"""Reference of the encoder-decoder depth CNN, in plain f32.

From the model's description: NHWC RGB in; a 4x4 space-to-depth stem
(channel index dy*4*C + dx*C + c); three encoder stages, each a 3x3 conv
(stride 1, 2, 2) -> GroupNorm(8, eps 1e-6) -> relu -> 3x3 conv -> relu of
the sum; two decoder stages, each a 1x1 projection, a bilinear x2, a 3x3
conv plus a 1x1-projected skip, relu; a 3x3 head with bias and a final
bilinear x2. Convolutions pad as "SAME" and carry no bias but the head's.
Widths 64, 128, 256 at width_mult 1 (a width is max(32, int(c * m) // 8 * 8)).

The parameters are a dict keyed as the program's state_dict.
"""

from __future__ import annotations

from portbench.reference import ops

MODEL = True
ENC_WIDTHS = (64, 128, 256)
S2D = 4
OUTPUT_STRIDE = 2


def widths(width_mult=1.0):
    return [max(32, int(c * width_mult) // 8 * 8) for c in ENC_WIDTHS]


def param_shapes(model_cfg, input_hw):
    """{name: shape} of every parameter."""
    w0, w1, w2 = widths(model_cfg.get("width_mult", 1.0))
    stem = 3 * S2D * S2D
    shapes = {}

    def stage(name, cin, cout):
        shapes[f"{name}.conv_down.weight"] = (cout, cin, 3, 3)
        shapes[f"{name}.norm.weight"] = (cout,)
        shapes[f"{name}.norm.bias"] = (cout,)
        shapes[f"{name}.conv_refine.weight"] = (cout, cout, 3, 3)

    def up(name, cin, cskip, cout):
        shapes[f"{name}.proj_down.weight"] = (cout, cin, 1, 1)
        shapes[f"{name}.conv_up.weight"] = (cout, cout, 3, 3)
        shapes[f"{name}.proj_skip.weight"] = (cout, cskip, 1, 1)

    stage("enc0", stem, w0)
    stage("enc1", w0, w1)
    stage("enc2", w1, w2)
    up("dec0", w2, w1, w1)
    up("dec1", w1, w0, w0)
    shapes["head.weight"] = (1, w0, 3, 3)
    shapes["head.bias"] = (1,)
    return shapes


def output_hw(input_hw):
    return (input_hw[0] // OUTPUT_STRIDE, input_hw[1] // OUTPUT_STRIDE)


def _space_to_depth(x, f):
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // f, w // f, f * f * c)


def forward(p, x, model_cfg=None, lowp=None):
    """p: params; x: normalized NHWC f32 [B, H, W, 3] -> log-depth NHWC
    [B, H/2, W/2, 1]. The widths come from the params. `lowp` lowers what
    the configuration computes in bf16 (the body's convolutions and
    upsamples); the head stays f32."""
    x = _space_to_depth(x, S2D).permute(0, 3, 1, 2)

    def stage(name, x, stride):
        x = ops.conv(x, p[f"{name}.conv_down.weight"], stride=stride,
                     lowp=lowp)
        x = ops.group_norm(x, 8, p[f"{name}.norm.weight"],
                           p[f"{name}.norm.bias"])
        x = x.clamp(min=0)
        y = ops.conv(x, p[f"{name}.conv_refine.weight"], lowp=lowp)
        return (x + y).clamp(min=0)

    def up(name, x, skip):
        x = ops.conv(x, p[f"{name}.proj_down.weight"], lowp=lowp)
        x = ops.lowp_round(lowp, ops.upsample(x, 2))
        y = (ops.conv(x, p[f"{name}.conv_up.weight"], lowp=lowp)
             + ops.conv(skip, p[f"{name}.proj_skip.weight"], lowp=lowp))
        return y.clamp(min=0)

    s0 = stage("enc0", x, 1)
    s1 = stage("enc1", s0, 2)
    x = stage("enc2", s1, 2)
    x = up("dec0", x, s1)
    x = up("dec1", x, s0)
    y = ops.conv(x, p["head.weight"], p["head.bias"])  # f32, as stated
    return ops.upsample(y, 2).permute(0, 2, 3, 1)
