"""Reference of DPT-Large (ViT-L/16 at 384x384), in plain f32: the
configuration `dpt-large` names it (`reference: "dpt_large"`).

From the paper (Ranftl et al., "Vision Transformers for Dense Prediction",
ICCV 2021) and the published `DPTDepthModel(backbone="vitl16_384")`:

- a 16x16 patch conv with bias, a cls token first, a learned position
  embedding added; `depth` pre-norm blocks: LayerNorm (eps 1e-6), one qkv
  projection, softmax(q k^T / sqrt(head dim)) v written out, an output
  projection; LayerNorm and an MLP with the exact (erf) GELU. The blocks
  of `tap_layers` give the four taps;
- per tap: each patch token concatenated with the cls token, a Linear to
  the width and a GELU; the token grid as a map, a 1x1 conv with bias, then
  a transposed conv k4 s4, a transposed conv k2 s2, nothing, or a 3x3 conv
  of stride 2 with padding 1; a 3x3 conv without bias to `features`;
- fusion, deepest first: x + RCU(skip), RCU, bilinear x2 with
  align_corners=True, a 1x1 conv; an RCU is relu, 3x3 conv, relu, 3x3
  conv, plus its input;
- head: 3x3 conv to features / 2, bilinear x2 (align_corners=True), 3x3
  conv to `head_hidden`, relu, 1x1 conv to one channel (log-depth; the
  published non-negative relu is left out, as the parameters that the
  published model never uses are).

The parameters are a dict keyed as the program's state_dict. `arch` holds
the sizes: patch, dim, depth, heads, mlp_dim, tap_layers,
reassemble_widths, features, head_hidden.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import ops

MODEL = True
RESAMPLE = (4, 2, 1, 0.5)


def param_shapes(arch, input_hw):
    """{name: shape} of every parameter."""
    e, p, f = arch["dim"], arch["patch"], arch["features"]
    tokens = (input_hw[0] // p) * (input_hw[1] // p)
    shapes = {"cls_token": (1, 1, e), "pos_embed": (1, 1 + tokens, e),
              "patch_embed.proj.weight": (e, 3, p, p),
              "patch_embed.proj.bias": (e,)}

    def linear(name, n_in, n_out):
        shapes[f"{name}.weight"] = (n_out, n_in)
        shapes[f"{name}.bias"] = (n_out,)

    def conv(name, n_in, n_out, k, bias=True, transposed=False):
        shapes[f"{name}.weight"] = ((n_in, n_out, k, k) if transposed
                                    else (n_out, n_in, k, k))
        if bias:
            shapes[f"{name}.bias"] = (n_out,)

    for i in range(arch["depth"]):
        b = f"blocks.{i}"
        shapes[f"{b}.norm1.weight"] = shapes[f"{b}.norm1.bias"] = (e,)
        linear(f"{b}.attn.qkv", e, 3 * e)
        linear(f"{b}.attn.proj", e, e)
        shapes[f"{b}.norm2.weight"] = shapes[f"{b}.norm2.bias"] = (e,)
        linear(f"{b}.mlp.fc1", e, arch["mlp_dim"])
        linear(f"{b}.mlp.fc2", arch["mlp_dim"], e)
    widths = arch["reassemble_widths"]
    for j, (w, factor) in enumerate(zip(widths, RESAMPLE), start=1):
        a = f"act_postprocess{j}"
        linear(f"{a}.readout", 2 * e, e)
        conv(f"{a}.conv", e, w, 1)
        if factor > 1:
            conv(f"{a}.resample", w, w, factor, transposed=True)
        elif factor < 1:
            conv(f"{a}.resample", w, w, 3)
    for j, w in enumerate(widths, start=1):
        conv(f"scratch.layer{j}_rn", w, f, 3, bias=False)
    for j in range(1, 5):
        r = f"scratch.refinenet{j}"
        for unit in (("resConfUnit1", "resConfUnit2") if j < 4
                     else ("resConfUnit2",)):
            conv(f"{r}.{unit}.conv1", f, f, 3)
            conv(f"{r}.{unit}.conv2", f, f, 3)
        conv(f"{r}.out_conv", f, f, 1)
    conv("scratch.output_conv.0", f, f // 2, 3)
    conv("scratch.output_conv.2", f // 2, arch["head_hidden"], 3)
    conv("scratch.output_conv.4", arch["head_hidden"], 1, 1)
    return shapes


def output_hw(input_hw):
    return tuple(input_hw)


def forward(p, x, arch, lowp=None):
    """p: params; x: normalized NHWC f32 [B, H, W, 3] -> log-depth NHWC
    [B, H, W, 1]. `lowp` lowers what the configuration computes in bf16:
    every matmul's and convolution's operands and output, the attention's
    probabilities, the LayerNorm and GELU outputs and the upsamples; the
    LayerNorm statistics and the last 1x1 conv stay f32."""
    def r(t):
        return ops.lowp_round(lowp, t)

    def linear(name, t):
        return r(F.linear(r(t), r(p[f"{name}.weight"]), p[f"{name}.bias"]))

    def conv(name, t, stride=1, padding=0):
        return r(F.conv2d(r(t), r(p[f"{name}.weight"]),
                          p.get(f"{name}.bias"), stride, padding))

    def up(t):
        return r(F.interpolate(t, scale_factor=2, mode="bilinear",
                               align_corners=True))

    e, patch, heads = arch["dim"], arch["patch"], arch["heads"]
    b, h, w, _ = x.shape
    gh, gw = h // patch, w // patch
    tok = conv("patch_embed.proj", x.permute(0, 3, 1, 2), stride=patch)
    tok = tok.flatten(2).transpose(1, 2)
    tok = torch.cat([p["cls_token"].expand(b, -1, -1), tok], dim=1)
    tok = tok + p["pos_embed"]

    def norm(name, t):
        return r(F.layer_norm(t, (e,), p[f"{name}.weight"],
                              p[f"{name}.bias"], 1e-6))

    def block(i, t):
        n = f"blocks.{i}"
        d = e // heads
        qkv = linear(f"{n}.attn.qkv", norm(f"{n}.norm1", t))
        q, k, v = qkv.reshape(b, -1, 3, heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d), dim=-1)
        o = r(r(att) @ v).transpose(1, 2).reshape(b, -1, e)
        t = t + linear(f"{n}.attn.proj", o)
        hidden = r(F.gelu(linear(f"{n}.mlp.fc1", norm(f"{n}.norm2", t))))
        return t + linear(f"{n}.mlp.fc2", hidden)

    taps = []
    for i in range(arch["depth"]):
        tok = block(i, tok)
        if i in arch["tap_layers"]:
            taps.append(tok)

    layers = []
    for j, (t, factor) in enumerate(zip(taps, RESAMPLE), start=1):
        a = f"act_postprocess{j}"
        patches = t[:, 1:]
        cls = t[:, :1].expand_as(patches)
        y = r(F.gelu(linear(f"{a}.readout", torch.cat([patches, cls], -1))))
        y = conv(f"{a}.conv", y.transpose(1, 2).reshape(b, e, gh, gw))
        if factor > 1:
            y = r(F.conv_transpose2d(r(y), r(p[f"{a}.resample.weight"]),
                                     p[f"{a}.resample.bias"], factor))
        elif factor < 1:
            y = conv(f"{a}.resample", y, stride=2, padding=1)
        layers.append(conv(f"scratch.layer{j}_rn", y, padding=1))

    def rcu(name, t):
        y = conv(f"{name}.conv1", t.clamp(min=0), padding=1)
        return conv(f"{name}.conv2", y.clamp(min=0), padding=1) + t

    def fuse(j, t, skip=None):
        n = f"scratch.refinenet{j}"
        if skip is not None:
            t = t + rcu(f"{n}.resConfUnit1", skip)
        return conv(f"{n}.out_conv", up(rcu(f"{n}.resConfUnit2", t)))

    y = fuse(4, layers[3])
    for j in (3, 2, 1):
        y = fuse(j, y, layers[j - 1])
    y = up(conv("scratch.output_conv.0", y, padding=1))
    y = conv("scratch.output_conv.2", y, padding=1).clamp(min=0)
    w4 = "scratch.output_conv.4"
    y = F.conv2d(y, p[f"{w4}.weight"], p[f"{w4}.bias"])  # f32, as stated
    return y.permute(0, 2, 3, 1)
