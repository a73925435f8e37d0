"""DPT-Large: the dense prediction transformer on a ViT-L/16 at 384x384.

Ranftl, Bochkovskiy and Koltun, "Vision Transformers for Dense
Prediction" (ICCV 2021, arXiv:2103.13413), as `DPTDepthModel(backbone=
"vitl16_384")` of isl-org/DPT builds it, at its published widths:

- Body (ViT-L/16, timm `vit_large_patch16_384`): a 16x16 patch conv
  3 -> 1024 with bias, a cls token, a learned `pos_embed` of 1 + tokens
  rows; 24 pre-norm blocks, each LayerNorm (eps 1e-6), one `qkv` Linear
  1024 -> 3072, 16 heads of 64 through `F.scaled_dot_product_attention`,
  a `proj` Linear, LayerNorm and an MLP 1024 -> 4096 -> 1024 with exact
  (erf) GELU. The outputs of blocks 5, 11, 17 and 23 are the taps; ViT's
  final norm is not applied to them.
- Readout "project": every patch token concatenated with the cls token,
  Linear 2048 -> 1024, GELU.
- Reassemble: the 24x24 grid, a 1x1 conv with bias to 256, 512, 1024 and
  1024 channels, then per tap a ConvTranspose2d k4 s4, a ConvTranspose2d
  k2 s2, nothing, and a 3x3 conv of stride 2 padded (1, 1); then the
  "scratch" 3x3 convs to 256 channels, without bias.
- Fusion: four RefineNet blocks, deepest first, each `RCU2(x + RCU1(skip))`
  (an RCU is relu, conv3x3, relu, conv3x3, plus its input), a bilinear x2
  with align_corners=True and a 1x1 conv.
- Head: conv3x3 256 -> 128, bilinear x2 (align_corners=True), conv3x3
  128 -> 32, ReLU, conv1x1 32 -> 1.

The registry's contract holds: NHWC normalized f32 in, NHWC log-depth f32
out at the input's size. bf16 under f32 params, as every port model: the
body, readout, reassembly, fusion and the head's first convs run under
autocast (no weight-cast cache, which a CUDA graph cannot capture); the
LayerNorm statistics are f32 (`dpt._layer_norm`); the last 1x1 conv is
f32 (`encdec.head_input`). The upsamples are `ops.resize.
upsample_aligned_nhwc`: two GEMMs on the NHWC bytes, whose backward is
GEMMs too (F.interpolate's CUDA backward sums with atomics), with the
align_corners weights held to about 16 bits in bf16 as F.interpolate
holds them in f32.

Departures from the published model:
- DPT's final non-negative ReLU is left out: the output is log-depth,
  which may be negative.
- Parameters that the published model holds and never uses are not
  created: ViT's final `norm` and classifier, and the deepest fusion
  block's `resConfUnit1`.
- Weights are seeded (`init_weights`), not pretrained.

Parameter names follow DPT's modules, so that a published checkpoint maps
onto them by renaming alone: `patch_embed.proj`, `cls_token`, `pos_embed`,
`blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}` (DPT's
`pretrained.model.*`); `act_postprocess{j}.readout` (DPT's
`pretrained.act_postprocess{j}.0.project.0`), `.conv` (`.3`) and
`.resample` (`.4`); `scratch.layer{j}_rn`, `scratch.refinenet{j}.
{resConfUnit1,resConfUnit2}.{conv1,conv2}`, `scratch.refinenet{j}.
out_conv` and `scratch.output_conv.{0,2,4}` as in DPT.

`SDPA_BACKENDS` counts which backend of `F.scaled_dot_product_attention`
the blocks take (flash, efficient, cudnn or math), once for each shape,
at the first call of that shape; `attention_backend` asks the same for a
step's shapes before it runs. A fallback to math holds the T x T scores
in memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ann3depth_tpu_torch.models.dpt import _layer_norm
from ann3depth_tpu_torch.models.encdec import (head_input, lecun_normal_,
                                               remat_call)
from ann3depth_tpu_torch.ops.resize import upsample_aligned_nhwc
from ann3depth_tpu_torch.utils.tracing import span

PATCH = 16
# Per tap, the reassembly's resampling of the 24x24 grid: x4 and x2 by a
# transposed conv, none, and /2 by a stride-2 conv.
RESAMPLE = (4, 2, 1, 0.5)
HEAD_HIDDEN = 32  # the head's last 3x3 conv's width
SDPA_BACKENDS = {}  # (q shape, dtype, device type) -> backend name
_SHORT = {"FLASH_ATTENTION": "flash", "EFFICIENT_ATTENTION": "efficient",
          "CUDNN_ATTENTION": "cudnn", "MATH": "math"}


def sdpa_backend(q, k, v):
    """The backend `F.scaled_dot_product_attention(q, k, v)` takes, as a
    short name, recorded in SDPA_BACKENDS once for each shape. A host-side
    check of the inputs' properties: it launches nothing."""
    key = (tuple(q.shape), str(q.dtype).removeprefix("torch."),
           q.device.type)
    name = SDPA_BACKENDS.get(key)
    if name is None:
        from torch.nn.attention import SDPBackend

        choice = SDPBackend(torch._fused_sdp_choice(q, k, v)).name
        name = SDPA_BACKENDS[key] = _SHORT.get(choice, choice.lower())
    return name


def _up(x, factor):
    """Bilinear x`factor`, align_corners=True, of NCHW x in x's dtype
    (outside autocast, so that the fusion path stays in the compute
    dtype). Channels_last x is NHWC bytes, so both permutes are views."""
    with torch.autocast(x.device.type, enabled=False):
        return upsample_aligned_nhwc(x.permute(0, 2, 3, 1),
                                     factor).permute(0, 3, 1, 2)


class Attention(nn.Module):
    """timm's ViT attention: one `qkv` GEMM, then SDPA (scale 1/sqrt(D))."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, e = x.shape
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads,
                                      e // self.heads).permute(
                                          2, 0, 3, 1, 4).unbind(0)
        sdpa_backend(q, k, v)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, t, e))


class MLP(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm ViT block on [B, T, E] tokens in the compute dtype."""

    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLP(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(_layer_norm(self.norm1, x)).to(x.dtype)
        return x + self.mlp(_layer_norm(self.norm2, x)).to(x.dtype)


class Reassemble(nn.Module):
    """One tap's readout (patch tokens with the cls token, Linear, GELU),
    its grid as an NCHW map, a 1x1 conv and the tap's resampling."""

    def __init__(self, dim, width, factor):
        super().__init__()
        self.readout = nn.Linear(2 * dim, dim)
        self.conv = nn.Conv2d(dim, width, 1)
        if factor > 1:
            self.resample = nn.ConvTranspose2d(width, width, factor, factor)
        elif factor < 1:
            self.resample = nn.Conv2d(width, width, 3, 2, padding=1)
        else:
            self.resample = None

    def forward(self, tok, gh, gw):
        patches = tok[:, 1:]
        cls = tok[:, :1].expand_as(patches)
        x = F.gelu(self.readout(torch.cat([patches, cls], dim=-1)))
        x = self.conv(x.reshape(tok.shape[0], gh, gw, -1).permute(0, 3, 1, 2))
        return x if self.resample is None else self.resample(x)


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """`RCU2(x + RCU1(skip))` (RCU2(x) without a skip), bilinear x2 with
    align_corners=True, then a 1x1 conv."""

    def __init__(self, features, skip=True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_up(self.resConfUnit2(x), 2))


class DPTLargeDepthNet(nn.Module):
    """x: NHWC [B, H, W, 3] normalized f32, H and W multiples of 16 and
    the input size given to `init_weights` -> NHWC [B, H, W, 1] log-depth
    f32."""

    S2D_INPUT_FACTOR = 0
    OUTPUT_STRIDE = 1

    def __init__(self, dim=1024, depth=24, heads=16,
                 tap_layers=(5, 11, 17, 23), widths=(256, 512, 1024, 1024),
                 features=256, compute_dtype=torch.bfloat16, remat=False):
        super().__init__()
        if len(tap_layers) != 4 or len(widths) != 4:
            raise ValueError("DPT reassembles 4 taps")
        self.dim = dim
        self.tap_layers = tuple(tap_layers)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, PATCH, PATCH)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, 0, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))
        for j, (width, factor) in enumerate(zip(widths, RESAMPLE), start=1):
            self.add_module(f"act_postprocess{j}",
                            Reassemble(dim, width, factor))
        self.scratch = nn.Module()
        for j, width in enumerate(widths, start=1):
            setattr(self.scratch, f"layer{j}_rn",
                    nn.Conv2d(width, features, 3, padding=1, bias=False))
        for j in range(1, 5):
            setattr(self.scratch, f"refinenet{j}",
                    FeatureFusionBlock(features, skip=j < 4))
        self.scratch.output_conv = nn.ModuleDict({
            "0": nn.Conv2d(features, features // 2, 3, padding=1),
            "2": nn.Conv2d(features // 2, HEAD_HIDDEN, 3, padding=1),
            "4": nn.Conv2d(HEAD_HIDDEN, 1, 1)})

    def init_weights(self, generator=None, input_hw=None):
        """Seeded init for inputs of `input_hw` (which sets pos_embed's
        rows): lecun_normal kernels, zero biases, LayerNorm scale 1 and
        bias 0, cls_token and pos_embed normal(0.02)."""
        if input_hw is None:
            raise ValueError("DPT's pos_embed needs the input size")
        tokens = (input_hw[0] // PATCH) * (input_hw[1] // PATCH)
        self.pos_embed = nn.Parameter(torch.empty(
            1, 1 + tokens, self.dim, device=self.cls_token.device))
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def attention_backend(self, batch, input_hw):
        """The SDPA backend the blocks take for a batch of `batch` inputs
        of `input_hw` in the compute dtype on the params' device (recorded
        in SDPA_BACKENDS as the forward records it)."""
        blk = self.blocks[0].attn
        tokens = 1 + (input_hw[0] // PATCH) * (input_hw[1] // PATCH)
        q = torch.empty(batch, blk.heads, tokens, self.dim // blk.heads,
                        dtype=self.compute_dtype,
                        device=self.cls_token.device)
        return sdpa_backend(q, q, q)

    def forward(self, x):
        b, h, w, _ = x.shape
        gh, gw = h // PATCH, w // PATCH
        if self.pos_embed.shape[1] != 1 + gh * gw:
            raise ValueError(
                f"input {h}x{w} gives {gh * gw} tokens; pos_embed holds "
                f"{self.pos_embed.shape[1] - 1} (init_weights' input_hw)")
        dt = self.compute_dtype
        dev = x.device.type
        s = self.scratch

        def run(module, *args):
            return remat_call(self.remat, module, *args)

        with torch.autocast(dev, dtype=dt, enabled=dt != torch.float32,
                            cache_enabled=False):
            with span("dpt.embed"):
                tok = self.patch_embed.proj(x.permute(0, 3, 1, 2).to(dt))
                tok = tok.permute(0, 2, 3, 1).reshape(b, gh * gw, self.dim)
                tok = torch.cat([self.cls_token.to(dt).expand(b, -1, -1),
                                 tok.to(dt)], dim=1) + self.pos_embed.to(dt)
            with span("dpt.blocks"):
                taps = []
                for i, block in enumerate(self.blocks):
                    tok = run(block, tok)
                    if i in self.tap_layers:
                        taps.append(tok)
            with span("dpt.reassemble"):
                layers = [getattr(s, f"layer{j}_rn")(
                    getattr(self, f"act_postprocess{j}")(t, gh, gw))
                    for j, t in enumerate(taps, start=1)]
            with span("dpt.fusion"):
                y = run(s.refinenet4, layers[3])
                for j in (3, 2, 1):
                    y = run(getattr(s, f"refinenet{j}"), y, layers[j - 1])
            with span("dpt.head"):
                head = s.output_conv
                y = F.relu(head["2"](_up(head["0"](y), 2)))
                with torch.autocast(dev, enabled=False):
                    y = head["4"](head_input(y))
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def output_hw(input_hw):
        return tuple(input_hw)
