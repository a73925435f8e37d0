"""DPT-style ViT depth model.

Counterpart of `ann3depth_tpu/models/dpt.py`, with its variant fields
(`upsample`, `attention_impl`) and its int8 path: a 16x16
patch embedding with a learned position embedding, `depth` pre-norm ViT
blocks, four token taps reassembled into feature maps by 1x1 convs, a
convolutional fusion head run deepest tap first, and an f32 1-channel
head upsampled to the input resolution. With quant "int8" every encoder
block's attention is `ops.quant.QAttention` and its MLP two
`ops.quant.QLinear`s (the JAX `QMultiHeadAttention` and `QDense`);
patch_embed, the reassemble projections and the fusion head stay in the
compute dtype, and the params are the same.

`attention_impl` picks the encoder's attention, as in JAX; every value
has the same params and state_dict keys, so checkpoints interchange:
- "flax" (default): `Attention`, separate q/k/v projections, then
  `F.scaled_dot_product_attention`.
- "jnn": `jax.nn.dot_product_attention`'s contract, f32 logits and
  softmax and one cast to the compute dtype, which is SDPA's own: on the
  card it is the same call as "flax".
- "fused": `FusedQKVSelfAttention`, the three projections as one
  [3E, E] GEMM, then SDPA.
quant "int8" takes precedence over it, as in JAX.

`upsample` picks how the fusion head upsamples by 2 and 4:
- "resize" (default): `F.interpolate` bilinear, whose CUDA backward sums
  with atomics, so two runs of one feed part.
- "matmul": `ops.resize.upsample_matmul_nhwc` in the compute dtype
  (JAX's `upsample_matmul(x.astype(dt), f)`), two fixed GEMMs whose
  result is channels_last and whose backward is GEMMs too. The same
  function: the x2 and x4 weights (0.25/0.75, 0.125...0.875) are exact in
  bf16. The f32 head's final x`head_stride` goes through it as well; JAX
  resizes there in both modes, which at an integer factor is the same
  function (encdec's head does the same).

Module and param names follow the flax tree through `convert.py`:
`block{i}` holds `norm1`/`norm2` (LayerNorm_0/1), `attn`
(MultiHeadDotProductAttention_0, with `query`/`key`/`value`/`out`) and
`mlp` (MLP_0, `fc1`/`fc2` for Dense_0/1); each `fuse{i}` holds
`conv_skip`, `conv1`, `conv2` (Conv_0/1/2).

Where flax and torch differ, each handled here:
- `nn.gelu` is the tanh approximation: `F.gelu(approximate="tanh")`.
- `nn.LayerNorm(dtype=f32)` has eps 1e-6 and takes its statistics and
  gives its output in f32, which the block casts to the compute dtype.
- flax attention scales the query by 1/sqrt(d) and takes the softmax in
  the compute dtype; `F.scaled_dot_product_attention` takes it with f32
  sums, so in bf16 the two differ by bf16 rounding of the weights.
- flax's `DenseGeneral` q/k/v kernels `(E, H, D)` are [H*D, E] Linear
  weights here, the out kernel `(H, D, E)` an [E, H*D] one.
- `pos_embed` has the shape of the token grid, so it is made by
  `init_weights(generator, input_hw)` (the JAX `init_params` takes the
  input size for the same reason); until then it holds no token.
- `jax.image.resize` bilinear at an integer upscale is
  `F.interpolate(align_corners=False)`, run here outside autocast so that
  the fusion path stays in the compute dtype as flax's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ann3depth_tpu_torch.models.encdec import Conv, init_flax_, remat_call
from ann3depth_tpu_torch.ops.resize import upsample_matmul_nhwc

PATCH = 16
ATTENTION_IMPLS = ("flax", "jnn", "fused")
UPSAMPLES = ("resize", "matmul")


def _layer_norm(norm, x):
    """flax nn.LayerNorm(dtype=f32): f32 statistics and output, then the
    input's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


def _up(x, factor, impl="resize"):
    """Bilinear x`factor` of NCHW x in x's dtype, as flax resizes and casts
    back to the compute dtype (autocast would run it, and the fusion path
    after it, in f32). impl "matmul": two fixed GEMMs on the NHWC bytes
    (NCHW channels_last is NHWC, so both permutes are views, and the
    result is channels_last, as F.interpolate's is)."""
    with torch.autocast(x.device.type, enabled=False):
        if impl == "matmul":
            return upsample_matmul_nhwc(x.permute(0, 2, 3, 1),
                                        factor).permute(0, 3, 1, 2)
        return F.interpolate(x, scale_factor=factor, mode="bilinear",
                             align_corners=False)


class Attention(nn.Module):
    """flax MultiHeadDotProductAttention, self-attention, no mask."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, e = x.shape
        h = self.heads

        def split(proj):  # [B, T, E] -> [B, H, T, D]
            return proj(x).reshape(b, t, h, e // h).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(self.query), split(self.key),
                                           split(self.value))
        return self.out(o.transpose(1, 2).reshape(b, t, e))


class FusedQKVSelfAttention(Attention):
    """`Attention` with the q/k/v projections as one GEMM: their weights
    and biases concatenated at forward time into a [3E, E] operand. The
    params, their names and their init are `Attention`'s, so the two load
    each other's state_dicts strictly. Tensor parallelism shards it as
    `Attention` (parallel/sharding_rules.py)."""

    def forward(self, x):
        b, t, e = x.shape
        h = self.heads
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        bias = torch.cat([self.query.bias, self.key.bias, self.value.bias])
        q, k, v = (p.reshape(b, t, h, e // h).transpose(1, 2)
                   for p in F.linear(x, w, bias).chunk(3, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v)
        return self.out(o.transpose(1, 2).reshape(b, t, e))


class MLP(nn.Module):
    def __init__(self, dim, hidden, linear=nn.Linear):
        super().__init__()
        self.fc1 = linear(dim, hidden)
        self.fc2 = linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-norm ViT block on [B, T, E] tokens in the compute dtype."""

    def __init__(self, dim, heads, quant="none", attention_impl="flax"):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, not {attention_impl!r}")
        attention, linear = Attention, nn.Linear
        if quant == "int8":
            from ann3depth_tpu_torch.ops.quant import QAttention, QLinear
            attention, linear = QAttention, QLinear
        elif quant != "none":
            raise ValueError(f"DPT takes quant 'none' or 'int8', not "
                             f"{quant!r}")
        elif attention_impl == "fused":
            attention = FusedQKVSelfAttention
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLP(dim, dim * 4, linear)

    def forward(self, x):
        x = x + self.attn(_layer_norm(self.norm1, x)).to(x.dtype)
        return x + self.mlp(_layer_norm(self.norm2, x)).to(x.dtype)


class FusionBlock(nn.Module):
    """Merge a reassembled skip into the coarser path (3x3 conv, added),
    refine with relu-conv-relu-conv (added), then bilinear x2 (by
    `upsample`, see `_up`) unless `upsample_out` is off. Convs without
    bias."""

    def __init__(self, features, upsample_out=True, upsample="resize"):
        super().__init__()
        self.upsample_out = upsample_out
        self.upsample = upsample
        self.conv_skip = Conv(features, features, 3)
        self.conv1 = Conv(features, features, 3)
        self.conv2 = Conv(features, features, 3)

    def forward(self, x, skip):
        x = x + self.conv_skip(skip)
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        x = x + y
        return _up(x, 2, self.upsample) if self.upsample_out else x


class DPTDepthNet(nn.Module):
    """x: NHWC [B, H, W, 3] normalized f32, H and W multiples of 16 and
    the input size given to `init_weights` -> NHWC [B, H, W, 1] log-depth
    f32."""

    S2D_INPUT_FACTOR = 0
    OUTPUT_STRIDE = 1

    def __init__(self, dim=384, depth=12, heads=6, fusion_features=128,
                 tap_layers=(2, 5, 8, 11), compute_dtype=torch.bfloat16,
                 remat=True, head_stride=2, quant="none", upsample="resize",
                 attention_impl="flax"):
        super().__init__()
        if len(tap_layers) != 4:
            raise ValueError("the DPT head takes 4 reassembled taps")
        if head_stride not in (2, 4):
            raise ValueError(f"head_stride must be 2 or 4, got {head_stride}")
        if upsample not in UPSAMPLES:
            raise ValueError(f"upsample must be one of {UPSAMPLES}, not "
                             f"{upsample!r}")
        self.dim, self.depth = dim, depth
        self.tap_layers = tuple(tap_layers)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.head_stride = head_stride
        self.upsample = upsample
        f = fusion_features
        self.patch_embed = Conv(3, dim, PATCH, PATCH, bias=True)
        self.pos_embed = nn.Parameter(torch.empty(1, 0, dim))
        for i in range(depth):
            self.add_module(f"block{i}",
                            Block(dim, heads, quant, attention_impl))
        for i in range(4):
            self.add_module(f"reassemble{i}", Conv(dim, f, 1, bias=True))
        self.fuse3 = FusionBlock(f, upsample=upsample)
        self.fuse2 = FusionBlock(f, upsample=upsample)
        self.fuse1 = FusionBlock(f, upsample_out=head_stride == 2,
                                 upsample=upsample)
        self.head1 = Conv(f, 64, 3, bias=True)
        self.head2 = Conv(64, 1, 3, bias=True)

    def init_weights(self, generator=None, input_hw=None):
        """flax init for inputs of `input_hw` (which sets the token count
        of pos_embed): lecun_normal conv and dense kernels (q/k/v with fan
        in E, out with fan in H*D), zero biases, LayerNorm scale 1 and bias
        0, pos_embed normal(0.02)."""
        if input_hw is None:
            raise ValueError("DPT's pos_embed needs the input size")
        h, w = input_hw
        tokens = (h // PATCH) * (w // PATCH)
        self.pos_embed = nn.Parameter(torch.empty(
            1, tokens, self.dim, device=self.patch_embed.weight.device))
        init_flax_(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, x):
        b, h, w, _ = x.shape
        gh, gw = h // PATCH, w // PATCH
        if self.pos_embed.shape[1] != gh * gw:
            raise ValueError(
                f"input {h}x{w} gives {gh * gw} tokens; pos_embed holds "
                f"{self.pos_embed.shape[1]} (init_weights' input_hw)")
        dt = self.compute_dtype
        dev = x.device.type
        low = dt != torch.float32
        ups = self.upsample

        def run(module, *args):
            return remat_call(self.remat, module, *args)

        # No weight-cast cache: a CUDA graph cannot capture it.
        with torch.autocast(dev, dtype=dt, enabled=low, cache_enabled=False):
            tok = self.patch_embed(x.permute(0, 3, 1, 2).to(dt))
            tok = tok.permute(0, 2, 3, 1).reshape(b, gh * gw, self.dim)
            tok = tok.to(dt) + self.pos_embed.to(dt)
            taps = []
            for i in range(self.depth):
                tok = run(getattr(self, f"block{i}"), tok)
                if i in self.tap_layers:
                    taps.append(tok)
            skips = [getattr(self, f"reassemble{i}")(
                t.reshape(b, gh, gw, self.dim).permute(0, 3, 1, 2))
                for i, t in enumerate(taps)]
            y = run(self.fuse3, skips[-1], skips[-2])
            y = run(self.fuse2, y, _up(skips[-3], 2, ups))
            y = run(self.fuse1, y, _up(skips[-4], 4, ups))
            y = F.relu(self.head1(y))
        with torch.autocast(dev, enabled=False):
            y = _up(self.head2(y.float()), self.head_stride, ups)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def output_hw(input_hw):
        return tuple(input_hw)
