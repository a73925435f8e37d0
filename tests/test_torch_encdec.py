"""Parity of the port's EncDecDepthNet (ann3depth_tpu_torch/models/encdec.py)
and converter with the flax model, on the CPU.

Flax params from the JAX package's `init_params` go through
`convert.to_state_dict`; both models then take the same numpy input at a
small size (32x48 input, width_mult 0.25; the input must be divisible by
16). Tolerances:

- f32 compute: 1e-4 absolute on log-depth of magnitude ~1.5. Both sides
  are f32 convs (the JAX side at HIGHEST matmul precision), differing in
  summation order only.
- bf16 compute: 3e-2 absolute. Activations are rounded to bf16 (2^-8
  relative) after every conv on both sides, but not at the same places:
  flax rounds its matmul-upsample's intermediate, torch's bilinear rounds
  once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models import encdec as tenc
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import step as tstep

IN_HW = (32, 48)
F32_TOL = 1e-4
BF16_TOL = 3e-2


@functools.lru_cache(maxsize=None)
def _jax_params(width_mult=0.25, seed=0):
    """`init_params` of the flax model, as numpy (jitted: same values)."""
    model = jenc.EncDecDepthNet(width_mult=width_mult,
                                compute_dtype=jnp.float32)
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=seed)
    return jax.tree.map(np.asarray, params)


def _pair(compute, width_mult=0.25):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    params = _jax_params(width_mult)
    jm = jenc.EncDecDepthNet(width_mult=width_mult, compute_dtype=jdt)
    tm = tenc.EncDecDepthNet(width_mult=width_mult, compute_dtype=tdt)
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    return jm, tm.eval(), params


def _input(shape=(2, *IN_HW, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("size", [(8, 8), (9, 7), (10, 5)])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_padding_matches_flax(size, stride):
    """flax SAME pads a stride-2 3x3 conv (0,1) on even sizes and (1,1) on
    odd ones; torch's padding=1 would shift every even-size output."""
    x = _input((1, *size, 4), seed=1)
    conv = nn.Conv(6, (3, 3), strides=(stride, stride), padding="SAME",
                   use_bias=False)
    variables = conv.init(jax.random.key(0), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        want = conv.apply(variables, jnp.asarray(x))
    tc = tenc.Conv(4, 6, 3, stride)
    tc.weight.data = torch.from_numpy(
        np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_space_to_depth_channel_order_matches_flax():
    x = _input((2, 8, 12, 3), seed=2)
    want = jenc.space_to_depth(jnp.asarray(x), 4)
    got = tenc.space_to_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_param_count_and_names_match_flax_at_full_width():
    params = _jax_params(width_mult=1.0)
    sd = convert.to_state_dict(params)
    tm = tenc.EncDecDepthNet()
    assert set(sd) == set(tm.state_dict())
    n_flax = sum(a.size for a in jax.tree.leaves(params))
    assert n_flax == sum(p.numel() for p in tm.parameters()) == 1_417_665
    for k, v in tm.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_converter_layouts():
    params = _jax_params()
    sd = convert.to_state_dict(params)
    k = params["enc1"]["conv_down"]["kernel"]            # HWIO
    np.testing.assert_array_equal(sd["enc1.conv_down.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["enc0.norm.weight"].numpy(),
                                  params["enc0"]["GroupNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["head.bias"].numpy(),
                                  params["head"]["bias"])
    flat = convert.flatten(params)
    assert "dec1/proj_skip/kernel" in flat
    assert convert.torch_name("dec1/proj_skip/kernel") == \
        "dec1.proj_skip.weight"
    with pytest.raises(KeyError):
        convert.torch_name("head/embedding")


def test_forward_f32_matches_flax():
    jm, tm, params = _pair("f32")
    x = _input()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 16, 24, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_forward_bf16_matches_flax():
    jm, tm, params = _pair("bf16")
    x = _input(seed=3)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32  # f32 head
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=BF16_TOL)


def test_forward_accepts_pre_s2d_input():
    _, tm, _ = _pair("f32")
    x = torch.from_numpy(_input())
    with torch.no_grad():
        torch.testing.assert_close(tm(tenc.space_to_depth(x, 4)), tm(x))


def test_channels_last_model_gives_the_same_output():
    _, tm, _ = _pair("f32")
    x = torch.from_numpy(_input())
    with torch.no_grad():
        want = tm(x)
        got = tm.to(memory_format=torch.channels_last)(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_init_follows_flax_initializers():
    tm = tstep.init_params(tenc.EncDecDepthNet(), IN_HW, seed=0)
    w = tm.enc2.conv_refine.weight.detach()
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = w.std().item()
    # lecun_normal: variance 1/fan_in (589,824 draws: ~0.1% sampling error)
    assert abs(std * fan_in ** 0.5 - 1.0) < 0.01
    # truncated at 2 standard deviations of the untruncated normal
    assert w.abs().max().item() <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6
    assert torch.all(tm.head.bias == 0)
    assert torch.all(tm.enc0.norm.weight == 1)
    assert torch.all(tm.enc0.norm.bias == 0)
    again = tstep.init_params(tenc.EncDecDepthNet(), IN_HW, seed=0)
    torch.testing.assert_close(again.enc0.conv_down.weight,
                               tm.enc0.conv_down.weight, rtol=0, atol=0)


def test_registry():
    m = registry.build(ModelConfig(name="encdec", width_mult=0.25))
    assert isinstance(m, tenc.EncDecDepthNet) and m.widths == [32, 32, 64]
    assert registry.available() == ["dpt", "dpt-large", "dpt-small",
                                    "encdec", "multiscale", "small"]
    with pytest.raises(KeyError, match="encdec"):
        registry.build(ModelConfig(name="nosuch"))
    q = registry.build(ModelConfig(name="encdec", quant="int8"))
    assert type(q.enc0.conv_down).__name__ == "QConv"
    with pytest.raises(ValueError, match="quant"):
        registry.build(ModelConfig(name="small", quant="int8"))


@pytest.mark.parametrize("tta", ["", "flip"])
def test_infer_step_matches_jax(tta):
    jm, tm, params = _pair("f32")
    x = np.random.default_rng(4).integers(0, 256, (2, 40, 56, 3),
                                          dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        want = jstep.infer_step(jm.apply, params, jnp.asarray(x),
                                input_hw=IN_HW, tta=tta)
    got = tstep.infer_step(tm, torch.from_numpy(x), input_hw=IN_HW, tta=tta)
    assert got.shape == (2, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL)


def test_apply_with_tta_rejects_unknown_mode():
    _, tm, _ = _pair("f32")
    with pytest.raises(ValueError, match="tta"):
        tstep.apply_with_tta(tm, torch.zeros(1, *IN_HW, 3), "rot90")
