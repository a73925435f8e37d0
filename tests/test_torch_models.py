"""Parity of the port's SmallDepthNet and MultiScaleDepthNet
(ann3depth_tpu_torch/models/{small_depth,multiscale}.py), of the registry's
remat and of the converter at every preset's full width with the flax
models, on the CPU.

Flax params from the JAX package's `init_params` go through
`convert.to_state_dict`; both models take the same numpy input (96x128,
multiscale at width_mult 0.25). Tolerances on log-depth:

- f32: 1e-4 absolute (both sides f32, the JAX side at HIGHEST matmul
  precision; summation order only).
- bf16: small 1e-2 absolute (three convs, one bf16 rounding of each
  activation, outputs ~1.3); multiscale 5e-2 absolute and 5e-3 in mean
  (seven GroupNorm stages and a global mean, each rounded to bf16, on
  outputs ~2.5; flax rounds at other places, tests/test_torch_encdec.py).
- remat: the same function, so outputs and gradients agree to 1e-6.
- one f32 train step against the JAX train_step (plain preprocess at
  HIGHEST): loss and grad norm 1e-4 relative, params after the update
  1e-5 absolute (Adam's first step moves each param by ~lr sign(g), so a
  param differs only where its gradient's sign does).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ann3depth_tpu.config import ModelConfig as JModelConfig
from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert
from ann3depth_tpu_torch.config import ModelConfig, get_config
from ann3depth_tpu_torch.models import encdec as tenc
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.models.multiscale import MultiScaleDepthNet
from ann3depth_tpu_torch.models.small_depth import SmallDepthNet
from ann3depth_tpu_torch.train import checkpoint as tckpt
from ann3depth_tpu_torch.train import step as tstep

IN_HW = (96, 128)
F32_TOL = 1e-4
BF16_TOL = {"small": (1e-2, 1e-2), "multiscale": (5e-2, 5e-3)}
WIDTH = {"small": 1.0, "multiscale": 0.25}
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed=0):
    model = jreg.build(JModelConfig(name=name, width_mult=WIDTH[name],
                                    compute_dtype="float32"))
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=seed)
    return jax.tree.map(np.asarray, params)


def _pair(name, compute="float32", remat=False):
    """(flax model, port model with the flax params, params)."""
    params = _jax_params(name)
    jm = jreg.build(JModelConfig(name=name, width_mult=WIDTH[name],
                                 compute_dtype=compute))
    tm = registry.build(ModelConfig(name=name, width_mult=WIDTH[name],
                                    compute_dtype=compute, remat=remat))
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    return jm, tm.eval(), params


def _input(shape=(2, *IN_HW, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_forward(jm, params, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(jm.apply)({"params": params},
                                            jnp.asarray(x)), np.float32)


@pytest.mark.parametrize("name,out_hw", [("small", (12, 16)),
                                         ("multiscale", (48, 64))])
def test_forward_f32_matches_flax(name, out_hw):
    jm, tm, params = _pair(name)
    x = _input()
    want = _jax_forward(jm, params, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, *out_hw, 1)
    assert got.dtype == torch.float32
    assert registry.output_hw(name, IN_HW) == out_hw
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("name", ["small", "multiscale"])
def test_forward_bf16_matches_flax(name):
    jm, tm, params = _pair(name, "bfloat16")
    x = _input(seed=3)
    want = _jax_forward(jm, params, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    max_tol, mean_tol = BF16_TOL[name]
    err = np.abs(got - want)
    assert err.max() <= max_tol and err.mean() <= mean_tol, (
        err.max(), err.mean())


def test_multiscale_accepts_pre_s2d_input():
    jm, tm, params = _pair("multiscale")
    x = _input(seed=4)
    s2d = tenc.space_to_depth(torch.from_numpy(x), 4)
    with torch.no_grad():
        torch.testing.assert_close(tm(s2d), tm(torch.from_numpy(x)))
    np.testing.assert_allclose(tm(s2d).detach().numpy(),
                               _jax_forward(jm, params, s2d.numpy()),
                               atol=F32_TOL)
    with pytest.raises(ValueError, match="s2d"):
        tm(torch.zeros(1, 8, 8, 5))
    assert registry.s2d_input_factor("multiscale") == 4
    assert registry.s2d_input_factor("small") == 0


def test_small_conv1_pads_like_flax():
    """flax SAME pads the 5x5 stride-2 conv (1, 2) on even sizes."""
    assert tenc.same_padding(96, 5, 2) == (1, 2)
    assert tenc.same_padding(97, 5, 2) == (2, 2)


def test_small_width_rounds_like_flax():
    assert SmallDepthNet(width_mult=0.3).widths == [9, 19]
    assert SmallDepthNet(width_mult=0.1).widths == [8, 8]
    sd = SmallDepthNet(width_mult=0.3).state_dict()
    assert SmallDepthNet(width_mult=SmallDepthNet.width_mult_of(sd)
                         ).widths == [9, 19]


def _loss_and_grads(model, x):
    model.zero_grad(set_to_none=True)
    y = model(x)
    (y ** 2).mean().backward()
    return y.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["encdec", "multiscale"])
def test_remat_gives_equal_outputs_and_gradients(name):
    """The registry passes remat (flax nn.remat of each stage) to encdec
    and multiscale; checkpointing recomputes the same function."""
    cfg = ModelConfig(name=name, width_mult=0.25, compute_dtype="float32")
    plain = tstep.init_params(registry.build(cfg), IN_HW, seed=1)
    remat = registry.build(dataclasses.replace(cfg, remat=True))
    remat.load_state_dict(plain.state_dict())
    assert remat.remat and not plain.remat
    x = torch.from_numpy(_input(seed=5))
    y0, g0 = _loss_and_grads(plain, x)
    y1, g1 = _loss_and_grads(remat, x)
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_registry_passes_remat_as_the_jax_registry_does():
    for name in ("encdec", "multiscale", "dpt", "dpt-small"):
        assert registry.build(ModelConfig(name=name, remat=True)).remat
        assert not registry.build(ModelConfig(name=name)).remat
    assert not hasattr(registry.build(ModelConfig(name="small", remat=True)),
                       "remat")
    # The JAX registry's names and the port's own DPT-Large, exactly.
    assert registry.available() == sorted(jreg.available() + ["dpt-large"])
    assert type(registry.build(ModelConfig(
        name="dpt", quant="int8")).block0.attn).__name__ == "QAttention"
    with pytest.raises(ValueError, match="quant"):
        registry.build(ModelConfig(name="dpt", quant="int8-qat"))
    with pytest.raises(ValueError, match="quant"):
        registry.build(ModelConfig(name="dpt-large", quant="int8"))


@pytest.mark.parametrize("name", ["small", "multiscale"])
def test_init_follows_flax_initializer_statistics(name):
    """Per param, the std of the port's init against flax's (kernels of
    more than 1000 draws: sampling error under 5% on each side), biases 0,
    GroupNorm scale 1; the same seed gives the same draws."""
    cfg = ModelConfig(name=name, width_mult=WIDTH[name])
    tm = tstep.init_params(registry.build(cfg), IN_HW, seed=0)
    want = convert.to_state_dict(_jax_params(name))
    for k, p in tm.state_dict().items():
        w = want[k].numpy()
        if k.endswith("bias") or k.endswith("norm.weight"):
            np.testing.assert_array_equal(p.numpy(), w, err_msg=k)
        elif p.numel() > 1000:
            ratio = p.std().item() / w.std()
            assert abs(ratio - 1) < 0.1, (k, ratio)
            fan_in = p[0].numel()
            assert p.abs().max().item() <= 2 / fan_in ** 0.5 / 0.8796 + 1e-6
    again = tstep.init_params(registry.build(cfg), IN_HW, seed=0)
    for k, v in again.state_dict().items():
        assert torch.equal(v, tm.state_dict()[k]), k


def _batch(raw_hw, depth_hw, seed=0, b=2):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, *raw_hw, 3), dtype=np.uint8)
    depth = rng.uniform(1.0, 60.0, (b, *depth_hw)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    depth[:, :, -3:] = 81.0
    return img, depth


def test_train_step_f32_matches_jax_multiscale():
    """One train_step from the same params on the same raw batch (identity
    rows): loss, grad norm and the params after the update."""
    name = "multiscale"
    params = _jax_params(name)
    kw = dict(warmup_steps=0, total_steps=10)
    jm = jreg.build(JModelConfig(name=name, width_mult=WIDTH[name],
                                 compute_dtype="float32"))
    js = jstep.TrainState.create(jm.apply, jax.tree.map(jnp.asarray, params),
                                 jstep.make_optimizer(LR, **kw))
    tm = registry.build(ModelConfig(name=name, width_mult=WIDTH[name],
                                    compute_dtype="float32"))
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    ts = tstep.TrainState.create(tm, tstep.make_optimizer(LR, **kw))
    img, depth = _batch((120, 160), (30, 22))
    target_hw = registry.output_hw(name, IN_HW)
    js, jmet = jstep.train_step(
        js, jnp.asarray(img), jnp.asarray(depth), jax.random.key(0),
        input_hw=IN_HW, target_hw=target_hw, use_pallas=False,
        resize_precision="highest", emit_s2d=0)
    ts, tmet = tstep.train_step(ts, torch.from_numpy(img),
                                torch.from_numpy(depth), None,
                                input_hw=IN_HW, target_hw=target_hw)
    for k in ("loss", "grad_norm"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-4), k
    want = convert.to_state_dict(jax.tree.map(np.asarray, js.params))
    for k, v in ts.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


# Every preset's model at its full width and input size: the flax tree
# (shapes from jax.eval_shape, no compute) converts and loads strictly.
FULL_WIDTH = [("dpt-384", "dpt", 23_408_641),
              ("make3d-multiscale", "multiscale", 1_454_082),
              ("make3d-small", "small", 21_505),
              ("make3d-encdec", "encdec", 1_417_665)]


@pytest.mark.parametrize("preset,name,count", FULL_WIDTH)
def test_converter_loads_every_preset_at_full_width(preset, name, count):
    jcfg = jget_config(preset)
    jm = jreg.build(jcfg.model)
    shapes = jax.eval_shape(functools.partial(
        jstep.init_params, jm, jcfg.data.input_hw, 0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    cfg = get_config(preset)
    assert cfg.model.name == name
    tm = tstep.init_params(registry.build(cfg.model), cfg.data.input_hw)
    tm.load_state_dict(convert.to_state_dict(zeros), strict=True)
    assert sum(p.numel() for p in tm.parameters()) == count == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


# The CLI on the smoke preset (the small model, f32, synthetic data).
SMOKE = ["--config", "smoke", "--synth-n", "4", "--synth-test-n", "4",
         "--device", "cpu"]


def test_cli_train_eval_serve_smoke(tmp_path, capsys):
    ckpt = str(tmp_path / "c")
    assert cli.main(["train", *SMOKE, "--steps", "4", "--ckpt-dir", ckpt,
                     "--workdir", str(tmp_path)]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["loss"])
    assert tckpt.CheckpointManager(ckpt).all_steps() == [4]
    assert cli.main(["eval", *SMOKE, "--ckpt-dir", ckpt,
                     "--max-batches", "2"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(v) for v in metrics.values())
    for extra in (["--init"], ["--ckpt-dir", ckpt]):
        args = cli.build_parser().parse_args(
            ["serve", *SMOKE, "--raw-hw", "96", "128", "--max-batch", "2",
             *extra])
        svc = cli.make_service(args)
        try:
            out = svc.predict(np.zeros((96, 128, 3), np.uint8))
        finally:
            svc.close()
        assert out.shape == (30, 40) and np.isfinite(out).all()
    Image.fromarray(np.zeros((96, 128, 3), np.uint8)).save(tmp_path / "a.png")
    assert cli.main(["infer", *SMOKE, "--ckpt-dir", ckpt, "--image",
                     str(tmp_path / "a.png"), "--out-dir",
                     str(tmp_path / "o")]) == 0
    rec, = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.load(rec["depth_npy"]).shape == (30, 40)
    assert cli.main(["live", *SMOKE, "--ckpt-dir", ckpt, "--no-display",
                     "--max-frames", "3", "--video",
                     str(tmp_path / "missing.avi")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 3
