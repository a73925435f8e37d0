"""Parity of the port's DPTDepthNet (ann3depth_tpu_torch/models/dpt.py) with
the flax model, on the CPU: `dpt` at full width (dim 384, depth 12, 6
heads) and `dpt-small` (dim 128, depth 6, 4 heads), both at a 64x64 input
(16 tokens), with head_stride 2 and 4. Mirrors tests/test_dpt.py.

Flax params from the JAX package's `init_params` go through
`convert.to_state_dict`. Tolerances on log-depth (outputs ~5 at init):

- f32: 1e-4 absolute. Both sides f32 (the JAX side at HIGHEST matmul
  precision); they differ in summation order, and LayerNorm's variance is
  flax's E[x^2] - E[x]^2 against torch's two-pass one.
- bf16: twice the distance of the flax bf16 output from the flax f32 one,
  in max and in mean. Every matmul output is rounded to bf16 on both
  sides, but not at the same places (flax also takes the attention
  softmax in bf16, SDPA sums it in f32), so the two bf16 outputs are as
  far apart as bf16 rounding moves either from the f32 one: on this input
  about 2.4% of the output's magnitude at most and 0.5% in mean.
- remat: the same function; outputs and gradients agree to 1e-5.
- one f32 train step against the JAX train_step: loss and grad norm 1e-4
  relative; params after the update within 2 lr, and within 1e-5 for all
  but 0.01% of them. Adam's first step moves a param by lr g/(|g| + eps):
  where |g| is near eps, f32 rounding of g moves that by more than 1e-5.
  The attention's key biases are left out of the count: softmax does not
  see a shift that is the same for every key, so their gradient is zero
  up to rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.config import ModelConfig as JModelConfig
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.models.dpt import DPTDepthNet as JDPT
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import ModelConfig, get_config
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.models.dpt import DPTDepthNet
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep

IN_HW = (64, 64)
F32_TOL = 1e-4
BF16_FACTOR = 2.0
LR = 1e-3
SMALL = dict(dim=128, depth=6, heads=4, fusion_features=64,
             tap_layers=(1, 2, 4, 5))
VARIANTS = {"dpt": {}, "dpt-small": SMALL}


def _jax_model(name, compute="float32", head_stride=2):
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    return JDPT(compute_dtype=dt, remat=False, head_stride=head_stride,
                **VARIANTS[name])


@functools.lru_cache(maxsize=None)
def _jax_params(name, head_stride=2, seed=0):
    model = _jax_model(name, head_stride=head_stride)
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=seed)
    return jax.tree.map(np.asarray, params)


def _port(name, params, compute="float32", head_stride=2, remat=False):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    tm = DPTDepthNet(compute_dtype=dt, remat=remat, head_stride=head_stride,
                     **VARIANTS[name])
    tstep.init_params(tm, IN_HW)
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    return tm.eval()


def _input(shape=(2, *IN_HW, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_out(name, compute="float32", head_stride=2):
    """The flax model's output on `_input()`, op by op (a jit of the
    12-block model compiles for longer than it runs here)."""
    jm = _jax_model(name, compute, head_stride)
    with jax.default_matmul_precision("highest"):
        y = jm.apply({"params": _jax_params(name, head_stride)},
                     jnp.asarray(_input()))
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("name,head_stride", [("dpt", 2), ("dpt-small", 2),
                                              ("dpt-small", 4)])
def test_forward_f32_matches_flax(name, head_stride):
    tm = _port(name, _jax_params(name, head_stride), head_stride=head_stride)
    want = _jax_out(name, head_stride=head_stride)
    with torch.no_grad():
        got = tm(torch.from_numpy(_input()))
    assert got.shape == want.shape == (2, *IN_HW, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("name", ["dpt", "dpt-small"])
def test_forward_bf16_matches_flax(name):
    tm = _port(name, _jax_params(name), compute="bfloat16")
    want = _jax_out(name, "bfloat16")
    with torch.no_grad():
        got = tm(torch.from_numpy(_input())).numpy()
    assert got.dtype == np.float32
    err = np.abs(got - want)
    rounding = np.abs(want - _jax_out(name))
    assert err.max() <= BF16_FACTOR * rounding.max(), (err.max(), rounding)
    assert err.mean() <= BF16_FACTOR * rounding.mean(), (err.mean(),
                                                          rounding.mean())


def test_param_tree_and_count_match_flax_at_full_width():
    params = _jax_params("dpt")
    sd = convert.to_state_dict(params)
    tm = tstep.init_params(DPTDepthNet(), IN_HW)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert sd[k].shape == v.shape, k
    n_flax = sum(a.size for a in jax.tree.leaves(params))
    assert n_flax == sum(p.numel() for p in tm.parameters())


def test_converter_attention_layouts():
    params = _jax_params("dpt-small")
    sd = convert.to_state_dict(params)
    attn = params["block0"]["MultiHeadDotProductAttention_0"]
    q = attn["query"]["kernel"]                        # (E, H, D)
    np.testing.assert_array_equal(sd["block0.attn.query.weight"].numpy(),
                                  q.reshape(q.shape[0], -1).T)
    np.testing.assert_array_equal(sd["block0.attn.query.bias"].numpy(),
                                  attn["query"]["bias"].reshape(-1))
    o = attn["out"]["kernel"]                          # (H, D, E)
    np.testing.assert_array_equal(sd["block0.attn.out.weight"].numpy(),
                                  o.reshape(-1, o.shape[-1]).T)
    np.testing.assert_array_equal(
        sd["block0.mlp.fc1.weight"].numpy(),
        params["block0"]["MLP_0"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["block0.norm2.weight"].numpy(),
                                  params["block0"]["LayerNorm_1"]["scale"])
    np.testing.assert_array_equal(
        sd["fuse1.conv_skip.weight"].numpy(),
        params["fuse1"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["pos_embed"].numpy(),
                                  params["pos_embed"])


def test_pos_embed_needs_the_input_size():
    tm = DPTDepthNet(**SMALL)
    with pytest.raises(ValueError, match="input size"):
        tm.init_weights()
    tstep.init_params(tm, IN_HW)
    assert tm.pos_embed.shape == (1, 16, 128)
    with pytest.raises(ValueError, match="tokens"):
        tm(torch.zeros(1, 32, 32, 3))


def _loss_and_grads(model, x):
    model.zero_grad(set_to_none=True)
    y = model(x)
    (y ** 2).mean().backward()
    return y.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_remat_gives_equal_outputs_and_gradients():
    """remat wraps every Block and FusionBlock (flax nn.remat)."""
    params = _jax_params("dpt-small")
    plain = _port("dpt-small", params)
    remat = _port("dpt-small", params, remat=True)
    x = torch.from_numpy(_input(seed=2))
    y0, g0 = _loss_and_grads(plain, x)
    y1, g1 = _loss_and_grads(remat, x)
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-5)
    assert sum(g.abs().sum() > 0 for g in g0.values()) >= len(g0) - 4
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


def test_init_follows_flax_initializer_statistics():
    """Per param of the full-width model, the std of the port's init
    against flax's (more than 1000 draws: sampling error under 5%):
    lecun_normal convs and dense kernels, q/k/v with fan-in E and out with
    fan-in H*D, zero biases, LayerNorm 1 and 0, pos_embed normal(0.02)
    without truncation."""
    tm = tstep.init_params(DPTDepthNet(), IN_HW, seed=0)
    want = convert.to_state_dict(_jax_params("dpt"))
    for k, p in tm.state_dict().items():
        w = want[k].numpy()
        if k.endswith("bias") or ".norm" in k:
            np.testing.assert_array_equal(p.numpy(), w, err_msg=k)
        elif p.numel() > 1000:
            ratio = p.std().item() / w.std()
            assert abs(ratio - 1) < 0.1, (k, ratio)
    q, o = tm.block0.attn.query.weight, tm.block0.attn.out.weight
    assert abs(q.std().item() * 384 ** 0.5 - 1) < 0.02
    assert abs(o.std().item() * 384 ** 0.5 - 1) < 0.02
    pos = tm.pos_embed.detach()
    assert abs(pos.std().item() / 0.02 - 1) < 0.05
    assert pos.abs().max().item() > 2 * 0.02  # not truncated


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, 80, 96, 3), dtype=np.uint8)
    depth = rng.uniform(1.0, 60.0, (b, 30, 22)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    depth[:, :, -3:] = 81.0
    return img, depth


def test_train_step_f32_matches_jax_dpt_small():
    """One train_step from the same params on the same raw batch (identity
    rows, depth upsampled on both axes): loss, grad norm and the params
    after the update."""
    params = _jax_params("dpt-small")
    kw = dict(warmup_steps=0, total_steps=10)
    js = jstep.TrainState.create(_jax_model("dpt-small").apply,
                                 jax.tree.map(jnp.asarray, params),
                                 jstep.make_optimizer(LR, **kw))
    ts = tstep.TrainState.create(_port("dpt-small", params).train(),
                                 tstep.make_optimizer(LR, **kw))
    img, depth = _batch()
    js, jmet = jstep.train_step(
        js, jnp.asarray(img), jnp.asarray(depth), jax.random.key(0),
        input_hw=IN_HW, target_hw=IN_HW, use_pallas=False,
        resize_precision="highest", emit_s2d=0)
    ts, tmet = tstep.train_step(ts, torch.from_numpy(img),
                                torch.from_numpy(depth), None,
                                input_hw=IN_HW, target_hw=IN_HW)
    for k in ("loss", "grad_norm"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-4), k
    want = convert.to_state_dict(jax.tree.map(np.asarray, js.params))
    diff = {k: np.abs(v.numpy() - want[k].numpy())
            for k, v in ts.model.state_dict().items()}
    assert max(d.max() for d in diff.values()) <= 2 * LR
    rest = np.concatenate([d.ravel() for k, d in diff.items()
                           if not k.endswith("attn.key.bias")])
    assert (rest > 1e-5).mean() <= 1e-4, (rest > 1e-5).sum()


def test_registry_builds_the_jax_variants():
    for name, kw in VARIANTS.items():
        tm = registry.build(ModelConfig(name=name))
        jm = jreg.build(JModelConfig(name=name))
        assert (tm.dim, tm.depth, tm.tap_layers) == (
            jm.dim, jm.depth, tuple(jm.tap_layers))
        assert tm.block0.attn.heads == jm.heads
        assert tm.head_stride == jm.head_stride == 2
        assert registry.output_hw(name, (384, 384)) == (384, 384)
        assert registry.s2d_input_factor(name) == 0


def test_loop_trains_and_evaluates_dpt_small(tmp_path):
    """--model dpt-small through the loop API at a 64x64 input, on the
    CPU: train with augmentation, resume, evaluate from the checkpoint."""
    cfg = get_config("smoke")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, input_hw=IN_HW, augment=True,
                                 synth_n=4, synth_test_n=4,
                                 synth_img_hw=(48, 64),
                                 synth_depth_hw=(48, 64)),
        model=dataclasses.replace(cfg.model, name="dpt-small"),
        train=dataclasses.replace(cfg.train, steps=2, log_every=1,
                                  checkpoint_every=2,
                                  ckpt_dir=str(tmp_path / "c")))
    state, metrics = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                                 device="cpu")
    assert state.step == 2 and np.isfinite(metrics["loss"])
    resumed = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=3, resume=True))
    state, _ = tloop.train(resumed, workdir=str(tmp_path), progress=False,
                           device="cpu")
    assert state.step == 3
    got = tloop.evaluate(cfg, device="cpu", max_batches=1)
    assert got == tloop.evaluate(cfg, state=state, max_batches=1)
    assert all(np.isfinite(v) for v in got.values())
