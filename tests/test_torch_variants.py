"""The JAX models' variant fields in the port, on the CPU, against the flax
models: DPT `upsample` ("resize" | "matmul") and `attention_impl`
("flax" | "jnn" | "fused"), encdec `norm` ("group" | "none") and
`upsample` ("matmul" | "resize"), and `UpStage(refine=True)`; and
`CapturableSGD`, the sgd rule on every device (train/step.py).

DPT runs at the JAX variant test's size (tests/test_models.py:139: dim 64,
depth 4, 2 heads, fusion features 32, every layer tapped, 32x32 input),
encdec at width_mult 0.25 and 64x64. Inputs come from a numpy seed, and
the port's weights are the flax init's, through `convert.py`.
Tolerances:

- f32 forward against flax: 1e-4 absolute and relative on log-depth (as
  tests/test_models.py holds "fused" against "flax"; both sides f32, the
  JAX side at HIGHEST matmul precision, apart in summation order).
- DPT "matmul" against "resize" in the port, f32: 1e-5 absolute. At an
  integer factor both are the same bilinear function; they differ in
  summation order only.
- One f32 train step at upsample "matmul" against the JAX step: the
  tolerances of tests/test_torch_dpt.py's step test (loss and grad norm
  1e-4 relative; params within 2 lr, and within 1e-5 for all but 0.01%).
- `ops.resize.upsample_matmul_nhwc` against JAX's `upsample_matmul`: 1e-6
  (f32, the same fixed matrices; summation order only).
- `CapturableSGD` against torch's SGD on the same gradients: 1e-6
  absolute (p - lr t against p + (-lr) t may round apart by an ulp).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.models import dpt as jdpt
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.ops import resize as jresize
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert, serving
from ann3depth_tpu_torch.models import dpt as tdpt
from ann3depth_tpu_torch.models import encdec as tenc
from ann3depth_tpu_torch.ops import resize as tresize
from ann3depth_tpu_torch.parallel import sharding_rules
from ann3depth_tpu_torch.train import step as tstep

DPT_KW = dict(dim=64, depth=4, heads=2, fusion_features=32,
              tap_layers=(0, 1, 2, 3), remat=False)
DPT_HW = (32, 32)
ENC_HW = (64, 64)
TOL = 1e-4
SAME_FN_TOL = 1e-5
LR = 1e-3
UPSAMPLES = ("resize", "matmul")
ATTENTIONS = ("flax", "jnn", "fused")


def _input(hw, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, *hw, 3)).astype(np.float32)


def _jax_dpt(upsample="resize", attention_impl="flax"):
    return jdpt.DPTDepthNet(compute_dtype=jnp.float32, upsample=upsample,
                            attention_impl=attention_impl, **DPT_KW)


@functools.lru_cache(maxsize=None)
def _jax_dpt_params():
    """The flax init (every variant has this tree: tests/test_models.py)."""
    params = jax.jit(functools.partial(jstep.init_params, _jax_dpt(),
                                       DPT_HW))(seed=0)
    return jax.tree.map(np.asarray, params)


def _port_dpt(upsample="resize", attention_impl="flax"):
    tm = tdpt.DPTDepthNet(compute_dtype=torch.float32, upsample=upsample,
                          attention_impl=attention_impl, **DPT_KW)
    tstep.init_params(tm, DPT_HW)
    tm.load_state_dict(convert.to_state_dict(_jax_dpt_params()), strict=True)
    return tm.eval()


@pytest.mark.parametrize("attention_impl", ATTENTIONS)
@pytest.mark.parametrize("upsample", UPSAMPLES)
def test_dpt_variant_forward_matches_flax(upsample, attention_impl):
    x = _input(DPT_HW)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(_jax_dpt(upsample, attention_impl).apply)(
            {"params": _jax_dpt_params()}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_dpt(upsample, attention_impl)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, *DPT_HW, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_matmul_nhwc_is_upsample_matmul(factor):
    """DPT's matmul upsample: JAX's upsample_matmul as two batched GEMMs
    with a contiguous NHWC result."""
    x = np.random.default_rng(8).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    got = tresize.upsample_matmul_nhwc(torch.from_numpy(x), factor)
    assert got.shape == (2, 5 * factor, 7 * factor, 3) and got.is_contiguous()
    want = jresize.upsample_matmul(jnp.asarray(x), factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(
        got, tresize.upsample_matmul(torch.from_numpy(x), factor), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("head_stride", [2, 4])
def test_dpt_matmul_upsample_is_the_resize_function(head_stride):
    params = convert.to_state_dict(_jax_dpt_params())
    x = torch.from_numpy(_input(DPT_HW, seed=3))
    outs = []
    for upsample in UPSAMPLES:
        tm = tdpt.DPTDepthNet(compute_dtype=torch.float32, upsample=upsample,
                              head_stride=head_stride, **DPT_KW)
        tstep.init_params(tm, DPT_HW)
        tm.load_state_dict(params, strict=True)
        with torch.no_grad():
            outs.append(tm(x))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=SAME_FN_TOL)


def test_dpt_matmul_upsample_under_remat_and_bf16():
    """remat_call recomputes the fusion blocks with the same upsample, and
    the bf16 fusion path stays in bf16 through the GEMMs."""
    params = convert.to_state_dict(_jax_dpt_params())
    x = torch.from_numpy(_input(DPT_HW, seed=4))
    grads = []
    for remat in (False, True):
        tm = tdpt.DPTDepthNet(upsample="matmul", **{**DPT_KW,
                                                    "remat": remat})
        tstep.init_params(tm, DPT_HW)
        tm.load_state_dict(params, strict=True)
        tm.zero_grad()
        y = tm(x)
        assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
        (y ** 2).mean().backward()
        grads.append({k: p.grad.clone() for k, p in tm.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0,
                                   msg=k)
    skip = torch.randn(1, 32, 4, 4, dtype=torch.bfloat16)
    assert tdpt._up(skip, 4, "matmul").dtype == torch.bfloat16


def test_dpt_matmul_upsample_at_int8():
    """quant "int8" leaves the fusion head in the compute dtype, so the
    field applies there too: the same function as "resize" (f32)."""
    params = convert.to_state_dict(_jax_dpt_params())
    x = torch.from_numpy(_input(DPT_HW, seed=9))
    outs = []
    for upsample in UPSAMPLES:
        tm = tdpt.DPTDepthNet(compute_dtype=torch.float32, quant="int8",
                              upsample=upsample, **DPT_KW)
        tstep.init_params(tm, DPT_HW)
        tm.load_state_dict(params, strict=True)
        with torch.no_grad():
            outs.append(tm.eval()(x))
    assert bool(torch.isfinite(outs[1]).all())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=SAME_FN_TOL)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, 48, 40, 3), dtype=np.uint8)
    depth = rng.uniform(1.0, 60.0, (b, 20, 12)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    return img, depth


def test_dpt_matmul_train_step_matches_jax():
    params = _jax_dpt_params()
    kw = dict(warmup_steps=0, total_steps=10)
    js = jstep.TrainState.create(_jax_dpt("matmul").apply,
                                 jax.tree.map(jnp.asarray, params),
                                 jstep.make_optimizer(LR, **kw))
    ts = tstep.TrainState.create(_port_dpt("matmul").train(),
                                 tstep.make_optimizer(LR, **kw))
    img, depth = _batch()
    js, jmet = jstep.train_step(
        js, jnp.asarray(img), jnp.asarray(depth), jax.random.key(0),
        input_hw=DPT_HW, target_hw=DPT_HW, use_pallas=False,
        resize_precision="highest", emit_s2d=0)
    ts, tmet = tstep.train_step(ts, torch.from_numpy(img),
                                torch.from_numpy(depth), None,
                                input_hw=DPT_HW, target_hw=DPT_HW)
    for k in ("loss", "grad_norm"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-4), k
    want = convert.to_state_dict(jax.tree.map(np.asarray, js.params))
    diff = {k: np.abs(v.numpy() - want[k].numpy())
            for k, v in ts.model.state_dict().items()}
    assert max(d.max() for d in diff.values()) <= 2 * LR
    rest = np.concatenate([d.ravel() for k, d in diff.items()
                           if not k.endswith("attn.key.bias")])
    assert (rest > 1e-5).mean() <= 1e-4, (rest > 1e-5).sum()


def test_fused_attention_interchanges_with_flax():
    """The JAX test's point (tests/test_models.py:139): the same
    state_dict keys and shapes, a strict load either way, the same init
    scale, and a gradient on every projection weight."""
    flax_m = tstep.init_params(tdpt.DPTDepthNet(**DPT_KW), DPT_HW, seed=0)
    fused = tstep.init_params(tdpt.DPTDepthNet(attention_impl="fused",
                                               **DPT_KW), DPT_HW, seed=0)
    assert isinstance(fused.block0.attn, tdpt.FusedQKVSelfAttention)
    sd, fsd = flax_m.state_dict(), fused.state_dict()
    assert list(sd) == list(fsd)
    assert all(sd[k].shape == fsd[k].shape for k in sd)
    for k, v in sd.items():  # one seed, one draw order: the same init
        torch.testing.assert_close(fsd[k], v, rtol=0, atol=0, msg=k)
    fused.load_state_dict(sd, strict=True)
    flax_m.load_state_dict(fsd, strict=True)
    x = torch.from_numpy(_input(DPT_HW, seed=5))
    fused.zero_grad()
    (fused(x) ** 2).mean().backward()
    for i in range(DPT_KW["depth"]):
        for proj in ("query", "key", "value", "out"):
            g = getattr(getattr(fused, f"block{i}").attn, proj).weight.grad
            assert g is not None and float(g.abs().sum()) > 0, (i, proj)


def test_attention_impl_and_upsample_are_checked():
    with pytest.raises(ValueError, match="attention_impl"):
        tdpt.DPTDepthNet(attention_impl="flash", **DPT_KW)
    with pytest.raises(ValueError, match="upsample"):
        tdpt.DPTDepthNet(upsample="nearest", **DPT_KW)
    # int8 takes precedence over the attention impl, as in JAX
    block = tdpt.Block(64, 2, quant="int8", attention_impl="fused")
    from ann3depth_tpu_torch.ops.quant import QAttention
    assert type(block.attn) is QAttention


def test_tensor_parallel_shards_the_fused_attention():
    """A fused block takes the same swap as a flax one: the same plan, and
    its one-process tp twin computes the same function (f32)."""
    from ann3depth_tpu_torch.parallel.mesh import Mesh

    plans, outs = [], []
    x = torch.from_numpy(_input(DPT_HW, seed=6))
    for impl in ("flax", "fused"):
        tm = _port_dpt(attention_impl=impl)
        twin = sharding_rules.tp_twin(_port_dpt(attention_impl=impl), 2)
        assert type(twin.block0.attn) is sharding_rules._TwinAttention
        with torch.no_grad():
            torch.testing.assert_close(twin(x), tm(x), rtol=0, atol=1e-5)
            outs.append(tm(x))
        mesh = Mesh(n_model=2, model_rank=0)
        plans.append(sharding_rules.shard_params(_port_dpt(
            attention_impl=impl), mesh))
    assert plans[0] == plans[1] and "block0.attn.query.weight" in plans[1]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# encdec: norm, upsample, refine.
# ---------------------------------------------------------------------------

ENC_VARIANTS = {"norm_none": dict(norm="none"),
                "upsample_resize": dict(upsample="resize")}


@functools.lru_cache(maxsize=None)
def _jax_enc_params(variant):
    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32,
                                **ENC_VARIANTS[variant])
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        jstep.init_params, model, ENC_HW))(seed=0))


@pytest.mark.parametrize("variant", sorted(ENC_VARIANTS))
def test_encdec_variant_forward_matches_flax(variant):
    kw = ENC_VARIANTS[variant]
    params = _jax_enc_params(variant)
    x = _input(ENC_HW, seed=1)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jenc.EncDecDepthNet(
            width_mult=0.25, compute_dtype=jnp.float32, **kw).apply)(
                {"params": params}, jnp.asarray(x))
    tm = tenc.EncDecDepthNet(width_mult=0.25, compute_dtype=torch.float32,
                             **kw)
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _upstage_pair(refine=True):
    jm = jenc.UpStage(16, refine=refine, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 6, 24)).astype(np.float32)
    skip = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(skip))["params"])
    tm = tenc.UpStage(24, 8, 16, refine=refine)
    return jm, tm, params, x, skip


def test_upstage_refine_matches_flax():
    jm, tm, params, x, skip = _upstage_pair()
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(skip))
    tm.load_state_dict(convert.to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(skip).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", sorted(ENC_VARIANTS) + ["refine"])
def test_encdec_variant_param_tree_matches_flax(variant):
    """The converted flax tree is the port's state_dict, key for key and
    shape for shape, and the port's flax-style init has the same tree."""
    if variant == "refine":
        _, tm, params, _, _ = _upstage_pair()
        tm = tenc.init_flax_(tm)
        assert "conv_refine" in params
    else:
        params = _jax_enc_params(variant)
        tm = tstep.init_params(tenc.EncDecDepthNet(
            width_mult=0.25, **ENC_VARIANTS[variant]), ENC_HW)
    sd = convert.to_state_dict(params)
    assert sorted(sd) == sorted(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert sd[k].shape == v.shape, k
    if variant == "norm_none":
        assert not any(".norm." in k for k in sd)
        assert not any("GroupNorm" in k for k in convert.flatten(params))


def test_norm_free_artifact_does_not_load_into_a_group_norm_model():
    """An artifact records no norm: a norm-free encdec's params raise on
    the strict load of the registry's model, rather than load wrong."""
    sd = tstep.init_params(tenc.EncDecDepthNet(width_mult=0.25, norm="none"),
                           ENC_HW).state_dict()
    assert tenc.EncDecDepthNet.width_mult_of(sd) == 0.25
    with pytest.raises(RuntimeError, match="norm"):
        serving.model_from_artifact(
            {"model": "encdec", "input_hw": list(ENC_HW)}, sd)


def test_encdec_variant_values_are_checked():
    with pytest.raises(ValueError, match="norm"):
        tenc.Stage(8, 16, norm="batch")
    with pytest.raises(ValueError, match="upsample"):
        tenc.UpStage(16, 8, 8, upsample="nearest")


# ---------------------------------------------------------------------------
# CapturableSGD, the sgd rule, against torch's SGD.
# ---------------------------------------------------------------------------

def _sgd_pair(b1, wd):
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(5, 3, generator=gen), torch.randn(7, generator=gen)]
    a = [torch.nn.Parameter(t.clone()) for t in init]
    b = [torch.nn.Parameter(t.clone()) for t in init]
    plain = torch.optim.SGD(a, lr=0.0, momentum=b1, weight_decay=wd)
    lr = torch.zeros(())
    capt = tstep.CapturableSGD(b, lr=lr, momentum=b1, weight_decay=wd)
    return a, b, plain, capt, lr, gen


@pytest.mark.parametrize("b1,wd", [(0.0, 0.0), (0.9, 0.0), (0.9, 1e-4),
                                   (0.0, 1e-2)])
def test_capturable_sgd_matches_torch_sgd(b1, wd):
    a, b, plain, capt, lr, gen = _sgd_pair(b1, wd)
    for step in range(4):
        value = 0.1 / (step + 1)
        for pa, pb in zip(a, b):
            g = torch.randn(pa.shape, generator=gen)
            pa.grad, pb.grad = g.clone(), g.clone()
        for group in plain.param_groups:
            group["lr"] = value
        lr.fill_(value)
        plain.step()
        capt.step()
        for pa, pb in zip(a, b):
            torch.testing.assert_close(pb.detach(), pa.detach(), rtol=0,
                                       atol=1e-6)
    assert set(capt.state_dict()["state"]) == set(
        plain.state_dict()["state"])


def test_capturable_sgd_restores_a_torch_sgd_checkpoint():
    """The trace keeps torch's `momentum_buffer` key: a checkpoint of
    torch's SGD resumes in CapturableSGD (and back), through
    `load_optimizer_state`, which keeps the device-tensor rate."""
    a, b, plain, capt, lr, gen = _sgd_pair(0.9, 1e-4)
    for p in a:
        p.grad = torch.randn(p.shape, generator=gen)
    plain.param_groups[0]["lr"] = 0.05
    plain.step()
    tstep.load_optimizer_state(capt, plain.state_dict())
    assert capt.param_groups[0]["lr"] is lr
    for pa, pb in zip(a, b):
        torch.testing.assert_close(capt.state[pb]["momentum_buffer"],
                                   plain.state[pa]["momentum_buffer"])
    back = torch.optim.SGD(a, lr=0.0, momentum=0.9, weight_decay=1e-4)
    tstep.load_optimizer_state(back, capt.state_dict())
    assert back.param_groups[0]["lr"] == 0.0
