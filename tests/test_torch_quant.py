"""The port's int8 path (ann3depth_tpu_torch/ops/quant.py and its wiring in
models/encdec.py, models/dpt.py, models/registry.py, train/loop.py and the
CLI) against the JAX package's ops/quant.py, on the CPU.

Inputs and flax params (their shapes from `jax.eval_shape`) come from a
numpy seed; the params reach the port through `convert.to_state_dict`.
Tolerances:

- quantize_sym, qconv (3x3 stride 1, 3x3 stride 2 on even and odd sizes,
  1x1, bf16 input), qmatmul, QLinear against QDense, and every QConv and
  QLinear of a model against the JAX package's int8 op, both fed the
  input the flax layer gets inside the flax model: equal, bit for bit.
  Both sides quantize in f32 with round-half-to-even, the int32 sums are
  exact, and the dequantize is the same two f32 products (the JAX ops run
  op by op: inside a jit XLA's fusions round the dequantize elsewhere).
- fake_quant: equal values; its gradient is the identity.
- qconv_fake: forward 1e-5 absolute (outputs ~5), gradients 1e-4 relative
  to their largest entry: f32 convs in another summation order.
- QAttention against QMultiHeadAttention: the projections are exact; the
  score and value products are f32 (1e-5 absolute) or bf16 sums of
  another order (2^-7 relative to the output's largest entry: one bf16
  rounding of the scores or of the weights may land one ulp apart).
- whole int8 models against the flax int8 model: no bound tighter than
  the quantization error itself holds. A per-tensor activation scale is
  the tensor's max, so where the float layers between two int8 layers
  differ by f32 rounding (GroupNorm's and LayerNorm's variance formulas
  differ) a value within that rounding of a rounding boundary lands on the
  neighbouring int8 step, moving its conv's output by one step of the
  activation times a weight (about 1% of the output range), and the
  following layers carry it on. So the port's int8 output is held within
  1.5 times the distance of the flax int8 output from the flax float one
  (in max and in mean), and the layer-by-layer test above holds every
  quantized layer exactly.
- int8-qat train steps (f32 compute), each from the same weights on its
  own batch, against the JAX step: loss 2e-3 relative. f32 summation order
  alone moves it by ~1e-7; a fake-quant flip as above moved it by
  1.5e-4-6e-4 on three of eight batches (a chain of steps is not held:
  flips and Adam's sign-sensitive first steps part the two runs by ~1%
  within four steps).
- a JAX int8 artifact served by the port: tests/test_torch_serving.py's
  bf16 serving tolerance, 3e-2 relative in linear depth.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util
from PIL import Image

from ann3depth_tpu import config as jcfg
from ann3depth_tpu import serving as jserving
from ann3depth_tpu.config import ModelConfig as JModelConfig
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.models.dpt import DPTDepthNet as JDPT
from ann3depth_tpu.ops import quant as jq
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert, serving
from ann3depth_tpu_torch.config import ModelConfig, get_config
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.models.dpt import DPTDepthNet
from ann3depth_tpu_torch.ops import quant as tq
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep

IN_HW = (64, 64)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# dpt: the preset's widths (dim 384, 6 heads, MLP 1536) at depth 4;
# dpt-small: the registry's (dim 128, MLP 512, depth 6).
DPT_KW = {"dpt": dict(depth=4, tap_layers=(0, 1, 2, 3)),
          "dpt-small": dict(dim=128, depth=6, heads=4, fusion_features=64,
                            tap_layers=(1, 2, 4, 5))}
MODEL_FACTOR = 1.5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_torch(a):
    """A JAX array (f32 or bf16) as a torch tensor of its dtype, exactly."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


# ---------------------------------------------------------------------------
# The ops.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["activation", "kernel"])
def test_quantize_sym_matches_jax(kind):
    x = 3.0 * _rand((3, 3, 24, 40), 0)
    if kind == "activation":
        jv, js = jq.quantize_sym(jnp.asarray(x))
        tv, ts = tq.quantize_sym(torch.from_numpy(x))
    else:  # HWIO over (0, 1, 2) against OIHW over (1, 2, 3)
        jv, js = jq.quantize_sym(jnp.asarray(x), axis=(0, 1, 2))
        jv, js = (np.asarray(jv).transpose(3, 2, 0, 1),
                  np.asarray(js).transpose(3, 2, 0, 1))
        tv, ts = tq.quantize_sym(
            torch.from_numpy(x.transpose(3, 2, 0, 1).copy()), dim=(1, 2, 3))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("hw,k,stride,dtype", [
    ((12, 16), 3, 1, "f32"), ((12, 16), 3, 2, "f32"), ((13, 17), 3, 2, "f32"),
    ((12, 16), 1, 1, "f32"), ((12, 16), 3, 2, "bf16")])
def test_qconv_matches_jax(hw, k, stride, dtype):
    x = _rand((2, *hw, 24), 1)
    kern = _rand((k, k, 24, 32), 2)
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    want = np.asarray(jq.qconv(jx, jnp.asarray(kern), (stride, stride)))
    got = tq.qconv(_to_torch(jx).permute(0, 3, 1, 2),
                   torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                   stride)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qmatmul_matches_jax(dtype):
    x = jnp.asarray(_rand((3, 7, 24), 3)).astype(DTYPES[dtype][0])
    kern = _rand((24, 40), 4)
    want = np.asarray(jq.qmatmul(x, jnp.asarray(kern)))
    got = tq.qmatmul(_to_torch(x), torch.from_numpy(kern.T.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fake_quant_matches_jax_with_identity_gradient():
    x = 2.0 * _rand((2, 6, 8, 16), 5)
    want = np.asarray(jq.fake_quant(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    got = tq.fake_quant(t)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.from_numpy(_rand(x.shape, 6))
    got.backward(g)
    torch.testing.assert_close(t.grad, g, rtol=0, atol=0)
    want_k = np.asarray(jq.fake_quant(jnp.asarray(x), axis=(0, 1, 2)))
    got_k = tq.fake_quant(torch.from_numpy(x.transpose(3, 2, 0, 1).copy()),
                          dim=(1, 2, 3))
    np.testing.assert_array_equal(got_k.numpy().transpose(2, 3, 1, 0),
                                  want_k)


def test_qconv_fake_matches_jax_forward_and_gradients():
    x = _rand((2, 12, 16, 24), 7)
    kern = 0.1 * _rand((3, 3, 24, 32), 8)
    cot = _rand((2, 6, 8, 32), 9)

    def jloss(x, k):
        return jnp.sum(jq.qconv_fake(x, k, (2, 2)) * cot)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jq.qconv_fake(jnp.asarray(x), jnp.asarray(kern),
                                        (2, 2)))
        jgx, jgk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(kern))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    tk = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()).requires_grad_()
    got = tq.qconv_fake(tx, tk, 2)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, rtol=0, atol=1e-5)
    for g, w in ((tx.grad.permute(0, 2, 3, 1), jgx),
                 (tk.grad.permute(2, 3, 1, 0), jgk)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qlinear_matches_qdense(dtype):
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(_rand((2, 16, 128), 10)).astype(jdt)
    dense = jq.QDense(512, out_dtype=jdt)
    params = dense.init(jax.random.key(0), x)["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(_rand((512,), 11))}
    want = dense.apply({"params": params}, x)
    lin = tq.QLinear(128, 512)
    sd = convert.to_state_dict({"fc": jax.tree.map(np.asarray, params)})
    lin.load_state_dict({k[len("fc."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = lin(_to_torch(x))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qattention_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(_rand((2, 16, 128), 12)).astype(jdt)
    attn = jq.QMultiHeadAttention(num_heads=4, dtype=jdt)
    params = jax.tree.map(np.asarray,
                          attn.init(jax.random.key(1), x)["params"])
    want = np.asarray(attn.apply({"params": params}, x), np.float32)
    ta = tq.QAttention(128, 4)
    sd = convert.to_state_dict({"attn": params})
    ta.load_state_dict({k[len("attn."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ta(_to_torch(x))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The models.
# ---------------------------------------------------------------------------

def _jax_model(name, compute, quant):
    dt = DTYPES[compute][0]
    if name == "encdec":
        return jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=dt,
                                   quant=quant)
    return JDPT(compute_dtype=dt, remat=False, quant=quant, **DPT_KW[name])


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """A params tree of the flax model (shapes from `jax.eval_shape`, so
    nothing compiles) filled from a numpy seed: kernels normal with std
    1/sqrt(all axes but the last), biases normal(0.02), norm scales
    1 + normal(0.1), pos_embed normal(0.02)."""
    model = _jax_model(name, "f32", "none")
    shapes = jax.eval_shape(lambda: jstep.init_params(model, IN_HW, seed=0))
    rng = np.random.default_rng(16)

    def fill(path, leaf):
        kind = path[-1].key
        if kind == "kernel":
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
        elif kind == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        else:
            std = 0.02
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(name, compute, quant):
    tdt = DTYPES[compute][1]
    if name == "encdec":
        tm = registry.build(ModelConfig(
            name=name, width_mult=0.25, quant=quant,
            compute_dtype={"f32": "float32", "bf16": "bfloat16"}[compute]))
    else:
        tm = DPTDepthNet(compute_dtype=tdt, remat=False, quant=quant,
                         **DPT_KW[name])
    tm = tstep.init_params(tm, IN_HW)
    tm.load_state_dict(convert.to_state_dict(_jax_params(name)), strict=True)
    return tm.eval()


def _model_input():
    return _rand((2, *IN_HW, 3), 13)


@functools.lru_cache(maxsize=None)
def _jax_run(name, compute, quant):
    """The flax model's output on `_model_input()` (jitted, at HIGHEST
    precision) and {module path: input} of each of its int8 layers, sown
    from inside the jit."""
    model = _jax_model(name, compute, quant)

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(
                context.module,
                (jq.QConv, jq.QDense, jq.QMultiHeadAttention)):
            context.module.sow("intermediates", "layer_in", args[0])
        return next_fun(*args, **kwargs)

    def run(params, x):
        with nn.intercept_methods(record):
            return model.apply({"params": params}, x,
                               mutable=["intermediates"])

    with jax.default_matmul_precision("highest"):
        y, state = jax.jit(run)(_jax_params(name),
                                jnp.asarray(_model_input()))
    inputs = {key[:-1]: v for key, (v,) in traverse_util.flatten_dict(
        state.get("intermediates", {})).items()}
    return np.asarray(y, np.float32), inputs


def _jax_layer(mod, params, x):
    """The JAX package's int8 layer of the port's `mod` on x (op by op:
    XLA's fusions in a jit may round a product or a quotient elsewhere),
    in the dtype of x, as the flax layer gives it."""
    if isinstance(mod, tq.QConv):
        return jq.qconv(x, params["kernel"], (mod.stride,) * 2).astype(
            x.dtype)
    if isinstance(mod, tq.QLinear):
        return (jq.qmatmul(x, params["kernel"]) + params["bias"]).astype(
            x.dtype)
    return jq.QMultiHeadAttention(num_heads=mod.heads, dtype=x.dtype).apply(
        {"params": params}, x)


def _port_name(path):
    return ".".join(convert._MODULE_NAMES.get(m, m) for m in path)


# encdec both ways, the DPT family in one compute dtype each: every int8
# layer's arithmetic is exact in either, and each model's JAX compile costs
# seconds here.
MODEL_CASES = [("encdec", "bf16"), ("encdec", "f32"), ("dpt", "bf16"),
               ("dpt-small", "f32")]


@pytest.mark.parametrize("name,compute", MODEL_CASES)
def test_int8_layers_match_jax_layer_by_layer(name, compute):
    """Every int8 layer of the flax model, fed the input it gets in the
    flax model, through the JAX package's int8 op and through the port's
    layer of the same name: equal (attention within
    test_qattention_matches_jax's tolerance). Every quantized layer of
    the port is one the flax model quantizes."""
    _, inputs = _jax_run(name, compute, "int8")
    tm = _port_model(name, compute, "int8")
    mods = dict(tm.named_modules())
    quantized = {n for n, m in mods.items()
                 if isinstance(m, (tq.QConv, tq.QLinear, tq.QAttention))}
    assert {_port_name(p) for p in inputs} == quantized
    for path, x in inputs.items():
        mod = mods[_port_name(path)]
        params = functools.reduce(lambda d, k: d[k], path,
                                  _jax_params(name))
        with jax.default_matmul_precision("highest"):
            want = np.asarray(_jax_layer(mod, params, x), np.float32)
        tx = _to_torch(x)
        with torch.no_grad():
            if isinstance(mod, tq.QConv):
                got = mod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            else:
                got = mod(tx)
        got = got.float().numpy()
        if isinstance(mod, tq.QAttention):
            tol = 1e-5 if compute == "f32" else 2.0 ** -7 * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("name,compute", MODEL_CASES)
def test_int8_forward_matches_jax(name, compute):
    want, _ = _jax_run(name, compute, "int8")
    quant_err = np.abs(want - _jax_run(name, compute, "none")[0])
    tm = _port_model(name, compute, "int8")
    with torch.no_grad():
        got = tm(torch.from_numpy(_model_input())).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= MODEL_FACTOR * quant_err.max(), (err.max(),
                                                         quant_err.max())
    assert err.mean() <= MODEL_FACTOR * quant_err.mean(), (
        err.mean(), quant_err.mean())


def test_int8_models_share_the_float_params():
    for name in ("encdec", "dpt-small"):
        plain = registry.build(ModelConfig(name=name, width_mult=0.25))
        for quant in (("int8", "int8-qat") if name == "encdec"
                      else ("int8",)):
            q = registry.build(ModelConfig(name=name, width_mult=0.25,
                                           quant=quant))
            assert {k: v.shape for k, v in q.state_dict().items()} == \
                {k: v.shape for k, v in plain.state_dict().items()}
    enc = registry.build(ModelConfig(name="encdec", quant="int8-qat"))
    assert enc.enc0.conv_down.qat and type(enc.head) is not tq.QConv


@pytest.mark.parametrize("name", ["small", "encdec", "multiscale", "dpt",
                                  "dpt-small"])
@pytest.mark.parametrize("quant", ["none", "int8", "int8-qat"])
def test_registry_refuses_what_jax_refuses(name, quant):
    try:
        jreg.build(JModelConfig(name=name, quant=quant))
        jax_refuses = False
    except ValueError:
        jax_refuses = True
    if jax_refuses:
        with pytest.raises(ValueError, match="quant"):
            registry.build(ModelConfig(name=name, quant=quant))
    else:
        registry.build(ModelConfig(name=name, quant=quant))


# ---------------------------------------------------------------------------
# int8-qat training.
# ---------------------------------------------------------------------------

TRAIN_IN, TRAIN_TARGET, RAW, DEPTH = (32, 48), (16, 24), (40, 56), (15, 11)
QAT_LOSS_RTOL = 2e-3


def _batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, *RAW, 3), dtype=np.uint8)
    depth = rng.uniform(1.0, 60.0, (2, *DEPTH)).astype(np.float32)
    depth[:, ::3, ::4] = 0.0
    return img, depth


def test_qat_train_steps_match_jax():
    """int8-qat train steps, each from the same weights on its own batch,
    against the JAX step."""
    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32,
                                quant="int8-qat")
    params = _jax_params("encdec")  # the same tree as the float model's
    kw = dict(warmup_steps=0, total_steps=10)
    for s in range(3):
        js = jstep.TrainState.create(model.apply, params,
                                     jstep.make_optimizer(1e-3, **kw))
        tm = registry.build(ModelConfig(name="encdec", width_mult=0.25,
                                        compute_dtype="float32",
                                        quant="int8-qat"))
        tm.load_state_dict(convert.to_state_dict(params), strict=True)
        ts = tstep.TrainState.create(tm, tstep.make_optimizer(1e-3, **kw))
        img, depth = _batch(s)
        js, jm = jstep.train_step(
            js, jnp.asarray(img), jnp.asarray(depth), jax.random.key(0),
            input_hw=TRAIN_IN, target_hw=TRAIN_TARGET, use_pallas=False,
            resize_precision="highest", emit_s2d=0)
        ts, tmet = tstep.train_step(ts, torch.from_numpy(img),
                                    torch.from_numpy(depth), None,
                                    input_hw=TRAIN_IN,
                                    target_hw=TRAIN_TARGET)
        assert float(tmet["loss"]) == pytest.approx(float(jm["loss"]),
                                                    rel=QAT_LOSS_RTOL), s


def _loop_cfg(tmp_path, quant="int8-qat", **train):
    cfg = get_config("make3d-encdec")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, datasets=("synthetic",),
                                 input_hw=TRAIN_IN, synth_img_hw=RAW,
                                 synth_depth_hw=DEPTH, synth_n=8,
                                 synth_test_n=4, augment=False),
        model=dataclasses.replace(cfg.model, width_mult=0.25, quant=quant),
        train=dataclasses.replace(cfg.train, batch_size=2, steps=4,
                                  log_every=2, checkpoint_every=4,
                                  ckpt_dir=str(tmp_path / "ckpt"), **train))


@pytest.mark.parametrize("pool", [False, True])
def test_loop_trains_int8_qat(tmp_path, pool):
    """The loop trains int8-qat from the host feed, and from the device
    pool at 2 steps a dispatch; `int8` stays refused for training."""
    extra = dict(steps_per_dispatch=2) if pool else {}
    cfg = _loop_cfg(tmp_path, **extra)
    if pool:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, cache_device=True))
    state, metrics = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                                 device="cpu")
    assert state.step == 4 and np.isfinite(metrics["loss"])
    assert state.model.enc0.conv_down.qat
    with pytest.raises(ValueError, match="serving-only"):
        tloop.train(_loop_cfg(tmp_path, quant="int8"),
                    workdir=str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# Serving a JAX int8 artifact, and the CLI at --quant int8.
# ---------------------------------------------------------------------------

def test_jax_int8_artifact_served_by_the_port(tmp_path):
    cfg = jcfg.get_config("make3d-encdec")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=TRAIN_IN),
        model=dataclasses.replace(cfg.model, width_mult=0.25, quant="int8"))
    jm = jreg.build(cfg.model)
    params = _jax_params("encdec")  # no param depends on the input size
    jserving.export_serving(cfg, params, tmp_path, raw_hw=RAW,
                            platforms=("cpu",), config_name="make3d-encdec")
    frames = np.random.default_rng(14).integers(0, 256, (2, *RAW, 3),
                                                dtype=np.uint8)
    fn = jserving.make_serving_fn(jm, "encdec", TRAIN_IN,
                                  precision=jax.lax.Precision.HIGHEST)
    want = np.asarray(jax.jit(fn)(params, jnp.asarray(frames)))
    model = serving.load_serving(tmp_path, device="cpu")
    assert model.meta["quant"] == "int8"
    assert isinstance(model.model.enc0.conv_down, tq.QConv)
    np.testing.assert_allclose(model.predict(frames), want, rtol=3e-2)


CLI_SMALL = ["--config", "make3d-encdec", "--datasets", "synthetic",
             "--synth-n", "4", "--synth-test-n", "4", "--synth-hw", "40",
             "56", "--synth-depth-hw", "15", "11", "--width-mult", "0.25",
             "--batch-size", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A port checkpoint of a bf16 make3d-encdec trained 2 steps."""
    d = tmp_path_factory.mktemp("ckpt")
    assert cli.main(["train"] + CLI_SMALL + [
        "--steps", "2", "--ckpt-dir", str(d / "c"), "--workdir",
        str(d / "w")]) == 0
    return str(d / "c")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_eval_int8(ckpt, capsys):
    flags = ["--ckpt-dir", ckpt, "--max-batches", "1"]
    assert cli.main(["eval"] + CLI_SMALL + flags + ["--quant", "int8"]) == 0
    got = _last_json(capsys)
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        ["eval"] + CLI_SMALL + flags + ["--quant", "int8"]))
    assert cfg.model.quant == "int8"
    assert got == pytest.approx(tloop.evaluate(cfg, device="cpu",
                                               max_batches=1))
    assert cli.main(["eval"] + CLI_SMALL + flags) == 0
    assert _last_json(capsys) != got  # the int8 model is another function


def test_cli_infer_and_live_int8(ckpt, tmp_path, capsys):
    img = np.random.default_rng(15).integers(0, 256, (60, 80, 3), np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    assert cli.main(["infer"] + CLI_SMALL + [
        "--quant", "int8", "--ckpt-dir", ckpt, "--image",
        str(tmp_path / "a.png"), "--out-dir", str(tmp_path)]) == 0
    rec, = _last_json(capsys)
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        ["infer"] + CLI_SMALL + ["--quant", "int8", "--ckpt-dir", ckpt]))
    model = serving.model_from_checkpoint(cfg, device="cpu")
    assert isinstance(model.enc1.conv_refine, tq.QConv)
    want = tstep.infer_image(model, img, input_hw=cfg.data.input_hw)
    np.testing.assert_array_equal(np.load(rec["depth_npy"]), want)
    assert cli.main(["live"] + CLI_SMALL + [
        "--quant", "int8", "--ckpt-dir", ckpt, "--no-display",
        "--max-frames", "3", "--video", str(tmp_path / "none.avi")]) == 0
    stats = _last_json(capsys)
    assert stats["frames"] == 3 and np.isfinite(stats["latency_p50_ms"])


@pytest.mark.parametrize("model", ["dpt-small"])
def test_cli_serve_int8_dpt_family(model):
    """`serve --quant int8` builds the DPT family's int8 twin and answers
    (the full dpt at int8 on the CPU costs seconds a frame; its layers are
    held above, and chip_smoke.py serves it on the card)."""
    args = cli.build_parser().parse_args(
        ["serve", "--config", "make3d-encdec", "--model", model, "--quant",
         "int8", "--init", "--device", "cpu", "--raw-hw", "40", "56",
         "--max-batch", "2"])
    svc = cli.make_service(args)
    try:
        out = svc.predict(np.random.default_rng(17).integers(
            0, 256, (40, 56, 3), dtype=np.uint8))
    finally:
        svc.close()
    assert out.shape == (240, 320) and np.isfinite(out).all()
    assert (out > 0).all()
