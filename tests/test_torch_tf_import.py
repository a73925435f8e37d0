"""The port's TF-checkpoint import (ann3depth_tpu_torch/compat/
tf_ckpt_import.py) and the inverse converter (convert.to_flax) against the
JAX package's `compat/tf_ckpt_import.py`, on the CPU.

- Name maps are keyed by flax paths in both packages and must be equal
  for the same model: small, encdec and multiscale at width 0.25 (48x64),
  dpt-small (64x64), both styles, with and without a scope.
- `convert.to_flax` inverts `convert.to_state_dict` exactly (a layout
  change only, no arithmetic).
- Import goes through a dict-backed reader (the module's `_reader`,
  which is `tf.train.load_checkpoint` otherwise): perturbed flax params
  (the JAX init plus normal(0, 0.05) noise) stored under the TF1 names
  import into the port model, whose forward then passes `verify_outputs`
  against the JAX model's on the same params at the gate's own default,
  the JAX package's pixel-parity tolerance: 1e-4 absolute plus 1e-4
  relative in log-depth (f32 on both sides, the JAX side at HIGHEST
  matmul precision, so summation order only; dpt-small's 6 blocks reach
  1.1e-4 on outputs ~0.5).
- The real TF round trip (a TF1 Saver checkpoint) is marked slow, as the
  JAX package's are: importing tensorflow alone takes seconds.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ann3depth_tpu.compat import tf_ckpt_import as jtfi
from ann3depth_tpu.config import ModelConfig as JModelConfig
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.compat import tf_ckpt_import as tfi
from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import step as tstep

MODELS = {"small": ((48, 64), 1.0), "encdec": ((48, 64), 0.25),
          "multiscale": ((48, 64), 0.25), "dpt-small": ((64, 64), 1.0)}


def _mcfg(cls, name):
    return cls(name=name, width_mult=MODELS[name][1], compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    model = jreg.build(_mcfg(JModelConfig, name))
    return jax.eval_shape(functools.partial(jstep.init_params, model,
                                            MODELS[name][0]), 0)


def _port_model(name):
    return tstep.init_params(registry.build(_mcfg(ModelConfig, name)),
                             MODELS[name][0]).eval()


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    model = jreg.build(_mcfg(JModelConfig, name))
    return jax.tree.map(np.asarray, jax.jit(functools.partial(
        jstep.init_params, model, MODELS[name][0]))(seed=0))


def _perturbed(name, seed):
    """The JAX init's params of `name` plus seeded normal(0, 0.05) noise,
    as the JAX package's round-trip tests perturb theirs."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: (v + rng.normal(0, 0.05, v.shape)).astype(
        np.float32), _jax_init(name))


def _random_flax(name, seed=0):
    """Flax-layout params of `name` (nested, as flax keeps them) drawn from
    a seeded normal: the shapes of the JAX init, other values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(0, 0.1, s.shape).astype(
        np.float32), _jax_shapes(name))


class DictReader:
    """A checkpoint reader over {name: array} (tf's CheckpointReader API)."""

    def __init__(self, arrays):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}

    def get_variable_to_shape_map(self):
        return {k: list(v.shape) for k, v in self.arrays.items()}

    def get_tensor(self, name):
        return self.arrays[name]


@pytest.fixture
def stage(monkeypatch):
    """stage(arrays) -> a checkpoint path the port's _reader serves."""
    readers = {}

    def put(arrays, path="ckpt"):
        readers[path] = DictReader(arrays)
        return path

    monkeypatch.setattr(tfi, "_reader", lambda path: readers[path])
    return put


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("style,scope", [("layers", ""), ("slim", "model")])
def test_tf1_scoped_name_map_equals_jax(name, style, scope):
    got = tfi.tf1_scoped_name_map(_port_model(name), style=style,
                                  scope=scope)
    assert got == jtfi.tf1_scoped_name_map(_jax_shapes(name), style=style,
                                           scope=scope)
    assert len(set(got.values())) == len(got)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_default_name_map_equals_jax(name):
    assert tfi.default_name_map(_port_model(name)) == jtfi.default_name_map(
        _jax_shapes(name))


def test_tf1_scoped_name_map_norm_layers_and_errors():
    m = tfi.tf1_scoped_name_map(_port_model("encdec"))
    assert m["enc0/GroupNorm_0/scale"] == "group_norm/gamma"
    assert m["enc1/GroupNorm_0/bias"] == "group_norm_1/beta"
    assert m["dec0/conv_up/kernel"] == "conv2d/kernel"
    with pytest.raises(ValueError, match="misses modules"):
        tfi.tf1_scoped_name_map(_port_model("small"), layer_order=["conv1"])
    with pytest.raises(ValueError, match="unknown style"):
        tfi.tf1_scoped_name_map(_port_model("small"), style="keras")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_to_flax_inverts_to_state_dict(name):
    flat = convert.flatten(_random_flax(name))
    sd = convert.to_state_dict(flat)
    back = convert.to_flax(sd, heads=4)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    model = _port_model(name)
    assert set(sd) == set(model.state_dict())
    again = convert.to_state_dict(convert.to_flax(model.state_dict(),
                                                  heads=4))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


def test_flax_name_inverts_torch_name():
    for key in ("conv1/kernel", "fuse1/Conv_1/kernel", "enc0/GroupNorm_0/scale",
                "block0/LayerNorm_1/bias", "block0/MLP_0/Dense_0/kernel",
                "block0/MultiHeadDotProductAttention_0/out/bias",
                "fuse2/Conv_0/kernel", "pos_embed", "head/bias"):
        assert convert.flax_name(convert.torch_name(key)) == key
    with pytest.raises(KeyError, match="no flax name"):
        convert.flax_name("enc0.norm.running_mean")
    with pytest.raises(ValueError, match="needs heads"):
        convert.flax_layout(
            "block0/MultiHeadDotProductAttention_0/query/kernel",
            np.zeros((8, 8), np.float32))


def _jax_forward(name, params, x):
    model = jreg.build(_mcfg(JModelConfig, name))
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(model.apply)({"params": params}, x))


@pytest.mark.parametrize("name", ["small", "encdec", "dpt-small"])
def test_import_equals_the_jax_forward(name, stage):
    params = _perturbed(name, seed=4)
    flat = convert.flatten(params)
    model = _port_model(name)
    name_map = tfi.tf1_scoped_name_map(model)
    ckpt = stage({name_map[p]: v for p, v in flat.items()})
    assert set(tfi.list_variables(ckpt)) == set(name_map.values())
    # The identity map misses the TF1 names: loud, nothing written.
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(KeyError, match="lacks variables"):
        tfi.import_checkpoint(ckpt, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert tfi.import_checkpoint(ckpt, model, name_map=name_map) is model
    x = np.random.default_rng(0).standard_normal(
        (2, *MODELS[name][0], 3)).astype(np.float32)
    want = _jax_forward(name, params, x)
    report = tfi.verify_outputs(model, x, want)
    assert report["within_tolerance"]
    with pytest.raises(AssertionError, match="parity failure"):
        tfi.verify_outputs(model, x, want + 1.0)


def test_import_shape_errors_and_transform(stage):
    """A checkpoint in a foreign kernel layout (OIHW) fails the flax-layout
    shape check loudly and imports through the transform hook."""
    model = _port_model("small")
    flat = convert.flatten(_random_flax("small", seed=2))
    name_map = tfi.tf1_scoped_name_map(model)
    foreign = {name_map[p]: (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
               for p, v in flat.items()}
    ckpt = stage(foreign)
    with pytest.raises(ValueError, match=r"shape mismatch at conv1/kernel: "
                       r"checkpoint \(32, 3, 5, 5\) vs model \(5, 5, 3, 32\)"):
        tfi.import_checkpoint(ckpt, model, name_map=name_map)

    def back(path, arr):
        return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr

    tfi.import_checkpoint(ckpt, model, name_map=name_map, transform=back)
    got = convert.to_flax(model.state_dict())
    for p, v in flat.items():
        np.testing.assert_array_equal(got[p], v)
    bad = stage({p: np.zeros((2, 2), np.float32) for p in flat}, "bad")
    with pytest.raises(ValueError, match="shape mismatch"):
        tfi.import_checkpoint(bad, model)


@pytest.mark.slow
def test_real_tf1_checkpoint_round_trip(tmp_path):
    """A TF1 Saver checkpoint in the hypothesized reference schema imports
    through the real reader; the forward equals the JAX model's."""
    tf = pytest.importorskip("tensorflow")
    params = _perturbed("small", seed=5)
    flat = convert.flatten(params)
    model = _port_model("small")
    name_map = tfi.tf1_scoped_name_map(model)
    with tf.Graph().as_default():
        variables = {name_map[p]: tf.compat.v1.get_variable(
            name_map[p], initializer=v) for p, v in flat.items()}
        saver = tf.compat.v1.train.Saver(var_list=variables)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            ckpt = saver.save(sess, str(tmp_path / "ref.ckpt"))
    assert set(tfi.list_variables(ckpt)) >= set(name_map.values())
    tfi.import_checkpoint(ckpt, model, name_map=name_map)
    x = np.random.default_rng(1).standard_normal((1, 48, 64, 3)).astype(
        np.float32)
    tfi.verify_outputs(model, x, _jax_forward("small", params, x))
