"""The port's public surface against the JAX package's, on the CPU.

Every public name (a top-level def, class or assignment without a leading
underscore) of every module of ann3depth_tpu/ has a counterpart in the
module of the same path in ann3depth_tpu_torch/, or under another name or
in another module (RENAMED), or sits in EXCEPTIONS with the reason the
port has none. Names are read from the source (ast), so no module is
imported for it. The port's CLI has the JAX CLI's subcommands; the public
names this slice adds behave as their JAX counterparts.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ann3depth_tpu import cli as jcli
from ann3depth_tpu.compat import reference_spec as jref
from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch.compat import reference_spec as tref
from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.utils import tb_writer, tracing

ROOT = Path(__file__).resolve().parent.parent
JAX_MODULES = sorted(str(p.relative_to(ROOT / "ann3depth_tpu"))
                     for p in (ROOT / "ann3depth_tpu").rglob("*.py"))

# (JAX module, name) -> (port module, port name).
RENAMED = {
    ("ops/pallas_preprocess.py", n): ("ops/fused_preprocess.py", n)
    for n in ("CROP_FRAC", "augment_params", "fused_preprocess",
              "fused_preprocess_v2", "geometry_of", "identity_params")}
RENAMED.update({
    ("ops/pallas_preprocess.py", "oracle_preprocess"):
        ("ops/fused_preprocess.py", "plain_preprocess"),
    ("ops/pallas_preprocess.py", "oracle_preprocess_s2d"):
        ("ops/fused_preprocess.py", "plain_preprocess_s2d"),
    ("parallel/sharding_rules.py", "DATA_AXIS"):
        ("parallel/mesh.py", "DATA_AXIS"),
    ("parallel/sharding_rules.py", "MODEL_AXIS"):
        ("parallel/mesh.py", "MODEL_AXIS"),
    ("parallel/sharding_rules.py", "tp_spec_for"):
        ("parallel/sharding_rules.py", "tp_dim_for"),
    ("parallel/zero1.py", "make_zero1_train_step"):
        ("parallel/zero1.py", "create_state"),
    ("pipeline/preprocess.py", "RGB_MEAN"):
        ("compat/reference_spec.py", "RGB_MEAN"),
    ("pipeline/preprocess.py", "RGB_STD"):
        ("compat/reference_spec.py", "RGB_STD"),
    ("pipeline/preprocess.py", "resize_bilinear"):
        ("ops/resize.py", "resample_2d"),
    ("ops/quant.py", "QDense"): ("ops/quant.py", "QLinear"),
    ("ops/quant.py", "QMultiHeadAttention"): ("ops/quant.py", "QAttention"),
    ("serving.py", "META_FILE"): ("convert.py", "META_FILE"),
    ("serving.py", "PARAMS_FILE"): ("convert.py", "PARAMS_FILE"),
})
# (JAX module, name) -> why the port has no counterpart.
EXCEPTIONS = {
    ("ops/pallas_preprocess.py", "*"):
        "the Pallas kernels' module: csrc/ and ops/fused_preprocess.py "
        "hold the CUDA kernels (RENAMED lists its public names)",
    ("models/dpt.py", "FusedQKVSelfAttention"):
        "no config reaches it (the registry's DPTs use the unfused "
        "attention)",
    ("ops/quant.py", "dense_general_init"): "a flax DenseGeneral "
        "initializer (QLinear and QAttention are torch Linear layers)",
    ("parallel/mesh.py", "batch_sharding"): "a JAX global-array sharding; "
        "one process per device holds only its own rows",
    ("parallel/mesh.py", "replicated"): "a JAX global-array sharding, as "
        "batch_sharding",
    ("parallel/multihost.py", "global_batch_from_local"): "assembles a "
        "JAX global array from per-host rows; a rank keeps its rows",
}
# Module loggers are not API.
NOT_API = {"log"}


def _public(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")} - NOT_API


def _port_names(module):
    path = ROOT / "ann3depth_tpu_torch" / module
    return _public(path) if path.exists() else set()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = _port_names(module)
    whole_module = (module, "*") in EXCEPTIONS
    assert whole_module or (ROOT / "ann3depth_tpu_torch" / module).exists()
    for name in sorted(_public(ROOT / "ann3depth_tpu" / module)):
        if (module, name) in RENAMED:
            where, other = RENAMED[module, name]
            assert other in _port_names(where), (module, name, where)
        elif (module, name) in EXCEPTIONS:
            continue
        else:
            assert name in port, f"{module}: {name} has no counterpart"


def test_renamed_and_exceptions_are_current():
    """Every listed name exists in the JAX package, and none that the port
    now has under its own name is still listed."""
    for (module, name) in list(RENAMED) + list(EXCEPTIONS):
        if name != "*":
            assert name in _public(ROOT / "ann3depth_tpu" / module)
        if (module, name) in EXCEPTIONS and name != "*":
            assert name not in _port_names(module), (module, name)


def _subcommands(parser):
    action = next(a for a in parser._actions
                  if a.__class__.__name__ == "_SubParsersAction")
    return set(action.choices)


def test_parser_has_every_jax_subcommand():
    assert _subcommands(cli.build_parser()) == _subcommands(
        jcli.build_parser())


@pytest.mark.parametrize("name", ["EVAL_ACCUMULATION", "SPEC"])
def test_reference_spec_names_match(name):
    got, want = getattr(tref, name), getattr(jref, name)
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        assert got == want


def test_registry_register(monkeypatch):
    monkeypatch.setattr(registry, "_CLASSES", dict(registry._CLASSES))

    @registry.register("tiny")
    class Tiny(torch.nn.Module):
        S2D_INPUT_FACTOR = 0

        def __init__(self, compute_dtype, remat):
            super().__init__()
            self.compute_dtype, self.remat = compute_dtype, remat

        @staticmethod
        def output_hw(input_hw):
            return tuple(s // 2 for s in input_hw)

    assert "tiny" in registry.available()
    m = registry.build(ModelConfig(name="tiny", compute_dtype="float32",
                                   remat=True))
    assert isinstance(m, Tiny) and m.remat and m.compute_dtype is torch.float32
    assert registry.output_hw("tiny", (8, 6)) == (4, 3)
    assert registry.s2d_input_factor("tiny") == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tracing.trace(str(tmp_path), device="cpu"):
        torch.ones(8).sum()
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


def test_step_timer_matches_jax(monkeypatch):
    from ann3depth_tpu.utils import tracing as jtracing

    stats = []
    for mod in (jtracing, tracing):
        clock = iter([0.0, 0.010, 1.0, 1.030, 2.0, 2.020])
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        timer = mod.StepTimer(window=2)
        assert timer.stats() == {}
        for _ in range(3):
            timer.start()
            timer.stop()
        timer.stop()  # without a start: no sample
        stats.append(timer.stats())
    assert stats[1] == stats[0]
    assert np.isclose(stats[1]["step_ms_mean"], 25.0)


def test_maybe_tb_writer(tmp_path, monkeypatch):
    """None or "" -> no writer; a directory -> a TensorBoardWriter on it
    (stubbed here: importing tensorboard takes seconds)."""
    monkeypatch.setattr(tb_writer, "TensorBoardWriter",
                        lambda logdir: ("writer", logdir))
    assert tb_writer.maybe_tb_writer(None) is None
    assert tb_writer.maybe_tb_writer("") is None
    assert tb_writer.maybe_tb_writer(str(tmp_path)) == ("writer",
                                                       str(tmp_path))
