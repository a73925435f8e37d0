"""The port's `bench` (cli.py, bench/train.py, bench/infer.py, and the MFU
and memory half of utils/flops.py) against the JAX CLI's `bench`
(ann3depth_tpu/cli.py, benchmarks/bench_train.py, bench_infer.py,
benchmarks/flops.py), on the CPU at small sizes: the smoke preset at
32x48 from raw 48x64 frames.

- Both CLIs refuse the same arguments with the same words; without a card
  and without --device cpu the port raises, never falling back.
- Each port result carries every key of the JAX bench's `result` dict,
  read from the JAX source with `ast`, so the test follows that source.
- `attach_mfu` and `attach_memory` equal the JAX functions on the same
  inputs (the peaks monkeypatched, as tests/test_flops.py does), at the
  bf16 and the int8 denominator.
- The train bench repeats its loss, through BlockRunner's blocks; the
  serving bench's output on pool entry 0 equals `make_serving_fn`'s bit
  for bit.
- The CLI hands `batch_size or 32` to the serving bench and prints one
  JSON line; docs/cli_torch.md is what tools/gen_cli_docs_torch.py writes.
"""

import ast
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from ann3depth_tpu import cli as jcli
from ann3depth_tpu_torch import cli, serving
from ann3depth_tpu_torch.bench import infer, train
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.utils import flops
from benchmarks import flops as jflops

ROOT = Path(__file__).resolve().parent.parent
RAW_HW = (48, 64)
PEAKS = {"bf16": 989e12, "int8": 1979e12}
MFU_KEYS = {"model_tflops_per_step", "achieved_tflops"}


def _cfg(preset="smoke", **model):
    cfg = get_config(preset)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=(32, 48)),
        model=dataclasses.replace(cfg.model, **model))


def _jax_result_keys(module):
    """The keys of the dict literal that benchmarks/<module>.py assigns to
    `result`."""
    tree = ast.parse((ROOT / "benchmarks" / f"{module}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets]
                == ["result"]):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no result dict in benchmarks/{module}.py")


@pytest.fixture(scope="module")
def train_runs():
    """Two train benches at steps=2 (K=20 a block), and the blocks each ran
    through BlockRunner."""
    blocks = []
    real = train.BlockRunner.run
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train.BlockRunner, "run", lambda self, block, more=True: (
            blocks.append(tuple(block.shape)) or real(self, block, more)))
        for _ in range(2):
            runs.append(train.run(_cfg(), steps=2, warmup=2, raw_hw=RAW_HW,
                                  device="cpu"))
    return runs, blocks


@pytest.fixture(scope="module")
def infer_run():
    """A serving bench (b2, 30 batches) and the replays it timed."""
    made = []
    real = infer.serving_graphs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(infer, "serving_graphs",
                   lambda fn, pool: made.append(real(fn, pool)) or made[-1])
        result = infer.run(_cfg(), batch=2, steps=30, raw_hw=RAW_HW,
                           device="cpu")
    return result, made[0]


@pytest.mark.parametrize("argv", [
    ["--ckpt-step", "3"], ["--quant", "int8"]], ids=["ckpt-step", "int8"])
def test_bench_refusals_match_jax(argv):
    argv = ["bench", "--config", "make3d-encdec", *argv]
    with pytest.raises(SystemExit) as j:
        jcli.main(argv)
    with pytest.raises(SystemExit) as t:
        cli.main(argv + ["--device", "cpu"])
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("serving_flag", [[], ["--serving"]],
                         ids=["train", "serving"])
def test_bench_without_a_card_raises(monkeypatch, serving_flag):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--config", "smoke", *serving_flag])


def test_train_result_has_every_jax_key(train_runs):
    result = train_runs[0][0]
    assert _jax_result_keys("bench_train") <= set(result)
    assert MFU_KEYS <= set(result)
    assert result["backend"] == "cpu" and "peak_hbm_gb" not in result


def test_train_bench_repeats_through_graph_blocks(train_runs):
    (a, b), blocks = train_runs
    assert math.isfinite(a["final_loss"])
    assert a["final_loss"] == b["final_loss"]
    # Per run: two warm blocks and steps // K = 1 timed block of K=20.
    assert blocks == [(20, 2)] * 6
    assert a["step_ms"] > 0 and a["images_per_sec"] > 0


def test_infer_result_has_every_jax_key(infer_run):
    result, replays = infer_run
    assert _jax_result_keys("bench_infer") <= set(result)
    assert MFU_KEYS <= set(result)
    assert len(replays) == infer.POOL_ENTRIES
    assert result["batch_size"] == 2 and result["backend"] == "cpu"


def test_infer_output_equals_serving_fn(infer_run):
    _, replays = infer_run
    cfg = _cfg()
    model = serving.prepare_model(steplib.init_params(
        registry.build(cfg.model), cfg.data.input_hw, seed=0), "cpu")
    want = serving.make_serving_fn(model, cfg.data.input_hw)(replays[0].x)
    assert replays[0].x.shape == (2, *RAW_HW, 3)
    assert torch.equal(replays[0].out, want)


def test_int8_serving_bench_takes_the_int8_peak(monkeypatch):
    """The serving bench of an int8 encdec divides by the int8 peak, and
    its int8 products count as the float model's convolutions do."""
    monkeypatch.setattr(flops, "device_peak_flops",
                        lambda device=None, dtype="bf16": PEAKS[dtype])
    result = infer.run(_cfg("make3d-encdec", quant="int8"), batch=2,
                       steps=30, raw_hw=RAW_HW, device="cpu")
    assert result["mfu_peak_dtype"] == "int8" and "mfu" in result
    x = torch.zeros((2, 32, 48, 3))
    fl = {q: flops.forward_flops(steplib.init_params(registry.build(
        _cfg("make3d-encdec", quant=q).model), (32, 48)), x)
        for q in ("none", "int8")}
    assert fl["int8"] == fl["none"] > 0


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("peak", [True, False], ids=["peak", "no-peak"])
def test_attach_mfu_matches_jax(monkeypatch, dtype, peak):
    for mod in (flops, jflops):
        monkeypatch.setattr(
            mod, "device_peak_flops",
            lambda device=None, dtype="bf16": PEAKS[dtype] if peak else None)
    for args in ((1.37e12, 40, 0.37), (2.6e9, 30, 0.011), (None, 10, 1.0),
                 (1e12, 10, 0.0)):
        assert (flops.attach_mfu({"k": 1}, *args, dtype=dtype)
                == jflops.attach_mfu({"k": 1}, *args, dtype=dtype))


def test_attach_memory_matches_jax(monkeypatch):
    peak = 3_456_789_012

    class FakeDev:
        def memory_stats(self):
            return {"peak_bytes_in_use": peak}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: peak)
    want = jflops.attach_memory({}, FakeDev())
    assert want == {"peak_hbm_gb": 3.219}
    assert flops.attach_memory({}, "cuda") == want
    assert flops.attach_memory({}, "cpu") == {}


def test_int8_peak_table(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, bf16, int8 in (("NVIDIA H100 80GB HBM3", 989e12, 1979e12),
                             ("NVIDIA A100-SXM4-80GB", None, None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert flops.device_peak_flops("cuda") == bf16
        assert flops.device_peak_flops("cuda", dtype="bf16") == bf16
        assert flops.device_peak_flops("cuda", dtype="int8") == int8
        assert flops.device_peak_flops("cpu", dtype="int8") is None


@pytest.mark.parametrize("argv,want", [
    ([], ("train", None)),
    (["--serving"], ("infer", 32)),
    (["--serving", "--batch-size", "8"], ("infer", 8))],
    ids=["train", "serving", "serving-b8"])
def test_cli_bench_dispatches_and_prints_one_line(monkeypatch, capsys, argv,
                                                  want):
    calls = []

    def fake(kind):
        def run(cfg, batch=None, device=None):
            calls.append((kind, batch, device, cfg.model.name))
            return {"bench": kind}
        return run

    monkeypatch.setattr(train, "run", fake("train"))
    monkeypatch.setattr(infer, "run", fake("infer"))
    assert cli.main(["bench", "--config", "smoke", "--device", "cpu",
                     *argv]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == {"bench": want[0]}
    assert calls == [(*want, "cpu", "small")]


def test_cli_torch_docs_fresh():
    spec = importlib.util.spec_from_file_location(
        "gen_cli_docs_torch", ROOT / "tools" / "gen_cli_docs_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    have = (ROOT / "docs" / "cli_torch.md").read_text()
    assert have == mod.generate(), ("docs/cli_torch.md is stale: run "
                                    "`python tools/gen_cli_docs_torch.py`")
