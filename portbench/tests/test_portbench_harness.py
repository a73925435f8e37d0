"""The harness on the CPU: what a run prints, what it refuses, what makes a
new cell, and faults planted under the timed path that `correct` has to
catch."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT, small_config

# Limits of the CPU stand-ins (encdec at width 0.25, bf16 on the CPU),
# above their own sound readings (loss_gap 4e-4-7e-4, grad_gap 0.007-0.03,
# change_gap 0.0015-0.004) and below what the faults read (half a batch:
# loss_gap 0.06-0.4, change_gap 0.08-0.11; a state left unchanged: 1).
TRAIN_LIMITS = {"limits": {"loss_gap": 0.01, "grad_gap": 0.1,
                           "change_gap": 0.03, "last_loss_finite": 0.0}}
CELLS = ("encdec.train.pool",)


def _run(run, capsys, workload, trace=0, seed=2 ** 31 + 5):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "1", "--trace", str(trace)])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.fixture
def cpu_limits(cpu_cells, monkeypatch):
    monkeypatch.setattr(spec, "limits", lambda name: TRAIN_LIMITS)
    return cpu_cells


def test_no_card_no_result():
    """The measurement path fails without a card; it never falls back to
    the CPU, and prints no result."""
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "encdec.train.pool", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(cpu_limits, capsys, trace, workload):
    rc, line = _run(cpu_limits, capsys, workload, trace)
    assert rc == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "feed_wait_ms.train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "train_images_per_s"}


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


# Two runs of one cell, trace 0 then 1, in a checkout whose portbench/ is
# the one in the working directory, with the CPU for the card.
RUN_TWICE_ON_THE_CPU = """
import os, sys, torch
import portbench
from portbench import run
assert portbench.__file__.startswith(os.getcwd()), portbench.__file__
run.require_devices = lambda chips: torch.device("cpu")
torch.set_num_threads(2)
for trace in ("0", "1"):
    rc = run.main(["--workload", sys.argv[1], "--seed", "2147483653",
                   "--seconds", "1", "--trace", trace])
    if rc:
        sys.exit(rc)
"""


def test_a_new_configuration_and_cell_from_new_files_alone(tmp_path):
    """A configuration file, its own reference model, a traffic file, a
    metric reader, a limits file and new entries in BENCHMARK.json's
    `configs`, `workloads` and `per_layer` make a new cell that reports the
    train metrics; no file that was there changes and no entry that was
    there is edited."""
    pkg = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    cfg = small_config("make3d-encdec")
    cfg.update(name="tiny-encdec", reference="tiny_encdec")
    (pkg / "configs" / "tiny-encdec.json").write_text(json.dumps(cfg))
    (pkg / "reference" / "tiny_encdec.py").write_text(
        (pkg / "reference" / "encdec.py").read_text())
    traffic = json.loads((pkg / "traffic" / "train_records.json").read_text())
    traffic.update(scenes=10, image_hw=[48, 64], depth_hw=[16, 10],
                   warm_steps=1, trace_steps=2)
    (pkg / "traffic" / "train_tiny.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    (pkg / "limits" / "tiny.train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0,
                    "last_loss_finite": 0.0}}))
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = json.loads(json.dumps(old))
    bench["configs"].append({"name": "tiny-encdec", "source": "x",
                             "file": "portbench/configs/tiny-encdec.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny.train", "config": "tiny-encdec",
                               "traffic": "train_tiny", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "train_images_per_s",
                               "workloads": ["tiny.train"]})
    for key, entries in old.items():
        if isinstance(entries, list):
            assert bench[key][:len(entries)] == entries, key
        else:
            assert bench[key] == entries, key
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = subprocess.run(
        [sys.executable, "-c", RUN_TWICE_ON_THE_CPU, "tiny.train"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith('{"correct"')]
    assert len(lines) == 2, proc.stdout[-4000:]
    e2e, layer = lines
    assert e2e["correct"] is True and layer["correct"] is True
    assert set(e2e["metrics"]) == {"setup_s", "train_images_per_s"}
    assert set(layer["metrics"]) >= {"mfu.train", "feed_wait_ms.train",
                                     "device_idle.train", "steps_done"}
    assert layer["metrics"]["steps_done"]["value"] > 0
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def _broken_update(monkeypatch):
    """A step that leaves its state unchanged."""
    from ann3depth_tpu_torch.train import step as steplib

    def apply(self, optimizer, count, lr=None, norm=None):
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        return steplib.global_norm(grads)

    monkeypatch.setattr(steplib.UpdateRule, "apply", apply)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from ann3depth_tpu_torch.train import step as steplib

    real = steplib.train_step

    def train_step(state, img_u8, depth_raw, *a, **kw):
        half = img_u8.shape[0] // 2
        return real(state, img_u8[:half], depth_raw[:half], *a, **kw)

    monkeypatch.setattr(steplib, "train_step", train_step)


@pytest.mark.parametrize("fault", [None, _broken_update, _half_batch])
@pytest.mark.parametrize("workload", CELLS)
def test_faults_under_the_timed_path(cpu_limits, capsys, monkeypatch,
                                     workload, fault):
    if fault is not None:
        fault(monkeypatch)
    rc, line = _run(cpu_limits, capsys, workload)
    assert rc == 0
    assert line["correct"] is (fault is None), line["checks"]
