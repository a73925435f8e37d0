"""The port's grid search (ann3depth_tpu_torch/sweep.py, `cli sweep`)
against the JAX package's `ann3depth_tpu/sweep.py`, on the CPU.

Parsing and overrides are held equal to the JAX functions on every config
field (the same types, values and error texts). The sweep itself runs at
a small size (smoke: the small net, f32, 48x64 input, b2, 6 steps) with
--device cpu; a trial's metrics equal, bit for bit, the port's own
`loop.train` + `loop.evaluate` with the same overrides (both on the CPU,
the same seeds and data).
"""

import dataclasses
import json
import os

import pytest

from ann3depth_tpu import sweep as jsweep
from ann3depth_tpu.config import Config as JConfig
from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch import sweep as tsweep
from ann3depth_tpu_torch.config import Config, get_config
from ann3depth_tpu_torch.train import loop as tloop

# Every dotted field of the JAX Config.
FIELDS = [f"{s.name}.{f.name}" for s in dataclasses.fields(JConfig)
          for f in dataclasses.fields(getattr(JConfig(), s.name))]
ROW_KEYS = {"trial", "overrides", "train_wall_s", "final_train_loss", "eval"}
GRID = "train.learning_rate=1e-3,1e-4"


def test_port_config_has_the_jax_fields():
    for section in dataclasses.fields(JConfig):
        want = [f.name for f in dataclasses.fields(
            getattr(JConfig(), section.name))]
        got = [f.name for f in dataclasses.fields(
            getattr(Config(), section.name))]
        assert got == want, section.name


@pytest.mark.parametrize("path", FIELDS)
def test_field_type_matches_jax(path):
    assert tsweep._field_type(path) == jsweep._field_type(path)


@pytest.mark.parametrize("spec", [
    "train.learning_rate=1e-4,3e-4", "train.steps=10,20",
    "data.augment=true,false", "data.augment=1,no,YES",
    "model.name=small,encdec", "train.resume_step=5",
    "model.width_mult=1,2", "data.preprocess_impl=xla,pallas",
    "data.input_hw=1", " train.loss = si , berhu ,"])
def test_parse_param_matches_jax(spec):
    if spec == "data.input_hw=1":  # a Tuple field: both raise alike
        with pytest.raises(TypeError) as j:
            jsweep.parse_param(spec)
        with pytest.raises(TypeError) as t:
            tsweep.parse_param(spec)
        assert str(t.value) == str(j.value)
        return
    path, values = tsweep.parse_param(spec)
    assert (path, values) == jsweep.parse_param(spec)
    assert [type(v) for v in values] == [
        type(v) for v in jsweep.parse_param(spec)[1]]


@pytest.mark.parametrize("spec,exc", [
    ("train.nope=1", KeyError), ("nosection.lr=1", KeyError),
    ("train.learning_rate", ValueError), ("train.learning_rate=", ValueError),
    ("train.learning_rate.x=1", KeyError), ("data.augment=maybe", ValueError),
    ("train.steps=1.5", ValueError)])
def test_parse_param_errors_match_jax(spec, exc):
    with pytest.raises(exc) as j:
        jsweep.parse_param(spec)
    with pytest.raises(exc) as t:
        tsweep.parse_param(spec)
    assert str(t.value) == str(j.value)


def test_apply_overrides_matches_jax():
    overrides = {"train.learning_rate": 3e-4, "model.width_mult": 2.0,
                 "data.augment": True, "train.resume_step": 4}
    got = tsweep.apply_overrides(get_config("smoke"), overrides)
    want = jsweep.apply_overrides(jget_config("smoke"), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.train.batch_size == get_config("smoke").train.batch_size
    with pytest.raises(KeyError, match="no config field 'train.nope'"):
        tsweep.apply_overrides(get_config("smoke"), {"train.nope": 1})


def _cfg(steps=6):
    cfg = get_config("smoke")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=(48, 64),
                                      synth_n=8, synth_test_n=4),
        train=dataclasses.replace(cfg.train, steps=steps, batch_size=2,
                                  checkpoint_every=steps, log_every=3))


def _sweep(out_dir, metric="rmse", grid=GRID, steps=6):
    return tsweep.run_sweep(_cfg(steps), [tsweep.parse_param(grid)],
                            str(out_dir), metric=metric, max_eval_batches=2,
                            progress=False, device="cpu")


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep") / "s"
    return out, _sweep(out)


def test_sweep_end_to_end(swept):
    out, result = swept
    assert len(result["rows"]) == 2
    with open(out / "sweep.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows == result["rows"]
    assert [r["trial"] for r in rows] == [0, 1]
    assert rows[0]["overrides"] == {"train.learning_rate": 1e-3}
    for r in rows:
        assert set(r) == ROW_KEYS  # the JAX ledger's keys
        assert r["eval"]["rmse"] > 0
        assert os.path.isdir(out / f"trial_{r['trial']:03d}" / "ckpt")
    best = result["best"]
    assert best["eval"]["rmse"] == min(r["eval"]["rmse"] for r in rows)
    with open(result["summary_path"]) as f:
        summary = json.load(f)
    assert summary["best"] == best and summary["maximize"] is False
    assert summary["grid"] == {"train.learning_rate": [1e-3, 1e-4]}


def test_sweep_trial_equals_train_and_evaluate(swept, tmp_path):
    """Trial 1 = loop.train + loop.evaluate of the same overrides, in a
    fresh directory, bit for bit on the CPU."""
    _, result = swept
    cfg = tsweep.apply_overrides(_cfg(), {"train.learning_rate": 1e-4})
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckpt_dir=str(tmp_path / "ckpt")))
    state, metrics = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                                 device="cpu")
    ev = tloop.evaluate(cfg, state=state, max_batches=2)
    row = result["rows"][1]
    assert row["eval"] == {k: float(v) for k, v in ev.items()}
    assert row["final_train_loss"] == float(metrics["loss"])


def test_sweep_resume_skips_and_delta1_maximizes(swept, monkeypatch):
    """A rerun of the same grid trains nothing (every row comes from the
    ledger); ranked by delta1 it picks the largest."""
    out, first = swept

    def boom(*a, **k):
        raise AssertionError("train re-ran for a recorded trial")

    monkeypatch.setattr(tloop, "train", boom)
    again = _sweep(out, metric="delta1")
    assert again["rows"] == first["rows"]
    assert again["best"]["eval"]["delta1"] == max(
        r["eval"]["delta1"] for r in again["rows"])
    with open(again["summary_path"]) as f:
        assert json.load(f)["maximize"] is True


def test_sweep_reruns_a_changed_or_unrecorded_trial_from_clean(tmp_path):
    """A trial whose ledger row is missing (a mid-trial kill), or whose
    index now maps to other overrides, reruns with its stale ckpt/ gone:
    a stale save at a later step would otherwise be the one eval sees."""
    out = tmp_path / "s"
    first = _sweep(out, grid="train.learning_rate=1e-3", steps=2)
    stale = out / "trial_000" / "ckpt" / "ckpt_500.pt"
    stale.write_bytes(b"stale")
    second = _sweep(out, grid="train.learning_rate=2e-3", steps=2)
    assert not stale.exists()
    assert second["rows"][0]["overrides"] == {"train.learning_rate": 2e-3}
    assert second["rows"][0] != first["rows"][0]
    with open(out / "sweep.jsonl") as f:
        assert len(f.readlines()) == 2  # append-only ledger


def test_sweep_unknown_metric(tmp_path):
    with pytest.raises(KeyError, match="--metric 'nope' not in eval"):
        _sweep(tmp_path / "s", metric="nope", grid="train.learning_rate=1e-3",
               steps=2)


def test_cli_sweep(tmp_path, capsys):
    out = tmp_path / "s"
    argv = ["sweep", "--config", "smoke", "--device", "cpu", "--steps", "2",
            "--synth-n", "4", "--synth-test-n", "2", "--param",
            "train.learning_rate=1e-3", "--param", "train.loss=si,berhu",
            "--out-dir", str(out), "--max-eval-batches", "1"]
    assert cli.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_trials"] == 2
    assert line["summary"] == str(out / "summary.json")
    assert line["best"]["overrides"]["train.loss"] in ("si", "berhu")
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--config", "smoke", "--out-dir", str(out)])
