"""The port's training loop, checkpoints, CLI and host-side copies
(ann3depth_tpu_torch/train/{loop,checkpoint}.py, cli.py `train`, data/*.py,
utils/metrics_writer.py), on the CPU.

- The copied host modules are the originals up to their import paths and a
  note in the docstring, and give the same scenes, batch orders, Make3D
  pairs and metric records.
- Both loops, from the same initial params, log the same 5-step loss curve
  on the copied synthetic data (augment off, the preset's warmup on). The
  JAX loop hands the model a bf16 input (emit_s2d) from a DEFAULT-precision
  resize, the port an f32 one: with bf16 compute on both sides the losses
  agree to 2e-2 relative (tests/test_torch_train.py states the bf16 step
  tolerance).
- The loop's own behaviour mirrors tests/test_train_integration.py: the
  loss decreases (:25), a resume continues the step counter (:35), a resume
  of a finished run is a no-op, and `cli train` runs (:323).
"""

import dataclasses
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli, convert
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.train import checkpoint as tckpt
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["data/batching.py", "data/synthetic.py", "data/make3d.py",
          "data/records.py", "data/nyu.py", "utils/metrics_writer.py",
          "data/download.py"]


# ---------------------------------------------------------------------------
# The copied host modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", COPIES)
def test_copy_is_the_original_up_to_imports(path):
    orig = (ROOT / "ann3depth_tpu" / path).read_text()
    copy = (ROOT / "ann3depth_tpu_torch" / path).read_text()
    note = re.compile(r"\n\nA copy of `ann3depth_tpu/[^`]+`, so that the "
                      r"port imports nothing of\nthe JAX package; [^\n]+\n")
    assert len(note.findall(copy)) == 1, "the copy names its original"
    # The copies' messages point the user at the port's own CLI.
    copy = note.sub("\n", copy).replace("ann3depth_tpu_torch.",
                                        "ann3depth_tpu.").replace(
        "python -m ann3depth_tpu_torch ", "python -m ann3depth_tpu ")
    assert copy == orig


def test_synthetic_scenes_are_bit_identical():
    from ann3depth_tpu.data.synthetic import SyntheticDepthDataset as J
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset as T

    for kw in (dict(n=5, img_hw=(40, 56), depth_hw=(15, 11), seed=0),
               dict(n=3, img_hw=(480, 640), depth_hw=(305, 55), seed=1)):
        j, t = J(**kw), T(**kw)
        assert len(j) == len(t)
        for i in range(len(j)):
            for a, b in zip(j[i], t[i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        T(n=2)[2]


def test_batch_orders_match():
    from ann3depth_tpu.data import batching as jb
    from ann3depth_tpu.data.synthetic import SyntheticDepthDataset as J
    from ann3depth_tpu_torch.data import batching as tb
    from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset as T

    kw = dict(n=7, img_hw=(8, 8), depth_hw=(4, 4))
    j, t = J(**kw), T(**kw)

    def same(a, b):
        a, b = list(a), list(b)
        assert len(a) == len(b) > 0
        for (ia, da), (ib, db) in zip(a, b):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(da, db)

    for opts in (dict(steps=9, seed=3), dict(steps=None, seed=0),
                 dict(steps=4, shuffle=False),
                 dict(steps=None, drop_remainder=False, seed=2)):
        same(j.batches(2, **opts), t.batches(2, **opts))
    same(jb.interleave_batches([j, J(n=5, img_hw=(8, 8), depth_hw=(4, 4),
                                      seed=1)], 2, steps=7, seed=4),
         tb.interleave_batches([t, T(n=5, img_hw=(8, 8), depth_hw=(4, 4),
                                     seed=1)], 2, steps=7, seed=4))
    assert list(tb.round_robin([iter([1, 2, 3]), iter([10])], steps=None)) \
        == list(jb.round_robin([iter([1, 2, 3]), iter([10])], steps=None))
    same(jb.ProcessShardView(j, 1, 3).batches(2, steps=3),
         tb.ProcessShardView(t, 1, 3).batches(2, steps=3))
    with pytest.raises(ValueError, match="batch_size"):
        next(t.batches(8, steps=1))


@pytest.fixture()
def make3d_tree(tmp_path):
    """A miniature Make3D tree, as tests/test_data_loaders.py:12 builds it
    (3 train, 2 test pairs and one unpaired image)."""
    import scipy.io
    from PIL import Image

    rng = np.random.default_rng(0)
    base = tmp_path / "make3d"
    for split, n, imgdir, depdir in [
        ("train", 3, "Train400Img", "Train400Depth"),
        ("test", 2, "Test134", "Gridlaserdata"),
    ]:
        (base / imgdir).mkdir(parents=True)
        (base / depdir).mkdir(parents=True)
        for i in range(n):
            sid = f"{split}scene-{i:03d}"
            img = rng.integers(0, 256, (96, 72, 3), dtype=np.uint8)
            Image.fromarray(img).save(base / imgdir / f"img-{sid}.jpg")
            grid = np.zeros((55, 305, 4), np.float32)
            grid[..., 3] = rng.uniform(1, 70, (55, 305))
            scipy.io.savemat(base / depdir / f"depth_sph_corr-{sid}.mat",
                             {"Position3DGrid": grid})
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        base / "Train400Img" / "img-orphan.jpg")
    return tmp_path


def test_make3d_loader_matches_original(make3d_tree):
    from ann3depth_tpu.data.make3d import Make3DDataset as J
    from ann3depth_tpu_torch.data.make3d import Make3DDataset as T

    for split, n in (("train", 3), ("test", 2)):
        j = J(str(make3d_tree), split=split, raw_hw=(48, 64))
        t = T(str(make3d_tree), split=split, raw_hw=(48, 64))
        assert len(t) == len(j) == n
        for i in range(n):
            for a, b in zip(j[i], t[i]):
                np.testing.assert_array_equal(a, b)
        img, depth = t[0]
        assert img.shape == (48, 64, 3) and depth.shape == (305, 55)
        for (ja, jd), (ta, td) in zip(j.batches(2, steps=3, seed=1),
                                      t.batches(2, steps=3, seed=1)):
            np.testing.assert_array_equal(ja, ta)
            np.testing.assert_array_equal(jd, td)
    with pytest.raises(FileNotFoundError, match="download"):
        T(str(make3d_tree / "nowhere"), split="train")


def test_metrics_writer_records_match(tmp_path, monkeypatch):
    from ann3depth_tpu.utils.metrics_writer import MetricsWriter as J
    from ann3depth_tpu_torch.utils.metrics_writer import MetricsWriter as T

    monkeypatch.setattr("time.time", lambda: 123.0)
    for cls, d in ((J, tmp_path / "j"), (T, tmp_path / "t")):
        with cls(str(d)) as w:
            w.write(3, {"loss": np.float32(0.5), "rmse": torch.tensor(2.0),
                        "name": "x", "obj": object}, images_per_sec=4.0)
    j = [json.loads(ln) for ln in open(tmp_path / "j" / "metrics.jsonl")]
    t = [json.loads(ln) for ln in open(tmp_path / "t" / "metrics.jsonl")]
    assert j[0].pop("obj").startswith("<class") and t[0].pop("obj")
    assert j == t


# ---------------------------------------------------------------------------
# Configs and the loop.
# ---------------------------------------------------------------------------

SMALL = dict(data=dict(datasets=("synthetic",), input_hw=(32, 48),
                       synth_img_hw=(40, 56), synth_depth_hw=(15, 11),
                       synth_n=8, synth_test_n=4),
             model=dict(name="encdec", width_mult=0.25),
             train=dict(batch_size=2, steps=5, log_every=1,
                        checkpoint_every=0, eval_every=0))


def _cfg(get, tmp_path, **sections):
    cfg = get("make3d-encdec")
    for name, base in SMALL.items():
        values = {**base, **sections.get(name, {})}
        if name == "train":
            values.setdefault("ckpt_dir", str(tmp_path / "ckpt"))
        cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
            getattr(cfg, name), **values)})
    return cfg


def _logged(workdir, key="loss"):
    return [r[key] for r in map(json.loads, open(Path(workdir) /
                                                 "metrics.jsonl"))
            if key in r]


def _steps(workdir):
    return [r["step"] for r in map(json.loads, open(Path(workdir) /
                                                    "metrics.jsonl"))
            if "loss" in r]


def test_loss_curve_matches_jax_loop(tmp_path, monkeypatch):
    """Same initial params, same synthetic batches, the preset's warmup (100
    steps, so lr k/100 * 1e-2 at step k): the logged losses agree."""
    over = dict(train=dict(learning_rate=1e-2))
    jcfg = _cfg(jget_config, tmp_path / "jax", **over)
    tcfg = _cfg(get_config, tmp_path / "port", **over)
    assert jcfg.train.warmup_steps == tcfg.train.warmup_steps == 100
    params = jstep.init_params(jreg.build(jcfg.model), jcfg.data.input_hw,
                               seed=jcfg.train.seed)
    sd = convert.to_state_dict(jax.tree.map(np.asarray, params))
    create = tloop.create_state

    def create_from_jax_params(cfg, device=None):
        state = create(cfg, device)
        state.model.load_state_dict(sd)
        return state

    monkeypatch.setattr(tloop, "create_state", create_from_jax_params)
    jloop.train(jcfg, workdir=str(tmp_path / "jax"), progress=False)
    state, last = tloop.train(tcfg, workdir=str(tmp_path / "port"),
                              progress=False, device="cpu")
    want, got = _logged(tmp_path / "jax"), _logged(tmp_path / "port")
    assert len(want) == len(got) == 5
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert _steps(tmp_path / "port") == [1, 2, 3, 4, 5]
    assert state.step == 5 and last["loss"] == got[-1]


def test_train_loss_decreases(tmp_path):
    """Mirrors tests/test_train_integration.py:25."""
    cfg = _cfg(get_config, tmp_path, train=dict(
        steps=60, batch_size=4, learning_rate=3e-3, log_every=10,
        warmup_steps=0))
    tloop.train(cfg, workdir=str(tmp_path), progress=False, device="cpu")
    losses = _logged(tmp_path)
    assert losses[-1] < losses[0] * 0.7, losses
    assert np.isfinite(losses[-1])


def test_resume_continues_step_counter(tmp_path):
    """Mirrors tests/test_train_integration.py:35, with the in-loop eval
    and the checkpoint rotation on."""
    cfg = _cfg(get_config, tmp_path, train=dict(
        steps=6, checkpoint_every=2, log_every=2, eval_every=3,
        warmup_steps=0))
    state, _ = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                           device="cpu")
    assert state.step == 6
    mgr = tckpt.CheckpointManager(cfg.train.ckpt_dir)
    assert mgr.all_steps() == [2, 4, 6]
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=10, resume=True))
    state2, _ = tloop.train(cfg2, workdir=str(tmp_path), progress=False,
                            device="cpu")
    assert state2.step == 10
    assert _steps(tmp_path) == [2, 4, 6, 8, 10]
    assert mgr.all_steps() == [6, 8, 10]  # max_to_keep=3
    evals = _logged(tmp_path, "eval_rmse")
    assert len(evals) == 3 and all(np.isfinite(evals))  # at 3, 6, 9
    # a resume of a finished run runs no step
    state3, _ = tloop.train(cfg2, workdir=str(tmp_path), progress=False,
                            device="cpu")
    assert state3.step == 10


def test_checkpoint_restore_then_step_is_bitwise_equal(tmp_path):
    cfg = _cfg(get_config, tmp_path, train=dict(steps=3, ema_decay=0.9,
                                                warmup_steps=1))
    state, _ = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                           device="cpu")
    fresh = tloop.create_state(cfg, torch.device("cpu"))
    fresh, step = tckpt.CheckpointManager(cfg.train.ckpt_dir).restore(fresh)
    assert step == 3 and fresh.step == 3
    img, dep = next(tloop.build_dataset(cfg).batches(2, steps=1, seed=9))
    kw = dict(input_hw=cfg.data.input_hw, target_hw=(16, 24), ema_decay=0.9)
    for s in (state, fresh):
        tstep.train_step(s, torch.from_numpy(img), torch.from_numpy(dep),
                         **kw)
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in state.ema_params:
        assert torch.equal(state.ema_params[k], fresh.ema_params[k]), k


def test_checkpoint_manager(tmp_path):
    cfg = _cfg(get_config, tmp_path)
    state = tloop.create_state(cfg, torch.device("cpu"))
    mgr = tckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(state) == (state, None)
    for s in (1, 2, 3):
        state.step = s
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not list((tmp_path / "c").glob("*.tmp"))
    with pytest.raises(ValueError, match="no checkpoint at step 1"):
        mgr.restore(state, step=1)
    with pytest.raises(ValueError, match="no ema_params"):
        mgr.restore_params(state, use_ema=True)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    _, step = mgr.restore_params(state, step=2)
    assert step == 2 and state.step == 2
    mgr.delete(2)
    assert mgr.all_steps() == [3]


def test_evaluate_matches_jax(tmp_path):
    """evaluate() of the same params on the same test split, in f32."""
    over = dict(model=dict(compute_dtype="float32"))
    jcfg = _cfg(jget_config, tmp_path, **over)
    tcfg = _cfg(get_config, tmp_path, **over)
    jstate = jloop.create_state(jcfg)
    tstate = tloop.create_state(tcfg, torch.device("cpu"))
    tstate.model.load_state_dict(convert.to_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    with jax.default_matmul_precision("highest"):
        want = jloop.evaluate(jcfg, state=jstate, max_batches=2)
    got = tloop.evaluate(tcfg, state=tstate, max_batches=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5), k


def test_evaluate_from_checkpoint_and_empty_dir(tmp_path):
    cfg = _cfg(get_config, tmp_path, train=dict(steps=2))
    with pytest.raises(RuntimeError, match="no checkpoint"):
        tloop.evaluate(cfg, device="cpu")
    state, _ = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                           device="cpu")
    got = tloop.evaluate(cfg, device="cpu", max_batches=1)
    want = tloop.evaluate(cfg, state=state, max_batches=1)
    assert got == want


# The input pipeline's options (cache_device, use_grain,
# steps_per_dispatch), int8-qat training and the parallel modes are ported
# now: they train, or meet the JAX loop's validation
# (tests/test_torch_dispatch.py, tests/test_torch_quant.py and
# tests/test_torch_parallel.py hold them to it). ZeRO-1 trains on one
# process; tensor parallelism needs a dpt-family model.
NOW_PORTED = {"cache_device": None, "use_grain": None,
              "steps_per_dispatch": "needs --cache-device", "quant": None,
              "zero1": None, "tensor_parallel": "requires a dpt-family"}


@pytest.mark.parametrize("section,field,value", [
    ("train", "zero1", True), ("train", "tensor_parallel", 2),
    ("data", "cache_device", True), ("data", "use_grain", True),
    ("train", "steps_per_dispatch", 2), ("model", "quant", "int8-qat"),
])
def test_options_outside_the_slice_raise(tmp_path, section, field, value):
    cfg = _cfg(get_config, tmp_path, **{section: {field: value}})
    if field not in NOW_PORTED:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            tloop.train(cfg, workdir=str(tmp_path), device="cpu")
    elif NOW_PORTED[field]:
        # K > 1 folds steps over a device-resident pool
        with pytest.raises(ValueError, match=NOW_PORTED[field]):
            tloop.train(cfg, workdir=str(tmp_path), device="cpu")
    else:
        state, metrics = tloop.train(cfg, workdir=str(tmp_path),
                                     progress=False, device="cpu")
        assert state.step == 5 and np.isfinite(metrics["loss"])


def test_train_on_the_card_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = _cfg(get_config, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(cfg, workdir=str(tmp_path))


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

CLI_SMALL = ["train", "--config", "make3d-encdec", "--datasets", "synthetic",
             "--synth-n", "4", "--synth-test-n", "2", "--synth-hw", "40",
             "56", "--synth-depth-hw", "15", "11", "--width-mult", "0.25",
             "--batch-size", "2"]


def test_cli_train_smoke(tmp_path, capsys):
    """Mirrors tests/test_train_integration.py:323, on the CPU."""
    rc = cli.main(CLI_SMALL + ["--steps", "3", "--ckpt-dir",
                               str(tmp_path / "c"), "--workdir",
                               str(tmp_path), "--device", "cpu"])
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "loss" in metrics and np.isfinite(metrics["loss"])
    assert tckpt.CheckpointManager(str(tmp_path / "c")).latest_step() == 3


def test_cli_resolves_the_jax_flags():
    args = cli.build_parser().parse_args(CLI_SMALL + [
        "--no-augment", "--loss", "si+grad", "--warmup-steps", "0",
        "--clip-norm", "0", "--optimizer", "sgd", "--resume", "--ema-decay",
        "0.99", "--eval-every", "7"])
    cfg = cli.resolve_config(args)
    assert cfg.data.synth_img_hw == (40, 56) and cfg.data.augment is False
    assert cfg.data.datasets == ("synthetic",)
    assert cfg.model.width_mult == 0.25
    assert (cfg.train.loss, cfg.train.warmup_steps, cfg.train.clip_norm,
            cfg.train.optimizer, cfg.train.resume, cfg.train.ema_decay,
            cfg.train.eval_every) == ("si+grad", 0, 0.0, "sgd", True, 0.99,
                                      7)
    assert args.device == "cuda"  # the card unless asked otherwise


# What each flag does now: --zero1 trains (one process: one chunk);
# --preprocess-impl is accepted and trains as the run without it does
# (both values run the same preprocess), bit for bit; the others stop with
# the JAX CLI's refusal or the port's own.
CLI_FLAG_OUTCOMES = {
    "--zero1": None,
    "--multihost": (ValueError, "no process group to join"),
    "--tp": (ValueError, "requires a dpt-family model"),
    "--preprocess-impl": "same",
    "--coordinator": (ValueError, "--coordinator needs --num-processes"),
    "--distill-model": (SystemExit, "distill-from"),
}


@pytest.mark.parametrize("flags", [["--zero1"], ["--multihost"],
                                   ["--tp", "2"],
                                   ["--preprocess-impl", "pallas"],
                                   ["--coordinator", "localhost:1234"],
                                   ["--distill-model", "encdec"]])
def test_cli_flags_outside_the_slice_exit(tmp_path, flags, capsys):
    argv = CLI_SMALL + ["--steps", "1", "--ckpt-dir", str(tmp_path / "c"),
                        "--device", "cpu"] + flags
    outcome = CLI_FLAG_OUTCOMES[flags[0]]
    if outcome == "same":
        printed = []
        for name, extra in (("a", flags), ("b", [])):
            assert cli.main(CLI_SMALL + ["--steps", "1", "--ckpt-dir",
                                         str(tmp_path / name), "--device",
                                         "cpu"] + extra) == 0
            printed.append(json.loads(
                capsys.readouterr().out.strip().splitlines()[-1]))
        assert printed[0] == printed[1]
        assert np.isfinite(printed[0]["loss"])
        assert cli.resolve_config(cli.build_parser().parse_args(
            argv)).data.preprocess_impl == "pallas"
        return
    if outcome is None:
        assert cli.main(argv) == 0
        metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(metrics["loss"])
        return
    with pytest.raises(outcome[0], match=outcome[1]):
        cli.main(argv)


def test_cli_train_on_the_card_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(CLI_SMALL + ["--steps", "1", "--ckpt-dir",
                              str(tmp_path / "c")])
