"""The port's eval path (train/loop.py `evaluate` with its report,
`restore_state_for_eval`, `evaluate_protocols`; train/checkpoint.py
`restore_avg_params`; cli.py `eval`) against the JAX package's, on the CPU.

Both sides score the same params on the same synthetic split: encdec at
width 0.25, f32 compute, 32x48 input, synthetic scenes 40x56 with a 15x11
depth grid. Checkpoints hold the same params in each package's format (the
JAX package's orbax, the port's torch files), made from flax inits of
several seeds.

Tolerances: metrics and per-image rows within 1e-4 relative (1e-5
absolute), as tests/test_torch_train_loop.py::test_evaluate_matches_jax
(f32 on both sides, summation order only). The worst-K grid ranks the same
images; its pixels are u8 renderings of f32 values, equal on at least 99%
of them (a last-ulp difference may move a colormap index or a denormalized
channel by one).
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

from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu.train.checkpoint import CheckpointManager as JCkpt
from ann3depth_tpu_torch import cli, convert
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.train import checkpoint as tckpt
from ann3depth_tpu_torch.train import loop as tloop

IN_HW = (32, 48)
RTOL, ATOL = 1e-4, 1e-5
SAVED_STEPS = (1, 2, 3)


def _cfg(get, ckpt_dir):
    cfg = get("make3d-encdec")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, datasets=("synthetic",),
                                 input_hw=IN_HW, synth_img_hw=(40, 56),
                                 synth_depth_hw=(15, 11), synth_n=4,
                                 synth_test_n=6),
        model=dataclasses.replace(cfg.model, width_mult=0.25,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=2, ema_decay=0.9,
                                  ckpt_dir=str(ckpt_dir)))


@functools.lru_cache(maxsize=None)
def _params(seed):
    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=seed)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The same three saves in both formats: params from seed s, EMA params
    from seed 10 + s, at step s."""
    root = tmp_path_factory.mktemp("ckpts")
    jcfg, tcfg = _cfg(jget_config, root / "jax"), _cfg(get_config,
                                                        root / "port")
    jstate = jloop.create_state(jcfg)
    jmgr = JCkpt(jcfg.train.ckpt_dir)
    tstate = tloop.create_state(tcfg, torch.device("cpu"))
    tmgr = tckpt.CheckpointManager(tcfg.train.ckpt_dir)
    try:
        for s in SAVED_STEPS:
            jmgr.save(s, jstate.replace(step=np.asarray(s),
                                        params=_params(s),
                                        ema_params=_params(10 + s)))
            tstate.model.load_state_dict(convert.to_state_dict(_params(s)))
            tstate.ema_params = convert.to_state_dict(_params(10 + s))
            tstate.step = s
            tmgr.save(s, tstate)
        jmgr.wait()
    finally:
        jmgr.close()
    return jcfg, tcfg


def _assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=RTOL, abs=ATOL), k


@pytest.mark.parametrize("avg_last,use_ema,ckpt_step", [
    (None, False, None), (None, True, None), (None, False, 1),
    (2, False, None), (3, True, None)])
def test_evaluate_from_checkpoints_matches_jax(ckpts, avg_last, use_ema,
                                               ckpt_step):
    jcfg, tcfg = ckpts
    kw = dict(max_batches=2, avg_last=avg_last, use_ema=use_ema,
              ckpt_step=ckpt_step)
    with jax.default_matmul_precision("highest"):
        want = jloop.evaluate(jcfg, **kw)
    got = tloop.evaluate(tcfg, device="cpu", **kw)
    _assert_metrics_close(got, want)


def test_restore_avg_params_is_the_uniform_mean(ckpts):
    _, tcfg = ckpts
    mgr = tckpt.CheckpointManager(tcfg.train.ckpt_dir)
    state = tloop.create_state(tcfg, torch.device("cpu"))
    state, steps = mgr.restore_avg_params(state, 2, use_ema=True)
    assert steps == [2, 3] and state.step == 3
    a, b = (convert.to_state_dict(_params(10 + s)) for s in (2, 3))
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, (a[k] + b[k]) * 0.5, rtol=0, atol=0)
    with pytest.raises(ValueError, match="only 3 checkpoints"):
        mgr.restore_avg_params(state, 4)
    with pytest.raises(ValueError, match="avg_last"):
        mgr.restore_avg_params(state, 0)
    with pytest.raises(ValueError, match="exclusive"):
        tloop.restore_state_for_eval(tcfg, avg_last=2, ckpt_step=1,
                                     device="cpu")


def test_evaluate_report_matches_jax(ckpts, tmp_path):
    """report_dir with tta: per-image rows, summary and the worst-3 grid."""
    jcfg, tcfg = ckpts
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    kw = dict(max_batches=2, report_worst=3, tta="flip")
    with jax.default_matmul_precision("highest"):
        want = jloop.evaluate(jcfg, report_dir=str(jdir), **kw)
    got = tloop.evaluate(tcfg, report_dir=str(tdir), device="cpu", **kw)
    _assert_metrics_close(got, want)
    # the report path's metrics are the stats path's
    _assert_metrics_close(tloop.evaluate(tcfg, device="cpu", max_batches=2,
                                         tta="flip"), got)
    rows = {d: [json.loads(ln) for ln in open(d / "per_image.jsonl")]
            for d in (jdir, tdir)}
    assert len(rows[tdir]) == len(rows[jdir]) == 4
    for g, w in zip(rows[tdir], rows[jdir]):
        assert g["index"] == w["index"]
        _assert_metrics_close(g, w)
    sj, st = (json.load(open(d / "summary.json")) for d in (jdir, tdir))
    assert st["images"] == sj["images"] == 4
    assert [w["index"] for w in st["worst"]] == \
        [w["index"] for w in sj["worst"]]
    _assert_metrics_close(st["metrics"], sj["metrics"])
    gi, wi = (np.asarray(Image.open(d / "worst.png")) for d in (tdir, jdir))
    assert gi.shape == wi.shape == (3 * 32, 3 * 48, 3)
    assert (gi == wi).all(axis=-1).mean() >= 0.99


def test_evaluate_report_worst_zero_writes_no_grid(ckpts, tmp_path):
    _, tcfg = ckpts
    tloop.evaluate(tcfg, device="cpu", max_batches=1,
                   report_dir=str(tmp_path / "r"), report_worst=0)
    assert (tmp_path / "r" / "per_image.jsonl").exists()
    assert not (tmp_path / "r" / "worst.png").exists()


def test_evaluate_protocols_matches_single_runs_and_jax(ckpts):
    jcfg, tcfg = ckpts
    tokens = ["plain", "tta", "align+crop", "tta+align+crop"]
    state = tloop.restore_state_for_eval(tcfg, device="cpu")
    got = tloop.evaluate_protocols(tcfg, tokens, state=state, max_batches=2)
    assert list(got) == tokens
    for token, parts in (("plain", {}), ("tta", dict(tta="flip")),
                         ("align+crop", dict(align="median", crop="eigen")),
                         ("tta+align+crop", dict(tta="flip", align="median",
                                                 crop="eigen"))):
        assert got[token] == tloop.evaluate(tcfg, state=state,
                                            max_batches=2, **parts)
    with jax.default_matmul_precision("highest"):
        want = jloop.evaluate_protocols(jcfg, tokens, max_batches=2)
    for token in tokens:
        _assert_metrics_close(got[token], want[token])
    with pytest.raises(ValueError, match="unknown protocol"):
        tloop.evaluate_protocols(tcfg, ["tta+zoom"], state=state)


CLI_SMALL = ["--config", "make3d-encdec", "--datasets", "synthetic",
             "--synth-n", "4", "--synth-test-n", "6", "--synth-hw", "40",
             "56", "--synth-depth-hw", "15", "11", "--width-mult", "0.25",
             "--batch-size", "2", "--device", "cpu"]


def test_cli_eval(ckpts, tmp_path, capsys):
    """`eval` of the port's checkpoints: the plain, report, EMA/avg-last
    and protocol forms print what `evaluate` returns."""
    _, tcfg = ckpts
    ck = ["--ckpt-dir", tcfg.train.ckpt_dir, "--max-batches", "2"]
    args = cli.build_parser().parse_args(["eval"] + CLI_SMALL + ck)
    cfg = cli.resolve_config(args)
    assert cfg.data.input_hw == (240, 320)  # the preset's; no flag sets it

    def run(*extra):
        assert cli.main(["eval"] + CLI_SMALL + ck + list(extra)) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert run() == pytest.approx(tloop.evaluate(cfg, device="cpu",
                                                 max_batches=2))
    rd = tmp_path / "report"
    assert run("--report-dir", str(rd), "--tta", "flip", "--ema",
               "--avg-last", "2") == pytest.approx(tloop.evaluate(
                   cfg, device="cpu", max_batches=2, tta="flip",
                   use_ema=True, avg_last=2))
    assert (rd / "worst.png").exists() and (rd / "summary.json").exists()
    prot = run("--protocols", "plain,tta+align+crop", "--ckpt-step", "2")
    assert sorted(prot) == ["plain", "tta+align+crop"]
    assert prot["tta+align+crop"] == pytest.approx(tloop.evaluate(
        cfg, device="cpu", max_batches=2, ckpt_step=2, tta="flip",
        align="median", crop="eigen"))


# --tp is a training option now ported: eval ignores it, as the JAX CLI's
# evaluate scores on its own data mesh (these cases keep their ids).
@pytest.mark.parametrize("flags,match", [
    (["--protocols", "plain", "--report-dir", "x"], "exclusive"),
    pytest.param(["--cache-device", "--tp", "2"], None,
                 id="flags1-not ported yet"),
    pytest.param(["--quant", "int8", "--tp", "2"], None,
                 id="flags2-not ported yet"),
    (["--preprocess-impl", "pallas"], "not ported yet"),
    pytest.param(["--tp", "2"], None, id="flags4-not ported yet"),
])
def test_cli_eval_refuses(ckpts, flags, match, capsys):
    """Eval refuses what the port lacks; with --tp it prints the metrics
    it prints without it."""
    _, tcfg = ckpts
    argv = ["eval"] + CLI_SMALL + ["--ckpt-dir", tcfg.train.ckpt_dir]
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            cli.main(argv + flags)
        return
    printed = []
    for extra in (flags, [f for f in flags if f not in ("--tp", "2")]):
        assert cli.main(argv + extra) == 0
        printed.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    assert printed[0] == printed[1]
    assert np.isfinite(printed[0]["rmse"])


def test_cli_eval_without_checkpoint_or_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no checkpoint"):
        cli.main(["eval"] + CLI_SMALL + ["--ckpt-dir", str(tmp_path / "e")])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval"] + CLI_SMALL[:-2]
                 + ["--ckpt-dir", str(tmp_path / "e")])
