"""The train step and the report eval as CUDA graphs (the port's
counterparts of the JAX package's jitted `train_step`,
`distill_train_step` and `eval_report_step`), on the CPU.

A CUDA graph exists only on the card. Here the train loop's
`dispatch.BlockRunner` runs through `tape_capture`, a capture hook with a
graph's semantics for a step that changes state: the capture records the
tensor ops the step issues and leaves every tensor as it was (a CUDA
capture runs no kernel), a host read of a device value raises (a CUDA
capture refuses it), and a replay reruns the recorded ops on the tensors
they touched, no Python. So a step that rebinds its state instead of
writing it in place replays on the stale tensors here as on the card.
(`tests/test_torch_graphs.static_capture`, whose replay reruns the
Python, serves the report eval: its step is a function of its inputs.)
The optimizer is built capturable and multi-tensor, as on the card, for
the eager twins too: the CPU's single-tensor Adam reads its step count on
the host.

Sizes: encdec at width 0.25 (f32) with a 32x48 input, synthetic scenes
40x56 with a 15x11 depth grid, batch 2; torch runs one thread.

Tolerances: a graphed loop against its eager twin, bit for bit (the same
ops in the same order on the same inputs); the graphed loop's logged
losses against the JAX loop's within rtol 2e-2, as
tests/test_torch_train_loop.py::test_loss_curve_matches_jax_loop states;
the report's per-image rows against the JAX `eval_report_step` within
1e-4 relative (1e-5 absolute), as tests/test_torch_eval.py states.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.optim.adam as torch_adam
from torch.utils._python_dispatch import TorchDispatchMode

from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.models import registry as jreg
from ann3depth_tpu.train import losses as jlosses
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
from ann3depth_tpu_torch.pipeline import streaming_pool
from ann3depth_tpu_torch.train import checkpoint as tckpt
from ann3depth_tpu_torch.train import dispatch
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep
from test_torch_graphs import graph_semantics  # noqa: F401 (a fixture)

LOSS_RTOL = 2e-2
RTOL, ATOL = 1e-4, 1e-5
HOST_READS = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default)


# ---------------------------------------------------------------------------
# A capture hook with a CUDA graph's semantics for a stateful step.
# ---------------------------------------------------------------------------

def _tensors(v):
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    return []


def _written(func, args, kwargs):
    """The tensors an op writes (its schema's mutable arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out += _tensors(args[i] if i < len(args) else kwargs.get(a.name))
    return out


def _is_view(func):
    schema = func._schema
    return (bool(schema.returns)
            and all(r.alias_info is not None for r in schema.returns)
            and not any(a.alias_info is not None and a.alias_info.is_write
                        for a in schema.arguments))


class _Tape(TorchDispatchMode):
    """Records every op below autograd, and the storages it writes as they
    were before the first write."""

    def __init__(self):
        super().__init__()
        self.ops, self.saved = [], {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_READS:
            raise RuntimeError(f"{func} reads a device value on the host: "
                               "a CUDA graph cannot capture it")
        for t in _written(func, args, kwargs):
            st = t.untyped_storage()
            self.saved.setdefault(st.data_ptr(), (st, st.clone()))
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def tape_capture(run):
    """`dispatch.BlockRunner`'s capture hook: `run()` recorded, every
    tensor put back as it was; `replay()` reruns the recorded ops on the
    recorded tensors, each new result copied into the recorded one."""
    tape = _Tape()
    with tape:
        out = run()
    for st, before in reversed(list(tape.saved.values())):
        st.copy_(before)
    ops = [op for op in tape.ops if not _is_view(op[0])]

    def replay():
        with torch.no_grad():
            for func, args, kwargs, recorded in ops:
                new = func(*args, **kwargs)
                if not _written(func, args, kwargs):
                    for o, n in zip(_tensors(recorded), _tensors(new)):
                        o.copy_(n)

    return out, replay


@pytest.fixture
def card_optimizer(monkeypatch):
    """The update rule built as on the card: capturable, multi-tensor."""
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: ["cuda", "cpu"])

    def init(self, params):
        opt = self.build(list(params), capturable=True)
        for group in opt.param_groups:
            group["foreach"] = True
        return opt

    monkeypatch.setattr(tstep.UpdateRule, "init", init)


@pytest.fixture
def runners(monkeypatch, card_optimizer):
    """Within the test: a twin's `train` runs eagerly; `graphed(fn)` runs
    fn with every BlockRunner captured through `tape_capture`, and keeps
    the runners made."""
    made = []
    init = dispatch.BlockRunner.__init__

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(dispatch.BlockRunner, "__init__", kept)

    def graphed(fn):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dispatch.BlockRunner, "capture_hook",
                       staticmethod(tape_capture))
            return fn()

    graphed.made = made
    return graphed


# ---------------------------------------------------------------------------
# The graphed loop against its eager twin.
# ---------------------------------------------------------------------------

def _cfg(tmp_path, sub, data=None, **train):
    cfg = get_config("make3d-encdec")
    data = {**dict(datasets=("synthetic",), input_hw=(32, 48),
                   synth_img_hw=(40, 56), synth_depth_hw=(15, 11),
                   synth_n=8, synth_test_n=4, augment=True), **(data or {})}
    train = {**dict(batch_size=2, steps=3, log_every=1, checkpoint_every=0,
                    eval_every=0, warmup_steps=2, ema_decay=0.9,
                    ckpt_dir=str(tmp_path / sub / "ckpt")), **train}
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **data),
        model=dataclasses.replace(cfg.model, width_mult=0.25,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **train))


def _train(cfg, tmp_path, sub, **kw):
    return tloop.train(cfg, workdir=str(tmp_path / sub), progress=False,
                       device="cpu", **kw)


def _rows(tmp_path, sub):
    with open(tmp_path / sub / "metrics.jsonl") as f:
        return [{k: v for k, v in r.items()
                 if k not in ("time", "images_per_sec")}
                for r in map(json.loads, f)]


def _same_state(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for k in a.ema_params:
        assert torch.equal(a.ema_params[k], b.ema_params[k]), k
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step


def _twins(runners, tmp_path, cfg_of, **kw):
    """The eager run and the graphed run of one config: (eager state,
    graphed state, their metrics rows)."""
    eager, _ = _train(cfg_of("eager"), tmp_path, "eager", **kw)
    graph, last = runners(lambda: _train(cfg_of("graph"), tmp_path, "graph",
                                         **kw))
    rows = _rows(tmp_path, "eager"), _rows(tmp_path, "graph")
    assert last["loss"] == [r for r in rows[1] if "loss" in r][-1]["loss"]
    return eager, graph, rows


class _TwoShapes:
    """build_dataset with the second dataset at another raw shape."""

    def __init__(self, real):
        self.real = real

    def __call__(self, cfg, split="train", name=None):
        if split == "train" and name == "make3d":
            return SyntheticDepthDataset(n=8, img_hw=(48, 64),
                                         depth_hw=(20, 16), seed=3)
        return self.real(cfg, split)


def _teacher(tmp_path):
    cfg = _cfg(tmp_path, "teacher")
    state = tloop.create_state(cfg, torch.device("cpu"))
    tckpt.CheckpointManager(cfg.train.ckpt_dir).save(0, state)
    return cfg.train.ckpt_dir


@pytest.mark.parametrize("case", ["host-feed", "pool", "grad-accum-2",
                                  "distill", "two-shapes"])
def test_graphed_loop_equals_the_eager_loop(runners, tmp_path, monkeypatch,
                                            case):
    """Each feed at K=1: one capture (two for two raw shapes) after the
    eager first step, the other steps replays; params, EMA, optimizer
    state and every logged metric equal the eager loop's bit for bit."""
    data, train, captures = {}, {}, 1
    if case == "pool":
        data = {"cache_device": True}
    elif case == "grad-accum-2":
        train = {"grad_accum": 2}
    elif case == "distill":
        train = {"distill_from": _teacher(tmp_path), "distill_alpha": 0.5,
                 "distill_width_mult": 0.25, "ema_decay": 0.0}
    elif case == "two-shapes":
        monkeypatch.setattr(tloop, "build_dataset",
                            _TwoShapes(tloop.build_dataset))
        data, train, captures = {"datasets": ("synthetic", "make3d")}, \
            {"steps": 4}, 2
    eager, graph, (want, got) = _twins(
        runners, tmp_path, lambda sub: _cfg(tmp_path, sub, data, **train))
    (runner,) = runners.made
    assert runner.captures == captures
    assert runner.replays == graph.step - captures
    assert (runner.sampler is not None) == (case == "pool")
    if case != "distill":
        _same_state(eager, graph)
    else:  # no EMA
        for x, y in zip(eager.model.parameters(), graph.model.parameters()):
            assert torch.equal(x, y)
        assert "distill" in got[-1]
    assert got == want and len(got) == graph.step


def test_graphed_loop_resumes_and_restores_in_place(runners, tmp_path):
    """A run with in-loop evals, early stop and the best-eval slot stops
    early with the best params written back in place, then a resumed run
    trains on from that save: both runs equal their eager twins."""
    stop = dict(steps=6, eval_every=1, log_every=1, checkpoint_every=2,
                early_stop_patience=1, save_best=True, learning_rate=0.1,
                warmup_steps=0)
    for phase, train in (("stop", stop), ("resume", dict(
            stop, steps=8, resume=True, early_stop_patience=0,
            eval_every=0, save_best=False))):
        eager, graph, (want, got) = _twins(
            runners, tmp_path, lambda sub: _cfg(tmp_path, sub, **train))
        _same_state(eager, graph)
        assert got == want, phase
    first, second = runners.made
    assert first.captures == second.captures == 1
    evals = [r for r in want if "eval_rmse" in r]
    stopped = max(r["step"] for r in evals)
    assert stopped < 6, "the run did not stop early"
    assert graph.step == 8 and first.replays == stopped - 1


def test_graphed_loop_matches_the_jax_loop(runners, tmp_path, monkeypatch):
    """test_torch_train_loop.py::test_loss_curve_matches_jax_loop with the
    port's step replayed: same initial params, same batches, lr 1e-2."""
    over = dict(data=dict(datasets=("synthetic",), input_hw=(32, 48),
                          synth_img_hw=(40, 56), synth_depth_hw=(15, 11),
                          synth_n=8, synth_test_n=4),
                model=dict(name="encdec", width_mult=0.25),
                train=dict(batch_size=2, steps=5, log_every=1,
                           checkpoint_every=0, eval_every=0,
                           learning_rate=1e-2))
    cfgs = []
    for get, sub in ((jget_config, "jax"), (get_config, "port")):
        cfg = get("make3d-encdec")
        for name, values in over.items():
            values = dict(values, **({"ckpt_dir": str(tmp_path / sub)}
                                     if name == "train" else {}))
            cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
                getattr(cfg, name), **values)})
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
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
    state, last = runners(lambda: tloop.train(
        tcfg, workdir=str(tmp_path / "port"), progress=False,
        device="cpu"))
    want, got = (
        [r["loss"] for r in map(json.loads, open(tmp_path / d /
                                                 "metrics.jsonl"))]
        for d in ("jax", "port"))
    assert len(want) == len(got) == 5
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    (runner,) = runners.made
    assert runner.captures == 1 and runner.replays == 4


def test_a_step_that_rebinds_its_state_fails_under_the_hook(
        runners, tmp_path, monkeypatch):
    """An EMA that rebinds the dict's tensors instead of writing them in
    place trains as the in-place one does eagerly; replayed, its step
    reads the tensors of the capture, so the EMA goes stale."""
    def rebinding(ema, params, ema_decay):
        for k in list(ema):
            ema[k] = ema_decay * ema[k] + (1 - ema_decay) * params[k].detach()
        return ema

    monkeypatch.setattr(tstep, "ema_update", rebinding)
    eager, graph, _ = _twins(runners, tmp_path,
                             lambda sub: _cfg(tmp_path, sub, steps=4))
    for x, y in zip(eager.model.parameters(), graph.model.parameters()):
        assert torch.equal(x, y)
    stale = [k for k in eager.ema_params
             if not torch.equal(eager.ema_params[k], graph.ema_params[k])]
    assert len(stale) == len(eager.ema_params)


def test_a_host_read_in_the_step_fails_the_capture(runners, tmp_path,
                                                   monkeypatch):
    inner = tstep.train_step

    def syncing(*a, **kw):
        state, metrics = inner(*a, **kw)
        float(metrics["loss"])
        return state, metrics

    monkeypatch.setattr(tstep, "train_step", syncing)
    with pytest.raises(RuntimeError, match="a CUDA graph cannot capture"):
        runners(lambda: _train(_cfg(tmp_path, "s"), tmp_path, "s"))
    (runner,) = runners.made
    assert runner.captures == runner.replays == 0


def test_window_calibration_times_the_step_the_loop_replays(
        runners, tmp_path, monkeypatch):
    """--window-epochs auto: the calibration passes run a BlockRunner on
    the probe window (a capture, then replays), the same step program the
    loop then replays from the window pool."""
    calls = []
    real = dispatch.BlockRunner.run

    def spy(self, item, more=True):
        calls.append((self, self.sampler, self.k, dict(self.kw)))
        return real(self, item, more)

    monkeypatch.setattr(dispatch.BlockRunner, "run", spy)
    probes = []
    calibrate = streaming_pool.calibrate_window_epochs

    def kept(*a, run_pass, **kw):
        def recorded(probe, blocks):
            probes.append(probe)
            return run_pass(probe, blocks)
        return calibrate(*a, run_pass=recorded, **kw)

    monkeypatch.setattr(streaming_pool, "calibrate_window_epochs", kept)
    # 1 MB windows of 9 scenes: 4 batches a calibration pass
    ds = SyntheticDepthDataset(n=24, img_hw=(160, 224), depth_hw=(40, 56))
    cfg = _cfg(tmp_path, "w", {"cache_device": True, "cache_window_mb": 1,
                               "window_epochs": 0}, steps=2, ema_decay=0.0)
    state, _ = runners(lambda: _train(cfg, tmp_path, "w", dataset=ds))
    cal, run = runners.made
    assert probes and probes[0] is probes[1]
    cal_calls = [c for c in calls if c[0] is cal]
    run_calls = [c for c in calls if c[0] is run]
    assert cal_calls and run_calls and len(calls) == len(cal_calls) + len(
        run_calls)
    assert cal_calls[0][1] is probes[0] and run_calls[0][1] is not None
    assert cal_calls[0][2] == run_calls[0][2] == 1
    assert cal_calls[0][3] == run_calls[0][3]
    assert cal.captures == run.captures == 1
    assert cal.replays == len(cal_calls) - 1 and state.step == 2


# ---------------------------------------------------------------------------
# The report eval through a GraphCache.
# ---------------------------------------------------------------------------

class _Ragged:
    """A split whose batches keep the remainder as a last, short batch."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def batches(self, batch_size, **kw):
        return self.ds.batches(batch_size, **dict(kw, drop_remainder=False))


def _report(tmp_path, sub, cfg, state, dataset, **kw):
    out = tmp_path / sub
    metrics = tloop.evaluate(cfg, state=state, dataset=dataset,
                             report_dir=str(out), report_worst=3, **kw)
    rows = [json.loads(ln) for ln in open(out / "per_image.jsonl")]
    return metrics, rows, json.load(open(out / "summary.json")), (
        out / "worst.png").read_bytes()


@pytest.mark.parametrize("tta", ["flip"])
def test_report_eval_graphs_equal_eager_and_jax(graph_semantics, tmp_path,
                                                tta):
    """eval --report-dir on 5 test scenes at batch 2 (2, 2, then a ragged
    1): one capture for each batch shape; per-image rows, summary, metrics
    and worst grid equal the eager report's; the rows against the JAX
    report's within RTOL / ATOL."""
    cfg = _cfg(tmp_path, "r", {"synth_test_n": 5})
    jcfg = jget_config("make3d-encdec")
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, input_hw=(32, 48)),
        model=dataclasses.replace(jcfg.model, width_mult=0.25,
                                  compute_dtype="float32"),
        train=dataclasses.replace(jcfg.train, batch_size=2))
    params = jstep.init_params(jreg.build(jcfg.model), jcfg.data.input_hw,
                               seed=0)
    state = tloop.create_state(cfg, torch.device("cpu"))
    state.model.load_state_dict(convert.to_state_dict(
        jax.tree.map(np.asarray, params)))
    split = _Ragged(tloop.build_dataset(cfg, "test"))
    got = _report(tmp_path, "graph", cfg, state, split, tta=tta)
    (cache,) = graph_semantics
    assert cache.captures == 2 and cache.replays == 3
    with pytest.MonkeyPatch.context() as mp:  # the eager report
        mp.setattr(tloop, "eval_report_graphs", lambda state, dev: (
            lambda i, d, **k: tstep.eval_report_step(state, i, d, **k)))
        want = _report(tmp_path, "eager", cfg, state, split, tta=tta)
    assert got == want
    jstate = jloop.create_state(jcfg).replace(params=params)
    kw = dict(input_hw=(32, 48), target_hw=jloop.resolved_target_hw(jcfg),
              si_lambda=jcfg.train.si_lambda, loss_kind=jcfg.train.loss,
              tta=tta)
    jax_rows = []
    with jax.default_matmul_precision("highest"):
        for img, dep in split.batches(2, shuffle=False):
            per = jstep.eval_report_step(jstate, img, dep, **kw)[0]
            per = {k: np.asarray(v) for k, v in per.items()}
            fin = jlosses.finalize_depth_metrics(
                {**{k: v for k, v in per.items() if k != "si_loss"},
                 "sum_si_loss": per["si_loss"],
                 "n_images": np.ones(len(img), np.float32)})
            jax_rows += [{k: float(v[i]) for k, v in fin.items()}
                         for i in range(len(img))]
    assert len(got[1]) == len(jax_rows) == 5
    for i, (g, w) in enumerate(zip(got[1], jax_rows)):
        assert g.pop("index") == i and sorted(g) == sorted(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=RTOL, abs=ATOL), k
