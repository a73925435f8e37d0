"""The port's counterpart of `jax.jit` (ann3depth_tpu_torch/utils/graphs.py)
and the paths that run through it (serve, live, transcode, eval, infer),
on the CPU.

A CUDA graph exists only on the card. Here the cache's keying, its static
input buffers and its static outputs run through a capture hook with a
graph's semantics (`static_capture`: the outputs are fixed tensors that
every replay overwrites), which the `graph_semantics` fixture gives every
`GraphCache` the paths build. A caller that reads an output after the
next call, or a step that rebinds its state instead of writing it in
place, then fails here as it would on the card.

Sizes: encdec at width 0.25 (f32) with a 32x48 input, frames of 48x64,
synthetic eval scenes 40x56 with a 15x11 depth grid.

Tolerances: the live sequence against the JAX `live_step` sequence within
LOG_TOL = 1e-4 in log-depth, as tests/test_torch_live.py states (f32 on
both sides, summation order only). Paths through the hook against the
same code run eagerly: equal, bit for bit (the same ops in the same order
on the same inputs).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann3depth_tpu.live import infer as jinfer
from ann3depth_tpu.models import encdec as jenc
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import convert, server, serving
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.live import infer as tinfer
from ann3depth_tpu_torch.live.transcode import render_batches
from ann3depth_tpu_torch.models import encdec as tenc
from ann3depth_tpu_torch.train import loop as tloop
from ann3depth_tpu_torch.train import step as tstep
from ann3depth_tpu_torch.utils import graphs

IN_HW = (32, 48)
FRAME_HW = (48, 64)
LOG_TOL = 1e-4


def _leaves(out):
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _leaves(v)]
    return [out]


def static_capture(run, log=None):
    """A capture hook with a graph's semantics: `run()` once for the
    outputs, then every replay runs it again and writes the result into
    those same tensors."""
    out = run()
    if log is not None:
        log.append("capture")

    def replay():
        with torch.inference_mode():
            for o, n in zip(_leaves(out), _leaves(run())):
                o.copy_(n)

    return out, replay


@pytest.fixture
def graph_semantics(monkeypatch):
    """Every GraphCache made in the test runs through `static_capture`;
    returns the caches made."""
    made = []
    init = graphs.GraphCache.__init__

    def hooked(self, fn, *, device=None, capture=None):
        init(self, fn, device=device, capture=capture or static_capture)
        made.append(self)

    monkeypatch.setattr(graphs.GraphCache, "__init__", hooked)
    return made


# ---------------------------------------------------------------------------
# The cache.
# ---------------------------------------------------------------------------

def _affine(x, y, *, scale, shift=(0.0,)):
    return {"sum": x * scale + y, "shifted": (x + shift[0],)}


def test_cache_captures_once_for_each_shape_and_static_kwargs():
    log = []
    cache = graphs.GraphCache(_affine, capture=functools.partial(
        static_capture, log=log))
    a, b = torch.ones(2, 3), torch.ones(4, 3)
    for x, kw in ((a, dict(scale=2.0)), (a, dict(scale=2.0)),
                  (b, dict(scale=2.0)), (a, dict(scale=3.0)),
                  (a, dict(scale=2.0, shift=[1.0])),
                  (a, dict(scale=2.0, shift=(1.0,))),  # a list is a tuple
                  (a.double(), dict(scale=2.0)), (b, dict(scale=2.0))):
        out = cache(x, x, **kw)
        want = _affine(x, x, **kw)
        assert torch.equal(out["sum"], want["sum"])
        assert torch.equal(out["shifted"][0], want["shifted"][0])
    assert cache.captures == len(cache) == len(log) == 5
    assert cache.replays == 8


def test_cache_copies_inputs_and_keeps_outputs_until_the_next_call():
    cache = graphs.GraphCache(lambda x: x * 2.0, capture=static_capture)
    x = torch.arange(6.0).reshape(2, 3)
    first = cache(x)
    x.fill_(100.0)  # the call copied x: its buffer does not change
    assert torch.equal(first, torch.arange(6.0).reshape(2, 3) * 2.0)
    ((buf,), _, _) = next(iter(cache._entries.values()))
    assert buf is not x and torch.equal(buf, torch.arange(6.0).reshape(2, 3))
    second = cache(torch.ones(2, 3))
    # The static output: the next call overwrote the first answer.
    assert second is first and torch.equal(first, torch.full((2, 3), 2.0))
    assert torch.equal(buf, torch.ones(2, 3))
    other = cache(torch.ones(1, 3))  # another key, its own buffers
    assert other is not first and torch.equal(first, torch.full((2, 3), 2.0))


def test_cache_called_in_and_out_of_inference_mode():
    """A key first called inside inference_mode takes later calls outside
    it (its static inputs are normal tensors)."""
    cache = graphs.GraphCache(torch.inference_mode()(lambda x: x + 1.0),
                              capture=static_capture)
    with torch.inference_mode():
        cache(torch.zeros(2))
    assert torch.equal(cache(torch.ones(2)), torch.full((2,), 2.0))


def test_cache_without_a_hook_runs_eagerly_on_the_cpu():
    calls = []
    cache = graphs.GraphCache(lambda x, *, k: calls.append(k) or x + k)
    one, two = cache(torch.zeros(2), k=1), cache(torch.zeros(2), k=1)
    assert one is not two and torch.equal(one, torch.ones(2))
    assert calls == [1, 1] and cache.captures == len(cache) == 0
    host = graphs.GraphCache(lambda x: x + 1, device="cpu")
    assert torch.equal(host(torch.zeros(2)), torch.ones(2))


def test_cache_refuses_what_it_cannot_key():
    cache = graphs.GraphCache(lambda *a, **k: a[0], capture=static_capture)
    with pytest.raises(TypeError, match="positional"):
        cache(torch.zeros(1), 3)
    with pytest.raises(TypeError, match="unhashable"):
        cache(torch.zeros(1), table={"a": 1})


def test_caches_lists_the_live_caches_and_clear_drops_the_graphs():
    log = []
    made = [graphs.GraphCache(lambda x: x + 1, capture=functools.partial(
        static_capture, log=log)) for _ in range(2)]
    assert all(c in graphs.caches() for c in made)
    made[0](torch.zeros(1))
    made[0].clear()
    assert len(made[0]) == 0
    made[0](torch.zeros(1))
    assert len(log) == 2 and made[0].captures == 2


def test_replay_on_the_cpu_is_the_eager_call():
    x = torch.ones(3)
    replay = graphs.Replay(lambda t: t * 3.0, x)
    assert replay.graph is None and torch.equal(replay(), torch.full(
        (3,), 3.0))
    x.fill_(2.0)
    assert torch.equal(replay(), torch.full((3,), 6.0))


# ---------------------------------------------------------------------------
# The paths.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params():
    model = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    params = jax.jit(functools.partial(jstep.init_params, model, IN_HW))(
        seed=0)
    return jax.tree.map(np.asarray, params)


def _model():
    tm = tenc.EncDecDepthNet(width_mult=0.25, compute_dtype=torch.float32)
    tm.load_state_dict(convert.to_state_dict(_params()), strict=True)
    return tm.eval()


def _frames(n, hw=FRAME_HW, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def test_live_smoothing_with_a_reset_matches_jax(graph_semantics):
    """Four frames through a smoothing engine, its carry reset after the
    second, against the JAX live_step sequence; one capture, a replay a
    frame (and the constructor's)."""
    jm = jenc.EncDecDepthNet(width_mult=0.25, compute_dtype=jnp.float32)
    engine = tinfer.LiveEngine(_model(), FRAME_HW, IN_HW, smooth=0.7)
    frames = _frames(4, seed=7)
    carry = jnp.zeros((1, 16, 24), jnp.float32)
    for i, frame in enumerate(frames):
        if i == 2:
            engine.reset_smoothing()
            carry = jnp.zeros_like(carry)
        has_prev = jnp.asarray(float(i not in (0, 2)), jnp.float32)
        wd, _, carry = jinfer.live_step(
            jm.apply, _params(), jnp.asarray(frame[None]), input_hw=IN_HW,
            display_hw=FRAME_HW, smooth=0.7, prev_log=carry,
            has_prev=has_prev)
        gd, gr, _ = engine.infer(frame, fetch_depth=True)
        np.testing.assert_allclose(np.log(gd), np.log(np.asarray(wd[0])),
                                   rtol=0, atol=LOG_TOL)
        assert gr.shape == (*FRAME_HW, 3)
    (cache,) = graph_semantics
    assert cache.captures == 1 and cache.replays == 5


def test_live_pipeline_keeps_each_frames_depth(graph_semantics):
    """submit k+1 before retrieving k, as the viewer does: frame k's depth
    is its own, though the graph's output already holds frame k+1's."""
    engine = tinfer.LiveEngine(_model(), FRAME_HW, IN_HW)
    frames = _frames(2, seed=8)
    want = [tinfer.live_step(engine.model, torch.from_numpy(f[None]),
                             input_hw=IN_HW, display_hw=FRAME_HW)
            for f in frames]
    first = engine.submit(frames[0])
    second = engine.submit(frames[1])
    for token, (wd, wr) in zip((first, second), want):
        gd, gr, _ = engine.retrieve(token, fetch_depth=True)
        assert np.array_equal(gd, wd[0].numpy())
        assert np.array_equal(gr, wr[0].numpy())


def test_transcode_loop_with_a_tail_batch(graph_semantics):
    """render_batches at batch 2 with a tail of 1: one capture for each
    shape, and every batch equal to live_step on it."""
    model = _model()
    frames = _frames(5, seed=9)
    batches = [(frames[0:2], 2), (frames[2:4], 2), (frames[4:5], 1)]
    out = list(render_batches(model, iter(batches), input_hw=IN_HW))
    for (x, n), (_, rendered, depth) in zip(batches, out):
        wd, wr = tinfer.live_step(model, torch.from_numpy(x),
                                  input_hw=IN_HW, display_hw=FRAME_HW)
        assert np.array_equal(depth, wd[:n].numpy())
        assert np.array_equal(rendered, wr[:n].numpy())
    (cache,) = graph_semantics
    assert cache.captures == 2 and cache.replays == 3


def test_infer_image_through_the_models_cache(graph_semantics):
    model = _model()
    frames = _frames(3, seed=10)
    got = [tstep.infer_image(model, f, input_hw=IN_HW) for f in frames]
    for f, g in zip(frames, got):
        want = tstep.infer_step(model, torch.from_numpy(f[None]),
                                input_hw=IN_HW)[0].numpy()
        assert np.array_equal(g, want)
    assert tstep.infer_graphs(model) is tstep.infer_graphs(model)
    (cache,) = graph_semantics
    assert cache.captures == 1 and cache.replays == 3


def test_service_warmup_captures_every_bucket(graph_semantics):
    seen = []
    svc = server.BatchingService(
        lambda frames: seen.append(frames.shape[0]) or np.zeros(
            (frames.shape[0], 2, 2), np.float32), FRAME_HW, max_batch=8)
    try:
        svc.warmup()
    finally:
        svc.close()
    assert seen == [1, 2, 4, 8]

    cfg = get_config("make3d-encdec")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, input_hw=IN_HW),
        model=dataclasses.replace(cfg.model, width_mult=0.25,
                                  compute_dtype="float32"))
    svc = server.service_from_config(cfg, init=True, raw_hw=FRAME_HW,
                                     max_batch=4, device="cpu")
    try:
        cache = svc._fn.fn
        assert isinstance(cache, graphs.GraphCache)
        svc.warmup()
        assert cache.captures == len(cache) == 3  # buckets 1, 2, 4
        frame = _frames(1, seed=11)[0]
        got = svc.predict(frame)
    finally:
        svc.close()
    assert cache.captures == 3 and cache.replays == 4
    model = serving.model_from_checkpoint(cfg, init=True, device="cpu")
    want = serving.serving_program(model, IN_HW)(
        torch.from_numpy(frame[None]))[0].numpy()
    assert np.array_equal(got, want)


def _eval_cfg(tmp_path):
    cfg = get_config("make3d-encdec")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, datasets=("synthetic",),
                                 input_hw=IN_HW, synth_img_hw=(40, 56),
                                 synth_depth_hw=(15, 11), synth_n=4,
                                 synth_test_n=6),
        model=dataclasses.replace(cfg.model, width_mult=0.25,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=2,
                                  ckpt_dir=str(tmp_path)))


@pytest.mark.parametrize("tta,align,crop", [("", "", ""),
                                            ("flip", "median", "eigen")],
                         ids=["plain", "tta+align+crop"])
def test_evaluate_through_the_cache_equals_the_step(graph_semantics,
                                                    tmp_path, tta, align,
                                                    crop):
    cfg = _eval_cfg(tmp_path)
    state = tloop.create_state(cfg, torch.device("cpu"))
    got = tloop.evaluate(cfg, state=state, max_batches=3, tta=tta,
                         align=align, crop=crop)
    (cache,) = graph_semantics
    assert cache.captures == 1 and cache.replays == 3
    totals = {}
    kw = dict(input_hw=IN_HW, target_hw=tloop.resolved_target_hw(cfg),
              si_lambda=cfg.train.si_lambda, loss_kind=cfg.train.loss,
              tta=tta, align=align, crop=crop)
    for img, dep in tloop.build_dataset(cfg, "test").batches(
            2, steps=3, shuffle=False):
        stats = tstep.eval_stats_step(state, torch.from_numpy(img),
                                      torch.from_numpy(dep), **kw)
        for k, v in stats.items():
            totals[k] = totals[k] + v if k in totals else v
    want = tloop.losses.finalize_depth_metrics(
        {k: float(v) for k, v in totals.items()})
    assert got == want


def test_train_loop_evals_share_one_cache(graph_semantics, tmp_path,
                                          monkeypatch):
    """The in-loop evals of one run replay one cache, made before the
    first step: its graphs hold the params, which the steps write in
    place. The last eval equals `evaluate` on the final state."""
    cfg = _eval_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps=4, log_every=2, checkpoint_every=0, eval_every=2,
        warmup_steps=1))
    seen = []
    inner = tloop.evaluate

    def recording(*a, stats_graphs=None, **kw):
        seen.append((stats_graphs, [p.data_ptr() for p in
                                    kw["state"].model.parameters()]))
        return inner(*a, stats_graphs=stats_graphs, **kw)

    monkeypatch.setattr(tloop, "evaluate", recording)
    state, _ = tloop.train(cfg, workdir=str(tmp_path), progress=False,
                           device="cpu")
    (cache,) = graph_semantics
    assert [g for g, _ in seen] == [cache, cache]
    assert seen[0][1] == seen[1][1]  # the same param tensors at each eval
    # EVAL_SAMPLE_BATCHES batches an eval, the first batch captured
    assert cache.captures == 1
    assert cache.replays == 2 * tloop.EVAL_SAMPLE_BATCHES
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [r for r in map(json.loads, f)
                if "eval_rmse" in r]
    want = inner(cfg, state=state, max_batches=tloop.EVAL_SAMPLE_BATCHES)
    assert [r["step"] for r in rows] == [2, 4]
    assert {k: rows[-1][f"eval_{k}"] for k in want} == want


def test_eval_refused_where_its_collectives_cannot_be_captured(monkeypatch):
    """A tensor-parallel state on the gloo backend: refused on the card
    (its model-axis all-reduces run on the host), a cache elsewhere."""
    from ann3depth_tpu_torch.parallel import mesh as meshlib

    tp = type("State", (), {"mesh": meshlib.Mesh(n_model=2,
                                                 distributed=True)})()
    dp = type("State", (), {"mesh": meshlib.Mesh(n_data=2,
                                                 distributed=True)})()
    cuda = torch.device("cuda")
    monkeypatch.setattr(tloop.multihost, "backend", lambda: "gloo")
    with pytest.raises(ValueError, match="gloo backend's model-axis"):
        tloop.eval_stats_graphs(tp, cuda)
    for state, dev in ((dp, cuda), (tp, torch.device("cpu"))):
        assert isinstance(tloop.eval_stats_graphs(state, dev),
                          graphs.GraphCache)
    monkeypatch.setattr(tloop.multihost, "backend", lambda: "nccl")
    assert isinstance(tloop.eval_stats_graphs(tp, cuda), graphs.GraphCache)
