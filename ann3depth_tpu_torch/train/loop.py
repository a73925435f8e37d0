"""The training and eval loops of the port.

Counterpart of `ann3depth_tpu/train/loop.py` (`build_dataset`,
`resolved_target_hw`, `create_state`, `train`, `predict_batch`, `evaluate`
with its report, `restore_state_for_eval`, `evaluate_protocols`). The feed
is one of

- a device-resident pool (`cache_device`, pipeline/device_cache.py), or a
  rotating window pool over a larger dataset (`cache_window_mb`, with
  `window_epochs` echo passes, `0` = calibrated, persisted in
  <ckpt_dir>/window_epochs.json; pipeline/streaming_pool.py);
- host batches (the dataset's own, several datasets batch-interleaved, or
  a worker-process loader with `use_grain`/`num_workers`,
  pipeline/grain_loader.py) through the prefetching `DeviceFeed`
  (pipeline/feed.py);

then `train_step` (with gradient accumulation) or `distill_train_step`,
which the card runs as replays of a CUDA graph of the step on every feed
(train/dispatch.py: a step a replay, from a pool K = `steps_per_dispatch`
replays a dispatch), and which runs eagerly on the CPU and over gloo on
the card (decided before the first step, and logged).
Metrics are read and logged every `log_every` steps (also to TensorBoard
with `tensorboard`), checkpoints written every `checkpoint_every`, a
4-batch eval sample scored (and an rgb|gt|pred grid of it written to the
workdir) every `eval_every` (from a device-resident eval pool on a
cache_device run), with early stopping and a best-eval checkpoint on top;
`resume` continues the step counter from the latest checkpoint,
`resume_step` rolls back to an earlier one; `profile_dir` traces a window
of steps (of dispatches under K > 1) with torch.profiler.

Over several processes (parallel/multihost.py: one per device) the run
is data parallel on the mesh of `parallel.mesh.auto_data_mesh`: each rank
reads its strided shard of the dataset (or holds its shard of the device
pool) at batch_size / n_data rows, draws the global batch's augmentation
and keeps its rows (`train.step.shard_draws`), and averages its gradients
over the data axis in the step; `zero1` shards the optimizer state
(parallel/zero1.py), `tensor_parallel` shards the DPT blocks over a model
axis (parallel/sharding_rules.py). Rank 0 writes checkpoints, metrics,
TensorBoard and viz; every rank restores. Eval shards the split the same
way and sums its statistics over the ranks.
"""

from __future__ import annotations

import heapq
import json
import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ann3depth_tpu_torch.config import Config
from ann3depth_tpu_torch.device import resolve_device
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.parallel import mesh as meshlib
from ann3depth_tpu_torch.parallel import multihost
from ann3depth_tpu_torch.pipeline import device_cache
from ann3depth_tpu_torch.train import dispatch, losses
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.train.checkpoint import CheckpointManager
from ann3depth_tpu_torch.utils import graphs, tracing
from ann3depth_tpu_torch.utils.metrics_writer import MetricsWriter

log = logging.getLogger(__name__)

EVAL_SAMPLE_BATCHES = 4  # in-loop eval is a sample, not the full split


def build_dataset(cfg: Config, split="train", name=None):
    """Dataset factory: name -> raw (uint8 rgb, f32 depth) example source.

    Prefers packed records (`cli prepare`) under <data_dir>/records when
    present; falls back to the raw-file loaders."""
    name = name or cfg.data.datasets[0]
    if name == "synthetic":
        from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
        train = split == "train"
        return SyntheticDepthDataset(
            n=cfg.data.synth_n if train else cfg.data.synth_test_n,
            img_hw=tuple(cfg.data.synth_img_hw),
            depth_hw=tuple(cfg.data.synth_depth_hw),
            seed=0 if train else 1)

    from ann3depth_tpu_torch.data import records
    index = records.find_index(
        os.path.join(cfg.data.data_dir, "records"), name, split)
    if index:
        log.info("using packed records: %s", index)
        return records.RecordDataset(index)

    if name == "make3d":
        from ann3depth_tpu_torch.data.make3d import Make3DDataset
        return Make3DDataset(cfg.data.data_dir, split=split)
    if name == "nyu":
        from ann3depth_tpu_torch.data.nyu import NYUDataset
        return NYUDataset(cfg.data.data_dir, split=split)
    raise KeyError(f"unknown dataset {name!r}")


def resolved_target_hw(cfg: Config):
    """Depth-target resolution from the model's output stride."""
    return registry.output_hw(cfg.model.name, cfg.data.input_hw)


def create_state(cfg: Config, device=None):
    """Model (initialized from cfg.train.seed) + update rule + TrainState."""
    model = steplib.init_params(registry.build(cfg.model), cfg.data.input_hw,
                                cfg.train.seed, device=device)
    tx = steplib.make_optimizer(
        cfg.train.learning_rate, cfg.train.warmup_steps, cfg.train.steps,
        b1=cfg.train.adam_b1, b2=cfg.train.adam_b2,
        weight_decay=cfg.train.weight_decay, clip_norm=cfg.train.clip_norm,
        optimizer=cfg.train.optimizer, schedule=cfg.train.schedule)
    return steplib.TrainState.create(model, tx, ema=cfg.train.ema_decay > 0)


def parallel_state(cfg: Config, state, mesh):
    """`state` (fresh from create_state) on the run's mesh: the params
    replicated from data-rank 0, then the DPT blocks sharded over the
    model axis (cfg.train.tensor_parallel > 1) or the optimizer made
    ZeRO-1's (cfg.train.zero1); its step averages over the data axis.
    Unchanged on one process without either option."""
    t = cfg.train
    if not (mesh.active() or t.zero1 or t.tensor_parallel > 1):
        return state
    model, ema = state.model, state.ema_params is not None
    meshlib.replicate(model, mesh)
    if t.zero1:
        from ann3depth_tpu_torch.parallel import zero1
        return zero1.create_state(model, state.tx, mesh, ema=ema)
    plan = None
    if t.tensor_parallel > 1:
        from ann3depth_tpu_torch.parallel import sharding_rules
        plan = sharding_rules.shard_params(model, mesh)
    return steplib.TrainState.create(model, state.tx, ema=ema, mesh=mesh,
                                     tp_plan=plan)


def _validate(cfg: Config):
    """The JAX loop's checks of the options the port trains with."""
    t, d = cfg.train, cfg.data
    if cfg.model.quant not in ("none", "int8-qat"):
        raise ValueError(
            f"model.quant={cfg.model.quant!r} is a serving-only path "
            "(round() has zero gradient); train with quant='none', or "
            "quant='int8-qat' for quantization-aware training, and pass "
            "--quant int8 to eval/live/infer")
    if t.batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {t.batch_size}")
    if t.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {t.grad_accum}")
    for name in ("log_every", "checkpoint_every", "eval_every"):
        if getattr(t, name) < 0:
            raise ValueError(
                f"{name} must be >= 0 (0 disables the periodic cadence; "
                f"the final step still logs/saves), got {getattr(t, name)}")
    if t.batch_size % t.grad_accum:
        raise ValueError(f"batch_size={t.batch_size} is not divisible by "
                         f"grad_accum={t.grad_accum}")
    if d.cache_device and (d.use_grain or len(d.datasets) > 1):
        raise ValueError(
            "cache_device is exclusive with use_grain and multi-dataset "
            "interleave — one resident pool, one source")
    if d.cache_window_mb < 0:
        raise ValueError(
            f"cache_window_mb must be >= 0, got {d.cache_window_mb}")
    if d.cache_window_mb and not d.cache_device:
        raise ValueError(
            "cache_window_mb configures the rotating-window DEVICE cache — "
            "add --cache-device (host-fed runs have no resident pool to "
            "window)")
    if d.window_epochs < 0:
        raise ValueError(
            f"window_epochs must be >= 1 (or 0 = auto-calibrate), got "
            f"{d.window_epochs}")
    if d.window_epochs != 1 and not d.cache_window_mb:
        raise ValueError(
            "window_epochs (data echoing) repeats WINDOW passes — it needs "
            "--cache-window-mb; a full resident pool already revisits every "
            "example each epoch")
    spd = t.steps_per_dispatch
    if spd < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {spd}")
    if spd > 1:
        if not d.cache_device:
            raise ValueError(
                f"steps_per_dispatch={spd} needs --cache-device: folding "
                "K steps into one device program requires the data pool "
                "resident in HBM (a host-fed step can't be scanned)")
        bad = [f"{name}={v}" for name, v in
               (("steps", t.steps), ("log_every", t.log_every),
                ("checkpoint_every", t.checkpoint_every),
                ("eval_every", t.eval_every))
               if v and v % spd]
        if bad:
            raise ValueError(
                f"steps_per_dispatch={spd} must divide the step cadences "
                f"(the loop only regains control at block boundaries); "
                f"offending: {', '.join(bad)}")
    if t.early_stop_patience < 0:
        raise ValueError("early_stop_patience must be >= 0, got "
                         f"{t.early_stop_patience}")
    if t.early_stop_patience and not t.eval_every:
        raise ValueError(
            "early_stop_patience needs in-loop eval to watch: set "
            "eval_every > 0 (the stop criterion is the eval RMSE)")
    if t.save_best and not t.eval_every:
        raise ValueError("save_best needs in-loop eval to rank checkpoints: "
                         "set eval_every > 0")
    if t.distill_from:
        if t.zero1 or t.tensor_parallel > 1 or t.grad_accum > 1:
            raise ValueError(
                "distill_from composes with plain data-parallel training "
                "only; zero1 / tensor_parallel / grad_accum are not wired "
                "into the distillation step")
        if not 0.0 < t.distill_alpha <= 1.0:
            raise ValueError(
                f"distill_alpha must be in (0, 1], got {t.distill_alpha} "
                "(0 would silently ignore the teacher — drop --distill-from "
                "instead)")
    tp = t.tensor_parallel
    if tp < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {tp} "
                         "(1 = no tensor parallelism)")
    if tp > 1:
        if cfg.model.name not in registry.DPT_FAMILY:
            raise ValueError(
                f"tensor_parallel={tp} requires a dpt-family model (the "
                f"TP sharding rules only match the ViT transformer; "
                f"{cfg.model.name!r} would replicate params and waste the "
                "model axis)")
        if t.zero1:
            raise ValueError(
                "tensor_parallel with zero1 is not wired (the ZeRO-1 "
                "shard_map collectives are data-axis only)")


def _attention_note(model, cfg: Config, mesh) -> str:
    """'; attention <SDPA backend> at <shape>' for a model that reports
    the backend its blocks take (`attention_backend`), else ''."""
    backend = getattr(model, "attention_backend", None)
    if backend is None:
        return ""
    t = cfg.train
    batch = t.batch_size // t.grad_accum // mesh.n_data
    return (f"; attention {backend(batch, tuple(cfg.data.input_hw))} at "
            f"batch {batch}, {cfg.model.compute_dtype}")


def step_seed(seed: int, step: int) -> int:
    """The augmentation seed of one step, a function of (seed, step) alone
    as the JAX step's fold_in(rng, step) is, so a resumed run draws what
    the uninterrupted run would have."""
    return int(np.random.SeedSequence((seed, step)).generate_state(
        1, np.uint64)[0])


def restore_teacher(cfg: Config, device):
    """The frozen distillation teacher: registry model `distill_model`
    (default the student's) at `distill_width_mult`, quant "none", with
    the params of the latest checkpoint in cfg.train.distill_from; eval
    mode, no gradients."""
    import dataclasses

    t = cfg.train
    tcfg = dataclasses.replace(cfg.model, name=t.distill_model
                               or cfg.model.name,
                               width_mult=t.distill_width_mult, quant="none")
    teacher = steplib.init_params(registry.build(tcfg), cfg.data.input_hw, 0,
                                  device=device)
    facade = steplib.TrainState(step=0, model=teacher, optimizer=None,
                                tx=None)
    _, restored = CheckpointManager(t.distill_from).restore_params(facade)
    if restored is None:
        raise RuntimeError(
            f"no teacher checkpoint in {t.distill_from!r} (distill_model="
            f"{tcfg.name!r}, width_mult={tcfg.width_mult})")
    log.info("distilling from %s step %d (%s, width %g, alpha %g)",
             t.distill_from, restored, tcfg.name, tcfg.width_mult,
             t.distill_alpha)
    return teacher.eval().requires_grad_(False)


def _restore_for_resume(cfg: Config, state, ckpt):
    """(state, start step): the latest checkpoint with `resume`, the one at
    `resume_step` with a rollback of every newer one."""
    t = cfg.train
    if not (t.resume or t.resume_step is not None):
        return state, 0
    state, restored = ckpt.restore(state, step=t.resume_step)
    if restored is None:
        return state, 0
    log.info("resumed from checkpoint at step %d", state.step)
    if t.resume_step is not None and multihost.process_index() == 0:
        # Explicit rollback: drop the abandoned newer timeline so this
        # run's saves don't collide with existing steps (rank 0 owns the
        # files).
        for s in [s for s in ckpt.all_steps() if s > restored]:
            log.warning("rollback resume: deleting newer checkpoint at "
                        "step %d", s)
            ckpt.delete(s)
    return state, state.step


class _BestTracker:
    """Early stopping and the best-eval checkpoint over the in-loop evals.

    Early stop keeps a host copy of the params at the best eval RMSE and,
    after `patience` evals that fail to beat it by `min_delta`, puts them
    back (Keras restore_best_weights) and asks the loop to stop. save_best
    keeps a one-slot CheckpointManager under <ckpt_dir>/best and pins its
    RMSE in <ckpt_dir>/best_metric.json, which a resumed run must beat.

    Every rank keeps one (the eval RMSE is the same on each); a sharded
    run (tensor parallel or several processes) keeps no host copy and
    stops with the stop-step weights, as the JAX loop does."""

    def __init__(self, cfg: Config, capture=True):
        t = cfg.train
        self.capture = capture
        self.proc0 = multihost.process_index() == 0
        self.patience, self.min_delta = t.early_stop_patience, \
            t.early_stop_min_delta
        self.best_rmse, self.stale, self.snapshot = float("inf"), 0, None
        self.ckpt = self.metric_path = None
        if t.save_best:
            self.ckpt = CheckpointManager(os.path.join(t.ckpt_dir, "best"),
                                          max_to_keep=1)
            self.metric_path = os.path.join(t.ckpt_dir, "best_metric.json")
            if os.path.exists(self.metric_path):
                with open(self.metric_path) as f:
                    prior = json.load(f)
                self.best_rmse = float(prior["rmse"])
                log.info("save_best: resuming against prior best rmse %.4f "
                         "(step %d)", prior["rmse"], prior["step"])

    @property
    def active(self):
        return bool(self.patience) or self.ckpt is not None

    def update(self, state, step, rmse) -> bool:
        """Record one eval; True when the run should stop (the best params
        are then back in `state`)."""
        if rmse < self.best_rmse - self.min_delta:
            self.best_rmse, self.stale = rmse, 0
            if self.patience and self.capture:
                self.snapshot = (step, {k: v.detach().to("cpu", copy=True)
                                        for k, v in state.params.items()})
            if self.ckpt is not None:
                self.ckpt.save(step, state)
                if self.proc0:
                    with open(self.metric_path, "w") as f:
                        json.dump({"rmse": float(rmse), "step": step}, f)
            return False
        self.stale += 1
        if not self.patience or self.stale < self.patience:
            return False
        if self.snapshot is not None:
            best_step, params = self.snapshot
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(params[k])
            log.info("early stop at step %d: restored the best weights "
                     "(eval rmse %.4f at step %d); %d stale evals", step,
                     self.best_rmse, best_step, self.stale)
        else:
            log.info("early stop at step %d: eval rmse stuck at %.4f "
                     "(best %.4f) for %d evals (a prior run's best, or a "
                     "sharded run: stop-step weights kept)", step, rmse,
                     self.best_rmse, self.stale)
        return True


def _window_epochs(cfg: Config, dataset, dev, start_step, step_kwargs):
    """The echo factor of a window-pool run: cfg.data.window_epochs, or
    with 0 (`--window-epochs auto`) the factor persisted next to the
    checkpoints by the run being resumed, else a calibrated one (persisted
    for the resumes to come)."""
    t, window_epochs = cfg.train, cfg.data.window_epochs
    # The sampling stream depends on E, and calibration timing is not
    # deterministic: a resumed `auto` run that re-calibrated would
    # silently walk a different index stream, so the chosen factor is
    # persisted next to the checkpoints and reused on resume.
    epochs_path = os.path.join(t.ckpt_dir, "window_epochs.json")
    persisted = None
    if os.path.exists(epochs_path):
        with open(epochs_path) as f:
            persisted = json.load(f)
    if window_epochs == 0:  # --window-epochs auto
        if multihost.process_count() > 1:
            raise ValueError(
                "--window-epochs auto calibrates from process-local timings "
                "and would diverge across controllers; pass an explicit "
                "factor under --multihost")
        stale = (persisted is not None
                 and persisted.get("cache_window_mb")
                 != cfg.data.cache_window_mb)
        if persisted is not None and start_step > 0 and not stale:
            window_epochs = int(persisted["window_epochs"])
            log.info("--window-epochs auto: reusing echo factor x%d "
                     "calibrated by the original run (persisted in %s) — "
                     "recalibrating mid-run would change the sampling "
                     "stream", window_epochs, epochs_path)
            return window_epochs
        if stale and start_step > 0:
            log.warning(
                "--window-epochs auto: persisted factor in %s was "
                "calibrated for cache_window_mb=%s, this run uses %d — "
                "recalibrating (the factor is a function of the window "
                "size; the resumed sampling stream changes either way "
                "when the window changes)", epochs_path,
                persisted.get("cache_window_mb"), cfg.data.cache_window_mb)
        # Calibrate with the program the run replays: the plain train step
        # (a distilled run's step costs a few percent more: E is then
        # under-picked) on a throwaway state, through a BlockRunner on the
        # probe window (a K-step block replays that captured step K
        # times), or eagerly where the run steps eagerly.
        cal = create_state(cfg, dev)
        kw = {k: v for k, v in step_kwargs.items() if k != "distill_alpha"}
        generator = torch.Generator(device=dev)
        runner = None

        def cal_pass(probe, blocks):
            nonlocal runner
            if runner is None and dispatch.eager_reason(cal, dev) is None:
                runner = dispatch.BlockRunner(
                    cal, probe, 1, step_kwargs=kw,
                    draw_seed=lambda s: step_seed(t.seed, s))
            metrics = None
            for block in blocks:
                if runner is not None:
                    metrics = runner.run(block)
                else:
                    img, dep = probe.gather(block[0])
                    _, metrics = steplib.train_step(cal, img, dep, generator,
                                                    **kw)
            float(metrics["loss"])  # sync

        from ann3depth_tpu_torch.pipeline import streaming_pool
        window_epochs = streaming_pool.calibrate_window_epochs(
            dataset, t.batch_size, dev,
            window_bytes=cfg.data.cache_window_mb << 20, run_pass=cal_pass,
            steps_per_dispatch=t.steps_per_dispatch, seed=t.seed)
        del cal, runner
        with open(epochs_path, "w") as f:
            json.dump({"window_epochs": window_epochs,
                       "cache_window_mb": cfg.data.cache_window_mb,
                       "calibrated_at_step": start_step}, f)
    elif (persisted is not None and start_step > 0
            and int(persisted["window_epochs"]) != window_epochs):
        log.warning(
            "--window-epochs %d overrides the factor x%d the original "
            "(auto) run calibrated and persisted in %s — the resumed "
            "sampling stream will differ from the one the run would have "
            "continued", window_epochs, int(persisted["window_epochs"]),
            epochs_path)
    return window_epochs


def _make_feed(cfg: Config, dataset, extra_datasets, dev, start_step,
               n_steps, step_kwargs, mesh):
    """The run's feed: a device pool sampler (cache_device) holding this
    rank's shard, else host batches through a DeviceFeed (this rank's
    rows: the datasets are its shards already)."""
    t, d = cfg.train, cfg.data
    seed = t.seed + start_step
    shard = dict(rank=mesh.data_rank, nproc=mesh.n_data)
    if d.cache_device:
        # (exclusivity with use_grain/multi-dataset validated up top)
        if d.cache_window_mb:
            from ann3depth_tpu_torch.pipeline import streaming_pool
            window_epochs = _window_epochs(cfg, dataset, dev, start_step,
                                           step_kwargs)
            return streaming_pool.StreamingPoolSampler(
                dataset, t.batch_size, dev,
                window_bytes=d.cache_window_mb << 20,
                window_epochs=window_epochs, steps=n_steps, seed=seed,
                **shard)
        return device_cache.DevicePoolSampler(dataset, t.batch_size, dev,
                                              steps=n_steps, seed=seed,
                                              **shard)
    feed_batch = t.batch_size // mesh.n_data
    if d.use_grain:
        from ann3depth_tpu_torch.pipeline.grain_loader import grain_batches
        if extra_datasets:
            # Several datasets: round-robin whole batches from one loader
            # per source (steps bounds each, so the rotation never skips
            # an exhausted source).
            from ann3depth_tpu_torch.data.batching import round_robin
            host_iter = round_robin(
                [grain_batches(ds, feed_batch, steps=n_steps,
                               seed=seed + 17 * k,
                               num_workers=d.num_workers)
                 for k, ds in enumerate([dataset, *extra_datasets])],
                steps=n_steps)
        else:
            host_iter = grain_batches(dataset, feed_batch, steps=n_steps,
                                      seed=seed, num_workers=d.num_workers)
    elif extra_datasets:
        # Multi-dataset training: round-robin whole batches (each batch is
        # shape-uniform).
        from ann3depth_tpu_torch.data.batching import interleave_batches
        host_iter = interleave_batches([dataset, *extra_datasets],
                                       feed_batch, steps=n_steps,
                                       seed=seed)
    else:
        host_iter = dataset.batches(feed_batch, steps=n_steps, seed=seed)
    from ann3depth_tpu_torch.pipeline.feed import DeviceFeed
    return DeviceFeed(host_iter, device=dev, prefetch=d.prefetch)


def train(cfg: Config, *, workdir: Optional[str] = None, dataset=None,
          progress=True, device=None):
    """Run cfg.train.steps of training; returns (state, last_metrics).

    device: None -> the card ("cuda"); "cpu" runs the plain preprocess and
    the model on the CPU. With cfg.train.resume, restores the latest
    checkpoint from cfg.train.ckpt_dir and continues the step counter. An
    explicit `dataset` overrides the config's dataset list; otherwise every
    configured dataset trains, batch-interleaved.

    In a process group (parallel/multihost.py) every rank calls it: the run
    is data parallel over the ranks (module docstring), on the rank's
    device; rank 0 returns the metrics the others return too."""
    t = cfg.train
    nproc = multihost.process_count()
    proc0 = multihost.process_index() == 0
    if nproc > 1 and t.batch_size % nproc:
        raise ValueError(
            f"global batch_size={t.batch_size} is not divisible by "
            f"{nproc} processes")
    _validate(cfg)
    spd = t.steps_per_dispatch
    dev = multihost.local_device(resolve_device(device))
    mesh = meshlib.auto_data_mesh(t.batch_size // t.grad_accum,
                                  tp=t.tensor_parallel)
    workdir = workdir or t.ckpt_dir
    extra_datasets = []
    if dataset is None:
        dataset = build_dataset(cfg, "train")
        extra_datasets = [build_dataset(cfg, "train", name=n)
                          for n in cfg.data.datasets[1:]]
    if mesh.n_data > 1 and not cfg.data.cache_device:
        # Each rank reads its strided shard of every dataset (the device
        # pool stages its own shard of the whole dataset instead).
        from ann3depth_tpu_torch.data.batching import ProcessShardView
        dataset = ProcessShardView(dataset, mesh.data_rank, mesh.n_data)
        extra_datasets = [ProcessShardView(d, mesh.data_rank, mesh.n_data)
                          for d in extra_datasets]
    state = parallel_state(cfg, create_state(cfg, dev), mesh)
    teacher = restore_teacher(cfg, dev) if t.distill_from else None
    ckpt = CheckpointManager(t.ckpt_dir)
    state, start_step = _restore_for_resume(cfg, state, ckpt)
    # One cache for every in-loop eval: the steps, the restores and an
    # early stop write the params in place, so its graphs stay valid. Made
    # here, so that a run whose eval cannot be captured is refused before
    # its first step.
    eval_graphs = eval_stats_graphs(state, dev) if t.eval_every else None
    n_steps = t.steps - start_step
    if spd > 1 and n_steps % spd:
        # t.steps % spd == 0 is validated up top, so this only trips on a
        # resume from a checkpoint step that isn't block-aligned.
        raise ValueError(
            f"resume step {start_step} leaves {n_steps} steps, not a "
            f"multiple of steps_per_dispatch={spd}; resume from a block-"
            "aligned checkpoint or drop --steps-per-dispatch")

    step_kwargs = dict(input_hw=tuple(cfg.data.input_hw),
                       target_hw=resolved_target_hw(cfg),
                       si_lambda=t.si_lambda, augment=cfg.data.augment,
                       loss_kind=t.loss, ema_decay=t.ema_decay)
    if teacher is None:
        step_kwargs["grad_accum"] = t.grad_accum
    else:
        step_kwargs["distill_alpha"] = t.distill_alpha
    generator = multihost.replicated_key(t.seed, dev)
    feed = _make_feed(cfg, dataset, extra_datasets, dev, start_step,
                      n_steps, step_kwargs, mesh)
    # The step: replays of a CUDA graph of it (train/dispatch.py) wherever
    # it can be captured, eagerly elsewhere; decided before step 1.
    eager = dispatch.eager_reason(state, dev)
    runner = None
    if spd > 1 or eager is None:
        try:
            runner = dispatch.BlockRunner(
                state, feed if cfg.data.cache_device else None, spd,
                step_kwargs=step_kwargs, device=dev, teacher=teacher,
                draw_seed=lambda s: step_seed(t.seed, s))
        except BaseException:
            feed.close()
            raise
    note = _attention_note(state.model, cfg, mesh)
    if eager is None:
        log.info("train step: CUDA graph replays, %d a dispatch%s", spd,
                 note)
    else:
        log.info("train step: eager (%s)%s", eager, note)
    # Profiler window: skip a few warm steps, then trace profile_steps.
    # Units are DISPATCHES: with steps_per_dispatch > 1 each traced unit is
    # one K-step block (the first block is the eager warm-up and the
    # capture; the window starts at the first replayed block).
    n_iters = n_steps // spd
    prof_start = prof_stop = -1
    if t.profile_dir and proc0:
        prof_start = min(5 if spd == 1 else 1, max(0, n_iters - 1))
        prof_stop = min(prof_start + max(1, -(-t.profile_steps // spd)),
                        n_iters)
    # Metrics, TensorBoard and viz are rank 0's (every rank computes the
    # same metrics over the global batch; one writes).
    writer = MetricsWriter(workdir) if proc0 else None
    progress = progress and proc0
    tb = None
    if t.tensorboard and proc0:
        from ann3depth_tpu_torch.utils.tb_writer import TensorBoardWriter
        tb = TensorBoardWriter(os.path.join(workdir, "tb"))
    best = _BestTracker(cfg, capture=t.tensor_parallel == 1 and nproc == 1)
    profiler = None
    eval_ds = eval_pool = None
    metrics = {}
    t0, imgs_since = time.perf_counter(), 0
    try:
        pooled = runner is not None and runner.sampler is not None
        iterator = feed.index_blocks(spd) if pooled else feed
        for i, item in enumerate(iterator):
            if i == prof_start:
                tracing.device_sync(dev)  # drain the warm steps
                profiler = tracing.start_trace(dev)
            if runner is not None:
                metrics = runner.run(item, more=i + 1 < n_iters)
                step_no = start_step + (i + 1) * spd - 1
                imgs_since += (spd * t.batch_size if pooled else
                               int(item[0].shape[0]) * mesh.n_data)
            else:
                img_u8, depth = item
                step_no = start_step + i
                draws = None
                if cfg.data.augment:
                    generator.manual_seed(step_seed(t.seed, step_no))
                    if mesh.active():
                        draws = steplib.shard_draws(
                            generator, t.batch_size,
                            step_kwargs.get("grad_accum", 1), mesh,
                            device=dev)
                if teacher is None:
                    state, metrics = steplib.train_step(
                        state, img_u8, depth, generator, draws=draws,
                        **step_kwargs)
                else:
                    state, metrics = steplib.distill_train_step(
                        state, teacher, img_u8, depth, generator,
                        draws=draws, **step_kwargs)
                imgs_since += int(img_u8.shape[0]) * mesh.n_data
            if i + 1 == prof_stop and profiler is not None:
                tracing.device_sync(dev)  # capture the window's device work
                path = tracing.stop_trace(profiler, t.profile_dir)
                profiler = None
                log.info("profiler trace (%d dispatches) -> %s",
                         prof_stop - prof_start, path)
            is_last = i == n_iters - 1

            if (t.log_every and (step_no + 1) % t.log_every == 0) or is_last:
                metrics = {k: float(v) for k, v in metrics.items()}  # sync
                if not math.isfinite(metrics["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {metrics['loss']} at step "
                        f"{step_no + 1} (grad_norm={metrics['grad_norm']}); "
                        f"last good checkpoint is in {t.ckpt_dir} — "
                        "lower the learning rate or inspect the data batch")
                dt = time.perf_counter() - t0
                ips = imgs_since / dt if dt > 0 else 0.0
                if writer is not None:
                    writer.write(step_no + 1, metrics, images_per_sec=ips)
                if tb is not None:
                    tb.write_scalars(step_no + 1,
                                     {**metrics, "images_per_sec": ips})
                if progress:
                    log.info("step %d loss=%.4f rmse=%.3f %.1f img/s",
                             step_no + 1, metrics["loss"], metrics["rmse"],
                             ips)
                t0, imgs_since = time.perf_counter(), 0

            if t.eval_every and (step_no + 1) % t.eval_every == 0:
                if eval_ds is None:
                    eval_ds = build_dataset(cfg, "test")
                    if cfg.data.cache_device:
                        # The train pool is resident: the eval pool gets
                        # the REMAINING budget.
                        eval_pool, _ = _eval_pool(
                            eval_ds, t.batch_size, dev,
                            need=EVAL_SAMPLE_BATCHES, byte_budget=max(
                                0, device_cache.DEFAULT_BYTE_BUDGET
                                - getattr(feed, "nbytes", 0)), mesh=mesh)
                # stage_pool=False: THIS loop owns pooling; without an eval
                # pool the sample comes from the host feed.
                em = evaluate(cfg, state=state, dataset=eval_ds,
                              max_batches=EVAL_SAMPLE_BATCHES,
                              stage_pool=False, mesh=mesh,
                              stats_graphs=eval_graphs,
                              device_batches=(eval_pool.fixed_batches(
                                  EVAL_SAMPLE_BATCHES)
                                  if eval_pool else None))
                if writer is not None:
                    writer.write(step_no + 1,
                                 {**{f"eval_{k}": v for k, v in em.items()},
                                  "eval_batches": EVAL_SAMPLE_BATCHES})
                if tb is not None:
                    tb.write_scalars(step_no + 1,
                                     {f"eval/{k}": v for k, v in em.items()})
                if nproc == 1 and t.tensor_parallel == 1:
                    # viz runs a forward of its own: over several ranks it
                    # would need them all in lockstep for a debug image.
                    _write_viz(cfg, state, eval_ds, workdir, step_no + 1,
                               tb)
                if progress:
                    log.info("eval @%d rmse=%.3f abs_rel=%.3f", step_no + 1,
                             em["rmse"], em["abs_rel"])
                if best.active and best.update(state, step_no + 1,
                                               em["rmse"]):
                    ckpt.save(step_no + 1, state)
                    break
                t0, imgs_since = time.perf_counter(), 0

            if (t.checkpoint_every
                    and (step_no + 1) % t.checkpoint_every == 0) or is_last:
                ckpt.save(step_no + 1, state)
    finally:
        if profiler is not None:  # the loop left inside the window
            tracing.stop_trace(profiler, t.profile_dir)
        if eval_pool is not None:
            eval_pool.close()
        feed.close()
        if writer is not None:
            writer.close()
        if tb is not None:
            tb.close()
    return state, metrics


def predict_batch(cfg: Config, state, img_u8, depth):
    """(normalized imgs, resized depth, linear pred as numpy) of one raw
    batch on the model's device, for viz and eval tooling."""
    from ann3depth_tpu_torch.pipeline import preprocess

    images, depths = preprocess.preprocess_batch(
        img_u8, depth, cfg.data.input_hw, resolved_target_hw(cfg))
    with torch.inference_mode():
        pred_log = state.model(images)
    return images, depths, np.exp(pred_log[..., 0].cpu().numpy())


def _write_viz(cfg: Config, state, dataset, workdir, step, tb=None):
    """Render an (rgb | gt | pred) triple grid from the eval split (also
    into TensorBoard when `tb` is given)."""
    from ann3depth_tpu_torch.utils import viz

    img_np, dep_np = next(dataset.batches(min(4, cfg.train.batch_size),
                                          steps=1, shuffle=False))
    dev = next(state.model.parameters()).device
    images, depths, pred = predict_batch(cfg, state,
                                         torch.from_numpy(img_np).to(dev),
                                         torch.from_numpy(dep_np).to(dev))
    return viz.write_triple_summary(workdir, step, images.cpu().numpy(),
                                    depths.cpu().numpy(), pred, tb)


def _eval_pool(dataset, batch_size, dev, max_batches=None, need=1,
               byte_budget=None, mesh=None):
    """(pool, n): the split staged on the device for eval, with the number
    of batches to score (its full batches, at most max_batches); (None,
    None) with a log line where it cannot be staged within byte_budget
    (default the full device-cache budget) or holds fewer than `need`
    batches: the host feed runs instead, as in the JAX loop. On a mesh
    each rank stages its shard of the split (every rank decides alike)."""
    shard = ({} if mesh is None
             else dict(rank=mesh.data_rank, nproc=mesh.n_data))
    try:
        pool = device_cache.DevicePoolSampler(
            dataset, batch_size, dev, steps=0, seed=0,
            byte_budget=(device_cache.DEFAULT_BYTE_BUDGET
                         if byte_budget is None else byte_budget), **shard)
        n = pool.shard // pool.per_dev
        if n < need:
            pool.close()
            raise ValueError(f"eval split too small for a {need}-batch "
                             f"fixed sample at batch_size={batch_size}")
    except ValueError as e:
        log.info("eval uses the host feed (%s)", e)
        return None, None
    return pool, n if max_batches is None else min(n, max_batches)


def eval_stats_graphs(state, device):
    """`train.step.eval_stats_step` on `state` as a `GraphCache` on
    `device`: on the card one CUDA graph for each batch shape and set of
    eval options, captured at its first batch. The graphs hold the
    addresses of state's params, so they stay valid while the params are
    written in place (as every train step, restore and early stop does).

    Refused on the card when state's model axis reduces over gloo (a
    tensor-parallel run on the gloo backend): those all-reduces run on the
    host and cannot be captured."""
    mesh = state.mesh
    if (device.type == "cuda" and mesh is not None
            and mesh.active(meshlib.MODEL_AXIS)
            and multihost.backend() == "gloo"):
        raise ValueError(
            "eval captures its step in a CUDA graph, and the gloo backend's "
            "model-axis all-reduces (tensor_parallel) cannot be captured; "
            "run nccl (one process per card) or eval_every 0")

    def eval_stats(img_u8, depth, **kw):
        return steplib.eval_stats_step(state, img_u8, depth, **kw)

    return graphs.GraphCache(eval_stats, device=device)


def eval_report_graphs(state, device):
    """`train.step.eval_report_step` on `state` as a `GraphCache` on
    `device`: on the card one CUDA graph for each batch shape (a split's
    ragged last batch gets its own) and set of eval options. Its outputs
    (per-image stats, images, depths, pred_log) are static: the caller
    copies what it keeps before the next call."""
    def eval_report(img_u8, depth, **kw):
        return steplib.eval_report_step(state, img_u8, depth, **kw)

    return graphs.GraphCache(eval_report, device=device)


def evaluate(cfg: Config, state=None, dataset=None, max_batches=None,
             device=None, use_ema=False, report_dir=None, report_worst=8,
             ckpt_step=None, tta="", avg_last=None, align="", crop="",
             device_batches=None, stage_pool=True, mesh=None,
             stats_graphs=None):
    """Eval loop: sum the sufficient statistics of every batch of the test
    split (as device scalars, one host read at the end) and finalize once,
    so the dataset RMSE is over all valid pixels of the split.

    state None -> a fresh state on `device` with the params restored from
    cfg.train.ckpt_dir (`restore_state_for_eval`: the latest save, the save
    at ckpt_step, or the mean of the last avg_last saves; the EMA params
    with use_ema).

    tta="flip", align="median" and crop="eigen"|"garg" as in
    `train.step.eval_stats_step`, which runs through `stats_graphs`, an
    `eval_stats_graphs(state, ...)` cache (the training loop keeps one for
    all its evals; None makes one for this call): on the card one CUDA
    graph for each batch shape, captured at the first batch of that shape
    and replayed for the rest; on the CPU eagerly. Report mode runs
    `eval_report_step` alike, through an `eval_report_graphs` cache of its
    own.

    report_dir: also write per-image error attribution: per_image.jsonl
    (one metrics row per test image, split order), worst.png (a rgb|gt|pred
    triple grid of the report_worst highest-RMSE images) and summary.json.
    The dataset metrics then come from the same per-image statistics.

    device_batches: an iterable of (img_u8, depth) tensors ALREADY on the
    device (e.g. DevicePoolSampler.fixed_batches), in place of the host
    feed; the in-loop eval of a cache_device run scores from its eval pool
    this way. Exclusive with report_dir (the report ranks the full split
    in split order).

    cfg.data.cache_device (`eval --cache-device`, stage_pool=True): stages
    the test split on the device once and evaluates from the pool (the
    same examples in the same order as the host feed). Skipped, with a log
    line, under report_dir or for a split too small for one batch, where
    the host feed runs instead.

    Data parallel like training, on `mesh` (default: every rank of the
    process group): each rank scores its strided shard of the split at
    batch_size / n_data rows, over the batches every shard can fill, and
    the statistics are summed over the ranks and finalized once. No report
    and no staged test pool then (the in-loop eval passes its own pool's
    shard as device_batches)."""
    dataset = dataset or build_dataset(cfg, "test")
    if report_dir is not None and multihost.process_count() > 1:
        raise ValueError("eval report is single-process only (the full "
                         "split must rank in one place); run eval without "
                         "--multihost")
    if device_batches is not None and report_dir is not None:
        raise ValueError("device_batches is a fixed pool sample; the "
                         "report path needs the full split in split order")
    batch_size = cfg.train.batch_size
    if mesh is None:
        mesh = meshlib.auto_data_mesh(batch_size)
    n_data = mesh.n_data
    if n_data > 1:
        # Every rank must run the SAME number of batches: bound by the
        # smallest shard (len // n_data examples).
        from ann3depth_tpu_torch.data.batching import ProcessShardView
        if batch_size % n_data:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"{n_data} processes")
        batch_size //= n_data
        common = (len(dataset) // n_data) // batch_size
        max_batches = (common if max_batches is None
                       else min(max_batches, common))
        dataset = ProcessShardView(dataset, mesh.data_rank, n_data)
    if state is None:
        state = restore_state_for_eval(cfg, use_ema=use_ema,
                                       ckpt_step=ckpt_step,
                                       avg_last=avg_last, device=device)
    dev = next(state.model.parameters()).device
    step_kw = dict(input_hw=tuple(cfg.data.input_hw),
                   target_hw=resolved_target_hw(cfg),
                   si_lambda=cfg.train.si_lambda, loss_kind=cfg.train.loss,
                   tta=tta, align=align, crop=crop)
    own_pool = None
    if device_batches is None and cfg.data.cache_device and stage_pool:
        if report_dir is not None or n_data > 1:
            log.info("eval --cache-device skipped: %s needs the host feed "
                     "(full split in split order / per-process shards)",
                     "report_dir" if report_dir is not None else "multihost")
        else:
            own_pool, n_b = _eval_pool(dataset, batch_size, dev,
                                       max_batches)
            if own_pool is not None:
                device_batches = own_pool.fixed_batches(n_b)
    if device_batches is not None:
        batch_iter = iter(device_batches)
    else:  # host tensors: the graph's static inputs are their H2D copies
        batch_iter = ((torch.from_numpy(img_np), torch.from_numpy(dep_np))
                      for img_np, dep_np in dataset.batches(
                          batch_size, steps=max_batches, shuffle=False))
    if report_dir is not None:
        report_graphs = eval_report_graphs(state, dev)
    elif stats_graphs is None:
        stats_graphs = eval_stats_graphs(state, dev)
    totals = {}
    rows, worst = [], []  # report mode: per-image rows + worst-K heap
    for b, (img_u8, depth) in enumerate(batch_iter):
        if report_dir is None:
            stats = stats_graphs(img_u8, depth, **step_kw)
            # the sums are new tensors: the next replay overwrites `stats`
            for k, v in stats.items():
                totals[k] = totals[k] + v if k in totals else v.clone()
        else:
            # the static outputs: every read below copies them to the host
            # before the next replay
            per, images, depths, pred_log = report_graphs(img_u8, depth,
                                                          **step_kw)
            per = {k: v.cpu().numpy() for k, v in per.items()}
            bsz = per["n_valid"].shape[0]
            batch_tot = {k: float(v.sum()) for k, v in per.items()
                         if k != "si_loss"}
            batch_tot["n_images"] = float(bsz)
            batch_tot["sum_si_loss"] = float(per["si_loss"].sum())
            for k, v in batch_tot.items():
                totals[k] = totals.get(k, 0.0) + v
            fin = losses.finalize_depth_metrics(
                {**{k: v for k, v in per.items() if k != "si_loss"},
                 "sum_si_loss": per["si_loss"],
                 "n_images": np.ones(bsz, np.float32)})
            for i in range(bsz):
                idx = b * batch_size + i
                rows.append({"index": idx,
                             **{k: float(v[i]) for k, v in fin.items()}})
                r = float(fin["rmse"][i])
                if report_worst > 0 and (len(worst) < report_worst
                                         or r > worst[0][0]):
                    payload = (images[i].cpu().numpy(),
                               depths[i].cpu().numpy(),
                               np.exp(pred_log[i].cpu().numpy()[..., 0]))
                    heapq.heappush(worst, (r, idx, payload))
                    if len(worst) > report_worst:
                        heapq.heappop(worst)
        if max_batches is not None and b + 1 >= max_batches:
            break
    if not totals:
        raise ValueError("eval split yielded no batches")
    if mesh.active():
        keys = sorted(totals)
        summed = mesh.all_reduce(torch.stack(
            [torch.as_tensor(totals[k], dtype=torch.float32, device=dev)
             for k in keys]))
        totals = dict(zip(keys, summed))
    metrics = losses.finalize_depth_metrics(
        {k: float(v) for k, v in totals.items()})
    if own_pool is not None:
        own_pool.close()
    if report_dir is not None:
        _write_eval_report(report_dir, rows, worst, metrics)
    return metrics


def restore_state_for_eval(cfg: Config, use_ema=False, ckpt_step=None,
                           avg_last=None, device=None):
    """A state on `device` (default the card) with params restored once
    from cfg.train.ckpt_dir, for the eval-family consumers (shared by
    multi-dataset and multi-protocol eval). In a process group, `device`
    "cuda" is the rank's card."""
    state = create_state(cfg, multihost.local_device(resolve_device(device)))
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    if avg_last:
        if ckpt_step is not None:
            raise ValueError("avg_last and ckpt_step are exclusive "
                             "(the average spans the last k saves)")
        state, restored = ckpt.restore_avg_params(state, avg_last,
                                                  use_ema=use_ema)
    else:
        state, restored = ckpt.restore_params(state, use_ema=use_ema,
                                              step=ckpt_step)
    if restored is None:
        raise RuntimeError(f"no checkpoint in {cfg.train.ckpt_dir}")
    return state


def evaluate_protocols(cfg: Config, protocols, *, state=None, use_ema=False,
                       ckpt_step=None, avg_last=None, max_batches=None,
                       tta="flip", align="median", crop="eigen",
                       dataset=None, device=None):
    """Score several eval-protocol variants from one restored checkpoint.

    protocols: tokens, 'plain' or '+'-joined subsets of {'tta', 'align',
    'crop'} (e.g. 'tta', 'tta+align+crop'); the tta/align/crop arguments
    supply each component's value when present. Returns {token: metrics
    dict}. No report_dir (one report per variant would be ambiguous)."""
    if not protocols:
        raise ValueError("protocols must be a non-empty list of tokens")
    parsed = {}
    for token in protocols:
        parts = frozenset() if token == "plain" else frozenset(
            token.split("+"))
        unknown = parts - {"tta", "align", "crop"}
        if unknown:
            raise ValueError(
                f"unknown protocol component(s) {sorted(unknown)} in "
                f"{token!r}; tokens are 'plain' or '+'-joined subsets of "
                "tta|align|crop")
        parsed[token] = parts
    dataset = dataset or build_dataset(cfg, "test")
    if state is None:
        state = restore_state_for_eval(cfg, use_ema=use_ema,
                                       ckpt_step=ckpt_step,
                                       avg_last=avg_last, device=device)
    # cache_device: ONE staged test pool shared by every variant.
    pool = n_b = None
    if cfg.data.cache_device and multihost.process_count() == 1:
        pool, n_b = _eval_pool(dataset, cfg.train.batch_size,
                               next(state.model.parameters()).device,
                               max_batches)
    try:
        return {token: evaluate(
                    cfg, state=state, dataset=dataset,
                    max_batches=max_batches, stage_pool=False,
                    tta=tta if "tta" in parts else "",
                    align=align if "align" in parts else "",
                    crop=crop if "crop" in parts else "",
                    device_batches=pool.fixed_batches(n_b) if pool else None)
                for token, parts in parsed.items()}
    finally:
        if pool is not None:
            pool.close()


def _write_eval_report(report_dir, rows, worst, metrics):
    """per_image.jsonl + worst.png triple grid + summary.json."""
    from ann3depth_tpu_torch.utils import viz

    os.makedirs(report_dir, exist_ok=True)
    with open(os.path.join(report_dir, "per_image.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    ranked = sorted(worst, key=lambda t: -t[0])  # worst first
    if ranked:
        imgs = np.stack([p[0] for _, _, p in ranked])
        gts = np.stack([p[1] for _, _, p in ranked])
        preds = np.stack([p[2] for _, _, p in ranked])
        grid = viz.triple_grid(imgs, gts, preds, max_rows=len(ranked))
        viz.save_png(os.path.join(report_dir, "worst.png"), grid)
    with open(os.path.join(report_dir, "summary.json"), "w") as f:
        json.dump({"metrics": metrics, "images": len(rows),
                   "worst": [{"index": idx, "rmse": r}
                             for r, idx, _ in ranked]}, f, indent=2)
    log.info("eval report: %d images -> %s (worst %d rendered)",
             len(rows), report_dir, len(ranked))
