"""Training driver and eval loop of the port, single device.

Counterpart of the plain single-device path of `ann3depth_tpu/train/loop.py`
(`build_dataset`, `resolved_target_hw`, `create_state`, `train`, and the
sufficient-statistics path of `evaluate`): host batches go to the device,
then `train_step`; metrics are read and logged every `log_every` steps,
checkpoints written every `checkpoint_every`, a 4-batch eval sample scored
every `eval_every`, and `resume` continues the step counter from the
latest checkpoint.

Every option of the JAX loop outside this path raises NotImplementedError
("not ported yet") instead of being ignored.
"""

from __future__ import annotations

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
from ann3depth_tpu_torch.train import losses
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.train.checkpoint import CheckpointManager
from ann3depth_tpu_torch.utils.metrics_writer import MetricsWriter

log = logging.getLogger(__name__)

EVAL_SAMPLE_BATCHES = 4  # in-loop eval is a sample, not the full split


def build_dataset(cfg: Config, split="train", name=None):
    """Dataset factory: name -> raw (uint8 rgb, f32 depth) example source."""
    name = name or cfg.data.datasets[0]
    if name == "synthetic":
        from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
        train = split == "train"
        return SyntheticDepthDataset(
            n=cfg.data.synth_n if train else cfg.data.synth_test_n,
            img_hw=tuple(cfg.data.synth_img_hw),
            depth_hw=tuple(cfg.data.synth_depth_hw),
            seed=0 if train else 1)
    if os.path.exists(os.path.join(cfg.data.data_dir, "records",
                                   f"{name}-{split}-index.json")):
        raise NotImplementedError(
            f"packed records ({name}-{split}) are not ported yet; the JAX "
            "loop would read them in place of the raw files")
    if name == "make3d":
        from ann3depth_tpu_torch.data.make3d import Make3DDataset
        return Make3DDataset(cfg.data.data_dir, split=split)
    if name == "nyu":
        raise NotImplementedError("the nyu loader is not ported yet")
    raise KeyError(f"unknown dataset {name!r}")


def resolved_target_hw(cfg: Config):
    """Depth-target resolution from the model's output stride."""
    return registry.output_hw(cfg.model.name, cfg.data.input_hw)


def create_state(cfg: Config, device=None):
    """Model (initialized from cfg.train.seed) + update rule + TrainState."""
    model = steplib.init_params(registry.build(cfg.model), cfg.train.seed,
                                device=device)
    tx = steplib.make_optimizer(
        cfg.train.learning_rate, cfg.train.warmup_steps, cfg.train.steps,
        b1=cfg.train.adam_b1, b2=cfg.train.adam_b2,
        weight_decay=cfg.train.weight_decay, clip_norm=cfg.train.clip_norm,
        optimizer=cfg.train.optimizer, schedule=cfg.train.schedule)
    return steplib.TrainState.create(model, tx, ema=cfg.train.ema_decay > 0)


def _check_ported(cfg: Config):
    """Raise for every option of the JAX loop that the port lacks."""
    t, d = cfg.train, cfg.data
    not_ported = [
        ("zero1", t.zero1), ("tensor_parallel > 1", t.tensor_parallel > 1),
        ("grad_accum > 1", t.grad_accum > 1),
        ("distill_from", bool(t.distill_from)),
        ("cache_device", d.cache_device),
        ("cache_window_mb", bool(d.cache_window_mb)),
        ("window_epochs != 1", d.window_epochs != 1),
        ("use_grain", d.use_grain or d.num_workers > 0),
        ("steps_per_dispatch > 1", t.steps_per_dispatch > 1),
        (f"quant={cfg.model.quant!r}", cfg.model.quant == "int8-qat"),
        ("profile_dir", bool(t.profile_dir)), ("tensorboard", t.tensorboard),
        ("early_stop_patience", t.early_stop_patience > 0),
        ("save_best", t.save_best), ("resume_step", t.resume_step is not None),
        ("more than one dataset", len(d.datasets) > 1),
    ]
    missing = [name for name, on in not_ported if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not ported yet (the port trains the "
            "plain single-device path)")


def _validate(cfg: Config):
    if cfg.model.quant not in ("none", "int8-qat"):
        raise ValueError(
            f"model.quant={cfg.model.quant!r} is a serving-only path "
            "(round() has zero gradient); train with quant='none'")
    if cfg.train.batch_size <= 0:
        raise ValueError(
            f"batch_size must be positive, got {cfg.train.batch_size}")
    if cfg.train.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.train.grad_accum}")
    for name in ("log_every", "checkpoint_every", "eval_every"):
        if getattr(cfg.train, name) < 0:
            raise ValueError(
                f"{name} must be >= 0 (0 disables the periodic cadence; "
                f"the final step still logs/saves), got "
                f"{getattr(cfg.train, name)}")
    _check_ported(cfg)


def step_seed(seed: int, step: int) -> int:
    """The augmentation seed of one step, a function of (seed, step) alone
    as the JAX step's fold_in(rng, step) is, so a resumed run draws what
    the uninterrupted run would have."""
    return int(np.random.SeedSequence((seed, step)).generate_state(
        1, np.uint64)[0])


def train(cfg: Config, *, workdir: Optional[str] = None, dataset=None,
          progress=True, device=None):
    """Run cfg.train.steps of training; returns (state, last_metrics).

    device: None -> the card ("cuda"); "cpu" runs the plain preprocess and
    the model on the CPU. With cfg.train.resume, restores the latest
    checkpoint from cfg.train.ckpt_dir and continues the step counter."""
    _validate(cfg)
    dev = resolve_device(device)
    workdir = workdir or cfg.train.ckpt_dir
    if dataset is None:
        dataset = build_dataset(cfg, "train")
    state = create_state(cfg, dev)
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    start_step = 0
    if cfg.train.resume:
        state, restored = ckpt.restore(state)
        if restored is not None:
            start_step = state.step
            log.info("resumed from checkpoint at step %d", start_step)

    step_kwargs = dict(input_hw=tuple(cfg.data.input_hw),
                       target_hw=resolved_target_hw(cfg),
                       si_lambda=cfg.train.si_lambda,
                       augment=cfg.data.augment, loss_kind=cfg.train.loss,
                       ema_decay=cfg.train.ema_decay)
    generator = torch.Generator(device=dev)
    n_steps = cfg.train.steps - start_step
    host_iter = dataset.batches(cfg.train.batch_size, steps=n_steps,
                                seed=cfg.train.seed + start_step)
    writer = MetricsWriter(workdir)
    eval_ds = None
    metrics = {}
    t0, imgs_since = time.perf_counter(), 0
    try:
        for i, (img_np, dep_np) in enumerate(host_iter):
            step_no = start_step + i
            img_u8 = torch.from_numpy(img_np).to(dev)
            depth = torch.from_numpy(dep_np).to(dev)
            if cfg.data.augment:
                generator.manual_seed(step_seed(cfg.train.seed, step_no))
            state, metrics = steplib.train_step(state, img_u8, depth,
                                                generator, **step_kwargs)
            imgs_since += int(img_u8.shape[0])
            is_last = i == n_steps - 1

            if (cfg.train.log_every
                    and (step_no + 1) % cfg.train.log_every == 0) or is_last:
                metrics = {k: float(v) for k, v in metrics.items()}  # sync
                if not math.isfinite(metrics["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {metrics['loss']} at step "
                        f"{step_no + 1} (grad_norm={metrics['grad_norm']}); "
                        f"last good checkpoint is in {cfg.train.ckpt_dir} — "
                        "lower the learning rate or inspect the data batch")
                dt = time.perf_counter() - t0
                ips = imgs_since / dt if dt > 0 else 0.0
                writer.write(step_no + 1, metrics, images_per_sec=ips)
                if progress:
                    log.info("step %d loss=%.4f rmse=%.3f %.1f img/s",
                             step_no + 1, metrics["loss"], metrics["rmse"],
                             ips)
                t0, imgs_since = time.perf_counter(), 0

            if (cfg.train.eval_every
                    and (step_no + 1) % cfg.train.eval_every == 0):
                if eval_ds is None:
                    eval_ds = build_dataset(cfg, "test")
                em = evaluate(cfg, state=state, dataset=eval_ds,
                              max_batches=EVAL_SAMPLE_BATCHES)
                writer.write(step_no + 1,
                             {**{f"eval_{k}": v for k, v in em.items()},
                              "eval_batches": EVAL_SAMPLE_BATCHES})
                if progress:
                    log.info("eval @%d rmse=%.3f abs_rel=%.3f", step_no + 1,
                             em["rmse"], em["abs_rel"])
                t0, imgs_since = time.perf_counter(), 0

            if (cfg.train.checkpoint_every
                    and (step_no + 1) % cfg.train.checkpoint_every == 0
                    ) or is_last:
                ckpt.save(step_no + 1, state)
    finally:
        writer.close()
    return state, metrics


def evaluate(cfg: Config, state=None, dataset=None, max_batches=None,
             device=None, tta="", align="", crop=""):
    """Eval loop: sum the sufficient statistics of every batch of the test
    split (as device scalars, one host read at the end) and finalize once,
    so the dataset RMSE is over all valid pixels of the split.

    state None -> a fresh state on `device` with the params of the latest
    checkpoint in cfg.train.ckpt_dir."""
    dataset = dataset or build_dataset(cfg, "test")
    if state is None:
        state = create_state(cfg, resolve_device(device))
        ckpt = CheckpointManager(cfg.train.ckpt_dir)
        state, restored = ckpt.restore_params(state)
        if restored is None:
            raise RuntimeError(f"no checkpoint in {cfg.train.ckpt_dir}")
    dev = next(state.model.parameters()).device
    step_kw = dict(input_hw=tuple(cfg.data.input_hw),
                   target_hw=resolved_target_hw(cfg),
                   si_lambda=cfg.train.si_lambda, loss_kind=cfg.train.loss,
                   tta=tta, align=align, crop=crop)
    totals = {}
    for b, (img_np, dep_np) in enumerate(dataset.batches(
            cfg.train.batch_size, steps=max_batches, shuffle=False)):
        stats = steplib.eval_stats_step(
            state, torch.from_numpy(img_np).to(dev),
            torch.from_numpy(dep_np).to(dev), **step_kw)
        for k, v in stats.items():
            totals[k] = totals[k] + v if k in totals else v
        if max_batches is not None and b + 1 >= max_batches:
            break
    if not totals:
        raise ValueError("eval split yielded no batches")
    return losses.finalize_depth_metrics(
        {k: float(v) for k, v in totals.items()})
