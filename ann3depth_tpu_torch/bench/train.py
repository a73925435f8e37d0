"""Training-throughput benchmark: train images/s of the fused train step.

Counterpart of `benchmarks/bench_train.py`: the steady-state train step of
a Config on synthetic data from a device-resident pool (no host data, no
H2D copy), so the number is the device pipeline's.

Primary measurement: blocks of K steps through `train/dispatch.BlockRunner`,
the CUDA graph of one step that `--steps-per-dispatch K` replays. The JAX
bench's scan of K steps in one program becomes K replays of the captured
step a block, on a fresh state. Eager `train_step` calls are reported beside
it (`images_per_sec_dispatched`); each pays several hundred kernel
launches, so they time the host.

The result carries the JAX bench's keys (its `stage_s` names the graph
blocks "scan" as the JAX bench names its scan program). Two differences:

- It writes no `benchmarks/results.jsonl`: the printed line is the record.
- It adds no `mfu_note` at grad_accum > 1. FlopCounterMode counts every
  microbatch of the step, where XLA's cost analysis counted the scan body
  once, so the MFU needs no correction.

On the CPU there is no graph: each block runs the slot step K times eagerly.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ann3depth_tpu_torch.device import resolve_device
from ann3depth_tpu_torch.train import loop as looplib
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.train.dispatch import BlockRunner
from ann3depth_tpu_torch.utils import flops as flopslib
from ann3depth_tpu_torch.utils.tracing import device_sync

POOL_ENTRIES = 4
POOL_SEED = 17


class _Pool:
    """The pool as `BlockRunner` reads a sampler: `pool_img`/`pool_dep`
    with the entries' rows one after another, `per_dev`, `batch_size` and
    `device`."""

    def __init__(self, img, dep):
        n, b = img.shape[:2]
        self.pool_img = img.view(n * b, *img.shape[2:])
        self.pool_dep = dep.view(n * b, *dep.shape[2:])
        self.per_dev = self.batch_size = b
        self.device = img.device

    def block(self, k):
        """[k, B] index rows of k steps, step j reading entry j % n, as the
        JAX bench's scan indexes its pool."""
        b = self.batch_size
        n = self.pool_img.shape[0] // b
        entry = torch.arange(k, device=self.device) % n
        return entry[:, None] * b + torch.arange(b, device=self.device)


def make_pool(b, raw_hw, device):
    """uint8 frames [4, b, *raw_hw, 3] and f32 depth U(1, 60) at raw_hw // 10,
    drawn on `device` from a generator seeded POOL_SEED."""
    gen = torch.Generator(device=device).manual_seed(POOL_SEED)
    h, w = raw_hw
    img = torch.randint(0, 256, (POOL_ENTRIES, b, h, w, 3), dtype=torch.uint8,
                        generator=gen, device=device)
    dep = torch.empty((POOL_ENTRIES, b, h // 10, w // 10),
                      device=device).uniform_(1.0, 60.0, generator=gen)
    return img, dep


def step_kwargs(cfg) -> dict:
    """The train step's keyword arguments, the JAX bench's: augmented, at
    cfg's shapes, loss weight, accumulation and EMA."""
    return dict(input_hw=tuple(cfg.data.input_hw),
                target_hw=looplib.resolved_target_hw(cfg),
                si_lambda=cfg.train.si_lambda, augment=True,
                grad_accum=cfg.train.grad_accum,
                ema_decay=cfg.train.ema_decay)


def run(cfg, steps: int = 100, warmup: int = 10, raw_hw=(480, 640),
        device=None) -> dict:
    """Images/s and ms a step of cfg's train step at its batch on frames of
    `raw_hw`: `min(steps, 100)` eager steps after `warmup`, then blocks of
    K = max(20, min(steps, 50)) graph steps, two warm and max(1, steps // K)
    timed."""
    t_start = time.perf_counter()
    stages = {}

    def mark(name):
        stages[name] = round(time.perf_counter() - t_start, 1)
        if os.environ.get("BENCH_DEBUG"):
            print(f"[bench_train +{stages[name]:7.1f}s] {name}",
                  file=sys.stderr, flush=True)

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    b = cfg.train.batch_size
    seed = cfg.train.seed
    state = looplib.create_state(cfg, dev)
    img, dep = make_pool(b, raw_hw, dev)
    pool = [(img[i], dep[i]) for i in range(POOL_ENTRIES)]
    kw = step_kwargs(cfg)
    gen = torch.Generator(device=dev)

    def eager_step(i):
        nonlocal state
        gen.manual_seed(looplib.step_seed(seed, state.step))
        state, m = steplib.train_step(state, *pool[i % POOL_ENTRIES], gen,
                                      **kw)
        return m

    mark("setup_done")
    # FlopCounterMode runs the step it counts: it is the first warm step
    # of the eager state, never a step of the state the graph times.
    gen.manual_seed(looplib.step_seed(seed, state.step))
    step_fl = flopslib.step_flops(steplib.train_step, state, *pool[0], gen,
                                  **kw)
    mark("flops_done")

    # --- eager steps (secondary: each pays the host's launches) ---
    d_steps = min(steps, 100)
    for i in range(1, warmup):
        metrics = eager_step(i)
    device_sync(dev)
    mark("dispatched_warm_done")
    t0 = time.perf_counter()
    for i in range(d_steps):
        metrics = eager_step(i)
    loss = float(metrics["loss"])
    dt_dispatched = time.perf_counter() - t0
    mark("dispatched_done")
    del state, metrics

    # --- K-step blocks of the captured step (primary) ---
    k = max(20, min(steps, 50))
    sampler = _Pool(img, dep)
    block = sampler.block(k)
    runner = BlockRunner(looplib.create_state(cfg, dev), sampler, k,
                         step_kwargs=kw,
                         draw_seed=lambda s: looplib.step_seed(seed, s))
    for _ in range(2):  # the first runs eagerly and captures the step
        out = runner.run(block)
    float(out["loss"])
    mark("scan_warm_done")
    reps = max(1, steps // k)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = runner.run(block)
    loss_scan = float(out["loss"])
    dt_scan = time.perf_counter() - t0
    mark("scan_done")
    scan_steps_total = reps * k

    result = {
        "bench": "train_throughput",
        "model": cfg.model.name,
        "quant": cfg.model.quant,
        "batch_size": b,
        "input_hw": list(cfg.data.input_hw),
        "backend": dev.type,
        "n_devices": 1,
        "images_per_sec": round(b * scan_steps_total / dt_scan, 2),
        "step_ms": round(dt_scan / scan_steps_total * 1e3, 3),
        "images_per_sec_dispatched": round(b * d_steps / dt_dispatched, 2),
        "step_ms_dispatched": round(dt_dispatched / d_steps * 1e3, 3),
        "final_loss": loss if loss == loss else loss_scan,
        "stage_s": stages,
        "time": time.time(),
    }
    if loss_scan != loss_scan:
        raise FloatingPointError("NaN loss in the graph benchmark")
    flopslib.attach_mfu(result, step_fl, scan_steps_total, dt_scan,
                        device=dev)
    flopslib.attach_memory(result, dev)
    return result
