#!/usr/bin/env python3
"""Time one checkout's train step on the card, on chip_smoke.py's phase 4
yardstick, and measure how far two runs of one feed part.

    python3 probe_train_step.py [--root DIR] [--preset make3d-encdec]

Builds the preset's model at full width from its seed in the package under
DIR (default: this checkout) and, on one device-resident batch at the
preset's batch size (raw 480x640 frames, depth at Make3D's 305x55 grid or
NYU's 480x640, augmented), times `train_step`: wall time per step after a
warm-up (`--iters` steps between two synchronizations), the card's busy
time a step and its kernels (torch.profiler, `chip_smoke.device_profile`)
and the peak memory. Then runs `--steps` steps twice from one state and
one feed, in the default (nondeterministic-allowed) mode, and reports the
largest relative difference of the two loss curves. Two checkouts compare
on one card when both are timed back to back, e.g. parent, change, change,
parent.

Prints one JSON line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The timers are this checkout's; import them before DIR goes on the path.
from chip_smoke import card_line, device_profile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose ann3depth_tpu_torch is timed")
    ap.add_argument("--preset", default="make3d-encdec")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_train_step: no CUDA device")
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib

    if not os.path.abspath(loop.__file__).startswith(root + os.sep):
        raise SystemExit(f"probe_train_step: imported {loop.__file__}, "
                         f"not the package under {root}")
    cfg = get_config(args.preset)
    dev = torch.device("cuda")
    b = cfg.train.batch_size
    depth_hw = (480, 640) if "nyu" in cfg.data.datasets else (305, 55)
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.randint(0, 256, (b, 480, 640, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    dep = 1.0 + 50.0 * torch.rand((b, *depth_hw), device=dev, generator=gen)
    kw = dict(input_hw=tuple(cfg.data.input_hw),
              target_hw=loop.resolved_target_hw(cfg), augment=True)

    state = loop.create_state(cfg, dev)
    draws = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        steplib.train_step(state, img, dep, draws, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        steplib.train_step(state, img, dep, draws, **kw)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.iters * 1e3
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(
        torch, lambda: steplib.train_step(state, img, dep, draws, **kw), 5,
        step_ms)

    curves = []
    for _ in range(2):
        state = loop.create_state(cfg, dev)
        losses = []
        for i in range(args.steps):
            draws.manual_seed(100 + i)
            state, m = steplib.train_step(state, img, dep, draws, **kw)
            losses.append(m["loss"])
        curves.append(torch.stack(losses).float().cpu())
    a, c = curves
    print(json.dumps(dict(
        root=root, preset=args.preset, batch=b, step_ms=step_ms,
        images_per_s=b / step_ms * 1e3, max_memory_allocated_bytes=peak,
        device_profile=profile or "not measured: no kernel in the trace",
        double_run_steps=args.steps,
        double_run_bitwise_equal=bool(torch.equal(a, c)),
        double_run_max_rel_spread=float(((a - c).abs() / c.abs()).max()),
        double_run_last_losses=[float(a[-1]), float(c[-1])])), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
