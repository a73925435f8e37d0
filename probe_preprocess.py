#!/usr/bin/env python3
"""Time one checkout's preprocess wrappers on the card, on the yardsticks
of chip_smoke.py.

    python3 probe_preprocess.py [--root DIR] [--tile-rows 4,6,8,12]

Times `fused_preprocess` and `fused_preprocess_v2` of the package under DIR
(default: this checkout) through their public wrappers, at the shapes of
the main path: the train shape (u8 [16,480,640,3] -> [240,320], augment
rows), serving b32 (identity rows) and the eval depth grid (f32
[16,305,55,1] -> [120,160]). For each: the device time per call from
torch.profiler, by kernel (`chip_smoke.device_ms`); a loop of calls timed
with CUDA events (`chip_smoke.time_ms`, the host's gaps included); and the
host time per call (`chip_smoke.host_ms`). Whatever a wrapper launches is
counted, operand builds included, so two checkouts of different designs
compare on one card when both run in one session, e.g. parent, change,
change, parent.

--tile-rows also times this checkout's kernels (device time) at other
tile sizes: output rows a block owns, where the wrappers launch
`fused_preprocess.TILE_ROWS`.

Prints one JSON line per (kernel, tile size) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# The timers are this checkout's; import them before DIR goes on the path.
from chip_smoke import card_line, device_ms, host_ms, time_ms

KERNELS = ("fused_preprocess", "fused_preprocess_v2")


def _top(by_kind, n=6):
    return dict(sorted(by_kind.items(), key=lambda kv: -kv[1])[:n])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose ann3depth_tpu_torch is timed")
    ap.add_argument("--tile-rows", default="",
                    help="comma-separated tile sizes (this checkout only)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_preprocess: no CUDA device")
    from ann3depth_tpu_torch.ops import fused_preprocess as fp

    if not os.path.abspath(fp.__file__).startswith(root + os.sep):
        raise SystemExit(f"probe_preprocess: imported {fp.__file__}, "
                         f"not the package under {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (32, 480, 640, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    depth = 1.0 + 59.0 * torch.rand((16, 305, 55, 1), device=dev,
                                    generator=gen)
    depth[:, ::7, ::5] = 0.0
    cases = {
        "train": (frames[:16], fp.augment_params(gen, 16, (480, 640),
                                                 (240, 320), device=dev),
                  (240, 320), False),
        "serve_b32": (frames, fp.identity_params(32, (480, 640), (240, 320),
                                                 device=dev),
                      (240, 320), False),
        "eval_depth": (depth, fp.identity_params(16, (305, 55), (120, 160),
                                                 device=dev),
                       (120, 160), True),
    }
    tiles = [int(t) for t in args.tile_rows.split(",") if t]
    if tiles and not hasattr(fp, "_launch_band"):
        raise SystemExit("probe_preprocess: --tile-rows needs the banded "
                         "kernels")
    for name in KERNELS:
        wrapper = getattr(fp, name)
        row = dict(root=root, kernel=name, tile_rows="default")
        for case, (x, params, out_hw, depth_mode) in cases.items():
            def call():
                return wrapper(x, params, out_hw=out_hw,
                               depth_mode=depth_mode)
            ms, by_kind = device_ms(torch, call)
            row[case] = dict(ms=ms, by_kernel=_top(by_kind),
                             event_ms=time_ms(call),
                             host_ms=host_ms(torch, call))
        print(json.dumps(row), flush=True)
        for tile_rows in tiles:
            row = dict(root=root, kernel=name, tile_rows=tile_rows)
            for case, (x, params, out_hw, depth_mode) in cases.items():
                plan = fp.launch_plan(tuple(x.shape), out_hw,
                                      itemsize=x.element_size(),
                                      depth_mode=depth_mode,
                                      tile_rows=tile_rows)
                ms, by_kind = device_ms(torch, lambda: fp._launch_band(
                    name, x, params, out_hw=out_hw, depth_mode=depth_mode,
                    plan=plan))
                row[case] = dict(ms=ms, by_kernel=_top(by_kind),
                                 smem_bytes=plan.smem_bytes)
            print(json.dumps(row), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
