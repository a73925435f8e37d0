"""Run one cell of the benchmark once.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's traffic
names its mode (modes/<mode>.py), which sets the program up from the
seed, measures for `--seconds`, and checks what the timed path produced
against the plain reference. With `--trace 0` the last line of standard
output holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics (each read by metrics/<name>.py), as one JSON object:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "checks"}

`checks` holds each number that `correct` compares with its limit; the
same numbers are the last lines of standard error. A run exits non-zero
and prints no result when the card or the cards the cell needs are
missing, or when JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ann3depth_tpu")


@dataclasses.dataclass
class RunContext:
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def require_devices(chips: int):
    """The first card; exits with code 2 when fewer than `chips` cards are
    present (a measurement never falls back to the CPU)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def cache_dirs(root: Path):
    """Fixed cache directories inside the checkout, for any kernel cache a
    library keeps (the program's own nvcc builds go to its _build/)."""
    base = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def device_kind(device):
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line():
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def result_line(ctx: RunContext, res: dict, limits: dict, chips: int):
    """(the result object, the check lines for standard error)."""
    from portbench import trace as tracelib

    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(ctx.bench, ctx.cell["name"], section):
        if ctx.trace:
            value = spec.reader(m["name"])(res["layer"])
            if value is None:
                continue
        else:
            value = res["e2e"][m["name"]]
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind(ctx.device),
              "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": None, "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": device}
    if ctx.trace:
        summary = res["trace"]
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = tracelib.breakdown(summary)
    checks, lines, ok = {}, [], True
    for name, limit in limits["limits"].items():
        value = res["checks"].get(name, math.inf)
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": _finite(value), "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if passed else 'FAILED'}")
    out["correct"] = bool(ok and res["failed"] == 0)
    out["checks"] = checks
    return out, lines


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    cache_dirs(root)
    device = require_devices(int(cell["chips"]))
    print(f"portbench: {cell['name']} seed {args.seed} on {card_line()}; "
          "bf16 dense peak 989 TFLOP/s, HBM 3.35 TB/s (H100 SXM, 700 W)",
          file=sys.stderr, flush=True)
    ctx = RunContext(bench=bench, cell=cell, config=config, traffic=traffic,
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=t_start)
    res = spec.mode(traffic).run(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run imported {found}", file=sys.stderr)
        return 3
    out, lines = result_line(ctx, res, limits, int(cell["chips"]))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
