"""Readings from which the limits of `correct` are set (limits/*.json).

    python3 -m portbench.calibrate --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e]

Not part of a benchmark run. For each seed it sets the training cell up
as a run does, drives the compared steps, and prints, as one JSON line,
every number that `correct` can compare, and each step's loss:

- "program": the program as the configuration states it (the lower
  reading is the largest over a dozen seeds or more);
- "control": the reference itself in float8 (the configuration's
  `control.train.lowp`) put in the program's place (the upper reading is
  the smallest over its seeds);
- "half_batch": the reference put in the program's place with half of
  each batch left out and the mean taken over the rest.

The control and the half batch are read on the control seeds alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import compare, spec
from portbench.modes import train as train_mode


def train_readings(config, traffic, seed, device, control):
    out = {"seed": seed}
    r = train_mode.TrainRun(config, traffic, seed, device)
    r.setup()
    r.first_steps()
    r.release()
    ref = r.reference()
    out["program"] = r.gaps(ref)
    out["loss"] = {"program": r.program["loss"], "reference": ref["loss"]}
    if control:
        lowp = config["control"]["train"]["lowp"]
        out["control"] = compare.train_gaps(r.reference(lowp=lowp), ref)
        full_rows = r.rows
        r.rows = [rows[:len(rows) // 2] for rows in full_rows]
        out["half_batch"] = compare.train_gaps(r.reference(), ref)
        r.rows = full_rows
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = spec.load_benchmark(Path.cwd())
    cell = spec.workload(bench, args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    device = torch.device(args.device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(controls - set(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        out = train_readings(config, traffic, seed, device, seed in controls)
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
