"""Hyperparameter sweep runner: grid search over config fields.

Counterpart of `ann3depth_tpu/sweep.py`, on the port's config, loop and
checkpoints. Trials run one after another in one process, each a full
`loop.train` plus `loop.evaluate` on `device` (the card unless asked for
the CPU):

    python -m ann3depth_tpu_torch sweep --config smoke --steps 200 \\
        --param train.learning_rate=1e-4,3e-4 \\
        --param model.width_mult=1,2 \\
        --out-dir sweeps/lr_x_width [--metric rmse]

Each `--param dotted.path=v1,v2,...` contributes one grid axis; values
are coerced to the dataclass field's type. Every trial trains under
`<out_dir>/trial_NNN/` (checkpoints + metrics.jsonl), is evaluated on
the test split, and appends a row to `<out_dir>/sweep.jsonl`; the best
trial (by --metric, direction-aware) lands in `<out_dir>/summary.json`.
The ledger's rows have the JAX package's keys, so a sweep started by
either package resumes under the other.

A trial's state (model, optimizer, EMA) is dropped before the next trial
starts; the loop closes its own feed, pools and writers. What stays across
trials is keyed by shape only (the decoder upsample's matrices, the
preprocess kernel's launch plans).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import time
import typing
from typing import Any, Dict, List, Sequence, Tuple

from ann3depth_tpu_torch.config import Config

# Eval metrics where larger is better; everything else is minimized.
_MAXIMIZE = {"delta1", "delta2", "delta3"}


def _field_type(path: str):
    """Type of a dotted config field, e.g. 'train.learning_rate' -> float."""
    parts = path.split(".")
    cls = Config
    for i, part in enumerate(parts):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        if part not in fields:
            raise KeyError(
                f"no config field '{'.'.join(parts[:i + 1])}' "
                f"(available: {sorted(fields)})")
        tp = fields[part].type
        if isinstance(tp, str):  # from __future__ annotations
            tp = typing.get_type_hints(cls)[part]
        if i < len(parts) - 1:
            if not dataclasses.is_dataclass(tp):
                raise KeyError(f"'{'.'.join(parts[:i + 1])}' is not a "
                               "config section")
            cls = tp
    return tp


def _coerce(tp, s: str):
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[int] and friends
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        tp = args[0]
    if tp is bool:
        if s.lower() in ("1", "true", "yes"):
            return True
        if s.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"not a bool: {s!r}")
    return tp(s)


def parse_param(spec: str) -> Tuple[str, List[Any]]:
    """'train.learning_rate=1e-4,3e-4' -> ('train.learning_rate', [...])."""
    if "=" not in spec:
        raise ValueError(f"--param needs dotted.path=v1,v2,... got {spec!r}")
    path, _, raw = spec.partition("=")
    path = path.strip()
    tp = _field_type(path)
    values = [_coerce(tp, v.strip()) for v in raw.split(",") if v.strip()]
    if not values:
        raise ValueError(f"--param {path}: no values given")
    return path, values


def apply_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Nested dataclasses.replace for {'train.learning_rate': 3e-4, ...}."""
    by_section: Dict[str, Dict[str, Any]] = {}
    for path, value in overrides.items():
        section, _, field = path.partition(".")
        _field_type(path)  # validate early with a good error
        by_section.setdefault(section, {})[field] = value
    for section, kw in by_section.items():
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})
    return cfg


def run_sweep(cfg: Config, grid: Sequence[Tuple[str, List[Any]]],
              out_dir: str, *, metric: str = "rmse",
              max_eval_batches=None, progress: bool = True,
              device=None) -> dict:
    """Train + eval every grid point on `device` (None: the card); returns
    {'rows': [...], 'best': row, 'summary_path': path}.

    Trials run sequentially and independently: each gets its own ckpt
    dir, fresh state, and eval.

    Resumable: trials already recorded in <out_dir>/sweep.jsonl with the
    SAME overrides are skipped (a killed sweep rerun with the same grid
    continues where it died; a changed grid re-runs what changed).
    """
    from ann3depth_tpu_torch.train import loop

    paths = [p for p, _ in grid]
    combos = list(itertools.product(*(vs for _, vs in grid)))
    os.makedirs(out_dir, exist_ok=True)
    ledger = os.path.join(out_dir, "sweep.jsonl")
    maximize = metric in _MAXIMIZE

    done: Dict[int, dict] = {}
    if os.path.exists(ledger):
        with open(ledger) as f:
            for line in f:
                row = json.loads(line)
                done[row["trial"]] = row

    rows = []
    for i, combo in enumerate(combos):
        overrides = dict(zip(paths, combo))
        prior = done.get(i)
        if prior is not None and prior["overrides"] == overrides:
            if progress:
                print(f"[sweep] trial {i + 1}/{len(combos)}: {overrides} "
                      "(already recorded, skipping)", flush=True)
            rows.append(prior)
            continue
        trial_dir = os.path.join(out_dir, f"trial_{i:03d}")
        # A trial we are (re-)running must start from a clean checkpoint
        # dir: a mid-trial kill (ledger row missing) or a changed grid
        # value mapping to the same index leaves stale steps behind, which
        # the new run's retention and the eval's restore would mix with
        # its own. Training state lives only under ckpt/, so deleting it
        # is safe; metrics.jsonl etc. are append-only.
        stale_ckpt = os.path.join(trial_dir, "ckpt")
        if os.path.isdir(stale_ckpt):
            shutil.rmtree(stale_ckpt)
        tcfg = apply_overrides(cfg, overrides)
        tcfg = dataclasses.replace(
            tcfg, train=dataclasses.replace(
                tcfg.train, ckpt_dir=os.path.join(trial_dir, "ckpt")))
        if progress:
            print(f"[sweep] trial {i + 1}/{len(combos)}: {overrides}",
                  flush=True)
        t0 = time.perf_counter()
        state, train_metrics = loop.train(tcfg, workdir=trial_dir,
                                          progress=False, device=device)
        wall_s = time.perf_counter() - t0
        eval_metrics = loop.evaluate(tcfg, state=state,
                                     max_batches=max_eval_batches)
        del state  # the next trial starts without this one's
        if metric not in eval_metrics:
            raise KeyError(f"--metric {metric!r} not in eval metrics "
                           f"{sorted(eval_metrics)}")
        row = {"trial": i, "overrides": overrides,
               "train_wall_s": round(wall_s, 2),
               "final_train_loss": float(train_metrics.get("loss", float("nan"))),
               "eval": {k: float(v) for k, v in eval_metrics.items()}}
        rows.append(row)
        with open(ledger, "a") as f:
            f.write(json.dumps(row) + "\n")
        if progress:
            print(f"[sweep]   {metric}={eval_metrics[metric]:.4f} "
                  f"({wall_s:.1f}s)", flush=True)

    best = (max if maximize else min)(rows, key=lambda r: r["eval"][metric])
    summary = {"metric": metric, "maximize": maximize,
               "n_trials": len(rows), "grid": {p: v for p, v in grid},
               "best": best}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return {"rows": rows, "best": best, "summary_path":
            os.path.join(out_dir, "summary.json")}
