"""The numbers that decide `correct`, from the program's readings and the
reference's.

Training (three steps from the same weights on the same rows):
- loss_gap: the largest relative gap of a step's loss;
- grad_gap: over the leaves, the largest gap between the norms of the
  first (clipped) gradient, over the larger of the reference leaf's norm
  and the median leaf's;
- change_gap: the same for the norm of each leaf's change after the
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (below that a leaf moves under Adam by round-off);
- grad_err: over the leaves, the norm of the difference of the first
  (clipped) gradients, program less reference, over the larger of the
  reference leaf's norm and the median leaf's: the gradient tensors
  compared, where grad_gap compares only their norms;
- loss1_gap, grad_gap_median, change_gap_median, grad_err_median: the
  first step's loss gap, and the median leaf's gap in place of the worst
  leaf's.
"""

from __future__ import annotations

import math
import statistics

TINY_GRAD = 1e-3


def _leaf_gaps(prog: dict, ref: dict, leaves):
    """Per leaf, |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's (inf where the program has
    no finite reading)."""
    leaves = list(leaves)
    if not leaves:
        return [math.inf]
    floor = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            if k in prog and math.isfinite(prog[k]) else math.inf
            for k in leaves]


def _leaf_errors(prog: dict, ref: dict, norms: dict):
    """Per leaf, ||program tensor - reference tensor|| over the larger of
    the reference leaf's norm (`norms`) and the median leaf's (inf where
    the program has no finite tensor of that shape)."""
    floor = statistics.median(norms.values())
    out = []
    for k, g in ref.items():
        p = prog.get(k)
        if p is None or p.shape != g.shape:
            out.append(math.inf)
            continue
        err = float((p.to(g.device).double() - g.double()).norm())
        out.append(err / max(norms[k], floor, 1e-30)
                   if math.isfinite(err) else math.inf)
    return out


def train_gaps(prog: dict, ref: dict) -> dict:
    """Every candidate number; a cell's limits file names those it
    compares."""
    if len(prog["loss"]) != len(ref["loss"]):
        steps = [math.inf]
    else:
        steps = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p)
                 else math.inf for p, r in zip(prog["loss"], ref["loss"])]
    grads = ref["grad_norm"]
    median = statistics.median(grads.values())
    moving = [k for k, g in grads.items() if g >= TINY_GRAD * median]
    grad = _leaf_gaps(prog["grad_norm"], grads, grads)
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    err = _leaf_errors(prog["grad"], ref["grad"], grads)
    return {"loss_gap": max(steps), "loss1_gap": steps[0],
            "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change),
            "grad_err": max(err), "grad_err_median": statistics.median(err)}
