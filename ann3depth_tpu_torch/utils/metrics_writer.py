"""Metrics/observability surface (SURVEY.md §5 "Metrics / logging").

The reference wrote TensorBoard scalar + image summaries; the rebuild's
primary sink is structured JSONL (machine-checkable in tests/benchmarks),
with an optional TensorBoard event writer when `tensorboardX`-equivalent
deps exist (they don't in this image, so TB output is gated off cleanly).

A copy of `ann3depth_tpu/utils/metrics_writer.py`, so that the port imports nothing of
the JAX package; tests/test_torch_train_loop.py compares its records with the original's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricsWriter:
    """Append-only JSONL metrics log, one object per event."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, metrics: Mapping[str, float], **extra):
        rec = {"step": int(step), "time": time.time(),
               **{k: _to_float(v) for k, v in metrics.items()}, **extra}
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
