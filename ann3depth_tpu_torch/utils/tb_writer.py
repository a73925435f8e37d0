"""Optional TensorBoard event writer.

Counterpart of `ann3depth_tpu/utils/tb_writer.py` (which writes through
tf.summary): scalars and images go through
`torch.utils.tensorboard.SummaryWriter`, imported when a writer is made.
Without the `tensorboard` package the writer does nothing, after one
warning. JSONL (utils/metrics_writer.py) stays the primary sink.
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np

log = logging.getLogger(__name__)


class TensorBoardWriter:
    """Thin SummaryWriter wrapper; no-ops (with one warning) without the
    tensorboard package."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            log.warning("tensorboard unavailable; TensorBoard output "
                        "disabled")
            return
        self._writer = SummaryWriter(logdir)

    def write_scalars(self, step: int, metrics: Mapping[str, float]):
        if self._writer is None:
            return
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def write_image(self, step: int, tag: str, img_u8: np.ndarray):
        if self._writer is None:
            return
        self._writer.add_image(tag, np.asarray(img_u8), step,
                               dataformats="HWC")

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
