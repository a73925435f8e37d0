"""Small stand-ins of the cells for the CPU: the same files, cut to shapes
the CPU runs in seconds (encdec at width 0.25 on 32x48 inputs, b4, a
dozen 48x64 scenes)."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402

REAL_CONFIG, REAL_TRAFFIC = spec.config, spec.traffic


def small_config(name):
    cfg = copy.deepcopy(REAL_CONFIG(name))
    cfg["config"]["data"]["input_hw"] = [32, 48]
    cfg["config"]["model"]["width_mult"] = 0.25
    cfg["arch"]["width_mult"] = 0.25
    cfg["config"]["train"]["batch_size"] = 4
    return cfg


def small_traffic(name):
    t = dict(REAL_TRAFFIC(name))
    t.update(scenes=12, image_hw=[48, 64], depth_hw=[20, 12], warm_steps=2,
             trace_steps=3)
    return t


@pytest.fixture
def cpu_cells(monkeypatch):
    """The cells at CPU size, and a run that takes the CPU for its card."""
    from portbench import run

    monkeypatch.setattr(spec, "config", small_config)
    monkeypatch.setattr(spec, "traffic", small_traffic)
    monkeypatch.setattr(run, "require_devices",
                        lambda chips: torch.device("cpu"))
    monkeypatch.chdir(ROOT)
    torch.set_num_threads(2)
    return run
