"""The controls of `correct` at CPU size: each reads above the sound
program on the numbers its cell compares (on the card, at the cells' own
sizes, the readings and limits are in portbench/limits/)."""

import torch

from portbench import calibrate, spec
from portbench.tests.conftest import ROOT

SEED = 2 ** 31 + 21


def _cell(name):
    cell = spec.workload(spec.load_benchmark(ROOT), name)
    return spec.config(cell["config"]), spec.traffic(cell["traffic"])


def test_train_control_and_half_batch(cpu_cells):
    config, traffic = _cell("encdec.train.pool")
    limits = spec.limits("encdec.train.pool")
    out = calibrate.train_readings(config, traffic, SEED,
                                   torch.device("cpu"), control=True)
    for number in limits["control_fails"]:
        assert out["control"][number] > 2 * out["program"][number], number
    for number in limits["half_batch_fails"]:
        assert out["half_batch"][number] > 2 * out["program"][number], number
