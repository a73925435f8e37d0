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


def test_grad_err_compares_the_gradient_tensors(cpu_cells):
    """The gradient tensors' gaps at CPU size (encdec at width 0.25, bf16
    on the CPU; seeds 5, 77 and SEED read alike): the program's grad_err
    0.064-0.085, its median leaf's 0.005-0.0075; the fp8 control 3.8-4.3x
    and 9.2-13x those, half a batch 6.7-9.9x and 12-20x."""
    config, traffic = _cell("encdec.train.pool")
    out = calibrate.train_readings(config, traffic, SEED,
                                   torch.device("cpu"), control=True)
    prog = out["program"]
    assert prog["grad_err"] < 0.1 and prog["grad_err_median"] < 0.01
    for fault, worst, median in (("control", 3, 5), ("half_batch", 5, 10)):
        assert out[fault]["grad_err"] > worst * prog["grad_err"], fault
        assert out[fault]["grad_err_median"] > median * \
            prog["grad_err_median"], fault
