"""The port's `info` (cli.py, utils/flops.py) against the JAX CLI's, on the
CPU.

Both print the same keys with the same values for smoke, make3d-small,
make3d-encdec and smoke with dpt-small. The JAX side's params come from
`jax.eval_shape` of its own `init_params` (the same shapes, and the same
FLOP count from `lower().compile().cost_analysis()`, without running the
init eagerly).

FLOPs: the two counts differ by construction, and the test bounds the
difference. FlopCounterMode (the port) counts 2 FLOPs a multiply-add over
the whole kernel window of every convolution and matmul, SAME-padding
taps included, and counts no elementwise op. XLA's cost analysis (JAX)
counts only the taps inside the unpadded input and one FLOP an element of
every elementwise op. At 240x320, make3d-small's padding taps are 0.94% of
its conv FLOPs and its bias adds and ReLUs 0.68% (port 0.2705 GFLOP, JAX
0.2698); make3d-encdec's padding taps are 3.3% (the stride-2 encoder and
the decoder run at 1/4-1/16 of the input, where a 3x3 window's border is
a larger share) and its elementwise ops (GroupNorm, ReLU, bias, the s2d
stem) about 1% (port 2.559, JAX 2.501, +2.3%; the decoder upsample's
GEMMs are 0.046 GFLOP of the port's count). So the port's count is at
least JAX's and at most JAX's plus the padding share: held to
1 <= port / JAX <= 1.035.
"""

import contextlib
import functools
import io
import json

import jax
import pytest
import torch

from ann3depth_tpu import cli as jcli
from ann3depth_tpu.train import step as jstep
from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch.utils import flops

FLOPS_KEYS = ("forward_gflops_per_image", "device_peak_tflops",
              "device_kind")
CONFIGS = [["--config", "smoke"], ["--config", "make3d-small"],
           ["--config", "make3d-encdec"],
           ["--config", "smoke", "--model", "dpt-small"]]
FLOPS_RATIO = (1.0, 1.035)


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def jax_info(monkeypatch):
    """The JAX CLI's `info`, its params from eval_shape of init_params."""
    init = jstep.init_params
    monkeypatch.setattr(jstep, "init_params", lambda m, hw, *a, **k: (
        jax.eval_shape(functools.partial(init, m, hw, *a, **k))))
    return lambda argv: _printed(jcli.main, ["info"] + argv)


@pytest.mark.parametrize("argv", CONFIGS, ids=lambda a: "-".join(a[1::2]))
def test_info_matches_jax(jax_info, argv):
    got = _printed(cli.main, ["info", "--device", "cpu"] + argv)
    assert got == jax_info(argv)
    assert not set(FLOPS_KEYS) & set(got)


@pytest.mark.parametrize("config", ["make3d-small", "make3d-encdec"])
def test_info_flops_agree_with_jax(jax_info, config):
    got = _printed(cli.main, ["info", "--device", "cpu", "--config", config,
                              "--flops"])
    want = jax_info(["--config", config, "--flops"])
    ratio = got["forward_gflops_per_image"] / want["forward_gflops_per_image"]
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], (got, want)
    # No peak for the CPU: the keys are left out, as JAX leaves them out.
    assert "device_peak_tflops" not in got and "device_kind" not in got
    assert {k: v for k, v in got.items() if k not in FLOPS_KEYS} == {
        k: v for k, v in want.items() if k not in FLOPS_KEYS}


def test_forward_flops_counts_a_matmul_and_a_conv():
    lin = torch.nn.Linear(64, 32, bias=False)
    assert flops.forward_flops(lin, torch.zeros(4, 64)) == 2 * 4 * 64 * 32
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    assert flops.forward_flops(conv, torch.zeros(1, 3, 10, 12)) == (
        2 * 3 * 8 * 9 * 10 * 12)  # the padding taps counted too


def test_cpu_attention_counts_as_on_the_card():
    """The CPU's fused attention counts as the CUDA kernels do (their
    formulas: QK^T and AV, 4 b h s^2 d forward, 2.5 times that backward),
    so `info --flops` of a DPT does not depend on the device."""
    q = torch.zeros(1, 2, 8, 4, requires_grad=True)

    def attention(x):
        return torch.nn.functional.scaled_dot_product_attention(x, x, x)

    fwd = 4 * 1 * 2 * 8 * 8 * 4
    assert flops.forward_flops(attention, q) == fwd
    assert flops.step_flops(lambda: attention(q).sum().backward()) == (
        3.5 * fwd)


def test_device_peak_flops(monkeypatch):
    assert flops.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert flops.device_peak_flops("cuda") == peak
        assert flops.device_peak_flops() == peak


def test_info_refusals_match_jax():
    argv = ["info", "--config", "smoke", "--ckpt-step", "3"]
    with pytest.raises(SystemExit) as j:
        jcli.main(argv)
    with pytest.raises(SystemExit) as t:
        cli.main(argv + ["--device", "cpu"])
    assert str(t.value) == str(j.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["info", "--config", "smoke"])
