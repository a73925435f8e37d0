"""DPT-Large (`models/dpt_large.py`, registry name `dpt-large`) against its
plain reference (`portbench/reference/dpt_large.py`) on the CPU.

The program's class at a small size (dim 64, depth 4 with every block a
tap, 4 heads, reassembly widths 16/32/64/64, 32 fusion features, 64x64
in) is given the reference's seeded weights and matches it in f32,
forward and every leaf's gradient, and in bf16 within a bf16 tolerance
that the reference's fp8 control fails. The published widths are built
on the meta device, and the benchmark configuration holds them. The
benchmark's two DPT-Large rooflines read their kernels by name.
"""

import ast
import dataclasses
import json
import math
import statistics
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from ann3depth_tpu_torch.config import ModelConfig, get_config
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.models.dpt_large import DPTLargeDepthNet
from ann3depth_tpu_torch.train import loop
from portbench import inputs, spec
from portbench.counts import dpt as dpt_counts
from portbench.trace import TraceSummary
from portbench.reference import dpt_large as ref

ROOT = Path(__file__).resolve().parents[1]
HW = (64, 64)
SMALL = dict(dim=64, depth=4, heads=4, tap_layers=(0, 1, 2, 3),
             widths=(16, 32, 64, 64), features=32)
# The published sizes (ViT-L/16 at 384x384) and their parameter count.
LARGE = dict(patch=16, dim=1024, depth=24, heads=16, mlp_dim=4096,
             tap_layers=[5, 11, 17, 23],
             reassemble_widths=[256, 512, 1024, 1024], features=256,
             head_hidden=32)
LARGE_PARAMS = 341_848_257
ARCH = dict(patch=16, dim=64, depth=4, heads=4, mlp_dim=256,
            tap_layers=[0, 1, 2, 3], reassemble_widths=[16, 32, 64, 64],
            features=32, head_hidden=32)
# bf16 against the f32 reference at the small size (seeds below): the
# output within 6% of its largest value (the program reads 1-3%, the fp8
# control 20-35%), the median leaf's gradient error within 0.1 (the
# program 0.02-0.04, the fp8 control 0.3-0.4).
BF16_OUT_TOL = 0.06
BF16_GRAD_TOL = 0.1


def _weights(seed=7):
    return inputs.make_weights(ref.param_shapes(ARCH, HW), seed, "cpu")


def _program(weights, dtype):
    model = DPTLargeDepthNet(compute_dtype=dtype, **SMALL)
    model.init_weights(torch.Generator().manual_seed(0), HW)
    model.load_state_dict(weights)
    return model


def _input():
    return torch.randn(2, *HW, 3, generator=torch.Generator().manual_seed(3))


def _loss(y):
    return y.square().mean()


def _reference(weights, x, lowp=None):
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    y = ref.forward(p, x, ARCH, lowp=lowp)
    grads = torch.autograd.grad(_loss(y), list(p.values()))
    return y.detach(), dict(zip(p, grads))


def _grad_errors(grads, want):
    """Per leaf, ||g - g_ref|| over the larger of ||g_ref|| and the median
    leaf's norm (the benchmark's grad_err)."""
    norms = {k: float(g.norm()) for k, g in want.items()}
    floor = statistics.median(norms.values())
    return [float((grads[k] - g).norm()) / max(norms[k], floor)
            for k, g in want.items()]


def _out_error(y, want):
    return float((y - want).abs().max()) / float(want.abs().max())


def test_f32_matches_the_reference_forward_and_every_leaf_gradient():
    w, x = _weights(), _input()
    want, want_g = _reference(w, x)
    model = _program(w, torch.float32)
    assert [n for n, _ in model.named_parameters()] == list(want_g)
    y = model(x)
    assert y.shape == (2, *HW, 1) and y.dtype == torch.float32
    grads = dict(zip(want_g, torch.autograd.grad(_loss(y),
                                                 list(model.parameters()))))
    assert _out_error(y.detach(), want) <= 1e-5
    for k, g in want_g.items():
        assert float(g.norm()) > 0, k
        assert float((grads[k] - g).norm()) <= 1e-5 * float(g.norm()), k


@pytest.mark.parametrize("seed", [7, 8])
def test_bf16_within_its_tolerance_which_the_fp8_control_fails(seed):
    w, x = _weights(seed), _input()
    want, want_g = _reference(w, x)
    model = _program(w, torch.bfloat16)
    y = model(x)
    grads = dict(zip(want_g, torch.autograd.grad(_loss(y),
                                                 list(model.parameters()))))
    assert _out_error(y.detach(), want) <= BF16_OUT_TOL
    assert statistics.median(_grad_errors(grads, want_g)) <= BF16_GRAD_TOL
    low, low_g = _reference(w, x, lowp="fp8")
    assert _out_error(low, want) > BF16_OUT_TOL
    assert statistics.median(_grad_errors(low_g, want_g)) > BF16_GRAD_TOL


def test_published_widths_on_the_meta_device():
    """The registry's dpt-large at the preset's 384x384: 24 blocks 1024
    wide, 577 position rows, the published parameter count and the
    reference's shapes (whose forward gives a 384x384 map)."""
    cfg = get_config("dpt-large")
    assert (cfg.model.name, cfg.data.input_hw, cfg.train.batch_size,
            cfg.train.optimizer, cfg.train.loss) == (
                "dpt-large", (384, 384), 16, "adamw", "si")
    with torch.device("meta"):
        model = registry.build(cfg.model)
        model.init_weights(None, cfg.data.input_hw)
    assert isinstance(model, DPTLargeDepthNet) and len(model.blocks) == 24
    assert model.pos_embed.shape == (1, 577, 1024)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(s) for k, s in ref.param_shapes(
        LARGE, cfg.data.input_hw).items()}
    assert sum(math.prod(s) for s in shapes.values()) == LARGE_PARAMS
    config = json.loads((ROOT / "portbench/configs/dpt-large.json")
                        .read_text())
    assert config["arch"] == {**LARGE, "params": LARGE_PARAMS}
    assert config["reduced"] == [] and config["reference"] == "dpt_large"
    assert config["config"]["model"]["name"] == "dpt-large"
    assert registry.output_hw("dpt-large", (384, 384)) == (384, 384)
    y = ref.forward({k: torch.empty(s, device="meta") for k, s in
                     shapes.items()}, torch.empty(1, 384, 384, 3,
                                                  device="meta"),
                    LARGE)
    assert y.shape == (1, 384, 384, 1)


def test_the_stride_two_reassembly_conv_pads_one_on_each_side():
    """DPT's 3x3 stride-2 conv (the deepest tap, 24x24 -> 12x12 at 384)
    pads (1, 1) as padding=1 does, where TF's "SAME" would pad (0, 1)."""
    model = _program(_weights(), torch.float32)
    conv = model.act_postprocess4.resample
    assert conv.stride == (2, 2) and conv.padding == (1, 1)
    x = torch.randn(1, 64, 24, 24, generator=torch.Generator().manual_seed(1))
    want = F.conv2d(F.pad(x, (1, 1, 1, 1)), conv.weight, conv.bias, 2)
    same = F.conv2d(F.pad(x, (0, 1, 0, 1)), conv.weight, conv.bias, 2)
    got = conv(x)
    assert got.shape == (1, 64, 12, 12)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert float((got - same).detach().abs().max()) > 1e-2


def test_refusals_quant_and_tensor_parallel():
    for quant in ("int8", "int8-qat"):
        with pytest.raises(ValueError, match="dpt family, not 'dpt-large'"):
            registry.build(ModelConfig(name="dpt-large", quant=quant))
    cfg = get_config("dpt-large")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, tensor_parallel=2))
    with pytest.raises(ValueError, match="dpt-family model.*'dpt-large'"):
        loop._validate(cfg)


def test_attention_backend_is_recorded_once_a_shape():
    model = _program(_weights(), torch.bfloat16)
    from ann3depth_tpu_torch.models import dpt_large

    backend = model.attention_backend(2, HW)
    assert backend in ("flash", "efficient", "cudnn", "math")
    key = ((2, 4, 17, 16), "bfloat16", "cpu")
    assert dpt_large.SDPA_BACKENDS[key] == backend
    model(_input())
    assert dpt_large.SDPA_BACKENDS[key] == backend


def test_the_reference_imports_neither_the_port_nor_jax():
    tree = ast.parse((ROOT / "portbench/reference/dpt_large.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    tops = {n.split(".")[0] for n in names}
    assert tops <= {"__future__", "math", "torch", "portbench"}, tops


def test_the_counts_are_the_references_products():
    """counts/dpt.py at the small size: the attention's count is the
    reference's batched products (q k^T and p v, forward and backward),
    the convolutions' its `aten.convolution*` entries."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {k: torch.empty(s, device="meta", requires_grad=True)
              for k, s in ref.param_shapes(ARCH, HW).items()}
    with FlopCounterMode(display=False) as counter:
        y = ref.forward(params, torch.empty(2, *HW, 3, device="meta"), ARCH)
        torch.autograd.grad(y.sum(), list(params.values()))
    ops = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert dpt_counts.attention_flops(ARCH, HW, 2) == ops["aten.bmm"]
    assert dpt_counts.conv_flops("dpt_large", ARCH, HW, 2) == (
        ops["aten.convolution"] + ops["aten.convolution_backward"])


# Kernel names of a DPT-Large step's trace on the H100 (torch 2.11), with
# the seconds each is given below.
H100_KERNELS = {
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
    "__5x_cudnn": 1.0,
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
    "__5x_cudnn": 2.0,
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize256x128x64_warpgroupsize2x1x1_g1_execute_segment_k_on_"
    "kernel__5x_cudnn": 4.0,
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
    "optimized_bf16_128x128_32x4_nhwc_align8>(cutlass_tensorop_bf16_s16816"
    "fprop_optimized_bf16_128x128_32x4_nhwc_align8::Params)": 8.0,
    "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int, "
    "int, int, float const*, int, float*, float const*, kernel_grad_params, "
    "unsigned long long, int, float, int, int, int, int)": 16.0,
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_"
    "64x128x64_4x1x1_cga1x1x1_kernel0_0": 32.0,
    "cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_26_"
    "64x64x64_1x4x1_cga1x1x1_kernel0_0": 64.0,
    "void cudnn::fusion::compute_dot_do_o_specialized<true, 64>(void "
    "const*, void const*, void*, void*, unsigned int)": 128.0,
    "void cudnn::fusion::convert_dq_to_16bits<true>(void const*, void*, "
    "unsigned int)": 256.0,
    "nvjet_tst_256x144_64x4_1x2_h_bz_coopA_NNT": 512.0,
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "128x64_64x6_nt_align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "128x64_64x6_nt_align8::Params)": 1024.0,
    "void at::native::vectorized_elementwise_kernel<8, at::native::"
    "GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)": 2048.0,
}


def test_the_rooflines_read_their_kernels_by_name(monkeypatch):
    """conv_roofline.train sums cuDNN's convolution kernels and no
    attention kernel (cuDNN's SDPA names hold "fprop" and "bprop");
    attention_roofline.train sums the SDPA kernels alone; both read None
    without a trace or without their kernels."""
    monkeypatch.setattr(dpt_counts, "conv_flops", lambda *a: 3.0e12)
    monkeypatch.setattr(dpt_counts, "attention_flops", lambda *a: 1.5e12)
    ctx = {"kind": "train", "batch": 16, "traced_steps": 20,
           "trace": TraceSummary(window_s=1.0, busy_s=1.0,
                                 by_name=dict(H100_KERNELS), gaps=[])}
    peak = 989e12
    conv = spec.reader("conv_roofline.train")(ctx)
    assert conv == pytest.approx(100 * 3.0e12 * 20 / (1 + 2 + 4 + 8 + 16)
                                 / peak)
    att = spec.reader("attention_roofline.train")(ctx)
    assert att == pytest.approx(100 * 1.5e12 * 20 / (32 + 64 + 128 + 256)
                                / peak)
    bare = dict(ctx, trace=TraceSummary(1.0, 1.0, {
        k: v for k, v in H100_KERNELS.items()
        if v >= 512}, []))
    for name in ("conv_roofline.train", "attention_roofline.train"):
        assert spec.reader(name)(bare) is None
        assert spec.reader(name)(dict(ctx, trace=None)) is None
