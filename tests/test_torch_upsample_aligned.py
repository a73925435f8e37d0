"""DPT-Large's align_corners=True upsample (ops/resize.upsample_aligned_nhwc,
csrc/upsample_aligned_nhwc.cu) and the benchmark's reader of it.

On the CPU the op runs the two batched GEMMs by fixed (hi, lo) matrices that
it ran before the kernel came, bit for bit. The registered ops' fake kernels
give their shapes; the kernels' tap ranges, mirrored here, are held to the
dense matrix's pattern, and what the kernels take is checked before a launch.
`upsample_roofline.train` counts a step's bytes from the configuration and
reads only its two kernels.

The tests marked `cuda` need a card and skip without one (this file imports
neither JAX nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_upsample_aligned.py

On the card the kernels are held against `F.interpolate(align_corners=True)`
in f64. The forward takes f32 weights (one rounding each) and two lerps,
each a subtraction and an fma: a few f32 roundings of the taps' magnitude,
then one rounding to the dtype. The backward sums at most (2f + 1)^2 terms
a pixel in f32, then rounds once. So each output is held within one rounding
of the dtype (2^-8 of its value in bf16, 2^-24 in f32) plus 2^-21 of the
largest |x| (forward), or plus 2^-18 of its sum of |weight * grad| (backward:
a 64-term chain of f32 roundings). Two backward calls, and a CUDA graph's
replay against the eager call, agree bit for bit: no atomics.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from ann3depth_tpu_torch.ops import resize
from portbench import spec
from portbench.trace import TraceSummary

ROOT = Path(__file__).resolve().parents[1]
# The five upsamples of a DPT-Large step (refinenet4 ... refinenet1, head),
# per image: [h, w, C] in, x2.
DPT_LARGE = [(12, 12, 256), (24, 24, 256), (48, 48, 256), (96, 96, 256),
             (192, 192, 128)]
# Demangled names of the two kernels as a profiler reports them.
KERNEL_NAMES = [
    "void (anonymous namespace)::upsample_aligned_nhwc_fwd<__nv_bfloat16, 8>"
    "(__nv_bfloat16 const*, __nv_bfloat16*, (anonymous namespace)::Shape, "
    "int, int)",
    "void (anonymous namespace)::upsample_aligned_nhwc_bwd<__nv_bfloat16, 8>"
    "(__nv_bfloat16 const*, __nv_bfloat16*, (anonymous namespace)::Shape, "
    "int, int)"]


def _inputs(shape, factor, dtype, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, h, w, c = shape
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    g = torch.randn((b, h * factor, w * factor, c), generator=gen,
                    device=device).to(dtype)
    return x, g


def _run(fn, x, g, factor):
    xs = x.detach().clone().requires_grad_()
    y = fn(xs, factor)
    return y.detach(), torch.autograd.grad(y, xs, g)[0]


def _reader():
    path = ROOT / "portbench" / "metrics" / "upsample_roofline.train.py"
    module_spec = importlib.util.spec_from_file_location(
        "upsample_roofline_train", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# The CPU path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_path_is_the_pair_of_gemms_bit_for_bit(dtype):
    """Forward and backward, with and without autograd, are the (hi, lo)
    GEMMs the op ran before the kernel."""
    x, g = _inputs((2, 5, 7, 8), 2, dtype)
    ay = resize._aligned_upsample_matrix(5, 2, dtype, x.device)
    ax = resize._aligned_upsample_matrix(7, 2, dtype, x.device)

    def pair(xs, factor):
        if ay[1] is None:
            return resize._pair_resize(xs, ay, ax)
        return resize._PairUpsample.apply(xs, *ay, *ax)

    got = _run(resize.upsample_aligned_nhwc, x, g, 2)
    want = _run(pair, x, g, 2)
    for u, v in zip(got, want):
        assert u.dtype == dtype and torch.equal(u, v)
    with torch.no_grad():
        assert torch.equal(resize.upsample_aligned_nhwc(x, 2), got[0])


def test_the_ops_fake_kernels_give_the_shapes():
    """The registered ops on meta tensors: the output of an upsample by 3
    and the input's gradient from it."""
    x = torch.empty((2, 5, 7, 8), dtype=torch.bfloat16, device="meta")
    y = torch.ops.ann3depth.upsample_aligned_nhwc(x, 3)
    assert y.shape == (2, 15, 21, 8) and y.dtype == x.dtype
    dx = torch.ops.ann3depth.upsample_aligned_nhwc_backward(y, 3)
    assert dx.shape == x.shape and dx.dtype == x.dtype


@pytest.mark.parametrize("factor", [2.5, 2.0, True, 0, "2"])
def test_a_factor_that_is_no_integer_from_1_raises(factor):
    x, _ = _inputs((1, 3, 3, 8), 2, torch.float32)
    with pytest.raises(ValueError, match="integer factor"):
        resize.upsample_aligned_nhwc(x, factor)


def _first(i, n, big):
    """The first of `big` outputs whose taps include input i of n: the
    kernels' Axis::first."""
    return 0 if i == 0 or n == 1 else ((i - 1) * (big - 1) + n - 2) // (n - 1)


def _last(i, n, big):
    """The last such output: Axis::last."""
    return big - 1 if n == 1 else min(big - 1, ((i + 1) * (big - 1) - 1)
                                      // (n - 1))


@pytest.mark.parametrize("n", [1, 2, 5, 12, 97])
@pytest.mark.parametrize("factor", [1, 2, 3, 4])
def test_the_kernels_tap_ranges_are_the_outputs_that_read_each_input(
        n, factor):
    """The backward kernel gathers input i from outputs first(i) to
    last(i): exactly those whose taps include it (a weight in the f64
    matrix, or the right tap's zero weight at an integer position)."""
    big = n * factor
    o = torch.arange(big, dtype=torch.float64)
    src = o * ((n - 1) / max(big - 1, 1))
    left = src.floor().long()
    right = (left + 1).clamp(max=n - 1)
    for i in range(n):
        reads = ((left == i) | (right == i)).nonzero().flatten().tolist()
        assert reads == list(range(_first(i, n, big),
                                   _last(i, n, big) + 1)), i


def _unaligned(shape, dtype, device="cpu"):
    """A contiguous view of `shape` one element into its storage."""
    n = torch.Size(shape).numel()
    return torch.zeros(n + 1, dtype=dtype, device=device)[1:].view(shape)


@pytest.mark.parametrize("make,match", [
    (lambda: torch.zeros((2, 6, 8, 16), dtype=torch.float16), "bf16 or f32"),
    (lambda: torch.zeros((2, 6, 8), dtype=torch.bfloat16), "bf16 or f32"),
    (lambda: torch.zeros((2, 8, 6, 16)).transpose(1, 2), "contiguous"),
    (lambda: torch.zeros((0, 6, 8, 16)), "empty"),
    (lambda: torch.zeros((2, 6, 8, 12), dtype=torch.bfloat16),
     "a multiple of 8"),
    (lambda: torch.zeros((2, 6, 8, 6)), "a multiple of 4"),
    (lambda: _unaligned((2, 6, 8, 16), torch.bfloat16), "16-byte aligned"),
    (lambda: _unaligned((2, 6, 8, 16), torch.float32), "16-byte aligned")])
def test_kernel_arguments_are_checked_before_a_launch(make, match):
    """What the kernels do not take (another dtype or rank, a strided or
    empty map, channels or data that 16-byte vectors do not cover) raises
    before the library is loaded."""
    with pytest.raises(ValueError, match=match):
        resize._check_cuda_arg(make(), 2, "input")


def test_kernel_arguments_are_bounded_by_32_bit_taps():
    """An axis of 2^15 inputs upsampled by 2: o (n - 1) passes 2^31."""
    x = torch.zeros((1, 1, 2 ** 15, 8), dtype=torch.bfloat16)
    resize._check_cuda_arg(x, 1, "input")
    with pytest.raises(ValueError, match="too large"):
        resize._check_cuda_arg(x, 2, "input")


# ---------------------------------------------------------------------------
# The benchmark's reader.
# ---------------------------------------------------------------------------

def test_reader_counts_a_b16_steps_bytes_from_the_configuration():
    config = json.loads((ROOT / "portbench/configs/dpt-large.json")
                        .read_text())
    want = sum(2 * 16 * h * w * c * 5 * 2 for h, w, c in DPT_LARGE)
    got = _reader().step_bytes(config["arch"],
                               config["config"]["data"]["input_hw"], 16)
    assert got == want == 2_512_650_240


def test_reader_reads_its_kernels_and_none_without_them():
    read = spec.reader("upsample_roofline.train")
    ctx = {"kind": "train", "batch": 16, "traced_steps": 20}
    by_name = {KERNEL_NAMES[0]: 0.01, KERNEL_NAMES[1]: 0.01,
               "nvjet_tst_128x192_64x5_1x2_h_bz_coopB_NNN": 0.5}
    full = read(dict(ctx, trace=TraceSummary(1.0, 1.0, by_name, [])))
    assert full == pytest.approx(
        100 * 2_512_650_240 * 20 / 0.02 / 3.35e12)
    bare = TraceSummary(1.0, 1.0, {KERNEL_NAMES[0].replace("upsample", "x"):
                                   0.01}, [])
    assert read(dict(ctx, trace=bare)) is None
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, kind="serve",
                     trace=TraceSummary(1.0, 1.0, by_name, []))) is None


def test_conv_and_attention_readers_do_not_take_the_kernels():
    ctx = {"kind": "train", "batch": 16, "traced_steps": 20,
           "trace": TraceSummary(1.0, 1.0, dict.fromkeys(KERNEL_NAMES, 0.01),
                                 [])}
    for name in ("conv_roofline.train", "attention_roofline.train",
                 "preprocess_roofline.train"):
        assert spec.reader(name)(dict(ctx, preprocess_bound_s=1e-5)) is None


# ---------------------------------------------------------------------------
# The kernels on the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off for the test; the flags are restored after
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _reference(x, g, factor):
    """F.interpolate(align_corners=True) in f64 on NCHW views: the output,
    the input's gradient and its sum of |weight * grad|."""
    xs = x.double().permute(0, 3, 1, 2).requires_grad_()
    y = F.interpolate(xs, scale_factor=factor, mode="bilinear",
                      align_corners=True)
    gd = g.double().permute(0, 3, 1, 2)
    dx, = torch.autograd.grad(y, xs, gd)
    mag, = torch.autograd.grad(y, xs, gd.abs())
    nhwc = (0, 2, 3, 1)
    return (y.detach().permute(*nhwc), dx.permute(*nhwc),
            mag.permute(*nhwc))


def _assert_close_to_reference(got, x, g, factor):
    y, dx = got
    y_ref, dx_ref, mag = _reference(x, g, factor)
    rel = 2.0 ** -8 if x.dtype == torch.bfloat16 else 2.0 ** -24
    y_err = (y.double() - y_ref).abs()
    assert bool((y_err <= rel * y_ref.abs()
                 + 2.0 ** -21 * float(x.double().abs().max())).all()), \
        float(y_err.max())
    dx_err = (dx.double() - dx_ref).abs()
    assert bool((dx_err <= rel * dx_ref.abs() + 2.0 ** -18 * mag).all()), \
        float(dx_err.max())


CARD_CASES = [
    *(((2, h, w, c), 2) for h, w, c in DPT_LARGE),
    ((2, 5, 7, 8), 2),      # H != W, C = 8
    ((2, 1, 1, 24), 2),     # n = 1 on both axes, C = 24
    ((3, 1, 6, 24), 4),     # n = 1 on one axis, factor 4
    ((2, 6, 5, 8), 4),
    ((2, 7, 3, 24), 3),
    ((1, 4, 5, 8), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,factor", CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_f64_interpolate(cuda, shape, factor, dtype):
    x, g = _inputs(shape, factor, dtype, cuda, seed=1)
    fwd = resize.upsample_aligned_nhwc.launches
    bwd = resize.upsample_aligned_nhwc_backward.launches
    got = _run(resize.upsample_aligned_nhwc, x, g, factor)
    torch.cuda.synchronize()
    assert resize.upsample_aligned_nhwc.launches == fwd + 1
    assert resize.upsample_aligned_nhwc_backward.launches == bwd + 1
    for t, want_shape in zip(got, (g.shape, x.shape)):
        assert t.dtype == dtype and t.shape == want_shape
        assert t.is_contiguous()
    _assert_close_to_reference(got, x, g, factor)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 96, 96, 256), (16, 192, 192, 128)])
def test_two_backward_calls_are_equal_bit_for_bit(cuda, shape):
    x, g = _inputs(shape, 2, torch.bfloat16, cuda, seed=3)
    first = _run(resize.upsample_aligned_nhwc, x, g, 2)
    second = _run(resize.upsample_aligned_nhwc, x, g, 2)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_a_constant_map_stays_constant_in_bf16(cuda):
    x = torch.full((2, 48, 48, 256), 0.7, dtype=torch.bfloat16, device=cuda)
    y = resize.upsample_aligned_nhwc(x, 2)
    assert bool((y == x[0, 0, 0, 0]).all())


def _captured(cuda, x, g):
    """Eager results, then the same under a CUDA graph: (eager, graph
    outputs, launch counts taken during the capture)."""
    eager = _run(resize.upsample_aligned_nhwc, x, g, 2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _run(resize.upsample_aligned_nhwc, x, g, 2)  # warm, outside capture
    torch.cuda.current_stream().wait_stream(stream)
    before = (resize.upsample_aligned_nhwc.launches,
              resize.upsample_aligned_nhwc_backward.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _run(resize.upsample_aligned_nhwc, x, g, 2)
    during = (resize.upsample_aligned_nhwc.launches - before[0],
              resize.upsample_aligned_nhwc_backward.launches - before[1])
    return eager, graph, out, during


@pytest.mark.cuda
def test_captured_replay_equals_eager(cuda):
    x, g = _inputs((16, 48, 48, 256), 2, torch.bfloat16, cuda, seed=4)
    eager, graph, out, _ = _captured(cuda, x, g)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.cuda
def test_launch_counters_count_outside_capture_only(cuda):
    x, g = _inputs((2, 12, 12, 256), 2, torch.bfloat16, cuda, seed=5)
    before = (resize.upsample_aligned_nhwc.launches,
              resize.upsample_aligned_nhwc_backward.launches)
    _, graph, _, during = _captured(cuda, x, g)
    assert during == (0, 0)
    graph.replay()
    torch.cuda.synchronize()
    # The eager call and the warm call: one each way apiece.
    assert (resize.upsample_aligned_nhwc.launches - before[0],
            resize.upsample_aligned_nhwc_backward.launches - before[1]) \
        == (2, 2)


@pytest.mark.cuda
def test_the_kernels_reject_what_they_do_not_take(cuda):
    x, _ = _inputs((2, 6, 8, 16), 2, torch.float16, cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        resize.upsample_aligned_nhwc(x, 2)
    x = x.float()
    with pytest.raises(ValueError, match="contiguous"):
        resize.upsample_aligned_nhwc(x.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="integer factor"):
        resize.upsample_aligned_nhwc(x, 1.5)
    with pytest.raises(ValueError, match="no upsample by"):
        resize.upsample_aligned_nhwc_backward(x[:, :5], 2)
    with pytest.raises(ValueError, match="a multiple of 8"):
        resize.upsample_aligned_nhwc(x[..., :12].bfloat16().contiguous(), 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        resize.upsample_aligned_nhwc(_unaligned(x.shape, x.dtype, cuda), 2)


@pytest.mark.cuda
def test_dpt_large_runs_the_kernels_five_times_each_way(cuda):
    """The model's five upsamples, forward and backward, at a small width
    on the card: each a launch of the kernels, fed contiguous NHWC."""
    from ann3depth_tpu_torch.models.dpt_large import DPTLargeDepthNet

    model = DPTLargeDepthNet(dim=64, depth=4, heads=4,
                             tap_layers=(0, 1, 2, 3), widths=(16, 32, 64, 64),
                             features=32)
    model.init_weights(torch.Generator().manual_seed(0), (64, 64)).to(cuda)
    fwd = resize.upsample_aligned_nhwc.launches
    bwd = resize.upsample_aligned_nhwc_backward.launches
    out = model(torch.randn((2, 64, 64, 3), device=cuda))
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert resize.upsample_aligned_nhwc.launches == fwd + 5
    assert resize.upsample_aligned_nhwc_backward.launches == bwd + 5
