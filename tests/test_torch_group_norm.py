"""GroupNorm + ReLU on NHWC bytes (ops/group_norm.py).

On the CPU the op runs the plain version's own aten calls: forward and
backward equal the Stage expression it replaced,
relu(F.group_norm(x.float(), ...).to(x.dtype)) under autograd, bit for bit.
The models keep channels_last through it from their input to their head.

The tests marked `cuda` need a card and skip without one (this file imports
neither JAX nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_group_norm.py

On the card the kernel is held against the plain version in f32 statistics
(`plain_group_norm_relu`, torch's CUDA group_norm). Both take f32 sums of the
same terms in other orders, so their statistics, and the backward's sums,
differ by a few f32 ulps of the sums of the terms' magnitudes:
- y: rtol 1e-5, atol 1e-5 in f32 (|xhat| < 6, gamma ~ 1: a relative 1e-6
  in mean or rstd moves y by under 1e-5); in bf16 one rounding apart, rtol
  2^-7 (a bf16 ulp is at most 2^-7 of the value) with the same atol;
- dx: rtol 1e-4, atol 1e-4 of the largest |dx| in f32 (the means of dz
  gamma and dz gamma xhat over 4,800-38,400 terms, scaled by rstd), and in
  bf16 rtol 2^-7 on top;
- dgamma, dbeta (f32, over 1,200-76,800 terms a channel): 1e-5 of the
  channel's sum of |dz xhat| and of |dz|, which holds two orders of
  summation of those terms with room;
- a pre-activation within an f32 rounding of 0 may fall on either side of
  the ReLU, and then the element's whole dy passes on one side only: about
  one element in a million parts so (at outputs under 1e-5), and the
  backward is compared with dy zeroed there.
Two calls of the kernel, and a CUDA graph's replay against the eager call,
are equal bit for bit: no atomics, every sum in a fixed order.
"""

import pytest
import torch

from ann3depth_tpu_torch.config import ModelConfig
from ann3depth_tpu_torch.models import encdec, registry
from ann3depth_tpu_torch.ops import group_norm as gn

CL = torch.channels_last
EPS = 1e-6
GROUPS = 8


def _inputs(shape, dtype, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = (2 * torch.randn(shape, generator=gen, device=device) + 0.5).to(
        dtype).contiguous(memory_format=CL)
    w = 1 + 0.5 * torch.randn(c, generator=gen, device=device)
    b = 0.5 * torch.randn(c, generator=gen, device=device)
    dy = torch.randn(shape, generator=gen, device=device).to(
        dtype).contiguous(memory_format=CL)
    return x, w, b, dy


def _run(fn, x, w, b, dy):
    """fn's output and the gradients of <fn(x), dy> in x, w and b."""
    x, w, b = (t.detach().clone().requires_grad_() for t in (x, w, b))
    y = fn(x, w, b, GROUPS, EPS)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))


# ---------------------------------------------------------------------------
# The CPU path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("per_group", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_op_is_the_stage_expression_bit_for_bit(dtype, per_group,
                                                    batch):
    x, w, b, dy = _inputs((batch, GROUPS * per_group, 6, 10), dtype)
    got = _run(gn.group_norm_relu, x, w, b, dy)
    want = _run(gn.plain_group_norm_relu, x, w, b, dy)
    for name, g, v in zip(("y", "dx", "dweight", "dbias"), got, want):
        assert g.dtype == v.dtype and torch.equal(g, v), name
    assert got[0].is_contiguous(memory_format=CL)
    assert got[1].is_contiguous(memory_format=CL)


def test_cpu_statistics_are_the_groups_mean_and_rstd():
    x, w, b, _ = _inputs((3, 32, 5, 7), torch.float32)
    y, mean, rstd = torch.ops.ann3depth.group_norm_relu(x, w, b, GROUPS, EPS)
    var, want = torch.var_mean(x.reshape(3, GROUPS, -1).double(), dim=-1,
                               correction=0)
    torch.testing.assert_close(mean.double(), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(rstd.double(), (var + EPS).rsqrt(), rtol=1e-6,
                               atol=0)


def test_nchw_input_is_made_channels_last_and_counted():
    x, w, b, dy = _inputs((2, 32, 5, 7), torch.bfloat16)
    before = gn.group_norm_relu.relayouts
    got = gn.group_norm_relu(x.contiguous(), w, b, GROUPS, EPS)
    assert gn.group_norm_relu.relayouts == before + 1
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, gn.plain_group_norm_relu(x, w, b, GROUPS, EPS))
    gn.group_norm_relu(x, w, b, GROUPS, EPS)
    assert gn.group_norm_relu.relayouts == before + 1


def test_no_grad_call_skips_autograd():
    x, w, b, _ = _inputs((2, 32, 5, 7), torch.float32)
    w.requires_grad_()
    with torch.no_grad():
        y = gn.group_norm_relu(x, w, b, GROUPS, EPS)
    assert y.grad_fn is None
    assert torch.equal(y, gn.plain_group_norm_relu(x, w.detach(), b, GROUPS,
                                                   EPS))


def test_other_devices_raise():
    x = torch.empty((1, 16, 2, 2), device="meta")
    w = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="device"):
        gn.group_norm_relu(x, w, w, GROUPS, EPS)


def test_fake_outputs_are_channels_last():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((2, 32, 5, 7)).contiguous(memory_format=CL)
        w = torch.empty(32)
        y, mean, rstd = torch.ops.ann3depth.group_norm_relu(x, w, w, GROUPS,
                                                            EPS)
        dx, dw, db = torch.ops.ann3depth.group_norm_relu_backward(
            x, x, y, mean, rstd, w, GROUPS)
    assert y.stride() == dx.stride() == x.stride() == (1120, 1, 224, 32)
    assert y.dtype == x.dtype and mean.shape == rstd.shape == (2, GROUPS)
    assert dw.shape == db.shape == (32,)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ops_pass_opcheck_on_the_cpu(dtype):
    """The schema, and the fake implementations against the CPU ones
    (shapes, dtypes and strides)."""
    x, w, b, dy = _inputs((2, 32, 5, 7), dtype)
    y, mean, rstd = torch.ops.ann3depth.group_norm_relu(x, w, b, GROUPS, EPS)
    utils = ("test_schema", "test_faketensor")
    torch.library.opcheck(torch.ops.ann3depth.group_norm_relu.default,
                          (x, w, b, GROUPS, EPS), test_utils=utils)
    torch.library.opcheck(torch.ops.ann3depth.group_norm_relu_backward
                          .default, (dy, x, y, mean, rstd, w, GROUPS),
                          test_utils=utils)


# The f32 head convs read plain NCHW on the card (encdec.head_input).
HEADS = ("head", "coarse_head", "fine_head")


def _conv_inputs(model):
    """A list that forward pre-hooks on every conv of `model` fill with
    (name, whether the conv's input is channels_last)."""
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, encdec.Conv):
            m.register_forward_pre_hook(
                lambda mod, args, name=name: seen.append(
                    (name, args[0].is_contiguous(memory_format=CL))))
    return seen


@pytest.mark.parametrize("name,quant,convs,head", [
    ("encdec", "none", 13, "head"), ("encdec", "int8-qat", 13, "head"),
    ("multiscale", "none", 12, "fine_head")])
def test_model_keeps_channels_last_from_input_to_head(name, quant, convs,
                                                      head):
    model = registry.build(ModelConfig(name=name, width_mult=0.25,
                                       quant=quant))
    model.init_weights(torch.Generator().manual_seed(0))
    seen = _conv_inputs(model)
    relayouts = gn.group_norm_relu.relayouts
    out = model(torch.randn((2, 32, 48, 3)))
    out.sum().backward()
    assert len(seen) == convs and seen[-1][0] == head
    assert _layouts_hold(seen, heads_nchw=False), seen
    assert gn.group_norm_relu.relayouts == relayouts


def _layouts_hold(seen, heads_nchw=True):
    """Every body conv saw channels_last; every f32 head plain NCHW where
    `heads_nchw` (the card), else channels_last."""
    return all(cl != (heads_nchw and name.split(".")[-1] in HEADS)
               for name, cl in seen)


def test_stage_keeps_channels_last():
    stage = encdec.Stage(16, 32)
    encdec.init_flax_(stage, torch.Generator().manual_seed(0))
    seen = _conv_inputs(stage)
    x = torch.randn((2, 16, 12, 10)).to(torch.bfloat16).contiguous(
        memory_format=CL)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = stage(x)
    assert y.is_contiguous(memory_format=CL) and y.dtype == torch.bfloat16
    assert [n for n, _ in seen] == ["conv_down", "conv_refine"]
    assert all(cl for _, cl in seen)


# The launch plan: pure host arithmetic, the same on every machine.
@pytest.mark.parametrize("shape,itemsize,vec,tiles", [
    ((16, 64, 60, 80), 2, 8, 19), ((16, 128, 30, 40), 2, 8, 19),
    ((16, 256, 15, 20), 2, 8, 19), ((16, 32, 60, 80), 2, 8, 19),
    ((16, 64, 60, 80), 4, 4, 38), ((1, 64, 60, 80), 2, 8, 300),
    ((4, 96, 7, 9), 2, 8, 7)])
def test_launch_plan_covers_the_map_and_fills_the_card(shape, itemsize, vec,
                                                       tiles):
    b, c, h, w = shape
    plan = gn.launch_plan(shape, itemsize, True, 132)
    assert (plan.vec, plan.tiles) == (vec, tiles)
    assert plan.lanes * plan.vec == c and plan.threads <= gn.MAX_THREADS
    assert plan.threads == plan.lanes * plan.prows
    assert plan.tile_px % plan.prows == 0
    assert (plan.tiles - 1) * plan.tile_px < h * w <= plan.tiles * plan.tile_px
    assert b * plan.tiles >= 2 * 132 or plan.tile_px == plan.prows
    assert plan.red_ch * plan.red_blocks >= c
    assert plan.red_ch * (plan.red_blocks - 1) < c


def test_launch_plan_without_alignment_and_too_wide():
    assert gn.launch_plan((2, 64, 4, 4), 2, False, 132).vec == 1
    assert gn.launch_plan((2, 60, 4, 4), 2, True, 132).vec == 1
    for c in (604, 4104):  # 604 lanes (no 16-byte path); 513 lanes
        with pytest.raises(ValueError, match="too wide"):
            gn.launch_plan((2, c, 4, 4), 2, True, 132)


# ---------------------------------------------------------------------------
# The kernel on the card.
# ---------------------------------------------------------------------------

# The encdec train step's three norms at b16 (240x320 in), width 0.5's
# first (C/G 4), the live path's first at b1, and a 480x640 frame's first.
CARD_SHAPES = [(16, 64, 60, 80), (16, 128, 30, 40), (16, 256, 15, 20),
               (16, 32, 60, 80), (1, 64, 60, 80), (4, 64, 120, 160)]


@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off for the test (as `train` runs, and the
    plain f32 path stays f32); the flags are restored after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _card_pair(x_in, x, w, b, dy):
    """The kernel's run on x_in and the plain version's on x (the same
    values): outputs and gradients, with dy zeroed where their ReLU masks
    part. A pre-activation within an f32 rounding of 0 may land on either
    side, and then the whole dy of that element passes on one side only:
    about one element in a million does, and both outputs are ~0 there."""
    with torch.no_grad():
        y_k = gn.group_norm_relu(x_in, w, b, GROUPS, EPS)
        y_p = gn.plain_group_norm_relu(x, w, b, GROUPS, EPS)
    parted = (y_k > 0) != (y_p > 0)
    assert int(parted.sum()) <= 2 + x.numel() // 100_000
    assert float(torch.where(parted, y_k.float() + y_p.float(), 0).max()) \
        <= 1e-5
    dy = torch.where(parted, torch.zeros_like(dy), dy)
    return (_run(gn.group_norm_relu, x_in, w, b, dy),
            _run(gn.plain_group_norm_relu, x, w, b, dy), dy)


def _assert_card_close(got, want, dy, x, dtype):
    y, dx, dw, db = got
    y_w, dx_w, dw_w, db_w = want
    low = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), y_w.float(), rtol=1e-5 + low,
                               atol=1e-5)
    torch.testing.assert_close(
        dx.float(), dx_w.float(), rtol=1e-4 + low,
        atol=1e-4 * float(dx_w.float().abs().max()))
    # dz and xhat from the plain side: the terms of dbeta and dgamma.
    xg = x.float().reshape(x.shape[0], GROUPS, -1)
    var, mean = torch.var_mean(xg, dim=-1, correction=0, keepdim=True)
    xhat = ((xg - mean) * (var + EPS).rsqrt()).reshape(x.shape)
    dz = torch.where(y_w > 0, dy, torch.zeros_like(dy)).float()
    torch.testing.assert_close(db, db_w, rtol=0,
                               atol=float(1e-5 * dz.abs().sum((0, 2, 3)).max()))
    torch.testing.assert_close(
        dw, dw_w, rtol=0,
        atol=float(1e-5 * (dz * xhat).abs().sum((0, 2, 3)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(cuda, shape, dtype):
    x, w, b, dy = _inputs(shape, dtype, cuda, seed=1)
    fwd, bwd = gn.group_norm_relu.launches, gn.group_norm_relu_backward.launches
    got, want, dy = _card_pair(x, x, w, b, dy)
    assert gn.group_norm_relu.launches == fwd + 2
    assert gn.group_norm_relu_backward.launches == bwd + 1
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[0].is_contiguous(memory_format=CL)
    assert got[1].dtype == dtype and got[1].is_contiguous(memory_format=CL)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_card_close(got, want, dy, x, dtype)


@pytest.mark.cuda
def test_kernel_statistics_match_plain(cuda):
    x, w, b, _ = _inputs((16, 128, 30, 40), torch.bfloat16, cuda, seed=2)
    _, mean, rstd = torch.ops.ann3depth.group_norm_relu(x, w, b, GROUPS, EPS)
    var, want = torch.var_mean(x.float().reshape(16, GROUPS, -1), dim=-1,
                               correction=0)
    torch.testing.assert_close(mean, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, (var + EPS).rsqrt(), rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unaligned_and_nchw_inputs(cuda, dtype):
    """A view 2 elements into its storage takes the scalar path; an NCHW
    input is made channels_last and counted."""
    x, w, b, dy = _inputs((4, 64, 30, 40), dtype, cuda, seed=3)
    flat = torch.empty(x.numel() + 2, dtype=dtype, device=cuda)
    shifted = flat[2:].view(4, 30, 40, 64).permute(0, 3, 1, 2)
    shifted.copy_(x)
    assert gn._plan(shifted).vec == 1
    _assert_card_close(*_card_pair(shifted, x, w, b, dy), x, dtype)
    before = gn.group_norm_relu.relayouts
    _assert_card_close(*_card_pair(x.contiguous(), x, w, b, dy), x, dtype)
    assert gn.group_norm_relu.relayouts == before + 2


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, b, _ = _inputs((2, 32, 5, 7), torch.float16, cuda)
    with pytest.raises(ValueError, match="bf16 or f32"):
        gn.group_norm_relu(x, w, b, GROUPS, EPS)
    x = x.float()
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_relu(x, w, b, 5, EPS)
    with pytest.raises(ValueError, match="weight"):
        gn.group_norm_relu(x, w[:16], b[:16], GROUPS, EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES[:3])
def test_two_runs_are_equal_bit_for_bit(cuda, shape):
    x, w, b, dy = _inputs(shape, torch.bfloat16, cuda, seed=4)
    first = _run(gn.group_norm_relu, x, w, b, dy)
    second = _run(gn.group_norm_relu, x, w, b, dy)
    for name, u, v in zip(("y", "dx", "dweight", "dbias"), first, second):
        assert torch.equal(u, v), name


@pytest.mark.cuda
def test_captured_replay_equals_eager(cuda):
    x, w, b, dy = _inputs((16, 128, 30, 40), torch.bfloat16, cuda, seed=5)
    eager = _run(gn.group_norm_relu, x, w, b, dy)
    fwd, bwd = gn.group_norm_relu.launches, gn.group_norm_relu_backward.launches
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _run(gn.group_norm_relu, x, w, b, dy)  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _run(gn.group_norm_relu, x, w, b, dy)
    assert gn.group_norm_relu.launches == fwd + 1  # the warm call only
    assert gn.group_norm_relu_backward.launches == bwd + 1
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for name, u, v in zip(("y", "dx", "dweight", "dbias"), out, eager):
        assert torch.equal(u, v), name


def _card_step(device):
    """make3d-encdec at full width, one b16 step at 240x320 on random
    frames: (state, images, depths)."""
    from ann3depth_tpu_torch.train import step as steplib

    model = registry.build(ModelConfig(name="encdec"))
    model = steplib.init_params(model, (240, 320), 0, device=device)
    tx = steplib.make_optimizer(1e-4, warmup_steps=0, total_steps=10)
    gen = torch.Generator(device=device).manual_seed(6)
    images = torch.randn((16, 240, 320, 3), generator=gen, device=device)
    depths = 1 + 59 * torch.rand((16, 120, 160), generator=gen,
                                 device=device)
    return steplib.TrainState.create(model, tx), images, depths


@pytest.mark.cuda
def test_train_step_convs_see_channels_last_and_run_the_kernel(cuda):
    from ann3depth_tpu_torch.train import step as steplib

    state, images, depths = _card_step(cuda)
    seen = _conv_inputs(state.model)
    fwd, bwd = gn.group_norm_relu.launches, gn.group_norm_relu_backward.launches
    relayouts = gn.group_norm_relu.relayouts
    _, metrics = steplib.step_on_batch(state, images, depths)
    assert bool(torch.isfinite(metrics["loss"]))
    assert len(seen) == 13
    assert _layouts_hold(seen), seen
    assert gn.group_norm_relu.launches == fwd + 3
    assert gn.group_norm_relu_backward.launches == bwd + 3
    assert gn.group_norm_relu.relayouts == relayouts


@pytest.mark.cuda
def test_train_steps_repeat_bit_for_bit(cuda):
    """Two runs of three encdec train steps from one state and batch end
    bit for bit alike: the kernel sums in a fixed order, and the f32 head
    reads NCHW (on channels_last input cuDNN's f32 weight gradient sums
    with atomics)."""
    from ann3depth_tpu_torch.train import step as steplib

    runs = []
    for _ in range(2):
        state, images, depths = _card_step(cuda)
        for _ in range(3):
            state, metrics = steplib.step_on_batch(state, images, depths)
        runs.append([p.detach().clone() for p in state.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_multiscale_runs_the_kernel_channels_last(cuda):
    """make3d-multiscale's five Stages at b4, 240x320: five calls each way,
    every conv fed channels_last, no relayout."""
    model = registry.build(ModelConfig(name="multiscale"))
    model = model.init_weights(torch.Generator().manual_seed(0)).to(cuda)
    seen = _conv_inputs(model)
    fwd, bwd = gn.group_norm_relu.launches, gn.group_norm_relu_backward.launches
    relayouts = gn.group_norm_relu.relayouts
    out = model(torch.randn((4, 240, 320, 3), device=cuda))
    out.sum().backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert len(seen) == 12 and _layouts_hold(seen), seen
    assert gn.group_norm_relu.launches == fwd + 5
    assert gn.group_norm_relu_backward.launches == bwd + 5
    assert gn.group_norm_relu.relayouts == relayouts


@pytest.mark.cuda
def test_profiled_train_step_has_no_bf16_layout_transposes(cuda):
    """cuDNN's NCHW<->NHWC transposes ran around every conv after the first
    norm while torch's group_norm returned NCHW; the kernel's four passes
    run three times a step each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ann3depth_tpu_torch.train import step as steplib

    state, images, depths = _card_step(cuda)
    steplib.step_on_batch(state, images, depths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steplib.step_on_batch(state, images, depths)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    transposes = [n for n in names
                  if ("nchwToNhwc" in n or "nhwcToNchw" in n)
                  and "bfloat16" in n]
    assert not transposes, transposes
    for kernel in ("gn_stats_kernel", "gn_apply_kernel",
                   "gn_bwd_stats_kernel", "gn_bwd_apply_kernel"):
        assert sum(kernel + "<" in n for n in names) == 3, kernel
