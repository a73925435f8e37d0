"""The update of a train step on the card: optax's global-norm clip folded
into AdamW (ops/adamw_clip.py, csrc/adamw_clip.cu), and the benchmark's
reader of it.

On the CPU the ops run their plain versions, per-leaf torch code in the
order of torch's capturable foreach AdamW. They are held here to
`torch.optim.AdamW` (or `Adam`) after `global_norm` and torch's clip, the
path the port takes on the CPU. Given the same norm, m and v come out equal
bit for bit (the same f32 ops in the same order). p does not: torch's CPU
step takes its bias corrections in f64 (`1 - 0.999 ** t` as a Python
float), the capturable arithmetic in f32, where `b2^t - 1` loses up to
2^-24 / (1 - b2^t) of its value (6e-5 at t = 1). So each step's update may
differ by up to 2^-12 of the learning rate (an update is at most a few
times lr early in training), and p's own rounding by half an ulp of p:
p is held within the sum of 2^-23 |p| + 2^-12 lr over the steps. The norm
(squares summed in f64) is held to `global_norm` (f32 sums) within rel
1e-6. The registered ops' fake kernels give their outputs; the chunk
table and what the ops take are checked before a launch.
`update_roofline.train` counts a step's bytes from the configuration and
reads only the two kernels.

The tests marked `cuda` need a card and skip without one (this file imports
neither JAX nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adamw_clip.py

On the card the kernels are held to torch's capturable foreach AdamW
(`foreach=True, capturable=True`, the port's path before the kernels)
after `global_norm` and `_foreach_mul_`. Given torch's norm (`norm=`), p,
m, v and the step counts agree bit for bit after 5 updates, 0 ulps: each
element runs torch's foreach ops one by one, each rounded to f32 once
(`__f*_rn`, no fused multiply-add), with the bias corrections from the
same device `powf` of the f32 step. The kernels' own norm sums squares in
f64 and rounds once, where `global_norm` sums each leaf in f32: held
within rel 1e-6. Two runs, and a CUDA graph's replay against its eager
twin, agree bit for bit: the norm's partials are summed in a fixed order,
with no float atomics.
"""

import importlib.util
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ann3depth_tpu_torch.ops import adamw_clip
from ann3depth_tpu_torch.train import step as steplib
from portbench import spec
from portbench.trace import TraceSummary

ROOT = Path(__file__).resolve().parents[1]
STEPS = 5
LR = 1e-3  # step s takes LR * (s + 1)
CHUNK = adamw_clip.CHUNK
# Leaves the kernels treat apart: 0 and 1 elements, tails of 1-3 after
# 16-byte vectors, a chunk and one more, a ragged leaf of several chunks.
ODD = [(0,), (1,), (3,), (5,), (17,), (4097,), (CHUNK - 1,), (CHUNK,),
       (CHUNK + 1,), (3, CHUNK + 7), (64, 1024)]
# Demangled names of the two kernels as a profiler reports them.
KERNEL_NAMES = [
    "(anonymous namespace)::adamw_clip_sumsq_kernel((anonymous namespace)"
    "::SumsqArgs, double*, unsigned int*, float*, int, int)",
    "(anonymous namespace)::adamw_clip_update_kernel((anonymous namespace)"
    "::UpdateArgs, float const*, float const*, unsigned int*, (anonymous "
    "namespace)::Hyper)"]
# (optimizer, weight decay): adamw with and without decay, and adam.
RULES = [("adamw", 1e-2), ("adamw", 0.0), ("adam", 0.0)]
# clip_norm: active (norms are about 10^2-10^4), inactive, off.
CLIPS = {"active": 1.0, "inactive": 1e9, "off": 0.0}


def _optimizer(cls_name, params, wd, lr, **kw):
    kind = {"adamw": torch.optim.AdamW, "adam": torch.optim.Adam,
            "clipped_adamw": steplib.ClippedAdamW,
            "clipped_adam": steplib.ClippedAdam}[cls_name]
    if wd:
        kw["weight_decay"] = wd
    return kind(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, **kw)


def _leaves(shapes, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=device) for s in shapes]


def _grads(shapes, gen, device, unaligned=False):
    """One step's gradients: contiguous leaves, or (`unaligned`) views of
    one buffer from its second element on, as ZeRO-1's chunks are."""
    if not unaligned:
        return [torch.randn(s, generator=gen, device=device) for s in shapes]
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = torch.randn(1 + sum(sizes), generator=gen, device=device)
    return [v.view(s) for v, s in zip(flat[1:].split(sizes), shapes)]


def _torch_update(opt, params, grads, clip_norm, norm=None):
    """The port's path before the kernels: global_norm, torch's clip,
    `opt.step()`; returns global_norm's norm. `norm`: the factor's norm
    in its place."""
    for p, g in zip(params, grads):
        p.grad = g.clone()
    tg = [p.grad for p in params]
    own = steplib.global_norm(tg)
    if clip_norm > 0:
        torch._foreach_mul_(tg, adamw_clip.clip_factor(
            own if norm is None else norm, clip_norm))
    opt.step()
    return own


def _ulps(a, b):
    ia, ib = (t.reshape(-1).view(torch.int32).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _reader_module():
    path = ROOT / "portbench" / "metrics" / "update_roofline.train.py"
    module_spec = importlib.util.spec_from_file_location(
        "update_roofline_train", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# The CPU path.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("rule,wd", RULES)
def test_plain_update_matches_torch_after_global_norm(rule, wd, clip):
    """5 updates of ClippedAdamW's `clipped_step` (the plain versions on the
    CPU) against torch's AdamW after global_norm and the clip: the norm
    within rel 1e-6, m, v and the step counts bit for bit given torch's
    norm, p within the bound of the module's note."""
    clip_norm = CLIPS[clip]
    p0 = _leaves(ODD, "cpu")
    mine = [torch.nn.Parameter(p.clone()) for p in p0]
    theirs = [torch.nn.Parameter(p.clone()) for p in p0]
    ours = _optimizer(f"clipped_{rule}", mine, wd, torch.tensor(LR))
    ref = _optimizer(rule, theirs, wd, LR)
    gen = torch.Generator().manual_seed(1)
    lr_sum = 0.0
    for s in range(STEPS):
        lr = LR * (s + 1)
        lr_sum += lr
        ours.param_groups[0]["lr"].fill_(lr)
        ref.param_groups[0]["lr"] = lr
        grads = _grads(ODD, gen, "cpu")
        for p, g in zip(mine, grads):
            p.grad = g
        own = adamw_clip.plain_sumsq(grads)
        norm = _torch_update(ref, theirs, grads, clip_norm)
        assert abs(float(own) - float(norm)) <= 1e-6 * float(norm)
        got = ours.clipped_step(clip_norm, norm=norm)
        assert got is norm
        if clip == "active":
            assert float(norm) > 10 * clip_norm  # the clip acts
    for a, b in zip(mine, theirs):
        sa, sb = ours.state[a], ref.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert float(sa["step"]) == float(sb["step"]) == STEPS
        bound = (STEPS * 2.0 ** -23 * torch.maximum(a.abs(), b.abs())
                 + 2.0 ** -12 * lr_sum)
        assert bool(((a - b).abs() <= bound).all()), \
            float((a - b).abs().max())
    # No `.grad` was written: the last step's gradients are unscaled.
    assert all(torch.equal(p.grad, g) for p, g in zip(mine, grads))


def test_own_norm_is_the_f64_sum_of_squares_rounded_once():
    grads = _grads(ODD, torch.Generator().manual_seed(3), "cpu")
    want = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    got = adamw_clip.adamw_clip_sumsq(grads)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(torch.tensor(want, dtype=torch.float32))


@pytest.mark.parametrize("norm,clip_norm,want", [
    (4.0, 2.0, 0.5), (2.0, 2.0, 1.0), (1.0, 2.0, 1.0), (4.0, 0.0, 1.0),
    (4.0, -1.0, 1.0), (0.0, 2.0, 1.0)])
def test_clip_factor_is_optax_where(norm, clip_norm, want):
    """optax's where(norm < clip, 1, clip / norm); 1 without a clip."""
    got = adamw_clip.clip_factor(torch.tensor(norm), clip_norm)
    assert float(got) == want


def test_cpu_update_rule_steps_torch_bit_for_bit():
    """On the CPU, UpdateRule.apply with the port's adamw clips `.grad` and
    runs torch's AdamW.step, as it did before the kernels."""
    rule = steplib.make_inner_optimizer(lambda c: 1e-3, "adamw",
                                        weight_decay=1e-2)
    rule = steplib.UpdateRule(build=rule.build, schedule=rule.schedule,
                              clip_norm=1.0)
    p0 = _leaves(ODD, "cpu")
    mine = [torch.nn.Parameter(p.clone()) for p in p0]
    theirs = [torch.nn.Parameter(p.clone()) for p in p0]
    ours = rule.init(mine)
    assert isinstance(ours, steplib.ClippedAdamW)
    ref = _optimizer("adamw", theirs, 1e-2, 1e-3)
    gen = torch.Generator().manual_seed(2)
    for s in range(3):
        grads = _grads(ODD, gen, "cpu")
        for p, g in zip(mine, grads):
            p.grad = g.clone()
        norm = rule.apply(ours, s)
        assert torch.equal(norm, _torch_update(ref, theirs, grads, 1.0))
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
        assert torch.equal(ours.state[a]["exp_avg_sq"],
                           ref.state[b]["exp_avg_sq"])


def test_the_ops_fake_kernels_give_the_outputs():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        g = [torch.empty(3), torch.empty(5, 7)]
        norm = torch.ops.ann3depth.adamw_clip_sumsq(g)
        assert norm.shape == () and norm.dtype == torch.float32
        steps = [torch.empty(()), torch.empty(())]
        out = torch.ops.ann3depth.adamw_clip_update(
            g, g, g, g, steps, torch.empty(()), norm, 1.0, 0.9, 0.999,
            1e-8, 0.0)
        assert out is None


def _update_args(**change):
    leaves = dict(params=[torch.zeros(3), torch.zeros(0), torch.zeros(5)],
                  grads=[torch.zeros(3), torch.zeros(0), torch.zeros(5)],
                  exp_avgs=[torch.zeros(3), torch.zeros(0), torch.zeros(5)],
                  exp_avg_sqs=[torch.zeros(3), torch.zeros(0),
                               torch.zeros(5)],
                  steps=[torch.zeros(()) for _ in range(3)],
                  lr=torch.tensor(1e-3), norm=torch.tensor(1.0))
    leaves.update(change)
    return leaves


@pytest.mark.parametrize("change,match", [
    (dict(grads=[torch.zeros(3), torch.zeros(0),
                 torch.zeros(5, dtype=torch.bfloat16)]),
     r"f32 leaves, got grads\[2\]"),
    (dict(exp_avgs=[torch.zeros(3), torch.zeros(0),
                    torch.zeros(5, dtype=torch.float64)]),
     r"f32 leaves, got exp_avgs\[2\]"),
    (dict(params=[torch.zeros(3), torch.zeros(0),
                  torch.zeros(5, device="meta")]),
     r"one device \(cpu\), got params\[2\]"),
    (dict(exp_avg_sqs=[torch.zeros(3), torch.zeros(0),
                       torch.zeros(5, 2).t()[0]]),
     r"contiguous leaves, got exp_avg_sqs\[2\]"),
    (dict(grads=[torch.zeros(3), torch.zeros(0), torch.zeros(6)]),
     r"leaf 2's param, grad, exp_avg and exp_avg_sq hold \[5, 6, 5, 5\]"),
    (dict(steps=[torch.zeros(()), torch.zeros(2), torch.zeros(())]),
     r"one-element steps\[1\]"),
    (dict(lr=torch.zeros(2)), "one-element lr"),
    (dict(steps=[torch.zeros(())]), "3 params, 3 grads"),
    (dict(norm=torch.zeros((), dtype=torch.float64)),
     r"f32 leaves, got norm\[0\]")])
def test_update_arguments_are_checked_before_a_launch(change, match):
    with pytest.raises(ValueError, match=match):
        adamw_clip._check_update(**_update_args(**change))


@pytest.mark.parametrize("grads,match", [
    ([torch.zeros(3), torch.zeros(2, dtype=torch.float16)],
     r"f32 leaves, got grads\[1\]"),
    ([torch.zeros(3), torch.zeros(2, device="meta")], "one device"),
    ([torch.zeros(4, 4).t()], "contiguous"),
    ([], "no leaf")])
def test_sumsq_arguments_are_checked(grads, match):
    with pytest.raises(ValueError, match=match):
        adamw_clip._check("adamw_clip_sumsq", grads=grads)


def test_zero_element_and_odd_leaves_update_in_place():
    """0-element and odd-sized leaves: the 0-element leaf is left alone
    but for its step count; every other one moves."""
    args = _update_args(grads=[torch.ones(3), torch.zeros(0),
                               torch.ones(5)])
    before = [p.clone() for p in args["params"]]
    adamw_clip.adamw_clip_update(*args.values(), 1.0, 0.9, 0.999, 1e-8,
                                 0.0)
    assert [float(t) for t in args["steps"]] == [1.0, 1.0, 1.0]
    assert args["params"][1].numel() == 0
    for i in (0, 2):
        assert bool((args["params"][i] != before[i]).all())
        assert bool((args["exp_avgs"][i] != 0).all())


def test_a_leaf_that_is_not_f32_raises_naming_it():
    params = [torch.nn.Parameter(torch.zeros(3)),
              torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))]
    opt = _optimizer("clipped_adamw", params, 0.0, torch.tensor(LR))
    for p in params:
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match=r"grads\[1\] \(torch.bfloat16"):
        opt.clipped_step(1.0)


def _leaf_of(first, c):
    """The kernels' Chunks::leaf_of: the last leaf with first[i] <= c."""
    lo, hi = 0, len(first) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= c:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("sizes", [
    [5], [0, 1, CHUNK, CHUNK + 1, 0, 3 * CHUNK, 7, 0],
    [torch.Size(s).numel() for s in ODD], [0, 0, 4]])
def test_chunk_table_covers_each_leaf_once(sizes):
    """Each leaf of n elements holds ceil(n / CHUNK) chunks; the kernels'
    search maps each chunk back to its leaf, and the chunks of a leaf cover
    its elements once, the last one ragged."""
    first = adamw_clip.chunk_table(sizes)
    assert first.dtype == np.int32 and len(first) == len(sizes) + 1
    assert first[0] == 0
    assert list(np.diff(first)) == [-(-n // CHUNK) for n in sizes]
    covered = [0] * len(sizes)
    for c in range(int(first[-1])):
        leaf = _leaf_of(first, c)
        assert first[leaf] <= c < first[leaf + 1]
        begin = (c - first[leaf]) * CHUNK
        covered[leaf] += min(CHUNK, sizes[leaf] - begin)
    assert covered == list(sizes)


def test_chunk_table_refuses_more_chunks_than_32_bits():
    with pytest.raises(ValueError, match="too many"):
        adamw_clip.chunk_table([CHUNK * 2 ** 30, CHUNK * 2 ** 30])


# ---------------------------------------------------------------------------
# The benchmark's reader.
# ---------------------------------------------------------------------------

def test_reader_counts_a_steps_bytes_from_the_configuration():
    config = json.loads((ROOT / "portbench/configs/dpt-large.json")
                        .read_text())
    assert config["arch"]["params"] == 341_848_257
    assert _reader_module().step_bytes(config["arch"]) == 10_939_144_224


def test_reader_reads_its_kernels_and_none_without_them():
    read = spec.reader("update_roofline.train")
    ctx = {"kind": "train", "batch": 16, "traced_steps": 20}
    by_name = {KERNEL_NAMES[0]: 0.02, KERNEL_NAMES[1]: 0.06,
               "nvjet_tst_128x192_64x5_1x2_h_bz_coopB_NNN": 0.5}
    full = read(dict(ctx, trace=TraceSummary(1.0, 1.0, by_name, [])))
    assert full == pytest.approx(100 * 10_939_144_224 * 20 / 0.08 / 3.35e12)
    torch_adamw = {
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
        "<at::native::(anonymous namespace)::TensorListMetadata<4>>": 0.18}
    bare = TraceSummary(1.0, 1.0, torch_adamw, [])
    assert read(dict(ctx, trace=bare)) is None
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, kind="serve",
                     trace=TraceSummary(1.0, 1.0, by_name, []))) is None


def test_other_readers_do_not_take_the_kernels():
    ctx = {"kind": "train", "batch": 16, "traced_steps": 20,
           "trace": TraceSummary(1.0, 1.0, dict.fromkeys(KERNEL_NAMES, 0.01),
                                 [])}
    for name in ("conv_roofline.train", "attention_roofline.train",
                 "upsample_roofline.train", "preprocess_roofline.train"):
        assert spec.reader(name)(dict(ctx, preprocess_bound_s=1e-5)) is None


# ---------------------------------------------------------------------------
# The kernels on the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _dpt_large_shapes():
    """DPT-Large's 360 leaves, 341,848,257 parameters (its position
    embedding at 384x384's 577 tokens)."""
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.models import registry

    with torch.device("meta"):
        model = registry.build(get_config("dpt-large").model)
    shapes = [(1, 577, 1024) if name == "pos_embed" else tuple(p.shape)
              for name, p in model.named_parameters()]
    assert sum(torch.Size(s).numel() for s in shapes) == 341_848_257
    return shapes


def _pair(cuda, shapes, rule, wd):
    """(kernel params, ClippedAdamW/Adam, torch params, torch's capturable
    foreach optimizer) from one set of leaves."""
    p0 = _leaves(shapes, cuda, seed=1)
    mine = [torch.nn.Parameter(p.clone()) for p in p0]
    theirs = [torch.nn.Parameter(p) for p in p0]
    lr = torch.full((), LR, device=cuda)
    ours = _optimizer(f"clipped_{rule}", mine, wd, lr, capturable=True)
    ref = _optimizer(rule, theirs, wd, lr.clone(), capturable=True,
                     foreach=True)
    return mine, ours, theirs, ref


def _set_lr(opts, lr):
    for opt in opts:
        opt.param_groups[0]["lr"].fill_(lr)


def _assert_states_equal(mine, ours, theirs, ref):
    for a, b in zip(mine, theirs):
        assert _ulps(a.detach(), b.detach()) == 0
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert _ulps(ours.state[a][key], ref.state[b][key]) == 0, key


CARD_CASES = [("odd", rule, wd, clip) for rule, wd in RULES for clip in CLIPS]
CARD_CASES += [("odd_unaligned", "adamw", 1e-2, "active"),
               ("odd_unaligned", "adam", 0.0, "inactive"),
               ("many", "adamw", 1e-2, "active"),
               ("dpt_large", "adamw", 1e-2, "active"),
               ("dpt_large", "adamw", 0.0, "off")]
# More leaves than one launch takes (512): each kernel launches three times,
# the sum of squares adding to its partials.
MANY = [(3,), (CHUNK + 1,), (1,)] * 400


@pytest.mark.cuda
@pytest.mark.parametrize("leaves,rule,wd,clip", CARD_CASES)
def test_five_updates_match_torch_capturable_foreach(cuda, leaves, rule, wd,
                                                     clip):
    shapes = (_dpt_large_shapes() if leaves == "dpt_large" else
              MANY if leaves == "many" else ODD)
    mine, ours, theirs, ref = _pair(cuda, shapes, rule, wd)
    gen = torch.Generator(device=cuda).manual_seed(2)
    sumsq = adamw_clip.adamw_clip_sumsq.launches
    update = adamw_clip.adamw_clip_update.launches
    for s in range(STEPS):
        _set_lr((ours, ref), LR * (s + 1))
        grads = _grads(shapes, gen, cuda, leaves == "odd_unaligned")
        for p, g in zip(mine, grads):
            p.grad = g
        own = adamw_clip.adamw_clip_sumsq(grads)
        norm = _torch_update(ref, theirs, grads, CLIPS[clip])
        assert ours.clipped_step(CLIPS[clip], norm=norm) is norm
        assert abs(float(own) - float(norm)) <= 1e-6 * float(norm)
    torch.cuda.synchronize()
    assert adamw_clip.adamw_clip_sumsq.launches == sumsq + STEPS
    assert adamw_clip.adamw_clip_update.launches == update + STEPS
    _assert_states_equal(mine, ours, theirs, ref)
    assert all(torch.equal(p.grad, g) for p, g in zip(mine, grads))


@pytest.mark.cuda
def test_two_runs_agree_bit_for_bit(cuda):
    shapes = _dpt_large_shapes()[:120]
    runs = []
    for _ in range(2):
        mine, ours, _, _ = _pair(cuda, shapes, "adamw", 1e-2)
        gen = torch.Generator(device=cuda).manual_seed(4)
        norms = []
        for _ in range(3):
            for p, g in zip(mine, _grads(shapes, gen, cuda)):
                p.grad = g
            norms.append(ours.clipped_step(1.0))
        runs.append(([p.detach() for p in mine], torch.stack(norms)))
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))


def _captured(cuda, shapes):
    """An eager ClippedAdamW and its twin whose update is a CUDA graph's
    replay, stepped on the same gradients: (eager params and norms, graph
    params and norms, launches counted during the capture)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    steps = [_grads(shapes, gen, cuda) for _ in range(4)]
    eager, opt_e, _, _ = _pair(cuda, shapes, "adamw", 1e-2)
    graphed, opt_g, _, _ = _pair(cuda, shapes, "adamw", 1e-2)
    norms_e = []
    for grads in steps:
        for p, g in zip(eager, grads):
            p.grad = g
        norms_e.append(opt_e.clipped_step(1.0).clone())
    for p in graphed:
        p.grad = torch.zeros_like(p)
    for p, g in zip(graphed, steps[0]):
        p.grad.copy_(g)
    opt_g.clipped_step(1.0)  # the first step eagerly makes the state
    before = (adamw_clip.adamw_clip_sumsq.launches,
              adamw_clip.adamw_clip_update.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        norm = opt_g.clipped_step(1.0)
    during = (adamw_clip.adamw_clip_sumsq.launches - before[0],
              adamw_clip.adamw_clip_update.launches - before[1])
    norms_g = [None]
    for grads in steps[1:]:
        for p, g in zip(graphed, grads):
            p.grad.copy_(g)
        graph.replay()
        norms_g.append(norm.clone())
    torch.cuda.synchronize()
    return (eager, norms_e, opt_e), (graphed, norms_g, opt_g), during


@pytest.mark.cuda
def test_captured_replay_equals_eager(cuda):
    (eager, norms_e, opt_e), (graphed, norms_g, opt_g), _ = _captured(
        cuda, ODD + _dpt_large_shapes()[:40])
    assert all(torch.equal(a, b) for a, b in zip(norms_e[1:], norms_g[1:]))
    _assert_states_equal(eager, opt_e, graphed, opt_g)


@pytest.mark.cuda
def test_launch_counters_count_outside_capture_only(cuda):
    before = (adamw_clip.adamw_clip_sumsq.launches,
              adamw_clip.adamw_clip_update.launches)
    _, _, during = _captured(cuda, ODD)
    assert during == (0, 0)
    # 4 eager steps and the graph's twin's first step; 3 replays count 0.
    assert (adamw_clip.adamw_clip_sumsq.launches - before[0],
            adamw_clip.adamw_clip_update.launches - before[1]) == (5, 5)


@pytest.mark.cuda
def test_a_given_norm_launches_no_sum_and_clips_by_it(cuda):
    """ZeRO-1 and tensor parallelism give the norm (`norm=`): no sum of
    squares is launched and the clip factor is the given norm's."""
    mine, ours, theirs, ref = _pair(cuda, ODD, "adamw", 1e-2)
    gen = torch.Generator(device=cuda).manual_seed(6)
    sumsq = adamw_clip.adamw_clip_sumsq.launches
    for given in (3.0, 1e4, 0.5):
        grads = _grads(ODD, gen, cuda)
        for p, g in zip(mine, grads):
            p.grad = g
        norm = torch.tensor(given, device=cuda)
        ours.clipped_step(2.0, norm=norm)
        _torch_update(ref, theirs, grads, 2.0, norm=norm)
    torch.cuda.synchronize()
    assert adamw_clip.adamw_clip_sumsq.launches == sumsq
    _assert_states_equal(mine, ours, theirs, ref)


@pytest.mark.cuda
def test_update_rule_runs_the_kernels_on_the_card(cuda):
    """UpdateRule.apply of the port's adamw on the card: one launch of each
    kernel, `.grad` unscaled, the norm returned."""
    rule = steplib.make_inner_optimizer(lambda c: 1e-3, "adamw",
                                        weight_decay=1e-2)
    rule = steplib.UpdateRule(build=rule.build, schedule=rule.schedule,
                              clip_norm=1.0)
    params = [torch.nn.Parameter(p) for p in _leaves(ODD, cuda)]
    opt = rule.init(params)
    assert isinstance(opt, steplib.ClippedAdamW)
    grads = _grads(ODD, torch.Generator(device=cuda).manual_seed(7), cuda)
    for p, g in zip(params, grads):
        p.grad = g.clone()
    launches = (adamw_clip.adamw_clip_sumsq.launches,
                adamw_clip.adamw_clip_update.launches)
    norm = rule.apply(opt, 0)
    torch.cuda.synchronize()
    assert (adamw_clip.adamw_clip_sumsq.launches - launches[0],
            adamw_clip.adamw_clip_update.launches - launches[1]) == (1, 1)
    assert abs(float(norm) - float(steplib.global_norm(grads))) \
        <= 1e-6 * float(norm)
    assert all(torch.equal(p.grad, g) for p, g in zip(params, grads))
    bf16 = torch.nn.Parameter(torch.zeros(4, device=cuda,
                                          dtype=torch.bfloat16))
    bf16.grad = torch.ones_like(bf16)
    opt.add_param_group({"params": [bf16]})
    with pytest.raises(ValueError, match=r"torch.bfloat16"):
        rule.apply(opt, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["kernels_to_torch",
                                       "torch_to_kernels"])
def test_optimizer_state_loads_both_ways(cuda, direction):
    """A state_dict written by one side loads into the other
    (`load_optimizer_state`, as a checkpoint does), and both go on equal."""
    mine, ours, theirs, ref = _pair(cuda, ODD, "adamw", 1e-2)
    writer, reader = (ours, ref) if direction == "kernels_to_torch" \
        else (ref, ours)
    wparams, rparams = (mine, theirs) if writer is ours else (theirs, mine)
    gen = torch.Generator(device=cuda).manual_seed(8)
    for _ in range(2):
        grads = _grads(ODD, gen, cuda)
        if writer is ours:
            for p, g in zip(mine, grads):
                p.grad = g
            ours.clipped_step(1.0, norm=steplib.global_norm(grads))
        else:
            _torch_update(ref, theirs, grads, 1.0)
    with torch.no_grad():
        for a, b in zip(rparams, wparams):
            a.copy_(b)
    saved = io.BytesIO()  # a checkpoint's copy: no tensor shared
    torch.save(writer.state_dict(), saved)
    saved.seek(0)
    steplib.load_optimizer_state(reader, torch.load(saved))
    for _ in range(2):
        grads = _grads(ODD, gen, cuda)
        for p, g in zip(mine, grads):
            p.grad = g
        norm = _torch_update(ref, theirs, grads, 1.0)
        ours.clipped_step(1.0, norm=norm)
    torch.cuda.synchronize()
    _assert_states_equal(mine, ours, theirs, ref)
