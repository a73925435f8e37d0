"""The update of a train step: optax's global-norm clip folded into AdamW
(or Adam, which is AdamW without decay), as two hand-written CUDA kernels
(csrc/adamw_clip.cu).

`adamw_clip_sumsq(grads)` gives the global norm of the gradients (a device
f32 scalar: sqrt of the sum of every element's square) in one launch.
`adamw_clip_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm,
clip_norm, beta1, beta2, eps, weight_decay)` then makes one pass over each
leaf's (p, g, m, v): it scales g by optax's clip factor, `(1 / norm) *
clip_norm` where norm is not under clip_norm (clip_norm <= 0: no clip),
and follows torch's capturable foreach AdamW op for op (each leaf's step
count `steps`, a one-element f32 tensor, incremented first; `lr`, a device
scalar; decoupled decay by `weight_decay`). p, m, v and the steps change in
place; `.grad` keeps the unscaled gradient.

Both are registered torch ops, `torch.ops.ann3depth.adamw_clip_sumsq` and
`adamw_clip_update`. On CUDA tensors they launch the kernels (every leaf f32,
contiguous and on one device, else ValueError; they never fall back); on
CPU tensors they run the plain versions, `plain_sumsq` and `plain_update`,
per-leaf torch code that repeats the kernels' arithmetic. The port's
optimizers (train/step.py `ClippedAdamW`, `ClippedAdam`) call them on the
card; on the CPU they step as torch's AdamW does. `adamw_clip_sumsq.
launches` and `adamw_clip_update.launches` count the calls outside CUDA
graph capture (a call launches one kernel for every 512 leaves).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ann3depth_tpu_torch.ops import _kernels

CHUNK = 16384        # elements of a leaf a block takes at a time
BLOCKS_PER_SM = 4    # the kernels' fixed grid, per SM


def chunk_table(sizes) -> np.ndarray:
    """The kernels' table of the leaves of `sizes` (element counts): leaf i
    holds chunks [first[i], first[i + 1]) of CHUNK elements, its last one
    ragged; a leaf of 0 elements holds none. n + 1 int32 entries."""
    counts = [-(-int(n) // CHUNK) for n in sizes]
    if sum(counts) >= 2 ** 31:
        raise ValueError(f"adamw_clip: {sum(counts)} chunks of {CHUNK} "
                         "elements are too many for the kernels")
    first = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=first[1:])
    return first


def plain_sumsq(grads):
    """The global norm in plain torch: each leaf's squares summed in f64,
    the leaves' sums added in f64, the square root rounded to f32."""
    _check("adamw_clip_sumsq", grads=grads)
    total = sum(g.double().square().sum() for g in grads)
    return torch.sqrt(total).float()


def clip_factor(norm, clip_norm):
    """optax's clip of gradients of global norm `norm` (an f32 tensor) as
    the port computes it: 1 where norm < clip_norm, else (1 / norm) *
    clip_norm; 1 where clip_norm <= 0."""
    if clip_norm <= 0:
        return torch.ones_like(norm)
    return torch.where(norm < clip_norm, torch.ones_like(norm),
                       clip_norm / norm)


@torch.no_grad()
def plain_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm,
                 clip_norm, beta1, beta2, eps, weight_decay):
    """The update in plain torch, leaf by leaf: the kernels' arithmetic,
    each step a torch op on f32 tensors in torch's capturable foreach
    AdamW's order (torch/optim/adam.py, _multi_tensor_adam)."""
    _check_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm)
    lr = lr.reshape(())
    factor = clip_factor(norm.reshape(()), clip_norm)
    keep = 1 - lr * weight_decay
    for p, g, m, v, t in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        t.add_(1)
        g = g * factor
        if weight_decay:
            p.mul_(keep)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        step_size = ((torch.pow(beta1, t) - 1) / lr).reciprocal()
        bc2_sqrt = (-(torch.pow(beta2, t) - 1)).sqrt()
        p.add_(m / ((v.sqrt() / bc2_sqrt + eps) / step_size))


def _check(op, **lists):
    """Raise unless every tensor of the named lists is f32, contiguous and
    on the first one's device, and there is one."""
    device = None
    for what, tensors in lists.items():
        for i, t in enumerate(tensors):
            leaf = f"{what}[{i}] ({t.dtype}, {tuple(t.shape)}, {t.device})"
            if t.dtype != torch.float32:
                raise ValueError(f"{op} takes f32 leaves, got {leaf}")
            device = t.device if device is None else device
            if t.device != device:
                raise ValueError(f"{op} takes leaves on one device "
                                 f"({device}), got {leaf}")
            if not t.is_contiguous():
                raise ValueError(f"{op} takes contiguous leaves, got {leaf} "
                                 f"with strides {t.stride()}")
    if device is None:
        raise ValueError(f"{op}: no leaf")


def _check_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm):
    op = "adamw_clip_update"
    _check(op, params=params, grads=grads, exp_avgs=exp_avgs,
           exp_avg_sqs=exp_avg_sqs, steps=steps, lr=[lr], norm=[norm])
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(steps)
            == n):
        raise ValueError(f"{op}: {n} params, {len(grads)} grads, "
                         f"{len(exp_avgs)} exp_avgs, {len(exp_avg_sqs)} "
                         f"exp_avg_sqs and {len(steps)} steps")
    for i, leaf in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs)):
        if len({t.numel() for t in leaf}) != 1:
            raise ValueError(f"{op}: leaf {i}'s param, grad, exp_avg and "
                             f"exp_avg_sq hold {[t.numel() for t in leaf]} "
                             "elements")
    for what, t in [*((f"steps[{i}]", s) for i, s in enumerate(steps)),
                    ("lr", lr), ("norm", norm)]:
        if t.numel() != 1:
            raise ValueError(f"{op} takes one-element {what}, got "
                             f"{tuple(t.shape)}")


_KERNEL = _kernels.bind("adamw_clip", {
    "sumsq": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 2 + [ctypes.c_int],
    "update": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
              + [ctypes.c_int] + [ctypes.c_float] * 7})

# {device: f64 [grid + 1]}: the sum of squares' block partials, then the
# bits of two counters (sumsq's, update's) that the kernels leave at 0.
_WORKSPACE: dict = {}


def _workspace(device):
    ws = _WORKSPACE.get(device)
    if ws is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = BLOCKS_PER_SM * sms
        ws = _WORKSPACE[device] = torch.zeros(grid + 1, dtype=torch.float64,
                                              device=device)
    return ws, ws.numel() - 1


def _table(tensors):
    """Host arrays of the leaves' pointers ([n] or [n, k]) and sizes, and
    their chunk table."""
    sizes = np.array([t[0].numel() for t in tensors], dtype=np.int64)
    ptrs = np.array([[x.data_ptr() for x in t] for t in tensors],
                    dtype=np.uint64)
    return ptrs, sizes, chunk_table(sizes)


def _sumsq_cuda(grads):
    _check("adamw_clip_sumsq", grads=grads)
    ws, grid = _workspace(grads[0].device)
    norm = torch.empty((), dtype=torch.float32, device=grads[0].device)
    ptrs, sizes, first = _table([(g,) for g in grads])
    _KERNEL["sumsq"](norm, ptrs.ctypes.data, sizes.ctypes.data,
                     first.ctypes.data, len(grads), CHUNK, ws,
                     ws.data_ptr() + 8 * grid, grid)
    return norm


def _update_cuda(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm,
                 clip_norm, beta1, beta2, eps, weight_decay):
    _check_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm)
    ws, grid = _workspace(params[0].device)
    ptrs, sizes, first = _table(list(zip(params, grads, exp_avgs,
                                         exp_avg_sqs, steps)))
    _KERNEL["update"](lr, norm, ptrs.ctypes.data, sizes.ctypes.data,
                      first.ctypes.data, len(params), CHUNK,
                      ws.data_ptr() + 8 * grid + 4, grid, clip_norm, beta1,
                      beta2, 1 - beta1, 1 - beta2, eps, weight_decay)


def adamw_clip_sumsq(grads):
    """The global norm of `grads` (a list of f32 tensors), an f32 scalar:
    one kernel on the card, `plain_sumsq` on the CPU."""
    return _SUMSQ(list(grads))


def adamw_clip_update(params, grads, exp_avgs, exp_avg_sqs, steps, lr, norm,
                      clip_norm, beta1, beta2, eps, weight_decay):
    """One clipped AdamW update of every leaf, in place (the module's
    note): one kernel on the card, `plain_update` on the CPU."""
    _UPDATE(list(params), list(grads), list(exp_avgs), list(exp_avg_sqs),
            list(steps), lr, norm, float(clip_norm), float(beta1),
            float(beta2), float(eps), float(weight_decay))


def _fake_sumsq(grads):
    return grads[0].new_empty((), dtype=torch.float32)


def _fake_update(*args):
    return None


_SUMSQ = _kernels.define(
    "adamw_clip_sumsq(Tensor[] grads) -> Tensor",
    adamw_clip_sumsq, cuda=_sumsq_cuda, cpu=plain_sumsq, fake=_fake_sumsq)
_UPDATE = _kernels.define(
    "adamw_clip_update(Tensor(a!)[] params, Tensor[] grads, "
    "Tensor(b!)[] exp_avgs, Tensor(c!)[] exp_avg_sqs, Tensor(d!)[] steps, "
    "Tensor lr, Tensor norm, float clip_norm, float beta1, float beta2, "
    "float eps, float weight_decay) -> ()",
    adamw_clip_update, cuda=_update_cuda, cpu=plain_update,
    fake=_fake_update)
