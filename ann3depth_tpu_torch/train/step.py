"""Train, eval and inference steps of the port.

Counterpart of `ann3depth_tpu/train/step.py`. One `train_step` is
preprocess (the CUDA kernel on the card) -> forward -> backward -> update,
split so that a caller can put another preprocess in front of the same
update: `train_step` = `preprocess.preprocess_batch` + `step_on_batch`.
With grad_accum > 1 it runs `accumulate_microbatches` instead, then one
update; `distill_train_step` adds a frozen teacher's log-depth map as a
second target.

Where the JAX step is a pure function of its state, the port updates the
state in place (params, optimizer moments, EMA and the step counter), as
the JAX step's buffer donation does on the device. The step makes no host
sync and copies nothing from the host: its metrics stay device tensors,
the step counter lives on the host, and so the step can be captured in a
CUDA graph (train/dispatch.py).

The update rule is the optax chain of the JAX package, written with torch
optimizers whose learning rate is set before each update to
`schedule(count)`, with `count` the step before the increment (optax's
`scale_by_schedule`), after a global-norm clip that leaves gradients
unchanged below `clip_norm` and scales them by `clip_norm / norm` above it
(optax's `clip_by_global_norm`; torch's `clip_grad_norm_` adds 1e-6). On
the card the rate is a device tensor (`UpdateRule`).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

from ann3depth_tpu_torch.compat import reference_spec as ref
from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.ops import resize
from ann3depth_tpu_torch.pipeline import preprocess
from ann3depth_tpu_torch.train import losses
from ann3depth_tpu_torch.utils import graphs


def init_params(model, input_hw, seed=0, *, device=None):
    """flax-style initialization for inputs of `input_hw` (DPT's pos_embed
    has a row per token) from a seeded `torch.Generator`; returns the
    model on `device`. The draws differ from jax.random's, the
    distributions are the same."""
    gen = torch.Generator().manual_seed(int(seed))
    return model.init_weights(gen, tuple(input_hw)).to(device or "cpu")


# ---------------------------------------------------------------------------
# Learning-rate schedule and update rule.
# ---------------------------------------------------------------------------

def _linear(init_value, end_value, transition_steps):
    """optax.linear_schedule."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine(init_value, decay_steps):
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    def schedule(count):
        count = min(count, decay_steps)
        return init_value * 0.5 * (1 + math.cos(math.pi * count
                                                / decay_steps))
    return schedule


def _join(first, second, boundary):
    """optax.join_schedules of two schedules."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_schedule(learning_rate, warmup_steps=0, total_steps=None,
                  schedule="cosine") -> Callable[[int], float]:
    """count -> learning rate, as the JAX package's `make_schedule`.

    schedule="cosine": linear warmup from 0, then cosine decay to 0 at
    total_steps (warmup_steps=0 disables only the warmup); total_steps None
    -> constant lr. schedule="constant": fixed lr, after a linear warmup
    when warmup_steps > 0."""
    if schedule == "constant":
        if warmup_steps:
            return _linear(0.0, learning_rate, warmup_steps)
        return lambda count: learning_rate
    if schedule != "cosine":
        raise ValueError(f"unknown schedule {schedule!r}; "
                         "have cosine | constant")
    if total_steps:
        decay_steps = max(total_steps, warmup_steps + 1)
        return _join(_linear(0.0, learning_rate, warmup_steps),
                     _cosine(learning_rate, decay_steps - warmup_steps),
                     warmup_steps)
    return lambda count: learning_rate


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """The port's counterpart of an optax chain: `build(params, capturable)`
    makes the torch optimizer; each `apply` clips the gradients by global
    norm (when clip_norm > 0), sets the learning rate to `schedule(count)`
    (or to a given tensor's value) and steps.

    On the card every optimizer holds its learning rate in a device tensor
    (adamw and adam built with capturable=True, sgd's `CapturableSGD`
    reads it as a tensor), so that a CUDA graph of the step reads the rate of each replay
    (train/dispatch.py); every step on the card, eager or replayed, runs
    that arithmetic. On the CPU the rate is a Python float."""

    build: Callable
    schedule: Callable[[int], float]
    clip_norm: float = 0.0

    def init(self, params) -> torch.optim.Optimizer:
        params = list(params)
        return self.build(params, capturable=bool(params)
                          and params[0].device.type == "cuda")

    def apply(self, optimizer, count: int, lr=None, norm=None):
        """One update from the gradients in `.grad`; returns their global
        norm before the clip (a device scalar). lr: a one-element tensor
        holding the learning rate, read in place of schedule(count).
        norm: that global norm, when the caller has it (the gradients are
        shards whose norm needs a collective: tensor parallelism, ZeRO-1)."""
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        if norm is None:
            norm = global_norm(grads)
        if self.clip_norm > 0:
            factor = torch.where(norm < self.clip_norm,
                                 torch.ones_like(norm), self.clip_norm / norm)
            torch._foreach_mul_(grads, factor)
        value = float(self.schedule(count)) if lr is None else None
        for group in optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                if lr is None:
                    group["lr"].fill_(value)
                else:
                    group["lr"].copy_(lr.reshape(()))
            else:
                group["lr"] = value if lr is None else float(lr)
        optimizer.step()
        return norm


def load_optimizer_state(optimizer, saved):
    """`optimizer.load_state_dict(saved)`, keeping this optimizer's own
    learning-rate holder and capturable flag: a checkpoint written on
    another device restores the moments and step counts only (the counts
    move to the params' device when the optimizer is capturable)."""
    own = [(g["lr"], g.get("capturable")) for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, (lr, capturable) in zip(optimizer.param_groups, own):
        group["lr"] = lr
        if capturable is None:
            continue
        group["capturable"] = capturable
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = (st["step"].to(p.device, torch.float32)
                              if capturable else st["step"].cpu())


def global_norm(tensors):
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class CapturableSGD(torch.optim.SGD):
    """optax.sgd after add_decayed_weights, the sgd rule on every device.
    Per param: g += wd p; t = g + b1 t (no trace when b1 is 0);
    p -= lr t. On the card the learning rate is a one-element device
    tensor that no step reads on the host, so that a CUDA graph can
    capture the step (torch's SGD applies a tensor rate through
    `.item()`); on the CPU it is a float. The trace is torch's
    `momentum_buffer` (zeros before the first step, where torch's SGD
    starts from g: the same values), so the state_dicts of the two load
    into each other."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableSGD takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            if group["momentum"]:
                bufs = []
                for p in params:
                    st = self.state[p]
                    if st.get("momentum_buffer") is None:
                        st["momentum_buffer"] = torch.zeros_like(p)
                    bufs.append(st["momentum_buffer"])
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, grads)
                grads = bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads,
                                                           group["lr"]))


def make_inner_optimizer(sched, optimizer="adamw", b1=0.9, b2=0.999,
                         weight_decay=0.0) -> UpdateRule:
    """The clip-free update rule.

    adamw: decoupled weight decay on the current params. adam: no weight
    decay (a nonzero one raises). sgd: momentum = b1, weight decay as an
    additive L2 term before the momentum.

    capturable (the card): adamw and adam take a device-tensor learning
    rate and capturable=True; sgd (`CapturableSGD` on every device) takes
    the device-tensor rate."""
    def lr0(params, capturable):
        if not capturable:
            return 0.0
        return torch.zeros((), dtype=torch.float32, device=params[0].device)

    if optimizer == "adamw":
        def build(params, capturable=False):
            return torch.optim.AdamW(params, lr=lr0(params, capturable),
                                     betas=(b1, b2), eps=1e-8,
                                     weight_decay=weight_decay,
                                     capturable=capturable)
    elif optimizer == "adam":
        if weight_decay:
            raise ValueError(
                "--optimizer adam ignores weight decay (plain Adam has "
                f"none); got weight_decay={weight_decay}. Use adamw for "
                "decoupled decay or sgd for additive L2, or pass "
                "--weight-decay 0.")

        def build(params, capturable=False):
            return torch.optim.Adam(params, lr=lr0(params, capturable),
                                    betas=(b1, b2), eps=1e-8,
                                    capturable=capturable)
    elif optimizer == "sgd":
        def build(params, capturable=False):
            return CapturableSGD(params, lr=lr0(params, capturable),
                                 momentum=b1 if b1 > 0 else 0.0,
                                 weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         "have adamw | adam | sgd")
    return UpdateRule(build=build, schedule=sched)


def make_optimizer(learning_rate, warmup_steps=0, total_steps=None,
                   b1=0.9, b2=0.999, weight_decay=0.0, clip_norm=1.0,
                   optimizer="adamw", schedule="cosine") -> UpdateRule:
    """The configured update rule: warmup + cosine decay, global-norm clip.
    clip_norm <= 0 disables the clip."""
    sched = make_schedule(learning_rate, warmup_steps, total_steps,
                          schedule)
    inner = make_inner_optimizer(sched, optimizer, b1=b1, b2=b2,
                                 weight_decay=weight_decay)
    return dataclasses.replace(inner, clip_norm=max(clip_norm, 0.0))


# ---------------------------------------------------------------------------
# State and steps.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """Model (its params), optimizer, step counter and optional EMA.

    ema_params: {name: tensor} exponential moving average of the params,
    updated after each step when the trainer enables it (ema_decay > 0);
    None otherwise.

    mesh: the data-parallel mesh (parallel/mesh.py) of a run over several
    processes: the step averages its gradients over the data axis. tp_plan:
    {param name: sharded dim} of a tensor-parallel model
    (parallel/sharding_rules.py); its params, moments and EMA are this
    rank's shards. Under ZeRO-1 the optimizer is a
    `parallel.zero1.Zero1Optimizer`."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tx: UpdateRule
    ema_params: Optional[dict] = None
    mesh: Any = None
    tp_plan: Optional[dict] = None

    @classmethod
    def create(cls, model, tx: UpdateRule, ema: bool = False, mesh=None,
               tp_plan=None):
        return cls(step=0, model=model, optimizer=tx.init(model.parameters()),
                   tx=tx, ema_params=_param_copy(model) if ema else None,
                   mesh=mesh, tp_plan=tp_plan)

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def full_state(self):
        """(model state_dict, optimizer state_dict, EMA params) in the
        single-device layout: tensor-parallel shards and ZeRO-1 chunks are
        gathered (a collective: every rank calls it)."""
        model, ema = self.model.state_dict(), self.ema_params
        optimizer = self.optimizer.state_dict()
        if self.tp_plan:
            from ann3depth_tpu_torch.parallel import sharding_rules
            model, optimizer, ema = sharding_rules.gather_state(
                self, model, optimizer, ema)
        return model, optimizer, ema

    def load_full_state(self, model=None, optimizer=None, ema=None):
        """Load what `full_state` gives (any of the three) into this
        state, keeping this rank's shards."""
        if self.tp_plan:
            from ann3depth_tpu_torch.parallel import sharding_rules
            model, optimizer, ema = sharding_rules.shard_state(
                self, model, optimizer, ema)
        if model is not None:
            self.model.load_state_dict(model)
        if optimizer is not None:
            load_optimizer_state(self.optimizer, optimizer)
        if ema is not None:
            self.ema_params = {k: v.clone() for k, v in ema.items()}


def _param_copy(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def loss_fn(model, images, depths, si_lambda, loss_kind="si"):
    """images: [B,h,w,3] normalized f32; depths: [B,h',w'] linear meters.
    Returns (loss, pred_log)."""
    pred_log = model(images)
    loss = losses.depth_loss(pred_log, depths, kind=loss_kind,
                             lam=si_lambda)
    return loss, pred_log


@torch.no_grad()
def ema_update(ema: dict, params: dict, ema_decay):
    """One Polyak-averaging step, in place: e = decay*e + (1-decay)*p."""
    names = list(ema)
    e = [ema[k] for k in names]
    torch._foreach_mul_(e, ema_decay)
    torch._foreach_add_(e, [params[k].detach() for k in names],
                        alpha=1.0 - ema_decay)
    return ema


def allreduce_gradients(mesh, grads, means=None, sums=None):
    """Average `grads` (in place) over the mesh's data axis in one flat
    all-reduce, which also carries the step's metrics: `means` (scalars
    that are means over equal shards, e.g. the loss) come back averaged,
    `sums` (sufficient statistics) summed. Returns (means, sums) as dicts
    of device scalars. A data axis of one rank moves no value: every
    number comes back bit for bit."""
    means, sums = dict(means or {}), dict(sums or {})
    scalars = [*means.values(), *sums.values()]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + ([torch.stack(scalars).float()] if scalars else []))
    mesh.all_reduce(flat)
    n_grad = flat.numel() - len(scalars)
    n = float(mesh.n_data)
    flat[:n_grad + len(means)].div_(n)
    views = flat[:n_grad].split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(views, grads)])
    tail = dict(zip([*means, *sums], flat[n_grad:]))
    return {k: tail[k] for k in means}, {k: tail[k] for k in sums}


def _finish_update(state, grad_accum=1, ema_decay=0.0, lr=None, means=None,
                   sums=None):
    """The update from the gradients in `.grad` (their mean over
    `grad_accum` microbatches, and over the mesh's data axis when the
    state has one), then the EMA and the step counter. lr: a tensor
    holding the learning rate (UpdateRule.apply). means, sums: the step's
    metrics (`allreduce_gradients`). Returns (the global norm of the mean
    gradients before the clip, means, sums), the metrics over every rank's
    batch."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    if grad_accum > 1:
        torch._foreach_div_(grads, float(grad_accum))
    sharded_update = getattr(state.optimizer, "sharded_update", None)
    if sharded_update is not None:  # ZeRO-1
        grad_norm, means, sums = sharded_update(state.model, state.step,
                                                lr, means, sums)
    else:
        if state.mesh is not None and state.mesh.active():
            means, sums = allreduce_gradients(state.mesh, grads, means, sums)
        norm = None
        if state.tp_plan:
            from ann3depth_tpu_torch.parallel import sharding_rules
            norm = sharding_rules.sync_grads(state)
        grad_norm = state.tx.apply(state.optimizer, state.step, lr=lr,
                                   norm=norm)
    if state.ema_params is not None and ema_decay:
        ema_update(state.ema_params, state.params, ema_decay)
    state.step += 1
    return grad_norm, dict(means or {}), dict(sums or {})


def step_on_batch(state: TrainState, images, depths, *, si_lambda=0.5,
                  ema_decay=0.0, loss_kind="si", lr=None):
    """Forward, backward, update and EMA on a preprocessed batch; returns
    (state, metrics) with loss, grad_norm (before the clip) and rmse as
    device scalars. lr: as in `train_step`."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, pred_log = loss_fn(state.model, images, depths, si_lambda,
                             loss_kind)
    loss.backward()
    with torch.no_grad():
        stats = losses.depth_metric_stats(pred_log.detach(), depths)
    grad_norm, means, stats = _finish_update(
        state, ema_decay=ema_decay, lr=lr, means={"loss": loss.detach()},
        sums=stats)
    rmse = losses.finalize_depth_metrics(stats)["rmse"]
    return state, {"loss": means["loss"], "grad_norm": grad_norm,
                   "rmse": rmse}


def _to_microbatches(x, accum):
    """Microbatch j of a [accum*m, ...] batch is x[j::accum]: the JAX
    step's strided split (contiguous copies, which the kernel reads)."""
    return [x[j::accum].contiguous() for j in range(accum)]


def shard_draws(generator, batch, grad_accum, mesh, device=None):
    """The grad_accum augmentation draws of this data-rank's rows of a
    global batch of `batch` (the `draws` of `train_step`).

    One process draws microbatch j's rows (B / grad_accum of them) as the
    j-th `draw_augment` of its generator. Every rank draws those same
    global rows from a generator seeded alike and keeps its slice
    [r*m, (r+1)*m), m = B / (n_data * grad_accum): its local microbatch j
    (rows j::grad_accum of its B / n_data) holds global rows r*B/n_data +
    j + grad_accum*q, which are exactly those of microbatch j. So n ranks
    step as one process at the full batch, up to reduction order."""
    micro = batch // grad_accum
    m = micro // mesh.n_data
    lo = mesh.data_rank * m
    return [{k: v[lo:lo + m] for k, v in fp.draw_augment(
        generator, micro, device=device).items()}
        for _ in range(grad_accum)]


def accumulate_microbatches(state: TrainState, img_u8, depth_raw,
                            generator=None, *, grad_accum, input_hw,
                            target_hw, si_lambda=0.5, augment=False,
                            loss_kind="si", draws=None):
    """Preprocess, forward and backward of `grad_accum` strided
    microbatches one after another; their gradients sum in `.grad`.
    Returns the summed `losses.depth_metric_stats` (with the training loss
    of `loss_kind`), whose finalize gives full-batch metrics.

    With augment, microbatch j takes the j-th draw of `generator` (the
    counterpart of the JAX step's fold_in(base_key, j)), or draws[j]."""
    if img_u8.shape[0] % grad_accum:
        raise ValueError(
            f"global batch {img_u8.shape[0]} is not divisible by "
            f"grad_accum={grad_accum}")
    stats = {}
    for j, (img, dep) in enumerate(zip(
            _to_microbatches(img_u8, grad_accum),
            _to_microbatches(depth_raw, grad_accum))):
        images, depths = preprocess.preprocess_batch(
            img, dep, input_hw, target_hw,
            generator=generator if augment else None,
            draw=draws[j] if augment and draws is not None else None)
        loss, pred_log = loss_fn(state.model, images, depths, si_lambda,
                                 loss_kind)
        loss.backward()
        with torch.no_grad():
            micro = losses.depth_metric_stats(
                pred_log.detach(), depths, si_lambda=si_lambda,
                loss_kind=loss_kind)
        stats = {k: stats[k] + v if k in stats else v
                 for k, v in micro.items()}
    return stats


def train_step(state: TrainState, img_u8, depth_raw, generator=None, *,
               input_hw, target_hw, si_lambda=0.5, augment=False,
               ema_decay=0.0, loss_kind="si", grad_accum=1, draws=None,
               lr=None):
    """One step: preprocess -> fwd -> bwd -> update.

    img_u8: [B, H, W, 3] raw uint8 frames; depth_raw: [B, dh, dw] raw f32
    depth; generator: the `torch.Generator` (on the frames' device) that
    draws the augmentation when augment is set.

    draws, lr: what a CUDA graph of the step reads from device buffers
    (train/dispatch.py): `draws`, a list of grad_accum `draw_augment`
    draws taken before the step, in place of the generator's; `lr`, a
    one-element tensor holding the learning rate, in place of
    schedule(state.step). The step then copies nothing from the host.

    grad_accum > 1: one update from the mean gradients of `grad_accum`
    microbatches of B/grad_accum images (`accumulate_microbatches`), each
    preprocessed on its own; peak activation memory is a microbatch's.
    Equal to one full-batch step up to f32 reassociation; loss and rmse
    are full-batch values, grad_norm that of the mean gradients."""
    if grad_accum > 1:
        state.optimizer.zero_grad(set_to_none=True)
        stats = accumulate_microbatches(
            state, img_u8, depth_raw, generator, grad_accum=grad_accum,
            input_hw=input_hw, target_hw=target_hw, si_lambda=si_lambda,
            augment=augment, loss_kind=loss_kind, draws=draws)
        grad_norm, _, stats = _finish_update(state, grad_accum, ema_decay,
                                             lr=lr, sums=stats)
        fin = losses.finalize_depth_metrics(stats)
        return state, {"loss": fin["loss"], "grad_norm": grad_norm,
                       "rmse": fin["rmse"]}
    images, depths = preprocess.preprocess_batch(
        img_u8, depth_raw, input_hw, target_hw,
        generator=generator if augment else None,
        draw=draws[0] if augment and draws is not None else None)
    return step_on_batch(state, images, depths, si_lambda=si_lambda,
                         ema_decay=ema_decay, loss_kind=loss_kind, lr=lr)


def distill_train_step(state: TrainState, teacher, img_u8, depth_raw,
                       generator=None, *, input_hw, target_hw, si_lambda=0.5,
                       augment=False, distill_alpha=0.5, ema_decay=0.0,
                       loss_kind="si", draws=None, lr=None):
    """One step with knowledge distillation: the frozen `teacher` module's
    log-depth map is a second regression target for the student,

        loss = (1 - alpha) * depth_loss(student, gt)
             + alpha * mean((student_log - teacher_log)^2)

    Both models read one preprocessed batch; the teacher runs without
    autograd, and its map is resized to the student's grid when the two
    grids differ, as `jax.image.resize(..., "bilinear")` resizes it: the
    antialiased half-pixel triangle (`ops.resize.resample_2d`, the batch
    carried as channels), whose radius widens on a downsample. Metrics:
    loss, gt_loss, distill, grad_norm and rmse, as device scalars. draws,
    lr: as in `train_step` (one draw)."""
    images, depths = preprocess.preprocess_batch(
        img_u8, depth_raw, input_hw, target_hw,
        generator=generator if augment else None,
        draw=draws[0] if augment and draws is not None else None)
    with torch.no_grad():
        teacher_log = teacher(images).float()
    if tuple(teacher_log.shape[1:3]) != tuple(target_hw):
        teacher_log = resize.resample_2d(
            teacher_log[..., 0].permute(1, 2, 0), target_hw).permute(
                2, 0, 1)[..., None]
    state.optimizer.zero_grad(set_to_none=True)
    pred_log = state.model(images)
    gt_loss = losses.depth_loss(pred_log, depths, kind=loss_kind,
                                lam=si_lambda)
    match = torch.mean(torch.square(pred_log.float() - teacher_log))
    loss = (1.0 - distill_alpha) * gt_loss + distill_alpha * match
    loss.backward()
    with torch.no_grad():
        stats = losses.depth_metric_stats(pred_log.detach(), depths)
    grad_norm, means, stats = _finish_update(
        state, ema_decay=ema_decay, lr=lr,
        means={"loss": loss.detach(), "gt_loss": gt_loss.detach(),
               "distill": match.detach()}, sums=stats)
    rmse = losses.finalize_depth_metrics(stats)["rmse"]
    return state, {**means, "grad_norm": grad_norm, "rmse": rmse}


# ---------------------------------------------------------------------------
# Eval and inference.
# ---------------------------------------------------------------------------

def apply_with_tta(model, images, tta=""):
    """Forward with optional test-time augmentation.

    tta="flip": average, in linear depth, the prediction with the unflipped
    prediction of the mirrored input:
    log(0.5*(e^a + e^b)) = logaddexp(a, b) - log 2."""
    pred_log = model(images)
    if tta == "flip":
        flipped = model(images.flip(2))
        pred_log = torch.logaddexp(pred_log, flipped.flip(2)) - math.log(2.0)
    elif tta:
        raise ValueError(f"unknown tta mode {tta!r} (have: 'flip')")
    return pred_log


def _nanmedian(x, valid):
    """Per-row median of x over `valid` ([B, N] each) with numpy's
    convention (the mean of the two middle values of an even count; NaN
    for an empty row). torch.nanmedian takes the lower middle value."""
    n = valid.sum(dim=1)
    s = torch.sort(torch.where(valid, x, torch.inf), dim=1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (s.gather(1, lo[:, None]) + s.gather(1, hi[:, None]))[:, 0]
    return torch.where(n > 0, med, torch.nan)


def apply_alignment(pred_log, depths, align="", mask=None):
    """Optional per-image median scale alignment before metrics: shift the
    log prediction by log median(gt) - log median(pred) over the valid
    (and masked) pixels. align="" is a no-op; an all-invalid image gets
    shift 0."""
    if not align:
        return pred_log
    if align != "median":
        raise ValueError(f"unknown align mode {align!r} (have: 'median')")
    t = torch.as_tensor(depths).to(torch.float32)
    p = pred_log.reshape(t.shape).to(torch.float32)
    valid = losses._flatten_mask(t, mask)
    b = t.shape[0]
    med_gt = _nanmedian(t.reshape(b, -1), valid.reshape(b, -1))
    med_pr = _nanmedian(torch.exp(p).reshape(b, -1), valid.reshape(b, -1))
    shift = (torch.log(torch.clamp(med_gt, min=ref.DEPTH_EPS))
             - torch.log(torch.clamp(med_pr, min=ref.DEPTH_EPS)))
    shift = torch.nan_to_num(shift, nan=0.0)
    return pred_log + shift.reshape(
        (-1,) + (1,) * (pred_log.ndim - 1)).to(pred_log.dtype)


def _eval_forward(state, img_u8, depth_raw, input_hw, target_hw, tta, align,
                  crop):
    images, depths = preprocess.preprocess_batch(img_u8, depth_raw,
                                                 input_hw, target_hw)
    mask = losses.eval_crop_mask(target_hw, crop, device=depths.device)
    pred_log = apply_with_tta(state.model, images, tta)
    pred_log = apply_alignment(pred_log, depths, align, mask)
    return images, depths, mask, pred_log


@torch.inference_mode()
def eval_stats_step(state: TrainState, img_u8, depth_raw, *, input_hw,
                    target_hw, si_lambda=0.5, loss_kind="si", tta="",
                    align="", crop=""):
    """Eval: preprocess -> forward -> summable sufficient statistics (no
    augment); the eval loop sums them over the split and finalizes once.

    crop='eigen'|'garg' restricts the metrics (and the align window) to
    the literature's fractional eval crop."""
    _, depths, mask, pred_log = _eval_forward(
        state, img_u8, depth_raw, input_hw, target_hw, tta, align, crop)
    return losses.depth_metric_stats(pred_log, depths, mask,
                                     si_lambda=si_lambda,
                                     loss_kind=loss_kind)


@torch.inference_mode()
def eval_report_step(state: TrainState, img_u8, depth_raw, *, input_hw,
                     target_hw, si_lambda=0.5, loss_kind="si", tta="",
                     align="", crop=""):
    """Eval with per-image attribution: (per-image stats with the
    per-image training loss as "si_loss", images, depths, pred_log)."""
    images, depths, mask, pred_log = _eval_forward(
        state, img_u8, depth_raw, input_hw, target_hw, tta, align, crop)
    per = losses.per_image_metric_stats(pred_log, depths, mask)
    per["si_loss"] = losses.per_image_depth_loss(
        pred_log, depths, mask, kind=loss_kind, lam=si_lambda)
    return per, images, depths, pred_log


def eval_step(state: TrainState, img_u8, depth_raw, *, input_hw, target_hw,
              si_lambda=0.5):
    """One-batch metric dict of host floats."""
    stats = eval_stats_step(state, img_u8, depth_raw, input_hw=input_hw,
                            target_hw=target_hw, si_lambda=si_lambda)
    return losses.finalize_depth_metrics(
        {k: float(v) for k, v in stats.items()})


@torch.inference_mode()
def infer_step(model, img_u8, *, input_hw, tta=""):
    """Raw uint8 frames [B,H,W,3] -> linear depth maps [B,h,w]."""
    images = preprocess.preprocess_image(img_u8, input_hw)
    return torch.exp(apply_with_tta(model, images, tta)[..., 0])


# `infer_image`'s graphs of `infer_step`: one GraphCache a model, weakly
# keyed, so that a model's graphs go with it.
_INFER_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def infer_graphs(model):
    """The `GraphCache` of `infer_step` on `model`, on its device (made at
    first use, kept while the model lives): one CUDA graph for each frame
    shape and tta on the card, the eager step on the CPU."""
    cache = _INFER_GRAPHS.get(model)
    if cache is None:
        ref = weakref.ref(model)

        def infer(img_u8, **kw):
            return infer_step(ref(), img_u8, **kw)

        cache = _INFER_GRAPHS[model] = graphs.GraphCache(
            infer, device=next(model.parameters()).device)
    return cache


def infer_image(model, img_u8, *, input_hw, tta=""):
    """One decoded uint8 numpy frame [H,W,3] -> linear depth, numpy f32
    [h,w]: `infer_step` on the model's device through `infer_graphs` (the
    device half of `cli infer --image`)."""
    x = torch.from_numpy(np.array(img_u8, dtype=np.uint8))
    return infer_graphs(model)(x[None], input_hw=tuple(input_hw),
                               tta=tta)[0].to("cpu", copy=True).numpy()
