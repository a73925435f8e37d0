"""Tensor parallelism for the DPT transformer: Megatron-style sharding of
each block's attention and MLP over the mesh's model axis.

Counterpart of `ann3depth_tpu/parallel/sharding_rules.py`. The JAX package
maps each parameter path to a PartitionSpec over ("data", "model") and lets
jit's sharding propagation insert the collectives. The port writes the
same layout by hand (so it runs on gloo as on NCCL, and its collectives
are the ones the rules imply):

- attention q/k/v are column-parallel over heads (rows of the [H*D, E]
  weights and their biases), `out` row-parallel (columns of its [E, H*D]
  weight); MLP fc1 column-parallel, fc2 row-parallel;
- the block input passes `copy_to_model` (identity forward, all-reduce of
  the gradient backward), each row-parallel product `reduce_from_model`
  (all-reduce forward, identity backward); out/fc2's bias is added once,
  after the reduce. Both all-reduces sum in f32.

A module is sharded only where its dimension divides the model axis (heads
for attention, hidden width for the MLP), else replicated, as the JAX
rules shard a leaf only where its dimension divides the axis. Everything
else (patch embedding, LayerNorms, reassembly, fusion head) is replicated.
A `FusedQKVSelfAttention` holds `Attention`'s params under its names and
is sharded as one: each rank projects its heads with its rows of q/k/v.

A sharded run's checkpoints hold the single-device layout: `gather_state`
all-gathers the shards of params, optimizer moments and EMA, and
`shard_state` cuts a full state back to this rank's shards.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ann3depth_tpu_torch.parallel.mesh import MODEL_AXIS

# (name-regex, sharded dim of the torch parameter or None = replicated):
# first match wins. Names look like "block0.attn.query.weight".
_DPT_TP_RULES = [
    (r".*\.attn\.(query|key|value)\.weight$", 0),
    (r".*\.attn\.(query|key|value)\.bias$", 0),
    (r".*\.attn\.out\.weight$", 1),
    (r".*\.attn\.out\.bias$", None),
    (r".*\.mlp\.fc1\.weight$", 0),
    (r".*\.mlp\.fc1\.bias$", 0),
    (r".*\.mlp\.fc2\.weight$", 1),
    (r".*\.mlp\.fc2\.bias$", None),
]

# Model-axis all-reduces run: in the forward, in the backward, and the
# update's (`sync_grads`); a CUDA graph replay adds none.
collectives = {"forward": 0, "backward": 0, "update": 0}


def tp_dim_for(name: str) -> Optional[int]:
    """The dim of parameter `name` that the rules shard, or None."""
    for pattern, dim in _DPT_TP_RULES:
        if re.match(pattern, name):
            return dim
    return None


def _reduce_f32(t, mesh):
    """Sum of `t` over the model axis, taken in f32, in t's dtype."""
    acc = t.to(torch.float32, copy=True).contiguous()
    mesh.all_reduce(acc, MODEL_AXIS)
    return acc


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the model axis
    backward (each rank's shard contributes to the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        collectives["backward"] += 1
        return _reduce_f32(grad, ctx.mesh).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model axis forward (the partial products of a
    row-parallel layer), in f32; identity backward."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.dtype = y.dtype
        collectives["forward"] += 1
        return _reduce_f32(y, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x, mesh):
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(y, mesh):
    return _ReduceFromModel.apply(y, mesh)


def _linear_shard(linear, dim, part, n, bias=True):
    """nn.Linear holding part `part` of n of `linear` along weight dim
    `dim` (0: output rows with their bias; 1: input columns, full bias)."""
    w = linear.weight.detach().chunk(n, dim)[part].clone()
    out = nn.Linear(w.shape[1], w.shape[0], bias=bias,
                    device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        if bias:
            b = linear.bias.detach()
            out.bias.copy_(b.chunk(n)[part] if dim == 0 else b)
    return out


class TPAttention(nn.Module):
    """dpt.Attention with this rank's heads: q/k/v column-parallel, out
    row-parallel (its full bias added after the reduce)."""

    def __init__(self, attn, mesh):
        super().__init__()
        n, m = mesh.n_model, mesh.model_rank
        self.heads = attn.heads // n
        self.mesh = mesh
        self.query = _linear_shard(attn.query, 0, m, n)
        self.key = _linear_shard(attn.key, 0, m, n)
        self.value = _linear_shard(attn.value, 0, m, n)
        self.out = _linear_shard(attn.out, 1, m, n)

    def forward(self, x):
        x = copy_to_model(x, self.mesh)
        b, t, _ = x.shape
        h = self.heads

        def split(proj):  # [B, T, h*D] -> [B, h, T, D]
            return proj(x).reshape(b, t, h, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(self.query), split(self.key),
                                           split(self.value))
        y = F.linear(o.transpose(1, 2).reshape(b, t, -1), self.out.weight)
        return reduce_from_model(y, self.mesh) + self.out.bias


class TPMLP(nn.Module):
    """dpt.MLP with this rank's hidden units: fc1 column-parallel, fc2
    row-parallel (its full bias added after the reduce)."""

    def __init__(self, mlp, mesh):
        super().__init__()
        n, m = mesh.n_model, mesh.model_rank
        self.mesh = mesh
        self.fc1 = _linear_shard(mlp.fc1, 0, m, n)
        self.fc2 = _linear_shard(mlp.fc2, 1, m, n)

    def forward(self, x):
        x = copy_to_model(x, self.mesh)
        h = F.gelu(self.fc1(x), approximate="tanh")
        y = F.linear(h, self.fc2.weight)
        return reduce_from_model(y, self.mesh) + self.fc2.bias


class _Fork(torch.autograd.Function):
    """n copies of x forward; backward, their gradients summed in f32 (in
    order) and cast to x's dtype: what `copy_to_model` does across n
    ranks."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].float()
        for g in grads[1:]:
            total = total + g.float()
        return total.to(grads[0].dtype), None


def _sum_f32(parts):
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    return total


class _TwinAttention(nn.Module):
    """Attention computed as tp=n computes it, in one process: each part
    of the heads on its own copy of the input, the row-parallel partial
    products summed in f32, the bias added once. Each part's weight is a
    contiguous tensor, as a rank's shard is: a strided one may take
    another GEMM kernel on the card, which sums in another order."""

    def __init__(self, attn, n):
        super().__init__()
        self.heads, self.n = attn.heads, n
        self.query, self.key = attn.query, attn.key
        self.value, self.out = attn.value, attn.out

    def forward(self, x):
        a, n = self, self.n
        b, t, _ = x.shape
        outs = []
        for p, xp in enumerate(_Fork.apply(x, n)):
            def split(lin):
                w, bias = lin.weight.chunk(n, 0)[p], lin.bias.chunk(n)[p]
                return F.linear(xp, w, bias).reshape(
                    b, t, a.heads // n, -1).transpose(1, 2)
            o = F.scaled_dot_product_attention(split(a.query), split(a.key),
                                               split(a.value))
            outs.append(F.linear(o.transpose(1, 2).reshape(b, t, -1),
                                 a.out.weight.chunk(n, 1)[p].contiguous()))
        return _sum_f32(outs) + a.out.bias


class _TwinMLP(nn.Module):
    """The MLP computed as tp=n computes it, in one process."""

    def __init__(self, mlp, n):
        super().__init__()
        self.fc1, self.fc2, self.n = mlp.fc1, mlp.fc2, n

    def forward(self, x):
        m, n = self, self.n
        outs = []
        for p, xp in enumerate(_Fork.apply(x, n)):
            h = F.gelu(F.linear(xp, m.fc1.weight.chunk(n, 0)[p],
                                m.fc1.bias.chunk(n)[p]), approximate="tanh")
            outs.append(F.linear(
                h, m.fc2.weight.chunk(n, 1)[p].contiguous()))
        return _sum_f32(outs) + m.fc2.bias


def tp_twin(model, n):
    """The one-process twin of `shard_params(model, mesh)` on a model
    axis of n ranks, in place: the same params (unsharded, under their
    names), each sharded block computed with the products, f32 sums and
    roundings of the sharded one. In bf16 a different order of the same
    sums moves a DPT's answers (PERF.md §6), so the twin, not the
    plain model, is what a tensor-parallel run equals. Param names and
    the state_dict are the plain model's."""
    from ann3depth_tpu_torch.models.dpt import (MLP, Attention,
                                                FusedQKVSelfAttention)

    if n > 1:
        for block in model.children():
            for child, twin_cls, kinds in (
                    ("attn", _TwinAttention, (Attention,
                                              FusedQKVSelfAttention)),
                    ("mlp", _TwinMLP, (MLP,))):
                module = getattr(block, child, None)
                if type(module) in kinds and _divides(module, n):
                    setattr(block, child, twin_cls(module, n))
    return model


def _divides(module, n) -> bool:
    if hasattr(module, "heads"):
        return module.heads % n == 0
    return module.fc1.out_features % n == 0


def shard_params(model, mesh) -> dict:
    """Shard a DPT model's blocks over the mesh's model axis, in place;
    returns the plan {param name: sharded dim}, also kept as
    `model.tp_plan`. A model axis of one rank shards nothing."""
    from ann3depth_tpu_torch.models.dpt import (MLP, Attention,
                                                FusedQKVSelfAttention)

    plan, n = {}, mesh.n_model
    if n > 1:
        for bname, block in list(model.named_children()):
            for child, tp_cls, kinds in (
                    ("attn", TPAttention, (Attention,
                                           FusedQKVSelfAttention)),
                    ("mlp", TPMLP, (MLP,))):
                module = getattr(block, child, None)
                if type(module) not in kinds or not _divides(module, n):
                    continue
                setattr(block, child, tp_cls(module, mesh))
                for pname, _ in getattr(block, child).named_parameters():
                    full = f"{bname}.{child}.{pname}"
                    dim = tp_dim_for(full)
                    if dim is not None:
                        plan[full] = dim
    model.tp_plan = plan
    return plan


def describe_sharding(model) -> dict:
    """{param name: spec} of a model; a spec names the mesh axis of each
    dim of the torch parameter, e.g. "('model', None)"; "()" is
    replicated."""
    plan = getattr(model, "tp_plan", None) or {}
    out = {}
    for name, p in model.named_parameters():
        dim = plan.get(name)
        out[name] = ("()" if dim is None else str(tuple(
            MODEL_AXIS if i == dim else None for i in range(p.ndim))))
    return out


def sync_grads(state):
    """The update's model-axis all-reduce: average the replicated params'
    gradients over the model axis, and sum the squares of the sharded
    ones, in one flat all-reduce; returns the global norm of the
    gradients. Every rank computes the replicated gradients from the same
    inputs, but a kernel that sums with atomics (F.interpolate's backward)
    may round them differently on each: averaging keeps the replicas one
    model (exactly so where they agree)."""
    plan = state.tp_plan
    replicated, sharded = [], []
    for name, p in state.model.named_parameters():
        if p.grad is not None:
            (sharded if name in plan else replicated).append(p.grad)
    sq = torch.zeros(1, dtype=torch.float32,
                     device=next(state.model.parameters()).device)
    for g in sharded:
        sq = sq + g.float().pow(2).sum()
    flat = torch.cat([g.reshape(-1).float() for g in replicated] + [sq])
    collectives["update"] += 1
    state.mesh.all_reduce(flat, MODEL_AXIS)
    flat[:-1].div_(float(state.mesh.n_model))
    views = flat[:-1].split([g.numel() for g in replicated])
    torch._foreach_copy_(replicated, [v.view_as(g)
                                      for v, g in zip(views, replicated)])
    replicated_sq = sum(g.float().pow(2).sum() for g in replicated)
    return torch.sqrt(flat[-1] + replicated_sq)


def _gather_dim(t, dim, mesh):
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((mesh.n_model * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    mesh.all_gather(out, x, MODEL_AXIS)
    return out.movedim(0, dim).contiguous()


def _shard_dim(t, dim, mesh):
    return t.chunk(mesh.n_model, dim)[mesh.model_rank].clone()


def _map_state(state, model_sd, opt_sd, ema, fn):
    """Apply fn(tensor, dim) to every sharded entry: params by name,
    optimizer moments by their param's index, EMA by name."""
    plan = state.tp_plan
    names = [n for n, _ in state.model.named_parameters()]
    if model_sd is not None:
        model_sd = {k: fn(v, plan[k]) if k in plan else v
                    for k, v in model_sd.items()}
    if opt_sd is not None:
        moments = {}
        for i, st in opt_sd["state"].items():
            dim = plan.get(names[int(i)])
            moments[i] = {k: (fn(v, dim) if dim is not None
                              and torch.is_tensor(v) and v.ndim > 0 else v)
                          for k, v in st.items()}
        opt_sd = {**opt_sd, "state": moments}
    if ema is not None:
        ema = {k: fn(v, plan[k]) if k in plan else v for k, v in ema.items()}
    return model_sd, opt_sd, ema


def gather_state(state, model_sd, opt_sd, ema):
    """Shards -> the single-device layout (every rank calls it)."""
    return _map_state(state, model_sd, opt_sd, ema,
                      lambda t, dim: _gather_dim(t, dim, state.mesh))


def shard_state(state, model_sd, opt_sd, ema):
    """The single-device layout -> this rank's shards."""
    return _map_state(state, model_sd, opt_sd, ema,
                      lambda t, dim: _shard_dim(t, dim, state.mesh))
