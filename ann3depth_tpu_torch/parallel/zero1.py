"""ZeRO-1 data parallelism: reduce-scattered gradients, sharded optimizer
state, all-gathered params.

Counterpart of `ann3depth_tpu/parallel/zero1.py`. Replicated data
parallelism (train/step.py) keeps the full optimizer moments on every
rank; ZeRO-1 (Rajbhandari et al. 2020) shards them over the data axis, in
the JAX package's layout: each param's flat f32 vector is padded to N
chunks of `chunk_size(numel, N)` and data-rank r owns chunk r. A step:

1. local gradients on the rank's batch (grad_accum microbatches summed
   first, so one collective round a step whatever the accumulation);
2. reduce-scatter: rank r gets the mean gradient of its chunk of every
   param, one `reduce_scatter_tensor` for all params (rows of the packed
   [N, sum of chunks] buffer are the ranks' chunks);
3. the global-norm clip from the all-reduced sum of the chunks' squares
   (clip_norm <= 0 disables it), in the same all-reduce as the metrics'
   sufficient statistics;
4. the update rule (adamw, adam, sgd: `train/step.make_optimizer`'s torch
   optimizer, built on the chunks) on the rank's chunks only: 1/N of the
   optimizer state and its arithmetic;
5. one `all_gather_into_tensor` of the updated chunks into the full
   params; the EMA follows the gathered params (train/step.py).

`torch.distributed.optim.ZeroRedundancyOptimizer` assigns whole tensors to
ranks, which is another layout; it is not used.

Checkpoints hold the single-device layout: `state_dict` all-gathers the
moments into the params' shapes (a torch optimizer's state_dict), and
`load_state_dict` cuts one (from a ZeRO-1 or a replicated run) into this
rank's chunks, so runs resume across the two modes.
"""

from __future__ import annotations

import torch

from ann3depth_tpu_torch.train.step import TrainState, UpdateRule


def chunk_size(n_elems: int, n_dev: int) -> int:
    return (n_elems + n_dev - 1) // n_dev


def local_chunk(x, idx: int, n_dev: int):
    """A tensor -> rank idx's padded flat [chunk] f32 slice (a copy)."""
    flat = x.detach().reshape(-1).float()
    chunk = chunk_size(flat.numel(), n_dev)
    flat = torch.nn.functional.pad(flat, (0, chunk * n_dev - flat.numel()))
    return flat[idx * chunk:(idx + 1) * chunk].clone()


class Zero1Optimizer:
    """The optimizer of a ZeRO-1 TrainState: the update rule's torch
    optimizer over this rank's param chunks (`inner`), with the
    collectives of a step (`sharded_update`, which train/step.py calls in
    place of the replicated all-reduce and update)."""

    def __init__(self, model, tx: UpdateRule, mesh):
        self.mesh, self.tx = mesh, tx
        self.params = list(model.parameters())
        n, r = mesh.n_data, mesh.data_rank
        self.numels = [p.numel() for p in self.params]
        self.chunks = [chunk_size(k, n) for k in self.numels]
        self.total = sum(self.chunks)
        self.local = [local_chunk(p, r, n) for p in self.params]
        self.inner = tx.init(self.local)

    # -- the torch.optim surface the loop and checkpoints use --------------

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in self.inner.state.values()
                   for v in st.values() if torch.is_tensor(v))

    # -- the step ----------------------------------------------------------

    def _pack(self, tensors):
        """[N, total]: row r holds chunk r of every tensor, in param
        order (tensor i padded to N * chunks[i])."""
        n = self.mesh.n_data
        return torch.cat([
            torch.nn.functional.pad(t.reshape(-1).float(),
                                    (0, n * c - t.numel())).view(n, c)
            for t, c in zip(tensors, self.chunks)], dim=1)

    def sharded_update(self, model, count, lr, means, sums):
        """Reduce-scatter, clip, update the chunks, all-gather the params;
        returns (the mean gradients' global norm before the clip, means
        averaged and sums summed over the data axis)."""
        mesh, n = self.mesh, float(self.mesh.n_data)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        mine = torch.empty(self.total, dtype=torch.float32,
                           device=self.local[0].device)
        mesh.reduce_scatter(mine, self._pack(grads).view(-1))
        mine.div_(n)
        means, sums = dict(means or {}), dict(sums or {})
        scalars = torch.stack([mine.square().sum(), *means.values(),
                               *sums.values()]).float()
        mesh.all_reduce(scalars)
        norm = torch.sqrt(scalars[0])
        scalars[1:1 + len(means)].div_(n)
        vals = dict(zip([*means, *sums], scalars[1:]))
        for c, g in zip(self.local, mine.split(self.chunks)):
            c.grad = g
        self.tx.apply(self.inner, count, lr=lr, norm=norm)
        full = torch.empty((int(n), self.total), dtype=torch.float32,
                           device=mine.device)
        mesh.all_gather(full.view(-1), torch.cat(self.local))
        with torch.no_grad():
            for p, part in zip(self.params, full.split(self.chunks, dim=1)):
                p.copy_(part.reshape(-1)[:p.numel()].view_as(p))
        return (norm, {k: vals[k] for k in means},
                {k: vals[k] for k in sums})

    # -- checkpoints -------------------------------------------------------

    def _gather_leaf(self, v, i):
        n = self.mesh.n_data
        full = torch.empty(n * self.chunks[i], dtype=v.dtype,
                           device=v.device)
        self.mesh.all_gather(full, v.contiguous())
        p = self.params[i]
        return full[:self.numels[i]].view(p.shape).to(p.dtype)

    def state_dict(self):
        """The inner optimizer's state_dict with every moment gathered
        into its param's shape (a collective: every rank calls it)."""
        sd = self.inner.state_dict()
        moments = {}
        for i, st in sd["state"].items():
            shape = self.local[int(i)].shape
            moments[i] = {k: (self._gather_leaf(v, int(i))
                              if torch.is_tensor(v) and v.shape == shape
                              else v) for k, v in st.items()}
        return {**sd, "state": moments}

    def load_state_dict(self, sd):
        """Load a single-device-layout state_dict, keeping this rank's
        chunk of every moment shaped like its param."""
        n, r = self.mesh.n_data, self.mesh.data_rank
        moments = {}
        for i, st in sd["state"].items():
            p = self.params[int(i)]
            moments[i] = {k: (local_chunk(v, r, n).to(self.local[0].device)
                              if torch.is_tensor(v) and v.shape == p.shape
                              and v.ndim > 0 else v) for k, v in st.items()}
        self.inner.load_state_dict({**sd, "state": moments})


def create_state(model, tx: UpdateRule, mesh, ema: bool = False):
    """A TrainState whose optimizer is ZeRO-1 over `mesh`'s data axis (the
    EMA, when kept, is a full copy of the params, as replicated runs
    keep it)."""
    return TrainState(
        step=0, model=model, optimizer=Zero1Optimizer(model, tx, mesh),
        tx=tx, mesh=mesh,
        ema_params=({k: v.detach().clone()
                     for k, v in model.named_parameters()} if ema else None))
