"""The process mesh: data-parallel and (data, model) groups of ranks.

Counterpart of `ann3depth_tpu/parallel/mesh.py`. The JAX mesh is an array
of devices that one process drives; the port runs one process per device
(parallel/multihost.py), so a mesh here is the ranks of the process group
laid out on a "data" axis and, for the DPT tensor-parallel path, a minor
"model" axis, as `create_mesh_2d` lays out devices: rank = d * tp + m.
Each rank holds its data and model process groups; collectives over an
axis run on its group.

The batch splits over the data axis: `shard_batch` keeps the rank's rows,
and parameters and optimizer state are replicated (`replicate` broadcasts
them from data-rank 0). Without a process group the mesh is one rank and
every collective is skipped.

`auto_data_mesh` keeps the JAX package's multi-process rules: tp must
divide the ranks and the per-step batch the data axis. Its single-process
shrink policy has no counterpart: one process drives one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (data, model) grid of n_data x n_model
    ranks, with the process groups of its data column and model row
    (None without a process group: one rank, no collectives)."""

    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    # -- collectives over one axis: skipped without a process group, and
    # over a model axis of one rank (which has no group) ---------------------

    def active(self, axis=DATA_AXIS) -> bool:
        """Whether collectives over `axis` run: over an axis of several
        ranks, and over the data axis of a one-rank group (they move no
        value there, and a CUDA graph of the step captures them). An axis
        of one rank beside another axis has nothing to reduce."""
        if axis == MODEL_AXIS:
            return self.distributed and self.n_model > 1
        return self.distributed and (self.n_data > 1 or self.n_model == 1)

    def all_reduce(self, t, axis=DATA_AXIS):
        """Sum `t` in place over the ranks of `axis`."""
        if self.active(axis):
            dist.all_reduce(t, group=self._group(axis))
        return t

    def reduce_scatter(self, out, flat, axis=DATA_AXIS):
        """out = this rank's slice of the sum of `flat` over `axis`."""
        if self.active(axis):
            dist.reduce_scatter_tensor(out, flat, group=self._group(axis))
        else:
            out.copy_(flat)
        return out

    def all_gather(self, out, local, axis=DATA_AXIS):
        """out = the ranks' `local` tensors of `axis`, concatenated."""
        if self.active(axis):
            dist.all_gather_into_tensor(out, local, group=self._group(axis))
        else:
            out.copy_(local)
        return out

    def _group(self, axis):
        if axis == DATA_AXIS:
            return self.data_group
        if axis == MODEL_AXIS:
            return self.model_group
        raise ValueError(f"unknown mesh axis {axis!r}")


def _world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_mesh(devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over every rank of the process group (one
    rank without one). devices: the rank count the caller expects."""
    rank, world = _world()
    if devices is not None and devices != world:
        raise ValueError(f"need {devices} devices, have {world}")
    if not dist.is_initialized():
        return Mesh()
    return Mesh(n_data=world, data_rank=rank, data_group=dist.group.WORLD,
                distributed=True)


def create_mesh_2d(n_data: int, n_model: int) -> Mesh:
    """2-D (data, model) mesh for dp x tp (the DPT path), the model axis
    minor: rank = d * n_model + m. Every rank must belong to it."""
    rank, world = _world()
    if world < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} devices, have {world}")
    if world > n_data * n_model:
        raise ValueError(
            f"a {n_data}x{n_model} mesh uses {n_data * n_model} of the "
            f"{world} processes; every process must belong to the mesh")
    if not dist.is_initialized():
        return Mesh()
    grid = np.arange(world).reshape(n_data, n_model)
    data_group = model_group = None
    # Every rank creates every group, in the same order (new_group is
    # collective over the world).
    for m in range(n_model):
        g = dist.new_group(grid[:, m].tolist())
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group(grid[d].tolist())
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data=n_data, n_model=n_model, data_rank=rank // n_model,
                model_rank=rank % n_model, data_group=data_group,
                model_group=model_group, distributed=True)


def auto_data_mesh(unit_batch: int, tp: int = 1) -> Mesh:
    """The mesh of every rank for a per-step batch of `unit_batch` (the
    microbatch when grad_accum > 1), with a minor model axis of width tp.

    Single policy shared by train() and evaluate(). Multi-process jobs
    must use every process, so tp must divide the ranks and unit_batch the
    data axis (the JAX package's multi-process rules, word for word)."""
    _, world = _world()
    if tp > 1 and world % tp:
        raise ValueError(f"{world} devices not divisible by "
                         f"tensor_parallel={tp}")
    n_data = world // tp
    if world > 1 and unit_batch % n_data:
        raise ValueError(
            f"per-step batch {unit_batch} is not divisible by the "
            f"{n_data}-wide data axis (multi-host meshes must span "
            "every process)")
    if tp > 1:
        return create_mesh_2d(n_data, tp)
    return create_mesh()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh, axis_name: str = DATA_AXIS):
    """This rank's rows of a batch (a tree of arrays or tensors with the
    batch leading): rows [r*B/n, (r+1)*B/n) for data-rank r of n.

    Requires batch size divisible by the DATA-axis size (not the whole
    mesh: on a dp x tp mesh only the data axis splits the batch), enforced
    loudly: an uneven split would skew the loss mean."""
    n = mesh.shape[axis_name]
    r = mesh.data_rank if axis_name == DATA_AXIS else mesh.model_rank

    def take(x):
        if x.shape[0] % n:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"{axis_name!r} axis size {n}")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return _tree_map(take, batch)


def replicate(tree, mesh: Mesh):
    """Replicate params and buffers (a module, or a tree of tensors) over
    the data axis: every rank takes data-rank 0's values, in place. Seeded
    inits and restores agree already; this makes it so."""
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = []
        _tree_map(tensors.append, tree)
    if mesh.active():
        from ann3depth_tpu_torch.parallel import multihost
        multihost.replicate_global(
            [t for t in tensors if isinstance(t, torch.Tensor)],
            src=dist.get_global_rank(mesh.data_group, 0),
            group=mesh.data_group)
    return tree
