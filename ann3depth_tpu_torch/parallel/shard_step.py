"""Explicit-collective data-parallel train step.

Counterpart of `ann3depth_tpu/parallel/shard_step.py`. The JAX package has
two realizations of data-parallel training: the production path, where
jit's sharding propagation derives the gradient all-reduce, and this one,
written with shard_map and an explicit `pmean`. In the port the production
path's all-reduce is explicit too (`train.step.allreduce_gradients`, which
`train_step` calls when its state has a mesh); this module keeps the JAX
twin's own semantics as the cross-check: the scale-invariant loss, no
EMA, loss and rmse averaged over the ranks (a mean of per-rank rmse, as
the JAX twin's pmean), and augmentation drawn per shard from a seed
folded with the step and the rank (each shard its own draws, which is not
the loop's global-batch semantics).
"""

from __future__ import annotations

import numpy as np
import torch

from ann3depth_tpu_torch.pipeline import preprocess
from ann3depth_tpu_torch.train import losses
from ann3depth_tpu_torch.train.step import allreduce_gradients


def shard_seed(seed: int, step: int, rank: int) -> int:
    """The augmentation seed of one shard of one step."""
    return int(np.random.SeedSequence((seed, step, rank)).generate_state(
        1, np.uint64)[0])


def make_dp_train_step(mesh, *, input_hw, target_hw, si_lambda=0.5,
                       augment=False, seed=0):
    """Build the step over `mesh`'s data axis.

    Returned fn: (state, img_u8 [b,H,W,3], depth [b,dh,dw]) -> (state,
    metrics), with this rank's b = B / n_data rows of the global batch.
    The state is replicated; each rank computes gradients on its rows,
    averages them over the data axis in one all-reduce and applies the
    identical update, so the replicas stay equal."""
    input_hw, target_hw = tuple(input_hw), tuple(target_hw)

    def step(state, img_u8, depth_raw):
        generator = None
        if augment:
            generator = torch.Generator(device=img_u8.device).manual_seed(
                shard_seed(seed, state.step, mesh.data_rank))
        images, depths = preprocess.preprocess_batch(
            img_u8, depth_raw, input_hw, target_hw, generator=generator)
        state.optimizer.zero_grad(set_to_none=True)
        pred_log = state.model(images)
        loss = losses.scale_invariant_log_loss(pred_log, depths,
                                               lam=si_lambda)
        loss.backward()
        with torch.no_grad():
            rmse = losses.depth_metrics(pred_log.detach(), depths)["rmse"]
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        means, _ = allreduce_gradients(
            mesh, grads, {"loss": loss.detach(), "rmse": rmse})
        grad_norm = state.tx.apply(state.optimizer, state.step)
        state.step += 1
        return state, {**means, "grad_norm": grad_norm}

    return step
