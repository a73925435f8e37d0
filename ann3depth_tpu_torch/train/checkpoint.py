"""Checkpoint save and restore in a torch format.

Counterpart of `ann3depth_tpu/train/checkpoint.py` (which writes orbax
checkpoints; the port does not read those). Each checkpoint is one file,
`<ckpt_dir>/ckpt_<step>.pt`, holding the step, the model's state_dict, the
optimizer's state_dict and, when the trainer keeps one, the EMA params. A
save writes a temporary file and renames it into place, so a checkpoint
that exists is complete. The newest `max_to_keep` are kept.

A run over several processes saves from every rank (a tensor-parallel or
ZeRO-1 state gathers its shards into the single-device layout, a
collective) and rank 0 writes; every rank restores, keeping its shards.
So a checkpoint reads the same whatever mode wrote it.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ann3depth_tpu_torch.parallel import multihost

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{int(step)}.pt")

    def save(self, step: int, state) -> None:
        """Save step, params, optimizer state and (if kept) the EMA, then
        delete the oldest checkpoints beyond max_to_keep. Every rank of a
        process group calls it; rank 0 writes."""
        model, optimizer, ema = state.full_state()
        if multihost.process_index() != 0:
            return
        payload = {"step": int(state.step), "model": model,
                   "optimizer": optimizer}
        if ema is not None:
            payload["ema_params"] = ema
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            self.delete(old)

    def all_steps(self):
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def delete(self, step: int):
        os.remove(self._path(step))

    def _resolve_step(self, step):
        """None -> latest; an explicit step must exist."""
        if step is None:
            return self.latest_step()
        if step not in self.all_steps():
            raise ValueError(f"no checkpoint at step {step} in {self.dir}; "
                             f"have {self.all_steps()}")
        return step

    def _load(self, step, state):
        device = next(state.model.parameters()).device
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def restore(self, state, step=None):
        """Restore into `state` in place; returns (state, step), or
        (state, None) when there is no checkpoint.

        A run that keeps an EMA but restores a checkpoint without one
        re-seeds the EMA from the restored params."""
        step = self._resolve_step(step)
        if step is None:
            return state, None
        saved = self._load(step, state)
        ema = (saved.get("ema_params") if state.ema_params is not None
               else None)
        state.load_full_state(saved["model"], saved["optimizer"], ema)
        state.step = int(saved["step"])
        if state.ema_params is not None and ema is None:
            state.ema_params = {k: v.detach().clone()
                                for k, v in state.model.named_parameters()}
        return state, step

    def restore_params(self, state, use_ema: bool = False, step=None):
        """Restore only the step and the params (the EMA params with
        use_ema) into `state.model`, whatever the optimizer."""
        step = self._resolve_step(step)
        if step is None:
            return state, None
        saved = self._load(step, state)
        if use_ema:
            if "ema_params" not in saved:
                raise ValueError(
                    f"checkpoint {step} in {self.dir} has no ema_params — "
                    "it was trained without ema_decay")
            state.model.load_state_dict(saved["ema_params"])
        else:
            state.model.load_state_dict(saved["model"])
        state.step = int(saved["step"])
        return state, step

    def restore_avg_params(self, state, k: int, use_ema: bool = False):
        """Uniform average of the params (the EMA params with use_ema) of
        the last k retained checkpoints, loaded into `state.model`.
        Returns (state, [averaged steps]); state.step is the newest
        averaged step. Raises when fewer than k checkpoints exist."""
        if k < 1:
            raise ValueError(f"avg_last must be >= 1, got {k}")
        steps = self.all_steps()
        if len(steps) < k:
            raise ValueError(
                f"avg_last={k} but only {len(steps)} checkpoints are "
                f"retained in {self.dir} (steps {steps}); raise "
                "max_to_keep / checkpoint more often or lower k")
        steps = steps[-k:]
        acc = None
        for s in steps:
            self.restore_params(state, use_ema=use_ema, step=s)
            sd = state.model.state_dict()
            acc = ({n: v.clone() for n, v in sd.items()} if acc is None
                   else {n: acc[n] + v for n, v in sd.items()})
        inv = 1.0 / float(len(steps))
        state.model.load_state_dict({n: (v * inv).to(v.dtype)
                                     for n, v in acc.items()})
        state.step = steps[-1]
        return state, steps
