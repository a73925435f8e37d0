"""Multi-process data-parallel training: one process per device, joined in
a `torch.distributed` process group.

Counterpart of `ann3depth_tpu/parallel/multihost.py`. The JAX package runs
one process per host, each driving its host's devices through one mesh;
the port runs one process per device. `initialize` joins (or forms) the
group: NCCL where the device is CUDA, gloo on the CPU, or the backend the
caller names (gloo also runs on CUDA tensors: several ranks may then share
one card, which NCCL refuses). Each rank binds `cuda:{local_rank}`.

What multi-process changes, and all it changes:
- data: each rank reads its strided slice of the dataset
  (`data.batching.ProcessShardView`) and feeds batch_size/nproc rows per
  step; a device pool holds the rank's shard (pipeline/device_cache.py);
- the step: gradients are averaged over the ranks in one all-reduce
  (train/step.py), or reduce-scattered under ZeRO-1 (parallel/zero1.py);
- output: checkpoints, metrics, TensorBoard and viz are written by rank 0;
  every rank restores.

Tested with two CPU processes over gloo (tests/test_torch_multiprocess.py)
and two ranks on one card over gloo (chip_smoke.py, phase 11).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name):
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(coordinator=None, num_processes=None, process_id=None, *,
               device="cuda", backend=None, timeout_s=DEFAULT_TIMEOUT_S):
    """Join (or form) the process group; a no-op once joined.

    With no coordinator, reads torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), as the JAX package defers to
    jax.distributed.initialize()'s auto-detection. An explicit
    coordinator ("host:port") needs num_processes and process_id: the
    CPU-test and bare-metal path. backend: None picks nccl for a CUDA
    device and gloo for the CPU. On CUDA the rank then binds its local
    device."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; have nccl | gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda; the CPU "
                         "runs gloo")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init_method = f"tcp://{coordinator}"
        rank, world = int(process_id), int(num_processes)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(
                "no process group to join: pass --coordinator HOST:PORT "
                "--num-processes N --process-id I, or launch with torchrun "
                f"(missing {', '.join(missing)})")
        init_method = "env://"
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} not in [0, {world})")
    if device.type == "cuda":
        torch.cuda.set_device(_local_device_index(rank, backend))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def _local_device_index(rank, backend):
    """cuda:{local_rank}; LOCAL_RANK (torchrun) or the rank itself. Under
    gloo, ranks beyond the card count share the cards in turn."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    count = torch.cuda.device_count()
    if local >= count:
        if backend == "nccl":
            raise ValueError(
                f"rank {rank} needs cuda:{local}, have {count} device(s); "
                "nccl runs one rank per card (--dist-backend gloo shares "
                "a card)")
        local %= count
    return local


def local_device(device=None) -> torch.device:
    """The rank's device: cuda -> cuda:{the bound index} once initialized
    on CUDA, else the device as given (None -> cuda)."""
    device = torch.device("cuda" if device is None else device)
    if (device.type == "cuda" and device.index is None
            and dist.is_initialized()):
        return torch.device("cuda", torch.cuda.current_device())
    return device


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str:
    """The group's backend, or "" when there is none."""
    return dist.get_backend() if dist.is_initialized() else ""


def replicate_global(tensors, src=0, group=None):
    """Broadcast every tensor (in place) from rank `src` of `group`
    (default: every rank) and return them: the counterpart of placing one
    host value on every process. A no-op without a process group."""
    tensors = list(tensors)
    if dist.is_initialized():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return tensors


def replicated_key(seed: int, device=None) -> torch.Generator:
    """A generator seeded alike on every rank (the JAX replicated key)."""
    return torch.Generator(device=device or "cpu").manual_seed(int(seed))


def shutdown():
    """Leave the process group (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()
