"""Device-resident dataset cache: stage the raw dataset into device memory
once, gather batches on the device, with no per-step host feed.

Counterpart of `ann3depth_tpu/pipeline/device_cache.py`. The
raw uint8 frames and f32 depth maps of a dataset go into two preallocated
device tensors, `pool_img [N, ...]` and `pool_dep [N, ...]`; a step's batch
is `pool[idx]` with a device index (plain tensor indexing, as the JAX
package gathers with jnp indexing). In steady state nothing crosses the
host link but one index row a step, and under `steps_per_dispatch` (a CUDA
graph of the step, train/dispatch.py) one index block a dispatch.

Staging is bounded in host memory: rows are read from the dataset into a
pinned staging buffer in chunks of at most STAGE_CHUNK_BYTES and copied
into the device tensors on a side CUDA stream, two staging buffers in
turn, so at most two chunks are in flight and a chunk's decode overlaps
the previous chunk's transfer.

The sampling order is the JAX sampler's: per epoch one permutation of the
rank's shard from `np.random.default_rng(seed + 1000003 * pid)`, cut into
batches. Under data parallelism (one process per device) rank r of n holds
shard r of the dataset, as the JAX sampler gives process r its devices'
shards; on one device the shard is the whole (pid 0).

Selected with DataConfig.cache_device / --cache-device. Raises when the
dataset exceeds the byte budget.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ann3depth_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

# Leave headroom for params/activations/scratch.
DEFAULT_BYTE_BUDGET = 8 << 30

# Host-RAM bound for pool staging: rows are decoded and transferred in
# chunks of at most this many bytes (see stage_rows).
STAGE_CHUNK_BYTES = 256 << 20

_UNIFORM = ("device cache needs uniform example shapes — pack the dataset "
            "first (`prepare` subcommand) or drop --cache-device")


def stack_dataset(dataset):
    """Materialize a uniform-shape dataset -> (img_u8 [N,...], dep [N,...])
    host arrays.

    Fills preallocated arrays in place: collecting per-example tuples and
    np.stack-ing would transiently hold TWO copies of a multi-GB dataset
    on the host (Make3D raw is ~4 GB)."""
    n = len(dataset)
    img0, dep0 = dataset[0]
    imgs = np.empty((n, *np.shape(img0)), np.asarray(img0).dtype)
    deps = np.empty((n, *np.shape(dep0)), np.asarray(dep0).dtype)
    imgs[0], deps[0] = img0, dep0
    for i in range(1, n):
        im, de = dataset[i]
        if np.shape(im) != imgs.shape[1:] or np.shape(de) != deps.shape[1:]:
            raise ValueError(_UNIFORM)
        imgs[i], deps[i] = im, de
    return imgs, deps


class RowView:
    """Read-only dataset view through a sequence of row indices (a rank's
    shard, a window's permutation slice) without materializing rows."""

    def __init__(self, dataset, rows):
        self._dataset = dataset
        self._rows = rows

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        return self._dataset[int(self._rows[i])]


def torch_dtype(np_dtype):
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def pool_buffers(n, img0, dep0, device):
    """Uninitialized device tensors for n rows shaped like img0 / dep0."""
    return (torch.empty((n, *img0.shape), device=device,
                        dtype=torch_dtype(img0.dtype)),
            torch.empty((n, *dep0.shape), device=device,
                        dtype=torch_dtype(dep0.dtype)))


def stage_rows(dataset, n, pool_img, pool_dep, chunk_bytes, stream=None):
    """Copy dataset rows [0, n) into pool_img[:n] / pool_dep[:n] without
    materializing a whole field on the host.

    Rows are read in chunks of at most chunk_bytes into one of two pinned
    staging buffers and copied to the device on `stream` (default: a new
    side stream, which first waits for the current stream's work, so the
    destination's earlier readers are done). The host waits for chunk
    k - 2's copy before it refills that chunk's buffer: at most two chunks
    are in flight. Returns the event recorded after the last copy, which
    the reader's stream waits on (None on the CPU, where the copies are
    plain)."""
    img0 = np.asarray(dataset[0][0])
    dep0 = np.asarray(dataset[0][1])
    ex_bytes = img0.nbytes + dep0.nbytes
    chunk_n = min(n, max(1, int(chunk_bytes // ex_bytes)))
    cuda = pool_img.device.type == "cuda"
    if cuda and stream is None:
        stream = torch.cuda.Stream(pool_img.device)
        stream.wait_stream(torch.cuda.current_stream(pool_img.device))
    total_bytes = n * ex_bytes
    done_bytes = 0
    t0 = last_log = time.perf_counter()
    bufs, copied, event = {}, [None, None], None
    for k, a in enumerate(range(0, n, chunk_n)):
        b = min(n, a + chunk_n)
        slot = k % 2
        if cuda:
            if copied[slot] is not None:
                copied[slot].synchronize()
            if slot not in bufs:
                bufs[slot] = (
                    torch.empty((chunk_n, *img0.shape), pin_memory=True,
                                dtype=pool_img.dtype),
                    torch.empty((chunk_n, *dep0.shape), pin_memory=True,
                                dtype=pool_dep.dtype))
            ci, cd = (x[:b - a] for x in bufs[slot])
        else:
            ci, cd = pool_img[a:b], pool_dep[a:b]
        for j in range(a, b):
            im, de = dataset[j]
            if np.shape(im) != img0.shape or np.shape(de) != dep0.shape:
                raise ValueError(_UNIFORM)
            ci[j - a] = torch.from_numpy(np.asarray(im))
            cd[j - a] = torch.from_numpy(np.asarray(de))
        if cuda:
            with torch.cuda.stream(stream):
                pool_img[a:b].copy_(ci, non_blocking=True)
                pool_dep[a:b].copy_(cd, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            copied[slot] = event
        done_bytes += (b - a) * ex_bytes
        now = time.perf_counter()
        if now - last_log > 15.0 and done_bytes < total_bytes:
            rate = done_bytes / max(now - t0, 1e-9)
            log.info("device cache: staging %.0f/%.0f MB (%.1f MB/s, ~%.0f "
                     "s left)", done_bytes / 1e6, total_bytes / 1e6,
                     rate / 1e6, (total_bytes - done_bytes) / max(rate, 1.0))
            last_log = now
    return event


def bind_thread(device):
    """Make `device` the current CUDA device of the calling thread (a
    worker thread starts on device 0); nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())


def to_index(idx, device):
    """A host index row (or block) -> an int64 tensor on `device` (the
    span `a3d.pool.index_copy` while a profiler window is open)."""
    with tracing.span("pool.index_copy"):
        return torch.from_numpy(np.asarray(idx, np.int64)).to(device)


class DevicePoolSampler:
    """Iterable of (img_u8, depth) device batches gathered from a
    device-resident pool; the train loop's `for (img, dep) in feed`
    contract of pipeline.feed.DeviceFeed."""

    def __init__(self, dataset, batch_size, device=None, *, steps=None,
                 seed=0, byte_budget=DEFAULT_BYTE_BUDGET,
                 stage_chunk_bytes=STAGE_CHUNK_BYTES, rank=0, nproc=1):
        # The JAX sampler on a data axis of `nproc` ranks, one device each:
        # rank r stages and samples shard r (rows [r*shard, (r+1)*shard) of
        # the shard-trimmed dataset), with process index r.
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if batch_size % nproc:
            raise ValueError(
                f"batch_size={batch_size} not divisible by data axis "
                f"{nproc}")
        # Trim to a shard-divisible example count (mirrors drop_remainder).
        n = (len(dataset) // nproc) * nproc
        if n < len(dataset):
            log.info("device cache: trimming %d example(s) for %d-way "
                     "sharding", len(dataset) - n, nproc)
        if n == 0:
            raise ValueError(
                f"dataset n={len(dataset)} is too small for {nproc}-way "
                "sharding")
        img0, dep0 = dataset[0]
        img0, dep0 = np.asarray(img0), np.asarray(dep0)
        nbytes = (n // nproc) * (img0.nbytes + dep0.nbytes)
        if nbytes > byte_budget:
            raise ValueError(
                f"dataset is {nbytes / 1e9:.1f} GB raw per process — over "
                f"the {byte_budget / 1e9:.1f} GB device-cache budget; use "
                "the rotating-window pool (--cache-window-mb, optionally "
                "--window-epochs) or drop --cache-device")
        self.n = n
        self.nbytes = nbytes  # raw pool bytes of this rank (budget math)
        self.shard = n // nproc
        self.per_dev = batch_size // nproc
        # The hazard iter_batches guards with the same error: a batch that
        # can't be filled would otherwise make __iter__ spin forever
        # computing empty epochs without yielding.
        if self.per_dev > self.shard:
            raise ValueError(
                f"batch_size={batch_size} needs {self.per_dev} examples "
                f"per device but each of the {nproc} shard(s) has "
                f"only {self.shard} (dataset n={len(dataset)})")
        self.batch_size = batch_size
        self.steps = steps
        self.seed = seed
        self.device = torch.device(device or "cpu")
        # decorrelate the shard-local shuffles across ranks
        self._rng = np.random.default_rng(seed + 1000003 * rank)

        self.pool_img, self.pool_dep = pool_buffers(self.shard, img0, dep0,
                                                    self.device)
        start = rank * self.shard
        event = stage_rows(RowView(dataset, range(start, start + self.shard)),
                           self.shard, self.pool_img, self.pool_dep,
                           stage_chunk_bytes)
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        log.info("device cache: staged %d examples (%.0f MB) on %s, rank "
                 "%d/%d", self.shard, nbytes / 1e6, self.device, rank, nproc)

    def gather(self, idx):
        """(pool_img[idx], pool_dep[idx]) for a device index row."""
        return self.pool_img[idx], self.pool_dep[idx]

    def _total_steps(self):
        # steps=None -> exactly one epoch (iter_batches' contract).
        return (self.shard // self.per_dev if self.steps is None
                else self.steps)

    def _local_index_stream(self):
        """Host-side per-step index rows [per_dev] i32 — the
        single source of the sampling order for both the per-step iterator
        and the K-step driver."""
        step, total = 0, self._total_steps()
        while step < total:
            perm = self._rng.permutation(self.shard)
            for b in range(self.shard // self.per_dev):
                if step >= total:
                    return
                yield perm[b * self.per_dev:(b + 1) * self.per_dev].astype(
                    np.int32)
                step += 1

    def __iter__(self):
        for idx in self._local_index_stream():
            yield self.gather(to_index(idx, self.device))

    def index_blocks(self, k: int):
        """[k, per_dev] int64 device index blocks — k steps of the SAME
        sampling stream __iter__ walks, grouped for the K-step driver
        (train/dispatch.py: steps_per_dispatch)."""
        if k < 1:
            raise ValueError(f"index_blocks needs k >= 1, got {k}")
        total = self._total_steps()
        if total % k:
            raise ValueError(
                f"steps={total} is not divisible by the {k}-step dispatch "
                "block (validated upstream; this is a hard shape "
                "constraint of the K-step dispatch)")
        stream = self._local_index_stream()
        for _ in range(total // k):
            yield to_index(np.stack([next(stream) for _ in range(k)]),
                           self.device)

    def fixed_batches(self, k: int):
        """Yield the SAME k batches on every call: the first `per_dev`
        examples of each shard in split order (no shuffle, no rng) — the
        deterministic fixed sample the in-loop eval compares across epochs
        (early stopping needs eval noise to come from the model, not the
        sample). Gathers from the resident pool: no H2D of data."""
        if k * self.per_dev > self.shard:
            raise ValueError(
                f"fixed_batches({k}) needs {k * self.per_dev} examples per "
                f"shard but shards hold {self.shard}")
        for b in range(k):
            idx = np.arange(b * self.per_dev, (b + 1) * self.per_dev)
            yield self.gather(to_index(idx, self.device))

    def close(self):
        """Free the device pool (DeviceFeed API compatibility)."""
        self.pool_img = self.pool_dep = None
