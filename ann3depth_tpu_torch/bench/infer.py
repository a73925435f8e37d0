"""Serving-throughput benchmark: raw uint8 frames -> linear depth.

Counterpart of `benchmarks/bench_infer.py`: the batched serving program
(`serving.make_serving_fn`: the v1 preprocess kernel, the model's forward,
exp) on a pool of 4 batches made on the device.

The JAX bench times a scan of 30 batches in one program. Here each pool
entry has a CUDA graph of the serving fn that reads that entry, and a rep
replays them in turn, 30 a rep. A capture error raises; nothing falls back
to eager timing. On the CPU there is no graph: the same calls run eagerly.

It writes no `benchmarks/results.jsonl`: the printed line is the record.
"""

from __future__ import annotations

import time

import torch

from ann3depth_tpu_torch import serving
from ann3depth_tpu_torch.device import resolve_device
from ann3depth_tpu_torch.models import registry
from ann3depth_tpu_torch.train import step as steplib
from ann3depth_tpu_torch.utils import flops as flopslib
from ann3depth_tpu_torch.utils.tracing import device_sync

K = 30
POOL_ENTRIES = 4


class Replay:
    """`fn(x)` on one fixed input: the replay of a CUDA graph captured from
    it on the card, the eager call on the CPU. `out` holds the last
    output (on the card, the graph's static output)."""

    def __init__(self, fn, x, pool=None):
        self.fn, self.x = fn, x
        self.graph = None
        self.out = None
        if x.device.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn(x)

    def __call__(self):
        if self.graph is None:
            self.out = self.fn(self.x)
        else:
            self.graph.replay()
        return self.out


def serving_graphs(fn, pool):
    """One `Replay` of `fn` per entry of `pool` ([N, B, H, W, 3] uint8), its
    graphs sharing one memory pool (they replay one after another). On the
    card `fn` runs once a entry on a side stream first: a capture runs no
    kernel, and the first calls load what a capture cannot (the kernel
    library, cuDNN's and cuBLAS's handles and plans, the cached identity
    rows)."""
    entries = [pool[i] for i in range(pool.shape[0])]
    if pool.device.type != "cuda":
        return [Replay(fn, x) for x in entries]
    side = torch.cuda.Stream(pool.device)
    side.wait_stream(torch.cuda.current_stream(pool.device))
    with torch.cuda.stream(side):
        for x in entries:
            fn(x)
    torch.cuda.current_stream(pool.device).wait_stream(side)
    first = Replay(fn, entries[0])
    return [first] + [Replay(fn, x, pool=first.graph.pool())
                      for x in entries[1:]]


def run(cfg, batch=32, steps=60, raw_hw=(480, 640), model=None, tag=None,
        device=None) -> dict:
    """Images/s and ms a batch of the serving fn of `model` (default: built
    from cfg.model; its params initialized from seed 0, its quant
    cfg.model.quant) at `batch` frames of `raw_hw`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    input_hw = tuple(cfg.data.input_hw)
    model = model if model is not None else registry.build(cfg.model)
    model = serving.prepare_model(
        steplib.init_params(model, input_hw, seed=0), dev)
    fn = serving.make_serving_fn(model, input_hw)
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = torch.randint(0, 256, (POOL_ENTRIES, batch, *raw_hw, 3),
                         dtype=torch.uint8, generator=gen, device=dev)

    batch_fl = flopslib.step_flops(fn, pool[0])
    replays = serving_graphs(fn, pool)

    def rep():
        for i in range(K):
            replays[i % len(replays)]()

    for _ in range(2):
        rep()
    device_sync(dev)
    reps = max(1, steps // K)
    t0 = time.perf_counter()
    for _ in range(reps):
        rep()
    device_sync(dev)
    dt = time.perf_counter() - t0
    total = reps * K

    result = {
        "bench": "infer_throughput",
        "model": tag or cfg.model.name,
        "batch_size": batch,
        "input_hw": list(input_hw),
        "backend": dev.type,
        "images_per_sec": round(batch * total / dt, 2),
        "batch_ms": round(dt / total * 1e3, 3),
        "time": time.time(),
    }
    flopslib.attach_mfu(result, batch_fl, total, dt,
                        dtype="int8" if cfg.model.quant == "int8" else "bf16",
                        device=dev)
    flopslib.attach_memory(result, dev)
    return result
