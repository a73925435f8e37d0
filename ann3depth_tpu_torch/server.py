"""Batched depth-serving server: request queue -> coalesced device batches.

Counterpart of `ann3depth_tpu/server.py`. The host half (`_buckets`,
`BatchingService`, the HTTP handler and `DepthServer`) is a copy of the JAX
package's, unchanged:

  HTTP POST /v1/depth  (npy uint8 frame[s])  ->  npy f32 depth map[s]

One dispatch thread coalesces concurrent requests into batches of at most
`max_batch` frames within `max_delay_s`, padded up to a power-of-2 bucket.
`warmup(service)` runs every bucket once in the dispatch thread before
traffic. The wiring below builds the torch serving fn:
`service_from_config` (random-init weights or a checkpoint's, on one
device or, with dp > 1, replicated on several with each batch split across
them) and `service_from_artifact` (the port's exported program, or the
weights of a JAX artifact's params.npz). Each serves through a
`utils.graphs.GraphCache`: on the card the first batch of each bucket
captures a CUDA graph of the serving program (the JAX package's
`jax.jit(serve_fn)` compiles one program a bucket), and every later batch
of that size replays it; a warm-up therefore captures the whole ladder
before traffic. On the CPU the program runs eagerly.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

log = logging.getLogger(__name__)


def _buckets(max_batch: int, multiple: int = 1):
    """Power-of-2 bucket ladder; with `multiple` > 1 every bucket is a
    multiple of it (DP serving shards the batch over `multiple` devices,
    so every dispatched shape must divide evenly)."""
    out, b = [], multiple
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class BatchingService:
    """Coalesce concurrent single-frame requests into device batches.

    fixed_batch: pad EVERY dispatch to exactly this size (single bucket) —
    required when the serving fn only accepts one batch shape, e.g. an
    artifact exported with --serving-batch N.
    """

    def __init__(self, fn, raw_hw, *, max_batch=32, max_delay_s=0.005,
                 fixed_batch=None, batch_multiple=1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if batch_multiple < 1:
            raise ValueError(
                f"batch_multiple must be >= 1, got {batch_multiple}")
        if fixed_batch is not None:
            if int(fixed_batch) % batch_multiple:
                raise ValueError(
                    f"fixed_batch={fixed_batch} is not divisible by "
                    f"batch_multiple={batch_multiple}")
            max_batch = int(fixed_batch)
        elif max_batch % batch_multiple:
            # round up so the top bucket stays dispatchable
            max_batch += batch_multiple - max_batch % batch_multiple
        self._buckets = ([int(fixed_batch)] if fixed_batch is not None
                         else _buckets(max_batch, batch_multiple))
        self._fn = fn
        self.raw_hw = tuple(raw_hw)
        self.max_batch = int(max_batch)
        self.batch_multiple = int(batch_multiple)
        self.max_delay_s = float(max_delay_s)
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._batch_sizes: deque = deque(maxlen=1000)
        self._latencies: deque = deque(maxlen=1000)
        self._n_requests = 0
        self._n_batches = 0
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="depth-batcher")
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit(self, frame: np.ndarray) -> Future:
        """Enqueue one [H,W,3] uint8 frame; returns a Future of [h,w] f32
        depth. Submitting several frames before awaiting any lets them
        coalesce into one device batch."""
        frame = np.ascontiguousarray(frame)
        if frame.shape != (*self.raw_hw, 3) or frame.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 frame of shape {(*self.raw_hw, 3)}, got "
                f"{frame.dtype} {frame.shape}")
        if self._closed:
            raise RuntimeError("service is closed")
        fut: Future = Future()
        self._q.put((frame, fut, time.perf_counter()))
        return fut

    def predict(self, frame: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """One [H,W,3] uint8 frame -> [h,w] f32 depth (blocks)."""
        return self.submit(frame).result(timeout=timeout)

    def warmup(self):
        """Compile every batch bucket before taking traffic (the first
        request at each bucket otherwise pays its compile), in the
        caller's thread: with the port's serving fn on the card, this
        captures each bucket's CUDA graph, which the dispatch thread then
        replays."""
        zero = np.zeros((*self.raw_hw, 3), np.uint8)
        for b in self._buckets:
            self._fn(np.broadcast_to(zero, (b, *zero.shape)).copy())

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            hist: dict = {}
            for b in self._batch_sizes:
                hist[b] = hist.get(b, 0) + 1
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "batch_size_hist": {str(k): v for k, v in sorted(hist.items())},
                "latency_p50_ms": 1e3 * lat[len(lat) // 2] if lat else None,
                "latency_p99_ms": (1e3 * lat[max(0, int(len(lat) * 0.99) - 1)]
                                   if lat else None),
                "max_batch": self.max_batch,
                "batch_multiple": self.batch_multiple,
                "max_delay_ms": 1e3 * self.max_delay_s,
            }

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5)
        # A submit() racing close() can land after the shutdown sentinel
        # (its _closed check passed first); without this drain that future
        # never resolves and its client blocks until the result timeout.
        try:
            while True:
                item = self._q.get_nowait()
                if item is not None and not item[1].done():
                    item[1].set_exception(RuntimeError("service is closed"))
        except queue.Empty:
            pass

    # -- dispatch thread --------------------------------------------------

    def _collect(self):
        """Block for the first request, then soak up to max_batch for at
        most max_delay_s. Returns [] at shutdown."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(items) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-signal shutdown for the outer loop
                break
            items.append(nxt)
        return items

    def _run(self):
        while True:
            items = self._collect()
            if not items:
                return
            frames = np.stack([f for f, _, _ in items])
            n = len(items)
            bucket = next(b for b in self._buckets if b >= n)
            if bucket > n:  # pad with the first frame (any valid content)
                pad = np.broadcast_to(frames[0], (bucket - n, *frames.shape[1:]))
                frames = np.concatenate([frames, pad])
            try:
                depth = np.asarray(self._fn(frames))[:n]
            except Exception as e:  # propagate to every waiter, keep serving
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            now = time.perf_counter()
            for i, (_, fut, t0) in enumerate(items):
                if not fut.done():
                    fut.set_result(depth[i])
            with self._lock:
                self._n_requests += n
                self._n_batches += 1
                self._batch_sizes.append(n)
                self._latencies.extend(now - t0 for _, _, t0 in items)


def warmup(service: BatchingService):
    """Run every bucket once in the service's dispatch thread.

    `BatchingService.warmup` runs the buckets in the caller's thread, but
    PyTorch keeps cuDNN's handles and plan cache per thread, so the
    dispatch thread would pay them again on its first batch of each size.
    Submitting b frames before awaiting any coalesces them into one batch
    of b (the service is idle at startup)."""
    zero = np.zeros((*service.raw_hw, 3), np.uint8)
    for b in service._buckets:
        futs = [service.submit(zero) for _ in range(b)]
        for fut in futs:
            fut.result(timeout=600.0)


# -- wiring: config or artifact -> serving fn -----------------------------

def service_from_artifact(artifact_dir, *, device=None,
                          **kw) -> BatchingService:
    """Serve an artifact directory: the port's exported program, or the
    weights of a JAX `export_serving` artifact in the port's model code.

    A port artifact exported at a fixed batch runs that one input shape, so
    the service pins every dispatch to it; a batch-polymorphic one uses the
    normal bucket ladder. A JAX artifact runs eagerly in the port's model
    code, so any batch works and it keeps the ladder whatever its batch."""
    from ann3depth_tpu_torch import serving

    model = serving.load_serving(artifact_dir, device=device)
    fixed = model.meta.get("batch")
    if model.meta.get("format") == serving.FORMAT and fixed is not None:
        if kw.get("max_batch") not in (None, fixed):
            log.warning("artifact was exported with fixed batch %d; "
                        "overriding max_batch=%s", fixed, kw["max_batch"])
        kw = {**kw, "max_batch": fixed, "fixed_batch": fixed}
    return BatchingService(model.predict, model.meta["raw_hw"], **kw)


def _local_devices(device, dp, devices):
    """The devices data-parallel serving may use: `devices` as given (the
    counterpart of the JAX `create_mesh(devices)`), else the one device of
    a dp=1 service, else every local CUDA device (the CPU is one)."""
    import torch

    from ann3depth_tpu_torch.device import resolve_device

    if devices is not None:
        devices = [torch.device(d) for d in devices]
        for d in devices:
            resolve_device(d.type)
        return devices
    dev = resolve_device(device)
    if dp == 1 or dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def split_predictor(fns, devices):
    """numpy u8 [B,H,W,3] -> numpy f32 [B,h,w] over several replicas: the
    batch is cut into len(fns) equal parts, part i runs fns[i] on
    devices[i] (on a stream of its own on the card; every part is launched
    before any is read back), and the answers are concatenated in order.
    Each fn is a `GraphCache` on its device (`make_serving_fn` of that
    device's replica): it takes its part from the host, and captures and
    replays its graphs on that device's stream."""
    import torch

    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devices]

    def on(d, stream):
        if stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(d))
        ctx.enter_context(torch.cuda.stream(stream))
        return ctx

    def predict(img_u8):
        parts = np.split(np.ascontiguousarray(img_u8, dtype=np.uint8),
                         len(fns))
        outs = []
        for fn, d, stream, x in zip(fns, devices, streams, parts):
            with on(d, stream):
                outs.append(fn(torch.from_numpy(x)))
        answers = []
        for out, d, stream in zip(outs, devices, streams):
            with on(d, stream):
                answers.append(out.to("cpu", copy=True).numpy())
        return np.concatenate(answers)

    return predict


def service_from_config(cfg, *, ckpt_dir=None, init=False, raw_hw=(480, 640),
                        use_ema=False, ckpt_step=None, dp=1, device=None,
                        devices=None, **kw) -> BatchingService:
    """Serve the registry model of `cfg` on `device` (default CUDA).

    init=True serves random-init weights from cfg.train.seed; otherwise the
    params of the checkpoint in ckpt_dir (default cfg.train.ckpt_dir): the
    latest save, or the one at ckpt_step; use_ema serves its EMA params.

    dp > 1 replicates the model on the first `dp` local devices (every
    local CUDA device with dp=0, or the given `devices`) and splits every
    coalesced batch across them, one stream each (`split_predictor`), the
    serving twin of data-parallel training; bucket sizes become multiples
    of dp so every part has the same size."""
    from ann3depth_tpu_torch import serving

    devices = _local_devices(device, dp, devices)
    n_dp = len(devices) if dp == 0 else int(dp)
    if n_dp < 1 or n_dp > len(devices):
        raise ValueError(
            f"dp={dp} needs {n_dp} devices, have {len(devices)}")
    model = serving.model_from_checkpoint(
        cfg, ckpt_dir=ckpt_dir, use_ema=use_ema, ckpt_step=ckpt_step,
        device=devices[0], init=init)
    if n_dp == 1:
        fn = serving.make_serving_fn(model, cfg.data.input_hw)
        return BatchingService(serving.numpy_predictor(fn), raw_hw, **kw)
    replicas = [model] + [serving.prepare_model(copy.deepcopy(model), d)
                          for d in devices[1:n_dp]]
    fns = [serving.make_serving_fn(m, cfg.data.input_hw) for m in replicas]
    return BatchingService(split_predictor(fns, devices[:n_dp]), raw_hw,
                           **{**kw, "batch_multiple": n_dp})


# -- HTTP front end --------------------------------------------------------

def _make_handler(service: BatchingService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet; stats live at /v1/stats
            pass

        def _send(self, code, body: bytes, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._send_json(200, service.stats())
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/depth":
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
            except Exception as e:
                self._send_json(400, {"error": f"bad npy body: {e}"})
                return
            single = arr.ndim == 3
            frames = arr[None] if single else arr
            try:
                if frames.ndim != 4:
                    raise ValueError(f"expected [B,H,W,3] or [H,W,3] uint8, "
                                     f"got shape {arr.shape}")
                # Each frame goes through the shared batcher so concurrent
                # clients coalesce; a multi-frame body is just N requests
                # (all submitted before any is awaited).
                futs = [service.submit(f) for f in frames]
                depth = np.stack([f.result(timeout=30.0) for f in futs])
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except FuturesTimeoutError:
                self._send_json(503, {"error": "inference timed out "
                                               "(device overloaded?)"})
                return
            except RuntimeError as e:  # e.g. "service is closed"
                self._send_json(503, {"error": str(e)})
                return
            except Exception as e:  # device failure surfaced via the future
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            out = io.BytesIO()
            np.save(out, depth[0] if single else depth)
            self._send(200, out.getvalue())

    return Handler


class DepthServer:
    """ThreadingHTTPServer wrapper around a BatchingService."""

    def __init__(self, service: BatchingService, host="127.0.0.1", port=0):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(service))
        self.port = self.httpd.server_address[1]
        self._thread = None

    def serve_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="depth-http")
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.service.close()
