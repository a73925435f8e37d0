"""Batched depth-serving server: request queue -> coalesced device batches.

Counterpart of `ann3depth_tpu/server.py`. The host half (`_buckets`,
`BatchingService`, the HTTP handler and `DepthServer`) is a copy of the JAX
package's, unchanged:

  HTTP POST /v1/depth  (npy uint8 frame[s])  ->  npy f32 depth map[s]

One dispatch thread coalesces concurrent requests into batches of at most
`max_batch` frames within `max_delay_s`, padded up to a power-of-2 bucket.
`warmup(service)` runs every bucket once in the dispatch thread before
traffic (on the card that builds the kernel and lets cuDNN pick its
algorithms for that thread). The wiring below builds the
torch serving fn: `service_from_config` (random-init weights) and
`service_from_artifact` (weights from a JAX artifact's params.npz).
Serving from a checkpoint and data-parallel serving (dp > 1) wait for a
later slice of the port, and asking for them raises.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


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
        request at each bucket otherwise pays its XLA compile)."""
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
    """Serve the weights of a JAX `export_serving` artifact directory.

    The port runs its own model code eagerly, so any batch size works and
    the normal bucket ladder is used even for a fixed-batch artifact."""
    from ann3depth_tpu_torch import serving

    model = serving.load_serving(artifact_dir, device=device)
    return BatchingService(model.predict, model.meta["raw_hw"], **kw)


def service_from_config(cfg, *, ckpt_dir=None, init=False, raw_hw=(480, 640),
                        dp=1, device=None, **kw) -> BatchingService:
    """Serve the registry model of `cfg` (init=True: random-init weights
    from cfg.train.seed) on `device` (default CUDA)."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.device import resolve_device
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.train import step as steplib

    if not init:
        raise NotImplementedError(
            f"serving from a checkpoint ({ckpt_dir or cfg.train.ckpt_dir}) is "
            "not ported yet; pass init=True (--init) or serve an artifact")
    if dp != 1:
        raise NotImplementedError(f"dp={dp}: data-parallel serving is not "
                                  "ported yet")
    device = resolve_device(device)
    model = steplib.init_params(registry.build(cfg.model), cfg.train.seed)
    model = serving.prepare_model(model, device)
    fn = serving.make_serving_fn(model, cfg.data.input_hw)
    return BatchingService(serving.numpy_predictor(fn, device), raw_hw, **kw)


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
