"""Warm-up effects on the served path, one condition per process.

    python -m ann3depth_tpu_torch.probe_serving            # on the card
    python -m ann3depth_tpu_torch.probe_serving --device cpu --small

A server process pays for state that is created on first use: the CUDA
libraries' handles and cuDNN's plans are per thread, and the first HTTP
traffic with large bodies costs the host time of its own. Each condition
runs in a fresh process (so each sees its own first HTTP round), serves
`make3d-encdec` with random weights through `DepthServer`, and prints one
JSON line:

- caller_warmup: `BatchingService.warmup` (every bucket, in the caller's
  thread), then the first two single frames and the first two 16-frame
  batches through the dispatch thread, then ROUNDS rounds of 8 concurrent
  single frames and one 4-frame body;
- dispatch_warmup: `server.warmup` (every bucket through the dispatch
  thread), then the same rounds;
- trivial_fn: a serving fn that returns zeros, the same rounds: the
  host's share alone;
- trivial_fn_one_post_first: the same, with one single-frame POST before
  the first round (the first HTTP exchange of the process made alone).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import io
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

CONDITIONS = ("caller_warmup", "dispatch_warmup", "trivial_fn",
              "trivial_fn_one_post_first")
ROUNDS = 5


def request_bodies(frames):
    """npy bodies of 8 single frames and one 4-frame body (12 frames)."""
    bodies = []
    for f in list(frames[:8]) + [frames[8:12]]:
        buf = io.BytesIO()
        np.save(buf, f)
        bodies.append(buf.getvalue())
    return bodies


def post(url, body):
    """POST one body; returns (response bytes, seconds)."""
    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        data = r.read()
    return data, time.perf_counter() - t0


def http_round(url, bodies):
    """All bodies posted concurrently; returns (results, seconds)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
        results = list(ex.map(lambda b: post(url, b), bodies))
    return results, time.perf_counter() - t0


def round_stats(results, seconds):
    lat = sorted(r[1] for r in results)
    return {"seconds": seconds, "p50_request_ms": 1e3 * lat[len(lat) // 2]}


def run_condition(condition, device, small):
    from ann3depth_tpu_torch import server
    from ann3depth_tpu_torch.config import get_config

    cfg = get_config("make3d-encdec")
    raw_hw = (480, 640)
    if small:
        raw_hw = (96, 128)
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, input_hw=(48, 64)),
            model=dataclasses.replace(cfg.model, width_mult=0.25))
    kw = dict(max_batch=32, max_delay_s=0.005)
    out = {"condition": condition, "device": device}
    if condition.startswith("trivial_fn"):
        h, w = cfg.data.input_hw
        svc = server.BatchingService(
            lambda f: np.zeros((f.shape[0], h // 2, w // 2), np.float32),
            raw_hw, **kw)
    else:
        svc = server.service_from_config(cfg, init=True, raw_hw=raw_hw,
                                         device=device, **kw)
    srv = server.DepthServer(svc, host="127.0.0.1", port=0)
    try:
        t0 = time.perf_counter()
        if condition == "caller_warmup":
            svc.warmup()
            zero = np.zeros((*raw_hw, 3), np.uint8)
            for n in (1, 16):
                times = []
                for _ in range(2):
                    t = time.perf_counter()
                    futs = [svc.submit(zero) for _ in range(n)]
                    for fut in futs:
                        fut.result(timeout=600)
                    times.append(1e3 * (time.perf_counter() - t))
                out[f"first_two_dispatch_batches_of_{n}_ms"] = times
        elif condition == "dispatch_warmup":
            server.warmup(svc)
        out["warmup_s"] = time.perf_counter() - t0
        srv.serve_background()
        url = f"http://127.0.0.1:{srv.port}/v1/depth"
        frames = np.random.default_rng(1).integers(
            0, 256, (12, *raw_hw, 3), dtype=np.uint8)
        bodies = request_bodies(frames)
        if condition == "trivial_fn_one_post_first":
            out["one_post_ms"] = 1e3 * post(url, bodies[0])[1]
        out["rounds"] = [round_stats(*http_round(url, bodies))
                         for _ in range(ROUNDS)]
    finally:
        srv.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="probe_serving")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="width 0.25, 48x64 input from 96x128 frames "
                         "(a CPU rehearsal size)")
    ap.add_argument("--condition", choices=CONDITIONS,
                    help="run one condition in this process")
    args = ap.parse_args(argv)
    if args.condition:
        print(json.dumps(run_condition(args.condition, args.device,
                                       args.small)), flush=True)
        return 0
    for condition in CONDITIONS:
        cmd = [sys.executable, "-m", "ann3depth_tpu_torch.probe_serving",
               "--condition", condition, "--device", args.device]
        subprocess.run(cmd + (["--small"] if args.small else []),
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
