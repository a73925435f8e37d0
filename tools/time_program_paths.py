"""Wall times of the paths whose device step runs once or a few times a
call: the training loop's in-loop evals and `infer --image`.

make3d-encdec at full width (b16) on synthetic scenes at Make3D's raw
shapes (RGB 480x640, depth grid 305x55), augmented, as chip_smoke.py's
phase 4 trains it: STEPS steps (warmup 10), logged every LOG_EVERY, an
in-loop eval of `loop.EVAL_SAMPLE_BATCHES` batches every EVAL_EVERY
steps. Then `infer --image` of one 480x640 frame through the CLI, CALLS
times, each call loading the checkpoint as the command does.

Prints one JSON line: the loop's logged images/s (each window of
LOG_EVERY steps; the loop restarts its clock after an eval), each in-loop
eval's wall seconds, each `infer --image` call's wall seconds, and the
card (`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).

It imports the port from the Python path, so one call times two trees:

    PYTHONPATH=<tree> python tools/time_program_paths.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

STEPS, LOG_EVERY, EVAL_EVERY, CALLS = 100, 10, 20, 3


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main():
    import numpy as np
    import torch
    from PIL import Image

    from ann3depth_tpu_torch import cli
    from ann3depth_tpu_torch.config import get_config
    from ann3depth_tpu_torch.train import loop

    if not torch.cuda.is_available():
        print("time_program_paths: no CUDA device", file=sys.stderr)
        return 2
    out = dict(tree=loop.__file__, card=_card())
    with tempfile.TemporaryDirectory() as tmp:
        cfg = get_config("make3d-encdec")
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, datasets=("synthetic",),
                                     synth_img_hw=(480, 640),
                                     synth_depth_hw=(305, 55), synth_n=64,
                                     augment=True),
            train=dataclasses.replace(cfg.train, steps=STEPS,
                                      warmup_steps=10, log_every=LOG_EVERY,
                                      checkpoint_every=0,
                                      eval_every=EVAL_EVERY,
                                      ckpt_dir=f"{tmp}/ckpt"))
        evals = []
        inner = loop.evaluate

        def timed(*a, **kw):
            t0 = time.perf_counter()
            metrics = inner(*a, **kw)
            evals.append(time.perf_counter() - t0)
            return metrics

        loop.evaluate = timed
        try:
            t0 = time.perf_counter()
            loop.train(cfg, workdir=tmp, progress=False)
            out["train_s"] = time.perf_counter() - t0
        finally:
            loop.evaluate = inner
        with open(f"{tmp}/metrics.jsonl") as f:
            rows = [json.loads(x) for x in f]
        out.update(
            loop_images_per_s=[r["images_per_sec"] for r in rows
                               if "images_per_sec" in r],
            eval_s=evals)

        frame = np.random.default_rng(0).integers(0, 256, (480, 640, 3),
                                                  dtype=np.uint8)
        Image.fromarray(frame).save(f"{tmp}/frame.png")
        infer_s = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            rc = cli.main(["infer", "--config", "make3d-encdec",
                           "--ckpt-dir", f"{tmp}/ckpt", "--image",
                           f"{tmp}/frame.png", "--out-dir", f"{tmp}/out"])
            torch.cuda.synchronize()
            infer_s.append(time.perf_counter() - t0)
            if rc:
                raise SystemExit(f"infer exited {rc}")
        out["infer_image_s"] = infer_s
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
