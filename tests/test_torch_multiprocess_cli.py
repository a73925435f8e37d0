"""`python -m ann3depth_tpu_torch train|eval` over two CPU processes (gloo,
`--device cpu --coordinator 127.0.0.1:PORT --num-processes 2 --process-id
i`): the data-parallel loop, ZeRO-1, tensor parallelism, the device pool,
kill then resume, and eval across the ranks against one process.

The children run the port's CLI only (no JAX), each with a timeout; a
stuck rank kills both and fails the test.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch.train.checkpoint import CheckpointManager

from test_torch_multiprocess import child_env, free_port, wait_all

ROOT = Path(__file__).resolve().parent.parent
# encdec at width 0.25 on small synthetic scenes (test split: 8 scenes)
SMALL = ["--config", "make3d-encdec", "--datasets", "synthetic",
         "--synth-n", "16", "--synth-test-n", "8", "--synth-hw", "40", "56",
         "--synth-depth-hw", "15", "11", "--width-mult", "0.25",
         "--batch-size", "4", "--device", "cpu"]


def spawn(argv, world=2):
    """Start the CLI on `world` ranks; returns the processes."""
    port = str(free_port())
    return [subprocess.Popen(
        [sys.executable, "-m", "ann3depth_tpu_torch", *argv,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(world), "--process-id", str(r)],
        cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def run(argv, world=2):
    """Run the CLI on `world` ranks; returns each rank's stdout lines."""
    outs = wait_all(spawn(argv, world))
    return [out.strip().splitlines() for out, _ in outs]


def last_json(lines):
    return json.loads(lines[-1])


def test_two_rank_train_writes_from_rank_0(tmp_path):
    """The data-parallel loop through the CLI: rank 0 prints the metrics
    and writes metrics.jsonl (with the in-loop eval) and the checkpoints;
    rank 1 writes nothing."""
    ckpt = tmp_path / "ckpt"
    outs = run(["train", *SMALL, "--steps", "4", "--log-every", "2",
                "--checkpoint-every", "2", "--eval-every", "2",
                "--ckpt-dir", str(ckpt), "--workdir",
                str(tmp_path / "wd")])
    assert np.isfinite(last_json(outs[0])["loss"])
    assert not [line for line in outs[1] if line.startswith("{")]
    rows = [json.loads(line) for line in
            (tmp_path / "wd" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [2, 4]
    assert any("eval_rmse" in r for r in rows)
    assert CheckpointManager(str(ckpt)).all_steps() == [2, 4]


def test_zero1_checkpoint_resumes_replicated(tmp_path):
    """`train --zero1` on two ranks, then its checkpoint resumed by ZeRO-1
    on two ranks and by a replicated one-process run: both continue the
    step counter from the full optimizer state the checkpoint holds."""
    ckpt = tmp_path / "z"
    outs = run(["train", *SMALL, "--zero1", "--steps", "2",
                "--checkpoint-every", "2", "--ckpt-dir", str(ckpt)])
    assert np.isfinite(last_json(outs[0])["loss"])
    saved = CheckpointManager(str(ckpt))._load(
        2, type("S", (), {"model": __import__("torch").nn.Linear(1, 1)})())
    moments = saved["optimizer"]["state"]
    shapes = {k: tuple(v.shape) for k, v in saved["model"].items()}
    names = list(saved["model"])
    for i, st in moments.items():
        assert tuple(st["exp_avg"].shape) == shapes[names[int(i)]]
    outs = run(["train", *SMALL, "--zero1", "--steps", "4", "--resume",
                "--checkpoint-every", "2", "--ckpt-dir", str(ckpt)])
    assert np.isfinite(last_json(outs[0])["loss"])
    assert cli.main(["train", *SMALL, "--steps", "6", "--resume",
                     "--checkpoint-every", "2", "--ckpt-dir",
                     str(ckpt)]) == 0
    assert CheckpointManager(str(ckpt)).all_steps() == [2, 4, 6]


def test_two_rank_tensor_parallel_dpt_small(tmp_path):
    """`train --tp 2 --model dpt-small` on two ranks (dp 1 x tp 2), then
    `eval` of its checkpoint in one process: the checkpoint holds the
    single-device layout."""
    ckpt = tmp_path / "tp"
    outs = run(["train", "--config", "smoke", "--model", "dpt-small",
                "--device", "cpu", "--tp", "2", "--steps", "2",
                "--synth-n", "4", "--synth-test-n", "2",
                "--checkpoint-every", "2", "--ckpt-dir", str(ckpt)])
    assert np.isfinite(last_json(outs[0])["loss"])
    from ann3depth_tpu_torch.train import loop
    cfg = cli.resolve_config(cli.build_parser().parse_args(
        ["eval", "--config", "smoke", "--model", "dpt-small",
         "--synth-test-n", "2", "--ckpt-dir", str(ckpt)]))
    metrics = loop.evaluate(cfg, device="cpu", max_batches=1)
    assert np.isfinite(metrics["rmse"])


def test_two_rank_device_pool_k_step_blocks(tmp_path):
    """--cache-device with --steps-per-dispatch 2 on two ranks: each rank
    holds its shard of the pool and runs K-step blocks (eagerly on the
    CPU)."""
    outs = run(["train", *SMALL, "--cache-device", "--steps-per-dispatch",
                "2", "--steps", "4", "--log-every", "2",
                "--checkpoint-every", "4", "--ckpt-dir",
                str(tmp_path / "pool")])
    assert np.isfinite(last_json(outs[0])["loss"])


def test_kill_then_resume(tmp_path):
    """SIGKILL both ranks after a checkpoint appears (a dead rank leaves
    the other stuck in a collective: restart is whole-job), relaunch with
    --resume: the ranks restore rank 0's checkpoint and finish
    (tests/test_multihost.py:151)."""
    ckpt = tmp_path / "k"
    argv = ["train", *SMALL, "--checkpoint-every", "2", "--log-every", "2",
            "--ckpt-dir", str(ckpt)]
    procs = spawn(argv + ["--steps", "400"])
    try:
        deadline = time.time() + 120
        while not (ckpt.is_dir() and CheckpointManager(str(ckpt))
                   .all_steps()):
            assert all(p.poll() is None for p in procs), \
                [p.communicate() for p in procs]
            assert time.time() < deadline, "no checkpoint appeared"
            time.sleep(0.1)
    finally:
        for p in procs:
            p.send_signal(signal.SIGKILL)
        for p in procs:
            p.communicate(timeout=30)
    resumed_from = CheckpointManager(str(ckpt)).latest_step()
    assert resumed_from >= 2
    run(argv + ["--steps", str(resumed_from + 4), "--resume"])
    assert CheckpointManager(str(ckpt)).latest_step() == resumed_from + 4


def test_two_rank_eval_equals_one_process(tmp_path, capsys):
    """`eval` across two ranks (each its strided half of the test split at
    half the batch, the statistics summed over the ranks) against one
    process: the same 8 images, so the metrics agree to f32 summation
    order, within tests/test_torch_eval.py's tolerance for that (1e-4
    relative, 1e-5 absolute: silog is a difference of two sums)."""
    ckpt = str(tmp_path / "e")
    assert cli.main(["train", *SMALL, "--steps", "2", "--ckpt-dir",
                     ckpt]) == 0
    capsys.readouterr()
    assert cli.main(["eval", *SMALL, "--ckpt-dir", ckpt]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    outs = run(["eval", *SMALL, "--ckpt-dir", ckpt])
    got = last_json(outs[0])
    assert not [line for line in outs[1] if line.startswith("{")]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k
    with pytest.raises(AssertionError, match="single-process only"):
        run(["eval", *SMALL, "--ckpt-dir", ckpt, "--report-dir",
             str(tmp_path / "r")])
