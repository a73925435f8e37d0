"""Command line of the PyTorch port.

Counterpart of `ann3depth_tpu/cli.py`, with every one of its subcommands:

    python -m ann3depth_tpu_torch train --config make3d-encdec --steps 50 \\
        --datasets synthetic --synth-hw 480 640 --synth-depth-hw 305 55
    python -m ann3depth_tpu_torch prepare --dataset nyu --data-dir data
    python -m ann3depth_tpu_torch train --config nyu-encdec-aug \\
        --datasets nyu make3d --grad-accum 2 --eval-every 100 --save-best
    python -m ann3depth_tpu_torch train --config make3d-encdec --steps 1000 \\
        --cache-device --steps-per-dispatch 10    # K-step CUDA graph
    python -m ann3depth_tpu_torch train --config make3d-encdec \\
        --cache-device --cache-window-mb 2048 --window-epochs auto
    python -m ann3depth_tpu_torch train --config make3d-encdec --use-grain \\
        --num-workers 4                           # worker-process loader
    python -m ann3depth_tpu_torch eval --config make3d-encdec --cache-device
    python -m ann3depth_tpu_torch eval --config make3d-encdec --ckpt-dir DIR
    python -m ann3depth_tpu_torch infer --ckpt-dir DIR --image a.jpg [--ply]
    python -m ann3depth_tpu_torch infer --ckpt-dir DIR --video clip.avi
    python -m ann3depth_tpu_torch live --config live --ckpt-dir DIR \\
        --no-display --max-frames 300
    python -m ann3depth_tpu_torch eval --config make3d-encdec --quant int8
    python -m ann3depth_tpu_torch train --config make3d-encdec \\
        --quant int8-qat                          # quantization-aware
    python -m ann3depth_tpu_torch serve --config make3d-encdec --init
    python -m ann3depth_tpu_torch serve --ckpt-dir DIR [--ema] [--quant int8]
    python -m ann3depth_tpu_torch export --ckpt-dir DIR --out-dir ART \\
        [--serving-batch 8] [--quant int8]        # torch.export artifact
    python -m ann3depth_tpu_torch serve --artifact ART   # or a JAX export
    python -m ann3depth_tpu_torch train --config make3d-encdec --zero1 \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0
    python -m ann3depth_tpu_torch train --config dpt-384 --tp 2 \
        --multihost                                # under torchrun
    python -m ann3depth_tpu_torch eval --config make3d-encdec --device cpu \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 1
    python -m ann3depth_tpu_torch serve --config make3d-encdec --dp 0
    python -m ann3depth_tpu_torch sweep --config make3d-encdec --steps 200 \\
        --param train.learning_rate=1e-4,3e-4 --out-dir sweeps/lr
    python -m ann3depth_tpu_torch info --config dpt-384 --flops
    python -m ann3depth_tpu_torch download --dataset make3d --data-dir data
    python -m ann3depth_tpu_torch bench --config make3d-encdec    # train
    python -m ann3depth_tpu_torch bench --serving --batch-size 32 # serving

Every subcommand but `prepare` and `download` takes the JAX CLI's shared
flags (`_COMMON_FLAGS`, the JAX `_common_flags`) and its own, plus --device
(default cuda; it raises when no card is present, unless --device cpu is
given). `train` and `eval` join a process group with --multihost
(torchrun's environment) or --coordinator/--num-processes/--process-id,
one process per device (NCCL on the card, gloo with --device cpu;
--dist-backend gloo also runs CUDA tensors, so several ranks can share a
card). `bench` times the train step (bench/train.py) or, with --serving,
the serving program (bench/infer.py) on a pool made on the device, as the
JAX CLI's `bench` runs benchmarks/bench_train.py and bench_infer.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

from ann3depth_tpu_torch import config as cfglib


def _window_epochs(v: str) -> int:
    """--window-epochs value: an int, or 'auto' (-> 0)."""
    return 0 if v == "auto" else int(v)


# (flag, type or action, config section, field): the flags of the JAX
# CLI's `_common_flags` that map onto a config field, shared by every
# subcommand. An absent flag leaves the preset's value.
_COMMON_FLAGS = (
    ("--model", str, "model", "name"),
    ("--width-mult", float, "model", "width_mult"),
    ("--quant", str, "model", "quant"),
    ("--datasets", "list", "data", "datasets"),
    ("--data-dir", str, "data", "data_dir"),
    ("--synth-n", int, "data", "synth_n"),
    ("--synth-test-n", int, "data", "synth_test_n"),
    ("--synth-hw", "pair", "data", "synth_img_hw"),
    ("--synth-depth-hw", "pair", "data", "synth_depth_hw"),
    ("--use-grain", "flag", "data", "use_grain"),
    ("--num-workers", int, "data", "num_workers"),
    ("--cache-device", "flag", "data", "cache_device"),
    ("--cache-window-mb", int, "data", "cache_window_mb"),
    ("--window-epochs", _window_epochs, "data", "window_epochs"),
    ("--preprocess-impl", str, "data", "preprocess_impl"),
    ("--ckpt-dir", str, "train", "ckpt_dir"),
    ("--batch-size", int, "train", "batch_size"),
    ("--grad-accum", int, "train", "grad_accum"),
    ("--tp", int, "train", "tensor_parallel"),
    ("--zero1", "flag", "train", "zero1"),
    ("--ema-decay", float, "train", "ema_decay"),
    ("--steps", int, "train", "steps"),
    ("--learning-rate", float, "train", "learning_rate"),
    ("--loss", str, "train", "loss"),
    ("--schedule", str, "train", "schedule"),
    ("--optimizer", str, "train", "optimizer"),
    ("--warmup-steps", int, "train", "warmup_steps"),
    ("--weight-decay", float, "train", "weight_decay"),
    ("--clip-norm", float, "train", "clip_norm"),
    ("--adam-b1", float, "train", "adam_b1"),
    ("--adam-b2", float, "train", "adam_b2"),
    ("--seed", int, "train", "seed"),
)
# The JAX CLI's `train`-only flags that map onto a config field.
_TRAIN_FLAGS = (
    ("--augment", "bool", "data", "augment"),
    ("--resume", "flag", "train", "resume"),
    ("--resume-step", int, "train", "resume_step"),
    ("--steps-per-dispatch", int, "train", "steps_per_dispatch"),
    ("--tensorboard", "flag", "train", "tensorboard"),
    ("--eval-every", int, "train", "eval_every"),
    ("--log-every", int, "train", "log_every"),
    ("--checkpoint-every", int, "train", "checkpoint_every"),
    ("--early-stop-patience", int, "train", "early_stop_patience"),
    ("--early-stop-min-delta", float, "train", "early_stop_min_delta"),
    ("--save-best", "flag", "train", "save_best"),
    ("--distill-from", str, "train", "distill_from"),
    ("--distill-model", str, "train", "distill_model"),
    ("--distill-width-mult", float, "train", "distill_width_mult"),
    ("--distill-alpha", float, "train", "distill_alpha"),
    ("--profile", str, "train", "profile_dir"),
    ("--profile-steps", int, "train", "profile_steps"),
)
# The live/infer flags that map onto the live config.
_LIVE_FLAGS = (("--smooth", float, "live", "smooth"),
               ("--colormap", str, "live", "colormap"))
COLORMAPS = ["turbo", "viridis", "magma", "gray"]
_CHOICES = {"--loss": ["si", "si+grad", "l2", "berhu"],
            "--schedule": ["cosine", "constant"],
            "--optimizer": ["adamw", "adam", "sgd"],
            "--quant": ["none", "int8", "int8-qat"],
            "--preprocess-impl": ["xla", "pallas"],
            "--colormap": COLORMAPS}
_HELP = {"--preprocess-impl":
         "device preprocess implementation (DataConfig.preprocess_impl). "
         "Both values compute the same function, as in the JAX package, "
         "and run the same code: the CUDA kernel (csrc/fused_preprocess.cu) "
         "on the card, its plain PyTorch version with --device cpu"}


def _dest(flag):
    return "tensor_parallel" if flag == "--tp" else flag[2:].replace("-", "_")


def _add_flags(p, table):
    for flag, kind, _, _ in table:
        dest = _dest(flag)
        if kind == "flag":
            p.add_argument(flag, dest=dest, action="store_true", default=None)
        elif kind == "bool":
            p.add_argument(flag, dest=dest,
                           action=argparse.BooleanOptionalAction,
                           default=None)
        elif kind == "list":
            p.add_argument(flag, dest=dest, nargs="+")
        elif kind == "pair":
            p.add_argument(flag, dest=dest, type=int, nargs=2,
                           metavar=("H", "W"))
        else:
            p.add_argument(flag, dest=dest, type=kind,
                           choices=_CHOICES.get(flag), help=_HELP.get(flag))


def _common_flags(p):
    """The JAX CLI's shared flags, plus --device."""
    p.add_argument("--config", default="make3d-encdec",
                   choices=sorted(cfglib.PRESETS), help="named preset")
    _add_flags(p, _COMMON_FLAGS)
    p.add_argument("--ckpt-step", type=int, metavar="N",
                   help="use the checkpoint saved at step N instead of the "
                        "latest (eval/infer/live/serve; train reads "
                        "checkpoints via --resume)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "preprocess and the model on the CPU)")


def _multihost_flags(p):
    """The JAX CLI's `train` flags that join a process group, plus the
    port's --dist-backend."""
    p.add_argument("--multihost", action="store_true",
                   help="join a process group from torchrun's environment "
                        "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); one "
                        "process per device")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="explicit rendezvous address (use with "
                        "--num-processes/--process-id; implies --multihost)")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   help="collective backend (default: nccl on the card, "
                        "gloo with --device cpu); gloo also runs on the "
                        "card, where several ranks may share one")


def _join_group(args):
    """Join the process group the flags ask for (train, eval)."""
    if args.multihost or args.coordinator:
        from ann3depth_tpu_torch.parallel import multihost
        multihost.initialize(coordinator=args.coordinator,
                             num_processes=args.num_processes,
                             process_id=args.process_id, device=args.device,
                             backend=args.dist_backend)


def _print_result(obj):
    """Print a run's JSON line, from rank 0 only in a process group."""
    from ann3depth_tpu_torch.parallel import multihost
    if multihost.process_index() == 0:
        print(json.dumps(obj), flush=True)


def resolve_config(args) -> cfglib.Config:
    """The preset of --config with the given flags applied."""
    cfg = cfglib.get_config(args.config)
    overrides = {"data": {}, "model": {}, "train": {}, "live": {}}
    for flag, kind, section, field in (_COMMON_FLAGS + _TRAIN_FLAGS
                                       + _LIVE_FLAGS):
        value = getattr(args, _dest(flag), None)
        if value is None:
            continue
        if kind in ("list", "pair"):
            value = tuple(value)
        overrides[section][field] = value
    for section, values in overrides.items():
        if values:
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
                getattr(cfg, section), **values)})
    return cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ann3depth_tpu_torch")
    sub = ap.add_subparsers(dest="mode", required=True)

    pt = sub.add_parser("train", help="train a depth model")
    _common_flags(pt)
    _add_flags(pt, _TRAIN_FLAGS)
    _multihost_flags(pt)
    pt.add_argument("--workdir",
                    help="metrics/log directory (default: ckpt dir)")

    pe = sub.add_parser("eval", help="evaluate RMSE etc. on the test split")
    _common_flags(pe)
    _multihost_flags(pe)
    pe.add_argument("--max-batches", type=int)
    pe.add_argument("--ema", action="store_true",
                    help="score the EMA weights of a checkpoint trained with "
                         "--ema-decay")
    pe.add_argument("--report-dir", metavar="DIR",
                    help="also write per-image error attribution: "
                         "per_image.jsonl, a worst-K rgb|gt|pred triple "
                         "grid (worst.png), summary.json")
    pe.add_argument("--report-worst", type=int, default=8,
                    help="how many highest-RMSE images worst.png renders "
                         "(default 8)")
    pe.add_argument("--tta", choices=["flip"], default="",
                    help="average the prediction with the mirrored-input "
                         "prediction (second forward pass)")
    pe.add_argument("--avg-last", type=int, metavar="K",
                    help="score the uniform average of the last K retained "
                         "checkpoints (exclusive with --ckpt-step)")
    pe.add_argument("--align", choices=["median"], default="",
                    help="per-image median scale alignment before metrics")
    pe.add_argument("--protocols", metavar="P1,P2,...",
                    help="score several protocol variants in one run from "
                         "one restored checkpoint: tokens are 'plain' or "
                         "'+'-joined subsets of tta|align|crop; --tta/"
                         "--align/--crop supply the component values "
                         "(defaults flip/median/eigen). Prints {token: "
                         "metrics}. Exclusive with --report-dir and "
                         "multi-dataset configs")
    pe.add_argument("--crop", choices=["eigen", "garg"], default="",
                    help="compute metrics only inside the Eigen/Garg "
                         "fractional eval window of the depth map")

    pl = sub.add_parser("live", help="continuous depth view from camera/video")
    _common_flags(pl)
    pl.add_argument("--camera", type=int, default=0)
    pl.add_argument("--video", help="video file instead of camera")
    pl.add_argument("--no-display", action="store_true",
                    help="run headless (latency mode)")
    pl.add_argument("--max-frames", type=int)
    pl.add_argument("--record", metavar="OUT.avi",
                    help="also append every displayed depth frame to this "
                         "video file")
    _add_flags(pl, _LIVE_FLAGS)

    pi = sub.add_parser("infer", help="predict depth maps for image file(s) "
                        "or transcode a whole video offline")
    _common_flags(pi)
    pi.add_argument("--image", nargs="+",
                    help="input image file(s) (any size; resized on device)")
    pi.add_argument("--video",
                    help="transcode a video file instead: writes "
                         "<stem>_depth.<ext> with colormapped depth frames")
    pi.add_argument("--side-by-side", action="store_true",
                    help="with --video: write input|depth side by side")
    pi.add_argument("--video-batch", type=int, default=8,
                    help="device batch for --video (default 8)")
    pi.add_argument("--max-frames", type=int,
                    help="with --video: stop after N frames")
    pi.add_argument("--depth-npy", action="store_true",
                    help="with --video: also write the raw depth stack "
                         "(<stem>_depth.npy, [N, h, w] f32 meters)")
    pi.add_argument("--out-dir", default=".",
                    help="where <stem>_depth.npy and <stem>_depth.png go")
    pi.add_argument("--no-png", action="store_true",
                    help="skip the colormapped PNG, write only the .npy")
    pi.add_argument("--ply", action="store_true",
                    help="also export a 3-D point cloud (<stem>_cloud.ply)")
    pi.add_argument("--fov-deg", type=float, default=55.0,
                    help="horizontal field of view for --ply (default 55)")
    pi.add_argument("--ema", action="store_true",
                    help="use the EMA weights from the checkpoint")
    pi.add_argument("--tta", choices=["flip"], default="",
                    help="average with the mirrored-input prediction")
    _add_flags(pi, _LIVE_FLAGS[1:])

    pp = sub.add_parser("prepare", help="pack a dataset into records "
                        "(decode once, train many times)")
    pp.add_argument("--dataset", required=True,
                    choices=["make3d", "nyu", "synthetic"])
    pp.add_argument("--data-dir", default="data")
    pp.add_argument("--out-dir", help="default: <data-dir>/records")
    pp.add_argument("--split", default="train", choices=["train", "test"])
    pp.add_argument("--format", default="npy", choices=["npy", "npz"],
                    help="npy: one memmap'd pair per split (shuffle-friendly"
                    " random access, the default); npz: legacy shards")
    pp.add_argument("--shard-size", type=int, default=64,
                    help="npz format only")

    px = sub.add_parser(
        "export", help="export the serving program (preprocess + forward + "
        "exp) with torch.export into an artifact directory that `serve "
        "--artifact` runs without the model code")
    _common_flags(px)
    px.add_argument("--out-dir", required=True,
                    help="artifact directory (serving.pt2, meta.json)")
    px.add_argument("--serving-batch", type=int,
                    help="pin a fixed batch size; default: any batch")
    px.add_argument("--raw-hw", type=int, nargs=2, default=[480, 640],
                    metavar=("H", "W"),
                    help="raw frame shape the artifact accepts (default "
                         "640x480 camera frames)")
    px.add_argument("--init", action="store_true",
                    help="export random-init params instead of requiring a "
                         "checkpoint (artifact plumbing tests)")
    px.add_argument("--ema", action="store_true",
                    help="bake the EMA weights into the artifact "
                         "(checkpoint trained with --ema-decay)")
    px.add_argument("--avg-last", type=int, metavar="K",
                    help="bake the uniform average of the last K retained "
                         "checkpoints into the artifact (exclusive with "
                         "--ckpt-step)")

    ps = sub.add_parser(
        "serve", help="batched depth-serving HTTP server: concurrent "
        "requests coalesce into device batches padded to power-of-2 "
        "buckets; POST npy frames to /v1/depth")
    _common_flags(ps)
    ps.add_argument("--artifact",
                    help="serve an artifact directory: the port's `export` "
                         "(serving.pt2) or the weights of a JAX `export` "
                         "(params.npz)")
    ps.add_argument("--init", action="store_true",
                    help="serve random-init params (smoke/testing)")
    ps.add_argument("--ema", action="store_true",
                    help="serve the EMA weights from the checkpoint")
    ps.add_argument("--dp", type=int, default=1,
                    help="split each coalesced batch over this many local "
                         "CUDA devices (the model replicated on each, one "
                         "stream each); 0 = all local devices (checkpoint "
                         "mode only: an artifact is a single-device "
                         "program)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8000)
    ps.add_argument("--max-batch", type=int, default=32,
                    help="largest coalesced device batch (default 32)")
    ps.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="batching window after the first queued request")
    ps.add_argument("--raw-hw", type=int, nargs=2, default=[480, 640],
                    metavar=("H", "W"),
                    help="accepted raw frame shape (checkpoint and --init "
                         "modes; artifacts carry their own)")
    ps.add_argument("--no-warmup", action="store_true",
                    help="skip running every batch bucket at startup")

    pn = sub.add_parser("info", help="inspect a model/config: parameter "
                        "count, shapes, registry, optional FLOPs")
    _common_flags(pn)
    pn.add_argument("--flops", action="store_true",
                    help="also count the forward pass's FLOPs per image "
                         "(torch.utils.flop_counter) and report the "
                         "card's dense bf16 peak where it is known")

    pd = sub.add_parser("download", help="fetch + extract datasets")
    pd.add_argument("--dataset", required=True, choices=["make3d", "nyu"])
    pd.add_argument("--data-dir", default="data")
    pd.add_argument("--record-checksums", action="store_true",
                    help="after verification, write the staged archives' "
                         "sha256 into <data-dir>/<dataset>/checksums.json; "
                         "every later verify enforces them (first verified "
                         "staging becomes a hard integrity gate)")

    pb = sub.add_parser("bench", help="train (or --serving) throughput "
                        "on a device pool: images/s, ms a step, MFU, peak "
                        "memory; one JSON line")
    _common_flags(pb)
    pb.add_argument("--serving", action="store_true",
                    help="measure serving throughput (bench/infer.py: "
                         "CUDA graphs of the serving fn, batch "
                         "--batch-size or 32) instead of training "
                         "(bench/train.py: K-step graph blocks)")

    pw = sub.add_parser(
        "sweep", help="hyperparameter grid search: sequential train+eval "
        "trials over --param axes, ledger in <out-dir>/sweep.jsonl, best "
        "trial in summary.json")
    _common_flags(pw)
    pw.add_argument("--param", action="append", default=[],
                    metavar="dotted.path=v1,v2,...", required=True,
                    help="one grid axis over a config field, e.g. "
                         "train.learning_rate=1e-4,3e-4 (repeatable; the "
                         "grid is the cartesian product)")
    pw.add_argument("--out-dir", required=True,
                    help="sweep root: per-trial subdirs + sweep.jsonl + "
                         "summary.json")
    pw.add_argument("--metric", default="rmse",
                    help="eval metric that ranks trials (rmse, abs_rel, "
                         "sq_rel, log10, rmse_log, silog, loss minimize; "
                         "delta1-3 maximize). default: rmse")
    pw.add_argument("--max-eval-batches", type=int,
                    help="bound each trial's eval (full test split "
                         "otherwise)")
    return ap


def make_service(args):
    from ann3depth_tpu_torch import server as serverlib

    svc_kw = dict(max_batch=args.max_batch,
                  max_delay_s=args.max_delay_ms / 1e3, device=args.device)
    if args.artifact:
        if (getattr(args, "ema", False)
                or getattr(args, "ckpt_step", None) is not None):
            raise SystemExit(
                "--ema/--ckpt-step have no effect with --artifact: the "
                "artifact's weights were baked at export time")
        if getattr(args, "dp", 1) != 1:
            raise SystemExit(
                "--dp requires checkpoint mode: an exported artifact "
                "is a single-device program (its shardings were fixed "
                "at export time)")
        return serverlib.service_from_artifact(args.artifact, **svc_kw)
    cfg = resolve_config(args)
    return serverlib.service_from_config(
        cfg, init=args.init, raw_hw=tuple(args.raw_hw), use_ema=args.ema,
        ckpt_step=args.ckpt_step, dp=args.dp, **svc_kw)


def train_main(args):
    if args.ckpt_step is not None:
        raise SystemExit("train reads checkpoints via --resume or "
                         "--resume-step, not --ckpt-step")
    if not args.distill_from and any(
            getattr(args, k) is not None
            for k in ("distill_model", "distill_width_mult",
                      "distill_alpha")):
        raise SystemExit(
            "--distill-model/--distill-width-mult/--distill-alpha "
            "configure the teacher and need --distill-from CKPT_DIR")
    from ann3depth_tpu_torch.train import loop

    cfg = resolve_config(args)
    _join_group(args)
    _, metrics = loop.train(cfg, workdir=args.workdir, device=args.device)
    _print_result({k: float(v) for k, v in metrics.items()})
    return 0


def eval_main(args):
    from ann3depth_tpu_torch.train import loop

    cfg = resolve_config(args)
    _join_group(args)
    common = dict(max_batches=args.max_batches,
                  report_worst=args.report_worst, tta=args.tta,
                  align=args.align, crop=args.crop)
    names = list(dict.fromkeys(cfg.data.datasets))  # dedupe, keep order
    try:
        if args.protocols:
            if len(names) > 1:
                raise SystemExit("--protocols is single-dataset (eval each "
                                 "dataset separately)")
            if args.report_dir:
                raise SystemExit("--protocols and --report-dir are "
                                 "exclusive (run a plain eval --report-dir "
                                 "for attribution)")
            metrics = loop.evaluate_protocols(
                cfg, [t for t in args.protocols.split(",") if t],
                use_ema=args.ema, ckpt_step=args.ckpt_step,
                avg_last=args.avg_last, max_batches=args.max_batches,
                tta=args.tta or "flip", align=args.align or "median",
                crop=args.crop or "eigen", device=args.device)
        elif len(names) > 1:
            # Per-dataset metrics from one restored checkpoint.
            try:
                state = loop.restore_state_for_eval(
                    cfg, use_ema=args.ema, ckpt_step=args.ckpt_step,
                    avg_last=args.avg_last, device=args.device)
            except ValueError as e:
                raise SystemExit(str(e))
            metrics = {}
            for n in names:
                rd = (os.path.join(args.report_dir, n)
                      if args.report_dir else None)
                metrics[n] = loop.evaluate(
                    cfg, state=state,
                    dataset=loop.build_dataset(cfg, "test", name=n),
                    report_dir=rd, **common)
        else:
            metrics = loop.evaluate(cfg, report_dir=args.report_dir,
                                    use_ema=args.ema,
                                    ckpt_step=args.ckpt_step,
                                    avg_last=args.avg_last,
                                    device=args.device, **common)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    _print_result(metrics)
    return 0


def live_main(args):
    from ann3depth_tpu_torch.live import viewer

    cfg = resolve_config(args)
    stats = viewer.run(cfg, camera=args.camera, video=args.video,
                       display=not args.no_display,
                       max_frames=args.max_frames, record=args.record,
                       ckpt_step=args.ckpt_step, device=args.device)
    print(json.dumps(stats), flush=True)
    return 0


def infer_main(args):
    import numpy as np

    if bool(args.image) == bool(args.video):
        raise SystemExit("infer needs exactly one of --image or --video")
    cfg = resolve_config(args)
    if args.video:
        from ann3depth_tpu_torch.live import transcode

        os.makedirs(args.out_dir, exist_ok=True)
        stem, ext = os.path.splitext(os.path.basename(args.video))
        out = os.path.join(args.out_dir, f"{stem}_depth{ext or '.avi'}")
        dnpy = (os.path.join(args.out_dir, f"{stem}_depth.npy")
                if args.depth_npy else None)
        stats = transcode.transcode(
            cfg, args.video, out, batch=args.video_batch,
            side_by_side=args.side_by_side, depth_npy=dnpy,
            max_frames=args.max_frames, use_ema=args.ema,
            ckpt_step=args.ckpt_step, tta=args.tta, device=args.device)
        print(json.dumps(stats), flush=True)
        return 0

    from PIL import Image

    from ann3depth_tpu_torch.serving import model_from_checkpoint
    from ann3depth_tpu_torch.train import step as steplib
    from ann3depth_tpu_torch.utils import viz

    model = model_from_checkpoint(cfg, use_ema=args.ema,
                                  ckpt_step=args.ckpt_step,
                                  device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    outputs = []
    for path in args.image:
        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        depth = steplib.infer_image(model, img, input_hw=cfg.data.input_hw,
                                    tta=args.tta)
        stem = os.path.splitext(os.path.basename(path))[0]
        npy = os.path.join(args.out_dir, f"{stem}_depth.npy")
        np.save(npy, depth)
        rec = {"image": path, "depth_npy": npy,
               "depth_min_m": round(float(depth.min()), 3),
               "depth_max_m": round(float(depth.max()), 3)}
        if not args.no_png:
            png = os.path.join(args.out_dir, f"{stem}_depth.png")
            viz.save_png(png, viz.colormap_depth(depth,
                                                 cmap=cfg.live.colormap))
            rec["depth_png"] = png
        if args.ply:
            from ann3depth_tpu_torch.utils import pointcloud

            h, w = depth.shape[:2]
            colors = np.asarray(
                Image.fromarray(img).resize((w, h), Image.BILINEAR))
            ply = os.path.join(args.out_dir, f"{stem}_cloud.ply")
            rec["ply"] = ply
            rec["ply_points"] = pointcloud.depth_to_ply(
                ply, depth, rgb=colors, fov_deg=args.fov_deg)
        outputs.append(rec)
    print(json.dumps(outputs), flush=True)
    return 0


def prepare_main(args):
    """Pack a dataset split into records (`data/records.pack`); prints
    {"index": path, "examples": N}."""
    from ann3depth_tpu_torch.data import records

    if args.dataset == "synthetic":
        from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
        ds = SyntheticDepthDataset()
    elif args.dataset == "make3d":
        from ann3depth_tpu_torch.data.make3d import Make3DDataset
        ds = Make3DDataset(args.data_dir, split=args.split)
    else:
        from ann3depth_tpu_torch.data.nyu import NYUDataset
        ds = NYUDataset(args.data_dir, split=args.split)
    out_dir = args.out_dir or os.path.join(args.data_dir, "records")
    index = records.pack(ds, out_dir, args.split,
                         shard_size=args.shard_size, format=args.format)
    print(json.dumps({"index": index, "examples": len(ds)}), flush=True)
    return 0


def export_main(args):
    """Export the serving program of a checkpoint's params (or, with
    --init, random ones); prints the artifact's meta."""
    from ann3depth_tpu_torch import serving
    from ann3depth_tpu_torch.train import loop

    cfg = resolve_config(args)
    if args.avg_last and args.ckpt_step is not None:
        raise SystemExit("--avg-last and --ckpt-step are exclusive")
    if args.init:
        model = serving.model_from_checkpoint(cfg, init=True,
                                              device=args.device)
    else:
        model = loop.restore_state_for_eval(
            cfg, use_ema=args.ema, ckpt_step=args.ckpt_step,
            avg_last=args.avg_last, device=args.device).model
    meta = serving.export_serving(
        cfg, model, args.out_dir, batch=args.serving_batch,
        raw_hw=tuple(args.raw_hw), config_name=args.config,
        device=args.device)
    print(json.dumps(meta), flush=True)
    return 0


def serve_main(args):
    from ann3depth_tpu_torch import server as serverlib

    service = make_service(args)
    if not args.no_warmup:
        logging.getLogger(__name__).info(
            "warming up %d batch buckets...", len(service._buckets))
        serverlib.warmup(service)
    srv = serverlib.DepthServer(service, host=args.host, port=args.port)
    print(json.dumps({"listening": f"http://{args.host}:{srv.port}",
                      "raw_hw": list(service.raw_hw),
                      "max_batch": service.max_batch,
                      "device": args.device}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


def info_main(args):
    """Parameter count, shapes and registry of a config's model (one
    forward on --device); with --flops its FLOPs per image and, on a card
    of utils/flops.PEAK_BF16_FLOPS, the card's peak. Prints one JSON
    line with the JAX CLI's keys."""
    if args.ckpt_step is not None:
        raise SystemExit("info inspects the model definition, not a "
                         "checkpoint; --ckpt-step has no effect")
    import torch

    from ann3depth_tpu_torch.device import resolve_device
    from ann3depth_tpu_torch.models import registry
    from ann3depth_tpu_torch.train import loop
    from ann3depth_tpu_torch.train import step as steplib
    from ann3depth_tpu_torch.utils import flops as flopslib

    cfg = resolve_config(args)
    dev = resolve_device(args.device)
    model = steplib.init_params(registry.build(cfg.model),
                                cfg.data.input_hw, device=dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros((1, *cfg.data.input_hw, 3), device=dev)
    with torch.no_grad():
        out = model(x)
    info = {
        "model": cfg.model.name,
        "config": args.config,
        "compute_dtype": cfg.model.compute_dtype,
        "quant": cfg.model.quant,
        "params": n_params,
        "params_mib_f32": round(n_params * 4 / 2**20, 2),
        "input_hw": list(cfg.data.input_hw),
        "output_hw": list(out.shape[1:3]),
        "target_hw": list(loop.resolved_target_hw(cfg)),
        "batch_size": cfg.train.batch_size,
        "registry": registry.available(),
    }
    if args.flops:
        fl = flopslib.forward_flops(model, x)
        info["forward_gflops_per_image"] = round(fl / 1e9, 3)
        peak = flopslib.device_peak_flops(dev)
        if peak:
            info["device_peak_tflops"] = round(peak / 1e12, 1)
            info["device_kind"] = torch.cuda.get_device_name(dev)
    print(json.dumps(info), flush=True)
    return 0


def download_main(args):
    from ann3depth_tpu_torch.data import download

    download.download(args.dataset, args.data_dir,
                      record=args.record_checksums)
    return 0


def bench_main(args):
    """Train throughput (bench/train.py) or, with --serving, serving
    throughput (bench/infer.py) on --device; prints one JSON line."""
    if args.ckpt_step is not None:
        raise SystemExit("bench runs random-init params; --ckpt-step "
                         "has no checkpoint to pin")
    cfg = resolve_config(args)
    if cfg.model.quant == "int8" and not args.serving:
        raise SystemExit(
            "--quant int8 is serving-only; pass --serving for the "
            "inference bench or drop --quant for the training bench")
    from ann3depth_tpu_torch.bench import infer, train

    if args.serving:
        result = infer.run(cfg, batch=args.batch_size or 32,
                           device=args.device)
    else:
        result = train.run(cfg, device=args.device)
    print(json.dumps(result), flush=True)
    return 0


def sweep_main(args):
    """Grid search (sweep.run_sweep) on --device; prints the best row, the
    trial count and the summary's path. Joins no process group."""
    from ann3depth_tpu_torch import sweep as sweeplib

    cfg = resolve_config(args)
    grid = [sweeplib.parse_param(spec) for spec in args.param]
    result = sweeplib.run_sweep(cfg, grid, args.out_dir, metric=args.metric,
                                max_eval_batches=args.max_eval_batches,
                                device=args.device)
    print(json.dumps({"best": result["best"],
                      "n_trials": len(result["rows"]),
                      "summary": result["summary_path"]}), flush=True)
    return 0


_MODES = {"train": train_main, "eval": eval_main, "live": live_main,
          "infer": infer_main, "serve": serve_main, "prepare": prepare_main,
          "export": export_main, "info": info_main,
          "download": download_main, "bench": bench_main,
          "sweep": sweep_main}



def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    from ann3depth_tpu_torch.parallel import multihost
    try:
        return _MODES[args.mode](args)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main())
