"""Command line of the PyTorch port.

Counterpart of `ann3depth_tpu/cli.py`, with the subcommands ported so far:

    python -m ann3depth_tpu_torch train --config make3d-encdec --steps 50 \\
        --datasets synthetic --synth-hw 480 640 --synth-depth-hw 305 55
    python -m ann3depth_tpu_torch serve --config make3d-encdec --init
    python -m ann3depth_tpu_torch serve --artifact DIR   # JAX export_serving

Each takes the JAX CLI's flags for its path, plus --device (default cuda;
it raises when no card is present, unless --device cpu is given). `train`
also takes the JAX flags of the options the port lacks; those stop with
"not ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

from ann3depth_tpu_torch import config as cfglib


def _window_epochs(v: str) -> int:
    """--window-epochs value: an int, or 'auto' (-> 0)."""
    return 0 if v == "auto" else int(v)


# (flag, type or action, config section, field): the JAX CLI's `train`
# flags that map onto a config field. An absent flag leaves the preset's
# value; the loop raises for the values the port has not ported.
_TRAIN_FLAGS = (
    ("--model", str, "model", "name"),
    ("--width-mult", float, "model", "width_mult"),
    ("--quant", str, "model", "quant"),
    ("--datasets", "list", "data", "datasets"),
    ("--data-dir", str, "data", "data_dir"),
    ("--synth-n", int, "data", "synth_n"),
    ("--synth-test-n", int, "data", "synth_test_n"),
    ("--synth-hw", "pair", "data", "synth_img_hw"),
    ("--synth-depth-hw", "pair", "data", "synth_depth_hw"),
    ("--augment", "bool", "data", "augment"),
    ("--use-grain", "flag", "data", "use_grain"),
    ("--num-workers", int, "data", "num_workers"),
    ("--cache-device", "flag", "data", "cache_device"),
    ("--cache-window-mb", int, "data", "cache_window_mb"),
    ("--window-epochs", _window_epochs, "data", "window_epochs"),
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
_CHOICES = {"--loss": ["si", "si+grad", "l2", "berhu"],
            "--schedule": ["cosine", "constant"],
            "--optimizer": ["adamw", "adam", "sgd"],
            "--quant": ["none", "int8", "int8-qat"]}
# JAX CLI flags of paths the port lacks and that map onto no config field.
_NOT_PORTED_FLAGS = ("--multihost", "--coordinator", "--num-processes",
                     "--process-id", "--preprocess-impl")


def _dest(flag):
    return "tensor_parallel" if flag == "--tp" else flag[2:].replace("-", "_")


def _add_train_parser(sub):
    pt = sub.add_parser("train", help="train a depth model")
    pt.add_argument("--config", default="make3d-encdec",
                    choices=sorted(cfglib.PRESETS), help="named preset")
    for flag, kind, _, _ in _TRAIN_FLAGS:
        dest = _dest(flag)
        if kind == "flag":
            pt.add_argument(flag, dest=dest, action="store_true",
                            default=None)
        elif kind == "bool":
            pt.add_argument(flag, dest=dest,
                            action=argparse.BooleanOptionalAction,
                            default=None)
        elif kind == "list":
            pt.add_argument(flag, dest=dest, nargs="+")
        elif kind == "pair":
            pt.add_argument(flag, dest=dest, type=int, nargs=2,
                            metavar=("H", "W"))
        else:
            pt.add_argument(flag, dest=dest, type=kind,
                            choices=_CHOICES.get(flag))
    for flag in _NOT_PORTED_FLAGS:
        pt.add_argument(flag, dest=_dest(flag), nargs="?", const=True,
                        default=None, help="not ported yet")
    pt.add_argument("--ckpt-step", type=int,
                    help="(eval/infer flag; train reads checkpoints via "
                         "--resume)")
    pt.add_argument("--workdir",
                    help="metrics/log directory (default: ckpt dir)")
    pt.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "preprocess and the model on the CPU)")


def resolve_train_config(args) -> cfglib.Config:
    """The preset of --config with the given train flags applied."""
    cfg = cfglib.get_config(args.config)
    overrides = {"data": {}, "model": {}, "train": {}}
    for flag, kind, section, field in _TRAIN_FLAGS:
        value = getattr(args, _dest(flag))
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
    _add_train_parser(sub)
    ps = sub.add_parser(
        "serve", help="batched depth-serving HTTP server: concurrent "
        "requests coalesce into device batches padded to power-of-2 "
        "buckets; POST npy frames to /v1/depth")
    ps.add_argument("--config", default="make3d-encdec",
                    choices=sorted(cfglib.PRESETS), help="named preset")
    ps.add_argument("--artifact",
                    help="serve the weights of a JAX `export` artifact "
                         "directory (meta.json + params.npz)")
    ps.add_argument("--init", action="store_true",
                    help="serve random-init params (smoke/testing)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8000)
    ps.add_argument("--max-batch", type=int, default=32,
                    help="largest coalesced device batch (default 32)")
    ps.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="batching window after the first queued request")
    ps.add_argument("--raw-hw", type=int, nargs=2, default=[480, 640],
                    metavar=("H", "W"),
                    help="accepted raw frame shape (--init mode; artifacts "
                         "carry their own)")
    ps.add_argument("--no-warmup", action="store_true",
                    help="skip running every batch bucket at startup")
    ps.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "preprocess and the model on the CPU)")
    return ap


def make_service(args):
    from ann3depth_tpu_torch import server as serverlib

    svc_kw = dict(max_batch=args.max_batch,
                  max_delay_s=args.max_delay_ms / 1e3, device=args.device)
    if args.artifact:
        return serverlib.service_from_artifact(args.artifact, **svc_kw)
    if not args.init:
        raise SystemExit("serving from a checkpoint is not ported yet: pass "
                         "--init or --artifact DIR")
    return serverlib.service_from_config(
        cfglib.get_config(args.config), init=True,
        raw_hw=tuple(args.raw_hw), **svc_kw)


def train_main(args):
    if args.ckpt_step is not None:
        raise SystemExit("train reads checkpoints via --resume, not "
                         "--ckpt-step")
    given = [f for f in _NOT_PORTED_FLAGS
             if getattr(args, _dest(f)) is not None]
    if given:
        raise SystemExit(f"{', '.join(given)}: not ported yet")
    if not args.distill_from and any(
            getattr(args, k) is not None
            for k in ("distill_model", "distill_width_mult",
                      "distill_alpha")):
        raise SystemExit(
            "--distill-model/--distill-width-mult/--distill-alpha "
            "configure the teacher and need --distill-from CKPT_DIR")
    from ann3depth_tpu_torch.train import loop

    cfg = resolve_train_config(args)
    try:
        _, metrics = loop.train(cfg, workdir=args.workdir, device=args.device)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    print(json.dumps({k: float(v) for k, v in metrics.items()}), flush=True)
    return 0


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.mode == "train":
        return train_main(args)
    if args.mode == "serve":
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
    raise AssertionError(args.mode)


if __name__ == "__main__":
    sys.exit(main())
