"""Command line of the PyTorch port.

Counterpart of `ann3depth_tpu/cli.py`, with the subcommands ported so far:

    python -m ann3depth_tpu_torch serve --config make3d-encdec --init
    python -m ann3depth_tpu_torch serve --artifact DIR   # JAX export_serving

`serve` takes the JAX CLI's flags for this path, plus --device (default
cuda; it raises when no card is present, unless --device cpu is given).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ann3depth_tpu_torch import config as cfglib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ann3depth_tpu_torch")
    sub = ap.add_subparsers(dest="mode", required=True)
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


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
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
