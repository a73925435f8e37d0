"""Regenerate docs/cli_torch.md from the PyTorch port's argparse definitions.

Run from the repo root: python tools/gen_cli_docs_torch.py
Like tools/gen_cli_docs.py (the JAX CLI's docs/cli.md), it renders every
subcommand's help, so a malformed help string (an unescaped %) raises here.
Imports nothing of JAX: the port's parser needs only torch.
"""

import argparse
import contextlib
import io
import os
import sys

os.environ["COLUMNS"] = "80"  # stable help wrapping across terminals

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ann3depth_tpu_torch.cli import build_parser  # noqa: E402


def _help_of(parser, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            parser.parse_args(argv)
        except SystemExit:
            pass
    return buf.getvalue().rstrip()


def generate() -> str:
    p = build_parser()
    subs, = (a for a in p._actions
             if isinstance(a, argparse._SubParsersAction))
    out = ["# CLI reference: the PyTorch port",
           "",
           "Generated from the argparse definitions "
           "(`ann3depth_tpu_torch/cli.py`) —",
           "regenerate with `python tools/gen_cli_docs_torch.py` after "
           "changing flags.",
           "",
           "```", _help_of(p, ["--help"]), "```", ""]
    for s in subs.choices:
        out += [f"## `{s}`", "", "```", _help_of(p, [s, "--help"]), "```", ""]
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    path = os.path.join(os.path.dirname(__file__), "..", "docs",
                        "cli_torch.md")
    with open(path, "w") as f:
        f.write(generate())
    print(f"wrote {os.path.normpath(path)}")
