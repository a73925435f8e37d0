"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt at its next use
and a stale library is never loaded.
The build happens at first use (nothing is compiled at import), into
`ann3depth_tpu_torch/_build/`, which .gitignore lists. Every `.cu` file of
csrc/ is a kernel.

The op modules bind their kernels into torch here: `bind` gives a
library's C functions as Python functions that launch on the current
stream and raise on an error code, and `define` registers a torch op
`torch.ops.ann3depth.<name>` in the one library of the namespace, with the
kernel as its CUDA implementation, whose launches `count` counts.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = tuple(sorted(p.stem for p in SRC_DIR.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LOADED: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """The library of one kernel, named by a hash of its source, the shared
    headers of csrc/ and the flags."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, one `nvcc` per
    source, all started together. Returns {name: nvcc output}; raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel. At first use every kernel that is
    not built yet is built, all in parallel."""
    with _LOCK:
        if name not in _LOADED:
            build()
            _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return _LOADED[name]


def bind(name: str, functions: dict) -> dict:
    """The C functions `<name>_<what>` of kernel `name`'s library, for each
    `what` of `functions` ({what: argtypes}), as {what: function}. Each C
    function takes its argtypes, then the cudaStream_t it launches on, and
    returns 0 or an error code that `<name>_error_string` names. A bound
    function takes the arguments of its argtypes, a tensor where a pointer
    goes; it launches on the current stream of its first tensor's device
    and raises RuntimeError on an error code. The library is loaded (built
    where it must be) at the first call."""
    @functools.cache
    def c_functions():
        lib = load(name)
        bound = {}
        for what, argtypes in functions.items():
            f = getattr(lib, f"{name}_{what}")
            f.argtypes, f.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
            bound[what] = f
        errors = getattr(lib, f"{name}_error_string")
        errors.argtypes, errors.restype = [ctypes.c_int], ctypes.c_char_p
        return bound, errors

    def launcher(what):
        def launch(*args):
            device = next(a.device for a in args if isinstance(a, torch.Tensor))
            fns, errors = c_functions()
            with torch.cuda.device(device):
                err = fns[what](
                    *(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args),
                    torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"{name} {what} failed: "
                                   f"{errors(err).decode()} ({err})")
        return launch

    return {what: launcher(what) for what in functions}


# The namespace's one library. The low-level `torch.library.Library` API
# costs the host less per call than the `torch.library.custom_op` decorator
# (PERF.md §6).
_LIB = torch.library.Library("ann3depth", "DEF")


def define(schema: str, counter, *, cuda, fake, cpu=None):
    """Define the op `torch.ops.ann3depth.<name>` of `schema` ("<name>(...)
    -> ..."), so that an exported program (`torch.export`) holds it as one
    node, and return its default overload. `cuda` runs the kernel, and each
    of its calls is counted in `counter.launches` (`count`); `cpu`, where
    given, runs on CPU tensors, and `fake` gives a tracer the outputs'
    shapes."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)

    def counted(*args):
        out = cuda(*args)
        count(counter)
        return out

    _LIB.impl(name, counted, "CUDA")
    if cpu is not None:
        _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"ann3depth::{name}", fake, lib=_LIB)
    counter.launches = 0
    return getattr(torch.ops.ann3depth, name).default


def count(wrapper):
    """One launch of `wrapper`'s kernel. A launch recorded into a CUDA graph
    runs at every replay, where no Python runs: it is not counted here, and
    a graph's launches are counted from a profiler trace of its replays."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
