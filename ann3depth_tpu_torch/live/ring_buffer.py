"""SPSC frame ring buffer: ctypes binding to native/ringbuffer.cpp.

Counterpart of `ann3depth_tpu/live/ring_buffer.py`, with the port's own
copy of the C++ source (`ann3depth_tpu_torch/native/ringbuffer.cpp`, byte
for byte the package's `native/ringbuffer.cpp`). The capture thread pushes
frames, the inference loop pops the latest complete one; drops are
counted, torn reads are impossible (seqlock slots). The library is built
with g++ at first use into `ann3depth_tpu_torch/_build/`, under a name that
carries a hash of the source and flags, so an edited source is rebuilt and
a stale library never loaded. A lock-guarded pure-Python ring keeps the
live path running on a machine without g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = PKG_DIR / "native" / "ringbuffer.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return PKG_DIR / "_build" / f"libringbuffer-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        try:
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError) as e:
            log.warning("native ringbuffer unavailable (%s); using the "
                        "python fallback", e)
            return None
        lib.rb_create.restype = ctypes.c_void_p
        lib.rb_create.argtypes = [ctypes.c_uint32, ctypes.c_uint64]
        lib.rb_destroy.argtypes = [ctypes.c_void_p]
        lib.rb_push.restype = ctypes.c_uint64
        lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rb_pop_latest.restype = ctypes.c_int64
        lib.rb_pop_latest.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_uint64)]
        for f in ("rb_pushed", "rb_popped", "rb_dropped"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class FrameRingBuffer:
    """Latest-frame SPSC ring for fixed-shape uint8 frames."""

    def __init__(self, capacity: int, frame_shape: Tuple[int, ...],
                 force_python: bool = False):
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        self.capacity = int(capacity)
        self._lib = None if force_python else _build_and_load()
        if self._lib is not None:
            self._ring = self._lib.rb_create(self.capacity, self.frame_bytes)
            if not self._ring:
                raise MemoryError("rb_create failed")
        else:  # pure-python fallback (lock-guarded, tests/no-toolchain)
            self._ring = None
            self._frames = np.zeros((self.capacity, self.frame_bytes), np.uint8)
            self._ids = [-1] * self.capacity
            self._head = 0
            self._last_read = -1
            self._stats = {"popped": 0, "dropped": 0}
            self._lock = threading.Lock()

    @property
    def native(self) -> bool:
        return self._ring is not None

    def push(self, frame: np.ndarray) -> int:
        """Producer: copy a frame in; returns its id. Never blocks."""
        assert frame.shape == self.frame_shape and frame.dtype == np.uint8
        buf = np.ascontiguousarray(frame)
        if self._ring is not None:
            return self._lib.rb_push(
                self._ring, buf.ctypes.data_as(ctypes.c_char_p))
        with self._lock:
            i = self._head % self.capacity
            self._frames[i] = buf.reshape(-1)
            self._ids[i] = self._head
            self._head += 1
            return self._head - 1

    def pop_latest(self) -> Tuple[Optional[np.ndarray], int, int]:
        """Consumer: (frame, frame_id, dropped_since_last) or (None,-1,0)."""
        out = np.empty(self.frame_bytes, np.uint8)
        if self._ring is not None:
            drops = ctypes.c_uint64(0)
            fid = self._lib.rb_pop_latest(
                self._ring, out.ctypes.data_as(ctypes.c_char_p),
                ctypes.byref(drops))
            if fid < 0:
                return None, -1, 0
            return out.reshape(self.frame_shape), int(fid), int(drops.value)
        with self._lock:
            if self._head == 0:
                return None, -1, 0
            fid = self._head - 1
            i = fid % self.capacity
            out[:] = self._frames[i]
            drops = max(0, fid - self._last_read - 1) if self._stats["popped"] else 0
            self._stats["dropped"] += drops
            self._stats["popped"] += 1
            self._last_read = fid
            return out.reshape(self.frame_shape), fid, drops

    def stats(self):
        if self._ring is not None:
            return {"pushed": int(self._lib.rb_pushed(self._ring)),
                    "popped": int(self._lib.rb_popped(self._ring)),
                    "dropped": int(self._lib.rb_dropped(self._ring))}
        with self._lock:
            return {"pushed": self._head, **self._stats}

    def close(self):
        if self._ring is not None:
            self._lib.rb_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
