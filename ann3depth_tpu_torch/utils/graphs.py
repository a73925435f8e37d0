"""CUDA graphs of the port's device steps: the counterpart of `jax.jit`.

The JAX package runs each device step (the serving fn, `live_step`,
`eval_stats_step`, `infer_step`) as one compiled program: traced and
compiled once for each input shape and each value of its static
arguments, then dispatched whole at every call. The port's counterpart on
the card is a CUDA graph of the step, captured once for each such key and
replayed at every call: one graph launch where the eager step issues
every op from Python (a hundred and more kernel launches).

- `Replay`: `fn(x)` on one fixed input tensor, captured once.
- `warm_up`: the eager calls a capture needs first, on a side stream.
- `GraphCache`: `fn(*tensors, **static)`, one graph for each key (the
  tensors' shapes, dtypes and device, and the static keyword arguments),
  with the graphs of one cache in one memory pool.
- `caches`: the live caches, whose `captures` and `replays` count what
  each did.

On the CPU there is no graph: the same calls run `fn` eagerly. On the
card a step that cannot be captured raises; nothing falls back to eager
calls.
"""

from __future__ import annotations

import weakref

import torch

_CACHES: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()


def warm_up(fn, *args, device, **kwargs):
    """Call `fn(*args, **kwargs)` once on a side stream of `device`, and
    make the current stream wait for it. A capture runs no kernel, and
    this call loads what a capture cannot: the kernel library, cuDNN's and
    cuBLAS's handles and plans, the tensors that the step builds once and
    caches (identity param rows, upsample matrices)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn(*args, **kwargs)
    main.wait_stream(side)


def _name(fn):
    return getattr(fn, "__qualname__", None) or type(fn).__name__


def _capture(graph, run, device, pool, stream, name):
    """run() recorded into `graph` on `stream` (None: `torch.cuda.graph`'s
    one capture stream of the process); returns its output. A capture
    error raises with the step's name."""
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            return run()
    except RuntimeError as e:
        raise RuntimeError(f"cannot capture {name} in a CUDA graph on "
                           f"{device}: {e}") from e


class Replay:
    """`fn(x)` on one fixed input: the replay of a CUDA graph captured from
    it on the card, the eager call on the CPU. `out` holds the last
    output (on the card, the graph's static output, which the next replay
    overwrites). Write a new input into `x` in place. The caller warms
    `fn` first (`warm_up`).

    Every Replay is captured on `torch.cuda.graph`'s one capture stream,
    so Replays given one `pool` share its memory: the allocator reuses a
    freed block only on the stream that freed it."""

    def __init__(self, fn, x, pool=None):
        self.fn, self.x = fn, x
        self.graph = None
        self.out = None
        if x.device.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            self.out = _capture(self.graph, lambda: fn(x), x.device, pool,
                                None, _name(fn))

    def __call__(self):
        if self.graph is None:
            self.out = self.fn(self.x)
        else:
            self.graph.replay()
        return self.out


def _frozen(v):
    """A static argument as a hashable key part (lists become tuples)."""
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(x) for x in v)
    hash(v)  # raises TypeError on an unhashable static argument
    return v


class GraphCache:
    """`fn(*tensors, **static)` as CUDA graphs, one for each key: the
    tensors' shapes and dtypes, the device, and the static keyword
    arguments (hashable values; lists count as tuples).

    The first call of a key allocates static input buffers on the device,
    copies the inputs into them, runs `fn` once on them on a side stream
    (`warm_up`), captures `fn` on them, and replays the graph. A later
    call of the key copies its inputs into the buffers and replays. Every
    graph of one cache shares one memory pool: they replay one after
    another on one stream.

    The outputs returned are the graph's static outputs: the NEXT call of
    the cache (of any key) may overwrite them. A caller copies what it
    keeps (to the host, or by a device copy queued before the next call,
    which stream order then protects) before it calls again.

    device: where the graphs run; None takes the first tensor's device.
    With a device given, inputs may lie anywhere (a host tensor is copied
    straight into the static buffer). A call on a device other than
    CUDA runs `fn` eagerly, on the inputs moved to the device.

    capture: a hook `capture(run) -> (out, replay)` in place of the CUDA
    capture, used for every key on any device: `run()` computes fn on the
    static inputs; `replay()` must leave fn's new output in `out`'s
    tensors. It lets the keying and the buffers be tested without a card.

    A capture error raises (with fn's name); nothing falls back to eager
    calls on the card.
    """

    def __init__(self, fn, *, device=None, capture=None):
        self.fn = fn
        self.device = None if device is None else torch.device(device)
        self._capture_hook = capture
        self._entries: dict = {}
        self._pool = None
        self._stream = None
        self.captures = 0
        self.replays = 0
        _CACHES.add(self)

    def __len__(self):
        return len(self._entries)

    def clear(self):
        """Drop every graph, its static buffers and the memory pool."""
        self._entries.clear()
        self._pool = None
        self._stream = None

    def _cuda_capture(self, run, device):
        warm_up(run, device=device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        out = _capture(graph, run, device, self._pool, self._stream,
                       _name(self.fn))
        if self._pool is None:
            self._pool = graph.pool()
        return out, graph.replay

    def __call__(self, *args, **static):
        for a in args:
            if not isinstance(a, torch.Tensor):
                raise TypeError(
                    f"GraphCache takes tensors as positional arguments "
                    f"(got {type(a).__name__}); pass the rest by keyword")
        device = self.device or args[0].device
        if self._capture_hook is None and device.type != "cuda":
            return self.fn(*(a.to(device) for a in args), **static)
        key = (tuple((tuple(a.shape), a.dtype) for a in args), device,
               tuple(sorted((k, _frozen(v)) for k, v in static.items())))
        entry = self._entries.get(key)
        if entry is None:
            # Normal tensors, so that a call outside inference_mode may copy
            # into them whichever mode the first call came in.
            with torch.inference_mode(False):
                inputs = [torch.empty(a.shape, dtype=a.dtype, device=device)
                          for a in args]
        else:
            inputs = entry[0]
        for buf, a in zip(inputs, args):
            buf.copy_(a)
        if entry is None:
            capture = self._capture_hook or (
                lambda run: self._cuda_capture(run, device))
            entry = self._entries[key] = (
                inputs, *capture(lambda: self.fn(*inputs, **static)))
            self.captures += 1
        _, out, replay = entry
        replay()
        self.replays += 1
        return out


def caches():
    """Every live `GraphCache`."""
    return list(_CACHES)
