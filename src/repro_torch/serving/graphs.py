"""Per-shape step graphs of the executors: the port's counterpart of the
JAX executors' cache of compiled executables (``repro.serving.executor``,
"the TPU analogue of CUDA Graph capture"; the paper captures its (L, B)
grid as CUDA graphs).

A :class:`StepGraph` holds one step function at one shape:

- static inputs: every int32 input of the step is written into one
  pinned host buffer and reaches the card by a single non-blocking copy
  into one device buffer, whose views are the step's arguments;
- one ``torch.cuda.CUDAGraph`` captured over the step function, after
  one eager warm-up on a side stream (kernel builds, module loads and
  cached device queries happen there, outside the capture).  Warm-up
  and capture run on PARKED inputs — every write on a park row, scratch
  slot or scratch page, every kv length 0 — which the executor builds,
  so capturing at a live miss changes no live KV row and no SSM state
  (an SSM step is not idempotent: running it on the real inputs would
  advance the state twice).  A capture runs nothing on the device;
- the static outputs, which every replay overwrites.  The graphs of one
  engine share one memory pool, so a consumer must be done with a
  step's outputs before the next replay of any graph of that engine;
  a replay raises if an output of its graph is still referenced (a
  tensor, a view or a numpy array of it) outside the graph;
- the per-kernel launches of the graph.  The launchers' counters are
  Python attributes (``kernels.ops.LAUNCHERS``): the capture's bumps ran
  nothing, so they are taken back and kept as the graph's delta, which
  every replay adds.  The warm-up's launches ran and stay counted
  (``warmup``).

The state a graph reads by address — parameters, the arena's leaves,
the gathered-cache buffer — must never be rebound: every run checks
the ``data_ptr()`` of each such tensor against the capture's.

On a CUDA device a capture that fails raises; nothing falls back to
eager.  On the CPU (tests) the same staging runs, the parked run stands
for the capture, and each run calls the step eagerly over the static
buffers and copies its results into the static outputs, so the CPU
suite covers staging, aliasing and the rebinding check.  The device of
the step's state decides the path, as the tensor's device decides a
kernel's.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.serving import trace


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def launch_counts(launchers: Mapping[str, Any]) -> Dict[str, int]:
    """{kernel name: launches so far}."""
    return {name: fn.launches for name, fn in launchers.items()}


def take_back(launchers: Mapping[str, Any], before: Dict[str, int]
              ) -> Dict[str, int]:
    """Undo the counter bumps made since ``before`` (a capture, which
    launched nothing) and return them: {kernel name: launches}."""
    delta = {}
    for name, fn in launchers.items():
        d = fn.launches - before[name]
        if d:
            delta[name] = d
            fn.launches -= d
    return delta


def add_launches(launchers: Mapping[str, Any], delta: Dict[str, int]
                 ) -> None:
    """Count one replay of a graph whose captured launches are
    ``delta``."""
    for name, d in delta.items():
        launchers[name].launches += d


def _holds(t: torch.Tensor) -> tuple:
    """(Python references, storage references) of ``t``: a consumer
    that keeps ``t``, a view of it or a numpy array over it raises one
    of the two."""
    return (sys.getrefcount(t),
            torch._C._storage_Use_Count(t.untyped_storage()._cdata))


class StepGraph:
    """One step function at one shape, captured once and replayed.

    ``fn(*args)`` is the step.  In ``parked`` — the arguments of the
    warm-up and the capture — every numpy array is a staged int32 input
    and everything else is state read by address (parameters, arena,
    gathered caches).  :meth:`run` takes arguments of the same structure:
    arrays of the same shapes, the same state."""

    # one side stream a device for every warm-up: cuBLAS keeps a
    # workspace for each stream it has run on (32 MiB on Hopper), so a
    # new stream per graph would pin up to one per pooled stream
    _warmup_streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def __init__(self, fn: Callable, parked: Sequence[Any], *,
                 pool: Optional[tuple] = None):
        self.fn = fn
        self._staged = [i for i, a in enumerate(parked)
                        if isinstance(a, np.ndarray)]
        state = self._state(parked)
        if not state:
            raise ValueError("a step graph needs state on its device")
        self.device = state[0].device
        cuda = self.device.type == "cuda"
        self._ptrs = [t.data_ptr() for t in state]
        shapes = [tuple(parked[i].shape) for i in self._staged]
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        total = max(sum(sizes), 1)
        self._host = torch.empty(total, dtype=torch.int32, pin_memory=cuda)
        self._host_np = self._host.numpy()
        self._dev = torch.empty(total, dtype=torch.int32, device=self.device)
        # the copy out of the pinned buffer must be done before the host
        # writes it again
        self._copied = torch.cuda.Event() if cuda else None
        args = list(parked)
        self._spans = []
        off = 0
        for i, shape, size in zip(self._staged, shapes, sizes):
            args[i] = self._dev[off:off + size].view(shape)
            self._spans.append((i, off, size, shape))
            off += size
        self._args = tuple(args)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.delta: Dict[str, int] = {}     # launches a replay makes
        self.warmup: Dict[str, int] = {}    # launches the warm-up made
        self.replays = 0
        self._stage(parked)
        if cuda:
            self.outputs = self._capture(pool)
        else:
            self.outputs = fn(*self._args)  # the parked run
        self._out = tensor_leaves(self.outputs)
        self._held = [_holds(t) for t in self._out]

    def _state(self, args: Sequence[Any]) -> List[torch.Tensor]:
        return tensor_leaves([a for i, a in enumerate(args)
                              if i not in self._staged])

    def _stage(self, args: Sequence[Any]) -> None:
        """Write the int32 inputs into the pinned buffer and copy it to
        the device buffer in one non-blocking copy."""
        if self._copied is not None:
            self._copied.synchronize()
        for i, off, size, shape in self._spans:
            a = args[i]
            if tuple(a.shape) != shape:
                raise ValueError(f"step input {i}: shape {a.shape}, the "
                                 f"graph's is {shape}")
            self._host_np[off:off + size] = a.reshape(-1)
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def _capture(self, pool: Optional[tuple]):
        """Warm up on a side stream, then capture on the parked inputs."""
        cur = torch.cuda.current_stream(self.device)
        side = self._warmup_streams.get(self.device)
        if side is None:
            side = self._warmup_streams[self.device] = torch.cuda.Stream(
                self.device)
        side.wait_stream(cur)
        before = launch_counts(kernel_ops.LAUNCHERS)
        with torch.cuda.stream(side):
            self.fn(*self._args)
        cur.wait_stream(side)
        after = launch_counts(kernel_ops.LAUNCHERS)
        self.warmup = {n: after[n] - before[n] for n in after
                       if after[n] != before[n]}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = self.fn(*self._args)
        self.delta = take_back(kernel_ops.LAUNCHERS, after)
        self.graph = graph
        return out

    def run(self, args: Sequence[Any],
            fill: Optional[Callable[[], Any]] = None) -> Any:
        """One step on ``args``: check the state, stage the inputs, call
        ``fill`` (which copies state into a buffer the graph reads, such
        as the gathered caches), replay.  Returns the static outputs."""
        with trace.span("graph.check"):
            if [t.data_ptr() for t in self._state(args)] != self._ptrs:
                raise RuntimeError("a step graph's state was rebound: the "
                                   "arena, caches and parameters must stay "
                                   "at their captured addresses")
            if [_holds(t) for t in self._out] != self._held:
                raise RuntimeError("a step output was kept across the next "
                                   "replay of its graph: copy what you keep")
        with trace.span("graph.stage"):
            self._stage(args)
            if fill is not None:
                fill()
        with trace.span("graph.replay"):
            if self.graph is not None:
                self.graph.replay()
                add_launches(kernel_ops.LAUNCHERS, self.delta)
            else:
                res = self.fn(*self._args)
                for o, r in zip(self._out, tensor_leaves(res)):
                    o.copy_(r)
        self.replays += 1
        return self.outputs
