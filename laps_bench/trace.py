"""Device trace of a ``--trace 1`` run: the PyTorch profiler recording
the card's activity (CUPTI: kernels, copies, sets) over the last part of
the window and its drain, read from its raw events.

The host side is not profiled: op-level recording of the host would slow
every tick.  The harness keeps its own spans instead, on the profiler's
clock (Unix-epoch nanoseconds), around the loop's tick and the program's
scheduler, engine and executor calls.  From both come: the time each
device operation ran, by name; the device's busy time (the union of
those intervals); each traced tick's idle time; and the idle gaps by
the innermost harness span the host was in.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import (_disable_profiler, _enable_profiler,
                            _prepare_profiler)
from torch.autograd.profiler import profile as AutogradProfile

TICK = "loop.tick"
OUTSIDE = "outside the loop"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def _device_op(ev) -> bool:
    """A kernel, copy or set that ran on the card (not an annotation)."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind()) in DEVICE_ACTIVITIES
    return not ev.is_user_annotation()


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _covered(merged: List[Tuple[int, int]], starts: List[int], s: int,
             e: int) -> int:
    """ns of [s, e) inside the merged intervals."""
    i = max(0, bisect.bisect_right(starts, s) - 1)
    got = 0
    while i < len(merged) and merged[i][0] < e:
        a, b = merged[i]
        got += max(0, min(b, e) - max(a, s))
        i += 1
    return got


@dataclasses.dataclass
class Summary:
    busy_s: float                      # device busy in the traced window
    window_s: float                    # the traced window's length
    op_s: Dict[str, float]             # device seconds by operation name
    tick_s: float                      # traced ticks' wall seconds
    tick_idle_s: float                 # of which no device operation ran
    gaps: Dict[str, float]             # idle seconds by host span
    stop_s: float                      # the profiler's stop, after the drain

    def kernel_seconds(self, match: Callable[[str], bool]) -> Optional[float]:
        hit = [v for k, v in self.op_s.items() if match(k)]
        return sum(hit) if hit else None

    def breakdown(self) -> Dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """One profiler window, started between ticks, and the harness's host
    spans while it is open."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.active = False
        self.spans: List[Tuple[int, int, str]] = []
        self._result = None
        self._t = (0, 0)
        self._stop_s = 0.0

    def _begin(self):
        """Start recording the card's activity (the host's ops on the CPU,
        where there is no card), through the profiler's own entry points:
        its stop then hands back the raw events, which are read here
        after the run, and builds no Python event objects."""
        ap = AutogradProfile(use_device="cuda" if self.cuda else None,
                             use_cpu=not self.cuda, use_kineto=True)
        config = ap.config(create_trace_id=True)
        _prepare_profiler(config, ap.kineto_activities)
        _enable_profiler(config, ap.kineto_activities)

    def prime(self) -> None:
        """Start and stop the profiler once in set-up, so the window's
        start does not pay its first initialisation."""
        self._begin()
        x = torch.ones(8, device=self.device)
        (x + x).sum().item()
        _disable_profiler()

    @contextlib.contextmanager
    def span(self, name: str):
        s = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((s, time.time_ns(), name))

    def start(self) -> None:
        self._begin()
        self.active = True
        self._t = (time.time_ns(), 0)

    def stop(self) -> None:
        """Stop the profiler and keep its raw events.  Its stop processes
        every event recorded, which takes seconds, so the harness calls it
        only once the window and its drain are over."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._t = (self._t[0], time.time_ns())
        a = time.monotonic()
        self._result = _disable_profiler()
        self._stop_s = time.monotonic() - a
        self.active = False

    def summary(self) -> Optional[Summary]:
        if self._result is None:
            return None
        dev: List[Tuple[int, int]] = []
        op_ns: Dict[str, int] = {}
        for ev in self._result.events():
            if not _device_op(ev):
                continue
            s, d = _ns(ev, "start"), _ns(ev, "duration")
            if d <= 0:
                continue
            name = ev.name().split("(")[0]
            op_ns[name] = op_ns.get(name, 0) + d
            dev.append((s, s + d))
        merged = _merge(dev)
        starts = [a for a, _ in merged]
        busy = sum(b - a for a, b in merged)
        tick_ns = idle_ns = 0
        for s, e, name in self.spans:
            if name == TICK:
                tick_ns += e - s
                idle_ns += (e - s) - _covered(merged, starts, s, e)
        gaps = _attribute_gaps(merged, self.spans)
        return Summary(busy_s=busy / 1e9, window_s=(self._t[1] - self._t[0])
                       / 1e9, op_s={k: v / 1e9 for k, v in op_ns.items()},
                       tick_s=tick_ns / 1e9, tick_idle_s=idle_ns / 1e9,
                       gaps={k: v / 1e9 for k, v in gaps.items()},
                       stop_s=self._stop_s)


def _attribute_gaps(merged: List[Tuple[int, int]],
                    spans: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """Idle ns between device operations, by the innermost harness span
    open on the host at each gap's middle."""
    # elementary host segments: the innermost open span from each edge on
    edges = sorted([(s, 1, -e, n) for s, e, n in spans]
                   + [(e, 0, 0, n) for s, e, n in spans])
    segs: List[Tuple[int, str]] = []
    stack: List[str] = []
    for t, opening, _, name in edges:
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        segs.append((t, stack[-1] if stack else OUTSIDE))
    seg_t = [t for t, _ in segs]
    out: Dict[str, int] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(seg_t, (a + b) // 2) - 1
        name = segs[i][1] if i >= 0 else OUTSIDE
        out[name] = out.get(name, 0) + (b - a)
    return out
