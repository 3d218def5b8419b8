"""Host spans of the serving path, on the profiler's clock.

The serving path marks where its host time goes: a span around each of
its phases, recorded as ``(start_ns, end_ns, name, attrs)`` on
``time.time_ns()``, the Unix-epoch clock the PyTorch profiler stamps
the card's kernels and copies with, so a device idle gap can be set
against the span the host was in.  ``attrs`` is a dict or None.

The spans, outermost first (``ServeLoop.tick`` holds all but ``gc``):

- ``serve.tick``: one loop tick, ``kind`` prefill, chunk, decode or idle;
- ``serve.schedule``: the decode backlog noted and the policy asked;
- ``engine.prepare``: host work before a step (prefix match, the packed
  stream, page tables, decode rows);
- ``graph.check``, ``graph.stage``, ``graph.replay``: a step graph's
  state checks, its input staging and its launch;
- ``engine.wait``: the step's ids (or logits) copied to the host, where
  the host waits for the card;
- ``engine.commit``: the written tokens committed, the draft fed and
  the lengths advanced after a step;
- ``serve.bookkeep``: the loop's own records after a step (tokens,
  first tokens, SLO tracker, the policy's completion, refits);
- ``graph.capture``: a step graph captured on a shape's first use;
- ``gc``: one collection of the interpreter, ``generation`` its oldest.

Off by default, and then :func:`span` hands back one shared no-op and
records nothing.  :func:`enable` starts recording (at most ``cap``
spans; later ones are counted as dropped), :func:`take` hands the
recorded spans over and starts a new buffer, :func:`disable` stops.
"""
from __future__ import annotations

import gc
from time import time_ns
from typing import Any, Dict, List, Optional, Tuple

Span = Tuple[int, int, str, Optional[Dict[str, Any]]]

CAP = 1 << 18               # spans kept a buffer: ~50 MB at the most

_on = False
_cap = CAP
_spans: List[Span] = []
_dropped = 0
_gc_t0 = 0


class _Off:
    """The span of a tracer that is off: enters, sets and exits as a
    no-op."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self.t0 = time_ns()
        return self

    def __exit__(self, *exc) -> None:
        _record(self.t0, time_ns(), self.name, self.attrs)

    def set(self, **attrs) -> None:
        """Add attributes to the span while it is open."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)


_OFF = _Off()


def _record(t0: int, t1: int, name: str,
            attrs: Optional[Dict[str, Any]]) -> None:
    global _dropped
    if len(_spans) < _cap:
        _spans.append((t0, t1, name, attrs))
    else:
        _dropped += 1


def _on_gc(phase: str, info: Dict[str, Any]) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = time_ns()
    elif _gc_t0:            # not a collection that began before enable
        _record(_gc_t0, time_ns(), "gc", {"generation": info["generation"]})
        _gc_t0 = 0


def span(name: str, **attrs):
    """A context manager that records ``name`` over the block it wraps,
    with ``attrs`` and any its ``set`` adds; a shared no-op when off."""
    if not _on:
        return _OFF
    return _Span(name, attrs or None)


def enable(cap: int = CAP) -> None:
    """Start recording, at most ``cap`` spans until the next take."""
    global _on, _cap
    _cap = int(cap)
    if not _on:
        _on = True
        gc.callbacks.append(_on_gc)


def disable() -> None:
    """Stop recording; what was recorded stays until taken."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_on_gc)


def take() -> Tuple[List[Span], int]:
    """(the spans recorded since the last take, in the order they ended;
    the spans dropped past the cap), and an empty buffer."""
    global _spans, _dropped
    out = (_spans, _dropped)
    _spans, _dropped = [], 0
    return out
