"""One run of a benchmark cell with the program's own spans on
(``repro_torch.serving.trace``), and what they show.

    python3 tools/serve_spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> --spans <0|1>

from the root of a checkout, on a machine with the card the cell asks
for.  The run is the benchmark's own (``laps_bench/harness.py``'s
``run``: set-up, the window, the drain, the metrics and the check),
with two things added: with ``--spans 1`` the program's tracer records
over the window and its drain, and with ``--trace 1`` those spans join
the harness's own in naming each idle gap of the card in ``breakdown``
(``device_idle_share`` still reads the harness's ``loop.tick`` alone).
The benchmark does neither yet: this tool stands in until its harness
turns the tracer on and joins the spans itself, and then goes, its
``host_ms`` becoming the readers of ``decode_host_ms`` and
``prefill_host_ms``.  With ``--spans 0`` it also runs on a checkout
whose program has no tracer.

The last line of standard output is the harness's result line with one
more key, ``program``:

- ``decode_tick_ms``, ``prefill_tick_ms``: the benchmark's readers, also
  untraced (the benchmark reports them in traced runs only);
- ``decode_host_ms``, ``prefill_host_ms``: the mean over the window's
  ``serve.tick`` spans that ran a decode-only step (a packed step) and
  lie outside the profiler's window, of each tick less the time from its
  first ``graph.replay`` start to its last ``engine.wait`` end: the
  card's idle time in a tick, measured on every tick and without CUPTI;
- with a trace, ``probe_ms``: the mean over the traced ticks of the
  harness's ``loop.tick`` less the program's ``serve.tick``; and
  ``wrapper_gap_share``: the share of the idle gaps (in %) still named
  by the harness's wrappers of the program's calls;
- ``span_s``: {name: [spans, seconds]} over the window and drain, so the
  host ms a span; ``dropped``, the spans past the tracer's cap.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

T_PROCESS = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
if __name__ == "__main__":
    # the benchmark's cache directories and host threads, before torch
    from laps_bench import run as _bench_run  # noqa: F401,E402

import numpy as np  # noqa: E402

from laps_bench import harness  # noqa: E402
from laps_bench import trace as bench_trace  # noqa: E402

# (start_ns, end_ns, name, attrs): ``repro_torch.serving.trace``'s spans
Span = Tuple[int, int, str, Optional[Dict]]

def host_ms(spans: List[Span], lo: int, hi: int,
            skip: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
    """{"decode_host_ms", "prefill_host_ms"}: the mean host-only ms of
    the ``serve.tick`` spans that start in [lo, hi) ns and do not meet
    ``skip`` (the profiler's window), by the kind of step they ran."""
    ticks = sorted((s, e, (a or {}).get("kind")) for s, e, n, a in spans
                   if n == "serve.tick")
    starts = [t[0] for t in ticks]
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for s, e, n, _ in spans:
        if n not in ("graph.replay", "engine.wait"):
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or e > ticks[i][1]:
            continue
        if n == "graph.replay":
            first[i] = min(first.get(i, s), s)
        else:
            last[i] = max(last.get(i, e), e)
    got: Dict[str, List[float]] = {"decode_host_ms": [],
                                   "prefill_host_ms": []}
    for i, (s, e, kind) in enumerate(ticks):
        if i not in first or i not in last or not lo <= s < hi:
            continue
        if skip is not None and s < skip[1] and e > skip[0]:
            continue
        name = "decode_host_ms" if kind == "decode" else "prefill_host_ms"
        got[name].append(((e - s) - (last[i] - first[i])) / 1e6)
    return {k: float(np.mean(v)) for k, v in got.items() if v}


def probe_ms(harness_spans: List[Tuple[int, int, str]],
             spans: List[Span]) -> Optional[float]:
    """Mean ms of each traced ``loop.tick`` outside the ``serve.tick``
    it holds."""
    inner = sorted((s, e) for s, e, n, _ in spans if n == "serve.tick")
    starts = [s for s, _ in inner]
    out = []
    for s, e, n in harness_spans:
        if n != bench_trace.TICK:
            continue
        i = bisect.bisect_left(starts, s)
        if i < len(inner) and inner[i][1] <= e:
            out.append((e - s) - (inner[i][1] - inner[i][0]))
    return float(np.mean(out)) / 1e6 if out else None


def readings(rec: harness.Record, spans: List[Span], dropped: int,
             epoch: float, tracer=None) -> Dict:
    """The ``program`` key of the result line (see the module's doc);
    ``epoch`` is the epoch less the harness's clock, in seconds."""
    out: Dict = {}
    for name in ("decode_tick_ms", "prefill_tick_ms"):
        value = harness.metric_reader(name).read(rec)
        if value is not None:
            out[name] = value
    skip = tracer._t if tracer is not None and tracer._t[1] else None
    out.update(host_ms(spans, int((rec.t_start + epoch) * 1e9),
                       int((rec.t_end + epoch) * 1e9), skip))
    if tracer is not None and rec.trace is not None:
        out["probe_ms"] = probe_ms(tracer.spans, spans)
        gaps = rec.trace.gaps
        total = sum(gaps.values())
        if total:
            # a gap that no program span, the harness's tick or the
            # outside of the loop names is a wrapper's
            own = {n for _, _, n, _ in spans} | {bench_trace.TICK,
                                                bench_trace.OUTSIDE}
            out["wrapper_gap_share"] = 100.0 * sum(
                v for n, v in gaps.items() if n not in own) / total
    by: Dict[str, List] = {}
    for s, e, n, _ in spans:
        c = by.setdefault(n, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) / 1e9
    out["span_s"] = by
    out["dropped"] = dropped
    return out


def run(spec: Dict, seed: int, seconds: float, traced: bool, spans_on: bool,
        t_process: float, device: str = "cuda", log=None
        ) -> Tuple[Dict, Dict]:
    """``harness.run`` with the program's tracer on over the window and
    drain (``spans_on``) and its spans joined to the profiler's window
    (``traced``).  Returns the result line's dict, with ``program``, and
    what it was read from: ``rec`` (the harness's ``Record``), ``spans``
    and ``dropped`` (the program's), ``tracer`` (with a trace) and
    ``epoch`` (the epoch less the harness's clock, s).  Without
    ``spans_on`` it runs on a program that has no tracer too."""
    got: Dict = {}
    real_serve, real_tracer = harness.serve, bench_trace.Tracer
    if spans_on:
        from repro_torch.serving import trace

    def take() -> None:
        if "spans" not in got:
            got["spans"], got["dropped"] = [], 0
            if spans_on:
                trace.disable()
                got["spans"], got["dropped"] = trace.take()

    class Joined(real_tracer):
        """The harness's profiler window, naming idle gaps by the
        program's spans too."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            got["tracer"] = self

        def stop(self) -> None:
            super().stop()
            take()              # the window and its drain are over

        def summary(self):
            own = self.spans
            self.spans = own + [(s, e, n) for s, e, n, _ in got["spans"]]
            try:
                return super().summary()
            finally:
                self.spans = own

    def serve(*a, **kw):
        got["epoch"] = time.time_ns() / 1e9 - harness.clock()
        if spans_on:
            trace.enable()
        try:
            got["rec"] = real_serve(*a, **kw)
        finally:
            take()
        return got["rec"]

    harness.serve, bench_trace.Tracer = serve, Joined
    try:
        res = harness.run(spec, seed, seconds, traced, t_process,
                          device=device, log=log)
    finally:
        harness.serve, bench_trace.Tracer = real_serve, real_tracer
    res["program"] = readings(got["rec"], got["spans"], got["dropped"],
                              got["epoch"], got.get("tracer"))
    return res, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch
    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available():
        print(f"[serve_spans] {args.workload} needs a CUDA card",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    res, _ = run(spec, args.seed, args.seconds, bool(args.trace),
                 bool(args.spans), T_PROCESS)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
