"""The host cost of one span of ``repro_torch.serving.trace``, with the
tracer off and on, and of one ``time.time_ns()``, in ns.

    python3 tools/span_cost.py [--n 200000] [--rounds 3]

from the root of a checkout.  A span here is what the serving path's
hottest one does: enter, ``set`` one attribute, exit.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.serving import trace  # noqa: E402


def per_span_ns(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("serve.tick") as sp:
            sp.set(kind="decode")
    return (time.perf_counter() - t0) / n * 1e9


def per_clock_ns(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        time.time_ns()
    return (time.perf_counter() - t0) / n * 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    for r in range(args.rounds):
        off = per_span_ns(args.n)
        trace.enable(cap=args.n)
        on = per_span_ns(args.n)
        trace.disable()
        trace.take()
        print(f"round {r}: span off {off:.1f} ns, on {on:.1f} ns, "
              f"time_ns {per_clock_ns(args.n):.1f} ns", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
