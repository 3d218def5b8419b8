"""Interleaved runs of one benchmark cell on two checkouts through
``tools/serve_spans.py``, untraced, and what they show.

    python3 tools/serve_ab.py --workload <cell> --parent <dir> \\
        --seeds <a,b,...> [--sides P0,C0,C1] [--seconds 51] --out <dir>
    python3 tools/serve_ab.py --show --out <dir>

from the root of the changed checkout, on a machine with the card the
cell asks for; ``--parent`` is the root of the parent's checkout, which
gets a copy of ``tools/serve_spans.py``.  A side is P (the parent) or C
(this checkout), then the tool's ``--spans`` (0 or 1).  Each seed runs
every side, in an order that rotates from one seed to the next, so that
no side always runs first; each run's last line goes to
``<out>/<side>.<seed>.jsonl`` and its log beside it.

The summary, for each metric of the result line and each of
``program``'s numbers: every side's median and spread (the quartiles'
distance over the median, ``statistics.quantiles(n=4)``), and for each
side against the first, the median of the per-seed changes (%) and
their spread (the quartiles' distance, in points).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join("tools", "serve_spans.py")


def run_all(workload: str, parent: str, seeds: List[int], sides: List[str],
            seconds: float, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    os.makedirs(os.path.join(parent, "tools"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, TOOL), os.path.join(parent, TOOL))
    for i, seed in enumerate(seeds):
        k = i % len(sides)
        for side in sides[k:] + sides[:k]:
            cwd = parent if side[0] == "P" else ROOT
            tag = os.path.join(out, f"{side}.{seed}")
            t0 = time.monotonic()
            with open(tag + ".jsonl", "w") as so, open(tag + ".err", "w") as se:
                rc = subprocess.call(
                    [sys.executable, TOOL, "--workload", workload,
                     "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", "0", "--spans", side[1]],
                    cwd=cwd, stdout=so, stderr=se)
            print(f"{side}.{seed} rc={rc} {time.monotonic() - t0:.0f} s",
                  flush=True)


def _spread(v: List[float]) -> float:
    med = statistics.median(v)
    if len(v) < 2 or not med:
        return float("nan")
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / med * 100


def show(out: str) -> None:
    runs: Dict[str, Dict[int, Dict[str, float]]] = {}
    for path in sorted(glob.glob(os.path.join(out, "*.jsonl"))):
        side, seed = os.path.basename(path)[:-6].split(".")
        lines = [ln for ln in open(path) if ln.startswith("{")]
        if not lines:
            print(f"{side}.{seed}: no result line")
            continue
        res = json.loads(lines[-1])
        m = {k: v["value"] for k, v in res["metrics"].items()}
        m.update({k: v for k, v in res.get("program", {}).items()
                  if isinstance(v, (int, float))})
        if not res["correct"]:
            print(f"{side}.{seed}: correct false")
        runs.setdefault(side, {})[int(seed)] = m
    sides = sorted(runs, key=lambda s: (s[0] != "P", s))
    names = sorted({k for by in runs.values() for m in by.values()
                    for k in m})
    for name in names:
        parts = []
        for side in sides:
            v = [m[name] for m in runs[side].values() if name in m]
            if v:
                parts.append(f"{side} {statistics.median(v):.4f} "
                             f"({_spread(v):.2f}%, {len(v)})")
        base = runs[sides[0]]
        for side in sides[1:]:
            d = [(m[name] / base[s][name] - 1) * 100
                 for s, m in runs[side].items()
                 if s in base and name in m and base[s].get(name)]
            if len(d) > 1:
                q = statistics.quantiles(d, n=4)
                parts.append(f"{side}/{sides[0]} {statistics.median(d):+.2f}%"
                             f" (quartiles {q[0]:+.2f} {q[2]:+.2f})")
        print(f"{name}: " + "; ".join(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--parent")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sides", default="P0,C0,C1")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", required=True)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)
    if not args.show:
        run_all(args.workload, os.path.abspath(args.parent),
                [int(s) for s in args.seeds.split(",")],
                args.sides.split(","), args.seconds, args.out)
    show(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
