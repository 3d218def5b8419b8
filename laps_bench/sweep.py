"""Find a cell's knee: serve its traffic at several rates, one window each,
in one process on one engine, and print for each rate the latencies and
whether the backlog grew over the window.

  python3 laps_bench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
      --rates 0.2,0.3,0.4

A rate is sustained where the turns due in the window's last third wait
about as long as those of its first third, and the drain after the window
is short; the knee is the highest such rate.  Not run by the benchmark.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from laps_bench import harness
    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available():
        print("[sweep] no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    dev = torch.device("cuda")
    _, _, system = harness.prepare(spec, args.seed, dev)
    print(f"[sweep] set-up {time.monotonic() - T_PROCESS:.1f} s, "
          f"{system.num_pages} pages", flush=True)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        rec = harness.serve(spec, system, args.seed + i, args.seconds,
                            {"rate": rate}, None)
        due = rec.in_window()
        ttft = [(t.due - rec.t_start, t.first - t.due) for t in due
                if t.first is not None]
        third = args.seconds / 3

        def p90(xs):
            return float(np.percentile(xs, 90)) * 1e3 if xs else None

        early = [w for at, w in ttft if at < third]
        late = [w for at, w in ttft if at >= 2 * third]
        row = {"rate": rate, "due": len(due),
               "failed": sum(1 for t in due if not t.times),
               "ttft_mean_ms": float(np.mean([w for _, w in ttft])) * 1e3,
               "ttft_p90_ms": p90([w for _, w in ttft]),
               "ttft_p90_first_third_ms": p90(early),
               "ttft_p90_last_third_ms": p90(late),
               "drain_s": rec.drain_s, "peak_tokens": rec.peak_tokens,
               "pool_tokens": system.num_pages
               * int(spec["config"]["serving"]["page_size"]),
               "evicted": rec.stats1["pages_evicted"]
               - rec.stats0["pages_evicted"]}
        for name in ("tpot_p90_ms", "prefill_tick_ms", "decode_tick_ms",
                     "prefix_hit_share", "step_mfu"):
            row[name] = harness.metric_reader(name).read(rec)
        print("[sweep] " + json.dumps(row), flush=True)
        for t in rec.turns:          # unfinished turns keep their pages
            if t.outputs is None:
                system.engine.close_session(t.sid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
