"""Run one cell of the benchmark of ``repro_torch`` and print its result.

  python3 laps_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout, on a machine with the card the cell asks
for.  The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, the cell's end-to-end metrics (``--trace 0``)
or per-layer metrics (``--trace 1``), ``device``, with a trace its
``breakdown``, and last ``check``, the numbers compared with their
limits, which also end standard error.  It exits non-zero, printing no
result, without a card, when a module of JAX or of the JAX package is
loaded, or when the program's sources are not in the checkout.

Never in the benchmark's own runs: ``--control 1`` judges the fp8
control in the program's place by the same limits, and ``--fault
<name>`` plants one of ``faults.py``'s faults underneath the timed path;
either has to print ``correct`` false.  ``sweep.py`` finds a cell's knee.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "laps_bench")
# every build and kernel cache at a fixed place inside the checkout;
# few host threads, so one process drives the card steadily
for key, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[key] = os.path.join(CACHE, sub)
for key in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[key] = "2"
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch
    from laps_bench import harness
    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"[laps_bench] {args.workload} needs {spec['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    if args.fault:
        from laps_bench import faults
        faults.plant(args.fault)
        print(f"[laps_bench] fault planted: {args.fault}", file=sys.stderr)
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         T_PROCESS, control=bool(args.control))
    bad = harness.forbidden_modules()
    if bad:
        print(f"[laps_bench] loaded modules of JAX or the JAX package: "
              f"{bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
