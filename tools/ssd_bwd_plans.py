"""Launch-plan A/B of the SSD scan's backward on one card.

Builds variants of ``src/repro_torch/csrc/ssd_scan_bwd.cu`` into
``build/plans/<variant>/`` — the source as it is ("base"), other group
grids (head ranges planned for 264 or 66 resident blocks, or for 64,
which cuts mamba2's heads into 5 ranges of 16; 32 DS columns a group
block; ranges of 16 heads), the head kernel at one block an SM
(more registers), and one cut-out: every ``mma.sync`` of the five
kernels replaced by a no-op that keeps its operands live — one ``nvcc``
each, all started together.  The whole variants are held to
``ref.ssd_bwd_error_bound`` on chip_smoke's ``SSD_BWD_CASES`` at B 2
(mamba2's layout, 80 heads in one group, and jamba's, 128 heads in 8)
with two runs bit-identical; the cut-out computes garbage and is only
timed.  Each variant then runs at the training shape (B 4, L 1024, DS
128, chunk 128, bf16) at both layouts in rounds, the order rotated each
round: CUDA events over 10 calls, and torch.profiler's device time of
each kernel a call.  The library routes ``ssd_scan_bwd`` through each
variant in turn; a variant that changes the group grid also sets the
launcher's ``BWD_KT`` / ``BWD_SMS``, which size the workspace.

    python3 tools/ssd_bwd_plans.py [variant ...]

Needs a card and ``nvcc``; prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

SMS = "constexpr int kSms = 132;"
HEADS = "    const int heads = (hpg + want - 1) / want;"
HEADS_16 = "    const int heads = hpg < 16 ? hpg : 16;"


def _ranges_of_16(b, l, nh, ds, g, chunk):
    """The launcher's side of variant heads_16: ranges of 16 heads."""
    hpg = nh // g
    heads = min(hpg, 16)
    return -(-hpg // heads), heads
KT = "constexpr int kKT = 64;"
HEAD_LB = ("__global__ void __launch_bounds__(kThreads, 2)\n"
           "ssd_bwd_head_kernel(")
MMA = "  tc::mma_16816(d, a[0], a[1], a[2], a[3], b[0], b[1]);"
NO_MMA = ('  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]),'
          ' "r"(a[3]), "r"(b[0]), "r"(b[1]));')
# variant: (edits of the source, launcher overrides, held to the bound)
VARIANTS = {
    "base": ([], {}, True),
    # the ranges planned for two group blocks an SM (mamba2's (4, 1024): 4
    # of 20 heads), for half the SMs (one range), and mamba2's heads cut
    # into ranges of 16 (5 ranges, 320 blocks)
    "sms_264": ([(SMS, SMS.replace("132", "264"))], {"BWD_SMS": 264}, True),
    "sms_66": ([(SMS, SMS.replace("132", "66"))], {"BWD_SMS": 66}, True),
    "heads_16": ([(HEADS, HEADS_16)], {"bwd_ranges": _ranges_of_16}, True),
    "kt_32": ([(KT, KT.replace("64", "32"))], {"BWD_KT": 32}, True),
    "head_1_block_an_sm": ([(HEAD_LB, HEAD_LB.replace("2)", "1)"))], {},
                           True),
    "no_mma": ([(MMA, NO_MMA)], {}, False),
}
ROUNDS = 3


def build(names):
    """{variant: launch function}, each built from an edited copy of
    csrc/; prints each kernel's registers and spills (bf16)."""
    src = open(_build.CSRC / "ssd_scan_bwd.cu").read()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old[:60]!r}")
            text = text.replace(old, new)
        d = os.path.join(ROOT, "build", "plans", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "ssd_scan_bwd.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(d, "ssd_scan_bwd.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"ssd_bwd_(\w+?)_kernel", line)
            if m and "Compiling" in line and "bfloat16" in line:
                facts = "; ".join(x.strip() for x in lines[i + 1:i + 5]
                                  if "spill" in x or "registers" in x)
                print(f"{name} {m.group(1)} bf16: {facts}")
        fn = ctypes.CDLL(so).ssd_scan_bwd_launch
        fn.argtypes = list(_build.SIGNATURES["ssd_scan_bwd"][1])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


_PLAN = {k: getattr(ssd, k) for k in ("BWD_KT", "BWD_SMS", "bwd_ranges")}


def use(name, fns):
    """Route the launcher through variant ``name``: its library, and the
    launcher's plan constants (or range function) that size the
    workspace as the variant's kernels carve it."""
    _build._loaded["ssd_scan_bwd"] = fns[name]
    for k, v in {**_PLAN, **VARIANTS[name][1]}.items():
        setattr(ssd, k, v)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_plans: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line())
    _build.build_all(["ssd_scan"])
    fns = build(names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    bad = 0
    layouts = ((cs.SSD_NH, 1), (cs.JAMBA_NH, cs.JAMBA_G))
    cases = []
    for nh, g in layouts:
        for what, l, zero, with_dst in cs.SSD_BWD_CASES:
            args, dy, dst = cs._ssd_bwd_case(gen, 2, l, nh, g,
                                             torch.bfloat16, zero, with_dst)
            _, _, states = ssd.ssd_scan(*args, chunk=cs.SSD_CHUNK,
                                        return_states=True)
            cases.append((args, dy, dst, states))
    for name in names:
        if not VARIANTS[name][2]:
            continue
        use(name, fns)
        worst, same = 0.0, True
        for args, dy, dst, states in cases:
            got = ssd.ssd_scan_bwd(*args[:5], states, dy, dst,
                                   chunk=cs.SSD_CHUNK)
            again = ssd.ssd_scan_bwd(*args[:5], states, dy, dst,
                                     chunk=cs.SSD_CHUNK)
            torch.cuda.synchronize()
            same &= all(torch.equal(x, y) for x, y in zip(got, again))
            worst = max(worst, cs._held_ssd_bwd(args, dy, dst, states,
                                                got)[1])
        ok = worst <= 1.0 and same
        bad += not ok
        print(f"{name}: {len(cases)} cases, worst err/bound {worst:.3f}, "
              f"two runs bit-identical {same} {'ok' if ok else 'FAIL'}",
              flush=True)
    del cases
    b, l = cs.SSD_TRAIN
    times = {}
    for nh, g in layouts:
        args, dy, dst = cs._ssd_bwd_case(gen, b, l, nh, g, torch.bfloat16)
        _, _, states = ssd.ssd_scan(*args, chunk=cs.SSD_CHUNK,
                                    return_states=True)
        flops, nbytes = cs._ssd_bwd_work(b, l, nh, g)

        def call():
            return ssd.ssd_scan_bwd(*args[:5], states, dy, dst,
                                    chunk=cs.SSD_CHUNK)
        for rnd in range(ROUNDS):
            order = names[rnd % len(names):] + names[:rnd % len(names)]
            for name in order:
                use(name, fns)
                ms = cs._time(call, 10)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                split = {}
                for e in prof.key_averages():
                    m = re.search(r"ssd_bwd_(\w+?)_kernel", e.key)
                    t = getattr(e, "device_time_total", 0)
                    if m and t:
                        split[m.group(1)] = split.get(m.group(1), 0.0) \
                            + t / 5 / 1e3
                times.setdefault((nh, name), []).append(ms)
                print(f"round {rnd} NH {nh} G {g} {name}: {ms:.4f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s, "
                      f"{nbytes / ms / 1e6:.0f} GB/s; " + ", ".join(
                          f"{k} {t:.4f}" for k, t in split.items()),
                      flush=True)
        del args, dy, dst, states
    for (nh, name), ts in times.items():
        print(f"NH {nh} {name}: {' / '.join(f'{x:.4f}' for x in ts)} ms")
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
