"""Launch-plan A/B of the bf16 attention backward on one card.

Builds variants of ``src/repro_torch/csrc/flash_attn_bwd.cu`` into
``build/plans/<variant>/`` — the source as it is ("base"), other
warpgroup counts and ring depths, a division where the kernels multiply
and shift, a ping-pong between the two warpgroups, dQ waiting for S
apart from dP, and two cut-outs (the dK/dV kernel's Q/dO tile copies, or
every product, removed) — one ``nvcc`` each, all started together.  The
whole variants are held to ``ref.flash_attn_bwd_error_bound`` on eight
of chip_smoke's ``BWD_CASES`` (two runs bit-identical); the cut-outs
compute garbage and are only timed.  Each variant then runs at the
training shape (B 4, L 1024, 32 / 8 heads of 128, causal, bf16) in
rounds, the order rotated each round: CUDA events over 20 calls, and
torch.profiler's device time of each of the three kernels.  The
library routes ``flash_attn_bwd`` through each variant in turn.

    python3 tools/flash_bwd_plans.py [variant ...]

Needs a card and ``nvcc``; prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.kernels import _build  # noqa: E402

KV = "constexpr int kWGKV = 2, kStagesKV = 4;"
Q = "constexpr int kWGQ = 2, kStagesQ = 3;"
QDO_COPIES = """      copy_rows<D, 64, NT>(qstage(t), a.q,
                           query_rows<D>(a, rp, a.q, b, g, r0, nq));
      copy_rows<D, 64, NT>(qstage(t) + P::kTile, a.dout,
                           query_rows<D>(a, rp, a.dout, b, g, r0, nq));"""
SKIP = """namespace tcore {
__device__ __forceinline__ void skip_ss(float (&d)[32], uint64_t, uint64_t,
                                        int) {
  tc::fence_regs(d);
}
template <int N>
__device__ __forceinline__ void skip_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t,
                                        int) {
  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}
"""
KV_PRODUCTS = """      float s[32], dp[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss_n64(s, tc::desc(kwa + kk * 256, 128, 16 * D),
                       tc::desc(qs + kk * 256, 128, 16 * D), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss_n64(dp, tc::desc(vwa + kk * 256, 128, 16 * D),
                       tc::desc(dos + kk * 256, 128, 16 * D), kk > 0);
      tc::wgmma_commit();"""
PINGPONG = """      float s[32], dp[32];
      if (wg == 1) asm volatile("bar.sync 1, 256;" ::: "memory");
      if (!none) {
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_ss_n64(s, tc::desc(kwa + kk * 256, 128, 16 * D),
                         tc::desc(qs + kk * 256, 128, 16 * D), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::mma_ss_n64(dp, tc::desc(vwa + kk * 256, 128, 16 * D),
                         tc::desc(dos + kk * 256, 128, 16 * D), kk > 0);
        tc::wgmma_commit();
      }
      if (wg == 0) asm volatile("bar.arrive 1, 256;" ::: "memory");
      if (none) continue;"""
# variant: (edits of the source, held to the bound)
VARIANTS = {
    "base": ([], True),
    "kv_3_stages": ([(KV, KV.replace("4;", "3;"))], True),
    "kv_2_stages": ([(KV, KV.replace("4;", "2;"))], True),
    "q_4_stages": ([(Q, Q.replace("3;", "4;"))], True),
    # one warpgroup a block, two blocks an SM (two ring stages fit)
    "kv_1_warpgroup": ([(KV, "constexpr int kWGKV = 1, kStagesKV = 2;"),
                        ("__launch_bounds__(128 * kWGKV, 1)",
                         "__launch_bounds__(128 * kWGKV, 2)")], True),
    "q_1_warpgroup": ([(Q, "constexpr int kWGQ = 1, kStagesQ = 2;"),
                       ("__launch_bounds__(128 * kWGQ, 1)",
                        "__launch_bounds__(128 * kWGQ, 2)")], True),
    "divide_by_rep": ([(f"rp.{op}({x})", f"{x} {sym} rp.rep")
                       for x in ("i", "v", "v0", "v1")
                       for op, sym in (("div", "/"), ("mod", "%"))
                       if x in ("i", "v") or op == "div"], True),
    # warpgroup 1 issues S^T and dP^T after warpgroup 0 has issued its own
    "kv_pingpong": ([("      if (none) continue;\n", ""),
                     (KV_PRODUCTS, PINGPONG)], True),
    # dQ waits for S alone, forms P while dP is on the tensor cores, then
    # waits for dP
    "q_split_wait": ([
        ("                     tc::desc(kst + kk * 256, 128, 16 * D), kk > 0);"
         "\n#pragma unroll",
         "                     tc::desc(kst + kk * 256, 128, 16 * D), kk > 0);"
         "\n    tc::wgmma_commit();\n#pragma unroll"),
        ("    tc::wgmma_wait_all();\n    tc::fence_regs(s);\n"
         "    tc::fence_regs(dp);\n",
         '    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");'
         "\n    tc::fence_regs(s);\n"),
        ("    // dS = P (dP - delta) as bf16 A fragments",
         '    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");'
         "\n    tc::fence_regs(dp);\n    // dS = P (dP - delta) as bf16 A "
         "fragments")], True),
    "kv_no_qdo_copies": ([(QDO_COPIES, "")], False),
    "no_products": ([("namespace tcore {", SKIP),
                     ("tc::mma_ss_n64(", "skip_ss("),
                     ("tc::mma_rs<D>(", "skip_rs<D>(")], False),
}
CHECKED = ("qwen3-4b's training shape", "L 65",
           "qwen2.5-32b's 40 / 8 (rep 5)", "D 80",
           "hubert's 16 x 80, non-causal", "window 256 over 1024 keys",
           "offsets > 0, kv lengths < S", "a row with no key")
ROUNDS = 3


def build(names):
    """{variant: launch function}, each built from an edited copy of
    csrc/; prints each bf16 tensor-core kernel's registers and spills."""
    src = open(_build.CSRC / "flash_attn_bwd.cu").read()
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
        path = os.path.join(d, "flash_attn_bwd.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(d, "flash_attn_bwd.so")
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
            if "tc_kernelILi128E" in line and "Compiling" in line:
                kern = "dkdv" if "dkdv" in line else "dq"
                facts = "; ".join(x.strip() for x in lines[i + 1:i + 5]
                                  if "spill" in x or "registers" in x)
                print(f"{name} {kern} D=128: {facts}")
        fn = ctypes.CDLL(so).flash_attn_bwd_launch
        fn.argtypes = list(_build.SIGNATURES["flash_attn_bwd"][1])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_plans: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attn as fl
    from repro_torch.kernels.ref import flash_attn_bwd_error_bound
    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line())
    _build.build_all(["flash_attn"])
    fns = build(names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    cases = []
    for what, b, lq, s, hq, hkv, d, causal, window, offs, lens, _ in \
            cs.BWD_CASES:
        if what not in CHECKED:
            continue
        q, k, v, do, o, ln = cs._bwd_case(gen, b, lq, s, hq, hkv, d, offs,
                                          lens, torch.bfloat16)
        kw = dict(causal=causal, window=window)
        out, lse = fl.flash_attn(q, k, v, o, ln, return_lse=True, **kw)
        refs, bounds = flash_attn_bwd_error_bound(q, k, v, out, lse, do, o,
                                                  ln, **kw)
        cases.append((what, (q, k, v, out, lse, do, o, ln), kw, refs,
                      bounds))
    bad = 0
    for name in names:
        if not VARIANTS[name][1]:
            continue
        _build._loaded["flash_attn_bwd"] = fns[name]
        worst, same = 0.0, True
        for what, args, kw, refs, bounds in cases:
            got = fl.flash_attn_bwd(*args, **kw)
            again = fl.flash_attn_bwd(*args, **kw)
            torch.cuda.synchronize()
            same &= all(torch.equal(x, y) for x, y in zip(got, again))
            worst = max(worst, max(((g.float() - r).abs() / bd).max().item()
                                   for g, r, bd in zip(got, refs, bounds)))
        ok = worst <= 1.0 and same
        bad += not ok
        print(f"{name}: {len(cases)} cases, worst err/bound {worst:.3f}, "
              f"two runs bit-identical {same} {'ok' if ok else 'FAIL'}")
    del cases
    b, l, hq, hkv, d = 4, 1024, 32, 8, 128
    q, k, v, do, o, ln = cs._bwd_case(gen, b, l, l, hq, hkv, d, [0] * b,
                                      [l] * b, torch.bfloat16)
    out, lse = fl.flash_attn(q, k, v, o, ln, return_lse=True)
    flops = 5 * 2 * d * b * sum(i + 1 for i in range(l)) * hq
    times = {}
    for rnd in range(ROUNDS):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for name in order:
            _build._loaded["flash_attn_bwd"] = fns[name]
            ms = cs._time(lambda: fl.flash_attn_bwd(q, k, v, out, lse, do, o,
                                                    ln), 20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln)
                torch.cuda.synchronize()
            split = {e.key.split("<")[0].split("::")[-1]:
                     e.device_time_total / e.count / 1e3
                     for e in prof.key_averages()
                     if getattr(e, "device_time_total", 0)}
            times.setdefault(name, []).append(ms)
            print(f"round {rnd} {name}: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s of "
                  f"{flops / 1e9:.1f} GFLOP; " + ", ".join(
                      f"{k} {t:.4f}" for k, t in sorted(split.items())))
    for name in names:
        print(f"{name}: {' / '.join(f'{x:.4f}' for x in times[name])} ms")
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
