"""Launch-plan A/B of the paged ragged prefill kernel on one card.

Builds variants of ``src/repro_torch/csrc/ragged_prefill_paged.cu`` (and
the headers it includes) into ``build/plans/<variant>/`` — the source as
it is ("base"), the ``cp.async`` tile core taken for every call
("cpasync"), other ring depths of the TMA-fed core, and cut-outs: the
K/V loads of the ``cp.async`` core removed ("cpasync_no_loads"), or
every wgmma of either core replaced by a no-op that keeps its operands
live ("cpasync_no_mmas", "no_mmas") — one ``nvcc`` each, all started
together.  A variant whose edit no longer matches the source is
skipped with a note.  The whole variants are held to the plain version
(``chip_smoke._held``) at both shapes below, with NaN in every pool row
a call does not own, and two runs bit-identical; the cut-outs compute
garbage and are only timed.  Then every variant runs in rounds, the
order rotated each round, CUDA events over 20 calls, at:

- row 1 of PERF.md's kernel table: a 512-row chunk at history 1536 over
  2048 keys in an 8-segment stream, at 32 / 8 and 40 / 8 heads;
- a mixed tick like those of qwen3-4b.mixed_closed: one 256-row chunk
  at history 4096 beside 15 one-row segments at histories 1024–12287,
  32 / 8 heads.

The library routes ``ragged_prefill_paged`` through each variant in
turn.

    python3 tools/prefill_plans.py [variant ...]

Needs a card and ``nvcc``; prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.kernels import _build  # noqa: E402

NAME = "ragged_prefill_paged"
CP_LOADS = ("      tc::cp_async16(ks + 16 * c, kbuf + o, in);\n"
            "      tc::cp_async16(vs + 16 * c, vbuf + o, in);\n")
SKIP = """namespace attn {
namespace tc {
__device__ __forceinline__ void skip_ss(float (&d)[32], uint64_t, uint64_t,
                                        int) {
  fence_regs(d);
}
template <int N>
__device__ __forceinline__ void skip_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t,
                                        int) {
  asm volatile("" : "+f"(d[0]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}
}  // namespace tc

"""
NS_HEAD = "namespace attn {\n\n"
# the paged export's choice of the TMA-fed core
TMA_CHOICE = "if (attn::tma_core(window, dtype, head_dim, page_size))"
STAGES = "static constexpr int kStages = 6;       // TMA ring"


def _no_mmas(path):
    return [(path, NS_HEAD, SKIP),
            (path, "tc::mma_ss_n64(", "tc::skip_ss("),
            (path, "tc::mma_rs<D>(", "tc::skip_rs<D>(")]


# variant: (edits (file, old, new), held to the plain version); the edit
# that turns the TMA-fed core off is skipped on a tree without it, where
# every call takes the cp.async core
VARIANTS = {
    "base": ([], True),
    "cpasync": ([("ragged_prefill_paged.cu", TMA_CHOICE, "if (false)")],
                True),
    "stages_4": ([("attn_tma.cuh", STAGES, STAGES.replace("6;", "4;"))],
                 True),
    "stages_5": ([("attn_tma.cuh", STAGES, STAGES.replace("6;", "5;"))],
                 True),
    "cpasync_no_loads": ([("ragged_prefill_paged.cu", TMA_CHOICE,
                           "if (false)"),
                          ("attn_tiles.cuh", CP_LOADS, "")], False),
    "cpasync_no_mmas": ([("ragged_prefill_paged.cu", TMA_CHOICE,
                          "if (false)")] + _no_mmas("attn_tiles.cuh"),
                        False),
    "no_mmas": (_no_mmas("attn_tma.cuh"), False),
}
ROUNDS = 3
PS, D = 16, 128


def _apply(name):
    """The variant's edited copy of csrc/, or None (with a note) when an
    edit no longer matches the source."""
    d = os.path.join(ROOT, "build", "plans", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fname, old, new in VARIANTS[name][0]:
        path = os.path.join(d, fname)
        text = open(path).read() if os.path.exists(path) else ""
        if old not in text and old == TMA_CHOICE:
            continue
        if old not in text:
            print(f"{name}: skipped, {fname} has no {old[:60]!r}")
            return None
        with open(path, "w") as f:
            f.write(text.replace(old, new, 1))
    return d


def build(names):
    """{variant: launch function}, each built from an edited copy of
    csrc/; prints each prefill kernel's registers and spills."""
    procs = {}
    for name in names:
        d = _apply(name)
        if d is None:
            continue
        so = os.path.join(d, f"{NAME}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(d, f"{NAME}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "13__nv_bfloat16Li128E" in line \
                    and "PagedLayout" in line:
                facts = "; ".join(x.strip() for x in lines[i + 1:i + 5]
                                  if "spill" in x or "registers" in x)
                kern = "tma" if "_tma" in line else "cp.async"
                print(f"{name} {kern} D=128: {facts}")
        fn = getattr(ctypes.CDLL(so), _build.SIGNATURES[NAME][0])
        fn.argtypes = list(_build.SIGNATURES[NAME][1])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _nan_pools(cs, gen, n_pages, hkv, owned):
    """K/V pools with NaN in every page no segment owns and in every row
    past a segment's length in its last page (for the kernel), and the
    same pools with 0 there (for the plain version)."""
    k, v = cs._pools(gen, n_pages + 1, torch.bfloat16, hkv=hkv)
    valid = np.zeros((n_pages + 1, PS), bool)
    for pages, n in owned:
        valid[pages] = True
        if n % PS:
            valid[pages[-1], n % PS:] = False
    return cs._nan_past(k, v, torch.as_tensor(valid, device="cuda"))


def calls(cs, gen, rng):
    """{name: (kernel's args, plain version's args, flops)} at row 1's
    shapes and the mixed tick."""
    out = {}
    n_pages, p_max = 8192, 12288 // PS
    keys, rows, b_rows = 2048, 512, 8
    hist = keys - rows
    # row 1: the 512-row chunk in an 8-segment stream (the rest empty)
    for hq, hkv, tag in ((32, 8, "row 1 (32/8)"), (40, 8, "row 1 (40/8)")):
        tab, _ = cs._layout(rng, n_pages, p_max, [keys], None)
        table = np.full((b_rows, p_max), n_pages, np.int32)
        table[0] = np.where(tab[0] == cs.POISON, n_pages, tab[0])
        k, v, kz, vz = _nan_pools(cs, gen, n_pages, hkv,
                                  [(table[0][:keys // PS], keys)])
        q = torch.randn((rows, hq, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        index = (cs._i32(table), cs._i32([0] + [rows] * b_rows),
                 cs._i32([hist] + [0] * (b_rows - 1)),
                 cs._i32([keys] + [0] * (b_rows - 1)))
        out[tag] = ((q, k, v) + index, (q, kz, vz) + index,
                    4 * sum(hist + r + 1 for r in range(rows)) * D * hq)
    # the mixed tick: a 256-row chunk at history 4096, 15 decode rows
    hists = [4096] + [int(x) for x in np.linspace(1024, 12287, 15)]
    lens = [256] + [1] * 15
    kvl = [h + n for h, n in zip(hists, lens)]
    tab, _ = cs._layout(rng, n_pages, p_max, kvl, None)
    table = np.where(tab == cs.POISON, n_pages, tab).astype(np.int32)
    k, v, kz, vz = _nan_pools(
        cs, gen, n_pages, 8,
        [(table[i][:-(-n // PS)], n) for i, n in enumerate(kvl)])
    t = sum(lens)
    q = torch.randn((t, 32, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    index = (cs._i32(table), cs._i32(np.cumsum([0] + lens)),
             cs._i32(hists), cs._i32(kvl))
    attended = sum(sum(h + r + 1 for r in range(n))
                   for h, n in zip(hists, lens))
    out["mixed tick"] = ((q, k, v) + index, (q, kz, vz) + index,
                         4 * attended * D * 32)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_plans: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ragged_prefill as rp
    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line())
    fns = build(names)
    names = [n for n in names if n in fns]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(35)
    shapes = calls(cs, gen, np.random.default_rng(35))
    bad = 0
    for name in names:
        if not VARIANTS[name][1]:
            continue
        _build._loaded[NAME] = fns[name]
        for tag, (args, zargs, _) in shapes.items():
            got = rp.ragged_prefill_paged(*args)
            again = rp.ragged_prefill_paged(*args)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            finite = bool(torch.isfinite(got).all())
            err, worst, ok, _ = cs._held(got, rp.ragged_prefill_paged_plain,
                                         *zargs)
            ok = ok and same and finite
            bad += not ok
            print(f"{name} {tag}: max_abs_err={err:.3e} err/bound="
                  f"{worst:.3f} finite {finite} bit-identical {same} "
                  f"{'ok' if ok else 'FAIL'}")
    times = {}
    for rnd in range(ROUNDS):
        order = names[rnd % len(names):] + names[:rnd % len(names)]
        for name in order:
            _build._loaded[NAME] = fns[name]
            for tag, (args, _, flops) in shapes.items():
                ms = cs._time(lambda: rp.ragged_prefill_paged(*args), 20)
                times.setdefault((name, tag), []).append(ms)
                print(f"round {rnd} {name} {tag}: {ms:.4f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s")
    for (name, tag), ts in times.items():
        print(f"{name} {tag}: {' / '.join(f'{x:.4f}' for x in ts)} ms")
    print(cs.card_line())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
