"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA card and fails on any fault:

  1. card and build — ``nvidia-smi`` name and power limit, the nvcc
     build of every kernel (seconds, ``-Xptxas -v`` registers / shared
     memory / spills);
  2. each kernel against its plain PyTorch version at qwen3-4b's head
     shapes (Hq 32, Hkv 8, D 128, page_size 16), fp32 and bf16, on
     fragmented, shared and COW-forked page tables, q_offsets > 0,
     length-1 decode segments inside a prefill stream, a bucket tail
     past cu_seqlens[-1], empty segments, decode rows with lengths 0,
     kv lengths off the page grid, 256- and 512-row chunks at histories
     of 1.5k-2k keys beside short segments, and table entries past the
     valid length poisoned so a stray read faults;
  3. the engine against the plain dense forward: qwen3-4b widths, 2
     layers, fp32, ServeLoop over 4 sessions × 2 turns + prefill_long,
     then 4 decode steps; logits within 1e-3 and the same greedy tokens;
  4. the full model: qwen3-4b, 36 layers, bf16, random weights from
     --seed, 8 sessions × 2 turns under ``pla_full`` with one
     2048-token prompt, served once to warm up and then --runs times,
     each on a fresh engine with a fixed LAPS boundary (no wall-time
     refit); every request answered, both kernels launched, prefix
     hits, a green arena audit, finite logits; median and spread of
     TTFT, throughput and seconds per tick, and peak memory;
  5. kernel times at main-path shapes with CUDA events (kernel, plain
     version, one PyTorch library call as a yardstick, the bound), and
     each kernel's output there held to its plain version;
  6. one JSON line describing every kernel, then the card line and the
     result line.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card and exits non-zero, printing no result, without
one.  fp32 comparisons run with TF32 off (matmul and cuDNN).

Tolerances, against the plain version computed in fp32 from the same
inputs, element by element: fp32 |out - ref| <= 1e-4.  bf16 kernels
round p to bf16 before the PV product (as the TPU kernels do) and
round the output once, each a relative error of at most u = 2^-8, so
|out - ref| <= u * (sum_j p_j |v_j| / l + |ref|) + 1e-4, where the first
term is the plain version run on |v|; and the max abs error <= 2e-2.
A dropped or repeated key tile moves outputs past that bound.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

DEVICE = "cuda"
HQ, HKV, D, PS = 32, 8, 128, 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 1

def phase_build():
    from repro_torch.kernels import _build
    log(f"[1] card: {card_line()}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "smem", "bytes stack")):
                log(f"[1] {name}: {line.strip()}")


# ------------------------------------------------------------ phase 2

POISON = 1 << 30   # table entries past the valid length: faults if read


def _layout(rng, n_pages, p_max, kv_lens, share=None):
    """Fragmented page table: each row gets ceil(kv_len/ps) distinct
    random pages; ``share=(a, b, k)`` gives row b row a's first k pages.
    Returns (poisoned table for the kernel, clamped table for the plain
    version), both int32 (B, P_max)."""
    table = np.full((len(kv_lens), p_max), POISON, np.int64)
    free = list(rng.permutation(n_pages))
    for i, n in enumerate(kv_lens):
        need = -(-n // PS)
        table[i, :need] = [free.pop() for _ in range(need)]
    if share is not None:
        a, b, k = share
        table[b, :k] = table[a, :k]
    clamped = np.where(table == POISON, n_pages - 1, table)
    return table.astype(np.int32), clamped.astype(np.int32)


def _pools(gen, n_pages, dtype):
    k = torch.randn((n_pages, PS, HKV, D), generator=gen, device=DEVICE)
    v = torch.randn((n_pages, PS, HKV, D), generator=gen, device=DEVICE)
    return k.to(dtype), v.to(dtype)


def _i32(x):
    return torch.as_tensor(np.asarray(x, np.int32), device=DEVICE)


def _held(out, plain, q, k, v, *index):
    """Hold a kernel's output to its plain version ``plain`` run in fp32
    on the same inputs (clamped tables), element by element
    (``ref.kernel_error_bound``).  Returns (max abs error, the largest
    error over its bound, ok, the plain output)."""
    from repro_torch.kernels.ref import kernel_error_bound
    ref, bound = kernel_error_bound(plain, out.dtype, q, k, v, *index)
    err = (out.float() - ref).abs()
    worst = (err / bound).max().item()
    max_err = err.max().item()
    return max_err, worst, max_err <= TOL[out.dtype] and worst <= 1.0, ref


PREFILL_CASES = {
    # lens, hists (q_offsets), tail rows past cu_seqlens[-1], share
    "fragmented": ([37, 5, 1, 64, 3], [0, 21, 40, 3, 130], 13, None),
    "shared_prefix": ([9, 17, 1], [48, 48, 70], 7, (0, 1, 3)),
    "cow_fork": ([4, 4, 1, 1], [37, 37, 90, 5], 0, (0, 1, 2)),
    "empty_segment": ([6, 4, 11], [0, 0, 200], 5, None),
    # main-path chunks: long page walks beside short segments
    "long_chunks": ([512, 3, 1, 256], [1536, 40, 900, 1800], 9, None),
}
DECODE_CASES = {
    # lengths, share
    "fragmented": ([1, 17, 130, 2053, 16, 33, 255, 7], None),
    "shared_cow": ([64, 70, 129, 1], (1, 0, 4)),
    "empty_rows": ([0, 5, 0, 300], None),
}


def phase_kernels(seed, errs):
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import ragged_prefill as rp
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    n_pages, p_max = 512, 160
    for dtype in (torch.float32, torch.bfloat16):
        k, v = _pools(gen, n_pages, dtype)
        for name, (lens, hists, tail, share) in PREFILL_CASES.items():
            kvl = [h + l for h, l in zip(hists, lens)]
            if name == "empty_segment":
                kvl[1] = 0          # a segment with no valid key at all
            tab, tab_c = _layout(rng, n_pages, p_max, kvl, share)
            cu = np.concatenate([[0], np.cumsum(lens)])
            t = int(cu[-1]) + tail
            q = torch.randn((t, HQ, D), generator=gen,
                            device=DEVICE).to(dtype)
            out = rp.ragged_prefill_paged(q, k, v, _i32(tab), _i32(cu),
                                          _i32(hists), _i32(kvl))
            torch.cuda.synchronize()
            index = (_i32(tab_c), _i32(cu), _i32(hists), _i32(kvl))
            err, worst, ok, ref = _held(
                out, rp.ragged_prefill_paged_plain, q, k, v, *index)
            # bucket-tail rows and rows with no valid key: exactly 0
            keyless = ref.abs().amax(dim=(1, 2)) == 0
            tail_zero = bool((out[keyless] == 0).all().item()) and \
                bool(keyless[int(cu[-1]):].all().item())
            ok = ok and tail_zero
            errs.setdefault(("prefill", dtype), []).append(err)
            log(f"[2] ragged_prefill_paged {name:14s} {str(dtype):15s} "
                f"T={t} max_abs_err={err:.3e} tol={TOL[dtype]:.0e} "
                f"err/bound={worst:.3f} tail_zero={tail_zero} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"ragged_prefill_paged {name} {dtype}"
        for name, (lengths, share) in DECODE_CASES.items():
            tab, tab_c = _layout(rng, n_pages, p_max, lengths, share)
            b = len(lengths)
            q = torch.randn((b, HQ, D), generator=gen,
                            device=DEVICE).to(dtype)
            out = dec.decode_attn_paged(q, k, v, _i32(tab), _i32(lengths))
            torch.cuda.synchronize()
            err, worst, ok, _ = _held(out, dec.decode_attn_paged_plain,
                                   q, k, v, _i32(tab_c), _i32(lengths))
            zero_rows = [i for i, n in enumerate(lengths) if n == 0]
            zeros = bool((out[zero_rows] == 0).all().item()) \
                if zero_rows else True
            ok = ok and zeros
            errs.setdefault(("decode", dtype), []).append(err)
            log(f"[2] decode_attn_paged    {name:14s} {str(dtype):15s} "
                f"B={b} max_abs_err={err:.3e} tol={TOL[dtype]:.0e} "
                f"err/bound={worst:.3f} zero_rows_zero={zeros} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"decode_attn_paged {name} {dtype}"


# ------------------------------------------------------------ phase 3

def _policy(engine, chunk_tokens, threshold):
    from repro_torch.core import H200_QWEN32B, Variant, make_policy
    from repro_torch.core.awd import AWDConfig
    awd = AWDConfig(packed=True, token_buckets=engine.ecfg.token_buckets,
                    packed_max_seqs=engine.packed_executor.max_seqs)
    return make_policy(Variant("pla_full"), H200_QWEN32B,
                       threshold=threshold, chunk_tokens=chunk_tokens,
                       awd_cfg=awd)


def phase_oracle(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.loop import ServeLoop
    cfg = get_config("qwen3-4b").replace(num_layers=2, dtype="float32")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=1024, chunk_tokens=64, measure=False),
        device=DEVICE)
    loop = ServeLoop(engine, _policy(engine, 64, 96), slo_ttft=None)
    rng = np.random.default_rng(seed + 1)
    system = rng.integers(1, cfg.vocab_size, 40)
    convs = {}
    for s in range(4):                       # turn 1: fresh sessions
        convs[s] = np.concatenate(
            [system, rng.integers(1, cfg.vocab_size,
                                  int(rng.integers(20, 160)))])
        loop.submit(s, convs[s], decode_tokens=2)
    loop.run_until_idle(max_wall=600.0)
    for s in range(4):                       # turn 2: the same sessions
        loop.submit(s, rng.integers(1, cfg.vocab_size,
                                    int(rng.integers(8, 40))),
                    decode_tokens=2)
    loop.run_until_idle(max_wall=600.0)
    # a fifth session prefilled through the chunked long path directly,
    # adopting the shared system prompt's indexed pages
    long_prompt = np.concatenate(
        [system, rng.integers(1, cfg.vocab_size, 200)])
    engine.open_session(4)
    engine.adopt_prefix(4, long_prompt)
    first = engine.prefill_long(4, long_prompt[engine.history(4):])
    loop.first_tokens[4] = first
    loop.last_token[4] = first
    for s in range(5):
        loop.decode(s, 4)
    worst = 0.0
    for s in range(5):
        ids = engine.arena._tokens[s]
        with torch.no_grad():
            ref = tr.forward(params, cfg, torch.tensor([ids], device=DEVICE))
        ref_last = ref[0, -1].float().cpu().numpy()
        got = engine.last_logits[s]
        err = float(np.abs(got - ref_last).max())
        same = int(np.argmax(got)) == int(np.argmax(ref_last))
        worst = max(worst, err)
        log(f"[3] session {s}: {len(ids)} cached tokens, logits "
            f"max_abs_err={err:.3e} (tol 1e-3) greedy_match={same}")
        assert err <= 1e-3 and same, f"engine vs oracle, session {s}"
    engine.arena.audit()
    log(f"[3] ok: engine == dense oracle (max_abs_err {worst:.3e}), "
        f"prefix_hit_tokens={engine.stats()['prefix_hit_tokens']}")


# ------------------------------------------------------------ phase 4

def _serve_once(cfg, params, seed):
    """Serve phase 4's trace once on a fresh engine and page pool, with
    the LAPS boundary fixed (``measure=False``: no refit from wall-time
    samples), so every run makes the same schedule.  The kernels' launch
    counters are set to 0 just before the trace and read just after."""
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.loop import ServeLoop
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=4096, chunk_tokens=256, measure=False),
        device=DEVICE)
    loop = ServeLoop(engine, _policy(engine, 256, 512), slo_ttft=None)
    rng = np.random.default_rng(seed + 2)
    system = rng.integers(1, cfg.vocab_size, 64)
    prompts = {0: rng.integers(1, cfg.vocab_size, 2048)}
    for s in range(1, 8):
        prompts[s] = np.concatenate(
            [system, rng.integers(1, cfg.vocab_size,
                                  int(rng.integers(16, 193)))])
    ticks = []          # (seconds, kind)

    def drive():
        while loop.has_work:
            px0 = engine.packed_executor.dispatches
            dx0 = engine.decode_executor.dispatches
            t = time.perf_counter()
            did, _ = loop.tick()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if engine.packed_executor.dispatches > px0:
                ticks.append((dt, "packed"))
            elif engine.decode_executor.dispatches > dx0:
                ticks.append((dt, "decode"))
            elif not did:
                time.sleep(0.0005)

    torch.cuda.synchronize()
    rp.ragged_prefill_paged.launches = 0
    dec.decode_attn_paged.launches = 0
    t_run = time.perf_counter()
    for s in range(8):                       # turn 1
        loop.submit(s, prompts[s], decode_tokens=16)
    drive()
    for s in range(8):                       # turn 2: full conversation
        gen = loop.generated[s][:-1]         # tokens whose KV is cached
        conv = np.concatenate(
            [prompts[s], gen, rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(16, 65)))])
        loop.close_session(s)
        loop.submit(100 + s, conv, decode_tokens=16)
    drive()
    wall = time.perf_counter() - t_run
    n_rp = rp.ragged_prefill_paged.launches
    n_dec = dec.decode_attn_paged.launches
    rep = loop.tracker.report(wall)
    st = engine.stats()
    prefill_s = sum(dt for dt, k in ticks if k == "packed")
    decode_s = sum(dt for dt, k in ticks if k == "decode")
    finite = all(bool(np.isfinite(x).all())
                 for x in engine.last_logits.values())
    engine.arena.audit()
    assert rep.n == 16 and rep.abandoned == 0, "unanswered requests"
    assert n_rp > 0 and n_dec > 0, "a kernel never launched"
    assert st["prefix_hit_tokens"] > 0, "no radix prefix hit"
    assert finite, "non-finite logits"
    return {
        "ttft_mean_ms": rep.mean_ttft * 1e3, "ttft_p90_ms": rep.p90_ttft * 1e3,
        "prefill_tok_s": st["packed_useful_tokens"] / prefill_s,
        "decode_tok_s": st["decode_useful_rows"] / max(decode_s, 1e-9),
        "packed_s_per_tick": prefill_s / max(1, st["packed_dispatches"]),
        "decode_s_per_tick": decode_s / max(1, st["decode_dispatches"]),
        "wall_s": wall,
        "schedule": (st["packed_dispatches"], st["decode_dispatches"],
                     st["packed_useful_tokens"], st["decode_useful_rows"],
                     st["prefix_hit_tokens"], st["chunk_hit_tokens"],
                     n_rp, n_dec),
    }


def phase_full(seed, card, runs):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config("qwen3-4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[4] qwen3-4b {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}: weights ready in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    results = []
    for i in range(runs + 1):            # run 0 warms up and is not kept
        r = _serve_once(cfg, params, seed)
        gc.collect()
        (packed, decode, ptok, drows, hits, chunk_hits, n_rp,
         n_dec) = r["schedule"]
        log(f"[4] run {i}: TTFT mean {r['ttft_mean_ms']:.1f} ms p90 "
            f"{r['ttft_p90_ms']:.1f} ms; prefill {ptok} tokens in {packed} "
            f"packed ticks, {r['prefill_tok_s']:.0f} tokens/s; decode "
            f"{drows} rows in {decode} decode ticks, "
            f"{r['decode_tok_s']:.0f} tokens/s; wall {r['wall_s']:.2f} s; "
            f"prefix_hit_tokens {hits} chunk_hit_tokens {chunk_hits}; "
            f"launches ragged_prefill_paged {n_rp} decode_attn_paged "
            f"{n_dec}; 16 requests answered, finite logits, audit green"
            f"{' (warm-up, not kept)' if i == 0 else ''}")
        if i:
            results.append(r)
    same = len({r["schedule"] for r in results}) == 1
    log(f"[4] card {card}: {runs} runs of the same trace after the "
        f"warm-up, schedule identical across them: {same}")
    for key, unit in [("ttft_mean_ms", "ms"), ("ttft_p90_ms", "ms"),
                      ("prefill_tok_s", "tokens/s"),
                      ("decode_tok_s", "tokens/s"),
                      ("packed_s_per_tick", "s"), ("decode_s_per_tick", "s"),
                      ("wall_s", "s")]:
        xs = [r[key] for r in results]
        log(f"[4] {key}: median {float(np.median(xs)):.4f} {unit}, "
            f"min {min(xs):.4f} max {max(xs):.4f} over {runs} runs "
            f"(card {card})")
    log(f"[4] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (card {card})")
    packed, decode, *_, n_rp, n_dec = results[0]["schedule"]
    return {"ragged_prefill_paged": (n_rp, packed),
            "decode_attn_paged": (n_dec, decode)}


# ------------------------------------------------------------ phase 5

def _time(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_times(seed, errs):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import ragged_prefill as rp
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 3)
    rng = np.random.default_rng(seed + 3)
    dt = torch.bfloat16
    n_pages, p_max, b_rows, keys = 2048, 4096 // PS, 8, 2048
    k, v = _pools(gen, n_pages + 1, dt)
    el = 2                                           # bf16 bytes
    out = {}

    # prefill chunk: 512 rows at history 1536 over 2048 keys, in an
    # 8-row stream (the other segments empty)
    rows, hist = 512, keys - 512
    tab, _ = _layout(rng, n_pages, p_max, [keys], None)
    table = np.full((b_rows, p_max), n_pages, np.int32)
    table[0] = np.where(tab[0] == POISON, n_pages, tab[0])
    cu = [0] + [rows] * b_rows
    q_off = [hist] + [0] * (b_rows - 1)
    kvl = [keys] + [0] * (b_rows - 1)
    q = torch.randn((rows, HQ, D), generator=gen, device=DEVICE).to(dt)
    args = (q, k, v, _i32(table), _i32(cu), _i32(q_off), _i32(kvl))
    got = rp.ragged_prefill_paged(*args)
    err, worst, ok, _ = _held(got, rp.ragged_prefill_paged_plain, *args)
    errs.setdefault(("prefill", dt), []).append(err)
    log(f"[5] ragged_prefill_paged 512 rows over {keys} keys: max_abs_err="
        f"{err:.3e} err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
    assert ok, "ragged_prefill_paged at main-path shapes"
    # the yardstick runs over pre-gathered, head-expanded K/V (the
    # gather is not timed)
    pages = table[0][:keys // PS].tolist()
    kg = k[pages].reshape(keys, HKV, D).repeat_interleave(HQ // HKV, 1)
    vg = v[pages].reshape(keys, HKV, D).repeat_interleave(HQ // HKV, 1)
    qs, ks, vs = (q.transpose(0, 1)[None], kg.transpose(0, 1)[None],
                  vg.transpose(0, 1)[None])
    mask = (torch.arange(keys, device=DEVICE)[None, :]
            <= hist + torch.arange(rows, device=DEVICE)[:, None])
    attended = sum(hist + r + 1 for r in range(rows))
    flops = 4 * attended * D * HQ
    nbytes = (2 * rows * HQ * D + 2 * keys * HKV * D) * el \
        + 4 * (table.size + 3 * b_rows + 1)
    out["ragged_prefill_paged"] = dict(
        ms=_time(lambda: rp.ragged_prefill_paged(*args)),
        plain_ms=_time(lambda: rp.ragged_prefill_paged_plain(*args), 3),
        library_ms=_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)),
        flops=flops, bytes=nbytes)

    # decode: 8 rows x 2048 keys
    lengths = [keys] * b_rows
    tab, _ = _layout(rng, n_pages, p_max, lengths, None)
    tab = np.where(tab == POISON, n_pages, tab).astype(np.int32)
    qd = torch.randn((b_rows, HQ, D), generator=gen, device=DEVICE).to(dt)
    dargs = (qd, k, v, _i32(tab), _i32(lengths))
    got = dec.decode_attn_paged(*dargs)
    err, worst, ok, _ = _held(got, dec.decode_attn_paged_plain, *dargs)
    errs.setdefault(("decode", dt), []).append(err)
    log(f"[5] decode_attn_paged {b_rows} rows x {keys} keys: max_abs_err="
        f"{err:.3e} err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
    assert ok, "decode_attn_paged at main-path shapes"
    idx = torch.as_tensor(tab[:, :keys // PS], device=DEVICE).long()
    kgd = k[idx].reshape(b_rows, keys, HKV, D).repeat_interleave(
        HQ // HKV, 2).transpose(1, 2)
    vgd = v[idx].reshape(b_rows, keys, HKV, D).repeat_interleave(
        HQ // HKV, 2).transpose(1, 2)
    out["decode_attn_paged"] = dict(
        ms=_time(lambda: dec.decode_attn_paged(*dargs)),
        plain_ms=_time(lambda: dec.decode_attn_paged_plain(*dargs), 3),
        library_ms=_time(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kgd, vgd)),
        flops=4 * b_rows * keys * D * HQ,
        bytes=(2 * b_rows * HQ * D + 2 * b_rows * keys * HKV * D) * el
        + 4 * (tab.size + b_rows))
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[5] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, library (SDPA over gathered pages) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
            f"{r['flops'] / 1e9:.2f} GFLOP)")
    return out


# ------------------------------------------------------------ main

KERNELS = {
    "ragged_prefill_paged": dict(
        source="src/repro_torch/csrc/ragged_prefill_paged.cu",
        replaces="src/repro/kernels/ragged_prefill.py:309",
        jax="repro.kernels.ragged_prefill.ragged_prefill_paged",
        key="prefill"),
    "decode_attn_paged": dict(
        source="src/repro_torch/csrc/decode_attn_paged.cu",
        replaces="src/repro/kernels/decode_attn.py:215",
        jax="repro.kernels.decode_attn.decode_attn_paged",
        key="decode"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5,
                    help="runs of phase 4's trace after one warm-up "
                         "(median and spread)")
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {int(p) for p in args.phases.split(",")}
    card = card_line()
    errs, launches, times = {}, {}, {}
    t0 = time.perf_counter()
    phase_build()
    if 2 in phases:
        phase_kernels(args.seed, errs)
    if 3 in phases:
        phase_oracle(args.seed)
    if 4 in phases:
        launches = phase_full(args.seed, card, args.runs)
    if 5 in phases:
        times = phase_times(args.seed, errs)
    rows = []
    for name, meta in KERNELS.items():
        t = times.get(name, {})
        n, ticks = launches.get(name, (None, None))
        e16 = errs.get((meta["key"], torch.bfloat16))
        e32 = errs.get((meta["key"], torch.float32))
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "jax": meta["jax"],
            "launches": n,
            "launches_per_tick": (n / ticks if n and ticks else None),
            "max_abs_err": max(e16) if e16 else None,
            "max_abs_err_fp32": max(e32) if e32 else None,
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")})
    log(f"[6] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
