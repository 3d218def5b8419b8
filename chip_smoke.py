"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives every path of the port on one NVIDIA card and fails on any fault:

  1. card and build — ``nvidia-smi`` name and power limit, the nvcc
     build of the nine kernels (seconds, ``-Xptxas -v`` registers /
     shared memory / spills), the paged prefill and decode kernels'
     shared memory, registers and blocks per SM at each head width,
     ``ssd_scan``'s launch plan at a prompt's
     256-row step and at the packed bridge (each of its two CUDA
     kernels' blocks, dynamic shared memory, registers and blocks per
     SM; the walk must put work on every SM at B = 1; also at
     jamba-v0.1-52b's 128 heads in 8 groups), ``fused_sample``'s
     (cluster size, CTAs, shared bytes, registers, clusters resident at
     once; a verify tick's 40 bf16 rows must fit one wave);
     ``flash_attn_bwd``'s three kernels at each head width and dtype
     (the bf16 dK/dV and dQ kernels on the tensor cores, fp32 on the
     CUDA cores: shared bytes, registers, bytes spilled, blocks per SM)
     and their grids at the training shape; ``ssd_scan_bwd``'s launch
     plan at the training shape (4, 1024) at mamba2's layout (80 heads
     of 64, DS 128, G 1) and jamba's (128 heads, G 8): the blocks of
     its five kernels, shared bytes and registers of the dH-term, head
     and group kernels and blocks per SM of the last two, the head
     ranges, the workspace;
  2. each kernel against its plain PyTorch version at qwen3-4b's head
     shapes (Hq 32, Hkv 8, D 128) unless said otherwise, fp32 and
     bf16.  Paged kernels: page size 16, fragmented, shared and
     COW-forked page tables, q_offsets > 0, length-1 decode segments
     inside a prefill stream, a bucket tail past cu_seqlens[-1], empty
     segments, decode rows with lengths
     0, kv lengths off the page grid, 256- and 512-row chunks at
     histories of 1.5k-2k keys, and table entries past the valid length
     poisoned so a stray read faults.  Slot kernels: pad segments, tail
     rows, decode-ladder pad rows, keyless rows, S_max of 64, 192, 200
     and the main path (a 512-row chunk at history 1536 beside a short
     segment and a decode row in an 8-slot x 4096 arena), with every
     row at and past each kv length holding a large finite value.
     The fused sampling kernel: V = 151,936 (qwen3-4b's vocabulary),
     152,064 (qwen2.5-32b's), 50,280 (mamba2-2.7b's) and 128, R = 40, 8
     and 1, fp32 and bf16 logits, each row's path as predicted from the
     inputs logged (greedy, drawn by the leader CTA's warp or block,
     whole row), rows for each trouble
     spot (a padded-vocab tail,
     a negative kth value, top_k off and 1, ties at the kth value, -0.0
     beside +0.0, top_p near 1 and tiny, u = 0 and just below 1, all 8
     bias slots with a repeated id and one past V, tied greedy maxima).
     ``ssd_scan`` at mamba2-2.7b's heads (NH 80, HD 64, DS 128, chunk
     128), B/C in group form (G = 1) and per head (G = NH), L = 1, 127,
     128, 129, 300 and 2048, B = 1 and 8, fp32 and bf16, x / B / C as
     views into one conv-output row, pad (dt = 0) and strong-decay rows,
     a random non-zero init state; then the chunks it skips (dt = 0 for
     every head) at G = 1 and NH: a zero chunk first, between two real
     chunks and last, the packed bridge's rows of lengths 0, 1, 127,
     128, 129 and 300, and a chunk with one non-zero dt, which must not
     be skipped.  Then at jamba-v0.1-52b's layout (``ssd_scan@grouped``:
     NH 128, B/C in G = 8 groups of 16 heads, so the C·Bᵀ pass runs 8
     groups a chunk) at the same lengths, B = 1 and 8, fp32 and bf16,
     with the bridge's rows.  The dense kernels: ``flash_attn``
     at head widths 64, 80, 96 and 128 and ``decode_attn`` at 128, each
     at GQA groups of 1, 4, 5 and 8 (16/16, 32/8, 40/8, 64/8 heads):
     causal with per-row offsets, non-causal with kv lengths, a window,
     dummy rows whose queries start at the park position S - 1, rows of
     length 0, every row at and past each length poisoned.  The three
     ragged prefill kernels (the tensor-core tile core's ragged forms)
     over one stream whose tiles would straddle segments — a 300-row
     segment over many 64-key tiles and 16-token pages, 5-row verify
     segments at history 2043, bands ending mid-tile, a keyless
     segment, pad segments, tail rows — at GQA 32/8, 40/8, 8/8 and 32/4,
     every page, arena and park row past a length NaN.  The three decode
     kernels' split key walk at the same four groups: rows of C - 1, C,
     C + 1 and 2C keys at the chunk C the launcher plans, the capacity,
     a long row beside short ones, a row of length 0, a decode-ladder
     pad row, every page, arena, park and cache row past a length NaN.
     The four windowed forms (the paged kernels over ring page tables,
     the arena kernels over rolling slots) at mixtral-8x7b's layout (32
     / 8 heads, D 128, fp32 and bf16, window 4096, page size 16, a ring
     of 272 pages, slots of 4352 rows): kv 3000, 4352, 6000 and 12000
     in one stream with a fresh prompt, pads and tail rows, decode rows
     before, at and past the window and the depth; and a window of 100
     (C_l 16) for the wrap edges (kv inside the window, rows straddling
     the wrap, kv at exactly one and two depths, a segment longer than
     the margin); every row no segment holds NaN.  The six paged, arena
     and gathered kernels at the head widths besides 128
     (``WIDTH_HEADS``): 64 and 96 at stablelm-1.6b's and phi-3-vision's
     32 / 32 heads, 80 at 16 / 16, each also at 32 / 8, over the same
     tile-straddling stream and split-walk cases (every plan there
     splits the walk, so the combine runs at D / 4 lanes), and the four
     windowed forms at 64 and 96 (32 / 32) at the window of 100;
     ``fused_sample`` also at stablelm's 100,352, phi-3's 32,064 padded
     to 32,256 and minitron-8b's 256,000 columns.  Training:
     ``flash_attn`` with its log-sum-exp (lse within 1e-4 of the plain
     logsumexp, -inf on exactly the keyless rows) and ``flash_attn_bwd``
     (dq, dk, dv within ``ref.flash_attn_bwd_error_bound``, which in
     bf16 carries P and dS rounded to bf16 at the tensor cores'
     operands) at
     qwen3-4b's training shape (4, 1024, 32 / 8 x 128, causal), lengths
     1, 63, 65 and 1000, qwen2.5-32b's 40 / 8, widths 64 / 80 / 96,
     hubert's 16 x 80 non-causal, a 256 window over 1024 keys, offsets
     with kv lengths below S and a keyless row, fp32 and bf16; two runs
     bit-identical and two mutants (a dropped query tile, a dropped key
     tile) outside the bound; ``ops.mha`` and ``ops.ssd_grouped``
     differentiating on the card (one ``flash_attn_bwd`` / one
     ``ssd_scan_bwd`` launch, finite grads) while the seven serving
     dispatchers refuse under grad mode.  ``ssd_scan``'s training form
     and ``ssd_scan_bwd`` at B 2, L 1024 and 1000, with and without a
     final-state gradient and with a chunk of zero dt, at mamba2's and
     jamba's layouts, fp32 and bf16: the chunk states against the plain
     recurrence, y and the state bit-identical to the serving launch's,
     the six gradients within ``ref.ssd_bwd_error_bound``, two runs
     bit-identical and a dropped chunk far outside the bound.  The dense
     decode kernel's lse against ``ref_flash_attn_lse`` and the keys split
     in two parts merged by ``distributed.local.merge_partials`` against
     one call (``phase_decode_lse``).  ``ragged_prefill_paged`` on its
     TMA-fed core (bf16, D 128, no window; ``phase_tma_kernel``) at 32 /
     8 and 40 / 8 heads, causal and not, over kv lengths at, below and
     past pages and 64-key steps, a mixed step like qwen3-4b.mixed_closed's
     (a 256-row chunk at history 4096 beside 15 one-row segments at
     1024-12287) and shared prefix pages, with NaN in every pool row no
     segment owns: finite, the same bits as over zero pools, twice, and
     as the cp.async core's (the ring form at a window past every
     position), each launch counted in ``tma.launches``;
  3. the engine against the plain dense forward — run on a CPU copy of
     the parameters, so it takes the plain versions and none of the
     kernels it checks — in each of its five attention modes (the
     launcher's slot/dense default, the same grid with the dense decode
     step, the packed slot arena, the gathered slot baseline, the paged
     default): qwen3-4b widths, 2 layers, fp32, ServeLoop over 4
     sessions x 2 turns + prefill_long, then 4 decode steps; logits
     within 1e-3 and the same greedy tokens.  hubert-xlarge's encoder
     forward (full width, 2 layers, fp32) against the CPU forward,
     without a cache and with one and ``kv_valid_len``, at 1e-3.
     Speculative decoding on the paged and slot_arena engines: greedy
     speculation (drafts scripted from the plain stream at acceptance
     0.7) lossless, a sampled session's stream the same through the
     fused kernel and the host sampler, and a ServeLoop armed with
     NGramDraft(n=3), k = 4 giving the unarmed loop's transcripts.  The
     SSM family in its three modes (ssm_paged, ssm_slot_arena, ssm_dense)
     at mamba2-2.7b widths, 2 layers, fp32, against the dense forward
     (one ``ssd_scan`` from a zero state), with a prefix adopted
     through a state checkpoint on the page pool.  The windowed MoE
     family in its three modes (swa_paged: ring tables; swa_slot_arena:
     rolling slots; swa_dense: full-depth slots, the window masked) at
     mixtral-8x7b widths, 2 layers, fp32, the window lowered to 128 so
     sessions of a few hundred tokens wrap the ring and the rolling
     slot several times, against the dense forward with the window
     masked.  ``moe_layer`` against ``moe_dense_reference`` at mixtral
     widths, 8192 rows, fp32, capacity factor 8, within 1e-4.
     stablelm-1.6b and phi-3-vision-4.2b (MHA at head_dim 64 and 96,
     full width, 2 layers, fp32) in paged, slot_arena and slot_dense
     against the dense oracle, every attention launch at the config's
     width; phi-3-vision's ``forward(embeds=)`` over 1024 stub patch
     embeddings then 32 text tokens against the same on the CPU.
     qwen3-moe-30b-a3b (full width, 2 layers, fp32; 32 / 4 heads, a GQA
     group of 8) in paged / slot_arena / slot_dense and jamba-v0.1-52b
     (full width, one pattern group of 8 layers: SSD at 128 heads in 8
     groups, attention at layer 4, MoE on the odd layers; fp32) in the
     three SSM modes, both with 8 experts so the engine and the oracle
     take ``moe_dense_reference``, within 1e-4; jamba's prefix adopted
     through a state checkpoint with its KV pages.  ``moe_layer``
     against ``moe_dense_reference`` also at jamba's (16 experts top 2,
     4096 rows) and qwen3-moe's widths (128 of 768 top 8, 4096 rows) at
     capacity factor E / k (nothing dropped), and captured in a CUDA
     graph at both widths (bf16, 512 rows, factor 1.25: pairs dropped),
     each replay bit-identical to the eager call.  The multi-engine
     cluster at the qwen3-4b smoke config (head_dim 128, fp32) on the
     card against the same cluster on the CPU, both on a stepping
     clock: bench_slo's 2-engine spatial cluster on the slot arena and
     the page pool (6 answered, 2 sessions migrated, 80 tokens handed
     off, 0 host bytes) and bench_faults' 4-engine failover (one engine
     killed mid-decode: 8 finished, 0 lost, 2 sessions recovered
     bit-identical to the fault-free cluster), with the same
     transcripts, homes, stats and reports on both devices.  Training:
     two train steps (accum 2, remat) of the qwen3-4b, mixtral-8x7b,
     qwen3-moe (16 experts), mamba2-2.7b and jamba-v0.1-52b smoke
     configs at head_dim 128, fp32, on the card against the same steps
     on the CPU from one set of weights, ``flash_attn_bwd`` once per
     attention layer and ``ssd_scan_bwd`` once per SSD layer per
     microbatch;
     two bf16 ``TrainLoop`` runs bit-identical, and one checkpointed at
     step 2 and resumed to 4 bit-identical to the continuous run;
  4. the full model: qwen3-4b, 36 layers, bf16, random weights from
     --seed, 8 sessions under ``pla_full`` with one 2048-token prompt,
     served in each mode after one warm-up run, each run on a fresh
     engine with a fixed LAPS boundary (no wall-time refit); every
     request answered, each of the mode's kernels launched, finite
     logits; TTFT, throughput, seconds per tick, whole-slot copies,
     peak memory and launches per mode (``ragged_prefill_paged``'s per
     prefill tick beside its ``tma.launches``).  A fifth mode, spec, serves the
     paged trace with NGramDraft(n=3), k = 4 armed and half the sessions
     sampled through the fused kernel: 0 logits rows shipped, tokens per
     verify dispatch, acceptance and fused_sample launches per tick.
     Then mamba2-2.7b (64 layers, bf16) serves the same trace in the
     three SSM modes (the paged one on ``SSM_POOL``: every page carries
     a ~170 MB state slot): every request answered, ``ssd_scan`` once
     per layer in every prefill dispatch and never in a decode-only
     tick, state checkpoints and prefix hits, whole-slot copies.  Then
     hubert-xlarge (48 layers, bf16) over 8 clips of 1500 random frame
     embeddings: ms per batch, frames/s, ``flash_attn`` once per layer
     per forward and no other kernel.  Then mixtral-8x7b at full width
     cut to 16 of its 32 layers (43.7 GiB of bf16 weights) in the three
     windowed modes, max_len 8192, C_l 256: one 6144-token prompt (past
     the 4096-token window and the 4352-row ring or slot) and seven of
     80-256 tokens, 16 decode tokens each; turn 2 adds 1024 tokens to
     the long session and 16-64 to the others; every attention launch
     of the paged and arena modes a windowed form.  Then stablelm-1.6b
     (24 layers) and phi-3-vision-4.2b (32 layers) at full width and
     depth, bf16, serve the qwen3-4b trace in the five attention modes
     (one kept run each), every launch of the six paged, arena and
     gathered kernels at width 64 or 96 (the ``@d64`` / ``@d96``
     counters); qwen2.5-14b (48 layers) and minitron-8b (32 layers), at
     head_dim 128, one kept paged run each; qwen3-moe-30b-a3b at full
     width and depth (48 layers, 128 experts top 8 through the capacity
     dispatch, 32 / 4 heads), one kept paged run; jamba-v0.1-52b at full
     width cut to 16 of its 32 layers (2 of 4 pattern groups) in the
     three SSM modes (ssm_paged on ``SSM_POOL``: every page carries 14
     SSD layers' state and 2 attention layers' KV), one kept run each:
     ``ssd_scan`` once per SSD layer in every prefill dispatch, every
     launch at G = 8, state checkpoints adopted by prefix matches, the
     attention launches per tick, peak memory.  Then the multi-engine
     cluster: two qwen3-4b engines (full width and depth, bf16, one copy
     of the weights) on both arena families over a trace of two
     2048-token prompts among multi-turn shorts of 80-256 tokens (the
     port's ``data.synthetic``), spatial (prefill + decode roles,
     LengthAwareRouter at 512: the longs migrate to the decode engine,
     the first handoff under ``torch.profiler`` with no device-to-host
     copy) and round robin beside it: TTFT by class, migrations,
     handoff tokens and host bytes (0), the migration gate's both
     sides, ms per handoff, pool sizes and peak memory; and
     bench_faults' 4-engine failover at full width (nothing lost, the
     recovered tokens counted against the fault-free cluster's).  Last,
     qwen2.5-32b (the paper's model: 64 layers, 40 / 8 heads, qkv
     bias, 61 GiB of bf16 weights) at full width and depth on the paged
     default over the qwen3-4b trace, one kept run.  Training (before
     the cluster): qwen3-4b at full width cut to 12 of 36 layers, bf16,
     remat, 10 ``TrainLoop`` steps of accum 2 x (4, 1024) synthetic
     tokens: the loss per step (falling), ms per step split into the
     microbatches' forward + backward and AdamW, tokens/s, model
     TFLOP/s, ``flash_attn@lse`` / ``flash_attn_bwd`` launches per step,
     peak GiB, and one profiled step's device share (the backward
     kernels' share of it), the losses at seed 0 beside the CUDA-core
     backward's; then mamba2-2.7b
     at full width cut to 32 of 64 layers the same way, its SSD layers
     through ``ssd_scan@states`` and ``ssd_scan_bwd``;
  5. kernel times at main-path shapes with CUDA events (kernel, plain
     version, one PyTorch library call as a yardstick where one computes
     the same function, the bound, the kernel's achieved TFLOP/s; the
     paged and arena prefill kernels also at 40 / 8 heads; fused_sample at a verify tick's
     40 x 151,936 bf16 rows, one of them alone, all 40 down the
     whole-row path (top-k off) and all 40 at top_k 1000 (the radix
     select), from a CUDA graph of 20 launches; ragged_prefill_paged also at a verify
     tick's 8 x 5 rows and at the mixed step of phase 2, each paged
     prefill call that takes the TMA-fed core beside the cp.async
     core's time for the same call; ``ssd_scan`` on a 2048-token prompt in 8 chunk
     steps (device time from a CUDA graph, its two CUDA kernels' share
     by ``torch.profiler``), and a (64, 8) grid step, a packed step's
     (512, 8) bridge with every row real and the bridge as phase 4 builds
     it (the executor's stream rows and bucket, 7 prompts) as medians of
     9 interleaved kernel / plain timings; ``flash_attn``
     at the (64, 8) grid step at history 256 over 4096-deep slots and at
     hubert's (8, 1500, 16, 80) non-causal layer; the three decode
     kernels at 8 rows x 2048 keys and at 40 / 8 heads,
     ``decode_attn_paged`` also for one row and phase 4's uneven tick,
     each with its achieved GB/s beside the bound's), each kernel's
     output there held to its plain
     version, the parts of a dense grid tick (whole-slot copies, the
     kernel's attention beside its plain version over S_max), and
     ``torch.profiler`` over two qwen3-4b grid steps (eight 256-token
     prompts; one 256-token re-prefill at history 1792), one qwen3-4b
     paged decode tick at phase 4's lengths (the decode kernels' share)
     and a mamba2 packed prefill, grid prefill and decode tick (device
     time by kernel, busy share), and one decode tick each of
     mixtral-8x7b (16 layers, ring tables), jamba-v0.1-52b (16 layers,
     ssm_paged) and qwen3-moe-30b-a3b (48 layers, paged) beside its
     weight-read bound, the expert stacks' bytes apart.  ``ssd_scan``
     at jamba's layout on the 2048-token prompt (the
     ``ssd_scan@grouped`` row); ``ragged_prefill_paged`` and
     ``decode_attn_paged`` also at qwen3-moe's 32 / 4 heads.  The four
     windowed forms at mixtral's layout: the prefill kernels over phase
     2's 4096 stream, the decode
     kernels over an 8-row tick (WINDOW_DECODE_TICK), the bound over the
     in-window keys only, the yardstick one SDPA call over the same
     in-window keys gathered contiguously.  The six paged, arena and
     gathered kernels at head widths 64 and 96 (32 / 32 heads): the
     512-row chunk at history 1536 through each prefill kernel, decode
     at 8 rows x 2048 keys through each decode kernel (from a CUDA
     graph), each beside one SDPA call over the same keys, checked to
     compute the same function.  ``flash_attn_bwd`` and the forward
     with its log-sum-exp at the training shape, beside their plain
     versions, SDPA's backward alone (its grads checked) and forward,
     the backward's three kernels' device times apart;
     ``ssd_scan_bwd`` and ``ssd_scan``'s training form at (4, 1024) at
     mamba2's and jamba's layouts beside their plain versions and the
     serving launch (no single PyTorch call computes either), the
     backward's kernels' device times apart;
  6. the serve launcher, its default and ``--packed``, for qwen3-4b and
     mamba2-2.7b, at the smoke config and at published widths cut to 4
     layers, and for mixtral-8x7b at its smoke config and at published
     widths cut to 16 layers; stablelm-1.6b at full width and depth with
     ``--packed``, phi-3-vision-4.2b at full width and depth; the
     jamba-v0.1-52b smoke config, default and ``--packed``, and
     qwen3-moe-30b-a3b's with ``--packed``; the training launcher's
     smoke default for 20 steps and ``--full --layers 2`` for 3, the
     mamba2-2.7b and jamba-v0.1-52b smoke configs for 3, and mamba2
     with ``--full --layers 2`` for 3;
  7. sharding (ROADMAP item 15c): qwen3-4b at full width and depth with
     its params as DTensors placed by SERVE_RULES on a world-size-1 NCCL
     mesh — a prefill (B 4, S 4096) and 16 greedy decode steps against
     the same steps on plain tensors, the kernels launched on the local
     shards; one train step of phase 4's qwen3-4b cell and of the
     mamba2-2.7b smoke config under TRAIN_RULES against the plain step;
     the dry run's predicted peak bytes of that prefill and train step
     (meta tensors, a host mesh) against ``max_memory_allocated`` of
     the real steps; and the production-mesh dry run (fake process
     groups of 256 and 512) of qwen2.5-32b's prefill_32k and decode_32k
     and qwen3-4b's four shapes on 16 x 16 and 2 x 16 x 16, each a
     subprocess started at the phase's start;
  8. one JSON line describing every kernel, then the card line and the
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
fused_sample: greedy tokens exact; token and alt equal except on a row
whose u lies within 1e-5 of a non-zero cumulative mass of the plain
version (the order of float sums may move such a draw; such rows are
counted and printed); p_draft within 1e-5.  ssd_scan
(``kernels.ref.ssd_error_bound``): y and the final state within 1e-4 of
the largest magnitude in their (batch row, head) — sums of up to
Q + DS products taken in another order — and a bf16 y also within its
one rounding, u * |ref|.  ssd_scan_bwd
(``kernels.ref.ssd_bwd_error_bound``): each gradient within 1e-4 of the
same sums over absolute values plus 1e-6 of its largest magnitude, and
a bf16 dx, dB or dC also within its one rounding, u * |ref|.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

DEVICE = "cuda"
HQ, HKV, D, PS = 32, 8, 128, 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 1

def _bwd_spills(text):
    """{(kernel, dtype, D): spill-store bytes} of flash_attn_bwd's
    kernels from its ``-Xptxas -v`` log (the tensor-core kernels are the
    bf16 instances)."""
    out, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '[^']*?(delta|dkdv|dq)"
                      r"(_tc)?_kernelI(f|13__nv_bfloat16)?Li(\d+)E", line)
        if m:
            dt = torch.bfloat16 if m.group(2) or m.group(3) != "f" \
                else torch.float32
            key = (m.group(1), dt, int(m.group(4)))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key is not None:
            out[key] = int(m.group(1))
            key = None
    return out


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
    # the attention kernels' launch facts at each head width (the
    # prefill tile core: Q and 3 stages of K/V; the decode split walk:
    # each warp's bf16 ring, rows padded to 8-slot groups)
    from repro_torch.kernels import ragged_prefill as rp
    for name in ("ragged_prefill_paged", "decode_attn_paged"):
        for dt in (torch.bfloat16, torch.float32):
            log(f"[1] {name} {str(dt)[6:]} by head width: " + "; ".join(
                f"D={d} {f['smem']} B shared a block, {f['regs']} registers, "
                f"{f['blocks_per_sm']} blocks per SM"
                for d, f in ((d, rp.launch_info(name, d, dt))
                             for d in rp.HEAD_DIMS)))
    f = rp.tma_launch_info()
    log(f"[1] ragged_prefill_paged bf16 D=128 on the TMA-fed core: "
        f"{f['smem']} B shared a block, {f['regs']} registers, "
        f"{f['blocks_per_sm']} blocks per SM")
    # flash_attn_bwd's launch plan: its three kernels at each head width
    # (bf16 on the tensor cores, fp32 on the CUDA cores), with the bytes
    # ptxas spilled, and their grids at the full-width training shape
    from repro_torch.kernels import flash_attn as fl
    spills = _bwd_spills(logs.get("flash_attn_bwd", ""))
    for dt in (torch.bfloat16, torch.float32):
        for d in rp.HEAD_DIMS:
            info = fl.bwd_launch_info(d, dt)
            log(f"[1] flash_attn_bwd {str(dt)[6:]} D={d}: " + "; ".join(
                f"{k} {f['smem']} B shared a block, {f['regs']} registers, "
                f"{spills.get((k, dt, d), 'n/a')} B spilled, "
                f"{f['blocks_per_sm']} blocks per SM"
                for k, f in info.items()))
        log(f"[1] flash_attn_bwd {str(dt)[6:]} blocks at (B 4, L 1024, "
            f"32 / 8 heads): {fl.bwd_grid(4, 1024, 1024, HQ, HKV, dt)} of "
            f"256 threads")
    # ssd_scan's launch plan at a chunked prompt's step, B = 1, L = 256
    # (the card must have work on every SM), and at the packed bridge
    from repro_torch.kernels import ssd_scan as ssd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (mamba2's heads in one group; jamba's 128 heads in 8 groups)
    for dt in (torch.bfloat16, torch.float32):
        for b, l, nh, g in ((1, 256, SSD_NH, 1), (16, 512, SSD_NH, 1),
                            (1, 256, JAMBA_NH, JAMBA_G)):
            pl = ssd.plan(b, l, nh, SSD_HD, SSD_DS, g, dt, SSD_CHUNK)
            log(f"[1] ssd_scan plan {str(dt)[6:]} B={b} L={l} (NH {nh}, "
                f"HD {SSD_HD}, DS {SSD_DS}, G {g}, chunk {SSD_CHUNK}): 2 "
                f"kernels a call; C.B^T {pl['cb_blocks']} blocks, "
                f"{pl['cb_smem']} B shared, {pl['cb_regs']} registers, "
                f"{pl['cb_blocks_per_sm']} per SM; walk "
                f"{pl['walk_blocks']} blocks ({pl['slices_per_head']} "
                f"slices a head), {pl['walk_smem']} B shared, "
                f"{pl['walk_regs']} registers, {pl['walk_blocks_per_sm']} "
                f"per SM, on {sms} SMs")
            if b == 1:
                assert pl["walk_blocks"] >= sms, \
                    f"ssd_scan leaves SMs idle at B = 1, L = 256: {pl}"
    # ssd_scan_bwd's launch plan at the training shape (4, 1024), at
    # mamba2's layout and jamba's
    for dt in (torch.bfloat16, torch.float32):
        for nh, g in ((SSD_NH, 1), (JAMBA_NH, JAMBA_G)):
            shape = (*SSD_TRAIN, nh, SSD_HD, SSD_DS, g)
            pl = ssd.bwd_plan(*shape, dt, SSD_CHUNK)
            assert tuple(pl) == ssd.BWD_PLAN_KEYS
            assert (pl["head_ranges"], pl["heads_per_range"]) == \
                ssd.bwd_ranges(SSD_TRAIN[0], SSD_TRAIN[1], nh, SSD_DS, g,
                               SSD_CHUNK)
            work = 4 * ssd.bwd_workspace_floats(*shape, SSD_CHUNK) / 2**20
            launches = 5 + (2 if pl["head_ranges"] > 1 else 0) + 1
            log(f"[1] ssd_scan_bwd plan {str(dt)[6:]} (B, L) = {SSD_TRAIN} "
                f"(NH {nh}, HD {SSD_HD}, DS {SSD_DS}, G {g}, chunk "
                f"{SSD_CHUNK}): {launches} launches a call; (B.C^T)^T "
                f"{pl['cb_blocks']} blocks; dH terms {pl['dstate_blocks']} "
                f"blocks, {pl['dstate_smem']} B shared, "
                f"{pl['dstate_regs']} registers; head {pl['head_blocks']} "
                f"blocks, {pl['head_smem']} B shared, {pl['head_regs']} "
                f"registers, {pl['head_blocks_per_sm']} per SM; group "
                f"{pl['group_blocks']} blocks ({pl['head_ranges']} ranges "
                f"of {pl['heads_per_range']} heads), {pl['group_smem']} B "
                f"shared, {pl['group_regs']} registers, "
                f"{pl['group_blocks_per_sm']} per SM; workspace "
                f"{work:.0f} MiB; on {sms} SMs")
    # fused_sample's launch plan: one cluster a row; a verify tick's 40
    # bf16 rows over qwen3-4b's vocabulary must be resident in one wave
    from repro_torch.kernels import sampling as ks
    for dt, r, v in ((torch.bfloat16, 40, 151936), (torch.bfloat16, 1, 151936),
                     (torch.bfloat16, 40, 152064), (torch.bfloat16, 40, 50280),
                     (torch.float32, 40, 151936)):
        pl = ks.launch_plan(r, v, dt)
        log(f"[1] fused_sample plan {str(dt)[6:]} R={r} V={v}: cluster "
            f"{pl['cluster']} CTAs a row, {pl['ctas']} CTAs of "
            f"{pl['threads']} threads, {pl['smem']} B dynamic + "
            f"{pl['static_smem']} B static shared a CTA, {pl['regs']} "
            f"registers, {pl['clusters_resident']} clusters resident at "
            f"once ({'one wave' if r <= pl['clusters_resident'] else 'waves'}"
            f"), slices of {pl['slice']} columns, compact capacity "
            f"{pl['capacity']}")
        # the C side's Layout against the Python plan's statement of it
        assert pl["smem"] == ks.plan(v, dt)["smem"], pl
        if dt == torch.bfloat16 and v == 151936:
            assert r <= pl["clusters_resident"], \
                f"fused_sample R={r} does not fit one wave: {pl}"


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


def _pools(gen, n_pages, dtype, hkv=HKV):
    k = torch.randn((n_pages, PS, hkv, D), generator=gen, device=DEVICE)
    v = torch.randn((n_pages, PS, hkv, D), generator=gen, device=DEVICE)
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
            errs.setdefault(("ragged_prefill_paged", dtype), []).append(err)
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
            errs.setdefault(("decode_attn_paged", dtype), []).append(err)
            log(f"[2] decode_attn_paged    {name:14s} {str(dtype):15s} "
                f"B={b} max_abs_err={err:.3e} tol={TOL[dtype]:.0e} "
                f"err/bound={worst:.3f} zero_rows_zero={zeros} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"decode_attn_paged {name} {dtype}"


ARENA_SLOTS = 8
POISON_KV = 1000.0  # arena rows at and past kv_len: a large finite value,
#                     so a kernel that reads a masked row still passes
#                     (0 x finite = 0) but one that attends it fails
ARENA_PREFILL_CASES = {
    # S_max, lens, hists, tail rows, pad segments, keyless segment
    "pad_segments": (192, [37, 5, 1], [0, 21, 120], 13, 2, None),
    "keyless_segment": (64, [6, 4, 11], [0, 0, 30], 5, 0, 1),
    "s_max_200": (200, [100, 3, 1], [90, 40, 196], 0, 1, None),
    # the main path: a 512-row chunk at history 1536 over 2048 keys
    # beside a short segment and a decode row, padded to 8 stream rows
    "main_path": (4096, [512, 17, 1], [1536, 40, 900], 9, 5, None),
}
ARENA_DECODE_CASES = {
    # S_max, lengths of the live rows, decode-ladder pad rows
    "s_max_64": (64, [1, 17, 62, 0], 4),
    "s_max_192": (192, [190, 64, 33], 5),
    "s_max_200": (200, [198, 17, 0, 130, 1], 3),
    "main_path": (4096, [2048] * 8, 0),
}


def _arena(gen, s_max, dtype, live):
    """An (ARENA_SLOTS, s_max, HKV, D) K/V arena of random rows whose
    rows at and past each live slot's valid length (``live``: {slot:
    kv_len}), park row S_max - 1 included, and every row of the other
    slots hold POISON_KV."""
    shape = (ARENA_SLOTS, s_max, HKV, D)
    k = torch.randn(shape, generator=gen, device=DEVICE)
    v = torch.randn(shape, generator=gen, device=DEVICE)
    valid = torch.zeros((ARENA_SLOTS, s_max), dtype=torch.bool,
                        device=DEVICE)
    for slot, n in live.items():
        valid[slot, :min(n, s_max - 1)] = True
    for a in (k, v):
        a[~valid] = POISON_KV
    return k.to(dtype), v.to(dtype)


def _prefill_layout(rng, name):
    """Stream layout of an ARENA_PREFILL_CASES case: the slot map (pad
    segments name the first segment's slot, as the engine pads), cu,
    q_offsets and kv_lengths over all stream rows, T and S_max."""
    s_max, lens, hists, tail, n_pad, keyless = ARENA_PREFILL_CASES[name]
    kvl = [h + l for h, l in zip(hists, lens)]
    if keyless is not None:
        kvl[keyless] = 0
    slots = [int(s) for s in rng.permutation(ARENA_SLOTS)[:len(lens)]]
    total = sum(lens)
    cu = [0] + list(np.cumsum(lens)) + [total] * n_pad
    slot_map = slots + [slots[0]] * n_pad
    return (slot_map, cu, hists + [0] * n_pad, kvl + [0] * n_pad,
            total + tail, s_max, dict(zip(slots, kvl)))


def phase_slot_kernels(seed, errs):
    """The three slot-arena kernels against their plain versions."""
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import ragged_prefill as rp
    rng = np.random.default_rng(seed + 10)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 10)
    for dtype in (torch.float32, torch.bfloat16):
        for name in ARENA_PREFILL_CASES:
            slot_map, cu, hists, kvl, t, s_max, live = \
                _prefill_layout(rng, name)
            k, v = _arena(gen, s_max, dtype, live)
            q = torch.randn((t, HQ, D), generator=gen,
                            device=DEVICE).to(dtype)
            index = (_i32(cu), _i32(hists), _i32(kvl))
            # the gathered baseline's caches: each stream row's slot
            # copied out, as KVArena.gather gives them
            kg, vg = (a[_i32(slot_map).long()].contiguous() for a in (k, v))
            for kname, out, plain, args in (
                    ("ragged_prefill_arena",
                     rp.ragged_prefill_arena(q, k, v, _i32(slot_map),
                                             *index),
                     rp.ragged_prefill_arena_plain,
                     (q, k, v, _i32(slot_map)) + index),
                    ("ragged_prefill_attn",
                     rp.ragged_prefill_attn(q, kg, vg, *index),
                     rp.ragged_prefill_attn_plain, (q, kg, vg) + index)):
                torch.cuda.synchronize()
                err, worst, ok, ref = _held(out, plain, *args)
                keyless = ref.abs().amax(dim=(1, 2)) == 0
                zeros = bool((out[keyless] == 0).all().item()) and \
                    bool(keyless[int(cu[-1]):].all().item())
                ok = ok and zeros
                errs.setdefault((kname, dtype), []).append(err)
                log(f"[2] {kname:20s} {name:15s} {str(dtype):15s} "
                    f"S_max={s_max} T={t} max_abs_err={err:.3e} "
                    f"err/bound={worst:.3f} tail_and_keyless_zero={zeros} "
                    f"{'ok' if ok else 'FAIL'}")
                assert ok, f"{kname} {name} {dtype}"
        for name, (s_max, lengths, n_pad) in ARENA_DECODE_CASES.items():
            slots = [int(s) for s in rng.permutation(ARENA_SLOTS)
                     [:len(lengths)]]
            k, v = _arena(gen, s_max, dtype, dict(zip(slots, lengths)))
            # pad rows read row 0 of the first live row's slot
            slot_map = slots + [slots[0]] * n_pad
            lens = lengths + [1] * n_pad
            b = len(lens)
            q = torch.randn((b, HQ, D), generator=gen,
                            device=DEVICE).to(dtype)
            args = (q, k, v, _i32(slot_map), _i32(lens))
            out = dec.decode_attn_arena(*args)
            torch.cuda.synchronize()
            live_rows = list(range(len(lengths)))
            err, worst, ok, _ = _held(out[live_rows],
                                      dec.decode_attn_arena_plain,
                                      q[live_rows], k, v,
                                      _i32(slots), _i32(lengths))
            zero_rows = [i for i, n in enumerate(lengths) if n == 0]
            zeros = bool((out[zero_rows] == 0).all().item()) \
                if zero_rows else True
            ok = ok and zeros and bool(torch.isfinite(out).all().item())
            errs.setdefault(("decode_attn_arena", dtype), []).append(err)
            log(f"[2] decode_attn_arena    {name:15s} {str(dtype):15s} "
                f"S_max={s_max} B={b} max_abs_err={err:.3e} "
                f"err/bound={worst:.3f} zero_rows_zero={zeros} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"decode_attn_arena {name} {dtype}"


# the tile core's ragged cases: every GQA group a 128-vector bf16 tile
# takes differently — qwen3-4b's 32 / 8 (32 rows a tile), qwen2.5-32b's
# 40 / 8 (25 rows, 3 idle vectors), 8 / 8 (128 rows), 32 / 4 (16 rows)
TILE_HEADS = ((32, 8), (40, 8), (8, 8), (32, 4))
# segments: a long one over many 64-key tiles and 16-token pages, a
# verify tick's 5-row segments at history 2043 (a tile of 32 rows across
# them would walk four 2048-key bands), one at history 37, a decode
# row, bands that start and end mid-tile, a keyless segment; then 2 pad
# segments and 9 tail rows
TILE_LENS = [300, 5, 5, 5, 5, 1, 70, 6]
TILE_HISTS = [1000, 2043, 2043, 37, 100, 900, 61, 0]
TILE_KEYLESS = 7
TILE_S_MAX = 2100    # not a multiple of the 64-key tile
# the head widths besides 128: stablelm-1.6b's 64 and phi-3-vision-
# 4.2b's 96 at their 32 / 32 heads (MHA: 128 rows of one head a bf16
# tile, one query head a decode group), 80 at 16 / 16, and each at 32 /
# 8; as (D, Hq, Hkv)
WIDTH_HEADS = ((64, 32, 32), (96, 32, 32), (80, 16, 16), (64, 32, 8),
               (80, 32, 8), (96, 32, 8))
# the six paged, arena and gathered attention kernels: each takes every
# width of HEAD_DIMS, as flash_attn does
WIDTH_KERNELS = ("ragged_prefill_paged", "decode_attn_paged",
                 "decode_attn_arena", "ragged_prefill_arena",
                 "ragged_prefill_attn", "decode_attn")
# the kernels line's own rows: the served MHA configs' widths
ROW_WIDTHS = (64, 96)


def _row(name, d):
    """The kernels-line row that a result at head width ``d`` belongs
    to: ``name@d64`` and ``name@d96`` rows of their own, 80 and 128 the
    base row."""
    return f"{name}@d{d}" if d in ROW_WIDTHS else name


def _groups():
    """(D, Hq, Hkv) of phase 2's tile and split cases: TILE_HEADS at D,
    then WIDTH_HEADS."""
    return [(D, hq, hkv) for hq, hkv in TILE_HEADS] + list(WIDTH_HEADS)


def _nan_past(k, v, valid):
    """K/V with every row where ``valid`` is False set to NaN (a kernel
    that reads one shows it), and the same with 0 there for the plain
    version."""
    kp, vp = k.clone(), v.clone()
    kp[~valid], vp[~valid] = float("nan"), float("nan")
    k[~valid], v[~valid] = 0.0, 0.0
    return kp, vp, k, v


# the non-causal form (causal=False) of the three ragged kernels: at
# every head width at qwen3-4b's 32 / 8 heads and at 32 / 32 (MHA), over
# phase 2's ragged stream with each segment's kv length NC_EXTRA keys
# past its rows, so every query has keys after its own position
NC_GROUPS = tuple((d, hq, hkv) for d in (64, 80, 96, 128)
                  for hq, hkv in ((32, 8), (32, 32)))
NC_EXTRA = [37, 40, 9, 50, 3, 70, 11, 0]


def phase_tile_kernels(seed, errs, causal=True):
    """The three ragged prefill kernels over one stream at each of
    TILE_HEADS and WIDTH_HEADS, fp32 and bf16: paged (16-token pages, a
    64-key tile spanning four; table entries past each length poisoned,
    pool rows past each length NaN), the slot arena (rows past each
    length and the park row S_max - 1 NaN, pad segments naming a live
    slot) and the gathered slots.  ``causal=False``: the non-causal form
    at NC_GROUPS, each kv length NC_EXTRA keys past its segment's rows,
    its errors on the ``<kernel>@nc`` rows."""
    import functools
    from repro_torch.kernels import ragged_prefill as rp
    rng = np.random.default_rng(seed + 40 + (not causal))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 40 + (not causal))
    n_pad, tail = 2, 9
    lens, hists = TILE_LENS, TILE_HISTS
    extra = [0] * len(lens) if causal else NC_EXTRA
    kvl = [h + n + e for h, n, e in zip(hists, lens, extra)]
    kvl[TILE_KEYLESS] = 0
    total = sum(lens)
    cu = [0] + [int(c) for c in np.cumsum(lens)] + [total] * n_pad
    offs, kvl = hists + [0] * n_pad, kvl + [0] * n_pad
    index = (_i32(cu), _i32(offs), _i32(kvl))
    n_pages, p_max = 512, 160
    tab, tab_c = _layout(rng, n_pages, p_max, kvl)
    page_ok = torch.zeros((n_pages, PS), dtype=torch.bool, device=DEVICE)
    for i, n in enumerate(kvl):
        for p in range(0, n, PS):
            page_ok[int(tab[i, p // PS]), :min(PS, n - p)] = True
    n_slots = len(lens) + 1
    slots = [int(x) for x in rng.permutation(n_slots)[:len(lens)]]
    slot_map = slots + [slots[0]] * n_pad
    slot_ok = torch.zeros((n_slots, TILE_S_MAX), dtype=torch.bool,
                          device=DEVICE)
    for slot, n in zip(slots, kvl):
        slot_ok[slot, :min(n, TILE_S_MAX - 1)] = True
    form = "tiles" if causal else "tiles nc"
    for dtype in (torch.float32, torch.bfloat16):
        for d, hq, hkv in (_groups() if causal else NC_GROUPS):
            q = torch.randn((total + tail, hq, d), generator=gen,
                            device=DEVICE).to(dtype)
            pools = [torch.randn((n_pages, PS, hkv, d), generator=gen,
                                 device=DEVICE) for _ in range(2)]
            kp, vp, kpc, vpc = (a.to(dtype) for a in _nan_past(
                *pools, page_ok))
            arena = [torch.randn((n_slots, TILE_S_MAX, hkv, d),
                                 generator=gen, device=DEVICE)
                     for _ in range(2)]
            ka, va, kac, vac = (a.to(dtype) for a in _nan_past(
                *arena, slot_ok))
            sm = _i32(slot_map).long()
            c = dict(causal=causal)
            for name, out, plain, args in (
                    ("ragged_prefill_paged",
                     rp.ragged_prefill_paged(q, kp, vp, _i32(tab), *index,
                                             **c),
                     rp.ragged_prefill_paged_plain,
                     (q, kpc, vpc, _i32(tab_c)) + index),
                    ("ragged_prefill_arena",
                     rp.ragged_prefill_arena(q, ka, va, _i32(slot_map),
                                             *index, **c),
                     rp.ragged_prefill_arena_plain,
                     (q, kac, vac, _i32(slot_map)) + index),
                    ("ragged_prefill_attn",
                     rp.ragged_prefill_attn(q, ka[sm].contiguous(),
                                            va[sm].contiguous(), *index,
                                            **c),
                     rp.ragged_prefill_attn_plain,
                     (q, kac[sm], vac[sm]) + index)):
                torch.cuda.synchronize()
                err, worst, ok, ref = _held(
                    out, functools.partial(plain, **c), *args)
                keyless = ref.abs().amax(dim=(1, 2)) == 0
                zeros = bool((out[keyless] == 0).all().item()) and \
                    bool(keyless[total:].all().item())
                ok = ok and zeros and bool(torch.isfinite(out).all())
                row = _row(name, d) if causal else f"{name}@nc"
                errs.setdefault((row, dtype), []).append(err)
                log(f"[2] {name:20s} {form} {hq}/{hkv} D={d} "
                    f"{str(dtype):15s} T={total + tail} max_abs_err="
                    f"{err:.3e} err/bound={worst:.3f} "
                    f"tail_and_keyless_zero={zeros} "
                    f"{'ok' if ok else 'FAIL'}")
                assert ok, f"{name} {form} {hq}/{hkv} D={d} {dtype}"
    if not causal:
        # every query of a segment had keys past its own position: the
        # non-causal form was really taken (each launch counted apart)
        assert all(getattr(rp, n).noncausal.launches >= 2 * len(NC_GROUPS)
                   for n in ("ragged_prefill_paged", "ragged_prefill_arena",
                             "ragged_prefill_attn"))


# the paged prefill's TMA-fed core (bf16, D = 128, no window): segments
# (rows, history, kv length) with kv lengths at, below and past 16-token
# pages and 64-key steps (a keyless segment among them), a mixed step
# like qwen3-4b.mixed_closed's, and two segments on shared prefix pages
TMA_CASES = {
    "edges": ([(1, 14, 15), (3, 13, 16), (1, 16, 17), (17, 46, 63),
               (1, 63, 64), (64, 1, 65), (2, 126, 128), (1, 128, 129),
               (5, 0, 0)], None),
    "mixed": ([(256, 4096, 4352)] + [(1, int(h), int(h) + 1) for h in
                                     np.linspace(1024, 12287, 15)], None),
    "shared": ([(9, 48, 57), (17, 48, 65), (1, 70, 71), (40, 100, 140)],
               (0, 1, 3)),
}
# a window past every position: the ring-table form then walks the
# same 64-key steps with the same arithmetic on the cp.async core
NO_WINDOW = 1 << 30


def _tma_inputs(gen, rng, segs, share, hq, hkv):
    """q, the pools with NaN in every row no segment owns and with 0
    there, the table (entries past each length name a page of NaN) and
    the index tensors."""
    lens = [n for n, _, _ in segs]
    kvl = [kv for _, _, kv in segs]
    n_pages = sum(-(-x // PS) for x in kvl) + 8
    table, _ = _layout(rng, n_pages - 1, 12288 // PS, kvl, share)
    table = np.where(table == POISON, n_pages - 1, table).astype(np.int32)
    ok = torch.zeros((n_pages, PS), dtype=torch.bool, device=DEVICE)
    for i, n in enumerate(kvl):
        for p in range(0, n, PS):
            ok[int(table[i, p // PS]), :min(PS, n - p)] = True
    pools = [torch.randn((n_pages, PS, hkv, D), generator=gen,
                         device=DEVICE) for _ in range(2)]
    kn, vn, kc, vc = (a.to(torch.bfloat16) for a in _nan_past(*pools, ok))
    cu = [0] + [int(c) for c in np.cumsum(lens)]
    q = torch.randn((cu[-1] + 7, hq, D), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    index = (_i32(table), _i32(cu), _i32([h for _, h, _ in segs]),
             _i32(kvl))
    return q, (kn, vn), (kc, vc), index, cu[-1]


def phase_tma_kernel(seed, errs):
    """``ragged_prefill_paged`` on its TMA-fed core over TMA_CASES at
    qwen3-4b's 32 / 8 and qwen2.5-32b's 40 / 8 heads, causal and not:
    within the bound of the plain version, finite over NaN pools and the
    same bits as over pools with 0 there, two runs bit-identical, the
    same bits as the cp.async core (the ring form at NO_WINDOW), each
    launch counted in ``tma.launches``."""
    import functools
    from repro_torch.kernels import ragged_prefill as rp
    fn = rp.ragged_prefill_paged
    rng = np.random.default_rng(seed + 35)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 35)
    for case, (segs, share) in TMA_CASES.items():
        for hq, hkv in ((HQ, HKV), (40, HKV)):
            q, (kn, vn), (kc, vc), index, total = _tma_inputs(
                gen, rng, segs, share, hq, hkv)
            for causal in (True, False):
                c = dict(causal=causal)
                t0 = fn.tma.launches
                out = fn(q, kn, vn, *index, **c)
                again = fn(q, kn, vn, *index, **c)
                clean = fn(q, kc, vc, *index, **c)
                cp = fn(q, kn, vn, *index, window=NO_WINDOW, **c)
                torch.cuda.synchronize()
                err, worst, ok, _ = _held(
                    out, functools.partial(rp.ragged_prefill_paged_plain,
                                           **c), q, kc, vc, *index)
                same = (torch.equal(out, again), torch.equal(out, clean),
                        torch.equal(out, cp))
                ok = (ok and all(same) and bool(torch.isfinite(out).all())
                      and bool((out[total:] == 0).all())
                      and fn.tma.launches == t0 + 3)
                errs.setdefault(("ragged_prefill_paged", torch.bfloat16),
                                []).append(err)
                log(f"[2] ragged_prefill_paged tma {case:6s} {hq}/{hkv} "
                    f"{'causal' if causal else 'non-causal'}: max_abs_err="
                    f"{err:.3e} err/bound={worst:.3f} bit-identical twice "
                    f"{same[0]}, NaN = zero pools {same[1]}, = cp.async "
                    f"core {same[2]} {'ok' if ok else 'FAIL'}")
                assert ok, f"ragged_prefill_paged tma {case} {hq}/{hkv}"


def phase_grad_check(seed):
    """The nine dispatchers of ``kernels.ops`` on the card, each at small
    qwen3-4b-headed shapes.  ``mha`` and ``ssd_grouped`` differentiate:
    under grad mode, with their tensor inputs requiring grad, ``mha``
    launches ``flash_attn`` with its log-sum-exp and the backward
    ``flash_attn_bwd`` once, ``ssd_grouped`` launches ``ssd_scan``'s
    training form and the backward ``ssd_scan_bwd`` once, and every
    input gets a finite grad.  The other seven, the serving kernels,
    raise before launching (no backward kernel, as the Pallas kernels
    define no VJP).  Under ``no_grad`` each call launches its kernel
    once."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 90)

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device=DEVICE).to(torch.bfloat16)

    kv4, slots, pool = rand(1, 16, HKV, D), rand(2, 16, HKV, D), \
        rand(4, PS, HKV, D)
    seg = (_i32([0, 8]), _i32([4]), _i32([12]))
    table, slot, lens = _i32([[0, 1]]), _i32([1]), _i32([12])
    host, _ = _sample_batch(np.random.default_rng(seed + 90), 2, 128)
    x, dt, a, bm, cm, h0 = _ssd_inputs(gen, 1, 64, 1, torch.bfloat16)
    q8 = rand(1, 8, HQ, D)
    cases = (
        ("mha", "flash_attn", q8, None),
        ("ragged_mha", "ragged_prefill_attn", rand(8, HQ, D),
         lambda q: ops.ragged_mha(q, slots[:1], slots[:1], *seg)),
        ("ragged_mha_arena", "ragged_prefill_arena", rand(8, HQ, D),
         lambda q: ops.ragged_mha_arena(q, slots, slots, slot, *seg)),
        ("ragged_mha_paged", "ragged_prefill_paged", rand(8, HQ, D),
         lambda q: ops.ragged_mha_paged(q, pool, pool, table, *seg)),
        ("decode", "decode_attn", rand(1, HQ, D),
         lambda q: ops.decode(q, kv4, kv4, lens)),
        ("decode_arena", "decode_attn_arena", rand(1, HQ, D),
         lambda q: ops.decode_arena(q, slots, slots, slot, lens)),
        ("decode_paged", "decode_attn_paged", rand(1, HQ, D),
         lambda q: ops.decode_paged(q, pool, pool, table, lens)),
        ("fused_sample", "fused_sample",
         torch.as_tensor(host[0], device=DEVICE),
         lambda lg: ops.fused_sample(lg, *host[1:8])),
        ("ssd_grouped", "ssd_scan", x, None))
    launchers = _launchers()
    # the two dispatchers with a backward: their differentiable inputs,
    # the call, and the forward, training-form and backward counters
    routed = {
        "mha": ((q8, kv4, kv4),
                lambda *t: ops.mha(*t).float().square().sum(),
                ("flash_attn", "flash_attn@lse", "flash_attn_bwd")),
        "ssd_grouped": ((x, dt, bm, cm, h0),
                        lambda xx, d, b_, c_, h: sum(
                            o.float().square().sum() for o in
                            ops.ssd_grouped(xx, d, a, b_, c_, h)),
                        ("ssd_scan", "ssd_scan@states", "ssd_scan_bwd"))}
    for fn_name, kernel, base, call in cases:
        counter = launchers[kernel]
        if fn_name in routed:
            inputs, loss, names = routed[fn_name]
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            n0 = [launchers[n].launches for n in names]
            with torch.enable_grad():
                loss(*leaves).backward()
            torch.cuda.synchronize()
            n1 = [launchers[n].launches for n in names]
            with torch.no_grad():
                loss(*leaves)
            torch.cuda.synchronize()
            n2 = [launchers[n].launches for n in names]
            grads = all(x.grad is not None and bool(torch.isfinite(
                x.grad).all()) for x in leaves)
            ok = (grads and [b - a for a, b in zip(n0, n1)] == [1, 1, 1]
                  and [b - a for a, b in zip(n1, n2)] == [1, 0, 0])
            log(f"[2] grad check {fn_name:16s} -> {kernel}: differentiates "
                f"under grad mode (every input's grad finite {grads}; "
                f"launches "
                f"{dict(zip(names, (b - a for a, b in zip(n0, n1))))}), ran "
                f"under no_grad (launches "
                f"{dict(zip(names, (b - a for a, b in zip(n1, n2))))}) "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"grad check {fn_name}"
            continue
        n0 = counter.launches
        leaf = base.detach().float().to(base.dtype).requires_grad_()
        with torch.enable_grad():
            try:
                call(leaf)
            except RuntimeError as err:
                refused = "no backward kernel" in str(err)
            else:
                refused = False
        n1 = counter.launches
        with torch.no_grad():
            call(leaf)
        torch.cuda.synchronize()
        ok = refused and n1 == n0 and counter.launches == n0 + 1
        log(f"[2] grad check {fn_name:16s} -> {kernel}: refused under grad "
            f"mode {refused} (launches {n1 - n0}), ran under no_grad "
            f"(launches {counter.launches - n1}) {'ok' if ok else 'FAIL'}")
        assert ok, f"grad check {fn_name}"


# the decode kernels' split walk at every GQA group of TILE_HEADS: rows
# on the plan's chunk boundaries (C - 1, C, C + 1 and 2C keys at the
# chunk C the launcher plans for these shapes), the capacity, one long
# row beside short ones, a row of length 0 and a decode-ladder pad row
# (length 1 on a live row's storage); NaN in every page, arena and cache
# row past a length, the arena's park row included, and table entries
# past a length poisoned
DECODE_CAP = 2100          # arena S_max and cache S: not a chunk multiple
DECODE_PAGES = 132         # page-table width: 2112 keys


def _decode_lengths(chunk, cap):
    return [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, cap, cap - 5,
            96, 256, 17]


def phase_decode_groups(seed, errs):
    """``decode_attn_paged``, ``decode_attn_arena`` and ``decode_attn``
    against their plain versions at each of TILE_HEADS and WIDTH_HEADS,
    fp32 and bf16, over the split walk's chunk boundaries
    (``_decode_lengths``); every plan splits the walk (n_chunks > 1), so
    the combine runs at each width's D / 4 lanes."""
    from repro_torch.kernels import decode_attn as dec
    rng = np.random.default_rng(seed + 50)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 50)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_pages = 512
    for dtype in (torch.float32, torch.bfloat16):
        for d, hq, hkv in _groups():
            def rand(*shape):
                return torch.randn(shape, generator=gen, device=DEVICE)
            cases = []
            # paged: pad row on row 1's first page
            cap = DECODE_PAGES * PS
            plan = dec.split_plan(12, hq, hkv, d, cap, n_sms)
            lens = _decode_lengths(plan.chunk, cap)
            tab, tab_c = _layout(rng, n_pages, DECODE_PAGES, lens + [0])
            tab[-1, 0] = tab_c[-1, 0] = tab[1, 0]
            lens = lens + [1]
            page_ok = torch.zeros((n_pages, PS), dtype=torch.bool,
                                  device=DEVICE)
            for i, n in enumerate(lens):
                for p in range(0, n, PS):
                    page_ok[int(tab[i, p // PS]), :min(PS, n - p)] = True
            kp, vp, kc, vc = (a.to(dtype) for a in _nan_past(
                rand(n_pages, PS, hkv, d), rand(n_pages, PS, hkv, d),
                page_ok))
            cases.append(("decode_attn_paged", plan, lens,
                          dec.decode_attn_paged, dec.decode_attn_paged_plain,
                          (kp, vp, _i32(tab)), (kc, vc, _i32(tab_c))))
            # arena: every row from each length on NaN, the park row
            # S_max - 1 too; the pad row on row 1's slot
            plan = dec.split_plan(12, hq, hkv, d, DECODE_CAP, n_sms)
            lens = _decode_lengths(plan.chunk, DECODE_CAP - 1)
            slots = [int(x) for x in rng.permutation(len(lens))]
            slot_ok = torch.zeros((len(lens), DECODE_CAP), dtype=torch.bool,
                                  device=DEVICE)
            for slot, n in zip(slots, lens):
                slot_ok[slot, :n] = True
            slots, lens = slots + [slots[1]], lens + [1]
            ka, va, kc, vc = (a.to(dtype) for a in _nan_past(
                rand(len(slots) - 1, DECODE_CAP, hkv, d),
                rand(len(slots) - 1, DECODE_CAP, hkv, d), slot_ok))
            cases.append(("decode_attn_arena", plan, lens,
                          dec.decode_attn_arena, dec.decode_attn_arena_plain,
                          (ka, va, _i32(slots)), (kc, vc, _i32(slots))))
            # batch cache: row b reads cache row b
            plan = dec.split_plan(12, hq, hkv, d, DECODE_CAP, n_sms)
            lens = _decode_lengths(plan.chunk, DECODE_CAP) + [1]
            row_ok = torch.arange(DECODE_CAP, device=DEVICE)[None, :] \
                < _i32(lens)[:, None]
            kb, vb, kc, vc = (a.to(dtype) for a in _nan_past(
                rand(len(lens), DECODE_CAP, hkv, d),
                rand(len(lens), DECODE_CAP, hkv, d), row_ok))
            cases.append(("decode_attn", plan, lens, dec.decode_attn,
                          dec.decode_attn_plain, (kb, vb), (kc, vc)))
            for name, plan, lens, fn, plain, args, plain_args in cases:
                assert plan.n_chunks > 1, (name, d, plan)
                q = torch.randn((len(lens), hq, d), generator=gen,
                                device=DEVICE).to(dtype)
                out = fn(q, *args, _i32(lens))
                torch.cuda.synchronize()
                err, worst, ok, _ = _held(out, plain, q, *plain_args,
                                          _i32(lens))
                zeros = bool((out[0] == 0).all().item())
                finite = bool(torch.isfinite(out).all().item())
                ok = ok and zeros and finite
                errs.setdefault((_row(name, d), dtype), []).append(err)
                log(f"[2] {name:17s} split {hq}/{hkv} D={d} "
                    f"{str(dtype):15s} chunk {plan.chunk} x {plan.n_chunks} "
                    f"lengths {lens} max_abs_err={err:.3e} "
                    f"err/bound={worst:.3f} zero_row_zero={zeros} "
                    f"finite={finite} {'ok' if ok else 'FAIL'}")
                assert ok, f"{name} split {hq}/{hkv} D={d} {dtype}"


# the dense kernels' GQA groups: hubert-xlarge's 16 / 16 (rep 1),
# qwen3-4b's 32 / 8 (rep 4), qwen2.5-32b's 40 / 8 (rep 5, 3 idle
# vectors a 128-vector tile) and 64 / 8 (rep 8, the widest group)
DENSE_HEADS = ((16, 16), (32, 8), (40, 8), (64, 8))
FLASH_DIMS = (64, 80, 96, 128)
FLASH_CASES = {
    # B, Lq, S, q_offsets, kv_lengths, causal, window
    "causal_offsets": (3, 77, 300, [0, 100, 223], [77, 177, 300], True,
                       None),
    "noncausal": (3, 150, 150, [0, 0, 0], [150, 61, 0], False, None),
    "window": (2, 77, 300, [10, 200], [87, 277], True, 48),
    # dummy depth rows: queries from the park position S - 1 on, past S
    "park_rows": (3, 16, 200, [199, 199, 30], [200, 200, 0], True, None),
}
DENSE_DECODE_LENGTHS = [0, 1, 17, 255, 256, 100]   # over S = 256


def _batch_kv(gen, b, s, hkv, d, kv_lengths, dtype):
    """(B, S, hkv, d) K/V batch caches of random rows whose rows at and
    past each row's kv length hold POISON_KV."""
    k = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    v = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    for i, n in enumerate(kv_lengths):
        k[i, n:] = POISON_KV
        v[i, n:] = POISON_KV
    return k.to(dtype), v.to(dtype)


def phase_dense_kernels(seed, errs):
    """``flash_attn`` and ``decode_attn`` (the dense grid's and the dense
    decode's kernels) against their plain versions: flash at D 64, 80,
    96 and 128 and decode at 128, each at the GQA groups of
    DENSE_HEADS; causal with offsets, non-causal with kv lengths, a
    window, dummy rows parked at S - 1, rows of length 0, every row at
    and past each length poisoned."""
    import functools
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import flash_attn as fl
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 30)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in FLASH_DIMS:
            for hq, hkv in DENSE_HEADS:
                for name, (b, lq, s, offs, kvl, causal, window) in \
                        FLASH_CASES.items():
                    k, v = _batch_kv(gen, b, s, hkv, d, kvl, dtype)
                    q = torch.randn((b, lq, hq, d), generator=gen,
                                    device=DEVICE).to(dtype)
                    args = (q, k, v, _i32(offs), _i32(kvl))
                    out = fl.flash_attn(*args, causal=causal, window=window)
                    torch.cuda.synchronize()
                    plain = functools.partial(fl.flash_attn_plain,
                                              causal=causal, window=window)
                    err, worst, ok, ref = _held(out, plain, *args)
                    keyless = ref.abs().amax(dim=(2, 3)) == 0
                    zeros = bool((out[keyless] == 0).all().item())
                    ok = ok and zeros and bool(torch.isfinite(out).all())
                    errs.setdefault(("flash_attn", dtype), []).append(err)
                    n += 1
                    if not ok or name == "causal_offsets":
                        log(f"[2] flash_attn D={d} {hq}/{hkv} {name:15s} "
                            f"{str(dtype):15s} max_abs_err={err:.3e} "
                            f"err/bound={worst:.3f} keyless rows "
                            f"{int(keyless.sum())} zero={zeros} "
                            f"{'ok' if ok else 'FAIL'}")
                    assert ok, f"flash_attn D={d} {hq}/{hkv} {name} {dtype}"
        for hq, hkv in DENSE_HEADS:
            lengths = DENSE_DECODE_LENGTHS
            k, v = _batch_kv(gen, len(lengths), 256, hkv, D, lengths, dtype)
            q = torch.randn((len(lengths), hq, D), generator=gen,
                            device=DEVICE).to(dtype)
            out = dec.decode_attn(q, k, v, _i32(lengths))
            torch.cuda.synchronize()
            err, worst, ok, _ = _held(out, dec.decode_attn_plain, q, k, v,
                                      _i32(lengths))
            zero_rows = [i for i, x in enumerate(lengths) if x == 0]
            zeros = bool((out[zero_rows] == 0).all().item())
            ok = ok and zeros and bool(torch.isfinite(out).all())
            errs.setdefault(("decode_attn", dtype), []).append(err)
            log(f"[2] decode_attn {hq}/{hkv} lengths {lengths} "
                f"{str(dtype):15s} max_abs_err={err:.3e} "
                f"err/bound={worst:.3f} zero_rows_zero={zeros} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"decode_attn {hq}/{hkv} {dtype}"
    log(f"[2] ok: flash_attn == plain on {n} cases (fp32 max_abs_err "
        f"{max(errs[('flash_attn', torch.float32)]):.3e}, bf16 "
        f"{max(errs[('flash_attn', torch.bfloat16)]):.3e})")


def phase_decode_lse(seed, errs):
    """The dense decode kernel's lse (``decode_attn(..., return_lse=True)``,
    the partial a sequence-sharded cache's shards merge) at the decode
    shapes of ``phase_dense_kernels`` (S = 256 at ``DENSE_HEADS``,
    ``DENSE_DECODE_LENGTHS``: a keyless row and uneven rows), fp32 and
    bf16: the output as the launch without lse (bit for bit), the lse
    within 1e-4 (natural-log units; the scores' fp32 sums in another
    order) of ``ref_flash_attn_lse`` on the same inputs, -inf on the
    keyless row.  Then the keys split in two parts on this one card,
    [0, 192) and [192, 256), each part's output and lse from the kernel,
    merged by ``distributed.local.merge_partials`` (``_combine``'s
    arithmetic): the merged output within the decode bound
    (``ref.kernel_error_bound``) of the plain version over all keys, its
    lse within 1e-4 of one call's.  The 64-key part plans one chunk (the
    split kernel writes the lse, -inf on its keyless rows) where the
    others plan several (the combine kernel writes it)."""
    from repro_torch.distributed.local import merge_partials
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels.ref import ref_flash_attn_lse
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 31)
    lengths = DENSE_DECODE_LENGTHS
    s, cut = 256, 192
    lens = _i32(lengths)
    worst_lse = worst_merge = 0.0
    chunks = set()
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in DENSE_HEADS:
            k, v = _batch_kv(gen, len(lengths), s, hkv, D, lengths, dtype)
            q = torch.randn((len(lengths), hq, D), generator=gen,
                            device=DEVICE).to(dtype)
            out, lse = dec.decode_attn(q, k, v, lens, return_lse=True)
            same = torch.equal(out, dec.decode_attn(q, k, v, lens))
            ll = lens.long()
            want = ref_flash_attn_lse(
                q[:, None].float(), torch.nan_to_num(k.float()), ll - 1,
                ll)[..., 0]
            keyless = ll == 0
            real = ~keyless[:, None].expand_as(lse)
            e_lse = float((lse - want)[real].abs().max())
            neginf = bool(torch.isneginf(lse[keyless]).all())
            parts = []
            for lo, hi in ((0, cut), (cut, s)):
                hl = _i32((ll - lo).clamp(0, hi - lo).cpu().numpy())
                parts.append(dec.decode_attn(
                    q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(),
                    hl, return_lse=True))
            m_out, m_lse = merge_partials(
                torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))
            torch.cuda.synchronize()
            err, worst, ok, _ = _held(m_out, dec.decode_attn_plain, q, k, v,
                                      lens)
            e_mlse = float((m_lse - lse)[real].abs().max())
            ok = ok and same and neginf and e_lse <= 1e-4 \
                and e_mlse <= 1e-4 and not m_out[keyless].any()
            for span in (s, cut, s - cut):
                chunks.add(dec.split_plan(len(lengths), hq, hkv, D, span,
                                          dec._sm_count(0)).n_chunks)
            errs.setdefault(("decode_attn@lse", dtype), []).append(e_lse)
            worst_lse = max(worst_lse, e_lse)
            worst_merge = max(worst_merge, worst)
            log(f"[2] decode_attn lse {hq}/{hkv} {str(dtype)[6:]}: lse "
                f"max_abs_err={e_lse:.2e}, keyless -inf {neginf}, output as"
                f" without lse {same}; two parts merged: err/bound="
                f"{worst:.3f}, lse err {e_mlse:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"decode_attn lse {hq}/{hkv} {dtype}"
    assert chunks >= {1} and max(chunks) > 1, chunks
    log(f"[2] ok: decode_attn's lse within {worst_lse:.2e} of "
        f"ref_flash_attn_lse, the two-part merge within its bound "
        f"(worst err/bound {worst_merge:.3f}); n_chunks taken "
        f"{sorted(chunks)}")


# ------------------------------------------------------------ phase 2:
# the windowed forms (ring page tables, rolling slots)

# window: (margin C_l, prefill lens, their histories, decode lengths).
# mixtral-8x7b's window and chunk: a ring of ceil((4096 + 256) / 16) =
# 272 pages and rolling slots of 4352 rows; a stream with a 256-row
# chunk before the window (kv 3000), a verify-sized segment ending at
# the depth (4352), a decode row (6000), a chunk far past it (12000)
# and a fresh 30-row prompt; decode rows before, at and past the window
# and the depth.  A small odd window (100, C_l 16: an 8-page ring of 128
# positions, slots of 116 rows) for the wrap edges: kv inside the window
# with a partly valid last page, rows straddling the ring's wrap at 128,
# two rolling depths (232), two ring depths (256), a segment longer than
# the margin, and decode rows of 0, 1, 50, 100, 101, 116, 128, 232, 256
# and 1000 keys.
WINDOW_CASES = {
    4096: (256, [256, 5, 1, 256, 30], [2744, 4347, 5999, 11744, 0],
           [3000, 4352, 6000, 12000, 0, 1, 4096, 4097]),
    100: (16, [16, 5, 1, 16, 10, 30], [84, 123, 231, 240, 3, 150],
          [0, 1, 50, 100, 101, 116, 128, 232, 256, 1000]),
}
WINDOW_PADS, WINDOW_TAIL = 2, 9


def _window_storage(gen, rng, layout, depth, kv_lens, dtype, hkv=HKV,
                    d=D):
    """K/V holding each row's newest positions in ``layout``: a ring of
    ceil(depth / PS) pages a row (a page table (B, n_ring); entries past
    a ring's allocated pages and pad rows name a spare page) or rolling
    slots of ``depth`` rows (a slot map; pads name a spare slot).  Every
    row no segment holds is NaN in the kernel's copy and 1000 in the
    plain version's.  Returns (kernel K, V, plain K, V, index)."""
    b = len(kv_lens)
    if layout == "ring":
        n_ring = -(-depth // PS)
        n_pages = b * n_ring + 1
        table = np.full((b, n_ring), n_pages - 1, np.int64)
        free = list(rng.permutation(n_pages - 1))
        for i, n in enumerate(kv_lens):
            need = min(-(-n // PS), n_ring)
            table[i, :need] = [free.pop() for _ in range(need)]
        rows = (table[:, :, None] * PS + np.arange(PS)).reshape(b, -1)
        shape, index = (n_pages, PS, hkv, d), table
    else:
        slots = rng.permutation(b + 1)[:b]
        rows = slots[:, None] * depth + np.arange(depth)
        shape, index = (b + 1, depth, hkv, d), slots
    held = np.zeros(shape[0] * shape[1], bool)
    for i, n in enumerate(kv_lens):
        held[rows[i, :min(n, rows.shape[1])]] = True
    unheld = torch.as_tensor(~held, device=DEVICE).reshape(shape[:2])
    k = torch.randn(shape, generator=gen, device=DEVICE)
    v = torch.randn(shape, generator=gen, device=DEVICE)
    kp, vp = k.clone(), v.clone()
    kp[unheld], vp[unheld] = float("nan"), float("nan")
    k[unheld], v[unheld] = 1000.0, 1000.0
    return (kp.to(dtype), vp.to(dtype), k.to(dtype), v.to(dtype),
            _i32(index))


def _window_stream(window, dtype, gen, rng, layout, hq=HQ, hkv=HKV, d=D):
    """Phase 2's windowed prefill stream for ``window``: (kernel args,
    plain args) of the paged or arena kernel, pad segments (kv 0) and
    tail rows included."""
    margin, lens, hists, _ = WINDOW_CASES[window]
    kvl = [h + n for h, n in zip(hists, lens)] + [0] * WINDOW_PADS
    cu = [0] + list(np.cumsum(lens)) + [sum(lens)] * WINDOW_PADS
    offs = hists + [0] * WINDOW_PADS
    kp, vp, k, v, index = _window_storage(gen, rng, layout, window + margin,
                                          kvl, dtype, hkv, d)
    q = torch.randn((sum(lens) + WINDOW_TAIL, hq, d), generator=gen,
                    device=DEVICE).to(dtype)
    seg = (_i32(cu), _i32(offs), _i32(kvl))
    return (q, kp, vp, index) + seg, (q, k, v, index) + seg


def _window_kernels(layout, window):
    """(prefill launcher, its plain version, decode launcher, its plain
    version) of ``layout``, each bound to ``window``."""
    import functools
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import ragged_prefill as rp
    pre, dcd = (("ragged_prefill_paged", "decode_attn_paged")
                if layout == "ring" else
                ("ragged_prefill_arena", "decode_attn_arena"))
    return tuple(functools.partial(f, window=window) for f in (
        getattr(rp, pre), getattr(rp, pre + "_plain"), getattr(dec, dcd),
        getattr(dec, dcd + "_plain"))), (pre, dcd)


# the windowed forms at the served MHA widths: the small odd window's
# wrap edges at stablelm's and phi-3's 32 / 32 heads; as (window, D, Hq,
# Hkv)
WINDOW_WIDTH_CASES = ((100, 64, 32, 32), (100, 96, 32, 32))


def phase_window_kernels(seed, errs):
    """The four windowed forms against their plain versions at
    mixtral-8x7b's heads (32 / 8, D 128), fp32 and bf16: the paged
    kernels over ring page tables, the arena kernels over rolling slots,
    at mixtral's window and at a small odd one (WINDOW_CASES), then the
    small one at D 64 and 96 (WINDOW_WIDTH_CASES); every row no segment
    holds NaN, so a read outside a segment's held range faults the
    comparison."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 40)
    rng = np.random.default_rng(seed + 40)
    cases = [(w, D, HQ, HKV) for w in WINDOW_CASES] + list(WINDOW_WIDTH_CASES)
    for window, d, hq, hkv in cases:
        margin, lens, hists, dlens = WINDOW_CASES[window]
        for layout in ("ring", "rolling"):
            (pf, pplain, df, dplain), (pre, dcd) = _window_kernels(
                layout, window)
            for dtype in (torch.float32, torch.bfloat16):
                args, pargs = _window_stream(window, dtype, gen, rng, layout,
                                             hq, hkv, d)
                out = pf(*args)
                torch.cuda.synchronize()
                err, worst, ok, _ = _held(out, pplain, *pargs)
                tail = bool((out[sum(lens):] == 0).all().item())
                ok = ok and tail and bool(torch.isfinite(out).all())
                errs.setdefault((pre + "@window" if d == D else
                                 _row(pre, d), dtype), []).append(err)
                log(f"[2] {pre} window {window} ({layout}, depth "
                    f"{window + margin}) {hq}/{hkv} D={d} "
                    f"{str(dtype):15s} kv "
                    f"{[h + n for h, n in zip(hists, lens)]}: max_abs_err="
                    f"{err:.3e} err/bound={worst:.3f} tail_zero={tail} "
                    f"{'ok' if ok else 'FAIL'}")
                assert ok, f"{pre} window {window} D={d} {dtype}"
                kp, vp, k, v, index = _window_storage(
                    gen, rng, layout, window + margin, dlens, dtype, hkv, d)
                q = torch.randn((len(dlens), hq, d), generator=gen,
                                device=DEVICE).to(dtype)
                out = df(q, kp, vp, index, _i32(dlens))
                torch.cuda.synchronize()
                err, worst, ok, _ = _held(out, dplain, q, k, v, index,
                                          _i32(dlens))
                zero = bool((out[[i for i, n in enumerate(dlens)
                                  if n == 0]] == 0).all().item())
                ok = ok and zero and bool(torch.isfinite(out).all())
                errs.setdefault((dcd + "@window" if d == D else
                                 _row(dcd, d), dtype), []).append(err)
                log(f"[2] {dcd} window {window} ({layout}) {hq}/{hkv} "
                    f"D={d} {str(dtype):15s} lengths {dlens}: max_abs_err="
                    f"{err:.3e} err/bound={worst:.3f} zero_rows_zero={zero} "
                    f"{'ok' if ok else 'FAIL'}")
                assert ok, f"{dcd} window {window} D={d} {dtype}"
    log("[2] ok: the four windowed forms == plain at windows "
        f"{sorted(WINDOW_CASES)}, and window 100 at D 64 and 96")


SAMPLE_MARGIN = 1e-5   # a draw may move only where u is this close to a
#                        non-zero cumulative mass of the plain version


def _sample_batch(rng, r, v):
    """Host inputs of one fused_sample batch of ``r`` rows over ``v``
    columns whose first rows are the kernel's trouble spots, the rest
    random: (logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft,
    row names)."""
    from repro_torch.kernels.sampling import MAX_BIAS
    logits = rng.normal(0.0, 3.0, (r, v)).astype(np.float32)
    temp = np.zeros(r, np.float32)
    top_k = np.zeros(r, np.int32)
    top_p = np.ones(r, np.float32)
    bids = np.full((r, MAX_BIAS), -1, np.int32)
    bvals = np.zeros((r, MAX_BIAS), np.float32)
    u = rng.random(r).astype(np.float32)
    draft = rng.integers(0, v, r).astype(np.int32)
    names = []

    def kth_negative(i):
        logits[i] = -np.abs(logits[i]) - 1.0
        temp[i], top_k[i] = 1.0, max(v // 3, 2)

    def kth_negative_side(i):
        logits[i, : v // 2] = -np.abs(logits[i, : v // 2]) - 0.5
        logits[i, v // 2:] = np.abs(logits[i, v // 2:]) + 0.5
        temp[i], top_k[i] = 0.6, v // 2 + 7

    def signed_zeros(i):
        logits[i, :6] = [3.0, 2.5, 2.0, 0.0, 0.0, 0.0]
        logits[i, 6:9] = -0.0
        logits[i, 9:] = -np.abs(logits[i, 9:]) - 1.0
        temp[i], top_k[i] = 1.0, 5

    def ties_at_kth(i):
        logits[i] = np.round(logits[i] / 2.0)
        temp[i], top_k[i] = 1.0, 10

    def padded_vocab(i):
        logits[i, v - min(64, v // 4):] = -1e9
        temp[i], top_k[i] = 0.9, 40

    def bias_all_slots(i):
        temp[i], top_k[i] = 0.7, 12
        bids[i] = [5, 5, v + 3, 1, 2, 3, 4, 6]        # repeat, past V
        bvals[i] = [2.0, 2.5, 9.0, 0.5, 0.5, 0.5, 0.5, 0.5]

    def greedy_tie(i):
        logits[i, [17, 4, 60]] = 20.0
        draft[i] = 4

    def biased_greedy(i):
        bids[i, :3] = [9, 9, v]
        bvals[i, :3] = [4.0, 4.0, 50.0]

    def set_(t=0.0, k=0, p=1.0, uu=None, d=None):
        def f(i):
            temp[i], top_k[i], top_p[i] = t, k, p
            if uu is not None:
                u[i] = uu
            if d is not None:
                draft[i] = d
        return f

    spots = [
        ("greedy_tie", greedy_tie), ("biased_greedy", biased_greedy),
        ("padded_vocab", padded_vocab), ("kth_negative", kth_negative),
        ("kth_negative_side", kth_negative_side),
        ("top_k_off", set_(1.1, v + 5)), ("top_k_1", set_(1.1, 1)),
        ("ties_at_kth", ties_at_kth), ("signed_zeros", signed_zeros),
        ("top_p_near_1", set_(1.0, 0, 0.999999)),
        ("top_p_tiny", set_(1.2, 0, 1e-6)), ("u_zero", set_(1.0, 8, 1.0, 0.0)),
        ("u_below_1", set_(2.0, 0, 1.0, np.float32(1.0 - 2.0 ** -24))),
        ("bias_all_slots", bias_all_slots),
        ("draft_minus_1", set_(0.8, 20, 0.95, None, -1)),
        ("case_top_k_top_p", set_(0.8, 24, 0.85)),
    ]
    for i in range(r):
        if i < len(spots):
            names.append(spots[i][0])
            spots[i][1](i)
        else:
            t, k, p = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 16, 1.0),
                       (1.3, 0, 0.9), (0.8, 24, 0.85)][i % 5]
            temp[i], top_k[i], top_p[i] = t, k, p
            names.append(f"random_{t}_{k}_{p}")
    return (logits, temp, top_k, top_p, bids, bvals, u, draft), names


def _held_draws(args, got):
    """Hold fused_sample's outputs ``got`` to its plain version on the
    same inputs: greedy tokens exact; token and alt equal except on rows
    whose u lies within SAMPLE_MARGIN of a non-zero cumulative mass of
    the plain version; p_draft within 1e-5.  Returns (p_draft max abs
    error, rows let through by the margin, ok)."""
    from repro_torch.kernels import sampling as ks
    want = [x.cpu().numpy() for x in ks.fused_sample_plain(*args)]
    got = [x.cpu().numpy() for x in got]
    margin = ks.cdf_margin(*args).cpu().numpy()
    greedy = torch.as_tensor(args[1]).cpu().numpy() <= 0
    ok = bool((got[0][greedy] == want[0][greedy]).all())
    moved = set()
    for k in (0, 2):
        for i in np.nonzero(got[k] != want[k])[0]:
            moved.add(int(i))
            ok = ok and bool(margin[i] < SAMPLE_MARGIN)
    err = float(np.abs(got[1] - want[1]).max())
    return err, sorted(moved), ok and err <= 1e-5


def _paths(logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft):
    """Per row, the path ``fused_sample`` takes, predicted from the
    inputs by the plain version's arithmetic (the kernel reports none):
    ``greedy``; ``compact_warp`` / ``compact`` when top-k keeps at most
    ``CAPACITY`` columns and the scaled max is above the mask value (at
    most 32: one warp of the leader draws); else ``whole_row``."""
    from repro_torch.kernels import sampling as ks
    temp, top_k, top_p, bias_ids, bias_vals, u, draft = ks._as_inputs(
        logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft)
    x, _ = ks.filtered_probs_plain(logits, temp, top_k, top_p, bias_ids,
                                   bias_vals)
    scaled = x / torch.clamp(temp, min=1e-6)[:, None]
    kept = ks._topk_keep(scaled, top_k).sum(-1).tolist()
    do_k = ((top_k > 0) & (top_k < x.shape[-1])).tolist()
    above = (scaled.max(-1).values > ks.NEG).tolist()
    return ["greedy" if t <= 0 else
            ("compact_warp" if n <= 32 else "compact")
            if k and n <= ks.CAPACITY and a else "whole_row"
            for t, k, n, a in zip(temp.tolist(), do_k, kept, above)]


def phase_sample_kernel(seed, errs):
    """fused_sample against its plain version: V = 151,936 (qwen3-4b's
    vocabulary), 152,064 (qwen2.5-32b's), 50,280 (mamba2-2.7b's),
    100,352 (stablelm-1.6b's), 32,256 (phi-3-vision's 32,064 padded to
    256 as ``padded_vocab`` pads it, the pad columns at -1e9 as the
    model's head writes them), 256,000 (minitron-8b's) and 128, R = 40
    (phase 4's verify tick: 8 stream rows x (k + 1)), 8 and 1, fp32 and
    bf16 logits, the first rows the kernel's trouble spots; each row's
    path (greedy, compact by a warp or a block, whole row), predicted
    from the inputs, is logged."""
    from repro_torch.kernels import sampling as ks
    rng = np.random.default_rng(seed + 20)
    for v, rows in ((151936, (40, 8, 1)), (152064, (40, 8)), (50280, (40, 8)),
                    (100352, (40, 8)), (32256, (40, 8)),
                    (256000, (40, 8, 1)), (128, (40, 1))):
        for r in rows:
            host, names = _sample_batch(rng, r, v)
            if v == 32256:                   # phi-3's pad columns
                host[0][:, 32064:] = -1e9
            for dtype in (torch.float32, torch.bfloat16):
                logits = torch.as_tensor(host[0], device=DEVICE).to(dtype)
                args = (logits,) + host[1:]
                got = ks.fused_sample(*args)
                torch.cuda.synchronize()
                err, moved, ok = _held_draws(args, got)
                errs.setdefault(("fused_sample", dtype), []).append(err)
                paths = _paths(*args)
                counts = {p: paths.count(p) for p in sorted(set(paths))}
                log(f"[2] fused_sample R={r:2d} V={v:6d} {str(dtype):15s} "
                    f"p_draft max_abs_err={err:.3e} (tol 1e-5) draws moved "
                    f"within {SAMPLE_MARGIN} of a CDF boundary: "
                    f"{len(moved)} {[names[i] for i in moved]} "
                    f"{'ok' if ok else 'FAIL'}; paths (predicted from "
                    f"the inputs) {counts}")
                if r == 40 and dtype == torch.bfloat16:
                    log(f"[2]   rows: "
                        f"{', '.join(f'{n}={p}' for n, p in zip(names, paths))}")
                assert ok, f"fused_sample R={r} V={v} {dtype}"


# mamba2-2.7b's SSD heads: 80 heads of 64, state 128, one group, chunk 128
SSD_NH, SSD_HD, SSD_DS, SSD_CHUNK = 80, 64, 128, 128
# jamba-v0.1-52b's SSD layout: 128 heads of the same widths, B/C in 8
# groups of 16 heads (the ``ssd_scan@grouped`` row)
JAMBA_NH, JAMBA_G = 128, 8
# the training shape of the SSD backward's checks and times: (B, L)
SSD_TRAIN = (4, 1024)
SSD_LENS = (1, 127, 128, 129, 300, 2048)
SSD_PAIRS = 9   # interleaved kernel / plain timings at the grid and bridge
# phase 5's packed mamba2 prefill: 7 prompts filling the 512-token bucket
SSM_PROFILE_LENS = (120, 64, 96, 80, 100, 40, 12)


def _ssd_inputs(gen, b, l, g, dtype, zero=None, lens=None, nh=SSD_NH):
    """SSD scan inputs at mamba2's head shapes (``nh`` heads: jamba's
    128 with ``nh=JAMBA_NH``), shaped as the mamba layer
    passes them: x, B and C are views into one (B, L, NH·HD + 2·G·DS)
    conv-output row; dt = softplus(N(0, 1)) with dt = 0 on the last 5
    rows (right padding) and on every 97th row, and 40 x dt (|a·dt| up to
    ~600, strong decay) on every 89th row from row 40; a =
    -linspace(1, 16, NH) (mamba2's A init); a random non-zero init
    state.  The conv row is N(0, 1/4) and the state N(0, 1/100), so y
    stays O(1)-O(10) as in the served model.  ``zero``: row ranges [r0,
    r1) where dt is 0 for every head; ``lens``: each batch row's length,
    dt = 0 past it (the packed step's bridge)."""
    import torch.nn.functional as F
    hd, ds = SSD_HD, SSD_DS
    xbc = 0.5 * torch.randn((b, l, nh * hd + 2 * g * ds), generator=gen,
                            device=DEVICE)
    xbc = xbc.to(dtype)
    x = xbc[..., :nh * hd].reshape(b, l, nh, hd)
    bm = xbc[..., nh * hd:nh * hd + g * ds].reshape(b, l, g, ds)
    cm = xbc[..., nh * hd + g * ds:].reshape(b, l, g, ds)
    dt = F.softplus(torch.randn((b, l, nh), generator=gen, device=DEVICE))
    rows = torch.arange(l, device=DEVICE)
    dt[:, rows % 89 == 40] *= 40.0
    dt[:, rows % 97 == 5] = 0.0
    if l > 10:
        dt[:, l - 5:] = 0.0
    for r0, r1 in zero or ():
        dt[:, r0:r1] = 0.0
    if lens is not None:
        dt[rows[None, :] >= torch.tensor(lens, device=DEVICE)[:, None]] = 0.0
    a = -torch.linspace(1.0, 16.0, nh, device=DEVICE)
    h0 = 0.1 * torch.randn((b, nh, hd, ds), generator=gen, device=DEVICE)
    return x, dt.contiguous(), a, bm, cm, h0


def _held_ssd(args, chunk=SSD_CHUNK):
    """Run ``ssd_scan`` once and hold y and the final state to the plain
    version in fp32 elementwise (``ref.ssd_error_bound``).  Returns (max
    abs error of y, the largest error / bound, ok)."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_error_bound
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    yr, yb, sr, sb = ssd_error_bound(*args, chunk)
    ey, es = (y.float() - yr).abs(), (st - sr).abs()
    worst = max(float((ey / yb).max()), float((es / sb).max()))
    finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    return float(ey.max()), worst, finite and worst <= 1.0


def phase_ssd_kernel(seed, errs):
    """``ssd_scan`` against its plain version at mamba2's head shapes (NH
    80, HD 64, DS 128, chunk 128), B/C in group form (G = 1) and per head
    (G = NH), L = 1, 127, 128, 129, 300 and 2048, B = 1 and 8, fp32 and
    bf16, with pad and strong-decay rows and a non-zero init state; then
    the chunks the kernel skips (dt = 0 for every head): a zero chunk
    first, between two and last, the bridge's rows of lengths 0, 1,
    Q - 1, Q, Q + 1 and 300, and a chunk with one non-zero dt."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 5)
    n, ratios = 0, {}
    for g in (1, SSD_NH):
        for b in (1, 8):
            for l in SSD_LENS:
                for dt in (torch.float32, torch.bfloat16):
                    err, worst, ok = _held_ssd(_ssd_inputs(gen, b, l, g, dt))
                    errs.setdefault(("ssd_scan", dt), []).append(err)
                    ratios.setdefault(dt, []).append(worst)
                    n += 1
                    log(f"[2] ssd_scan G={g} B={b} L={l} "
                        f"{str(dt)[6:]}: max_abs_err={err:.3e} "
                        f"err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
                    assert ok, f"ssd_scan G={g} B={b} L={l} {dt}"
    # chunks whose dt is 0 for every head, which the kernel skips: one
    # zero chunk first, between two real chunks and last; the packed
    # bridge's rows, dt = 0 past each row's length (0, 1, Q - 1, Q,
    # Q + 1, 300); a chunk whose only non-zero dt is one row (not skipped)
    q = SSD_CHUNK
    for g in (1, SSD_NH):
        for dt in (torch.float32, torch.bfloat16):
            cases = [(f"zero chunk {k} of 3", [(k * q, (k + 1) * q)], 1,
                      3 * q, None) for k in range(3)]
            cases.append(("bridge rows", None, 6, 300,
                          (0, 1, q - 1, q, q + 1, 300)))
            cases.append(("one non-zero dt", [(0, 200), (201, 256)], 1,
                          256, None))
            for what, zero, b, l, lens in cases:
                args = _ssd_inputs(gen, b, l, g, dt, zero=zero, lens=lens)
                err, worst, ok = _held_ssd(args)
                errs.setdefault(("ssd_scan", dt), []).append(err)
                ratios.setdefault(dt, []).append(worst)
                n += 1
                log(f"[2] ssd_scan {what} G={g} B={b} L={l} "
                    f"{str(dt)[6:]}: max_abs_err={err:.3e} "
                    f"err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
                assert ok, f"ssd_scan {what} G={g} {dt}"
    log(f"[2] ok: ssd_scan == plain on {n} cases (fp32 max_abs_err "
        f"{max(errs[('ssd_scan', torch.float32)]):.3e}, err/bound "
        f"{min(ratios[torch.float32]):.3f}-{max(ratios[torch.float32]):.3f};"
        f" bf16 max_abs_err {max(errs[('ssd_scan', torch.bfloat16)]):.3e}, "
        f"err/bound {min(ratios[torch.bfloat16]):.3f}-"
        f"{max(ratios[torch.bfloat16]):.3f})")
    # jamba's layout: 128 heads, B/C in 8 groups of 16 heads, so the
    # C.B^T pass runs 8 groups a chunk; the same lengths, batch rows and
    # dtypes, and the bridge's rows
    n, worst_g = 0, {}
    for b in (1, 8):
        for l in SSD_LENS:
            for dt in (torch.float32, torch.bfloat16):
                lens = None
                if l == 300 and b == 8:
                    lens = (0, 1, q - 1, q, q + 1, 300, 17, 250)
                args = _ssd_inputs(gen, b, l, JAMBA_G, dt, lens=lens,
                                   nh=JAMBA_NH)
                err, worst, ok = _held_ssd(args)
                errs.setdefault(("ssd_scan@grouped", dt), []).append(err)
                worst_g[dt] = max(worst_g.get(dt, 0.0), worst)
                n += 1
                log(f"[2] ssd_scan@grouped NH={JAMBA_NH} G={JAMBA_G} B={b} "
                    f"L={l}{' bridge rows' if lens else ''} "
                    f"{str(dt)[6:]}: max_abs_err={err:.3e} "
                    f"err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
                assert ok, f"ssd_scan G={JAMBA_G} B={b} L={l} {dt}"
    log(f"[2] ok: ssd_scan at jamba's layout (NH {JAMBA_NH}, G {JAMBA_G}, "
        f"16 heads a group) == plain on {n} cases (max_abs_err fp32 "
        f"{max(errs[('ssd_scan@grouped', torch.float32)]):.3e}, bf16 "
        f"{max(errs[('ssd_scan@grouped', torch.bfloat16)]):.3e}; worst "
        f"err/bound {worst_g[torch.float32]:.3f} / "
        f"{worst_g[torch.bfloat16]:.3f})")


# ------------------------------------------------------------ phase 3

# the engine configurations served: the launcher's default (the dense
# (L, B) grid with arena decode), the grid with the dense decode step,
# the two packed slot-arena forms and the paged default stack
MODES = {
    "slot_dense": dict(packed=False, paged_kv=False),
    # the dense grid and the dense decode step over copied-out slots
    "slot_dense_decode": dict(packed=False, paged_kv=False,
                              arena_decode=False),
    "slot_arena": dict(paged_kv=False),
    "slot_gathered": dict(paged_kv=False, arena_prefill=False),
    "paged": dict(),
}
# the kernels each mode's serving path must launch
# the SSM family (mamba2-2.7b) through the three arena layouts: the
# paged default (a state page per session, boundary-state checkpoints on
# the radix index), the slot arena with its scratch slot, and the
# launcher's dense (L, B) grid with arena decode
SSM_MODES = {
    "ssm_paged": dict(),
    "ssm_slot_arena": dict(paged_kv=False),
    "ssm_dense": dict(packed=False, paged_kv=False),
}
# the windowed MoE family (mixtral-8x7b) through the reference engine's
# three windowed layouts: ring page tables (the default), rolling slots
# of depth window + C_l, and the dense baseline's full-depth slots with
# the window masked (no decode executor: decode takes the dense step)
WINDOW_MODES = {
    "swa_paged": dict(),
    "swa_slot_arena": dict(paged_kv=False),
    "swa_dense": dict(packed=False, paged_kv=False),
}
# phase 3's window: mixtral's 4096 lowered so that a trace of a few
# hundred tokens a session wraps its ring and rolling slot several times
ORACLE_WINDOW = 128
# the MHA configs at the kernels' other widths, stablelm-1.6b (64) and
# phi-3-vision-4.2b (96), each in the three layouts: the page pool, the
# packed slot arena and the dense (L, B) grid with arena decode (phase
# 3); phase 4 serves them in all five attention modes
WIDTH_ARCHS = ("stablelm-1.6b", "phi-3-vision-4.2b")
WIDTH_ORACLE_MODES = ("paged", "slot_arena", "slot_dense")
MODE_KERNELS = {
    "slot_dense": ("flash_attn", "decode_attn_arena"),
    "slot_dense_decode": ("flash_attn", "decode_attn"),
    "slot_arena": ("ragged_prefill_arena", "decode_attn_arena"),
    "slot_gathered": ("ragged_prefill_attn", "decode_attn_arena"),
    "paged": ("ragged_prefill_paged", "decode_attn_paged"),
    "spec": ("ragged_prefill_paged", "fused_sample"),
    **{mode: ("ssd_scan",) for mode in SSM_MODES},
    # every attention launch of a windowed stack is a windowed form
    "swa_paged": ("ragged_prefill_paged@window", "decode_attn_paged@window"),
    "swa_slot_arena": ("ragged_prefill_arena@window",
                       "decode_attn_arena@window"),
    "swa_dense": ("flash_attn",),
}
# phase 4 serves one more mode: the paged engine with speculation armed
# (NGramDraft(n=3), k = SPEC_K) and fused sampling, half its sessions
# sampled.  Armed, every decode tick is a verify step on the packed
# stream (the reference routes no decode to the decode step then), so
# the mode launches ragged_prefill_paged and fused_sample, and
# decode_attn_paged only on a tick split for overflowing the ladder.
SERVE_MODES = {**MODES, "spec": dict(fused_sampling=True,
                                     keep_last_logits=False),
               **SSM_MODES, **WINDOW_MODES}
# phase 4's mamba2 page pool: every page of a pure-SSM pool carries one
# state slot of all 64 layers (~170 MB), token pages included, so the
# reference's default of num_slots * max_len / page_size = 2048 pages
# (~348 GB) cannot be held; 64-token pages and 160 pages (~27 GB) hold
# the trace beside the 5.7 GB of weights
SSM_POOL = dict(page_size=64, num_pages=192)
SPEC_K = 4
# phase 4's mixtral-8x7b: 16 of its 32 layers (43.7 GiB of bf16 weights;
# the 32 layers' 87.0 GiB exceed one 80 GB card) and a long prompt past
# its 4096-token window and 4352-row ring / rolling slot
WINDOW_LAYERS, WINDOW_PROMPT = 16, 6144
# the hybrid family (jamba-v0.1-52b: SSD, attention and MoE layers
# interleaved, period 8) and the last MoE config (qwen3-moe-30b-a3b: 128
# experts top 8, 32 / 4 heads).  Phase 4 serves jamba cut to 16 of its 32
# layers (2 of 4 pattern groups; the 32 layers' ~96 GiB of bf16 weights
# exceed the card) in the three SSM modes, its SSD layers' state beside
# its attention layers' KV, and qwen3-moe at full depth on the paged
# default
HYBRID, QWEN_MOE = "jamba-v0.1-52b", "qwen3-moe-30b-a3b"
HYBRID_LAYERS = 16
# a hybrid's SSM modes also run its attention layers, through the
# kernels of the attention mode with the same layout
HYBRID_ATTN_MODE = {"ssm_paged": "paged", "ssm_slot_arena": "slot_arena",
                    "ssm_dense": "slot_dense"}
# phase 3's cuts of the two: jamba one pattern group (8 layers), qwen3-moe
# 2 layers, both with 8 experts, so the engine's steps and the dense
# oracle take moe_dense_reference (every expert on every row) and must
# agree to ORACLE_MOE_TOL; with more than 8 every step takes the capacity
# dispatch, whose drops depend on each step's rows (phase_moe_check and
# phase_moe_graph check it apart)
ORACLE_CUTS = {HYBRID: dict(num_layers=8, num_experts=8),
               QWEN_MOE: dict(num_layers=2, num_experts=8)}
ORACLE_MOE_TOL = 1e-4


def _mode_kernels(cfg, mode):
    """The kernels ``mode``'s serving path must launch for ``cfg``: a
    hybrid stack's SSM modes add its attention layers' kernels and the
    SSD scan with B/C in several groups."""
    names = MODE_KERNELS[mode]
    if cfg.family == "hybrid":
        names += MODE_KERNELS[HYBRID_ATTN_MODE[mode]] + ("ssd_scan@grouped",)
    return names


def _launchers():
    """{kernel name: its launcher, whose ``launches`` counts launches}."""
    from repro_torch.kernels.ops import LAUNCHERS
    return LAUNCHERS


def _graphs_replayed(engine, what):
    """Every dispatch of ``engine``'s executors was a CUDA graph replay
    (a capture at each shape's first dispatch, a replay at every one);
    returns the engine's graph counts."""
    gs = engine.graph_stats()
    dispatches = sum(ex.dispatches for ex in engine.executors)
    assert gs["replays"] == dispatches, \
        f"{what}: {dispatches} dispatches, {gs['replays']} graph replays"
    assert all(g.graph is not None for ex in engine.executors
               for g in ex.graphs.values()), f"{what}: a step ran eagerly"
    return gs


def _warmup_launches(engine):
    """{kernel: launches} of the engine's graph warm-ups (one run on
    parked inputs before each capture)."""
    out = {}
    for ex in engine.executors:
        for name, n in ex.warmup_launches().items():
            out[name] = out.get(name, 0) + n
    return out


def _policy(engine, chunk_tokens, threshold):
    from repro_torch.core import H200_QWEN32B, Variant, make_policy
    from repro_torch.core.awd import AWDConfig
    awd = None
    if engine.packed_executor is not None:
        awd = AWDConfig(packed=True, token_buckets=engine.ecfg.token_buckets,
                        packed_max_seqs=engine.packed_executor.max_seqs)
    return make_policy(Variant("pla_full"), H200_QWEN32B,
                       threshold=threshold, chunk_tokens=chunk_tokens,
                       awd_cfg=awd)


def _to_cpu(tree):
    """A CPU copy of a parameter or cache tree: a forward over it takes
    the kernels' plain versions, never the kernels it is held against."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# phase 3's stack and its oracle's logits by cached ids, kept across the
# modes of one windowed or WIDTH_ARCHS config (whose transcripts agree)
_ORACLE = {}


def phase_oracle(seed, mode, arch=None):
    """The engine in ``mode`` against the plain dense forward over each
    session's cached ids, at full width cut to 2 layers, fp32: qwen3-4b
    in the attention modes, mamba2-2.7b in the SSM modes (whose oracle
    scans each whole sequence once from a zero state), mixtral-8x7b in
    the windowed modes, its window lowered to ORACLE_WINDOW and the
    chunked fifth session 600 tokens past the system prompt, so each
    session's ring or rolling slot wraps (the oracle masks the window
    over the whole sequence).  The oracle runs
    on a CPU copy of the parameters, so it takes the plain versions and
    passes through none of the kernels the engine launches.  ``arch``
    (one of WIDTH_ARCHS, or qwen3-moe-30b-a3b) serves that config in an
    attention mode instead of qwen3-4b, and ``arch=HYBRID`` serves
    jamba in an SSM mode instead of mamba2 (its attention layers through
    the attention mode's kernels); both cut by ORACLE_CUTS and held to
    ORACLE_MOE_TOL.  The SSM system prompt is 64 tokens, one C_l chunk
    and four pages: a chunked prompt's first commit lands on its end and
    checkpoints the state there, which later sessions adopt on the page
    pool, with a hybrid's KV pages."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.loop import ServeLoop
    ssm = mode in SSM_MODES
    swa = mode in WINDOW_MODES
    arch = arch or ("mamba2-2.7b" if ssm else "mixtral-8x7b" if swa
                    else "qwen3-4b")
    memo = swa or arch in WIDTH_ARCHS or arch in ORACLE_CUTS
    cfg = get_config(arch).replace(**{"num_layers": 2, "dtype": "float32",
                                      **ORACLE_CUTS.get(arch, {})})
    tol = ORACLE_MOE_TOL if arch in ORACLE_CUTS else 1e-3
    if swa:
        cfg = cfg.replace(sliding_window=ORACLE_WINDOW)
    if memo and _ORACLE.get("key") == (arch, seed):
        params, cpu_params = _ORACLE["params"]
    else:
        _ORACLE.clear()
        gc.collect()
        params = tr.init_params(cfg, seed=seed, device=DEVICE)
        cpu_params = _to_cpu(params)
        if memo:
            _ORACLE.update(key=(arch, seed), params=(params, cpu_params),
                           logits={})
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=1024, chunk_tokens=64, measure=False,
        **{**MODES, **SSM_MODES, **WINDOW_MODES}[mode]), device=DEVICE)
    loop = ServeLoop(engine, _policy(engine, 64, 96), slo_ttft=None)
    n0 = {k: f.launches for k, f in _launchers().items()}
    rng = np.random.default_rng(seed + 1)
    system = rng.integers(1, cfg.vocab_size, 64 if ssm else 40)
    # a windowed session's prompt runs past the window
    first_turn = (150, 400) if swa else (20, 160)
    for s in range(4):                       # turn 1: fresh sessions
        loop.submit(s, np.concatenate(
            [system, rng.integers(1, cfg.vocab_size,
                                  int(rng.integers(*first_turn)))]),
                    decode_tokens=2)
    loop.run_until_idle(max_wall=600.0)
    for s in range(4):                       # turn 2: the same sessions
        loop.submit(s, rng.integers(1, cfg.vocab_size,
                                    int(rng.integers(8, 40))),
                    decode_tokens=2)
    loop.run_until_idle(max_wall=600.0)
    # a fifth session prefilled through the chunked long path directly
    # (on the page pool it adopts the shared system prompt's pages)
    long_prompt = np.concatenate(
        [system, rng.integers(1, cfg.vocab_size, 600 if swa else 200)])
    engine.open_session(4)
    engine.adopt_prefix(4, long_prompt)
    first = engine.prefill_long(4, long_prompt[engine.history(4):])
    # the cached ids of each session: the loop's transcript, and for the
    # fifth the prompt, the first token and all but the last decoded one
    cached = {s: list(loop._cache_tokens[s]) for s in range(4)}
    pending = {s: loop._cache_pending[s] for s in range(4)}
    cached[4], pending[4] = [int(t) for t in long_prompt], first
    loop.first_tokens[4] = first
    loop.last_token[4] = first
    for s in range(5):
        toks = loop.decode(s, 4)
        cached[s] += [pending[s]] + toks[1:-1]
    worst, t_oracle = 0.0, time.perf_counter()
    for s in range(5):
        ids = cached[s]
        assert engine.history(s) == len(ids), (s, engine.history(s))
        if engine._paged:
            assert engine.arena._tokens[s] == ids, f"session {s} ids"
        key = tuple(ids)
        if memo and key in _ORACLE["logits"]:
            ref_last = _ORACLE["logits"][key]
        else:
            with torch.no_grad():
                ref = tr.forward(cpu_params, cfg, torch.tensor([ids]),
                                 logits_slice="last")
            ref_last = ref[0].numpy()
            if memo:
                _ORACLE["logits"][key] = ref_last
        got = engine.last_logits[s]
        err = float(np.abs(got - ref_last).max())
        same = int(np.argmax(got)) == int(np.argmax(ref_last))
        worst = max(worst, err)
        log(f"[3] {arch} {mode}: session {s}: {len(ids)} cached tokens, logits "
            f"max_abs_err={err:.3e} (tol {tol:g}) greedy_match={same}")
        assert err <= tol and same, f"{mode} engine vs oracle, session {s}"
    st = engine.stats()
    if engine._paged:
        engine.arena.audit()
    if mode == "ssm_paged":
        assert st["state_checkpoints"] > 0 and st["prefix_hit_tokens"] > 0, \
            "ssm_paged: no prefix adopted through a state checkpoint"
    if swa:
        # every session past the window, the longest past three depths
        # of its ring or rolling slot
        depth = ORACLE_WINDOW + 64
        assert min(engine.history(s) for s in range(5)) > ORACLE_WINDOW
        assert engine.history(4) > 3 * depth, engine.history(4)
        log(f"[3] {mode}: mixtral-8x7b full width, 2 layers, fp32, window "
            f"lowered to {ORACLE_WINDOW} (C_l 64: ring / rolling depth "
            f"{depth}); histories {[engine.history(s) for s in range(5)]}")
    gs = _graphs_replayed(engine, mode)
    ran = {k: f.launches - n0[k] for k, f in _launchers().items()}
    assert all(ran[k] > 0 for k in _mode_kernels(cfg, mode)), (mode, ran)
    if cfg.family == "hybrid":
        # every scan at jamba's 8 groups; KV and state side by side
        assert ran["ssd_scan@grouped"] == ran["ssd_scan"], ran
        log(f"[3] {arch} {mode}: {cfg.num_layers} layers ("
            f"{[cfg.layer_kind(i) for i in range(cfg.num_layers)]}), "
            f"ssd_scan launches {ran['ssd_scan']} all at G "
            f"{cfg.ssm_n_groups}, attention "
            f"{ {k: ran[k] for k in MODE_KERNELS[HYBRID_ATTN_MODE[mode]]} }")
    if arch in WIDTH_ARCHS:
        # every attention launch at the config's width
        launches = {k: f.launches for k, f in _launchers().items()}
        for name in MODE_KERNELS[mode]:
            if name in WIDTH_KERNELS:
                assert launches[f"{name}@d{cfg.hdim}"] > 0, (name, launches)
    log(f"[3] ok: {arch} {mode} engine == dense oracle (max_abs_err "
        f"{worst:.3e}; the oracle's forwards and checks "
        f"{time.perf_counter() - t_oracle:.1f} s) "
        f"through {gs['graphs']} captured step graphs, {gs['replays']} "
        f"replays; prefix_hit_tokens {st['prefix_hit_tokens']}, "
        f"state_checkpoints "
        f"{st['state_checkpoints']}, arena_gathers "
        f"{st['arena_gathers']}, dense_dispatches {st['dense_dispatches']} "
        f"{st['dense_dispatches_by_cause']}")


VLM_TEXT = 32       # text tokens after phi-3-vision's 1024 patches


def phase_vlm_oracle(seed):
    """phi-3-vision-4.2b's ``forward(embeds=)`` on the card (full width
    cut to 2 layers, fp32): its stub frontend's ``frontend_tokens`` =
    1024 random patch embeddings, then VLM_TEXT text tokens' embeddings,
    causal through the backbone (``flash_attn`` at 32 / 32 heads of 96,
    once per layer), against the same forward on a CPU copy of the
    parameters.  Logits over the real vocabulary within 1e-3, the same
    greedy token at every text position."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config("phi-3-vision-4.2b").replace(num_layers=2,
                                                  dtype="float32")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    cpu_params = _to_cpu(params)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 9)
    patches = torch.randn((1, cfg.frontend_tokens, cfg.d_model),
                          generator=gen, device=DEVICE)
    text = torch.randint(1, cfg.vocab_size, (1, VLM_TEXT), generator=gen,
                         device=DEVICE)
    emb = torch.cat([patches, params["embed"][text]], dim=1)
    fl = _launchers()["flash_attn"]
    n0 = fl.launches
    with torch.no_grad():
        got = tr.forward(params, cfg, embeds=emb)
        torch.cuda.synchronize()
        n = fl.launches - n0
        want = tr.forward(cpu_params, cfg, embeds=emb.cpu())
    v = cfg.vocab_size
    err = float((got[..., :v].cpu() - want[..., :v]).abs().max())
    same = bool((got[0, -VLM_TEXT:, :v].argmax(-1).cpu()
                 == want[0, -VLM_TEXT:, :v].argmax(-1)).all())
    log(f"[3] phi-3-vision-4.2b forward(embeds=) of {cfg.frontend_tokens} "
        f"patch embeddings + {VLM_TEXT} text tokens (full width, 2 layers, "
        f"fp32): logits max_abs_err={err:.3e} (tol 1e-3), greedy tokens "
        f"of the text rows match={same}, flash_attn launches {n}")
    assert err <= 1e-3 and same, "phi-3-vision forward(embeds=) vs CPU"
    assert n == cfg.num_layers, n


def phase_encoder_oracle(seed):
    """hubert-xlarge's encoder forward on the card (full width cut to 2
    layers, fp32, random frame embeddings) against the same forward on a
    CPU copy of the parameters (the plain versions): two clips of 400
    frames without a cache, then as a padded batch through a 512-deep
    cache with ``kv_valid_len`` (400, 290).  Logits over the real
    vocabulary within 1e-3, and ``flash_attn`` launched once per layer
    in each forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fl
    from repro_torch.models import transformer as tr
    cfg = get_config("hubert-xlarge").replace(num_layers=2, dtype="float32")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    cpu_params = _to_cpu(params)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 7)
    emb = torch.randn((2, 400, cfg.d_model), generator=gen, device=DEVICE)
    kvl = torch.tensor([400, 290], dtype=torch.int32)
    for name, cached in (("no cache", False), ("cache + kv_valid_len", True)):
        kw, cpu_kw = {}, {}
        if cached:
            kw = dict(caches=tr.init_cache(cfg, 2, 512, device=DEVICE),
                      kv_valid_len=kvl.to(DEVICE))
            cpu_kw = dict(caches=_to_cpu(kw["caches"]), kv_valid_len=kvl)
        n0 = fl.flash_attn.launches
        with torch.no_grad():
            got = tr.forward(params, cfg, embeds=emb, **kw)
            ref = tr.forward(cpu_params, cfg, embeds=emb.cpu(), **cpu_kw)
        torch.cuda.synchronize()
        launched = fl.flash_attn.launches - n0
        v = cfg.vocab_size
        err = float((got[..., :v].cpu() - ref[..., :v]).abs().max())
        log(f"[3] hubert-xlarge encoder, {cfg.num_layers} layers fp32, "
            f"{name}: logits {tuple(got.shape)} max_abs_err={err:.3e} "
            f"(tol 1e-3), flash_attn launches {launched}")
        assert err <= 1e-3, f"hubert encoder ({name}) vs the CPU forward"
        assert launched == cfg.num_layers, f"hubert ({name}): {launched}"
    log("[3] ok: hubert-xlarge encoder on the card == CPU forward")


# rows of phase 3's capacity-dispatch checks at each MoE config's widths
# (fp32): mixtral's 8 experts, jamba's 16 and qwen3-moe's 128
MOE_CHECKS = {"mixtral-8x7b": 8192, HYBRID: 4096, QWEN_MOE: 4096}
# rows of the step captured in phase_moe_graph: a 512-token prefill
# bucket
MOE_GRAPH_ROWS = 512


def _moe_ffn(cfg, gen, dtype=torch.float32):
    """Random MoE FFN parameters at ``cfg``'s widths, drawn as
    ``init_params`` draws them (N(0, 1/fan_in))."""
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen,
                           device=DEVICE).mul_(scale).to(dtype)

    return {"router": randn(d, e, scale=d ** -0.5),
            "wg": randn(e, d, f, scale=d ** -0.5),
            "wi": randn(e, d, f, scale=d ** -0.5),
            "wo": randn(e, f, d, scale=f ** -0.5)}


def _dropped_pairs(p, x, top_k, factor=1.25):
    """(token, expert) pairs the capacity dispatch drops on x."""
    from repro_torch.models import moe
    x2d = x.reshape(-1, x.shape[-1])
    e = p["router"].shape[-1]
    _, experts, _ = moe._routing(p, x2d, top_k)
    cap = max(1, int(np.ceil(x2d.shape[0] * top_k / e * factor)))
    counts = torch.bincount(experts.reshape(-1), minlength=e)
    return int((counts - cap).clamp(min=0).sum())


def phase_moe_check(seed):
    """``moe_layer`` (capacity dispatch) against ``moe_dense_reference``
    (every expert on every token) on the card at each MoE config's
    widths: mixtral-8x7b (d_model 4096, 8 experts of d_ff 14336, top 2),
    jamba-v0.1-52b (16 of 14336, top 2) and qwen3-moe-30b-a3b (d_model
    2048, 128 experts of 768, top 8), MOE_CHECKS rows in fp32 at
    capacity factor E / k (C = T: no pair dropped; mixtral at 8): the
    reference's own check (tests/test_moe_mamba.py), outputs within 1e-4
    and aux losses within 1e-5 relative; at the reference's factor 1.25
    it logs the pairs dropped and the rows they move."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 50)
    for arch, t in MOE_CHECKS.items():
        cfg = get_config(arch)
        k = cfg.num_experts_per_tok
        factor = max(8.0, cfg.num_experts / k)
        p = _moe_ffn(cfg, gen)
        x = torch.randn((1, t, cfg.d_model), generator=gen, device=DEVICE)
        with torch.no_grad():
            want, aux_w = moe.moe_dense_reference(p, x, top_k=k)
            got, aux_g = moe.moe_layer(p, x, top_k=k, capacity_factor=factor)
            dropped, _ = moe.moe_layer(p, x, top_k=k)
            n_drop = _dropped_pairs(p, x, k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4))
        rel = abs(float(aux_w) - float(aux_g)) / abs(float(aux_w))
        moved = int(((dropped - want).abs().amax(dim=-1) > 1e-3).sum())
        log(f"[3] moe_layer vs moe_dense_reference, {arch} widths (d "
            f"{cfg.d_model}, {cfg.num_experts} experts of "
            f"{cfg.moe_d_ff or cfg.d_ff}, top {k}), T = {t}, fp32, "
            f"capacity factor {factor:g}: max_abs_err={err:.3e} (tol 1e-4 "
            f"+ 1e-4 rel) aux {float(aux_g):.6f} vs {float(aux_w):.6f} "
            f"(rel {rel:.1e}); at factor 1.25 {n_drop} of {t * k} pairs "
            f"dropped, {moved} rows moved "
            f"{'ok' if ok and rel <= 1e-5 else 'FAIL'}")
        assert ok and rel <= 1e-5, f"moe_layer vs moe_dense_reference {arch}"
        assert bool(torch.isfinite(dropped).all())
        del p, x, want, got, dropped
        gc.collect()
        torch.cuda.empty_cache()


def phase_moe_graph(seed):
    """The capacity dispatch inside a CUDA graph (a hybrid's and
    qwen3-moe's every MoE step takes it on the card): ``moe_layer`` at
    jamba-v0.1-52b's and qwen3-moe-30b-a3b's widths, bf16, a
    MOE_GRAPH_ROWS-row step at the reference's factor 1.25, captured
    once; replayed on two fresh inputs it gives the eager call's output
    and aux loss bit for bit, pairs dropped and all."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 51)
    bf = torch.bfloat16
    for arch in (HYBRID, QWEN_MOE):
        cfg = get_config(arch)
        k = cfg.num_experts_per_tok
        p = _moe_ffn(cfg, gen, bf)

        def x_new():
            # rows sharing one component route alike, so the experts
            # they favour overflow their capacity
            x = torch.randn((1, MOE_GRAPH_ROWS, cfg.d_model), generator=gen,
                            device=DEVICE)
            return (x + torch.randn((cfg.d_model,), generator=gen,
                                    device=DEVICE)).to(bf)

        static = x_new()
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):            # the warm-up
                moe.moe_layer(p, static, top_k=k)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out, aux = moe.moe_layer(p, static, top_k=k)
            for trial in range(2):
                x = x_new()
                want, aux_w = moe.moe_layer(p, x, top_k=k)
                static.copy_(x)
                graph.replay()
                torch.cuda.synchronize()
                same = bool(torch.equal(out, want) and torch.equal(aux, aux_w))
                n_drop = _dropped_pairs(p, x, k)
                log(f"[3] moe_layer captured in a CUDA graph, {arch} widths "
                    f"bf16, {MOE_GRAPH_ROWS} rows, factor 1.25 ({n_drop} "
                    f"of {MOE_GRAPH_ROWS * k} pairs dropped): replay {trial} "
                    f"bit-identical to eager={same}")
                assert same, f"moe_layer replay vs eager, {arch}"
                assert n_drop > 0, f"{arch}: no pair dropped"
        del p, graph, static, out
        gc.collect()
        torch.cuda.empty_cache()


def _spec_run(engine, prompt, n, sampling=None):
    """Prefill session 0 and speculate until ``n`` tokens are out."""
    engine.open_session(0)
    if sampling is not None:
        engine.set_sampling(0, sampling)
    out = [engine.prefill_packed([0], [prompt])[0]]
    while len(out) < n:
        got = engine.spec_step([(0, out[-1])],
                               max_new={0: n - len(out)})[0]
        assert 1 <= len(got) <= n - len(out), got
        out += got
    return out


def phase_spec_oracle(seed, mode):
    """Speculative decoding on ``mode``'s engine (paged or slot_arena) at
    qwen3-4b widths, 2 layers, fp32: (a) greedy speculation with drafts
    scripted from the plain decode's stream at acceptance 0.7 gives that
    stream token for token; (b) a sampled session (temperature 0.8,
    top_k 20, top_p 0.95, one bias) gives the same stream through the
    fused kernel and through the host sampler, every kernel call held to
    the plain version on its rows; (c) a ServeLoop armed with
    NGramDraft(n=3), k = 4 gives the unarmed loop's transcripts (and a
    green audit on the page pool).  Two of (c)'s four prompts repeat one
    token, on which the random model's greedy stream falls into a loop
    the n-gram draft predicts, so the armed loop does speculate and
    accept; the other two are random."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import sampling as ks
    from repro_torch.models import transformer as tr
    from repro_torch.serving.draft import NGramDraft, ScriptedDraft
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.loop import ServeLoop
    from repro_torch.serving.sampling import SamplingParams
    cfg = get_config("qwen3-4b").replace(num_layers=2, dtype="float32")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    prefill = _launchers()[MODE_KERNELS[mode][0]]

    def engine(**kw):
        return Engine(cfg, params, EngineConfig(
            num_slots=8, max_len=1024, chunk_tokens=64, measure=False,
            keep_last_logits=False, **MODES[mode], **kw), device=DEVICE)

    rng = np.random.default_rng(seed + 5)
    prompt = rng.integers(1, cfg.vocab_size, 40)
    # (a) greedy: lossless at acceptance 0.7
    eng = engine()
    eng.open_session(0)
    t0 = eng.prefill_packed([0], [prompt])[0]
    base = [t0] + eng.decode_batch([0], [t0], steps=24)[0]
    eng = engine()
    eng.enable_spec(ScriptedDraft({0: base}, accept=0.7,
                                  vocab=cfg.vocab_size, seed=1), k=4)
    n0 = prefill.launches
    got = _spec_run(eng, prompt, len(base))
    st = eng.stats()
    log(f"[3] {mode} spec (a): greedy stream of {len(base)} tokens "
        f"lossless={got == base}; {st['spec_dispatches']} verify "
        f"dispatches, {st['spec_tokens_per_dispatch']:.2f} tokens per "
        f"dispatch, acceptance {st['spec_acceptance']:.2f}, "
        f"{prefill.launches - n0} {MODE_KERNELS[mode][0]} launches")
    assert got == base, f"{mode}: greedy speculation is not lossless"
    assert st["spec_dispatches"] > 0 and st["logits_rows_shipped"] == 0
    if eng._paged:
        eng.arena.audit()

    # (b) sampled: the fused kernel's stream == the host sampler's
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=7,
                        logit_bias={3: 2.0})
    calls = []
    inner = ops.fused_sample

    def recorded(logits, *rest):
        out = inner(logits, *rest)
        # a copy: the logits are a step graph's output, which the next
        # replay overwrites
        calls.append(((logits.clone(), *rest), out))
        return out

    streams, stats = {}, {}
    ops.fused_sample = recorded
    try:
        n0 = ks.fused_sample.launches
        for fused in (False, True):
            eng = engine(fused_sampling=fused)
            eng.enable_spec(ScriptedDraft({0: base}, vocab=cfg.vocab_size),
                            k=4)
            streams[fused] = _spec_run(eng, prompt, 24, sampling=sp)
            stats[fused] = eng.stats()
        launched = ks.fused_sample.launches - n0
    finally:
        ops.fused_sample = inner
    moved, worst = 0, 0.0
    for args, out in calls:
        err, rows, ok = _held_draws(args, out)
        moved += len(rows)
        worst = max(worst, err)
        assert ok, f"{mode}: a fused draw off its plain version"
    same = streams[True] == streams[False]
    log(f"[3] {mode} spec (b): sampled stream fused == host: {same}; "
        f"{launched} fused_sample launches ({len(calls)} calls held to "
        f"the plain version: p_draft max_abs_err {worst:.3e}, {moved} "
        f"draws within {SAMPLE_MARGIN} of a CDF boundary); logits rows "
        f"shipped fused {stats[True]['logits_rows_shipped']} host "
        f"{stats[False]['logits_rows_shipped']}; acceptance "
        f"{stats[True]['spec_acceptance']:.2f}")
    assert same, f"{mode}: fused and host sampled streams differ"
    assert launched > 0 and stats[True]["fused_sample_steps"] > 0
    assert stats[True]["logits_rows_shipped"] == 0
    assert stats[False]["logits_rows_shipped"] > 0

    # (c) the serve loop, armed and unarmed
    prompts = {s: rng.integers(1, cfg.vocab_size, int(rng.integers(20, 160)))
               for s in range(2)}
    prompts.update({s: np.full(40, 1000 + s) for s in (2, 3)})
    gen = {}
    for armed in (False, True):
        eng = engine()
        if armed:
            eng.enable_spec(NGramDraft(n=3), k=4)
        loop = ServeLoop(eng, _policy(eng, 64, 96), slo_ttft=None)
        for s, p in prompts.items():
            loop.submit(s, p, decode_tokens=24)
        loop.run_until_idle(max_wall=600.0)
        gen[armed] = {s: list(loop.generated[s]) for s in prompts}
        if eng._paged:
            eng.arena.audit()
    st = eng.stats()
    log(f"[3] {mode} spec (c): ServeLoop + NGramDraft(n=3), k=4: "
        f"transcripts == unarmed: {gen[True] == gen[False]}; "
        f"{st['spec_dispatches']} verify dispatches, drafted "
        f"{st['tokens_drafted']}, accepted {st['tokens_accepted']}"
        f"{', audit green' if eng._paged else ''}")
    assert gen[True] == gen[False], f"{mode}: armed loop transcripts differ"
    assert st["spec_dispatches"] > 0 and st["tokens_accepted"] > 0, \
        f"{mode}: the armed loop never speculated"


# ---------------------------------------------- the cluster (phases 3, 4)

# phase 3's cluster scenarios run the qwen3-4b smoke config at head_dim
# 128 (the kernels take 64, 80, 96 and 128), fp32, on the card and on
# the CPU; phase 4's at qwen3-4b's full width and depth, bf16
CLUSTER_SMOKE = dict(head_dim=128, dtype="float32")
CLUSTER_THRESHOLD = 512            # LengthAwareRouter's long / short cut
CLUSTER_ECFG = dict(num_slots=8, max_len=4096, chunk_tokens=256,
                    measure=False)
CLUSTER_DECODE = 16                # decode budget of every request
CLUSTER_LONG = 2048                # the trace's two long prompts
FAILOVER_ECFG = dict(num_slots=8, max_len=1024, chunk_tokens=256,
                     paged_kv=True, measure=False)


def _stepping_clock():
    """A clock that advances 1 ms a read: wall time then feeds no
    decision of a loop or cluster, so the card and the CPU take one
    schedule."""
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _cluster_loop(cfg, params, device, ecfg, pool=None, threshold=24,
                  chunk=16, clock=None, awd=True):
    """A ServeLoop over a fresh engine: ``PoolPolicy(pool)`` or, with no
    pool, ``pla_full``; with the packed AWD configuration where ``awd``
    (the bench scenarios of phase 3 run without, as the benches do)."""
    from repro_torch.core import (H200_QWEN32B, PoolPolicy, Variant,
                                  make_policy)
    from repro_torch.core.awd import AWDConfig
    from repro_torch.serving import Engine, EngineConfig, ServeLoop
    eng = Engine(cfg, params, EngineConfig(**ecfg), device=device)
    kw = dict(threshold=threshold, chunk_tokens=chunk)
    if awd:
        kw["awd_cfg"] = AWDConfig(
            packed=True, token_buckets=eng.ecfg.token_buckets,
            packed_max_seqs=eng.packed_executor.max_seqs)
    pol = (PoolPolicy(H200_QWEN32B, pool=pool, **kw) if pool is not None
           else make_policy(Variant("pla_full"), H200_QWEN32B, **kw))
    return ServeLoop(eng, pol, slo_ttft=None,
                     **({"clock": clock()} if clock else {}))


def _cluster_state(cluster, sessions):
    st = cluster.stats()
    return dict(stats={k: v for k, v in st.items() if k != "per_engine"},
                report=cluster.report().as_dict(),
                generated={s: list(cluster.generated(s)) for s in sessions},
                homes={s: cluster.engine_of(s) for s in sessions})


def _slo_cluster(cfg, params, device, paged):
    """``benchmarks/bench_slo.py::_engine_cluster`` with its seeds: two
    engines (prefill + decode roles), the longs migrate to decode."""
    from repro_torch.core import LengthAwareRouter
    from repro_torch.serving import ServeCluster
    ecfg = dict(num_slots=8, max_len=160, chunk_tokens=16, paged_kv=paged,
                page_size=8, measure=False)
    cluster = ServeCluster(
        [_cluster_loop(cfg, params, device, ecfg, pool,
                       clock=_stepping_clock, awd=False)
         for pool in ("long", "short")],
        LengthAwareRouter(threshold=24), roles=["prefill", "decode"])
    rng = np.random.default_rng(5)
    for s in range(6):
        n = 40 if s % 3 == 0 else int(rng.integers(4, 16))
        cluster.submit(s, rng.integers(0, cfg.vocab_size, n),
                       decode_tokens=4)
    cluster.run_until_idle(max_wall=1e9)
    return _cluster_state(cluster, range(6))


def _failover(cfg, params, device, ecfg, subs, threshold, chunk, awd,
              victim=1, n_engines=4):
    """``benchmarks/bench_faults.py::_engine_failover`` over ``subs``
    ((session, prompt, decode budget)): a fault-free cluster of
    ``n_engines`` round-robin engines, then the same cluster with
    ``victim`` killed once it holds a decoding session.  Returns the
    failover row, the faulted cluster's state and the fault-free
    transcripts."""
    from repro_torch.core import RoundRobinRouter
    from repro_torch.core.faults import (CRASH, FaultEvent, FaultInjector,
                                         FaultPlan)
    from repro_torch.serving import ServeCluster

    def build(faults):
        return ServeCluster(
            [_cluster_loop(cfg, params, device, ecfg, None, threshold,
                           chunk, clock=_stepping_clock, awd=awd)
             for _ in range(n_engines)], RoundRobinRouter(), faults=faults)

    baseline = build(None)
    for s, toks, d in subs:
        baseline.submit(s, toks, decode_tokens=d)
    baseline.run_until_idle(max_wall=1e9)
    want = {s: list(baseline.generated(s)) for s, _, _ in subs}
    del baseline
    gc.collect()
    cluster = build(FaultInjector(FaultPlan(events=(
        FaultEvent(CRASH, at=1.0, engine=victim),))))
    for s, toks, d in subs:
        cluster.submit(s, toks, decode_tokens=d)
    for _ in range(600):
        if cluster.loops[victim].active_decodes:
            break
        for lp in cluster.loops:
            if lp.has_work:
                lp.tick()
    assert cluster.loops[victim].active_decodes, \
        "failover: the victim never reached its decode phase"
    cluster.run_until_idle(max_wall=1e9)
    for i in cluster.alive_engines():
        cluster.loops[i].engine.arena.audit()
    rep, st = cluster.report(), cluster.stats()
    row = {
        "n_submitted": len(subs), "n_finished": rep.n,
        "lost": len(subs) - rep.n - rep.rejected - rep.abandoned,
        "crashes": st["crashes"],
        "recovered_sessions": st["recovered_sessions"],
        "rerouted_requests": st["rerouted_requests"],
        "abandoned": rep.abandoned,
        "bit_identical": int(all(cluster.generated(s) == want[s]
                                 for s, _, _ in subs)),
        "transcripts_complete": int(all(
            len(cluster.generated(s)) == d + 1 for s, _, d in subs)),
        "health": st["health"],
    }
    return row, _cluster_state(cluster, [s for s, _, _ in subs]), want


def phase_cluster_oracle(seed):
    """Phase 3's cluster scenarios at the qwen3-4b smoke config
    (``CLUSTER_SMOKE``, fp32) on the card against the same clusters on
    the CPU, both on the stepping clock: ``bench_slo``'s 2-engine
    spatial cluster on the slot arena and the page pool (the
    ``BENCH_cluster.json`` engine rows: 2 sessions migrated, 80 tokens
    handed off, 0 host bytes) and ``bench_faults``' 4-engine failover
    (the ``engine/failover`` row: 8 finished, 0 lost, 2 sessions
    recovered bit-identical to the fault-free cluster).  The same
    transcripts, homes, stats and SLO reports on both devices, every
    kernel of the paths launched on the card."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tr
    cfg = get_smoke("qwen3-4b").replace(**CLUSTER_SMOKE)
    params = tr.init_params(cfg, seed=seed + 7, device=DEVICE)
    cpu_params = _to_cpu(params)
    launchers = _launchers()
    for paged in (False, True):
        for fn in launchers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = _slo_cluster(cfg, params, DEVICE, paged)
        torch.cuda.synchronize()
        ran = {k: f.launches for k, f in launchers.items() if f.launches}
        want = _slo_cluster(cfg, cpu_params, "cpu", paged)
        st = got["stats"]
        log(f"[3] cluster {'paged' if paged else 'slot'}: bench_slo's "
            f"2-engine cluster, {got['report']['n']} answered, migrated "
            f"{st['migrated_sessions']}, handoff sessions / tokens / host "
            f"bytes {st['handoff_sessions']} / {st['handoff_tokens']} / "
            f"{st['handoff_host_bytes']}, homes {got['homes']}; card == "
            f"CPU (transcripts, stats, report): {got == want}; "
            f"{time.perf_counter() - t0:.1f} s; launches {ran}")
        assert got == want, "cluster: the card's run differs from the CPU's"
        assert (got["report"]["n"], st["migrated_sessions"],
                st["handoff_sessions"], st["handoff_tokens"],
                st["handoff_host_bytes"]) == (6, 2, 2, 80, 0), st
        assert all(len(g) == 5 for g in got["generated"].values())
        for name in MODE_KERNELS["paged" if paged else "slot_arena"]:
            assert ran.get(name, 0) > 0, f"cluster: {name} never launched"
    rng = np.random.default_rng(11)
    subs = [(s, rng.integers(0, cfg.vocab_size,
                             40 if s % 3 == 0 else int(rng.integers(5, 16))),
             6) for s in range(8)]
    ecfg = dict(num_slots=8, max_len=160, chunk_tokens=16, paged_kv=True,
                page_size=8, measure=False)
    t0 = time.perf_counter()
    row, got, _ = _failover(cfg, params, DEVICE, ecfg, subs, 24, 16, False)
    row_cpu, want, _ = _failover(cfg, cpu_params, "cpu", ecfg, subs, 24, 16,
                                 False)
    log(f"[3] cluster failover: bench_faults' 4 engines, engine 1 killed "
        f"mid-decode: {row}; card == CPU: {(row, got) == (row_cpu, want)}; "
        f"{time.perf_counter() - t0:.1f} s")
    assert (row, got) == (row_cpu, want), "failover: card differs from CPU"
    assert row == {
        "n_submitted": 8, "n_finished": 8, "lost": 0, "crashes": 1,
        "recovered_sessions": 2, "rerouted_requests": 0, "abandoned": 0,
        "bit_identical": 1, "transcripts_complete": 1,
        "health": ["healthy", "dead", "healthy", "healthy"]}, row


def _watch_spills(arena):
    """Snapshot every page as it spills (a device clone of each leaf) and
    hold each promoted page to the snapshot of its key bit for bit, with
    no host sync: mismatches accumulate in a device flag.  Returns
    {"spilled", "promoted", "bad" (the flag)}."""
    snaps = {}
    seen = {"spilled": 0, "promoted": 0,
            "bad": torch.zeros((), dtype=torch.bool, device=DEVICE)}
    spill, promote = arena._spill, arena._promote

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    def watched_spill(key, page):
        snaps[key] = [{n: a[:, page].clone() for n, a in leaves.items()}
                      for leaves in arena.arena]
        seen["spilled"] += 1
        spill(key, page)

    def watched_promote(key, parent, chunk):
        node = promote(key, parent, chunk)
        if node is not None:
            for want, leaves in zip(snaps[key], arena.arena):
                for n, a in leaves.items():
                    seen["bad"] |= (bits(want[n])
                                    != bits(a[:, node.page])).any()
            seen["promoted"] += 1
        return node

    arena._spill, arena._promote = watched_spill, watched_promote
    return seen


def _drive_spill(cfg, params, device, spill):
    """``benchmarks/bench_mix.py::_drive_paged_spill`` with its seed:
    stateless turns over five conversations on an 8-page pool of 8-token
    pages, then every conversation returns; with a 64 MiB host pool the
    evicted prefix pages spill and are promoted on the return hit, without
    one (drop-on-evict) the returns re-prefill.  Returns the bench row,
    the host pool's keys in LRU order, the first tokens and the watch."""
    from repro_torch.serving import Engine, EngineConfig
    rng = np.random.default_rng(23)
    eng = Engine(cfg, params, EngineConfig(
        num_slots=2, max_len=64, num_pages=8, page_size=8, chunk_tokens=16,
        token_buckets=(16, 32), decode_buckets=(1, 2),
        host_pool_bytes=(64 << 20) if spill else 0, measure=False),
        device=device)
    watch = _watch_spills(eng.arena) if spill else None
    prompts = [rng.integers(0, cfg.vocab_size, 24) for _ in range(5)]
    sid, prompt_tokens, tokens = 100, 0, {}
    for _ in range(2):                       # round 2 = the returns
        for p in prompts:
            eng.open_session(sid)
            matched = eng.adopt_prefix(sid, p)
            tokens[sid] = eng.step_mixed([(sid, p[matched:])],
                                         []).tokens[sid]
            eng.close_session(sid)
            prompt_tokens += len(p)
            sid += 1
    st = eng.stats()
    eng.arena.audit()
    row = {"hit_rate": round(st["prefix_hit_tokens"] / prompt_tokens, 3),
           **{k: st[k] for k in ("prefix_hit_tokens", "pages_evicted",
                                 "pages_spilled", "pages_promoted",
                                 "host_pages_dropped")}}
    return row, list(eng.arena._host_pool), tokens, watch


# BENCH_paged.json's spill and drop_on_evict rows
SPILL_ROWS = {True: dict(hit_rate=0.333, prefix_hit_tokens=80,
                         pages_evicted=22, pages_spilled=22,
                         pages_promoted=10, host_pages_dropped=0),
              False: dict(hit_rate=0.0, prefix_hit_tokens=0,
                          pages_evicted=22, pages_spilled=0,
                          pages_promoted=0, host_pages_dropped=0)}


def phase_spill_oracle(seed):
    """Phase 3's host spill tier at the qwen3-4b smoke config
    (``CLUSTER_SMOKE``, fp32): ``bench_mix``'s eviction-pressure trace
    with the host pool and drop-on-evict, on the card against the same
    on the CPU.  Both arms give identical counters and host-pool keys on
    both devices and the committed ``BENCH_paged.json`` rows; on the
    card every promoted page equals, bit for bit, its snapshot taken
    before it spilled, and the paged prefill kernel ran."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tr
    cfg = get_smoke("qwen3-4b").replace(**CLUSTER_SMOKE)
    params = tr.init_params(cfg, seed=seed + 8, device=DEVICE)
    cpu_params = _to_cpu(params)
    launchers = _launchers()
    for spill in (True, False):
        for fn in launchers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        row, keys, toks, watch = _drive_spill(cfg, params, DEVICE, spill)
        torch.cuda.synchronize()
        ran = {k: f.launches for k, f in launchers.items() if f.launches}
        row_c, keys_c, toks_c, _ = _drive_spill(cfg, cpu_params, "cpu",
                                                spill)
        arm = "spill" if spill else "drop_on_evict"
        log(f"[3] spill {arm}: bench_mix's eviction-pressure trace {row}; "
            f"card == CPU (counters, host-pool keys): "
            f"{(row, keys) == (row_c, keys_c)}, first tokens alike "
            f"{toks == toks_c}; {time.perf_counter() - t0:.1f} s; "
            f"launches {ran}")
        assert (row, keys) == (row_c, keys_c), \
            f"spill {arm}: the card's counters differ from the CPU's"
        assert row == SPILL_ROWS[spill], f"spill {arm}: {row}"
        # the trace's steps are prefills only (no decode tick)
        assert ran.get("ragged_prefill_paged", 0) > 0, \
            "spill: ragged_prefill_paged never launched"
        if spill:
            assert watch["promoted"] == row["pages_promoted"] > 0
            assert not bool(watch["bad"].item()), \
                "spill: a promoted page differs from its snapshot"
            log(f"[3] spill: {watch['promoted']} promoted pages == their "
                f"snapshots before the spill, bit for bit")


def _cluster_trace(cfg, seed):
    """Phase 4's cluster trace, in waves by turn: the port's multi-turn
    chat (6 sessions, a 64-token system prompt from a pool of 2, 16-64
    new tokens a turn, up to 3 turns: turns of 80-256 tokens; a later
    turn sends its new tokens to the same session) with two
    CLUSTER_LONG-token prompts among the first wave's shorts."""
    from repro_torch.data.synthetic import (MultiTurnConfig,
                                            gen_multiturn_sessions)
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=cfg.vocab_size, num_sessions=6, system_len=64,
        suffix_lo=16, suffix_hi=64, max_turns=3, seed=seed))
    waves = {}
    for u in turns:
        toks = u.tokens if u.turn == 0 else u.tokens[-u.suffix:]
        waves.setdefault(u.turn, []).append((u.session, toks))
    rng = np.random.default_rng(seed + 3)
    first = waves[0]
    for i, at in enumerate((1, 4)):
        first.insert(min(at, len(first)), (
            100 + i, rng.integers(1, cfg.vocab_size, CLUSTER_LONG)))
    return [waves[t] for t in sorted(waves)]


def _kv_bytes(engine):
    """Bytes of one token's K and V over every layer of ``engine``."""
    return sum(a[:, 0, 0].numel() * a.element_size()
               for leaves in engine.arena.arena for a in leaves.values())


class _HostReads(TorchDispatchMode):
    """Counts every aten op run inside it that reads a CUDA tensor, and
    keeps by name each such op whose result is a host tensor or a Python
    scalar: a device-to-host read seen at the dispatcher, whether or not
    the profiler traces the device."""

    def __init__(self):
        super().__init__()
        self.device_ops, self.d2h = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves((args, kwargs))):
            self.device_ops += 1
            if any(not (isinstance(t, torch.Tensor) and t.is_cuda)
                   for t in tree_leaves(out) if t is not None):
                self.d2h.append(str(func))
        return out


def _profile_handoff(fn):
    """Run ``fn`` on an idle device under ``torch.profiler`` and
    ``_HostReads``; fail on a device-to-host copy that either sees, or if
    ``fn`` ran no op on the card.  Returns ``fn``'s result and the
    profile's count of device events: 0 when CUPTI traced nothing in this
    session (it happened in one whole run on an H100, with the ops on the
    card all the same), and the caller then profiles another handoff."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _HostReads() as reads:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e.name for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    d2h = [e.name for e in events
           if "DtoH" in e.name or "Device -> Pageable" in e.name
           or "Device -> Pinned" in e.name
           or e.name in ("aten::_local_scalar_dense", "aten::item")]
    assert reads.device_ops, "handoff profile: no op on the card"
    assert not d2h and not reads.d2h, \
        f"handoff: device-to-host copies {d2h} {reads.d2h}"
    return out, len(device)


def _cluster_run(cfg, params, paged, spatial, seed, card, kept=True):
    """One cluster run of phase 4 over ``_cluster_trace``: two engines on
    the card sharing one copy of the weights — prefill + decode roles
    under ``LengthAwareRouter(CLUSTER_THRESHOLD)`` (``spatial``), or two
    general engines under ``RoundRobinRouter``.  The kernel counters are
    set to 0 just before the trace and read just after.  The first
    migration runs under ``_profile_handoff`` (no device-to-host copy;
    the next ones too while the profiles trace no device event), the
    others between CUDA events; the gate's both sides are logged."""
    from repro_torch.core import LengthAwareRouter, RoundRobinRouter
    from repro_torch.core.slo import SLOTracker, percentile
    from repro_torch.serving import Engine, EngineConfig, ServeCluster
    ecfg = dict(CLUSTER_ECFG, paged_kv=paged)
    roles = ["prefill", "decode"] if spatial else ["general", "general"]
    pools = ("long", "short") if spatial else (None, None)
    loops = [_cluster_loop(cfg, params, DEVICE, ecfg, pool,
                           CLUSTER_THRESHOLD, ecfg["chunk_tokens"])
             for pool in pools]
    router = (LengthAwareRouter(threshold=CLUSTER_THRESHOLD) if spatial
              else RoundRobinRouter())
    cluster = ServeCluster(loops, router, roles=roles)
    gate, handoff_ms, profiled = [], [], []
    inner_worth, inner_migrate = (cluster._worth_migrating,
                                  cluster._migrate_session)

    def worth(lp, session):
        ok = inner_worth(lp, session)
        c = cluster.cost
        gain = lp.active_decodes.get(session, 0) * (
            c.beta + c.w_tok + c.decode_per_seq)
        gate.append((session, lp.active_decodes.get(session, 0),
                     lp.engine.history(session), gain,
                     c.handoff_time(lp.engine.history(session)), ok))
        return ok

    def migrate(src, dst, session):
        if not any(n for _, n in profiled):
            _, n_dev = _profile_handoff(
                lambda: inner_migrate(src, dst, session))
            profiled.append((session, n_dev))
            return
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        inner_migrate(src, dst, session)
        ev[1].record()
        torch.cuda.synchronize()
        handoff_ms.append(ev[0].elapsed_time(ev[1]))

    cluster._worth_migrating, cluster._migrate_session = worth, migrate
    waves = _cluster_trace(cfg, seed)
    launchers = _launchers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in launchers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    turns = {}
    for wave in waves:
        for s, toks in wave:
            cluster.submit(s, toks, decode_tokens=CLUSTER_DECODE)
            turns[s] = turns.get(s, 0) + 1
        cluster.run_until_idle(max_wall=600.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = {k: f.launches for k, f in launchers.items() if f.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = cluster.stats()
    rep = cluster.report()
    merged = SLOTracker.merged([lp.tracker for lp in cluster.loops])
    by_class = {}
    for r in merged.finished:
        cls = "long" if r.new_tokens >= CLUSTER_THRESHOLD else "short"
        by_class.setdefault(cls, []).append(r.ttft() * 1e3)
    what = (f"{'paged' if paged else 'slot'} "
            f"{'spatial' if spatial else 'round_robin'}"
            f"{'' if kept else ' (warm-up, not kept)'}")
    n_req = sum(turns.values())
    assert rep.n == n_req and rep.abandoned == 0, f"{what}: unanswered"
    assert all(len(cluster.generated(s)) == n * (CLUSTER_DECODE + 1)
               for s, n in turns.items()), f"{what}: short transcripts"
    kernels = MODE_KERNELS["paged" if paged else "slot_arena"]
    assert all(ran.get(k, 0) > 0 for k in kernels), f"{what}: {ran}"
    assert st["handoff_host_bytes"] == 0
    if spatial:
        assert st["migrated_sessions"] >= 1 and profiled, \
            f"{what}: no session migrated"
        assert cluster.engine_of(100) == 1 and cluster.engine_of(101) == 1
    else:
        assert st["migrated_sessions"] == 0
    pools_log = []
    for lp in cluster.loops:
        ar = lp.engine.arena
        rows = (ar.num_pages * ar.page_size if paged
                else ar.num_slots * ar.max_len)
        pools_log.append(
            f"{ar.num_pages} pages" if paged else f"{ar.num_slots} slots")
        pools_log[-1] += f" ({rows * _kv_bytes(lp.engine) / 2**30:.2f} GiB)"
    log(f"[4] cluster {what}: {n_req} requests in {len(waves)} waves, "
        f"wall {wall:.2f} s; TTFT long mean "
        f"{np.mean(by_class.get('long', [0])):.1f} ms p90 "
        f"{percentile(by_class.get('long', [0]), 0.9):.1f} ms "
        f"({len(by_class.get('long', []))}), short mean "
        f"{np.mean(by_class['short']):.1f} ms p90 "
        f"{percentile(by_class['short'], 0.9):.1f} ms "
        f"({len(by_class['short'])}); migrated {st['migrated_sessions']}, "
        f"handoff tokens {st['handoff_tokens']}, host bytes "
        f"{st['handoff_host_bytes']}; homes of the longs "
        f"{[cluster.engine_of(s) for s in (100, 101)]}; pools "
        f"{pools_log}; peak {peak:.2f} GiB; launches {ran} (card {card})")
    if spatial:
        log(f"[4] cluster {what}: migration gate (session, decode tokens "
            f"left, history, gain s, handoff s, moved): "
            + "; ".join(f"{s} {left} {h} {g:.2e} {c:.2e} {ok}"
                        for s, left, h, g, c, ok in gate))
        # the copy alone: the migrated long exported from the decode
        # engine into a fresh engine without a prefix index (nothing
        # deduped), profiled while no profile of a migration traced the
        # device (at most 5 times), then 5 times between CUDA events
        a = cluster.loops[1].engine
        b = Engine(cfg, params, EngineConfig(**ecfg, prefix_cache=False),
                   device=DEVICE)
        alone = []
        while not any(n for _, n in profiled + alone) and len(alone) < 5:
            _, n_dev = _profile_handoff(
                lambda: b.import_session(800, a.export_session(100)))
            b.close_session(800)
            alone.append((100, n_dev))
        traced = sum(1 for _, n in profiled + alone if n)
        log(f"[4] cluster {what}: {traced} of {len(profiled + alone)} "
            f"handoff profiles traced the device, "
            f"{len(profiled + alone) - traced} came back blind")
        assert any(n for _, n in profiled + alone), \
            f"{what}: no handoff profile traced the device"
        log(f"[4] cluster {what}: migrations profiled (session, device "
            f"events) {profiled}, then export + import alone {alone}: no "
            f"device-to-host copy in the profiles or at the dispatcher; "
            f"the other migrations' ms between CUDA events around export "
            f"+ import: {[round(x, 3) for x in handoff_ms]}")
        ms = []
        for i in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            b.import_session(900 + i, a.export_session(100))
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            b.close_session(900 + i)
        assert b.handoff_host_bytes == 0
        n = a.history(100)
        moved = 4 * n * _kv_bytes(a)
        log(f"[4] cluster {what}: export + import of a {n}-token session "
            f"({n * _kv_bytes(a) / 2**20:.1f} MiB of KV, read and written "
            f"by the export and again by the import): "
            f"{[round(x, 3) for x in ms]} ms, median {np.median(ms):.3f} "
            f"ms, {moved / (np.median(ms) * 1e-3) / 1e9:.0f} GB/s "
            f"(card {card})")
    return dict(ttft_long=by_class.get("long", []),
                ttft_short=by_class["short"], stats=st, peak=peak,
                handoff_ms=handoff_ms)


def phase_cluster(seed, card):
    """Phase 4's cluster: qwen3-4b at full width and depth (bf16), two
    engines on the card over ``_cluster_trace`` on both arena families,
    spatial (prefill + decode roles, ``LengthAwareRouter``) and round
    robin beside it, after one warm-up run; then ``bench_faults``' 4-engine failover at full
    width (one of four paged engines killed mid-decode: nothing lost,
    the recovered sessions' tokens against the fault-free cluster's,
    logged — bf16, so not asserted bit-identical)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config("qwen3-4b")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    # a process's first profiler session initializes CUPTI, which took
    # seconds: take it here, not inside the first cluster trace
    t0 = time.perf_counter()
    _, n_dev = _profile_handoff(lambda: params["embed"].sum())
    log(f"[4] cluster: the profiler's first session took "
        f"{time.perf_counter() - t0:.2f} s (outside the traces), "
        f"{n_dev} device events")
    torch.cuda.synchronize()
    log(f"[4] cluster: qwen3-4b {cfg.num_layers} layers {cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights "
        f"shared by every engine")
    # one warm-up run (the process's first full-width qwen3-4b work if
    # phase 4 runs alone), then the four kept cells
    for paged, spatial, kept in ((True, True, False), (True, True, True),
                                 (True, False, True), (False, True, True),
                                 (False, False, True)):
        t0 = time.perf_counter()
        _cluster_run(cfg, params, paged, spatial, seed, card, kept)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[4] cluster run took {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 11)
    subs = [(s, rng.integers(1, cfg.vocab_size, 768 if s % 3 == 0
                             else int(rng.integers(64, 257))), 16)
            for s in range(8)]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    row, got, want = _failover(cfg, params, DEVICE, FAILOVER_ECFG, subs,
                               CLUSTER_THRESHOLD, 256, True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = sum(a == b for s, _, _ in subs
               for a, b in zip(got["generated"][s], want[s]))
    total = sum(len(want[s]) for s, _, _ in subs)
    log(f"[4] cluster failover at full width: {row}; tokens equal to the "
        f"fault-free cluster's {same} of {total} (bf16: the recovery "
        f"re-prefills what decode wrote row by row); peak {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s (card {card})")
    assert row["lost"] == 0 and row["crashes"] == 1 and \
        row["recovered_sessions"] >= 1 and row["transcripts_complete"] == 1

# ------------------------------------------------------------ phase 4

# phase 4's host spill tier: the pinned host pool (large enough that no
# page of the trace is dropped) and the decode budget of every request
SPILL_HOST_BYTES = 2 << 30
SPILL_DECODE = 16


# the H100 SXM data sheet's host link: PCIe Gen5 x16, 128 GB/s both
# ways together, the rate used where nvidia-smi cannot read the link
DATASHEET_LINK_GBS = 64.0


def _pcie_link():
    """(what ``nvidia-smi`` reads of the host link's current generation
    and width, GB/s each way).  The rate is the generation's (2.5 / 5
    GT/s a lane for 1-2 at 8b/10b, 8, 16, 32 and 64 GT/s for 3-6 at
    128b/130b) times the width; an idle link may sit below its maximum
    generation.  Where the card reports no link (``[N/A]``), the data
    sheet's ``DATASHEET_LINK_GBS``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    raw = out.splitlines()[0].strip()
    try:
        gen, width = (int(x) for x in raw.split(","))
    except ValueError:
        return f"{raw} (the data sheet's gen 5 x16)", DATASHEET_LINK_GBS
    gt = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}[gen]
    eff = 0.8 if gen <= 2 else 128 / 130
    return f"gen {gen} x{width}", gt * eff * width / 8


def _spill_trace(cfg, seed):
    """Phase 4's paged multi-turn trace (``_serve_once``'s prompts and
    turn-2 extensions, from the same seed): one 2048-token prompt and
    seven 64-token-system-prompt prompts of 80-256 tokens, then each
    conversation back with 16-64 new tokens."""
    rng = np.random.default_rng(seed + 2)
    system = rng.integers(1, cfg.vocab_size, 64)
    prompts = {0: rng.integers(1, cfg.vocab_size, 2048)}
    for s in range(1, 8):
        prompts[s] = np.concatenate(
            [system, rng.integers(1, cfg.vocab_size,
                                  int(rng.integers(16, 193)))])
    news = {s: rng.integers(1, cfg.vocab_size, int(rng.integers(16, 65)))
            for s in range(8)}
    return prompts, news


def _spill_run(cfg, params, seed, host_bytes, num_pages):
    """Phase 4's paged trace on a page pool of ``num_pages`` pages, with
    a host pool of ``host_bytes`` (0: drop on evict), one conversation at
    a time as a stateless client sends it (each session closed once its
    answer is complete, so its pages stay only on the radix index): turn
    1, then every conversation back as its whole transcript plus the new
    tokens under a new session.  The host tier's copies are timed with
    CUDA events around each spill's and promote's copies."""
    from repro_torch.core.slo import percentile
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.loop import ServeLoop
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=4096, chunk_tokens=256, measure=False,
        num_pages=num_pages, host_pool_bytes=host_bytes), device=DEVICE)
    ar = engine.arena
    watch = _watch_spills(ar) if host_bytes else None
    events = {"store": [], "load": []}
    for what in events:
        def timed(slot, page, _fn=getattr(ar._host_slots, what),
                  _ev=events[what]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _fn(slot, page)
            b.record()
            _ev.append((a, b))
        setattr(ar._host_slots, what, timed)
    loop = ServeLoop(engine, _policy(engine, 256, 512), slo_ttft=None)
    prompts, news = _spill_trace(cfg, seed)
    launchers = _launchers()
    for fn in launchers.values():
        fn.launches = 0
    gen, graphs = {}, []

    def serve(session, tokens):
        loop.submit(session, tokens, decode_tokens=SPILL_DECODE)
        while loop.has_work:
            loop.tick()
        torch.cuda.synchronize()
        out = list(loop.generated[session])
        loop.close_session(session)
        return out

    t0 = time.perf_counter()
    for s in range(8):                           # turn 1
        gen[s] = serve(s, prompts[s])
    graphs.append(engine.graph_stats()["graphs"])
    back = {}
    for s in range(8):                           # the returns
        back[s] = serve(100 + s, np.concatenate(
            [prompts[s], gen[s][:-1], news[s]]))
    graphs.append(engine.graph_stats()["graphs"])
    wall = time.perf_counter() - t0
    ttft = [r.ttft() * 1e3 for r in loop.tracker.finished
            if r.session >= 100]
    st = engine.stats()
    ar.audit()
    ms = {what: [a.elapsed_time(b) for a, b in ev]
          for what, ev in events.items()}
    assert len(ttft) == 8 and loop.tracker.report().n == 16
    assert all(len(g) == SPILL_DECODE + 1 for g in (*gen.values(),
                                                    *back.values()))
    return {
        "counters": {k: st[k] for k in (
            "pages_evicted", "pages_spilled", "pages_promoted",
            "host_pages_dropped", "host_pool_pages", "prefix_hit_tokens")},
        "ttft_mean_ms": float(np.mean(ttft)),
        "ttft_p90_ms": percentile(ttft, 0.9), "ttft_ms": ttft,
        "spill_ms": ms["store"], "promote_ms": ms["load"],
        "pinned_bytes": ar.host_pinned_bytes, "page_bytes": ar._page_bytes,
        "watch": watch, "launches": {k: f.launches
                                     for k, f in launchers.items()},
        "graphs_turn2": graphs[1] - graphs[0], "wall_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "back": back}


def phase_spill(seed, card):
    """Phase 4's ``paged_spill`` run: qwen3-4b at full width and depth
    (36 layers, 32 / 8 heads of 128, bf16; a 16-token page is 2,359,296
    B) serving phase 4's paged multi-turn trace on a page pool cut to
    about half the pages turn 1's conversations need (never below what
    the longest returning conversation holds at once), so turn 1's pages
    are evicted before they return.  Beside it the same trace without a
    host pool (drop on evict).  Logs each arm's pages evicted, spilled,
    promoted and dropped, prefix-hit tokens and the returning turns'
    TTFT; the tier's ms and GB/s per spill and promote against the host
    link's rate; the pinned bytes.  Fails if nothing was promoted, a
    page was dropped, or a promoted page differs from its snapshot."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config("qwen3-4b")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    prompts, news = _spill_trace(cfg, seed)
    ps = 16

    def pages(n):
        return -(-n // ps)

    turn1 = sum(pages(len(p) + SPILL_DECODE) for p in prompts.values())
    longest = max(pages(len(prompts[s]) + SPILL_DECODE + len(news[s])
                        + SPILL_DECODE) for s in prompts)
    num_pages = max(turn1 // 2, longest + 8)
    link_read, link = _pcie_link()
    log(f"[4] paged_spill: qwen3-4b {cfg.num_layers} layers, turn 1's "
        f"conversations hold {turn1} pages, the longest returning one "
        f"{longest}; device pool {num_pages} pages "
        f"({num_pages / turn1:.2f} of turn 1's); host link "
        f"(pcie.link.gen.current, pcie.link.width.current) {link_read}, "
        f"{link:.1f} GB/s each way (card {card})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for arm, host in (("spill", SPILL_HOST_BYTES), ("drop_on_evict", 0)):
        gc.collect()
        r = runs[arm] = _spill_run(cfg, params, seed, host, num_pages)
        c = r["counters"]
        log(f"[4] paged_spill {arm}: evicted {c['pages_evicted']}, spilled "
            f"{c['pages_spilled']}, promoted {c['pages_promoted']}, dropped "
            f"{c['host_pages_dropped']}, host pool {c['host_pool_pages']} "
            f"pages at the end, prefix-hit tokens {c['prefix_hit_tokens']}; "
            f"returning turns' TTFT mean {r['ttft_mean_ms']:.2f} ms p90 "
            f"{r['ttft_p90_ms']:.2f} ms (each: "
            + ", ".join(f"{x:.1f}" for x in r["ttft_ms"])
            + f" ms); step graphs captured in the returns "
            f"{r['graphs_turn2']}; wall {r['wall_s']:.2f} s, peak "
            f"{r['peak_gib']:.2f} GiB (card {card})")
    sp = runs["spill"]
    for what, key in (("spill", "spill_ms"), ("promote", "promote_ms")):
        xs = sp[key]
        med = float(np.median(xs))
        log(f"[4] paged_spill: {len(xs)} {what}s of a {sp['page_bytes']} B "
            f"page (CUDA events around the copies): median {med:.4f} ms, "
            f"mean {float(np.mean(xs)):.4f} ms, min {min(xs):.4f}, max "
            f"{max(xs):.4f}; {sp['page_bytes'] / med / 1e6:.2f} GB/s at the "
            f"median against the link's {link:.1f} GB/s (card {card})")
    log(f"[4] paged_spill: pinned host pool {sp['pinned_bytes']} B "
        f"({sp['pinned_bytes'] / 2**30:.3f} GiB, "
        f"{sp['pinned_bytes'] // sp['page_bytes']} page slots) for a "
        f"budget of {SPILL_HOST_BYTES} B")
    c = sp["counters"]
    assert c["pages_promoted"] > 0, "paged_spill: no page promoted"
    assert c["host_pages_dropped"] == 0, "paged_spill: a page was dropped"
    assert sp["watch"]["promoted"] == c["pages_promoted"]
    assert not bool(sp["watch"]["bad"].item()), \
        "paged_spill: a promoted page differs from its snapshot"
    assert runs["drop_on_evict"]["counters"]["pages_spilled"] == 0
    for name in MODE_KERNELS["paged"]:
        assert sp["launches"][name] > 0, f"paged_spill: {name} never ran"
    firsts = [[r["back"][s][0] for s in range(8)] for r in runs.values()]
    log(f"[4] paged_spill: {c['pages_promoted']} promoted pages == their "
        f"snapshots before the spill, bit for bit; the returns' first "
        f"tokens alike in both arms: {firsts[0] == firsts[1]}")
    return runs


def _dispatches(engine):
    """(prefill dispatches, decode dispatches) so far: packed and dense
    prefill steps, arena / paged and dense decode steps."""
    dense = engine.executor.kind_hits, engine.executor.kind_misses
    pre = sum(d.get("prefill", 0) for d in dense)
    dec = sum(d.get("decode", 0) for d in dense)
    if engine.packed_executor is not None:
        pre += engine.packed_executor.dispatches
    if engine.decode_executor is not None:
        dec += engine.decode_executor.dispatches
    return pre, dec


def _serve_once(cfg, params, seed, mode):
    """Serve phase 4's trace once on a fresh engine in ``mode``, with the
    LAPS boundary fixed (``measure=False``: no refit from wall-time
    samples).  Every kernel's launch counter is set to 0 just before the
    trace and read just after.

    Turn 1: one 2048-token prompt (long queue, chunked) and seven
    64-token-system-prompt prompts of 80-256 tokens.  On the page pool
    turn 2 resubmits each full conversation plus 16-64 new tokens under
    a new session (radix prefix hits).  A slot keeps its session's
    history, so there turn 2 submits only the 16-64 new tokens to the
    same session, and turn 3 another 24-32 (short enough for the (L, B)
    grid).  Every request decodes 16 tokens.

    The spec mode serves the paged trace with NGramDraft(n=3), k =
    SPEC_K armed and the odd sessions sampled (temperature 0.8, top_k 20,
    top_p 0.95; session 1 with one bias) through the fused kernel; its
    decode ticks are the loop's speculative steps.  The SSM modes serve
    mamba2 or jamba (``ssm_paged`` on ``SSM_POOL``'s page pool) and count
    the ``ssd_scan`` launches of prefill and decode-only ticks apart, and
    the prefix matches that adopted a state checkpoint.  The
    windowed modes serve mixtral at max_len 8192: the long prompt is
    WINDOW_PROMPT tokens (past the 4096-token window and the 4352-row
    ring or rolling slot), turn 2 adds 1024 tokens to it and 16-64 to
    the others in the same sessions (a ring keeps no radix index), and
    there is no turn 3."""
    from repro_torch.serving.draft import NGramDraft
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.loop import ServeLoop
    from repro_torch.serving.sampling import SamplingParams
    ssm = mode in SSM_MODES
    swa = mode in WINDOW_MODES
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=8192 if swa else 4096, chunk_tokens=256,
        measure=False,
        **SERVE_MODES[mode], **(SSM_POOL if mode == "ssm_paged" else {})),
        device=DEVICE)
    spec = mode == "spec"
    sampling = {}
    spec_ticks = {"n": 0, "tokens": 0, "stream": 0}
    if spec:
        engine.enable_spec(NGramDraft(n=3), k=SPEC_K)
        for s in range(1, 8, 2):
            sampling[s] = sampling[100 + s] = SamplingParams(
                temperature=0.8, top_k=20, top_p=0.95, seed=s,
                logit_bias={3: 2.0} if s == 1 else None)
        inner = engine.spec_step
        px = engine.packed_executor

        def spec_step(decodes, max_new=None):
            # the loop's decode-only ticks: count them, their committed
            # tokens, and the stream tokens they ran
            u0 = px.useful_tokens
            out = inner(decodes, max_new=max_new)
            spec_ticks["n"] += 1
            spec_ticks["tokens"] += sum(len(v) for v in out.values())
            spec_ticks["stream"] += px.useful_tokens - u0
            return out

        engine.spec_step = spec_step
    policy = _policy(engine, 256, 512)
    loop = ServeLoop(engine, policy, slo_ttft=None)
    rng = np.random.default_rng(seed + 2)
    system = rng.integers(1, cfg.vocab_size, 64)
    prompts = {0: rng.integers(1, cfg.vocab_size,
                               WINDOW_PROMPT if swa else 2048)}
    for s in range(1, 8):
        prompts[s] = np.concatenate(
            [system, rng.integers(1, cfg.vocab_size,
                                  int(rng.integers(16, 193)))])
    ticks = []          # (seconds, kind)
    # rows of dense decode steps (arena_decode=False): the dense executor
    # counts them among its useful tokens, beside the grid's prompts
    dense_decode_rows = [0]
    # whole-slot gathers by tick kind (only slot_dense_decode copies
    # slots on decode ticks)
    gathers = {"prefill": 0, "decode": 0}
    # the (L, B) shape of every dense grid step, and each prefill tick's
    # seconds with the shapes it ran
    dense_shapes, prefill_log = [], []
    inner_prefill = engine.executor.prefill

    def dense_prefill(params, tokens, *rest, **kw):
        dense_shapes.append(tuple(tokens.shape[::-1]))
        return inner_prefill(params, tokens, *rest, **kw)

    engine.executor.prefill = dense_prefill
    # prefix matches that adopted pages and, on a state-page pool, a
    # boundary-state checkpoint with them
    adopted = [0]
    if engine._paged and engine.arena.state_slots:
        for name in ("match_prefix", "match_extend"):
            def counted(*a, _fn=getattr(engine.arena, name), **kw):
                n = _fn(*a, **kw)
                adopted[0] += n > 0
                return n
            setattr(engine.arena, name, counted)
    launchers = _launchers()
    ssd = launchers["ssd_scan"]
    # ssd_scan launches in prefill and in decode-only ticks, and the
    # prefill dispatches those ticks ran
    ssd_split = {"prefill": 0, "decode": 0, "dispatches": 0}

    # graph replays by tick kind
    replays = {"prefill": 0, "decode": 0}

    def drive():
        while loop.has_work:
            pre0, dec0 = _dispatches(engine)
            # a tick's own ssd_scan launches: those of its graphs'
            # replays, not of a new graph's warm-up on parked inputs
            n_spec = spec_ticks["n"]
            n_ssd = ssd.launches - _warmup_launches(engine).get(
                "ssd_scan", 0)
            r0 = engine.graph_stats()["replays"]
            u0 = engine.executor.useful_tokens
            g0 = engine.arena.gather_calls
            s0 = len(dense_shapes)
            t = time.perf_counter()
            did, _ = loop.tick()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            pre, dec = _dispatches(engine)
            kind = None
            if spec_ticks["n"] > n_spec:
                kind = "decode"
            elif pre > pre0:
                kind = "prefill"
                ssd_split["dispatches"] += pre - pre0
            elif dec > dec0:
                kind = "decode"
                dense_decode_rows[0] += engine.executor.useful_tokens - u0
            elif not did:
                time.sleep(0.0005)
            if kind is not None:
                ticks.append((dt, kind))
                ssd_split[kind] += (ssd.launches - n_ssd
                                    - _warmup_launches(engine).get(
                                        "ssd_scan", 0))
                replays[kind] += engine.graph_stats()["replays"] - r0
                gathers[kind] += engine.arena.gather_calls - g0
                if kind == "prefill":
                    prefill_log.append((dt, dense_shapes[s0:]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in launchers.values():
        fn.launches = 0
    t_run = time.perf_counter()
    for s in range(8):                       # turn 1
        loop.submit(s, prompts[s], decode_tokens=16,
                    sampling=sampling.get(s))
    drive()
    for s in range(8):                       # turn 2
        new = rng.integers(1, cfg.vocab_size, int(rng.integers(16, 65)))
        if swa and s == 0:                   # on past the window
            new = rng.integers(1, cfg.vocab_size, 1024)
        if engine._paged and engine.arena.index is not None:
            gen = loop.generated[s][:-1]     # tokens whose KV is cached
            loop.close_session(s)
            loop.submit(100 + s, np.concatenate([prompts[s], gen, new]),
                        decode_tokens=16, sampling=sampling.get(100 + s))
        else:
            loop.submit(s, new, decode_tokens=16)
    drive()
    n_requests = 16
    if not engine._paged and not swa:
        for s in range(8):                   # turn 3: grid-sized turns
            loop.submit(s, rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(24, 33))),
                        decode_tokens=16)
        drive()
        n_requests = 24
    wall = time.perf_counter() - t_run
    launches = {name: fn.launches for name, fn in launchers.items()}
    rep = loop.tracker.report(wall)
    st = engine.stats()
    prefill_s = sum(dt for dt, k in ticks if k == "prefill")
    decode_s = sum(dt for dt, k in ticks if k == "decode")
    n_pre = sum(1 for _, k in ticks if k == "prefill")
    n_dec = sum(1 for _, k in ticks if k == "decode")
    # prompt tokens through packed steps and through dense grid steps
    # (the dense executor also counts the rows of dense decode steps,
    # which only slot_dense_decode runs)
    assert ("decode" in st["dense_dispatches_by_cause"]) == (
        mode in ("slot_dense_decode", "swa_dense"))
    prefill_tokens = (st.get("packed_useful_tokens", 0) + st["useful_tokens"]
                      - dense_decode_rows[0])
    decode_rows = st.get("decode_useful_rows", 0) + dense_decode_rows[0]
    finite = all(bool(np.isfinite(x).all())
                 for x in engine.last_logits.values())
    if spec:
        # verify ticks run on the packed executor: their stream tokens
        # are not prefill, their committed tokens are the decode rows
        prefill_tokens -= spec_ticks["stream"]
        decode_rows += spec_ticks["tokens"]
        finite = all(0 <= t < cfg.vocab_size for g in loop.generated.values()
                     for t in g)
    if engine._paged:
        engine.arena.audit()
    assert rep.n == n_requests and rep.abandoned == 0, \
        f"{mode}: unanswered requests"
    gs = _graphs_replayed(engine, mode)
    assert all(launches[k] > 0 for k in _mode_kernels(cfg, mode)), \
        f"{mode}: a kernel of its path never launched: {launches}"
    assert finite, f"{mode}: non-finite logits"
    if engine._paged and engine.arena.index is not None:
        assert st["prefix_hit_tokens"] > 0, "no radix prefix hit"
    for name in WIDTH_KERNELS:
        # every launch of an attention kernel at the config's head width
        # (the @d counters, counted as the @window ones are)
        at_width = launches.get(f"{name}@d{cfg.hdim}", 0)
        assert at_width == launches[name], \
            f"{mode}: {name}@d{cfg.hdim} {at_width} of {launches[name]}"
    if swa:
        # the long session past the window and the depth; every launch
        # of a windowed attention kernel its windowed form
        assert engine.history(0) > cfg.sliding_window + 256
        for name in MODE_KERNELS[mode]:
            if name.endswith("@window"):
                base = name.split("@")[0]
                assert launches[name] == launches[base] > 0, \
                    f"{mode}: {name} {launches[name]} of {launches[base]}"
    if ssm:
        # one scan per SSM layer in every prefill dispatch, none in decode
        n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
        assert ssd_split["decode"] == 0, f"{mode}: ssd_scan in a decode tick"
        assert ssd_split["prefill"] == n_ssm * ssd_split[
            "dispatches"], f"{mode}: ssd_scan launches {ssd_split}"
        # a hybrid's every scan at its groups (jamba: 8)
        assert launches["ssd_scan@grouped"] == (
            launches["ssd_scan"] if cfg.family == "hybrid" else 0), launches
        if engine._paged:
            assert adopted[0] > 0, f"{mode}: no state checkpoint adopted"
    if mode in ("slot_dense", "slot_dense_decode"):
        assert policy.awd.graph_hits > 0, "the (L, B) grid was never hit"
    if mode == "slot_arena":
        assert st["arena_gathers"] == st["dense_dispatches"], \
            "an arena-resident step copied whole slots"
    spec_row = None
    if spec:
        assert st["spec_dispatches"] > 0, "spec: no verify dispatch"
        assert st["logits_rows_shipped"] == 0, \
            f"spec: {st['logits_rows_shipped']} logits rows shipped"
        assert st["fused_sample_steps"] > 0
        px = engine.packed_executor
        segs = st["spec_committed"] - st["tokens_accepted"]
        spec_row = {
            # committed tokens per verify dispatch (over all its
            # sessions) and per verify segment (one session's walk)
            "tokens_per_dispatch": st["spec_tokens_per_dispatch"],
            "tokens_per_segment": st["spec_committed"] / max(1, segs),
            "acceptance": st["spec_acceptance"],
            "drafted": st["tokens_drafted"],
            "dispatches": st["spec_dispatches"],
            # rows each verify dispatch gathers (every stream row x
            # (k + 1)) and the live ones: each verify segment's pending
            # token and drafts
            "verify_rows_per_dispatch": px.verify_rows
            / max(1, px.verify_steps),
            "live_verify_rows_per_dispatch": (st["tokens_drafted"] + segs)
            / max(1, st["spec_dispatches"]),
            "fused_sample_per_tick": launches["fused_sample"]
            / max(1, n_pre + n_dec),
        }
    return {
        "spec": spec_row,
        "ttft_mean_ms": rep.mean_ttft * 1e3, "ttft_p90_ms": rep.p90_ttft * 1e3,
        "prefill_tok_s": prefill_tokens / max(prefill_s, 1e-9),
        "decode_tok_s": decode_rows / max(decode_s, 1e-9),
        "prefill_s_per_tick": prefill_s / max(1, n_pre),
        "decode_s_per_tick": decode_s / max(1, n_dec),
        # whole-slot copies (each gather is scattered back in its tick)
        "gathers_per_prefill_tick": gathers["prefill"] / max(1, n_pre),
        "gathers_per_decode_tick": gathers["decode"] / max(1, n_dec),
        "wall_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "ssd_per_prefill_tick": ssd_split["prefill"] / max(1, n_pre),
        "ssd_per_decode_tick": ssd_split["decode"] / max(1, n_dec),
        "ssd_per_prefill_dispatch": ssd_split["prefill"]
        / max(1, ssd_split["dispatches"]),
        "state_checkpoints": st["state_checkpoints"],
        "checkpoints_adopted": adopted[0],
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "ticks": (n_pre, n_dec),
        "prefill_log": prefill_log,
        "graphs": gs["graphs"], "capture_s": gs["capture_seconds"],
        "replays_per_prefill_tick": replays["prefill"] / max(1, n_pre),
        "replays_per_decode_tick": replays["decode"] / max(1, n_dec),
        "warmup_launches": _warmup_launches(engine),
        "schedule": (n_pre, n_dec, prefill_tokens, decode_rows,
                     st["prefix_hit_tokens"], st["arena_gathers"],
                     st["dense_dispatches"], policy.awd.graph_hits,
                     tuple(sorted(launches.items()))),
    }


def phase_full(seed, card, arch, kept, layers=None):
    """Phase 4: ``arch`` at full width through each mode of ``kept``
    ({mode: kept runs}), its depth cut to ``layers`` where given.
    Returns {kernel: (launches, ticks of its mode, mode)} from each
    kernel's first mode's first kept run."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config(arch)
    cut = ""
    if layers is not None:
        cut = f" (depth cut from {cfg.num_layers})"
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[4] {arch} {cfg.num_layers} layers{cut} d_model {cfg.d_model} "
        f"{cfg.dtype}: weights ready in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if "ssm_paged" in kept:
        from repro_torch.models.transformer import init_cache
        page = sum(a[:, 0].numel() * a.element_size()
                   for c in init_cache(cfg, 1, SSM_POOL["page_size"],
                                       device=DEVICE) for a in c.values())
        log(f"[4] ssm_paged pool: {SSM_POOL['num_pages']} pages of "
            f"{SSM_POOL['page_size']} tokens + the scratch page, "
            f"{page / 1e6:.1f} MB each (one state slot of every SSM "
            f"layer, a page of KV of every attention layer), "
            f"{(SSM_POOL['num_pages'] + 1) * page / 1e9:.2f} GB")
    launches = {}
    for mode, n_runs in kept.items():
        results = []
        for i in range(n_runs + 1):      # run 0 warms up and is not kept
            r = _serve_once(cfg, params, seed, mode)
            gc.collect()
            (n_pre, n_dec, ptok, drows, hits, gathers, dense, graph_hits,
             _) = r["schedule"]
            ran = {k: v for k, v in r["launches"].items() if v}
            log(f"[4] {mode} run {i}: TTFT mean {r['ttft_mean_ms']:.1f} ms "
                f"p90 {r['ttft_p90_ms']:.1f} ms; prefill {ptok} tokens in "
                f"{n_pre} ticks, {r['prefill_tok_s']:.0f} tokens/s; decode "
                f"{drows} rows in {n_dec} ticks, {r['decode_tok_s']:.0f} "
                f"tokens/s; wall {r['wall_s']:.2f} s; gathers {gathers} "
                f"dense steps {dense} grid hits {graph_hits} prefix hits "
                f"{hits}; peak {r['peak_gib']:.2f} GiB; launches {ran}"
                f"{' (warm-up, not kept)' if i == 0 else ''}")
            log(f"[4] {mode} run {i}: {r['graphs']} step graphs captured "
                f"in {r['capture_s']:.2f} s (warm-up + capture), graph "
                f"replays per prefill / decode tick "
                f"{r['replays_per_prefill_tick']:.2f} / "
                f"{r['replays_per_decode_tick']:.2f}, warm-up launches "
                f"(in the counts above) {r['warmup_launches']}; peak "
                f"{r['peak_gib']:.2f} GiB (card {card})")
            if ran.get("ragged_prefill_paged"):
                # the paged prefill launches per prefill tick and how many
                # of them took the TMA-fed core, the graphs' warm-ups
                # taken out
                warm = r["warmup_launches"]
                pre, tma = (ran.get(k, 0) - warm.get(k, 0) for k in (
                    "ragged_prefill_paged", "ragged_prefill_paged@tma"))
                n_pre = max(1, r["ticks"][0])
                log(f"[4] {mode} run {i}: ragged_prefill_paged launches "
                    f"per prefill tick {pre / n_pre:.2f}, on the TMA-fed "
                    f"core {tma / n_pre:.2f} (tma.launches {tma} of {pre},"
                    f" warm-ups aside)")
            if mode in SSM_MODES:
                grouped = r["launches"]["ssd_scan@grouped"]
                log(f"[4] {arch} {mode} run {i}: ssd_scan launches per "
                    f"prefill tick {r['ssd_per_prefill_tick']:.2f}, per "
                    f"prefill dispatch {r['ssd_per_prefill_dispatch']:.2f} "
                    f"({grouped} of {r['launches']['ssd_scan']} at G "
                    f"{cfg.ssm_n_groups} > 1), per decode-only tick "
                    f"{r['ssd_per_decode_tick']:.2f}; state checkpoints "
                    f"{r['state_checkpoints']}, adopted by "
                    f"{r['checkpoints_adopted']} prefix matches "
                    f"({r['prefix_hit_tokens']} prefix-hit tokens); "
                    f"whole-slot gathers per prefill / decode tick "
                    f"{r['gathers_per_prefill_tick']:.2f} / "
                    f"{r['gathers_per_decode_tick']:.2f}")
            if cfg.family == "hybrid" or cfg.num_experts > 8:
                # the attention launches per tick of the kernel's kind
                # (a hybrid's few attention layers; qwen3-moe's GQA
                # group of 8), the graphs' warm-ups taken out
                n_pre, n_dec = r["ticks"]

                def per_tick(name):
                    n = (r["launches"][name]
                         - r["warmup_launches"].get(name, 0))
                    return n / max(1, n_dec if name.startswith("decode")
                                   else n_pre)

                attn = MODE_KERNELS[HYBRID_ATTN_MODE.get(mode, mode)]
                log(f"[4] {arch} {mode} run {i}: attention launches per "
                    f"tick of their kind, warm-ups aside: " + ", ".join(
                        f"{name} {per_tick(name):.2f}" for name in attn)
                    + f"; peak {r['peak_gib']:.2f} GiB (card {card})")
            if i == 1 and mode in ("slot_dense", "slot_dense_decode"):
                log(f"[4] {mode} run {i}: prefill ticks, ms and the (L, B) "
                    f"of their dense grid steps: " + ", ".join(
                        f"{dt * 1e3:.1f} {shapes}"
                        for dt, shapes in r["prefill_log"]))
            if r["spec"] is not None:
                sr = r["spec"]
                log(f"[4] {mode} run {i}: {sr['dispatches']} verify "
                    f"dispatches, {sr['tokens_per_dispatch']:.3f} tokens "
                    f"per dispatch, {sr['tokens_per_segment']:.3f} per "
                    f"session segment, acceptance {sr['acceptance']:.3f} "
                    f"({sr['drafted']} drafted), verify rows per dispatch "
                    f"{sr['live_verify_rows_per_dispatch']:.2f} live of "
                    f"{sr['verify_rows_per_dispatch']:.0f} gathered, "
                    f"fused_sample launches per tick "
                    f"{sr['fused_sample_per_tick']:.3f}")
            if i:
                results.append(r)
        same = len({r["schedule"] for r in results}) == 1
        log(f"[4] {mode}: {n_runs} kept runs after the warm-up, schedule "
            f"identical across them: {same} (card {card})")
        for key, unit in [("ttft_mean_ms", "ms"), ("ttft_p90_ms", "ms"),
                          ("prefill_tok_s", "tokens/s"),
                          ("decode_tok_s", "tokens/s"),
                          ("prefill_s_per_tick", "s"),
                          ("decode_s_per_tick", "s"),
                          ("gathers_per_prefill_tick", ""),
                          ("gathers_per_decode_tick", ""),
                          ("capture_s", "s"), ("graphs", ""),
                          ("peak_gib", "GiB"), ("wall_s", "s")]:
            xs = [r[key] for r in results]
            log(f"[4] {mode} {key}: median {float(np.median(xs)):.4f} "
                f"{unit}, min {min(xs):.4f} max {max(xs):.4f} over "
                f"{n_runs} runs")
        n_pre, n_dec = results[0]["schedule"][:2]
        for name in _mode_kernels(cfg, mode):
            if name not in launches:
                n = results[0]["launches"][name]
                ticks = (n_pre + n_dec if name == "fused_sample" else
                         n_dec if name.startswith("decode") else n_pre)
                launches[name] = (n, ticks, mode)
            # a ragged kernel's non-causal launches in the same run: a
            # causal model's path takes none
            nc = f"{name}@nc"
            if nc in results[0]["launches"] and nc not in launches:
                launches[nc] = (results[0]["launches"][nc], n_pre, mode)
    return launches


ENCODER_CLIPS, ENCODER_FRAMES = 8, 1500   # 30 s of audio at 50 frames/s


def phase_encoder(seed, card, runs=3):
    """hubert-xlarge at full width (48 layers, bf16, random weights from
    the seed) over ENCODER_CLIPS clips of ENCODER_FRAMES random frame
    embeddings (the frontend is a stub, as in the reference): one
    warm-up forward, then ``runs`` timed ones with every kernel's count
    set to 0 just before them and read just after — ``flash_attn`` once
    per layer per forward and no other kernel; finite logits; ms per
    batch and frames/s."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    cfg = get_config("hubert-xlarge")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 8)
    emb = torch.randn((ENCODER_CLIPS, ENCODER_FRAMES, cfg.d_model),
                      generator=gen, device=DEVICE).to(cfg.torch_dtype)
    with torch.no_grad():
        tr.forward(params, cfg, embeds=emb)          # warm-up
    torch.cuda.synchronize()
    launchers = _launchers()
    for fn in launchers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(runs):
        t = time.perf_counter()
        with torch.no_grad():
            logits = tr.forward(params, cfg, embeds=emb)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = {name: fn.launches for name, fn in launchers.items()}
    finite = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    ms = float(np.median(secs)) * 1e3
    frames = ENCODER_CLIPS * ENCODER_FRAMES
    log(f"[4] hubert-xlarge {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, {ENCODER_CLIPS} clips x {ENCODER_FRAMES} frames: "
        f"{ms:.1f} ms per batch (median of {runs}; min {min(secs) * 1e3:.1f}"
        f" max {max(secs) * 1e3:.1f}), {frames / ms * 1e3:.0f} frames/s, "
        f"flash_attn launches {launches['flash_attn']} "
        f"({launches['flash_attn'] / runs:.0f} per forward), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, logits "
        f"{tuple(logits.shape)} finite={finite} (card {card})")
    assert finite, "hubert-xlarge: non-finite logits"
    assert launches["flash_attn"] == cfg.num_layers * runs, launches
    assert all(n == 0 for k, n in launches.items() if k != "flash_attn"), \
        launches


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


def _time_graph(fn, iters=20):
    """Device ms per call of ``fn``, a launch that reads nothing back:
    ``iters`` calls captured in one CUDA graph and replayed between two
    events, so the host's launch overhead, which exceeds a short decode
    kernel's run, is not what is timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# phase 4's uneven decode tick: the long prompt's session beside the
# seven short ones
UNEVEN_TICK = [2100, 96, 128, 160, 192, 224, 256, 112]


def _time_decode(name, fn, plain, args, kg, vg, lengths, errs, index_bytes,
                 check_library=False):
    """Hold one decode kernel call to its plain version, then time the
    kernel and the library yardstick — one SDPA call over each row's keys
    ``kg``, ``vg`` (B, max length, Hkv, D), gathered and head-expanded
    beforehand (not timed), masked past each length — from a CUDA graph
    (``_time_graph``), and the plain version launched eagerly.  The
    kernel launched eagerly is logged too: the host's launch time.
    Bytes: q and out, each row's keys and values once, and
    ``index_bytes`` of tables and lengths.  ``check_library``: first hold
    the SDPA call to the kernel's output (the same function).  Logs the
    achieved GB/s beside the bound's; returns the phase-5 row."""
    import torch.nn.functional as F
    q = args[0]
    got = fn(*args)
    err, worst, ok, _ = _held(got, plain, *args)
    errs.setdefault((name.split()[0], q.dtype), []).append(err)
    log(f"[5] {name} {len(lengths)} rows x {lengths[:3]}.. keys: "
        f"max_abs_err={err:.3e} err/bound={worst:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, f"{name} at main-path shapes"
    b, hq, d = q.shape
    rep = hq // kg.shape[2]
    ks, vs = (a.repeat_interleave(rep, 2).transpose(1, 2) for a in (kg, vg))
    mask = None
    if len(set(lengths)) > 1:
        mask = (torch.arange(kg.shape[1], device=DEVICE)[None, :]
                < _i32(lengths)[:, None])[:, None, None, :]
    if check_library:
        lib = F.scaled_dot_product_attention(q[:, :, None], ks, vs,
                                             attn_mask=mask)[:, :, 0]
        lib_err = float((lib.float() - got.float()).abs().max())
        log(f"[5] {name}: SDPA over the same keys within {lib_err:.3e} of "
            f"the kernel")
        assert lib_err <= TOL[q.dtype], f"{name}: SDPA {lib_err}"
    el = q.element_size()
    row = dict(
        ms=_time_graph(lambda: fn(*args)),
        plain_ms=_time(lambda: plain(*args), 3),
        library_ms=_time_graph(lambda: F.scaled_dot_product_attention(
            q[:, :, None], ks, vs, attn_mask=mask)),
        flops=4 * sum(lengths) * d * hq,
        bytes=(2 * b * hq * d + 2 * sum(lengths) * kg.shape[2] * d) * el
        + index_bytes)
    eager_ms = _time(lambda: fn(*args))
    bound = row["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"[5] {name}: kernel {row['ms']:.4f} ms at "
        f"{row['bytes'] / row['ms'] / 1e6:.0f} GB/s ({eager_ms:.4f} ms "
        f"a call launched one by one), SDPA "
        f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; "
        f"bound {bound:.4f} ms at {HBM_BYTES_PER_S / 1e9:.0f} GB/s "
        f"({row['bytes'] / 1e6:.2f} MB), kernel / bound "
        f"{row['ms'] / bound:.2f}")
    return row


# phase 5's windowed decode tick at mixtral's layout: rows past the
# window and the depth beside rows inside it
WINDOW_DECODE_TICK = [7168, 4352, 6000, 12000, 3000, 4097, 200, 96]


def _time_window(gen, rng, errs):
    """The four windowed forms timed at phase 2's main-path shape for
    mixtral (window 4096, C_l 256, bf16): the paged and arena prefill
    kernels over the 4096 stream of WINDOW_CASES, the decode kernels
    over WINDOW_DECODE_TICK.  The bound counts only the keys inside each
    row's window; the yardstick is one SDPA call over the same in-window
    keys gathered contiguously beforehand (not timed) and head-expanded
    — a block mask for the stream, a length mask for the decode rows.
    The port never calls it."""
    import torch.nn.functional as F
    dt, el = torch.bfloat16, 2
    window = max(WINDOW_CASES)                       # mixtral's
    margin, lens, hists, _ = WINDOW_CASES[window]
    out = {}
    for layout in ("ring", "rolling"):
        (pf, pplain, df, dplain), (pre, dcd) = _window_kernels(layout,
                                                               window)
        args, _ = _window_stream(window, dt, gen, rng, layout)
        q, kp, vp, index = args[:4]
        depth = window + margin
        if layout == "ring":
            depth = -(-depth // PS) * PS

        def phys(index, b, pos):
            """Storage row of row b's positions ``pos`` (numpy)."""
            idx = index.cpu().numpy()
            if layout == "ring":
                return idx[b, (pos // PS) % idx.shape[1]] * PS + pos % PS
            return idx[b] * depth + pos % depth

        kflat, vflat = kp.reshape(-1, HKV, D), vp.reshape(-1, HKV, D)
        got = pf(*args)
        plain_args = (q, kp.nan_to_num(1000.0), vp.nan_to_num(1000.0),
                      index) + args[4:]
        err, worst, ok, _ = _held(got, pplain, *plain_args)
        errs.setdefault((pre + "@window", dt), []).append(err)
        assert ok, f"{pre} window {window} at main-path shapes"
        # each segment's in-window keys, contiguous, and each row's band
        kcat, vcat, bands, k0 = [], [], [], 0
        for b, (n, h) in enumerate(zip(lens, hists)):
            kv = h + n
            lo = max(0, kv - depth, h - window + 1)
            rows = torch.as_tensor(phys(index, b, np.arange(lo, kv)),
                                   device=DEVICE).long()
            kcat.append(kflat[rows])
            vcat.append(vflat[rows])
            qpos = torch.arange(h, kv, device=DEVICE)[:, None]
            kpos = torch.arange(lo, kv, device=DEVICE)[None, :]
            bands.append((k0, kv - lo, (kpos <= qpos)
                          & (kpos > qpos - window)))
            k0 += kv - lo
        n_rows = sum(lens)
        mask = torch.zeros((n_rows, k0), dtype=torch.bool, device=DEVICE)
        r0 = 0
        for (c0, n_k, band), n in zip(bands, lens):
            mask[r0:r0 + n, c0:c0 + n_k] = band
            r0 += n
        rep = HQ // HKV
        qs = q[:n_rows].transpose(0, 1)[None]
        ks = torch.cat(kcat).repeat_interleave(rep, 1).transpose(0, 1)[None]
        vs = torch.cat(vcat).repeat_interleave(rep, 1).transpose(0, 1)[None]
        t = q.shape[0]
        # the yardstick computes the same function
        lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        lib_err = float((lib[0].transpose(0, 1).float()
                         - got[:n_rows].float()).abs().max())
        assert lib_err <= TOL[dt], f"{pre}@window: SDPA {lib_err}"
        log(f"[5] {pre}@window {t} stream rows, kv "
            f"{[h + n for h, n in zip(hists, lens)]} over a {layout} of "
            f"{depth} positions: max_abs_err={err:.3e} err/bound="
            f"{worst:.3f}; {k0} in-window keys, SDPA over them within "
            f"{lib_err:.3e} of the kernel")
        out[pre + "@window"] = dict(
            ms=_time(lambda: pf(*args)),
            plain_ms=_time(lambda: pplain(*plain_args), 3),
            library_ms=_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)),
            flops=4 * int(mask.sum()) * D * HQ,
            bytes=(2 * t * HQ * D + 2 * k0 * HKV * D) * el
            + 4 * (index.numel() + 3 * len(lens) + 1))
        # decode: each row's newest min(window, depth, length) keys
        lengths = WINDOW_DECODE_TICK
        kp, vp, k, v, index = _window_storage(gen, rng, layout, window
                                              + margin, lengths, dt)
        qd = torch.randn((len(lengths), HQ, D), generator=gen,
                         device=DEVICE).to(dt)
        inwin = [min(n, window, depth) for n in lengths]
        kflat, vflat = k.reshape(-1, HKV, D), v.reshape(-1, HKV, D)
        # each row's in-window positions, padded to the longest with
        # positions the length mask drops
        rows = torch.as_tensor(np.stack([
            phys(index, b, np.arange(n - m, n - m + max(inwin)) % n)
            for b, (n, m) in enumerate(zip(lengths, inwin))]),
            device=DEVICE).long()
        kg, vg = kflat[rows], vflat[rows]          # (B, max in-window, ...)
        pages = sum(-(-m // PS) + 1 for m in inwin)
        out[dcd + "@window"] = _time_decode(
            dcd + "@window", df, dplain, (qd, k, v, index, _i32(lengths)),
            kg, vg, inwin, errs,
            4 * (pages if layout == "ring" else len(lengths)) + 4 * len(
                lengths))
    return out


def _time_widths(gen, rng, errs):
    """The six paged, arena and gathered attention kernels at
    stablelm-1.6b's 64 and phi-3-vision's 96 (32 / 32 heads, bf16), at
    the main path's shapes: the 512-row chunk at history 1536 over 2048
    keys in an 8-row stream (the other segments empty) through each
    prefill kernel (page pool, 8-slot x 4096 arena, the segment's slot
    gathered), and decode at 8 rows x 2048 keys through each decode
    kernel (from a CUDA graph).  Each is held to its plain version, and
    the yardstick, one SDPA call over the same keys, to the kernel's
    output.  Returns {"<kernel>@d<D>": phase-5 row}."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import ragged_prefill as rp
    dt, el, hq, hkv = torch.bfloat16, 2, 32, 32
    b_rows, keys, rows = 8, 2048, 512
    hist, p_max, s_max = keys - rows, 4096 // PS, 4096
    out = {}
    for d in ROW_WIDTHS:
        n_pages = b_rows * p_max
        kp = torch.randn((n_pages + 1, PS, hkv, d), generator=gen,
                         device=DEVICE).to(dt)
        vp = torch.randn((n_pages + 1, PS, hkv, d), generator=gen,
                         device=DEVICE).to(dt)
        tables = np.stack([rng.permutation(n_pages)[:p_max]
                           for _ in range(b_rows)]).astype(np.int32)
        # prefill: the chunk in segment 0, its keys on segment 0's pages,
        # in slot 3 of the arena, and as row 0 of the gathered cache
        cu = [0] + [rows] * b_rows
        q_off = [hist] + [0] * (b_rows - 1)
        kvl = [keys] + [0] * (b_rows - 1)
        seg = (_i32(cu), _i32(q_off), _i32(kvl))
        q = torch.randn((rows, hq, d), generator=gen, device=DEVICE).to(dt)
        kpos = tables[0, :keys // PS]
        kg = kp[kpos].reshape(keys, hkv, d)
        vg = vp[kpos].reshape(keys, hkv, d)
        ka = torch.zeros((b_rows, s_max, hkv, d), dtype=dt, device=DEVICE)
        va = torch.zeros_like(ka)
        ka[3, :keys], va[3, :keys] = kg, vg
        slot_map = [3] + [0] * (b_rows - 1)
        kc, vc = ka[slot_map].contiguous(), va[slot_map].contiguous()
        qs, ks, vs = (q.transpose(0, 1)[None], kg.transpose(0, 1)[None],
                      vg.transpose(0, 1)[None])
        mask = (torch.arange(keys, device=DEVICE)[None, :]
                <= hist + torch.arange(rows, device=DEVICE)[:, None])
        attended = sum(hist + r + 1 for r in range(rows))
        lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)[0]
        lib = lib.transpose(0, 1)
        for name, fn, plain, args, index_bytes in (
                ("ragged_prefill_paged", rp.ragged_prefill_paged,
                 rp.ragged_prefill_paged_plain,
                 (q, kp, vp, _i32(tables)) + seg, 4 * tables.size),
                ("ragged_prefill_arena", rp.ragged_prefill_arena,
                 rp.ragged_prefill_arena_plain,
                 (q, ka, va, _i32(slot_map)) + seg, 4 * b_rows),
                ("ragged_prefill_attn", rp.ragged_prefill_attn,
                 rp.ragged_prefill_attn_plain, (q, kc, vc) + seg, 0)):
            got = fn(*args)
            err, worst, ok, _ = _held(got, plain, *args)
            lib_err = float((lib.float() - got.float()).abs().max())
            errs.setdefault((f"{name}@d{d}", dt), []).append(err)
            log(f"[5] {name}@d{d} {rows} rows at history {hist} over "
                f"{keys} keys, {hq}/{hkv} heads: max_abs_err={err:.3e} "
                f"err/bound={worst:.3f}; SDPA over the same keys within "
                f"{lib_err:.3e} of the kernel {'ok' if ok else 'FAIL'}")
            assert ok and lib_err <= TOL[dt], f"{name}@d{d} at main-path shapes"
            out[f"{name}@d{d}"] = dict(
                ms=_time(lambda: fn(*args)),
                plain_ms=_time(lambda: plain(*args), 3),
                library_ms=_time(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask)),
                flops=4 * attended * d * hq,
                bytes=(2 * rows * hq * d + 2 * keys * hkv * d) * el
                + index_bytes + 4 * (3 * b_rows + 1))
        # decode: 8 rows x 2048 keys, each row's keys on its own pages,
        # in its own slot, in its own cache row
        lengths = [keys] * b_rows
        qd = torch.randn((b_rows, hq, d), generator=gen, device=DEVICE).to(dt)
        kd = kp[tables[:, :keys // PS]].reshape(b_rows, keys, hkv, d)
        vd = vp[tables[:, :keys // PS]].reshape(b_rows, keys, hkv, d)
        ka, va = torch.zeros_like(ka), torch.zeros_like(va)
        ka[:, :keys], va[:, :keys] = kd, vd
        slots = list(range(b_rows))[::-1]
        ka, va = ka[slots].contiguous(), va[slots].contiguous()
        for name, fn, plain, args, index_bytes in (
                ("decode_attn_paged", dec.decode_attn_paged,
                 dec.decode_attn_paged_plain,
                 (qd, kp, vp, _i32(tables), _i32(lengths)),
                 4 * (b_rows * keys // PS + b_rows)),
                ("decode_attn_arena", dec.decode_attn_arena,
                 dec.decode_attn_arena_plain,
                 (qd, ka, va, _i32(slots), _i32(lengths)), 4 * 2 * b_rows),
                ("decode_attn", dec.decode_attn, dec.decode_attn_plain,
                 (qd, kd.contiguous(), vd.contiguous(), _i32(lengths)),
                 4 * b_rows)):
            out[f"{name}@d{d}"] = _time_decode(
                f"{name}@d{d}", fn, plain, args, kd, vd, lengths, errs,
                index_bytes, check_library=True)
    return out


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
    # pools at qwen3-moe-30b-a3b's 4 KV heads (a GQA group of 8), drawn
    # at their first use
    pools = {HKV: (k, v)}

    def pools_at(hkv):
        if hkv not in pools:
            pools[hkv] = _pools(gen, n_pages + 1, dt, hkv=hkv)
        return pools[hkv]

    el = 2                                           # bf16 bytes
    out = {}

    # prefill chunk: 512 rows at history 1536 over 2048 keys, in an
    # 8-row stream (the other segments empty); at qwen3-4b's 32 / 8 heads,
    # qwen2.5-32b's 40 / 8 (3 idle query vectors a 128-vector tile) and
    # qwen3-moe's 32 / 4
    rows, hist = 512, keys - 512
    tab, _ = _layout(rng, n_pages, p_max, [keys], None)
    table = np.full((b_rows, p_max), n_pages, np.int32)
    table[0] = np.where(tab[0] == POISON, n_pages, tab[0])
    cu = [0] + [rows] * b_rows
    q_off = [hist] + [0] * (b_rows - 1)
    kvl = [keys] + [0] * (b_rows - 1)
    for hq, hkv, name in ((HQ, HKV, "ragged_prefill_paged"),
                          (40, HKV, "ragged_prefill_paged (40/8)"),
                          (32, 4, "ragged_prefill_paged (32/4)")):
        kp, vp = pools_at(hkv)
        q = torch.randn((rows, hq, D), generator=gen, device=DEVICE).to(dt)
        args = (q, kp, vp, _i32(table), _i32(cu), _i32(q_off), _i32(kvl))
        got = rp.ragged_prefill_paged(*args)
        err, worst, ok, _ = _held(got, rp.ragged_prefill_paged_plain, *args)
        errs.setdefault(("ragged_prefill_paged", dt), []).append(err)
        log(f"[5] {name} 512 rows over {keys} keys: max_abs_err="
            f"{err:.3e} err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
        assert ok, f"{name} at main-path shapes"
        # the yardstick runs over pre-gathered, head-expanded K/V (the
        # gather is not timed)
        pages = table[0][:keys // PS].tolist()
        kg = kp[pages].reshape(keys, hkv, D).repeat_interleave(hq // hkv, 1)
        vg = vp[pages].reshape(keys, hkv, D).repeat_interleave(hq // hkv, 1)
        qs, ks, vs = (q.transpose(0, 1)[None], kg.transpose(0, 1)[None],
                      vg.transpose(0, 1)[None])
        mask = (torch.arange(keys, device=DEVICE)[None, :]
                <= hist + torch.arange(rows, device=DEVICE)[:, None])
        attended = sum(hist + r + 1 for r in range(rows))
        out[name] = dict(
            ms=_time(lambda: rp.ragged_prefill_paged(*args)),
            plain_ms=_time(lambda: rp.ragged_prefill_paged_plain(*args), 3),
            library_ms=_time(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)),
            flops=4 * attended * D * hq,
            bytes=(2 * rows * hq * D + 2 * keys * hkv * D) * el
            + 4 * (table.size + 3 * b_rows + 1))
        _cp_async_beside(name, out[name], args)

    # a mixed step like qwen3-4b.mixed_closed's: a 256-row chunk at
    # history 4096 beside 15 one-row segments at histories 1024-12287
    segs, _ = TMA_CASES["mixed"]
    q, _, (kc, vc), index, total = _tma_inputs(gen, rng, segs, None, HQ,
                                               HKV)
    margs = (q, kc, vc) + index
    got = rp.ragged_prefill_paged(*margs)
    err, worst, ok, _ = _held(got, rp.ragged_prefill_paged_plain, *margs)
    errs.setdefault(("ragged_prefill_paged", dt), []).append(err)
    log(f"[5] ragged_prefill_paged (mixed tick) {total} rows: max_abs_err="
        f"{err:.3e} err/bound={worst:.3f} {'ok' if ok else 'FAIL'}")
    assert ok, "ragged_prefill_paged at the mixed tick"
    attended = sum(sum(h + r + 1 for r in range(n)) for n, h, _ in segs)
    out["ragged_prefill_paged (mixed tick)"] = dict(
        ms=_time(lambda: rp.ragged_prefill_paged(*margs)),
        plain_ms=_time(lambda: rp.ragged_prefill_paged_plain(*margs), 3),
        # no single SDPA call over fifteen separate caches
        library_ms=None,
        flops=4 * attended * D * HQ,
        bytes=(2 * total * HQ * D + 2 * sum(kv for _, _, kv in segs) * HKV
               * D) * el + 4 * (index[0].numel() + 3 * len(segs) + 1))
    _cp_async_beside("ragged_prefill_paged (mixed tick)",
                     out["ragged_prefill_paged (mixed tick)"], margs)

    # the non-causal form on the same chunk at qwen3-4b's heads: every
    # row attends all 2048 held keys; the yardstick one SDPA call with
    # is_causal=False over the same gathered keys (the same function)
    kp, vp = pools_at(HKV)
    q = torch.randn((rows, HQ, D), generator=gen, device=DEVICE).to(dt)
    args = (q, kp, vp, _i32(table), _i32(cu), _i32(q_off), _i32(kvl))
    nc = dict(causal=False)
    got = rp.ragged_prefill_paged(*args, **nc)
    err, worst, ok, _ = _held(
        got, lambda *a: rp.ragged_prefill_paged_plain(*a, **nc), *args)
    errs.setdefault(("ragged_prefill_paged@nc", dt), []).append(err)
    pages = table[0][:keys // PS].tolist()
    kg = kp[pages].reshape(keys, HKV, D).repeat_interleave(HQ // HKV, 1)
    vg = vp[pages].reshape(keys, HKV, D).repeat_interleave(HQ // HKV, 1)
    qs, ks, vs = (q.transpose(0, 1)[None], kg.transpose(0, 1)[None],
                  vg.transpose(0, 1)[None])
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=False)
    lib_err = (sdpa[0].transpose(0, 1).float() - got.float()).abs().max()
    log(f"[5] ragged_prefill_paged@nc 512 rows over {keys} keys: "
        f"max_abs_err={err:.3e} err/bound={worst:.3f}; SDPA "
        f"(is_causal=False) computes the same function: max diff "
        f"{lib_err.item():.3e} {'ok' if ok else 'FAIL'}")
    assert ok and lib_err.item() <= TOL[dt], \
        "ragged_prefill_paged@nc at main-path shapes"
    out["ragged_prefill_paged@nc"] = dict(
        ms=_time(lambda: rp.ragged_prefill_paged(*args, **nc)),
        plain_ms=_time(lambda: rp.ragged_prefill_paged_plain(*args, **nc),
                       3),
        library_ms=_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=False)),
        flops=4 * rows * keys * D * HQ,
        bytes=(2 * rows * HQ * D + 2 * keys * HKV * D) * el
        + 4 * (table.size + 3 * b_rows + 1))

    # the same kernel at a speculative verify tick's layout: 8 segments
    # of k + 1 = 5 rows, each at history 2043 over 2048 keys (what a
    # decode tick's 8 rows x 2048 keys become under speculation)
    vrows = SPEC_K + 1
    tab8, _ = _layout(rng, n_pages, p_max, [keys] * b_rows, None)
    tab8 = np.where(tab8 == POISON, n_pages, tab8).astype(np.int32)
    qv = torch.randn((b_rows * vrows, HQ, D), generator=gen,
                     device=DEVICE).to(dt)
    vargs = (qv, k, v, _i32(tab8),
             _i32([vrows * i for i in range(b_rows + 1)]),
             _i32([keys - vrows] * b_rows), _i32([keys] * b_rows))
    got = rp.ragged_prefill_paged(*vargs)
    err, worst, ok, _ = _held(got, rp.ragged_prefill_paged_plain, *vargs)
    assert ok, "ragged_prefill_paged at the verify layout"
    verify_ms = _time(lambda: rp.ragged_prefill_paged(*vargs))
    log(f"[5] ragged_prefill_paged at a verify tick ({b_rows} segments x "
        f"{vrows} rows over {keys} keys): {verify_ms:.4f} ms per layer, "
        f"max_abs_err={err:.3e} err/bound={worst:.3f} "
        f"(decode_attn_paged over the same keys: below)")

    # decode: 8 rows x 2048 keys (the JSON row), then the split walk's
    # other shapes: qwen2.5-32b's 40 / 8 heads, qwen3-moe's 32 / 4 (rep 8,
    # the body's kMaxRep), one session decoding alone, and phase 4's
    # uneven tick (one row at ~2100 keys beside seven at 96-256)
    for what, hq, hkv, lengths in (("", HQ, HKV, [keys] * b_rows),
                                   (" (40/8)", 40, HKV, [keys] * b_rows),
                                   (" (32/4)", 32, 4, [keys] * b_rows),
                                   (" (1 row)", HQ, HKV, [keys]),
                                   (" (uneven tick)", HQ, HKV, UNEVEN_TICK)):
        kp, vp = pools_at(hkv)
        tab, _ = _layout(rng, n_pages, p_max, lengths, None)
        tab = np.where(tab == POISON, n_pages, tab).astype(np.int32)
        qd = torch.randn((len(lengths), hq, D), generator=gen,
                         device=DEVICE).to(dt)
        n = max(lengths)
        idx = torch.as_tensor(tab[:, :-(-n // PS)], device=DEVICE).long()
        kg, vg = (a[idx].reshape(len(lengths), -1, hkv, D)[:, :n]
                  for a in (kp, vp))
        pages = sum(-(-x // PS) for x in lengths)
        out["decode_attn_paged" + what] = _time_decode(
            "decode_attn_paged" + what, dec.decode_attn_paged,
            dec.decode_attn_paged_plain,
            (qd, kp, vp, _i32(tab), _i32(lengths)), kg, vg, lengths, errs,
            4 * (pages + len(lengths)))

    # slot arena at phase 2's main-path layout: a 512-row chunk at
    # history 1536 beside a 17-row segment and a decode row, 5 pad
    # segments and 9 tail rows, in an 8-slot x 4096 arena; the gathered
    # baseline's kernel on the same stream over each row's slot copied
    # out; the arena kernel also at 40 / 8 heads
    slot_map, cu, hists, kvl, t, s_max, live = \
        _prefill_layout(rng, "main_path")
    ka, va = _arena(gen, s_max, dt, live)
    index = (_i32(cu), _i32(hists), _i32(kvl))
    kg, vg = (a[_i32(slot_map).long()].contiguous() for a in (ka, va))
    real = [i for i in range(len(kvl)) if cu[i + 1] > cu[i]]
    # the yardstick: one SDPA call over the real rows against the real
    # segments' slot prefixes side by side, each row masked to its own
    # segment's keys up to its position (the same function)
    kcat = torch.cat([ka[slot_map[i], :kvl[i]] for i in real])
    vcat = torch.cat([va[slot_map[i], :kvl[i]] for i in real])
    n_rows = int(cu[real[-1] + 1])
    seg_mask = torch.zeros((n_rows, kcat.shape[0]), dtype=torch.bool,
                           device=DEVICE)
    k0, attended = 0, 0
    for i in real:
        rows_i = torch.arange(cu[i], cu[i + 1], device=DEVICE)
        qpos = hists[i] + rows_i - cu[i]
        kpos = torch.arange(kvl[i], device=DEVICE)
        seg_mask[cu[i]:cu[i + 1], k0:k0 + kvl[i]] = \
            kpos[None, :] <= qpos[:, None]
        attended += int(torch.minimum(qpos + 1, torch.tensor(
            kvl[i], device=DEVICE)).sum().item())
        k0 += kvl[i]
    for hq, suffix in ((HQ, ""), (40, " (40/8)")):
        qa = torch.randn((t, hq, D), generator=gen, device=DEVICE).to(dt)
        qs = qa[:n_rows].transpose(0, 1)[None]
        ks = kcat.repeat_interleave(hq // HKV, 1).transpose(0, 1)[None]
        vs = vcat.repeat_interleave(hq // HKV, 1).transpose(0, 1)[None]
        nbytes = (2 * t * hq * D + 2 * sum(kvl) * HKV * D) * el \
            + 4 * (4 * len(kvl) + 1)
        kernels = [("ragged_prefill_arena", rp.ragged_prefill_arena,
                    rp.ragged_prefill_arena_plain,
                    (qa, ka, va, _i32(slot_map)) + index),
                   ("ragged_prefill_attn", rp.ragged_prefill_attn,
                    rp.ragged_prefill_attn_plain, (qa, kg, vg) + index)]
        for name, fn, plain, args in kernels[:2 if hq == HQ else 1]:
            got = fn(*args)
            err, worst, ok, _ = _held(got, plain, *args)
            errs.setdefault((name, dt), []).append(err)
            log(f"[5] {name}{suffix} {t} stream rows (512 over {kvl[0]} "
                f"keys): max_abs_err={err:.3e} err/bound={worst:.3f} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"{name}{suffix} at main-path shapes"
            out[name + suffix] = dict(
                ms=_time(lambda: fn(*args)),
                plain_ms=_time(lambda: plain(*args), 3),
                library_ms=_time(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=seg_mask)),
                flops=4 * attended * D * hq, bytes=nbytes)

    # slot-arena decode: 8 rows x 2048 keys, one slot each; also at 40 /
    # 8 heads
    s_max, lengths, _ = ARENA_DECODE_CASES["main_path"]
    slots = [int(x) for x in rng.permutation(ARENA_SLOTS)[:len(lengths)]]
    kd, vd = _arena(gen, s_max, dt, dict(zip(slots, lengths)))
    for what, hq in (("", HQ), (" (40/8)", 40)):
        qd = torch.randn((len(slots), hq, D), generator=gen,
                         device=DEVICE).to(dt)
        out["decode_attn_arena" + what] = _time_decode(
            "decode_attn_arena" + what, dec.decode_attn_arena,
            dec.decode_attn_arena_plain,
            (qd, kd, vd, _i32(slots), _i32(lengths)),
            kd[slots, :max(lengths)], vd[slots, :max(lengths)], lengths,
            errs, 4 * 2 * len(slots))
    # fused sampling at phase 4's verify tick: 8 stream rows x (k + 1)
    # = 40 rows over qwen3-4b's 151,936-column vocabulary in bf16, every
    # row sampled as phase 4's sampled sessions are (temperature 0.8,
    # top_k 20, top_p 0.95, one row with a bias)
    from repro_torch.kernels import sampling as ks
    r_rows, vocab = 8 * (SPEC_K + 1), 151936
    host, _ = _sample_batch(rng, r_rows, vocab)
    host[1][:], host[2][:], host[3][:] = 0.8, 20, 0.95
    logits = torch.as_tensor(host[0], device=DEVICE).to(dt)
    sargs = (logits,) + host[1:]
    got = ks.fused_sample(*sargs)
    err, moved, ok = _held_draws(sargs, got)
    errs.setdefault(("fused_sample", dt), []).append(err)
    log(f"[5] fused_sample {r_rows} rows x {vocab}: p_draft max_abs_err="
        f"{err:.3e}, draws moved within {SAMPLE_MARGIN}: {len(moved)} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, "fused_sample at main-path shapes"
    # the same rows alone (R = 1), every row down the whole-row path
    # (top-k off, top_p 0.9), and top_k 1000: past the thread-maxima
    # filter (k <= 256), so the radix select and the block's draw
    wide = tuple(np.array(x) for x in host)
    wide[2][:], wide[3][:] = 0, 0.9
    radix = tuple(np.array(x) for x in host)
    radix[2][:] = 1000
    for name, h, rows in (("fused_sample", host, r_rows),
                          ("fused_sample (1 row)", host, 1),
                          ("fused_sample (whole row)", wide, r_rows),
                          ("fused_sample (top_k 1000)", radix, r_rows)):
        # the per-row inputs as device tensors, as the kernel takes them
        dargs = (logits[:rows],) + tuple(
            torch.as_tensor(x[:rows], device=DEVICE) for x in h[1:])
        if name != "fused_sample":
            err, moved, ok = _held_draws(dargs, ks.fused_sample(*dargs))
            errs.setdefault(("fused_sample", dt), []).append(err)
            log(f"[5] {name}: p_draft max_abs_err={err:.3e}, draws moved "
                f"within {SAMPLE_MARGIN}: {len(moved)} "
                f"{'ok' if ok else 'FAIL'}; paths (predicted from the "
                f"inputs) {sorted(set(_paths(*dargs)))}")
            assert ok, f"{name} at main-path shapes"
        eager = _time(lambda: ks.fused_sample(*dargs))
        out[name] = dict(
            # device time from a CUDA graph of 20 launches, as the decode
            # rows: launched one by one the launcher's host time shows
            ms=_time_graph(lambda: ks.fused_sample(*dargs)),
            plain_ms=_time(lambda: ks.fused_sample_plain(*dargs), 3),
            # no single PyTorch call computes this function
            library_ms=None,
            # bytes: the logits read once, the per-row inputs, the
            # outputs; operations: 6 fp32 per logit (the temperature, and
            # a subtract, an exp and a sum in each of the two softmaxes)
            flops=6 * rows * vocab, flops_rate=FP32_FLOPS,
            bytes=rows * vocab * el + rows * (4 * 5 + 2 * 4 * ks.MAX_BIAS)
            + rows * 12)
        log(f"[5] {name}: launched one by one {eager:.4f} ms a call, from "
            f"a CUDA graph {out[name]['ms']:.4f} ms")
    out["ssd_scan"] = _time_ssd(gen, errs)
    out["ssd_scan@grouped"] = _ssd_prompt_row(gen, errs, "ssd_scan@grouped",
                                              JAMBA_NH, JAMBA_G)
    out.update(_time_dense(gen, errs))
    out.update(_time_flash_bwd(gen, errs))
    out.update(_time_ssd_bwd(gen, errs))
    out.update(_time_window(gen, rng, errs))
    out.update(_time_widths(gen, rng, errs))
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.get("flops_rate", BF16_FLOPS) * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = ("none (no single PyTorch call computes it)"
               if r["library_ms"] is None else
               f"(SDPA over the keys attended) {r['library_ms']:.4f} ms")
        log(f"[5] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, library {lib}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
            f"{r['flops'] / 1e9:.2f} GFLOP), kernel "
            f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s and "
            f"{r['bytes'] / r['ms'] / 1e6:.0f} GB/s against the bound's "
            f"{r['flops'] / r['bound_ms'] / 1e9:.1f} and "
            f"{r['bytes'] / r['bound_ms'] / 1e6:.0f}")
    return out


def _cp_async_beside(name, row, args):
    """Time the cp.async core on a paged call the TMA-fed core takes (the
    ring form at NO_WINDOW: the same steps, the same bits) in the same
    run, and log both."""
    from repro_torch.kernels import ragged_prefill as rp
    t0 = rp.ragged_prefill_paged.tma.launches
    tma = rp.ragged_prefill_paged(*args)
    cp = rp.ragged_prefill_paged(*args, window=NO_WINDOW)
    torch.cuda.synchronize()
    assert rp.ragged_prefill_paged.tma.launches == t0 + 1, name
    assert torch.equal(tma, cp), f"{name}: the two cores differ"
    row["cp_async_ms"] = _time(
        lambda: rp.ragged_prefill_paged(*args, window=NO_WINDOW))
    log(f"[5] {name}: TMA-fed core {row['ms']:.4f} ms, cp.async core "
        f"{row['cp_async_ms']:.4f} ms on the same call (the same bits), "
        f"{row['flops'] / row['ms'] / 1e9:.1f} against "
        f"{row['flops'] / row['cp_async_ms'] / 1e9:.1f} TFLOP/s")


GRID_L, GRID_B, GRID_HIST, GRID_S = 64, 8, 256, 4096


def _time_dense(gen, errs):
    """``flash_attn`` and ``decode_attn`` at the dense paths' shapes in
    bf16, each held to its plain version first: the (L, B) = (64, 8)
    grid step at history 256 over 8 gathered 4096-deep slots (the
    ``flash_attn`` row), hubert-xlarge's non-causal layer over 8 clips
    of 1500 frames at 16 heads of 80 (``flash_attn_encoder``), and the
    dense decode step of 8 rows x 2048 keys in 4096-deep slots; and,
    logged beside them, ``flash_attn`` at phase 4's other grid steps (a
    long prompt's 256-row chunk at history 1792, seven 256-row prompts).
    The plain versions attend over whole slots, masked, as the dense
    path did before the kernels; the library yardstick is one SDPA call over
    the keys each row attends (head-expanded beforehand, not timed).
    Bounds count the keys attended: the grid reads 320 of each slot's
    4096 rows, the decode 2048."""
    import functools

    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.kernels import flash_attn as fl
    dt, el = torch.bfloat16, 2
    rep = HQ // HKV
    rows = {}
    b, l, hist, s = GRID_B, GRID_L, GRID_HIST, GRID_S
    n = hist + l
    q = torch.randn((b, l, HQ, D), generator=gen, device=DEVICE).to(dt)
    k, v = _batch_kv(gen, b, s, HKV, D, [s] * b, dt)
    args = (q, k, v, _i32([hist] * b), _i32([s] * b))
    got = fl.flash_attn(*args)
    err, worst, ok, _ = _held(got, fl.flash_attn_plain, *args)
    errs.setdefault(("flash_attn", dt), []).append(err)
    log(f"[5] flash_attn grid step (L, B) = ({l}, {b}) at history {hist} "
        f"over {s}-deep slots: max_abs_err={err:.3e} err/bound={worst:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, "flash_attn at the grid step"
    mask = (torch.arange(n, device=DEVICE)[None, :]
            <= hist + torch.arange(l, device=DEVICE)[:, None])
    qs = q.transpose(1, 2)
    ks = k[:, :n].repeat_interleave(rep, 2).transpose(1, 2)
    vs = v[:, :n].repeat_interleave(rep, 2).transpose(1, 2)
    attended = b * sum(hist + i + 1 for i in range(l))
    rows["flash_attn"] = dict(
        ms=_time(lambda: fl.flash_attn(*args)),
        plain_ms=_time(lambda: fl.flash_attn_plain(*args), 3),
        library_ms=_time(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)),
        flops=4 * attended * D * HQ,
        bytes=(2 * b * l * HQ * D + 2 * b * n * HKV * D) * el + 4 * 2 * b)

    # the trace's other dense prefill steps: a chunk of the long prompt
    # (256 rows at history 1792, B = 1) and turn 1's seven prompts
    # padded to 256 rows (history 0, B = 7), each over 4096-deep slots
    for what, cb, chist in (("the long prompt's chunk", 1, 1792),
                            ("turn 1's seven prompts", 7, 0)):
        cq = torch.randn((cb, 256, HQ, D), generator=gen,
                         device=DEVICE).to(dt)
        ck, cv = _batch_kv(gen, cb, s, HKV, D, [s] * cb, dt)
        cargs = (cq, ck, cv, _i32([chist] * cb), _i32([s] * cb))
        err, worst, ok, _ = _held(fl.flash_attn(*cargs), fl.flash_attn_plain,
                                  *cargs)
        assert ok, f"flash_attn at {what}"
        k_ms = _time(lambda: fl.flash_attn(*cargs))
        p_ms = _time(lambda: fl.flash_attn_plain(*cargs), 3)
        flops = 4 * cb * sum(chist + i + 1 for i in range(256)) * D * HQ
        log(f"[5] flash_attn at {what} (L, B) = (256, {cb}), history "
            f"{chist} over {s}-deep slots: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms a layer (x 36: {36 * k_ms:.1f} vs "
            f"{36 * p_ms:.1f} ms a tick), {flops / 1e9:.2f} GFLOP, kernel "
            f"{flops / k_ms / 1e9:.1f} TFLOP/s, max_abs_err={err:.3e} "
            f"err/bound={worst:.3f}")

    eb, ef, eh, ed = ENCODER_CLIPS, ENCODER_FRAMES, 16, 80
    qe, ke, ve = (torch.randn((eb, ef, eh, ed), generator=gen,
                              device=DEVICE).to(dt) for _ in range(3))
    eargs = (qe, ke, ve, _i32([0] * eb), _i32([ef] * eb))
    plain = functools.partial(fl.flash_attn_plain, causal=False)
    got = fl.flash_attn(*eargs, causal=False)
    err, worst, ok, _ = _held(got, plain, *eargs)
    errs.setdefault(("flash_attn", dt), []).append(err)
    log(f"[5] flash_attn encoder layer ({eb}, {ef}, {eh}, {ed}) "
        f"non-causal: max_abs_err={err:.3e} err/bound={worst:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, "flash_attn at the encoder layer"
    qt, kt, vt = (x.transpose(1, 2) for x in (qe, ke, ve))
    rows["flash_attn_encoder"] = dict(
        ms=_time(lambda: fl.flash_attn(*eargs, causal=False), 5),
        plain_ms=_time(lambda: plain(*eargs), 2),
        library_ms=_time(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        flops=4 * eb * ef * ef * ed * eh,
        bytes=4 * eb * ef * eh * ed * el + 4 * 2 * eb)

    keys = 2048
    kd, vd = _batch_kv(gen, b, s, HKV, D, [keys] * b, dt)
    for what, hq in (("", HQ), (" (40/8)", 40)):
        qd = torch.randn((b, hq, D), generator=gen, device=DEVICE).to(dt)
        rows["decode_attn" + what] = _time_decode(
            "decode_attn" + what, dec.decode_attn, dec.decode_attn_plain,
            (qd, kd, vd, _i32([keys] * b)), kd[:, :keys], vd[:, :keys],
            [keys] * b, errs, 4 * b)
    return rows


def _ssd_work(b, l, g, chunk=SSD_CHUNK, el=2, lens=None, nh=SSD_NH):
    """(operations, bytes) ``ssd_scan`` needs for one call at mamba2's
    heads: per chunk of n rows the lower triangle of C.B^T once per
    group, and per head the lower triangle of M X, the carried state's
    C state^T and the state update X^T (w B); bytes: x in and y out, B
    and C, dt and a, the state in and out.  ``lens``: each batch row's
    length, dt = 0 past it; a chunk wholly past it is an identity of the
    state, whose y needs only C state^T, and neither its x nor its B."""
    hd, ds = SSD_HD, SSD_DS
    flops = live_rows = 0
    for r in range(b):
        n_r = l if lens is None else lens[r]
        for c0 in range(0, l, chunk):
            n = min(chunk, l - c0)
            if c0 < n_r:
                tri = n * (n + 1) // 2
                flops += 2 * tri * ds * g + nh * (2 * tri * hd
                                                  + 4 * n * hd * ds)
                live_rows += n
            else:
                flops += nh * 2 * n * hd * ds
    nbytes = (live_rows * nh * hd * el + b * l * nh * hd * el
              + (live_rows + b * l) * g * ds * el
              + 4 * b * l * nh + 4 * nh + 2 * 4 * b * nh * hd * ds)
    return flops, nbytes


def _ssd_pairs(what, args, lens=None):
    """Time ``ssd_scan`` and its plain version in turns, SSD_PAIRS times
    each, on the same inputs (held to the plain version first); log the
    medians beside the bound.  Returns (kernel ms, plain ms)."""
    from repro_torch.kernels import ssd_scan as ssd
    err, worst, ok = _held_ssd(args)
    assert ok, f"ssd_scan at the {what}"
    pairs = [(_time(lambda: ssd.ssd_scan(*args, chunk=SSD_CHUNK), 20),
              _time(lambda: ssd.ssd_scan_plain(*args, chunk=SSD_CHUNK), 5))
             for _ in range(SSD_PAIRS)]
    k_ms, p_ms = (float(np.median([p[i] for p in pairs])) for i in (0, 1))
    b, l = args[0].shape[:2]
    flops, nbytes = _ssd_work(b, l, 1, lens=lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[5] ssd_scan {what} (L, B) = ({l}, {b}): kernel {k_ms:.4f} "
        f"ms, plain {p_ms:.4f} ms (medians of {SSD_PAIRS} interleaved "
        f"timings: kernel {[round(p[0], 4) for p in pairs]}, plain "
        f"{[round(p[1], 4) for p in pairs]}), kernel / plain "
        f"{k_ms / p_ms:.3f}, bound {max(t_bytes, flops / BF16_FLOPS * 1e3):.4f}"
        f" ms ({flops / 1e9:.3f} GFLOP: {flops / BF16_FLOPS * 1e3:.4f} ms "
        f"at bf16 tensor-core rate, {flops / FP32_FLOPS * 1e3:.4f} ms at "
        f"fp32; {nbytes / 1e6:.2f} MB: {t_bytes:.4f} ms), "
        f"max_abs_err={err:.3e} err/bound={worst:.3f}")
    return k_ms, p_ms


def _trace_bridge():
    """The packed step's dense bridge as phase 4 builds it for phase 5's
    7-prompt dispatch: the packed executor's own stream rows and token
    bucket (the mamba2 engine of ``phase_ssm_profile``, built at the
    smoke config's widths: neither depends on them) and the prompts'
    lengths, each prompt one row from position 0.  Returns (B, L,
    lengths)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_smoke("mamba2-2.7b")
    engine = Engine(cfg, tr.init_params(cfg, seed=0, device=DEVICE),
                    EngineConfig(num_slots=16, max_len=4096,
                                 chunk_tokens=256, measure=False,
                                 **SSM_MODES["ssm_slot_arena"]),
                    device=DEVICE)
    ex = engine.packed_executor
    b, l = ex.stream_rows, ex.bucket_for(sum(SSM_PROFILE_LENS))
    return b, l, list(SSM_PROFILE_LENS) + [0] * (b - len(SSM_PROFILE_LENS))


def _time_ssd(gen, errs):
    """``ssd_scan`` at main-path shapes of mamba2 in bf16: a 2048-token
    prompt as 8 chunk steps of 256 rows with the state carried, B = 1
    (the JSON row: its device time, from a CUDA graph of the 8 steps, as
    ``_time_graph`` times the decode rows — launched one by one, the
    Python launcher's host time exceeds the kernels'; the one-by-one
    time and each of the call's two CUDA kernels' share, by
    ``torch.profiler``, are logged); then, as medians of interleaved
    kernel / plain timings,
    one dense grid step (L, B) = (64, 8), the packed step's bridge with
    every row real (512, 8), and the bridge as phase 4 builds it for
    phase 5's 7-prompt dispatch (``_trace_bridge``); each held to the
    plain version first.  The bf16 kernel multiplies on the tensor cores
    (bf16 x, B, C exact; fp32 operands as split hi + lo pairs), so the
    bound counts its operations at 989 TFLOP/s; the fp32 rate's bound is
    logged beside it."""
    row = _ssd_prompt_row(gen, errs, "ssd_scan", SSD_NH, 1)
    dt_ = torch.bfloat16
    for what, b, l in (("dense grid step", 8, 64),
                       ("packed step's bridge, every row real", 8, 512)):
        _ssd_pairs(what, _ssd_inputs(gen, b, l, 1, dt_))
    b, l, lens = _trace_bridge()
    _ssd_pairs(f"packed step's bridge as phase 4 builds it (lengths "
               f"{lens[:len(SSM_PROFILE_LENS)]}, {b - len(SSM_PROFILE_LENS)}"
               f" empty rows)", _ssd_inputs(gen, b, l, 1, dt_, lens=lens),
               lens=lens)
    return row


def _ssd_prompt_row(gen, errs, name, nh, g):
    """The kernel row ``name``: ``ssd_scan`` at ``nh`` heads of 64, state
    128, B/C in ``g`` groups, bf16, on a 2048-token prompt as 8 chunk
    steps of 256 rows with the state carried, B = 1 — held to the plain
    version, its device time from a CUDA graph of the 8 steps, the plain
    version's, the bound, and (logged) the one-by-one time and each of
    the call's two CUDA kernels' device share by ``torch.profiler``."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_error_bound
    dt_ = torch.bfloat16
    x, dt, a, bm, cm, h0 = _ssd_inputs(gen, 1, 2048, g, dt_, nh=nh)
    steps = [(x[:, i:i + 256], dt[:, i:i + 256].contiguous(),
              bm[:, i:i + 256], cm[:, i:i + 256]) for i in range(0, 2048, 256)]

    def prompt(fn):
        st, ys = h0, []
        for xs, ds_, bs, cs in steps:
            y, st = fn(xs, ds_, a, bs, cs, st, chunk=SSD_CHUNK)
            ys.append(y)
        return ys, st

    ys, st = prompt(ssd.ssd_scan)
    torch.cuda.synchronize()
    yr, yb, sr, sb = ssd_error_bound(x, dt, a, bm, cm, h0, SSD_CHUNK)
    y = torch.cat(ys, dim=1).float()
    worst = max(float(((y - yr).abs() / yb).max()),
                float(((st - sr).abs() / sb).max()))
    err = float((y - yr).abs().max())
    errs.setdefault((name, dt_), []).append(err)
    log(f"[5] {name} (NH {nh}, G {g}) 2048-token prompt in 8 steps of 256, "
        f"state carried: max_abs_err={err:.3e} err/bound={worst:.3f} "
        f"{'ok' if worst <= 1 else 'FAIL'}")
    assert worst <= 1, f"{name} at the chunked-prompt shapes"
    work = [_ssd_work(1, 256, g, nh=nh) for _ in steps]
    flops, nbytes = (sum(w[i] for w in work) for i in (0, 1))
    eager_ms = _time(lambda: prompt(ssd.ssd_scan), 10)
    row = dict(ms=_time_graph(lambda: prompt(ssd.ssd_scan), 5),
               plain_ms=_time(lambda: prompt(ssd.ssd_scan_plain), 3),
               # no single PyTorch call computes the scan
               library_ms=None, flops=flops, flops_rate=BF16_FLOPS,
               bytes=nbytes)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prompt(ssd.ssd_scan)
        torch.cuda.synchronize()
    split = {re.search(r"ssd_\w+_kernel", e.key).group(0): round((
        getattr(e, "self_device_time_total", 0)
        or getattr(e, "self_cuda_time_total", 0)) / 1e3, 4)
        for e in prof.key_averages() if re.search(r"ssd_\w+_kernel", e.key)}
    log(f"[5] {name} 2048-token prompt: from a CUDA graph {row['ms']:.4f}"
        f" ms, launched one by one {eager_ms:.4f} ms; device ms of the 8 "
        f"calls by kernel {split}; the bound at the fp32 rate (the old "
        f"design's) {flops / FP32_FLOPS * 1e3:.4f} ms")
    return row


# the executors' step methods (each the innermost of its kind, so a
# nested call is timed once)
STEP_METHODS = ("prefill", "decode", "prefill_packed", "prefill_packed_arena",
                "mixed_step_paged", "verify_step_arena", "verify_step_paged",
                "decode_paged")
# the host's launch calls as the profiler names them
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")


def _timed_steps(engine):
    """Wrap every step method of ``engine``'s executors: each call's host
    seconds, and its device span between CUDA events recorded on the
    current stream before and after it, go into the returned list as
    (seconds, start event, end event)."""
    calls = []
    for ex in (engine.executor, engine.packed_executor,
               engine.decode_executor):
        for name in STEP_METHODS if ex is not None else ():
            fn = getattr(ex, name, None)
            if fn is None:
                continue

            def timed(*args, _fn=fn, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                t = time.perf_counter()
                out = _fn(*args, **kw)
                calls.append((time.perf_counter() - t, *ev))
                ev[1].record()
                return out

            setattr(ex, name, timed)
    return calls


def _device_split(prof, wall_ms, what, card, calls=None, engine=None):
    """Log the device time of a profiled region by kernel (the top 8),
    the device-busy share of its wall time, the host's launch calls
    (kernels and graphs) and, given the region's timed step calls
    (``_timed_steps``), the executor calls' host share of the wall time,
    their device span and the graph replays.  Returns ({kernel: device
    ms}, device-busy ms)."""
    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    events = prof.key_averages()
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    n_kernel = sum(e.count for e in events if e.key in KERNEL_LAUNCH_CALLS)
    n_graph = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    n_copy = sum(e.count for e in events if e.key == "cudaMemcpyAsync")
    log(f"[5] profile {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / max(wall_ms, 1e-9):.1f}%, idle "
        f"{100 * (1 - busy / max(wall_ms, 1e-9)):.1f}%); host launches "
        f"{n_kernel + n_graph} ({n_kernel} kernels, {n_graph} graphs), "
        f"{n_copy} async copies (card {card})")
    if calls is not None:
        torch.cuda.synchronize()
        host = sum(c[0] for c in calls) * 1e3
        span = sum(a.elapsed_time(b) for _, a, b in calls)
        gs = getattr(engine, "graph_stats", None)
        log(f"[5] profile {what}: {len(calls)} executor calls, host "
            f"{host:.2f} ms ({100 * host / max(wall_ms, 1e-9):.1f}% of the "
            f"wall), device span {span:.2f} ms; graph replays so far "
            f"{gs()['replays'] if gs else 'none (eager)'} (card {card})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[5]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    # where the host's time goes: the host-side events by self time
    host_ev = [e for e in events if e not in kernels]
    for e in sorted(host_ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        log(f"[5]   host {e.self_cpu_time_total / 1e3:8.3f} ms "
            f"{e.count:6d}x  {e.key[:80]}")
    return {e.key: dev_us(e) / 1e3 for e in kernels}, busy


def _unprofiled(what, card, tick, calls, n=3):
    """Wall ms of ``n`` more ticks of the profiled kind run without the
    profiler (its tracing of every kernel adds host time to a tick), and
    of the executor calls in them (``_timed_steps``' ``calls``): host ms
    and device span."""
    ms, host, span = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        calls.clear()
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        host.append(sum(c[0] for c in calls) * 1e3)
        span.append(sum(a.elapsed_time(b) for _, a, b in calls))
    med = float(np.median(ms))
    log(f"[5] unprofiled {what}: wall {med:.2f} ms, median of {n} "
        f"({', '.join(f'{x:.2f}' for x in ms)}); executor calls host "
        f"{float(np.median(host)):.2f} ms "
        f"({100 * float(np.median(host)) / max(med, 1e-9):.1f}% of the "
        f"wall), device span {float(np.median(span)):.2f} ms (card {card})")


def phase_dense_profile(seed, card):
    """Where a qwen3-4b dense grid tick's time goes (full width, bf16,
    the launcher's slot_dense mode): ``torch.profiler`` over the trace's
    two kinds of grid step — eight 256-token prompts as one (256, 8)
    step, and one 256-token re-prefill at history 1792, a long prompt's
    chunk — each after a warm-up of the same step on other sessions."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_config("qwen3-4b")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    engine = Engine(cfg, params, EngineConfig(
        num_slots=18, max_len=4096, chunk_tokens=256, measure=False,
        **MODES["slot_dense"]), device=DEVICE)
    rng = np.random.default_rng(seed + 9)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def prompts(n, length):
        return [rng.integers(1, cfg.vocab_size, length) for _ in range(n)]

    calls = _timed_steps(engine)
    for base in (0, 8):                  # warm-up on 0..7, then profile
        sess = list(range(base, base + 8))
        calls.clear()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engine.prefill_batch(sess, prompts(8, 256))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if base:
            _device_split(prof, wall, "slot_dense (256, 8) grid step",
                          card, calls, engine)
    for s in (16, 17):                   # warm-up on 16, then profile
        engine.prefill_batch([s], prompts(1, 1792))
        torch.cuda.synchronize()
        calls.clear()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engine.prefill_batch([s], prompts(1, 256))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        if s == 17:
            _device_split(prof, wall, "slot_dense (256, 1) step at "
                          "history 1792", card, calls, engine)
            _unprofiled("slot_dense (256, 1) step at history 2048-2560",
                        card, lambda: engine.prefill_batch(
                            [17], prompts(1, 256)), calls)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_decode_profile(seed, card):
    """Where a qwen3-4b paged decode tick's time goes (full width, bf16,
    the engine default): ``torch.profiler`` over one decode tick of 8
    sessions at phase 4's lengths (UNEVEN_TICK), after a warm-up tick;
    the tick's wall time, the device's busy share and the decode
    kernels' share (the split walk and its combine, ``attn::decode``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attn as dec
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_config("qwen3-4b")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=4096, chunk_tokens=256, measure=False,
        **MODES["paged"]), device=DEVICE)
    rng = np.random.default_rng(seed + 7)
    sess = list(range(len(UNEVEN_TICK)))
    toks = []
    for s, n in zip(sess, UNEVEN_TICK):
        # two decode ticks follow: the profiled one reads n keys
        prompt = rng.integers(1, cfg.vocab_size, n - 2)
        toks.append(engine.prefill_long(s, prompt) if n > 256 else
                    engine.prefill_batch([s], [prompt])[s])
    warm = engine.decode_batch(sess, toks, 1)          # warm-up tick
    toks = [warm[s][-1] for s in sess]
    n0 = dec.decode_attn_paged.launches
    calls = _timed_steps(engine)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode_batch(sess, toks, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = dec.decode_attn_paged.launches - n0
    by_kernel, busy = _device_split(
        prof, wall, f"paged decode tick of {len(sess)} rows at "
        f"{UNEVEN_TICK} keys", card, calls, engine)
    cur = [toks]

    def tick():
        out = engine.decode_batch(sess, cur[0], 1)
        cur[0] = [out[s][-1] for s in sess]

    _unprofiled(f"paged decode tick of {len(sess)} rows", card, tick,
                calls)
    attn_ms = sum(ms for key, ms in by_kernel.items()
                  if "attn::decode" in key)
    log(f"[5] paged decode tick: {n} decode_attn_paged launches, the "
        f"decode kernels {attn_ms:.3f} ms of the device's {busy:.2f} ms "
        f"busy ({100 * attn_ms / max(busy, 1e-9):.1f}%) and of the "
        f"tick's {wall:.2f} ms wall ({100 * attn_ms / wall:.1f}%) "
        f"(card {card})")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()


# phase 5's MoE decode ticks: one session past mixtral's window and the
# ring's depth beside seven short ones (phase 4's shape), and phase 4's
# uneven tick for jamba and qwen3-moe
WINDOW_PROFILE_TICK = [7168, 300, 256, 200, 160, 128, 100, 80]
# (arch, layers, mode, pool, tick, max_len) of each profiled MoE tick
MOE_PROFILES = (
    ("mixtral-8x7b", WINDOW_LAYERS, "swa_paged", {}, WINDOW_PROFILE_TICK,
     8192),
    (HYBRID, HYBRID_LAYERS, "ssm_paged", SSM_POOL, UNEVEN_TICK, 4096),
    (QWEN_MOE, None, "paged", {}, UNEVEN_TICK, 4096))


def _is_expert_stack(path, a):
    return "/ffn/" in path and a.dim() == 4


def phase_moe_profile(seed, card, arch, layers, mode, pool, tick, max_len):
    """Where an MoE decode tick's time goes (bf16, random weights from
    the seed, ``layers`` cuts the depth where given): ``torch.profiler``
    over one 8-row decode tick at ``tick`` keys after a warm-up tick,
    then 3 unprofiled ticks.  The weight read alone bounds it: every
    expert of every MoE layer is read each tick — mixtral's through
    ``moe_dense_reference``, jamba's 16 and qwen3-moe's 128 through
    ``moe_layer``, whose capacity of at least one row puts every expert
    in the step — and the expert stacks' bytes are logged apart."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.models.convert import _leaf_shapes
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    leaves = dict(zip(_leaf_shapes(params), _leaves(params)))
    weight_bytes = sum(a.numel() * a.element_size() for a in leaves.values())
    expert_bytes = sum(a.numel() * a.element_size()
                       for path, a in leaves.items()
                       if _is_expert_stack(path, a))
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=max_len, chunk_tokens=256, measure=False,
        **SERVE_MODES[mode], **pool), device=DEVICE)
    rng = np.random.default_rng(seed + 8)
    sess = list(range(len(tick)))
    toks = []
    for s, n in zip(sess, tick):
        prompt = rng.integers(1, cfg.vocab_size, n - 2)
        toks.append(engine.prefill_long(s, prompt) if n > 256 else
                    engine.prefill_batch([s], [prompt])[s])
    warm = engine.decode_batch(sess, toks, 1)          # warm-up tick
    toks = [warm[s][-1] for s in sess]
    calls = _timed_steps(engine)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode_batch(sess, toks, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel, busy = _device_split(
        prof, wall, f"{arch} ({cfg.num_layers} layers) {mode} decode tick "
        f"of {len(sess)} rows at {tick} keys", card, calls, engine)
    cur = [toks]

    def step():
        out = engine.decode_batch(sess, cur[0], 1)
        cur[0] = [out[s][-1] for s in sess]

    _unprofiled(f"{arch} {mode} decode tick of {len(sess)} rows", card,
                step, calls)
    attn_ms = sum(ms for key, ms in by_kernel.items()
                  if "attn::decode" in key)
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[5] {arch} decode tick: weights {weight_bytes / 2**30:.2f} GiB "
        f"({weight_bytes / 1e9:.1f} GB; the expert stacks "
        f"{expert_bytes / 1e9:.1f} GB, {expert_bytes / HBM_BYTES_PER_S * 1e3:.2f}"
        f" ms), read once a tick: bound {bound:.2f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; device busy {busy:.2f} ms "
        f"({busy / bound:.2f}x the bound); the decode attention kernels "
        f"{attn_ms:.3f} ms ({100 * attn_ms / max(busy, 1e-9):.1f}% of "
        f"busy) (card {card})")
    del engine, params, leaves
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_ssm_profile(seed, card):
    """Where a mamba2-2.7b tick's time goes (full width, bf16):
    ``torch.profiler`` over one packed prefill dispatch of 7 prompts
    (512 tokens, the largest bucket) and one 8-row decode tick on the
    slot arena, and the same prompts as one dense grid prefill; each
    after a warm-up of the same step on other sessions."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_config("mamba2-2.7b")
    params = tr.init_params(cfg, seed=seed, device=DEVICE)
    rng = np.random.default_rng(seed + 6)
    lens = SSM_PROFILE_LENS
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for mode in ("ssm_slot_arena", "ssm_dense"):
        engine = Engine(cfg, params, EngineConfig(
            num_slots=16, max_len=4096, chunk_tokens=256, measure=False,
            **SSM_MODES[mode]), device=DEVICE)
        calls = _timed_steps(engine)
        for base in (0, 8):              # warm-up on 0..6, then profile
            sess = list(range(base, base + 7))
            prompts = [rng.integers(1, cfg.vocab_size, n) for n in lens]
            torch.cuda.synchronize()
            calls.clear()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                first = engine.prefill_batch(sess, prompts)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if base:
                _device_split(prof, wall, f"{mode} prefill of 7 prompts "
                              f"({sum(lens)} tokens)", card, calls, engine)
            rows = sess + [base + 7]
            engine.prefill_batch([base + 7], [rng.integers(
                1, cfg.vocab_size, 30)])
            toks = [first.get(r, 1) for r in rows]
            torch.cuda.synchronize()
            calls.clear()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                engine.decode_batch(rows, toks)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if base:
                _device_split(prof, wall, f"{mode} decode tick of 8 rows",
                              card, calls, engine)
                _unprofiled(f"{mode} decode tick of 8 rows", card,
                            lambda: engine.decode_batch(rows, toks), calls)
        del engine
        gc.collect()


def phase_dense_tick(card, times):
    """Where a dense (L, B) grid tick of the launcher's default goes, at
    full width: copying 8 whole slots out of an 8-slot x 4096 arena and
    back (one gather and one scatter), and one layer's bf16 attention at
    (L, B) = (64, 8), history 256, over the gathered slots — the
    ``flash_attn`` kernel, which walks the 320 keys each row needs,
    beside its plain version over all 4096 positions, the dense path's
    attention before the kernel (``times["flash_attn"]``, phase 5)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kvcache import KVArena
    cfg = get_config("qwen3-4b")
    arena = KVArena(cfg, 8, GRID_S, device=DEVICE)
    slots = list(range(8))
    caches = arena.gather(slots)
    nbytes = sum(a.numel() * a.element_size() for c in caches
                 for a in c.values())
    gather_ms = _time(lambda: arena.gather(slots), 5)
    scatter_ms = _time(lambda: arena.scatter(slots, caches), 5)
    bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3      # read + write
    log(f"[5] dense tick: gather of 8 whole slots {gather_ms:.3f} ms, "
        f"scatter {scatter_ms:.3f} ms ({nbytes / 1e9:.2f} GB each way, "
        f"bound {bound_ms:.3f} ms each) (card {card})")
    del caches, arena
    r, n = times["flash_attn"], cfg.num_layers
    log(f"[5] dense tick: one layer's attention at (L, B) = ({GRID_L}, "
        f"{GRID_B}), history {GRID_HIST}: flash_attn {r['ms']:.4f} ms "
        f"(the {GRID_HIST + GRID_L} keys needed), the plain version over "
        f"all {GRID_S} positions {r['plain_ms']:.3f} ms; x {n} layers: "
        f"{r['ms'] * n:.1f} vs {r['plain_ms'] * n:.1f} ms, beside "
        f"{gather_ms + scatter_ms:.1f} ms of slot copies (card {card})")


# ------------------------------------------ training (phases 2 to 6)

# phase 2's cases of flash_attn's backward: (what, B, Lq, S, Hq, Hkv, D,
# causal, window, q_offsets, kv_lengths, dtypes)
_BOTH = (torch.bfloat16, torch.float32)
BWD_CASES = (
    ("qwen3-4b's training shape", 4, 1024, 1024, 32, 8, 128, True, None,
     [0] * 4, [1024] * 4, _BOTH),
    ("L 1", 2, 1, 1, 32, 8, 128, True, None, [0, 0], [1, 1], _BOTH),
    ("L 63", 2, 63, 63, 32, 8, 128, True, None, [0, 0], [63, 63], _BOTH),
    ("L 65", 2, 65, 65, 32, 8, 128, True, None, [0, 0], [65, 65], _BOTH),
    ("L 1000", 2, 1000, 1000, 32, 8, 128, True, None, [0, 0], [1000, 1000],
     (torch.bfloat16,)),
    ("qwen2.5-32b's 40 / 8 (rep 5)", 2, 300, 300, 40, 8, 128, True, None,
     [0, 0], [300, 300], _BOTH),
    ("D 64", 2, 200, 200, 32, 8, 64, True, None, [0, 0], [200, 200], _BOTH),
    ("D 80", 2, 200, 200, 32, 8, 80, True, None, [0, 0], [200, 200], _BOTH),
    ("D 96", 2, 200, 200, 32, 8, 96, True, None, [0, 0], [200, 200], _BOTH),
    ("hubert's 16 x 80, non-causal", 2, 1500, 1500, 16, 16, 80, False, None,
     [0, 0], [1500, 900], _BOTH),
    ("window 256 over 1024 keys", 2, 1024, 1024, 32, 8, 128, True, 256,
     [0, 0], [1024, 1024], _BOTH),
    ("offsets > 0, kv lengths < S", 2, 300, 600, 32, 8, 128, True, None,
     [100, 250], [400, 520], _BOTH),
    ("a row with no key", 2, 100, 200, 32, 8, 128, True, None, [0, 0],
     [150, 0], _BOTH),
)
LSE_TOL = 1e-4     # |lse - plain|: the same fp32 sums in another order


def _bwd_case(gen, b, lq, s, hq, hkv, d, offs, lens, dt):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dt)
    return (rand(b, lq, hq, d), rand(b, s, hkv, d), rand(b, s, hkv, d),
            rand(b, lq, hq, d), _i32(offs), _i32(lens))


def _bwd_held(got, refs, bounds):
    """(max abs error, the largest error over its bound) of dq, dk, dv."""
    errs = [(g.float() - r).abs() for g, r in zip(got, refs)]
    return (max(e.max().item() for e in errs),
            max((e / bd).max().item() for e, bd in zip(errs, bounds)))


def phase_flash_bwd(seed, errs):
    """``flash_attn`` with its log-sum-exp and ``flash_attn_bwd`` against
    their plain versions at ``BWD_CASES``: the forward's output within
    ``kernel_error_bound``, its lse within ``LSE_TOL`` of the plain
    logsumexp (-inf on exactly the keyless rows), and dq, dk, dv within
    ``ref.flash_attn_bwd_error_bound``.  At the training shape in bf16,
    two runs are bit-identical and the bound bites: the kernel run on a
    dout whose 64-vector query tiles at rows 512.. are zeroed (a dropped
    query tile), and its dk / dv with keys 512..575 zeroed (a dropped key
    tile), each lie outside it."""
    import functools

    from repro_torch.kernels import flash_attn as fl
    from repro_torch.kernels.ref import flash_attn_bwd_error_bound
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 27)
    for what, b, lq, s, hq, hkv, d, causal, window, offs, lens, dts in \
            BWD_CASES:
        for dt in dts:
            q, k, v, do, o, ln = _bwd_case(gen, b, lq, s, hq, hkv, d, offs,
                                           lens, dt)
            kw = dict(causal=causal, window=window)
            out, lse = fl.flash_attn(q, k, v, o, ln, return_lse=True, **kw)
            ferr, fworst, fok, _ = _held(
                out, functools.partial(fl.flash_attn_plain, **kw), q, k, v,
                o, ln)
            lref = fl.flash_attn_lse_plain(q.float(), k.float(), o, ln, **kw)
            fin = torch.isfinite(lref)
            lerr = (lse[fin] - lref[fin]).abs().max().item() \
                if fin.any() else 0.0
            lok = torch.equal(torch.isfinite(lse), fin) and lerr <= LSE_TOL
            got = fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln, **kw)
            refs, bounds = flash_attn_bwd_error_bound(q, k, v, out, lse, do,
                                                      o, ln, **kw)
            err, worst = _bwd_held(got, refs, bounds)
            ok = fok and lok and worst <= 1.0
            errs.setdefault(("flash_attn_bwd", dt), []).append(err)
            errs.setdefault(("flash_attn@lse", dt), []).append(ferr)
            log(f"[2] flash_attn_bwd {what} (B {b}, Lq {lq}, S {s}, {hq}/"
                f"{hkv} x {d}, {'causal' if causal else 'non-causal'}"
                f"{f', window {window}' if window else ''}) {str(dt)[6:]}: "
                f"dq/dk/dv max_abs_err={err:.3e} err/bound={worst:.3f}; "
                f"forward with lse err/bound={fworst:.3f}, lse max_abs_err="
                f"{lerr:.2e}, {int((~fin).sum())} keyless rows "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, f"flash_attn_bwd {what} {dt}"
            if what == BWD_CASES[0][0] and dt == torch.bfloat16:
                again = fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln, **kw)
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                cut = do.clone()
                cut[:, 512:512 + 64 // (hq // hkv)] = 0
                dropped_q = _bwd_held(fl.flash_attn_bwd(
                    q, k, v, out, lse, cut, o, ln, **kw), refs, bounds)[1]
                dk, dv = got[1].clone(), got[2].clone()
                dk[:, 512:576] = 0
                dv[:, 512:576] = 0
                dropped_k = _bwd_held((got[0], dk, dv), refs, bounds)[1]
                log(f"[2] flash_attn_bwd {what}: two runs bit-identical "
                    f"{same}; mutants: a dropped query tile err/bound="
                    f"{dropped_q:.1f}, a dropped key tile err/bound="
                    f"{dropped_k:.1f} (each must exceed 1)")
                assert same and dropped_q > 1 and dropped_k > 1
            del q, k, v, do, out, lse, got, refs, bounds
    torch.cuda.empty_cache()


# phase 2's cases of ssd_scan's backward at the training shape's batch:
# (what, L, zero-dt row ranges, with the final state's gradient), each at
# mamba2's layout and jamba's, fp32 and bf16
SSD_BWD_CASES = (
    ("L 1024", 1024, None, True),
    ("L 1000, off the chunk grid", 1000, None, True),
    ("no final-state gradient", 1024, None, False),
    ("a chunk of zero dt", 1024, [(256, 384)], True),
)


def _ssd_bwd_case(gen, b, l, nh, g, dt_, zero=None, dstate=True):
    """``_ssd_inputs`` (pad and strong-decay rows, a non-zero init state)
    with dy ~ N(0, 1) in x's dtype and, if asked, a final-state gradient
    ~ N(0, 1/100)."""
    args = _ssd_inputs(gen, b, l, g, dt_, zero=zero, nh=nh)
    dy = torch.randn(args[0].shape, generator=gen, device=DEVICE).to(dt_)
    dst = 0.1 * torch.randn(args[5].shape, generator=gen, device=DEVICE) \
        if dstate else None
    return args, dy, dst


def _held_ssd_bwd(args, dy, dst, states, got):
    """(max abs error, the largest error over its bound) of the six
    gradients against ``ref.ssd_bwd_error_bound``; the refs and bounds."""
    from repro_torch.kernels.ref import ssd_bwd_error_bound
    refs, bounds = ssd_bwd_error_bound(*args, dy, dst, states, SSD_CHUNK)
    errs = [(x.float() - r).abs() for x, r in zip(got, refs)]
    worst = max(float(torch.nan_to_num(e / bd, nan=0.0).max())
                for e, bd in zip(errs, bounds))
    return max(float(e.max()) for e in errs), worst, refs, bounds


def phase_ssd_bwd(seed, errs):
    """``ssd_scan``'s training form and ``ssd_scan_bwd`` against their
    plain versions at ``SSD_BWD_CASES``, B = 2, at mamba2's layout (80
    heads of 64, DS 128, G 1) and jamba's (128 heads, G 8), fp32 and
    bf16: the chunk states within 1e-4 of the largest state of their
    (batch row, head) from the plain chunk-by-chunk recurrence, y and the
    final state bit-identical to the serving launch's, and the six
    gradients within ``ref.ssd_bwd_error_bound``.  At L 1024 in bf16 at
    each layout: two runs bit-identical, and the kernel run on a dy whose
    chunk 3 is zeroed (a dropped chunk) lies far past the bound."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import SSD_REL_TOL, ref_ssd_scan
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 28)
    b, n, ratios = 2, 0, {}
    for nh, g in ((SSD_NH, 1), (JAMBA_NH, JAMBA_G)):
        for what, l, zero, with_dst in SSD_BWD_CASES:
            for dt_ in (torch.float32, torch.bfloat16):
                args, dy, dst = _ssd_bwd_case(gen, b, l, nh, g, dt_, zero,
                                              with_dst)
                y, st, states = ssd.ssd_scan(*args, chunk=SSD_CHUNK,
                                             return_states=True)
                y2, st2 = ssd.ssd_scan(*args, chunk=SSD_CHUNK)
                serving = torch.equal(y, y2) and torch.equal(st, st2)
                _, _, sref = ref_ssd_scan(*(t.float() for t in args),
                                          chunk=SSD_CHUNK, return_states=True)
                sbound = SSD_REL_TOL * sref.abs().amax((2, 3, 4), True)
                s_err = float(((states - sref).abs() / sbound).max())
                got = ssd.ssd_scan_bwd(*args[:5], states, dy, dst,
                                       chunk=SSD_CHUNK)
                torch.cuda.synchronize()
                err, worst, refs, bounds = _held_ssd_bwd(args, dy, dst,
                                                         states, got)
                finite = all(bool(torch.isfinite(x.float()).all())
                             for x in got)
                ok = serving and s_err <= 1 and worst <= 1 and finite
                errs.setdefault(("ssd_scan_bwd", dt_), []).append(err)
                errs.setdefault(("ssd_scan@states", dt_), []).append(
                    float((states - sref).abs().max()))
                ratios[dt_] = max(ratios.get(dt_, 0.0), worst)
                n += 1
                log(f"[2] ssd_scan_bwd {what} (B {b}, NH {nh}, G {g}) "
                    f"{str(dt_)[6:]}: dx/ddt/da/dB/dC/dinit max_abs_err="
                    f"{err:.3e} err/bound={worst:.3f}; chunk states "
                    f"err/bound={s_err:.3f}, y and state as the serving "
                    f"launch's {serving} {'ok' if ok else 'FAIL'}")
                assert ok, f"ssd_scan_bwd {what} NH {nh} {dt_}"
                if what == SSD_BWD_CASES[0][0] and dt_ == torch.bfloat16:
                    again = ssd.ssd_scan_bwd(*args[:5], states, dy, dst,
                                             chunk=SSD_CHUNK)
                    same = all(torch.equal(p, q) for p, q in zip(got, again))
                    cut = dy.clone()
                    cut[:, 3 * SSD_CHUNK:4 * SSD_CHUNK] = 0
                    dropped = ssd.ssd_scan_bwd(*args[:5], states, cut, dst,
                                               chunk=SSD_CHUNK)
                    mutant = _held_ssd_bwd(args, dy, dst, states,
                                           dropped)[1]
                    log(f"[2] ssd_scan_bwd L 1024 (NH {nh}, G {g}) bf16: "
                        f"two runs bit-identical {same}; a dropped chunk "
                        f"err/bound={mutant:.1f} (must exceed 100)")
                    assert same and mutant > 100
                del args, dy, dst, y, st, states, got, refs, bounds
    log(f"[2] ok: ssd_scan_bwd == plain on {n} cases (worst err/bound fp32 "
        f"{ratios[torch.float32]:.3f}, bf16 {ratios[torch.bfloat16]:.3f}; "
        f"max_abs_err fp32 {max(errs[('ssd_scan_bwd', torch.float32)]):.3e}"
        f", bf16 {max(errs[('ssd_scan_bwd', torch.bfloat16)]):.3e})")
    torch.cuda.empty_cache()


TRAIN_SMOKE = dict(head_dim=128)         # the attention kernels' width
# the smoke configs trained on the card against the CPU (qwen3-moe with
# 16 experts: the capacity dispatch; mamba2 and jamba through the SSD
# backward, their SSD layers at the smoke's own widths)
TRAIN_ORACLE = (("qwen3-4b", {}), ("mixtral-8x7b", {}),
                (QWEN_MOE, dict(num_experts=16)), ("mamba2-2.7b", {}),
                (HYBRID, {}))
TRAIN_BATCH = dict(seq_len=64, batch=4, accum=2)
TRAIN_OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_GRAD_TOL = (1e-5, 1e-4)   # card vs CPU grads: atol (x the leaf's
                                # largest |grad| where above 1), rtol
TRAIN_LOSS_TOL = 1e-5           # relative
# card vs CPU params after the steps: Adam's update m^ / (sqrt(v^) +
# eps) is normalised, so where the steps' grads nearly cancel in m^ it
# amplifies the grads' fp32 rounding; each element within 1e-5 + 5% of
# lr a step, the 99.9th percentile within 1e-6


def _tree_to(tree, device):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda x: x.to(device), tree)


def _train_steps(cfg, params, device, n, seed):
    """``n`` steps of ``make_train_step`` (accum 2, remat) from
    ``params`` over ``SyntheticLM`` batches: (losses, params, state)."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seed=seed,
                                       **TRAIN_BATCH))
    state = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OCFG),
                           accum=TRAIN_BATCH["accum"], remat=True)
    losses = []
    for _ in range(n):
        params, state, m = step(params, state, data.next_batch())
        losses.append(float(m["loss"]))
    return losses, params, state


def _train_loop(cfg, seed, steps, ckpt_dir=None, every=100):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, TrainLoop
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seed=seed,
                                       **TRAIN_BATCH))
    return TrainLoop(cfg, AdamWConfig(**TRAIN_OCFG), data, TrainConfig(
        steps=steps, ckpt_dir=ckpt_dir, ckpt_every=every, log_every=1,
        accum=TRAIN_BATCH["accum"], remat=True),
        log_fn=lambda s: None, device=DEVICE)


def phase_train_oracle(seed):
    """The train step on the card against the same steps on the CPU (the
    plain path), from one set of weights: the qwen3-4b, mixtral-8x7b
    (window 32, 4 experts) and qwen3-moe (16 experts: the capacity
    dispatch) smoke configs at head_dim 128, fp32, two steps of accum 2
    with remat; and the mamba2-2.7b and jamba-v0.1-52b smoke configs, the
    SSD layers through ``ssd_scan``'s training form and ``ssd_scan_bwd``.
    The first microbatch's loss grads within ``TRAIN_GRAD_TOL``, the
    losses within ``TRAIN_LOSS_TOL``, the params as stated beside
    ``TRAIN_LOSS_TOL``; ``flash_attn_bwd`` once per attention layer and
    ``ssd_scan_bwd`` once per SSD layer per microbatch.  Then
    qwen3-4b's in bf16: two card runs of ``TrainLoop`` from one seed
    bit-identical, and a run checkpointed at step 2 and resumed to 4
    bit-identical to the continuous run."""
    import shutil

    from repro_torch.configs import get_smoke
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.models import transformer as tr
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.training.train_step import make_loss_fn
    launchers = _launchers()
    steps, lr = 2, TRAIN_OCFG["lr"]
    for arch, extra in TRAIN_ORACLE:
        cfg = get_smoke(arch).replace(**TRAIN_SMOKE, **extra)
        cpu = tr.init_params(cfg, seed=seed, device="cpu")
        # the first microbatch's loss grads on both devices
        first = SyntheticLM(SyntheticConfig(
            vocab_size=cfg.vocab_size, seed=seed,
            **TRAIN_BATCH)).next_batch()
        grads = []
        for dev in (DEVICE, "cpu"):
            live = [p.detach().to(dev).requires_grad_()
                    for p in tree_leaves(cpu)]
            tot, _ = make_loss_fn(cfg)(
                tree_unflatten(cpu, live),
                torch.from_numpy(first["tokens"][0]).to(dev),
                torch.from_numpy(first["labels"][0]).to(dev))
            grads.append([torch.zeros_like(p) if g is None else g.cpu()
                          for p, g in zip(live, torch.autograd.grad(
                              tot, live, allow_unused=True))])
        atol, rtol = TRAIN_GRAD_TOL
        grad_worst = max(
            ((a - b).abs() / (atol * max(1.0, b.abs().max().item())
                              + rtol * b.abs())).max().item()
            for a, b in zip(*grads))
        bwd = ("flash_attn_bwd", "ssd_scan_bwd")
        n0 = [launchers[k].launches for k in bwd]
        lc, pc, sc = _train_steps(cfg, _tree_to(cpu, DEVICE), DEVICE, steps,
                                  seed)
        torch.cuda.synchronize()
        n_bwd = [launchers[k].launches - n for k, n in zip(bwd, n0)]
        lh, ph, sh = _train_steps(cfg, cpu, "cpu", steps, seed)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        errs = torch.cat([(a.float().cpu() - b.float()).abs().flatten()
                          for a, b in zip(tree_leaves(pc), tree_leaves(ph))])
        worst = errs.max().item()
        q999 = errs.quantile(0.999).item() if errs.numel() <= 1 << 24 \
            else errs.sort().values[int(0.999 * (errs.numel() - 1))].item()
        ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
        want_bwd = [n * TRAIN_BATCH["accum"] * steps
                    for n in (cfg.num_layers - ssm, ssm)]
        ok = (grad_worst <= 1.0 and loss_err <= TRAIN_LOSS_TOL
              and worst <= 1e-5 + 0.05 * lr * steps and q999 <= 1e-6
              and n_bwd == want_bwd)
        log(f"[3] train step {arch} smoke (head_dim 128, fp32, accum 2, "
            f"remat), card vs CPU: first microbatch's grads err/bound "
            f"{grad_worst:.3f}; over {steps} steps losses "
            f"{[round(x, 5) for x in lc]} vs {[round(x, 5) for x in lh]} "
            f"(rel err {loss_err:.2e}), params max err {worst:.2e}, 99.9th "
            f"percentile {q999:.2e}; flash_attn_bwd / ssd_scan_bwd launches "
            f"{n_bwd} (want {want_bwd}) {'ok' if ok else 'FAIL'}")
        assert ok, f"train step {arch}: card vs CPU"

    cfg = get_smoke("qwen3-4b").replace(**TRAIN_SMOKE, dtype="bfloat16")
    runs = [_train_loop(cfg, seed, 4).run(seed) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(list(runs[0])), tree_leaves(list(runs[1]))))
    ckpt = os.path.join(HERE, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    _train_loop(cfg, seed, 2, ckpt, 2).run(seed)
    resumed = _train_loop(cfg, seed, 4, ckpt).run(seed)
    shutil.rmtree(ckpt, ignore_errors=True)
    restart = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(list(runs[0])), tree_leaves(list(resumed))))
    log(f"[3] TrainLoop qwen3-4b smoke bf16 on the card, 4 steps: two runs "
        f"bit-identical {same}; checkpointed at step 2 and resumed to 4 "
        f"bit-identical to the continuous run {restart}")
    assert same and restart, "train loop on the card: not bit-identical"


TRAIN_LAYERS = 12                 # of qwen3-4b's 36: full depth's state
TRAIN_FULL = dict(seq_len=1024, batch=4, accum=2)    # (~88 GB) > 80 GB
# of mamba2-2.7b's 64: at ~1.03 GiB a layer (params, Adam state,
# remat's activations) full depth reckons ~72 GiB of the 80 GB card
TRAIN_SSM_LAYERS = 32
# each training form's forward and backward kernels: the counts phase 4
# reports per step and the kernels line takes
TRAIN_KERNELS = {"qwen3-4b": ("flash_attn", "flash_attn@lse",
                              "flash_attn_bwd"),
                 "mamba2-2.7b": ("ssd_scan", "ssd_scan@states",
                                 "ssd_scan_bwd")}
TRAIN_STEPS = 10
TRAIN_FULL_OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
# qwen3-4b's losses at --seed 0 (4 decimals) with the bf16 backward on
# the CUDA cores in fp32, dS unrounded (an NVIDIA H100 80GB HBM3 at
# 700 W): phase 4 logs the tensor-core backward's trajectory beside it
TRAIN_LOSSES_CUDA_CORE = {"qwen3-4b": (
    12.436, 12.1104, 14.4494, 18.856, 11.5926, 10.5961, 9.0737, 7.4805,
    6.4744, 6.4217)}


def _matmul_params(tree, path=""):
    """Parameters that enter a matrix product: not the embedding table
    (a gather) nor the norms' scales, nor an SSD mixer's depthwise
    convolution and per-head vectors."""
    if isinstance(tree, dict):
        return sum(_matmul_params(v, f"{path}/{k}") for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_matmul_params(v, f"{path}/{i}")
                   for i, v in enumerate(tree))
    if path == "/embed" or path.split("/")[-1] in (
            "ln1", "ln2", "final_norm", "q_norm", "k_norm", "norm", "conv_w",
            "conv_b", "dt_bias", "A_log", "D"):
        return 0
    return tree.numel()


def phase_train(seed, card, arch="qwen3-4b", layers=TRAIN_LAYERS):
    """``arch`` at full width cut to ``layers`` layers, bf16, trained by
    ``TrainLoop`` for ``TRAIN_STEPS`` steps of accum 2 x (4, 1024) tokens
    from ``SyntheticLM``, with remat: qwen3-4b (d_model 2560, 32 / 8
    heads of 128, d_ff 9728, vocab 151,936) through the attention
    kernels, mamba2-2.7b (d_model 2560, 80 SSD heads of 64, state 128,
    vocab 50,280) through the SSD scan's.  Logs the loss per step
    (finite, lower at the last step than the first), ms per step and its
    split between the microbatches' forward + backward and AdamW (CUDA
    events around each step and around its ``adamw_update``), tokens/s,
    model TFLOP/s (6 N tokens + attention or the SSD scan's operations,
    remat's extra forward apart), the training forms' forward and
    backward launches per step (every count set to 0 before the run),
    peak GiB; then one more step under ``torch.profiler``: the
    device-busy share and the backward and forward kernels' share of
    it.  Returns {kernel: (launches, steps, mode)} for the two training
    forms."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, TrainLoop
    from repro_torch.training import train_step as tts
    cfg = get_config(arch)
    full_layers = cfg.num_layers
    cfg = cfg.replace(num_layers=layers)
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seed=seed,
                                       **TRAIN_FULL))
    losses = []
    loop = TrainLoop(cfg, AdamWConfig(**TRAIN_FULL_OCFG), data, TrainConfig(
        steps=TRAIN_STEPS, log_every=1, accum=TRAIN_FULL["accum"],
        remat=True), log_fn=lambda s: None, device=DEVICE)
    marks, inner, adamw = [], loop._step, tts.adamw_update

    def timed_step(params, state, batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks.append(ev)
        ev[0].record()
        out = inner(params, state, batch)
        ev[3].record()
        return out

    def timed_adamw(*a, **kw):
        marks[-1][1].record()
        out = adamw(*a, **kw)
        marks[-1][2].record()
        return out

    launchers = _launchers()
    for fn in launchers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    loop._step, tts.adamw_update = timed_step, timed_adamw
    t0 = time.perf_counter()
    try:
        params, state = loop.run(seed)
        torch.cuda.synchronize()
    finally:
        tts.adamw_update = adamw
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in launchers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in loop.history]
    step_ms = [a.elapsed_time(d) for a, _, _, d in marks]
    adam_ms = [b.elapsed_time(c) for _, b, c, _ in marks]
    steady = slice(1, None)                   # step 1 warms up
    ms = float(np.median(step_ms[steady]))
    am = float(np.median(adam_ms[steady]))
    tokens = TRAIN_FULL["accum"] * TRAIN_FULL["batch"] * TRAIN_FULL["seq_len"]
    n_mm = _matmul_params(params)
    fwd_k, lse_k, bwd_k = TRAIN_KERNELS[arch]
    if cfg.family == "ssm":
        # the SSD scan's forward operations a layer and microbatch
        mixer = "the SSD scan"
        mix_fwd = _ssd_work(TRAIN_FULL["batch"], TRAIN_FULL["seq_len"],
                            cfg.ssm_n_groups, nh=cfg.ssm_nheads)[0]
    else:
        mixer = "attention"
        pairs = TRAIN_FULL["batch"] * sum(i + 1 for i in
                                          range(TRAIN_FULL["seq_len"]))
        mix_fwd = 4 * cfg.hdim * cfg.num_heads * pairs
    mix_fwd *= layers * TRAIN_FULL["accum"]
    model = 6 * n_mm * tokens + 3 * mix_fwd
    remat = 2 * n_mm * tokens + mix_fwd
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items() if n}
    log(f"[4] train {arch} full width, {layers} of {full_layers} "
        f"layers, bf16, remat, accum {TRAIN_FULL['accum']} x "
        f"({TRAIN_FULL['batch']}, {TRAIN_FULL['seq_len']}): "
        f"{n_mm / 1e9:.3f} B matmul params; losses "
        f"{[round(x, 4) for x in losses]}; step 1 {step_ms[0]:.1f} ms, then "
        f"median {ms:.1f} ms (min {min(step_ms[steady]):.1f} max "
        f"{max(step_ms[steady]):.1f}): forward + backward {ms - am:.1f} ms, "
        f"AdamW {am:.1f} ms; {tokens / ms * 1e3:.0f} tokens/s; model "
        f"{model / ms / 1e9:.1f} TFLOP/s (6 N T {6 * n_mm * tokens / 1e12:.2f}"
        f" + {mixer} {3 * mix_fwd / 1e12:.2f} TFLOP a step; remat's "
        f"extra forward {remat / 1e12:.2f} TFLOP more, "
        f"{(model + remat) / ms / 1e9:.1f} TFLOP/s with it); launches a "
        f"step {per_step}; peak {peak:.2f} GiB; {wall:.1f} s in all "
        f"(card {card})")
    before = TRAIN_LOSSES_CUDA_CORE.get(arch)
    if seed == 0 and before is not None and layers == TRAIN_LAYERS:
        log(f"[4] train {arch} losses beside the CUDA-core backward's "
            f"(seed 0): " + ", ".join(
                f"{x:.4f} ({x - y:+.4f})" for x, y in zip(losses, before)))
    fwd = layers * TRAIN_FULL["accum"] * TRAIN_STEPS
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert launches[bwd_k] == fwd, launches
    assert launches[lse_k] == launches[fwd_k] == 2 * fwd, launches
    assert all(n == 0 for k, n in launches.items() if k not in (
        fwd_k, lse_k, bwd_k)), launches

    # one more step under the profiler: the device's busy share and the
    # training forms' kernels' share of it
    from torch.profiler import ProfilerActivity, profile
    batch = data.next_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, state, _ = inner(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    by_kernel, busy = _device_split(prof, wall_ms, f"{arch} train step",
                                    card)
    # the backward's kernels and the forward kernel's, by name
    bwd_pat, fwd_pat = (("flash_bwd", "flash_attn_kernel")
                        if fwd_k == "flash_attn" else
                        ("ssd_bwd_", "ssd_(?:cb|walk)_kernel"))
    bwd = sum(t for k, t in by_kernel.items() if re.search(bwd_pat, k))
    fwd_ms = sum(t for k, t in by_kernel.items() if re.search(fwd_pat, k))
    log(f"[4] train step profile {arch}: device busy {busy:.1f} ms of "
        f"{wall_ms:.1f} ms wall; {bwd_k}'s kernels {bwd:.1f} ms "
        f"({100 * bwd / max(busy, 1e-9):.1f}% of the busy time), "
        f"{lse_k} {fwd_ms:.1f} ms "
        f"({100 * fwd_ms / max(busy, 1e-9):.1f}%) (card {card})")
    del params, state, loop
    return {name: (n, TRAIN_STEPS, "train") for name, n in launches.items()
            if name in (lse_k, bwd_k)}


def _time_flash_bwd(gen, errs):
    """``flash_attn_bwd`` and the forward with its log-sum-exp at the
    full-width training shape (B 4, L 1024, 32 / 8 heads of 128, causal,
    bf16), each held to its plain version first, beside their plain
    versions and one library call: SDPA's backward alone
    (``autograd.grad`` through ``scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)`` less its forward), checked to
    compute the same gradients, and SDPA's forward; the backward's three
    kernels' device times apart.  Bounds: 5 products (backward) and 2
    (forward) of 2 D FLOPs for each (query, key) pair of the band at the
    bf16 tensor-core peak, against each input read and each output
    written once."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as fl
    from repro_torch.kernels.ref import flash_attn_bwd_error_bound
    b, l, hq, hkv, d, dt, el = 4, 1024, HQ, HKV, D, torch.bfloat16, 2
    q, k, v, do, o, ln = _bwd_case(gen, b, l, l, hq, hkv, d, [0] * b,
                                   [l] * b, dt)
    out, lse = fl.flash_attn(q, k, v, o, ln, return_lse=True)
    got = fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln)
    refs, bounds = flash_attn_bwd_error_bound(q, k, v, out, lse, do, o, ln)
    err, worst = _bwd_held(got, refs, bounds)
    errs.setdefault(("flash_attn_bwd", dt), []).append(err)
    assert worst <= 1.0, "flash_attn_bwd at the training shape"
    # SDPA's gradients, held to the plain ones (bf16 kernels of another
    # schedule: u-relative, as the forward's SDPA checks)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    def sdpa_grads():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), do.transpose(1, 2))

    lib = [x.transpose(1, 2).float() for x in sdpa_grads()]
    lib_err = max(((x - r).abs().max() / r.abs().max()).item()
                  for x, r in zip(lib, refs))
    log(f"[5] flash_attn_bwd at ({b}, {l}) {hq}/{hkv} x {d} causal bf16: "
        f"max_abs_err={err:.3e} err/bound={worst:.3f}; SDPA's grads within "
        f"{lib_err:.2e} of the plain ones (relative to their largest)")
    assert lib_err < 2e-2, "SDPA computes another function"
    pairs = b * sum(i + 1 for i in range(l))
    io = (3 * b * l * hq * d + 2 * b * l * hkv * d) * el
    rows = {}
    fwd_ms = _time(sdpa)          # with grad, as the backward's forward
    rows["flash_attn_bwd"] = dict(
        ms=_time(lambda: fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln), 5),
        plain_ms=_time(lambda: fl.flash_attn_bwd_plain(
            q.float(), k.float(), v.float(), out.float(), lse, do.float(),
            o, ln), 2),
        library_ms=_time(sdpa_grads, 5) - fwd_ms,
        flops=5 * 2 * d * pairs * hq,
        # q, k, v, out, dout and lse read; dq, dk, dv written
        bytes=io + b * hq * l * 4 + (b * l * hq * d + 2 * b * l * hkv * d)
        * el)
    # the three kernels' device time (torch.profiler over 5 calls), and
    # the rate over the 7 products the design runs (S and dP twice)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln)
        torch.cuda.synchronize()
    split = {e.key.split("<")[0].split("::")[-1]:
             e.device_time_total / e.count / 1e3
             for e in prof.key_averages()
             if getattr(e, "device_time_total", 0)}
    ms = rows["flash_attn_bwd"]["ms"]
    log(f"[5] flash_attn_bwd's kernels at ({b}, {l}): " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in sorted(split.items())) +
        f"; {7 * 2 * d * pairs * hq / ms / 1e9:.1f} TFLOP/s over the "
        f"{7 * 2 * d * pairs * hq / 1e9:.1f} GFLOP of 7 products it runs")
    rows["flash_attn@lse"] = dict(
        ms=_time(lambda: fl.flash_attn(q, k, v, o, ln, return_lse=True)),
        plain_ms=_time(lambda: (fl.flash_attn_plain(q, k, v, o, ln),
                                fl.flash_attn_lse_plain(q, k, o, ln)), 2),
        library_ms=fwd_ms,
        flops=2 * 2 * d * pairs * hq,
        # q, k, v read; out and lse written
        bytes=(2 * b * l * hq * d + 2 * b * l * hkv * d) * el
        + b * hq * l * 4)
    return rows


def _ssd_bwd_work(b, l, nh, g, chunk=SSD_CHUNK, el=2):
    """(operations, bytes) ``ssd_scan_bwd`` needs for one call at
    mamba2's head widths: per chunk of n rows and head the lower
    triangles of G = dy·xᵀ and of Mᵀ·dy, and five rank-HD products over
    the chunk (dH·Bᵀ, C·Hᵀ, dC's and dB's carried terms, dH's update);
    per group C·Bᵀ, dC's and dB's intra-chunk products; nothing is
    skipped.  Bytes: x, dy, B, C, dt, a, the chunk states and the final
    state's gradient read once; dx, d dt, da, dB, dC and the initial
    state's gradient written once."""
    hd, ds = SSD_HD, SSD_DS
    flops = 0
    for c0 in range(0, l, chunk):
        n = min(chunk, l - c0)
        tri = n * (n + 1) // 2
        flops += b * (nh * (2 * 2 * tri * hd + 5 * 2 * n * hd * ds)
                      + g * 3 * 2 * tri * ds)
    rows, nc = b * l, -(-l // chunk)
    state = 4 * b * nh * hd * ds
    nbytes = (3 * rows * nh * hd * el + 4 * rows * g * ds * el
              + 2 * 4 * rows * nh + 2 * 4 * nh + state * nc + 2 * state)
    return flops, nbytes


def _time_ssd_bwd(gen, errs):
    """``ssd_scan``'s training form and ``ssd_scan_bwd`` at the training
    shape (B 4, L 1024, bf16) at mamba2's layout (the JSON rows) and
    jamba's (logged), each held to its plain version first, beside their
    plain versions.  No single PyTorch call computes either function.
    Bounds: the bf16 tensor-core rate for their operations against each
    input read and each output written once (``_ssd_work`` plus the
    chunk states written, ``_ssd_bwd_work``)."""
    from repro_torch.kernels import ssd_scan as ssd
    rows = {}
    b, l = SSD_TRAIN
    for nh, g in ((SSD_NH, 1), (JAMBA_NH, JAMBA_G)):
        args, dy, dst = _ssd_bwd_case(gen, b, l, nh, g, torch.bfloat16)
        y, st, states = ssd.ssd_scan(*args, chunk=SSD_CHUNK,
                                     return_states=True)
        got = ssd.ssd_scan_bwd(*args[:5], states, dy, dst, chunk=SSD_CHUNK)
        err, worst, _, _ = _held_ssd_bwd(args, dy, dst, states, got)
        errs.setdefault(("ssd_scan_bwd", torch.bfloat16), []).append(err)
        assert worst <= 1.0, f"ssd_scan_bwd at the training shape, NH {nh}"
        flops, nbytes = _ssd_work(b, l, g, nh=nh)
        nc = -(-l // SSD_CHUNK)
        fwd = dict(
            ms=_time(lambda: ssd.ssd_scan(*args, chunk=SSD_CHUNK,
                                          return_states=True), 10),
            plain_ms=_time(lambda: ssd.ssd_scan_plain(
                *args, chunk=SSD_CHUNK, return_states=True), 2),
            library_ms=None, flops=flops, flops_rate=BF16_FLOPS,
            bytes=nbytes + 4 * b * nh * nc * SSD_HD * SSD_DS)
        flops, nbytes = _ssd_bwd_work(b, l, nh, g)
        bwd = dict(
            ms=_time(lambda: ssd.ssd_scan_bwd(*args[:5], states, dy, dst,
                                              chunk=SSD_CHUNK), 5),
            plain_ms=_time(lambda: ssd.ssd_scan_bwd_plain(
                *(t.float() for t in args), dy.float(), dst,
                chunk=SSD_CHUNK, states=states), 2),
            library_ms=None, flops=flops, flops_rate=BF16_FLOPS,
            bytes=nbytes)
        serving = _time(lambda: ssd.ssd_scan(*args, chunk=SSD_CHUNK), 10)
        log(f"[5] ssd_scan_bwd at (B, L) = {SSD_TRAIN} (NH {nh}, G {g}) "
            f"bf16: max_abs_err={err:.3e} err/bound={worst:.3f}; kernel "
            f"{bwd['ms']:.4f} ms ({flops / bwd['ms'] / 1e9:.1f} TFLOP/s of "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / bwd['ms'] / 1e6:.0f} GB/s "
            f"of {nbytes / 1e6:.2f} MB), plain {bwd['plain_ms']:.4f} ms; "
            f"the training-form forward {fwd['ms']:.4f} ms (the serving "
            f"launch {serving:.4f} ms), plain {fwd['plain_ms']:.4f} ms")
        # each of the backward's kernels: device ms a call (torch.profiler
        # over 5 calls; the sum kernel's launches together)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ssd.ssd_scan_bwd(*args[:5], states, dy, dst, chunk=SSD_CHUNK)
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            m = re.search(r"ssd_bwd_\w+_kernel", e.key)
            t = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if m and t:
                split[m.group(0)] = split.get(m.group(0), 0.0) + t / 5 / 1e3
        log(f"[5] ssd_scan_bwd's kernels at (NH {nh}, G {g}), device ms a "
            f"call: " + ", ".join(f"{k} {t:.4f}" for k, t in split.items())
            + f"; sum {sum(split.values()):.4f} ms")
        if g == 1:
            rows["ssd_scan_bwd"], rows["ssd_scan@states"] = bwd, fwd
        else:
            for name, r in (("ssd_scan_bwd", bwd), ("ssd_scan@states", fwd)):
                t_b = r["bytes"] / HBM_BYTES_PER_S * 1e3
                t_o = r["flops"] / BF16_FLOPS * 1e3
                log(f"[5] {name} at jamba's layout (NH {nh}, G {g}): kernel"
                    f" {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                    f"bound {max(t_b, t_o):.4f} ms ({r['bytes'] / 1e6:.2f} "
                    f"MB, {r['flops'] / 1e9:.2f} GFLOP)")
        del args, dy, dst, y, st, states, got
    torch.cuda.empty_cache()
    return rows


def phase_train_launcher(card):
    """The training launcher on the card: its smoke default (qwen3-4b's
    smoke config at head_dim 64) for 20 steps, and published widths cut
    to 2 layers for 3 steps; the mamba2-2.7b and jamba-v0.1-52b smoke
    configs for 3 steps, and mamba2 at published widths cut to 2
    layers."""
    from repro_torch.launch import train
    for argv in (["--steps", "20"],
                 ["--full", "--layers", "2", "--steps", "3"],
                 ["--arch", "mamba2-2.7b", "--steps", "3"],
                 ["--arch", HYBRID, "--steps", "3"],
                 ["--arch", "mamba2-2.7b", "--full", "--layers", "2",
                  "--steps", "3"]):
        t0 = time.perf_counter()
        loop = train.main(argv)
        torch.cuda.synchronize()
        losses = [h["loss"] for h in loop.history]
        log(f"[6] launch.train {' '.join(argv)}: losses {losses}, finished "
            f"in {time.perf_counter() - t0:.1f} s (card {card})")
        assert all(np.isfinite(losses)), losses


# ------------------------------------------------------------ main

KERNELS = {
    "ragged_prefill_paged": dict(
        source="src/repro_torch/csrc/ragged_prefill_paged.cu",
        replaces="src/repro/kernels/ragged_prefill.py:309",
        jax="repro.kernels.ragged_prefill.ragged_prefill_paged"),
    "decode_attn_paged": dict(
        source="src/repro_torch/csrc/decode_attn_paged.cu",
        replaces="src/repro/kernels/decode_attn.py:215",
        jax="repro.kernels.decode_attn.decode_attn_paged"),
    "decode_attn_arena": dict(
        source="src/repro_torch/csrc/decode_attn_arena.cu",
        replaces="src/repro/kernels/decode_attn.py:303",
        jax="repro.kernels.decode_attn.decode_attn_arena"),
    "ragged_prefill_arena": dict(
        source="src/repro_torch/csrc/ragged_prefill_arena.cu",
        replaces="src/repro/kernels/ragged_prefill.py:417",
        jax="repro.kernels.ragged_prefill.ragged_prefill_arena"),
    "ragged_prefill_attn": dict(
        source="src/repro_torch/csrc/ragged_prefill_attn.cu",
        replaces="src/repro/kernels/ragged_prefill.py:148",
        jax="repro.kernels.ragged_prefill.ragged_prefill_attn"),
    "fused_sample": dict(
        source="src/repro_torch/csrc/fused_sample.cu",
        replaces="src/repro/kernels/sampling.py:185",
        jax="repro.kernels.sampling.fused_sample"),
    "ssd_scan": dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:69",
        jax="repro.kernels.ssd_scan.ssd_scan"),
    "decode_attn": dict(
        source="src/repro_torch/csrc/decode_attn_dense.cu",
        replaces="src/repro/kernels/decode_attn.py:101",
        jax="repro.kernels.decode_attn.decode_attn"),
    "flash_attn": dict(
        source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:103",
        jax="repro.kernels.flash_attn.flash_attn"),
}
# the training forms of flash_attn: the forward launch that writes the
# log-sum-exp (the same library and TPU kernel), and the backward, which
# ports no TPU kernel (the reference differentiates XLA attention,
# src/repro/models/layers.py:157; its forward's TPU kernel is named)
KERNELS["flash_attn@lse"] = dict(KERNELS["flash_attn"])
KERNELS["flash_attn_bwd"] = dict(
    source="src/repro_torch/csrc/flash_attn_bwd.cu",
    replaces="src/repro/kernels/flash_attn.py:103",
    jax="jax.vjp of repro.models.layers.attention_core (XLA; no Pallas "
        "backward)")
# the training forms of ssd_scan: the forward launch that writes the
# chunk states (the same library and TPU kernel), and the backward, which
# ports no TPU kernel (the reference differentiates ssd_chunked through
# XLA, src/repro/models/mamba.py:98; its forward's TPU kernel is named)
KERNELS["ssd_scan@states"] = dict(KERNELS["ssd_scan"])
KERNELS["ssd_scan_bwd"] = dict(
    source="src/repro_torch/csrc/ssd_scan_bwd.cu",
    replaces="src/repro/kernels/ssd_scan.py:69",
    jax="jax.vjp of repro.models.mamba.ssd_chunked (XLA; no Pallas "
        "backward)")
# the windowed forms (ring page tables, rolling slots) of four of them:
# the same libraries and TPU kernels, timed and counted on their own
KERNELS.update({f"{name}@window": dict(KERNELS[name]) for name in (
    "ragged_prefill_paged", "decode_attn_paged", "ragged_prefill_arena",
    "decode_attn_arena")})
# the six at the served MHA widths, 64 (stablelm-1.6b) and 96
# (phi-3-vision-4.2b): the same libraries and TPU kernels, checked,
# timed and counted on their own (80's checks fold into the base row)
KERNELS.update({f"{name}@d{d}": dict(KERNELS[name]) for name in WIDTH_KERNELS
                for d in ROW_WIDTHS})
# the SSD scan at jamba's layout (128 heads, B/C in 8 groups of 16): the
# same library and TPU kernel, checked, timed and counted on its own
KERNELS["ssd_scan@grouped"] = dict(KERNELS["ssd_scan"])
# the three ragged kernels, whose rows also carry their non-causal form
RAGGED_KERNELS = ("ragged_prefill_paged", "ragged_prefill_arena",
                  "ragged_prefill_attn")


def phase_launcher(card):
    """The serve launcher on the card: its default (the slot/dense
    baseline) and ``--packed``, for qwen3-4b (the smoke config at
    head_dim 64) and mamba2-2.7b (its smoke config's own SSD head
    widths), each also at published widths cut to 4 layers, and for
    mixtral-8x7b (the smoke config at head_dim 64, window 32, and its
    published widths cut to 4 layers: the window-masked dense baseline
    and the ring tables, traffic past the window; phase 4 serves it at
    WINDOW_LAYERS); then stablelm-1.6b at full width and depth with
    ``--packed`` and phi-3-vision-4.2b at full width and depth in the
    default; the jamba-v0.1-52b smoke config (attention at head_dim 64,
    its SSD layers' own widths, 2 B/C groups) in the default and with
    ``--packed``, jamba at published widths cut to one pattern group (8
    layers) with ``--packed``, and qwen3-moe-30b-a3b's smoke config with
    ``--packed``."""
    from repro_torch.launch import serve
    runs = [extra + packed
            for extra in ([], ["--full", "--layers", "4"],
                          ["--arch", "mamba2-2.7b"],
                          ["--arch", "mamba2-2.7b", "--full", "--layers",
                           "4"],
                          ["--arch", "mixtral-8x7b"],
                          ["--arch", "mixtral-8x7b", "--full", "--layers",
                           "4"])
            for packed in ([], ["--packed"])]
    runs += [["--arch", "stablelm-1.6b", "--full", "--packed"],
             ["--arch", "phi-3-vision-4.2b", "--full"],
             ["--arch", HYBRID], ["--arch", HYBRID, "--packed"],
             ["--arch", HYBRID, "--full", "--layers", "8", "--packed"],
             ["--arch", QWEN_MOE, "--packed"]]
    for argv in runs:
        t0 = time.perf_counter()
        serve.main(argv)
        torch.cuda.synchronize()
        log(f"[6] launch.serve {' '.join(argv) or '(default)'}: "
            f"finished in {time.perf_counter() - t0:.1f} s (card {card})")


# ------------------------------------- sharding and the dry run (phase 7)

SHARD_PREFILL = dict(batch=4, seq_len=4096)     # (a): B 4, S 4096
SHARD_DECODE = 16                               # (a): decode steps after it
SHARD_SSM_TRAIN = dict(seq_len=64, batch=4, accum=2)
MEM_RATIO = (0.8, 1.25)       # (c): predicted / measured peak bytes
# (d): the dry-run cells, each CLI call a process of its own, all
# started together
DRYRUN_CALLS = (("qwen2.5-32b", "prefill_32k", "single"),
                ("qwen2.5-32b", "decode_32k", "single"),
                ("qwen3-4b", "all", "single"),
                ("qwen3-4b", "all", "multi"))
DRYRUN_TIMEOUT = 400          # seconds a dry-run call may take


def _dryrun_start():
    """Start the production-mesh dry runs (phase 7d): one process per
    ``DRYRUN_CALLS`` entry, each over a fake process group of its mesh's
    size (a process's default group), its output in a temporary file."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    calls = []
    for arch, shape, mesh in DRYRUN_CALLS:
        out = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             os.path.join(HERE, "chiprun_out", "dryrun")],
            cwd=HERE, env=env, stdout=out, stderr=subprocess.STDOUT,
            text=True)
        calls.append(((arch, shape, mesh), proc, out))
    return calls


def _dryrun_finish(calls, t_start):
    """Wait for the dry runs and print each cell's line (per-device
    bytes, collective bytes by kind, the three roofline terms and the
    bottleneck); fail unless every call printed ALL CELLS PASSED."""
    try:
        for what, proc, out in calls:
            left = DRYRUN_TIMEOUT - (time.perf_counter() - t_start)
            proc.wait(timeout=max(left, 1))
            out.seek(0)
            text = out.read()
            for line in text.splitlines():
                if line.startswith("[dryrun]"):
                    log(f"[7d] {line}")
            if proc.returncode or "[dryrun] ALL CELLS PASSED" not in text:
                raise RuntimeError(f"dry run {what} failed (exit "
                                   f"{proc.returncode}):\n{text[-3000:]}")
    finally:
        for _, proc, out in calls:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()


def _predicted_peaks(seed):
    """Phase 7c's predictions: the dry run's peak device bytes of (a)'s
    prefill step and (b)'s train step, traced on meta tensors on a host
    mesh over a fake world of one (no card memory)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeSpec
    out = {}
    with dryrun.fake_world(1):
        mesh = make_host_mesh("cpu")
        cells = (
            ("prefill", get_config("qwen3-4b"),
             ShapeSpec("prefill", SHARD_PREFILL["seq_len"],
                       SHARD_PREFILL["batch"], "prefill"), None),
            ("train", get_config("qwen3-4b").replace(num_layers=TRAIN_LAYERS),
             ShapeSpec("train", TRAIN_FULL["seq_len"],
                       TRAIN_FULL["batch"] * TRAIN_FULL["accum"], "train"),
             TRAIN_FULL["accum"]))
        for name, cfg, shape, accum in cells:
            rules, _ = dryrun.cell_rules(shape, mesh, False)
            t0 = time.perf_counter()
            rec = dryrun.trace_cell(cfg, shape, mesh, rules,
                                    accum_override=accum)
            out[name] = rec["memory"]
            log(f"[7c] predicted {name}: peak "
                f"{rec['memory']['peak_device_bytes'] / 2**30:.3f} GiB "
                f"(arguments {rec['memory']['argument_bytes'] / 2**30:.3f}, "
                f"outputs {rec['memory']['output_bytes'] / 2**30:.3f}) "
                f"traced in {time.perf_counter() - t0:.1f} s")
    return out


def _measured(b0):
    """Peak bytes the card held during the step, less what it held
    before the step's arguments were made."""
    return torch.cuda.max_memory_allocated() - b0


def _ratio(name, predicted, measured):
    r = predicted / measured
    log(f"[7c] {name}: predicted {predicted / 2**30:.3f} GiB, measured "
        f"{measured / 2**30:.3f} GiB (max_memory_allocated after "
        f"reset_peak_memory_stats), ratio {r:.3f}")
    if not MEM_RATIO[0] <= r <= MEM_RATIO[1]:
        raise AssertionError(f"{name}: predicted / measured {r:.3f} "
                             f"outside {MEM_RATIO}")
    return r


def _world1():
    """A real process group of one: NCCL on the card (gloo on the CPU)."""
    import torch.distributed as dist
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            rank=0, world_size=1, store=dist.HashStore())


def phase_shard_steps(seed, predicted):
    """Phase 7a: qwen3-4b at full width and depth (36 layers, bf16,
    random weights from ``seed``), its params as DTensors placed by
    ``SERVE_RULES`` on a world-size-1 NCCL mesh (``make_host_mesh``;
    ``DTensor.from_local``: no copy of the weights): a prefill step
    (``dense_cache_write``, B 4, S 4096, last logits) and 16 greedy
    decode steps, against the same steps on plain tensors on the card.
    The same greedy tokens, every step's logits within u = 2^-8 of the
    largest reference logit, and whether the bits are identical; the
    ``flash_attn`` and ``decode_attn`` counts (set to 0 before) rise:
    the kernels ran on the local shards.  7c: the sharded prefill's peak
    against the dry run's prediction."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    cfg = get_config("qwen3-4b")
    b, s = SHARD_PREFILL["batch"], SHARD_PREFILL["seq_len"]
    _world1()
    try:
        mesh = make_host_mesh(DEVICE)
        gc.collect()
        b0 = torch.cuda.memory_allocated()
        params = tr.init_params(cfg, seed=seed, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab_size, (b, s), device=DEVICE,
                               generator=gen)

        def run(p, caches, measure=False):
            pos = torch.arange(s, device=DEVICE)[None].expand(b, s)
            with torch.no_grad():
                if measure:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                logits = [tr.forward(p, cfg, tokens=prompt, positions=pos,
                                     caches=caches, logits_slice="last",
                                     dense_cache_write=True)]
                if measure:
                    torch.cuda.synchronize()
                    peak = _measured(b0)
                for i in range(SHARD_DECODE):
                    last = logits[-1]
                    last = last.full_tensor() if hasattr(
                        last, "full_tensor") else last
                    tok = last.argmax(-1)[:, None].to(torch.int32)
                    q = torch.full((b, 1), s + i, dtype=torch.int32,
                                   device=DEVICE)
                    logits.append(tr.forward(p, cfg, tokens=tok,
                                             positions=q, caches=caches,
                                             logits_slice="last"))
            logits = [x.full_tensor() if hasattr(x, "full_tensor") else x
                      for x in logits]
            return logits, (peak if measure else None)

        t0 = time.perf_counter()
        want, _ = run(params, tr.init_cache(cfg, b, s + SHARD_DECODE,
                                            device=DEVICE))
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        gc.collect()
        launchers = _launchers()
        for fn in launchers.values():
            fn.launches = 0
        rules = sh.ShardingRules(mesh, dict(sh.SERVE_RULES))
        t0 = time.perf_counter()
        with sh.use_rules(rules):
            dp = sh.shard_tree(params, tr.param_axes(cfg), rules)
            dc = sh.shard_tree(tr.init_cache(cfg, b, s + SHARD_DECODE,
                                             device=DEVICE),
                               tr.cache_logical_axes(cfg), rules)
            got, peak = run(dp, dc, measure=True)
        torch.cuda.synchronize()
        t_shard = time.perf_counter() - t0
        ran = {k: f.launches for k, f in launchers.items() if f.launches}
        for name in ("flash_attn", "decode_attn"):
            if not ran.get(name):
                raise AssertionError(f"7a: {name} never launched under "
                                     f"DTensor ({ran})")
        u = 2.0 ** -8
        worst, same_bits = 0.0, True
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g.argmax(-1), w.argmax(-1)):
                raise AssertionError(f"7a: step {i}: greedy tokens differ")
            err = float((g.float() - w.float()).abs().max())
            bound = u * float(w.float().abs().max())
            if err > bound:
                raise AssertionError(f"7a: step {i}: logits differ by "
                                     f"{err:.3g} > {bound:.3g}")
            worst = max(worst, err / bound)
            same_bits &= torch.equal(g, w)
        log(f"[7a] qwen3-4b 36 layers bf16 under SERVE_RULES on a "
            f"world-size-1 {'NCCL' if DEVICE == 'cuda' else 'gloo'} mesh: "
            f"prefill B {b} x S {s} + {SHARD_DECODE} decode steps, greedy "
            f"tokens equal, logits err/bound {worst:.3f}, bits identical "
            f"{same_bits}; launches {ran}; plain {t_plain:.2f} s, "
            f"sharded {t_shard:.2f} s")
        ratio = _ratio("prefill", predicted["prefill"]["peak_device_bytes"],
                       peak)
        del params, dp, dc, got, want
        return {"launches": ran, "same_bits": same_bits, "ratio": ratio}
    finally:
        dist.destroy_process_group()


def _train_once(cfg, params, batch, rules=None, measure_from=None):
    """One train step of ``cfg`` (accum from the batch, remat) from
    ``params``, sharded under ``rules`` when given.  Returns (params,
    first moments, metrics, measured peak or None)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tr
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.train_step import make_train_step
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OCFG),
                           accum=batch["tokens"].shape[0],
                           constrain_grads=True)
    ctx = sh.use_rules(rules) if rules is not None else contextlib.nullcontext()
    with ctx:
        p = params if rules is None else sh.shard_tree(
            params, tr.param_axes(cfg), rules)
        state = adamw_init(p)
        if measure_from is not None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        p2, s2, m = step(p, state, batch)
        peak = None
        if measure_from is not None:
            torch.cuda.synchronize()
            peak = _measured(measure_from)
        local = (lambda x: x.to_local() if hasattr(x, "to_local") else x)
        out = ([local(x) for x in tree_leaves(p2)],
               [local(x) for x in tree_leaves(s2["m"])],
               {k: float(local(v)) for k, v in m.items()}, peak)
    return out


def phase_shard_train(seed, predicted):
    """Phase 7b: one train step of phase 4's cell (qwen3-4b at full
    width, 12 layers, bf16, accum 2 x (4, 1024), remat) under
    ``TRAIN_RULES`` with ``constrain_grads`` on a world-size-1 mesh,
    against the same step without rules; then the mamba2-2.7b smoke
    config (fp32, accum 2 x (4, 64)).  Loss, grads (Adam's first moment
    after one step: a tenth of the clipped grads) and params within the
    card-vs-CPU margins of phase 3's training (``TRAIN_GRAD_TOL``,
    ``TRAIN_LOSS_TOL``, params within 1e-5 + 5% of lr), whether the
    bits are identical, and the training forms' counts (set to 0
    before) above 0 under DTensor.  7c: the sharded step's peak against
    the dry run's prediction."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    res = {}
    _world1()
    try:
        mesh = make_host_mesh(DEVICE)
        rules = sh.ShardingRules(mesh, dict(sh.TRAIN_RULES))
        rng = np.random.default_rng(seed + 2)
        for arch, cfg, dims in (
                ("qwen3-4b",
                 get_config("qwen3-4b").replace(num_layers=TRAIN_LAYERS),
                 TRAIN_FULL),
                ("mamba2-2.7b", get_smoke("mamba2-2.7b"), SHARD_SSM_TRAIN)):
            shape = (dims["accum"], dims["batch"], dims["seq_len"])
            batch = {k: rng.integers(0, cfg.vocab_size, shape)
                     for k in ("tokens", "labels")}
            gc.collect()
            params = tr.init_params(cfg, seed=seed + 3, device=DEVICE)
            want = _train_once(cfg, params, batch)
            gc.collect()
            big = arch == "qwen3-4b"
            b0 = torch.cuda.memory_allocated() - sum(
                x.nbytes for x in _leaves(params))
            launchers = _launchers()
            for fn in launchers.values():
                fn.launches = 0
            got = _train_once(cfg, params, batch, rules,
                              measure_from=b0 if big else None)
            ran = {k: f.launches for k, f in launchers.items()
                   if f.launches}
            need = (("flash_attn@lse", "flash_attn_bwd") if big else
                    ("ssd_scan@states", "ssd_scan_bwd"))
            for name in need:
                if not ran.get(name):
                    raise AssertionError(f"7b {arch}: {name} never "
                                         f"launched under DTensor ({ran})")
            lw, lg = want[2]["loss"], got[2]["loss"]
            if abs(lg - lw) > TRAIN_LOSS_TOL * abs(lw):
                raise AssertionError(f"7b {arch}: loss {lg} vs {lw}")
            atol, rtol = TRAIN_GRAD_TOL
            lr = want[2]["lr"]
            same = lg == lw
            worst_m = worst_p = 0.0
            for g, w in zip(got[1], want[1]):
                # m = a tenth of the clipped grads: TRAIN_GRAD_TOL / 10
                lim = 0.1 * atol * max(1.0, 10 * float(w.abs().max())) \
                    + rtol * w.abs()
                if not ((g - w).abs() <= lim).all():
                    raise AssertionError(f"7b {arch}: grads differ by "
                                         f"{float((g - w).abs().max())}")
                worst_m = max(worst_m, float((g - w).abs().max()))
                same &= torch.equal(g, w)
            for g, w in zip(got[0], want[0]):
                e = float((g.float() - w.float()).abs().max())
                if e > 1e-5 + 0.05 * lr:
                    raise AssertionError(f"7b {arch}: params differ by {e}")
                worst_p = max(worst_p, e)
                same &= torch.equal(g, w)
            log(f"[7b] {arch} train step under TRAIN_RULES "
                f"(constrain_grads) vs plain: loss {lg:.6f} / {lw:.6f}, "
                f"first-moment max diff {worst_m:.3g}, params max diff "
                f"{worst_p:.3g}, bits identical {same}; launches {ran}")
            res[arch] = {"launches": ran, "same_bits": same}
            if big:
                res["ratio"] = _ratio(
                    "train", predicted["train"]["peak_device_bytes"], got[3])
            del params, want, got
    finally:
        dist.destroy_process_group()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=3,
                    help="kept runs of phase 4's trace in the launcher's "
                         "default mode, after one warm-up (median and "
                         "spread); the paged mode keeps half as many, "
                         "the two packed slot modes one")
    ap.add_argument("--phases", default="1,2,3,4,5,6,7",
                    help="comma-separated phases to run (default: all); "
                         "5p runs only phase 5's tick profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = set(args.phases.split(","))
    card = card_line()
    errs, launches, times = {}, {}, {}
    t0 = time.perf_counter()
    phase_build()
    if "2" in phases:
        phase_kernels(args.seed, errs)
        phase_slot_kernels(args.seed, errs)
        phase_tile_kernels(args.seed, errs)
        phase_tile_kernels(args.seed, errs, causal=False)
        phase_tma_kernel(args.seed, errs)
        phase_grad_check(args.seed)
        phase_decode_groups(args.seed, errs)
        phase_sample_kernel(args.seed, errs)
        phase_ssd_kernel(args.seed, errs)
        phase_dense_kernels(args.seed, errs)
        phase_decode_lse(args.seed, errs)
        phase_window_kernels(args.seed, errs)
        t2 = time.perf_counter()
        phase_flash_bwd(args.seed, errs)
        log(f"[t] phase 2 flash_attn_bwd took "
            f"{time.perf_counter() - t2:.1f} s")
        t2 = time.perf_counter()
        phase_ssd_bwd(args.seed, errs)
        log(f"[t] phase 2 ssd_scan_bwd took "
            f"{time.perf_counter() - t2:.1f} s")
    log(f"[t] build and phase 2 done at {time.perf_counter() - t0:.1f} s")
    if "3" in phases:
        for mode in (*MODES, *SSM_MODES, *WINDOW_MODES):
            phase_oracle(args.seed, mode)
        for arch in (*WIDTH_ARCHS, QWEN_MOE):
            for mode in WIDTH_ORACLE_MODES:
                phase_oracle(args.seed, mode, arch)
        for mode in SSM_MODES:
            phase_oracle(args.seed, mode, HYBRID)
        _ORACLE.clear()
        gc.collect()
        torch.cuda.empty_cache()
        phase_vlm_oracle(args.seed)
        phase_encoder_oracle(args.seed)
        phase_moe_check(args.seed)
        phase_moe_graph(args.seed)
        for mode in ("paged", "slot_arena"):
            phase_spec_oracle(args.seed, mode)
        t3 = time.perf_counter()
        phase_cluster_oracle(args.seed)
        log(f"[t] phase 3 cluster scenarios took "
            f"{time.perf_counter() - t3:.1f} s")
        t3 = time.perf_counter()
        phase_spill_oracle(args.seed)
        log(f"[t] phase 3 spill scenario took "
            f"{time.perf_counter() - t3:.1f} s")
        t3 = time.perf_counter()
        phase_train_oracle(args.seed)
        log(f"[t] phase 3 training took {time.perf_counter() - t3:.1f} s")
    log(f"[t] phase 3 done at {time.perf_counter() - t0:.1f} s")
    if "4" in phases:
        runs = args.runs
        launches = phase_full(args.seed, card, "qwen3-4b", {
            "slot_dense": runs, "slot_dense_decode": max(1, runs // 2),
            "slot_arena": 1, "slot_gathered": 1,
            "paged": max(1, runs // 2), "spec": 1})
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(phase_full(args.seed, card, "mamba2-2.7b",
                                   {mode: 1 for mode in SSM_MODES}))
        gc.collect()
        torch.cuda.empty_cache()
        phase_encoder(args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        # a kernel's row keeps its first mode's count (flash_attn: the
        # qwen3-4b grid's), the windowed forms take mixtral's
        for name, row in phase_full(args.seed, card, "mixtral-8x7b",
                                    {mode: 1 for mode in WINDOW_MODES},
                                    layers=WINDOW_LAYERS).items():
            launches.setdefault(name, row)
        # the MHA configs at full width and depth in the five attention
        # modes: the @d64 / @d96 rows take their launches (every
        # attention launch there at the config's width, _serve_once)
        for arch, d in zip(WIDTH_ARCHS, ROW_WIDTHS):
            gc.collect()
            torch.cuda.empty_cache()
            for name, row in phase_full(args.seed, card, arch,
                                        {mode: 1 for mode in MODES}).items():
                if name in WIDTH_KERNELS:
                    launches[f"{name}@d{d}"] = row
        # the other dense GQA configs at head_dim 128, and qwen3-moe at
        # full depth (128 experts top 8 through the capacity dispatch,
        # 32 / 4 heads): one paged run each
        for arch in ("qwen2.5-14b", "minitron-8b", QWEN_MOE):
            gc.collect()
            torch.cuda.empty_cache()
            phase_full(args.seed, card, arch, {"paged": 1})
        # jamba cut to HYBRID_LAYERS in the three SSM modes: the
        # ssd_scan@grouped row takes its launches
        gc.collect()
        torch.cuda.empty_cache()
        for name, row in phase_full(args.seed, card, HYBRID,
                                    {mode: 1 for mode in SSM_MODES},
                                    layers=HYBRID_LAYERS).items():
            launches.setdefault(name, row)
        # training: qwen3-4b at full width, 12 layers, and mamba2-2.7b at
        # full width, 32 layers; the flash_attn@lse and flash_attn_bwd
        # rows take qwen3's launches, ssd_scan@states and ssd_scan_bwd
        # mamba2's
        for arch, layers in (("qwen3-4b", TRAIN_LAYERS),
                             ("mamba2-2.7b", TRAIN_SSM_LAYERS)):
            gc.collect()
            torch.cuda.empty_cache()
            t4 = time.perf_counter()
            launches.update(phase_train(args.seed, card, arch, layers))
            log(f"[t] phase 4 training {arch} took "
                f"{time.perf_counter() - t4:.1f} s")
        # the multi-engine cluster (qwen3-4b), then the paper's model,
        # qwen2.5-32b, at full width and depth on the paged default
        for what, fn in (("cluster", lambda: phase_cluster(args.seed, card)),
                         ("paged_spill", lambda: phase_spill(args.seed,
                                                             card)),
                         ("qwen2.5-32b", lambda: phase_full(
                             args.seed, card, "qwen2.5-32b", {"paged": 1}))):
            gc.collect()
            torch.cuda.empty_cache()
            t4 = time.perf_counter()
            fn()
            log(f"[t] phase 4 {what} took {time.perf_counter() - t4:.1f} s")
    log(f"[t] phase 4 done at {time.perf_counter() - t0:.1f} s")
    if "5" in phases:
        times = phase_times(args.seed, errs)
        phase_dense_tick(card, times)
    if phases & {"5", "5p"}:
        phase_dense_profile(args.seed, card)
        phase_decode_profile(args.seed, card)
        phase_ssm_profile(args.seed, card)
        for prof in MOE_PROFILES:
            phase_moe_profile(args.seed, card, *prof)
    log(f"[t] phase 5 done at {time.perf_counter() - t0:.1f} s")
    if "6" in phases:
        phase_launcher(card)
        t6 = time.perf_counter()
        phase_train_launcher(card)
        log(f"[t] phase 6 training launcher took "
            f"{time.perf_counter() - t6:.1f} s")
    sharded = {}
    if "7" in phases:
        t7 = time.perf_counter()
        calls = _dryrun_start()
        try:
            predicted = _predicted_peaks(args.seed)
            log(f"[t] phase 7c predictions took "
                f"{time.perf_counter() - t7:.1f} s")
            t = time.perf_counter()
            sharded["steps"] = phase_shard_steps(args.seed, predicted)
            log(f"[t] phase 7a sharded steps took "
                f"{time.perf_counter() - t:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            sharded["train"] = phase_shard_train(args.seed, predicted)
            log(f"[t] phase 7b sharded train steps took "
                f"{time.perf_counter() - t:.1f} s")
        finally:
            t = time.perf_counter()
            _dryrun_finish(calls, t7)
            log(f"[t] phase 7d dry runs waited {time.perf_counter() - t:.1f}"
                f" s more")
        log(f"[t] phase 7 took {time.perf_counter() - t7:.1f} s")
    rows = []
    for name, meta in KERNELS.items():
        t = times.get(name, {})
        n, ticks, mode = launches.get(name, (None, None, None))
        e16 = errs.get((name, torch.bfloat16))
        e32 = errs.get((name, torch.float32))
        row = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "jax": meta["jax"],
            "launches": n, "launches_mode": mode,
            "launches_per_tick": (n / ticks if n and ticks else None),
            "max_abs_err": max(e16) if e16 else None,
            "max_abs_err_fp32": max(e32) if e32 else None,
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
            "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms")}
        if sharded:
            # phase 7's launches under DTensor (counts set to 0 before
            # each run): the dense steps, then the train steps
            row["launches_sharded"] = (
                sharded["steps"]["launches"].get(name, 0)
                + sum(sharded["train"][a]["launches"].get(name, 0)
                      for a in ("qwen3-4b", "mamba2-2.7b")))
        if name in RAGGED_KERNELS:
            # the non-causal form: its launches on the main path (none:
            # every served model is causal), its errors in phase 2 and
            # 5, and, for the paged kernel, its phase-5 times
            nc = f"{name}@nc"
            tn = times.get(nc, {})
            n16 = errs.get((nc, torch.bfloat16))
            n32 = errs.get((nc, torch.float32))
            row.update({
                "launches_nc": launches.get(nc, (None,))[0],
                "max_abs_err_nc": max(n16) if n16 else None,
                "max_abs_err_nc_fp32": max(n32) if n32 else None,
                **{f"{k}_nc": tn.get(k) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}})
        rows.append(row)
    log(f"[8] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
