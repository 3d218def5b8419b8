"""Ground-truth service-time model for the discrete-event simulator.

Roofline (max) form of §2.1's T(L,H) at batch level:

  T(batch) = launch + max( T_comp(batch), T_mem(batch) )
  T_comp   = Σ_i [ α·L'_i·(L'_i + 2H_i) + β·L'_i ]          (MXU/tensor-core)
  T_mem    = weight_read + Σ_i [ w_tok·L'_i + γ_r·H_i ]     (HBM)

where L'_i is the *padded* length when the batch runs as a captured
graph.  The max() is the whole §2.1 story: a batch is memory-bound
(weight-read-dominated) until its total compute crosses the weight-read
floor — so batching/padding short re-prefills is nearly free up to the
boundary, and the AWD waiting window buys weight-read amortization,
while long prefills sit firmly on the compute side.  Launch overhead
(scheduler dispatch + kernel launches) drops to graph_launch for
captured shapes.

Calibrated for H200 + Qwen2.5-32B/14B/7B (bf16): weight_read = bytes /
4.8 TB/s; α/β scaled by parameter count.  The single-request restriction
of this model is what core.boundary fits at runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.request import Batch
from repro_torch.core.scheduler import ChunkWork


@dataclasses.dataclass(frozen=True)
class CostModel:
    alpha: float            # s/token² attention compute
    beta: float             # s/token linear compute
    w_tok: float            # s/token KV write
    gamma_r: float          # s/history-token KV read (re-prefill)
    weight_read: float      # s per batch step (weights HBM read)
    launch: float = 2.0e-3  # unbatched kernel-launch + dispatch overhead
    graph_launch: float = 3.0e-4   # captured graph / AOT executable launch
    graph_lookup: float = 5.0e-5   # §4.2 per-step graph lookup/selection
    decode_step: Optional[float] = None   # defaults to weight_read
    decode_per_seq: float = 1.0e-4
    # s/token for linear-only tail/pad rows (packed bucket tails, decode
    # ladder pad rows).  Calibratable against real tail-row cost — see
    # benchmarks.roofline.fit_beta_tail; None falls back to β.
    beta_tail: Optional[float] = None
    # sliding-window width (DESIGN.md §7): attention compute and cached
    # KV reads clamp history to min(h, window) — the windowed ragged
    # kernels stream O(min(cached, window)) rows per token, so the
    # model must bill the same.  None = full attention.
    window: Optional[int] = None
    # paged KV arena (DESIGN.md §8): page_size set bills the page-table
    # walk — page_lookup per logical KV block touched (the scalar-
    # prefetched indirection the paged kernels add over the slot map).
    # Prefix hits need NO extra term: the sim's admission converts
    # matched pages from new tokens into history, and history already
    # bills γ_r reads only (no prefill FLOPs, no KV writes) — exactly
    # what the suffix-only step executes.
    page_size: Optional[int] = None
    page_lookup: float = 2.0e-7    # s per page-table entry walked
    # §9 arena→arena KV handoff (spatial disaggregation): migrating a
    # session's cached KV between engines is a device-to-device copy —
    # ~0.26 MB/token for a 32B bf16 config over an NVLink-class fabric
    # (~0.9 TB/s) plus a fixed launch.  Billed by ClusterSim when
    # decode_handoff moves a prefilled session to a decode instance.
    handoff_per_token: float = 2.9e-7
    handoff_launch: float = 5.0e-4
    # §12 host-tier page spill: promoting an evicted prefix page back
    # from the host pool is a host→device copy over PCIe-class
    # bandwidth — roughly an order of magnitude slower per token than
    # the NVLink handoff path, but still far cheaper than re-prefilling
    # the page (α·l² compute + writes).  Billed per token restored.
    swap_beta: float = 3.0e-6
    swap_launch: float = 1.5e-4
    # §10 speculative decoding: host-side draft proposal cost per draft
    # token (n-gram table lookups — tiny next to a dispatch; a
    # small-model draft would calibrate this much higher)
    draft_per_token: float = 2.0e-5

    # ------------------------------------------------------------ pieces
    def handoff_time(self, ctx: int) -> float:
        """Migrate ``ctx`` cached tokens engine→engine (§9)."""
        return self.handoff_launch + self.handoff_per_token * max(ctx, 0)

    def swap_in_time(self, tokens: int) -> float:
        """Promote ``tokens`` spilled KV tokens host→device (§12).
        Zero when nothing is promoted — the launch is only paid when a
        copy actually crosses PCIe."""
        if tokens <= 0:
            return 0.0
        return self.swap_launch + self.swap_beta * tokens

    def predicted_wait(self, queue_len: int, backlog_tokens: int,
                       active_decodes: int = 0,
                       batch_hint: int = 8) -> float:
        """Admission-control queue-wait estimate (§11): how long the
        work already queued ahead keeps the engine busy.  The backlog
        drains as packed steps of roughly ``batch_hint`` requests each —
        one weight read + launch per step (the AWD amortization), linear
        compute / KV writes per queued token under the roofline max, and
        the resident decode backlog stealing decode_per_seq per step.
        Deliberately coarse: the gate needs a monotone, conservative
        ordering of "how doomed is this submit", not a simulation."""
        if queue_len <= 0 and backlog_tokens <= 0:
            return 0.0
        steps = -(-max(queue_len, 1) // max(batch_hint, 1))
        comp = self.beta * backlog_tokens
        mem = steps * self.weight_read + self.w_tok * backlog_tokens
        return (steps * self.graph_launch + max(comp, mem)
                + steps * self.decode_per_seq * max(active_decodes, 0))

    def predicted_ttft(self, l: int, h: int, queue_len: int,
                       backlog_tokens: int,
                       active_decodes: int = 0) -> float:
        """Predicted TTFT for a submit arriving NOW: queue wait ahead of
        it plus its own single-request service time.  The §11 admission
        gate rejects when ``now + predicted_ttft > deadline`` — a
        guaranteed violation is cheaper refused than served late."""
        return (self.predicted_wait(queue_len, backlog_tokens,
                                    active_decodes)
                + self.single(l, h))

    @property
    def tail_coef(self) -> float:
        """Linear cost of one tail/pad row (β_tail, falling back to β)."""
        return self.beta if self.beta_tail is None else self.beta_tail

    def _h_eff(self, h: int) -> int:
        """Attended history: full, or window-clamped for SWA configs."""
        return h if self.window is None else min(h, self.window)

    def _page_walk(self, ctx: int) -> float:
        """Page-table indirection for one segment attending over ``ctx``
        tokens: one prefetched lookup per logical KV block (0 when the
        arena is slot-mapped, i.e. page_size is None)."""
        if self.page_size is None or ctx <= 0:
            return 0.0
        return self.page_lookup * (-(-ctx // self.page_size))

    def comp_time(self, l: int, h: int = 0, padded: Optional[int] = None) -> float:
        lp = padded if padded is not None else l
        return self.alpha * lp * (lp + 2 * self._h_eff(h)) + self.beta * lp

    def mem_time(self, l: int, h: int = 0, padded: Optional[int] = None) -> float:
        lp = padded if padded is not None else l
        return self.w_tok * lp + self.gamma_r * self._h_eff(h)

    def single(self, l: int, h: int = 0) -> float:
        """Single-request service time (what runtime fitting samples)."""
        return self.launch + max(self.comp_time(l, h),
                                 self.weight_read + self.mem_time(l, h))

    # ------------------------------------------------------------- batch
    def packed_batch_time(self, batch: Batch, gather_rows: int = 0) -> float:
        """Token-bucket pricing for packed / mixed steps.

        A packed batch executes RAW per-request tokens (no per-request
        padding) plus the bucket tail — tail rows run the linear stack
        and a junk KV write but no useful attention, so they cost
        β + w_tok each.  Fused decode rows (continuous batching) ride
        the SAME dispatch: they share the per-step weight read and add
        only their linear work plus the per-sequence decode overhead —
        the saving vs. a separate decode step is exactly one weight
        read + launch.  The stream runs as ONE fused kernel, so the
        roofline max() overlap survives even for heterogeneous mixes
        (unlike co-batched separate kernels, §2.2).

        The arena-resident step (§6) moves O(history + new) KV rows —
        exactly the mem term above.  ``gather_rows`` bills the LEGACY
        gathered-cache path: the whole-slot copies (2 · b_max · S_max
        rows per step, gather out + scatter back) that the slot-map
        kernel eliminated, at γ_r per row; 0 on the arena path."""
        fixed = self.graph_launch + self.graph_lookup
        comp = sum(self.comp_time(r.new_tokens, r.history_tokens)
                   for r in batch.requests)
        mem = self.weight_read + sum(
            self.mem_time(r.new_tokens, r.history_tokens)
            for r in batch.requests)
        tail = max(0, (batch.token_bucket or 0) - batch.stream_tokens)
        comp += self.tail_coef * tail
        mem += self.w_tok * tail + self.gamma_r * gather_rows
        fused = batch.decode_tokens * (self.beta + self.w_tok
                                       + self.decode_per_seq)
        # §8: one page-table walk per logical KV block each segment
        # attends over (prefix-hit pages included — they are read)
        fixed += sum(self._page_walk(self._h_eff(r.history_tokens)
                                     + r.new_tokens)
                     for r in batch.requests)
        return fixed + max(comp, mem) + fused

    def batch_time(self, batch: Batch, long_threshold: float = 256.0,
                   gather_rows: int = 0) -> float:
        if batch.is_packed:
            return self.packed_batch_time(batch, gather_rows)
        if batch.uses_graph:
            fixed = self.graph_launch + self.graph_lookup
            pad = batch.bucket_len
        else:
            fixed = self.launch
            pad = None
        comp = sum(self.comp_time(r.new_tokens, r.history_tokens, pad)
                   for r in batch.requests)
        mem = self.weight_read + sum(
            self.mem_time(r.new_tokens, r.history_tokens, pad)
            for r in batch.requests)
        # §2.1/§2.2 compute–memory contention: a homogeneous batch overlaps
        # its compute and memory phases (roofline max); mixing compute-bound
        # long GEMMs with memory-bound short KV traffic destroys the
        # overlap — the mixed batch pays comp + mem serially.
        kinds = {r.new_tokens >= long_threshold for r in batch.requests}
        if len(kinds) > 1:
            return fixed + comp + mem
        return fixed + max(comp, mem)

    def chunk_time(self, w: ChunkWork, gather_rows: int = 0) -> float:
        """One long-prefill chunk: C_l new tokens on top of
        (done + history) context.  A chunk riding a captured token-bucket
        shape (uses_graph) pays the graph launch, not the eager one;
        fused decode rows share the step's weight read — same pricing as
        :meth:`packed_batch_time`'s fusion term.  ``gather_rows`` bills
        the legacy whole-slot gather/scatter (γ_r per copied row) that
        the arena-resident step (§6) eliminated; 0 on the arena path."""
        h = w.done_tokens + w.req.history_tokens
        fixed = self.graph_launch + self.graph_lookup if w.uses_graph \
            else self.launch
        fixed += self._page_walk(self._h_eff(h) + w.chunk_tokens)
        fused = w.decode_tokens * (self.beta + self.w_tok
                                   + self.decode_per_seq)
        return fixed + max(
            self.comp_time(w.chunk_tokens, h),
            self.weight_read + self.mem_time(w.chunk_tokens, h)
            + self.gamma_r * gather_rows) + fused

    def decode_step_time(self, n_active: int) -> float:
        """Legacy decode pricing: per-step weight read + per-seq launch
        overhead, blind to context lengths.  Kept for callers without
        length bookkeeping; prefer :meth:`decode_bucket_time`."""
        base = self.decode_step if self.decode_step is not None \
            else self.weight_read
        return base + self.decode_per_seq * n_active

    def decode_bucket_time(self, cached_lens: Sequence[int],
                           bucket: Optional[int] = None) -> float:
        """Arena-resident bucketed decode tick (DESIGN.md §5).

        Billed on ACTUAL cached lengths: one weight read per BUCKETED
        step (not per session count — the captured executable amortizes
        it across the rung), γ_r per cached token streamed in place,
        one new KV row written (w_tok) per session, β linear per live
        row and β_tail per ladder pad row.  The dense-gather path this
        replaces moved O(S_max) arena rows per session per token; here
        HBM traffic follows the valid prefixes only."""
        n = len(cached_lens)
        if n == 0:
            return 0.0
        b = bucket if bucket is not None else n
        comp = self.beta * n + self.tail_coef * max(0, b - n)
        mem = self.weight_read + sum(self.gamma_r * self._h_eff(h)
                                     + self.w_tok for h in cached_lens)
        walk = sum(self._page_walk(self._h_eff(h) + 1)
                   for h in cached_lens)
        return self.graph_launch + self.graph_lookup + walk \
            + max(comp, mem) + self.decode_per_seq * n

    def spec_step_time(self, cached_lens: Sequence[int], k: int,
                       bucket: Optional[int] = None) -> float:
        """One speculative verify tick (DESIGN.md §10): every session's
        segment carries 1 + k stream tokens (pending + drafts), so the
        linear work and KV writes scale like a (1+k)-token packed row
        per session — but the weight read is still paid ONCE for the
        whole dispatch.  That amortization is the speculative win: a
        tick that commits 1 + α·k tokens costs far less than 1 + α·k
        plain decode ticks, each of which re-reads the weights.  Draft
        proposal adds draft_per_token per proposed token (host-side)."""
        n = len(cached_lens)
        if n == 0:
            return 0.0
        rows = n * (1 + k)
        b = bucket if bucket is not None else rows
        comp = self.beta * rows + self.tail_coef * max(0, b - rows) \
            + self.alpha * sum((1 + k) * ((1 + k) + 2 * self._h_eff(h))
                               for h in cached_lens)
        mem = self.weight_read + sum(
            self.gamma_r * self._h_eff(h) + self.w_tok * (1 + k)
            for h in cached_lens)
        walk = sum(self._page_walk(self._h_eff(h) + 1 + k)
                   for h in cached_lens)
        return self.graph_launch + self.graph_lookup + walk \
            + max(comp, mem) + self.decode_per_seq * n \
            + self.draft_per_token * k * n

    def work_time(self, work, gather_rows: int = 0) -> float:
        if isinstance(work, ChunkWork):
            return self.chunk_time(work, gather_rows)
        return self.batch_time(work, gather_rows=gather_rows)


def decode_hbm_bytes_per_token(cached_len: int, s_max: int,
                               kv_row_bytes: float, *, arena: bool,
                               window: Optional[int] = None) -> float:
    """Modeled KV HBM traffic to generate ONE token for one session.

    arena=False (dense gather/scatter): the session's whole (S_max,)
    arena slot is gathered out, attention reads the valid prefix, and
    the whole slot is scattered back — 2·S_max slot-copy rows plus the
    attended prefix and the new row.  arena=True (in-place): only the
    valid prefix is streamed and one new row is written.

    ``window``: sliding-window width — the attended prefix clamps to
    min(cached, window) on BOTH paths (§7): the windowed kernel streams
    only in-window rows, and the dense step's masked reads still touch
    only the window's rows of the gathered copy.  The dense path keeps
    paying the 2·S_max whole-slot round-trip regardless — that copy is
    blind to the mask, which is exactly the traffic the rolling arena
    retires.

    kv_row_bytes: bytes of one cached token's K+V across all layers
    (2 · layers · Hkv · D · dtype_bytes).  Pure arithmetic so the
    benchmark, the simulator, and the docs all quote the same number.
    """
    attended = cached_len if window is None else min(cached_len, window)
    if arena:
        return kv_row_bytes * (attended + 1)
    return kv_row_bytes * (2 * s_max + attended + 1)


def packed_hbm_bytes_per_step(new_tokens: Sequence[int],
                              histories: Sequence[int], s_max: int,
                              n_rows: int, kv_row_bytes: float, *,
                              arena: bool,
                              window: Optional[int] = None) -> float:
    """Modeled KV HBM traffic of ONE packed prefill / mixed / chunk step
    (the prefill sibling of :func:`decode_hbm_bytes_per_token`).

    Every step reads each segment's attended prefix (history + new) and
    writes its new rows.  arena=False (legacy gathered-cache path): the
    step ALSO copies ``n_rows`` whole (S_max,) arena slots out before
    the dispatch and scatters them back after — 2 · n_rows · S_max
    slot-copy rows regardless of how few tokens the bucket holds, the
    exact O(b_max · S_max) round-trip the slot-map kernel (§6) kills.
    arena=True: only the O(history + new) rows move.

    kv_row_bytes: bytes of one cached token's K+V across all layers
    (2 · layers · Hkv · D · dtype_bytes).  Pure arithmetic so the
    benchmark, the simulator, and the docs all quote the same number.

    ``window``: sliding-window width — each segment's attended read
    clamps to min(history, window) + new on both paths (§7), while the
    dense path's whole-slot round-trip stays 2 · n_rows · s_max.
    """
    def _h(h: int) -> int:
        return h if window is None else min(h, window)

    useful = sum(_h(h) + l for h, l in zip(histories, new_tokens))  # reads
    useful += sum(new_tokens)                                       # writes
    if arena:
        return kv_row_bytes * useful
    return kv_row_bytes * (useful + 2 * n_rows * s_max)


def _scaled(params_b: float) -> CostModel:
    """Calibration scaled by parameter count (H200 SXM, bf16, 4.8 TB/s).

    γ_r is the *physical* KV re-read: ~0.26 MB per history token (32B:
    64L × 8KV × 128D × 2B × K+V) / 4.8 TB/s ≈ 5.4e-8 s — re-prefill
    memory-boundness comes from the per-step weight read, which dominates
    short batches exactly as §2.1 argues."""
    # α = 4·d_attn·layers / peak ≈ 4·5120·64 / 990e12 ≈ 1.3e-9 s per
    # (token × context) pair; β = 2N/peak ≈ 6.5e-5 s/token (32B).
    s = params_b / 32.0
    return CostModel(
        alpha=1.3e-9 * s, beta=6.5e-5 * s, w_tok=2.0e-6 * s,
        gamma_r=5.4e-8 * s, weight_read=0.013 * s,
    )


H200_32B = _scaled(32.0)
H200_14B = _scaled(14.0)
H200_7B = _scaled(7.0)
