"""Algorithm 1 — AWD: Adaptive-Wait-Depth batching for short prefills.

Pure decision logic, shared verbatim by the discrete-event simulator
(virtual clock) and the real serving engine (wall clock).  The caller
owns the queue; AWD decides *when* to dispatch and *what* to batch.

State:
  W — waiting window, adapted from observed fill times;
  D — target depth, aligned to a captured graph shape;
  r̂ — EWMA short-request arrival rate (drives the graph window W_GR);
  Ŝ — EWMA service-time estimate (drives the SLA window W_SLA).

Dispatch triggers (any): depth(B) ≥ D · window expiry · SLA slack ≤ σ ·
head-of-line wait ≥ T_max.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.buckets import (Bucket, BucketGrid, DEFAULT_TOKEN_BUCKETS,
                                TokenBucketLadder)
from repro_torch.core.request import Batch, Request

EPS = 1e-9


@dataclasses.dataclass
class AWDConfig:
    w_min: float = 0.001          # s
    w_max: float = 0.050          # s
    sigma: float = 0.020          # SLA slack threshold (s)
    delta: float = 0.005          # safety margin inside W_SLA (s)
    t_max: float = 0.200          # absolute head-of-line wait cap (s)
    service_estimate: float = 0.010  # initial Ŝ (s)
    rate_ewma: float = 0.2        # EWMA factor for r̂
    service_ewma: float = 0.3     # EWMA factor for Ŝ
    mem_budget_tokens: Optional[int] = None  # None → the grid's budget
    deadline_free: bool = False   # §3.2(b): token-max mode
    min_fill_tokens: int = 8_192  # deadline-free: admit when tok(B) ≥ M_s
    max_pad_ratio: float = 1.5    # graph profitability guard: run the
    # standard (unpadded) kernel when padding would inflate batch tokens
    # beyond this factor — "else use standard prefill kernel" (Alg. 1 l.10).
    # Deadline-free (offline) batches are compute-bound, where padding is
    # pure compute waste — a much tighter guard applies there.
    max_pad_ratio_offline: float = 1.1
    idle_flush: float = 0.5       # deadline-free: flush residue when the
    # queue has been stagnant this long (tail requests must not starve)
    packed: bool = False          # padding-free packed prefill: batches
    # concatenate into one flat token stream bucketed on TOTAL tokens
    # (TokenBucketLadder) instead of padding to the (L, B) grid
    token_buckets: Optional[Tuple[int, ...]] = None  # None → defaults
    packed_max_seqs: int = 16     # cache rows per packed step (B_max)
    decode_window_shrink: float = 0.25  # continuous batching: every
    # waiting decode session stalls one TPOT per tick spent filling a
    # prefill batch, so the waiting window shrinks as the decode backlog
    # grows — W_eff = W / (1 + shrink · n_decode)


class AWDScheduler:
    def __init__(self, grid: BucketGrid, cfg: Optional[AWDConfig] = None):
        self.grid = grid
        self.cfg = cfg or AWDConfig()
        self.ladder: Optional[TokenBucketLadder] = None
        if self.cfg.packed:
            self.ladder = TokenBucketLadder(
                self.cfg.token_buckets or DEFAULT_TOKEN_BUCKETS,
                self.cfg.packed_max_seqs)
        # single source of truth for the memory budget (grid's by default)
        self.mem_budget = self.cfg.mem_budget_tokens or grid.mem_budget
        self.s_hat = self.cfg.service_estimate
        self.r_hat = 0.0
        self._last_arrival: Optional[float] = None
        self._accum_since: Optional[float] = None
        # init per Algorithm 1 line 1
        self.d_target = grid.max_depth(grid.lengths[0], self.mem_budget)
        self.w = self.cfg.w_max
        self.dispatches = 0
        self.graph_hits = 0
        self.decode_backlog = 0   # active decode sessions awaiting fusion
        self.decode_tokens_per = 1   # stream tokens one fused session costs

    def note_decode_backlog(self, n: int, tokens_per_decode: int = 1) -> None:
        """Continuous batching: the loop reports how many in-flight
        sessions are waiting on their next decode token.  The backlog
        shrinks the waiting window (their TPOT stalls while we wait) and
        reserves stream rows in packed batch formation.
        ``tokens_per_decode`` is the stream cost of ONE fused session —
        1 plain, 1 + k when the engine speculates (a verify segment
        carries k draft tokens besides the pending one, DESIGN.md §10) —
        so the token reserve scales while the row reserve does not."""
        self.decode_backlog = max(0, int(n))
        self.decode_tokens_per = max(1, int(tokens_per_decode))

    # ------------------------------------------------------------ signals
    def on_arrival(self, now: float) -> None:
        if self._last_arrival is not None:
            # clamp the gap: simultaneous arrivals (batch completions
            # releasing several closed-loop clients at one timestamp)
            # must not blow the EWMA up to 1/ε
            gap = max(now - self._last_arrival, 1e-4)
            inst = min(1.0 / gap, 1e4)
            a = self.cfg.rate_ewma
            self.r_hat = (1 - a) * self.r_hat + a * inst
        self._last_arrival = now

    def observe_service(self, seconds: float) -> None:
        a = self.cfg.service_ewma
        self.s_hat = (1 - a) * self.s_hat + a * seconds

    # ------------------------------------------------------------ windows
    def w_sla(self, queue: Sequence[Request], now: float) -> float:
        """Last safe time to wait before any pending request would violate
        its deadline after one prefill step of duration Ŝ."""
        ddls = [r.deadline for r in queue if r.deadline is not None]
        if not ddls:
            return float("inf")
        return max(0.0, min(ddls) - now - self.s_hat - self.cfg.delta)

    def w_gr(self, depth: int) -> float:
        """Expected time to reach target depth D at arrival rate r̂."""
        need = max(0, self.d_target - depth)
        return need / max(self.r_hat, EPS)

    def window(self, queue: Sequence[Request], now: float, depth: int) -> float:
        w = min(self.w_sla(queue, now), self.w_gr(depth))
        w = min(max(w, self.cfg.w_min), self.cfg.w_max)
        if self.decode_backlog:
            # decode sessions stall one token per tick we spend waiting:
            # trade batch fill for TPOT as the backlog grows (applied to
            # the EFFECTIVE window, after the clamp, so pressure bites
            # even when the raw window sits at w_max)
            w = max(self.cfg.w_min,
                    w / (1.0 + self.cfg.decode_window_shrink
                         * self.decode_backlog))
        return w

    # ----------------------------------------------------------- batching
    def _select(self, queue: Sequence[Request],
                depth_cap: Optional[int] = None,
                decode_tokens: int = 0) -> List[Request]:
        """Bucket-first greedy selection (Algorithm 1 line 6): requests
        ordered by (bucket, arrival) so same-length groups cluster and
        padding to the eventual NEARESTGRAPH shape stays minimal; filled
        to target depth D under the memory budget.

        Packed mode: requests cost their RAW length (no per-request
        padding exists), order is plain FCFS (packing is composition-
        independent), and the fill target is the token-bucket ladder.
        ``decode_tokens`` active decode sessions each reserve one stream
        row AND ``decode_tokens_per`` stream tokens for continuous-
        batching fusion (clamped so at least one prefill always fits)."""
        if not queue:
            return []
        cap = depth_cap if depth_cap is not None else self.d_target
        budget = self.mem_budget
        if self.ladder is not None:
            reserve = min(decode_tokens, self.ladder.max_seqs - 1)
            cap = min(cap, self.ladder.max_seqs - reserve)
            budget = min(budget, max(1, self.ladder.max_tokens
                                     - reserve * self.decode_tokens_per))
            ordered = sorted(queue, key=lambda r: r.arrival)
        else:
            ordered = sorted(
                queue, key=lambda r: (self.grid.nearest_length(r.new_tokens)
                                      or 10 ** 9, r.arrival))
        picked: List[Request] = []
        tokens = 0
        seen_sessions = set()
        for r in ordered:
            if len(picked) >= cap:
                break
            if r.session >= 0 and r.session in seen_sessions:
                # one step per session: a second queued turn depends on
                # the first turn's KV writes, so it waits for the next
                # batch (same-stream duplicates would corrupt the cache)
                continue
            pad = self._cost(r)
            if picked and tokens + pad > budget:
                break
            picked.append(r)
            tokens += pad
            seen_sessions.add(r.session)
        return picked

    def _cost(self, r: Request) -> int:
        """Tokens a request occupies in a batch shape: its padded bucket
        length on the dense grid, its raw length on the packed ladder."""
        if self.ladder is not None:
            return r.new_tokens
        return self.grid.nearest_length(r.new_tokens) or r.new_tokens

    def _sla_urgent(self, queue: Sequence[Request], now: float) -> bool:
        return any(r.slack(now, self.s_hat) <= self.cfg.sigma for r in queue)

    # ------------------------------------------------------------- decide
    def decide(self, queue: List[Request], now: float,
               force: bool = False,
               decode_tokens: Optional[int] = None
               ) -> Tuple[Optional[Batch], Optional[float]]:
        """Returns (batch_to_dispatch | None, next_wakeup_time | None).

        The caller removes the batch's requests from the queue on dispatch.
        ``decode_tokens`` (None → the noted backlog) is the number of
        in-flight decode sessions the emitted packed batch must leave
        room for — the batch comes back with ``decode_tokens`` set to the
        fusion capacity actually reserved inside its token bucket.
        """
        if decode_tokens is None:
            decode_tokens = self.decode_backlog
        if not queue:
            self._accum_since = None
            return None, None
        if self._accum_since is None:
            self._accum_since = max(now, queue[0].arrival)

        if self.cfg.deadline_free:
            # token-max policy (§3.2b): pack to the full memory budget
            # (no depth target — offline cares about throughput only);
            # admit when tok(B) ≥ M_s, or flush the residue once the
            # queue has been stagnant for idle_flush seconds
            batch = self._select(queue, depth_cap=10 ** 9)
            tok = sum(r.new_tokens for r in batch)
            stagnant = now - self._accum_since >= self.cfg.idle_flush
            # "full" = the packer stopped on the budget while work remains
            # (real tokens can sit below min_fill forever once padding
            # hits the budget — dispatch, don't wait for the idle timer)
            full = len(batch) < len(queue)
            if tok >= self.cfg.min_fill_tokens or full or stagnant or force:
                return self._emit(batch, now), None
            return None, self._accum_since + self.cfg.idle_flush

        batch = self._select(queue, decode_tokens=decode_tokens)
        elapsed = now - self._accum_since
        w = self.window(queue, now, len(batch))
        urgent = self._sla_urgent(queue, now)
        hol = now - queue[0].arrival
        if (urgent or hol >= self.cfg.t_max) and queue:
            # SLA path: flush deadline-ordered, regardless of bucket
            batch = self._flush_select(queue)
            return self._emit(batch, now, sla_flush=True,
                              decode_tokens=decode_tokens), None
        # waiting is only rational if ≥1 more request is expected to
        # arrive inside the remaining window (napkin math: r̂·W ≥ 1)
        futile = self.r_hat * max(w - elapsed, 0.0) < 1.0
        if force or (batch and (len(batch) >= self.d_target or elapsed >= w
                                or futile)):
            return self._emit(batch, now, decode_tokens=decode_tokens), None
        wake = self._accum_since + w
        ddls = [r.deadline - self.s_hat - self.cfg.sigma
                for r in queue if r.deadline is not None]
        if ddls:
            wake = min(wake, min(ddls))
        return None, max(wake, now + EPS)

    def _flush_select(self, queue: Sequence[Request]) -> List[Request]:
        """Deadline-ordered flush packed to the memory budget — a flush
        must clear backlog, so it is NOT capped at the captured-graph
        depth (an over-deep flush simply runs the standard kernel)."""
        picked: List[Request] = []
        tokens = 0
        seen_sessions = set()
        for r in sorted(queue, key=lambda r: (r.deadline is None,
                                              r.deadline or r.arrival)):
            if r.session >= 0 and r.session in seen_sessions:
                continue          # same-session turns never share a step
            pad = self._cost(r)
            if picked and tokens + pad > self.mem_budget:
                break
            picked.append(r)
            tokens += pad
            seen_sessions.add(r.session)
        return picked

    def _emit(self, requests: List[Request], now: float,
              sla_flush: bool = False, decode_tokens: int = 0) -> Batch:
        lengths = [r.new_tokens for r in requests]
        batch = Batch(requests=list(requests), kind="short")
        real = max(sum(lengths), 1)
        ratio = self.cfg.max_pad_ratio_offline if self.cfg.deadline_free \
            else self.cfg.max_pad_ratio
        if self.ladder is not None:
            # packed path: one flat stream in the total-token bucket —
            # the profitability guard only sees the bucket tail.  Fused
            # decode rows (continuous batching) count as real tokens —
            # ``decode_tokens_per`` each when the engine speculates —
            # the bucket must cover them and they discount the tail.
            # When the full reserve busts the ladder, fuse FEWER decodes
            # rather than losing the packed path for the whole batch.
            per = self.decode_tokens_per
            fused = max(0, min(decode_tokens,
                               self.ladder.max_seqs - len(requests)))
            tb = self.ladder.bucket_for(sum(lengths) + fused * per)
            while tb is None and fused > 0:
                fused -= 1
                tb = self.ladder.bucket_for(sum(lengths) + fused * per)
            if tb is not None and len(requests) <= self.ladder.max_seqs \
                    and tb <= ratio * (real + fused * per):
                batch.token_bucket = tb
                batch.uses_graph = True
                batch.decode_tokens = fused
                if fused:
                    batch.kind = "mixed"
                self.graph_hits += 1
                for r in requests:
                    r.used_graph = True
        if not batch.uses_graph:
            # dense (L, B) grid — also the packed mode's fallback when
            # the token bucket flunks profitability (a small batch in a
            # big bucket): a captured grid shape still beats an eager
            # compile of the exact batch shape at serve time
            g = self.grid.nearest_graph(lengths, self.mem_budget)
            if g is not None and g.length * len(requests) <= ratio * real:
                batch.bucket_len, batch.bucket_depth = g.length, g.depth
                batch.uses_graph = True
                self.graph_hits += 1
                for r in requests:
                    r.padded_to, r.used_graph = g.length, True
        self.dispatches += 1
        # Algorithm 1 lines 11–15: adapt W / D from fill behaviour.
        # SLA flushes bypass the adaptation — shrinking D on a deadline
        # flush would spiral target depth (and throughput) down.
        fill = now - (self._accum_since if self._accum_since is not None else now)
        d = len(requests)
        if not sla_flush:
            if d >= self.d_target:
                # Algorithm 1 l.13: W ← clip(τ); grow D only on fast fills
                # (demand clearly supports a deeper target)
                self.w = min(max(fill, self.cfg.w_min), self.cfg.w_max)
                if fill < 0.5 * self.w or self.r_hat * self.cfg.w_max > 2 * d:
                    self.d_target = self._next_depth_up(d)
            else:
                self.d_target = max(1, self._depth_floor(d))
        self._accum_since = None
        return batch

    # depth adaptation helpers: D moves along the captured-depth grid
    def _next_depth_up(self, d: int) -> int:
        for dep in self.grid.depths:
            if dep > d:
                return dep
        return self.grid.depths[-1]

    def _depth_floor(self, d: int) -> int:
        best = self.grid.depths[0]
        for dep in self.grid.depths:
            if dep <= d:
                best = dep
        return best

    @property
    def graph_hit_rate(self) -> float:
        return self.graph_hits / self.dispatches if self.dispatches else 0.0
