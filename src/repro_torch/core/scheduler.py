"""Instance-level scheduling policies and serving modes (§3, §1).

Four serving modes (paper §1) plus the two partial ablation variants of
Fig.6.  Policies are pure decision objects: the discrete-event simulator
and the real engine both drive them through the same three calls —
``enqueue``, ``next_work``, ``on_complete``.

  VANILLA           SGLang-like: single FCFS queue, memory-constrained
                    continuous batching, long+short co-batched.
  GRAPH_ONLY        VANILLA batching + bucketized graph execution (ablation).
  DISAGG_ONLY       dual-queue LP/SP separation, no AWD window/graphs (ablation).
  PLA_FULL          dual queue + AWD + graph bucketization (the paper).

Long-prefill work always advances one request at a time in fixed chunks
C_l (§3.2 "long-prefill dispatch continues to advance a single request by
fixed-size chunks"), which bounds how long a ready short batch can wait
behind a long prefill in temporal disaggregation.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.core.awd import AWDConfig, AWDScheduler
from repro_torch.core.boundary import LatencyModel
from repro_torch.core.buckets import BucketGrid
from repro_torch.core.queues import DualQueue
from repro_torch.core.request import Batch, Request


class ServingMode(str, enum.Enum):
    MIX = "mix"                       # decode co-batched with prefill
    PD_TEMPORAL = "pd_temporal"       # prefill/decode alternate on one instance
    PD_SPATIAL = "pd_spatial"         # prefill/decode on separate instances
    PREFILL_DISAGG = "prefill_disagg"  # ours: LP/SP disaggregation


class Variant(str, enum.Enum):
    VANILLA = "vanilla"
    GRAPH_ONLY = "graph_only"
    DISAGG_ONLY = "disagg_only"
    PLA_FULL = "pla_full"


@dataclasses.dataclass
class ChunkWork:
    """One long-prefill chunk advancing request `req`."""
    req: Request
    chunk_tokens: int
    done_tokens: int          # tokens already prefilled (acts as history)
    is_last: bool
    decode_tokens: int = 0    # decode rows fused into the chunk's packed
    # stream (continuous batching — the serve loop fuses the backlog
    # into chunk steps exactly as into short batches)
    uses_graph: bool = False  # chunk rides a captured token-bucket shape
    # (engine.prefill_long routes C_l chunks through the packed path)


class BasePolicy:
    """Interface: the instance asks for work whenever it goes idle."""

    def enqueue(self, r: Request, now: float) -> None:
        raise NotImplementedError

    def next_work(self, now: float):
        """Returns (Batch | ChunkWork | None, wake_time | None)."""
        raise NotImplementedError

    def on_complete(self, work, now: float) -> None:
        pass

    def note_decode_backlog(self, n: int, tokens_per_decode: int = 1) -> None:
        """Continuous batching: the serving loop reports how many
        in-flight sessions await their next decode token (each costing
        ``tokens_per_decode`` stream tokens — > 1 under speculation).
        Policies that form packed batches reserve fusion room; others
        ignore it."""
        pass

    def backlog_tokens(self) -> int:
        raise NotImplementedError

    def queue_len(self) -> int:
        raise NotImplementedError

    def drain(self) -> List[Request]:
        """Remove and return every queued request (failure re-routing)."""
        raise NotImplementedError

    def purge(self, pred) -> List[Request]:
        """Remove and return every queued request matching ``pred``
        (session close, deflection).  Concrete policies override this to
        preserve queue order and chunk progress; the fallback drains and
        re-enqueues the survivors."""
        kept: List[Request] = []
        out: List[Request] = []
        for r in self.drain():
            (out if pred(r) else kept).append(r)
        for r in kept:
            self.enqueue(r, 0.0)
        return out


class FCFSPolicy(BasePolicy):
    """Vanilla SGLang-like: memory-constrained FCFS batching; long and
    short co-batched (the interference source of §2.2).  GRAPH_ONLY adds
    bucket matching on whatever FCFS happened to batch."""

    def __init__(self, *, mem_budget_tokens: int = 16_384,
                 grid: Optional[BucketGrid] = None):
        self.queue: Deque[Request] = deque()
        self.mem_budget = mem_budget_tokens
        self.grid = grid  # non-None = GRAPH_ONLY variant

    def enqueue(self, r: Request, now: float) -> None:
        self.queue.append(r)

    def next_work(self, now: float):
        if not self.queue:
            return None, None
        batch: List[Request] = []
        tokens = 0
        seen = set()
        for r in list(self.queue):
            if batch and tokens + r.new_tokens > self.mem_budget:
                break
            if r.session >= 0 and r.session in seen:
                continue    # a session's later turn waits for its earlier
            batch.append(r)
            tokens += r.new_tokens
            seen.add(r.session)
        picked = {r.rid for r in batch}
        self.queue = deque(r for r in self.queue if r.rid not in picked)
        b = Batch(requests=batch, kind="mixed")
        if self.grid is not None:
            g = self.grid.nearest_graph([r.new_tokens for r in batch],
                                        self.mem_budget)
            if g is not None:
                b.bucket_len, b.bucket_depth = g.length, g.depth
                b.uses_graph = True
                for r in batch:
                    r.padded_to, r.used_graph = g.length, True
        return b, None

    def backlog_tokens(self) -> int:
        return sum(r.new_tokens for r in self.queue)

    def queue_len(self) -> int:
        return len(self.queue)

    def drain(self) -> List[Request]:
        out = list(self.queue)
        self.queue.clear()
        return out

    def purge(self, pred) -> List[Request]:
        out = [r for r in self.queue if pred(r)]
        if out:
            gone = {r.rid for r in out}
            self.queue = deque(r for r in self.queue if r.rid not in gone)
        return out


class TemporalDisaggPolicy(BasePolicy):
    """§3.2 temporal disaggregation on a single instance: dual queues;
    short batches formed by AWD (or plain bucketless FCFS for the
    DISAGG_ONLY ablation); long prefills advance in chunks C_l; a ready
    short batch preempts at chunk boundaries (short-priority)."""

    def __init__(self, model: LatencyModel, *, grid: Optional[BucketGrid] = None,
                 awd_cfg: Optional[AWDConfig] = None,
                 chunk_tokens: int = 2048,
                 use_awd: bool = True,
                 threshold: Optional[float] = None,
                 max_short_streak: int = 8):
        self.dq = DualQueue(model, override_threshold=threshold)
        self.grid = grid or BucketGrid()
        self.awd = AWDScheduler(self.grid, awd_cfg) if use_awd else None
        self.chunk = chunk_tokens
        self._long_progress: dict = {}   # rid -> tokens done
        # anti-starvation: under a continuous short flood, guarantee one
        # long chunk per `max_short_streak` short dispatches (bounded
        # interference: one chunk ≈ C_l·β, the paper's temporal phases)
        self.max_short_streak = max_short_streak
        self._short_streak = 0
        # the AWD hold the last answer began (its time), and the shorts
        # enqueued since, by rid: credited to Request.awd_hold_s at the
        # next answer
        self._hold_since: Optional[float] = None
        self._joined: dict = {}

    def enqueue(self, r: Request, now: float) -> None:
        cls = self.dq.push(r)
        if cls == "short" and self.awd is not None:
            self.awd.on_arrival(now)
            if r.awd_hold_s is None:
                r.awd_hold_s = 0.0
            if self._hold_since is not None:
                self._joined[r.rid] = now

    def _end_hold(self, now: float) -> None:
        """Credit each queued short with the part of the last answer's
        hold since its own enqueue."""
        t0 = self._hold_since
        if t0 is None:
            return
        self._hold_since = None
        for r in self.dq.short:
            r.awd_hold_s += now - self._joined.get(r.rid, t0)
        self._joined.clear()

    def note_decode_backlog(self, n: int, tokens_per_decode: int = 1) -> None:
        if self.awd is not None:
            self.awd.note_decode_backlog(n, tokens_per_decode)

    # ------------------------------------------------------------- short
    def _short_work(self, now: float):
        q = list(self.dq.short)
        if not q:
            return None, None
        if self.awd is not None:
            batch, wake = self.awd.decide(q, now)
            if batch is not None:
                picked = {r.rid for r in batch.requests}
                self.dq.short = deque(r for r in self.dq.short
                                      if r.rid not in picked)
            return batch, wake
        # DISAGG_ONLY: batch all queued shorts under budget, no window
        batch: List[Request] = []
        tokens = 0
        seen = set()
        for r in list(self.dq.short):
            if batch and tokens + r.new_tokens > self.grid.mem_budget:
                break
            if r.session >= 0 and r.session in seen:
                continue
            batch.append(r)
            tokens += r.new_tokens
            seen.add(r.session)
        picked = {r.rid for r in batch}
        self.dq.short = deque(r for r in self.dq.short
                              if r.rid not in picked)
        return Batch(requests=batch, kind="short"), None

    # -------------------------------------------------------------- long
    def _long_work(self) -> Optional[ChunkWork]:
        if not self.dq.long:
            return None
        r = self.dq.long[0]
        done = self._long_progress.get(r.rid, 0)
        remaining = r.new_tokens - done
        chunk = min(self.chunk, remaining)
        return ChunkWork(req=r, chunk_tokens=chunk, done_tokens=done,
                         is_last=(done + chunk >= r.new_tokens))

    def next_work(self, now: float):
        self._end_hold(now)
        if self._short_streak >= self.max_short_streak and self.dq.long:
            self._short_streak = 0
            return self._long_work(), None
        short, wake = self._short_work(now)
        if short is not None and short.requests:
            self._short_streak += 1
            return short, None
        if self.dq.short and wake is not None:
            # shorts are accumulating inside an AWD window: hold the slot
            # (the "short phase" of temporal disaggregation) instead of
            # starting a long chunk that would outlive the window —
            # otherwise long work de-facto preempts short SLAs.
            self._hold_since = now
            return None, wake
        long_work = self._long_work()
        if long_work is not None:
            self._short_streak = 0
            return long_work, wake
        return None, wake

    def on_complete(self, work, now: float) -> None:
        if isinstance(work, ChunkWork):
            if work.is_last:
                self._long_progress.pop(work.req.rid, None)
                if self.dq.long and self.dq.long[0].rid == work.req.rid:
                    self.dq.long.popleft()
            else:
                self._long_progress[work.req.rid] = \
                    work.done_tokens + work.chunk_tokens
        elif isinstance(work, Batch) and self.awd is not None:
            if work.requests and work.requests[0].dispatch_time is not None:
                fin = now - work.requests[0].dispatch_time
                self.awd.observe_service(fin)

    def backlog_tokens(self) -> int:
        return self.dq.backlog_tokens("short") + self.dq.backlog_tokens("long")

    def queue_len(self) -> int:
        return len(self.dq)

    def drain(self) -> List[Request]:
        out = list(self.dq.short) + list(self.dq.long)
        self.dq.short.clear()
        self.dq.long.clear()
        self._long_progress.clear()
        return out

    def purge(self, pred) -> List[Request]:
        out = [r for r in self.dq.short if pred(r)] + \
              [r for r in self.dq.long if pred(r)]
        if out:
            gone = {r.rid for r in out}
            self.dq.short = deque(r for r in self.dq.short
                                  if r.rid not in gone)
            self.dq.long = deque(r for r in self.dq.long
                                 if r.rid not in gone)
            for r in out:
                self._long_progress.pop(r.rid, None)
        return out


class PoolPolicy(TemporalDisaggPolicy):
    """§3.2 spatial mode: instance dedicated to ONE class (mutual
    exclusion).  pool = 'short' → AWD batches only; 'long' → chunked FCFS
    only.  The spatial controller migrates instances between pools."""

    def __init__(self, model: LatencyModel, pool: str, **kw):
        super().__init__(model, **kw)
        self.pool = pool

    def next_work(self, now: float):
        if self.pool == "short":
            b, wake = self._short_work(now)
            return (b if (b is not None and b.requests) else None), wake
        lw = self._long_work()
        return lw, None


def make_policy(variant: Variant, model: LatencyModel, *,
                grid: Optional[BucketGrid] = None,
                awd_cfg: Optional[AWDConfig] = None,
                mem_budget_tokens: int = 16_384,
                chunk_tokens: int = 2048,
                threshold: Optional[float] = None) -> BasePolicy:
    grid = grid or BucketGrid(mem_budget_tokens=mem_budget_tokens)
    if variant == Variant.VANILLA:
        return FCFSPolicy(mem_budget_tokens=mem_budget_tokens)
    if variant == Variant.GRAPH_ONLY:
        return FCFSPolicy(mem_budget_tokens=mem_budget_tokens, grid=grid)
    if variant == Variant.DISAGG_ONLY:
        return TemporalDisaggPolicy(model, grid=grid, use_awd=False,
                                    chunk_tokens=chunk_tokens,
                                    threshold=threshold)
    return TemporalDisaggPolicy(model, grid=grid, awd_cfg=awd_cfg,
                                chunk_tokens=chunk_tokens,
                                threshold=threshold)
