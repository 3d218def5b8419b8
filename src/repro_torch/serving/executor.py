"""Bucketed step executors of the port, from ``repro.serving.executor``:
the dense (L, B) grid (:class:`BucketExecutor`), the packed token-bucket
steps over gathered caches, the slot arena and the page pool
(:class:`PackedBucketExecutor`), and the bucketed decode steps over the
slot arena and the page pool (:class:`DecodeBucketExecutor`).

The JAX package lowers and compiles one executable per bucket shape —
its analogue of CUDA Graph capture, the paper's (L, B) grid captured at
system init.  Here every step shape is one CUDA graph
(``serving/graphs.py``): captured at the shape's first dispatch, or
earlier by a ``precapture*``, on parked inputs, and replayed by every
dispatch.  The shape keys are the JAX executors', so hits, misses,
``shapes_by_kind`` and ``dispatches`` are theirs.  Step inputs are host
int32 arrays, staged by the graph; the state (parameters, arena,
gathered caches) is read and written in place by address.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.buckets import (DEFAULT_DECODE_BUCKETS,
                                      DEFAULT_TOKEN_BUCKETS,
                                      DecodeBucketLadder, TokenBucketLadder)
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.serving import trace
from repro_torch.serving.graphs import StepGraph


def make_prefill_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(B,L), positions(B,L), caches, sample_idx(B,)) →
    last_logits(B,V).  The dense (L, B) grid step: first prefill AND
    re-prefill (positions carry the history offset); the gathered
    caches are written in place and each row attends from positions[b,
    0] on (``ops.mha``).  Each row's real length is
    ``sample_idx + 1`` (SSM layers make the padding past it an identity
    of their state)."""

    @torch.no_grad()
    def prefill_step(params, tokens, positions, caches, sample_idx):
        logits = tr.forward(params, cfg, tokens, positions, caches=caches,
                            seq_valid_len=sample_idx + 1)
        rows = torch.arange(tokens.shape[0], device=logits.device)
        return logits[rows, sample_idx.long()]

    return prefill_step


def make_decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(B,1), positions(B,1), caches) → logits(B,V).  The
    dense (B, 1) decode step over gathered caches, written in place;
    each row attends its first positions + 1 keys (``ops.decode``)."""

    @torch.no_grad()
    def decode_step(params, tokens, positions, caches):
        return tr.forward(params, cfg, tokens, positions, caches=caches,
                          logits_slice="last")

    return decode_step


def make_packed_prefill_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(T,), positions(T,), seg_ids(T,), cu_seqlens(B+1,),
    q_offsets(B,), kv_lengths(B,), caches, last_idx(B,)) →
    last_logits(B,V).  Padding-free packed prefill over gathered caches,
    written in place."""

    @torch.no_grad()
    def packed_step(params, tokens, positions, seg_ids, cu_seqlens,
                    q_offsets, kv_lengths, caches, last_idx):
        return tr.forward_packed(
            params, cfg, tokens=tokens, positions=positions,
            seg_ids=seg_ids, cu_seqlens=cu_seqlens, q_offsets=q_offsets,
            kv_lengths=kv_lengths, caches=caches, last_idx=last_idx)

    return packed_step


def make_packed_arena_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(T,), positions(T,), seg_slots(T,), slot_map(B,),
    cu_seqlens(B+1,), q_offsets(B,), kv_lengths(B,), arena, last_idx(B,))
    → (last_logits(B,V), greedy_ids(B,)).  Arena-resident packed
    prefill: the slot arena is read in place through the slot map and
    only the step's new KV rows are written."""

    @torch.no_grad()
    def packed_step(params, tokens, positions, seg_slots, slot_map,
                    cu_seqlens, q_offsets, kv_lengths, arena, last_idx):
        last = tr.forward_packed_arena(
            params, cfg, tokens=tokens, positions=positions,
            seg_slots=seg_slots, slot_map=slot_map, cu_seqlens=cu_seqlens,
            q_offsets=q_offsets, kv_lengths=kv_lengths, arena=arena,
            last_idx=last_idx)
        return last, torch.argmax(last, dim=-1).to(torch.int32)

    return packed_step


def make_arena_decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(B,), slot_map(B,), write_pos(B,), kv_lengths(B,),
    arena) → (logits(B,V), greedy_ids(B,)).  Arena-resident decode: one
    new KV row per row written in place, the arena read through the slot
    map."""

    @torch.no_grad()
    def decode_step(params, tokens, slot_map, write_pos, kv_lengths, arena):
        logits = tr.forward_decode_arena(
            params, cfg, tokens=tokens, slot_map=slot_map,
            write_pos=write_pos, kv_lengths=kv_lengths, arena=arena)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    return decode_step


def make_packed_paged_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(T,), positions(T,), token_pages(T,), token_offs(T,),
    page_table(B,P_max), cu_seqlens(B+1,), q_offsets(B,), kv_lengths(B,),
    arena, last_idx(B,), state_map(B,)) → (last_logits(B,V),
    greedy_ids(B,)).  The page pool is read through the page table and
    written in place; SSM positions step the state page named by
    ``state_map``."""

    @torch.no_grad()
    def packed_step(params, tokens, positions, token_pages, token_offs,
                    page_table, cu_seqlens, q_offsets, kv_lengths, arena,
                    last_idx, state_map):
        last = tr.forward_packed_paged(
            params, cfg, tokens=tokens, positions=positions,
            token_pages=token_pages, token_offs=token_offs,
            page_table=page_table, cu_seqlens=cu_seqlens,
            q_offsets=q_offsets, kv_lengths=kv_lengths, arena=arena,
            last_idx=last_idx, state_map=state_map)
        return last, torch.argmax(last, dim=-1).to(torch.int32)

    return packed_step


def make_packed_verify_arena_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(T,), positions(T,), seg_slots(T,), slot_map(B,),
    cu_seqlens(B+1,), q_offsets(B,), kv_lengths(B,), arena,
    gather_idx(B,L)) → (logits(B,L,V), greedy_ids(B,L)).  Speculative
    verification: the arena-resident packed step gathering EVERY row's
    logits per segment instead of one; ``greedy_ids`` is the per-row
    on-device argmax, so all-greedy acceptance walks it without shipping
    (B, L, V) to host."""

    @torch.no_grad()
    def verify_step(params, tokens, positions, seg_slots, slot_map,
                    cu_seqlens, q_offsets, kv_lengths, arena, gather_idx):
        logits = tr.forward_packed_verify_arena(
            params, cfg, tokens=tokens, positions=positions,
            seg_slots=seg_slots, slot_map=slot_map, cu_seqlens=cu_seqlens,
            q_offsets=q_offsets, kv_lengths=kv_lengths, arena=arena,
            gather_idx=gather_idx)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    return verify_step


def make_packed_verify_paged_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(T,), positions(T,), token_pages(T,), token_offs(T,),
    page_table(B,P_max), cu_seqlens(B+1,), q_offsets(B,), kv_lengths(B,),
    arena, gather_idx(B,L)) → (logits(B,L,V), greedy_ids(B,L)).  Paged
    speculative verification."""

    @torch.no_grad()
    def verify_step(params, tokens, positions, token_pages, token_offs,
                    page_table, cu_seqlens, q_offsets, kv_lengths, arena,
                    gather_idx):
        logits = tr.forward_packed_verify_paged(
            params, cfg, tokens=tokens, positions=positions,
            token_pages=token_pages, token_offs=token_offs,
            page_table=page_table, cu_seqlens=cu_seqlens,
            q_offsets=q_offsets, kv_lengths=kv_lengths, arena=arena,
            gather_idx=gather_idx)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    return verify_step


def make_paged_decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(B,), positions(B,), write_pages(B,), write_offs(B,),
    page_table(B,P_max), kv_lengths(B,), arena, state_map(B,)) →
    (logits(B,V), greedy_ids(B,)).  Paged decode, pool written in place;
    SSM positions step the state page named by ``state_map``."""

    @torch.no_grad()
    def decode_step(params, tokens, positions, write_pages, write_offs,
                    page_table, kv_lengths, arena, state_map):
        logits = tr.forward_decode_paged(
            params, cfg, tokens=tokens, positions=positions,
            write_pages=write_pages, write_offs=write_offs,
            page_table=page_table, kv_lengths=kv_lengths, arena=arena,
            state_map=state_map)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    return decode_step


def _parked(args: Sequence[Any], values: Dict[int, int]) -> tuple:
    """``args`` with every int32 input replaced by a constant array of
    its shape: ``values[i]`` at position i, 0 elsewhere."""
    return tuple(np.full(a.shape, values.get(i, 0), np.int32)
                 if isinstance(a, np.ndarray) else a
                 for i, a in enumerate(args))


class _ExecutorBase:
    """Shape-keyed step graphs, dispatch accounting and padding stats.

    Every step goes through :meth:`_step`: the first dispatch of a shape
    key is a miss and captures the shape's :class:`StepGraph` on parked
    inputs (``compile_times`` gets the warm-up plus capture seconds),
    every dispatch replays it.  The keys are the JAX executors' (kind,
    then the shape and dtype of the inputs that fix the shape), so
    hits, misses and ``shapes_by_kind`` stay theirs."""

    def __init__(self, graph_pool: Optional[tuple] = None) -> None:
        # shape key → warm-up plus capture seconds of its graph
        self.compile_times: Dict[Tuple, float] = {}
        # shape key → its captured step
        self.graphs: Dict[Tuple, StepGraph] = {}
        # one memory pool for every graph of an engine (None: each graph
        # its own)
        self.graph_pool = graph_pool
        self.hits = 0
        self.misses = 0
        self.useful_tokens = 0     # real tokens executed
        self.total_tokens = 0      # tokens incl. bucket padding
        self.kind_hits: Dict[str, int] = {}
        self.kind_misses: Dict[str, int] = {}

    @staticmethod
    def _key(kind: str, *arrays) -> Tuple:
        return (kind,) + tuple((tuple(a.shape), str(a.dtype))
                               for a in arrays)

    def _note_dispatch(self, kind: str, *arrays) -> Tuple:
        """Count one dispatch of the step ``kind`` at the shapes of
        ``arrays`` (a miss the first time); returns its key."""
        key = self._key(kind, *arrays)
        if key not in self.compile_times:
            self.misses += 1
            self.kind_misses[kind] = self.kind_misses.get(kind, 0) + 1
            self.compile_times[key] = 0.0
        else:
            self.hits += 1
            self.kind_hits[kind] = self.kind_hits.get(kind, 0) + 1
        return key

    def _graph(self, key: Tuple, fn: Callable, parked: tuple) -> StepGraph:
        """The graph of shape ``key``, captured on ``parked`` at its
        first use."""
        g = self.graphs.get(key)
        if g is None:
            t0 = time.perf_counter()
            with trace.span("graph.capture", kind=key[0]):
                g = StepGraph(fn, parked, pool=self.graph_pool)
                if g.device.type == "cuda":
                    torch.cuda.synchronize(g.device)
            self.compile_times[key] = time.perf_counter() - t0
            self.graphs[key] = g
        return g

    def _step(self, kind: str, keyed: Tuple[int, ...], fn: Callable,
              args: tuple, park: Dict[int, int],
              fill: Optional[Callable[[], Any]] = None):
        """One dispatch of step ``kind``: ``fn(*args)`` with the host
        arrays of ``args`` as its int32 inputs, keyed by the shapes of
        ``args[i]`` for i in ``keyed``.  A miss captures the graph on
        ``args`` parked by ``park`` (position → value); then the graph
        replays on ``args``, ``fill`` copying state in first.  Returns
        the graph's static outputs."""
        args = tuple(np.asarray(a, np.int32) if isinstance(a, np.ndarray)
                     else a for a in args)
        key = self._note_dispatch(kind, *(args[i] for i in keyed))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self._graph(key, fn, _parked(args, park))
        return graph.run(args, fill)

    def _precapture(self, kind: str, keyed: Tuple[int, ...], fn: Callable,
                    parked: tuple) -> None:
        """Capture one shape at init on ``parked`` inputs, counted as a
        dispatch of ``kind`` (as the JAX executors count the compile)."""
        key = self._note_dispatch(kind, *(parked[i] for i in keyed))
        self._graph(key, fn, parked)

    def capture_cost(self) -> float:
        """Total warm-up plus capture seconds."""
        return sum(self.compile_times.values())

    @property
    def replays(self) -> int:
        """Graph replays so far (every dispatch is one)."""
        return sum(g.replays for g in self.graphs.values())

    def warmup_launches(self) -> Dict[str, int]:
        """{kernel: launches} of the graphs' warm-up runs, which ran on
        parked inputs beside the dispatches."""
        out: Dict[str, int] = {}
        for g in self.graphs.values():
            for name, n in g.warmup.items():
                out[name] = out.get(name, 0) + n
        return out

    # ------------------------------------------------------------- stats
    def note_padding(self, useful: int, total: int) -> None:
        self.useful_tokens += int(useful)
        self.total_tokens += int(total)

    @property
    def padded_tokens(self) -> int:
        return self.total_tokens - self.useful_tokens

    @property
    def padding_efficiency(self) -> float:
        """useful / total executed tokens (1.0 = zero padding waste)."""
        return (self.useful_tokens / self.total_tokens
                if self.total_tokens else 1.0)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def hit_rate_by_kind(self) -> Dict[str, float]:
        """Per-dispatch-kind hit rates."""
        out: Dict[str, float] = {}
        for kind in set(self.kind_hits) | set(self.kind_misses):
            h = self.kind_hits.get(kind, 0)
            m = self.kind_misses.get(kind, 0)
            out[kind] = h / (h + m) if (h + m) else 0.0
        return out

    def shapes_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for key in self.compile_times:
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    @property
    def dispatches(self) -> int:
        """Total step dispatches."""
        return self.hits + self.misses


def _zeros(*shape: int) -> np.ndarray:
    return np.zeros(shape, np.int32)


def _park_slot(arena: List[Dict[str, torch.Tensor]]) -> int:
    """The slot or page a capture at a live miss parks on: the arena's
    last, which is the scratch slot or page where the arena has one, and
    otherwise a slot whose park row no session reaches."""
    return next(iter(arena[0].values())).shape[1] - 1


def _park(arena: List[Dict[str, torch.Tensor]]) -> int:
    """The park row S_max − 1 of a slot arena's or gathered caches' KV
    leaves, the park offset page_size − 1 of a page pool's (0 for a pure
    SSM arena, whose layers read no positions)."""
    return next((leaves["k"].shape[2] - 1 for leaves in arena
                 if "k" in leaves), 0)


def _arena_park(arena) -> Dict[int, int]:
    """A packed arena-form step's parked inputs: every token on the park
    row (positions 2) of the park slot, every segment there (seg_slots
    3, slot_map 4)."""
    slot = _park_slot(arena)
    return {2: _park(arena), 3: slot, 4: slot}


def _paged_park(arena) -> Dict[int, int]:
    """A packed paged-form step's parked inputs: every token at the
    scratch page's last offset (token_pages 3, token_offs 4), every
    page-table entry the scratch page (5)."""
    page = _park_slot(arena)
    return {3: page, 4: _park(arena), 5: page}


class BucketExecutor(_ExecutorBase):
    """The dense (L, B) bucket-grid executor: every batch is padded to a
    grid (length, depth) shape, so the shape space is |L| × |B|.  Its
    steps read and write gathered caches: the leading rows of the slot
    arena's one static batch buffer, which ``fill`` gathers the step's
    slots into before each replay."""

    def __init__(self, cfg: ModelConfig, graph_pool: Optional[tuple] = None):
        super().__init__(graph_pool)
        self.cfg = cfg
        self._prefill = make_prefill_fn(cfg)
        self._decode = make_decode_fn(cfg)

    def prefill(self, params, tokens, positions, caches, sample_idx,
                fill: Optional[Callable[[], Any]] = None):
        return self._step("prefill", (1,), self._prefill,
                          (params, tokens, positions, caches, sample_idx),
                          {2: _park(caches)}, fill)

    def decode(self, params, tokens, positions, caches,
               fill: Optional[Callable[[], Any]] = None):
        return self._step("decode", (1,), self._decode,
                          (params, tokens, positions, caches),
                          {2: _park(caches)}, fill)

    def precapture(self, params, arena_gather: Callable, lengths, depths
                   ) -> float:
        """Capture the (L, B) grid at init (paper: graphs captured at
        system initialization) over the gathered first slots, every
        write on the park row.  Returns total seconds."""
        t0 = time.perf_counter()
        for b in depths:
            caches = arena_gather(list(range(b)))
            park = _park(caches)
            for l in lengths:
                self._precapture(
                    "prefill", (1,), self._prefill,
                    (params, _zeros(b, l), _zeros(b, l) + park, caches,
                     _zeros(b)))
            self._precapture("decode", (1,), self._decode,
                             (params, _zeros(b, 1), _zeros(b, 1) + park,
                              caches))
        return time.perf_counter() - t0


class PackedBucketExecutor(_ExecutorBase):
    """Padding-free packed step keyed on a 1-D total-token bucket: one
    flat (T,) stream with ``max_seqs`` segment rows, so the shape space
    grows with |token_buckets| only.  Three forms: over gathered caches
    (``mixed_step``, the measurement baseline, attention stacks only),
    over the slot arena (``mixed_step_arena``) and over the page pool
    (``mixed_step_paged``); the last two also verify speculative drafts
    (``verify_step_arena`` / ``verify_step_paged``).

    Scratch-slot arenas (SSM state) permanently reserve ONE stream row:
    bucket-tail tokens park in a dummy segment whose slot is the scratch
    slot.  The reservation is folded into the ladder (``max_seqs`` one
    less), so the engine, the serve loop and AWD agree on the
    schedulable room."""

    def __init__(self, cfg: ModelConfig,
                 token_buckets: Tuple[int, ...] = DEFAULT_TOKEN_BUCKETS,
                 max_seqs: int = 16, graph_pool: Optional[tuple] = None):
        super().__init__(graph_pool)
        if not tr.arena_capability(cfg).packed_ok:
            raise ValueError(
                f"{cfg.name}: packed serving needs a causal decoder "
                "(encoder-only models have no serving decode loop)")
        self.cfg = cfg
        self.reserve_pad_row = tr.arena_capability(cfg).needs_scratch_slot
        if self.reserve_pad_row:
            max_seqs = max_seqs - 1
            assert max_seqs >= 1, \
                "scratch-slot arenas need packed max_seqs >= 2"
        self.ladder = TokenBucketLadder(token_buckets, max_seqs)
        self._packed = make_packed_prefill_fn(cfg)
        self._packed_arena = make_packed_arena_fn(cfg)
        self._packed_paged = make_packed_paged_fn(cfg)
        # speculative verification forms: the same packed dispatch with
        # an L-per-segment logits gather
        self._verify_arena = make_packed_verify_arena_fn(cfg)
        self._verify_paged = make_packed_verify_paged_fn(cfg)
        # continuous-batching counters: a mixed step fuses decode rows
        # into the same packed stream
        self.mixed_steps = 0
        self.decode_tokens_fused = 0
        # speculative counters: verify dispatches and rows verified
        self.verify_steps = 0
        self.verify_rows = 0

    @property
    def token_buckets(self) -> Tuple[int, ...]:
        return self.ladder.buckets

    @property
    def max_seqs(self) -> int:
        return self.ladder.max_seqs

    @property
    def stream_rows(self) -> int:
        """Segment rows of the stream shape: the schedulable segments
        plus the reserved scratch pad row, if any."""
        return self.ladder.max_seqs + int(self.reserve_pad_row)

    def bucket_for(self, total_tokens: int) -> Optional[int]:
        """Smallest token bucket ≥ total_tokens (None if off-scale)."""
        return self.ladder.bucket_for(total_tokens)

    def _note_mixed(self, n_decode: int) -> None:
        if n_decode:
            self.mixed_steps += 1
            self.decode_tokens_fused += int(n_decode)

    def prefill_packed(self, params, tokens, positions, seg_ids, cu_seqlens,
                       q_offsets, kv_lengths, caches, last_idx,
                       fill: Optional[Callable[[], Any]] = None):
        return self._step("packed_prefill", (1,), self._packed,
                          (params, tokens, positions, seg_ids, cu_seqlens,
                           q_offsets, kv_lengths, caches, last_idx),
                          {2: _park(caches)}, fill)

    def mixed_step(self, params, tokens, positions, seg_ids, cu_seqlens,
                   q_offsets, kv_lengths, caches, last_idx, *,
                   n_decode: int = 0,
                   fill: Optional[Callable[[], Any]] = None):
        """One continuous-batching step over GATHERED caches: prefill,
        chunk and decode segments in one flat stream; the caches are
        written in place.  Returns last_logits (B, V)."""
        self._note_mixed(n_decode)
        return self.prefill_packed(params, tokens, positions, seg_ids,
                                   cu_seqlens, q_offsets, kv_lengths,
                                   caches, last_idx, fill)

    def prefill_packed_arena(self, params, tokens, positions, seg_slots,
                             slot_map, cu_seqlens, q_offsets, kv_lengths,
                             arena, last_idx):
        return self._step("packed_arena", (1,), self._packed_arena,
                          (params, tokens, positions, seg_slots, slot_map,
                           cu_seqlens, q_offsets, kv_lengths, arena,
                           last_idx), _arena_park(arena))

    def mixed_step_arena(self, params, tokens, positions, seg_slots,
                         slot_map, cu_seqlens, q_offsets, kv_lengths,
                         arena, last_idx, *, n_decode: int = 0):
        """One ARENA-RESIDENT continuous-batching step: each segment's
        KV is routed through ``slot_map`` and only the new rows are
        written, in place.  Returns (last_logits (B, V), greedy_ids
        (B,))."""
        self._note_mixed(n_decode)
        return self.prefill_packed_arena(params, tokens, positions,
                                         seg_slots, slot_map, cu_seqlens,
                                         q_offsets, kv_lengths, arena,
                                         last_idx)

    def mixed_step_paged(self, params, tokens, positions, token_pages,
                         token_offs, page_table, cu_seqlens, q_offsets,
                         kv_lengths, arena, last_idx, state_map, *,
                         n_decode: int = 0):
        """One PAGED continuous-batching step: prefill, chunk and decode
        segments in one flat stream; each segment's KV is routed through
        its row of ``page_table``, its SSM state through ``state_map``
        (B,) (the scratch page for pads), and the pool is written in
        place.  Returns (last_logits (B, V), greedy_ids (B,))."""
        self._note_mixed(n_decode)
        park = {**_paged_park(arena), 11: _park_slot(arena)}
        return self._step("packed_paged", (1, 5), self._packed_paged,
                          (params, tokens, positions, token_pages,
                           token_offs, page_table, cu_seqlens, q_offsets,
                           kv_lengths, arena, last_idx, state_map), park)

    def verify_step_arena(self, params, tokens, positions, seg_slots,
                          slot_map, cu_seqlens, q_offsets, kv_lengths,
                          arena, gather_idx):
        """One speculative verification dispatch over the slot arena:
        the arena-resident packed step scoring every session's draft
        segment at once.  Returns (logits (B, L, V), greedy_ids (B, L));
        the arena is written in place."""
        self.verify_steps += 1
        self.verify_rows += int(gather_idx.shape[0] * gather_idx.shape[1])
        return self._step("verify_arena", (1, 9), self._verify_arena,
                          (params, tokens, positions, seg_slots, slot_map,
                           cu_seqlens, q_offsets, kv_lengths, arena,
                           gather_idx), _arena_park(arena))

    def verify_step_paged(self, params, tokens, positions, token_pages,
                          token_offs, page_table, cu_seqlens, q_offsets,
                          kv_lengths, arena, gather_idx):
        """Paged speculative verification dispatch —
        :meth:`verify_step_arena` over the shared page pool."""
        self.verify_steps += 1
        self.verify_rows += int(gather_idx.shape[0] * gather_idx.shape[1])
        return self._step("verify_paged", (1, 5, 10), self._verify_paged,
                          (params, tokens, positions, token_pages,
                           token_offs, page_table, cu_seqlens, q_offsets,
                           kv_lengths, arena, gather_idx),
                          _paged_park(arena))

    def precapture(self, params, arena_gather: Callable) -> float:
        """Capture every token bucket's gathered step at init over the
        gathered first ``max_seqs`` slots, every write on the park row.
        Returns total seconds."""
        t0 = time.perf_counter()
        b = self.max_seqs
        caches = arena_gather(list(range(b)))
        park = _park(caches)
        for t in self.token_buckets:
            self._precapture("packed_prefill", (1,), self._packed,
                             (params, _zeros(t), _zeros(t) + park,
                              _zeros(t), _zeros(b + 1), _zeros(b),
                              _zeros(b), caches, _zeros(b)))
        return time.perf_counter() - t0

    def precapture_arena(self, params, arena: List[Dict[str, torch.Tensor]],
                         slot: int = 0) -> float:
        """Capture every token bucket's arena-resident step at init.
        Its stream has no segment (every kv length 0, so an SSM update
        is an identity) and parks every write on ``slot``'s park row —
        the scratch slot where the arena has one — so no cached row
        changes.  Returns total seconds."""
        t0 = time.perf_counter()
        b = self.stream_rows
        park = _park(arena)
        for t in self.token_buckets:
            self._precapture("packed_arena", (1,), self._packed_arena,
                             (params, _zeros(t), _zeros(t) + park,
                              _zeros(t) + slot, _zeros(b) + slot,
                              _zeros(b + 1), _zeros(b), _zeros(b), arena,
                              _zeros(b)))
        return time.perf_counter() - t0


class DecodeBucketExecutor(_ExecutorBase):
    """Bucketed decode over the slot arena (``decode``) or the page pool
    (``decode_paged``): the batch axis is padded to a decode-ladder
    rung, so the shape space is keyed on the BUCKET, not the live
    session count."""

    def __init__(self, cfg: ModelConfig,
                 decode_buckets: Tuple[int, ...] = DEFAULT_DECODE_BUCKETS,
                 max_seqs: Optional[int] = None,
                 graph_pool: Optional[tuple] = None):
        super().__init__(graph_pool)
        if not tr.arena_capability(cfg).packed_ok:
            raise ValueError(
                f"{cfg.name}: arena-resident decode needs a causal "
                "decoder (encoder-only models have no decode loop)")
        self.cfg = cfg
        self.ladder = DecodeBucketLadder(decode_buckets, max_seqs)
        self._decode = make_arena_decode_fn(cfg)
        self._decode_paged = make_paged_decode_fn(cfg)

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        return self.ladder.buckets

    def bucket_for(self, n_seqs: int) -> Optional[int]:
        """Smallest ladder rung ≥ n_seqs (None → split)."""
        return self.ladder.bucket_for(n_seqs)

    def decode(self, params, tokens, slot_map, write_pos, kv_lengths,
               arena):
        """One ARENA-RESIDENT decode tick: each row's new KV row is
        written in place at (slot, write_pos) and the arena read through
        the slot map.  Returns (logits (B, V), greedy_ids (B,)).  Parked,
        every row writes the park slot's park row and reads its row 0,
        as a ladder pad row does."""
        return self._step("arena_decode", (1,), self._decode,
                          (params, tokens, slot_map, write_pos, kv_lengths,
                           arena),
                          {2: _park_slot(arena), 3: _park(arena), 4: 1})

    def precapture(self, params, arena: List[Dict[str, torch.Tensor]],
                   slot: int = 0) -> float:
        """Capture every decode rung's arena-resident step at init.
        Every row writes ``slot``'s park row and reads its row 0, as a
        ladder pad row does, so no cached KV row changes.  A decode step
        does change the recurrent state of the slot it reads, so an SSM
        arena passes its scratch slot.  Returns total seconds."""
        t0 = time.perf_counter()
        park = _park(arena)
        for b in self.decode_buckets:
            self._precapture("arena_decode", (1,), self._decode,
                             (params, _zeros(b), _zeros(b) + slot,
                              _zeros(b) + park, _zeros(b) + 1, arena))
        return time.perf_counter() - t0

    def decode_paged(self, params, tokens, positions, write_pages,
                     write_offs, page_table, kv_lengths, arena, state_map):
        """One PAGED decode tick: each row's KV is routed through its
        page-table row and its SSM state through ``state_map`` (B,), the
        pool written in place.  Returns (logits (B, V), greedy_ids
        (B,)).  Parked, every row writes the scratch page and steps its
        state, as a ladder pad row does."""
        page = _park_slot(arena)
        return self._step("paged_decode", (1, 5), self._decode_paged,
                          (params, tokens, positions, write_pages,
                           write_offs, page_table, kv_lengths, arena,
                           state_map),
                          {3: page, 4: _park(arena), 5: page, 6: 1,
                           8: page})
