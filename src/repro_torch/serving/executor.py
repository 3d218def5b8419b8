"""Bucketed step executors of the port, from ``repro.serving.executor``:
the paged packed step and the paged decode step.

The JAX package lowers and compiles one executable per bucket shape.
Here execution is eager: every step runs the PyTorch stack directly
(CUDA-graph capture per bucket is a later slice).  The shape-keyed
bookkeeping stays — the first step of a shape counts as a miss, later
ones as hits — with the same counter names, because ``Engine.stats()``
and the benches read them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.buckets import (DEFAULT_DECODE_BUCKETS,
                                      DEFAULT_TOKEN_BUCKETS,
                                      DecodeBucketLadder, TokenBucketLadder)
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


def make_packed_paged_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(T,), positions(T,), token_pages(T,), token_offs(T,),
    page_table(B,P_max), cu_seqlens(B+1,), q_offsets(B,), kv_lengths(B,),
    arena, last_idx(B,)) → (last_logits(B,V), greedy_ids(B,)).  The page
    pool is read through the page table and written in place."""

    @torch.no_grad()
    def packed_step(params, tokens, positions, token_pages, token_offs,
                    page_table, cu_seqlens, q_offsets, kv_lengths, arena,
                    last_idx):
        last = tr.forward_packed_paged(
            params, cfg, tokens=tokens, positions=positions,
            token_pages=token_pages, token_offs=token_offs,
            page_table=page_table, cu_seqlens=cu_seqlens,
            q_offsets=q_offsets, kv_lengths=kv_lengths, arena=arena,
            last_idx=last_idx)
        return last, torch.argmax(last, dim=-1).to(torch.int32)

    return packed_step


def make_paged_decode_fn(cfg: ModelConfig) -> Callable:
    """(params, tokens(B,), positions(B,), write_pages(B,), write_offs(B,),
    page_table(B,P_max), kv_lengths(B,), arena) → (logits(B,V),
    greedy_ids(B,)).  Paged decode, pool written in place."""

    @torch.no_grad()
    def decode_step(params, tokens, positions, write_pages, write_offs,
                    page_table, kv_lengths, arena):
        logits = tr.forward_decode_paged(
            params, cfg, tokens=tokens, positions=positions,
            write_pages=write_pages, write_offs=write_offs,
            page_table=page_table, kv_lengths=kv_lengths, arena=arena)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32)

    return decode_step


class _ExecutorBase:
    """Shape-keyed dispatch accounting + padding-efficiency stats."""

    def __init__(self) -> None:
        # shape key → first-dispatch cost; eager execution compiles
        # nothing, so the value is 0.0 (CUDA-graph capture fills it later)
        self.compile_times: Dict[Tuple, float] = {}
        self.hits = 0
        self.misses = 0
        self.useful_tokens = 0     # real tokens executed
        self.total_tokens = 0      # tokens incl. bucket padding
        self.kind_hits: Dict[str, int] = {}
        self.kind_misses: Dict[str, int] = {}

    @staticmethod
    def _key(kind: str, *tensors: torch.Tensor) -> Tuple:
        return (kind,) + tuple((tuple(t.shape), str(t.dtype))
                               for t in tensors)

    def _note_dispatch(self, kind: str, *tensors: torch.Tensor) -> None:
        key = self._key(kind, *tensors)
        if key not in self.compile_times:
            self.misses += 1
            self.kind_misses[kind] = self.kind_misses.get(kind, 0) + 1
            self.compile_times[key] = 0.0
        else:
            self.hits += 1
            self.kind_hits[kind] = self.kind_hits.get(kind, 0) + 1

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

    def shapes_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for key in self.compile_times:
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    @property
    def dispatches(self) -> int:
        """Total step dispatches."""
        return self.hits + self.misses


class PackedBucketExecutor(_ExecutorBase):
    """Padding-free packed step keyed on a 1-D total-token bucket: one
    flat (T,) stream with ``max_seqs`` segment rows, so the shape space
    grows with |token_buckets| only."""

    def __init__(self, cfg: ModelConfig,
                 token_buckets: Tuple[int, ...] = DEFAULT_TOKEN_BUCKETS,
                 max_seqs: int = 16):
        super().__init__()
        self.cfg = cfg
        self.ladder = TokenBucketLadder(token_buckets, max_seqs)
        self._packed_paged = make_packed_paged_fn(cfg)
        # continuous-batching counters: a mixed step fuses decode rows
        # into the same packed stream
        self.mixed_steps = 0
        self.decode_tokens_fused = 0

    @property
    def token_buckets(self) -> Tuple[int, ...]:
        return self.ladder.buckets

    @property
    def max_seqs(self) -> int:
        return self.ladder.max_seqs

    @property
    def stream_rows(self) -> int:
        """Segment rows of the stream shape (no scratch pad row: full
        attention parks pads on the scratch page)."""
        return self.ladder.max_seqs

    def bucket_for(self, total_tokens: int) -> Optional[int]:
        """Smallest token bucket ≥ total_tokens (None if off-scale)."""
        return self.ladder.bucket_for(total_tokens)

    def mixed_step_paged(self, params, tokens, positions, token_pages,
                         token_offs, page_table, cu_seqlens, q_offsets,
                         kv_lengths, arena, last_idx, *,
                         n_decode: int = 0):
        """One PAGED continuous-batching step: prefill, chunk and decode
        segments in one flat stream; each segment's KV is routed through
        its row of ``page_table`` and the pool is written in place.
        Returns (last_logits (B, V), greedy_ids (B,))."""
        if n_decode:
            self.mixed_steps += 1
            self.decode_tokens_fused += int(n_decode)
        self._note_dispatch("packed_paged", tokens, page_table)
        return self._packed_paged(params, tokens, positions, token_pages,
                                  token_offs, page_table, cu_seqlens,
                                  q_offsets, kv_lengths, arena, last_idx)


class DecodeBucketExecutor(_ExecutorBase):
    """Bucketed paged decode: the batch axis is padded to a decode-ladder
    rung, so the shape space is keyed on the BUCKET, not the live
    session count."""

    def __init__(self, cfg: ModelConfig,
                 decode_buckets: Tuple[int, ...] = DEFAULT_DECODE_BUCKETS,
                 max_seqs: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.ladder = DecodeBucketLadder(decode_buckets, max_seqs)
        self._decode_paged = make_paged_decode_fn(cfg)

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        return self.ladder.buckets

    def bucket_for(self, n_seqs: int) -> Optional[int]:
        """Smallest ladder rung ≥ n_seqs (None → split)."""
        return self.ladder.bucket_for(n_seqs)

    def decode_paged(self, params, tokens, positions, write_pages,
                     write_offs, page_table, kv_lengths, arena):
        """One PAGED decode tick: each row's KV is routed through its
        page-table row, the pool written in place.  Returns (logits
        (B, V), greedy_ids (B,))."""
        self._note_dispatch("paged_decode", tokens, page_table)
        return self._decode_paged(params, tokens, positions, write_pages,
                                  write_offs, page_table, kv_lengths, arena)
