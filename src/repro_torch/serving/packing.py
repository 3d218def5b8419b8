"""Mixed-stream assembly for continuous batching (DESIGN.md §4).

One scheduler tick produces ONE flat (T,) token stream holding three
segment kinds side by side:

  * ``prefill`` — a short request's new tokens (history 0 or a
    re-prefill offset);
  * ``chunk``   — one C_l slice of a long prefill (history = tokens
    already prefilled), so a long chunk shares the step with shorts
    instead of running the dense path solo;
  * ``decode``  — ONE token of an in-flight session (history = its
    full cached context), attending over ``history + 1`` keys through
    the ragged kernel's offset prefetch;
  * ``verify``  — a speculative session's ``[pending, d_1..d_{L-1}]``
    draft segment (DESIGN.md §10): a length-L re-prefill whose logits
    are ALL gathered back so acceptance can walk the drafts.

Mechanically a decode segment is a length-1 re-prefill, so the packed
executor serves every mix with the SAME compiled shape — prefill and
decode share one dispatch, which is the continuous-batching point.

This module is pure numpy (no JAX) so the assembly invariants — bucket
never exceeded, segments never split, per-session token order kept,
``cu_seqlens`` consistent — are property-testable in microseconds.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.buckets import fit_decodes  # noqa: F401
# fit_decodes lives in core.buckets (pure ladder arithmetic shared with
# the JAX-free simulator) and is re-exported here for the serving side

SEGMENT_KINDS = ("prefill", "chunk", "decode", "verify")


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """One sequence's slice of the mixed stream."""
    session: int
    tokens: np.ndarray        # (len,) int32 new tokens (decode: length 1)
    history: int              # cached KV tokens before this step
    kind: str = "prefill"     # prefill | chunk | decode | verify

    def __post_init__(self):
        assert self.kind in SEGMENT_KINDS, self.kind
        assert len(self.tokens) >= 1, "empty segment"
        if self.kind == "decode":
            assert len(self.tokens) == 1, "decode segments carry ONE token"
        # a "verify" segment is [pending token, draft_1..draft_{L-1}] —
        # mechanically a length-L re-prefill whose logits are ALL read
        # back (speculative verification, DESIGN.md §10); any length ≥ 1

    @property
    def length(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class MixedStream:
    """The assembled flat stream — exactly the packed executor's inputs.

    Row layout per DESIGN.md §3: sequence i owns rows
    [cu_seqlens[i], cu_seqlens[i+1]); rows past cu_seqlens[n_seqs] are
    bucket tail (parked positions, duplicate cache row).  All arrays are
    statically shaped on (bucket, b_max) so every mix of segment kinds
    reuses one compiled executable.
    """
    tokens: np.ndarray        # (bucket,) int32
    positions: np.ndarray     # (bucket,) int32 absolute positions
    seg_ids: np.ndarray       # (bucket,) int32 local cache-row index
    cu_seqlens: np.ndarray    # (b_max + 1,) int32
    q_offsets: np.ndarray     # (b_max,) int32 history offsets
    kv_lengths: np.ndarray    # (b_max,) int32 valid cache entries
    last_idx: np.ndarray      # (b_max,) int32 flat index of final token
    segments: List[SegmentSpec]
    bucket: int

    @property
    def n_seqs(self) -> int:
        return len(self.segments)

    @property
    def total_tokens(self) -> int:
        return int(sum(s.length for s in self.segments))

    @property
    def decode_tokens(self) -> int:
        return sum(s.length for s in self.segments if s.kind == "decode")

    @property
    def prefill_tokens(self) -> int:
        return sum(s.length for s in self.segments
                   if s.kind not in ("decode", "verify"))

    @property
    def verify_tokens(self) -> int:
        return sum(s.length for s in self.segments if s.kind == "verify")

    @property
    def tail_tokens(self) -> int:
        return self.bucket - self.total_tokens


def assemble_mixed_stream(segments: Sequence[SegmentSpec], bucket: int,
                          b_max: int, park_position: int,
                          pad_token: int = 0) -> MixedStream:
    """Concatenate segments into one statically shaped packed stream.

    park_position: the arena's junk KV slot (max_len - 1) — tail rows
    and the dummy-sequence rows write there so padding never corrupts a
    live cache entry.
    """
    n = len(segments)
    assert 0 < n <= b_max, (n, b_max)
    total = sum(s.length for s in segments)
    assert total <= bucket, (total, bucket)

    tokens = np.full(bucket, pad_token, np.int32)
    positions = np.full(bucket, park_position, np.int32)
    # tail rows write their junk KV into a DUPLICATE cache row (index n
    # when a dummy row exists, else row 0) at the parked position
    seg_ids = np.full(bucket, n if n < b_max else 0, np.int32)
    cu = np.full(b_max + 1, total, np.int32)
    cu[0] = 0
    off = np.zeros(b_max, np.int32)
    kvl = np.zeros(b_max, np.int32)
    last_idx = np.zeros(b_max, np.int32)

    o = 0
    for i, seg in enumerate(segments):
        l = seg.length
        tokens[o:o + l] = seg.tokens
        positions[o:o + l] = seg.history + np.arange(l)
        seg_ids[o:o + l] = i
        cu[i + 1] = o + l
        off[i] = seg.history
        kvl[i] = seg.history + l
        last_idx[i] = o + l - 1
        o += l

    return MixedStream(tokens=tokens, positions=positions, seg_ids=seg_ids,
                       cu_seqlens=cu, q_offsets=off, kv_lengths=kvl,
                       last_idx=last_idx, segments=list(segments),
                       bucket=bucket)


@dataclasses.dataclass
class DecodeRows:
    """One arena-resident decode tick's padded row arrays — exactly the
    DecodeBucketExecutor's inputs.  Rows [0, n) are the live sessions in
    submission order; rows [n, bucket) are ladder padding that writes
    junk KV at the park position of row 0's slot and attends over one
    garbage key (output discarded)."""
    tokens: np.ndarray        # (bucket,) int32 last sampled token per row
    slot_map: np.ndarray      # (bucket,) int32 arena slot per row
    write_pos: np.ndarray     # (bucket,) int32 new-KV position (pad: park)
    kv_lengths: np.ndarray    # (bucket,) int32 valid entries (pad: 1)
    n: int                    # live rows
    bucket: int

    @property
    def pad_rows(self) -> int:
        return self.bucket - self.n


def pad_decode_rows(slots: Sequence[int], histories: Sequence[int],
                    tokens: Sequence[int], bucket: int,
                    park_position: int, pad_token: int = 0,
                    pad_slot: Optional[int] = None) -> DecodeRows:
    """Pad one decode tick's rows to the ladder ``bucket``.

    The live rows keep their submission order and exact values — the
    bucket choice never drops or reorders sessions (property-tested).
    Pad rows reuse slot 0's arena row but write at ``park_position``
    (the arena's designated junk slot), so padding never corrupts a
    live cache entry.  ``pad_slot`` overrides the slot pad rows target:
    rolling windowed arenas and SSM state arenas (DESIGN.md §7) pass
    their dedicated scratch slot — a rolling slot has no spare park row
    and recurrent state has no park position, so aliasing a live slot
    is not an option there.
    """
    n = len(slots)
    assert 0 < n <= bucket, (n, bucket)
    assert len(histories) == n and len(tokens) == n
    tok = np.full(bucket, pad_token, np.int32)
    tok[:n] = tokens
    sm = np.full(bucket, slots[0] if pad_slot is None else pad_slot,
                 np.int32)
    sm[:n] = slots
    wp = np.full(bucket, park_position, np.int32)
    wp[:n] = histories
    kl = np.ones(bucket, np.int32)
    kl[:n] = np.asarray(histories, np.int32) + 1
    return DecodeRows(tokens=tok, slot_map=sm, write_pos=wp, kv_lengths=kl,
                      n=n, bucket=bucket)


__all__ = ["SegmentSpec", "MixedStream", "assemble_mixed_stream",
           "DecodeRows", "pad_decode_rows", "fit_decodes", "SEGMENT_KINDS"]
