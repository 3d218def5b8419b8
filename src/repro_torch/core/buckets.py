"""§3.1 — the power-of-two (L, B) bucket grid for graph capture.

On GPU each bucket is a captured CUDA Graph; on TPU each bucket is an
AOT-compiled fixed-shape XLA executable (serving/executor.py).  The grid
and the NEARESTGRAPH matching logic are identical.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple


DEFAULT_LENGTHS = (8, 16, 32, 64, 128, 256)
DEFAULT_DEPTHS = (1, 2, 4, 8, 16, 32, 64)
DEFAULT_TOKEN_BUCKETS = (64, 128, 256, 512)
DEFAULT_DECODE_BUCKETS = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class Bucket:
    length: int   # padded per-request token length
    depth: int    # padded batch size

    @property
    def tokens(self) -> int:
        return self.length * self.depth

    @property
    def key(self) -> Tuple[int, int]:
        return (self.length, self.depth)


class BucketGrid:
    """The captured-shape grid H of Algorithm 1."""

    def __init__(self, lengths: Sequence[int] = DEFAULT_LENGTHS,
                 depths: Sequence[int] = DEFAULT_DEPTHS,
                 mem_budget_tokens: int = 16_384):
        self.lengths = tuple(sorted(lengths))
        self.depths = tuple(sorted(depths))
        self.mem_budget = mem_budget_tokens
        self.buckets = [Bucket(l, d) for l in self.lengths for d in self.depths
                        if l * d <= mem_budget_tokens]

    # ------------------------------------------------------------- lookup
    def nearest_length(self, l: int) -> Optional[int]:
        """Smallest captured length ≥ l (None if l exceeds the grid)."""
        i = bisect.bisect_left(self.lengths, l)
        return self.lengths[i] if i < len(self.lengths) else None

    def covers(self, l: int) -> bool:
        return l <= self.lengths[-1]

    def max_depth(self, length: int, mem_budget: Optional[int] = None) -> int:
        """Largest captured depth whose (length, depth) fits the budget —
        the target depth D of Algorithm 1."""
        budget = mem_budget if mem_budget is not None else self.mem_budget
        best = 0
        for d in self.depths:
            if length * d <= budget:
                best = d
        return best

    def nearest_graph(self, lengths: Sequence[int],
                      mem_budget: Optional[int] = None) -> Optional[Bucket]:
        """NEARESTGRAPH(B, H, M): smallest captured (L, B) covering every
        request with minimal padding; None if any request is off-grid or
        the padded batch busts the memory budget."""
        if not lengths:
            return None
        budget = mem_budget if mem_budget is not None else self.mem_budget
        lmax = max(lengths)
        bl = self.nearest_length(lmax)
        if bl is None:
            return None
        i = bisect.bisect_left(self.depths, len(lengths))
        if i >= len(self.depths):
            return None
        bd = self.depths[i]
        if bl * bd > budget:
            return None
        return Bucket(bl, bd)

    def padding_waste(self, lengths: Sequence[int]) -> float:
        """Fraction of padded tokens wasted for this batch under the grid."""
        b = self.nearest_graph(lengths)
        if b is None:
            return 0.0
        real = sum(lengths)
        return 1.0 - real / b.tokens

    def __len__(self) -> int:
        return len(self.buckets)


class TokenBucketLadder:
    """Padding-free alternative to the (L, B) grid: captured shapes are
    1-D TOTAL-token buckets over a packed flat stream.

    A batch of heterogeneous lengths [7, 61, 12] packs into one stream
    of 80 tokens and runs in the 128-bucket shape — the only padding is
    the bucket tail (48 tokens here), vs. padding every request to the
    max bucketed length under the dense grid.  The captured-shape space
    is |buckets|, not |lengths| × |depths|.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_TOKEN_BUCKETS,
                 max_seqs: int = 16):
        assert buckets, "token ladder needs at least one bucket"
        self.buckets = tuple(sorted(buckets))
        self.max_seqs = max_seqs

    # ------------------------------------------------------------- lookup
    @property
    def max_tokens(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, total_tokens: int) -> Optional[int]:
        """Smallest bucket ≥ total_tokens (None when off-scale)."""
        i = bisect.bisect_left(self.buckets, total_tokens)
        return self.buckets[i] if i < len(self.buckets) else None

    def covers(self, total_tokens: int) -> bool:
        return total_tokens <= self.buckets[-1]

    def padding_waste(self, lengths: Sequence[int]) -> float:
        """Fraction of executed tokens wasted on the bucket tail."""
        total = sum(lengths)
        b = self.bucket_for(total)
        if b is None or b == 0:
            return 0.0
        return 1.0 - total / b

    def __len__(self) -> int:
        return len(self.buckets)


class DecodeBucketLadder:
    """The decode-seqs ladder: a decode-only tick pads its BATCH axis to
    a small power-of-two rung, so the compiled-shape space for decode is
    O(log max_seqs) — not one executable per live session count (the
    §3.1 shape-cache blowup, in its decode form).

    Rungs above ``max_seqs`` (the arena depth) are dropped and the arena
    depth itself becomes the top rung — whether the configured ladder
    overshoots the arena OR stops short of it — so a full-arena decode
    tick always lands on the ladder and never falls back to the dense
    per-count path.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_DECODE_BUCKETS,
                 max_seqs: Optional[int] = None):
        assert buckets, "decode ladder needs at least one rung"
        rungs = sorted(set(buckets))
        if max_seqs is not None:
            rungs = [r for r in rungs if r < max_seqs] + [max_seqs]
        self.buckets = tuple(rungs)

    @property
    def max_seqs(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n_seqs: int) -> Optional[int]:
        """Smallest rung ≥ n_seqs (None when the tick overflows)."""
        if n_seqs <= 0:
            return None
        i = bisect.bisect_left(self.buckets, n_seqs)
        return self.buckets[i] if i < len(self.buckets) else None

    def covers(self, n_seqs: int) -> bool:
        return 0 < n_seqs <= self.buckets[-1]

    def pad_rows(self, n_seqs: int) -> int:
        b = self.bucket_for(n_seqs)
        return b - n_seqs if b is not None else 0

    def __len__(self) -> int:
        return len(self.buckets)


def fit_decodes(prefill_tokens: int, n_prefill: int, n_decodes: int,
                ladder: TokenBucketLadder,
                token_bucket: Optional[int] = None,
                tokens_per_decode: int = 1
                ) -> Tuple[int, Optional[int]]:
    """How many decode sessions can fuse into a packed step already
    carrying ``prefill_tokens`` over ``n_prefill`` segments
    (continuous batching, DESIGN.md §4).

    Each fused session costs ``tokens_per_decode`` stream tokens — 1
    for a plain decode row, 1 + k when a speculative verify segment
    carries k draft tokens (DESIGN.md §10) — but always ONE sequence
    row, so the fit is min over the token room and the row room.
    Returns (n_fit, bucket) — bucket is the smallest ladder rung
    covering the fused total (or ``token_bucket`` when the caller
    pinned one); (0, None) when even the prefill part is off-ladder.

    Pure ladder arithmetic (no serving deps): the real engine's mixed
    step and the discrete-event simulator's pricing share this exact
    function, which is what keeps them in agreement.
    """
    row_room = max(0, ladder.max_seqs - n_prefill)
    want = min(n_decodes, row_room)
    while want >= 0:
        total = prefill_tokens + want * tokens_per_decode
        if total == 0:
            return 0, None
        bucket = token_bucket if token_bucket is not None \
            else ladder.bucket_for(total)
        if bucket is not None and total <= bucket:
            return want, bucket
        want -= 1
    return 0, None


def greedy_length_groups(lengths: Sequence[int],
                         grid: BucketGrid) -> List[List[int]]:
    """Greedy bucket-first grouping (Algorithm 1 line 6): indices grouped
    by their nearest captured length, minimizing intra-batch padding."""
    groups: dict = {}
    for idx, l in enumerate(lengths):
        key = grid.nearest_length(l) or -1
        groups.setdefault(key, []).append(idx)
    return [groups[k] for k in sorted(groups)]
