"""Request model: the unit the LAPS scheduler reasons about.

A request is one *prefill job*: either a first-turn prefill (H == 0) or a
multi-turn re-prefill (H > 0 cached history tokens, L new tokens).
Decode work is modelled separately (PD disaggregation) except in MIX
mode.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    new_tokens: int                      # L — new prompt tokens this turn
    history_tokens: int = 0              # H — cached KV history
    arrival: float = 0.0
    deadline: Optional[float] = None     # absolute TTFT deadline (None = offline)
    session: int = -1
    decode_tokens: int = 0               # expected output length (PD sims)
    # tokens of the prompt a paged KV arena can inherit from its radix
    # prefix index (shared system prompt / earlier turn) instead of
    # prefilling — the scheduler and sim bill only the suffix past it
    reusable_prefix: int = 0
    # §12 host spill tier: how many of those reusable tokens live in the
    # HOST page pool (demoted by eviction) rather than on device.  Sims
    # with host_pool_pages > 0 bill their promotion (swap_in_time);
    # without a host tier they were dropped at eviction and are not
    # adoptable at all
    host_prefix: int = 0
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))

    # fault tolerance (DESIGN.md §11): a recovery request is the synthetic
    # re-prefill that reconstructs a crashed engine's session on a
    # survivor — trackers count it as `recovered`, not as client traffic;
    # `rejected` marks a submit shed by the admission gate (never queued)
    recovery: bool = False
    rejected: bool = False

    # runtime bookkeeping (filled by scheduler/engine/sim)
    swap_time: float = 0.0               # host→device promotion delay billed
    dispatch_time: Optional[float] = None
    # seconds of its wait in the short queue that the policy held that
    # queue open for the AWD window, from its own enqueue on
    # (TemporalDisaggPolicy); None for a request never queued as short
    awd_hold_s: Optional[float] = None
    finish_time: Optional[float] = None
    instance: Optional[int] = None
    padded_to: Optional[int] = None      # bucket length it was padded to
    used_graph: bool = False

    @property
    def is_reprefill(self) -> bool:
        return self.history_tokens > 0

    @property
    def total_context(self) -> int:
        return self.new_tokens + self.history_tokens

    def ttft(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def violated(self) -> bool:
        if self.deadline is None:
            return False
        return self.finish_time is None or self.finish_time > self.deadline

    def slack(self, now: float, service_estimate: float) -> float:
        """Time to spare if dispatched now (∞ when deadline-free)."""
        if self.deadline is None:
            return float("inf")
        return self.deadline - now - service_estimate


@dataclasses.dataclass
class Batch:
    requests: list
    bucket_len: Optional[int] = None     # padded per-request length (graph L)
    bucket_depth: Optional[int] = None   # padded batch size (graph B)
    token_bucket: Optional[int] = None   # packed path: total-token bucket T
    uses_graph: bool = False
    kind: str = "short"                  # short | long | decode | mixed
    decode_tokens: int = 0               # decode rows fused into this step
    # (continuous batching: each rides the packed stream as a length-1
    # segment, sharing the dispatch + weight read with the prefills)

    @property
    def depth(self) -> int:
        return len(self.requests)

    @property
    def tokens(self) -> int:
        return sum(r.new_tokens for r in self.requests)

    @property
    def stream_tokens(self) -> int:
        """Real rows of the packed stream: prefill + fused decode."""
        return self.tokens + self.decode_tokens

    @property
    def is_packed(self) -> bool:
        return self.token_bucket is not None

    @property
    def padded_tokens(self) -> int:
        if self.token_bucket is not None:
            return self.token_bucket
        if self.bucket_len is None or self.bucket_depth is None:
            return self.tokens
        return self.bucket_len * self.bucket_depth

    @property
    def max_history(self) -> int:
        return max((r.history_tokens for r in self.requests), default=0)
