"""Per-session token sampling (ROADMAP PR-2 follow-up).

Every serving path ends in one `(B, V)` logits gather — prefill TTFT
tokens, fused mixed-step rows, and arena-decode rows alike.  This module
turns those rows into tokens under per-session options: greedy argmax
(the default, temperature 0), temperature scaling, top-k truncation,
top-p (nucleus) truncation, and additive logit bias.  Logit bias applies
BEFORE everything else — including greedy argmax, so a biased session
can force/ban tokens even at temperature 0.

Pure numpy on host-side logits: the sampled token feeds the NEXT step's
token stream, which is assembled on host anyway, so sampling adds no
device dispatch.  Determinism: each session owns a Generator seeded from
``SamplingParams.seed`` (or the session id), so a replayed request
stream reproduces its tokens exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

BiasSpec = Union[Dict[int, float], Tuple[Tuple[int, float], ...]]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-session decode options.  temperature <= 0 means greedy
    (logit_bias still applies — biased argmax)."""
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    logit_bias: Optional[BiasSpec] = None   # {token_id: additive bias}

    def __post_init__(self):
        # normalize dict → sorted tuple so params stay hashable/frozen
        if isinstance(self.logit_bias, dict):
            object.__setattr__(self, "logit_bias",
                               tuple(sorted(self.logit_bias.items())))

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def is_default(self) -> bool:
        """True when plain vectorized argmax already does the job."""
        return self.is_greedy and not self.logit_bias


GREEDY = SamplingParams()


def make_rng(session: int, params: SamplingParams) -> np.random.Generator:
    seed = params.seed if params.seed is not None else session
    return np.random.default_rng(seed)


def _apply_bias(logits: np.ndarray, params: SamplingParams) -> np.ndarray:
    """Additive per-token bias, IN PLACE (out-of-range ids are ignored).
    Callers pass a private float32 copy — no second allocation here."""
    if not params.logit_bias:
        return logits
    for tok, bias in params.logit_bias:
        if 0 <= int(tok) < logits.size:
            logits[int(tok)] += np.float32(bias)
    return logits


def filtered_probs(logits: np.ndarray, params: SamplingParams) -> np.ndarray:
    """The (V,) distribution a non-greedy session actually samples from:
    bias → temperature → exact top-k (kth-value threshold, ties kept) →
    tie-inclusive top-p (a token survives iff the mass of STRICTLY
    GREATER probs is < top_p) → renormalized softmax.

    float32 throughout, matching the fused on-device sampling kernel
    bit-for-bit up to summation order.  Speculative rejection sampling
    reads draft probabilities straight off this distribution.
    """
    scaled = _apply_bias(np.asarray(logits, np.float32).copy(), params)
    scaled = scaled / np.float32(max(params.temperature, 1e-6))
    if params.top_k is not None and 0 < params.top_k < scaled.size:
        kth = np.partition(scaled, -params.top_k)[-params.top_k]
        scaled = np.where(scaled < kth, -np.inf, scaled)
    if params.top_p is not None and 0.0 < params.top_p < 1.0:
        shifted = scaled - scaled.max()
        probs = np.exp(shifted)
        probs /= probs.sum()
        # strict-greater mass G(v) = Σ p_j for p_j > v, via the sorted
        # prefix: ties share one G, so equal-prob tokens live or die
        # together (the value-threshold rule the device kernel uses)
        sp = np.sort(probs)[::-1]
        cs = np.concatenate(([np.float32(0.0)], np.cumsum(sp)))
        first_le = np.searchsorted(-sp, -probs, side="left")
        scaled = np.where(cs[first_le] < params.top_p, scaled, -np.inf)
    scaled = scaled - scaled.max()
    probs = np.exp(scaled)
    probs /= probs.sum()
    return probs.astype(np.float32)


def sample_from_probs(probs: np.ndarray, u: float) -> int:
    """Inverse-CDF draw: the smallest index whose cumulative mass
    exceeds ``u``.  One uniform per draw — the same protocol the fused
    sampling kernel consumes, so host and device paths share one rng
    stream layout."""
    cdf = np.cumsum(probs)
    return int(min(np.searchsorted(cdf, u, side="right"), probs.size - 1))


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: Optional[np.random.Generator] = None) -> int:
    """Sample one token from a (V,) logits row."""
    if params.is_greedy or rng is None:
        scaled = _apply_bias(np.asarray(logits, np.float32).copy(), params)
        return int(np.argmax(scaled))
    return sample_from_probs(filtered_probs(logits, params), rng.random())


def sample_batch(logits: np.ndarray, sessions: Sequence[int],
                 params: Dict[int, SamplingParams],
                 rngs: Dict[int, np.random.Generator]) -> np.ndarray:
    """Sample one token per row of a (n, V) logits block.

    Default rows (no per-session params) share one vectorized argmax;
    rows with options go through :func:`sample_token` — bias, then
    greedy argmax or the temperature / top-k / top-p draw from their
    session's Generator.  Row order is the caller's ``sessions`` order —
    the segment/batch layout is never reordered by sampling.
    """
    n = len(sessions)
    assert logits.shape[0] >= n, (logits.shape, n)
    out = np.argmax(logits[:n], axis=-1).astype(np.int64)
    for i, s in enumerate(sessions):
        sp = params.get(s)
        if sp is not None and not sp.is_default:
            out[i] = sample_token(logits[i], sp, rngs.get(s))
    return out


__all__ = ["SamplingParams", "GREEDY", "make_rng", "sample_token",
           "sample_batch", "filtered_probs", "sample_from_probs"]
