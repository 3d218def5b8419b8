"""§2.2 — M/G/1 Pollaczek–Khinchine analysis of intra-prefill interference.

Used (a) to *predict* head-of-line blocking penalties for mixed long/short
prefill batching and (b) as an analytic oracle the discrete-event
simulator is validated against in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ServiceClass:
    rate: float        # arrival rate λ_i (req/s)
    mean: float        # E[S_i] (s)
    second_moment: float  # E[S_i²] (s²)


def mixture(classes: Sequence[ServiceClass]) -> Tuple[float, float, float]:
    """Aggregate (λ, E[S], E[S²]) of a Poisson mixture."""
    lam = sum(c.rate for c in classes)
    if lam <= 0:
        return 0.0, 0.0, 0.0
    es = sum(c.rate * c.mean for c in classes) / lam
    es2 = sum(c.rate * c.second_moment for c in classes) / lam
    return lam, es, es2


def pk_wait(lam: float, es: float, es2: float) -> float:
    """P-K mean waiting time W = λE[S²] / (2(1−ρ)); inf when ρ ≥ 1."""
    rho = lam * es
    if rho >= 1.0:
        return float("inf")
    return lam * es2 / (2.0 * (1.0 - rho))


def mixed_wait(classes: Sequence[ServiceClass]) -> float:
    lam, es, es2 = mixture(classes)
    return pk_wait(lam, es, es2)


def hol_penalty(lam: float, p_short: float, s_long: float, s_short: float,
                rho: float) -> float:
    """ΔW_HoL = λ p(1−p) (S_ℓ − S_s)² / (2(1−ρ))  (§2.2).

    The extra waiting inflicted on *every* request by mixing two
    deterministic service classes instead of serving a homogeneous stream
    with the same mean.
    """
    if rho >= 1.0:
        return float("inf")
    return lam * p_short * (1.0 - p_short) * (s_long - s_short) ** 2 \
        / (2.0 * (1.0 - rho))


def normalized_latency(service: float, wait: float) -> float:
    """R/S = 1 + W/S — the convoy-effect metric (§2.2): identical W hurts
    short jobs more."""
    return 1.0 + wait / service


def utilization(classes: Sequence[ServiceClass]) -> float:
    return sum(c.rate * c.mean for c in classes)
