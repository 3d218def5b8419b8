"""§2.1 — the compute/memory boundary latency model.

    T_comp(L, H) ≈ α·L·(L + 2H) + β·L
    T_mem(L, H)  ≈ γ_w·L + γ_r·H

Boundaries:
    L_m^prefill    = max(0, (γ_w − β)/α)
    L_m^re-prefill = positive root of α·L² + (2αH + β − γ_w)·L − γ_r·H = 0,
                     saturating at γ_r/(2α) for H ≫ |β−γ_w|/(2α).

Constants are fitted at runtime from (T_comp, T_mem, L, H) samples
(:func:`fit`) or taken from :data:`H200_QWEN32B` — a calibration chosen
so the prefill boundary lands in the paper's empirical 150–512-token
range (§2.1) and absolute latencies match the paper's H200/Qwen2.5-32B
setup to first order.  The roofline cross-check (:func:`roofline_boundary`)
computes the arithmetic-intensity crossing AI(L) = P_peak/B_mem.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    alpha: float    # s/token² — attention quadratic compute
    beta: float     # s/token  — FFN/projection linear compute
    gamma_w: float  # s/token  — KV write + per-token weight-read share
    gamma_r: float  # s/token  — KV read per history token

    # ------------------------------------------------------------ latency
    def t_comp(self, l: float, h: float = 0.0) -> float:
        return self.alpha * l * (l + 2.0 * h) + self.beta * l

    def t_mem(self, l: float, h: float = 0.0) -> float:
        return self.gamma_w * l + self.gamma_r * h

    def total(self, l: float, h: float = 0.0) -> float:
        return self.t_comp(l, h) + self.t_mem(l, h)

    # ---------------------------------------------------------- boundaries
    def l_m_prefill(self) -> float:
        return max(0.0, (self.gamma_w - self.beta) / self.alpha)

    def l_m_reprefill(self, h: float) -> float:
        if h <= 0:
            return self.l_m_prefill()
        b = 2.0 * self.alpha * h + self.beta - self.gamma_w
        disc = b * b + 4.0 * self.alpha * self.gamma_r * h
        return max(0.0, (-b + math.sqrt(disc)) / (2.0 * self.alpha))

    def saturation(self) -> float:
        """lim_{H→∞} L_m^re-prefill = γ_r / (2α)."""
        return self.gamma_r / (2.0 * self.alpha)

    def boundary(self, h: float = 0.0,
                 clip: Tuple[float, float] = (16.0, 2048.0)) -> float:
        """Operational classification threshold (clipped fitted boundary)."""
        lm = self.l_m_reprefill(h) if h > 0 else self.l_m_prefill()
        return float(min(max(lm, clip[0]), clip[1]))

    def is_memory_bound(self, l: float, h: float = 0.0) -> bool:
        return self.t_mem(l, h) > self.t_comp(l, h)


def fit(samples: Sequence[Tuple[float, float, float, float]]) -> LatencyModel:
    """Least-squares fit of (T_comp, T_mem, L, H) runtime samples (§2.1).

    T_comp is quadratic in (L, H) with features [L(L+2H), L];
    T_mem is linear with features [L, H].  Coefficients are clamped ≥ 0.
    """
    arr = np.asarray(samples, dtype=np.float64)
    t_comp, t_mem, l, h = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    xc = np.stack([l * (l + 2.0 * h), l], axis=1)
    coef_c, *_ = np.linalg.lstsq(xc, t_comp, rcond=None)
    xm = np.stack([l, h], axis=1)
    coef_m, *_ = np.linalg.lstsq(xm, t_mem, rcond=None)
    alpha, beta = max(coef_c[0], 1e-12), max(coef_c[1], 0.0)
    gamma_w, gamma_r = max(coef_m[0], 0.0), max(coef_m[1], 0.0)
    return LatencyModel(alpha, beta, gamma_w, gamma_r)


@dataclasses.dataclass(frozen=True)
class TotalFit:
    """Fit of wall-clock totals T(L,H) ≈ F + b·L + a·L(L+2H) + c·H.

    When only end-to-end times are observable (no profiler separating
    compute from memory stations), the compute/memory boundary is the
    roofline crossing of the quadratic compute term against the fixed
    memory floor F (weight read + launch): a·L² + b_c·L = F.  We
    conservatively attribute the linear term to compute (b_c = b), which
    biases L_m slightly low — safe for classification (a borderline
    request lands in the long queue).
    """
    alpha: float
    beta_eff: float
    gamma_r: float
    fixed: float

    def l_m(self) -> float:
        a, b, f = self.alpha, self.beta_eff, self.fixed
        if a <= 0:
            return f / b if b > 0 else 0.0
        disc = b * b + 4.0 * a * f
        return (-b + math.sqrt(disc)) / (2.0 * a)

    def boundary(self, h: float = 0.0,
                 clip: Tuple[float, float] = (16.0, 2048.0)) -> float:
        return float(min(max(self.l_m(), clip[0]), clip[1]))

    def total(self, l: float, h: float = 0.0) -> float:
        return self.fixed + self.beta_eff * l + \
            self.alpha * l * (l + 2.0 * h) + self.gamma_r * h


def fit_total(samples: Sequence[Tuple[float, float, float]]) -> TotalFit:
    """Least-squares fit of (T_total, L, H) wall-clock engine samples."""
    arr = np.asarray(samples, dtype=np.float64)
    t, l, h = arr[:, 0], arr[:, 1], arr[:, 2]
    x = np.stack([np.ones_like(l), l, l * (l + 2.0 * h), h], axis=1)
    coef, *_ = np.linalg.lstsq(x, t, rcond=None)
    return TotalFit(alpha=max(coef[2], 1e-15), beta_eff=max(coef[1], 1e-12),
                    gamma_r=max(coef[3], 0.0), fixed=max(coef[0], 0.0))


def roofline_boundary(model_params: int, kv_bytes_per_token: float,
                      peak_flops: float, mem_bw: float,
                      weight_bytes: Optional[float] = None) -> float:
    """Roofline form of the boundary (§2.1): smallest L whose prefill
    arithmetic intensity reaches AI* = P_peak/B_mem.

    AI(L) ≈ 2·N·L / (W + L·kv_bytes): FLOPs grow linearly in L, bytes are
    dominated by the one-time weight read W plus per-token KV writes.
    """
    w = weight_bytes if weight_bytes is not None else 2.0 * model_params
    ai_star = peak_flops / mem_bw
    denom = 2.0 * model_params - ai_star * kv_bytes_per_token
    if denom <= 0:
        return float("inf")
    return ai_star * w / denom


# Calibration for the paper's setup (H200 SXM, Qwen2.5-32B, bf16).
# α and β are physical (4·d_attn·layers/peak ≈ 1.3e-9 s/pair; 2N/peak ≈
# 6.5e-5 s/token).  The paper's *linear* T_mem = γ_w·L form has no slot
# for the fixed per-step weight read, so a fitted γ_w lands a hair above
# β with the gap set by the weight-read amortization slope around short
# lengths; we pin γ_w = β + 300·α so the prefill boundary sits at 300
# tokens — inside the paper's empirically reported 150–512 range.
# γ_r is the physical KV re-read per history token
# (≈0.26 MB / 4.8 TB/s ≈ 5.4e-8 s): with physical constants the
# re-prefill saturation γ_r/(2α) ≈ 21 tokens sits BELOW L_m^prefill, so
# the history-dependent boundary *descends* toward saturation — the
# paper's rising-boundary narrative corresponds to fitted (coarse) γ_r
# values; both regimes are covered by the same formula and tests.
_A32, _B32 = 1.3e-9, 6.5e-5
H200_QWEN32B = LatencyModel(alpha=_A32, beta=_B32,
                            gamma_w=_B32 + 300.0 * _A32, gamma_r=5.4e-8)

_A14, _B14 = 5.7e-10, 2.8e-5
H200_QWEN14B = LatencyModel(alpha=_A14, beta=_B14,
                            gamma_w=_B14 + 280.0 * _A14, gamma_r=2.4e-8)
_A7, _B7 = 2.8e-10, 1.4e-5
H200_QWEN7B = LatencyModel(alpha=_A7, beta=_B7,
                           gamma_w=_B7 + 250.0 * _A7, gamma_r=1.2e-8)
