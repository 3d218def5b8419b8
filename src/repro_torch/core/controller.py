"""Algorithm 2 — Lightweight Instance-Pressure Controller (§3.2 spatial).

Per-instance pressure ψ_k = α·q_k + β·e_k − γ·u_k from queue backlog,
SLA deviation and utilization; robust (P90) pool aggregation; single-step
hill-climb with hysteresis τ, cool-down T_cool and a minimum allocation
n_min.  Also the elastic-scaling / failure-handling point: pools may
grow or shrink between control periods (instances joining, leaving, or
dying) — the controller simply re-balances whatever is alive.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class InstanceStats:
    instance: int
    queue_backlog: float      # q_k — queued tokens (normalized by capacity)
    sla_deviation: float      # e_k — mean positive (TTFT − SLO) of recent reqs
    utilization: float        # u_k — busy fraction over the control period


@dataclasses.dataclass
class Migration:
    instance: int
    src_pool: str             # "short" | "long"
    dst_pool: str


@dataclasses.dataclass
class ControllerConfig:
    alpha: float = 1.0        # weight on backlog
    beta: float = 4.0         # weight on SLA deviation
    gamma: float = 0.5        # credit for utilization headroom
    tau: float = 0.25         # hysteresis
    t_cool: float = 5.0       # cool-down (s)
    n_min: int = 1            # minimum instances per pool
    quantile: float = 0.90    # robust aggregator A(·)
    period: float = 1.0       # control period Δt (s)
    min_pressure: float = 0.05  # absolute gate: multiplicative hysteresis
    # is meaningless around ≤0 pressures (an idle pool must not strip a
    # busy-but-healthy one whose utilization credit turns ψ negative)


def _p_quantile(vals: Sequence[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(int(q * len(s)), len(s) - 1)
    return s[idx]


class PressureController:
    def __init__(self, cfg: Optional[ControllerConfig] = None):
        self.cfg = cfg or ControllerConfig()
        self.t_last = float("-inf")
        self.history: List[Dict] = []

    def pressure(self, st: InstanceStats) -> float:
        c = self.cfg
        return c.alpha * st.queue_backlog + c.beta * st.sla_deviation \
            - c.gamma * st.utilization

    def pool_pressure(self, stats: Sequence[InstanceStats]) -> float:
        return _p_quantile([self.pressure(s) for s in stats],
                           self.cfg.quantile)

    def step(self, short_pool: Sequence[InstanceStats],
             long_pool: Sequence[InstanceStats],
             now: float) -> Optional[Migration]:
        """One control period.  Returns at most one migration."""
        c = self.cfg
        p_s = self.pool_pressure(short_pool)
        p_l = self.pool_pressure(long_pool)
        self.history.append({"t": now, "p_short": p_s, "p_long": p_l,
                             "n_short": len(short_pool),
                             "n_long": len(long_pool)})
        if now - self.t_last < c.t_cool:
            return None
        if p_s > max((1 + c.tau) * p_l, c.min_pressure) \
                and len(long_pool) > c.n_min:
            # migrate the least-pressured long instance to the short pool
            victim = min(long_pool, key=self.pressure)
            self.t_last = now
            return Migration(victim.instance, "long", "short")
        if p_l > max((1 + c.tau) * p_s, c.min_pressure) \
                and len(short_pool) > c.n_min:
            victim = min(short_pool, key=self.pressure)
            self.t_last = now
            return Migration(victim.instance, "short", "long")
        return None
