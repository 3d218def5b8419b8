"""Workload generation: LMSys-Chat-1M-like multi-turn conversations.

Calibrated to Fig.2 of the paper: ~63% of first-turn prompts < 256
tokens, rising to ~81% in subsequent turns (re-prefills exclude the
system prompt and carry only the new user message).  Long-context
requests (> 1K tokens) form the heavy tail.

Two client models:
  * open-loop Poisson arrivals (Fig.7's λ-driven SLO experiments);
  * closed-loop concurrency-C clients (Fig.1/3/6's "concurrency level"
    axis): each client submits its next turn as soon as the previous one
    finishes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request


@dataclasses.dataclass
class WorkloadConfig:
    # first-turn prompt lengths: lognormal, ~63% < 256
    first_mu: float = math.log(150.0)
    first_sigma: float = 1.3
    # later-turn (re-prefill) new-token lengths: lognormal, ~81% < 256
    later_mu: float = math.log(80.0)
    later_sigma: float = 1.1
    # assistant responses (grow the history)
    resp_mu: float = math.log(200.0)
    resp_sigma: float = 0.8
    mean_turns: float = 3.5          # geometric
    max_len: int = 32_768
    slo_ttft: Optional[float] = 0.4  # s (paper §4.1); None = deadline-free
    decode_mu: float = math.log(150.0)
    decode_sigma: float = 0.9


def _ln(rng: np.random.Generator, mu: float, sigma: float, max_len: int) -> int:
    return int(min(max(rng.lognormal(mu, sigma), 1.0), max_len))


class SessionSampler:
    """Stateful per-session turn generator."""

    def __init__(self, cfg: WorkloadConfig, rng: np.random.Generator,
                 session_id: int):
        self.cfg = cfg
        self.rng = rng
        self.session = session_id
        self.turn = 0
        self.history = 0
        self.n_turns = 1 + rng.geometric(1.0 / cfg.mean_turns)

    def done(self) -> bool:
        return self.turn >= self.n_turns

    def next_request(self, now: float) -> Request:
        c = self.cfg
        if self.turn == 0:
            l = _ln(self.rng, c.first_mu, c.first_sigma, c.max_len)
            h = 0
        else:
            l = _ln(self.rng, c.later_mu, c.later_sigma, c.max_len)
            h = self.history
        dec = _ln(self.rng, c.decode_mu, c.decode_sigma, c.max_len)
        r = Request(new_tokens=l, history_tokens=h, arrival=now,
                    deadline=(now + c.slo_ttft) if c.slo_ttft else None,
                    session=self.session, decode_tokens=dec)
        self.history = h + l + dec
        self.turn += 1
        return r


def lmsys_like_requests(n: int, rate: float, cfg: Optional[WorkloadConfig] = None,
                        seed: int = 0) -> List[Request]:
    """Open-loop: n requests, Poisson(rate) arrivals, stationary turn mix."""
    cfg = cfg or WorkloadConfig()
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    t = 0.0
    sessions: List[SessionSampler] = []
    sid = 0
    while len(out) < n:
        t += rng.exponential(1.0 / rate)
        # continue an existing session w.p. proportional to remaining turns
        live = [s for s in sessions if not s.done()]
        if live and rng.random() < 0.7:
            s = rng.choice(live)
        else:
            s = SessionSampler(cfg, rng, sid)
            sid += 1
            sessions.append(s)
        out.append(s.next_request(t))
    return out


def closed_loop_clients(concurrency: int, cfg: Optional[WorkloadConfig] = None,
                        seed: int = 0, think_time: float = 0.0,
                        long_only: bool = False, short_only: bool = False,
                        long_min: int = 1024, short_max: int = 64):
    """Closed-loop client factories for the simulator (Fig.1/3 style).

    Returns a list of ``next_request(now) -> Request | None`` callables,
    one per client; each produces its next turn when called (the sim
    calls it when the previous request finishes + think_time).
    ``long_only`` / ``short_only`` clamp lengths to reproduce the paper's
    interference experiments (>1K vs <64 tokens).
    """
    cfg = cfg or WorkloadConfig()

    def make_client(i: int) -> Callable[[float], Optional[Request]]:
        rng = np.random.default_rng(seed * 7919 + i)
        state = {"s": SessionSampler(cfg, rng, i)}

        def next_request(now: float) -> Optional[Request]:
            if state["s"].done():
                state["s"] = SessionSampler(cfg, rng, i + 100_000)
            r = state["s"].next_request(now)
            if long_only:
                r.new_tokens = max(r.new_tokens, long_min) + \
                    int(rng.integers(0, 3 * long_min))
            elif short_only:
                r.new_tokens = 1 + int(rng.integers(0, short_max))
            return r

        return next_request

    return [make_client(i) for i in range(concurrency)]


def length_stats(requests: Sequence[Request]) -> dict:
    """Fig.2 reproduction: fraction of prompts < 256 by turn position."""
    first = [r.new_tokens for r in requests if not r.is_reprefill]
    later = [r.new_tokens for r in requests if r.is_reprefill]

    def frac_below(xs, k):
        return sum(1 for x in xs if x < k) / len(xs) if xs else 0.0

    return {
        "n_first": len(first), "n_later": len(later),
        "first_lt256": frac_below(first, 256),
        "later_lt256": frac_below(later, 256),
        "first_gt1k": frac_below(first, 10 ** 9) - frac_below(first, 1024),
        "later_gt1k": frac_below(later, 10 ** 9) - frac_below(later, 1024),
        "first_median": float(np.median(first)) if first else 0.0,
        "later_median": float(np.median(later)) if later else 0.0,
    }
