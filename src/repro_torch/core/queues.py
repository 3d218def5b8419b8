"""§3.2 — dual-queue length classification (Q_s / Q_l).

Requests are classified at arrival by prompt length against the fitted
compute/memory boundary L_m (re-prefills use the history-dependent
L_m^re-prefill).  Each class has an independent FIFO; instances in
disaggregated modes pull exclusively from one queue.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional

from repro_torch.core.boundary import LatencyModel
from repro_torch.core.request import Request


class DualQueue:
    def __init__(self, model: LatencyModel,
                 override_threshold: Optional[float] = None):
        self.model = model
        self.override = override_threshold
        self.short: Deque[Request] = deque()
        self.long: Deque[Request] = deque()
        self.n_short = 0
        self.n_long = 0

    def threshold(self, history: int) -> float:
        if self.override is not None:
            return self.override
        return self.model.boundary(history)

    def classify(self, r: Request) -> str:
        return "short" if r.new_tokens < self.threshold(r.history_tokens) \
            else "long"

    def push(self, r: Request) -> str:
        cls = self.classify(r)
        if cls == "short":
            self.short.append(r)
            self.n_short += 1
        else:
            self.long.append(r)
            self.n_long += 1
        return cls

    # ------------------------------------------------------------- stats
    def backlog_tokens(self, which: str) -> int:
        q = self.short if which == "short" else self.long
        return sum(r.new_tokens for r in q)

    def oldest_wait(self, which: str, now: float) -> float:
        q = self.short if which == "short" else self.long
        return now - q[0].arrival if q else 0.0

    def __len__(self) -> int:
        return len(self.short) + len(self.long)
