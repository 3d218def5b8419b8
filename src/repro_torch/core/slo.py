"""SLO accounting: TTFT percentiles, violation rates, RPS (§4 metrics)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.request import Request


def percentile(vals: Sequence[float], q: float) -> float:
    """Standard nearest-rank percentile: the ⌈q·n⌉-th smallest value.

    The previous ``int(q * n)`` index was biased one rank high — p99 over
    any sample smaller than 100 reported the maximum instead of the
    99th-percentile rank.
    """
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(max(math.ceil(q * len(s)), 1), len(s)) - 1
    return s[idx]


@dataclasses.dataclass
class SLOReport:
    n: int
    rps: float
    mean_ttft: float
    p50_ttft: float
    p90_ttft: float
    p99_ttft: float
    violation_rate: float
    mean_queue_wait: float
    graph_hit_rate: float = 0.0
    # speculative decoding (DESIGN.md §10) — zeros when no draft is armed
    tokens_drafted: int = 0
    tokens_accepted: int = 0
    spec_dispatches: int = 0
    spec_acceptance: float = 0.0        # accepted / drafted
    spec_tokens_per_dispatch: float = 0.0
    # fault tolerance + admission control (DESIGN.md §11) — zeros on a
    # fault-free, accept-everything run
    rejected: int = 0                   # shed by the admission gate
    retried: int = 0                    # re-enqueued / re-routed attempts
    recovered_sessions: int = 0         # re-prefill-reconstructed sessions
    abandoned: int = 0                  # dropped at max_wall expiry

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class SLOTracker:
    """Streaming SLO aggregates plus a bounded tail of finished requests.

    Means, violation rate, graph hit rate, and the horizon are folded into
    O(1) state in :meth:`record`, so a long-lived serve loop never holds
    more than ``2 * max_finished`` Request objects. ``finished`` keeps the
    most recent requests for percentile estimation and for callers that
    inspect individual results — on runs shorter than ``max_finished`` it
    retains everything and :meth:`report` is exact, matching the old
    keep-it-all behaviour.
    """

    def __init__(self, slo_ttft: Optional[float] = None,
                 max_finished: int = 4096):
        self.slo = slo_ttft
        self.max_finished = max_finished
        self.finished: List[Request] = []
        # streaming aggregates over every request ever recorded
        self.n_recorded = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._wait_sum = 0.0
        self._wait_n = 0
        self._viol = 0
        self._denom = 0
        self._graphs = 0
        self._max_finish = 0.0
        # speculative decoding totals, synced from Engine.stats() by the
        # serve loop (absolute values, not deltas — idempotent)
        self.tokens_drafted = 0
        self.tokens_accepted = 0
        self.spec_dispatches = 0
        self.spec_committed = 0
        # fault tolerance + admission control (DESIGN.md §11)
        self.rejected = 0
        self.retried = 0
        self.recovered = 0
        self.abandoned = 0

    def note_rejected(self, n: int = 1) -> None:
        """Admission gate shed ``n`` submits (fail-fast, never queued)."""
        self.rejected += n

    def note_retried(self, n: int = 1) -> None:
        """``n`` dispatch/handoff/submit attempts were re-tried."""
        self.retried += n

    def note_recovered(self, n: int = 1) -> None:
        """``n`` sessions were re-prefill-reconstructed after a crash."""
        self.recovered += n

    def note_abandoned(self, r: Optional[Request] = None) -> None:
        """A still-queued request was dropped (max_wall expiry).  It
        never finished, so a deadline it carried counts as violated —
        abandoning must not flatter the violation rate."""
        self.abandoned += 1
        if r is not None:
            ddl = r.deadline if r.deadline is not None else (
                None if self.slo is None else r.arrival + self.slo)
            if ddl is not None:
                self._denom += 1
                self._viol += 1

    def note_spec(self, drafted: int, accepted: int, dispatches: int,
                  committed: int = 0) -> None:
        """Sync the engine's speculative counters into the tracker.
        Absolute totals (one tracker per engine), so calling after every
        tick is safe; :meth:`merged` sums them across engines."""
        self.tokens_drafted = int(drafted)
        self.tokens_accepted = int(accepted)
        self.spec_dispatches = int(dispatches)
        self.spec_committed = int(committed)

    def record(self, r: Request) -> None:
        if getattr(r, "recovery", False):
            # a synthetic re-prefill reconstructing a crashed session:
            # count the recovery, but keep it out of TTFT/violation
            # stats — its "arrival" is the crash time, not a client's
            self.recovered += 1
            return
        self.n_recorded += 1
        t = r.ttft()
        if t is not None:
            self._ttft_sum += t
            self._ttft_n += 1
        if r.dispatch_time is not None:
            self._wait_sum += r.dispatch_time - r.arrival
            self._wait_n += 1
        ddl = r.deadline if r.deadline is not None else (
            None if self.slo is None else r.arrival + self.slo)
        if ddl is not None:
            self._denom += 1
            if r.finish_time is None or r.finish_time > ddl:
                self._viol += 1
        if r.used_graph:
            self._graphs += 1
        if r.finish_time is not None:
            self._max_finish = max(self._max_finish, r.finish_time)
        self.finished.append(r)
        if len(self.finished) > 2 * self.max_finished:
            del self.finished[:-self.max_finished]

    @classmethod
    def merged(cls, trackers: Sequence["SLOTracker"]) -> "SLOTracker":
        """Fold several trackers (one per cluster engine) into one view."""
        out = cls(trackers[0].slo if trackers else None,
                  max_finished=max((t.max_finished for t in trackers),
                                   default=4096))
        for t in trackers:
            out.n_recorded += t.n_recorded
            out._ttft_sum += t._ttft_sum
            out._ttft_n += t._ttft_n
            out._wait_sum += t._wait_sum
            out._wait_n += t._wait_n
            out._viol += t._viol
            out._denom += t._denom
            out._graphs += t._graphs
            out._max_finish = max(out._max_finish, t._max_finish)
            out.tokens_drafted += t.tokens_drafted
            out.tokens_accepted += t.tokens_accepted
            out.spec_dispatches += t.spec_dispatches
            out.spec_committed += t.spec_committed
            out.rejected += t.rejected
            out.retried += t.retried
            out.recovered += t.recovered
            out.abandoned += t.abandoned
            out.finished.extend(t.finished)
        if len(out.finished) > 2 * out.max_finished:
            out.finished.sort(key=lambda r: r.finish_time or 0.0)
            del out.finished[:-out.max_finished]
        return out

    def report(self, horizon: Optional[float] = None) -> SLOReport:
        ttfts = [r.ttft() for r in self.finished if r.ttft() is not None]
        if horizon is None:
            horizon = self._max_finish if self.n_recorded else 1.0
        return SLOReport(
            n=self.n_recorded,
            rps=self.n_recorded / max(horizon, 1e-9),
            mean_ttft=self._ttft_sum / self._ttft_n if self._ttft_n else 0.0,
            p50_ttft=percentile(ttfts, 0.50),
            p90_ttft=percentile(ttfts, 0.90),
            p99_ttft=percentile(ttfts, 0.99),
            violation_rate=self._viol / self._denom if self._denom else 0.0,
            mean_queue_wait=(self._wait_sum / self._wait_n
                             if self._wait_n else 0.0),
            graph_hit_rate=(self._graphs / self.n_recorded
                            if self.n_recorded else 0.0),
            tokens_drafted=self.tokens_drafted,
            tokens_accepted=self.tokens_accepted,
            spec_dispatches=self.spec_dispatches,
            spec_acceptance=(self.tokens_accepted
                             / max(1, self.tokens_drafted)),
            spec_tokens_per_dispatch=(self.spec_committed
                                      / max(1, self.spec_dispatches)),
            rejected=self.rejected,
            retried=self.retried,
            recovered_sessions=self.recovered,
            abandoned=self.abandoned,
        )
