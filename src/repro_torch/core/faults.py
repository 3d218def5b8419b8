"""Deterministic fault injection for chaos testing (DESIGN.md §11).

A :class:`FaultPlan` is a frozen, seed-reproducible script of failures;
a :class:`FaultInjector` consumes one plan and answers point queries from
the serving stack's fault seams:

  * ``crashes_due(tick)``      — engine deaths (``ServeCluster`` kills the
    engine, evacuates its queue through the router, and re-prefill-
    reconstructs its in-flight sessions on survivors);
  * ``handoff_fails(engine)``  — transient export/import failures on the
    §9 arena→arena handoff path (the cluster retries with exponential
    backoff and falls back to keeping the session home);
  * ``dispatch_fails(engine)`` — a dispatch attempt raises before the
    engine runs (the loop re-enqueues the work untouched);
  * ``submit_stall(index)``    — the Nth cluster submit is accepted but
    withheld for ``duration`` ticks before being routed (a slow/retried
    client connection).

Everything is driven by the plan — the injector holds NO hidden RNG
state, so replaying the same plan over the same workload reproduces the
same failure sequence exactly.  JAX-free: shared verbatim by the real
``ServeCluster`` and the discrete-event ``ClusterSim`` (where ``at`` is
simulated seconds instead of a tick index).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

CRASH = "crash"          # engine dies at tick `at`
HANDOFF = "handoff"      # next `count` handoffs FROM `engine` fail
DISPATCH = "dispatch"    # next `count` dispatches ON `engine` raise
STALL = "stall"          # the `at`-th submit is held `duration` ticks

KINDS = (CRASH, HANDOFF, DISPATCH, STALL)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str                # one of KINDS
    at: float = 0.0          # tick (cluster) / seconds (sim); STALL: submit #
    engine: int = -1         # target engine (-1 = any, for HANDOFF/DISPATCH)
    count: int = 1           # transient kinds: consecutive failures injected
    duration: float = 0.0    # STALL: ticks/seconds the submit is withheld


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None       # provenance only (set by random())

    @classmethod
    def random(cls, seed: int, n_engines: int, horizon: float = 64.0,
               max_crashes: int = 1, p_crash: float = 0.5,
               p_handoff: float = 0.5, p_dispatch: float = 0.5,
               p_stall: float = 0.5, max_submits: int = 8) -> "FaultPlan":
        """A seed-deterministic chaos plan.  At most ``max_crashes``
        engines die (never all: at least one survivor is always left so
        recovery has somewhere to land); transient handoff/dispatch
        faults and submit stalls are sprinkled independently."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        crashes = min(max_crashes, max(n_engines - 1, 0))
        victims = rng.sample(range(n_engines), n_engines)
        for v in victims[:crashes]:
            if rng.random() < p_crash:
                events.append(FaultEvent(
                    CRASH, at=float(rng.randrange(1, max(int(horizon), 2))),
                    engine=v))
        if rng.random() < p_handoff:
            events.append(FaultEvent(
                HANDOFF, at=float(rng.randrange(0, max(int(horizon), 1))),
                engine=rng.randrange(n_engines), count=rng.randint(1, 4)))
        if rng.random() < p_dispatch:
            events.append(FaultEvent(
                DISPATCH, at=float(rng.randrange(0, max(int(horizon), 1))),
                engine=rng.randrange(n_engines), count=rng.randint(1, 3)))
        if rng.random() < p_stall:
            events.append(FaultEvent(
                STALL, at=float(rng.randrange(0, max_submits)),
                duration=float(rng.randint(1, 6))))
        return cls(events=tuple(events), seed=seed)


class FaultInjector:
    """Consumes one :class:`FaultPlan`.  Stateful only in *which events
    already fired* — deterministic given the same query sequence."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._left: Dict[int, int] = {
            i: ev.count for i, ev in enumerate(plan.events)}
        self._crashed: set = set()
        # injected-fault tally by kind (observability + test assertions)
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}

    def _matches(self, ev: FaultEvent, kind: str, engine: int,
                 at: Optional[float]) -> bool:
        if ev.kind != kind:
            return False
        if ev.engine not in (-1, engine):
            return False
        return at is None or at >= ev.at

    def _consume(self, kind: str, engine: int,
                 at: Optional[float]) -> Optional[FaultEvent]:
        for i, ev in enumerate(self.plan.events):
            if self._left.get(i, 0) <= 0:
                continue
            if self._matches(ev, kind, engine, at):
                self._left[i] -= 1
                self.injected[kind] += 1
                return ev
        return None

    # ------------------------------------------------------------ queries
    def crashes_due(self, tick: float) -> List[int]:
        """Engine ids whose crash event has matured (fires once each)."""
        out = []
        for i, ev in enumerate(self.plan.events):
            if ev.kind == CRASH and i not in self._crashed and tick >= ev.at:
                self._crashed.add(i)
                self.injected[CRASH] += 1
                out.append(ev.engine)
        return out

    def handoff_fails(self, engine: int, at: Optional[float] = None) -> bool:
        """True when the next handoff FROM ``engine`` should fail
        transiently (one scripted failure consumed per call)."""
        return self._consume(HANDOFF, engine, at) is not None

    def dispatch_fails(self, engine: int, at: Optional[float] = None) -> bool:
        """True when the next dispatch on ``engine`` should raise."""
        return self._consume(DISPATCH, engine, at) is not None

    def submit_stall(self, index: int) -> Optional[float]:
        """Duration to withhold the ``index``-th submit, or None."""
        for i, ev in enumerate(self.plan.events):
            if (ev.kind == STALL and self._left.get(i, 0) > 0
                    and int(ev.at) == index):
                self._left[i] -= 1
                self.injected[STALL] += 1
                return ev.duration
        return None
