"""Cluster-level routing policies for spatial disaggregation (§3, fig7/fig8).

Pure decision objects, JAX-free, shared verbatim by the real multi-engine
``ServeCluster`` (serving/cluster.py) and the discrete-event cluster
simulator (sim/simulator.py): both sides build :class:`EngineView`
snapshots of their instances and ask the :class:`Router` for a placement,
so a policy tuned offline in the simulator drops into the live cluster
unchanged.

Three concrete policies reproduce the paper's fig7 comparison:

* :class:`RoundRobinRouter` — vanilla data-parallel spraying (the paper's
  DP baseline).
* :class:`LeastLoadedRouter` — SGLang-router-style backlog balancing:
  place on the engine with the smallest queued-token + active-decode load.
* :class:`LengthAwareRouter` — the paper's dual-queue SPATIAL mode: long
  prefills go only to dedicated prefill-role engines, shorts batch on the
  rest, each pool balanced least-loaded internally. An optional spillover
  lets a short ride an *idle* prefill engine under short-pool pressure;
  the cluster's deflection hook (Load-Aware Prefill Deflection) bounces it
  back through :meth:`Router.route` with ``exclude={engine_id}`` if long
  work arrives behind it before dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence


@dataclasses.dataclass
class EngineView:
    """One engine's router-visible state at routing time."""

    engine_id: int
    role: str = "general"          # "prefill" | "decode" | "general"
    alive: bool = True
    # §11 failure model: "healthy" | "degraded" | "dead".  Dead engines
    # are never routed to; degraded ones (recent transient faults) are
    # eligible only when no healthy engine is.
    health: str = "healthy"
    queue_len: int = 0             # queued requests (policy backlog)
    backlog_tokens: int = 0        # queued prefill tokens
    active_decodes: int = 0        # sessions mid-generation
    free_slots: int = 0            # free arena slots / pages


@dataclasses.dataclass
class RouteRequest:
    """The router-visible shape of one incoming turn."""

    new_tokens: int
    history_tokens: int = 0
    decode_tokens: int = 0
    session: int = -1


def _load(v: EngineView):
    """Backlog ordering: queued prefill work plus resident decode load;
    ties break on queue depth, then engine id for determinism."""
    return (v.backlog_tokens + v.active_decodes, v.queue_len, v.engine_id)


class Router:
    """route(request, cluster_state) -> engine_id.

    ``views`` is the full cluster snapshot; ``exclude`` names engines that
    must not be chosen (deflection re-routes pass the bouncing engine).
    If exclusion leaves nothing eligible the exclusion is ignored rather
    than failing — a lone overloaded engine still beats dropping work.
    """

    name = "router"

    def route(self, req, views: Sequence[EngineView],
              exclude: FrozenSet[int] = frozenset()) -> int:
        raise NotImplementedError

    @staticmethod
    def _eligible(views: Sequence[EngineView],
                  exclude: FrozenSet[int]) -> List[EngineView]:
        live = [v for v in views if v.alive and v.health != "dead"]
        out = [v for v in live if v.engine_id not in exclude]
        if not out:
            out = live
        if not out:
            raise RuntimeError("no alive engines to route to")
        # prefer fully-healthy engines; degraded ones (recent transient
        # faults, §11) only take traffic when nothing healthy is eligible
        healthy = [v for v in out if v.health == "healthy"]
        return healthy or out


class RoundRobinRouter(Router):
    """Data-parallel baseline: successive requests walk the engine list."""

    name = "round_robin"

    def __init__(self):
        self._i = -1

    def route(self, req, views, exclude=frozenset()) -> int:
        elig = self._eligible(views, exclude)
        self._i += 1
        return elig[self._i % len(elig)].engine_id


class LeastLoadedRouter(Router):
    """Backlog balancing: minimize queued tokens + active decodes."""

    name = "least_loaded"

    def route(self, req, views, exclude=frozenset()) -> int:
        return min(self._eligible(views, exclude), key=_load).engine_id


class LengthAwareRouter(Router):
    """Dual-queue spatial placement (§3): longs pinned to prefill engines.

    A request with ``new_tokens >= threshold`` is long and may only land
    on a prefill-role engine (falling back to the general pool when the
    cluster has none). Shorts go least-loaded over the non-prefill pool.
    With ``spill_tokens`` set, a short may be placed on an *idle* prefill
    engine when every short engine's backlog exceeds that bound — the
    deflection hook undoes the spill if the prefill engine becomes busy
    before the short dispatches.
    """

    name = "length_aware"

    def __init__(self, threshold: float = 256.0,
                 spill_tokens: Optional[int] = None):
        self.threshold = threshold
        self.spill_tokens = spill_tokens

    def is_long(self, req) -> bool:
        return req.new_tokens >= self.threshold

    def route(self, req, views, exclude=frozenset()) -> int:
        elig = self._eligible(views, exclude)
        prefill = [v for v in elig if v.role == "prefill"]
        rest = [v for v in elig if v.role != "prefill"]
        if self.is_long(req):
            pool = prefill or rest
            return min(pool, key=_load).engine_id
        if not rest:
            return min(prefill, key=_load).engine_id
        best = min(rest, key=_load)
        if (self.spill_tokens is not None and prefill
                and best.backlog_tokens > self.spill_tokens):
            idle = [v for v in prefill
                    if v.backlog_tokens == 0 and v.queue_len == 0]
            if idle:
                return min(idle, key=_load).engine_id
        return best.engine_id


def make_router(name: str, threshold: float = 256.0,
                spill_tokens: Optional[int] = None) -> Router:
    if name in ("round_robin", "rr"):
        return RoundRobinRouter()
    if name in ("least_loaded", "ll"):
        return LeastLoadedRouter()
    if name in ("length_aware", "spatial"):
        return LengthAwareRouter(threshold=threshold,
                                 spill_tokens=spill_tokens)
    raise ValueError(f"unknown router: {name!r}")
