"""Discrete-event cluster simulator.

Drives the *same* policy objects (core.scheduler) the real engine uses,
under a calibrated cost model, to reproduce the paper's experiments at
H200-cluster scale on this CPU-only container.  Supports:

  * shared-queue (temporal disaggregation, N ≥ 1 instances pulling from
    one policy) and routed (per-instance policies + router) topologies;
  * routers: round_robin, least_loaded (SGLang-router-like), pool
    (PLA spatial: classify → pool → least-loaded member);
  * Algorithm 2 controller with live instance migration between pools;
  * MIX mode (decode sessions co-resident with prefill — Fig.8);
  * closed-loop clients (Fig.1/3/6) and open-loop traces (Fig.7);
  * fault injection: instance failure/join and straggler slowdown.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.buckets import DEFAULT_DECODE_BUCKETS, DecodeBucketLadder
from repro_torch.core.controller import (InstanceStats, Migration,
                                   PressureController)
from repro_torch.core.request import Batch, Request
from repro_torch.core.routing import EngineView, Router
from repro_torch.core.scheduler import BasePolicy, ChunkWork, PoolPolicy
from repro_torch.core.slo import SLOTracker
from repro_torch.sim.costmodel import CostModel


@dataclasses.dataclass
class SimConfig:
    mode: str = "pd"              # "pd" (prefill-only instance) | "mix"
    router: str = "shared"        # shared | round_robin | least_loaded | pool
    control_period: float = 0.0   # >0 enables the pressure controller
    slo_ttft: Optional[float] = 0.4
    seed: int = 0
    max_events: int = 5_000_000
    # decode-only ticks price through the arena-resident decode ladder
    # (DESIGN.md §5), mirroring the real engine's DecodeBucketExecutor;
    # overflow falls back to the dense per-count pricing like the engine
    decode_buckets: Tuple[int, ...] = DEFAULT_DECODE_BUCKETS
    # packed prefill / mixed / chunk ticks run arena-resident (§6):
    # O(history + new) KV rows per step.  arena_prefill=False mirrors
    # the legacy engine — every packed step pays the whole-slot
    # gather/scatter round-trip of 2 · packed_seqs · arena_s_max rows
    arena_prefill: bool = True
    packed_seqs: int = 16          # gathered cache rows (b_max)
    arena_s_max: int = 256         # arena slot depth S_max
    # sliding-window width (DESIGN.md §7): mirrors the engine's rolling
    # windowed arena — decode ticks bill γ_r on min(cached, window)
    # rows per session, exactly the windowed kernel's HBM stream.
    # (CostModel.window applies the same clamp to prefill pricing.)
    window: Optional[int] = None
    # paged KV arena with radix prefix reuse (DESIGN.md §8): with
    # prefix_reuse on, admission converts each request's annotated
    # ``reusable_prefix`` — rounded DOWN to page granularity, capped so
    # at least one new token survives (the engine's match cap) — from
    # new tokens into history: the turn is billed suffix-prefill +
    # history reads, exactly what the paged engine executes.
    # (CostModel.page_size separately prices the page-table walk.)
    page_size: Optional[int] = None
    prefix_reuse: bool = False
    # §12 host-tier page spill: capacity (in pages) of the host pool
    # that catches device-evicted prefix pages.  Requests annotate the
    # host-resident part of their reusable prefix (Request.host_prefix);
    # with a pool those tokens stay adoptable but bill
    # CostModel.swap_in_time for the PCIe promotion, without one they
    # were dropped at eviction and fall out of the adoptable prefix.
    host_pool_pages: int = 0
    # §9 spatial disaggregation: when a prefill-role instance finishes a
    # request with decode budget, the session's KV hands off (device-to-
    # device, priced by CostModel.handoff_time) to the least-decode-
    # loaded non-prefill instance instead of decoding in place —
    # mirroring ServeCluster._maybe_migrate on the real engines.
    decode_handoff: bool = False
    # §10 speculative decoding: decode-only ticks become verify steps.
    # Each session's segment carries 1 + spec_k stream tokens, priced by
    # CostModel.spec_step_time (one amortized weight read for the whole
    # dispatch), and commits the EXPECTED 1 + round(spec_accept·spec_k)
    # tokens.  Fused decode rows inside mixed ticks stay 1-token in the
    # model (conservative: the real engine speculates there too).
    speculative: bool = False
    spec_k: int = 4
    spec_accept: float = 0.7
    # §11 fault tolerance: when an instance fails, its in-flight decode
    # sessions are recovered by PRICED re-prefill reconstruction on a
    # survivor (a synthetic recovery request of the session's full
    # cached context — mirroring ServeCluster's recovery path) instead
    # of being silently dropped as they used to be.
    recovery: bool = True
    # §11 SLO-aware admission control: reject an arrival whose
    # CostModel-predicted TTFT already violates its deadline (fail-fast
    # beats a guaranteed violation).  Off = accept everything.
    admission: bool = False


class _Instance:
    def __init__(self, idx: int, policy: Optional[BasePolicy],
                 speed: float = 1.0):
        self.idx = idx
        self.policy = policy          # None in shared mode
        self.speed = speed
        self.busy = False
        self.alive = True
        self.busy_time = 0.0
        self.busy_mark = 0.0          # busy_time at last control period
        # (tokens remaining, cached context length) per in-flight session:
        # decode pricing follows the ACTUAL cached lengths, which grow by
        # one with every generated token
        self.decode_sessions: List[Tuple[int, int]] = []
        self.recent_dev: List[float] = []
        self.prefill_done = 0
        self.current = None

    def advance_decodes(self, m: int = 1) -> None:
        """Every in-flight session emitted ``m`` tokens (1 plain, up to
        1 + k speculative): budgets shrink, cached contexts grow — a
        session with fewer than m tokens left just finishes."""
        self.decode_sessions = [(r - m, h + m)
                                for r, h in self.decode_sessions if r > m]

    @property
    def decode_ctx_lens(self) -> List[int]:
        return [h for _, h in self.decode_sessions]


class ClusterSim:
    def __init__(self, n_instances: int,
                 policy_factory: Callable[[int], BasePolicy],
                 cost: CostModel, cfg: Optional[SimConfig] = None,
                 shared_policy: Optional[BasePolicy] = None,
                 classifier: Optional[Callable[[Request], str]] = None,
                 controller: Optional[PressureController] = None,
                 pools: Optional[Dict[int, str]] = None,
                 router_obj: Optional[Router] = None,
                 roles: Optional[Sequence[str]] = None):
        self.cfg = cfg or SimConfig()
        self.cost = cost
        self.shared = shared_policy
        self.classifier = classifier
        self.controller = controller
        # router_obj: a core.routing Router drives placement over live
        # EngineView snapshots — the SAME object the real ServeCluster
        # uses, so policies tuned here drop into serving unchanged.
        # Takes precedence over the cfg.router string dispatch.
        self.router_obj = router_obj
        self.instances = [
            _Instance(i, None if shared_policy is not None else policy_factory(i))
            for i in range(n_instances)]
        # instance roles for the router + decode handoff ("prefill" =
        # long-prefill pool).  Default derives from PoolPolicy pools.
        if roles is not None:
            self.roles = list(roles)
        else:
            self.roles = [
                {"long": "prefill", "short": "decode"}.get(
                    getattr(i.policy, "pool", None) or "", "general")
                for i in self.instances]
        self.pools = pools or {}
        self.handoffs = 0
        self.handoff_tokens = 0
        self.swapped_pages = 0        # §12 host→device prefix promotions
        # §11: optional FaultInjector (set by apply_faults) + counters
        self.faults = None
        self.handoff_retries = 0
        self.recovered_sessions = 0
        self._decode_ladder = DecodeBucketLadder(self.cfg.decode_buckets)
        self.tracker = SLOTracker(self.cfg.slo_ttft)
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._rr = 0
        self.now = 0.0
        self.clients: List = []
        self._client_busy: Dict[int, bool] = {}

    # ------------------------------------------------------------ events
    def _push(self, t: float, kind: str, data=None) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, data))

    def add_requests(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self._admit_prefix(r)
            self._push(r.arrival, "arrival", r)

    def _admit_prefix(self, r: Request) -> None:
        """§8 prefix-reuse admission: shift the page-aligned part of the
        request's reusable prefix from new tokens into history.

        §12 host tier: the part of the prefix annotated host-resident
        (``host_prefix``) only survives eviction when the sim has a
        host pool — it is then billed one PCIe promotion
        (:meth:`CostModel.swap_in_time`) before the suffix prefill can
        start; without a pool those pages were dropped at eviction, so
        they fall out of the adoptable prefix and get re-prefilled."""
        if not (self.cfg.prefix_reuse and self.cfg.page_size
                and r.reusable_prefix > 0):
            return
        ps = self.cfg.page_size
        host = max(0, min(r.host_prefix, r.reusable_prefix))
        if self.cfg.host_pool_pages <= 0:
            r.reusable_prefix -= host
            host = 0
        else:
            kept = min(host, self.cfg.host_pool_pages * ps)
            r.reusable_prefix -= host - kept   # aged out of the pool too
            host = kept
        shift = min(r.reusable_prefix // ps * ps,
                    max(r.new_tokens - 1, 0))
        r.new_tokens -= shift
        r.history_tokens += shift
        if host > 0 and shift > 0:
            pages = -(-min(host, shift) // ps)
            r.swap_time = self.cost.swap_in_time(pages * ps)
            self.swapped_pages += pages

    def add_clients(self, clients, start: float = 0.0,
                    think_time: float = 0.0) -> None:
        self.clients = list(clients)
        self.think = think_time
        for cid in range(len(self.clients)):
            self._push(start, "client", cid)

    def inject_failure(self, t: float, instance: int) -> None:
        self._push(t, "fail", instance)

    def apply_faults(self, plan) -> None:
        """Map a core.faults.FaultPlan onto the simulator: crash events
        schedule instance failures at their ``at`` time (seconds here,
        ticks on the real cluster); transient handoff events are served
        by an injector consulted on the §9 handoff path (retried with
        backoff).  Dispatch/stall faults are engine-loop seams with no
        sim analogue — the sim's "dispatch" IS the priced service — so
        they are ignored."""
        from repro_torch.core.faults import CRASH, FaultInjector
        for ev in plan.events:
            if ev.kind == CRASH and 0 <= ev.engine < len(self.instances):
                self.inject_failure(ev.at, ev.engine)
        self.faults = FaultInjector(plan)

    def inject_join(self, t: float, instance_speed: Tuple[int, float]) -> None:
        self._push(t, "join", instance_speed)

    def set_straggler(self, instance: int, speed: float) -> None:
        self.instances[instance].speed = speed

    # ------------------------------------------------------------ routing
    def _views(self) -> List[EngineView]:
        return [EngineView(engine_id=i.idx,
                           role=(self.roles[i.idx]
                                 if i.idx < len(self.roles) else "general"),
                           alive=i.alive,
                           queue_len=i.policy.queue_len(),
                           backlog_tokens=i.policy.backlog_tokens(),
                           active_decodes=len(i.decode_sessions))
                for i in self.instances if i.alive and i.policy is not None]

    def _route(self, r: Request) -> Optional[_Instance]:
        alive = [i for i in self.instances if i.alive]
        if not alive:
            return None
        if self.router_obj is not None:
            return self.instances[self.router_obj.route(r, self._views())]
        if self.cfg.router == "round_robin":
            self._rr = (self._rr + 1) % len(alive)
            return alive[self._rr]
        if self.cfg.router == "least_loaded":
            return min(alive, key=lambda i: i.policy.backlog_tokens())
        if self.cfg.router == "pool":
            cls = self.classifier(r) if self.classifier else "short"
            members = [i for i in alive
                       if getattr(i.policy, "pool", None) == cls]
            if not members:
                members = alive
            return min(members, key=lambda i: i.policy.backlog_tokens())
        return None  # shared

    # ---------------------------------------------------------- admission
    def _admit(self, r: Request, policy: BasePolicy,
               inst: Optional[_Instance] = None) -> bool:
        """§11 SLO-aware admission gate (mirrors ServeLoop's): reject
        when the predicted TTFT — queue wait ahead plus own service —
        already violates the deadline.  Recovery re-prefills are never
        rejected (shedding one loses a session, not just a turn)."""
        if not self.cfg.admission or r.recovery:
            return True
        ddl = r.deadline if r.deadline is not None else (
            None if self.cfg.slo_ttft is None
            else r.arrival + self.cfg.slo_ttft)
        if ddl is None:
            return True
        eta = self.now + self.cost.predicted_ttft(
            r.new_tokens, r.history_tokens, policy.queue_len(),
            policy.backlog_tokens(),
            len(inst.decode_sessions) if inst is not None else 0)
        if eta <= ddl:
            return True
        r.rejected = True
        self.tracker.note_rejected()
        return False

    # ------------------------------------------------------------- engine
    def _decode_tick_time(self, ctx_lens: List[int],
                          spec: bool = True) -> float:
        """One decode-only tick, mirroring the real engine's routing:
        on-ladder counts run the arena-resident bucketed step billed on
        actual cached lengths (window-clamped for SWA configs — the §7
        rolling arena streams min(cached, window) rows); ladder overflow
        falls back to the dense gather path's per-count pricing (the
        engine does exactly this).  ``spec=False`` forces plain pricing
        for ticks that only commit one token per session (the leftover
        decode step alongside a mixed tick) — verify-row cost is only
        paid where the multi-token commit happens."""
        if self.cfg.window is not None:
            ctx_lens = [min(h, self.cfg.window) for h in ctx_lens]
        if self.cfg.speculative and spec:
            # §10: the tick is one packed verify dispatch — (1+k)-token
            # segments, one amortized weight read, host draft cost
            return self.cost.spec_step_time(ctx_lens, self.cfg.spec_k)
        bucket = self._decode_ladder.bucket_for(len(ctx_lens))
        if bucket is None:
            return self.cost.decode_step_time(len(ctx_lens))
        return self.cost.decode_bucket_time(ctx_lens, bucket)

    def _spec_commit(self) -> int:
        """Tokens one decode-only tick commits per session: the expected
        speculative prefix 1 + round(α·k), or 1 when not speculating."""
        if not self.cfg.speculative:
            return 1
        return 1 + int(round(self.cfg.spec_accept * self.cfg.spec_k))

    def _try(self, inst: _Instance) -> None:
        if inst.busy or not inst.alive:
            return
        policy = self.shared if self.shared is not None else inst.policy
        if self.cfg.mode == "mix":
            # continuous batching: the policy reserves packed-stream rows
            # for the decode backlog (and shrinks the AWD window)
            policy.note_decode_backlog(len(inst.decode_sessions))
        work, wake = policy.next_work(self.now)
        if work is None:
            # MIX: run a decode-only step if sessions are active — priced
            # as one arena-resident bucketed tick over actual contexts
            if self.cfg.mode == "mix" and inst.decode_sessions:
                dt = self._decode_tick_time(inst.decode_ctx_lens) \
                    * inst.speed
                inst.busy = True
                inst.current = "decode"
                self._push(self.now + dt, "done", (inst.idx, "decode"))
            elif wake is not None and wake > self.now:
                self._push(wake, "try", inst.idx)
            return
        if self.cfg.mode == "mix":
            # clamp the reserved fusion room to the actual backlog before
            # pricing — packed_batch_time / chunk_time charge each fused
            # decode row.  Chunks fuse too (the serve loop routes C_l
            # chunks through the packed stream) when the policy is packed.
            if isinstance(work, Batch) and work.is_packed:
                work.decode_tokens = min(work.decode_tokens,
                                         len(inst.decode_sessions))
            elif isinstance(work, ChunkWork):
                ladder = getattr(getattr(policy, "awd", None), "ladder", None)
                if ladder is not None:
                    # mirror the real loop exactly: fit_decodes respects
                    # BOTH the row room and the token-bucket room (an
                    # off-ladder chunk fuses nothing and runs dense)
                    from repro_torch.core.buckets import fit_decodes
                    n_fit, bucket = fit_decodes(
                        work.chunk_tokens, 1, len(inst.decode_sessions),
                        ladder)
                    work.decode_tokens = n_fit if bucket is not None else 0
        if isinstance(work, ChunkWork):
            # packed engines route every on-ladder C_l chunk through a
            # captured token-bucket shape (engine.prefill_long) — price
            # the graph launch in every mode, not just MIX
            ladder = getattr(getattr(policy, "awd", None), "ladder", None)
            work.uses_graph = (ladder is not None and
                               ladder.bucket_for(work.chunk_tokens)
                               is not None)
        # §6 routing: packed/mixed/chunk ticks are arena-resident (no
        # slot copies); the legacy config bills the gather/scatter
        # round-trip the slot-map kernel eliminated
        gather_rows = 0
        if not self.cfg.arena_prefill and (
                (isinstance(work, Batch) and work.is_packed)
                or (isinstance(work, ChunkWork) and work.uses_graph)):
            gather_rows = 2 * self.cfg.packed_seqs * self.cfg.arena_s_max
        service = self.cost.work_time(work, gather_rows=gather_rows) \
            * inst.speed
        # §12: host→device page promotion gates the suffix prefill —
        # billed once, on the request's first dispatch
        if isinstance(work, Batch):
            service += sum(r.swap_time for r in work.requests
                           if r.dispatch_time is None) * inst.speed
        elif isinstance(work, ChunkWork) and work.req.dispatch_time is None:
            service += work.req.swap_time * inst.speed
        if self.cfg.mode == "mix" and inst.decode_sessions:
            # decode tokens fused into a packed step already paid inside
            # the work's pricing (they share the weight read); sessions
            # beyond the fusion room pay the separate alternating step
            fused = getattr(work, "decode_tokens", 0) \
                if isinstance(work, (Batch, ChunkWork)) else 0
            if isinstance(work, Batch) and not work.is_packed:
                fused = 0
            leftover = len(inst.decode_sessions) - fused
            if leftover > 0:
                # sessions beyond the fusion room advance in a separate
                # bucketed decode tick, billed on their cached contexts
                service += self._decode_tick_time(
                    inst.decode_ctx_lens[fused:], spec=False) * inst.speed
            inst.advance_decodes()
        if isinstance(work, Batch):
            for r in work.requests:
                if r.dispatch_time is None:
                    r.dispatch_time = self.now
                r.instance = inst.idx
        elif isinstance(work, ChunkWork):
            if work.req.dispatch_time is None:
                work.req.dispatch_time = self.now
            work.req.instance = inst.idx
        inst.busy = True
        inst.current = work
        self._push(self.now + service, "done", (inst.idx, work))

    def _finish(self, inst: _Instance, work) -> None:
        inst.busy = False
        inst.current = None
        if work == "decode":
            inst.advance_decodes(self._spec_commit())
            return
        policy = self.shared if self.shared is not None else inst.policy
        policy.on_complete(work, self.now)
        if isinstance(work, Batch):
            for r in work.requests:
                r.finish_time = self.now
                self.tracker.record(r)
                self._after_request(inst, r)
        elif isinstance(work, ChunkWork) and work.is_last:
            work.req.finish_time = self.now
            self.tracker.record(work.req)
            self._after_request(inst, work.req)

    def _role(self, inst: _Instance) -> str:
        return self.roles[inst.idx] if inst.idx < len(self.roles) \
            else "general"

    def _after_request(self, inst: _Instance, r: Request) -> None:
        inst.prefill_done += 1
        if r.deadline is not None:
            inst.recent_dev.append(max(0.0, (r.finish_time or 0.0) - r.deadline))
        if self.cfg.mode == "mix" and r.decode_tokens > 0:
            if self.cfg.decode_handoff and self._role(inst) == "prefill" \
                    and any(i.alive and self._role(i) != "prefill"
                            for i in self.instances):
                # §9 spatial split: the prefilled session decodes on a
                # decode instance — its KV crosses engine→engine after
                # the (priced) device-to-device copy; the destination is
                # picked when the copy lands (load may have shifted)
                delay = self.cost.handoff_time(r.total_context)
                self.handoffs += 1
                self.handoff_tokens += r.total_context
                self._push(self.now + delay, "handoff",
                           (r.decode_tokens, r.total_context,
                            inst.idx, 0))
            else:
                inst.decode_sessions.append((r.decode_tokens,
                                             r.total_context))
        if 0 <= r.session < len(self.clients) and \
                self._client_busy.get(r.session, False):
            self._client_busy[r.session] = False
            self._push(self.now + self.think, "client", r.session)

    # ---------------------------------------------------------- controller
    def _instance_stats(self, inst: _Instance, period: float) -> InstanceStats:
        util = (inst.busy_time - inst.busy_mark) / max(period, 1e-9)
        inst.busy_mark = inst.busy_time
        dev = sum(inst.recent_dev) / len(inst.recent_dev) \
            if inst.recent_dev else 0.0
        # clip: structurally unmeetable deadlines (a 20k-token prefill vs
        # a 0.4 s TTFT SLO) must not dominate pool pressure, or the
        # controller starves the healthy pool chasing lost causes
        dev = min(dev, 1.0)
        inst.recent_dev = []
        backlog = inst.policy.backlog_tokens() / 16_384 if inst.policy else 0.0
        return InstanceStats(inst.idx, backlog, dev, min(util, 1.0))

    def _control(self) -> None:
        period = self.cfg.control_period
        alive = [i for i in self.instances if i.alive and i.policy is not None]
        shorts = [self._instance_stats(i, period) for i in alive
                  if getattr(i.policy, "pool", None) == "short"]
        longs = [self._instance_stats(i, period) for i in alive
                 if getattr(i.policy, "pool", None) == "long"]
        if self.controller is not None and shorts and longs:
            mig: Optional[Migration] = self.controller.step(
                shorts, longs, self.now)
            if mig is not None:
                inst = self.instances[mig.instance]
                if isinstance(inst.policy, PoolPolicy):
                    inst.policy.pool = mig.dst_pool
        self._push(self.now + period, "control")

    # --------------------------------------------------------------- run
    def run(self, until: float = float("inf")) -> SLOTracker:
        if self.cfg.control_period > 0:
            self._push(self.cfg.control_period, "control")
        events = 0
        busy_since: Dict[int, float] = {}
        while self._events and events < self.cfg.max_events:
            t, _, kind, data = heapq.heappop(self._events)
            if t > until:
                break
            self.now = t
            events += 1
            if kind == "arrival":
                r: Request = data
                if self.shared is not None:
                    if self._admit(r, self.shared):
                        self.shared.enqueue(r, t)
                        for inst in self.instances:
                            self._try(inst)
                else:
                    inst = self._route(r)
                    if inst is not None and \
                            self._admit(r, inst.policy, inst):
                        inst.policy.enqueue(r, t)
                        self._try(inst)
            elif kind == "client":
                # enqueue synchronously: the next turn must be visible to
                # any same-timestamp "try" of a freed instance, otherwise
                # the instance grabs a long chunk before the arrival lands
                cid: int = data
                if cid < len(self.clients):
                    r = self.clients[cid](t)
                    if r is not None:
                        r.arrival = t
                        r.session = cid
                        self._client_busy[cid] = True
                        admitted = False
                        if self.shared is not None:
                            if self._admit(r, self.shared):
                                admitted = True
                                self.shared.enqueue(r, t)
                                for inst in self.instances:
                                    self._try(inst)
                        else:
                            inst = self._route(r)
                            if inst is not None and \
                                    self._admit(r, inst.policy, inst):
                                admitted = True
                                inst.policy.enqueue(r, t)
                                self._try(inst)
                        if not admitted:
                            # rejected/unroutable: the closed-loop client
                            # thinks and moves on instead of hanging
                            self._client_busy[cid] = False
                            self._push(self.now + self.think, "client",
                                       cid)
            elif kind == "try":
                self._try(self.instances[data])
            elif kind == "handoff":
                # the migrated session's KV has landed: attach its decode
                # to the least decode-loaded non-prefill instance
                budget, ctx, src, attempt = data
                if self.faults is not None and \
                        self.faults.handoff_fails(src, self.now):
                    # §11 transient handoff failure: retry with
                    # exponential backoff, or keep the session on the
                    # source after max attempts (it decodes in place)
                    self.handoff_retries += 1
                    self.tracker.note_retried()
                    if attempt + 1 >= 3:
                        if 0 <= src < len(self.instances) and \
                                self.instances[src].alive:
                            self.instances[src].decode_sessions.append(
                                (budget, ctx))
                            self._try(self.instances[src])
                    else:
                        backoff = self.cost.handoff_launch * \
                            (2 ** (attempt + 1))
                        self._push(self.now + backoff, "handoff",
                                   (budget, ctx, src, attempt + 1))
                    continue
                cands = [i for i in self.instances
                         if i.alive and self._role(i) != "prefill"]
                dst = min(cands, key=lambda i: (len(i.decode_sessions),
                                                i.idx)) if cands else None
                if dst is not None:
                    dst.decode_sessions.append((budget, ctx))
                    self._try(dst)
            elif kind == "done":
                idx, work = data
                inst = self.instances[idx]
                if not inst.alive or inst.current is not work:
                    continue  # stale completion from a failed instance
                self._finish(inst, work)
                # defer the idle re-check behind same-timestamp client
                # releases pushed by _finish (closed-loop next turns)
                self._push(self.now, "try", inst.idx)
            elif kind == "fail":
                inst = self.instances[data]
                inst.alive = False
                # in-flight work dies with the node: the request is
                # re-submitted (re-prefill from cached/replicated state).
                # A ChunkWork's request ALSO still sits in the policy
                # queue (it only leaves at the last chunk's on_complete),
                # so the drain below must skip anything re-pushed here —
                # a double arrival dispatches the request twice and
                # double-records it.
                repushed = set()
                if isinstance(inst.current, Batch):
                    for r in inst.current.requests:
                        r.dispatch_time = None
                        repushed.add(r.rid)
                        self._push(self.now, "arrival", r)
                elif isinstance(inst.current, ChunkWork):
                    inst.current.req.dispatch_time = None
                    repushed.add(inst.current.req.rid)
                    self._push(self.now, "arrival", inst.current.req)
                inst.current, inst.busy = None, False
                # queued requests are re-routed to surviving instances
                if inst.policy is not None:
                    for r in inst.policy.drain():
                        if r.rid in repushed:
                            continue
                        r.dispatch_time = None
                        self.tracker.note_retried()
                        self._push(self.now, "arrival", r)
                # §11: in-flight decode sessions are recovered by PRICED
                # re-prefill reconstruction — a synthetic recovery
                # request replays the session's full cached context on a
                # survivor (billed as a normal prefill of ctx tokens),
                # then its remaining decode budget re-attaches there.
                # Mirrors ServeCluster._recover_session; previously the
                # sessions were silently dropped.
                if self.cfg.recovery and \
                        any(i.alive for i in self.instances):
                    for budget, ctx in inst.decode_sessions:
                        rr = Request(new_tokens=max(ctx, 1),
                                     arrival=self.now, deadline=None,
                                     session=-1, decode_tokens=budget,
                                     recovery=True)
                        self.recovered_sessions += 1
                        self._push(self.now, "arrival", rr)
                inst.decode_sessions = []
            elif kind == "join":
                idx, speed = data
                while len(self.instances) <= idx:
                    self.instances.append(_Instance(len(self.instances), None))
                self.instances[idx].alive = True
                self.instances[idx].speed = speed
            elif kind == "control":
                self._control()
            # busy-time accounting
            for inst in self.instances:
                if inst.busy and inst.idx not in busy_since:
                    busy_since[inst.idx] = t
                elif not inst.busy and inst.idx in busy_since:
                    inst.busy_time += t - busy_since.pop(inst.idx)
        return self.tracker

    # ------------------------------------------------------------ metrics
    def prefill_rps(self, horizon: float) -> float:
        return sum(i.prefill_done for i in self.instances) / max(horizon, 1e-9)
