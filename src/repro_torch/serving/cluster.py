"""Multi-engine spatial disaggregation of the port, from
``repro.serving.cluster``: the ServeCluster.

Owns N independent ``Engine``/``ServeLoop`` pairs and a pluggable
:class:`~repro_torch.core.routing.Router`.  Three mechanisms reproduce
the paper's fig7/fig8 multi-instance mode on real PyTorch engines (on
one card the engines share the device and one copy of the weights):

* **Length-aware routing** — every fresh session is placed by the
  router over live :class:`EngineView` snapshots; later turns follow the
  session's home engine (its KV lives there).
* **Arena→arena KV handoff** — a session prefilled on a prefill-role
  engine migrates to a decode-role engine before generating:
  ``Engine.export_session`` → ``Engine.import_session`` moves slot rows
  or page lists as device tensors, written into the destination arena
  in place (``handoff_host_bytes == 0`` is the no-host-bounce proof),
  the loop-side decode bookkeeping moves with it, and the source slot
  frees for the next long prefill.
* **Deflection** — a short that spilled onto an idle prefill engine is
  bounced back to the router (``ServeLoop.withdraw`` + re-route with
  ``exclude={engine}``) if long work lands behind it before it
  dispatches — Load-Aware Prefill Deflection's admission control.

The cluster drives all loops round-robin through ``ServeLoop.tick``, so
one thread interleaves every engine — the same unified-tick semantics
as a single loop, summed over instances.  The migration gate prices a
handoff with the analytic cost model (``sim.costmodel``), not wall
time, so a replay takes the same decisions.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultInjector
from repro_torch.core.request import Request
from repro_torch.core.routing import (EngineView, LengthAwareRouter,
                                      RouteRequest, Router)
from repro_torch.core.slo import SLOReport, SLOTracker
from repro_torch.serving.loop import PendingRequest, ServeLoop
from repro_torch.serving.sampling import SamplingParams
from repro_torch.sim.costmodel import CostModel, H200_32B


class ServeCluster:
    """N serve loops behind one submit() + a routing/migration brain."""

    def __init__(self, loops: Sequence[ServeLoop], router: Router,
                 roles: Optional[Sequence[str]] = None,
                 migrate_decodes: Optional[bool] = None,
                 deflect_backlog_tokens: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 cost: Optional[CostModel] = None,
                 max_handoff_attempts: int = 3,
                 degrade_ticks: int = 8):
        assert loops, "a cluster needs at least one engine"
        self.loops: List[ServeLoop] = list(loops)
        self.router = router
        self.roles: List[str] = (list(roles) if roles is not None
                                 else ["general"] * len(self.loops))
        assert len(self.roles) == len(self.loops)
        pagedness = {lp.engine._paged for lp in self.loops}
        assert len(pagedness) == 1, \
            "mixed slot/paged clusters cannot hand sessions off"
        spatial = (any(r == "prefill" for r in self.roles)
                   and any(r != "prefill" for r in self.roles))
        # migrate by default exactly when the cluster HAS a spatial
        # split and its engines support handoff.  The ORIGINAL flag
        # value is kept: None (auto) applies the §11 cost/benefit gate,
        # True forces the old always-migrate behaviour, False disables.
        self._migrate_override = migrate_decodes
        self.migrate = (spatial and all(lp.engine.can_handoff
                                        for lp in self.loops)
                        if migrate_decodes is None else migrate_decodes)
        self.deflect_tokens = deflect_backlog_tokens
        self._home: Dict[int, int] = {}            # session → engine
        self._deflectable: Dict[int, Tuple[int, int]] = {}  # rid → (eng, sess)
        self.deflections = 0
        self.migrated_sessions = 0
        # ---- §11 fault tolerance -------------------------------------
        self.faults = faults
        self.cost = cost if cost is not None else H200_32B
        self.max_handoff_attempts = max_handoff_attempts
        self.degrade_ticks = degrade_ticks
        self.health: List[str] = ["healthy"] * len(self.loops)
        self._tick = 0                             # cluster tick index
        self._submit_seq = 0                       # cluster submit ordinal
        # submit-stall buffer: (release_tick, was_fresh, withdrawn req)
        self._stalled: List[Tuple[float, bool, PendingRequest]] = []
        # transient-handoff backoff: session → (attempts, retry_tick)
        self._handoff_backoff: Dict[int, Tuple[int, int]] = {}
        self._no_migrate: set = set()              # gave up: stay home
        self._degraded_until: Dict[int, int] = {}  # engine → heal tick
        self.crashes = 0
        self.recovered_sessions = 0
        self.rerouted_requests = 0
        self.handoff_retries = 0
        self.handoff_giveups = 0
        self.stalled_requests = 0
        for i, lp in enumerate(self.loops):
            lp.engine_id = i
            if faults is not None:
                lp.faults = faults

    # ------------------------------------------------------------- state
    def views(self) -> List[EngineView]:
        out = []
        for i, lp in enumerate(self.loops):
            eng = lp.engine
            free = (eng.arena.free_pages if eng._paged
                    else eng.arena.free_slots)
            health = self.health[i]
            if health != "dead" and \
                    self._degraded_until.get(i, 0) > self._tick:
                health = "degraded"
            out.append(EngineView(
                engine_id=i, role=self.roles[i],
                alive=health != "dead", health=health,
                queue_len=lp.policy.queue_len(),
                backlog_tokens=lp.policy.backlog_tokens(),
                active_decodes=len(lp.active_decodes),
                free_slots=free))
        return out

    def alive_engines(self) -> List[int]:
        return [i for i, h in enumerate(self.health) if h != "dead"]

    def engine_of(self, session: int) -> Optional[int]:
        return self._home.get(session)

    def generated(self, session: int) -> List[int]:
        home = self._home.get(session)
        if home is None:
            return []
        return self.loops[home].generated.get(session, [])

    # ------------------------------------------------------------ intake
    def submit(self, session: int, tokens: np.ndarray,
               decode_tokens: int = 0,
               deadline: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Route one turn.  A session's first turn is placed by the
        router; later turns pin to the home engine (that is where the
        cached KV lives — cross-engine reuse is exactly what
        migration/handoff is for, not re-routing)."""
        idx = self._submit_seq
        self._submit_seq += 1
        eid = self._home.get(session)
        fresh = eid is None
        if not fresh and self.health[eid] == "dead":
            # the home engine died and nothing of the session survived
            # to recover (else kill_engine re-homed it) — route fresh
            fresh = True
        meta = RouteRequest(new_tokens=len(tokens),
                            decode_tokens=decode_tokens, session=session)
        if fresh:
            eid = self.router.route(meta, self.views())
            self._home[session] = eid
        r = self.loops[eid].submit(session, tokens,
                                   decode_tokens=decode_tokens,
                                   deadline=deadline, sampling=sampling)
        if r.rejected:
            # §11 admission gate shed it — nothing landed on the engine
            if fresh:
                self._home.pop(session, None)
            return r
        # §11 injected submit stall: accepted, then withheld — pulled
        # back out of the loop and buffered until the release tick, when
        # it re-routes (original arrival preserved: the stall is charged
        # to the request's TTFT, not forgiven)
        stall = self.faults.submit_stall(idx) if self.faults is not None \
            else None
        if stall is not None:
            w = self.loops[eid].withdraw(r.rid)
            if w is not None:
                if fresh:
                    self._home.pop(session, None)
                self.stalled_requests += 1
                self._stalled.append((self._tick + stall, fresh, w))
                return r
        # a fresh SHORT parked on a prefill-role engine (spillover) is
        # a deflection candidate until it dispatches
        if (fresh and self.deflect_tokens is not None
                and self.roles[eid] == "prefill"
                and isinstance(self.router, LengthAwareRouter)
                and not self.router.is_long(meta)):
            self._deflectable[r.rid] = (eid, session)
        return r

    def close_session(self, session: int) -> None:
        home = self._home.pop(session, None)
        # purge deflection candidates for the closed session NOW — a
        # stale rid must not linger until a later sweep happens to
        # notice it is gone
        self._deflectable = {rid: (e, s)
                             for rid, (e, s) in self._deflectable.items()
                             if s != session}
        if home is not None and self.health[home] != "dead":
            self.loops[home].close_session(session)

    # --------------------------------------------------------- deflection
    def _maybe_deflect(self) -> None:
        """Bounce spilled shorts off prefill engines that turned busy.

        A deflected request leaves the bouncing engine exactly as if it
        had never been submitted there (ServeLoop.withdraw) and goes
        back through the router with that engine excluded; its original
        arrival timestamp is preserved so TTFT/SLO accounting charges
        the detour to the request, not to the clock."""
        if self.deflect_tokens is None or not self._deflectable:
            return
        for rid, (eid, _sess) in list(self._deflectable.items()):
            lp = self.loops[eid]
            pr = lp._tokens.get(rid)
            if pr is None or pr.req.dispatch_time is not None:
                self._deflectable.pop(rid, None)   # served or gone
                continue
            if lp.policy.backlog_tokens() - pr.req.new_tokens \
                    <= self.deflect_tokens:
                continue                           # engine still quiet
            w = lp.withdraw(rid)
            self._deflectable.pop(rid, None)
            if w is None:
                continue
            session = w.req.session
            self._home.pop(session, None)
            tokens = w.prompt if w.prompt is not None else w.tokens
            meta = RouteRequest(new_tokens=len(tokens),
                                decode_tokens=w.decode_tokens,
                                session=session)
            new_eid = self.router.route(meta, self.views(),
                                        exclude=frozenset({eid}))
            self._home[session] = new_eid
            r2 = self.loops[new_eid].submit(
                session, tokens, decode_tokens=w.decode_tokens,
                deadline=w.req.deadline, sampling=w.sampling)
            r2.arrival = w.req.arrival
            self.deflections += 1

    # ---------------------------------------------------------- migration
    def _migratable(self, lp: ServeLoop, session: int) -> bool:
        # only sessions that are PURELY decoding move: no queued turn
        # (its prefill belongs where it was routed) — and the engine
        # pair must support handoff at all
        return not any(p.req.session == session
                       for p in lp._tokens.values())

    def _maybe_migrate(self) -> None:
        """Move decode-phase sessions off prefill-role engines.

        In spatial mode a prefill engine exists to run long prefills
        back to back; a session that finished its prefill there would
        otherwise pin a slot and steal tick time for its decode steps.
        Export → import moves its KV device-to-device to the least
        decode-loaded non-prefill engine, the loop bookkeeping follows,
        and the source slot frees."""
        if not self.migrate:
            return
        dsts = [i for i, role in enumerate(self.roles)
                if role != "prefill" and self.health[i] != "dead"]
        if not dsts:
            return
        for src, lp in enumerate(self.loops):
            if self.roles[src] != "prefill" or self.health[src] == "dead":
                continue
            for session in list(lp.active_decodes):
                if session in self._no_migrate:
                    continue
                attempts, retry_at = self._handoff_backoff.get(
                    session, (0, 0))
                if retry_at > self._tick:
                    continue                 # still backing off
                if not self._migratable(lp, session):
                    continue
                if not self._worth_migrating(lp, session):
                    continue
                dst = min(dsts, key=lambda i: (
                    len(self.loops[i].active_decodes),
                    self.loops[i].policy.backlog_tokens(), i))
                if self.faults is not None and \
                        self.faults.handoff_fails(src, self._tick):
                    # §11 transient export/import failure: retry with
                    # exponential backoff; after max attempts keep the
                    # session home (decoding in place beats flapping)
                    self._on_handoff_failure(src, session, attempts)
                    continue
                self._handoff_backoff.pop(session, None)
                self._migrate_session(src, dst, session)

    def _worth_migrating(self, lp: ServeLoop, session: int) -> bool:
        """§11 cost/benefit gate (replaces the greedy always-migrate
        trigger): moving the session pays CostModel.handoff_time for its
        cached context; each decode token it would otherwise run on the
        prefill engine costs roughly one fused stream row (β + w_tok +
        decode_per_seq) of tick time stolen from long chunks.  Migrate
        only when the remaining budget's saving beats the copy —
        ``migrate_decodes=True`` restores the old unconditional move."""
        if self._migrate_override is True:
            return True
        remaining = lp.active_decodes.get(session, 0)
        gain = remaining * (self.cost.beta + self.cost.w_tok
                            + self.cost.decode_per_seq)
        return gain > self.cost.handoff_time(lp.engine.history(session))

    def _on_handoff_failure(self, src: int, session: int,
                            attempts: int) -> None:
        attempts += 1
        self.handoff_retries += 1
        self._degraded_until[src] = self._tick + self.degrade_ticks
        if attempts >= self.max_handoff_attempts:
            self._no_migrate.add(session)
            self._handoff_backoff.pop(session, None)
            self.handoff_giveups += 1
        else:
            self._handoff_backoff[session] = (
                attempts, self._tick + 2 ** attempts)

    def _migrate_session(self, src: int, dst: int, session: int) -> None:
        a, b = self.loops[src], self.loops[dst]
        payload = a.engine.export_session(session)
        b.engine.import_session(session, payload)
        # decode bookkeeping moves with the KV
        b.active_decodes[session] = a.active_decodes.pop(session)
        for d_src, d_dst in ((a.last_token, b.last_token),
                             (a.generated, b.generated),
                             (a.first_tokens, b.first_tokens),
                             (a._last_emit, b._last_emit),
                             (a._cache_tokens, b._cache_tokens),
                             (a._cache_pending, b._cache_pending)):
            if session in d_src:
                d_dst[session] = d_src.pop(session)
        if session in a._session_pending:
            b._session_pending[session] = a._session_pending.pop(session)
        a.engine.close_session(session)
        self._home[session] = dst
        self.migrated_sessions += 1

    # ---------------------------------------------------------- failover
    def kill_engine(self, eid: int) -> None:
        """§11 engine death.  Evacuate everything the dead engine held,
        then refuse it forever: queued requests withdraw and re-route
        through the router (dead engine excluded via its view), and
        in-flight sessions are re-prefill-reconstructed on survivors
        from the loop's recovery transcript — greedy sessions continue
        bit-identically to a fault-free run.  With no survivors the
        queued requests are recorded as abandoned, never silently lost."""
        if self.health[eid] == "dead":
            return
        lp = self.loops[eid]
        self.health[eid] = "dead"
        self.crashes += 1
        self._deflectable = {rid: (e, s)
                             for rid, (e, s) in self._deflectable.items()
                             if e != eid}
        survivors = [i for i in self.alive_engines() if i != eid]
        # 1) pull every queued (or mid-chunk) request back out
        queued: List[PendingRequest] = []
        for rid, pr in list(lp._tokens.items()):
            w = lp.withdraw(rid)
            if w is None:
                # already dispatching (a long mid-chunk): its partial KV
                # died with the arena — restart the turn from scratch
                lp.policy.purge(lambda q, _rid=rid: q.rid == _rid)
                lp._tokens.pop(rid, None)
                lp._outstanding -= 1
                pr.req.dispatch_time = None
                w = pr
            queued.append(w)
        # 2) recover sessions with committed cache on a survivor
        for session in [s for s, h in list(self._home.items()) if h == eid]:
            if not survivors or not lp._cache_tokens.get(session):
                self._home.pop(session, None)
                continue
            self._recover_session(eid, session)
        # 3) re-route the evacuated requests (recovered sessions pin to
        # their new home — their cache lives there now)
        for w in queued:
            if not survivors:
                lp.tracker.note_abandoned(w.req)
                continue
            session = w.req.session
            home = self._home.get(session)
            if home is None or self.health[home] == "dead":
                tokens = w.prompt if w.prompt is not None else w.tokens
                meta = RouteRequest(new_tokens=len(tokens),
                                    decode_tokens=w.decode_tokens,
                                    session=session)
                home = self.router.route(meta, self.views())
                self._home[session] = home
            self._resubmit(home, w)
            self.rerouted_requests += 1
            self.loops[home].tracker.note_retried()
        # 4) scrub the dead loop so has_work goes quiet, and make any
        # future dispatch attempt on the dead engine an error
        lp.policy.drain()
        lp._tokens.clear()
        lp._outstanding = 0
        lp.active_decodes.clear()
        lp.engine.mark_dead()

    def _resubmit(self, eid: int, w: PendingRequest) -> Request:
        tokens = w.prompt if w.prompt is not None else w.tokens
        r2 = self.loops[eid].submit(
            w.req.session, tokens, decode_tokens=w.decode_tokens,
            deadline=w.req.deadline, sampling=w.sampling)
        r2.arrival = w.req.arrival     # the detour stays on its TTFT bill
        return r2

    def _recover_session(self, src: int, session: int) -> None:
        """Re-prefill reconstruction (§11): replay the dead engine's
        exact cache token sequence on a router-chosen survivor and
        resume decoding from the recorded pending token."""
        lp = self.loops[src]
        cache = list(lp._cache_tokens.get(session, []))
        budget = lp.active_decodes.get(session, 0)
        meta = RouteRequest(new_tokens=len(cache), decode_tokens=budget,
                            session=session)
        dst = self.router.route(meta, self.views())
        self.loops[dst].restore_session(
            session, cache,
            pending=lp._cache_pending.get(session),
            generated=list(lp.generated.get(session, [])),
            budget=budget,
            sampling=lp.engine.sampling.get(session),
            first_token=lp.first_tokens.get(session))
        self._home[session] = dst
        self.recovered_sessions += 1

    def _release_stalled(self) -> None:
        if not self._stalled:
            return
        due = [s for s in self._stalled if s[0] <= self._tick]
        if not due:
            return
        self._stalled = [s for s in self._stalled if s[0] > self._tick]
        for _, fresh, w in due:
            session = w.req.session
            eid = self._home.get(session)
            if eid is None or self.health[eid] == "dead":
                tokens = w.prompt if w.prompt is not None else w.tokens
                meta = RouteRequest(new_tokens=len(tokens),
                                    decode_tokens=w.decode_tokens,
                                    session=session)
                eid = self.router.route(meta, self.views())
                self._home[session] = eid
            self._resubmit(eid, w)
            self.loops[eid].tracker.note_retried()

    # --------------------------------------------------------------- run
    @property
    def has_work(self) -> bool:
        return bool(self._stalled) or any(
            lp.has_work for i, lp in enumerate(self.loops)
            if self.health[i] != "dead")

    def run_until_idle(self, max_wall: float = 60.0) -> None:
        """Interleave every live loop's unified tick until the whole
        cluster drains.  Per tick: fire matured fault-plan events
        (engine crashes), release stalled submits, deflect, tick, then
        migrate (a prefill that just finished starts decoding elsewhere
        next tick).  If ``max_wall`` expires first every still-queued
        request — including buffered stalls — is recorded as abandoned
        rather than silently dropped."""
        clock = self.loops[0].clock
        start = clock()
        while self.has_work and clock() - start < max_wall:
            self._tick += 1
            if self.faults is not None:
                for eid in self.faults.crashes_due(self._tick):
                    if 0 <= eid < len(self.loops) and \
                            len(self.alive_engines()) > 1:
                        self.kill_engine(eid)
            self._release_stalled()
            self._maybe_deflect()
            did_any = False
            for i, lp in enumerate(self.loops):
                if self.health[i] == "dead" or not lp.has_work:
                    continue
                did, _ = lp.tick()
                did_any = did_any or did
            self._maybe_migrate()
            if not did_any:
                time.sleep(0.0005)
        if self.has_work:      # max_wall expired with work still queued
            for i, lp in enumerate(self.loops):
                if self.health[i] != "dead" and lp._outstanding > 0:
                    lp.abandon_pending()
            for _, _, w in self._stalled:
                self.loops[0].tracker.note_abandoned(w.req)
            self._stalled = []

    # ------------------------------------------------------------ reports
    def report(self, horizon: Optional[float] = None) -> SLOReport:
        return SLOTracker.merged(
            [lp.tracker for lp in self.loops]).report(horizon)

    def stats(self) -> Dict:
        per_engine = [lp.engine.stats() for lp in self.loops]
        merged = SLOTracker.merged([lp.tracker for lp in self.loops])
        return {
            "engines": len(self.loops),
            "roles": list(self.roles),
            "router": self.router.name,
            "health": list(self.health),
            "deflections": self.deflections,
            "migrated_sessions": self.migrated_sessions,
            # §11 fault tolerance + admission control
            "crashes": self.crashes,
            "recovered_sessions": self.recovered_sessions,
            "rerouted_requests": self.rerouted_requests,
            "handoff_retries": self.handoff_retries,
            "handoff_giveups": self.handoff_giveups,
            "stalled_requests": self.stalled_requests,
            "dispatch_faults": sum(lp.dispatch_faults for lp in self.loops),
            "rejected": merged.rejected,
            "retried": merged.retried,
            "abandoned": merged.abandoned,
            "handoff_sessions": sum(s["handoff_sessions"]
                                    for s in per_engine),
            "handoff_tokens": sum(s["handoff_tokens"] for s in per_engine),
            "handoff_host_bytes": sum(s["handoff_host_bytes"]
                                      for s in per_engine),
            "tokens_drafted": sum(s["tokens_drafted"] for s in per_engine),
            "tokens_accepted": sum(s["tokens_accepted"]
                                   for s in per_engine),
            "spec_dispatches": sum(s["spec_dispatches"]
                                   for s in per_engine),
            "per_engine": per_engine,
        }
