"""The port's multi-engine cluster against the JAX package's: the routers
and ``FaultPlan.random`` on the same inputs, arena-to-arena session
handoff on the slot arena and the page pool (the next decode's logits,
the freed source, the destination's prefix dedupe), deflection and home
pinning, and the real-engine scenario of ``benchmarks/bench_slo.py``
(``_engine_cluster``, copied here with its seeds), which must give the
JAX cluster's transcripts and stats and ``BENCH_cluster.json``'s
``engine/slot`` and ``engine/paged`` rows.

Every loop of both packages runs on the same stepping clock with
``measure=False``, so wall time feeds neither a decision nor a TTFT.
"""
import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


class Side:
    """One package's engines, loops and clusters on the weights of
    ``jax.random.key(key)`` (the port's converted from the JAX tree)."""

    def __init__(self, name, key):
        self.name = name
        self.cfg = get_smoke("qwen3-4b")
        params, _ = jtr.init_params(self.cfg, jax.random.key(key))
        if name == "jax":
            self.core, self.serving, self.params = jcore, jserving, params
        else:
            self.core, self.serving = tcore, tserving
            self.params = params_from_numpy(jax.tree.map(np.asarray, params),
                                            tget("qwen3-4b"), "cpu")

    def engine(self, **kw):
        ecfg = self.serving.EngineConfig(measure=False, **kw)
        if self.name == "jax":
            return self.serving.Engine(self.cfg, self.params, ecfg)
        return self.serving.Engine(tget("qwen3-4b"), self.params, ecfg,
                                   device="cpu")

    def loop(self, pool=None, **kw):
        """A loop over a fresh engine: PoolPolicy(``pool``) or, with no
        pool, the pla_full policy."""
        eng = self.engine(**kw)
        c = self.core
        pol = (c.PoolPolicy(c.H200_QWEN32B, pool=pool, threshold=24,
                            chunk_tokens=16) if pool is not None else
               c.make_policy(c.Variant("pla_full"), c.H200_QWEN32B,
                             threshold=24, chunk_tokens=16))
        return self.serving.ServeLoop(eng, pol, slo_ttft=30.0,
                                      clock=_stepping_clock())


_SIDES = {}


def side(name, key):
    if (name, key) not in _SIDES:
        _SIDES[(name, key)] = Side(name, key)
    return _SIDES[(name, key)]


# ------------------------------------------------------------- routers
def _random_views(rng, core):
    n = int(rng.integers(1, 6))
    views = []
    for i in range(n):
        views.append(core.EngineView(
            engine_id=i,
            role=str(rng.choice(["prefill", "decode", "general"])),
            alive=bool(rng.random() > 0.15),
            health=str(rng.choice(["healthy", "healthy", "degraded",
                                   "dead"])),
            queue_len=int(rng.integers(0, 4)),
            backlog_tokens=int(rng.choice([0, 0, 10, 90, 300])),
            active_decodes=int(rng.integers(0, 5)),
            free_slots=int(rng.integers(0, 8))))
    return views


def _route_all(core, seed):
    rng = np.random.default_rng(seed)
    routers = [core.RoundRobinRouter(), core.LeastLoadedRouter(),
               core.LengthAwareRouter(threshold=256),
               core.LengthAwareRouter(threshold=64, spill_tokens=50),
               core.make_router("spatial", threshold=128, spill_tokens=0)]
    out = []
    for _ in range(60):
        views = _random_views(rng, core)
        req = core.RouteRequest(new_tokens=int(rng.integers(1, 600)),
                                decode_tokens=int(rng.integers(0, 9)))
        exclude = frozenset(int(e) for e in
                            rng.integers(0, len(views), rng.integers(0, 3)))
        for r in routers:
            try:
                out.append(r.route(req, views, exclude=exclude))
            except RuntimeError as e:
                out.append(str(e))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_routers_and_fault_plans_match_reference(seed):
    """The port's routers take the reference's placements over random
    cluster snapshots (dead, degraded and excluded engines included),
    and ``FaultPlan.random`` and the injector's answers are the
    reference's for the same seed."""
    got, want = _route_all(tcore, seed), _route_all(jcore, seed)
    assert got == want
    assert len(set(got)) > 2       # the snapshots vary the placement
    for n_engines, horizon in ((1, 64.0), (3, 12.0), (4, 30.0)):
        tp = tfaults.FaultPlan.random(seed, n_engines=n_engines,
                                      horizon=horizon)
        jp = jfaults.FaultPlan.random(seed, n_engines=n_engines,
                                      horizon=horizon)
        assert [dataclasses.asdict(e) for e in tp.events] == \
            [dataclasses.asdict(e) for e in jp.events]
        answers = []
        for mod, plan in ((tfaults, tp), (jfaults, jp)):
            inj = mod.FaultInjector(plan)
            seq = [inj.crashes_due(t) for t in range(int(horizon) + 1)]
            seq += [inj.handoff_fails(e, 5.0) for e in range(n_engines)]
            seq += [inj.dispatch_fails(e, float(t)) for e in
                    range(n_engines) for t in range(0, 40, 7)]
            seq += [inj.submit_stall(i) for i in range(8)]
            answers.append((seq, dict(inj.injected)))
        assert answers[0] == answers[1]


# ------------------------------------------------------------ handoff
def _ecfg(paged):
    return dict(num_slots=4, max_len=96, chunk_tokens=16, paged_kv=paged,
                page_size=8)


def _handoff(sd, paged, prompt, shared):
    """Prefill ``prompt`` on engine A, export it to engine B (which
    already serves ``shared`` under session 9, so a paged B holds the
    prompt's first pages), decode 4 tokens on both; then close A's
    session.  Returns the decodes, last logits and counters."""
    a, b = sd.engine(**_ecfg(paged)), sd.engine(**_ecfg(paged))
    b.prefill_batch([9], [shared])
    first = a.prefill_batch([0], [prompt])[0]
    payload = a.export_session(0)
    b.import_session(0, payload)
    assert b.history(0) == len(prompt)
    db = b.decode_batch([0], [first], steps=4)
    da = a.decode_batch([0], [first], steps=4)
    la = np.asarray(a.last_logits[0])
    a.close_session(0)
    st = b.stats()
    if paged:
        a.arena.audit()
        b.arena.audit()
        free = a.arena.free_pages + len(a.arena.index.pages())
        freed = free == a.arena.num_pages and not a.arena.pages_of(0)
    else:
        freed = a.arena.free_slots == a.ecfg.num_slots
    return dict(first=first, da=da, db=db, freed=freed,
                la=la, lb=np.asarray(b.last_logits[0]),
                counters={k: st[k] for k in (
                    "handoff_sessions", "handoff_tokens",
                    "handoff_host_bytes", "handoff_pages_deduped",
                    "prefix_hit_tokens")})


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_session_handoff_matches_reference(paged):
    """export_session -> import_session: the destination's next decode
    gives the source's own continuation and the JAX engines' (tokens
    exact, last logits within 1e-5), the source slot or pages free
    after close, and a paged destination that already holds the
    prompt's prefix adopts those pages (``handoff_pages_deduped``)."""
    rng = np.random.default_rng(6)
    sd = side("torch", 21)
    prompt = rng.integers(0, sd.cfg.vocab_size, 21)   # a partial page
    shared = np.concatenate([prompt[:17],
                             rng.integers(0, sd.cfg.vocab_size, 3)])
    got = _handoff(sd, paged, prompt, shared)
    want = _handoff(side("jax", 21), paged, prompt, shared)
    assert got["db"] == got["da"] == want["db"]
    assert got["first"] == want["first"]
    np.testing.assert_allclose(got["lb"], got["la"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["lb"], want["lb"], atol=1e-5, rtol=0)
    assert got["freed"] and want["freed"]
    assert got["counters"] == want["counters"]
    c = got["counters"]
    assert c["handoff_sessions"] == 1 and c["handoff_tokens"] == 21
    assert c["handoff_host_bytes"] == 0
    # 16 of the prompt's tokens sit on B's two full pages of session 9
    assert c["handoff_pages_deduped"] == (2 if paged else 0)


def test_export_is_a_snapshot():
    """A payload stays valid after the source frees the session and its
    slot is reused: the export copies, it does not alias the arena."""
    sd = side("torch", 21)
    rng = np.random.default_rng(7)
    for paged in (False, True):
        a, b = sd.engine(**_ecfg(paged)), sd.engine(**_ecfg(paged))
        p = rng.integers(0, sd.cfg.vocab_size, 9)
        first = a.prefill_batch([0], [p])[0]
        payload = a.export_session(0)
        a.close_session(0)
        a.prefill_batch([5], [rng.integers(0, sd.cfg.vocab_size, 9)])
        b.import_session(0, payload)
        one = sd.engine(**_ecfg(paged))
        f1 = one.prefill_batch([0], [p])[0]
        assert first == f1
        assert b.decode_batch([0], [first], 3) == \
            one.decode_batch([0], [f1], 3)


# ------------------------------------------------- deflection, pinning
def _deflection(sd):
    cluster = sd.serving.ServeCluster(
        [sd.loop("long", **_ecfg(False)), sd.loop("short", **_ecfg(False))],
        sd.core.LengthAwareRouter(threshold=24, spill_tokens=0),
        roles=["prefill", "decode"], deflect_backlog_tokens=8)
    rng = np.random.default_rng(8)
    vocab = sd.cfg.vocab_size
    cluster.submit(1, rng.integers(0, vocab, 6))
    spilled = cluster.submit(2, rng.integers(0, vocab, 5))
    trace = [cluster.engine_of(2), spilled.rid in cluster._deflectable]
    cluster._maybe_deflect()
    trace.append(cluster.deflections)
    cluster.submit(3, rng.integers(0, vocab, 40))
    cluster._maybe_deflect()
    trace += [cluster.deflections, cluster.engine_of(2),
              cluster.engine_of(3)]
    lp1 = cluster.loops[1]
    re_routed = [p.req for p in lp1._tokens.values() if p.req.session == 2]
    trace.append(re_routed[0].arrival == spilled.arrival)
    cluster.run_until_idle(max_wall=1e6)
    trace += [cluster.has_work, cluster.report(horizon=1.0).as_dict(),
              {s: cluster.generated(s) for s in (1, 2, 3)}]
    return trace


def test_deflection_matches_reference():
    """A short spilled onto the idle prefill engine is withdrawn and
    re-routed when a long lands behind it; its arrival survives."""
    got = _deflection(side("torch", 21))
    assert got == _deflection(side("jax", 21))
    assert got[:7] == [0, True, 0, 1, 1, 0, True]
    assert not got[7] and got[8]["n"] == 3


def _pinning(sd):
    cluster = sd.serving.ServeCluster(
        [sd.loop("short", **_ecfg(False)), sd.loop("short", **_ecfg(False))],
        sd.core.RoundRobinRouter())
    rng = np.random.default_rng(10)
    cluster.submit(0, rng.integers(0, sd.cfg.vocab_size, 6))
    home = cluster.engine_of(0)
    cluster.run_until_idle(max_wall=1e6)
    cluster.submit(0, rng.integers(0, sd.cfg.vocab_size, 5))
    out = [home, cluster.engine_of(0)]
    cluster.run_until_idle(max_wall=1e6)
    return out + [cluster.loops[home].engine.history(0),
                  cluster.generated(0)]


def test_later_turns_pin_to_home_as_reference():
    got = _pinning(side("torch", 21))
    assert got == _pinning(side("jax", 21))
    assert got[0] == got[1] and got[2] == 11


# -------------------------------------------- bench_slo._engine_cluster
def _engine_cluster(sd, paged):
    """``benchmarks/bench_slo.py::_engine_cluster``: a 2-engine cluster
    (prefill + decode roles) on the smoke model; the longs prefill on
    engine 0 and migrate to engine 1 to decode."""
    ecfg = dict(num_slots=8, max_len=160, chunk_tokens=16, paged_kv=paged,
                page_size=8)
    cluster = sd.serving.ServeCluster(
        [sd.loop("long", **ecfg), sd.loop("short", **ecfg)],
        sd.core.LengthAwareRouter(threshold=24), roles=["prefill", "decode"])
    rng = np.random.default_rng(5)
    n_sessions = 6
    for s in range(n_sessions):
        n = 40 if s % 3 == 0 else int(rng.integers(4, 16))
        cluster.submit(s, rng.integers(0, sd.cfg.vocab_size, n),
                       decode_tokens=4)
    cluster.run_until_idle(max_wall=1e6)
    rep = cluster.report()
    st = cluster.stats()
    row = {
        "n": rep.n,
        "generated_ok": int(all(
            len(cluster.generated(s)) == 5 for s in range(n_sessions))),
        "migrated_sessions": st["migrated_sessions"],
        "handoff_sessions": st["handoff_sessions"],
        "handoff_tokens": st["handoff_tokens"],
        "handoff_host_bytes": st["handoff_host_bytes"],
        "router": st["router"],
    }
    keep = {k: v for k, v in st.items() if k != "per_engine"}
    per_engine = [{k: e[k] for k in (
        "handoff_sessions", "handoff_tokens", "prefix_hit_tokens",
        "handoff_pages_deduped", "packed_dispatches", "decode_dispatches")}
        for e in st["per_engine"]]
    return row, dict(stats=keep, per_engine=per_engine,
                     report=rep.as_dict(),
                     generated={s: cluster.generated(s)
                                for s in range(n_sessions)},
                     homes=[cluster.engine_of(s) for s in range(n_sessions)])


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_bench_slo_engine_cluster(paged):
    """The port's cluster gives the JAX cluster's transcripts, homes,
    stats and SLO report, and both give the committed row."""
    row, got = _engine_cluster(side("torch", 7), paged)
    jrow, want = _engine_cluster(side("jax", 7), paged)
    assert got == want
    assert row == jrow
    tag = "engine/paged" if paged else "engine/slot"
    bench = {r["tag"]: r for r in json.loads(
        (ROOT / "BENCH_cluster.json").read_text())}[tag]
    assert row == {k: bench[k] for k in row}
    assert got["homes"] == [1] * 6       # both longs migrated to decode
