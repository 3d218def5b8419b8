"""Fault tolerance of the port's cluster against the JAX package's: the
4-engine failover of ``benchmarks/bench_faults.py`` (``_engine_failover``,
copied here with its seeds; ``BENCH_faults.json``'s ``engine/failover``
row exactly), then admission, the bounded queue, wall expiry, the
migration gate, dispatch-fault retry, handoff backoff and give-up, stall
release, a dead engine refusing dispatch and re-prefill recovery after
``kill_engine``, each on both packages with the same transcripts and
counters.  Last, the port's own chaos property: a seed-random fault plan
over a seed-random request mix on a 3-engine paged cluster never loses
a request and keeps greedy transcripts bit-identical to a fault-free
replay.  Unlike the reference's ``test_chaos_property`` it asserts a
crash only when the plan's crash tick comes before the fault-free run
drains (ROADMAP Queue 3), and it pins seed=1, where the reference's
fails on the wall clock, as an explicit example.

Every loop runs on a stepping clock with ``measure=False``.
"""
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
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.sim import costmodel as jcost  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sim import costmodel as tcost  # noqa: E402

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
            self.faults, self.cost = jfaults, jcost
        else:
            self.core, self.serving = tcore, tserving
            self.faults, self.cost = tfaults, tcost
            self.params = params_from_numpy(jax.tree.map(np.asarray, params),
                                            tget("qwen3-4b"), "cpu")

    def engine(self, **kw):
        ecfg = self.serving.EngineConfig(measure=False, **kw)
        if self.name == "jax":
            return self.serving.Engine(self.cfg, self.params, ecfg)
        return self.serving.Engine(tget("qwen3-4b"), self.params, ecfg,
                                   device="cpu")

    def loop(self, pool=None, ecfg=None, **loop_kw):
        """A loop over a fresh engine: PoolPolicy(``pool``) or, with no
        pool, the pla_full policy."""
        eng = self.engine(**(ecfg or ECFG))
        c = self.core
        pol = (c.PoolPolicy(c.H200_QWEN32B, pool=pool, threshold=24,
                            chunk_tokens=16) if pool is not None else
               c.make_policy(c.Variant("pla_full"), c.H200_QWEN32B,
                             threshold=24, chunk_tokens=16))
        return self.serving.ServeLoop(eng, pol, slo_ttft=30.0,
                                      clock=_stepping_clock(), **loop_kw)

    def cluster(self, n=2, paged=False, **kw):
        ecfg = dict(ECFG, paged_kv=paged)
        return self.serving.ServeCluster(
            [self.loop(ecfg=ecfg) for _ in range(n)],
            self.core.RoundRobinRouter(), **kw)

    def spatial(self, **kw):
        return self.serving.ServeCluster(
            [self.loop(pool) for pool in ("long", "short")],
            self.core.LengthAwareRouter(threshold=24),
            roles=["prefill", "decode"], **kw)


ECFG = dict(num_slots=4, max_len=96, chunk_tokens=16, paged_kv=False,
            page_size=8)
_SIDES = {}


def side(name, key=31):
    if (name, key) not in _SIDES:
        _SIDES[(name, key)] = Side(name, key)
    return _SIDES[(name, key)]


def both(fn, *args):
    """``fn`` on the port and on the reference: the same result."""
    got = fn(side("torch"), *args)
    assert got == fn(side("jax"), *args)
    return got


def _cluster_state(cluster, sessions):
    st = cluster.stats()
    return dict(stats={k: v for k, v in st.items() if k != "per_engine"},
                report=cluster.report().as_dict(),
                generated={s: cluster.generated(s) for s in sessions},
                homes={s: cluster.engine_of(s) for s in sessions})


# ------------------------------------------- bench_faults._engine_failover
N_ENGINES, VICTIM, N_SESSIONS, DECODE_TOKENS = 4, 1, 8, 6


def _engine_failover(sd, baseline=True):
    """Kill 1 of 4 engines mid-drain and compare against an identical
    fault-free cluster (``benchmarks/bench_faults.py``); without
    ``baseline`` only the faulted cluster runs (its row then holds no
    ``bit_identical``)."""
    ecfg = dict(num_slots=8, max_len=160, chunk_tokens=16, paged_kv=True,
                page_size=8)

    def build(faults):
        return sd.serving.ServeCluster(
            [sd.loop(ecfg=ecfg) for _ in range(N_ENGINES)],
            sd.core.RoundRobinRouter(), faults=faults)

    rng = np.random.default_rng(11)
    subs = [(s, rng.integers(0, sd.cfg.vocab_size,
                             40 if s % 3 == 0 else int(rng.integers(5, 16))),
             DECODE_TOKENS)
            for s in range(N_SESSIONS)]
    want = None
    if baseline:
        clean = build(None)
        for s, toks, d in subs:
            clean.submit(s, toks, decode_tokens=d)
        clean.run_until_idle(max_wall=1e6)
        want = {s: list(clean.generated(s)) for s, _, _ in subs}

    plan = sd.faults.FaultPlan(events=(sd.faults.FaultEvent(
        sd.faults.CRASH, at=1.0, engine=VICTIM),))
    cluster = build(sd.faults.FaultInjector(plan))
    for s, toks, d in subs:
        cluster.submit(s, toks, decode_tokens=d)
    for _ in range(600):
        if cluster.loops[VICTIM].active_decodes:
            break
        for lp in cluster.loops:
            if lp.has_work:
                lp.tick()
    assert cluster.loops[VICTIM].active_decodes, \
        "victim engine never reached its decode phase"
    cluster.run_until_idle(max_wall=1e6)
    rep = cluster.report()
    st = cluster.stats()
    for i in cluster.alive_engines():
        cluster.loops[i].engine.arena.audit()
    row = {
        "n_submitted": N_SESSIONS,
        "n_finished": rep.n,
        "lost": N_SESSIONS - rep.n - rep.rejected - rep.abandoned,
        "crashes": st["crashes"],
        "recovered_sessions": st["recovered_sessions"],
        "rerouted_requests": st["rerouted_requests"],
        "abandoned": rep.abandoned,
        "bit_identical": want and int(all(
            cluster.generated(s) == want[s] for s, _, _ in subs)),
        "transcripts_complete": int(all(
            len(cluster.generated(s)) == d + 1 for s, _, d in subs)),
        "health": st["health"],
    }
    return row, _cluster_state(cluster, range(N_SESSIONS))


def test_bench_faults_engine_failover():
    """One of four engines dies mid-decode: nothing is lost, its
    in-flight sessions recover by re-prefill on survivors, and every
    greedy transcript is the fault-free cluster's — the committed row,
    and the JAX cluster's transcripts and stats."""
    row, got = _engine_failover(side("torch", 19))
    _, want = _engine_failover(side("jax", 19), baseline=False)
    assert got == want
    bench = {r["tag"]: r for r in json.loads(
        (ROOT / "BENCH_faults.json").read_text())}["engine/failover"]
    assert row == {k: bench[k] for k in row}


# ------------------------------------------------------- loop-level seams
def _admission(sd):
    loop = sd.loop(admission=sd.cost.H200_32B)
    rng = np.random.default_rng(0)
    vocab = sd.cfg.vocab_size
    r = loop.submit(0, rng.integers(0, vocab, 8), deadline=0.0)
    out = [r.rejected, loop.policy.queue_len(), loop._outstanding,
           loop.engine.history(0), loop.tracker.report().rejected]
    r2 = loop.submit(0, rng.integers(0, vocab, 8), decode_tokens=2)
    loop.run_until_idle(max_wall=1e6)
    return out + [r2.rejected, loop.generated[0]]


def test_admission_rejects_doomed_submit():
    got = both(_admission)
    assert got[:5] == [True, 0, 0, 0, 1] and not got[5]
    assert len(got[6]) == 3


def _bounded(sd):
    loop = sd.loop(max_queue=1)
    rng = np.random.default_rng(1)
    r1 = loop.submit(0, rng.integers(0, sd.cfg.vocab_size, 6))
    r2 = loop.submit(1, rng.integers(0, sd.cfg.vocab_size, 6))
    out = [r1.rejected, r2.rejected, loop.tracker.rejected]
    loop.run_until_idle(max_wall=1e6)
    return out + [loop.engine.history(1), loop.generated]


def test_bounded_queue_rejects_overflow():
    got = both(_bounded)
    assert got[:4] == [False, True, 1, 0]


def _expiry(sd):
    loop = sd.loop()
    rng = np.random.default_rng(2)
    loop.submit(0, rng.integers(0, sd.cfg.vocab_size, 6))
    loop.submit(1, rng.integers(0, sd.cfg.vocab_size, 6))
    loop.run_until_idle(max_wall=0.0)
    rep = loop.tracker.report()
    return [rep.abandoned, rep.n, rep.violation_rate, loop._outstanding,
            loop.has_work]


def test_run_until_idle_abandons_on_wall_expiry():
    assert both(_expiry) == [2, 0, 1.0, 0, False]


def _dispatch_faults(sd):
    loop = sd.loop()
    loop.faults = sd.faults.FaultInjector(sd.faults.FaultPlan(events=(
        sd.faults.FaultEvent(sd.faults.DISPATCH, at=0.0, engine=0,
                             count=2),)))
    rng = np.random.default_rng(5)
    for s in (0, 1):
        loop.submit(s, rng.integers(0, sd.cfg.vocab_size, 6),
                    decode_tokens=2)
    loop.run_until_idle(max_wall=1e6)
    return [loop.dispatch_faults, loop.tracker.retried, loop.generated]


def test_dispatch_fault_retries_work():
    got = both(_dispatch_faults)
    assert got[0] == 2 and got[1] >= 2
    assert all(len(got[2][s]) == 3 for s in (0, 1))


# --------------------------------------------------------- cluster seams
def _gate(sd):
    """The migration gate: tiny decode budgets stay home, big ones move,
    ``migrate_decodes`` forces either way."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, sd.cfg.vocab_size, 40)
    out = []
    for kw, budget in (({}, 2), ({}, 8), ({"migrate_decodes": True}, 2),
                       ({"migrate_decodes": False}, 8)):
        cluster = sd.spatial(**kw)
        cluster.submit(0, prompt, decode_tokens=budget)
        cluster.run_until_idle(max_wall=1e6)
        out.append((cluster.migrated_sessions, cluster.generated(0)))
    return out


def test_migration_cost_benefit_gate():
    got = both(_gate)
    assert [m for m, _ in got] == [0, 1, 1, 0]
    assert [len(g) for _, g in got] == [3, 9, 3, 9]


def _backoff(sd):
    inj = sd.faults.FaultInjector(sd.faults.FaultPlan(events=(
        sd.faults.FaultEvent(sd.faults.HANDOFF, at=0.0, engine=0,
                             count=99),)))
    cluster = sd.spatial(migrate_decodes=True, faults=inj,
                         max_handoff_attempts=3)
    rng = np.random.default_rng(6)
    cluster.submit(0, rng.integers(0, sd.cfg.vocab_size, 40),
                   decode_tokens=20)
    cluster.run_until_idle(max_wall=1e6)
    return _cluster_state(cluster, [0])


def test_transient_handoff_backoff_and_giveup():
    """Every handoff from engine 0 fails: the cluster backs off, gives
    up after three attempts, and the session decodes at home."""
    got = both(_backoff)
    st = got["stats"]
    assert st["handoff_retries"] == 3 and st["handoff_giveups"] == 1
    assert st["migrated_sessions"] == 0 and got["homes"][0] == 0
    assert len(got["generated"][0]) == 21


def _stall(sd):
    inj = sd.faults.FaultInjector(sd.faults.FaultPlan(events=(
        sd.faults.FaultEvent(sd.faults.STALL, at=0.0, duration=2.0),)))
    cluster = sd.cluster(n=2, faults=inj)
    rng = np.random.default_rng(7)
    r = cluster.submit(0, rng.integers(0, sd.cfg.vocab_size, 8),
                       decode_tokens=2)
    held = [r.rejected, len(cluster._stalled), cluster.engine_of(0)]
    cluster.run_until_idle(max_wall=1e6)
    return held, _cluster_state(cluster, [0])


def test_submit_stall_released_and_served():
    held, got = both(_stall)
    assert held == [False, 1, None]
    assert got["stats"]["stalled_requests"] == 1
    assert got["stats"]["retried"] >= 1
    assert len(got["generated"][0]) == 3


def _dead(sd):
    """A dead engine refuses every dispatch and both handoff ends."""
    eng = sd.engine(**ECFG)
    eng.prefill_batch([0], [np.arange(5) % sd.cfg.vocab_size])
    eng.mark_dead()
    refused = []
    for call in (lambda: eng.export_session(0),
                 lambda: eng.prefill_batch([1], [np.arange(4)]),
                 lambda: eng.step_mixed([(1, np.arange(4))], []),
                 lambda: eng.decode_batch([0], [1], 1),
                 lambda: eng.import_session(2, None)):
        with pytest.raises(RuntimeError, match="dead"):
            call()
        refused.append(True)
    return refused + [eng.history(0)]


def test_dead_engine_refuses_dispatch():
    assert both(_dead) == [True] * 5 + [5]


def _kill(sd, paged, baseline=True):
    rng = np.random.default_rng(8)
    subs = [(s, rng.integers(0, sd.cfg.vocab_size,
                             36 if s % 2 == 0 else 7), 6) for s in range(4)]
    want = None
    if baseline:
        clean = sd.cluster(n=2, paged=paged)
        for s, toks, d in subs:
            clean.submit(s, toks, decode_tokens=d)
        clean.run_until_idle(max_wall=1e6)
        want = {s: list(clean.generated(s)) for s, _, _ in subs}
    cluster = sd.cluster(n=2, paged=paged)
    for s, toks, d in subs:
        cluster.submit(s, toks, decode_tokens=d)
    for _ in range(400):
        if cluster.loops[0].active_decodes:
            break
        cluster._tick += 1
        for lp in cluster.loops:
            if lp.has_work:
                lp.tick()
    assert cluster.loops[0].active_decodes, "never reached decode phase"
    cluster.kill_engine(0)
    cluster.run_until_idle(max_wall=1e6)
    if paged:
        cluster.loops[1].engine.arena.audit()
    return want, _cluster_state(cluster, range(4))


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_kill_engine_recovers_bit_identical(paged):
    """Kill an engine mid-decode: queued requests re-route, in-flight
    sessions re-prefill on the survivor, and every greedy transcript is
    the fault-free run's (the JAX cluster's faulted run gives the same
    transcripts, stats and report)."""
    want, got = _kill(side("torch"), paged)
    assert got == _kill(side("jax"), paged, baseline=False)[1]
    st = got["stats"]
    assert st["crashes"] == 1 and st["recovered_sessions"] >= 1
    assert st["health"] == ["dead", "healthy"]
    assert got["report"]["n"] == 4
    assert got["report"]["recovered_sessions"] == st["recovered_sessions"]
    assert got["generated"] == want
    assert set(got["homes"].values()) == {1}


# ---------------------------------------------------------- chaos property
def _chaos_case(seed):
    """One chaos example on the port: a random request mix on a 3-engine
    paged cluster under ``FaultPlan.random(seed)`` against a fault-free
    replay."""
    sd = side("torch")
    rng = np.random.default_rng(seed)
    n_sessions = int(rng.integers(3, 6))
    subs = [(s, rng.integers(0, sd.cfg.vocab_size, int(rng.integers(4, 40))),
             int(rng.integers(1, 7)))
            for s in range(n_sessions)]

    def run(faults):
        cluster = sd.cluster(n=3, paged=True, faults=faults)
        for s, toks, d in subs:
            cluster.submit(s, toks, decode_tokens=d)
        cluster.run_until_idle(max_wall=1e6)
        return cluster

    base = run(None)
    want = {s: list(base.generated(s)) for s, _, _ in subs}
    plan = tfaults.FaultPlan.random(seed, n_engines=3, horizon=12.0)
    chaos = run(tfaults.FaultInjector(plan))
    rep = chaos.report()
    assert rep.n + rep.rejected + rep.abandoned == n_sessions, \
        (plan, rep.n, rep.rejected, rep.abandoned)
    assert rep.abandoned == 0 and rep.rejected == 0
    for s, _, d in subs:
        assert chaos.generated(s) == want[s], (s, plan)
        assert len(chaos.generated(s)) == d + 1
    for i in chaos.alive_engines():
        chaos.loops[i].engine.arena.audit()
    crash = [ev.at for ev in plan.events if ev.kind == tfaults.CRASH]
    # a crash fires at the first cluster tick at or past its time: the
    # faults only delay the drain, so one planned before the fault-free
    # run drains must fire, and one past the chaos run's drain cannot
    if crash and crash[0] <= base._tick:
        assert chaos.stats()["crashes"] == 1, (plan, base._tick)
    assert chaos.stats()["crashes"] == int(bool(crash)
                                           and crash[0] <= chaos._tick)
    return plan, base._tick, chaos.stats()["crashes"]


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
@example(seed=1)
def test_chaos_property(seed):
    _chaos_case(seed)


def test_chaos_seed_1_recovers_from_its_crash():
    """The seed the reference's chaos test fails at: its plan crashes an
    engine at tick 8.  On the stepping clock the fault-free cluster
    drains at a later tick, so the crash fires here, and the recovered
    transcripts still match the fault-free ones (asserted in the case)."""
    plan, drain, crashes = _chaos_case(1)
    crash = [ev.at for ev in plan.events if ev.kind == tfaults.CRASH]
    assert crash == [8.0] and drain > 8 and crashes == 1
