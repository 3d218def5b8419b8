"""The port's analytic modules (``core.controller``, ``core.queueing``,
``sim.workload``, ``sim.simulator``) against the JAX package's: the same
seeds and configurations through both, outputs equal exactly.

Each scenario is written once over a namespace of one package's modules
and run on both; what it returns (every finished request's fields, the
SLO report, the simulator's counters, the controller's decisions) must
be equal, floats bit for bit.  The scenarios are those of
``tests/test_sim.py``, ``test_controller.py`` and ``test_queueing.py``,
including the host spill tier's billing (``host_pool_pages > 0``,
``CostModel.swap_in_time``).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
import repro.core.awd as jawd  # noqa: E402
import repro.core.controller as jcontroller  # noqa: E402
import repro.core.queueing as jqueueing  # noqa: E402
import repro.core.request as jrequest  # noqa: E402
import repro.core.scheduler as jscheduler  # noqa: E402
import repro.data.synthetic as jsynthetic  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro.sim.workload as jworkload  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.awd as tawd  # noqa: E402
import repro_torch.core.controller as tcontroller  # noqa: E402
import repro_torch.core.queueing as tqueueing  # noqa: E402
import repro_torch.core.request as trequest  # noqa: E402
import repro_torch.core.scheduler as tscheduler  # noqa: E402
import repro_torch.data.synthetic as tsynthetic  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
import repro_torch.sim.workload as tworkload  # noqa: E402

JAX = types.SimpleNamespace(core=jcore, awd=jawd, controller=jcontroller,
                            queueing=jqueueing, request=jrequest,
                            scheduler=jscheduler, synthetic=jsynthetic,
                            sim=jsim, workload=jworkload)
PORT = types.SimpleNamespace(core=tcore, awd=tawd, controller=tcontroller,
                             queueing=tqueueing, request=trequest,
                             scheduler=tscheduler, synthetic=tsynthetic,
                             sim=tsim, workload=tworkload)

# Request fields compared (``rid`` comes from each package's own counter)
REQ_FIELDS = ("new_tokens", "history_tokens", "arrival", "deadline",
              "session", "decode_tokens", "reusable_prefix", "host_prefix",
              "recovery", "rejected", "swap_time", "dispatch_time",
              "finish_time", "instance", "padded_to", "used_graph")


def _req(r):
    return tuple(getattr(r, f) for f in REQ_FIELDS)


def _tracker(tr):
    return ([_req(r) for r in tr.finished],
            dataclasses.asdict(tr.report()))


def _both(scenario, *args):
    out_j = scenario(JAX, *args)
    out_t = scenario(PORT, *args)
    assert out_t == out_j
    return out_t


def test_port_modules_are_distinct():
    """The two sides really are two packages (no alias hides a copy)."""
    assert tsim.ClusterSim is not jsim.ClusterSim
    assert tcontroller.PressureController is not \
        jcontroller.PressureController
    assert tcore.queueing is tqueueing and jcore.queueing is jqueueing
    assert tsim.ClusterSim.__module__ == "repro_torch.sim.simulator"


# --------------------------------------------------------------- workload
@pytest.mark.parametrize("seed,slo", [(0, 0.4), (3, None)])
def test_lmsys_like_requests_equal(seed, slo):
    def scen(p):
        reqs = p.workload.lmsys_like_requests(
            600, rate=50.0, cfg=p.workload.WorkloadConfig(slo_ttft=slo),
            seed=seed)
        return [_req(r) for r in reqs], p.workload.length_stats(reqs)
    _both(scen)


@pytest.mark.parametrize("kw", [dict(), dict(short_only=True),
                                dict(long_only=True, think_time=0.5)])
def test_closed_loop_clients_equal(kw):
    def scen(p):
        clients = p.workload.closed_loop_clients(
            6, p.workload.WorkloadConfig(), seed=5, **kw)
        return [_req(c(0.5 * k)) for k in range(8) for c in clients]
    _both(scen)


# --------------------------------------------------------- simulator runs
def _run_shared(p, variant, conc, until, seed, mode="pd"):
    pol = p.core.make_policy(p.core.Variant(variant),
                             p.core.H200_QWEN32B, threshold=256)
    sim = p.sim.ClusterSim(1, lambda i: None, p.sim.H200_32B,
                           p.sim.SimConfig(router="shared", mode=mode),
                           shared_policy=pol)
    sim.add_clients(p.workload.closed_loop_clients(
        conc, p.workload.WorkloadConfig(), seed=seed))
    tr = sim.run(until)
    return _tracker(tr), sim.prefill_rps(until)


@pytest.mark.parametrize("variant", ["vanilla", "pla_full", "graph_only",
                                     "disagg_only"])
def test_shared_queue_variants_equal(variant):
    _both(_run_shared, variant, 32, 40.0, 1)


@pytest.mark.parametrize("mode", ["mix", "pd"])
def test_mix_mode_equal(mode):
    _both(_run_shared, "pla_full", 32, 30.0, 2, mode)


def test_failure_rerouting_equal():
    def scen(p):
        reqs = p.workload.lmsys_like_requests(300, rate=30.0, seed=3)
        sim = p.sim.ClusterSim(
            2, lambda i: p.core.make_policy(p.core.Variant("pla_full"),
                                            p.core.H200_QWEN32B,
                                            threshold=256),
            p.sim.H200_32B, p.sim.SimConfig(router="least_loaded"))
        sim.add_requests(reqs)
        sim.inject_failure(3.0, 0)
        return _tracker(sim.run(600.0))
    out = _both(scen)
    assert len(out[0]) == 300


def test_straggler_equal():
    def scen(p):
        reqs = p.workload.lmsys_like_requests(400, rate=40.0, seed=7)
        sim = p.sim.ClusterSim(
            2, lambda i: p.core.make_policy(p.core.Variant("pla_full"),
                                            p.core.H200_QWEN32B,
                                            threshold=256),
            p.sim.H200_32B, p.sim.SimConfig(router="least_loaded"))
        sim.set_straggler(0, speed=4.0)
        sim.add_requests(reqs)
        return _tracker(sim.run(600.0))
    _both(scen)


@pytest.mark.parametrize("n_short,conc,think", [(1, 192, 0.0),
                                                (2, 16, None)])
def test_spatial_controller_equal(n_short, conc, think):
    """Routed pools under Algorithm 2: the migrations, the final pools and
    every request equal on both sides."""
    def scen(p):
        def factory(i):
            return p.scheduler.PoolPolicy(
                p.core.H200_QWEN32B,
                pool="short" if i < n_short else "long", threshold=256)
        ctrl = p.controller.PressureController(
            p.controller.ControllerConfig(t_cool=1.0, tau=0.2, period=0.5))
        sim = p.sim.ClusterSim(
            4, factory, p.sim.H200_32B,
            p.sim.SimConfig(router="pool", control_period=0.5),
            classifier=lambda r: "short" if r.new_tokens < 256 else "long",
            controller=ctrl)
        kw = dict(short_only=True)
        if think is not None:
            kw["think_time"] = think
        sim.add_clients(p.workload.closed_loop_clients(
            conc, p.workload.WorkloadConfig(), seed=5, **kw))
        tr = sim.run(20.0)
        pools = [getattr(i.policy, "pool", None) for i in sim.instances]
        return _tracker(tr), pools, ctrl.history
    out = _both(scen)
    assert out[2], "controller never ran"


@pytest.mark.parametrize("arena", [True, False])
def test_arena_prefill_routing_equal(arena):
    def scen(p):
        pol = p.core.make_policy(p.core.Variant("pla_full"),
                                 p.core.H200_QWEN32B, threshold=256,
                                 awd_cfg=p.awd.AWDConfig(packed=True))
        sim = p.sim.ClusterSim(1, lambda i: None, p.sim.H200_32B,
                               p.sim.SimConfig(mode="mix",
                                               arena_prefill=arena,
                                               packed_seqs=16,
                                               arena_s_max=256),
                               shared_policy=pol)
        sim.add_clients(p.workload.closed_loop_clients(
            8, p.workload.WorkloadConfig(), seed=3))
        tr = sim.run(20.0)
        return _tracker(tr), sim.prefill_rps(20.0)
    _both(scen)


@pytest.mark.parametrize("pool_pages", [0, 1, 8])
def test_host_spill_admission_and_swap_billing_equal(pool_pages):
    """§12: the host-resident part of a reusable prefix is dropped without
    a host pool, kept (capped to the pool) with one, and its promotion
    billed through ``swap_in_time`` on the first dispatch."""
    def scen(p):
        kw = dict(host_pool_pages=pool_pages) if pool_pages else {}
        sim = p.sim.ClusterSim(
            1, lambda i: p.core.make_policy(p.core.Variant("pla_full"),
                                            p.core.H200_QWEN32B,
                                            threshold=256),
            p.sim.H200_32B, p.sim.SimConfig(page_size=16, prefix_reuse=True,
                                            **kw))
        reqs = [p.request.Request(new_tokens=100, reusable_prefix=70,
                                  host_prefix=32, arrival=0.0),
                p.request.Request(new_tokens=300, reusable_prefix=200,
                                  host_prefix=160, arrival=0.5)]
        sim.add_requests(reqs)
        admitted = [_req(r) for r in reqs]
        tr = sim.run(60.0)
        return admitted, sim.swapped_pages, _tracker(tr)
    admitted, swapped, _ = _both(scen)
    if pool_pages == 8:
        assert swapped > 0 and admitted[0][REQ_FIELDS.index("swap_time")] > 0
    if pool_pages == 0:
        assert swapped == 0


@pytest.mark.parametrize("host_pool_pages", [0, 4, 64])
@pytest.mark.parametrize("reuse", [True, False])
def test_multiturn_prefix_reuse_equal(reuse, host_pool_pages):
    """The multi-turn trace through a paged, prefix-reusing simulator,
    with the host prefix of each returning turn marked: drop-on-evict
    and host pools of two sizes bill the same on both sides."""
    def scen(p):
        cfg = p.synthetic.MultiTurnConfig(vocab_size=1000, num_sessions=16,
                                          max_turns=5, seed=4)
        reqs = p.synthetic.multiturn_requests(cfg, decode_tokens=4)
        for i, r in enumerate(reqs):
            if r.reusable_prefix and i % 3 == 0:
                r.host_prefix = r.reusable_prefix // 2
        pol = p.core.make_policy(p.core.Variant("pla_full"),
                                 p.core.H200_QWEN32B, threshold=256)
        sim = p.sim.ClusterSim(1, lambda i: None, p.sim.H200_32B,
                               p.sim.SimConfig(
                                   mode="mix", page_size=16,
                                   prefix_reuse=reuse,
                                   host_pool_pages=host_pool_pages),
                               shared_policy=pol)
        sim.add_requests(reqs)
        billed = sum(r.new_tokens for r in reqs)
        tr = sim.run(600.0)
        return billed, sim.swapped_pages, _tracker(tr)
    billed, swapped, (finished, _) = _both(scen)
    assert len(finished) > 0
    if reuse and host_pool_pages:
        assert swapped > 0


@pytest.mark.parametrize("spec", [True, False])
def test_speculative_drain_equal(spec):
    def scen(p):
        pol = p.core.make_policy(p.core.Variant("pla_full"),
                                 p.core.H200_QWEN32B, threshold=256)
        sim = p.sim.ClusterSim(1, lambda i: None, p.sim.H200_32B,
                               p.sim.SimConfig(router="shared", mode="mix",
                                               speculative=spec),
                               shared_policy=pol)
        inst = sim.instances[0]
        inst.decode_sessions = [(64, 512 + 64 * i) for i in range(4)]
        t, ticks = 0.0, 0
        while inst.decode_sessions:
            t += sim._decode_tick_time(inst.decode_ctx_lens)
            inst.advance_decodes(sim._spec_commit())
            ticks += 1
        return t, ticks
    _both(scen)


def test_fault_plan_through_the_simulator_equal():
    def scen(p):
        plan = p.core.FaultPlan.random(seed=3, n_engines=3, horizon=8.0)
        reqs = p.workload.lmsys_like_requests(200, rate=25.0, seed=11)
        sim = p.sim.ClusterSim(
            3, lambda i: p.core.make_policy(p.core.Variant("pla_full"),
                                            p.core.H200_QWEN32B,
                                            threshold=256),
            p.sim.H200_32B, p.sim.SimConfig(router="least_loaded"))
        sim.add_requests(reqs)
        sim.apply_faults(plan)
        return _tracker(sim.run(300.0))
    _both(scen)


# ------------------------------------------------------------- controller
def _stats(p, idx, q=0.0, e=0.0, u=0.0):
    return p.controller.InstanceStats(idx, q, e, u)


def _mig(m):
    return None if m is None else dataclasses.astuple(m)


@pytest.mark.parametrize("cfg,shorts,longs,now", [
    (dict(t_cool=0.0, tau=0.25), [(0, 5.0, 1.0, 0.0), (1, 4.0, 0.8, 0.0)],
     [(2, 0.1, 0.0, 0.2), (3, 0.1, 0.0, 0.3)], 10.0),
    (dict(t_cool=0.0, n_min=1), [(0, 9.0, 0.0, 0.0)], [(1, 0.0, 0.0, 0.0)],
     1.0),
    (dict(t_cool=0.0, tau=0.5), [(0, 1.1, 0.0, 0.0), (1, 1.0, 0.0, 0.0)],
     [(2, 1.0, 0.0, 0.0), (3, 0.9, 0.0, 0.0)], 1.0),
    (dict(t_cool=0.0, tau=0.25), [(2, 0.1, 0.0, 0.2), (3, 0.1, 0.0, 0.3)],
     [(0, 5.0, 1.0, 0.0), (1, 4.0, 0.8, 0.0)], 3.0),
])
def test_controller_step_equal(cfg, shorts, longs, now):
    def scen(p):
        c = p.controller.PressureController(
            p.controller.ControllerConfig(**cfg))
        s = [_stats(p, *a) for a in shorts]
        lg = [_stats(p, *a) for a in longs]
        return (_mig(c.step(s, lg, now=now)), c.pool_pressure(s),
                c.pool_pressure(lg), [c.pressure(x) for x in s + lg])
    _both(scen)


def test_controller_cooldown_and_balanced_load_equal():
    def scen(p):
        c = p.controller.PressureController(
            p.controller.ControllerConfig(t_cool=5.0, tau=0.1))
        shorts = [_stats(p, 0, q=9.0), _stats(p, 1, q=9.0)]
        longs = [_stats(p, 2), _stats(p, 3)]
        out = [_mig(c.step(shorts, longs, now=t)) for t in (0.0, 2.0, 6.0)]
        c2 = p.controller.PressureController(
            p.controller.ControllerConfig(t_cool=0.0, tau=0.25))
        for t in range(50):
            s = [_stats(p, 0, q=1.0 + 0.05 * (t % 2)), _stats(p, 1, q=1.0)]
            lg = [_stats(p, 2, q=1.0), _stats(p, 3, q=1.0 - 0.05 * (t % 2))]
            out.append(_mig(c2.step(s, lg, now=float(t))))
        return out
    out = _both(scen)
    assert out[0] is not None and out[1] is None and out[2] is not None
    assert all(m is None for m in out[3:])


def test_controller_quantile_and_utilization_equal():
    def scen(p):
        c = p.controller.PressureController(
            p.controller.ControllerConfig(quantile=0.5))
        pool = [_stats(p, i, q=0.1) for i in range(9)] + \
            [_stats(p, 9, q=99.0)]
        c2 = p.controller.PressureController(p.controller.ControllerConfig())
        return (c.pool_pressure(pool),
                c2.pressure(_stats(p, 0, q=1.0, u=1.0)),
                c2.pressure(_stats(p, 1, q=1.0, u=0.0)))
    _both(scen)


# --------------------------------------------------------------- queueing
def test_queueing_formulas_equal():
    rng = np.random.default_rng(0)
    for _ in range(200):
        lam = float(rng.uniform(0.1, 5.0))
        p_s = float(rng.uniform(0.01, 0.99))
        s_s = float(rng.uniform(0.001, 0.05))
        s_l = s_s + float(rng.uniform(0.01, 0.5))
        es = p_s * s_s + (1 - p_s) * s_l
        rho = lam * es

        def scen(p):
            q = p.queueing
            classes = [q.ServiceClass(lam * p_s, s_s, s_s ** 2),
                       q.ServiceClass(lam * (1 - p_s), s_l, s_l ** 2)]
            out = [q.mixture(classes), q.utilization(classes),
                   q.normalized_latency(s_s, 0.1)]
            if rho < 0.95:
                out += [q.pk_wait(lam, es, es * es), q.mixed_wait(classes),
                        q.hol_penalty(lam, p_s, s_l, s_s, rho)]
            return out
        _both(scen)
