"""The serving path's own spans (``repro_torch.serving.trace``): off they
record nothing, on they nest and stay under their cap, a collection of
the interpreter leaves one, and they share the profiler's clock; the
AWD window's hold per turn (``Request.awd_hold_s``) on a fake clock; the
harness naming an idle gap by a program span nested in one of its own;
and the tiny benchmark cell served with the spans on
(``tools/serve_spans.py``)."""
import gc
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import repro_torch.core as tcore  # noqa: E402
from laps_bench import tiny_cell  # noqa: E402
from laps_bench import trace as bench_trace  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.awd import AWDConfig  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import trace  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402


@pytest.fixture
def tracer():
    """The tracer on, with an empty buffer; off again afterwards."""
    trace.disable()
    trace.take()
    trace.enable()
    yield trace
    trace.disable()
    trace.take()


def _named(spans, name):
    return [s for s in spans if s[2] == name]


def test_off_records_nothing():
    trace.disable()
    trace.take()
    off = trace.span("serve.tick")
    assert off is trace.span("engine.wait", kind="decode")
    with off as sp:
        sp.set(kind="idle")
        gc.collect()
    assert trace.take() == ([], 0)
    assert trace._on_gc not in gc.callbacks


def test_children_lie_inside_their_parents(tracer):
    with trace.span("serve.tick", n=1) as tick:
        with trace.span("serve.schedule"):
            time.sleep(0.001)
        with trace.span("engine.prepare"):
            pass
        tick.set(kind="decode")
    spans, dropped = trace.take()
    assert dropped == 0
    (t0, t1, _, attrs), = _named(spans, "serve.tick")
    assert attrs == {"n": 1, "kind": "decode"}
    kids = _named(spans, "serve.schedule") + _named(spans, "engine.prepare")
    assert len(kids) == 2
    for s, e, _, a in kids:
        assert t0 <= s <= e <= t1 and a is None
    assert kids[0][1] - kids[0][0] >= 1_000_000
    # recorded as each ends: the children before their parent
    assert spans.index(kids[0]) < spans.index((t0, t1, "serve.tick", attrs))


def test_the_cap_counts_what_it_drops(tracer):
    trace.enable(cap=3)
    was = gc.isenabled()
    gc.disable()
    try:
        for _ in range(5):
            with trace.span("graph.replay"):
                pass
    finally:
        if was:
            gc.enable()
    spans, dropped = trace.take()
    assert len(spans) == 3 and dropped == 2
    with trace.span("graph.replay"):
        pass
    assert len(trace.take()[0]) == 1      # a take empties the buffer


def test_a_collection_leaves_a_gc_span(tracer):
    a = time.time_ns()
    gc.collect()
    b = time.time_ns()
    got = [s for s in _named(trace.take()[0], "gc")
           if s[3] == {"generation": 2}]
    assert got and all(a <= s <= e <= b for s, e, _, _ in got)
    trace.disable()
    gc.collect()
    assert trace.take() == ([], 0)


def test_spans_share_the_profilers_clock(tracer):
    """A torch op run inside a span starts, on the profiler's clock (the
    harness's profiler window, on the CPU), inside that span."""
    prof = bench_trace.Tracer("cpu")
    x = torch.randn(64, 64)
    prof.start()
    time.sleep(0.002)
    with trace.span("graph.replay"):
        time.sleep(0.002)
        torch.mm(x, x)
        time.sleep(0.002)
    prof.stop()
    (s, e, _, _), = _named(trace.take()[0], "graph.replay")
    ops = [bench_trace._ns(ev, "start") for ev in prof._result.events()
           if ev.name() == "aten::mm"]
    assert len(ops) == 1
    assert s < ops[0] < e


# ---------------------------------------------------------- AWD holds


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke("qwen3-4b")
    return cfg, ttr.init_params(cfg, seed=0, device="cpu")


def _held_loop(smoke):
    """A loop on a fake clock whose AWD window holds the short queue until
    ``hold[0]`` and then lets the whole queue go."""
    cfg, params = smoke
    engine = Engine(cfg, params, EngineConfig(
        num_slots=8, max_len=256, chunk_tokens=32, measure=False),
        device="cpu")
    awd = AWDConfig(packed=True, token_buckets=engine.ecfg.token_buckets,
                    packed_max_seqs=engine.packed_executor.max_seqs)
    policy = tcore.make_policy(tcore.Variant("pla_full"),
                               tcore.H200_QWEN32B, threshold=48,
                               chunk_tokens=32, awd_cfg=awd)
    hold = [None]
    real = policy.awd.decide

    def decide(queue, now):
        if hold[0] is not None and now < hold[0]:
            return None, hold[0]
        return real(queue, now, force=True)

    policy.awd.decide = decide
    clock = _Clock()
    return ServeLoop(engine, policy, slo_ttft=None, clock=clock), clock, hold


def _prompt(seed, n=10):
    return np.random.default_rng(seed).integers(1, 200, n)


def test_a_hold_with_a_decode_tick_inside_is_counted_whole(smoke):
    loop, clock, hold = _held_loop(smoke)
    a = loop.submit(1, _prompt(1), decode_tokens=4)
    loop.tick()                                   # a prefills, decodes on
    assert a.awd_hold_s == 0.0 and a.dispatch_time == 0.0
    clock.t = 1.0
    b = loop.submit(2, _prompt(2))
    hold[0] = 1.25
    trace.enable()
    try:
        loop.tick()                               # held: a decode-only tick
        clock.t = 1.25
        loop.tick()                               # released: b prefills
        spans, _ = trace.take()
    finally:
        trace.disable()
    kinds = [at["kind"] for _, _, n, at in spans if n == "serve.tick"]
    assert kinds == ["decode", "prefill"]
    assert b.dispatch_time == 1.25
    assert b.awd_hold_s == pytest.approx(0.25, abs=1e-12)
    assert a.awd_hold_s == 0.0


def test_a_turn_that_arrives_mid_hold_counts_from_its_arrival(smoke):
    loop, clock, hold = _held_loop(smoke)
    clock.t = 2.0
    b = loop.submit(2, _prompt(2))
    hold[0] = 2.3
    assert loop.tick() == (False, 2.3)            # held, nothing to decode
    clock.t = 2.1
    c = loop.submit(3, _prompt(3))
    loop.tick()                                   # still held
    clock.t = 2.3
    loop.tick()                                   # both go
    assert b.dispatch_time == c.dispatch_time == 2.3
    assert b.awd_hold_s == pytest.approx(0.3, abs=1e-12)
    assert c.awd_hold_s == pytest.approx(0.2, abs=1e-12)
    long = loop.submit(4, _prompt(4, 100))        # over the threshold
    loop.run_until_idle()
    assert long.awd_hold_s is None                # never queued as short


# ------------------------------------------------------ the benchmark


def test_an_idle_gap_goes_to_a_program_span_nested_in_a_harness_span():
    """The harness's gap attribution picks the innermost open span, a
    program span inside one of its wrappers; a gap outside the program's
    spans keeps the wrapper's name."""
    device = [(0, 10), (40, 100), (130, 200)]
    spans = [(0, 200, "engine.step_mixed"), (10, 50, "engine.prepare"),
             (60, 140, "graph.replay")]
    gaps = bench_trace._attribute_gaps(device, spans)
    assert gaps == {"engine.prepare": 30, "graph.replay": 30}
    gaps = bench_trace._attribute_gaps([(0, 150), (190, 200)], spans)
    assert gaps == {"engine.step_mixed": 40}


def _serve_spans():
    spec = importlib.util.spec_from_file_location(
        "serve_spans", ROOT / "tools" / "serve_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_tiny_cell_served_with_spans_on():
    """A traced run of the tiny cell with the program's spans on: correct;
    every ``serve.tick`` in the profiler's window inside the harness's
    ``loop.tick``; no turn held longer than it waited, and the
    benchmark's AWD readers over those holds; the host-side readings of
    the spans."""
    ss = _serve_spans()
    res, got = ss.run(tiny_cell.spec(), 2**31 + 11, 1.5, True, True,
                      time.monotonic(), device="cpu", log=lambda m: None)
    assert res["correct"] is True
    assert got["dropped"] == 0
    tr = got["tracer"]
    outer = [(s, e) for s, e, n in tr.spans if n == bench_trace.TICK]
    inner = [(s, e) for s, e, n, _ in got["spans"] if n == "serve.tick"
             and tr._t[0] <= s < tr._t[1]]
    assert outer and len(inner) == len(outer)
    for s, e in inner:
        assert any(a <= s <= e <= b for a, b in outer)
    turns = [t for t in got["rec"].turns if t.dispatch is not None]
    assert any(t.req.awd_hold_s is not None for t in turns)
    for t in turns:
        if t.req.awd_hold_s is not None:
            assert t.req.awd_hold_s <= t.dispatch - t.req.arrival
    # the benchmark's readers of the counter
    held = [t.req.awd_hold_s for t in got["rec"].in_window()
            if t.dispatch is not None and t.req.awd_hold_s is not None]
    got_ms = {n: res["metrics"][n]["value"]
              for n in ("awd_hold_p90_ms", "awd_hold_mean_ms")}
    assert got_ms == pytest.approx({
        "awd_hold_p90_ms": np.percentile(held, 90) * 1e3,
        "awd_hold_mean_ms": np.mean(held) * 1e3})
    prog = res["program"]
    for name in ("decode_host_ms", "prefill_host_ms"):
        assert name in prog, name
    assert 0 < prog["decode_host_ms"] < prog["decode_tick_ms"]
    assert 0 < prog["prefill_host_ms"] < prog["prefill_tick_ms"]
    assert prog["probe_ms"] > 0
    assert not trace._on and trace._on_gc not in gc.callbacks
