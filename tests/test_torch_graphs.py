"""The executors' step graphs (``repro_torch/serving/graphs.py``) on the
CPU, where a ``StepGraph`` stages its inputs exactly as on the card and
runs the step eagerly over its static buffers:

- the staging over two ticks of one shape, the second's stream shorter
  than the first, against the eager step function on fresh inputs (no
  stale input leaks into the result);
- output aliasing: a consumer that keeps a step's output (the tensor, a
  view or a numpy array over it) across the next replay is caught, and
  state rebound under a graph is refused;
- the launch-count bookkeeping of a capture and its replays, with fake
  launchers;
- the executors' per-kind shape keys over a multi-turn ServeLoop trace,
  against the JAX executors' compile-cache keys;
- a capture at a live miss, on parked inputs, leaves every live KV row
  and SSM state bit-unchanged, in every engine mode;
- the device paths' freedom from host syncs: no ``.item()``,
  ``.tolist()``, ``nonzero``, ``.cpu()`` or ``.numpy()`` in ``models/``,
  ``kernels/`` and ``serving/executor.py``.
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro_torch.core as tcore  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import H200_QWEN32B, Variant, make_policy  # noqa: E402
from repro.core.awd import AWDConfig  # noqa: E402
from repro.data.synthetic import (MultiTurnConfig,  # noqa: E402
                                  gen_multiturn_sessions)
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving.loop import ServeLoop as JLoop  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.core.awd import AWDConfig as TAWDConfig  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import executor as tex  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving import packing  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.kvcache import KVArena  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402


SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
# the positions of each step kind's arguments that key its graph
# (executor.py's ``_step`` calls): the JAX key holds every argument
KEYED = {"prefill": (1,), "decode": (1,), "packed_prefill": (1,),
         "packed_arena": (1,), "packed_paged": (1, 5),
         "verify_arena": (1, 9), "verify_paged": (1, 5, 10),
         "arena_decode": (1,), "paged_decode": (1, 5)}


@pytest.fixture(scope="module")
def stack():
    cfg = get_smoke("qwen3-4b")
    params, _ = jtr.init_params(cfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, params),
                           tget("qwen3-4b"), "cpu")
    return cfg, params, tget("qwen3-4b"), tp


def _clone(tree):
    return [{k: v.clone() for k, v in leaves.items()} for leaves in tree]


def _stream(rng, vocab, lens, hists, bucket, rows, slots, park):
    segs = [packing.SegmentSpec(i, rng.integers(1, vocab, n).astype(
        np.int32), h, kind="prefill") for i, (n, h) in enumerate(
        zip(lens, hists))]
    st = packing.assemble_mixed_stream(segs, bucket, rows,
                                       park_position=park, pad_token=0)
    slot_map = np.asarray(slots + [slots[0]] * (rows - len(slots)),
                          np.int32)
    return (st.tokens, st.positions, slot_map[st.seg_ids], slot_map,
            st.cu_seqlens, st.q_offsets, st.kv_lengths, st.last_idx)


def test_staging_over_a_shorter_second_tick(stack):
    """Two ticks of one bucket, the second stream 5 tokens after a first
    of 27: the replayed step equals the eager step on fresh tensors —
    logits, greedy ids and every arena row below the park row — bit for
    bit."""
    _, _, tcfg, tp = stack
    px = tex.PackedBucketExecutor(tcfg, token_buckets=(32,), max_seqs=4)
    arena = KVArena(tcfg, 4, 64, device="cpu").arena
    ref = _clone(arena)
    eager = tex.make_packed_arena_fn(tcfg)
    rng = np.random.default_rng(0)
    park = 63
    ticks = [_stream(rng, tcfg.vocab_size, [12, 9, 6], [0, 0, 0], 32, 4,
                     [0, 1, 2], park),
             _stream(rng, tcfg.vocab_size, [5], [12], 32, 4, [0], park)]
    for n, ins in enumerate(ticks):
        got = px.mixed_step_arena(tp, *ins[:7], arena, ins[7])
        got = [t.clone() for t in got]
        want = eager(tp, *(torch.from_numpy(a) for a in ins[:7]), ref,
                     torch.from_numpy(ins[7]))
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"tick {n}"
        for la, lr in zip(arena, ref):
            for name in la:
                # below the park row, which the graph's parked run and
                # the ticks' tail rows write
                assert torch.equal(la[name][:, :, :park],
                                   lr[name][:, :, :park]), f"tick {n}"
    assert px.dispatches == 2 and len(px.graphs) == 1
    (graph,) = px.graphs.values()
    assert graph.replays == 2


def _toy(state, a, b):
    state.add_(a.sum())
    return a * 2 + b[:1], (a + state[0]).sum()


def test_a_kept_output_is_caught():
    """A step output held across the next replay of its graph — the
    tensor, a view or a numpy array over it — makes the replay raise;
    copies pass.  State rebound under the graph is refused."""
    state = torch.zeros(3)
    g = graphs.StepGraph(_toy, (state, np.zeros(4, np.int32),
                                np.zeros(2, np.int32)))
    a, b = np.arange(4, dtype=np.int32), np.asarray([7, 9], np.int32)
    out, total = g.run((state, a, b))
    assert out.tolist() == [7, 9, 11, 13] and float(total) == 30.0
    del out, total
    for keep in (lambda o: o, lambda o: o[1:], lambda o: o.numpy()):
        kept = keep(g.outputs[0])
        with pytest.raises(RuntimeError, match="kept across"):
            g.run((state, a, b))
        del kept
    copy = g.run((state, a, b))[0].clone()
    assert copy.tolist() == [7, 9, 11, 13]
    # the static output is rewritten in place by the next replay
    g.run((state, a + 1, b))
    assert g.outputs[0].tolist() == [9, 11, 13, 15]
    assert copy.tolist() == [7, 9, 11, 13]
    with pytest.raises(RuntimeError, match="rebound"):
        g.run((torch.zeros(3), a, b))
    with pytest.raises(ValueError, match="shape"):
        g.run((state, np.zeros(5, np.int32), b))


class _FakeLauncher:
    def __init__(self):
        self.launches = 0

    def __call__(self):
        self.launches += 1


def test_launch_delta_bookkeeping_with_fake_launchers():
    """A capture's counter bumps ran nothing: they are taken back and
    kept as the graph's delta, which every replay adds; a warm-up's
    launches ran and stay."""
    fakes = {"a": _FakeLauncher(), "b": _FakeLauncher(),
             "c": _FakeLauncher()}

    def step():
        fakes["a"]()
        fakes["a"]()
        fakes["b"]()

    step()                                  # the warm-up: it ran
    before = graphs.launch_counts(fakes)
    assert before == {"a": 2, "b": 1, "c": 0}
    step()                                  # the capture: it did not
    delta = graphs.take_back(fakes, before)
    assert delta == {"a": 2, "b": 1}
    assert graphs.launch_counts(fakes) == before
    for _ in range(3):                      # three replays
        graphs.add_launches(fakes, delta)
    assert graphs.launch_counts(fakes) == {"a": 8, "b": 4, "c": 0}


def _clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _serve(side, stack, kw):
    cfg, params, tcfg, tp = stack
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=cfg.vocab_size, num_sessions=4, max_turns=2,
        system_len=24, seed=6))
    kw = dict(num_slots=8, max_len=256, chunk_tokens=32, measure=False,
              token_buckets=(16, 32, 64), decode_buckets=(1, 2, 4, 8),
              **kw)
    if side == "jax":
        engine = JEngine(cfg, params, JConfig(**kw))
        core, awd_cls, loop_cls = None, AWDConfig, JLoop
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
        core, awd_cls, loop_cls = tcore, TAWDConfig, ServeLoop
    awd = None
    if engine.packed_executor is not None:
        awd = awd_cls(packed=True, token_buckets=engine.ecfg.token_buckets,
                      packed_max_seqs=engine.packed_executor.max_seqs)
    if core is None:
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=48, chunk_tokens=32, awd_cfg=awd)
    else:
        policy = core.make_policy(core.Variant("pla_full"),
                                  core.H200_QWEN32B, threshold=48,
                                  chunk_tokens=32, awd_cfg=awd)
    loop = loop_cls(engine, policy, slo_ttft=2.0, clock=_clock())
    for _, wave in itertools.groupby(turns, key=lambda u: u.arrival):
        for u in wave:
            loop.submit(u.session, u.tokens if u.turn == 0
                        else u.tokens[-u.suffix:], decode_tokens=3)
        loop.run_until_idle(max_wall=1e9)
    return engine, loop.generated


def _jax_keys(ex):
    """The JAX executor's compile-cache keys, cut to the arguments that
    key the port's graphs."""
    return {(k[0],) + tuple((tuple(k[1 + j][0][0]), k[1 + j][0][1])
                            for j in KEYED[k[0]])
            for k in ex.compile_times}


@pytest.mark.parametrize("kw", [dict(), dict(packed=False, paged_kv=False)],
                         ids=["paged", "slot_dense"])
def test_graph_keys_are_the_jax_compile_keys(stack, kw):
    """On a multi-turn trace every executor holds one graph per JAX
    compile-cache key, and dispatches, hits and misses by kind agree."""
    je, jgen = _serve("jax", stack, kw)
    te, tgen = _serve("torch", stack, kw)
    assert tgen == jgen
    for name in ("executor", "packed_executor", "decode_executor"):
        jx, tx = getattr(je, name), getattr(te, name)
        if jx is None:
            assert tx is None
            continue
        assert set(tx.graphs) == set(tx.compile_times)
        assert set(tx.graphs) == _jax_keys(jx), name
        assert (tx.kind_hits, tx.kind_misses) == (jx.kind_hits,
                                                 jx.kind_misses)
        assert tx.replays == tx.dispatches
    assert te.graph_stats()["graphs"] > 0


SYNCS = re.compile(r"\.item\(\)|\.tolist\(\)|nonzero|\.cpu\(\)|\.numpy\(\)")


def test_device_paths_have_no_host_sync():
    """The step functions a graph captures read nothing back to the
    host: no ``.item()``, ``.tolist()``, ``nonzero``, ``.cpu()`` or
    ``.numpy()`` in the models, the kernels' launchers and plain
    versions, or the executors."""
    files = (sorted((SRC / "models").glob("*.py"))
             + sorted((SRC / "kernels").glob("*.py"))
             + [SRC / "serving" / "executor.py"])
    assert len(files) > 10
    hits = [f"{f.relative_to(SRC)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if SYNCS.search(line)]
    assert hits == []


# (arch, engine options) of each engine mode whose parked captures are
# checked
PARKED_MODES = {
    "paged": ("qwen3-4b", dict()),
    "arena": ("qwen3-4b", dict(paged_kv=False)),
    "gathered": ("qwen3-4b", dict(paged_kv=False, arena_prefill=False)),
    "grid": ("qwen3-4b", dict(packed=False, paged_kv=False,
                              arena_decode=False)),
    "ssm_paged": ("mamba2-2.7b", dict()),
    "ssm_arena": ("mamba2-2.7b", dict(paged_kv=False)),
    # KV and recurrent state side by side in one page pool or slot
    "hybrid_paged": ("jamba-v0.1-52b", dict()),
    "hybrid_arena": ("jamba-v0.1-52b", dict(paged_kv=False)),
}


@pytest.mark.parametrize("mode", list(PARKED_MODES))
def test_parked_capture_leaves_live_state_unchanged(mode):
    """Step graphs first met at live misses, of every step kind of the
    mode, built on parked inputs (on the CPU the parked run stands for
    the card's warm-up; the replays are skipped): every arena row but
    the park rows and the scratch slot or page keeps its bits."""
    arch, opts = PARKED_MODES[mode]
    cfg = tget(arch)
    params = ttr.init_params(cfg, seed=0, device="cpu")
    e = Engine(cfg, params, EngineConfig(
        num_slots=4, max_len=128, chunk_tokens=32, measure=False,
        token_buckets=(16, 32, 64), decode_buckets=(1, 2, 4), **opts),
        device="cpu")
    rng = np.random.default_rng(6)
    bucket = (16, 2) if opts.get("packed") is False else None
    r = e.prefill_batch([0, 1], [rng.integers(1, cfg.vocab_size, n)
                                 for n in (7, 11)], bucket=bucket)
    e.decode_batch([0, 1], [r[0], r[1]], 2)
    before = [{k: v.clone() for k, v in leaves.items()}
              for leaves in e.arena.arena]
    shapes = sum(len(ex.graphs) for ex in e.executors)
    run = graphs.StepGraph.run
    graphs.StepGraph.run = lambda self, args, fill=None: self.outputs
    try:
        kinds = _capture_new_shapes(e)
    finally:
        graphs.StepGraph.run = run
    assert sum(len(ex.graphs) for ex in e.executors) == shapes + kinds
    ar = e.arena
    for leaves, old in zip(ar.arena, before):
        for name, a in leaves.items():
            keep = torch.ones(a.shape[1], dtype=torch.bool)
            if ar.scratch is not None:
                keep[ar.scratch] = False
            a, o = a[:, keep], old[name][:, keep]
            if name in ("k", "v") and not e._paged:
                a, o = a[:, :, :-1], o[:, :, :-1]     # the park rows
            assert torch.equal(a, o), name


def _capture_new_shapes(e) -> int:
    """Dispatch each step kind of ``e`` once at a shape it has not met
    (the largest token bucket and decode rung, a new grid shape), with
    zero inputs.  Returns the dispatches made."""
    z = lambda *shape: np.zeros(shape, np.int32)   # noqa: E731
    p, ar = e.params, e.arena
    px, dx = e.packed_executor, e.decode_executor
    n = 0
    if px is not None:
        t, b = px.token_buckets[-1], px.stream_rows
        if e._paged:
            pm = ar.max_pages_per_seq
            px.mixed_step_paged(p, z(t), z(t), z(t), z(t), z(b, pm),
                                z(b + 1), z(b), z(b), ar.arena, z(b), z(b))
            if e.capability.pure_attn:
                px.verify_step_paged(p, z(t), z(t), z(t), z(t), z(b, pm),
                                     z(b + 1), z(b), z(b), ar.arena,
                                     z(b, 4))
                n += 1
        elif e.ecfg.arena_prefill:
            px.mixed_step_arena(p, z(t), z(t), z(t), z(b), z(b + 1), z(b),
                                z(b), ar.arena, z(b))
            if e.capability.pure_attn:
                px.verify_step_arena(p, z(t), z(t), z(t), z(b), z(b + 1),
                                     z(b), z(b), ar.arena, z(b, 4))
                n += 1
        else:
            px.mixed_step(p, z(t), z(t), z(t), z(b + 1), z(b), z(b),
                          ar.batch(b), z(b))
        n += 1
    if dx is not None:
        m = dx.decode_buckets[-1]
        if e._paged:
            dx.decode_paged(p, z(m), z(m), z(m), z(m),
                            z(m, ar.max_pages_per_seq), z(m), ar.arena,
                            z(m))
        else:
            dx.decode(p, z(m), z(m), z(m), z(m), ar.arena)
        n += 1
    if not e._paged:
        caches = ar.batch(3)
        e.executor.prefill(p, z(3, 24), z(3, 24), caches, z(3))
        e.executor.decode(p, z(3, 1), z(3, 1), caches)
        n += 2
    return n
