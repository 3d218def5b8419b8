"""Slot-arena serving engine of the PyTorch port against the JAX engine,
in the three slot modes: arena-resident packed steps (``paged_kv=False``),
the gathered packed baseline (``arena_prefill=False``) and the dense
(L, B) grid with arena decode (``packed=False``, the serve launcher's
default).  The same schedule — ``prefill_batch`` with and without a
pinned (L, B) bucket, ``step_mixed`` fused, off the token ladder and over
``max_seqs``, ``prefill_long`` and ``decode_batch`` — must commit
identical tokens into identical slots, give logits and cached KV within
1e-5 (fp32), and leave identical counters: whole-slot gathers and
scatters, dense dispatches by cause, dispatches and shapes by kind.

Also: the port's slot engine against its own paged engine on the same
greedy traffic, and ServeLoop on the launcher default against the JAX
loop (same transcripts, grid hits and dense causes).
"""
import itertools

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
from repro.data.synthetic import (MultiTurnConfig,  # noqa: E402
                                  gen_multiturn_sessions)
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving.loop import ServeLoop as JLoop  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
MODES = {
    "arena": dict(paged_kv=False),
    "gathered": dict(paged_kv=False, arena_prefill=False),
    "dense": dict(packed=False, paged_kv=False),
}
# counters that must agree between the two engines
KEYS = ("arena_gathers", "arena_scatters", "dense_dispatches",
        "dense_dispatches_by_cause", "graph_hit_rate", "captured_shapes",
        "hit_rate_by_kind", "useful_tokens", "padded_tokens", "free_slots",
        "decode_shapes", "decode_dispatches", "decode_useful_rows",
        "decode_pad_rows", "packed_shapes", "packed_dispatches",
        "packed_useful_tokens", "packed_padded_tokens",
        "packed_shapes_by_kind", "mixed_steps", "decode_tokens_fused",
        "fused_greedy_steps", "logits_rows_shipped", "fit_samples")


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for arch in ("qwen3-4b", "qwen2.5-32b"):
        cfg = get_smoke(arch)
        params, _ = jtr.init_params(cfg, jax.random.key(13))
        tp = params_from_numpy(jax.tree.map(np.asarray, params),
                               tget(arch), "cpu")
        out[arch] = (cfg, params, tget(arch), tp)
    return out


def _pair(stack, **kw):
    cfg, params, tcfg, tp = stack
    base = dict(num_slots=8, max_len=96, chunk_tokens=16, measure=False,
                token_buckets=(16, 32), packed_max_seqs=4,
                decode_buckets=(1, 2, 4))
    base.update(kw)
    return (JEngine(cfg, params, JConfig(**base)),
            Engine(tcfg, tp, EngineConfig(**base), device="cpu"))


def _same(je, te, sessions):
    """Logits, slots, lengths, cached KV rows and counters agree."""
    for s in sessions:
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
        slot, n = je.arena.slot_of(s), je.arena.length(s)
        assert te.arena.slot_of(s) == slot and te.arena.length(s) == n
        for name in ("k", "v"):
            np.testing.assert_allclose(
                te.arena.arena[0][name][:, slot, :n].numpy(),
                np.asarray(je.arena.arena[0][name])[:, slot, :n], **TOL)
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in KEYS} == {k: js.get(k) for k in KEYS}
    for x in ("executor", "packed_executor", "decode_executor"):
        jx, tx = getattr(je, x), getattr(te, x)
        assert (jx is None) == (tx is None)
        if jx is not None:
            assert tx.shapes_by_kind() == jx.shapes_by_kind()
            assert tx.dispatches == jx.dispatches


def _schedule(e, vocab, seed):
    """Every slot-engine entry point, in an order that reaches each
    dense cause the mode has."""
    rng = np.random.default_rng(seed)

    def p(n):
        return rng.integers(1, vocab, n).astype(np.int32)

    out = [e.prefill_batch([0, 1], [p(9), p(5)])]            # on the ladder
    out.append(e.prefill_batch([2], [p(7)], bucket=(8, 2)))   # pinned (L, B)
    r = e.step_mixed([(3, p(6))], [(0, out[0][0]), (1, out[0][1])])
    out.append((r.tokens, r.fused))                           # fused
    r = e.step_mixed([(4, p(40))], [(2, out[1][2])])          # off-ladder
    out.append((r.tokens, r.fused))
    r = e.step_mixed([(5, p(3)), (6, p(4))],
                     [(0, 1), (1, 2), (3, 3)])                # over max_seqs
    out.append((r.tokens, r.fused))
    out.append(e.prefill_long(7, p(37)))                      # C_l chunks
    out.append(e.prefill_batch([0], [p(4)]))                  # re-prefill
    out.append(e.decode_batch([0, 1, 2], [5, 6, 7], steps=2))  # rung 4
    out.append(e.decode_batch(list(range(8)), list(range(8)), steps=1))
    return out


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-32b"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_slot_engine_matches_jax(stacks, arch, mode):
    je, te = _pair(stacks[arch], **MODES[mode])
    vocab = stacks[arch][0].vocab_size
    want = _schedule(je, vocab, 1)
    got = _schedule(te, vocab, 1)
    assert got == want
    _same(je, te, range(8))
    st = te.stats()
    # whole slots are copied by the dense steps, and by every packed
    # step of the gathered baseline; the arena-resident steps copy none
    copies = st["dense_dispatches"] + (
        st["packed_dispatches"] if mode == "gathered" else 0)
    assert st["arena_gathers"] == st["arena_scatters"] == copies
    if mode == "dense":
        assert te.packed_executor is None
        assert st["dense_dispatches_by_cause"]["prefill"] == {
            "requested": st["dense_dispatches"]}
    else:
        assert st["dense_dispatches_by_cause"]["prefill"]["forced"] > 0


def test_dense_decode_when_arena_decode_is_off(stacks):
    """arena_decode=False: every decode tick gathers, runs the (B, 1)
    step and scatters, one shape per session count."""
    je, te = _pair(stacks["qwen3-4b"], packed=False, arena_decode=False,
                   paged_kv=False)
    vocab = stacks["qwen3-4b"][0].vocab_size
    outs = []
    for e in (je, te):
        rng = np.random.default_rng(2)
        first = e.prefill_batch([0, 1, 2],
                                [rng.integers(1, vocab, n) for n in (5, 8, 3)])
        d = e.decode_batch([0, 1, 2], [first[s] for s in (0, 1, 2)], steps=2)
        d2 = e.decode_batch([1], [d[1][-1]], steps=1)
        outs.append((first, d, d2))
    assert outs[0] == outs[1]
    _same(je, te, range(3))
    assert te.stats()["dense_dispatches_by_cause"]["decode"] == {
        "requested": 3}


def test_slot_engine_matches_own_paged_engine(stacks):
    """The same greedy traffic through the port's slot arena and its
    page pool (same math, different layout): identical tokens, logits
    within 1e-5, and no whole-slot copy and no dense step on either."""
    cfg, params, tcfg, tp = stacks["qwen3-4b"]
    base = dict(num_slots=4, max_len=64, chunk_tokens=16, measure=False,
                token_buckets=(16, 32, 64), decode_buckets=(1, 2, 4))
    eng = Engine(tcfg, tp, EngineConfig(**base), device="cpu")
    ora = Engine(tcfg, tp, EngineConfig(**base, paged_kv=False),
                 device="cpu")
    rng = np.random.default_rng(3)
    t1 = rng.integers(0, cfg.vocab_size, 9)
    t2 = rng.integers(0, cfg.vocab_size, 5)
    r1 = eng.step_mixed([(0, t1), (1, t2)], [])
    r2 = ora.step_mixed([(0, t1), (1, t2)], [])
    assert r1.fused and r2.fused and r1.tokens == r2.tokens
    last = dict(r1.tokens)
    active = [0, 1]
    for i in range(6):
        d1 = eng.decode_batch(active, [last[s] for s in active])
        d2 = ora.decode_batch(active, [last[s] for s in active])
        assert d1 == d2, (i, d1, d2)
        for s in active:
            last[s] = d1[s][0]
            np.testing.assert_allclose(eng.last_logits[s],
                                       ora.last_logits[s], **TOL)
        if i == 3:
            active = [0]
    long_toks = rng.integers(0, cfg.vocab_size, 40)
    assert eng.prefill_long(2, long_toks) == ora.prefill_long(2, long_toks)
    np.testing.assert_allclose(eng.last_logits[2], ora.last_logits[2],
                               **TOL)
    for e in (eng, ora):
        st = e.stats()
        assert st["arena_gathers"] == st["arena_scatters"] == 0
        assert st["dense_dispatches"] == 0
    eng.arena.audit()


def test_precapture_counts_as_the_jax_executors_count(stacks):
    """Running the (L, B) grid, the decode rungs and the packed-arena
    buckets once at init leaves shapes, hit rates and dispatches as the
    JAX executors' compile-only precapture does."""
    cfg, params, tcfg, tp = stacks["qwen3-4b"]
    engines = []
    for packed in (False, True):
        je, te = _pair(stacks["qwen3-4b"], packed=packed, paged_kv=False)
        for e, p in ((je, params), (te, tp)):
            if packed:
                e.packed_executor.precapture_arena(p, e.arena.arena)
            else:
                e.executor.precapture(p, e.arena.gather, lengths=(8, 16),
                                      depths=(1, 2))
            e.decode_executor.precapture(p, e.arena.arena)
        engines.append((je, te))
    for je, te in engines:
        for x in ("executor", "packed_executor", "decode_executor"):
            jx, tx = getattr(je, x), getattr(te, x)
            if jx is None:
                continue
            assert tx.shapes_by_kind() == jx.shapes_by_kind()
            assert tx.hit_rate_by_kind == jx.hit_rate_by_kind
            assert tx.dispatches == jx.dispatches
        assert te.stats()["arena_gathers"] == je.stats()["arena_gathers"]
        assert all(v > 0 for v in te.executor.compile_times.values())
        # precapture parks every write: no session's rows exist yet, and
        # a fresh session's prefill then matches the JAX engine's
        vocab = cfg.vocab_size
        toks = np.arange(1, 12, dtype=np.int32) % vocab
        assert te.prefill_batch([0], [toks]) == je.prefill_batch([0], [toks])
        np.testing.assert_allclose(te.last_logits[0], je.last_logits[0],
                                   **TOL)


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _drive_loop(side, stack, turns, threshold=48):
    """ServeLoop on the launcher default (dense grid + arena decode)
    over a multi-turn trace whose later turns submit only their new
    tokens (a slot keeps its session's history)."""
    cfg, params, tcfg, tp = stack
    kw = dict(num_slots=8, max_len=256, chunk_tokens=32, measure=False,
              packed=False, paged_kv=False)
    if side == "jax":
        engine = JEngine(cfg, params, JConfig(**kw))
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=threshold, chunk_tokens=32)
        loop = JLoop(engine, policy, slo_ttft=2.0, clock=_stepping_clock())
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
        policy = tcore.make_policy(tcore.Variant("pla_full"),
                                   tcore.H200_QWEN32B, threshold=threshold,
                                   chunk_tokens=32)
        loop = ServeLoop(engine, policy, slo_ttft=2.0,
                         clock=_stepping_clock())
    for arrival, wave in itertools.groupby(turns, key=lambda u: u.arrival):
        for u in wave:
            toks = u.tokens if u.turn == 0 else u.tokens[-u.suffix:]
            loop.submit(u.session, toks, decode_tokens=3)
        loop.run_until_idle(max_wall=1e9)
    for sid in sorted(loop.generated):
        loop.decode(sid, 2)
    st = engine.stats()
    return dict(generated=loop.generated,
                report=loop.tracker.report().as_dict(),
                graph_hits=policy.awd.graph_hits,
                dense=st["dense_dispatches_by_cause"],
                counters={k: st.get(k) for k in KEYS},
                slots={s: engine.arena.slot_of(s) for s in loop.generated})


def test_serve_loop_on_the_launcher_default_matches_jax(stacks):
    stack = stacks["qwen3-4b"]
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=stack[0].vocab_size, num_sessions=5, max_turns=3,
        system_len=40, seed=4))
    want = _drive_loop("jax", stack, turns)
    got = _drive_loop("torch", stack, turns)
    assert got == want
    assert got["graph_hits"] > 0
    assert got["dense"]["prefill"]["requested"] > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_overflow_raises_before_the_step_writes(stacks, mode):
    """A step that would push a session past S_max - 2 raises the JAX
    engine's error; the port raises it before writing (a PyTorch write
    out of range is an error, where a JAX scatter drops it), so the
    arena is untouched."""
    je, te = _pair(stacks["qwen3-4b"], max_len=48, **MODES[mode])
    vocab = stacks["qwen3-4b"][0].vocab_size
    toks = (np.arange(40) % (vocab - 1) + 1).astype(np.int32)
    for e in (je, te):
        e.prefill_batch([0], [toks[:30]])
    before = [a.clone() for a in te.arena.arena[0].values()]
    for e in (je, te):
        with pytest.raises(RuntimeError, match="overflows arena"):
            e.prefill_batch([0], [toks[:20]])
    assert all(torch.equal(a, b)
               for a, b in zip(te.arena.arena[0].values(), before))
    assert te.history(0) == 30
