"""The SSM (mamba2) serving engine of the PyTorch port against the JAX
engine, at the mamba2-2.7b smoke config in fp32 with converted weights.

Three modes: the paged default (a state page per session, boundary-state
checkpoints on the radix index), the slot arena with its scratch slot
(``paged_kv=False``), and the dense (L, B) grid with arena decode
(``packed=False, paged_kv=False``, the serve launcher's default); plus
``arena_prefill=False``, which has no packed step for an SSM stack (the
gathered form is attention-only) and runs the dense grid.  The same
schedule must commit identical greedy tokens into identical slots or
pages, give logits and live recurrent state within 1e-5, and leave
identical counters: state checkpoints, prefix-hit tokens, page tables,
refcounts, dispatches by kind and dense causes; ``audit()`` holds.

Also: pads confined to the scratch slot / page, the paged engine against
the slot engine, ServeLoop against the JAX loop, speculation off, and a
reused slot or page starting from a zero state.
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
from repro.core.awd import AWDConfig  # noqa: E402
from repro.data.synthetic import (MultiTurnConfig,  # noqa: E402
                                  gen_multiturn_sessions)
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving.loop import ServeLoop as JLoop  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.core.awd import AWDConfig as TAWDConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "mamba2-2.7b"
MODES = {
    "paged": dict(),
    "arena": dict(paged_kv=False),
    "dense": dict(packed=False, paged_kv=False),
    "gathered": dict(paged_kv=False, arena_prefill=False),
}
BASE = dict(num_slots=8, max_len=96, chunk_tokens=16, measure=False,
            token_buckets=(16, 32), packed_max_seqs=4,
            decode_buckets=(1, 2, 4))
# counters that must agree between the two engines
KEYS = ("arena_gathers", "arena_scatters", "dense_dispatches",
        "dense_dispatches_by_cause", "graph_hit_rate", "captured_shapes",
        "hit_rate_by_kind", "useful_tokens", "padded_tokens", "free_slots",
        "decode_shapes", "decode_dispatches", "decode_useful_rows",
        "decode_pad_rows", "packed_shapes", "packed_dispatches",
        "packed_useful_tokens", "packed_padded_tokens",
        "packed_shapes_by_kind", "mixed_steps", "decode_tokens_fused",
        "logits_rows_shipped", "fit_samples", "prefix_hit_tokens",
        "chunk_hit_tokens", "state_checkpoints", "pages_evicted",
        "free_pages", "radix_pages")


@pytest.fixture(scope="module")
def stack():
    cfg, tcfg = get_smoke(ARCH), tget(ARCH)
    params, _ = jtr.init_params(cfg, jax.random.key(23))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tp


def _pair(stack, **kw):
    cfg, params, tcfg, tp = stack
    ecfg = dict(BASE, **kw)
    return (JEngine(cfg, params, JConfig(**ecfg)),
            Engine(tcfg, tp, EngineConfig(**ecfg), device="cpu"))


def _state(e, session):
    """The session's recurrent state (ssm, conv) as numpy."""
    row = e.arena.slot_of(session)
    leaves = e.arena.arena[0]
    return [np.asarray(leaves[k][:, row]) for k in ("ssm", "conv")]


def _same(je, te, sessions):
    """Tokens aside: logits, slots or pages, lengths, live state and
    counters agree."""
    for s in sessions:
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
        assert te.arena.slot_of(s) == je.arena.slot_of(s)
        assert te.history(s) == je.history(s)
        for a, b in zip(_state(te, s), _state(je, s)):
            np.testing.assert_allclose(a, b, **TOL)
    if je._paged:
        ja, ta = je.arena, te.arena
        assert ta._pages == ja._pages and ta._tokens == ja._tokens
        assert ta._refcount == ja._refcount
        assert sorted(ta._free) == sorted(ja._free)
        assert ta.state_pages == ja.state_pages
        ta.audit()
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in KEYS} == {k: js.get(k) for k in KEYS}
    for x in ("executor", "packed_executor", "decode_executor"):
        jx, tx = getattr(je, x), getattr(te, x)
        assert (jx is None) == (tx is None)
        if jx is not None:
            assert tx.shapes_by_kind() == jx.shapes_by_kind()
            assert tx.dispatches == jx.dispatches


def _schedule(e, vocab, seed):
    """Every engine entry point.  A 16-token system prompt (one page)
    first goes through the chunked long path, whose chunk commits land
    on page boundaries and checkpoint the state there; later prompts
    that share it adopt the checkpoint on a page pool."""
    rng = np.random.default_rng(seed)

    def p(n):
        return rng.integers(1, vocab, n).astype(np.int32)

    system = p(16)
    out = [e.prefill_long(0, np.concatenate([system, p(30)]))]
    out.append(e.prefill_batch([1, 2], [np.concatenate([system, p(9)]),
                                        p(5)]))               # on the ladder
    out.append(e.prefill_batch([3], [p(7)], bucket=(8, 2)))   # pinned (L, B)
    r = e.step_mixed([(4, np.concatenate([system, p(6)]))],
                     [(0, out[0]), (1, out[1][1])])           # fused
    out.append((r.tokens, r.fused))
    r = e.step_mixed([(5, p(40))], [(2, out[1][2])])          # off-ladder
    out.append((r.tokens, r.fused))
    r = e.step_mixed([(6, p(3)), (7, p(4))],
                     [(0, 1), (1, 2), (3, 3)])                # over max_seqs
    out.append((r.tokens, r.fused))
    out.append(e.prefill_batch([0], [p(4)]))                  # re-prefill
    out.append(e.decode_batch([0, 1, 2], [5, 6, 7], steps=2))  # rung 4
    out.append(e.decode_batch(list(range(8)), list(range(8)), steps=1))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ssm_engine_matches_jax(stack, mode):
    je, te = _pair(stack, **MODES[mode])
    vocab = stack[0].vocab_size
    want = _schedule(je, vocab, 1)
    got = _schedule(te, vocab, 1)
    assert got == want
    _same(je, te, range(8))
    st = te.stats()
    if mode == "paged":
        assert st["state_checkpoints"] > 0 and st["prefix_hit_tokens"] > 0
        assert st["arena_gathers"] == st["dense_dispatches"] == 0
    elif mode == "arena":
        # the packed stream reserves a row for the scratch pad segment
        assert te.packed_executor.max_seqs == BASE["packed_max_seqs"] - 1
        assert te.arena.scratch == BASE["num_slots"]
        assert st["dense_dispatches_by_cause"]["prefill"]["forced"] > 0
    else:
        assert te.packed_executor is None
        assert st["dense_dispatches_by_cause"]["prefill"] == {
            "requested": st["dense_dispatches"]}


@pytest.mark.parametrize("paged", [False, True])
def test_state_pads_confined_to_scratch(stack, paged):
    """The counterpart of test_hybrid_arena's pad hygiene: ladder pad
    rows and bucket tails step only the scratch slot or page, so a
    session decoded alone inside a padded rung keeps the state and
    tokens of a pad-free run."""
    cfg, params, tcfg, tp = stack
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, 6)
    outs = []
    for rungs in ((1,), (4,)):           # pad-free vs 3 pad rows per tick
        eng = Engine(tcfg, tp, EngineConfig(
            num_slots=4, max_len=64, token_buckets=(16, 32),
            decode_buckets=rungs, paged_kv=paged), device="cpu")
        seq = [eng.step_mixed([(0, toks)], []).tokens[0]]
        for _ in range(5):
            seq.append(eng.decode_batch([0], [seq[-1]])[0][0])
        outs.append((seq, _state(eng, 0)))
    (seq_a, st_a), (seq_b, st_b) = outs
    assert seq_a == seq_b
    for a, b in zip(st_a, st_b):
        np.testing.assert_allclose(a, b, **TOL)


def test_paged_engine_matches_slot_engine(stack):
    """The counterpart of test_paged_default's parity for mamba2: the
    same greedy traffic through the port's page pool and its slot arena
    gives the same tokens and logits, with no whole-slot copy and no
    dense step on the paged side."""
    cfg, params, tcfg, tp = stack
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
    st = eng.stats()
    assert st["arena_gathers"] == st["arena_scatters"] == 0
    assert st["dense_dispatches"] == 0
    eng.arena.audit()


def test_reused_slot_or_page_starts_from_zero_state(stack):
    """A session that takes over a closed session's slot or state page
    gets the logits of a fresh engine: ``alloc`` / ``open`` zero the
    recurrent state.  (The JAX arenas hand the old state over: ROADMAP
    Queue 3.)"""
    cfg, params, tcfg, tp = stack
    rng = np.random.default_rng(5)
    first, prompt = (rng.integers(1, cfg.vocab_size, n) for n in (20, 12))
    for mode in ("paged", "arena", "dense"):
        kw = dict(BASE, num_slots=2, packed_max_seqs=2, decode_buckets=(1,),
                  **MODES[mode])
        used = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
        used.prefill_batch([0], [first])
        used.close_session(0)
        used.prefill_batch([1], [prompt])
        fresh = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
        fresh.prefill_batch([1], [prompt])
        np.testing.assert_array_equal(used.last_logits[1],
                                      fresh.last_logits[1])


def test_speculation_stays_off(stack):
    """An SSM stack has no rollback of its recurrent state: as in the
    reference, ``can_spec`` is False and ``enable_spec`` refuses."""
    _, te = _pair(stack)
    assert not te.can_spec and not te.spec_enabled
    with pytest.raises(AssertionError, match="pure-attention"):
        te.enable_spec(object(), k=2)


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _drive_loop(side, stack, turns, mode):
    cfg, params, tcfg, tp = stack
    kw = dict(num_slots=8, max_len=256, chunk_tokens=32, measure=False,
              **MODES[mode])
    jax_side = side == "jax"
    if jax_side:
        engine = JEngine(cfg, params, JConfig(**kw))
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
    awd = None
    if engine.packed_executor is not None:
        awd = (AWDConfig if jax_side else TAWDConfig)(
            packed=True, token_buckets=engine.ecfg.token_buckets,
            packed_max_seqs=engine.packed_executor.max_seqs)
    if jax_side:
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=48, chunk_tokens=32, awd_cfg=awd)
        loop = JLoop(engine, policy, slo_ttft=2.0, clock=_stepping_clock())
    else:
        policy = tcore.make_policy(tcore.Variant("pla_full"),
                                   tcore.H200_QWEN32B, threshold=48,
                                   chunk_tokens=32, awd_cfg=awd)
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
                dense=st["dense_dispatches_by_cause"],
                counters={k: st.get(k) for k in KEYS},
                slots={s: engine.arena.slot_of(s) for s in loop.generated})


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_serve_loop_matches_jax(stack, mode):
    """ServeLoop over a multi-turn trace sharing a system prompt, on the
    paged default (state checkpoints, prefix adoption) and on the
    launcher's default (dense grid + arena decode): the same transcripts,
    report and counters as the JAX loop."""
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=stack[0].vocab_size, num_sessions=4, max_turns=2,
        system_len=32, seed=4))
    want = _drive_loop("jax", stack, turns, mode)
    got = _drive_loop("torch", stack, turns, mode)
    assert got == want
    if mode == "paged":
        assert got["counters"]["state_checkpoints"] > 0
        assert got["counters"]["prefix_hit_tokens"] > 0
