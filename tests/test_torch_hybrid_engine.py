"""The hybrid (jamba) serving engine of the PyTorch port against the JAX
engine, at the jamba-v0.1-52b smoke config in fp32 with converted
weights (4 layers: SSD, SSD, attention, SSD; MoE on the odd ones).

Three modes: the paged default (a session's KV pages and its state page
side by side in one pool, boundary-state checkpoints on the radix
index), the slot arena with its scratch slot (``paged_kv=False``: KV
rows and state in one slot), and the dense (L, B) grid with arena decode
(``packed=False, paged_kv=False``).  The same schedule must commit
identical greedy tokens into identical slots or pages, give logits and
every SSM position's live (ssm, conv) state within 1e-5, and leave
identical counters: state checkpoints, prefix-hit tokens, page tables,
refcounts, dispatches by kind and dense causes; ``audit()`` holds, and
the arena arms copy no slot.

Also: pads confined to the scratch slot or page, speculation off, and
qwen3-moe-30b-a3b's smoke config with 16 experts, whose every MoE step
takes the capacity dispatch on both sides and drops the same pairs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "jamba-v0.1-52b"
MODES = {
    "paged": dict(),
    "arena": dict(paged_kv=False),
    "dense": dict(packed=False, paged_kv=False),
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


def _convert(cfg, tcfg, seed):
    params, _ = jtr.init_params(cfg, jax.random.key(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params),
                                     tcfg, "cpu")


@pytest.fixture(scope="module")
def stack():
    cfg, tcfg = get_smoke(ARCH), tget(ARCH)
    return (cfg, tcfg) + _convert(cfg, tcfg, 24)


def _pair(stack, **kw):
    cfg, tcfg, params, tp = stack
    ecfg = dict(BASE, **kw)
    return (JEngine(cfg, params, JConfig(**ecfg)),
            Engine(tcfg, tp, EngineConfig(**ecfg), device="cpu"))


def _state(e, session):
    """The session's recurrent state, (ssm, conv) of every SSM pattern
    position, as numpy."""
    row = e.arena.slot_of(session)
    return [np.asarray(leaves[k][:, row]) for leaves in e.arena.arena
            if "ssm" in leaves for k in ("ssm", "conv")]


def _same(je, te, sessions):
    """Tokens aside: logits, slots or pages, lengths, live state and
    counters agree."""
    for s in sessions:
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
        assert te.arena.slot_of(s) == je.arena.slot_of(s)
        assert te.history(s) == je.history(s)
        got, want = _state(te, s), _state(je, s)
        assert len(got) == 6                      # 3 SSM positions
        for a, b in zip(got, want):
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
    first goes through the chunked long path, whose chunk commit lands
    on a page boundary and checkpoints the state there; later prompts
    that share it adopt its KV pages and the checkpoint on a page pool."""
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
def test_hybrid_engine_matches_jax(stack, mode):
    je, te = _pair(stack, **MODES[mode])
    vocab = stack[0].vocab_size
    want = _schedule(je, vocab, 1)
    got = _schedule(te, vocab, 1)
    assert got == want
    _same(je, te, range(8))
    st = te.stats()
    if mode == "paged":
        assert te.arena.state_slots and te.arena.ring_pages is None
        assert st["state_checkpoints"] > 0 and st["prefix_hit_tokens"] > 0
        assert st["arena_gathers"] == st["arena_scatters"] == 0
        assert st["dense_dispatches"] == 0
    elif mode == "arena":
        # the packed stream reserves a row for the scratch pad segment
        assert te.packed_executor.max_seqs == BASE["packed_max_seqs"] - 1
        assert te.arena.scratch == BASE["num_slots"]
        # whole slots are copied only for the dense steps the packed
        # stream could not take
        assert st["arena_gathers"] == st["dense_dispatches"] > 0
    else:
        assert te.packed_executor is None
        assert st["dense_dispatches_by_cause"]["prefill"] == {
            "requested": st["dense_dispatches"]}


@pytest.mark.parametrize("paged", [False, True])
def test_state_pads_confined_to_scratch(stack, paged):
    """Ladder pad rows and bucket tails step only the scratch slot or
    page, in the SSM and the attention layers alike: a session decoded
    alone inside a padded rung keeps the state, logits and tokens of a
    pad-free run (the counterpart of test_hybrid_arena's pad hygiene)."""
    cfg, tcfg, params, tp = stack
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, 6)
    outs = []
    for rungs in ((1,), (4,)):           # pad-free vs 3 pad rows per tick
        eng = Engine(tcfg, tp, EngineConfig(
            num_slots=4, max_len=64, token_buckets=(16, 32),
            decode_buckets=rungs, paged_kv=paged), device="cpu")
        seq = [eng.step_mixed([(0, toks)], []).tokens[0]]
        for _ in range(5):
            seq.append(eng.decode_batch([0], [seq[-1]])[0][0])
        assert eng.arena.slot_of(0) != eng.arena.scratch
        outs.append((seq, _state(eng, 0), eng.last_logits[0]))
    (seq_a, st_a, lg_a), (seq_b, st_b, lg_b) = outs
    assert seq_a == seq_b
    np.testing.assert_allclose(lg_a, lg_b, **TOL)
    for a, b in zip(st_a, st_b):
        np.testing.assert_allclose(a, b, **TOL)


def test_paged_engine_matches_slot_engine(stack):
    """The counterpart of test_paged_default's and test_hybrid_arena's
    parity for jamba: the same greedy traffic through the port's page
    pool, the port's slot arena and the JAX slot arena gives the same
    tokens, logits and state, with no whole-slot copy and no dense step
    on any arm."""
    cfg, tcfg, params, tp = stack
    base = dict(num_slots=4, max_len=64, chunk_tokens=16, measure=False,
                token_buckets=(16, 32, 64), decode_buckets=(1, 2, 4))
    engines = [Engine(tcfg, tp, EngineConfig(**base), device="cpu"),
               Engine(tcfg, tp, EngineConfig(**base, paged_kv=False),
                      device="cpu"),
               JEngine(cfg, params, JConfig(**base, paged_kv=False))]
    rng = np.random.default_rng(3)
    t1 = rng.integers(0, cfg.vocab_size, 9)
    t2 = rng.integers(0, cfg.vocab_size, 5)
    rs = [e.step_mixed([(0, t1), (1, t2)], []) for e in engines]
    assert all(r.fused and r.tokens == rs[0].tokens for r in rs)
    last = dict(rs[0].tokens)
    for i in range(4):
        ds = [e.decode_batch([0, 1], [last[0], last[1]]) for e in engines]
        assert ds[1] == ds[0] and ds[2] == ds[0], (i, ds)
        last = {s: ds[0][s][0] for s in (0, 1)}
    long_toks = rng.integers(0, cfg.vocab_size, 40)
    firsts = [e.prefill_long(2, long_toks) for e in engines]
    assert firsts[1] == firsts[0] and firsts[2] == firsts[0]
    for e in engines[1:]:
        for s in (0, 1, 2):
            np.testing.assert_allclose(e.last_logits[s],
                                       engines[0].last_logits[s], **TOL)
            for a, b in zip(_state(e, s), _state(engines[0], s)):
                np.testing.assert_allclose(a, b, **TOL)
    # no arm copied a whole slot or took a dense step
    for e in engines:
        st = e.stats()
        assert st["arena_gathers"] == st["arena_scatters"] == 0
        assert st["dense_dispatches"] == 0
    engines[0].arena.audit()


def test_speculation_stays_off(stack):
    """A hybrid has recurrent state, which has no rollback: as in the
    reference, ``can_spec`` is False and ``enable_spec`` refuses."""
    _, te = _pair(stack)
    assert not te.can_spec and not te.spec_enabled
    with pytest.raises(AssertionError, match="pure-attention"):
        te.enable_spec(object(), k=2)


def test_qwen3_moe_capacity_engine_matches_jax(monkeypatch):
    """qwen3-moe-30b-a3b's smoke config with 16 experts (top 2): more
    than 8, so every MoE step of both engines takes the capacity
    dispatch, whose capacity counts every row of the step, pads
    included.  The paged default gives the JAX engine's tokens, logits
    and counters."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttr
    arch = "qwen3-moe-30b-a3b"
    cfg = get_smoke(arch).replace(num_experts=16)
    tcfg = tget(arch).replace(num_experts=16)
    params, tp = _convert(cfg, tcfg, 26)
    je, te = _pair((cfg, tcfg, params, tp))
    calls = {"capacity": 0, "dense": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(ttr, "moe_layer", counted("capacity", moe.moe_layer))
    monkeypatch.setattr(ttr, "moe_dense_reference",
                        counted("dense", moe.moe_dense_reference))
    want = _schedule(je, cfg.vocab_size, 2)
    got = _schedule(te, cfg.vocab_size, 2)
    assert got == want
    assert calls["capacity"] > 0 and calls["dense"] == 0
    for s in range(8):
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in KEYS} == {k: js.get(k) for k in KEYS}
    assert ts["prefix_hit_tokens"] > 0
    te.arena.audit()
