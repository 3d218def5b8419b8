"""The serving engine of the PyTorch port on a sliding-window MoE
config (the mixtral-8x7b smoke config: window 32, 4 experts top 2,
fp32) against the JAX engine, with converted weights, in the reference
engine's three windowed layouts:

  * ``swa_paged`` (the default): ring page tables of
    ceil((window + C_l) / page_size) pages a session, the radix index
    off;
  * ``swa_slot_arena`` (``paged_kv=False``): rolling slots of depth
    window + C_l plus a scratch slot, a segment longer than C_l split
    across packed steps (``_step_split``);
  * ``swa_dense`` (``packed=False, paged_kv=False``): full-depth slots
    with the window masked, the dense (L, B) grid and the dense decode
    step (no decode executor).

One schedule through every entry point runs sessions several windows
past the window (100-token chunked prompts, 30 decode steps, histories
up to ~170) and segments longer than the margin (20 and 40 tokens).  It
must commit the same greedy tokens into the same ring pages or slots,
give logits within 1e-5, and leave the same counters: dispatches by
kind and dense causes, split steps, ring pages per session.  The JAX
engine runs once per mode (a module fixture).  Also: ServeLoop against
the JAX loop on the paged default, pads confined to the scratch slot of
a rolling arena, and speculation off on rolling arenas.

Tolerance: fp32 atol = rtol = 1e-5.  Runs in ~31 s in the tier-1
command (6 workers, ``--dist loadfile``).
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
ARCH = "mixtral-8x7b"
MODES = {
    "swa_paged": dict(),
    "swa_slot_arena": dict(paged_kv=False),
    "swa_dense": dict(packed=False, paged_kv=False),
}
BASE = dict(num_slots=6, max_len=192, chunk_tokens=16, measure=False,
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
        "pages_evicted", "free_pages", "radix_pages")


@pytest.fixture(scope="module")
def stack():
    cfg, tcfg = get_smoke(ARCH), tget(ARCH)
    params, _ = jtr.init_params(cfg, jax.random.key(31))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tp


def _count_splits(engine):
    """Count the engine's ``_step_split`` calls (the packed split of a
    segment over the margin or an off-ladder mix)."""
    inner = engine._step_split
    engine.splits = 0

    def split(*a, **kw):
        engine.splits += 1
        return inner(*a, **kw)

    engine._step_split = split
    return engine


def _schedule(e, vocab, seed):
    """Every engine entry point, sessions running several windows past
    the window of 32."""
    rng = np.random.default_rng(seed)

    def p(n):
        return rng.integers(1, vocab, n).astype(np.int32)

    out = [e.prefill_long(0, p(100))]                          # chunked
    out.append(e.prefill_batch([1, 2], [p(9), p(20)]))         # 20 > C_l
    out.append(e.prefill_batch([3], [p(7)], bucket=(8, 2)))    # pinned
    r = e.step_mixed([(4, p(6))], [(0, out[0]), (1, out[1][1])])
    out.append((r.tokens, r.fused))
    r = e.step_mixed([(5, p(40))], [(2, out[1][2])])           # off-ladder
    out.append((r.tokens, r.fused))
    r = e.step_mixed([(1, p(3)), (3, p(4))],
                     [(0, 1), (2, 2), (4, 3)])                 # > max_seqs
    out.append((r.tokens, r.fused))
    out.append(e.decode_batch([0, 1, 2], [5, 6, 7], steps=30))  # rung 4
    out.append(e.prefill_batch([5], [p(12)]))                  # re-prefill
    out.append(e.decode_batch(list(range(6)), list(range(6)), steps=2))
    return out


@pytest.fixture(scope="module")
def jax_runs(stack):
    """The JAX engine through the schedule, once per mode."""
    cfg, params, _, _ = stack
    runs = {}
    for mode, kw in MODES.items():
        je = _count_splits(JEngine(cfg, params, JConfig(**BASE, **kw)))
        runs[mode] = (je, _schedule(je, cfg.vocab_size, 1))
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_window_engine_matches_jax(stack, jax_runs, mode):
    _, _, tcfg, tp = stack
    je, want = jax_runs[mode]
    te = _count_splits(Engine(tcfg, tp, EngineConfig(**BASE, **MODES[mode]),
                              device="cpu"))
    got = _schedule(te, tcfg.vocab_size, 1)
    assert got == want
    for s in range(6):
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
        assert te.history(s) == je.history(s)
        assert te.arena.slot_of(s) == je.arena.slot_of(s)
    assert max(te.history(s) for s in range(6)) > 4 * tcfg.sliding_window
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in KEYS} == {k: js.get(k) for k in KEYS}
    assert te.splits == je.splits
    for x in ("executor", "packed_executor", "decode_executor"):
        jx, tx = getattr(je, x), getattr(te, x)
        assert (jx is None) == (tx is None)
        if jx is not None:
            assert tx.shapes_by_kind() == jx.shapes_by_kind()
            assert tx.dispatches == jx.dispatches
    window, margin = tcfg.sliding_window, BASE["chunk_tokens"]
    depth = window + margin
    if mode == "swa_paged":
        ring = -(-depth // te.arena.page_size)
        assert te.arena.ring_pages == je.arena.ring_pages == ring
        assert te.arena.index is None and je.arena.index is None
        assert te.arena._pages == je.arena._pages      # ring pages
        assert all(len(pg) <= ring for pg in te.arena._pages.values())
        assert te.arena._refcount == je.arena._refcount
        te.arena.audit()
        assert ts["dense_dispatches"] == 0 and te.splits > 0
    elif mode == "swa_slot_arena":
        assert te._rolling and te.arena.arena[0]["k"].shape[2] == depth
        assert te.arena.scratch == BASE["num_slots"]
        assert ts["dense_dispatches"] == 0 and te.splits > 0
    else:
        assert not te._rolling and te.decode_executor is None
        assert te.arena.arena[0]["k"].shape[2] == BASE["max_len"]
        assert set(ts["dense_dispatches_by_cause"]["decode"]) == \
            {"requested"}


def test_rolling_pads_confined_to_scratch(stack):
    """Ladder pad rows and bucket tails write only the scratch slot of
    a rolling arena: a session decoded alone inside a padded rung keeps
    the tokens and logits of a pad-free run, past several windows."""
    cfg, params, tcfg, tp = stack
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, 12)
    runs = []
    for rungs in ((1,), (4,)):            # pad-free vs 3 pad rows a tick
        eng = Engine(tcfg, tp, EngineConfig(
            num_slots=4, max_len=192, chunk_tokens=16, token_buckets=(16,),
            decode_buckets=rungs, paged_kv=False), device="cpu")
        seq = [eng.step_mixed([(0, toks)], []).tokens[0]]
        for _ in range(100):
            seq.append(eng.decode_batch([0], [seq[-1]])[0][0])
        runs.append((seq, eng.last_logits[0]))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_allclose(runs[0][1], runs[1][1], **TOL)


@pytest.mark.parametrize("mode", ["swa_paged", "swa_slot_arena"])
def test_speculation_stays_off(stack, mode):
    """A ring or rolling slot has already overwritten what a rejected
    tail wrote over: as in the reference, ``can_spec`` is False."""
    _, _, tcfg, tp = stack
    te = Engine(tcfg, tp, EngineConfig(**BASE, **MODES[mode]), device="cpu")
    assert not te.can_spec
    with pytest.raises(AssertionError, match="pure-attention"):
        te.enable_spec(object(), k=2)


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _drive_loop(side, stack, turns):
    cfg, params, tcfg, tp = stack
    kw = dict(num_slots=4, max_len=256, chunk_tokens=16, measure=False)
    jax_side = side == "jax"
    if jax_side:
        engine = JEngine(cfg, params, JConfig(**kw))
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
    awd = (AWDConfig if jax_side else TAWDConfig)(
        packed=True, token_buckets=engine.ecfg.token_buckets,
        packed_max_seqs=engine.packed_executor.max_seqs)
    if jax_side:
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=24, chunk_tokens=16, awd_cfg=awd)
        loop = JLoop(engine, policy, slo_ttft=2.0, clock=_stepping_clock())
    else:
        policy = tcore.make_policy(tcore.Variant("pla_full"),
                                   tcore.H200_QWEN32B, threshold=24,
                                   chunk_tokens=16, awd_cfg=awd)
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
                counters={k: st.get(k) for k in KEYS},
                pages={s: engine.arena.pages_of(s) for s in loop.generated})


def test_serve_loop_matches_jax(stack):
    """ServeLoop over a multi-turn trace on the ring-table default:
    the JAX loop's transcripts, report, counters and ring pages."""
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=stack[0].vocab_size, num_sessions=3, max_turns=2,
        system_len=24, seed=4))
    want = _drive_loop("jax", stack, turns)
    got = _drive_loop("torch", stack, turns)
    assert got == want
