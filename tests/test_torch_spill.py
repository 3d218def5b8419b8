"""The host spill tier of the port's page pool (``host_pool_bytes > 0``)
against the JAX package's.

* The reference's spill state machines (``tests/test_paged_default.py``:
  seeded and hypothesis-driven random schedules of submits, extends and
  frees under allocation pressure, the host budget in bookkeeping pages)
  are replayed op by op on a JAX and a port bookkeeping arena, on an
  attention pool and on a ``state_slots`` (hybrid) pool, with
  chunk-level matches besides.  After every op both arenas hold the same
  page tables, tokens, refcounts, free list, host-pool keys in LRU
  order and counters, ``audit()`` holds on both, and no live session's
  pages move under another session's spill or promotion traffic.
* ``test_promoted_pages_bit_identical`` through the port's ``Engine`` on
  the CPU beside the JAX engine: pages demoted to the host and promoted
  back on a prefix match hold exactly their bytes from before the spill,
  and exactly the JAX arena's promoted bytes.
* A hybrid engine with a host pool constructs and spills (the whole
  page, SSM leaves included, counted in ``_page_bytes``).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving.kvcache import PagedKVArena as JArena  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.kvcache import PagedKVArena as TArena  # noqa: E402

NUM_PAGES = 8
PS = 4
MAX_LEN = 24
HOST_BUDGET = 6          # bookkeeping mode: _page_bytes == 1
COUNTERS = ("pages_spilled", "pages_promoted", "host_pages_dropped",
            "pages_evicted", "prefix_hit_tokens", "chunk_hit_tokens",
            "pages_cow_forked", "state_checkpoints")


def _write(arena, session, toks):
    h = arena.length(session)
    try:
        arena.prepare_extend(session, len(toks))
    except RuntimeError:
        return False
    arena.commit(session, toks)
    assert arena.length(session) == h + len(toks)
    return True


def _state(ar):
    return (dict(ar._pages), dict(ar._tokens), dict(ar.lengths),
            list(ar._refcount), list(ar._free), dict(ar.state_pages),
            list(ar._host_pool), ar._host_bytes,
            ar.host_pool_pages, tuple(getattr(ar, c) for c in COUNTERS))


class _Refused:
    """What an op that raised RuntimeError (a full pool) returns."""

    def __init__(self, err):
        self.msg = str(err)

    def __eq__(self, other):
        return isinstance(other, _Refused) and other.msg == self.msg


def _both(arenas, fn):
    """Apply ``fn`` to both arenas; they must return alike, or refuse
    alike (a state-slot pool can run out of pages when a session opens)."""
    outs = []
    for ar in arenas:
        try:
            outs.append(fn(ar))
        except RuntimeError as err:
            outs.append(_Refused(err))
    assert outs[0] == outs[1]
    return outs[0]


def _drive_spill(arenas, draw_int, draw_choice, steps, extend_match=False):
    """The reference's random submit / extend / free schedule under
    allocation pressure, each op applied to both arenas; with
    ``extend_match`` an extend first adopts the longest indexed
    continuation (``match_extend``), which may promote too."""
    next_sid = [0]
    transcripts = {}

    def fresh():
        next_sid[0] += 1
        return next_sid[0]

    for _ in range(steps):
        live = _both(arenas, lambda ar: sorted(ar._pages))
        snap = {s: (arenas[1].length(s), list(arenas[1].pages_of(s)),
                    list(arenas[1]._tokens[s])) for s in live}
        ops = ["submit"] + (["extend", "free"] if live else [])
        op = draw_choice(ops)
        target = None
        if op == "submit":
            toks = (list(draw_choice(sorted(transcripts.values(),
                                            key=tuple)))
                    if transcripts and draw_int(0, 1) else [])
            toks += [draw_int(0, 3) for _ in range(draw_int(1, 10))]
            toks = toks[:MAX_LEN - 2]
            target = fresh()
            matched = _both(arenas, lambda ar: ar.match_prefix(target, toks))
            if isinstance(matched, _Refused):
                _both(arenas, lambda ar: ar.free(target))
                target = None
            elif _both(arenas, lambda ar: _write(ar, target,
                                                 toks[matched:])):
                transcripts[target] = list(toks)
            else:
                _both(arenas, lambda ar: ar.free(target))
                target = None
        elif op == "extend":
            target = draw_choice(live)
            ext = [draw_int(0, 3) for _ in range(draw_int(1, 3))]
            if extend_match and transcripts.get(target) and draw_int(0, 1):
                # a returning continuation of another transcript
                other = draw_choice(sorted(transcripts.values(), key=tuple))
                h = arenas[1].length(target)
                ext = list(other[h:h + 9]) + ext
                got = _both(arenas, lambda ar: ar.match_extend(target, ext))
                assert not isinstance(got, _Refused)
                ext = ext[got:]
                if got:
                    transcripts[target] = list(arenas[1]._tokens[target])
            if _both(arenas, lambda ar: _write(ar, target, ext)):
                transcripts[target] = list(arenas[1]._tokens[target])
        else:
            target = draw_choice(live)
            _both(arenas, lambda ar: ar.free(target))
        for ar in arenas:
            ar.audit()
        _both(arenas, _state)
        assert arenas[1].host_pool_pages <= HOST_BUDGET
        # session-pinned pages never spill
        for s, (n, pages, toks_) in snap.items():
            if s == target:
                continue
            assert arenas[1].length(s) == n
            assert arenas[1].pages_of(s) == pages
            assert arenas[1]._tokens[s] == toks_
    for s in list(arenas[1]._pages):
        _both(arenas, lambda ar: ar.free(s))
    _both(arenas, lambda ar: ar._evict(NUM_PAGES))
    for ar in arenas:
        ar.audit()
    _both(arenas, _state)
    assert arenas[1].free_pages == NUM_PAGES


def _arenas(**kw):
    return [cls(None, NUM_PAGES, PS, MAX_LEN, host_pool_bytes=HOST_BUDGET,
                **kw) for cls in (JArena, TArena)]


@pytest.mark.parametrize("seed", range(10))
def test_spill_state_machine_seeded_matches_jax(seed):
    rng = random.Random(seed)
    _drive_spill(_arenas(), rng.randint, rng.choice, steps=50)


@pytest.mark.parametrize("seed", range(4))
def test_spill_state_machine_with_chunk_matches_matches_jax(seed):
    rng = random.Random(100 + seed)
    _drive_spill(_arenas(), rng.randint, rng.choice, steps=60,
                 extend_match=True)


@pytest.mark.parametrize("seed", range(4))
def test_spill_state_machine_state_slots_matches_jax(seed):
    """A hybrid pool: one state page a session, checkpoints on the index
    released (not spilled) when their node spills, host continuations
    not counted by ``probe_prefix``."""
    rng = random.Random(200 + seed)
    arenas = _arenas(state_slots=True)
    _drive_spill(arenas, rng.randint, rng.choice, steps=50,
                 extend_match=True)
    toks = [rng.randint(0, 3) for _ in range(MAX_LEN - 2)]
    _both(arenas, lambda ar: ar.probe_prefix(toks))


def test_spill_pressure_actually_spills():
    """The machine is only a proof if the spill path fires: the
    reference's deterministic pressure schedule demotes AND promotes,
    drops past the budget, and both arenas count it alike."""
    rng = random.Random(1234)
    arenas = _arenas()
    _drive_spill(arenas, rng.randint, rng.choice, steps=120)
    assert arenas[1].pages_spilled > 0
    assert arenas[1].pages_promoted > 0


def test_probe_prefix_counts_host_continuations():
    """A spilled page is still a hit for ``probe_prefix`` (one promotion
    away), on both arenas, until ``match_prefix`` promotes it."""
    arenas = [cls(None, 4, PS, 32, host_pool_bytes=HOST_BUDGET)
              for cls in (JArena, TArena)]
    a = [1, 2, 3, 0, 2, 2, 1, 0, 3, 3]
    b = [0, 1, 1, 2, 3, 3, 0, 1, 2, 1]
    for ar in arenas:
        ar.match_prefix(1, a)
        _write(ar, 1, a)
        ar.free(1)                       # 2 full pages on the index
        ar.match_prefix(2, b)
        _write(ar, 2, b)                 # evicts and spills a's pages
        ar.free(2)
    assert _both(arenas, lambda ar: ar.pages_spilled) >= 1
    assert _both(arenas, lambda ar: ar.probe_prefix(a)) == 8
    assert _both(arenas, lambda ar: ar.match_prefix(3, a)) == 8
    assert _both(arenas, lambda ar: ar.pages_promoted) >= 1
    _both(arenas, _state)


def test_zero_budget_page_drops_every_spill():
    """A budget below one page: each spill is counted and dropped at
    once, as the reference's over-budget sweep drops the new entry."""
    arenas = [cls(None, 4, PS, 32, host_pool_bytes=1) for cls in
              (JArena, TArena)]
    for ar in arenas:
        ar._page_bytes = 2               # a page larger than the budget
    arenas[1]._host_slots.limit = 0
    rng = random.Random(5)
    for step in range(30):
        toks = [rng.randint(0, 3) for _ in range(rng.randint(4, 12))]
        m = _both(arenas, lambda ar: ar.match_prefix(step, toks))
        _both(arenas, lambda ar: _write(ar, step, toks[m:]))
        _both(arenas, lambda ar: ar.free(step))
        for ar in arenas:
            ar.audit()
        _both(arenas, _state)
    assert arenas[1].pages_spilled == arenas[1].host_pages_dropped > 0
    assert arenas[1].host_pool_pages == 0


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_spill_state_machine_hypothesis_matches_jax(data):
    _drive_spill(_arenas(),
                 lambda lo, hi: data.draw(st.integers(lo, hi)),
                 lambda seq: data.draw(st.sampled_from(list(seq))),
                 steps=data.draw(st.integers(5, 40), label="steps"))


# ------------------------------------------------------- device arenas
@pytest.fixture(scope="module")
def qwen():
    cfg = get_smoke("qwen3-4b")
    params, _ = jtr.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params),
                           tget("qwen3-4b"), "cpu")
    return cfg, params, tget("qwen3-4b"), tp


def _page(arena, p):
    return [{n: a[:, p].clone() for n, a in leaves.items()}
            for leaves in arena.arena]


def test_promoted_pages_bit_identical(qwen):
    """The reference's schedule (``test_paged_default.py``) on both
    engines: three full pages are closed onto the index, two throwaway
    sessions exhaust the 8-page pool and force them through the spill
    path, and a resubmission promotes them back.  The port's promoted
    pages equal, bit for bit, snapshots (clones) taken before the spill
    and the JAX arena's promoted pages (the port's pool holds the JAX
    pool's bytes from the first prefill on)."""
    cfg, params, tcfg, tp = qwen
    ecfg = dict(num_slots=2, max_len=64, page_size=8, num_pages=8,
                chunk_tokens=16, token_buckets=(16, 32),
                decode_buckets=(1, 2), host_pool_bytes=256 << 20,
                measure=False)
    je = JEngine(cfg, params, JConfig(**ecfg))
    te = Engine(tcfg, tp, EngineConfig(**ecfg), device="cpu")
    rng = np.random.default_rng(21)
    toks = [int(t) for t in rng.integers(0, cfg.vocab_size, 25)]
    long_p = rng.integers(0, cfg.vocab_size, 40)
    third = rng.integers(0, cfg.vocab_size, 24)
    for e in (je, te):
        e.prefill_batch([0], [np.asarray(toks)])
    # the two engines' KV agree to 1e-5 (XLA and PyTorch sum in other
    # orders); the port's pool then takes the JAX pool's bytes in place,
    # so what the tier moves can be held to the JAX arena's bytes exactly
    for tleaves, jleaves in zip(te.arena.arena, je.arena.arena):
        for name, a in tleaves.items():
            want = np.array(jleaves[name])
            np.testing.assert_allclose(a.numpy(), want, atol=1e-5)
            a.copy_(torch.from_numpy(want))
    snap = [_page(te.arena, p) for p in list(te.arena.pages_of(0))[:3]]
    for e in (je, te):
        ar = e.arena
        e.close_session(0)
        e.prefill_long(1, long_p)
        e.prefill_batch([2], [third])
        assert ar.pages_spilled >= 3
        e.close_session(1)
        e.close_session(2)
        assert ar.match_prefix(9, toks) == 24 and ar.pages_promoted >= 3
        ar.audit()
    ta, ja = te.arena, je.arena
    assert ta.pages_of(9) == ja.pages_of(9)
    assert list(ta._host_pool) == list(ja._host_pool)
    for c in ("pages_spilled", "pages_promoted", "host_pages_dropped",
              "pages_evicted"):
        assert getattr(ta, c) == getattr(ja, c)
    assert ta._page_bytes == ja._page_bytes
    for want, p in zip(snap, ta.pages_of(9)):
        got = _page(ta, p)
        for w, g, jleaves in zip(want, got, ja.arena):
            for name in w:
                assert torch.equal(w[name], g[name])
                np.testing.assert_array_equal(
                    g[name].numpy(), np.asarray(jleaves[name][:, p]))
    st_ = te.stats()
    assert st_["pages_promoted"] == ta.pages_promoted > 0
    assert st_["pages_spilled"] == ta.pages_spilled
    assert st_["host_pool_pages"] == ta.host_pool_pages
    assert st_["host_pages_dropped"] == 0
    assert st_["handoff_host_bytes"] == 0
    # the slot store: the budget's pages and one slot more
    assert ta._host_slots.size == (256 << 20) // ta._page_bytes + 1
    assert ta.host_pinned_bytes == ta._host_slots.size * ta._page_bytes


def test_hybrid_engine_with_a_host_pool_spills():
    """jamba's smoke config with a host pool: the engine constructs, a
    page spills whole (``_page_bytes`` counts the SSM leaves of the page
    as the reference does) and the counters equal the JAX engine's."""
    arch = "jamba-v0.1-52b"
    cfg, tcfg = get_smoke(arch), tget(arch)
    params, _ = jtr.init_params(cfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    ecfg = dict(num_slots=2, max_len=64, page_size=8, num_pages=10,
                chunk_tokens=16, token_buckets=(16, 32),
                decode_buckets=(1, 2), host_pool_bytes=64 << 20,
                measure=False)
    je = JEngine(cfg, params, JConfig(**ecfg))
    te = Engine(tcfg, tp, EngineConfig(**ecfg), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (25, 33, 20, 25)]
    prompts[3][:24] = prompts[0][:24]
    for e in (je, te):
        for s, p in enumerate(prompts):
            e.prefill_batch([s], [p])
            e.close_session(s)
        e.arena.audit()
    ta, ja = te.arena, je.arena
    assert ta.state_slots and ta._page_bytes == ja._page_bytes
    ssm = sum(a[:, 0].numel() * a.element_size() for leaves in ta.arena
              for n, a in leaves.items() if n in ("ssm", "conv"))
    assert 0 < ssm < ta._page_bytes
    keys = ("pages_spilled", "pages_promoted", "host_pool_pages",
            "host_pages_dropped", "pages_evicted", "prefix_hit_tokens",
            "state_checkpoints")
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["pages_spilled"] > 0
    assert list(ta._host_pool) == list(ja._host_pool)
