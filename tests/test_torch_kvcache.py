"""Paged KV arena of the PyTorch port against the JAX package's: a seeded
replay of open / prefix-match / extend / commit / fork / free under a
tiny pool (LRU eviction) drives both arenas and must give identical page
ids, refcounts, free lists, counters and a green ``audit()`` after every
step — also with SSM state pages (one per session, boundary-state
checkpoints on the radix index, adoption clamped to a checkpoint, and
truncate's de-index); COW page copies and state checkpoints move the
same pool content; the branches outside the port raise.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_smoke  # noqa: E402
from repro.serving.kvcache import PagedKVArena as JArena  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.serving.kvcache import PagedKVArena as TArena  # noqa: E402

NUM_PAGES, PS, MAX_LEN = 10, 4, 24


def _state(ar):
    ckpt = []
    if ar.index is not None:
        stack = [ar.index.root]
        while stack:
            nd = stack.pop()
            ckpt.append((nd.page, nd.state_page))
            stack.extend(nd.children.values())
    return (dict(ar._pages), dict(ar._tokens), dict(ar.lengths),
            list(ar._refcount), list(ar._free), ar.prefix_hit_tokens,
            ar.chunk_hit_tokens, ar.pages_cow_forked, ar.pages_evicted,
            sorted(ar.index.pages()) if ar.index is not None else None,
            dict(ar.state_pages), ar.state_checkpoints, sorted(ckpt))


def _write(ar, session, toks):
    try:
        pages = ar.prepare_extend(session, len(toks))
    except RuntimeError:
        return None                    # pool exhausted / arena overflow
    ar.commit(session, toks)
    return list(pages)


def _replay(seed, steps, prefix_cache=True, state_slots=False):
    """Apply one seeded op sequence to both arenas in lock step."""
    rng = random.Random(seed)
    kw = dict(prefix_cache=prefix_cache, state_slots=state_slots)
    arenas = (JArena(None, NUM_PAGES, PS, MAX_LEN, **kw),
              TArena(None, NUM_PAGES, PS, MAX_LEN, **kw))
    next_sid = 0
    for _ in range(steps):
        live = sorted(arenas[0]._pages)
        op = rng.choice(["submit", "submit"] + (
            ["extend", "fork", "free", "match_extend"] if live else [])
            + (["truncate"] if live and state_slots else []))
        if op == "submit":
            toks = (list(arenas[0]._tokens[rng.choice(live)])
                    if live and rng.random() < 0.5 else [])
            toks += [rng.randint(0, 3) for _ in range(rng.randint(1, 10))]
            toks = toks[:MAX_LEN - 2]
            next_sid += 1
            outs = []
            for ar in arenas:
                try:
                    m = ar.match_prefix(next_sid, toks)
                except RuntimeError:       # no page left for its state
                    m, w = None, None
                else:
                    w = _write(ar, next_sid, toks[m:])
                if w is None:
                    ar.free(next_sid)
                outs.append((m, w))
            assert outs[0] == outs[1]
        elif op == "extend":
            s = rng.choice(live)
            toks = [rng.randint(0, 3) for _ in range(rng.randint(1, 3))]
            assert _write(arenas[0], s, toks) == _write(arenas[1], s, toks)
        elif op == "match_extend":
            s = rng.choice(live)
            toks = [rng.randint(0, 3) for _ in range(rng.randint(1, 9))]
            assert arenas[0].match_extend(s, toks) == \
                arenas[1].match_extend(s, toks)
        elif op == "fork":
            parent = rng.choice(live)
            next_sid += 1
            for ar in arenas:
                try:
                    ar.fork(parent, next_sid)
                except RuntimeError:       # no page left for its state
                    ar.free(next_sid)
        elif op == "truncate":
            s = rng.choice(live)
            n = rng.randint(0, arenas[0].length(s))
            for ar in arenas:
                ar.truncate(s, n)
        else:
            s = rng.choice(live)
            for ar in arenas:
                ar.free(s)
        for ar in arenas:
            ar.audit()
        assert _state(arenas[0]) == _state(arenas[1])
        assert arenas[1].probe_prefix(toks) == arenas[0].probe_prefix(toks)
    return arenas


@pytest.mark.parametrize("seed", range(12))
def test_replay_matches_jax_arena(seed):
    arenas = _replay(seed, steps=60)
    # drain: freeing every session then evicting everything empties both
    for ar in arenas:
        for s in list(ar._pages):
            ar.free(s)
        ar._evict(NUM_PAGES)
        ar.audit()
        assert ar.free_pages == NUM_PAGES
    assert _state(arenas[0]) == _state(arenas[1])


def test_replay_without_prefix_cache():
    _replay(99, steps=40, prefix_cache=False)


@pytest.mark.parametrize("seed", range(6))
def test_replay_with_state_pages_matches_jax_arena(seed):
    """SSM state pages: each session holds one, commits that land on a
    page boundary checkpoint it into a page owned by the radix node,
    adoption stops at the deepest checkpoint, and eviction and truncate
    release checkpoints; the same page ids, refcounts and checkpoint
    nodes as the JAX arena after every step."""
    arenas = _replay(seed, steps=60, state_slots=True)
    assert arenas[1].state_checkpoints > 0
    for ar in arenas:
        for s in list(ar._pages):
            ar.free(s)
        ar._evict(NUM_PAGES)
        ar.audit()
        assert ar.free_pages == NUM_PAGES
    assert _state(arenas[0]) == _state(arenas[1])


def test_state_checkpoint_moves_the_same_pool_content():
    """A boundary-state checkpoint and its adoption copy the state page
    content as the JAX arena does; a fresh session's state page starts
    at zero (the JAX arena hands out the page's old content)."""
    cfg, tcfg = get_smoke("mamba2-2.7b"), tget("mamba2-2.7b")
    ja = JArena(cfg, 8, PS, 32, state_slots=True)
    ta = TArena(tcfg, 8, PS, 32, state_slots=True, device="cpu")
    rng = np.random.default_rng(1)
    for ar in (ja, ta):
        ar.open(1)
    sp = ta.slot_of(1)
    assert sp == ja.slot_of(1)
    fill = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in ta.arena[0].items()}
    for k, v in fill.items():
        ta.arena[0][k][:, sp] = torch.from_numpy(v[:, sp])
    ja.arena = [{k: jax.numpy.asarray(ta.arena[0][k].numpy())
                 for k in fill}]
    for ar in (ja, ta):
        _write(ar, 1, [1, 2, 3, 4])               # one full page: checkpoint
        assert ar.state_checkpoints == 1
        assert ar.match_prefix(2, [1, 2, 3, 4, 5]) == 4
    assert ta.slot_of(2) == ja.slot_of(2)
    for k in fill:
        np.testing.assert_array_equal(ta.arena[0][k].numpy(),
                                      np.asarray(ja.arena[0][k]))
        np.testing.assert_array_equal(ta.arena[0][k][:, ta.slot_of(2)],
                                      fill[k][:, sp])
    ta.open(3)
    for k in fill:
        assert not ta.arena[0][k][:, ta.slot_of(3)].any()
    ta.audit()


def test_cow_copy_moves_the_same_pool_content():
    """A fork-shared partial boundary page is copied on the first
    diverging write, content and all, exactly as in the JAX arena."""
    cfg, tcfg = get_smoke("qwen3-4b"), tget("qwen3-4b")
    ja = JArena(cfg, 8, PS, 32)
    ta = TArena(tcfg, 8, PS, 32, device="cpu")
    rng = np.random.default_rng(0)
    fill = rng.standard_normal(ja.arena[0]["k"].shape).astype(np.float32)
    ja.arena = [{"k": jax.numpy.asarray(fill), "v": jax.numpy.asarray(-fill)}]
    ta.arena[0]["k"].copy_(torch.from_numpy(fill))
    ta.arena[0]["v"].copy_(torch.from_numpy(-fill))
    for ar in (ja, ta):
        ar.open(1)
        _write(ar, 1, [1, 2, 3, 4, 5, 6])         # one full + one partial
        ar.fork(1, 2)
        _write(ar, 2, [9])                         # COW of the partial page
        ar.audit()
    assert ja.pages_of(2) == ta.pages_of(2) and ta.pages_cow_forked == 1
    for name in ("k", "v"):
        np.testing.assert_array_equal(ta.arena[0][name].numpy(),
                                      np.asarray(ja.arena[0][name]))


def test_branches_outside_the_slice_raise():
    """No branch of the page pool is left outside the port: the host
    spill tier constructs (bookkeeping: a budget in pages) on an
    attention pool and a state-slot pool, and ring tables, as in the
    reference, keep no radix index and refuse forks."""
    for kw in ({}, dict(state_slots=True)):
        spill = TArena(None, 8, PS, 32, host_pool_bytes=1 << 20, **kw)
        assert spill.host_pool_bytes == 1 << 20 and spill._page_bytes == 1
        assert spill.host_pool_pages == spill.pages_spilled == 0
        spill.audit()
    ring = TArena(None, 8, PS, 32, ring_pages=4)
    assert ring.index is None and ring.max_pages_per_seq == 4
    with pytest.raises(AssertionError, match="ring tables cannot fork"):
        ring.fork(0, 1)
