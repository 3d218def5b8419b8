"""The hybrid (jamba) stack and the last MoE config (qwen3-moe-30b-a3b)
of the PyTorch port against the JAX package, with weights converted
from the JAX init and inputs from numpy seeds, in fp32.

The two configs field by field; the layer pattern (period, each layer's
group, position, mixer and FFN); the converted tree's leaves against
the port's own ``init_params`` and ``param_shapes``; and the hybrid
stack's ``forward`` (without caches, and with caches: the dense (L, B)
grid and the (B, 1) decode step), ``forward_packed_paged`` and
``forward_decode_paged`` over a page pool whose attention positions
hold KV pages and whose SSM positions hold state pages, and
``forward_packed_arena`` / ``forward_decode_arena`` over a slot arena
with a scratch slot.  Each at jamba's smoke config (4 layers, one
pattern group) and at an 8-layer variant of it (two groups): layer i is
group i // 4, position i % 4, and only with two groups does a loop that
walks positions outermost give other logits.  qwen3-moe's smoke config
with 16 experts takes the capacity dispatch in ``forward``.

Tolerance: atol = rtol = 1e-5 (fp32; summation order).  Scratch slots,
scratch pages and park rows, where pads write in an order neither side
defines, are not compared.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_full  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_config as tget_full  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import _leaf_shapes  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
JAMBA, QMOE = "jamba-v0.1-52b", "qwen3-moe-30b-a3b"
# jamba's smoke config (period 4: attention at 2, MoE on odd layers)
# and the same pattern twice
VARIANTS = {"smoke": 4, "two_groups": 8}
S_MAX, SLOTS = 40, 5


def _cfgs(layers):
    return (get_smoke(JAMBA).replace(num_layers=layers),
            tget(JAMBA).replace(num_layers=layers))


_STACKS = {}


def _stack(variant):
    if variant not in _STACKS:
        cfg, tcfg = _cfgs(VARIANTS[variant])
        params, _ = jtr.init_params(cfg, jax.random.key(24))
        tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
        _STACKS[variant] = (cfg, params, tcfg, tp)
    return _STACKS[variant]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("arch", [JAMBA, QMOE])
def test_configs_match_the_reference(arch):
    """Published and smoke configs equal the reference's field by
    field, and both are registered."""
    assert _fields(tget_full(arch)) == _fields(jget_full(arch))
    assert _fields(tget(arch)) == _fields(get_smoke(arch))


def test_layer_pattern():
    """jamba: period lcm(8, 2) = 8 at full size (4 groups), lcm(4, 2) =
    4 in the smoke config; layer i is group i // p, position i % p,
    attention where i % 8 == 4 (smoke: 2), MoE on odd layers.  Every
    other config has period 1.  A depth off the period is refused."""
    full = tget_full(JAMBA)
    assert tr.pattern_period(full) == 8 and tr.num_groups(full) == 4
    kinds = ["attn" if i % 8 == 4 else "ssm" for i in range(32)]
    assert [full.layer_kind(i % 8) for i in range(32)] == kinds
    assert [full.layer_is_moe(i % 8) for i in range(32)] == \
        [i % 2 == 1 for i in range(32)]
    for layers in VARIANTS.values():
        _, tcfg = _cfgs(layers)
        assert tr.pattern_period(tcfg) == 4
        assert tr.num_groups(tcfg) == layers // 4
        assert tr.pattern_period(tcfg) == jtr.pattern_period(_cfgs(layers)[0])
    assert tr.pattern_period(tget_full(QMOE)) == 1
    assert tr.num_groups(tget_full(QMOE)) == 48
    with pytest.raises(ValueError, match="multiple of the layer pattern"):
        tr.num_groups(full.replace(num_layers=12))
    # one block per position, each with its own mixer and FFN
    p = tr.param_shapes(full)
    assert len(p["blocks"]) == 8
    for j, blk in enumerate(p["blocks"]):
        assert ("wq" in blk["mixer"]) == (j == 4)
        assert ("in_proj" in blk["mixer"]) == (j != 4)
        assert ("router" in blk["ffn"]) == (j % 2 == 1)
        assert blk["ln1"].shape == blk["ln2"].shape == (4, full.d_model)
    moe = p["blocks"][1]["ffn"]
    assert tuple(moe["wg"].shape) == (4, 16, 4096, 14336)
    assert tuple(p["blocks"][0]["mixer"]["in_proj"].shape) == \
        (4, 4096, 2 * 8192 + 2 * 8 * 128 + 128)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converted_tree_structure(variant):
    """The converted JAX tree, the port's ``init_params`` and its
    ``param_shapes`` have the same leaf paths and shapes; a tree with a
    position's leaf missing or reshaped is refused."""
    cfg, params, tcfg, tp = _stack(variant)
    want = _leaf_shapes(tr.param_shapes(tcfg))
    assert _leaf_shapes(tp) == want
    assert _leaf_shapes(tr.init_params(tcfg, seed=0, device="cpu")) == want
    assert _leaf_shapes(jax.tree.map(np.asarray, params)) == want
    assert len(tp["blocks"]) == tr.pattern_period(tcfg)
    bad = jax.tree.map(np.asarray, params)
    del bad["blocks"][1]["ffn"]["router"]
    with pytest.raises(ValueError, match="blocks/1/ffn/router"):
        params_from_numpy(bad, tcfg, "cpu")
    bad = jax.tree.map(np.asarray, params)
    bad["blocks"][2]["mixer"]["wq"] = bad["blocks"][2]["mixer"]["wq"][:, 1:]
    with pytest.raises(ValueError, match="blocks/2/mixer/wq"):
        params_from_numpy(bad, tcfg, "cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    cfg, params, tcfg, tp = _stack(variant)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32)
    want, _, jaux = jtr.forward(params, cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tr.forward(tp, tcfg, _t(toks), return_aux=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def _cache_np(cfg, batch, depth, seed):
    """A cache of ``batch`` rows with every leaf random: KV at the
    attention positions, (ssm, conv) state at the SSM ones."""
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(np.shape(a)).astype(np.float32)
             for k, a in c.items()}
            for c in jtr.init_cache(cfg, batch, depth)]


def _both(cache):
    return ([{k: jnp.asarray(a) for k, a in c.items()} for c in cache],
            [{k: _t(a) for k, a in c.items()} for c in cache])


def _same(tcache, jcache, rows=None, skip_park=False):
    """Every leaf equal, on ``rows`` of the row axis (all by default);
    KV leaves without the park position S - 1 where asked."""
    for tc, jc in zip(tcache, jcache):
        for k in tc:
            got, want = tc[k].numpy(), _np(jc[k])
            if rows is not None:
                got, want = got[:, rows], want[:, rows]
            if skip_park and k in ("k", "v"):
                got, want = got[:, :, :-1], want[:, :, :-1]
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_with_caches_matches_jax(variant):
    """The dense (L, B) grid step over caches holding KV and state (a
    fresh row and a shorter row padded through ``seq_valid_len``), then
    a (B, 1) decode step, caches carried in place."""
    cfg, params, tcfg, tp = _stack(variant)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    vl = np.array([12, 7], np.int32)
    jc = jtr.init_cache(cfg, 2, 32)
    tc = tr.init_cache(tcfg, 2, 32, device="cpu")
    want, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(toks),
                              caches=jc, seq_valid_len=jnp.asarray(vl))
    with torch.no_grad():
        got = tr.forward(tp, tcfg, _t(toks), caches=tc, seq_valid_len=_t(vl))
    for i, n in enumerate(vl):
        np.testing.assert_allclose(got.numpy()[i, :n], _np(want)[i, :n],
                                   **TOL)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    pos = vl[:, None].astype(np.int32)
    want, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(nxt),
                              positions=jnp.asarray(pos), caches=jc,
                              logits_slice="last")
    with torch.no_grad():
        got = tr.forward(tp, tcfg, _t(nxt), _t(pos), caches=tc,
                         logits_slice="last")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    _same(tc, jc)


def _paged_inputs(cfg, seed):
    """A packed stream over a fragmented pool of 4-token pages: a
    re-prefill at history 6, a fresh prefill, a decode row at history 9,
    a pad segment and three tail rows; each live segment's state page
    apart from its KV pages, the pad's the scratch page."""
    rng = np.random.default_rng(seed)
    ps, n_pages, p_max = 4, 24, 8
    lens, hists = [5, 7, 1, 0], [6, 0, 9, 0]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    t = int(cu[-1]) + 3
    free = list(rng.permutation(n_pages))
    table = np.full((4, p_max), n_pages, np.int32)   # scratch = n_pages
    for i, (n, h) in enumerate(zip(lens[:3], hists)):
        need = -(-(h + n) // ps)
        table[i, :need] = [free.pop() for _ in range(need)]
    state_map = np.asarray([free.pop() for _ in range(3)] + [n_pages],
                           np.int32)
    positions = np.full(t, p_max * ps - 1, np.int32)
    pages = np.full(t, n_pages, np.int32)
    offs = np.full(t, ps - 1, np.int32)
    for i, (n, h) in enumerate(zip(lens, hists)):
        pos = h + np.arange(n)
        positions[cu[i]:cu[i + 1]] = pos
        pages[cu[i]:cu[i + 1]] = table[i, pos // ps]
        offs[cu[i]:cu[i + 1]] = pos % ps
    ins = dict(tokens=rng.integers(0, cfg.vocab_size, t).astype(np.int32),
               positions=positions, token_pages=pages, token_offs=offs,
               page_table=table, cu_seqlens=cu,
               q_offsets=np.asarray(hists, np.int32),
               kv_lengths=np.asarray([h + n for h, n in zip(hists, lens)],
                                     np.int32),
               last_idx=np.maximum(cu[1:] - 1, 0).astype(np.int32),
               state_map=state_map)
    return ins, _cache_np(cfg, n_pages + 1, ps, seed + 1)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_packed_paged_matches_jax(variant):
    cfg, params, tcfg, tp = _stack(variant)
    ins, pool = _paged_inputs(cfg, 3)
    jpool, tpool = _both(pool)
    want, jnew = jtr.forward_packed_paged(
        params, cfg, arena=jpool, **{k: jnp.asarray(v)
                                     for k, v in ins.items()})
    with torch.no_grad():
        got = tr.forward_packed_paged(
            tp, tcfg, arena=tpool, **{k: _t(v) for k, v in ins.items()})
    live = slice(0, 3)                     # the pad segment's row aside
    np.testing.assert_allclose(got.numpy()[live], _np(want)[live], **TOL)
    # every page but the scratch page, KV and state alike
    _same(tpool, jnew, rows=slice(0, -1))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_decode_paged_matches_jax(variant):
    """Three live decode rows, each writing its KV page and stepping its
    state page, and a ladder pad row on the scratch page."""
    cfg, params, tcfg, tp = _stack(variant)
    ins, pool = _paged_inputs(cfg, 4)
    ps, scratch = 4, 24
    hist = ins["kv_lengths"][:3]
    table = ins["page_table"][:3].copy()
    # a row ending on a page boundary writes into a page nothing holds
    spare = iter(sorted(set(range(scratch)) - set(table.ravel().tolist())
                        - set(ins["state_map"].tolist())))
    for i in range(3):
        if table[i, hist[i] // ps] == scratch:
            table[i, hist[i] // ps] = next(spare)
    dec = dict(tokens=ins["tokens"][:4],
               positions=np.concatenate([hist, [0]]),
               write_pages=np.concatenate(
                   [table[np.arange(3), hist // ps], [scratch]]),
               write_offs=np.concatenate([hist % ps, [ps - 1]]),
               page_table=np.concatenate(
                   [table, np.full((1, table.shape[1]), scratch)]),
               kv_lengths=np.concatenate([hist + 1, [1]]),
               state_map=ins["state_map"])
    dec = {k: np.asarray(v, np.int32) for k, v in dec.items()}
    jpool, tpool = _both(pool)
    want, jnew = jtr.forward_decode_paged(
        params, cfg, arena=jpool, **{k: jnp.asarray(v)
                                     for k, v in dec.items()})
    with torch.no_grad():
        got = tr.forward_decode_paged(
            tp, tcfg, arena=tpool, **{k: _t(v) for k, v in dec.items()})
    np.testing.assert_allclose(got.numpy()[:3], _np(want)[:3], **TOL)
    _same(tpool, jnew, rows=slice(0, -1))


def _slot_stream(cfg, seed):
    """A packed slot-arena stream: a re-prefill at history 6 on slot 3,
    a fresh prefill on slot 0, a decode row at history 20 on slot 4, two
    pad segments and three tail rows on the scratch slot SLOTS (the
    tails parked at S_max - 1)."""
    rng = np.random.default_rng(seed)
    lens, hists, slots = [5, 7, 1], [6, 0, 20], [3, 0, 4]
    n_pad, tail = 2, 3
    cu = np.asarray([0] + list(np.cumsum(lens)) + [sum(lens)] * n_pad,
                    np.int32)
    t = int(cu[-1]) + tail
    slot_map = np.asarray(slots + [SLOTS] * n_pad, np.int32)
    seg_slots = np.full(t, SLOTS, np.int32)
    positions = np.full(t, S_MAX - 1, np.int32)
    for i, (n, h) in enumerate(zip(lens, hists)):
        seg_slots[cu[i]:cu[i + 1]] = slots[i]
        positions[cu[i]:cu[i + 1]] = h + np.arange(n)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, t).astype(np.int32),
        positions=positions, seg_slots=seg_slots, slot_map=slot_map,
        cu_seqlens=cu, q_offsets=np.asarray(hists + [0] * n_pad, np.int32),
        kv_lengths=np.asarray([h + n for h, n in zip(hists, lens)]
                              + [0] * n_pad, np.int32),
        last_idx=np.asarray(list(cu[1:4] - 1) + [0] * n_pad, np.int32))


def _slot_decode(cfg, seed):
    """Three live decode rows (slots 2, 0, 4) and a ladder pad row on
    the scratch slot, parked at S_max - 1."""
    rng = np.random.default_rng(seed)
    hists = np.asarray([6, 21, 0], np.int32)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
        slot_map=np.asarray([2, 0, 4, SLOTS], np.int32),
        write_pos=np.concatenate([hists, [S_MAX - 1]]).astype(np.int32),
        kv_lengths=np.concatenate([hists + 1, [1]]).astype(np.int32))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("step", ["forward_packed_arena",
                                  "forward_decode_arena"])
def test_slot_arena_steps_match_jax(variant, step):
    """The slot arena's two in-place steps: KV rows and state slots of
    every live slot as the JAX steps leave them (the scratch slot and
    the park rows aside), the logits of every live segment or row."""
    cfg, params, tcfg, tp = _stack(variant)
    ins = (_slot_stream if step == "forward_packed_arena"
           else _slot_decode)(cfg, 5)
    jarena, tarena = _both(_cache_np(cfg, SLOTS + 1, S_MAX, 6))
    want, jnew = getattr(jtr, step)(
        params, cfg, arena=jarena, **{k: jnp.asarray(v)
                                      for k, v in ins.items()})
    with torch.no_grad():
        got = getattr(tr, step)(tp, tcfg, arena=tarena,
                                **{k: _t(v) for k, v in ins.items()})
    np.testing.assert_allclose(got.numpy()[:3], _np(want)[:3], **TOL)
    _same(tarena, jnew, rows=slice(0, SLOTS), skip_park=True)


def test_capability_of_the_hybrid_stack():
    """A hybrid reports each position's kind: it takes a scratch slot
    and state pages, and no gathered packed path or speculation."""
    cap = tr.arena_capability(tget(JAMBA))
    assert [c.kind for c in cap.layers] == ["ssm", "ssm", "attn", "ssm"]
    assert cap.has_ssm and cap.needs_scratch_slot and cap.packed_ok
    assert not cap.pure_attn and not cap.has_window
    assert cap == tr.arena_capability(tget(JAMBA).replace(num_layers=8))
    full = tr.arena_capability(tget_full(JAMBA))
    assert [c.kind for c in full.layers] == ["ssm"] * 4 + ["attn"] + \
        ["ssm"] * 3
    assert tr.arena_capability(tget(QMOE)).pure_attn


def test_qwen3_moe_capacity_forward_matches_jax():
    """qwen3-moe's smoke config with 16 experts: more than 8, so both
    forwards take the capacity dispatch, and drop the same pairs."""
    cfg = get_smoke(QMOE).replace(num_experts=16)
    tcfg = tget(QMOE).replace(num_experts=16)
    params, _ = jtr.init_params(cfg, jax.random.key(25))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _, jaux = jtr.forward(params, cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = tr.forward(tp, tcfg, _t(toks), return_aux=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
