"""Slot-arena and dense-grid model steps of the PyTorch port against the
JAX package, with weights converted from the JAX param pytree: the three
slot attention layers (packed over the arena, decode over the arena,
packed over gathered caches), the dense ``forward`` with caches ((L, B)
prefill with padded rows and parked positions, then a (B, 1) decode),
``forward_packed``, ``forward_packed_arena`` and ``forward_decode_arena``
— logits and the in-place cache writes — for the qwen3-4b (qk-norm) and
qwen2.5-32b (qkv bias) smoke configs.

Tolerance: atol 1e-5 on fp32 logits and caches (XLA and PyTorch's CPU
matmuls sum in different orders).  Park rows S_max - 1, where several
pad rows write in one step, hold whichever write won and are not
compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
ARCHS = ["qwen3-4b", "qwen2.5-32b"]
SLOTS, S_MAX = 5, 40


def _stack(arch):
    cfg, tcfg = get_smoke(arch), tget(arch)
    params, _ = jtr.init_params(cfg, jax.random.key(9))
    if cfg.qkv_bias:
        # init zeroes the biases; perturb them so the branch is exercised
        rng = np.random.default_rng(8)
        for name in ("bq", "bk", "bv"):
            b = params["blocks"][0]["mixer"][name]
            params["blocks"][0]["mixer"][name] = jnp.asarray(
                0.5 * rng.standard_normal(b.shape), b.dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tp


def _arena(cfg, seed, batch=SLOTS):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, batch, S_MAX, cfg.num_kv_heads, cfg.hdim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _both(k, v):
    return ([{"k": jnp.asarray(k), "v": jnp.asarray(v)}],
            [{"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}])


def _same_cache(tarena, jarena, skip_park=True):
    for name in ("k", "v"):
        got = tarena[0][name].numpy()
        want = np.asarray(jarena[0][name])
        if skip_park:
            got, want = got[:, :, :-1], want[:, :, :-1]
        np.testing.assert_allclose(got, want, **TOL)


def _stream(cfg, seed, slots=(3, 0, 4)):
    """A packed slot-arena stream the engine would assemble: a re-prefill
    with history, a fresh prefill, a decode row, two pad segments on the
    first slot and three tail rows parked at S_max - 1."""
    rng = np.random.default_rng(seed)
    lens, hists = [5, 7, 1], [6, 0, 20]
    n_pad, tail = 2, 3
    cu = np.asarray([0] + list(np.cumsum(lens)) + [sum(lens)] * n_pad,
                    np.int32)
    t = int(cu[-1]) + tail
    slot_map = np.asarray(list(slots) + [slots[0]] * n_pad, np.int32)
    seg_ids = np.full(t, 0, np.int32)
    positions = np.full(t, S_MAX - 1, np.int32)
    for i, (l, h) in enumerate(zip(lens, hists)):
        seg_ids[cu[i]:cu[i + 1]] = i
        positions[cu[i]:cu[i + 1]] = h + np.arange(l)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, t).astype(np.int32),
        positions=positions, seg_ids=seg_ids,
        seg_slots=slot_map[seg_ids], slot_map=slot_map, cu_seqlens=cu,
        q_offsets=np.asarray(hists + [0] * n_pad, np.int32),
        kv_lengths=np.asarray([h + l for h, l in zip(hists, lens)]
                              + [0] * n_pad, np.int32),
        last_idx=np.asarray(list(cu[1:4] - 1) + [0] * n_pad, np.int32))


def _decode_rows(cfg, seed):
    """Three live decode rows and a ladder pad row on the first slot."""
    rng = np.random.default_rng(seed)
    hists = np.asarray([6, 21, 0], np.int32)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
        slot_map=np.asarray([2, 0, 4, 2], np.int32),
        write_pos=np.concatenate([hists, [S_MAX - 1]]).astype(np.int32),
        kv_lengths=np.concatenate([hists + 1, [1]]).astype(np.int32))


def _j(d, keys):
    return {k: jnp.asarray(d[k]) for k in keys}


def _t(d, keys):
    return {k: torch.from_numpy(d[k]) for k in keys}


@pytest.mark.parametrize("layer", ["packed_arena", "packed_gathered",
                                   "arena_decode"])
def test_slot_attention_layers_match_jax(layer):
    cfg, tcfg, params, tp = _stack("qwen3-4b")
    jlp = jax.tree.map(lambda a: a[0], params["blocks"][0]["mixer"])
    tlp = ttr._layer(tp["blocks"][0], 0)["mixer"]
    rng = np.random.default_rng(4)
    k, v = _arena(cfg, 5)
    if layer == "arena_decode":
        ins = _decode_rows(cfg, 6)
        n = len(ins["tokens"])
        keys = ("slot_map", "kv_lengths")
        jkw = dict(positions=jnp.asarray(ins["write_pos"]), **_j(ins, keys))
        tkw = dict(positions=torch.from_numpy(ins["write_pos"]),
                   **_t(ins, keys))
        jfn, tfn = jl.arena_decode_layer, tl.arena_decode_layer
    else:
        ins = _stream(cfg, 6)
        n = len(ins["tokens"])
        base = ("positions", "cu_seqlens", "q_offsets", "kv_lengths")
        if layer == "packed_arena":
            keys = base + ("seg_slots", "slot_map")
            jfn, tfn = jl.packed_arena_attention_layer, \
                tl.packed_arena_attention_layer
        else:
            keys = base + ("seg_ids",)
            # the gathered caches: each stream row's slot copied out
            k, v = k[:, ins["slot_map"]], v[:, ins["slot_map"]]
            jfn, tfn = jl.packed_attention_layer, tl.packed_attention_layer
        jkw, tkw = _j(ins, keys), _t(ins, keys)
    x = rng.standard_normal((n, cfg.d_model)).astype(np.float32)
    want, (jk, jv) = jfn(jlp, jnp.asarray(x), cfg=cfg,
                         kv=(jnp.asarray(k[0]), jnp.asarray(v[0])), **jkw)
    tk, tv = torch.from_numpy(k[0].copy()), torch.from_numpy(v[0].copy())
    got = tfn(tlp, torch.from_numpy(x), cfg=tcfg, kv=(tk, tv), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy()[:, :-1], np.asarray(jk)[:, :-1],
                               **TOL)
    np.testing.assert_allclose(tv.numpy()[:, :-1], np.asarray(jv)[:, :-1],
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_grid_steps_match_jax(arch):
    """The (L, B) grid prefill over gathered slots — two re-prefills
    with history, a padded row and a dummy depth row parked at S_max - 1
    — then the (B, 1) decode step, with caches written in place."""
    cfg, tcfg, params, tp = _stack(arch)
    k, v = _arena(cfg, 7, batch=3)
    rng = np.random.default_rng(8)
    pad_l, lens, hists = 8, [8, 5], [4, 11]
    tokens = rng.integers(0, cfg.vocab_size, (3, pad_l)).astype(np.int32)
    positions = np.full((3, pad_l), S_MAX - 1, np.int32)
    for i, (l, h) in enumerate(zip(lens, hists)):
        positions[i, :l] = h + np.arange(l)
    jc, tc = _both(k, v)
    want, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(tokens),
                              positions=jnp.asarray(positions), caches=jc)
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, torch.from_numpy(tokens),
                          torch.from_numpy(positions), caches=tc)
    for i, l in enumerate(lens):       # every real position's logits
        np.testing.assert_allclose(got.numpy()[i, :l],
                                   np.asarray(want)[i, :l], **TOL)
    _same_cache(tc, jc)
    # decode one token per real row at its next position
    tok1 = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    pos1 = np.asarray([[h + l] for h, l in zip(hists, lens)], np.int32)
    jc2 = [{n: a[:, :2] for n, a in jc[0].items()}]
    tc2 = [{n: a[:, :2].contiguous() for n, a in tc[0].items()}]
    want, jc2, _ = jtr.forward(params, cfg, tokens=jnp.asarray(tok1),
                               positions=jnp.asarray(pos1), caches=jc2,
                               logits_slice="last")
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, torch.from_numpy(tok1),
                          torch.from_numpy(pos1), caches=tc2,
                          logits_slice="last")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_cache(tc2, jc2)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", ["forward_packed", "forward_packed_arena",
                                  "forward_decode_arena"])
def test_flat_stream_steps_match_jax(arch, step):
    cfg, tcfg, params, tp = _stack(arch)
    k, v = _arena(cfg, 10)
    if step == "forward_decode_arena":
        ins = _decode_rows(cfg, 11)
        keys = ("tokens", "slot_map", "write_pos", "kv_lengths")
        kw = dict(arena=None)
    else:
        ins = _stream(cfg, 11)
        keys = ("tokens", "positions", "cu_seqlens", "q_offsets",
                "kv_lengths", "last_idx")
        if step == "forward_packed":
            keys += ("seg_ids",)
            k, v = k[:, ins["slot_map"]], v[:, ins["slot_map"]]
            kw = dict(caches=None)
        else:
            keys += ("seg_slots", "slot_map")
            kw = dict(arena=None)
    name = next(iter(kw))
    jc, tc = _both(k, v)
    want, jnew = getattr(jtr, step)(params, cfg, **{name: jc},
                                    **_j(ins, keys))
    with torch.no_grad():
        got = getattr(ttr, step)(tp, tcfg, **{name: tc}, **_t(ins, keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_cache(tc, jnew)
