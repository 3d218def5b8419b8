"""The Mamba2 mixer and the SSM stack of the PyTorch port against the JAX
package, with weights converted from the JAX init
(``repro_torch.models.convert.params_from_numpy``) and inputs from numpy
seeds, at the mamba2-2.7b smoke config in fp32.

``mamba_layer`` in sequence mode (fresh and carried caches, right
padding through ``valid_len`` — the counterpart of
``test_moe_mamba.py::test_mamba_valid_len_padding_identity``) and in
decode mode; the arena layers ``packed_arena_mamba_layer`` (with pad
segments, bucket-tail rows and a scratch slot) and
``arena_decode_mamba_layer`` on live slots — the scratch slot is not
compared: duplicate pad writes land there in an order neither framework
defines; the stack's ``forward`` logits without caches and, with
caches, the dense (L, B) grid step and the (B, 1) decode step.
Tolerance: atol = rtol = 1e-5 (fp32; summation order).
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
from repro.models import mamba as jm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models import mamba as tm  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def stack():
    cfg, tcfg = get_smoke(ARCH), tget(ARCH)
    params, _ = jtr.init_params(cfg, jax.random.key(21))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    # one layer's mixer params, group 0
    jp = jax.tree.map(lambda a: a[0], params["blocks"][0]["mixer"])
    tpl = {k: v[0] for k, v in tp["blocks"][0]["mixer"].items()}
    return cfg, params, jp, tcfg, tp, tpl


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cache(cfg, b, seed):
    """A non-zero (ssm, conv) cache of ``b`` rows."""
    rng = np.random.default_rng(seed)
    ssm = rng.standard_normal((b, cfg.ssm_nheads, cfg.ssm_head_dim,
                               cfg.ssm_state_size)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.ssm_conv_width - 1,
                                jm.conv_channels(cfg))).astype(np.float32)
    return ssm, conv


def test_init_params_layout_matches_jax(stack):
    """The port's init draws the JAX package's tree: same leaves, shapes
    and dtypes (an SSM block has no ln2 / ffn), and A_log the same
    log(linspace(1, 16, nheads)), up to the last bit of log."""
    cfg, params, _, tcfg, _, _ = stack
    ours = tr.init_params(tcfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_allclose(
        ours["blocks"][0]["mixer"]["A_log"].numpy(),
        _np(params["blocks"][0]["mixer"]["A_log"]), rtol=1e-6)
    assert "ffn" not in ours["blocks"][0]
    assert tcfg.param_count() == cfg.param_count()


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_layer_sequence_matches_jax(stack, with_cache):
    cfg, _, jp, tcfg, _, tpl = stack
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 2, 2) if with_cache else None
    jy, jc = jm.mamba_layer(jp, jnp.asarray(x), cfg=cfg,
                            cache=None if cache is None else
                            tuple(jnp.asarray(c) for c in cache))
    ty, tc = tm.mamba_layer(tpl, _t(x), cfg=tcfg,
                            cache=None if cache is None else
                            tuple(_t(c) for c in cache))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    if with_cache:
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    else:
        assert tc is None and jc is None


def test_mamba_layer_valid_len_padding_matches_jax(stack):
    """Right padding with ``valid_len``: the state and conv cache equal
    the unpadded run's, and both match the JAX layer."""
    cfg, _, jp, tcfg, _, tpl = stack
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    xp = np.concatenate([x, rng.standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)], axis=1)
    cache = _cache(cfg, 2, 4)
    vl = np.array([10, 7], np.int32)
    _, (s1, c1) = tm.mamba_layer(tpl, _t(x[:1]), cfg=tcfg,
                                 cache=tuple(_t(c[:1]) for c in cache))
    ty, (s2, c2) = tm.mamba_layer(tpl, _t(xp), cfg=tcfg,
                                  cache=tuple(_t(c) for c in cache),
                                  valid_len=_t(vl))
    np.testing.assert_allclose(s2[:1].numpy(), s1.numpy(), **TOL)
    np.testing.assert_allclose(c2[:1].numpy(), c1.numpy(), **TOL)
    jy, (js, jc) = jm.mamba_layer(jp, jnp.asarray(xp), cfg=cfg,
                                  cache=tuple(jnp.asarray(c) for c in cache),
                                  valid_len=jnp.asarray(vl))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(s2.numpy(), _np(js), **TOL)
    np.testing.assert_allclose(c2.numpy(), _np(jc), **TOL)


def test_mamba_layer_decode_matches_jax(stack):
    cfg, _, jp, tcfg, _, tpl = stack
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 3, 6)
    jy, jc = jm.mamba_layer(jp, jnp.asarray(x), cfg=cfg, decode=True,
                            cache=tuple(jnp.asarray(c) for c in cache))
    ty, tc = tm.mamba_layer(tpl, _t(x), cfg=tcfg, decode=True,
                            cache=tuple(_t(c) for c in cache))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def _arena(cfg, n, seed):
    ssm, conv = _cache(cfg, n, seed)
    return {"ssm": ssm, "conv": conv}


def test_packed_arena_mamba_layer_matches_jax(stack):
    """A flat stream of three segments (a prefill, a re-prefill, a decode
    row), one pad segment on the scratch slot and four bucket-tail rows:
    the output rows and every live slot's state match the JAX layer; the
    tail rows give 0."""
    cfg, _, jp, tcfg, _, tpl = stack
    rng = np.random.default_rng(7)
    lens, t, scratch = [6, 3, 1, 0], 14, 5
    slot_map = np.array([2, 0, 4, scratch], np.int32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rows = np.arange(t)
    seg = (rows[:, None] >= cu[None, 1:]).sum(1)
    seg_rows = np.minimum(seg, len(lens) - 1).astype(np.int32)
    seg_pos = (rows - cu[seg_rows]).astype(np.int32)
    valid = rows < cu[-1]
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    arena = _arena(cfg, scratch + 1, 8)
    bridge = dict(seg_rows=seg_rows, seg_pos=seg_pos, valid_row=valid,
                  seg_lens=np.asarray(lens, np.int32))
    jy, jnew = jm.packed_arena_mamba_layer(
        jp, jnp.asarray(x), cfg=cfg, slot_map=jnp.asarray(slot_map),
        cache={k: jnp.asarray(v) for k, v in arena.items()},
        **{k: jnp.asarray(v) for k, v in bridge.items()})
    tarena = {k: _t(v.copy()) for k, v in arena.items()}
    ty = tm.packed_arena_mamba_layer(
        tpl, _t(x), cfg=tcfg, slot_map=_t(slot_map), cache=tarena,
        **{k: _t(v) for k, v in bridge.items()})
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    assert not ty[~torch.from_numpy(valid)].any()
    live = [0, 1, 2, 3, 4]                       # every slot but scratch
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tarena[k][live].numpy(),
                                   _np(jnew[k])[live], **TOL)
    # slots 1 and 3 hold no segment: untouched
    for k in ("ssm", "conv"):
        np.testing.assert_array_equal(tarena[k][[1, 3]].numpy(),
                                      arena[k][[1, 3]])


def test_arena_decode_mamba_layer_matches_jax(stack):
    """Three live rows and a ladder pad row on the scratch slot."""
    cfg, _, jp, tcfg, _, tpl = stack
    rng = np.random.default_rng(9)
    scratch = 4
    slot_map = np.array([3, 1, 0, scratch], np.int32)
    x = rng.standard_normal((4, cfg.d_model)).astype(np.float32)
    arena = _arena(cfg, scratch + 1, 10)
    jy, jnew = jm.arena_decode_mamba_layer(
        jp, jnp.asarray(x), cfg=cfg, slot_map=jnp.asarray(slot_map),
        cache={k: jnp.asarray(v) for k, v in arena.items()})
    tarena = {k: _t(v.copy()) for k, v in arena.items()}
    ty = tm.arena_decode_mamba_layer(tpl, _t(x), cfg=tcfg,
                                     slot_map=_t(slot_map), cache=tarena)
    np.testing.assert_allclose(ty[:3].numpy(), _np(jy)[:3], **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tarena[k][:scratch].numpy(),
                                   _np(jnew[k])[:scratch], **TOL)


def test_forward_logits_match_jax(stack):
    cfg, params, _, tcfg, tp, _ = stack
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, _, _ = jtr.forward(params, cfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tl = tr.forward(tp, tcfg, _t(toks))
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def test_forward_with_caches_matches_jax(stack):
    """The dense (L, B) grid step (padded rows through
    ``seq_valid_len``) then a (B, 1) decode step, caches carried in
    place, against the JAX forward threading its caches."""
    cfg, params, _, tcfg, tp, _ = stack
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    vl = np.array([12, 7], np.int32)
    jc = jtr.init_cache(cfg, 2, 32)
    tc = tr.init_cache(tcfg, 2, 32, device="cpu")
    jl, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(toks), caches=jc,
                            seq_valid_len=jnp.asarray(vl))
    with torch.no_grad():
        tl = tr.forward(tp, tcfg, _t(toks), caches=tc,
                        seq_valid_len=_t(vl))
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tc[0][k].numpy(), _np(jc[0][k]), **TOL)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jl, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(nxt), caches=jc,
                            logits_slice="last")
    with torch.no_grad():
        tl = tr.forward(tp, tcfg, _t(nxt), caches=tc, logits_slice="last")
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tc[0][k].numpy(), _np(jc[0][k]), **TOL)


def test_capability_of_the_ssm_stack(stack):
    _, _, _, tcfg, _, _ = stack
    cap = tr.arena_capability(tcfg)
    assert cap.has_ssm and cap.needs_scratch_slot and not cap.pure_attn
    assert cap.packed_ok
