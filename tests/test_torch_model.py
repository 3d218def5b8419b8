"""Model layers and serving steps of the PyTorch port against the JAX
package, with weights converted from the JAX param pytree: RMSNorm,
RoPE, SwiGLU, the dense forward, and the paged packed / decode steps
(logits and page pools) for the qwen3-4b (qk-norm) and qwen2.5-32b
(qkv bias) smoke configs.

Tolerance: atol 1e-5 on fp32 logits and pools.  The two sides run the
same fp32 math; XLA and PyTorch's CPU matmuls sum in different orders,
which moves results by a few 1e-6 at these widths.
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


def _stack(arch):
    cfg, tcfg = get_smoke(arch), tget(arch)
    params, _ = jtr.init_params(cfg, jax.random.key(7))
    if cfg.qkv_bias:
        # init zeroes the biases; perturb them so the branch is exercised
        rng = np.random.default_rng(8)
        for name in ("bq", "bk", "bv"):
            b = params["blocks"][0]["mixer"][name]
            params["blocks"][0]["mixer"][name] = jnp.asarray(
                0.5 * rng.standard_normal(b.shape), b.dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tp


def test_norm_rope_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                      1e6).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **TOL)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wg", (16, 24)), ("wi", (16, 24)), ("wo", (24, 16)))}
    h = x[:, :, 0]
    np.testing.assert_allclose(
        tl.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(h)).numpy(),
        np.asarray(jl.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(h))), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_jax(arch):
    """Same tree, same shapes, same dtype string → the converter is a
    tree map and the port's own init is interchangeable."""
    cfg, tcfg, params, tp = _stack(arch)
    mine = ttr.init_params(tcfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape), mine))[0]
    assert [(jax.tree_util.keystr(k), np.shape(v)) for k, v in flat_j] == \
        [(jax.tree_util.keystr(k), np.shape(v)) for k, v in flat_t]
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(mine))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_forward_matches_jax(arch):
    cfg, tcfg, params, tp = _stack(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 19)).astype(np.int32)
    want, _, _ = jtr.forward(params, cfg, tokens=jnp.asarray(toks))
    got = ttr.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_step_inputs(cfg, seed):
    """A packed stream over a fragmented page pool: two prefill
    segments (one with history, one fresh), one decode row, a tail."""
    rng = np.random.default_rng(seed)
    ps, n_pages, p_max = 4, 24, 8
    lens, hists = [5, 7, 1], [6, 0, 9]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    t = int(cu[-1]) + 3
    free = list(rng.permutation(n_pages))
    table = np.full((3, p_max), n_pages, np.int32)   # scratch = n_pages
    for i, (l, h) in enumerate(zip(lens, hists)):
        need = -(-(h + l) // ps)
        table[i, :need] = [free.pop() for _ in range(need)]
    positions = np.full(t, p_max * ps - 1, np.int32)
    pages = np.full(t, n_pages, np.int32)
    offs = np.full(t, ps - 1, np.int32)
    for i, (l, h) in enumerate(zip(lens, hists)):
        pos = h + np.arange(l)
        positions[cu[i]:cu[i + 1]] = pos
        pages[cu[i]:cu[i + 1]] = table[i, pos // ps]
        offs[cu[i]:cu[i + 1]] = pos % ps
    tokens = rng.integers(0, cfg.vocab_size, t).astype(np.int32)
    pool = rng.standard_normal(
        (1, n_pages + 1, ps, cfg.num_kv_heads, cfg.hdim)).astype(np.float32)
    return dict(tokens=tokens, positions=positions, token_pages=pages,
                token_offs=offs, page_table=table, cu_seqlens=cu,
                q_offsets=np.asarray(hists, np.int32),
                kv_lengths=np.asarray([h + l for h, l in zip(hists, lens)],
                                      np.int32),
                last_idx=(cu[1:] - 1).astype(np.int32)), \
        np.repeat(pool, cfg.num_layers, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_packed_paged_matches_jax(arch):
    cfg, tcfg, params, tp = _stack(arch)
    ins, pool = _paged_step_inputs(cfg, 2)
    jarena = [{"k": jnp.asarray(pool), "v": jnp.asarray(-pool)}]
    want, jnew = jtr.forward_packed_paged(
        params, cfg, arena=jarena, **{k: jnp.asarray(v)
                                      for k, v in ins.items()})
    tarena = [{"k": torch.from_numpy(pool.copy()),
               "v": torch.from_numpy(-pool)}]
    got = ttr.forward_packed_paged(
        tp, tcfg, arena=tarena, **{k: torch.from_numpy(v)
                                   for k, v in ins.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the in-place pool writes land where the JAX scatter put them
    # (the scratch page holds whichever duplicate pad write won: skip it)
    for name in ("k", "v"):
        np.testing.assert_allclose(tarena[0][name][:, :-1].numpy(),
                                   np.asarray(jnew[0][name])[:, :-1], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_decode_paged_matches_jax(arch):
    cfg, tcfg, params, tp = _stack(arch)
    ins, pool = _paged_step_inputs(cfg, 3)
    hist = ins["kv_lengths"]                      # decode one token each
    ps = pool.shape[2]
    table = ins["page_table"]
    dec = dict(tokens=ins["tokens"][:3], positions=hist,
               write_pages=table[np.arange(3), hist // ps],
               write_offs=hist % ps, page_table=table,
               kv_lengths=hist + 1)
    # every row needs its write page: extend rows ending on a boundary
    for i in range(3):
        if table[i, hist[i] // ps] == pool.shape[1] - 1:
            table[i, hist[i] // ps] = 20 + i
            dec["write_pages"][i] = 20 + i
    jarena = [{"k": jnp.asarray(pool), "v": jnp.asarray(pool * 0.5)}]
    want, jnew = jtr.forward_decode_paged(
        params, cfg, arena=jarena,
        **{k: jnp.asarray(np.asarray(v, np.int32)) for k, v in dec.items()})
    tarena = [{"k": torch.from_numpy(pool.copy()),
               "v": torch.from_numpy(pool * 0.5)}]
    got = ttr.forward_decode_paged(
        tp, tcfg, arena=tarena,
        **{k: torch.from_numpy(np.asarray(v, np.int32))
           for k, v in dec.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tarena[0][name].numpy(),
                                   np.asarray(jnew[0][name]), **TOL)


def test_arena_capability_and_slice_guards():
    """The capability descriptor, and the slice: windowed, MoE and
    hybrid configs build (the window and each position's kind reported
    per layer, as the reference's ``arena_capability`` does); a hybrid
    depth off its pattern period is refused."""
    tcfg = tget("qwen3-4b")
    cap = ttr.arena_capability(tcfg)
    assert cap.packed_ok and cap.pure_attn and not cap.has_window
    swa = ttr.arena_capability(tcfg.replace(sliding_window=32))
    assert swa.has_window and swa.window == 32 and not swa.pure_attn
    assert swa.needs_scratch_slot
    moe = ttr.init_params(tcfg.replace(num_experts=4, num_experts_per_tok=2),
                          device="cpu")
    assert set(moe["blocks"][0]["ffn"]) == {"router", "wg", "wi", "wo"}
    hyb = tcfg.replace(family="hybrid", attn_layer_period=2)
    hp = ttr.init_params(hyb, device="cpu")
    assert [c.kind for c in ttr.arena_capability(hyb).layers] == \
        ["attn", "ssm"]
    assert "wq" in hp["blocks"][0]["mixer"]
    assert "in_proj" in hp["blocks"][1]["mixer"]
    with pytest.raises(ValueError, match="pattern's period 2"):
        ttr.init_params(hyb.replace(num_layers=3), device="cpu")


def test_entry_points_default_to_the_card():
    """Without an explicit device the entry points run on CUDA, and
    where no card is present they raise instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tcfg = tget("qwen3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_params(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"embed": np.zeros((2, 2))}, tcfg)
