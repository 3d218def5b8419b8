"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), at the mixtral-8x7b smoke config's
widths (d_model 64, 4 experts of d_ff 128, top 2) in fp32, with seeded
numpy inputs and weights.

``_routing`` (weights, experts, aux loss), ``moe_dense_reference`` and
``moe_layer`` at the reference's capacity factor and at one low enough
to drop pairs (the same pairs dropped: the stable sort by expert over
every row, pads included), an exact router tie (the lower expert index
first, as ``jax.lax.top_k`` keeps it), the FFN rule of
``transformer._ffn`` on both sides of its 4096-row switch, and the MoE
leaves converted from the JAX parameter tree through the whole dense
forward (logits and the aux loss).

Tolerance: fp32 atol = rtol = 1e-5 (expert indices exact).  Runs in
~35 s in the tier-1 command (6 workers, ``--dist loadfile``).
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "mixtral-8x7b"
D, E, FF, K = 64, 4, 128, 2


def _weights(seed, tie=False):
    """A router and expert weights; ``tie``: expert 0's router column
    far above the rest, experts 1 and 3 identical (an exact tie for the
    second place) and expert 2 far below."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
         "wg": rng.standard_normal((E, D, FF)).astype(np.float32) * 0.1,
         "wi": rng.standard_normal((E, D, FF)).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((E, FF, D)).astype(np.float32) * 0.1}
    if tie:
        p["router"][:, 3] = p["router"][:, 1]
    return p


def _x(seed, shape, tie=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if tie:
        # every row's router logits: expert 0 first, 1 and 3 tied
        x[..., 0] = 40.0
    return x


def _pair(p):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return tp, jp


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
def test_routing_matches_jax(tie):
    p = _weights(1, tie)
    if tie:
        p["router"][0] = [8.0, 0.5, -8.0, 0.5]
    x = _x(2, (96, D), tie)
    tp, jp = _pair(p)
    w, e, aux = tmoe._routing(tp, torch.from_numpy(x), K)
    jw, je, jaux = jmoe._routing(jp, jnp.asarray(x), K)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if tie:
        assert (e.numpy() == [0, 1]).all()   # the lower index of the tie


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
def test_dense_reference_matches_jax(tie):
    p = _weights(3, tie)
    if tie:
        p["router"][0] = [8.0, 0.5, -8.0, 0.5]
    x = _x(4, (3, 37, D), tie)
    tp, jp = _pair(p)
    y, aux = tmoe.moe_dense_reference(tp, torch.from_numpy(x), top_k=K)
    jy, jaux = jmoe.moe_dense_reference(jp, jnp.asarray(x), top_k=K)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("factor", [1.25, 0.5, 8.0],
                         ids=["reference", "drops", "no_drops"])
def test_moe_layer_matches_jax(factor):
    """The capacity dispatch, with pairs dropped at factor 0.5 and none
    at 8.0 (where it equals the dense reference, the reference's own
    check)."""
    p = _weights(5)
    x = _x(6, (2, 61, D))
    tp, jp = _pair(p)
    y, aux = tmoe.moe_layer(tp, torch.from_numpy(x), top_k=K,
                            capacity_factor=factor)
    jy, jaux = jmoe.moe_layer(jp, jnp.asarray(x), top_k=K,
                              capacity_factor=factor)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    dense, _ = tmoe.moe_dense_reference(tp, torch.from_numpy(x), top_k=K)
    if factor == 8.0:
        np.testing.assert_allclose(y.numpy(), dense.numpy(), **TOL)
    elif factor == 0.5:                    # some pair was dropped
        assert np.abs(y.numpy() - dense.numpy()).max() > 1e-3


def test_moe_layer_counts_pads_toward_capacity():
    """Pad rows (zeros, as a bucket tail's embeddings are not) route and
    take capacity like any row: the same stream with and without a tail
    drops different pairs, on both sides alike."""
    p = _weights(7)
    x = _x(8, (1, 40, D))
    padded = np.concatenate([x, np.repeat(x[:, :1], 24, axis=1)], axis=1)
    tp, jp = _pair(p)
    got = tmoe.moe_layer(tp, torch.from_numpy(padded), top_k=K,
                         capacity_factor=0.75)[0].numpy()
    want = np.asarray(jmoe.moe_layer(jp, jnp.asarray(padded), top_k=K,
                                     capacity_factor=0.75)[0])
    np.testing.assert_allclose(got, want, **TOL)
    alone = tmoe.moe_layer(tp, torch.from_numpy(x), top_k=K,
                           capacity_factor=0.75)[0].numpy()
    assert np.abs(got[:, :40] - alone).max() > 1e-3


@pytest.mark.parametrize("rows", [4096, 4100], ids=["dense", "dispatch"])
def test_ffn_rule_matches_jax(rows):
    """``_ffn`` takes the dense reference up to 4096 rows of the padded
    step and the capacity dispatch past it, as the reference does."""
    cfg, tcfg = get_smoke(ARCH), tget(ARCH)
    rng = np.random.default_rng(rows)
    lp = {"ln2": np.ones(D, np.float32), "ffn": _weights(9)}
    x = rng.standard_normal((1, rows, D)).astype(np.float32)
    tlp = {"ln2": torch.from_numpy(lp["ln2"]),
           "ffn": {k: torch.from_numpy(v) for k, v in lp["ffn"].items()}}
    jlp = jax.tree.map(jnp.asarray, lp)
    y, aux = ttr._ffn(tcfg, 0, tlp, torch.from_numpy(x))
    jy, jaux = jtr._ffn(cfg, 0, jlp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    flat, _ = ttr._ffn(tcfg, 0, tlp, torch.from_numpy(x[0]))
    torch.testing.assert_close(flat, y[0])      # a flat stream alike


def test_converted_moe_leaves_through_forward():
    """The MoE leaves (router, wg, wi, wo, stacked over layers) converted
    from the JAX tree: the dense forward's logits and summed aux loss."""
    cfg, tcfg = get_smoke(ARCH), tget(ARCH)
    params, _ = jtr.init_params(cfg, jax.random.key(11))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    ffn = tp["blocks"][0]["ffn"]
    assert set(ffn) == {"router", "wg", "wi", "wo"}
    assert tuple(ffn["wg"].shape) == (2, E, D, FF)
    np.testing.assert_array_equal(
        ffn["router"].numpy(), np.asarray(params["blocks"][0]["ffn"]["router"]))
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 48))
    logits, aux = ttr.forward(tp, tcfg, torch.from_numpy(tokens),
                              return_aux=True)
    jlogits, _, jaux = jtr.forward(params, cfg, tokens=jnp.asarray(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0
