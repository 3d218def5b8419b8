"""The chunked SSD scan of the PyTorch port against the JAX package.

``repro_torch.kernels.ref.ref_ssd_scan`` is the plain version the
``ssd_scan`` CUDA kernel is held to on the card; here it meets the
group-factored ``repro.models.mamba.ssd_chunked``, the sequential
oracle ``repro.kernels.ref.ref_ssd_scan`` and the Pallas ``ssd_scan`` in
interpret mode (both per head: B/C repeated to heads) on the same numpy
inputs: y and the final state, L on and off the chunk grid, a non-zero
init state, G < NH and G == NH.  fp32 within atol = rtol = 1e-5: the
outputs reach |y| ~ 40, where fp32 rounding of the reference's own
chunked sums alone moves them by ~2e-5.  Also: chunk-size invariance,
the dt = 0 padding identity, the ``ops`` dispatch and the kernel
launcher's refusals on the CPU.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, L, NH, HD, G, DS, chunk)
CASES = {
    "off_grid_g1": (2, 40, 4, 8, 1, 16, 16),
    "groups": (2, 37, 8, 8, 2, 16, 8),
    "per_head": (1, 64, 4, 8, 4, 16, 32),
    "short": (2, 5, 4, 8, 4, 16, 8),
    "one_token": (1, 1, 4, 8, 2, 16, 128),
}


def _inputs(seed, b, l, nh, hd, g, ds, init=True):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); a = -exp(0.3 N(0, 1))
    (the reference's own test scales); init state N(0, 1) or zeros."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, nh, hd)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, nh)))).astype(f)
    a = -np.exp(0.3 * rng.standard_normal(nh)).astype(f)
    bg = rng.standard_normal((b, l, g, ds)).astype(f)
    cg = rng.standard_normal((b, l, g, ds)).astype(f)
    h0 = (rng.standard_normal((b, nh, hd, ds)) if init
          else np.zeros((b, nh, hd, ds))).astype(f)
    return x, dt, a, bg, cg, h0


def _plain(args, chunk):
    y, st = tref.ref_ssd_scan(*(torch.from_numpy(v) for v in args),
                              chunk=chunk)
    return y.numpy(), st.numpy()


def _per_head(args):
    """The per-head (B, L, NH, DS) form of group-form B/C."""
    x, dt, a, bg, cg, h0 = args
    rep = x.shape[2] // bg.shape[2]
    return (x, dt, a, np.repeat(bg, rep, axis=2), np.repeat(cg, rep, axis=2),
            h0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_scan_matches_ssd_chunked(name):
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args = _inputs(1, b, l, nh, hd, g, ds)
    x, dt, a, bg, cg, h0 = (jnp.asarray(v) for v in args)
    jy, js = ssd_chunked(x, dt, a, bg, cg, chunk, init_state=h0)
    ty, ts = _plain(args, chunk)
    np.testing.assert_allclose(ty, np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts, np.asarray(js), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_scan_matches_sequential_oracle_and_pallas(name):
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args = _inputs(2, b, l, nh, hd, g, ds)
    ty, ts = _plain(args, chunk)
    x, dt, a, bh, ch, h0 = (jnp.asarray(v) for v in _per_head(args))
    oy, os_ = jref.ref_ssd_scan(x, dt, a, bh, ch, init_state=h0)
    np.testing.assert_allclose(ty, np.asarray(oy), **TOL)
    np.testing.assert_allclose(ts, np.asarray(os_), **TOL)
    py, ps = pallas_ssd(x, dt, a, bh, ch, h0, chunk=chunk, interpret=True)
    np.testing.assert_allclose(ty, np.asarray(py), **TOL)
    np.testing.assert_allclose(ts, np.asarray(ps), **TOL)
    # the per-head form through the port's own entry gives the same
    hy, hs = _plain(_per_head(args), chunk)
    np.testing.assert_allclose(hy, ty, **TOL)
    np.testing.assert_allclose(hs, ts, **TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunk_size_invariance(chunk):
    """The port's counterpart of test_moe_mamba's chunk-size invariance:
    every chunk size gives the sequential recurrence."""
    args = _inputs(3, 1, 32, 2, 8, 2, 8, init=False)
    ty, ts = _plain(args, chunk)
    x, dt, a, bh, ch, _ = (jnp.asarray(v) for v in _per_head(args))
    oy, os_ = jref.ref_ssd_scan(x, dt, a, bh, ch)
    np.testing.assert_allclose(ty, np.asarray(oy), **TOL)
    np.testing.assert_allclose(ts, np.asarray(os_), **TOL)


def test_dt_zero_padding_is_an_identity():
    """Rows with dt = 0 appended past L (any x, B, C) leave the final
    state and every earlier y as they were: the identity that makes
    right-padding, and the kernel's skipping of a ragged last chunk's
    missing rows, exact."""
    x, dt, a, bg, cg, h0 = _inputs(4, 2, 13, 4, 8, 2, 16)
    pad = _inputs(5, 2, 5, 4, 8, 2, 16)
    padded = (np.concatenate([x, pad[0]], 1),
              np.concatenate([dt, np.zeros_like(pad[1])], 1), a,
              np.concatenate([bg, pad[3]], 1),
              np.concatenate([cg, pad[4]], 1), h0)
    y, st = _plain((x, dt, a, bg, cg, h0), 8)
    yp, sp = _plain(padded, 8)
    np.testing.assert_allclose(yp[:, :13], y, **TOL)
    np.testing.assert_allclose(sp, st, **TOL)


def test_ops_dispatch_on_cpu():
    """``ops.ssd`` (per head, shaped like the JAX ops entry) and
    ``ops.ssd_grouped`` (group form, the mamba layer's entry) take the
    plain version for CPU tensors; a missing init state is zeros."""
    b, l, nh, hd, g, ds, chunk = CASES["groups"]
    args = _inputs(6, b, l, nh, hd, g, ds, init=False)
    t = [torch.from_numpy(v) for v in args]
    gy, gs = ops.ssd_grouped(*t[:5], None, chunk=chunk)
    hy, hs = ops.ssd(*(torch.from_numpy(v) for v in _per_head(args)),
                     chunk=chunk)
    py, ps = _plain(args, chunk)
    for got in (gy, hy):
        np.testing.assert_allclose(got.numpy(), py, **TOL)
    for got in (gs, hs):
        np.testing.assert_allclose(got.numpy(), ps, **TOL)


def test_kernel_launcher_refuses_cpu_tensors():
    """On a CPU tensor the launcher raises: only ``ops`` chooses the
    plain version, by the tensor's device."""
    t = [torch.from_numpy(v) for v in _inputs(7, 1, 8, 4, 8, 1, 16)]
    with pytest.raises(ValueError, match="CUDA kernel"):
        tssd.ssd_scan(*t)


def test_row_strides_of_conv_output_views():
    """x, B and C reach the kernel as views into the layer's (B, L, C)
    conv output: the launcher reads their uniform row stride, and
    refuses a layout whose rows are not evenly strided."""
    b, l, nh, hd, g, ds = 2, 5, 4, 8, 1, 16
    xbc = torch.zeros(b, l, nh * hd + 2 * g * ds)
    x = xbc[..., :nh * hd].reshape(b, l, nh, hd)
    bm = xbc[..., nh * hd:nh * hd + g * ds].reshape(b, l, g, ds)
    assert tssd._row_stride("x", x) == xbc.shape[-1]
    assert tssd._row_stride("b", bm) == xbc.shape[-1]
    # a single row has no stride to keep
    assert tssd._row_stride("one", x[:1, :1]) == nh * hd
    with pytest.raises(ValueError, match="evenly strided"):
        tssd._row_stride("x", x.transpose(0, 1))


def test_error_bound_admits_rounding_and_rejects_a_dropped_chunk():
    """``ssd_error_bound`` (the card's tolerance) admits the bf16 rounding
    of the plain version's own output, and not an output missing one
    chunk's intra-chunk term."""
    args = [torch.from_numpy(v) for v in _inputs(8, 1, 40, 4, 8, 1, 16)]
    x, dt, a, bm, cm, h0 = args
    xb, bb, cb = (t.bfloat16() for t in (x, bm, cm))
    y, st = tref.ref_ssd_scan(xb, dt, a, bb, cb, h0, chunk=16)
    yr, yb, sr, sb = tref.ssd_error_bound(xb, dt, a, bb, cb, h0, 16)
    assert bool(((y.float() - yr).abs() <= yb).all())
    assert bool(((st - sr).abs() <= sb).all())
    # zero the second chunk's inputs but keep its decay: its rows' y
    # loses the intra-chunk term
    x2 = x.clone()
    x2[:, 16:32] = 0
    yd, _ = tref.ref_ssd_scan(x2, dt, a, bm, cm, h0, chunk=16)
    yr, yb, _, _ = tref.ssd_error_bound(x, dt, a, bm, cm, h0, 16)
    assert not bool(((yd - yr).abs() <= yb).all())
