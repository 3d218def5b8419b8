"""The backward of the port's chunked SSD scan: the plain version
``kernels.ref.ref_ssd_scan_bwd`` (the reverse chunk walk the
``ssd_scan_bwd`` CUDA kernels compute: G = dy·xᵀ, dCB, dx, dB, dC, the
decays' gradient through row and column sums of dseg, dH carried from
the last chunk to the first) against ``torch.autograd`` of
``ref_ssd_scan`` and against ``jax.vjp`` of the reference's
``repro.models.mamba.ssd_chunked``, at the ``CASES`` of
``tests/test_torch_ssd.py`` (G = 1, G = NH, G in between, L off the
chunk grid, a non-zero initial state), with and without a gradient of
the final state.  Also the chunk states the forward's training form
writes, the derived error bound of ``ssd_bwd_error_bound`` (it admits
fp32 and bf16 rounding and rejects a dropped chunk), zero-dt padding
rows, the launchers' refusals and ``ops.ssd_grouped`` under grad on the
CPU.

Tolerance ``GRAD_TOL``: atol 1e-5, rtol 1e-4, the atol scaled by the
leaf's largest |grad| where that is above 1 — every side computes the
same sums in fp32 in another order (the reference takes cum_t − cum_s
where the port sums seg directly), and d dt and da sum up to B·L terms
that reach ~90.
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
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
NAMES = ("x", "dt", "a", "bmat", "cmat", "init_state")

# (B, L, NH, HD, G, DS, chunk), as tests/test_torch_ssd.py
CASES = {
    "off_grid_g1": (2, 40, 4, 8, 1, 16, 16),
    "groups": (2, 37, 8, 8, 2, 16, 8),
    "per_head": (1, 64, 4, 8, 4, 16, 32),
    "short": (2, 5, 4, 8, 4, 16, 8),
    "one_token": (1, 1, 4, 8, 2, 16, 128),
}


def _inputs(seed, b, l, nh, hd, g, ds):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)) with every 7th row 0;
    a = -exp(0.3 N(0, 1)); a non-zero init state; dy and the final
    state's gradient ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, nh, hd)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, nh)))).astype(f)
    dt[:, ::7] = 0.0
    a = -np.exp(0.3 * rng.standard_normal(nh)).astype(f)
    bg = rng.standard_normal((b, l, g, ds)).astype(f)
    cg = rng.standard_normal((b, l, g, ds)).astype(f)
    h0 = rng.standard_normal((b, nh, hd, ds)).astype(f)
    dy = rng.standard_normal((b, l, nh, hd)).astype(f)
    dst = rng.standard_normal((b, nh, hd, ds)).astype(f)
    return (x, dt, a, bg, cg, h0), dy, dst


def _assert_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        atol = GRAD_TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0)))
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=name)


def _plain(args, dy, dst, chunk):
    t = [torch.from_numpy(v) for v in (*args, dy)]
    ds_ = None if dst is None else torch.from_numpy(dst)
    return [g.numpy() for g in tref.ref_ssd_scan_bwd(*t, ds_, chunk=chunk)]


@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no_dstate"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd(name, dstate):
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args, dy, dst = _inputs(1, b, l, nh, hd, g, ds)
    dst = dst if dstate else None
    got = _plain(args, dy, dst, chunk)
    leaves = [torch.from_numpy(v).requires_grad_() for v in args]
    y, st = tref.ref_ssd_scan(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dst is not None:
        loss = loss + (st * torch.from_numpy(dst)).sum()
    want = torch.autograd.grad(loss, leaves)
    _assert_grads(got, [w.numpy() for w in want])


@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no_dstate"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_vjp(name, dstate):
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args, dy, dst = _inputs(2, b, l, nh, hd, g, ds)
    got = _plain(args, dy, dst if dstate else None, chunk)
    _, vjp = jax.vjp(
        lambda x, dt, a, bg, cg, h0: ssd_chunked(x, dt, a, bg, cg, chunk,
                                                 init_state=h0),
        *(jnp.asarray(v) for v in args))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(dst if dstate else np.zeros_like(dst))))
    _assert_grads(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_states_are_the_state_before_each_chunk(name):
    """``ref_ssd_scan(..., return_states=True)``: chunk c's state is the
    final state of the reference's scan over the first c chunks (the
    initial state for c = 0)."""
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args, _, _ = _inputs(3, b, l, nh, hd, g, ds)
    _, _, states = tref.ref_ssd_scan(*(torch.from_numpy(v) for v in args),
                                     chunk=chunk, return_states=True)
    q = min(chunk, l)
    assert states.shape == (b, nh, tssd.n_chunks(l, chunk), hd, ds)
    x, dt, a, bg, cg, h0 = args
    np.testing.assert_array_equal(states[:, :, 0].numpy(), h0)
    for c in range(1, states.shape[2]):
        r = c * q
        _, want = ssd_chunked(*(jnp.asarray(v[:, :r]) for v in (x, dt)),
                              jnp.asarray(a),
                              *(jnp.asarray(v[:, :r]) for v in (bg, cg)),
                              chunk, init_state=jnp.asarray(h0))
        np.testing.assert_allclose(states[:, :, c].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_error_bound_admits_rounding_and_rejects_a_dropped_chunk(dtype):
    """The bound the card's kernels are held to: autograd's gradients
    (the same function summed in another order), rounded to the storage
    type where the kernel rounds, lie inside it; gradients computed as
    if one chunk's dy had never been read lie outside it."""
    b, l, nh, hd, g, ds, chunk = 2, 40, 4, 8, 1, 16, 8
    args, dy, dst = _inputs(4, b, l, nh, hd, g, ds)
    t = [torch.from_numpy(v) for v in args]
    x, bg, cg = (t[i].to(dtype) for i in (0, 3, 4))
    dyt, dstt = torch.from_numpy(dy).to(dtype), torch.from_numpy(dst)
    _, _, states = tref.ref_ssd_scan(x.float(), t[1], t[2], bg.float(),
                                     cg.float(), t[5], chunk=chunk,
                                     return_states=True)
    refs, bounds = tref.ssd_bwd_error_bound(x, t[1], t[2], bg, cg, t[5], dyt,
                                            dstt, states, chunk)
    leaves = [v.float().requires_grad_() for v in (x, t[1], t[2], bg, cg,
                                                   t[5])]
    y, st = tref.ref_ssd_scan(*leaves, chunk=chunk)
    auto = torch.autograd.grad((y * dyt.float()).sum() + (st * dstt).sum(),
                               leaves)
    for i, (a_, r, bd) in enumerate(zip(auto, refs, bounds)):
        if i in (0, 3, 4):
            a_ = a_.to(dtype).float()
        assert ((a_ - r).abs() <= bd).all(), NAMES[i]
    cut = dyt.clone()
    cut[:, 16:24] = 0                           # chunk 2's dy never read
    dropped = tref.ref_ssd_scan_bwd(x, t[1], t[2], bg, cg, t[5], cut, dstt,
                                    chunk=chunk, states=states)
    for i in (0, 1, 3, 4):
        assert ((dropped[i].float() - refs[i]).abs() > bounds[i]).any(), \
            NAMES[i]


def test_zero_dt_padding_rows_get_no_gradient():
    """Rows with dt = 0 appended past L (any x, B, C; dy 0 there, no
    gradient of the final state): every gradient of a padding row is 0,
    and the real rows' gradients are those of the unpadded call."""
    (x, dt, a, bg, cg, h0), dy, _ = _inputs(5, 2, 13, 4, 8, 2, 16)
    (px, _, _, pb, pc, _), _, _ = _inputs(6, 2, 5, 4, 8, 2, 16)
    padded = (np.concatenate([x, px], 1),
              np.concatenate([dt, np.zeros((2, 5, 4), np.float32)], 1), a,
              np.concatenate([bg, pb], 1), np.concatenate([cg, pc], 1), h0)
    pdy = np.concatenate([dy, np.zeros_like(px)], 1)
    got = _plain(padded, pdy, None, 8)
    want = _plain((x, dt, a, bg, cg, h0), dy, None, 8)
    for i in (0, 1, 3, 4):
        assert not got[i][:, 13:].any(), NAMES[i]
        got[i] = got[i][:, :13]
    _assert_grads(got, want)


def test_launchers_refuse_cpu_tensors():
    """The training form, the backward and the autograd function launch
    kernels: on CPU tensors they raise; only ``ops`` chooses the plain
    version, by the tensor's device."""
    args, dy, _ = _inputs(7, 1, 8, 4, 8, 1, 16)
    t = [torch.from_numpy(v) for v in args]
    states = torch.zeros((1, 4, 1, 8, 16))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tssd.ssd_scan(*t, return_states=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tssd.ssd_scan_bwd(*t[:5], states, torch.from_numpy(dy))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tssd.SSDScanFn.apply(*t, 128)


@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no_dstate"])
def test_ssd_grouped_on_cpu_differentiates_through_the_plain_version(dstate):
    """On the CPU ``ops.ssd_grouped`` under grad is the plain version,
    which autograd differentiates: its grads equal the plain backward's
    (the same walk the card's kernels compute)."""
    b, l, nh, hd, g, ds, chunk = CASES["groups"]
    args, dy, dst = _inputs(8, b, l, nh, hd, g, ds)
    dst = dst if dstate else None
    leaves = [torch.from_numpy(v).requires_grad_() for v in args]
    y, st = ops.ssd_grouped(*leaves, chunk=chunk)
    assert y.grad_fn is not None
    loss = (y * torch.from_numpy(dy)).sum()
    if dst is not None:
        loss = loss + (st * torch.from_numpy(dst)).sum()
    loss.backward()
    _assert_grads([v.grad.numpy() for v in leaves],
                  _plain(args, dy, dst, chunk))


def test_backward_workspace_covers_its_parts():
    """``bwd_workspace_floats`` is the sum of the parts the kernels'
    workspace is carved into: at mamba2's training shape (80 heads of 64,
    DS 128, one group, 2 head ranges of 40) (B·Cᵀ)ᵀ's band, each chunk's
    end-state gradient, the chunks' decays, the da partials and the 2
    ranges' dB and dC partials; at jamba's (128 heads in 8 groups, one
    range) no range partials; no (B, L, NH·slices, DS) partials at all."""
    b, l, nh, hd, ds, g, chunk = 4, 1024, 80, 64, 128, 1, 128
    nc = 8
    assert tssd.n_chunks(l, chunk) == nc
    assert tssd.bwd_ranges(b, l, nh, ds, g, chunk) == (2, 40)
    assert tssd.bwd_workspace_floats(b, l, nh, hd, ds, g, chunk) == (
        b * nc * g * chunk * chunk + b * nh * nc * hd * ds + b * nh * nc
        + nh * b * nc + 2 * 2 * b * l * g * ds)
    nh, g = 128, 8
    assert tssd.bwd_ranges(b, l, nh, ds, g, chunk) == (1, 16)
    assert tssd.bwd_workspace_floats(b, l, nh, hd, ds, g, chunk) == (
        b * nc * g * chunk * chunk + b * nh * nc * hd * ds + 2 * b * nh * nc)
    # an L off the chunk grid and a chunk off 16: the band is Q16 square
    assert tssd.bwd_workspace_floats(2, 37, 16, 8, 16, 2, 8) == (
        2 * 5 * 2 * 16 * 16 + 2 * 16 * 5 * 8 * 16 + 2 * 2 * 16 * 5
        + 2 * tssd.bwd_ranges(2, 37, 16, 16, 2, 8)[0] * 2 * 37 * 2 * 16)
    assert tssd.n_chunks(1000, 128) == 8 and tssd.n_chunks(5, 128) == 1


@pytest.mark.parametrize("hd,ds", [(65, 128), (64, 257)])
def test_backward_refuses_widths_past_its_tiles(hd, ds):
    """The backward's blocks hold a head of at most 64 columns and a
    state of at most 256: wider inputs raise before any launch (meta
    tensors, which pass the device check)."""
    m = dict(device="meta")
    x = torch.empty((1, 8, 2, hd), **m)
    args = (x, torch.empty((1, 8, 2), **m), torch.empty((2,), **m),
            torch.empty((1, 8, 1, ds), **m), torch.empty((1, 8, 1, ds), **m))
    states = torch.empty((1, 2, 1, hd, ds), **m)
    with pytest.raises(ValueError, match="the backward takes"):
        tssd.ssd_scan_bwd(*args, states, torch.empty_like(x))
