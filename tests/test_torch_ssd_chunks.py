"""The schedule of the ``ssd_scan`` CUDA kernel (``csrc/ssd_scan.cu``),
rehearsed in plain PyTorch and held to the plain version and the JAX
package.

``rehearse`` runs the kernel's two passes as the card does:
- C·Bᵀ once per (batch row, chunk, group), skipped when dt is 0 for
  every head of the group in that chunk (the cb kernel);
- the walk: every (batch row, head, slice of the head's columns) carries
  its slice of the fp32 state through the chunks in order (the walk
  kernel; the slices are independent and run side by side here);
  per chunk cum by a warp scan (32-row warps, Hillis-Steele, then the
  warp sums in order), M by running sums down each column,
  seg(t, s) = seg(t - 1, s) + la_t, the rows split between the block's
  two halves at half the chunk's 16-row tiles, rounded up (the second
  half first sums seg(mid - 1, s) over the same terms in the same
  order), y = diag(exp(cum)) (C stateᵀ) + M X and state =
  exp(cum_last) state + (w X)ᵀ B;
- bf16: x, B and C are bf16, so their products are exact in fp32; the
  fp32 operands (M, the state, w X) enter as a split pair hi + lo of
  bf16, as the kernel's two MMAs take them;
- a (row, chunk, head) whose dt is 0 on every row computes only
  y = C stateᵀ and passes the state on.

Every (row, chunk, head, slice) is counted once, as computed or skipped,
and every (row, chunk, group) of C·Bᵀ likewise, so a dropped or repeated
chunk, or a wrong skip, fails.  Inputs from a numpy seed at NH 8, HD 16,
DS 32, chunk 16 (slices of 8 columns, so each head has two), G = 1 and
G = NH, plus a chunk of 96 whose columns cross the split at row 48.
fp32 within atol = rtol = 1e-5 of ``ref_ssd_scan``, JAX ``ssd_chunked``
and the Pallas ``ssd_scan`` (interpret mode), except that against
``ssd_chunked`` the strong-decay cases are held to
``kernels.ref.ssd_error_bound`` (1e-4 of each (row, head)'s largest
magnitude): it takes cum_t - cum_s, which after a 40x decay keeps fewer
digits than the direct sums of ``ref_ssd_scan`` and the kernel; bf16
within ``ssd_error_bound`` of the plain version run in fp32, as the
kernel is held on the card.  Time of the file in the whole suite's
parallel run (6 xdist workers, ``--dist loadfile``, one torch thread a
worker): ~25–30 s.
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
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32 = torch.float32
TOL = dict(atol=1e-5, rtol=1e-5)
NH, HD, DS, CHUNK, SLICE = 8, 16, 32, 16, 8


def _split(v):
    """v as the bf16 pair hi + lo the kernel's two MMAs take."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm(a, b, split_a=False, split_b=False):
    """a @ b in fp32, an fp32-valued operand entering as hi + lo."""
    if split_a:
        hi, lo = _split(a)
        return hi @ b + lo @ b
    if split_b:
        hi, lo = _split(b)
        return a @ hi + a @ lo
    return a @ b


def _warp_scan(la):
    """Inclusive prefix sums over the last dim as the kernel's four warps
    take them: Hillis-Steele within each 32 rows, then the sums of the
    earlier warps added in order."""
    n = la.shape[-1]
    w = -(-n // 32)
    v = torch.nn.functional.pad(la, (0, 32 * w - n)).reshape(
        *la.shape[:-1], w, 32)
    lane = torch.arange(32)
    o = 1
    while o < 32:
        shifted = torch.nn.functional.pad(v, (o, 0))[..., :32]
        v = torch.where(lane >= o, v + shifted, v)
        o *= 2
    off = torch.zeros_like(v[..., 0])
    for k in range(1, w):
        off[..., k] = off[..., k - 1] + v[..., k - 1, 31]
    return (v + off[..., None]).reshape(*la.shape[:-1], 32 * w)[..., :n]


def _column_walk(la, dts, cb, n_pad):
    """M and w of one chunk by running sums down each column s, the rows
    split between two halves at half the 16-row tiles, rounded up; la,
    dts: (..., np); cb: (..., np, np).  Returns (M (..., np, np), w (...,
    np))."""
    s = torch.arange(n_pad)
    mid = 16 * ((n_pad // 16 + 1) // 2)
    m = torch.zeros_like(cb)
    seg = torch.zeros_like(la)
    # the first half: rows [0, mid)
    for t in range(mid):
        seg = torch.where(t > s, seg + la[..., t:t + 1], seg)
        m[..., t, :] = torch.where(t >= s, torch.exp(seg) * cb[..., t, :]
                                   * dts, 0.0)
    if n_pad > mid:
        # the second half sums seg(mid - 1, s) afresh, then walks on
        seg = torch.zeros_like(la)
        for r in range(1, mid):
            seg = torch.where(r > s, seg + la[..., r:r + 1], seg)
        for t in range(mid, n_pad):
            seg = torch.where(t > s, seg + la[..., t:t + 1], seg)
            m[..., t, :] = torch.where(t >= s, torch.exp(seg)
                                       * cb[..., t, :] * dts, 0.0)
    return m, torch.exp(seg) * dts


def rehearse(x, dt, a, bmat, cmat, init_state, chunk, slice_=SLICE):
    """The kernel's schedule on CPU tensors.  Returns (y, state, tally of
    (row, chunk, head, slice): 1 computed, 2 skipped, count of visits,
    tally of (row, chunk, group): 1 computed, 2 skipped)."""
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    hpg, split = nh // g, x.dtype == torch.bfloat16
    q = min(chunk, l)
    nc, nsl = -(-l // q), -(-hd // slice_)
    xf, bf, cf = x.float(), bmat.float(), cmat.float()
    # 1. C.B^T once per (row, chunk, group), skipped where every head of
    # the group has dt = 0 on every row of the chunk
    cbs = {}
    group_tally = torch.zeros((b, nc, g), dtype=torch.int64)
    for c in range(nc):
        rows = slice(c * q, min(l, (c + 1) * q))
        live = (dt[:, rows].reshape(b, -1, g, hpg) != 0).any(3).any(1)
        for bi in range(b):
            for gi in range(g):
                group_tally[bi, c, gi] += 1 if live[bi, gi] else 2
                if live[bi, gi]:
                    cbs[bi, c, gi] = cf[bi, rows, gi] @ bf[bi, rows, gi].T
    # 2. the walk of every (row, head, slice), its slices side by side
    st = torch.nn.functional.pad(init_state.float(),
                                 (0, 0, 0, nsl * slice_ - hd))
    st = st.reshape(b, nh, nsl, slice_, ds)
    xs = torch.nn.functional.pad(xf, (0, nsl * slice_ - hd)).reshape(
        b, l, nh, nsl, slice_)
    y = torch.full((b, l, nh, nsl, slice_), float("nan"))
    tally = torch.zeros((b, nc, nh, nsl), dtype=torch.int64)
    visits = torch.zeros_like(tally)
    av = a.float()
    for c in range(nc):
        r0, n = c * q, min(q, l - c * q)
        n_pad = -(-n // 16) * 16
        pad = (0, 0, 0, n_pad - n)
        for bi in range(b):
            for h in range(nh):
                gi = h // hpg
                dts = torch.nn.functional.pad(dt[bi, r0:r0 + n, h], pad[2:])
                live = bool((dts != 0).any())
                visits[bi, c, h] += 1
                tally[bi, c, h] = 1 if live else 2
                cs = torch.nn.functional.pad(cf[bi, r0:r0 + n, gi], pad)
                s_h = st[bi, h]                           # (nsl, P, ds)
                yc = _mm(cs, s_h.transpose(1, 2), split_b=split)
                if live:
                    la = dts * av[h]
                    ecum = torch.exp(_warp_scan(la))
                    cb = torch.nn.functional.pad(cbs[bi, c, gi],
                                                 (0, n_pad - n, 0, n_pad - n))
                    m, w = _column_walk(la, dts, cb, n_pad)
                    xc = torch.nn.functional.pad(
                        xs[bi, r0:r0 + n, h], (0, 0, 0, 0, 0, n_pad - n))
                    xc = xc.transpose(0, 1)               # (nsl, np, P)
                    bc = torch.nn.functional.pad(bf[bi, r0:r0 + n, gi], pad)
                    yc = ecum[:, None] * yc + _mm(m, xc, split_a=split)
                    wx = (w[:, None] * xc).transpose(1, 2)  # (nsl, P, np)
                    st[bi, h] = ecum[n - 1] * s_h + _mm(wx, bc,
                                                        split_a=split)
                y[bi, r0:r0 + n, h] = yc[:, :n].transpose(0, 1)
    y = y.reshape(b, l, nh, nsl * slice_)[..., :hd].to(x.dtype)
    state = st.reshape(b, nh, nsl * slice_, ds)[:, :, :hd]
    return y, state, tally, visits, group_tally


def _inputs(seed, b, l, g, lens=None, zero=(), strong=(), dtype=F32):
    """x, B, C from one N(0, 1/4) conv-output row (bf16 for dtype bf16);
    dt = softplus(N(0, 1)), 40x on the ``strong`` rows, 0 on the rows of
    each ``zero`` range and past each row's length in ``lens``; a =
    -linspace(1, 16, NH); a non-zero init state N(0, 1/100)."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(0.5 * rng.standard_normal(
        (b, l, NH * HD + 2 * g * DS)).astype(np.float32)).to(dtype)
    x = xbc[..., :NH * HD].reshape(b, l, NH, HD)
    bm = xbc[..., NH * HD:NH * HD + g * DS].reshape(b, l, g, DS)
    cm = xbc[..., NH * HD + g * DS:].reshape(b, l, g, DS)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, NH)))).astype(np.float32)
    for r in strong:
        dt[:, r] *= 40.0
    for r0, r1 in zero:
        dt[:, r0:r1] = 0.0
    if lens is not None:
        dt[np.arange(l)[None, :] >= np.asarray(lens)[:, None]] = 0.0
    a = -torch.linspace(1.0, 16.0, NH)
    h0 = torch.from_numpy(
        0.1 * rng.standard_normal((b, NH, HD, DS)).astype(np.float32))
    return x, torch.from_numpy(dt), a, bm, cm, h0


Q = CHUNK
CASES = {
    # (B, L, kwargs, chunk)
    "zero_first": (1, 3 * Q, dict(zero=[(0, Q)]), Q),
    "zero_middle": (1, 3 * Q, dict(zero=[(Q, 2 * Q)]), Q),
    "zero_last": (1, 3 * Q, dict(zero=[(2 * Q, 3 * Q)]), Q),
    "empty_row": (2, 40, dict(lens=[40, 0]), Q),
    "bridge_rows": (6, 300, dict(lens=[0, 1, Q - 1, Q, Q + 1, 300]), Q),
    "one_dt": (1, 2 * Q, dict(zero=[(Q, Q + 5), (Q + 6, 2 * Q)]), Q),
    "strong_decay": (2, 45, dict(strong=[3, 20, 33]), Q),
    "split_walk": (1, 150, dict(strong=[70], zero=[(96, 100)]), 96),
}


def _expected_skips(dt, q):
    """(row, chunk, head) -> skipped: dt 0 on every row of the chunk."""
    b, l, nh = dt.shape
    nc = -(-l // q)
    d = torch.nn.functional.pad(dt, (0, 0, 0, nc * q - l))
    return (d.reshape(b, nc, q, nh) == 0).all(2)


@pytest.mark.parametrize("g", [1, NH], ids=["g1", "per_head"])
@pytest.mark.parametrize("dtype", [F32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rehearsal_matches_plain_and_jax(name, dtype, g):
    b, l, kw, chunk = CASES[name]
    args = _inputs(sorted(CASES).index(name), b, l, g, dtype=dtype, **kw)
    y, st, tally, visits, gtally = rehearse(*args, chunk)
    # every (row, chunk, head, slice) once, skipped exactly where dt = 0
    skipped = _expected_skips(args[1], min(chunk, l))
    assert bool((visits == 1).all())
    assert torch.equal(tally == 2, skipped[..., None].expand_as(tally))
    hpg = NH // g
    gskip = skipped.reshape(*skipped.shape[:2], g, hpg).all(3)
    assert torch.equal(gtally == 2, gskip)
    assert y.dtype == dtype and st.dtype == F32
    if dtype == F32:
        py, ps = tref.ref_ssd_scan(*args, chunk=chunk)
        torch.testing.assert_close(y, py, **TOL)
        torch.testing.assert_close(st, ps, **TOL)
        x, dt, a, bm, cm, h0 = (jnp.asarray(t.numpy()) for t in args)
        jy, js = ssd_chunked(x, dt, a, bm, cm, chunk, init_state=h0)
        if "strong" in kw:
            # ssd_chunked takes cum_t - cum_s, which keeps fewer digits
            # after a 40x decay (it moves ~1e-3 of |y| ~ 200 here): held
            # as the kernel is, to 1e-4 of each (row, head)'s largest
            _, yb, _, sb = tref.ssd_error_bound(*args, chunk)
            assert bool(((y - torch.from_numpy(np.array(jy))).abs()
                         <= yb).all())
            assert bool(((st - torch.from_numpy(np.array(js))).abs()
                         <= sb).all())
        else:
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
            np.testing.assert_allclose(st.numpy(), np.asarray(js), **TOL)
    else:
        yr, yb, sr, sb = tref.ssd_error_bound(*args, chunk)
        assert bool(((y.float() - yr).abs() <= yb).all())
        assert bool(((st - sr).abs() <= sb).all())


@pytest.mark.parametrize("name", ["bridge_rows", "one_dt", "zero_middle"])
def test_rehearsal_matches_pallas_interpret(name):
    """The per-head form (B/C repeated to heads, G = NH) against the
    Pallas kernel run in interpret mode, fp32."""
    b, l, kw, chunk = CASES[name]
    args = _inputs(7, b, l, 1, **kw)
    x, dt, a, bm, cm, h0 = args
    y, st, *_ = rehearse(*args, chunk)
    rep = [jnp.asarray(np.repeat(t.numpy(), NH, axis=2)) for t in (bm, cm)]
    py, ps = pallas_ssd(jnp.asarray(x.numpy()), jnp.asarray(dt.numpy()),
                        jnp.asarray(a.numpy()), *rep,
                        jnp.asarray(h0.numpy()), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(ps), **TOL)


def test_column_walk_gives_the_direct_sums_bits():
    """The running sums down each column, split at row 48 of 96, give
    the same bits as summing each seg(t, s) directly in row order."""
    rng = np.random.default_rng(11)
    n = 96
    la = torch.from_numpy(-np.abs(rng.standard_normal(n)).astype(np.float32)
                          * 3.0)
    dts = torch.ones(n)
    m, w = _column_walk(la, dts, torch.ones(n, n), n)
    for t in (0, 5, 47, 48, 49, 63, 64, 95):
        for s in (0, 1, 30, 47, 48, 64, 80, 95):
            if s > t:
                assert m[t, s] == 0
                continue
            seg = torch.zeros(())
            for r in range(s + 1, t + 1):
                seg = seg + la[r]
            assert m[t, s] == torch.exp(seg)
    last = torch.zeros(())
    for r in range(1, n):
        last = last + la[r]
    assert w[0] == torch.exp(last)
