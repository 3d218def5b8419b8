"""CPU rehearsal of the tile schedule of the port's SSD backward on the
tensor cores (``csrc/ssd_scan_bwd.cu``), in plain PyTorch, against the
plain version (``repro_torch.kernels.ref.ref_ssd_scan_bwd``) and
``jax.vjp`` of the reference's ``repro.models.mamba.ssd_chunked``.

The rehearsal walks the kernels' own decomposition:

- the dH pass: per (batch row, head, chunk) the chunk's term
  dyᵀ·(e ∘ C) of the state gradient (HD x DS, over the chunk's rows),
  then one reverse pass over the chunks, dH ← e_last·dH + term, which
  leaves each chunk's end-state gradient and the initial state's;
- the head blocks, one per (batch row, chunk, head): the decays from
  the forward's running sums in 16-row tiles (E(t, s) = EA[tile t][s] ·
  ER[t] across tiles, a direct sum inside a tile, never cum_t − cum_s),
  Gᵀ = x·dyᵀ, Mᵀ = E ∘ (C·Bᵀ)ᵀ ∘ dt_s, dx = Mᵀ·dy + w ∘ (B·dHᵀ), the
  row and column sums of dseg, d dt and the chunk's da partial;
- the group blocks, one per (batch row, chunk, group, 64 DS columns,
  range of heads): dCB = Σ_h G_h ∘ E_h ∘ dt_h summed over the range's
  heads in head order BEFORE its products, dB = dCBᵀ·C + Σ_h w_h ∘
  (x_h·dH_h), dC = dCB·B + Σ_h e_h ∘ (dy_h·H_h), the ranges' partials
  summed in range order (``kernels.ssd_scan.bwd_ranges``).

Every fp32-valued operand of a product (Mᵀ, dCB, dH, H, e ∘ C) enters
split as hi + lo bf16 (hi = bf16(v), lo = bf16(v − hi)), as the
kernels' two MMAs per product take it; x, dy, B and C are bf16 and
exact.  Each block counts what it visits: every (row, chunk, head)
once in the head blocks and once in its group's range, every DS column
once per range.

Tolerances: ``GRAD_TOL`` of ``tests/test_torch_ssd_bwd.py`` (atol 1e-5
scaled by the leaf's largest |grad| above 1, rtol 1e-4) against the
plain version, autograd of ``ref_ssd_scan`` and ``jax.vjp``; the split
operands keep 16 bits of each value, ~2^-17 relative.  The schedule
with one head dropped from a group's sum, or one chunk's term dropped
from the dH pass, lies outside ``ref.ssd_bwd_error_bound``.
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
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
NAMES = ("x", "dt", "a", "bmat", "cmat", "init_state")
TILE = 16                      # rows of a decay tile and of an MMA tile

# (B, L, NH, HD, G, DS, chunk), as tests/test_torch_ssd_bwd.py, and a
# chunk whose dt is 0 on every row of every head
CASES = {
    "off_grid_g1": (2, 40, 4, 8, 1, 16, 16),
    "groups": (2, 37, 8, 8, 2, 16, 8),
    "per_head": (1, 64, 4, 8, 4, 16, 32),
    "short": (2, 5, 4, 8, 4, 16, 8),
    "one_token": (1, 1, 4, 8, 2, 16, 128),
    "zero_dt_chunk": (2, 48, 4, 8, 2, 16, 16),
}
ZERO_CHUNK = (16, 32)          # rows of the zero-dt chunk


def _inputs(seed, name):
    """As ``tests/test_torch_ssd_bwd.py``: x, B, C ~ N(0, 1); dt =
    softplus(N(0, 1)) with every 7th row 0 (a whole chunk 0 in
    ``zero_dt_chunk``); a = -exp(0.3 N(0, 1)); a non-zero init state; dy
    and the final state's gradient ~ N(0, 1)."""
    b, l, nh, hd, g, ds, chunk = CASES[name]
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, nh, hd)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, nh)))).astype(f)
    dt[:, ::7] = 0.0
    if name == "zero_dt_chunk":
        dt[:, ZERO_CHUNK[0]:ZERO_CHUNK[1]] = 0.0
    a = -np.exp(0.3 * rng.standard_normal(nh)).astype(f)
    bg = rng.standard_normal((b, l, g, ds)).astype(f)
    cg = rng.standard_normal((b, l, g, ds)).astype(f)
    h0 = rng.standard_normal((b, nh, hd, ds)).astype(f)
    dy = rng.standard_normal((b, l, nh, hd)).astype(f)
    dst = rng.standard_normal((b, nh, hd, ds)).astype(f)
    return (x, dt, a, bg, cg, h0), dy, dst


def _split(v):
    """An fp32 operand as the kernels' two MMAs take it: hi + lo bf16."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _pad(t, rows):
    """t's first dim zero-padded to ``rows``."""
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def decays(la, n):
    """The decay tables of one (chunk, head) as the kernels build them
    from la = dt·a (zero past the chunk's n rows, padded to 16): E (qp,
    qp) with E[t, s] = exp(seg(t, s)) for s <= t, 0 above; e_t =
    exp(cum_t); esl_s = E[n - 1, s].  Across 16-row tiles E = EA[tile
    t][s]·ER[t], EA the sum of la over s < r < the tile's first row
    (the rest of s's tile, then whole-tile sums), ER the sum from the
    tile's first row to t; inside a tile a direct sum.  Every sum adds
    terms of one sign, so none loses digits as cum_t − cum_s would."""
    qp = la.shape[0]
    nt = qp // TILE
    tl = la.reshape(nt, TILE)
    pre = torch.cumsum(tl, 1).reshape(qp)                 # tile start .. t
    ts = tl.sum(1)                                        # whole tiles
    # the rest of s's tile past s: sum over s < r <= the tile's last row
    suf = torch.flip(torch.cumsum(torch.flip(tl, (1,)), 1), (1,))
    rest = torch.cat([suf[:, 1:], suf.new_zeros((nt, 1))], 1).reshape(qp)
    cum = torch.cat([ts.new_zeros(1), torch.cumsum(ts, 0)[:-1]])
    e = torch.exp(cum.repeat_interleave(TILE) + pre)
    tile = torch.arange(qp) // TILE
    # EA[i, s] for tile(s) < i: rest(s) + whole tiles tile(s) + 1 .. i - 1,
    # summed on from rest(s) (a running sum, not a difference of cums)
    later = torch.arange(nt)[:, None] > tile[None, :]     # (i', s)
    run = torch.cumsum(torch.where(later, ts[:, None], torch.zeros(())), 0)
    exc = torch.cat([run.new_zeros((1, qp)), run[:-1]])   # i' < i
    ea = rest[None, :] + exc                              # (i, s)
    e_across = torch.exp(ea[tile]) * torch.exp(pre)[:, None]   # (t, s)
    r = torch.arange(qp)
    within = (r[None, :, None] > r[None, None, :]) \
        & (r[None, :, None] <= r[:, None, None])          # (t, r, s): s<r<=t
    e_within = torch.exp((within * la[None, :, None]).sum(1))
    same = tile[:, None] == tile[None, :]
    lower = r[:, None] >= r[None, :]
    big = torch.where(same, e_within, e_across)
    big = torch.where(lower, big, torch.zeros_like(big))
    return big, e, big[n - 1].clone()


def dstate_pass(x, dt, a, bm, cm, dy, dstate, q, drop_chunk=None):
    """The dH pass: each (row, head, chunk)'s term dyᵀ·split(e ∘ C), then
    the reverse pass.  Returns (dHs (B, NH, nc, HD, DS) end-state
    gradients, dinit)."""
    b, l, nh, hd = x.shape
    g, ds = bm.shape[2], bm.shape[3]
    hpg, nc = nh // g, -(-l // q)
    terms = torch.zeros((b, nh, nc, hd, ds))
    elast = torch.zeros((b, nh, nc))
    for bi in range(b):
        for h in range(nh):
            for c in range(nc):
                r0, n = c * q, min(q, l - c * q)
                qp = -(-n // TILE) * TILE
                la = _pad(dt[bi, r0:r0 + n, h] * a[h], qp)
                _, e, _ = decays(la, n)
                ec = e[:n, None] * cm[bi, r0:r0 + n, h // hpg]
                terms[bi, h, c] = dy[bi, r0:r0 + n, h].T @ _split(ec)
                elast[bi, h, c] = e[n - 1]
    run = torch.zeros((b, nh, hd, ds)) if dstate is None else dstate.clone()
    dhs = torch.zeros_like(terms)
    for c in reversed(range(nc)):
        dhs[:, :, c] = run
        term = 0.0 if c == drop_chunk else terms[:, :, c]
        run = elast[:, :, c, None, None] * run + term
    return dhs, run


def head_block(x, dy, dtc, av, bc, cc, hs, dh, n, visits):
    """One head block: one (batch row, chunk, head), its rows padded to
    16.  Returns (dx (n, HD), ddt (n,), da partial)."""
    qp = -(-n // TILE) * TILE
    x, dy, bc, cc = (_pad(t, qp) for t in (x, dy, bc, cc))
    dtc = _pad(dtc, qp)
    la = dtc * av
    big, e, esl = decays(la, n)
    et = big.T                                            # (s, t)
    cbt = bc @ cc.T                                       # B_s . C_t
    gt = x @ dy.T                                         # x_s . dy_t
    upper = torch.ones((qp, qp), dtype=torch.bool).triu()
    strict = torch.ones((qp, qp), dtype=torch.bool).triu(1)
    u = torch.where(upper, gt * et * cbt, torch.zeros(()))
    mt = torch.where(upper, et * cbt * dtc[:, None], torch.zeros(()))
    ddte = u.sum(1)
    dseg = torch.where(strict, u * dtc[:, None], torch.zeros(()))
    colsum, rowsum = dseg.sum(1), dseg.sum(0)
    ch = cc @ _split(hs).T                                # C_t . H
    dcum = e * (dy * ch).sum(1)
    dxa = bc @ _split(dh).T                               # B_s . dH
    dw = (x * dxa).sum(1)
    w = esl * dtc
    dx = w[:, None] * dxa + _split(mt) @ dy
    dlast = e[n - 1] * (dh * hs).sum()
    dsw = dw * w
    dsw[n - 1:] = 0.0
    rowsum[n - 1] += dsw.sum()
    colsum = colsum + dsw
    d = dcum + rowsum - colsum
    d[n - 1] += dlast
    dla = torch.zeros(qp)
    acc = torch.zeros(())
    for t in reversed(range(n)):
        acc = acc + d[t]
        dla[t] = acc
    ddt = ddte + dw * esl + dla * av
    visits["head"] += 1
    return dx[:n], ddt[:n], (dla * dtc).sum()


def group_block(xs, dys, dts, avs, bc, cc, hs, dhs, n, k0, k1, visits,
                drop_head=None):
    """One group block: one (batch row, chunk, group), DS columns [k0,
    k1), the heads of one range (lists in head order).  Returns the
    range's dB and dC partials (n, k1 - k0)."""
    qp = -(-n // TILE) * TILE
    bc, cc = _pad(bc, qp), _pad(cc, qp)
    upper = torch.ones((qp, qp), dtype=torch.bool).triu()
    dcbt = torch.zeros((qp, qp))                          # (s, t)
    db = torch.zeros((qp, k1 - k0))
    dc = torch.zeros((qp, k1 - k0))
    for j, (x, dy, dtc, av, h, dh) in enumerate(zip(xs, dys, dts, avs, hs,
                                                    dhs)):
        visits["group"] += 1
        if j == drop_head:
            continue
        x, dy, dtc = _pad(x, qp), _pad(dy, qp), _pad(dtc, qp)
        big, e, esl = decays(dtc * av, n)
        gt = x @ dy.T
        dcbt += torch.where(upper, gt * big.T * dtc[:, None],
                            torch.zeros(()))
        w = esl * dtc
        db += w[:, None] * (x @ _split(dh[:, k0:k1]))
        dc += e[:, None] * (dy @ _split(h[:, k0:k1]))
    visits["cols"] += k1 - k0
    db += _split(dcbt) @ cc[:, k0:k1]               # dB_s: sum over t
    dc += _split(dcbt).T @ bc[:, k0:k1]             # dC_t: sum over s
    return db[:n], dc[:n]


def rehearse(x, dt, a, bm, cm, states, dy, dstate, chunk, *,
             drop_head=None, drop_chunk=None):
    """The six gradients by the kernels' schedule, and the visit counts.
    ``drop_head``: skip the range's head at this index in every group
    sum; ``drop_chunk``: skip this chunk's term in the dH pass."""
    b, l, nh, hd = x.shape
    g, ds = bm.shape[2], bm.shape[3]
    hpg, q = nh // g, min(chunk, l)
    nc = -(-l // q)
    xf, bf, cf, dyf = (t.float() for t in (x, bm, cm, dy))
    dtf, af = dt.float(), a.float()
    dhs, dinit = dstate_pass(xf, dtf, af, bf, cf, dyf, dstate, q,
                             drop_chunk)
    dx = torch.zeros((b, l, nh, hd))
    ddt = torch.zeros((b, l, nh))
    pda = torch.zeros((nh, b, nc))
    ranges, per = tssd.bwd_ranges(b, l, nh, ds, g, chunk)
    parts = torch.zeros((ranges, 2, b, l, g, ds))
    visits = {"head": 0, "group": 0, "cols": 0}
    for bi in range(b):
        for c in range(nc):
            r0, n = c * q, min(q, l - c * q)
            rows = slice(r0, r0 + n)
            for h in range(nh):
                gi = h // hpg
                dxh, ddth, da = head_block(
                    xf[bi, rows, h], dyf[bi, rows, h], dtf[bi, rows, h],
                    af[h], bf[bi, rows, gi], cf[bi, rows, gi],
                    states[bi, h, c], dhs[bi, h, c], n, visits)
                dx[bi, rows, h], ddt[bi, rows, h] = dxh, ddth
                pda[h, bi, c] = da
            for gi in range(g):
                for r in range(ranges):
                    heads = range(gi * hpg + r * per,
                                  min(gi * hpg + (r + 1) * per,
                                      (gi + 1) * hpg))
                    for k0 in range(0, ds, tssd.BWD_KT):
                        k1 = min(k0 + tssd.BWD_KT, ds)
                        db, dc = group_block(
                            [xf[bi, rows, h] for h in heads],
                            [dyf[bi, rows, h] for h in heads],
                            [dtf[bi, rows, h] for h in heads],
                            [af[h] for h in heads], bf[bi, rows, gi],
                            cf[bi, rows, gi],
                            [states[bi, h, c] for h in heads],
                            [dhs[bi, h, c] for h in heads], n, k0, k1,
                            visits, drop_head)
                        parts[r, 0, bi, rows, gi, k0:k1] = db
                        parts[r, 1, bi, rows, gi, k0:k1] = dc
    dbm, dcm = parts[0, 0].clone(), parts[0, 1].clone()
    for r in range(1, ranges):                            # range order
        dbm += parts[r, 0]
        dcm += parts[r, 1]
    da = torch.zeros(nh)
    for bi in range(b):
        for c in range(nc):
            da += pda[:, bi, c]
    grads = (dx.to(x.dtype), ddt, da, dbm.to(bm.dtype), dcm.to(cm.dtype),
             dinit)
    return grads, visits


def _run(name, seed, dstate=True, **kw):
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args, dy, dst = _inputs(seed, name)
    t = [torch.from_numpy(v) for v in args]
    dyt = torch.from_numpy(dy)
    dstt = torch.from_numpy(dst) if dstate else None
    _, _, states = tref.ref_ssd_scan(*t, chunk=chunk, return_states=True)
    got, visits = rehearse(*t[:5], states, dyt, dstt, chunk, **kw)
    return (args, dy, dst if dstate else None, t, dyt, dstt, states, got,
            visits)


def _assert_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        atol = GRAD_TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0)))
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no_dstate"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_the_plain_backward(name, dstate):
    """The schedule's six gradients against ``ref_ssd_scan_bwd`` at
    ``GRAD_TOL``; every (row, chunk, head) visited once by the head
    blocks and once by its group's range, every DS column once a range."""
    b, l, nh, hd, g, ds, chunk = CASES[name]
    _, _, _, t, dyt, dstt, states, got, visits = _run(name, 1, dstate)
    want = tref.ref_ssd_scan_bwd(*t, dyt, dstt, chunk=chunk, states=states)
    _assert_grads([v.numpy() for v in got], [w.numpy() for w in want])
    nc = tssd.n_chunks(l, chunk)
    ranges, _ = tssd.bwd_ranges(b, l, nh, ds, g, chunk)
    assert visits["head"] == b * nc * nh
    assert visits["group"] == b * nc * nh * -(-ds // tssd.BWD_KT)
    assert visits["cols"] == b * nc * g * ranges * ds


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax_vjp_and_autograd(name):
    """The schedule against ``jax.vjp`` of ``ssd_chunked`` and autograd of
    ``ref_ssd_scan``, at ``GRAD_TOL``."""
    b, l, nh, hd, g, ds, chunk = CASES[name]
    args, dy, dst, t, dyt, dstt, _, got, _ = _run(name, 2)
    got = [v.numpy() for v in got]
    _, vjp = jax.vjp(
        lambda x, dt, a, bg, cg, h0: ssd_chunked(x, dt, a, bg, cg, chunk,
                                                 init_state=h0),
        *(jnp.asarray(v) for v in args))
    _assert_grads(got, [np.asarray(w) for w in vjp((jnp.asarray(dy),
                                                    jnp.asarray(dst)))])
    leaves = [v.clone().requires_grad_() for v in t]
    y, st = tref.ref_ssd_scan(*leaves, chunk=chunk)
    want = torch.autograd.grad((y * dyt).sum() + (st * dstt).sum(), leaves)
    _assert_grads(got, [w.numpy() for w in want])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_inputs_lie_inside_the_error_bound(dtype):
    """On inputs in the storage type the schedule (operands split, dx, dB
    and dC rounded once) lies inside ``ssd_bwd_error_bound``, unwidened."""
    b, l, nh, hd, g, ds, chunk = CASES["groups"]
    args, dy, dst = _inputs(3, "groups")
    t = [torch.from_numpy(v) for v in args]
    x, bg, cg = (t[i].to(dtype) for i in (0, 3, 4))
    dyt, dstt = torch.from_numpy(dy).to(dtype), torch.from_numpy(dst)
    _, _, states = tref.ref_ssd_scan(x.float(), t[1], t[2], bg.float(),
                                     cg.float(), t[5], chunk=chunk,
                                     return_states=True)
    got, _ = rehearse(x, t[1], t[2], bg, cg, states, dyt, dstt, chunk)
    refs, bounds = tref.ssd_bwd_error_bound(x, t[1], t[2], bg, cg, t[5], dyt,
                                            dstt, states, chunk)
    for i, (v, r, bd) in enumerate(zip(got, refs, bounds)):
        assert ((v.float() - r).abs() <= bd).all(), NAMES[i]


@pytest.mark.parametrize("mutant", ["drop_head", "drop_chunk"])
def test_error_bound_rejects_a_dropped_head_or_chunk(mutant):
    """The schedule with the first head of every range left out of its
    group's sum (dB, dC move), or the middle chunk's term left out of the
    dH pass (dx, d dt, dB and dinit of the earlier chunks move), lies
    outside ``ssd_bwd_error_bound``."""
    b, l, nh, hd, g, ds, chunk = CASES["off_grid_g1"]
    kw = {"drop_head": 0} if mutant == "drop_head" else {"drop_chunk": 1}
    _, _, _, t, dyt, dstt, states, got, _ = _run("off_grid_g1", 4, **kw)
    refs, bounds = tref.ssd_bwd_error_bound(*t, dyt, dstt, states, chunk)
    moved = [i for i, (v, r, bd) in enumerate(zip(got, refs, bounds))
             if ((v.float() - r).abs() > bd).any()]
    want = [3, 4] if mutant == "drop_head" else [0, 1, 3, 5]
    assert all(i in moved for i in want), moved


def test_decay_tables_are_the_direct_sums():
    """E from the tiles' tables equals exp of seg summed directly in fp64
    (1e-5 relative: fp32 seg keeps |seg|·2^-24, ~2e-6 at the spike), 0
    above the diagonal, across tile edges and with a spike
    of decay early in a tile; e_t = exp(cum_t)."""
    rng = np.random.default_rng(5)
    for n in (1, 15, 16, 17, 40, 128):
        qp = -(-n // TILE) * TILE
        la = -np.abs(rng.standard_normal(qp)).astype(np.float32)
        la[min(n, 17) - 1] = -30.0
        la[n:] = 0.0
        big, e, esl = decays(torch.from_numpy(la), n)
        seg = np.full((qp, qp), -np.inf)
        for t in range(qp):
            for s in range(t + 1):
                seg[t, s] = la[s + 1:t + 1].astype(np.float64).sum()
        want = np.exp(seg)
        np.testing.assert_allclose(big.numpy(), want, rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(e.numpy(), np.exp(np.cumsum(
            la.astype(np.float64))), rtol=1e-5, atol=1e-30)
        np.testing.assert_array_equal(esl.numpy(), big[n - 1].numpy())


def test_ranges_cover_each_group_once():
    """``bwd_ranges``: ranges x heads a range covers the group's heads
    with no empty range, and no other cut takes fewer (waves of
    ``BWD_SMS`` blocks) x (heads a block walks + ``BWD_BLOCK_HEADS``);
    mamba2's (4, 1024) takes 2 ranges of 40 heads, jamba's one."""
    for b, l, nh, ds, g in ((4, 1024, 80, 128, 1), (4, 1024, 128, 128, 8),
                            (2, 1000, 80, 128, 1), (1, 1, 4, 16, 2),
                            (2, 37, 16, 16, 2), (1, 257, 128, 200, 8)):
        ranges, per = tssd.bwd_ranges(b, l, nh, ds, g, 128)
        hpg = nh // g
        assert (ranges - 1) * per < hpg <= ranges * per
        base = b * tssd.n_chunks(l, 128) * g * -(-ds // tssd.BWD_KT)

        def cost(r, p):
            return -(-base * r // tssd.BWD_SMS) * (p + tssd.BWD_BLOCK_HEADS)
        assert all(cost(-(-hpg // p), p) >= cost(ranges, per)
                   for p in range(1, hpg + 1))
    assert tssd.bwd_ranges(4, 1024, 80, 128, 1, 128) == (2, 40)
    assert tssd.bwd_ranges(4, 1024, 128, 128, 8, 128) == (1, 16)
