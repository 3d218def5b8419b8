"""CPU rehearsal of the tile schedule of the port's bf16 attention
backward (``csrc/flash_attn_bwd.cu``, namespace ``tcore``), in plain
PyTorch, against the plain version (``repro_torch.kernels.ref
.flash_attn_bwd_plain``) and ``jax.vjp`` of the JAX oracle
(``repro.kernels.ref.ref_flash_attn``).

The rehearsal walks the kernels' own decomposition.  dK/dV: a block per
(128 keys, KV head, batch row), two warpgroups of 64 keys, walking the
query tiles whose band can reach its keys, 64 query vectors a tile (the
(row, head) pairs of 64 / rep rows and the rep heads of one KV head:
rep 1, 4, 5 with 4 idle vectors, 8), each with its lse and delta; a
warpgroup skips a tile no row of which reaches its keys, and masks
nothing on a tile inside every row's band.  dQ: a block per 128 query
vectors (25 rows and 3 idle vectors at rep 5), walking its band [lo, hi)
64 keys a tile.  Keys past each row's length are NaN in storage and the
rehearsal reads only positions inside the band, so a stray read shows.
P and dS are rounded to bf16 where the kernels round them (P before
dV's product, dS before dK's and dQ's).  Each block counts the (query
vector, key) pairs it visits: every pair of the band must be visited
exactly once in each kernel, so a schedule that drops or repeats a tile
fails before any chip time.

Tolerances: fp32 (nothing rounded) atol = rtol = 1e-5 against the plain
version and the JAX oracle — the same sums in another order.  bf16:
``ref.flash_attn_bwd_error_bound``, which carries both roundings.  The
JAX oracle averages junk on rows with no valid key and differentiates
it, where the kernels pass no gradient: it is held on three of the cases
whose rows all have keys.
"""
import math

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
from repro_torch.kernels import ref as tref  # noqa: E402

KEYS_WG, WGS = 64, 2        # keys a dK/dV warpgroup, warpgroups a block
Q_TILE = 64                 # query vectors a dK/dV walk step
DQ_VECS, DQ_KEYS = 128, 64  # query vectors a dQ block, keys a tile
LOG2E = math.log2(math.e)
TOL = dict(atol=1e-5, rtol=1e-5)
HKV, B, LQ, D = 2, 2, 150, 64
# S, q_offsets, kv_lengths, causal, window
CASES = {
    "causal": (150, [0, 0], [150, 150], True, None),
    "causal_offsets_kv_lengths": (300, [40, 150], [190, 260], True, None),
    "noncausal_kv_lengths": (200, [0, 0], [200, 77], False, None),
    "window": (300, [20, 150], [170, 300], True, 37),
    "noncausal_window": (150, [0, 0], [150, 150], False, 50),
    "keyless_row": (200, [0, 0], [130, 0], True, None),
}
# the cases held to jax.vjp too: every row has a key (two key depths, so
# two sets of shapes to trace)
JAX_CASES = ("causal_offsets_kv_lengths", "window", "noncausal_window")


def _round(x, on):
    return x.to(torch.bfloat16).float() if on else x


def _row_band(pos0, r, n_rows, kv_hi, causal, window):
    """``TileArgs::row_band`` over local rows r (a tensor): [klo, khi),
    empty for r >= n_rows."""
    klo = torch.clamp(pos0 + r - window + 1, min=0) if window else \
        torch.zeros_like(r)
    khi = torch.clamp(pos0 + r + 1, max=kv_hi) if causal else \
        torch.full_like(r, kv_hi)
    return klo, torch.where(r < n_rows, khi, torch.zeros_like(r))


def _vectors(q, do, lse, delta, b, g, r0, n_rows, rep, n):
    """A tile of n query vectors from row r0 of group g: vector i = (row
    r0 + i // rep, head g rep + i % rep); Q, dO, lse, delta staged, zeros
    past its n_rows * rep real vectors (the cp.async zero-fill)."""
    d = q.shape[-1]
    i = torch.arange(n)
    real = i < n_rows * rep
    rows, heads = r0 + i // rep, g * rep + i % rep
    qt, dot = torch.zeros(n, d), torch.zeros(n, d)
    lt, dt = torch.zeros(n), torch.zeros(n)
    qt[real] = q[b, rows[real], heads[real]].float()
    dot[real] = do[b, rows[real], heads[real]].float()
    lt[real] = lse[b, heads[real], rows[real]]
    dt[real] = delta[b, heads[real], rows[real]]
    return real, rows, heads, qt, dot, lt, dt


def _keys(buf, b, g, kb, n, hi):
    """n key rows from position kb, zeros at positions >= hi, which are
    never read."""
    pos = torch.arange(kb, kb + n)
    t = torch.zeros(n, buf.shape[-1])
    live = pos < hi
    t[live] = buf[b, pos[live], g].float()
    return pos, t


def _visit(visits, b, rows, heads, real, kb, ok):
    """Count the pairs (vector, key kb + j) a warpgroup visits; ok is
    (vectors, keys)."""
    s = visits.shape[-1]
    n = min(ok.shape[1], s - kb)
    visits[b, rows[real], heads[real], kb:kb + n] += \
        ok[real][:, :n].long()


def tile_dkdv(q, k, v, lse, delta, do, offs, lens, causal, window, rnd,
              visits):
    """``dkdv_tc_kernel``'s schedule; returns (dk, dv) fp32."""
    b_, lq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    rows_per = Q_TILE // rep
    sl2 = LOG2E / math.sqrt(d)
    dk = torch.full((b_, s, hkv, d), float("nan"))
    dv = torch.full((b_, s, hkv, d), float("nan"))
    for b in range(b_):
        kv_hi, off = min(max(lens[b], 0), s), offs[b]
        for g in range(hkv):
            for k0 in range(0, s, KEYS_WG * WGS):
                ak = torch.zeros(KEYS_WG * WGS, d)
                av = torch.zeros(KEYS_WG * WGS, d)
                if k0 < kv_hi:
                    _, kt = _keys(k, b, g, k0, KEYS_WG * WGS, kv_hi)
                    _, vt = _keys(v, b, g, k0, KEYS_WG * WGS, kv_hi)
                    k_end = min(k0 + KEYS_WG * WGS, kv_hi)
                    r_lo = max(0, k0 - off) if causal else 0
                    r_hi = min(lq, k_end - 1 + window - off) if window \
                        else lq
                    for r0 in range(r_lo, r_hi, rows_per):
                        n_rows = min(rows_per, lq - r0)
                        real, rows, heads, qt, dot, lt, dt = _vectors(
                            q, do, lse, delta, b, g, r0, n_rows, rep,
                            Q_TILE)
                        i = torch.arange(Q_TILE)
                        local = torch.where(real, i // rep,
                                            torch.full_like(i, n_rows))
                        klo, khi = _row_band(off + r0, local, n_rows, kv_hi,
                                             causal, window)
                        ends = _row_band(off + r0, torch.tensor(
                            [0, n_rows - 1]), n_rows, kv_hi, causal, window)
                        (lo_first, lo_last), (hi_first, hi_last) = \
                            ends[0].tolist(), ends[1].tolist()
                        for w in range(WGS):
                            kw = k0 + KEYS_WG * w
                            if kw >= hi_last or kw + KEYS_WG <= lo_first:
                                continue
                            inside = lo_last <= kw and \
                                kw + KEYS_WG <= hi_first
                            keys = torch.arange(kw, kw + KEYS_WG)
                            ok = (keys[None, :] >= klo[:, None]) & \
                                (keys[None, :] < khi[:, None])  # (vec, key)
                            if inside:
                                assert ok[real].all()
                                ok = real[:, None].expand_as(ok)
                            sl = slice(KEYS_WG * w, KEYS_WG * (w + 1))
                            st = kt[sl] @ qt.T                  # S^T
                            dpt = vt[sl] @ dot.T                # dP^T
                            pt = torch.exp2(st * sl2 - lt[None] * LOG2E)
                            if not inside:
                                pt = torch.where(ok.T, pt,
                                                 torch.zeros(()))
                            dst = pt * (dpt - dt[None])
                            av[sl] += _round(pt, rnd) @ dot
                            ak[sl] += _round(dst, rnd) @ qt
                            _visit(visits, b, rows, heads, real, kw, ok)
                n = min(KEYS_WG * WGS, s - k0)
                dk[b, k0:k0 + n, g] = ak[:n] / math.sqrt(d)
                dv[b, k0:k0 + n, g] = av[:n]
    return dk, dv


def tile_dq(q, k, v, lse, delta, do, offs, lens, causal, window, rnd,
            visits):
    """``dq_tc_kernel``'s schedule; returns dq fp32."""
    b_, lq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    rows_per = DQ_VECS // rep
    sl2 = LOG2E / math.sqrt(d)
    dq = torch.full((b_, lq, hq, d), float("nan"))
    for b in range(b_):
        kv_hi, off = min(max(lens[b], 0), s), offs[b]
        for g in range(hkv):
            for r0 in range(0, lq, rows_per):
                n_rows = min(rows_per, lq - r0)
                pos0 = off + r0
                real, rows, heads, qt, dot, lt, dt = _vectors(
                    q, do, lse, delta, b, g, r0, n_rows, rep, DQ_VECS)
                i = torch.arange(DQ_VECS)
                local = torch.where(real, i // rep,
                                    torch.full_like(i, n_rows))
                klo, khi = _row_band(pos0, local, n_rows, kv_hi, causal,
                                     window)
                lo = max(0, pos0 - window + 1) if window else 0
                hi = min(kv_hi, pos0 + n_rows) if causal else kv_hi
                ends = _row_band(pos0, torch.tensor([0, n_rows - 1]),
                                 n_rows, kv_hi, causal, window)
                lo_last, hi_first = int(ends[0][1]), int(ends[1][0])
                acc = torch.zeros(DQ_VECS, d)
                for kb in range(lo, hi, DQ_KEYS):
                    pos, kt = _keys(k, b, g, kb, DQ_KEYS, hi)
                    _, vt = _keys(v, b, g, kb, DQ_KEYS, hi)
                    inside = lo_last <= kb and kb + DQ_KEYS <= hi_first
                    ok = (pos[None, :] >= klo[:, None]) & \
                        (pos[None, :] < khi[:, None])
                    if inside:
                        assert ok[real].all()
                        ok = real[:, None].expand_as(ok)
                    p = torch.exp2((qt @ kt.T) * sl2 - lt[:, None] * LOG2E)
                    if not inside:
                        p = torch.where(ok, p, torch.zeros(()))
                    ds = p * (dot @ vt.T - dt[:, None])
                    acc += _round(ds, rnd) @ kt
                    _visit(visits, b, rows, heads, real, kb, ok)
                dq[b, rows[real], heads[real]] = acc[real] / math.sqrt(d)
    return dq


def _case(seed, rep, case, dtype):
    """Inputs in ``dtype`` with each row's keys past its length NaN in
    the storage the rehearsal reads (clean copies for the references),
    the plain forward's out and lse, delta as the kernel forms it."""
    s, offs, lens, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    hq = HKV * rep

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    q, k, v, do = (rand(B, LQ, hq, D), rand(B, s, HKV, D),
                   rand(B, s, HKV, D), rand(B, LQ, hq, D))
    o = torch.tensor(offs, dtype=torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32)
    kw = dict(causal=causal, window=window)
    out = tref.ref_flash_attn(q.float(), k.float(), v.float(), o, ln,
                              **kw).to(dtype)
    lse = tref.ref_flash_attn_lse(q.float(), k.float(), o, ln, **kw)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
    kn, vn = k.clone(), v.clone()
    for b, n in enumerate(lens):
        kn[b, max(n, 0):] = float("nan")
        vn[b, max(n, 0):] = float("nan")
    return (q, k, v, do, out, lse, o, ln, kw), (kn, vn, delta)


def _rehearse(inputs, poisoned, rnd):
    """Both kernels' schedules; returns ((dq, dk, dv) fp32, visits of
    dK/dV, visits of dQ, the band)."""
    q, k, v, do, out, lse, o, ln, kw = inputs
    kn, vn, delta = poisoned
    offs, lens = o.tolist(), ln.tolist()
    shape = (B, LQ, q.shape[2], k.shape[1])
    seen_kv = torch.zeros(shape, dtype=torch.long)
    seen_q = torch.zeros(shape, dtype=torch.long)
    dk, dv = tile_dkdv(q, kn, vn, lse, delta, do, offs, lens, kw["causal"],
                       kw["window"], rnd, seen_kv)
    dq = tile_dq(q, kn, vn, lse, delta, do, offs, lens, kw["causal"],
                 kw["window"], rnd, seen_q)
    _, mask = tref._flash_scores(q.float(), k.float(), o, ln, kw["causal"],
                                 kw["window"])
    band = mask[:, :, None, :].expand(shape).long()          # (B, L, Hq, S)
    return (dq, dk, dv), seen_kv, seen_q, band


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4, 5, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_schedule_visits_the_band_once_and_matches_plain(case, rep,
                                                              dtype):
    """Each kernel visits every (query vector, key) pair of the band
    exactly once and nothing else; never reads a key past a length (NaN
    there stays out of every gradient); dq, dk, dv held to the plain
    backward: 1e-5 in fp32, ``flash_attn_bwd_error_bound`` in bf16 with
    P and dS rounded where the kernels round them."""
    inputs, poisoned = _case(11, rep, case, dtype)
    rnd = dtype == torch.bfloat16
    got, seen_kv, seen_q, band = _rehearse(inputs, poisoned, rnd)
    assert torch.equal(seen_kv, band)
    assert torch.equal(seen_q, band)
    for x in got:
        assert torch.isfinite(x).all()
    q, k, v, do, out, lse, o, ln, kw = inputs
    if dtype == torch.float32:
        want = tref.flash_attn_bwd_plain(q, k, v, out, lse, do, o, ln, **kw)
        for x, w in zip(got, want):
            np.testing.assert_allclose(x.numpy(), w.numpy(), **TOL)
        return
    refs, bounds = tref.flash_attn_bwd_error_bound(q, k, v, out, lse, do, o,
                                                   ln, **kw)
    for x, r, bd in zip(got, refs, bounds):
        assert ((x.to(dtype).float() - r).abs() <= bd).all()


@pytest.mark.parametrize("case", JAX_CASES)
def test_tile_schedule_matches_jax_vjp(case):
    """The fp32 rehearsal at rep 5 (idle vectors in every tile) against
    ``jax.vjp`` of the reference's ``ref_flash_attn``."""
    inputs, poisoned = _case(12, 5, case, torch.float32)
    got, _, _, _ = _rehearse(inputs, poisoned, False)
    q, k, v, do, out, lse, o, ln, kw = inputs
    _, vjp = jax.vjp(
        lambda a, b_, c: jref.ref_flash_attn(
            a, b_, c, q_offsets=jnp.asarray(o.numpy()),
            kv_lengths=jnp.asarray(ln.numpy()), **kw),
        q.numpy(), k.numpy(), v.numpy())
    want = vjp(jnp.asarray(do.numpy()))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)
