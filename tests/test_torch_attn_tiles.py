"""CPU rehearsal of the tile schedule of the port's prefill attention
kernels (``csrc/attn_tiles.cuh`` through ``csrc/flash_attn.cu`` and
``csrc/ragged_prefill.cuh``), in plain PyTorch, against the plain
versions (``repro_torch.kernels.ref``) and the JAX oracles
(``repro.kernels.ref``).

The rehearsal walks the kernels' own decomposition: for the bf16 core,
M tiles of 128 query vectors over (row, head) pairs, rows outer and the
rep heads of one KV head inner (rep 1, 4, 5 and 8: 128, 32, 25 with 3
idle vectors, 16 rows), and N tiles of 64 keys; for the fp32 core, 32
vectors and 32 keys; each from the tile's band [lo, hi) (kv length, causal
frontier of its last row, window of its first); per-row key intervals;
an online softmax in log2 units; for the ragged kernels, tiles aligned
to segments and found by scanning cu_seqlens, ceil(T / rows) + B of
them launched, and the rows past cu_seqlens[B] written as zeros.  Every
key row is fetched through the layout's row map (page table, slot map,
gathered rows) and positions at or past the band are zero-filled and
never addressed: rows and pages past each length hold NaN, so a stray
read shows.  Each tile counts the (query vector, key) pairs it attends
and each output vector it writes, so a band that drops or repeats a key
tile, or a tile schedule that drops or repeats rows, fails before any
chip time.

Tolerances: fp32 (no rounding of p) atol = rtol = 1e-5 against the plain
versions and the JAX oracles — the same softmax in another summation
order.  With q, K, V in bf16 and p rounded to bf16 before P.V, as the
bf16 tile does, ``ref.kernel_error_bound``.  The JAX oracles average junk
on rows with no valid key, where the kernels write 0: those rows are
held to the plain versions only.
"""
import functools
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

# query vectors per M tile and keys per N tile of each core: the bf16
# tensor-core tile (p rounded to bf16) and the fp32 CUDA-core tile
CORES = {True: (128, 64), False: (32, 32)}
NEG = -1e30              # the kernels' finite initial running max
TOL = dict(atol=1e-5, rtol=1e-5)
HKV, PS = 2, 16


def _attend_tile(qv, rows, kbuf, vbuf, g, band, lo, hi, round_p, seen):
    """One block's walk: query vectors qv (n, D) fp32 with per-vector key
    intervals band = (klo, khi), over key positions [lo, hi) of the row
    map ``rows`` (a position -> storage row function) into K/V storage
    (rows, hkv, D), in the core's key tiles.  ``seen`` (n, hi) counts the
    pairs attended.  Returns the vectors' outputs (n, D)."""
    kn = CORES[round_p][1]
    n, d = qv.shape
    klo, khi = band
    sl2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((n,), NEG)
    l = torch.zeros(n)
    o = torch.zeros(n, d)
    for kb in range(lo, hi, kn):                   # the N tiles
        pos = torch.arange(kb, kb + kn)
        live = pos < hi                            # the rest zero-filled
        kt = torch.zeros(kn, d)
        vt = torch.zeros(kn, d)
        idx = torch.tensor([rows(int(p)) for p in pos[live]], dtype=torch.long)
        kt[live] = kbuf[idx, g].float()
        vt[live] = vbuf[idx, g].float()
        s = qv @ kt.T * sl2
        ok = (pos[None, :] >= klo[:, None]) & (pos[None, :] < khi[:, None])
        seen[:, pos[live]] += ok[:, live].long()
        s = torch.where(ok, s, torch.tensor(-math.inf))
        mx = torch.maximum(m, s.max(dim=1).values)
        p = torch.exp2(s - mx[:, None])
        alpha = torch.exp2(m - mx)
        l = alpha * l + p.sum(dim=1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        o = o * alpha[:, None] + p @ vt
        m = mx
    return o / torch.where(l == 0, torch.ones_like(l), l)[:, None]


def _tile(q, out, written, seen_all, rows, kbuf, vbuf, *, r0, n_rows, rep,
          g, pos0, kv_hi, causal, window, round_p, vec_base, kv_lo=0):
    """The tile core (``Tile::run``): stage the tile's query vectors
    (row r0 + i // rep, head g * rep + i % rep), derive the band and the
    rows' intervals as ``TileArgs`` does — keys in [kv_lo, kv_hi), the
    positions the layout holds — attend, write each vector."""
    hq, d = q.shape[-2], q.shape[-1]
    nv = n_rows * rep
    assert nv <= CORES[round_p][0]
    i = torch.arange(nv)
    r, h = i // rep, g * rep + i % rep
    qv = q[r0 + r, h].float()
    qpos = pos0 + r
    klo = torch.clamp(qpos - window + 1, min=kv_lo) if window else \
        torch.full((nv,), kv_lo, dtype=torch.long)
    khi = torch.clamp(qpos + 1, max=kv_hi) if causal else \
        torch.full((nv,), kv_hi)
    lo = max(kv_lo, pos0 - window + 1) if window else kv_lo
    hi = min(kv_hi, pos0 + n_rows) if causal else kv_hi
    seen = torch.zeros(nv, max(hi, 0), dtype=torch.long)
    o = _attend_tile(qv, rows, kbuf, vbuf, g, (klo, khi), lo, hi, round_p,
                     seen)
    out[r0 + r, h] = o.to(out.dtype)
    written[r0 + r, h] += 1
    for j in range(nv):                  # each pair attended exactly once
        want = torch.zeros(max(hi, 0), dtype=torch.long)
        want[int(klo[j]):max(int(khi[j]), int(klo[j]))] = 1
        assert torch.equal(seen[j], want), (vec_base, r0, j)
    seen_all.append(int(seen.sum()))


def _rows_map(kv_hi, fn, kv_lo=0):
    """A row map that refuses positions outside the held range [kv_lo,
    kv_hi): the kernels never address them."""
    def rows(pos):
        assert kv_lo <= pos < kv_hi, pos
        return fn(pos)
    return rows


def tile_flash(q, k, v, q_offsets, kv_lengths, *, causal=True, window=None,
               round_p=False):
    """``flash_attn.cu``'s schedule: one block per (tile of kM // rep
    rows, KV head g, batch row b)."""
    b, lq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    rows_per = CORES[round_p][0] // rep
    out = torch.full_like(q, float("nan"))
    written = torch.zeros(b, lq, hq, dtype=torch.long)
    seen = []
    kbuf, vbuf = k.reshape(b * s, hkv, d), v.reshape(b * s, hkv, d)
    for bi in range(b):
        kv_hi = min(max(int(kv_lengths[bi]), 0), s)
        rows = _rows_map(kv_hi, lambda p, bi=bi: bi * s + p)
        for g in range(hkv):
            for x in range(-(-lq // rows_per)):
                r0 = x * rows_per
                _tile(q[bi], out[bi], written[bi], seen, rows, kbuf, vbuf,
                      r0=r0, n_rows=min(rows_per, lq - r0), rep=rep, g=g,
                      pos0=int(q_offsets[bi]) + r0, kv_hi=kv_hi,
                      causal=causal, window=window or 0, round_p=round_p,
                      vec_base=(bi, g, x))
    assert (written == 1).all()          # every (row, head) once
    return out


def segment_tiles(cu, n_rows, rows_per):
    """``ragged_prefill_kernel``'s block -> (segment, first row, end row)
    map over the ceil(T / rows) + B blocks the launch starts; segment B
    stands for the rows past cu_seqlens[B]; None for a block that
    exits."""
    n_seqs = len(cu) - 1
    tiles = []
    for x in range(-(-n_rows // rows_per) + n_seqs):
        seg, s0, s1 = n_seqs, cu[n_seqs], n_rows
        for bi in range(n_seqs):
            nt = -(-(cu[bi + 1] - cu[bi]) // rows_per) \
                if cu[bi + 1] > cu[bi] else 0
            if x < nt:
                seg, s0, s1 = bi, cu[bi], cu[bi + 1]
                break
            x -= nt
        r0 = s0 + x * rows_per
        tiles.append((seg, r0, min(s1, r0 + rows_per)) if r0 < s1 else None)
    return tiles


def tile_ragged(q, kbuf, vbuf, seg_rows, capacity, cu, q_offsets,
                kv_lengths, *, round_p=False, window=0):
    """``ragged_prefill.cuh``'s schedule over storage (rows, hkv, D) whose
    segment b reads row ``seg_rows(b, pos)``; ``capacity`` is the most
    positions a segment holds (the layout's depth).  ``window`` > 0: the
    ring and rolling layouts, which hold a segment's newest positions
    [max(0, kv_len − depth), kv_len) (``Layout::held``), and each row's
    window."""
    t, hq, d = q.shape
    hkv = kbuf.shape[1]
    rep = hq // hkv
    rows_per = CORES[round_p][0] // rep
    cu = [int(c) for c in cu]
    n_seqs = len(cu) - 1
    out = torch.full_like(q, float("nan"))
    written = torch.zeros(t, hq, dtype=torch.long)
    seen = []
    for g in range(hkv):
        for x, tile in enumerate(segment_tiles(cu, t, rows_per)):
            if tile is None:
                continue
            seg, r0, r1 = tile
            if seg == n_seqs:            # rows past cu_seqlens[B]
                i = torch.arange((r1 - r0) * rep)
                out[r0 + i // rep, g * rep + i % rep] = 0
                written[r0 + i // rep, g * rep + i % rep] += 1
                continue
            kv_len = max(int(kv_lengths[seg]), 0)
            kv_lo, kv_hi = ((max(0, kv_len - capacity), kv_len) if window
                            else (0, min(kv_len, capacity)))
            rows = _rows_map(kv_hi, functools.partial(seg_rows, seg), kv_lo)
            s0 = cu[seg]
            _tile(q, out, written, seen, rows, kbuf, vbuf, r0=r0,
                  n_rows=r1 - r0, rep=rep, g=g,
                  pos0=int(q_offsets[seg]) + r0 - s0, kv_hi=kv_hi,
                  causal=True, window=window, round_p=round_p,
                  vec_base=(g, x), kv_lo=kv_lo)
    assert (written == 1).all()          # every (row, head) once
    return out


# ------------------------------------------------------------ flash

# q_offsets, kv_lengths, causal, window over B = 3, Lq = 77, S = 300
FLASH_CASES = {
    "causal_offsets": ([0, 100, 223], [77, 177, 300], True, None),
    "noncausal": ([0, 0, 0], [150, 61, 0], False, None),
    "window": ([10, 200, 0], [87, 277, 50], True, 48),
    # dummy depth rows: queries from the park position S - 1 on, past S
    "park_rows": ([299, 299, 30], [300, 300, 0], True, None),
}
REP_WIDTHS = {1: 80, 4: 128, 5: 96, 8: 64}   # every width, one rep each


def _flash_inputs(seed, rep, d, kvl, dtype):
    """q (3, 77, HKV * rep, d) and K/V (3, 300, HKV, d), rows at and past
    each kv length NaN for the tile walk and 1000 for the plain
    version."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(
        (3, 77, HKV * rep, d)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal(
        (3, 300, HKV, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(
        (3, 300, HKV, d)).astype(np.float32))
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(kvl):
        kp[i, n:] = float("nan")
        vp[i, n:] = float("nan")
        k[i, n:] = 1000.0
        v[i, n:] = 1000.0
    return q, kp.to(dtype), vp.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("rep", sorted(REP_WIDTHS))
def test_flash_tiles_match_plain(rep, case, bf16):
    offs, kvl, causal, window = FLASH_CASES[case]
    d = REP_WIDTHS[rep]
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, kp, vp, k, v = _flash_inputs(rep * 7 + d, rep, d, kvl, dtype)
    idx = (torch.tensor(offs, dtype=torch.int32),
           torch.tensor(kvl, dtype=torch.int32))
    got = tile_flash(q, kp, vp, *idx, causal=causal, window=window,
                     round_p=bf16)
    plain = functools.partial(tref.ref_flash_attn, causal=causal,
                              window=window)
    if not bf16:
        torch.testing.assert_close(got, plain(q, k, v, *idx), **TOL)
        return
    ref, bound = tref.kernel_error_bound(plain, dtype, q, k, v, *idx)
    assert ((got.float() - ref).abs() <= bound).all()


@pytest.mark.parametrize("rep", sorted(REP_WIDTHS))
def test_flash_tiles_match_jax_oracle(rep):
    offs, kvl, causal, window = FLASH_CASES["window"]
    d = REP_WIDTHS[rep]
    q, kp, vp, k, v = _flash_inputs(rep, rep, d, kvl, torch.float32)
    got = tile_flash(q, kp, vp, torch.tensor(offs), torch.tensor(kvl),
                     causal=causal, window=window)
    want = np.asarray(jref.ref_flash_attn(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), q_offsets=jnp.asarray(offs, jnp.int32),
        kv_lengths=jnp.asarray(kvl, jnp.int32), window=window,
        causal=causal))
    keyed = got.abs().amax(dim=-1) > 0          # JAX averages junk else
    assert keyed.any()
    np.testing.assert_allclose(got[keyed].numpy(), want[keyed.numpy()],
                               **TOL)


# ------------------------------------------------------------ ragged

# segment lengths, histories: a long segment across several tiles, a
# verify tick's 5-row segments (a 16-row tile would straddle four), a
# decode row, a keyless segment; then 2 pad segments and 9 tail rows
RAGGED_LENS = [37, 5, 5, 5, 1, 70, 6]
RAGGED_HISTS = [0, 40, 100, 7, 130, 60, 0]
RAGGED_KEYLESS = 6
N_PAGES, P_MAX, N_SLOTS, S_MAX = 40, 12, 9, 192


def _ragged_inputs(seed, rep, layout, dtype, d=128):
    """The stream and one layout's storage: (q, storage poisoned with NaN
    past each length, the same with 1000 there, the kernel's index
    arguments, the plain version's index arguments, the row map,
    capacity)."""
    rng = np.random.default_rng(seed)
    lens, hists = RAGGED_LENS, RAGGED_HISTS
    kvl = [h + n for h, n in zip(hists, lens)]
    kvl[RAGGED_KEYLESS] = 0
    n_pad, tail = 2, 9
    cu = [0] + list(np.cumsum(lens)) + [sum(lens)] * n_pad
    offs = hists + [0] * n_pad
    kvl = kvl + [0] * n_pad
    b = len(kvl)
    t = sum(lens) + tail
    q = torch.from_numpy(rng.standard_normal(
        (t, HKV * rep, d)).astype(np.float32)).to(dtype)
    if layout == "paged":
        shape = (N_PAGES, PS, HKV, d)
        table = np.full((b, P_MAX), 1 << 30, np.int64)  # faults if read
        free = list(rng.permutation(N_PAGES - 1))
        valid = np.zeros((N_PAGES, PS), bool)
        for i, n in enumerate(kvl):
            need = -(-n // PS)
            table[i, :need] = [free.pop() for _ in range(need)]
            for p in range(n):
                valid[table[i, p // PS], p % PS] = True
        plain_table = np.where(table == 1 << 30, N_PAGES - 1, table)
        index = [torch.tensor(plain_table, dtype=torch.int32)]

        def seg_rows(seg, pos):
            return int(table[seg, pos // PS]) * PS + pos % PS
        capacity = P_MAX * PS
    else:
        shape = (N_SLOTS, S_MAX, HKV, d)
        slots = [int(x) for x in rng.permutation(N_SLOTS)[:len(lens)]]
        slot_map = slots + [slots[0]] * n_pad     # pads name a live slot
        valid = np.zeros((N_SLOTS, S_MAX), bool)
        for i, n in enumerate(kvl[:len(lens)]):
            valid[slot_map[i], :min(n, S_MAX - 1)] = True  # park row S-1
        index = [torch.tensor(slot_map, dtype=torch.int32)]

        def seg_rows(seg, pos):
            return slot_map[seg] * S_MAX + pos
        capacity = S_MAX
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vmask = torch.from_numpy(valid)
    kp, vp = k.clone(), v.clone()
    kp[~vmask], vp[~vmask] = float("nan"), float("nan")
    k[~vmask], v[~vmask] = 1000.0, 1000.0
    seg_idx = [torch.tensor(x, dtype=torch.int32) for x in (cu, offs, kvl)]
    if layout == "gathered":
        # segment b reads cache row b: each slot copied out
        sm = index[0].long()
        kp, vp, k, v = (a[sm].contiguous() for a in (kp, vp, k, v))
        index = []

        def seg_rows(seg, pos):              # noqa: F811
            return seg * S_MAX + pos
    flat = [a.reshape(-1, HKV, d).to(dtype) for a in (kp, vp)]
    return (q, flat, k.to(dtype), v.to(dtype), index, seg_idx, seg_rows,
            capacity)


PLAIN = {"paged": tref.ref_ragged_prefill_paged,
         "arena": tref.ref_ragged_prefill_arena,
         "gathered": tref.ref_ragged_prefill}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("rep", [1, 4, 5, 8])
@pytest.mark.parametrize("layout", list(PLAIN))
def test_ragged_tiles_match_plain(layout, rep, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, (kf, vf), k, v, index, seg_idx, seg_rows, cap = \
        _ragged_inputs(rep + 11, rep, layout, dtype)
    got = tile_ragged(q, kf, vf, seg_rows, cap, *seg_idx, round_p=bf16)
    plain = PLAIN[layout]
    args = (q, k, v, *index, *seg_idx)
    total = int(seg_idx[0][-1])
    assert (got[total:] == 0).all()
    if not bf16:
        torch.testing.assert_close(got, plain(*args), **TOL)
        return
    ref, bound = tref.kernel_error_bound(plain, dtype, *args)
    assert ((got.float() - ref).abs() <= bound).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("layout", list(PLAIN))
def test_ragged_tiles_at_head_widths_rep_1(layout, d, bf16):
    """The ragged tiles at rep 1 (MHA: stablelm's 32 / 32 heads of 64,
    phi-3's of 96; 80 too): 128 rows of one head a bf16 tile, 32 an
    fp32 one, over the same stream."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, (kf, vf), k, v, index, seg_idx, seg_rows, cap = \
        _ragged_inputs(d + 3, 1, layout, dtype, d)
    got = tile_ragged(q, kf, vf, seg_rows, cap, *seg_idx, round_p=bf16)
    plain = PLAIN[layout]
    args = (q, k, v, *index, *seg_idx)
    assert (got[int(seg_idx[0][-1]):] == 0).all()
    if not bf16:
        torch.testing.assert_close(got, plain(*args), **TOL)
        return
    ref, bound = tref.kernel_error_bound(plain, dtype, *args)
    assert ((got.float() - ref).abs() <= bound).all()


@pytest.mark.parametrize("layout", list(PLAIN))
def test_ragged_tiles_match_jax_oracle(layout):
    q, (kf, vf), k, v, index, seg_idx, seg_rows, cap = \
        _ragged_inputs(5, 5, layout, torch.float32)
    got = tile_ragged(q, kf, vf, seg_rows, cap, *seg_idx)
    j = [jnp.asarray(x.numpy()) for x in (q, k, v, *index)]
    cu, offs, kvl = (jnp.asarray(x.numpy()) for x in seg_idx)
    if layout == "paged":
        want = jref.ref_ragged_prefill_paged(*j, cu, offs, kvl)
    elif layout == "arena":
        want = jref.ref_ragged_prefill_arena(*j, cu, offs, kvl)
    else:
        want = jref.ref_ragged_prefill(*j, cu, offs, kvl)
    want = np.asarray(want)
    keyed = got.abs().amax(dim=-1) > 0          # JAX averages junk else
    assert keyed.any()
    np.testing.assert_allclose(got[keyed].numpy(), want[keyed.numpy()],
                               **TOL)


@pytest.mark.parametrize("rep", [1, 4, 5, 8, 32])
def test_segment_tiles_cover_each_row_once(rep):
    """Up to 16 segments of random lengths (pad segments, 1-row decode
    segments, a long one) and a tail: the ceil(T / rows) + B launched
    blocks hold every stream row in exactly one tile, no tile holds rows
    of two segments, and the blocks past the count are the only ones
    that exit."""
    rng = np.random.default_rng(rep)
    rows_per = CORES[True][0] // rep
    for _ in range(20):
        n = int(rng.integers(1, 17))
        lens = [int(x) for x in rng.choice([0, 1, 5, 5, 13, 64, 300], n)]
        cu = [0] + list(np.cumsum(lens))
        t = cu[-1] + int(rng.integers(0, 40))
        if t == 0:
            continue
        tiles = segment_tiles(cu, t, rows_per)
        held = np.zeros(t, int)
        for tile in tiles:
            if tile is None:
                continue
            seg, r0, r1 = tile
            assert 0 < r1 - r0 <= rows_per
            lo, hi = (cu[seg], cu[seg + 1]) if seg < n else (cu[-1], t)
            assert lo <= r0 < r1 <= hi        # inside one segment
            held[r0:r1] += 1
        assert (held == 1).all()
        used = sum(tile is not None for tile in tiles)
        assert all(tile is None for tile in tiles[used:])


# ------------------------------------------------------------ windowed

# the windowed forms (ring page tables, rolling slots): a window off the
# page and key-tile grids, a margin C_l of 16, so a ring of
# ceil((37 + 16) / 16) = 4 pages (64 positions) and rolling slots of
# 53 rows.  Segments (length, history): kv at exactly one ring depth,
# rows straddling the ring's wrap at 128, a decode row, kv inside the
# window (a partly valid last page), kv at two ring depths, at two
# rolling depths, rows straddling the rolling wrap at 106, a segment
# longer than the margin (keys it overwrote are not held, as in the
# TPU kernels), a keyless segment; then 2 pad segments and 9 tail rows
W_WINDOW, W_MARGIN = 37, 16
W_RING = -(-(W_WINDOW + W_MARGIN) // PS)
W_DEPTH = {"ring": W_RING * PS, "rolling": W_WINDOW + W_MARGIN}
W_LENS = [16, 5, 1, 10, 16, 13, 8, 30, 4]
W_HISTS = [48, 125, 200, 10, 112, 93, 102, 150, 0]
W_KEYLESS = 8
W_PAGES, W_SLOTS = 48, 11


def window_storage(rng, layout, kv_lens, d):
    """Ring pages or rolling slots holding each segment's newest
    positions, written in position order as the engine writes them:
    (K, V with NaN on every row no segment holds, K, V with 1000 there,
    the plain version's index — a page table, whose entries past a
    ring's allocated pages name a spare page, or a slot map — and
    seg_rows(seg, pos), the kernel's row map, which faults on an entry
    past a ring's allocated pages)."""
    b = len(kv_lens)
    if layout == "ring":
        shape = (W_PAGES, PS, HKV, d)
        table = np.full((b, W_RING), 1 << 30, np.int64)   # faults if read
        free = list(rng.permutation(W_PAGES - 1))
        for i, n in enumerate(kv_lens):
            need = min(-(-n // PS), W_RING)
            table[i, :need] = [free.pop() for _ in range(need)]

        def seg_rows(seg, pos):
            return int(table[seg, (pos // PS) % W_RING]) * PS + pos % PS
        index = np.where(table == 1 << 30, W_PAGES - 1, table)
    else:
        shape = (W_SLOTS, W_DEPTH["rolling"], HKV, d)
        slots = [int(x) for x in rng.permutation(W_SLOTS - 1)[:b]]

        def seg_rows(seg, pos):
            return slots[seg] * W_DEPTH["rolling"] + pos % W_DEPTH["rolling"]
        index = slots
    k = torch.full((int(np.prod(shape[:2])), HKV, d), float("nan"))
    v = k.clone()
    for i, n in enumerate(kv_lens):
        for p in range(n):                       # the newest write wins
            r = seg_rows(i, p)
            k[r] = torch.from_numpy(rng.standard_normal((HKV, d)).astype(
                np.float32))
            v[r] = torch.from_numpy(rng.standard_normal((HKV, d)).astype(
                np.float32))
    held = ~k.isnan().any(dim=-1).any(dim=-1)
    kf, vf = k.clone(), v.clone()
    kf[~held], vf[~held] = 1000.0, 1000.0
    return (k, v, kf.reshape(shape), vf.reshape(shape),
            torch.tensor(np.asarray(index), dtype=torch.int32), seg_rows)


def _window_ragged_inputs(seed, rep, layout, dtype):
    rng = np.random.default_rng(seed)
    d = 128
    kvl = [h + n for h, n in zip(W_HISTS, W_LENS)]
    kvl[W_KEYLESS] = 0
    n_pad, tail = 2, 9
    cu = [0] + list(np.cumsum(W_LENS)) + [sum(W_LENS)] * n_pad
    offs = W_HISTS + [0] * n_pad
    kvl = kvl + [0] * n_pad
    t = sum(W_LENS) + tail
    q = torch.from_numpy(rng.standard_normal(
        (t, HKV * rep, d)).astype(np.float32)).to(dtype)
    kp, vp, k, v, index, seg_rows = window_storage(rng, layout, kvl, d)
    if layout == "rolling":                 # pads name the scratch slot
        index = torch.cat([index[:len(W_LENS)],
                           torch.full((n_pad,), W_SLOTS - 1,
                                      dtype=torch.int32)])
    seg_idx = [torch.tensor(x, dtype=torch.int32) for x in (cu, offs, kvl)]
    return (q, (kp.to(dtype), vp.to(dtype)), k.to(dtype), v.to(dtype),
            index, seg_idx, seg_rows)


W_PLAIN = {"ring": tref.ref_ragged_prefill_paged,
           "rolling": tref.ref_ragged_prefill_arena}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("layout", list(W_PLAIN))
def test_window_ragged_tiles_match_plain(layout, rep, bf16):
    """The windowed ragged kernels' walk (``Layout::held``, the window's
    lower edge, every position read through the ring or the rolling
    slot) against the plain windowed versions; no position outside a
    segment's held range is addressed and every unheld row is NaN."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, (kf, vf), k, v, index, seg_idx, seg_rows = \
        _window_ragged_inputs(rep + 3, rep, layout, dtype)
    got = tile_ragged(q, kf, vf, seg_rows, W_DEPTH[layout], *seg_idx,
                      round_p=bf16, window=W_WINDOW)
    plain = functools.partial(W_PLAIN[layout], window=W_WINDOW)
    args = (q, k, v, index, *seg_idx)
    assert (got[int(seg_idx[0][-1]):] == 0).all()
    if not bf16:
        torch.testing.assert_close(got, plain(*args), **TOL)
        return
    ref, bound = tref.kernel_error_bound(plain, dtype, *args)
    assert ((got.float() - ref).abs() <= bound).all()
