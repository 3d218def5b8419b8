"""CPU rehearsal of the split key walk of the port's decode kernels
(``csrc/decode_attn.cuh`` through ``csrc/decode_attn_{paged,arena,
dense}.cu``), in plain PyTorch, against the plain versions
(``repro_torch.kernels.ref``) and the JAX oracles (``repro.kernels.ref``).

The rehearsal walks the kernels' own decomposition.
``kernels.decode_attn.split_plan``, given a small SM count, fixes the
chunk C and the chunk count over the layout's static capacity.  One
block per (chunk, KV head, row): a block whose chunk starts at or past
the row's length writes an empty partial (m = -1e30, l = 0) and reads
nothing; in the others 4 warps walk 16-key tiles w, w + 4, ... of the
chunk, each with its own online softmax in log2 units (p rounded to
bf16 against the warp's running max in the bf16 form, l summing the
unrounded p); the warps merge into the block's partial (acc, m, l); the
combine merges a row's partials in chunk order, skipping the empty
ones, and gives a row with no key 0; with one chunk the block writes
the output itself.  Every key row is fetched through the layout's row
map (page table, slot map, batch row) and positions at or past the
row's length are never addressed: K/V rows and pages past each length
hold NaN and table entries past them an index that faults, and the
workspace starts as NaN, so a stray read shows.  Each (row, KV head)
counts the (query head, key) pairs it attends, so a dropped chunk, a
chunk boundary off by one key or a tile read twice fails before any
chip time.  Rows: lengths 0, 1, C, C + 1, the capacity, one long row
beside short ones, and a decode-ladder pad row (length 1 on a live
row's storage).

Tolerances: fp32 (no rounding of p) atol = rtol = 1e-5 against the plain
versions and the JAX oracles — the same softmax in another summation
order.  With q, K, V in bf16 and p rounded to bf16 before P.V, as the
bf16 walk does, ``ref.kernel_error_bound``.  The JAX oracles average
junk on rows with no key, where the kernels write 0: those rows are held
to the plain versions only.
"""
import functools
import itertools
import math
from types import SimpleNamespace

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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attn as dec  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

NEG = -1e30              # the kernels' finite initial running max
TOL = dict(atol=1e-5, rtol=1e-5)
WARPS, KT = 4, dec.WARP_KEYS
HKV, D, PS = 2, 32, 16
CAP = 320                # every layout's capacity: 20 pages, S_max, S
POISON = 1 << 30         # page-table entries past a length: fault if read
# SM counts giving one chunk (the block writes out), two (256 + 64 keys)
# and five (64 keys each) over the 320-key capacity at 8 rows x 2 heads
SMS = (1, 8, 16)


def _block(qg, rows, kbuf, vbuf, g, k0, k1, round_p, seen):
    """One block of ``decode_split_kernel``: the group's query vectors qg
    (rep, D) fp32 over keys [k0, k1) of the row map ``rows``; the warps'
    walks, then their merge.  Returns the block's partial (m, l, acc)."""
    rep, d = qg.shape
    sl2 = math.log2(math.e) / math.sqrt(d)
    parts = []
    for w in range(WARPS):
        m = torch.full((rep,), NEG)
        l = torch.zeros(rep)
        acc = torch.zeros(rep, d)
        for base in range(k0 + w * KT, k1, WARPS * KT):
            pos = torch.arange(base, base + KT)
            live = pos < k1                        # the rest zero-filled
            kt = torch.zeros(KT, d)
            vt = torch.zeros(KT, d)
            idx = torch.tensor([rows(int(p)) for p in pos[live]],
                               dtype=torch.long)
            kt[live] = kbuf[idx, g].float()
            vt[live] = vbuf[idx, g].float()
            seen[:, pos[live]] += 1
            s = torch.where(live, qg @ kt.T * sl2, torch.tensor(NEG))
            mx = torch.maximum(m, s.max(dim=1).values)
            p = torch.where(live, torch.exp2(s - mx[:, None]),
                            torch.tensor(0.0))
            alpha = torch.exp2(m - mx)
            l = alpha * l + p.sum(dim=1)
            if round_p:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha[:, None] + p @ vt
            m = mx
        parts.append((m, l, acc))
    mx = torch.stack([p[0] for p in parts]).max(dim=0).values
    e = [torch.exp2(p[0] - mx) for p in parts]
    lsum = sum(ei * p[1] for ei, p in zip(e, parts))
    a = sum(ei[:, None] * p[2] for ei, p in zip(e, parts))
    return mx, lsum, a


def _rows_map(n_keys, fn, lo=0):
    """A row map that refuses positions outside the row's key range [lo,
    n_keys): the kernels never address them."""
    def rows(pos):
        assert lo <= pos < n_keys, pos
        return fn(pos)
    return rows


def key_range(length, capacity, window=0):
    """A row's key range [lo, hi) (``Layout::held``, then the window):
    [0, min(length, capacity)) without a window; with one, the newest
    min(window, capacity, length) positions of a ring or rolling slot
    of ``capacity`` positions."""
    hi = max(int(length), 0)
    if not window:
        return 0, min(hi, capacity)
    return max(0, hi - capacity, hi - window), hi


def split_decode(q, kbuf, vbuf, row_fn, lengths, capacity, n_sms, *,
                 round_p=False, window=0):
    """``decode_split_kernel`` then ``decode_combine_kernel`` over K/V
    storage (rows, hkv, D) whose row b reads storage row ``row_fn(b,
    pos)``; ``window`` > 0 the ring / rolling form, its plan spanning
    min(capacity, window) keys.  Returns (out, the plan, the blocks that
    read keys)."""
    b, hq, d = q.shape
    hkv = kbuf.shape[1]
    rep = hq // hkv
    span = min(capacity, window) if window else capacity
    plan = dec.split_plan(b, hq, hkv, d, span, n_sms)
    c_keys, n_chunks = plan.chunk, plan.n_chunks
    out = torch.full((b, hq, d), float("nan"))
    ws = torch.full(plan.workspace or (1,), float("nan"))   # acc, m, l, pad
    live_blocks = 0
    n_pos = max([capacity] + [int(n) for n in lengths])
    seen = torch.zeros(b, hkv, rep, n_pos, dtype=torch.long)
    # the grid (hkv, b, n_chunks), chunk slowest
    for c, bi, g in itertools.product(range(n_chunks), range(b), range(hkv)):
        lo, n_keys = key_range(lengths[bi], capacity, window)
        heads = slice(g * rep, (g + 1) * rep)
        k0 = lo + c * c_keys
        k1 = min(k0 + c_keys, n_keys)
        if k0 >= n_keys:                           # an empty partial
            if n_chunks == 1:
                out[bi, heads] = 0.0
            else:
                ws[bi, g, c, :, d] = NEG
                ws[bi, g, c, :, d + 1] = 0.0
            continue
        live_blocks += 1
        rows = _rows_map(n_keys, lambda p, bi=bi: row_fn(bi, p), lo)
        m, lsum, a = _block(q[bi, heads].float(), rows, kbuf, vbuf, g, k0,
                            k1, round_p, seen[bi, g])
        if n_chunks == 1:
            out[bi, heads] = a / lsum[:, None]
        else:
            ws[bi, g, c, :, :d] = a
            ws[bi, g, c, :, d] = m
            ws[bi, g, c, :, d + 1] = lsum
    for bi in range(b):                            # each pair once
        lo, n_keys = key_range(lengths[bi], capacity, window)
        want = torch.zeros(hkv, rep, n_pos, dtype=torch.long)
        want[..., lo:n_keys] = 1
        assert torch.equal(seen[bi], want), bi
    if n_chunks > 1:                               # the combine
        out = combine_lanes(ws, d).reshape(b, hq, d)
    return out.to(q.dtype), plan, live_blocks


LANES = 32


def combine_lanes(part, d):
    """``decode_combine_kernel`` over the partials ``part`` (b, hkv,
    chunks, rep, d + 4), lane by lane: lane j folds the (m, l) of chunks
    j, j + 32, ... online (skipping empty ones, l = 0), a butterfly of
    shuffles folds the 32 lanes' into the row's max and sum, then for
    each chunk in order lane j < d / 4 adds the chunk's weight times its
    4 columns 4j..4j + 3 of acc; the other lanes load nothing and write
    nothing.  Returns (b, hkv, rep, d); a row with no key gets 0."""
    b, hkv, n_chunks, rep, _ = part.shape
    n_cols = d // 4
    assert d % 4 == 0 and n_cols <= LANES
    mx = torch.full((b, hkv, rep, LANES), NEG)
    ls = torch.zeros(b, hkv, rep, LANES)
    for c in range(n_chunks):                      # each lane's chunks
        j, lc, mc = c % LANES, part[:, :, c, :, d + 1], part[:, :, c, :, d]
        m_new = torch.maximum(mx[..., j], mc)
        folded = ls[..., j] * torch.exp2(mx[..., j] - m_new) \
            + lc * torch.exp2(mc - m_new)
        ls[..., j] = torch.where(lc > 0, folded, ls[..., j])
        mx[..., j] = torch.where(lc > 0, m_new, mx[..., j])
    for w in (1, 2, 4, 8, 16):                     # __shfl_xor_sync
        other = torch.arange(LANES) ^ w
        mo, lo = mx[..., other], ls[..., other]
        m_new = torch.maximum(mx, mo)
        ls = ls * torch.exp2(mx - m_new) + lo * torch.exp2(mo - m_new)
        mx = m_new
    assert torch.equal(mx, mx[..., :1].expand_as(mx))   # every lane agrees
    mx, ls = mx[..., 0], ls[..., 0]
    inv = torch.where(ls > 0, 1.0 / torch.where(ls > 0, ls, 1.0),
                      torch.tensor(0.0))
    acc = torch.zeros(b, hkv, rep, LANES, 4)
    for c in range(n_chunks):
        lc = part[:, :, c, :, d + 1]
        wc = torch.where(lc > 0, torch.exp2(part[:, :, c, :, d] - mx) * inv,
                         torch.tensor(0.0))
        cols = part[:, :, c, :, :4 * n_cols].reshape(b, hkv, rep, n_cols, 4)
        acc[..., :n_cols, :] += torch.where(
            wc[..., None, None] > 0, wc[..., None, None] * cols,
            torch.tensor(0.0))
    # lane j < d / 4 writes columns 4j..4j + 3: each column once
    cols_written = sorted(4 * j + e for j in range(n_cols) for e in range(4))
    assert cols_written == list(range(d))
    return acc[..., :n_cols, :].reshape(b, hkv, rep, d)


def _lengths(plan):
    """0, 1, C, C + 1, the capacity, a long row beside two short ones,
    and a decode-ladder pad row of length 1 (on row 1's storage)."""
    c = plan.chunk
    return [0, 1, c, min(c + 1, CAP), CAP, CAP - 7, 17, 1]


def _inputs(seed, rep, layout, dtype, n_sms, d=D):
    """q, the rehearsal's flat storage with NaN past every length, the
    plain versions' storage with 1000 there, index arguments for the
    plain versions, the row map and the lengths."""
    rng = np.random.default_rng(seed)
    hq, b = HKV * rep, 8
    plan = dec.split_plan(b, hq, HKV, d, CAP, n_sms)
    lens = _lengths(plan)
    q = torch.from_numpy(rng.standard_normal(
        (b, hq, d)).astype(np.float32)).to(dtype)
    if layout == "paged":
        n_pages, p_max = 160, CAP // PS
        shape = (n_pages, PS, HKV, d)
        table = np.full((b, p_max), POISON, np.int64)
        free = list(rng.permutation(n_pages - 1))
        valid = np.zeros((n_pages, PS), bool)
        for i, n in enumerate(lens[:-1]):
            need = -(-n // PS)
            table[i, :need] = [free.pop() for _ in range(need)]
            for p in range(n):
                valid[table[i, p // PS], p % PS] = True
        table[-1, 0] = table[1, 0]                 # the pad row
        plain_index = [torch.tensor(np.where(table == POISON, n_pages - 1,
                                             table), dtype=torch.int32)]

        def row_fn(bi, pos):
            return int(table[bi, pos // PS]) * PS + pos % PS
    else:
        n_slots = b
        shape = (n_slots, CAP, HKV, d)
        slots = [int(x) for x in rng.permutation(n_slots - 1)]
        slot_map = slots + [slots[1]]              # the pad row
        valid = np.zeros((n_slots, CAP), bool)
        for s, n in zip(slots, lens[:-1]):
            valid[s, :n] = True
        plain_index = [torch.tensor(slot_map, dtype=torch.int32)]

        def row_fn(bi, pos):
            return slot_map[bi] * CAP + pos
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vmask = torch.from_numpy(valid)
    kp, vp = k.clone(), v.clone()
    kp[~vmask], vp[~vmask] = float("nan"), float("nan")
    k[~vmask], v[~vmask] = 1000.0, 1000.0
    if layout == "dense":
        # row b reads cache row b: each row's slot copied out
        sm = plain_index[0].long()
        kp, vp, k, v = (a[sm].contiguous() for a in (kp, vp, k, v))
        plain_index = []

        def row_fn(bi, pos):                       # noqa: F811
            return bi * CAP + pos
    flat = [a.reshape(-1, HKV, d).to(dtype) for a in (kp, vp)]
    lengths = torch.tensor(lens, dtype=torch.int32)
    return (q, flat, k.to(dtype), v.to(dtype), plain_index, row_fn,
            lengths)


PLAIN = {"paged": tref.ref_decode_attn_paged,
         "arena": tref.ref_decode_attn_arena,
         "dense": tref.ref_decode_attn}


@pytest.mark.parametrize("n_sms", SMS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("rep", [1, 4, 5, 8])
@pytest.mark.parametrize("layout", list(PLAIN))
def test_split_walk_matches_plain(layout, rep, bf16, n_sms):
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, (kf, vf), k, v, index, row_fn, lengths = _inputs(
        rep * 3 + n_sms, rep, layout, dtype, n_sms)
    got, plan, live_blocks = split_decode(q, kf, vf, row_fn, lengths, CAP,
                                          n_sms, round_p=bf16)
    # a block reads keys iff its chunk starts below its row's length
    assert live_blocks == HKV * sum(-(-int(n) // plan.chunk)
                                    for n in lengths)
    assert (got[0] == 0).all() and torch.isfinite(got).all()
    args = (q, k, v, *index, lengths)
    if not bf16:
        torch.testing.assert_close(got, PLAIN[layout](*args), **TOL)
        return
    ref, bound = tref.kernel_error_bound(PLAIN[layout], dtype, *args)
    assert ((got.float() - ref).abs() <= bound).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("layout", list(PLAIN))
def test_split_walk_at_head_widths(layout, d, rep, bf16):
    """The split walk and the combine at D / 4 lanes (16, 20, 24) at
    the head widths the kernels take besides 128 — stablelm's 64 and
    phi-3's 96 at rep 1 (MHA), hubert's 80 — over several chunks."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, (kf, vf), k, v, index, row_fn, lengths = _inputs(
        d + rep, rep, layout, dtype, 16, d)
    got, plan, _ = split_decode(q, kf, vf, row_fn, lengths, CAP, 16,
                                round_p=bf16)
    assert plan.n_chunks > 1 and plan.workspace[-1] == d + 4
    assert (got[0] == 0).all() and torch.isfinite(got).all()
    args = (q, k, v, *index, lengths)
    if not bf16:
        torch.testing.assert_close(got, PLAIN[layout](*args), **TOL)
        return
    ref, bound = tref.kernel_error_bound(PLAIN[layout], dtype, *args)
    assert ((got.float() - ref).abs() <= bound).all()


# ------------------------------------------------------ the bf16 ring map

RING_STAGES = 3                     # csrc/decode_attn.cuh kStages


def ring_map(d):
    """The bf16 walk's shared-memory map of one warp's stage (csrc/
    decode_attn.cuh ``Walk<__nv_bfloat16, D>``): a tile of KT key rows,
    each of d / 8 16-byte chunks; a row's slots are the chunks padded
    to a multiple of 8, and chunk c of row r sits in slot c ^ (r % 8)
    of its row.  Returns (chunks a row, the byte offset of (r, c) in a
    K or V tile, the tile's bytes)."""
    chunks = d // 8
    slots = -(-chunks // 8) * 8

    def offset(r, c):
        return (r * slots + (c ^ (r & 7))) * 16
    return chunks, offset, KT * slots * 16


@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_bf16_ring_map(d):
    """The copy puts each (key row, chunk) of a tile in its own 16-byte
    slot inside the tile; every ldmatrix of S = q.K^T and of O += P.V
    reads the (row, chunk) its fragment wants; and the 8 row addresses
    of each ldmatrix phase fall in 8 distinct bank groups (16 bytes x 8
    = the 32 banks), so no read is serialised.  At 128 this is the map
    the kernels had before widths 64, 80 and 96."""
    chunks, offset, tile_bytes = ring_map(d)
    copies = KT * chunks // 32                     # kCopies: whole rounds
    assert KT * chunks % 32 == 0
    assert copies == {64: 4, 80: 5, 96: 6, 128: 8}[d]
    held = {}                                      # byte offset -> (r, c)
    for lane, u in itertools.product(range(32), range(copies)):
        idx = lane + 32 * u
        r, c = idx // chunks, idx % chunks
        off = offset(r, c)
        assert off % 16 == 0 and 0 <= off < tile_bytes
        assert off not in held
        held[off] = (r, c)
    assert sorted(held.values()) == [(r, c) for r in range(KT)
                                     for c in range(chunks)]
    # the ring: 4 warps x 3 stages x a K and a V tile
    assert WARPS * RING_STAGES * 2 * tile_bytes == \
        {64: 48, 80: 96, 96: 96, 128: 96}[d] * 1024
    for what in ("K", "V"):
        for kk in range(d // 16):
            addr = {}
            for lane in range(32):
                mi, mr = lane >> 3, lane & 7
                if what == "K":    # (keys 0-7 | 8-15) x (chunk 2kk | +1)
                    r, c = ((mi >> 1) << 3) + mr, 2 * kk + (mi & 1)
                else:              # transposed: (keys 0-7 | 8-15) first
                    r, c = ((mi & 1) << 3) + mr, 2 * kk + (mi >> 1)
                addr[lane] = offset(r, c)
                assert held[addr[lane]] == (r, c)
            for mi in range(4):                    # one phase a matrix
                groups = {(addr[8 * mi + j] // 16) % 8 for j in range(8)}
                assert len(groups) == 8, (what, kk, mi)


def test_combine_lanes_matches_a_direct_merge():
    """The lane model of the combine against a direct merge of the
    partials over the chunks, at D / 4 = 16, 20, 24 and 32 lanes, with
    empty partials (l = 0, acc never written) and more than 32 chunks
    (two rounds of chunk weights)."""
    rng = np.random.default_rng(3)
    for d in (64, 80, 96, 128):
        b, hkv, n_chunks, rep = 2, 2, 37, 4
        part = torch.from_numpy(rng.standard_normal(
            (b, hkv, n_chunks, rep, d + 4)).astype(np.float32))
        part[..., d + 1] = part[..., d + 1].abs()
        empty = torch.from_numpy(rng.random((b, hkv, n_chunks, rep)) < 0.3)
        empty[0, 0, :, 0] = True                   # a row with no key
        part[..., d][empty] = NEG
        part[..., d + 1][empty] = 0.0
        acc = part[..., :d]
        acc[empty] = float("nan")
        live = part[..., d + 1] > 0
        m = torch.where(live, part[..., d], torch.tensor(NEG))
        mx = m.max(dim=2, keepdim=True).values
        e = torch.where(live, torch.exp2(m - mx), torch.tensor(0.0))
        lsum = (e * part[..., d + 1]).sum(dim=2)
        a = (e[..., None] * torch.where(live[..., None], acc,
                                        torch.tensor(0.0))).sum(dim=2)
        want = torch.where(lsum[..., None] > 0,
                           a / torch.where(lsum > 0, lsum, 1.0)[..., None],
                           torch.tensor(0.0))
        got = combine_lanes(part, d)
        torch.testing.assert_close(got, want, **TOL)
        assert (got[0, 0, 0] == 0).all()


@pytest.mark.parametrize("rep", [1, 4, 5, 8])
@pytest.mark.parametrize("layout", list(PLAIN))
def test_split_walk_matches_jax_oracle(layout, rep):
    q, (kf, vf), k, v, index, row_fn, lengths = _inputs(
        rep, rep, layout, torch.float32, 16)
    got, plan, _ = split_decode(q, kf, vf, row_fn, lengths, CAP, 16)
    assert plan.n_chunks > 1
    j = [jnp.asarray(x.numpy()) for x in (q, k, v, *index, lengths)]
    if layout == "paged":
        want = jref.ref_decode_attn_paged(*j)
    elif layout == "arena":
        want = jref.ref_decode_attn_arena(*j)
    else:
        want = jref.ref_decode_attn(*j)
    keyed = (lengths > 0).numpy()                 # JAX averages junk else
    np.testing.assert_allclose(got[keyed].numpy(),
                               np.asarray(want)[keyed], **TOL)


@pytest.mark.parametrize("n_sms", [1, 16, 66, 132])
def test_split_plan_spans_the_capacity(n_sms):
    """Over many shapes: the chunk is a multiple of the block's round and
    at most MAX_CHUNK; the chunks cover the capacity with no chunk past
    it; the blocks reach UNITS_PER_SM per SM unless the chunk is already
    the smallest; the workspace holds (acc, m, l, pad) of every (row, KV head, chunk,
    query head) and is empty with one chunk."""
    rng = np.random.default_rng(n_sms)
    for _ in range(200):
        b = int(rng.integers(1, 65))
        hkv = int(rng.choice([1, 2, 4, 8, 16]))
        rep = int(rng.choice([1, 4, 5, 8]))
        cap = int(rng.choice([1, 16, 64, 192, 200, 2560, 4096, 32768]))
        plan = dec.split_plan(b, hkv * rep, hkv, 128, cap, n_sms)
        assert plan.chunk % dec.ROUND_KEYS == 0
        assert plan.chunk <= dec.MAX_CHUNK
        assert (plan.n_chunks - 1) * plan.chunk < cap \
            <= plan.n_chunks * plan.chunk
        units = b * hkv * plan.n_chunks
        assert plan.chunk == dec.ROUND_KEYS or plan.n_chunks == 1 or \
            units >= dec.UNITS_PER_SM * n_sms
        assert plan.workspace == ((b, hkv, plan.n_chunks, rep, 132)
                                  if plan.n_chunks > 1 else ())
        assert plan == dec.split_plan(b, hkv * rep, hkv, 128, cap, n_sms)


@pytest.mark.parametrize("name,index,layout,capacity", [
    ("decode_attn_paged", 2, (16, 40), 640),
    ("decode_attn_arena", 2, (4096,), 4096),
    ("decode_attn_dense", 1, (192,), 192),
    ("decode_attn_dense", 1, (64,), 64),       # one chunk: no workspace
])
def test_launcher_passes_the_plan(monkeypatch, name, index, layout,
                                  capacity):
    """The launchers' shared glue hands the C entry point exactly the
    arguments of its signature: the workspace (None with one chunk,
    else an fp32 tensor of the plan's shape on q's device), the plan's
    chunk and count, read from shapes and the SM count alone, and for
    the paged and arena kernels the window argument (0: none)."""
    calls = []
    monkeypatch.setattr(dec, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(dec, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    q = torch.zeros((8, 40, 128))
    k = torch.zeros((4, 16, 8, 128))
    idx = tuple(torch.zeros(8, dtype=torch.int32) for _ in range(index))
    window = None if name == "decode_attn_dense" else 0
    out = dec._launch_split(name, q, k, k, idx, layout, capacity, window)
    assert out.shape == q.shape
    (args,) = calls
    assert args[0] == name
    assert len(args) - 1 == len(_build.SIGNATURES[name][1])
    plan = dec.split_plan(8, 40, 8, 128, capacity, 132)
    tail = (0, 7) if window is None else (0, 0, 7)
    assert tuple(args[-2 - len(tail):]) == (plan.chunk, plan.n_chunks,
                                            *tail)
    ws = args[5 + index]
    assert (ws is None) == (plan.n_chunks == 1)
    assert args[-2 - len(tail) - len(layout):-2 - len(tail)] == layout


@pytest.mark.parametrize("name,window,capacity", [
    ("decode_attn_paged", 4096, 272 * 16),    # mixtral's ring
    ("decode_attn_arena", 4096, 4096 + 256),  # its rolling slot
    ("decode_attn_arena", 100, 116),          # a small odd window
])
def test_launcher_plans_the_window(monkeypatch, name, window, capacity):
    """A windowed launch plans over min(capacity, window) keys and hands
    the C entry point the window; the plan reads shapes only, so a CUDA
    graph captured at one kv length replays the right plan at any
    other."""
    calls = []
    monkeypatch.setattr(dec, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(dec, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    q = torch.zeros((8, 32, 128))
    k = torch.zeros((4, 16, 8, 128))
    idx = tuple(torch.zeros(8, dtype=torch.int32) for _ in range(2))
    layout = (16, capacity // 16) if name.endswith("paged") else (capacity,)
    dec._launch_split(name, q, k, k, idx, layout, capacity, window)
    (args,) = calls
    assert len(args) - 1 == len(_build.SIGNATURES[name][1])
    plan = dec.split_plan(8, 32, 8, 128, min(capacity, window), 132)
    assert tuple(args[-5:]) == (plan.chunk, plan.n_chunks, window, 0, 7)
    assert plan.n_chunks * plan.chunk >= min(capacity, window)


# ------------------------------------------------------------ windowed

# the windowed forms: a window of 150 (off the 16- and 64-key grids), a
# margin of 16, so a ring of ceil(166 / 16) = 11 pages (176 positions)
# and rolling slots of 166 rows.  Lengths: 0, 1, inside the window, at
# it, one past it, the ring's depth, two rolling depths, far past both,
# and a decode-ladder pad row of length 1
W_WINDOW, W_MARGIN = 150, 16
W_RING = -(-(W_WINDOW + W_MARGIN) // PS)
W_DEPTH = {"ring": W_RING * PS, "rolling": W_WINDOW + W_MARGIN}
W_LENGTHS = [0, 1, 100, 150, 151, 176, 332, 400, 1]


def _window_inputs(seed, rep, layout, dtype):
    """Ring pages or rolling slots written in position order (the newest
    write wins): q, the rehearsal's flat storage with NaN on every row
    no row holds, the plain version's storage with 1000 there, its index
    (table entries past a ring's allocated pages name a spare page), the
    row map (which faults on them) and the lengths."""
    rng = np.random.default_rng(seed)
    hq, b = HKV * rep, len(W_LENGTHS)
    q = torch.from_numpy(rng.standard_normal(
        (b, hq, D)).astype(np.float32)).to(dtype)
    if layout == "ring":
        n_pages = 100
        shape = (n_pages, PS, HKV, D)
        table = np.full((b, W_RING), POISON, np.int64)
        free = list(rng.permutation(n_pages - 1))
        for i, n in enumerate(W_LENGTHS[:-1]):
            need = min(-(-n // PS), W_RING)
            table[i, :need] = [free.pop() for _ in range(need)]
        table[-1, 0] = table[1, 0]                 # the pad row
        index = torch.tensor(np.where(table == POISON, n_pages - 1, table),
                             dtype=torch.int32)

        def row_fn(bi, pos):
            return int(table[bi, (pos // PS) % W_RING]) * PS + pos % PS
    else:
        depth = W_DEPTH["rolling"]
        shape = (b, depth, HKV, D)
        slots = [int(x) for x in rng.permutation(b - 1)]
        slot_map = slots + [slots[1]]              # the pad row
        index = torch.tensor(slot_map, dtype=torch.int32)

        def row_fn(bi, pos):
            return slot_map[bi] * depth + pos % depth
    k = torch.full((int(np.prod(shape[:2])), HKV, D), float("nan"))
    v = k.clone()
    for i, n in enumerate(W_LENGTHS[:-1]):
        for p in range(n):
            r = row_fn(i, p)
            k[r] = torch.from_numpy(rng.standard_normal((HKV, D)).astype(
                np.float32))
            v[r] = torch.from_numpy(rng.standard_normal((HKV, D)).astype(
                np.float32))
    held = ~k.isnan().any(dim=-1).any(dim=-1)
    kf, vf = k.clone(), v.clone()
    kf[~held], vf[~held] = 1000.0, 1000.0
    return (q, (k.to(dtype), v.to(dtype)), kf.reshape(shape).to(dtype),
            vf.reshape(shape).to(dtype), index, row_fn,
            torch.tensor(W_LENGTHS, dtype=torch.int32))


W_PLAIN = {"ring": tref.ref_decode_attn_paged,
           "rolling": tref.ref_decode_attn_arena}


@pytest.mark.parametrize("n_sms", SMS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_p"])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("layout", list(W_PLAIN))
def test_window_split_walk_matches_plain(layout, rep, bf16, n_sms):
    """The windowed decode kernels' split walk — the row's key range
    [len − min(window, depth, len), len), chunked by a plan over
    min(depth, window) keys, every position read through the ring or
    the rolling slot — against the plain windowed versions; no position
    outside the range is addressed, each (head, key) pair once."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, (kf, vf), k, v, index, row_fn, lengths = _window_inputs(
        rep * 5 + n_sms, rep, layout, dtype)
    got, plan, live_blocks = split_decode(
        q, kf, vf, row_fn, lengths, W_DEPTH[layout], n_sms, round_p=bf16,
        window=W_WINDOW)
    spans = [key_range(n, W_DEPTH[layout], W_WINDOW) for n in W_LENGTHS]
    assert live_blocks == HKV * sum(-(-(hi - lo) // plan.chunk)
                                    for lo, hi in spans)
    assert (got[0] == 0).all() and torch.isfinite(got).all()
    plain = functools.partial(W_PLAIN[layout], window=W_WINDOW)
    args = (q, k, v, index, lengths)
    if not bf16:
        torch.testing.assert_close(got, plain(*args), **TOL)
        return
    ref, bound = tref.kernel_error_bound(plain, dtype, *args)
    assert ((got.float() - ref).abs() <= bound).all()


def test_dense_launcher_passes_the_lse(monkeypatch):
    """Asked for the lse, the dense launcher hands the C entry point a
    (B, Hq) fp32 tensor's pointer right after the workspace (None when
    not asked); the paged and arena entry points take no lse."""
    calls = []
    monkeypatch.setattr(dec, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(dec, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    q = torch.zeros((8, 40, 128))
    k = torch.zeros((8, 192, 8, 128))
    lens = torch.zeros(8, dtype=torch.int32)
    lse = torch.empty((8, 40))
    dec._launch_split("decode_attn_dense", q, k, k, (lens,), (192,), 192,
                      lse=lse)
    dec._launch_split("decode_attn_dense", q, k, k, (lens,), (192,), 192)
    (with_lse, without) = calls
    assert with_lse[7] == lse.data_ptr() and without[7] is None
    assert len(with_lse) - 1 == len(_build.SIGNATURES["decode_attn_dense"][1])
    assert dec._LSE_ARG == ("decode_attn_dense",)


@pytest.mark.parametrize("rep", [1, 4])
def test_decode_lse_and_the_two_half_merge(rep):
    """``ops.decode(return_lse=True)`` on the CPU: the lse is
    ``ref_flash_attn_lse``'s at each row's last position (-inf on a
    keyless row), and the keys split into two halves, each half's output
    and lse merged by ``local.merge_partials`` (the arithmetic of a
    sequence-sharded cache's merge), give one call's output and lse
    (1e-5)."""
    from repro_torch.distributed import local
    from repro_torch.kernels import ops
    rng = np.random.default_rng(rep)
    b, s, hkv, d = 4, 96, 2, 64
    q = torch.from_numpy(rng.standard_normal((b, hkv * rep, d),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d),
                                                 dtype=np.float32))
            for _ in range(2))
    lens = torch.tensor([96, 40, 0, 49], dtype=torch.int32)
    out, lse = ops.decode(q, k, v, lens, return_lse=True)
    want = tref.ref_flash_attn_lse(q[:, None], k, lens.long() - 1,
                                   lens.long())[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.numpy(), **TOL)
    assert torch.isneginf(lse[2]).all() and not out[2].any()
    half = 48
    first = ops.decode(q, k[:, :half], v[:, :half], lens.clamp(max=half),
                       return_lse=True)
    second = ops.decode(q, k[:, half:], v[:, half:],
                        (lens - half).clamp(min=0), return_lse=True)
    m_out, m_lse = local.merge_partials(torch.stack([first[0], second[0]]),
                                        torch.stack([first[1], second[1]]))
    np.testing.assert_allclose(m_out.numpy(), out.numpy(), **TOL)
    np.testing.assert_allclose(m_lse.numpy(), lse.numpy(), **TOL)
