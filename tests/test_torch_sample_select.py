"""The schedule of the fused sampling CUDA kernel (``csrc/fused_sample.cu``),
rehearsed in plain PyTorch and held to the plain version and the JAX
package.

``rehearse`` runs one row as the kernel's thread-block cluster does:
- the row cut into the ``plan``'s slices (8 CTAs, 16 for fp32 rows past
  a one-wave slice; each slice a multiple of 8 columns, the last one
  short);
- the load: the bias in slot order (a repeated id adds twice, an id past
  V matches nothing), the argmax (largest value, lowest index) of each
  slice merged in rank order;
- top-k, when k <= THREADS, first by a filter: per slice the kth largest
  of its threads' maxima (a thread takes the slice's 16-byte chunks tid,
  tid + THREADS, ...; a biased column's slot holds -inf and thread 0
  takes its value), the largest over the slices as a logit threshold;
  the candidates past it, when each slice's fit its region of the leader
  and at most MAX_CANDIDATES in all, go to the leader, which finds the
  kth largest key among them;
- otherwise top-k by radix select: 8-bit digit histograms of U = key ^ 0x80000000
  over each slice's columns that match the prefix so far, summed over the
  slices, the digit picked by the suffix sum; two digits where every
  biased value is bf16-exact (the key's low half then follows from its
  sign), four otherwise; then K_x, the least logit key whose scaled value
  x / temp reaches the kth scaled key, and the keep-mask key(x) >= K_x;
- the kept columns counted per slice; when at most ``CAPACITY`` are kept
  and the scaled max is above the mask value, they are gathered in
  column order (each slice's base is the counts of the slices before it)
  and the two softmaxes, the 31-step top-p descent, the draw (the column
  of the first candidate whose running sum exceeds u, V when none,
  clamped to V - 1), p(draft) and the residual draw run over them alone;
- otherwise the whole row: e = exp(s - m) summed per slice, p = e / S1,
  the descent over the slices' partial masses, p2 = (p >= theta ? p :
  p_neg) / P2, and the CDF counted per slice from the totals of the
  slices before it.

Tolerance: the top-k threshold and keep-mask equal the reference's bit
for bit (integer counts over identical keys); greedy tokens exact;
``token`` and ``alt`` equal except on a row whose u lies within 1e-5 of a
non-zero cumulative mass of the plain version (``cdf_margin``: the order
of float sums may move such a draw); ``p_draft`` within 1e-5.  Rows: the
trouble spots of ``chip_smoke.py::_sample_batch``, kept sets of exactly
``CAPACITY`` and ``CAPACITY + 1`` columns (the path switch), random rows,
at V = 128, 1,003, 50,280, 151,936 and 152,064 in fp32 and bf16; every
path (greedy, compact by a warp and by a block, whole row) is taken.
Time of the file in the whole suite's parallel run (6 xdist workers,
``--dist loadfile``, one torch thread a worker): ~42–44 s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.kernels.sampling import fused_sample as pallas_sample  # noqa: E402
from repro.kernels.sampling import fused_sample_reference  # noqa: E402
from repro_torch.kernels import sampling as ks  # noqa: E402

F32 = torch.float32
NEG = np.float32(ks.NEG)
SIGN_LOW = 0x7FFFFFFF
MARGIN = 1e-5
C = ks.CAPACITY


def _f(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def fkey(x: torch.Tensor) -> torch.Tensor:
    """The monotone int32 key of float32 ``x``, as int64."""
    b = x.contiguous().view(torch.int32).long()
    return torch.where(b >= 0, b, b ^ SIGN_LOW)


def from_key(k: int) -> torch.Tensor:
    """The float32 whose key is ``k``."""
    b = k if k >= 0 else k ^ SIGN_LOW
    return torch.tensor([b], dtype=torch.int64).to(torch.int32).view(F32)[0]


KEY_NEG_INF = int(fkey(_f([-np.inf]))[0])


def _ukey(x: torch.Tensor) -> torch.Tensor:
    return fkey(x) + (1 << 31)


def _arg_better(best, cand):
    (v, i), (v2, i2) = best, cand
    return cand if (v2 > v or (v2 == v and i2 < i)) else best


def _first_past(run: torch.Tensor, u) -> int:
    hit = torch.nonzero(run > u)
    return int(hit[0, 0]) if len(hit) else len(run)


def _descent(mass_of, top_p) -> torch.Tensor:
    """_topp_theta's 31-step descent; ``mass_of(trial)`` sums the
    probabilities whose bits exceed ``trial``."""
    kacc = 0
    for it in range(31):
        bit = 1 << (30 - it)
        if not bool(mass_of(kacc | (bit - 1)) < top_p):
            kacc |= bit
    return torch.tensor([kacc], dtype=torch.int32).view(F32)[0]


def _x_threshold(tkey: int, tdiv) -> int:
    """The least logit key whose scaled value's key reaches that of
    ``tkey`` (x / temp is monotone)."""
    ks_key = int(fkey((from_key(tkey) / tdiv)[None])[0])

    def ok(k):
        return k >= KEY_NEG_INF and int(
            fkey((from_key(k) / tdiv)[None])[0]) >= ks_key
    kx = tkey
    while ok(kx - 1):
        kx -= 1
    return kx


def rehearse(logits, temp, top_k, top_p, bids, bvals, u, draft):
    """One row through the kernel's schedule.  ``logits``: (V,) float32
    or bfloat16.  Returns (token, p_draft, alt, info): info holds the
    path taken and, when top-k ran, the kth scaled key and the keep-mask."""
    v = logits.shape[0]
    pl = ks.plan(v, logits.dtype)
    cs, n = pl["cluster"], pl["slice"]
    slices = [(min(q * n, v), min(q * n + n, v)) for q in range(cs)]
    temp, top_p, u = _f(temp), _f(top_p), _f(u)
    x = logits.to(F32).clone()
    low = logits.dtype == F32
    seen = set()
    for j in range(ks.MAX_BIAS):
        col = int(bids[j])
        if 0 <= col < v and col not in seen:
            seen.add(col)
            xb = x[col].clone()
            for q in range(j, ks.MAX_BIAS):
                if int(bids[q]) == col:
                    xb = xb + _f(bvals[q])
            x[col] = xb
            low |= int(xb.view(torch.int32)) & 0xFFFF != 0
    best = (-np.inf, 1 << 31)
    for lo, hi in slices:
        if hi > lo:
            i = int(torch.argmax(x[lo:hi]))
            best = _arg_better(best, (float(x[lo + i]), lo + i))
    gval, gtok = best
    info = {}
    if temp <= 0:
        info["path"] = "greedy"
        return gtok, float(gtok == draft), gtok, info
    tdiv = torch.clamp(temp, min=1e-6)
    m = _f(gval) / tdiv
    dcol = min(max(int(draft), 0), v - 1)
    do_k = 0 < top_k < v
    do_p = 0 < top_p < 1
    keep = None
    if do_k and top_k <= ks.THREADS:
        # the filter: per CTA the kth largest of its threads' maxima (a
        # thread takes chunks tid, tid + THREADS, ... of 16 bytes), the
        # largest over the cluster, as a logit threshold; the candidates
        # past it, when few, go to the leader, which finds the kth key
        # (a biased column's slot holds -inf; thread 0 takes its value)
        kv = 8 if logits.dtype == torch.bfloat16 else 4
        bound = -(1 << 31)
        for lo, hi in slices:
            xs = torch.full((-(-(hi - lo) // kv) * kv,), -np.inf)
            xs[:hi - lo] = x[lo:hi]
            here = [c - lo for c in seen if lo <= c < hi]
            xs[here] = -np.inf
            chunks = xs.view(-1, kv)
            per = torch.full((ks.THREADS, chunks.shape[0] // ks.THREADS + 1,
                              kv), -np.inf)
            q = torch.arange(chunks.shape[0])
            per[q % ks.THREADS, q // ks.THREADS] = chunks
            per = per.view(ks.THREADS, -1)
            best = per.gather(1, per.argmax(1, keepdim=True))[:, 0]
            for c in here:
                best[0] = torch.maximum(best[0], x[lo + c])
            keys = fkey(best)
            ge = (keys[None, :] >= keys[:, None]).sum(1)
            bound = max(bound, int(keys[ge >= top_k].max()))
        lx = _x_threshold(bound, tdiv)
        cand = fkey(x) >= lx
        # each slice writes its candidates into its own region of the
        # leader: CAPACITY / 2 entries shared among the slices
        fits = all(int(cand[lo:hi].sum()) <= ks.CAPACITY // 2 // cs
                   for lo, hi in slices)
        if fits and int(cand.sum()) <= ks.MAX_CANDIDATES and m > _f(NEG):
            cols = torch.nonzero(cand)[:, 0]
            ckeys = fkey(x[cols])
            ge = (ckeys[None, :] >= ckeys[:, None]).sum(1)
            tkey = int(ckeys[ge >= top_k].max())
            ks_key = int(fkey((from_key(tkey) / tdiv)[None])[0])
            keep = fkey(x) >= _x_threshold(tkey, tdiv)
            assert bool((cand | ~keep).all())     # every kept column a candidate
            info.update(kth_scaled_key=ks_key, keep=keep, select="filter")
            cols = torch.nonzero(keep)[:, 0]
            info["path"] = "compact_warp" if len(cols) <= 32 else "compact_block"
            return _draw_compact(cols, x[cols], m, tdiv, do_p, top_p, u,
                                 dcol, v) + (info,)
    if do_k:
        info["select"] = "radix"
        uk = _ukey(x)
        prefix, need = 0, int(top_k)
        for d in range(4 if low else 2):
            sh = 24 - 8 * d
            merged = torch.zeros(256, dtype=torch.int64)
            for lo, hi in slices:
                k = uk[lo:hi]
                if d:
                    k = k[(k >> (sh + 8)) == prefix]
                merged += torch.bincount((k >> sh) & 0xFF, minlength=256)
            above = torch.cumsum(merged.flip(0), 0).flip(0) - merged
            b = int(torch.nonzero((above < need) & (above + merged >= need))[0, 0])
            need -= int(above[b])
            prefix = (prefix << 8) | b
        tu = prefix if low else (prefix << 16) | (0 if prefix & 0x8000 else 0xFFFF)
        tkey = tu - (1 << 31)
        ks_key = int(fkey((from_key(tkey) / tdiv)[None])[0])
        keep = fkey(x) >= _x_threshold(tkey, tdiv)
        info.update(kth_scaled_key=ks_key, keep=keep)
        counts = [int(keep[lo:hi].sum()) for lo, hi in slices]
        kept = sum(counts)
        if kept <= C and m > _f(NEG):
            cols = torch.cat([torch.nonzero(keep[lo:hi])[:, 0] + lo
                              for lo, hi in slices])
            info["path"] = "compact_warp" if kept <= 32 else "compact_block"
            assert len(cols) == kept and bool((cols[1:] > cols[:-1]).all())
            return _draw_compact(cols, x[cols], m, tdiv, do_p, top_p, u,
                                 dcol, v) + (info,)
    info["path"] = "whole_row"
    s = x / tdiv
    if do_k:
        s = torch.where(keep, s, _f(NEG))
    e = torch.exp(s - m)
    s1 = sum(e[lo:hi].sum() for lo, hi in slices)
    p = e / s1
    if do_p:
        theta = _descent(lambda t: sum(
            torch.where(p[lo:hi].view(torch.int32) > t, p[lo:hi], 0.).sum()
            for lo, hi in slices), top_p)
        p = torch.where(p >= theta, p, torch.exp(_f(NEG) - m) / s1)
        p = p / sum(p[lo:hi].sum() for lo, hi in slices)
    iota = torch.arange(v)
    rest = torch.where(iota == dcol, 0., p)
    t1 = [p[lo:hi].sum() for lo, hi in slices]
    t2 = [rest[lo:hi].sum() for lo, hi in slices]
    mass = sum(t2)
    div = torch.clamp(mass, min=1e-30)
    n1 = n2 = 0
    for q, (lo, hi) in enumerate(slices):
        c1 = sum(t1[:q], _f(0.))
        c2 = sum(t2[:q], _f(0.)) / div
        n1 += int((c1 + torch.cumsum(p[lo:hi], 0) <= u).sum())
        n2 += int((c2 + torch.cumsum(rest[lo:hi] / div, 0) <= u).sum())
    tok = min(n1, v - 1)
    alt = min(n2, v - 1) if mass > 0 else tok
    return tok, float(p[dcol]), alt, info


def _draw_compact(cols, xs, m, tdiv, do_p, top_p, u, dcol, v):
    """The leader's draw over the kept candidates, in column order."""
    e = torch.exp(xs / tdiv - m)
    s1 = e.sum()
    if do_p:
        theta = _descent(lambda t: torch.where(
            (e / s1).view(torch.int32) > t, e / s1, 0.).sum(), top_p)
        e = torch.where(e / s1 >= theta, e, 0.)
    p = e / e.sum()
    f1 = _first_past(torch.cumsum(p, 0), u)
    tok = min(int(cols[f1]) if f1 < len(cols) else v, v - 1)
    is_d = cols == dcol
    mass = torch.where(is_d, 0., p).sum()
    alt = tok
    if mass > 0:
        y = torch.where(is_d, 0., p / torch.clamp(mass, min=1e-30))
        f2 = _first_past(torch.cumsum(y, 0), u)
        alt = min(int(cols[f2]) if f2 < len(cols) else v, v - 1)
    return tok, float(torch.where(is_d, p, 0.).sum()), alt


def _rows(rng, v):
    """Host inputs of a batch whose rows are the kernel's trouble spots
    (``chip_smoke.py::_sample_batch``'s), the capacity rows where V
    allows, and random rows: (logits, temp, top_k, top_p, bias_ids,
    bias_vals, u, draft), row names."""
    spots = []

    def spot(name, t=0.0, k=0, p=1.0, uu=None, d=None, edit=None):
        spots.append((name, t, k, p, uu, d, edit))

    def kth_negative(row):
        row[:] = -np.abs(row) - 1.0

    def kth_negative_side(row):
        row[: v // 2] = -np.abs(row[: v // 2]) - 0.5
        row[v // 2:] = np.abs(row[v // 2:]) + 0.5

    def signed_zeros(row):
        row[:6] = [3.0, 2.5, 2.0, 0.0, 0.0, 0.0]
        row[6:9] = -0.0
        row[9:] = -np.abs(row[9:]) - 1.0

    def ties_at_kth(row):
        row[:] = np.round(row / 2.0)

    def padded_vocab(row):
        row[v - min(64, v // 4):] = -1e9

    def greedy_tie(row):
        row[[17, 4, 60]] = 20.0

    def distinct(count):
        # ``count`` distinct bf16-exact values above a floor of -10
        def edit(row):
            row[:] = -10.0
            bits = (0x3F80 + np.arange(count)).astype(np.uint32) << 16
            row[rng.permutation(v)[:count]] = bits.view(np.float32)
        return edit

    spot("greedy_tie", d=4, edit=greedy_tie)
    spot("biased_greedy")
    spot("padded_vocab", 0.9, 40, edit=padded_vocab)
    spot("kth_negative", 1.0, max(v // 3, 2), edit=kth_negative)
    spot("kth_negative_side", 0.6, v // 2 + 7, edit=kth_negative_side)
    spot("top_k_off", 1.1, v + 5)
    spot("top_k_1", 1.1, 1)
    spot("ties_at_kth", 1.0, 10, edit=ties_at_kth)
    spot("signed_zeros", 1.0, 5, edit=signed_zeros)
    spot("top_p_near_1", 1.0, 0, 0.999999)
    spot("top_p_tiny", 1.2, 0, 1e-6)
    spot("u_zero", 1.0, 8, 1.0, 0.0)
    spot("u_below_1", 2.0, 0, 1.0, np.float32(1.0 - 2.0 ** -24))
    spot("bias_all_slots", 0.7, 12)
    spot("draft_minus_1", 0.8, 20, 0.95, None, -1)
    spot("case_top_k_top_p", 0.8, 24, 0.85)
    spot("main_path", 0.8, 20, 0.95)
    spot("block_compact", 1.0, 300, 0.9)
    if v > C + 1:
        spot("kept_C", 3.0, C, 0.99, edit=distinct(C))
        spot("kept_C_plus_1", 3.0, C + 1, 0.99, edit=distinct(C + 1))
    for t, k, p in [(1.0, 0, 1.0), (0.7, 16, 1.0), (1.3, 0, 0.9),
                    (0.8, 24, 0.85)]:
        spot(f"random_{t}_{k}_{p}", t, k, p)
    r = len(spots)
    logits = rng.normal(0.0, 3.0, (r, v)).astype(np.float32)
    temp = np.zeros(r, np.float32)
    top_k = np.zeros(r, np.int32)
    top_p = np.ones(r, np.float32)
    bids = np.full((r, ks.MAX_BIAS), -1, np.int32)
    bvals = np.zeros((r, ks.MAX_BIAS), np.float32)
    u = rng.random(r).astype(np.float32)
    draft = rng.integers(0, v, r).astype(np.int32)
    names = []
    for i, (name, t, k, p, uu, d, edit) in enumerate(spots):
        names.append(name)
        temp[i], top_k[i], top_p[i] = t, k, p
        if uu is not None:
            u[i] = uu
        if d is not None:
            draft[i] = d
        if edit is not None:
            edit(logits[i])
        if name == "biased_greedy":
            bids[i, :3] = [9, 9, v]
            bvals[i, :3] = [4.0, 4.0, 50.0]
        if name in ("bias_all_slots", "main_path"):
            bids[i] = [5, 5, v + 3, 1, 2, 3, 4, 6]
            bvals[i] = [2.0, 2.5, 9.0, 0.5, 0.5, 0.5, 0.5, 0.5]
    return (logits, temp, top_k, top_p, bids, bvals, u, draft), names


def _scaled(args, i):
    """Row i's biased logits over the temperature, as the plain version
    computes them."""
    logits, temp, _, _, bids, bvals = args[:6]
    x = logits[i:i + 1].float()
    iota = torch.arange(x.shape[1], dtype=torch.int32)[None]
    for j in range(ks.MAX_BIAS):
        x = torch.where(iota == int(bids[i, j]), x + float(bvals[i, j]), x)
    return x / torch.clamp(_f([temp[i]]), min=1e-6)


def _held(got, want, margin, greedy, names, what):
    tok, pd, alt = (np.asarray(g) for g in got)
    wtok, wpd, walt = (np.asarray(w) for w in want)
    assert (tok[greedy] == wtok[greedy]).all(), what
    for a, b in ((tok, wtok), (alt, walt)):
        bad = np.nonzero(a != b)[0]
        assert (margin[bad] < MARGIN).all(), (
            what, [(names[i], a[i], b[i], margin[i]) for i in bad])
    np.testing.assert_allclose(pd, wpd, atol=1e-5, rtol=0, err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("v", [128, 1003, 50280, 151936, 152064])
def test_rehearsal_matches_plain_and_jax(v, dtype):
    rng = np.random.default_rng(v + (dtype == F32))
    host, names = _rows(rng, v)
    logits = torch.as_tensor(host[0]).to(dtype)
    args = (logits,) + host[1:]
    outs = [rehearse(logits[i], *(h[i] for h in host[1:]))
            for i in range(len(names))]
    got = [[o[j] for o in outs] for j in range(3)]
    paths = {o[3]["path"] for o in outs}
    assert {"greedy", "compact_warp", "compact_block", "whole_row"} <= paths
    # the leader's refinement of the thread-maxima filter, and (past
    # k = THREADS or MAX_CANDIDATES candidates) the radix select
    selects = {o[3].get("select") for o in outs}
    assert "filter" in selects and (v < 1000 or "radix" in selects)
    # the top-k threshold and keep-mask bit for bit
    for i, o in enumerate(outs):
        if "keep" not in o[3]:
            continue
        scaled = _scaled(args, i)
        want = ks._topk_keep(scaled, torch.tensor([int(host[2][i])]))[0]
        assert torch.equal(o[3]["keep"], want), names[i]
        kth = np.sort(fkey(scaled[0]).numpy())[-int(host[2][i])]
        assert o[3]["kth_scaled_key"] == kth, names[i]
        if names[i] == "kept_C":
            assert o[3]["path"] == "compact_block" and int(want.sum()) == C
        if names[i] == "kept_C_plus_1":
            assert o[3]["path"] == "whole_row" and int(want.sum()) == C + 1
    margin = ks.cdf_margin(*args).numpy()
    greedy = host[1] <= 0
    plain = [x.numpy() for x in ks.fused_sample_plain(*args)]
    _held(got, plain, margin, greedy, names, "plain")
    f32 = logits.float().numpy()
    ref = [np.asarray(x) for x in fused_sample_reference(f32, *host[1:])]
    _held(got, ref, margin, greedy, names, "jax reference")
    if v <= 1003:
        pal = [np.asarray(x) for x in pallas_sample(f32, *host[1:],
                                                    interpret=True)]
        _held(got, pal, margin, greedy, names, "pallas interpret")


@pytest.mark.parametrize("v", [1, 5, 128, 1003, 50280, 151936, 152064,
                               256000, 788480, 927744])
def test_plan_covers_the_row(v):
    """Every plan's slices are multiples of 8 columns that cover the row;
    the main path's bf16 rows and every fp32 row up to qwen2.5-32b's
    vocabulary leave three CTAs an SM; past the largest slice V is
    refused."""
    for dtype in (torch.float32, torch.bfloat16):
        try:
            pl = ks.plan(v, dtype)
        except ValueError:
            assert v > 788480 and dtype == F32
            continue
        cs, n = pl["cluster"], pl["slice"]
        assert cs in ks.CLUSTERS and n % 8 == 0
        assert cs * n >= v and (v <= 8 * cs or (cs - 1) * n < v)
        assert pl["smem"] <= ks.MAX_SMEM
        if v <= 152064:
            assert pl["smem"] <= ks.ONE_WAVE_SMEM
        if dtype == torch.bfloat16 and 50280 <= v <= 152064:
            assert cs == 8
    for dtype, past in ((torch.float32, 788481), (torch.bfloat16, 927745)):
        with pytest.raises(ValueError, match="does not fit"):
            ks.plan(past, dtype)
