"""CPU tests of the paged prefill's TMA-fed core (``csrc/attn_tma.cuh``)
from the host side, and a rehearsal of its schedule in plain PyTorch.

Host side: which calls take the core (``ragged_prefill.tma_core``, held
to the C rule ``attn::tma_core`` read from the source), the launcher's
glue (the C signature's arguments, the pool's page count among them,
and the ``tma.launches`` counter, listed in ``ops.LAUNCHERS``).

The rehearsal walks the core's producer and consumers: tiles of 128
query vectors (128 // rep rows x the rep heads of one KV head) over
64-key steps from position 0 to the band's end hi, each step's K and V
arriving as whole pages into a six-stage ring that starts full of NaN
(what an earlier block may have left), boxes issued only for the pages
holding keys below hi, V's rows past hi zeroed on the last step.  Pool
rows past each length and the pages that table entries past it name
hold NaN.  The output must be finite, the same bits as the cp.async
core's walk (keys past hi zero-filled, never addressed), and within
``ref.kernel_error_bound`` of the plain version.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ragged_prefill as rp  # noqa: E402
from repro_torch.kernels.ref import kernel_error_bound  # noqa: E402

KM, KN, STAGES = 128, 64, 6      # vectors a tile, keys a step, ring depth
HKV, D = 2, 128


def _c_rule():
    """``attn::tma_core``'s condition from ``csrc/attn_tma.cuh`` as a
    Python function of (window, dtype code, head_dim, page_size)."""
    src = (_build.CSRC / "attn_tma.cuh").read_text()
    m = re.search(r"bool tma_core\(int window, int dtype, int head_dim,\s*"
                  r"int page_size\) \{\s*return (.*?);\s*\}", src, re.S)
    assert m is not None
    expr = " ".join(m.group(1).split()).replace("&&", "and")
    return lambda window, dtype, head_dim, page_size: eval(expr)


@pytest.mark.parametrize("page_size", [4, 8, 12, 16, 32, 64, 128])
@pytest.mark.parametrize("head_dim", rp.HEAD_DIMS)
def test_tma_core_rule_matches_the_c_side(head_dim, page_size):
    """The Python rule and the C rule agree on every dtype, width, page
    size and window: bf16, head width 128, no window, pages of 8, 16, 32
    or 64 tokens."""
    rule = _c_rule()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for window in (None, 1, 64):
            want = rule(rp.window_arg(window), code, head_dim, page_size)
            assert rp.tma_core(dtype, head_dim, page_size, window) is want
            assert want == (dtype == torch.bfloat16 and head_dim == 128
                            and window is None
                            and page_size in (8, 16, 32, 64))


@pytest.fixture
def glue(monkeypatch):
    """The paged launcher on CPU tensors with its launch recorded: the
    device check, the C call and the stream are stubbed."""
    calls = []
    monkeypatch.setattr(rp, "check_kernel_inputs", lambda *a, **k: None)
    monkeypatch.setattr(rp, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 7}))
    return calls


@pytest.mark.parametrize("dtype,d,ps,window,taken", [
    (torch.bfloat16, 128, 16, None, True),
    (torch.bfloat16, 128, 64, None, True),
    (torch.bfloat16, 128, 16, 100, False),
    (torch.float32, 128, 16, None, False),
    (torch.bfloat16, 96, 16, None, False),
    (torch.bfloat16, 128, 4, None, False),
])
def test_launcher_passes_the_pool_and_counts_tma(glue, dtype, d, ps, window,
                                                  taken):
    """The launcher hands the C entry point exactly its signature's
    arguments, the pool's page count after the page size (the tensor
    maps cover n_pages * page_size rows), and counts the call in
    ``tma.launches`` iff ``tma_core`` holds."""
    n_pages, b, p_max = 11, 3, 5
    q = torch.zeros((20, 32, d), dtype=dtype)
    k = torch.zeros((n_pages, ps, 8, d), dtype=dtype)
    table = torch.zeros((b, p_max), dtype=torch.int32)
    idx = [torch.zeros(n, dtype=torch.int32) for n in (b + 1, b, b)]
    fn = rp.ragged_prefill_paged
    n0, t0 = fn.launches, fn.tma.launches
    fn(q, k, k, table, *idx, window=window)
    (args,) = glue
    assert args[0] == "ragged_prefill_paged"
    assert len(args) - 1 == len(_build.SIGNATURES["ragged_prefill_paged"][1])
    assert args[9:19] == (20, 32, 8, d, ps, n_pages, b, p_max, 1,
                          rp.window_arg(window))
    assert (fn.launches, fn.tma.launches) == (n0 + 1, t0 + taken)
    assert ops.LAUNCHERS["ragged_prefill_paged@tma"] is fn.tma


# ------------------------------------------------------------ rehearsal

def _pool(rng, kv_lens, ps, share=None):
    """A page table (entries past each length name a page of NaN), the
    pools with NaN in every row no segment owns (for the walks) and with
    0 there (for the plain version)."""
    need = sum(-(-n // ps) for n in kv_lens)
    n_pages = need + 3
    nan_page = n_pages - 1
    p_max = max(-(-n // ps) for n in kv_lens) + 2
    table = np.full((len(kv_lens), p_max), nan_page, np.int64)
    free = list(rng.permutation(n_pages - 1))
    for i, n in enumerate(kv_lens):
        table[i, :-(-n // ps)] = [free.pop() for _ in range(-(-n // ps))]
    if share is not None:
        a, b, k = share
        table[b, :k] = table[a, :k]
    ok = torch.zeros((n_pages, ps), dtype=torch.bool)
    for i, n in enumerate(kv_lens):
        for p in range(0, n, ps):
            ok[int(table[i, p // ps]), :min(ps, n - p)] = True
    kv = [torch.from_numpy(rng.standard_normal((n_pages, ps, HKV, D))).to(
        torch.bfloat16).float() for _ in range(2)]
    clean = [a.masked_fill(~ok[..., None, None], 0.0) for a in kv]
    junk = [a.masked_fill(~ok[..., None, None], float("nan")) for a in kv]
    return table, junk, clean


class Ring:
    """The core's shared-memory ring: STAGES stages of K and V, 64 rows
    each, starting full of NaN; the producer's boxes and the pages it
    read from the table are recorded."""

    def __init__(self):
        self.k = torch.full((STAGES, KN, D), float("nan"))
        self.v = torch.full((STAGES, KN, D), float("nan"))
        self.entries = []

    def produce(self, t, kb, hi, row_table, kpool, vpool, g, ps):
        """Step t: one box set (K, V; two column halves each) a page
        holding keys in [kb, min(kb + 64, hi))."""
        s = t % STAGES
        pages = (min(kb + KN, hi) - kb + ps - 1) // ps
        for j in range(pages):
            e = kb // ps + j
            self.entries.append(e)
            page = int(row_table[e])
            self.k[s, j * ps:(j + 1) * ps] = kpool[page, :, g]
            self.v[s, j * ps:(j + 1) * ps] = vpool[page, :, g]
        return s

    def consume(self, s, kb, hi):
        """The stage as the consumers' products read it: V's rows past
        hi zeroed on the last step."""
        if kb + KN > hi:
            self.v[s, hi - kb:] = 0.0
        return self.k[s], self.v[s]


def _cp_async_step(kb, hi, row_table, kpool, vpool, g, ps):
    """The cp.async core's step: keys past hi zero-filled, their rows
    never addressed."""
    kt = torch.zeros(KN, D)
    vt = torch.zeros(KN, D)
    for j in range(min(KN, hi - kb)):
        pos = kb + j
        row = int(row_table[pos // ps])
        kt[j] = kpool[row, pos % ps, g]
        vt[j] = vpool[row, pos % ps, g]
    return kt, vt


def _walk(qv, klo, khi, hi, step):
    """The consumers' arithmetic over 64-key steps [0, hi): S = Q.K^T,
    the mask as a select (NaN never passes), online softmax in log2
    units, p rounded to bf16 before P.V, l keeping the unrounded p."""
    n = qv.shape[0]
    sl2 = math.log2(math.e) / math.sqrt(D)
    m = torch.full((n,), -1e30)
    l = torch.zeros(n)
    o = torch.zeros(n, D)
    for t, kb in enumerate(range(0, hi, KN)):
        kt, vt = step(t, kb)
        pos = torch.arange(kb, kb + KN)
        ok = (pos[None] >= klo[:, None]) & (pos[None] < khi[:, None])
        s = torch.where(ok, (qv @ kt.T) * sl2, torch.tensor(-math.inf))
        mx = torch.maximum(m, s.max(dim=1).values)
        p = torch.exp2(s - mx[:, None])
        alpha = torch.exp2(m - mx)
        l = alpha * l + p.sum(dim=1)
        o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ vt
        m = mx
    return o / torch.where(l == 0, torch.ones_like(l), l)[:, None]


def rehearse(q, table, kpool, vpool, cu, hists, kv_lens, ps, causal):
    """Both cores' walks over every (segment tile, KV head): returns the
    TMA walk's output, the cp.async walk's, and every table entry the
    producer read with the bound it must stay under."""
    t, hq, _ = q.shape
    rep = hq // HKV
    rows_per = KM // rep
    out_tma = torch.zeros(t, hq, D)
    out_cp = torch.zeros(t, hq, D)
    reads = []
    for b in range(len(kv_lens)):
        for r0 in range(int(cu[b]), int(cu[b + 1]), rows_per):
            n_rows = min(rows_per, int(cu[b + 1]) - r0)
            pos0 = int(hists[b]) + r0 - int(cu[b])
            kv = int(kv_lens[b])
            hi = min(kv, pos0 + n_rows) if causal else kv
            for g in range(HKV):
                i = torch.arange(n_rows * rep)
                rows, heads = r0 + i // rep, g * rep + i % rep
                qv = q[rows, heads]
                qpos = pos0 + i // rep
                klo = torch.zeros_like(qpos)
                khi = torch.clamp(qpos + 1, max=kv) if causal else \
                    torch.full_like(qpos, kv)
                ring = Ring()

                def tma_step(t_, kb, ring=ring, g=g, b=b, hi=hi):
                    s = ring.produce(t_, kb, hi, table[b], kpool, vpool, g,
                                     ps)
                    return ring.consume(s, kb, hi)

                def cp_step(t_, kb, g=g, b=b, hi=hi):
                    return _cp_async_step(kb, hi, table[b], kpool, vpool, g,
                                          ps)

                out_tma[rows, heads] = _walk(qv, klo, khi, hi, tma_step)
                out_cp[rows, heads] = _walk(qv, klo, khi, hi, cp_step)
                reads.append((ring.entries, -(-max(hi, 0) // ps)))
    return out_tma, out_cp, reads


# segments (rows, history, kv length): kv lengths at, below and just past
# pages and 64-key steps with a keyless segment; a mixed step (a chunk
# beside one-row segments at long histories); two segments on shared
# prefix pages
REHEARSALS = {
    "edges": ([(1, 14, 15), (3, 13, 16), (1, 16, 17), (17, 46, 63),
               (1, 63, 64), (40, 25, 65), (2, 126, 128), (1, 128, 129),
               (3, 0, 0)], None),
    "mixed": ([(40, 300, 340)] + [(1, h, h + 1) for h in
                                  (100, 257, 511, 640, 777, 900)], None),
    "shared": ([(9, 48, 57), (17, 48, 65), (1, 70, 71)], (0, 1, 3)),
}


@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nc"])
@pytest.mark.parametrize("rep", [4, 5])
@pytest.mark.parametrize("case", list(REHEARSALS))
def test_tma_walk_matches_the_cp_async_walk_and_plain(case, rep, causal, ps):
    rng = np.random.default_rng(rep * 7 + ps)
    segs, share = REHEARSALS[case]
    lens = [n for n, _, _ in segs]
    hists = [h for _, h, _ in segs]
    kv_lens = [kv for _, _, kv in segs]
    table, (kn, vn), (kc, vc) = _pool(rng, kv_lens, ps, share)
    cu = np.concatenate([[0], np.cumsum(lens)])
    q = torch.from_numpy(rng.standard_normal(
        (int(cu[-1]) + 3, rep * HKV, D))).to(torch.bfloat16).float()
    out_tma, out_cp, reads = rehearse(q, table, kn, vn, cu, hists, kv_lens,
                                      ps, causal)
    for entries, bound in reads:       # no box past the band's last page
        assert all(e < bound for e in entries)
        assert len(entries) == bound
    assert torch.isfinite(out_tma).all()
    assert torch.equal(out_tma, out_cp)
    idx = [torch.as_tensor(np.asarray(x), dtype=torch.int32)
           for x in (table, cu, hists, kv_lens)]
    ref, bound = kernel_error_bound(
        lambda *a: rp.ragged_prefill_paged_plain(*a, causal=causal),
        torch.bfloat16, q, kc, vc, *idx)
    assert ((out_tma - ref).abs() <= bound).all()
