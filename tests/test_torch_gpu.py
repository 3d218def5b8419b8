"""Card-only tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version at qwen3-4b's head shapes (fp32 with TF32 off, and
bf16), the three ragged prefill kernels over tile-straddling streams at
GQA groups 1, 4, 5 and 8, the dense ``flash_attn`` at head widths 64-128
and GQA groups 1, 4, 5 and 8, the three decode kernels' split key walk
at GQA groups 1, 4, 5 and 8 over its chunk boundaries and one paged
decode launch replayed from a CUDA graph, the fused sampling kernel at
qwen3-4b's, qwen2.5-32b's and mamba2-2.7b's vocabularies (1 to 64 rows,
every row on the whole-row path, kept sets on each side of the compact
capacity, one call replayed from a CUDA graph, no (R, V) workspace), the SSD
scan kernel at mamba2-2.7b's head shapes (with the chunks it skips, and
one call replayed from a CUDA graph), the serving engine
(qwen3-4b and mamba2-2.7b smoke configs) and the hubert-xlarge smoke
encoder on the card against the same on the CPU, and the executors'
step graphs: one launch of each tile-core kernel replayed from a CUDA
graph, every executor step kind replayed bit-identical to its eager
step function (logits and every live arena, pool and state row), and a
capture at a live miss leaving every live row unchanged; the four
windowed kernels (ring tables, rolling slots) at mixtral-8x7b's heads
against their plain versions and replayed from a CUDA graph at other
kv lengths, and the windowed MoE engine (the mixtral-8x7b smoke config)
on the card against the same on the CPU in its three layouts.  The six
paged, arena and gathered attention kernels also at head widths 64, 80
and 96 (32 / 32, 16 / 16 and 32 / 8 heads; the windowed forms at 64 and
96), one decode launch at 96 replayed from a CUDA graph, and every
launcher refusing widths 16, 32, 112 and 256.  The hybrid family: the
SSD scan at jamba-v0.1-52b's layout (128 heads, B/C in 8 groups), the
jamba smoke engine on the card against the CPU in its three SSM modes,
its paged and slot steps replayed from their step graphs bit-identical
to the eager steps and its parked captures; and ``moe_layer``'s
capacity dispatch captured in a CUDA graph, bit-identical to eager.
Session handoff between two engines on the card: no device-to-host copy
in an export and import (``torch.profiler``), an imported session
decoded through the destination's graphs captured before the import,
bit-identical to an eager engine, and a dead engine refusing dispatch.
The host spill tier: a prefix spilled to the pinned host pool and
promoted back in place, decoded through a graph captured before the
spill, bit-identical to an eager engine.  Training: ``flash_attn_bwd``
against its plain version within ``ref.flash_attn_bwd_error_bound``
(head widths 64-128, GQA 1, 4, 5, 8, a window, non-causal with a
keyless row) with the forward's log-sum-exp, two runs bit-identical,
the serving launch unchanged bit for bit by the lse form,
``FlashAttnFn`` inside ``torch.utils.checkpoint``, and two runs of the
smoke config's bf16 train step bit-identical; ``ssd_scan``'s training
form (chunk states against the plain recurrence, y and state as the
serving launch's) and ``ssd_scan_bwd`` within
``ref.ssd_bwd_error_bound`` at mamba2's and jamba's layouts, the smoke
widths, widths off every tile and DS past 128, two runs bit-identical;
``ops.ssd_grouped`` differentiating on the card against the CPU, also
inside ``torch.utils.checkpoint``; and two runs of the mamba2 and jamba
smoke configs' bf16 train step bit-identical.
Without a card every test skips inside its fixture.

Run on the card:  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, element by element against the plain version computed in
fp32 from the same inputs: fp32 |out - ref| ≤ 1e-4 (summation order).
bf16: the kernels round p to bf16 before the PV product, as the TPU
kernels do, and round the output once, each a relative error of at most
u = 2^-8, so |out - ref| ≤ u·(Σ p|v| / l + |ref|) + 1e-4, where the first
term is the plain version on |v|; and the max abs error ≤ 2e-2.
Fused sampling: greedy tokens exact; token and alt equal except on a row
whose u lies within 1e-5 of a non-zero cumulative mass of the plain
version (``kernels.sampling.cdf_margin``); p_draft within 1e-5.
SSD scan (``kernels.ref.ssd_error_bound``): y and the final state within
1e-4 of the largest magnitude of their (batch row, head); a bf16 y also
within its one rounding, u·|ref|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import decode_attn as dec  # noqa: E402
from repro_torch.kernels import flash_attn as fl  # noqa: E402
from repro_torch.kernels import ragged_prefill as rp  # noqa: E402
from repro_torch.kernels import sampling as ks  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import kernel_error_bound  # noqa: E402
from repro_torch.kernels.ref import ssd_error_bound  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving.draft import ScriptedDraft  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

pytestmark = pytest.mark.gpu
HQ, HKV, D, PS, NPAGES, PMAX = 32, 8, 128, 16, 320, 160
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_held(out, plain, q, k, v, *index):
    ref, bound = kernel_error_bound(plain, out.dtype, q, k, v, *index)
    err = (out.float() - ref).abs()
    assert err.max().item() <= TOL[out.dtype]
    assert (err <= bound).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _table(rng, kv_lens, share=None):
    t = np.zeros((len(kv_lens), PMAX), np.int32)
    free = list(rng.permutation(NPAGES))
    for i, n in enumerate(kv_lens):
        need = -(-n // PS)
        t[i, :need] = [free.pop() for _ in range(need)]
    if share is not None:
        a, b, k = share
        t[b, :k] = t[a, :k]
    return t


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _i32(x, dev):
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,hists,share", [
    ([37, 5, 1, 64], [0, 21, 40, 3], None),
    ([9, 17, 1], [48, 48, 70], (0, 1, 3)),
    ([256, 3, 1], [1800, 40, 900], None),
])
def test_ragged_prefill_paged_kernel_matches_plain(card, dtype, lens, hists,
                                                   share):
    rng = np.random.default_rng(0)
    g = torch.Generator(device=card).manual_seed(0)
    kvl = [h + n for h, n in zip(hists, lens)]
    table = _table(rng, kvl, share)
    cu = np.concatenate([[0], np.cumsum(lens)])
    q = torch.randn((int(cu[-1]) + 7, HQ, D), generator=g,
                    device=card).to(dtype)
    k = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    v = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    idx = [_i32(x, card) for x in (table, cu, hists, kvl)]
    n0 = rp.ragged_prefill_paged.launches
    out = rp.ragged_prefill_paged(q, k, v, *idx)
    torch.cuda.synchronize()
    assert rp.ragged_prefill_paged.launches == n0 + 1
    _assert_held(out, rp.ragged_prefill_paged_plain, q, k, v, *idx)
    assert (out[int(cu[-1]):] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_paged_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(1)
    g = torch.Generator(device=card).manual_seed(1)
    lengths = [0, 1, 17, 2053, 129, 64]
    table = _table(rng, lengths, (4, 5, 4))
    q = torch.randn((len(lengths), HQ, D), generator=g,
                    device=card).to(dtype)
    k = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    v = torch.randn((NPAGES, PS, HKV, D), generator=g, device=card).to(dtype)
    idx = [_i32(table, card), _i32(lengths, card)]
    out = dec.decode_attn_paged(q, k, v, *idx)
    torch.cuda.synchronize()
    _assert_held(out, dec.decode_attn_paged_plain, q, k, v, *idx)
    assert (out[0] == 0).all()


# head widths no reference config has: the launchers refuse them before
# any launch
REFUSED_WIDTHS = (16, 32, 112, 256)


def test_kernel_refuses_what_it_does_not_take(card):
    """``check_kernel_inputs`` refuses every width outside 64, 80, 96
    and 128, for the six paged, arena and gathered launchers alike."""
    assert rp.HEAD_DIMS == fl.HEAD_DIMS == (64, 80, 96, 128)
    for d in REFUSED_WIDTHS:
        q = torch.zeros((4, HQ, d), device=card)
        k = torch.zeros((NPAGES, PS, HKV, d), device=card)
        table, lens = _i32(np.zeros((4, PMAX)), card), _i32([1] * 4, card)
        seg = [_i32([0, 1, 2, 3, 4], card), _i32([0] * 4, card), lens]
        for call in (
                lambda: dec.decode_attn_paged(q, k, k, table, lens),
                lambda: dec.decode_attn_arena(q, k, k, lens, lens),
                lambda: dec.decode_attn(q, k[:4], k[:4], lens),
                lambda: rp.ragged_prefill_paged(q, k, k, table, *seg),
                lambda: rp.ragged_prefill_arena(q, k, k, lens, *seg),
                lambda: rp.ragged_prefill_attn(q, k[:4], k[:4], *seg)):
            n0 = sum(f.launches for f in (
                dec.decode_attn_paged, dec.decode_attn_arena,
                dec.decode_attn, rp.ragged_prefill_paged,
                rp.ragged_prefill_arena, rp.ragged_prefill_attn))
            with pytest.raises(ValueError, match="head_dim"):
                call()
            assert n0 == sum(f.launches for f in (
                dec.decode_attn_paged, dec.decode_attn_arena,
                dec.decode_attn, rp.ragged_prefill_paged,
                rp.ragged_prefill_arena, rp.ragged_prefill_attn))


def test_engine_on_card_matches_engine_on_cpu(card):
    """The same schedule through the CUDA kernels and through the plain
    versions: the same greedy tokens, logits within 1e-4 (fp32)."""
    cfg = get_smoke("qwen3-4b").replace(head_dim=128)
    params = tr.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    ecfg = dict(num_slots=4, max_len=256, chunk_tokens=32, measure=False)
    engines = [Engine(cfg, params, EngineConfig(**ecfg), device="cpu"),
               Engine(cfg, on_card, EngineConfig(**ecfg), device=card)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (70, 9, 33)]
    outs = []
    n_rp, n_dec = rp.ragged_prefill_paged.launches, \
        dec.decode_attn_paged.launches
    for e in engines:
        r = e.step_mixed([(i, p) for i, p in enumerate(prompts)], [])
        d = e.decode_batch([0, 1, 2], [r.tokens[i] for i in range(3)], 4)
        outs.append((r.tokens, d))
    assert outs[0] == outs[1]
    assert rp.ragged_prefill_paged.launches > n_rp
    assert dec.decode_attn_paged.launches > n_dec
    for s in range(3):
        np.testing.assert_allclose(engines[1].last_logits[s],
                                   engines[0].last_logits[s], atol=1e-4,
                                   rtol=0)


def _slot_arena(card, dtype, g, s_max, live, slots=6):
    """A K/V arena whose rows at and past each live slot's length (the
    park row included) hold a large finite value."""
    k = torch.randn((slots, s_max, HKV, D), generator=g, device=card)
    v = torch.randn((slots, s_max, HKV, D), generator=g, device=card)
    valid = torch.zeros((slots, s_max), dtype=torch.bool, device=card)
    for slot, n in live.items():
        valid[slot, :n] = True
    k[~valid] = 1000.0
    v[~valid] = -1000.0
    return k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_max,lens,hists", [
    (200, [37, 1, 12], [120, 196, 0]),
    (4096, [512, 17, 1], [1536, 40, 900]),
])
def test_slot_prefill_kernels_match_plain(card, dtype, s_max, lens, hists):
    """ragged_prefill_arena over the arena and ragged_prefill_attn over
    the gathered slots, with two pad segments and a bucket tail."""
    g = torch.Generator(device=card).manual_seed(3)
    slots = [4, 0, 2]
    kvl = [h + n for h, n in zip(hists, lens)]
    k, v = _slot_arena(card, dtype, g, s_max, dict(zip(slots, kvl)))
    total = sum(lens)
    cu = [0] + list(np.cumsum(lens)) + [total] * 2
    slot_map = _i32(slots + [slots[0]] * 2, card)
    q = torch.randn((total + 7, HQ, D), generator=g, device=card).to(dtype)
    idx = [_i32(x, card) for x in (cu, hists + [0, 0], kvl + [0, 0])]
    kg, vg = k[slot_map.long()].contiguous(), v[slot_map.long()].contiguous()
    for fn, plain, args in (
            (rp.ragged_prefill_arena, rp.ragged_prefill_arena_plain,
             (q, k, v, slot_map, *idx)),
            (rp.ragged_prefill_attn, rp.ragged_prefill_attn_plain,
             (q, kg, vg, *idx))):
        n0 = fn.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        _assert_held(out, plain, *args)
        assert (out[total:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (40, 8), (8, 8), (32, 4)])
def test_ragged_prefill_tiles_match_plain(card, dtype, hq, hkv):
    _check_tiles(card, dtype, hq, hkv, D)


# the head widths besides 128: stablelm-1.6b's 64 and phi-3-vision's 96
# at their 32 / 32 heads (MHA, rep 1), 80 at 16 / 16, and each at 32 / 8
WIDTH_HEADS = [(64, 32, 32), (96, 32, 32), (80, 16, 16), (64, 32, 8),
               (80, 32, 8), (96, 32, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv", WIDTH_HEADS)
def test_ragged_prefill_tiles_at_head_widths(card, dtype, d, hq, hkv):
    _check_tiles(card, dtype, hq, hkv, d)


def _check_tiles(card, dtype, hq, hkv, d):
    """The three ragged kernels at each GQA group a 128-vector bf16 tile
    takes differently (32, 25 with 3 idle vectors, 128 and 16 rows), over one
    stream: a long segment across many 64-key tiles and 16-token pages,
    four 5-row segments at history 2043 (a tile across them would walk
    four bands), bands ending mid-tile, a keyless segment, two pad
    segments and a tail.  Every page row, arena row and park row at or
    past a segment's length holds NaN, and table entries past it point
    nowhere, so any stray read shows."""
    rng = np.random.default_rng(hq + hkv)
    g = torch.Generator(device=card).manual_seed(hq + hkv)
    lens, hists = [300, 5, 5, 5, 5, 1, 6], [1000, 2043, 2043, 37, 100, 900,
                                             0]
    kvl = [h + n for h, n in zip(hists, lens)]
    kvl[-1] = 0
    total, n_pad, tail = sum(lens), 2, 9
    cu = [0] + list(np.cumsum(lens)) + [total] * n_pad
    offs, kvl = hists + [0] * n_pad, kvl + [0] * n_pad
    idx = [_i32(x, card) for x in (cu, offs, kvl)]
    q = torch.randn((total + tail, hq, d), generator=g, device=card)
    q = q.to(dtype)
    n_pages = 512                       # 405 needed
    table = np.full((len(kvl), PMAX), 1 << 30, np.int32)
    free = list(rng.permutation(n_pages))
    page_ok = torch.zeros((n_pages, PS), dtype=torch.bool, device=card)
    for i, n in enumerate(kvl):
        for p in range(0, n, PS):
            table[i, p // PS] = free.pop()
            page_ok[int(table[i, p // PS]), :min(PS, n - p)] = True
    s_max, n_slots = 2100, len(lens) + 1
    slots = [int(x) for x in rng.permutation(n_slots)[:len(lens)]]
    slot_map = _i32(slots + [slots[0]] * n_pad, card)
    slot_ok = torch.zeros((n_slots, s_max), dtype=torch.bool, device=card)
    for slot, n in zip(slots, kvl):
        slot_ok[slot, :n] = True

    def storage(shape, ok):
        kv = [torch.randn(shape, generator=g, device=card) for _ in range(2)]
        clean = [a.masked_fill(~ok[..., None, None], 0.0).to(dtype)
                 for a in kv]
        junk = [a.masked_fill(~ok[..., None, None], float("nan")).to(dtype)
                for a in kv]
        return junk, clean

    (kp, vp), (kpc, vpc) = storage((n_pages, PS, hkv, d), page_ok)
    (ka, va), (kac, vac) = storage((n_slots, s_max, hkv, d), slot_ok)
    sm = slot_map.long()
    plain_table = _i32(np.where(table == 1 << 30, 0, table), card)
    for fn, plain, args, plain_args in (
            (rp.ragged_prefill_paged, rp.ragged_prefill_paged_plain,
             (q, kp, vp, _i32(table, card)), (q, kpc, vpc, plain_table)),
            (rp.ragged_prefill_arena, rp.ragged_prefill_arena_plain,
             (q, ka, va, slot_map), (q, kac, vac, slot_map)),
            (rp.ragged_prefill_attn, rp.ragged_prefill_attn_plain,
             (q, ka[sm].contiguous(), va[sm].contiguous()),
             (q, kac[sm], vac[sm]))):
        n0 = fn.launches
        out = fn(*args, *idx)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        _assert_held(out, plain, *plain_args, *idx)
        assert torch.isfinite(out).all()
        assert (out[cu[-2 - n_pad]:cu[-1 - n_pad]] == 0).all()  # keyless
        assert (out[total:] == 0).all()


# The paged prefill's TMA-fed core (``rp.tma_core``: bf16, D = 128, no
# window).  Each case: segments (rows, history, kv length); the cases put
# kv lengths at, below and just past 16-token pages and 64-key steps,
# make a mixed step like qwen3-4b.mixed_closed's (a 256-row chunk at
# history 4096 beside 15 one-row segments at 1024-12287), and give two
# segments the same prefix pages.  A keyless segment, a pad segment and
# tail rows ride along.
TMA_CASES = {
    "edges": [(1, 14, 15), (3, 13, 16), (1, 16, 17), (17, 46, 63),
              (1, 63, 64), (64, 1, 65), (2, 126, 128), (1, 128, 129),
              (5, 0, 0), (0, 0, 0)],
    "mixed": [(256, 4096, 4352)] + [(1, int(h), int(h) + 1) for h in
                                    np.linspace(1024, 12287, 15)],
    "shared": [(9, 48, 57), (17, 48, 65), (1, 70, 71), (40, 100, 140)],
}
TMA_SHARE = {"shared": (0, 1, 3)}
TMA_PMAX = 12288 // PS


def _tma_case(card, case, hq, hkv, seed=0):
    """q, the NaN pools and the zero pools, the page table (entries past
    each length point at a page of NaN), and the index tensors, for a
    case of TMA_CASES.  Pages are drawn in random order."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=card).manual_seed(seed)
    segs = TMA_CASES[case]
    lens = [n for n, _, _ in segs]
    hists = [h for _, h, _ in segs]
    kvl = [kv for _, _, kv in segs]
    need = sum(-(-x // PS) for x in kvl)
    n_pages = need + 8
    nan_page = n_pages - 1             # owned by no segment
    table = np.full((len(segs), TMA_PMAX), nan_page, np.int32)
    free = list(rng.permutation(n_pages - 1))
    ok = torch.zeros((n_pages, PS), dtype=torch.bool, device=card)
    for i, n in enumerate(kvl):
        for p in range(0, n, PS):
            table[i, p // PS] = free.pop()
    share = TMA_SHARE.get(case)
    if share is not None:
        a, b, k = share
        table[b, :k] = table[a, :k]
    for i, n in enumerate(kvl):
        for p in range(0, n, PS):
            ok[int(table[i, p // PS]), :min(PS, n - p)] = True
    kv = [torch.randn((n_pages, PS, hkv, D), generator=g, device=card)
          for _ in range(2)]
    clean = [a.masked_fill(~ok[..., None, None], 0.0).to(torch.bfloat16)
             for a in kv]
    junk = [a.masked_fill(~ok[..., None, None], float("nan")).to(
        torch.bfloat16) for a in kv]
    cu = np.concatenate([[0], np.cumsum(lens)])
    tail = 7
    q = torch.randn((int(cu[-1]) + tail, hq, D), generator=g,
                    device=card).to(torch.bfloat16)
    idx = [_i32(x, card) for x in (table, cu, hists, kvl)]
    return q, junk, clean, idx, int(cu[-1])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "nc"])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (40, 8)], ids=["rep4", "rep5"])
@pytest.mark.parametrize("case", list(TMA_CASES))
def test_tma_core_matches_plain_and_the_cp_async_core(card, case, hq, hkv,
                                                      causal):
    """The TMA-fed core against the plain version under the bf16 bound,
    with NaN in every page row past each length and every table entry
    past it pointing at a page of NaN: the output is finite, the same
    bits as over pools with 0 there, the same bits in two runs, and the
    same bits as the cp.async core on the same inputs (the ring-table
    form with a window past every position walks the same 64-key steps
    with the same arithmetic)."""
    q, (kn, vn), (kc, vc), idx, total = _tma_case(card, case, hq, hkv)
    assert rp.tma_core(q.dtype, D, PS, None)
    fn = rp.ragged_prefill_paged
    n0, t0 = fn.launches, fn.tma.launches
    out = rp.ragged_prefill_paged(q, kn, vn, *idx, causal=causal)
    again = rp.ragged_prefill_paged(q, kn, vn, *idx, causal=causal)
    clean = rp.ragged_prefill_paged(q, kc, vc, *idx, causal=causal)
    cp = rp.ragged_prefill_paged(q, kn, vn, *idx, causal=causal,
                                 window=1 << 30)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tma.launches) == (n0 + 4, t0 + 3)
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    assert torch.equal(out, clean)
    assert torch.equal(out, cp)
    _assert_held(out, lambda *a: rp.ragged_prefill_paged_plain(
        *a, causal=causal), q, kc, vc, *idx)
    assert (out[total:] == 0).all()


def test_tma_core_is_taken_by_its_calls_alone(card):
    """``tma.launches`` counts the calls ``rp.tma_core`` names — bf16 at
    head width 128 with no window — and no fp32 call, no windowed call
    and no call at another width."""
    g = torch.Generator(device=card).manual_seed(5)
    table = _i32(np.arange(8, dtype=np.int32)[None], card)
    idx = [table] + [_i32(x, card) for x in ([0, 40], [60], [100])]
    for dtype, d, window, taken in ((torch.bfloat16, 128, None, True),
                                    (torch.float32, 128, None, False),
                                    (torch.bfloat16, 128, 64, False),
                                    (torch.bfloat16, 64, None, False),
                                    (torch.bfloat16, 96, None, False)):
        q = torch.randn((40, HQ, d), generator=g, device=card).to(dtype)
        k = torch.randn((8, PS, HKV, d), generator=g, device=card).to(dtype)
        v = torch.randn((8, PS, HKV, d), generator=g, device=card).to(dtype)
        assert rp.tma_core(dtype, d, PS, window) is taken
        t0 = rp.ragged_prefill_paged.tma.launches
        out = rp.ragged_prefill_paged(q, k, v, *idx, window=window)
        torch.cuda.synchronize()
        assert rp.ragged_prefill_paged.tma.launches == t0 + taken
        _assert_held(out, lambda *a: rp.ragged_prefill_paged_plain(
            *a, window=window), q, k, v, *idx)


def test_tma_core_facts(card):
    """The TMA-fed kernel's launch facts: one block of 384 threads an SM,
    a ring of six 32 KB K/V stages beside Q's 32 KB."""
    f = rp.tma_launch_info()
    assert f["blocks_per_sm"] == 1
    assert 7 * 32768 < f["smem"] <= 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_arena_kernel_matches_plain(card, dtype):
    """Live rows of 0 to 2053 keys and ladder pad rows (length 1 on the
    first row's slot) in a 192-deep and a 4096-deep arena."""
    g = torch.Generator(device=card).manual_seed(4)
    for s_max, lengths in ((192, [0, 190, 33, 1]),
                           (4096, [2053, 1, 129, 64])):
        slots = [3, 1, 5, 0]
        k, v = _slot_arena(card, dtype, g, s_max, dict(zip(slots, lengths)))
        slot_map = slots + [slots[0]] * 3
        lens = lengths + [1] * 3
        q = torch.randn((len(lens), HQ, D), generator=g,
                        device=card).to(dtype)
        out = dec.decode_attn_arena(q, k, v, _i32(slot_map, card),
                                    _i32(lens, card))
        torch.cuda.synchronize()
        _assert_held(out[:4], dec.decode_attn_arena_plain, q[:4], k, v,
                     _i32(slots, card), _i32(lengths, card))
        zero = [i for i, n in enumerate(lengths) if n == 0]
        assert (out[zero] == 0).all() and torch.isfinite(out).all()


# the decode kernels' split walk at every GQA group, over its chunk
# boundaries: rows of C - 1, C, C + 1 and 2C keys at the chunk C the
# launcher plans, the capacity, a long row beside short ones, a row of
# length 0 and a decode-ladder pad row (length 1 on row 1's storage)
SPLIT_HEADS = [(32, 8), (40, 8), (8, 8), (32, 4)]
SPLIT_CAP = 1056          # the arena's S_max, the cache's S


def _split_case(card, dtype, g, layout, hq, hkv, d=D):
    """(launcher, plain, kernel args, plain args, lengths) of one split
    case, with NaN in every K/V row past a length (page, arena slot or
    cache row) for the kernel and 0 there for the plain version."""
    n_sms = torch.cuda.get_device_properties(card).multi_processor_count
    cap = PMAX * PS if layout == "paged" else SPLIT_CAP
    plan = dec.split_plan(10, hq, hkv, d, cap, n_sms)
    assert plan.n_chunks > 1
    c = plan.chunk
    lens = [0, 1, c - 1, c, c + 1, 2 * c, SPLIT_CAP - 1, 200, 33]
    lens = [min(n, SPLIT_CAP - 1) for n in lens]
    if layout == "paged":
        rng = np.random.default_rng(hq + hkv)
        table = _table(rng, lens)
        table = np.concatenate([table, table[1:2]])       # the pad row
        lens = lens + [1]
        ok = torch.zeros((NPAGES, PS), dtype=torch.bool, device=card)
        for i, n in enumerate(lens):
            for p in range(n):
                ok[int(table[i, p // PS]), p % PS] = True
        shape, index = (NPAGES, PS, hkv, d), [_i32(table, card)]
        fn, plain = dec.decode_attn_paged, dec.decode_attn_paged_plain
    elif layout == "arena":
        slots = list(range(len(lens)))[::-1]
        ok = torch.zeros((len(lens), SPLIT_CAP), dtype=torch.bool,
                         device=card)
        for slot, n in zip(slots, lens):
            ok[slot, :n] = True
        slots, lens = slots + [slots[1]], lens + [1]
        shape, index = (len(slots) - 1, SPLIT_CAP, hkv, d), \
            [_i32(slots, card)]
        fn, plain = dec.decode_attn_arena, dec.decode_attn_arena_plain
    else:
        lens = lens + [1]
        ok = torch.arange(SPLIT_CAP, device=card)[None, :] \
            < _i32(lens, card)[:, None]
        shape, index = (len(lens), SPLIT_CAP, hkv, d), []
        fn, plain = dec.decode_attn, dec.decode_attn_plain
    k = torch.randn(shape, generator=g, device=card)
    v = torch.randn(shape, generator=g, device=card)
    kn, vn = k.clone(), v.clone()
    kn[~ok], vn[~ok] = float("nan"), float("nan")
    k[~ok], v[~ok] = 0.0, 0.0
    q = torch.randn((len(lens), hq, d), generator=g, device=card).to(dtype)
    idx = index + [_i32(lens, card)]
    return (fn, plain, (q, kn.to(dtype), vn.to(dtype), *idx),
            (q, k.to(dtype), v.to(dtype), *idx), lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", SPLIT_HEADS)
@pytest.mark.parametrize("layout", ["paged", "arena", "dense"])
def test_decode_split_matches_plain_at_every_group(card, layout, hq, hkv,
                                                   dtype):
    g = torch.Generator(device=card).manual_seed(hq * hkv)
    fn, plain, args, plain_args, lens = _split_case(card, dtype, g, layout,
                                                    hq, hkv)
    assert lens[0] == 0 and lens[-1] == 1        # a keyless row, a pad row
    n0 = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    _assert_held(out, plain, *plain_args)
    assert (out[0] == 0).all() and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv", WIDTH_HEADS)
@pytest.mark.parametrize("layout", ["paged", "arena", "dense"])
def test_decode_split_at_head_widths(card, layout, d, hq, hkv, dtype):
    """The split walk (more than one chunk) and the combine at D / 4
    lanes at each width besides 128."""
    g = torch.Generator(device=card).manual_seed(d + hq * hkv)
    fn, plain, args, plain_args, lens = _split_case(card, dtype, g, layout,
                                                    hq, hkv, d)
    n0 = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    _assert_held(out, plain, *plain_args)
    assert (out[0] == 0).all() and torch.isfinite(out).all()


def test_decode_attn_paged_replays_in_a_cuda_graph(card):
    """One decode_attn_paged launch captured in a CUDA graph and replayed
    after ``lengths`` is rewritten in place: each replay matches the
    plain version at the new lengths, so the launch read nothing back
    to the host (its split plan comes from shapes alone)."""
    _replay_decode(card, HQ, HKV, D)


def test_decode_attn_paged_replays_at_d96_in_a_cuda_graph(card):
    """The same at phi-3-vision's 32 / 32 heads of 96."""
    _replay_decode(card, 32, 32, 96)


def _replay_decode(card, hq, hkv, d):
    g = torch.Generator(device=card).manual_seed(11)
    rng = np.random.default_rng(11)
    first, later = [0, 1, 300, 2053, 17, 129], [5, 0, 2047, 2100, 600, 1]
    table = _i32(_table(rng, [max(a, b) for a, b in zip(first, later)]),
                 card)
    q = torch.randn((6, hq, d), generator=g, device=card).to(torch.bfloat16)
    k = torch.randn((NPAGES, PS, hkv, d), generator=g,
                    device=card).to(torch.bfloat16)
    v = torch.randn((NPAGES, PS, hkv, d), generator=g,
                    device=card).to(torch.bfloat16)
    lengths = _i32(first, card)
    dec.decode_attn_paged(q, k, v, table, lengths)    # builds, warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dec.decode_attn_paged(q, k, v, table, lengths)
    for lens in (later, first, later):
        lengths.copy_(_i32(lens, card))
        graph.replay()
        torch.cuda.synchronize()
        _assert_held(out, dec.decode_attn_paged_plain, q, k, v, table,
                     _i32(lens, card))
        zero = [i for i, n in enumerate(lens) if n == 0]
        assert (out[zero] == 0).all()


@pytest.mark.parametrize("mode", [
    dict(paged_kv=False), dict(paged_kv=False, arena_prefill=False),
    dict(packed=False, paged_kv=False),
    dict(packed=False, paged_kv=False, arena_decode=False)],
    ids=["arena", "gathered", "dense", "dense_decode"])
def test_slot_engine_on_card_matches_engine_on_cpu(card, mode):
    """Each slot mode through the CUDA kernels and through the plain
    versions: the same greedy tokens, logits within 1e-4 (fp32)."""
    cfg = get_smoke("qwen3-4b").replace(head_dim=128)
    params = tr.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    ecfg = dict(num_slots=4, max_len=256, chunk_tokens=32, measure=False,
                **mode)
    engines = [Engine(cfg, params, EngineConfig(**ecfg), device="cpu"),
               Engine(cfg, on_card, EngineConfig(**ecfg), device=card)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (70, 9, 33)]
    outs = []
    for e in engines:
        r = e.prefill_batch([0, 1, 2], prompts)
        d = e.decode_batch([0, 1, 2], [r[i] for i in range(3)], 4)
        r2 = e.prefill_batch([1], [prompts[1]], bucket=(16, 2))
        outs.append((r, d, r2))
    assert outs[0] == outs[1]
    for s in range(3):
        np.testing.assert_allclose(engines[1].last_logits[s],
                                   engines[0].last_logits[s], atol=1e-4,
                                   rtol=0)


# the dense kernels' GQA groups: rep 1 (hubert-xlarge), 4 (qwen3-4b), 5
# (qwen2.5-32b), 8 (the widest group the dense kernels take)
DENSE_HEADS = [(16, 16), (32, 8), (40, 8), (64, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("hq,hkv", DENSE_HEADS)
@pytest.mark.parametrize("case", [
    # q_offsets, kv_lengths, causal, window
    ([0, 90, 199], [37, 127, 200], True, None),
    ([0, 0, 0], [200, 61, 0], False, None),
    ([10, 150, 0], [47, 187, 0], True, 24),
], ids=["causal_offsets", "noncausal", "window"])
def test_flash_attn_kernel_matches_plain(card, dtype, d, hq, hkv, case):
    import functools
    offs, kvl, causal, window = case
    g = torch.Generator(device=card).manual_seed(d + hq)
    q = torch.randn((3, 37, hq, d), generator=g, device=card).to(dtype)
    k = torch.randn((3, 200, hkv, d), generator=g, device=card)
    v = torch.randn((3, 200, hkv, d), generator=g, device=card)
    for i, n in enumerate(kvl):          # junk past each length
        k[i, n:] = 1000.0
        v[i, n:] = 1000.0
    k, v = k.to(dtype), v.to(dtype)
    idx = [_i32(offs, card), _i32(kvl, card)]
    n0 = fl.flash_attn.launches
    out = fl.flash_attn(q, k, v, *idx, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fl.flash_attn.launches == n0 + 1
    plain = functools.partial(fl.flash_attn_plain, causal=causal,
                              window=window)
    _assert_held(out, plain, q, k, v, *idx)
    assert (out[[i for i, n in enumerate(kvl) if n == 0]] == 0).all()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", DENSE_HEADS)
def test_decode_attn_dense_kernel_matches_plain(card, dtype, hq, hkv):
    g = torch.Generator(device=card).manual_seed(hq)
    lengths = [0, 1, 17, 300, 512, 2]
    q = torch.randn((6, hq, D), generator=g, device=card).to(dtype)
    k = torch.randn((6, 512, hkv, D), generator=g, device=card)
    v = torch.randn((6, 512, hkv, D), generator=g, device=card)
    for i, n in enumerate(lengths):
        k[i, n:] = 1000.0
        v[i, n:] = 1000.0
    k, v = k.to(dtype), v.to(dtype)
    n0 = dec.decode_attn.launches
    out = dec.decode_attn(q, k, v, _i32(lengths, card))
    torch.cuda.synchronize()
    assert dec.decode_attn.launches == n0 + 1
    _assert_held(out, dec.decode_attn_plain, q, k, v, _i32(lengths, card))
    assert (out[0] == 0).all()


def test_dense_kernels_refuse_what_they_do_not_take(card):
    idx = _i32([0, 0], card)
    for d, hq, match in ((48, 4, "head_dim"), (64, 36, "Hq / Hkv")):
        q = torch.zeros((2, 5, hq, d), device=card)
        k = torch.zeros((2, 9, 4, d), device=card)
        with pytest.raises(ValueError, match=match):
            fl.flash_attn(q, k, k, idx, idx)
    for d in REFUSED_WIDTHS:
        q = torch.zeros((2, 8, d), device=card)
        k = torch.zeros((2, 9, 2, d), device=card)
        with pytest.raises(ValueError, match="head_dim"):
            dec.decode_attn(q, k, k, idx)


def test_encoder_forward_on_card_matches_cpu(card):
    """The hubert-xlarge smoke encoder at head_dim 80 through
    ``flash_attn`` (non-causal) against the same forward on the CPU,
    with and without a cache and ``kv_valid_len``."""
    cfg = get_smoke("hubert-xlarge").replace(head_dim=80)
    params = tr.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    emb = torch.randn((2, 70, cfg.d_model),
                      generator=torch.Generator().manual_seed(3))
    kvl = torch.tensor([70, 41], dtype=torch.int32)
    for cached in (False, True):
        kw = {}
        if cached:
            kw = dict(caches=tr.init_cache(cfg, 2, 96, device="cpu"),
                      kv_valid_len=kvl)
        want = tr.forward(params, cfg, embeds=emb, **kw)
        n0 = fl.flash_attn.launches
        got = tr.forward(on_card, cfg, embeds=emb.to(card), **_to(kw, card))
        assert fl.flash_attn.launches == n0 + cfg.num_layers
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=0)


# (temp, top_k, top_p, bias) cycled over the rows of a sampling batch:
# greedy, biased greedy, plain temperature, top-k of 1, off (>= V) and
# 20, top-p tiny and near 1, all 8 bias slots with a repeated id and one
# past the vocabulary
SAMPLE_PARAMS = [
    (0.0, 0, 1.0, ()), (0.0, 0, 1.0, ((9, 4.0), (9, 4.0))),
    (1.0, 0, 1.0, ()), (1.1, 1, 1.0, ()), (0.9, 1 << 20, 1.0, ()),
    (0.8, 20, 0.95, ((3, 2.0),)), (1.2, 0, 1e-6, ()),
    (1.0, 0, 0.999999, ()),
    (0.7, 12, 1.0, tuple((7 * j + 1, 0.5) for j in range(6))
     + ((1, 1.0), (1 << 30, 9.0))),
]


def _sample_inputs(card, r, v, dtype, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 3.0, (r, v)).astype(np.float32)
    logits[::3, max(v - 64, 1):] = -1e9          # a padded-vocab tail
    temp = np.zeros(r, np.float32)
    top_k = np.zeros(r, np.int32)
    top_p = np.ones(r, np.float32)
    bids = -np.ones((r, ks.MAX_BIAS), np.int32)
    bvals = np.zeros((r, ks.MAX_BIAS), np.float32)
    for i in range(r):
        t, k, p, bias = SAMPLE_PARAMS[i % len(SAMPLE_PARAMS)]
        temp[i], top_k[i], top_p[i] = t, k, p
        for j, (tok, b) in enumerate(bias):
            bids[i, j], bvals[i, j] = tok, b
    u = rng.random(r).astype(np.float32)
    u[::5] = 0.0
    u[1::7] = np.float32(1.0 - 2.0 ** -24)
    draft = rng.integers(-1, v, r).astype(np.int32)
    x = torch.as_tensor(logits, device=card).to(dtype)
    return (x, temp, top_k, top_p, bids, bvals, u, draft)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,v", [(40, 151936), (1, 151936), (23, 128)])
def test_fused_sample_kernel_matches_plain(card, dtype, r, v):
    args = _sample_inputs(card, r, v, dtype, seed=r + v)
    n0 = ks.fused_sample.launches
    got = [x.cpu().numpy() for x in ks.fused_sample(*args)]
    torch.cuda.synchronize()
    assert ks.fused_sample.launches == n0 + 1
    want = [x.cpu().numpy() for x in ks.fused_sample_plain(*args)]
    margin = ks.cdf_margin(*args).cpu().numpy()
    greedy = args[1] <= 0
    assert (got[0][greedy] == want[0][greedy]).all()
    for k in (0, 2):
        bad = got[k] != want[k]
        assert (margin[bad] < 1e-5).all(), (k, np.nonzero(bad), margin[bad])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)


def _held_sample(args, got):
    got = [x.cpu().numpy() for x in got]
    want = [x.cpu().numpy() for x in ks.fused_sample_plain(*args)]
    margin = ks.cdf_margin(*args).cpu().numpy()
    greedy = np.asarray(args[1]) <= 0
    assert (got[0][greedy] == want[0][greedy]).all()
    for k in (0, 2):
        bad = got[k] != want[k]
        assert (margin[bad] < 1e-5).all(), (k, np.nonzero(bad), margin[bad])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [151936, 152064, 50280])
@pytest.mark.parametrize("r", [1, 8, 40, 64])
def test_fused_sample_at_vocab_widths(card, dtype, r, v):
    """The cluster kernel at qwen3-4b's, qwen2.5-32b's and mamba2-2.7b's
    vocabularies, 1 to 64 rows (64 clusters: more than one wave)."""
    args = _sample_inputs(card, r, v, dtype, seed=3 * r + v)
    n0 = ks.fused_sample.launches
    got = ks.fused_sample(*args)
    torch.cuda.synchronize()
    assert ks.fused_sample.launches == n0 + 1
    _held_sample(args, got)


def _capacity_rows(card, v, dtype, ks_):
    """Rows of ``C`` or ``C + 1`` distinct bf16-exact logits above a
    floor of -10, top_k = C or C + 1: kept sets on each side of the
    compact capacity."""
    rng = np.random.default_rng(len(ks_))
    r = len(ks_)
    logits = np.full((r, v), -10.0, np.float32)
    for i, k in enumerate(ks_):
        bits = (0x3F80 + np.arange(k)).astype(np.uint32) << 16
        logits[i, rng.permutation(v)[:k]] = bits.view(np.float32)
    temp = np.full(r, 40.0, np.float32)
    top_k = np.asarray(ks_, np.int32)
    top_p = np.full(r, 0.97, np.float32)
    bids = -np.ones((r, ks.MAX_BIAS), np.int32)
    bvals = np.zeros((r, ks.MAX_BIAS), np.float32)
    u = rng.random(r).astype(np.float32)
    draft = rng.integers(0, v, r).astype(np.int32)
    x = torch.as_tensor(logits, device=card).to(dtype)
    return (x, temp, top_k, top_p, bids, bvals, u, draft)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sample_whole_row_and_capacity(card, dtype):
    """A batch whose every row takes the whole-row path (top-k off, top_p
    0.9), and one that straddles the compact capacity (kept sets of C - 1,
    C, C + 1 and 2 C)."""
    v = 151936
    args = list(_sample_inputs(card, 40, v, dtype, seed=11))
    args[1] = np.full(40, 0.8, np.float32)
    args[2] = np.zeros(40, np.int32)
    args[3] = np.full(40, 0.9, np.float32)
    # top_k 0: every row takes the whole-row path
    _held_sample(args, ks.fused_sample(*args))
    c = ks.CAPACITY
    args = _capacity_rows(card, v, dtype, [c - 1, c, c + 1, 2 * c])
    # kept sets of C - 1 and C are drawn compact, C + 1 and 2 C whole-row
    scaled = args[0].float().cpu() / torch.as_tensor(args[1])[:, None]
    kept = ks._topk_keep(scaled, torch.as_tensor(args[2])).sum(-1)
    assert kept.tolist() == [c - 1, c, c + 1, 2 * c]
    _held_sample(args, ks.fused_sample(*args))


def test_fused_sample_replays_in_a_cuda_graph(card):
    """One bf16 fused_sample call captured in a CUDA graph: replays on
    new inputs copied into the captured buffers equal eager calls."""
    def inputs(seed):
        a = _sample_inputs(card, 40, 151936, torch.bfloat16, seed)
        return [a[0]] + [torch.as_tensor(x, device=card) for x in a[1:]]
    static = [t.clone() for t in inputs(1)]
    ks.fused_sample(*static)                  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ks.fused_sample(*static)
    for seed in (2, 3):
        fresh = inputs(seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        want = ks.fused_sample(*fresh)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_fused_sample_allocates_no_workspace(card):
    """A call allocates its three (R,) outputs and nothing of (R, V)."""
    args = _sample_inputs(card, 40, 151936, torch.bfloat16, seed=5)
    args = [args[0]] + [torch.as_tensor(x, device=card) for x in args[1:]]
    ks.fused_sample(*args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    out = ks.fused_sample(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(card) - before
    assert grown <= 3 * 512, grown
    del out


def test_sampled_spec_fused_matches_host_on_card(card):
    """A sampled session under speculation on the card: the fused
    kernel's stream equals the host sampler's, and only the host path
    ships logits rows."""
    cfg = get_smoke("qwen3-4b").replace(head_dim=128)
    params = _to(tr.init_params(cfg, seed=0, device="cpu"), card)
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, cfg.vocab_size, 9)
    script = list(rng.integers(1, cfg.vocab_size, 40))
    streams = {}
    for fused in (False, True):
        eng = Engine(cfg, params, EngineConfig(
            num_slots=4, max_len=256, chunk_tokens=32, measure=False,
            keep_last_logits=False, fused_sampling=fused), device=card)
        eng.enable_spec(ScriptedDraft({0: script}, vocab=cfg.vocab_size),
                        k=3)
        eng.open_session(0)
        eng.set_sampling(0, SamplingParams(temperature=0.8, top_k=20,
                                           top_p=0.95, seed=7,
                                           logit_bias={3: 2.0}))
        out = [eng.prefill_packed([0], [prompt])[0]]
        while len(out) < 16:
            out += eng.spec_step([(0, out[-1])],
                                 max_new={0: 16 - len(out)})[0]
        streams[fused] = out
        st = eng.stats()
        assert (st["logits_rows_shipped"] == 0) == fused
        assert (st["fused_sample_steps"] > 0) == fused
    assert streams[True] == streams[False]


def _ssd_args(card, b, l, g, dtype, seed, nh=80, hd=64, ds=128):
    """SSD scan inputs at mamba2's heads, x / B / C as views into one
    conv-output row; dt = 0 on the last rows (right padding), a strong
    decay on row l // 2, a non-zero init state."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    xbc = 0.5 * torch.randn((b, l, nh * hd + 2 * g * ds), generator=gen,
                            device=card)
    xbc = xbc.to(dtype)
    x = xbc[..., :nh * hd].reshape(b, l, nh, hd)
    bm = xbc[..., nh * hd:nh * hd + g * ds].reshape(b, l, g, ds)
    cm = xbc[..., nh * hd + g * ds:].reshape(b, l, g, ds)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, nh), generator=gen, device=card))
    dt[:, l // 2] *= 40.0
    dt[:, max(l - 3, 1):] = 0.0
    a = -torch.linspace(1.0, 16.0, nh, device=card)
    h0 = 0.1 * torch.randn((b, nh, hd, ds), generator=gen, device=card)
    return x, dt.contiguous(), a, bm, cm, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,g", [(1, 1, 1), (2, 129, 1), (1, 300, 80),
                                   (8, 64, 1)])
def test_ssd_scan_kernel_matches_plain(card, dtype, b, l, g):
    args = _ssd_args(card, b, l, g, dtype, seed=l)
    n = ssd.ssd_scan.launches
    y, st = ssd.ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == n + 1
    yr, yb, sr, sb = ssd_error_bound(*args, 128)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert bool(((y.float() - yr).abs() <= yb).all())
    assert bool(((st - sr).abs() <= sb).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["zero_first", "zero_middle", "zero_last",
                                  "bridge_rows", "one_dt"])
def test_ssd_scan_kernel_skips_only_zero_chunks(card, dtype, case):
    """Chunks whose dt is 0 for every head, which the kernel computes as
    y = C state^T with the state passed on, held to the plain version:
    a zero chunk first, between two real chunks and last; the packed
    bridge's rows (dt = 0 past lengths 0, 1, 127, 128, 129, 300); a chunk
    whose only non-zero dt is one row, which must not be skipped."""
    b, l = (6, 300) if case == "bridge_rows" else (1, 384)
    x, dt, a, bm, cm, h0 = _ssd_args(card, b, l, 1, dtype, seed=7)
    rows = torch.arange(l, device=card)
    if case == "bridge_rows":
        lens = torch.tensor([0, 1, 127, 128, 129, 300], device=card)
        dt = torch.where(rows[None, :, None] < lens[:, None, None], dt, 0.0)
    elif case == "one_dt":
        dt = torch.where((rows < 128)[None, :, None] | (rows == 200)[
            None, :, None], dt, 0.0)
    else:
        k = ["zero_first", "zero_middle", "zero_last"].index(case)
        dt = torch.where((rows // 128 == k)[None, :, None], 0.0, dt)
    args = (x, dt.contiguous(), a, bm, cm, h0)
    y, st = ssd.ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    yr, yb, sr, sb = ssd_error_bound(*args, 128)
    assert bool(((y.float() - yr).abs() <= yb).all())
    assert bool(((st - sr).abs() <= sb).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,hd,g,ds,chunk", [(6, 40, 2, 20, 48),
                                              (3, 10, 1, 17, 16),
                                              (4, 24, 4, 200, 32)])
def test_ssd_scan_kernel_takes_any_widths(card, dtype, nh, hd, g, ds,
                                          chunk):
    """Widths whose rows are not whole 16-byte units (plain loads in
    place of bulk copies, C read element by element), a head's columns
    past its last full slice, DS past 128 (the wider state instance),
    chunks off the 16-row grid, held to the plain version."""
    args = _ssd_args(card, 2, 150, g, dtype, seed=nh, nh=nh, hd=hd, ds=ds)
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    yr, yb, sr, sb = ssd_error_bound(*args, chunk)
    assert bool(((y.float() - yr).abs() <= yb).all())
    assert bool(((st - sr).abs() <= sb).all())


def test_ssd_scan_replays_in_a_cuda_graph(card):
    """One bf16 ssd_scan call captured in a CUDA graph: replays on new
    inputs copied into the captured buffers match an eager call."""
    static = [t.clone() for t in _ssd_args(card, 2, 300, 1, torch.bfloat16,
                                           seed=3)]
    ssd.ssd_scan(*static, chunk=128)           # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd.ssd_scan(*static, chunk=128)
    for seed in (4, 5):
        fresh = _ssd_args(card, 2, 300, 1, torch.bfloat16, seed=seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        y, st = ssd.ssd_scan(*fresh, chunk=128)
        torch.cuda.synchronize()
        assert torch.equal(out[0], y) and torch.equal(out[1], st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l", [(1, 300), (2, 129), (8, 64)])
def test_ssd_scan_at_jamba_groups(card, dtype, b, l):
    """jamba-v0.1-52b's layout: 128 heads of 64, state 128, B/C in 8
    groups of 16 heads, each launch counted as grouped."""
    args = _ssd_args(card, b, l, 8, dtype, seed=l + b, nh=128)
    n, ng = ssd.ssd_scan.launches, ssd.ssd_scan.grouped.launches
    y, st = ssd.ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == n + 1
    assert ssd.ssd_scan.grouped.launches == ng + 1
    yr, yb, sr, sb = ssd_error_bound(*args, 128)
    assert bool(((y.float() - yr).abs() <= yb).all())
    assert bool(((st - sr).abs() <= sb).all())


def test_ssd_scan_kernel_refuses_what_it_does_not_take(card):
    x, dt, a, bm, cm, h0 = _ssd_args(card, 1, 8, 1, torch.float32, seed=0)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, dt, a, bm, cm, h0, chunk=256)
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_scan(x, dt.bfloat16(), a, bm, cm, h0)
    with pytest.raises(ValueError, match="NH % G"):
        ssd.ssd_scan(x, dt, a, bm[:, :, :0], cm[:, :, :0], h0)


SSM_ENGINE_MODES = [dict(), dict(paged_kv=False),
                    dict(packed=False, paged_kv=False)]


@pytest.mark.parametrize("mode", SSM_ENGINE_MODES,
                         ids=["paged", "arena", "dense"])
def test_ssm_engine_on_card_matches_engine_on_cpu(card, mode):
    """The mamba2 smoke config in each SSM mode through the ssd_scan
    kernel and through its plain version: the same greedy tokens,
    logits within 1e-4 (fp32)."""
    _engine_on_card_matches_cpu(card, get_smoke("mamba2-2.7b"), mode)


@pytest.mark.parametrize("mode", SSM_ENGINE_MODES,
                         ids=["paged", "arena", "dense"])
def test_hybrid_engine_on_card_matches_engine_on_cpu(card, mode):
    """jamba's smoke config (its attention at head_dim 64 beside its SSD
    layers at 2 B/C groups) in each SSM mode through the attention and
    ssd_scan kernels and through their plain versions: the same greedy
    tokens, logits within 1e-4 (fp32), every scan grouped."""
    ng = ssd.ssd_scan.grouped.launches
    _engine_on_card_matches_cpu(
        card, get_smoke("jamba-v0.1-52b").replace(head_dim=64), mode)
    assert ssd.ssd_scan.grouped.launches > ng


def _engine_on_card_matches_cpu(card, cfg, mode):
    params = tr.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    ecfg = dict(num_slots=4, max_len=256, chunk_tokens=32, measure=False,
                **mode)
    engines = [Engine(cfg, params, EngineConfig(**ecfg), device="cpu"),
               Engine(cfg, on_card, EngineConfig(**ecfg), device=card)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (70, 9, 33)]
    outs = []
    n = ssd.ssd_scan.launches
    for e in engines:
        r = e.prefill_batch([0, 1, 2], prompts)
        d = e.decode_batch([0, 1, 2], [r[i] for i in range(3)], 4)
        r2 = e.prefill_long(3, prompts[0])
        outs.append((r, d, r2))
    assert outs[0] == outs[1]
    assert ssd.ssd_scan.launches > n
    for s in range(4):
        np.testing.assert_allclose(engines[1].last_logits[s],
                                   engines[0].last_logits[s], atol=1e-4,
                                   rtol=0)


# ------------------------------------------------- step graphs on the card

def _tile_inputs(card, name, seed):
    """One bf16 launch of a tile-core kernel at qwen3-4b's heads: four
    segments (or rows) whose lengths and histories change with
    ``seed`` while every shape stays."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(
            torch.bfloat16)

    lens, hists = (([37, 5, 1, 64], [0, 21, 40, 3]) if seed % 2 else
                   ([64, 1, 5, 37], [300, 2000, 7, 0]))
    kvl = [h + n for h, n in zip(hists, lens)]
    cu = np.concatenate([[0], np.cumsum(lens)])
    idx = [_i32(x, card) for x in (cu, hists, kvl)]
    q = randn(int(cu[-1]) + 7, HQ, D)
    if name == "ragged_prefill_paged":
        return (q, randn(NPAGES, PS, HKV, D), randn(NPAGES, PS, HKV, D),
                _i32(_table(rng, kvl), card), *idx)
    if name == "ragged_prefill_arena":
        slots = [int(s) for s in rng.permutation(6)[:4]]
        return (q, randn(6, 2100, HKV, D), randn(6, 2100, HKV, D),
                _i32(slots, card), *idx)
    if name == "ragged_prefill_attn":
        return (q, randn(4, 2100, HKV, D), randn(4, 2100, HKV, D), *idx)
    return (randn(4, 64, HQ, D), randn(4, 2100, HKV, D),
            randn(4, 2100, HKV, D), _i32(hists, card),
            _i32([h + 64 for h in hists], card))


@pytest.mark.parametrize("name", ["ragged_prefill_paged",
                                  "ragged_prefill_arena",
                                  "ragged_prefill_attn", "flash_attn"])
def test_tile_kernel_replays_in_a_cuda_graph(card, name):
    """One bf16 launch of each kernel on the wgmma tile core (its
    dynamic shared memory set at every launch) captured in a CUDA graph:
    replays on new inputs copied into the captured buffers equal eager
    launches bit for bit and hold the plain version."""
    mod = fl if name == "flash_attn" else rp
    fn, plain = getattr(mod, name), getattr(mod, name + "_plain")
    static = [t.clone() for t in _tile_inputs(card, name, 1)]
    fn(*static)                                # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = fn.launches
    with torch.cuda.graph(graph):
        out = fn(*static)
    assert fn.launches == n0 + 1
    for seed in (2, 3):
        fresh = _tile_inputs(card, name, seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        want = fn(*fresh)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        _assert_held(out, plain, *fresh)


def _on(args, dev):
    return tuple(torch.as_tensor(np.asarray(a, np.int32), device=dev)
                 if isinstance(a, np.ndarray) else a for a in args)


def _eager_steps(engine):
    """Run every step of ``engine``'s executors eagerly, as its step
    graph would: the step on parked inputs at a shape's first dispatch
    (the warm-up), then ``fill`` and the step on the real inputs."""
    from repro_torch.serving import executor as tex

    for ex in engine.executors:
        seen = set()

        def step(kind, keyed, fn, args, park, fill=None, ex=ex, seen=seen):
            args = tuple(np.asarray(a, np.int32)
                         if isinstance(a, np.ndarray) else a for a in args)
            key = ex._note_dispatch(kind, *(args[i] for i in keyed))
            if key not in seen:
                seen.add(key)
                fn(*_on(tex._parked(args, park), engine.device))
            if fill is not None:
                fill()
            return fn(*_on(args, engine.device))

        ex._step = step


# (arch, engine options, speculation, the step kinds the schedule runs)
GRAPH_MODES = {
    "paged": ("qwen3-4b", dict(), False, ("packed_paged", "paged_decode")),
    "arena": ("qwen3-4b", dict(paged_kv=False), False,
              ("packed_arena", "arena_decode")),
    "gathered": ("qwen3-4b", dict(paged_kv=False, arena_prefill=False),
                 False, ("packed_prefill", "arena_decode")),
    "grid": ("qwen3-4b", dict(packed=False, paged_kv=False,
                              arena_decode=False), False,
             ("prefill", "decode")),
    "spec_paged": ("qwen3-4b", dict(), True, ("verify_paged",)),
    "spec_arena": ("qwen3-4b", dict(paged_kv=False), True,
                   ("verify_arena",)),
    "ssm_paged": ("mamba2-2.7b", dict(), False,
                  ("packed_paged", "paged_decode")),
    "ssm_arena": ("mamba2-2.7b", dict(paged_kv=False), False,
                  ("packed_arena", "arena_decode")),
    # the windowed MoE stack: ring tables and rolling slots
    "swa_paged": ("mixtral-8x7b", dict(), False,
                  ("packed_paged", "paged_decode")),
    "swa_arena": ("mixtral-8x7b", dict(paged_kv=False), False,
                  ("packed_arena", "arena_decode")),
    # the hybrid stack: KV pages beside state pages, KV rows beside
    # state in one slot
    "hybrid_paged": ("jamba-v0.1-52b", dict(), False,
                     ("packed_paged", "paged_decode")),
    "hybrid_arena": ("jamba-v0.1-52b", dict(paged_kv=False), False,
                     ("packed_arena", "arena_decode")),
}


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_step_graphs_replay_bit_identical_to_eager(card, mode):
    """Each executor step kind through its step graph and through the
    eager step function on the same inputs (two engines on the card,
    one schedule): the same tokens, bit-identical logits and arena,
    pool and state contents (every row but the junk rows that pads write
    in an undefined order: park rows, the scratch slot or page), every
    kind replayed at least twice at one shape."""
    arch, opts, spec, kinds = GRAPH_MODES[mode]
    cfg = get_smoke(arch)
    if cfg.family != "ssm":
        cfg = cfg.replace(head_dim=128)
    params = _to(tr.init_params(cfg, seed=0, device="cpu"), card)
    rng = np.random.default_rng(5)
    # two turns in one token bucket (64) or grid shape (64, 4)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (9, 30, 17)]
    again = [rng.integers(1, cfg.vocab_size, n) for n in (20, 25, 12)]
    script = list(rng.integers(1, cfg.vocab_size, 40))
    outs, engines = [], []
    for eager in (False, True):
        e = Engine(cfg, params, EngineConfig(
            num_slots=4, max_len=256, chunk_tokens=32, measure=False,
            token_buckets=(16, 32, 64), **opts), device=card)
        if eager:
            _eager_steps(e)
        if spec:
            e.enable_spec(ScriptedDraft({s: script for s in range(3)},
                                        accept=0.5, vocab=cfg.vocab_size),
                          k=3)
        bucket = (64, 4) if opts.get("packed") is False else None
        r = e.prefill_batch([0, 1, 2], prompts, bucket=bucket)
        r2 = e.prefill_batch([0, 1, 2], again, bucket=bucket)
        toks = [r2[s] for s in range(3)]
        if spec:
            d = [e.spec_step([(s, toks[s]) for s in range(3)])
                 for _ in range(3)]
        else:
            d = e.decode_batch([0, 1, 2], toks, 3)
        torch.cuda.synchronize()
        outs.append((r, r2, d))
        engines.append(e)
    assert outs[0] == outs[1]
    graph_e, eager_e = engines
    for s in range(3):
        assert np.array_equal(graph_e.last_logits[s],
                              eager_e.last_logits[s]), s
    _assert_live_equal(graph_e, eager_e.arena.arena)
    replays = {}
    for ex in graph_e.executors:
        for key, g in ex.graphs.items():
            assert g.graph is not None
            replays[key[0]] = max(replays.get(key[0], 0), g.replays)
    assert all(replays.get(k, 0) >= 2 for k in kinds), replays


@pytest.mark.parametrize("mode", ["paged", "arena", "gathered", "grid",
                                  "ssm_paged", "ssm_arena", "swa_paged",
                                  "swa_arena", "hybrid_paged",
                                  "hybrid_arena"])
def test_parked_capture_leaves_live_state_unchanged(card, mode):
    """A step graph captured at a live miss — warm-up and capture on
    parked inputs — changes no live KV row and no live SSM state: every
    arena row but the park rows and the scratch slot or page is
    bit-unchanged."""
    from repro_torch.serving import graphs
    arch, opts, _, _ = GRAPH_MODES[mode]
    cfg = get_smoke(arch)
    if cfg.family != "ssm":
        cfg = cfg.replace(head_dim=128)
    params = _to(tr.init_params(cfg, seed=0, device="cpu"), card)
    e = Engine(cfg, params, EngineConfig(
        num_slots=4, max_len=128, chunk_tokens=32, measure=False,
        token_buckets=(16, 32, 64), decode_buckets=(1, 2, 4), **opts),
        device=card)
    rng = np.random.default_rng(6)
    bucket = (16, 2) if opts.get("packed") is False else None
    r = e.prefill_batch([0, 1], [rng.integers(1, cfg.vocab_size, n)
                                 for n in (7, 11)], bucket=bucket)
    e.decode_batch([0, 1], [r[0], r[1]], 2)
    torch.cuda.synchronize()
    before = [{k: v.clone() for k, v in leaves.items()}
              for leaves in e.arena.arena]
    shapes = sum(len(ex.graphs) for ex in e.executors)
    run = graphs.StepGraph.run
    graphs.StepGraph.run = lambda self, args, fill=None: self.outputs
    try:
        kinds = _capture_new_shapes(e)
    finally:
        graphs.StepGraph.run = run
    torch.cuda.synchronize()
    assert sum(len(ex.graphs) for ex in e.executors) == shapes + kinds
    _assert_live_equal(e, before)


def _capture_new_shapes(e) -> int:
    """Dispatch each step kind of ``e`` once at a shape it has not met
    (the largest token bucket and decode rung, a new grid shape), with
    zero inputs.  Returns the dispatches made."""
    z = lambda *shape: np.zeros(shape, np.int32)   # noqa: E731
    p, ar = e.params, e.arena
    px, dx = e.packed_executor, e.decode_executor
    n = 0
    if px is not None:
        t, b = px.token_buckets[-1], px.stream_rows
        if e._paged:
            pm = ar.max_pages_per_seq
            px.mixed_step_paged(p, z(t), z(t), z(t), z(t), z(b, pm),
                                z(b + 1), z(b), z(b), ar.arena, z(b), z(b))
            if e.capability.pure_attn:
                px.verify_step_paged(p, z(t), z(t), z(t), z(t), z(b, pm),
                                     z(b + 1), z(b), z(b), ar.arena,
                                     z(b, 4))
                n += 1
        elif e.ecfg.arena_prefill:
            px.mixed_step_arena(p, z(t), z(t), z(t), z(b), z(b + 1), z(b),
                                z(b), ar.arena, z(b))
            if e.capability.pure_attn:
                px.verify_step_arena(p, z(t), z(t), z(t), z(b), z(b + 1),
                                     z(b), z(b), ar.arena, z(b, 4))
                n += 1
        else:
            px.mixed_step(p, z(t), z(t), z(t), z(b + 1), z(b), z(b),
                          ar.batch(b), z(b))
        n += 1
    if dx is not None:
        m = dx.decode_buckets[-1]
        if e._paged:
            dx.decode_paged(p, z(m), z(m), z(m), z(m),
                            z(m, ar.max_pages_per_seq), z(m), ar.arena,
                            z(m))
        else:
            dx.decode(p, z(m), z(m), z(m), z(m), ar.arena)
        n += 1
    if not e._paged:
        caches = ar.batch(3)
        e.executor.prefill(p, z(3, 24), z(3, 24), caches, z(3))
        e.executor.decode(p, z(3, 1), z(3, 1), caches)
        n += 2
    return n


def _assert_live_equal(e, other):
    """``e``'s arena equals the arena tree ``other`` bit for bit on every
    live row: all but the park rows and the scratch slot or page, where
    pad rows write junk (their duplicate writes land in an undefined
    order)."""
    ar = e.arena
    for leaves, old in zip(ar.arena, other):
        for name, a in leaves.items():
            keep = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
            if ar.scratch is not None:
                keep[ar.scratch] = False
            a, o = a[:, keep], old[name][:, keep]
            if name in ("k", "v") and not e._paged:
                a, o = a[:, :, :-1], o[:, :, :-1]     # the park rows
            assert torch.equal(a, o), name


# ------------------------------------------------- windowed kernels

# mixtral-8x7b's window, a ring of ceil((4096 + 256) / 16) = 272 pages,
# rolling slots of 4352 rows; and a small odd window over a ring of
# ceil((100 + 16) / 16) = 8 pages and slots of 116 rows
WINDOWS = {4096: 256, 100: 16}


def _window_case(card, dtype, window, layout, seed, lens, hists, d=D,
                 hq=HQ, hkv=HKV):
    """A windowed launch's inputs: the stream of ``lens`` new rows at
    ``hists`` over ring pages or rolling slots, every unheld row NaN,
    and the plain version's copy with 1000 there."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=card).manual_seed(seed)
    depth = window + WINDOWS[window]
    kvl = [h + n for h, n in zip(hists, lens)]
    b = len(kvl)
    if layout == "ring":
        n_ring = -(-depth // PS)
        n_pages = b * n_ring + 1
        table = np.full((b, n_ring), n_pages - 1, np.int64)
        free = list(rng.permutation(n_pages - 1))
        for i, n in enumerate(kvl):
            need = min(-(-n // PS), n_ring)
            table[i, :need] = [free.pop() for _ in range(need)]
        rows = (table[:, None, :] * PS + np.arange(PS)[:, None]
                ).transpose(0, 2, 1).reshape(b, -1)        # ring order
        shape, index = (n_pages, PS, hkv, d), _i32(table, card)
    else:
        slots = rng.permutation(b + 1)[:b]
        rows = slots[:, None] * depth + np.arange(depth)[None]
        shape, index = (b + 1, depth, hkv, d), _i32(slots, card)
    held = np.zeros(int(np.prod(shape[:2])), bool)
    for i, n in enumerate(kvl):
        held[rows[i, :min(n, rows.shape[1])]] = True
    k = torch.randn(shape, generator=g, device=card)
    v = torch.randn(shape, generator=g, device=card)
    mask = torch.as_tensor(~held, device=card).reshape(shape[:2])
    kp, vp = k.clone(), v.clone()
    kp[mask], vp[mask] = float("nan"), float("nan")
    k[mask], v[mask] = 1000.0, 1000.0
    cu = np.concatenate([[0], np.cumsum(lens)])
    q = torch.randn((int(cu[-1]) + 5, hq, d), generator=g, device=card)
    seg = [_i32(x, card) for x in (cu, hists, kvl)]
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), k.to(dtype),
            v.to(dtype), index, seg)


WINDOW_STREAMS = {
    # lens, hists: kv before, at and far past the window and the depth,
    # rows straddling the wrap, a decode row
    4096: ([256, 5, 1, 256], [2744, 4340, 11999, 5744]),
    100: ([16, 5, 1, 3, 16], [84, 111, 231, 0, 216]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("layout", ["ring", "rolling"])
def test_windowed_kernels_match_plain(card, layout, window, dtype):
    """The windowed prefill and decode kernels of ``layout`` at
    mixtral-8x7b's heads against their plain versions; no unheld row is
    read (NaN there)."""
    _check_windowed(card, layout, window, dtype, D, HQ, HKV)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("layout", ["ring", "rolling"])
def test_windowed_kernels_at_head_widths(card, layout, d, dtype):
    """The same at stablelm's and phi-3's widths, 32 / 32 heads, over
    the small odd window's wrap edges."""
    _check_windowed(card, layout, 100, dtype, d, 32, 32)


def _check_windowed(card, layout, window, dtype, d, hq, hkv):
    lens, hists = WINDOW_STREAMS[window]
    q, kp, vp, k, v, index, seg = _window_case(card, dtype, window, layout,
                                               3, lens, hists, d, hq, hkv)
    if layout == "ring":
        pf, pplain = rp.ragged_prefill_paged, rp.ragged_prefill_paged_plain
        df, dplain = dec.decode_attn_paged, dec.decode_attn_paged_plain
    else:
        pf, pplain = rp.ragged_prefill_arena, rp.ragged_prefill_arena_plain
        df, dplain = dec.decode_attn_arena, dec.decode_attn_arena_plain
    out = pf(q, kp, vp, index, *seg, window=window)
    plain = lambda *a: pplain(*a, window=window)       # noqa: E731
    _assert_held(out, plain, q, k, v, index, *seg)
    lengths = seg[2]
    qd = q[:len(lens)].contiguous()
    out = df(qd, kp, vp, index, lengths, window=window)
    dplain_w = lambda *a: dplain(*a, window=window)    # noqa: E731
    _assert_held(out, dplain_w, qd, k, v, index, lengths)


@pytest.mark.parametrize("layout", ["ring", "rolling"])
def test_windowed_kernels_replay_in_a_cuda_graph(card, layout):
    """A windowed prefill and decode launch captured in a CUDA graph at
    one set of kv lengths and replayed at others (before the window,
    past it, past two depths): each replay equals an eager launch at the
    new lengths bit for bit — the split plan and the prefill grid read
    shapes only."""
    window = 4096
    lens, first = [256, 5, 1, 256], [2744, 4340, 11999, 5744]
    later = [[0, 4091, 8703, 300], [6000, 9, 4351, 12000]]
    q, kp, vp, _, _, index, seg = _window_case(
        card, torch.bfloat16, window, layout, 7, lens,
        [max(x) for x in zip(first, *later)])
    pf = rp.ragged_prefill_paged if layout == "ring" \
        else rp.ragged_prefill_arena
    df = dec.decode_attn_paged if layout == "ring" \
        else dec.decode_attn_arena
    kp, vp = kp.nan_to_num(0.0), vp.nan_to_num(0.0)
    cu, offs, kvl = seg
    offs.copy_(_i32(first, card))
    kvl.copy_(_i32([h + n for h, n in zip(first, lens)], card))
    qd = q[:len(lens)].contiguous()
    pf(q, kp, vp, index, cu, offs, kvl, window=window)  # build, warm up
    df(qd, kp, vp, index, kvl, window=window)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_p = pf(q, kp, vp, index, cu, offs, kvl, window=window)
        out_d = df(qd, kp, vp, index, kvl, window=window)
    for hists in later:
        offs.copy_(_i32(hists, card))
        kvl.copy_(_i32([h + n for h, n in zip(hists, lens)], card))
        graph.replay()
        want_p = pf(q, kp, vp, index, cu, offs, kvl, window=window)
        want_d = df(qd, kp, vp, index, kvl, window=window)
        torch.cuda.synchronize()
        assert torch.equal(out_p, want_p) and torch.equal(out_d, want_d)


@pytest.mark.parametrize("mode", [dict(), dict(paged_kv=False),
                                  dict(packed=False, paged_kv=False)],
                         ids=["swa_paged", "swa_slot_arena", "swa_dense"])
def test_window_engine_on_card_matches_engine_on_cpu(card, mode):
    """The windowed MoE engine (mixtral-8x7b smoke, head_dim 128, window
    32) through the CUDA kernels and through the plain versions, with
    sessions several windows deep: the same greedy tokens, logits within
    1e-4 (fp32)."""
    cfg = get_smoke("mixtral-8x7b").replace(head_dim=128)
    params = tr.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    ecfg = dict(num_slots=4, max_len=256, chunk_tokens=16, measure=False,
                **mode)
    engines = [Engine(cfg, params, EngineConfig(**ecfg), device="cpu"),
               Engine(cfg, on_card, EngineConfig(**ecfg), device=card)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (70, 9, 33)]
    outs = []
    for e in engines:
        r = {s: e.prefill_long(s, p) for s, p in enumerate(prompts)}
        d = e.decode_batch([0, 1, 2], [r[i] for i in range(3)], 40)
        r2 = e.prefill_batch([1], [prompts[1]])
        outs.append((r, d, r2))
    assert outs[0] == outs[1]
    for s in range(3):
        np.testing.assert_allclose(engines[1].last_logits[s],
                                   engines[0].last_logits[s], atol=1e-4,
                                   rtol=0)


# ------------------------------------------------- the capacity dispatch

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,k", [(16, 2), (128, 8)])
def test_moe_layer_replays_in_a_cuda_graph(card, dtype, e, k):
    """The capacity dispatch, which every MoE step of a config with more
    than 8 experts takes (jamba's 16 top 2, qwen3-moe's 128 top 8),
    captured in a CUDA graph: replays on fresh inputs give the eager
    call's output and aux loss bit for bit, dropped pairs included."""
    from repro_torch.models import moe
    gen = torch.Generator(device=card).manual_seed(e)
    d, f, t = 256, 384, 96

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card)
                * scale).to(dtype)

    p = {"router": randn(d, e, scale=d ** -0.5),
         "wg": randn(e, d, f, scale=d ** -0.5),
         "wi": randn(e, d, f, scale=d ** -0.5),
         "wo": randn(e, f, d, scale=f ** -0.5)}
    static = randn(1, t, d)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe.moe_layer(p, static, top_k=k)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, aux = moe.moe_layer(p, static, top_k=k)
        for _ in range(2):
            x = randn(1, t, d)
            want, aux_w = moe.moe_layer(p, x, top_k=k)
            static.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want) and torch.equal(aux, aux_w)


# ------------------------------------------------------ session handoff
def _handoff_engines(card, paged, eager=False):
    cfg = get_smoke("qwen3-4b").replace(head_dim=128)
    params = _to(tr.init_params(cfg, seed=3, device="cpu"), card)

    def make(eager_steps=False):
        e = Engine(cfg, params, EngineConfig(
            num_slots=4, max_len=256, chunk_tokens=32, measure=False,
            paged_kv=paged, page_size=16), device=card)
        if eager_steps:
            _eager_steps(e)
        return e
    return cfg, make


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_handoff_copies_no_byte_through_the_host(card, paged):
    """export_session -> import_session between two engines on the card
    runs no device-to-host copy (``torch.profiler``), counts 0 host
    bytes, and the destination decodes what the source decodes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg, make = _handoff_engines(card, paged)
    a, b = make(), make()
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, cfg.vocab_size, 45)     # a partial page
    first = a.prefill_batch([0], [prompt])[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b.import_session(0, a.export_session(0))
        torch.cuda.synchronize()
    events = prof.events()
    assert any(getattr(e, "device_type", None) == DeviceType.CUDA
               for e in events), "the profiler traced no device activity"
    d2h = [e.name for e in events if "DtoH" in e.name
           or e.name in ("aten::_local_scalar_dense", "aten::item")]
    assert not d2h, d2h
    assert b.stats()["handoff_host_bytes"] == 0
    assert b.history(0) == len(prompt)
    assert b.decode_batch([0], [first], 4) == a.decode_batch([0], [first], 4)
    np.testing.assert_allclose(b.last_logits[0], a.last_logits[0],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_imported_session_decodes_through_captured_graphs(card, paged):
    """The destination's decode graph is captured before the import (the
    import writes the arena in place, so the graph still reads it): the
    imported session's decode replays that graph and gives the eager
    engine's tokens and logits bit for bit."""
    cfg, make = _handoff_engines(card, paged)
    a, b, eager = make(), make(), make(eager_steps=True)
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, 37)
    other = rng.integers(1, cfg.vocab_size, 20)
    f5 = b.prefill_batch([5], [other])[5]
    b.decode_batch([5], [f5], 2)                 # captures the 1-row step
    b.close_session(5)
    dx = b.decode_executor
    graphs, replays = len(dx.graphs), dx.replays
    first = a.prefill_batch([0], [prompt])[0]
    b.import_session(0, a.export_session(0))
    got = b.decode_batch([0], [first], 3)
    fe = eager.prefill_batch([0], [prompt])[0]
    want = eager.decode_batch([0], [fe], 3)
    torch.cuda.synchronize()
    assert first == fe and got == want
    assert np.array_equal(b.last_logits[0], eager.last_logits[0])
    assert len(dx.graphs) == graphs and dx.replays == replays + 3


def test_promoted_prefix_decodes_through_captured_graphs(card):
    """The host spill tier on the card: a conversation's pages spill to
    the pinned host pool under pressure and are promoted back in place
    when it returns; the engine whose decode graph was captured before
    the spill decodes the returning session through that graph, giving
    the eager engine's tokens and logits bit for bit on the same
    schedule, and the promoted pages equal clones taken before the
    spill."""
    cfg = get_smoke("qwen3-4b").replace(head_dim=128)
    params = _to(tr.init_params(cfg, seed=3, device="cpu"), card)

    def make(eager_steps=False):
        e = Engine(cfg, params, EngineConfig(
            num_slots=2, max_len=128, chunk_tokens=32, measure=False,
            page_size=16, num_pages=8, host_pool_bytes=64 << 20),
            device=card)
        if eager_steps:
            _eager_steps(e)
        return e

    rng = np.random.default_rng(6)
    prompt = rng.integers(1, cfg.vocab_size, 40)      # 2 full pages
    filler = rng.integers(1, cfg.vocab_size, 120)     # the whole pool
    extra = rng.integers(1, cfg.vocab_size, 9)
    outs = []
    for e in (make(), make(eager_steps=True)):
        ar = e.arena
        assert ar.host_pinned_bytes > 0
        assert all(b.is_pinned() for bufs in ar._host_slots._bufs
                   for b in bufs.values())
        first = e.prefill_batch([0], [prompt])[0]
        toks = e.decode_batch([0], [first], 2)[0]
        snap = [[{n: a[:, p].clone() for n, a in leaves.items()}
                 for leaves in ar.arena] for p in ar.pages_of(0)[:2]]
        full = np.concatenate([prompt, [first] + toks[:-1], extra])
        e.close_session(0)
        dx = e.decode_executor
        graphs, replays = len(dx.graphs), dx.replays
        e.prefill_batch([1], [filler])
        e.close_session(1)
        assert ar.pages_spilled >= 2
        e.open_session(2)
        assert e.adopt_prefix(2, full) == 32 and ar.pages_promoted >= 2
        for want, p in zip(snap, ar.pages_of(2)[:2]):
            for wl, leaves in zip(want, ar.arena):
                for n, a in leaves.items():
                    assert torch.equal(wl[n], a[:, p])
        t2 = e.step_mixed([(2, full[32:])], []).tokens[2]
        got = e.decode_batch([2], [t2], 3)[2]
        torch.cuda.synchronize()
        ar.audit()
        outs.append((first, toks, t2, got, e.last_logits[2].copy(),
                     ar.pages_spilled, ar.pages_promoted))
        if not outs[1:]:
            # the decode replays the graph captured before the spill
            assert len(dx.graphs) == graphs and dx.replays == replays + 3
    (f0, d0, t0, g0, l0, *c0), (f1, d1, t1, g1, l1, *c1) = outs
    assert (f0, d0, t0, g0, c0) == (f1, d1, t1, g1, c1)
    assert np.array_equal(l0, l1)


def test_dead_engine_refuses_dispatch_on_card(card):
    cfg, make = _handoff_engines(card, True)
    e = make()
    first = e.prefill_batch([0], [np.arange(1, 9)])[0]
    e.mark_dead()
    for call in (lambda: e.prefill_batch([1], [np.arange(1, 5)]),
                 lambda: e.decode_batch([0], [first], 1),
                 lambda: e.export_session(0)):
        with pytest.raises(RuntimeError, match="dead"):
            call()


# ------------------------------------------- flash_attn's backward kernel

def _bwd_inputs(dev, dtype, b, lq, s, hq, hkv, d, offs, lens, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rand(b, lq, hq, d), rand(b, s, hkv, d), rand(b, s, hkv, d),
            rand(b, lq, hq, d), _i32(offs, dev), _i32(lens, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv,causal,window,offs,lens", [
    (128, 32, 8, True, None, [0, 7], [300, 190]),
    (64, 40, 8, True, 64, [0, 0], [257, 100]),
    (80, 16, 16, False, None, [0, 0], [300, 0]),      # a row with no key
    (96, 8, 1, True, None, [30, 0], [200, 120]),
])
def test_flash_attn_bwd_kernel_matches_plain(card, dtype, d, hq, hkv, causal,
                                             window, offs, lens):
    """dq, dk, dv of the backward kernels within the derived bound of
    their plain version (``flash_attn_bwd_error_bound``), from the
    forward kernel's output and log-sum-exp; the log-sum-exp equal to
    the plain one (-inf on a keyless row); two runs bit-identical."""
    from repro_torch.kernels.ref import (flash_attn_bwd_error_bound,
                                         ref_flash_attn_lse)
    q, k, v, do, o, ln = _bwd_inputs(card, dtype, 2, 190, 300, hq, hkv, d,
                                     offs, lens)
    kw = dict(causal=causal, window=window)
    out, lse = fl.flash_attn(q, k, v, o, ln, return_lse=True, **kw)
    want = ref_flash_attn_lse(q.float(), k.float(), o, ln, **kw)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - want[fin]).abs().max().item() <= 1e-4
    got = fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln, **kw)
    again = fl.flash_attn_bwd(q, k, v, out, lse, do, o, ln, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    refs, bounds = flash_attn_bwd_error_bound(q, k, v, out, lse, do, o, ln,
                                              **kw)
    for x, r, bd in zip(got, refs, bounds):
        assert ((x.float() - r).abs() <= bd).all()


def test_flash_attn_serving_launch_unchanged_by_lse(card):
    """The serving launch (no log-sum-exp) gives the same bits as the
    training launch's output."""
    q, k, v, _, o, ln = _bwd_inputs(card, torch.bfloat16, 2, 256, 300, HQ,
                                    HKV, D, [0, 40], [256, 296])
    n0, l0 = fl.flash_attn.launches, fl.flash_attn.lse.launches
    plain = fl.flash_attn(q, k, v, o, ln)
    out, _ = fl.flash_attn(q, k, v, o, ln, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, out)
    assert fl.flash_attn.launches == n0 + 2
    assert fl.flash_attn.lse.launches == l0 + 1


def test_flash_attn_fn_inside_checkpoint(card):
    """``ops.mha`` under grad through ``FlashAttnFn`` inside
    ``torch.utils.checkpoint`` (the training forward's remat): the grads
    equal those without the checkpoint bit for bit, and the backward
    kernels ran once per backward."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import ops
    q0, k0, v0, do, _, _ = _bwd_inputs(card, torch.bfloat16, 2, 128, 128,
                                       HQ, HKV, D, [0, 0], [128, 128])
    grads = []
    for remat in (False, True):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        n0 = fl.flash_attn_bwd.launches
        fn = (lambda *a: checkpoint(ops.mha, *a, use_reentrant=False)) \
            if remat else ops.mha
        fn(q, k, v).backward(do)
        torch.cuda.synchronize()
        assert fl.flash_attn_bwd.launches == n0 + 1
        grads.append((q.grad, k.grad, v.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_train_step_on_card_repeats_bit_for_bit(card):
    """Two runs of the smoke config's train step (head_dim 64, bf16, 2
    microbatches, remat) from one seed give the same loss and params bit
    for bit: no float atomics on the path."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step
    cfg = get_smoke("qwen3-4b").replace(head_dim=64, dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 2, 32))}
    runs = []
    for _ in range(2):
        params = tr.init_params(cfg, seed=3, device=card)
        state = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                               accum=2)
        for _ in range(2):
            params, state, m = step(params, state, batch)
        runs.append((float(m["loss"]), params))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    from repro_torch.optim.adamw import tree_leaves
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p0), tree_leaves(p1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,nh,hd,g,ds,chunk", [
    (2, 300, 80, 64, 1, 128, 128),      # mamba2's heads, off the chunk grid
    (1, 257, 128, 64, 8, 128, 128),     # jamba's 8 groups of 16 heads
    (2, 37, 16, 8, 2, 16, 8),           # the smoke configs' SSD widths
    (2, 150, 6, 40, 2, 20, 48),         # widths off every tile
    (1, 64, 4, 24, 4, 200, 32),         # DS past 128, per-head B / C
])
def test_ssd_scan_bwd_kernel_matches_plain(card, dtype, b, l, nh, hd, g, ds,
                                           chunk):
    """The training form's chunk states against the plain recurrence, its
    y and final state bit-identical to the serving launch's; the six
    gradients of ``ssd_scan_bwd`` within ``ssd_bwd_error_bound``, with
    and without the final state's gradient; two runs bit-identical."""
    from repro_torch.kernels.ref import (SSD_REL_TOL, ref_ssd_scan,
                                         ssd_bwd_error_bound)
    args = _ssd_args(card, b, l, g, dtype, seed=l + nh, nh=nh, hd=hd, ds=ds)
    n0, s0 = ssd.ssd_scan.launches, ssd.ssd_scan.states.launches
    y, st, states = ssd.ssd_scan(*args, chunk=chunk, return_states=True)
    y2, st2 = ssd.ssd_scan(*args, chunk=chunk)
    assert ssd.ssd_scan.launches == n0 + 2
    assert ssd.ssd_scan.states.launches == s0 + 1
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _, _, sref = ref_ssd_scan(*(t.float() for t in args), chunk=chunk,
                              return_states=True)
    assert bool(((states - sref).abs()
                 <= SSD_REL_TOL * sref.abs().amax((2, 3, 4), True)).all())
    gen = torch.Generator(device=card)
    gen.manual_seed(b * l)
    dy = torch.randn(y.shape, generator=gen, device=card).to(dtype)
    for dst in (0.1 * torch.randn(st.shape, generator=gen, device=card),
                None):
        n = ssd.ssd_scan_bwd.launches
        got = ssd.ssd_scan_bwd(*args[:5], states, dy, dst, chunk=chunk)
        again = ssd.ssd_scan_bwd(*args[:5], states, dy, dst, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd.ssd_scan_bwd.launches == n + 2
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        refs, bounds = ssd_bwd_error_bound(*args, dy, dst, states, chunk)
        for x, r, bd in zip(got, refs, bounds):
            assert x.shape == r.shape
            assert bool(((x.float() - r).abs() <= bd).all())


def test_ssd_grouped_differentiates_on_card(card):
    """``ops.ssd_grouped`` under grad on the card goes through
    ``SSDScanFn``: one training-form launch and one backward launch, and
    every input's gradient equal to autograd of the plain version on the
    CPU (fp32; atol 1e-5 x the leaf's largest |grad| above 1, rtol
    1e-4); inside ``torch.utils.checkpoint`` (training's remat) the
    same gradients bit for bit."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import ops
    base = _ssd_args(card, 2, 200, 2, torch.float32, seed=9, nh=8, hd=64,
                     ds=32)
    gen = torch.Generator(device=card)
    gen.manual_seed(10)
    dy = torch.randn(base[0].shape, generator=gen, device=card)
    dst = torch.randn(base[5].shape, generator=gen, device=card)

    def grads(dev, remat=False):
        leaves = [t.detach().to(dev).contiguous().requires_grad_()
                  for t in base]
        fn = (lambda *a: checkpoint(ops.ssd_grouped, *a, chunk=64,
                                    use_reentrant=False)) if remat else \
            (lambda *a: ops.ssd_grouped(*a, chunk=64))
        y, st = fn(*leaves)
        ((y * dy.to(dev)).sum() + (st * dst.to(dev)).sum()).backward()
        return [t.grad for t in leaves]

    n = [ssd.ssd_scan.states.launches, ssd.ssd_scan_bwd.launches]
    on_card = grads(card)
    torch.cuda.synchronize()
    assert [ssd.ssd_scan.states.launches - n[0],
            ssd.ssd_scan_bwd.launches - n[1]] == [1, 1]
    for g, w in zip(on_card, grads("cpu")):
        atol = 1e-5 * max(1.0, w.abs().max().item())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=atol)
    assert all(torch.equal(a, b) for a, b in zip(on_card,
                                                  grads(card, remat=True)))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_ssm_train_step_on_card_repeats_bit_for_bit(card, arch):
    """Two runs of the SSM and hybrid smoke configs' train step (bf16, 2
    microbatches, remat; the SSD layers through the training form and
    ``ssd_scan_bwd``) from one seed give the same loss and params bit
    for bit: no float atomics on the path."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training.train_step import make_train_step
    cfg = get_smoke(arch).replace(head_dim=64, dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 2, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 2, 32))}
    runs = []
    for _ in range(2):
        n = ssd.ssd_scan_bwd.launches
        params = tr.init_params(cfg, seed=3, device=card)
        state = adamw_init(params)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                               accum=2)
        for _ in range(2):
            params, state, m = step(params, state, batch)
        ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
        assert ssd.ssd_scan_bwd.launches - n == ssm * 2 * 2
        runs.append((float(m["loss"]), params))
    (l0, p0), (l1, p1) = runs
    assert np.isfinite(l0) and l0 == l1
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p0), tree_leaves(p1)))


# ------------------------------------------------------------- sharding


def test_sharded_steps_on_a_world_size_1_nccl_mesh(card):
    """The smoke config (head_dim 64) with params and caches as DTensors
    placed by ``SERVE_RULES`` on a real NCCL mesh of one card: a prefill
    (``dense_cache_write``) and two decode steps give the plain tensors'
    logits and greedy tokens, through the kernels on the local shards
    (``flash_attn`` and ``decode_attn`` counts rise)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = make_host_mesh()
        cfg = get_smoke("qwen3-4b").replace(head_dim=64)
        params = tr.init_params(cfg, seed=0, device=card)
        b, l = 2, 24
        tok = torch.randint(0, cfg.vocab_size, (b, l + 2), device=card,
                            generator=torch.Generator(card).manual_seed(1))
        pos = torch.arange(l + 2, device=card)[None].expand(b, l + 2)

        def steps(p, caches):
            with torch.no_grad():
                out = [tr.forward(p, cfg, tokens=tok[:, :l],
                                  positions=pos[:, :l], caches=caches,
                                  logits_slice="last",
                                  dense_cache_write=True)]
                for i in range(l, l + 2):
                    out.append(tr.forward(p, cfg, tokens=tok[:, i:i + 1],
                                          positions=pos[:, i:i + 1],
                                          caches=caches,
                                          logits_slice="last"))
            return out

        want = steps(params, tr.init_cache(cfg, b, l + 4, device=card))
        rules = sh.ShardingRules(mesh, dict(sh.SERVE_RULES))
        before = (ops.LAUNCHERS["flash_attn"].launches,
                  ops.LAUNCHERS["decode_attn"].launches)
        with sh.use_rules(rules):
            dp = sh.shard_tree(params, tr.param_axes(cfg), rules)
            dc = sh.shard_tree(tr.init_cache(cfg, b, l + 4, device=card),
                               tr.cache_logical_axes(cfg), rules)
            got = [x.to_local() for x in steps(dp, dc)]
        assert ops.LAUNCHERS["flash_attn"].launches > before[0]
        assert ops.LAUNCHERS["decode_attn"].launches > before[1]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
            assert torch.equal(g.argmax(-1), w.argmax(-1))
    finally:
        dist.destroy_process_group()


def _alloc(fn, device):
    """The most bytes ``fn(device, args)``'s allocations hold at once
    (the dry run's watch: outputs and workspace), its inputs made by
    ``fn(device, None)`` before the watch."""
    from repro_torch.launch.dryrun import Watch
    args = fn(device, None)
    w = Watch()
    with w:
        fn(device, args)
    return w.peak


def _t(device, *shape, dtype=torch.bfloat16, fill=None):
    if fill is not None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    if device.type == "meta" or not dtype.is_floating_point:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.randn(shape, dtype=dtype, device=device) * 0.1


def _meta_case(name):
    from repro_torch.kernels import ops
    b, lq, s, hq, hkv, d = 2, 64, 512, 32, 8, 128
    i32 = torch.int32

    def case(dev, args):
        if args is None:
            if name in ("mha", "flash_fn"):
                return (_t(dev, b, lq, hq, d), _t(dev, b, s, hkv, d),
                        _t(dev, b, s, hkv, d), _t(dev, b, dtype=i32),
                        _t(dev, b, dtype=i32, fill=s))
            if name.startswith("decode"):
                pool = _t(dev, 16, 64, hkv, d)
                return (_t(dev, b, hq, d), _t(dev, b, s, hkv, d), pool,
                        _t(dev, b, 8, dtype=i32),
                        _t(dev, b, dtype=i32, fill=300),
                        _t(dev, b, dtype=i32))
            if name.startswith("ragged"):
                pool = _t(dev, 16, 64, hkv, d)
                cu = torch.tensor([0, 40, 96], dtype=i32,
                                  device=dev if dev.type != "meta" else "cpu"
                                  ).to(dev)
                return (_t(dev, 96, hq, d), _t(dev, b, s, hkv, d), pool,
                        _t(dev, b, 8, dtype=i32), cu,
                        _t(dev, b, dtype=i32), _t(dev, b, dtype=i32,
                                                  fill=100),
                        _t(dev, b, dtype=i32))
            if name == "fused_sample":
                r = 8
                return (_t(dev, r, 151936, dtype=torch.float32),
                        _t(dev, r, dtype=torch.float32, fill=1.0),
                        _t(dev, r, dtype=i32, fill=50),
                        _t(dev, r, dtype=torch.float32, fill=0.9),
                        _t(dev, r, ops.MAX_BIAS, dtype=i32, fill=-1),
                        _t(dev, r, ops.MAX_BIAS, dtype=torch.float32,
                           fill=0.0),
                        _t(dev, r, dtype=torch.float32, fill=0.5),
                        _t(dev, r, dtype=i32, fill=-1))
            x = _t(dev, b, 256, 16, 64, dtype=torch.float32)
            dt = _t(dev, b, 256, 16, dtype=torch.float32, fill=0.01)
            a = _t(dev, 16, dtype=torch.float32, fill=-1.0)
            bc = _t(dev, b, 256, 1, 128, dtype=torch.float32)
            return (x, dt, a, bc, bc.clone(),
                    _t(dev, b, 16, 64, 128, dtype=torch.float32))
        if name == "mha":
            ops.mha(*args)
        elif name == "decode":
            ops.decode(args[0], args[1], args[1], args[4])
        elif name == "decode_arena":
            ops.decode_arena(args[0], args[1], args[1], args[5], args[4])
        elif name == "decode_paged":
            ops.decode_paged(args[0], args[2], args[2], args[3], args[4])
        elif name == "ragged_mha":
            ops.ragged_mha(args[0], args[1], args[1], *args[4:7])
        elif name == "ragged_mha_arena":
            ops.ragged_mha_arena(args[0], args[1], args[1], args[7],
                                 *args[4:7])
        elif name == "ragged_mha_paged":
            ops.ragged_mha_paged(args[0], args[2], args[2], args[3],
                                 *args[4:7])
        elif name == "fused_sample":
            ops.fused_sample(*args)
        elif name == "ssd_grouped":
            ops.ssd_grouped(*args)
        elif name == "flash_fn":
            q = args[0].detach().requires_grad_()
            fl.FlashAttnFn.apply(q, *args[1:], True, None).sum().backward()
        elif name == "ssd_fn":
            x = args[0].detach().requires_grad_()
            y, _ = ssd.SSDScanFn.apply(x, *args[1:], 128)
            y.sum().backward()
    return case


@pytest.mark.parametrize("name", [
    "mha", "decode", "decode_arena", "decode_paged", "ragged_mha",
    "ragged_mha_arena", "ragged_mha_paged", "fused_sample", "ssd_grouped",
    "flash_fn", "ssd_fn"])
def test_meta_branches_allocate_what_the_launchers_do(card, name):
    """Each of the nine dispatchers and the two training forms (forward
    and backward) on meta tensors allocates, by shape, the bytes its CUDA
    launchers allocate on the card at the same shapes: outputs and
    workspace (the decode split plan at this card's SM count, which the
    meta branch takes as an H100 SXM's 132)."""
    from repro_torch.kernels.decode_attn import H100_SMS, _sm_count
    assert _sm_count(card.index or 0) == H100_SMS
    case = _meta_case(name)
    assert _alloc(case, torch.device("meta")) == _alloc(case, card)
