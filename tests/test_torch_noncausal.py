"""The non-causal form (``causal=False``) of the three ragged prefill
kernels: the port's plain versions against the JAX package's Pallas
kernels in interpret mode (as its own suite runs them) and its oracles.

Non-causal, every row of a segment attends every held key of its row
below the segment's kv length, not only those up to its own position.
The cases put the difference in view: ``q_offsets > 0`` and kv lengths
past the segment's rows (keys after every query), GQA at rep 1 and 4,
a keyless segment and bucket-tail rows (both exactly 0), the paged
layout over a fragmented, shared table and the slot arena, and the
windowed forms (ring pages, rolling slots), where a row attends every
held key above its position - window.  The CUDA kernels take the same
flag (``csrc/ragged_prefill.cuh``); ``chip_smoke.py`` holds them to
these plain versions on the card.

Tolerance: atol 1e-5 in fp32 — both sides compute the same softmax in
fp32 and differ only in summation order.  The JAX oracle averages junk
over rows with no valid key where the kernels write 0, so the keyless
cases are held against the Pallas kernels only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ragged_prefill import ragged_prefill_attn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ragged_prefill as trp  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
D, PS = 16, 4

# lens, q_offsets, keys past the rows, tail rows, keyless segment
CASES = {
    # tests/test_ragged_prefill.py::test_ragged_noncausal's stream
    "reference": ([6, 14], [0, 0], [0, 0], 0, None),
    "offsets_and_future_keys": ([5, 17, 9], [12, 0, 26], [7, 3, 5], 3,
                                None),
    "decode_rows": ([1, 1, 6, 1], [14, 3, 0, 27], [2, 9, 5, 0], 1, None),
    "keyless_segment": ([4, 3, 2], [0, 2, 5], [6, 0, 4], 2, 1),
}
GROUPS = [(4, 4), (8, 2)]


def _case(name, hq, hkv, s, seed):
    lens, offs, extra, tail, keyless = CASES[name]
    kvl = [o + n + e for o, n, e in zip(offs, lens, extra)]
    if keyless is not None:
        kvl[keyless] = 0
    assert max(kvl) <= s
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((int(cu[-1]) + tail, hq, D)).astype(np.float32)
    return (q, cu, np.asarray(offs, np.int32), np.asarray(kvl, np.int32),
            keyless is None, rng)


def _pallas(fn, *args, **kw):
    try:
        jops.set_backend("pallas")
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))
    finally:
        jops.set_backend(None)


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _check_zero_rows(got, cu, kvl):
    assert (got[cu[-1]:] == 0).all(), "bucket tail must be exactly 0"
    for b in np.flatnonzero(kvl == 0):
        assert (got[cu[b]:cu[b + 1]] == 0).all(), "keyless rows must be 0"


def _differs_from_causal(got, causal_out, cu):
    """The case really tests the form: some row sees keys past itself."""
    assert not np.allclose(got[:cu[-1]], causal_out[:cu[-1]], atol=1e-3)


def test_reference_case_matches_the_reference_test():
    """``test_ragged_noncausal``'s own inputs (4 / 4 heads, S = 32): the
    plain version equals the Pallas kernel at the reference test's
    blocking and the dense oracle per segment."""
    rng = np.random.default_rng(5)
    lens, hq, hkv, s = [6, 14], 4, 4, 32
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    q = rng.standard_normal((20, hq, D)).astype(np.float32)
    k = rng.standard_normal((2, s, hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, D)).astype(np.float32)
    off = np.zeros(2, np.int32)
    kvl = np.asarray(lens, np.int32)
    got = tops.ragged_mha(*_t([q, k, v, cu, off, kvl]), causal=False).numpy()
    pallas = np.asarray(ragged_prefill_attn(
        *(jnp.asarray(a) for a in (q, k, v, cu, off, kvl)), causal=False,
        block_q=8, block_k=16, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    for i in range(2):
        dense = np.asarray(jref.ref_flash_attn(
            jnp.asarray(q[cu[i]:cu[i + 1]][None]), jnp.asarray(k[i:i + 1]),
            jnp.asarray(v[i:i + 1]), q_offsets=jnp.asarray(off[i:i + 1]),
            kv_lengths=jnp.asarray(kvl[i:i + 1]), causal=False))[0]
        np.testing.assert_allclose(got[cu[i]:cu[i + 1]], dense, **TOL)


@pytest.mark.parametrize("hq,hkv", GROUPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_gathered_noncausal_matches_jax(name, hq, hkv):
    s = 48
    q, cu, off, kvl, ref_ok, rng = _case(name, hq, hkv, s, seed=1)
    b = len(off)
    k = rng.standard_normal((b, s, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, D)).astype(np.float32)
    args = (q, k, v, cu, off, kvl)
    got = tops.ragged_mha(*_t(args), causal=False).numpy()
    np.testing.assert_allclose(
        got, _pallas(jops.ragged_mha, *args, causal=False), **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_ragged_prefill(
            *(jnp.asarray(a) for a in args), causal=False))
        np.testing.assert_allclose(got, want, **TOL)
    _check_zero_rows(got, cu, kvl)
    _differs_from_causal(got, tops.ragged_mha(*_t(args)).numpy(), cu)


def _page_table(rng, kvl, n_pages, p_max, share=True):
    """Each segment on ceil(kv_len / ps) distinct random pages, segment 1
    sharing segment 0's first page; unused entries on page 0."""
    table = np.zeros((len(kvl), p_max), np.int32)
    free = list(rng.permutation(n_pages))
    for i, n in enumerate(kvl):
        need = -(-int(n) // PS)
        table[i, :need] = [free.pop() for _ in range(need)]
    if share and kvl[0] > 0 and kvl[1] > 0:
        table[1, 0] = table[0, 0]
    return table


@pytest.mark.parametrize("hq,hkv", GROUPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_noncausal_matches_jax(name, hq, hkv):
    p_max, n_pages = 12, 60
    q, cu, off, kvl, ref_ok, rng = _case(name, hq, hkv, p_max * PS, seed=2)
    table = _page_table(rng, kvl, n_pages, p_max)
    k = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
    args = (q, k, v, table, cu, off, kvl)
    got = tops.ragged_mha_paged(*_t(args), causal=False).numpy()
    np.testing.assert_allclose(
        got, _pallas(jops.ragged_mha_paged, *args, causal=False), **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_ragged_prefill_paged(
            *(jnp.asarray(a) for a in args), causal=False))
        np.testing.assert_allclose(got, want, **TOL)
    _check_zero_rows(got, cu, kvl)
    _differs_from_causal(got, tops.ragged_mha_paged(*_t(args)).numpy(), cu)


@pytest.mark.parametrize("hq,hkv", GROUPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_arena_noncausal_matches_jax(name, hq, hkv):
    s_max, n_slots = 56, 6
    q, cu, off, kvl, ref_ok, rng = _case(name, hq, hkv, s_max, seed=3)
    slot_map = rng.permutation(n_slots)[:len(off)].astype(np.int32)
    k = rng.standard_normal((n_slots, s_max, hkv, D)).astype(np.float32)
    v = rng.standard_normal((n_slots, s_max, hkv, D)).astype(np.float32)
    args = (q, k, v, slot_map, cu, off, kvl)
    got = tops.ragged_mha_arena(*_t(args), causal=False).numpy()
    np.testing.assert_allclose(
        got, _pallas(jops.ragged_mha_arena, *args, causal=False), **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_ragged_prefill_arena(
            *(jnp.asarray(a) for a in args), causal=False))
        np.testing.assert_allclose(got, want, **TOL)
    _check_zero_rows(got, cu, kvl)
    _differs_from_causal(got, tops.ragged_mha_arena(*_t(args)).numpy(), cu)


@pytest.mark.parametrize("layout", ["ring_pages", "rolling_slots"])
@pytest.mark.parametrize("name", ["offsets_and_future_keys", "decode_rows"])
def test_windowed_noncausal_matches_jax(name, layout):
    """``window=`` with ``causal=False``: the reference applies the window
    as a lower edge only (``_arena_kernel``'s mask) and refuses nothing;
    the plain versions do the same over ring page tables (positions past
    the ring's depth wrap) and rolling slots."""
    hq, hkv, window = 8, 2, 9
    depth = 24                       # < the longest kv length: it wraps
    q, cu, off, kvl, _, rng = _case(name, hq, hkv, 64, seed=4)
    assert kvl.max() > depth
    if layout == "ring_pages":
        p_max, n_pages = depth // PS, 40
        table = np.stack([rng.permutation(n_pages)[:p_max]
                          for _ in kvl]).astype(np.int32)
        k = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
        v = rng.standard_normal((n_pages, PS, hkv, D)).astype(np.float32)
        args = (q, k, v, table, cu, off, kvl)
        tcall, jcall = tops.ragged_mha_paged, jops.ragged_mha_paged
    else:
        n_slots = 6
        slot_map = rng.permutation(n_slots)[:len(off)].astype(np.int32)
        k = rng.standard_normal((n_slots, depth, hkv, D)).astype(np.float32)
        v = rng.standard_normal((n_slots, depth, hkv, D)).astype(np.float32)
        args = (q, k, v, slot_map, cu, off, kvl)
        tcall, jcall = tops.ragged_mha_arena, jops.ragged_mha_arena
    got = tcall(*_t(args), causal=False, window=window).numpy()
    np.testing.assert_allclose(
        got, _pallas(jcall, *args, causal=False, window=window), **TOL)
    _differs_from_causal(got, tcall(*_t(args), window=window).numpy(), cu)


def test_launchers_count_noncausal_launches_apart():
    """Each ragged launcher has a non-causal counter, listed in
    ``ops.LAUNCHERS`` as ``<kernel>@nc`` beside the kernel's own."""
    for fn in (trp.ragged_prefill_paged, trp.ragged_prefill_arena,
               trp.ragged_prefill_attn):
        assert tops.LAUNCHERS[f"{fn.__name__}@nc"] is fn.noncausal
        assert isinstance(fn.noncausal.launches, int)
    assert "_refuse" not in vars(trp)


@pytest.mark.parametrize("call", [trp.ragged_prefill_paged,
                                  trp.ragged_prefill_arena,
                                  trp.ragged_prefill_attn])
def test_launchers_take_causal_false_and_refuse_only_the_cpu(call):
    """The launchers no longer refuse ``causal=False``: on CPU tensors
    they raise only for the device, before any launch."""
    q = torch.zeros((4, 4, 64))
    k = torch.zeros((4, 8, 4, 64))
    i32 = torch.zeros((4,), dtype=torch.int32)
    idx = ([torch.zeros((4, 2), dtype=torch.int32)]
           if call is trp.ragged_prefill_paged else
           [i32] if call is trp.ragged_prefill_arena else [])
    seg = [torch.arange(5, dtype=torch.int32), i32, i32]
    n0 = call.launches
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor"):
        call(q, k, k, *idx, *seg, causal=False)
    assert call.launches == n0
