"""Slot-arena attention kernels of the PyTorch port: the plain PyTorch
versions of ``ragged_prefill_arena``, ``ragged_prefill_attn`` and
``decode_attn_arena`` against the Pallas kernels in interpret mode and
the JAX oracles (``repro.kernels.ref``), on the layouts the slot engine
gives them: pad segments (``cu[i] == cu[i+1]``, kv length 0, slot map
naming a live slot), bucket-tail rows past cu_seqlens[-1], decode-ladder
pad rows (length 1 on the first row's slot), keyless rows, rows at and
past each kv length (the park row S_max - 1 included) poisoned, and
S_max of 64, 192 and 200 (not a multiple of any key tile); plus the
device dispatch and the kernel build signatures.

Tolerance: atol 1e-5 in fp32 — both sides compute the same softmax in
fp32 and differ only in summation order.  The JAX oracles average junk
over rows with no valid key where the kernels write 0, so those layouts
are held against the Pallas kernels only.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attn as tdec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ragged_prefill as trp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
HQ, HKV, D, SLOTS = 4, 2, 16, 6
POISON = 50.0

PREFILL = {
    # S_max, lens, hists, tail rows, pad segments, keyless segment
    "pad_segments_s64": (64, [5, 3, 1], [6, 0, 57], 3, 2, None),
    "tail_rows_s192": (192, [37, 1, 12], [120, 188, 0], 9, 1, None),
    "keyless_s200": (200, [4, 7, 2], [0, 150, 5], 2, 0, 1),
    "decode_rows_s200": (200, [1, 1, 6, 1], [14, 196, 0, 70], 1, 3, None),
}
DECODE = {
    # S_max, live lengths, ladder pad rows
    "pad_rows_s64": (64, [11, 7, 62], 5),
    "zero_length_s192": (192, [0, 190, 33, 0], 4),
    "long_rows_s200": (200, [198, 1, 129], 0),
}


def _arena(seed, s_max, live):
    """(SLOTS, s_max, HKV, D) K/V arenas whose rows at and past each
    live slot's kv length — the park row included — and every row of
    the other slots hold POISON."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((SLOTS, s_max, HKV, D)).astype(np.float32)
    v = rng.standard_normal((SLOTS, s_max, HKV, D)).astype(np.float32)
    valid = np.zeros((SLOTS, s_max), bool)
    for slot, n in live.items():
        valid[slot, :n] = True
    k[~valid] = POISON
    v[~valid] = -POISON
    return k, v


def _prefill_inputs(name, seed=1):
    s_max, lens, hists, tail, n_pad, keyless = PREFILL[name]
    kvl = [h + l for h, l in zip(hists, lens)]
    if keyless is not None:
        kvl[keyless] = 0
    rng = np.random.default_rng(seed)
    slots = [int(s) for s in rng.permutation(SLOTS)[:len(lens)]]
    total = sum(lens)
    cu = np.asarray([0] + list(np.cumsum(lens)) + [total] * n_pad, np.int32)
    slot_map = np.asarray(slots + [slots[0]] * n_pad, np.int32)
    q = rng.standard_normal((total + tail, HQ, D)).astype(np.float32)
    k, v = _arena(seed + 1, s_max, dict(zip(slots, kvl)))
    return (q, k, v, slot_map, cu, np.asarray(hists + [0] * n_pad, np.int32),
            np.asarray(kvl + [0] * n_pad, np.int32)), keyless is None


def _decode_inputs(name, seed=3):
    s_max, lengths, n_pad = DECODE[name]
    rng = np.random.default_rng(seed)
    slots = [int(s) for s in rng.permutation(SLOTS)[:len(lengths)]]
    k, v = _arena(seed + 1, s_max, dict(zip(slots, lengths)))
    slot_map = np.asarray(slots + [slots[0]] * n_pad, np.int32)
    lens = np.asarray(lengths + [1] * n_pad, np.int32)
    q = rng.standard_normal((len(lens), HQ, D)).astype(np.float32)
    return (q, k, v, slot_map, lens), min(lengths) > 0


def _pallas(fn, *args):
    try:
        jops.set_backend("pallas")
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))
    finally:
        jops.set_backend(None)


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("name", sorted(PREFILL))
def test_ragged_prefill_arena_plain_matches_jax(name):
    args, ref_ok = _prefill_inputs(name)
    got = tref.ref_ragged_prefill_arena(*_t(args)).numpy()
    np.testing.assert_allclose(got, _pallas(jops.ragged_mha_arena, *args),
                               **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_ragged_prefill_arena(
            *(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, **TOL)
    cu = args[4]
    assert (got[cu[-1]:] == 0).all(), "bucket tail must be exactly 0"
    assert np.isfinite(got).all() and np.abs(got).max() < POISON / 5


@pytest.mark.parametrize("name", sorted(PREFILL))
def test_ragged_prefill_attn_plain_matches_jax(name):
    """The gathered baseline's caches: each stream row's slot copied
    out, segment b reading row b (pad segments a copy of slot 0)."""
    (q, k, v, slot_map, cu, off, kvl), ref_ok = _prefill_inputs(name)
    args = (q, k[slot_map], v[slot_map], cu, off, kvl)
    got = tref.ref_ragged_prefill(*_t(args)).numpy()
    np.testing.assert_allclose(got, _pallas(jops.ragged_mha, *args), **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_ragged_prefill(
            *(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, **TOL)
    assert (got[cu[-1]:] == 0).all(), "bucket tail must be exactly 0"


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_attn_arena_plain_matches_jax(name):
    args, ref_ok = _decode_inputs(name)
    got = tref.ref_decode_attn_arena(*_t(args)).numpy()
    np.testing.assert_allclose(got, _pallas(jops.decode_arena, *args),
                               **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_decode_attn_arena(
            *(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, **TOL)
    lengths = args[-1]
    assert (got[lengths == 0] == 0).all(), "lengths 0 must give 0"


@pytest.mark.parametrize("fn", ["prefill_arena", "prefill_attn", "decode"])
def test_poisoned_rows_are_never_attended(fn):
    """Rows at and past each kv length (the park row included) do not
    move the output: another poison gives the same bits."""
    if fn == "decode":
        args, _ = _decode_inputs("pad_rows_s64")
        call = tref.ref_decode_attn_arena
    else:
        args, _ = _prefill_inputs("tail_rows_s192")
        call = tref.ref_ragged_prefill_arena
    if fn == "prefill_attn":
        q, k, v, sm, cu, off, kvl = args
        args = (q, k[sm], v[sm], cu, off, kvl)
        call = tref.ref_ragged_prefill
    got = call(*_t(args)).numpy()
    k, v = args[1], args[2]
    k2, v2 = np.where(np.abs(k) == POISON, 7.0, k), \
        np.where(np.abs(v) == POISON, -7.0, v)
    other = call(*_t((args[0], k2, v2) + tuple(args[3:]))).numpy()
    assert np.array_equal(got, other)


def test_cpu_dispatch_takes_the_plain_version():
    """ops on CPU tensors run the plain version and launch nothing; the
    kernel launchers refuse CPU tensors instead of falling back."""
    pargs = _t(_prefill_inputs("pad_segments_s64")[0])
    q, k, v, sm, cu, off, kvl = pargs
    gargs = [q, k[sm.long()], v[sm.long()], cu, off, kvl]
    dargs = _t(_decode_inputs("pad_rows_s64")[0])
    counts = (trp.ragged_prefill_arena.launches,
              trp.ragged_prefill_attn.launches,
              tdec.decode_attn_arena.launches)
    assert torch.equal(tops.ragged_mha_arena(*pargs),
                       trp.ragged_prefill_arena_plain(*pargs))
    assert torch.equal(tops.ragged_mha(*gargs),
                       trp.ragged_prefill_attn_plain(*gargs))
    assert torch.equal(tops.decode_arena(*dargs),
                       tdec.decode_attn_arena_plain(*dargs))
    assert (trp.ragged_prefill_arena.launches,
            trp.ragged_prefill_attn.launches,
            tdec.decode_attn_arena.launches) == counts
    for launcher, a in ((trp.ragged_prefill_arena, pargs),
                        (trp.ragged_prefill_attn, gargs),
                        (tdec.decode_attn_arena, dargs)):
        with pytest.raises(ValueError, match="CUDA kernel"):
            launcher(*a)


def test_ops_defaults_match_the_jax_wrappers():
    """q_offsets default to 0 and kv_lengths to the full slot depth."""
    q, k, v, sm, cu, _, _ = _t(_prefill_inputs("pad_segments_s64")[0])
    b, s = sm.shape[0], k.shape[1]
    zeros = torch.zeros(b, dtype=torch.int32)
    full = torch.full((b,), s, dtype=torch.int32)
    assert torch.equal(tops.ragged_mha_arena(q, k, v, sm, cu),
                       tops.ragged_mha_arena(q, k, v, sm, cu, zeros, full))
    kg, vg = k[sm.long()], v[sm.long()]
    assert torch.equal(tops.ragged_mha(q, kg, vg, cu),
                       tops.ragged_mha(q, kg, vg, cu, zeros, full))


@pytest.mark.parametrize("fn", ["prefill", "decode"])
def test_window_is_not_ported(fn):
    """Once the port's refusal of ``window=``; the rolling-slot forms
    are ported now, and on the CPU ``window=8`` gives the Pallas
    kernel's windowed form (interpret mode) on the same arena."""
    if fn == "prefill":
        args, call = _prefill_inputs("pad_segments_s64")[0], \
            tops.ragged_mha_arena
        jcall = jops.ragged_mha_arena
    else:
        args, call = _decode_inputs("pad_rows_s64")[0], tops.decode_arena
        jcall = jops.decode_arena
    got = call(*_t(args), window=8).numpy()
    want = _pallas(lambda *a: jcall(*a, window=8), *args)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_launcher_signatures_match_the_sources(name):
    """Each kernel library's C entry point takes exactly the pointer
    and int arguments its ctypes signature declares, in that order."""
    symbol, argtypes = _build.SIGNATURES[name]
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m is not None, symbol
    kinds = ["p" if "*" in a else "i" for a in m.group(1).split(",")]
    assert kinds == ["p" if t is _build.ctypes.c_void_p else "i"
                     for t in argtypes]
