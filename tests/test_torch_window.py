"""The port's windowed attention (ring page tables, rolling slots)
against the JAX package: the four windowed plain versions
(``ref_ragged_prefill_paged`` / ``_arena`` and ``ref_decode_attn_paged``
/ ``_arena`` with ``window=``) against the JAX oracles
(``repro.kernels.ref``, as the JAX suite runs them on the CPU), and the
launchers' window argument.

The inputs cover the wrap edges: a window off the page grid and the key
tiles (37 with 16-token pages; 1), kv lengths inside the window, at it,
at exactly one and two ring / rolling depths and far past them, rows of
one segment straddling the ring's wrap and the rolling slot's, a last
ring page partly valid, a segment longer than the margin (whose own
writes overwrote keys its first rows would see: both sides drop them,
as the TPU kernels do), keyless and pad segments, tail rows.  The
kernels' walk over the same layouts is rehearsed against these plain
versions in ``test_torch_attn_tiles.py`` and ``test_torch_decode_split.py``.

Tolerance: fp32 atol = rtol = 1e-5 — the same softmax in another
summation order.  The JAX oracles average junk on rows with no key,
where the port (and every kernel) writes 0: those rows are held to 0.

Runs in ~31 s in the tier-1 command (6 workers, ``--dist loadfile``;
most of it the JAX oracles' compiles).
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

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attn as tdec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ragged_prefill as trp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HQ, HKV, D, PS = 8, 2, 16, 16
MARGIN = 16
N_PAGES, N_SLOTS = 64, 12
# (length, history) per segment: at one ring depth (64 at window 37),
# straddling the ring's wrap at 128, a decode row, inside the window,
# two ring depths, two rolling depths (106 at window 37), straddling the
# rolling wrap at 106, longer than the margin, keyless; then pads
LENS = [16, 5, 1, 10, 16, 13, 8, 30, 4]
HISTS = [48, 125, 200, 10, 112, 93, 102, 150, 0]
KEYLESS = 8
N_PAD, TAIL = 2, 7
DECODE_LENGTHS = [0, 1, 20, 37, 38, 53, 64, 106, 128, 400]


def _depth(layout, window):
    d = window + MARGIN
    return -(-d // PS) * PS if layout == "ring" else d


def _storage(rng, layout, window, b):
    """Random K/V storage and the layout's index: a ring page table of
    ceil((window + margin) / ps) distinct pages a row (ring order), or a
    slot map into rolling slots of window + margin rows."""
    if layout == "ring":
        n_ring = _depth(layout, window) // PS
        shape = (N_PAGES, PS, HKV, D)
        index = rng.integers(0, N_PAGES, (b, n_ring))
    else:
        shape = (N_SLOTS, _depth(layout, window), HKV, D)
        index = rng.permutation(N_SLOTS)[:b]
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return k, v, index.astype(np.int32)


def _prefill_inputs(seed, layout, window):
    rng = np.random.default_rng(seed)
    kvl = [h + n for h, n in zip(HISTS, LENS)]
    kvl[KEYLESS] = 0
    cu = np.asarray([0] + list(np.cumsum(LENS)) + [sum(LENS)] * N_PAD,
                    np.int32)
    offs = np.asarray(HISTS + [0] * N_PAD, np.int32)
    kvl = np.asarray(kvl + [0] * N_PAD, np.int32)
    q = rng.standard_normal((sum(LENS) + TAIL, HQ, D)).astype(np.float32)
    k, v, index = _storage(rng, layout, window, len(kvl))
    return q, k, v, index, cu, offs, kvl


def _decode_inputs(seed, layout, window):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(DECODE_LENGTHS, np.int32)
    q = rng.standard_normal((len(lengths), HQ, D)).astype(np.float32)
    k, v, index = _storage(rng, layout, window, len(lengths))
    return q, k, v, index, lengths


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


PREFILL = {"ring": (tref.ref_ragged_prefill_paged,
                    jref.ref_ragged_prefill_paged),
           "rolling": (tref.ref_ragged_prefill_arena,
                       jref.ref_ragged_prefill_arena)}
DECODE = {"ring": (tref.ref_decode_attn_paged, jref.ref_decode_attn_paged),
          "rolling": (tref.ref_decode_attn_arena,
                      jref.ref_decode_attn_arena)}


@pytest.mark.parametrize("window", [37, 1, 64])
@pytest.mark.parametrize("layout", sorted(PREFILL))
def test_windowed_prefill_plain_matches_jax(layout, window):
    args = _prefill_inputs(window, layout, window)
    plain, oracle = PREFILL[layout]
    got = plain(*_t(args), window=window).numpy()
    want = np.asarray(oracle(*_j(args), window=window))
    # a row has a key unless its own position is no longer held (a
    # segment longer than the margin overwrote it) or its segment has
    # none; tail rows have none
    cu, offs, kvl = args[4:]
    keyed = np.zeros(len(got), bool)
    for i in range(len(kvl)):
        qpos = offs[i] + np.arange(cu[i + 1] - cu[i])
        keyed[cu[i]:cu[i + 1]] = (qpos < kvl[i]) & (
            qpos >= kvl[i] - _depth(layout, window))
    assert keyed.sum() > len(got) // 2
    np.testing.assert_allclose(got[keyed], want[keyed], **TOL)
    assert (got[~keyed] == 0).all()


@pytest.mark.parametrize("window", [37, 1, 64])
@pytest.mark.parametrize("layout", sorted(DECODE))
def test_windowed_decode_plain_matches_jax(layout, window):
    args = _decode_inputs(window + 1, layout, window)
    plain, oracle = DECODE[layout]
    got = plain(*_t(args), window=window).numpy()
    want = np.asarray(oracle(*_j(args), window=window))
    keyed = args[-1] > 0
    np.testing.assert_allclose(got[keyed], want[keyed], **TOL)
    assert (got[~keyed] == 0).all()


@pytest.mark.parametrize("layout", sorted(PREFILL))
def test_window_wider_than_history_is_full_attention(layout):
    """Before any wrap (every length within the layout's depth) and with
    a window wider than every history, the windowed forms are the full
    causal attention of the unwindowed plain versions."""
    q, k, v, index, cu, offs, kvl = _prefill_inputs(5, layout, 400)
    kvl = np.minimum(kvl, 60)
    offs = np.minimum(offs, kvl - np.diff(cu).astype(np.int32))
    offs = np.maximum(offs, 0)
    kvl = (offs + np.diff(cu)).astype(np.int32)
    kvl[KEYLESS] = 0
    args = _t((q, k, v, index, cu, offs, kvl))
    plain = PREFILL[layout][0]
    torch.testing.assert_close(plain(*args, window=400), plain(*args),
                               **TOL)
    dq, dk, dv, dindex, lengths = _t(_decode_inputs(6, layout, 400))
    lengths = lengths.clamp(max=60)
    dplain = DECODE[layout][0]
    torch.testing.assert_close(
        dplain(dq, dk, dv, dindex, lengths, window=400),
        dplain(dq, dk, dv, dindex, lengths), **TOL)


def test_ops_route_the_window_to_the_plain_versions():
    """On the CPU ``ops`` hands ``window`` to the plain versions."""
    args = _t(_prefill_inputs(3, "rolling", 37))
    torch.testing.assert_close(
        tops.ragged_mha_arena(*args, window=37),
        tref.ref_ragged_prefill_arena(*args, window=37))
    dargs = _t(_decode_inputs(4, "ring", 37))
    torch.testing.assert_close(
        tops.decode_paged(*dargs, window=37),
        tref.ref_decode_attn_paged(*dargs, window=37))


def test_launchers_check_the_window():
    """The launchers turn ``window`` into the C argument (0 = none) and
    refuse a width below 1; a CPU tensor never reaches a kernel."""
    assert trp.window_arg(None) == 0 and trp.window_arg(4096) == 4096
    with pytest.raises(ValueError, match="window"):
        trp.window_arg(0)
    q, k, v, index, cu, offs, kvl = _t(_prefill_inputs(3, "ring", 37))
    with pytest.raises(ValueError, match="window"):
        trp.ragged_prefill_paged(q, k, v, index, cu, offs, kvl, window=-1)
    with pytest.raises(ValueError, match="CUDA kernel"):
        trp.ragged_prefill_paged(q, k, v, index, cu, offs, kvl, window=37)
    dq, dk, dv, dindex, lengths = _t(_decode_inputs(4, "rolling", 37))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tdec.decode_attn_arena(dq, dk, dv, dindex, lengths, window=37)
