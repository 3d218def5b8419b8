"""The port's attention at head widths 64, 80 and 96 — stablelm-1.6b's,
hubert-xlarge's and phi-3-vision-4.2b's — against the JAX package: the
six plain versions of the paged, arena and gathered ragged prefill and
decode kernels, and the four windowed ones (ring page tables, rolling
slots), at rep 1 (MHA, as stablelm and phi-3) and rep 4, against the
JAX oracles (``repro.kernels.ref``) and the Pallas kernels in interpret
mode; and the port's configs stablelm-1.6b, phi-3-vision-4.2b,
qwen2.5-14b and minitron-8b equal to the reference's, field by field.  The engine at these widths:
``test_torch_head_widths_engine.py``.

The CUDA kernels' walks at these widths are rehearsed in
``test_torch_attn_tiles.py`` and ``test_torch_decode_split.py``, and
run on the card in ``test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerance: fp32 atol = rtol = 1e-5.  The JAX oracles average junk on
rows with no key, where the port and the Pallas kernels write 0: those
rows are held to the Pallas kernels only.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import decode_attn as jdec  # noqa: E402
from repro.kernels import ragged_prefill as jrp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ragged_prefill import HEAD_DIMS  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = (64, 80, 96)
HKV, PS = 2, 16

# ------------------------------------------------------------ plain versions

# a packed stream: a segment over several pages, a re-prefill at history
# 30, a decode row, a keyless segment, a pad segment and tail rows
LENS, HISTS, KEYLESS, TAIL = [21, 6, 1, 4], [0, 30, 50, 0], 3, 3
N_PAGES, P_MAX, N_SLOTS, S_MAX = 32, 4, 6, 64
DECODE_LENGTHS = [0, 1, 17, 64]


def _stream(rng, rep, d):
    kvl = [h + n for h, n in zip(HISTS, LENS)]
    kvl[KEYLESS] = 0
    cu = np.asarray([0] + list(np.cumsum(LENS)) + [sum(LENS)], np.int32)
    offs = np.asarray(HISTS + [0], np.int32)
    kvl = np.asarray(kvl + [0], np.int32)
    q = rng.standard_normal((sum(LENS) + TAIL, HKV * rep, d)).astype(
        np.float32)
    return q, cu, offs, kvl


def _kv(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _prefill_inputs(layout, rep, d):
    """(the plain version's args, the JAX oracle, the Pallas call) of the
    ragged prefill kernel over ``layout``."""
    rng = np.random.default_rng(d * 10 + rep)
    q, cu, offs, kvl = _stream(rng, rep, d)
    if layout == "paged":
        k, v = _kv(rng, (N_PAGES, PS, HKV, d))
        index = rng.permutation(N_PAGES)[:len(kvl) * P_MAX].reshape(
            len(kvl), P_MAX).astype(np.int32)
        return ((q, k, v, index, cu, offs, kvl), jref.ref_ragged_prefill_paged,
                lambda *a: jrp.ragged_prefill_paged(*a, block_q=8,
                                                    interpret=True))
    if layout == "arena":
        k, v = _kv(rng, (N_SLOTS, S_MAX, HKV, d))
        index = rng.permutation(N_SLOTS)[:len(kvl)].astype(np.int32)
        return ((q, k, v, index, cu, offs, kvl), jref.ref_ragged_prefill_arena,
                lambda *a: jrp.ragged_prefill_arena(
                    *a, block_q=8, block_k=16, interpret=True))
    k, v = _kv(rng, (len(kvl), S_MAX, HKV, d))
    return ((q, k, v, cu, offs, kvl), jref.ref_ragged_prefill,
            lambda *a: jrp.ragged_prefill_attn(*a, block_q=8, block_k=16,
                                               interpret=True))


def _decode_inputs(layout, rep, d):
    rng = np.random.default_rng(d * 10 + rep + 5)
    lengths = np.asarray(DECODE_LENGTHS, np.int32)
    b = len(lengths)
    q = rng.standard_normal((b, HKV * rep, d)).astype(np.float32)
    if layout == "paged":
        k, v = _kv(rng, (N_PAGES, PS, HKV, d))
        index = rng.permutation(N_PAGES)[:b * P_MAX].reshape(
            b, P_MAX).astype(np.int32)
        return ((q, k, v, index, lengths), jref.ref_decode_attn_paged,
                lambda *a: jdec.decode_attn_paged(*a, interpret=True))
    if layout == "arena":
        k, v = _kv(rng, (N_SLOTS, S_MAX, HKV, d))
        index = rng.permutation(N_SLOTS)[:b].astype(np.int32)
        return ((q, k, v, index, lengths), jref.ref_decode_attn_arena,
                lambda *a: jdec.decode_attn_arena(*a, block_k=16,
                                                  interpret=True))
    k, v = _kv(rng, (b, S_MAX, HKV, d))
    return ((q, k, v, lengths), jref.ref_decode_attn,
            lambda *a: jdec.decode_attn(*a, block_k=16, interpret=True))


PREFILL_PLAIN = {"paged": tref.ref_ragged_prefill_paged,
                 "arena": tref.ref_ragged_prefill_arena,
                 "gathered": tref.ref_ragged_prefill}
DECODE_PLAIN = {"paged": tref.ref_decode_attn_paged,
                "arena": tref.ref_decode_attn_arena,
                "dense": tref.ref_decode_attn}


def _held(plain, oracle, pallas, args, keyed, window=None):
    kw = {} if window is None else dict(window=window)
    got = plain(*(torch.from_numpy(a) for a in args), **kw).numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(oracle(*jargs, **kw))
    np.testing.assert_allclose(got[keyed], want[keyed], **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas(*jargs, **kw)), **TOL)
    assert (got[~keyed] == 0).all()
    return got


def _prefill_keyed(cu, offs, kvl, n_rows, depth=None):
    """Rows with a key: inside a segment with keys whose own position
    is still held (``depth``: the ring's or rolling slot's)."""
    keyed = np.zeros(n_rows, bool)
    for i in range(len(kvl)):
        qpos = offs[i] + np.arange(cu[i + 1] - cu[i])
        ok = qpos < kvl[i]
        if depth is not None:
            ok &= qpos >= kvl[i] - depth
        keyed[cu[i]:cu[i + 1]] = ok
    return keyed


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("layout", sorted(PREFILL_PLAIN))
@pytest.mark.parametrize("d", WIDTHS)
def test_prefill_plain_matches_jax(d, layout, rep):
    args, oracle, pallas = _prefill_inputs(layout, rep, d)
    cu, offs, kvl = args[-3:]
    keyed = _prefill_keyed(cu, offs, kvl, len(args[0]))
    assert keyed.sum() > len(keyed) // 2
    _held(PREFILL_PLAIN[layout], oracle, pallas, args, keyed)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("layout", sorted(DECODE_PLAIN))
@pytest.mark.parametrize("d", WIDTHS)
def test_decode_plain_matches_jax(d, layout, rep):
    args, oracle, pallas = _decode_inputs(layout, rep, d)
    _held(DECODE_PLAIN[layout], oracle, pallas, args, args[-1] > 0)


# the windowed forms: a window of 24 (off the 16-token page grid) over
# a ring of 3 pages (48 positions) and rolling slots of 40 rows (window
# + a 16-row margin); every stream segment runs past both depths
W_WINDOW, W_RING, W_DEPTH = 24, 3, 40
W_LENS, W_HISTS = [10, 1, 5, 12], [60, 90, 41, 0]
W_DECODE = [0, 1, 24, 25, 48, 90]


def _window_inputs(layout, kind, rep, d):
    rng = np.random.default_rng(d * 7 + rep)
    if kind == "prefill":
        kvl = np.asarray([h + n for h, n in zip(W_HISTS, W_LENS)] + [0],
                         np.int32)
        cu = np.asarray([0] + list(np.cumsum(W_LENS)) + [sum(W_LENS)],
                        np.int32)
        offs = np.asarray(W_HISTS + [0], np.int32)
        q = rng.standard_normal((sum(W_LENS) + TAIL, HKV * rep, d)).astype(
            np.float32)
        b, seg = len(kvl), (cu, offs, kvl)
    else:
        lengths = np.asarray(W_DECODE, np.int32)
        q = rng.standard_normal((len(lengths), HKV * rep, d)).astype(
            np.float32)
        b, seg = len(lengths), (lengths,)
    if layout == "ring":
        k, v = _kv(rng, (N_PAGES, PS, HKV, d))
        index = rng.permutation(N_PAGES)[:b * W_RING].reshape(
            b, W_RING).astype(np.int32)
    else:
        k, v = _kv(rng, (b + 1, W_DEPTH, HKV, d))
        index = rng.permutation(b + 1)[:b].astype(np.int32)
    return (q, k, v, index) + seg


W_KERNELS = {
    ("ring", "prefill"): (tref.ref_ragged_prefill_paged,
                          jref.ref_ragged_prefill_paged,
                          lambda *a, **kw: jrp.ragged_prefill_paged(
                              *a, block_q=8, interpret=True, **kw)),
    ("rolling", "prefill"): (tref.ref_ragged_prefill_arena,
                             jref.ref_ragged_prefill_arena,
                             lambda *a, **kw: jrp.ragged_prefill_arena(
                                 *a, block_q=8, block_k=8, interpret=True,
                                 **kw)),
    ("ring", "decode"): (tref.ref_decode_attn_paged,
                         jref.ref_decode_attn_paged,
                         lambda *a, **kw: jdec.decode_attn_paged(
                             *a, interpret=True, **kw)),
    ("rolling", "decode"): (tref.ref_decode_attn_arena,
                            jref.ref_decode_attn_arena,
                            lambda *a, **kw: jdec.decode_attn_arena(
                                *a, block_k=8, interpret=True, **kw)),
}


# the windowed forms at rep 1 at the MHA configs' widths and rep 4 at 80
# (each rep is at every width in the unwindowed tests above, and
# test_torch_window.py holds the windowed forms at rep 4 over more wrap
# edges)
W_CASES = [(64, 1), (80, 4), (96, 1)]


@pytest.mark.parametrize("layout,kind", sorted(W_KERNELS))
@pytest.mark.parametrize("d,rep", W_CASES)
def test_windowed_plain_matches_jax(d, rep, layout, kind):
    args = _window_inputs(layout, kind, rep, d)
    if kind == "prefill":
        depth = W_RING * PS if layout == "ring" else W_DEPTH
        keyed = _prefill_keyed(*args[-3:], len(args[0]), depth)
    else:
        keyed = args[-1] > 0
    assert keyed.sum() > len(keyed) // 2
    _held(*W_KERNELS[layout, kind], args, keyed, window=W_WINDOW)


@pytest.mark.parametrize("arch,module", [
    ("stablelm-1.6b", "stablelm_1_6b"),
    ("phi-3-vision-4.2b", "phi3_vision_4_2b"),
    ("qwen2.5-14b", "qwen2_5_14b"),
    ("minitron-8b", "minitron_8b"),
])
def test_registered_configs_equal_the_reference(arch, module):
    """The port's copies of the reference's ``FULL`` and ``smoke()``,
    field for field, and their head widths among the kernels'."""
    jsmoke = importlib.import_module(f"repro.configs.{module}").smoke()
    for jc, tc in ((get_config(arch), tget_config(arch)),
                   (jsmoke, tget(arch))):
        assert {f.name: getattr(jc, f.name) for f in
                dataclasses.fields(tc)} == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
    assert tget_config(arch).hdim in HEAD_DIMS
