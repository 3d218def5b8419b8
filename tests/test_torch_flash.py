"""Dense attention kernels of the PyTorch port: ``flash_attn`` (the dense
(L, B) grid's and an encoder layer's attention) and ``decode_attn`` (the
dense decode step's).  Their plain versions, reached through the port's
``ops.mha`` / ``ops.decode`` on the CPU, against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode: causal
with per-row query offsets, non-causal with kv lengths, a sliding
window, head widths 16, 64, 80, 96 and 128, GQA groups of 1, 2 and 5.
Rows with no valid key are held against the Pallas kernels only: the JAX
oracle averages junk there, where the kernels (Pallas and CUDA) and the
port's plain version write 0.  Also the CPU q-chunking of
``attention_core`` and the CUDA launchers' refusals.

Tolerance: atol = rtol = 1e-5 in fp32 — both sides compute the same
softmax in fp32 and differ only in summation order.
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
from repro.kernels.decode_attn import decode_attn as jdecode  # noqa: E402
from repro.kernels.flash_attn import flash_attn as jflash  # noqa: E402
from repro_torch.kernels import decode_attn as tdec  # noqa: E402
from repro_torch.kernels import flash_attn as tfl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HKV, B, LQ, S = 2, 2, 9, 24
DIMS = (16, 64, 80, 96, 128)
REPS = (1, 2, 5)
# q_offsets, kv_lengths, causal, window
CASES = {
    "causal_offsets": ([0, 15], None, True, None),
    "noncausal_kv_lengths": ([0, 0], [24, 11], False, None),
    "window": ([3, 15], [12, 24], True, 5),
}
KEYLESS = {
    # a row whose kv length is 0, beside one with keys
    "noncausal_empty_row": ([0, 0], [0, 7], False, None),
    "causal_empty_row": ([4, 0], [9, 0], True, None),
}


def _qkv(seed, d, rep, lq=LQ, b=B):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, HKV * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, S, HKV, d)).astype(np.float32)
    v = rng.standard_normal((b, S, HKV, d)).astype(np.float32)
    return q, k, v


def _i32(x):
    return None if x is None else np.asarray(x, np.int32)


def _port_mha(q, k, v, offs, kvl, causal, window):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return tops.mha(*t, None if offs is None else torch.from_numpy(offs),
                    None if kvl is None else torch.from_numpy(kvl),
                    causal=causal, window=window).numpy()


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_plain_matches_jax(d, rep, case):
    offs, kvl, causal, window = CASES[case]
    q, k, v = _qkv(d * 10 + rep, d, rep)
    offs, kvl = _i32(offs), _i32(kvl)
    got = _port_mha(q, k, v, offs, kvl, causal, window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo = jnp.asarray(offs)
    jl = None if kvl is None else jnp.asarray(kvl)
    want = jref.ref_flash_attn(jq, jk, jv, q_offsets=jo, kv_lengths=jl,
                               window=window, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    pallas = jflash(jq, jk, jv, jo, jl, causal=causal, window=window,
                    block_q=8, block_k=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", sorted(KEYLESS))
def test_mha_keyless_rows_write_zero_as_pallas(d, case):
    offs, kvl, causal, window = KEYLESS[case]
    q, k, v = _qkv(d, d, 2)
    offs, kvl = _i32(offs), _i32(kvl)
    got = _port_mha(q, k, v, offs, kvl, causal, window)
    pallas = jflash(*(jnp.asarray(a) for a in (q, k, v, offs, kvl)),
                    causal=causal, window=window, block_q=8, block_k=8,
                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    assert (got[kvl == 0] == 0).all()


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("rep", REPS)
def test_decode_plain_matches_jax(d, rep):
    rng = np.random.default_rng(d + rep)
    b = 4
    q = rng.standard_normal((b, HKV * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, S, HKV, d)).astype(np.float32)
    v = rng.standard_normal((b, S, HKV, d)).astype(np.float32)
    lengths = np.asarray([0, 1, 13, S], np.int32)
    got = tops.decode(*(torch.from_numpy(a) for a in (q, k, v, lengths)))
    got = got.numpy()
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    pallas = jdecode(*args, block_k=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    assert (got[0] == 0).all()                       # length 0 → 0
    want = jref.ref_decode_attn(*args)               # junk on row 0
    np.testing.assert_allclose(got[1:], np.asarray(want)[1:], **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_core_chunks_match_one_call(causal):
    """On the CPU attention_core runs the plain version in q-chunks,
    each from its own offset; the chunks join into the one-call
    result."""
    q, k, v = _qkv(5, 16, 2, lq=11)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = (torch.tensor([[2], [9]]) + torch.arange(11)).int()
    kvl = torch.tensor([S, 17], dtype=torch.int32)
    whole = tl.attention_core(tq, tk, tv, pos, causal=causal, window=None,
                              kv_valid_len=kvl)
    parts = tl.attention_core(tq, tk, tv, pos, causal=causal, window=None,
                              kv_valid_len=kvl, q_chunk=4)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), **TOL)
    want = tops.mha(tq, tk, tv, pos[:, 0], kvl, causal=causal)
    np.testing.assert_allclose(whole.numpy(), want.numpy(), **TOL)


def test_launchers_refuse_what_their_kernels_do_not_take():
    """A CPU tensor reaches the plain version only through ``ops``; the
    CUDA launchers refuse it (the head widths and GQA groups they refuse
    are checked on the card, ``tests/test_torch_gpu.py``)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 80, 1))
    idx = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfl.flash_attn(q, k, v, idx, idx)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tdec.decode_attn(q[:, 0].contiguous(), k, v, idx)
    assert tfl.HEAD_DIMS == (64, 80, 96, 128) and tfl.MAX_REP == 8
