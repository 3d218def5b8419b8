"""Paged attention kernels of the PyTorch port: the plain PyTorch versions
against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels in
interpret mode, on fragmented, shared and COW-forked page tables with
q_offsets > 0, length-1 decode segments inside a prefill stream, a
bucket tail past cu_seqlens[-1], keyless segments, decode rows with
lengths 0 and kv lengths off the page grid; plus the device dispatch
(CPU → plain version, never a fallback) and the kernel build keys.

Tolerance: atol 1e-5 in fp32 — both sides compute the same softmax in
fp32 and differ only in summation order.  The JAX oracle averages junk
over rows with no valid key where the kernels (Pallas and CUDA) and the
port's plain version write 0, so those layouts are held against the
Pallas kernels only.
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

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attn as tdec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ragged_prefill as trp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
HQ, HKV, D, PS, NPAGES, PMAX = 4, 2, 16, 4, 40, 12

# lens, hists (q_offsets), tail rows, share=(a, b, k), keyless segment
PREFILL = {
    "fragmented": ([5, 3, 1, 7], [6, 0, 9, 2], 3, None, None),
    "shared_prefix": ([4, 2, 1], [8, 8, 13], 2, (0, 1, 2), None),
    "cow_fork": ([3, 3, 1], [9, 9, 5], 0, (0, 1, 3), None),
    "decode_rows": ([1, 1, 6, 1], [14, 3, 0, 27], 1, None, None),
    "keyless_segment": ([4, 3, 2], [0, 0, 5], 2, None, 1),
}
# lengths, share
DECODE = {
    "fragmented": ([11, 7, 1, 16, 29], None),
    "shared_cow": ([12, 14, 5], (0, 1, 3)),
    "zero_lengths": ([0, 9, 0], None),
}


def _layout(seed, kv_lens, share):
    """Fragmented page table: each row gets ceil(kv_len/ps) distinct
    random pages, row b optionally sharing row a's first k pages; unused
    entries point at page 0 (in range; masked by the lengths)."""
    rng = np.random.default_rng(seed)
    table = np.zeros((len(kv_lens), PMAX), np.int32)
    free = list(rng.permutation(NPAGES))
    for i, n in enumerate(kv_lens):
        need = -(-n // PS)
        table[i, :need] = [free.pop() for _ in range(need)]
    if share is not None:
        a, b, k = share
        table[b, :k] = table[a, :k]
    return table


def _pools(seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((NPAGES, PS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((NPAGES, PS, HKV, D)).astype(np.float32)
    return k, v


def _prefill_inputs(name):
    lens, hists, tail, share, keyless = PREFILL[name]
    kvl = [h + l for h, l in zip(hists, lens)]
    if keyless is not None:
        kvl[keyless] = 0
    table = _layout(1, kvl, share)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((int(cu[-1]) + tail, HQ, D)).astype(np.float32)
    k, v = _pools(3)
    return (q, k, v, table, cu, np.asarray(hists, np.int32),
            np.asarray(kvl, np.int32)), keyless is None


def _decode_inputs(name):
    lengths, share = DECODE[name]
    table = _layout(4, lengths, share)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((len(lengths), HQ, D)).astype(np.float32)
    k, v = _pools(6)
    return (q, k, v, table, np.asarray(lengths, np.int32)), \
        min(lengths) > 0


def _pallas(fn, *args):
    try:
        jops.set_backend("pallas")
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))
    finally:
        jops.set_backend(None)


@pytest.mark.parametrize("name", sorted(PREFILL))
def test_ragged_prefill_paged_plain_matches_jax(name):
    args, ref_ok = _prefill_inputs(name)
    got = tref.ref_ragged_prefill_paged(
        *(torch.from_numpy(a) for a in args)).numpy()
    pallas = _pallas(jops.ragged_mha_paged, *args)
    np.testing.assert_allclose(got, pallas, **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_ragged_prefill_paged(
            *(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, **TOL)
    cu = args[4]
    assert (got[cu[-1]:] == 0).all(), "bucket tail must be exactly 0"


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_attn_paged_plain_matches_jax(name):
    args, ref_ok = _decode_inputs(name)
    got = tref.ref_decode_attn_paged(
        *(torch.from_numpy(a) for a in args)).numpy()
    pallas = _pallas(jops.decode_paged, *args)
    np.testing.assert_allclose(got, pallas, **TOL)
    if ref_ok:
        want = np.asarray(jref.ref_decode_attn_paged(
            *(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(got, want, **TOL)
    lengths = args[-1]
    assert (got[lengths == 0] == 0).all(), "lengths 0 must give 0"


def test_bf16_plain_rounds_only_the_output():
    """bf16 inputs: the plain version computes in fp32 and rounds once
    at the end, so it equals the fp32 result on the bf16-rounded inputs
    cast to bf16."""
    args, _ = _prefill_inputs("fragmented")
    t = [torch.from_numpy(a) for a in args]
    q, k, v = (x.to(torch.bfloat16) for x in t[:3])
    got = tref.ref_ragged_prefill_paged(q, k, v, *t[3:])
    want = tref.ref_ragged_prefill_paged(q.float(), k.float(), v.float(),
                                         *t[3:]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def _bf16_decode_like_the_kernel(q, k, v, table, lengths, tile=16,
                                 drop=None):
    """What the CUDA decode kernel computes in bf16, in plain ops: an
    online softmax over key tiles in fp32, p rounded to bf16 before the
    PV product, l summed from the unrounded p, the output rounded once.
    ``drop`` skips the key tile starting there (a faulty kernel)."""
    b, p_max = table.shape
    ps, hkv, d = k.shape[1:]
    rep = q.shape[1] // hkv
    kg = k.float()[table.long()].reshape(b, p_max * ps, hkv, d)
    vg = v.float()[table.long()].reshape(b, p_max * ps, hkv, d)
    kg, vg = kg.repeat_interleave(rep, 2), vg.repeat_interleave(rep, 2)
    pos = torch.arange(p_max * ps)
    valid = pos[None, :] < lengths[:, None]
    if drop is not None:
        valid &= ~((pos >= drop) & (pos < drop + tile))[None, :]
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kg) * d ** -0.5
    m = torch.full(q.shape[:2], -1e30)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape)
    for t0 in range(0, p_max * ps, tile):
        ok = valid[:, None, t0:t0 + tile]
        st = s[:, :, t0:t0 + tile].masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None]) * ok
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhk,bkhd->bhd", p.bfloat16().float(), vg[:, t0:t0 + tile])
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)[..., None]).bfloat16()


@pytest.mark.parametrize("lengths,drop,within", [
    ([2048, 2048, 2048, 2048], None, True),
    ([5, 17, 1, 40], None, True),
    ([2048, 2048, 2048, 2048], 1024, False),
    ([2048, 2048, 2048, 2048], 2032, False),
])
def test_bf16_error_bound_holds_the_kernels_rounding(lengths, drop, within):
    """The elementwise bound the card holds bf16 kernels to
    (``ref.kernel_error_bound``) admits the kernels' rounding of p and of
    the output, on long rows (outputs ~0.04) and on short rows (outputs
    ~1), and rejects a kernel that drops one 16-key tile of 2048."""
    g = torch.Generator().manual_seed(7)
    hq, hkv, d, ps = 4, 2, 128, 16
    n = len(lengths) * 2048 // ps
    k = torch.randn((n, ps, hkv, d), generator=g).bfloat16()
    v = torch.randn((n, ps, hkv, d), generator=g).bfloat16()
    q = torch.randn((len(lengths), hq, d), generator=g).bfloat16()
    table = torch.arange(n, dtype=torch.int32).reshape(len(lengths), -1)
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = _bf16_decode_like_the_kernel(q, k, v, table, lens, drop=drop)
    ref, bound = tref.kernel_error_bound(tref.ref_decode_attn_paged,
                                         torch.bfloat16, q, k, v, table, lens)
    assert bool(((got.float() - ref).abs() <= bound).all()) == within


def test_cpu_dispatch_takes_the_plain_version():
    """ops on CPU tensors run the plain version and launch nothing; the
    kernel launchers refuse CPU tensors instead of falling back."""
    pargs, _ = _prefill_inputs("fragmented")
    dargs, _ = _decode_inputs("fragmented")
    pt = [torch.from_numpy(a) for a in pargs]
    dt = [torch.from_numpy(a) for a in dargs]
    n_p, n_d = trp.ragged_prefill_paged.launches, tdec.decode_attn_paged.launches
    out = tops.ragged_mha_paged(*pt)
    assert torch.equal(out, trp.ragged_prefill_paged_plain(*pt))
    assert torch.equal(tops.decode_paged(*dt), tdec.decode_attn_paged_plain(*dt))
    assert (trp.ragged_prefill_paged.launches, tdec.decode_attn_paged.launches) \
        == (n_p, n_d)
    with pytest.raises(ValueError, match="CUDA kernel"):
        trp.ragged_prefill_paged(*pt)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tdec.decode_attn_paged(*dt)


def test_ops_defaults_match_explicit_lengths():
    """ragged_mha_paged's q_offsets / kv_lengths defaults (0 and the full
    table depth) are the JAX wrapper's."""
    args, _ = _prefill_inputs("fragmented")
    q, k, v, table, cu = (torch.from_numpy(a) for a in args[:5])
    b = table.shape[0]
    got = tops.ragged_mha_paged(q, k, v, table, cu)
    want = tops.ragged_mha_paged(
        q, k, v, table, cu, torch.zeros(b, dtype=torch.int32),
        torch.full((b,), PS * PMAX, dtype=torch.int32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("fn", ["prefill", "decode"])
def test_window_is_not_ported(fn):
    """Once the port's refusal of ``window=``; the ring-table forms are
    ported now, and on the CPU ``window=8`` gives the Pallas kernel's
    windowed form (interpret mode) over the same table, read as a ring
    of P_max pages."""
    if fn == "prefill":
        args, _ = _prefill_inputs("fragmented")
        call, jcall = tops.ragged_mha_paged, jops.ragged_mha_paged
    else:
        args, _ = _decode_inputs("fragmented")
        call, jcall = tops.decode_paged, jops.decode_paged
    got = call(*(torch.from_numpy(a) for a in args), window=8).numpy()
    want = _pallas(lambda *a: jcall(*a, window=8), *args)
    np.testing.assert_allclose(got, want, **TOL)


def test_build_key_follows_the_sources():
    """Each kernel library is keyed by its own source and the shared
    header; the two kernels never share a library."""
    a = _build.library_path("ragged_prefill_paged")
    b = _build.library_path("decode_attn_paged")
    assert a != b and a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("ragged_prefill_paged-")
    for name, (symbol, argtypes) in _build.SIGNATURES.items():
        assert (_build.CSRC / f"{name}.cu").read_text().count(
            f'extern "C" int {symbol}(') == 1


# the nine dispatchers of ``ops`` whose CUDA branch launches a kernel
CUDA_DISPATCH = ("mha", "ragged_mha", "ragged_mha_arena", "ragged_mha_paged",
                 "decode", "decode_arena", "decode_paged", "fused_sample",
                 "ssd_grouped")


@pytest.mark.parametrize("grad_input", [0, 1, 2])
def test_check_no_grad_refuses_inputs_that_require_grad(grad_input):
    """The check every CUDA branch runs: under grad mode an input that
    requires grad raises (the kernels have no backward kernel), naming
    the kernel and ROADMAP item 15b; under ``no_grad``, or with no input
    requiring grad, it passes."""
    xs = [torch.zeros(3), torch.zeros(3), torch.zeros(2, dtype=torch.int32)]
    tops.check_no_grad("decode_paged", *xs, None, 1.0)
    xs[grad_input] = xs[grad_input].float().requires_grad_()
    with pytest.raises(RuntimeError, match=r"decode_paged: .*no backward "
                                           r"kernel yet \(ROADMAP item 15b\)"):
        tops.check_no_grad("decode_paged", *xs)
    with torch.no_grad():
        tops.check_no_grad("decode_paged", *xs)
    tops.check_no_grad("decode_paged", *(x.detach() for x in xs))


# the dispatchers whose kernel has a backward: (the autograd function's
# call under grad, the plain launch)
ROUTED = {"mha": ("_flash.FlashAttnFn.apply(", "_flash.flash_attn("),
          "ssd_grouped": ("_ssd.SSDScanFn.apply(", "_ssd.ssd_scan(")}


@pytest.mark.parametrize("name", CUDA_DISPATCH)
def test_every_cuda_branch_checks_grad_before_launching(name):
    """Each dispatcher's CUDA branch runs ``check_no_grad`` on its tensor
    inputs before it calls the launcher, and its CPU branch does not —
    but ``mha`` and ``ssd_grouped``, whose kernels have a backward: under
    grad mode with an input that requires grad their CUDA branch goes
    through ``FlashAttnFn`` (forward kernel with its log-sum-exp, then
    the backward kernels) or ``SSDScanFn`` (forward kernel with its
    chunk states, then the backward kernels), else the plain launch."""
    import inspect
    src = inspect.getsource(getattr(tops, name))
    body = src.split('.device.type == "cuda":', 1)[1]
    cpu = src.split('.device.type == "cpu":', 1)[1]
    assert "check_no_grad" not in cpu
    if name in ROUTED:
        first = body.split("return", 1)[0]
        assert "torch.is_grad_enabled()" in first and "requires_grad" in first
        routed = body.split("return", 2)
        assert ROUTED[name][0] in routed[1]
        assert ROUTED[name][1] in routed[2]
        assert "check_no_grad" not in body.split('.device.type == "cpu"')[0]
        return
    cuda = body.split("if ", 1)[0]
    assert f'check_no_grad("{name}", ' in cuda.split("return", 1)[0]


def test_cpu_branches_still_differentiate():
    """The plain versions on the CPU keep their autograd graph."""
    args, _ = _prefill_inputs("fragmented")
    t = [torch.from_numpy(a) for a in args]
    q = t[0].clone().requires_grad_()
    out = tops.ragged_mha_paged(q, *t[1:])
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
