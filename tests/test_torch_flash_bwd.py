"""The backward of the port's dense flash attention: the plain version
``kernels.ref.flash_attn_bwd_plain`` (the formulas the
``flash_attn_bwd`` CUDA kernels compute: P from the forward's
log-sum-exp, Δ = rowsum(dO ∘ O), dV = Pᵀ·dO, dS = P ∘ (dP − Δ), dK and
dQ from dS) against ``torch.autograd`` of ``ref_flash_attn`` and
against ``jax.vjp`` of the reference's ``repro.kernels.ref
.ref_flash_attn``, over the forms the kernel takes: causal with per-row
query offsets, non-causal with kv lengths, a sliding window, rows with
no key, GQA groups of 1 to 8, head widths 64 to 128.  Rows with no key
are held against autograd only: the JAX oracle averages junk there and
differentiates it, where the kernels and the port's plain version write
0 and pass no gradient.  Also the plain log-sum-exp the forward kernel
writes, the derived error bound of ``flash_attn_bwd_error_bound`` and
that it bites (a dropped query tile or key tile lies outside it), the
launchers' refusals and ``ops.mha`` under grad on the CPU.

Tolerance: atol = rtol = 1e-5 in fp32 — every side computes the same
sums in fp32 in another order.
"""
import math

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
from repro_torch.kernels import flash_attn as tfl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HKV, B, LQ = 2, 2, 21
# S, q_offsets, kv_lengths, causal, window
CASES = {
    "causal": (21, [0, 0], None, True, None),
    "causal_offsets": (40, [3, 19], [24, 40], True, None),
    "noncausal_kv_lengths": (30, [0, 0], [30, 11], False, None),
    "window": (40, [5, 19], [26, 40], True, 6),
    "noncausal_window": (21, [0, 0], None, False, 4),
}
KEYLESS = {
    "noncausal_empty_row": (16, [0, 0], [0, 7], False, None),
    "causal_empty_row": (40, [4, 0], [9, 0], True, None),
}


def _inputs(seed, d, rep, s, lq=LQ, b=B):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, HKV * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, s, HKV, d)).astype(np.float32)
    v = rng.standard_normal((b, s, HKV, d)).astype(np.float32)
    do = rng.standard_normal((b, lq, HKV * rep, d)).astype(np.float32)
    return q, k, v, do


def _i32(x):
    return None if x is None else torch.tensor(x, dtype=torch.int32)


def _plain(q, k, v, do, offs, lens, causal, window):
    """(out, lse, (dq, dk, dv)) of the plain forward and backward."""
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, ln = _i32(offs), _i32(lens)
    out = tref.ref_flash_attn(*t[:3], o, ln, causal=causal, window=window)
    lse = tref.ref_flash_attn_lse(t[0], t[1], o, ln, causal=causal,
                                  window=window)
    grads = tref.flash_attn_bwd_plain(*t[:3], out, lse, t[3], o, ln,
                                      causal=causal, window=window)
    return out, lse, grads


def _autograd(q, k, v, do, offs, lens, causal, window):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tref.ref_flash_attn(*t, _i32(offs), _i32(lens), causal=causal,
                              window=window)
    out.backward(torch.from_numpy(do))
    return [x.grad for x in t]


@pytest.mark.parametrize("rep", [1, 4, 5, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case, rep):
    s, offs, lens, causal, window = CASES[case]
    d = 64
    q, k, v, do = _inputs(1, d, rep, s)
    _, _, got = _plain(q, k, v, do, offs, lens, causal, window)
    jo = None if offs is None else jnp.asarray(offs, jnp.int32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    _, vjp = jax.vjp(
        lambda a, b_, c: jref.ref_flash_attn(a, b_, c, q_offsets=jo,
                                             kv_lengths=jl, causal=causal,
                                             window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("case", sorted(CASES) + sorted(KEYLESS))
def test_plain_backward_matches_autograd(case, d):
    s, offs, lens, causal, window = {**CASES, **KEYLESS}[case]
    q, k, v, do = _inputs(2, d, 4, s)
    _, _, got = _plain(q, k, v, do, offs, lens, causal, window)
    want = _autograd(q, k, v, do, offs, lens, causal, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("case", sorted(KEYLESS))
def test_keyless_rows_pass_no_gradient(case):
    """A row with no key: lse -inf, dq 0, and its dout moves no dk/dv."""
    s, offs, lens, causal, window = KEYLESS[case]
    q, k, v, do = _inputs(3, 64, 2, s)
    _, lse, (dq, dk, dv) = _plain(q, k, v, do, offs, lens, causal, window)
    t = [torch.from_numpy(x) for x in (q, k)]
    scores, mask = tref._flash_scores(*t, _i32(offs), _i32(lens), causal,
                                      window)
    keyless = ~mask.any(-1)                                 # (B, Lq)
    assert keyless.any()
    assert torch.isneginf(lse.permute(0, 2, 1)[keyless]).all()
    assert (dq[keyless] == 0).all()
    do2 = do.copy()
    do2[keyless.numpy()] = 1e3                  # nothing flows from them
    _, _, (_, dk2, dv2) = _plain(q, k, v, do2, offs, lens, causal, window)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(KEYLESS))
def test_plain_lse_is_the_logsumexp_of_the_band(case):
    s, offs, lens, causal, window = {**CASES, **KEYLESS}[case]
    q, k, _, _ = _inputs(4, 80, 5, s)
    lse = tref.ref_flash_attn_lse(torch.from_numpy(q), torch.from_numpy(k),
                                  _i32(offs), _i32(lens), causal=causal,
                                  window=window).numpy()
    qpos = np.asarray(offs)[:, None] + np.arange(LQ)
    kpos = np.arange(s)
    hq = q.shape[2]
    for b in range(B):
        for i in range(LQ):
            ok = np.ones(s, bool)
            if causal:
                ok &= kpos <= qpos[b, i]
            if window is not None:
                ok &= kpos > qpos[b, i] - window
            if lens is not None:
                ok &= kpos < lens[b]
            for h in range(hq):
                sc = (k[b, :, h // (hq // HKV)].astype(np.float64)
                      @ q[b, i, h].astype(np.float64)) / math.sqrt(80)
                want = (np.log(np.exp(sc[ok] - sc[ok].max()).sum())
                        + sc[ok].max()) if ok.any() else -np.inf
                np.testing.assert_allclose(lse[b, h, i], want, rtol=1e-5,
                                           atol=1e-5)


def _kernel_rounding(q, k, v, out, lse, do, o, ln, causal):
    """The backward by the bf16 kernels' arithmetic: fp32 sums of the
    storage values, P rounded to bf16 before dV's product and dS rounded
    to bf16 before dK's and dQ's (the tensor cores' operands)."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scores, mask = tref._flash_scores(q.float(), k.float(), o, ln, causal,
                                      None)
    lse5 = lse.reshape(b, hkv, rep, lq).permute(0, 1, 3, 2)
    p = torch.where(mask[:, None, :, None, :],
                    torch.exp(scores - lse5[..., None]), torch.zeros(()))
    og, dog, qg = (x.float().reshape(b, lq, hkv, rep, d)
                   for x in (out, do, q))
    delta = (dog * og).sum(-1).permute(0, 2, 1, 3)
    dp = torch.einsum("blgrd,bsgd->bglrs", dog, v.float())
    ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()
    dv = torch.einsum("bglrs,blgrd->bsgd", pb, dog)
    dk = torch.einsum("bglrs,blgrd->bsgd", ds, qg) / math.sqrt(d)
    dq = torch.einsum("bglrs,bsgd->blgrd", ds, k.float()) / math.sqrt(d)
    return dq.reshape(b, lq, hq, d), dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_error_bound_holds_for_the_plain_version_and_bites(dtype):
    """The bound the card's kernels are held to: the plain version run
    on the storage values lies inside it (fp32, and bf16 rounded once),
    and in bf16 so does the kernels' arithmetic (P and dS rounded to
    bf16 at the tensor cores' operands); a dropped 64-vector query tile
    (its dout unseen) or a dropped 64-key tile (its dk, dv never
    written) lies outside it, for the plain version and, in bf16, for
    the kernels' arithmetic."""
    s, offs, lens, causal, window = 130, [0, 2], [130, 120], True, None
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(dtype) for sh in ((B, 128, 8, 64), (B, s, 2, 64),
                                          (B, s, 2, 64), (B, 128, 8, 64)))
    o, ln = _i32(offs), _i32(lens)
    out = tref.ref_flash_attn(q.float(), k.float(), v.float(), o, ln,
                              causal=causal).to(dtype)
    lse = tref.ref_flash_attn_lse(q.float(), k.float(), o, ln, causal=causal)
    refs, bounds = tref.flash_attn_bwd_error_bound(q, k, v, out, lse, do, o,
                                                   ln, causal=causal)
    runs = {"plain": lambda d_: tref.flash_attn_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, d_.float(), o, ln,
        causal=causal)}
    if dtype == torch.bfloat16:
        runs["kernel rounding"] = lambda d_: _kernel_rounding(
            q, k, v, out, lse, d_, o, ln, causal)
    for name, run in runs.items():
        got = run(do)
        for g, r, bd in zip(got, refs, bounds):
            assert ((g.to(dtype).float() - r).abs() <= bd).all(), name
        # a dropped query tile: rows 32..47 of every head (16 rows x rep
        # 4 = 64 vectors of one KV group), their dout never read
        do_cut = do.clone()
        do_cut[:, 32:48] = 0
        cut = run(do_cut)
        assert any(((c.to(dtype).float() - r).abs() > bd).any()
                   for c, r, bd in zip(cut, refs, bounds)), name
        # a dropped key tile: keys 64..127's dk and dv left at 0
        for i in (1, 2):
            c = got[i].clone()
            c[:, 64:128] = 0
            assert ((c.to(dtype).float() - refs[i]).abs() >
                    bounds[i]).any(), name


def test_launchers_refuse_cpu_tensors():
    q = torch.zeros(1, 4, 4, 64)
    k = torch.zeros(1, 4, 4, 64)
    idx = torch.zeros(1, dtype=torch.int32)
    lse = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfl.flash_attn(q, k, k, idx, idx, return_lse=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfl.flash_attn_bwd(q, k, k, q, lse, q, idx, idx)


def test_mha_on_cpu_differentiates_through_the_plain_version():
    """On the CPU ``ops.mha`` is the plain version, which autograd
    differentiates: its grads equal the plain backward's from the plain
    log-sum-exp."""
    s, offs, lens, causal, window = CASES["window"]
    q, k, v, do = _inputs(6, 128, 4, s)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tops.mha(*t, _i32(offs), _i32(lens), causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    _, _, want = _plain(q, k, v, do, offs, lens, causal, window)
    for x, w in zip(t, want):
        np.testing.assert_allclose(x.grad.numpy(), w.numpy(), **TOL)
