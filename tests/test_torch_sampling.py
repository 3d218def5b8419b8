"""The fused sampling kernel's plain PyTorch version against the JAX
package: the same numpy rows through ``fused_sample_plain``, the Pallas
kernel ``repro.kernels.sampling.fused_sample`` in interpret mode, its jnp
oracle ``fused_sample_reference``, and the port's host sampler
(``serving/sampling.py``, the bit-level oracle of the reference).

Rows: ``test_fused_sampling.py``'s six CASES and the trouble spots of the
kernel — a padded-vocab tail of -1e9, a negative kth value, top_k off
(>= V) and top_k = 1, many logits equal to the kth value, -0.0 and +0.0
at the top-k boundary, top_p near 1 and tiny, u = 0 and u just below 1,
all 8 bias slots, a repeated bias id and an id >= V, ties at the greedy
maximum — at V = 128 and V = 256.

Tolerance: the top-k keep set and greedy tokens are exact (integer
counts over identical keys), so ``token`` and ``alt`` must be equal on
every row except one whose u lies within 1e-5 of a non-zero cumulative
mass of the plain version (``cdf_margin``): there the order of the float
sums may move the draw to the neighbouring kept token.  Such rows are
counted and printed; a mismatch on any other row fails.  ``p_draft``
agrees within 1e-5 absolute (the JAX test's atol).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.kernels.sampling import MAX_BIAS as JMAX_BIAS  # noqa: E402
from repro.kernels.sampling import fused_sample as jfused  # noqa: E402
from repro.kernels.sampling import fused_sample_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sampling as ks  # noqa: E402
from repro_torch.serving.sampling import (SamplingParams,  # noqa: E402
                                          filtered_probs, sample_from_probs)

MARGIN = 1e-5
ATOL = 1e-5
MAX_BIAS = ks.MAX_BIAS

# test_fused_sampling.py's CASES
CASES = [
    SamplingParams(),
    SamplingParams(logit_bias={3: 5.0, 7: -4.0}),
    SamplingParams(temperature=1.0),
    SamplingParams(temperature=0.7, top_k=16),
    SamplingParams(temperature=1.3, top_p=0.9),
    SamplingParams(temperature=0.8, top_k=24, top_p=0.85,
                   logit_bias={11: 3.0, 40: 1.5, 90: -2.0}),
]


def _trouble_rows(v, rng):
    """(name, logits row, SamplingParams, u, draft, host_ok) for each
    trouble spot; ``host_ok`` is False where the reference kernel and
    the numpy host sampler differ by design (-0.0 keys below +0.0)."""
    rows = []

    def add(name, row, sp, u=None, draft=None, host_ok=True):
        rows.append((name, np.asarray(row, np.float32), sp,
                     np.float32(rng.random() if u is None else u),
                     int(rng.integers(0, v) if draft is None else draft),
                     host_ok))

    base = lambda: rng.normal(0.0, 3.0, v).astype(np.float32)  # noqa: E731
    pad = base()
    pad[v - 24:] = -1e9                      # padded-vocab columns
    add("padded_vocab", pad, SamplingParams(temperature=0.9, top_k=40))
    add("padded_vocab_greedy", pad, SamplingParams(logit_bias={v - 3: 1.0}))
    neg = -np.abs(base()) - 1.0              # every logit negative
    add("kth_negative", neg, SamplingParams(temperature=1.0, top_k=v // 3))
    half = base()
    half[: v // 2] = -np.abs(half[: v // 2]) - 0.5
    half[v // 2:] = np.abs(half[v // 2:]) + 0.5
    add("kth_negative_side", half,
        SamplingParams(temperature=0.6, top_k=v // 2 + 7))
    add("top_k_off", base(), SamplingParams(temperature=1.1, top_k=v + 5))
    add("top_k_eq_v", base(), SamplingParams(temperature=1.1, top_k=v))
    add("top_k_1", base(), SamplingParams(temperature=1.1, top_k=1))
    ties = np.round(base() / 2.0).astype(np.float32)  # many equal values
    add("ties_at_kth", ties, SamplingParams(temperature=1.0, top_k=10))
    zeros = base()
    zeros[:6] = [3.0, 2.5, 2.0, 0.0, 0.0, 0.0]
    zeros[6:9] = -0.0
    zeros[9:] = -np.abs(zeros[9:]) - 1.0
    add("signed_zeros", zeros, SamplingParams(temperature=1.0, top_k=5),
        host_ok=False)
    add("top_p_near_1", base(),
        SamplingParams(temperature=1.0, top_p=float(np.float32(0.999999))))
    add("top_p_tiny", base(), SamplingParams(temperature=1.2, top_p=1e-6))
    add("u_zero", base(), SamplingParams(temperature=1.0, top_k=8), u=0.0)
    add("u_below_1", base(), SamplingParams(temperature=2.0),
        u=np.float32(1.0) - np.float32(2.0 ** -24))
    add("u_below_1_flat", np.zeros(v, np.float32),
        SamplingParams(temperature=1.0), u=np.float32(1.0 - 2.0 ** -24))
    add("bias_all_slots", base(),
        SamplingParams(temperature=0.7, top_k=12,
                       logit_bias=tuple((int(t), 0.5 * (j + 1)) for j, t in
                                        enumerate(rng.choice(v, 8, False)))))
    add("bias_repeat_and_oob", base(),
        SamplingParams(temperature=0.9, top_p=0.8,
                       logit_bias=((5, 2.0), (5, 2.5), (v + 3, 9.0))))
    add("bias_greedy_repeat", base(),
        SamplingParams(logit_bias=((9, 4.0), (9, 4.0), (v, 50.0))))
    tie_max = base()
    tie_max[[17, 4, 60]] = 20.0              # equal maxima: lowest index
    add("greedy_tie", tie_max, SamplingParams(), draft=4)
    add("draft_minus_1", base(), SamplingParams(temperature=0.8, top_k=20),
        draft=-1, host_ok=False)
    return rows


def _encode(sp):
    ids = -np.ones(MAX_BIAS, np.int32)
    vals = np.zeros(MAX_BIAS, np.float32)
    for j, (tok, b) in enumerate(sp.logit_bias or ()):
        ids[j], vals[j] = tok, b
    return (np.float32(max(sp.temperature, 0.0)), np.int32(sp.top_k or 0),
            np.float32(sp.top_p if sp.top_p is not None else 1.0), ids, vals)


def _batch(v, seed):
    """Kernel inputs for CASES (random rows) plus the trouble rows, and
    the per-row (SamplingParams, host_ok, name)."""
    rng = np.random.default_rng(100 + seed)
    meta, logits, us, drafts = [], [], [], []
    for i, sp in enumerate(CASES):
        logits.append(rng.normal(0.0, 3.0, v).astype(np.float32))
        us.append(np.float32(rng.random()))
        drafts.append(int(rng.integers(0, v)))
        meta.append((sp, True, f"case{i}"))
    for name, row, sp, u, d, host_ok in _trouble_rows(v, rng):
        logits.append(row)
        us.append(u)
        drafts.append(d)
        meta.append((sp, host_ok, name))
    n = len(meta)
    temp = np.zeros(n, np.float32)
    top_k = np.zeros(n, np.int32)
    top_p = np.ones(n, np.float32)
    bids = -np.ones((n, MAX_BIAS), np.int32)
    bvals = np.zeros((n, MAX_BIAS), np.float32)
    for i, (sp, _, _) in enumerate(meta):
        temp[i], top_k[i], top_p[i], bids[i], bvals[i] = _encode(sp)
    args = (np.stack(logits), temp, top_k, top_p, bids, bvals,
            np.asarray(us, np.float32), np.asarray(drafts, np.int32))
    return args, meta


def _plain(args):
    out = ks.fused_sample_plain(torch.from_numpy(args[0]), *args[1:])
    margin = ks.cdf_margin(torch.from_numpy(args[0]), *args[1:])
    return [x.numpy() for x in out], margin.numpy()


def _held(got, want, margin, names, what):
    """token / alt equal except on rows within MARGIN of a CDF boundary;
    p_draft within ATOL.  Returns the names of the rows let through."""
    let = []
    for k in (0, 2):
        bad = np.nonzero(np.asarray(got[k]) != np.asarray(want[k]))[0]
        for i in bad:
            assert margin[i] < MARGIN, (what, names[i], k, got[k][i],
                                        want[k][i], margin[i])
            let.append(names[i])
    np.testing.assert_allclose(np.asarray(got[1], np.float32), want[1],
                               atol=ATOL, rtol=0, err_msg=what)
    if let:
        print(f"{what}: {len(let)} draws within {MARGIN} of a boundary "
              f"moved: {sorted(set(let))}")
    return let


def test_max_bias_is_the_reference_s():
    assert ks.MAX_BIAS == JMAX_BIAS == 8
    assert ops.MAX_BIAS == 8


@pytest.mark.parametrize("v", [128, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_and_reference(v, seed):
    args, meta = _batch(v, seed)
    names = [m[2] for m in meta]
    want, margin = _plain(args)
    pallas = [np.asarray(x) for x in jfused(*args, interpret=True)]
    ref = [np.asarray(x) for x in fused_sample_reference(*args)]
    _held(pallas, want, margin, names, f"pallas v={v} seed={seed}")
    _held(ref, want, margin, names, f"reference v={v} seed={seed}")
    # the exact parts: greedy tokens and the top-k keep set
    greedy = args[1] <= 0
    assert (want[0][greedy] == pallas[0][greedy]).all()


@pytest.mark.parametrize("v", [128, 256])
def test_plain_matches_the_host_sampler(v):
    """The port's numpy host sampler (the reference's bit-level oracle)
    gives the same (token, p_draft, alt) triple."""
    args, meta = _batch(v, 3)
    want, margin = _plain(args)
    logits, _, _, _, _, _, u, draft = args
    rows = [i for i, m in enumerate(meta) if m[1]]
    host = [[], [], []]
    for i in rows:
        sp, row, d = meta[i][0], logits[i], int(draft[i])
        if sp.is_greedy:
            biased = row.copy()
            for tok, b in sp.logit_bias or ():
                if 0 <= int(tok) < v:
                    biased[int(tok)] += np.float32(b)
            g = int(np.argmax(biased))
            trip = (g, float(g == d), g)
        else:
            probs = filtered_probs(row, sp)
            tok = sample_from_probs(probs, float(u[i]))
            resid = probs.copy()
            resid[d] = 0.0
            mass = resid.sum()
            trip = (tok, float(probs[d]),
                    sample_from_probs(resid / mass, float(u[i]))
                    if mass > 0 else tok)
        for k in range(3):
            host[k].append(trip[k])
    sub = [x[rows] for x in want]
    _held([np.asarray(h) for h in host], sub, margin[rows],
          [meta[i][2] for i in rows], f"host v={v}")


def test_draft_accept_semantics():
    """test_fused_sampling.py's accept-semantics case on the plain
    version: a point-mass draft gets p_draft ~ 1, a truncated-out draft
    exactly 0, and the residual excludes the draft."""
    rng = np.random.default_rng(7)
    v = 128
    logits = rng.normal(0.0, 1.0, (2, v)).astype(np.float32)
    logits[0, 5] = 40.0
    worst = int(np.argmin(logits[1]))
    args = (torch.from_numpy(logits), np.array([0.9, 0.9], np.float32),
            np.array([0, 4], np.int32), np.ones(2, np.float32),
            -np.ones((2, MAX_BIAS), np.int32),
            np.zeros((2, MAX_BIAS), np.float32),
            np.array([0.5, 0.5], np.float32), np.array([5, worst], np.int32))
    tok, p_d, alt = ks.fused_sample_plain(*args)
    assert float(p_d[0]) > 0.999
    assert float(p_d[1]) == 0.0
    assert int(alt[0]) != 5
    sp = SamplingParams(temperature=0.9, top_k=4)
    assert int(tok[1]) == sample_from_probs(filtered_probs(logits[1], sp),
                                            0.5)


def test_ops_dispatch_follows_the_device():
    """A CPU tensor reaches the plain version (no launch counted); the
    launcher refuses a CPU tensor; a meta tensor takes the CUDA branch,
    whose launcher allocates the outputs by shape and launches nothing
    (the dry run's footprint)."""
    args, _ = _batch(128, 4)
    n0 = ks.fused_sample.launches
    got = ops.fused_sample(torch.from_numpy(args[0]), *args[1:])
    want, _ = _plain(args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert ks.fused_sample.launches == n0
    with pytest.raises(ValueError, match="CUDA kernel"):
        ks.fused_sample(torch.from_numpy(args[0]), *args[1:])
    tok, p_d, alt = ops.fused_sample(torch.empty((2, 8), device="meta"),
                                     *[a[:2] for a in args[1:]])
    assert all(x.is_meta and x.shape == (2,) for x in (tok, p_d, alt))
    assert ks.fused_sample.launches == n0


def test_float64_uniforms_are_cast_like_the_engine():
    """The engine ships float64 uniforms from each session's numpy rng
    cast to float32 (``np.zeros(r, np.float32)``); the plain version
    takes float64 host arrays the same way."""
    args, _ = _batch(128, 5)
    u64 = args[6].astype(np.float64) + 1e-12
    want, _ = _plain(args)
    got = ks.fused_sample_plain(torch.from_numpy(args[0]), *args[1:6], u64,
                                args[7])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
