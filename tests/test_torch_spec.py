"""Speculative decoding and fused sampling of the PyTorch port against the
JAX package, on the smoke config in fp32 with weights converted from the
JAX pytree, on both arena families (``paged_kv`` True and False).

The cases of ``test_spec_decode.py``, each run through both engines:

* greedy speculation is lossless — at every draft quality the stream
  equals the plain decode — and equals the JAX stream, with identical
  counters, per-session acceptance, pages and refcounts (``audit()``);
* ``NGramDraft`` is lossless;
* a sampled session (temperature, top-k, top-p, a bias) gives the same
  stream through the host verify path and the fused sampling path, and
  the JAX engine's stream;
* ``PagedKVArena.truncate`` replayed against the JAX arena over random
  extend / commit / fork / truncate sequences: equal pages, refcounts,
  radix pages and free lists, ``audit()`` green (the forms of
  ``test_truncate_property.py``: hypothesis and a seeded replay);
* the serve loop armed with ``NGramDraft`` gives the unarmed loop's
  transcripts, ``2 x budget`` TPOT samples and the tracker's spec
  counters (``test_loop_lifecycle.py``), equal to the JAX loop's;
* ``benchmarks/bench_spec.py``'s scenario gives the JAX engine's
  counters: the spec and plain rows equal the committed
  ``BENCH_spec.json``; the fused_sampled row equals the JAX run in the
  same test, draw for draw, except where a draw's u lies within 1e-5 of
  a cumulative mass of the plain sampler (the order of float sums may
  move such a draw; from that draw on the streams may fork).
"""
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro.kernels.ops as jops  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.kernels.ops as tops  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import H200_QWEN32B, Variant, make_policy  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import draft as jdraft  # noqa: E402
from repro.serving.kvcache import PagedKVArena as JPaged  # noqa: E402
from repro.serving.loop import ServeLoop as JLoop  # noqa: E402
from repro.serving.sampling import SamplingParams as JSP  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.kernels.sampling import cdf_margin  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import draft as tdraft  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.kvcache import KVArena, PagedKVArena  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

ROOT = Path(__file__).resolve().parent.parent
MARGIN = 1e-5
SIDES = ("jax", "torch")
DRAFTS = {"jax": jdraft, "torch": tdraft}
PARAMS = {"jax": JSP, "torch": SamplingParams}
SPEC_KEYS = ("tokens_drafted", "tokens_accepted", "spec_dispatches",
             "spec_committed", "spec_acceptance", "spec_tokens_per_dispatch",
             "spec_by_session", "logits_rows_shipped", "fused_sample_steps",
             "fused_greedy_steps", "arena_gathers", "arena_scatters",
             "packed_dispatches", "packed_shapes_by_kind",
             "decode_dispatches", "mixed_steps", "decode_tokens_fused",
             "prefix_hit_tokens")


def _stack(seed):
    cfg = get_smoke("qwen3-4b")
    params, _ = jtr.init_params(cfg, jax.random.key(seed))
    tcfg = tget("qwen3-4b")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return {"jax": lambda **kw: JEngine(cfg, params, JConfig(**kw)),
            "torch": lambda **kw: Engine(tcfg, tp, EngineConfig(**kw),
                                         device="cpu"),
            "vocab": cfg.vocab_size}


@pytest.fixture(scope="module")
def smoke():
    """test_spec_decode.py's weights (key 7)."""
    return _stack(7)


def _engine(make, paged, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 96)
    kw.setdefault("chunk_tokens", 16)
    kw.setdefault("keep_last_logits", False)
    return make(paged_kv=paged, **kw)


def _spec_run(eng, prompt, n, sampling=None):
    eng.open_session(0)
    if sampling is not None:
        eng.set_sampling(0, sampling)
    t0 = eng.prefill_packed([0], [prompt])[0]
    out, cur = [t0], t0
    while len(out) < n:
        got = eng.spec_step([(0, cur)], max_new={0: n - len(out)})[0]
        assert 1 <= len(got) <= n - len(out)
        out.extend(got)
        cur = got[-1]
    return out[:n]


def _base(make, paged, prompt, steps):
    eng = _engine(make, paged)
    eng.open_session(0)
    t0 = eng.prefill_packed([0], [prompt])[0]
    return [t0] + eng.decode_batch([0], [t0], steps=steps)[0]


def _same_state(engines, paged):
    """Counters, per-session stats, and (paged) page tables, refcounts,
    radix pages and free lists equal on both engines; audit green."""
    js, ts = (engines[s].stats() for s in SIDES)
    assert {k: ts[k] for k in SPEC_KEYS} == {k: js[k] for k in SPEC_KEYS}
    if paged:
        ja, ta = engines["jax"].arena, engines["torch"].arena
        ta.audit()
        assert ta._pages == ja._pages and ta._tokens == ja._tokens
        assert ta._refcount == ja._refcount
        assert sorted(ta._free) == sorted(ja._free)
        assert sorted(ta.index.pages()) == sorted(ja.index.pages())
    else:
        assert engines["torch"].arena.lengths == engines["jax"].arena.lengths
    return ts


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_spec_lossless_matches_jax(smoke, paged):
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, smoke["vocab"], 12)
    base = {s: _base(smoke[s], paged, prompt, 14) for s in SIDES}
    assert base["torch"] == base["jax"]
    for accept in (1.0, 0.0):
        engines = {}
        for s in SIDES:
            engines[s] = eng = _engine(smoke[s], paged)
            eng.enable_spec(DRAFTS[s].ScriptedDraft(
                {0: base[s]}, accept=accept, vocab=smoke["vocab"], seed=3),
                k=4)
            assert _spec_run(eng, prompt, 15) == base[s], (s, accept)
        st = _same_state(engines, paged)
        assert st["logits_rows_shipped"] == 0 and st["arena_gathers"] == 0
        assert st["spec_dispatches"] > 0
        if accept == 1.0:
            assert st["spec_tokens_per_dispatch"] > 1.8
            assert st["spec_acceptance"] == 1.0


@pytest.mark.parametrize("paged", [False, True])
def test_ngram_spec_lossless_matches_jax(smoke, paged):
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, smoke["vocab"], 10)
    engines = {}
    for s in SIDES:
        base = _base(smoke[s], paged, prompt, 12)
        engines[s] = eng = _engine(smoke[s], paged)
        eng.enable_spec(DRAFTS[s].NGramDraft(n=3), k=4)
        assert _spec_run(eng, prompt, 13) == base
    _same_state(engines, paged)


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_spec_host_fused_parity(smoke, paged):
    """Rejection sampling under temperature / top-k / top-p / bias: the
    host verify path and the fused kernel path consume one rng protocol
    and give the same stream, the JAX engine's; only the host path ships
    logits rows."""
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, smoke["vocab"], 9)
    script = list(np.random.default_rng(99).integers(1, smoke["vocab"], 40))
    streams, engines = {}, {}
    for fused in (False, True):
        for s in SIDES:
            sp = PARAMS[s](temperature=0.8, top_k=20, top_p=0.95, seed=7,
                           logit_bias={3: 2.0})
            eng = _engine(smoke[s], paged, fused_sampling=fused)
            eng.enable_spec(DRAFTS[s].ScriptedDraft(
                {0: script}, accept=1.0, vocab=smoke["vocab"], seed=0), k=3)
            streams[fused, s] = _spec_run(eng, prompt, 12, sampling=sp)
            engines[s] = eng
        st = _same_state(engines, paged)
        if fused:
            assert st["logits_rows_shipped"] == 0
            assert st["fused_sample_steps"] > 0
        else:
            assert st["logits_rows_shipped"] > 0
    assert len(set(map(tuple, streams.values()))) == 1, streams


@pytest.mark.parametrize("paged", [False, True])
def test_spec_counters_and_session_stats(smoke, paged):
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, smoke["vocab"], 8)
    engines = {}
    for s in SIDES:
        base = _base(smoke[s], paged, prompt, 10)
        engines[s] = eng = _engine(smoke[s], paged)
        eng.enable_spec(DRAFTS[s].ScriptedDraft(
            {0: base}, accept=1.0, vocab=smoke["vocab"], seed=0), k=4)
        _spec_run(eng, prompt, 11)
    st = _same_state(engines, paged)
    assert st["tokens_accepted"] == st["tokens_drafted"] > 0
    assert st["spec_committed"] == 10
    assert st["spec_by_session"][0]["acceptance"] == 1.0


def test_many_bias_entries_keep_the_host_path(smoke):
    """A session with more than MAX_BIAS bias entries samples on the host
    even with fused_sampling=True (the reference's ``_fused_bias_ok``)."""
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, smoke["vocab"], 9)
    out = {}
    for s in SIDES:
        bias = {int(t): 0.5 for t in range(1, 11)}
        eng = _engine(smoke[s], True, fused_sampling=True)
        eng.open_session(0)
        eng.set_sampling(0, PARAMS[s](temperature=0.9, seed=3,
                                      logit_bias=bias))
        t0 = eng.prefill_packed([0], [prompt])[0]
        out[s] = [t0] + eng.decode_batch([0], [t0], steps=4)[0]
        st = eng.stats()
        assert st["fused_sample_steps"] == 0 and st["logits_rows_shipped"]
    assert out["torch"] == out["jax"]


# ------------------------------------------------ truncate replay (paged)
NUM_PAGES, PS, MAX_LEN = 12, 4, 34


def _snapshot(ar):
    return (sorted(ar._free), list(ar._refcount),
            {s: list(p) for s, p in ar._pages.items()},
            {s: list(t) for s, t in ar._tokens.items()},
            dict(ar.lengths), sorted(ar.index.pages()))


def _drive_paged_pair(rng):
    """test_truncate_property's speculate / commit / fork / rollback
    machine, every op applied to the port's and the JAX arena."""
    ars = (PagedKVArena(None, NUM_PAGES, PS, MAX_LEN),
           JPaged(None, NUM_PAGES, PS, MAX_LEN))

    def both(fn):
        for ar in ars:
            fn(ar)
        ars[0].audit()
        ars[1].audit()
        assert _snapshot(ars[0]) == _snapshot(ars[1])

    def commit(s, toks):
        def op(ar):
            if toks:
                ar.prepare_extend(s, len(toks))
            ar.commit(s, list(toks))
        both(op)

    both(lambda ar: ar.open(0))
    commit(0, [int(t) for t in rng.integers(1, 50, int(rng.integers(1, 9)))])
    forked = False
    for _ in range(12):
        op = int(rng.integers(0, 3))
        s = 1 if forked and rng.integers(0, 2) else 0
        ar = ars[0]
        h = ar.length(s)
        if op == 0 and not forked and h >= PS:
            both(lambda a: a.fork(0, 1))
            forked = True
        elif op == 1:
            k = int(rng.integers(1, 6))
            if h + k > MAX_LEN - 2 or ar.free_pages < -(-k // PS) + 1:
                continue
            before = _snapshot(ar)
            cow = ar.pages_cow_forked
            c = int(rng.integers(0, k + 1))
            toks = [int(t) for t in rng.integers(1, 50, c)]
            both(lambda a: a.prepare_extend(s, k))       # the verify write
            both(lambda a: a.commit(s, toks))
            both(lambda a: a.truncate(s, h + c))         # reject the tail
            assert ar.length(s) == h + c
            if c == 0 and ar.pages_cow_forked == cow:
                assert _snapshot(ar) == before
        elif h + 1 <= MAX_LEN - 2 and ar.free_pages > 1:
            commit(s, [int(rng.integers(1, 50))])
    if forked:
        parent = list(ars[0]._pages[0])
        both(lambda a: a.truncate(1, 0))
        assert all(ars[0]._refcount[p] >= 1 for p in parent)
        assert ars[0]._pages[0] == parent
        both(lambda a: a.free(1))
    for n in (ars[0].length(0) + 1, -1):
        for a in ars:
            with pytest.raises(ValueError):
                a.truncate(0, n)
    both(lambda a: a.free(0))


def _drive_slot(rng, ar):
    ar.alloc(0)
    try:
        h = 0
        for _ in range(24):
            k = int(rng.integers(1, 6))
            if h + k > ar.max_len - 2:
                ar.truncate(0, 0)
                h = 0
                continue
            ar.set_length(0, h + k)
            c = int(rng.integers(0, k + 1))
            ar.truncate(0, h + c)
            assert ar.length(0) == h + c
            h += c
        for n in (h + 1, -1):
            with pytest.raises(ValueError):
                ar.truncate(0, n)
    finally:
        ar.free(0)


@pytest.fixture(scope="module")
def slot_arena():
    return KVArena(tget("qwen3-4b"), num_slots=2, max_len=32, device="cpu")


if HAVE_HYPOTHESIS:
    @given(seed=st.integers(0, 2 ** 32 - 1))
    @settings(max_examples=60, deadline=None)
    def test_paged_truncate_matches_jax_hypothesis(seed):
        _drive_paged_pair(np.random.default_rng(seed))


def test_paged_truncate_matches_jax_replay():
    for seed in range(40):
        _drive_paged_pair(np.random.default_rng(seed))


def test_slot_truncate_roundtrip_replay(slot_arena):
    for seed in range(30):
        _drive_slot(np.random.default_rng(seed), slot_arena)


# ------------------------------------------------------------- serve loop
def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


@pytest.fixture(scope="module")
def loop_stack():
    """test_loop_lifecycle.py's weights (key 11)."""
    return _stack(11)


def _loop(side, make):
    engine = make(num_slots=4, max_len=96, chunk_tokens=16, measure=False)
    if side == "jax":
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=24, chunk_tokens=16)
        return JLoop(engine, policy, slo_ttft=30.0, clock=_stepping_clock())
    policy = tcore.make_policy(tcore.Variant("pla_full"), tcore.H200_QWEN32B,
                               threshold=24, chunk_tokens=16)
    return ServeLoop(engine, policy, slo_ttft=30.0, clock=_stepping_clock())


def test_loop_spec_stream_matches_jax(loop_stack):
    """test_loop_lifecycle's spec case through both loops: arming
    speculation changes neither the transcripts nor the number of TPOT
    samples (one per decoded token), and the tracker mirrors the
    engine's spec counters — on the port as on the reference."""
    rng = np.random.default_rng(5)
    prompts = {0: rng.integers(1, loop_stack["vocab"], 9),
               1: rng.integers(1, loop_stack["vocab"], 12)}
    budget = 8
    runs = {}
    for side in SIDES:
        for spec in (False, True):
            loop = _loop(side, loop_stack[side])
            if spec:
                loop.engine.enable_spec(DRAFTS[side].NGramDraft(n=3), k=4)
            for s, p in prompts.items():
                loop.submit(s, p, decode_tokens=budget)
            loop.run_until_idle(max_wall=240.0)
            runs[side, spec] = loop
    gen = {key: {s: list(lp.generated[s]) for s in prompts}
           for key, lp in runs.items()}
    assert len({json.dumps(g, sort_keys=True) for g in gen.values()}) == 1
    for side in SIDES:
        loop = runs[side, True]
        assert len(loop.tpot_samples) == 2 * budget
        rep = loop.tracker.report()
        assert rep.spec_dispatches == loop.engine.spec_dispatches > 0
        assert rep.tokens_drafted == loop.engine.tokens_drafted
        assert rep.tokens_accepted == loop.engine.tokens_accepted
    assert len({(r.spec_dispatches, r.tokens_drafted, r.tokens_accepted)
                for r in (runs[s, True].tracker.report()
                          for s in SIDES)}) == 1


# ------------------------------------------------------ bench_spec scenario
K, BUDGET, ACCEPT = 4, 48, 0.7          # bench_spec.py's constants


def _kv_row_bytes(cfg) -> int:
    return (2 * cfg.num_layers * cfg.num_kv_heads * cfg.hdim
            * np.dtype(cfg.np_dtype).itemsize)


def _bench_plain(eng, prompt, kvb):
    """bench_spec._drive_plain."""
    eng.open_session(0)
    t0 = eng.prefill_packed([0], [prompt])[0]
    stream, cur, hbm = [t0], t0, 0.0
    for _ in range(BUDGET):
        hbm += (eng.history(0) + 1) * kvb
        cur = eng.decode_batch([0], [cur], steps=1)[0][0]
        stream.append(cur)
    st = eng.stats()
    disp = eng.decode_executor.dispatches
    return stream, {"dispatches": disp,
                    "tokens_per_dispatch": round(BUDGET / max(disp, 1), 2),
                    "hbm_bytes_per_token": round(hbm / BUDGET, 1),
                    "logits_rows_shipped": st["logits_rows_shipped"],
                    "arena_gathers": st["arena_gathers"],
                    "arena_scatters": st["arena_scatters"]}


def _bench_spec(eng, draft, prompt, kvb, sampling=None):
    """bench_spec._drive_spec."""
    eng.enable_spec(draft, k=K)
    eng.open_session(0)
    if sampling is not None:
        eng.set_sampling(0, sampling)
    t0 = eng.prefill_packed([0], [prompt])[0]
    stream, cur, hbm = [t0], t0, 0.0
    while len(stream) < 1 + BUDGET:
        hbm += (eng.history(0) + 1 + K) * kvb
        got = eng.spec_step([(0, cur)],
                            max_new={0: 1 + BUDGET - len(stream)})[0]
        stream.extend(got)
        cur = got[-1]
    st = eng.stats()
    return stream, {"dispatches": st["spec_dispatches"],
                    "tokens_per_dispatch": st["spec_tokens_per_dispatch"],
                    "acceptance": st["spec_acceptance"],
                    "tokens_drafted": st["tokens_drafted"],
                    "tokens_accepted": st["tokens_accepted"],
                    "hbm_bytes_per_token": round(hbm / BUDGET, 1),
                    "logits_rows_shipped": st["logits_rows_shipped"],
                    "fused_sample_steps": st["fused_sample_steps"],
                    "arena_gathers": st["arena_gathers"],
                    "arena_scatters": st["arena_scatters"]}


def _record(monkeypatch, module, calls):
    """Wrap ``module.fused_sample`` to keep each call's inputs and
    outputs as numpy arrays.  The logits are copied: they are a step
    graph's output, which the next replay overwrites."""
    inner = module.fused_sample

    def wrapped(logits, *rest):
        out = inner(logits, *rest)
        calls.append(([np.array(logits, np.float32)] +
                      [np.asarray(x) for x in rest],
                      [np.asarray(x) for x in out]))
        return out

    monkeypatch.setattr(module, "fused_sample", wrapped)


def _first_fork(jcalls, tcalls):
    """Hold the two packages' fused-sampling calls draw for draw: equal
    tokens and alts, p_draft within 1e-5, until the first call whose
    draws differ; every differing draw of that call must have its u
    within MARGIN of a non-zero cumulative mass of the plain sampler.
    Returns (call index, rows) of that fork, or None."""
    for n, ((jin, jout), (tin, tout)) in enumerate(zip(jcalls, tcalls)):
        for a, b in zip(jin, tin):
            np.testing.assert_array_equal(a.shape, b.shape)
        np.testing.assert_allclose(tin[0], jin[0], atol=1e-4, rtol=0)
        for a, b in zip(jin[1:], tin[1:]):
            np.testing.assert_array_equal(np.asarray(a, b.dtype), b)
        np.testing.assert_allclose(tout[1], jout[1], atol=1e-5, rtol=0)
        rows = np.nonzero((tout[0] != jout[0]) | (tout[2] != jout[2]))[0]
        if len(rows):
            margin = cdf_margin(torch.from_numpy(jin[0]), *jin[1:]).numpy()
            assert (margin[rows] < MARGIN).all(), (n, rows, margin[rows])
            return n, rows
    return None


def test_bench_spec_scenario_counters(monkeypatch):
    """``bench_spec.spec_scenario``'s three runs on both engines (the
    bench's weights, key 0; its prompt, rng 9).  The spec and plain rows
    equal the committed BENCH_spec.json; the fused_sampled row equals the
    JAX run's, draw for draw up to a fork the margin rule allows."""
    stack = _stack(0)
    cfg = get_smoke("qwen3-4b")
    kvb = _kv_row_bytes(cfg)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab_size, 11)
    committed = {r["tag"]: r for r in
                 json.loads((ROOT / "BENCH_spec.json").read_text())}
    rows, streams = {}, {}
    calls = {"jax": [], "torch": []}
    _record(monkeypatch, jops, calls["jax"])
    _record(monkeypatch, tops, calls["torch"])
    for s in SIDES:
        make = stack[s]
        streams[s, "plain"], rows[s, "plain"] = _bench_plain(
            _engine(make, True, max_len=128), prompt, kvb)
        script = streams[s, "plain"]
        draft = DRAFTS[s].ScriptedDraft({0: script}, accept=ACCEPT,
                                        vocab=cfg.vocab_size, seed=1)
        streams[s, "spec"], rows[s, "spec"] = _bench_spec(
            _engine(make, True, max_len=128), draft, prompt, kvb)
        draft = DRAFTS[s].ScriptedDraft({0: script}, accept=ACCEPT,
                                        vocab=cfg.vocab_size, seed=1)
        sp = PARAMS[s](temperature=0.8, top_k=32, top_p=0.95, seed=17)
        streams[s, "fused"], rows[s, "fused"] = _bench_spec(
            _engine(make, True, max_len=128, fused_sampling=True), draft,
            prompt, kvb, sampling=sp)
    for s in SIDES:
        assert streams[s, "spec"] == streams[s, "plain"]      # lossless
        for tag in ("spec", "plain"):
            want = {k: committed[tag][k] for k in rows[s, tag]}
            assert rows[s, tag] == want, (s, tag)
        assert len(streams[s, "fused"]) == 1 + BUDGET
        for tag in ("spec", "plain", "fused"):
            r = rows[s, tag]
            assert r["logits_rows_shipped"] == 0
            assert r["arena_gathers"] == r["arena_scatters"] == 0
        assert rows[s, "fused"]["fused_sample_steps"] > 0
    assert streams["torch", "plain"] == streams["jax", "plain"]
    fork = _first_fork(calls["jax"], calls["torch"])
    if fork is None:
        assert streams["torch", "fused"] == streams["jax", "fused"]
        assert rows["torch", "fused"] == rows["jax", "fused"]
    else:
        print(f"fused_sampled: the streams fork at fused-sampling call "
              f"{fork[0]}, rows {list(fork[1])}, within {MARGIN} of a "
              f"CDF boundary")
