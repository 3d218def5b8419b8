"""The reference's paged-arena bench scenarios, driven through both
packages with the port's own trace generator and cost model
(``repro_torch.data.synthetic``, ``repro_torch.sim.costmodel``): the
stateless multi-turn chat of ``benchmarks/bench_mix.py``
(``_drive_multiturn``: radix prefix reuse against the same paged engine
re-prefilling every turn, the ``BENCH_multiturn.json`` rows), its
chunk-level matching against the submit-only probe
(``_drive_paged_chunk``) and its cold-miss coalescing
(``_drive_paged_coalesce``), the ``chunk_matching`` / ``submit_only`` /
``coalesce`` rows of ``BENCH_paged.json``.  The traffic is copied here
with the bench's rng seeds; the loops run on a stepping clock with
``measure=False``.  The port's engine must count exactly what the JAX
engine counts, and both must equal the committed rows.  The spill rows
wait for the host spill tier (ROADMAP item 11).

Also: the port's ``gen_multiturn_sessions`` and ``CostModel`` give the
reference's outputs over a few seeds and shapes.
"""
import dataclasses
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

import repro.core as jcore  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.sim import costmodel as jcost  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sim import costmodel as tcost  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _rows(name):
    return {r["tag"]: r for r in json.loads((ROOT / name).read_text())}


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


@pytest.fixture(scope="module")
def sides():
    """{package: (engine factory, loop factory)} on the bench's weights."""
    cfg = get_smoke("qwen3-4b")
    params, _ = jtr.init_params(cfg, jax.random.key(0))
    tcfg = tget("qwen3-4b")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")

    def jengine(**kw):
        return jserving.Engine(cfg, params, jserving.EngineConfig(**kw))

    def tengine(**kw):
        return tserving.Engine(tcfg, tp, tserving.EngineConfig(**kw),
                               device="cpu")

    def loop_of(core, serving, make):
        def paged_loop():
            """``bench_mix._paged_loop``: the default paged stack."""
            eng = make(num_slots=6, max_len=128, page_size=8,
                       chunk_tokens=16, token_buckets=(16, 32),
                       decode_buckets=(1, 2, 4), measure=False)
            pol = core.make_policy(core.Variant("pla_full"),
                                   core.H200_QWEN32B, threshold=32,
                                   chunk_tokens=16)
            return eng, serving.ServeLoop(eng, pol, slo_ttft=30.0,
                                          clock=_stepping_clock())
        return paged_loop

    return cfg, {
        "jax": (jengine, loop_of(jcore, jserving, jengine), jsyn, jcost),
        "torch": (tengine, loop_of(tcore, tserving, tengine), tsyn, tcost),
    }


# ------------------------------------------------------ multi-turn reuse
def _drive_multiturn(cfg, make, syn, cost, reuse, page_size=16,
                     max_len=256):
    """``bench_mix._drive_multiturn``: every turn submits the FULL
    conversation under a fresh session id and closes it afterwards, so
    only the radix prefix index carries KV across turns."""
    eng = make(num_slots=16, max_len=max_len, chunk_tokens=64, packed=True,
               packed_max_seqs=8, token_buckets=(64, 256), paged_kv=True,
               page_size=page_size, prefix_cache=reuse)
    trace = syn.gen_multiturn_sessions(syn.MultiTurnConfig(
        vocab_size=cfg.vocab_size, num_sessions=6, system_len=48,
        suffix_lo=8, suffix_hi=32, max_turns=4, seed=11))
    kv_row_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.hdim
                    * np.dtype(cfg.np_dtype).itemsize)
    prompt_tokens = prefilled = 0
    hbm_bytes = 0.0
    late_overpay = []
    tokens = {}
    sid = 1000
    for u in trace:
        hit0 = eng.stats()["prefix_hit_tokens"]
        eng.open_session(sid)
        tokens[sid] = eng.step_mixed([(sid, u.tokens)], []).tokens[sid]
        matched = eng.stats()["prefix_hit_tokens"] - hit0
        new = len(u.tokens) - matched
        prompt_tokens += len(u.tokens)
        prefilled += new
        hbm_bytes += cost.packed_hbm_bytes_per_step(
            [new], [matched], max_len, 1, kv_row_bytes, arena=True)
        if u.turn >= 1:
            late_overpay.append(new - u.suffix)
        eng.close_session(sid)
        sid += 1
    st = eng.stats()
    return {
        "turns": len(trace),
        "prompt_tokens": prompt_tokens,
        "prefilled_tokens": prefilled,
        "prefix_hit_rate": round(st["prefix_hit_tokens"]
                                 / max(prompt_tokens, 1), 3),
        "max_turn_overpay": max(late_overpay) if late_overpay else 0,
        "page_size": page_size,
        "hbm_bytes_total": round(hbm_bytes, 1),
        "pages_evicted": st["pages_evicted"],
        "arena_gathers": st["arena_gathers"],
        "arena_scatters": st["arena_scatters"],
        "packed_dispatches": st["packed_dispatches"],
        "dense_dispatches": st["dense_dispatches"],
    }, tokens


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "noreuse"])
def test_bench_multiturn_rows(sides, reuse):
    """The port's engine, trace and HBM model give the JAX engine's
    counters and first tokens, and the committed row."""
    cfg, s = sides
    got, gtok = _drive_multiturn(cfg, s["torch"][0], s["torch"][2],
                                 s["torch"][3], reuse)
    want, wtok = _drive_multiturn(cfg, s["jax"][0], s["jax"][2],
                                  s["jax"][3], reuse)
    assert got == want and gtok == wtok
    bench = _rows("BENCH_multiturn.json")["reuse" if reuse else "noreuse"]
    assert got == {k: bench[k] for k in got}


# ------------------------------------------- chunk matching, coalescing
def _drive_paged_chunk(cfg, paged_loop, chunk_matching):
    """``bench_mix._drive_paged_chunk``: two long prompts sharing a
    48-token prefix submitted together (only chunk-boundary re-probes
    adopt the filler's pages), then each conversation returns with 16
    more tokens under a fresh session."""
    rng = np.random.default_rng(17)
    shared = rng.integers(0, cfg.vocab_size, 48)
    tails = [rng.integers(0, cfg.vocab_size, 16) for _ in range(2)]
    eng, loop = paged_loop()
    loop.chunk_matching = chunk_matching
    for s in range(2):
        loop.submit(s, np.concatenate([shared, tails[s]]), decode_tokens=1)
    loop.run_until_idle(max_wall=1e6)
    for s in range(2):
        loop.close_session(s)
    for s in range(2):
        turn2 = np.concatenate([shared, tails[s],
                                rng.integers(0, cfg.vocab_size, 16)])
        loop.submit(10 + s, turn2, decode_tokens=1)
        loop.run_until_idle(max_wall=1e6)
    st = eng.stats()
    eng.arena.audit()
    return {
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "chunk_hit_tokens": st["chunk_hit_tokens"],
        "coalesced_prefills": loop.coalesced_prefills,
        "arena_gathers": st["arena_gathers"],
        "arena_scatters": st["arena_scatters"],
    }, dict(loop.generated)


@pytest.mark.parametrize("chunk_matching", [True, False],
                         ids=["chunk_matching", "submit_only"])
def test_bench_paged_chunk_rows(sides, chunk_matching):
    cfg, s = sides
    got = _drive_paged_chunk(cfg, s["torch"][1], chunk_matching)
    assert got == _drive_paged_chunk(cfg, s["jax"][1], chunk_matching)
    bench = _rows("BENCH_paged.json")[
        "chunk_matching" if chunk_matching else "submit_only"]
    assert got[0] == {k: bench[k] for k in got[0]}


def _drive_paged_coalesce(cfg, paged_loop, n=5):
    """``bench_mix._drive_paged_coalesce``: N identical cold submits
    arrive together and the shared full-page prefix fills once."""
    rng = np.random.default_rng(29)
    eng, loop = paged_loop()
    prompt = rng.integers(0, cfg.vocab_size, 24)
    for s in range(n):
        loop.submit(s, prompt, decode_tokens=1)
    loop.run_until_idle(max_wall=1e6)
    st = eng.stats()
    return {
        "submits": n,
        "coalesced_prefills": loop.coalesced_prefills,
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "shared_prefix_tokens": (len(prompt) - 1) // 8 * 8,
        "prefilled_tokens": st["packed_useful_tokens"]
        - st["decode_tokens_fused"],
    }, dict(loop.generated)


def test_bench_paged_coalesce_row(sides):
    cfg, s = sides
    got = _drive_paged_coalesce(cfg, s["torch"][1])
    assert got == _drive_paged_coalesce(cfg, s["jax"][1])
    bench = _rows("BENCH_paged.json")["coalesce"]
    assert got[0] == {k: bench[k] for k in got[0]}


# ------------------------------------------------ trace and cost model
@pytest.mark.parametrize("seed,kw", [
    (0, {}), (11, dict(num_sessions=6, system_len=48, max_turns=4)),
    (3, dict(num_sessions=12, num_system_prompts=3, suffix_lo=1,
             suffix_hi=64, zipf_a=1.3))])
def test_multiturn_trace_matches_reference(seed, kw):
    got = tsyn.gen_multiturn_sessions(tsyn.MultiTurnConfig(
        vocab_size=500, seed=seed, **kw))
    want = jsyn.gen_multiturn_sessions(jsyn.MultiTurnConfig(
        vocab_size=500, seed=seed, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        np.testing.assert_array_equal(gd.pop("tokens"), wd.pop("tokens"))
        assert gd == wd
    rg = tsyn.multiturn_requests(tsyn.MultiTurnConfig(vocab_size=500,
                                                      seed=seed, **kw), 4)
    rw = jsyn.multiturn_requests(jsyn.MultiTurnConfig(vocab_size=500,
                                                      seed=seed, **kw), 4)
    key = ("new_tokens", "arrival", "session", "decode_tokens",
           "reusable_prefix")
    assert [tuple(getattr(r, k) for k in key) for r in rg] == \
        [tuple(getattr(r, k) for k in key) for r in rw]


def _costs(core, cost, seed):
    rng = np.random.default_rng(seed)
    out = []
    for model in (cost.H200_32B, cost.H200_14B, cost.H200_7B,
                  dataclasses.replace(cost.H200_32B, window=128,
                                      page_size=16, beta_tail=1e-5)):
        for _ in range(6):
            ls = [int(x) for x in rng.integers(1, 600, rng.integers(1, 5))]
            hs = [int(x) for x in rng.integers(0, 900, len(ls))]
            reqs = [core.Request(new_tokens=l, history_tokens=h)
                    for l, h in zip(ls, hs)]
            packed = core.Batch(reqs, token_bucket=-(-sum(ls) // 64) * 64,
                                uses_graph=True,
                                decode_tokens=int(rng.integers(0, 4)))
            dense = core.Batch(reqs, bucket_len=max(ls), uses_graph=False)
            chunk = core.ChunkWork(reqs[0], chunk_tokens=64,
                                   done_tokens=hs[0], is_last=False,
                                   decode_tokens=2, uses_graph=True)
            out += [model.handoff_time(hs[0]), model.single(ls[0], hs[0]),
                    model.predicted_ttft(ls[0], hs[0], len(ls), sum(ls), 3),
                    model.packed_batch_time(packed),
                    model.batch_time(dense), model.batch_time(packed),
                    model.chunk_time(chunk), model.work_time(chunk),
                    model.decode_step_time(len(ls)),
                    model.decode_bucket_time(hs, 8),
                    model.spec_step_time(hs, 4),
                    model.swap_in_time(hs[0]),
                    cost.decode_hbm_bytes_per_token(hs[0], 1024, 512.0,
                                                    arena=False, window=256),
                    cost.packed_hbm_bytes_per_step(ls, hs, 1024, 4, 512.0,
                                                   arena=False)]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_model_matches_reference(seed):
    assert _costs(tcore, tcost, seed) == _costs(jcore, jcost, seed)
