"""The reference's slot-arena bench scenarios, driven through both
packages: the short-prefill flood of ``benchmarks/bench_mix.py``
(``_drive_prefill_flood``: arena-resident packed prefill against the
whole-slot gather baseline, the ``BENCH_prefill.json`` rows) and its
decode-heavy drain (``_drive_decode_heavy``: bucketed arena decode
against the dense gather path, ``BENCH_decode.json``).  The traffic is
copied here with the bench's rng seeds.  The port's engine must count
exactly what the JAX engine counts — dispatches, shapes, whole-slot
gathers and scatters, session counts seen — and both must equal the
committed JSON rows.
"""
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

from repro.configs import get_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def makers():
    """Engine factories of the two packages on the bench's weights."""
    cfg = get_smoke("qwen3-4b")
    params, _ = jtr.init_params(cfg, jax.random.key(0))
    tcfg = tget("qwen3-4b")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return {
        "jax": lambda **kw: JEngine(cfg, params, JConfig(**kw)),
        "torch": lambda **kw: Engine(tcfg, tp, EngineConfig(**kw),
                                     device="cpu"),
    }, cfg.vocab_size


def _prefill_flood(make, vocab, arena, rounds=8, max_len=64):
    """``bench_mix._drive_prefill_flood``: two persistent chat sessions,
    ``rounds`` packed ticks of one re-prefill plus 2-3 fresh shorts,
    then a 40-token prompt in C_l = 16 chunks."""
    rng = np.random.default_rng(7)
    eng = make(num_slots=16, max_len=max_len, chunk_tokens=16, packed=True,
               arena_prefill=arena, paged_kv=False, packed_max_seqs=8,
               token_buckets=(32, 64))
    steps = 0

    def packed_tick(sessions, lists):
        nonlocal steps
        steps += 1
        return eng.prefill_packed(sessions, lists)

    for s in (0, 1):
        packed_tick([s], [rng.integers(0, vocab, 8)])
    burst_sess = 100
    for r in range(rounds):
        mix = [(0 if r % 2 else 1, rng.integers(0, vocab, 4))]
        for i in range(2 + r % 2):
            mix.append((burst_sess + i,
                        rng.integers(0, vocab, int(rng.integers(4, 9)))))
        packed_tick([s for s, _ in mix], [t for _, t in mix])
        for s, _ in mix:
            if s >= 100:
                eng.close_session(s)
        burst_sess += len(mix)
    long_toks = rng.integers(0, vocab, 40)
    for start in range(0, 40, 16):
        packed_tick([50], [long_toks[start:start + 16]])
    st = eng.stats()
    return {
        "packed_dispatches": st["packed_dispatches"],
        "dense_dispatches": st["dense_dispatches"],
        "arena_gathers": st["arena_gathers"],
        "arena_scatters": st["arena_scatters"],
        "steps": steps,
        "compiled_shapes": st["packed_shapes"] + st["captured_shapes"],
    }, {s: eng.last_logits[s] for s in (0, 1, 50)}


def _decode_dispatches(eng, arena):
    if arena and eng.decode_executor is not None:
        return eng.decode_executor.dispatches
    return (eng.executor.kind_hits.get("decode", 0)
            + eng.executor.kind_misses.get("decode", 0))


def _decode_heavy(make, vocab, arena, n_sessions=6, max_len=64):
    """``bench_mix._drive_decode_heavy``: sessions drain staggered decode
    budgets while short prefill bursts arrive every fourth round."""
    rng = np.random.default_rng(5)
    eng = make(num_slots=16, max_len=max_len, packed=arena,
               arena_decode=arena, paged_kv=False, packed_max_seqs=8,
               token_buckets=(16, 32, 64), decode_buckets=(1, 2, 4, 8))
    prompts = [rng.integers(0, vocab, int(rng.integers(6, 14)))
               for _ in range(n_sessions)]
    budgets = {s: 4 + 2 * s for s in range(n_sessions)}
    last = {}
    for s in range(n_sessions):
        last.update(eng.prefill_batch([s], [prompts[s]]))
    base_decode = _decode_dispatches(eng, arena)
    active = dict(budgets)
    counts_seen, rounds, burst_sess = set(), 0, 100
    transcript = []
    while active:
        sessions = sorted(active)
        counts_seen.add(len(sessions))
        decodes = [(s, last[s]) for s in sessions]
        burst = [] if rounds % 4 != 1 else \
            [(burst_sess + i, rng.integers(0, vocab, 6)) for i in range(2)]
        burst_sess += len(burst)
        if burst and arena:
            toks = eng.step_mixed(burst, decodes).tokens
        else:
            if burst:
                eng.prefill_batch([s for s, _ in burst],
                                  [t for _, t in burst])
            dec = eng.decode_batch(sessions, [t for _, t in decodes])
            toks = {s: dec[s][0] for s in sessions}
        for s, _ in burst:
            eng.close_session(s)
        for s in sessions:
            last[s] = toks[s]
            active[s] -= 1
            if active[s] <= 0:
                del active[s]
        transcript.append(dict(toks))
        rounds += 1
    st = eng.stats()
    return {
        "decode_dispatches": _decode_dispatches(eng, arena) - base_decode,
        "decode_shapes": st["decode_shapes"] if arena else
        eng.executor.shapes_by_kind().get("decode", 0),
        "decode_ladder_len": len(eng.decode_executor.decode_buckets)
        if arena else None,
        "session_counts_seen": len(counts_seen),
        "rounds": rounds,
    }, transcript


def _committed(name, tag):
    rows = json.loads((ROOT / name).read_text())
    return next(r for r in rows if r["tag"] == tag)


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "gather"])
def test_prefill_flood_counters_match_jax_and_bench(makers, arena):
    make, vocab = makers
    want, jlogits = _prefill_flood(make["jax"], vocab, arena)
    got, tlogits = _prefill_flood(make["torch"], vocab, arena)
    assert got == want
    for s in jlogits:
        np.testing.assert_allclose(tlogits[s], jlogits[s], atol=1e-5, rtol=0)
    row = _committed("BENCH_prefill.json", "arena" if arena else "gather")
    assert got == {k: row[k] for k in got}


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "dense"])
def test_decode_heavy_counters_match_jax_and_bench(makers, arena):
    make, vocab = makers
    want, jtrans = _decode_heavy(make["jax"], vocab, arena)
    got, ttrans = _decode_heavy(make["torch"], vocab, arena)
    assert got == want and ttrans == jtrans
    row = _committed("BENCH_decode.json", "arena" if arena else "dense")
    assert got == {k: row[k] for k in got}
