"""Two more of the reference's bench scenarios driven through both
packages, as ``tests/test_torch_paged_benches.py`` drives the paged ones:

* the continuous-batching scenario of ``benchmarks/bench_mix.py``
  (``_continuous_batching`` over ``_drive``, the qwen3-4b smoke config):
  steady decode load plus bursty short prefills, as one mixed packed
  dispatch a round (unified) or a prefill step then a decode step
  (alternating), the ``BENCH_mixed.json`` rows;
* the sliding-window scenario (``window_scenario`` over
  ``_drive_window``, the mixtral-8x7b smoke config, window 32): sessions
  decoding far past the window on rolling window-deep slots against the
  dense full-depth baseline, the ``BENCH_window.json`` rows, with the
  modeled HBM bytes a decode token from the port's ``sim.costmodel``.

The traffic is copied here with the bench's rng seeds.  The port's
engine must count exactly what the JAX engine counts and commit the same
tokens, and both must equal the committed rows' framework-free counters.
``wall_ms``, ``mean_ms``, ``ttft_ms`` and ``tpot_ms`` are host times of
the run that wrote the rows, not targets.  ``compiled_shapes`` counts as
``tests/test_torch_slot_benches.py`` counts it: the executors' shapes
(packed, grid and decode) the run captured.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.sim import costmodel as jcost  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.sim import costmodel as tcost  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TICKS_PER_SIM_SECOND = 10          # bench_mix's scheduler round, 100 ms


def _rows(name):
    return {r["tag"]: r for r in json.loads((ROOT / name).read_text())}


def _makers(arch):
    cfg = get_smoke(arch)
    params, _ = jtr.init_params(cfg, jax.random.key(0))
    tcfg = tget(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, {
        "jax": (lambda **kw: JEngine(cfg, params, JConfig(**kw)), jcost),
        "torch": (lambda **kw: Engine(tcfg, tp, EngineConfig(**kw),
                                      device="cpu"), tcost),
    }


@pytest.fixture(scope="module")
def qwen():
    return _makers("qwen3-4b")


@pytest.fixture(scope="module")
def mixtral():
    return _makers("mixtral-8x7b")


def _compiled(st):
    return (st.get("packed_shapes", 0) + st["captured_shapes"]
            + st.get("decode_shapes", 0))


# ------------------------------------------------- continuous batching
def _mixed_workload(cfg, seed=4):
    """``bench_mix._mixed_workload``: 4 steady decode sessions + 8 rounds
    of bursty short prefills."""
    rng = np.random.default_rng(seed)
    steady = [rng.integers(0, cfg.vocab_size, 24) for _ in range(4)]
    bursts = []
    for r in range(8):
        n = int(rng.integers(0, 4)) if r % 3 else 0
        bursts.append([rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(4, 20)))
                       for _ in range(n)])
    return steady, bursts


def _dispatches(st):
    return (st["packed_dispatches"] + st["dense_dispatches"]
            + st.get("decode_dispatches", 0))


def _drive(cfg, make, unified, decode_budget=12):
    """``bench_mix._drive``: each round one ``step_mixed`` (unified) or a
    packed prefill then a separate decode step (alternating)."""
    eng = make(num_slots=16, max_len=64, packed=True, packed_max_seqs=8,
               token_buckets=(64, 128), measure=False)
    steady, bursts = _mixed_workload(cfg)
    warm = [np.zeros(4, np.int32) for _ in range(4)]
    wf = eng.prefill_packed([90, 91, 92, 93], warm)
    eng.decode_batch([90, 91, 92, 93], [wf[s] for s in (90, 91, 92, 93)])
    for s in (90, 91, 92, 93):
        eng.close_session(s)
    firsts = eng.prefill_packed(list(range(4)), steady)
    d_base = _dispatches(eng.stats())
    active = {s: decode_budget for s in range(4)}
    last = dict(firsts)
    rounds, sess, queue, tokens = 0, 100, list(bursts), []
    while active or queue:
        burst = queue.pop(0) if queue else []
        prefills = [(sess + i, toks) for i, toks in enumerate(burst)]
        sess += len(burst)
        decodes = [(s, last[s]) for s in active]
        if unified:
            toks = eng.step_mixed(prefills, decodes).tokens
        else:
            toks = {}
            if prefills:
                toks.update(eng.prefill_packed([s for s, _ in prefills],
                                               [t for _, t in prefills]))
            if decodes:
                dec = eng.decode_batch([s for s, _ in decodes],
                                       [t for _, t in decodes])
                toks.update({s: d[0] for s, d in dec.items()})
        tokens.append(sorted(toks.items()))
        for s, _ in prefills:
            eng.close_session(s)
        for s in list(active):
            last[s] = toks[s]
            active[s] -= 1
            if active[s] <= 0:
                del active[s]
        rounds += 1
    st = eng.stats()
    dispatches = _dispatches(st) - d_base
    return {
        "dispatches": dispatches,
        "dispatches_per_sim_s": round(
            dispatches / (rounds / TICKS_PER_SIM_SECOND), 2),
        "rounds": rounds,
        "decode_tokens_fused": st.get("decode_tokens_fused", 0),
        "compiled_shapes": _compiled(st),
    }, tokens


@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "alternating"])
def test_bench_mixed_rows(qwen, unified):
    """Unified: 12 dispatches in 12 rounds, 48 decode tokens fused, 3
    shapes; alternating: 16, 12, 0, 3 — on both engines, with the same
    tokens every round."""
    cfg, sides = qwen
    got = _drive(cfg, sides["torch"][0], unified)
    assert got == _drive(cfg, sides["jax"][0], unified)
    bench = _rows("BENCH_mixed.json")["unified" if unified
                                      else "alternating"]
    assert got[0] == {k: bench[k] for k in got[0]}


# ----------------------------------------------------- sliding window
def _drive_window(cfg, make, cost, windowed, n_sessions=3, max_len=128):
    """``bench_mix._drive_window``: staggered decode budgets far past the
    window, a one-prompt prefill burst every tenth round."""
    rng = np.random.default_rng(11)
    if windowed:
        eng = make(num_slots=8, max_len=max_len, chunk_tokens=16,
                   paged_kv=False, packed_max_seqs=4, token_buckets=(16, 32),
                   decode_buckets=(1, 2, 4), measure=False)
    else:
        eng = make(num_slots=8, max_len=max_len, packed=False,
                   arena_decode=False, paged_kv=False, measure=False)
    depth = eng.arena.arena[0]["k"].shape[2]
    kv_row_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.hdim
                    * np.dtype(cfg.np_dtype).itemsize)
    eff_window = depth if windowed else cfg.sliding_window
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(n_sessions)]
    budgets = {s: 40 + 15 * s for s in range(n_sessions)}
    last = {}
    for s in range(n_sessions):
        last.update(eng.prefill_batch([s], [prompts[s]]))
    active = dict(budgets)
    tick_bytes, tick_tokens, rounds, burst_sess = 0.0, 0, 0, 100
    tokens = []
    while active:
        sessions = sorted(active)
        if rounds % 10 == 5:
            burst = [(burst_sess, rng.integers(0, cfg.vocab_size, 6))]
            burst_sess += 1
            if windowed:
                eng.step_mixed(burst, [])
            else:
                eng.prefill_batch([s for s, _ in burst],
                                  [t for _, t in burst])
            for s, _ in burst:
                eng.close_session(s)
        for s in sessions:
            tick_bytes += cost.decode_hbm_bytes_per_token(
                eng.history(s), max_len, kv_row_bytes, arena=windowed,
                window=eff_window)
        tick_tokens += len(sessions)
        dec = eng.decode_batch(sessions, [last[s] for s in sessions])
        for s in sessions:
            last[s] = dec[s][0]
            active[s] -= 1
            if active[s] <= 0:
                del active[s]
        tokens.append([dec[s][0] for s in sessions])
        rounds += 1
    st = eng.stats()
    return {
        "window": cfg.sliding_window,
        "slot_depth": depth,
        "max_cached_len": max(eng.history(s) for s in range(n_sessions)),
        "hbm_bytes_per_decode_token": round(
            tick_bytes / max(tick_tokens, 1), 1),
        "arena_gathers": st["arena_gathers"],
        "arena_scatters": st["arena_scatters"],
        "decode_shapes": st.get("decode_shapes",
                                eng.executor.shapes_by_kind()
                                .get("decode", 0)),
        "compiled_shapes": _compiled(st),
        "rounds": rounds,
    }, tokens


@pytest.mark.parametrize("windowed", [True, False],
                         ids=["windowed", "dense"])
def test_bench_window_rows(mixtral, windowed):
    """Windowed: slot depth 48, no gathers or scatters, 3 decode shapes,
    4 compiled, 70 rounds, 17454.5 modeled HBM bytes a decode token;
    dense: 128, 80 / 80, 3, 5, 70, 145175.3 — on both engines, with the
    same tokens every round."""
    cfg, sides = mixtral
    got = _drive_window(cfg, *sides["torch"], windowed)
    assert got == _drive_window(cfg, *sides["jax"], windowed)
    bench = _rows("BENCH_window.json")["windowed" if windowed else "dense"]
    assert got[0] == {k: bench[k] for k in got[0]}
