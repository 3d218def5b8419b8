"""ServeLoop of the PyTorch port against the JAX loop: a multi-turn chat
trace from ``repro.data.synthetic`` (shared system prompts, stateless
full-conversation resubmits, concurrent cold submits) drives both loops
with the same stepping clock and ``measure=False`` — so wall time feeds
neither the classification threshold nor the TTFT — and must give
identical greedy transcripts, prefix-hit and chunk-hit tokens, coalesced
prefills, page tables and SLO reports (TTFT on the stepping clock).
Also: the port imports no JAX and no module of the JAX package, and the
serve launcher runs end to end.
"""
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import repro_torch.core as tcore  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import H200_QWEN32B, Variant, make_policy  # noqa: E402
from repro.core.awd import AWDConfig  # noqa: E402
from repro.data.synthetic import (MultiTurnConfig,  # noqa: E402
                                  gen_multiturn_sessions)
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving.loop import ServeLoop as JLoop  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.core.awd import AWDConfig as TAWDConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def stack():
    cfg = get_smoke("qwen3-4b")
    params, _ = jtr.init_params(cfg, jax.random.key(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, params),
                           tget("qwen3-4b"), "cpu")
    return cfg, params, tget("qwen3-4b"), tp


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _drive(side, stack, turns, *, stateless, chunk=32, threshold=48):
    cfg, params, tcfg, tp = stack
    kw = dict(num_slots=8, max_len=512, chunk_tokens=chunk, measure=False)
    if side == "jax":
        engine = JEngine(cfg, params, JConfig(**kw))
        awd = AWDConfig(packed=True, token_buckets=engine.ecfg.token_buckets,
                        packed_max_seqs=engine.packed_executor.max_seqs)
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=threshold, chunk_tokens=chunk,
                             awd_cfg=awd)
        loop = JLoop(engine, policy, slo_ttft=2.0, clock=_stepping_clock())
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
        awd = TAWDConfig(packed=True,
                         token_buckets=engine.ecfg.token_buckets,
                         packed_max_seqs=engine.packed_executor.max_seqs)
        policy = tcore.make_policy(tcore.Variant("pla_full"),
                                   tcore.H200_QWEN32B, threshold=threshold,
                                   chunk_tokens=chunk, awd_cfg=awd)
        loop = ServeLoop(engine, policy, slo_ttft=2.0,
                         clock=_stepping_clock())
    # each arrival wave is submitted together, so cold submits of one
    # system prompt coalesce behind the first
    for arrival, wave in itertools.groupby(turns, key=lambda u: u.arrival):
        for u in wave:
            sid = u.session * 100 + u.turn if stateless else u.session
            toks = u.tokens if stateless or u.turn == 0 else \
                u.tokens[-u.suffix:]
            loop.submit(sid, toks, decode_tokens=3)
        loop.run_until_idle(max_wall=1e9)
    for sid in sorted(loop.generated):
        loop.decode(sid, 2)
    st = engine.stats()
    return dict(generated=loop.generated,
                prefix_hit_tokens=st["prefix_hit_tokens"],
                chunk_hit_tokens=st["chunk_hit_tokens"],
                coalesced=loop.coalesced_prefills,
                report=loop.tracker.report().as_dict(),
                pages={s: list(engine.arena.pages_of(s))
                       for s in loop.generated}), engine


@pytest.mark.parametrize("stateless", [True, False])
def test_multiturn_trace_matches_jax_loop(stack, stateless):
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=stack[0].vocab_size, num_sessions=5, max_turns=3,
        system_len=40, seed=2))
    want, _ = _drive("jax", stack, turns, stateless=stateless)
    got, engine = _drive("torch", stack, turns, stateless=stateless)
    assert got == want
    assert got["prefix_hit_tokens"] > 0
    engine.arena.audit()


def test_long_prompt_chunk_matching_matches_jax_loop(stack):
    """A long prompt filled while a second one with the same prefix
    waits: the second adopts the filler's pages at chunk boundaries."""
    rng = np.random.default_rng(4)
    vocab = stack[0].vocab_size
    body = rng.integers(1, vocab, 150).astype(np.int32)

    class U:
        def __init__(self, s, toks):
            self.session, self.turn, self.tokens = s, 0, toks
            self.suffix, self.arrival = len(toks), 0.0

    turns = [U(0, body), U(1, np.concatenate(
        [body, rng.integers(1, vocab, 9).astype(np.int32)]))]
    want, _ = _drive("jax", stack, turns, stateless=True, chunk=32)
    got, _ = _drive("torch", stack, turns, stateless=True, chunk=32)
    assert got == want
    assert got["prefix_hit_tokens"] > 0


def test_port_imports_no_jax():
    """Every repro_torch module imports without pulling in jax or any
    module of the JAX package, the analytic modules (controller,
    queueing model, workloads, simulator), the training ones
    (optimizer, checkpoints, train step and loop, launcher) and the
    sharding layer and the dry run (rules, shard-local steps, meshes,
    cell specs, the dry run) among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "new = ('core.controller', 'core.queueing', 'sim.workload',\n"
        "       'sim.simulator', 'optim.adamw', 'checkpoint.ckpt',\n"
        "       'training.train_step', 'training.loop', 'launch.train',\n"
        "       'distributed.sharding', 'distributed.local', 'launch.mesh',\n"
        "       'launch.specs', 'launch.dryrun')\n"
        "assert all('repro_torch.' + m in sys.modules for m in new)\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_serve_launcher_runs_on_cpu(capsys):
    """The plain run serves the reference launcher's default, the
    slot/dense baseline with its grid and decode rungs captured at init;
    ``--packed`` the paged stack."""
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--sessions", "2", "--turns", "2",
            "--decode-steps", "2"]
    serve.main(args)
    out = capsys.readouterr().out
    assert "requests=4" in out and "device=cpu" in out
    assert "[serve] captured 15 grid step graphs" in out
    assert "[serve] captured 4 decode step graphs" in out
    serve.main(args + ["--packed"])
    out = capsys.readouterr().out
    assert "requests=4" in out and "[serve] captured" not in out


def test_serve_launcher_default_traffic_fits_the_arena(capsys):
    """The launcher's default traffic (6 sessions x 3 turns of prompts up
    to 95 tokens, 4 decode steps each) fits the arena it sizes."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu"])
    assert "requests=18" in capsys.readouterr().out
