"""The serving engine of the PyTorch port at head widths 64 and 96
against the JAX engine, with converted weights: stablelm-1.6b's smoke
config raised to head_dim 64 and phi-3-vision-4.2b's raised to 96 (both
MHA, 4 / 4 heads, fp32), in the paged, slot_arena and slot_dense modes,
and ServeLoop on the paged default; and phi-3-vision's
``forward(embeds=)`` (stub patch embeddings, then text tokens, causal)
against the JAX ``forward``.  The same schedule must commit the same
greedy tokens into the same slots or pages, give logits within 1e-5 and
leave the same counters.  The JAX engine runs once per (config, mode)
(a module fixture).  The kernels' plain versions at these widths:
``test_torch_head_widths.py``.

Tolerance: fp32 atol = rtol = 1e-5.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one torch thread per test process: the suite runs in parallel
# workers, and torch's default of a thread per core in each of them
# oversubscribes the cores many times over
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

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
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# each MHA config's smoke cut raised to the head width its published
# config has (the CUDA kernels do not take the smoke configs' 16)
ARCHS = {"stablelm-1.6b": 64, "phi-3-vision-4.2b": 96}
MODES = {
    "paged": dict(),
    "slot_arena": dict(paged_kv=False),
    "slot_dense": dict(packed=False, paged_kv=False),
}
BASE = dict(num_slots=6, max_len=128, chunk_tokens=16, measure=False,
            token_buckets=(16, 32), packed_max_seqs=4,
            decode_buckets=(1, 2, 4))
# counters that must agree between the two engines
KEYS = ("arena_gathers", "arena_scatters", "dense_dispatches",
        "dense_dispatches_by_cause", "graph_hit_rate", "captured_shapes",
        "hit_rate_by_kind", "useful_tokens", "padded_tokens", "free_slots",
        "decode_shapes", "decode_dispatches", "decode_useful_rows",
        "decode_pad_rows", "packed_shapes", "packed_dispatches",
        "packed_useful_tokens", "packed_padded_tokens",
        "packed_shapes_by_kind", "mixed_steps", "decode_tokens_fused",
        "logits_rows_shipped", "fit_samples", "prefix_hit_tokens",
        "pages_evicted", "free_pages", "radix_pages")


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for arch, hd in ARCHS.items():
        cfg = get_smoke(arch).replace(head_dim=hd)
        tcfg = tget(arch).replace(head_dim=hd)
        params, _ = jtr.init_params(cfg, jax.random.key(23))
        tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
        out[arch] = (cfg, params, tcfg, tp)
    return out


def _schedule(e, vocab, seed):
    """Every engine entry point: packed prefill, a step with decode rows
    fused, a chunked long prompt, a re-prefill and decode ticks on two
    rungs."""
    rng = np.random.default_rng(seed)

    def p(n):
        return rng.integers(1, vocab, n).astype(np.int32)

    out = [e.prefill_batch([0, 1, 2], [p(9), p(5), p(7)])]
    r = e.step_mixed([(3, p(6)), (4, p(11))],
                     [(0, out[0][0]), (1, out[0][1]), (2, out[0][2])])
    out.append((r.tokens, r.fused))
    out.append(e.prefill_long(5, p(37)))
    out.append(e.prefill_batch([0], [p(4)]))
    out.append(e.decode_batch([0, 1, 2], [5, 6, 7], steps=3))
    out.append(e.decode_batch(list(range(6)), list(range(6)), steps=1))
    return out


@pytest.fixture(scope="module")
def jax_runs(stacks):
    """The JAX engine through the schedule, once per (config, mode)."""
    runs = {}
    for (arch, (cfg, params, _, _)), (mode, kw) in itertools.product(
            stacks.items(), MODES.items()):
        je = JEngine(cfg, params, JConfig(**BASE, **kw))
        runs[arch, mode] = (je, _schedule(je, cfg.vocab_size, 3))
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_matches_jax(stacks, jax_runs, arch, mode):
    _, _, tcfg, tp = stacks[arch]
    assert tcfg.num_heads == tcfg.num_kv_heads          # MHA: rep 1
    je, want = jax_runs[arch, mode]
    te = Engine(tcfg, tp, EngineConfig(**BASE, **MODES[mode]), device="cpu")
    got = _schedule(te, tcfg.vocab_size, 3)
    assert got == want
    for s in range(6):
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
        assert te.history(s) == je.history(s)
        assert te.arena.slot_of(s) == je.arena.slot_of(s)
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in KEYS} == {k: js.get(k) for k in KEYS}
    for x in ("executor", "packed_executor", "decode_executor"):
        jx, tx = getattr(je, x), getattr(te, x)
        assert (jx is None) == (tx is None)
        if jx is not None:
            assert tx.shapes_by_kind() == jx.shapes_by_kind()
            assert tx.dispatches == jx.dispatches


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _drive_loop(side, stack, turns):
    cfg, params, tcfg, tp = stack
    kw = dict(num_slots=4, max_len=192, chunk_tokens=16, measure=False)
    jax_side = side == "jax"
    if jax_side:
        engine = JEngine(cfg, params, JConfig(**kw))
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
    awd = (AWDConfig if jax_side else TAWDConfig)(
        packed=True, token_buckets=engine.ecfg.token_buckets,
        packed_max_seqs=engine.packed_executor.max_seqs)
    if jax_side:
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=24, chunk_tokens=16, awd_cfg=awd)
        loop = JLoop(engine, policy, slo_ttft=2.0, clock=_stepping_clock())
    else:
        policy = tcore.make_policy(tcore.Variant("pla_full"),
                                   tcore.H200_QWEN32B, threshold=24,
                                   chunk_tokens=16, awd_cfg=awd)
        loop = ServeLoop(engine, policy, slo_ttft=2.0,
                         clock=_stepping_clock())
    for _, wave in itertools.groupby(turns, key=lambda u: u.arrival):
        for u in wave:
            toks = u.tokens if u.turn == 0 else u.tokens[-u.suffix:]
            loop.submit(u.session, toks, decode_tokens=3)
        loop.run_until_idle(max_wall=1e9)
    for sid in sorted(loop.generated):
        loop.decode(sid, 2)
    st = engine.stats()
    return dict(generated=loop.generated,
                report=loop.tracker.report().as_dict(),
                counters={k: st.get(k) for k in KEYS},
                pages={s: engine.arena.pages_of(s) for s in loop.generated})


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_loop_matches_jax(stacks, arch):
    """ServeLoop over a multi-turn trace on the paged default: the JAX
    loop's transcripts, report, counters and pages."""
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=stacks[arch][0].vocab_size, num_sessions=3, max_turns=2,
        system_len=24, seed=6))
    want = _drive_loop("jax", stacks[arch], turns)
    got = _drive_loop("torch", stacks[arch], turns)
    assert got == want


def test_vlm_forward_with_patch_embeddings_matches_jax(stacks):
    """phi-3-vision's stub frontend: its ``frontend_tokens`` patch
    embeddings, then text tokens' embeddings, through the causal
    backbone as ``forward(embeds=)``, against the JAX forward."""
    cfg, params, tcfg, tp = stacks["phi-3-vision-4.2b"]
    assert tcfg.family == "vlm" and tcfg.frontend == "vision"
    rng = np.random.default_rng(9)
    patches = rng.standard_normal(
        (2, tcfg.frontend_tokens, tcfg.d_model)).astype(np.float32)
    text = rng.integers(1, tcfg.vocab_size, (2, 12)).astype(np.int32)
    emb = np.concatenate(
        [patches, np.asarray(params["embed"])[text]], axis=1)
    want, _, _ = jtr.forward(params, cfg, embeds=jnp.asarray(emb))
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # causal: the patch rows do not see the text after them
    with torch.no_grad():
        alone = ttr.forward(tp, tcfg, embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(got[:, :tcfg.frontend_tokens].numpy(),
                               alone.numpy(), **TOL)
