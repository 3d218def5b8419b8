"""The dense paths of the PyTorch port against the JAX package, with
weights converted from the JAX param pytree: the attention layer and
``forward`` on the dense (L, B) grid (a padded bucket, a dummy depth row
parked at S_max - 1) and the (B, 1) decode step — through ``ops.mha``
and ``ops.decode``, the dispatch of the ``flash_attn`` and
``decode_attn`` kernels — the hubert-xlarge smoke encoder through
``embeds`` (with and without a cache and ``kv_valid_len``),
``dense_cache_write``, an engine and a ServeLoop with dense decode
(``arena_decode=False``), ``params_from_numpy`` on the audio family and
the refusal of encoder-only configs by the page pool and the packed and
decode executors.

Tolerance: atol = rtol = 1e-5 on fp32 logits and caches (XLA and
PyTorch's CPU matmuls sum in different orders).  Real rows only: the
port places each grid row's queries at positions[b, 0] + arange(L),
where the reference masks by each token's own position, so pad tokens
and dummy depth rows compute other junk than the reference; it lands
only in the park row S_max - 1, which is not compared and which nothing
reads.
"""
import dataclasses
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
from repro.configs import get_config, get_smoke  # noqa: E402
from repro.core import H200_QWEN32B, Variant, make_policy  # noqa: E402
from repro.data.synthetic import (MultiTurnConfig,  # noqa: E402
                                  gen_multiturn_sessions)
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JConfig  # noqa: E402
from repro.serving import executor as jex  # noqa: E402
from repro.serving.loop import ServeLoop as JLoop  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import get_smoke as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import executor as tex  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.loop import ServeLoop  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
DECODERS = ["qwen3-4b", "qwen2.5-32b"]
S_MAX = 40


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for arch in DECODERS + ["hubert-xlarge"]:
        cfg, tcfg = get_smoke(arch), tget(arch)
        params, _ = jtr.init_params(cfg, jax.random.key(21))
        if cfg.qkv_bias:
            # init zeroes the biases; perturb them so the branch runs
            rng = np.random.default_rng(3)
            for name in ("bq", "bk", "bv"):
                b = params["blocks"][0]["mixer"][name]
                params["blocks"][0]["mixer"][name] = jnp.asarray(
                    0.5 * rng.standard_normal(b.shape), b.dtype)
        tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
        out[arch] = (cfg, tcfg, params, tp)
    return out


@pytest.fixture
def counted(monkeypatch):
    """Count the dense attention calls the port's layers make through
    ``ops.mha`` and ``ops.decode``."""
    calls = {"mha": 0, "decode": 0}
    for name in calls:
        inner = getattr(tops, name)

        def wrapped(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(tops, name, wrapped)
    return calls


def _grid_positions(lens, hists, pad_l, depth):
    """Positions of a padded (L, B) grid bucket as the engine builds
    them: hist + arange on the real tokens, the park row S_MAX - 1 on
    pad tokens and on dummy depth rows."""
    pos = np.full((depth, pad_l), S_MAX - 1, np.int32)
    for i, (n, h) in enumerate(zip(lens, hists)):
        pos[i, :n] = h + np.arange(n)
    return pos


def _caches(cfg, seed, batch, s=S_MAX):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, batch, s, cfg.num_kv_heads, cfg.hdim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return ([{"k": jnp.asarray(k), "v": jnp.asarray(v)}],
            [{"k": torch.from_numpy(k.copy()),
              "v": torch.from_numpy(v.copy())}])


def _same_caches(tc, jc, rows=slice(None), below=S_MAX - 1):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc[0][name].numpy()[:, rows, :below],
            np.asarray(jc[0][name])[:, rows, :below], **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_attention_layer_dense_grid_matches_jax(stacks, counted, arch):
    """One attention layer over gathered caches at a padded (L, B)
    bucket: two re-prefills with history (one padded), a first prefill
    and a dummy depth row; real rows' outputs and every KV row below the
    park row."""
    cfg, tcfg, params, tp = stacks[arch]
    jlp = jax.tree.map(lambda a: a[0], params["blocks"][0]["mixer"])
    tlp = {k: v[0] for k, v in tp["blocks"][0]["mixer"].items()}
    lens, hists, pad_l = [8, 3, 6], [5, 20, 0], 8
    pos = _grid_positions(lens, hists, pad_l, 4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, pad_l, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((4, S_MAX, cfg.num_kv_heads, cfg.hdim))
              .astype(np.float32) for _ in range(2))
    want, (jk, jv) = jl.attention_layer(
        jlp, jnp.asarray(x), cfg=cfg, positions=jnp.asarray(pos),
        kv=(jnp.asarray(kc), jnp.asarray(vc)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tl.attention_layer(tlp, torch.from_numpy(x), cfg=tcfg,
                             positions=torch.from_numpy(pos), kv=(tk, tv))
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[i, :n],
                                   np.asarray(want)[i, :n], **TOL)
    np.testing.assert_allclose(tk.numpy()[:, :-1], np.asarray(jk)[:, :-1],
                               **TOL)
    np.testing.assert_allclose(tv.numpy()[:, :-1], np.asarray(jv)[:, :-1],
                               **TOL)
    assert counted == {"mha": 1, "decode": 0}


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_runs_ops_decode_and_matches_jax(stacks, counted, arch):
    """The (B, 1) step with caches: each row writes its new KV at its
    history and attends its first history + 1 keys through
    ``ops.decode``, once per layer, never ``ops.mha``."""
    cfg, tcfg, params, tp = stacks[arch]
    jc, tc = _caches(cfg, 6, 3)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    pos = np.asarray([[0], [17], [S_MAX - 2]], np.int32)
    want, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(tok),
                              positions=jnp.asarray(pos), caches=jc,
                              logits_slice="last")
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, torch.from_numpy(tok),
                          torch.from_numpy(pos), caches=tc,
                          logits_slice="last")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_caches(tc, jc, below=S_MAX)
    assert counted == {"mha": 0, "decode": cfg.num_layers}


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_grid_then_decode_matches_jax(stacks, counted, arch):
    """``forward`` over a padded grid bucket with a dummy row, then a
    (B, 1) decode of the real rows at their next positions: real rows'
    logits, KV below the park row, one ``ops.mha`` per layer for the
    grid and one ``ops.decode`` per layer for the decode."""
    cfg, tcfg, params, tp = stacks[arch]
    jc, tc = _caches(cfg, 8, 3)
    lens, hists, pad_l = [6, 4], [9, 0], 8
    pos = _grid_positions(lens, hists, pad_l, 3)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab_size, (3, pad_l)).astype(np.int32)
    want, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(tok),
                              positions=jnp.asarray(pos), caches=jc)
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, torch.from_numpy(tok),
                          torch.from_numpy(pos), caches=tc)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[i, :n],
                                   np.asarray(want)[i, :n], **TOL)
    _same_caches(tc, jc)
    assert counted == {"mha": cfg.num_layers, "decode": 0}
    tok1 = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    pos1 = np.asarray([[h + n] for h, n in zip(hists, lens)], np.int32)
    jc2 = [{n: a[:, :2] for n, a in jc[0].items()}]
    tc2 = [{n: a[:, :2].contiguous() for n, a in tc[0].items()}]
    want, jc2, _ = jtr.forward(params, cfg, tokens=jnp.asarray(tok1),
                               positions=jnp.asarray(pos1), caches=jc2,
                               logits_slice="last")
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, torch.from_numpy(tok1),
                          torch.from_numpy(pos1), caches=tc2,
                          logits_slice="last")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_caches(tc2, jc2)
    assert counted == {"mha": cfg.num_layers, "decode": cfg.num_layers}


def _embeds(cfg, b, l, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)


def test_hubert_encoder_forward_matches_jax(stacks, counted):
    """The encoder forward over stub frame embeddings, no cache:
    non-causal attention, no rope, every frame's logits."""
    cfg, tcfg, params, tp = stacks["hubert-xlarge"]
    emb = _embeds(cfg, 2, 13, 1)
    want, _, _ = jtr.forward(params, cfg, embeds=jnp.asarray(emb))
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (2, 13, tcfg.padded_vocab)
    assert counted == {"mha": cfg.num_layers, "decode": 0}


@pytest.mark.parametrize("dense_write", [False, True])
def test_hubert_cached_forward_with_kv_valid_len_matches_jax(stacks,
                                                            dense_write):
    """A padded encoder batch through a cache: the frames' KV written at
    their positions (or, with ``dense_cache_write``, copied over a cache
    as deep as the batch) and each row's keys bounded by
    ``kv_valid_len``."""
    cfg, tcfg, params, tp = stacks["hubert-xlarge"]
    l = 10
    s = l if dense_write else 16
    emb = _embeds(cfg, 2, l, 2)
    kvl = np.asarray([l, 6], np.int32)
    jc = jtr.init_cache(cfg, 2, s)
    tc = ttr.init_cache(tcfg, 2, s, device="cpu")
    want, jc, _ = jtr.forward(params, cfg, embeds=jnp.asarray(emb),
                              caches=jc, kv_valid_len=jnp.asarray(kvl),
                              dense_cache_write=dense_write)
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, embeds=torch.from_numpy(emb), caches=tc,
                          kv_valid_len=torch.from_numpy(kvl),
                          dense_cache_write=dense_write)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0][name].numpy(),
                                   np.asarray(jc[0][name]), **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_dense_cache_write_matches_jax(stacks, counted, arch):
    """A fresh full prefill covering the whole cache: the cache takes
    the tokens' KV as a copy and attention runs over the new tokens."""
    cfg, tcfg, params, tp = stacks[arch]
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc = jtr.init_cache(cfg, 2, 12)
    tc = ttr.init_cache(tcfg, 2, 12, device="cpu")
    want, jc, _ = jtr.forward(params, cfg, tokens=jnp.asarray(tok),
                              caches=jc, dense_cache_write=True)
    with torch.no_grad():
        got = ttr.forward(tp, tcfg, torch.from_numpy(tok), caches=tc,
                          dense_cache_write=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_caches(tc, jc, below=12)
    assert counted == {"mha": cfg.num_layers, "decode": 0}


# counters that must agree between the two engines
KEYS = ("arena_gathers", "arena_scatters", "dense_dispatches",
        "dense_dispatches_by_cause", "graph_hit_rate", "captured_shapes",
        "hit_rate_by_kind", "useful_tokens", "padded_tokens", "free_slots",
        "decode_shapes", "decode_dispatches", "fit_samples")


def _stepping_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


def _drive_loop(side, stack, turns):
    """ServeLoop on the slot arena with the dense (L, B) grid and dense
    decode (``arena_decode=False``) over a multi-turn trace whose later
    turns submit only their new tokens.  ``shapes``: the dense
    executor's shapes by kind (each one step graph in the port)."""
    cfg, tcfg, params, tp = stack
    kw = dict(num_slots=8, max_len=256, chunk_tokens=32, measure=False,
              packed=False, paged_kv=False, arena_decode=False)
    if side == "jax":
        engine = JEngine(cfg, params, JConfig(**kw))
        policy = make_policy(Variant("pla_full"), H200_QWEN32B,
                             threshold=48, chunk_tokens=32)
        loop = JLoop(engine, policy, slo_ttft=2.0, clock=_stepping_clock())
    else:
        engine = Engine(tcfg, tp, EngineConfig(**kw), device="cpu")
        policy = tcore.make_policy(tcore.Variant("pla_full"),
                                   tcore.H200_QWEN32B, threshold=48,
                                   chunk_tokens=32)
        loop = ServeLoop(engine, policy, slo_ttft=2.0,
                         clock=_stepping_clock())
    for arrival, wave in itertools.groupby(turns, key=lambda u: u.arrival):
        for u in wave:
            toks = u.tokens if u.turn == 0 else u.tokens[-u.suffix:]
            loop.submit(u.session, toks, decode_tokens=3)
        loop.run_until_idle(max_wall=1e9)
    for sid in sorted(loop.generated):
        loop.decode(sid, 2)
    st = engine.stats()
    last = {s: np.asarray(x) for s, x in engine.last_logits.items()}
    return dict(generated=loop.generated,
                report=loop.tracker.report().as_dict(),
                graph_hits=policy.awd.graph_hits,
                counters={k: st.get(k) for k in KEYS},
                shapes=engine.executor.shapes_by_kind(),
                slots={s: engine.arena.slot_of(s) for s in loop.generated},
                lengths={s: engine.history(s) for s in loop.generated}), last


def test_serve_loop_with_dense_decode_matches_jax(stacks, counted):
    """An engine with ``arena_decode=False`` under ServeLoop gives the
    JAX loop's greedy transcripts, TTFT report, grid hits and host
    counters (dense dispatches by cause, whole-slot copies, shapes),
    with logits within 1e-5; every grid step runs ``ops.mha`` and every
    decode step ``ops.decode``, and so does the capture of each shape's
    step graph (on the CPU its run on parked inputs)."""
    stack = stacks["qwen3-4b"]
    turns = gen_multiturn_sessions(MultiTurnConfig(
        vocab_size=stack[0].vocab_size, num_sessions=4, max_turns=3,
        system_len=24, seed=6))
    want, jlast = _drive_loop("jax", stack, turns)
    got, tlast = _drive_loop("torch", stack, turns)
    assert got == want
    for s in jlast:
        np.testing.assert_allclose(tlast[s], jlast[s], **TOL)
    dense = got["counters"]["dense_dispatches_by_cause"]
    assert dense["prefill"]["requested"] > 0
    assert dense["decode"]["requested"] > 0
    layers = stack[0].num_layers
    shapes = got["shapes"]
    assert counted["mha"] == layers * (dense["prefill"]["requested"]
                                       + shapes["prefill"])
    assert counted["decode"] == layers * (dense["decode"]["requested"]
                                          + shapes["decode"])


def test_hubert_config_and_params_from_numpy(stacks):
    """The port registers hubert-xlarge with the reference's fields (the
    published config and its smoke cut), and ``params_from_numpy``
    converts the audio family's pytree leaf for leaf."""
    cfg, tcfg, params, tp = stacks["hubert-xlarge"]
    for jc, tc in ((get_config("hubert-xlarge"), tget_config("hubert-xlarge")),
                   (cfg, tcfg)):
        assert {f.name: getattr(jc, f.name) for f in
                dataclasses.fields(tc)} == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
    assert tcfg.family == "audio" and not tcfg.causal
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_encoder_only_configs_are_refused_by_the_serving_stack(stacks):
    """The engine on the page pool, the packed executor and the
    arena-resident decode executor refuse an encoder-only config with
    the reference's own words."""
    cfg, tcfg, params, tp = stacks["hubert-xlarge"]
    for jcall, tcall in (
            (lambda: JEngine(cfg, params, JConfig()),
             lambda: Engine(tcfg, tp, EngineConfig(), device="cpu")),
            (lambda: jex.PackedBucketExecutor(cfg),
             lambda: tex.PackedBucketExecutor(tcfg)),
            (lambda: jex.DecodeBucketExecutor(cfg),
             lambda: tex.DecodeBucketExecutor(tcfg))):
        with pytest.raises(ValueError) as jerr:
            jcall()
        with pytest.raises(ValueError) as terr:
            tcall()
        assert str(terr.value) == str(jerr.value)
        assert "encoder-only" in str(terr.value)
