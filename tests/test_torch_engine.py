"""Serving engine of the PyTorch port against the JAX engine on the paged
default path: the same ``step_mixed`` / ``decode_batch`` /
``prefill_long`` / ``fork_session`` schedule on both, with weights
converted from the JAX pytree, must commit identical tokens, place them
on identical pages, count identical prefix hits, and give logits within
1e-5 (fp32; XLA and PyTorch's CPU matmuls sum in different orders).
Also: the split paths for over-wide ticks, the entry-point guards, the
refusal of speculation off the packed arena stream, and the branches
outside the slice.
"""
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
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def stacks():
    out = {}
    for arch in ("qwen3-4b", "qwen2.5-32b"):
        cfg = get_smoke(arch)
        params, _ = jtr.init_params(cfg, jax.random.key(11))
        tp = params_from_numpy(jax.tree.map(np.asarray, params),
                               tget(arch), "cpu")
        out[arch] = (cfg, params, tget(arch), tp)
    return out


def _pair(stack, **kw):
    cfg, params, tcfg, tp = stack
    base = dict(num_slots=6, max_len=128, chunk_tokens=16, measure=False)
    base.update(kw)
    return (JEngine(cfg, params, JConfig(**base)),
            Engine(tcfg, tp, EngineConfig(**base), device="cpu"))


def _same(je, te, sessions):
    for s in sessions:
        np.testing.assert_allclose(te.last_logits[s], je.last_logits[s],
                                   **TOL)
        assert te.arena.pages_of(s) == je.arena.pages_of(s)
        assert te.arena._tokens[s] == je.arena._tokens[s]
    keys = ("prefix_hit_tokens", "chunk_hit_tokens", "pages_cow_forked",
            "pages_evicted", "packed_dispatches", "decode_dispatches",
            "packed_useful_tokens", "packed_padded_tokens", "mixed_steps",
            "decode_tokens_fused", "free_pages", "radix_pages")
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    te.arena.audit()


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, 20).astype(np.int32)
    return [np.concatenate([system, rng.integers(1, vocab, n)]).astype(
        np.int32) for n in (5, 11, 3)], rng


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-32b"])
def test_mixed_schedule_matches_jax(stacks, arch):
    """Prefill → prefix-hit prefill fused with decode rows → bucketed
    decode: identical tokens, pages and counters."""
    je, te = _pair(stacks[arch])
    prompts, rng = _prompts(stacks[arch][0].vocab_size)
    outs = []
    for e in (je, te):
        r1 = e.step_mixed([(0, prompts[0])], [])
        r2 = e.step_mixed([(1, prompts[1]), (2, prompts[2])],
                          [(0, r1.tokens[0])])
        d = e.decode_batch([0, 1, 2], [r2.tokens[0], r2.tokens[1],
                                       r2.tokens[2]], steps=3)
        outs.append((r1.tokens, r2.tokens, r2.fused, d))
    assert outs[0] == outs[1]
    assert te.stats()["prefix_hit_tokens"] > 0
    _same(je, te, [0, 1, 2])


def test_long_prefill_fork_and_split_match_jax(stacks):
    """Chunked prefill with chunk-level matching, a COW fork diverging
    on the shared boundary page, an over-wide tick split across packed
    steps, and a decode batch over the ladder top."""
    je, te = _pair(stacks["qwen3-4b"], num_slots=4,
                   decode_buckets=(1, 2))
    vocab = stacks["qwen3-4b"][0].vocab_size
    rng = np.random.default_rng(3)
    long_p = rng.integers(1, vocab, 70).astype(np.int32)
    # five segments over 4 stream rows: split, never dense
    many = [(10 + i, rng.integers(1, vocab, 4).astype(np.int32))
            for i in range(5)]
    outs = []
    for e in (je, te):
        t0 = e.prefill_long(0, long_p)
        e.open_session(1)
        hit = e.adopt_prefix(1, long_p[:50])
        t1 = e.prefill_long(1, long_p[hit:60])     # chunk-level re-probe
        e.fork_session(0, 3)
        d = e.decode_batch([0, 3], [t0, t0 + 1], steps=2)  # COW on fork
        r = e.step_mixed(many, [])
        d2 = e.decode_batch([0, 1, 3], [d[0][-1], t1, d[3][-1]], steps=1)
        outs.append((t0, hit, t1, d, r.tokens, r.fused, d2))
    assert outs[0] == outs[1]
    assert outs[1][5] is False                       # split tick
    assert te.stats()["pages_cow_forked"] == 1
    _same(je, te, [0, 1, 3])


def test_greedy_ids_path_skips_the_logits_transfer(stacks):
    _, te = _pair(stacks["qwen3-4b"], keep_last_logits=False)
    prompts, _ = _prompts(stacks["qwen3-4b"][0].vocab_size)
    _, tk = _pair(stacks["qwen3-4b"])
    r = te.step_mixed([(0, prompts[0])], [])
    want = tk.step_mixed([(0, prompts[0])], [])
    assert r.tokens == want.tokens
    st = te.stats()
    assert st["fused_greedy_steps"] == 1 and st["logits_rows_shipped"] == 0


def test_engine_refuses_the_cpu_by_default():
    """No device given → CUDA; without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tcfg = tget("qwen3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, {})


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-32b"])
def test_config_branches_outside_the_slice_raise(stacks, arch):
    """No config branch is left outside the port: windowed, MoE and
    hybrid configs are served, and the host spill tier constructs on the
    page pool, its byte budget over pages of every leaf as the JAX
    engine counts them."""
    je, te = _pair(stacks[arch], host_pool_bytes=1 << 20)
    assert te.arena.host_pool_bytes == je.arena.host_pool_bytes == 1 << 20
    assert te.arena._page_bytes == je.arena._page_bytes > 1
    st_ = te.stats()
    assert st_["pages_spilled"] == st_["host_pool_pages"] == 0


def test_method_branches_outside_the_slice_raise(stacks):
    """Session export/import (item 13) is ported: a qwen3-4b session
    hands off between two engines as on the JAX engine.  A hybrid
    config (item 10) builds an engine that refuses handoff, as the
    reference's does (SSM state is no token sequence), and with the
    host spill tier asked for it constructs on the state-slot pool."""
    je, te = _pair(stacks["qwen3-4b"])
    _, te2 = _pair(stacks["qwen3-4b"])
    prompt = np.arange(1, 20) % stacks["qwen3-4b"][0].vocab_size
    assert je.prefill_batch([0], [prompt]) == te.prefill_batch([0], [prompt])
    jp, tp_ = je.export_session(0), te.export_session(0)
    assert (tp_.length, tp_.paged, tp_.token_ids) == \
        (jp.length, jp.paged, jp.token_ids)
    te2.import_session(0, tp_)
    assert te2.history(0) == te.history(0) == 19
    assert te2.arena.pages_of(0) == te.arena.pages_of(0)
    hcfg = tget("jamba-v0.1-52b")
    hp = ttr.init_params(hcfg, seed=0, device="cpu")
    e = Engine(hcfg, hp, EngineConfig(num_slots=2, max_len=32),
               device="cpu")
    assert e._paged and e.arena.state_slots and not e.can_spec
    assert not e.can_handoff
    with pytest.raises(AssertionError, match="handoff"):
        e.export_session(0)
    e = Engine(hcfg, hp, EngineConfig(num_slots=2, max_len=32,
                                      host_pool_bytes=1 << 20),
               device="cpu")
    assert e.arena.state_slots and e.arena.host_pool_bytes == 1 << 20


@pytest.mark.parametrize("kw", [
    dict(packed=False, paged_kv=False),
    dict(arena_prefill=False, paged_kv=False),
], ids=["unpacked", "gathered"])
def test_enable_spec_refuses_off_the_packed_arena_stream(stacks, kw):
    """Speculation rides the packed arena stream: like the JAX engine,
    ``enable_spec`` refuses an engine without it; the packed slot arena
    and the paged default accept."""
    from repro.serving.draft import NGramDraft as JNGram
    from repro_torch.serving.draft import NGramDraft
    je, te = _pair(stacks["qwen3-4b"], **kw)
    assert te.can_spec and je.can_spec
    with pytest.raises(AssertionError):
        je.enable_spec(JNGram(), k=4)
    with pytest.raises(AssertionError):
        te.enable_spec(NGramDraft(), k=4)
    assert not te.spec_enabled
    for ok in (dict(paged_kv=False), {}):
        _, te = _pair(stacks["qwen3-4b"], **ok)
        te.enable_spec(NGramDraft(), k=4)
        assert te.spec_enabled and te.spec_k == 4
        te.disable_spec()
        assert not te.spec_enabled
