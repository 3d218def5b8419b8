"""Sharded numerics of the port at world size 4 on the CPU: four gloo
processes on a (2, 2) ("data", "model") mesh run the port's steps on
DTensors placed by ``SERVE_RULES`` and ``TRAIN_RULES``, against the
reference run under the same rules on a (2, 2) mesh of 4 host devices
in one module-scoped subprocess (params from the reference's init,
converted with ``params_from_numpy``).

- the dense ``forward``'s logits, and a prefill (``dense_cache_write``,
  and for the attention configs under ``SERVE_RULES`` also written at
  its positions, L tokens a row, into the sequence-sharded caches) then
  a decode step over the sharded caches, for the fp32 smoke configs
  of qwen3-4b, qwen3-moe-30b-a3b (16 experts: the capacity dispatch)
  and mamba2-2.7b: within 1e-4, the same greedy tokens (the reference's
  own sharded and unsharded forwards differ by up to 1.3e-5: an
  all-reduce sums partials in another order);
- ``moe_layer`` alone with a router that crowds one data shard's tokens
  onto two experts: the per-shard capacity drops what one shard's would
  keep, the port follows the reference's drops and differs from the
  one-shard result;
- one qwen3-4b train step under ``TRAIN_RULES`` against the reference's
  jitted step: loss and grad norm, and Adam's first moment (a tenth of
  the grads) within ``test_torch_training.py``'s tolerances;
- the legacy rolling cache, ``forward(rolling=True)`` one token a step
  on mixtral's smoke config (window 32, 40 tokens), against the
  reference's step logits at 1e-5 (in this process).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-2.7b")
B, L = 4, 16                       # a prefill of L, then one decode step
TOL = 1e-4


def smoke(arch):
    """The fp32 smoke config; qwen3-moe with 16 experts (past 8 the
    model takes the capacity dispatch)."""
    cfg = get_smoke(arch).replace(dtype="float32")
    return cfg.replace(num_experts=16) if arch.startswith("qwen3-moe") \
        else cfg


REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke
    from repro.distributed.sharding import (SERVE_RULES, TRAIN_RULES,
                                            ShardingRules, tree_shardings,
                                            use_rules)
    from repro.models import transformer as tr
    from repro.models.moe import moe_layer
    from repro.optim import adamw
    from repro.training import train_step as ts

    B, L = %(b)d, %(l)d
    inp = pickle.load(open(sys.argv[1], "rb"))
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(auto, auto))
    tree = lambda t: jax.tree.map(jnp.asarray, t)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    out = {}
    for arch in %(archs)r:
        cfg = get_smoke(arch).replace(dtype="float32")
        if arch.startswith("qwen3-moe"):
            cfg = cfg.replace(num_experts=16)
        params, tok = tree(inp[arch]["params"]), inp[arch]["tokens"]
        axes = tr.param_axes(cfg)
        pos = jnp.broadcast_to(jnp.arange(L + 1)[None], (B, L + 1))

        def steps(p, tok):
            logits = tr.forward(p, cfg, tokens=tok[:, :L])[0]
            c = tr.init_cache(cfg, B, L + 2)
            l1, c, _ = tr.forward(p, cfg, tokens=tok[:, :L],
                                  positions=pos[:, :L], caches=c,
                                  logits_slice="last")
            l2, c, _ = tr.forward(p, cfg, tokens=tok[:, L:],
                                  positions=pos[:, L:], caches=c,
                                  logits_slice="last")
            return logits, l1, l2

        for name, table in (("serve", SERVE_RULES), ("train", TRAIN_RULES)):
            rules = ShardingRules(mesh=mesh, rules=dict(table))
            with use_rules(rules), mesh:
                sp = jax.device_put(params,
                                    tree_shardings(params, axes, rules))
                out[arch + "|" + name] = np_(jax.jit(steps)(sp, tok))

    # moe_layer alone under SERVE_RULES, and one shard (no rules)
    cfg = get_smoke("qwen3-moe-30b-a3b").replace(dtype="float32",
                                                  num_experts=16)
    ffn, x = tree(inp["moe"]["ffn"]), jnp.asarray(inp["moe"]["x"])
    k = cfg.num_experts_per_tok
    with use_rules(ShardingRules(mesh=mesh, rules=dict(SERVE_RULES))), mesh:
        y = jax.jit(lambda p, x: moe_layer(p, x, top_k=k)[0])(ffn, x)
    y_one = moe_layer(ffn, x, top_k=k)[0]
    out["moe"] = {"y": np.asarray(y), "y_one": np.asarray(y_one)}

    # one train step of 2 microbatches under TRAIN_RULES
    cfg = get_smoke("qwen3-4b").replace(dtype="float32")
    t = inp["train"]
    params = tree(t["params"])
    axes = tr.param_axes(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rules = ShardingRules(mesh=mesh, rules=dict(TRAIN_RULES))
    with use_rules(rules), mesh:
        sp = jax.device_put(params, tree_shardings(params, axes, rules))
        p2, s2, m = jax.jit(ts.make_train_step(cfg, ocfg, accum=2))(
            sp, adamw.adamw_init(sp), tree(t["batch"]))
    out["train"] = {"m": jax.tree.leaves(np_(s2["m"])),
                    "metrics": {k: float(v) for k, v in m.items()}}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _inputs():
    """The checks' inputs from the reference's init (numpy trees)."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_smoke(arch).replace(dtype="float32")
        if arch.startswith("qwen3-moe"):
            jcfg = jcfg.replace(num_experts=16)
        params, _ = jtr.init_params(jcfg, jax.random.key(3))
        out[arch] = {"params": jax.tree.map(np.asarray, params),
                     "tokens": np.asarray(jax.random.randint(
                         jax.random.key(4), (B, L + 1), 0,
                         jcfg.vocab_size))}
    # moe_layer alone: shard 0's tokens (batch rows 0, 1) lead with
    # experts 0 and 1, and shard 1's tie on every expert (stable: 0, 1):
    # a shard's 16 tokens overfill its capacity of 3, one shard's 5
    jcfg = jget_smoke("qwen3-moe-30b-a3b").replace(dtype="float32",
                                                   num_experts=16)
    params, _ = jtr.init_params(jcfg, jax.random.key(6))
    ffn = jax.tree.map(lambda a: np.array(a[0]), params["blocks"][0]["ffn"])
    ffn["router"][:] = 0.0
    ffn["router"][0, 0], ffn["router"][0, 1] = 8.0, 6.0
    x = np.array(jax.random.normal(jax.random.key(7), (B, 8, jcfg.d_model)))
    x[:, :, 0] = 0.0
    x[:2, :, 0] = 4.0
    out["moe"] = {"ffn": ffn, "x": x}
    jcfg = jget_smoke("qwen3-4b").replace(dtype="float32")
    params, _ = jtr.init_params(jcfg, jax.random.key(5))
    rng = np.random.default_rng(8)
    out["train"] = {
        "params": jax.tree.map(np.asarray, params),
        "batch": {k: rng.integers(0, jcfg.vocab_size, (2, B, 8)
                                  ).astype(np.int32)
                  for k in ("tokens", "labels")}}
    return out


def _worker(rank, init, inp_path, out_path):
    """One of the four gloo ranks: every sharded step; rank 0 writes the
    full results (each step's collectives run on every rank)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.moe import moe_layer
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         tree_leaves, tree_map)
    from repro_torch.training.train_step import make_train_step
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        inp = pickle.load(open(inp_path, "rb"))
        res = {}
        for arch in ARCHS:
            cfg = smoke(arch)
            params = params_from_numpy(inp[arch]["params"], cfg, "cpu")
            tok = torch.from_numpy(inp[arch]["tokens"])
            pos = torch.arange(L + 1)[None].expand(B, L + 1)
            for name, table in (("serve", sh.SERVE_RULES),
                                ("train", sh.TRAIN_RULES)):
                rules = sh.ShardingRules(mesh, dict(table))
                with sh.use_rules(rules), torch.no_grad():
                    dp = sh.shard_tree(params, tr.param_axes(cfg), rules)
                    logits = tr.forward(dp, cfg, tokens=tok[:, :L])
                    caches = sh.shard_tree(
                        tr.init_cache(cfg, B, L + 2, device="cpu"),
                        tr.cache_logical_axes(cfg), rules)
                    l1 = tr.forward(dp, cfg, tokens=tok[:, :L],
                                    positions=pos[:, :L], caches=caches,
                                    logits_slice="last",
                                    dense_cache_write=True)
                    l2 = tr.forward(dp, cfg, tokens=tok[:, L:],
                                    positions=pos[:, L:], caches=caches,
                                    logits_slice="last")
                    res[f"{arch}|{name}"] = [x.full_tensor().numpy()
                                             for x in (logits, l1, l2)]
                    res[f"{arch}|{name}|cache"] = str(
                        next(iter(caches[0].values())).placements)
                    if name != "serve" or arch == "mamba2-2.7b":
                        continue
                    # the prefill written token by token at its positions
                    # (write_rows) into the sequence-sharded caches
                    caches = sh.shard_tree(
                        tr.init_cache(cfg, B, L + 2, device="cpu"),
                        tr.cache_logical_axes(cfg), rules)
                    r1 = tr.forward(dp, cfg, tokens=tok[:, :L],
                                    positions=pos[:, :L], caches=caches,
                                    logits_slice="last")
                    r2 = tr.forward(dp, cfg, tokens=tok[:, L:],
                                    positions=pos[:, L:], caches=caches,
                                    logits_slice="last")
                    res[f"{arch}|rows"] = [x.full_tensor().numpy()
                                           for x in (r1, r2)]
                    res[f"{arch}|rows|cache"] = str(
                        next(iter(caches[0].values())).placements)

        cfg = smoke("qwen3-moe-30b-a3b")
        ffn = tree_map(torch.from_numpy, inp["moe"]["ffn"])
        x = torch.from_numpy(inp["moe"]["x"])
        k = cfg.num_experts_per_tok
        one = moe_layer(ffn, x, top_k=k)[0].numpy()
        rules = sh.ShardingRules(mesh, dict(sh.SERVE_RULES))
        axes = tr.param_axes(cfg)["blocks"][0]["ffn"]
        with sh.use_rules(rules), torch.no_grad():
            dffn = sh.shard_tree(ffn, {n: a[1:] for n, a in axes.items()},
                                 rules)
            dx = sh.shard(x, sh.placements(sh.spec_for(
                x.shape, ("batch", "seq", "embed_act"), rules), mesh), mesh)
            y = moe_layer(dffn, dx, top_k=k)[0].full_tensor().numpy()
        res["moe"] = {"y": y, "y_one": one}

        cfg = smoke("qwen3-4b")
        t = inp["train"]
        params = params_from_numpy(t["params"], cfg, "cpu")
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        rules = sh.ShardingRules(mesh, dict(sh.TRAIN_RULES))
        with sh.use_rules(rules):
            dp = sh.shard_tree(params, tr.param_axes(cfg), rules)
            _, s2, mt = make_train_step(cfg, ocfg, accum=2)(
                dp, adamw_init(dp), t["batch"])
            res["train"] = {
                "m": [x.full_tensor().numpy() for x in tree_leaves(s2["m"])],
                "metrics": {kk: float(v.full_tensor()
                                      if hasattr(v, "full_tensor") else v)
                            for kk, v in mt.items()}}
        if rank == 0:
            pickle.dump(res, open(out_path, "wb"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, port) results: the reference's subprocess and the
    four gloo ranks run side by side from one pickled set of inputs."""
    d = tmp_path_factory.mktemp("sharded")
    inp, ref_out, port_out = d / "inputs.pkl", d / "ref.pkl", d / "port.pkl"
    pickle.dump(_inputs(), open(inp, "wb"))
    code = REF % {"b": B, "l": L, "archs": ARCHS}
    ref = subprocess.Popen(
        [sys.executable, "-c", code, str(inp), str(ref_out)],
        env=dict(os.environ, PYTHONPATH=str(SRC)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, "file://" + str(d / "init"), str(inp),
                               str(port_out))) for r in range(4)]
    for p in procs:
        p.start()
    try:
        _, err = ref.communicate(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return (pickle.load(open(ref_out, "rb")),
            pickle.load(open(port_out, "rb")))


@pytest.mark.parametrize("rules", ["serve", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_the_reference(results, arch, rules):
    """The forward's logits, the prefill's and the decode step's: within
    1e-4 and the same greedy tokens.  Under SERVE_RULES the caches'
    sequence is sharded over "model" (the decode merges two shards'
    partials)."""
    ref, port = results
    key = f"{arch}|{rules}"
    for got, want in zip(port[key], ref[key]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < TOL, key
        assert (got.argmax(-1) == want.argmax(-1)).all(), key
    if arch != "mamba2-2.7b" and rules == "serve":
        assert "Shard(dim=2)" in port[key + "|cache"]   # (G, B, S, ...)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_multi_token_write_into_a_sequence_sharded_cache(results, arch):
    """Under SERVE_RULES a prefill written at its positions (L tokens a
    row, each on the shard that holds its position) into caches whose
    sequence is sharded over "model", then a decode step merging the two
    shards' partials by their lse: the logits of both within 1e-4 of the
    reference's unsharded-cache steps, the same greedy tokens."""
    ref, port = results
    for got, want in zip(port[f"{arch}|rows"], ref[f"{arch}|serve"][1:]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < TOL, arch
        assert (got.argmax(-1) == want.argmax(-1)).all(), arch
    assert "Shard(dim=2)" in port[f"{arch}|rows|cache"]


def test_moe_layer_follows_the_shard_local_drops(results):
    ref, port = results
    y, one = port["moe"]["y"], port["moe"]["y_one"]
    assert np.abs(y - ref["moe"]["y"]).max() < 1e-5
    assert np.abs(one - ref["moe"]["y_one"]).max() < 1e-5
    # the per-shard capacity dropped pairs that one shard's keeps
    assert np.abs(y - one).max() > 1e-2


def test_sharded_train_step_matches_the_reference(results):
    ref, port = results
    for k in ("loss", "lr", "grad_norm"):
        assert port["train"]["metrics"][k] == pytest.approx(
            ref["train"]["metrics"][k], rel=1e-5), k
    got, want = port["train"]["m"], ref["train"]["m"]
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)


def test_rolling_cache_matches_the_reference():
    """``forward(rolling=True)`` one token a step over a window-deep
    cache (mixtral's smoke config: window 32, 40 tokens, past the
    window), each step's logits against the reference's at 1e-5."""
    jcfg = jget_smoke("mixtral-8x7b")
    cfg = get_smoke("mixtral-8x7b")
    params, _ = jtr.init_params(jcfg, jax.random.key(1))
    t = 40
    tok = np.asarray(jax.random.randint(jax.random.key(2), (1, t), 0,
                                        jcfg.vocab_size))
    w = jcfg.sliding_window
    jcaches = jtr.init_cache(jcfg, 1, w)
    jstep = jax.jit(lambda p, x, q, c: jtr.forward(
        p, jcfg, tokens=x, positions=q, caches=c, rolling=True)[:2])
    tp = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    caches = tr.init_cache(cfg, 1, w, device="cpu")
    assert caches[0]["k"].shape[2] == w
    worst = 0.0
    with torch.no_grad():
        for i in range(t):
            pos = np.full((1, 1), i, np.int32)
            jl, jcaches = jstep(params, jnp.asarray(tok[:, i:i + 1]),
                                jnp.asarray(pos), jcaches)
            lo = tr.forward(tp, cfg, tokens=torch.from_numpy(tok[:, i:i + 1]),
                            positions=torch.from_numpy(pos), caches=caches,
                            rolling=True)
            worst = max(worst, float(np.abs(lo.numpy() - np.asarray(jl)).max()))
    assert worst < 1e-5, worst
