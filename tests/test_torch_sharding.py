"""The port's logical-axis sharding rules (``repro_torch.distributed``)
against the reference's (``repro.distributed.sharding``): the reference's
own cases, on real DeviceMeshes over a fake process group; the specs of
every param, cache and step input leaf, for every registered config and
dry-run shape, on the 1 x 1, 16 x 16 and 2 x 16 x 16 meshes under
``TRAIN_RULES``, ``SERVE_RULES`` and the ``moe-repl`` tables, equal to
the reference's leaf for leaf; and the dry run's argument bytes on the
host mesh equal to XLA's ``argument_size_in_bytes`` of the reference's
step.  The reference runs in one module-scoped subprocess with 512 host
devices and writes its side as JSON."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.configs import all_configs, get_smoke  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    SERVE_RULES, TRAIN_RULES, ShardingRules, constrain, current_rules,
    placements, spec_for, tree_shardings, use_rules)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.config import SHAPES, shape_by_name  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the host-mesh cells whose argument bytes are held to XLA's
ARG_CELLS = (("qwen3-4b", "decode_32k"), ("qwen3-4b", "train_4k"),
             ("qwen3-moe-30b-a3b", "decode_32k"))


class mesh_of:
    """A DeviceMesh of ``MESHES[name]`` over a fake world of its size,
    the world torn down on exit."""

    def __init__(self, name):
        self.shape, self.names = MESHES[name]
        self._world = dryrun.fake_world(math.prod(self.shape))

    def __enter__(self):
        self._world.__enter__()
        return init_device_mesh("cpu", self.shape,
                                mesh_dim_names=self.names)

    def __exit__(self, *exc):
        return self._world.__exit__(*exc)


def rules(mesh, table=TRAIN_RULES):
    return ShardingRules(mesh=mesh, rules=dict(table))


# ------------------------------------------ the reference's own cases


def test_spec_basic():
    with mesh_of("1x1") as mesh:
        assert spec_for((64, 128), ("embed", "mlp"), rules(mesh)) == \
            ("data", "model")


def test_divisibility_guard():
    """On a real 16-way model axis (the reference could only emulate
    one): 8 KV heads do not divide it and replicate; 32 query heads
    shard."""
    with mesh_of("16x16") as mesh:
        r = rules(mesh)
        assert spec_for((8,), ("kv_heads",), r) == (None,)
        assert spec_for((32,), ("heads",), r) == ("model",)
        # the guard reads the dim's size: 8 heads of 128 columns divide
        assert spec_for((4096, 1024), ("embed", "kv_heads"), r) == \
            ("data", "model")


def test_duplicate_axis_dropped():
    with mesh_of("1x1") as mesh:
        s = spec_for((64, 64), ("heads", "mlp"), rules(mesh))
        names = [n for a in s if a is not None
                 for n in (a if isinstance(a, tuple) else (a,))]
        assert len(names) == len(set(names)) and s == ("model", None)


def test_constrain_noop_without_rules():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", "seq") is x


def test_tree_shardings():
    with mesh_of("1x1") as mesh:
        sh = tree_shardings({"w": torch.ones(8, 16)},
                            {"w": ("embed", "mlp")}, rules(mesh))
        assert sh["w"] == (Shard(0), Shard(1))


def test_serve_rules_replicate_weights_over_data():
    with mesh_of("1x1") as mesh:
        assert spec_for((64, 128), ("embed", "mlp"),
                        rules(mesh, SERVE_RULES)) == (None, "model")


def test_use_rules_context():
    assert current_rules() is None
    with mesh_of("1x1") as mesh:
        with use_rules(rules(mesh)):
            assert current_rules() is not None
    assert current_rules() is None


# ------------------------------------------------ the port's additions


def test_constrain_refuses_a_plain_tensor_under_a_mesh():
    """A path that lost its placements raises, naming the axes."""
    with mesh_of("1x1") as mesh, use_rules(rules(mesh)):
        with pytest.raises(ValueError, match=r"'batch', 'seq'"):
            constrain(torch.ones(4, 4), "batch", "seq")


def test_tuple_axes_follow_the_mesh_order():
    """("pod", "data") on one dim: Shard on both mesh dims, pod major —
    rank r's shard is JAX's (r // 16 over pod, r % 16 over data)."""
    with mesh_of("2x16x16") as mesh:
        r = rules(mesh)
        spec = spec_for((64, 8), ("batch", None), r)
        assert spec == (("pod", "data"), None)
        assert placements(spec, mesh) == (Shard(0), Shard(0), Replicate())
        with pytest.raises(ValueError, match="mesh's order"):
            placements((("data", "pod"), None), mesh)


# ------------------------------------------------------- spec parity


REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                               "--xla_backend_optimization_level=0")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import json, sys
    import jax
    from repro.configs import all_configs, get_smoke
    from repro.distributed.sharding import (SERVE_RULES, TRAIN_RULES,
                                            ShardingRules, spec_for,
                                            use_rules)
    from repro.launch import dryrun
    from repro.launch.specs import input_specs
    from repro.models import transformer as tr
    from repro.models.config import SHAPES, shape_by_name

    MESHES = %(meshes)s
    ARG_CELLS = %(cells)s

    def sp(p):
        return [list(a) if isinstance(a, tuple) else a for a in p]

    def tables(multi):
        out = {"train": dict(TRAIN_RULES), "serve": dict(SERVE_RULES)}
        if multi:
            out["serve"]["batch"] = ("pod", "data")
        repl = dict(TRAIN_RULES)
        repl["expert_embed"] = None
        out["moe-repl"] = repl
        opt = dict(repl)
        opt["expert_embed"] = "data"
        out["moe-repl-opt"] = opt
        return out

    auto = jax.sharding.AxisType.Auto
    res = {"params": {}, "inputs": {}, "arg_bytes": {}}
    for mname, (shape, names) in MESHES.items():
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             axis_types=(auto,) * len(shape))
        tabs = tables(len(shape) == 3)
        for tname, table in tabs.items():
            r = ShardingRules(mesh=mesh, rules=table)
            for arch, cfg in all_configs().items():
                shapes, axes = tr.init_params(cfg, abstract=True)
                sl = jax.tree.leaves(shapes)
                al = jax.tree.leaves(axes,
                                     is_leaf=lambda x: isinstance(x, tuple))
                res["params"]["|".join((mname, tname, arch))] = [
                    sp(spec_for(s.shape, a, r)) for s, a in zip(sl, al)]
        for arch, cfg in all_configs().items():
            for shp in SHAPES:
                table = tabs["train" if shp.kind == "train" else "serve"]
                r = ShardingRules(mesh=mesh, rules=table)
                cell = input_specs(cfg, shp, r)
                res["inputs"]["|".join((mname, arch, shp.name))] = [
                    [list(s.shape), str(s.dtype), sp(s.sharding.spec)]
                    for s in jax.tree.leaves(cell.args)]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(auto,) * 2)
    for arch, shape_name in ARG_CELLS:
        cfg = get_smoke(arch)
        shp = shape_by_name(shape_name)
        r = ShardingRules(mesh=mesh, rules=dict(
            TRAIN_RULES if shp.kind == "train" else SERVE_RULES))
        with use_rules(r):
            cell = input_specs(cfg, shp, r)
            fn, args = dryrun.build_step(cfg, cell, mesh, r)
            with mesh:
                ma = jax.jit(fn).lower(*args).compile().memory_analysis()
        res["arg_bytes"][arch + "|" + shape_name] = \\
            ma.argument_size_in_bytes
    json.dump(res, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("spec_parity") / "ref.json"
    code = REF % {"meshes": repr({k: [list(s), list(n)]
                                  for k, (s, n) in MESHES.items()}),
                  "cells": repr(ARG_CELLS)}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _sp(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _tables(multi):
    # the rule tables the dry run builds (``dryrun.cell_rules``)
    out = {"train": dict(TRAIN_RULES), "serve": dict(SERVE_RULES)}
    if multi:
        out["serve"]["batch"] = ("pod", "data")
    repl = dict(TRAIN_RULES)
    repl["expert_embed"] = None
    out["moe-repl"] = repl
    opt = dict(repl)
    opt["expert_embed"] = "data"
    out["moe-repl-opt"] = opt
    return out


@pytest.mark.parametrize("mname", list(MESHES))
def test_spec_parity(ref, mname):
    """Every param leaf's spec (``param_axes``) under each rule table,
    and every step input's shape, dtype and spec (``input_specs``: the
    tokens, positions, labels and the cache tree of
    ``cache_logical_axes``) for every dry-run shape, for every
    registered config, equal to the reference's."""
    multi = len(MESHES[mname][0]) == 3
    with mesh_of(mname) as mesh:
        tabs = _tables(multi)
        assert dryrun.cell_rules(shape_by_name("decode_32k"), mesh, multi,
                                 ("moe-repl",))[0].rules == {
            **tabs["serve"], "expert_embed": None}
        n = 0
        for tname, table in tabs.items():
            r = ShardingRules(mesh=mesh, rules=table)
            for arch, cfg in all_configs().items():
                shapes = tree_leaves(tr.param_shapes(cfg))
                axes = _axes_leaves(tr.param_axes(cfg))
                got = [_sp(spec_for(s.shape, a, r))
                       for s, a in zip(shapes, axes)]
                assert got == ref["params"]["|".join((mname, tname, arch))], \
                    (mname, tname, arch)
                n += len(got)
        for arch, cfg in all_configs().items():
            for shp in SHAPES:
                table = tabs["train" if shp.kind == "train" else "serve"]
                cell = input_specs(cfg, shp, ShardingRules(mesh, table))
                got = [[list(a.shape), _dtype(a.dtype), _sp(a.spec)]
                       for a in tree_leaves(list(cell.args))]
                assert got == ref["inputs"]["|".join((mname, arch,
                                                       shp.name))], \
                    (mname, arch, shp.name)
                n += len(got)
        assert n > 1000


def _axes_leaves(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    if isinstance(tree, list):
        return [a for v in tree for a in _axes_leaves(v)]
    return [tree]


def _dtype(dt):
    return {torch.int32: "int32", torch.bfloat16: "bfloat16",
            torch.float32: "float32"}[dt]


@pytest.mark.parametrize("arch,shape_name", ARG_CELLS)
def test_argument_bytes_equal_xla(ref, arch, shape_name):
    """The dry run's exact argument bytes on the host mesh (params,
    caches or optimizer state and batch, each a local shard) equal
    XLA's ``argument_size_in_bytes`` of the reference's step."""
    cfg = get_smoke(arch)
    shp = shape_by_name(shape_name)
    with mesh_of("1x1") as mesh:
        r = ShardingRules(mesh, dict(TRAIN_RULES if shp.kind == "train"
                                     else SERVE_RULES))
        with use_rules(r):
            cell = input_specs(cfg, shp, r)
            _, args = dryrun.build_step(cfg, cell, mesh, r)
            got = dryrun._nbytes(args)
    assert got == ref["arg_bytes"][arch + "|" + shape_name]
