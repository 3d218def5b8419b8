"""Dry run of the port at production scale, from ``repro.launch.dryrun``:
every (arch x shape) cell's real step (train, prefill, decode or
encode) run once on meta DTensors over a fake process group of the
mesh's world size (256 on 16 x 16, 512 on 2 x 16 x 16), without XLA.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch all|<id>] [--shape all|<name>] [--mesh single|multi|both] \\
        [--out reports/dryrun_torch] [--opt int8kv,int8w,moe-repl,accumN,
                                            gradbf16,lateconstrain]

Nothing is allocated and nothing runs on a device: every tensor is a
meta tensor holding only rank 0's shard, every collective a functional
collective on the fake group.  A ``TorchDispatchMode`` (:class:`Watch`)
under DTensor sees each local op and records, per device:

- ``memory.argument_bytes``: the step's arguments' local shards, exact;
  ``memory.output_bytes``: its outputs' (caches and optimizer state
  written in place count as outputs, as XLA's aliased outputs do);
  ``memory.peak_device_bytes``: the peak of live bytes during the step —
  each new storage's bytes added, subtracted when its last reference
  dies — which takes the place of XLA's temp and alias sizes.  The
  kernels allocate their outputs and workspace on meta tensors
  (``kernels/ops.py``), so the figure is theirs, not the plain
  versions'.  The reference's ``tpu_estimate_bytes`` corrects XLA's CPU
  legalisation of bf16 to f32, which meta tensors do not have: dropped.
- ``collectives``: every executed ``_c10d_functional`` collective, by
  kind, as the bytes of its result times the reference's ``WIRE``
  factors.  Python runs the loops (microbatches, layers), so each call
  is counted where it runs and no trip counts are inferred.  The figures
  come from DTensor's partitioner, not XLA's: a figure equal to the
  reference's is not expected.  On the fake group's CPU mesh DTensor
  runs an all-to-all as an all-gather and a chunk: it is counted as the
  all-to-all (its input's bytes), its gathered buffer as that many.
- ``cost.flops``: the matmuls' operations on the local shards
  (``torch.utils.flop_counter``); the attention and SSD kernels add
  none, so the roofline's compute term takes the larger of it and the
  model's useful FLOPs over the devices, as the reference does.

The roofline uses the card's constants: NVIDIA H100 80GB HBM3 (SXM, 700
W) dense bf16 989 TFLOP/s and HBM3 3.35 TB/s (NVIDIA's H100 data sheet,
the bound of ``PERF.md``), and a link of 50 GB/s a device: a 16-way
"model" axis spans two 8-GPU NVLink domains (DGX H100 nodes), so its
collectives cross the nodes' InfiniBand fabric, one 400 Gb/s
ConnectX-7 port a GPU (DGX H100 data sheet), not NVLink's 450 GB/s.
``compile_s`` is ``trace_s``, the wall time of the traced step.  The
train step returns its params as new tensors, where the reference
donates them: its peak includes that copy.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed.sharding import (SERVE_RULES, TRAIN_RULES,
                                              ShardingRules, shard_tree,
                                              use_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import ArgSpec, CellSpec, input_specs
from repro_torch.models import transformer as tr
from repro_torch.models.config import (SHAPES, ModelConfig, ShapeSpec,
                                       cell_supported, shape_by_name)
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.training.train_step import make_train_step

# NVIDIA H100 80GB HBM3 (SXM) constants, one device, for the roofline
PEAK_FLOPS = 989e12          # dense bf16, FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 50e9               # bytes/s a device: 400 Gb/s InfiniBand NDR

# wire multiplier: ring all-reduce moves ~2x the buffer
WIRE = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
        "all-to-all": 1.0, "collective-permute": 1.0}
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


@contextlib.contextmanager
def fake_world(size: int):
    """A fake default process group of ``size`` ranks (this process rank
    0) for the step's collectives, torn down on exit; an existing
    default group of that size is used as it is."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the dry run needs {size}")
        yield
        return
    dist.init_process_group("fake", rank=0, world_size=size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _storages(tree) -> List[torch.UntypedStorage]:
    out = []
    for x in tree_leaves(tree) if not isinstance(tree, torch.Tensor) \
            else [tree]:
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            out.append(x.untyped_storage())
    return out


def _nbytes(tree) -> int:
    seen, n = set(), 0
    for st in _storages(tree):
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


class Watch(TorchDispatchMode):
    """Live bytes and their peak, collectives and matmul FLOPs of the
    local ops it sees (DTensor ops are let through to DTensor, whose
    local ops and collectives then come here)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self.collectives: List[Tuple[str, int]] = []
        self.flops = 0

    def hold(self, tree) -> None:
        """Count the storages of ``tree`` (the arguments) as live."""
        for st in _storages(tree):
            self._track(st)

    def _track(self, st, nbytes: Optional[int] = None) -> None:
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)     # DTensor's shape propagation
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        res = out if isinstance(out, (list, tuple)) else [out]
        if func.namespace == "_c10d_functional" and \
                packet.__name__ in _KINDS:
            kind = _KINDS[packet.__name__]
            nbytes = sum(r.numel() * r.element_size() for r in res)
            if kind == "all-gather" and _in_alltoall():
                # the CPU mesh's stand-in for an all-to-all: count the
                # all-to-all, whose result is as large as its input
                kind, nbytes = "all-to-all", args[0].nbytes
                self._track(res[0].untyped_storage(), nbytes)
            self.collectives.append((kind, nbytes))
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        for t in res:
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())
        return out


def _in_alltoall() -> bool:
    """Whether DTensor's all-to-all is running as an all-gather and a
    chunk (its fallback on a CPU mesh: the fake group's)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def collective_bytes(records) -> Dict[str, float]:
    """Per-device collective wire bytes by kind from the recorded calls
    (kind, bytes of the result): each times its ``WIRE`` factor."""
    out: Dict[str, float] = {k: 0.0 for k in WIRE}
    for kind, nbytes in records:
        out[kind] += nbytes * WIRE[kind]
    out["total"] = sum(out[k] for k in WIRE)
    return out


def _materialise(tree, mesh):
    """Meta DTensors (this rank's shards) for a tree of ArgSpecs."""
    if isinstance(tree, ArgSpec):
        return tree.meta(mesh)
    if isinstance(tree, dict):
        return {k: _materialise(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialise(v, mesh) for v in tree)
    return tree


def build_step(cfg: ModelConfig, cell: CellSpec, mesh, rules: ShardingRules,
               opt_rules: Optional[ShardingRules] = None, opts=()):
    """Returns (fn, args): the cell's step and its meta DTensor
    arguments (params placed by ``rules``; a train step's optimizer
    state by ``opt_rules``, default ``rules``)."""
    axes = tr.param_axes(cfg)
    params = shard_tree(tr.param_shapes(cfg), axes, rules)
    args = tuple(_materialise(a, mesh) for a in cell.args)

    if cell.kind == "train":
        orules = opt_rules or rules
        f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"),
                       tr.param_shapes(cfg))
        opt = {"m": shard_tree(f32, axes, orules),
               "v": shard_tree(f32, axes, orules),
               "master": shard_tree(f32, axes, orules),
               "count": torch.zeros((), dtype=torch.int32, device="meta")}
        gdt = torch.bfloat16 if "gradbf16" in opts else torch.float32
        step = make_train_step(cfg, AdamWConfig(), accum=cell.accum,
                               remat=True, with_embeds=cell.with_embeds,
                               grad_dtype=gdt,
                               constrain_grads="lateconstrain" not in opts)
        return step, (params, opt) + args

    if cell.kind == "encode":
        def encode_step(params, embeds):
            return tr.forward(params, cfg, embeds=embeds)
        return encode_step, (params,) + args

    if cell.kind == "prefill":
        emb = cell.with_embeds

        def prefill_step(params, tokens, positions, caches, sample_idx):
            logits = tr.forward(params, cfg,
                                tokens=None if emb else tokens,
                                embeds=tokens if emb else None,
                                positions=positions, caches=caches,
                                logits_slice="last", dense_cache_write=True)
            return logits, caches
        return prefill_step, (params,) + args

    rolling = cell.rolling

    def decode_step(params, tokens, positions, caches):
        logits = tr.forward(params, cfg, tokens=tokens, positions=positions,
                            caches=caches, rolling=rolling,
                            logits_slice="last")
        return logits, caches
    return decode_step, (params,) + args


def _quant_wrap(fn, args, cell: CellSpec, opts):
    """Serving variants applied as wrappers, so model code stays as it
    is: int8w — weights of two or more dims stored int8, dequantized at
    use (a per-tensor static scale stands in for per-channel scales);
    int8kv — the bf16 KV cache stored int8, dequantized on read and
    requantized on write."""
    int8w = "int8w" in opts and cell.kind in ("prefill", "decode", "encode")
    int8kv = "int8kv" in opts and cell.kind in ("prefill", "decode")
    if not (int8w or int8kv):
        return fn, args

    def to_int8(x):
        return x.to(torch.int8) if x.dtype == torch.bfloat16 else x

    def deq(x):
        return (x.to(torch.bfloat16) / 16.0) if x.dtype == torch.int8 else x

    def quant(x):
        return torch.clamp(x.float() * 16.0, -127, 127).to(torch.int8)

    args = list(args)
    cache_pos = 3                       # (params, tokens, positions, caches)
    if int8w:
        args[0] = tree_map(lambda x: to_int8(x) if x.dim() >= 2 else x,
                           args[0])
    if int8kv:
        args[cache_pos] = tree_map(to_int8, args[cache_pos])

    def wrapped(params, *rest):
        if int8w:
            params = tree_map(deq, params)
        rest = list(rest)
        held = None
        if int8kv:
            held = rest[cache_pos - 1]
            rest[cache_pos - 1] = tree_map(deq, held)
        out = fn(params, *rest)
        if int8kv:
            logits, caches = out
            for c8, c in zip(tree_leaves(held), tree_leaves(caches)):
                if c8.dtype == torch.int8:
                    c8.copy_(quant(c))
            return logits, held
        return out

    return wrapped, tuple(args)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               rules: ShardingRules, opt_rules=None, opts=(),
               accum_override: Optional[int] = None) -> Dict[str, Any]:
    """Build the cell's step on ``mesh`` (any mesh: the production ones,
    a host mesh) and run it once on meta DTensors under ``rules``;
    returns {"memory", "collectives", "cost", "trace_s", "cell"}."""
    with use_rules(rules):
        cell = input_specs(cfg, shape, rules, accum_override)
        fn, args = build_step(cfg, cell, mesh, rules, opt_rules, opts)
        fn, args = _quant_wrap(fn, args, cell, opts)
        watch = Watch()
        watch.hold(args)
        arg_bytes = _nbytes(args)
        grad = torch.enable_grad() if cell.kind == "train" \
            else torch.no_grad()
        t0 = time.perf_counter()
        with watch, grad:
            out = fn(*args)
        trace_s = time.perf_counter() - t0
        out_bytes = _nbytes(out)
        peak = watch.peak
        del out, args
    return {"memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "peak_device_bytes": peak},
            "collectives": collective_bytes(watch.collectives),
            "cost": {"flops": float(watch.flops)},
            "trace_s": trace_s, "cell": cell}


def _roofline(rec: Dict, cfg: ModelConfig, shape: ShapeSpec,
              devices: int) -> None:
    """The reference's roofline terms, per device, seconds a step, with
    the H100's constants: compute from the larger of the counted matmul
    FLOPs and the model's useful FLOPs over the devices, memory from the
    peak bytes, collectives from the wire bytes."""
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mf = 2.0 * cfg.active_param_count() * tokens
    if shape.kind == "train":
        mf *= 3.0
    rec["model_flops"] = mf
    flops = max(rec["cost"]["flops"], mf / devices)
    rec["roofline"] = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": rec["memory"]["peak_device_bytes"] / HBM_BW,
        "collective_s": rec["collectives"]["total"] / LINK_BW,
    }
    terms = rec["roofline"]
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["mfu_ratio"] = (mf / devices) / flops if flops else 0.0
    rec["roofline_fraction"] = (mf / devices / PEAK_FLOPS) / \
        max(sum(terms.values()), 1e-12)


def cell_rules(shape: ShapeSpec, mesh, multi_pod: bool, opts=()):
    """(rules, opt_rules) of a cell, as the reference's ``run_cell``:
    TRAIN_RULES or SERVE_RULES (serving batches over pod and data on
    the multi-pod mesh); ``moe-repl`` replicates the live expert
    weights over data while their optimizer state stays FSDP-sharded."""
    base = TRAIN_RULES if shape.kind == "train" else SERVE_RULES
    rules_map = dict(base)
    if multi_pod and shape.kind != "train":
        rules_map["batch"] = ("pod", "data")
    opt_rules = None
    if "moe-repl" in opts:
        rules_map["expert_embed"] = None
        opt_map = dict(rules_map)
        opt_map["expert_embed"] = "data"
        opt_rules = ShardingRules(mesh=mesh, rules=opt_map)
    return ShardingRules(mesh=mesh, rules=rules_map), opt_rules


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, verbose: bool = True,
             opts: Tuple[str, ...] = (),
             cfg: Optional[ModelConfig] = None) -> Dict:
    """One cell on the production mesh over a fake world of its size.
    ``cfg``: a config to run under the name ``arch`` (default: the
    registered one)."""
    cfg = cfg or get_config(arch)
    shape = shape_by_name(shape_name)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        if verbose:
            print(f"[dryrun] {arch:20s} {shape_name:12s} skipped: {why}")
        return {"arch": arch, "shape": shape_name, "skipped": why}
    size = 512 if multi_pod else 256
    accum_override = None
    for o in opts:
        if o.startswith("accum"):
            accum_override = int(o[len("accum"):])
    with fake_world(size):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules, opt_rules = cell_rules(shape, mesh, multi_pod, opts)
        rec: Dict = {"arch": arch, "shape": shape_name,
                     "mesh": "2x16x16" if multi_pod else "16x16",
                     "devices": mesh.size(), "opts": list(opts)}
        traced = trace_cell(cfg, shape, mesh, rules, opt_rules, opts,
                            accum_override)
    rec["trace_s"] = traced["trace_s"]
    rec["memory"] = traced["memory"]
    rec["cost"] = traced["cost"]
    rec["collectives"] = traced["collectives"]
    _roofline(rec, cfg, shape, rec["devices"])

    if verbose:
        m = rec["memory"]["peak_device_bytes"] / 2**30
        r = rec["roofline"]
        c = rec["collectives"]
        print(f"[dryrun] {arch:20s} {shape_name:12s} {rec['mesh']:8s} "
              f"trace {rec['trace_s']:6.1f}s  mem/dev {m:7.2f} GiB  "
              f"coll {c['total'] / 2**30:8.3f} GiB (ag "
              f"{c['all-gather'] / 2**30:.3f} ar "
              f"{c['all-reduce'] / 2**30:.3f} rs "
              f"{c['reduce-scatter'] / 2**30:.3f})  "
              f"comp {r['compute_s'] * 1e3:8.2f}ms mem "
              f"{r['memory_s'] * 1e3:8.2f}ms coll "
              f"{r['collective_s'] * 1e3:8.2f}ms  -> {rec['bottleneck']}",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{rec['mesh']}"
        if opts:
            tag += "_" + "-".join(opts)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--opt", default="",
                    help="comma-separated: int8kv,int8w,moe-repl,accumN,"
                         "gradbf16,lateconstrain")
    args = ap.parse_args()

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    opts = tuple(o for o in args.opt.split(",") if o)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, mp, args.out, opts=opts)
                except Exception as e:  # noqa: BLE001  (report every cell)
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape} multi={mp}: {e}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: "
                         + "; ".join(str(f[:3]) for f in failures))
    print("[dryrun] ALL CELLS PASSED")


if __name__ == "__main__":
    main()
