"""Logical-axis sharding rules of the port, from
``repro.distributed.sharding``, over ``torch.distributed``'s DeviceMesh
and DTensor.

Model code names each tensor dim by a *logical* axis ("batch", "seq",
"embed", "heads", ...).  A :class:`ShardingRules` maps logical names to
mesh axes; :func:`spec_for` turns a shape and its logical names into a
spec — a tuple with one entry per dim, each ``None``, a mesh-axis name
or a tuple of names (the counterpart of a JAX ``PartitionSpec``) — and
:func:`placements` turns a spec into DTensor placements.
:func:`constrain` redistributes a DTensor to its spec's placements when
a mesh is active and is a no-op without rules or a mesh (tests, the
serving engine, one card without a mesh).  Under a mesh a plain tensor
raises: a path that lost its placements must not pass silently.

Divisibility guard: a logical→mesh mapping is dropped per tensor when
the dimension does not divide by the mesh axis' size (8 KV heads on a
16-way model axis), so one rule table serves every architecture.
Duplicate-axis guard: a mesh axis names at most one dim of a spec; a
later dim that would reuse it is replicated.

A tuple of mesh axes on one dim ("batch": ("pod", "data")) shards it in
the tuple's order, major to minor, as JAX does; DTensor shards a dim
over several mesh dims in the mesh's order, so the tuple must follow
the mesh's order (the production meshes list "pod" before "data").
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]


# Rule tables: logical axis -> mesh axis (or tuple). "pod" present only on
# multi-pod meshes; axis_size() treats missing axes as 1.
TRAIN_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",            # FSDP: weight in-dim sharded over data
    "expert_embed": "data",     # MoE expert weight FSDP (hillclimb: None)
    "embed_act": None,          # activations keep d_model unsharded
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_ch": "model",
    "cache_seq": None,
    "opt_shard": "data",        # ZeRO-1 extra partition for optimizer state
}

SERVE_RULES: Dict[str, AxisVal] = {
    "batch": "data",
    "seq": None,
    "embed": None,              # weights TP-only, replicated over data
    "expert_embed": None,
    "embed_act": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_ch": "model",
    "cache_seq": "model",       # flash-decode: KV seq sharded over model
    "opt_shard": None,
}


def mesh_axis_sizes(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{mesh axis name: size} of ``mesh`` ({} without one)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass
class ShardingRules:
    mesh: Optional[DeviceMesh]
    rules: Dict[str, AxisVal]

    def axis_size(self, axis: AxisVal) -> int:
        if axis is None or self.mesh is None:
            return 1
        sizes = mesh_axis_sizes(self.mesh)
        names = (axis,) if isinstance(axis, str) else axis
        n = 1
        for a in names:
            n *= sizes.get(a, 1)
        return n

    def mesh_axes(self, logical: Optional[str]) -> AxisVal:
        if logical is None:
            return None
        val = self.rules.get(logical)
        if val is None or self.mesh is None:
            return None
        sizes = mesh_axis_sizes(self.mesh)
        names = (val,) if isinstance(val, str) else tuple(val)
        names = tuple(a for a in names if a in sizes)
        if not names:
            return None
        return names[0] if len(names) == 1 else names


_local = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_local, "rules", None)


def _has_mesh(rules: Optional[ShardingRules]) -> bool:
    return rules is not None and rules.mesh is not None


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` the current rules of this thread.  The outermost
    rules with a mesh also let plain tensors (constants a step makes:
    rope frequencies, masks, zeros) stand as replicated DTensors beside
    the sharded ones (``implicit_replication``)."""
    prev = current_rules()
    _local.rules = rules
    outer = _has_mesh(rules) and not _has_mesh(prev)
    try:
        with implicit_replication() if outer else contextlib.nullcontext():
            yield rules
    finally:
        _local.rules = prev


def _dim_spec(rules: ShardingRules, dim: int,
              logical: Optional[str]) -> AxisVal:
    axes = rules.mesh_axes(logical)
    if axes is None:
        return None
    if dim % rules.axis_size(axes) != 0:
        return None  # divisibility guard: drop mapping
    return axes


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             rules: Optional[ShardingRules] = None) -> Spec:
    """The spec of a tensor of ``shape`` whose dims are named
    ``logical_axes``: one entry per dim (``()`` without rules or a
    mesh, as the reference's ``P()``)."""
    rules = rules or current_rules()
    if not _has_mesh(rules):
        return ()
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"logical axes {tuple(logical_axes)}")
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        ax = _dim_spec(rules, dim, name)
        # a mesh axis may appear at most once in a spec
        if ax is not None:
            flat = (ax,) if isinstance(ax, str) else ax
            if any(a in used for a in flat):
                ax = None
            else:
                used.update(flat)
        parts.append(ax)
    return tuple(parts)


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that names tensor dim d, ``Replicate()`` on the others."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        flat = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in flat]
        if idx != sorted(idx):
            raise ValueError(f"axes {flat} of dim {d} do not follow the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_sharding(shape: Sequence[int],
                     logical_axes: Sequence[Optional[str]],
                     rules: ShardingRules) -> Optional[Tuple]:
    """Placements of a tensor of ``shape`` named ``logical_axes`` under
    ``rules`` (None without a mesh)."""
    if rules.mesh is None:
        return None
    return placements(spec_for(shape, logical_axes, rules), rules.mesh)



def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute DTensor ``x`` to its spec's placements under the
    current rules; a no-op without rules or a mesh.  A plain tensor
    under a mesh raises, naming the axes."""
    rules = current_rules()
    if not _has_mesh(rules):
        return x
    if not isinstance(x, DTensor):
        raise ValueError(
            f"constrain{tuple(logical_axes)}: a plain tensor of shape "
            f"{tuple(x.shape)} under a mesh (its placements were lost)")
    target = logical_sharding(x.shape, logical_axes, rules)
    if tuple(x.placements) == target:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pin.apply(x, target)
    return x.redistribute(rules.mesh, target)


class _Pin(torch.autograd.Function):
    """``redistribute`` whose gradient goes back replicated where the
    input was a partial sum (the all-reduce's backward is the identity,
    as in tensor-parallel layers), not as DTensor's partial gradient,
    which would make the next weight gradient gather its activations."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.src = tuple(Replicate() if p.is_partial() else p
                        for p in x.placements)
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.src), None


def unshard(x: torch.Tensor) -> torch.Tensor:
    """A weight gathered over the batch's mesh axes before use (FSDP:
    "embed" on "data" shards a weight's in-dim over the data axis): its
    shards on those axes become replicas, and its gradient is
    reduce-scattered back.  Its tensor-parallel ("model") shards stay.
    A no-op without rules, on a plain tensor or without such shards."""
    rules = current_rules()
    if not _has_mesh(rules) or not isinstance(x, DTensor):
        return x
    batch = rules.rules.get("batch")
    names = {batch} if isinstance(batch, str) else set(batch or ())
    dims = [i for i, n in enumerate(x.device_mesh.mesh_dim_names)
            if n in names]
    if not any(isinstance(x.placements[i], Shard) for i in dims):
        return x
    target = [Replicate() if i in dims else p
              for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, target)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``; on a DTensor, a reshape whose backward
    first gives the gradient the output's placements, so the reverse
    view is the forward's (a gradient sharded over merged heads that
    do not divide the mesh axis cannot be split back by DTensor)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


class _Reshape(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = x.shape
        out = x.reshape(*shape)
        ctx.out_place = out.placements
        return out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.out_place):
            g = g.redistribute(g.device_mesh, ctx.out_place)
        return g.reshape(ctx.in_shape), None


def _map(fn, tree, other):
    """``fn(leaf, o)`` over a nested dict / list tree and the entry of a
    parallel tree (``other``) at each leaf's place: its axes (a tuple of
    logical names, or None) or its placements."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def tree_shardings(params: Any, axes_tree: Any,
                   rules: ShardingRules) -> Any:
    """A tree of placements for a param tree and its parallel
    logical-axes tree (None leaves without a mesh)."""
    def one(leaf, axes):
        if rules.mesh is None:
            return None
        if axes is None:
            return (Replicate(),) * rules.mesh.ndim
        return logical_sharding(leaf.shape, axes, rules)

    return _map(one, params, axes_tree)


def constrain_tree(tree: Any, axes_tree: Any) -> Any:
    """``constrain`` leaf-wise (axes_tree: tuples of logical names): the
    gradient accumulator of a train step, pinned to the params'
    placements."""
    if not _has_mesh(current_rules()):
        return tree

    def one(leaf, axes):
        if axes is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return constrain(leaf, *axes)

    return _map(one, tree, axes_tree)


def local_offset(shape: Sequence[int], mesh: DeviceMesh,
                 place: Sequence) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed ``place`` on ``mesh``."""
    return compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                 tuple(place))


def shard(x: torch.Tensor, place: Sequence, mesh: DeviceMesh) -> DTensor:
    """A DTensor of global value ``x`` (the same on every rank) placed
    ``place`` on ``mesh``, made from this rank's shard of ``x`` with no
    communication: a view of ``x`` (no copy; at world size 1 the whole
    of it), or a fresh meta tensor of the shard's shape when ``x`` is on
    the meta device (a view would keep the global storage)."""
    shape, off = local_offset(x.shape, mesh, place)
    if x.is_meta:
        local = torch.empty(shape, dtype=x.dtype, device="meta")
    else:
        local = x
        for d, (o, n) in enumerate(zip(off, shape)):
            if n != x.shape[d]:
                local = local.narrow(d, o, n)
    return DTensor.from_local(local, mesh, tuple(place), run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_tree(tree: Any, axes_tree: Any, rules: ShardingRules) -> Any:
    """Every leaf of ``tree`` as a DTensor placed by its logical axes
    under ``rules`` (:func:`shard`; no copy of an unsharded leaf)."""
    return _map(lambda x, p: shard(x, p, rules.mesh), tree,
                tree_shardings(tree, axes_tree, rules))


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
