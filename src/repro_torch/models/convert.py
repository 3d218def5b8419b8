"""Weight converter: the JAX package's parameter pytree → the port's.

Both packages keep the same nested layout (``embed``, ``blocks`` — one
dict per pattern position, leaves stacked over groups — ``final_norm``,
``lm_head``) and leaf names (attention ``wq``..``wo``, ``ffn`` — dense
``wg``, ``wi``, ``wo``, or an MoE FFN's ``router`` (d, E) and expert
stacks ``wg``, ``wi`` (E, d, F), ``wo`` (E, F, d); the mamba mixer's
``in_proj``, ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``D``,
``norm`` and ``out_proj``), so conversion is a tree map.  The caller passes the JAX
tree as numpy arrays (``jax.tree.map(np.asarray, params)``); the port
never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import param_shapes, resolve_device


def _leaf_shapes(tree: Any, path: str = "") -> Dict[str, Tuple[int, ...]]:
    """{leaf path: shape} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_leaf_shapes(v, f"{path}/{k}"))
    return out


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda") -> Any:
    """Convert a numpy param tree to torch tensors on ``device`` in
    ``cfg.dtype``.  Arrays go through float32, which holds every bf16
    value exactly.  The tree must have the leaf paths and shapes of the
    port's :func:`~repro_torch.models.transformer.init_params` for
    ``cfg`` (every pattern position's block, each with its own leaves);
    any other tree raises ``ValueError``."""
    dev = resolve_device(device)
    _check_tree(tree, cfg)
    return _convert(tree, dev, cfg.torch_dtype)


def _check_tree(tree: Any, cfg: ModelConfig) -> None:
    want, got = _leaf_shapes(param_shapes(cfg)), _leaf_shapes(tree)
    if got != want:
        diff = sorted(k for k in want.keys() | got.keys()
                      if want.get(k) != got.get(k))
        raise ValueError(
            f"{cfg.name}: the tree's leaves differ from the port's "
            f"parameters at {diff[:6]} (want "
            f"{[want.get(k) for k in diff[:6]]}, got "
            f"{[got.get(k) for k in diff[:6]]})")


def _convert(x: Any, dev: torch.device, dtype: torch.dtype) -> Any:
    if isinstance(x, dict):
        return {k: _convert(v, dev, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_convert(v, dev, dtype) for v in x]
    arr = np.array(x, dtype=np.float32)   # a writable copy
    return torch.from_numpy(arr).to(device=dev, dtype=dtype)


def opt_state_from_numpy(state: Any, cfg: ModelConfig,
                         device="cuda") -> Dict[str, Any]:
    """Convert the JAX package's AdamW state (``adamw_init`` /
    ``adamw_update``: fp32 ``m``, ``v`` and ``master`` trees shaped like
    the params, int ``count``), given as numpy arrays, to the port's:
    fp32 trees on ``device`` and a 0-d int32 ``count``.  Each tree must
    have the port's parameter leaves for ``cfg``, else ``ValueError``."""
    dev = resolve_device(device)
    out = {}
    for name in ("m", "v", "master"):
        _check_tree(state[name], cfg)
        out[name] = _convert(state[name], dev, torch.float32)
    out["count"] = torch.tensor(int(np.asarray(state["count"])),
                                dtype=torch.int32, device=dev)
    return out
