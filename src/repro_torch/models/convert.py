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

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _check_slice, resolve_device


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda") -> Any:
    """Convert a numpy param tree to torch tensors on ``device`` in
    ``cfg.dtype``.  Arrays go through float32, which holds every bf16
    value exactly."""
    _check_slice(cfg)
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        arr = np.array(x, dtype=np.float32)   # a writable copy
        return torch.from_numpy(arr).to(device=dev, dtype=cfg.torch_dtype)

    return conv(tree)
