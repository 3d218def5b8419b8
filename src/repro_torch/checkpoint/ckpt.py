"""Checkpoint/restart, from ``repro.checkpoint.ckpt``.

Trees are flattened to path-keyed npz archives plus a JSON metadata
sidecar (step, data-iterator state).  Writes are atomic (a temporary
directory, then a rename), so a failure mid-write never corrupts the
latest checkpoint: a restart resumes from the newest complete step
directory.

The archive keys are the reference's: dict keys and list indices joined
by "/" (``blocks/0/mixer/wq``; an optimizer state's ``m/blocks/0/...``,
``count``), so a checkpoint moves between the two packages.  A float32
or integer leaf is stored as its numpy array.  numpy has no bfloat16,
so a bfloat16 leaf is stored as its raw 16-bit patterns in a 2-byte
void array (``|V2``), the bytes the reference's numpy writes for a
bfloat16 leaf; a ``|V2`` array loads back bit for bit into a bfloat16
tensor.  Tensors are copied to the host to be written and loaded onto
the example leaf's device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_V2 = np.dtype("V2")


def _items(tree: Any):
    if isinstance(tree, dict):
        return tree.items()
    return enumerate(tree)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if not isinstance(tree, (dict, list, tuple)):
        return {prefix: _to_numpy(tree)}
    flat = {}
    for k, v in _items(tree):
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(x) -> np.ndarray:
    t = torch.as_tensor(x).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == _V2:                  # raw bfloat16 bit patterns
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _unflatten(example: Any, flat: Dict[str, np.ndarray],
               prefix: str = "") -> Any:
    if isinstance(example, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else k)
                for k, v in example.items()}
    if isinstance(example, (list, tuple)):
        return [_unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(example)]
    return _from_numpy(flat[prefix], example)


def save_checkpoint(ckpt_dir: str, step: int, params: Any,
                    opt_state: Optional[Any] = None,
                    meta: Optional[Dict] = None) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(tmp, "opt.npz"), **_flatten(opt_state))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int, params_example: Any,
                    opt_example: Optional[Any] = None
                    ) -> Tuple[Any, Optional[Any], Dict]:
    """(params, opt_state or None, meta) of ``step``, each leaf in the
    dtype and on the device of the example's leaf."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(d, "params.npz")) as z:
        params = _unflatten(params_example, dict(z))
    opt_state = None
    if opt_example is not None and os.path.exists(os.path.join(d, "opt.npz")):
        with np.load(os.path.join(d, "opt.npz")) as z:
            opt_state = _unflatten(opt_example, dict(z))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta
