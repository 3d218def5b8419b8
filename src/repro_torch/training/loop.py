"""Fault-tolerant training loop of the port, from
``repro.training.loop``: checkpoint every N steps, resume from the
latest complete checkpoint (params + optimizer + data-iterator state).

The reference draws its params from a JAX key; here the seed is an int
and ``transformer.init_params`` draws from a ``torch.Generator`` on the
loop's device.  The reference jits its step with buffer donation; the
port's step runs eagerly and updates the optimizer state in place
(``optim.adamw.adamw_update``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint,
                                         save_checkpoint)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    accum: int = 1
    remat: bool = True


class TrainLoop:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data: SyntheticLM, tcfg: TrainConfig,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data = data
        self.tcfg = tcfg
        self.log = log_fn
        self.device = tr.resolve_device(device)
        self.history: List[Dict] = []
        self._step = make_train_step(cfg, opt_cfg, accum=tcfg.accum,
                                     remat=tcfg.remat)

    # ------------------------------------------------------------- state
    def init_or_restore(self, seed: int):
        params = tr.init_params(self.cfg, seed=seed, device=self.device)
        opt_state = adamw_init(params)
        start = 0
        if self.tcfg.ckpt_dir:
            last = latest_step(self.tcfg.ckpt_dir)
            if last is not None:
                params, opt_state, meta = load_checkpoint(
                    self.tcfg.ckpt_dir, last, params, opt_state)
                self.data.restore(meta.get("data", {"step": last}))
                start = meta["step"]
                self.log(f"[restore] resumed from step {start}")
        return params, opt_state, start

    # --------------------------------------------------------------- run
    def run(self, seed: int = 0):
        params, opt_state, start = self.init_or_restore(seed)
        t0 = time.perf_counter()
        for step in range(start, self.tcfg.steps):
            batch = self.data.next_batch()
            params, opt_state, metrics = self._step(params, opt_state, batch)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                self.history.append({"step": step + 1, "loss": loss,
                                     "lr": float(metrics["lr"])})
                dt = time.perf_counter() - t0
                self.log(f"[train] step {step + 1} loss {loss:.4f} "
                         f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                save_checkpoint(self.tcfg.ckpt_dir, step + 1, params,
                                opt_state, {"data": self.data.state()})
        if self.tcfg.ckpt_dir:
            save_checkpoint(self.tcfg.ckpt_dir, self.tcfg.steps, params,
                            opt_state, {"data": self.data.state()})
        return params, opt_state
