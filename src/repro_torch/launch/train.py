"""Training launcher of the port: the fault-tolerant loop with
checkpoint/restart (``repro_torch.training.TrainLoop``) on synthetic
data, from ``repro.launch.train``.

Runs on the card unless ``--device cpu``.  The smoke config is used
unless ``--full`` asks for the published widths (random weights from
``--seed``; ``--layers`` cuts the depth, a multiple of the layer pattern
period).  On the card an attention smoke config's head_dim of 16 is
raised to 64, the narrowest width the attention kernels take, as the
serve launcher does.  The reference's ``--smoke`` flag is not copied:
it is ``store_true`` with ``default=True``, so it can never be turned
off and the reference's launcher never reaches a published config.

On the card every family trains through the hand-written kernels: the
attention layers through ``flash_attn`` and its backward kernels, the
SSD layers of the SSM and hybrid configs (mamba2, jamba) through
``ssd_scan``'s training form and the ``ssd_scan_bwd`` kernels.  On the
CPU they differentiate through the plain versions.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --full --layers 2 --steps 3 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --full --layers 2 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --device cpu --steps 20
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig
from repro_torch.training import TrainConfig, TrainLoop


def main(argv=None) -> TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of the smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    on_card = torch.device(args.device).type == "cuda"
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if on_card and not args.full:
        cfg = cfg.replace(head_dim=64)
    if args.layers is not None:
        period = tr.pattern_period(cfg)
        if args.layers <= 0 or args.layers % period:
            ap.error(f"--layers {args.layers}: {cfg.name} takes a positive "
                     f"multiple of its layer pattern period {period}")
        cfg = cfg.replace(num_layers=args.layers)
    data = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len, batch=args.batch,
        accum=args.accum, seed=args.seed))
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, accum=args.accum)
    loop = TrainLoop(cfg, ocfg, data, tcfg, device=args.device)
    loop.run(args.seed)
    final = (f"final loss {loop.history[-1]['loss']:.4f}" if loop.history
             else "nothing left to run")
    print(f"[train] done: {len(loop.history)} logged points, {final}")
    return loop


if __name__ == "__main__":
    main()
