"""Serving launcher of the port: the real PyTorch engine + LAPS scheduler
under synthetic multi-turn traffic (CLI wrapper over
``repro_torch.serving.loop.ServeLoop``), from ``repro.launch.serve``.

Runs on the card, with the reference launcher's flags and defaults:
the plain run serves the slot/dense baseline (``packed=False,
paged_kv=False``: the dense (L, B) grid for prefill, one step graph
per shape captured at init, and arena-resident bucketed decode, its
rungs captured at init too); ``--packed`` serves the
default engine stack (packed token-bucket stream over the paged pool).
The smoke config is used unless ``--full`` asks for the published width
(random weights from ``--seed``; ``--layers`` cuts the depth).  On the
card an attention smoke config's head_dim of 16 is raised to 64, the
narrowest of the widths the attention kernels take (64, 80, 96, 128);
the SSD scan kernel takes the SSM smoke config's own head widths.
``--arch`` names any registered config: qwen3-4b (the default),
qwen2.5-32b, qwen2.5-14b and minitron-8b (GQA at head_dim 128),
stablelm-1.6b and phi-3-vision-4.2b (MHA at head_dim 64 and 96; phi-3's
vision frontend is a stub and its backbone serves tokens).
``--arch mamba2-2.7b`` serves the SSM family
(a scratch slot on the slot arena, state pages on the paged pool);
``--arch mixtral-8x7b`` the windowed MoE family (window-masked full
slots in the default run, ring page tables with ``--packed``), whose
long prompts run past the sliding window so every session's cache
wraps; ``--arch qwen3-moe-30b-a3b`` 128 experts top 8 through the
capacity dispatch; ``--arch jamba-v0.1-52b`` the hybrid family
(attention, SSD and MoE layers interleaved: KV and recurrent state side
by side in each session's slot or pages).  ``--layers`` must be a
multiple of the config's layer pattern period (jamba: 8; its smoke
config: 4); any other value is refused.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --full --layers 4 --sessions 8 --turns 3 --variant pla_full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --packed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --full --layers 16 --packed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --full --packed
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi-3-vision-4.2b --full
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-v0.1-52b --full --layers 16 --packed
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import H200_QWEN32B, Variant, make_policy
from repro_torch.core.awd import AWDConfig
from repro_torch.models import transformer as tr
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.loop import ServeLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of the smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--variant", default="pla_full",
                    choices=[v.value for v in Variant])
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--slo", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--packed", action="store_true",
                    help="packed token-bucket stream over the paged pool")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full:
        cfg = get_config(args.arch)
    else:
        cfg = get_smoke(args.arch)
        if torch.device(args.device).type == "cuda" \
                and cfg.family != "ssm":
            cfg = cfg.replace(head_dim=64)
    if args.layers is not None:
        period = tr.pattern_period(cfg)
        if args.layers <= 0 or args.layers % period:
            ap.error(f"--layers {args.layers}: {cfg.name} takes a positive "
                     f"multiple of its layer pattern period {period}")
        cfg = cfg.replace(num_layers=args.layers)
    params = tr.init_params(cfg, seed=args.seed, device=args.device)
    # a long prefill runs past the sliding window of a windowed config
    long_lo = 48 + (cfg.sliding_window or 0)
    # each turn adds a prompt shorter than a long one, its first token
    # and the decoded ones to the session's cache
    max_len = args.turns * (long_lo + 48 + 1 + args.decode_steps)
    # --packed rides the default stack (packed + paged pool); the plain
    # run keeps the explicit slot/dense baseline
    engine = Engine(cfg, params, EngineConfig(
        num_slots=max(8, args.sessions), max_len=max_len, chunk_tokens=32,
        packed=args.packed, paged_kv=args.packed), device=args.device)
    awd_cfg = None
    if engine.packed_executor is not None:
        awd_cfg = AWDConfig(packed=True,
                            token_buckets=engine.ecfg.token_buckets,
                            packed_max_seqs=engine.packed_executor.max_seqs)
    policy = make_policy(Variant(args.variant), H200_QWEN32B, threshold=48,
                         chunk_tokens=32, awd_cfg=awd_cfg)
    if engine.packed_executor is None:
        # capture the (L, B) grid at system init: one step graph a shape
        cap = engine.executor.precapture(
            params, engine.arena.gather, lengths=(8, 16, 32, 64),
            depths=(1, 2, 4))
        print(f"[serve] captured {len(engine.executor.graphs)} grid step "
              f"graphs in {cap:.1f}s at init")
    if engine.decode_executor is not None and not engine._paged:
        # and every decode-ladder rung, so no live decode tick is the
        # first of its shape (the paged engine's rungs meet theirs live)
        # (an SSM arena runs them on its scratch slot: a decode step
        # changes the state of the slot it reads)
        dcap = engine.decode_executor.precapture(
            params, engine.arena.arena, slot=engine.arena.scratch or 0)
        print(f"[serve] captured {len(engine.decode_executor.graphs)} "
              f"decode step graphs in {dcap:.1f}s at init")
    loop = ServeLoop(engine, policy, slo_ttft=args.slo)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for turn in range(args.turns):
        for s in range(args.sessions):
            if rng.random() < 0.2:
                n = int(rng.integers(long_lo, long_lo + 48))  # long prefill
            else:
                n = int(rng.integers(4, 32))      # short / re-prefill
            loop.submit(s, rng.integers(0, cfg.vocab_size, n))
        loop.run_until_idle(max_wall=120.0)
        for s in range(args.sessions):
            toks = loop.decode(s, args.decode_steps)
            if turn == args.turns - 1 and s == 0:
                print(f"[serve] session {s} decoded: {toks}")
    wall = time.perf_counter() - t0

    rep = loop.tracker.report(wall)
    print(f"[serve] arch={cfg.name} layers={cfg.num_layers} "
          f"variant={args.variant} requests={rep.n} wall={wall:.1f}s "
          f"device={engine.device}")
    print(f"[serve] mean TTFT {rep.mean_ttft * 1000:.1f} ms  "
          f"p90 {rep.p90_ttft * 1000:.1f} ms  viol {rep.violation_rate:.3f}  "
          f"graph-hit {rep.graph_hit_rate:.2f}")
    print(f"[serve] engine stats: {engine.stats()}")
    fit = engine.fit_boundary()
    if fit:
        print(f"[serve] fitted boundary L_m = {fit.boundary():.0f} tokens "
              f"(fixed {fit.fixed * 1000:.2f} ms, "
              f"beta {fit.beta_eff * 1e3:.3f} ms/tok)")


if __name__ == "__main__":
    main()
