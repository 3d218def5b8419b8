"""A model family for the CPU tests, kept outside ``models/``: any
architecture the port registers, at its smoke size
(``repro_torch.configs.get_smoke``), named by the configuration's
``"program"`` key.  ``test_bench_family.py`` copies it into a checkout's
``models/`` beside a configuration that names it, as a new family would
come: the harness needs no edit for it.

It counts what the ``ModelConfig``'s layer pattern holds: K and V in
the attention layers, and for each SSD layer a state slot on every page
(the program's pool keeps one there); routed experts at their top-k.
The SSD scan's own products are not counted.  It serves no benchmark
cell and has no plain reference."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

from laps_bench import arith


def program_config(config: Dict):
    """The registered smoke config of ``config["program"]``."""
    from repro_torch.configs import get_smoke
    return get_smoke(config["program"])


def _elem_bytes(cfg) -> int:
    return torch.empty(0, dtype=cfg.torch_dtype).element_size()


def page_bytes(config: Dict, page_size: int) -> int:
    """Device bytes of one pool page: K and V of each attention layer, and
    the SSM state (fp32) and conv window of each SSD layer."""
    cfg = program_config(config)
    el = _elem_bytes(cfg)
    kv = 2 * page_size * cfg.num_kv_heads * cfg.hdim * el
    ssm = cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state_size * 4
    conv = (cfg.ssm_conv_width - 1) * (
        cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state_size) * el
    return sum(kv if cfg.layer_kind(i) == "attn" else ssm + conv
               for i in range(cfg.num_layers))


def pool(config: Dict, free_bytes: float) -> Dict[str, int]:
    """One page pool, the SSD layers' state slots on its pages."""
    ps = int(config["serving"]["page_size"])
    return {"num_pages": int(free_bytes // page_bytes(config, ps))}


@dataclasses.dataclass(frozen=True)
class Yardstick:
    heads: int
    kv_heads: int
    head_dim: int
    elem_bytes: int
    attn_layers: int
    token_params: int       # weights one token multiplies in all layers
    d_model: int
    vocab: int

    def step_flops(self, segments: Iterable[Tuple[int, int]]) -> float:
        """2 per weight a token multiplies, causal attention in the
        attention layers, the output head once a segment."""
        flops = 0.0
        for q, h in segments:
            flops += 2.0 * self.token_params * q
            flops += 2.0 * self.d_model * self.vocab
            flops += self.attn_layers * arith.attn_flops(
                q, h, self.heads, self.head_dim)
        return flops


def yardstick(config: Dict) -> Yardstick:
    cfg = program_config(config)
    d, hd = cfg.d_model, cfg.hdim
    params = attn = 0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            attn += 1
            params += 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
        else:
            di, g, ds = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state_size
            params += d * (2 * di + 2 * g * ds + cfg.ssm_nheads) + di * d
        if cfg.layer_is_moe(i):
            ff = cfg.moe_d_ff or cfg.d_ff
            params += d * cfg.num_experts + \
                cfg.num_experts_per_tok * 3 * d * ff
        elif cfg.family != "ssm":         # mamba2's blocks have no FFN
            params += 3 * d * cfg.d_ff
    return Yardstick(heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
                     head_dim=hd, elem_bytes=_elem_bytes(cfg),
                     attn_layers=attn, token_params=params, d_model=d,
                     vocab=cfg.vocab_size)
