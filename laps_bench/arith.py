"""The yardstick's arithmetic: a dense decoder's model FLOPs per token
(the dense family's yardstick, ``models/dense.py``), the operations and
bytes each attention kernel's call needs, and the card's published peaks
(``peaks.json``).  Counts follow the inputs, as a kernel needs them:
causal keys only, every input byte read once, every output byte written
once.  Nothing here imports the program."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Shape:
    """The widths the arithmetic needs, read from a configuration file."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    elem_bytes: int = 2          # of the served dtype

    @classmethod
    def from_config(cls, cfg: Dict) -> "Shape":
        hq = int(cfg["num_attention_heads"])
        d = int(cfg["hidden_size"])
        return cls(layers=int(cfg["num_hidden_layers"]), d_model=d,
                   heads=hq, kv_heads=int(cfg["num_key_value_heads"]),
                   head_dim=int(cfg.get("head_dim") or d // hq),
                   d_ff=int(cfg["intermediate_size"]),
                   vocab=int(cfg["vocab_size"]),
                   elem_bytes=ELEM_BYTES[cfg.get("torch_dtype", "bfloat16")])

    @property
    def attn_layers(self) -> int:
        """Layers that launch the attention kernels: every one."""
        return self.layers

    def step_flops(self, segments: Iterable[Tuple[int, int]]) -> float:
        """Model FLOPs of one step (``step_flops``): what a family's
        yardstick gives ``ticks_mfu``."""
        return step_flops(self, segments)

    @property
    def block_matmul_params(self) -> int:
        """Weights one token multiplies in one layer: q, k, v, o and the
        three SwiGLU matrices."""
        d, qd = self.d_model, self.heads * self.head_dim
        kvd = self.kv_heads * self.head_dim
        return 2 * d * qd + 2 * d * kvd + 3 * d * self.d_ff


def attn_flops(q: int, history: int, heads: int, head_dim: int) -> float:
    """Q·Kᵀ and P·V of ``q`` new causal queries at ``history`` cached
    keys, one layer: query i sees history + i + 1 keys."""
    keys = q * history + q * (q + 1) // 2
    return 4.0 * heads * head_dim * keys


def prefill_call(shape: Shape, segments: Iterable[Tuple[int, int]]
                 ) -> Tuple[float, float]:
    """(operations, bytes) of one ``ragged_prefill_paged`` launch (one
    layer) over segments of (new tokens, history): Q read and O written
    per new token, K and V read once per key the segment attends to."""
    e, hd = shape.elem_bytes, shape.head_dim
    flops = nbytes = 0.0
    for q, h in segments:
        flops += attn_flops(q, h, shape.heads, hd)
        nbytes += 2 * q * shape.heads * hd * e            # Q in, O out
        nbytes += 2 * (h + q) * shape.kv_heads * hd * e   # K, V in
    return flops, nbytes


def decode_call(shape: Shape, lengths: Iterable[int]
                ) -> Tuple[float, float]:
    """(operations, bytes) of one ``decode_attn_paged`` launch (one layer)
    over rows that attend to ``lengths`` keys each."""
    e, hd = shape.elem_bytes, shape.head_dim
    flops = nbytes = 0.0
    for n in lengths:
        flops += 4.0 * shape.heads * hd * n
        nbytes += 2 * shape.heads * hd * e + 2 * n * shape.kv_heads * hd * e
    return flops, nbytes


def step_flops(shape: Shape, segments: Iterable[Tuple[int, int]]) -> float:
    """Model FLOPs of one step over segments of (new tokens, history):
    2 per weight per token through the layers, causal attention over each
    segment's keys, and the output head once per segment (one sampled
    row each).  A decode row is a segment of one token."""
    flops = 0.0
    per_tok = 2.0 * shape.layers * shape.block_matmul_params
    head = 2.0 * shape.d_model * shape.vocab
    for q, h in segments:
        flops += per_tok * q + head
        flops += shape.layers * attn_flops(q, h, shape.heads, shape.head_dim)
    return flops


def peaks(kind: str) -> Dict:
    """Published peaks of the card named ``kind`` (``peaks.json``)."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    if kind not in table["cards"]:
        raise KeyError(f"no published peaks for {kind!r} in peaks.json")
    return table["cards"][kind]


def least_seconds(flops: float, nbytes: float, peak: Dict) -> float:
    """The least time the card could take: the larger of operations over
    its bf16 rate and bytes over its memory bandwidth."""
    return max(flops / peak["bf16_flops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])


def ticks_mfu(rec, kinds: Sequence[str]) -> Optional[float]:
    """Model FLOPs of the window's untraced ticks of ``kinds`` ("prefill":
    ran a packed step, "decode": decode only), as the record's yardstick
    (``rec.shape``) counts them, over their wall seconds times the card's
    bf16 peak, in %."""
    if not rec.peak:
        return None
    flops = secs = 0.0
    for k in rec.ticks:
        if k.traced or k.kind not in kinds or \
                not rec.t_start <= k.t0 < rec.t_end:
            continue
        for segs in k.prefill:
            flops += rec.shape.step_flops(segs)
        for lens in k.decode:
            flops += rec.shape.step_flops([(1, n - 1) for n in lens])
        secs += k.t1 - k.t0
    if not secs:
        return None
    return 100.0 * flops / (secs * rec.peak["bf16_flops_per_s"])
