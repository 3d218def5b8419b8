"""Plain reference of the dense Qwen decoder (Qwen2 with q/k/v biases,
Qwen3 with per-head q/k RMSNorm), and the seeded weights both it and the
program read.

The weights are made here, on the device, from the run's seed, in the
dtype they are served in, one ``normal_`` call per stacked leaf, in the
tree the program takes (``blocks`` a one-entry list of leaves stacked
over the layers).  The reference reads those same tensors, upcast one
layer at a time; it imports nothing of the program and uses nothing the
program derived from them.

The forward follows the published block: pre-norm RMSNorm, attention
with rotary embedding on the two halves of each head (rope_theta), GQA
with contiguous groups of query heads per key/value head, softmax over
causal keys scaled by head_dim^-0.5, SwiGLU FFN, final RMSNorm and the
output head (the embedding's transpose where tied).  It runs in float32
with TF32 off, or with ``precision="fp8"`` as the control: every matrix
product's operands rounded to float8 e4m3 (weights per output channel,
activations per token), and keys and values per token and head, the
products then taken in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3fn value


def _vocab_padded(cfg: Dict) -> int:
    pad = int(cfg.get("vocab_pad_to", 256))
    v = int(cfg["vocab_size"])
    return (v + pad - 1) // pad * pad


def arch(cfg: Dict) -> Dict:
    """The block's switches from a Hugging Face style config."""
    mt = cfg["model_type"]
    if mt not in ("qwen2", "qwen3"):
        raise ValueError(f"qwen_dense serves qwen2 / qwen3, not {mt!r}")
    d, hq = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {
        "layers": int(cfg["num_hidden_layers"]), "d": d, "hq": hq,
        "hkv": int(cfg["num_key_value_heads"]),
        "hd": int(cfg.get("head_dim") or d // hq),
        "ff": int(cfg["intermediate_size"]),
        "vocab": int(cfg["vocab_size"]), "vocab_padded": _vocab_padded(cfg),
        "eps": float(cfg["rms_norm_eps"]), "theta": float(cfg["rope_theta"]),
        # Qwen2 always carries q/k/v biases; Qwen3 says so in its config
        "qkv_bias": bool(cfg.get("attention_bias", mt == "qwen2")),
        "qk_norm": mt == "qwen3",
        "tied": bool(cfg.get("tie_word_embeddings", False)),
    }


def make_weights(cfg: Dict, init: Dict, seed: int, device) -> Dict:
    """Random weights from ``seed``, drawn on ``device`` in the config's
    ``torch_dtype`` by a ``torch.Generator`` there.  ``init`` gives the
    scales: matrices N(0, fan_in^-1/2), the embedding ``embed_std``,
    biases ``bias_std``, norm weights 1 + N(0, ``norm_std``)."""
    a = arch(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    dt = getattr(torch, cfg.get("torch_dtype", "bfloat16"))
    n, d, hd = a["layers"], a["d"], a["hd"]
    qd, kvd, ff, vp = a["hq"] * hd, a["hkv"] * hd, a["ff"], a["vocab_padded"]

    def normal(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dt, device=dev)
        return t.normal_(mean, std, generator=gen)

    mixer = {"wq": normal((n, d, qd), d ** -0.5),
             "wk": normal((n, d, kvd), d ** -0.5),
             "wv": normal((n, d, kvd), d ** -0.5),
             "wo": normal((n, qd, d), qd ** -0.5)}
    if a["qkv_bias"]:
        mixer["bq"] = normal((n, qd), init["bias_std"])
        mixer["bk"] = normal((n, kvd), init["bias_std"])
        mixer["bv"] = normal((n, kvd), init["bias_std"])
    if a["qk_norm"]:
        mixer["q_norm"] = normal((n, hd), init["norm_std"], 1.0)
        mixer["k_norm"] = normal((n, hd), init["norm_std"], 1.0)
    block = {"ln1": normal((n, d), init["norm_std"], 1.0), "mixer": mixer,
             "ln2": normal((n, d), init["norm_std"], 1.0),
             "ffn": {"wg": normal((n, d, ff), d ** -0.5),
                     "wi": normal((n, d, ff), d ** -0.5),
                     "wo": normal((n, ff, d), ff ** -0.5)}}
    embed = normal((vp, d), init["embed_std"])
    head = embed.t() if a["tied"] else normal((d, vp), d ** -0.5)
    return {"embed": embed, "blocks": [block],
            "final_norm": normal((d,), init["norm_std"], 1.0),
            "lm_head": head}


# ------------------------------------------------------------- forward


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x (T, H, D); cos / sin (T, 1, D/2): rotate the two halves."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax / 448), returned dequantized in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Mat:
    """Matrix products of one precision: float32, or the fp8 control's
    rounded operands (weights per output column, activations per row)."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.fp8 else x

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.fp8 else x


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_block: int) -> torch.Tensor:
    """Causal attention of q (T, Hq, D) over k, v (T, Hkv, D), query
    blocks at a time: query head h reads key/value head h // (Hq/Hkv)."""
    t, hq, hd = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    scale = hd ** -0.5
    kt = k.permute(1, 2, 0)                       # (Hkv, D, T)
    vh = v.permute(1, 0, 2)                       # (Hkv, T, D)
    out = torch.empty_like(q)
    for s in range(0, t, q_block):
        e = min(t, s + q_block)
        qb = q[s:e].reshape(e - s, hkv, rep, hd).permute(1, 2, 0, 3)
        qb = qb.reshape(hkv, rep * (e - s), hd)   # (Hkv, rep·Q, D)
        sc = torch.bmm(qb, kt[:, :, :e]) * scale  # (Hkv, rep·Q, e)
        sc = sc.view(hkv, rep, e - s, e)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        sc.masked_fill_(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1).view(hkv, rep * (e - s), e)
        o = torch.bmm(p, vh[:, :e])               # (Hkv, rep·Q, D)
        out[s:e] = o.view(hkv, rep, e - s, hd).permute(2, 0, 1, 3).reshape(
            e - s, hq, hd)
    return out


@torch.no_grad()
def logits_at(weights: Dict, cfg: Dict, tokens: torch.Tensor,
              positions: torch.Tensor, precision: str = "fp32",
              q_block: int = 512, row_block: int = 4096) -> torch.Tensor:
    """Float32 logits (len(positions), vocab) of the causal forward over
    ``tokens`` (T,) at ``positions`` (the rows whose next token is
    judged).  Layers run one at a time on their upcast weights; the FFN
    in blocks of ``row_block`` rows."""
    a = arch(cfg)
    mm = _Mat(precision)
    dev = tokens.device
    t = tokens.shape[0]
    hq, hkv, hd, eps = a["hq"], a["hkv"], a["hd"], a["eps"]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd
    freqs = 1.0 / (a["theta"] ** exps)
    ang = torch.arange(t, dtype=torch.float32, device=dev)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x = weights["embed"][tokens].float()
    blk = weights["blocks"][0]
    for i in range(a["layers"]):
        mx = blk["mixer"]
        h = _rms(x, blk["ln1"][i].float(), eps)
        ha = mm.act(h)
        q = ha @ mm.weight(mx["wq"][i])
        k = ha @ mm.weight(mx["wk"][i])
        v = ha @ mm.weight(mx["wv"][i])
        del ha
        if a["qkv_bias"]:
            q = q + mx["bq"][i].float()
            k = k + mx["bk"][i].float()
            v = v + mx["bv"][i].float()
        q, k, v = q.view(t, hq, hd), k.view(t, hkv, hd), v.view(t, hkv, hd)
        if a["qk_norm"]:
            q = _rms(q, mx["q_norm"][i].float(), eps)
            k = _rms(k, mx["k_norm"][i].float(), eps)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        o = _attention(q, mm.kv(k), mm.kv(v), q_block)
        del q, k, v
        x = x + mm.act(o.reshape(t, hq * hd)) @ mm.weight(mx["wo"][i])
        del o
        fw = blk["ffn"]
        wg, wi, wo = (mm.weight(fw[n][i]) for n in ("wg", "wi", "wo"))
        for s in range(0, t, row_block):
            e = min(t, s + row_block)
            h = mm.act(_rms(x[s:e], blk["ln2"][i].float(), eps))
            g = F.silu(h @ wg) * (h @ wi)
            x[s:e] += mm.act(g) @ wo
        del wg, wi, wo
    xf = _rms(x[positions], weights["final_norm"].float(), eps)
    logits = mm.act(xf) @ mm.weight(weights["lm_head"])
    return logits[:, :a["vocab"]]


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each judged token's reference logit lies below the
    reference's best at its row (0 where it is the best)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tokens[:, None].long())[:, 0]


def fp32_mode():
    """Context: float32 products in float32 (no TF32), restored after."""
    return _NoTF32()


class _NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def judge(weights: Dict, cfg: Dict, sequences: List[Dict], device,
          precision: Optional[str] = None) -> Dict:
    """Run the reference over each sequence and return the served tokens'
    gaps (a float32 tensor on the CPU), and with ``precision`` set the
    gaps of the tokens that precision's forward puts first.
    Each sequence: {"tokens": (T,) ids, "positions": rows judged,
    "served": the token served after each judged row}."""
    out = {"gaps": [], "control": []}
    with fp32_mode():
        for seq in sequences:
            toks = torch.as_tensor(seq["tokens"], device=device)
            pos = torch.as_tensor(seq["positions"], device=device)
            served = torch.as_tensor(seq["served"], device=device)
            ref = logits_at(weights, cfg, toks, pos)
            out["gaps"].append(gaps(ref, served).cpu())
            if precision is not None:
                low = logits_at(weights, cfg, toks, pos, precision)
                out["control"].append(gaps(ref, low.argmax(-1)).cpu())
                del low
            del ref
    return {k: (torch.cat(v) if v else torch.zeros(0)) for k, v in out.items()}


def reference_config_check(cfg: Dict) -> None:
    """Refuse a config this reference does not describe."""
    arch(cfg)
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("qwen_dense computes SwiGLU (silu) FFNs")
    if cfg.get("use_sliding_window"):
        raise ValueError("qwen_dense computes full causal attention")
    if cfg.get("rope_scaling"):
        raise ValueError("qwen_dense computes unscaled rotary embedding")
    if not math.isfinite(float(cfg["rope_theta"])):
        raise ValueError("rope_theta")
