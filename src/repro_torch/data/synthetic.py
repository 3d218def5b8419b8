"""Synthetic LM data pipeline: deterministic, seekable, checkpointable.

Sequences mix (a) Zipfian unigram noise with (b) learnable structure —
fixed-length copy/repeat motifs — so a ~100M model's loss visibly drops
within a few hundred steps (the end-to-end example's success criterion).
The iterator state is a single integer (step), making data-restart after
failure exact.

Also home to the MULTI-TURN serving trace generator (DESIGN.md §8):
seeded chat sessions drawing from a shared system-prompt pool, each turn
resubmitting the full conversation plus a fresh suffix, with
heavy-tailed (Zipf) turn counts — the workload whose TTFT the paged
arena's radix prefix reuse collapses to the new-suffix cost.  The bench
(benchmarks/bench_mix.py multiturn) and the cluster simulator consume
the SAME trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    batch: int             # per-step global batch
    accum: int = 1         # microbatch accumulation factor
    motif_len: int = 8
    motif_prob: float = 0.5
    zipf_a: float = 1.3
    seed: int = 0


class SyntheticLM:
    def __init__(self, cfg: SyntheticConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def state(self) -> Dict:
        return {"step": self.step}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])

    def _sample(self, rng: np.random.Generator,
                n: int) -> Tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        v = c.vocab_size
        toks = rng.zipf(c.zipf_a, size=(n, c.seq_len + 1)) % (v - 1) + 1
        # inject copy motifs: x[t] = x[t - motif_len] within motif spans
        total = c.seq_len + 1
        for i in range(n):
            if rng.random() < c.motif_prob:
                start = int(rng.integers(0, total // 2))
                span = int(rng.integers(c.motif_len,
                                        max(total - start - c.motif_len, c.motif_len + 1)))
                src = toks[i, start:start + c.motif_len]
                for j in range(span):
                    pos = start + c.motif_len + j
                    if pos >= total:
                        break
                    toks[i, pos] = src[j % c.motif_len]
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int64)

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(c.seed * 1_000_003 + self.step)
        n = c.batch * c.accum
        x, y = self._sample(rng, n)
        self.step += 1
        return {
            "tokens": x.reshape(c.accum, c.batch, c.seq_len),
            "labels": y.reshape(c.accum, c.batch, c.seq_len).astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


# --------------------------------------------------------- multi-turn trace

@dataclasses.dataclass(frozen=True)
class MultiTurnConfig:
    """Stateless-API chat trace: every turn submits the FULL conversation
    (system prompt + all prior turns + the new suffix) under a fresh
    request, exactly how OpenAI-style serving frontends drive an engine —
    the shape prefix caching exists for."""
    vocab_size: int
    num_sessions: int = 8
    num_system_prompts: int = 2   # shared pool → cross-session reuse
    system_len: int = 48          # tokens per system prompt
    suffix_lo: int = 8            # fresh tokens per turn (user + reply)
    suffix_hi: int = 32
    max_turns: int = 6
    zipf_a: float = 1.7           # heavy-tailed turn counts: most
    #                               sessions are short, a few run long
    turn_gap: float = 0.05        # s between a session's turns
    session_gap: float = 0.02     # s between session starts
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TurnSpec:
    """One submitted turn of a multi-turn session."""
    session: int
    turn: int                 # 0-based within the session
    tokens: np.ndarray        # (n,) int32 — the FULL conversation so far
    suffix: int               # fresh tokens this turn (the true new work)
    reusable_prefix: int      # len(tokens) − suffix (prior turns' pages)
    arrival: float


def gen_multiturn_sessions(cfg: MultiTurnConfig) -> List[TurnSpec]:
    """Generate the trace, ordered by arrival.

    Sessions share system prompts drawn from a fixed pool, so a FRESH
    session's first turn already has a reusable prefix whenever another
    session with the same prompt committed first; turn ≥ 2 of any
    session reuses everything but its new suffix.  ``reusable_prefix``
    is the exact oracle (ignoring eviction and page rounding — the
    consumer rounds down to page granularity)."""
    rng = np.random.default_rng(cfg.seed)
    prompts = [rng.integers(1, cfg.vocab_size,
                            cfg.system_len).astype(np.int32)
               for _ in range(cfg.num_system_prompts)]
    turns: List[TurnSpec] = []
    for s in range(cfg.num_sessions):
        conv = prompts[int(rng.integers(cfg.num_system_prompts))]
        prior = 0   # conversation tokens carried in from earlier turns
        n_turns = min(int(rng.zipf(cfg.zipf_a)), cfg.max_turns)
        start = s * cfg.session_gap
        for t in range(n_turns):
            suffix = int(rng.integers(cfg.suffix_lo, cfg.suffix_hi + 1))
            conv = np.concatenate(
                [conv, rng.integers(1, cfg.vocab_size,
                                    suffix).astype(np.int32)])
            # turn 0 still reuses the SHARED system prompt if another
            # session committed it first — the consumer's radix index
            # decides; ``reusable_prefix`` reports the within-session
            # floor every cache must reach
            turns.append(TurnSpec(session=s, turn=t, tokens=conv,
                                  suffix=suffix, reusable_prefix=prior,
                                  arrival=start + t * cfg.turn_gap))
            prior = len(conv)
    turns.sort(key=lambda u: (u.arrival, u.session))
    return turns


def multiturn_requests(cfg: MultiTurnConfig, decode_tokens: int = 0,
                       rid_base: Optional[int] = None) -> List:
    """The same trace as :func:`gen_multiturn_sessions` shaped for the
    JAX-free cluster simulator: each turn becomes a full-conversation
    ``core.request.Request`` carrying its ``reusable_prefix`` annotation
    (the sim's prefix-reuse admission converts matched pages from new
    tokens into history — sim/simulator.py)."""
    from repro_torch.core.request import Request
    out = []
    for u in gen_multiturn_sessions(cfg):
        out.append(Request(new_tokens=len(u.tokens),
                           arrival=u.arrival,
                           session=u.session * 10_000 + u.turn,
                           decode_tokens=decode_tokens,
                           reusable_prefix=u.reusable_prefix))
    return out
