"""The one traffic generator: turns a mix file of ``laps_bench/traffic/``
and a cell's load into the sessions a run serves.

A mix file holds parameters only (lengths, sharing, arrivals).  The
sessions' shapes (turns, lengths, think times) and the inter-arrival gaps
are drawn once from the mix's ``plan_seed``, so every seed serves the
same schedule; the run's seed draws every token id (and the weights).
Drawn in another order per seed, the same work moved TTFT mean by 16%
between seeds against 1-4% between two runs of one seed (qwen2.5-32b,
PERF.md), so the order is fixed too.

Sessions are multi-turn conversations.  A turn's prompt is the whole
conversation so far (earlier prompts, earlier replies in full) plus its
own new tokens, resubmitted under a fresh engine session, so the radix
index serves the history.  Open-loop mixes place each session's first
turn on the arrival schedule and every later turn ``think`` seconds
after the previous reply's last token; closed-loop mixes give each
client a list of sessions and send its next turn as soon as its
previous reply ends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TurnShape:
    new_tokens: int          # tokens this turn adds to the conversation
    out_tokens: int          # tokens it decodes (first token included)
    think_s: float           # pause after its reply before the next turn


@dataclasses.dataclass(frozen=True)
class SessionShape:
    turns: tuple             # of TurnShape
    system: int = 0          # shared system-prompt tokens before turn 1


@dataclasses.dataclass
class Plan:
    """What a run serves: sessions in the order they are used, and for an
    open loop their arrival offsets in seconds (None for a closed loop,
    whose ``clients`` lists index into ``sessions``)."""
    sessions: List[SessionShape]
    arrivals: Optional[List[float]]
    clients: Optional[List[List[int]]]


def _draw_len(rng: np.random.Generator, spec: Sequence) -> int:
    """A length from ``[lo, hi]`` (uniform) or ``[lo, hi, "loguniform"]``."""
    lo, hi = int(spec[0]), int(spec[1])
    if len(spec) > 2 and spec[2] == "loguniform":
        return int(round(math.exp(rng.uniform(math.log(lo), math.log(hi)))))
    return int(rng.integers(lo, hi + 1))


def _think(rng: np.random.Generator, spec) -> float:
    if not spec:
        return 0.0
    if spec["kind"] == "exp":
        return float(rng.exponential(spec["mean"]))
    raise ValueError(f"think time kind {spec['kind']!r}")


def draw_session(rng: np.random.Generator, mix: Dict,
                 max_len: int) -> SessionShape:
    """One session from the mix: 2–5 turns (``turns``), each long with
    probability ``long_share`` (``long`` lengths) and short otherwise
    (``first_short`` for turn 1 when given, ``short`` after), decoding
    ``decode`` tokens.  A long draw that would not fit ``max_len`` with
    the conversation so far becomes short; a turn that does not fit
    either ends the session."""
    n_turns = int(rng.integers(mix["turns"][0], mix["turns"][1] + 1))
    system = int(mix.get("system_prompt", 0))
    used = system
    turns = []
    for i in range(n_turns):
        long = rng.random() < mix.get("long_share", 0.0)
        short_spec = mix.get("first_short", mix["short"]) if i == 0 \
            else mix["short"]
        n_long = _draw_len(rng, mix["long"]) if "long" in mix else 0
        n_short = _draw_len(rng, short_spec)
        out = _draw_len(rng, mix["decode"])
        think = _think(rng, mix.get("think_s"))
        new = n_long if long else n_short
        if used + new + out > max_len:
            new = n_short
        if used + new + out > max_len:
            break
        turns.append(TurnShape(new, out, think))
        used += new + out
    return SessionShape(tuple(turns), system)


def _gaps(rng: np.random.Generator, kind: Dict, n: int) -> np.ndarray:
    """n inter-arrival gaps of mean 1: exponential (Poisson arrivals) or
    gamma with coefficient of variation ``cv`` (bursts)."""
    if kind["kind"] == "poisson":
        return rng.exponential(1.0, n)
    if kind["kind"] == "gamma":
        shape = 1.0 / kind["cv"] ** 2
        return rng.gamma(shape, 1.0 / shape, n)
    raise ValueError(f"arrival kind {kind['kind']!r}")


def plan(mix: Dict, load: Dict, seconds: float, max_len: int) -> Plan:
    """The run's sessions, from the mix's ``plan_seed`` alone.  ``load``
    is the cell's: ``rate`` (sessions a second, open loop) or ``clients``
    (closed loop)."""
    base = np.random.default_rng(int(mix["plan_seed"]))
    arrival = mix["arrival"]
    if arrival["kind"] == "closed":
        clients = int(load["clients"])
        per = max(1, int(math.ceil(seconds * mix["sessions_per_client_s"])))
        shapes = [draw_session(base, mix, max_len)
                  for _ in range(clients * per)]
        return Plan(shapes, None, [list(range(c * per, (c + 1) * per))
                                   for c in range(clients)])
    n = max(1, int(round(load["rate"] * seconds)))
    shapes = [draw_session(base, mix, max_len) for _ in range(n)]
    gaps = _gaps(base, arrival, n)
    # the first session arrives at 0 and the n-th before ``seconds``:
    # the gaps are scaled so that the run's mean rate is the cell's
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    t = t * (seconds * (n - 1) / n) / max(t[-1], 1e-12) if n > 1 else t
    return Plan(shapes, [float(x) for x in t], None)


class Tokens:
    """Token ids of a run, drawn from the seed: a shared system prompt
    and each (session, turn)'s new tokens, from generators keyed by
    their indices, so the ids do not depend on the order turns are
    served in.  Ids lie in [1, vocab)."""

    def __init__(self, seed: int, vocab: int, system: int):
        self.seed = int(seed) % 2**63
        self.vocab = int(vocab)
        self.system = self._draw((0,), system)

    def _draw(self, key: tuple, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 2, *key])
        return rng.integers(1, self.vocab, n, dtype=np.int64)

    def turn(self, session: int, turn: int, n: int) -> np.ndarray:
        return self._draw((1, session, turn), n)
