"""Draft proposers for speculative decoding, from
``repro.serving.draft`` (the same classes, line for line).

A draft proposes up to ``k`` continuation tokens per decode session;
the target model verifies every session's ``[last_token, d_1..d_k]``
segment as ONE packed mixed dispatch through the unchanged arena
kernels and commits the accepted prefix (engine.spec_step).  Drafts are
free to be wrong — a rejected tail costs one arena truncate — and free
to be short: fewer than ``k`` proposals just means fewer rows to
verify.

Protocol (duck-typed, see :class:`DraftProposer`):

* ``propose(session, last_token, k)`` → up to ``k`` token ids expected
  AFTER ``last_token``.  ``last_token`` is the pending input of the
  next tick (its KV is not cached yet — the decode convention).
* ``observe(session, tokens, prompt=False)`` — tokens whose KV the
  target engine just cached (the prompt at prefill time, then each
  step's consumed inputs: the previous pending token plus the accepted
  drafts).  The engine calls this from ``spec_step``; the serve loop
  feeds prompts.
* ``forget(session)`` — session closed / slot reused.

Three implementations:

* :class:`NGramDraft` — self-speculation: proposes the continuation
  that followed the most recent earlier occurrence of the current
  suffix n-gram.  Zero model cost, deterministic, great on repetitive
  streams (and the lossless property makes it free to be wrong).
* :class:`ScriptedDraft` — test/bench oracle: proposes a known token
  stream with seeded per-POSITION corruption at rate ``1 − accept``,
  so benches dial an exact acceptance rate α deterministically.
* :class:`SmallModelDraft` — a small target-architecture model run
  greedily through its OWN Engine (sharing all the executor/arena
  machinery), kept in sync via ``observe`` and rolled back with the
  same ``truncate`` primitive the big engine uses.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class DraftProposer:
    """Interface base (and the null draft: proposes nothing)."""

    def propose(self, session: int, last_token: int, k: int) -> List[int]:
        return []

    def observe(self, session: int, tokens: Sequence[int],
                prompt: bool = False) -> None:
        pass

    def forget(self, session: int) -> None:
        pass


class NGramDraft(DraftProposer):
    """Suffix n-gram self-draft over the session's own token history.

    To propose after ``last_token``: find the most recent EARLIER
    occurrence of the longest matching suffix (length ≤ n, ≥ 1 token)
    of ``history + [last_token]`` and return the tokens that followed
    it.  Keeps its own per-session history — the slot arena stores KV,
    not token ids.
    """

    def __init__(self, n: int = 3, min_match: int = 1):
        assert n >= 1 and 1 <= min_match <= n
        self.n = n
        self.min_match = min_match
        self._hist: Dict[int, List[int]] = {}

    def observe(self, session: int, tokens: Sequence[int],
                prompt: bool = False) -> None:
        self._hist.setdefault(session, []).extend(int(t) for t in tokens)

    def forget(self, session: int) -> None:
        self._hist.pop(session, None)

    def propose(self, session: int, last_token: int, k: int) -> List[int]:
        h = self._hist.get(session, []) + [int(last_token)]
        for n in range(min(self.n, len(h) - 1), self.min_match - 1, -1):
            pat = h[-n:]
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == pat:
                    cont = h[i + n:i + n + k]
                    if cont:
                        return cont
                    break       # the only longer continuation is the suffix
        return []


class ScriptedDraft(DraftProposer):
    """Oracle draft for deterministic tests and benches.

    ``scripts[session]`` is the full expected generated stream INCLUDING
    the first (TTFT) token.  A per-session cursor counts stream tokens
    whose KV the engine has cached (observe of non-prompt tokens), so
    ``last_token == script[cursor]`` and proposals continue from
    ``cursor + 1``.  Each scripted POSITION is independently corrupted
    with probability ``1 − accept`` under a seed derived from
    (seed, session, position) — deterministic across re-proposals, so a
    run realizes acceptance rate α = ``accept`` exactly per position.
    """

    def __init__(self, scripts: Dict[int, Sequence[int]],
                 accept: float = 1.0, vocab: int = 32_000, seed: int = 0):
        self.scripts = {s: [int(t) for t in toks]
                        for s, toks in scripts.items()}
        self.accept = accept
        self.vocab = vocab
        self.seed = seed
        self._cursor: Dict[int, int] = {}

    def observe(self, session: int, tokens: Sequence[int],
                prompt: bool = False) -> None:
        if prompt:
            return              # the prompt is not part of the script
        self._cursor[session] = self._cursor.get(session, 0) + len(tokens)

    def forget(self, session: int) -> None:
        self._cursor.pop(session, None)

    def _corrupt(self, session: int, pos: int, tok: int) -> int:
        rng = np.random.default_rng((self.seed, session, pos))
        if rng.random() < self.accept:
            return tok
        return (tok + 1 + int(rng.integers(self.vocab - 1))) % self.vocab

    def propose(self, session: int, last_token: int, k: int) -> List[int]:
        script = self.scripts.get(session)
        if script is None:
            return []
        start = self._cursor.get(session, 0) + 1   # after the pending token
        out = []
        for j in range(start, min(start + k, len(script))):
            out.append(self._corrupt(session, j, script[j]))
        return out


class SmallModelDraft(DraftProposer):
    """A small model drafting through its own Engine.

    The draft engine mirrors each target session: prompts prefill,
    consumed inputs re-prefill as suffix extensions, and ``propose``
    decodes ``k`` tokens greedily — then immediately truncates its arena
    back, because only the accepted prefix (reported via ``observe``)
    may stay cached.  All the packed/arena machinery is reused
    as-is: the small-model draft shares the executor machinery.
    """

    def __init__(self, engine):
        self.engine = engine
        self._open: Dict[int, bool] = {}
        self._pending: Dict[int, List[int]] = {}   # observed, not yet cached

    def observe(self, session: int, tokens: Sequence[int],
                prompt: bool = False) -> None:
        self._open.setdefault(session, True)
        self._pending.setdefault(session, []).extend(int(t) for t in tokens)

    def forget(self, session: int) -> None:
        if self._open.pop(session, None):
            self.engine.close_session(session)
        self._pending.pop(session, None)

    def _sync(self, session: int) -> None:
        toks = self._pending.get(session)
        if toks:
            self.engine.prefill_packed([session], [np.asarray(toks)])
            self._pending[session] = []

    def propose(self, session: int, last_token: int, k: int) -> List[int]:
        self._sync(session)
        h = self.engine.history(session)
        if h + k + 1 > self.engine.ecfg.max_len - 2:
            return []
        out = self.engine.decode_batch([session], [int(last_token)], steps=k)
        # roll the draft's own arena back: only tokens the TARGET accepts
        # (reported via observe) may stay cached
        self.engine.arena.truncate(session, h)
        return [int(t) for t in out.get(session, [])]


__all__ = ["DraftProposer", "NGramDraft", "ScriptedDraft", "SmallModelDraft"]
