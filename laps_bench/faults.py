"""Faults planted underneath the timed path, to see that ``correct``
catches each fault a one-card serving cell can have (there is no
exchange between cards to leave out):

- ``token``: a token altered where it is produced: each step's first
  sampled token moves to its neighbour;
- ``state``: a step that leaves its state unchanged: every attention
  layer writes its new keys and values to the pool's scratch page, so
  the pages the sequences read never change;
- ``half``: half of the batch left out: the logits of a step's second
  half of live rows are the mean over its first half's.

Each is planted before set-up, so the step graphs captured there hold
it, and is written without reading a device value on the host, so it
can be captured.  ``plant(name, setattr)`` takes the setter that patches
(pytest's ``monkeypatch.setattr``, or the builtin ``setattr`` in a
process that ends after the run).  Never planted in the benchmark's own
runs: ``run.py --fault <name>``.
"""
from __future__ import annotations

from typing import Callable

import torch


def _fault_token(patch: Callable) -> None:
    from repro_torch.serving.engine import Engine
    inner = Engine._tokens_from_step

    def altered(self, sessions, logits, ids):
        toks, last = inner(self, sessions, logits, ids)
        toks = toks.copy()
        toks[0] = (toks[0] + 1) % self.cfg.vocab_size
        return toks, last

    patch(Engine, "_tokens_from_step", altered)


def _fault_state(patch: Callable) -> None:
    from repro_torch.models import transformer as tr
    for name, pages, offs in (
            ("packed_paged_attention_layer", "token_pages", "token_offs"),
            ("paged_decode_layer", "write_pages", "write_offs")):
        inner = getattr(tr, name)

        def unchanged(p, x, *, kv, _inner=inner, _pages=pages, _offs=offs,
                      **kw):
            # every new key and value goes to the pool's last page, the
            # scratch page that no sequence reads
            kw[_pages] = torch.full_like(kw[_pages], kv[0].shape[0] - 1)
            kw[_offs] = torch.full_like(kw[_offs], kv[0].shape[1] - 1)
            return _inner(p, x, kv=kv, **kw)

        patch(tr, name, unchanged)


def _halve(logits: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Rows [n/2, n) of the n live (leading) rows replaced by the mean of
    rows [0, n/2); nothing changes where n < 2."""
    n = live.sum()
    half = n // 2
    rows = torch.arange(logits.shape[0], device=logits.device)
    first = (rows < half).to(logits.dtype)[:, None]
    mean = (logits * first).sum(0) / half.clamp(min=1).to(logits.dtype)
    second = ((rows >= half) & (rows < n) & (n >= 2))[:, None]
    return torch.where(second, mean[None, :], logits)


def _fault_half(patch: Callable) -> None:
    from repro_torch.models import transformer as tr
    packed, decode = tr.forward_packed_paged, tr.forward_decode_paged
    patch(tr, "forward_packed_paged", lambda *a, **kw: _halve(
        packed(*a, **kw), kw["cu_seqlens"].diff() > 0))
    patch(tr, "forward_decode_paged", lambda *a, **kw: _halve(
        decode(*a, **kw), kw["kv_lengths"] > 1))


FAULTS = {"token": _fault_token, "state": _fault_state, "half": _fault_half}


def plant(name: str, patch: Callable = setattr) -> None:
    FAULTS[name](patch)
