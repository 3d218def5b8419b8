"""Single-instance serving engine of the port, from
``repro.serving.engine``, on the paged default path.

Composes the paged KV arena (radix prefix reuse, COW forks) with the
packed and decode step executors under the paper's primitives:

  * prefills, long-prefill chunks and decode rows fused into one packed
    flat stream per tick (``step_mixed``), prefix-matched pages adopted
    before the bucket is chosen;
  * long prefills advanced in C_l chunks with chunk-level prefix
    matching (``prefill_long``);
  * decode-only ticks through the bucketed paged decode step;
  * runtime (T, L, H) samples feeding ``core.boundary.fit_total``.

Sampling is greedy argmax on the device or the numpy sampler on the
host.  Outside this slice — the slot arena (``paged_kv=False``), fused
on-device sampling, speculative decoding, session export/import, and
windowed, SSM and MoE configs — every entry raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import boundary as boundary_mod
from repro_torch.core.buckets import (DEFAULT_DECODE_BUCKETS,
                                      DEFAULT_TOKEN_BUCKETS)
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.serving import packing
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.executor import (DecodeBucketExecutor,
                                          PackedBucketExecutor)
from repro_torch.serving.kvcache import PagedKVArena
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class MixedStepResult:
    """Outcome of one continuous-batching tick (engine.step_mixed)."""
    tokens: Dict[int, int]        # session → sampled next token
    fused: bool                   # True = ONE packed dispatch served all
    bucket: Optional[int] = None  # token bucket used (fused path)
    n_prefill: int = 0            # prefill + chunk segments
    n_decode: int = 0             # fused decode segments


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 16
    max_len: int = 256
    chunk_tokens: int = 64           # C_l
    pad_token: int = 0
    measure: bool = True             # collect boundary-fit samples
    token_buckets: Tuple[int, ...] = DEFAULT_TOKEN_BUCKETS
    packed_max_seqs: Optional[int] = None  # None → min(num_slots, 16)
    decode_buckets: Tuple[int, ...] = DEFAULT_DECODE_BUCKETS
    # keep a host copy of every step's last logits row per session
    # (parity harnesses, sampling introspection).  False lets all-greedy
    # steps take their token from the on-device argmax and skip the
    # full-vocab logits transfer
    keep_last_logits: bool = True
    # paged KV arena: a shared page pool + per-session page tables with
    # radix-tree prefix reuse and COW forks.  False (the slot arena) is
    # not ported yet
    paged_kv: bool = True
    page_size: int = 16
    num_pages: Optional[int] = None  # None → num_slots·max_len/page_size
    prefix_cache: bool = True        # radix prefix index on/off
    host_pool_bytes: int = 0         # host spill tier: not ported yet
    fused_sampling: bool = False     # fused sampling kernel: not ported yet


class Engine:
    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg or EngineConfig()
        self.device = tr.resolve_device(device)
        tr._check_slice(cfg)
        if not self.ecfg.paged_kv:
            raise NotImplementedError(
                "the slot-arena baseline (paged_kv=False) is not ported yet "
                "(ROADMAP Queue 1, item 9)")
        if self.ecfg.fused_sampling:
            raise NotImplementedError(
                "fused on-device sampling is not ported yet "
                "(ROADMAP Queue 1, item 12)")
        num_pages = self.ecfg.num_pages or (
            self.ecfg.num_slots * self.ecfg.max_len // self.ecfg.page_size)
        self.arena = PagedKVArena(
            cfg, num_pages, self.ecfg.page_size, self.ecfg.max_len,
            prefix_cache=self.ecfg.prefix_cache,
            host_pool_bytes=self.ecfg.host_pool_bytes, device=self.device)
        max_seqs = self.ecfg.packed_max_seqs or min(self.ecfg.num_slots, 16)
        self.packed_executor = PackedBucketExecutor(
            cfg, token_buckets=self.ecfg.token_buckets,
            max_seqs=min(max_seqs, self.ecfg.num_slots))
        self.decode_executor = DecodeBucketExecutor(
            cfg, decode_buckets=self.ecfg.decode_buckets,
            max_seqs=self.ecfg.num_slots)
        self.samples: List[Tuple[float, float, float]] = []  # (T, L, H)
        self.fitted: Optional[boundary_mod.TotalFit] = None
        # last-step logits per session (parity harness + sampling hooks)
        self.last_logits: Dict[int, np.ndarray] = {}
        # per-session sampling options (greedy argmax when absent)
        self.sampling: Dict[int, SamplingParams] = {}
        self._rngs: Dict[int, np.random.Generator] = {}
        # steps that took tokens from the on-device argmax without
        # shipping full-vocab logits to host
        self.fused_greedy_steps = 0
        self.logits_rows_shipped = 0

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host int32 step inputs → the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    # ------------------------------------------------------------ session
    def open_session(self, session: int) -> None:
        self.arena.open(session)

    def close_session(self, session: int) -> None:
        self.arena.free(session)
        self.last_logits.pop(session, None)
        self.sampling.pop(session, None)
        self._rngs.pop(session, None)

    def history(self, session: int) -> int:
        return self.arena.length(session)

    def probe_prefix(self, tokens: Sequence[int]) -> int:
        """Tokens of ``tokens`` a FRESH session would inherit from the
        radix prefix index instead of prefilling (0 with the prefix
        cache off)."""
        return int(self.arena.probe_prefix(tokens))

    def adopt_prefix(self, session: int, tokens: Sequence[int]) -> int:
        """Map the longest indexed prefix of ``tokens`` onto existing
        pages for fresh session ``session`` NOW, returning the adopted
        token count; the pages stay refcount-pinned while the request
        waits."""
        if self.arena.length(session) != 0:
            return 0
        return self.arena.match_prefix(session, tokens)

    def fork_session(self, parent: int, child: int) -> None:
        """COW-fork ``parent``'s cached context into fresh session
        ``child``: both share every page until one writes into the
        partial boundary page, which then copies on demand."""
        self.arena.fork(parent, child)

    def export_session(self, session: int):
        raise NotImplementedError(
            "session export/import is not ported yet "
            "(ROADMAP Queue 1, item 13)")

    def import_session(self, session: int, payload) -> None:
        raise NotImplementedError(
            "session export/import is not ported yet "
            "(ROADMAP Queue 1, item 13)")

    def enable_spec(self, draft: Any, k: int = 4) -> None:
        raise NotImplementedError(
            "speculative decoding is not ported yet "
            "(ROADMAP Queue 1, item 12)")

    # ----------------------------------------------------------- sampling
    def set_sampling(self, session: int,
                     params: Optional[SamplingParams]) -> None:
        """Attach per-session sampling options (None → greedy argmax)."""
        if params is None or params.is_default:
            self.sampling.pop(session, None)
            self._rngs.pop(session, None)
            return
        self.sampling[session] = params
        if params.is_greedy:
            self._rngs.pop(session, None)
        else:
            self._rngs[session] = sampling_mod.make_rng(session, params)

    def _sample_rows(self, sessions: Sequence[int],
                     logits: np.ndarray) -> np.ndarray:
        """One token per (session, logits row) under its options."""
        return sampling_mod.sample_batch(logits, sessions, self.sampling,
                                         self._rngs)

    def _tokens_from_step(self, sessions: Sequence[int], logits_dev,
                          ids_dev) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Sample one token per session from a step's outputs.

        An all-greedy step with ``keep_last_logits=False`` takes its
        tokens from the on-device argmax — the full-vocab logits never
        cross to host.  Otherwise the rows are shipped and sampled on
        host.  Returns (tokens (n,), logits_np or None)."""
        n = len(sessions)
        all_greedy = all(s not in self.sampling for s in sessions)
        if all_greedy and not self.ecfg.keep_last_logits:
            self.fused_greedy_steps += 1
            return ids_dev[:n].cpu().numpy().astype(np.int64), None
        logits_np = logits_dev.float().cpu().numpy()
        self.logits_rows_shipped += int(logits_np.shape[0])
        return self._sample_rows(sessions, logits_np[:n]), logits_np

    # ------------------------------------------------------------- prefill
    def prefill_batch(self, sessions: Sequence[int],
                      token_lists: Sequence[np.ndarray],
                      bucket: Optional[Tuple[int, int]] = None
                      ) -> Dict[int, int]:
        """Short-prefill / re-prefill batch on the packed stream.  A
        pinned (L, B) graph bucket has no meaning on a paged pool (there
        is no dense gather path), so ``bucket`` is ignored, as the JAX
        engine ignores it on paged arenas.
        Returns {session: first_sampled_token}."""
        return self.step_mixed(list(zip(sessions, token_lists)), []).tokens

    def prefill_packed(self, sessions: Sequence[int],
                       token_lists: Sequence[np.ndarray],
                       token_bucket: Optional[int] = None
                       ) -> Dict[int, int]:
        """Padding-free packed prefill / re-prefill.
        Returns {session: first_sampled_token}."""
        assert len(sessions) == len(token_lists)
        res = self.step_mixed(list(zip(sessions, token_lists)), [],
                              token_bucket=token_bucket)
        return res.tokens

    # ------------------------------------------------- continuous batching
    def step_mixed(self, prefills: Sequence[Tuple[int, np.ndarray]],
                   decodes: Sequence[Tuple[int, int]],
                   token_bucket: Optional[int] = None,
                   max_new: Optional[Dict[int, int]] = None
                   ) -> MixedStepResult:
        """One continuous-batching tick: short prefills, long-prefill
        chunks, and single-token decode segments fused into ONE packed
        flat stream.

        prefills: (session, new_tokens) — fresh prefill, re-prefill, or a
        C_l chunk (the session's cached length is the history offset).
        decodes: (session, last_token) — in-flight sessions advancing one
        token each.  ``max_new`` is accepted for the serve loop's
        interface (it caps speculative commits, which are not ported).

        A mix that overflows ``max_seqs`` or the ladder is SPLIT across
        packed steps (a paged pool has no dense fallback).  Returns a
        :class:`MixedStepResult`."""
        prefills, decodes = list(prefills), list(decodes)
        n_p, n_d = len(prefills), len(decodes)
        assert n_p + n_d > 0, "empty mixed step"
        sess_all = [s for s, _ in prefills] + [s for s, _ in decodes]
        assert len(set(sess_all)) == len(sess_all), \
            f"session appears twice in one step: {sess_all}"
        # radix prefix adoption: a FRESH session's prompt maps its
        # longest indexed prefix onto existing pages BEFORE the bucket is
        # chosen, so the step only prefills (and the ladder only prices)
        # the new suffix
        rewritten = []
        for s, toks in prefills:
            toks = np.asarray(toks, np.int32)
            if self.arena.length(s) == 0:
                matched = self.arena.match_prefix(s, toks)
                if matched:
                    toks = toks[matched:]
            rewritten.append((s, toks))
        prefills = rewritten
        lens = [len(t) for _, t in prefills]
        total = sum(lens) + n_d
        px = self.packed_executor
        bucket = None
        if n_p + n_d <= px.max_seqs:
            bucket = token_bucket or px.bucket_for(total)
            if bucket is not None and bucket < total:
                bucket = None
        if bucket is None:
            return self._step_split(prefills, decodes)

        segments: List[packing.SegmentSpec] = []
        for s, toks in prefills:
            segments.append(packing.SegmentSpec(
                s, np.asarray(toks, np.int32), self.arena.length(s),
                kind="prefill"))
        for s, tok in decodes:
            assert self.arena.length(s) > 0, \
                f"decode session {s} has no cached context"
            segments.append(packing.SegmentSpec(
                s, np.asarray([tok], np.int32), self.arena.length(s),
                kind="decode"))
        return self._run_packed_paged(segments, bucket)

    def _step_split(self, prefills: Sequence[Tuple[int, np.ndarray]],
                    decodes: Sequence[Tuple[int, int]]) -> MixedStepResult:
        """Serve an off-ladder / over-depth mix without a dense path:
        prefills advance in C_l-sized packed chunks and the decode
        backlog drains in ladder-top groups."""
        px = self.packed_executor
        c = min(self.ecfg.chunk_tokens, px.ladder.max_tokens)
        out: Dict[int, int] = {}
        for s, toks in prefills:
            toks = np.asarray(toks)
            for start in range(0, len(toks), c):
                res = self.step_mixed([(s, toks[start:start + c])], [])
                out[s] = res.tokens[s]
        if decodes:
            m = self.decode_executor.ladder.max_seqs
            decodes = list(decodes)
            for i in range(0, len(decodes), m):
                grp = decodes[i:i + m]
                dec = self.decode_batch([s for s, _ in grp],
                                        [t for _, t in grp])
                out.update({s: v[0] for s, v in dec.items()})
        return MixedStepResult(tokens=out, fused=False,
                               n_prefill=len(prefills),
                               n_decode=len(decodes))

    def _run_packed_paged(self, segments: List[packing.SegmentSpec],
                          bucket: int) -> MixedStepResult:
        """Paged dispatch of an assembled segment list.

        Per segment, ``prepare_extend`` makes the write range
        exclusively owned (COW-copying a fork-shared boundary page,
        allocating tail pages); the step then writes each stream row's
        KV at its (page, offset) and reads every segment's FULL logical
        context — matched prefix pages included — through its page-table
        row.  Tail rows and dummy sequences park on the reserved scratch
        page at offset page_size − 1.  ``commit`` records the written
        token ids and indexes newly-full pages for cross-session reuse."""
        px = self.packed_executor
        ar = self.arena
        ps = ar.page_size
        n = len(segments)
        b_max = px.stream_rows
        stream = packing.assemble_mixed_stream(
            segments, bucket, b_max, park_position=ar.max_len - 1,
            pad_token=self.ecfg.pad_token)
        sessions = [seg.session for seg in segments]

        page_table = np.full((b_max, ar.max_pages_per_seq), ar.scratch,
                             np.int32)
        token_pages = np.full(bucket, ar.scratch, np.int32)
        token_offs = np.full(bucket, ps - 1, np.int32)
        cu = stream.cu_seqlens
        for i, seg in enumerate(segments):
            pages = ar.prepare_extend(seg.session, seg.length)
            page_table[i, :len(pages)] = pages
            pos = stream.positions[cu[i]:cu[i + 1]]
            pt = np.asarray(pages, np.int32)
            token_pages[cu[i]:cu[i + 1]] = pt[pos // ps]
            token_offs[cu[i]:cu[i + 1]] = pos % ps

        t0 = time.perf_counter()
        last, ids = px.mixed_step_paged(
            self.params, self._dev(stream.tokens),
            self._dev(stream.positions), self._dev(token_pages),
            self._dev(token_offs), self._dev(page_table),
            self._dev(stream.cu_seqlens), self._dev(stream.q_offsets),
            self._dev(stream.kv_lengths), ar.arena,
            self._dev(stream.last_idx), n_decode=stream.decode_tokens)
        toks, last_np = self._tokens_from_step(sessions, last, ids)
        elapsed = time.perf_counter() - t0
        px.note_padding(stream.total_tokens, bucket)
        out: Dict[int, int] = {}
        for i, seg in enumerate(segments):
            ar.commit(seg.session, seg.tokens)
            out[seg.session] = int(toks[i])
            if last_np is not None:
                self.last_logits[seg.session] = last_np[i]
        if self.ecfg.measure:
            # only prefill work feeds the (T, L, H) boundary fit — decode
            # rows are priced by the decode model, not T(L, H)
            pre = [seg for seg in segments if seg.kind != "decode"]
            if pre:
                per = elapsed / len(pre)
                for seg in pre:
                    self.samples.append((per, float(seg.length),
                                         float(seg.history)))
        n_d = stream.decode_tokens
        return MixedStepResult(tokens=out, fused=True, bucket=bucket,
                               n_prefill=n - n_d, n_decode=n_d)

    # ------------------------------------------------------ long prefill
    def prefill_long(self, session: int, token_list: np.ndarray) -> int:
        """Chunked long prefill (C_l per step).  Returns first token.

        Each chunk rides the packed stream as a re-prefill segment whose
        history is the tokens already done.  CHUNK-LEVEL prefix
        matching: the radix index is re-probed at every chunk boundary,
        so a long prompt whose cached prefix extends past the first
        chunk adopts the already-indexed pages mid-request."""
        c = self.ecfg.chunk_tokens
        arr = np.asarray(token_list)
        tok = None
        i = 0
        while i < len(arr):
            if self.arena.index is not None:
                i += self.arena.match_extend(
                    session, [int(t) for t in arr[i:]])
            chunk = arr[i:i + c]
            res = self.prefill_packed([session], [np.asarray(chunk)])
            tok = res[session]
            i += len(chunk)
        return tok

    # ------------------------------------------------------------- decode
    def decode_batch(self, sessions: Sequence[int],
                     tokens: Sequence[int], steps: int = 1
                     ) -> Dict[int, List[int]]:
        """Decode ``steps`` tokens for each session through the bucketed
        paged decode step; a batch over the ladder top splits into
        ladder-top groups."""
        dx = self.decode_executor
        bucket = dx.bucket_for(len(sessions))
        if bucket is None:
            m = dx.ladder.max_seqs
            out: Dict[int, List[int]] = {}
            sessions, tokens = list(sessions), list(tokens)
            for i in range(0, len(sessions), m):
                out.update(self.decode_batch(sessions[i:i + m],
                                             tokens[i:i + m], steps))
            return out
        return self._decode_batch_paged(sessions, tokens, steps, bucket)

    def _decode_batch_paged(self, sessions: Sequence[int],
                            tokens: Sequence[int], steps: int,
                            bucket: int) -> Dict[int, List[int]]:
        """Paged decode tick: each row writes its new KV at (page,
        offset) from ``prepare_extend(1)`` — COW-copying a fork-shared
        boundary page first — and attends over its full logical context
        through its page-table row.  Ladder pad rows park on the scratch
        page at offset page_size − 1 and attend over one garbage key
        (output discarded)."""
        dx = self.decode_executor
        ar = self.arena
        ps = ar.page_size
        n = len(sessions)
        cur = np.asarray(tokens, np.int32)
        out: Dict[int, List[int]] = {s: [] for s in sessions}
        for _ in range(steps):
            hists = [ar.length(s) for s in sessions]
            assert all(h > 0 for h in hists), \
                f"paged decode on an empty session: {list(sessions)}"
            tok = np.full(bucket, self.ecfg.pad_token, np.int32)
            tok[:n] = cur
            positions = np.full(bucket, ar.max_len - 1, np.int32)
            write_pages = np.full(bucket, ar.scratch, np.int32)
            write_offs = np.full(bucket, ps - 1, np.int32)
            page_table = np.full((bucket, ar.max_pages_per_seq),
                                 ar.scratch, np.int32)
            kv_lengths = np.ones(bucket, np.int32)
            for i, (s, h) in enumerate(zip(sessions, hists)):
                pages = ar.prepare_extend(s, 1)
                page_table[i, :len(pages)] = pages
                positions[i] = h
                write_pages[i] = pages[h // ps]
                write_offs[i] = h % ps
                kv_lengths[i] = h + 1
            logits, ids = dx.decode_paged(
                self.params, self._dev(tok), self._dev(positions),
                self._dev(write_pages), self._dev(write_offs),
                self._dev(page_table), self._dev(kv_lengths), ar.arena)
            dx.note_padding(n, bucket)
            # the KV written this tick belongs to the INPUT token — the
            # radix index must see the ids whose keys occupy the pages
            for i, s in enumerate(sessions):
                ar.commit(s, [int(cur[i])])
            toks, logits_np = self._tokens_from_step(sessions, logits, ids)
            cur = toks.astype(np.int32)
            for i, s in enumerate(sessions):
                out[s].append(int(cur[i]))
                if logits_np is not None:
                    self.last_logits[s] = logits_np[i]
        return out

    # ------------------------------------------------------ runtime fit
    def fit_boundary(self) -> Optional[boundary_mod.TotalFit]:
        if len(self.samples) >= 8:
            self.fitted = boundary_mod.fit_total(self.samples)
        return self.fitted

    def classification_threshold(self, history: int = 0) -> float:
        if self.fitted is not None:
            return self.fitted.boundary(history)
        return boundary_mod.H200_QWEN32B.boundary(history)

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict:
        ar, px, dx = self.arena, self.packed_executor, self.decode_executor
        return {
            "free_slots": ar.free_pages,
            "free_pages": ar.free_pages,
            "radix_pages": (len(ar.index.pages())
                            if ar.index is not None else 0),
            "fit_samples": len(self.samples),
            # whole-sequence copy proof: the paged paths keep both at 0
            "arena_gathers": ar.gather_calls,
            "arena_scatters": ar.scatter_calls,
            "prefix_hit_tokens": ar.prefix_hit_tokens,
            "chunk_hit_tokens": ar.chunk_hit_tokens,
            "pages_cow_forked": ar.pages_cow_forked,
            "pages_evicted": ar.pages_evicted,
            "decode_shapes": len(dx.compile_times),
            "decode_dispatches": dx.dispatches,
            "decode_hit_rate": dx.hit_rate,
            "decode_useful_rows": dx.useful_tokens,
            "decode_pad_rows": dx.padded_tokens,
            "decode_padding_efficiency": dx.padding_efficiency,
            "packed_shapes": len(px.compile_times),
            "packed_hit_rate": px.hit_rate,
            "packed_useful_tokens": px.useful_tokens,
            "packed_padded_tokens": px.padded_tokens,
            "packed_padding_efficiency": px.padding_efficiency,
            "packed_dispatches": px.dispatches,
            "packed_shapes_by_kind": px.shapes_by_kind(),
            "mixed_steps": px.mixed_steps,
            "decode_tokens_fused": px.decode_tokens_fused,
            "fused_greedy_steps": self.fused_greedy_steps,
            "logits_rows_shipped": self.logits_rows_shipped,
        }
