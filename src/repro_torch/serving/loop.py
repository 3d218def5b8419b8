"""Wall-clock serving loop of the port, from ``repro.serving.loop``:
core policies driving the real PyTorch engine.

This is the production composition (launch/serve.py wraps it):

  requests → DualQueue classification → AWD short batches / chunked
  long prefills → bucketized AOT executables → KV arena → decode.

The same policy objects run in the simulator under a virtual clock; here
they schedule real PyTorch computations, TTFTs are real wall-clock, and the
engine's (T, L, H) samples continuously re-fit the §2.1 boundary.

Continuous batching (DESIGN.md §4): sessions submitted with
``decode_tokens > 0`` keep generating after their prefill completes.
Instead of alternating prefill and decode phases, every scheduler tick
drives ONE mixed step — the packed flat stream carries the tick's short
prefills (or the long-prefill chunk) plus one decode token for each
in-flight session, so prefill and decode share a single dispatch.  The
decode backlog is reported to the policy, which shrinks the AWD waiting
window (a stalled window stalls every session's TPOT) and reserves
stream rows for the fused decode segments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.request import Batch, Request
from repro_torch.core.scheduler import BasePolicy, ChunkWork
from repro_torch.core.slo import SLOTracker
from repro_torch.serving import packing
from repro_torch.serving import trace
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class PendingRequest:
    req: Request
    tokens: np.ndarray            # prompt suffix past any adopted prefix
    decode_tokens: int = 0
    prompt: Optional[np.ndarray] = None   # full original prompt (deflection)
    sampling: Optional[SamplingParams] = None


class ServeLoop:
    def __init__(self, engine: Engine, policy: BasePolicy,
                 slo_ttft: Optional[float] = 0.4,
                 clock: Callable[[], float] = time.monotonic,
                 refit_every: int = 16,
                 max_queue: Optional[int] = None,
                 admission=None):
        self.engine = engine
        self.policy = policy
        self.clock = clock
        self.tracker = SLOTracker(slo_ttft)
        self.slo = slo_ttft
        # §11 admission control: a bounded intake queue plus an optional
        # CostModel-shaped estimator (anything with predicted_ttft(l, h,
        # queue_len, backlog_tokens, active_decodes)); a submit whose
        # predicted completion already violates its deadline is rejected
        # at the door.  Both default OFF — accept-everything.
        self.max_queue = max_queue
        self.admission = admission
        # §11 fault seams, wired by ServeCluster: a FaultInjector whose
        # dispatch_fails(engine_id, tick) is consulted before every
        # dispatch, plus this loop's id and a monotone tick counter
        self.faults = None
        self.engine_id = 0
        self.ticks = 0
        self.dispatch_faults = 0
        self._tokens: Dict[int, PendingRequest] = {}
        self._outstanding = 0
        self.refit_every = refit_every
        self._since_fit = 0
        self.first_tokens: Dict[int, int] = {}
        # continuous batching state: in-flight decode sessions
        self.active_decodes: Dict[int, int] = {}   # session → tokens left
        self.last_token: Dict[int, int] = {}
        self.generated: Dict[int, List[int]] = {}
        self.tpot_samples: List[float] = []        # s between decode tokens
        self.max_tpot_samples = 4096               # keep the tail only
        self._last_emit: Dict[int, float] = {}
        # tokens accepted for a session but not yet written to the engine
        # cache (queued prefills + unserved decode budgets): the history
        # estimate for a turn enqueued behind another turn of the same
        # session is engine.history + this
        self._session_pending: Dict[int, int] = {}
        # §11 recovery transcript: the EXACT token sequence the engine
        # cache holds per session (committed turn prompts + generated
        # tokens whose KV has been written), plus the one sampled-but-
        # unwritten "pending" token (its KV lands when it is fed as the
        # next decode input).  Re-prefilling _cache_tokens on a survivor
        # reproduces the crashed cache bit-for-bit; feeding the recorded
        # pending token resumes generation exactly where it stopped.
        self._cache_tokens: Dict[int, List[int]] = {}
        self._cache_pending: Dict[int, int] = {}
        # §12 cold-miss coalescing (wait-for-fill): concurrent COLD
        # submits of an identical full-page prompt prefix park behind
        # the first submit (the "filler") instead of each prefilling the
        # same pages; when the filler's prefill completes, the waiters
        # re-enter intake and adopt the freshly indexed pages.  Keyed by
        # the prompt's full-page chunk prefix.
        self._active_fills: Dict[Tuple[int, ...], int] = {}  # key → rid
        self._fill_waiters: Dict[Tuple[int, ...], List[Tuple]] = {}
        self.coalesced_prefills = 0
        # §12 chunk-level matching: re-probe the radix index at every
        # chunk boundary of a long prefill (False = the old submit-only
        # probe — kept as the measurement baseline for benches/tests)
        self.chunk_matching = True

    def _dec_pending(self, session: int, n: int) -> None:
        if n <= 0 or session not in self._session_pending:
            return
        left = self._session_pending[session] - n
        if left > 0:
            self._session_pending[session] = left
        else:
            self._session_pending.pop(session, None)

    def close_session(self, session: int) -> None:
        """Release a finished session: its engine slot and every piece
        of per-session loop state (transcripts, decode bookkeeping) —
        long-running loops must not accumulate dead sessions.  Queued
        turns for the session are purged FIRST: a later tick must never
        dispatch a prefill into the freed (or reallocated) slot."""
        for r in self.policy.purge(lambda q: q.session == session):
            self._tokens.pop(r.rid, None)
            self._outstanding -= 1
            self._finish_fill(r.rid)
        # parked waiters of the closing session vanish with it
        for key, ws in list(self._fill_waiters.items()):
            keep = [w for w in ws if w[0].session != session]
            self._outstanding -= len(ws) - len(keep)
            self._fill_waiters[key] = keep
        self.engine.close_session(session)
        self.active_decodes.pop(session, None)
        self.last_token.pop(session, None)
        self.generated.pop(session, None)
        self.first_tokens.pop(session, None)
        self._last_emit.pop(session, None)
        self._session_pending.pop(session, None)
        self._cache_tokens.pop(session, None)
        self._cache_pending.pop(session, None)

    # ------------------------------------------------------------ intake
    def submit(self, session: int, tokens: np.ndarray,
               decode_tokens: int = 0,
               deadline: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Queue one turn.  ``sampling`` attaches per-session decode
        options (temperature / top-k / top-p / logit-bias); None or
        temperature 0 without a bias is greedy.  They apply to the TTFT
        token and every generated token, on the fused mixed path and
        the bucketed decode path alike — every path ends in the same
        logits gather."""
        now = self.clock()
        ddl = deadline if deadline is not None else \
            (now + self.slo if self.slo else None)
        if self.max_queue is not None or self.admission is not None:
            r = self._admission_gate(session, tokens, now, ddl)
            if r is not None:
                return r
        # a new turn preempts any generation still running on the session
        # — including decode budgets of EARLIER turns still queued: those
        # tokens will never be generated, so the pending-token estimate
        # must forget them too
        preempted = self.active_decodes.pop(session, 0)
        # the preempted turn's sampled-but-unwritten token never reaches
        # the cache — the new turn prefills right after the committed
        # history, so the recovery transcript must forget it too
        self._cache_pending.pop(session, None)
        for p in self._tokens.values():
            if p.req.session == session and p.decode_tokens:
                preempted += p.decode_tokens
                p.decode_tokens = 0
        self._dec_pending(session, preempted)
        self.engine.open_session(session)
        self.engine.set_sampling(session, sampling)
        pending = self._session_pending.get(session, 0)
        # history ESTIMATE: cache length now plus every queued-but-unwritten
        # token of this session.  Reading engine.history alone is stale the
        # moment a second turn is submitted before the first dispatches —
        # wrong dual-queue classification and AWD billing.  The estimate is
        # refined to the exact cache length at dispatch time.
        hist = self.engine.history(session) + pending
        # paged engines with a radix prefix index: adopt the longest
        # indexed prefix of the prompt RIGHT HERE, so length-aware
        # classification, the AWD token budget, and the long-prefill
        # chunker all see (and slice) exactly the true suffix — the
        # matched pages are refcount-pinned while the request waits and
        # the prefill step only ever touches tokens past them (§8).
        # Adoption is gated on a TRULY empty session: adopting under a
        # queued prior turn would bump the arena length and corrupt the
        # queued turn's write offset.
        prompt = np.asarray(tokens)
        # §12 wait-for-fill: a COLD submit whose full-page prefix is
        # already being filled by an in-flight request parks behind that
        # filler — it re-enters intake on fill completion and adopts the
        # indexed pages instead of prefilling them a second time
        key = self._fill_key(prompt) if hist == 0 else None
        if key is not None and key in self._active_fills:
            r = Request(new_tokens=len(prompt), history_tokens=0,
                        arrival=now, deadline=ddl, session=session)
            self._fill_waiters[key].append(
                (r, prompt, decode_tokens, sampling))
            self._session_pending[session] = \
                pending + len(prompt) + decode_tokens
            self._outstanding += 1
            self.coalesced_prefills += 1
            return r
        reusable = self.engine.adopt_prefix(session, prompt) if hist == 0 \
            else 0
        tokens = prompt[reusable:]
        r = Request(new_tokens=len(tokens),
                    history_tokens=hist + reusable,
                    arrival=now, deadline=ddl,
                    session=session, reusable_prefix=reusable)
        self._tokens[r.rid] = PendingRequest(r, tokens, decode_tokens,
                                             prompt=prompt,
                                             sampling=sampling)
        self._session_pending[session] = \
            pending + len(tokens) + decode_tokens
        self.policy.enqueue(r, now)
        self._outstanding += 1
        # this request will index new full pages: register it as the
        # filler so identical cold submits park instead of duplicating
        if key is not None and key not in self._active_fills and \
                reusable < len(key):
            self._active_fills[key] = r.rid
            self._fill_waiters[key] = []
        return r

    def _fill_key(self, prompt: np.ndarray) -> Optional[Tuple[int, ...]]:
        """Coalescing key: the prompt's full-page chunk prefix (≥ 1 full
        page, keeping 1 token of true suffix).  None when the engine has
        no radix index or the prompt spans no full page."""
        eng = self.engine
        if not eng._paged or eng.arena.index is None:
            return None
        ps = eng.arena.page_size
        n_full = max(len(prompt) - 1, 0) // ps
        if n_full == 0:
            return None
        return tuple(int(t) for t in prompt[:n_full * ps])

    def _finish_fill(self, rid: int) -> None:
        """Filler completion (or cancellation): release its parked
        waiters back through normal intake — they adopt whatever the
        radix index now holds (the full filled prefix on success, less
        on a withdrawn/abandoned filler) and queue only their true
        suffix."""
        key = next((k for k, v in self._active_fills.items() if v == rid),
                   None)
        if key is None:
            return
        del self._active_fills[key]
        waiters = self._fill_waiters.pop(key, [])
        now = self.clock()
        for r, prompt, decode_tokens, sampling in waiters:
            s = r.session
            self._dec_pending(s, len(prompt) + decode_tokens)
            self._outstanding -= 1
            pending = self._session_pending.get(s, 0)
            hist = self.engine.history(s) + pending
            reusable = self.engine.adopt_prefix(s, prompt) if hist == 0 \
                else 0
            suffix = prompt[reusable:]
            r.new_tokens = len(suffix)
            r.history_tokens = hist + reusable
            r.reusable_prefix = reusable
            self._tokens[r.rid] = PendingRequest(
                r, suffix, decode_tokens, prompt=prompt, sampling=sampling)
            self._session_pending[s] = \
                pending + len(suffix) + decode_tokens
            self.policy.enqueue(r, now)
            self._outstanding += 1

    def _admission_gate(self, session: int, tokens: np.ndarray,
                        now: float, ddl: Optional[float]
                        ) -> Optional[Request]:
        """§11 admission control, checked BEFORE any submit side effect
        (no session opened, no prefix adopted, nothing queued).  Returns
        the rejected Request (``rejected=True``, never enqueued) when the
        submit should be shed, else None.  Two triggers: a full bounded
        queue, and a predicted TTFT that already violates the deadline —
        serving a guaranteed violation only delays everyone behind it."""
        reject = False
        if self.max_queue is not None and \
                self.policy.queue_len() >= self.max_queue:
            reject = True
        elif self.admission is not None and ddl is not None:
            hist = self.engine.history(session) + \
                self._session_pending.get(session, 0)
            eta = now + self.admission.predicted_ttft(
                len(tokens), hist, self.policy.queue_len(),
                self.policy.backlog_tokens(), len(self.active_decodes))
            reject = eta > ddl
        if not reject:
            return None
        r = Request(new_tokens=len(np.asarray(tokens)),
                    history_tokens=self.engine.history(session),
                    arrival=now, deadline=ddl, session=session,
                    rejected=True)
        self.tracker.note_rejected()
        return r

    def withdraw(self, rid: int) -> Optional[PendingRequest]:
        """Deflection support (§9): pull a still-queued request back out
        of the loop — removed from the policy and every intake-side
        record as if it had never been submitted — so the cluster can
        re-route it.  Returns None when the request is unknown or has
        already dispatched (too late to bounce)."""
        pr = self._tokens.get(rid)
        if pr is None or pr.req.dispatch_time is not None:
            return None
        if not self.policy.purge(lambda q: q.rid == rid):
            return None
        self._tokens.pop(rid, None)
        self._outstanding -= 1
        session = pr.req.session
        self._dec_pending(session, len(pr.tokens) + pr.decode_tokens)
        # free the engine session when nothing else references it — the
        # withdrawn request wrote no KV (at most adopted pins, which
        # close releases)
        others = any(p.req.session == session
                     for p in self._tokens.values())
        if not others and session not in self.active_decodes and \
                self.engine.history(session) <= pr.req.reusable_prefix:
            self.engine.close_session(session)
        # a withdrawn filler releases its waiters (they adopt whatever
        # the index holds and prefill the rest themselves)
        self._finish_fill(rid)
        return pr

    # ------------------------------------------------- decode bookkeeping
    def _start_decoding(self, session: int, first_token: int,
                        budget: int, now: float) -> None:
        self.first_tokens[session] = first_token
        self.generated.setdefault(session, []).append(first_token)
        self.last_token[session] = first_token
        self._last_emit[session] = now
        # the freshly sampled TTFT token: emitted, but its KV is written
        # only when it is fed as the next decode input
        self._cache_pending[session] = first_token
        if budget > 0:
            self.active_decodes[session] = budget

    def _record_decoded(self, session: int, tokens: List[int],
                        now: float) -> None:
        """Commit the tokens one tick emitted for a session.  A
        speculative tick commits up to k+1 tokens in ONE dispatch
        (DESIGN.md §10); the tick's wall-clock gap covers that many
        inter-token intervals, so TPOT credits m samples of gap/m each —
        billing the full gap to every token would overstate TPOT m-fold,
        and billing it once would hide the speculative speedup."""
        m = len(tokens)
        if m == 0:
            return
        self.generated.setdefault(session, []).extend(tokens)
        self.last_token[session] = tokens[-1]
        # recovery transcript (§11): committing m tokens means the old
        # pending token plus the first m-1 new ones had their KV written
        # (each as a dispatch input row); the last new token becomes the
        # next pending.  Holds for plain 1-token ticks and speculative
        # multi-commits alike.
        pend = self._cache_pending.get(session)
        if pend is not None:
            seq = [pend] + tokens
            self._cache_tokens.setdefault(session, []).extend(seq[:-1])
            self._cache_pending[session] = seq[-1]
        gap = (now - self._last_emit.get(session, now)) / m
        self.tpot_samples.extend([gap] * m)
        if len(self.tpot_samples) > 2 * self.max_tpot_samples:
            self.tpot_samples = self.tpot_samples[-self.max_tpot_samples:]
        self._last_emit[session] = now
        self._dec_pending(session, m)   # these tokens' KV is now cached
        left = self.active_decodes.get(session, 0) - m
        if left > 0:
            self.active_decodes[session] = left
        else:
            self.active_decodes.pop(session, None)

    def _commit_turn(self, session: int, pr: PendingRequest) -> None:
        """Recovery transcript (§11): a turn's prompt enters the cache
        atomically when its prefill COMPLETES (last chunk included) —
        adopted prefix plus suffix, i.e. the full original prompt.
        Mid-turn partial chunks are deliberately not tracked: a crash
        mid-prefill restarts the turn from its full prompt."""
        full = pr.prompt if pr.prompt is not None else pr.tokens
        self._cache_tokens.setdefault(session, []).extend(
            int(t) for t in np.asarray(full).tolist())

    def _fusable_decodes(self, exclude: Tuple[int, ...] = ()
                         ) -> List[Tuple[int, int]]:
        return [(s, self.last_token[s]) for s in self.active_decodes
                if s not in exclude]

    def _tokens_per_decode(self) -> int:
        """Stream tokens one fused decode session costs this tick: 1 +
        spec_k when the engine runs speculative verify segments, else 1.
        Sizing the ladder/AWD reserves with this keeps verify segments
        from busting the token bucket mid-assembly."""
        return 1 + self.engine.spec_k if self.engine.spec_enabled else 1

    @staticmethod
    def _committed(res, session: int) -> List[int]:
        """Tokens a mixed step emitted for a fused decode session — the
        full speculative commit when present, the single sampled token
        otherwise."""
        if res.committed and session in res.committed:
            return list(res.committed[session])
        return [res.tokens[session]]

    # ----------------------------------------------------------- execute
    def _run_batch(self, batch: Batch) -> None:
        now = self.clock()
        sessions, token_lists = [], []
        for r in batch.requests:
            r.dispatch_time = now
            # the enqueue-time history was an estimate (a prior turn of
            # the session may still have been queued); the cache length
            # NOW is the truth the prefill writes against
            r.history_tokens = self.engine.history(r.session)
            pr = self._tokens[r.rid]
            sessions.append(r.session)
            token_lists.append(pr.tokens)
        px = self.engine.packed_executor
        if batch.is_packed:
            # the unified tick: fuse one decode token per in-flight
            # session into the prefill stream, up to the bucket's room
            fused: List[Tuple[int, int]] = []
            bucket = batch.token_bucket
            if px is not None:
                cand = self._fusable_decodes(exclude=tuple(sessions))
                n_fit, bucket = packing.fit_decodes(
                    sum(len(t) for t in token_lists), len(sessions),
                    len(cand), px.ladder, token_bucket=batch.token_bucket,
                    tokens_per_decode=self._tokens_per_decode())
                fused = cand[:n_fit]
            batch.decode_tokens = len(fused)
            res = self.engine.step_mixed(
                list(zip(sessions, token_lists)), fused,
                token_bucket=bucket,
                max_new={s: self.active_decodes[s] for s, _ in fused})
            firsts = res.tokens
        else:
            fused = []
            bucket = None
            if batch.uses_graph:
                bucket = (batch.bucket_len, batch.bucket_depth)
            firsts = self.engine.prefill_batch(sessions, token_lists, bucket)
        done = self.clock()
        with trace.span("serve.bookkeep"):
            for s, _ in fused:
                self._record_decoded(s, self._committed(res, s), done)
            for r in batch.requests:
                r.finish_time = done
                self.tracker.record(r)
                pr = self._tokens.pop(r.rid)  # prefill served: drop prompt
                self._dec_pending(r.session, len(pr.tokens))
                self._commit_turn(r.session, pr)
                self._start_decoding(r.session, firsts[r.session],
                                     pr.decode_tokens, done)
                self._outstanding -= 1
                self._finish_fill(r.rid)      # release parked waiters

    def _run_chunk(self, work: ChunkWork) -> None:
        now = self.clock()
        r = work.req
        if r.dispatch_time is None:
            r.dispatch_time = now
            # first chunk: refine the enqueue-time history estimate to
            # the exact cache length (later chunks keep it — done chunks
            # are accounted by ChunkWork.done_tokens)
            r.history_tokens = self.engine.history(r.session)
        pr = self._tokens[r.rid]
        # §12 chunk-level matching: re-probe the radix index at this
        # chunk boundary — pages indexed since submit (another request's
        # fill that was still in flight back then) are adopted instead
        # of re-prefilled.  match_extend self-gates on page alignment
        # and keeps ≥ 1 token of true suffix, so the final chunk always
        # dispatches and produces the first-token logits.
        adopt = 0
        if self.chunk_matching and self.engine._paged \
                and self.engine.arena.index is not None:
            rem = pr.tokens[work.done_tokens:]
            if len(rem) > 1:
                if self.engine.history(r.session) == 0:
                    # cold at submit, warm now: the first chunk gets the
                    # full-prompt match the submit-time probe missed
                    adopt = self.engine.adopt_prefix(r.session, rem)
                    # count it with the chunk-boundary hits: the submit
                    # probe missed these pages, the re-probe found them
                    self.engine.arena.chunk_hit_tokens += adopt
                else:
                    adopt = self.engine.arena.match_extend(
                        r.session, [int(t) for t in rem[:-1]])
        if adopt:
            self._dec_pending(r.session, adopt)
            work.chunk_tokens += adopt   # on_complete advances past them
            work.is_last = work.is_last or \
                (work.done_tokens + work.chunk_tokens >= len(pr.tokens))
        chunk = np.asarray(
            pr.tokens[work.done_tokens + adopt:
                      work.done_tokens + work.chunk_tokens])
        px = self.engine.packed_executor
        if px is not None:
            # a long-prefill chunk shares the packed stream with the
            # decode backlog instead of serializing against it
            cand = self._fusable_decodes(exclude=(r.session,))
            n_fit, bucket = packing.fit_decodes(
                len(chunk), 1, len(cand), px.ladder,
                tokens_per_decode=self._tokens_per_decode())
            fused = cand[:n_fit] if bucket is not None else []
            res = self.engine.step_mixed(
                [(r.session, chunk)], fused, token_bucket=bucket,
                max_new={s: self.active_decodes[s] for s, _ in fused})
            firsts = res.tokens
        else:
            fused = []
            firsts = self.engine.prefill_batch([r.session], [chunk])
        done = self.clock()
        with trace.span("serve.bookkeep"):
            for s, _ in fused:
                self._record_decoded(s, self._committed(res, s), done)
            self._dec_pending(r.session, len(chunk))
            if work.is_last:
                r.finish_time = done
                self.tracker.record(r)
                self._tokens.pop(r.rid, None)    # all chunks served
                self._commit_turn(r.session, pr)
                self._start_decoding(r.session, firsts[r.session],
                                     pr.decode_tokens, done)
                self._outstanding -= 1
                self._finish_fill(r.rid)         # release parked waiters

    def _run_decode_only(self) -> None:
        """No prefill work this tick: advance every in-flight session in
        a single dispatch.  With a draft armed this is one speculative
        verify step — each session commits up to spec_k + 1 tokens per
        dispatch (DESIGN.md §10), capped by its remaining budget — else
        one token via the arena-resident bucketed decode path (or the
        dense gather step)."""
        sessions = list(self.active_decodes)
        if self.engine.spec_enabled:
            out = self.engine.spec_step(
                [(s, self.last_token[s]) for s in sessions],
                max_new=dict(self.active_decodes))
            done = self.clock()
            with trace.span("serve.bookkeep"):
                for s in sessions:
                    self._record_decoded(s, out[s], done)
            return
        tokens = [self.last_token[s] for s in sessions]
        out = self.engine.decode_batch(sessions, tokens, steps=1)
        done = self.clock()
        with trace.span("serve.bookkeep"):
            for s in sessions:
                self._record_decoded(s, [out[s][0]], done)

    # --------------------------------------------------------------- run
    @property
    def has_work(self) -> bool:
        """True while any prefill is queued or any decode budget remains."""
        return self._outstanding > 0 or bool(self.active_decodes)

    def tick(self) -> Tuple[bool, Optional[float]]:
        """One unified scheduler tick: ask the policy for work, run it
        (or a decode-only step when the backlog is the only work), and
        periodically re-fit the §2.1 boundary.  Returns ``(did_work,
        wake_time)`` so multi-engine callers (ServeCluster) can
        interleave many loops without nesting their drain loops."""
        with trace.span("serve.tick") as sp:
            return self._tick(sp)

    def _tick(self, sp) -> Tuple[bool, Optional[float]]:
        now = self.clock()
        self.ticks += 1
        with trace.span("serve.schedule"):
            self.policy.note_decode_backlog(
                len(self.active_decodes),
                tokens_per_decode=self._tokens_per_decode())
            work, wake = self.policy.next_work(now)
        if work is not None and self.faults is not None and \
                self.faults.dispatch_fails(self.engine_id, self.ticks):
            # §11 injected dispatch exception: the engine never ran, so
            # the work re-enters the queue untouched.  A Batch was popped
            # by next_work — push its requests back (state intact: they
            # are still in _tokens, never dispatched).  A ChunkWork
            # retries for free: skipping on_complete leaves the chunk
            # progress unadvanced, so the same chunk is offered again.
            self.dispatch_faults += 1
            if isinstance(work, Batch) and work.requests:
                for r in work.requests:
                    self.policy.enqueue(r, now)
                self.tracker.note_retried(len(work.requests))
            else:
                self.tracker.note_retried(1)
            sp.set(kind="idle")
            return True, wake
        did = True
        ran = None                       # the policy's work, once run
        if isinstance(work, Batch) and work.requests:
            sp.set(kind="prefill")
            self._run_batch(work)
            ran = work
        elif isinstance(work, ChunkWork):
            sp.set(kind="chunk")
            self._run_chunk(work)
            ran = work
        elif self.active_decodes:
            # the decode backlog fills what would be an idle wait —
            # temporal sharing without a separate decode phase
            sp.set(kind="decode")
            self._run_decode_only()
        else:
            sp.set(kind="idle")
            did = False
        with trace.span("serve.bookkeep"):
            if ran is not None:
                self.policy.on_complete(ran, self.clock())
            if self.engine.spec_dispatches:
                # mirror the engine's speculative totals into the tracker
                # so cluster-merged SLO reports carry acceptance statistics
                self.tracker.note_spec(self.engine.tokens_drafted,
                                       self.engine.tokens_accepted,
                                       self.engine.spec_dispatches,
                                       self.engine.spec_committed)
            self._since_fit += 1
            if self._since_fit >= self.refit_every:
                self._since_fit = 0
                fit = self.engine.fit_boundary()
                if fit is not None and hasattr(self.policy, "dq") and \
                        self.policy.dq.override is None:
                    self.policy.dq.model = None  # fitted threshold wins
                    self.policy.dq.override = fit.boundary()
        return did, wake

    def run_until_idle(self, max_wall: float = 60.0) -> None:
        """Drive the unified tick until every prefill AND every session's
        decode budget is drained.  If ``max_wall`` expires first, the
        still-queued prefills are ABANDONED — drained and recorded in the
        tracker (counter + violation accounting) instead of silently
        left behind as they used to be."""
        start = self.clock()
        while self.has_work and self.clock() - start < max_wall:
            did, wake = self.tick()
            if not did:
                now = self.clock()
                if wake is not None:
                    time.sleep(max(0.0, min(wake - now, 0.01)))
                else:
                    time.sleep(0.0005)
        if self._outstanding > 0:
            self.abandon_pending()

    def abandon_pending(self) -> int:
        """Drop every still-queued prefill, recording each as abandoned
        (§11: a timeout must never LOSE requests untracked).  In-flight
        decode budgets stay — their requests already produced a first
        token and were recorded; a later drive can resume them."""
        n = 0
        for r in self.policy.drain():
            pr = self._tokens.pop(r.rid, None)
            self._outstanding -= 1
            if pr is not None:
                self._dec_pending(r.session,
                                  len(pr.tokens) + pr.decode_tokens)
            self.tracker.note_abandoned(r)
            n += 1
        # parked wait-for-fill requests never reached the policy queue —
        # a timeout must not lose them untracked either
        for ws in self._fill_waiters.values():
            for r, prompt, decode_tokens, _ in ws:
                self._dec_pending(r.session, len(prompt) + decode_tokens)
                self._outstanding -= 1
                self.tracker.note_abandoned(r)
                n += 1
        self._fill_waiters.clear()
        self._active_fills.clear()
        return n

    # --------------------------------------------------------- recovery
    def restore_session(self, session: int, cache_tokens: List[int],
                        pending: Optional[int], generated: List[int],
                        budget: int, sampling=None,
                        first_token: Optional[int] = None) -> None:
        """Rebuild a crashed engine's session on THIS loop by re-prefill
        reconstruction (§11): replay the exact cache token sequence the
        dead arena held, then resume decoding from the recorded pending
        token.  On a paged engine the radix prefix index absorbs any
        indexed prefix, so recovery costs only the uncached suffix (§8).
        Greedy sessions continue bit-identically to a fault-free run:
        the cache contents and the pending input token are both exact.
        The reconstruction dispatches synchronously — bypassing the
        policy queue — so no queued turn can prefill against a
        half-rebuilt cache."""
        now = self.clock()
        arr = np.asarray(cache_tokens, dtype=np.int64)
        self.engine.open_session(session)
        self.engine.set_sampling(session, sampling)
        if len(arr):
            reusable = self.engine.adopt_prefix(session, arr)
            suffix = arr[reusable:]
            if len(suffix):
                # chunked re-prefill through the normal packed path; the
                # recomputed final sample is discarded — the recorded
                # pending token is the ground truth (it was already
                # emitted to the client before the crash)
                self.engine.prefill_long(session, suffix)
        self._cache_tokens[session] = list(cache_tokens)
        if generated:
            self.generated[session] = list(generated)
        if first_token is not None:
            self.first_tokens[session] = first_token
        if pending is not None:
            self.last_token[session] = pending
            self._cache_pending[session] = pending
        self._last_emit[session] = now
        if budget > 0 and pending is not None:
            self.active_decodes[session] = budget
        self.tracker.note_recovered()

    def decode(self, session: int, steps: int) -> List[int]:
        """Manual greedy continuation (legacy API).  Keeps the loop's
        per-session bookkeeping coherent: ``last_token`` / ``generated``
        advance with the engine cache, so a later unified tick fuses the
        session from the RIGHT token (not a stale one)."""
        first = self.last_token.get(session,
                                    self.first_tokens.get(session, 0))
        out = self.engine.decode_batch([session], [first], steps)
        toks = out[session]
        if session in self.last_token or session in self.generated:
            now = self.clock()
            self.generated.setdefault(session, []).extend(toks)
            self.last_token[session] = toks[-1]
            self._last_emit[session] = now
            pend = self._cache_pending.get(session)
            if pend is not None and toks:
                self._cache_tokens.setdefault(session, []).extend(
                    [pend] + toks[:-1])
                self._cache_pending[session] = toks[-1]
        return [first] + toks
