"""Single-instance serving engine of the port, from
``repro.serving.engine``.

Composes a KV arena — the paged pool (radix prefix reuse, COW forks;
the default) or the slot arena (``paged_kv=False``, the measurement
baseline) — with the step executors under the paper's primitives:

  * prefills, long-prefill chunks and decode rows fused into one packed
    flat stream per tick (``step_mixed``): over the page pool with
    prefix-matched pages adopted before the bucket is chosen, over the
    slot arena in place (``arena_prefill``), or over whole slots
    gathered and scattered back (``arena_prefill=False``);
  * the dense (L, B) grid (``prefill_batch`` with a pinned bucket,
    ``packed=False``, and slot-arena ticks that fall off the token
    ladder), whose gathered slots the plain dense forward writes;
  * long prefills advanced in C_l chunks, with chunk-level prefix
    matching on the page pool (``prefill_long``);
  * decode-only ticks through the bucketed decode step (slot arena or
    page pool), or the dense (B, 1) step when the ladder overflows or
    ``arena_decode`` is off;
  * speculative decoding (``enable_spec``): decode sessions advance
    through length-(k+1) ``verify`` segments ``[pending, d_1..d_k]`` on
    the same packed stream, the accepted prefix plus one corrective or
    bonus token committed per dispatch, the rejected tail rolled back
    with ``arena.truncate``;
  * runtime (T, L, H) samples feeding ``core.boundary.fit_total``.

Every executor step is a replay of its shape's CUDA graph
(``serving/graphs.py``): the engine hands the executors host int32
arrays and copies what it keeps of a step's outputs, which the next
replay overwrites.

Attention stacks (full or sliding-window, dense or MoE FFNs), pure SSM
(mamba2) stacks and hybrid (jamba) stacks that interleave both are
served.  A stack with SSM layers keeps one recurrent-state slot per
session — a slot of the slot arena plus a scratch slot that every pad
row and pad segment targets, or a state page of the pool with
boundary-state checkpoints on the radix index, beside the session's KV
pages or slot rows where it also has attention layers — and every
sequence-mode SSM layer runs the ``ssd_scan`` kernel.  A sliding-window stack keeps its
window in rolling slots of depth window + C_l on the packed slot arena
(a scratch slot for pads; a segment longer than C_l is split, so one
step's writes never wrap onto a key still in a query's window), in ring
page tables of ceil((window + C_l) / page_size) pages on the pool (the
radix index off, forks refused), and in full-depth slots with the
window masked in the dense baseline, which has no decode executor.  The
scratch-slot stacks' packed steps reserve one stream row for the pad
segment; speculation stays off for them (no rollback of recurrent state
or of a rolling slot).

Sampling is greedy argmax on the device, the fused sampling kernel
(``fused_sampling=True`` with ``keep_last_logits=False``: bias,
temperature, top-k / top-p and the draw on the device, host-drawn
uniforms in, (R,) ids out), or the numpy sampler on the host.

Sessions hand off between engines (``export_session`` /
``import_session``, driven by ``serving.cluster.ServeCluster``): slot
rows or page rows cross as device tensors, written into the
destination's arena in place, and ``handoff_host_bytes`` counts any KV
byte that would have crossed through the host (0 by construction).  A
crashed engine is ``mark_dead``-ed and refuses every dispatch.  Not
ported: the host spill tier (``host_pool_bytes > 0``, ROADMAP item 11),
which raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import boundary as boundary_mod
from repro_torch.core.buckets import (DEFAULT_DECODE_BUCKETS,
                                      DEFAULT_TOKEN_BUCKETS, BucketGrid)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.serving import packing
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.executor import (BucketExecutor,
                                          DecodeBucketExecutor,
                                          PackedBucketExecutor)
from repro_torch.serving.kvcache import KVArena, PagedKVArena
from repro_torch.serving.sampling import SamplingParams


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A host copy of a step output: the outputs are a step graph's
    static buffers, which its next replay overwrites (on the CPU a bare
    ``.numpy()`` would alias them)."""
    return t.to("cpu", dtype or t.dtype, copy=True).numpy()


@dataclasses.dataclass
class MixedStepResult:
    """Outcome of one continuous-batching tick (engine.step_mixed)."""
    tokens: Dict[int, int]        # session → sampled next token
    fused: bool                   # True = ONE packed dispatch served all
    bucket: Optional[int] = None  # token bucket used (fused path)
    n_prefill: int = 0            # prefill + chunk segments
    n_decode: int = 0             # fused decode segments
    # speculative ticks commit SEVERAL tokens per decode session in one
    # dispatch; ``committed[s]`` is the full emitted list (``tokens[s]``
    # stays the LAST of them for non-spec callers)
    committed: Optional[Dict[int, List[int]]] = None


@dataclasses.dataclass
class SessionExport:
    """Device-resident snapshot of one session's cached context for
    arena-to-arena KV handoff.

    ``kv`` stays on the device end to end: slot arenas export per-leaf
    ``(G, length, Hkv, D)`` clones, paged arenas ``(G, n_pages,
    page_size, Hkv, D)`` page gathers.  ``Engine.import_session`` counts
    the bytes of any leaf that is not a device tensor of its own device
    type into ``handoff_host_bytes`` — the proof counter benches assert
    == 0."""

    length: int
    kv: Any
    paged: bool
    token_ids: Optional[List[int]] = None   # paged: committed ids
    sampling: Optional[SamplingParams] = None
    rng: Optional[np.random.Generator] = None
    last_logits: Optional[np.ndarray] = None


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 16
    max_len: int = 256
    chunk_tokens: int = 64           # C_l
    grid_lengths: Tuple[int, ...] = (8, 16, 32, 64)
    grid_depths: Tuple[int, ...] = (1, 2, 4, 8)
    pad_token: int = 0
    measure: bool = True             # collect boundary-fit samples
    # padding-free packed serving is the default; packed=False is the
    # explicitly requested dense (L, B) measurement baseline
    packed: bool = True
    token_buckets: Tuple[int, ...] = DEFAULT_TOKEN_BUCKETS
    packed_max_seqs: Optional[int] = None  # None → min(num_slots, 16)
    arena_decode: bool = True        # in-place bucketed decode
    decode_buckets: Tuple[int, ...] = DEFAULT_DECODE_BUCKETS
    arena_prefill: bool = True       # in-place packed prefill
    # keep a host copy of every step's last logits row per session
    # (parity harnesses, sampling introspection).  False lets all-greedy
    # steps take their token from the on-device argmax and skip the
    # full-vocab logits transfer
    keep_last_logits: bool = True
    # paged KV arena: a shared page pool + per-session page tables with
    # radix-tree prefix reuse and COW forks.  Requires the packed + arena
    # paths; False keeps the slot arena as the measurement baseline
    paged_kv: bool = True
    page_size: int = 16
    num_pages: Optional[int] = None  # None → num_slots·max_len/page_size
    prefix_cache: bool = True        # radix prefix index on/off
    host_pool_bytes: int = 0         # host spill tier: not ported yet
    # route sampled rows through the fused sampling kernel (bias +
    # temperature + top-k/top-p + the inverse-CDF draw on the device,
    # host uniforms shipped in): only the (R,) ids cross to host.  Takes
    # effect with keep_last_logits=False; a session with more than
    # kernels.sampling.MAX_BIAS bias entries keeps its step on the host
    fused_sampling: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, params,
                 ecfg: Optional[EngineConfig] = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg or EngineConfig()
        self.device = tr.resolve_device(device)
        self.capability = cap = tr.arena_capability(cfg)
        # rolling mode: a sliding-window config serves from window-deep
        # rolling slots (depth = window + margin) when both in-place
        # paths run — a rolling slot cannot be gathered into the dense
        # (L, B) step, whose writes are absolute.  Otherwise its slots
        # are full depth and the dense path masks the window
        self._rolling = bool(
            cap.packed_ok and cap.has_window and self.ecfg.packed
            and self.ecfg.arena_prefill and self.ecfg.arena_decode)
        # the no-alias margin: the most new rows one segment may write
        # into a rolling slot or ring in one step.  C_l bounds it —
        # step_mixed splits a longer segment on a rolling arena
        self._seg_margin = self.ecfg.chunk_tokens
        swa_depth: Optional[int] = None
        if cap.has_window:
            swa_depth = (min(self.ecfg.max_len, cap.window + self._seg_margin)
                         if self._rolling else self.ecfg.max_len)
        # rolling KV slots and SSM state have no spare park row: pads
        # target a dedicated scratch slot instead of aliasing a live one
        scratch = bool(cap.packed_ok and cap.needs_scratch_slot
                       and (self.ecfg.packed or self.ecfg.arena_decode))
        self._paged = bool(self.ecfg.paged_kv)
        if self._paged:
            if not cap.packed_ok:
                raise ValueError(
                    f"{cfg.name}: paged_kv needs a causal decoder stack "
                    "(encoder-only models have no serving cache) — set "
                    "paged_kv=False for the dense baseline")
            if not (self.ecfg.packed and self.ecfg.arena_prefill
                    and self.ecfg.arena_decode):
                raise ValueError(
                    "paged_kv requires the packed + arena execution paths "
                    "(packed=True, arena_prefill=True, arena_decode=True): "
                    "a paged pool has no dense gather fallback — set "
                    "paged_kv=False to pin the slot/dense baseline")
            num_pages = self.ecfg.num_pages or (
                self.ecfg.num_slots * self.ecfg.max_len
                // self.ecfg.page_size)
            # a sliding-window config gets RING tables: the rolling
            # arena at page granularity, ceil((window + margin) / ps)
            # pages a session
            ring_pages = None
            if cap.has_window:
                depth = min(self.ecfg.max_len, cap.window + self._seg_margin)
                ring_pages = -(-depth // self.ecfg.page_size)
            self.arena = PagedKVArena(
                cfg, num_pages, self.ecfg.page_size, self.ecfg.max_len,
                prefix_cache=self.ecfg.prefix_cache, ring_pages=ring_pages,
                state_slots=cap.has_ssm,
                host_pool_bytes=self.ecfg.host_pool_bytes,
                device=self.device)
        else:
            # gathered steps read one static batch buffer: as deep as the
            # deepest grid rung or the most sessions a step gathers
            self.arena = KVArena(cfg, self.ecfg.num_slots,
                                 self.ecfg.max_len, swa_depth=swa_depth,
                                 scratch_slot=scratch, device=self.device,
                                 batch_rows=max(self.ecfg.num_slots,
                                                *self.ecfg.grid_depths))
        # dense gather/scatter is a valid fallback on the slot arena
        # except in rolling mode (absolute-position writes do not fit a
        # rolling slot); a paged pool has no whole-sequence row to
        # gather.  There oversized work is split across packed steps
        self._dense_ok = not (self._rolling or self._paged)
        # every step graph of the engine draws on one memory pool
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        self.executor = BucketExecutor(cfg, graph_pool=pool)
        self.packed_executor: Optional[PackedBucketExecutor] = None
        # the gathered packed form is attention-only (an SSM state has no
        # gathered equivalent): without arena_prefill an SSM stack runs
        # the dense grid
        if self.ecfg.packed and cap.packed_ok and (
                cap.pure_attn or self.ecfg.arena_prefill):
            max_seqs = self.ecfg.packed_max_seqs or min(self.ecfg.num_slots,
                                                        16)
            self.packed_executor = PackedBucketExecutor(
                cfg, token_buckets=self.ecfg.token_buckets,
                max_seqs=min(max_seqs, self.ecfg.num_slots),
                graph_pool=pool)
        # a windowed config that is not rolling (the dense baseline's
        # full-depth slots) decodes through the dense step
        self.decode_executor: Optional[DecodeBucketExecutor] = None
        if self.ecfg.arena_decode and cap.packed_ok and not (
                cap.has_window and not self._rolling):
            self.decode_executor = DecodeBucketExecutor(
                cfg, decode_buckets=self.ecfg.decode_buckets,
                max_seqs=self.ecfg.num_slots, graph_pool=pool)
        self.grid = BucketGrid(self.ecfg.grid_lengths, self.ecfg.grid_depths,
                               mem_budget_tokens=self.ecfg.num_slots
                               * self.ecfg.max_len)
        self.samples: List[Tuple[float, float, float]] = []  # (T, L, H)
        self.fitted: Optional[boundary_mod.TotalFit] = None
        # last-step logits per session (parity harness + sampling hooks)
        self.last_logits: Dict[int, np.ndarray] = {}
        # per-session sampling options (greedy argmax when absent)
        self.sampling: Dict[int, SamplingParams] = {}
        self._rngs: Dict[int, np.random.Generator] = {}
        # dense-dispatch accounting by (kind, cause): "requested" = the
        # config asked for the dense baseline (packed off, a pinned
        # (L, B) bucket, arena decode off); "forced" = the packed path
        # exists but this step fell off it (off-ladder total, over-depth
        # batch, ladder overflow)
        self.dense_causes: Dict[Tuple[str, str], int] = {}
        # steps that took tokens from the on-device argmax without
        # shipping full-vocab logits to host
        self.fused_greedy_steps = 0
        self.logits_rows_shipped = 0
        # non-greedy steps served by the fused sampling kernel (no
        # full-vocab logits transfer)
        self.fused_sample_steps = 0
        # speculative decoding: a draft proposer attached via enable_spec
        # turns decode segments into length-(k+1) "verify" segments on
        # the same packed stream; the counters prove the multi-token
        # commits
        self.draft: Optional[Any] = None     # serving.draft.DraftProposer
        self.spec_k = 0
        self.tokens_drafted = 0
        self.tokens_accepted = 0
        self.spec_dispatches = 0
        self.spec_committed = 0
        self._spec_by_session: Dict[int, List[int]] = {}  # [drafted, acc.]
        # arena-to-arena handoff proof counters: sessions imported from a
        # peer engine, tokens of KV that crossed, and the bytes of any
        # host array among the crossing leaves (stays 0: the copy is
        # device to device)
        self.handoff_sessions = 0
        self.handoff_tokens = 0
        self.handoff_host_bytes = 0
        # failure model: a crashed engine is never dispatched to again —
        # the cluster marks it dead after evacuation and every compute
        # entry point refuses (host-side bookkeeping like history() and
        # sampling stays readable)
        self.dead = False

    def mark_dead(self) -> None:
        self.dead = True

    def _check_alive(self) -> None:
        if self.dead:
            raise RuntimeError("engine is dead: dispatch refused")

    @property
    def executors(self) -> List[Any]:
        """The engine's step executors (each holds its step graphs)."""
        return [ex for ex in (self.executor, self.packed_executor,
                              self.decode_executor) if ex is not None]

    def graph_stats(self) -> Dict[str, Any]:
        """Step graphs captured, their warm-up plus capture seconds and
        replays, over the engine's executors."""
        exs = self.executors
        return {"graphs": sum(len(ex.graphs) for ex in exs),
                "capture_seconds": sum(ex.capture_cost() for ex in exs),
                "replays": sum(ex.replays for ex in exs)}

    # ------------------------------------------------------------ session
    def open_session(self, session: int) -> None:
        if self._paged:
            self.arena.open(session)
        else:
            self.arena.alloc(session)

    def close_session(self, session: int) -> None:
        self.arena.free(session)
        self.last_logits.pop(session, None)
        self.sampling.pop(session, None)
        self._rngs.pop(session, None)
        if self.draft is not None:
            self.draft.forget(session)

    def history(self, session: int) -> int:
        return self.arena.length(session)

    def probe_prefix(self, tokens: Sequence[int]) -> int:
        """Tokens of ``tokens`` a FRESH session would inherit from the
        radix prefix index instead of prefilling (0 on slot arenas or
        with the prefix cache off)."""
        if not self._paged:
            return 0
        return int(self.arena.probe_prefix(tokens))

    def adopt_prefix(self, session: int, tokens: Sequence[int]) -> int:
        """Map the longest indexed prefix of ``tokens`` onto existing
        pages for fresh session ``session`` NOW, returning the adopted
        token count; the pages stay refcount-pinned while the request
        waits.  0 on slot arenas or with the prefix cache off."""
        if not self._paged or self.arena.length(session) != 0:
            return 0
        return self.arena.match_prefix(session, tokens)

    def fork_session(self, parent: int, child: int) -> None:
        """COW-fork ``parent``'s cached context into fresh session
        ``child``: both share every page until one writes into the
        partial boundary page, which then copies on demand.  Paged
        arenas only."""
        assert self._paged, "fork_session requires paged_kv=True"
        self.arena.fork(parent, child)

    # ------------------------------------------------------------ handoff
    @property
    def can_handoff(self) -> bool:
        """Arena-to-arena session handoff is defined for pure-attention,
        non-rolling layouts: every cache leaf is a k/v tensor with the
        sequence on one contiguous axis.  Rolling window slots write
        modularly and SSM state is not a token sequence."""
        return self.capability.pure_attn and not self._rolling

    def export_session(self, session: int) -> SessionExport:
        """Handoff source: snapshot the session's cached KV as device
        tensors — slot rows cloned or page rows gathered, never copied
        through the host — plus the sampling state a decode on the
        destination needs (params, the replayable rng, last logits).
        The source keeps the session; the cluster closes it after a
        successful import."""
        self._check_alive()
        assert self.can_handoff, \
            "KV handoff requires a pure-attention, non-rolling arena"
        h = self.history(session)
        if self._paged:
            kv = self.arena.export_pages(session)
            ids = list(self.arena._tokens.get(session, []))
        else:
            kv = self.arena.export_slot(session)
            ids = None
        return SessionExport(length=h, kv=kv, paged=self._paged,
                             token_ids=ids,
                             sampling=self.sampling.get(session),
                             rng=self._rngs.get(session),
                             last_logits=self.last_logits.get(session))

    def _host_bytes(self, kv) -> int:
        """Bytes of the KV leaves that are not tensors on this engine's
        device type (a host array, or a CPU tensor into a CUDA arena)."""
        n = 0
        for leaves in kv:
            for leaf in leaves.values():
                if not isinstance(leaf, torch.Tensor):
                    n += int(getattr(leaf, "nbytes", 0))
                elif leaf.device.type != self.device.type:
                    n += leaf.numel() * leaf.element_size()
        return n

    def import_session(self, session: int, payload: SessionExport) -> None:
        """Handoff destination: write the exported KV into this arena
        (a fresh slot or fresh pages) in place, device to device, and
        restore the sampling state.  On a page pool the destination's
        radix index is probed first: prefix pages it already holds are
        adopted and only the suffix is copied."""
        self._check_alive()
        assert self.can_handoff, \
            "KV handoff requires a pure-attention, non-rolling arena"
        assert payload.paged == self._paged, \
            "handoff between arena families (slot vs paged) not supported"
        assert self.history(session) == 0, \
            f"import into non-empty session {session}"
        if payload.kv is not None:
            self.handoff_host_bytes += self._host_bytes(payload.kv)
        if self._paged:
            toks = payload.token_ids or []
            if toks and self.ecfg.prefix_cache:
                self.arena.match_prefix(session, toks)
            self.arena.import_session(session, toks, payload.kv,
                                      payload.length)
        else:
            if session in self.arena._session_slot:
                self.arena.free(session)
            self.arena.import_slot(session, payload.kv, payload.length)
        if payload.sampling is not None:
            self.sampling[session] = payload.sampling
            if payload.rng is not None:
                self._rngs[session] = payload.rng
        if payload.last_logits is not None:
            self.last_logits[session] = payload.last_logits
        self.handoff_sessions += 1
        self.handoff_tokens += payload.length

    # ------------------------------------------------ speculative decode
    @property
    def can_spec(self) -> bool:
        """Speculative verify/rollback is defined where ``arena.truncate``
        is: pure-attention, non-rolling layouts.  An SSM stack has no
        rollback of its recurrent state and a rolling slot or ring has
        already overwritten the rows a rejected tail wrote over, so
        speculation stays off there."""
        return self.capability.pure_attn and not self._rolling

    def enable_spec(self, draft: Any, k: int = 4) -> None:
        """Attach a draft proposer (``serving.draft``): decode sessions
        now advance through length-(k+1) ``verify`` segments on the
        packed mixed stream — up to k accepted drafts plus one
        corrective/bonus token per dispatch, rejected tails rolled back
        via ``arena.truncate``.  Greedy sessions stay identical to plain
        decode; sampled sessions commit by rejection sampling, which
        preserves the target distribution."""
        assert self.can_spec, \
            "speculative decoding needs a pure-attention, non-rolling arena"
        assert self.packed_executor is not None and self.ecfg.arena_prefill, \
            "speculative decoding rides the packed arena stream"
        assert k >= 1, k
        self.draft = draft
        self.spec_k = int(k)

    def disable_spec(self) -> None:
        self.draft = None
        self.spec_k = 0

    def _spec_ready(self) -> bool:
        return (self.draft is not None and self.spec_k > 0
                and self.packed_executor is not None
                and self.ecfg.arena_prefill and self.can_spec)

    @property
    def spec_enabled(self) -> bool:
        """True when decode ticks will run speculative verify segments —
        the serve loop reads this to size its stream-token reservations
        (1 + k per fused session instead of 1)."""
        return self._spec_ready()

    def _plan_spec(self, decodes: Sequence[Tuple[int, int]],
                   max_new: Optional[Dict[int, int]]
                   ) -> Dict[int, List[int]]:
        """Ask the draft for up to k tokens per eligible decode session.
        A session sits the tick out (plain 1-token decode segment) when
        its k+1 verify rows would overflow the arena, its remaining
        token budget cannot cover even one accepted draft, or the
        proposer has nothing to say."""
        spec: Dict[int, List[int]] = {}
        lim = self.ecfg.max_len - 2
        for s, tok in decodes:
            h = self.arena.length(s)
            budget = self.spec_k + 1
            if max_new is not None:
                budget = min(budget, int(max_new.get(s, budget)))
            if h <= 0 or budget < 2 or h + self.spec_k + 1 > lim:
                continue
            d = self.draft.propose(s, int(tok), self.spec_k)
            d = [int(x) for x in list(d)[:min(self.spec_k, budget - 1)]]
            if d:
                spec[s] = d
        return spec

    def spec_step(self, decodes: Sequence[Tuple[int, int]],
                  max_new: Optional[Dict[int, int]] = None
                  ) -> Dict[int, List[int]]:
        """One speculative decode tick: every eligible session's
        ``[pending, draft_1..draft_k]`` verify segment fused into ONE
        packed dispatch, 1..k+1 tokens committed each.  ``max_new``
        caps a session's emitted tokens.  Returns {session: emitted
        tokens}."""
        res = self.step_mixed([], decodes, max_new=max_new)
        if res.committed is not None:
            return res.committed
        return {s: [res.tokens[s]] for s, _ in decodes}

    def _spec_draws(self, session: int, m: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(u_acc, u_samp) uniforms for one verify walk, drawn as
        interleaved pairs j = 0..m from the session's replayable rng —
        row j's accept test is ``u_acc[j] < p_j(draft)``, its reject
        resample (or the row-m bonus draw) consumes ``u_samp[j]``.  The
        2(m+1) draws happen up front whatever prefix is accepted, so the
        per-step rng consumption is deterministic.  Greedy sessions draw
        nothing (accept = exact id match)."""
        rng = self._rngs.get(session)
        if rng is None:
            return np.zeros(m + 1), np.zeros(m + 1)
        u = np.asarray([rng.random() for _ in range(2 * (m + 1))])
        return u[0::2], u[1::2]

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
            return _host(ids_dev[:n]).astype(np.int64), None
        if (self.ecfg.fused_sampling and not self.ecfg.keep_last_logits
                and self._fused_bias_ok(sessions)):
            return self._fused_sample_rows(sessions, logits_dev), None
        logits_np = _host(logits_dev, torch.float32)
        self.logits_rows_shipped += int(logits_np.shape[0])
        return self._sample_rows(sessions, logits_np[:n]), logits_np

    def _fused_bias_ok(self, sessions: Sequence[int]) -> bool:
        """The fused sampling kernel carries MAX_BIAS bias slots per row;
        a step with a heavier-biased session keeps the host path."""
        return all(len(self.sampling[s].logit_bias or ())
                   <= kernel_ops.MAX_BIAS
                   for s in sessions if s in self.sampling)

    def _sampling_rows(self, r: int):
        """Empty per-row kernel inputs for ``r`` rows: greedy, top-k and
        top-p off, no bias, no draft."""
        return (np.zeros(r, np.float32), np.zeros(r, np.int32),
                np.ones(r, np.float32), np.zeros(r, np.float32),
                np.full(r, -1, np.int32),
                np.full((r, kernel_ops.MAX_BIAS), -1, np.int32),
                np.zeros((r, kernel_ops.MAX_BIAS), np.float32))

    def _fill_params(self, rows, i: int, sp: SamplingParams) -> None:
        """Write session options ``sp`` into row ``i`` of the kernel
        inputs ``rows``."""
        temp, topk, topp, _, _, bias_ids, bias_vals = rows
        temp[i] = max(float(sp.temperature), 0.0)
        topk[i] = int(sp.top_k or 0)
        topp[i] = float(sp.top_p) if sp.top_p is not None else 1.0
        for j, (t, v) in enumerate(sp.logit_bias or ()):
            bias_ids[i, j] = int(t)
            bias_vals[i, j] = float(v)

    def _fused_sample_rows(self, sessions: Sequence[int],
                           logits_dev: torch.Tensor) -> np.ndarray:
        """Sample one token per live row through the fused kernel: bias,
        temperature, top-k/top-p and the inverse-CDF draw all happen on
        the device; host-drawn uniforms go in, (R,) ids come out, and the
        full-vocab logits never cross.  Consumes ONE uniform per
        non-greedy row (cast to float32) — the host sampler's rng
        protocol, so a session can hop between paths mid-stream."""
        r = int(logits_dev.shape[0])
        rows = self._sampling_rows(r)
        temp, topk, topp, u, draft, bias_ids, bias_vals = rows
        for i, s in enumerate(sessions):
            sp = self.sampling.get(s)
            if sp is None:
                continue
            self._fill_params(rows, i, sp)
            if not sp.is_greedy:
                u[i] = float(self._rngs[s].random())
        tok, _, _ = kernel_ops.fused_sample(logits_dev, temp, topk, topp,
                                            bias_ids, bias_vals, u, draft)
        self.fused_sample_steps += 1
        return tok.cpu().numpy()[:len(sessions)].astype(np.int64)

    def _note_dense(self, kind: str, cause: str) -> None:
        key = (kind, cause)
        self.dense_causes[key] = self.dense_causes.get(key, 0) + 1

    # ------------------------------------------------- bucketized prefill
    def prefill_batch(self, sessions: Sequence[int],
                      token_lists: Sequence[np.ndarray],
                      bucket: Optional[Tuple[int, int]] = None
                      ) -> Dict[int, int]:
        """Short-prefill / re-prefill batch.

        With a packed executor and no pinned (L, B) ``bucket``, the
        batch rides the packed token-bucket stream via
        :meth:`step_mixed` (which itself falls back to the dense path
        for off-ladder totals or over-depth batches on a slot arena).
        An explicit ``bucket`` pins the dense (L, B) grid path; it has
        no meaning on a paged pool or a rolling arena (no dense gather
        path exists), where the batch rides the packed stream instead.
        Returns {session: first_sampled_token}."""
        self._check_alive()
        if self.packed_executor is not None and (
                bucket is None or not self._dense_ok):
            return self.step_mixed(list(zip(sessions, token_lists)),
                                   []).tokens
        cause = "requested" if (bucket is not None
                                or self.packed_executor is None) else "forced"
        return self._prefill_batch_dense(sessions, token_lists, bucket,
                                         cause=cause)

    def _prefill_batch_dense(self, sessions: Sequence[int],
                             token_lists: Sequence[np.ndarray],
                             bucket: Optional[Tuple[int, int]] = None,
                             cause: str = "requested") -> Dict[int, int]:
        """Dense (L, B) grid prefill: pads to ``bucket`` when given (the
        grid path), else to the longest prompt; gathers whole arena
        slots and scatters them back.  ``cause`` records whether the
        config requested it or the packed path forced it (``stats()``)."""
        assert self._dense_ok, \
            "a paged pool or a rolling arena has no dense gather path"
        assert len(sessions) == len(token_lists)
        self._note_dense("prefill", cause)
        n = len(sessions)
        lens = [len(t) for t in token_lists]
        if bucket is not None:
            pad_l, pad_b = bucket
            assert pad_l >= max(lens) and pad_b >= n, (bucket, lens, n)
        else:
            pad_l, pad_b = max(lens), n

        slots, hists = [], []
        for s, l in zip(sessions, lens):
            slots.append(self.arena.alloc(s))
            hists.append(self.arena.length(s))
            self.arena.check_length(s, hists[-1] + l)
        # depth padding reuses slot 0's cache row for dummy rows
        all_slots = slots + [slots[0]] * (pad_b - n)

        tokens = np.full((pad_b, pad_l), self.ecfg.pad_token, np.int32)
        positions = np.zeros((pad_b, pad_l), np.int32)
        sample_idx = np.zeros((pad_b,), np.int32)
        park = self.arena.max_len - 1
        for i, (tl, h) in enumerate(zip(token_lists, hists)):
            tokens[i, :len(tl)] = tl
            pos = h + np.arange(pad_l)
            pos[len(tl):] = park                    # junk KV → park row
            positions[i] = pos
            sample_idx[i] = len(tl) - 1
        positions[n:] = park                        # dummy depth rows

        caches = self.arena.batch(pad_b)
        t0 = time.perf_counter()
        last_np = _host(self.executor.prefill(
            self.params, tokens, positions, caches, sample_idx,
            fill=lambda: self.arena.gather(all_slots)),
            torch.float32)
        toks = self._sample_rows(sessions, last_np)
        elapsed = time.perf_counter() - t0
        self.executor.note_padding(sum(lens), pad_l * pad_b)
        # write back only the real rows
        self.arena.scatter(slots, [{k: a[:, :n] for k, a in c.items()}
                                   for c in caches])
        out: Dict[int, int] = {}
        for i, s in enumerate(sessions):
            self.arena.set_length(s, hists[i] + lens[i])
            out[s] = int(toks[i])
            self.last_logits[s] = last_np[i]
        if self.ecfg.measure and n:
            per = elapsed / n
            for l, h in zip(lens, hists):
                self.samples.append((per, float(l), float(h)))
        return out

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
        token each, or with a draft attached up to k + 1 through a verify
        segment; ``max_new`` caps a session's speculative commit.

        A mix without a packed executor, that overflows ``max_seqs`` or
        whose total is off the ladder runs the dense path on a slot
        arena (a prefill batch then a decode batch: up to two
        dispatches) and is SPLIT across packed steps on a paged pool.
        Returns a :class:`MixedStepResult`."""
        prefills, decodes = list(prefills), list(decodes)
        self._check_alive()
        n_p, n_d = len(prefills), len(decodes)
        assert n_p + n_d > 0, "empty mixed step"
        sess_all = [s for s, _ in prefills] + [s for s, _ in decodes]
        assert len(set(sess_all)) == len(sess_all), \
            f"session appears twice in one step: {sess_all}"
        if self._paged:
            # radix prefix adoption: a FRESH session's prompt maps its
            # longest indexed prefix onto existing pages BEFORE the
            # bucket is chosen, so the step only prefills (and the
            # ladder only prices) the new suffix
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
        # speculative planning: with a draft attached, each eligible
        # decode session's segment grows from 1 token to 1 + k (pending
        # + drafts) — the ladder prices the true verify stream
        spec: Dict[int, List[int]] = {}
        if decodes and self._spec_ready():
            spec = self._plan_spec(decodes, max_new)
        spec_len = 1 + self.spec_k
        total = sum(lens) + sum(spec_len if s in spec else 1
                                for s, _ in decodes)
        px = self.packed_executor
        bucket = None
        # a rolling slot adds the no-alias rule: no segment may write
        # more than the margin in one step (a pinned token_bucket must
        # not bypass it); longer segments take the split path
        fits = px is not None and n_p + n_d <= px.max_seqs
        if fits and self._rolling and lens and max(lens) > self._seg_margin:
            fits = False
        if fits:
            bucket = token_bucket or px.bucket_for(total)
            if bucket is not None and bucket < total:
                bucket = None
        if bucket is None and spec:
            # speculative lengths pushed the tick off the ladder — this
            # dispatch drops back to plain 1-token decode segments
            spec = {}
            total = sum(lens) + n_d
            if fits:
                bucket = token_bucket or px.bucket_for(total)
                if bucket is not None and bucket < total:
                    bucket = None
        if bucket is None:
            if not self._dense_ok:
                return self._step_split(prefills, decodes)
            out: Dict[int, int] = {}
            if prefills:
                out.update(self._prefill_batch_dense(
                    [s for s, _ in prefills], [t for _, t in prefills],
                    cause="forced" if px is not None else "requested"))
            if decodes:
                dec = self.decode_batch([s for s, _ in decodes],
                                        [t for _, t in decodes])
                out.update({s: toks[0] for s, toks in dec.items()})
            return MixedStepResult(tokens=out, fused=False,
                                   n_prefill=n_p, n_decode=n_d)

        segments: List[packing.SegmentSpec] = []
        for s, toks in prefills:
            # arena.length is 0 for a session without a slot yet; the
            # slot itself is claimed once, inside _run_packed
            segments.append(packing.SegmentSpec(
                s, np.asarray(toks, np.int32), self.arena.length(s),
                kind="prefill"))
        for s, tok in decodes:
            if self._paged:
                assert self.arena.length(s) > 0, \
                    f"decode session {s} has no cached context"
            else:
                assert self.arena.slot_of(s) is not None, \
                    f"decode session {s} has no cache slot"
            if s in spec:
                # uniform verify length 1 + k (short proposals pad with
                # pad_token rows — KV written past the commit is rolled
                # back anyway) so every spec dispatch shares one shape
                d = spec[s]
                toks = np.asarray(
                    [tok] + d + [self.ecfg.pad_token]
                    * (self.spec_k - len(d)), np.int32)
                segments.append(packing.SegmentSpec(
                    s, toks, self.arena.length(s), kind="verify"))
            else:
                segments.append(packing.SegmentSpec(
                    s, np.asarray([tok], np.int32), self.arena.length(s),
                    kind="decode"))
        if spec:
            return self._run_spec(segments, bucket,
                                  {s: len(d) for s, d in spec.items()})
        if self._paged:
            return self._run_packed_paged(segments, bucket)
        return self._run_packed(segments, bucket)

    def _step_split(self, prefills: Sequence[Tuple[int, np.ndarray]],
                    decodes: Sequence[Tuple[int, int]]) -> MixedStepResult:
        """Serve an off-ladder / over-depth mix on a paged pool or a
        rolling arena, which have no dense path: prefills advance in
        C_l-sized packed chunks (which also keeps a rolling slot's
        no-alias margin) and the decode backlog drains in ladder-top
        groups."""
        px = self.packed_executor
        c = min(self._seg_margin, px.ladder.max_tokens)
        out: Dict[int, int] = {}
        for s, toks in prefills:
            toks = np.asarray(toks)
            for start in range(0, len(toks), c):
                res = self.step_mixed([(s, toks[start:start + c])], [])
                out[s] = res.tokens[s]
        if decodes:
            dx = self.decode_executor
            m = dx.ladder.max_seqs if dx is not None else 1
            decodes = list(decodes)
            for i in range(0, len(decodes), m):
                grp = decodes[i:i + m]
                dec = self.decode_batch([s for s, _ in grp],
                                        [t for _, t in grp])
                out.update({s: v[0] for s, v in dec.items()})
        return MixedStepResult(tokens=out, fused=False,
                               n_prefill=len(prefills),
                               n_decode=len(decodes))

    def _observe(self, seg: packing.SegmentSpec) -> None:
        """Keep the draft's view of the cached stream in sync: a decode
        segment cached its one input token, a prefill or chunk segment
        seeds the draft's history with its prompt tokens."""
        if self.draft is None:
            return
        if seg.kind == "decode":
            self.draft.observe(seg.session, [int(seg.tokens[0])])
        else:
            self.draft.observe(seg.session, [int(t) for t in seg.tokens],
                               prompt=True)

    def _record_packed(self, segments: List[packing.SegmentSpec],
                       toks: np.ndarray, last_np: Optional[np.ndarray],
                       elapsed: float) -> Dict[int, int]:
        """Per-segment bookkeeping after a packed step: the sampled
        token, the kept logits row and the boundary-fit samples."""
        out: Dict[int, int] = {}
        for i, seg in enumerate(segments):
            self._observe(seg)
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
        return out

    def _slot_map(self, segments: List[packing.SegmentSpec]
                  ) -> Tuple[List[int], np.ndarray]:
        """Claim (or find) each segment's slot and check its write fits:
        (slots, slot map over every stream row).  Dummy segments and tail
        rows reuse the first segment's slot, confined to its park row
        S_max − 1 by their positions — or, on an SSM or rolling arena
        (state has no park position, a rolling slot no spare row), target
        the scratch slot."""
        slots = [self.arena.alloc(seg.session) for seg in segments]
        for seg in segments:
            self.arena.check_length(seg.session, seg.history + seg.length)
        pad = self.packed_executor.stream_rows - len(slots)
        pad_slot = (self.arena.scratch if self.arena.scratch is not None
                    else slots[0])
        return slots, np.asarray(slots + [pad_slot] * pad, np.int32)

    def _page_tables(self, segments: List[packing.SegmentSpec],
                     stream: packing.MixedStream, bucket: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """``prepare_extend`` every segment's write range (COW-copying a
        fork-shared boundary page, allocating tail pages): (page table
        (b_max, P_max), token pages (bucket,), token offsets (bucket,),
        state map (b_max,) — each segment's SSM state page).  Tail rows
        and dummy sequences park on the reserved scratch page at offset
        page_size − 1, and step its state.  On a ring table position p
        lives on ring page (p // ps) % n_ring, the host-side half of the
        windowed kernels' ring walk."""
        ar = self.arena
        ps = ar.page_size
        b_max = self.packed_executor.stream_rows
        page_table = np.full((b_max, ar.max_pages_per_seq), ar.scratch,
                             np.int32)
        token_pages = np.full(bucket, ar.scratch, np.int32)
        token_offs = np.full(bucket, ps - 1, np.int32)
        state_map = np.full(b_max, ar.scratch, np.int32)
        cu = stream.cu_seqlens
        for i, seg in enumerate(segments):
            pages = ar.prepare_extend(seg.session, seg.length)
            page_table[i, :len(pages)] = pages
            pos = stream.positions[cu[i]:cu[i + 1]]
            pidx = pos // ps if ar.ring_pages is None \
                else (pos // ps) % ar.ring_pages
            token_pages[cu[i]:cu[i + 1]] = np.asarray(pages, np.int32)[pidx]
            token_offs[cu[i]:cu[i + 1]] = pos % ps
            if ar.state_slots:
                state_map[i] = ar.state_pages[seg.session]
        return page_table, token_pages, token_offs, state_map

    def _run_packed(self, segments: List[packing.SegmentSpec],
                    bucket: int) -> MixedStepResult:
        """Slot-arena dispatch of an assembled segment list as one packed
        stream.

        Arena-resident by default: the step reads cached history and
        writes new KV rows directly in the arena through the slot map —
        no whole-slot copy.  ``arena_prefill=False`` keeps the gathered
        baseline: every stream row's slot is copied out before the step
        and the real rows scattered back after it."""
        px = self.packed_executor
        n = len(segments)
        slots, slot_map = self._slot_map(segments)
        stream = packing.assemble_mixed_stream(
            segments, bucket, px.stream_rows,
            park_position=self.arena.max_len - 1,
            pad_token=self.ecfg.pad_token)
        sessions = [seg.session for seg in segments]

        if self.ecfg.arena_prefill:
            seg_slots = slot_map[stream.seg_ids]   # per-token arena slot
            t0 = time.perf_counter()
            toks, last_np = self._tokens_from_step(
                sessions, *px.mixed_step_arena(
                    self.params, stream.tokens, stream.positions, seg_slots,
                    slot_map, stream.cu_seqlens, stream.q_offsets,
                    stream.kv_lengths, self.arena.arena, stream.last_idx,
                    n_decode=stream.decode_tokens))
        else:
            caches = self.arena.batch(len(slot_map))
            t0 = time.perf_counter()
            last_np = _host(px.mixed_step(
                self.params, stream.tokens, stream.positions,
                stream.seg_ids, stream.cu_seqlens, stream.q_offsets,
                stream.kv_lengths, caches, stream.last_idx,
                n_decode=stream.decode_tokens,
                fill=lambda: self.arena.gather(slot_map.tolist())),
                torch.float32)
            self.logits_rows_shipped += int(last_np.shape[0])
            toks = self._sample_rows(sessions, last_np[:n])
        elapsed = time.perf_counter() - t0
        px.note_padding(stream.total_tokens, bucket)
        if not self.ecfg.arena_prefill:
            self.arena.scatter(slots, [{k: a[:, :n] for k, a in c.items()}
                                       for c in caches])
        for seg in segments:
            self.arena.set_length(seg.session, seg.history + seg.length)
        out = self._record_packed(segments, toks, last_np, elapsed)
        n_d = stream.decode_tokens
        return MixedStepResult(tokens=out, fused=True, bucket=bucket,
                               n_prefill=n - n_d, n_decode=n_d)

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
        n = len(segments)
        stream = packing.assemble_mixed_stream(
            segments, bucket, px.stream_rows, park_position=ar.max_len - 1,
            pad_token=self.ecfg.pad_token)
        sessions = [seg.session for seg in segments]
        page_table, token_pages, token_offs, state_map = self._page_tables(
            segments, stream, bucket)

        t0 = time.perf_counter()
        toks, last_np = self._tokens_from_step(
            sessions, *px.mixed_step_paged(
                self.params, stream.tokens, stream.positions, token_pages,
                token_offs, page_table, stream.cu_seqlens,
                stream.q_offsets, stream.kv_lengths, ar.arena,
                stream.last_idx, state_map, n_decode=stream.decode_tokens))
        elapsed = time.perf_counter() - t0
        px.note_padding(stream.total_tokens, bucket)
        for seg in segments:
            ar.commit(seg.session, seg.tokens)
        out = self._record_packed(segments, toks, last_np, elapsed)
        n_d = stream.decode_tokens
        return MixedStepResult(tokens=out, fused=True, bucket=bucket,
                               n_prefill=n - n_d, n_decode=n_d)

    # ------------------------------------------- speculative verify step
    def _run_spec(self, segments: List[packing.SegmentSpec], bucket: int,
                  n_drafts: Dict[int, int]) -> MixedStepResult:
        """Dispatch a mixed stream carrying ``verify`` segments.

        The same packed arena step runs — a verify segment is a
        length-(k+1) re-prefill — but every verify row's output is
        gathered back ((B, L) on-device argmax ids for all-greedy steps,
        (R,) fused-kernel samples, or (B, L, V) host rows) so acceptance
        can walk each session's drafts: row j scores the token AFTER
        inputs [pending, d_1..d_j], so accepted drafts and the
        corrective/bonus token commit together, 1..k+1 per session per
        dispatch.  Accepted prefixes stay in place; rejected tails roll
        back via ``arena.truncate`` (slot: length bookkeeping; paged:
        page release + radix de-index)."""
        px = self.packed_executor
        n = len(segments)
        L = 1 + self.spec_k
        b_max = px.stream_rows
        stream = packing.assemble_mixed_stream(
            segments, bucket, b_max, park_position=self.arena.max_len - 1,
            pad_token=self.ecfg.pad_token)
        sessions = [seg.session for seg in segments]
        # gather row i: a verify segment reads ALL its L rows back; other
        # kinds repeat their last row (their token is column 0); pad
        # segments read row 0 and are discarded
        gather = np.zeros((b_max, L), np.int32)
        cu = stream.cu_seqlens
        for i, seg in enumerate(segments):
            if seg.kind == "verify":
                gather[i] = cu[i] + np.arange(L, dtype=np.int32)
            else:
                gather[i] = stream.last_idx[i]

        if self._paged:
            page_table, token_pages, token_offs, _ = self._page_tables(
                segments, stream, bucket)
            t0 = time.perf_counter()
            logits, ids = px.verify_step_paged(
                self.params, stream.tokens, stream.positions, token_pages,
                token_offs, page_table, stream.cu_seqlens,
                stream.q_offsets, stream.kv_lengths, self.arena.arena,
                gather)
        else:
            _, slot_map = self._slot_map(segments)
            seg_slots = slot_map[stream.seg_ids]
            t0 = time.perf_counter()
            logits, ids = px.verify_step_arena(
                self.params, stream.tokens, stream.positions, seg_slots,
                slot_map, stream.cu_seqlens, stream.q_offsets,
                stream.kv_lengths, self.arena.arena, gather)

        # interleaved uniforms per verify session, drawn up front so the
        # fused kernel and the host oracle consume one rng stream layout
        draws = {seg.session: self._spec_draws(seg.session,
                                               n_drafts[seg.session])
                 for seg in segments if seg.kind == "verify"}
        all_greedy = all(s not in self.sampling for s in sessions)
        logits_np = None
        frows = None            # fused-kernel (tok, p_draft, alt) rows
        if all_greedy and not self.ecfg.keep_last_logits:
            self.fused_greedy_steps += 1
        elif (self.ecfg.fused_sampling and not self.ecfg.keep_last_logits
                and self._fused_bias_ok(sessions)):
            frows = self._fused_verify_rows(segments, n_drafts, logits, L,
                                            draws)
        else:
            logits_np = _host(logits, torch.float32)
            self.logits_rows_shipped += int(logits_np.shape[0]
                                            * logits_np.shape[1])
        ids_np = _host(ids)
        # the step's outputs are the graph's: done with them
        del logits, ids
        elapsed = time.perf_counter() - t0
        px.note_padding(stream.total_tokens, bucket)

        committed: Dict[int, List[int]] = {}
        out: Dict[int, int] = {}
        n_verify = 0
        for i, seg in enumerate(segments):
            s = seg.session
            if seg.kind != "verify":
                if logits_np is not None:
                    row = logits_np[i, 0]
                    sp = self.sampling.get(s)
                    if sp is None or sp.is_default:
                        tok = int(np.argmax(row))
                    else:
                        tok = int(sampling_mod.sample_token(
                            row, sp, self._rngs.get(s)))
                    self.last_logits[s] = row
                elif frows is not None:
                    tok = int(frows[0][i * L])
                else:
                    tok = int(ids_np[i, 0])
                if self._paged:
                    self.arena.commit(s, [int(t) for t in seg.tokens])
                else:
                    self.arena.set_length(s, seg.history + seg.length)
                self._observe(seg)
                committed[s] = [tok]
                out[s] = tok
                continue
            # ---- verify segment: walk the drafts ----------------------
            m = n_drafts[s]
            d = [int(t) for t in seg.tokens[1:1 + m]]
            if logits_np is not None:
                tok_r, pd_r, alt_r = self._host_verify_row(
                    s, logits_np[i], d, draws[s][1])
            elif frows is not None:
                base = i * L
                tok_r = [int(frows[0][base + j]) for j in range(m + 1)]
                pd_r = [float(frows[1][base + j]) for j in range(m + 1)]
                alt_r = [int(frows[2][base + j]) for j in range(m + 1)]
            else:
                ids_row = ids_np[i]
                tok_r = [int(ids_row[j]) for j in range(m + 1)]
                pd_r = [1.0 if (j < m and tok_r[j] == d[j]) else 0.0
                        for j in range(m + 1)]
                alt_r = list(tok_r)
            u_acc = draws[s][0]
            emitted: List[int] = []
            for j in range(m):
                if u_acc[j] < pd_r[j]:
                    emitted.append(d[j])     # draft accepted
                else:
                    emitted.append(alt_r[j])  # corrective token; stop
                    break
            else:
                emitted.append(tok_r[m])     # all accepted → bonus token
            c = len(emitted)
            if self._paged:
                # the radix index must only ever see tokens whose KV is
                # REAL: pending + accepted drafts.  commit advances the
                # length to h + c; truncate then releases the
                # over-allocated tail pages the verify write touched
                self.arena.commit(s, [int(t) for t in seg.tokens[:c]])
                self.arena.truncate(s, seg.history + c)
            else:
                self.arena.set_length(s, seg.history + seg.length)
                self.arena.truncate(s, seg.history + c)
            if logits_np is not None:
                self.last_logits[s] = logits_np[i, c - 1]
            if self.draft is not None:
                self.draft.observe(s, [int(t) for t in seg.tokens[:c]])
            self.tokens_drafted += m
            self.tokens_accepted += c - 1
            self.spec_committed += c
            acc = self._spec_by_session.setdefault(s, [0, 0])
            acc[0] += m
            acc[1] += c - 1
            n_verify += 1
            committed[s] = emitted
            out[s] = emitted[-1]
        if self.ecfg.measure:
            pre = [seg for seg in segments
                   if seg.kind not in ("decode", "verify")]
            if pre:
                per = elapsed / len(pre)
                for seg in pre:
                    self.samples.append((per, float(seg.length),
                                         float(seg.history)))
        if n_verify:
            self.spec_dispatches += 1
        n_dec = sum(1 for seg in segments
                    if seg.kind in ("decode", "verify"))
        return MixedStepResult(tokens=out, fused=True, bucket=bucket,
                               n_prefill=n - n_dec, n_decode=n_dec,
                               committed=committed)

    def _host_verify_row(self, session: int, logits_row: np.ndarray,
                         d: List[int], u_samp: np.ndarray
                         ) -> Tuple[List[int], List[float], List[int]]:
        """Per verify row j, the triple the fused kernel returns — (plain
        sample, p(draft_j), residual resample with the draft zeroed) —
        computed by the host oracle sampler over the session's filtered
        distribution."""
        m = len(d)
        sp = self.sampling.get(session)
        tok_r: List[int] = []
        pd_r: List[float] = []
        alt_r: List[int] = []
        for j in range(m + 1):
            row = logits_row[j]
            if sp is None or sp.is_greedy:
                t = (int(sampling_mod.sample_token(row, sp))
                     if sp is not None else int(np.argmax(row)))
                tok_r.append(t)
                pd_r.append(1.0 if (j < m and t == d[j]) else 0.0)
                alt_r.append(t)
                continue
            probs = sampling_mod.filtered_probs(row, sp)
            v = probs.shape[0]
            u = float(u_samp[j])
            tok_r.append(sampling_mod.sample_from_probs(probs, u))
            in_range = j < m and 0 <= d[j] < v
            pd_r.append(float(probs[d[j]]) if in_range else 0.0)
            if in_range and probs[d[j]] < 1.0:
                resid = probs.copy()
                resid[d[j]] = 0.0
                alt_r.append(sampling_mod.sample_from_probs(
                    resid / resid.sum(), u))
            else:
                alt_r.append(tok_r[-1])
        return tok_r, pd_r, alt_r

    def _fused_verify_rows(self, segments: List[packing.SegmentSpec],
                           n_drafts: Dict[int, int],
                           logits_dev: torch.Tensor, L: int,
                           draws: Dict[int, Tuple[np.ndarray, np.ndarray]]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run the fused sampling kernel over EVERY gathered row ((b_max ·
        L, V) logits, reshaped on the card): each row's plain sample,
        p(draft) and residual resample come back as (R,) scalars — the
        full-vocab logits never cross to host even for sampled
        speculative sessions.  Non-verify segments use column 0 (their
        repeated last row); pad rows run greedy into the void."""
        r = int(logits_dev.shape[0]) * L
        rows = self._sampling_rows(r)
        _, _, _, u, draft, _, _ = rows
        for i, seg in enumerate(segments):
            s = seg.session
            sp = self.sampling.get(s)
            verify = seg.kind == "verify"
            m = n_drafts.get(s, 0)
            for j in range(L if verify else 1):
                rr = i * L + j
                if sp is not None:
                    self._fill_params(rows, rr, sp)
                if verify:
                    if j <= m:
                        u[rr] = float(draws[s][1][j])
                    if j < m:
                        draft[rr] = int(seg.tokens[1 + j])
                elif sp is not None and not sp.is_greedy:
                    u[rr] = float(self._rngs[s].random())
        temp, topk, topp, _, _, bias_ids, bias_vals = rows
        tok, p_d, alt = kernel_ops.fused_sample(
            logits_dev.reshape(r, -1), temp, topk, topp, bias_ids,
            bias_vals, u, draft)
        self.fused_sample_steps += 1
        return tok.cpu().numpy(), p_d.cpu().numpy(), alt.cpu().numpy()

    # ------------------------------------------------------ long prefill
    def prefill_long(self, session: int, token_list: np.ndarray) -> int:
        """Chunked long prefill (C_l per step).  Returns first token.

        Each chunk rides the packed stream as a re-prefill segment whose
        history is the tokens already done (off-ladder chunks take the
        dense path on a slot arena).  CHUNK-LEVEL prefix matching on a
        paged pool: the radix index is re-probed at every chunk
        boundary, so a long prompt whose cached prefix extends past the
        first chunk adopts the already-indexed pages mid-request."""
        c = self.ecfg.chunk_tokens
        arr = np.asarray(token_list)
        tok = None
        i = 0
        while i < len(arr):
            if self._paged and self.arena.index is not None:
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
        """Decode ``steps`` tokens for each session.

        Routed through the bucketed decode step when available: the
        batch axis pads to a decode-ladder rung and the arena (slot or
        paged) is read in place.  A batch over the ladder top takes the
        dense gather path on a slot arena and splits into ladder-top
        groups on a paged pool or a rolling arena; without
        ``arena_decode`` (or on a windowed dense baseline) every tick is
        dense."""
        self._check_alive()
        dx = self.decode_executor
        bucket = dx.bucket_for(len(sessions)) if dx is not None else None
        if bucket is None:
            if not self._dense_ok:
                m = dx.ladder.max_seqs
                out: Dict[int, List[int]] = {}
                sessions, tokens = list(sessions), list(tokens)
                for i in range(0, len(sessions), m):
                    out.update(self.decode_batch(sessions[i:i + m],
                                                 tokens[i:i + m], steps))
                return out
            return self._decode_batch_dense(
                sessions, tokens, steps,
                cause="requested" if dx is None else "forced")
        if self._paged:
            return self._decode_batch_paged(sessions, tokens, steps, bucket)

        n = len(sessions)
        slots = [self.arena.slot_of(s) for s in sessions]
        assert all(sl is not None for sl in slots), \
            f"decode session without a cache slot: {list(sessions)}"
        park = self.arena.max_len - 1
        cur = np.asarray(tokens, np.int32)
        out = {s: [] for s in sessions}
        for _ in range(steps):
            hists = [self.arena.length(s) for s in sessions]
            for s, h in zip(sessions, hists):
                self.arena.check_length(s, h + 1)
            rows = packing.pad_decode_rows(
                slots, hists, cur, bucket, park_position=park,
                pad_token=self.ecfg.pad_token, pad_slot=self.arena.scratch)
            out_dev = dx.decode(
                self.params, rows.tokens, rows.slot_map, rows.write_pos,
                rows.kv_lengths, self.arena.arena)
            dx.note_padding(n, bucket)
            if self.draft is not None:
                for i, s in enumerate(sessions):
                    self.draft.observe(s, [int(cur[i])])
            toks, logits_np = self._tokens_from_step(sessions, *out_dev)
            del out_dev     # the graph's outputs: done with them
            cur = toks.astype(np.int32)
            for i, s in enumerate(sessions):
                self.arena.set_length(s, hists[i] + 1)
                out[s].append(int(cur[i]))
                if logits_np is not None:
                    self.last_logits[s] = logits_np[i]
        return out

    def _decode_batch_paged(self, sessions: Sequence[int],
                            tokens: Sequence[int], steps: int,
                            bucket: int) -> Dict[int, List[int]]:
        """Paged decode tick: each row writes its new KV at (page,
        offset) from ``prepare_extend(1)`` — COW-copying a fork-shared
        boundary page first — and attends over its full logical context
        through its page-table row.  Ladder pad rows park on the scratch
        page at offset page_size − 1 and attend over one garbage key
        (output discarded).  SSM rows step their state page in place, pad
        rows the scratch page's."""
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
            state_map = np.full(bucket, ar.scratch, np.int32)
            for i, (s, h) in enumerate(zip(sessions, hists)):
                pages = ar.prepare_extend(s, 1)
                page_table[i, :len(pages)] = pages
                positions[i] = h
                pidx = h // ps if ar.ring_pages is None \
                    else (h // ps) % ar.ring_pages
                write_pages[i] = pages[pidx]
                write_offs[i] = h % ps
                kv_lengths[i] = h + 1
                if ar.state_slots:
                    state_map[i] = ar.state_pages[s]
            out_dev = dx.decode_paged(
                self.params, tok, positions, write_pages, write_offs,
                page_table, kv_lengths, ar.arena, state_map)
            dx.note_padding(n, bucket)
            # the KV written this tick belongs to the INPUT token — the
            # radix index must see the ids whose keys occupy the pages
            for i, s in enumerate(sessions):
                ar.commit(s, [int(cur[i])])
                if self.draft is not None:
                    self.draft.observe(s, [int(cur[i])])
            toks, logits_np = self._tokens_from_step(sessions, *out_dev)
            del out_dev     # the graph's outputs: done with them
            cur = toks.astype(np.int32)
            for i, s in enumerate(sessions):
                out[s].append(int(cur[i]))
                if logits_np is not None:
                    self.last_logits[s] = logits_np[i]
        return out

    def _decode_batch_dense(self, sessions: Sequence[int],
                            tokens: Sequence[int], steps: int = 1,
                            cause: str = "requested"
                            ) -> Dict[int, List[int]]:
        """Dense decode: gather whole arena slots, run the (B, 1) step,
        scatter the slots back — O(S_max) bytes per token and one shape
        per session count.  ``cause`` records whether the config
        requested it or the ladder forced it."""
        assert self._dense_ok, \
            "a paged pool or a rolling arena has no dense gather path"
        n = len(sessions)
        slots = [self.arena.slot_of(s) for s in sessions]
        cur = np.asarray(tokens, np.int32)
        out: Dict[int, List[int]] = {s: [] for s in sessions}
        for _ in range(steps):
            self._note_dense("decode", cause)
            hists = [self.arena.length(s) for s in sessions]
            for s, h in zip(sessions, hists):
                self.arena.check_length(s, h + 1)
            positions = np.asarray(hists, np.int32)[:, None]
            caches = self.arena.batch(n)
            logits_np = _host(self.executor.decode(
                self.params, cur[:, None], positions, caches,
                fill=lambda: self.arena.gather(slots)),
                torch.float32)
            self.arena.scatter(slots, caches)
            self.executor.note_padding(n, n)
            if self.draft is not None:
                for i, s in enumerate(sessions):
                    self.draft.observe(s, [int(cur[i])])
            cur = self._sample_rows(sessions, logits_np).astype(np.int32)
            for i, s in enumerate(sessions):
                self.arena.set_length(s, hists[i] + 1)
                out[s].append(int(cur[i]))
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
        ar, ex = self.arena, self.executor
        out = {
            "graph_hit_rate": ex.hit_rate,
            "captured_shapes": len(ex.compile_times),
            "capture_seconds": ex.capture_cost(),
            "free_slots": ar.free_pages if self._paged else ar.free_slots,
            "fit_samples": len(self.samples),
            "useful_tokens": ex.useful_tokens,
            "padded_tokens": ex.padded_tokens,
            "padding_efficiency": ex.padding_efficiency,
            "hit_rate_by_kind": ex.hit_rate_by_kind,
            # whole-slot copy proof: the arena-resident paths keep both
            # at 0
            "arena_gathers": ar.gather_calls,
            "arena_scatters": ar.scatter_calls,
            # paged-arena proof counters (0 on slot arenas)
            "prefix_hit_tokens": getattr(ar, "prefix_hit_tokens", 0),
            "chunk_hit_tokens": getattr(ar, "chunk_hit_tokens", 0),
            "pages_cow_forked": getattr(ar, "pages_cow_forked", 0),
            "pages_evicted": getattr(ar, "pages_evicted", 0),
            # host spill tier (ROADMAP item 11): 0 until it is ported
            "pages_spilled": getattr(ar, "pages_spilled", 0),
            "pages_promoted": getattr(ar, "pages_promoted", 0),
            "host_pool_pages": getattr(ar, "host_pool_pages", 0),
            "host_pages_dropped": getattr(ar, "host_pages_dropped", 0),
            # SSM boundary-state checkpoints on the radix index, and
            # handoff pages adopted from the destination's index
            "state_checkpoints": getattr(ar, "state_checkpoints", 0),
            "handoff_pages_deduped": getattr(ar, "handoff_pages_deduped",
                                             0),
            # arena-to-arena handoff proof counters
            "handoff_sessions": self.handoff_sessions,
            "handoff_tokens": self.handoff_tokens,
            "handoff_host_bytes": self.handoff_host_bytes,
        }
        if self._paged:
            out["free_pages"] = ar.free_pages
            out["radix_pages"] = (len(ar.index.pages())
                                  if ar.index is not None else 0)
        if self.decode_executor is not None:
            dx = self.decode_executor
            out.update({
                "decode_shapes": len(dx.compile_times),
                "decode_dispatches": dx.dispatches,
                "decode_hit_rate": dx.hit_rate,
                "decode_useful_rows": dx.useful_tokens,
                "decode_pad_rows": dx.padded_tokens,
                "decode_padding_efficiency": dx.padding_efficiency,
            })
        if self.packed_executor is not None:
            px = self.packed_executor
            out.update({
                "packed_shapes": len(px.compile_times),
                "packed_hit_rate": px.hit_rate,
                "packed_useful_tokens": px.useful_tokens,
                "packed_padded_tokens": px.padded_tokens,
                "packed_padding_efficiency": px.padding_efficiency,
                "packed_dispatches": px.dispatches,
                "packed_shapes_by_kind": px.shapes_by_kind(),
                "mixed_steps": px.mixed_steps,
                "decode_tokens_fused": px.decode_tokens_fused,
            })
        out["dense_dispatches"] = ex.dispatches
        # per-kind dense causes: "requested" = the config pinned the
        # dense baseline; "forced" = a ladder miss pushed an otherwise
        # packed step onto the dense path
        by_cause: Dict[str, Dict[str, int]] = {}
        for (kind, cause), count in self.dense_causes.items():
            by_cause.setdefault(kind, {}).setdefault(cause, 0)
            by_cause[kind][cause] += count
        out["dense_dispatches_by_cause"] = by_cause
        out["fused_greedy_steps"] = self.fused_greedy_steps
        out["fused_sample_steps"] = self.fused_sample_steps
        out["logits_rows_shipped"] = self.logits_rows_shipped
        # speculative decoding counters: drafted vs accepted tokens,
        # verify dispatches, total commits, and per-session acceptance
        out["tokens_drafted"] = self.tokens_drafted
        out["tokens_accepted"] = self.tokens_accepted
        out["spec_dispatches"] = self.spec_dispatches
        out["spec_committed"] = self.spec_committed
        out["spec_acceptance"] = (self.tokens_accepted
                                  / max(1, self.tokens_drafted))
        out["spec_tokens_per_dispatch"] = (self.spec_committed
                                           / max(1, self.spec_dispatches))
        out["spec_by_session"] = {
            s: {"drafted": v[0], "accepted": v[1],
                "acceptance": v[1] / max(1, v[0])}
            for s, v in self._spec_by_session.items()}
        return out
