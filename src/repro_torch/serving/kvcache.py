"""KV and state caches of the port, from ``repro.serving.kvcache``: the
slot arena (one preallocated slot of S_max positions per session, plus a
scratch slot for SSM stacks), the radix prefix index over page-sized
token chunks, and the page-pool arena with COW forks, LRU eviction,
speculative rollback (``truncate``) and, for SSM stacks, one state page
per session with boundary-state checkpoints on the radix index.
Sliding-window configs get ROLLING slots on the slot arena
(``swa_depth``) and RING page tables on the page pool (``ring_pages``).

The bookkeeping (slots, lengths, page ids, refcounts, the trie) is the
JAX package's, line for line, so a replay gives identical assignments.
The arenas are torch tensors updated in place by the serving steps.  One
difference: a session's recurrent state starts at zero — ``alloc`` and
``open`` zero the SSM leaves of the slot or state page they hand out,
where the JAX arenas hand out a reused slot or page with the state its
last owner left (ROADMAP Queue 3).  Session handoff (``export_slot`` /
``import_slot``, ``export_pages`` / ``import_session``) moves KV from
arena to arena on the device, writing the destination's tensors in
place.  Not ported: the host spill tier (``host_pool_bytes > 0``, ROADMAP
item 11), which raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


def _zero_state(arena: List[Dict[str, torch.Tensor]], row: int) -> None:
    """Zero the SSM leaves (recurrent and conv state) of slot or page
    ``row``: a fresh session's state.  KV rows need nothing — rows past
    a session's length are never read."""
    for leaves in arena:
        for name in ("ssm", "conv"):
            if name in leaves:
                leaves[name][:, row].zero_()


class KVArena:
    """Slot arena: per layer-pattern position k/v ``(G, N_slots, S_max,
    Hkv, D)`` torch tensors; each session owns one slot and its cached
    positions [0, length).  Row S_max − 1 of every slot is the PARK row:
    pad and tail rows of a step write there, and ``set_length`` caps a
    session at S_max − 2 so no live position ever reaches it.  SSM
    stacks (``scratch_slot=True``) hold per-layer {"ssm", "conv"} state
    leaves ``(G, N_slots + 1, ...)``: state has no park position, so
    pads target the extra SCRATCH slot ``N_slots``, which sessions never
    claim.

    ``swa_depth``: the attention-slot depth of a sliding-window config
    (None keeps ``min(max_len, window)``).  The rolling arena passes
    window + margin: a slot holds a session's newest positions at
    position % depth, every row cycles live, so it has a scratch slot
    too; the dense baseline passes max_len and masks the window.

    The arena-resident steps read and write the tensors in place through
    a slot map (there is no ``replace``: the JAX package's swap of the
    donated result is the identity here).  ``gather`` / ``scatter`` copy
    whole slots out and back for the dense (L, B) path and the gathered
    packed baseline, through one static batch buffer of ``batch_rows``
    slots that their step graphs read by address; ``gather_calls`` /
    ``scatter_calls`` count them, and the arena-resident paths keep both
    at 0.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 dtype=None, swa_depth: Optional[int] = None,
                 scratch_slot: bool = False, device="cuda",
                 batch_rows: Optional[int] = None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.swa_depth = swa_depth
        # None: pads park on a live slot's park row
        self.scratch: Optional[int] = num_slots if scratch_slot else None
        self.arena = tr.init_cache(cfg, num_slots + int(scratch_slot),
                                   max_len, dtype, device=device,
                                   swa_depth=swa_depth)
        self._free: List[int] = list(range(num_slots))
        self._session_slot: Dict[int, int] = {}
        self.lengths: Dict[int, int] = {}          # session -> tokens cached
        self.gather_calls = 0
        self.scatter_calls = 0
        # rows of the static batch buffer that gathers fill (``batch``)
        self.batch_rows = num_slots if batch_rows is None else batch_rows
        self._batch: Optional[List[Dict[str, torch.Tensor]]] = None

    # ----------------------------------------------------------- slots
    def alloc(self, session: int) -> int:
        if session in self._session_slot:
            return self._session_slot[session]
        if not self._free:
            raise RuntimeError("KV arena exhausted")
        slot = self._free.pop()
        self._session_slot[session] = slot
        self.lengths[session] = 0
        _zero_state(self.arena, slot)
        return slot

    def free(self, session: int) -> None:
        slot = self._session_slot.pop(session, None)
        if slot is not None:
            self._free.append(slot)
            self.lengths.pop(session, None)

    def slot_of(self, session: int) -> Optional[int]:
        return self._session_slot.get(session)

    def length(self, session: int) -> int:
        return self.lengths.get(session, 0)

    def check_length(self, session: int, n: int) -> None:
        """Raise if ``n`` cached positions would reach the park row.  The
        engine calls it before a step writes (an out-of-range write is
        an error in PyTorch, where a JAX scatter drops it)."""
        if n > self.max_len - 2:
            raise RuntimeError(
                f"session {session} overflows arena ({n} > {self.max_len - 2})")

    def set_length(self, session: int, n: int) -> None:
        self.check_length(session, n)
        self.lengths[session] = n

    def truncate(self, session: int, n: int) -> None:
        """Drop cached rows past ``n``: pure length bookkeeping, since
        rows past the valid length are never read and the next append
        overwrites them."""
        h = self.lengths.get(session, 0)
        if not 0 <= n <= h:
            raise ValueError(
                f"truncate session {session} to {n} outside [0, {h}]")
        self.lengths[session] = n

    @property
    def free_slots(self) -> int:
        return len(self._free)

    # ---------------------------------------------------------- gather
    def batch(self, n: int) -> List[Dict[str, torch.Tensor]]:
        """The first ``n`` rows of the arena's one static batch buffer:
        {"k"/"v": (G, n, S_max, Hkv, D), ...} per pattern position, each
        leaf contiguous and starting at the buffer's address whatever
        ``n``, so the step graphs of every grid depth read one buffer.
        Allocated at first use, for ``batch_rows`` rows (one slot of
        qwen3-4b at S_max 4096 is 604 MB: one buffer of the deepest
        depth, not one per depth)."""
        if n > self.batch_rows:
            raise ValueError(f"{n} gathered rows: the batch buffer holds "
                             f"{self.batch_rows}")
        if self._batch is None:
            self._batch = [{name: torch.empty(
                a.numel() // a.shape[1] * self.batch_rows, dtype=a.dtype,
                device=a.device) for name, a in leaves.items()}
                for leaves in self.arena]
        out = []
        for leaves, flat in zip(self.arena, self._batch):
            views = {}
            for name, a in leaves.items():
                shape = (a.shape[0], n) + tuple(a.shape[2:])
                views[name] = flat[name][:a.numel() // a.shape[1] * n
                                         ].view(shape)
            out.append(views)
        return out

    def gather(self, slots: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
        """Copy whole slots out into the first len(slots) rows of the
        static batch buffer (:meth:`batch`), valid until the next gather:
        {"k"/"v": (G, len(slots), S_max, Hkv, D)} per pattern position (a
        slot may repeat)."""
        self.gather_calls += 1
        idx = self._index(slots)
        out = self.batch(len(slots))
        for leaves, dst in zip(self.arena, out):
            for name, a in leaves.items():
                torch.index_select(a, 1, idx, out=dst[name])
        return out

    def scatter(self, slots: Sequence[int],
                batch_cache: List[Dict[str, torch.Tensor]]) -> None:
        """Copy whole slots back: row i of ``batch_cache`` into slot
        ``slots[i]``."""
        self.scatter_calls += 1
        idx = self._index(slots)
        for leaves, batch in zip(self.arena, batch_cache):
            for name, a in leaves.items():
                a.index_copy_(1, idx, batch[name].to(a.dtype))

    def _index(self, slots: Sequence[int]) -> torch.Tensor:
        dev = next(iter(self.arena[0].values())).device
        return torch.as_tensor(list(slots), dtype=torch.long, device=dev)

    # ----------------------------------------------------------- handoff
    def export_slot(self, session: int) -> List[Dict[str, torch.Tensor]]:
        """Handoff source: a device snapshot of the session's cached rows,
        ``(G, length, Hkv, D)`` per leaf — a clone, not a view, so a
        payload held past ``free`` stays valid.  Only valid for
        pure-attention, non-rolling layouts."""
        slot = self._session_slot[session]
        h = self.lengths[session]
        return [{name: a[:, slot, :h].clone() for name, a in leaves.items()}
                for leaves in self.arena]

    def import_slot(self, session: int, kv: List[Dict[str, torch.Tensor]],
                    n_tokens: int) -> int:
        """Handoff destination: allocate a slot and copy the exported rows
        into it in place (the step graphs hold the arena's addresses).
        Returns the slot."""
        assert session not in self._session_slot, \
            f"import into live session {session}"
        self.check_length(session, n_tokens)
        slot = self.alloc(session)
        if n_tokens:
            for leaves, src in zip(self.arena, kv):
                for name, a in leaves.items():
                    a[:, slot, :n_tokens].copy_(
                        src[name].to(a.device, a.dtype, non_blocking=True))
        self.set_length(session, n_tokens)
        return slot


class _RadixNode:
    """One edge of the prefix trie: a page_size-token chunk → one page.

    ``state_page`` (SSM stacks) optionally names a page holding the
    boundary-state CHECKPOINT after this chunk — the recurrent state a
    session holds having processed exactly the root→here token path.
    The node owns one refcount on it."""
    __slots__ = ("children", "parent", "chunk", "page", "last_use",
                 "state_page")

    def __init__(self, parent: Optional["_RadixNode"] = None,
                 chunk: Optional[Tuple[int, ...]] = None, page: int = -1):
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.chunk = chunk
        self.page = page
        self.last_use = 0
        self.state_page: Optional[int] = None


class RadixPageIndex:
    """Radix/trie prefix index over page_size-token chunks.

    Maps token-id prefixes to the KV pages that hold them, at PAGE
    granularity: an edge at depth i is the tuple of token ids
    ``tokens[i·ps : (i+1)·ps]`` and names the physical page caching that
    chunk's KV.  Only FULL pages are indexed — a prefix is shareable
    exactly up to its last page boundary, which is also what makes
    sharing safe: sessions append at positions ≥ their committed length,
    so an indexed (full) page is never written again.

    The index holds its own reference on every indexed page; eviction
    (LRU over leaf nodes) drops that reference so cold cached prefixes
    return to the free pool once no session holds them either.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _RadixNode()
        self._clock = 0
        self._n_pages = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int],
              touch: bool = True) -> List[int]:
        """Longest indexed prefix of ``tokens`` in full-page chunks.

        Returns the page ids caching ``tokens[:len(result)·ps]``.  Never
        matches past ``len(tokens) − 1``: the caller must keep ≥ 1 token
        of true suffix to prefill.
        """
        ps = self.page_size
        limit = max(len(tokens) - 1, 0) // ps
        node, pages = self.root, []
        now = self._tick() if touch else self._clock
        for i in range(limit):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            if touch:
                child.last_use = now
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> List[int]:
        """Index every full-page chunk of ``tokens``; return the page ids
        NEWLY referenced (the caller owns refcounts).  Chunks already
        indexed keep their existing page — the duplicate stays private
        to its session."""
        ps = self.page_size
        node, newly = self.root, []
        now = self._tick()
        for i in range(len(tokens) // ps):
            chunk = tuple(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(parent=node, chunk=chunk, page=pages[i])
                node.children[chunk] = child
                newly.append(pages[i])
                self._n_pages += 1
            child.last_use = now
            node = child
        return newly

    def pages(self) -> List[int]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                out.append(n.page)
            stack.extend(n.children.values())
        return out

    def leaves(self) -> Iterable[_RadixNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                yield n
            stack.extend(n.children.values())

    def remove(self, node: _RadixNode) -> int:
        """Unlink a LEAF node; returns its page (caller drops the ref)."""
        assert not node.children and node.parent is not None
        del node.parent.children[node.chunk]
        self._n_pages -= 1
        return node.page

    def __len__(self) -> int:
        return self._n_pages


class PagedKVArena:
    """Paged KV cache: fixed-size pages in a shared pool + per-session
    page tables, with radix-tree prefix reuse, COW forks, and LRU
    eviction.

    Layout per layer-pattern position: k/v ``(G, N_pages + 1, page_size,
    Hkv, D)`` torch tensors.  Page ``N_pages`` is the reserved SCRATCH
    page: it is never allocated, never indexed, and pad stream rows
    write at (scratch, page_size − 1).

    Sessions own ORDERED page lists (logical page i = positions
    [i·ps, (i+1)·ps)).  Pages are shared through radix-tree prefix reuse
    (``match_prefix`` / ``match_extend``) and COW forks (``fork``; the
    fork-shared partial boundary page is copied by ``prepare_extend`` on
    the first diverging write).

    ``refcount[p]`` = #sessions whose table holds p, + 1 if the radix
    index holds p, + 1 per session or radix node holding p as a state
    page.  A page returns to the free pool when its refcount drops to
    zero; when the pool runs dry, LRU leaf pages held only by the index
    are evicted (with their state checkpoints).

    ``ring_pages=n`` (sliding-window configs): RING tables.  A
    session's page list is a ring of at most ``n`` pages; position p
    lives on ring page (p // ps) % n (the engine maps it), so the ring
    holds the newest n·ps positions and its pages are overwritten in
    place as the window rolls.  They are never shareable: the radix
    index is off, refcounts stay 1, ``truncate`` is length bookkeeping
    and ``fork`` refuses.

    ``state_slots=True`` (SSM stacks): each session gets one STATE page
    from the same pool (the SSM leaves of the pool use the page axis as
    the state-slot axis).  ``commit`` checkpoints the live state into a
    fresh page attached to the radix node whenever the committed length
    lands on a page boundary, and ``match_prefix`` / ``match_extend``
    clamp adoption to the deepest matched ancestor that carries such a
    checkpoint, copying it into the session's state page.  Every page,
    token pages included, carries a state slot's worth of SSM leaves.

    ``cfg=None`` builds a bookkeeping-only arena (no tensors) for
    property tests of the share/fork/evict/write state machine.
    """

    def __init__(self, cfg: Optional[ModelConfig], num_pages: int,
                 page_size: int, max_len: int, dtype=None,
                 prefix_cache: bool = True,
                 ring_pages: Optional[int] = None,
                 state_slots: bool = False,
                 host_pool_bytes: int = 0, device="cuda"):
        if host_pool_bytes > 0:
            raise NotImplementedError(
                "the host spill tier is not ported yet "
                "(ROADMAP Queue 1, item 11)")
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_len = max_len
        self.scratch: int = num_pages          # reserved, never allocated
        self.ring_pages = ring_pages
        self.state_slots = state_slots
        # swa_depth=page_size keeps a windowed pool's pages page_size
        # deep: the ring table, not the page depth, carries the window
        self.arena = (tr.init_cache(cfg, num_pages + 1, page_size, dtype,
                                    device=device, swa_depth=page_size)
                      if cfg is not None else None)
        self._free: List[int] = list(range(num_pages))
        self._refcount: List[int] = [0] * num_pages
        self._pages: Dict[int, List[int]] = {}     # session -> page list
        self._tokens: Dict[int, List[int]] = {}    # session -> cached ids
        self.lengths: Dict[int, int] = {}          # session -> tokens cached
        self.state_pages: Dict[int, int] = {}      # session -> SSM state page
        if ring_pages is not None:
            prefix_cache = False               # ring pages are overwritten
        self.index: Optional[RadixPageIndex] = (
            RadixPageIndex(page_size) if prefix_cache else None)
        # proof counters (engine.stats())
        self.prefix_hit_tokens = 0
        self.chunk_hit_tokens = 0
        self.pages_cow_forked = 0
        self.pages_evicted = 0
        self.state_checkpoints = 0
        self.handoff_pages_deduped = 0
        # the paged paths never materialize whole sequences: kept for
        # stats() symmetry with the JAX package and asserted == 0
        self.gather_calls = 0
        self.scatter_calls = 0

    # ---------------------------------------------------------- refcounts
    def _ref(self, page: int) -> None:
        self._refcount[page] += 1

    def _unref(self, page: int) -> None:
        rc = self._refcount[page] = self._refcount[page] - 1
        assert rc >= 0, f"page {page} refcount underflow"
        if rc == 0:
            self._free.append(page)

    def _alloc_page(self) -> int:
        if not self._free:
            self._evict(1)
        if not self._free:
            raise RuntimeError("KV page pool exhausted")
        page = self._free.pop()
        self._refcount[page] = 1
        return page

    def _evict(self, need: int) -> None:
        """LRU-evict leaf pages held ONLY by the radix index."""
        if self.index is None:
            return
        freed = 0
        while freed < need:
            victim = None
            for leaf in self.index.leaves():
                if self._refcount[leaf.page] != 1:
                    continue                   # pinned by a live session
                if victim is None or leaf.last_use < victim.last_use:
                    victim = leaf
            if victim is None:
                return
            if victim.state_page is not None:
                self._unref(victim.state_page)
                victim.state_page = None
            self._unref(self.index.remove(victim))
            self.pages_evicted += 1
            freed += 1

    # ------------------------------------------------------------ sessions
    def open(self, session: int) -> None:
        if session in self._pages:
            return
        self._pages[session] = []
        self._tokens[session] = []
        self.lengths[session] = 0
        if self.state_slots:
            # one SSM state page per session, from the same pool, zeroed
            sp = self.state_pages[session] = self._alloc_page()
            if self.arena is not None:
                _zero_state(self.arena, sp)

    def free(self, session: int) -> None:
        pages = self._pages.pop(session, None)
        if pages is None:
            return
        for p in pages:
            self._unref(p)
        sp = self.state_pages.pop(session, None)
        if sp is not None:
            self._unref(sp)
        self._tokens.pop(session, None)
        self.lengths.pop(session, None)

    def pages_of(self, session: int) -> List[int]:
        return self._pages.get(session, [])

    def slot_of(self, session: int) -> Optional[int]:
        """KVArena-compatible accessor: the 'slot' carrying an SSM
        session's recurrent state is its state page (None for
        pure-attention stacks)."""
        return self.state_pages.get(session)

    def length(self, session: int) -> int:
        return self.lengths.get(session, 0)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def max_pages_per_seq(self) -> int:
        if self.ring_pages is not None:
            return self.ring_pages
        return self.max_len // self.page_size

    # -------------------------------------------------------- prefix reuse
    def _walk(self, start: _RadixNode, tokens: Sequence[int], limit: int,
              *, pin: bool) -> List[_RadixNode]:
        """Follow ``tokens`` chunk by chunk from ``start``.  ``pin=True``
        refs every matched page (the caller owns the refs)."""
        node = start
        out: List[_RadixNode] = []
        now = self.index._tick() if pin else self.index._clock
        ps = self.page_size
        for i in range(limit):
            chunk = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                break
            if pin:
                child.last_use = now
                self._ref(child.page)
            out.append(child)
            node = child
        return out

    def _adoptable(self, nodes: List[_RadixNode]) -> int:
        """How many matched chunks a session can actually ADOPT: all of
        them for attention stacks; with SSM state, only up to the
        deepest one carrying a boundary-state checkpoint (the recurrent
        state must be reconstructable, not just the KV)."""
        if not self.state_slots:
            return len(nodes)
        for d in range(len(nodes), 0, -1):
            if nodes[d - 1].state_page is not None:
                return d
        return 0

    def probe_prefix(self, tokens: Sequence[int]) -> int:
        """Tokens a fresh session with this prompt would NOT re-prefill
        (non-adopting; used by the serve loop for length-aware
        scheduling of the true suffix)."""
        if self.index is None:
            return 0
        limit = max(len(tokens) - 1, 0) // self.page_size
        nodes = self._walk(self.index.root, tokens, limit, pin=False)
        return self._adoptable(nodes) * self.page_size

    def match_prefix(self, session: int, tokens: Sequence[int]) -> int:
        """Map the longest indexed prefix of ``tokens`` onto existing
        pages; the session then only prefills ``tokens[matched:]``.

        Only valid on an EMPTY session.  Returns the matched token count
        (multiple of page_size, ≤ len(tokens) − 1).
        """
        self.open(session)
        assert self.lengths[session] == 0 and not self._pages[session], \
            f"match_prefix on non-empty session {session}"
        if self.index is None:
            return 0
        limit = max(len(tokens) - 1, 0) // self.page_size
        nodes = self._walk(self.index.root, tokens, limit, pin=True)
        nodes = self._clamp(nodes)
        if not nodes:
            return 0
        matched = len(nodes) * self.page_size
        self._pages[session] = [nd.page for nd in nodes]
        self._tokens[session] = [int(t) for t in tokens[:matched]]
        self.lengths[session] = matched
        self.prefix_hit_tokens += matched
        if self.state_slots:
            self._copy_page(nodes[-1].state_page, self.state_pages[session])
        return matched

    def _clamp(self, nodes: List[_RadixNode]) -> List[_RadixNode]:
        """Unpin the matched chunks past the adoptable depth."""
        d = self._adoptable(nodes)
        for nd in nodes[d:]:
            self._unref(nd.page)
        return nodes[:d]

    def match_extend(self, session: int, tokens: Sequence[int]) -> int:
        """CHUNK-LEVEL prefix matching: mid-request, map the longest
        indexed continuation of the session's cached history onto
        existing pages.

        ``tokens`` is the not-yet-cached remainder of the prompt.  Only
        valid when the session sits exactly on a page boundary.  Keeps
        ≥ 1 token of true suffix.  Returns the adopted token count.
        """
        if self.index is None:
            return 0
        h = self.lengths.get(session, 0)
        ps = self.page_size
        if h == 0 or h % ps:
            return 0
        toks = self._tokens[session]
        # locate the session's frontier node by CONTENT (the session may
        # hold private duplicate pages; the trie is keyed on token ids)
        node = self.index.root
        for i in range(h // ps):
            child = node.children.get(tuple(toks[i * ps:(i + 1) * ps]))
            if child is None:
                return 0                       # history not indexed
            node = child
        limit = max(len(tokens) - 1, 0) // ps
        # with SSM state the session's live state covers exactly h
        # tokens: skipping ahead is sound only up to a checkpoint that
        # replaces it, so clamp as match_prefix does
        nodes = self._clamp(self._walk(node, tokens, limit, pin=True))
        if not nodes:
            return 0
        matched = len(nodes) * ps
        self._pages[session].extend(nd.page for nd in nodes)
        toks.extend(int(t) for t in tokens[:matched])
        self.lengths[session] = h + matched
        self.prefix_hit_tokens += matched
        self.chunk_hit_tokens += matched
        if self.state_slots:
            self._copy_page(nodes[-1].state_page, self.state_pages[session])
        return matched

    # --------------------------------------------------------------- write
    def prepare_extend(self, session: int, n: int) -> List[int]:
        """Make positions [length, length + n) writable: COW-copy the
        fork-shared partial boundary page (the ONLY shareable page a
        write can touch — full pages are append-safe) and allocate fresh
        pages for the tail.  Returns the session's page list; every page
        overlapping the write range is exclusively owned afterwards."""
        self.open(session)
        h = self.lengths[session]
        if h + n > self.max_len - 2:
            raise RuntimeError(
                f"session {session} overflows arena "
                f"({h + n} > {self.max_len - 2})")
        ps = self.page_size
        pages = self._pages[session]
        if self.ring_pages is not None:
            # a ring table: pages are allocated until the ring is full;
            # past that, writes wrap onto the ring's own pages, which are
            # never shared, so no COW
            last = (h + n - 1) // ps
            while len(pages) <= last and len(pages) < self.ring_pages:
                pages.append(self._alloc_page())
            return pages
        if h % ps and self._refcount[pages[h // ps]] > 1:
            src = pages[h // ps]
            dst = self._alloc_page()
            self._copy_page(src, dst)
            self._unref(src)
            pages[h // ps] = dst
            self.pages_cow_forked += 1
        last = (h + n - 1) // ps
        while len(pages) <= last:
            pages.append(self._alloc_page())
        return pages

    def commit(self, session: int, token_ids: Sequence[int]) -> None:
        """Record ``token_ids`` as written at [length, length + n) (the
        step already wrote their KV via prepare_extend's pages) and
        index every newly-FULL page for cross-session reuse."""
        toks = self._tokens[session]
        toks.extend(int(t) for t in token_ids)
        self.lengths[session] += len(token_ids)
        if self.index is not None:
            ps = self.page_size
            n_full = self.lengths[session] // ps
            for p in self.index.insert(toks[:n_full * ps],
                                       self._pages[session][:n_full]):
                self._ref(p)
            if (self.state_slots and n_full > 0
                    and self.lengths[session] % ps == 0):
                self._checkpoint_state(session, toks, n_full)

    def _checkpoint_state(self, session: int, toks: List[int],
                          n_full: int) -> None:
        """SSM boundary-state checkpoint: when the committed length lands
        exactly on a page boundary, the session's LIVE state is the state
        after ``n_full`` chunks — snapshot it into a fresh page owned by
        the radix node at that depth, so a later session matching this
        prefix can adopt it.  Best-effort: pool pressure skips the
        snapshot rather than evicting live data for it."""
        ps = self.page_size
        try:
            cp = self._alloc_page()
        except RuntimeError:
            return
        # re-walk AFTER the alloc: its eviction sweep may have dropped
        # the very node about to be decorated
        node: Optional[_RadixNode] = self.index.root
        for i in range(n_full):
            node = node.children.get(tuple(toks[i * ps:(i + 1) * ps]))
            if node is None:
                break
        if node is None or node is self.index.root \
                or node.state_page is not None:
            self._unref(cp)
            return
        self._copy_page(self.state_pages[session], cp)
        node.state_page = cp
        self.state_checkpoints += 1

    # ------------------------------------------------------------ rollback
    def truncate(self, session: int, n: int) -> None:
        """Speculative rollback: forget every cached token past ``n``.

        Three things unwind, in order:

        1. **Radix de-index** — the session's indexed chunk path is
           walked and suffix nodes covering chunks >= ``n // ps`` are
           unlinked deepest first, including the boundary chunk whose
           page goes full → partial (an indexed page must stay
           append-only).  A node survives when it still has children (a
           longer indexed prefix — shared, not ours to drop) or when it
           names another physical page (a private duplicate was never
           indexed); then every shallower node survives too, and a
           still-indexed boundary page keeps rc > 1 so
           ``prepare_extend``'s COW shields it from the re-extend.
        2. **Page release** — the session unrefs every page past
           ``ceil(n / ps)``; pages held by the index or a fork sibling
           stay alive, exclusively-owned tails return to the free pool.
           Pages a speculative ``prepare_extend`` over-allocated (never
           committed) are released the same way even when
           ``n == length``.
        3. **Token trim** — the token ids and length shrink to ``n``.

        ``audit()`` holds afterwards.  On a ring table the rollback is
        length bookkeeping: its pages hold wrapped history, rows past
        ``n`` are masked out by length and overwritten in place.
        """
        h = self.lengths.get(session, 0)
        if not 0 <= n <= h:
            raise ValueError(
                f"truncate session {session} to {n} outside [0, {h}]")
        self.open(session)
        ps = self.page_size
        toks = self._tokens[session]
        pages = self._pages[session]
        if self.ring_pages is not None:
            del toks[n:]
            self.lengths[session] = n
            return
        new_full = n // ps
        keep_pages = -(-n // ps)
        if self.index is not None:
            # the session's indexed chain, chunk by chunk
            path: List[_RadixNode] = []
            node = self.index.root
            for i in range(h // ps):
                child = node.children.get(tuple(toks[i * ps:(i + 1) * ps]))
                if child is None:
                    break
                path.append(child)
                node = child
            for i in range(len(path) - 1, new_full - 1, -1):
                nd = path[i]
                if nd.children or nd.page != pages[i]:
                    break
                if nd.state_page is not None:
                    self._unref(nd.state_page)
                    nd.state_page = None
                self._unref(self.index.remove(nd))
        for p in pages[keep_pages:]:
            self._unref(p)
        del pages[keep_pages:]
        del toks[n:]
        self.lengths[session] = n

    # ---------------------------------------------------------------- fork
    def fork(self, parent: int, child: int) -> None:
        """COW-fork: the child shares every page (and the token history)
        of the parent; diverging writes copy the partial boundary page
        on demand (prepare_extend).  With SSM state the parent's state
        page is deep-copied (recurrent state diverges at once).  Ring
        tables cannot fork: their pages are overwritten in place."""
        assert self.ring_pages is None, \
            "ring tables cannot fork (pages are overwritten in place)"
        assert child not in self._pages, f"fork onto live session {child}"
        self.open(child)
        for p in self._pages[parent]:
            self._ref(p)
        self._pages[child] = list(self._pages[parent])
        self._tokens[child] = list(self._tokens[parent])
        self.lengths[child] = self.lengths[parent]
        if self.state_slots:
            self._copy_page(self.state_pages[parent],
                            self.state_pages[child])

    # ------------------------------------------------------------- handoff
    def export_pages(self, session: int
                     ) -> Optional[List[Dict[str, torch.Tensor]]]:
        """Handoff source: gather the session's page rows from the pool
        on the device, ``(G, n_pages, page_size, Hkv, D)`` per leaf
        (``index_select`` makes a snapshot, not a view)."""
        pages = self._pages.get(session, [])
        if self.arena is None or not pages:
            return None
        dev = next(iter(self.arena[0].values())).device
        idx = torch.as_tensor(pages, dtype=torch.long, device=dev)
        return [{name: torch.index_select(a, 1, idx)
                 for name, a in leaves.items()} for leaves in self.arena]

    def import_session(self, session: int, token_ids: Sequence[int],
                       kv: Optional[List[Dict[str, torch.Tensor]]],
                       n_tokens: int) -> List[int]:
        """Handoff destination: allocate fresh pages, copy the exported
        pool rows into them in place, rebuild the session bookkeeping,
        and index every full page — the imported prefix becomes
        shareable here exactly as if it had been prefilled locally.

        Dedupe: the caller may ``match_prefix`` the incoming transcript
        first — pages the destination's radix index already holds are
        adopted, and only the suffix of the exported payload (``kv``
        sliced past the matched pages) is copied in.  ``kv`` is always
        the FULL export; the slicing happens here."""
        self.open(session)
        h = self.lengths[session]
        ps = self.page_size
        assert h % ps == 0, \
            f"import into session {session} off a page boundary ({h})"
        assert self._tokens[session] == [int(t) for t in token_ids[:h]], \
            f"import into session {session} with mismatched history"
        if n_tokens > self.max_len - 2:
            raise RuntimeError(
                f"imported session {session} overflows arena "
                f"({n_tokens} > {self.max_len - 2})")
        skip = h // ps
        n_pages = -(-n_tokens // ps) - skip
        pages = [self._alloc_page() for _ in range(n_pages)]
        if self.arena is not None and kv is not None and pages:
            dev = next(iter(self.arena[0].values())).device
            idx = torch.as_tensor(pages, dtype=torch.long, device=dev)
            for leaves, src in zip(self.arena, kv):
                for name, a in leaves.items():
                    a.index_copy_(1, idx, src[name][:, skip:].to(
                        a.device, a.dtype, non_blocking=True))
        self._pages[session].extend(pages)
        self._tokens[session].extend(int(t) for t in token_ids[h:n_tokens])
        self.lengths[session] = n_tokens
        if skip:
            self.handoff_pages_deduped += skip
        if self.index is not None:
            n_full = n_tokens // ps
            for p in self.index.insert(self._tokens[session][:n_full * ps],
                                       self._pages[session][:n_full]):
                self._ref(p)
        return self._pages[session]

    # ------------------------------------------------------------- tensors
    def _copy_page(self, src: int, dst: int) -> None:
        if self.arena is None:
            return
        for leaves in self.arena:
            for a in leaves.values():
                a[:, dst].copy_(a[:, src])

    # --------------------------------------------------------------- audit
    def audit(self) -> None:
        """Assert the refcount/free-list/scratch invariants (tests)."""
        rc = [0] * self.num_pages
        for pages in self._pages.values():
            for p in pages:
                assert p != self.scratch, "scratch page in a session table"
                rc[p] += 1
        for sp in self.state_pages.values():
            assert sp != self.scratch, "scratch page as a state page"
            rc[sp] += 1
        if self.index is not None:
            stack = [self.index.root]
            while stack:
                nd = stack.pop()
                if nd is not self.index.root:
                    assert nd.page != self.scratch, \
                        "scratch page in the radix index"
                    assert nd.page >= 0, "placeholder node leaked"
                    rc[nd.page] += 1
                    if nd.state_page is not None:
                        assert nd.state_page != self.scratch
                        rc[nd.state_page] += 1
                stack.extend(nd.children.values())
        assert rc == self._refcount, \
            f"refcount drift: counted {rc} != tracked {self._refcount}"
        assert sorted(self._free) == sorted(set(self._free)), \
            "duplicate pages in the free list"
        free = set(self._free)
        for p in self._free:
            assert p != self.scratch and self._refcount[p] == 0, \
                f"free page {p} still referenced"
        for p, r in enumerate(self._refcount):
            assert (r == 0) == (p in free), \
                f"page {p} rc={r} free-list membership mismatch"
