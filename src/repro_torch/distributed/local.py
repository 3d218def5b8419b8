"""Shard-local steps under DTensor: the kernels, the KV cache writes,
the MoE dispatch and expert products, the vocab-sharded embedding and
loss, each run on every rank's local shards through
``torch.distributed.tensor.experimental.local_map`` with its in and out
placements declared, so autograd passes through and nothing is
replicated that the reference keeps shard-local.

Each wrapper reads its inputs' placements and picks, mesh dim by mesh
dim, the placements its local computation needs; an input that does not
already have them is redistributed (``redistribute_inputs``: an
all-gather of an FSDP-sharded weight, a slice of a replicated vector).
A plain tensor beside DTensors is a replicated global value.  An input
replicated over a mesh dim on which the computation is split has a
partial gradient there (its local grads sum).

GQA under the divisibility guard: query heads sharded over a mesh axis
that does not divide the KV heads (32 / 8 heads on a 16-way axis)
leave the KV heads replicated; each rank's call then takes only the KV
heads its local query heads read (query head h reads KV head h // rep),
and the SSD scan likewise only the B/C groups of its local heads.

A KV cache sharded over its sequence (``cache_seq`` on "model" in
``SERVE_RULES``) is written row by row on the shard that holds the
position, and a decode step over it combines each shard's partial output
by its log-sum-exp over the sequence's mesh dims.  The plain versions
give the partials on the CPU and the meta device; on the card, with the
sequence over one device, the kernel's output is the answer, and over
more a CUDA call raises: ``decode_attn`` writes no log-sum-exp yet.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import local_offset

R = Replicate()


def as_dtensor(x, mesh) -> Optional[DTensor]:
    """``x`` as a DTensor on ``mesh``: a plain tensor is a replicated
    global value; None stays None."""
    if x is None or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (R,) * mesh.ndim, run_check=False)


def _grads(ins: Sequence[Optional[Tuple]], split: Sequence[bool]):
    """Gradient placements: an input replicated over a mesh dim on
    which the computation is split has a partial gradient there."""
    out = []
    for place in ins:
        if place is None:
            out.append(None)
            continue
        out.append(tuple(Partial() if s and isinstance(p, Replicate) else p
                         for p, s in zip(place, split)))
    return tuple(out)


def run_local(fn: Callable, mesh, args, in_places, out_places):
    """``fn`` on the local shards of ``args`` placed ``in_places``
    (ignored for an argument that is None), its outputs placed
    ``out_places``."""
    in_places = [None if a is None else p for a, p in zip(args, in_places)]
    split = [any(p is not None and isinstance(p[i], Shard)
                 for p in in_places) or
             any(isinstance(o[i], Partial) for o in _flat(out_places))
             for i in range(mesh.ndim)]
    fn = _contiguous(fn)
    # one output's placements are a list; several outputs', a tuple
    outs = _flat(out_places)
    if out_places is not None:
        out_places = (list(outs[0]) if outs[0] is out_places else
                      tuple(list(o) for o in outs))
    wrapped = local_map(fn, out_placements=out_places,
                        in_placements=tuple(None if p is None else list(p)
                                            for p in in_places),
                        in_grad_placements=_grads(in_places, split),
                        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor
    takes a local shard's strides to be its global layout's, and a
    plain version's permuted gradient would fail a later ``view``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous(fn: Callable) -> Callable:
    """``fn`` with contiguous tensor outputs and input gradients."""
    def wrapped(*args):
        args = [_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
                and a.requires_grad else a for a in args]
        out = fn(*args)
        if isinstance(out, tuple):
            return tuple(o.contiguous() if isinstance(o, torch.Tensor)
                         else o for o in out)
        return out.contiguous() if isinstance(out, torch.Tensor) else out
    return wrapped


def _flat(out_places) -> List[Tuple]:
    if out_places is None:
        return []
    if out_places and isinstance(out_places[0], (tuple, list)):
        return [o for o in out_places if o is not None]
    return [out_places]


def _local_range(x: DTensor, dim: int, place=None) -> Tuple[int, int]:
    """(global offset, local size) of this rank's shard of ``x`` along
    ``dim`` under ``place`` (default its own placements)."""
    shape, off = local_offset(x.shape, x.device_mesh,
                              place or x.placements)
    return off[dim], shape[dim]


def _group_slice(h0: int, nh: int, per: int, total: int) -> slice:
    """The groups (KV heads, B/C groups) that local heads [h0, h0 + nh)
    read when each group serves ``per`` consecutive heads; the local
    heads must cover whole groups or lie inside one."""
    g0, g1 = h0 // per, (h0 + nh - 1) // per + 1
    if not (nh % per == 0 and h0 % per == 0) and g1 - g0 != 1:
        raise ValueError(f"local heads {h0}..{h0 + nh} straddle groups "
                         f"of {per} heads")
    return slice(g0, min(g1, total))


# ---------------------------------------------------------- attention


def mha(q: DTensor, k, v, q_offsets, kv_lengths, *, causal: bool,
        window: Optional[int]) -> DTensor:
    """``ops.mha`` over DTensors: q (B, Lq, Hq, D) batch- and
    head-sharded as it comes; K/V (B, S, Hkv, D) follow q's batch, keep
    their heads' shards where q's heads are sharded the same way, and
    are otherwise replicated (a sequence-sharded cache is gathered);
    each rank's call takes the KV heads its query heads read."""
    from repro_torch.kernels import ops
    mesh = q.device_mesh
    k, v = as_dtensor(k, mesh), as_dtensor(v, mesh)
    qp, kp, vecp = [], [], []
    for pq, pk in zip(q.placements, k.placements):
        if pq == Shard(0):
            qp.append(pq), kp.append(Shard(0)), vecp.append(Shard(0))
        elif pq == Shard(2):
            qp.append(pq), kp.append(pk if pk == Shard(2) else R)
            vecp.append(R)
        else:
            qp.append(R), kp.append(R), vecp.append(R)
    qp, kp, vecp = tuple(qp), tuple(kp), tuple(vecp)
    h0, hq_l = _local_range(q, 2, qp)
    hq, hkv = q.shape[2], k.shape[2]
    slice_kv = any(p == Shard(2) for p in qp) and Shard(2) not in kp

    def local(ql, kl, vl, offs, lens):
        if slice_kv:
            s = _group_slice(h0, hq_l, hq // hkv, hkv)
            kl, vl = kl[:, :, s].contiguous(), vl[:, :, s].contiguous()
        return ops.mha(ql, kl, vl, offs, lens, causal=causal, window=window)

    offs = as_dtensor(q_offsets, mesh)
    lens = as_dtensor(kv_lengths, mesh)
    return run_local(local, mesh, (q, k, v, offs, lens),
                     (qp, kp, kp, vecp, vecp), qp)


def _decode_partial(q, k, v, lengths):
    """A shard's decode partial: (out (B, Hq, D), lse (B, Hq) fp32) over
    its keys [0, lengths); -inf lse and zero out on a keyless row (the
    dense decode kernel's lse on the card, the plain one's on the CPU)."""
    from repro_torch.kernels import ops
    return ops.decode(q, k, v, lengths, return_lse=True)


def merge_partials(out, lse, reduce=None):
    """The log-sum-exp merge of decode partials: ``out`` (B, Hq, D) and
    ``lse`` (B, Hq) fp32 of each partial, stacked on a leading dim that
    ``reduce(t, "max" | "sum")`` reduces (default: the local stack's dim
    0; ``_combine`` passes an all-reduce over a mesh dim): w = exp(lse -
    max), out = sum(w out) / sum(w), lse = max + log(sum(w)).  Returns
    (merged out in the partials' dtype, merged lse); a head with no key
    in any partial gets 0 and -inf."""
    if reduce is None:
        def reduce(t, op):
            return t.amax(0) if op == "max" else t.sum(0)
    m = reduce(lse, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)
    num = reduce(out.float() * w[..., None], "sum")
    den = reduce(w, "sum")
    merged = torch.where(den[..., None] > 0,
                         num / den.clamp(min=1e-30)[..., None], 0.0)
    return merged.to(out.dtype), m + torch.log(den)


def _combine(out, lse, group):
    """Merge decode partials over ``group`` by their log-sum-exp."""
    return merge_partials(
        out, lse, lambda t, op: funcol.all_reduce(t, op, group))


def decode(q: DTensor, k, v, lengths) -> DTensor:
    """``ops.decode`` over DTensors: q (B, Hq, D), cache K/V (B, S, Hkv,
    D), lengths (B,).  Over each mesh dim that shards the cache's
    sequence, q is replicated, each shard attends its keys and the
    partials are merged by log-sum-exp; a head-sharded q takes the KV
    heads its heads read."""
    from repro_torch.kernels import ops
    mesh = q.device_mesh
    k, v = as_dtensor(k, mesh), as_dtensor(v, mesh)
    qp, kp, vecp, seq_dims = [], [], [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pk == Shard(1):
            qp.append(R), kp.append(pk), vecp.append(R)
            seq_dims.append(i)
        elif pq == Shard(0) and pk == Shard(0):
            qp.append(pq), kp.append(pk), vecp.append(Shard(0))
        elif pq == Shard(1):
            qp.append(pq), kp.append(pk if pk == Shard(2) else R)
            vecp.append(R)
        elif pk == Shard(0):
            qp.append(Shard(0)), kp.append(pk), vecp.append(Shard(0))
        else:
            qp.append(R), kp.append(R), vecp.append(R)
    qp, kp, vecp = tuple(qp), tuple(kp), tuple(vecp)
    h0, hq_l = _local_range(q, 1, qp)
    s0, _ = _local_range(k, 1, kp)
    hq, hkv = q.shape[1], k.shape[2]
    slice_kv = any(p == Shard(1) for p in qp) and Shard(2) not in kp
    spread = [i for i in seq_dims if mesh.shape[i] > 1]

    def local(ql, kl, vl, lens):
        if slice_kv:
            s = _group_slice(h0, hq_l, hq // hkv, hkv)
            kl, vl = kl[:, :, s].contiguous(), vl[:, :, s].contiguous()
        if not spread:
            return ops.decode(ql, kl, vl, lens)
        lens = (lens.long() - s0).clamp(0, kl.shape[1]).to(torch.int32)
        out, lse = _decode_partial(ql, kl, vl, lens)
        for i in spread:
            out, lse = _combine(out, lse, (mesh, i))
        return out

    return run_local(local, mesh, (q, k, v, as_dtensor(lengths, mesh)),
                     (qp, kp, kp, vecp), qp)


def write_rows(cache: DTensor, new, positions) -> None:
    """``layers.write_kv_cache`` into a DTensor cache (B, S, Hkv, D), in
    place: each row's new KV (B, L, Hkv, D) at ``positions`` (B, L), each
    token on the shard that holds its position."""
    mesh = cache.device_mesh
    cp, np_, pp = [], [], []
    for pc in cache.placements:
        if pc == Shard(0):
            cp.append(pc), np_.append(pc), pp.append(pc)
        elif pc == Shard(2):
            cp.append(pc), np_.append(pc), pp.append(R)
        else:
            cp.append(pc if pc == Shard(1) else R), np_.append(R)
            pp.append(R)
    cp, np_, pp = tuple(cp), tuple(np_), tuple(pp)
    s0, s_l = _local_range(cache, 1, cp)
    seq_split = s_l != cache.shape[1]

    def local(cl, nl, pl):
        from repro_torch.models.layers import write_kv_cache
        if not seq_split:
            write_kv_cache(cl, nl, pl)
            return
        # token (b, i) is held here if its position falls in [s0, s0 +
        # s_l); every token writes the slot it clamps to, with the value
        # of the held token that writes that slot, or the slot's own
        # where none does, so writes that share a slot agree
        p = pl.long() - s0
        held = (p >= 0) & (p < s_l)
        p = p.clamp(0, s_l - 1)
        rows = torch.arange(cl.shape[0], device=cl.device)[:, None] \
            .expand_as(p)
        tok = torch.arange(p.shape[1], device=cl.device).expand_as(p)
        writer = torch.full((p.shape[0], s_l + 1), -1, dtype=torch.long,
                            device=cl.device)
        writer.scatter_(1, torch.where(held, p, s_l), tok)
        w = writer[rows, p]
        cl[rows, p] = torch.where((w >= 0)[..., None, None],
                                  nl[rows, w.clamp(min=0)].to(cl.dtype),
                                  cl[rows, p])

    run_local(local, mesh, (cache, as_dtensor(new, mesh),
                            as_dtensor(positions, mesh)),
              (cp, np_, pp), None)


def write_prefix(cache: DTensor, new) -> None:
    """``layers.write_kv_prefix`` into a DTensor cache (B, S, Hkv, D), in
    place: new (B, L, Hkv, D) into rows [0, L), each sequence shard
    taking the rows it holds."""
    mesh = cache.device_mesh
    cp, np_ = [], []
    for pc in cache.placements:
        if pc in (Shard(0), Shard(2)):
            cp.append(pc), np_.append(pc)
        else:
            cp.append(pc if pc == Shard(1) else R), np_.append(R)
    cp, np_ = tuple(cp), tuple(np_)
    s0, s_l = _local_range(cache, 1, cp)

    def local(cl, nl):
        n = min(max(nl.shape[1] - s0, 0), s_l)
        cl[:, :n].copy_(nl[:, s0:s0 + n])

    run_local(local, mesh, (cache, as_dtensor(new, mesh)), (cp, np_), None)


# ------------------------------------------------------------- SSD scan


def heads_local(fn: Callable, x: DTensor, dt, a, bg, cg, state):
    """``fn(x, dt, a, bg, cg, state) → (y, state)`` (the SSD scan, the
    decode step) over DTensors: x (B, L, NH, HD), dt (B, L, NH), a (NH,),
    B/C (B, L, G, DS), state (B, NH, HD, DS) or None, split by x's batch
    and heads; each rank takes the B/C groups its heads read."""
    mesh = x.device_mesh
    xp, dtp, ap, bp, sp = [], [], [], [], []
    for px in x.placements:
        if px == Shard(0):
            xp.append(px), dtp.append(px), ap.append(R), bp.append(px)
            sp.append(px)
        elif px == Shard(2):
            xp.append(px), dtp.append(px), ap.append(Shard(0))
            bp.append(R), sp.append(Shard(1))
        else:
            xp.append(R), dtp.append(R), ap.append(R), bp.append(R)
            sp.append(R)
    xp, dtp, ap, bp, sp = map(tuple, (xp, dtp, ap, bp, sp))
    h0, nh_l = _local_range(x, 2, xp)
    nh, g = x.shape[2], bg.shape[2]
    slice_g = any(p == Shard(2) for p in xp) and g > 1

    def local(xl, dtl, al, bl, cl, stl):
        if slice_g:
            s = _group_slice(h0, nh_l, nh // g, g)
            bl, cl = bl[:, :, s].contiguous(), cl[:, :, s].contiguous()
        return fn(xl, dtl, al, bl, cl, stl)

    args = (x, as_dtensor(dt, mesh), as_dtensor(a, mesh),
            as_dtensor(bg, mesh), as_dtensor(cg, mesh),
            as_dtensor(state, mesh))
    return run_local(local, mesh, args,
                     (xp, dtp, ap, bp, bp, None if state is None else sp),
                     (xp, sp))


# ------------------------------------------------------------------ MoE


def moe_dispatch(fn: Callable, x3: DTensor, w3, e3):
    """``fn(x (S_l, tl, d), w (S_l, tl, k), e (S_l, tl, k)) → (buf (S_l,
    E, C, d), dest, s_tok, s_w (S_l, tl·k))`` on each batch shard's
    tokens: the capacity dispatch never crosses a shard."""
    mesh = x3.device_mesh
    p = tuple(px if px == Shard(0) else R for px in x3.placements)
    return run_local(fn, mesh, (x3, as_dtensor(w3, mesh),
                                as_dtensor(e3, mesh)),
                     (p, p, p), (p, p, p, p))


def moe_combine(fn: Callable, y_exp: DTensor, dest, s_tok, s_w):
    """``fn(y_exp (S_l, E, C, d), dest, s_tok, s_w) → y (S_l, tl, d)``
    on each batch shard, over every expert (an expert-sharded y_exp is
    gathered)."""
    mesh = y_exp.device_mesh
    p = tuple(pd if pd == Shard(0) else R for pd in dest.placements)
    return run_local(fn, mesh, (y_exp, dest, s_tok, s_w),
                     (p, p, p, p), p)


def expert_ffn(fn: Callable, xe: DTensor, wg, wi, wo, gates=None):
    """The expert products over each rank's experts.  Without ``gates``:
    ``fn(xe_l, wg_l, wi_l, wo_l) → y_l`` on the dispatched buffer xe
    (S, E, C, d), batch-sharded on S, y like xe.  With ``gates`` (the
    every-expert form): ``fn(x_l, wg_l, wi_l, wo_l, gates_l) → y_l`` on
    tokens xe (T, d) and their gates (T, E), y (T, d).  The weights'
    experts dim is split as the rules place it ("experts": xe, or the
    gates, follow; "expert_mlp", each expert's FFN width: the products
    are partial sums) and their model width ("expert_embed") gathered."""
    mesh = xe.device_mesh
    wg, wi, wo = (as_dtensor(w, mesh) for w in (wg, wi, wo))
    xp, gp, wp, wop, outp = [], [], [], [], []
    for px, pw in zip(xe.placements, wg.placements):
        if px == Shard(0):                           # batch shards
            xp.append(px), gp.append(px), wp.append(R), wop.append(R)
            outp.append(px)
        elif pw == Shard(0):                         # experts split
            wp.append(pw), wop.append(pw)
            if gates is None:
                xp.append(Shard(1)), gp.append(R), outp.append(Shard(1))
            else:
                xp.append(R), gp.append(Shard(1)), outp.append(Partial())
        elif pw == Shard(2):                         # expert_mlp split
            xp.append(R), gp.append(R), wp.append(pw)
            wop.append(Shard(1)), outp.append(Partial())
        else:
            xp.append(R), gp.append(R), wp.append(R), wop.append(R)
            outp.append(R)
    xp, gp, wp, wop, outp = map(tuple, (xp, gp, wp, wop, outp))
    if gates is None:
        return run_local(fn, mesh, (xe, wg, wi, wo), (xp, wp, wp, wop),
                         outp)
    return run_local(fn, mesh, (xe, wg, wi, wo, as_dtensor(gates, mesh)),
                     (xp, wp, wp, wop, gp), outp)


# ------------------------------------------------------------- vocab


def embed(table: DTensor, tokens) -> DTensor:
    """The token embedding over a table (V, d) whose vocab may be
    sharded: each vocab shard gathers the tokens it holds, zero for the
    others (a partial sum); tokens follow their batch shards."""
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    tp, kp, outp = [], [], []
    for pt, pk in zip(table.placements, tokens.placements):
        if pt == Shard(0):
            tp.append(pt), kp.append(R), outp.append(Partial())
        elif pk == Shard(0):
            tp.append(R), kp.append(pk), outp.append(pk)
        elif pt == Shard(1):
            tp.append(pt), kp.append(R), outp.append(Shard(2))
        else:
            tp.append(R), kp.append(R), outp.append(R)
    tp, kp, outp = tuple(tp), tuple(kp), tuple(outp)
    v0, v_l = _local_range(table, 0, tp)

    def local(tl, kl):
        idx = kl.long() - v0
        held = (idx >= 0) & (idx < v_l)
        rows = tl[idx.clamp(0, v_l - 1)]
        return torch.where(held[..., None], rows, torch.zeros_like(rows))

    return run_local(local, mesh, (table, tokens), (tp, kp), outp)


# ---------------------------------------------------------------- loss


class _VocabCE(torch.autograd.Function):
    """Per-position cross-entropy over one vocab shard's logits (B, L,
    V_l) fp32 with labels (B, L): the max, the sum of exponentials and
    the gold logit are all-reduced over the vocab's mesh dims; the
    backward, exp(x - logsumexp) times the incoming gradient less it at
    the label, needs no communication (Megatron's vocab-parallel loss).
    Its arithmetic is ``torch.logsumexp``'s and its backward's, so over
    one shard the loss and its gradient are the plain path's bit for
    bit."""

    @staticmethod
    def forward(ctx, logits, labels, v0, groups):
        m = logits.amax(dim=-1)
        for grp in groups:
            m = funcol.all_reduce(m, "max", grp)
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        se = torch.exp(logits - m[..., None]).sum(-1)
        idx = labels.long() - v0
        held = (idx >= 0) & (idx < logits.shape[-1])
        idx = idx.clamp(0, logits.shape[-1] - 1)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = torch.where(held, gold, torch.zeros_like(gold))
        for grp in groups:
            se = funcol.all_reduce(se, "sum", grp)
            gold = funcol.all_reduce(gold, "sum", grp)
        logz = torch.log(se) + m
        ctx.save_for_backward(logits, logz, idx, held)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, held = ctx.saved_tensors
        gx = g[..., None] * torch.exp(logits - logz[..., None])
        gx.scatter_add_(-1, idx[..., None],
                        torch.where(held, -g, torch.zeros_like(g))[..., None])
        return gx, None, None, None


def token_nll(logits: DTensor, labels) -> DTensor:
    """Each position's negative log-likelihood (B, L) fp32, ``logsumexp
    - gold logit``, from logits (B, L, V) whose vocab may be sharded
    (``_VocabCE`` on each shard); positions follow the batch shards."""
    mesh = logits.device_mesh
    lp, yp, outp, groups = [], [], [], []
    for i, pl in enumerate(logits.placements):
        if pl == Shard(2):
            lp.append(pl), yp.append(R), outp.append(R)
            groups.append((mesh, i))
        elif pl in (Shard(0), Shard(1)):
            lp.append(pl), yp.append(pl), outp.append(pl)
        else:
            lp.append(R), yp.append(R), outp.append(R)
    lp, yp, outp = tuple(lp), tuple(yp), tuple(outp)
    v0, _ = _local_range(logits, 2, lp)

    def local(ll, yl):
        return _VocabCE.apply(ll, yl, v0, groups)

    return run_local(local, mesh, (logits, as_dtensor(labels, mesh)),
                     (lp, yp), outp)


def total(x: DTensor) -> DTensor:
    """The sum of every element of ``x``: each rank sums its shard (a
    partial sum over the mesh dims that shard ``x``), so the backward
    hands each shard its own gradient instead of replicating it."""
    mesh = x.device_mesh
    xp = tuple(R if isinstance(p, Partial) else p for p in x.placements)
    outp = tuple(Partial() if isinstance(p, Shard) else R for p in xp)
    return run_local(lambda t: t.sum(), mesh, (x,), (xp,), outp)
