// Slot-arena ragged prefill flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_prefill.py::
// ragged_prefill_arena (pallas_call at :500): the packed prefill of
// ragged_prefill.cuh, causal or not (causal = 1 or 0), over the whole
// per-layer KV arena (N_slots, S_max, Hkv, D), read in place; segment
// b's keys are row slot_map[b] of the arena.  The step has already
// written its new KV rows at each token's (slot, position), and pad and
// tail rows at the park row S_max - 1 of a live slot; the key walk stops
// at min(kv_len, causal frontier), or at kv_len when non-causal, so the
// park row and every row past kv_len are never read.  A pad segment
// (cu[b] == cu[b+1], kv_len 0, slot_map pointing at a live slot) owns no
// rows and reads nothing.  S_max need not be a
// multiple of the key tile: the last tile is masked by position.
//
// window > 0 selects the TPU kernel's window= form (body _arena_kernel,
// ragged_prefill.py:218): each slot is then a ROLLING cache of depth
// S_max (attn_common.cuh RollingLayout), position p at row p % S_max, so
// it holds the newest min(kv_len, S_max) positions; each row attends
// those in (its position - window, its position].  The step wrote its
// rows at position % S_max, and pads on the scratch slot, which no
// segment reads.
#include "ragged_prefill.cuh"

extern "C" int ragged_prefill_arena_launch(
    const void* q, const void* k, const void* v, const void* slot_map,
    const void* cu_seqlens, const void* q_offsets, const void* kv_lengths,
    void* out, int n_rows, int hq, int hkv, int head_dim, int s_max,
    int n_seqs, int causal, int window, int dtype, void* stream) {
  const int* sm = static_cast<const int*>(slot_map);
  if (window > 0)
    return attn::prefill::entry(q, k, v, attn::RollingLayout{sm, s_max},
                                cu_seqlens, q_offsets, kv_lengths, out,
                                n_rows, hq, hkv, head_dim, n_seqs, causal,
                                window, dtype, stream);
  return attn::prefill::entry(q, k, v, attn::SlotLayout{sm, s_max},
                              cu_seqlens, q_offsets, kv_lengths, out,
                              n_rows, hq, hkv, head_dim, n_seqs, causal, 0,
                              dtype, stream);
}
