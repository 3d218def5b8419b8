// Slot-arena flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attn_arena
// (pallas_call at :373): the flash decode of decode_attn.cuh over the
// whole per-layer KV arena (N_slots, S_max, Hkv, D), read in place; row
// b's keys are slot slot_map[b], and it reads only that slot's first
// lengths[b] rows, so a decode tick streams O(cached length) per row
// and never the slot's park row S_max - 1.  Decode-ladder pad rows
// (lengths 1, slot_map naming a live slot) read one key and their
// output is discarded.  S_max need not be a multiple of the key tile;
// the chunk plan spans S_max keys.
//
// window > 0 selects the TPU kernel's window= form (body _arena_kernel,
// decode_attn.py:146): each slot is a ROLLING cache of depth S_max
// (attn_common.cuh RollingLayout), position p at row p % S_max, and each
// row attends its newest min(window, S_max, lengths[b]) keys, so a tick
// streams O(min(cached, window)) rows per row; the chunk plan spans
// min(window, S_max) keys.  Pad rows name the scratch slot.
#include "decode_attn.cuh"

extern "C" int decode_attn_arena_launch(
    const void* q, const void* k, const void* v, const void* slot_map,
    const void* lengths, void* out, void* ws, int n_rows, int hq, int hkv,
    int head_dim, int s_max, int chunk, int n_chunks, int window, int dtype,
    void* stream) {
  const int* sm = static_cast<const int*>(slot_map);
  if (window > 0)
    return attn::decode::entry(q, k, v, attn::RollingLayout{sm, s_max},
                               lengths, out, ws, nullptr, n_rows, hq, hkv,
                               head_dim, chunk, n_chunks, window, dtype,
                               stream);
  return attn::decode::entry(q, k, v, attn::SlotLayout{sm, s_max}, lengths,
                             out, ws, nullptr, n_rows, hq, hkv, head_dim,
                             chunk, n_chunks, 0, dtype, stream);
}
