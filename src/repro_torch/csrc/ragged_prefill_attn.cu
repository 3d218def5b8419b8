// Batch-cache ragged prefill flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_prefill.py::
// ragged_prefill_attn (pallas_call at :205): the packed prefill of
// ragged_prefill.cuh, causal or not (causal = 1 or 0), over a gathered
// per-segment cache (B, S, Hkv, D), segment b reading row b.  It serves
// the gathered slot-arena baseline (arena_prefill=False), whose caches
// are whole arena slots copied out before the step and back after it.
// The key walk stops at min(kv_len, causal frontier), or at kv_len when
// non-causal, so the park position S - 1 that tail rows write is never
// read; S need not be a multiple of the key tile (the TPU kernel pads
// it, this one masks the last tile by position).
#include "ragged_prefill.cuh"

extern "C" int ragged_prefill_attn_launch(
    const void* q, const void* k, const void* v, const void* cu_seqlens,
    const void* q_offsets, const void* kv_lengths, void* out, int n_rows,
    int hq, int hkv, int head_dim, int s_max, int n_seqs, int causal,
    int dtype, void* stream) {
  const attn::SlotLayout layout{nullptr, s_max};
  return attn::prefill::entry(q, k, v, layout, cu_seqlens, q_offsets,
                              kv_lengths, out, n_rows, hq, hkv, head_dim,
                              n_seqs, causal, 0, dtype, stream);
}
