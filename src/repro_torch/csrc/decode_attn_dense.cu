// Batch-cache flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attn
// (pallas_call at :123): the flash decode of decode_attn.cuh over a
// gathered batch cache (B, S, Hkv, D) in the batch-row layout, row b
// reading cache row b, as the reference shares one body between
// decode_attn and decode_attn_arena.  It serves the dense decode step
// (arena_decode=False), whose caches are whole arena slots copied out
// before the step and back after it: row b reads only its first
// lengths[b] positions, so the step streams O(cached length) of each
// row and never the rest of its S_max-deep copy.  S need not be a
// multiple of the key tile; the chunk plan spans S keys.
//
// lse: null, or (n_rows, hq) fp32, each query head's log-sum-exp of its
// scaled scores (-inf on a row with no key): a shard of a KV cache
// sharded over its sequence attends its own keys and the shards'
// partials are merged by their lse (distributed/local.py decode).
#include "decode_attn.cuh"

extern "C" int decode_attn_dense_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* ws, void* lse, int n_rows, int hq, int hkv,
    int head_dim, int s, int chunk, int n_chunks, int dtype, void* stream) {
  const attn::SlotLayout layout{nullptr, s};
  return attn::decode::entry(q, k, v, layout, lengths, out, ws, lse, n_rows,
                             hq, hkv, head_dim, chunk, n_chunks, 0, dtype,
                             stream);
}
