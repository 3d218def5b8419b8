// Paged flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attn_paged
// (pallas_call at :290): the flash decode of decode_attn.cuh with each
// row reading its KV through a page table (B, P_max) into shared page
// pools (N_pages + 1, page_size, Hkv, D).  page_table[b, i] is read only
// for key positions < lengths[b], and only by the blocks whose key chunk
// holds them, so it is never dereferenced for i >= ceil(lengths[b] /
// page_size) (entries past the valid length may point anywhere).  The
// chunk plan spans the table's capacity, P_max * page_size keys.
#include "decode_attn.cuh"

extern "C" int decode_attn_paged_launch(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* lengths, void* out, void* ws, int n_rows, int hq, int hkv,
    int head_dim, int page_size, int p_max, int chunk, int n_chunks,
    int dtype, void* stream) {
  const attn::PagedLayout layout{static_cast<const int*>(page_table),
                                 page_size, p_max};
  return attn::decode::entry(q, k, v, layout, lengths, out, ws, n_rows, hq,
                             hkv, head_dim, chunk, n_chunks, dtype, stream);
}
