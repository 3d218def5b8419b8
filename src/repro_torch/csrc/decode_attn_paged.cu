// Paged flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attn_paged
// (pallas_call at :290): the flash decode of decode_attn.cuh with each
// row reading its KV through a page table (B, P_max) into shared page
// pools (N_pages + 1, page_size, Hkv, D).  page_table[b, i] is read only
// for key positions < lengths[b], and only by the blocks whose key chunk
// holds them, so it is never dereferenced for i >= ceil(lengths[b] /
// page_size) (entries past the valid length may point anywhere).  The
// chunk plan spans the table's depth, P_max * page_size keys.
//
// window > 0 selects the TPU kernel's window= form: the table is a RING
// over its P_max entries (attn_common.cuh RingLayout) and each row
// attends its newest min(window, P_max * page_size, lengths[b]) keys,
// each read through entry (p / page_size) % P_max.  The chunk plan then
// spans min(window, P_max * page_size) keys, the most a row's range can
// hold; the TPU kernel streams (window - 1) / block_k + 2 blocks
// (decode_attn.py:253).
#include "decode_attn.cuh"

extern "C" int decode_attn_paged_launch(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* lengths, void* out, void* ws, int n_rows, int hq, int hkv,
    int head_dim, int page_size, int p_max, int chunk, int n_chunks,
    int window, int dtype, void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  if (window > 0)
    return attn::decode::entry(q, k, v,
                               attn::RingLayout{pt, page_size, p_max},
                               lengths, out, ws, nullptr, n_rows, hq, hkv,
                               head_dim, chunk, n_chunks, window, dtype,
                               stream);
  return attn::decode::entry(q, k, v, attn::PagedLayout{pt, page_size, p_max},
                             lengths, out, ws, nullptr, n_rows, hq, hkv,
                             head_dim, chunk, n_chunks, 0, dtype, stream);
}

// The launch facts of the split kernel at head_dim and dtype over a page
// table (attn_common.cuh kernel_info): out[0] shared bytes a block, out[1]
// registers a thread, out[2] blocks resident per SM.
extern "C" int decode_attn_paged_info(int head_dim, int dtype, void* out) {
  return attn::decode::info<attn::PagedLayout>(head_dim, dtype,
                                              static_cast<int*>(out));
}
