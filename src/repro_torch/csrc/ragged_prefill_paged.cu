// Paged ragged prefill flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_prefill.py::
// ragged_prefill_paged (pallas_call at :401): the packed prefill of
// ragged_prefill.cuh, causal or not (causal = 1 or 0), with each
// segment reading its KV through a page table (B, P_max) into shared
// page pools (N_pages + 1, page_size, Hkv, D).  page_table[b, i] is
// read only for key positions < kv_lengths[b], so it is never
// dereferenced for i >= ceil(kv_len_b / page_size) (entries past the
// valid length may point anywhere).
//
// window > 0 selects the TPU kernel's window= form: the table is then a
// RING over its P_max entries (attn_common.cuh RingLayout), position p
// on entry (p / page_size) % P_max, so it holds the newest
// min(kv_len, P_max * page_size) positions; each row attends those in
// (its position - window, its position].  The walk covers logical
// positions from the window's lower edge (and never below kv_len -
// P_max * page_size) and reads each through the ring, so the entries it
// dereferences are those of the ring's live pages only.
//
// With no window, in bf16 at head_dim 128 over pages of 8, 16, 32 or 64
// tokens (attn::tma_core) the launch takes the TMA-fed kernel
// (ragged_prefill.cuh launch_tma): the pools are then read through
// tensor maps over their n_pages * page_size rows.
#include "ragged_prefill.cuh"

extern "C" int ragged_prefill_paged_launch(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* cu_seqlens, const void* q_offsets, const void* kv_lengths,
    void* out, int n_rows, int hq, int hkv, int head_dim, int page_size,
    int n_pages, int n_seqs, int p_max, int causal, int window, int dtype,
    void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  if (attn::tma_core(window, dtype, head_dim, page_size))
    return attn::prefill::launch_tma(
        q, k, v, attn::PagedLayout{pt, page_size, p_max}, n_pages,
        cu_seqlens, q_offsets, kv_lengths, out, n_rows, hq, hkv, n_seqs,
        causal, static_cast<cudaStream_t>(stream));
  if (window > 0)
    return attn::prefill::entry(q, k, v,
                                attn::RingLayout{pt, page_size, p_max},
                                cu_seqlens, q_offsets, kv_lengths, out,
                                n_rows, hq, hkv, head_dim, n_seqs, causal,
                                window, dtype, stream);
  return attn::prefill::entry(q, k, v,
                              attn::PagedLayout{pt, page_size, p_max},
                              cu_seqlens, q_offsets, kv_lengths, out,
                              n_rows, hq, hkv, head_dim, n_seqs, causal, 0,
                              dtype, stream);
}

// The launch facts of the kernel at head_dim and dtype over a page table
// (attn_common.cuh kernel_info): out[0] shared bytes a block, out[1]
// registers a thread, out[2] blocks resident per SM.
extern "C" int ragged_prefill_paged_info(int head_dim, int dtype, void* out) {
  return attn::prefill::info<attn::PagedLayout>(head_dim, dtype,
                                               static_cast<int*>(out));
}

// The same facts of the TMA-fed kernel (bf16, head_dim 128, no window).
extern "C" int ragged_prefill_paged_tma_info(void* out) {
  return attn::prefill::tma_info(static_cast<int*>(out));
}
