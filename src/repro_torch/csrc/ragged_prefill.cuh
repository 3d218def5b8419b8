// Ragged (packed, padding-free) causal prefill flash attention for Hopper
// (sm_90a), over any KV layout of attn_common.cuh.  Each of
// ragged_prefill_paged.cu, ragged_prefill_arena.cu and
// ragged_prefill_attn.cu instantiates it for its layout and exports one C
// entry point.
//
// Computes, for a packed flat token stream q (T, Hq, D) whose segments
// are given by cu_seqlens (B+1,): every row of segment b attends its
// segment's keys at positions < kv_lengths[b] and <= its own position
// q_offsets[b] + (row - cu_seqlens[b]).  GQA maps query head h to KV
// head h / rep; softmax is online in fp32; p is rounded to the storage
// type before the PV product; rows past cu_seqlens[B] and rows with no
// valid key write exactly 0.
//
// What bounds it: at the main-path shapes (a 512-row chunk over 2048
// keys, 32 query heads, D = 128) the work is ~4·T·K·D·Hq ≈ 15 GFLOP
// against ~16 MB of q, KV and output, so the card's operation rate
// bounds it, far above the ~295 FLOP/byte ridge.  This first design is
// simple and right rather than fast: scalar fp32 FMAs from shared memory
// on the CUDA cores (67 TFLOP/s peak), no tensor cores; K/V tiles arrive
// as 16-byte vector loads, several in flight per thread.  What it does
// keep from the TPU design: each K/V tile loaded into shared memory is
// used by every query row of the block times the rep = Hq / Hkv query
// heads of its KV group, so KV bytes are read from device memory once
// per block and not once per query head.  wgmma tiles are later work.
//
// Layout of the work: one block per (tile of rows_per_block stream
// rows, KV head g); the block holds rows_per_block · rep <= 32 query
// vectors.  A tile that straddles segments walks each overlapping
// segment in turn; a segment that owns no row of the tile (a pad
// segment with cu[b] == cu[b+1]) costs one comparison.  For segment b
// it streams key positions 0 .. min(kv_len, causal frontier of its last
// row) - 1 in tiles of 32, so no row at or past kv_len is ever read:
// page-table entries past the valid length, and an arena slot's park
// row S_max - 1 that pad and tail rows write in the same step, may hold
// anything.  Four threads share each query vector: each scores 8 keys
// of a tile and owns D / 4 output columns.  Segment counts are small
// (<= 16), so the per-block segment loop is short; nothing is sized by
// T x B.
#pragma once

#include "attn_common.cuh"

namespace attn {
namespace prefill {

constexpr int kThreads = 128;
constexpr int kMaxQ = kThreads / 4;   // query vectors per block
constexpr int kKT = 32;               // keys per shared-memory tile

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kMaxQ * (D + 1) + kKT * (D + 1) + kKT * D + kMaxQ * (kKT + 1));
}

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kThreads)
ragged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                      const T* __restrict__ vbuf, Layout layout,
                      const int* __restrict__ cu_seqlens,
                      const int* __restrict__ q_offsets,
                      const int* __restrict__ kv_lengths,
                      T* __restrict__ out, int n_rows, int hq, int hkv,
                      int n_seqs, int rows_per_block) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kMaxQ][D + 1]
  float* ks = qs + kMaxQ * (D + 1);      // [kKT][D + 1]
  float* vs = ks + kKT * (D + 1);        // [kKT][D]
  float* ps = vs + kKT * D;              // [kMaxQ][kKT + 1]

  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int rep = hq / hkv;
  const int r0 = blockIdx.x * rows_per_block;
  const int r_end = min(r0 + rows_per_block, n_rows);
  const int nq = rows_per_block * rep;
  const float scale = rsqrtf(static_cast<float>(D));

  for (int idx = tid; idx < kMaxQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int row = r0 + i / rep;
    float val = 0.f;
    if (i < nq && row < n_rows) {
      const int h = g * rep + i % rep;
      val = to_f(q[(static_cast<size_t>(row) * hq + h) * D + d]);
    }
    qs[i * (D + 1) + d] = val;
  }

  const int qi = tid >> 2;               // this thread's query vector
  const int sub = tid & 3;               // its quarter of keys and of D
  const int my_row = r0 + qi / rep;
  const bool live = qi < nq && my_row < n_rows;
  float m_i = kNegInf, l_i = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int k = 0; k < D / 4; ++k) acc[k] = 0.f;

  for (int b = 0; b < n_seqs; ++b) {
    const int s0 = cu_seqlens[b], s1 = cu_seqlens[b + 1];
    const int lo = max(s0, r0), hi = min(s1, r_end);
    if (lo >= hi) continue;              // block-uniform
    const int off = q_offsets[b];
    const int kvl = min(kv_lengths[b], layout.capacity());
    // keys past the causal frontier of the tile's last row of b, or
    // past kv_len, are never loaded
    const int n_keys = min(kvl, off + (hi - 1 - s0) + 1);
    if (n_keys <= 0) continue;           // block-uniform
    const bool mine = live && my_row >= lo && my_row < hi;
    const int qpos = off + (my_row - s0);
    const auto rows = layout.rows(b);

    for (int base = 0; base < n_keys; base += kKT) {
      __syncthreads();                   // previous tile fully consumed
      load_kv_tile<T, D, kKT, kThreads>(kbuf, vbuf, rows, base, n_keys, hkv,
                                        g, tid, ks, vs);
      __syncthreads();

      float s[kKT / 4];
      float tmax = kNegInf;
#pragma unroll
      for (int m = 0; m < kKT / 4; ++m) {
        const int j = sub + 4 * m;
        const int pos = base + j;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d)
          dot += qs[qi * (D + 1) + d] * ks[j * (D + 1) + d];
        const bool ok = mine && pos < n_keys && pos <= qpos;
        s[m] = ok ? dot * scale : kNegInf;
        tmax = fmaxf(tmax, s[m]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_i, tmax);
      float psum = 0.f;
#pragma unroll
      for (int m = 0; m < kKT / 4; ++m) {
        const int j = sub + 4 * m;
        const int pos = base + j;
        const bool ok = mine && pos < n_keys && pos <= qpos;
        const float p = ok ? expf(s[m] - m_new) : 0.f;
        psum += p;
        ps[qi * (kKT + 1) + j] = round_p<T>(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float alpha = expf(m_i - m_new);
      l_i = alpha * l_i + psum;
      m_i = m_new;
      __syncwarp();                      // the 4 sharers of qi are one warp
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        const int d = sub + 4 * k;
        float a = acc[k] * alpha;
#pragma unroll 8
        for (int j = 0; j < kKT; ++j)
          a += ps[qi * (kKT + 1) + j] * vs[j * D + d];
        acc[k] = a;
      }
    }
  }

  if (live) {
    const int h = g * rep + qi % rep;
    const float inv = 1.f / (l_i == 0.f ? 1.f : l_i);
    T* o = out + (static_cast<size_t>(my_row) * hq + h) * D;
#pragma unroll
    for (int k = 0; k < D / 4; ++k) o[sub + 4 * k] = from_f<T>(acc[k] * inv);
  }
}

template <typename T, int D, typename Layout>
int launch(const void* q, const void* k, const void* v, Layout layout,
           const void* cu_seqlens, const void* q_offsets,
           const void* kv_lengths, void* out, int n_rows, int hq, int hkv,
           int n_seqs, cudaStream_t stream) {
  auto kern = ragged_prefill_kernel<T, D, Layout>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kMaxQ / (hq / hkv);
  dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const int*>(cu_seqlens),
      static_cast<const int*>(q_offsets), static_cast<const int*>(kv_lengths),
      static_cast<T*>(out), n_rows, hq, hkv, n_seqs, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaGetLastError() (0 on success); never synchronises.
template <typename Layout>
int entry(const void* q, const void* k, const void* v, Layout layout,
          const void* cu_seqlens, const void* q_offsets,
          const void* kv_lengths, void* out, int n_rows, int hq, int hkv,
          int head_dim, int n_seqs, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxQ || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 128 && dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, layout, cu_seqlens, q_offsets,
                                      kv_lengths, out, n_rows, hq, hkv,
                                      n_seqs, s);
  if (head_dim == 128 && dtype == 0)
    return launch<float, 128>(q, k, v, layout, cu_seqlens, q_offsets,
                              kv_lengths, out, n_rows, hq, hkv, n_seqs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace prefill
}  // namespace attn
