// Dense (B, Lq) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attn
// (pallas_call at :140): prefill and re-prefill attention of the dense
// (L, B) grid, and the non-causal attention of an encoder layer.  For
// batch row b, query row i sits at position q_offsets[b] + i and attends
// the keys of cache row b at positions p < kv_lengths[b] that also pass
// p <= its position (causal) and p > its position - window (window > 0).
// GQA maps query head h to KV head h / rep without duplicating KV;
// softmax is online in fp32; p is rounded to the storage type before the
// PV product, as `p.astype(v.dtype)` does (flash_attn.py:87); a row with
// no valid key writes exactly 0.
//
// What bounds it: ~4·K·D FLOPs per query row and head over its K keys,
// against q, the band of KV and the output read or written once.  At
// the grid's shapes (64 queries over a 320-key history, 32 query heads,
// D = 128) that is ~130 FLOPs per byte, below the ~295 FLOP/byte ridge,
// so the least time is set by the bytes; in an encoder layer (1500
// frames over 1500 keys, 16 heads, D = 80) by the operations.  This
// first design is simple and right rather than fast: scalar fp32 FMAs
// from shared memory on the CUDA cores, no tensor cores (wgmma and TMA
// are later work), so its own limit is the CUDA cores' FMA rate in both.
// What it keeps from the TPU design: each K/V tile loaded into shared
// memory serves every query row of the block times the rep query heads
// of its KV group, and key tiles outside the rows' band are never
// loaded — past kv_lengths[b], past the causal frontier of the block's
// last row, before the window of its first row (flash_attn.py:56-59).
// The band also bounds every read: a dummy depth row whose offset is
// the park position S - 1 runs its queries past S, and kv_lengths[b]
// (at most S) still stops its key walk.
//
// Layout of the work: one block per (tile of query rows, KV head g,
// batch row b); the block holds rows_per_block = 32 / rep query rows of
// the rep query heads of group g, <= 32 query vectors (rep 5 leaves two
// idle).  Four threads share each query vector: each scores 8 keys of a
// 32-key tile and owns D / 4 output columns.  Head widths 64, 80, 96 and
// 128 (every config of src/repro/configs/) are instantiated; D = 80 and
// 96 rows load as 10 and 12 bf16 vectors, which the tile loader splits
// over the block with a ragged last round.
#include "attn_common.cuh"

namespace attn {
namespace flash {

constexpr int kThreads = 128;
constexpr int kMaxQ = kThreads / 4;   // query vectors per block
constexpr int kKT = 32;               // keys per shared-memory tile
constexpr int kMaxRep = 8;            // query heads per KV group

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kMaxQ * (D + 1) + kKT * (D + 1) + kKT * D + kMaxQ * (kKT + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                  const T* __restrict__ vbuf,
                  const int* __restrict__ q_offsets,
                  const int* __restrict__ kv_lengths, T* __restrict__ out,
                  int lq, int s, int hq, int hkv, int causal, int window,
                  int rows_per_block) {
  static_assert(D % 16 == 0, "head widths 64, 80, 96, 128");
  extern __shared__ float smem[];
  float* qs = smem;                      // [kMaxQ][D + 1]
  float* ks = qs + kMaxQ * (D + 1);      // [kKT][D + 1]
  float* vs = ks + kKT * (D + 1);        // [kKT][D]
  float* ps = vs + kKT * D;              // [kMaxQ][kKT + 1]

  const int tid = threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv;
  const int r0 = blockIdx.x * rows_per_block;
  const int r_end = min(r0 + rows_per_block, lq);
  const int nq = rows_per_block * rep;
  const float scale = rsqrtf(static_cast<float>(D));

  for (int idx = tid; idx < kMaxQ * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int row = r0 + i / rep;
    float val = 0.f;
    if (i < nq && row < lq) {
      const int h = g * rep + i % rep;
      val = to_f(q[((static_cast<size_t>(b) * lq + row) * hq + h) * D + d]);
    }
    qs[i * (D + 1) + d] = val;
  }

  const int qi = tid >> 2;               // this thread's query vector
  const int sub = tid & 3;               // its quarter of keys and of D
  const int my_row = r0 + qi / rep;
  const bool live = qi < nq && my_row < lq;
  const int off = q_offsets[b];
  const int qpos = off + my_row;
  // the band of keys any row of the block attends: [lo, hi)
  int hi = min(max(kv_lengths[b], 0), s);
  if (causal) hi = min(hi, off + r_end);  // last row's frontier + 1
  const int lo = window > 0 ? max(0, off + r0 - window + 1) : 0;
  const SlotRows rows{static_cast<size_t>(b) * s};

  float m_i = kNegInf, l_i = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int k = 0; k < D / 4; ++k) acc[k] = 0.f;

  for (int base = lo; base < hi; base += kKT) {   // block-uniform
    __syncthreads();                   // q staged / previous tile consumed
    load_kv_tile<T, D, kKT, kThreads>(kbuf, vbuf, rows, base, hi, hkv, g,
                                      tid, ks, vs);
    __syncthreads();

    float sc[kKT / 4];
    bool ok[kKT / 4];
    float tmax = kNegInf;
#pragma unroll
    for (int m = 0; m < kKT / 4; ++m) {
      const int j = sub + 4 * m;
      const int pos = base + j;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        dot += qs[qi * (D + 1) + d] * ks[j * (D + 1) + d];
      ok[m] = live && pos < hi && (!causal || pos <= qpos) &&
              (window <= 0 || pos > qpos - window);
      sc[m] = ok[m] ? dot * scale : kNegInf;
      tmax = fmaxf(tmax, sc[m]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);
    float psum = 0.f;
#pragma unroll
    for (int m = 0; m < kKT / 4; ++m) {
      const int j = sub + 4 * m;
      const float p = ok[m] ? expf(sc[m] - m_new) : 0.f;
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

  if (live) {
    const int h = g * rep + qi % rep;
    const float inv = 1.f / (l_i == 0.f ? 1.f : l_i);
    T* o = out + ((static_cast<size_t>(b) * lq + my_row) * hq + h) * D;
#pragma unroll
    for (int k = 0; k < D / 4; ++k) o[sub + 4 * k] = from_f<T>(acc[k] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const void* q_offsets, const void* kv_lengths, void* out,
           int n_batch, int lq, int s, int hq, int hkv, int causal,
           int window, cudaStream_t stream) {
  auto kern = flash_attn_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kMaxQ / (hq / hkv);
  dim3 grid((lq + rows_per_block - 1) / rows_per_block, hkv, n_batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_offsets),
      static_cast<const int*>(kv_lengths), static_cast<T*>(out), lq, s, hq,
      hkv, causal, window, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(const void* q, const void* k, const void* v,
             const void* q_offsets, const void* kv_lengths, void* out,
             int n_batch, int lq, int s, int hq, int hkv, int head_dim,
             int causal, int window, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, q_offsets, kv_lengths, out, n_batch, lq,
                           s, hq, hkv, causal, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, q_offsets, kv_lengths, out, n_batch, lq,
                           s, hq, hkv, causal, window, stream);
    case 96:
      return launch<T, 96>(q, k, v, q_offsets, kv_lengths, out, n_batch, lq,
                           s, hq, hkv, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_offsets, kv_lengths, out, n_batch,
                            lq, s, hq, hkv, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
}  // namespace attn

// q: (B, Lq, Hq, D); k, v: (B, S, Hkv, D); q_offsets, kv_lengths: (B,)
// int32; out: (B, Lq, Hq, D).  causal: 0 or 1; window: 0 for none, else
// the band width.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaGetLastError() (0 on success); never synchronises.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, const void* q_offsets,
    const void* kv_lengths, void* out, int n_batch, int lq, int s, int hq,
    int hkv, int head_dim, int causal, int window, int dtype,
    void* stream) {
  using namespace attn::flash;
  auto st = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || n_batch <= 0 ||
      n_batch > 65535 || lq <= 0 || s <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return by_width<__nv_bfloat16>(q, k, v, q_offsets, kv_lengths, out,
                                   n_batch, lq, s, hq, hkv, head_dim, causal,
                                   window, st);
  if (dtype == 0)
    return by_width<float>(q, k, v, q_offsets, kv_lengths, out, n_batch, lq,
                           s, hq, hkv, head_dim, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
