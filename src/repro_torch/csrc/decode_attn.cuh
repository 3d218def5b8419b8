// Flash decode for Hopper (sm_90a), over any KV layout of
// attn_common.cuh.  decode_attn_paged.cu and decode_attn_arena.cu each
// instantiate it for their layout and export one C entry point.
//
// Computes one query token per row b: the rep = Hq / Hkv query heads of
// each KV group attend over the row's keys at positions < lengths[b].
// Softmax is online in fp32, p is rounded to the storage type before
// the PV product, and a row with lengths == 0 writes 0.
//
// What bounds it: decode reads every cached key and value of the row
// once and does ~4·rep·D FLOPs per key and KV head, about rep / 2 = 2
// FLOP per byte in bf16, far below the ~295 FLOP/byte ridge, so device
// memory bandwidth bounds it.  The design does two things about that:
// the rep query heads of a KV group share each tile load (one block per
// (row, KV head), so KV bytes are read once, not rep times), and the
// key walk of a row is split across the block's 4 warps (warp w takes
// key tiles w, w + 4, ...), each keeping its own (m, l, acc) and merging
// them at the end, so a long row keeps four independent load streams in
// flight, each lane issuing several 16-byte loads at once.  Tiles go
// through shared memory synchronously; asynchronous copies (cp.async /
// TMA) overlapping the next tile with this one's math are later work.
//
// No row at or past lengths[b] is ever read: page-table entries past
// the valid length, and an arena slot's rows past it, may hold anything.
#pragma once

#include "attn_common.cuh"

namespace attn {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;    // query heads per KV group held per block
constexpr int kKT = 16;       // keys per warp tile

template <int D>
__host__ __device__ constexpr int warp_floats() {
  return kKT * (D + 1) + kKT * D + kMaxRep * kKT;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (kMaxRep * D + kWarps * warp_floats<D>());
}

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                   const T* __restrict__ vbuf, Layout layout,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int hq, int hkv) {
  static_assert(D % 32 == 0 && D >= 32, "head_dim must be a multiple of 32");
  static_assert(kWarps * kMaxRep * (D + 2) <=
                    kMaxRep * D + kWarps * warp_floats<D>(),
                "merge buffers must fit in the tile buffers");
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem;                                        // [kMaxRep][D]
  float* ks = qs + kMaxRep * D + warp * warp_floats<D>();  // [kKT][D + 1]
  float* vs = ks + kKT * (D + 1);                          // [kKT][D]
  float* ps = vs + kKT * D;                                // [kMaxRep][kKT]

  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = hq / hkv;
  const float scale = rsqrtf(static_cast<float>(D));
  for (int idx = threadIdx.x; idx < kMaxRep * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    qs[idx] = i < rep
        ? to_f(q[(static_cast<size_t>(b) * hq + g * rep + i) * D + d])
        : 0.f;
  }
  __syncthreads();

  const int n_keys = min(max(lengths[b], 0), layout.capacity());
  const auto rows = layout.rows(b);
  // score phase: lane (j, half) dots key j of the tile with half of D;
  // half 1 walks its columns rotated by 16 so the two halves never hit
  // the same shared-memory bank
  const int j = lane & 15, half = lane >> 4;
  constexpr int kHalf = D / 2;

  float m_i[kMaxRep], l_i[kMaxRep], acc[kMaxRep][D / 32];
#pragma unroll
  for (int i = 0; i < kMaxRep; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int k = 0; k < D / 32; ++k) acc[i][k] = 0.f;
  }

  for (int base = warp * kKT; base < n_keys; base += kWarps * kKT) {
    load_kv_tile<T, D, kKT, 32>(kbuf, vbuf, rows, base, n_keys, hkv, g, lane,
                                ks, vs);
    __syncwarp();
    const bool ok = base + j < n_keys;
    float alpha[kMaxRep];
#pragma unroll
    for (int i = 0; i < kMaxRep; ++i) {
      alpha[i] = 1.f;
      if (i < rep) {                     // warp-uniform
        float dot = 0.f;
#pragma unroll 16
        for (int t = 0; t < kHalf; ++t) {
          const int d = half ? kHalf + (t + 16) % kHalf : t;
          dot += qs[i * D + d] * ks[j * (D + 1) + d];
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 16);
        const float s = ok ? dot * scale : kNegInf;
        float tmax = s;
#pragma unroll
        for (int w = 1; w < 16; w <<= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
        const float m_new = fmaxf(m_i[i], tmax);
        const float p = ok ? expf(s - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int w = 1; w < 16; w <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, w);
        alpha[i] = expf(m_i[i] - m_new);
        l_i[i] = alpha[i] * l_i[i] + psum;
        m_i[i] = m_new;
        if (half == 0) ps[i * kKT + j] = round_p<T>(p);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxRep; ++i) {
      if (i < rep) {
#pragma unroll
        for (int k = 0; k < D / 32; ++k) {
          const int d = lane + 32 * k;
          float a = acc[i][k] * alpha[i];
#pragma unroll
          for (int jj = 0; jj < kKT; ++jj) a += ps[i * kKT + jj] * vs[jj * D + d];
          acc[i][k] = a;
        }
      }
    }
    __syncwarp();                        // tile buffers free for the next
  }

  // merge the warps' partial (m, l, acc) of each query head
  __syncthreads();
  float* ml = smem;                        // [kWarps][kMaxRep][2]
  float* accs = smem + kWarps * kMaxRep * 2;  // [kWarps][kMaxRep][D]
#pragma unroll
  for (int i = 0; i < kMaxRep; ++i) {
    if (i < rep) {
      if (lane == 0) {
        ml[(warp * kMaxRep + i) * 2] = m_i[i];
        ml[(warp * kMaxRep + i) * 2 + 1] = l_i[i];
      }
#pragma unroll
      for (int k = 0; k < D / 32; ++k)
        accs[(warp * kMaxRep + i) * D + lane + 32 * k] = acc[i][k];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml[(w * kMaxRep + i) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(ml[(w * kMaxRep + i) * 2] - m);
      l += c * ml[(w * kMaxRep + i) * 2 + 1];
      a += c * accs[(w * kMaxRep + i) * D + d];
    }
    out[(static_cast<size_t>(b) * hq + g * rep + i) * D + d] =
        from_f<T>(a / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D, typename Layout>
int launch(const void* q, const void* k, const void* v, Layout layout,
           const void* lengths, void* out, int n_rows, int hq, int hkv,
           cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, D, Layout>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_rows, hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const int*>(lengths),
      static_cast<T*>(out), hq, hkv);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaGetLastError() (0 on success); never synchronises.
template <typename Layout>
int entry(const void* q, const void* k, const void* v, Layout layout,
          const void* lengths, void* out, int n_rows, int hq, int hkv,
          int head_dim, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 128 && dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, layout, lengths, out, n_rows,
                                      hq, hkv, s);
  if (head_dim == 128 && dtype == 0)
    return launch<float, 128>(q, k, v, layout, lengths, out, n_rows, hq, hkv,
                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode
}  // namespace attn
