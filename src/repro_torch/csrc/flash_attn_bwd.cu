// The backward of the dense flash attention kernel (flash_attn.cu) for
// Hopper (sm_90a): dQ, dK and dV of
//   out = softmax(Q.K^T * scale, masked to each query's band) . V
// from the forward's saved q, k, v, out and its per-query log-sum-exp.
//
// Replaces no TPU kernel.  The reference trains through XLA attention
// (repro/models/layers.py attention_core: q-chunked jnp, no Pallas call,
// no custom_vjp); the port's forward of the same layers is the
// hand-written flash_attn kernel, so its gradient needs a kernel of its
// own (kernels/flash_attn.py FlashAttnFn).  It takes every form the
// forward takes: causal or not, a window, per-row q_offsets and
// kv_lengths, head widths 64/80/96/128, up to 8 query heads per KV head,
// fp32 and bf16.  The band of each (query, key) pair is the forward's
// own (attn_tiles.cuh TileArgs::row_band).
//
// Three kernels a call, each block writing only its own outputs, with
// no float atomics, so two runs give the same bits:
//   1. delta: D_i = rowsum(dO_i * O_i) in fp32, one warp a query vector
//      (a small CUDA kernel beside the other two, so one nvcc build and
//      one launcher cover the backward; Triton would add a second
//      toolchain for a reduction this small);
//   2. dK/dV: one block per (tile of 64 keys, KV head g, batch row b).
//      It walks the query tiles whose band can reach its keys (64 query
//      vectors a tile: 64 / rep rows x the rep heads of group g, ordered
//      as the forward orders them), recomputes P = exp(S * scale - lse),
//      dP = dO.V^T and dS = P * (dP - D), and accumulates dV += P^T.dO
//      and dK += dS^T.Q (times scale) in fp32 registers; the sum over a
//      group's rep query heads stays inside the block;
//   3. dQ: one block per (query tile, g, b), laid out like the forward;
//      it walks the key tiles of its band and accumulates dQ = dS.K *
//      scale.
// A row with no valid key has lse = -inf and every pair masked: P = 0,
// so its dQ is 0 and it adds nothing to dK/dV.  Keys no query attends
// (past kv_lengths, outside every band) get dK = dV = 0.
//
// Rounding: in bf16 the forward rounded p to bf16 before its P.V
// product, so dV's product takes P rounded to bf16 too (the exact
// derivative of that forward); dS is not rounded: every product here
// runs on the CUDA cores in fp32 from the storage values, and each
// output is rounded to the storage type once.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): 5
// products of 2 D FLOPs for each (query, key) pair of the band (S, dP,
// dV, dK, dQ; this design recomputes S and dP in the dQ kernel, 7 in
// all).  At training's full-width shape (B 4, L 1024, 32 / 8 heads of
// 128, causal) that is 86 GFLOP against ~50 MB of q, k, v, out, dO and
// the gradients: the tensor cores bound it at ~0.087 ms.
//
// What this design does about it: the simple correct first kernel.  All
// products run on the CUDA cores in fp32 over 64 x 64 tiles staged in
// shared memory as fp32 (rows padded to D + 4 floats so the 16-byte
// reads of a quarter warp fall in distinct banks), 4 x 4 register
// micro-tiles for S and dP, 4 rows x 4-column chunks for the
// accumulators.  It is far from the bound: the tensor-core form
// (wgmma, the forward's tile core) is later work.  PERF.md holds its
// times.
#include "attn_tiles.cuh"

namespace attn {
namespace flash_bwd {

constexpr int kMaxRep = 8;       // query heads per KV group
constexpr int kThreads = 256;
constexpr int kT = 64;           // query vectors, and keys, per tile
constexpr int kPS = kT + 1;      // row stride of the P and dS tiles

template <int D>
struct Shape {
  static constexpr int kST = D + 4;           // fp32 row stride of a tile
  static constexpr int kChunks = D / 4;       // 4-column chunks of a row
  static constexpr int kNW = (kChunks + 15) / 16;  // chunks a thread owns
  static constexpr size_t kTile = sizeof(float) * kT * kST;
  // dK/dV block: K, V, Q, dO tiles, P and dS, lse and delta
  static constexpr size_t kSmemKV =
      4 * kTile + 2 * sizeof(float) * kT * kPS + 2 * sizeof(float) * kT;
  // dQ block: Q, dO, K, V tiles, dS, lse and delta
  static constexpr size_t kSmemQ =
      4 * kTile + sizeof(float) * kT * kPS + 2 * sizeof(float) * kT;
};

// Stage n (<= kT) rows of D storage elements as fp32 at stride D + 4;
// row r starts at src(r), rows >= n are zero.  16-byte loads: every row
// is 16-byte aligned (D * sizeof(T) is a multiple of 16).
template <typename T, int D, typename Src>
__device__ __forceinline__ void stage_rows(float* dst, Src src, int n) {
  constexpr int V = Vec16<T>::n;
  constexpr int RV = D / V;
  for (int idx = threadIdx.x; idx < kT * RV; idx += kThreads) {
    const int r = idx / RV, c = (idx % RV) * V;
    float f[V];
    if (r < n) {
      Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(src(r) + c)),
                       f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(dst + r * Shape<D>::kST + c + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// S = A.B^T and dP = C.E^T over one 64 x 64 tile pair: thread (ti, tj) =
// (tid / 16, tid % 16) holds rows ti + 16 u and columns tj + 16 v.
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* e,
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int ST = Shape<D>::kST;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) s[u][v] = dp[u][v] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 ra[4], rb[4], rc[4], re[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ra[u] = *reinterpret_cast<const float4*>(a + (ti + 16 * u) * ST + d);
      rc[u] = *reinterpret_cast<const float4*>(c + (ti + 16 * u) * ST + d);
      rb[u] = *reinterpret_cast<const float4*>(b + (tj + 16 * u) * ST + d);
      re[u] = *reinterpret_cast<const float4*>(e + (tj + 16 * u) * ST + d);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        s[u][v] = dot4(ra[u], rb[v], s[u][v]);
        dp[u][v] = dot4(rc[u], re[v], dp[u][v]);
      }
  }
}

// ------------------------------------------------------------ 1. delta

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int n_vec, int lq, int hq) {
  const int w = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_vec) return;                 // w = (b * lq + row) * hq + h
  const T* o = out + static_cast<size_t>(w) * D;
  const T* g = dout + static_cast<size_t>(w) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
#pragma unroll
  for (int x = 16; x >= 1; x >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {
    const int h = w % hq, row = (w / hq) % lq, b = w / hq / lq;
    delta[(static_cast<size_t>(b) * hq + h) * lq + row] = acc;
  }
}

// The per-call constants both kernels read.
template <typename T>
struct Args {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *q_offsets, *kv_lengths;
  T *dq, *dk, *dv;
  int lq, s, hq, hkv, causal, window;
};

// The band of a tile of n_rows rows from row r0 of batch row b (the
// forward's TileArgs; its q / out pointers unused).
template <typename T>
__device__ __forceinline__ TileArgs<T> band(const Args<T>& a, int b, int g,
                                            int r0, int n_rows) {
  return TileArgs<T>{nullptr, nullptr, n_rows, a.hq / a.hkv, a.hq, g,
                     a.hkv, a.q_offsets[b] + r0, 0,
                     min(max(a.kv_lengths[b], 0), a.s), a.causal, a.window};
}

// Stage the query tile of rows [r0, r0 + n_rows) of group g: its Q and
// dO vectors (vector i = row i / rep, head g rep + i % rep) and their
// lse and delta.
template <typename T, int D>
__device__ __forceinline__ void stage_queries(const Args<T>& a, int b,
                                              int g, int r0, int n_rows,
                                              float* qs, float* dos,
                                              float* lse_s, float* del_s) {
  const int rep = a.hq / a.hkv, nq = n_rows * rep;
  auto vec = [&](int i) {
    return ((static_cast<size_t>(b) * a.lq + r0 + i / rep) * a.hq + g * rep +
            i % rep) * D;
  };
  stage_rows<T, D>(qs, [&](int i) { return a.q + vec(i); }, nq);
  stage_rows<T, D>(dos, [&](int i) { return a.dout + vec(i); }, nq);
  for (int i = threadIdx.x; i < kT; i += kThreads) {
    const size_t o = (static_cast<size_t>(b) * a.hq + g * rep + i % rep) *
                         a.lq + r0 + i / rep;
    lse_s[i] = i < nq ? a.lse[o] : 0.f;
    del_s[i] = i < nq ? a.delta[o] : 0.f;
  }
}

// P and dS of one tile pair from S and dP (thread layout of
// two_products): query vector i of the tile (local row i / rep of
// `t`'s band), key kb + j; pairs outside the band get 0.  P goes to
// ps rounded to T (dV's product) if ps is given, dS to dss unrounded.
template <typename T>
__device__ __forceinline__ void p_and_ds(const TileArgs<T>& t, int nq,
                                         int kb, float scale,
                                         const float (&s)[4][4],
                                         const float (&dp)[4][4],
                                         const float* lse_s,
                                         const float* del_s, float* ps,
                                         float* dss) {
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = ti + 16 * u;
    int klo, khi;
    t.row_band(i < nq ? i / t.rep : t.n_rows, klo, khi);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = tj + 16 * v, pos = kb + j;
      const bool ok = pos >= klo && pos < khi;
      const float p = ok ? expf(s[u][v] * scale - lse_s[i]) : 0.f;
      if (ps != nullptr) ps[i * kPS + j] = round_p<T>(p);
      dss[i * kPS + j] = p * (dp[u][v] - del_s[i]);
    }
  }
}

// Store 4-column chunk c4 of row `row` (fp32 x scale) into T storage.
template <typename T>
__device__ __forceinline__ void put4(T* dst, const float (&x)[4],
                                     float scale) {
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = from_f<T>(x[e] * scale);
}

// ------------------------------------------------------------ 2. dK/dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(Args<T> a) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kT * S::kST;
  float* qs = vs + kT * S::kST;
  float* dos = qs + kT * S::kST;
  float* ps = dos + kT * S::kST;
  float* dss = ps + kT * kPS;
  float* lse_s = dss + kT * kPS;
  float* del_s = lse_s + kT;
  const int k0 = blockIdx.x * kT, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.hq / a.hkv, rows_per = kT / rep;
  const float scale = rsqrtf(static_cast<float>(D));
  const int kv_hi = min(max(a.kv_lengths[b], 0), a.s);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  float dk[4][S::kNW][4], dv[4][S::kNW][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < S::kNW; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[u][w][e] = dv[u][w][e] = 0.f;

  if (k0 < kv_hi) {                       // block-uniform
    const int k_end = min(k0 + kT, kv_hi);
    auto key = [&](const T* base) {
      return [=](int j) {
        return base + ((static_cast<size_t>(b) * a.s + k0 + j) * a.hkv + g) *
                          D;
      };
    };
    stage_rows<T, D>(ks, key(a.k), k_end - k0);
    stage_rows<T, D>(vs, key(a.v), k_end - k0);
    // the rows whose band can reach keys [k0, k_end)
    const int off = a.q_offsets[b];
    const int r_lo = a.causal ? max(0, k0 - off) : 0;
    const int r_hi = a.window > 0 ? min(a.lq, k_end - 1 + a.window - off)
                                  : a.lq;
    for (int r0 = r_lo; r0 < r_hi; r0 += rows_per) {
      const int n_rows = min(rows_per, a.lq - r0), nq = n_rows * rep;
      __syncthreads();                    // the previous tile is consumed
      stage_queries<T, D>(a, b, g, r0, n_rows, qs, dos, lse_s, del_s);
      __syncthreads();
      float s[4][4], dp[4][4];
      two_products<D>(qs, ks, dos, vs, s, dp);
      p_and_ds(band(a, b, g, r0, n_rows), nq, k0, scale, s, dp, lse_s,
               del_s, ps, dss);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i]
      for (int i = 0; i < nq; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pv[u] = ps[i * kPS + tr + 16 * u];
          dsv[u] = dss[i * kPS + tr + 16 * u];
        }
#pragma unroll
        for (int w = 0; w < S::kNW; ++w) {
          const int c4 = tc + 16 * w;
          if (S::kChunks % 16 != 0 && c4 >= S::kChunks) break;
          const float4 o =
              *reinterpret_cast<const float4*>(dos + i * S::kST + 4 * c4);
          const float4 x =
              *reinterpret_cast<const float4*>(qs + i * S::kST + 4 * c4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dv[u][w][0] = fmaf(pv[u], o.x, dv[u][w][0]);
            dv[u][w][1] = fmaf(pv[u], o.y, dv[u][w][1]);
            dv[u][w][2] = fmaf(pv[u], o.z, dv[u][w][2]);
            dv[u][w][3] = fmaf(pv[u], o.w, dv[u][w][3]);
            dk[u][w][0] = fmaf(dsv[u], x.x, dk[u][w][0]);
            dk[u][w][1] = fmaf(dsv[u], x.y, dk[u][w][1]);
            dk[u][w][2] = fmaf(dsv[u], x.z, dk[u][w][2]);
            dk[u][w][3] = fmaf(dsv[u], x.w, dk[u][w][3]);
          }
        }
      }
    }
  }
  // every key of the tile is written: 0 where no query attends it
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int pos = k0 + tr + 16 * u;
    if (pos >= a.s) continue;
    const size_t row = ((static_cast<size_t>(b) * a.s + pos) * a.hkv + g) * D;
#pragma unroll
    for (int w = 0; w < S::kNW; ++w) {
      const int c4 = tc + 16 * w;
      if (S::kChunks % 16 != 0 && c4 >= S::kChunks) break;
      put4(a.dk + row + 4 * c4, dk[u][w], scale);
      put4(a.dv + row + 4 * c4, dv[u][w], 1.f);
    }
  }
}

// ------------------------------------------------------------ 3. dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(Args<T> a) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kT * S::kST;
  float* ks = dos + kT * S::kST;
  float* vs = ks + kT * S::kST;
  float* dss = vs + kT * S::kST;
  float* lse_s = dss + kT * kPS;
  float* del_s = lse_s + kT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = a.hq / a.hkv, rows_per = kT / rep;
  const int r0 = blockIdx.x * rows_per;
  const int n_rows = min(rows_per, a.lq - r0), nq = n_rows * rep;
  const float scale = rsqrtf(static_cast<float>(D));
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const TileArgs<T> t = band(a, b, g, r0, n_rows);

  stage_queries<T, D>(a, b, g, r0, n_rows, qs, dos, lse_s, del_s);
  float dq[4][S::kNW][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < S::kNW; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[u][w][e] = 0.f;

  const int lo = t.lo(), hi = t.hi();
  for (int kb = lo; kb < hi; kb += kT) {  // block-uniform
    __syncthreads();                      // queries staged / tile consumed
    auto key = [&](const T* base) {
      return [=](int j) {
        return base + ((static_cast<size_t>(b) * a.s + kb + j) * a.hkv + g) *
                          D;
      };
    };
    const int n_keys = min(kT, hi - kb);
    stage_rows<T, D>(ks, key(a.k), n_keys);
    stage_rows<T, D>(vs, key(a.v), n_keys);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(qs, ks, dos, vs, s, dp);
    p_and_ds(t, nq, kb, scale, s, dp, lse_s, del_s,
             static_cast<float*>(nullptr), dss);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
    for (int j = 0; j < n_keys; ++j) {
      float dsv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) dsv[u] = dss[(tr + 16 * u) * kPS + j];
#pragma unroll
      for (int w = 0; w < S::kNW; ++w) {
        const int c4 = tc + 16 * w;
        if (S::kChunks % 16 != 0 && c4 >= S::kChunks) break;
        const float4 x =
            *reinterpret_cast<const float4*>(ks + j * S::kST + 4 * c4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dq[u][w][0] = fmaf(dsv[u], x.x, dq[u][w][0]);
          dq[u][w][1] = fmaf(dsv[u], x.y, dq[u][w][1]);
          dq[u][w][2] = fmaf(dsv[u], x.z, dq[u][w][2]);
          dq[u][w][3] = fmaf(dsv[u], x.w, dq[u][w][3]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tr + 16 * u;
    if (i >= nq) continue;
    const size_t row = ((static_cast<size_t>(b) * a.lq + r0 + i / rep) *
                            a.hq + g * rep + i % rep) * D;
#pragma unroll
    for (int w = 0; w < S::kNW; ++w) {
      const int c4 = tc + 16 * w;
      if (S::kChunks % 16 != 0 && c4 >= S::kChunks) break;
      put4(a.dq + row + 4 * c4, dq[u][w], scale);
    }
  }
}

template <typename T, int D>
int launch(const Args<T>& a, const T* out, float* delta, int n_batch,
           cudaStream_t stream) {
  using S = Shape<D>;
  const int n_vec = n_batch * a.lq * a.hq;
  constexpr int kWarps = kThreads / 32;
  delta_kernel<T, D><<<(n_vec + kWarps - 1) / kWarps, kThreads, 0,
                       stream>>>(out, a.dout, delta, n_vec, a.lq, a.hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the attribute at every launch (a once-only guard is one object for
  // every library that instantiates it: attn_common.cuh kernel_info)
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmemKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D><<<dim3((a.s + kT - 1) / kT, a.hkv, n_batch), kThreads,
                      S::kSmemKV, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmemQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per = kT / (a.hq / a.hkv);
  dq_kernel<T, D><<<dim3((a.lq + rows_per - 1) / rows_per, a.hkv, n_batch),
                    kThreads, S::kSmemQ, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int info(int* out) {
  using S = Shape<D>;
  int r = kernel_info(delta_kernel<T, D>, kThreads, 0, out);
  if (r == 0) r = kernel_info(dkdv_kernel<T, D>, kThreads, S::kSmemKV,
                              out + 3);
  if (r == 0) r = kernel_info(dq_kernel<T, D>, kThreads, S::kSmemQ, out + 6);
  return r;
}

}  // namespace flash_bwd
}  // namespace attn

// q, out, dout, dq: (B, Lq, Hq, D); k, v, dk, dv: (B, S, Hkv, D); lse and
// delta (scratch): (B, Hq, Lq) fp32; q_offsets, kv_lengths: (B,) int32.
// causal: 0 or 1; window: 0 for none, else the band width; dtype: 0 =
// float32, 1 = bfloat16.  Launches the three kernels on `stream` and
// returns the first launch error (0 on success); never synchronises.
extern "C" int flash_attn_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* q_offsets,
    const void* kv_lengths, void* dq, void* dk, void* dv, void* delta,
    int n_batch, int lq, int s, int hq, int hkv, int head_dim, int causal,
    int window, int dtype, void* stream) {
  using namespace attn::flash_bwd;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || n_batch <= 0 ||
      n_batch > 65535 || lq <= 0 || s <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return attn::with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    using T = typename F::T;
    const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<const int*>(q_offsets),
                    static_cast<const int*>(kv_lengths),
                    static_cast<T*>(dq), static_cast<T*>(dk),
                    static_cast<T*>(dv), lq, s, hq, hkv, causal, window};
    return launch<T, F::D>(a, static_cast<const T*>(out),
                           static_cast<float*>(delta), n_batch,
                           static_cast<cudaStream_t>(stream));
  });
}

// The launch facts of the three kernels at (head_dim, dtype) on this
// card (attn_common.cuh kernel_info): out[3 k + 0..2] the dynamic shared
// bytes a block, registers a thread and blocks resident per SM of kernel
// k = delta, dK/dV, dQ.
extern "C" int flash_attn_bwd_info(int head_dim, int dtype, void* out) {
  return attn::with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    return attn::flash_bwd::info<typename F::T, F::D>(static_cast<int*>(out));
  });
}
