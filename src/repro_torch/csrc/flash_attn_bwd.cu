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
//   2. dK/dV: one block per (tile of keys, KV head g, batch row b).  It
//      walks the query tiles whose band can reach its keys (64 query
//      vectors a tile: 64 / rep rows x the rep heads of group g, ordered
//      as the forward orders them), recomputes S, P = exp(S * scale -
//      lse), dP = dO.V^T and dS = P * (dP - D), and accumulates dV +=
//      P^T.dO and dK += dS^T.Q in fp32 registers (dK times scale once, at
//      the end); the sum over a group's rep query heads stays inside the
//      block;
//   3. dQ: one block per (query tile, g, b), laid out like the forward;
//      it walks the key tiles of its band, recomputes S and dP, and
//      accumulates dQ = dS.K * scale.
// A row with no valid key has lse = -inf and every pair masked: P = 0,
// so its dQ is 0 and it adds nothing to dK/dV.  Keys no query attends
// (past kv_lengths, outside every band) get dK = dV = 0.
//
// bf16: the tensor cores (namespace tcore).  Both kernels are two
// warpgroups on the forward's primitives (attn_tc.cuh): operand tiles in
// the no-swizzle core-matrix layout, 16-byte cp.async copies into a ring
// of stages, wgmma with fp32 accumulators.  dK/dV: 128 keys a block, 64
// a warpgroup; K and V staged once; the Q and dO tiles of 64 vectors
// (with their lse and delta, 4-byte copies) stream through a four-stage
// ring, shared by both warpgroups.  A warpgroup takes S^T = K.Q^T and
// dP^T = V.dO^T as D / 16 m64n64k16 each with both operands in shared
// memory, forms P^T and dS^T in registers, and its m64n64 accumulators,
// rounded to bf16 pairs, are the A fragments of dV += P^T.dO and dK +=
// dS^T.Q (m64nDk16, dO and Q the MN-major B operands, no exchange
// between threads).  dQ: 128 query vectors a block with Q and dO staged
// once, K and V 64 keys a tile through a three-stage ring; S = Q.K^T and
// dP = dO.V^T, then dQ += dS.K with K's tile read again as the MN-major
// B operand.  Key tiles that lie inside every row's band skip the
// per-element band test, and a warpgroup whose keys no row of the query
// tile reaches skips the tile.  Blocks with the longest causal walks are
// launched first.
//
// fp32, the checking type: the CUDA cores, as the forward's fp32 tile
// keeps them (TF32 would keep about three digits).  64 x 64 tiles staged
// in shared memory as fp32 (rows padded to D + 4 floats so the 16-byte
// reads of a quarter warp fall in distinct banks), 4 x 4 register
// micro-tiles for S and dP, 4 rows x 4-column chunks for the
// accumulators.
//
// Rounding.  fp32 rounds nothing but its outputs' sums.  In bf16 the
// forward rounded p to bf16 before its P.V product, so dV's product takes
// P rounded to bf16 (the exact derivative of that forward); the tensor
// cores take dS in bf16 too, rounded once before the dK and dQ products
// (as FlashAttention's backward does), a relative error of at most u =
// 2^-8 of each |dS|.  ref.py flash_attn_bwd_error_bound carries both:
// u times the |.| sums of dV, dK and dQ (dS's magnitude P (|dO||V| +
// |dO||O|)) beside the fp32 summation term and each output's one
// rounding; the kernels stay inside it at every form chip_smoke.py
// phase 2 runs, and a dropped query or key tile lies far outside.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): 5
// products of 2 D FLOPs for each (query, key) pair of the band (S, dP,
// dV, dK, dQ; this design recomputes S and dP in the dQ kernel, 7 in
// all).  At training's full-width shape (B 4, L 1024, 32 / 8 heads of
// 128, causal) that is 86 GFLOP against ~168 MB of q, k, v, out, dO, lse
// and the gradients: the tensor cores bound it at ~0.087 ms.
//
// What this design does about it, and what holds it back (NVIDIA H100
// 80GB HBM3, 700.00 W; tools/flash_bwd_plans.py at that shape, three
// rounds of CUDA events, each kernel by torch.profiler): the bf16 call
// takes 0.554-0.562 ms (the CUDA-core kernels took 5.9), dK/dV
// 0.316-0.322 of it, dQ 0.196-0.200, delta 0.031-0.032.  With every
// product cut out dK/dV takes 0.117-0.120 ms and dQ 0.143-0.146; with
// dK/dV's Q/dO tile copies cut out, dK/dV takes 0.234-0.240.  So each
// warpgroup's products, run in turn with its elementwise work, bound
// dK/dV, and dQ spends most of its time outside its products, streaming
// K/V tiles and forming P and dS.  Slower in the same call: one
// warpgroup a block at two blocks an SM (dK/dV 0.423-0.430, dQ
// 0.254-0.259), warpgroup 1 issuing its first products after warpgroup
// 0's (a ping-pong: dK/dV 0.447-0.452), a division by rep in the tile
// copies (dK/dV 0.368-0.375; Rep multiplies and shifts instead), a
// three-stage dK/dV ring (0.336-0.341).  No faster: a two-stage dK/dV
// ring, a four-stage dQ ring, dQ waiting for S apart from dP.  At D =
// 128 dK/dV holds 255 registers a thread (two m64n128 and two m64n64
// fp32 accumulators) and spills 8 bytes.
#include <type_traits>

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

// ------------------------------------------ bf16: the tensor-core kernels

namespace tcore {

using bf16 = __nv_bfloat16;
// warpgroups a block and ring stages of each kernel
constexpr int kWGKV = 2, kStagesKV = 4;
constexpr int kWGQ = 2, kStagesQ = 3;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Plan {
  static constexpr int kTile = 64 * D * 2;    // 64 rows of D bf16
  // dK/dV: K and V of 64 kWGKV keys; a ring of (Q, dO) tiles of 64
  // query vectors; each stage's lse and delta (64 fp32 each) after it
  static constexpr size_t kSmemKV =
      2 * kWGKV * kTile + kStagesKV * (2 * kTile + 2 * 64 * sizeof(float));
  // dQ: Q and dO of 64 kWGQ query vectors; a ring of (K, V) tiles of 64
  // keys
  static constexpr size_t kSmemQ = 2 * kWGQ * kTile + kStagesQ * 2 * kTile;
};

// cp.async rows [0, R) of a tile of D bf16 into the core-matrix layout
// (attn_tc.cuh) at shared address dst, over NT threads: row r from
// src(r), zeros where src(r) is null (that row never read; `any` stands
// in as the address).
template <int D, int R, int NT, typename Src>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* any,
                                          Src src) {
  using L = Tile<bf16, D>;
  constexpr int kChunks = R * D / 8;
#pragma unroll
  for (int u = 0; u < (kChunks + NT - 1) / NT; ++u) {
    const int c = threadIdx.x + u * NT;
    if (kChunks % NT != 0 && c >= kChunks) break;
    const bf16* row = src(L::chunk_row(c));
    tc::cp_async16(dst + 16 * c,
                   row != nullptr ? row + L::chunk_col(c) * 8 : any,
                   row != nullptr);
  }
}

__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// i / rep and i % rep for 0 <= i < 128 by a multiply and a shift, not a
// division: with rep <= 8 the reciprocal's rounding, under 128 / 2^16,
// stays below the 1 / rep gap between quotients
struct Rep {
  int rep;
  uint32_t inv;                           // ceil(2^16 / rep)
  __device__ explicit Rep(int r) : rep(r), inv((65536u + r - 1) / r) {}
  __device__ __forceinline__ int div(int i) const {
    return static_cast<int>((static_cast<uint32_t>(i) * inv) >> 16);
  }
  __device__ __forceinline__ int mod(int i) const {
    return i - div(i) * rep;
  }
};

// The rows of `base` (q or dout) of query vectors i < nq of the tile from
// row r0 of group g, batch row b (vector i = row r0 + i / rep, head
// g rep + i % rep); null past them.
template <int D>
__device__ __forceinline__ auto query_rows(const Args<bf16>& a, Rep rp,
                                           const bf16* base, int b, int g,
                                           int r0, int nq) {
  const int lq = a.lq, hq = a.hq;
  return [=](int i) -> const bf16* {
    return i < nq ? base + ((static_cast<size_t>(b) * lq + r0 + rp.div(i)) *
                                hq + g * rp.rep + rp.mod(i)) * D
                  : nullptr;
  };
}

// The rows of `base` (k or v) of key positions kb + r < hi; null past.
template <int D>
__device__ __forceinline__ auto key_rows(const Args<bf16>& a,
                                         const bf16* base, int b, int g,
                                         int kb, int hi) {
  const int s = a.s, hkv = a.hkv;
  return [=](int r) -> const bf16* {
    return kb + r < hi
               ? base + ((static_cast<size_t>(b) * s + kb + r) * hkv + g) * D
               : nullptr;
  };
}

// dK/dV: one block per (64 kWGKV keys, KV head g, batch row b), the
// longest causal walks (the first keys) first; warpgroup w owns keys
// k0 + 64 w .. + 63, and the block's warpgroups walk one ring of query
// tiles.
template <int D>
__global__ void __launch_bounds__(128 * kWGKV, 1)
dkdv_tc_kernel(Args<bf16> a) {
  using P = Plan<D>;
  constexpr int NT = 128 * kWGKV;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * 64 * kWGKV;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int quad = lane & 3;
  const int rep = a.hq / a.hkv, rows_per = 64 / rep;
  const Rep rp(rep);
  const int kv_hi = min(max(a.kv_lengths[b], 0), a.s);
  const uint32_t ks = tc::smem_addr(smem), vs = ks + kWGKV * P::kTile;
  const uint32_t ring = vs + kWGKV * P::kTile;
  float* const lds = reinterpret_cast<float*>(
      smem + 2 * kWGKV * P::kTile + kStagesKV * 2 * P::kTile);
  auto qstage = [&](int t) {
    return ring + (t % kStagesKV) * 2 * P::kTile;
  };
  auto ldstage = [&](int t) { return lds + (t % kStagesKV) * 128; };
  // this warpgroup's keys; this thread's two (its accumulator rows)
  const int kw = k0 + 64 * wg;
  const int key0 = kw + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int key1 = key0 + 8;
  // scores in log2 units: p = 2^(s * scale * log2(e) - lse * log2(e))
  const float sl2 = rsqrtf(static_cast<float>(D)) * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (k0 < kv_hi) {                       // block-uniform
    copy_rows<D, 64 * kWGKV, NT>(ks, a.k,
                                 key_rows<D>(a, a.k, b, g, k0, kv_hi));
    copy_rows<D, 64 * kWGKV, NT>(vs, a.v,
                                 key_rows<D>(a, a.v, b, g, k0, kv_hi));
    // the rows whose band can reach keys [k0, k_end)
    const int k_end = min(k0 + 64 * kWGKV, kv_hi);
    const int off = a.q_offsets[b];
    const int r_lo = a.causal ? max(0, k0 - off) : 0;
    const int r_hi = a.window > 0 ? min(a.lq, k_end - 1 + a.window - off)
                                  : a.lq;
    const int n_tiles =
        r_hi > r_lo ? (r_hi - r_lo + rows_per - 1) / rows_per : 0;
    // tile t's Q and dO vectors into its stage, their lse and delta
    // (threads 0-63 and 64-127) beside them
    auto load_q = [&](int t) {
      const int r0 = r_lo + t * rows_per;
      const int nq = min(rows_per, a.lq - r0) * rep;
      copy_rows<D, 64, NT>(qstage(t), a.q,
                           query_rows<D>(a, rp, a.q, b, g, r0, nq));
      copy_rows<D, 64, NT>(qstage(t) + P::kTile, a.dout,
                           query_rows<D>(a, rp, a.dout, b, g, r0, nq));
      if (tid < 128) {
        const int i = tid & 63;
        const float* x = tid < 64 ? a.lse : a.delta;
        const size_t o =
            (static_cast<size_t>(b) * a.hq + g * rep + rp.mod(i)) * a.lq +
            r0 + rp.div(i);
        tc::cp_async4(tc::smem_addr(ldstage(t) + tid), i < nq ? x + o : x,
                      i < nq);
      }
    };
    // K, V and tiles 0 .. kStagesKV - 2 in flight, one commit group each
    // (K and V with tile 0), so tile t has landed once kStagesKV - 2
    // groups are left in flight
#pragma unroll
    for (int t = 0; t < kStagesKV - 1; ++t) {
      if (t < n_tiles) load_q(t);
      tc::cp_async_commit();
    }
    TileArgs<bf16> tb = band(a, b, g, 0, 0);
    const int pos0 = tb.pos0;
    for (int t = 0; t < n_tiles; ++t) {   // block-uniform
      tc::cp_async_wait<kStagesKV - 2>();
      tc::fence_proxy_async();
      __syncthreads();                    // tile t landed for every
                                          // thread; t - 1's stage is free
      if (t + kStagesKV - 1 < n_tiles) load_q(t + kStagesKV - 1);
      tc::cp_async_commit();
      const int r0 = r_lo + t * rows_per;
      tb.n_rows = min(rows_per, a.lq - r0);
      tb.pos0 = pos0 + r0;
      const int nq = tb.n_rows * rep;
      // the first row's and the last row's keys (both bounds grow with
      // the row)
      int lo_first, hi_first, lo_last, hi_last;
      tb.row_band(0, lo_first, hi_first);
      tb.row_band(tb.n_rows - 1, lo_last, hi_last);
      // no pair of this warpgroup's keys in the band (warpgroup-
      // uniform), or every pair
      const bool none = kw >= hi_last || kw + 64 <= lo_first;
      const bool inside = lo_last <= kw && kw + 64 <= hi_first;
      if (none) continue;

      // S^T = K.Q^T and dP^T = V.dO^T over D in steps of 16
      const uint32_t qs = qstage(t), dos = qs + P::kTile;
      const uint32_t kwa = ks + wg * P::kTile, vwa = vs + wg * P::kTile;
      float s[32], dp[32];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss_n64(s, tc::desc(kwa + kk * 256, 128, 16 * D),
                       tc::desc(qs + kk * 256, 128, 16 * D), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss_n64(dp, tc::desc(vwa + kk * 256, 128, 16 * D),
                       tc::desc(dos + kk * 256, 128, 16 * D), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(s);
      tc::fence_regs(dp);

      // P^T on the band (0 elsewhere) and dS^T = P^T (dP^T - delta), rows
      // this thread's keys, columns query vectors 8 j + 2 quad + e; each
      // rounded to bf16 pairs, the A fragments of the next two products
      const float* lse_s = ldstage(t);
      const float* del_s = lse_s + 64;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[2][2], ds[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * j + 2 * quad + e;
          const float l2 = lse_s[i] * kLog2e, del = del_s[i];
          int klo = 0, khi = 0;
          if (!inside)
            tb.row_band(i < nq ? rp.div(i) : tb.n_rows, klo, khi);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = h ? key1 : key0;
            float x = exp2f(fmaf(s[4 * j + 2 * h + e], sl2, -l2));
            if (!inside && !(key >= klo && key < khi)) x = 0.f;
            p[h][e] = x;
            ds[h][e] = x * (dp[4 * j + 2 * h + e] - del);
          }
        }
        pa[j / 2][2 * (j & 1)] = pack(p[0][0], p[0][1]);
        pa[j / 2][2 * (j & 1) + 1] = pack(p[1][0], p[1][1]);
        da[j / 2][2 * (j & 1)] = pack(ds[0][0], ds[0][1]);
        da[j / 2][2 * (j & 1) + 1] = pack(ds[1][0], ds[1][1]);
      }

      // dV += P^T.dO and dK += dS^T.Q over the tile's 64 vectors in steps
      // of 16, dO and Q the MN-major B operands
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<D>(dv, pa[kk], tc::desc(dos + kk * 32 * D, 16 * D, 128),
                      1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::mma_rs<D>(dk, da[kk], tc::desc(qs + kk * 32 * D, 16 * D, 128),
                      1);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(dv);
      tc::fence_regs(dk);
    }
    tc::cp_async_wait<0>();               // nothing left in flight
  }
  // every key of the block is written: 0 where no query attends it
  const float scale = rsqrtf(static_cast<float>(D));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = h ? key1 : key0;
    if (pos >= a.s) continue;
    const size_t row =
        ((static_cast<size_t>(b) * a.s + pos) * a.hkv + g) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + row + 8 * j) =
          __floats2bfloat162_rn(dk[4 * j + 2 * h] * scale,
                                dk[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + row + 8 * j) =
          __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// dQ: one block per (64 kWGQ query vectors, g, b), the last rows (the
// longest causal walks) first; the forward's layout, warpgroup w on
// vectors 64 w .. + 63, K and V 64 keys a tile through the ring.
template <int D>
__global__ void __launch_bounds__(128 * kWGQ, 1)
dq_tc_kernel(Args<bf16> a) {
  using P = Plan<D>;
  constexpr int NT = 128 * kWGQ;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = a.hq / a.hkv, rows_per = 64 * kWGQ / rep;
  const Rep rp(rep);
  const int r0 = (gridDim.z - 1 - blockIdx.z) * rows_per;
  const int n_rows = min(rows_per, a.lq - r0), nq = n_rows * rep;
  const TileArgs<bf16> tb = band(a, b, g, r0, n_rows);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int quad = lane & 3;
  const uint32_t qs = tc::smem_addr(smem), dos = qs + kWGQ * P::kTile;
  const uint32_t ring = dos + kWGQ * P::kTile;
  auto stage = [&](int t) { return ring + (t % kStagesQ) * 2 * P::kTile; };
  copy_rows<D, 64 * kWGQ, NT>(qs, a.q,
                              query_rows<D>(a, rp, a.q, b, g, r0, nq));
  copy_rows<D, 64 * kWGQ, NT>(dos, a.dout,
                              query_rows<D>(a, rp, a.dout, b, g, r0, nq));
  const int lo = tb.lo(), hi = tb.hi();
  const int n_tiles = hi > lo ? (hi - lo + 63) / 64 : 0;
  auto load_kv = [&](int t) {
    const int kb = lo + 64 * t;
    copy_rows<D, 64, NT>(stage(t), a.k, key_rows<D>(a, a.k, b, g, kb, hi));
    copy_rows<D, 64, NT>(stage(t) + P::kTile, a.v,
                         key_rows<D>(a, a.v, b, g, kb, hi));
  };
  // Q, dO and K/V tiles 0 .. kStagesQ - 2 in flight (Q and dO with
  // tile 0)
#pragma unroll
  for (int t = 0; t < kStagesQ - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    tc::cp_async_commit();
  }

  // this warpgroup's vectors (a warpgroup with none only loads and joins
  // the barriers); this thread's two (accumulator rows), their bands,
  // lse and delta
  const bool busy = 64 * wg < nq;         // warpgroup-uniform
  const uint32_t qw = qs + wg * P::kTile, dow = dos + wg * P::kTile;
  const int v0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int v1 = v0 + 8;
  int klo0, khi0, klo1, khi1;
  tb.row_band(v0 < nq ? rp.div(v0) : n_rows, klo0, khi0);
  tb.row_band(v1 < nq ? rp.div(v1) : n_rows, klo1, khi1);
  auto at = [&](const float* x, int v) {
    return v < nq ? x[(static_cast<size_t>(b) * a.hq + g * rep + rp.mod(v)) *
                          a.lq + r0 + rp.div(v)]
                  : 0.f;
  };
  const float l20 = at(a.lse, v0) * kLog2e, l21 = at(a.lse, v1) * kLog2e;
  const float del0 = at(a.delta, v0), del1 = at(a.delta, v1);
  // a key tile inside every row's band needs no mask
  int lo_last, hi_first, unused;
  tb.row_band(n_rows - 1, lo_last, unused);
  tb.row_band(0, unused, hi_first);
  const float sl2 = rsqrtf(static_cast<float>(D)) * kLog2e;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {     // block-uniform
    tc::cp_async_wait<kStagesQ - 2>();
    tc::fence_proxy_async();
    __syncthreads();
    if (t + kStagesQ - 1 < n_tiles) load_kv(t + kStagesQ - 1);
    tc::cp_async_commit();
    if (!busy) continue;
    const uint32_t kst = stage(t), vst = kst + P::kTile;

    // S = Q.K^T and dP = dO.V^T over D in steps of 16
    float s[32], dp[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::mma_ss_n64(s, tc::desc(qw + kk * 256, 128, 16 * D),
                     tc::desc(kst + kk * 256, 128, 16 * D), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::mma_ss_n64(dp, tc::desc(dow + kk * 256, 128, 16 * D),
                     tc::desc(vst + kk * 256, 128, 16 * D), kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // P on the band, 0 elsewhere, in place of S
    const int kb = lo + 64 * t;
    const bool inside = lo_last <= kb && kb + 64 <= hi_first;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = kb + 8 * j + 2 * quad + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[4 * j + 2 * h + e];
          x = exp2f(fmaf(x, sl2, h ? -l21 : -l20));
          if (!inside && !(h ? pos >= klo1 && pos < khi1
                             : pos >= klo0 && pos < khi0))
            x = 0.f;
        }
      }

    // dS = P (dP - delta) as bf16 A fragments; dQ += dS.K over the
    // tile's keys in steps of 16, K the MN-major B operand
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      da[j / 2][2 * (j & 1)] = pack(s[4 * j] * (dp[4 * j] - del0),
                                    s[4 * j + 1] * (dp[4 * j + 1] - del0));
      da[j / 2][2 * (j & 1) + 1] =
          pack(s[4 * j + 2] * (dp[4 * j + 2] - del1),
               s[4 * j + 3] * (dp[4 * j + 3] - del1));
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::mma_rs<D>(dq, da[kk], tc::desc(kst + kk * 32 * D, 16 * D, 128), 1);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(dq);
  }
  tc::cp_async_wait<0>();

  const float scale = rsqrtf(static_cast<float>(D));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = h ? v1 : v0;
    if (v >= nq) continue;
    bf16* dst = a.dq + ((static_cast<size_t>(b) * a.lq + r0 + rp.div(v)) *
                            a.hq + g * rep + rp.mod(v)) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2 * h] * scale,
                                dq[4 * j + 2 * h + 1] * scale);
  }
}

template <int D>
int launch(const Args<bf16>& a, int n_batch, cudaStream_t stream) {
  using P = Plan<D>;
  const int key_tiles = (a.s + 64 * kWGKV - 1) / (64 * kWGKV);
  const int rows_per = 64 * kWGQ / (a.hq / a.hkv);
  const int q_tiles = (a.lq + rows_per - 1) / rows_per;
  if (key_tiles > 65535 || q_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::kSmemKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_tc_kernel<D><<<dim3(a.hkv, n_batch, key_tiles), 128 * kWGKV,
                      P::kSmemKV, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(P::kSmemQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<D><<<dim3(a.hkv, n_batch, q_tiles), 128 * kWGQ, P::kSmemQ,
                    stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcore

// the CUDA-core kernels: fp32, the checking type
template <int D>
int launch_fp32(const Args<float>& a, int n_batch, cudaStream_t stream) {
  using S = Shape<D>;
  // the attribute at every launch (a once-only guard is one object for
  // every library that instantiates it: attn_common.cuh kernel_info)
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<float, D><<<dim3((a.s + kT - 1) / kT, a.hkv, n_batch),
                          kThreads, S::kSmemKV, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<float, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmemQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per = kT / (a.hq / a.hkv);
  dq_kernel<float, D><<<dim3((a.lq + rows_per - 1) / rows_per, a.hkv,
                             n_batch),
                        kThreads, S::kSmemQ, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// delta, then dK/dV and dQ: the tensor-core kernels in bf16, the CUDA-core
// ones in fp32 (chosen at compile time by the storage type)
template <typename T, int D>
int launch(const Args<T>& a, const T* out, float* delta, int n_batch,
           cudaStream_t stream) {
  const int n_vec = n_batch * a.lq * a.hq;
  constexpr int kWarps = kThreads / 32;
  delta_kernel<T, D><<<(n_vec + kWarps - 1) / kWarps, kThreads, 0,
                       stream>>>(out, a.dout, delta, n_vec, a.lq, a.hq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return tcore::launch<D>(a, n_batch, stream);
  else
    return launch_fp32<D>(a, n_batch, stream);
}

template <typename T, int D>
int info(int* out) {
  int r = kernel_info(delta_kernel<T, D>, kThreads, 0, out);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    using P = tcore::Plan<D>;
    if (r == 0) r = kernel_info(tcore::dkdv_tc_kernel<D>,
                                128 * tcore::kWGKV, P::kSmemKV, out + 3);
    if (r == 0) r = kernel_info(tcore::dq_tc_kernel<D>, 128 * tcore::kWGQ,
                                P::kSmemQ, out + 6);
  } else {
    using S = Shape<D>;
    if (r == 0) r = kernel_info(dkdv_kernel<T, D>, kThreads, S::kSmemKV,
                                out + 3);
    if (r == 0) r = kernel_info(dq_kernel<T, D>, kThreads, S::kSmemQ,
                                out + 6);
  }
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
