// The attention tile core shared by flash_attn.cu and ragged_prefill.cuh:
// one block attends one tile of query vectors — the (row, head) pairs of
// consecutive rows and the rep query heads of one KV head g, ordered by
// row and then by head — over one band of key positions of one KV row
// map.  The callers decide which rows a block owns and where its keys
// live; the core does the rest.
//
// What a tile computes.  Local row r (0 <= r < n_rows) sits at position
// pos0 + r and attends key positions p of its row map with kv_lo <= p <
// kv_hi (the positions its layout holds), p <= pos0 + r if causal, and
// p > pos0 + r - window if window > 0.  The block walks the union of
// those intervals, [lo, hi), and loads no key outside it: past kv_hi (a
// page-table entry or the park row there may hold anything), before
// kv_lo (a ring page or rolling row a newer position has overwritten),
// past the causal frontier of the last row, before the window of the
// first.  Softmax is online in fp32; p is rounded to the
// storage type before the PV product while the row sum l keeps the
// unrounded p (attn_common.cuh round_p); a row with no key writes 0.
// Where the caller asks (TileArgs::lse, the dense kernel's training
// form), each query vector's log-sum-exp is written too, for the
// backward (flash_attn_bwd.cu).
//
// Two cores, chosen at compile time by the storage type:
//
// - bf16, Tile<__nv_bfloat16, D>: the tensor cores.  A block is two
//   warpgroups (kWG) on a tile of 128 query vectors (kM), 64 each.  Q is
//   staged once in shared memory as bf16; K and V arrive 64 keys a tile
//   (kN) by 16-byte cp.async into a three-stage ring shared by both
//   warpgroups, the copies of tile t + 2 issued before the MMAs of tile
//   t.  Per warpgroup, S = Q.K^T is D / 16 wgmma m64n64k16 with both
//   operands in shared memory; the masked, exponentiated S is rounded to
//   bf16 pairs in registers, which are the A fragments of O += P.V, 4
//   wgmma m64nDk16 with V (transposed) from shared memory.  m and l stay
//   in registers.  The no-swizzle core-matrix layout of attn_tc.cuh
//   takes D = 64, 80, 96 and 128 alike, so every width runs through
//   wgmma with no padded columns (one compile-time path for all four).
//   Shared memory: 128 D x 2 bytes of Q and 3 stages x 2 x 64 D x 2
//   bytes of K/V, 128 KB at D = 128 (one block an SM), 80 KB at D = 80
//   (two).
// - fp32, Tile<float, D>: the checking type, kept on the CUDA cores
//   (TF32 would keep about three digits).  32 query vectors a block, four
//   threads a vector, 32-key tiles widened into shared memory by
//   attn_common.cuh load_kv_tile, scalar fp32 FMAs.
//
// Why this shape: with one warpgroup on 64 vectors the kernel ran at the
// rate the SMs could stream K/V tiles from L2 — builds with the MMAs cut
// out took as long, builds with the loads cut out were several times
// faster — so two warpgroups share each K/V tile, which halves the bytes
// per FLOP, and the copies go through L1 (.ca), which streamed faster
// than .cg.  A deeper ring did not help, nor did overlapping the next
// tile's Q.K^T with the softmax inside a warpgroup: the second score set
// costs the registers that let a second block share an SM.  PERF.md
// holds the measurements.
#pragma once

#include "attn_common.cuh"
#include "attn_tc.cuh"

namespace attn {

// One tile of query vectors: rows [0, n_rows) of q / out, each row hq * D
// elements (q and out point at the tile's first row), and its key band.
template <typename T>
struct TileArgs {
  const T* q;
  T* out;
  int n_rows, rep, hq, g, hkv;
  int pos0, kv_lo, kv_hi, causal, window;
  // where given (the dense kernel's training form), each vector's
  // log-sum-exp of its scaled scores, -inf for a row with no key: lse
  // points at the tile's first row of head 0 in a (heads, lse_rows)
  // array; nullptr (serving) writes nothing
  float* lse = nullptr;
  int lse_rows = 0;

  // the union [lo, hi) of the rows' key intervals
  __device__ __forceinline__ int lo() const {
    return window > 0 ? max(kv_lo, pos0 - window + 1) : kv_lo;
  }
  __device__ __forceinline__ int hi() const {
    return causal ? min(kv_hi, pos0 + n_rows) : kv_hi;
  }
  // the key interval [klo, khi) of local row r: empty for r >= n_rows
  __device__ __forceinline__ void row_band(int r, int& klo,
                                           int& khi) const {
    klo = window > 0 ? max(kv_lo, pos0 + r - window + 1) : kv_lo;
    khi = r < n_rows ? (causal ? min(kv_hi, pos0 + r + 1) : kv_hi) : 0;
  }
  // query vector i is (row i / rep, head g * rep + i % rep): its index
  // in q and out, in vectors of D
  __device__ __forceinline__ size_t vec(int i) const {
    return static_cast<size_t>(i / rep) * hq + g * rep + i % rep;
  }
  // store query vector i's log-sum-exp where asked
  __device__ __forceinline__ void put_lse(int i, float x) const {
    if (lse != nullptr)
      lse[static_cast<size_t>(g * rep + i % rep) * lse_rows + i / rep] = x;
  }
};

template <typename T, int D>
struct Tile;

// ------------------------------------------------------------ fp32 core

template <int D>
struct Tile<float, D> {
  static constexpr int kThreads = 128;
  static constexpr int kM = kThreads / 4;   // query vectors per tile
  static constexpr int kKT = 32;            // keys per shared-memory tile
  static constexpr size_t kSmem =
      sizeof(float) *
      (kM * (D + 1) + kKT * (D + 1) + kKT * D + kM * (kKT + 1));

  template <typename Rows>
  static __device__ void run(const TileArgs<float>& a,
                             const float* __restrict__ kbuf,
                             const float* __restrict__ vbuf, Rows rows,
                             unsigned char* smem_raw) {
    float* qs = reinterpret_cast<float*>(smem_raw);   // [kM][D + 1]
    float* ks = qs + kM * (D + 1);                   // [kKT][D + 1]
    float* vs = ks + kKT * (D + 1);                  // [kKT][D]
    float* ps = vs + kKT * D;                        // [kM][kKT + 1]
    const int tid = threadIdx.x;
    const int nq = a.n_rows * a.rep;
    const float scale = rsqrtf(static_cast<float>(D));

    for (int idx = tid; idx < kM * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      qs[i * (D + 1) + d] = i < nq ? a.q[a.vec(i) * D + d] : 0.f;
    }

    const int qi = tid >> 2;                // this thread's query vector
    const int sub = tid & 3;                // its quarter of keys and of D
    int klo, khi;
    a.row_band(qi < nq ? qi / a.rep : a.n_rows, klo, khi);
    const int lo = a.lo(), hi = a.hi();
    float m_i = kNegInf, l_i = 0.f;
    float acc[D / 4];
#pragma unroll
    for (int k = 0; k < D / 4; ++k) acc[k] = 0.f;

    for (int base = lo; base < hi; base += kKT) {   // block-uniform
      __syncthreads();                 // q staged / previous tile consumed
      load_kv_tile<float, D, kKT, kThreads>(kbuf, vbuf, rows, base, hi,
                                            a.hkv, a.g, tid, ks, vs);
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
        ok[m] = pos >= klo && pos < khi;
        sc[m] = ok[m] ? dot * scale : kNegInf;
        tmax = fmaxf(tmax, sc[m]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_i, tmax);
      float psum = 0.f;
#pragma unroll
      for (int m = 0; m < kKT / 4; ++m) {
        const float p = ok[m] ? expf(sc[m] - m_new) : 0.f;
        psum += p;
        ps[qi * (kKT + 1) + sub + 4 * m] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float alpha = expf(m_i - m_new);
      l_i = alpha * l_i + psum;
      m_i = m_new;
      __syncwarp();                    // the 4 sharers of qi are one warp
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        const int d = sub + 4 * k;
        float acc_k = acc[k] * alpha;
#pragma unroll 8
        for (int j = 0; j < kKT; ++j)
          acc_k += ps[qi * (kKT + 1) + j] * vs[j * D + d];
        acc[k] = acc_k;
      }
    }

    if (qi < nq) {
      const float inv = 1.f / (l_i == 0.f ? 1.f : l_i);
      float* o = a.out + a.vec(qi) * D;
#pragma unroll
      for (int k = 0; k < D / 4; ++k) o[sub + 4 * k] = acc[k] * inv;
      if (sub == 0)
        a.put_lse(qi, l_i > 0.f ? m_i + logf(l_i) : -INFINITY);
    }
  }
};

// ------------------------------------------------------------ bf16 core

template <int D>
struct Tile<__nv_bfloat16, D> {
  static_assert(D % 16 == 0 && D >= 64 && D <= 128,
                "head widths 64, 80, 96, 128");
  static constexpr int kWG = 2;             // consumer warpgroups
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kM = 64 * kWG;       // query vectors per tile
  static constexpr int kN = 64;             // keys per K/V tile
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kKVBytes = kN * D * 2;   // one K or V tile
  static constexpr int kStages = 3;         // K/V ring stages
  static constexpr size_t kSmem = kQBytes + kStages * 2 * kKVBytes;
  // 16-byte chunks a thread copies of the Q tile, and of a K (or V) tile
  // (a ragged last round at D = 80: 640 chunks over 256 threads)
  static constexpr int kQChunks = kM * D / 8 / kThreads;
  static constexpr int kKVChunks = (kN * D / 8 + kThreads - 1) / kThreads;
  static_assert(kM * D / 8 % kThreads == 0, "Q splits evenly");

  // Chunk c of a tile (rows of D / 8 chunks) in the core-matrix layout
  // of attn_tc.cuh: row, 16-byte column, and shared byte 16 c.
  static __device__ __forceinline__ int chunk_row(int c) {
    return (c / 8) / (D / 8) * 8 + c % 8;
  }
  static __device__ __forceinline__ int chunk_col(int c) {
    return (c / 8) % (D / 8);
  }

  // K and V tile of keys [kb, kb + kN) into one stage; keys >= hi are
  // zero-filled and their rows never addressed
  template <typename Rows>
  static __device__ __forceinline__ void load_kv(
      const __nv_bfloat16* __restrict__ kbuf,
      const __nv_bfloat16* __restrict__ vbuf, Rows rows, int kb, int hi,
      int hkv, int g, uint32_t ks, uint32_t vs) {
#pragma unroll
    for (int u = 0; u < kKVChunks; ++u) {
      const int c = threadIdx.x + u * kThreads;
      if (kN * D / 8 % kThreads != 0 && c >= kN * D / 8) break;
      const int pos = kb + chunk_row(c);
      const bool in = pos < hi;
      const size_t o =
          in ? (rows(pos) * hkv + g) * D + chunk_col(c) * 8 : 0;
      tc::cp_async16(ks + 16 * c, kbuf + o, in);
      tc::cp_async16(vs + 16 * c, vbuf + o, in);
    }
  }

  template <typename Rows>
  static __device__ void run(const TileArgs<__nv_bfloat16>& a,
                             const __nv_bfloat16* __restrict__ kbuf,
                             const __nv_bfloat16* __restrict__ vbuf,
                             Rows rows, unsigned char* smem) {
    const int tid = threadIdx.x;
    const int nq = a.n_rows * a.rep;
    const uint32_t qs = tc::smem_addr(smem);
    const uint32_t kv0 = qs + kQBytes;      // stage s: K at kv0 + 2 s kKV,
                                            // V after it
    auto stage = [&](int t) { return kv0 + (t % kStages) * 2 * kKVBytes; };
    // Q, zero past the tile's vectors
#pragma unroll
    for (int u = 0; u < kQChunks; ++u) {
      const int c = tid + u * kThreads;
      const int i = chunk_row(c);
      const bool in = i < nq;
      const size_t o = in ? a.vec(i) * D + chunk_col(c) * 8 : 0;
      tc::cp_async16(qs + 16 * c, a.q + o, in);
    }
    // Q and tiles 0 .. kStages - 2 in flight, one commit group each (Q
    // with tile 0); every loop step then commits one group, so tile t is
    // group t and has landed once kStages - 2 groups are left in flight
    const int lo = a.lo(), hi = a.hi();
    const int n_tiles = hi > lo ? (hi - lo + kN - 1) / kN : 0;
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles)
        load_kv(kbuf, vbuf, rows, lo + t * kN, hi, a.hkv, a.g, stage(t),
                stage(t) + kKVBytes);
      tc::cp_async_commit();
    }

    // this warpgroup's 64 query vectors (a Q sub-tile of 64 D x 2
    // bytes); a warpgroup with none only loads and joins the barriers
    const int wg = tid / 128, lane = tid & 31, quad = lane & 3;
    const bool busy = 64 * wg < nq;         // warpgroup-uniform
    const uint32_t qw = qs + wg * 64 * D * 2;
    // this thread's two query vectors (accumulator rows) and their bands
    const int v0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
    const int v1 = v0 + 8;
    int klo0, khi0, klo1, khi1;
    a.row_band(v0 < nq ? v0 / a.rep : a.n_rows, klo0, khi0);
    a.row_band(v1 < nq ? v1 / a.rep : a.n_rows, klo1, khi1);
    // scores in log2 units: p = 2^(s * scale * log2(e) - m)
    const float sl2 = rsqrtf(static_cast<float>(D)) * 1.4426950408889634f;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int t = 0; t < n_tiles; ++t) {     // block-uniform
      tc::cp_async_wait<kStages - 2>();     // tile t (and Q) landed
      tc::fence_proxy_async();
      __syncthreads();                      // ... for every thread; tile
                                            // t - 1's stage is free
      const int next = t + kStages - 1;
      if (next < n_tiles)
        load_kv(kbuf, vbuf, rows, lo + next * kN, hi, a.hkv, a.g,
                stage(next), stage(next) + kKVBytes);
      tc::cp_async_commit();
      if (!busy) continue;
      const uint32_t ks = stage(t), vs = ks + kKVBytes;

      // S = Q.K^T over D in steps of 16
      float s[kN / 2];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss_n64(s, tc::desc(qw + kk * 256, 128, 16 * D),
                       tc::desc(ks + kk * 256, 128, 16 * D), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(s);

      // mask to each row's band, online softmax in fp32
      const int kb = lo + t * kN;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = kb + 8 * j + 2 * quad + e;
          float& s0 = s[4 * j + e];
          float& s1 = s[4 * j + 2 + e];
          s0 = pos >= klo0 && pos < khi0 ? s0 * sl2 : -INFINITY;
          s1 = pos >= klo1 && pos < khi1 ? s1 * sl2 : -INFINITY;
          mx0 = fmaxf(mx0, s0);
          mx1 = fmaxf(mx1, s1);
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // m starts at the finite kNegInf, so a masked score (-inf) gives
      // p = 0 and alpha stays finite
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pa[kN / 16][4];              // P as the A fragments of P.V
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float p00 = exp2f(s[4 * j] - m0), p01 = exp2f(s[4 * j + 1] - m0);
        const float p10 = exp2f(s[4 * j + 2] - m1),
                    p11 = exp2f(s[4 * j + 3] - m1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        const __nv_bfloat162 r0 = __floats2bfloat162_rn(p00, p01);
        const __nv_bfloat162 r1 = __floats2bfloat162_rn(p10, p11);
        pa[j / 2][2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(&r0);
        pa[j / 2][2 * (j & 1) + 1] = *reinterpret_cast<const uint32_t*>(&r1);
      }
      // l is this thread's partial row sum; the quad adds them at the end
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }

      // O += P.V over the tile's keys in steps of 16
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        tc::mma_rs<D>(o, pa[kk], tc::desc(vs + kk * 32 * D, 16 * D, 128), 1);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(o);
    }
    tc::cp_async_wait<0>();                 // nothing left in flight

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = h ? v1 : v0;
      if (v >= nq) continue;
      const float inv = h ? inv1 : inv0;
      if (quad == 0) {
        // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2
        const float l = h ? l1 : l0, m = h ? m1 : m0;
        a.put_lse(v, l > 0.f ? (m + log2f(l)) * 0.6931471805599453f
                             : -INFINITY);
      }
      __nv_bfloat16* dst = a.out + a.vec(v) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  }
};

}  // namespace attn
