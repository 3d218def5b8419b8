// Chunked Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (pallas_call
// at :94, body _kernel), in the group-factored form of
// repro/models/mamba.py::ssd_chunked: B and C are read per GROUP through
// the head -> group map g = h / (NH / G), never expanded to heads in
// device memory (mamba2's G = 1 would cost 80x the B/C bytes).  The
// per-head form of the TPU kernel is G == NH.
//
// The function, per (batch row, head) and chunk of n <= Q rows, all in
// fp32 as _kernel computes it, with la = dt * a and cum its prefix sums:
//   M[t, s] = exp(seg(t, s)) * (C_t . B_s) * dt_s for s <= t only, where
//     seg(t, s) = sum_{s < r <= t} la_r (exp is never taken above the
//     diagonal, where it would overflow);
//   y = M X + (C * exp(cum)) state^T, written in x's dtype;
//   state <- exp(cum_last) state + X^T (w * B), w_s = exp(seg(last, s))
//     dt_s.
//
// Two kernels a call, on the caller's stream:
//   1. ssd_cb_kernel, one block per (batch row, chunk, group, 16-row
//      tile): C . B^T of the chunk, once per GROUP (mamba2's 80 heads
//      share one), into an fp32 workspace of Q x Q per (row, chunk,
//      group) that stays in L2.  Only the lower band of 16-row tiles is
//      computed.
//   2. ssd_walk_kernel, one block per (batch row, head, slice of kSlice
//      of the head's HD columns): the chunk loop inside the block with the
//      slice's kSlice x DS fp32 state in registers, in the accumulator
//      layout of the state update's MMAs.  At B = 1 mamba2's 80 heads
//      give 160 blocks in bf16, so every one of the 132 SMs has work.
// Per chunk the walk block tests the chunk's dt (fetched into a register
// during the last chunk) and, unless the chunk is skipped, copies X, B
// and the chunk's band of C . B^T into shared memory in their own
// layouts, one 1-D bulk copy (TMA) per row counted on an mbarrier, rows
// past L zeroed (16-byte cp.async or plain loads where the rows are not
// whole 16-byte units); meanwhile each warp multiplies its own 16 rows
// of C, read from device memory as MMA fragments, by the state (C is
// read by no other warp); then
//   - cum by a warp scan (4 warps of 32 rows);
//   - M by a running sum down each column s: seg(t, s) = seg(t - 1, s) +
//     la_t, O(1) an entry and the same additions in the same order as
//     the direct sum, never cum_t - cum_s (after a large decay early in
//     a chunk cum is large and that difference keeps few digits, while
//     these sums add terms of one sign).  The block's two halves split a
//     column's rows at half the chunk's tiles, the second half first
//     summing seg(mid - 1, s) over the same terms in the same order; the
//     column's last sum gives w_s;
//   - y = M X + diag(exp(cum)) (C state^T), the state's term first;
//   - state = exp(cum_last) state + (w X)^T B, into the registers.
// A chunk whose dt is 0 on every row of the head is an exact identity of
// the state (la = 0, M = 0, w = 0): the block sees it from the dt it
// loads (__syncthreads_or) and only computes y = C state^T, with no
// M, no X, no B and no C . B^T; the cb kernel likewise skips a chunk
// whose dt is 0 for every head of the group.  The packed step's dense
// bridge, mostly empty rows, is mostly such chunks.  The last chunk of
// an L off the chunk grid runs over its n real rows, zero-padded to a
// multiple of 16 in shared memory: nothing is read past L.
//
// Arithmetic.  bf16: mma.sync m16n8k16 (attn_tc.cuh) for C . B^T, M X,
// C state^T and (w X)^T B, X and B through ldmatrix.trans.  x, B and C
// are bf16, so their products are exact in the fp32 accumulators; the
// fp32 operands (M, the state, w X) enter as a split pair hi + lo of bf16
// (hi = bf16(v), lo = bf16(v - hi), |v - hi - lo| <= 2^-18 |v|), two MMAs
// each, so the products keep fp32-like accuracy as the reference's
// preferred_element_type=fp32 does.  M, w X and the state are stored
// interleaved (hi | lo << 16 per element): one load gives both
// fragments.  C state^T takes K in a permuted order (the same on both
// operands), so each lane reads 16 bytes of C and 32 of the state at a
// time.  fp32 (the checking type): the same schedule and the same
// fragment ownership, each thread computing its accumulator elements
// with scalar FMAs from shared memory.
//
// Bound (mamba2, bf16, B = 1, L = 256): ~0.84 GFLOP, which the tensor
// cores would take in ~0.001 ms, against ~10.7 MB of x, y, B, C, dt and
// the state, ~0.0032 ms at 3.35 TB/s: bytes bound it.  Every block
// re-reads the group's B and C (and the C . B^T band) from L2, 80x over
// at G = 1, and walks its chunks in order.
//
// Shared memory of the walk block at Q = 128, DS = 128: M as its lower
// band of 16-row tiles, B, X, the state's split copy (w X once the
// state's term is taken): bf16 (kSlice 32) 105,504 bytes, so two blocks
// share an SM (at most 128 registers a thread); fp32 (kSlice 16)
// 127,264 bytes.  Rows are padded so the fragment loads and ldmatrix
// rows fall on distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tc.cuh"

namespace {

namespace tc = attn::tc;
using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kMaxDs = 256;                  // the widest state taken
constexpr size_t kMaxSmem = 232448;          // 227 KB per block

// Per element type: the HD columns of a walk block and the element of a
// split (fp32-valued) operand with its row pad in 4-byte words.
template <typename T>
struct Tr;
template <>
struct Tr<bf16> {
  static constexpr int kSlice = 32;
  using S = uint32_t;                        // hi | lo << 16
  static constexpr int kPadS = 8;            // 8-byte fragment loads
};
template <>
struct Tr<float> {
  static constexpr int kSlice = 16;
  using S = float;
  static constexpr int kPadS = 4;
};
// operand rows padded by 16 bytes
template <typename E>
__host__ __device__ constexpr int pad_e() { return 16 / sizeof(E); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// two adjacent outputs, 4- or 8-byte aligned
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// a split operand element from its fp32 value, and back
__device__ __forceinline__ uint32_t split(float v, uint32_t*) {
  const bf16 hi = __float2bfloat16(v);
  const bf16 lo = __float2bfloat16(v - __bfloat162float(hi));
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16);
}
__device__ __forceinline__ float split(float v, float*) { return v; }
__device__ __forceinline__ float as_f(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ float as_f(float v) { return v; }

// --- bf16 fragments of mma.sync m16n8k16 (see tc::mma_16816) ----------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// A[r0.., k0..] of a row-major bf16 array with row stride ld
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* A,
                                       int ld, int r0, int k0, int g,
                                       int t) {
  const bf16* p = A + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// B[k0.., n0..] of an array stored [n][k] with row stride ld
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* B,
                                       int ld, int n0, int k0, int g,
                                       int t) {
  const bf16* p = B + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
// B[k0.., n0..] and B[k0.., n0 + 8..] of an array stored [k][n]: b[0..1]
// the first n-tile's fragment, b[2..3] the second's
__device__ __forceinline__ void frag_b2_kn(uint32_t (&b)[4], const bf16* B,
                                           int ld, int n0, int k0,
                                           int lane) {
  const int r = (lane & 7) + 8 * ((lane >> 3) & 1), c = 8 * (lane >> 4);
  tc::ldsm_x4_trans(tc::smem_addr(B + (k0 + r) * ld + n0 + c), b);
}
// two interleaved split elements -> the hi pair and the lo pair
__device__ __forceinline__ void unsplit2(uint32_t& hi, uint32_t& lo,
                                         const uint32_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  hi = __byte_perm(v.x, v.y, 0x5410);
  lo = __byte_perm(v.x, v.y, 0x7632);
}
// A[r0.., k0..] of a row-major array of interleaved split elements: the
// hi fragment and the lo fragment
__device__ __forceinline__ void frag_a_split(uint32_t (&ah)[4],
                                             uint32_t (&al)[4],
                                             const uint32_t* A, int ld,
                                             int r0, int k0, int g, int t) {
  const uint32_t* p = A + (r0 + g) * ld + k0 + 2 * t;
  unsplit2(ah[0], al[0], p);
  unsplit2(ah[1], al[1], p + 8 * ld);
  unsplit2(ah[2], al[2], p + 8);
  unsplit2(ah[3], al[3], p + 8 * ld + 8);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  tc::mma_16816(d, a[0], a[1], a[2], a[3], b0, b1);
}

// --- fp32: the same accumulator elements by scalar FMAs -----------------

// d += A[r0 + {g, g + 8}, k0..k0+15] . B[k0..k0+15, n0 + {2t, 2t + 1}],
// A row-major, B stored [n][k] (kKN false) or [k][n] (kKN true): the
// elements an mma.sync thread owns
template <bool kKN>
__device__ __forceinline__ void fma_tile(float (&d)[4], const float* A,
                                         int lda, int r0, const float* B,
                                         int ldb, int n0, int k0, int g,
                                         int t) {
  const float* a0 = A + (r0 + g) * lda + k0;
  const float* a1 = a0 + 8 * lda;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float* b = kKN ? B + (k0 + kk) * ldb + n0 + 2 * t
                         : B + (n0 + 2 * t) * ldb + k0 + kk;
    const float b0 = b[0], b1 = kKN ? b[1] : b[ldb];
    d[0] = fmaf(a0[kk], b0, d[0]);
    d[1] = fmaf(a0[kk], b1, d[1]);
    d[2] = fmaf(a1[kk], b0, d[2]);
    d[3] = fmaf(a1[kk], b1, d[3]);
  }
}

// --- C state^T from C's rows in device memory ---------------------------

// acc += C[rows g, g + 8 of the warp][k] . state[p][k] over k < dsp:
// crow is the row of C at g (the row at g + 8 is rs further), ok0 / ok1
// whether those rows exist (C is zero past L and past ds); the state is
// the split copy in shared memory [p][k].  bf16: each 4 k-steps' A
// fragments are loaded first, then multiplied; wide: 16-byte loads.
template <int kNY>
__device__ __forceinline__ void c_state(float (&acc)[kNY][4],
                                        const bf16* crow, long long rs,
                                        bool ok0, bool ok1, int ds, int dsp,
                                        bool wide, const uint32_t* sts,
                                        int ldst, int g, int t) {
  // K is taken in blocks of 32 with lane t holding physical k 8t .. 8t +
  // 7 of its rows: logical (2t, 2t + 1, 2t + 8, 2t + 9) of the block's
  // first k-step at physical 8t .. 8t + 3, of its second at 8t + 4 .. 8t
  // + 7.  The sum over k is the same; each lane reads 16 bytes of C and
  // 32 of the state where it would read 4 and 8.  A last block past DS
  // reads zeros: C is zero past ds, the state's copy past dsp.
  const bf16* c1 = crow + 8 * rs;
  auto load = [&](const bf16* r, bool ok, int k) -> uint4 {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!ok || k >= ds) return v;
    if (wide) return *reinterpret_cast<const uint4*>(r + k);
    uint16_t e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      e[u] = k + u < ds ? __bfloat16_as_ushort(r[k + u]) : 0;
    v.x = e[0] | (static_cast<uint32_t>(e[1]) << 16);
    v.y = e[2] | (static_cast<uint32_t>(e[3]) << 16);
    v.z = e[4] | (static_cast<uint32_t>(e[5]) << 16);
    v.w = e[6] | (static_cast<uint32_t>(e[7]) << 16);
    return v;
  };
  for (int kb = 0; kb < dsp; kb += 64) {
    uint4 r0[2], r1[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      r0[u] = load(crow, ok0, kb + 32 * u + 8 * t);
      r1[u] = load(c1, ok1, kb + 32 * u + 8 * t);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k0 = kb + 32 * u;
      if (k0 < dsp) {
        // the two k-steps' A fragments
        const uint32_t af[2][4] = {{r0[u].x, r1[u].x, r0[u].y, r1[u].y},
                                   {r0[u].z, r1[u].z, r0[u].w, r1[u].w}};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t bh[kNY][2], bl[kNY][2];
#pragma unroll
          for (int j = 0; j < kNY; ++j) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                sts + (8 * j + g) * ldst + k0 + 8 * t + 4 * q);
            bh[j][0] = __byte_perm(v.x, v.y, 0x5410);
            bl[j][0] = __byte_perm(v.x, v.y, 0x7632);
            bh[j][1] = __byte_perm(v.z, v.w, 0x5410);
            bl[j][1] = __byte_perm(v.z, v.w, 0x7632);
          }
#pragma unroll
          for (int j = 0; j < kNY; ++j) mma(acc[j], af[q], bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < kNY; ++j) mma(acc[j], af[q], bl[j][0], bl[j][1]);
        }
      }
    }
  }
}
template <int kNY>
__device__ __forceinline__ void c_state(float (&acc)[kNY][4],
                                        const float* crow, long long rs,
                                        bool ok0, bool ok1, int ds, int dsp,
                                        bool, const float* sts, int ldst,
                                        int g, int t) {
  const float* c1 = crow + 8 * rs;
  for (int k = 0; k < ds; ++k) {
    const float a0 = ok0 ? crow[k] : 0.f, a1 = ok1 ? c1[k] : 0.f;
#pragma unroll
    for (int j = 0; j < kNY; ++j) {
      const float b0 = sts[(8 * j + 2 * t) * ldst + k];
      const float b1 = sts[(8 * j + 2 * t + 1) * ldst + k];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// --- copies into shared memory ------------------------------------------

// can rows of `cols` elements at stride rs from src move as 16-byte units
template <typename E>
__device__ __forceinline__ bool rows16(const E* src, long long rs,
                                       int cols) {
  return reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
         (rs * static_cast<long long>(sizeof(E))) % 16 == 0 &&
         (cols * static_cast<int>(sizeof(E))) % 16 == 0;
}

// rows [0, rows) x columns [0, cols) of the matrix whose row r starts at
// src + r * rs, zero past valid_rows / valid_cols, into shared memory at
// dst[r * ld + c]: 16-byte cp.async when the rows allow them (the caller
// commits and waits), plain loads otherwise
template <typename E>
__device__ __forceinline__ void copy_tile(E* dst, int ld, const E* src,
                                          long long rs, int rows,
                                          int valid_rows, int cols,
                                          int valid_cols) {
  constexpr int V = 16 / sizeof(E);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
      (rs * static_cast<long long>(sizeof(E))) % 16 == 0 &&
      valid_cols % V == 0) {
    const int cv = cols / V;
    for (int i = threadIdx.x; i < rows * cv; i += kThreads) {
      const int r = i / cv, c = (i % cv) * V;
      const bool in = r < valid_rows && c < valid_cols;
      tc::cp_async16(tc::smem_addr(dst + r * ld + c),
                     in ? src + r * rs + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      dst[r * ld + c] = (r < valid_rows && c < valid_cols)
                            ? src[r * rs + c] : from_f<E>(0.f);
    }
  }
}

// --- shapes -------------------------------------------------------------

struct Dims {
  int len, nh, hd, ds, groups, hpg;
  int chunk, qp, dsp, nc, nslice;            // qp, dsp: 16-padded Q, DS
  long long x_rs, b_rs, c_rs;                // element stride of a (b, t) row
};

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

template <typename T>
__host__ __device__ constexpr size_t cb_smem(int qp, int dsp) {
  return sizeof(T) * static_cast<size_t>(16 + qp) * (dsp + pad_e<T>());
}

// The lower band of a Q x Q matrix, stored by 16-row tiles: tile i
// (rows 16 i .. 16 i + 15) holds columns 0 .. 16 (i + 1) - 1 at a row
// stride of 16 (i + 1) + pad elements, from element band_base(i).
__host__ __device__ constexpr int band_ld(int i, int pad) {
  return 16 * (i + 1) + pad;
}
__host__ __device__ constexpr int band_base(int i, int pad) {
  return 16 * (8 * i * (i + 1) + pad * i);
}

template <typename T>
__host__ __device__ constexpr size_t walk_smem(int qp, int dsp) {
  using S = typename Tr<T>::S;
  constexpr int P = Tr<T>::kSlice, ps = Tr<T>::kPadS, pe = pad_e<T>();
  return sizeof(S) * (static_cast<size_t>(band_base(qp / 16, ps))  // M
                      + static_cast<size_t>(P) *
                            (((dsp + 31) & ~31) + 4 > qp + ps
                                 ? ((dsp + 31) & ~31) + 4 : qp + ps))
         + sizeof(T) * (static_cast<size_t>(qp) * (dsp + pe)     // B
                        + static_cast<size_t>(qp) * (P + pe))    // X
         + sizeof(float) * (4 * static_cast<size_t>(qp) + 4)
         + 16;                                                   // mbarrier
}

// --- 1. C . B^T once per (batch row, chunk, group) ----------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ dt, const T* __restrict__ bm,
              const T* __restrict__ cm, float* __restrict__ cb, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = d.qp / 16, w = blockIdx.x % tiles;
  const int c = blockIdx.x / tiles / d.groups;
  const int g = blockIdx.x / tiles % d.groups;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int gq = (tid & 31) >> 2, tq = tid & 3;
  const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0), np = pad16(n);
  const int r0 = 16 * w;                     // this block's rows t
  if (r0 >= np) return;
  const long long row0 = static_cast<long long>(b) * d.len + c0;
  const int ld = d.dsp + pad_e<T>();
  T* cs = reinterpret_cast<T*>(smem_raw);    // (16, ld): C[r0 + t][k]
  T* bs = cs + 16 * ld;                      // (r0 + 16, ld): B[s][k]
  const long long gcol = static_cast<long long>(g) * d.ds;
  copy_tile(cs, ld, cm + (row0 + r0) * d.c_rs + gcol, d.c_rs, 16, n - r0,
            d.dsp, d.ds);
  copy_tile(bs, ld, bm + row0 * d.b_rs + gcol, d.b_rs, r0 + 16, n, d.dsp,
            d.ds);
  tc::cp_async_commit();
  // skipped when dt is 0 on every row of every head of the group: then
  // no walk block of the group reads this chunk's C . B^T
  int live = 0;
  const float* dg = dt + row0 * d.nh + g * d.hpg;
  if (d.hpg % 4 == 0 && d.nh % 4 == 0 &&
      reinterpret_cast<uintptr_t>(dg) % 16 == 0) {
    const int h4 = d.hpg / 4;
#pragma unroll 4
    for (int i = tid; i < n * h4; i += kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(
          dg + static_cast<long long>(i / h4) * d.nh + 4 * (i % h4));
      live |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < n * d.hpg; i += kThreads)
      live |= dg[static_cast<long long>(i / d.hpg) * d.nh + i % d.hpg] != 0.f;
  }
  tc::cp_async_wait<0>();
  if (!__syncthreads_or(live)) return;
  // columns s < r0 + 16: n-tiles warp and warp + 8
  const int nn = 2 * (w + 1);
  float acc[2][4] = {};
  for (int k0 = 0; k0 < d.dsp; k0 += 16) {
    if constexpr (sizeof(T) == 2) {
      uint32_t a[4];
      frag_a(a, cs, ld, 0, k0, gq, tq);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (warp + 8 * u < nn) {
          uint32_t bb[2];
          frag_b(bb, bs, ld, 8 * (warp + 8 * u), k0, gq, tq);
          mma(acc[u], a, bb[0], bb[1]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (warp + 8 * u < nn)
          fma_tile<false>(acc[u], cs, ld, 0, bs, ld, 8 * (warp + 8 * u), k0,
                          gq, tq);
    }
  }
  float* out = cb + ((static_cast<long long>(b) * d.nc + c) * d.groups + g) *
                        d.qp * d.qp;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (warp + 8 * u < nn) {
      const int t = r0 + gq, s = 8 * (warp + 8 * u) + 2 * tq;
      *reinterpret_cast<float2*>(out + t * d.qp + s) =
          make_float2(acc[u][0], acc[u][1]);
      *reinterpret_cast<float2*>(out + (t + 8) * d.qp + s) =
          make_float2(acc[u][2], acc[u][3]);
    }
  }
}

// --- 2. the chunk walk of one (batch row, head, HD slice) ---------------

// kDs: the widest DS this instance takes (it sizes the state registers:
// 128 for mamba2's heads, with no spills at 128 registers a thread);
// kStates: the training form, which also writes each chunk's start state
// (an instance of its own, so the serving form compiles as it did)
template <typename T, int kDs, bool kStates = false>
__global__ void __launch_bounds__(kThreads, 2)
ssd_walk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ cb,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hout, float* __restrict__ states,
                Dims d) {
  using S = typename Tr<T>::S;
  constexpr int P = Tr<T>::kSlice;
  constexpr int kNY = P / 8;                 // y: n-tiles of a warp's rows
  constexpr int kMT = P / 16;                // state: m-tiles of rows p
  constexpr int kWpm = kWarps / kMT;         // warps per state m-tile
  constexpr int kNS = kDs / 8 / kWpm;        // state n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x / d.nslice, p0 = (blockIdx.x % d.nslice) * P;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int qp = d.qp, dsp = d.dsp;
  constexpr int ps = Tr<T>::kPadS;
  // the state's copy: rows of DS rounded up to 32 (zero past dsp) and 4
  // words of pad (bf16: the 16-byte reads of c_state); w X's rows padded
  // by kPadS (the fragment loads of the update)
  const int ds32 = (dsp + 31) & ~31, ldst = ds32 + 4, ldw = qp + ps;
  const int ldc = dsp + pad_e<T>(), ldx = P + pad_e<T>();
  S* mb = reinterpret_cast<S*>(smem_raw);    // the band: C.B^T, then M
  // (P, ldst): the state's split copy [p][k] for C state^T, and once
  // every warp has taken it, (P, ldw): w X split [p][s] for the update
  S* sts = mb + band_base(qp / 16, ps);
  S* wxs = sts;
  T* bs = reinterpret_cast<T*>(sts + P * max(ldst, ldw));  // (qp, ldc)
  T* xs = bs + qp * ldc;                     // (qp, ldx): X[s][p]
  float* dts = reinterpret_cast<float*>(xs + qp * ldx);  // (qp): dt
  float* las = dts + qp;                     // (qp): la = dt a
  float* ecum = las + qp;                    // (qp): exp(cum)
  float* ws = ecum + qp;                     // (qp): w
  float* wtot = ws + qp;                     // (4): the scan's warp sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(wtot + 4);  // the copies
  const int g = h / d.hpg;
  const float av = a[h];
  const long long gcol = static_cast<long long>(g) * d.ds;
  const long long xcol = static_cast<long long>(h) * d.hd + p0;
  // C's rows are read 16 bytes at a time when they allow it
  const bool c_wide = rows16(cm + gcol, d.c_rs, d.ds);
  // X's and B's rows move by bulk copies when they are 16-byte units
  const int xn = min(P, d.hd - p0);          // this slice's columns of X
  const bool bulk = rows16(x + xcol, d.x_rs, xn) &&
                    rows16(bm + gcol, d.b_rs, d.ds);
  if (tid == 0) tc::mbar_init(bar);
  uint32_t parity = 0;

  // the state slice in registers, in the accumulator layout of the
  // state update: rows p = 16 mt + gq (+ 8), columns k = 8 j + 2 tq
  // (+ 1) of n-tiles j in pairs 2 (jw + kWpm i) and + 1
  const int mt = warp % kMT, jw = warp / kMT;
  auto tile = [&](int i) { return 2 * (jw + kWpm * (i >> 1)) + (i & 1); };
  auto band = [&](int t, int s) {            // element (t, s) of the band
    return band_base(t >> 4, ps) + (t & 15) * band_ld(t >> 4, ps) + s;
  };
  const long long sbase = (static_cast<long long>(b) * d.nh + h) * d.hd;
  float st[kNS][4];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 16 * mt + gq + 8 * (e >> 1);
      const int k = 8 * tile(i) + 2 * tq + (e & 1);
      st[i][e] = (p < d.hd && k < d.ds) ? h0[(sbase + p) * d.ds + k] : 0.f;
    }
  }
  auto stash_state = [&]() {
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      if (8 * tile(i) < dsp) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sts[(16 * mt + gq + 8 * (e >> 1)) * ldst + 8 * tile(i) + 2 * tq +
              (e & 1)] = split(st[i][e], static_cast<S*>(nullptr));
      }
    }
    for (int i = tid; i < P * (ds32 - dsp); i += kThreads)
      sts[i / (ds32 - dsp) * ldst + dsp + i % (ds32 - dsp)] =
          split(0.f, static_cast<S*>(nullptr));
  };
  stash_state();

  float dnext = 0.f;                         // this thread's row of dt
  if (tid < min(d.chunk, d.len))
    dnext = dt[(static_cast<long long>(b) * d.len + tid) * d.nh + h];
  for (int c = 0; c < d.nc; ++c) {
    const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0), np = pad16(n);
    const long long row0 = static_cast<long long>(b) * d.len + c0;
    if constexpr (kStates) {                 // the training form
      float* sc = states + ((static_cast<long long>(b) * d.nh + h) * d.nc +
                            c) * d.hd * d.ds;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 16 * mt + gq + 8 * (e >> 1);
          const int k = 8 * tile(i) + 2 * tq + (e & 1);
          if (p < d.hd && k < d.ds) sc[p * d.ds + k] = st[i][e];
        }
      }
    }
    __syncthreads();                         // the last chunk's reads done
    const float dtv = dnext;
    if (tid < np) {
      dts[tid] = dtv;
      las[tid] = dtv * av;
    }
    const bool live = __syncthreads_or(dtv != 0.f);
    dnext = (c + 1 < d.nc && tid < min(d.chunk, d.len - c0 - d.chunk))
                ? dt[(row0 + d.chunk + tid) * d.nh + h] : 0.f;
    float part = 0.f;
    if (live) {
      const float* src =
          cb + ((static_cast<long long>(b) * d.nc + c) * d.groups + g) *
                   qp * qp;
      if (bulk) {
        tc::fence_proxy_async();             // generic writes, then copies
        // thread t moves row t of X, B and the band of C . B^T (columns
        // < 16 (t / 16 + 1)); rows past n and the pad columns are zeroed
        if (tid == 0) {
          uint32_t band_bytes = 0;
          for (int t = 0; t < n; t += 16)
            band_bytes += 64u * (t / 16 + 1) * min(16, n - t);
          tc::mbar_expect(bar, band_bytes + static_cast<uint32_t>(n) *
                                            (xn + d.ds) * sizeof(T));
        }
        const int t = tid;
        if (t < n) {
          tc::bulk_copy(xs + t * ldx, x + (row0 + t) * d.x_rs + xcol,
                    xn * sizeof(T), bar);
          tc::bulk_copy(bs + t * ldc, bm + (row0 + t) * d.b_rs + gcol,
                    d.ds * sizeof(T), bar);
          tc::bulk_copy(mb + band(t, 0), src + t * qp, 64u * (t / 16 + 1), bar);
          for (int k = xn; k < P; ++k) xs[t * ldx + k] = from_f<T>(0.f);
          for (int k = d.ds; k < dsp; ++k) bs[t * ldc + k] = from_f<T>(0.f);
        } else if (t < np) {
          for (int k = 0; k < P; ++k) xs[t * ldx + k] = from_f<T>(0.f);
          for (int k = 0; k < dsp; ++k) bs[t * ldc + k] = from_f<T>(0.f);
          for (int k = 0; k < 16 * (t / 16 + 1); ++k)
            mb[band(t, k)] = split(0.f, static_cast<S*>(nullptr));
        }
      } else {
        copy_tile(xs, ldx, x + row0 * d.x_rs + xcol, d.x_rs, np, n, P, xn);
        copy_tile(bs, ldc, bm + row0 * d.b_rs + gcol, d.b_rs, np, n, dsp,
                  d.ds);
        // this chunk's band of C . B^T: row t, columns < 16 (t / 16 + 1)
        const int q4 = qp / 4;
        for (int i = tid; i < np * q4; i += kThreads) {
          const int t = i / q4, s4 = i % q4;
          if (4 * s4 < 16 * (t / 16 + 1))
            tc::cp_async16(tc::smem_addr(mb + band(t, 4 * s4)),
                           src + t * qp + 4 * s4, true);
        }
        tc::cp_async_commit();
      }
      // cum: an inclusive scan of la over 4 warps of 32 rows
      if (warp < 4) {
        part = tid < np ? las[tid] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, part, o);
          if (lane >= o) part += u;
        }
        if (lane == 31) wtot[warp] = part;
      }
    }

    // y rows 16 warp .. + 15: C state^T first, from the warp's own rows
    // of C in device memory while the copies land, then scaled by
    // exp(cum) once M is built, plus M X
    const int r0 = 16 * warp;
    float acc[kNY][4] = {};
    if (r0 < np)
      c_state(acc, cm + (row0 + r0 + gq) * d.c_rs + gcol, d.c_rs,
              r0 + gq < n, r0 + gq + 8 < n, d.ds, dsp, c_wide, sts, ldst,
              gq, tq);
    if (live) {
      if (bulk) {
        tc::mbar_wait(bar, parity);
        parity ^= 1;
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();                       // X, B, the band, the scan
      if (tid < np) {
        float off = 0.f;
        for (int w = 0; w < warp; ++w) off += wtot[w];
        ecum[tid] = expf(part + off);
      }
      // M down column s = tid % 128, its rows split at mid (half the
      // chunk's 16-row tiles, rounded up) between the two halves of the
      // block: zero above the diagonal in the column's tile band, then the
      // running sum seg(t, s) = seg(t - 1, s) + la_t.  The second half
      // first sums seg(mid - 1, s) over the same terms in the same order,
      // so both give the direct sum's bits.
      const int s = tid & 127, half = tid >> 7;
      const int mid = 16 * ((np / 16 + 1) / 2), lo0 = s & ~15;
      const int lo = half ? max(mid, lo0) : lo0, hi = half ? np : mid;
      if (s < np && lo < hi) {
        const float dts_s = dts[s];
        float seg = 0.f;
        for (int r = s + 1; r < lo; ++r) seg += las[r];
        for (int i = lo >> 4; i < hi >> 4; ++i) {
          S* col = mb + band_base(i, ps) + s;
          const int ld = band_ld(i, ps);
          if (i == s >> 4) {                 // the diagonal tile
#pragma unroll
            for (int tt = 0; tt < 16; ++tt) {
              const int t = 16 * i + tt;
              float m = 0.f;
              if (t > s) seg += las[t];
              if (t >= s) m = __expf(seg) * as_f(col[tt * ld]) * dts_s;
              col[tt * ld] = split(m, static_cast<S*>(nullptr));
            }
          } else {
#pragma unroll
            for (int tt = 0; tt < 16; ++tt) {
              seg += las[16 * i + tt];
              col[tt * ld] = split(__expf(seg) * as_f(col[tt * ld]) * dts_s,
                                   static_cast<S*>(nullptr));
            }
          }
        }
        if (hi == np) ws[s] = __expf(seg) * dts_s;
      }
      __syncthreads();                       // M, exp(cum), w set
      // w X split, [p][s], into the state stash every warp has read
      for (int p = tid >> 7; p < P; p += 2) {
        const int s = tid & 127;
        if (s < np)
          wxs[p * ldw + s] = split(to_f(xs[s * ldx + p]) * ws[s],
                                   static_cast<S*>(nullptr));
      }
      __syncthreads();
    }
    if (r0 < np) {
      if (live) {
        const float e0 = ecum[r0 + gq], e1 = ecum[r0 + gq + 8];
#pragma unroll
        for (int j = 0; j < kNY; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
        const S* mw = mb + band_base(warp, ps);
        const int ldm = band_ld(warp, ps);
        for (int k0 = 0; k0 <= r0; k0 += 16) {
          if constexpr (sizeof(T) == 2) {
            uint32_t ah[4], al[4], bb[kNY / 2][4];
            frag_a_split(ah, al, mw, ldm, 0, k0, gq, tq);
#pragma unroll
            for (int j = 0; j < kNY; j += 2)
              frag_b2_kn(bb[j / 2], xs, ldx, 8 * j, k0, lane);
#pragma unroll
            for (int j = 0; j < kNY; ++j)
              mma(acc[j], ah, bb[j / 2][2 * (j & 1)],
                  bb[j / 2][2 * (j & 1) + 1]);
#pragma unroll
            for (int j = 0; j < kNY; ++j)
              mma(acc[j], al, bb[j / 2][2 * (j & 1)],
                  bb[j / 2][2 * (j & 1) + 1]);
          } else {
#pragma unroll
            for (int j = 0; j < kNY; ++j)
              fma_tile<true>(acc[j], mw, ldm, 0, xs, ldx, 8 * j, k0, gq,
                             tq);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNY; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = r0 + gq + 4 * e;
          const int p = p0 + 8 * j + 2 * tq;
          T* out = y + ((row0 + t) * d.nh + h) * d.hd + p;
          if (t < n && p + 1 < d.hd && d.hd % 2 == 0) {
            store2(out, acc[j][e], acc[j][e + 1]);
          } else if (t < n) {
            if (p < d.hd) out[0] = from_f<T>(acc[j][e]);
            if (p + 1 < d.hd) out[1] = from_f<T>(acc[j][e + 1]);
          }
        }
      }
    }

    if (live) {
      // state = exp(cum_last) state + (w X)^T B over the chunk's rows s
      const float decay = ecum[n - 1];
#pragma unroll
      for (int i = 0; i < kNS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] *= decay;
      for (int k0 = 0; k0 < np; k0 += 16) {
        if constexpr (sizeof(T) == 2) {
          uint32_t ah[4], al[4];
          frag_a_split(ah, al, wxs, ldw, 16 * mt, k0, gq, tq);
#pragma unroll
          for (int i = 0; i < kNS; i += 2) {
            if (8 * tile(i) < dsp) {
              uint32_t bb[4];
              frag_b2_kn(bb, bs, ldc, 8 * tile(i), k0, lane);
              mma(st[i], ah, bb[0], bb[1]);
              mma(st[i + 1], ah, bb[2], bb[3]);
              mma(st[i], al, bb[0], bb[1]);
              mma(st[i + 1], al, bb[2], bb[3]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < kNS; ++i)
            if (8 * tile(i) < dsp)
              fma_tile<true>(st[i], wxs, ldw, 16 * mt, bs, ldc,
                             8 * tile(i), k0, gq, tq);
        }
      }
      __syncthreads();                       // every warp's w X read
      stash_state();
    }
  }

#pragma unroll
  for (int i = 0; i < kNS; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 16 * mt + gq + 8 * (e >> 1);
      const int k = 8 * tile(i) + 2 * tq + (e & 1);
      if (p < d.hd && k < d.ds) hout[(sbase + p) * d.ds + k] = st[i][e];
    }
  }
}

Dims make_dims(int len, int nh, int hd, int ds, int groups, int chunk,
               int x_rs, int b_rs, int c_rs, int slice) {
  const int q = chunk < len ? chunk : len;
  return Dims{len, nh, hd, ds, groups, nh / groups, q, pad16(q), pad16(ds),
              (len + q - 1) / q, (hd + slice - 1) / slice, x_rs, b_rs, c_rs};
}

// raise both kernels' dynamic shared memory limit: at every launch, as
// a once-only guard would be one object across the kernel libraries
// loaded in one process
template <typename T, int kDs, bool kStates = false>
cudaError_t set_smem(const Dims& d, size_t& s1, size_t& s2) {
  s1 = cb_smem<T>(d.qp, d.dsp);
  s2 = walk_smem<T>(d.qp, d.dsp);
  if (s1 > kMaxSmem || s2 > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_walk_kernel<T, kDs, kStates>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(s2));
}

template <typename T, int kDs, bool kStates>
int launch_form(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, const void* h0, void* y, void* hout,
                void* cb, void* states, int batch, const Dims& d,
                cudaStream_t stream) {
  size_t s1, s2;
  cudaError_t err = set_smem<T, kDs, kStates>(d, s1, s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_cb_kernel<T><<<dim3(d.nc * d.groups * (d.qp / 16), batch), kThreads,
                     s1, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(cb), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_walk_kernel<T, kDs, kStates><<<dim3(d.nh * d.nslice, batch), kThreads,
                                      s2, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(cb),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hout), static_cast<float*>(states), d);
  return static_cast<int>(cudaGetLastError());
}

// the training form where a states pointer is given, else the serving one
template <typename T, int kDs>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* h0, void* y, void* hout, void* cb,
           void* states, int batch, const Dims& d, cudaStream_t stream) {
  if (states != nullptr)
    return launch_form<T, kDs, true>(x, dt, a, bm, cm, h0, y, hout, cb,
                                     states, batch, d, stream);
  return launch_form<T, kDs, false>(x, dt, a, bm, cm, h0, y, hout, cb,
                                    nullptr, batch, d, stream);
}

template <typename T, int kDs>
int info(int batch, const Dims& d, int* out) {
  size_t s1, s2;
  cudaError_t err = set_smem<T, kDs>(d, s1, s2);
  cudaFuncAttributes f1, f2;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&f1, ssd_cb_kernel<T>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f2, ssd_walk_kernel<T, kDs>);
  int per1 = 0, per2 = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per1, ssd_cb_kernel<T>, kThreads, s1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per2, ssd_walk_kernel<T, kDs>, kThreads, s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[10] = {d.nc * d.groups * (d.qp / 16) * batch,
                     static_cast<int>(s1), f1.numRegs, per1,
                     d.nh * d.nslice * batch, static_cast<int>(s2),
                     f2.numRegs, per2, d.nslice, d.qp};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// the instance for the call's dtype (0 = float32, 1 = bfloat16) and DS
template <template <typename, int> class F, typename... A>
int dispatch(int dtype, int ds, A... args) {
  if (dtype == 1)
    return ds <= 128 ? F<bf16, 128>::run(args..., Tr<bf16>::kSlice)
                     : F<bf16, kMaxDs>::run(args..., Tr<bf16>::kSlice);
  if (dtype == 0)
    return ds <= 128 ? F<float, 128>::run(args..., Tr<float>::kSlice)
                     : F<float, kMaxDs>::run(args..., Tr<float>::kSlice);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool refused(int batch, int len, int nh, int hd, int ds, int groups,
             int chunk) {
  return batch <= 0 || len <= 0 || nh <= 0 || hd <= 0 || ds <= 0 ||
         ds > kMaxDs || groups <= 0 || nh % groups != 0 || chunk <= 0 ||
         chunk > kMaxChunk || batch > 65535;
}

template <typename T, int kDs>
struct Launch {
  static int run(const void* x, const void* dt, const void* a,
                 const void* bm, const void* cm, const void* h0, void* y,
                 void* hout, void* cb, void* states, int batch, int len,
                 int nh, int hd, int ds, int groups, int chunk, int x_rs,
                 int b_rs, int c_rs, cudaStream_t stream, int slice) {
    return launch<T, kDs>(x, dt, a, bm, cm, h0, y, hout, cb, states, batch,
                          make_dims(len, nh, hd, ds, groups, chunk, x_rs,
                                    b_rs, c_rs, slice),
                          stream);
  }
};
template <typename T, int kDs>
struct Info {
  static int run(int batch, int len, int nh, int hd, int ds, int groups,
                 int chunk, int* out, int slice) {
    return info<T, kDs>(batch, make_dims(len, nh, hd, ds, groups, chunk, 0,
                                         0, 0, slice), out);
  }
};

}  // namespace

// x: (B, L, NH, HD) and bm, cm: (B, L, G, DS) in one dtype (0 = float32,
// 1 = bfloat16), each (b, t) row `*_rs` elements after the last and its
// inner dims contiguous; dt: (B, L, NH) and a: (NH,) float32; h0 and
// hout: (B, NH, HD, DS) float32 (they may alias); y: (B, L, NH, HD)
// contiguous; cb: a float32 workspace of B * ceil(L / Q) * G * Q16^2
// floats, Q = min(chunk, L) and Q16 it rounded up to 16; states: null
// (serving), or the training form's (B, NH, ceil(L / Q), HD, DS) float32
// output, the state at the start of each chunk.  chunk: rows
// per chunk, 1..128; DS at most 256 (and the shared memory within 227
// KB).  Launches the two kernels and returns the first failing launch's
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* h0, void* y, void* hout, void* cb,
                               void* states, int batch, int len, int nh,
                               int hd, int ds, int groups, int chunk,
                               int x_rs, int b_rs, int c_rs, int dtype,
                               void* stream) {
  if (refused(batch, len, nh, hd, ds, groups, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Launch>(dtype, ds, x, dt, a, bm, cm, h0, y, hout, cb,
                          states, batch, len, nh, hd, ds, groups, chunk, x_rs,
                          b_rs, c_rs, static_cast<cudaStream_t>(stream));
}

// The launch plan of one call: out[0..9] = the cb kernel's blocks,
// dynamic shared memory bytes, registers per thread and blocks per SM,
// the same four of the walk kernel, the HD slices per head and the
// 16-padded chunk.  Returns a CUDA error code (0 on success).
extern "C" int ssd_scan_info(int batch, int len, int nh, int hd, int ds,
                             int groups, int chunk, int dtype, int* out) {
  if (refused(batch, len, nh, hd, ds, groups, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Info>(dtype, ds, batch, len, nh, hd, ds, groups, chunk,
                        out);
}
