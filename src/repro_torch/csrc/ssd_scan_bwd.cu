// The backward of the chunked Mamba2 SSD scan (ssd_scan.cu) for Hopper
// (sm_90a): dx, d dt, da, dB, dC and the initial state's gradient of
//   y, final state = ssd_scan(x, dt, a, B, C, initial state)
// from the forward's inputs, the state at the start of each chunk (which
// the forward's training form writes), dy and the final state's gradient.
//
// Replaces no TPU kernel.  The reference trains its SSD layers by
// differentiating repro/models/mamba.py::ssd_chunked (:98) through XLA:
// its Pallas ssd_scan defines no VJP.  The port's forward of those layers
// is the hand-written ssd_scan kernel, so its gradient needs a kernel of
// its own (kernels/ssd_scan.py SSDScanFn).  It is the vector-Jacobian
// product of the function as kernels/ref.py::ref_ssd_scan defines it:
// seg(t, s) = sum_{s < r <= t} la_r summed directly, entries above the
// diagonal masked before exp, rows past L absent (dt = 0) and given no
// gradient.  The formulas, per (batch row, head) and chunk of n <= Q rows
// with e_t = exp(cum_t), E = exp(seg), M = E (C_t . B_s) dt_s, w_s =
// E[last, s] dt_s, H the chunk's start state and dH the gradient of its
// end state, are those of kernels/ref.py::ref_ssd_scan_bwd:
//   G[t, s] = dy_t . x_s;  dCB[t, s] = G E dt_s;
//   dx_s = sum_t M[t, s] dy_t + w_s (dH B_s);
//   dC_t = sum_s dCB[t, s] B_s + e_t (dy_t H);
//   dB_s = sum_t dCB[t, s] C_t + w_s (x_s dH);
//   d dt_s = sum_t G E (C_t . B_s) + (x_s . dH B_s) E[last, s] + dla_s a;
//   dla_r = sum_{t >= r} (dcum_t + rowsum_t - colsum_t), the sums over
//     s < t and over t > s of dseg = G E (C_t . B_s) dt_s (and, on the
//     last row, (x_s . dH B_s) w_s), whose difference's suffix sums are
//     the sums of dseg over the pairs s < r <= t that seg's la_r enters;
//   da = sum dla_r dt_r;  dH <- e_last dH + sum_t e_t dy_t^T C_t.
// A zero-dt chunk has M = w = 0 but a full dt gradient: nothing is
// skipped.
//
// The decomposition is that of the public mamba_ssm Triton backward
// (chunk_scan_bwd_*, state_passing_bwd, chunk_state_bwd_*): only the
// state gradient needs a sequential pass, and it is elementwise; every
// product is chunk-parallel.  Five kernels, up to eight launches a call,
// on the caller's stream, with no float atomics (two runs give the same
// bits):
//   1. ssd_bwd_cbt_kernel, one block per (batch row, chunk, group, 16
//      rows s): (C . B^T)^T = B_s . C_t for t >= the tile's first row,
//      once per GROUP (mamba2's 80 heads share one), into a workspace;
//   2. ssd_bwd_dterm_kernel, one block per (batch row, head, chunk): the
//      chunk's term of the state gradient dy^T (e o C) (HD x DS, over the
//      chunk's rows) into the chunk's slot of the dH workspace, and the
//      chunk's decay exp(cum_last);
//   3. ssd_bwd_dpass_kernel, a thread per (batch row, head, state
//      element): the reverse pass over the chunks, dH <- e_last dH +
//      term, in place, leaving each chunk's END-state gradient in its
//      slot and the initial state's gradient;
//   4. ssd_bwd_head_kernel, one block per (batch row, chunk, head), a
//      warp per 16 rows: C H^T -> dcum, B dH^T -> dx's carried term and
//      dw, then in 32-column steps G^T = x dy^T and (C . B^T)^T, from
//      which M^T (held in registers, the next product's A operand), dx
//      += M^T dy, d dt's intra-chunk sum and dseg's row and column sums;
//      then dla's suffix sums by a warp scan per 32 rows: d dt and the
//      chunk's da partial;
//   5. ssd_bwd_group_kernel, one block per (batch row, chunk, group, 64
//      DS columns, range of heads): per head of the range, in head order,
//      G^T E dt_s added into the range's dCB^T in shared memory (the sum
//      over heads BEFORE the products), w_s (x_s dH) into dB's and e_t
//      (dy_t H) into dC's register accumulators; then dB += dCB^T C and
//      dC += dCB B.  With one range it writes dB and dC; with more,
//      fp32 partials (kernels/ssd_scan.py bwd_ranges: mamba2's one group
//      of 80 heads at (4, 1024) is cut into 2 ranges of 40, 128 blocks in
//      one wave; jamba's 8 groups need none), which
//   6. ssd_bwd_sum_kernel sums in range order; it also sums da's
//      partials over (batch row, chunk).
//
// The decays: E(t, s) is never exp(cum_t - cum_s) (after a large decay
// early in a chunk cum is large and that difference keeps few digits).
// Per 16-row tile each row's in-tile prefix pre_t and each column's
// rest of its tile are running sums, the tiles' sums ts_i whole-tile
// sums; across tiles E(t, s) = EA[tile t][s] ER[t], EA = exp(rest_s +
// ts of the tiles between) and ER = exp(pre_t), inside a tile a direct
// sum.  Every sum adds terms of one sign (la = dt a <= 0).
//
// Arithmetic, as in the forward: mma.sync m16n8k16 (attn_tc.cuh).  x,
// B, C and dy are bf16, so their products are exact in the fp32
// accumulators; every fp32-valued operand (M^T, dCB^T, dH, H, e o C)
// enters as a split pair hi + lo of bf16 (hi = bf16(v), lo = bf16(v -
// hi), |v - hi - lo| <= 2^-18 |v|), two MMAs each, and the per-head
// scalings w_s and e_t are applied to the fp32 accumulators.  So the
// gradients keep fp32-like accuracy and ref.ssd_bwd_error_bound is
// unchanged.  Operands are staged in shared memory in the layout their
// fragments read (transposed where a product takes them so), so every
// fragment is a 4- or 8-byte load, by 16-byte loads 8 at a time a thread
// (stage()).  The three big kernels are instances per head width rounded
// up to 16 (16..64), so every loop over a head's columns unrolls with no
// branch and the MMAs of independent accumulators interleave.  fp32 (the
// checking type): the same schedule and fragment ownership, each thread
// computing its accumulator elements with scalar FMAs.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// mamba2-2.7b's training shape (B 4, L 1024, 80 heads of 64, DS 128,
// chunk 128, bf16) it must read x, dy, B, C, dt and the chunk states
// (~171 MB, the states 84 MB of it) and write dx, dB, dC, d dt and the
// initial state's gradient (~56 MB): ~0.07 ms; its products are ~32
// GFLOP, ~0.03 ms on the tensor cores, doubled by the split operands.
// Bytes bound it.  This design moves the dH workspace (84 MB written by
// 2, read and written by 3, read by 4 and 5), the states twice and the
// range partials (21 MB) besides, and the group blocks walk their heads
// one after another; PERF.md holds its times and where they go
// (tools/ssd_bwd_plans.py).
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
constexpr int kMaxTiles = kMaxChunk / 16;
constexpr int kMaxHd = 64;                   // head widths taken
constexpr int kMaxDs = 256;                  // state widths taken
constexpr int kKT = 64;                      // DS columns of a group block
constexpr int kSms = 132;                    // an H100 SXM's SMs
constexpr int kBlockHeads = 2;               // a group block's own work,
                                             // in heads' worth
constexpr size_t kMaxSmem = 232448;          // 227 KB per block

// Per element type: the element of a split (fp32-valued) operand, and
// the row pads (in elements) of the T and split arrays.
template <typename T>
struct Tr;
template <>
struct Tr<bf16> {
  using S = uint32_t;                        // hi | lo << 16
  static constexpr int kPadT = 8;
  static constexpr int kPadS = 8;
};
template <>
struct Tr<float> {
  using S = float;
  static constexpr int kPadT = 4;
  static constexpr int kPadS = 4;
};

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

// a split operand element from its fp32 value, and back
__device__ __forceinline__ uint32_t split(float v, uint32_t*) {
  const bf16 hi = __float2bfloat16(v);
  const bf16 lo = __float2bfloat16(v - __bfloat162float(hi));
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16);
}
__device__ __forceinline__ float split(float v, float*) { return v; }
__device__ __forceinline__ float unsplit(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16(
             static_cast<unsigned short>(v & 0xffffu))) +
         __bfloat162float(
             __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16)));
}
__device__ __forceinline__ float unsplit(float v) { return v; }

// --- bf16 fragments of mma.sync m16n8k16 (see tc::mma_16816) ----------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// A[r0.., k0..] of a row-major bf16 array with row stride ld (even)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* A,
                                       int ld, int r0, int k0, int g,
                                       int t) {
  const bf16* p = A + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// B[k0.., n0..] of an array stored [n][k] with row stride ld (even)
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* B,
                                       int ld, int n0, int k0, int g,
                                       int t) {
  const bf16* p = B + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
// two interleaved split elements -> the hi pair and the lo pair
__device__ __forceinline__ void unsplit2(uint32_t& hi, uint32_t& lo,
                                         const uint32_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  hi = __byte_perm(v.x, v.y, 0x5410);
  lo = __byte_perm(v.x, v.y, 0x7632);
}
// B[k0.., n0..] of split elements stored [n][k]: hi and lo fragments
__device__ __forceinline__ void frag_b_split(uint32_t (&bh)[2],
                                             uint32_t (&bl)[2],
                                             const uint32_t* B, int ld,
                                             int n0, int k0, int g, int t) {
  const uint32_t* p = B + (n0 + g) * ld + k0 + 2 * t;
  unsplit2(bh[0], bl[0], p);
  unsplit2(bh[1], bl[1], p + 8);
}
// two fp32 values -> their hi pair and lo pair of bf16
__device__ __forceinline__ void split2(uint32_t& hi, uint32_t& lo, float v0,
                                       float v1) {
  const uint32_t s0 = split(v0, static_cast<uint32_t*>(nullptr));
  const uint32_t s1 = split(v1, static_cast<uint32_t*>(nullptr));
  hi = __byte_perm(s0, s1, 0x5410);
  lo = __byte_perm(s0, s1, 0x7632);
}
// a bf16 pair (row r, columns k and k + 1, k even) of a row-major matrix
// in device memory at row stride rs, zero past `rows` and `cols`: one
// 4-byte load where the pair is aligned (w32), else two
__device__ __forceinline__ uint32_t gpair(const bf16* m, long long rs, int r,
                                          int k, int rows, int cols,
                                          bool w32) {
  if (r >= rows) return 0u;
  const bf16* p = m + r * rs + k;
  if (w32 && k + 1 < cols) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = k < cols ? __bfloat16_as_ushort(p[0]) : 0u;
  const uint32_t hi = k + 1 < cols ? __bfloat16_as_ushort(p[1]) : 0u;
  return lo | (hi << 16);
}
// A[r0.., k0..] of such a matrix
__device__ __forceinline__ void gfrag_a(uint32_t (&a)[4], const bf16* m,
                                        long long rs, int r0, int k0,
                                        int rows, int cols, int g, int t) {
  const bool w32 = reinterpret_cast<uintptr_t>(m) % 4 == 0 && rs % 2 == 0;
  a[0] = gpair(m, rs, r0 + g, k0 + 2 * t, rows, cols, w32);
  a[1] = gpair(m, rs, r0 + g + 8, k0 + 2 * t, rows, cols, w32);
  a[2] = gpair(m, rs, r0 + g, k0 + 2 * t + 8, rows, cols, w32);
  a[3] = gpair(m, rs, r0 + g + 8, k0 + 2 * t + 8, rows, cols, w32);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  tc::mma_16816(d, a[0], a[1], a[2], a[3], b[0], b[1]);
}

// --- fp32: the same accumulator elements by scalar FMAs -----------------

// d += A[{g, g + 8}, 0..15] . B[0..15, {2t, 2t + 1}] of one m16n8k16
// tile, A(r, k) and B(k, c) given by the caller
template <class FA, class FB>
__device__ __forceinline__ void fma16(float (&d)[4], FA a, FB b, int g,
                                      int t) {
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    const float a0 = a(g, kk), a1 = a(g + 8, kk);
    const float b0 = b(kk, 2 * t), b1 = b(kk, 2 * t + 1);
    d[0] = fmaf(a0, b0, d[0]);
    d[1] = fmaf(a0, b1, d[1]);
    d[2] = fmaf(a1, b0, d[2]);
    d[3] = fmaf(a1, b1, d[3]);
  }
}
// an element of a row-major matrix in device memory, zero past the edges
template <typename T>
__device__ __forceinline__ float gval(const T* m, long long rs, int r, int k,
                                      int rows, int cols) {
  return (r < rows && k < cols) ? to_f(m[r * rs + k]) : 0.f;
}

// --- shapes -------------------------------------------------------------

struct Dims {
  int batch, len, nh, hd, ds, groups, hpg;
  int chunk, qp, hdp, dsp, nc, nkt, ranges, per;
  long long x_rs, b_rs, c_rs;                // element stride of a (b, t) row
};

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

Dims make_dims(int batch, int len, int nh, int hd, int ds, int groups,
               int chunk, int x_rs, int b_rs, int c_rs) {
  const int q = chunk < len ? chunk : len;
  const int nc = (len + q - 1) / q, hpg = nh / groups;
  const int nkt = (ds + kKT - 1) / kKT;
  // the head ranges of the group blocks (kernels/ssd_scan.py bwd_ranges):
  // a group block holds an SM, so a call takes about (its waves of kSms
  // blocks) x (the heads a block walks + kBlockHeads); the fewest ranges
  // that minimise that
  const long long base = static_cast<long long>(batch) * nc * groups * nkt;
  long long best = -1;
  int per = hpg;
  for (int want = 1; want <= hpg; ++want) {
    const int heads = (hpg + want - 1) / want;
    const long long waves = (base * ((hpg + heads - 1) / heads) + kSms - 1) /
                            kSms;
    const long long cost = waves * (heads + kBlockHeads);
    if (best < 0 || cost < best) {
      best = cost;
      per = heads;
    }
  }
  return Dims{batch, len, nh, hd, ds, groups, hpg, q, pad16(q), pad16(hd),
              pad16(ds), nc, nkt, (hpg + per - 1) / per, per, x_rs, b_rs,
              c_rs};
}

// the workspace, in floats: (B . C^T)^T's band (B, n_chunks, G, Q16,
// Q16); the chunks' state gradients (B, NH, n_chunks, HD, DS); the
// chunks' decays (B, NH, n_chunks); the da partials (NH, B, n_chunks);
// with more than one range the dB and dC partials (ranges, B, L, G, DS)
struct Work {
  float *cbt, *dhs, *elast, *pda, *pdb, *pdc;
};
__host__ __device__ inline long long part_floats(const Dims& d) {
  return static_cast<long long>(d.batch) * d.len * d.groups * d.ds;
}
Work carve(float* w, const Dims& d) {
  Work k;
  k.cbt = w;
  k.dhs = k.cbt + static_cast<long long>(d.batch) * d.nc * d.groups * d.qp *
                      d.qp;
  k.elast = k.dhs + static_cast<long long>(d.batch) * d.nh * d.nc * d.hd *
                        d.ds;
  k.pda = k.elast + static_cast<long long>(d.batch) * d.nh * d.nc;
  k.pdb = k.pda + static_cast<long long>(d.nh) * d.batch * d.nc;
  k.pdc = k.pdb + (d.ranges > 1 ? d.ranges * part_floats(d) : 0);
  return k;
}

// --- the decays of one (chunk, head) -------------------------------------

struct Decay {
  float dtv[kMaxChunk];                      // dt (0 past n)
  float la[kMaxChunk];                       // dt a
  float pre[kMaxChunk];                      // in-tile prefix of la
  float er[kMaxChunk];                       // exp(pre)
  float e[kMaxChunk];                        // exp(cum)
  float esl[kMaxChunk];                      // E[n - 1, s]
  float w[kMaxChunk];                        // E[n - 1, s] dt_s
  float ts[kMaxTiles];                       // whole-tile sums of la
  float ea[kMaxTiles][kMaxChunk];            // EA[tile][s]
  float de[kMaxChunk][16];                   // in-tile E[t][s % 16]
};

// E(t, s) for s <= t (0 above the diagonal)
__device__ __forceinline__ float decay_at(const Decay& dc, int t, int s) {
  const int it = t >> 4;
  if ((s >> 4) < it) return dc.ea[it][s] * dc.er[t];
  return s <= t ? dc.de[t][s & 15] : 0.f;
}

// The tables from dc.dtv and dc.la (set for rows < qp, zero past n);
// `tables` false builds e only.  Ends with the block synchronised.
__device__ void build_decays(Decay& dc, int n, int qp, bool tables) {
  const int t = threadIdx.x;
  float rest = 0.f;
  if (t < qp) {
    const int i0 = t & ~15;
    float acc = 0.f;
    for (int r = i0; r <= t; ++r) acc += dc.la[r];
    dc.pre[t] = acc;
    dc.er[t] = expf(acc);
    if ((t & 15) == 15) dc.ts[t >> 4] = acc;
    if (tables) {
      float sa = 0.f;
      dc.de[t][t & 15] = 1.f;
      for (int j = (t & 15) - 1; j >= 0; --j) {
        sa += dc.la[i0 + j + 1];
        dc.de[t][j] = expf(sa);
      }
      for (int j = (t & 15) + 1; j < 16; ++j) dc.de[t][j] = 0.f;
      for (int r = t + 1; r < i0 + 16; ++r) rest += dc.la[r];
    }
  }
  __syncthreads();
  if (t < qp) {
    const int it = t >> 4;
    float cum = 0.f;
    for (int i = 0; i < it; ++i) cum += dc.ts[i];
    dc.e[t] = expf(cum + dc.pre[t]);
    if (tables) {
      float acc = rest;
      for (int i = it + 1; i < qp / 16; ++i) {
        dc.ea[i][t] = expf(acc);
        acc += dc.ts[i];
      }
    }
  }
  __syncthreads();
  if (tables && t < qp) {
    const float v = decay_at(dc, n - 1, t);
    dc.esl[t] = v;
    dc.w[t] = v * dc.dtv[t];
  }
  __syncthreads();
}

// dt of (batch row, chunk rows row0.., head h) into the tables
__device__ __forceinline__ void load_dt(Decay& dc, const float* dt,
                                        long long row0, int n, int qp,
                                        int nh, int h, float av) {
  const int t = threadIdx.x;
  if (t < qp) {
    const float v = t < n ? dt[(row0 + t) * nh + h] : 0.f;
    dc.dtv[t] = v;
    dc.la[t] = v * av;
  }
}

// --- copies into shared memory ------------------------------------------

// Each thread takes kLoads 16-byte units a round, all its loads issued
// before its stores, so a block keeps kThreads x kLoads x 16 bytes of
// reads in flight (threads that each waited out the memory's latency
// per element left the SMs idle: PERF.md row 7b).
constexpr int kLoads = 8;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint32_t* p, float v) {
  *p = split(v, static_cast<uint32_t*>(nullptr));
}
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);                  // bf16 sources: exact
}
struct One {
  __device__ float operator()(int) const { return 1.f; }
};

// dst[r * ld + c] (or, transposed, dst[c * ld + r]) = scale(r) src[r *
// rs + c] for r < rows, c < cols, zero past valid_rows / valid_cols:
// 16-byte loads where the rows allow them, else one element at a time.
// Transposed, consecutive lanes take consecutive rows, so their stores
// fall on consecutive words (lanes along a row would write one column
// apart, ld apart: one bank); else each lane stores its unit as 16-byte
// vectors (dst's rows a multiple of 16 bytes).
template <bool kTrans, typename E, typename Src, class Scale = One>
__device__ __forceinline__ void stage(E* dst, int ld, const Src* src,
                                      long long rs, int rows, int cols,
                                      int valid_rows, int valid_cols,
                                      Scale scale = Scale()) {
  constexpr int V = 16 / sizeof(Src);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && rs % V == 0 &&
      valid_cols % V == 0 && cols % V == 0) {
    const int cv = cols / V, total = rows * cv;
    auto at = [&](int i, int& r, int& c) {
      if constexpr (kTrans) {
        r = i % rows;
        c = i / rows * V;
      } else {
        r = i / cv;
        c = (i - r * cv) * V;
      }
    };
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kLoads) {
      uint4 raw[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        int r, c;
        const int i = i0 + u * kThreads;
        at(i, r, c);
        raw[u] = (i < total && r < valid_rows && c < valid_cols)
                     ? *reinterpret_cast<const uint4*>(src + r * rs + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        int r, c;
        const int i = i0 + u * kThreads;
        if (i >= total) break;
        at(i, r, c);
        const Src* v = reinterpret_cast<const Src*>(&raw[u]);
        const float sc = scale(r);
        if constexpr (kTrans) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            put(dst + (c + e) * ld + r, sc * to_f(v[e]));
        } else {
          static_assert(sizeof(E) * V % 16 == 0, "whole 16-byte stores");
          __align__(16) E out[V];
#pragma unroll
          for (int e = 0; e < V; ++e) put(out + e, sc * to_f(v[e]));
#pragma unroll
          for (int q = 0; q < static_cast<int>(sizeof(out) / 16); ++q)
            reinterpret_cast<uint4*>(dst + r * ld + c)[q] =
                reinterpret_cast<const uint4*>(out)[q];
        }
      }
    }
    return;
  }
  const int total = rows * cols;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const int r = kTrans ? i % rows : i / cols;
      const int c = kTrans ? i / rows : i - r * cols;
      v[u] = (i < total && r < valid_rows && c < valid_cols)
                 ? to_f(src[r * rs + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const int r = kTrans ? i % rows : i / cols;
      const int c = kTrans ? i / rows : i - r * cols;
      if (i < total)
        put(kTrans ? dst + c * ld + r : dst + r * ld + c, scale(r) * v[u]);
    }
  }
}

// --- 1. (C . B^T)^T once per (batch row, chunk, group, 16 rows) ---------

template <typename T>
__host__ __device__ constexpr size_t cbt_smem(int qp, int dsp) {
  return sizeof(T) * static_cast<size_t>(16 + qp) * (dsp + Tr<T>::kPadT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cbt_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                   float* __restrict__ cbt, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = d.qp / 16, i = blockIdx.x % tiles;
  const int g = blockIdx.x / tiles % d.groups;
  const int c = blockIdx.x / tiles / d.groups;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int gq = (tid & 31) >> 2, tq = tid & 3;
  const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0), np = pad16(n);
  const int s0 = 16 * i;                     // this block's rows s
  if (s0 >= np) return;
  const long long row0 = static_cast<long long>(b) * d.len + c0;
  const long long gcol = static_cast<long long>(g) * d.ds;
  const int ld = d.dsp + Tr<T>::kPadT;
  T* bs = reinterpret_cast<T*>(smem_raw);    // (16, ld): B[s0 + s][k]
  T* cs = bs + 16 * ld;                      // (np - s0, ld): C[s0 + t][k]
  const T* brow = bm + (row0 + s0) * d.b_rs + gcol;
  const T* crow = cm + (row0 + s0) * d.c_rs + gcol;
  stage<false>(bs, ld, brow, d.b_rs, 16, d.dsp, n - s0, d.ds);
  stage<false>(cs, ld, crow, d.c_rs, np - s0, d.dsp, n - s0, d.ds);
  __syncthreads();
  // columns t >= s0: n-tiles warp and warp + 8 of the np - s0 columns
  const int nn = (np - s0) / 8;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < d.dsp; k0 += 16) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = warp + 8 * u;
      if (j >= nn) continue;
      if constexpr (sizeof(T) == 2) {
        uint32_t a[4], bb[2];
        frag_a(a, bs, ld, 0, k0, gq, tq);
        frag_b(bb, cs, ld, 8 * j, k0, gq, tq);
        mma(acc[u], a, bb);
      } else {
        fma16(acc[u], [&](int r, int kk) { return bs[r * ld + k0 + kk]; },
              [&](int kk, int cc) { return cs[(8 * j + cc) * ld + k0 + kk]; },
              gq, tq);
      }
    }
  }
  float* out = cbt + ((static_cast<long long>(b) * d.nc + c) * d.groups + g) *
                         d.qp * d.qp;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = warp + 8 * u;
    if (j >= nn) continue;
    const int s = s0 + gq, t = s0 + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(out + s * d.qp + t) =
        make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(out + (s + 8) * d.qp + t) =
        make_float2(acc[u][2], acc[u][3]);
  }
}

// --- 2. each chunk's term of the state gradient -------------------------

__host__ __device__ constexpr int pad32(int v) { return (v + 31) & ~31; }
__host__ __device__ constexpr int pad64(int v) { return (v + 63) & ~63; }

template <typename T>
__host__ __device__ constexpr size_t dterm_smem(int qp, int hdp, int dsp) {
  using S = typename Tr<T>::S;
  return sizeof(Decay) +
         sizeof(T) * static_cast<size_t>(hdp) * (qp + Tr<T>::kPadT) +
         sizeof(S) * static_cast<size_t>(pad32(dsp)) * (qp + Tr<T>::kPadS);
}

// term[p][k] = sum_t dy[t][p] e_t C[t][k]: A = dy^T [p][t] (bf16, exact),
// B = (e o C)^T [k][t] split; warp w takes the units (16 rows p, 32
// columns k) w, w + 8, ..., four accumulators a unit
template <typename T, int kHD>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dterm_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                     const T* __restrict__ cm, const T* __restrict__ dy,
                     Work wk, Dims d) {
  using S = typename Tr<T>::S;
  constexpr int kMT = kHD / 16;              // m-tiles of a head's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Decay& dc = *reinterpret_cast<Decay*>(smem_raw);
  const int qp = d.qp, ldy = qp + Tr<T>::kPadT, lde = qp + Tr<T>::kPadS;
  const int ds32 = pad32(d.dsp);
  T* dyt = reinterpret_cast<T*>(smem_raw + sizeof(Decay));   // (kHD, ldy)
  S* ect = reinterpret_cast<S*>(dyt + kHD * ldy);            // (ds32, lde)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int gq = (tid & 31) >> 2, tq = tid & 3;
  const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0);
  const long long row0 = static_cast<long long>(b) * d.len + c0;
  const long long gcol = static_cast<long long>(h / d.hpg) * d.ds;
  load_dt(dc, dt, row0, n, qp, d.nh, h, a[h]);
  const T* dyr = dy + (row0 * d.nh + h) * d.hd;
  const long long dy_rs = static_cast<long long>(d.nh) * d.hd;
  stage<true>(dyt, ldy, dyr, dy_rs, qp, kHD, n, d.hd);
  __syncthreads();
  build_decays(dc, n, qp, false);
  const T* crow = cm + row0 * d.c_rs + gcol;
  stage<true>(ect, lde, crow, d.c_rs, qp, ds32, n, d.ds,
              [&](int t) { return dc.e[t]; });
  __syncthreads();
  const long long slot = (static_cast<long long>(b) * d.nh + h) * d.nc + c;
  float* out = wk.dhs + slot * d.hd * d.ds;
  for (int un = warp; un < kMT * (ds32 / 32); un += kWarps) {
    const int p0 = 16 * (un % kMT), n0 = 32 * (un / kMT);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < qp; k0 += 16) {
      if constexpr (sizeof(T) == 2) {
        uint32_t af[4], bh[4][2], bl[4][2];
        frag_a(af, dyt, ldy, p0, k0, gq, tq);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          frag_b_split(bh[j], bl[j], ect, lde, n0 + 8 * j, k0, gq, tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[j], af, bh[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[j], af, bl[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fma16(acc[j],
                [&](int r, int kk) { return dyt[(p0 + r) * ldy + k0 + kk]; },
                [&](int kk, int cc) {
                  return ect[(n0 + 8 * j + cc) * lde + k0 + kk];
                },
                gq, tq);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + 8 * (e >> 1);
        const int k = n0 + 8 * j + 2 * tq + (e & 1);
        if (p < d.hd && k < d.ds) out[p * d.ds + k] = acc[j][e];
      }
    }
  }
  if (tid == 0) wk.elast[slot] = dc.e[n - 1];
}

// --- 3. the reverse pass over the chunks --------------------------------

// a thread per V consecutive elements (float4 where HD DS allows), the
// chunks taken kLoads at a time with their loads issued first
template <typename V>
__device__ __forceinline__ V fma_v(float e, V r, V t);
template <>
__device__ __forceinline__ float fma_v(float e, float r, float t) {
  return fmaf(e, r, t);
}
template <>
__device__ __forceinline__ float4 fma_v(float e, float4 r, float4 t) {
  return make_float4(fmaf(e, r.x, t.x), fmaf(e, r.y, t.y), fmaf(e, r.z, t.z),
                     fmaf(e, r.w, t.w));
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dpass_kernel(const float* __restrict__ dstate, float* __restrict__ dh0,
                     Work wk, Dims d) {
  constexpr int kV = sizeof(V) / sizeof(float);
  const long long hs = static_cast<long long>(d.hd) * d.ds / kV;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= hs) return;
  const long long bh = static_cast<long long>(blockIdx.z) * d.nh + blockIdx.y;
  V* slots = reinterpret_cast<V*>(wk.dhs) + bh * d.nc * hs + i;
  const float* el = wk.elast + bh * d.nc;
  V run = {};
  if (dstate != nullptr) run = reinterpret_cast<const V*>(dstate)[bh * hs + i];
  for (int c0 = d.nc - 1; c0 >= 0; c0 -= kLoads) {
    V t[kLoads];
    float e[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (c0 - u < 0) break;
      t[u] = slots[(c0 - u) * hs];
      e[u] = el[c0 - u];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (c0 - u < 0) break;
      slots[(c0 - u) * hs] = run;
      run = fma_v(e[u], run, t[u]);
    }
  }
  reinterpret_cast<V*>(dh0)[bh * hs + i] = run;
}

// --- 4. the head blocks -------------------------------------------------

template <typename T>
struct HeadSmem {
  // offsets in bytes of the block's arrays (qp, hdp, dsp padded)
  size_t dys, dyt, hb, vec, rs, red, mscr, total;
  __host__ __device__ HeadSmem(int qp, int hdp, int dsp) {
    using S = typename Tr<T>::S;
    const size_t ldy = hdp + Tr<T>::kPadT, ldt = qp + Tr<T>::kPadT;
    const size_t ldh = pad64(dsp) + Tr<T>::kPadS;
    dys = sizeof(Decay);
    dyt = dys + sizeof(T) * qp * ldy;
    hb = dyt + sizeof(T) * hdp * ldt;
    vec = hb + sizeof(S) * hdp * ldh;        // dcum, dw, ddte, colsum
    rs = vec + sizeof(float) * 4 * qp;       // (kWarps, qp): column sums
    red = rs + sizeof(float) * kWarps * qp;  // (4, kWarps): the tail's sums
    mscr = red + sizeof(float) * 4 * kWarps; // fp32: M^T per warp
    total = mscr + (sizeof(T) == 4 ? sizeof(float) * kWarps * 16 * 33 : 0);
  }
};

// a count known at compile time, for the steps of 16 or 32 columns
template <int N>
struct Int {
  static constexpr int value = N;
};

// kHD: the head's columns rounded up to 16 (every loop over them unrolls
// with no branch, so the MMAs of independent accumulators interleave)
template <typename T, int kHD>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_head_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const T* __restrict__ dy,
                    const float* __restrict__ states, T* __restrict__ dx,
                    float* __restrict__ ddt, Work wk, Dims d) {
  using S = typename Tr<T>::S;
  constexpr bool kBf = sizeof(T) == 2;
  constexpr int hdp = kHD, kNP = kHD / 8, kKS = kHD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qp = d.qp, dsq = pad64(d.dsp);   // H's columns, zero past DS
  const HeadSmem<T> L(qp, hdp, d.dsp);
  Decay& dc = *reinterpret_cast<Decay*>(smem_raw);
  const int ldy = hdp + Tr<T>::kPadT, ldt = qp + Tr<T>::kPadT;
  const int ldh = dsq + Tr<T>::kPadS;
  T* dys = reinterpret_cast<T*>(smem_raw + L.dys);    // (qp, ldy): dy[t][p]
  T* dyt = reinterpret_cast<T*>(smem_raw + L.dyt);    // (hdp, ldt): dy[t][p]^T
  S* hb = reinterpret_cast<S*>(smem_raw + L.hb);      // (hdp, ldh): H, then dH
  float* dcum = reinterpret_cast<float*>(smem_raw + L.vec);
  float* dwv = dcum + qp;
  float* ddte = dwv + qp;
  float* colsum = ddte + qp;
  float* rs = reinterpret_cast<float*>(smem_raw + L.rs);
  float* red = reinterpret_cast<float*>(smem_raw + L.red);
  float* mscr = reinterpret_cast<float*>(smem_raw + L.mscr);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0), np = pad16(n);
  const long long row0 = static_cast<long long>(b) * d.len + c0;
  const int g = h / d.hpg;
  const float av = a[h];
  const long long gcol = static_cast<long long>(g) * d.ds;
  const long long slot = (static_cast<long long>(b) * d.nh + h) * d.nc + c;
  const float* hsrc = states + slot * d.hd * d.ds;
  const float* dhsrc = wk.dhs + slot * d.hd * d.ds;
  const T* xr = x + row0 * d.x_rs + static_cast<long long>(h) * d.hd;
  const T* br = bm + row0 * d.b_rs + gcol;
  const T* cr = cm + row0 * d.c_rs + gcol;
  const T* dyr = dy + (row0 * d.nh + h) * d.hd;
  const long long dy_rs = static_cast<long long>(d.nh) * d.hd;

  load_dt(dc, dt, row0, n, qp, d.nh, h, av);
  stage<false>(dys, ldy, dyr, dy_rs, qp, hdp, n, d.hd);
  stage<true>(dyt, ldt, dyr, dy_rs, qp, hdp, n, d.hd);
  stage<false>(hb, ldh, hsrc, d.ds, hdp, dsq, d.hd, d.ds);
  for (int i = tid; i < kWarps * qp; i += kThreads) rs[i] = 0.f;
  __syncthreads();
  build_decays(dc, n, qp, true);

  const int r0 = 16 * warp;                  // this warp's rows (t or s)
  const bool rows = r0 < np;
  // products over DS of this warp's 16 rows of `m` (C or B, in device
  // memory) by hb's rows p: acc[j] = columns p 8j .. 8j + 7
  auto by_state = [&](float (&acc)[kNP][4], const T* m, long long m_rs) {
    // bf16: the A fragments of 4 k-steps loaded first, their reads in
    // flight together; then per k-step every B fragment, the hi MMAs and
    // the lo MMAs, each over kNP independent accumulators
    for (int k0 = 0; k0 < dsq; k0 += kBf ? 64 : 16) {
      if constexpr (kBf) {
        uint32_t af[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gfrag_a(af[q], m, m_rs, r0, k0 + 16 * q, n, d.ds, gq, tq);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t bh[kNP][2], bl[kNP][2];
#pragma unroll
          for (int j = 0; j < kNP; ++j)
            frag_b_split(bh[j], bl[j], hb, ldh, 8 * j, k0 + 16 * q, gq, tq);
#pragma unroll
          for (int j = 0; j < kNP; ++j) mma(acc[j], af[q], bh[j]);
#pragma unroll
          for (int j = 0; j < kNP; ++j) mma(acc[j], af[q], bl[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNP; ++j) {
          fma16(acc[j],
                [&](int r, int kk) {
                  return gval(m, m_rs, r0 + r, k0 + kk, n, d.ds);
                },
                [&](int kk, int cc) {
                  return hb[(8 * j + cc) * ldh + k0 + kk];
                },
                gq, tq);
        }
      }
    }
  };
  // the quad's sum of a value of rows gq and gq + 8
  auto quad = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  // (c) C_t H^T -> dcum_t = e_t (dy_t . C_t H^T), rows t of this warp
  if (rows) {
    float ch[kNP][4] = {};
    by_state(ch, cr, d.c_rs);
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      const T* y0 = dys + (r0 + gq) * ldy + 8 * j + 2 * tq;
      const T* y1 = y0 + 8 * ldy;
      v0 += ch[j][0] * to_f(y0[0]) + ch[j][1] * to_f(y0[1]);
      v1 += ch[j][2] * to_f(y1[0]) + ch[j][3] * to_f(y1[1]);
    }
    v0 = quad(v0);
    v1 = quad(v1);
    if (tq == 0) {
      dcum[r0 + gq] = dc.e[r0 + gq] * v0;
      dcum[r0 + gq + 8] = dc.e[r0 + gq + 8] * v1;
    }
  }
  __syncthreads();                           // every read of H done
  // dH into the same buffer, and this thread's share of dH . H, H as the
  // buffer holds it (hi + lo bf16: 2^-17 of each term, well inside
  // ssd_bwd_error_bound's 1e-4 of the |.| sum)
  float dot = 0.f;
  const bool v4 = reinterpret_cast<uintptr_t>(dhsrc) % 16 == 0 &&
                  d.ds % 4 == 0;
  const int cw = v4 ? 4 : 1, cv = dsq / cw;
  for (int i0 = tid; i0 < hdp * cv; i0 += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads, p = i / cv, k = (i - p * cv) * cw;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < hdp * cv && p < d.hd && k < d.ds) {
        if (v4) v[u] = *reinterpret_cast<const float4*>(dhsrc + p * d.ds + k);
        else v[u].x = dhsrc[p * d.ds + k];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads, p = i / cv, k = (i - p * cv) * cw;
      if (i >= hdp * cv) break;
      const float e4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      S* q = hb + p * ldh + k;
      for (int e = 0; e < cw; ++e) {
        dot = fmaf(e4[e], unsplit(q[e]), dot);
        q[e] = split(e4[e], static_cast<S*>(nullptr));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if (lane == 0) red[warp] = dot;
  __syncthreads();

  // (b) dxa = B_s dH^T, rows s of this warp: dw_s = x_s . dxa_s, and
  // dx starts as w_s dxa_s
  float dxa[kNP][4] = {};
  if (rows) {
    by_state(dxa, br, d.b_rs);
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      const int p = 8 * j + 2 * tq;
      v0 += dxa[j][0] * gval(xr, d.x_rs, r0 + gq, p, n, d.hd) +
            dxa[j][1] * gval(xr, d.x_rs, r0 + gq, p + 1, n, d.hd);
      v1 += dxa[j][2] * gval(xr, d.x_rs, r0 + gq + 8, p, n, d.hd) +
            dxa[j][3] * gval(xr, d.x_rs, r0 + gq + 8, p + 1, n, d.hd);
    }
    v0 = quad(v0);
    v1 = quad(v1);
    if (tq == 0) {
      dwv[r0 + gq] = v0;
      dwv[r0 + gq + 8] = v1;
    }
    const float w0 = dc.w[r0 + gq], w1 = dc.w[r0 + gq + 8];
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      dxa[j][0] *= w0;
      dxa[j][1] *= w0;
      dxa[j][2] *= w1;
      dxa[j][3] *= w1;
    }
  }

  // (a) columns t >= r0 of G^T and (C . B^T)^T, 32 at a time (16 for a
  // last step of 16): M^T into dx, u into d dt's intra sum and dseg's row
  // and column sums
  if (rows) {
    const int s_a = r0 + gq, s_b = s_a + 8;  // this thread's rows s
    const float dts_a = dc.dtv[s_a], dts_b = dc.dtv[s_b];
    uint32_t xa[kKS][4];
    if constexpr (kBf) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        gfrag_a(xa[ks], xr, d.x_rs, r0, 16 * ks, n, d.hd, gq, tq);
    }
    const float* cbg = wk.cbt + ((static_cast<long long>(b) * d.nc + c) *
                                     d.groups + g) * qp * qp;
    float dte_a = 0.f, dte_b = 0.f, col_a = 0.f, col_b = 0.f;
    auto step = [&](int t0, auto nj_c) {
      constexpr int kNJ = decltype(nj_c)::value;
      float gt[kNJ][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if constexpr (kBf) {
          uint32_t bb[kNJ][2];
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj)
            frag_b(bb[jj], dys, ldy, t0 + 8 * jj, 16 * ks, gq, tq);
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj) mma(gt[jj], xa[ks], bb[jj]);
        } else {
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj)
            fma16(gt[jj],
                  [&](int r, int kk) {
                    return gval(xr, d.x_rs, r0 + r, 16 * ks + kk, n, d.hd);
                  },
                  [&](int kk, int cc) {
                    return dys[(t0 + 8 * jj + cc) * ldy + 16 * ks + kk];
                  },
                  gq, tq);
        }
      }
      float mt[kNJ][4], rp[kNJ][2];
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        rp[jj][0] = rp[jj][1] = 0.f;
        const int tc0 = t0 + 8 * jj + 2 * tq;
        const float2 cb0 = *reinterpret_cast<const float2*>(
            cbg + s_a * qp + tc0);
        const float2 cb1 = *reinterpret_cast<const float2*>(
            cbg + s_b * qp + tc0);
        const float cbv[4] = {cb0.x, cb0.y, cb1.x, cb1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? s_a : s_b, t = tc0 + (e & 1);
          const float dts = e < 2 ? dts_a : dts_b;
          const float ev = t >= s ? decay_at(dc, t, s) : 0.f;
          const float ec = ev * cbv[e];
          const float u = gt[jj][e] * ec;
          mt[jj][e] = ec * dts;
          const float dsg = t > s ? u * dts : 0.f;
          if (e < 2) {
            dte_a += u;
            col_a += dsg;
          } else {
            dte_b += u;
            col_b += dsg;
          }
          rp[jj][e & 1] += dsg;
        }
      }
      // dseg's column sums over this warp's 16 rows: the 8 row lanes
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = rp[jj][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) rs[warp * qp + t0 + 8 * jj + 2 * tq + e] = v;
        }
      }
      // dx_s += sum_t M^T[s][t] dy_t over these columns
      if constexpr (kBf) {
#pragma unroll
        for (int kk = 0; kk < kNJ / 2; ++kk) {
          uint32_t ah[4], al[4], bb[kNP][2];
          split2(ah[0], al[0], mt[2 * kk][0], mt[2 * kk][1]);
          split2(ah[1], al[1], mt[2 * kk][2], mt[2 * kk][3]);
          split2(ah[2], al[2], mt[2 * kk + 1][0], mt[2 * kk + 1][1]);
          split2(ah[3], al[3], mt[2 * kk + 1][2], mt[2 * kk + 1][3]);
#pragma unroll
          for (int j = 0; j < kNP; ++j)
            frag_b(bb[j], dyt, ldt, 8 * j, t0 + 16 * kk, gq, tq);
#pragma unroll
          for (int j = 0; j < kNP; ++j) mma(dxa[j], ah, bb[j]);
#pragma unroll
          for (int j = 0; j < kNP; ++j) mma(dxa[j], al, bb[j]);
        }
      } else {
        float* ms = mscr + warp * 16 * 33;
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ms[(gq + 8 * (e >> 1)) * 33 + 8 * jj + 2 * tq + (e & 1)] =
                mt[jj][e];
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kNJ / 2; ++kk) {
#pragma unroll
          for (int j = 0; j < kNP; ++j)
            fma16(dxa[j],
                  [&](int r, int q) { return ms[r * 33 + 16 * kk + q]; },
                  [&](int q, int cc) {
                    return dyt[(8 * j + cc) * ldt + t0 + 16 * kk + q];
                  },
                  gq, tq);
        }
        __syncwarp();
      }
    };
    for (int t0 = r0; t0 < np; t0 += 32) {
      if (np - t0 >= 32) step(t0, Int<4>());
      else step(t0, Int<2>());
    }
    dte_a = quad(dte_a);
    dte_b = quad(dte_b);
    col_a = quad(col_a);
    col_b = quad(col_b);
    if (tq == 0) {
      ddte[s_a] = dte_a;
      ddte[s_b] = dte_b;
      colsum[s_a] = col_a;
      colsum[s_b] = col_b;
    }
    // dx out, rows past n dropped
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = e < 2 ? s_a : s_b, p = 8 * j + 2 * tq + (e & 1);
        if (s < n && p < d.hd)
          dx[((row0 + s) * d.nh + h) * d.hd + p] = from_f<T>(dxa[j][e]);
      }
    }
  }
  __syncthreads();
  // dla by suffix sums over the rows, a warp scan per 32 rows, then d dt
  // and da; every sum in a fixed order
  float* wpart = red + kWarps;               // (kWarps): sum dsw
  float* wtot = red + 2 * kWarps;            // (kWarps): suffix totals
  float* dpart = red + 3 * kWarps;           // (kWarps): sum dla dt
  const int t = tid;
  const bool mine = warp < (qp + 31) / 32;
  const float dsw = t < n - 1 ? dwv[t] * dc.w[t] : 0.f;
  if (mine) {
    float v = dsw;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) wpart[warp] = v;
  }
  __syncthreads();
  float dla = 0.f;
  if (mine) {
    float dlast = 0.f, wsum = 0.f;
    for (int w = 0; w < kWarps; ++w) dlast += red[w];
    for (int w = 0; w < (qp + 31) / 32; ++w) wsum += wpart[w];
    float dd = 0.f;
    if (t < n) {
      float rsum = 0.f;
      for (int w = 0; w <= (t >> 4); ++w) rsum += rs[w * qp + t];
      dd = dcum[t] + rsum - (colsum[t] + dsw);
      if (t == n - 1) dd += dlast * dc.e[n - 1] + wsum;
    }
    dla = dd;                                // the suffix sum in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, dla, o);
      if (lane + o < 32) dla += y;
    }
    if (lane == 0) wtot[warp] = dla;
  }
  __syncthreads();
  if (mine) {
    for (int w = warp + 1; w < (qp + 31) / 32; ++w) dla += wtot[w];
    float da = 0.f;
    if (t < n) {
      ddt[(row0 + t) * d.nh + h] = ddte[t] + dwv[t] * dc.esl[t] + dla * av;
      da = dla * dc.dtv[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) dpart[warp] = da;
  }
  __syncthreads();
  if (tid == 0) {
    float da = 0.f;
    for (int w = 0; w < (qp + 31) / 32; ++w) da += dpart[w];
    wk.pda[(static_cast<long long>(h) * d.batch + b) * d.nc + c] = da;
  }
}

// --- 5. the group blocks ------------------------------------------------

template <typename T>
struct GroupSmem {
  size_t ct, bt, dcb, dys, dht, ht, total;
  __host__ __device__ GroupSmem(int qp, int hdp) {
    using S = typename Tr<T>::S;
    const size_t ldc = qp + Tr<T>::kPadT, ldy = hdp + Tr<T>::kPadT;
    const size_t ldh = hdp + Tr<T>::kPadS;
    ct = sizeof(Decay);
    bt = ct + sizeof(T) * kKT * ldc;
    dcb = bt + sizeof(T) * kKT * ldc;
    dys = dcb + sizeof(float) * qp * (qp + 4);
    dht = dys + sizeof(T) * qp * ldy;
    ht = dht + sizeof(S) * kKT * ldh;
    total = ht + sizeof(S) * kKT * ldh;
  }
};

template <typename T, int kHD>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_group_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ bm,
                     const T* __restrict__ cm, const T* __restrict__ dy,
                     const float* __restrict__ states, T* __restrict__ dbm,
                     T* __restrict__ dcm, Work wk, Dims d) {
  using S = typename Tr<T>::S;
  constexpr bool kBf = sizeof(T) == 2;
  constexpr int kNK = kKT / 8;               // n-tiles of the DS tile
  constexpr int hdp = kHD, kKS = kHD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qp = d.qp;
  const GroupSmem<T> L(qp, hdp);
  Decay& dc = *reinterpret_cast<Decay*>(smem_raw);
  const int ldc = qp + Tr<T>::kPadT, ldq = qp + 4;
  const int ldy = hdp + Tr<T>::kPadT, ldh = hdp + Tr<T>::kPadS;
  T* ct = reinterpret_cast<T*>(smem_raw + L.ct);     // (kKT, ldc): C^T
  T* bt = reinterpret_cast<T*>(smem_raw + L.bt);     // (kKT, ldc): B^T
  float* dcb = reinterpret_cast<float*>(smem_raw + L.dcb);  // dCB^T[s][t]
  T* dys = reinterpret_cast<T*>(smem_raw + L.dys);   // (qp, ldy): dy[t][p]
  S* dht = reinterpret_cast<S*>(smem_raw + L.dht);   // (kKT, ldh): dH^T
  S* ht = reinterpret_cast<S*>(smem_raw + L.ht);     // (kKT, ldh): H^T

  int blk = blockIdx.x;
  const int kt = blk % d.nkt;
  blk /= d.nkt;
  const int r = blk % d.ranges;
  blk /= d.ranges;
  const int g = blk % d.groups, c = blk / d.groups, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0), np = pad16(n);
  const long long row0 = static_cast<long long>(b) * d.len + c0;
  const int k0 = kt * kKT, kn = min(kKT, d.ds - k0);
  const long long gcol = static_cast<long long>(g) * d.ds + k0;
  const int h0 = g * d.hpg + r * d.per;
  const int h1 = min(h0 + d.per, (g + 1) * d.hpg);
  const long long dy_rs = static_cast<long long>(d.nh) * d.hd;

  const T* cr = cm + row0 * d.c_rs + gcol;
  const T* br = bm + row0 * d.b_rs + gcol;
  stage<true>(ct, ldc, cr, d.c_rs, qp, kKT, n, kn);
  stage<true>(bt, ldc, br, d.b_rs, qp, kKT, n, kn);
  for (int i = tid; i < qp * ldq; i += kThreads) dcb[i] = 0.f;

  const int r0 = 16 * warp;
  const bool rows = r0 < np;
  float dba[kNK][4] = {}, dca[kNK][4] = {};
  for (int h = h0; h < h1; ++h) {
    __syncthreads();                         // the last head's reads done
    const long long slot = (static_cast<long long>(b) * d.nh + h) * d.nc + c;
    const float* hsrc = states + slot * d.hd * d.ds + k0;
    const float* dhsrc = wk.dhs + slot * d.hd * d.ds + k0;
    const T* dyr = dy + (row0 * d.nh + h) * d.hd;
    const T* xr = x + row0 * d.x_rs + static_cast<long long>(h) * d.hd;
    load_dt(dc, dt, row0, n, qp, d.nh, h, a[h]);
    stage<false>(dys, ldy, dyr, dy_rs, qp, hdp, n, d.hd);
    stage<true>(dht, ldh, dhsrc, d.ds, hdp, kKT, d.hd, kn);
    stage<true>(ht, ldh, hsrc, d.ds, hdp, kKT, d.hd, kn);
    __syncthreads();
    build_decays(dc, n, qp, true);
    if (!rows) continue;
    uint32_t xa[kKS][4];
    if constexpr (kBf) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        gfrag_a(xa[ks], xr, d.x_rs, r0, 16 * ks, n, d.hd, gq, tq);
    }
    // dCB^T[s][t] += G^T E dt_s over columns t >= r0, rows s of this warp,
    // 32 at a time (16 for a last step of 16)
    const int s_a = r0 + gq, s_b = s_a + 8;
    const float dts_a = dc.dtv[s_a], dts_b = dc.dtv[s_b];
    auto step = [&](int t0, auto nj_c) {
      constexpr int kNJ = decltype(nj_c)::value;
      float gt[kNJ][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if constexpr (kBf) {
          uint32_t bb[kNJ][2];
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj)
            frag_b(bb[jj], dys, ldy, t0 + 8 * jj, 16 * ks, gq, tq);
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj) mma(gt[jj], xa[ks], bb[jj]);
        } else {
#pragma unroll
          for (int jj = 0; jj < kNJ; ++jj)
            fma16(gt[jj],
                  [&](int rr, int kk) {
                    return gval(xr, d.x_rs, r0 + rr, 16 * ks + kk, n, d.hd);
                  },
                  [&](int kk, int cc) {
                    return dys[(t0 + 8 * jj + cc) * ldy + 16 * ks + kk];
                  },
                  gq, tq);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int tc0 = t0 + 8 * jj + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? s_a : s_b, t = tc0 + (e & 1);
          const float dts = e < 2 ? dts_a : dts_b;
          if (t >= s) dcb[s * ldq + t] += gt[jj][e] * decay_at(dc, t, s) * dts;
        }
      }
    };
    for (int t0 = r0; t0 < np; t0 += 32) {
      if (np - t0 >= 32) step(t0, Int<4>());
      else step(t0, Int<2>());
    }
    // dB_s += w_s (x_s . dH^T) and dC_t += e_t (dy_t . H^T) over the tile
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      float tmp[kNK][4] = {};
      const S* src = side == 0 ? dht : ht;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if constexpr (kBf) {
          uint32_t af[4], bh[kNK][2], bl[kNK][2];
          if (side == 0) {
#pragma unroll
            for (int q = 0; q < 4; ++q) af[q] = xa[ks][q];
          } else {
            frag_a(af, dys, ldy, r0, 16 * ks, gq, tq);
          }
#pragma unroll
          for (int j = 0; j < kNK; ++j)
            frag_b_split(bh[j], bl[j], src, ldh, 8 * j, 16 * ks, gq, tq);
#pragma unroll
          for (int j = 0; j < kNK; ++j) mma(tmp[j], af, bh[j]);
#pragma unroll
          for (int j = 0; j < kNK; ++j) mma(tmp[j], af, bl[j]);
        } else {
#pragma unroll
          for (int j = 0; j < kNK; ++j) {
            fma16(tmp[j],
                  [&](int rr, int kk) {
                    return side == 0
                               ? gval(xr, d.x_rs, r0 + rr, 16 * ks + kk, n,
                                      d.hd)
                               : to_f(dys[(r0 + rr) * ldy + 16 * ks + kk]);
                  },
                  [&](int kk, int cc) {
                    return src[(8 * j + cc) * ldh + 16 * ks + kk];
                  },
                  gq, tq);
          }
        }
      }
      const float* sc = side == 0 ? dc.w : dc.e;
      const float f0 = sc[s_a], f1 = sc[s_b];
      float (*acc)[4] = side == 0 ? dba : dca;
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        acc[j][0] = fmaf(f0, tmp[j][0], acc[j][0]);
        acc[j][1] = fmaf(f0, tmp[j][1], acc[j][1]);
        acc[j][2] = fmaf(f1, tmp[j][2], acc[j][2]);
        acc[j][3] = fmaf(f1, tmp[j][3], acc[j][3]);
      }
    }
  }
  __syncthreads();                           // dCB^T summed over the range
  if (rows) {
    // dB_s += sum_{t >= r0} dCB^T[s][t] C_t: A = dCB^T rows s, split
    for (int t0 = r0; t0 < np; t0 += 16) {
      if constexpr (kBf) {
        uint32_t ah[4], al[4];
        const float* p0 = dcb + (r0 + gq) * ldq + t0 + 2 * tq;
        const float* p1 = p0 + 8 * ldq;
        split2(ah[0], al[0], p0[0], p0[1]);
        split2(ah[1], al[1], p1[0], p1[1]);
        split2(ah[2], al[2], p0[8], p0[9]);
        split2(ah[3], al[3], p1[8], p1[9]);
        uint32_t bb[kNK][2];
#pragma unroll
        for (int j = 0; j < kNK; ++j) frag_b(bb[j], ct, ldc, 8 * j, t0, gq, tq);
#pragma unroll
        for (int j = 0; j < kNK; ++j) mma(dba[j], ah, bb[j]);
#pragma unroll
        for (int j = 0; j < kNK; ++j) mma(dba[j], al, bb[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kNK; ++j)
          fma16(dba[j],
                [&](int rr, int kk) { return dcb[(r0 + rr) * ldq + t0 + kk]; },
                [&](int kk, int cc) {
                  return to_f(ct[(8 * j + cc) * ldc + t0 + kk]);
                },
                gq, tq);
      }
    }
    // dC_t += sum_{s < r0 + 16} dCB^T[s][t] B_s: A = dCB rows t, split
    for (int s0 = 0; s0 <= r0; s0 += 16) {
      if constexpr (kBf) {
        uint32_t ah[4], al[4];
        const int t_a = r0 + gq, s = s0 + 2 * tq;
        split2(ah[0], al[0], dcb[s * ldq + t_a], dcb[(s + 1) * ldq + t_a]);
        split2(ah[1], al[1], dcb[s * ldq + t_a + 8],
               dcb[(s + 1) * ldq + t_a + 8]);
        split2(ah[2], al[2], dcb[(s + 8) * ldq + t_a],
               dcb[(s + 9) * ldq + t_a]);
        split2(ah[3], al[3], dcb[(s + 8) * ldq + t_a + 8],
               dcb[(s + 9) * ldq + t_a + 8]);
        uint32_t bb[kNK][2];
#pragma unroll
        for (int j = 0; j < kNK; ++j) frag_b(bb[j], bt, ldc, 8 * j, s0, gq, tq);
#pragma unroll
        for (int j = 0; j < kNK; ++j) mma(dca[j], ah, bb[j]);
#pragma unroll
        for (int j = 0; j < kNK; ++j) mma(dca[j], al, bb[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kNK; ++j)
          fma16(dca[j],
                [&](int rr, int kk) { return dcb[(s0 + kk) * ldq + r0 + rr]; },
                [&](int kk, int cc) {
                  return to_f(bt[(8 * j + cc) * ldc + s0 + kk]);
                },
                gq, tq);
      }
    }
    // out: rows past n and columns past DS dropped
    const long long part = d.ranges > 1 ? static_cast<long long>(r) *
                                              part_floats(d) : 0;
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r0 + gq + 8 * (e >> 1), k = 8 * j + 2 * tq + (e & 1);
        if (rr >= n || k >= kn) continue;
        const long long o = (row0 + rr) * d.groups * d.ds + gcol + k;
        if (d.ranges > 1) {
          wk.pdb[part + o] = dba[j][e];
          wk.pdc[part + o] = dca[j][e];
        } else {
          dbm[o] = from_f<T>(dba[j][e]);
          dcm[o] = from_f<T>(dca[j][e]);
        }
      }
    }
  }
}

// --- 6. the partials' sums, in a fixed order ----------------------------

// out[r, k] = sum_{j < J} in[r, j, k], for r < rows and k < K
template <typename TO>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ in, TO* __restrict__ out,
                   long long rows, int nj, long long nk) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= rows * nk) return;
  const long long rr = i / nk, k = i % nk;
  const float* src = in + rr * nj * nk + k;
  float sum = 0.f;
  for (int j = 0; j < nj; ++j) sum += src[static_cast<long long>(j) * nk];
  out[i] = from_f<TO>(sum);
}

template <typename TO>
cudaError_t sum_launch(const float* in, TO* out, long long rows, int nj,
                       long long nk, cudaStream_t stream) {
  const long long n = rows * nk;
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ssd_bwd_sum_kernel<TO><<<blocks, kThreads, 0, stream>>>(in, out, rows, nj,
                                                          nk);
  return cudaGetLastError();
}

// --- launches -----------------------------------------------------------

struct Smem {
  size_t cbt, dterm, head, group;
};

// raise the kernels' dynamic shared memory limits: at every launch, as a
// once-only guard would be one object across the kernel libraries loaded
// in one process
template <typename T, int kHD>
cudaError_t set_smem(const Dims& d, Smem& s) {
  s.cbt = cbt_smem<T>(d.qp, d.dsp);
  s.dterm = dterm_smem<T>(d.qp, d.hdp, d.dsp);
  s.head = HeadSmem<T>(d.qp, d.hdp, d.dsp).total;
  s.group = GroupSmem<T>(d.qp, d.hdp).total;
  if (s.cbt > kMaxSmem || s.dterm > kMaxSmem || s.head > kMaxSmem ||
      s.group > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cbt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s.cbt));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_dterm_kernel<T, kHD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.dterm));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_head_kernel<T, kHD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.head));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_group_kernel<T, kHD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.group));
  return err;
}

template <typename T, int kHD>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* dy, const void* dstate,
           const void* states, void* dx, void* ddt, void* da, void* dbm,
           void* dcm, void* dh0, void* work, const Dims& d,
           cudaStream_t stream) {
  Smem sm;
  cudaError_t err = set_smem<T, kHD>(d, sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Work wk = carve(static_cast<float*>(work), d);
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const T* bt = static_cast<const T*>(bm);
  const T* ctt = static_cast<const T*>(cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* st = static_cast<const float*>(states);
  ssd_bwd_cbt_kernel<T><<<dim3(d.nc * d.groups * (d.qp / 16), d.batch),
                          kThreads, sm.cbt, stream>>>(bt, ctt, wk.cbt, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dterm_kernel<T, kHD><<<dim3(d.nc, d.nh, d.batch), kThreads,
                                 sm.dterm, stream>>>(dtf, af, ctt, dyt, wk,
                                                     d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long hs = static_cast<long long>(d.hd) * d.ds;
  const bool vec = hs % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dstate) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((hs / (vec ? 4 : 1) + kThreads - 1) /
                                        kThreads),
                  d.nh, d.batch);
  if (vec)
    ssd_bwd_dpass_kernel<float4><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(dstate), static_cast<float*>(dh0), wk, d);
  else
    ssd_bwd_dpass_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(dstate), static_cast<float*>(dh0), wk, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_kernel<T, kHD><<<dim3(d.nh, d.nc, d.batch), kThreads,
                                sm.head, stream>>>(
      xt, dtf, af, bt, ctt, dyt, st, static_cast<T*>(dx),
      static_cast<float*>(ddt), wk, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_group_kernel<T, kHD><<<dim3(d.nc * d.groups * d.ranges * d.nkt,
                                      d.batch),
                                 kThreads, sm.group, stream>>>(
      xt, dtf, af, bt, ctt, dyt, st, static_cast<T*>(dbm),
      static_cast<T*>(dcm), wk, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d.ranges > 1) {
    err = sum_launch(wk.pdb, static_cast<T*>(dbm), 1, d.ranges,
                     part_floats(d), stream);
    if (err == cudaSuccess)
      err = sum_launch(wk.pdc, static_cast<T*>(dcm), 1, d.ranges,
                       part_floats(d), stream);
  }
  if (err == cudaSuccess)
    err = sum_launch(wk.pda, static_cast<float*>(da), d.nh,
                     d.batch * d.nc, 1, stream);
  return static_cast<int>(err);
}

template <typename T, int kHD>
int info(const Dims& d, int* out) {
  Smem sm;
  cudaError_t err = set_smem<T, kHD>(d, sm);
  cudaFuncAttributes f1, f2, f3;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f1, ssd_bwd_dterm_kernel<T, kHD>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f2, ssd_bwd_head_kernel<T, kHD>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f3, ssd_bwd_group_kernel<T, kHD>);
  int per2 = 0, per3 = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per2, ssd_bwd_head_kernel<T, kHD>, kThreads, sm.head);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per3, ssd_bwd_group_kernel<T, kHD>, kThreads, sm.group);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[14] = {d.nc * d.groups * (d.qp / 16) * d.batch,
                     d.nc * d.nh * d.batch, static_cast<int>(sm.dterm),
                     f1.numRegs, d.nh * d.nc * d.batch,
                     static_cast<int>(sm.head), f2.numRegs, per2,
                     d.nc * d.groups * d.ranges * d.nkt * d.batch,
                     static_cast<int>(sm.group), f3.numRegs, per3, d.ranges,
                     d.per};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

// f.template operator()<T, kHD>() for the call's dtype (0 = float32, 1 =
// bfloat16) and head width rounded up to 16
template <class F>
int dispatch(int dtype, int hdp, F f) {
  auto by_hd = [&](auto t) {
    using T = decltype(t);
    switch (hdp) {
      case 16: return f.template operator()<T, 16>();
      case 32: return f.template operator()<T, 32>();
      case 48: return f.template operator()<T, 48>();
      case 64: return f.template operator()<T, 64>();
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (dtype == 1) return by_hd(bf16());
  if (dtype == 0) return by_hd(0.f);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  const void *x, *dt, *a, *bm, *cm, *dy, *dstate, *states;
  void *dx, *ddt, *da, *dbm, *dcm, *dh0, *work;
  const Dims& d;
  cudaStream_t stream;
  template <typename T, int kHD>
  int operator()() const {
    return launch<T, kHD>(x, dt, a, bm, cm, dy, dstate, states, dx, ddt, da,
                          dbm, dcm, dh0, work, d, stream);
  }
};
struct Info {
  const Dims& d;
  int* out;
  template <typename T, int kHD>
  int operator()() const {
    return info<T, kHD>(d, out);
  }
};

bool refused(int batch, int len, int nh, int hd, int ds, int groups,
             int chunk) {
  return batch <= 0 || len <= 0 || nh <= 0 || hd <= 0 || hd > kMaxHd ||
         ds <= 0 || ds > kMaxDs || groups <= 0 || nh % groups != 0 ||
         chunk <= 0 || chunk > kMaxChunk || batch > 65535 || nh > 65535;
}

}  // namespace

// x: (B, L, NH, HD) and bm, cm: (B, L, G, DS) in one dtype (0 = float32,
// 1 = bfloat16), each (b, t) row `*_rs` elements after the last and its
// inner dims contiguous; dy and dx: (B, L, NH, HD) in that dtype,
// contiguous; dt and ddt: (B, L, NH), a and da: (NH,), dstate (may be
// null: zeros) and dh0: (B, NH, HD, DS), states: (B, NH, n_chunks, HD,
// DS), all float32 and contiguous; dbm, dcm: (B, L, G, DS) in x's dtype,
// contiguous; work: a float32 workspace of B n_chunks G Q16^2 + B NH
// n_chunks HD DS + 2 B NH n_chunks (+ 2 ranges B L G DS with more than
// one head range) floats, Q16 = min(chunk, L) rounded up to 16
// (kernels/ssd_scan.py bwd_workspace_floats).  chunk: rows per chunk,
// 1..128, as the forward took it; HD at most 64, DS at most 256.  Makes
// the launches on `stream` and returns the first launch error (0 on
// success); never synchronises.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* dy, const void* dstate, const void* states,
    void* dx, void* ddt, void* da, void* dbm, void* dcm, void* dh0,
    void* work, int batch, int len, int nh, int hd, int ds, int groups,
    int chunk, int x_rs, int b_rs, int c_rs, int dtype, void* stream) {
  if (refused(batch, len, nh, hd, ds, groups, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(batch, len, nh, hd, ds, groups, chunk, x_rs, b_rs,
                           c_rs);
  if (d.nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d.hdp,
                  Launch{x, dt, a, bm, cm, dy, dstate, states, dx, ddt, da,
                         dbm, dcm, dh0, work, d,
                         static_cast<cudaStream_t>(stream)});
}

// The launch plan of one call: out[0..13] = the (B . C^T)^T kernel's
// blocks; the dH terms' blocks, dynamic shared bytes and registers a
// thread; the head kernel's blocks, shared bytes, registers and blocks
// per SM; the group kernel's four; the head ranges a group and the heads
// a range (kernels/ssd_scan.py BWD_PLAN_KEYS).  Returns a CUDA error
// code (0 on success).
extern "C" int ssd_scan_bwd_info(int batch, int len, int nh, int hd, int ds,
                                 int groups, int chunk, int dtype, int* out) {
  if (refused(batch, len, nh, hd, ds, groups, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(batch, len, nh, hd, ds, groups, chunk, 0, 0, 0);
  return dispatch(dtype, d.hdp, Info{d, out});
}
