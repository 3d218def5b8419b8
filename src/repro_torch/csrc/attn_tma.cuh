// The TMA-fed tile core of the paged ragged prefill (ragged_prefill.cuh's
// ragged_prefill_kernel_tma): the bf16 tile of attn_tiles.cuh at head
// width 128 over a page pool with no window, its K/V stream moved off
// the threads that multiply.
//
// Why.  attn_tiles.cuh's bf16 core has its 256 threads load as well as
// multiply: every 64-key step each thread issues 8 cp.async of 16 bytes,
// each after its own page-table lookup, into a three-stage ring.  Builds
// with the loads cut out ran several times faster than the whole kernel,
// builds with the MMAs cut out about as slow (PERF.md §6): the SMs are
// bound by issuing the stream, not by the tensor cores.
//
// What this core does about it.  A block is three warpgroups: two
// consumers on a tile of 128 query vectors, as in attn_tiles.cuh (64
// each; Q.K^T and P.V on wgmma, the online softmax in fp32), and a
// producer whose one warp streams K and V by TMA and whose other warps
// exit.  The producer gives its registers to the consumers (setmaxnreg:
// 24 against 240).  The pool (N_pages * page_size rows, Hkv, D) is one
// 3-D tensor map a tensor, with a box of one page x one KV head x 64
// columns (128 bytes, the 128-byte swizzle's row): a 64-key step is
// 64 / page_size pages x 2 column halves x (K, V) boxes, 16 at 16-token
// pages, issued by the lanes of the producer warp, one page a lane, each
// lane reading its page-table entry once.  Q arrives once by two boxes
// of a map over q (T, Hq, D): (128 / rep rows) x (rep heads) x 64
// columns.  The ring has kStages stages of K + V (32 KB each), each with
// a full mbarrier (the producer's arrival and the stage's bytes) and an
// empty one (one arrival a consumer warpgroup with vectors); Q's 32 KB and
// six stages take 225 KB of the SM's 227.  The consumers read the
// swizzled tiles through swizzled wgmma descriptors (attn_tc.cuh
// desc_sw128); their arithmetic is attn_tiles.cuh's, step for step, so
// both cores give the same bits on the same inputs.
//
// What TMA changes in the walk's edges.  A box moves a whole page, so
// the last page of a walk brings rows past its band's end hi (past
// kv_len, or past the causal frontier), and the pages of the last step
// past hi are not loaded at all, their rows holding whatever an earlier
// stage or block left there — rows a page pool "may hold anything" in,
// NaN included.  K rows past hi only meet masked scores (a select, so
// NaN never passes); V rows past hi would meet p = 0 in P.V, and 0 x NaN
// is NaN, so the consumers zero V's rows [hi, step end) in shared memory
// on the last step before P.V.  No box is issued for a page-table entry
// at or past hi: the entries past a segment's length may point anywhere.
//
// Taken only for PagedLayout, window 0, bf16, D = 128 and page sizes of
// 8, 16, 32 or 64 (tma_core): the box geometry belongs to the page pool
// (whole pages from position 0, 64 / page_size of them a step).  The
// ring's wrap and window, the arena's slot rows, the gathered rows, fp32
// and the other widths keep attn_tiles.cuh's core.
#pragma once

#include <cuda.h>   // CUtensorMap and its encoder's types; the encoder is
                    // reached through the runtime (no link to libcuda)

#include "attn_tiles.cuh"

namespace attn {

// Whether a paged prefill call takes the TMA-fed core (host and device
// agree: kernels/ragged_prefill.py tma_core states the same rule).
__host__ __device__ inline bool tma_core(int window, int dtype, int head_dim,
                                         int page_size) {
  return window == 0 && dtype == 1 && head_dim == 128 && page_size >= 8 &&
         page_size <= 64 && 64 % page_size == 0;
}

struct TmaTile {
  static constexpr int D = 128;
  static constexpr int kWG = 2;             // consumer warpgroups
  static constexpr int kThreads = 128 * (kWG + 1);   // + the producer's
  static constexpr int kM = 64 * kWG;       // query vectors per tile
  static constexpr int kN = 64;             // keys per K/V step
  static constexpr int kRow = 128;          // bytes of a swizzled row
  static constexpr int kQHalf = kM * kRow;  // Q's 64 columns: 16 KB
  static constexpr int kQBytes = 2 * kQHalf;
  static constexpr int kTileHalf = kN * kRow;   // a K or V half: 8 KB
  static constexpr int kKVBytes = 2 * kTileHalf;
  static constexpr int kStages = 6;       // TMA ring
  static constexpr int kBars = 2 * kStages + 1;
  // 1024 bytes to align the swizzle atoms, Q, the ring, the mbarriers
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * 2 * kKVBytes + kBars * 8;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kWG <= 65536,
                "the register file");

  // the tile's rows r0.. (q's row index), its key band from a, the
  // segment's page-table row pt
  static __device__ void run(const TileArgs<__nv_bfloat16>& a,
                             const CUtensorMap* qmap,
                             const CUtensorMap* kmap,
                             const CUtensorMap* vmap, const int* pt,
                             int page_size, int r0,
                             unsigned char* smem_raw) {
    const int tid = threadIdx.x;
    const int nq = a.n_rows * a.rep;
    const int busy_wgs = nq > 64 ? 2 : 1;   // consumers with vectors
    const int lo = a.lo(), hi = a.hi();
    const int n_tiles = hi > lo ? (hi - lo + kN - 1) / kN : 0;
    const uint32_t raw = tc::smem_addr(smem_raw);
    const uint32_t qs = (raw + 1023) & ~1023u;   // Q: two 64-column halves
    const uint32_t kv0 = qs + kQBytes;   // stage s: K at kv0 + 2 s kKV
                                         // (two halves), V after it
    uint64_t* full = reinterpret_cast<uint64_t*>(
        smem_raw + (qs - raw) + kQBytes + kStages * 2 * kKVBytes);
    uint64_t* empty = full + kStages;
    uint64_t* qbar = empty + kStages;
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        tc::mbar_init(&full[s], 1);
        tc::mbar_init(&empty[s], busy_wgs);
      }
      tc::mbar_init(qbar, 1);
    }
    __syncthreads();
    const int wg = tid / 128;

    if (wg == kWG) {                        // the producer
      tc::regs_dec<kProducerRegs>();
      const int lane = tid & 31;
      if (tid - 128 * kWG >= 32 || n_tiles == 0) return;
      if (lane == 0) {
        const int rows = kM / a.rep;
        tc::mbar_expect(qbar, 2 * rows * a.rep * kRow);
        tc::tma_load_3d(qs, qmap, qbar, 0, a.g * a.rep, r0);
        tc::tma_load_3d(qs + kQHalf, qmap, qbar, 64, a.g * a.rep, r0);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) tc::mbar_wait(&empty[s], (t / kStages - 1) & 1);
        const int kb = lo + t * kN;
        // the pages holding keys [kb, min(kb + kN, hi)): none past hi
        const int pages = (min(kb + kN, hi) - kb + page_size - 1) / page_size;
        if (lane == 0)
          tc::mbar_expect(&full[s], pages * page_size * 4 * kRow);
        __syncwarp();
        if (lane < pages) {
          const int row = pt[kb / page_size + lane] * page_size;
          const uint32_t ks = kv0 + s * 2 * kKVBytes + lane * page_size * kRow;
          const uint32_t vs = ks + kKVBytes;
          tc::tma_load_3d(ks, kmap, &full[s], 0, a.g, row);
          tc::tma_load_3d(ks + kTileHalf, kmap, &full[s], 64, a.g, row);
          tc::tma_load_3d(vs, vmap, &full[s], 0, a.g, row);
          tc::tma_load_3d(vs + kTileHalf, vmap, &full[s], 64, a.g, row);
        }
      }
      return;
    }

    tc::regs_inc<kConsumerRegs>();
    if (64 * wg >= nq) return;              // a warpgroup with no vectors
    const int consumers = 128 * busy_wgs;
    const int lane = tid & 31, quad = lane & 3;
    const uint32_t qw = qs + wg * 64 * kRow;   // this warpgroup's rows
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
    if (n_tiles > 0) tc::mbar_wait(qbar, 0);

    for (int t = 0; t < n_tiles; ++t) {     // block-uniform
      const int s = t % kStages;
      tc::mbar_wait(&full[s], (t / kStages) & 1);
      const uint32_t ks = kv0 + s * 2 * kKVBytes, vs = ks + kKVBytes;
      const int kb = lo + t * kN;
      if (kb + kN > hi) {
        // the walk's last step: V's rows [hi, kb + kN) hold a page's
        // rows past the band or another stage's leftovers; zero them
        // (both halves) before any P.V reads them
        const int first = hi - kb;
        for (int i = tid; i < (kN - first) * 16; i += consumers) {
          // 16-byte chunk i % 8 of row first + i / 16 in half (i / 8) % 2
          const uint32_t at = vs + (i / 8 % 2) * kTileHalf +
                              (first + i / 16) * kRow + (i % 8) * 16;
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at),
                       "r"(0) : "memory");
        }
        tc::fence_proxy_async();
        tc::bar_sync(1, consumers);
      }

      // S = Q.K^T over D in steps of 16: 4 steps a 64-column half
      float s_[kN / 2];
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::mma_ss_n64(
            s_,
            tc::desc_sw128(qw + (kk / 4) * kQHalf + (kk % 4) * 32, 16, 1024),
            tc::desc_sw128(ks + (kk / 4) * kTileHalf + (kk % 4) * 32, 16,
                           1024),
            kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(s_);

      // mask to each row's band, online softmax in fp32
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = kb + 8 * j + 2 * quad + e;
          float& s0 = s_[4 * j + e];
          float& s1 = s_[4 * j + 2 + e];
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
        const float p00 = exp2f(s_[4 * j] - m0),
                    p01 = exp2f(s_[4 * j + 1] - m0);
        const float p10 = exp2f(s_[4 * j + 2] - m1),
                    p11 = exp2f(s_[4 * j + 3] - m1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        const __nv_bfloat162 r0_ = __floats2bfloat162_rn(p00, p01);
        const __nv_bfloat162 r1_ = __floats2bfloat162_rn(p10, p11);
        pa[j / 2][2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(&r0_);
        pa[j / 2][2 * (j & 1) + 1] =
            *reinterpret_cast<const uint32_t*>(&r1_);
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

      // O += P.V over the step's keys in steps of 16 (two 8-key atoms)
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        tc::mma_rs<D>(o, pa[kk],
                      tc::desc_sw128(vs + kk * 16 * kRow, kTileHalf, 1024),
                      1);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(o);
      if ((tid & 127) == 0) tc::mbar_arrive(&empty[s]);   // stage read
    }

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
      __nv_bfloat16* dst = a.out + a.vec(v) * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
    }
  }
};

// ------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled through the runtime's entry-point
// query, looked up once; nullptr where the installed libcuda lacks it.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor (d2, d1, d0) row-major at base as a 3-D map with boxes
// (b2, b1, 64) and the 128-byte swizzle: each box row of 64 elements
// lands as one 128-byte row in shared memory.  Elements past the tensor
// read as 0.  Returns 0 on success.
inline int encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0,
                          uint64_t d1, uint64_t d2, uint32_t b1,
                          uint32_t b2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};   // bytes, dims 1, 2
  const cuuint32_t box[3] = {64, b1, b2};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace attn
