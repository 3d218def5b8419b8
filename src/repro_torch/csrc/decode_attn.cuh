// Flash decode for Hopper (sm_90a), over any KV layout of
// attn_common.cuh.  decode_attn_paged.cu, decode_attn_arena.cu and
// decode_attn_dense.cu each instantiate it for their layout and export
// one C entry point.
//
// Computes one query token per row b: the rep = Hq / Hkv query heads of
// each KV group attend over the row's keys at positions < lengths[b]
// (clamped to the layout's depth); with a window W > 0 (the ring and
// rolling layouts of attn_common.cuh) over the newest min(W, depth) of
// them, [lengths[b] - min(W, depth, lengths[b]), lengths[b]), which is
// the window of its query at lengths[b] - 1 among the positions the
// layout still holds.  Softmax is online in fp32, p is
// rounded to the storage type before the PV product while l sums the
// unrounded p (attn_common.cuh round_p), and a row with lengths == 0
// writes 0.
//
// What bounds it: decode reads every cached key and value once and does
// ~4·rep·D FLOPs per key and KV head, ~rep FLOP per byte in bf16, far
// below an H100's ~295 FLOP/byte ridge, so device memory bandwidth bounds
// it (8 rows x 2048 keys at 8 KV heads of 128 in bf16: 67 MB, 0.020 ms at
// 3.35 TB/s).  The design's job is to keep enough bytes in flight on
// every SM:
//
// 1. A split key walk over the whole card (flash-decoding).  The unit of
//    work is (KV head g, row b, key chunk c), one block of kWarps warps:
//    keys [lo + c·C, min(lo + (c + 1)·C, hi)) of the row's key range
//    [lo, hi), which is [0, min(lengths[b], depth)) without a window.
//    The chunk size C (a multiple of kRound, the keys the block's warps
//    take in one round) and the chunk count come from
//    kernels/decode_attn.py split_plan, from the shapes, the layout's
//    static depth (windowed: min(window, depth), the most keys a row's
//    range can span) and the SM count alone, never from
//    lengths: the launcher reads nothing back, the grid depends only on
//    shapes, and a launch can be captured in a CUDA graph.  A block whose
//    chunk starts at or past hi writes an empty partial (m = kNegInf,
//    l = 0) and exits, reading no K, V or page-table entry.  The others
//    write fp32 partials (acc[rep][D], m, l) into a workspace the launcher
//    allocates, and decode_combine_kernel, a second kernel launched from
//    the same entry point, merges each (b, g)'s partials in chunk order
//    and writes out.  A second kernel rather than the last block of each
//    (b, g) behind an atomic counter: the counters would need zeroed
//    memory at every launch (a memset, one more launch all the same) or a
//    persistent buffer shared by every stream and every captured graph,
//    and the combine reads only ~2 KB a chunk.  When the span fits one
//    chunk there is no workspace and the block writes out directly.
// 2. bf16 tiles stay bf16, in an asynchronous ring.  In a chunk, warp w
//    walks key tiles w, w + kWarps, ... of kKT keys with its own (m, l,
//    acc), copying each tile's K and V rows by 16-byte cp.async.cg (each
//    byte is read once) into a ring of kStages stages of its own in
//    dynamic shared memory: the next kStages - 1 tiles are in flight
//    while it computes on one, and the walk has no block barrier.  A lane
//    looks a key's row up (a page-table entry) only for keys below the
//    chunk's end, so never at or past ceil(n_keys / page_size).  No TMA:
//    a key row of one KV head is a 256-byte run behind a page-table
//    lookup, so a TMA descriptor per 16-row page would gain little over
//    cp.async.  A tile row's 16-byte chunks are XOR-swizzled by the row
//    (chunk c of row r at slot c ^ (r % 8)), so ldmatrix reads are free
//    of bank conflicts.  The swizzle permutes the slots of an aligned
//    group of 8, so a row's slots are D / 8 chunks padded up to a
//    multiple of 8: 8 at D = 64, 16 at D = 80, 96 and 128 (the 10 or 12
//    chunks of D = 80 or 96 sit in a 16-slot row, which is the ring of
//    D = 128, 96 KB a block; D = 64's is 48 KB).
// 3. Tensor cores on the GQA group.  S = q.K^T and O += P.V run as
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the group's rep <=
//    8 query heads as the M rows (rows rep..15 are zero): per 16-key tile
//    2 D / 16 MMAs for S from K by ldmatrix, and D / 8 for P.V from V by
//    ldmatrix.trans.  The S accumulator, rounded to bf16 pairs, is P's A
//    fragment with no exchange, as the prefill core's wgmma accumulator
//    is (attn_tiles.cuh).  Not wgmma: its 64-row M tile against <= 8
//    query heads of one row would leave 87-98% of it idle, and bytes, not
//    the tensor-core rate, bound this kernel.
// fp32, the checking type, stays on the CUDA cores: the same split walk
// and warp tiles, each tile copied synchronously (attn_common.cuh
// load_kv_tile) and scalar fp32 FMAs.
//
// Head widths: D = 64, 80, 96 and 128, every width of the reference's
// configs (attn_common.cuh with_form), in fp32 and bf16.
//
// On the card (PERF.md §6): at 8 rows x 2048 keys the bytes bound it as
// designed — throwaway builds with the K/V copies cut out ran several
// times faster, builds with the MMAs cut out no faster.  A short or
// uneven tick (one session, or one long row beside short ones) is bound
// instead by each launch's fixed chain: the row's length, its page-table
// entries, the first tile, the warps' merge, then the combine kernel's
// own launch and reads; with the copies cut out such a tick still took
// about twice its bytes' time.
//
// Scores are kept in log2 units (scaled by log2(e) / sqrt(D)), the
// partials' m too, and the merges use exp2 as the walk does.  Asked for
// (a non-null lse, the dense export only), each query head's
// log-sum-exp of its scaled scores in natural-log units, (m + log2 l)
// ln 2, is written beside its output, -inf on a row with no key: the
// partial a sequence-sharded cache's shards merge (distributed/local.py
// decode).  A null lse leaves every launch as it was.
//
// No row at or past lengths[b] is ever read: page-table entries past the
// valid length, and an arena slot's rows past it, may hold anything.
// Windowed, no position below the row's range is read either: its ring
// page or rolling row may already hold a newer position.
#pragma once

#include "attn_common.cuh"
#include "attn_tc.cuh"

namespace attn {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;              // query heads per KV group
constexpr int kKT = 16;                 // keys per warp tile
constexpr int kRound = kWarps * kKT;    // keys the block takes per round
constexpr int kStages = 3;              // bf16 ring stages per warp

// Each warp's (m, l, acc) of its query heads, merged into the block's
// partial after the walk (laid over the walk's shared memory).
template <int D>
struct Merge {
  float ml[kWarps][kMaxRep][2];
  float acc[kWarps][kMaxRep][D];
};

template <typename T, int D>
struct Walk;

// the natural-log log-sum-exp of a head's scores from its log2-unit max m
// and sum l > 0; a head with no key gets -inf (kNegInf is finite)
__device__ __forceinline__ float to_lse(float m, float l) {
  return (m + log2f(l)) * 0.6931471805599453f;
}
__device__ __forceinline__ float no_lse() {
  return __int_as_float(0xff800000);
}

// ------------------------------------------------------------ fp32 walk

template <int D>
struct Walk<float, D> {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  // a lane's output columns lane + 32 k, k < kCols (the last one partly
  // idle at D = 80 and 96)
  static constexpr int kCols = (D + 31) / 32;
  static constexpr int kWarpFloats = kKT * (D + 1) + kKT * D + kMaxRep * kKT;
  static constexpr size_t kSmem =
      sizeof(float) * (kMaxRep * D + kWarps * kWarpFloats);

  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][kCols];

  // q: the group's first query vector (its rep vectors are contiguous)
  template <typename Rows>
  __device__ void run(const float* __restrict__ q,
                      const float* __restrict__ kbuf,
                      const float* __restrict__ vbuf, Rows rows, int k0,
                      int k1, int hkv, int g, int rep, float scale,
                      unsigned char* smem_raw) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* qs = reinterpret_cast<float*>(smem_raw);      // [kMaxRep][D]
    float* ks = qs + kMaxRep * D + warp * kWarpFloats;   // [kKT][D + 1]
    float* vs = ks + kKT * (D + 1);                      // [kKT][D]
    float* ps = vs + kKT * D;                            // [kMaxRep][kKT]
    for (int idx = threadIdx.x; idx < kMaxRep * D; idx += kThreads)
      qs[idx] = idx / D < rep ? q[idx] : 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxRep; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[i][k] = 0.f;
    }
    // score phase: lane (j, half) dots key j of the tile with half of D;
    // half 1 walks its columns rotated by 16 so the two halves never hit
    // the same shared-memory bank
    const int j = lane & 15, half = lane >> 4;
    constexpr int kHalf = D / 2;
    for (int base = k0 + warp * kKT; base < k1; base += kRound) {
      load_kv_tile<float, D, kKT, 32>(kbuf, vbuf, rows, base, k1, hkv, g,
                                      lane, ks, vs);
      __syncwarp();
      const bool ok = base + j < k1;
      float alpha[kMaxRep];
#pragma unroll
      for (int i = 0; i < kMaxRep; ++i) {
        alpha[i] = 1.f;
        if (i < rep) {                   // warp-uniform
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
          const float m_new = fmaxf(m[i], tmax);
          const float p = ok ? exp2f(s - m_new) : 0.f;
          float psum = p;
#pragma unroll
          for (int w = 1; w < 16; w <<= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, w);
          alpha[i] = exp2f(m[i] - m_new);
          l[i] = alpha[i] * l[i] + psum;
          m[i] = m_new;
          if (half == 0) ps[i * kKT + j] = p;
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kMaxRep; ++i) {
        if (i < rep) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int d = lane + 32 * k;
            if (D % 32 != 0 && d >= D) break;
            float a = acc[i][k] * alpha[i];
#pragma unroll
            for (int jj = 0; jj < kKT; ++jj)
              a += ps[i * kKT + jj] * vs[jj * D + d];
            acc[i][k] = a;
          }
        }
      }
      __syncwarp();                      // tile buffers free for the next
    }
  }

  __device__ void stash(Merge<D>& mg, int rep) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kMaxRep; ++i) {
      if (i < rep) {
        if (lane == 0) {
          mg.ml[warp][i][0] = m[i];
          mg.ml[warp][i][1] = l[i];
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (D % 32 == 0 || lane + 32 * k < D)
            mg.acc[warp][i][lane + 32 * k] = acc[i][k];
      }
    }
  }
};

// ------------------------------------------------------------ bf16 walk

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int D>
struct Walk<__nv_bfloat16, D> {
  static_assert(D % 16 == 0, "m16n8k16 takes 16 columns at a time");
  static constexpr int kChunks = D / 8;              // 16-byte chunks a row
  // a row's 16-byte slots in the ring: kChunks padded to the swizzle's
  // group of 8, so chunk c ^ (r % 8) stays inside the row
  static constexpr int kSlots = (kChunks + 7) / 8 * 8;
  static constexpr int kTileBytes = kKT * kSlots * 16;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr size_t kSmem =
      static_cast<size_t>(kWarps) * kStages * kStageBytes;
  static constexpr int kCopies = kKT * kChunks / 32;  // per lane, K and V
  static_assert(kKT * kChunks % 32 == 0, "whole copy rounds");

  // the ring offset of chunk c of tile row r
  static __device__ __forceinline__ uint32_t slot(int r, int c) {
    return (r * kSlots + (c ^ (r & 7))) * 16;
  }

  // Lane (r = lane / 4, t = lane % 4) holds query head r of the group:
  // its running max m, its partial row sum l over the keys it scores
  // (2t, 2t + 1, 8 + 2t, 9 + 2t of each tile; the quad adds them at the
  // end), and O's columns 8j + 2t, + 1 in o[j][0], o[j][1] (o[j][2], [3]
  // are the zero rows 8..15).
  float m, l;
  float o[D / 8][4];

  template <typename Rows>
  __device__ void run(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ kbuf,
                      const __nv_bfloat16* __restrict__ vbuf, Rows rows,
                      int k0, int k1, int hkv, int g, int rep, float scale,
                      unsigned char* smem_raw) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int qr = lane >> 2, t = lane & 3;
    const uint32_t ring =
        tc::smem_addr(smem_raw) + warp * kStages * kStageBytes;

    // q's A fragments: row qr, columns 16 kk + 2t, + 1 and those + 8
    // (rows 8..15 are zero, so a[1] = a[3] = 0 in every MMA)
    uint32_t qa[D / 16][2];
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + qr * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = qr < rep ? __ldg(qw + 8 * kk + t) : 0u;
      qa[kk][1] = qr < rep ? __ldg(qw + 8 * kk + 4 + t) : 0u;
    }
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    const int first = k0 + warp * kKT;
    const int n_t = first < k1 ? (k1 - first + kRound - 1) / kRound : 0;
    // copy this warp's tile i into stage i % kStages; rows at or past k1
    // are zero-filled and never addressed
    auto issue = [&](int i) {
      const int base = first + i * kRound;
      const uint32_t st = ring + (i % kStages) * kStageBytes;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int idx = lane + 32 * u;
        const int r = idx / kChunks, c = idx % kChunks;
        const bool in = base + r < k1;
        const size_t off =
            in ? (rows(base + r) * hkv + g) * D + c * 8 : 0;
        const uint32_t dst = st + slot(r, c);
        tc::cp_async16_cg(dst, kbuf + off, in);
        tc::cp_async16_cg(dst + kTileBytes, vbuf + off, in);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_t) issue(s);
      tc::cp_async_commit();
    }
    // ldmatrix: lane gives row mr of matrix mi
    const int mi = lane >> 3, mr = lane & 7;
    for (int i = 0; i < n_t; ++i) {
      if (i + kStages - 1 < n_t) issue(i + kStages - 1);
      tc::cp_async_commit();
      tc::cp_async_wait<kStages - 1>();  // tile i landed for this lane
      __syncwarp();                      // ... and for the whole warp
      const uint32_t ks = ring + (i % kStages) * kStageBytes;
      const uint32_t vs = ks + kTileBytes;

      // S = q.K^T: keys 0-7 in s0, 8-15 in s1; matrices (keys 0-7, d
      // chunk 2kk), (0-7, 2kk + 1), (8-15, 2kk), (8-15, 2kk + 1)
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = ((mi >> 1) << 3) + mr, c = 2 * kk + (mi & 1);
        uint32_t b[4];
        tc::ldsm_x4(ks + slot(r, c), b);
        tc::mma_16816(s0, qa[kk][0], 0u, qa[kk][1], 0u, b[0], b[1]);
        tc::mma_16816(s1, qa[kk][0], 0u, qa[kk][1], 0u, b[2], b[3]);
      }
      const int p0 = first + i * kRound + 2 * t;
      const bool ok[4] = {p0 < k1, p0 + 1 < k1, p0 + 8 < k1, p0 + 9 < k1};
      float x[4] = {s0[0], s0[1], s1[0], s1[1]};
      float tmax = kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = ok[e] ? x[e] * scale : kNegInf;
        tmax = fmaxf(tmax, x[e]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m, tmax);
      float p[4], psum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ok[e] ? exp2f(x[e] - m_new) : 0.f;
        psum += p[e];
      }
      const float alpha = exp2f(m - m_new);
      l = alpha * l + psum;
      m = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha;
        o[j][1] *= alpha;
      }
      // P's A fragment: keys 2t, 2t + 1 and 8 + 2t, 9 + 2t of row qr
      const uint32_t pa0 = pack_bf16(p[0], p[1]), pa2 = pack_bf16(p[2], p[3]);
      // O += P.V: matrices (keys 0-7, d chunk 2jj), (8-15, 2jj), (0-7,
      // 2jj + 1), (8-15, 2jj + 1), transposed
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        const int r = ((mi & 1) << 3) + mr, c = 2 * jj + (mi >> 1);
        uint32_t b[4];
        tc::ldsm_x4_trans(vs + slot(r, c), b);
        tc::mma_16816(o[2 * jj], pa0, 0u, pa2, 0u, b[0], b[1]);
        tc::mma_16816(o[2 * jj + 1], pa0, 0u, pa2, 0u, b[2], b[3]);
      }
      __syncwarp();                      // stage i % kStages is refilled next
    }
    tc::cp_async_wait<0>();              // nothing of this warp in flight
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
  }

  __device__ void stash(Merge<D>& mg, int rep) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int qr = lane >> 2, t = lane & 3;
    if (qr >= rep) return;
    if (t == 0) {
      mg.ml[warp][qr][0] = m;
      mg.ml[warp][qr][1] = l;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(&mg.acc[warp][qr][8 * j + 2 * t]) =
          make_float2(o[j][0], o[j][1]);
  }
};

// ------------------------------------------------------------ kernels

// One block per unit of work (KV head g, row b, key chunk c): grid (hkv,
// n_rows, n_chunks), the chunk slowest, so the blocks with keys are
// dispatched first whatever the lengths and the empty ones (half of the
// chunks of 8 rows x 2048 keys over a 4096-key capacity) come last.  ws
// holds (n_rows, hkv, n_chunks, rep, D + 4) fp32: acc, then m and l (the
// two floats after them pad a head's partial to 16 bytes).  With one
// chunk the block writes out, and lse (n_rows, hq) where it is asked.
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                    const T* __restrict__ vbuf, Layout layout,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, float* __restrict__ lse, int hq,
                    int hkv, int chunk, int window) {
  static_assert(sizeof(Merge<D>) <= Walk<T, D>::kSmem,
                "the merge buffers must fit in the walk's shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int n_chunks = gridDim.z;
  const int rep = hq / hkv;
  int lo, hi;                            // the row's key range
  layout.held(lengths[b], lo, hi);
  if (window > 0) lo = max(lo, hi - window);
  const int k0 = lo + c * chunk, k1 = min(k0 + chunk, hi);
  const size_t vec0 = static_cast<size_t>(b) * hq + g * rep;
  float* part = ws + ((static_cast<size_t>(b) * hkv + g) * n_chunks + c) *
                         rep * (D + 4);
  if (k0 >= hi) {                        // block-uniform: nothing to read
    if (n_chunks == 1) {
      for (int idx = threadIdx.x; idx < rep * D; idx += kThreads)
        out[vec0 * D + idx] = from_f<T>(0.f);
      if (lse != nullptr)
        for (int i = threadIdx.x; i < rep; i += kThreads)
          lse[vec0 + i] = no_lse();
    } else {
      for (int i = threadIdx.x; i < rep; i += kThreads) {
        part[i * (D + 4) + D] = kNegInf;
        part[i * (D + 4) + D + 1] = 0.f;
      }
    }
    return;
  }
  const float scale = 1.4426950408889634f * rsqrtf(static_cast<float>(D));
  Walk<T, D> walk;
  walk.run(q + vec0 * D, kbuf, vbuf, layout.rows(b), k0, k1, hkv, g, rep,
           scale, smem);
  __syncthreads();                       // the merge buffers overlay the walk's
  Merge<D>& mg = *reinterpret_cast<Merge<D>*>(smem);
  walk.stash(mg, rep);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg.ml[w][i][0]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(mg.ml[w][i][0] - mx);
      lsum += e * mg.ml[w][i][1];
      a += e * mg.acc[w][i][d];
    }
    if (n_chunks == 1) {                 // lsum > 0: the chunk has a key
      out[(vec0 + i) * D + d] = from_f<T>(a / lsum);
      if (lse != nullptr && d == 0) lse[vec0 + i] = to_lse(mx, lsum);
    } else {
      part[i * (D + 4) + d] = a;
      if (d == 0) {
        part[i * (D + 4) + D] = mx;
        part[i * (D + 4) + D + 1] = lsum;
      }
    }
  }
}

// One block per (KV head, row) and one warp per query head of the group.
// The lanes fold the chunks' (m, l) side by side, online, and the warp
// folds the lanes' into the row's max and sum; then, 32 chunks at a
// time, lane j computes chunk j's weight and each lane j < D / 4 (16,
// 20, 24 or 32 of them) merges columns 4j..4j + 3 of acc (one float4)
// over the chunks in chunk order, each chunk's weight taken from its
// lane by a shuffle, so the acc loads of 16 chunks are in flight at
// once; the other lanes take part in the folds and shuffles only.  Empty
// partials (l = 0) weigh nothing: their acc, never written, is loaded
// and dropped by a select.  A row with no key gets 0 (and an lse of
// -inf where it is asked).
template <typename T, int D>
__global__ void __launch_bounds__(kMaxRep * 32)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                      float* __restrict__ lse, int hq, int hkv,
                      int n_chunks) {
  static_assert(D % 4 == 0 && D / 4 <= 32, "one float4 of acc per lane");
  constexpr int kLanes = D / 4;
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = hq / hkv;
  const int i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (i >= rep) return;                  // warp-uniform
  const bool cols = lane < kLanes;       // this lane merges columns
  const int stride = rep * (D + 4);      // one chunk's partials
  const float* p = ws + (static_cast<size_t>(b) * hkv + g) * n_chunks *
                            stride + i * (D + 4);
  float mx = kNegInf, lsum = 0.f;
  for (int c = lane; c < n_chunks; c += 32) {
    const float lc = p[c * stride + D + 1], mc = p[c * stride + D];
    if (lc > 0.f) {
      const float m_new = fmaxf(mx, mc);
      lsum = lsum * exp2f(mx - m_new) + lc * exp2f(mc - m_new);
      mx = m_new;
    }
  }
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, mx, w);
    const float lo = __shfl_xor_sync(0xffffffffu, lsum, w);
    const float m_new = fmaxf(mx, mo);
    lsum = lsum * exp2f(mx - m_new) + lo * exp2f(mo - m_new);
    mx = m_new;
  }
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  if (lse != nullptr && lane == 0)
    lse[static_cast<size_t>(b) * hq + g * rep + i] =
        lsum > 0.f ? to_lse(mx, lsum) : no_lse();
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < n_chunks; c0 += 32) {
    float w = 0.f;                       // lane j: chunk c0 + j's weight
    if (c0 + lane < n_chunks) {
      const float lc = p[(c0 + lane) * stride + D + 1];
      if (lc > 0.f) w = exp2f(p[(c0 + lane) * stride + D] - mx) * inv;
    }
    const int n = min(32, n_chunks - c0);
#pragma unroll 16
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float4 v = cols ? *reinterpret_cast<const float4*>(
                                  p + (c0 + j) * stride + 4 * lane)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      a[0] += wj > 0.f ? wj * v.x : 0.f;
      a[1] += wj > 0.f ? wj * v.y : 0.f;
      a[2] += wj > 0.f ? wj * v.z : 0.f;
      a[3] += wj > 0.f ? wj * v.w : 0.f;
    }
  }
  if (!cols) return;
  T* o = out + (static_cast<size_t>(b) * hq + g * rep + i) * D + 4 * lane;
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = from_f<T>(a[e]);
}

template <typename T, int D, typename Layout>
int launch(const void* q, const void* k, const void* v, Layout layout,
           const void* lengths, void* out, void* ws, void* lse, int n_rows,
           int hq, int hkv, int chunk, int n_chunks, int window,
           cudaStream_t stream) {
  auto split = decode_split_kernel<T, D, Layout>;
  constexpr size_t smem = Walk<T, D>::kSmem;
  // at every launch: a function-local static here would be one object
  // for the three kernel libraries (template statics are unique across a
  // process), so a second library's kernel would keep the 48 KB default
  const cudaError_t attr = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  split<<<dim3(hkv, n_rows, n_chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<float*>(lse), hq, hkv, chunk, window);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  decode_combine_kernel<T, D><<<dim3(hkv, n_rows), kMaxRep * 32, 0,
                                stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out),
      static_cast<float*>(lse), hq, hkv, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64, 80, 96 or 128.
// chunk, n_chunks: the split plan
// (kernels/decode_attn.py split_plan) over the span, the most keys a
// row's range can hold — the layout's depth, or min(window, depth) with
// a window > 0; ws: its fp32 workspace, unused (may be null) when
// n_chunks == 1; lse: null, or (n_rows, hq) fp32 for each query head's
// log-sum-exp.  Returns the launches' cudaGetLastError() (0 on
// success); never synchronises.
template <typename Layout>
int entry(const void* q, const void* k, const void* v, Layout layout,
          const void* lengths, void* out, void* ws, void* lse, int n_rows,
          int hq, int hkv, int head_dim, int chunk, int n_chunks, int window,
          int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int span = window > 0 ? min(window, layout.depth()) : layout.depth();
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || n_rows <= 0 ||
      n_rows > 65535 || hkv > 65535 || chunk <= 0 || chunk % kRound != 0 ||
      n_chunks <= 0 || n_chunks > 65535 || window < 0 ||
      layout.depth() <= 0 ||
      static_cast<long long>(chunk) * n_chunks < span ||
      (n_chunks > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    return launch<typename F::T, F::D>(q, k, v, layout, lengths, out, ws,
                                       lse, n_rows, hq, hkv, chunk, n_chunks,
                                       window, s);
  });
}

// The launch facts (attn_common.cuh kernel_info) of the split kernel of
// this form over Layout.
template <typename Layout>
int info(int head_dim, int dtype, int* out) {
  return with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    return kernel_info(decode_split_kernel<typename F::T, F::D, Layout>,
                       kThreads, Walk<typename F::T, F::D>::kSmem, out);
  });
}

}  // namespace decode
}  // namespace attn
