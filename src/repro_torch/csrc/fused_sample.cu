// Fused on-device sampling for Hopper (sm_90a): one thread-block cluster
// per logits row, the row held in the cluster's distributed shared memory.
//
// Replaces the TPU kernel src/repro/kernels/sampling.py::fused_sample
// (pallas_call at :201, body _fused_sample_kernel / _sample_core).  Per
// logits row, in the reference's order: an additive bias of up to 8
// (id, value) slots applied in slot order, the temperature, EXACT top-k
// (every column whose monotone key is >= the kth largest key, ties kept,
// -0.0 keyed below +0.0), a softmax, tie-inclusive top-p (the minimal
// probability theta whose strictly-greater mass is < top_p), a second
// softmax, and the inverse-CDF draw from the host's uniform u (the count
// of cumulative masses <= u, clamped to V - 1); plus p(draft) and the
// residual draw with the draft column zeroed.  Greedy rows (temp <= 0)
// give the biased argmax, the lowest index among equal maxima.
//
// Bound: the logits read once -- 12.15 MB at 40 x 151,936 in bf16, 0.0036
// ms at 3.35 TB/s.  The design reads them from HBM once and keeps every
// later pass on chip:
// - A cluster of CS CTAs (8; 16 where a slice of 8 would not leave three
//   CTAs an SM) splits the row into slices of n columns.  Each CTA
//   bulk-copies (TMA) its slice once into shared memory as the logits
//   came (bf16 or fp32; a biased column's slot -inf, its value in a side
//   table), and row-wide reductions merge through DSMEM (map_shared_rank,
//   cluster.sync).  At V = 151,936 in bf16 a CTA holds 75,968 B, three
//   share an SM, and R = 40 runs in one wave.
// - Top-k (k <= 256) by a filter: the kth largest of a CTA's 256 thread
//   maxima is a lower bound of the row's kth largest logit; past the
//   cluster's largest bound lie a few candidates, which each CTA writes
//   into its region of the leader CTA; the leader finds the kth largest
//   key among them exactly.  Otherwise (k > 256, or too many candidates)
//   a radix select over the slices: 8-bit digit histograms merged across
//   the cluster, a suffix sum picks each digit (two digits for bf16 rows
//   with no fp32 bias value).  Counts are integers: the kth logit is
//   exact.  x / temp is monotone, so the kth scaled key is the scaled kth
//   logit, and the keep-mask key(x / temp) >= T becomes key(x) >= K_x,
//   K_x found by a warp search below the kth logit: bit for bit the
//   reference's mask.
// - When at most kCap columns are kept (and their max is above the mask
//   value), the leader alone runs both softmaxes, the top-p descent, the
//   draw and the residual draw over them, in column order: masked
//   columns add exactly 0 to every sum, and the count of cumulative
//   masses <= u is the column of the first kept entry whose running sum
//   exceeds u (V when none).  A warp does it when at most 32 are kept.
// - Otherwise (top-k off, or a larger kept set) the cluster-resident row
//   is widened in place to fp32 probabilities, theta comes from the
//   31-step descent with cluster reductions, and the CDF from a cluster
//   scan: each slice's total through DSMEM, then runs inside the slice.
// No workspace, no host synchronisation, nothing read back: one launch,
// graph-capturable.  No fast math: division and expf stay IEEE-accurate,
// or the thresholds drift.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attn_tc.cuh"

namespace cg = cooperative_groups;
namespace tc = attn::tc;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBias = 8;
constexpr int kCap = 4096;             // compact capacity C (kept columns)
constexpr int kMaxCand = 512;          // candidates the leader refines
constexpr int kBins = 256;             // 8-bit radix digits
constexpr int kXch = 4;                // words each CTA posts per exchange
constexpr int kTile = 4 * kThreads;    // columns widened per barrier
constexpr int kBulk = 16384;           // bytes a bulk copy moves
constexpr int kMaxDynSmem = 232448 - 512;
constexpr float kNeg = -1e30f;         // masked logit, as the reference
constexpr int kSignLow = 0x7fffffff;
constexpr int kMinInt = -0x7fffffff - 1;
constexpr int kKeyNegInf = static_cast<int>(0xff800000u ^ 0x7fffffffu);
static_assert(kThreads == kBins, "one histogram bin per thread");

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory of a CTA holding n columns of el bytes: the slice
// [0, el n), two radix histograms, the leader's compact candidates
// (columns, then values); the whole-row fp32 array [0, 4 n) overlays all.
// The total is kernels/sampling.py::_smem's, from which the launcher
// picks the cluster size (held equal on the card by chip_smoke phase 1).
struct Layout {
  int hist, col, val, total;
  __host__ __device__ Layout(int n, int el) {
    hist = align16(n * el);
    col = hist + 2 * kBins * 4;
    val = col + kCap * 4;
    const int compact = val + kCap * 4;
    total = align16(compact > 4 * n ? compact : 4 * n);
  }
};

// Monotone int32 key: x < y <=> key(x) < key(y) for float32 x, y (no
// NaN).  Bit for bit the reference's _float_key (-0.0 keys below +0.0).
__device__ __forceinline__ int fkey(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : (b ^ kSignLow);
}
__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : (k ^ kSignLow));
}
// the key as an unsigned order, for the radix digits
__device__ __forceinline__ uint32_t ukey(float x) {
  return static_cast<uint32_t>(fkey(x)) ^ 0x80000000u;
}

// The slice as stored: the logits' own bits (bf16 or fp32), a biased
// column's slot -inf (its value is in btab; fix-ups below).
template <typename T>
struct Store;
template <>
struct Store<float> {
  using S = float;
  static constexpr int kVec = 4;
  __device__ static float of(float raw) { return raw; }
  __device__ static float neg_inf() { return -CUDART_INF_F; }
};
template <>
struct Store<__nv_bfloat16> {
  using S = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float of(uint16_t raw) {
    return __uint_as_float(static_cast<uint32_t>(raw) << 16);
  }
  __device__ static uint16_t neg_inf() { return 0xff80; }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <typename V>
__device__ __forceinline__ V warp_scan(V x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// (value, index) argmax: the largest value, the lowest index among equal
// maxima (jnp.argmax's rule).
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide reductions and scans over kThreads threads.  Scratch is
// double-buffered by a parity flipped on every call, so one barrier a
// call suffices: a buffer is rewritten only after the next call's barrier,
// which every reader of its last use has passed.
struct Block {
  static constexpr int kSize = kThreads;
  float (*rf)[kWarps];
  int (*ri)[kWarps];
  int par = 0;
  __device__ int tid() const { return threadIdx.x; }
  __device__ float sum(float x) {
    x = warp_sum(x);
    if ((threadIdx.x & 31) == 0) rf[par][threadIdx.x >> 5] = x;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += rf[par][w];
    par ^= 1;
    return t;
  }
  __device__ int sum_i(int x) {
    x = warp_sum_i(x);
    if ((threadIdx.x & 31) == 0) ri[par][threadIdx.x >> 5] = x;
    __syncthreads();
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += ri[par][w];
    par ^= 1;
    return t;
  }
  __device__ int max_i(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
    if ((threadIdx.x & 31) == 0) ri[par][threadIdx.x >> 5] = x;
    __syncthreads();
    int t = ri[par][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = max(t, ri[par][w]);
    par ^= 1;
    return t;
  }
  // the block's (value, index) argmax, into v and i of every thread
  __device__ void argmax(float& v, int& i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
      arg_better(v, i, v2, i2);
    }
    if ((threadIdx.x & 31) == 0) {
      rf[par][threadIdx.x >> 5] = v;
      ri[par][threadIdx.x >> 5] = i;
    }
    __syncthreads();
    v = rf[par][0];
    i = ri[par][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) arg_better(v, i, rf[par][w], ri[par][w]);
    par ^= 1;
  }
  __device__ int min_i(int x) {
    x = warp_min_i(x);
    if ((threadIdx.x & 31) == 0) ri[par][threadIdx.x >> 5] = x;
    __syncthreads();
    int t = ri[par][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = min(t, ri[par][w]);
    par ^= 1;
    return t;
  }
  // inclusive prefix in thread order; `total` gets the block's sum
  __device__ float scan(float x, float& total) {
    const int warp = threadIdx.x >> 5;
    x = warp_scan(x);
    if ((threadIdx.x & 31) == 31) rf[par][warp] = x;
    __syncthreads();
    float before = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float s = rf[par][w];
      if (w < warp) before += s;
      t += s;
    }
    par ^= 1;
    total = t;
    return before + x;
  }
  __device__ int scan_i(int x, int& total) {
    const int warp = threadIdx.x >> 5;
    x = warp_scan(x);
    if ((threadIdx.x & 31) == 31) ri[par][warp] = x;
    __syncthreads();
    int before = 0, t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = ri[par][w];
      if (w < warp) before += s;
      t += s;
    }
    par ^= 1;
    total = t;
    return before + x;
  }
};

// The same over warp 0 alone: no barriers.
struct Warp {
  static constexpr int kSize = 32;
  __device__ int tid() const { return threadIdx.x; }
  __device__ float sum(float x) { return warp_sum(x); }
  __device__ int min_i(int x) { return warp_min_i(x); }
  __device__ float scan(float x, float& total) {
    x = warp_scan(x);
    total = __shfl_sync(0xffffffffu, x, 31);
    return x;
  }
};

// First candidate (in column order) whose running sum of y exceeds u,
// y = p / div, zero at column zero_col; nc when none.
template <class G>
__device__ int first_past(G& g, const int* col, const float* p, int nc,
                          float u, int zero_col, float div) {
  float carry = 0.f;
  for (int base = 0; base < nc; base += G::kSize) {
    const int i = base + g.tid();
    const float y = (i < nc && col[i] != zero_col) ? p[i] / div : 0.f;
    float tot;
    const float run = carry + g.scan(y, tot);
    const int hit = g.min_i(i < nc && run > u ? i : 0x7fffffff);
    if (hit != 0x7fffffff) return hit;
    carry += tot;
  }
  return nc;
}

// The leader's draw over nc kept candidates (column, biased logit), in
// column order: the two softmaxes, the top-p descent, the draw, p(draft)
// and the residual draw.  m is the row's scaled max (> kNeg, so masked
// columns add exactly 0 to every sum).  Each thread keeps to candidates
// tid, tid + size, ... throughout.
template <class G>
__device__ void draw_compact(G g, const int* col, float* val, int nc, float m,
                             float tdiv, bool do_p, float top_p, float u,
                             int dcol, int v, int* tok, float* pd, int* alt) {
  const int t = g.tid();
  float part = 0.f;
  for (int i = t; i < nc; i += G::kSize) {
    const float e = expf(val[i] / tdiv - m);
    val[i] = e;
    part += e;
  }
  const float s1 = g.sum(part);
  float s2 = s1;
  if (do_p) {
    // tie-inclusive top-p (_topp_theta), p = e / s1 as the reference
    float theta;
    if constexpr (G::kSize == 32) {
      // one candidate a lane: theta, the least K whose strictly-greater
      // mass G(K) is < top_p, is 0 or a candidate's p, so test each
      // (lanes past nc hold p = 0 and test K = 0; every lane K = 0 too)
      const float p = t < nc ? val[t] / s1 : 0.f;
      float above = 0.f, pos = 0.f;
      for (int j = 0; j < 32; ++j) {
        const float q = __shfl_sync(0xffffffffu, p, j);
        if (q > p) above += q;
        if (q > 0.f) pos += q;
      }
      float cand = above < top_p ? p : CUDART_INF_F;
      if (pos < top_p) cand = 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cand = fminf(cand, __shfl_xor_sync(0xffffffffu, cand, o));
      theta = cand;
    } else {
      int kacc = 0;
      for (int it = 0; it < 31; ++it) {
        const int bit = 1 << (30 - it);
        const int trial = kacc | (bit - 1);
        float mass = 0.f;
        for (int i = t; i < nc; i += G::kSize) {
          const float p = val[i] / s1;
          if (__float_as_int(p) > trial) mass += p;
        }
        if (!(g.sum(mass) < top_p)) kacc |= bit;
      }
      theta = __int_as_float(kacc);
    }
    part = 0.f;
    for (int i = t; i < nc; i += G::kSize) {
      const float e = val[i] / s1 >= theta ? val[i] : 0.f;
      val[i] = e;
      part += e;
    }
    s2 = g.sum(part);
  }
  // (top-p off: the second softmax runs over the unchanged row, so it is
  // the first one -- the same m and sum)
  float pdl = 0.f, rest = 0.f;
  for (int i = t; i < nc; i += G::kSize) {
    const float p = val[i] / s2;
    val[i] = p;
    if (col[i] == dcol)
      pdl += p;
    else
      rest += p;
  }
  const float p_d = g.sum(pdl);
  const float mass = g.sum(rest);
  const int f1 = first_past(g, col, val, nc, u, -1, 1.f);
  const int stok = min(f1 < nc ? col[f1] : v, v - 1);
  int salt = stok;
  if (mass > 0.f) {
    const int f2 = first_past(g, col, val, nc, u, dcol, fmaxf(mass, 1e-30f));
    salt = min(f2 < nc ? col[f2] : v, v - 1);
  }
  if (t == 0) {
    *tok = stok;
    *pd = p_d;
    *alt = salt;
  }
}

// The least logit key K_x whose scaled value reaches that of key tkey:
// x / tdiv is monotone, so key(x / tdiv) >= key(from_key(tkey) / tdiv)
// <=> key(x) >= K_x.  Run by a whole warp: its lanes test the 32 keys
// below tkey; a binary search goes further when all of them pass.
__device__ int x_threshold(int tkey, float tdiv) {
  const int lane = threadIdx.x & 31;
  const int ks = fkey(from_key(tkey) / tdiv);
  auto ok = [&](long long k) {
    return k >= kKeyNegInf &&
           fkey(from_key(static_cast<int>(k)) / tdiv) >= ks;
  };
  const unsigned pass = __ballot_sync(
      0xffffffffu, ok(static_cast<long long>(tkey) - 1 - lane));
  if (pass != 0xffffffffu) return tkey - (__ffs(~pass) - 1);
  long long a = kKeyNegInf, b = static_cast<long long>(tkey) - 32;
  while (a < b) {
    const long long mid = a + (b - a) / 2;
    if (ok(mid))
      b = mid;
    else
      a = mid + 1;
  }
  return static_cast<int>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
fused_sample_kernel(const T* __restrict__ logits,
                    const float* __restrict__ temp_in,
                    const int* __restrict__ topk_in,
                    const float* __restrict__ topp_in,
                    const int* __restrict__ bias_ids,
                    const float* __restrict__ bias_vals,
                    const float* __restrict__ u_in,
                    const int* __restrict__ draft_in, int* __restrict__ tok_out,
                    float* __restrict__ pd_out, int* __restrict__ alt_out,
                    int v, int n) {
  using St = Store<T>;
  using S = typename St::S;
  constexpr int kv = St::kVec;   // columns in a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float redf[2][kWarps];
  __shared__ int redi[2][kWarps];
  __shared__ uint32_t xch[2][kXch];
  __shared__ float btab[kMaxBias];
  __shared__ int bcol[kMaxBias];
  __shared__ int bslot[kMaxBias];
  __shared__ int bcast[4];
  __shared__ int counts[2][16];   // the filter's counts, from every CTA
  __shared__ __align__(8) uint64_t mbar;

  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int r = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lo = min(rank * n, v), len = min(n, v - lo);
  const Layout lay(n, static_cast<int>(sizeof(S)));
  const S* raw = reinterpret_cast<const S*>(smem);
  const uint4* raw4 = reinterpret_cast<const uint4*>(smem);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + lay.hist);
  int* cand_col = reinterpret_cast<int*>(smem + lay.col);
  float* cand_val = reinterpret_cast<float*>(smem + lay.val);
  float* wr = reinterpret_cast<float*>(smem);
  const T* row = logits + static_cast<size_t>(r) * v;

  const float temp = temp_in[r];
  const int top_k = topk_in[r];
  const float top_p = topp_in[r];
  const float u = u_in[r];
  const int draft = draft_in[r];
  const float tdiv = fmaxf(temp, 1e-6f);
  const bool greedy = temp <= 0.f;
  const bool do_k = !greedy && top_k > 0 && top_k < v;
  const bool do_p = top_p > 0.f && top_p < 1.f;
  const int dcol = min(max(draft, 0), v - 1);
  Block blk{redf, redi};
  int xp = 0;   // exchange parity: this round posts xch[xp] (and hist[xp])

  // The slice into shared memory by 1-D bulk copies of its 16-byte
  // chunks (the TMA: one thread asks, an mbarrier counts the bytes); the
  // rest, or all of a row not 16-byte aligned, by the threads.
  const int bulk =
      (reinterpret_cast<uintptr_t>(row + lo) & 15) == 0
          ? (len * static_cast<int>(sizeof(S))) & ~15 : 0;
  if (tid == 0 && bulk > 0) {
    tc::mbar_init(&mbar);
    tc::mbar_expect(&mbar, bulk);
    for (int o = 0; o < bulk; o += kBulk)
      tc::bulk_copy(smem + o,
                    reinterpret_cast<const unsigned char*>(row + lo) + o,
                    min(kBulk, bulk - o), &mbar);
  }
  for (int c = bulk / static_cast<int>(sizeof(S)) + tid; c < len;
       c += kThreads)
    reinterpret_cast<S*>(smem)[c] = reinterpret_cast<const S*>(row)[lo + c];
  // The bias slots, one a thread, and each in-range id's logit; then
  // thread 0 gives each distinct id its biased value (slots in order, a
  // repeated id adds twice) in btab at its first slot, and lists this
  // slice's biased columns in bcol / bslot.  `low`: a value with bits
  // below bf16's, so the radix select needs all four digits.
  if (tid < kMaxBias) {
    const int id = bias_ids[r * kMaxBias + tid];
    bcol[tid] = id;
    btab[tid] = bias_vals[r * kMaxBias + tid];
    redf[0][tid] = id >= 0 && id < v ? St::of(reinterpret_cast<const S*>(row)[id]) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int ids[kMaxBias];
    float vals[kMaxBias], xs[kMaxBias];
    for (int j = 0; j < kMaxBias; ++j) {
      ids[j] = bcol[j];
      vals[j] = btab[j];
      xs[j] = redf[0][j];
    }
    int nb = 0, low = sizeof(S) == 4;
    for (int j = 0; j < kMaxBias; ++j) {
      const int id = ids[j];
      bool first = id >= 0 && id < v;
      for (int q = 0; q < j && first; ++q) first = ids[q] != id;
      if (!first) continue;
      float x = xs[j];
      for (int q = j; q < kMaxBias; ++q)
        if (ids[q] == id) x = x + vals[q];
      btab[j] = x;
      low |= (__float_as_uint(x) & 0xffffu) != 0;
      if (id >= lo && id < lo + len) {
        bcol[nb] = id - lo;
        bslot[nb] = j;
        ++nb;
      }
    }
    bcast[0] = nb;
    bcast[1] = low;
  }
  if (bulk > 0) tc::mbar_wait(&mbar, 0);
  __syncthreads();
  const int nb = bcast[0];
  const bool low = bcast[1] != 0;
  // A biased column's slot in the slice holds -inf, so the passes run on
  // the slice alone; its value is btab's (thread 0 adds it to its argmax;
  // counts, gathers and the whole-row pass fix it up).
  if (tid < nb) reinterpret_cast<S*>(smem)[bcol[tid]] = St::neg_inf();
  __syncthreads();
  // Every pass walks the slice in 16-byte chunks, branch-free inside a
  // chunk (columns past the slice masked), so a thread's columns are in
  // flight together.
  const int nch = (len + kv - 1) / kv;
  auto biased = [&](int c, float x) {
    for (int b = 0; b < nb; ++b)
      if (c == bcol[b]) x = btab[bslot[b]];
    return x;
  };

  // ---- the slice once over: the biased argmax ----
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int q = tid; q < nch; q += kThreads) {
    const uint4 pk = raw4[q];
    const S* e = reinterpret_cast<const S*>(&pk);
    const int nv = min(kv, len - q * kv);
#pragma unroll
    for (int k = 0; k < kv; ++k) {
      const float x = St::of(e[k]);
      const int c = lo + q * kv + k;
      const bool up = k < nv && (x > best || (x == best && c < best_i));
      best = up ? x : best;
      best_i = up ? c : best_i;
    }
  }
  if (tid == 0)
    for (int b = 0; b < nb; ++b)
      arg_better(best, best_i, btab[bslot[b]], lo + bcol[b]);
  // top-k's filter: the kth largest of this block's thread maxima is a
  // lower bound of the row's kth largest logit; the cluster takes the
  // largest bound (a thread with no columns holds -inf, which bounds too)
  const bool do_filter = do_k && top_k <= kThreads;
  int bound = kMinInt;
  if (do_filter) {
    int* keys = reinterpret_cast<int*>(hist);
    const int mine = fkey(best);
    keys[tid] = mine;
    __syncthreads();
    int ge = 0;
    for (int j = 0; j < kThreads / 4; ++j) {
      const int4 kk = reinterpret_cast<const int4*>(keys)[j];
      ge += (kk.x >= mine) + (kk.y >= mine) + (kk.z >= mine) + (kk.w >= mine);
    }
    bound = blk.max_i(ge >= top_k ? mine : kMinInt);
  }
  const float tmax = best;   // this thread's maximum, for the filter
  blk.argmax(best, best_i);
  if (tid == 0) {
    xch[xp][0] = __float_as_uint(best);
    xch[xp][1] = static_cast<uint32_t>(best_i);
    xch[xp][2] = static_cast<uint32_t>(bound);
  }
  cl.sync();
  float gval = -CUDART_INF_F;
  int gtok = 0x7fffffff;
  for (int q = 0; q < cs; ++q) {
    const uint32_t* x = cl.map_shared_rank(&xch[xp][0], q);
    arg_better(gval, gtok, __uint_as_float(x[0]), static_cast<int>(x[1]));
    bound = max(bound, static_cast<int>(x[2]));
  }
  if (greedy) {
    if (rank == 0 && tid == 0) {
      tok_out[r] = gtok;
      pd_out[r] = gtok == draft ? 1.f : 0.f;
      alt_out[r] = gtok;
    }
    cl.sync();   // no CTA leaves while another reads its shared memory
    return;
  }
  const float m = gval / tdiv;   // x / temp is monotone: the scaled max

  // Runs of consecutive chunks a thread (column order) for the counts and
  // the gathers; an odd run length keeps a warp's 16-byte reads on
  // distinct banks.
  const int rl = ((nch + kThreads - 1) / kThreads) | 1;
  const int qa = min(tid * rl, nch), qb = min(qa + rl, nch);
  bool fix = false;   // a biased column lies in this thread's run
  for (int b = 0; b < nb; ++b)
    fix |= bcol[b] >= qa * kv && bcol[b] < qb * kv;
  // this run's columns whose biased key is >= thr
  auto count_run = [&](int thr) {
    int c = 0;
    for (int q = qa; q < qb; ++q) {
      const uint4 pk = raw4[q];
      const S* e = reinterpret_cast<const S*>(&pk);
      const int nv = min(kv, len - q * kv);
#pragma unroll
      for (int k = 0; k < kv; ++k)
        c += (k < nv) & (fkey(St::of(e[k])) >= thr);
    }
    if (fix)
      for (int b = 0; b < nb; ++b)
        if (bcol[b] >= qa * kv && bcol[b] < qb * kv)
          c += (fkey(btab[bslot[b]]) >= thr) -
               (fkey(St::of(raw[bcol[b]])) >= thr);
    return c;
  };
  // post the slice's count: every CTA learns the row's total and the
  // counts of the slices before it; returns this thread's offset
  auto post_count = [&](int c, int& base, int& total) {
    int slice;
    const int off = blk.scan_i(c, slice) - c;
    xp ^= 1;
    if (tid == 0) xch[xp][0] = static_cast<uint32_t>(slice);
    cl.sync();
    base = total = 0;
    for (int q = 0; q < cs; ++q) {
      const int t = static_cast<int>(cl.map_shared_rank(&xch[xp][0], q)[0]);
      if (q < rank) base += t;
      total += t;
    }
    return off;
  };
  // this run's columns whose biased key is >= thr, (column, biased
  // logit) into the leader from slot o on
  auto gather_run = [&](int thr, int o) {
    int* lc = cl.map_shared_rank(cand_col, 0);
    float* lv = cl.map_shared_rank(cand_val, 0);
    for (int q = qa; q < qb; ++q) {
      const uint4 pk = raw4[q];
      const S* e = reinterpret_cast<const S*>(&pk);
      const int nv = min(kv, len - q * kv);
#pragma unroll
      for (int k = 0; k < kv; ++k) {
        float x = St::of(e[k]);
        if (fix) x = biased(q * kv + k, x);
        const bool keep = (k < nv) & (fkey(x) >= thr);
        if (keep) {
          lc[o] = lo + q * kv + k;
          lv[o] = x;
        }
        o += keep;
      }
    }
  };
  // the leader's draw over nc kept columns
  auto draw = [&](const int* col, float* val, int nc) {
    if (nc <= 32) {
      if (tid < 32)
        draw_compact(Warp{}, col, val, nc, m, tdiv, do_p, top_p, u, dcol, v,
                     tok_out + r, pd_out + r, alt_out + r);
    } else {
      draw_compact(blk, col, val, nc, m, tdiv, do_p, top_p, u, dcol, v,
                   tok_out + r, pd_out + r, alt_out + r);
    }
  };

  int kx = kKeyNegInf;
  if (do_k) {
    if (do_filter) {
      // ---- the candidates past the bound (as a logit threshold) ----
      if (tid < 32) {
        const int lx = x_threshold(bound, tdiv);
        if (tid == 0) bcast[0] = lx;
      }
      __syncthreads();
      const int lx = bcast[0];
      // a thread's own columns past lx (none when its maximum is below):
      // counted, then written into this rank's region of the leader;
      // every CTA hears every count
      const int per = kCap / 2 / cs;
      int c = 0;
      if (fkey(tmax) >= lx) {
        for (int q = tid; q < nch; q += kThreads) {
          const uint4 pk = raw4[q];
          const S* e = reinterpret_cast<const S*>(&pk);
          const int nv = min(kv, len - q * kv);
#pragma unroll
          for (int k = 0; k < kv; ++k)
            c += (k < nv) & (fkey(St::of(e[k])) >= lx);
        }
        if (tid == 0)
          for (int b = 0; b < nb; ++b) c += fkey(btab[bslot[b]]) >= lx;
      }
      int slice;
      int o = blk.scan_i(c, slice) - c + rank * per;
      if (c > 0 && slice <= per) {
        int* lc = cl.map_shared_rank(cand_col, 0);
        float* lv = cl.map_shared_rank(cand_val, 0);
        for (int q = tid; q < nch; q += kThreads) {
          const uint4 pk = raw4[q];
          const S* e = reinterpret_cast<const S*>(&pk);
          const int nv = min(kv, len - q * kv);
#pragma unroll
          for (int k = 0; k < kv; ++k) {
            const float x = St::of(e[k]);
            const bool keep = (k < nv) & (fkey(x) >= lx);
            if (keep) {
              lc[o] = lo + q * kv + k;
              lv[o] = x;
            }
            o += keep;
          }
        }
        if (tid == 0)
          for (int b = 0; b < nb; ++b) {
            const float x = btab[bslot[b]];
            if (fkey(x) >= lx) {
              lc[o] = lo + bcol[b];
              lv[o] = x;
              ++o;
            }
          }
      }
      xp ^= 1;
      if (tid < cs) cl.map_shared_rank(&counts[xp][0], tid)[rank] = slice;
      cl.sync();
      int total = 0;
      bool fits = true;
      for (int q = 0; q < cs; ++q) {
        total += counts[xp][q];
        fits &= counts[xp][q] <= per;
      }
      if (fits && total <= kMaxCand && m > kNeg) {
        if (rank != 0) return;
        // the leader: the candidates (all of the row's top k are among
        // them) packed from the ranks' regions, the kth largest key among
        // them, its logit threshold, and the kept columns in column order
        int* keys = cand_col + kCap / 2;
        int* dcols = keys + kMaxCand;
        int* kcol = dcols + kMaxCand;
        float* dvals = cand_val + kCap / 2;
        float* kval = dvals + kMaxCand;
        for (int i = tid; i < total; i += kThreads) {
          int q = 0, before = 0;
          while (i - before >= counts[xp][q]) before += counts[xp][q++];
          const int src = q * per + i - before;
          dcols[i] = cand_col[src];
          dvals[i] = cand_val[src];
          keys[i] = fkey(cand_val[src]);
        }
        __syncthreads();
        int tk = kMinInt;
        for (int i = tid; i < total; i += kThreads) {
          int ge = 0;
          for (int j = 0; j < total; ++j) ge += keys[j] >= keys[i];
          if (ge >= top_k) tk = max(tk, keys[i]);
        }
        const int tkey = blk.max_i(tk);
        if (tid < 32) {
          const int x = x_threshold(tkey, tdiv);
          if (tid == 0) bcast[1] = x;
        }
        __syncthreads();
        const int kx2 = bcast[1];
        int here = 0;
        for (int i = tid; i < total; i += kThreads) {
          if (keys[i] < kx2) continue;
          int at = 0;
          for (int j = 0; j < total; ++j)
            at += (keys[j] >= kx2) & (dcols[j] < dcols[i]);
          kcol[at] = dcols[i];
          kval[at] = dvals[i];
          ++here;
        }
        draw(kcol, kval, blk.sum_i(here));
        return;
      }
    }
    // ---- exact top-k by radix select over the slices ----
    uint32_t prefix = 0;
    int need = top_k;
    const int digits = low ? 4 : 2;
    for (int d = 0; d < digits; ++d) {
      // histogram digit d of the columns that match the prefix so far
      xp ^= 1;
      uint32_t* h = hist + xp * kBins;
      h[tid] = 0;
      __syncthreads();
      const int sh = 24 - 8 * d;
      for (int q = tid; q < nch; q += kThreads) {
        const uint4 pk = raw4[q];
        const S* e = reinterpret_cast<const S*>(&pk);
        const int nv = min(kv, len - q * kv);
#pragma unroll
        for (int k = 0; k < kv; ++k) {
          const uint32_t key = ukey(St::of(e[k]));
          if ((k < nv) & ((static_cast<uint64_t>(key) >> (sh + 8)) == prefix))
            atomicAdd(&h[(key >> sh) & 0xffu], 1u);
        }
      }
      if (tid == 0)   // the biased columns by their biased keys
        for (int b = 0; b < nb; ++b) {
          const uint32_t kr = ukey(St::of(raw[bcol[b]]));
          const uint32_t kb = ukey(btab[bslot[b]]);
          if ((static_cast<uint64_t>(kr) >> (sh + 8)) == prefix)
            atomicSub(&h[(kr >> sh) & 0xffu], 1u);
          if ((static_cast<uint64_t>(kb) >> (sh + 8)) == prefix)
            atomicAdd(&h[(kb >> sh) & 0xffu], 1u);
        }
      cl.sync();
      // merge bin (255 - tid) over the cluster; a scan in thread order is
      // the suffix sum over bins; one thread holds the kth key's digit
      const int bin = kBins - 1 - tid;
      int cnt = 0;
      for (int q = 0; q < cs; ++q)
        cnt += static_cast<int>(cl.map_shared_rank(h, q)[bin]);
      int total;
      const int incl = blk.scan_i(cnt, total);
      if (incl >= need && incl - cnt < need) {
        bcast[2] = bin;
        bcast[3] = incl - cnt;
      }
      __syncthreads();
      need -= bcast[3];
      prefix = (prefix << 8) | static_cast<uint32_t>(bcast[2]);
    }
    // two digits: every column is bf16, its key's low half 0 (x >= +0)
    // or all ones (x <= -0)
    const uint32_t tu =
        low ? prefix : ((prefix << 16) | ((prefix & 0x8000u) ? 0u : 0xffffu));
    if (tid < 32) {
      const int x = x_threshold(static_cast<int>(tu ^ 0x80000000u), tdiv);
      if (tid == 0) bcast[0] = x;
    }
    __syncthreads();
    kx = bcast[0];
    int base, total;
    const int off = post_count(count_run(kx), base, total);
    if (total <= kCap && m > kNeg) {
      // ---- compact: the kept columns into the leader, in column order ----
      gather_run(kx, base + off);
      cl.sync();
      if (rank != 0) return;
      draw(cand_col, cand_val, total);
      return;
    }
  }

  // ---- the whole row: e = expf(s - m) widened in place to fp32 ----
  // Tiles from the slice's end: a tile's fp32 words cover only its own
  // (already read) columns and later tiles' (already widened) ones.
  float part = 0.f;
  for (int t0 = (len - 1) / kTile * kTile; t0 >= 0 && len > 0; t0 -= kTile) {
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = t0 + k * kThreads + tid;
      e[k] = 0.f;
      if (i < len) {
        const float x = St::of(raw[i]);
        const float s = (do_k && fkey(x) < kx) ? kNeg : x / tdiv;
        e[k] = expf(s - m);
        part += e[k];
      }
    }
    if (sizeof(S) < 4) __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = t0 + k * kThreads + tid;
      if (i < len) wr[i] = e[k];
    }
  }
  // a row-wide sum: this block's, posted; every CTA adds in rank order
  auto cluster_sum = [&](float x) -> float {
    const float b = blk.sum(x);
    xp ^= 1;
    if (tid == 0) xch[xp][0] = __float_as_uint(b);
    cl.sync();
    float t = 0.f;
    for (int q = 0; q < cs; ++q)
      t += __uint_as_float(cl.map_shared_rank(&xch[xp][0], q)[0]);
    return t;
  };
  // (0 / x is 0: the zeros, most of a filtered row, skip IEEE division's
  // slow path)
  __syncthreads();
  if (tid == 0)   // the biased columns (their -inf slots gave e = 0)
    for (int b = 0; b < nb; ++b) {
      const float x = btab[bslot[b]];
      const float s = (do_k && fkey(x) < kx) ? kNeg : x / tdiv;
      wr[bcol[b]] = expf(s - m);
      part += wr[bcol[b]];
    }
  const float s1 = cluster_sum(part);
  for (int i = tid; i < len; i += kThreads)
    if (wr[i] != 0.f) wr[i] = wr[i] / s1;
  float p2div = 1.f;   // the second softmax's sum, in units of the first
  float p_neg = 0.f;   // a masked column's probability
  if (do_p) {
    int kacc = 0;
    for (int it = 0; it < 31; ++it) {
      const int bit = 1 << (30 - it);
      const int trial = kacc | (bit - 1);
      float mass = 0.f;
      for (int i = tid; i < len; i += kThreads) {
        const float p = wr[i];
        if (__float_as_int(p) > trial) mass += p;
      }
      if (!(cluster_sum(mass) < top_p)) kacc |= bit;
    }
    const float theta = __int_as_float(kacc);
    p_neg = expf(kNeg - m) / s1;
    float kept = 0.f;
    for (int i = tid; i < len; i += kThreads) {
      const float p = wr[i] >= theta ? wr[i] : p_neg;
      wr[i] = p;
      kept += p;
    }
    p2div = cluster_sum(kept);
  }
  // the filtered distribution, this slice's total with and without the
  // draft column, and p(draft) where the column lies here
  float t1 = 0.f, t2 = 0.f, pdl = 0.f;
  for (int i = tid; i < len; i += kThreads) {
    const float p = do_p && wr[i] != 0.f ? wr[i] / p2div : wr[i];
    wr[i] = p;
    t1 += p;
    if (lo + i == dcol)
      pdl += p;
    else
      t2 += p;
  }
  t1 = blk.sum(t1);
  t2 = blk.sum(t2);
  pdl = blk.sum(pdl);
  xp ^= 1;
  if (tid == 0) {
    xch[xp][0] = __float_as_uint(t1);
    xch[xp][1] = __float_as_uint(t2);
    xch[xp][2] = __float_as_uint(pdl);
  }
  cl.sync();
  float c1 = 0.f, c2 = 0.f, mass = 0.f, p_d = 0.f;
  for (int q = 0; q < cs; ++q) {
    const uint32_t* x = cl.map_shared_rank(&xch[xp][0], q);
    if (q < rank) {
      c1 += __uint_as_float(x[0]);
      c2 += __uint_as_float(x[1]);
    }
    mass += __uint_as_float(x[1]);
    p_d += __uint_as_float(x[2]);
  }
  const float div = fmaxf(mass, 1e-30f);
  c2 = c2 / div;
  // the CDF in runs: each thread's run total, a block scan, then the run
  // walked in column order; count cumulative masses <= u (both draws)
  const int wl = ((len + kThreads - 1) / kThreads) | 1;   // odd: no bank
  const int ra = min(tid * wl, len), rb = min(ra + wl, len);  // conflicts
  float r1 = 0.f, r2 = 0.f;
  for (int i = ra; i < rb; ++i) {
    r1 += wr[i];
    if (lo + i != dcol && wr[i] != 0.f) r2 += wr[i] / div;
  }
  float tot;
  float run1 = c1 + (blk.scan(r1, tot) - r1);
  float run2 = c2 + (blk.scan(r2, tot) - r2);
  int n1 = 0, n2 = 0;
  for (int i = ra; i < rb; ++i) {
    run1 += wr[i];
    if (lo + i != dcol && wr[i] != 0.f) run2 += wr[i] / div;
    n1 += run1 <= u;
    n2 += run2 <= u;
  }
  n1 = blk.sum_i(n1);
  n2 = blk.sum_i(n2);
  xp ^= 1;
  if (tid == 0) {
    xch[xp][0] = static_cast<uint32_t>(n1);
    xch[xp][1] = static_cast<uint32_t>(n2);
  }
  cl.sync();
  if (rank == 0 && tid == 0) {
    int a1 = 0, a2 = 0;
    for (int q = 0; q < cs; ++q) {
      const uint32_t* x = cl.map_shared_rank(&xch[xp][0], q);
      a1 += static_cast<int>(x[0]);
      a2 += static_cast<int>(x[1]);
    }
    const int stok = min(a1, v - 1);
    tok_out[r] = stok;
    pd_out[r] = p_d;
    alt_out[r] = mass > 0.f ? min(a2, v - 1) : stok;
  }
  cl.sync();
}

// The launch's shape: the cluster size cs and slice n come from the
// caller (kernels/sampling.py::plan); refused unless cs slices of n cover
// V and the CTA's shared memory fits.
template <typename T>
bool refused(int n_rows, int v, int cs, int n) {
  using S = typename Store<T>::S;
  return n_rows <= 0 || v <= 0 || cs < 1 || cs > 16 || n <= 0 ||
         n % 8 != 0 || static_cast<long long>(cs) * n < v ||
         Layout(n, sizeof(S)).total > kMaxDynSmem;
}

template <typename T>
cudaError_t configure(int cs, int n, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr, int n_rows,
                      cudaStream_t stream) {
  using S = typename Store<T>::S;
  const int smem = Layout(n, sizeof(S)).total;
  // set at every launch: a once-only guard would be one object across the
  // kernel libraries a process loads
  cudaError_t e = cudaFuncSetAttribute(
      fused_sample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(fused_sample_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(n_rows * cs, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const void* logits, const void* temp, const void* top_k,
           const void* top_p, const void* bias_ids, const void* bias_vals,
           const void* u, const void* draft, void* token, void* p_draft,
           void* alt, int n_rows, int v, int cs, int n, cudaStream_t stream) {
  if (refused<T>(n_rows, v, cs, n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T>(cs, n, cfg, attr, n_rows, stream);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(
        &cfg, fused_sample_kernel<T>, static_cast<const T*>(logits),
        static_cast<const float*>(temp), static_cast<const int*>(top_k),
        static_cast<const float*>(top_p), static_cast<const int*>(bias_ids),
        static_cast<const float*>(bias_vals), static_cast<const float*>(u),
        static_cast<const int*>(draft), static_cast<int*>(token),
        static_cast<float*>(p_draft), static_cast<int*>(alt), v, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int n_rows, int v, int cs, int n, int* out) {
  if (refused<T>(n_rows, v, cs, n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<T>(cs, n, cfg, attr, n_rows, nullptr);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, fused_sample_kernel<T>);
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, fused_sample_kernel<T>, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = cs;
  out[1] = n_rows * cs;
  out[2] = kThreads;
  out[3] = static_cast<int>(cfg.dynamicSmemBytes);
  out[4] = static_cast<int>(fa.sharedSizeBytes);
  out[5] = fa.numRegs;
  out[6] = clusters;
  out[7] = n;
  out[8] = kCap;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits.  Every pointer is on the
// card: logits (R, V); temp, top_p, u (R,) float32; top_k, draft (R,)
// int32; bias_ids (R, 8) int32; bias_vals (R, 8) float32; outputs token,
// alt (R,) int32 and p_draft (R,) float32.  cluster CTAs a row, each
// holding a slice of `slice` columns (a multiple of 8).  Returns the
// launch's error; never synchronises.
extern "C" int fused_sample_launch(const void* logits, const void* temp,
                                   const void* top_k, const void* top_p,
                                   const void* bias_ids,
                                   const void* bias_vals, const void* u,
                                   const void* draft, void* token,
                                   void* p_draft, void* alt, int n_rows,
                                   int v, int dtype, int cluster, int slice,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, temp, top_k, top_p, bias_ids, bias_vals, u,
                         draft, token, p_draft, alt, n_rows, v, cluster,
                         slice, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, temp, top_k, top_p, bias_ids,
                                 bias_vals, u, draft, token, p_draft, alt,
                                 n_rows, v, cluster, slice, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan at these shapes: out[0..8] = cluster size, CTAs,
// threads a CTA, dynamic shared bytes, static shared bytes, registers a
// thread, clusters resident at once (cudaOccupancyMaxActiveClusters),
// slice columns, compact capacity.
extern "C" int fused_sample_info(int n_rows, int v, int dtype, int cluster,
                                 int slice, int* out) {
  if (dtype == 0) return info<float>(n_rows, v, cluster, slice, out);
  if (dtype == 1) return info<__nv_bfloat16>(n_rows, v, cluster, slice, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
