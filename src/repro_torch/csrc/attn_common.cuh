// Shared helpers of the attention kernels: the forms they take (storage
// type x head width) and the dispatch over them, element conversion for
// the two storage types (fp32, bf16), the probability rounding the
// TPU kernels apply before the PV product, the KV layouts (a page
// pool read through a page table, a slot arena read through a slot map,
// and their windowed forms, a ring page table and rolling slots) and the
// K/V tile load into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;   // masked score, as the TPU kernels use

// One instantiation of an attention kernel: storage type T, head width D.
template <typename T_, int D_>
struct Form {
  using T = T_;
  static constexpr int D = D_;
};

// The forms every attention kernel takes: dtype 0 = float32, 1 =
// bfloat16, head widths 64, 80, 96 and 128 (every head width of the
// reference's configs).  Calls f(Form<T, D>{}) and returns its result,
// or cudaErrorInvalidValue for any other dtype or width.
template <typename T, typename F>
int with_width(int head_dim, F&& f) {
  switch (head_dim) {
    case 64: return f(Form<T, 64>{});
    case 80: return f(Form<T, 80>{});
    case 96: return f(Form<T, 96>{});
    case 128: return f(Form<T, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int with_form(int dtype, int head_dim, F&& f) {
  if (dtype == 0) return with_width<float>(head_dim, f);
  if (dtype == 1) return with_width<__nv_bfloat16>(head_dim, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A kernel's launch facts on this card, for a launch plan's log: out[0]
// its dynamic shared bytes a block, out[1] registers a thread, out[2]
// blocks resident per SM; its shared-memory attribute set first, as a
// launch sets it.
template <typename K>
int kernel_info(K kern, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(smem);
  out[1] = fa.numRegs;
  out[2] = per_sm;
  return 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The TPU kernels cast p to v.dtype before the PV product
// (ragged_prefill.py:293, decode_attn.py:201); the row sum l keeps the
// unrounded fp32 p.
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<T>(p));
}

// 16-byte vectors of storage elements, unpacked to fp32 without a trip
// through local memory (a bf16 is the top half of its fp32)
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(uint4 r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Where segment b's key position pos lives: row rows(pos) of K/V storage
// laid out (rows, hkv, D).  A page pool (N_pages, page_size, hkv, D) maps
// pos through the segment's page-table row; a slot arena (N_slots, S_max,
// hkv, D) holds the segment's positions contiguously in one slot.  The
// windowed forms hold only a segment's newest positions and wrap: a RING
// page table maps pos to page-table entry (pos / page_size) % n_ring, a
// ROLLING slot of depth rows holds pos at row pos % depth.
struct PagedRows {
  const int* pt;
  int page_size;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return static_cast<size_t>(pt[pos / page_size]) * page_size +
           pos % page_size;
  }
};

struct SlotRows {
  size_t base;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return base + pos;
  }
};

struct RingRows {
  const int* pt;
  int page_size, n_ring;
  __device__ __forceinline__ size_t operator()(int pos) const {
    const int blk = pos / page_size;
    return static_cast<size_t>(pt[blk % n_ring]) * page_size +
           (pos - blk * page_size);
  }
};

struct RollingRows {
  size_t base;
  int depth;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return base + pos % depth;
  }
};

// The KV layout a kernel reads.  depth() is the most positions a segment
// holds at once; held(kv_len, lo, hi) the positions [lo, hi) it holds
// when kv_len are cached — [0, min(kv_len, depth)) for the full-depth
// layouts, the newest [max(0, kv_len - depth), kv_len) for the wrapping
// ones, exactly the rows the TPU kernels reconstruct a position for
// (slot s holding s + depth * floor((kv_len - 1 - s) / depth),
// ragged_prefill.py:270-282); rows(b) is segment b's row map.  Kernels
// walk logical positions inside [lo, hi) and map each to its row.
struct PagedLayout {
  const int* page_table;   // (B, p_max)
  int page_size, p_max;
  __host__ __device__ __forceinline__ int depth() const {
    return p_max * page_size;
  }
  __device__ __forceinline__ void held(int kv_len, int& lo,
                                       int& hi) const {
    lo = 0;
    hi = min(max(kv_len, 0), depth());
  }
  __device__ __forceinline__ PagedRows rows(int b) const {
    return {page_table + static_cast<size_t>(b) * p_max, page_size};
  }
};

// With slot_map == nullptr it is the batch-row layout of a gathered
// cache (B, S, hkv, D): segment or row b reads cache row b.
struct SlotLayout {
  const int* slot_map;     // (B,); nullptr: segment b reads slot b
  int s_max;
  __host__ __device__ __forceinline__ int depth() const { return s_max; }
  __device__ __forceinline__ void held(int kv_len, int& lo,
                                       int& hi) const {
    lo = 0;
    hi = min(max(kv_len, 0), s_max);
  }
  __device__ __forceinline__ SlotRows rows(int b) const {
    const int slot = slot_map != nullptr ? slot_map[b] : b;
    return {static_cast<size_t>(slot) * s_max};
  }
};

// A ring page table (B, n_ring): the windowed form of PagedLayout.
struct RingLayout {
  const int* page_table;   // (B, n_ring)
  int page_size, n_ring;
  __host__ __device__ __forceinline__ int depth() const {
    return n_ring * page_size;
  }
  __device__ __forceinline__ void held(int kv_len, int& lo,
                                       int& hi) const {
    hi = max(kv_len, 0);
    lo = max(0, hi - depth());
  }
  __device__ __forceinline__ RingRows rows(int b) const {
    return {page_table + static_cast<size_t>(b) * n_ring, page_size,
            n_ring};
  }
};

// Rolling slots (N_slots, depth, hkv, D): the windowed form of SlotLayout.
struct RollingLayout {
  const int* slot_map;     // (B,)
  int s_depth;
  __host__ __device__ __forceinline__ int depth() const { return s_depth; }
  __device__ __forceinline__ void held(int kv_len, int& lo,
                                       int& hi) const {
    hi = max(kv_len, 0);
    lo = max(0, hi - s_depth);
  }
  __device__ __forceinline__ RollingRows rows(int b) const {
    return {static_cast<size_t>(slot_map[b]) * s_depth, s_depth};
  }
};

// Load key positions [base, base + KT) of KV head g into shared memory
// as fp32: ks with row stride D + 1 (bank padding), vs with row stride D.
// NT threads cooperate, `lane` being this thread's index among them;
// each moves 16-byte vectors, issuing up to 4 K and 4 V loads before it
// stores any, so several loads are in flight per thread.  When NT does
// not divide the tile's KT * D / V vectors (D = 80 or 96: 10 or 12 bf16
// vectors a row), the last round is ragged and its spare lanes idle;
// where it divides, the guards fold away at compile time.  Positions >=
// n_keys are zero-filled and their rows (page-table entries, slot rows)
// are never read.  The storage base pointers must be 16-byte aligned
// (the wrappers check), and so is every row: D * sizeof(T) is a
// multiple of 16.
template <typename T, int D, int KT, int NT, typename Rows>
__device__ __forceinline__ void load_kv_tile(
    const T* __restrict__ kbuf, const T* __restrict__ vbuf, Rows rows,
    int base, int n_keys, int hkv, int g, int lane, float* ks, float* vs) {
  constexpr int V = Vec16<T>::n;
  static_assert(D % V == 0, "a row must split into 16-byte vectors");
  constexpr int kRowVecs = D / V;
  constexpr int kTotal = KT * kRowVecs;
  constexpr int kPer = (kTotal + NT - 1) / NT;
  constexpr int kRound = kPer < 4 ? kPer : 4;
  constexpr bool kEven = kTotal % NT == 0 && kPer % kRound == 0;
#pragma unroll
  for (int r = 0; r < kPer; r += kRound) {
    uint4 kraw[kRound], vraw[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int vi = lane + (r + u) * NT;
      const int pos = base + vi / kRowVecs;
      kraw[u] = make_uint4(0u, 0u, 0u, 0u);
      vraw[u] = kraw[u];
      const bool in = kEven || (r + u < kPer && vi < kTotal);
      if (in && pos < n_keys) {
        const size_t o =
            (rows(pos) * hkv + g) * D + (vi % kRowVecs) * V;
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(kbuf + o));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(vbuf + o));
      }
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int vi = lane + (r + u) * NT;
      if (!(kEven || (r + u < kPer && vi < kTotal))) continue;
      const int j = vi / kRowVecs, d0 = (vi % kRowVecs) * V;
      float kf[V], vf[V];
      Vec16<T>::unpack(kraw[u], kf);
      Vec16<T>::unpack(vraw[u], vf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ks[j * (D + 1) + d0 + e] = kf[e];
        vs[j * D + d0 + e] = vf[e];
      }
    }
  }
}

}  // namespace attn
