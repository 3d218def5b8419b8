// Ragged (packed, padding-free) prefill flash attention for Hopper
// (sm_90a), causal or not, over any KV layout of attn_common.cuh.  Each of
// ragged_prefill_paged.cu, ragged_prefill_arena.cu and
// ragged_prefill_attn.cu instantiates it for its layout and exports one C
// entry point.
//
// Computes, for a packed flat token stream q (T, Hq, D) whose segments
// are given by cu_seqlens (B+1,): every row of segment b attends its
// segment's keys at positions < kv_lengths[b] and, if causal, <= its own
// position q_offsets[b] + (row - cu_seqlens[b]); with a window W > 0
// (the ring and rolling layouts of attn_common.cuh) also > its position
// - W, and only among the positions the layout still holds.  Non-causal
// (causal == 0), each row attends every held key of its segment below
// kv_lengths[b] (and above its position - W when windowed), as the TPU
// kernels' causal=False form does.  GQA maps query head h to KV head h /
// rep; softmax is online in fp32; p is rounded to the storage type
// before the PV product; rows past cu_seqlens[B] and rows with no valid
// key write exactly 0.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// main-path chunk (512 rows at history 1536 over 2048 keys, 32/8 heads,
// D = 128) is ~4·T·K·D·Hq ≈ 15 GFLOP against ~17 MB of q, KV and output,
// ~900 FLOP/byte, far above the ~295 FLOP/byte ridge: the tensor cores
// bound it, 0.0152 ms.  A speculative verify tick (8 segments of 5 rows
// over 2048 keys each) is the other way round: 0.17 GFLOP over 67 MB of
// KV, bound by bytes (0.020 ms), like a decode step.
//
// What the design does about it: the attention tile core of
// attn_tiles.cuh, at head widths 64, 80, 96 and 128.  In bf16 a block is
// two warpgroups on a tile of 128 query vectors — 128 / rep rows of one
// segment x the rep query heads of one KV head g (32 rows at qwen3-4b's
// rep 4, 25 with 3 idle vectors at qwen2.5-32b's rep 5, 128 rows of one
// head at an MHA config's rep 1) — each warpgroup running Q.K^T and P.V
// for its 64 vectors on the tensor cores (wgmma, bf16 in, fp32 accumulate), with
// K/V tiles of 64 keys arriving by cp.async into a three-stage ring
// while earlier tiles are multiplied; a warpgroup whose 64 vectors are
// all past the tile's rows (a short segment) only loads.  Each key
// row's address comes from the layout's row map, so one loader serves
// the page pool (a 64-key tile spans four 16-token pages), the slot
// arena and the gathered rows; each K/V tile is read from memory once
// per tile and serves every row and head of it.  fp32, the checking
// type, stays on the CUDA-core loop of the same core.
//
// The served case — a page pool with no window, bf16, D = 128, pages of
// 8 to 64 tokens (attn_tma.cuh tma_core) — takes its own kernel,
// ragged_prefill_kernel_tma, over attn_tma.cuh's core: the same tiles
// and key walk, the same arithmetic, but K and V streamed by TMA from a
// producer warp into a six-stage ring (a 64-key step is four 16-token
// pages x two column halves x K and V, sixteen boxes), so the two
// consumer warpgroups only multiply and run the softmax.  Every other
// form keeps the cp.async core (PERF.md §6 says which rows take which).
//
// Tiles never straddle segments.  A tile that held rows of two segments
// would walk the keys of both, and at 32 rows a tile a verify tick's
// 5-row segments would put seven 2048-key walks in one block.  So block x
// finds its (segment, tile within the segment) by scanning cu_seqlens
// (<= 16 segments, no host sync): segment b owns ceil(len_b / rows)
// tiles, the rows past cu_seqlens[B] the tiles after them (written as
// zeros), and the launch's ceil(T / rows) + B blocks bound that count;
// blocks past it exit.  A pad segment (cu[b] == cu[b+1]) owns no tile.
// Within segment b the key walk stops at min(kv_len, causal frontier of
// the tile's last row) — at kv_len when non-causal — so no row at or
// past kv_len is ever read:
// page-table entries past the valid length, and an arena slot's park row
// S_max - 1 that pad and tail rows write in the same step, may hold
// anything.  Windowed, the walk starts at the window's lower edge for
// the tile's first row, and never below the oldest position the ring or
// rolling slot holds (kv_len - depth): the walk is over logical
// positions, each mapped to its wrapped row, so a 64-key tile that
// straddles the wrap reads the ring's last page and its first in one
// cp.async round, and the grid, a function of T and B alone, is the
// same at every kv_len (a captured step replays at any length).
//
// Left for the next redesign: warpgroups that alternate softmax and
// MMAs, the other layouts and widths on the TMA feed, and a split of the
// key walk for the few long tiles of a verify tick (8 segments x 8 KV
// heads = 64 blocks over 2048 keys each) and the one-row segments of a
// mixed step (a whole m64 product a step for 4 query vectors).
#pragma once

#include "attn_tma.cuh"

namespace attn {
namespace prefill {

constexpr int kMaxRep = 32;           // query heads per KV group

// This block's tile (block-uniform): its segment seg (n_seqs for the
// rows past cu_seqlens[B]) and its first row r0; false for a block past
// the last tile.  Segment b owns ceil(len_b / rows_per_block) tiles.
__device__ __forceinline__ bool find_tile(const int* __restrict__ cu_seqlens,
                                          int n_seqs, int n_rows,
                                          int rows_per_block, int& seg,
                                          int& s0, int& s1, int& r0) {
  int x = blockIdx.x;
  seg = n_seqs;
  s0 = cu_seqlens[n_seqs];
  s1 = n_rows;
  for (int b = 0; b < n_seqs; ++b) {
    const int b0 = cu_seqlens[b], b1 = cu_seqlens[b + 1];
    const int tiles = b1 > b0 ? (b1 - b0 + rows_per_block - 1) /
                                    rows_per_block : 0;
    if (x < tiles) {
      seg = b;
      s0 = b0;
      s1 = b1;
      break;
    }
    x -= tiles;
  }
  r0 = s0 + x * rows_per_block;
  return r0 < s1;
}

// The tile's arguments (attn_tiles.cuh TileArgs) for KV head blockIdx.y.
template <typename T, int D, typename Layout>
__device__ __forceinline__ TileArgs<T> tile_args(
    const T* q, T* out, Layout layout, const int* __restrict__ q_offsets,
    const int* __restrict__ kv_lengths, int hq, int hkv, int n_seqs,
    int rows_per_block, int causal, int window, int seg, int s0, int s1,
    int r0) {
  int kv_lo = 0, kv_hi = 0;           // the positions the layout holds
  if (seg < n_seqs) layout.held(kv_lengths[seg], kv_lo, kv_hi);
  return TileArgs<T>{q + static_cast<size_t>(r0) * hq * D,
                     out + static_cast<size_t>(r0) * hq * D,
                     min(rows_per_block, s1 - r0),
                     hq / hkv,
                     hq,
                     static_cast<int>(blockIdx.y),
                     hkv,
                     seg < n_seqs ? q_offsets[seg] + (r0 - s0) : 0,
                     kv_lo,
                     kv_hi,
                     causal,
                     window};
}

// rows past cu_seqlens[B]: zeros
template <typename T, int D>
__device__ __forceinline__ void zero_tile(const TileArgs<T>& a) {
  for (int i = threadIdx.x; i < a.n_rows * a.rep * D; i += blockDim.x)
    a.out[a.vec(i / D) * D + i % D] = from_f<T>(0.f);
}

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(Tile<T, D>::kThreads)
ragged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                      const T* __restrict__ vbuf, Layout layout,
                      const int* __restrict__ cu_seqlens,
                      const int* __restrict__ q_offsets,
                      const int* __restrict__ kv_lengths,
                      T* __restrict__ out, int n_rows, int hq, int hkv,
                      int n_seqs, int rows_per_block, int causal,
                      int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  int seg, s0, s1, r0;
  if (!find_tile(cu_seqlens, n_seqs, n_rows, rows_per_block, seg, s0, s1,
                 r0))
    return;                           // past the last tile
  const TileArgs<T> a = tile_args<T, D>(q, out, layout, q_offsets,
                                        kv_lengths, hq, hkv, n_seqs,
                                        rows_per_block, causal, window, seg,
                                        s0, s1, r0);
  if (seg == n_seqs) return zero_tile<T, D>(a);
  Tile<T, D>::run(a, kbuf, vbuf, layout.rows(seg), smem);
}

// The same tiles over a page pool, bf16 at D = 128 with no window, on
// attn_tma.cuh's TMA-fed core: q and the K and V pools are read through
// the tensor maps (q's rows and heads, and the pool's rows, heads and
// columns), out and the page table directly.
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(TmaTile::kThreads, 1)
ragged_prefill_kernel_tma(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          Layout layout, const int* __restrict__ cu_seqlens,
                          const int* __restrict__ q_offsets,
                          const int* __restrict__ kv_lengths,
                          T* __restrict__ out, int n_rows, int hq, int hkv,
                          int n_seqs, int rows_per_block, int causal) {
  static_assert(D == TmaTile::D, "the TMA-fed core is D = 128");
  extern __shared__ __align__(1024) unsigned char tma_smem[];
  int seg, s0, s1, r0;
  if (!find_tile(cu_seqlens, n_seqs, n_rows, rows_per_block, seg, s0, s1,
                 r0))
    return;
  const TileArgs<T> a = tile_args<T, D>(nullptr, out, layout, q_offsets,
                                        kv_lengths, hq, hkv, n_seqs,
                                        rows_per_block, causal, 0, seg, s0,
                                        s1, r0);
  if (seg == n_seqs) return zero_tile<T, D>(a);
  TmaTile::run(a, &qmap, &kmap, &vmap, layout.rows(seg).pt,
               layout.page_size, r0, tma_smem);
}

template <typename T, int D, typename Layout>
int launch(const void* q, const void* k, const void* v, Layout layout,
           const void* cu_seqlens, const void* q_offsets,
           const void* kv_lengths, void* out, int n_rows, int hq, int hkv,
           int n_seqs, int causal, int window, cudaStream_t stream) {
  auto kern = ragged_prefill_kernel<T, D, Layout>;
  const size_t smem = Tile<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = Tile<T, D>::kM / (hq / hkv);
  // segment-aligned tiles: at most ceil(T / rows) + B of them
  dim3 grid((n_rows + rows_per_block - 1) / rows_per_block + n_seqs, hkv);
  kern<<<grid, Tile<T, D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const int*>(cu_seqlens),
      static_cast<const int*>(q_offsets), static_cast<const int*>(kv_lengths),
      static_cast<T*>(out), n_rows, hq, hkv, n_seqs, rows_per_block,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The launch arguments every layout's kernel takes: GQA groups of at most
// kMaxRep heads, rows, a causal flag of 0 or 1, a window >= 0, a layout
// that holds a position.
inline bool args_ok(int n_rows, int hq, int hkv, int n_seqs, int causal,
                    int window, int depth) {
  return hkv > 0 && hq % hkv == 0 && hq / hkv <= kMaxRep && n_rows > 0 &&
         n_seqs >= 0 && (causal == 0 || causal == 1) && window >= 0 &&
         depth > 0;
}

// The TMA-fed launch over a page pool of n_pages pages: bf16, D = 128,
// no window (tma_core).  Encodes q's map and the K and V pools' maps
// (attn_tma.cuh encode_bf16_3d) and launches; the maps are kernel
// arguments, so a captured CUDA graph replays them, and with them the
// pool's and q's addresses, unchanged.
inline int launch_tma(const void* q, const void* k, const void* v,
                      PagedLayout layout, int n_pages,
                      const void* cu_seqlens, const void* q_offsets,
                      const void* kv_lengths, void* out, int n_rows, int hq,
                      int hkv, int n_seqs, int causal, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int D = TmaTile::D;
  auto kern = ragged_prefill_kernel_tma<T, D, PagedLayout>;
  const uint64_t pool_rows = static_cast<uint64_t>(n_pages) *
                             layout.page_size;
  if (!args_ok(n_rows, hq, hkv, n_seqs, causal, 0, layout.depth()) ||
      n_pages <= 0 || pool_rows > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = hq / hkv;
  const int rows_per_block = TmaTile::kM / rep;
  CUtensorMap qmap, kmap, vmap;
  int err = encode_bf16_3d(&qmap, q, D, hq, n_rows, rep, rows_per_block);
  if (err == 0)
    err = encode_bf16_3d(&kmap, k, D, hkv, pool_rows, 1, layout.page_size);
  if (err == 0)
    err = encode_bf16_3d(&vmap, v, D, hkv, pool_rows, 1, layout.page_size);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TmaTile::kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n_rows + rows_per_block - 1) / rows_per_block + n_seqs, hkv);
  kern<<<grid, TmaTile::kThreads, TmaTile::kSmem, stream>>>(
      qmap, kmap, vmap, layout, static_cast<const int*>(cu_seqlens),
      static_cast<const int*>(q_offsets), static_cast<const int*>(kv_lengths),
      static_cast<T*>(out), n_rows, hq, hkv, n_seqs, rows_per_block, causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64, 80, 96 or 128 (the
// tile core's widths); causal: 1 or 0; window: the sliding window (0 =
// none).  Returns
// the launch's cudaGetLastError() (0 on success); never synchronises.
template <typename Layout>
int entry(const void* q, const void* k, const void* v, Layout layout,
          const void* cu_seqlens, const void* q_offsets,
          const void* kv_lengths, void* out, int n_rows, int hq, int hkv,
          int head_dim, int n_seqs, int causal, int window, int dtype,
          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!args_ok(n_rows, hq, hkv, n_seqs, causal, window, layout.depth()))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    return launch<typename F::T, F::D>(q, k, v, layout, cu_seqlens,
                                       q_offsets, kv_lengths, out, n_rows,
                                       hq, hkv, n_seqs, causal, window, s);
  });
}

// The launch facts (attn_common.cuh kernel_info) of the kernel of this
// form over Layout.
template <typename Layout>
int info(int head_dim, int dtype, int* out) {
  return with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    using Core = Tile<typename F::T, F::D>;
    return kernel_info(ragged_prefill_kernel<typename F::T, F::D, Layout>,
                       Core::kThreads, Core::kSmem, out);
  });
}

// The launch facts of the TMA-fed kernel (bf16, D = 128, PagedLayout).
inline int tma_info(int* out) {
  return kernel_info(
      ragged_prefill_kernel_tma<__nv_bfloat16, TmaTile::D, PagedLayout>,
      TmaTile::kThreads, TmaTile::kSmem, out);
}

}  // namespace prefill
}  // namespace attn
