// Dense (B, Lq) flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attn.py::flash_attn
// (pallas_call at :140): prefill and re-prefill attention of the dense
// (L, B) grid, and the non-causal attention of an encoder layer.  For
// batch row b, query row i sits at position q_offsets[b] + i and attends
// the keys of cache row b at positions p < kv_lengths[b] that also pass
// p <= its position (causal) and p > its position - window (window > 0).
// GQA maps query head h to KV head h / rep without duplicating KV;
// softmax is online in fp32; p is rounded to the storage type before the
// PV product, as `p.astype(v.dtype)` does (flash_attn.py:87); a row with
// no valid key writes exactly 0.  Where lse is given (training: the
// forward of kernels/flash_attn.py FlashAttnFn), each query's log-sum-exp
// of its scaled scores is written too, for flash_attn_bwd.cu; serving
// passes nullptr and writes nothing more.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): ~4·K·D
// FLOPs per query vector over its K keys, against q, the band of KV and
// the output moved once.  The grid step (64 rows at history 256, B = 8,
// 32/8 heads, D = 128) is 2.4 GFLOP over 19 MB, ~130 FLOP/byte, below
// the ~295 FLOP/byte ridge: bytes bound it, 0.0056 ms.  An encoder layer
// (8 clips of 1500 frames, 16 heads of 80, non-causal) is 92 GFLOP over
// 123 MB and a long prompt's 256-row chunk at history 1792 8.1 GFLOP
// over 13 MB: the tensor cores bound them, 0.093 and 0.0082 ms.
//
// What the design does about it: the attention tile core of
// attn_tiles.cuh.  In bf16 a block is two warpgroups on a tile of 128
// query vectors (128 / rep rows x the rep heads of one KV group: 128 rows
// at hubert's rep 1, 32 at qwen3-4b's rep 4, 25 with 3 idle vectors at
// qwen2.5-32b's rep 5, 16 at rep 8), each warpgroup running Q.K^T and
// P.V for its 64 vectors on the tensor cores (wgmma, bf16 in, fp32
// accumulate) at every width 64/80/96/128, with K/V tiles of 64 keys
// arriving by cp.async into a three-stage ring while earlier tiles are
// multiplied.  Each K/V tile in shared memory serves every row and head
// of the tile, and key tiles outside the rows' band are never loaded —
// past kv_lengths[b], past the causal frontier of the tile's last row,
// before the window of its first row (flash_attn.py:56-59).  The band
// also bounds every read: a dummy depth row whose offset is the park
// position S - 1 runs its queries past S, and kv_lengths[b] (at most S)
// still stops its key walk.  fp32, the checking type, stays on the
// CUDA-core loop of the same core.
//
// Left for the next redesign: the K/V stream from L2 still bounds the
// long shapes — TMA with a producer warp and cluster multicast of a K/V
// tile to the blocks of one (b, g) would cut its cost; inside a
// warpgroup the softmax waits for the MMAs and the MMAs for the softmax
// (FA3's ping-pong between warpgroups needs the producer's mbarriers
// first); a (256, 1) chunk fills only 64 blocks, which a split of the
// key walk would widen.
//
// Layout of the work: one block per (tile of Tile::kM / rep query rows,
// KV head g, batch row b).
#include "attn_tiles.cuh"

namespace attn {
namespace flash {

constexpr int kMaxRep = 8;            // query heads per KV group

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                  const T* __restrict__ vbuf,
                  const int* __restrict__ q_offsets,
                  const int* __restrict__ kv_lengths, T* __restrict__ out,
                  float* __restrict__ lse, int lq, int s, int hq, int hkv,
                  int causal, int window, int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * rows_per_block;
  const size_t row0 = static_cast<size_t>(b) * lq + r0;
  const TileArgs<T> a{q + row0 * hq * D,
                      out + row0 * hq * D,
                      min(rows_per_block, lq - r0),
                      hq / hkv,
                      hq,
                      g,
                      hkv,
                      q_offsets[b] + r0,
                      0,
                      min(max(kv_lengths[b], 0), s),
                      causal,
                      window,
                      lse == nullptr ? nullptr
                                     : lse + static_cast<size_t>(b) * hq * lq
                                           + r0,
                      lq};
  Tile<T, D>::run(a, kbuf, vbuf, SlotRows{static_cast<size_t>(b) * s},
                  smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const void* q_offsets, const void* kv_lengths, void* out,
           void* lse, int n_batch, int lq, int s, int hq, int hkv,
           int causal, int window, cudaStream_t stream) {
  auto kern = flash_attn_kernel<T, D>;
  const size_t smem = Tile<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = Tile<T, D>::kM / (hq / hkv);
  dim3 grid((lq + rows_per_block - 1) / rows_per_block, hkv, n_batch);
  kern<<<grid, Tile<T, D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_offsets),
      static_cast<const int*>(kv_lengths), static_cast<T*>(out),
      static_cast<float*>(lse), lq, s, hq, hkv, causal, window,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace attn

// q: (B, Lq, Hq, D); k, v: (B, S, Hkv, D); q_offsets, kv_lengths: (B,)
// int32; out: (B, Lq, Hq, D); lse: nullptr, or (B, Hq, Lq) fp32 for each
// query's log-sum-exp (the training form; -inf on a row with no key).
// causal: 0 or 1; window: 0 for none, else the band width.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, const void* q_offsets,
    const void* kv_lengths, void* out, void* lse, int n_batch, int lq,
    int s, int hq, int hkv, int head_dim, int causal, int window,
    int dtype, void* stream) {
  using namespace attn::flash;
  auto st = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || n_batch <= 0 ||
      n_batch > 65535 || lq <= 0 || s <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return attn::with_form(dtype, head_dim, [&](auto form) {
    using F = decltype(form);
    return launch<typename F::T, F::D>(q, k, v, q_offsets, kv_lengths, out,
                                       lse, n_batch, lq, s, hq, hkv, causal,
                                       window, st);
  });
}
