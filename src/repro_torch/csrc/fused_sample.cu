// Fused on-device sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sampling.py::fused_sample
// (pallas_call at :201, body _fused_sample_kernel / _sample_core).  Per
// logits row, in the reference's order: an additive bias of up to 8
// (id, value) slots applied in slot order, the temperature, EXACT top-k
// (the kth largest monotone int32 key found by a 31-step MSB descent,
// ties kept), a softmax, tie-inclusive top-p (a 31-step descent over the
// probability bits), a second softmax, and the inverse-CDF draw from the
// host's uniform u (the count of cumulative masses <= u, clamped to
// V - 1); plus p(draft) and the residual draw with the draft column
// zeroed.  Greedy rows (temp <= 0) give the biased argmax, the lowest
// index among equal maxima.
//
// Bound: it must read the (R, V) logits once, so at R = 40, V = 151,936
// in bf16 it is bound by 12.2 MB over the card's memory rate (~3.6 us).
// This first design is simple and right, not fast: one block of 1024
// threads per row, exact int counts and fp32 sums / max by block
// reductions (warp shuffles), a tiled block scan with a carried prefix
// for the CDF.  A row (600 KB in fp32) does not fit in shared memory, so
// the first pass writes the scaled row to an fp32 workspace and ~75
// later passes re-read it (L2-resident: 40 rows fit in the 50 MB L2);
// the probabilities are recomputed from it with the same expf and IEEE
// division each time, so every pass sees the same bits.  No fast math:
// division and expf stay IEEE-accurate, or the thresholds drift.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBias = 8;
constexpr float kNeg = -1e30f;        // masked logit, as the reference
constexpr int kSignLow = 0x7fffffff;

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Monotone int32 key: x < y <=> key(x) < key(y) for float32 x, y (no
// NaN).  Bit for bit the reference's _float_key (-0.0 keys below +0.0).
__device__ __forceinline__ int float_key(float x) {
  const int bits = __float_as_int(x);
  return bits >= 0 ? bits : (bits ^ kSignLow);
}

// Block reductions: every thread passes its value and gets the block's
// result.  `red` is kWarps words of shared scratch; the leading
// __syncthreads makes back-to-back calls safe.
__device__ __forceinline__ int block_sum_int(int x, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int t = 0;
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = red[0];
#pragma unroll 8
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

// (value, index) argmax: the largest value, the lowest index among
// equal maxima (jnp.argmax's rule).
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ int block_argmax(float v, int i, float* redv,
                                            int* redi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    arg_better(v, i, v2, i2);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    redv[threadIdx.x >> 5] = v;
    redi[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  float bv = redv[0];
  int bi = redi[0];
  for (int w = 1; w < kWarps; ++w) arg_better(bv, bi, redv[w], redi[w]);
  return bi;
}

// Count of cumulative masses <= u over the row's probabilities
// p_j = expf(ws[j] - m) / s * (j == zero_col ? 0 : 1) / div, walked in
// tiles of kThreads with an inclusive block scan and a carried prefix;
// each thread counts its own columns, one block sum totals them.
__device__ int inv_cdf_count(const float* ws, int v, float m, float s,
                             int zero_col, float div, float u, float* red,
                             int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  int count = 0;
  for (int base = 0; base < v; base += kThreads) {
    const int j = base + threadIdx.x;
    float p = 0.f;
    if (j < v && j != zero_col) p = expf(ws[j] - m) / s / div;
    float x = p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    __syncthreads();                      // red free from the last tile
    if (lane == 31) red[warp] = x;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += red[w];
    float total = carry;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    if (j < v && before + x <= u) ++count;
    carry = total;
  }
  return block_sum_int(count, redi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const T* __restrict__ logits,
                    const float* __restrict__ temp_in,
                    const int* __restrict__ topk_in,
                    const float* __restrict__ topp_in,
                    const int* __restrict__ bias_ids,
                    const float* __restrict__ bias_vals,
                    const float* __restrict__ u_in,
                    const int* __restrict__ draft_in, int* __restrict__ tok_out,
                    float* __restrict__ pd_out, int* __restrict__ alt_out,
                    float* __restrict__ work, int v) {
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];
  const int r = blockIdx.x;
  const T* row = logits + static_cast<size_t>(r) * v;
  float* ws = work + static_cast<size_t>(r) * v;
  const float temp = temp_in[r];
  const int top_k = topk_in[r];
  const float top_p = topp_in[r];
  const float u = u_in[r];
  const int draft = draft_in[r];
  int bid[kMaxBias];
  float bval[kMaxBias];
#pragma unroll
  for (int j = 0; j < kMaxBias; ++j) {
    bid[j] = bias_ids[r * kMaxBias + j];
    bval[j] = bias_vals[r * kMaxBias + j];
  }

  // pass 0: bias in slot order (a repeated id adds twice), the biased
  // argmax, the scaled row into the workspace
  const float tdiv = fmaxf(temp, 1e-6f);
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int j = threadIdx.x; j < v; j += kThreads) {
    float x = load_f(row, j);
#pragma unroll
    for (int b = 0; b < kMaxBias; ++b)
      if (j == bid[b]) x = x + bval[b];
    arg_better(best, best_i, x, j);
    ws[j] = x / tdiv;
  }
  const int gtok = block_argmax(best, best_i, redf, redi);
  if (temp <= 0.f) {
    if (threadIdx.x == 0) {
      tok_out[r] = gtok;
      pd_out[r] = gtok == draft ? 1.f : 0.f;
      alt_out[r] = gtok;
    }
    return;
  }

  // exact top-k over monotone keys, ties kept (_topk_keep)
  if (top_k > 0 && top_k < v) {
    int c = 0;
    for (int j = threadIdx.x; j < v; j += kThreads)
      c += float_key(ws[j]) >= 0;
    const int cnt_nn = block_sum_int(c, redi);
    const bool pos_side = cnt_nn >= top_k;
    // the kth key's side: the descent over the non-negative keys, or
    // over the low 31 bits of the negative keys for the remaining
    // k - cnt_nn
    const int need = pos_side ? top_k : top_k - cnt_nn;
    int t = 0;
    for (int i = 0; i < 31; ++i) {
      const int cand = t | (1 << (30 - i));
      int n = 0;
      for (int j = threadIdx.x; j < v; j += kThreads) {
        const int key = float_key(ws[j]);
        n += pos_side ? (key >= cand) : (key < 0 && (key & kSignLow) >= cand);
      }
      if (block_sum_int(n, redi) >= need) t = cand;
    }
    for (int j = threadIdx.x; j < v; j += kThreads) {
      const int key = float_key(ws[j]);
      const bool keep = pos_side ? (key >= 0 && key >= t)
                                 : (key >= 0 || (key & kSignLow) >= t);
      if (!keep) ws[j] = kNeg;
    }
  }

  // first softmax: p_j = expf(ws_j - m) / s, recomputed on each pass
  float mx = -CUDART_INF_F;
  for (int j = threadIdx.x; j < v; j += kThreads) mx = fmaxf(mx, ws[j]);
  float m = block_max(mx, redf);
  float acc = 0.f;
  for (int j = threadIdx.x; j < v; j += kThreads) acc += expf(ws[j] - m);
  float s = block_sum(acc, redf);

  // tie-inclusive top-p (_topp_theta): the minimal probability theta
  // whose strictly-greater mass is < top_p; keep p >= theta
  if (top_p > 0.f && top_p < 1.f) {
    int kacc = 0;
    for (int i = 0; i < 31; ++i) {
      const int bit = 1 << (30 - i);
      const int trial = kacc | (bit - 1);
      float part = 0.f;
      for (int j = threadIdx.x; j < v; j += kThreads) {
        const float p = expf(ws[j] - m) / s;
        if (__float_as_int(p) > trial) part += p;
      }
      if (!(block_sum(part, redf) < top_p)) kacc |= bit;
    }
    const float theta = __int_as_float(kacc);
    for (int j = threadIdx.x; j < v; j += kThreads) {
      const float p = expf(ws[j] - m) / s;
      if (!(p >= theta)) ws[j] = kNeg;
    }
    // second softmax over the nucleus
    mx = -CUDART_INF_F;
    for (int j = threadIdx.x; j < v; j += kThreads) mx = fmaxf(mx, ws[j]);
    m = block_max(mx, redf);
    acc = 0.f;
    for (int j = threadIdx.x; j < v; j += kThreads) acc += expf(ws[j] - m);
    s = block_sum(acc, redf);
  }
  // (top-p off: the reference's second softmax runs over the unchanged
  // row, so it is the first one — the same m and s)

  const int stok =
      min(inv_cdf_count(ws, v, m, s, -1, 1.f, u, redf, redi), v - 1);
  const int dcol = min(max(draft, 0), v - 1);
  const float p_d = expf(ws[dcol] - m) / s;
  // residual: the draft column zeroed, renormalised by its mass
  acc = 0.f;
  for (int j = threadIdx.x; j < v; j += kThreads)
    if (j != dcol) acc += expf(ws[j] - m) / s;
  const float mass = block_sum(acc, redf);
  int salt = stok;
  if (mass > 0.f)
    salt = min(inv_cdf_count(ws, v, m, s, dcol, fmaxf(mass, 1e-30f), u, redf,
                             redi),
               v - 1);
  if (threadIdx.x == 0) {
    tok_out[r] = stok;
    pd_out[r] = p_d;
    alt_out[r] = salt;
  }
}

template <typename T>
int launch(const void* logits, const void* temp, const void* top_k,
           const void* top_p, const void* bias_ids, const void* bias_vals,
           const void* u, const void* draft, void* token, void* p_draft,
           void* alt, void* work, int n_rows, int v, cudaStream_t stream) {
  fused_sample_kernel<T><<<n_rows, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(temp),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<const int*>(bias_ids), static_cast<const float*>(bias_vals),
      static_cast<const float*>(u), static_cast<const int*>(draft),
      static_cast<int*>(token), static_cast<float*>(p_draft),
      static_cast<int*>(alt), static_cast<float*>(work), v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits.  Every pointer is on the
// card: logits (R, V); temp, top_p, u (R,) float32; top_k, draft (R,)
// int32; bias_ids (R, 8) int32; bias_vals (R, 8) float32; outputs token,
// alt (R,) int32 and p_draft (R,) float32; work an (R, V) float32
// workspace.  Returns the launch's cudaGetLastError(); never
// synchronises.
extern "C" int fused_sample_launch(const void* logits, const void* temp,
                                   const void* top_k, const void* top_p,
                                   const void* bias_ids,
                                   const void* bias_vals, const void* u,
                                   const void* draft, void* token,
                                   void* p_draft, void* alt, void* work,
                                   int n_rows, int v, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(logits, temp, top_k, top_p, bias_ids, bias_vals, u,
                         draft, token, p_draft, alt, work, n_rows, v, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, temp, top_k, top_p, bias_ids,
                                 bias_vals, u, draft, token, p_draft, alt,
                                 work, n_rows, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
