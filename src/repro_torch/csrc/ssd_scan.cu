// Chunked Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (pallas_call
// at :94, body _kernel), in the group-factored form of
// repro/models/mamba.py::ssd_chunked: B and C are read per GROUP through
// the head -> group map g = h / (NH / G), never expanded to heads in
// device memory (mamba2's G = 1 would cost 80x the B/C bytes).  The
// per-head form of the TPU kernel is G == NH.
//
// One block of 256 threads per (head, batch row).  The TPU grid's
// sequential chunk axis becomes a loop inside the block, and the HD x DS
// fp32 state (64 x 128 = 32 KB at mamba2's widths) stays in shared memory
// across chunks, written out once at the end.  Per chunk of Q <= 128
// rows, as _kernel does, all in fp32, with la = dt * a and cum its
// prefix sums (one thread, in row order):
//   M[t, s] = exp(seg(t, s)) * (C_t . B_s) * dt_s for s <= t only, where
//     seg(t, s) = sum_{s < r <= t} la_r (exp is never taken above the
//     diagonal, where it would overflow);
//   y = M X + (C * exp(cum)) state^T, written in x's dtype;
//   state <- exp(cum_last) state + X^T (w * B), w_s = exp(seg(last, s))
//     dt_s.
// seg is summed directly, in row order, where _kernel takes cum_t -
// cum_s: after a large decay early in a chunk cum is large and that
// difference keeps few digits, while these sums add terms of one sign.
// The last chunk of an L off the chunk grid runs over its n < Q real rows
// only: the rows a zero-padded chunk would add (dt = 0) are exact
// identities, so nothing is read past L.
//
// Shared memory at chunk 128, HD 64, DS 128: the state (33 KB), X
// (32 KB), B (66 KB) and C (64 KB) of the chunk in fp32, plus the
// Q x Q matrix M computed 16 rows at a time (8 KB): 208 KB of the 227 KB
// a block may hold, so one block per SM.  The state and B rows are padded
// to DS + 1 floats, so the column walks of the M, y and state loops hit
// 32 distinct banks.
//
// Bound: at B = 1, L = 2048 the function does ~9.4 GFLOP of fp32 per
// layer (the reference computes in fp32) against ~45 MB of bytes, so it
// is bound by operations: ~0.14 ms at 67 TFLOP/s.  This first design is
// plain CUDA-core fp32 math from shared memory, right before fast:
// wgmma on bf16/TF32 tiles, TMA-fed chunks, and C.B^T computed once per
// group (all 80 heads of mamba2 share it) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kTileT = 16;                   // rows of M held at once
constexpr size_t kMaxSmem = 232448;          // 227 KB per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Dims {
  int len, nh, hd, ds, hpg, chunk;
  long long x_rs, b_rs, c_rs;                // element stride of a (b, t) row
};

__host__ __device__ constexpr size_t smem_floats(int hd, int ds, int q) {
  return static_cast<size_t>(hd) * (ds + 1)  // state
         + static_cast<size_t>(q) * hd       // X
         + static_cast<size_t>(q) * (ds + 1) // B
         + static_cast<size_t>(q) * ds       // C
         + static_cast<size_t>(kTileT) * q   // M rows
         + 4 * static_cast<size_t>(q);       // la, cum, dt, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hout, Dims d) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int hd = d.hd, ds = d.ds, q = d.chunk, sp = ds + 1;
  float* st = smem;                          // (hd, sp)
  float* xs = st + hd * sp;                  // (q, hd)
  float* bs = xs + q * hd;                   // (q, sp)
  float* cs = bs + q * sp;                   // (q, ds)
  float* ms = cs + q * ds;                   // (kTileT, q)
  float* la = ms + kTileT * q;               // (q)
  float* cum = la + q;                       // (q)
  float* dts = cum + q;                      // (q)
  float* ws = dts + q;                       // (q)
  const int g = h / d.hpg;
  const float av = a[h];
  const size_t sbase = (static_cast<size_t>(b) * d.nh + h) * hd * ds;
  for (int i = tid; i < hd * ds; i += kThreads)
    st[(i / ds) * sp + i % ds] = h0[sbase + i];

  for (int c0 = 0; c0 < d.len; c0 += q) {
    const int n = min(q, d.len - c0);
    const size_t row0 = static_cast<size_t>(b) * d.len + c0;
    __syncthreads();                         // the last chunk is done
    for (int i = tid; i < n * hd; i += kThreads) {
      const int t = i / hd, p = i % hd;
      xs[i] = to_f(x[(row0 + t) * d.x_rs + static_cast<size_t>(h) * hd + p]);
    }
    for (int i = tid; i < n * ds; i += kThreads) {
      const int t = i / ds, k = i % ds;
      const size_t col = static_cast<size_t>(g) * ds + k;
      bs[t * sp + k] = to_f(bm[(row0 + t) * d.b_rs + col]);
      cs[t * ds + k] = to_f(cm[(row0 + t) * d.c_rs + col]);
    }
    for (int t = tid; t < n; t += kThreads)
      dts[t] = dt[(row0 + t) * d.nh + h];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int t = 0; t < n; ++t) {
        la[t] = dts[t] * av;
        s += la[t];
        cum[t] = s;
      }
    }
    __syncthreads();
    const float cum_last = cum[n - 1];
    for (int t = tid; t < n; t += kThreads) {
      float seg = 0.f;
      for (int r = t + 1; r < n; ++r) seg += la[r];
      ws[t] = expf(seg) * dts[t];
    }

    // y over the chunk's rows, kTileT rows of M at a time; the carried
    // state's term uses the state before this chunk's update
    for (int t0 = 0; t0 < n; t0 += kTileT) {
      const int tn = min(kTileT, n - t0);
      for (int i = tid; i < tn * n; i += kThreads) {
        const int tt = i / n, s = i % n, t = t0 + tt;
        float m = 0.f;
        if (s <= t) {
          const float* cr = cs + t * ds;
          const float* br = bs + s * sp;
          float dot = 0.f;
          for (int k = 0; k < ds; ++k) dot = fmaf(cr[k], br[k], dot);
          float seg = 0.f;
          for (int r = s + 1; r <= t; ++r) seg += la[r];
          m = expf(seg) * dot * dts[s];
        }
        ms[tt * q + s] = m;
      }
      __syncthreads();
      for (int i = tid; i < tn * hd; i += kThreads) {
        const int tt = i / hd, p = i % hd, t = t0 + tt;
        const float* mr = ms + tt * q;
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) acc = fmaf(mr[s], xs[s * hd + p], acc);
        const float* cr = cs + t * ds;
        const float* sr = st + p * sp;
        float inter = 0.f;
        for (int k = 0; k < ds; ++k) inter = fmaf(cr[k], sr[k], inter);
        acc = fmaf(expf(cum[t]), inter, acc);
        y[((row0 + t) * d.nh + h) * hd + p] = from_f<T>(acc);
      }
      __syncthreads();
    }

    const float decay = expf(cum_last);
    for (int i = tid; i < hd * ds; i += kThreads) {
      const int p = i / ds, k = i % ds;
      float acc = 0.f;
      for (int s = 0; s < n; ++s)
        acc = fmaf(xs[s * hd + p] * ws[s], bs[s * sp + k], acc);
      st[p * sp + k] = fmaf(decay, st[p * sp + k], acc);
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * ds; i += kThreads)
    hout[sbase + i] = st[(i / ds) * sp + i % ds];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* h0, void* y, void* hout, int batch,
           Dims d, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const size_t smem = sizeof(float) * smem_floats(d.hd, d.ds, d.chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(d.nh, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, L, NH, HD) and bm, cm: (B, L, G, DS) in one dtype (0 = float32,
// 1 = bfloat16), each (b, t) row `*_rs` elements after the last and its
// inner dims contiguous; dt: (B, L, NH) and a: (NH,) float32; h0 and
// hout: (B, NH, HD, DS) float32 (they may alias); y: (B, L, NH, HD)
// contiguous.  chunk: rows per chunk, 1..128.  Returns the launch's
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* h0, void* y, void* hout,
                               int batch, int len, int nh, int hd, int ds,
                               int groups, int chunk, int x_rs, int b_rs,
                               int c_rs, int dtype, void* stream) {
  if (batch <= 0 || len <= 0 || nh <= 0 || hd <= 0 || ds <= 0 ||
      groups <= 0 || nh % groups != 0 || chunk <= 0 || chunk > kMaxChunk ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{len, nh, hd, ds, nh / groups, chunk < len ? chunk : len,
               x_rs, b_rs, c_rs};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, hout, batch, d, s);
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, h0, y, hout, batch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
