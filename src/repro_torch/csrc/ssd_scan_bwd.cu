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
// Three kernels, six launches a call, on the caller's stream, with no
// float atomics, so two runs give the same bits:
//   1. ssd_bwd_cb_kernel, one block per (batch row, chunk, group): C . B^T
//      of the chunk's lower triangle once per GROUP (mamba2's 80 heads
//      share one), fp32, into a workspace;
//   2. ssd_bwd_walk_kernel, one block per (batch row, head, slice of kP =
//      32 of the head's HD columns), as the forward's walk: the chunks in
//      reverse with the slice's kP x DS state gradient dH in shared
//      memory, seeded by the final state's gradient and written out as
//      the initial state's after the first chunk.  Per chunk a thread per
//      (column s, half of the slice) walks down its column computing seg
//      by running sums (the forward's order), M, G, dx's intra-chunk
//      term, dCB and the column's dseg sum; a thread per (row, half)
//      sums the row's dseg; then the DS columns in tiles of kKT = 32 (B,
//      C and H staged per tile): dH B_s and C_t H^T per (row, half of the
//      slice), dB and dC per (row, 16 of the tile's columns), and dH's
//      update.  dx is whole (its sums stay in the block); dB, dC, d dt
//      and da are sums over the head's slices and the group's heads, so
//      the block writes fp32 partials;
//   3. ssd_bwd_sum_kernel, four launches: each sum over its partials in a
//      fixed order (dB and dC per (row, group, column) over the group's
//      heads and slices, d dt over slices, da over batch rows, chunks and
//      slices), written in the output's dtype.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// mamba2-2.7b's training shape (B 4, L 1024, 80 heads of 64, DS 128,
// chunk 128, bf16) it must read x, dy, B, C, dt and the chunk states
// (~171 MB, the states 84 MB of it) and write dx, dB, dC, d dt and the
// initial state's gradient (~56 MB): ~0.07 ms; its products (G, the two
// intra-chunk sums and five rank-HD products a head and chunk) are ~32
// GFLOP, ~0.03 ms on the tensor cores.  Bytes bound it.
//
// What this design does about it: the simple correct first kernel.  All
// products run on the CUDA cores in fp32 from shared memory, each walk
// block recomputes the group's dB / dC intra-chunk sums for its own head
// and slice (80 x 2 times at G = 1), and the partials (2 x B L NH
// n_slices DS floats, ~670 MB at the training shape) go through device
// memory: it is far from the bound.  The tensor-core form (mma.sync as
// the forward, dCB summed over the group before its products) is later
// work.  PERF.md holds its times.
//
// Shared memory of the walk block at Q = 128, DS = 128: the lower bands
// of C . B^T and dCB, x and dy of the slice, B and C tiles, H's tile, dH,
// and the per-row vectors: 161,920 bytes (DS 256: 178,304), one block an
// SM.  Rows are padded by one float so column walks fall on distinct
// banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kP = 32;                       // HD columns of a walk block
constexpr int kHalf = kP / 2;                // a thread's half of them
constexpr int kKT = 32;                      // DS columns of a tile
constexpr int kMaxChunk = 128;
constexpr int kMaxDs = 256;
constexpr size_t kMaxSmem = 232448;          // 227 KB per block

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

struct Dims {
  int batch, len, nh, hd, ds, groups, hpg;
  int chunk, nc, nslice, nkt;                // nkt: DS tiles of kKT
  long long x_rs, b_rs, c_rs;                // element stride of a (b, t) row
};

Dims make_dims(int batch, int len, int nh, int hd, int ds, int groups,
               int chunk, int x_rs, int b_rs, int c_rs) {
  const int q = chunk < len ? chunk : len;
  return Dims{batch, len, nh, hd, ds, groups, nh / groups, q,
              (len + q - 1) / q, (hd + kP - 1) / kP, (ds + kKT - 1) / kKT,
              x_rs, b_rs, c_rs};
}

// element (t, s), s <= t, of a lower band stored row after row
__host__ __device__ __forceinline__ int band(int t, int s) {
  return t * (t + 1) / 2 + s;
}

// the workspace, in floats: C . B^T (B, n_chunks, G, Q, Q); the dB and
// dC partials (B, L, NH n_slices, DS) each; the d dt partials (B, L, NH,
// n_slices); the da partials (NH, B, n_chunks, n_slices)
struct Work {
  float *cb, *pb, *pc, *pdt, *pda;
};
__host__ __device__ inline long long cb_floats(const Dims& d) {
  return static_cast<long long>(d.batch) * d.nc * d.groups * d.chunk *
         d.chunk;
}
__host__ __device__ inline long long part_floats(const Dims& d) {
  return static_cast<long long>(d.batch) * d.len * d.nh * d.nslice * d.ds;
}
Work carve(float* w, const Dims& d) {
  Work k;
  k.cb = w;
  k.pb = k.cb + cb_floats(d);
  k.pc = k.pb + part_floats(d);
  k.pdt = k.pc + part_floats(d);
  k.pda = k.pdt + static_cast<long long>(d.batch) * d.len * d.nh * d.nslice;
  return k;
}

// --- 1. C . B^T once per (batch row, chunk, group) ----------------------

constexpr size_t kCbSmem = sizeof(float) * 2 * kMaxChunk * (kKT + 1);

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);   // (Q, kKT + 1): C[t][k]
  float* bs = cs + kMaxChunk * (kKT + 1);           // (Q, kKT + 1): B[s][k]
  const int c = blockIdx.x / d.groups, g = blockIdx.x % d.groups;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = c * d.chunk, n = min(d.chunk, d.len - c0);
  const long long row0 = static_cast<long long>(b) * d.len + c0;
  const long long gcol = static_cast<long long>(g) * d.ds;
  // rows t = ty + 16 i, columns s = tx + 16 j
  float acc[8][8] = {};
  for (int k0 = 0; k0 < d.ds; k0 += kKT) {
    __syncthreads();
    for (int i = tid; i < n * kKT; i += kThreads) {
      const int r = i / kKT, k = i % kKT;
      const bool in = k0 + k < d.ds;
      cs[r * (kKT + 1) + k] =
          in ? to_f(cm[(row0 + r) * d.c_rs + gcol + k0 + k]) : 0.f;
      bs[r * (kKT + 1) + k] =
          in ? to_f(bm[(row0 + r) * d.b_rs + gcol + k0 + k]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kKT; ++k) {
      float cv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i, s = tx + 16 * i;
        cv[i] = t < n ? cs[t * (kKT + 1) + k] : 0.f;
        bv[i] = s < n ? bs[s * (kKT + 1) + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
  }
  float* out = cb + ((static_cast<long long>(b) * d.nc + c) * d.groups + g) *
                        d.chunk * d.chunk;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      if (t < n && s <= t) out[t * d.chunk + s] = acc[i][j];
    }
}

// --- 2. the reverse chunk walk of one (batch row, head, HD slice) -------

// shared floats of the walk block
__host__ __device__ inline size_t walk_floats(int q, int ds) {
  const int ldh = ((ds + kKT - 1) / kKT) * kKT;
  return static_cast<size_t>(kP) * ldh                  // dH
         + 2 * static_cast<size_t>(q) * (kP + 1)        // x, dy
         + static_cast<size_t>(q) * (q + 1)             // C.B^T, dCB bands
         + 2 * static_cast<size_t>(q) * (kKT + 1)       // B, C tiles
         + static_cast<size_t>(kP) * (kKT + 1)          // H tile
         + 13 * static_cast<size_t>(q)                  // per-row vectors
         + kThreads;                                    // the reduction
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_walk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const T* __restrict__ dy,
                const float* __restrict__ dstate,
                const float* __restrict__ states, T* __restrict__ dx,
                float* __restrict__ dh0, Work wk, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = d.chunk;
  const int ldh = d.nkt * kKT, ldx = kP + 1, ldt = kKT + 1;
  float* dhs = reinterpret_cast<float*>(smem_raw);  // (kP, ldh): dH[p][k]
  float* xs = dhs + kP * ldh;                        // (q, ldx): x[s][p]
  float* dys = xs + q * ldx;                         // (q, ldx): dy[t][p]
  float* cbs = dys + q * ldx;                        // band: C_t . B_s
  float* dcbs = cbs + q * (q + 1) / 2;               // band: dCB[t][s]
  float* bt = dcbs + q * (q + 1) / 2;                // (q, ldt): B[s][k]
  float* ct = bt + q * ldt;                          // (q, ldt): C[t][k]
  float* ht = ct + q * ldt;                          // (kP, ldt): H[p][k]
  float* dts = ht + kP * ldt;                        // dt
  float* las = dts + q;                              // la = dt a
  float* ecum = las + q;                             // exp(cum)
  float* esl = ecum + q;                             // exp(seg(last, s))
  float* ws = esl + q;                               // w
  float* ddte = ws + q;                              // d dt through M
  float* colsum = ddte + q;                          // dseg's column sums
  float* rsh = colsum + q;                           // (2, q): row sums
  float* dwh = rsh + 2 * q;                          // (2, q): x_s . dH B_s
  float* dch = dwh + 2 * q;                          // (2, q): dy_t . C_t H^T
  float* red = dch + 2 * q;                          // (kThreads)

  const int h = blockIdx.x / d.nslice, sl = blockIdx.x % d.nslice;
  const int p0 = sl * kP, b = blockIdx.y, tid = threadIdx.x;
  const int r = tid >> 1, hf = tid & 1;              // a row / column, half
  const int g = h / d.hpg;
  const float av = a[h];
  const long long gcol = static_cast<long long>(g) * d.ds;
  const long long xcol = static_cast<long long>(h) * d.hd + p0;
  const long long sbase = (static_cast<long long>(b) * d.nh + h) * d.hd;
  const int npart = d.nh * d.nslice, part = h * d.nslice + sl;

  for (int i = tid; i < kP * ldh; i += kThreads) {
    const int p = i / ldh, k = i % ldh;
    dhs[i] = (dstate != nullptr && p0 + p < d.hd && k < d.ds)
                 ? dstate[(sbase + p0 + p) * d.ds + k] : 0.f;
  }

  for (int c = d.nc - 1; c >= 0; --c) {
    const int c0 = c * q, n = min(q, d.len - c0);
    const long long row0 = static_cast<long long>(b) * d.len + c0;
    __syncthreads();                         // the last chunk's reads done
    if (tid < n) {
      const float v = dt[(row0 + tid) * d.nh + h];
      dts[tid] = v;
      las[tid] = v * av;
    }
    for (int i = tid; i < q * kP; i += kThreads) {
      const int t = i / kP, p = i % kP;
      const bool in = t < n && p0 + p < d.hd;
      xs[t * ldx + p] = in ? to_f(x[(row0 + t) * d.x_rs + xcol + p]) : 0.f;
      dys[t * ldx + p] =
          in ? to_f(dy[((row0 + t) * d.nh + h) * d.hd + p0 + p]) : 0.f;
    }
    const float* cbg = wk.cb + ((static_cast<long long>(b) * d.nc + c) *
                                    d.groups + g) * q * q;
    for (int i = tid; i < n * n; i += kThreads) {
      const int t = i / n, s = i % n;
      if (s <= t) cbs[band(t, s)] = cbg[t * q + s];
    }
    __syncthreads();
    // cum, in the forward's order, by the thread of the shortest column
    if (tid == kThreads - 1) {
      float cum = 0.f;
      for (int t = 0; t < n; ++t) {
        cum += las[t];
        ecum[t] = expf(cum);
      }
    }

    // down column s = r: seg by running sums, M's column times dy into
    // dx's intra term (this half's columns), G, dCB and the column's dseg
    float dxi[kHalf] = {};
    if (r < n) {
      const int s = r;
      const float dts_s = dts[s];
      float seg = 0.f, dte = 0.f, col = 0.f;
      for (int t = s; t < n; ++t) {
        if (t > s) seg += las[t];
        const float es = expf(seg);
        const float cbv = cbs[band(t, s)];
        float gd = 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p)
          gd = fmaf(dys[t * ldx + p], xs[s * ldx + p], gd);
        const float m = es * cbv * dts_s;
#pragma unroll
        for (int p = 0; p < kHalf; ++p)
          dxi[p] = fmaf(m, dys[t * ldx + kHalf * hf + p], dxi[p]);
        const float u = gd * es * cbv;
        dte += u;
        if (t > s) col = fmaf(u, dts_s, col);
        if (hf == 0) dcbs[band(t, s)] = gd * es * dts_s;
      }
      if (hf == 0) {
        esl[s] = expf(seg);
        ws[s] = expf(seg) * dts_s;
        ddte[s] = dte;
        colsum[s] = col;
      }
    }
    __syncthreads();
    // row t = r's dseg = dCB C.B^T over s < t, the row split at its middle
    if (r < n) {
      const int t = r, mid = t / 2;
      float sum = 0.f;
      for (int s = hf ? mid : 0; s < (hf ? t : mid); ++s)
        sum = fmaf(dcbs[band(t, s)], cbs[band(t, s)], sum);
      rsh[hf * q + t] = sum;
    }

    // the DS columns a tile at a time
    float dxa[kHalf] = {}, chv[kHalf] = {}, lastacc = 0.f;
    const float elast = ecum[n - 1];
    for (int kt = 0; kt < d.nkt; ++kt) {
      const int k0 = kt * kKT;
      __syncthreads();                       // the last tile's reads done
      for (int i = tid; i < q * kKT; i += kThreads) {
        const int t = i / kKT, k = i % kKT;
        const bool in = t < n && k0 + k < d.ds;
        bt[t * ldt + k] =
            in ? to_f(bm[(row0 + t) * d.b_rs + gcol + k0 + k]) : 0.f;
        ct[t * ldt + k] =
            in ? to_f(cm[(row0 + t) * d.c_rs + gcol + k0 + k]) : 0.f;
      }
      const float* hsrc = states + ((static_cast<long long>(b) * d.nh + h) *
                                        d.nc + c) * d.hd * d.ds;
      for (int i = tid; i < kP * kKT; i += kThreads) {
        const int p = i / kKT, k = i % kKT;
        ht[p * ldt + k] = (p0 + p < d.hd && k0 + k < d.ds)
                              ? hsrc[static_cast<long long>(p0 + p) * d.ds +
                                     k0 + k] : 0.f;
      }
      __syncthreads();
      if (r < n) {
        // dH B_s and C_t H^T over this tile, this half's columns
        for (int k = 0; k < kKT; ++k) {
          const float bv = bt[r * ldt + k], cv = ct[r * ldt + k];
#pragma unroll
          for (int p = 0; p < kHalf; ++p) {
            dxa[p] = fmaf(dhs[(kHalf * hf + p) * ldh + k0 + k], bv, dxa[p]);
            chv[p] = fmaf(ht[(kHalf * hf + p) * ldt + k], cv, chv[p]);
          }
        }
        // dC_t and dB_s (t = s = r) over this half of the tile's columns
        const float er = ecum[r], wr = ws[r];
        const int kk0 = kHalf * hf;
        float dcv[kHalf] = {}, dbv[kHalf] = {};
        for (int p = 0; p < kP; ++p) {
          const float yv = dys[r * ldx + p] * er, xv = xs[r * ldx + p] * wr;
#pragma unroll
          for (int kk = 0; kk < kHalf; ++kk) {
            dcv[kk] = fmaf(yv, ht[p * ldt + kk0 + kk], dcv[kk]);
            dbv[kk] = fmaf(xv, dhs[p * ldh + k0 + kk0 + kk], dbv[kk]);
          }
        }
        for (int s = 0; s <= r; ++s) {
          const float v = dcbs[band(r, s)];
#pragma unroll
          for (int kk = 0; kk < kHalf; ++kk)
            dcv[kk] = fmaf(v, bt[s * ldt + kk0 + kk], dcv[kk]);
        }
        for (int t = r; t < n; ++t) {
          const float v = dcbs[band(t, r)];
#pragma unroll
          for (int kk = 0; kk < kHalf; ++kk)
            dbv[kk] = fmaf(v, ct[t * ldt + kk0 + kk], dbv[kk]);
        }
        const long long o = ((row0 + r) * npart + part) * d.ds + k0 + kk0;
#pragma unroll
        for (int kk = 0; kk < kHalf; ++kk) {
          if (k0 + kk0 + kk < d.ds) {
            wk.pc[o + kk] = dcv[kk];
            wk.pb[o + kk] = dbv[kk];
          }
        }
      }
      for (int i = tid; i < kP * kKT; i += kThreads) {
        const int p = i / kKT, k = i % kKT;
        lastacc = fmaf(dhs[p * ldh + k0 + k], ht[p * ldt + k], lastacc);
      }
      __syncthreads();                       // every read of dH's tile done
      // dH <- e_last dH + sum_t e_t dy_t^T C_t over this tile
      for (int i = tid; i < kP * kKT; i += kThreads) {
        const int p = i / kKT, k = i % kKT;
        float v = elast * dhs[p * ldh + k0 + k];
        for (int t = 0; t < n; ++t)
          v = fmaf(ecum[t] * dys[t * ldx + p], ct[t * ldt + k], v);
        dhs[p * ldh + k0 + k] = v;
      }
    }

    // dx, and the slice's x_s . dH B_s and dy_t . C_t H^T by halves
    if (r < n) {
      const float wr = ws[r];
      float dw = 0.f, dc = 0.f;
      T* out = dx + ((row0 + r) * d.nh + h) * d.hd + p0 + kHalf * hf;
#pragma unroll
      for (int p = 0; p < kHalf; ++p) {
        dw = fmaf(xs[r * ldx + kHalf * hf + p], dxa[p], dw);
        dc = fmaf(dys[r * ldx + kHalf * hf + p], chv[p], dc);
        if (p0 + kHalf * hf + p < d.hd)
          out[p] = from_f<T>(fmaf(wr, dxa[p], dxi[p]));
      }
      dwh[hf * q + r] = dw;
      dch[hf * q + r] = dc;
    }
    red[tid] = lastacc;
    __syncthreads();
    // dla by suffix sums, d dt and da: one thread, rows in a fixed order
    if (tid == 0) {
      float dlast = 0.f;
      for (int i = 0; i < kThreads; ++i) dlast += red[i];
      dlast *= elast;
      float wsum = 0.f;
      for (int t = 0; t < n - 1; ++t) wsum += (dwh[t] + dwh[q + t]) * ws[t];
      float dla = 0.f, da = 0.f;
      for (int t = n - 1; t >= 0; --t) {
        const float dw = dwh[t] + dwh[q + t];
        const float dsw = t < n - 1 ? dw * ws[t] : 0.f;
        float dd = ecum[t] * (dch[t] + dch[q + t]) + (rsh[t] + rsh[q + t]) -
                   (colsum[t] + dsw);
        if (t == n - 1) dd += dlast + wsum;
        dla += dd;
        wk.pdt[((row0 + t) * d.nh + h) * d.nslice + sl] =
            ddte[t] + dw * esl[t] + dla * av;
        da = fmaf(dla, dts[t], da);
      }
      wk.pda[((static_cast<long long>(h) * d.batch + b) * d.nc + c) *
                 d.nslice + sl] = da;
    }
  }
  __syncthreads();
  for (int i = tid; i < kP * d.ds; i += kThreads) {
    const int p = i / d.ds, k = i % d.ds;
    if (p0 + p < d.hd) dh0[(sbase + p0 + p) * d.ds + k] = dhs[p * ldh + k];
  }
}

// --- 3. the partials' sums, in a fixed order ----------------------------

// out[r, k] = sum_{j < J} in[r, j, k], for r < rows and k < K
template <typename TO>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ in, TO* __restrict__ out,
               long long rows, int nj, int nk) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= rows * nk) return;
  const long long rr = i / nk;
  const int k = static_cast<int>(i % nk);
  const float* src = in + rr * nj * nk + k;
  float sum = 0.f;
  for (int j = 0; j < nj; ++j) sum += src[static_cast<long long>(j) * nk];
  out[i] = from_f<TO>(sum);
}

template <typename TO>
cudaError_t sum_launch(const float* in, TO* out, long long rows, int nj,
                       int nk, cudaStream_t stream) {
  const long long n = rows * nk;
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ssd_bwd_sum_kernel<TO><<<blocks, kThreads, 0, stream>>>(in, out, rows, nj,
                                                          nk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t set_smem(const Dims& d, size_t& s2) {
  s2 = sizeof(float) * walk_floats(d.chunk, d.ds);
  if (s2 > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kCbSmem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_bwd_walk_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(s2));
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* dy, const void* dstate,
           const void* states, void* dx, void* ddt, void* da, void* dbm,
           void* dcm, void* dh0, void* work, const Dims& d,
           cudaStream_t stream) {
  size_t s2;
  cudaError_t err = set_smem<T>(d, s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Work wk = carve(static_cast<float*>(work), d);
  ssd_bwd_cb_kernel<T><<<dim3(d.nc * d.groups, d.batch), kThreads, kCbSmem,
                     stream>>>(static_cast<const T*>(bm),
                               static_cast<const T*>(cm), wk.cb, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_walk_kernel<T><<<dim3(d.nh * d.nslice, d.batch), kThreads, s2,
                       stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(dy),
      static_cast<const float*>(dstate), static_cast<const float*>(states),
      static_cast<T*>(dx), static_cast<float*>(dh0), wk, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(d.batch) * d.len;
  const int nj = d.hpg * d.nslice;
  err = sum_launch(wk.pb, static_cast<T*>(dbm), rows * d.groups, nj, d.ds,
                   stream);
  if (err == cudaSuccess)
    err = sum_launch(wk.pc, static_cast<T*>(dcm), rows * d.groups, nj, d.ds,
                     stream);
  if (err == cudaSuccess)
    err = sum_launch(wk.pdt, static_cast<float*>(ddt), rows * d.nh,
                     d.nslice, 1, stream);
  if (err == cudaSuccess)
    err = sum_launch(wk.pda, static_cast<float*>(da), d.nh,
                     d.batch * d.nc * d.nslice, 1, stream);
  return static_cast<int>(err);
}

template <typename T>
int info(const Dims& d, int* out) {
  size_t s2;
  cudaError_t err = set_smem<T>(d, s2);
  cudaFuncAttributes f1, f2, f3;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f1, ssd_bwd_cb_kernel<T>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f2, ssd_bwd_walk_kernel<T>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&f3, ssd_bwd_sum_kernel<T>);
  int per1 = 0, per2 = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per1, ssd_bwd_cb_kernel<T>, kThreads, kCbSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per2, ssd_bwd_walk_kernel<T>, kThreads, s2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[10] = {d.nc * d.groups * d.batch, static_cast<int>(kCbSmem),
                     f1.numRegs, per1, d.nh * d.nslice * d.batch,
                     static_cast<int>(s2), f2.numRegs, per2, f3.numRegs,
                     d.nslice};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

bool refused(int batch, int len, int nh, int hd, int ds, int groups,
             int chunk) {
  return batch <= 0 || len <= 0 || nh <= 0 || hd <= 0 || ds <= 0 ||
         ds > kMaxDs || groups <= 0 || nh % groups != 0 || chunk <= 0 ||
         chunk > kMaxChunk || batch > 65535;
}

}  // namespace

// x: (B, L, NH, HD) and bm, cm: (B, L, G, DS) in one dtype (0 = float32,
// 1 = bfloat16), each (b, t) row `*_rs` elements after the last and its
// inner dims contiguous; dy and dx: (B, L, NH, HD) in that dtype,
// contiguous; dt and ddt: (B, L, NH), a and da: (NH,), dstate (may be
// null: zeros) and dh0: (B, NH, HD, DS), states: (B, NH, n_chunks, HD,
// DS), all float32 and contiguous; dbm, dcm: (B, L, G, DS) in x's dtype,
// contiguous; work: a float32 workspace of B ceil(L / Q) G Q^2 + (2 DS +
// 1) B L NH n_slices + NH B ceil(L / Q) n_slices floats, Q = min(chunk,
// L), n_slices = ceil(HD / 32) (kernels/ssd_scan.py
// bwd_workspace_floats).  chunk: rows per chunk, 1..128, as the forward
// took it; DS at most 256.  Makes the six launches on `stream` and
// returns the first launch error (0 on success); never synchronises.
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
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<bf16>(x, dt, a, bm, cm, dy, dstate, states, dx, ddt, da,
                        dbm, dcm, dh0, work, d, s);
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, dy, dstate, states, dx, ddt, da,
                         dbm, dcm, dh0, work, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of one call: out[0..9] = the C . B^T kernel's blocks,
// dynamic shared bytes, registers a thread and blocks per SM, the same
// four of the walk kernel, the sum kernel's registers and the HD slices
// a head.  Returns a CUDA error code (0 on success).
extern "C" int ssd_scan_bwd_info(int batch, int len, int nh, int hd, int ds,
                                 int groups, int chunk, int dtype, int* out) {
  if (refused(batch, len, nh, hd, ds, groups, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(batch, len, nh, hd, ds, groups, chunk, 0, 0, 0);
  if (dtype == 1) return info<bf16>(d, out);
  if (dtype == 0) return info<float>(d, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
