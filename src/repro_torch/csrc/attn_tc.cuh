// Hopper tensor-core primitives of the bf16 attention kernels: 16-byte
// cp.async copies into shared memory (and 4-byte ones, for the
// backward's per-vector log-sum-exp and delta) and 1-D bulk copies
// (ssd_scan.cu); for the prefill tiles (attn_tiles.cuh) and the bf16
// backward (flash_attn_bwd.cu) the shared-memory matrix descriptor of
// wgmma and wgmma.mma_async itself in the two forms they use —
// m64n64k16 with both operands in shared memory (S = Q.K^T, and the
// backward's S^T = K.Q^T and dP^T = V.dO^T) and m64nDk16 with A in
// registers (O += P.V, and the backward's dV += P^T.dO, dK += dS^T.Q,
// dQ += dS.K); for the decode walk (decode_attn.cuh) the warp-level
// ldmatrix and mma.sync m16n8k16; for the paged prefill's TMA-fed core
// (attn_tma.cuh) the tensor copies of the TMA into 128-byte-swizzled
// tiles, the mbarriers of its ring, the descriptor of a swizzled wgmma
// operand and the register hand-over between warpgroups (setmaxnreg).
// sm_90a only: wgmma and setmaxnreg do not exist on plain sm_90.
//
// Shared-memory operand layout.  Every operand tile is stored as 8 x 8
// "core matrices" of bf16, each 8 rows of 16 contiguous bytes (128 bytes
// in all), with no swizzle: element (r, c) of a tile whose rows hold C
// elements lies at byte ((r / 8) * (C / 8) + c / 8) * 128 + (r % 8) * 16
// + (c % 8) * 2.  A K or Q tile (rows = keys or query vectors, C = D) is
// the K-major operand of Q.K^T; a V tile stored the same way (rows =
// keys, C = D) is the MN-major (transposed) B operand of P.V, as the
// backward's dO and Q tiles are of dV and dK, and its K tile of dQ
// (one tile, two descriptors: K-major for S, MN-major for dQ).  This
// layout takes any D that is a multiple of 16, so widths 80 and 96 run
// through wgmma with no padding, and a cp.async of 16-byte chunk i of a
// tile lands at byte 16 * i, so the copies are free of bank conflicts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace attn {
namespace tc {

// --- cp.async -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 16 bytes global -> shared through L1 (.ca streams the attention
// tiles faster than .cg, which bypasses L1); with fill false the 16 bytes
// are zeroed and src is not read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
// the same through L2 only (.cg): for bytes read once, as the decode
// walk reads each cached key and value
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src,
                                              bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (.ca; .cg takes only 16); with fill false they
// are zeroed and src is not read
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- bulk copies ---------------------------------------------------------

// 1-D bulk copies (the TMA's copy of contiguous bytes, no tensor map):
// one instruction moves a whole row; the transaction count of an
// mbarrier in shared memory tells the block when every row has landed.
// An mbarrier whose phase completes after `count` arrivals (and the
// bytes they expect).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}
// arrive once, expecting `bytes` more to land in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity) : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from src to
// dst, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// arrive once, expecting no bytes (a consumer releasing a ring stage)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// --- tensor copies (TMA) -------------------------------------------------

// The box of a 3-D tensor map (a CUtensorMap in parameter space, passed
// __grid_constant__) at element coordinates (c0, c1, c2), innermost
// first, into shared memory at dst; its bytes are counted on bar.  The
// map's swizzle decides the layout in shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// --- warp specialisation ---------------------------------------------------

// Lower (dec) or raise (inc) the registers a thread of this warpgroup
// may hold; every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- wgmma --------------------------------------------------------------

// Descriptor of a no-swizzle operand at shared address `addr`: `lbo` is
// the byte step between core matrices along K, `sbo` along M or N (the
// PTX "leading" and "stride" byte offsets), for the K-major and the
// transposed (MN-major) operand alike.  So a Q or K tile of width D has
// lbo 128 and sbo 16 D as a K-major operand, and any such tile (V; the
// backward's dO, Q and K) lbo 16 D and sbo 128 as an MN-major one.
// Fields are in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// Descriptor of an operand the TMA wrote with the 128-byte swizzle: rows
// of 128 bytes (64 bf16), 16-byte chunk j of row r stored at chunk j ^ (r
// % 8), in 1024-byte atoms of 8 rows, each atom 1024-byte aligned.  As a
// K-major operand (Q, K: rows are vectors or keys, 64 columns of D a
// row) sbo is the step between 8-row atoms (1024) and lbo is unused (16);
// the k-th 16-column step starts 32 k bytes into the row, the swizzle
// applying to the address.  As an MN-major operand (V: rows are keys,
// 64 columns of D a row) sbo steps 8 keys (1024) and lbo steps the next
// 64 columns of N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return desc(addr, lbo, sbo) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers in place: the compiler may not move their
// reads or writes across it (around the asynchronous wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nN (fp32): thread t of the warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 and that + 8; register 4j + 2h + e is
// column 8j + 2 (t % 4) + e of the first (h = 0) or second (h = 1) row.
// The A-register fragment of m64k16 (bf16 pairs) has the same rows and
// columns 2 (t % 4) + {0, 1} and + 8, so a thread's S accumulator,
// rounded to bf16 pairs, is its P fragment with no exchange.

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 80] (+)= A[64 x 16] . B[16 x 80], A in registers, B in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void mma_rs_n80(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 96] (+)= A[64 x 16] . B[16 x 96], A in registers, B in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void mma_rs_n96(float (&d)[48],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers, B in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (N == 64) mma_rs_n64(d, a, db, acc);
  else if constexpr (N == 80) mma_rs_n80(d, a, db, acc);
  else if constexpr (N == 96) mma_rs_n96(d, a, db, acc);
  else {
    static_assert(N == 128, "head widths 64, 80, 96, 128");
    mma_rs_n128(d, a, db, acc);
  }
}

// --- mma.sync (warp level) ---------------------------------------------

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8; register i of every lane receives matrix
// i, lane t holding row t / 4, columns 2 (t % 4) and + 1 — or, with
// .trans, row 2 (t % 4) and + 1 of column t / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, fp32 accumulate.  With
// g = lane / 4 and t = lane % 4: a[0] holds A row g, columns 2t and + 1,
// a[1] row g + 8 there, a[2] and a[3] the same at columns + 8; b[0] holds
// B rows 2t and + 1 of column g, b[1] rows + 8; d[0], d[1] are D row g,
// columns 2t and + 1, d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace tc
}  // namespace attn
