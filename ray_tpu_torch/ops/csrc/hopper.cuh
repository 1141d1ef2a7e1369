// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): TMA tile loads behind mbarriers, the
// shared-memory matrix descriptor of wgmma, and the wgmma products
// themselves, the pieces of a warp-specialised block (register hand-over,
// the producer's last wait, the launch-time register check), plus the host
// code that encodes the TMA tensor maps.
//
// Tiles.  A [B, T, H, D] bf16 tensor is read in boxes of `rows` x 64
// columns of one (b, h): a 64-column bf16 row is 128 bytes, exactly one
// 128-byte swizzle atom, so D=64 is one box and D=128 two, each landing
// as its own [rows][64] tile, 128-byte swizzled, at a 1024-byte-aligned
// shared address.  TMA fills rows at or past T with zeros; the kernels
// mask those keys themselves, since a zero key scores 0, not -inf.
//
// wgmma fragments.  The f32 accumulator of wgmma m64nNk16 holds, in warp w
// of the warpgroup, rows 16w..16w+15; lane (g = lane / 4, t = lane % 4)
// holds, for each 8-column chunk j:
//   d[4j], d[4j+1]     = (row g,     cols 8j + 2t, 8j + 2t + 1)
//   d[4j+2], d[4j+3]   = (row g + 8, cols 8j + 2t, 8j + 2t + 1)
// A register A operand (16 rows x 16 k per warp) wants
//   a[0] = (row g, k 2t, 2t+1)      a[1] = (row g + 8, k 2t, 2t+1)
//   a[2] = (row g, k 2t+8, 2t+9)    a[3] = (row g + 8, k 2t+8, 2t+9)
// so chunks 2k and 2k+1 of an accumulator, packed two floats to a bf16
// pair in order (a[e] = pack_bf16(d[8k + 2e], d[8k + 2e + 1])), are the A
// operand of k-step k of the next product: nothing moves between threads.
//
// Descriptors (128-byte swizzle; addresses, LBO and SBO in bytes):
//   K-major tile [rows][64] (the contiguous dimension is the product's K):
//     SBO = 1024 (8 rows of 128 bytes), LBO unused; k-step kk of 16 adds
//     32 bytes within the atom.
//   MN-major tile [k rows][64] (contiguous along N; the transpose bit):
//     SBO = 1024 (the next 8 k rows), LBO = the distance to the next
//     64-column atom of N; k-step kk adds 16 rows = 2048 bytes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver entry is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kAtomRow = 128;      // bytes of one 64-column bf16 row: one swizzle atom

// Warp specialisation: a block of two consumer warpgroups (threads 0..255,
// 64 rows each) and one producer warpgroup (256..383), one thread of which
// issues every TMA load into a ring whose stages the consumers release.
// setmaxnreg moves registers from the producer to the consumers.
constexpr int kWsThreads = 3 * 128;
constexpr int kConsumerWarps = 2 * 128 / 32;  // arrivals that release a ring stage
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// A [B, T, H, D] bf16 tensor as a TMA map of [rows x 64] boxes.  The three
// outer dimensions are ordered by stride; `order` says which is which.
struct RowsMap {
  CUtensorMap map;
  uint32_t order;  // 2 bits per map dimension 1..3: 0 = head, 1 = time, 2 = batch
};

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to a bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one plain arrival (a consumer warp releasing a ring stage)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a
// transfer that never completes (a bad tensor map) traps after some
// seconds instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 25)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait without the trap, for the consumer warpgroups of a warp-
// specialised kernel: a trap inside a setmaxnreg region makes ptxas keep
// the registers above the block's entry count through it (B3 at D=128
// spilled 276 bytes and serialised its products), so there the producer's
// trapping waits, which include a wait for the consumers' release of every
// stage it filled, stand in for a load that never lands
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The producer's last wait: the consumers' release of the last stages it
// filled (tiles max(0, n - Stages) .. n - 1, `empty` the stages' release
// barriers).  It returns once every tile is consumed; a consumer stuck on a
// load that never lands (they wait without a trap) makes it trap instead.
template <int Stages>
__device__ __forceinline__ void wait_released(const uint64_t* empty, int n_tiles) {
  for (int j = n_tiles > Stages ? n_tiles - Stages : 0; j < n_tiles; ++j)
    mbar_wait(smem_u32(&empty[j % Stages]), (j / Stages) & 1);
}

// 2^x, the MUFU instruction alone (exact to 2 ulp; no denormal fix-up,
// which exp2f adds: probabilities below 2^-126 are 0 to bf16 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int pick(uint32_t order, int dim, int h, int t, int b) {
  const uint32_t which = (order >> (2 * dim)) & 3u;
  return which == 0 ? h : (which == 1 ? t : b);
}

// rows [t, t + rows) x columns [col, col + 64) of head h of batch b into
// the shared tile at `dst`, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_rows(const RowsMap& m, uint32_t dst, uint32_t bar,
                                              int col, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(bar), "r"(col), "r"(pick(m.order, 0, h, t, b)),
      "r"(pick(m.order, 1, h, t, b)), "r"(pick(m.order, 2, h, t, b))
      : "memory");
}

// the shared tile at `src` (laid out as tma_load_rows lands one) to rows
// [t, t + rows) x columns [col, col + 64) of head h of batch b, by one
// thread; TMA writes no row at or past T.  Once issued, commit and wait
// with tma_store_wait before the tile's shared memory is reused or freed.
__device__ __forceinline__ void tma_store_rows(const RowsMap& m, uint32_t src, int col, int h,
                                               int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(&m.map)),
      "r"(src), "r"(col), "r"(pick(m.order, 0, h, t, b)), "r"(pick(m.order, 1, h, t, b)),
      "r"(pick(m.order, 2, h, t, b))
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// makes this thread's writes to shared memory visible to TMA (the async
// proxy), before the barrier after which one thread stores them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) on hardware barrier
// `id` (0 is __syncthreads')
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// an arrival on barrier `id` that does not wait for it
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// one float from global to shared memory, asynchronously; zero when !valid
// (nothing is read then)
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// 16 bytes of shared memory at a 16-byte-aligned shared address
__device__ __forceinline__ uint4 ld_shared_16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Warp specialisation: a warpgroup hands registers back to the SM's pool
// (the producer) or takes them from it (the consumers).  Every thread of
// the warpgroup executes it; the counts are multiples of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 64 rows of a K-major shared tile (128-byte swizzled, [rows][64] atoms
// `atom` bytes apart; `tile` at the warpgroup's first row, a multiple of 8
// rows into its atom) as the register A operands of D/16 k-steps: a[kk]
// holds rows warp*16 + g and + 8, columns 16 kk + 2 t4 (+1) and + 8 (+9),
// as the layout note above says
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t tile, uint32_t atom, uint32_t (&a)[D / 16][4],
                                             int warp, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + 8 * (e & 1);
      const int chunk = 2 * (kk % 4) + (e >> 1);
      const uint32_t addr = tile + (kk / 4) * atom + r * kAtomRow + ((chunk ^ g) << 4) + 4 * t4;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a[kk][e]) : "r"(addr) : "memory");
    }
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins an accumulator's registers around the asynchronous products, so
// the compiler neither reads them early nor moves their writes across
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for register A operands that an asynchronous product still reads
template <int M>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers, B from shared
// memory K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (accumulator layout,
// pack_a), B from shared memory MN-major (the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (accumulator layout,
// pack_a), B from shared memory MN-major (the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// host: tensor maps.  cuTensorMapEncodeTiled is a driver function; it is
// looked up through the runtime, so the libraries need no -lcuda.
// ---------------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// [rows x 64] boxes of a [B, T, H, D] bf16 tensor with element strides sb,
// st, sh (last dimension contiguous), 128-byte swizzled, zeros past T
inline cudaError_t make_rows_map(RowsMap* out, const void* base, int B, int T, int H, int D,
                                 long long sb, long long st, long long sh, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Dim {
    cuuint64_t size, stride;
    cuuint32_t box, which;
  };
  Dim dims[3] = {{static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(sh) * 2, 1, 0},
                 {static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(st) * 2,
                  static_cast<cuuint32_t>(rows), 1},
                 {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(sb) * 2, 1, 2}};
  for (int i = 1; i < 3; ++i)  // by stride, as a dense layout would have them
    for (int j = i; j > 0 && dims[j - 1].stride > dims[j].stride; --j) {
      const Dim tmp = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = tmp;
    }
  const cuuint64_t size[4] = {static_cast<cuuint64_t>(D), dims[0].size, dims[1].size,
                              dims[2].size};
  const cuuint64_t stride[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  const cuuint32_t box[4] = {64, dims[0].box, dims[1].box, dims[2].box};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  out->order = dims[0].which | dims[1].which << 2 | dims[2].which << 4;
  const CUresult r = encode(&out->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            size, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A warp-specialised kernel's setmaxnreg hands the producer's registers to
// the consumers: that needs the block to start with at least
// (128 x 24 + 256 x 240) / 384 = 168 registers a thread, which ptxas gives
// a kernel with setmaxnreg and launch bounds of (kWsThreads, 1).  Checked
// once, so that a build that allotted fewer fails the launch instead of
// stalling the consumers' setmaxnreg.inc forever.
template <auto Kernel>
inline cudaError_t check_ws_registers() {
  static const cudaError_t checked = [] {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, Kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs * kWsThreads >= 128 * (kProducerRegs + 2 * kConsumerRegs)
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  return checked;
}

// Lets Kernel take `bytes` of dynamic shared memory.  The attribute lasts as
// long as the device's context, so it is set once per device (on every
// call past the 64th device).
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  static std::atomic<unsigned long long> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace hopper
