// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _flash_fwd_impl).  It computes the same function:
// softmax(q k^T / sqrt(D)) v with the optional causal mask kpos <= qpos,
// as an online softmax (running max m, normaliser l, f32 accumulator)
// over K/V tiles, skipping the tiles above the diagonal, and it writes the
// per-row log-sum-exp m + log l in f32 beside the output.
//
// What bounds it on an H100.  At Llama-1B's training shape ([4, 4096, 16,
// 128], bf16, causal) the two products are 274.9 GFLOP over the 8.4 M causal
// (query, key) pairs of each of the 64 heads, against 269.5 MB of q, k, v,
// O and LSE each read or written once: 0.278 ms of tensor-core time at
// 989 TFLOP/s against 0.080 ms of memory time at 3.35 TB/s, so the
// operations set the bound.  Beside each score's 512 FLOPs of products at
// D=128 (256 at D=64) the softmax takes one exponential, and the SM's
// exponential rate is about 1/256 of its bf16 tensor rate: run in series,
// the exponentials alone would add about half the products' time at D=128,
// all of it at D=64.  At GPT-2's D=64 shapes the bytes set the bound, only
// just (25.8 GFLOP against 101.5 MB at [16, 1024, 12, 64]: 0.026 against
// 0.030 ms).  A causal prefill at B=1 is a chain: the block of a head's
// last query rows walks every K/V tile in turn, so there the kernel's time
// is that chain's latency, not either bound.
//
// What the design does about it (bf16).  A block owns 128 query rows over
// two consumer warpgroups of 64 rows each (the wgmma M) and one producer
// warpgroup (hopper.cuh's warp specialisation): one producer thread loads
// the block's Q once and each 64-key K and V tile into a ring (three
// stages at D=128, four at D=64) by TMA, 128-byte swizzled, behind full
// and empty mbarriers, so each K/V tile is loaded once for 128 query rows
// and runs ahead of the products.  setmaxnreg gives the consumers 240
// registers a thread (the producer 24), room for each consumer's Q rows as
// register A operands (S = Q K^T then reads only K from shared memory),
// its 64 x D f32 accumulator, one S tile and the bf16 P of one tile.  In
// each consumer the products of one tile overlap the softmax of the next:
// S of tile j is issued before O += P V of tile j - 1, and the softmax of
// tile j runs while that product is in flight; once it lands, the
// accumulator takes tile j's rescale and tile j's P is packed into the A
// fragments (packing them while the product runs made ptxas serialise
// every wgmma of the kernel, C7513).  At D=128 the two consumers take
// turns to issue their products (named barriers, "ping-pong"), so that one
// consumer's softmax runs beside the other's products rather than both at
// once; at D=64, where the products are half as long, they issue
// unordered.  P is the S accumulator rounded to bf16 (wgmma takes
// bf16 operands; the reference's Pallas kernel keeps P in f32), the A
// operand of O += P V straight from registers, with V read MN-major
// through the descriptor's transpose bit: nothing is gathered or
// transposed by a thread.  The causal and ragged masks apply only to the
// tiles that need them (the diagonal, keys past T), the softmax scale is
// folded into one FMA before ex2.approx, and a consumer whose rows the
// causal mask leaves nothing of a tile skips it but still releases its
// stage.  A consumer releases a stage once its P V product has read it
// (one arrival a warp): no block-wide barrier in the loop.  The grid
// launches heads in groups whose K and V fit in L2 together (about 16 MB),
// each head's heaviest query rows first, so that the blocks in flight
// share their K/V tiles through L2 and the longest chains start first.
// TMA zero-fills rows past T; those keys are masked.  Each consumer writes
// its O rows into its own rows of the Q tile, which only it read, and one
// thread stores them by TMA, which writes no row past T.
// What still keeps it from the bound: within a consumer the softmax waits
// for its own S product, so only the P V product and the other consumer
// hide it, and the rescale and packing run with no product of this
// consumer in flight; and with one block an SM, each block's start (Q and
// the first K/V tile) and end are hidden behind no other block's products.
//
// At D=192 and 256 (the reference's _use_pallas takes every D % 64 == 0 up
// to 256) the same kernel is instantiated with two changes.  A consumer's
// 64 x D accumulator is 96 or 128 registers a thread, so Q no longer fits
// beside it as register A operands: S = Q K^T reads both operands from
// shared memory (each consumer its own 64 rows of the Q tile).  And at
// D=256 the ring has two stages, since three and the Q tile would be
// 263 KB of shared memory.  O += P V is issued as products of 128 columns
// (and one of 64 at D=192), which keep one m64nD product's accumulator
// layout (hopper.cuh wgmma_rs_tb_wide).
//
// In f32 the kernel does its arithmetic on the CUDA cores (67 TFLOP/s),
// the simple version kept for f32 parity with the reference.
//
// Layout.  q, k and v are [B, T, H, D], read through their strides (last
// dimension contiguous; in bf16 16-byte-aligned pointers and strides in
// multiples of 8 elements, which TMA needs and the wrapper checks), so the
// q/k/v views that GPT-2 splits out of one fused qkv projection need no
// copy.  O is written contiguous [B, T, H, D] in the input type, LSE
// contiguous [B, H, T] in f32.  Any T >= 1, D in {64, 128, 192, 256}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 64;  // query rows of a warpgroup (the wgmma M in bf16), of an f32 block
constexpr int kBlockN = 64;  // keys of an f32 K/V tile

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16, warp-specialised: two consumer warpgroups of 64 query rows each and
// one producer warpgroup (hopper.cuh), so a block owns 128 query rows and
// each K/V tile is loaded once for all of them.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;      // one warpgroup
constexpr int kWsRows = 2 * kBlockM;  // query rows of a block
constexpr int kWsKeys = 64;           // keys of a K/V ring tile
constexpr long long kGroupBytes = 16ll << 20;  // K and V of the heads launched together

// Stages of the K/V ring: the producer runs this many tiles ahead.  A D=64
// tile is half the bytes and half the products of a D=128 one, so its
// loads need more tiles in flight to stay hidden (4 against 3 measured
// faster at every D=64 shape, `flash_bwd_ab.py`).  At D=256 three stages
// and the 128-row Q tile are 263 KB, over the 227 KB a block may hold:
// two stages (197 KB); D=192 keeps three (197 KB).
template <int D>
__host__ __device__ constexpr int ws_stages() {
  return D == 64 ? 4 : (D == 256 ? 2 : 3);
}
constexpr float kLog2e = 1.4426950408889634f;

struct FwdMaps {
  hopper::RowsMap q, k, v, o;  // o: bf16 only, written by TMA
};

__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023u) & ~1023u; }

template <int D>
constexpr size_t ws_smem_bytes() {
  // Q [128][D], then the ring's stages of (K, V) [kWsKeys][D], each D/64
  // swizzle-atom tiles; 1024 bytes of slack to align the first tile
  return 1024 + (D / 64) * kAtomRow * (kWsRows + ws_stages<D>() * 2 * kWsKeys);
}

// One S tile of a consumer's 64 rows x N keys, in place, to this tile's
// probabilities, with the online softmax's running max m (log2 units of the
// scaled scores), this lane's share of the row sums l, and alpha, the
// factor the accumulator takes for the new max.  The causal and ragged
// masks only where the tile needs them (`masked`, uniform across the
// warpgroup); the softmax scale is folded into one FMA before ex2.approx.
// A row's values sit in the 4 lanes of a quad.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int k0, int tq,
                                             const int (&row)[2], int T_len, int causal,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * tq + (i & 1);
      const int r = (i >> 1) & 1;
      if (!(key < T_len && (!causal || key <= row[r]))) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // every processed row has a key
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float e = fast_exp2(fmaf(s[i], scale_log2, neg_m[r]));  // 0 where masked
    s[i] = e;
    l[r] += e;
  }
}

// The probabilities rounded to bf16 pairs, the A fragments of O += P V
// (wgmma takes bf16 operands; the reference's Pallas kernel keeps P in f32)
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2], uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16_ws_kernel(const __grid_constant__ FwdMaps maps, float* __restrict__ lse, int BH,
                         int H, int T_len, int causal, float scale_log2, int group_heads) {
  constexpr int kAtoms = D / 64;
  constexpr int kWsStages = ws_stages<D>();
  // Q as register A operands of S = Q K^T up to D=128; above, a consumer's
  // 64 x D accumulator (96 or 128 registers a thread) leaves no room for
  // them, and S reads Q from shared memory too
  constexpr bool kQRegs = D <= 128;
  constexpr uint32_t kQAtom = kWsRows * kAtomRow;   // bytes of one 128-row Q atom tile
  constexpr uint32_t kKVAtom = kWsKeys * kAtomRow;  // bytes of one K or V atom tile
  constexpr uint32_t kStageBytes = 2 * kAtoms * kKVAtom;  // K, then V
  extern __shared__ unsigned char smem_raw[];
  // Q; then a full and an empty barrier per ring stage
  __shared__ alignas(8) uint64_t bars[1 + 2 * kWsStages];

  const uint32_t sQ = align1024(smem_u32(smem_raw));
  const uint32_t sRing = sQ + kAtoms * kQAtom;
  const uint32_t q_bar = smem_u32(&bars[0]);
  const uint64_t* full = bars + 1;
  const uint64_t* empty = bars + 1 + kWsStages;

  // Blocks launch in order of blockIdx.x: heads in groups of group_heads,
  // whose K and V fit in L2 together, and within a group each head's
  // heaviest query rows first, so that the blocks in flight share their K/V
  // tiles through L2 and the longest chains start first
  const int n_q = (T_len + kWsRows - 1) / kWsRows;
  const int grp = blockIdx.x / (group_heads * n_q);
  const int heads = min(group_heads, BH - grp * group_heads);
  const int r_grp = blockIdx.x - grp * group_heads * n_q;
  const int bh = grp * group_heads + r_grp % heads;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (n_q - 1 - r_grp / heads) * kWsRows;
  const int tid = threadIdx.x;
  const int kv_end = causal ? min(T_len, q0 + kWsRows) : T_len;
  const int n_tiles = (kv_end + kWsKeys - 1) / kWsKeys;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 2 * kMmaThreads) {
    // the producer warpgroup: one thread issues every load
    reg_dealloc<kProducerRegs>();
    if (tid == 2 * kMmaThreads) {
      mbar_expect_tx(q_bar, kAtoms * kQAtom);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        tma_load_rows(maps.q, sQ + a * kQAtom, q_bar, a * 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kWsStages;
        if (j >= kWsStages) mbar_wait(smem_u32(&empty[s]), (j / kWsStages - 1) & 1);
        const uint32_t stage = sRing + s * kStageBytes;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, kStageBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_rows(maps.k, stage + a * kKVAtom, bar, a * 64, h, j * kWsKeys, b);
          tma_load_rows(maps.v, stage + (kAtoms + a) * kKVAtom, bar, a * 64, h, j * kWsKeys, b);
        }
      }
      wait_released<kWsStages>(empty, n_tiles);
    }
    return;
  }

  // a consumer warpgroup: 64 query rows.  Its index and the values derived
  // from it are made warp-uniform to the compiler (a shuffle from lane 0),
  // so that the branches around the products are not divergent paths,
  // which would serialise the asynchronous products.
  reg_alloc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wg_q0 = q0 + wg * kBlockM;
  const int row[2] = {wg_q0 + warp * 16 + g, wg_q0 + warp * 16 + g + 8};
  // the key tiles this warpgroup's rows see (none when they all lie past T);
  // the block's last tile is empty for warpgroup 0 under the causal mask
  const int wg_tiles =
      wg_q0 >= T_len ? 0
                     : (causal ? (min(T_len, wg_q0 + kBlockM) + kWsKeys - 1) / kWsKeys : n_tiles);
  auto wait_full = [&](int j) {
    mbar_wait_spin(smem_u32(&full[j % kWsStages]), (j / kWsStages) & 1);
  };
  auto release = [&](int j) {  // one arrival a warp, once its products have read tile j
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[j % kWsStages]));
  };
  // the diagonal tile, and a tile with keys past T, need the masks
  auto masked = [&](int j) {
    return (j + 1) * kWsKeys > T_len || (causal && (j + 1) * kWsKeys - 1 > wg_q0);
  };

  // this warpgroup's Q rows as the A operand of S = Q K^T, in registers for
  // the whole loop up to D=128 (S then reads only the K tile from shared
  // memory), else read from its rows of the shared Q tile
  mbar_wait_spin(q_bar, 0);
  const uint32_t sQw = sQ + wg * kBlockM * kAtomRow;
  uint32_t aq[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) load_a_frags<D>(sQw, kQAtom, aq, warp, g, tq);
  // S = Q K^T of tile j, issued as one commit group
  auto issue_s = [&](int j, float (&sc)[kWsKeys / 2]) {
    const uint32_t sK = sRing + (j % kWsStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t desc_k = desc_sw128(sK + (kk / 4) * kKVAtom + (kk % 4) * 32, 16, 1024);
      if constexpr (kQRegs)
        wgmma_rs(sc, aq[kk], desc_k, kk > 0);
      else
        wgmma_ss(sc, desc_sw128(sQw + (kk / 4) * kQAtom + (kk % 4) * 32, 16, 1024), desc_k,
                 kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile j, issued as one commit group: V read MN-major through
  // the descriptor's transpose bit
  float acc[D / 2];  // O: this thread's share of the warpgroup's 64 x D accumulator
  auto issue_pv = [&](int j, const uint32_t (&p)[kWsKeys / 16][4]) {
    const uint32_t sV = sRing + (j % kWsStages) * kStageBytes + kAtoms * kKVAtom;
#pragma unroll
    for (int kk = 0; kk < kWsKeys / 16; ++kk)
      wgmma_rs_tb_wide<D>(acc, p[kk], sV + kk * 16 * kAtomRow, kKVAtom);
    wgmma_commit();
  };

#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  uint32_t pa[kWsKeys / 16][4];     // P of the last tile, the A operand of O += P V

  // n_tiles + 1 events, the same in both consumers: event e issues S of
  // tile e and O += P V of tile e - 1 where this consumer's rows see them.
  // From D=128 up the two consumers take turns to issue them (named
  // barriers 1 and 2, "ping-pong"), so one runs its softmax while the
  // other's products run; at D=64 they issue unordered, which measured
  // faster there (at D=192 and 256, whose products are longer still,
  // unordered was not measured).
  constexpr bool kPingPong = D >= 128;
  auto turn = [&]() {
    if constexpr (kPingPong) named_barrier_sync(1 + wg, 2 * kMmaThreads);
  };
  auto pass = [&]() {
    if constexpr (kPingPong) named_barrier_arrive(2 - wg, 2 * kMmaThreads);
  };
  if (wg == 1) pass();
  int e0 = 0;
  if (wg_tiles > 0) {
    {  // event 0: S of tile 0, then its softmax (the accumulator is still 0)
      wait_full(0);
      float sc[kWsKeys / 2], alpha[2];
      turn();
      wgmma_fence();
      issue_s(0, sc);
      pass();
      wgmma_wait<0>();
      fence_operand(sc);
      softmax_tile<kWsKeys>(sc, m, l, alpha, masked(0), 0, tq, row, T_len, causal, scale_log2);
      pack_p<kWsKeys>(sc, pa);
    }
    // S of tile j is issued before O += P V of tile j - 1, and the softmax
    // of tile j runs while that product is in flight.  P is packed into the
    // product's A fragments only once it has landed: a register operand
    // written while a product is in flight serialises every product of the
    // kernel (ptxas C7513).
    for (int j = 1; j < wg_tiles; ++j) {
      wait_full(j);
      float sc[kWsKeys / 2], alpha[2];
      fence_operand(acc);
      turn();
      wgmma_fence();
      issue_s(j, sc);
      issue_pv(j - 1, pa);
      pass();
      wgmma_wait<1>();  // S, while O += P V runs
      fence_operand(sc);
      softmax_tile<kWsKeys>(sc, m, l, alpha, masked(j), j * kWsKeys, tq, row, T_len, causal,
                            scale_log2);
      wgmma_wait<0>();
      fence_operand(acc);
      fence_operand(pa);
      release(j - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p<kWsKeys>(sc, pa);
    }
    // event wg_tiles: O += P V of the last tile these rows see
    if (wg_tiles < n_tiles) wait_full(wg_tiles);
    fence_operand(acc);
    turn();
    wgmma_fence();
    issue_pv(wg_tiles - 1, pa);
    pass();
    wgmma_wait<0>();
    fence_operand(acc);
    release(wg_tiles - 1);
    if (wg_tiles < n_tiles) release(wg_tiles);
    e0 = wg_tiles + 1;
  }
  for (int e = e0; e <= n_tiles; ++e) {  // tiles these rows do not see
    if (e < n_tiles) wait_full(e);
    turn();
    pass();
    if (e < n_tiles) release(e);
  }
  if (wg == 0) turn();  // consumer 1's last pass

  // O through shared memory: this warpgroup's 64 rows of the Q tiles, which
  // only it read, take O in the layout TMA reads (128-byte swizzled: chunk
  // c of row r at chunk c ^ (r % 8)), and one thread stores them by TMA in
  // whole 128-byte rows, writing no row at or past T
  const uint32_t sO = sQ + wg * kBlockM * kAtomRow;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / l[r];
    const uint32_t srow = sO + (warp * 16 + g + 8 * r) * kAtomRow + 4 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)  // columns 8n + 2tq, + 1: atom n / 8, chunk n % 8
      st_shared_32(srow + (n / 8) * kQAtom + (((n % 8) ^ g) << 4),
                   pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv));
    const int t = row[r];
    if (tq == 0 && t < T_len)
      lse[static_cast<long long>(bh) * T_len + t] = m[r] / kLog2e + logf(l[r]);
  }
  fence_proxy_async();
  named_barrier_sync(3 + wg, kMmaThreads);  // this warpgroup's rows are in place
  if ((tid & (kMmaThreads - 1)) == 0 && wg_q0 < T_len) {
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) tma_store_rows(maps.o, sO + a * kQAtom, a * 64, h, wg_q0, b);
    tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.  8 warps, each owning 8 query rows; lane j scores keys j
// and j + 32 of each K tile and owns output columns j + 32c.
// ---------------------------------------------------------------------------
constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kRowsPerWarp = kBlockM / kF32Warps;

template <int D>
constexpr size_t f32_smem_bytes() {
  // Q [M][D] (pre-scaled), K [N][D+1] (padded: lane j reads row j without
  // bank conflicts), V [N][D], P [M][N]
  return sizeof(float) * (kBlockM * D + kBlockN * (D + 1) + kBlockN * D + kBlockM * kBlockN);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int H, int T_len, int causal, float scale, long long q_sb, long long q_st,
                     long long q_sh, long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockM * D;
  float* Vs = Ks + kBlockN * (D + 1);
  float* Ps = Vs + kBlockN * D;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBlockM * D; i += kF32Threads) {
    const int r = i / D, d = i - (i / D) * D, t = q0 + r;
    Qs[i] = t < T_len ? qb[t * q_st + d] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(T_len, q0 + kBlockM) : T_len;
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's K/V are consumed (and Q is staged)
    for (int i = tid; i < kBlockN * D; i += kF32Threads) {
      const int r = i / D, d = i - (i / D) * D, t = k0 + r;
      const bool ok = t < T_len;
      Ks[r * (D + 1) + d] = ok ? kb[t * k_st + d] : 0.f;
      Vs[r * D + d] = ok ? vb[t * v_st + d] : 0.f;
    }
    __syncthreads();

    // s[r][c]: score of query row0+r against key k0 + lane + 32c
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = Ks + lane * (D + 1);
    const float* kc = Ks + (lane + 32) * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float a[4], c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = ka[d + e];
        c[e] = kc[d + e];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        s[r][0] += qv.x * a[0] + qv.y * a[1] + qv.z * a[2] + qv.w * a[3];
        s[r][1] += qv.x * c[0] + qv.y * c[1] + qv.z * c[2] + qv.w * c[3];
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row0 + r;
      bool valid[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        valid[c] = kpos < T_len && (!causal || kpos <= qpos);
        if (!valid[c]) s[r][c] = kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = valid[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = valid[1] ? expf(s[r][1] - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      Ps[(row0 + r) * kBlockN + lane] = p0;
      Ps[(row0 + r) * kBlockN + lane + 32] = p1;
    }
    __syncwarp();  // a warp reads back only the P rows it wrote

    // acc[r][c] += sum_j P[row0+r][j] * V[j][lane + 32c]
#pragma unroll 2
    for (int j = 0; j < kBlockN; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[e][c] = Vs[(j + e) * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + (row0 + r) * kBlockN + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] += p.x * vv[0][c] + p.y * vv[1][c] + p.z * vv[2][c] + p.w * vv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    if (t >= T_len) continue;
    const float inv = 1.f / l[r];
    float* orow = o + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[lane + 32 * c] = acc[r][c] * inv;
    if (lane == 0) lse[static_cast<long long>(bh) * T_len + t] = m[r] + logf(l[r]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                int T_len, int causal, float scale, const long long* st, cudaStream_t stream) {
  FwdMaps maps;
  cudaError_t err = hopper::make_rows_map(&maps.q, q, B, T_len, H, D, st[0], st[1], st[2], kWsRows);
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.k, k, B, T_len, H, D, st[3], st[4], st[5], kWsKeys);
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.v, v, B, T_len, H, D, st[6], st[7], st[8], kWsKeys);
  if (err == cudaSuccess)  // O contiguous [B, T, H, D]
    err = hopper::make_rows_map(&maps.o, o, B, T_len, H, D, 1ll * T_len * H * D, 1ll * H * D, D,
                                kBlockM);
  if (err == cudaSuccess) err = check_ws_registers<flash_fwd_bf16_ws_kernel<D>>();
  if (err == cudaSuccess)
    err = hopper::allow_smem<flash_fwd_bf16_ws_kernel<D>>(static_cast<int>(ws_smem_bytes<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  // heads a launch group: their K and V together about kGroupBytes
  const long long head_bytes = 4ll * T_len * D;
  const int group_heads =
      static_cast<int>(std::min<long long>(B * H, std::max(1ll, kGroupBytes / head_bytes)));
  const int n_blocks = B * H * ((T_len + kWsRows - 1) / kWsRows);
  flash_fwd_bf16_ws_kernel<D><<<n_blocks, kWsThreads, ws_smem_bytes<D>(), stream>>>(
      maps, static_cast<float*>(lse), B * H, H, T_len, causal, scale * kLog2e, group_heads);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int T_len, int causal, float scale, const long long* st, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  const cudaError_t err = hopper::allow_smem<flash_fwd_f32_kernel<D>>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, T_len, causal, scale, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, in the order
// (q batch, q time, q head, k batch, k time, k head, v batch, v time,
// v head).  Returns 0 or a cudaError_t code; the wrapper validates shapes,
// so an unsupported (dtype, D) pair is cudaErrorInvalidValue here.
extern "C" int ray_tpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int H, int T_len, int D, int dtype,
                                 int causal, float scale, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st,
                                 long long k_sh, long long v_sb, long long v_st,
                                 long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 0 && D == 192) return launch_f32<192>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 0 && D == 256) return launch_f32<256>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 1 && D == 192) return launch_bf16<192>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 1 && D == 256) return launch_bf16<256>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
