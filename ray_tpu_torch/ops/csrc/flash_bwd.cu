// Flash attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/pallas_attention.py's
// _flash_bwd_impl:
//   _dq_kernel  (B2): dQ = sum over keys of dS K
//   _dkv_kernel (B3): dV = sum over queries of P^T dO, dK = sum of dS^T Q
// with P = exp(q k^T * scale - LSE) recomputed tile by tile from the
// forward's row log-sum-exp (masked entries 0), dS = P * (dO V^T - Delta) *
// scale, and Delta = rowsum(dO * O) computed by the wrapper in torch, as the
// reference computes it in XLA outside its kernels.  Two kernels, not one
// with atomics, so that dQ is summed in a fixed order and every gradient is
// deterministic.
//
// What bounds it on an H100.  At GPT-2 small's training shape (B=16, T=1024,
// H=12, D=64, bf16, causal) B2 does three products over the 524,800 causal
// (query, key) pairs of each of the 192 heads, 38.7 GFLOP, against 127 MB of
// q, k, v, dO, LSE, Delta and dQ each read or written once: 39 us of tensor
// core time at 989 TFLOP/s and 38 us of memory time at 3.35 TB/s.  B3 does
// four products (S^T and dP^T are recomputed, then dV and dK), 51.6 GFLOP
// against 153 MB: 52 us against 46 us.  So the operations set both bounds.
//
// What the design does about it (bf16).  Each kernel runs one warpgroup per
// block, which owns 64 rows, the wgmma M: queries in B2, keys in B3.  The
// block's own two tiles (Q and dO in B2, K and V in B3) arrive once by TMA;
// the other side's tiles come through a two-stage ring of 128-byte-swizzled
// shared tiles behind mbarriers, issued by one thread, so tile i+1 is in
// flight while tile i is in the products and no thread spends registers or
// instructions on copies.  The two score products (S = Q K^T and
// dP = dO V^T in B2, their transposes in B3) are wgmma with both operands in
// shared memory, K-major as they land, issued together and committed once.
// Their accumulators, turned into P and dS in f32 and rounded to bf16, are
// the register A operands of the gradient products, whose B operand is read
// MN-major through the descriptor's transpose bit: nothing is gathered or
// transposed by a thread.  The grid launches the heaviest blocks first.
//   B2: K/V tiles of 64 keys walk up to the diagonal; dQ += dS K reads the
//       K tile that S used.  The block's LSE and Delta rows are loaded into
//       registers once.  At D=128 the 64-key tile stays: the dQ accumulator
//       takes 64 registers a thread and S and dP 32 each, fewer than B3's
//       128 + 32 there: ptxas (nvcc 12.9, sm_90a) gives B2 155 registers
//       at D=128 and 123 at D=64, with no spill.
//   B3: query tiles of 64 rows (32 at D=128, where the dK and dV
//       accumulators already take 128 registers a thread) walk from the
//       diagonal on; each tile's LSE and Delta ride its stage barrier by
//       4-byte cp.async, one float a thread, because a head's rows start at
//       (b*H + h) * T floats, which TMA cannot read from when T % 4 != 0.
// What still keeps them from the bound: within a block the score products,
// the elementwise step and the gradient products run in series, so the
// tensor cores wait on the CUDA cores unless another block on the SM has
// products to issue; each tile of the other side is loaded by every block
// that needs it; the gradients are written from registers.
//
// In f32 both kernels do their arithmetic on the CUDA cores (67 TFLOP/s),
// the simple version kept for f32 parity with the reference.
//
// Layout.  q, k, v and dO are [B, T, H, D], read through the strides the
// wrapper passes (last dimension contiguous; in bf16 16-byte-aligned
// pointers and strides in multiples of 8 elements, as the wrapper checks and
// TMA needs), so the q/k/v views of GPT-2's fused qkv projection need no
// copy.  LSE and Delta are contiguous [B, H, T] f32.  dQ, dK, dV are written
// contiguous [B, T, H, D] in the input type, each rounded once from its f32
// sum.  Any T >= 1: rows at or past T are loaded as zeros (by TMA in bf16),
// masked, and not written; D in {64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // the block's own rows: queries in dq, keys in dkv

struct Strides {  // in elements: batch, time, head of q, k, v and dO
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// bf16: tensor cores.  One warpgroup (4 warps) per block owns its 64 rows;
// thread 0 also issues the TMA loads.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;
constexpr int kStages = 2;     // tile i in the products, tile i+1 in flight
constexpr int kAtomRow = 128;  // bytes of one 64-column bf16 row: one swizzle atom
constexpr uint32_t kAtomTile = kTile * kAtomRow;  // bytes of one 64-row atom tile
constexpr float kLog2e = 1.4426950408889634f;

struct BwdMaps {
  RowsMap q, k, v, dout;
};

// ---------------------------------------------------------------------------
// bf16 dq: the block owns 64 queries.  Q and dO arrive once; K and V of
// each 64-key tile through the ring.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_bf16_smem() {
  // Q and dO, then kStages x (K, V), each D/64 atom tiles; 1024 bytes of
  // slack to align the first tile
  return 1024 + (D / 64) * kAtomTile * (2 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq, int H, int T_len,
                     int causal, float scale) {
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kStageBytes = 2 * kAtoms * kAtomTile;  // K, then V
  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bars[1 + kStages];  // Q and dO, then one per ring stage

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + kAtoms * kAtomTile;
  const uint32_t sRing = sdO + kAtoms * kAtomTile;
  const uint32_t q_bar = smem_u32(&bars[0]);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // the heaviest tiles launch first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kv_end = causal ? min(T_len, q0 + kTile) : T_len;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  // K and V of tile j into ring stage j % kStages
  auto issue_kv = [&](int j) {
    const uint32_t stage = sRing + (j % kStages) * kStageBytes;
    const uint32_t bar = smem_u32(&bars[1 + j % kStages]);
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_rows(maps.k, stage + a * kAtomTile, bar, a * 64, h, j * kTile, b);
      tma_load_rows(maps.v, stage + (kAtoms + a) * kAtomTile, bar, a * 64, h, j * kTile, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * kAtoms * kAtomTile);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_rows(maps.q, sQ + a * kAtomTile, q_bar, a * 64, h, q0, b);
      tma_load_rows(maps.dout, sdO + a * kAtomTile, q_bar, a * 64, h, q0, b);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) issue_kv(j);
  }

  // this thread's two rows' LSE (in log2 units) and Delta, for every tile
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < T_len;
    const long long at = static_cast<long long>(bh) * T_len + row[r];
    lse_r[r] = ok ? lse[at] * kLog2e : 0.f;
    delta_r[r] = ok ? delta[at] : 0.f;
  }

  float acc[D / 2];  // dQ: this thread's share of the warpgroup's 64 x D sum
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t sK = sRing + (j % kStages) * kStageBytes;
    const uint32_t sV = sK + kAtoms * kAtomTile;
    mbar_wait(smem_u32(&bars[1 + j % kStages]), (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T for the warpgroup's 64 queries x 64 keys:
    // A = Q or dO, B = the K or V tile, all K-major as they landed
    float s[kTile / 2], dp[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtomTile + (kk % 4) * 32;  // 16 bf16 within the atom
      wgmma_ss(s, desc_sw128(sQ + off, 16, 1024), desc_sw128(sK + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtomTile + (kk % 4) * 32;
      wgmma_ss(dp, desc_sw128(sdO + off, 16, 1024), desc_sw128(sV + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);
    fence_operand(dp);

    // P = exp(S scale - LSE) on the unmasked entries (a key past T was
    // loaded as zeros and scores 0, so it is masked too);
    // dS = P (dP - Delta) scale
    const int k0 = j * kTile;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      const int r = (i >> 1) & 1;
      const bool valid = key < T_len && (!causal || key <= row[r]);
      const float p = valid ? exp2f(s[i] * scale_log2 - lse_r[r]) : 0.f;
      s[i] = p * (dp[i] - delta_r[r]) * scale;
    }

    // dQ += dS K: dS (rounded to bf16) from registers, the same K tile read
    // MN-major through the descriptor's transpose bit
    uint32_t ads[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) ads[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    wgmma_fence();
    fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs_tb(acc, ads[kk], desc_sw128(sK + kk * 16 * kAtomRow, kAtomTile, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && j + kStages < n_tiles) issue_kv(j + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row[r];
    if (t >= T_len) continue;
    bf16* drow = dq + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dkv: the block owns 64 keys.  K and V arrive once; Q, dO, LSE and
// Delta of each query tile through the ring.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int dkv_q_rows() {
  // query rows per tile: at D=128 the dK and dV accumulators already take
  // 128 registers a thread, so S^T and dP^T get 16 each
  return D == 64 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr uint32_t dkv_stage_bytes() {
  // Q and dO tiles, then the tile's LSE and Delta, rounded up to keep the
  // next stage's tiles 1024-byte aligned
  return (2 * (D / 64) * dkv_q_rows<D>() * kAtomRow + 2 * dkv_q_rows<D>() * 4 + 1023) / 1024 *
         1024;
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  return 1024 + 2 * (D / 64) * kTile * kAtomRow + kStages * dkv_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_bf16_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int T_len, int causal, float scale) {
  constexpr int kQ = dkv_q_rows<D>();
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kKAtom = kTile * kAtomRow;  // bytes of one K or V atom tile
  constexpr uint32_t kQAtom = kQ * kAtomRow;     // bytes of one Q or dO atom tile
  constexpr uint32_t kStage = dkv_stage_bytes<D>();
  constexpr uint32_t kStageTx = 2 * kAtoms * kQAtom;  // the TMA bytes of a stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bars[1 + kStages];  // K/V, then one per ring stage

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + kAtoms * kKAtom;
  const uint32_t sRing = sV + kAtoms * kKAtom;
  const uint32_t kv_bar = smem_u32(&bars[0]);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTile;  // the first key tiles see the most queries: they launch first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // causal: query q sees key k only for k <= q, so the loop starts at k0
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (T_len - q_begin + kQ - 1) / kQ;

  // Query tile i into ring stage i % kStages, called by every thread:
  // thread 0 sends Q and dO by TMA; the tile's LSE and Delta come by 4-byte
  // cp.async, one float a thread, because a head's rows start at
  // bh * T * 4 bytes, which TMA cannot read from unless T % 4 == 0.  Each
  // thread's arrival on the stage barrier waits for its own copy.
  const float* lse_b = lse + static_cast<long long>(bh) * T_len;
  const float* delta_b = delta + static_cast<long long>(bh) * T_len;
  auto issue_q = [&](int i) {
    const uint32_t stage = sRing + (i % kStages) * kStage;
    const uint32_t bar = smem_u32(&bars[1 + i % kStages]);
    const int q0 = q_begin + i * kQ;
    if (tid == 0) {
      mbar_expect_tx(bar, kStageTx);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_rows(maps.q, stage + a * kQAtom, bar, a * 64, h, q0, b);
        tma_load_rows(maps.dout, stage + (kAtoms + a) * kQAtom, bar, a * 64, h, q0, b);
      }
    }
    if (tid < 2 * kQ) {  // LSE then Delta; zeros past T (those queries are masked)
      const int qi = tid < kQ ? tid : tid - kQ;
      const float* src = (tid < kQ ? lse_b : delta_b) + q0 + qi;
      cp_async_4(stage + 2 * kAtoms * kQAtom + tid * 4, src, q0 + qi < T_len);
    }
    cp_async_arrive(bar);
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 1; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]), 1 + kMmaThreads);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * kAtoms * kKAtom);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_rows(maps.k, sK + a * kKAtom, kv_bar, a * 64, h, k0, b);
      tma_load_rows(maps.v, sV + a * kKAtom, kv_bar, a * 64, h, k0, b);
    }
  }
  for (int i = 0; i < kStages && i < n_tiles; ++i) issue_q(i);

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t stage = sRing + (it % kStages) * kStage;
    const uint32_t sQ = stage;
    const uint32_t sdO = stage + kAtoms * kQAtom;
    const float* lse_s = reinterpret_cast<const float*>(
        smem_raw + (stage + 2 * kAtoms * kQAtom - raw));
    const float* delta_s = lse_s + kQ;
    const int q0 = q_begin + it * kQ;
    mbar_wait(smem_u32(&bars[1 + it % kStages]), (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys x kQ
    // queries: A = K or V, B = Q or dO, all K-major as they landed
    float sT[kQ / 2], dpT[kQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 bf16 within the atom
      wgmma_ss(sT, desc_sw128(sK + (kk / 4) * kKAtom + off, 16, 1024),
               desc_sw128(sQ + (kk / 4) * kQAtom + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(dpT, desc_sw128(sV + (kk / 4) * kKAtom + off, 16, 1024),
               desc_sw128(sdO + (kk / 4) * kQAtom + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sT);
    fence_operand(dpT);

    // P^T = exp(S^T scale - LSE) on the unmasked entries and
    // dS^T = P^T (dP^T - Delta) scale; LSE and Delta index the columns
#pragma unroll
    for (int i = 0; i < kQ / 2; ++i) {
      const int qi = (i / 4) * 8 + 2 * t4 + (i & 1);
      const int query = q0 + qi;
      const int kpos = key[(i >> 1) & 1];
      const bool valid = query < T_len && kpos < T_len && (!causal || kpos <= query);
      const float p = valid ? exp2f(sT[i] * scale_log2 - lse_s[qi] * kLog2e) : 0.f;
      dpT[i] = p * (dpT[i] - delta_s[qi]) * scale;
      sT[i] = p;
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T (rounded to bf16) from
    // registers, dO and Q read MN-major through the descriptor's transpose bit
    uint32_t ap[kQ / 16][4], ads[kQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ap[kk][e] = pack_bf16(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1]);
        ads[kk][e] = pack_bf16(dpT[8 * kk + 2 * e], dpT[8 * kk + 2 * e + 1]);
      }
    wgmma_fence();
    fence_operand(dv_acc);
    fence_operand(dk_acc);
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      wgmma_rs_tb(dv_acc, ap[kk], desc_sw128(sdO + kk * 16 * kAtomRow, kQAtom, 1024));
      wgmma_rs_tb(dk_acc, ads[kk], desc_sw128(sQ + kk * 16 * kAtomRow, kQAtom, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dv_acc);
    fence_operand(dk_acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (it + kStages < n_tiles) issue_q(it + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key[r];
    if (t >= T_len) continue;
    const long long at = ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.  8 warps, each owning 8 rows of the block's tile; lane j
// takes columns j and j + 32 of each 64-wide score tile and output columns
// j + 32c.  Tiles a lane reads by row are padded to D + 1 floats.
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;
constexpr int kRowsPerWarp = 8;

// rows [t0, t0 + 64) of one head into a shared tile of row stride `ld`
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src, long long st,
                                              int t0, int T_len, int tid) {
  for (int i = tid; i < kTile * D; i += kF32Threads) {
    const int r = i / D, d = i - r * D, t = t0 + r;
    dst[r * ld + d] = t < T_len ? src[t * st + d] : 0.f;
  }
}

template <int D>
constexpr size_t dq_f32_smem() {
  // Q, dO [64][D]; dS [64][64]; K, V [64][D + 1]
  return sizeof(float) * (2 * kTile * D + kTile * kTile + 2 * kTile * (D + 1));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int H, int T_len, int causal, float scale,
                    Strides st) {
  constexpr int kCols = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + kTile * D;
  float* dSs = dOs + kTile * D;
  float* Ks = dSs + kTile * kTile;
  float* Vs = Ks + kTile * (D + 1);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * kRowsPerWarp;

  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  load_tile_f32<D>(Qs, D, q + b * st.q[0] + h * st.q[2], st.q[1], q0, T_len, tid);
  load_tile_f32<D>(dOs, D, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, T_len, tid);

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    const long long at = static_cast<long long>(bh) * T_len + t;
    lse_r[r] = t < T_len ? lse[at] : 0.f;
    delta_r[r] = t < T_len ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(T_len, q0 + kTile) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed (and Q, dO are staged)
    load_tile_f32<D>(Ks, D + 1, kb, st.k[1], k0, T_len, tid);
    load_tile_f32<D>(Vs, D + 1, vb, st.v[1], k0, T_len, tid);
    __syncthreads();

    // s[r][c], dp[r][c]: row row0 + r against key k0 + lane + 32c
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* ka = Ks + lane * (D + 1);
    const float* kc = Ks + (lane + 32) * (D + 1);
    const float* va = Vs + lane * (D + 1);
    const float* vc = Vs + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float a[4], c[4], x[4], y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = ka[d + e];
        c[e] = kc[d + e];
        x[e] = va[d + e];
        y[e] = vc[d + e];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + (row0 + r) * D + d);
        s[r][0] += qv.x * a[0] + qv.y * a[1] + qv.z * a[2] + qv.w * a[3];
        s[r][1] += qv.x * c[0] + qv.y * c[1] + qv.z * c[2] + qv.w * c[3];
        dp[r][0] += ov.x * x[0] + ov.y * x[1] + ov.z * x[2] + ov.w * x[3];
        dp[r][1] += ov.x * y[0] + ov.y * y[1] + ov.z * y[2] + ov.w * y[3];
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        const bool valid = kpos < T_len && (!causal || kpos <= qpos);
        const float p = valid ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        dSs[(row0 + r) * kTile + lane + 32 * c] = p * (dp[r][c] - delta_r[r]) * scale;
      }
    }
    __syncwarp();  // a warp reads back only the dS rows it wrote

    // acc[r][c] += sum_j dS[row0 + r][j] K[j][lane + 32c]
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][kCols];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kCols; ++c) kk[e][c] = Ks[(j + e) * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 ds = *reinterpret_cast<const float4*>(dSs + (row0 + r) * kTile + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] += ds.x * kk[0][c] + ds.y * kk[1][c] + ds.z * kk[2][c] + ds.w * kk[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    if (t >= T_len) continue;
    float* drow = dq + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) drow[lane + 32 * c] = acc[r][c];
  }
}

template <int D>
constexpr size_t dkv_f32_smem() {
  // K, V [64][D]; P, dS [64][64]; Q, dO [64][D + 1]; LSE, Delta [64]
  return sizeof(float) * (2 * kTile * D + 2 * kTile * kTile + 2 * kTile * (D + 1) + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int T_len,
                     int causal, float scale, Strides st) {
  constexpr int kCols = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kTile * D;
  float* Ps = Vs + kTile * D;
  float* dSs = Ps + kTile * kTile;
  float* Qs = dSs + kTile * kTile;
  float* dOs = Qs + kTile * (D + 1);
  float* lse_s = dOs + kTile * (D + 1);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * kRowsPerWarp;

  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lse_b = lse + static_cast<long long>(bh) * T_len;
  const float* delta_b = delta + static_cast<long long>(bh) * T_len;
  load_tile_f32<D>(Ks, D, k + b * st.k[0] + h * st.k[2], st.k[1], k0, T_len, tid);
  load_tile_f32<D>(Vs, D, v + b * st.v[0] + h * st.v[2], st.v[1], k0, T_len, tid);

  float dk_acc[kRowsPerWarp][kCols], dv_acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int q0 = causal ? k0 : 0; q0 < T_len; q0 += kTile) {
    __syncthreads();  // the previous Q/dO tile is consumed (and K, V are staged)
    load_tile_f32<D>(Qs, D + 1, qb, st.q[1], q0, T_len, tid);
    load_tile_f32<D>(dOs, D + 1, ob, st.o[1], q0, T_len, tid);
    for (int i = tid; i < kTile; i += kF32Threads) {
      const bool ok = q0 + i < T_len;
      lse_s[i] = ok ? lse_b[q0 + i] : 0.f;
      delta_s[i] = ok ? delta_b[q0 + i] : 0.f;
    }
    __syncthreads();

    // sT[r][c], dpT[r][c]: key row0 + r against query q0 + lane + 32c
    float sT[kRowsPerWarp][2], dpT[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sT[r][0] = sT[r][1] = dpT[r][0] = dpT[r][1] = 0.f;
    const float* qa = Qs + lane * (D + 1);
    const float* qc = Qs + (lane + 32) * (D + 1);
    const float* oa = dOs + lane * (D + 1);
    const float* oc = dOs + (lane + 32) * (D + 1);
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float a[4], c[4], x[4], y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = qa[d + e];
        c[e] = qc[d + e];
        x[e] = oa[d + e];
        y[e] = oc[d + e];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (row0 + r) * D + d);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + (row0 + r) * D + d);
        sT[r][0] += kv.x * a[0] + kv.y * a[1] + kv.z * a[2] + kv.w * a[3];
        sT[r][1] += kv.x * c[0] + kv.y * c[1] + kv.z * c[2] + kv.w * c[3];
        dpT[r][0] += vv.x * x[0] + vv.y * x[1] + vv.z * x[2] + vv.w * x[3];
        dpT[r][1] += vv.x * y[0] + vv.y * y[1] + vv.z * y[2] + vv.w * y[3];
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int kpos = k0 + row0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = lane + 32 * c;
        const int qpos = q0 + qi;
        const bool valid = qpos < T_len && kpos < T_len && (!causal || kpos <= qpos);
        const float p = valid ? expf(sT[r][c] * scale - lse_s[qi]) : 0.f;
        Ps[(row0 + r) * kTile + qi] = p;
        dSs[(row0 + r) * kTile + qi] = p * (dpT[r][c] - delta_s[qi]) * scale;
      }
    }
    __syncwarp();  // a warp reads back only the P and dS rows it wrote

    // dv[r][c] += sum_j P[row0 + r][j] dO[j][lane + 32c]; dk likewise with dS, Q
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float oo[4][kCols], qq[4][kCols];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          oo[e][c] = dOs[(j + e) * (D + 1) + lane + 32 * c];
          qq[e][c] = Qs[(j + e) * (D + 1) + lane + 32 * c];
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + (row0 + r) * kTile + j);
        const float4 ds = *reinterpret_cast<const float4*>(dSs + (row0 + r) * kTile + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[r][c] += p.x * oo[0][c] + p.y * oo[1][c] + p.z * oo[2][c] + p.w * oo[3][c];
          dk_acc[r][c] += ds.x * qq[0][c] + ds.y * qq[1][c] + ds.z * qq[2][c] + ds.w * qq[3][c];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = k0 + row0 + r;
    if (t >= T_len) continue;
    const long long at = ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + lane + 32 * c] = dk_acc[r][c];
      dv[at + lane + 32 * c] = dv_acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Call {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int BH, H, T_len, causal;
  float scale;
  Strides st;
  cudaStream_t stream;
};

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out(void* p) {
  return static_cast<T*>(p);
}

// the f32 kernels: one block per (64-row tile, b*h)
template <auto Kernel, typename... Args>
int launch(const Call& c, size_t smem, Args... args) {
  const cudaError_t err = allow_smem<Kernel>(static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.T_len + kTile - 1) / kTile, c.BH);
  Kernel<<<grid, kF32Threads, smem, c.stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 kernels' four tensor maps: Q and dO in boxes of q_rows rows, K
// and V in boxes of kv_rows
template <int D>
cudaError_t make_maps(BwdMaps* m, const Call& c, int q_rows, int kv_rows) {
  const int B = c.BH / c.H, T = c.T_len;
  const Strides& st = c.st;
  cudaError_t err = make_rows_map(&m->q, c.q, B, T, c.H, D, st.q[0], st.q[1], st.q[2], q_rows);
  if (err == cudaSuccess)
    err = make_rows_map(&m->dout, c.dout, B, T, c.H, D, st.o[0], st.o[1], st.o[2], q_rows);
  if (err == cudaSuccess)
    err = make_rows_map(&m->k, c.k, B, T, c.H, D, st.k[0], st.k[1], st.k[2], kv_rows);
  if (err == cudaSuccess)
    err = make_rows_map(&m->v, c.v, B, T, c.H, D, st.v[0], st.v[1], st.v[2], kv_rows);
  return err;
}

template <int D>
int dq_bf16(const Call& c) {
  BwdMaps maps;
  cudaError_t err = make_maps<D>(&maps, c, kTile, kTile);
  if (err == cudaSuccess)
    err = allow_smem<flash_dq_bf16_kernel<D>>(static_cast<int>(dq_bf16_smem<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (c.T_len + kTile - 1) / kTile);
  flash_dq_bf16_kernel<D><<<grid, kMmaThreads, dq_bf16_smem<D>(), c.stream>>>(
      maps, in<float>(c.lse), in<float>(c.delta), out<bf16>(c.out0), c.H, c.T_len, c.causal,
      c.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_bf16(const Call& c) {
  BwdMaps maps;
  cudaError_t err = make_maps<D>(&maps, c, dkv_q_rows<D>(), kTile);
  if (err == cudaSuccess)
    err = allow_smem<flash_dkv_bf16_kernel<D>>(static_cast<int>(dkv_bf16_smem<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (c.T_len + kTile - 1) / kTile);
  flash_dkv_bf16_kernel<D><<<grid, kMmaThreads, dkv_bf16_smem<D>(), c.stream>>>(
      maps, in<float>(c.lse), in<float>(c.delta), out<bf16>(c.out0), out<bf16>(c.out1), c.H,
      c.T_len, c.causal, c.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_f32(const Call& c) {
  return launch<flash_dq_f32_kernel<D>>(c, dq_f32_smem<D>(), in<float>(c.q), in<float>(c.k),
                                        in<float>(c.v), in<float>(c.dout), in<float>(c.lse),
                                        in<float>(c.delta), out<float>(c.out0), c.H, c.T_len,
                                        c.causal, c.scale, c.st);
}

template <int D>
int dkv_f32(const Call& c) {
  return launch<flash_dkv_f32_kernel<D>>(c, dkv_f32_smem<D>(), in<float>(c.q), in<float>(c.k),
                                         in<float>(c.v), in<float>(c.dout), in<float>(c.lse),
                                         in<float>(c.delta), out<float>(c.out0),
                                         out<float>(c.out1), c.H, c.T_len, c.causal, c.scale,
                                         c.st);
}

}  // namespace

// kernel: 0 = dq (out0 = dQ; out1 unused), 1 = dkv (out0 = dK, out1 = dV).
// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, time,
// head) of q, k, v, then dO.  Returns 0 or a cudaError_t code; the wrapper
// validates shapes, so an unsupported (kernel, dtype, D) is
// cudaErrorInvalidValue here.
extern "C" int ray_tpu_flash_bwd(int kernel, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta, void* out0,
                                 void* out1, int B, int H, int T_len, int D, int dtype, int causal,
                                 float scale, long long q_sb, long long q_st, long long q_sh,
                                 long long k_sb, long long k_st, long long k_sh, long long v_sb,
                                 long long v_st, long long v_sh, long long o_sb, long long o_st,
                                 long long o_sh, void* stream) {
  using Launcher = int (*)(const Call&);
  static const Launcher launchers[2][2][2] = {  // [kernel][dtype][D == 128]
      {{dq_f32<64>, dq_f32<128>}, {dq_bf16<64>, dq_bf16<128>}},
      {{dkv_f32<64>, dkv_f32<128>}, {dkv_bf16<64>, dkv_bf16<128>}},
  };
  if (kernel < 0 || kernel > 1 || dtype < 0 || dtype > 1 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{{q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, {o_sb, o_st, o_sh}};
  const Call c{q, k, v, dout, lse, delta, out0, out1, B * H, H, T_len, causal, scale, st,
               static_cast<cudaStream_t>(stream)};
  return launchers[kernel][dtype][D == 128](c);
}

extern "C" const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
