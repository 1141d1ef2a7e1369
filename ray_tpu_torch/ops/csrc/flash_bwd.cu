// Flash attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/pallas_attention.py's
// _flash_bwd_impl:
//   _dq_kernel  (B2): dQ = sum over keys of dS K
//   _dkv_kernel (B3): dV = sum over queries of P^T dO, dK = sum of dS^T Q
// with P = exp(q k^T * scale - LSE) recomputed tile by tile from the
// forward's row log-sum-exp (masked entries 0) and dS = P * (dO V^T -
// Delta) * scale.  Delta = rowsum(dO * O), which the reference computes in
// XLA outside its kernels, is formed by B2 in its prologue from the block's
// O and dO rows and written to a [B, H, T] f32 buffer that B3 reads; a
// caller with its own Delta (ring attention's merged rows) hands it to B2
// instead.  Two kernels, not one with atomics, so that dQ is summed in a
// fixed order and every gradient is deterministic.
//
// What bounds it on an H100.  At GPT-2 small's training shape (B=16, T=1024,
// H=12, D=64, bf16, causal) B2 does three products over the 524,800 causal
// (query, key) pairs of each of the 192 heads, 38.7 GFLOP, against 127 MB of
// q, k, v, dO, LSE, Delta and dQ (146 MB with O) each read or written once:
// 39 us of tensor-core time at 989 TFLOP/s against 38 (44) us of memory
// time at 3.35 TB/s.  B3 does four products (S^T and dP^T are recomputed,
// then dV and dK), 51.6 GFLOP against 153 MB: 52 us against 46 us.  At
// Llama-1B's [4, 4096, 16, 128] the operations set both bounds by far: B2
// 412.4 GFLOP against 404.8 MB with O, 0.417 ms against 0.121 ms; B3 549.9
// GFLOP against 404.8 MB, 0.556 ms against 0.121 ms.
//
// What the design does about it (bf16).  Tiles of 64 rows (the wgmma M)
// arrive by TMA into 128-byte-swizzled shared tiles behind mbarriers.  The
// two score products (S = Q K^T and dP = dO V^T in B2, their transposes in
// B3) are wgmma issued together (committed once at D=64, as two groups at
// D=128).  Their accumulators, turned into P and dS in f32 and rounded to
// bf16, are the register A operands of the gradient products, whose B
// operand is read MN-major through the descriptor's transpose bit: nothing
// is gathered or transposed by a thread.  The grid launches the heaviest
// blocks first.  Delta: each quad of threads sums dO * O over its row from
// the two shared tiles (O arrives by TMA with Q and dO), keeps it in
// registers and writes it once.
//   D=64: one warpgroup per block owns 64 rows, queries in B2, keys in B3,
//       and its thread 0 issues the loads; the other side's tiles come
//       through a two-stage ring, so tile i+1 is in flight while tile i is
//       in the products; both score products read their operands from
//       shared memory.  B2 lands its O tile in ring stage 1 and loads that
//       stage's first K/V tile once Delta is formed, so Delta costs no
//       shared memory (ptxas, nvcc 12.9: B2 123 registers, B3 161).
//   D=128: the dK and dV accumulators of 64 keys take 128 registers a
//       thread, which left one warpgroup room for score tiles of 32 queries
//       only (m64n32 products, 35% of the bound).  So a block owns 128 rows
//       over two consumer warpgroups of 64 rows each and one producer
//       warpgroup, one thread of which issues every TMA load into a
//       three-stage ring and waits on the consumers' release of each stage.
//       setmaxnreg moves registers from the producer (24 a thread) to the
//       consumers (240), which is what makes room for 64-row score tiles
//       beside the accumulators: every product is m64n64 or m64n128, with no
//       spill (168 registers at entry).  Both consumers read each ring tile,
//       so each of the other side's tiles is loaded once per 128 rows, not
//       per 64.  B3: 128 keys a block (K and V 64 KB), 64-query tiles of Q,
//       dO and their LSE/Delta rows in the ring (33 KB a stage), 168 KB.  B2:
//       128 queries a block (Q, dO, O 96 KB), 64-key K/V tiles in the ring
//       (32 KB a stage), 193 KB; its consumers hold their Q and dO rows in
//       registers as the score products' A operands, so those read only K
//       and V from shared memory.  One block an SM.  The two score products
//       are committed as two groups, so P is formed from S while the dP
//       product still runs.  The CUDA-core step masks only the tiles that
//       need it (the diagonal, rows past T), takes 2^x from ex2.approx and
//       leaves the softmax scale out of dS, to multiply dQ and dK once at
//       the end; a consumer skips a tile that the causal mask empties for
//       its rows but still releases the stage.
// What still keeps them from the bound: within a warpgroup the score
// products, the CUDA-core step and the gradient products run mostly in
// series (only P's formation overlaps the dP product), and B3's score
// products, both operands in shared memory at N = 64, need about the SM's
// whole shared-memory rate (4 KB a 32-clock product): its products alone,
// with the CUDA-core step taken out, ran at 60% of the bound, and its K
// rows do not also fit in registers (a register A operand for S^T spilled).
// Ordering the two consumers' products by named barriers ("ping-pong") was
// measured and moved nothing, so they run unordered; the gradients are
// written from registers, not by TMA.
//
// In f32 both kernels do their arithmetic on the CUDA cores (67 TFLOP/s),
// the simple version kept for f32 parity with the reference; B2's prologue
// forms Delta there too.
//
// Layout.  q, k, v, dO and O are [B, T, H, D], read through the strides the
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

constexpr int kTile = 64;  // rows of a tile: the wgmma M

struct Strides {  // in elements: batch, time, head of q, k, v, dO and O
  long long q[3], k[3], v[3], dout[3], o[3];
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // one warpgroup
constexpr int kStages = 2;        // D=64: tile i in the products, tile i+1 in flight
constexpr uint32_t kAtomTile = kTile * kAtomRow;  // bytes of one 64-row atom tile
constexpr float kLog2e = 1.4426950408889634f;

// D=128: two consumer warpgroups, then the producer warpgroup (hopper.cuh)
constexpr int kWsRows = 2 * kTile;                     // the block's own rows
constexpr uint32_t kWsAtomTile = kWsRows * kAtomRow;   // bytes of one 128-row atom tile
constexpr int kWsStages = 3;

struct BwdMaps {
  RowsMap q, k, v, dout, o;
};

__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023u) & ~1023u; }

// rowsum(dO * O) of row r of two [rows][64]-column atom tiles of D/64 atoms
// each (128-byte swizzled, 1024-byte aligned, `atom` bytes apart), in f32,
// shared by the four threads of a quad: thread t4 sums 16-byte chunks 2 t4
// and 2 t4 + 1 of each atom row (chunk c of row r lies at chunk c ^ (r % 8)),
// and the quad's sums meet by shuffles.  Every lane of the warp calls it.
template <int D>
__device__ __forceinline__ float quad_row_dot(uint32_t sdO, uint32_t sO, uint32_t atom, int r,
                                              int t4) {
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const uint32_t off = a * atom + r * kAtomRow + (((2 * t4 + cc) ^ (r & 7)) << 4);
      const uint4 x = ld_shared_16(sdO + off), y = ld_shared_16(sO + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
        acc += u.x * w.x;
        acc += u.y * w.y;
      }
    }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// this thread's two rows' LSE (in log2 units) and Delta: Delta formed from
// the shared dO and O tiles (rows r_tile, r_tile + 8) and written to the
// [B, H, T] buffer when delta_out, else read from it
template <int D>
__device__ __forceinline__ void row_stats(const float* __restrict__ lse, float* __restrict__ delta,
                                          int delta_out, uint32_t sdO, uint32_t sO, uint32_t atom,
                                          int r_tile, int t4, int bh, int t_row, int T_len,
                                          float (&lse_r)[2], float (&delta_r)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t_row + 8 * r;
    const bool ok = t < T_len;
    const long long at = static_cast<long long>(bh) * T_len + t;
    lse_r[r] = ok ? lse[at] * kLog2e : 0.f;
    if (delta_out) {
      const float d = quad_row_dot<D>(sdO, sO, atom, r_tile + 8 * r, t4);  // 0 past T (zeros)
      delta_r[r] = d;
      if (ok && t4 == 0) delta[at] = d;
    } else {
      delta_r[r] = ok ? delta[at] : 0.f;
    }
  }
}

// The CUDA-core step of B2 on one 64 x 64 tile: P = exp(S scale - LSE) on
// the unmasked entries (a key past T was loaded as zeros and scores 0, so
// it is masked too), dS = P (dP - Delta) scale, rounded to bf16 pairs as
// the A operand of dQ += dS K.
__device__ __forceinline__ void dq_scores_to_ds(const float (&s)[kTile / 2],
                                                const float (&dp)[kTile / 2], uint32_t (&ads)[4][4],
                                                int k0, int t4, const int (&row)[2],
                                                const float (&lse_r)[2], const float (&delta_r)[2],
                                                int T_len, int causal, float scale,
                                                float scale_log2) {
  float ds[kTile / 2];
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    const int key = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
    const int r = (i >> 1) & 1;
    const bool valid = key < T_len && (!causal || key <= row[r]);
    const float p = valid ? exp2f(s[i] * scale_log2 - lse_r[r]) : 0.f;
    ds[i] = p * (dp[i] - delta_r[r]) * scale;
  }
  // dS rounded to bf16, the operand type wgmma takes; the reference's
  // Pallas kernel keeps dS in f32
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) ads[kk][e] = pack_bf16(ds[8 * kk + 2 * e], ds[8 * kk + 2 * e + 1]);
}

// ---------------------------------------------------------------------------
// bf16 dq at D=64: the block (one warpgroup) owns 64 queries.  Q, dO and,
// for Delta, O arrive once; K and V of each 64-key tile through the ring.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_bf16_smem() {
  // Q and dO, then kStages x (K, V), each D/64 atom tiles (O lands in
  // stage 1 before its first K/V tile); 1024 bytes of slack to align
  return 1024 + (D / 64) * kAtomTile * (2 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                     float* __restrict__ delta, int delta_out, bf16* __restrict__ dq, int H,
                     int T_len, int causal, float scale) {
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kStageBytes = 2 * kAtoms * kAtomTile;  // K, then V
  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bars[1 + kStages];  // Q, dO (and O), then one per ring stage

  const uint32_t sQ = align1024(smem_u32(smem_raw));
  const uint32_t sdO = sQ + kAtoms * kAtomTile;
  const uint32_t sRing = sdO + kAtoms * kAtomTile;
  const uint32_t sO = sRing + kStageBytes;  // ring stage 1, until Delta is formed
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
    mbar_expect_tx(q_bar, (delta_out ? 3 : 2) * kAtoms * kAtomTile);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_rows(maps.q, sQ + a * kAtomTile, q_bar, a * 64, h, q0, b);
      tma_load_rows(maps.dout, sdO + a * kAtomTile, q_bar, a * 64, h, q0, b);
      if (delta_out) tma_load_rows(maps.o, sO + a * kAtomTile, q_bar, a * 64, h, q0, b);
    }
    for (int j = 0; j < (delta_out ? 1 : kStages) && j < n_tiles; ++j) issue_kv(j);
  }

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
  mbar_wait(q_bar, 0);
  row_stats<D>(lse, delta, delta_out, sdO, sO, kAtomTile, warp * 16 + g, t4, bh, row[0], T_len,
               lse_r, delta_r);
  if (delta_out) {
    __syncthreads();  // every warp is done with O: stage 1 takes its first K/V tile
    if (tid == 0 && n_tiles > 1) issue_kv(1);
  }

  float acc[D / 2];  // dQ: this thread's share of the warpgroup's 64 x D sum
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

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

    uint32_t ads[kTile / 16][4];
    dq_scores_to_ds(s, dp, ads, j * kTile, t4, row, lse_r, delta_r, T_len, causal, scale,
                    scale_log2);

    // dQ += dS K: dS from registers, the same K tile read MN-major through
    // the descriptor's transpose bit
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

// The CUDA-core steps of the D=128 kernels, lean: the causal and ragged
// masks only where a tile needs them (`masked`, uniform across the
// warpgroup: the diagonal tiles and those past T), one LSE and one Delta
// load per column pair, 2^x by ex2.approx, and dS without the softmax
// scale, which multiplies the gradient once at the end instead of every
// entry.
//
// Each comes in two halves, so that P is formed from S while the dP
// product still runs (the two score products are committed as two groups).
//
// B2: S [64 queries x 64 keys] -> P in place, then with dP -> dS / scale
// as bf16 A fragments.
__device__ __forceinline__ void dq_p(float (&s)[kTile / 2], bool masked, int k0, int t4,
                                     const int (&row)[2], const float (&lse_r)[2], int T_len,
                                     int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = fast_exp2(s[i] * scale_log2 - lse_r[r]);
    if (masked) {
      const int key = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      p = key < T_len && (!causal || key <= row[r]) ? p : 0.f;
    }
    s[i] = p;
  }
}

__device__ __forceinline__ void dq_ds(const float (&p)[kTile / 2], const float (&dp)[kTile / 2],
                                      uint32_t (&ads)[4][4], const float (&delta_r)[2]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e;
      const float dl = delta_r[(i >> 1) & 1];  // entries i and i + 1 share a row
      ads[kk][e] = pack_bf16(p[i] * (dp[i] - dl), p[i + 1] * (dp[i + 1] - dl));
    }
}

// B3: S^T [64 keys x 64 queries] -> P^T in place and as bf16 A fragments,
// then with dP^T -> dS^T / scale as bf16 A fragments; LSE and Delta index
// the columns (queries q0 + 8 j + 2 t4 + h).
__device__ __forceinline__ void dkv_p(float (&sT)[kTile / 2], uint32_t (&ap)[4][4], bool masked,
                                      const float* lse_s, int q0, int t4, const int (&key)[2],
                                      int T_len, int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 8 * j + 2 * t4 + h;
      const float lse2 = lse_s[qi] * kLog2e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + h;
        float e = fast_exp2(sT[i] * scale_log2 - lse2);
        if (masked) {
          const int query = q0 + qi;
          e = query < T_len && key[r] < T_len && (!causal || key[r] <= query) ? e : 0.f;
        }
        sT[i] = e;
      }
    }
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) ap[kk][e] = pack_bf16(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void dkv_ds(const float (&pT)[kTile / 2], const float (&dpT)[kTile / 2],
                                       uint32_t (&ads)[4][4], const float* delta_s, int t4) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e;  // entries i and i + 1: one key, queries qi and qi + 1
      const int qi = 8 * (i / 4) + 2 * t4;
      ads[kk][e] = pack_bf16(pT[i] * (dpT[i] - delta_s[qi]),
                             pT[i + 1] * (dpT[i + 1] - delta_s[qi + 1]));
    }
}

// ---------------------------------------------------------------------------
// bf16 dq at D=128: the block owns 128 queries, 64 for each of two consumer
// warpgroups; the producer loads Q, dO and O once and each 64-key K/V tile
// into the ring, which both consumers read.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_ws_smem() {
  // Q, dO, O [128][D]; kWsStages x (K, V) [64][D]; 1024 bytes of slack
  return 1024 + (D / 64) * (3 * kWsAtomTile + kWsStages * 2 * kAtomTile);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_dq_bf16_ws_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                        float* __restrict__ delta, int delta_out, bf16* __restrict__ dq, int H,
                        int T_len, int causal, float scale) {
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kStageBytes = 2 * kAtoms * kAtomTile;  // K, then V
  extern __shared__ unsigned char smem_raw[];
  // Q, dO and O; then a full and an empty barrier per ring stage
  __shared__ alignas(8) uint64_t bars[1 + 2 * kWsStages];

  const uint32_t sQ = align1024(smem_u32(smem_raw));
  const uint32_t sdO = sQ + kAtoms * kWsAtomTile;
  const uint32_t sO = sdO + kAtoms * kWsAtomTile;
  const uint32_t sRing = sO + kAtoms * kWsAtomTile;
  const uint32_t q_bar = smem_u32(&bars[0]);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWsRows;  // the heaviest tiles launch first
  const int tid = threadIdx.x;
  const int kv_end = causal ? min(T_len, q0 + kWsRows) : T_len;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(smem_u32(&bars[1 + s]), 1);
      mbar_init(smem_u32(&bars[1 + kWsStages + s]), kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 2 * kMmaThreads) {
    // the producer warpgroup: one thread issues every load
    reg_dealloc<kProducerRegs>();
    if (tid == 2 * kMmaThreads) {
      mbar_expect_tx(q_bar, (delta_out ? 3 : 2) * kAtoms * kWsAtomTile);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_rows(maps.q, sQ + a * kWsAtomTile, q_bar, a * 64, h, q0, b);
        tma_load_rows(maps.dout, sdO + a * kWsAtomTile, q_bar, a * 64, h, q0, b);
        if (delta_out) tma_load_rows(maps.o, sO + a * kWsAtomTile, q_bar, a * 64, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kWsStages;
        if (j >= kWsStages) mbar_wait(smem_u32(&bars[1 + kWsStages + s]), (j / kWsStages - 1) & 1);
        const uint32_t stage = sRing + s * kStageBytes;
        const uint32_t bar = smem_u32(&bars[1 + s]);
        mbar_expect_tx(bar, kStageBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_rows(maps.k, stage + a * kAtomTile, bar, a * 64, h, j * kTile, b);
          tma_load_rows(maps.v, stage + (kAtoms + a) * kAtomTile, bar, a * 64, h, j * kTile, b);
        }
      }
      wait_released<kWsStages>(bars + 1 + kWsStages, n_tiles);
    }
  } else {
    // a consumer warpgroup: 64 queries
    reg_alloc<kConsumerRegs>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r_tile = wg * kTile + warp * 16 + g;  // this thread's first row in the block
    const int row[2] = {q0 + r_tile, q0 + r_tile + 8};
    const int wg_q0 = q0 + wg * kTile;
    // the key tiles this warpgroup's queries see (none past T)
    const int wg_tiles =
        wg_q0 >= T_len ? 0 : (causal ? (min(T_len, wg_q0 + kTile) + kTile - 1) / kTile : n_tiles);

    float lse_r[2], delta_r[2];
    mbar_wait_spin(q_bar, 0);
    row_stats<D>(lse, delta, delta_out, sdO, sO, kWsAtomTile, r_tile, t4, bh, row[0], T_len,
                 lse_r, delta_r);

    // this warpgroup's Q and dO rows as the score products' A operands, in
    // registers for the whole loop: only the K/V tiles are read from shared
    // memory per product, half of what two shared operands would take
    uint32_t aq[D / 16][4], ado[D / 16][4];
    load_a_frags<D>(sQ + wg * kAtomTile, kWsAtomTile, aq, warp, g, t4);
    load_a_frags<D>(sdO + wg * kAtomTile, kWsAtomTile, ado, warp, g, t4);

    float acc[D / 2];  // dQ: this thread's share of the warpgroup's 64 x D sum
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const float scale_log2 = scale * kLog2e;

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kWsStages;
      const uint32_t sK = sRing + s * kStageBytes;
      const uint32_t sV = sK + kAtoms * kAtomTile;
      mbar_wait_spin(smem_u32(&bars[1 + s]), (j / kWsStages) & 1);
      if (j < wg_tiles) {
        // S = Q K^T and dP = dO V^T for the warpgroup's 64 queries x 64 keys
        float sc[kTile / 2], dp[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_rs(sc, aq[kk], desc_sw128(sK + (kk / 4) * kAtomTile + (kk % 4) * 32, 16, 1024),
                   kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_rs(dp, ado[kk], desc_sw128(sV + (kk / 4) * kAtomTile + (kk % 4) * 32, 16, 1024),
                   kk > 0);
        wgmma_commit();

        // the diagonal tile, and tiles with keys or queries past T, need the masks
        const int k0 = j * kTile;
        const bool masked =
            k0 + kTile > T_len || wg_q0 + kTile > T_len || (causal && k0 + kTile - 1 > wg_q0);
        wgmma_wait<1>();  // S, while dP runs
        fence_operand(sc);
        dq_p(sc, masked, k0, t4, row, lse_r, T_len, causal, scale_log2);
        wgmma_wait<0>();
        fence_operand(dp);
        uint32_t ads[kTile / 16][4];
        dq_ds(sc, dp, ads, delta_r);

        // dQ += dS K, K read MN-major through the descriptor's transpose bit
        wgmma_fence();
        fence_operand(acc);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_rs_tb(acc, ads[kk], desc_sw128(sK + kk * 16 * kAtomRow, kAtomTile, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&bars[1 + kWsStages + s]));  // release the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row[r];
      if (t >= T_len) continue;
      bf16* drow = dq + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)  // the scale that dS left out
        *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) = __floats2bfloat162_rn(
            acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

// The CUDA-core step of B3 on one 64-key x 64-query tile, in place: P^T =
// exp(S^T scale - LSE) on the unmasked entries and dS^T = P^T (dP^T -
// Delta) scale, LSE and Delta indexing the columns, each rounded to bf16
// pairs as the A operands of dV += P^T dO and dK += dS^T Q (the
// reference's Pallas kernel keeps P and dS in f32).
__device__ __forceinline__ void dkv_scores(float (&sT)[kTile / 2],
                                           float (&dpT)[kTile / 2], uint32_t (&ap)[4][4],
                                           uint32_t (&ads)[4][4], const float* lse_s,
                                           const float* delta_s, int q0, int t4,
                                           const int (&key)[2], int T_len, int causal,
                                           float scale, float scale_log2) {
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) {
    const int qi = (i / 4) * 8 + 2 * t4 + (i & 1);
    const int query = q0 + qi;
    const int kpos = key[(i >> 1) & 1];
    const bool valid = query < T_len && kpos < T_len && (!causal || kpos <= query);
    const float p = valid ? exp2f(sT[i] * scale_log2 - lse_s[qi] * kLog2e) : 0.f;
    dpT[i] = p * (dpT[i] - delta_s[qi]) * scale;
    sT[i] = p;
  }
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ap[kk][e] = pack_bf16(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1]);
      ads[kk][e] = pack_bf16(dpT[8 * kk + 2 * e], dpT[8 * kk + 2 * e + 1]);
    }
}

// ---------------------------------------------------------------------------
// bf16 dkv at D=64: the block (one warpgroup) owns 64 keys.  K and V
// arrive once; Q, dO, LSE and Delta of each 64-query tile through the ring.
// ---------------------------------------------------------------------------
// Q and dO tiles, then the tile's LSE and Delta, rounded up to keep the
// next stage's tiles 1024-byte aligned
template <int D>
__host__ __device__ constexpr uint32_t dkv_stage_bytes() {
  return (2 * (D / 64) * kAtomTile + 2 * kTile * 4 + 1023) / 1024 * 1024;
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  return 1024 + 2 * (D / 64) * kAtomTile + kStages * dkv_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_bf16_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int T_len, int causal, float scale) {
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kStage = dkv_stage_bytes<D>();
  constexpr uint32_t kStageTx = 2 * kAtoms * kAtomTile;  // the TMA bytes of a stage
  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bars[1 + kStages];  // K/V, then one per ring stage

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = align1024(raw);
  const uint32_t sV = sK + kAtoms * kAtomTile;
  const uint32_t sRing = sV + kAtoms * kAtomTile;
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
  const int n_tiles = (T_len - q_begin + kTile - 1) / kTile;

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
    const int q0 = q_begin + i * kTile;
    if (tid == 0) {
      mbar_expect_tx(bar, kStageTx);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_rows(maps.q, stage + a * kAtomTile, bar, a * 64, h, q0, b);
        tma_load_rows(maps.dout, stage + (kAtoms + a) * kAtomTile, bar, a * 64, h, q0, b);
      }
    }
    // LSE then Delta; zeros past T (those queries are masked)
    const int qi = tid < kTile ? tid : tid - kTile;
    const float* src = (tid < kTile ? lse_b : delta_b) + q0 + qi;
    cp_async_4(stage + kStageTx + tid * 4, src, q0 + qi < T_len);
    cp_async_arrive(bar);
  };

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 1; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]), 1 + kMmaThreads);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * kAtoms * kAtomTile);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_rows(maps.k, sK + a * kAtomTile, kv_bar, a * 64, h, k0, b);
      tma_load_rows(maps.v, sV + a * kAtomTile, kv_bar, a * 64, h, k0, b);
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
    const uint32_t sdO = stage + kAtoms * kAtomTile;
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (stage + kStageTx - raw));
    mbar_wait(smem_u32(&bars[1 + it % kStages]), (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys x 64
    // queries: A = K or V, B = Q or dO, all K-major as they landed
    float sT[kTile / 2], dpT[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtomTile + (kk % 4) * 32;  // 16 bf16 within the atom
      wgmma_ss(sT, desc_sw128(sK + off, 16, 1024), desc_sw128(sQ + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtomTile + (kk % 4) * 32;
      wgmma_ss(dpT, desc_sw128(sV + off, 16, 1024), desc_sw128(sdO + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sT);
    fence_operand(dpT);

    uint32_t ap[kTile / 16][4], ads[kTile / 16][4];
    dkv_scores(sT, dpT, ap, ads, lse_s, lse_s + kTile, q_begin + it * kTile, t4, key, T_len,
               causal, scale, scale_log2);

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO and Q
    // read MN-major through the descriptor's transpose bit
    wgmma_fence();
    fence_operand(dv_acc);
    fence_operand(dk_acc);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wgmma_rs_tb(dv_acc, ap[kk], desc_sw128(sdO + kk * 16 * kAtomRow, kAtomTile, 1024));
      wgmma_rs_tb(dk_acc, ads[kk], desc_sw128(sQ + kk * 16 * kAtomRow, kAtomTile, 1024));
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
// bf16 dkv at D=128: the block owns 128 keys, 64 for each of two consumer
// warpgroups; the producer loads K and V once and each 64-query tile of Q,
// dO, LSE and Delta into the ring, which both consumers read.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_ws_smem() {
  // K, V [128][D], then kWsStages stages as D=64's
  return 1024 + 2 * (D / 64) * kWsAtomTile + kWsStages * dkv_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_dkv_bf16_ws_kernel(const __grid_constant__ BwdMaps maps, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int T_len, int causal, float scale) {
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kStage = dkv_stage_bytes<D>();
  constexpr uint32_t kStageTx = 2 * kAtoms * kAtomTile;  // the TMA bytes of a stage
  extern __shared__ unsigned char smem_raw[];
  // K/V; then a full and an empty barrier per ring stage
  __shared__ alignas(8) uint64_t bars[1 + 2 * kWsStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = align1024(raw);
  const uint32_t sV = sK + kAtoms * kWsAtomTile;
  const uint32_t sRing = sV + kAtoms * kWsAtomTile;
  const uint32_t kv_bar = smem_u32(&bars[0]);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kWsRows;  // the first key blocks see the most queries: first out
  const int tid = threadIdx.x;
  // causal: query q sees key k only for k <= q, so the loop starts at k0
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (T_len - q_begin + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kWsStages; ++s) {
      // the TMA thread's arrival and the producer warp's 32 cp.async arrivals
      mbar_init(smem_u32(&bars[1 + s]), 1 + 32);
      mbar_init(smem_u32(&bars[1 + kWsStages + s]), kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 2 * kMmaThreads) {
    // the producer warpgroup: its first warp loads; thread 0 of it sends
    // K, V, Q and dO by TMA, and its 32 lanes copy each tile's 64 LSE and 64
    // Delta floats by 4-byte cp.async (a head's rows start at bh * T * 4
    // bytes, which TMA cannot read from unless T % 4 == 0), each lane's
    // arrival on the stage barrier waiting for its own copies
    reg_dealloc<kProducerRegs>();
    const int lane = tid & 31;
    if (tid < 2 * kMmaThreads + 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * kAtoms * kWsAtomTile);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_rows(maps.k, sK + a * kWsAtomTile, kv_bar, a * 64, h, k0, b);
          tma_load_rows(maps.v, sV + a * kWsAtomTile, kv_bar, a * 64, h, k0, b);
        }
      }
      const float* lse_b = lse + static_cast<long long>(bh) * T_len;
      const float* delta_b = delta + static_cast<long long>(bh) * T_len;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWsStages;
        if (i >= kWsStages) mbar_wait(smem_u32(&bars[1 + kWsStages + s]), (i / kWsStages - 1) & 1);
        const uint32_t stage = sRing + s * kStage;
        const uint32_t bar = smem_u32(&bars[1 + s]);
        const int q0 = q_begin + i * kTile;
        if (lane == 0) {
          mbar_expect_tx(bar, kStageTx);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a) {
            tma_load_rows(maps.q, stage + a * kAtomTile, bar, a * 64, h, q0, b);
            tma_load_rows(maps.dout, stage + (kAtoms + a) * kAtomTile, bar, a * 64, h, q0, b);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // LSE then Delta; zeros past T (those queries are masked)
          const int idx = lane * 4 + e;
          const int qi = idx & (kTile - 1);
          const float* src = (idx < kTile ? lse_b : delta_b) + q0 + qi;
          cp_async_4(stage + kStageTx + idx * 4, src, q0 + qi < T_len);
        }
        cp_async_arrive(bar);
      }
      wait_released<kWsStages>(bars + 1 + kWsStages, n_tiles);
    }
  } else {
    // a consumer warpgroup: 64 keys
    reg_alloc<kConsumerRegs>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int wg_k0 = k0 + wg * kTile;
    const int key[2] = {wg_k0 + warp * 16 + g, wg_k0 + warp * 16 + g + 8};
    const uint32_t a_rows = wg * kAtomTile;  // this warpgroup's 64 rows of the 128-row K, V
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const float scale_log2 = scale * kLog2e;

    mbar_wait_spin(kv_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kWsStages;
      const uint32_t stage = sRing + s * kStage;
      const uint32_t sQ = stage;
      const uint32_t sdO = stage + kAtoms * kAtomTile;
      const float* lse_s = reinterpret_cast<const float*>(smem_raw + (stage + kStageTx - raw));
      const int q0 = q_begin + it * kTile;
      mbar_wait_spin(smem_u32(&bars[1 + s]), (it / kWsStages) & 1);
      // keys past T, or a tile whose queries all precede these keys, add nothing
      if (wg_k0 < T_len && (!causal || q0 + kTile - 1 >= wg_k0)) {
        // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys x 64 queries
        float sT[kTile / 2], dpT[kTile / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t a = desc_sw128(sK + (kk / 4) * kWsAtomTile + a_rows + (kk % 4) * 32,
                                        16, 1024);
          const uint64_t b = desc_sw128(sQ + (kk / 4) * kAtomTile + (kk % 4) * 32, 16, 1024);
          wgmma_ss(sT, a, b, kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint64_t a = desc_sw128(sV + (kk / 4) * kWsAtomTile + a_rows + (kk % 4) * 32,
                                        16, 1024);
          const uint64_t b = desc_sw128(sdO + (kk / 4) * kAtomTile + (kk % 4) * 32, 16, 1024);
          wgmma_ss(dpT, a, b, kk > 0);
        }
        wgmma_commit();

        // the diagonal tiles, and tiles with keys or queries past T, need the masks
        const bool masked = q0 + kTile > T_len || wg_k0 + kTile > T_len ||
                            (causal && wg_k0 + kTile - 1 > q0);
        wgmma_wait<1>();  // S^T, while dP^T runs
        fence_operand(sT);
        uint32_t ap[kTile / 16][4], ads[kTile / 16][4];
        dkv_p(sT, ap, masked, lse_s, q0, t4, key, T_len, causal, scale_log2);
        wgmma_wait<0>();
        fence_operand(dpT);
        dkv_ds(sT, dpT, ads, lse_s + kTile, t4);

        // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO and
        // Q read MN-major through the descriptor's transpose bit
        wgmma_fence();
        fence_operand(dv_acc);
        fence_operand(dk_acc);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          wgmma_rs_tb(dv_acc, ap[kk], desc_sw128(sdO + kk * 16 * kAtomRow, kAtomTile, 1024));
          wgmma_rs_tb(dk_acc, ads[kk], desc_sw128(sQ + kk * 16 * kAtomRow, kAtomTile, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dv_acc);
        fence_operand(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&bars[1 + kWsStages + s]));  // release the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = key[r];
      if (t >= T_len) continue;
      const long long at = ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8 + 2 * t4) = __floats2bfloat162_rn(
            dk_acc[4 * n + 2 * r] * scale, dk_acc[4 * n + 2 * r + 1] * scale);  // dS's scale
        *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
      }
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
                    const float* __restrict__ o, const float* __restrict__ lse,
                    float* __restrict__ delta, int delta_out, float* __restrict__ dq, int H,
                    int T_len, int causal, float scale, Strides st) {
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
  load_tile_f32<D>(dOs, D, dout + b * st.dout[0] + h * st.dout[2], st.dout[1], q0, T_len, tid);
  if (delta_out) __syncthreads();  // dO is staged for Delta
  const float* ob = delta_out ? o + b * st.o[0] + h * st.o[2] : nullptr;

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + row0 + r;
    const long long at = static_cast<long long>(bh) * T_len + t;
    lse_r[r] = t < T_len ? lse[at] : 0.f;
    if (delta_out) {  // Delta = rowsum(dO * O): lane j takes columns j + 32c
      float d = 0.f;
      if (t < T_len)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          d += dOs[(row0 + r) * D + lane + 32 * c] * ob[t * st.o[1] + lane + 32 * c];
      d = warp_sum(d);
      delta_r[r] = d;
      if (t < T_len && lane == 0) delta[at] = d;
    } else {
      delta_r[r] = t < T_len ? delta[at] : 0.f;
    }
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
  const float* ob = dout + b * st.dout[0] + h * st.dout[2];
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
    load_tile_f32<D>(dOs, D + 1, ob, st.dout[1], q0, T_len, tid);
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
  const void *q, *k, *v, *dout, *o, *lse;
  void* delta;  // written by dq when o is given, else read
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

// the bf16 kernels' tensor maps: Q, dO and O in boxes of q_rows rows, K and
// V in boxes of kv_rows (O only when dq forms Delta)
template <int D>
cudaError_t make_maps(BwdMaps* m, const Call& c, int q_rows, int kv_rows) {
  const int B = c.BH / c.H, T = c.T_len;
  const Strides& st = c.st;
  cudaError_t err = make_rows_map(&m->q, c.q, B, T, c.H, D, st.q[0], st.q[1], st.q[2], q_rows);
  if (err == cudaSuccess)
    err = make_rows_map(&m->dout, c.dout, B, T, c.H, D, st.dout[0], st.dout[1], st.dout[2],
                        q_rows);
  if (err == cudaSuccess)
    err = make_rows_map(&m->k, c.k, B, T, c.H, D, st.k[0], st.k[1], st.k[2], kv_rows);
  if (err == cudaSuccess)
    err = make_rows_map(&m->v, c.v, B, T, c.H, D, st.v[0], st.v[1], st.v[2], kv_rows);
  if (err == cudaSuccess && c.o != nullptr)
    err = make_rows_map(&m->o, c.o, B, T, c.H, D, st.o[0], st.o[1], st.o[2], q_rows);
  return err;
}

int dq_bf16_64(const Call& c) {
  BwdMaps maps;
  cudaError_t err = make_maps<64>(&maps, c, kTile, kTile);
  if (err == cudaSuccess)
    err = allow_smem<flash_dq_bf16_kernel<64>>(static_cast<int>(dq_bf16_smem<64>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (c.T_len + kTile - 1) / kTile);
  flash_dq_bf16_kernel<64><<<grid, kMmaThreads, dq_bf16_smem<64>(), c.stream>>>(
      maps, in<float>(c.lse), out<float>(c.delta), c.o != nullptr, out<bf16>(c.out0), c.H,
      c.T_len, c.causal, c.scale);
  return static_cast<int>(cudaGetLastError());
}

int dq_bf16_128(const Call& c) {
  BwdMaps maps;
  cudaError_t err = make_maps<128>(&maps, c, kWsRows, kTile);
  if (err == cudaSuccess) err = check_ws_registers<flash_dq_bf16_ws_kernel<128>>();
  if (err == cudaSuccess)
    err = allow_smem<flash_dq_bf16_ws_kernel<128>>(static_cast<int>(dq_ws_smem<128>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (c.T_len + kWsRows - 1) / kWsRows);
  flash_dq_bf16_ws_kernel<128><<<grid, kWsThreads, dq_ws_smem<128>(), c.stream>>>(
      maps, in<float>(c.lse), out<float>(c.delta), c.o != nullptr, out<bf16>(c.out0), c.H,
      c.T_len, c.causal, c.scale);
  return static_cast<int>(cudaGetLastError());
}

int dkv_bf16_64(const Call& c) {
  BwdMaps maps;
  cudaError_t err = make_maps<64>(&maps, c, kTile, kTile);
  if (err == cudaSuccess)
    err = allow_smem<flash_dkv_bf16_kernel<64>>(static_cast<int>(dkv_bf16_smem<64>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (c.T_len + kTile - 1) / kTile);
  flash_dkv_bf16_kernel<64><<<grid, kMmaThreads, dkv_bf16_smem<64>(), c.stream>>>(
      maps, in<float>(c.lse), in<float>(c.delta), out<bf16>(c.out0), out<bf16>(c.out1), c.H,
      c.T_len, c.causal, c.scale);
  return static_cast<int>(cudaGetLastError());
}

int dkv_bf16_128(const Call& c) {
  BwdMaps maps;
  cudaError_t err = make_maps<128>(&maps, c, kTile, kWsRows);
  if (err == cudaSuccess) err = check_ws_registers<flash_dkv_bf16_ws_kernel<128>>();
  if (err == cudaSuccess)
    err = allow_smem<flash_dkv_bf16_ws_kernel<128>>(static_cast<int>(dkv_ws_smem<128>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (c.T_len + kWsRows - 1) / kWsRows);
  flash_dkv_bf16_ws_kernel<128><<<grid, kWsThreads, dkv_ws_smem<128>(), c.stream>>>(
      maps, in<float>(c.lse), in<float>(c.delta), out<bf16>(c.out0), out<bf16>(c.out1), c.H,
      c.T_len, c.causal, c.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_f32(const Call& c) {
  return launch<flash_dq_f32_kernel<D>>(
      c, dq_f32_smem<D>(), in<float>(c.q), in<float>(c.k), in<float>(c.v), in<float>(c.dout),
      in<float>(c.o), in<float>(c.lse), out<float>(c.delta), c.o != nullptr, out<float>(c.out0),
      c.H, c.T_len, c.causal, c.scale, c.st);
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
// dtype: 0 = float32, 1 = bfloat16.  dq with `o` (the forward's output)
// forms Delta = rowsum(dO * O) and writes it to `delta`; dq without `o`,
// and dkv (which takes no `o`), read `delta`.  Strides are in elements,
// (batch, time, head) of q, k, v, dO, then O (unread without `o`).  Returns
// 0 or a cudaError_t code; the wrapper validates shapes, so an unsupported
// (kernel, dtype, D) or an `o` for dkv is cudaErrorInvalidValue here.
extern "C" int ray_tpu_flash_bwd(int kernel, const void* q, const void* k, const void* v,
                                 const void* dout, const void* o, const void* lse, void* delta,
                                 void* out0, void* out1, int B, int H, int T_len, int D, int dtype,
                                 int causal, float scale, long long q_sb, long long q_st,
                                 long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh, long long do_sb,
                                 long long do_st, long long do_sh, long long o_sb, long long o_st,
                                 long long o_sh, void* stream) {
  using Launcher = int (*)(const Call&);
  static const Launcher launchers[2][2][2] = {  // [kernel][dtype][D == 128]
      {{dq_f32<64>, dq_f32<128>}, {dq_bf16_64, dq_bf16_128}},
      {{dkv_f32<64>, dkv_f32<128>}, {dkv_bf16_64, dkv_bf16_128}},
  };
  if (kernel < 0 || kernel > 1 || dtype < 0 || dtype > 1 || (D != 64 && D != 128) ||
      (kernel == 1 && o != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{{q_sb, q_st, q_sh},
                   {k_sb, k_st, k_sh},
                   {v_sb, v_st, v_sh},
                   {do_sb, do_st, do_sh},
                   {o_sb, o_st, o_sh}};
  const Call c{q,     k, v,     dout,   o,        lse, delta, out0, out1, B * H, H, T_len, causal,
               scale, st, static_cast<cudaStream_t>(stream)};
  return launchers[kernel][dtype][D == 128](c);
}

extern "C" const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
