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
// B3 (bf16), designed for Hopper.  One warpgroup per block owns 64 keys, the
// wgmma M; its K and V tiles arrive once by TMA, and the Q and dO of each
// query tile through a two-stage ring of 128-byte-swizzled shared tiles
// behind mbarriers, issued by one thread, so tile i+1 is in flight while
// tile i is in the products.  The tile's LSE and Delta ride the same
// barrier by 4-byte cp.async, one float a thread: a head's rows start at
// (b*H + h) * T floats, which TMA cannot read from when T % 4 != 0.  S^T = K Q^T and dP^T = V dO^T
// are wgmma with both operands in shared memory, K-major as they land; their
// accumulators, turned into P^T and dS^T (rounded to bf16), are the register
// A operands of dV += P^T dO and dK += dS^T Q, whose B operands dO and Q
// are read MN-major through the descriptor's transpose bit: nothing is
// gathered or transposed by a thread.  The grid launches the first key
// tiles, which see the most queries, first.  What still keeps it from the
// bound: within a block the two product pairs and the elementwise step run
// in series, and each query tile is loaded by every key block that needs
// it (64 keys a block).
//
// B2 (bf16) is PR 2's simple version: mma.sync m16n8k16 fragments from
// padded shared tiles loaded synchronously, K gathered two bf16 at a time
// for dQ += dS K.  In f32 both kernels do their arithmetic on the CUDA cores
// (67 TFLOP/s), the simple version kept for f32 parity with the reference.
//
// Layout.  q, k, v and dO are [B, T, H, D], read through the strides the
// wrapper passes (last dimension contiguous; in bf16 16-byte-aligned
// pointers and strides in multiples of 8 elements, as the wrapper checks and
// TMA needs), so the q/k/v views of GPT-2's fused qkv projection need no
// copy.  LSE and Delta are contiguous [B, H, T] f32.  dQ, dK, dV are written
// contiguous [B, T, H, D] in the input type, each rounded once from its f32
// sum.
//
// Work split, in place of the TPU's sequential grid axis:
//   dq:  one block per (b*h, 64-row query tile); a loop walks the 64-key K/V
//        tiles up to the diagonal.
//   dkv: one block per (b*h, 64-key tile); a loop walks the query tiles from
//        the diagonal on: 64 rows at D=64, 32 at D=128, where the dK and dV
//        accumulators already take 128 registers a thread.
// Any T >= 1 works: rows at or past T are loaded as zeros (by TMA in dkv),
// masked, and not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // the block's own rows: queries in dq, keys in dkv

struct Strides {  // in elements: batch, time, head of q, k, v and dO
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// bf16: tensor cores.  4 warps, each owning 16 rows of the block's tile.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;

// rows [t0, t0 + kRows) of one head of a [B, T, H, D] tensor into a shared
// tile of row stride D + kPad, zeros at or past T
template <int D, int kRows>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long long st, int t0,
                                               int T_len, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int S = D + kPad;
  for (int c = tid; c < kRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c - r * kChunks) * 8, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len) val = *reinterpret_cast<const uint4*>(src + t * st + col);
    *reinterpret_cast<uint4*>(dst + r * S + col) = val;
  }
}

template <int D>
constexpr size_t dq_bf16_smem() {
  return sizeof(bf16) * 4 * kTile * (D + kPad);  // Q, dO, K, V
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int H, int T_len, int causal, float scale,
                     Strides st) {
  constexpr int S = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * S;
  bf16* Ks = dOs + kTile * S;
  bf16* Vs = Ks + kTile * S;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16;

  const bf16* kb = k + b * st.k[0] + h * st.k[2];
  const bf16* vb = v + b * st.v[0] + h * st.v[2];
  load_tile_bf16<D, kTile>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, T_len, tid);
  load_tile_bf16<D, kTile>(dOs, dout + b * st.o[0] + h * st.o[2], st.o[1], q0, T_len, tid);

  const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < T_len;
    const long long at = static_cast<long long>(bh) * T_len + row[i];
    lse_r[i] = ok ? lse[at] : 0.f;
    delta_r[i] = ok ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = causal ? min(T_len, q0 + kTile) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, kTile>(Ks, kb, st.k[1], k0, T_len, tid);
    load_tile_bf16<D, kTile>(Vs, vb, st.v[1], k0, T_len, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, Qs + wrow * S + kk * 16, S, g, t4);
      load_a(ado, dOs + wrow * S + kk * 16, S, g, t4);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const bf16* pk = Ks + (nt * 8 + g) * S + kk * 16 + 2 * t4;
        mma_bf16(s[nt], aq, ld32(pk), ld32(pk + 8));
        const bf16* pv = Vs + (nt * 8 + g) * S + kk * 16 + 2 * t4;
        mma_bf16(dp[nt], ado, ld32(pv), ld32(pv + 8));
      }
    }

    // P = exp(S * scale - LSE) on the unmasked entries; dS = P (dP - Delta) scale
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int i = e >> 1;
        const bool valid = key < T_len && (!causal || key <= row[i]);
        const float p = valid ? expf(s[nt][e] * scale - lse_r[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[i]) * scale;
      }

    // dQ += dS K: dS (rounded to bf16) is the A fragment; K is read
    // transposed, two keys of one column at a time
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* pk = Ks + (kk * 16 + 2 * t4) * S + n * 8 + g;
        mma_bf16(acc[n], a, ld_col2(pk, S), ld_col2(pk + 8 * S, S));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row[i];
    if (t >= T_len) continue;
    bf16* drow = dq + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dkv: one warpgroup per block owns 64 keys; thread 0 also issues the
// TMA loads.  K and V arrive once; Q, dO, LSE and Delta of each query tile
// through a two-stage ring.
// ---------------------------------------------------------------------------
constexpr int kStages = 2;     // tile i in the products, tile i+1 in flight
constexpr int kAtomRow = 128;  // bytes of one 64-column bf16 row: one swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int dkv_q_rows() {
  // query rows per tile: at D=128 the dK and dV accumulators already take
  // 128 registers a thread, so S^T and dP^T get 16 each
  return D == 64 ? 64 : 32;
}

struct DkvMaps {
  hopper::RowsMap q, k, v, dout;
};

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
flash_dkv_bf16_kernel(const __grid_constant__ DkvMaps maps, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int T_len, int causal, float scale) {
  using namespace hopper;
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

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Call& c, int threads, size_t smem, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.T_len + kTile - 1) / kTile, c.BH);
  kernel<<<grid, threads, smem, c.stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_bf16(const Call& c) {
  return launch(flash_dq_bf16_kernel<D>, c, kMmaThreads, dq_bf16_smem<D>(), in<bf16>(c.q),
                in<bf16>(c.k), in<bf16>(c.v), in<bf16>(c.dout), in<float>(c.lse),
                in<float>(c.delta), out<bf16>(c.out0), c.H, c.T_len, c.causal, c.scale, c.st);
}

template <int D>
int dkv_bf16(const Call& c) {
  const int B = c.BH / c.H, T = c.T_len;
  DkvMaps maps;
  const Strides& st = c.st;
  cudaError_t err = hopper::make_rows_map(&maps.q, c.q, B, T, c.H, D, st.q[0], st.q[1], st.q[2],
                                          dkv_q_rows<D>());
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.dout, c.dout, B, T, c.H, D, st.o[0], st.o[1], st.o[2],
                                dkv_q_rows<D>());
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.k, c.k, B, T, c.H, D, st.k[0], st.k[1], st.k[2], kTile);
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.v, c.v, B, T, c.H, D, st.v[0], st.v[1], st.v[2], kTile);
  if (err == cudaSuccess)
    err = hopper::allow_smem<flash_dkv_bf16_kernel<D>>(static_cast<int>(dkv_bf16_smem<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(c.BH, (T + kTile - 1) / kTile);
  flash_dkv_bf16_kernel<D><<<grid, kMmaThreads, dkv_bf16_smem<D>(), c.stream>>>(
      maps, in<float>(c.lse), in<float>(c.delta), out<bf16>(c.out0), out<bf16>(c.out1), c.H, T,
      c.causal, c.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_f32(const Call& c) {
  return launch(flash_dq_f32_kernel<D>, c, kF32Threads, dq_f32_smem<D>(), in<float>(c.q),
                in<float>(c.k), in<float>(c.v), in<float>(c.dout), in<float>(c.lse),
                in<float>(c.delta), out<float>(c.out0), c.H, c.T_len, c.causal, c.scale, c.st);
}

template <int D>
int dkv_f32(const Call& c) {
  return launch(flash_dkv_f32_kernel<D>, c, kF32Threads, dkv_f32_smem<D>(), in<float>(c.q),
                in<float>(c.k), in<float>(c.v), in<float>(c.dout), in<float>(c.lse),
                in<float>(c.delta), out<float>(c.out0), out<float>(c.out1), c.H, c.T_len,
                c.causal, c.scale, c.st);
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
