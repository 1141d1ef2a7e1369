// Flash attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _flash_fwd_impl).  It computes the same function:
// softmax(q k^T / sqrt(D)) v with the optional causal mask kpos <= qpos,
// as an online softmax (running max m, normaliser l, f32 accumulator)
// over K/V tiles, skipping the tiles above the diagonal, and it writes the
// per-row log-sum-exp m + log l in f32 beside the output.
//
// What bounds it on an H100.  At the largest prefill of GPT-2 small
// (B=1, T=1024, H=12, D=64, bf16, causal) the two products are 1.6 GFLOP
// against 6.3 MB of q, k, v, O and LSE each read or written once: 1.6 us of
// tensor-core time at 989 TFLOP/s against 1.9 us of memory time at
// 3.35 TB/s, so the bytes set the bound, and only just.  At the training
// shape (B=16) both grow 16-fold and the bytes still set it (30 us).  But
// a causal prefill is a chain: the block of a head's last query tile walks
// every K/V tile in turn, so at B=1 the kernel's time is that chain's
// latency, not either bound; at B=16 it is the SMs' throughput.
//
// What the design does about it (bf16).  One warpgroup per block owns 64
// query rows, the wgmma M.  Q and a two-stage ring of K/V tiles arrive by
// TMA into 128-byte-swizzled shared tiles behind mbarriers, issued by one
// thread, so tile j+1 is in flight while tile j is in the products and no
// thread spends registers or instructions on copies.  S = Q K^T is a wgmma
// with both operands in shared memory, K-major as they land.  O += P V is a
// wgmma with P from registers (the S accumulator, rounded to bf16 as the
// reference rounds its probabilities) and V read MN-major through the
// descriptor's transpose bit: V is never transposed by a thread.  The grid
// launches each head's heaviest query tile first, so the longest chains
// start in the first wave.  TMA zero-fills rows past T; those keys are
// masked to -1e30 (a zero key would score 0), those rows not written.
// What still keeps it from the bound: within a block the steps run in
// series (products, softmax, products), with no second warpgroup or
// second S in flight to hide the softmax behind the tensor cores, and O
// is written from registers rather than by a TMA store.
//
// In f32 the kernel does its arithmetic on the CUDA cores (67 TFLOP/s),
// the simple version kept for f32 parity with the reference.
//
// Layout.  q, k and v are [B, T, H, D], read through their strides (last
// dimension contiguous; in bf16 16-byte-aligned pointers and strides in
// multiples of 8 elements, which TMA needs and the wrapper checks), so the
// q/k/v views that GPT-2 splits out of one fused qkv projection need no
// copy.  O is written contiguous [B, T, H, D] in the input type, LSE
// contiguous [B, H, T] in f32.  Any T >= 1, D in {64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 64;  // query rows per block (the wgmma M in bf16)
constexpr int kBlockN = 64;  // keys per K/V tile

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: one warpgroup (4 warps) per block owns the 64 query rows; thread 0
// also issues the TMA loads.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;
constexpr int kStages = 2;        // K/V ring: tile j in the products, tile j+1 in flight
constexpr int kAtomRow = 128;     // bytes of one 64-column bf16 row: one swizzle atom
constexpr float kLog2e = 1.4426950408889634f;

struct FwdMaps {
  hopper::RowsMap q, k, v;
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  // Q, then kStages x (K, V), each D/64 swizzle-atom tiles; 1024 bytes of
  // slack to align the first tile
  return 1024 + (D / 64) * kAtomRow * (kBlockM + kStages * 2 * kBlockN);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __grid_constant__ FwdMaps maps, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int T_len, int causal, float scale_log2) {
  constexpr int kAtoms = D / 64;
  constexpr uint32_t kQAtom = kBlockM * kAtomRow;  // bytes of one Q atom tile
  constexpr uint32_t kKVAtom = kBlockN * kAtomRow;  // bytes of one K or V atom tile
  constexpr uint32_t kStageBytes = 2 * kAtoms * kKVAtom;
  extern __shared__ unsigned char smem_raw[];
  __shared__ alignas(8) uint64_t bars[1 + kStages];  // Q, then one per ring stage

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sRing = sQ + kAtoms * kQAtom;
  const uint32_t q_bar = smem_u32(&bars[0]);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // the heaviest tiles launch first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kv_end = causal ? min(T_len, q0 + kBlockM) : T_len;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  // K and V of tile j into ring stage j % kStages
  auto issue_kv = [&](int j) {
    const uint32_t stage = sRing + (j % kStages) * kStageBytes;
    const uint32_t bar = smem_u32(&bars[1 + j % kStages]);
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_rows(maps.k, stage + a * kKVAtom, bar, a * 64, h, j * kBlockN, b);
      tma_load_rows(maps.v, stage + (kAtoms + a) * kKVAtom, bar, a * 64, h, j * kBlockN, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, kAtoms * kQAtom);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) tma_load_rows(maps.q, sQ + a * kQAtom, q_bar, a * 64, h, q0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) issue_kv(j);
  }

  float acc[D / 2];  // O: this thread's share of the warpgroup's 64 x D accumulator
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t stage = sRing + (j % kStages) * kStageBytes;
    mbar_wait(smem_u32(&bars[1 + j % kStages]), (j / kStages) & 1);

    // S = Q K^T: A = Q, B = the K tile, both K-major as they landed
    float s[kBlockN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 bf16 within the atom
      wgmma_ss(s, desc_sw128(sQ + (kk / 4) * kQAtom + off, 16, 1024),
               desc_sw128(stage + (kk / 4) * kKVAtom + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    // mask, scale (to log2 units), online softmax; a row's values sit in
    // the 4 lanes of a quad
    const int k0 = j * kBlockN;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int key = k0 + (i / 4) * 8 + 2 * tq + (i & 1);
      const int r = row[(i >> 1) & 1];
      const bool valid = key < T_len && (!causal || key <= r);
      s[i] = valid ? s[i] * scale_log2 : kNegInf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      // masked entries hold kNegInf: zero them explicitly
      const float p = s[i] == kNegInf ? 0.f : exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P (rounded to bf16, as the reference rounds it) from
    // registers, V read MN-major through the descriptor's transpose bit
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    const uint32_t sV = stage + kAtoms * kKVAtom;
    wgmma_fence();
    fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_tb(acc, pa[kk], desc_sw128(sV + kk * 16 * kAtomRow, kKVAtom, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && j + kStages < n_tiles) issue_kv(j + kStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row[r];
    if (t >= T_len) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    if (tq == 0) lse[static_cast<long long>(bh) * T_len + t] = m[r] / kLog2e + logf(l[r]);
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
  cudaError_t err = hopper::make_rows_map(&maps.q, q, B, T_len, H, D, st[0], st[1], st[2], kBlockM);
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.k, k, B, T_len, H, D, st[3], st[4], st[5], kBlockN);
  if (err == cudaSuccess)
    err = hopper::make_rows_map(&maps.v, v, B, T_len, H, D, st[6], st[7], st[8], kBlockN);
  if (err == cudaSuccess)
    err = hopper::allow_smem<flash_fwd_bf16_kernel<D>>(static_cast<int>(bf16_smem_bytes<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T_len + kBlockM - 1) / kBlockM);
  flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, bf16_smem_bytes<D>(), stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, T_len, causal,
      scale * kLog2e);
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
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, o, lse, B, H, T_len, causal, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ray_tpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
