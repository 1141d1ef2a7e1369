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
// (B=1, T=1024, H=12, D=64, bf16) causal attention is about 1.6 GFLOP of
// matrix products against about 6 MB of q, k, v, O and LSE, each read or
// written once: 1.6 us of tensor-core time at 989 TFLOP/s and 1.9 us of
// memory time at 3.35 TB/s, so the bytes set the bound, and only just.
// What the design does about the bytes: each q element is read from device
// memory once, each k and v element once per query tile that needs it, the
// scores and probabilities never leave the SM, and the reuse of a K/V tile
// by the 64 rows of a query tile comes from shared memory.  What it does
// about the operations: in bf16, both products run on the tensor cores
// (mma.sync m16n8k16, f32 accumulation).  It does not reach either bound:
// 16 K/V tiles in a row for the last query tile, each loaded without
// overlap, make the kernel latency-bound at this size; TMA-fed wgmma with
// the next tile's load in flight is later work.  In f32 the kernel does its
// arithmetic on the CUDA cores (67 TFLOP/s), the simple version kept for
// f32 parity with the reference.
//
// Layout.  q, k and v are [B, T, H, D], read through the strides the
// wrapper passes (the last dimension must be contiguous; in bf16 the
// pointers are 16-byte aligned and the strides multiples of 8 elements,
// as the wrapper checks), so the q/k/v views that GPT-2 splits out of one
// fused qkv projection need no copy.  O is written contiguous
// [B, T, H, D] in the input type, LSE contiguous [B, H, T] in f32.
//
// Work split.  One block per (b*h, 64-row query tile); a loop inside the
// block walks the 64-key tiles up to the diagonal, in place of the TPU's
// sequential grid axis.  Any T >= 1 works: rows at or past T are not
// written and keys at or past T are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;  // query rows per block
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
// bf16: tensor cores.  4 warps, each owning 16 query rows of the tile, with
// the m16n8k16 fragments of mma_bf16.cuh.
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = kBlockM / 16;
constexpr int kMmaThreads = kMmaWarps * 32;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int T_len, int causal, float scale,
                      long long q_sb, long long q_st, long long q_sh, long long k_sb,
                      long long k_st, long long k_sh, long long v_sb, long long v_st,
                      long long v_sh) {
  constexpr int kStride = D + kPad;         // Ks row stride (Q is staged there first)
  constexpr int kVtStride = kBlockN + kPad;  // Vt row stride
  constexpr int kChunks = D / 8;             // 16-byte chunks per row
  __shared__ alignas(16) __nv_bfloat16 Ks[kBlockN * kStride];  // [key][d]
  __shared__ alignas(16) __nv_bfloat16 Vt[D * kVtStride];      // [d][key]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wrow = warp * 16;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // stage the Q tile through Ks, then keep its A fragments in registers
  for (int c = tid; c < kBlockM * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c - r * kChunks) * 8, t = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len) val = *reinterpret_cast<const uint4*>(qb + t * q_st + col);
    *reinterpret_cast<uint4*>(Ks + r * kStride + col) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Ks + (wrow + g) * kStride + kk * 16 + 2 * tq;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * kStride);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * kStride + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const int kv_end = causal ? min(T_len, q0 + kBlockM) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous Ks/Vt (or Q)
    for (int c = tid; c < kBlockN * kChunks; c += kMmaThreads) {
      const int r = c / kChunks, col = (c - r * kChunks) * 8, t = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (t < T_len) {
        kv = *reinterpret_cast<const uint4*>(kb + t * k_st + col);
        vv = *reinterpret_cast<const uint4*>(vb + t * v_st + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * kStride + col) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(col + e) * kVtStride + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * kStride + kk * 16 + 2 * tq;
        mma_bf16(s[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    // mask, scale, online softmax (rows are shared by the 4 lanes of a group)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tq + (e & 1);
        const int r = row[e >> 1];
        const bool valid = key < T_len && (!causal || key <= r);
        s[nt][e] = valid ? s[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries hold kNegInf, which underflows to 0 unless the
        // whole row is masked (only rows past T): zero them explicitly
        const float p = s[nt][e] == kNegInf ? 0.f : expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are the A fragments of the next
    // product, rounded to bf16 (as the reference rounds its probabilities)
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* p = Vt + (n * 8 + g) * kVtStride + kk * 16 + 2 * tq;
        mma_bf16(acc[n], a, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row[i];
    if (t >= T_len) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * T_len + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tq == 0) lse[static_cast<long long>(bh) * T_len + t] = m[i] + logf(l[i]);
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
  const dim3 grid((T_len + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, T_len, causal, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int T_len, int causal, float scale, const long long* st, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
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
