// bf16 tensor-core fragment helpers of the mma.sync dq kernel (B2,
// flash_bwd.cu); the wgmma kernels (hopper.cuh) share its pack_bf16, its
// mask value and its fragment layout, which is wgmma's per warp.
//
// mma.sync m16n8k16, row.col, f32 accumulation.  In a warp, lane
// (g = lane / 4, t = lane % 4) holds:
//   A (16 x 16, row-major M x K): a[0] = (row g,     k 2t, 2t+1)
//                                 a[1] = (row g + 8, k 2t, 2t+1)
//                                 a[2] = (row g,     k 2t+8, 2t+9)
//                                 a[3] = (row g + 8, k 2t+8, 2t+9)
//   B (16 x 8, K x N):            b0 = (k 2t, 2t+1; col g), b1 = (k 2t+8, 2t+9; col g)
//   C (16 x 8):                   c[0], c[1] = (row g, cols 2t, 2t+1)
//                                 c[2], c[3] = (row g + 8, cols 2t, 2t+1)
// So the C tiles of two neighbouring 8-column tiles, packed to bf16, are the
// A fragment of a 16-deep product over those 16 columns (pack_a below).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kPad = 8;            // bf16 of row padding: fragment loads hit 32 banks

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// two neighbouring bf16 of one row
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column, from rows r and r + 1 of a row-major tile with
// row stride `stride`: a B fragment half of a tile stored transposed
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p, int stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of a row-major [16 x 16] bf16 block at p (row stride `stride`)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p, int stride,
                                       int g, int t) {
  const __nv_bfloat16* r = p + g * stride + 2 * t;
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * stride);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * stride + 8);
}

// A fragment from the f32 accumulators of two neighbouring 8-column tiles,
// rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace flash
