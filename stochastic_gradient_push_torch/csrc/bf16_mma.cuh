// Device helpers shared by the bf16 forms of the flash kernels
// (flash_fwd.cu, flash_bwd.cu), whose products run on wgmma
// (sm90_bf16.cuh): f32 <-> bf16 packing, the hi/lo split of an fp32
// operand, and the rounded store of a 64-row accumulator.
//
// The product of two bf16 values (8 significant bits each) fits the 24
// bits of an fp32 significand, so a bf16 product with fp32 accumulation
// computes the reference's widened fp32 dot product of bf16 inputs up to
// the order of the sum, in one pass.  An fp32 operand computed inside a
// kernel (P, dS) enters its product as a hi/lo bf16 pair in two passes
// (split, through sm90::split_acc), as tf32_mma.cuh splits fp32 values
// into TF32 pairs.
//
// ops/_build.py hashes this header into the key of every library that
// includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;  // head dim

// two fp32 values rounded (to nearest even) into one bf16x2 register,
// `lo` in the lower half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 halves of a register, widened exactly to fp32
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// x = hi + lo in bf16: hi = bf16(x), lo = bf16(x - hi), packed for two
// adjacent elements.  hi + lo keeps ~16 significant bits of x (a relative
// 2**-17), where hi alone keeps 8 (2**-9).
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(x0, x1);
  lo = pack(x0 - lo_f(hi), x1 - hi_f(hi));
}

// One warp's rows of an fp32 accumulator (n-block n: dims 8n + 2tq, +1 of
// rows r0 and r0 + 8, as wgmma's accumulator holds them for the warp's 16
// rows), times `scale`, rounded once to bf16 and written to a [t, 64]
// bf16 matrix; rows at or past t are left alone.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&c)[8][4],
                                           int r0, int t, int tq,
                                           float scale0, float scale1) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
    if (r0 < t)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r0 * D + col) =
          pack(c[n][0] * scale0, c[n][1] * scale0);
    if (r0 + 8 < t)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r0 + 8) * D + col) =
          pack(c[n][2] * scale1, c[n][3] * scale1);
  }
}

}  // namespace bf16mma
