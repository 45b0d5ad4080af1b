// Device helpers shared by the flash kernels (flash_fwd.cu, flash_bwd.cu):
// fp32-accurate products on Hopper's TF32 tensor cores (3xTF32), cp.async
// staging of 64-row tiles, the per-warp tile products of the backward
// kernels, and the once-per-device lift of dynamic shared memory.
//
// 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
// a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the small terms first,
// accumulated in fp32 (mma.sync m16n8k8 tf32).  One TF32 pass keeps only
// ~5e-4 relative per d64 score, too coarse for the 1e-4 the kernels are
// held to; three keep ~fp32.
//
// ops/_build.py hashes this header into every library's key, so an edit
// here rebuilds every kernel that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

constexpr int D = 64;         // head dim
constexpr int THREADS = 128;  // 4 warps, 16 owned rows each
constexpr int SS = D + 4;     // row stride (floats) of a staged tile
constexpr int TILE = 64 * SS;  // one staged 64-row tile (floats)

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) of a
// finite fp32 value, as a tf32 bit pattern (low 13 bits clear).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// d = a.b in 3xTF32, from a zero accumulator.  The tensor cores' fp32
// accumulation does not round to nearest, so a running sum carried
// through them over all the streamed tiles drifts as t grows; the running
// sums (o in the forward, dQ, dK and dV) take one tile's product at a
// time from them, summed from zero, and add it in fp32.
__device__ __forceinline__ void mma3z(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t bh0,
                                      uint32_t bh1, uint32_t bl0,
                                      uint32_t bl1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh0), "r"(bh1),
        "f"(0.f));
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// cp.async of 16 bytes (zero-filled when !valid)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// cp.async of 4 bytes (zero-filled when !valid)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + 64) of a [t, 64] matrix into `dst` (row stride S
// floats), zeros past t; issued by the block's THREADS threads.
template <int S = SS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int t) {
#pragma unroll
  for (int j = 0; j < 64 * D / 4 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i >> 4, c4 = i & 15;
    const bool ok = r0 + r < t;
    cp_async16(dst + r * S + 4 * c4,
               src + (size_t)(ok ? r0 + r : 0) * D + 4 * c4, ok);
  }
}

// c = A.B^T for one warp: A's 16 resident rows (`a` at row g, and g + 8
// below it) against the 64 rows of a staged tile `b` (both at row stride
// SS).  n-tile n of c holds b's rows 8n + 2tq, +1; k-step st covers dims
// 8st + tq (k index tq) and 8st + tq + 4.
__device__ __forceinline__ void rows_by_tile(float (&c)[8][4],
                                             const float* a, const float* b,
                                             int g, int tq) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    uint32_t ah[4], al[4];
    const float* ar = a + 8 * st + tq;
    split(ar[0], ah[0], al[0]);
    split(ar[8 * SS], ah[1], al[1]);
    split(ar[4], ah[2], al[2]);
    split(ar[8 * SS + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* br = b + (8 * n + g) * SS + 8 * st + tq;
      uint32_t bh0, bl0, bh1, bl1;
      split(br[0], bh0, bl0);
      split(br[4], bh1, bl1);
      mma3(c[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// c = X.B, summed on the tensor cores from zero: X in rows_by_tile's
// accumulator layout, its columns the k index over the 64 rows of the
// staged tile `b`; n-tile n of c holds dims 8n + 2tq, +1.  k-step j
// covers b's rows 8j .. 8j + 7 with k index tq -> row 2tq and tq + 4 ->
// row 2tq + 1, so X is the A fragment as it stands.
__device__ __forceinline__ void acc_by_tile(float (&c)[8][4],
                                            const float (&x)[8][4],
                                            const float* b, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ah[4], al[4];
    split(x[j][0], ah[0], al[0]);
    split(x[j][2], ah[1], al[1]);
    split(x[j][1], ah[2], al[2]);
    split(x[j][3], ah[3], al[3]);
    const float* br = b + (8 * j + 2 * tq) * SS + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // dims 8n + g
      uint32_t bh0, bl0, bh1, bl1;
      split(br[8 * n], bh0, bl0);
      split(br[SS + 8 * n], bh1, bl1);
      if (j == 0)
        mma3z(c[n], ah, al, bh0, bh1, bl0, bl1);
      else
        mma3(c[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// Lift `kernel`'s dynamic shared memory to `bytes` (above 48 KB it must be
// asked for), once per device; `ready` is the kernel's own per-device
// flags.  Returns the cudaError_t (0 on success).
inline int allow_dynamic_smem(const void* kernel, int bytes,
                              int (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (ready[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) ready[dev] = 1;
  return (int)err;
}

}  // namespace tf32mma
