// Device helpers shared by the bf16 forms of the flash kernels
// (flash_fwd.cu, flash_bwd.cu): f32 <-> bf16 packing, the hi/lo split of
// an fp32 operand, and the rounded store of a 64-row accumulator, used by
// all three; and, for dQ, bf16 products on the tensor cores with fp32
// accumulation (mma.sync m16n8k16), ldmatrix fragment loads from staged
// tiles and cp.async staging of 64-row bf16 tiles.  The forward and dK/dV
// run their products on wgmma (sm90_bf16.cuh).
//
// The product of two bf16 values (8 significant bits each) fits the 24
// bits of an fp32 significand, so a bf16 mma with fp32 accumulation
// computes the reference's widened fp32 dot product of bf16 inputs up to
// the order of the sum, in one pass.  An fp32 operand computed inside a
// kernel (P, dS) enters its product as a hi/lo bf16 pair in two passes
// (acc_by_tile), as tf32_mma.cuh splits fp32 values into TF32 pairs.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16; g = lane / 4,
// tq = lane % 4): A (16 x 16, row) in 4 registers of two bf16 each,
// {row g, cols 2tq, +1}, {row g + 8, same}, {row g, cols 2tq + 8, +1},
// {row g + 8, same}; B (16 x 8, col) in 2, {rows 2tq, +1 of col g},
// {rows 2tq + 8, +1 of col g}; C/D (16 x 8, fp32) in 4, {row g, cols 2tq,
// +1}, {row g + 8, same}.  The lower-indexed element sits in the lower
// half of a register.  ldmatrix gives lane l of an 8 x 8 b16 matrix the
// pair {row g, cols 2tq, +1}, or with .trans {rows 2tq, +1 of col g}:
// the B fragment of a tile read row-major (K for q.K^T), or transposed
// (V for P.V).
//
// ops/_build.py hashes this header into the key of every library that
// includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;         // head dim
constexpr int THREADS = 128;  // 4 warps, 16 owned rows each
// row stride (bf16) of a staged tile: 144 bytes, so the 8 rows an
// ldmatrix phase reads start in banks 0, 4, .., 28 (no conflict) and every
// row start stays 16-byte aligned for cp.async and ldmatrix
constexpr int SS = D + 8;
constexpr int TILE = 64 * SS;  // one staged 64-row tile (bf16 elements)
constexpr int TILE_BYTES = TILE * (int)sizeof(bf16);  // 9,216

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

// c += a.b
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b from a zero accumulator
__device__ __forceinline__ void mmaz(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i (16-byte aligned shared memory)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// as ldsm_x4, each matrix transposed on delivery
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// cp.async of 16 bytes (8 bf16; zero-filled when !valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + 64) of a [t, 64] bf16 matrix into `dst` (row
// stride SS), zeros past t; issued by the block's THREADS threads, 16
// bytes each.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int t) {
#pragma unroll
  for (int j = 0; j < 64 * D / 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i >> 3, c8 = i & 7;
    const bool ok = r0 + r < t;
    cp_async16(dst + r * SS + 8 * c8,
               src + (size_t)(ok ? r0 + r : 0) * D + 8 * c8, ok);
  }
}

// The A fragments of one warp's 16 rows of a [t, 64] bf16 matrix, read
// from global memory (zeros for rows at or past t): a[s] covers dims
// 16s .. 16s + 15 of rows r0 (= g of the warp's rows) and r0 + 8, each
// element multiplied by `scale`.  With scale a power of two the product
// is exact (bf16 keeps fp32's exponent range).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* src,
                                       int r0, int t, int tq, float scale) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = 16 * s + 2 * tq;
    uint32_t x[4] = {0u, 0u, 0u, 0u};
    if (r0 < t) {
      x[0] = *reinterpret_cast<const uint32_t*>(src + (size_t)r0 * D + c);
      x[2] = *reinterpret_cast<const uint32_t*>(src + (size_t)r0 * D + c + 8);
    }
    if (r1 < t) {
      x[1] = *reinterpret_cast<const uint32_t*>(src + (size_t)r1 * D + c);
      x[3] = *reinterpret_cast<const uint32_t*>(src + (size_t)r1 * D + c + 8);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[s][e] = scale == 1.f ? x[e]
                             : pack(lo_f(x[e]) * scale, hi_f(x[e]) * scale);
  }
}

// c = A.B^T for one warp: A's 16 rows as the fragments `a` (k = the 64
// dims), against the 64 rows of the staged tile `b`.  n-tile n of c holds
// b's rows 8n + 2tq, +1; each ldmatrix.x4 gives the B fragments of two
// k-steps of one n-tile (lane l addresses row 8n + l % 8, dims 8 (l / 8)
// on from the k-step pair's first).
__device__ __forceinline__ void rows_by_tile(float (&c)[8][4],
                                             const uint32_t (&a)[4][4],
                                             const bf16* b, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const bf16* row = b + (8 * n + (lane & 7)) * SS + 8 * (lane >> 3);
    uint32_t f[4];
    ldsm_x4(f, row);
    mmaz(c[n], a[0], f[0], f[1]);
    mma(c[n], a[1], f[2], f[3]);
    ldsm_x4(f, row + 32);
    mma(c[n], a[2], f[0], f[1]);
    mma(c[n], a[3], f[2], f[3]);
  }
}

// x = hi + lo in bf16: hi = bf16(x), lo = bf16(x - hi), packed for two
// adjacent elements.  hi + lo keeps ~16 significant bits of x (a relative
// 2**-17), where hi alone keeps 8 (2**-9).
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(x0, x1);
  lo = pack(x0 - lo_f(hi), x1 - hi_f(hi));
}

// c += X.B on the tensor cores: X in rows_by_tile's accumulator layout
// (its columns the k index over the 64 rows of the staged tile `b`), fed
// as a hi/lo bf16 pair (two passes, the small terms first), so X enters
// the product with ~16 bits where the reference keeps it in fp32; b's
// bf16 values are exact.  n-tile n of c holds dims 8n + 2tq, +1.  k-step
// j covers b's rows 16j .. 16j + 15 in order: n-tiles 2j and 2j + 1 of X
// are the A fragment's two column halves as they stand.  b is read
// transposed: lane l addresses row 16j + l % 16, dims 16p + 8 (l / 16)
// for the n-tile pair p.  The running sums carried this way drift by at
// most an fp32 ulp a tile (the tensor cores' accumulation truncates), far
// below the bf16 rounding of the result.
__device__ __forceinline__ void acc_by_tile(float (&c)[8][4],
                                            const float (&x)[8][4],
                                            const bf16* b, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t hi[4], lo[4];
    split(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
    split(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
    split(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
    split(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
    const bf16* row = b + (16 * j + (lane & 15)) * SS + 8 * (lane >> 4);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t f[4];
      ldsm_x4_t(f, row + 16 * p);
      mma(c[2 * p], lo, f[0], f[1]);
      mma(c[2 * p + 1], lo, f[2], f[3]);
      mma(c[2 * p], hi, f[0], f[1]);
      mma(c[2 * p + 1], hi, f[2], f[3]);
    }
  }
}

// One warp's rows of an fp32 accumulator (n-tile n: dims 8n + 2tq, +1 of
// rows r0 and r0 + 8), times `scale`, rounded once to bf16 and written to
// a [t, 64] bf16 matrix; rows at or past t are left alone.
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
