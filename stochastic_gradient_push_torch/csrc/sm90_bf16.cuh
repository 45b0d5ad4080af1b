// Hopper (sm_90a) building blocks of the bf16 flash kernels, which all
// run on wgmma fed by TMA: the forward (flash_fwd.cu), dQ and dK/dV
// (flash_bwd.cu).
// Inline PTX, no CUTLASS, so each library still builds in seconds.
//
// - Tiles.  Every bf16 row tensor is [bh, t, 64]: one row of 64 bf16 is
//   128 bytes, so a 64-row tile is 8 KB in shared memory, written by a TMA
//   load with 128-byte swizzle (16-byte chunk c of row r lands at chunk
//   c ^ (r % 8)) at a 1024-byte-aligned address.  The tensor map is 3-D,
//   [bh, t, 64] (rows_map), so a tile that runs past t is zero-filled and
//   never reads the next head's rows.
// - wgmma reads such a tile through one 64-bit matrix descriptor
//   (desc_sw128): start address >> 4, 8-row groups 1024 bytes apart
//   (stride byte offset), layout 128-byte swizzle.  The same descriptor
//   serves both majors: read K-major (rows = the m or n index, dims = k),
//   k-step j of 16 dims starts 32 bytes on (+2 in the descriptor); read
//   MN-major (rows = k, dims = n; the transpose bit bf16 wgmma allows),
//   k-step j of 16 rows starts 2048 bytes on (+128).
// - wgmma_ss / wgmma_rs: m64n64k16 bf16 products with fp32 accumulators
//   in registers, A from shared memory or from registers.  The
//   accumulator layout (warp w of the warpgroup, g = lane / 4, tq = lane %
//   4): d[n][0..1] row 16w + g, cols 8n + 2tq, +1; d[n][2..3] row + 8.
//   Its n-blocks 2j and 2j + 1 are, packed to bf16 pairs, the A fragment
//   of k-step j, so a product's result feeds the next from registers.
// - mbarriers (full/empty rings), and cp.async.bulk.tensor loads and
//   4-byte cp.asyncs that complete on them.
//
// ops/_build.py hashes this header into the key of every library that
// includes it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"  // split

namespace sm90 {

constexpr int BOX_BYTES = 64 * 128;  // one 64-row bf16 tile (TMA box), 8 KB
constexpr uint32_t KSTEP_K = 2;       // descriptor step, K-major k16
constexpr uint32_t KSTEP_MN = 128;    // descriptor step, MN-major k16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the inits visible to the async proxy (TMA) before any use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also expects `bytes` from TMA loads in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "-1", parity 1, as complete)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)map) : "memory");
}

// the box of `map` at coordinates (c0, c1, c2) = (dim, row, head) into
// shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async of 4 bytes (zero-filled when !valid)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.asyncs have landed
// (counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// -- wgmma -----------------------------------------------------------------

// a tile written by TMA with 128-byte swizzle at `addr` (1024-aligned)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the compiler may not move reads or writes of an accumulator across
// this point (placed after a wait, so a use sees the product's result)
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

// d = A.B (ACC false: d is written, not read) or d += A.B (ACC true),
// m64n64k16: A and B from shared memory, both K-major (rows of 64 bf16
// dims, 128-byte swizzle)
template <bool ACC>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b) {
#define SGP_WGMMA_SS                                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
  if constexpr (ACC) {
    asm volatile(SGP_WGMMA_SS
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(SGP_WGMMA_SS
        : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
          "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
          "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
          "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
          "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
          "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
          "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
          "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
        : "l"(a), "l"(b), "r"(0));
  }
#undef SGP_WGMMA_SS
}

// d += A.B, m64n64k16: A from registers (the A fragment of warp w's rows
// 16w + g: a[0] row g, cols 2tq, +1; a[1] row g + 8; a[2], a[3] the
// same rows 8 columns on), B from shared memory MN-major (16 rows of the
// k index, each 64 bf16 of the n index, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// An fp32 accumulator as the hi/lo bf16 A fragments of the next product
// (bf16mma::split): k-step j is n-blocks 2j and 2j + 1
__device__ __forceinline__ void split_acc(const float (&x)[8][4],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
  using bf16mma::split;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(x[2 * j][0], x[2 * j][1], hi[j][0], lo[j][0]);
    split(x[2 * j][2], x[2 * j][3], hi[j][1], lo[j][1]);
    split(x[2 * j + 1][0], x[2 * j + 1][1], hi[j][2], lo[j][2]);
    split(x[2 * j + 1][2], x[2 * j + 1][3], hi[j][3], lo[j][3]);
  }
}

// -- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The 3-D map of a contiguous bf16 [bh, t, 64] tensor at `base` (16-byte
// aligned), boxes of 64 rows of one head, 128-byte swizzle, zeros past t.
// cuTensorMapEncodeTiled is looked up once through the runtime (no -lcuda).
// Returns 0, a cudaError_t, or 1000 + the encoder's CUresult.
inline int rows_map(CUtensorMap* map, const void* base, int bh, int t) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {64, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {128, (cuuint64_t)t * 128};  // bytes
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

}  // namespace sm90
