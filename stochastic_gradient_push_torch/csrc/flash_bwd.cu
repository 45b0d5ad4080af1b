// Flash-attention backward for Hopper (sm_90a), head_dim 64: the dQ
// kernel and the dK/dV kernel, each in an fp32 form (3xTF32) and a bf16
// form (below, after the fp32 ones).
//
// Replaces stochastic_gradient_push_tpu/ops/flash_attention.py::
// _flash_dq_kernel and ::_flash_dkv_kernel (launched from
// flash_attention_backward).  Same functions: with the forward's row
// logsumexp `lse` and delta = rowsum(dO * O) (computed outside, as there),
//
//   s  = (q * d**-0.5) . k          p  = exp(s - lse)   (0 where masked)
//   dp = dO . v                     ds = p * (dp - delta)
//   dQ = d**-0.5 * sum_k ds * k     dK = sum_q ds * (q * d**-0.5)
//   dV = sum_q p * dO
//
// The TPU kernels carry their accumulators in scratch across a
// sequential grid axis; here that axis is a loop inside one block, and
// every output tile has exactly one owner block, so no atomics are
// needed and the results are the same from run to run.  Causal tiles
// that hold no visible pair are never loaded: the dQ loop stops at the
// tile's diagonal (kv_map's clamp there), the dK/dV loop starts at it
// (q_map's clamp).  Unlike the TPU kernels any sequence length is
// accepted: rows and columns at or past `t` are masked.
//
// What bounds them on an H100: 6*d (dQ) and 8*d (dK/dV) flops per visible
// (q, k) pair against ~O(t*d) bytes per head, so the arithmetic, not HBM,
// is the limit.  Both run their products on the tensor cores, fp32-
// accurate through a 3xTF32 split (tf32_mma.cuh; roof 495/3 = 165
// TFLOP/s).  At d64 the splits and fragment loads around the products
// issue more instructions than the products, so instruction issue bounds
// them before that roof.  The two kernels share one design with the roles
// of query and key rows swapped:
// - 4 warps own 64 rows (16 each) of one (batch*head): dQ owns query rows
//   and keeps their q and dO resident in shared memory, with each lane's
//   lse and delta (rows g, g + 8) in registers; dK/dV owns key rows and
//   keeps their K and V resident.  The other side's 64-row tiles stream
//   through shared memory double-buffered with cp.async (rows at or past
//   `t` zero-filled): K and V from key tile 0 up to the diagonal for dQ;
//   q, dO, lse and delta from the diagonal on for dK/dV.
// - dQ, per key tile: S = q.K^T, P = exp(S * d**-0.5 - lse) in
//   registers; dP = dO.V^T, dS = P * (dP - delta) in place; dQ += dS.K.
//   dK/dV, per query tile: S^T = K.q^T, P^T in registers, dV += P^T.dO;
//   dP^T = V.dO^T, dS^T in place, dK += dS^T.q.  The order of the k-terms
//   in a k8 step is free, so the second product's B rows are read in the
//   order the first product's accumulator holds its columns (2t, 2t + 1),
//   and P / dS feed it straight from registers (acc_by_tile).
// - Every staged row is padded to 68 floats, which keeps both fragment
//   orders (row-major for S, dP; transposed for the second product) free
//   of bank conflicts.  Masking runs only on edge tiles (the causal
//   diagonal, a ragged last tile).
// - The running sums (dQ; dK, dV) stay in registers and are written once;
//   each tile's product is summed on the tensor cores from zero and added
//   in fp32 (mma3z): carried through the tensor cores' own accumulation
//   they would drift as t grows.  d**-0.5, a power of two, scales dQ and
//   dK once at the end.
// - Under the causal mask the last query tiles and the first key tiles
//   see the most pairs; each kernel launches its heaviest tiles first
//   (grid.y, batch*head on grid.x) so they do not form the tail.
// - Shared memory: 2 resident tiles plus 2 stages of two tiles, 104,448
//   bytes for dQ and 105,472 for dK/dV (its stages also carry lse and
//   delta): two blocks of 4 warps per SM.

#include <math.h>

#include "bf16_mma.cuh"
#include "sm90_bf16.cuh"
#include "tf32_mma.cuh"

namespace {
namespace f32 {

using namespace tf32mma;

constexpr int DQ_STAGE = 2 * TILE;  // K, V
constexpr int DQ_SMEM_BYTES =
    (2 * TILE + 2 * DQ_STAGE) * (int)sizeof(float);  // 104,448
constexpr int DKV_STAGE = 2 * TILE + 2 * 64;  // q, dO, lse, delta
constexpr int DKV_SMEM_BYTES =
    (2 * TILE + 2 * DKV_STAGE) * (int)sizeof(float);  // 105,472

// dQ: one block per (batch*head, 64-row query tile), looping over the
// visible 64-row key tiles up to the diagonal.  Warp w owns query rows
// q0 + 16w .. +15; lane (g = lane / 4, tq = lane % 4) holds rows g and
// g + 8 of them, as the rows of S = q.K^T and dP = dO.V^T and of the dQ
// accumulator.
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int t, int causal,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qres = smem;           // this block's q rows, resident
  float* dores = smem + TILE;   // and its dO rows
  float* stages = smem + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // causal: the last query tiles see the most keys: run them first
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * 64;
  const size_t base = (size_t)blockIdx.x * (size_t)t * D;
  const float* kb = k + base;
  const float* vb = v + base;
  // causal: keys past the tile's last query row are never loaded
  const int nk = causal ? qt + 1 : (t + 63) / 64;

  load_rows(qres, q + base, q0, t);
  load_rows(dores, dout + base, q0, t);
  load_rows(stages, kb, 0, t);
  load_rows(stages + TILE, vb, 0, t);
  cp_async_commit();

  const int qr = 16 * warp + g;  // this lane's first query row in the tile
  const int qi0 = q0 + qr, qi1 = qi0 + 8;
  const float* lb = lse + (size_t)blockIdx.x * t;
  const float* deb = delta + (size_t)blockIdx.x * t;
  const float l0 = qi0 < t ? lb[qi0] : 0.f, l1 = qi1 < t ? lb[qi1] : 0.f;
  const float d0 = qi0 < t ? deb[qi0] : 0.f, d1 = qi1 < t ? deb[qi1] : 0.f;
  float dqa[8][4];  // n-tile n holds dims 8n + 2tq, +1
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile loads while this one is used
      float* nxt = stages + ((kt + 1) & 1) * DQ_STAGE;
      load_rows(nxt, kb, (kt + 1) * 64, t);
      load_rows(nxt + TILE, vb, (kt + 1) * 64, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = stages + (kt & 1) * DQ_STAGE;
    const float* vs = ks + TILE;
    const int k0 = kt * 64;

    // S = q.K^T, then P = exp(S * scale - lse), exactly 0 where masked
    float s[8][4];
    rows_by_tile(s, qres + qr * SS, ks, g, tq);
    const bool edge = (causal && kt == qt) || q0 + 64 > t || k0 + 64 > t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(fmaf(s[n][e], scale, -(e < 2 ? l0 : l1)));
        if (edge) {
          const int qi = e < 2 ? qi0 : qi1;
          const int kj = k0 + 8 * n + 2 * tq + (e & 1);
          if (qi >= t || kj >= t || (causal && kj > qi)) p = 0.f;
        }
        s[n][e] = p;
      }

    // dP = dO.V^T, then dS = P * (dP - delta) in place
    float dp[8][4];
    rows_by_tile(dp, dores + qr * SS, vs, g, tq);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - (e < 2 ? d0 : d1));

    // dQ += dS.K
    float pt[8][4];
    acc_by_tile(pt, dp, ks, g, tq);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] += pt[n][e];
    __syncthreads();  // every warp is done with this buffer
  }

  // dQ = dS.K * scale: the scale (a power of two) applied once here
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const size_t c = base + 8 * n + 2 * tq;
    if (qi0 < t)
      *reinterpret_cast<float2*>(dq + c + (size_t)qi0 * D) =
          make_float2(dqa[n][0] * scale, dqa[n][1] * scale);
    if (qi1 < t)
      *reinterpret_cast<float2*>(dq + c + (size_t)qi1 * D) =
          make_float2(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

// One dK/dV stage: rows [q0, q0 + 64) of q and dO, and their lse and
// delta (4-byte copies: a head's [t] row need not be 16-byte aligned).
__device__ __forceinline__ void load_stage(float* st, const float* qb,
                                           const float* db, const float* lb,
                                           const float* deb, int q0, int t) {
  load_rows(st, qb, q0, t);
  load_rows(st + TILE, db, q0, t);
  const int r = threadIdx.x & 63;
  const bool ok = q0 + r < t;
  const float* src = threadIdx.x < 64 ? lb : deb;
  cp_async4(st + 2 * TILE + threadIdx.x, src + (ok ? q0 + r : 0), ok);
}

// dK/dV: one block per (batch*head, 64-row key tile), looping over the
// visible 64-row query tiles from the diagonal on.  Warp w owns key rows
// k0 + 16w .. +15; lane (g = lane / 4, tq = lane % 4) holds rows g and
// g + 8 of them, as the rows of S^T = K.q^T and dP^T = V.dO^T and of the
// dK and dV accumulators.
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int t, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kres = smem;          // this block's K rows, resident
  float* vres = smem + TILE;   // and its V rows
  float* stages = smem + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kt = blockIdx.y;  // low tiles see the most queries: run first
  const int k0 = kt * 64;
  const size_t base = (size_t)blockIdx.x * (size_t)t * D;
  const float* qb = q + base;
  const float* db = dout + base;
  const float* lb = lse + (size_t)blockIdx.x * t;
  const float* deb = delta + (size_t)blockIdx.x * t;
  const int nq = (t + 63) / 64;
  // causal: query rows before the tile's first key see none of it
  const int qt0 = causal ? kt : 0;

  load_rows(kres, k + base, k0, t);
  load_rows(vres, v + base, k0, t);
  load_stage(stages, qb, db, lb, deb, qt0 * 64, t);
  cp_async_commit();

  const int kr = 16 * warp + g;  // this lane's first key row in the tile
  const int kj0 = k0 + kr, kj1 = kj0 + 8;
  float dka[8][4], dva[8][4];  // n-tile n holds dims 8n + 2tq, +1
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int it = qt - qt0;
    if (qt + 1 < nq) {  // the next tile loads while this one is used
      load_stage(stages + ((it + 1) & 1) * DKV_STAGE, qb, db, lb, deb,
                 (qt + 1) * 64, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = stages + (it & 1) * DKV_STAGE;
    const float* dos = qs + TILE;
    const float* ls = qs + 2 * TILE;
    const float* dls = ls + 64;
    const int q0 = qt * 64;

    // S^T = K.q^T, then P^T = exp(S^T * scale - lse), exactly 0 where
    // masked
    float s[8][4], pt[8][4];
    rows_by_tile(s, kres + kr * SS, qs, g, tq);
    const bool edge = (causal && qt == kt) || q0 + 64 > t || k0 + 64 > t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(fmaf(s[n][e], scale, -((e & 1) ? l2.y : l2.x)));
        if (edge) {
          const int qi = q0 + 8 * n + 2 * tq + (e & 1);
          const int kj = e < 2 ? kj0 : kj1;
          if (qi >= t || kj >= t || (causal && kj > qi)) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    // dV += P^T.dO
    acc_by_tile(pt, s, dos, g, tq);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[n][e] += pt[n][e];

    // dP^T = V.dO^T, then dS^T = P^T * (dP^T - delta) in place
    float dp[8][4];
    rows_by_tile(dp, vres + kr * SS, dos, g, tq);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dls + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
    }
    // dK += dS^T.q
    acc_by_tile(pt, dp, qs, g, tq);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] += pt[n][e];
    __syncthreads();  // every warp is done with this buffer
  }

  // dK = dS^T.(q * scale): the scale (a power of two) applied once here
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const size_t c = base + 8 * n + 2 * tq;
    if (kj0 < t) {
      *reinterpret_cast<float2*>(dk + c + (size_t)kj0 * D) =
          make_float2(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<float2*>(dv + c + (size_t)kj0 * D) =
          make_float2(dva[n][0], dva[n][1]);
    }
    if (kj1 < t) {
      *reinterpret_cast<float2*>(dk + c + (size_t)kj1 * D) =
          make_float2(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<float2*>(dv + c + (size_t)kj1 * D) =
          make_float2(dva[n][2], dva[n][3]);
    }
  }
}

// each kernel's dynamic shared memory is lifted above 48 KB once per device
int dq_smem_ready[64];
int dkv_smem_ready[64];

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int t,
              int causal, void* stream) {
  const int nq = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  if (int err = allow_dynamic_smem((const void*)flash_bwd_dq_f32_kernel,
                                   DQ_SMEM_BYTES, dq_smem_ready))
    return err;
  const dim3 grid(bh, nq);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, DQ_SMEM_BYTES,
                            (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int t, int causal, void* stream) {
  const int nk = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nk > 65535) return (int)cudaErrorInvalidValue;
  if (int err = allow_dynamic_smem((const void*)flash_bwd_dkv_f32_kernel,
                                   DKV_SMEM_BYTES, dkv_smem_ready))
    return err;
  const dim3 grid(bh, nk);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, DKV_SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t, causal,
      0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

}  // namespace f32

// The bf16 forms: the same functions on bf16 q, k, v, dO and gradients,
// with lse and delta in fp32, as the TPU kernels compute them for bf16
// inputs (widened to fp32, fp32 accumulators, each gradient rounded once
// to the input type).  Both feed P and dS to their second products from
// registers as hi/lo bf16 pairs, two passes each, ~16 bits where the
// reference keeps fp32 (flash_fwd.cu says why one rounding to bf16 is
// too coarse), and round each running sum once to bf16 at the end, where
// d**-0.5 scales dQ and dK.  Both run on Hopper's wgmma fed by TMA
// (sm90_bf16.cuh), one design with the roles of query and key rows
// swapped.
//
// dQ.  What bounds it on an H100: 6*d flops a visible pair at the bf16
// tensor-core rate (989 TFLOP/s) against 2-byte rows and the fp32 lse and
// delta at 3.35 TB/s: at B8 H12 T1024 causal the operations bound (0.0196
// ms) is above the bytes bound.  The hi/lo pass makes it 8*d flops of
// tensor-core work a pair (16 m64n64k16 products a 64 x 64 tile pair).
// The design:
// - A block is one warpgroup (4 warps, 64 query rows of one head, 16 a
//   warp).  Thread 0 loads the block's q and dO tiles once by TMA onto one
//   mbarrier, and keeps a ring of DQ_STAGES (K, V) tiles in flight from
//   key tile 0 up to the diagonal (causal) under full/empty mbarriers.
//   Each thread reads its two rows' lse and delta (rows 16w + g and + 8
//   of the accumulator layout) into registers once.  Thread 0 refills the
//   stage of tile kt - 1 once dP of tile kt has landed: no product is in
//   flight there, and every thread released that stage before it issued
//   tile kt's products, so the refill waits for no warp.  (Refilled
//   after tile kt's own dQ product, the wait on the empty barrier held
//   warp 0, and with it the warpgroup's next products, for the slowest
//   warp, and the kernel ran slower.)
// - Occupancy sets the speed: with two stages (50 KB) and 128 registers,
//   four blocks share an SM; with three stages only three fit (shared
//   memory), and that ran slower, as did q and dO held as register A
//   fragments (S and dP as RS products; more registers, three blocks) and
//   tile kt + 1's S and dP issued beside tile kt's dQ product.
// - Per key tile: S = q.K^T and dP = dO.V^T are two SS wgmma groups
//   (both operands K-major), so each accumulator row is a query row; P =
//   exp2(S * d**-0.5 * log2 e - lse * log2 e) is computed while dP is
//   still in flight, then dS = P * (dP - delta), in registers.
// - dQ += dS.K is an RS wgmma group: dS as hi/lo A fragments (n-blocks
//   2j, 2j + 1 = k-step j), the small terms first, K the B operand
//   MN-major, read in place from the same tile with wgmma's transpose
//   bit.  The fp32 accumulator stays in registers across the loop.
// - Masking runs on the causal diagonal and a ragged last key tile only;
//   the last query tiles, which see the most keys, launch first.  Rows
//   past t are zero-filled by TMA and their outputs never stored.
// - One block owns each query row, no atomics: two launches are bit-equal.
// - 64 query rows a block at every shape (B8 H12 T1024: 1,536 blocks; the
//   tick b2 h12 t1024: 384).
// - -Xptxas -v: 128 registers a thread, no spill, no static shared
//   memory; DQ_SMEM_BYTES (50,216) of dynamic shared memory a block.
//
// dK/dV.  What bounds it on an H100: 8*d flops a visible pair against
// 2-byte rows and the fp32 lse and delta: at B8 H12 T1024 causal the
// operations bound (0.0261 ms) is above the bytes bound.  The hi/lo
// passes make it 12*d flops of tensor-core work a pair, run at ~40 % of
// the peak (PERF.md).  The design:
// - A block is one warpgroup (4 warps, 64 key rows of one head).  Thread
//   0 loads the block's K and V tiles once by TMA; warp 0 keeps a ring of
//   DKV_STAGES (q, dO) tiles in flight from the diagonal on (causal)
//   under full/empty mbarriers: lane 0 loads q and dO by TMA, and the 32
//   lanes copy the tile's 64 lse and 64 delta values with 4-byte
//   cp.asyncs that arrive on the same full barrier (a head's fp32 row
//   starts 4t bytes in, which TMA refuses when t % 4 != 0).  Warp 0
//   refills a stage after the products of the tile before, where none is
//   in flight.  Without a producer warp a block is 128 threads, and three
//   fit an SM at the kernel's registers (with one, two fit).
// - Per q tile: S^T = K.q^T and dP^T = V.dO^T are two SS wgmma groups
//   (both operands K-major), so each accumulator row is a key row; P^T =
//   exp2(S^T * d**-0.5 * log2 e - lse * log2 e) is computed while dP^T is
//   still in flight, then dS^T = P^T * (dP^T - delta), in registers.
// - dV += P^T.dO and dK += dS^T.q are RS wgmma groups: P^T and dS^T as
//   hi/lo A fragments (n-blocks 2j, 2j + 1 = k-step j), dO and q the B
//   operands MN-major, read in place with wgmma's transpose bit; the dV
//   group runs while dS^T is split.  The fp32 accumulators stay in
//   registers across the loop.
// - Masking runs on the causal diagonal and ragged edge tiles only; the
//   low key tiles, which see the most queries, launch first.  Rows past t
//   are zero-filled by TMA and their outputs never stored.
// - One block owns each key row, no atomics: two launches are bit-equal.
// - 64 key rows a block at every shape (B8 H12 T1024: 1,536 blocks; the
//   tick b2 h12 t1024: 384).
// - -Xptxas -v: 167 registers a thread, no spill, no static shared
//   memory; DKV_SMEM_BYTES (68,152) of dynamic shared memory a block.
//
// In both, a load issued on a divergent path between wgmma products would
// make ptxas serialize every product of the kernel (warning C7520), so
// the stages are refilled only where no product is in flight.
namespace bf16k {

using namespace bf16mma;  // bf16, D, store_rows

constexpr int THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dQ (wgmma, TMA): shared memory holds q, dO, then K and V of each stage
// (8 KB tiles, 1024-aligned), then the barriers qdo, full[DQ_STAGES],
// empty[DQ_STAGES]
constexpr int DQ_STAGES = 2;
constexpr int DQ_OFF_K = 2 * sm90::BOX_BYTES;  // stage s: K, then V
constexpr int DQ_OFF_BAR = DQ_OFF_K + 2 * DQ_STAGES * sm90::BOX_BYTES;
constexpr int DQ_SMEM_BYTES =
    DQ_OFF_BAR + 8 * (1 + 2 * DQ_STAGES) + 1024;  // 50,216

// S = q.K^T and dP = dO.V^T, each one committed group of 4 k-steps
// (q, o, k, v: the descriptors of the q, dO, K and V tiles)
__device__ __forceinline__ void scores(float (&s)[8][4], float (&dp)[8][4],
                                       uint64_t q, uint64_t o, uint64_t k,
                                       uint64_t v) {
  using namespace sm90;
  wgmma_ss<false>(s, q, k);
#pragma unroll
  for (int j = 1; j < 4; ++j)
    wgmma_ss<true>(s, q + j * KSTEP_K, k + j * KSTEP_K);
  wgmma_commit();
  wgmma_ss<false>(dp, o, v);
#pragma unroll
  for (int j = 1; j < 4; ++j)
    wgmma_ss<true>(dp, o + j * KSTEP_K, v + j * KSTEP_K);
  wgmma_commit();
}

// S of key tile k0 in place -> P = exp2(S * c - l), exactly 0 where
// masked (an edge tile: keys at or past t, or, causal, past the row)
__device__ __forceinline__ void probs(float (&s)[8][4], bool edge, int k0,
                                      int t, int causal, int tq, int qi0,
                                      float c, float l0, float l1) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[n][e], c, -(e < 2 ? l0 : l1)));
      if (edge) {
        const int kj = k0 + 8 * n + 2 * tq + (e & 1);
        if (kj >= t || (causal && kj > qi0 + (e < 2 ? 0 : 8))) p = 0.f;
      }
      s[n][e] = p;
    }
}

// One block per (batch*head, 64-row query tile), looping over the visible
// key tiles up to the diagonal.  Warp w owns query rows q0 + 16w .. +15;
// lane (g, tq) holds rows g and g + 8 of them, as the rows of S, dP and
// the dQ accumulator.
__global__ void __launch_bounds__(THREADS, 4)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __grid_constant__ CUtensorMap tmdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int t, int causal,
                         float scale) {
  using namespace sm90;
  extern __shared__ unsigned char dq_bf16_smem[];
  const uint32_t sq = (smem_addr(dq_bf16_smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + BOX_BYTES, skv = sq + DQ_OFF_K;
  const uint32_t qbar = sq + DQ_OFF_BAR;
  auto full = [&](int s) { return qbar + 8 + 8 * s; };
  auto empty = [&](int s) { return qbar + 8 + 8 * (DQ_STAGES + s); };
  auto ktile = [&](int s) { return skv + 2 * s * BOX_BYTES; };

  const int head = blockIdx.x;
  // causal: the last query tiles see the most keys: run them first
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * 64;
  // causal: keys past the tile's last query row are never loaded
  const int nk = causal ? qt + 1 : (t + 63) / 64;
  // thread 0 fills the stage of key tile kt with its K and V, once the
  // block is done with tile kt - DQ_STAGES there (zeros past t)
  auto fill = [&](int kt) {
    const int s = kt % DQ_STAGES;
    if (kt >= DQ_STAGES) mbar_wait(empty(s), ((kt / DQ_STAGES) - 1) & 1);
    mbar_arrive_expect_tx(full(s), 2 * BOX_BYTES);
    tma_load_3d(ktile(s), &tmk, full(s), 0, kt * 64, head);
    tma_load_3d(ktile(s) + BOX_BYTES, &tmv, full(s), 0, kt * 64, head);
  };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    mbar_init_fence();
    mbar_arrive_expect_tx(qbar, 2 * BOX_BYTES);
    tma_load_3d(sq, &tmq, qbar, 0, q0, head);
    tma_load_3d(sdo, &tmdo, qbar, 0, q0, head);
    for (int kt = 0; kt < DQ_STAGES && kt < nk; ++kt) fill(kt);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qi0 = q0 + 16 * warp + g, qi1 = qi0 + 8;
  const float* lb = lse + (size_t)head * t;
  const float* deb = delta + (size_t)head * t;
  // the two rows' lse (in log2 units) and delta; rows past t, never
  // stored, take 0
  const float l0 = qi0 < t ? lb[qi0] * LOG2E : 0.f;
  const float l1 = qi1 < t ? lb[qi1] * LOG2E : 0.f;
  const float d0 = qi0 < t ? deb[qi0] : 0.f;
  const float d1 = qi1 < t ? deb[qi1] : 0.f;
  const float c = scale * LOG2E;  // raw score -> log2 units
  const uint64_t desc_q = desc_sw128(sq), desc_do = desc_sw128(sdo);

  // dQ; S then P; dP then dS: n-block n holds keys k0 + 8n + 2tq, +1 of
  // rows qi0 (e < 2) and qi1 (dQ: dims 8n + 2tq, +1)
  float dqa[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % DQ_STAGES;
    const uint64_t desc_k = desc_sw128(ktile(st));
    mbar_wait(full(st), (kt / DQ_STAGES) & 1);
    // S = q.K^T and dP = dO.V^T, two groups; P while dP is in flight
    wgmma_fence();
    scores(s, dp, desc_q, desc_do, desc_k,
           desc_sw128(ktile(st) + BOX_BYTES));
    wgmma_wait<1>();
    fence_acc(s);
    const bool edge = (causal && kt == qt) || kt * 64 + 64 > t;
    probs(s, edge, kt * 64, t, causal, tq, qi0, c, l0, l1);
    wgmma_wait<0>();
    fence_acc(dp);
    // no product is in flight, and every thread has released the stage of
    // tile kt - 1 (its arrival came before this tile's products): thread 0
    // refills it
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + DQ_STAGES < nk)
      fill(kt - 1 + DQ_STAGES);

    // dS = P * (dP - delta) in place, then dQ += dS.K: dS as hi/lo bf16 A
    // fragments (k-step j = n-blocks 2j, 2j + 1), the small terms first,
    // K read MN-major from the same tile
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - (e < 2 ? d0 : d1));
    uint32_t dh[4][4], dl[4][4];
    split_acc(dp, dh, dl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs(dqa, dl[j], desc_k + j * KSTEP_MN);
      wgmma_rs(dqa, dh[j], desc_k + j * KSTEP_MN);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
    mbar_arrive(empty(st));  // this thread is done with the stage
  }

  // dQ = dS.K * scale: the scale (a power of two) applied once here
  store_rows(dq + (size_t)head * (size_t)t * D, dqa, qi0, t, tq, scale,
             scale);
}

// dK/dV (wgmma, TMA): shared memory holds K, V, then q[STAGES],
// dO[STAGES] (8 KB tiles, 1024-aligned), then each stage's 64 lse and 64
// delta values, then the barriers kv, full[STAGES], empty[STAGES]
constexpr int DKV_STAGES = 3;
constexpr int DKV_OFF_Q = 2 * sm90::BOX_BYTES;
constexpr int DKV_OFF_DO = DKV_OFF_Q + DKV_STAGES * sm90::BOX_BYTES;
constexpr int DKV_OFF_L = DKV_OFF_DO + DKV_STAGES * sm90::BOX_BYTES;
constexpr int DKV_OFF_BAR = DKV_OFF_L + DKV_STAGES * 128 * 4;
constexpr int DKV_SMEM_BYTES =
    DKV_OFF_BAR + 8 * (1 + 2 * DKV_STAGES) + 1024;  // 68,152

// One block per (batch*head, 64-row key tile), looping over the visible
// query tiles from the diagonal on: one warpgroup, whose warp 0 also
// fills the stages.  Warp w owns key rows k0 + 16w .. +15; lane (g, tq)
// holds rows g and g + 8 of them, as the rows of S^T, dP^T and the dK and
// dV accumulators.
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv,
                          const __grid_constant__ CUtensorMap tmdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int t, int causal, float scale) {
  using namespace sm90;
  extern __shared__ unsigned char dkv_bf16_smem[];
  const uint32_t raw = smem_addr(dkv_bf16_smem);
  const uint32_t sk = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms
  const uint32_t sv = sk + BOX_BYTES, sq = sk + DKV_OFF_Q;
  const uint32_t sdo = sk + DKV_OFF_DO, kvbar = sk + DKV_OFF_BAR;
  // stage s's lse at [128 s], delta at [128 s + 64]
  const uint32_t sscal = sk + DKV_OFF_L;
  const float* const scal =
      reinterpret_cast<const float*>(dkv_bf16_smem + (sscal - raw));
  auto full = [&](int s) { return kvbar + 8 + 8 * s; };
  auto empty = [&](int s) { return kvbar + 8 + 8 * (DKV_STAGES + s); };

  const int head = blockIdx.x;
  const int kt = blockIdx.y;  // low tiles see the most queries: run first
  const int k0 = kt * 64;
  const int nq = (t + 63) / 64;
  // causal: query rows before the tile's first key see none of it
  const int qt0 = causal ? kt : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* lb = lse + (size_t)head * t;
  const float* deb = delta + (size_t)head * t;
  // warp 0 fills the stage of the block's it-th query tile, once the block
  // is done with its (it - DKV_STAGES)-th there: q and dO by TMA (lane 0),
  // the tile's lse and delta by 4-byte cp.asyncs (a head's fp32 row starts
  // 4t bytes in, which TMA refuses when t % 4 != 0), zeros past t
  auto fill = [&](int it) {
    const int s = it % DKV_STAGES, q0 = (qt0 + it) * 64;
    if (it >= DKV_STAGES) mbar_wait(empty(s), ((it / DKV_STAGES) - 1) & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + lane + 32 * h;
      const uint32_t dst = sscal + 4 * (128 * s + lane + 32 * h);
      cp_async4(dst, lb + (r < t ? r : 0), r < t);
      cp_async4(dst + 4 * 64, deb + (r < t ? r : 0), r < t);
    }
    cp_async_arrive(full(s));
    if (lane == 0) {
      mbar_arrive_expect_tx(full(s), 2 * BOX_BYTES);
      tma_load_3d(sq + s * BOX_BYTES, &tmq, full(s), 0, q0, head);
      tma_load_3d(sdo + s * BOX_BYTES, &tmdo, full(s), 0, q0, head);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full(s), 33);  // warp 0's cp.asyncs, lane 0's TMA
      mbar_init(empty(s), THREADS);
    }
    mbar_init_fence();
    mbar_arrive_expect_tx(kvbar, 2 * BOX_BYTES);
    tma_load_3d(sk, &tmk, kvbar, 0, k0, head);
    tma_load_3d(sv, &tmv, kvbar, 0, k0, head);
  }
  __syncthreads();
  if (warp == 0)
    for (int it = 0; it < DKV_STAGES && qt0 + it < nq; ++it) fill(it);

  const int g = lane >> 2, tq = lane & 3;
  const int kj0 = k0 + 16 * warp + g, kj1 = kj0 + 8;
  const float c = scale * LOG2E;  // raw score -> log2 units
  const uint64_t dK = desc_sw128(sk), dV = desc_sw128(sv);

  // dK, dV; S^T then P^T; dP^T then dS^T: n-block n holds queries
  // q0 + 8n + 2tq, +1 (dK, dV: dims 8n + 2tq, +1)
  float dka[8][4], dva[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  mbar_wait(kvbar, 0);

  for (int qt = qt0; qt < nq; ++qt) {
    const int it = qt - qt0, st = it % DKV_STAGES;
    const int q0 = qt * 64;
    mbar_wait(full(st), (it / DKV_STAGES) & 1);
    const uint64_t dQ = desc_sw128(sq + st * BOX_BYTES);
    const uint64_t dO = desc_sw128(sdo + st * BOX_BYTES);
    const float* sl = scal + 128 * st;

    // S^T = K.q^T and dP^T = V.dO^T, two groups
    wgmma_fence();
    wgmma_ss<false>(s, dK, dQ);
#pragma unroll
    for (int j = 1; j < 4; ++j)
      wgmma_ss<true>(s, dK + j * KSTEP_K, dQ + j * KSTEP_K);
    wgmma_commit();
    wgmma_ss<false>(dp, dV, dO);
#pragma unroll
    for (int j = 1; j < 4; ++j)
      wgmma_ss<true>(dp, dV + j * KSTEP_K, dO + j * KSTEP_K);
    wgmma_commit();

    // P^T = exp(S^T * scale - lse), exactly 0 where masked, while dP^T
    // is in flight
    wgmma_wait<1>();
    fence_acc(s);
    const bool edge = (causal && qt == kt) || q0 + 64 > t || k0 + 64 > t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * n + 2 * tq);
      const float lc[2] = {l2.x * LOG2E, l2.y * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[n][e], c, -lc[e & 1]));
        if (edge) {
          const int qi = q0 + 8 * n + 2 * tq + (e & 1);
          const int kj = e < 2 ? kj0 : kj1;
          if (qi >= t || kj >= t || (causal && kj > qi)) p = 0.f;
        }
        s[n][e] = p;
      }
    }
    // dS^T = P^T * (dP^T - delta) in place
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(sl + 64 + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
    }
    // P^T and dS^T as hi/lo bf16 A fragments (k-step j = n-blocks 2j,
    // 2j + 1); dV += P^T.dO runs on the tensor cores while dS^T is split,
    // then dK += dS^T.q, each the small terms first
    uint32_t hi[4][4], lo[4][4];
    split_acc(s, hi, lo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs(dva, lo[j], dO + j * KSTEP_MN);
      wgmma_rs(dva, hi[j], dO + j * KSTEP_MN);
    }
    wgmma_commit();
    uint32_t dh[4][4], dl[4][4];
    split_acc(dp, dh, dl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_rs(dka, dl[j], dQ + j * KSTEP_MN);
      wgmma_rs(dka, dh[j], dQ + j * KSTEP_MN);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    mbar_arrive(empty(st));  // this thread is done with the stage
    if (warp == 0 && qt + DKV_STAGES < nq) fill(it + DKV_STAGES);
  }

  // dK = dS^T.(q * scale): the scale (a power of two) applied once here
  const size_t base = (size_t)head * (size_t)t * D;
  store_rows(dk + base, dka, kj0, t, tq, scale, scale);
  store_rows(dv + base, dva, kj0, t, tq, 1.f, 1.f);
}

// the dQ kernel's dynamic shared memory is lifted once per device
int dq_smem_ready[64];

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int t,
              int causal, void* stream) {
  const int nq = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tmq, tmk, tmv, tmdo;
  if (int err = sm90::rows_map(&tmq, q, bh, t)) return err;
  if (int err = sm90::rows_map(&tmk, k, bh, t)) return err;
  if (int err = sm90::rows_map(&tmv, v, bh, t)) return err;
  if (int err = sm90::rows_map(&tmdo, dout, bh, t)) return err;
  if (int err = tf32mma::allow_dynamic_smem(
          (const void*)flash_bwd_dq_bf16_kernel, DQ_SMEM_BYTES,
          dq_smem_ready))
    return err;
  const dim3 grid(bh, nq);
  flash_bwd_dq_bf16_kernel<<<grid, THREADS, DQ_SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      tmq, tmk, tmv, tmdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), t, causal,
      0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

// the dK/dV kernel's dynamic shared memory is lifted once per device
int dkv_smem_ready[64];

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int t, int causal, void* stream) {
  const int nk = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nk > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tmq, tmk, tmv, tmdo;
  if (int err = sm90::rows_map(&tmq, q, bh, t)) return err;
  if (int err = sm90::rows_map(&tmk, k, bh, t)) return err;
  if (int err = sm90::rows_map(&tmv, v, bh, t)) return err;
  if (int err = sm90::rows_map(&tmdo, dout, bh, t)) return err;
  if (int err = tf32mma::allow_dynamic_smem(
          (const void*)flash_bwd_dkv_bf16_kernel, DKV_SMEM_BYTES,
          dkv_smem_ready))
    return err;
  const dim3 grid(bh, nk);
  flash_bwd_dkv_bf16_kernel<<<grid, THREADS, DKV_SMEM_BYTES,
                              (cudaStream_t)stream>>>(
      tmq, tmk, tmv, tmdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

}  // namespace bf16k
}  // namespace

// q, k, v, dout, dq: contiguous fp32 [bh, t, 64]; lse, delta: fp32
// [bh, t].  Returns the error of the shared-memory attribute or
// cudaGetLastError() after the launch (0 on success).
extern "C" int sgp_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int bh, int t, int causal,
                                    void* stream) {
  return f32::launch_dq(q, k, v, dout, lse, delta, dq, bh, t, causal,
                        stream);
}

// As above, writing dk and dv (contiguous fp32 [bh, t, 64]).
extern "C" int sgp_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int t,
                                     int causal, void* stream) {
  return f32::launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, t, causal,
                         stream);
}

// The bf16 forms: q, k, v, dout and the gradients contiguous bf16
// [bh, t, 64], 16-byte aligned; lse, delta fp32 [bh, t].  Return the
// error of a tensor map (1000 + its CUresult), of the shared-memory
// attribute or cudaGetLastError() after the launch (0 on success).
extern "C" int sgp_flash_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int bh, int t, int causal,
                                     void* stream) {
  return bf16k::launch_dq(q, k, v, dout, lse, delta, dq, bh, t, causal,
                          stream);
}

extern "C" int sgp_flash_bwd_dkv_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int t,
                                      int causal, void* stream) {
  return bf16k::launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, t, causal,
                           stream);
}
