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
// to the input type).
// - S and dP are one bf16 mma.sync pass each (m16n8k16, fp32
//   accumulation): products of bf16 values are exact in fp32, so both are
//   the reference's widened dot products up to the order of the sum.
// - p = exp(s * d**-0.5 - lse) and ds = p * (dp - delta) in fp32 in the
//   accumulators; P (for dV) and dS (for dQ and dK) enter the second
//   products from registers as hi/lo bf16 pairs, two passes each, ~16
//   bits where the reference keeps fp32 (flash_fwd.cu says why one
//   rounding to bf16 is too coarse).
// - The running sums (dQ; dK, dV) accumulate on the tensor cores in fp32
//   and are rounded once to bf16 at the end; d**-0.5 scales dQ and dK
//   there.
// - As the fp32 forms: 4 warps own 64 rows, dQ query rows (q and dO as
//   register fragments) and streams K and V; dK/dV key rows (K and V as
//   register fragments) and streams q, dO, lse and delta; the other
//   side's 64-row tiles double-buffered with 16-byte cp.async (8 bf16;
//   lse and delta 4 bytes), rows padded to 72 values for conflict-free
//   ldmatrix.  The second products read their B tiles with
//   ldmatrix.trans.  Shared memory: 36,864 bytes (dQ), 37,888 (dK/dV).
// What bounds them: 6*d (dQ) and 8*d (dK/dV) flops a visible pair at the
// bf16 tensor-core rate (989 TFLOP/s), against 2-byte rows.
namespace bf16k {

using namespace bf16mma;

constexpr int DQ_STAGE = 2 * TILE;  // K, V
constexpr int DQ_SMEM_BYTES = 2 * DQ_STAGE * (int)sizeof(bf16);  // 36,864
constexpr int DKV_STAGE_BYTES = 2 * TILE_BYTES + 2 * 64 * 4;  // q dO lse δ
constexpr int DKV_SMEM_BYTES = 2 * DKV_STAGE_BYTES;           // 37,888

// dQ: one block per (batch*head, 64-row query tile), looping over the
// visible key tiles up to the diagonal.  Warp w owns query rows q0 + 16w
// .. +15; lane (g, tq) holds rows g and g + 8 of them.
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int t, int causal,
                         float scale) {
  extern __shared__ __align__(16) unsigned char dq_bf16_smem[];
  bf16* stages = reinterpret_cast<bf16*>(dq_bf16_smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // causal: the last query tiles see the most keys: run them first
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * 64;
  const size_t base = (size_t)blockIdx.x * (size_t)t * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  // causal: keys past the tile's last query row are never loaded
  const int nk = causal ? qt + 1 : (t + 63) / 64;

  load_rows(stages, kb, 0, t);
  load_rows(stages + TILE, vb, 0, t);
  cp_async_commit();

  const int qi0 = q0 + 16 * warp + g, qi1 = qi0 + 8;
  uint32_t qa[4][4], da[4][4];  // the A fragments of S and dP
  load_a(qa, q + base, qi0, t, tq, 1.f);
  load_a(da, dout + base, qi0, t, tq, 1.f);
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
      bf16* nxt = stages + ((kt + 1) & 1) * DQ_STAGE;
      load_rows(nxt, kb, (kt + 1) * 64, t);
      load_rows(nxt + TILE, vb, (kt + 1) * 64, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stages + (kt & 1) * DQ_STAGE;
    const bf16* vs = ks + TILE;
    const int k0 = kt * 64;

    // S = q.K^T, then P = exp(S * scale - lse), exactly 0 where masked
    float s[8][4];
    rows_by_tile(s, qa, ks, lane);
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
    rows_by_tile(dp, da, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - (e < 2 ? d0 : d1));

    // dQ += dS.K, dS as a hi/lo bf16 pair
    acc_by_tile(dqa, dp, ks, lane);
    __syncthreads();  // every warp is done with this buffer
  }

  // dQ = dS.K * scale: the scale (a power of two) applied once here
  store_rows(dq + base, dqa, qi0, t, tq, scale, scale);
}

// One dK/dV stage: rows [q0, q0 + 64) of q and dO, and their lse and
// delta (4-byte copies: a head's [t] row need not be 16-byte aligned).
__device__ __forceinline__ void load_stage(unsigned char* st, const bf16* qb,
                                           const bf16* db, const float* lb,
                                           const float* deb, int q0, int t) {
  bf16* rows = reinterpret_cast<bf16*>(st);
  load_rows(rows, qb, q0, t);
  load_rows(rows + TILE, db, q0, t);
  const int r = threadIdx.x & 63;
  const bool ok = q0 + r < t;
  const float* src = threadIdx.x < 64 ? lb : deb;
  cp_async4(reinterpret_cast<float*>(st + 2 * TILE_BYTES) + threadIdx.x,
            src + (ok ? q0 + r : 0), ok);
}

// dK/dV: one block per (batch*head, 64-row key tile), looping over the
// visible query tiles from the diagonal on.  Warp w owns key rows k0 +
// 16w .. +15; lane (g, tq) holds rows g and g + 8 of them, as the rows of
// S^T = K.q^T and dP^T = V.dO^T and of the dK and dV accumulators.
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int t, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char dkv_bf16_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kt = blockIdx.y;  // low tiles see the most queries: run first
  const int k0 = kt * 64;
  const size_t base = (size_t)blockIdx.x * (size_t)t * D;
  const bf16* qb = q + base;
  const bf16* db = dout + base;
  const float* lb = lse + (size_t)blockIdx.x * t;
  const float* deb = delta + (size_t)blockIdx.x * t;
  const int nq = (t + 63) / 64;
  // causal: query rows before the tile's first key see none of it
  const int qt0 = causal ? kt : 0;

  load_stage(dkv_bf16_smem, qb, db, lb, deb, qt0 * 64, t);
  cp_async_commit();

  const int kj0 = k0 + 16 * warp + g, kj1 = kj0 + 8;
  uint32_t ka[4][4], va[4][4];  // the A fragments of S^T and dP^T
  load_a(ka, k + base, kj0, t, tq, 1.f);
  load_a(va, v + base, kj0, t, tq, 1.f);
  float dka[8][4], dva[8][4];  // n-tile n holds dims 8n + 2tq, +1
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int it = qt - qt0;
    if (qt + 1 < nq) {  // the next tile loads while this one is used
      load_stage(dkv_bf16_smem + ((it + 1) & 1) * DKV_STAGE_BYTES, qb, db,
                 lb, deb, (qt + 1) * 64, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* st = dkv_bf16_smem + (it & 1) * DKV_STAGE_BYTES;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* dos = qs + TILE;
    const float* ls = reinterpret_cast<const float*>(st + 2 * TILE_BYTES);
    const float* dls = ls + 64;
    const int q0 = qt * 64;

    // S^T = K.q^T, then P^T = exp(S^T * scale - lse), exactly 0 where
    // masked
    float s[8][4];
    rows_by_tile(s, ka, qs, lane);
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
    // dV += P^T.dO, P^T as a hi/lo bf16 pair
    acc_by_tile(dva, s, dos, lane);

    // dP^T = V.dO^T, then dS^T = P^T * (dP^T - delta) in place
    float dp[8][4];
    rows_by_tile(dp, va, dos, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dls + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
    }
    // dK += dS^T.q, dS^T as a hi/lo bf16 pair
    acc_by_tile(dka, dp, qs, lane);
    __syncthreads();  // every warp is done with this buffer
  }

  // dK = dS^T.(q * scale): the scale (a power of two) applied once here
  store_rows(dk + base, dka, kj0, t, tq, scale, scale);
  store_rows(dv + base, dva, kj0, t, tq, 1.f, 1.f);
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int t,
              int causal, void* stream) {
  const int nq = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, nq);  // under 48 KB of shared memory: no lift
  flash_bwd_dq_bf16_kernel<<<grid, THREADS, DQ_SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int t, int causal, void* stream) {
  const int nk = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nk > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, nk);  // under 48 KB of shared memory: no lift
  flash_bwd_dkv_bf16_kernel<<<grid, THREADS, DKV_SMEM_BYTES,
                              (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, causal,
      0.125f /* 64 ** -0.5 */);
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
// [bh, t, 64]; lse, delta fp32 [bh, t].  Return cudaGetLastError() after
// the launch (0 on success).
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
