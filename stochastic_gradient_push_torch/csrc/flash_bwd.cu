// Flash-attention backward for Hopper (sm_90a), fp32, head_dim 64: the
// dQ kernel and the dK/dV kernel.
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
// is the limit, and at fp32 accuracy the CUDA cores cap it at 67 TFLOP/s.
//
// dQ (flash_bwd_dq_f32_kernel) still runs on the CUDA cores: the streamed
// K/V tile is staged in shared memory once per block tile, 4 threads own
// one row and keep their 16 of its 64 dims (and their part of the
// accumulator) in registers, read the staged rows as float4 and finish
// each dot product with two shuffles.
//
// dK/dV (flash_bwd_dkv_f32_kernel) runs its four products on the tensor
// cores, fp32-accurate through a 3xTF32 split, as flash_fwd.cu does:
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and
// a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b accumulated in fp32
// (mma.sync m16n8k8 tf32; roof 495/3 = 165 TFLOP/s).  At d64 the splits
// and fragment loads around the products issue more instructions than the
// products, so instruction issue bounds it before that roof.  The design:
// - 4 warps own 64 key rows (16 each).  The block's K and V rows stay
//   resident in shared memory; q and dO tiles of 64 rows, with their lse
//   and delta, stream from the diagonal on, double-buffered with cp.async
//   (rows at or past `t` zero-filled).
// - Per tile, on the tensor cores: S^T = K.q^T, then P^T =
//   exp(S^T * d**-0.5 - lse) in registers and dV += P^T.dO; then
//   dP^T = V.dO^T, dS^T = P^T * (dP^T - delta) in registers and
//   dK += dS^T.q.  The order of the k-terms in a k8 step is free, so dO's
//   and q's k-rows are read in the order the S^T accumulator holds its
//   columns (2t, 2t + 1), and P^T and dS^T feed the second products
//   straight from registers.
// - Every staged row is padded to 68 floats, which keeps both fragment
//   orders (row-major for S^T, dP^T; transposed for dV, dK) free of bank
//   conflicts.  dK and dV stay in registers (64 floats a thread) and are
//   written once; d**-0.5, a power of two, scales dK once at the end.
//   They are running sums over the whole loop, so each tile's product is
//   summed on the tensor cores from zero and added in fp32 (mma3z):
//   carried through the tensor cores' own accumulation, dK and dV would
//   drift as t grows.
// - The key tiles nearest the start see the most queries under the causal
//   mask; they sit first in the grid (grid.y, batch*head on grid.x).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head dim
constexpr int TPR = 4;            // threads per owned row
constexpr int CH = D / (4 * TPR); // float4 chunks per thread (4)
constexpr int ROWS = 64;          // owned query rows per dQ block
constexpr int THREADS = ROWS * TPR;  // 256
constexpr int BS = 32;            // streamed rows per shared-memory tile

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x += a * x.x; acc.y += a * x.y; acc.z += a * x.z; acc.w += a * x.w;
}

__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stage rows [r0, r0 + BS) of two [t, D] operands (zeros past t), the
// first one scaled.
__device__ __forceinline__ void stage(float (*a)[D], float (*b)[D],
                                      const float* ga, const float* gb,
                                      int r0, int t, float scale_a) {
  for (int i = threadIdx.x; i < BS * D / 4; i += THREADS) {
    const int r = i / (D / 4);
    const int c4 = i % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + r < t) {
      x = reinterpret_cast<const float4*>(ga + (size_t)(r0 + r) * D)[c4];
      y = reinterpret_cast<const float4*>(gb + (size_t)(r0 + r) * D)[c4];
      x.x *= scale_a; x.y *= scale_a; x.z *= scale_a; x.w *= scale_a;
    }
    reinterpret_cast<float4*>(&a[r][0])[c4] = x;
    reinterpret_cast<float4*>(&b[r][0])[c4] = y;
  }
}

// dQ: one block per (64-row query tile, batch*head), looping over the
// visible 32-row key tiles.  Thread (row, sub) owns dims
// {16*c + 4*sub .. +3 : c in 0..3} of query row `row`.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int t, int causal,
                        float scale) {
  __shared__ __align__(16) float ks[BS][D];
  __shared__ __align__(16) float vs[BS][D];

  const int row = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + row;
  const size_t base = (size_t)blockIdx.y * (size_t)t * D;
  const float* kb = k + base;
  const float* vb = v + base;

  float4 qr[CH], dor[CH], acc[CH];
  float lse_i = 0.f, delta_i = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (qi < t) {
      x = ld4(q + base + (size_t)qi * D + 16 * c + 4 * sub);
      y = ld4(dout + base + (size_t)qi * D + 16 * c + 4 * sub);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    qr[c] = x;
    dor[c] = y;
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (qi < t) {
    lse_i = lse[(size_t)blockIdx.y * t + qi];
    delta_i = delta[(size_t)blockIdx.y * t + qi];
  }

  // causal: keys past the tile's last query row are never loaded
  const int kend = causal ? min(t, q0 + ROWS) : t;
  for (int k0 = 0; k0 < kend; k0 += BS) {
    __syncthreads();  // the previous tile is consumed
    stage(ks, vs, kb, vb, k0, t, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BS; ++c) {
      float4 kk[CH];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        kk[j] = ld4(&ks[c][16 * j + 4 * sub]);
        s += dot4(qr[j], kk[j]);
        dp += dot4(dor[j], ld4(&vs[c][16 * j + 4 * sub]));
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int kc = k0 + c;
      const bool visible = qi < t && kc < t && (!causal || kc <= qi);
      const float p = visible ? expf(s - lse_i) : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int j = 0; j < CH; ++j) axpy4(acc[j], ds, kk[j]);
    }
  }

  if (qi < t) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float4 y = acc[j];
      y.x *= scale; y.y *= scale; y.z *= scale; y.w *= scale;
      *reinterpret_cast<float4*>(dq + base + (size_t)qi * D + 16 * j +
                                 4 * sub) = y;
    }
  }
}

// -- dK/dV on the tensor cores ----------------------------------------------

constexpr int DKV_THREADS = 128;   // 4 warps, 16 owned key rows each
constexpr int SS = D + 4;          // row stride (floats) of every staged tile
constexpr int TILE = 64 * SS;      // one staged 64-row tile (floats)
constexpr int DKV_STAGE = 2 * TILE + 2 * 64;  // q, dO, lse, delta
constexpr int DKV_SMEM_BYTES =
    (2 * TILE + 2 * DKV_STAGE) * (int)sizeof(float);  // 105,472

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
// sums (o in the forward, dK and dV) take one tile's product at a time
// from them, summed from zero, and add it in fp32.
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

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
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

// Stage rows [r0, r0 + 64) of a [t, 64] matrix into `dst` (row stride
// SS), zeros past t.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int t) {
#pragma unroll
  for (int j = 0; j < 64 * D / 4 / DKV_THREADS; ++j) {
    const int i = threadIdx.x + j * DKV_THREADS;
    const int r = i >> 4, c4 = i & 15;
    const bool ok = r0 + r < t;
    cp_async(dst + r * SS + 4 * c4,
             src + (size_t)(ok ? r0 + r : 0) * D + 4 * c4, 16, ok);
  }
}

// One stage: rows [q0, q0 + 64) of q and dO, and their lse and delta
// (4-byte copies: a head's [t] row need not be 16-byte aligned).
__device__ __forceinline__ void load_stage(float* st, const float* qb,
                                           const float* db, const float* lb,
                                           const float* deb, int q0, int t) {
  load_rows(st, qb, q0, t);
  load_rows(st + TILE, db, q0, t);
  const int r = threadIdx.x & 63;
  const bool ok = q0 + r < t;
  const float* src = threadIdx.x < 64 ? lb : deb;
  cp_async(st + 2 * TILE + threadIdx.x, src + (ok ? q0 + r : 0), 4, ok);
}

// c = A.B^T for one warp: A's 16 resident rows (`a` at row g, and g + 8
// below it) against the 64 rows of a staged tile `b`.  n-tile n of c holds
// b's rows 8n + 2tq, +1; k-step st covers dims 8st + tq (k index tq) and
// 8st + tq + 4.
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

// dK/dV: one block per (batch*head, 64-row key tile), looping over the
// visible 64-row query tiles from the diagonal on.  Warp w owns key rows
// k0 + 16w .. +15; lane (g = lane / 4, tq = lane % 4) holds rows g and
// g + 8 of them, as the rows of S^T = K.q^T and dP^T = V.dO^T and of the
// dK and dV accumulators.
__global__ void __launch_bounds__(DKV_THREADS, 2)
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

// Lift the dK/dV kernel's dynamic shared memory above 48 KB, once per
// device.
int dkv_smem_ready[64];

int allow_dkv_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (dkv_smem_ready[dev]) return 0;
  err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM_BYTES);
  if (err == cudaSuccess) dkv_smem_ready[dev] = 1;
  return (int)err;
}

}  // namespace

// q, k, v, dout, dq: contiguous fp32 [bh, t, 64]; lse, delta: fp32
// [bh, t].  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sgp_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int bh, int t, int causal,
                                    void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

// As above, writing dk and dv (contiguous fp32 [bh, t, 64]).  Returns the
// error of the shared-memory attribute or cudaGetLastError() after the
// launch (0 on success).
extern "C" int sgp_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int t,
                                     int causal, void* stream) {
  const int nk = (t + 63) / 64;
  if (bh <= 0 || t <= 0 || nk > 65535) return (int)cudaErrorInvalidValue;
  if (int err = allow_dkv_smem()) return err;
  const dim3 grid(bh, nk);
  flash_bwd_dkv_f32_kernel<<<grid, DKV_THREADS, DKV_SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t, causal,
      0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}
