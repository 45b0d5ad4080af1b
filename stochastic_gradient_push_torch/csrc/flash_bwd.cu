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
// needed.  Causal tiles that hold no visible pair are never loaded: the
// dQ loop stops at the tile's diagonal (kv_map's clamp there), the dK/dV
// loop starts at it (q_map's clamp).  Unlike the TPU kernels any sequence
// length is accepted: rows and columns at or past `t` are masked.
//
// What bounds it on an H100: 6*d (dQ) and 8*d (dK/dV) flops per visible
// (q, k) pair against ~O(t*d) bytes per head, so fp32 FMAs on the CUDA
// cores (67 TFLOP/s), not HBM, are the roof.  The design is the forward's
// (flash_fwd.cu): the streamed operand pair (K/V for dQ, Q/dO for dK/dV)
// is staged in shared memory once per block tile, 4 threads own one row
// and keep their 16 of its 64 dims (and their part of the accumulators)
// in registers, read the staged rows as float4 (64 contiguous bytes per
// row group: no bank conflicts, a broadcast across the warp for dK/dV),
// and finish each dot product with two shuffles.  Tensor cores (wgmma,
// TMA) are left for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;             // head dim
constexpr int TPR = 4;            // threads per owned row
constexpr int CH = D / (4 * TPR); // float4 chunks per thread (4)
constexpr int ROWS = 64;          // owned rows per block (q for dQ, k for dK/dV)
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

// dK/dV: one block per (64-row key tile, batch*head), looping over the
// visible 32-row query tiles from the diagonal on.  Thread (row, sub) owns
// dims {16*c + 4*sub .. +3} of key row `row` (and of its dK, dV rows).
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int t, int causal, float scale) {
  __shared__ __align__(16) float qs[BS][D];   // q * scale
  __shared__ __align__(16) float dos[BS][D];
  __shared__ float ls[BS];
  __shared__ float dls[BS];

  const int row = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int k0 = blockIdx.x * ROWS;
  const int kj = k0 + row;
  const size_t base = (size_t)blockIdx.y * (size_t)t * D;
  const float* qb = q + base;
  const float* db = dout + base;
  const float* lb = lse + (size_t)blockIdx.y * t;
  const float* deb = delta + (size_t)blockIdx.y * t;

  float4 kr[CH], vr[CH], dka[CH], dva[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (kj < t) {
      x = ld4(k + base + (size_t)kj * D + 16 * c + 4 * sub);
      y = ld4(v + base + (size_t)kj * D + 16 * c + 4 * sub);
    }
    kr[c] = x;
    vr[c] = y;
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }

  // causal: query rows before the tile's first key see none of it
  for (int q0 = causal ? k0 : 0; q0 < t; q0 += BS) {
    __syncthreads();  // the previous tile is consumed
    stage(qs, dos, qb, db, q0, t, scale);
    if (threadIdx.x < BS) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < t ? lb[r] : 0.f;
      dls[threadIdx.x] = r < t ? deb[r] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BS; ++r) {
      float4 qq[CH], dd[CH];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        qq[j] = ld4(&qs[r][16 * j + 4 * sub]);
        dd[j] = ld4(&dos[r][16 * j + 4 * sub]);
        s += dot4(qq[j], kr[j]);
        dp += dot4(dd[j], vr[j]);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int qr = q0 + r;
      const bool visible = kj < t && qr < t && (!causal || kj <= qr);
      const float p = visible ? expf(s - ls[r]) : 0.f;
      const float ds = p * (dp - dls[r]);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        axpy4(dva[j], p, dd[j]);
        axpy4(dka[j], ds, qq[j]);
      }
    }
  }

  if (kj < t) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const size_t off = base + (size_t)kj * D + 16 * j + 4 * sub;
      *reinterpret_cast<float4*>(dk + off) = dka[j];
      *reinterpret_cast<float4*>(dv + off) = dva[j];
    }
  }
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

// As above, writing dk and dv (contiguous fp32 [bh, t, 64]).
extern "C" int sgp_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int t,
                                     int causal, void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t, causal,
      0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}
