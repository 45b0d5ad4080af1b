// Flash-attention forward for Hopper (sm_90a), fp32, head_dim 64.
//
// Replaces stochastic_gradient_push_tpu/ops/flash_attention.py::
// _flash_fwd_kernel (reached through flash_attention_forward).  Same
// function: blocked online-softmax attention with fp32 running (m, den,
// acc) per query row, q scaled by d**-0.5 before the product, and in
// causal mode the key tiles above the diagonal are skipped without being
// loaded (the counterpart of the clamped kv_map there).  Unlike the TPU
// kernel, any sequence length is accepted: rows and columns at or past
// `t` are masked here, so a prompt padded to a multiple of 8 needs no
// block that divides it.
//
// What bounds it on an H100: at the serving prompt lengths (t <= 512,
// d = 64) the work is ~4*t*t*d flops per head in fp32 against ~4*t*d*4
// bytes moved, so the arithmetic, not HBM, is the limit; fp32 FMAs on
// the CUDA cores (67 TFLOP/s) are the roof since the port keeps fp32
// end to end.  The design does what the simple form allows about it:
// each K/V tile is read from HBM once per 64-row query tile and staged in
// shared memory; every thread keeps its quarter of a q row and of the
// accumulator in registers and reads K and V as float4 from shared
// memory (four threads of a row read 64 contiguous bytes: no bank
// conflicts); the row's dot product is finished with two shuffles.
// Tensor cores (wgmma, TMA) are left for a later version.
//
// With a non-null `lse` the kernel also writes each row's logsumexp,
// m + log(den) in the scaled-score units (the TPU kernel's return_lse
// output, `lse_ref` there): the residual the backward kernels in
// flash_bwd.cu recompute the probabilities from.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;             // head dim
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // key rows per shared-memory tile
constexpr int TPR = 4;            // threads per query row
constexpr int THREADS = BQ * TPR; // 256
constexpr int CH = D / (4 * TPR); // float4 chunks per thread (4)

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// One block per (64-row query tile, batch*head).  Thread (row, sub) owns
// dims {16*c + 4*sub .. +3 : c in 0..3} of query row `row`.
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t, int causal,
                     float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + row;
  const size_t base = (size_t)blockIdx.y * (size_t)t * D;

  float4 qr[CH], acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < t) {
      x = *reinterpret_cast<const float4*>(q + base + (size_t)qi * D +
                                           16 * c + 4 * sub);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    qr[c] = x;
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY;
  float den = 0.f;

  // causal: keys past the tile's last query row are never loaded
  const int kend = causal ? min(t, q0 + BQ) : t;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D / 4; i += THREADS) {
      const int r = i / (D / 4);
      const int c4 = i % (D / 4);
      const int kr = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kr < t) {
        kx = reinterpret_cast<const float4*>(k + base + (size_t)kr * D)[c4];
        vx = reinterpret_cast<const float4*>(v + base + (size_t)kr * D)[c4];
      }
      reinterpret_cast<float4*>(&ks[r][0])[c4] = kx;
      reinterpret_cast<float4*>(&vs[r][0])[c4] = vx;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        part += dot4(qr[j], *reinterpret_cast<const float4*>(
                                &ks[c][16 * j + 4 * sub]));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kc = k0 + c;
      const bool visible = kc < t && (!causal || kc <= qi);
      s[c] = visible ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[c]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // nothing visible to this row yet
    const float alpha = expf(m - m_new);  // 0 while m is still -inf
    den *= alpha;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      acc[j].x *= alpha; acc[j].y *= alpha;
      acc[j].z *= alpha; acc[j].w *= alpha;
    }
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float p = expf(s[c] - m_new);  // masked columns give exactly 0
      den += p;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[c][16 * j + 4 * sub]);
        acc[j].x += p * vv.x; acc[j].y += p * vv.y;
        acc[j].z += p * vv.z; acc[j].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (qi < t) {
    const float inv = 1.f / den;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float4 y = acc[j];
      y.x *= inv; y.y *= inv; y.z *= inv; y.w *= inv;
      *reinterpret_cast<float4*>(o + base + (size_t)qi * D + 16 * j +
                                 4 * sub) = y;
    }
    // every row < t sees at least key 0, so den > 0 and m is finite
    if (lse != nullptr && sub == 0)
      lse[(size_t)blockIdx.y * t + qi] = m + logf(den);
  }
}

}  // namespace

// q, k, v, o: contiguous fp32 [bh, t, 64]; lse: fp32 [bh, t] or null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sgp_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int t,
                                 int causal, void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}
