// Paged-attention decode for Hopper (sm_90a), fp32, head_dim 64, GQA.
//
// Replaces stochastic_gradient_push_tpu/serve/paged_attention.py::
// _paged_decode_kernel (reached through paged_attention_decode).  Same
// function: one new query token per sequence attends over the sequence's
// KV pages, named by an int32 page_indices row and a length; pages past
// the length are never read; online softmax in fp32 across pages; the
// `group` query heads of a kv head share every streamed page.  Where the
// TPU kernel scalar-prefetched page_indices/lengths ahead of its grid,
// each block here reads its own row and length.
//
// What bounds it on an H100: bytes.  Every K/V element read is used for
// 2*group flops, far below the ~20 flops/byte the card needs before fp32
// compute binds, so the roof is streaming len*2*64*4 bytes per (sequence,
// kv head) at 3.35 TB/s.  The design: one block per (kv head, sequence)
// and four warps that split the sequence's pages between them, each with
// its own online-softmax state (combined through shared memory at the
// end), so four page streams are in flight per block; a warp reads a
// token's 64-float K and V rows as one coalesced 256-byte float2 load
// each, eight tokens at a time, so sixteen loads are issued before the
// first is used, and the eight dot products reduce as independent
// shuffle chains.  cp.async/TMA staging is left for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;
constexpr int WARPS = 4;
constexpr int TOK = 8;  // tokens per inner step

template <int G>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_f32_kernel(const float* __restrict__ q,    // [B, hkv*G, D]
                        const float* __restrict__ kp,   // [hkv, P, S, D]
                        const float* __restrict__ vp,   // [hkv, P, S, D]
                        const int* __restrict__ page_indices,  // [B, maxp]
                        const int* __restrict__ lengths,       // [B]
                        float* __restrict__ out,              // [B, hkv*G, D]
                        int hkv, int num_pages, int page_size, int max_pages,
                        float scale) {
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_den[WARPS][G];
  __shared__ float2 sm_acc[WARPS][G][32];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = lengths[b];
  const int n_pages = min(max((len + page_size - 1) / page_size, 0), max_pages);

  // lane owns dims 2*lane, 2*lane+1 of every head of the group
  const float2* qrow =
      reinterpret_cast<const float2*>(q + ((size_t)b * hkv + h) * G * D);
  float2 qv[G], acc[G];
  float m[G], den[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float2 x = qrow[g * (D / 2) + lane];
    qv[g] = make_float2(x.x * scale, x.y * scale);
    acc[g] = make_float2(0.f, 0.f);
    m[g] = -INFINITY;
    den[g] = 0.f;
  }

  const int* prow = page_indices + (size_t)b * max_pages;
  for (int j = warp; j < n_pages; j += WARPS) {
    const int pid = prow[j];
    if ((unsigned)pid >= (unsigned)num_pages) __trap();  // bad page id
    const size_t page_off =
        ((size_t)h * num_pages + (size_t)pid) * page_size * D;
    const float2* kpage = reinterpret_cast<const float2*>(kp + page_off);
    const float2* vpage = reinterpret_cast<const float2*>(vp + page_off);
    const int ntok = min(page_size, len - j * page_size);
    for (int t0 = 0; t0 < ntok; t0 += TOK) {
      float2 kk[TOK], vv[TOK];
#pragma unroll
      for (int i = 0; i < TOK; ++i) {
        const bool ok = t0 + i < ntok;
        kk[i] = ok ? kpage[(t0 + i) * (D / 2) + lane] : make_float2(0.f, 0.f);
        vv[i] = ok ? vpage[(t0 + i) * (D / 2) + lane] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[TOK];
#pragma unroll
        for (int i = 0; i < TOK; ++i)
          s[i] = qv[g].x * kk[i].x + qv[g].y * kk[i].y;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int i = 0; i < TOK; ++i)
            s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        }
        float tile_max = -INFINITY;
#pragma unroll
        for (int i = 0; i < TOK; ++i) {
          if (t0 + i >= ntok) s[i] = -INFINITY;
          tile_max = fmaxf(tile_max, s[i]);
        }
        const float m_new = fmaxf(m[g], tile_max);  // finite: token t0 is valid
        const float alpha = expf(m[g] - m_new);      // 0 while m is -inf
        float psum = 0.f;
        float2 pv = make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < TOK; ++i) {
          const float p = expf(s[i] - m_new);
          psum += p;
          pv.x += p * vv[i].x;
          pv.y += p * vv[i].y;
        }
        den[g] = den[g] * alpha + psum;
        acc[g].x = acc[g].x * alpha + pv.x;
        acc[g].y = acc[g].y * alpha + pv.y;
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_den[warp][g] = den[g];
    }
    sm_acc[warp][g][lane] = acc[g];
  }
  __syncthreads();

  float2* orow = reinterpret_cast<float2*>(out + ((size_t)b * hkv + h) * G * D);
  for (int g = warp; g < G; g += WARPS) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float tot = 0.f;
    float2 o = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = sm_m[w][g];
      const float c = (mw == -INFINITY) ? 0.f : expf(mw - mx);
      tot += sm_den[w][g] * c;
      o.x += sm_acc[w][g][lane].x * c;
      o.y += sm_acc[w][g][lane].y * c;
    }
    const float inv = tot > 0.f ? 1.f / tot : 0.f;  // length 0: zeros
    orow[g * (D / 2) + lane] = make_float2(o.x * inv, o.y * inv);
  }
}

template <int G>
int launch(const void* q, const void* kp, const void* vp, const void* pi,
           const void* lens, void* out, int batch, int hkv, int num_pages,
           int page_size, int max_pages, cudaStream_t stream) {
  const dim3 grid(hkv, batch);
  paged_decode_f32_kernel<G><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int*>(pi),
      static_cast<const int*>(lens), static_cast<float*>(out), hkv,
      num_pages, page_size, max_pages, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out: contiguous fp32 [batch, hkv*group, 64]; k/v pages: contiguous fp32
// [hkv, num_pages, page_size, 64]; page_indices: int32 [batch, max_pages];
// lengths: int32 [batch].  group in 1..8.  Returns cudaGetLastError().
extern "C" int sgp_paged_decode_f32(const void* q, const void* kp,
                                    const void* vp, const void* page_indices,
                                    const void* lengths, void* out, int batch,
                                    int hkv, int group, int num_pages,
                                    int page_size, int max_pages,
                                    void* stream) {
  if (batch <= 0 || hkv <= 0 || page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 1: return launch<1>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 2: return launch<2>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 3: return launch<3>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 4: return launch<4>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 5: return launch<5>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 6: return launch<6>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 7: return launch<7>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    case 8: return launch<8>(q, kp, vp, page_indices, lengths, out, batch, hkv, num_pages, page_size, max_pages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
