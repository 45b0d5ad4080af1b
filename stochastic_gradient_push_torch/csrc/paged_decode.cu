// Paged-attention decode for Hopper (sm_90a), fp32, head_dim 64, GQA.
//
// Replaces stochastic_gradient_push_tpu/serve/paged_attention.py::
// _paged_decode_kernel (reached through paged_attention_decode).  Same
// function: one new query token per sequence attends over the sequence's
// KV pages, named by an int32 page_indices row and a length; pages past
// the length are never read (a bad id among those read traps); online
// softmax in fp32 across pages; the `group` query heads of a kv head
// share every streamed page.  Where the TPU kernel scalar-prefetched
// page_indices/lengths ahead of its grid, each block reads its own row
// and length.
//
// What bounds it on an H100: bytes.  Every K/V element read is used for
// 2*group flops, far below the ~20 flops/byte the card needs before fp32
// compute binds, so the roof is streaming len*2*64*4 bytes per (sequence,
// kv head) at 3.35 TB/s.  Reaching it takes many bytes in flight, and a
// grid whose work follows the total number of cached tokens rather than
// the longest sequence.  So the decode runs split-sequence, in two
// kernels on one stream:
// - paged_decode_split_kernel: one block of 4 warps per (split, kv head,
//   sequence).  A split is `split_pages` consecutive pages of the
//   sequence (the wrapper picks ~64 tokens); splits past the length exit
//   at once.  Warp w takes the split's pages w, w + 4, ... in groups of 8
//   tokens; lane l owns dims 2l, 2l + 1 and reads a token's K and V rows
//   as one coalesced 256-byte float2 load each.  The next group's 16
//   loads are issued before the current group is used (a register double
//   buffer), and its 8 dot products reduce as independent shuffle chains.
//   Each warp keeps its own online-softmax state; the block combines its
//   warps through shared memory and writes the split's partial
//   (m, den, acc[group][64]) to the workspace.
// - paged_decode_combine_kernel: one block per (kv head, sequence) folds
//   the sequence's partials in split order into the output.  The order is
//   fixed, so the result is bit-identical from run to run, and no atomics
//   or counters are needed (the launch pair can be captured in a CUDA
//   graph).  A length of 0 has no split and gives zeros.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;
constexpr int WARPS = 4;
constexpr int TOK = 8;  // tokens per inner step
constexpr unsigned FULL = 0xffffffffu;

// the pages of a sequence of `len` tokens that the kernel reads
__device__ __forceinline__ int pages_of(int len, int page_size,
                                        int max_pages) {
  return min(max((len + page_size - 1) / page_size, 0), max_pages);
}

// Load tokens [t0, t0 + TOK) of page `j` of the row (zeros at or past
// `ntok`): lane l's float2 of each token's K and V rows.
__device__ __forceinline__ void load_group(float2 (&kk)[TOK],
                                           float2 (&vv)[TOK],
                                           const float2* kh, const float2* vh,
                                           const int* prow, int j, int t0,
                                           int ntok, int num_pages,
                                           int page_size, int lane) {
  const int pid = prow[j];
  if ((unsigned)pid >= (unsigned)num_pages) __trap();  // bad page id
  const size_t row0 = ((size_t)pid * page_size + t0) * (D / 2) + lane;
#pragma unroll
  for (int i = 0; i < TOK; ++i) {
    const bool ok = t0 + i < ntok;
    kk[i] = ok ? kh[row0 + (size_t)i * (D / 2)] : make_float2(0.f, 0.f);
    vv[i] = ok ? vh[row0 + (size_t)i * (D / 2)] : make_float2(0.f, 0.f);
  }
}

// (A floor of 1 block per SM in the launch bounds lets ptxas give the
// larger groups the registers they hold, up to 252 at G = 8; without it,
// it capped them lower and G = 6 and 8 spilled.)
template <int G>
__global__ void __launch_bounds__(WARPS * 32, 1)
paged_decode_split_kernel(const float* __restrict__ q,   // [B, hkv*G, D]
                          const float* __restrict__ kp,  // [hkv, P, S, D]
                          const float* __restrict__ vp,  // [hkv, P, S, D]
                          const int* __restrict__ page_indices,  // [B, maxp]
                          const int* __restrict__ lengths,       // [B]
                          float* __restrict__ part_acc,  // [B, hkv, ns, G, D]
                          float* __restrict__ part_md,   // [B, hkv, ns, G, 2]
                          int hkv, int num_pages, int page_size,
                          int max_pages, int split_pages, float scale) {
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_den[WARPS][G];
  __shared__ float2 sm_acc[WARPS][G][32];

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const int n_pages = pages_of(len, page_size, max_pages);
  const int p0 = sp * split_pages;
  if (p0 >= n_pages) return;  // a split past the length
  const int p_end = min(p0 + split_pages, n_pages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

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
  const size_t head_off = (size_t)h * num_pages * page_size * (D / 2);
  const float2* kh = reinterpret_cast<const float2*>(kp) + head_off;
  const float2* vh = reinterpret_cast<const float2*>(vp) + head_off;
  // tokens of page j that the sequence holds
  auto page_tokens = [&](int j) {
    return min(page_size, len - j * page_size);
  };

  // this warp's groups: pages p0 + warp, + WARPS, ..., TOK tokens at a time
  int j = p0 + warp, t0 = 0;
  float2 kk[TOK], vv[TOK], kn[TOK], vn[TOK];
  if (j < p_end)
    load_group(kk, vv, kh, vh, prow, j, t0, page_tokens(j), num_pages,
               page_size, lane);
  while (j < p_end) {
    const int ntok = page_tokens(j);
    int jn = j, tn = t0 + TOK;
    if (tn >= ntok) {
      jn = j + WARPS;
      tn = 0;
    }
    if (jn < p_end)  // the next group loads while this one is used
      load_group(kn, vn, kh, vh, prow, jn, tn, page_tokens(jn), num_pages,
                 page_size, lane);
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
          s[i] += __shfl_xor_sync(FULL, s[i], off);
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
#pragma unroll
    for (int i = 0; i < TOK; ++i) {
      kk[i] = kn[i];
      vv[i] = vn[i];
    }
    j = jn;
    t0 = tn;
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

  // the split's partial, relative to the max over its warps (finite:
  // warp 0 holds the split's first page)
  const size_t part = (((size_t)b * hkv + h) * gridDim.x + sp) * G;
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
    reinterpret_cast<float2*>(part_acc + (part + g) * D)[lane] = o;
    if (lane == 0)
      reinterpret_cast<float2*>(part_md)[part + g] = make_float2(mx, tot);
  }
}

// One block of 32 * G threads per (kv head, sequence); warp g folds head
// g's partials in split order.
template <int G>
__global__ void __launch_bounds__(G * 32)
paged_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_md,
                            const int* __restrict__ lengths,
                            float* __restrict__ out,  // [B, hkv*G, D]
                            int hkv, int page_size, int max_pages,
                            int split_pages, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pages = pages_of(lengths[b], page_size, max_pages);
  const int ns = (n_pages + split_pages - 1) / split_pages;
  const size_t part = ((size_t)b * hkv + h) * n_splits * G + g;
  const float2* md = reinterpret_cast<const float2*>(part_md) + part;
  const float2* pa = reinterpret_cast<const float2*>(part_acc + part * D);

  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, md[(size_t)s * G].x);
  float tot = 0.f;
  float2 o = make_float2(0.f, 0.f);
  for (int s = 0; s < ns; ++s) {
    const float2 st = md[(size_t)s * G];
    const float c = expf(st.x - mx);
    const float2 a = pa[(size_t)s * G * (D / 2) + lane];
    tot += st.y * c;
    o.x += a.x * c;
    o.y += a.y * c;
  }
  const float inv = tot > 0.f ? 1.f / tot : 0.f;  // length 0: zeros
  reinterpret_cast<float2*>(out + (((size_t)b * hkv + h) * G + g) * D)[lane] =
      make_float2(o.x * inv, o.y * inv);
}

template <int G>
int launch(const void* q, const void* kp, const void* vp, const void* pi,
           const void* lens, void* out, void* work, int batch, int hkv,
           int num_pages, int page_size, int max_pages, int split_pages,
           cudaStream_t stream) {
  const int ns = (max_pages + split_pages - 1) / split_pages;
  float* part_acc = static_cast<float*>(work);
  float* part_md = part_acc + (size_t)batch * hkv * ns * G * D;
  paged_decode_split_kernel<G><<<dim3(ns, hkv, batch), WARPS * 32, 0,
                                 stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int*>(pi),
      static_cast<const int*>(lens), part_acc, part_md, hkv, num_pages,
      page_size, max_pages, split_pages, 0.125f /* 64 ** -0.5 */);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  paged_decode_combine_kernel<G><<<dim3(hkv, batch), G * 32, 0, stream>>>(
      part_acc, part_md, static_cast<const int*>(lens),
      static_cast<float*>(out), hkv, page_size, max_pages, split_pages, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out: contiguous fp32 [batch, hkv*group, 64]; k/v pages: contiguous fp32
// [hkv, num_pages, page_size, 64]; page_indices: int32 [batch, max_pages];
// lengths: int32 [batch]; work: fp32, at least
// batch * hkv * ceil(max_pages / split_pages) * group * 66 floats.
// group in 1..8.  Returns cudaGetLastError() after the launches.
extern "C" int sgp_paged_decode_f32(const void* q, const void* kp,
                                    const void* vp, const void* page_indices,
                                    const void* lengths, void* out,
                                    void* work, int batch, int hkv,
                                    int group, int num_pages, int page_size,
                                    int max_pages, int split_pages,
                                    void* stream) {
  if (batch <= 0 || hkv <= 0 || page_size <= 0 || max_pages <= 0 ||
      split_pages <= 0 || batch > 65535 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SGP_PAGED_CASE(G)                                                  \
  case G:                                                                  \
    return launch<G>(q, kp, vp, page_indices, lengths, out, work, batch,  \
                     hkv, num_pages, page_size, max_pages, split_pages, s);
  switch (group) {
    SGP_PAGED_CASE(1)
    SGP_PAGED_CASE(2)
    SGP_PAGED_CASE(3)
    SGP_PAGED_CASE(4)
    SGP_PAGED_CASE(5)
    SGP_PAGED_CASE(6)
    SGP_PAGED_CASE(7)
    SGP_PAGED_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SGP_PAGED_CASE
}
