// Flash-attention forward for Hopper (sm_90a), head_dim 64: an fp32 form
// (3xTF32) and a bf16 form (below, after the fp32 one).
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
// What bounds it on an H100: ~4*t*t*d flops per head against ~4*t*d*4
// bytes moved, so the arithmetic, not HBM, is the limit.  The port keeps
// fp32 accuracy, which on the CUDA cores caps it at 67 TFLOP/s; a single
// TF32 pass on the tensor cores keeps only ~5e-4 relative per score at
// d64, too coarse for the 1e-4 the kernels are held to.  So every product
// runs on the tensor cores as three TF32 products of a hi/lo split
// (3xTF32, the helpers in tf32_mma.cuh).  Its roof is 495/3 = 165
// TFLOP/s of fp32-accurate products; at d64 the loop around the products
// (splits, fragment loads, softmax) issues more instructions than the
// products themselves, so it is bound by instruction issue well before
// that roof.
//
// The design:
// - 4 warps own 64 query rows (16 each); key/value tiles of 64 rows are
//   staged in shared memory double-buffered with cp.async (16-byte
//   copies, rows at or past `t` zero-filled), so a tile's load overlaps
//   the previous tile's products.
// - q (scaled) is split into hi/lo once and kept in registers as the A
//   fragments of S = q.k^T; K and V are split as their fragments are read.
//   K rows are padded to 72 floats and read 8 bytes at a time, V rows to
//   68 floats and read 4 bytes at a time: both without bank conflicts.
// - The order of the k-terms inside one k8 step is free.  S's
//   accumulator holds columns (2t, 2t+1) of a row where the A fragment of
//   P.V wants (t, t+4), so V's k-rows are read in that permuted order and
//   P feeds the second product straight from registers.  The same freedom
//   lets q.k^T read dims (2t, 2t+1) as one float2.
// - Row max and sum are reduced across the 4 threads of an mma quad once
//   per 64-key tile; each exp is evaluated once per score.
// - The running sum o is carried in fp32 registers: each tile's P.V is
//   summed on the tensor cores from zero and folded in with one fp32 FMA,
//   o = o * alpha + P.V (mma3z), so o does not drift with t.
// - Causal: tiles above the diagonal are never loaded, only the diagonal
//   tile (and a ragged last tile) is masked, and the q-tiles are launched
//   heaviest first (grid.y reversed, batch*head on grid.x) so the longest
//   blocks do not form the tail.
//
// With a non-null `lse` the kernel also writes each row's logsumexp,
// m + log(den) in the scaled-score units (the TPU kernel's return_lse
// output, `lse_ref` there): the residual the backward kernels in
// flash_bwd.cu recompute the probabilities from.

#include <math.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {
namespace f32 {

using namespace tf32mma;

constexpr int BQ = 64;              // query rows per block (16 per warp)
constexpr int BK = 64;              // key rows per streamed tile
constexpr int KS = D + 8;           // K tile row stride (floats)
constexpr int VS = D + 4;           // V tile row stride (floats)
constexpr int STAGE = BK * KS + BK * VS;                  // floats
constexpr int SMEM_BYTES = 2 * STAGE * (int)sizeof(float);  // 71,680
constexpr unsigned FULL = 0xffffffffu;

// One block per (batch*head, 64-row query tile).  Warp w owns rows
// q0 + 16w .. +15; lane (g = lane / 4, tq = lane % 4) holds rows g and
// g + 8 of it in the mma fragment layouts.
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t, int causal,
                     float scale) {
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const size_t base = (size_t)blockIdx.x * (size_t)t * D;
  const float* kb = k + base;
  const float* vb = v + base;
  // causal: keys past the tile's last query row are never loaded
  const int nk = causal ? qt + 1 : (t + BK - 1) / BK;

  load_rows<KS>(smem, kb, 0, t);
  load_rows<VS>(smem + BK * KS, vb, 0, t);
  cp_async_commit();

  // q fragments: k-step s covers dims 8s + 2tq (k index tq) and
  // 8s + 2tq + 1 (k index tq + 4)
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float2 x0 = make_float2(0.f, 0.f), x1 = x0;
    if (r0 < t)
      x0 = *reinterpret_cast<const float2*>(q + base + (size_t)r0 * D +
                                            8 * s + 2 * tq);
    if (r1 < t)
      x1 = *reinterpret_cast<const float2*>(q + base + (size_t)r1 * D +
                                            8 * s + 2 * tq);
    split(x0.x * scale, qh[s][0], ql[s][0]);
    split(x1.x * scale, qh[s][1], ql[s][1]);
    split(x0.y * scale, qh[s][2], ql[s][2]);
    split(x1.y * scale, qh[s][3], ql[s][3]);
  }

  float acc[8][4];  // o: n-tile n holds dims 8n + 2tq, +1 of rows r0, r1
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile loads while this one is used
      float* nxt = smem + ((kt + 1) & 1) * STAGE;
      load_rows<KS>(nxt, kb, (kt + 1) * BK, t);
      load_rows<VS>(nxt + BK * KS, vb, (kt + 1) * BK, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smem + (kt & 1) * STAGE;
    const float* vs = ks + BK * KS;
    const int k0 = kt * BK;

    // S = (q * scale) . k^T: n-tile n holds keys k0 + 8n + 2tq, +1
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < 8; ++st) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(
            ks + (8 * n + g) * KS + 8 * st + 2 * tq);
        uint32_t bh0, bl0, bh1, bl1;
        split(b.x, bh0, bl0);
        split(b.y, bh1, bl1);
        mma3(s[n], qh[st], ql[st], bh0, bh1, bl0, bl1);
      }
    }

    if ((causal && kt == qt) || k0 + BK > t) {  // diagonal or ragged tile
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= t || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    // a row that sees nothing yet keeps m = -inf: subtract 0 so that its
    // masked scores give exp(-inf) = 0, not NaN
    const float b0 = mx0 == -INFINITY ? 0.f : mx0;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1;
    const float al0 = expf(m0 - b0), al1 = expf(m1 - b1);  // 0 from -inf
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - b0); s[n][1] = expf(s[n][1] - b0);
      s[n][2] = expf(s[n][2] - b1); s[n][3] = expf(s[n][3] - b1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // o = o * alpha + P . V: the tile's product summed on the tensor cores
    // from zero, added to o in fp32.  k-step j covers keys k0 + 8j .. +7
    // with k index tq -> key 2tq and tq + 4 -> key 2tq + 1, so P's
    // accumulator is the A fragment as it stands
    float pv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const float* vr = vs + (8 * j + 2 * tq) * VS + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // dims 8n + g
        uint32_t bh0, bl0, bh1, bl1;
        split(vr[8 * n], bh0, bl0);
        split(vr[VS + 8 * n], bh1, bl1);
        if (j == 0)
          mma3z(pv[n], ph, pl, bh0, bh1, bl0, bl1);
        else
          mma3(pv[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] = fmaf(acc[n][0], al0, pv[n][0]);
      acc[n][1] = fmaf(acc[n][1], al0, pv[n][1]);
      acc[n][2] = fmaf(acc[n][2], al1, pv[n][2]);
      acc[n][3] = fmaf(acc[n][3], al1, pv[n][3]);
    }
    __syncthreads();  // every warp is done with this buffer
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  // every row < t sees at least key 0, so den > 0 and m is finite
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (r0 < t)
      *reinterpret_cast<float2*>(o + base + (size_t)r0 * D + 8 * n +
                                 2 * tq) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < t)
      *reinterpret_cast<float2*>(o + base + (size_t)r1 * D + 8 * n +
                                 2 * tq) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (lse != nullptr && tq == 0) {
    float* lb = lse + (size_t)blockIdx.x * t;
    if (r0 < t) lb[r0] = m0 + logf(l0);
    if (r1 < t) lb[r1] = m1 + logf(l1);
  }
}

// the kernel's dynamic shared memory is lifted above 48 KB once per device
int smem_ready[64];

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int t, int causal, void* stream) {
  const int nq = (t + BQ - 1) / BQ;
  if (bh <= 0 || t <= 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  if (int err = allow_dynamic_smem((const void*)flash_fwd_f32_kernel,
                                   SMEM_BYTES, smem_ready))
    return err;
  const dim3 grid(bh, nq);
  flash_fwd_f32_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

}  // namespace f32

// The bf16 form: the same function on bf16 q, k, v and o, with lse in
// fp32, as the TPU kernel computes it for bf16 inputs (it widens them to
// fp32, scales q by d**-0.5 before the product, accumulates in fp32 and
// rounds o once to the input type).
//
// - S = (q * d**-0.5) . k^T is one bf16 mma.sync pass (m16n8k16) with
//   fp32 accumulation.  The product of two bf16 values is exact in fp32,
//   so S is the reference's widened fp32 dot product up to the order of
//   the sum.  At head_dim 64, d**-0.5 = 0.125 is a power of two, so q is
//   scaled in bf16 exactly, once, as its fragments are loaded.
// - P = exp(S - m) stays in the S accumulators in fp32 for the row max,
//   the row sum and the lse, and enters P.V straight from registers
//   (n-tiles 2j, 2j + 1 of S are the k-step j fragment) as a hi/lo bf16
//   pair, two passes: ~16 bits of P where the reference keeps fp32.  P
//   and dS rounded once to bf16 (a relative 2**-9 on each term of a sum)
//   moved a small LM step's grad norm by 1.1e-4 relative in a model of
//   this arithmetic, more than all the step's other bf16 roundings
//   together (8.5e-5), and failed chip_smoke.py's step check (12a).
// - The running o is rescaled by alpha in fp32 and P.V accumulated into
//   it on the tensor cores; o is rounded once to bf16 at the end and lse
//   written in fp32.
// - 4 warps own 64 query rows (q's fragments in registers); K and V tiles
//   of 64 rows stream through shared memory double-buffered with 16-byte
//   cp.async (8 bf16 values; rows at or past t zero-filled, causal tiles
//   above the diagonal never loaded), rows padded to 72 values (144 bytes)
//   so the ldmatrix phases are free of bank conflicts.  K's B fragments
//   come from ldmatrix, V's from ldmatrix.trans.  36,864 bytes of shared
//   memory a block.
// What bounds it: 4*d flops a visible pair at the bf16 tensor-core rate
// (989 TFLOP/s) against 2-byte rows; at B8 T1024 the two bounds are
// close (chip_smoke.py prints both).
namespace bf16k {

using namespace bf16mma;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int STAGE = 2 * TILE;                              // K, V
constexpr int SMEM_BYTES = 2 * STAGE * (int)sizeof(bf16);    // 36,864
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int t, int causal,
                      float scale) {
  extern __shared__ __align__(16) unsigned char fwd_bf16_smem[];
  bf16* sm = reinterpret_cast<bf16*>(fwd_bf16_smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const size_t base = (size_t)blockIdx.x * (size_t)t * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  // causal: keys past the tile's last query row are never loaded
  const int nk = causal ? qt + 1 : (t + BK - 1) / BK;

  load_rows(sm, kb, 0, t);
  load_rows(sm + TILE, vb, 0, t);
  cp_async_commit();

  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  uint32_t qa[4][4];  // q * scale, the A fragments of S
  load_a(qa, q + base, r0, t, tq, scale);

  float acc[8][4];  // o: n-tile n holds dims 8n + 2tq, +1 of rows r0, r1
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {  // the next tile loads while this one is used
      bf16* nxt = sm + ((kt + 1) & 1) * STAGE;
      load_rows(nxt, kb, (kt + 1) * BK, t);
      load_rows(nxt + TILE, vb, (kt + 1) * BK, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = sm + (kt & 1) * STAGE;
    const bf16* vs = ks + TILE;
    const int k0 = kt * BK;

    // S = (q * scale) . k^T: n-tile n holds keys k0 + 8n + 2tq, +1
    float s[8][4];
    rows_by_tile(s, qa, ks, lane);

    if ((causal && kt == qt) || k0 + BK > t) {  // diagonal or ragged tile
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= t || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    // a row that sees nothing yet keeps m = -inf: subtract 0 so that its
    // masked scores give exp(-inf) = 0, not NaN
    const float b0 = mx0 == -INFINITY ? 0.f : mx0;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1;
    const float al0 = expf(m0 - b0), al1 = expf(m1 - b1);  // 0 from -inf
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - b0); s[n][1] = expf(s[n][1] - b0);
      s[n][2] = expf(s[n][2] - b1); s[n][3] = expf(s[n][3] - b1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }
    // o += P . V, P as a hi/lo bf16 pair
    acc_by_tile(acc, s, vs, lane);
    __syncthreads();  // every warp is done with this buffer
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  // every row < t sees at least key 0, so den > 0 and m is finite
  store_rows(o + base, acc, r0, t, tq, 1.f / l0, 1.f / l1);
  if (lse != nullptr && tq == 0) {
    float* lb = lse + (size_t)blockIdx.x * t;
    if (r0 < t) lb[r0] = m0 + logf(l0);
    if (r1 < t) lb[r1] = m1 + logf(l1);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int t, int causal, void* stream) {
  const int nq = (t + BQ - 1) / BQ;
  if (bh <= 0 || t <= 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, nq);  // under 48 KB of shared memory: no lift
  flash_fwd_bf16_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), t, causal, 0.125f /* 64 ** -0.5 */);
  return (int)cudaGetLastError();
}

}  // namespace bf16k
}  // namespace

// q, k, v, o: contiguous fp32 [bh, t, 64]; lse: fp32 [bh, t] or null.
// Returns the error of the shared-memory attribute or cudaGetLastError()
// after the launch (0 on success).
extern "C" int sgp_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int t,
                                 int causal, void* stream) {
  return f32::launch(q, k, v, o, lse, bh, t, causal, stream);
}

// q, k, v, o: contiguous bf16 [bh, t, 64]; lse: fp32 [bh, t] or null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sgp_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int bh,
                                  int t, int causal, void* stream) {
  return bf16k::launch(q, k, v, o, lse, bh, t, causal, stream);
}
