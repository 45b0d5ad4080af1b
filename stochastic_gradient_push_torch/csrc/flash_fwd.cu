// Flash-attention forward for Hopper (sm_90a), head_dim 64: an fp32 form
// (3xTF32 on mma.sync) and a bf16 form (wgmma fed by TMA; below, after
// the fp32 one).
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
#include "sm90_bf16.cuh"
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
// rounds o once to the input type), built on Hopper's wgmma fed by TMA
// (sm90_bf16.cuh).
//
// What bounds it on an H100: 4*d flops a visible pair at the bf16 tensor-
// core rate (989 TFLOP/s) against 2-byte rows and the fp32 lse at 3.35
// TB/s: at B8 H12 T1024 causal the bytes bound (0.0151 ms) is just above
// the operations bound (0.0130 ms).  P's hi/lo pass makes it 6*d flops of
// tensor-core work a pair, and the softmax's exp and the split run on the
// CUDA cores beside the products, so the kernel is bound by how well
// the two overlap; it runs its products at ~40 % of the tensor-core peak
// (PERF.md).
//
// The design:
// - A block is one consumer warpgroup (4 warps, 64 query rows of one
//   head, 16 a warp) and one producer warp.  The producer's one thread
//   loads the q tile, then keeps a ring of STAGES K/V tiles (64 rows each)
//   in flight with 3-D TMA loads under full/empty mbarriers: K and V of a
//   stage complete on their own barriers.  Tiles past t are zero-filled
//   by TMA; causal tiles above the diagonal are never loaded.
// - S = q.K^T is one SS wgmma group (4 k-steps of 16 dims, both operands
//   K-major in shared memory) into 32 fp32 registers a thread.  q is not
//   pre-scaled: S * d**-0.5 with d**-0.5 = 2**-3 exact is the reference's
//   (q * d**-0.5).K^T bit for bit, and the scale folds into the exponent
//   (exp2 of S * 2**-3 * log2 e).
// - The online softmax runs on the accumulator registers (row max and sum
//   across the 4 threads of a quad, once a tile); the diagonal and a
//   ragged last tile alone are masked.  o is rescaled by alpha in fp32.
// - O += P.V is an RS wgmma group: P from registers (n-blocks 2j, 2j + 1
//   of S are the A fragment of k-step j) as a hi/lo bf16 pair, lo then hi
//   per k-step, so P enters with ~16 bits where the reference keeps fp32
//   (P rounded once to bf16 failed the one-ulp check by 20-97 ulps); V is
//   the B operand MN-major, read in place with wgmma's transpose bit.
// - The loop is pipelined across key tiles: S of tile kt + 1 is issued,
//   then P.V of tile kt, and the softmax of kt + 1 runs on the CUDA cores
//   while P.V of kt runs on the tensor cores.
// - o is rounded once to bf16 at the end and stored masked at t; lse =
//   m * d**-0.5 + log(den) in fp32.
// - Tiles: 64 query rows a block at every shape.  Three blocks share an
//   SM (registers), the three warpgroups a 192-row block would hold
//   without its ragged waves: B8 H12 T1024 is 1,536 blocks, the ring tick
//   b2 h12 t1024 384 on 132 SMs (128-row tiles would give it 192).
//   Causal launches the heaviest q tiles first.
// - No atomics: one block owns each output row, so two launches are
//   bit-equal.
// - -Xptxas -v: 122 registers a thread, no spill, no static shared
//   memory; SMEM_BYTES (58,448) of dynamic shared memory a block.
namespace bf16k {

using namespace bf16mma;  // bf16, D, pack, split, store_rows
using namespace sm90;

constexpr int BM = 64;      // query rows a block (one warpgroup)
constexpr int BN = 64;      // key rows a K/V tile
constexpr int STAGES = 3;   // K/V tiles in flight
constexpr int CONSUMERS = 128;
constexpr int THREADS_WS = CONSUMERS + 32;  // + the producer warp
// q, then K[STAGES], V[STAGES], then the barriers: q, kfull[STAGES],
// vfull[STAGES], empty[STAGES]; 1,024 bytes of slack align the tiles
constexpr int OFF_K = BOX_BYTES;
constexpr int OFF_V = OFF_K + STAGES * BOX_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * BOX_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 3 * STAGES) + 1024;  // 58,448
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = q.K^T (4 k-steps of 16 dims) into s
__device__ __forceinline__ void qk(float (&s)[8][4], uint64_t dq,
                                   uint64_t dk) {
  wgmma_ss<false>(s, dq, dk);
#pragma unroll
  for (int j = 1; j < 4; ++j)
    wgmma_ss<true>(s, dq + j * KSTEP_K, dk + j * KSTEP_K);
}

// o += P.V, P as the hi/lo A fragments of its 4 k-steps, small terms first
__device__ __forceinline__ void pv(float (&o)[8][4],
                                   const uint32_t (&ph)[4][4],
                                   const uint32_t (&pl)[4][4], uint64_t dv) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_rs(o, pl[j], dv + j * KSTEP_MN);
    wgmma_rs(o, ph[j], dv + j * KSTEP_MN);
  }
}

// One key tile's online softmax, in place: the raw scores s (n-block n:
// keys k0 + 8n + 2tq, +1 of rows r[0], r[1]) become P = exp2(s * c - m *
// c), c = d**-0.5 * log2 e; keys at or past t (and, causal, past the row)
// are masked on an edge tile.  Updates the running max m (raw units) and
// sum l of each row and returns its alpha = exp2((m_old - m_new) * c).
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], bool edge,
                                             int k0, const int (&r)[2],
                                             int t, int causal, int tq,
                                             float c, float (&m)[2],
                                             float (&l)[2], float (&al)[2]) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * tq + (e & 1);
        if (col >= t || (causal && col > r[e >> 1])) s[n][e] = -INFINITY;
      }
  }
  float b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    // a row that sees nothing yet keeps m = -inf: subtract 0 so that its
    // masked scores give exp(-inf) = 0, not NaN
    b[i] = mx == -INFINITY ? 0.f : mx * c;
    al[i] = ex2(m[i] * c - b[i]);  // 0 from -inf
    m[i] = mx;
    l[i] *= al[i];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = ex2(fmaf(s[n][e], c, -b[e >> 1]));
      l[e >> 1] += s[n][e];
    }
}

// One block per (batch*head, 64-row query tile).
__global__ void __launch_bounds__(THREADS_WS, 3)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      bf16* __restrict__ o, float* __restrict__ lse, int t,
                      int causal, float scale) {
  extern __shared__ unsigned char fwd_bf16_smem[];
  const uint32_t raw = smem_addr(fwd_bf16_smem);
  const uint32_t sq = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms
  const uint32_t sk = sq + OFF_K, sv = sq + OFF_V, qbar = sq + OFF_BAR;
  auto kfull = [&](int s) { return qbar + 8 + 8 * s; };
  auto vfull = [&](int s) { return qbar + 8 + 8 * (STAGES + s); };
  auto empty = [&](int s) { return qbar + 8 + 8 * (2 * STAGES + s); };

  const int head = blockIdx.x;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * BM;
  // causal: keys past the tile's last query row are never loaded
  const int nk = causal ? qt + 1 : (t + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread loads
    if (threadIdx.x == CONSUMERS) {
      tma_prefetch(&tmk);
      tma_prefetch(&tmv);
      mbar_arrive_expect_tx(qbar, BOX_BYTES);
      tma_load_3d(sq, &tmq, qbar, 0, q0, head);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(kfull(s), BOX_BYTES);
        tma_load_3d(sk + s * BOX_BYTES, &tmk, kfull(s), 0, kt * BN, head);
        mbar_arrive_expect_tx(vfull(s), BOX_BYTES);
        tma_load_3d(sv + s * BOX_BYTES, &tmv, vfull(s), 0, kt * BN, head);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float c = scale * LOG2E;  // raw score -> log2 units
  const uint64_t dq = desc_sw128(sq);
  // a tile is an edge tile on the causal diagonal or past t
  auto edge = [&](int kt) {
    return (causal && kt == qt) || kt * BN + BN > t;
  };

  float acc[8][4];  // o: n-block n holds dims 8n + 2tq, +1 of rows r
  float s[8][4];    // S, then P, of one key tile
  uint32_t ph[4][4], pl[4][4];  // P as hi/lo A fragments
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];

  // tile 0: S, then P (o is still 0)
  mbar_wait(qbar, 0);
  mbar_wait(kfull(0), 0);
  wgmma_fence();
  qk(s, dq, desc_sw128(sk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  softmax_tile(s, edge(0), 0, r, t, causal, tq, c, m, l, al);
  split_acc(s, ph, pl);

  // tile kt's o += P.V runs on the tensor cores while the softmax of tile
  // kt + 1 runs on the CUDA cores: S of kt + 1 is issued first, then P.V
  // of kt, and the wait for S leaves P.V in flight
  for (int kt = 0; kt + 1 < nk; ++kt) {
    const int st = kt % STAGES, st1 = (kt + 1) % STAGES;
    mbar_wait(kfull(st1), ((kt + 1) / STAGES) & 1);
    wgmma_fence();
    qk(s, dq, desc_sw128(sk + st1 * BOX_BYTES));
    wgmma_commit();
    mbar_wait(vfull(st), (kt / STAGES) & 1);
    pv(acc, ph, pl, desc_sw128(sv + st * BOX_BYTES));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(s);
    softmax_tile(s, edge(kt + 1), (kt + 1) * BN, r, t, causal, tq, c, m, l,
                 al);
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty(st));  // this thread is done with tile kt's stage
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= al[e >> 1];
    split_acc(s, ph, pl);
  }
  {  // the last tile's o += P.V
    const int st = (nk - 1) % STAGES;
    mbar_wait(vfull(st), ((nk - 1) / STAGES) & 1);
    wgmma_fence();
    pv(acc, ph, pl, desc_sw128(sv + st * BOX_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
  // every row sees at least key 0, so den > 0 and m is finite
  const size_t base = (size_t)head * (size_t)t * D;
  store_rows(o + base, acc, r[0], t, tq, 1.f / l[0], 1.f / l[1]);
  if (lse != nullptr && tq == 0) {
    float* lb = lse + (size_t)head * t;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r[i] < t) lb[r[i]] = m[i] * scale + logf(l[i]);
  }
}

// the kernel's dynamic shared memory is lifted above 48 KB once per device
int smem_ready[64];

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int t, int causal, void* stream) {
  const int nq = (t + BM - 1) / BM;
  if (bh <= 0 || t <= 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tmq, tmk, tmv;
  if (int err = rows_map(&tmq, q, bh, t)) return err;
  if (int err = rows_map(&tmk, k, bh, t)) return err;
  if (int err = rows_map(&tmv, v, bh, t)) return err;
  if (int err = tf32mma::allow_dynamic_smem(
          (const void*)flash_fwd_bf16_kernel, SMEM_BYTES, smem_ready))
    return err;
  const dim3 grid(bh, nq);
  flash_fwd_bf16_kernel<<<grid, THREADS_WS, SMEM_BYTES,
                          (cudaStream_t)stream>>>(
      tmq, tmk, tmv, static_cast<bf16*>(o), static_cast<float*>(lse), t,
      causal, 0.125f /* 64 ** -0.5 */);
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
