// Gossip transport for Hopper (sm_90a): edge start (K2) and edge wait (K1).
//
// K2 replaces stochastic_gradient_push_tpu/ops/gossip_kernel.py::
// _edge_start_kernel (reached through gossip_edge_start): every encoded
// wire part of E edges lands in the destination rank's landing buffer.
// On the stacked lane all R ranks live in one process on one card, rank-
// stacked as [R, E, slab], so the "remote" copy is landed[dests[e][r], e]
// = parts[r, e] inside one device's memory.  The TPU kernel's entry
// barrier (no sender may write a landing buffer before its receiver owns
// it) and its depth-2 remote-DMA pipeline have no work to do here: one
// process issues the start and the wait on one stream, and stream order
// already puts every writer before every reader.  So K2 is a byte copy
// over a grid of (tile, rank * E + edge, part); one launch moves every
// part of a start (the f32/bf16 payload, or the int8 q and its f32
// scales).  Bound: bytes, each read once and written once at 3.35 TB/s.
// A tile moves 16 KiB as 16-byte vectors where source and destination
// are both 16-byte aligned, and byte by byte where they are not (ragged
// int8 slabs); cp.async/TMA staging is left for a later version.
//
// K1 replaces _edge_wait_kernel (reached through gossip_edge_wait):
// out[r, i] = acc[r, i] + sum_e decode(recv[r, e, i]), the edges folded
// in order e = 0, 1, ... in registers before one store.  Decode is the
// f32 passthrough, the exact bf16 -> f32 widen, or the int8 q * scale
// with the scale of element i at i / block (chunks hold whole codec
// blocks, so this is the chunk-local scale row of the TPU kernel).  The
// rounding is the TPU kernel's: dec = q * scale rounded, then acc + dec
// rounded, written with __fmul_rn/__fadd_rn so nvcc cannot contract
// them into one FMA (it would by default) and the result stays bit-equal
// to the plain PyTorch version.  Bound: bytes (1 flop per element read).
// Each thread owns 4 consecutive elements (16-byte acc/out loads) when
// the slab length and the pointers allow, else 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC_PER_THREAD = 4;  // 16-byte vectors per thread per tile
constexpr long long TILE_BYTES = (long long)THREADS * 16 * VEC_PER_THREAD;

struct Part {
  const unsigned char* src;  // [R, E, slab] bytes
  unsigned char* dst;        // [R, E, slab] bytes
  long long slab;            // bytes per (rank, edge)
};

__global__ void __launch_bounds__(THREADS)
edge_start_kernel(Part p0, Part p1, const int* __restrict__ dests, int R,
                  int E) {
  const Part p = blockIdx.z == 0 ? p0 : p1;
  const long long off = (long long)blockIdx.x * TILE_BYTES;
  if (off >= p.slab) return;
  const long long n = p.slab - off < TILE_BYTES ? p.slab - off : TILE_BYTES;
  const int re = blockIdx.y;  // r * E + e
  const int r = re / E;
  const int e = re - r * E;
  const long long dst_re = (long long)dests[e * R + r] * E + e;
  const unsigned char* s = p.src + (long long)re * p.slab + off;
  unsigned char* d = p.dst + dst_re * p.slab + off;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) &
       15) == 0) {
    const long long nv = n >> 4;
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    uint4* dv = reinterpret_cast<uint4*>(d);
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += THREADS) dv[i] = sv[i];
    for (long long i = (nv << 4) + threadIdx.x; i < n; i += THREADS)
      d[i] = s[i];
  } else {
    for (long long i = threadIdx.x; i < n; i += THREADS) d[i] = s[i];
  }
}

enum Kind { F32 = 0, BF16 = 1, INT8 = 2 };

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);  // exact widen
}

// VEC consecutive decoded elements of one (rank, edge) slab from i0 on.
template <int KIND, int VEC>
__device__ __forceinline__ void decode(const void* __restrict__ recv,
                                       const float* __restrict__ scale,
                                       long long slab_re, long long i0,
                                       int block, long long L, float* d) {
  if constexpr (KIND == F32) {
    const float* x = static_cast<const float*>(recv) + slab_re * L + i0;
    if constexpr (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(x);
      d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
    } else {
      d[0] = x[0];
    }
  } else if constexpr (KIND == BF16) {
    const uint16_t* x = static_cast<const uint16_t*>(recv) + slab_re * L + i0;
    if constexpr (VEC == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(x);
      d[0] = bf16_bits_to_f32(static_cast<uint16_t>(t.x & 0xffffu));
      d[1] = bf16_bits_to_f32(static_cast<uint16_t>(t.x >> 16));
      d[2] = bf16_bits_to_f32(static_cast<uint16_t>(t.y & 0xffffu));
      d[3] = bf16_bits_to_f32(static_cast<uint16_t>(t.y >> 16));
    } else {
      d[0] = bf16_bits_to_f32(x[0]);
    }
  } else {
    const int8_t* q = static_cast<const int8_t*>(recv) + slab_re * L + i0;
    const float* s = scale + slab_re * (L / block);
    int8_t qv[VEC];
    if constexpr (VEC == 4) {
      const char4 t = *reinterpret_cast<const char4*>(q);
      qv[0] = t.x; qv[1] = t.y; qv[2] = t.z; qv[3] = t.w;
    } else {
      qv[0] = q[0];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      d[k] = __fmul_rn(static_cast<float>(qv[k]), s[(i0 + k) / block]);
  }
}

template <int KIND, int VEC>
__global__ void __launch_bounds__(THREADS)
edge_wait_kernel(const float* __restrict__ acc, const void* __restrict__ recv,
                 const float* __restrict__ scale, float* __restrict__ out,
                 long long L, int block, int E) {
  const int r = blockIdx.y;
  const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i0 >= L) return;
  const float* a = acc + (long long)r * L + i0;
  float v[VEC];
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(a);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = a[0];
  }
  for (int e = 0; e < E; ++e) {
    float d[VEC];
    decode<KIND, VEC>(recv, scale, (long long)r * E + e, i0, block, L, d);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fadd_rn(v[k], d[k]);
  }
  float* o = out + (long long)r * L + i0;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    o[0] = v[0];
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <int KIND>
int launch_wait(const void* acc, const void* recv, const void* scale,
                void* out, long long L, int block, int R, int E,
                void* stream) {
  const int wire_bytes = KIND == F32 ? 16 : (KIND == BF16 ? 8 : 4);
  const bool vec = L % 4 == 0 && aligned(acc, 16) && aligned(out, 16) &&
                   aligned(recv, wire_bytes);
  const int per_block = THREADS * (vec ? 4 : 1);
  dim3 grid((unsigned)((L + per_block - 1) / per_block), (unsigned)R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (vec)
    edge_wait_kernel<KIND, 4><<<grid, THREADS, 0, st>>>(a, recv, s, o, L,
                                                          block, E);
  else
    edge_wait_kernel<KIND, 1><<<grid, THREADS, 0, st>>>(a, recv, s, o, L,
                                                          block, E);
  return (int)cudaGetLastError();
}

}  // namespace

// K2.  Parts are rank-stacked [R, E, n] of esize-byte elements; part 1 is
// absent when src1 is null.  dests: int32 [E, R] on the device, each row a
// permutation of the ranks.  Returns cudaGetLastError().
extern "C" int sgp_gossip_edge_start(const void* src0, void* dst0,
                                     long long n0, int esize0,
                                     const void* src1, void* dst1,
                                     long long n1, int esize1,
                                     const void* dests, int R, int E,
                                     void* stream) {
  Part p0{static_cast<const unsigned char*>(src0),
          static_cast<unsigned char*>(dst0), n0 * esize0};
  Part p1{static_cast<const unsigned char*>(src1),
          static_cast<unsigned char*>(dst1), src1 ? n1 * esize1 : 0};
  const long long most = p0.slab > p1.slab ? p0.slab : p1.slab;
  dim3 grid((unsigned)((most + TILE_BYTES - 1) / TILE_BYTES),
            (unsigned)(R * E), src1 ? 2u : 1u);
  edge_start_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p0, p1, static_cast<const int*>(dests), R, E);
  return (int)cudaGetLastError();
}

// K1, one entry point per wire.  acc/out: f32 [R, L]; recv: [R, E, L] of
// f32 / bf16 bits / int8; scale (int8 only): f32 [R, E, L / block].
extern "C" int sgp_gossip_edge_wait_f32(const void* acc, const void* recv,
                                        void* out, long long L, int R, int E,
                                        void* stream) {
  return launch_wait<F32>(acc, recv, nullptr, out, L, 1, R, E, stream);
}

extern "C" int sgp_gossip_edge_wait_bf16(const void* acc, const void* recv,
                                         void* out, long long L, int R, int E,
                                         void* stream) {
  return launch_wait<BF16>(acc, recv, nullptr, out, L, 1, R, E, stream);
}

extern "C" int sgp_gossip_edge_wait_int8(const void* acc, const void* q,
                                         const void* scale, void* out,
                                         long long L, int block, int R,
                                         int E, void* stream) {
  return launch_wait<INT8>(acc, q, scale, out, L, block, R, E, stream);
}
