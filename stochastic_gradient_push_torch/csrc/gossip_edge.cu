// Gossip transport for Hopper (sm_90a): edge start (K2) and edge wait (K1),
// in two forms: the stacked lane (every rank in one process) and the
// cross-process lane (one rank per process, peers mapped by CUDA IPC).
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
//
// Cross-process form (one rank per process, R = 1 in every shape): each
// rank cudaMalloc's one block per transport bucket, [ready[E] |
// consumed[E] | landing part 0 [E, slab0] | part 1 [E, slab1]], exports it
// with cudaIpcGetMemHandle, and maps the blocks of the peers it sends to
// with cudaIpcOpenMemHandle (sgp_gossip_ipc_*; on one card the processes
// share the device, across cards the mapping rides NVLink).  Counters
// hold the round number (1, 2, ...) and are never reset, so stale landing
// bytes cannot pass for a new round.  Stream order is the barrier: K2
// (sgp_gossip_edge_start_ipc) is a one-block wait kernel that
// acquire-waits (ld.acquire.sys) until each receiver's consumed[e] has
// reached the previous round -- the receiver owns its landing row again,
// the TPU kernel's entry barrier -- then the stacked K2 above at R = E = 1
// for each edge, straight into the receiver's mapped landing row, then a
// one-block signal kernel that release-stores ready[e] = round in each
// receiver's block (st.release.sys after a system fence).  K1
// (sgp_gossip_edge_wait_ipc_*) is the wait kernel on this rank's ready[e],
// the stacked K1 above at R = 1, and the signal kernel on its
// consumed[e].  A wait polls with __nanosleep backoff and gives up after
// timeout_ns of %globaltimer: it records (code, rank, edge, round) in a
// host-mapped error record and raises a device abort word, after which
// the link's waits give up at once and its signals are not sent; the host
// raises a typed error from the record.  Processes that share one card
// run by time-slicing, so a wait spinning on a flag holds the card until
// its slice ends: rounds there are slow, and are no NVLink figure.
// Bound of the cross-process K2: the part bytes read once and written
// once (3.35 TB/s on one card; across cards each byte also crosses
// NVLink at 450 GB/s a direction).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// ---- the cross-process form ----------------------------------------------

namespace {

constexpr int MAX_EDGES = 16;  // edges a round

// One u64 round counter an edge, each in some rank's IPC block.
struct Flags {
  unsigned long long* p[MAX_EDGES];
};
// Host-side int64 link[5]: the abort word (local device int), the error
// record (host-mapped, device address), round, timeout_ns, rank.
struct Link {
  int* abort;
  volatile long long* err;
  unsigned long long round;
  long long timeout_ns;
  int rank;
};

Link make_link(const long long* h) {
  return Link{reinterpret_cast<int*>(h[0]),
              reinterpret_cast<volatile long long*>(h[1]),
              static_cast<unsigned long long>(h[2]), h[3],
              static_cast<int>(h[4])};
}

Flags make_flags(const long long* h, int E) {
  Flags f;
  for (int e = 0; e < MAX_EDGES; ++e)
    f.p[e] = e < E ? reinterpret_cast<unsigned long long*>(h[e]) : nullptr;
  return f;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread e spins until *f.p[e] >= want.  It gives up when another wait of
// the link gave up, or after timeout_ns: then the first to give up
// records (code, rank, edge, round) for the host and raises the abort
// word.
__global__ void flag_wait_kernel(Flags f, unsigned long long want, Link k,
                                 int code, int E) {
  const int e = threadIdx.x;
  if (e >= E || ld_acquire(f.p[e]) >= want) return;
  const unsigned long long t0 = now_ns();
  unsigned ns = 32;
  for (;;) {
    if (*reinterpret_cast<volatile int*>(k.abort)) return;
    __nanosleep(ns);
    if (ns < 8192) ns <<= 1;
    if (ld_acquire(f.p[e]) >= want) return;
    if ((long long)(now_ns() - t0) > k.timeout_ns) {
      if (atomicCAS(k.abort, 0, code) == 0) {
        k.err[1] = k.rank;
        k.err[2] = e;
        k.err[3] = (long long)k.round;
        __threadfence_system();
        k.err[0] = code;
        __threadfence_system();
      }
      return;
    }
  }
}

// Thread e release-stores the round in *f.p[e], after the copy or fold
// before it in stream order; nothing once a wait of the link gave up.
__global__ void flag_signal_kernel(Flags f, unsigned long long round,
                                   const int* abort, int E) {
  const int e = threadIdx.x;
  if (e >= E || *reinterpret_cast<const volatile int*>(abort)) return;
  __threadfence_system();
  st_release(f.p[e], round);
}

// K1, cross-process: wait for every incoming edge's ready[e] (waits),
// the stacked K1 at R = 1, then release consumed[e] (signals).
template <int KIND>
int wait_ipc(const void* acc, const void* recv, const void* scale,
             void* out, long long L, int block, int E, const void* waits,
             const void* signals, const void* link, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || E > MAX_EDGES) return (int)cudaErrorInvalidValue;
  const Link k = make_link(static_cast<const long long*>(link));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flag_wait_kernel<<<1, MAX_EDGES, 0, st>>>(
      make_flags(static_cast<const long long*>(waits), E), k.round, k, 2,
      E);
  const int rc = launch_wait<KIND>(acc, recv, scale, out, L, block, 1, E,
                                   stream);
  if (rc != 0) return rc;
  flag_signal_kernel<<<1, MAX_EDGES, 0, st>>>(
      make_flags(static_cast<const long long*>(signals), E), k.round,
      k.abort, E);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- cross-process setup and entry points ----------------------------------

// One zeroed block of `bytes` on `device` and its IPC handle (64 bytes).
extern "C" int sgp_gossip_ipc_alloc(int device, long long bytes, void** ptr,
                                    void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return (int)err;
}

// Map a peer's block from its handle.
extern "C" int sgp_gossip_ipc_open(int device, const void* handle,
                                   void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(
        ptr, *static_cast<const cudaIpcMemHandle_t*>(handle),
        cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

extern "C" int sgp_gossip_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return (int)err;
}

extern "C" int sgp_gossip_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return (int)err;
}

// A zeroed host-mapped buffer (the error record): its host and device
// addresses.
extern "C" int sgp_gossip_host_alloc(long long bytes, void** host,
                                     void** dev) {
  cudaError_t err = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped);
  if (err == cudaSuccess) {
    memset(*host, 0, (size_t)bytes);
    err = cudaHostGetDevicePointer(dev, *host, 0);
  }
  return (int)err;
}

extern "C" int sgp_gossip_host_free(void* host) {
  return (int)cudaFreeHost(host);
}

// K2, cross-process: wait until every receiver has consumed the last
// round (waits: host int64[E], each receiver's consumed[e]), the stacked
// K2 once an edge at R = E = 1 from this rank's row e of each part
// (src0/src1: [E, n] of esize-byte elements, src1 null when absent)
// straight to dst0[e]/dst1[e] (host int64[E], the mapped landing rows),
// then release the round into each receiver's ready[e] (signals: host
// int64[E]).  zero: a device int32 0 (the one-rank dests table); link:
// host int64[5] (see Link).
extern "C" int sgp_gossip_edge_start_ipc(const void* src0, long long n0,
                                         int esize0, const void* dst0,
                                         const void* src1, long long n1,
                                         int esize1, const void* dst1,
                                         const void* zero, int E,
                                         const void* waits,
                                         const void* signals,
                                         const void* link, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || E > MAX_EDGES) return (int)cudaErrorInvalidValue;
  const Link k = make_link(static_cast<const long long*>(link));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flag_wait_kernel<<<1, MAX_EDGES, 0, st>>>(
      make_flags(static_cast<const long long*>(waits), E), k.round - 1, k,
      1, E);
  const long long* d0 = static_cast<const long long*>(dst0);
  const long long* d1 = static_cast<const long long*>(dst1);
  const long long s0 = n0 * esize0, s1 = src1 ? n1 * esize1 : 0;
  for (int e = 0; e < E && err == cudaSuccess; ++e)
    err = (cudaError_t)sgp_gossip_edge_start(
        static_cast<const unsigned char*>(src0) + e * s0,
        reinterpret_cast<void*>(d0[e]), n0, esize0,
        src1 ? static_cast<const unsigned char*>(src1) + e * s1 : nullptr,
        src1 ? reinterpret_cast<void*>(d1[e]) : nullptr, n1, esize1, zero,
        1, 1, stream);
  if (err != cudaSuccess) return (int)err;
  flag_signal_kernel<<<1, MAX_EDGES, 0, st>>>(
      make_flags(static_cast<const long long*>(signals), E), k.round,
      k.abort, E);
  return (int)cudaGetLastError();
}

// K1, cross-process, one entry point per wire.  acc/out: f32 [L]; recv:
// this rank's landing [E, L]; scale (int8): [E, L / block]; waits,
// signals, link as for K2.
extern "C" int sgp_gossip_edge_wait_ipc_f32(const void* acc, const void* recv,
                                            void* out, long long L, int E,
                                            const void* waits,
                                            const void* signals,
                                            const void* link, int device,
                                            void* stream) {
  return wait_ipc<F32>(acc, recv, nullptr, out, L, 1, E, waits, signals,
                       link, device, stream);
}

extern "C" int sgp_gossip_edge_wait_ipc_bf16(const void* acc,
                                             const void* recv, void* out,
                                             long long L, int E,
                                             const void* waits,
                                             const void* signals,
                                             const void* link, int device,
                                             void* stream) {
  return wait_ipc<BF16>(acc, recv, nullptr, out, L, 1, E, waits, signals,
                        link, device, stream);
}

extern "C" int sgp_gossip_edge_wait_ipc_int8(const void* acc, const void* q,
                                             const void* scale, void* out,
                                             long long L, int block, int E,
                                             const void* waits,
                                             const void* signals,
                                             const void* link, int device,
                                             void* stream) {
  return wait_ipc<INT8>(acc, q, scale, out, L, block, E, waits, signals,
                        link, device, stream);
}
