// K1: fused state fingerprint (hash + sum + absmax) over a flat u32 buffer.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint.py::_fingerprint_kernel
// (pl.pallas_call in fingerprint_pallas). For word u_i at element index i
// (a wrapping 32-bit index):
//     h1 = sum_i ((u_i ^ (i*C1)) * C2)                mod 2^32
//     h2 = sum_i (t ^ (t >> 15)),  t = (u_i + i) * C3  mod 2^32
//     s  = sum_i float(u_i)    a = max_i |float(u_i)|  (f32 diagnostics)
//
// Bound on the H100: memory. It reads each word once (4n bytes at 3.35 TB/s)
// and does a handful of integer operations per word, far below the card's
// compute rate. Design: pass 1 is a grid-stride loop of 16-byte (uint4)
// loads with per-thread accumulators and one partial per block; pass 2 is a
// single block that combines the partials in a fixed order. Integer sums are
// exact in any order; the float sum uses no atomics, so for one buffer
// length the reduction tree, and with it every output bit, is the same on
// every run. Words before the first 16-byte boundary and after the last
// whole vector are mixed by thread 0 of block 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t C1 = 2654435761u;
constexpr uint32_t C2 = 2246822519u;
constexpr uint32_t C3 = 3266489917u;
constexpr int THREADS = 256;

struct Acc {
  uint32_t h1, h2;
  float s, a;
};

__device__ __forceinline__ void mix(Acc& acc, uint32_t u, uint32_t i) {
  acc.h1 += (u ^ (i * C1)) * C2;
  const uint32_t t = (u + i) * C3;
  acc.h2 += t ^ (t >> 15);  // logical shift: t is unsigned
  const float x = __uint_as_float(u);
  acc.s += x;
  acc.a = fmaxf(acc.a, fabsf(x));
}

__device__ __forceinline__ Acc warp_reduce(Acc v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.h1 += __shfl_down_sync(0xffffffffu, v.h1, off);
    v.h2 += __shfl_down_sync(0xffffffffu, v.h2, off);
    v.s += __shfl_down_sync(0xffffffffu, v.s, off);
    v.a = fmaxf(v.a, __shfl_down_sync(0xffffffffu, v.a, off));
  }
  return v;
}

// Fixed-shape tree over the block; the result is valid in thread 0.
__device__ Acc block_reduce(Acc v) {
  __shared__ Acc warp_acc[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v);
  if (lane == 0) warp_acc[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_acc[lane] : Acc{0u, 0u, 0.f, 0.f};
    v = warp_reduce(v);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
fp_partial(const uint32_t* __restrict__ u, unsigned long long n,
           unsigned long long head, unsigned long long nvec,
           Acc* __restrict__ partials) {
  Acc acc{0u, 0u, 0.f, 0.f};
  const uint4* vec = reinterpret_cast<const uint4*>(u + head);
  const unsigned long long stride = (unsigned long long)gridDim.x * THREADS;
  for (unsigned long long j = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
       j < nvec; j += stride) {
    const uint4 w = __ldg(vec + j);
    const uint32_t i = (uint32_t)(head + 4ull * j);
    mix(acc, w.x, i);
    mix(acc, w.y, i + 1u);
    mix(acc, w.z, i + 2u);
    mix(acc, w.w, i + 3u);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (unsigned long long k = 0; k < head; ++k) mix(acc, u[k], (uint32_t)k);
    for (unsigned long long k = head + 4ull * nvec; k < n; ++k)
      mix(acc, u[k], (uint32_t)k);
  }
  acc = block_reduce(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(THREADS)
fp_combine(const Acc* __restrict__ partials, int nblocks,
           uint32_t* __restrict__ out) {
  Acc acc{0u, 0u, 0.f, 0.f};
  for (int b = threadIdx.x; b < nblocks; b += THREADS) {
    const Acc p = partials[b];
    acc.h1 += p.h1;
    acc.h2 += p.h2;
    acc.s += p.s;
    acc.a = fmaxf(acc.a, p.a);
  }
  acc = block_reduce(acc);
  if (threadIdx.x == 0) {
    out[0] = acc.h1;
    out[1] = acc.h2;
    out[2] = __float_as_uint(acc.s);
    out[3] = __float_as_uint(acc.a);
  }
}

}  // namespace

// u: n words; partials: nblocks * 4 words of scratch; out: 4 words.
// Returns cudaGetLastError() after both launches.
extern "C" int sedar_fingerprint(const void* u, long long n, void* partials,
                                 int nblocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* words = static_cast<const uint32_t*>(u);
  Acc* part = static_cast<Acc*>(partials);
  int combined = 0;
  if (n > 0) {
    const unsigned long long mis = (reinterpret_cast<uintptr_t>(words) & 15u) / 4u;
    unsigned long long head = mis ? 4u - mis : 0u;
    if (head > (unsigned long long)n) head = (unsigned long long)n;
    const unsigned long long nvec = ((unsigned long long)n - head) / 4u;
    fp_partial<<<nblocks, THREADS, 0, st>>>(words, (unsigned long long)n,
                                            head, nvec, part);
    combined = nblocks;
  }
  fp_combine<<<1, THREADS, 0, st>>>(part, combined,
                                    static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
