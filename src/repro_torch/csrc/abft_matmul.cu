// K3: the f32 matrix product of ABFT's checksum-encoded operands.
//
// Replaces the TPU kernel src/repro/abft/kernels.py::_matmul_kernel
// (pl.pallas_call in matmul_pallas, called by abft_matmul). C (M, N) =
// A (M, K) x B (K, N), all f32, row-major, contiguous; in ABFT use A is
// [A; 1^T A] (m+1 rows) and B is [B, B 1] (k+1 columns), so C carries the
// checksum row and column that abft/ref.py::verify_and_correct checks.
//
// Two rules come from the checker, not from speed:
//  * true IEEE f32 (FFMA, no TF32, no tensor cores): the residual threshold
//    is an eps32 bound, and a TF32 product (~1e-3 relative) would trip it
//    on clean data;
//  * bitwise run-to-run determinism: every output is one thread's FFMA
//    chain in ascending k order, so there is no split-K and no atomic.
//
// Bound on the H100: at the qwen2-0.5b MLP shapes (M = 1025, K = 896 or
// 4864, N = 4865 or 897) the product is 8.9 GFLOP against ~41 MB moved,
// so the least time is set by the operations at the 67 TFLOP/s non-tensor
// f32 rate. This first version is a plain shared-memory-tiled SIMT GEMM
// and runs well below that rate; a faster f32 design is later work.
// Design: one block of 256 threads per 64 x 64 output tile, each thread
// holding a 4 x 4 block of outputs in registers; per k step of 16 a 64 x 16
// slice of A (stored k-major, so a thread reads its 4 rows as one float4)
// and a 16 x 64 slice of B are staged in shared memory. Loads past M, K or
// N are predicated and read zero, so there are no padded copies (the
// reference's zero padding contributes nothing to the product). Global
// loads are scalar: N = 4865 leaves B's rows off the 16-byte boundary.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int APAD = 4;  // keeps As rows 16-byte aligned, eases bank conflicts

__global__ void __launch_bounds__(THREADS)
abft_matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slice: 64 rows x 16 k; consecutive threads read consecutive k
#pragma unroll
    for (int it = 0; it < (BM * BK) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? a[(long long)gr * K + gk] : 0.f;
    }
    // B slice: 16 k x 64 columns; consecutive threads read consecutive columns
#pragma unroll
    for (int it = 0; it < (BK * BN) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      Bs[kk][cc] = (gk < K && gc < N) ? b[(long long)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < N) c[(long long)gr * N + gc] = acc[i][j];
    }
  }
}

}  // namespace

// C (M, N) = A (M, K) x B (K, N), f32, contiguous row-major. Returns
// cudaGetLastError() after the launch.
extern "C" int sedar_abft_matmul(const void* a, const void* b, void* c, int M,
                                 int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  abft_matmul_f32<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return (int)cudaGetLastError();
}
