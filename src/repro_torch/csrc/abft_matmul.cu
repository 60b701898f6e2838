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
//  * bitwise run-to-run determinism: every output is one thread's fmaf
//    chain in ascending k from +0.0f, so there is no split-K and no atomic.
//    Zero padding past K adds fmaf(0, 0, acc) = acc, so every tiling of
//    this chain gives the same bits: this kernel equals the SIMT body kept
//    below (sedar_abft_matmul_simt) bit for bit.
//
// Bound on the H100: at the qwen2-0.5b MLP shapes (M = 1025, K = 896 or
// 4864, N = 4865 or 897) the product is 8.9 GFLOP against ~41 MB moved, so
// the least time is set by the operations at the 67 TFLOP/s non-tensor f32
// rate: 0.1334 ms at (1025 x 896) x (896 x 4865).
//
// Design: one block of 256 threads per 128 x 128 output tile, each thread
// holding 8 x 8 outputs as 2 x 2 sub-blocks of 4 x 4 that lie 64 rows and
// 64 columns apart, so its shared reads are four conflict-free float4 per
// k for 64 FFMA. Per k step of TK = 8 a 128 x 8 slice of A (stored k-major:
// transposed on its way in, rows padded to 132 floats so the transposing
// stores do not conflict) and an 8 x 128 slice of B are staged in two
// shared buffers: the next slice's global loads are issued into registers
// before this slice's FFMAs and stored into the other buffer after them,
// which leaves one __syncthreads per k step. A takes 16-byte loads when K
// is a multiple of 4 and A is 16-byte aligned (the MLP shapes), else 4-byte
// loads; B's rows are off the 16-byte boundary (N = 4865 or 897), so its
// loads are 4-byte and coalesced. Edges are predicated and read zero; there
// are no padded copies. __launch_bounds__(256, 2) holds a thread to 128
// registers so that two blocks share an SM. At M = 1025 the ninth row of
// tiles holds only the checksum row: 9 x 39 = 351 tiles over 132 SMs x 2
// blocks is 1.33 waves. A tile whose lower 64 rows lie past M runs the k
// loop over its upper 64 rows only, which leaves 8.2% of the FFMA on
// padding rows or columns ((8.5 x 128 x 4992 - 1025 x 4865) /
// (8.5 x 128 x 4992)) instead of 13.3%.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int TM = 128;
constexpr int TN = 128;
constexpr int TK = 8;
constexpr int NT = 256;
constexpr int TPAD = 4;  // As rows of 132 floats: 16-byte aligned, no conflicts

template <bool AVEC>
__global__ void __launch_bounds__(NT, 2)
abft_matmul_f32(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float As[2][TK][TM + TPAD];
  __shared__ __align__(16) float Bs[2][TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // rows ty*4 .. +3 and 64 + ty*4 .. +3
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  // loads: A row lr, k offsets lk .. lk+3; B column lc, k rows lb + 2 i
  const int lr = tid / 2;
  const int lk = (tid % 2) * 4;
  const bool a_ok = row0 + lr < M;
  const float* ap = a + (long long)(a_ok ? row0 + lr : 0) * K;
  const int lc = tid % TN;
  const int lb = tid / TN;
  const bool b_ok = col0 + lc < N;
  const float* bp = b + (b_ok ? col0 + lc : 0);

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int gk = k0 + lk;
    if constexpr (AVEC) {  // K % 4 == 0: gk < K covers gk + 3
      const float4 t = (a_ok && gk < K)
                           ? *reinterpret_cast<const float4*>(ap + gk)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[0] = t.x;
      ra[1] = t.y;
      ra[2] = t.z;
      ra[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = (a_ok && gk + i < K) ? ap[gk + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kb = k0 + lb + 2 * i;
      rb[i] = (b_ok && kb < K) ? bp[(long long)kb * N] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][lk + i][lr] = ra[i];
      Bs[buf][lb + 2 * i][lc] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the k loop over R rows of fragments: 8, or 4 where the tile's lower 64
  // rows lie past M (at M = 1025, the ninth row of tiles)
  auto run = [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    load(0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += TK) {
      const bool more = k0 + TK < K;
      if (more) load(k0 + TK);  // in flight during this slice's FFMAs
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float ar[8];
#pragma unroll
        for (int h = 0; h < R / 4; ++h) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&As[buf][kk][64 * h + ty * 4]);
          ar[4 * h] = a4.x;
          ar[4 * h + 1] = a4.y;
          ar[4 * h + 2] = a4.z;
          ar[4 * h + 3] = a4.w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  };
  if (row0 + 64 < M)
    run(std::integral_constant<int, 8>{});
  else
    run(std::integral_constant<int, 4>{});

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (gc < N) c[(long long)gr * N + gc] = acc[i][j];
    }
  }
}

// The first (SIMT) K3 body, kept only as the bitwise oracle of the kernel
// above (test-only code: tests/test_torch_cuda.py and chip_smoke.py call it
// through sedar_abft_matmul_simt; the K3 wrapper never does). 64 x 64
// tiles, 4 x 4 outputs per thread, k steps of 16, one shared buffer.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int APAD = 4;  // keeps As rows 16-byte aligned, eases bank conflicts

__global__ void __launch_bounds__(THREADS)
abft_matmul_f32_simt(const float* __restrict__ a,
                     const float* __restrict__ b, float* __restrict__ c,
                     int M, int N, int K) {
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
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* pc = static_cast<float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0)
    abft_matmul_f32<true><<<grid, NT, 0, st>>>(pa, pb, pc, M, N, K);
  else
    abft_matmul_f32<false><<<grid, NT, 0, st>>>(pa, pb, pc, M, N, K);
  return (int)cudaGetLastError();
}

// Test-only: the same product by the first (SIMT) K3 body, the bitwise oracle.
extern "C" int sedar_abft_matmul_simt(const void* a, const void* b, void* c,
                                      int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  abft_matmul_f32_simt<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return (int)cudaGetLastError();
}
