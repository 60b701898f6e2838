// K2: forward flash attention (online softmax), GQA, causal + sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pl.pallas_call in flash_attention_pallas). q: (B, H, Sq, hd), k/v:
// (B, KV, Sk, hd) given by element strides (the head dim is contiguous), so
// the model's (B, S, H, hd) tensors are read in place; query head h reads KV
// head h / (H / KV). Masks come from absolute positions (row qpos, key kpos,
// both from 0): kpos < Sk, causal qpos >= kpos, window qpos - kpos < window.
// Softmax state (m, l, acc) is f32; the output is written in q's type.
//
// Bound on the H100: at qwen2-0.5b prefill shapes (hd 64, B 4, causal) the
// least time is set by bytes (q, k, v read once, o written once) at S = 256
// and by the two matmuls' operations at the bf16 tensor-core rate from about
// S = 700 on. This first version is plain SIMT f32 FMA and runs far from
// either bound; wgmma/TMA tiles are later work. Design: one block of
// BQ = 64 threads per (b, h, 64-row q tile), one thread per query row, its
// q row and its accumulator in registers. A loop inside the block walks the
// KV tiles (the Pallas grid's sequential nK axis) and stages each BK = 32 key
// tile of K and V in shared memory as f32; every thread reads the same K/V
// row at a time, which shared memory broadcasts. Tiles that the causal or
// window mask removes for every row of the q tile are skipped; the result
// is the same. A row that no key reaches gets zeros.
//
// K4 (CK = true) is the same body with a checksum lane, and replaces the TPU
// kernel src/repro/abft/kernels.py::abft_flash_attention (its pl.pallas_call
// runs _flash_kernel with V and the output widened to hd + 1). It reads
// v_aug (B, KV, Sk, hd + 1) f32, whose lane hd is the row sum of V (done
// outside the kernel, abft/ref.py::attention_checksum_encode), and writes
// out_full (B, H, Sq, hd + 1) f32, so a fault can be injected between the
// kernel and abft/ref.py::attention_verify. Lane hd is ONE extra per-row
// accumulator fed from its own shared array Vc; the data lanes keep Vs
// [BK][hd], since a 65-float row would break the 16-byte float4 reads. The
// lane takes the same p, corr and 1/l as the data lanes: attention is
// linear in V, so lane hd equals the sum of the data lanes up to rounding.
// The scale stays 1/sqrt(hd). Bound: as K2, with operations counted at the
// non-tensor f32 rate, since K4 runs in f32 only.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

template <typename T, int HD, bool CK>
__global__ void __launch_bounds__(BQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
          Strides vs, Strides os, int H, int KV, int Sq, int Sk, int causal,
          int window, float scale) {
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];
  __shared__ float Vc[CK ? BK : 1];  // K4: lane HD of each v_aug row

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const int r = threadIdx.x;
  const int qpos = q0 + r;
  const bool row_ok = qpos < Sq;

  float qr[HD];
  float acc[HD];
  const T* qp = q + b * qs.b + h * qs.h + (long long)qpos * qs.s;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = row_ok ? to_f(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -1e30f;
  float l = 0.f;
  float acc_c = 0.f;  // K4: the checksum lane's accumulator

  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / BK) * BK;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int idx = r; idx < BK * HD; idx += BQ) {
      const int j = idx / HD;
      const int d = idx - j * HD;
      const int kp = k0 + j;
      const bool ok = kp < Sk;
      Ks[j][d] = ok ? to_f(kb[(long long)kp * ks.s + d]) : 0.f;
      Vs[j][d] = ok ? to_f(vb[(long long)kp * vs.s + d]) : 0.f;
    }
    if constexpr (CK) {
      for (int j = r; j < BK; j += BQ) {
        const int kp = k0 + j;
        Vc[j] = kp < Sk ? to_f(vb[(long long)kp * vs.s + HD]) : 0.f;
      }
    }
    __syncthreads();

    float s[BK];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kp = k0 + j;
      const bool ok = kp < Sk && (!causal || qpos >= kp) &&
                      (window <= 0 || qpos - kp < window);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][d]);
        dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
      }
      s[j] = ok ? dot : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    if constexpr (CK) acc_c *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for a masked key
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][d]);
        acc[d] += p * vv.x;
        acc[d + 1] += p * vv.y;
        acc[d + 2] += p * vv.z;
        acc[d + 3] += p * vv.w;
      }
      if constexpr (CK) acc_c += p * Vc[j];
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = o + b * os.b + h * os.h + (long long)qpos * os.s;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = from_f<T>(acc[d] * inv);
    if constexpr (CK) op[HD] = from_f<T>(acc_c * inv);
  }
}

template <typename T, int HD, bool CK = false>
void launch(const void* q, const void* k, const void* v, void* o,
            const long long* st, int B, int H, int KV, int Sq, int Sk,
            int causal, int window, float scale, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD, CK><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H, KV, Sq,
      Sk, causal, window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 16 or 64. strides: 12 element
// strides (b, h, s) of q, k, v, o. Returns cudaGetLastError() after launch.
extern "C" int sedar_flash_fwd(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, void* o,
                               const long long* strides, int B, int H, int KV,
                               int Sq, int Sk, int causal, int window,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (dtype == 1 && head_dim == 64)
    launch<__nv_bfloat16, 64>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else if (dtype == 1 && head_dim == 16)
    launch<__nv_bfloat16, 16>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else if (dtype == 0 && head_dim == 64)
    launch<float, 64>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else if (dtype == 0 && head_dim == 16)
    launch<float, 16>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K4: head_dim 16 or 64, float32 only; v is v_aug (row length head_dim + 1)
// and o is out_full (row length head_dim + 1). strides: 12 element strides
// (b, h, s) of q, k, v_aug, out_full. Returns cudaGetLastError() after launch.
extern "C" int sedar_abft_flash_fwd(int head_dim, const void* q, const void* k,
                                    const void* v_aug, void* o,
                                    const long long* strides, int B, int H,
                                    int KV, int Sq, int Sk, int causal,
                                    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (head_dim == 64)
    launch<float, 64, true>(q, k, v_aug, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else if (head_dim == 16)
    launch<float, 16, true>(q, k, v_aug, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
