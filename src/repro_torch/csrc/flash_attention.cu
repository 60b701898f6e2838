// K2: forward flash attention (online softmax), GQA, causal + sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (pl.pallas_call in flash_attention_pallas). q: (B, H, Sq, hd), k/v:
// (B, KV, Sk, hd) given by element strides (the head dim is contiguous), so
// the model's (B, S, H, hd) tensors are read in place; query head h reads KV
// head h / (H / KV). Masks come from absolute positions (row qpos, key kpos,
// both from 0): kpos < Sk, causal qpos >= kpos, window qpos - kpos < window.
// A row that no key reaches gets zeros. The output is written through its
// strides (the wrapper passes a (B, Sq, H, hd) buffer).
//
// Each input type has one kernel: bf16 runs flash_fwd_wgmma (tensor cores),
// f32 runs the SIMT body flash_fwd (true f32, K4's body as well).
//
// Bound on the H100 at qwen2-0.5b prefill shapes (B 4, H 14, KV 2, hd 64,
// causal): at S = 256 the bytes (q, k, v read once, o written once:
// 3.67 MB, 0.0011 ms at 3.35 TB/s); at S = 2048 the operations, 4 B H hd
// per unmasked (q, k) pair = 30.1 GFLOP, 0.0304 ms at 989 TFLOP/s bf16.
//
// bf16 design (flash_fwd_wgmma): one block of one warpgroup (128 threads)
// per (b, h, 64-row q tile), heaviest causal tiles first. The q tile is
// loaded once into shared memory and each 64-key K and V tile comes through
// a two-stage ring by cp.async (16-byte copies, zero-filled past Sq/Sk), so
// the next tile's copy overlaps this tile's products. Tiles are stored as
// [row][hd] with the 128-byte swizzle (hd 64) or the 32-byte swizzle
// (hd 16). S = Q K^T is wgmma m64n64k16 (bf16 in, f32 accumulate, both
// operands from shared memory, K as the K-major B operand); the scale
// 1/sqrt(hd) is applied to the f32 scores, as the reference does. The
// online softmax (m, l) stays in f32 registers; each row lives in a quad of
// threads, whose max is taken with shuffles. Only tiles on the diagonal, the
// window edge or past Sk apply the element mask; tiles the mask removes for
// every row are skipped. O += P V is wgmma with P from registers (the score
// accumulator's layout is the A fragment's) and V as the MN-major B operand.
// P is split into bf16 hi = bf16(p) and lo = bf16(p - hi), two wgmma into
// the same f32 O: one bf16 rounding of p (2^-9) would move outputs by more
// than a bf16 step, hi + lo keeps p to ~2^-17, and the executed work is
// 1.5x the function's operations. No split-KV, no atomics, a fixed order:
// two launches give the same bits.
//
// f32 design (flash_fwd, SIMT): one block of BQ = 64 threads per (b, h,
// 64-row q tile), one thread per query row, its q row and its accumulator
// in registers; the KV loop stages each BK = 32 key tile of K and V in
// shared memory and every thread reads the same K/V row at a time, which
// shared memory broadcasts. It runs far from the f32 bound.
//
// K4 (CK = true) is the SIMT body with a checksum lane, and replaces the TPU
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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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


// ---------------------------------------------------------------------------
// bf16: flash_fwd_wgmma (Hopper tensor cores; PTX for cp.async and wgmma)
// ---------------------------------------------------------------------------

constexpr int WG = 128;    // one warpgroup
constexpr int TQ = 64;     // q rows per block (wgmma M)
constexpr int TKV = 64;    // keys per K/V tile (wgmma N of S = Q K^T)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; ok = false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's completed cp.async writes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads and writes across the
// asynchronous wgmma (between its launch and its wait)
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// A tile is 64 rows of hd bf16 (row pitch 2 hd bytes) stored with the
// hardware swizzle that matches the pitch: 128-byte for hd 64 (16-byte
// chunk c of row r at chunk c ^ (r % 8)), 32-byte for hd 16 (chunk c at
// c ^ ((r / 4) % 2)). Both are "byte offset bits [4, 4+n) ^= bits [7, 7+n)".
template <int HD>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask = HD == 64 ? 7u : 1u;
  return off ^ (((off >> 7) & mask) << 4);
}

// wgmma shared-memory descriptor: start address, leading byte offset
// (unused by these swizzled layouts, set to 1), stride byte offset = one
// 8-row group (8 * 2 hd bytes), layout 1 = 128-byte swizzle, 3 = 32-byte.
template <int HD>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  constexpr uint64_t layout = HD == 64 ? 1 : 3;
  constexpr uint64_t sbo = (8 * 2 * HD) >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         (sbo << 32) | (layout << 62);
}

// rows [pos0, pos0 + 64) of a (pos, hd) matrix with row stride rs (elements)
// into a swizzled tile; rows at or past `limit` are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t sdst,
                                          const __nv_bfloat16* g,
                                          long long rs, int pos0, int limit,
                                          int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < TKV * CPR / WG; ++it) {
    const int i = tid + it * WG;
    const int r = i / CPR;
    const int c = i % CPR;
    const int p = pos0 + r;
    const bool ok = p < limit;
    cp_async16(sdst + swz<HD>(r * HD * 2 + c * 16),
               ok ? g + (long long)p * rs + c * 8 : g, ok);
  }
}

// D (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64)^T, both K-major in shared
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64), B MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, f32) += A (64 x 16, registers) * B (16 x 16), B MN-major
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n16(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Register layout of a wgmma f32 accumulator (64 x N): thread t of the
// warpgroup, warp w = t / 32, lane l; element i sits at row
// 16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int HD>
__global__ void __launch_bounds__(WG)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                Strides vs, Strides os, int H, int KV, int Sq, int Sk,
                int causal, int window, float scale_log2) {
  constexpr int TILE = TKV * HD * 2;  // bytes of one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries: Q, then K0 V0 K1 V1
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ;  // longest tiles first
  const int kvh = h / (H / KV);
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + TQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / TKV) * TKV;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + TKV - 1) / TKV : 0;

  load_tile<HD>(sq, qb, qs.s, q0, Sq, tid);
  if (ntiles > 0) {
    load_tile<HD>(sq + TILE, kb, ks.s, k_lo, Sk, tid);
    load_tile<HD>(sq + 2 * TILE, vb, vs.s, k_lo, Sk, tid);
  }
  cp_async_commit();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane % 4);
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max, in scaled log2 units
  float l[2] = {0.f, 0.f};        // this thread's share of the row sum
  const uint64_t dq = make_desc<HD>(sq);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * TKV;
    const uint32_t sk = sq + TILE * (1 + 2 * (t & 1));
    const uint32_t sv = sk + TILE;
    if (t + 1 < ntiles) {
      const uint32_t nk = sq + TILE * (1 + 2 * ((t + 1) & 1));
      load_tile<HD>(nk, kb, ks.s, k0 + TKV, Sk, tid);
      load_tile<HD>(nk + TILE, vb, vs.s, k0 + TKV, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T: hd / 16 steps of k16 (32 bytes along the swizzled row)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t dk = make_desc<HD>(sk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);

    // scale in f32, mask only where a row can see a masked key
    const bool edge = k0 + TKV > Sk || (causal && k0 + TKV - 1 > q0) ||
                      (window > 0 && q0 + TQ - 1 - k0 >= window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
        const int qp = q0 + r0 + 8 * ((i / 2) % 2);
        const bool ok = kp < Sk && (!causal || qp >= kp) &&
                        (window <= 0 || qp - kp < window);
        x = ok ? x : -CUDART_INF_F;
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m[(i / 2) % 2]);  // 0 for a masked key
      l[(i / 2) % 2] += p;
      s[i] = p;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i / 2) % 2];

    // P as A fragments, split hi + lo: for keys [16 kk, 16 kk + 16) the
    // fragment is accumulator elements 8 kk .. 8 kk + 7 in pairs
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = s[8 * kk + 2 * j];
        const float p1 = s[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        phi[kk][j] = pack_bf16(hi);
        plo[kk][j] = pack_bf16(__floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi)));
      }

    // O += P V: 4 steps of 16 keys (16 rows of 2 hd bytes each)
    const uint64_t dv = make_desc<HD>(sv);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) reg_fence(oacc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<HD>(oacc, phi[kk], dv + kk * (16 * 2 * HD >> 4));
      wgmma_rs<HD>(oacc, plo[kk], dv + kk * (16 * 2 * HD >> 4));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) reg_fence(oacc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        reg_fence(phi[kk][j]);
        reg_fence(plo[kk][j]);
      }
    __syncthreads();  // every warp is done with this stage before refill
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    inv[r] = lr > 0.f ? 1.f / lr : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + r0 + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* op = o + b * os.b + h * os.h + (long long)qp * os.s;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x0 = oacc[4 * j + 2 * r] * inv[r];
      const float x1 = oacc[4 * j + 2 * r + 1] * inv[r];
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + cq) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int HD>
void launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const long long* st, int B, int H, int KV, int Sq, int Sk,
                 int causal, int window, float scale, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int smem = 5 * TKV * HD * 2 + 1024;  // Q, two K/V stages, alignment
  const dim3 grid((Sq + TQ - 1) / TQ, H, B);
  flash_fwd_wgmma<HD><<<grid, WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qs, ks, vs, os, H, KV, Sq, Sk, causal, window,
      scale * 1.4426950408889634f);
}

}  // namespace

// dtype: 0 = float32 (SIMT body), 1 = bfloat16 (wgmma body; q, k, v 16-byte
// aligned with strides that are multiples of 8 elements, which the wrapper
// checks). head_dim: 16 or 64. strides: 12 element strides (b, h, s) of q,
// k, v, o. Returns cudaGetLastError() after launch.
extern "C" int sedar_flash_fwd(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, void* o,
                               const long long* strides, int B, int H, int KV,
                               int Sq, int Sk, int causal, int window,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (dtype == 1 && head_dim == 64)
    launch_wgmma<64>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  else if (dtype == 1 && head_dim == 16)
    launch_wgmma<16>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
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
