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
// f32 runs flash_fwd_f32 (true f32 on the FFMA units; K4's body as well).
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
// the next tile's copy overlaps this tile's products. Head dims 16, 64,
// 128 and 256. Tiles are stored as [row][hd] with the 32-byte swizzle at
// hd 16, and from hd 64 up as hd / 64 panels of 64 columns, each with the
// 128-byte swizzle (one panel row is one swizzle atom). S = Q K^T is
// hd / 16 wgmma m64n64k16 (bf16 in, f32 accumulate, both operands from
// shared memory, K as the K-major B operand; the descriptor steps 32 bytes
// along a panel row and then to the next panel); the scale
// 1/sqrt(hd) is applied to the f32 scores, as the reference does. The
// online softmax (m, l) stays in f32 registers; each row lives in a quad of
// threads, whose max is taken with shuffles. Only tiles on the diagonal, the
// window edge or past Sk apply the element mask; tiles the mask removes for
// every row are skipped. O += P V is wgmma with P from registers (the score
// accumulator's layout is the A fragment's) and V as the MN-major B operand,
// one m64n64k16 per 64-column panel of V (n16 at hd 16): at hd 256 the O
// accumulator is 128 f32 registers a thread. Shared memory is Q plus two
// K/V stages, 5 tiles of 64 x hd bf16: 41 KB at hd 64, 161 KB at hd 256.
// P is split into bf16 hi = bf16(p) and lo = bf16(p - hi), two wgmma into
// the same f32 O: one bf16 rounding of p (2^-9) would move outputs by more
// than a bf16 step, hi + lo keeps p to ~2^-17, and the executed work is
// 1.5x the function's operations. No split-KV, no atomics, a fixed order:
// two launches give the same bits.
//
// f32 design (flash_fwd_f32). Hopper's tensor cores take no f32 input and
// TF32 keeps a 10-bit mantissa, which would trip ABFT's eps32 residual
// threshold on clean data, so this body runs in true f32 on the FFMA units
// and is bound by the f32 rate (67 TFLOP/s): the design is K3's register
// blocking applied to both products. One block of 256 threads (8 warps)
// per (b, h, 64-row q tile), heaviest causal tiles first. Thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i (i < 4). The q tile is staged
// once; 64-key K and V tiles come through cp.async (zero-filled past
// Sq/Sk). Q, K and V tiles are [row][hd + 4] (16-byte rows; the pad puts
// the 16 rows that a half-warp reads at one d on distinct banks).
//   Head dims 16, 64, 128 and 256. Shared memory (f32_smem_bytes) decides
//   the K/V ring. At hd <= 128 two K/V stages (Q, K0, V0, K1, V1 and P:
//   (5 64 (hd + 4) + 64 68) 4 bytes): tile t + 1's copy overlaps all of
//   tile t's products; at hd 16 and 64 (21 and 89 KB) two blocks share an
//   SM (at most 128 registers a thread), at hd 128 (186,368 B) one does
//   (at most 255). At hd 256 two stages would take 350,208 B of the 227 KB
//   a block may have, so the body keeps ONE K and ONE V tile and refills
//   them apart (217,088 B): K of tile t + 1 is copied while P V of tile t
//   runs (K is free once S is in registers), and V of tile t + 1 while
//   Q K^T of tile t + 1 runs, so every copy still overlaps a product, at
//   the cost of two more __syncthreads per tile. Halving the head dim or
//   32-row q tiles would keep the ring but read K (or Q) twice, or double
//   the blocks; the split refill reads each tile once.
//   S = Q K^T: each thread a 4 x 4 block, keys tx + 16 j (j < 4), from
//   float4 fragments of Q and K: 8 shared loads per 64 FFMA, every score
//   one fmaf chain in ascending d. The scale 1/sqrt(hd) multiplies the f32
//   scores. Masks as in the wgmma body: only edge tiles apply the element
//   mask, tiles that no row reaches are not visited.
//   Online softmax: a row's max is taken over its 16 threads with xor
//   shuffles (1, 2, 4, 8: a fixed tree), m and corr in f32, p = expf(s - m);
//   each thread keeps its own share of l, summed over the 16 at the end by
//   the same tree.
//   O += P V: P goes to shared memory ([64][68]); each thread accumulates
//   4 rows x hd / 16 adjacent data columns (tx * hd / 16 ...), one fmaf
//   chain per output in ascending key order (at hd 256: 64 accumulators a
//   thread).
// No split-KV, no atomics: two launches give the same bits. The output is
// staged through the Q tile (free after the last S) and written row by
// row, consecutive threads on consecutive elements, whatever the output's
// strides.
//
// K4 (CK = true) is the f32 body with a checksum lane, and replaces the TPU
// kernel src/repro/abft/kernels.py::abft_flash_attention (its pl.pallas_call
// runs _flash_kernel with V and the output widened to hd + 1). It reads
// v_aug (B, KV, Sk, hd + 1) f32, whose lane hd is the row sum of V (done
// outside the kernel, abft/ref.py::attention_checksum_encode), and writes
// out_full (B, H, Sq, hd + 1) f32, so a fault can be injected between the
// kernel and abft/ref.py::attention_verify. A v_aug row of hd + 1 floats
// (260 bytes at hd 64) starts on a 16-byte boundary only every 4th row, so
// the kernel reads V_aug with 4-byte cp.async.ca copies into the same
// [row][hd + 4] tiles: any v_aug view with a contiguous last dim is read
// as it is, padded or not (q and k keep 16-byte copies; the wrapper
// refuses q or k views that are not 16-byte aligned). Lane hd is one more
// accumulator per row and thread: each thread adds p * v_aug[key][hd] for
// its own 4 x 4 scores, and the 16 shares of a row are summed at the end by
// the xor tree. It takes the same p, corr and 1/l as the data lanes:
// attention is linear in V, so lane hd equals the sum of the data lanes up
// to rounding. Bound: as K2, with operations counted at the f32 rate.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

struct Strides {
  long long b, h, s;
};

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
// 4-byte async copy; ok = false writes 4 zero bytes and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// f32: flash_fwd_f32 (FFMA, register-blocked; K4 with CK = true)
// ---------------------------------------------------------------------------

constexpr int FT = 256;   // threads per block
constexpr int FQ = 64;    // q rows per block
constexpr int FK = 64;    // keys per K/V tile
constexpr int PP = FK + 4;  // pitch of the P tile

// two K/V stages up to hd 128; at hd 256 one K and one V tile
template <int HD>
__host__ __device__ constexpr bool f32_ring() { return HD <= 128; }

template <int HD>
constexpr int f32_smem_bytes() {  // Q, the K/V stages, P
  return ((f32_ring<HD>() ? 5 : 3) * FK * (HD + 4) + FQ * PP) * 4;
}

// blocks per SM the register budget is set for: two while two fit in
// shared memory (hd 16, 64), else one (255 registers a thread)
template <int HD>
__host__ __device__ constexpr int f32_min_blocks() { return HD <= 64 ? 2 : 1; }

// rows [pos0, pos0 + 64) of a matrix with row stride rs (elements) into a
// [64][HD + 4] tile: W floats per row, 16-byte copies (W = HD, rows 16-byte
// aligned) or 4-byte copies (any W); rows at or past `limit` are zeroed
template <int HD, int W, bool VEC>
__device__ __forceinline__ void f32_load_tile(float* sdst, const float* g,
                                              long long rs, int pos0,
                                              int limit, int tid) {
  constexpr int P = HD + 4;
  constexpr int CPR = VEC ? W / 4 : W;  // copies per row
#pragma unroll 4
  for (int i = tid; i < FK * CPR; i += FT) {
    const int r = i / CPR;
    const int c = i - r * CPR;
    const int p = pos0 + r;
    const bool ok = p < limit;
    const float* src = ok ? g + (long long)p * rs + (VEC ? 4 * c : c) : g;
    const uint32_t dst = smem_u32(sdst + r * P + (VEC ? 4 * c : c));
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

// N floats from p: float4 loads when N is a multiple of 4 (p then 16-byte
// aligned), else scalar loads
template <int N>
__device__ __forceinline__ void ld_frag(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <int HD, bool CK>
__global__ void __launch_bounds__(FT, f32_min_blocks<HD>())
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides qs,
              Strides ks, Strides vs, Strides os, int H, int KV, int Sq,
              int Sk, int causal, int window, float scale) {
  constexpr bool RING = f32_ring<HD>();
  constexpr int P = HD + 4;
  constexpr int TILE = FK * P;      // floats of one Q, K or V tile
  constexpr int DPT = HD / 16;      // data columns per thread in O
  constexpr int W = CK ? HD + 1 : HD;
  extern __shared__ float4 fsm4[];
  float* const Qs = reinterpret_cast<float*>(fsm4);
  // ring stage s: K at KV0 + 2 s TILE, V after it; one stage: K, then V
  float* const KV0 = Qs + TILE;
  float* const Ps = Qs + (RING ? 5 : 3) * TILE;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;  // longest tiles first
  const int kvh = h / (H / KV);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  int k_lo = 0;
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + FQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / FK) * FK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + FK - 1) / FK : 0;

  // copy groups: ring, one per tile ({Q, K0, V0}, {K1, V1}, ...); one
  // stage, K and V apart ({Q, K0}, {V0}, {K1}, {V1}, ...)
  f32_load_tile<HD, HD, true>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  if (ntiles > 0) f32_load_tile<HD, HD, true>(KV0, kb, ks.s, k_lo, Sk, tid);
  if constexpr (!RING) cp_async_commit();
  if (ntiles > 0) f32_load_tile<HD, W, !CK>(KV0 + TILE, vb, vs.s, k_lo, Sk, tid);
  cp_async_commit();

  float acc[4][DPT];
  float acc_c[4];       // K4: this thread's share of the checksum lane
  float m[4], l[4];     // running max (shared by the row), own share of l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
    acc_c[i] = 0.f;
    m[i] = -1e30f;
    l[i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_lo + t * FK;
    float* const Ks = RING ? KV0 + 2 * TILE * (t & 1) : KV0;
    float* const Vs = Ks + TILE;
    if constexpr (RING) {
      cp_async_wait<0>();   // this tile (and Q) has landed
      __syncthreads();      // ... for every thread; stage t + 1 and P are free
      if (t + 1 < ntiles) {
        float* nk = KV0 + 2 * TILE * ((t + 1) & 1);
        f32_load_tile<HD, HD, true>(nk, kb, ks.s, k0 + FK, Sk, tid);
        f32_load_tile<HD, W, !CK>(nk + TILE, vb, vs.s, k0 + FK, Sk, tid);
      }
      cp_async_commit();
    } else {
      cp_async_wait<1>();   // this tile's K (and Q) has landed; V may not
      __syncthreads();      // ... for every thread; P is free
    }

    // S = Q K^T: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float qf[4][4], kf[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld_frag(qf[i], Qs + (ty + 16 * i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ld_frag(kf[j], Ks + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qf[i][e], kf[j][e], s[i][j]);
    }

    // scale in f32, mask only where a row can see a masked key
    const bool edge = k0 + FK > Sk || (causal && k0 + FK - 1 > q0) ||
                      (window > 0 && q0 + FQ - 1 - k0 >= window);
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (edge) {
          const int kp = k0 + tx + 16 * j;
          const bool ok = kp < Sk && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
          x = ok ? x : -CUDART_INF_F;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] *= corr[i];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= corr[i];
      if constexpr (CK) acc_c[i] *= corr[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m[i]);   // 0 for a masked key
        l[i] += p;
        s[i][j] = p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
    }
    __syncthreads();      // P is complete; every thread is done with K
    if constexpr (!RING) {
      if (t + 1 < ntiles)
        f32_load_tile<HD, HD, true>(Ks, kb, ks.s, k0 + FK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();   // this tile's V has landed
      __syncthreads();      // ... for every thread
    }

    // K4's lane: this thread's own 4 x 4 scores, in the order the data
    // lanes take them
    if constexpr (CK) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc_c[i] = fmaf(s[i][j], Vs[(tx + 16 * j) * P + HD], acc_c[i]);
    }

    // O += P V: rows ty + 16 i, data columns tx * DPT + jj
#pragma unroll 4
    for (int c = 0; c < FK; c += 4) {
      float pf[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld_frag(pf[i], Ps + (ty + 16 * i) * PP + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vf[DPT];
        ld_frag(vf, Vs + (c + e) * P + tx * DPT);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < DPT; ++jj)
            acc[i][jj] = fmaf(pf[i][e], vf[jj], acc[i][jj]);
      }
    }
    if constexpr (!RING) {
      __syncthreads();      // every thread is done with V
      if (t + 1 < ntiles)
        f32_load_tile<HD, W, !CK>(Vs, vb, vs.s, k0 + FK, Sk, tid);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // the 16 shares of each row's l (and lane), by the same xor tree
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      if constexpr (CK) acc_c[i] += __shfl_xor_sync(0xffffffffu, acc_c[i], off);
    }
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  __syncthreads();        // every thread is done with Q, P and the last V
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = Qs + (ty + 16 * i) * P;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) row[tx * DPT + jj] = acc[i][jj] * inv[i];
    if (CK && tx == 0) row[HD] = acc_c[i] * inv[i];
  }
  __syncthreads();
  float* ob = o + b * os.b + h * os.h;
  for (int i = tid; i < FQ * W; i += FT) {
    const int r = i / W;
    const int c = i - r * W;
    if (q0 + r < Sq) ob[(long long)(q0 + r) * os.s + c] = Qs[r * P + c];
  }
}

template <int HD, bool CK>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int H, int KV, int Sq, int Sk,
               int causal, int window, float scale, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  constexpr int smem = f32_smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<HD, CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + FQ - 1) / FQ, H, B);
  flash_fwd_f32<HD, CK><<<grid, FT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      H, KV, Sq, Sk, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: flash_fwd_wgmma (Hopper tensor cores; PTX for cp.async and wgmma)
// ---------------------------------------------------------------------------

constexpr int WG = 128;    // one warpgroup
constexpr int TQ = 64;     // q rows per block (wgmma M)
constexpr int TKV = 64;    // keys per K/V tile (wgmma N of S = Q K^T)

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

// A tile is 64 rows of hd bf16. hd 16: one [64][16] tile (row pitch 32
// bytes) with the 32-byte swizzle (16-byte chunk c of row r at chunk
// c ^ ((r / 4) % 2)). hd >= 64: hd / 64 panels of [64 rows][64 columns]
// (row pitch 128 bytes, 8 KB each, one after the other), each with the
// 128-byte swizzle (chunk c of row r at chunk c ^ (r % 8)), so that one
// panel row is one swizzle atom whatever hd is. Both swizzles are "byte
// offset bits [4, 4+n) ^= bits [7, 7+n)" within a panel.
template <int HD>
__host__ __device__ constexpr int panel_cols() { return HD >= 64 ? 64 : HD; }
template <int HD>
__host__ __device__ constexpr int panel_bytes() {
  return TKV * panel_cols<HD>() * 2;
}

template <int HD>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t mask = HD >= 64 ? 7u : 1u;
  return off ^ (((off >> 7) & mask) << 4);
}

// byte offset of 16-byte chunk c (8 columns) of row r in a tile
template <int HD>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  constexpr int CPP = panel_cols<HD>() / 8;  // chunks per panel row
  return (c / CPP) * panel_bytes<HD>() +
         swz<HD>(r * panel_cols<HD>() * 2 + (c % CPP) * 16);
}

// wgmma shared-memory descriptor of one panel: start address, leading byte
// offset (unused by these swizzled layouts, set to 1), stride byte offset =
// one 8-row group (8 rows of the panel pitch), layout 1 = 128-byte swizzle,
// 3 = 32-byte.
template <int HD>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  constexpr uint64_t layout = HD >= 64 ? 1 : 3;
  constexpr uint64_t sbo = (8 * 2 * panel_cols<HD>()) >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         (sbo << 32) | (layout << 62);
}

// descriptor step to k16 slice kk of a K-major operand (Q or K): panel
// kk / 4, then 32 bytes per slice along the swizzled panel row
template <int HD>
__device__ __forceinline__ uint64_t k_slice(int kk) {
  return (uint64_t)(((kk / 4) * panel_bytes<HD>() + (kk % 4) * 32) >> 4);
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
    cp_async16(sdst + tile_off<HD>(r, c),
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
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
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

// O (64 x hd) += A (16 keys of P) * V rows [16 kk, 16 kk + 16): one n16
// product at hd 16, else one n64 product per 64-column panel of V into
// the accumulator's 32-register block of that panel
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t dv,
                                         int kk) {
  constexpr uint64_t rows16 = (16 * 2 * panel_cols<HD>()) >> 4;
  if constexpr (HD == 16) {
    wgmma_rs_n16(o, a, dv + kk * rows16);
  } else {
#pragma unroll
    for (int j = 0; j < HD / 64; ++j)
      wgmma_rs_n64(o + 32 * j, a,
                   dv + j * (panel_bytes<HD>() >> 4) + kk * rows16);
  }
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

    // S = Q K^T: hd / 16 steps of k16 (32 bytes along a swizzled panel row)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t dk = make_desc<HD>(sk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, dq + k_slice<HD>(kk), dk + k_slice<HD>(kk), kk > 0);
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

    // O += P V: 4 steps of 16 keys, each over every panel of V
    const uint64_t dv = make_desc<HD>(sv);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) reg_fence(oacc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<HD>(oacc, phi[kk], dv, kk);
      wgmma_pv<HD>(oacc, plo[kk], dv, kk);
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
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const long long* st, int B, int H, int KV, int Sq, int Sk,
                 int causal, int window, float scale, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  // Q, two K/V stages, alignment: 41 KB at hd 64, 161 KB at hd 256
  constexpr int smem = 5 * TKV * HD * 2 + 1024;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + TQ - 1) / TQ, H, B);
  flash_fwd_wgmma<HD><<<grid, WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qs, ks, vs, os, H, KV, Sq, Sk, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (flash_fwd_f32), 1 = bfloat16 (wgmma body), each at
// head_dim 16, 64, 128 or 256. q, k, v 16-byte aligned with
// strides that are multiples of 16 bytes (8 bf16 or 4 f32 elements), which
// the wrapper checks. strides: 12 element strides (b, h, s) of q, k, v, o.
// Returns the launch's error code.
extern "C" int sedar_flash_fwd(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, void* o,
                               const long long* strides, int B, int H, int KV,
                               int Sq, int Sk, int causal, int window,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_wgmma<16>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
      case 64: return launch_wgmma<64>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
      case 128: return launch_wgmma<128>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
      case 256: return launch_wgmma<256>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
    }
  } else if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_f32<16, false>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
      case 64: return launch_f32<64, false>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
      case 128: return launch_f32<128, false>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
      case 256: return launch_f32<256, false>(q, k, v, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// K4: head_dim 16, 64, 128 or 256, float32 only; v is v_aug (row length head_dim + 1,
// any 4-byte aligned view) and o is out_full (row length head_dim + 1); q
// and k as for sedar_flash_fwd. strides: 12 element strides (b, h, s) of q,
// k, v_aug, out_full. Returns the launch's error code.
extern "C" int sedar_abft_flash_fwd(int head_dim, const void* q, const void* k,
                                    const void* v_aug, void* o,
                                    const long long* strides, int B, int H,
                                    int KV, int Sq, int Sk, int causal,
                                    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0 || H <= 0) return (int)cudaGetLastError();
  switch (head_dim) {
    case 16: return launch_f32<16, true>(q, k, v_aug, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
    case 64: return launch_f32<64, true>(q, k, v_aug, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
    case 128: return launch_f32<128, true>(q, k, v_aug, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
    case 256: return launch_f32<256, true>(q, k, v_aug, o, strides, B, H, KV, Sq, Sk, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
