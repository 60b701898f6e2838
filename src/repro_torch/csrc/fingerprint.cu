// K1: fused state fingerprint (hash + sum + absmax), one launch per call,
// reading the leaves of a state where they lie.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint.py::_fingerprint_kernel
// (pl.pallas_call in fingerprint_pallas). For word u_i at global index i of
// the packed order (every leaf's words in turn, a wrapping 32-bit index):
//     h1 = sum_i ((u_i ^ (i*C1)) * C2)                mod 2^32
//     h2 = sum_i (t ^ (t >> 15)),  t = (u_i + i) * C3  mod 2^32
//     s  = sum_i float(u_i)    a = max_i |float(u_i)|  (f32 diagnostics;
//     a is a NaN if a word is a NaN pattern, as in the reference)
//
// The input is a table of leaves, one row each: pointer, element kind, rows,
// contiguous run (elements per row), row stride (elements), the leaf's
// first global word index and the lane it hashes into. Kinds: 0 = 32-bit
// words taken as they are (f32, int32, uint32), 1 = bf16 upcast exactly to
// f32 (bits << 16), 2 = int64 value-cast to int32 (its low 32 bits), 3 =
// zero words (no pointer: a lane's zero-padded tail). So a bf16 logits
// buffer, or each KV-cache slice c[:, :, :pos] (rows of pos * KV * hd contiguous elements
// at the cache's row stride), is hashed in place, with no cast, copy or
// concatenation, and h1/h2/a equal those of the packed buffer bit for bit.
// A leaf may also name a row limit: a device int32/int64 element `limit`
// and a row width `per_row` (elements); the words of each run at or past
// limit * per_row are then hashed as zero words at their fixed global
// index (and never loaded), so the result equals that of the packed
// buffer with those words zeroed. One slot's cache rows [0, pos[i]) are
// hashed this way without a host read of pos and without device prefix
// sums: every word keeps its offset. A limit may also name a ring of W
// rows (a local-attention cache holding position p at row p % W): the row
// limit % W is then hashed as zero words too, so a ring's live rows but
// the one the next step overwrites count. Limits without a ring hash as
// they did before rings existed, bit for bit. The table travels by value in the
// kernel's parameters (__grid_constant__), so no host-to-device copy
// precedes the launch. It comes in two sizes: SMALL_LEAVES rows (3,736
// bytes, under the classic 4 KB parameter limit: every serving call) and
// MAX_LEAVES rows (25,240 bytes, under the 32,764-byte limit that CUDA 12.1
// and later give sm_90), which a training state's {params, m, v} of more
// than 64 leaves takes; both have MAX_LIMITS row limits and MAX_LANES
// lanes. The two are one kernel body, so a tree hashes to the same words
// in either.
//
// Lanes (the mesh backends' per-shard fingerprints, the reference's
// pytree_fingerprint_lanes): the packed words are cut into L lanes of W
// words, lane l covering words [l W, (l + 1) W) with its own index stream
// from 0 and the last lane's tail zero-padded. The wrapper splits a leaf
// that crosses a lane boundary into rows, one per lane, gives each row its
// lane and its offset within that lane as the first index, and adds kind-3
// rows for the padding; rows come in lane order. The grid is L groups of
// `bpl` blocks, group l walking lane l's chunks only, and the last block
// combines each group's partials into lane l's four words: one launch
// returns (L, 4). h1 and h2 are modular sums, so a lane's rows combine
// exactly. With L = 1 the grid, the chunk order and the combine are the
// single fingerprint's, bit for bit.
//
// Bound on the H100: memory. It reads each element once (esize * n bytes
// at 3.35 TB/s) and does a handful of integer operations per word, far
// below the card's compute rate. Design: the leaves' rows are cut into
// chunks of 16 bytes (4 words, 8 bf16 or 2 int64), numbered across the
// whole table; a grid-stride loop gives consecutive threads consecutive
// chunks (one uint4 load each where the row start is 16-byte aligned,
// element loads otherwise and for a row's last partial chunk), the loads
// of BATCH steps in flight together, with per-thread accumulators and one
// partial per block. The last block to finish combines the partials: each
// block writes its partial and takes an integer ticket (an atomic add on
// an unsigned counter, with release and acquire order); the block that
// draws the last ticket reads every partial from L2, combines them in
// block-index order, writes the result and puts the ticket back to 0 for
// the next launch. Integer sums are exact in any
// order; the float sum uses no float atomics and, for one table layout, a
// grid that is a function of the word count alone, so every output bit is
// the same on every run. The ticket and the partials are a workspace that
// the wrapper keeps per (device, stream), so two calls in flight on two
// streams never share a ticket.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t C1 = 2654435761u;
constexpr uint32_t C2 = 2246822519u;
constexpr uint32_t C3 = 3266489917u;
constexpr int THREADS = 256;
constexpr int SMALL_LEAVES = 64;  // the table of every call of <= 64 leaves
constexpr int MAX_LEAVES = 512;  // kernels/fingerprint.py MAX_LEAVES
constexpr int MAX_LIMITS = 16;   // kernels/fingerprint.py MAX_LIMITS
constexpr int MAX_LANES = 16;    // kernels/fingerprint.py MAX_LANES

struct Acc {
  uint32_t h1, h2;
  float s, a;
};

struct Leaf {                   // 48 bytes
  const void* ptr;              // first element
  unsigned long long base;      // global word index of the first element
  unsigned long long stride;    // elements between row starts
  unsigned long long chunk_end; // one past its last chunk (table numbering)
  uint32_t rows, run, cpr;      // rows, elements per row, chunks per row
  uint32_t kind_vec;            // kind (0: 32-bit word, 1: bf16, 2: int64,
                                // 3: zero words) | 4 if every row start is
                                // 16-byte aligned
                                // | (row limit index + 1) << 8, 0 if none
};

struct Limit {                  // 16 bytes
  const void* ptr;              // the limit element on the device
  uint32_t per_row;             // elements per limited row
  uint32_t mode;                // bit 0: int64 element (else int32);
                                // bits 1..31: ring rows W (0: no ring)
};

struct Lane {                   // 24 bytes
  unsigned long long chunk_lo, chunk_hi;  // its chunks (table numbering)
  int leaf_lo;                  // its first table row
};

template <int N>
struct Table {
  Leaf leaf[N];
  Limit lim[MAX_LIMITS];
  Lane lane[MAX_LANES];
  unsigned long long nchunks;
  int nleaves;
  int nlanes;
  int bpl;                      // blocks per lane
};

// the larger of a and b, and a NaN if either is one: the rule of the
// reference's jnp.maximum and of torch.max, where fmaxf would skip a NaN
// word. PTX's max.NaN (sm_80 on) is one instruction per word, as fmaxf
// is; a compare-and-select takes three.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void mix(Acc& acc, uint32_t u, uint32_t i) {
  acc.h1 += (u ^ (i * C1)) * C2;
  const uint32_t t = (u + i) * C3;
  acc.h2 += t ^ (t >> 15);  // logical shift: t is unsigned
  const float x = __uint_as_float(u);
  acc.s += x;
  acc.a = max_nan(acc.a, fabsf(x));
}

__device__ __forceinline__ Acc warp_reduce(Acc v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.h1 += __shfl_down_sync(0xffffffffu, v.h1, off);
    v.h2 += __shfl_down_sync(0xffffffffu, v.h2, off);
    v.s += __shfl_down_sync(0xffffffffu, v.s, off);
    v.a = max_nan(v.a, __shfl_down_sync(0xffffffffu, v.a, off));
  }
  return v;
}

// Fixed-shape tree over the block; the result is valid in thread 0. A
// second call in the same block must follow a __syncthreads.
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

// one chunk: `cnt` elements of leaf `leaf` from element offset `e`, whose
// first word has global index `i`
struct Chunk {
  unsigned long long e;
  uint32_t leaf, i, cnt;
  uint32_t live;  // elements below the row limit (cnt without a limit)
  uint32_t skip_lo, skip_hi;  // the ring's skipped elements [lo, hi)
  bool vec;       // one 16-byte load
};

// elements of a chunk at column `col` of its run that lie below the leaf's
// row limit (`live`), and those of the ring row limit % W (`skip_lo` to
// `skip_hi`, an empty range without a ring): both are hashed as zero words
template <class T>
__device__ __forceinline__ void live_range(const T& t, const Leaf& L,
                                           uint32_t col, Chunk& c) {
  c.live = (L.kind_vec & 3u) == 3u ? 0u : c.cnt;  // kind 3: all zero
  c.skip_lo = c.skip_hi = 0u;
  const uint32_t li = (L.kind_vec >> 8) & 0xFFu;
  if (!li) return;
  const Limit& m = t.lim[li - 1];
  const long long v =
      (m.mode & 1u) ? __ldg(static_cast<const long long*>(m.ptr))
                    : (long long)__ldg(static_cast<const int*>(m.ptr));
  if (v <= 0) {
    c.live = 0u;
    return;
  }
  const unsigned long long end = (unsigned long long)v * m.per_row;
  const unsigned long long d = end <= col ? 0ull : end - col;
  c.live = d >= c.cnt ? c.cnt : (uint32_t)d;
  const uint32_t ring = m.mode >> 1;
  if (ring) {
    const unsigned long long s0 =
        (unsigned long long)(v % (long long)ring) * m.per_row;
    const unsigned long long s1 = s0 + m.per_row;
    const unsigned long long lo = s0 > col ? s0 - col : 0ull;
    const unsigned long long hi = s1 > col ? s1 - col : 0ull;
    c.skip_lo = lo >= c.cnt ? c.cnt : (uint32_t)lo;
    c.skip_hi = hi >= c.cnt ? c.cnt : (uint32_t)hi;
  }
}

template <class T>
__device__ __forceinline__ Chunk locate(const T& t, int& li,
                                        unsigned long long g) {
  while (g >= t.leaf[li].chunk_end) ++li;  // g only grows
  const Leaf& L = t.leaf[li];
  const uint32_t kind = L.kind_vec & 3u;
  const uint32_t per = kind == 1 ? 8u : (kind == 2 ? 2u : 4u);
  const uint32_t local =
      (uint32_t)(g - (L.chunk_end - (unsigned long long)L.rows * L.cpr));
  const uint32_t row = L.rows == 1 ? 0u : local / L.cpr;
  const uint32_t col = (local - row * L.cpr) * per;
  Chunk c;
  c.leaf = (uint32_t)li;
  c.cnt = min(per, L.run - col);
  c.i = (uint32_t)(L.base + (unsigned long long)row * L.run + col);
  c.e = (unsigned long long)row * L.stride + col;
  live_range(t, L, col, c);
  c.vec = (L.kind_vec & 4u) && c.cnt == per && c.live == per &&
          c.skip_lo >= c.skip_hi;
  return c;
}

__device__ __forceinline__ uint4 load_vec(const Leaf& L, const Chunk& c) {
  const uint32_t kind = L.kind_vec & 3u;
  const unsigned long long esize = kind == 0 ? 4 : (kind == 1 ? 2 : 8);
  return __ldg(reinterpret_cast<const uint4*>(
      static_cast<const char*>(L.ptr) + c.e * esize));
}

__device__ __forceinline__ void mix_chunk(Acc& acc, const Leaf& L,
                                          const Chunk& c, uint4 w) {
  const uint32_t kind = L.kind_vec & 3u;
  const uint32_t i = c.i;
  if (c.vec) {
    if (kind == 0) {
      mix(acc, w.x, i);
      mix(acc, w.y, i + 1u);
      mix(acc, w.z, i + 2u);
      mix(acc, w.w, i + 3u);
    } else if (kind == 1) {  // little-endian: element 2k is the low half
      mix(acc, w.x << 16, i);
      mix(acc, w.x & 0xFFFF0000u, i + 1u);
      mix(acc, w.y << 16, i + 2u);
      mix(acc, w.y & 0xFFFF0000u, i + 3u);
      mix(acc, w.z << 16, i + 4u);
      mix(acc, w.z & 0xFFFF0000u, i + 5u);
      mix(acc, w.w << 16, i + 6u);
      mix(acc, w.w & 0xFFFF0000u, i + 7u);
    } else {                 // int64: the low word of each element
      mix(acc, w.x, i);
      mix(acc, w.z, i + 1u);
    }
    return;
  }
  for (uint32_t k = 0; k < c.cnt; ++k) {
    const unsigned long long e = c.e + k;
    uint32_t u;
    if (k >= c.live || (k >= c.skip_lo && k < c.skip_hi))
      u = 0u;  // at or past the row limit, or the ring's skipped row
    else if (kind == 0) u = __ldg(static_cast<const uint32_t*>(L.ptr) + e);
    else if (kind == 1)
      u = (uint32_t)__ldg(static_cast<const unsigned short*>(L.ptr) + e) << 16;
    else u = __ldg(static_cast<const uint32_t*>(L.ptr) + 2 * e);
    mix(acc, u, i + k);
  }
}

constexpr int BATCH = 4;  // grid-stride steps whose loads go out together

template <int N>
__global__ void __launch_bounds__(THREADS)
fp_leaves(const __grid_constant__ Table<N> t, Acc* __restrict__ partials,
          unsigned int* __restrict__ ticket, uint32_t* __restrict__ out) {
  Acc acc{0u, 0u, 0.f, 0.f};
  // this block's lane and its place among the lane's bpl blocks
  const int lane = blockIdx.x / t.bpl;
  const int lb = blockIdx.x - lane * t.bpl;
  const Lane& R = t.lane[lane];
  const unsigned long long stride = (unsigned long long)t.bpl * THREADS;
  int li = R.leaf_lo;
  // this thread's chunks g0, g0 + stride, ... of its lane in that order,
  // BATCH at a time: their 16-byte loads are in flight together
  for (unsigned long long g0 = R.chunk_lo + (unsigned long long)lb * THREADS +
                               threadIdx.x;
       g0 < R.chunk_hi; g0 += BATCH * stride) {
    Chunk c[BATCH];
    uint4 w[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const unsigned long long g = g0 + b * stride;
      c[b].cnt = 0;
      c[b].live = 0;
      c[b].skip_lo = c[b].skip_hi = 0;
      c[b].vec = false;
      w[b] = make_uint4(0u, 0u, 0u, 0u);
      if (g < R.chunk_hi) {
        c[b] = locate(t, li, g);
        if (c[b].vec) w[b] = load_vec(t.leaf[c[b].leaf], c[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      if (c[b].cnt) mix_chunk(acc, t.leaf[c[b].leaf], c[b], w[b]);
  }
  acc = block_reduce(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    // the ticket with release (this block's partial is visible before its
    // ticket) and acquire (the last block sees every partial) semantics
    unsigned int prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(ticket) : "memory");
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // each lane's partials in block-index order
  for (int l = 0; l < t.nlanes; ++l) {
    Acc tot{0u, 0u, 0.f, 0.f};
    for (int b = threadIdx.x; b < t.bpl; b += THREADS) {
      const Acc* p = partials + l * t.bpl + b;
      tot.h1 += __ldcg(&p->h1);
      tot.h2 += __ldcg(&p->h2);
      tot.s += __ldcg(&p->s);
      tot.a = max_nan(tot.a, __ldcg(&p->a));
    }
    __syncthreads();          // block_reduce's shared words are free again
    tot = block_reduce(tot);
    if (threadIdx.x == 0) {
      out[4 * l] = tot.h1;
      out[4 * l + 1] = tot.h2;
      out[4 * l + 2] = __float_as_uint(tot.s);
      out[4 * l + 3] = __float_as_uint(tot.a);
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;      // ready for the next launch
}

// fills a table of N rows from the launcher's rows and launches the kernel
// on it, nlanes groups of bpl blocks: cudaErrorInvalidValue on a bad row,
// else cudaGetLastError()
template <int N>
int fill_and_launch(const long long* leaves, int nleaves,
                    const long long* limits, int nlimits, int nlanes, int bpl,
                    void* partials, void* ticket, void* out, void* stream) {
  Table<N> t{};
  for (int j = 0; j < nlimits; ++j) {
    const long long* r = limits + 3 * j;
    if (r[0] == 0 || r[1] < 0 || r[1] >= (1ll << 32) || r[2] < 1 ||
        r[2] >= (1ll << 32))
      return (int)cudaErrorInvalidValue;
    t.lim[j].ptr = reinterpret_cast<const void*>(r[0]);
    t.lim[j].mode = (uint32_t)r[1];
    t.lim[j].per_row = (uint32_t)r[2];
  }
  unsigned long long chunks = 0;
  int lane = 0;
  t.lane[0].chunk_lo = 0;
  t.lane[0].leaf_lo = 0;
  for (int j = 0; j < nleaves; ++j) {
    const long long* r = leaves + 8 * j;
    const int kind = (int)r[1];
    if (kind < 0 || kind > 3 || r[2] < 1 || r[3] < 1 ||
        r[2] * r[3] >= (1ll << 32) || r[6] < 0 || r[6] > nlimits ||
        r[7] < lane || r[7] >= nlanes || (kind == 3 && r[6] != 0))
      return (int)cudaErrorInvalidValue;
    while (lane < r[7]) {        // close lane, open the next at this row
      t.lane[lane].chunk_hi = chunks;
      ++lane;
      t.lane[lane].chunk_lo = chunks;
      t.lane[lane].leaf_lo = j;
    }
    const unsigned long long esize = kind == 1 ? 2 : (kind == 2 ? 8 : 4);
    const unsigned long long per = 16 / esize;
    Leaf& L = t.leaf[j];
    L.ptr = reinterpret_cast<const void*>(r[0]);
    L.base = (unsigned long long)r[5];
    L.stride = (unsigned long long)r[4];
    L.rows = (uint32_t)r[2];
    L.run = (uint32_t)r[3];
    L.cpr = (uint32_t)((L.run + per - 1) / per);
    const bool vec = kind != 3 && r[0] % 16 == 0 &&
                     (r[2] == 1 || (r[4] * esize) % 16 == 0);
    L.kind_vec = (uint32_t)kind | (vec ? 4u : 0u) | ((uint32_t)r[6] << 8);
    chunks += (unsigned long long)L.rows * L.cpr;
    L.chunk_end = chunks;
  }
  t.lane[lane].chunk_hi = chunks;
  while (++lane < nlanes) {      // lanes with no rows hash nothing
    t.lane[lane].chunk_lo = t.lane[lane].chunk_hi = chunks;
    t.lane[lane].leaf_lo = nleaves;
  }
  t.nleaves = nleaves;
  t.nchunks = chunks;
  t.nlanes = nlanes;
  t.bpl = bpl;
  fp_leaves<N><<<nlanes * bpl, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<Acc*>(partials), static_cast<unsigned int*>(ticket),
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: nleaves rows of 8 values (pointer, kind, rows, run, row stride in
// elements, first index within its lane, row limit index + 1 or 0, lane),
// in lane order; rows and run >= 1, rows * run < 2^32 words per leaf,
// nleaves <= MAX_LEAVES. limits: nlimits rows of 3 values (pointer to the
// int32/int64 limit element, (1 if int64 else 0) | ring rows W << 1,
// elements per row), nlimits <= MAX_LIMITS. nlanes <= MAX_LANES groups of
// bpl blocks, nlanes * bpl <= the partials' rows.
// partials: nlanes * bpl * 16 bytes and ticket: one unsigned int (0 on
// entry, 0 again after the launch) of the caller's per-stream workspace;
// out: 4 words per lane. Returns cudaGetLastError() after the one launch.
extern "C" int sedar_fingerprint_leaves(const long long* leaves, int nleaves,
                                        const long long* limits, int nlimits,
                                        int nlanes, int bpl, void* partials,
                                        void* ticket, void* out,
                                        void* stream) {
  if (nleaves < 0 || nleaves > MAX_LEAVES || nlimits < 0 ||
      nlimits > MAX_LIMITS || nlanes < 1 || nlanes > MAX_LANES || bpl < 1)
    return (int)cudaErrorInvalidValue;
  return nleaves <= SMALL_LEAVES
             ? fill_and_launch<SMALL_LEAVES>(leaves, nleaves, limits, nlimits,
                                             nlanes, bpl, partials, ticket,
                                             out, stream)
             : fill_and_launch<MAX_LEAVES>(leaves, nleaves, limits, nlimits,
                                           nlanes, bpl, partials, ticket, out,
                                           stream);
}
