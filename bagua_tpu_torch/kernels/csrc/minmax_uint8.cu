// MinMaxUInt8 codec for Hopper (sm_90a): compress, decompress, and the fused
// dequantize -> reduce -> requantize of ByteGrad's middle stage.
//
// Replaces the three Pallas TPU kernels of bagua_tpu/kernels/minmax_uint8.py:
//   compress        _compress_kernel      (pallas_call at minmax_uint8.py:195)
//   decompress      _decompress_kernel    (pallas_call at minmax_uint8.py:232)
//   fused reduce    _fused_reduce_kernel  (pallas_call at minmax_uint8.py:318)
//
// Semantics, per row ("chunk") of the input, exactly as the jnp reference:
//   scale = 255 / min(max - min + 1e-7 + 1e-35 * max(|min|, |max|), FLT_MAX)
//   upper = rint(max * scale), lower = upper - 255
//   q     = u8(min(rint(x * scale), upper) - lower)
//   x'    = (q + lower) / scale
// Every result is bitwise equal to the plain PyTorch version beside the
// wrappers (bagua_tpu_torch/kernels/minmax_uint8.py), by XLA's float rules
// (xla_float.cuh): no contracted FMA, rintf, NaN-propagating min/max that
// order -0 below +0, and the saturating f32 -> u8 convert.
//
// Design.  The TPU kernels hold a whole chunk in VMEM for one grid step; on
// this card a chunk reaches 25.7 M elements (VGG16's Dense_0 kernel split 4
// ways), far beyond a block's shared memory, so a chunk-wide min/max needs a
// reduction across blocks (no atomics; deterministic: min/max do not depend
// on the order they fold in).
//   compress   (1 launch up to kRowMax = 16384 elements a chunk, else 2): below
//   decompress (1 launch):   elementwise, each block computes its row's scale
//   fused      (2 launches, 1 for a chunk of one 4096-element tile): below
// Bound: device-memory bytes.  Least bytes per element of a chunk: compress
// 4 in + 1 out, decompress 1 in + 4 out, fused n in + 1 out.  Compress reads
// a chunk longer than kRowMax twice (9 B an element, less what the second
// read finds in L2); decompress moves its 5.
//
// Compress.  Min/max fold as integer keys (MinMax: one integer min and max
// an element, where XLA's NaN- and sign-aware float min/max is six
// instructions), warps by redux.sync.
//   * A chunk of at most kRowMax elements is one CTA's (compress_rows): a
//     thread holds 16 elements, its four 16-byte loads issued before the
//     fold; the block folds by one barrier, every thread derives (scale,
//     upper) and quantizes from registers, 16 bytes stored at once.  Every
//     input is read once.  Rows up to 4096 take 256 threads (the int8
//     ring's blocks; 6 CTAs an SM), up to 16384 up to 1024.
//   * Longer chunks: pass 1 (compress_fold) is one wave of CTAs over all
//     rows, each row's share of the CTAs walking its tiles (256 threads x 4
//     16-byte loads in flight each) and writing one partial of keys; pass 2
//     (compress_quantize), the same grid, folds the row's partials in every
//     CTA and quantizes the CTA's tiles in the reverse of pass 1's order, so
//     the bytes pass 1 read last, which the 50 MB L2 may still hold, are
//     read first.
//   * Chunks not a whole number of 16 elements, or views off a 16-byte
//     boundary, load and store element by element (a stride of the block).
//
// The fused reduce, per element of a rank's chunk (n peers):
//   * No division.  A peer's dequantized value takes one of 256 values, so
//     each CTA builds, in shared memory, the table of every peer's 256
//     values, each entry dequantize() itself (bitwise the division): n KB,
//     built once a CTA for n <= kGroup = 32, else group by group in
//     increasing p per tile.  The average divides by n (__fdiv_rn), or
//     multiplies by 1/n where n is a power of two: the same number.
//   * A thread holds 16 neighbouring elements: one 16-byte load of each
//     peer, 4 peers' loads issued together (a byte at a time, 16 strided
//     elements, where the chunk or a pointer is not 16-byte aligned).
//   * Pass 1 (fused_sum_minmax) sums the peers left to right from +0 and
//     folds min/max as integer keys (MinMax: one integer min and max an
//     element); one partial a CTA.  Pass 2 (fused_quantize): every CTA folds
//     its rank's partials, then quantizes the sums, recomputed from the u8
//     inputs by the same operations in the same order for n < 8 (2n + 1
//     bytes an element: 9 at n = 4), read back from the (R, chunk) f32 red
//     from n = 8 on (n + 9 bytes; equal at n = 8).
//   * Each pass runs one wave of 4 CTAs an SM over all ranks (2 for pass 1
//     storing red, whose group walk needs more registers), each CTA walking
//     tiles of 4096 elements; a chunk of one tile takes fused_one_tile, one
//     launch with the sums in registers.
// ptxas (sm_90a, nvcc 12.8, -fmad=false): the fused kernels use 40-64
// registers at 4 CTAs an SM (92 for pass 1 storing red), static shared
// memory 64-80 bytes beside their n KB of tables; compress's one-pass
// kernels 32 registers on the vector path (so 8 CTAs of 256 an SM fit) and
// 46-48 on the scalar, its two passes 29-32 (8 CTAs an SM); no stack frame
// and no spill in any instantiation (PERF.md holds the build's lines).

#include <algorithm>

#include "xla_float.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTile = 16384;  // elements of one row per decompress block
constexpr float kLevels = 255.0f;

__device__ __forceinline__ int64_t tile_end(int64_t begin, int64_t chunk) {
  return begin + kTile < chunk ? begin + kTile : chunk;
}

__device__ __forceinline__ float safe_scale(float mn, float mx) {
  return xla::safe_scale(mn, mx, kLevels);
}

__device__ __forceinline__ uint8_t quantize(float x, float scale, float upper) {
  const float level = xla::min(rintf(__fmul_rn(x, scale)), upper);
  return xla::to_u8(__fsub_rn(level, __fsub_rn(upper, kLevels)));
}

// Four elements' levels with p = (scale, upper), the first in the low byte.
__device__ __forceinline__ uint32_t quantize4(float a, float b, float c, float d, float2 p) {
  return static_cast<uint32_t>(quantize(a, p.x, p.y)) | static_cast<uint32_t>(quantize(b, p.x, p.y)) << 8 |
         static_cast<uint32_t>(quantize(c, p.x, p.y)) << 16 | static_cast<uint32_t>(quantize(d, p.x, p.y)) << 24;
}

__device__ __forceinline__ float dequantize(uint8_t q, float scale, float lower) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(q), lower), scale);
}

// ---------------------------------------------------------------------------
// The fused reduce, in two launches with no division per element.
//
// Each CTA serves one rank and walks the tiles c, c + ctas, ... of its chunk
// (kFusedTile elements each, kPer per thread: 16 neighbours, one 16-byte load
// per peer, or a stride of the block on the scalar path).  A peer's
// dequantized value takes one of 256 values, so the CTA keeps a table of
// them in shared memory, each entry dequantize() itself.  Pass 1 sums the
// peers left to right from +0 and folds the tile min/max into one partial
// per CTA (and, from kScratchPeers peers on, stores the sums in red); pass 2
// folds the rank's partials in every CTA, then quantizes the sums, read back
// from red or recomputed from the u8 inputs by the same operations in the
// same order.
// ---------------------------------------------------------------------------

constexpr int kFusedThreads = 256;
constexpr int kPer = 16;                              // elements a thread holds per tile
constexpr int64_t kFusedTile = kFusedThreads * kPer;  // 4096 elements of one rank's chunk
constexpr int kGroup = 32;                            // peers' tables in shared memory at once
constexpr int kBatch = 4;                             // peers whose loads go out together
constexpr int kScratchPeers = 8;  // from here on the sums go through red: n + 9 <= 2n + 1 bytes
static_assert(kScratchPeers <= kGroup, "the recomputing passes build every table at once");
// CTAs an SM each pass asks registers for, and sizes its grid by: the
// recomputing passes (knobs for chip_kernel_ab.py --variant), then pass 1
// storing its sums (which may walk groups of tables) and pass 2 reading them
#ifndef FUSED_CTAS_PASS1
#define FUSED_CTAS_PASS1 4
#endif
#ifndef FUSED_CTAS_PASS2
#define FUSED_CTAS_PASS2 4
#endif
constexpr int kStoreCtas = 2;
constexpr int kFromRedCtas = 4;
constexpr int kMaxCtasPerRank = 1024;
constexpr int kMaxPeers = 6144;

enum Average { kSum = 0, kDivide = 1, kMultiply = 2 };  // kMultiply: by 1/n, n a power of 2

// Tables of peers p0 .. p0 + cnt - 1: tab[k * 256 + l] = dequantize(l) of
// peer p0 + k.  Every thread of the CTA calls it.
__device__ __forceinline__ void build_tables(float* tab, const float* __restrict__ mm, int p0,
                                             int cnt) {
  __syncthreads();  // the previous group's lookups are done
  for (int e = threadIdx.x; e < cnt * 256; e += kFusedThreads) {
    const int p = p0 + (e >> 8);
    const float pmx = mm[2 * p + 1];
    const float s = safe_scale(mm[2 * p], pmx);
    tab[e] = dequantize(static_cast<uint8_t>(e & 255), s, __fsub_rn(rintf(__fmul_rn(pmx, s)), kLevels));
  }
  __syncthreads();
}

// Column of this thread's element k in the tile that starts at begin.
template <bool kVec>
__device__ __forceinline__ int64_t column(int64_t begin, int k) {
  return kVec ? begin + threadIdx.x * kPer + k : begin + k * kFusedThreads + threadIdx.x;
}

__device__ __forceinline__ void add_levels(float (&acc)[kPer], int k0, uint32_t w, const float* t) {
  acc[k0] = __fadd_rn(acc[k0], t[w & 0xFFu]);
  acc[k0 + 1] = __fadd_rn(acc[k0 + 1], t[(w >> 8) & 0xFFu]);
  acc[k0 + 2] = __fadd_rn(acc[k0 + 2], t[(w >> 16) & 0xFFu]);
  acc[k0 + 3] = __fadd_rn(acc[k0 + 3], t[w >> 24]);
}

// acc[k] += peer p's value at column k, for p = p0 .. p0 + cnt - 1 in order.
template <bool kVec>
__device__ __forceinline__ void accumulate(float (&acc)[kPer], const uint8_t* __restrict__ qr,
                                           const float* tab, int p0, int cnt, int64_t chunk,
                                           int64_t begin, int64_t end) {
  if (kVec) {
    const int64_t c0 = column<true>(begin, 0);
    if (c0 >= end) return;
    int k = 0;
    for (; k + kBatch <= cnt; k += kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        v[b] = *reinterpret_cast<const uint4*>(qr + (p0 + k + b) * chunk + c0);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float* t = tab + (k + b) * 256;
        add_levels(acc, 0, v[b].x, t);
        add_levels(acc, 4, v[b].y, t);
        add_levels(acc, 8, v[b].z, t);
        add_levels(acc, 12, v[b].w, t);
      }
    }
    for (; k < cnt; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(qr + (p0 + k) * chunk + c0);
      const float* t = tab + k * 256;
      add_levels(acc, 0, v.x, t);
      add_levels(acc, 4, v.y, t);
      add_levels(acc, 8, v.z, t);
      add_levels(acc, 12, v.w, t);
    }
  } else {
    for (int k = 0; k < cnt; ++k) {
      const uint8_t* qp = qr + (p0 + k) * chunk;
      uint8_t b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int64_t c = column<false>(begin, i);
        b[i] = c < end ? qp[c] : 0;
      }
      const float* t = tab + k * 256;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = __fadd_rn(acc[i], t[b[i]]);
    }
  }
}

// The thread's kPer sums of the tile [begin, end) of rank r, [/ n].  With
// more than kGroup peers the tables are rebuilt group by group (kGroups:
// the caller may have that many; else n <= kGroup and the tables are built).
template <bool kVec, bool kGroups>
__device__ __forceinline__ void tile_sums(float (&acc)[kPer], const uint8_t* __restrict__ qr,
                                          const float* __restrict__ mm, float* tab, int n,
                                          int64_t chunk, int64_t begin, int64_t end, int mode,
                                          float recip) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  if (!kGroups || n <= kGroup) {
    accumulate<kVec>(acc, qr, tab, 0, n, chunk, begin, end);
  } else {
    for (int p0 = 0; p0 < n; p0 += kGroup) {
      const int cnt = n - p0 < kGroup ? n - p0 : kGroup;
      build_tables(tab, mm, p0, cnt);
      accumulate<kVec>(acc, qr, tab, p0, cnt, chunk, begin, end);
    }
  }
  if (mode == kDivide) {
    const float nf = static_cast<float>(n);
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = __fdiv_rn(acc[i], nf);
  } else if (mode == kMultiply) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = __fmul_rn(acc[i], recip);
  }
}

__device__ __forceinline__ int64_t fused_end(int64_t begin, int64_t chunk) {
  return begin + kFusedTile < chunk ? begin + kFusedTile : chunk;
}

// Running min/max in XLA's order (NaN propagates, -0 below +0).  Each value
// becomes an integer key that orders as the floats do, -0 below +0 and
// NaNs beyond the infinities, so an element costs one integer min and one
// max; get() turns any NaN into both results.
struct MinMax {
  static constexpr int32_t kPosInf = 0x7f800000, kNegInf = static_cast<int32_t>(0x807fffff);
  int32_t lo = kPosInf, hi = kNegInf;
  __device__ __forceinline__ static int32_t key(float x) {
    const int32_t b = __float_as_int(x);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  __device__ __forceinline__ void add(float x) {
    const int32_t k = key(x);
    lo = k < lo ? k : lo;
    hi = k > hi ? k : hi;
  }
  __device__ __forceinline__ void get(float& mn, float& mx) const {
    if (lo < kNegInf || hi > kPosInf) {
      mn = mx = __int_as_float(0x7fffffff);
    } else {
      mn = __int_as_float(lo ^ ((lo >> 31) & 0x7fffffff));
      mx = __int_as_float(hi ^ ((hi >> 31) & 0x7fffffff));
    }
  }
};

// Folds this thread's sums of the tile [begin, end) into m; kStore: stores
// them in out.
template <bool kVec, bool kStore>
__device__ __forceinline__ void fold_sums(const float (&acc)[kPer], float* __restrict__ out,
                                          int64_t begin, int64_t end, MinMax& m) {
  if (kVec) {
    const int64_t c0 = column<true>(begin, 0);
    if (c0 >= end) return;
#pragma unroll
    for (int i = 0; i < kPer; ++i) m.add(acc[i]);
    if (kStore) {
      float4* o4 = reinterpret_cast<float4*>(out + c0);
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j)
        o4[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t c = column<false>(begin, i);
      if (c < end) {
        m.add(acc[i]);
        if (kStore) out[c] = acc[i];
      }
    }
  }
}

// Quantizes this thread's sums of the tile [begin, end) with (scale, upper).
template <bool kVec>
__device__ __forceinline__ void quantize_sums(const float (&acc)[kPer], uint8_t* __restrict__ qo,
                                              int64_t begin, int64_t end, float2 p) {
  if (kVec) {
    const int64_t c0 = column<true>(begin, 0);
    if (c0 >= end) return;
    uint32_t w[kPer / 4];
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j)
      w[j] = static_cast<uint32_t>(quantize(acc[4 * j], p.x, p.y)) |
             static_cast<uint32_t>(quantize(acc[4 * j + 1], p.x, p.y)) << 8 |
             static_cast<uint32_t>(quantize(acc[4 * j + 2], p.x, p.y)) << 16 |
             static_cast<uint32_t>(quantize(acc[4 * j + 3], p.x, p.y)) << 24;
    *reinterpret_cast<uint4*>(qo + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t c = column<false>(begin, i);
      if (c < end) qo[c] = quantize(acc[i], p.x, p.y);
    }
  }
}

// Pass 1: the sums of every tile this CTA walks, their min/max folded into
// partial[blockIdx.x]; kStore: the sums stored in red.
template <bool kVec, bool kStore>
__global__ void __launch_bounds__(kFusedThreads, kStore ? kStoreCtas : FUSED_CTAS_PASS1)
fused_sum_minmax(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
                 float* __restrict__ red, float2* __restrict__ partial, int n, int64_t chunk,
                 int64_t tiles, int ctas, int mode, float recip) {
  extern __shared__ float tab[];
  const int r = blockIdx.x / ctas;
  const uint8_t* qr = q + static_cast<int64_t>(r) * n * chunk;
  const float* mm = minmax + 2LL * r * n;
  float* out = red + static_cast<int64_t>(r) * chunk;
  if (n <= kGroup) build_tables(tab, mm, 0, n);
  MinMax m;
  for (int64_t t = blockIdx.x - r * ctas; t < tiles; t += ctas) {
    const int64_t begin = t * kFusedTile, end = fused_end(begin, chunk);
    float acc[kPer];
    tile_sums<kVec, kStore>(acc, qr, mm, tab, n, chunk, begin, end, mode, recip);
    fold_sums<kVec, kStore>(acc, out, begin, end, m);
  }
  float mn, mx;
  m.get(mn, mx);
  xla::block_minmax<kFusedThreads>(mn, mx);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_float2(mn, mx);
}

// Pass 2: every CTA folds its rank's parts partials into (scale, upper);
// the first writes mm_out.  Then the sums of each tile, from red
// (kFromRed) or recomputed, are quantized.
template <bool kVec, bool kFromRed>
__global__ void __launch_bounds__(kFusedThreads, kFromRed ? kFromRedCtas : FUSED_CTAS_PASS2)
fused_quantize(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
               const float* __restrict__ red, const float2* __restrict__ partial,
               uint8_t* __restrict__ q_out, float* __restrict__ mm_out, int n, int64_t chunk,
               int64_t tiles, int parts, int ctas, int mode, float recip) {
  extern __shared__ float tab[];
  __shared__ float2 params;  // (scale, upper)
  const int r = blockIdx.x / ctas;
  const int c = blockIdx.x - r * ctas;
  const uint8_t* qr = q + static_cast<int64_t>(r) * n * chunk;
  const float* mm = minmax + 2LL * r * n;
  const float* in = red + static_cast<int64_t>(r) * chunk;
  uint8_t* qo = q_out + static_cast<int64_t>(r) * chunk;
  float mn = INFINITY, mx = -INFINITY;
  for (int i = threadIdx.x; i < parts; i += kFusedThreads) {
    const float2 p = partial[r * parts + i];
    mn = xla::min(mn, p.x);
    mx = xla::max(mx, p.y);
  }
  xla::block_minmax<kFusedThreads>(mn, mx);
  if (threadIdx.x == 0) {
    const float s = safe_scale(mn, mx);
    params = make_float2(s, rintf(__fmul_rn(mx, s)));
    if (c == 0) {
      mm_out[2 * r] = mn;
      mm_out[2 * r + 1] = mx;
    }
  }
  if (!kFromRed && n <= kGroup) build_tables(tab, mm, 0, n);  // its barriers publish params
  else __syncthreads();
  const float2 p = params;
  for (int64_t t = c; t < tiles; t += ctas) {
    const int64_t begin = t * kFusedTile, end = fused_end(begin, chunk);
    float acc[kPer];
    if (kFromRed) {
      if (kVec) {
        const int64_t c0 = column<true>(begin, 0);
        if (c0 < end) {
          const float4* i4 = reinterpret_cast<const float4*>(in + c0);
#pragma unroll
          for (int j = 0; j < kPer / 4; ++j) {
            const float4 v = i4[j];
            acc[4 * j] = v.x, acc[4 * j + 1] = v.y, acc[4 * j + 2] = v.z, acc[4 * j + 3] = v.w;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int64_t col = column<false>(begin, i);
          acc[i] = col < end ? in[col] : 0.0f;
        }
      }
    } else {
      tile_sums<kVec, false>(acc, qr, mm, tab, n, chunk, begin, end, mode, recip);
    }
    quantize_sums<kVec>(acc, qo, begin, end, p);
  }
}

// A chunk of one tile: one CTA per rank sums, reduces and quantizes it in a
// single launch, the sums held in registers.
template <bool kVec>
__global__ void __launch_bounds__(kFusedThreads)
fused_one_tile(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
               uint8_t* __restrict__ q_out, float* __restrict__ mm_out, int n, int64_t chunk,
               int mode, float recip) {
  extern __shared__ float tab[];
  __shared__ float2 params;  // (scale, upper)
  const int r = blockIdx.x;
  const uint8_t* qr = q + static_cast<int64_t>(r) * n * chunk;
  const float* mm = minmax + 2LL * r * n;
  if (n <= kGroup) build_tables(tab, mm, 0, n);
  float acc[kPer];
  tile_sums<kVec, true>(acc, qr, mm, tab, n, chunk, 0, chunk, mode, recip);
  MinMax m;
  fold_sums<kVec, false>(acc, nullptr, 0, chunk, m);
  float mn, mx;
  m.get(mn, mx);
  xla::block_minmax<kFusedThreads>(mn, mx);
  if (threadIdx.x == 0) {
    const float s = safe_scale(mn, mx);
    params = make_float2(s, rintf(__fmul_rn(mx, s)));
    mm_out[2 * r] = mn;
    mm_out[2 * r + 1] = mx;
  }
  __syncthreads();
  quantize_sums<kVec>(acc, q_out + static_cast<int64_t>(r) * chunk, 0, chunk, params);
}

// ---------------------------------------------------------------------------
// Compress: one launch for a chunk a CTA holds, two for longer ones.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;                              // chunks up to 4096 elements
constexpr int kRowMinBlocks = 6;                              // CTAs an SM of 256 (32 registers)
constexpr int kLongRowThreads = 1024;                         // up to kRowMax, still in registers
constexpr int64_t kRowMax = kLongRowThreads * kPer;           // 16384
constexpr int kWalkThreads = 256;                             // the two-pass kernels
constexpr int kWalkLoads = 4;                                 // 16-byte loads a thread a tile
constexpr int64_t kWalkTile = kWalkThreads * 4 * kWalkLoads;  // 4096 elements of a row
constexpr int kWalkCtas = 8;                                  // CTAs an SM of each pass

// m folded over the block (a whole number of warps, at most 32); every
// thread gets the result.
__device__ __forceinline__ void block_keys(MinMax& m, int32_t* s_lo, int32_t* s_hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  m.lo = __reduce_min_sync(0xffffffffu, m.lo);
  m.hi = __reduce_max_sync(0xffffffffu, m.hi);
  if (lane == 0) {
    s_lo[warp] = m.lo;
    s_hi[warp] = m.hi;
  }
  __syncthreads();
  const bool live = lane < static_cast<int>(blockDim.x >> 5);
  m.lo = __reduce_min_sync(0xffffffffu, live ? s_lo[lane] : MinMax::kPosInf);
  m.hi = __reduce_max_sync(0xffffffffu, live ? s_hi[lane] : MinMax::kNegInf);
}

// The row's (min, max) from its folded keys, as (scale, upper); the
// caller's writer stores (min, max) in mm.
__device__ __forceinline__ float2 row_params(const MinMax& m, float* mm, bool writer) {
  float mn, mx;
  m.get(mn, mx);
  if (writer) {
    mm[0] = mn;
    mm[1] = mx;
  }
  const float s = safe_scale(mn, mx);
  return make_float2(s, rintf(__fmul_rn(mx, s)));
}

// One CTA a row of at most kMaxThreads * kPer elements.  Vector path: the
// thread's kPer neighbours from threadIdx.x * kPer; scalar path: element k
// at k * blockDim.x + threadIdx.x.
template <bool kVec, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, kVec && kMaxThreads == kRowThreads ? kRowMinBlocks : 1)
compress_rows(const float* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ minmax,
              int chunk) {
  __shared__ int32_t s_lo[kMaxThreads / 32], s_hi[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * chunk;
  const int c0 = kVec ? threadIdx.x * kPer : threadIdx.x;
  float v[kPer];
  MinMax m;
  if (kVec) {
    if (c0 < chunk) {
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(xr + c0 + 4 * j);
        v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z, v[4 * j + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) m.add(v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = c0 + i * static_cast<int>(blockDim.x);
      v[i] = c < chunk ? xr[c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (c0 + i * static_cast<int>(blockDim.x) < chunk) m.add(v[i]);
  }
  block_keys(m, s_lo, s_hi);
  const float2 p = row_params(m, minmax + 2 * row, threadIdx.x == 0);
  uint8_t* qr = q + row * chunk;
  if (kVec) {
    if (c0 < chunk)
      *reinterpret_cast<uint4*>(qr + c0) =
          make_uint4(quantize4(v[0], v[1], v[2], v[3], p), quantize4(v[4], v[5], v[6], v[7], p),
                     quantize4(v[8], v[9], v[10], v[11], p), quantize4(v[12], v[13], v[14], v[15], p));
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = c0 + i * static_cast<int>(blockDim.x);
      if (c < chunk) qr[c] = quantize(v[i], p.x, p.y);
    }
  }
}

// Element (vector path: float4) k of this thread in the tile that starts
// at begin: a stride of the block, so each load of a warp is contiguous.
template <bool kVec>
__device__ __forceinline__ int64_t walk_column(int64_t begin, int k) {
  return begin + (static_cast<int64_t>(k) * kWalkThreads + threadIdx.x) * (kVec ? 4 : 1);
}

// This thread's elements of the tile at begin: kWalkLoads float4 (vector
// path) or 4 * kWalkLoads floats, those past the row's end left unset.
template <bool kVec>
__device__ __forceinline__ void walk_load(float (&v)[4 * kWalkLoads], const float* __restrict__ xr,
                                          int64_t begin, int64_t chunk) {
#pragma unroll
  for (int k = 0; k < (kVec ? kWalkLoads : 4 * kWalkLoads); ++k) {
    const int64_t c = walk_column<kVec>(begin, k);
    if (c < chunk) {
      if (kVec) {
        const float4 f = *reinterpret_cast<const float4*>(xr + c);
        v[4 * k] = f.x, v[4 * k + 1] = f.y, v[4 * k + 2] = f.z, v[4 * k + 3] = f.w;
      } else {
        v[k] = xr[c];
      }
    }
  }
}

// Pass 1 over chunks longer than kRowMax: CTA c of each row's ctas walks
// the tiles c, c + ctas, ... and writes its keys' (lo, hi) to
// partial[blockIdx.x].
template <bool kVec>
__global__ void __launch_bounds__(kWalkThreads, kWalkCtas)
compress_fold(const float* __restrict__ x, int2* __restrict__ partial, int64_t chunk, int64_t tiles,
              int ctas) {
  __shared__ int32_t s_lo[kWalkThreads / 32], s_hi[kWalkThreads / 32];
  const int64_t row = blockIdx.x / ctas;
  const float* xr = x + row * chunk;
  MinMax m;
  for (int64_t t = blockIdx.x - row * ctas; t < tiles; t += ctas) {
    const int64_t begin = t * kWalkTile;
    float v[4 * kWalkLoads];
    walk_load<kVec>(v, xr, begin, chunk);
#pragma unroll
    for (int k = 0; k < 4 * kWalkLoads; ++k)
      if (walk_column<kVec>(begin, kVec ? k / 4 : k) < chunk) m.add(v[k]);
  }
  block_keys(m, s_lo, s_hi);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_int2(m.lo, m.hi);
}

// Pass 2, on pass 1's grid: every CTA folds its row's ctas partials, the
// first writes the row's (min, max); then CTA c quantizes the tiles pass 1's
// CTA c walked, last first.
template <bool kVec>
__global__ void __launch_bounds__(kWalkThreads, kWalkCtas)
compress_quantize(const float* __restrict__ x, const int2* __restrict__ partial,
                  uint8_t* __restrict__ q, float* __restrict__ minmax, int64_t chunk, int64_t tiles,
                  int ctas) {
  __shared__ int32_t s_lo[kWalkThreads / 32], s_hi[kWalkThreads / 32];
  const int64_t row = blockIdx.x / ctas;
  const int64_t c = blockIdx.x - row * ctas;
  MinMax m;
  for (int i = threadIdx.x; i < ctas; i += kWalkThreads) {
    const int2 k = partial[row * ctas + i];
    m.lo = k.x < m.lo ? k.x : m.lo;
    m.hi = k.y > m.hi ? k.y : m.hi;
  }
  block_keys(m, s_lo, s_hi);
  const float2 p = row_params(m, minmax + 2 * row, c == 0 && threadIdx.x == 0);
  const float* xr = x + row * chunk;
  uint8_t* qr = q + row * chunk;
  for (int64_t t = c + (tiles - 1 - c) / ctas * ctas; t >= 0; t -= ctas) {
    const int64_t begin = t * kWalkTile;
    float v[4 * kWalkLoads];
    walk_load<kVec>(v, xr, begin, chunk);
#pragma unroll
    for (int k = 0; k < (kVec ? kWalkLoads : 4 * kWalkLoads); ++k) {
      const int64_t col = walk_column<kVec>(begin, k);
      if (col < chunk) {
        if (kVec)
          *reinterpret_cast<uint32_t*>(qr + col) = quantize4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3], p);
        else
          qr[col] = quantize(v[k], p.x, p.y);
      }
    }
  }
}

// Decompress one tile of one row; each thread derives the row's scale.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequantize_tile(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
                float* __restrict__ out, int64_t chunk, int64_t tiles) {
  const int64_t row = blockIdx.x / tiles;
  const int64_t begin = (blockIdx.x - row * tiles) * kTile;
  const int64_t end = tile_end(begin, chunk);
  const float mx = minmax[2 * row + 1];
  const float s = safe_scale(minmax[2 * row], mx);
  const float lower = __fsub_rn(rintf(__fmul_rn(mx, s)), kLevels);
  const uint8_t* qr = q + row * chunk;
  float* o = out + row * chunk;
  if (kVec) {
    const uchar4* q4 = reinterpret_cast<const uchar4*>(qr);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int64_t i = begin / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      const uchar4 v = q4[i];
      o4[i] = make_float4(dequantize(v.x, s, lower), dequantize(v.y, s, lower),
                          dequantize(v.z, s, lower), dequantize(v.w, s, lower));
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads)
      o[i] = dequantize(qr[i], s, lower);
  }
}

int64_t tiles_of(int64_t chunk) { return (chunk + kTile - 1) / kTile; }

int64_t fused_tiles(int64_t chunk) { return (chunk + kFusedTile - 1) / kFusedTile; }

// CTAs a rank (a row) for a pass of the fused reduce or compress: one wave
// of `resident` CTAs over all ranks at most (kMaxCtasPerRank a rank), each
// walking the same number of tiles but for the last ones.
int64_t wave_ctas(int64_t tiles, int64_t ranks, int64_t resident) {
  const int64_t most = std::min<int64_t>(std::max<int64_t>(resident / ranks, 1), kMaxCtasPerRank);
  const int64_t walk = (tiles + most - 1) / most;
  return (tiles + walk - 1) / walk;
}

// The current device's SMs.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Rows x tiles blocks must fit a 1-D grid.
bool grid_ok(int64_t rows, int64_t chunk) {
  return rows > 0 && chunk > 0 && rows * tiles_of(chunk) <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Partials a row of chunk elements may need, less one: the caller sizes the
// scratch of compress and the fused reduce as 2 * rows * (tiles + 1) floats,
// or passes none where tiles is -1.  The sentinel is the fused reduce's: a
// chunk of one 4096-element tile, which it takes in one launch without
// scratch (so does compress).  Compress also leaves the scratch of chunks of
// 4097 to kRowMax elements unread (at most 10 floats a row).  At most one
// partial a tile of either and kMaxCtasPerRank a row.
int64_t bagua_minmax_u8_tiles(int64_t chunk) {
  static_assert(kWalkTile == kFusedTile, "one count of tiles serves compress and the fused reduce");
  return chunk <= kFusedTile ? -1 : std::min<int64_t>(fused_tiles(chunk), kMaxCtasPerRank);
}

// x (rows, chunk) f32 -> q (rows, chunk) u8, minmax (rows, 2) f32.  scratch:
// see bagua_minmax_u8_tiles; unread for chunks up to kRowMax, may be null.
int bagua_compress_minmax_u8(const float* x, uint8_t* q, float* minmax,
                             float* scratch, int64_t rows, int64_t chunk,
                             void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows);
  if (chunk <= kRowMax) {
    const int n = static_cast<int>(chunk);
    const bool vec = n % kPer == 0 && aligned(x, 16) && aligned(q, 16);
    const unsigned threads = static_cast<unsigned>(((n + kPer - 1) / kPer + 31) / 32 * 32);
    if (threads <= kRowThreads) {
      auto* k = vec ? compress_rows<true, kRowThreads> : compress_rows<false, kRowThreads>;
      k<<<grid, threads, 0, s>>>(x, q, minmax, n);
    } else {
      auto* k = vec ? compress_rows<true, kLongRowThreads> : compress_rows<false, kLongRowThreads>;
      k<<<grid, threads, 0, s>>>(x, q, minmax, n);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = fused_tiles(chunk);
  const int64_t ctas = wave_ctas(tiles, rows, sms * kWalkCtas);
  if (rows * ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = chunk % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  int2* partial = reinterpret_cast<int2*>(scratch);
  const unsigned wave = static_cast<unsigned>(rows * ctas);
  (vec ? compress_fold<true> : compress_fold<false>)<<<wave, kWalkThreads, 0, s>>>(
      x, partial, chunk, tiles, static_cast<int>(ctas));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  (vec ? compress_quantize<true> : compress_quantize<false>)<<<wave, kWalkThreads, 0, s>>>(
      x, partial, q, minmax, chunk, tiles, static_cast<int>(ctas));
  return static_cast<int>(cudaGetLastError());
}

// q (rows, chunk) u8, minmax (rows, 2) f32 -> out (rows, chunk) f32.
int bagua_decompress_minmax_u8(const uint8_t* q, const float* minmax, float* out,
                               int64_t rows, int64_t chunk, void* stream) {
  if (!grid_ok(rows, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(chunk);
  const bool vec = chunk % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  const unsigned grid = static_cast<unsigned>(rows * tiles);
  if (vec) dequantize_tile<true><<<grid, kThreads, 0, s>>>(q, minmax, out, chunk, tiles);
  else dequantize_tile<false><<<grid, kThreads, 0, s>>>(q, minmax, out, chunk, tiles);
  return static_cast<int>(cudaGetLastError());
}

// q (R, n, chunk) u8, minmax (R, n, 2) f32 -> q_out (R, chunk) u8,
// mm_out (R, 2) f32.  red is an (R, chunk) f32 scratch (used from
// kScratchPeers peers on), scratch holds 2 * R * (tiles + 1) floats.
int bagua_fused_reduce_minmax_u8(const uint8_t* q, const float* minmax,
                                 uint8_t* q_out, float* mm_out, float* red,
                                 float* scratch, int64_t ranks, int64_t n,
                                 int64_t chunk, int average, void* stream) {
  if (!grid_ok(ranks, chunk) || n <= 0 || n > kMaxPeers)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mode = !average ? kSum : (n & (n - 1)) == 0 ? kMultiply : kDivide;
  const float recip = 1.0f / static_cast<float>(n);  // exact where it is used
  const size_t smem = std::min<int64_t>(n, kGroup) * 256 * sizeof(float);
  const int64_t tiles = fused_tiles(chunk);
  if (tiles == 1) {
    const bool vec = chunk % kPer == 0 && aligned(q, 16) && aligned(q_out, 16);
    auto* one = vec ? fused_one_tile<true> : fused_one_tile<false>;
    one<<<static_cast<unsigned>(ranks), kFusedThreads, smem, s>>>(q, minmax, q_out, mm_out,
                                                                 static_cast<int>(n), chunk, mode, recip);
    return static_cast<int>(cudaGetLastError());
  }
  const bool store = n >= kScratchPeers;
  const int64_t ctas1 = wave_ctas(tiles, ranks, sms * (store ? kStoreCtas : FUSED_CTAS_PASS1));
  const int64_t ctas2 = wave_ctas(tiles, ranks, sms * (store ? kFromRedCtas : FUSED_CTAS_PASS2));
  if (ranks * std::max(ctas1, ctas2) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = chunk % kPer == 0 && aligned(q, 16) && aligned(q_out, 16) && aligned(red, 16);
  float2* partial = reinterpret_cast<float2*>(scratch);
  auto* pass1 = vec ? (store ? fused_sum_minmax<true, true> : fused_sum_minmax<true, false>)
                    : (store ? fused_sum_minmax<false, true> : fused_sum_minmax<false, false>);
  pass1<<<static_cast<unsigned>(ranks * ctas1), kFusedThreads, smem, s>>>(
      q, minmax, red, partial, static_cast<int>(n), chunk, tiles, static_cast<int>(ctas1), mode, recip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* pass2 = vec ? (store ? fused_quantize<true, true> : fused_quantize<true, false>)
                    : (store ? fused_quantize<false, true> : fused_quantize<false, false>);
  pass2<<<static_cast<unsigned>(ranks * ctas2), kFusedThreads, store ? 0 : smem, s>>>(
      q, minmax, red, partial, q_out, mm_out, static_cast<int>(n), chunk, tiles,
      static_cast<int>(ctas1), static_cast<int>(ctas2), mode, recip);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
