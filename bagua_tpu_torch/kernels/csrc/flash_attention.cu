// Blockwise (flash) attention for ring attention, for Hopper (sm_90a): one
// K/V block's unnormalized online-softmax contribution, and its backward with
// the row max held constant.
//
// Replaces the three Pallas TPU kernels of bagua_tpu/kernels/flash_attention.py:
//   bagua_flash_fwd      _tiled_flash_kernel     (body :187, pallas_call :314)
//   bagua_flash_bwd_dq   _flash_bwd_dq_kernel    (body :350, pallas_call :510)
//   bagua_flash_bwd_dkv  _flash_bwd_dkv_kernel   (body :386, pallas_call :543)
//
// Semantics (the plain versions in bagua_tpu_torch/kernels/flash_attention.py):
//   s  = qf . k^T per (batch, head); masked entries are NEG = -1e30
//   m  = row max of s;  p = where(mask, exp(s - m), 0);  l = row sum of p
//   o  = p . v                                   (unnormalized)
//   backward, m constant:  dp = do . v^T + dl;  ds = p * dp
//   dq = ds . k;  dv = p^T . do;  dk = ds^T . qf  (dk, dv summed over the g
//   query heads that share a K/V head, cast to k's type)
// Query head i of batch b reads K/V head (i % h) / g: grouped-query attention
// by index, no repeated K/V.  A row whose keys are all masked ends with
// (o, l, m) = (0, 0, NEG) and dq = 0.
//
// Layouts: qf (b, tq, h, d) f32; k, v (b, tk, h_kv, d) f32, bf16 or f16; mask
// (b, tq, tk) bool; each read through the caller's strides (d contiguous), so
// the ring's half-block views need no copy.  o (b, h, tq, d), l and m
// (b, h, tq), dq (b, tq, h, d), dk and dv (b, tk, h_kv, d) are written
// contiguous; do is read through strides, m and dl contiguous.
//
// Bound: f32 operations.  Per live (query, key) pair and head the forward
// does 4d operations (two products of d multiply-adds), dq 6d, dk/dv 8d, all
// on the CUDA cores (67 TFLOP/s on an H100 SXM), against O(t d) bytes.  The
// tensor cores would read TF32 inputs (10 mantissa bits, 2^-11 relative
// each), which spends a large part of the contract, the plain f32 versions
// within 2e-4 to 3e-4 of max(1, |value|) (the bounds the JAX package holds
// its Pallas kernels to), on input rounding alone; split-TF32 (three products
// per term) keeps f32 accuracy but sums in another order.  Either would need
// a tolerance and a check of its own, so these kernels stay full f32 FMA.
//
// One design for all three.  A CTA of 8 warps owns a tile of rows of one head
// (128 queries for the forward, 64 for dq, 64 keys for dk/dv) and walks the
// other side's live 64-row tiles in increasing order, keeping its running
// state in registers: nothing crosses CTAs, so there are no atomics and every
// result is deterministic.
// - Liveness: one coalesced scan of the CTA's mask rows (or columns) per
//   window of up to kWindow tiles, 16 bytes a load and 8 loads in flight,
//   sets one flag per tile; dead tiles are never loaded.  A CTA that no pair
//   of it can use loads no operand and writes zeros (the forward (0, 0, NEG)).
// - Latency: while one tile computes, the next live tile's operands and its
//   mask tile are copied by cp.async into the other of two stages (16-byte
//   copies where every row of the view is 16-byte aligned, else 4-byte for
//   f32).  bf16/f16 K/V cannot be widened by cp.async: the forward and dq
//   stage their raw 16-bit rows the same way and widen them into one f32
//   pair in shared memory after the stage lands (one pass and one barrier a
//   tile, no global load on the tile's critical path; rows off 16-byte
//   boundaries take plain loads).  dk/dv loads its one K/V tile with plain
//   widening loads.
// - Shared-memory bandwidth, which bounds the products: tiles are f32 rows of
//   d padded to D = 64 or 128 (zeros past d) with a row stride of D + 4
//   floats, so that a warp's float4 reads of 8 distinct rows fall on distinct
//   banks.  A warp's float4 read delivers 512 bytes, 4 clocks of the SM's 128
//   bytes a clock, while the SM does 4 warp FMAs a clock, so a thread's R x C
//   block of outputs (4 R C / (R + C) FMAs per float4 it reads) needs 16 FMAs
//   a read to keep the FMA pipes busy: 4 x 4 gives 8, 4 x 8 10.7, 4 x 16
//   12.8.  The products reach about 0.6-0.75 of that ceiling on the H100.
//
// flash_fwd_kernel: warp w owns queries 16w .. 16w + 15 and all 64 keys of a
// tile, so a row's online softmax reduces by shuffles over 8 lanes: lane (ly,
// lx) = (lane / 8, lane % 8) holds queries 16w + ly + 4r (r < 4) and keys lx
// + 8c (c < 8) of S, then the same queries and d columns 4 lx + 32q + {0..3}
// of o.  P takes the place of the tile's K once every warp is done with it
// (128 x 66 floats, float2 reads; D = 64 has room for a buffer of its own):
// two barriers a tile.  Per tile: m_new = max(m, row max), p = exp(s -
// m_new), corr = exp(m - m_new), l = l corr + row sum, o = o corr, then o +=
// P V: rescale, then accumulate.
// flash_bwd_dq_kernel: dk/dv's layout with queries and keys swapped, the
// keys of a tile split between the two warps of a pair.  Warp w owns queries
// 16 (w / 2) + ly + 4r and keys 32 (w % 2) + lx + 8c (r, c < 4) of S = Q K^T
// and dP = dO V^T, writes dS = P (dP + dl) to its own part of a [64][kPS]
// buffer and adds dS K over its 32 keys into all d columns 4 lx + 32q +
// {0..3} of its queries; the pair's two sums add once, at the end.  m and dl
// stay in registers.  One barrier a tile.
//
// Shared memory (bytes; above 48 KB opted into per launch; checked by the
// static_asserts at the launch) and occupancy, one CTA of 256 threads per SM:
//   forward  D = 128: Q 67,584 + K/V stages 135,168 + mask tiles 16,384 +
//            flags 1,024 = 220,160 (bf16/f16 K/V: one f32 pair 67,584 + raw
//            stages 65,536 -> 218,112); D = 64, with a P buffer of 33,792:
//            155,648 (bf16/f16 153,600).
//   dq       D = 128: Q and dO 67,584 + K/V stages 135,168 + dS 18,432 +
//            mask tiles 8,192 + flags 1,024 = 230,400 (bf16/f16: 228,352);
//            D = 64: 132,096 (bf16/f16 130,048).
//   dk/dv    D = 128: 231,424; D = 64: 133,120 (its section says what).
// Registers a thread (ptxas -v, sm_90a, CUDA 12.8; f32 / bf16 / f16 K/V at D
// = 64, then at D = 128), no instantiation with a stack frame: forward 254
// 252 252, 240 255 255; dq 254 248 248, 248 255 255; dk/dv 254 250 250,
// 254 254 254.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query or key rows per tile
constexpr int kPS = kTile + 8;  // row stride of a score tile: conflict-free stores and reads
constexpr int kWindow = 1024;   // tiles whose liveness a CTA holds at once
constexpr float kNeg = -1e30f;

// Bits of the kernels' `vec`: which operands take 16-byte copies.
constexpr int kVecQ = 1, kVecDo = 2, kVecMask = 4, kVecK = 8, kVecV = 16;

struct Dims {
  int64_t b, tq, tk, h, hkv, d;
};

// Element strides of a (batch, sequence, head, d) operand; d is contiguous.
struct View {
  int64_t sb, st, sh;
};

// Element strides of the (batch, query, key) mask.
struct MaskView {
  int64_t sb, sq, sk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// The two 16-bit values packed in w (the lower first), widened exactly.
__device__ __forceinline__ float2 widen2(uint32_t w, __nv_bfloat16) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 widen2(uint32_t w, __half) {
  return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Max and sum over the 8 lanes of a lane group (lane / 8).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return static_cast<size_t>(kTile) * (D + 4) * sizeof(float);
}

// Rows [row0, row0 + 64) of one head of one batch into a [64][D + 4] f32
// tile by plain loads, widened on the way; rows past `rows` and columns past
// d are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base, View vw, int64_t bi,
                                          int64_t head, int64_t row0, int64_t rows, int64_t d) {
  const T* p = base + bi * vw.sb + head * vw.sh;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t row = row0 + r;
    tile[r * (D + 4) + c] = row < rows && c < d ? to_f32(p[row * vw.st + c]) : 0.0f;
  }
}

// Copies rows [row0, row0 + 64) of one head of an f32 (batch, sequence,
// head, d) operand into a [64][D + 4] tile, zeros past `rows` and past d:
// 16 bytes at a time where the view is 16-byte aligned (vec), else 4.
template <int D>
__device__ __forceinline__ void copy_tile(float* tile, const float* base, View vw, int64_t bi,
                                          int64_t head, int64_t row0, int64_t rows, int64_t d,
                                          bool vec) {
  const float* p = base + bi * vw.sb + head * vw.sh;
  if (vec) {
#pragma unroll 4
    for (int i = 0; i < kTile * D / 4 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      const int64_t row = row0 + r, left = d - c;
      const int bytes = row < rows && left > 0 ? static_cast<int>(left < 4 ? left : 4) * 4 : 0;
      copy16(tile + r * (D + 4) + c, bytes ? p + row * vw.st + c : p, bytes);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kTile * D / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / D, c = e % D;
      const int64_t row = row0 + r;
      const bool valid = row < rows && c < d;
      copy4(tile + r * (D + 4) + c, valid ? p + row * vw.st + c : p, valid);
    }
  }
}

// The same for a 16-bit operand, unwidened, into a [64][D] tile of its own
// type: 16-byte copies (8 values) where the view is 16-byte aligned, else
// plain loads (cp.async has no 2-byte copy).
template <int D, typename T>
__device__ __forceinline__ void copy_raw(T* tile, const T* base, View vw, int64_t bi,
                                         int64_t head, int64_t row0, int64_t rows, int64_t d,
                                         bool vec) {
  const T* p = base + bi * vw.sb + head * vw.sh;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTile * D / 8 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const int64_t row = row0 + r, left = d - c;
      const int bytes = row < rows && left > 0 ? static_cast<int>(left < 8 ? left : 8) * 2 : 0;
      copy16(tile + r * D + c, bytes ? p + row * vw.st + c : p, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int64_t row = row0 + r;
      tile[r * D + c] = row < rows && c < d ? p[row * vw.st + c] : from_f32<T>(0.0f);
    }
  }
}

// The 64 x 64 mask tile of queries [q0, q0 + 64) and keys [k0, k0 + 64) into
// tile[query][key], zeros outside the mask: 16-key copies where the mask's
// rows are 16-byte aligned (vec), else byte loads.
__device__ __forceinline__ void copy_mask_tile(uint8_t* tile, const uint8_t* mb, MaskView mv,
                                               const Dims& dm, int64_t q0, int64_t k0, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTile * kTile / 16 / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / (kTile / 16), c = (e % (kTile / 16)) * 16;
      const int64_t q = q0 + r, left = dm.tk - (k0 + c);
      const int bytes = q < dm.tq && left > 0 ? static_cast<int>(left < 16 ? left : 16) : 0;
      copy16(tile + r * kTile + c, bytes ? mb + q * mv.sq + k0 + c : mb, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int64_t i = q0 + e / kTile, j = k0 + e % kTile;
      tile[e] = i < dm.tq && j < dm.tk ? mb[i * mv.sq + j * mv.sk] : 0;
    }
  }
}

// live[t] = whether any query of [q0, q0 + span) sees any key of k tile w0 +
// t, for t < nw: one coalesced scan of the span's mask rows (16 keys a load,
// 8 loads in flight, where vec).  Starts and ends with a barrier.
__device__ __forceinline__ void scan_key_tiles(uint8_t* live, const uint8_t* mb, MaskView mv,
                                               const Dims& dm, int64_t q0, int span, int64_t w0,
                                               int nw, bool vec) {
  for (int i = threadIdx.x; i < nw; i += kThreads) live[i] = 0;
  __syncthreads();
  const int rows = static_cast<int>(dm.tq - q0 < span ? dm.tq - q0 : span);
  const int64_t ka = w0 * kTile;
  const int keys = static_cast<int>(dm.tk - ka < nw * kTile ? dm.tk - ka : nw * kTile);
  if (vec) {
    constexpr int kBatch = 8;
    const int chunks = (keys + 15) / 16;  // 16-key chunks a row
    const int n = rows * chunks;
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
      uint32_t any[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, c = (e % chunks) * 16;
        const uint8_t* p = mb + (q0 + e / chunks) * mv.sq + ka + c;
        any[u] = 0;
        if (e < n && keys - c >= 16) {
          const uint4 x = *reinterpret_cast<const uint4*>(p);
          any[u] = x.x | x.y | x.z | x.w;
        } else if (e < n) {  // the ragged end of a row
          for (int j = 0; j < keys - c; ++j) any[u] |= p[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (any[u]) live[(e0 + u * kThreads) % chunks / (kTile / 16)] = 1;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * keys; e += kThreads) {
      const int64_t i = q0 + e / keys, j = ka + e % keys;
      if (mb[i * mv.sq + j * mv.sk]) live[(j - ka) / kTile] = 1;
    }
  }
  __syncthreads();
}

// The forward's and dq's K/V stages: f32 K/V as two stages of [K, V][64][D +
// 4] f32 tiles; bf16/f16 K/V as one f32 pair [K, V][64][D + 4] followed by
// two stages of raw [K, V][64][D] tiles.
template <int D, typename KV>
__host__ __device__ constexpr size_t kv_bytes() {
  return std::is_same<KV, float>::value
             ? 4 * tile_bytes<D>()
             : 2 * tile_bytes<D>() + 2 * 2 * static_cast<size_t>(kTile) * D * sizeof(KV);
}

// Starts the copies of K/V rows [k0, k0 + 64) of head kvh into `stage`.
template <int D, typename KV>
__device__ __forceinline__ void issue_kv(float* kvs, int stage, const KV* k, const KV* v, View kv,
                                         View vv, int64_t bi, int64_t kvh, int64_t k0,
                                         const Dims& dm, int vec) {
  if constexpr (std::is_same<KV, float>::value) {
    float* t = kvs + stage * 2 * kTile * (D + 4);
    copy_tile<D>(t, k, kv, bi, kvh, k0, dm.tk, dm.d, vec & kVecK);
    copy_tile<D>(t + kTile * (D + 4), v, vv, bi, kvh, k0, dm.tk, dm.d, vec & kVecV);
  } else {
    KV* t = reinterpret_cast<KV*>(kvs + 2 * kTile * (D + 4)) + stage * 2 * kTile * D;
    copy_raw<D>(t, k, kv, bi, kvh, k0, dm.tk, dm.d, vec & kVecK);
    copy_raw<D>(t + kTile * D, v, vv, bi, kvh, k0, dm.tk, dm.d, vec & kVecV);
  }
}

// The f32 K tile of `stage` (V follows it), once the stage's copies have
// landed and a barrier has followed every thread's wait.  bf16/f16 K/V are
// first widened into the one f32 pair, behind a barrier of their own.
template <int D, typename KV>
__device__ __forceinline__ const float* kv_ready(float* kvs, int stage) {
  if constexpr (std::is_same<KV, float>::value) {
    return kvs + stage * 2 * kTile * (D + 4);
  } else {
    const KV* raw = reinterpret_cast<const KV*>(kvs + 2 * kTile * (D + 4)) + stage * 2 * kTile * D;
#pragma unroll 1  // unrolled, it pushed the forward's registers into a spill
    for (int i = 0; i < 2 * kTile * D / 8 / kThreads; ++i) {  // 8 values (16 bytes) at a time
      const int e = threadIdx.x + i * kThreads;
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const uint4 x = *reinterpret_cast<const uint4*>(raw + r * D + c);
      const float2 a = widen2(x.x, KV{}), b = widen2(x.y, KV{}), c2 = widen2(x.z, KV{}),
                   d2 = widen2(x.w, KV{});
      float* dst = kvs + r * (D + 4) + c;
      *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(c2.x, c2.y, d2.x, d2.y);
    }
    __syncthreads();
    return kvs;
  }
}

// acc[r][c] += sum_{d in [k, k + 4)} A[a0 + 4r][d] * B[b0 + 8c][d].
template <int D, int R, int C>
__device__ __forceinline__ void rows_step(const float* A, int a0, const float* B, int b0, int k,
                                          float (&acc)[R][C]) {
  float4 a[R], b[C];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = *reinterpret_cast<const float4*>(A + (a0 + 4 * r) * (D + 4) + k);
#pragma unroll
  for (int c = 0; c < C; ++c) b[c] = *reinterpret_cast<const float4*>(B + (b0 + 8 * c) * (D + 4) + k);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
      acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
      acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
      acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
    }
}

// acc[r][c] += sum_d A[a0 + 4r][d] * B[b0 + 8c][d]: rows of two [64][D + 4]
// tiles, contracted along d.  The forward's 4 x 8 block holds twice the
// operands of a 4 x 4 one and unrolls half as deep.
template <int D, int R, int C>
__device__ __forceinline__ void contract_rows(const float* A, int a0, const float* B, int b0,
                                              float (&acc)[R][C]) {
  if constexpr (R * C > 16) {
#pragma unroll 2
    for (int k = 0; k < D; k += 4) rows_step<D>(A, a0, B, b0, k, acc);
  } else {
#pragma unroll 4
    for (int k = 0; k < D; k += 4) rows_step<D>(A, a0, B, b0, k, acc);
  }
}

// acc[r][4q + e] += sum_j S[s0 + 4r][j] * B[j][c0 + 32q + e], j < J: rows
// of a score tile S of row stride SS times the [64][D + 4] tile B.
template <int D, int R, int Q, int J = kTile, int SS = kPS>
__device__ __forceinline__ void contract_cols(const float* S, int s0, const float* B, int c0,
                                              float (&acc)[R][4 * Q]) {
#pragma unroll 2
  for (int j = 0; j < J; j += 4) {
    float4 s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* row = S + (s0 + 4 * r) * SS + j;
      if constexpr (SS % 4 == 0) {
        s[r] = *reinterpret_cast<const float4*>(row);
      } else {  // rows 8-byte aligned only
        const float2 a = *reinterpret_cast<const float2*>(row), b = *reinterpret_cast<const float2*>(row + 2);
        s[r] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(B + (j + jj) * (D + 4) + c0 + 32 * q);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sv = lane(s[r], jj);
          acc[r][4 * q + 0] = fmaf(sv, bv.x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(sv, bv.y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(sv, bv.z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(sv, bv.w, acc[r][4 * q + 3]);
        }
      }
    }
  }
}

// Columns c + 32q + {0..3} (q < Q) of an f32 output row, float4 stores where
// d is a multiple of 4 (rows then start 16-byte aligned), columns past d
// dropped.
template <int Q>
__device__ __forceinline__ void store_cols(float* out, int c, const float (&acc)[4 * Q], int64_t d) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int64_t col = c + 32 * q;
    if (d % 4 == 0) {
      if (col < d)
        *reinterpret_cast<float4*>(out + col) =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) out[col + e] = acc[4 * q + e];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: grid (b * h, q tiles)
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 2 * kTile;  // queries a forward CTA owns: 16 a warp
constexpr int kPF = 66;              // row stride of the forward's P: 128 x 66 floats fill one [64][132] tile

// At D = 128 P takes the place of the tile's K, which the scores no longer
// need; at D = 64 it has a buffer of its own.
template <int D>
__host__ __device__ constexpr size_t fwd_p_bytes() {
  return D == 128 ? 0 : static_cast<size_t>(kFwdRows) * kPF * sizeof(float);
}

template <int D, typename KV>
constexpr size_t fwd_smem_bytes() {
  return 2 * tile_bytes<D>() + kv_bytes<D, KV>() + fwd_p_bytes<D>() + 2 * kFwdRows * kTile + kWindow;
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                 const uint8_t* __restrict__ mask, float* __restrict__ o, float* __restrict__ l,
                 float* __restrict__ m, Dims dm, View qv, View kv, View vv, MaskView mv, int vec) {
  static_assert(D == 64 || kFwdRows * kPF <= kTile * (D + 4), "P fits in a K tile");
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);             // [128][D + 4]
  float* kvs = Qs + kFwdRows * (D + 4);                    // kv_bytes
  float* Pown = kvs + kv_bytes<D, KV>() / sizeof(float);   // D = 64: [128 queries][kPF]
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Pown + fwd_p_bytes<D>() / sizeof(float));  // [2][128][64]
  uint8_t* live = Mk + 2 * kFwdRows * kTile;                                          // [kWindow]

  const int warp = threadIdx.x / 32, ly = (threadIdx.x % 32) / 8, lx = threadIdx.x % 8;
  const int qw = 16 * warp + ly;  // this thread's queries: qw + 4r; keys lx + 8c; columns 4 lx + 32q
  const int64_t bh = blockIdx.x, bi = bh / dm.h, hi = bh % dm.h;
  const int64_t kvh = hi / (dm.h / dm.hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kFwdRows;
  const uint8_t* mb = mask + bi * mv.sb;
  const int64_t k_tiles = (dm.tk + kTile - 1) / kTile;

  float m_run[4], l_run[4], acc[4][D / 8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNeg;
    l_run[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < D / 8; ++e) acc[r][e] = 0.0f;
  }

  bool q_loaded = false;
  int st = 0;
  for (int64_t w0 = 0; w0 < k_tiles; w0 += kWindow) {
    const int nw = static_cast<int>(k_tiles - w0 < kWindow ? k_tiles - w0 : kWindow);
    scan_key_tiles(live, mb, mv, dm, q0, kFwdRows, w0, nw, vec & kVecMask);
    auto next_live = [&](int t) {
      while (t < nw && !live[t]) ++t;
      return t;
    };
    auto issue = [&](int t, int stage) {  // tile t's K, V and mask tiles into `stage`
      const int64_t k0 = (w0 + t) * kTile;
      issue_kv<D>(kvs, stage, k, v, kv, vv, bi, kvh, k0, dm, vec);
      uint8_t* tile = Mk + stage * kFwdRows * kTile;
      copy_mask_tile(tile, mb, mv, dm, q0, k0, vec & kVecMask);
      copy_mask_tile(tile + kTile * kTile, mb, mv, dm, q0 + kTile, k0, vec & kVecMask);
    };

    int cur = next_live(0);
    if (cur < nw && !q_loaded) {  // a CTA whose queries see no key never reads Q
      copy_tile<D>(Qs, q, qv, bi, hi, q0, dm.tq, dm.d, vec & kVecQ);
      copy_tile<D>(Qs + kTile * (D + 4), q, qv, bi, hi, q0 + kTile, dm.tq, dm.d, vec & kVecQ);
      q_loaded = true;
    }
    if (cur < nw) issue(cur, st);
    commit();
    while (cur < nw) {
      wait_pending<0>();
      __syncthreads();  // cur's stage is in; every thread is done with the other one
      const int nxt = next_live(cur + 1);
      if (nxt < nw) issue(nxt, st ^ 1);
      commit();

      const float* Kc = kv_ready<D, KV>(kvs, st);
      const float* Vc = Kc + kTile * (D + 4);
      const uint8_t* pair = Mk + st * kFwdRows * kTile;
      float s[4][8] = {};
      contract_rows<D>(Qs, qw, Kc, lx, s);
      float* Ps = Pown;
      if constexpr (D == 128) {
        __syncthreads();  // every warp is done with K: P takes its place
        Ps = const_cast<float*>(Kc);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint8_t* row = pair + (qw + 4 * r) * kTile + lx;
        bool on[8];
        float mx = kNeg;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          on[c] = row[8 * c] != 0;
          s[r][c] = on[c] ? s[r][c] : kNeg;
          mx = fmaxf(mx, s[r][c]);
        }
        const float m_new = fmaxf(m_run[r], group_max(mx));
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[r][c] = on[c] ? expf(s[r][c] - m_new) : 0.0f;
          sum += s[r][c];
          Ps[(qw + 4 * r) * kPF + lx + 8 * c] = s[r][c];
        }
        const float corr = expf(m_run[r] - m_new);
        l_run[r] = l_run[r] * corr + group_sum(sum);
#pragma unroll
        for (int e = 0; e < D / 8; ++e) acc[r][e] *= corr;
        m_run[r] = m_new;
      }
      __syncwarp();  // the warp's P rows are its own
      contract_cols<D, 4, D / 32, kTile, kPF>(Ps, qw, Vc, 4 * lx, acc);
      cur = nxt;
      st ^= 1;
    }
    __syncthreads();  // the next window's flags and stages are free
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + qw + 4 * r;
    if (i >= dm.tq) continue;
    store_cols<D / 32>(o + (bh * dm.tq + i) * dm.d, 4 * lx, acc[r], dm.d);
    if (lx == 0) {
      l[bh * dm.tq + i] = l_run[r];
      m[bh * dm.tq + i] = m_run[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dq: grid (b * h, q tiles)
// ---------------------------------------------------------------------------

template <int D, typename KV>
constexpr size_t dq_smem_bytes() {
  return 2 * tile_bytes<D>() + kv_bytes<D, KV>() + static_cast<size_t>(kTile) * kPS * sizeof(float) +
         2 * kTile * kTile + kWindow;
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const uint8_t* __restrict__ mask, const float* __restrict__ m,
                    const float* __restrict__ dl, const float* __restrict__ dout,
                    float* __restrict__ dq, Dims dm, View qv, View kv, View vv, MaskView mv,
                    View dov, int vec) {
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);             // [64][D + 4]
  float* dOs = Qs + kTile * (D + 4);                       // [64][D + 4]
  float* kvs = dOs + kTile * (D + 4);                      // kv_bytes
  float* Ts = kvs + kv_bytes<D, KV>() / sizeof(float);     // [64 queries][kPS]: dS
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Ts + kTile * kPS);  // [2][64 queries][64 keys]
  uint8_t* live = Mk + 2 * kTile * kTile;                      // [kWindow]

  const int warp = threadIdx.x / 32, ly = (threadIdx.x % 32) / 8, lx = threadIdx.x % 8;
  const int half = warp % 2;           // the half of each k tile this warp's dq sum covers
  const int qb = (warp / 2) * 16 + ly;  // this thread's queries: qb + 4r
  const int kb = 32 * half + lx;        // its keys of a tile: kb + 8c; its columns 4 lx + 32q
  const int64_t bh = blockIdx.x, bi = bh / dm.h, hi = bh % dm.h;
  const int64_t kvh = hi / (dm.h / dm.hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const uint8_t* mb = mask + bi * mv.sb;
  const int64_t k_tiles = (dm.tk + kTile - 1) / kTile;

  float m_i[4] = {}, dl_i[4] = {}, acc[4][D / 8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < D / 8; ++e) acc[r][e] = 0.0f;

  bool q_loaded = false;
  int st = 0;
  for (int64_t w0 = 0; w0 < k_tiles; w0 += kWindow) {
    const int nw = static_cast<int>(k_tiles - w0 < kWindow ? k_tiles - w0 : kWindow);
    scan_key_tiles(live, mb, mv, dm, q0, kTile, w0, nw, vec & kVecMask);
    auto next_live = [&](int t) {
      while (t < nw && !live[t]) ++t;
      return t;
    };
    auto issue = [&](int t, int stage) {  // tile t's K, V and mask tile into `stage`
      const int64_t k0 = (w0 + t) * kTile;
      issue_kv<D>(kvs, stage, k, v, kv, vv, bi, kvh, k0, dm, vec);
      copy_mask_tile(Mk + stage * kTile * kTile, mb, mv, dm, q0, k0, vec & kVecMask);
    };

    int cur = next_live(0);
    if (cur < nw && !q_loaded) {  // a CTA whose queries see no key reads nothing more
      copy_tile<D>(Qs, q, qv, bi, hi, q0, dm.tq, dm.d, vec & kVecQ);
      copy_tile<D>(dOs, dout, dov, bi, hi, q0, dm.tq, dm.d, vec & kVecDo);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t i = q0 + qb + 4 * r;
        m_i[r] = i < dm.tq ? m[bh * dm.tq + i] : 0.0f;
        dl_i[r] = i < dm.tq ? dl[bh * dm.tq + i] : 0.0f;
      }
      q_loaded = true;
    }
    if (cur < nw) issue(cur, st);
    commit();
    while (cur < nw) {
      wait_pending<0>();
      __syncthreads();  // cur's stage is in; every thread is done with the other one and dS
      const int nxt = next_live(cur + 1);
      if (nxt < nw) issue(nxt, st ^ 1);
      commit();

      const float* Kc = kv_ready<D, KV>(kvs, st);
      const float* Vc = Kc + kTile * (D + 4);
      const uint8_t* pair = Mk + st * kTile * kTile;
      float s[4][4] = {}, dp[4][4] = {};
      contract_rows<D>(Qs, qb, Kc, kb, s);
      contract_rows<D>(dOs, qb, Vc, kb, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = qb + 4 * r, j = kb + 8 * c;
          const float p = pair[i * kTile + j] ? expf(s[r][c] - m_i[r]) : 0.0f;
          Ts[i * kPS + j] = p * (dp[r][c] + dl_i[r]);
        }
      __syncwarp();  // the warp's dS rows and keys are its own
      contract_cols<D, 4, D / 32, kTile / 2>(Ts + 32 * half, qb, Kc + 32 * half * (D + 4), 4 * lx, acc);
      cur = nxt;
      st ^= 1;
    }
    __syncthreads();  // the next window's flags and stages are free
  }

  // The two halves' sums of a query row add once: the odd warp of each pair
  // hands its own to the even one through the free stages.
  float* Os = kvs;  // [64][D + 4]
  if (half) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int qq = 0; qq < D / 32; ++qq)
        *reinterpret_cast<float4*>(Os + (qb + 4 * r) * (D + 4) + 4 * lx + 32 * qq) = make_float4(
            acc[r][4 * qq], acc[r][4 * qq + 1], acc[r][4 * qq + 2], acc[r][4 * qq + 3]);
  }
  __syncthreads();
  if (half) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + qb + 4 * r;
    if (i >= dm.tq) continue;
#pragma unroll
    for (int qq = 0; qq < D / 32; ++qq) {
      const float4 o1 = *reinterpret_cast<const float4*>(Os + (qb + 4 * r) * (D + 4) + 4 * lx + 32 * qq);
      acc[r][4 * qq] += o1.x;
      acc[r][4 * qq + 1] += o1.y;
      acc[r][4 * qq + 2] += o1.z;
      acc[r][4 * qq + 3] += o1.w;
    }
    store_cols<D / 32>(dq + ((bi * dm.tq + i) * dm.h + hi) * dm.d, 4 * lx, acc[r], dm.d);
  }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv: grid (b * h_kv, k tiles); each CTA loops over the g
// query heads of its K/V head and over the live q tiles
// ---------------------------------------------------------------------------
//
// Design (the note at the top says what it computes).  A CTA owns 64 keys of
// one K/V head: K and V stay in shared memory, dk and dv in registers, and
// the CTA walks the live (query head, 64-query tile) items in a fixed order,
// head by head, q tiles in increasing order.  Per item it forms S^T = K Q^T
// and dP^T = V dO^T (64 x 64, contracted over D), then P^T and dS^T in
// registers, then dv += P^T dO and dk += dS^T Q (64 x D, contracted over the
// 64 queries).  What bounds it and how it is met:
// - Operations: 8d operations (4d FMAs) per live (query, key) pair and head
//   on the CUDA cores, full f32 (the top note says why not TF32).
// - Shared-memory bandwidth (the top note's bound): warp tiling.  Warp w
//   owns keys 16 (w / 2) .. +16; in the score products lane (ly, lx) = (lane
//   / 8, lane % 8) holds keys 4r + ly and queries 32 (w % 2) + 8c + lx (r, c
//   < 4), 4 x 4 blocks whose float4 reads of K or Q rows are conflict-free
//   (4 or 8 distinct rows a warp); in the output products it holds the same
//   keys and d columns D/2 (w % 2) + 32q + 4 lx + {0..3}, 4 x D/16 blocks.
// - Latency, with one CTA of 8 warps per SM: the next live item's Q, dO
//   (16-byte cp.async where the view is 16-byte aligned, else 4-byte), m,
//   dl and mask tile are copied into the other of two stages while this
//   item computes; f32 K and V are copied the same way with the first item
//   (bf16 and f16 K/V are widened to f32 by plain loads).
// - Liveness: the mask does not depend on the head, so each window of up to
//   kWindow q tiles is scanned once, coalesced (keys are contiguous, 16
//   bytes a load, 8 loads in flight), into one flag per tile; dead tiles are
//   never loaded, and a CTA whose keys no query sees loads no K or V and
//   writes zeros (float4 stores where d is a multiple of 4).  Within an
//   item, a pair's liveness is read from the staged mask tile.
// Shared memory at D = 128: K, V and two stages of Q and dO (6 x 64 x 132
// floats, 202,752 bytes), P^T then dS^T in one 64 x 72 buffer (18,432: the
// two would need 18 KB more than the 227 KB a CTA can have, so dS^T waits
// for dv's product to finish reading P^T, one extra barrier), two stages of
// m, dl (1,024) and the 64 x 64 mask tile (8,192), and the window's flags
// (1,024): 231,424 bytes.  D = 64: 133,120.  Registers: the top note's, no
// spill (ptxas -v, in the build log), under __launch_bounds__(256, 1).

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 6 * tile_bytes<D>() + static_cast<size_t>(kTile) * kPS * sizeof(float) +
         2 * 2 * kTile * sizeof(float) + 2 * kTile * kTile + kWindow;
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                     const uint8_t* __restrict__ mask, const float* __restrict__ m,
                     const float* __restrict__ dl, const float* __restrict__ dout,
                     KV* __restrict__ dk, KV* __restrict__ dv, Dims dm, View qv, View kv, View vv,
                     MaskView mv, View dov, int vec) {
  extern __shared__ float4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kTile * (D + 4);
  float* Qs = Vs + kTile * (D + 4);     // [2][64][D + 4]
  float* dOs = Qs + 2 * kTile * (D + 4);  // [2][64][D + 4]
  float* Ts = dOs + 2 * kTile * (D + 4);  // [64 keys][kPS]: P^T, then dS^T
  float* Ms = Ts + kTile * kPS;           // [2][64]
  float* DLs = Ms + 2 * kTile;            // [2][64]
  uint8_t* Mk = reinterpret_cast<uint8_t*>(DLs + 2 * kTile);  // [2][64 queries][64 keys]
  uint8_t* live = Mk + 2 * kTile * kTile;                      // [kWindow]

  const int warp = threadIdx.x / 32, ly = (threadIdx.x % 32) / 8, lx = threadIdx.x % 8;
  const int kb = (warp / 2) * 16 + ly;         // this thread's keys: kb + 4r
  const int qb = (warp % 2) * 32 + lx;         // its queries in the score products: qb + 8c
  const int cb = (warp % 2) * (D / 2) + 4 * lx;  // its d columns in the output products: cb + 32q + e
  const int64_t bkv = blockIdx.x, bi = bkv / dm.hkv, kh = bkv % dm.hkv;
  const int64_t g = dm.h / dm.hkv;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const uint8_t* mb = mask + bi * mv.sb;
  const int64_t q_tiles = (dm.tq + kTile - 1) / kTile;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.0f;

  bool kv_loaded = false;
  for (int64_t w0 = 0; w0 < q_tiles; w0 += kWindow) {
    const int nw = static_cast<int>(q_tiles - w0 < kWindow ? q_tiles - w0 : kWindow);
    // the window's liveness: one flag per q tile, any pair of it live
    for (int i = threadIdx.x; i < nw; i += kThreads) live[i] = 0;
    __syncthreads();
    const int64_t qa = w0 * kTile, qe = (qa + nw * kTile < dm.tq) ? qa + nw * kTile : dm.tq;
    const int keys = static_cast<int>(dm.tk - k0 < kTile ? dm.tk - k0 : kTile);
    if ((vec & kVecMask) && keys == kTile) {  // 16 keys a load, 8 loads in flight
      constexpr int kBatch = 8;
      const int64_t n = (qe - qa) * (kTile / 16);
      for (int64_t e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
        uint4 x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t e = e0 + u * kThreads, i = qa + e / (kTile / 16);
          x[u] = e < n ? *reinterpret_cast<const uint4*>(mb + i * mv.sq + k0 + (e % (kTile / 16)) * 16)
                       : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (x[u].x | x[u].y | x[u].z | x[u].w) live[(e0 + u * kThreads) / (kTile / 16) / kTile] = 1;
      }
    } else {
#pragma unroll 4
      for (int64_t e = threadIdx.x; e < (qe - qa) * kTile; e += kThreads) {
        const int64_t i = qa + e / kTile, j = k0 + e % kTile;
        if (j < dm.tk && mb[i * mv.sq + j * mv.sk]) live[(i - qa) / kTile] = 1;
      }
    }
    __syncthreads();

    // items: (query head gi, q tile w0 + t) as gi * nw + t, live ones only
    const int64_t items = g * nw;
    auto next_live = [&](int64_t it) {
      while (it < items && !live[it % nw]) ++it;
      return it;
    };
    auto issue = [&](int64_t it, int stage) {  // the item's operands into `stage`
      const int64_t hi = kh * g + it / nw, bh = bi * dm.h + hi;
      const int64_t q0 = (w0 + it % nw) * kTile;
      copy_tile<D>(Qs + stage * kTile * (D + 4), q, qv, bi, hi, q0, dm.tq, dm.d, vec & kVecQ);
      copy_tile<D>(dOs + stage * kTile * (D + 4), dout, dov, bi, hi, q0, dm.tq, dm.d, vec & kVecDo);
      if (threadIdx.x < 2 * kTile) {
        const int i = threadIdx.x % kTile;
        const float* src = threadIdx.x < kTile ? m : dl;
        float* dst = (threadIdx.x < kTile ? Ms : DLs) + stage * kTile + i;
        const bool valid = q0 + i < dm.tq;
        copy4(dst, valid ? src + bh * dm.tq + q0 + i : src, valid);
      }
      copy_mask_tile(Mk + stage * kTile * kTile, mb, mv, dm, q0, k0, vec & kVecMask);
    };

    int64_t cur = next_live(0);
    int st = 0;
    if (cur < items && !kv_loaded) {  // a CTA no query sees never reads K or V
      if constexpr (std::is_same<KV, float>::value) {
        if (vec & kVecK)
          copy_tile<D>(Ks, k, kv, bi, kh, k0, dm.tk, dm.d, true);
        else
          load_tile<D>(Ks, k, kv, bi, kh, k0, dm.tk, dm.d);
        if (vec & kVecV)
          copy_tile<D>(Vs, v, vv, bi, kh, k0, dm.tk, dm.d, true);
        else
          load_tile<D>(Vs, v, vv, bi, kh, k0, dm.tk, dm.d);
      } else {  // converted to f32 on the way
        load_tile<D>(Ks, k, kv, bi, kh, k0, dm.tk, dm.d);
        load_tile<D>(Vs, v, vv, bi, kh, k0, dm.tk, dm.d);
      }
      kv_loaded = true;
    }
    if (cur < items) issue(cur, st);
    commit();
    while (cur < items) {
      wait_pending<0>();
      __syncthreads();  // cur's stage is in; every thread is done with the other one
      const int64_t nxt = next_live(cur + 1);
      if (nxt < items) issue(nxt, st ^ 1);
      commit();

      const float* Qc = Qs + st * kTile * (D + 4);
      const float* dOc = dOs + st * kTile * (D + 4);
      const float* Mc = Ms + st * kTile;
      const float* DLc = DLs + st * kTile;
      const uint8_t* live_pair = Mk + st * kTile * kTile;
      float s[4][4] = {}, ds[4][4] = {};
      contract_rows<D>(Ks, kb, Qc, qb, s);
      contract_rows<D>(Vs, kb, dOc, qb, ds);  // dP^T, then dS^T in place
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = qb + 8 * c, j = kb + 4 * r;
          const float p = live_pair[i * kTile + j] ? expf(s[r][c] - Mc[i]) : 0.0f;
          ds[r][c] = p * (ds[r][c] + DLc[i]);
          Ts[j * kPS + i] = p;
        }
      __syncthreads();
      contract_cols<D, 4, D / 64>(Ts, kb, dOc, cb, dv_acc);
      __syncthreads();  // every thread is done with P^T
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) Ts[(kb + 4 * r) * kPS + qb + 8 * c] = ds[r][c];
      __syncthreads();
      contract_cols<D, 4, D / 64>(Ts, kb, Qc, cb, dk_acc);
      cur = nxt;
      st ^= 1;
    }
    __syncthreads();  // the next window's flags and stages are free
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t j = k0 + kb + 4 * r;
    if (j >= dm.tk) continue;
    const int64_t off = ((bi * dm.tk + j) * dm.hkv + kh) * dm.d;
#pragma unroll
    for (int qq = 0; qq < D / 64; ++qq) {
      const int64_t c = cb + 32 * qq;
      if constexpr (std::is_same<KV, float>::value) {
        if (dm.d % 4 == 0 && c < dm.d) {  // rows start 16-byte aligned: whole float4s
          *reinterpret_cast<float4*>(dk + off + c) = make_float4(
              dk_acc[r][4 * qq], dk_acc[r][4 * qq + 1], dk_acc[r][4 * qq + 2], dk_acc[r][4 * qq + 3]);
          *reinterpret_cast<float4*>(dv + off + c) = make_float4(
              dv_acc[r][4 * qq], dv_acc[r][4 * qq + 1], dv_acc[r][4 * qq + 2], dv_acc[r][4 * qq + 3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < dm.d) {
          dk[off + c + e] = from_f32<KV>(dk_acc[r][4 * qq + e]);
          dv[off + c + e] = from_f32<KV>(dv_acc[r][4 * qq + e]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The shared memory the source note states, and that a CTA can have.
static_assert(fwd_smem_bytes<128, float>() == 220160 && fwd_smem_bytes<128, __half>() == 218112 &&
                  fwd_smem_bytes<64, float>() == 155648 && fwd_smem_bytes<64, __half>() == 153600,
              "forward shared memory");
static_assert(dq_smem_bytes<128, float>() == 230400 && dq_smem_bytes<128, __half>() == 228352 &&
                  dq_smem_bytes<64, float>() == 132096 && dq_smem_bytes<64, __half>() == 130048,
              "dq shared memory");
static_assert(dkv_smem_bytes<128>() == 231424 && dkv_smem_bytes<64>() == 133120, "dk/dv shared memory");
static_assert(dkv_smem_bytes<128>() <= 232448 && dq_smem_bytes<128, float>() <= 232448,
              "over the 227 KB a CTA can have");

template <int kD, typename T>
struct Tag {
  static constexpr int D = kD;
  using KV = T;
};

// Calls f(Tag<D, KV>{}) for d <= 64 (D = 64) or d <= 128 (D = 128) and the
// K/V type: 0 f32, 1 bf16, 2 f16.
template <typename F>
int dispatch(int64_t d, int kv_dtype, F&& f) {
  const bool wide = d > 64;
  switch (kv_dtype) {
    case 0: return wide ? f(Tag<128, float>{}) : f(Tag<64, float>{});
    case 1: return wide ? f(Tag<128, __nv_bfloat16>{}) : f(Tag<64, __nv_bfloat16>{});
    case 2: return wide ? f(Tag<128, __half>{}) : f(Tag<64, __half>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool dims_ok(const Dims& dm, int64_t tiles_y) {
  return dm.b > 0 && dm.tq > 0 && dm.tk > 0 && dm.h > 0 && dm.hkv > 0 && dm.h % dm.hkv == 0 &&
         dm.d > 0 && dm.d <= 128 && dm.b * dm.h <= 0x7fffffffLL && tiles_y <= 65535;
}

int64_t tiles(int64_t t) { return (t + kTile - 1) / kTile; }

// Above 48 KB a launch needs the kernel's opt-in to more dynamic shared memory.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

Dims dims_of(const int64_t* a) { return Dims{a[0], a[1], a[2], a[3], a[4], a[5]}; }
View view_of(const int64_t* a) { return View{a[0], a[1], a[2]}; }
MaskView mask_of(const int64_t* a) { return MaskView{a[0], a[1], a[2]}; }

// Every row of every head of a (batch, sequence, head, d) view of
// `elem`-byte values starts 16-byte aligned.
bool aligned16(const void* p, const View& v, int64_t elem) {
  const int64_t n = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && v.sb % n == 0 && v.st % n == 0 && v.sh % n == 0;
}

// The kernels' `vec` bits for q, k, v and the mask (strides as the C
// interface orders them) and, where given, do.
int vec_bits(const float* q, const void* k, const void* v, const uint8_t* mask,
             const int64_t* strides, int kv_dtype, const float* dout) {
  const int64_t kv_elem = kv_dtype == 0 ? 4 : 2;
  const MaskView mv = mask_of(strides + 9);
  return (aligned16(q, view_of(strides), 4) ? kVecQ : 0) |
         (dout && aligned16(dout, view_of(strides + 12), 4) ? kVecDo : 0) |
         (reinterpret_cast<uintptr_t>(mask) % 16 == 0 && mv.sk == 1 && mv.sq % 16 == 0 &&
                  mv.sb % 16 == 0
              ? kVecMask
              : 0) |
         (aligned16(k, view_of(strides + 3), kv_elem) ? kVecK : 0) |
         (aligned16(v, view_of(strides + 6), kv_elem) ? kVecV : 0);
}

}  // namespace

extern "C" {

// dims: b, tq, tk, h, h_kv, d.  strides: q, k, v, mask (3 each: batch,
// sequence, head; the mask's batch, query, key).  kv_dtype: 0 f32, 1 bf16,
// 2 f16.  -> o (b, h, tq, d), l, m (b, h, tq), all f32.
int bagua_flash_fwd(const float* q, const void* k, const void* v, const uint8_t* mask, float* o,
                    float* l, float* m, const int64_t* dims, const int64_t* strides, int kv_dtype,
                    void* stream) {
  const Dims dm = dims_of(dims);
  const int64_t q_tiles = (dm.tq + kFwdRows - 1) / kFwdRows;
  if (!dims_ok(dm, q_tiles)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(dm.b * dm.h), static_cast<unsigned>(q_tiles));
  const int vec = vec_bits(q, k, v, mask, strides, kv_dtype, nullptr);
  return dispatch(dm.d, kv_dtype, [&](auto tag) {
    using T = decltype(tag);
    using KV = typename T::KV;
    auto kernel = flash_fwd_kernel<T::D, KV>;
    const size_t smem = fwd_smem_bytes<T::D, KV>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kThreads, smem, s>>>(q, static_cast<const KV*>(k), static_cast<const KV*>(v),
                                        mask, o, l, m, dm, view_of(strides), view_of(strides + 3),
                                        view_of(strides + 6), mask_of(strides + 9), vec);
    return static_cast<int>(cudaGetLastError());
  });
}

// As bagua_flash_fwd, plus m, dl (b, h, tq) contiguous and do (b, h, tq, d)
// through strides + 12 (batch, sequence, head) -> dq (b, tq, h, d) f32.
int bagua_flash_bwd_dq(const float* q, const void* k, const void* v, const uint8_t* mask,
                       const float* m, const float* dl, const float* dout, float* dq,
                       const int64_t* dims, const int64_t* strides, int kv_dtype, void* stream) {
  const Dims dm = dims_of(dims);
  if (!dims_ok(dm, tiles(dm.tq))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(dm.b * dm.h), static_cast<unsigned>(tiles(dm.tq)));
  const int vec = vec_bits(q, k, v, mask, strides, kv_dtype, dout);
  return dispatch(dm.d, kv_dtype, [&](auto tag) {
    using T = decltype(tag);
    using KV = typename T::KV;
    auto kernel = flash_bwd_dq_kernel<T::D, KV>;
    const size_t smem = dq_smem_bytes<T::D, KV>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kThreads, smem, s>>>(q, static_cast<const KV*>(k), static_cast<const KV*>(v),
                                        mask, m, dl, dout, dq, dm, view_of(strides),
                                        view_of(strides + 3), view_of(strides + 6),
                                        mask_of(strides + 9), view_of(strides + 12), vec);
    return static_cast<int>(cudaGetLastError());
  });
}

// As bagua_flash_bwd_dq -> dk, dv (b, tk, h_kv, d) in the K/V type.
int bagua_flash_bwd_dkv(const float* q, const void* k, const void* v, const uint8_t* mask,
                        const float* m, const float* dl, const float* dout, void* dk, void* dv,
                        const int64_t* dims, const int64_t* strides, int kv_dtype, void* stream) {
  const Dims dm = dims_of(dims);
  if (!dims_ok(dm, tiles(dm.tk)) || dm.b * dm.hkv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(dm.b * dm.hkv), static_cast<unsigned>(tiles(dm.tk)));
  const int vec = vec_bits(q, k, v, mask, strides, kv_dtype, dout);
  return dispatch(dm.d, kv_dtype, [&](auto tag) {
    using T = decltype(tag);
    using KV = typename T::KV;
    auto kernel = flash_bwd_dkv_kernel<T::D, KV>;
    const size_t smem = dkv_smem_bytes<T::D>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kThreads, smem, s>>>(q, static_cast<const KV*>(k), static_cast<const KV*>(v),
                                        mask, m, dl, dout, static_cast<KV*>(dk),
                                        static_cast<KV*>(dv), dm, view_of(strides),
                                        view_of(strides + 3), view_of(strides + 6),
                                        mask_of(strides + 9), view_of(strides + 12), vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
