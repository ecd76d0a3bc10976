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
// wrappers (bagua_tpu_torch/kernels/minmax_uint8.py):
//   * built with -fmad=false, and the arithmetic is written with the _rn
//     intrinsics as well, so no multiply-add is contracted into an FMA;
//   * rintf rounds half to even, as jnp.round / torch.round;
//   * min and max propagate NaN and order -0 below +0 whatever the element
//     order, as XLA's reductions do (fminf/fmaxf would drop a NaN);
//   * the f32 -> u8 conversion saturates and sends NaN to 0, as XLA's convert.
//
// Design.  The TPU kernels hold a whole chunk in VMEM for one grid step; on
// this card a chunk reaches 25.7 M elements (VGG16's Dense_0 kernel split 4
// ways), far beyond a block's shared memory, so a chunk-wide min/max needs a
// reduction across blocks.  Each call is split into passes over tiles of
// kTile elements of one row (one block per tile, no atomics, deterministic):
//   compress   (3 launches): tile min/max -> finish per row (min/max, scale,
//                            upper) -> quantize tile by tile
//   decompress (1 launch):   elementwise, each block computes its row's scale
//   fused      (3 launches): dequantize the n peers, sum them left to right
//                            in peer order (/ n when averaging) into an f32
//                            scratch with tile min/max -> finish per row ->
//                            quantize the scratch
// Bound: all three are bounded by device-memory bytes.  Least bytes per
// element of a chunk: compress 4 in + 1 out, decompress 1 in + 4 out, fused
// n in + 1 out.  Bytes actually moved: compress reads x twice (9 B/elem);
// the fused path writes and re-reads its f32 scratch, 8 B per element of the
// reduced chunk beyond the bound.  Cutting that extra traffic is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTile = 16384;  // elements of one row per block
constexpr float kLevels = 255.0f;
constexpr float kEps = 1e-7f;
constexpr float kRelEps = 1e-35f;
constexpr float kF32Max = 3.40282346638528859811704183484516925e+38f;

__device__ __forceinline__ bool sign_set(float a) { return __float_as_uint(a) >> 31; }

__device__ __forceinline__ int64_t tile_end(int64_t begin, int64_t chunk) {
  return begin + kTile < chunk ? begin + kTile : chunk;
}

__device__ __forceinline__ float xla_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return sign_set(a) ? a : b;  // equal: only the sign of a zero can differ
}

__device__ __forceinline__ float xla_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return sign_set(a) ? b : a;
}

__device__ __forceinline__ float safe_scale(float mn, float mx) {
  const float amax = xla_max(fabsf(mn), fabsf(mx));
  const float denom = __fadd_rn(__fadd_rn(__fsub_rn(mx, mn), kEps),
                                __fmul_rn(kRelEps, amax));
  return __fdiv_rn(kLevels, xla_min(denom, kF32Max));
}

__device__ __forceinline__ uint8_t quantize(float x, float scale, float upper) {
  const float level = xla_min(rintf(__fmul_rn(x, scale)), upper);
  const float d = __fsub_rn(level, __fsub_rn(upper, kLevels));
  if (!(d > 0.0f)) return 0;  // NaN and everything at or below 0
  if (d >= kLevels) return 255;
  return static_cast<uint8_t>(d);
}

__device__ __forceinline__ float dequantize(uint8_t q, float scale, float lower) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(q), lower), scale);
}

// Reduces (mn, mx) over the block; thread 0 holds the result.
__device__ __forceinline__ void block_minmax(float& mn, float& mx) {
  __shared__ float s_mn[kThreads / 32];
  __shared__ float s_mx[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    mn = xla_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = xla_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kThreads / 32 ? s_mn[lane] : INFINITY;
    mx = lane < kThreads / 32 ? s_mx[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1) {
      mn = xla_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = xla_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    }
  }
}

// Pass 1 of compress: min/max of one tile of one row.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tile_minmax(const float* __restrict__ x, float2* __restrict__ partial,
            int64_t chunk, int64_t tiles) {
  const int64_t row = blockIdx.x / tiles;
  const int64_t begin = (blockIdx.x - row * tiles) * kTile;
  const int64_t end = tile_end(begin, chunk);
  const float* xr = x + row * chunk;
  float mn = INFINITY, mx = -INFINITY;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int64_t i = begin / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      const float4 v = x4[i];
      mn = xla_min(xla_min(mn, v.x), xla_min(v.y, xla_min(v.z, v.w)));
      mx = xla_max(xla_max(mx, v.x), xla_max(v.y, xla_max(v.z, v.w)));
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
      mn = xla_min(mn, xr[i]);
      mx = xla_max(mx, xr[i]);
    }
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_float2(mn, mx);
}

// Pass 1 of the fused path: dequantize the n peers of one tile of rank r,
// sum them in peer order, write the f32 result and the tile's min/max.
// kVec: each thread takes 4 neighbouring elements, one 4-byte load per
// peer and one 16-byte store; each element's sum is the same sequence of
// additions either way.
template <bool kAverage, bool kVec>
__global__ void __launch_bounds__(kThreads)
tile_dequant_reduce(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
                    float* __restrict__ red, float2* __restrict__ partial,
                    int64_t n, int64_t chunk, int64_t tiles) {
  extern __shared__ float2 peer[];  // (scale, lower) of each peer
  const int64_t r = blockIdx.x / tiles;
  const int64_t begin = (blockIdx.x - r * tiles) * kTile;
  const int64_t end = tile_end(begin, chunk);
  for (int64_t p = threadIdx.x; p < n; p += kThreads) {
    const float pmn = minmax[2 * (r * n + p)], pmx = minmax[2 * (r * n + p) + 1];
    const float s = safe_scale(pmn, pmx);
    peer[p] = make_float2(s, __fsub_rn(rintf(__fmul_rn(pmx, s)), kLevels));
  }
  __syncthreads();
  const uint8_t* qr = q + r * n * chunk;
  float* out = red + r * chunk;
  const float nf = static_cast<float>(n);
  float mn = INFINITY, mx = -INFINITY;
  if (kVec) {
    for (int64_t i = begin / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int64_t p = 0; p < n; ++p) {
        const float2 pl = peer[p];
        const uchar4 v = reinterpret_cast<const uchar4*>(qr + p * chunk)[i];
        acc.x = __fadd_rn(acc.x, dequantize(v.x, pl.x, pl.y));
        acc.y = __fadd_rn(acc.y, dequantize(v.y, pl.x, pl.y));
        acc.z = __fadd_rn(acc.z, dequantize(v.z, pl.x, pl.y));
        acc.w = __fadd_rn(acc.w, dequantize(v.w, pl.x, pl.y));
      }
      if (kAverage) {
        acc = make_float4(__fdiv_rn(acc.x, nf), __fdiv_rn(acc.y, nf),
                          __fdiv_rn(acc.z, nf), __fdiv_rn(acc.w, nf));
      }
      reinterpret_cast<float4*>(out)[i] = acc;
      mn = xla_min(xla_min(mn, acc.x), xla_min(acc.y, xla_min(acc.z, acc.w)));
      mx = xla_max(xla_max(mx, acc.x), xla_max(acc.y, xla_max(acc.z, acc.w)));
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
      float acc = 0.0f;
      for (int64_t p = 0; p < n; ++p) {
        const float2 pl = peer[p];
        acc = __fadd_rn(acc, dequantize(qr[p * chunk + i], pl.x, pl.y));
      }
      if (kAverage) acc = __fdiv_rn(acc, nf);
      out[i] = acc;
      mn = xla_min(mn, acc);
      mx = xla_max(mx, acc);
    }
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) partial[blockIdx.x] = make_float2(mn, mx);
}

// Pass 2: one block per row folds the tiles' min/max and derives the row's
// quantization parameters (scale, upper).
__global__ void __launch_bounds__(kThreads)
finish_minmax(const float2* __restrict__ partial, float* __restrict__ minmax,
              float2* __restrict__ qparams, int64_t tiles) {
  const int64_t row = blockIdx.x;
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t t = threadIdx.x; t < tiles; t += kThreads) {
    const float2 p = partial[row * tiles + t];
    mn = xla_min(mn, p.x);
    mx = xla_max(mx, p.y);
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    minmax[2 * row] = mn;
    minmax[2 * row + 1] = mx;
    const float s = safe_scale(mn, mx);
    qparams[row] = make_float2(s, rintf(__fmul_rn(mx, s)));
  }
}

// Pass 3: quantize one tile of one row with the row's (scale, upper).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_tile(const float* __restrict__ x, const float2* __restrict__ qparams,
              uint8_t* __restrict__ q, int64_t chunk, int64_t tiles) {
  const int64_t row = blockIdx.x / tiles;
  const int64_t begin = (blockIdx.x - row * tiles) * kTile;
  const int64_t end = tile_end(begin, chunk);
  const float2 p = qparams[row];
  const float* xr = x + row * chunk;
  uint8_t* qr = q + row * chunk;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    uchar4* q4 = reinterpret_cast<uchar4*>(qr);
    for (int64_t i = begin / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      const float4 v = x4[i];
      q4[i] = make_uchar4(quantize(v.x, p.x, p.y), quantize(v.y, p.x, p.y),
                          quantize(v.z, p.x, p.y), quantize(v.w, p.x, p.y));
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads)
      qr[i] = quantize(xr[i], p.x, p.y);
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

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Rows x tiles blocks must fit a 1-D grid.
bool grid_ok(int64_t rows, int64_t chunk) {
  return rows > 0 && chunk > 0 && rows * tiles_of(chunk) <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Tiles per row; the caller sizes the scratch as 2 * rows * (tiles + 1) floats.
int64_t bagua_minmax_u8_tiles(int64_t chunk) { return tiles_of(chunk); }

// x (rows, chunk) f32 -> q (rows, chunk) u8, minmax (rows, 2) f32.
int bagua_compress_minmax_u8(const float* x, uint8_t* q, float* minmax,
                             float* scratch, int64_t rows, int64_t chunk,
                             void* stream) {
  if (!grid_ok(rows, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(chunk);
  float2* partial = reinterpret_cast<float2*>(scratch);
  float2* qparams = partial + rows * tiles;
  const bool vec = chunk % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  const unsigned grid = static_cast<unsigned>(rows * tiles);
  if (vec) tile_minmax<true><<<grid, kThreads, 0, s>>>(x, partial, chunk, tiles);
  else tile_minmax<false><<<grid, kThreads, 0, s>>>(x, partial, chunk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_minmax<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(partial, minmax, qparams, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) quantize_tile<true><<<grid, kThreads, 0, s>>>(x, qparams, q, chunk, tiles);
  else quantize_tile<false><<<grid, kThreads, 0, s>>>(x, qparams, q, chunk, tiles);
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
// mm_out (R, 2) f32.  red is an (R, chunk) f32 scratch, scratch holds
// 2 * R * (tiles + 1) floats.
int bagua_fused_reduce_minmax_u8(const uint8_t* q, const float* minmax,
                                 uint8_t* q_out, float* mm_out, float* red,
                                 float* scratch, int64_t ranks, int64_t n,
                                 int64_t chunk, int average, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float2);
  if (!grid_ok(ranks, chunk) || n <= 0 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(chunk);
  float2* partial = reinterpret_cast<float2*>(scratch);
  float2* qparams = partial + ranks * tiles;
  const unsigned grid = static_cast<unsigned>(ranks * tiles);
  const bool vec = chunk % 4 == 0 && aligned(q, 4) && aligned(red, 16) && aligned(q_out, 4);
  if (average && vec)
    tile_dequant_reduce<true, true><<<grid, kThreads, smem, s>>>(q, minmax, red, partial, n, chunk, tiles);
  else if (average)
    tile_dequant_reduce<true, false><<<grid, kThreads, smem, s>>>(q, minmax, red, partial, n, chunk, tiles);
  else if (vec)
    tile_dequant_reduce<false, true><<<grid, kThreads, smem, s>>>(q, minmax, red, partial, n, chunk, tiles);
  else
    tile_dequant_reduce<false, false><<<grid, kThreads, smem, s>>>(q, minmax, red, partial, n, chunk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_minmax<<<static_cast<unsigned>(ranks), kThreads, 0, s>>>(partial, mm_out, qparams, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) quantize_tile<true><<<grid, kThreads, 0, s>>>(red, qparams, q_out, chunk, tiles);
  else quantize_tile<false><<<grid, kThreads, 0, s>>>(red, qparams, q_out, chunk, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
