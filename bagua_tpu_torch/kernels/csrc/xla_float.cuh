// XLA's float rules, for kernels that must equal the JAX package's jnp
// codecs bit for bit.  Shared by minmax_uint8.cu and quantized_ring.cu.
//
//   * every add, multiply and divide is an _rn intrinsic (and the sources are
//     built with -fmad=false), so nothing is contracted into an FMA;
//   * rintf rounds half to even, as jnp.round / torch.round;
//   * min and max propagate NaN and order -0 below +0 whatever the element
//     order, as XLA's reductions do (fminf/fmaxf would drop a NaN);
//   * f32 -> u8 and f32 -> s32 saturate and send NaN to 0, as XLA's convert
//     (a C cast is undefined out of range).
// MinMax and block_keys fold a min/max in that order as integer keys, one
// integer min and max an element (the compress kernels of both sources).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace xla {

constexpr float kEps = 1e-7f;
constexpr float kRelEps = 1e-35f;
constexpr float kF32Max = 3.40282346638528859811704183484516925e+38f;

__device__ __forceinline__ bool sign_set(float a) { return __float_as_uint(a) >> 31; }

__device__ __forceinline__ float min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return sign_set(a) ? a : b;  // equal: only the sign of a zero can differ
}

__device__ __forceinline__ float max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return sign_set(a) ? b : a;
}

// levels / min(max - min + 1e-7 + 1e-35 * max(|min|, |max|), FLT_MAX): the
// bounded denominator of minmax_uint8._safe_scale.
__device__ __forceinline__ float safe_scale(float mn, float mx, float levels) {
  const float amax = xla::max(fabsf(mn), fabsf(mx));
  const float denom = __fadd_rn(__fadd_rn(__fsub_rn(mx, mn), kEps),
                                __fmul_rn(kRelEps, amax));
  return __fdiv_rn(levels, xla::min(denom, kF32Max));
}

__device__ __forceinline__ uint8_t to_u8(float d) {
  if (!(d > 0.0f)) return 0;  // NaN and everything at or below 0
  if (d >= 255.0f) return 255;
  return static_cast<uint8_t>(d);
}

__device__ __forceinline__ int32_t to_s32(float d) {
  if (d != d) return 0;
  if (d >= 2147483648.0f) return 2147483647;
  if (d <= -2147483648.0f) return -2147483647 - 1;
  return static_cast<int32_t>(d);  // truncates toward zero
}

// Reduces (mn, mx) over a block of kThreads threads; thread 0 holds the result.
template <int kThreads>
__device__ __forceinline__ void block_minmax(float& mn, float& mx) {
  __shared__ float s_mn[kThreads / 32];
  __shared__ float s_mx[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    mn = xla::min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = xla::max(mx, __shfl_down_sync(0xffffffffu, mx, off));
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
      mn = xla::min(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = xla::max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    }
  }
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

}  // namespace xla
