// The quantized ring's hop for Hopper (sm_90a): one ring step's fused
// dequantize -> add the local partial -> requantize, with the error that the
// requantization leaves.
//
// Replaces the two Pallas TPU kernels of bagua_tpu/kernels/quantized_ring.py
// (both launched by the pallas_call at quantized_ring.py:253):
//   bits=8  _hop_kernel8  (quantized_ring.py:200)
//   bits=4  _hop_kernel4  (quantized_ring.py:211)
//
// Semantics, per row ("block") of B elements, L = 255 (int8) or 15 (int4),
// exactly the jnp oracle hop_dequant_add_requant:
//   x   = (q + lower) / scale      scale = L / bounded(max - min) (see
//                                  minmax_uint8._safe_scale), lower =
//                                  rint(max * scale) - L, from the row's minmax
//   s   = x + local
//   mm2 = (min s, max s); scale2, upper2 = rint(max s * scale2), lower2 = upper2 - L
//   lvl = min(rint(s * scale2), upper2) - lower2
//   int8: q2 = u8(lvl), saturating, NaN -> 0 (the jnp codec's convert; the
//         Pallas body wraps through int32, the port follows jnp)
//   int4: element j < B/2 rides the low nibble of byte j, element j + B/2 the
//         high nibble: q2 = (s32(lvl_j) | s32(lvl_{j+B/2}) << 4) mod 256, with
//         XLA's saturating, NaN -> 0 f32 -> s32 convert
//   err = s - (nibble or byte of q2 as stored + lower2) / scale2
// Every result is bitwise equal to the plain PyTorch version
// (bagua_tpu_torch/kernels/quantized_ring.py), by XLA's float rules
// (xla_float.cuh).
//
// Design.  One CTA per row over a grid of ranks x blocks-per-shard rows
// (25,088 rows of 4096 at VGG16's Dense_0 bucket over 4 ranks): the ring
// calls the hop once per step for every rank at once.  Per row:
//   * No division per element.  The incoming levels take 256 (int8) or 16
//     (int4) values: the CTA builds their table from the row's (min, max)
//     before pass 1, and after the min/max the same from (scale2, lower2)
//     for err; each entry is dequantize() itself, so a lookup is bitwise the
//     division.
//   * A thread holds 16 elements in registers: 16 bytes of q (int8; 8 for
//     int4) and 4 float4 of local, a whole row's loads issued before its
//     reduction (int4: before its table is built).  So s stays in registers
//     between the passes and every input is read once.  Rows up to 4096
//     elements take B/16 threads rounded to a warp, up to 16384 up to 1024
//     threads; longer rows walk in sections of 256 x 16 elements, twice
//     (pass 2 computes s again, by the same arithmetic).
//   * Min/max over the CTA: shuffles, one barrier, and every thread folds
//     the warps' results (no broadcast barrier).
//   * Occupancy decides the speed: the short-row vector kernel asks for 6
//     (int8, 40 registers) or 5 (int4, 48) CTAs an SM, so VGG16's buckets of
//     about 600 rows run in one wave.  A persistent CTA staging its next
//     row by cp.async, and one prefetching it into registers, measured
//     slower (PERF.md).
// Every even B works; nothing falls back.
// Bound: device-memory bytes.  Least traffic per element: int8 1 + 4 in and
// 1 + 4 out, int4 0.5 + 4 in and 0.5 + 4 out, plus 16 B of sidecars per row;
// this kernel moves exactly that for B <= 16384.
// ptxas (sm_90a, nvcc 12.8, -fmad=false): the short-row vector kernels 40
// (int8) and 48 (int4) registers, the other instantiations 50-156 (at most
// 64 where 1024 threads run), static shared memory up to 2.3 KB; no stack
// frame and no spill in any instantiation (PERF.md holds the build's lines).

#include "xla_float.cuh"

namespace {

// CTAs of 256 threads an SM the short-row vector kernels ask registers for
// (knobs for chip_kernel_ab.py --variant)
#ifndef HOP_MIN_BLOCKS_8
#define HOP_MIN_BLOCKS_8 6
#endif
#ifndef HOP_MIN_BLOCKS_4
#define HOP_MIN_BLOCKS_4 5
#endif

constexpr int kPer = 16;           // elements of a row a thread holds
constexpr int kShortThreads = 256;  // rows up to 4096 elements
constexpr int kLongThreads = 1024;  // rows up to 16384 elements, still in registers
constexpr int kWalkThreads = 256;   // longer rows, which pass 2 reads again

// int8: a byte is one element, a thread holds 16 bytes.  int4: a byte holds
// element j (low nibble) and j + B/2 (high), a thread holds 8 bytes.
template <int kBits>
struct Hop {
  static constexpr int kLevels = kBits == 8 ? 256 : 16;
  static constexpr float kL = kBits == 8 ? 255.0f : 15.0f;
  static constexpr int kBytes = kBits == 8 ? 16 : 8;
  static constexpr int kWords = kBytes / 4;
};

// One thread's bytes of q (4 to a word) and local values of a section.
template <int kBits>
struct Raw {
  uint32_t w[Hop<kBits>::kWords];
  float l[kPer];
};

__device__ __forceinline__ float dequantize(uint32_t level, float scale, float lower) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(level), lower), scale);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

__device__ __forceinline__ void load4(const float* p, float* l) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  l[0] = v.x, l[1] = v.y, l[2] = v.z, l[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* e) {
  *reinterpret_cast<float4*>(p) = make_float4(e[0], e[1], e[2], e[3]);
}

// This thread's bytes of the section of a q row that starts at base: kBytes
// neighbours from base + threadIdx.x * kBytes (vector path), or byte k at
// base + k * blockDim.x + threadIdx.x (scalar path).  Returns how many of
// them lie in the row (they come first).
template <int kBits, bool kVec>
__device__ __forceinline__ int bytes_in_row(int64_t base, int64_t cols) {
  constexpr int kB = Hop<kBits>::kBytes;
  if (kVec) return base + threadIdx.x * kB < cols ? kB : 0;
  const int64_t rest = cols - base - threadIdx.x;
  if (rest <= 0) return 0;
  const int64_t n = (rest + blockDim.x - 1) / blockDim.x;
  return n < kB ? static_cast<int>(n) : kB;
}

template <int kBits, bool kVec>
__device__ __forceinline__ void load_raw(Raw<kBits>& raw, const uint8_t* __restrict__ qr,
                                         const float* __restrict__ lr, int64_t base,
                                         int64_t half, int nv) {
  constexpr int kB = Hop<kBits>::kBytes;
  if (kVec) {
    if (!nv) return;
    const int64_t j0 = base + threadIdx.x * kB;
    if constexpr (kBits == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(qr + j0);
      raw.w[0] = v.x, raw.w[1] = v.y, raw.w[2] = v.z, raw.w[3] = v.w;
#pragma unroll
      for (int k = 0; k < kPer; k += 4) load4(lr + j0 + k, raw.l + k);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(qr + j0);
      raw.w[0] = v.x, raw.w[1] = v.y;
#pragma unroll
      for (int k = 0; k < kB; k += 4) {
        load4(lr + j0 + k, raw.l + k);
        load4(lr + half + j0 + k, raw.l + kB + k);
      }
    }
  } else {
    const int64_t j0 = base + threadIdx.x;
#pragma unroll
    for (int i = 0; i < Hop<kBits>::kWords; ++i) raw.w[i] = 0;
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (k < nv) {
        const int64_t j = j0 + static_cast<int64_t>(k) * blockDim.x;
        raw.w[k >> 2] |= static_cast<uint32_t>(qr[j]) << (8 * (k & 3));
        raw.l[k] = lr[j];
        if constexpr (kBits == 4) raw.l[kB + k] = lr[half + j];
      }
    }
  }
}

// s = dequantize(q) + local: s[k] is byte k's element (int4: s[k] its low
// nibble's, s[8 + k] its high nibble's).  tab holds each level's
// dequantize(), the same expression.
template <int kBits>
__device__ __forceinline__ void sums(float (&s)[kPer], const Raw<kBits>& raw, const float* tab) {
  constexpr int kB = Hop<kBits>::kBytes;
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const uint32_t b = byte_of(raw.w, k);
    if constexpr (kBits == 8) {
      s[k] = __fadd_rn(tab[b], raw.l[k]);
    } else {
      s[k] = __fadd_rn(tab[b & 0xFu], raw.l[k]);
      s[kB + k] = __fadd_rn(tab[b >> 4], raw.l[kB + k]);
    }
  }
}

// Folds the first nv bytes' elements of s into (mn, mx).
template <int kBits>
__device__ __forceinline__ void fold(const float (&s)[kPer], int nv, float& mn, float& mx) {
  constexpr int kB = Hop<kBits>::kBytes;
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    if (k < nv) {
      mn = xla::min(mn, s[k]);
      mx = xla::max(mx, s[k]);
      if constexpr (kBits == 4) {
        mn = xla::min(mn, s[kB + k]);
        mx = xla::max(mx, s[kB + k]);
      }
    }
  }
}

// q2 and err of this thread's elements (laid out as sums() lays them);
// tab holds each level's (level + lower2) / scale2.
template <int kBits, bool kVec>
__device__ __forceinline__ void requantize(const float (&s)[kPer], uint8_t* __restrict__ qo,
                                           float* __restrict__ er, int64_t base, int64_t half,
                                           int nv, float scale2, float upper2, float lower2,
                                           const float* tab) {
  constexpr int kB = Hop<kBits>::kBytes;
  uint32_t w[Hop<kBits>::kWords];
  float e[kPer];
#pragma unroll
  for (int i = 0; i < Hop<kBits>::kWords; ++i) w[i] = 0;
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const float lvl = __fsub_rn(xla::min(rintf(__fmul_rn(s[k], scale2)), upper2), lower2);
    uint32_t b;
    if constexpr (kBits == 8) {
      b = xla::to_u8(lvl);
      e[k] = __fsub_rn(s[k], tab[b]);
    } else {
      const float lvh = __fsub_rn(xla::min(rintf(__fmul_rn(s[kB + k], scale2)), upper2), lower2);
      b = (static_cast<uint32_t>(xla::to_s32(lvl)) | (static_cast<uint32_t>(xla::to_s32(lvh)) << 4)) & 0xFFu;
      e[k] = __fsub_rn(s[k], tab[b & 0xFu]);
      e[kB + k] = __fsub_rn(s[kB + k], tab[b >> 4]);
    }
    w[k >> 2] |= b << (8 * (k & 3));
  }
  if (kVec) {
    if (!nv) return;
    const int64_t j0 = base + threadIdx.x * kB;
    if constexpr (kBits == 8) {
      *reinterpret_cast<uint4*>(qo + j0) = make_uint4(w[0], w[1], w[2], w[3]);
#pragma unroll
      for (int k = 0; k < kPer; k += 4) store4(er + j0 + k, e + k);
    } else {
      *reinterpret_cast<uint2*>(qo + j0) = make_uint2(w[0], w[1]);
#pragma unroll
      for (int k = 0; k < kB; k += 4) {
        store4(er + j0 + k, e + k);
        store4(er + half + j0 + k, e + kB + k);
      }
    }
  } else {
    const int64_t j0 = base + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (k < nv) {
        const int64_t j = j0 + static_cast<int64_t>(k) * blockDim.x;
        qo[j] = static_cast<uint8_t>(byte_of(w, k));
        er[j] = e[k];
        if constexpr (kBits == 4) er[half + j] = e[kB + k];
      }
    }
  }
}

// (mn, mx) over the block (a whole number of warps); every thread gets it.
__device__ __forceinline__ void block_minmax_all(float& mn, float& mx, float* s_mn, float* s_mx) {
  for (int off = 16; off > 0; off >>= 1) {
    mn = xla::min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = xla::max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if ((threadIdx.x & 31) == 0) {
    s_mn[threadIdx.x >> 5] = mn;
    s_mx[threadIdx.x >> 5] = mx;
  }
  __syncthreads();
  mn = s_mn[0], mx = s_mx[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
    mn = xla::min(mn, s_mn[w]);
    mx = xla::max(mx, s_mx[w]);
  }
}

// One CTA per row.  kResident: blockDim.x * kBytes bytes of q cover the
// row, whose values stay in registers between the passes, so each input is
// read once; else both passes walk the row in sections and pass 2 computes
// s again, by the same arithmetic.
template <int kBits, bool kVec, int kMaxThreads, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, kVec && kMaxThreads == kShortThreads && kResident
                                                   ? (kBits == 8 ? HOP_MIN_BLOCKS_8 : HOP_MIN_BLOCKS_4) : 1)
hop_kernel(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
           const float* __restrict__ local, uint8_t* __restrict__ q_out,
           float* __restrict__ mm_out, float* __restrict__ err, int64_t block) {
  using H = Hop<kBits>;
  __shared__ float tab_in[H::kLevels], tab_out[H::kLevels];
  __shared__ float s_mn[kMaxThreads / 32], s_mx[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const int64_t cols = kBits == 8 ? block : block / 2;  // bytes of a q row
  const int64_t half = block / 2;
  const int64_t section = static_cast<int64_t>(blockDim.x) * H::kBytes;
  const uint8_t* qr = q + row * cols;
  const float* lr = local + row * block;
  // int4: the first section's loads go out before the table is built (int8's
  // raw section and table build do not fit its 40 registers together)
  constexpr bool kEarly = kBits == 4;
  Raw<kBits> raw;
  if (kEarly) load_raw<kBits, kVec>(raw, qr, lr, 0, half, bytes_in_row<kBits, kVec>(0, cols));
  {
    const float mx_in = minmax[2 * row + 1];
    const float scale = xla::safe_scale(minmax[2 * row], mx_in, H::kL);
    const float lower = __fsub_rn(rintf(__fmul_rn(mx_in, scale)), H::kL);
    for (int l = threadIdx.x; l < H::kLevels; l += blockDim.x) tab_in[l] = dequantize(l, scale, lower);
  }
  __syncthreads();

  float s[kPer];
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t base = 0; base < cols; base += section) {
    const int nv = bytes_in_row<kBits, kVec>(base, cols);
    if (base || !kEarly) load_raw<kBits, kVec>(raw, qr, lr, base, half, nv);
    sums<kBits>(s, raw, tab_in);
    fold<kBits>(s, nv, mn, mx);
    if (kResident) break;
  }
  block_minmax_all(mn, mx, s_mn, s_mx);
  const float scale2 = xla::safe_scale(mn, mx, H::kL);
  const float upper2 = rintf(__fmul_rn(mx, scale2));
  const float lower2 = __fsub_rn(upper2, H::kL);
  if (threadIdx.x == 0) {
    mm_out[2 * row] = mn;
    mm_out[2 * row + 1] = mx;
  }
  for (int l = threadIdx.x; l < H::kLevels; l += blockDim.x) tab_out[l] = dequantize(l, scale2, lower2);
  __syncthreads();

  uint8_t* qo = q_out + row * cols;
  float* er = err + row * block;
  for (int64_t base = 0; base < cols; base += section) {
    const int nv = bytes_in_row<kBits, kVec>(base, cols);
    if (!kResident) {
      load_raw<kBits, kVec>(raw, qr, lr, base, half, nv);
      sums<kBits>(s, raw, tab_in);
    }
    requantize<kBits, kVec>(s, qo, er, base, half, nv, scale2, upper2, lower2, tab_out);
    if (kResident) break;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kBits, bool kVec>
int launch(const uint8_t* q, const float* minmax, const float* local, uint8_t* q_out,
           float* mm_out, float* err, int64_t rows, int64_t block, cudaStream_t s) {
  constexpr int kB = Hop<kBits>::kBytes;
  const int64_t cols = kBits == 8 ? block : block / 2;
  const int64_t threads = ((cols + kB - 1) / kB + 31) / 32 * 32;
  const unsigned grid = static_cast<unsigned>(rows);
  if (threads <= kShortThreads) {
    hop_kernel<kBits, kVec, kShortThreads, true><<<grid, static_cast<unsigned>(threads), 0, s>>>(
        q, minmax, local, q_out, mm_out, err, block);
  } else if (threads <= kLongThreads) {
    hop_kernel<kBits, kVec, kLongThreads, true><<<grid, static_cast<unsigned>(threads), 0, s>>>(
        q, minmax, local, q_out, mm_out, err, block);
  } else {
    hop_kernel<kBits, kVec, kWalkThreads, false><<<grid, kWalkThreads, 0, s>>>(
        q, minmax, local, q_out, mm_out, err, block);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kBits>
int launch(const uint8_t* q, const float* minmax, const float* local, uint8_t* q_out,
           float* mm_out, float* err, int64_t rows, int64_t block, cudaStream_t s) {
  constexpr int kB = Hop<kBits>::kBytes;
  const int64_t cols = kBits == 8 ? block : block / 2;
  const bool vec = cols % kB == 0 && aligned(q, kB) && aligned(q_out, kB) &&
                   aligned(local, 16) && aligned(err, 16);
  return vec ? launch<kBits, true>(q, minmax, local, q_out, mm_out, err, rows, block, s)
             : launch<kBits, false>(q, minmax, local, q_out, mm_out, err, rows, block, s);
}

}  // namespace

extern "C" {

// q (rows, B) u8 for bits=8, (rows, B/2) packed u8 for bits=4; minmax
// (rows, 2) f32; local (rows, B) f32 -> q_out like q, mm_out (rows, 2) f32,
// err (rows, B) f32.  B even.
int bagua_qr_hop(const uint8_t* q, const float* minmax, const float* local,
                 uint8_t* q_out, float* mm_out, float* err, int64_t rows,
                 int64_t block, int bits, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || block < 2 || block % 2 || (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bits == 8 ? launch<8>(q, minmax, local, q_out, mm_out, err, rows, block, s)
                   : launch<4>(q, minmax, local, q_out, mm_out, err, rows, block, s);
}

}  // extern "C"
