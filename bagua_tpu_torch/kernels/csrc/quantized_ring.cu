// The quantized ring's kernels for Hopper (sm_90a): one ring step's fused
// dequantize -> add the local partial -> requantize, with the error that the
// requantization leaves (the hop), and the int4 block codec.
//
// The hop replaces the two Pallas TPU kernels of bagua_tpu/kernels/quantized_ring.py
// (both launched by the pallas_call at quantized_ring.py:253):
//   bits=8  _hop_kernel8  (quantized_ring.py:200)
//   bits=4  _hop_kernel4  (quantized_ring.py:211)
// The int4 block codec replaces no Pallas kernel: the JAX package writes it
// in jnp (compress_minmax_uint4 at quantized_ring.py:101, decompress at
// :125), which XLA fuses into the jitted step.  Here it is two kernels, so
// that the int4 ring's compresses and decompresses (2 + 2 a bucket a step)
// are one pass each instead of about 20 PyTorch operations:
//   compress4_kernel    (rows, B) f32 -> packed (rows, B/2) u8 + (rows, 2) f32
//   decompress4_kernel  packed + minmax -> (rows, B) f32
// Both are bounded by device-memory bytes: compress reads 4 and writes 0.5
// bytes an element, decompress reads 0.5 and writes 4, plus 8 bytes of
// sidecar a row; each moves exactly that (compress up to B = 4096).
// Compress loads a row as the hop does (load_values), folds its min/max as
// integer keys reduced by redux.sync (xla::MinMax and xla::block_keys, as
// minmax_uint8.cu's compress), and quantizes a row whose min and max are
// finite without the NaN-aware clamp and saturating convert; a row with a
// NaN or an infinity keeps them.  XLA's NaN- and sign-aware float min/max
// and convert compile to compares and branches: 967 of the first design's
// 1784 instructions for a thread's 16 elements, 832 in all now (PERF.md:
// 45% -> 82% of the bound a VGG16 int4-ring step, the keys most of it).
// Decompress runs a grid of row sections so that few long rows still fill
// the 132 SMs, and looks each nibble up in the row's 16 level values.
// Vector paths: compress where B/2 is a whole number of 8 bytes (a
// thread's four 16-byte loads and one 8-byte store, as the hop's; a layout
// contiguous across a warp measured no faster), decompress where it is of
// 4 (4-byte loads and 16-byte stores, each contiguous over a warp); else a
// byte at a time, a stride of the block.
// ptxas (sm_90a, nvcc 12.8, -fmad=false): compress's vector kernels 32
// (resident) and 56 (walking) registers, its scalar ones 48 and 96;
// decompress 32; no stack frame and no spill.
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
// The codec, per row of B elements: (min, max), scale and the int4 levels
// as the hop's requantize computes them from s = the row, packed as above;
// decompress x = (nibble + lower) / scale.  Every result is bitwise equal
// to the plain PyTorch version (bagua_tpu_torch/kernels/quantized_ring.py),
// by XLA's float rules (xla_float.cuh).
//
// The hop's design.  One CTA per row over a grid of ranks x blocks-per-shard rows
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

#include <algorithm>

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

// This thread's values of the section of an f32 row that starts at byte
// base of its q row, laid out as Raw::l: int8 byte k's element at l[k];
// int4 byte k's low-nibble element (column j) at l[k] and its high-nibble
// element (column j + B/2) at l[8 + k].  Values past the row are left unset.
template <int kBits, bool kVec>
__device__ __forceinline__ void load_values(float (&l)[kPer], const float* __restrict__ lr,
                                            int64_t base, int64_t half, int nv) {
  constexpr int kB = Hop<kBits>::kBytes;
  if (kVec) {
    if (!nv) return;
    const int64_t j0 = base + threadIdx.x * kB;
    if constexpr (kBits == 8) {
#pragma unroll
      for (int k = 0; k < kPer; k += 4) load4(lr + j0 + k, l + k);
    } else {
#pragma unroll
      for (int k = 0; k < kB; k += 4) {
        load4(lr + j0 + k, l + k);
        load4(lr + half + j0 + k, l + kB + k);
      }
    }
  } else {
    const int64_t j0 = base + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (k < nv) {
        const int64_t j = j0 + static_cast<int64_t>(k) * blockDim.x;
        l[k] = lr[j];
        if constexpr (kBits == 4) l[kB + k] = lr[half + j];
      }
    }
  }
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
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(qr + j0);
      raw.w[0] = v.x, raw.w[1] = v.y;
    }
    load_values<kBits, kVec>(raw.l, lr, base, half, nv);
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

// ---------------------------------------------------------------------------
// The int4 block codec: compress_minmax_uint4 and decompress_minmax_uint4.
// ---------------------------------------------------------------------------

// Compress.  Level of one element: kFinite, where the row's min and max are
// finite, rint(x * scale) <= upper (a product by scale > 0 and rint are
// monotone) and every value is finite, so the clamp to upper is the
// identity and the convert needs no NaN or range test (cvt.rzi saturates);
// else XLA's expressions, the NaN-aware clamp and the saturating convert.
template <bool kFinite>
__device__ __forceinline__ uint32_t level4(float x, float scale, float upper, float lower) {
  if (kFinite) return static_cast<uint32_t>(__float2int_rz(__fsub_rn(rintf(__fmul_rn(x, scale)), lower)));
  return static_cast<uint32_t>(xla::to_s32(__fsub_rn(xla::min(rintf(__fmul_rn(x, scale)), upper), lower)));
}

// The thread's 8 packed bytes (v laid out as load_values<4> lays it) as two
// words: byte k = (level of v[k] | level of v[8 + k] << 4) mod 256.
template <bool kFinite>
__device__ __forceinline__ void pack4(const float (&v)[kPer], float scale, float upper, float lower,
                                      uint32_t (&w)[Hop<4>::kWords]) {
  constexpr int kB = Hop<4>::kBytes;
#pragma unroll
  for (int i = 0; i < Hop<4>::kWords; ++i) w[i] = 0;
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const uint32_t b = (level4<kFinite>(v[k], scale, upper, lower) |
                        level4<kFinite>(v[kB + k], scale, upper, lower) << 4) & 0xFFu;
    w[k >> 2] |= b << (8 * (k & 3));
  }
}

// One CTA per row of B elements.  A thread holds the 16 elements of 8
// packed bytes (load_values<4>'s layout: columns j .. j + 7 and their
// partners B/2 further on), loaded before the fold.  The row's (min, max)
// folds as integer keys (xla::MinMax: one 3-input integer min or max for
// two elements) and the CTA reduces the keys by redux.sync
// (xla::block_keys); every thread derives scale, upper and lower and takes
// one branch for the whole row (finite min and max, or not).  kResident
// (B <= 4096, the ring's blocks): the values stay in registers and each
// input is read once; else both passes walk the row in sections and pass 2
// reads it again.  The 1 CTA an SM asked lets ptxas use the registers each
// instantiation wants: with the thread count alone (nvcc 12.8) it held the
// scalar resident kernel to 40 registers and spilled 12 bytes.
template <bool kVec, int kMaxThreads, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 1)
compress4_kernel(const float* __restrict__ x, uint8_t* __restrict__ packed,
                 float* __restrict__ minmax, int64_t block) {
  using H = Hop<4>;
  __shared__ int32_t s_lo[kMaxThreads / 32], s_hi[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const int64_t half = block / 2;  // also the bytes of a packed row
  const int64_t section = static_cast<int64_t>(blockDim.x) * H::kBytes;
  const float* xr = x + row * block;
  float v[kPer];
  xla::MinMax m;
  for (int64_t base = 0; base < half; base += section) {
    const int nv = bytes_in_row<4, kVec>(base, half);
    load_values<4, kVec>(v, xr, base, half, nv);
#pragma unroll
    for (int k = 0; k < H::kBytes; ++k) {
      if (k < nv) {
        m.add(v[k]);
        m.add(v[H::kBytes + k]);
      }
    }
    if (kResident) break;
  }
  xla::block_keys(m, s_lo, s_hi);
  float mn, mx;
  m.get(mn, mx);
  const float scale = xla::safe_scale(mn, mx, H::kL);
  const float upper = rintf(__fmul_rn(mx, scale));
  const float lower = __fsub_rn(upper, H::kL);
  const bool finite = fabsf(mn) <= xla::kF32Max && fabsf(mx) <= xla::kF32Max;
  if (threadIdx.x == 0) {
    minmax[2 * row] = mn;
    minmax[2 * row + 1] = mx;
  }
  uint8_t* pr = packed + row * half;
  for (int64_t base = 0; base < half; base += section) {
    const int nv = bytes_in_row<4, kVec>(base, half);
    if (!kResident) load_values<4, kVec>(v, xr, base, half, nv);
    uint32_t w[H::kWords];
    if (finite) pack4<true>(v, scale, upper, lower, w);
    else pack4<false>(v, scale, upper, lower, w);
    if (kVec) {
      if (nv) *reinterpret_cast<uint2*>(pr + base + threadIdx.x * H::kBytes) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int k = 0; k < H::kBytes; ++k)
        if (k < nv) pr[base + static_cast<int64_t>(k) * blockDim.x + threadIdx.x] = byte_of(w, k);
    }
    if (kResident) break;
  }
}

constexpr int kDecompressThreads = 256;
constexpr int kDecompressWords = 4;  // 4-byte loads of packed bytes a thread a tile
constexpr int kDecompressBytes = 4 * kDecompressWords;

// Decompress: CTA t of a row's tiles takes blockDim.x * 16 of its packed
// bytes, so short rows fill the card with one tile each and long rows with
// many.  Word k of a thread is the 4 bytes at (k * blockDim.x + thread) * 4
// of the tile, so each load and each store of a warp is contiguous: a
// word's 4 low nibbles go to columns j .. j + 3 (one float4), its 4 high
// nibbles B/2 further on.  The words' loads go out before the CTA builds
// the row's 16 level values (dequantize(), the division itself).  Scalar
// path: a byte at a time, a stride of the block.
template <bool kVec>
__global__ void __launch_bounds__(kDecompressThreads)
decompress4_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ minmax,
                   float* __restrict__ out, int64_t half, int64_t tiles) {
  __shared__ float tab[16];
  const int64_t row = blockIdx.x / tiles;
  const int64_t tile = static_cast<int64_t>(blockDim.x) * kDecompressBytes;
  const int64_t begin = (blockIdx.x - row * tiles) * tile;
  const int64_t end = begin + tile < half ? begin + tile : half;
  const uint8_t* pr = packed + row * half;
  uint32_t w[kDecompressWords];
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kDecompressWords; ++k) {
      const int64_t j = begin + (static_cast<int64_t>(k) * blockDim.x + threadIdx.x) * 4;
      if (j < end) w[k] = *reinterpret_cast<const uint32_t*>(pr + j);
    }
  }
  if (threadIdx.x < 16) {
    const float mx = minmax[2 * row + 1];
    const float scale = xla::safe_scale(minmax[2 * row], mx, Hop<4>::kL);
    tab[threadIdx.x] = dequantize(threadIdx.x, scale, __fsub_rn(rintf(__fmul_rn(mx, scale)), Hop<4>::kL));
  }
  __syncthreads();
  float* lo = out + row * 2 * half;
  float* hi = lo + half;
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kDecompressWords; ++k) {
      const int64_t j = begin + (static_cast<int64_t>(k) * blockDim.x + threadIdx.x) * 4;
      if (j < end) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = (w[k] >> (8 * i)) & 0xFFu;
          a[i] = tab[byte & 0xFu];
          b[i] = tab[byte >> 4];
        }
        store4(lo + j, a);
        store4(hi + j, b);
      }
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const uint32_t byte = pr[i];
      lo[i] = tab[byte & 0xFu];
      hi[i] = tab[byte >> 4];
    }
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

template <bool kVec>
int launch_compress4(const float* x, uint8_t* packed, float* minmax, int64_t rows, int64_t block,
                     cudaStream_t s) {
  const int64_t half = block / 2;
  const int64_t threads = ((half + Hop<4>::kBytes - 1) / Hop<4>::kBytes + 31) / 32 * 32;
  const unsigned grid = static_cast<unsigned>(rows);
  if (threads <= kShortThreads) {
    compress4_kernel<kVec, kShortThreads, true><<<grid, static_cast<unsigned>(threads), 0, s>>>(
        x, packed, minmax, block);
  } else {
    compress4_kernel<kVec, kWalkThreads, false><<<grid, kWalkThreads, 0, s>>>(x, packed, minmax, block);
  }
  return static_cast<int>(cudaGetLastError());
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

// blocks (rows, B) f32 -> packed (rows, B/2) u8, minmax (rows, 2) f32.
// B even.
int bagua_qr_compress4(const float* x, uint8_t* packed, float* minmax, int64_t rows,
                       int64_t block, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || block < 2 || block % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (block / 2) % Hop<4>::kBytes == 0 && aligned(x, 16) && aligned(packed, Hop<4>::kBytes);
  return vec ? launch_compress4<true>(x, packed, minmax, rows, block, s)
             : launch_compress4<false>(x, packed, minmax, rows, block, s);
}

// packed (rows, B/2) u8, minmax (rows, 2) f32 -> out (rows, B) f32.  B even;
// rows x tiles of a row must fit a 1-D grid.
int bagua_qr_decompress4(const uint8_t* packed, const float* minmax, float* out, int64_t rows,
                         int64_t block, void* stream) {
  if (rows <= 0 || block < 2 || block % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t half = block / 2;
  const int64_t threads = std::min<int64_t>(
      kDecompressThreads, ((half + kDecompressBytes - 1) / kDecompressBytes + 31) / 32 * 32);
  const int64_t tile = threads * kDecompressBytes;
  const int64_t tiles = (half + tile - 1) / tile;
  if (rows > 0x7fffffffLL / tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = half % 4 == 0 && aligned(packed, 4) && aligned(out, 16);
  const unsigned grid = static_cast<unsigned>(rows * tiles);
  if (vec) decompress4_kernel<true><<<grid, static_cast<unsigned>(threads), 0, s>>>(packed, minmax, out, half, tiles);
  else decompress4_kernel<false><<<grid, static_cast<unsigned>(threads), 0, s>>>(packed, minmax, out, half, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
