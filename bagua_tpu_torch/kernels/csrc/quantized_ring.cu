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
// Design.  One block (CTA) per quantization row, over a grid of ranks x
// blocks-per-shard rows (25,088 rows of 4096 at VGG16's Dense_0 bucket over 4
// ranks): the ring calls the hop once per step for every rank at once.
//   pass 1: load the incoming bytes (4 per thread where the row allows) and
//           the local f32 partial (16 bytes per thread), dequantize with the
//           row's scale (derived once), form s, reduce min/max over the CTA;
//   pass 2: derive scale2/upper2 once, quantize s, store q2 and err, thread 0
//           stores mm2.
// s stays in shared memory while its 4 B bytes fit in 32 KB (B <= 8192; the
// default B = 4096 takes 16 KB), which with the static shared memory stays
// under the 48 KB a launch gets without opting in; above that pass 2
// recomputes s from the inputs, the same arithmetic, so the result stays
// bitwise.  Every even B works; nothing falls back.
// Bound: device-memory bytes.  Least traffic per element: int8 1 + 4 in and
// 1 + 4 out, int4 0.5 + 4 in and 0.5 + 4 out, plus 16 B of sidecars per row;
// this kernel moves exactly that (it reads each input once).

#include "xla_float.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSmemBytes = 32 * 1024;

template <int kW>
__device__ __forceinline__ void load(const uint8_t* p, uint8_t (&v)[kW]) {
  if constexpr (kW == 4) {
    const uchar4 u = *reinterpret_cast<const uchar4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = *p;
  }
}

template <int kW>
__device__ __forceinline__ void load(const float* p, float (&v)[kW]) {
  if constexpr (kW == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = *p;
  }
}

template <int kW>
__device__ __forceinline__ void store(uint8_t* p, const uint8_t (&v)[kW]) {
  if constexpr (kW == 4) *reinterpret_cast<uchar4*>(p) = make_uchar4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

template <int kW>
__device__ __forceinline__ void store(float* p, const float (&v)[kW]) {
  if constexpr (kW == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

__device__ __forceinline__ float dequantize(uint32_t level, float scale, float lower) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(level), lower), scale);
}

// s of the kW bytes at column j: lo[k] is element j + k, hi[k] (int4 only)
// element half + j + k.
template <int kBits, int kW>
__device__ __forceinline__ void sums(const uint8_t* qr, const float* lr, int64_t j, int64_t half,
                                     float scale, float lower, float (&lo)[kW], float (&hi)[kW]) {
  uint8_t b[kW];
  float l[kW];
  load<kW>(qr + j, b);
  load<kW>(lr + j, l);
#pragma unroll
  for (int k = 0; k < kW; ++k)
    lo[k] = __fadd_rn(dequantize(kBits == 8 ? b[k] : b[k] & 0xFu, scale, lower), l[k]);
  if constexpr (kBits == 4) {
    load<kW>(lr + half + j, l);
#pragma unroll
    for (int k = 0; k < kW; ++k) hi[k] = __fadd_rn(dequantize(b[k] >> 4, scale, lower), l[k]);
  }
}

// kW: bytes of q per thread per step (4: vector loads); kSmem: s kept in
// shared memory between the passes.
template <int kBits, int kW, bool kSmem>
__global__ void __launch_bounds__(kThreads)
hop_kernel(const uint8_t* __restrict__ q, const float* __restrict__ minmax,
           const float* __restrict__ local, uint8_t* __restrict__ q_out,
           float* __restrict__ mm_out, float* __restrict__ err, int64_t block) {
  constexpr float kL = kBits == 8 ? 255.0f : 15.0f;
  extern __shared__ float4 s_raw[];
  float* s_buf = reinterpret_cast<float*>(s_raw);
  __shared__ float2 params;  // (scale2, upper2)
  const int64_t row = blockIdx.x;
  const int64_t cols = kBits == 8 ? block : block / 2;  // bytes of a q row
  const int64_t half = block / 2;
  const uint8_t* qr = q + row * cols;
  const float* lr = local + row * block;
  const float mx_in = minmax[2 * row + 1];
  const float scale = xla::safe_scale(minmax[2 * row], mx_in, kL);
  const float lower = __fsub_rn(rintf(__fmul_rn(mx_in, scale)), kL);

  float mn = INFINITY, mx = -INFINITY;
  for (int64_t j = threadIdx.x * kW; j < cols; j += kThreads * kW) {
    float lo[kW], hi[kW];
    sums<kBits, kW>(qr, lr, j, half, scale, lower, lo, hi);
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      mn = xla::min(mn, lo[k]);
      mx = xla::max(mx, lo[k]);
      if constexpr (kBits == 4) {
        mn = xla::min(mn, hi[k]);
        mx = xla::max(mx, hi[k]);
      }
    }
    if constexpr (kSmem) {
      store<kW>(s_buf + j, lo);
      if constexpr (kBits == 4) store<kW>(s_buf + half + j, hi);
    }
  }
  xla::block_minmax<kThreads>(mn, mx);
  if (threadIdx.x == 0) {
    mm_out[2 * row] = mn;
    mm_out[2 * row + 1] = mx;
    const float sc = xla::safe_scale(mn, mx, kL);
    params = make_float2(sc, rintf(__fmul_rn(mx, sc)));
  }
  __syncthreads();
  const float scale2 = params.x, upper2 = params.y;
  const float lower2 = __fsub_rn(upper2, kL);

  uint8_t* qo = q_out + row * cols;
  float* er = err + row * block;
  for (int64_t j = threadIdx.x * kW; j < cols; j += kThreads * kW) {
    float lo[kW], hi[kW];
    if constexpr (kSmem) {
      load<kW>(s_buf + j, lo);
      if constexpr (kBits == 4) load<kW>(s_buf + half + j, hi);
    } else {
      sums<kBits, kW>(qr, lr, j, half, scale, lower, lo, hi);
    }
    uint8_t b[kW];
    float e[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float lvl = __fsub_rn(xla::min(rintf(__fmul_rn(lo[k], scale2)), upper2), lower2);
      if constexpr (kBits == 8) {
        b[k] = xla::to_u8(lvl);
      } else {
        const float lvh = __fsub_rn(xla::min(rintf(__fmul_rn(hi[k], scale2)), upper2), lower2);
        const uint32_t packed = static_cast<uint32_t>(xla::to_s32(lvl)) |
                                (static_cast<uint32_t>(xla::to_s32(lvh)) << 4);
        b[k] = static_cast<uint8_t>(packed & 0xFFu);
      }
      e[k] = __fsub_rn(lo[k], dequantize(kBits == 8 ? b[k] : b[k] & 0xFu, scale2, lower2));
    }
    store<kW>(qo + j, b);
    store<kW>(er + j, e);
    if constexpr (kBits == 4) {
#pragma unroll
      for (int k = 0; k < kW; ++k) e[k] = __fsub_rn(hi[k], dequantize(b[k] >> 4, scale2, lower2));
      store<kW>(er + half + j, e);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kBits>
void launch(const uint8_t* q, const float* minmax, const float* local, uint8_t* q_out,
            float* mm_out, float* err, int64_t rows, int64_t block, bool vec, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(rows);
  const int64_t smem = block * static_cast<int64_t>(sizeof(float));
  if (smem <= kSmemBytes) {
    if (vec)
      hop_kernel<kBits, 4, true><<<grid, kThreads, smem, s>>>(q, minmax, local, q_out, mm_out, err, block);
    else
      hop_kernel<kBits, 1, true><<<grid, kThreads, smem, s>>>(q, minmax, local, q_out, mm_out, err, block);
  } else {
    if (vec)
      hop_kernel<kBits, 4, false><<<grid, kThreads, 0, s>>>(q, minmax, local, q_out, mm_out, err, block);
    else
      hop_kernel<kBits, 1, false><<<grid, kThreads, 0, s>>>(q, minmax, local, q_out, mm_out, err, block);
  }
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
  const int64_t cols = bits == 8 ? block : block / 2;
  const bool vec = cols % 4 == 0 && aligned(q, 4) && aligned(q_out, 4) &&
                   aligned(local, 16) && aligned(err, 16);
  if (bits == 8) launch<8>(q, minmax, local, q_out, mm_out, err, rows, block, vec, s);
  else launch<4>(q, minmax, local, q_out, mm_out, err, rows, block, vec, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
