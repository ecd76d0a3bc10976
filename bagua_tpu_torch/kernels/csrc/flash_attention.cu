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
// by index, no repeated K/V.
//
// Layouts: qf (b, tq, h, d) f32; k, v (b, tk, h_kv, d) f32, bf16 or f16; mask
// (b, tq, tk) bool; each read through the caller's strides (d contiguous), so
// the ring's half-block views need no copy.  o (b, h, tq, d), l and m
// (b, h, tq), dq (b, tq, h, d), dk and dv (b, tk, h_kv, d) are written
// contiguous; do is read through strides, m and dl contiguous.
//
// Design of the forward and dq.  A CTA of 256 threads owns one 64-row tile
// of queries of one head and loops over the keys' 64-row tiles, keeping its
// running state (m, l, o; or the dq sum) in registers: nothing crosses CTAs,
// so there are no atomics and every result is deterministic.  Tiles live in
// shared memory as f32 rows of d padded to D = 64 or 128 (zeros past d),
// with a row stride of D + 4 floats so that a thread's float4 reads along d
// fall on distinct banks.  Each thread owns a 4 x 4 block of the 64 x 64
// score tile (rows ty + 16r, columns tx + 16c) and a 4 x D/16 block of the
// 64 x D output tile; the score tile goes through shared memory between the
// two products.  Row statistics reduce over the 16 lanes of a half warp
// with shuffles.  A tile whose mask is all false is skipped by the whole CTA
// (__syncthreads_or), so under a causal mask about half the work is never
// done; the running state is then untouched, as in the TPU kernel.  The dk/dv
// kernel has a design of its own (warp-tiled products, asynchronous staging
// of the next live tile, liveness from one coalesced scan of the mask): its
// section below says what and why.
//
// Bound: f32 operations.  Per live (query, key) pair and head the forward
// does 4d operations (two products), dq 6d, dk/dv 8d, all on the CUDA cores
// (67 TFLOP/s on an H100 SXM), against O(t d) bytes.  The tensor cores would
// read TF32 inputs (10 mantissa bits, 2^-11 relative each), which spends a
// large part of the contract, the plain f32 versions within 2e-4 to 3e-4 of
// max(1, |value|) (the bounds the JAX package holds its Pallas kernels to),
// on input rounding alone; split-TF32 (three products per term) keeps f32
// accuracy but sums in another order.  Either would need a tolerance and a
// check of its own, so these kernels stay full f32 FMA.  Shared memory above
// 48 KB is opted into per launch: at D = 128 the forward takes 101,376 bytes
// (two CTAs per SM), dq 135,168 and dk/dv 231,424 (one).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query or key rows per tile
constexpr int kLS = kTile + 4;  // row stride of a score tile in shared memory
constexpr float kNeg = -1e30f;

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

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of one head of one batch into a [64][D + 4] f32
// tile; rows past `rows` and columns past d are zero.
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

// acc[r][c] += sum_k A[ty + 16r][k] * B[tx + 16c][k]: a 64 x 64 product
// contracted along d, both operands [64][D + 4] tiles.
template <int D>
__device__ __forceinline__ void contract_d(const float* A, const float* B, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * (D + 4) + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * (D + 4) + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

// acc[r][4q + e] += sum_j S[ty + 16r][j] * B[j][4tx + 64q + e]: a 64 x D
// product contracted along the 64 rows of B; S is a [64][kLS] score tile, B
// a [64][D + 4] tile.
template <int D>
__device__ __forceinline__ void contract_t(const float* S, const float* B, float (&acc)[4][D / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = *reinterpret_cast<const float4*>(S + (ty + 16 * r) * kLS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* brow = B + (j + jj) * (D + 4) + 4 * tx;
#pragma unroll
      for (int q = 0; q < D / 64; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(brow + 64 * q);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
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

// This thread's D/16 columns of the output row at `out` (columns past d dropped).
template <int D, typename T>
__device__ __forceinline__ void store_row(T* out, const float (&acc)[D / 16], int64_t d) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int q = 0; q < D / 64; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t c = 4 * tx + 64 * q + e;
      if (c < d) out[c] = from_f32<T>(acc[4 * q + e]);
    }
}

template <int D>
constexpr size_t tile_bytes() {
  return static_cast<size_t>(kTile) * (D + 4) * sizeof(float);
}

// ---------------------------------------------------------------------------
// Forward: grid (b * h, q tiles)
// ---------------------------------------------------------------------------

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                 const uint8_t* __restrict__ mask, float* __restrict__ o, float* __restrict__ l,
                 float* __restrict__ m, Dims dm, View qv, View kv, View vv, MaskView mv) {
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kTile * (D + 4);
  float* Vs = Ks + kTile * (D + 4);
  float* Ps = Ks;  // the probabilities take K's place once the scores are formed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.x, bi = bh / dm.h, hi = bh % dm.h;
  const int64_t kvh = hi / (dm.h / dm.hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const uint8_t* mb = mask + bi * mv.sb;

  load_tile<D>(Qs, q, qv, bi, hi, q0, dm.tq, dm.d);
  float m_run[4], l_run[4], acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNeg;
    l_run[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[r][e] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < dm.tk; k0 += kTile) {
    bool live[4][4];
    int any = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t i = q0 + ty + 16 * r, j = k0 + tx + 16 * c;
        live[r][c] = i < dm.tq && j < dm.tk && mb[i * mv.sq + j * mv.sk] != 0;
        any |= live[r][c];
      }
    // a dead tile leaves the state untouched; the barrier also keeps the
    // loads below from overwriting tiles another thread still reads
    if (!__syncthreads_or(any)) continue;
    load_tile<D>(Ks, k, kv, bi, kvh, k0, dm.tk, dm.d);
    load_tile<D>(Vs, v, vv, bi, kvh, k0, dm.tk, dm.d);
    __syncthreads();

    float s[4][4] = {};
    contract_d<D>(Qs, Ks, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = live[r][c] ? s[r][c] : kNeg;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_run[r], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = live[r][c] ? expf(s[r][c] - m_new) : 0.0f;
        sum += s[r][c];
      }
      const float corr = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr + row_sum(sum);
#pragma unroll
      for (int e = 0; e < D / 16; ++e) acc[r][e] *= corr;
      m_run[r] = m_new;
    }
    __syncthreads();  // every thread is done with Ks
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + 16 * r) * kLS + tx + 16 * c] = s[r][c];
    __syncthreads();
    contract_t<D>(Ps, Vs, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + ty + 16 * r;
    if (i >= dm.tq) continue;
    store_row<D>(o + (bh * dm.tq + i) * dm.d, acc[r], dm.d);
    if (tx == 0) {
      l[bh * dm.tq + i] = l_run[r];
      m[bh * dm.tq + i] = m_run[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dq: grid (b * h, q tiles)
// ---------------------------------------------------------------------------

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                    const uint8_t* __restrict__ mask, const float* __restrict__ m,
                    const float* __restrict__ dl, const float* __restrict__ dout,
                    float* __restrict__ dq, Dims dm, View qv, View kv, View vv, MaskView mv,
                    View dov) {
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kTile * (D + 4);
  float* Ks = dOs + kTile * (D + 4);
  float* Vs = Ks + kTile * (D + 4);
  float* dSs = Vs;  // ds takes V's place once dp is formed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.x, bi = bh / dm.h, hi = bh % dm.h;
  const int64_t kvh = hi / (dm.h / dm.hkv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const uint8_t* mb = mask + bi * mv.sb;

  load_tile<D>(Qs, q, qv, bi, hi, q0, dm.tq, dm.d);
  load_tile<D>(dOs, dout, dov, bi, hi, q0, dm.tq, dm.d);
  float m_i[4], dl_i[4], acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + ty + 16 * r;
    m_i[r] = i < dm.tq ? m[bh * dm.tq + i] : 0.0f;
    dl_i[r] = i < dm.tq ? dl[bh * dm.tq + i] : 0.0f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[r][e] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < dm.tk; k0 += kTile) {
    bool live[4][4];
    int any = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t i = q0 + ty + 16 * r, j = k0 + tx + 16 * c;
        live[r][c] = i < dm.tq && j < dm.tk && mb[i * mv.sq + j * mv.sk] != 0;
        any |= live[r][c];
      }
    if (!__syncthreads_or(any)) continue;  // dead tiles contribute exactly zero
    load_tile<D>(Ks, k, kv, bi, kvh, k0, dm.tk, dm.d);
    load_tile<D>(Vs, v, vv, bi, kvh, k0, dm.tk, dm.d);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    contract_d<D>(Qs, Ks, s);
    contract_d<D>(dOs, Vs, dp);
    __syncthreads();  // every thread is done with Vs
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = live[r][c] ? expf(s[r][c] - m_i[r]) : 0.0f;
        dSs[(ty + 16 * r) * kLS + tx + 16 * c] = p * (dp[r][c] + dl_i[r]);
      }
    __syncthreads();
    contract_t<D>(dSs, Ks, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + ty + 16 * r;
    if (i < dm.tq) store_row<D>(dq + ((bi * dm.tq + i) * dm.h + hi) * dm.d, acc[r], dm.d);
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
// - Shared-memory bandwidth (128 bytes a clock, against 128 FMAs): warp
//   tiling.  Warp w owns keys 16 (w / 2) .. +16; in the score products lane
//   (ly, lx) = (lane / 8, lane % 8) holds keys 4r + ly and queries 32 (w % 2)
//   + 8c + lx (r, c < 4), so a float4 read of K rows or of Q rows takes one
//   wavefront (4 or 8 distinct rows a warp); in the output products it holds
//   the same keys and d columns D/2 (w % 2) + 32q + 4 lx + {0..3}, one
//   wavefront per read of P^T, dS^T, dO or Q: about 0.11 wavefronts per
//   FMA, where the forward's and dq's 16 x 16 thread grid takes about 0.17.
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
// (1,024): 231,424 bytes.  D = 64: 129,024.  Registers: 244-254 a thread, no
// spill (ptxas -v, in the build log), under __launch_bounds__(256, 1).

constexpr int kPS = kTile + 8;  // row stride of the P^T / dS^T tile: conflict-free stores and reads
constexpr int kWindow = 1024;   // q tiles whose liveness a CTA holds at once

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 6 * tile_bytes<D>() + static_cast<size_t>(kTile) * kPS * sizeof(float) +
         2 * 2 * kTile * sizeof(float) + 2 * kTile * kTile + kWindow;
}

// acc[r][c] += sum_d A[a0 + 4r][d] * B[b0 + 8c][d]: rows of two [64][D + 4]
// tiles, contracted along d.
template <int D>
__device__ __forceinline__ void contract_rows(const float* A, int a0, const float* B, int b0,
                                              float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(A + (a0 + 4 * r) * (D + 4) + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = *reinterpret_cast<const float4*>(B + (b0 + 8 * c) * (D + 4) + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

// acc[r][4q + e] += sum_j S[s0 + 4r][j] * B[j][c0 + 32q + e]: rows of the
// [64][kPS] score tile S times the [64][D + 4] tile B.
template <int D>
__device__ __forceinline__ void contract_cols(const float* S, int s0, const float* B, int c0,
                                              float (&acc)[4][D / 16]) {
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = *reinterpret_cast<const float4*>(S + (s0 + 4 * r) * kPS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int q = 0; q < D / 64; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(B + (j + jj) * (D + 4) + c0 + 32 * q);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
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

// Bits of bagua_flash_bwd_dkv's `vec`: which operands take 16-byte copies.
constexpr int kVecQ = 1, kVecDo = 2, kVecMask = 4, kVecK = 8, kVecV = 16;

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
      uint8_t* tile = Mk + stage * kTile * kTile;
      if (vec & kVecMask) {  // one 16-key chunk per thread
        const int r = threadIdx.x / (kTile / 16), c = (threadIdx.x % (kTile / 16)) * 16;
        const int64_t i = q0 + r, left = dm.tk - (k0 + c);
        const int bytes = i < dm.tq && left > 0 ? static_cast<int>(left < 16 ? left : 16) : 0;
        copy16(tile + r * kTile + c, bytes ? mb + i * mv.sq + k0 + c : mb, bytes);
      } else {
        for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
          const int64_t i = q0 + e / kTile, j = k0 + e % kTile;
          tile[e] = i < dm.tq && j < dm.tk ? mb[i * mv.sq + j * mv.sk] : 0;
        }
      }
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
      contract_cols<D>(Ts, kb, dOc, cb, dv_acc);
      __syncthreads();  // every thread is done with P^T
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) Ts[(kb + 4 * r) * kPS + qb + 8 * c] = ds[r][c];
      __syncthreads();
      contract_cols<D>(Ts, kb, Qc, cb, dk_acc);
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

// Every row of every head of an f32 (batch, sequence, head, d) view starts
// 16-byte aligned.
bool aligned16(const float* p, const View& v) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && v.sb % 4 == 0 && v.st % 4 == 0 &&
         v.sh % 4 == 0;
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
  if (!dims_ok(dm, tiles(dm.tq))) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(dm.b * dm.h), static_cast<unsigned>(tiles(dm.tq)));
  return dispatch(dm.d, kv_dtype, [&](auto tag) {
    using T = decltype(tag);
    using KV = typename T::KV;
    auto kernel = flash_fwd_kernel<T::D, KV>;
    const size_t smem = 3 * tile_bytes<T::D>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kThreads, smem, s>>>(q, static_cast<const KV*>(k), static_cast<const KV*>(v),
                                        mask, o, l, m, dm, view_of(strides), view_of(strides + 3),
                                        view_of(strides + 6), mask_of(strides + 9));
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
  return dispatch(dm.d, kv_dtype, [&](auto tag) {
    using T = decltype(tag);
    using KV = typename T::KV;
    auto kernel = flash_bwd_dq_kernel<T::D, KV>;
    const size_t smem = 4 * tile_bytes<T::D>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kThreads, smem, s>>>(q, static_cast<const KV*>(k), static_cast<const KV*>(v),
                                        mask, m, dl, dout, dq, dm, view_of(strides),
                                        view_of(strides + 3), view_of(strides + 6),
                                        mask_of(strides + 9), view_of(strides + 12));
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
  const View qv = view_of(strides), dov = view_of(strides + 12);
  const MaskView mv = mask_of(strides + 9);
  const int vec = (aligned16(q, qv) ? kVecQ : 0) | (aligned16(dout, dov) ? kVecDo : 0) |
                  (reinterpret_cast<uintptr_t>(mask) % 16 == 0 && mv.sk == 1 && mv.sq % 16 == 0 &&
                           mv.sb % 16 == 0
                       ? kVecMask
                       : 0) |
                  (kv_dtype == 0 && aligned16(static_cast<const float*>(k), view_of(strides + 3))
                       ? kVecK
                       : 0) |
                  (kv_dtype == 0 && aligned16(static_cast<const float*>(v), view_of(strides + 6))
                       ? kVecV
                       : 0);
  return dispatch(dm.d, kv_dtype, [&](auto tag) {
    using T = decltype(tag);
    using KV = typename T::KV;
    auto kernel = flash_bwd_dkv_kernel<T::D, KV>;
    const size_t smem = dkv_smem_bytes<T::D>();
    int err = allow_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kThreads, smem, s>>>(q, static_cast<const KV*>(k), static_cast<const KV*>(v),
                                        mask, m, dl, dout, static_cast<KV*>(dk),
                                        static_cast<KV*>(dv), dm, qv, view_of(strides + 3),
                                        view_of(strides + 6), mv, dov, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
