// The collective-matmul rings' tile GEMM, for Hopper (sm_90a): a batched f32
// matrix product, one batch entry per rank.
//
// Replaces the Pallas TPU kernel of bagua_tpu/kernels/collective_matmul.py:
//   bagua_matmul_tile   _matmul_kernel   (body :229, pallas_call :299; entry
//                                         matmul_tile_pallas :239)
//
// Semantics (matmul_tile_plain in bagua_tpu_torch/kernels/collective_matmul.py):
//   c[r] = a[r] . b[r]  for every batch entry r, in f32:
//   a (R, m, k) and b (R, k, n) read through the caller's strides, c (R, m, n)
//   written contiguous.  Each c element is one sum over k, taken in
//   increasing k with fused multiply-adds.
//
// Layouts.  Any strides: the backward's transposed operands (w^T, x^T) and
// the ring's per-rank block views go in uncopied.  A tile is loaded so that
// neighbouring threads read neighbouring addresses along whichever of the
// operand's two dims has stride 1 (a: k or m; b: n or k).  Ragged edges of
// m, n and k are masked here (zeros in shared memory, no store past the
// edge): the TPU kernel's external zero padding is a layout need of its
// (8, 128) tiles, not semantics.  Any k: the TPU kernel held the whole k of a
// tile in VMEM and fell back to jnp.dot above 8 MB; here k streams through
// shared memory in chunks of kBK.
//
// Design.  A CTA of 256 threads owns a 128 x 128 tile of c and walks k in
// chunks of kBK = 16: each chunk of a (128 x 16) and b (16 x 128) is staged in
// shared memory (a stored k-major, so both are read along m or n), double
// buffered, the next chunk's global loads issued into registers before the
// current chunk's products.  Each thread keeps an 8 x 8 block of c in
// registers: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3}
// and 64 + tx*4 + {0..3}, so its shared-memory reads are float4s that a
// quarter warp takes without bank conflicts; staged rows are kBM + 4 floats
// apart, so the k-major stores of a transposed operand spread over the banks.
// Grid: (n tiles, m tiles, R).  No atomics: results are deterministic, and a
// batch entry's result does not depend on the others.
//
// Bound: f32 operations.  The rings' tiles at Llama-7B width do 2 m n k
// operations on about (mk + kn + mn) 4 bytes, some 600 operations a byte, far
// above the H100's f32 balance (67 TFLOP/s over 3.35 TB/s, 20 a byte).  This
// kernel runs on the CUDA cores in full f32 (no TF32, no tensor cores), so
// its bound is 67 TFLOP/s; the 8 x 8 register block gives each thread 64
// independent FMA chains to keep the pipes full.  Shared memory: 2 x 2 x 16
// x 132 floats = 33,792 bytes, static, under the 48 KB that needs no opt-in.
// No wgmma, TMA or TF32 yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of c per CTA
constexpr int kBN = 128;  // columns of c per CTA
constexpr int kBK = 16;   // k per shared-memory chunk
constexpr int kLoads = kBM * kBK / kThreads;  // elements of a (and of b) each thread stages
constexpr int kLD = kBM + 4;  // row stride of a staged chunk: k-major stores spread over banks

// Element strides of a batched operand: batch, rows, columns.
struct View {
  int64_t sb, sr, sc;
};

struct Dims {
  int64_t r, m, n, k;
};

// How a thread stages its kLoads elements of a 128 x kBK tile (rows: a's m
// or b's n; k: the contraction).  KMajor (the operand's k has stride 1):
// neighbouring threads take neighbouring k, and element i sits 16 i rows
// further; else neighbouring rows, and element i sits 2 i k further.  Either
// way a thread's elements are one base offset plus i steps.
template <bool KMajor>
struct Staging {
  int row, k;    // this thread's first element, within the tile
  int64_t step;  // elements between its consecutive elements in memory
  __device__ Staging(const View& v) {
    const int t = threadIdx.x;
    row = KMajor ? t / kBK : t % kBM;
    k = KMajor ? t % kBK : t / kBM;
    step = KMajor ? (kThreads / kBK) * v.sr : (kThreads / kBM) * v.sc;
  }
  __device__ __forceinline__ int row_of(int i) const {
    return KMajor ? row + i * (kThreads / kBK) : row;
  }
  __device__ __forceinline__ int k_of(int i) const {
    return KMajor ? k : k + i * (kThreads / kBM);
  }

  // The tile at rows r0.., k0.. of an operand with `rows` rows and `depth`
  // k into registers, zeros past its edges.
  __device__ __forceinline__ void load(const float* __restrict__ p, const View& v, int64_t r0,
                                       int64_t k0, int64_t rows, int64_t depth,
                                       float (&reg)[kLoads]) const {
    const float* base = p + (r0 + row) * v.sr + (k0 + k) * v.sc;
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      reg[i] = (r0 + row_of(i) < rows && k0 + k_of(i) < depth) ? base[i * step] : 0.0f;
  }

  // The registers into a k-major staged chunk: s[k][row].
  __device__ __forceinline__ void store(float (*s)[kLD], const float (&reg)[kLoads]) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) s[k_of(i)][row_of(i)] = reg[i];
  }
};

template <bool AK, bool BK>
__global__ void __launch_bounds__(kThreads, 2)
    matmul_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ c, Dims d, View va, View vb) {
  __shared__ __align__(16) float as[2][kBK][kLD];
  __shared__ __align__(16) float bs[2][kBK][kLD];

  const int64_t batch = blockIdx.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  a += batch * va.sb;
  b += batch * vb.sb;
  c += batch * d.m * d.n;

  const int tx = threadIdx.x % 16;  // column group
  const int ty = threadIdx.x / 16;  // row group

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // b is staged as rows n, so its view swaps (k, n) to (n, k)
  const View vbt{vb.sb, vb.sc, vb.sr};
  const Staging<AK> sa(va);
  const Staging<BK> sb(vbt);
  float ra[kLoads], rb[kLoads];
  const int64_t chunks = (d.k + kBK - 1) / kBK;
  if (chunks > 0) {
    sa.load(a, va, m0, 0, d.m, d.k, ra);
    sb.load(b, vbt, n0, 0, d.n, d.k, rb);
    sa.store(as[0], ra);
    sb.store(bs[0], rb);
  }
  __syncthreads();

  for (int64_t ch = 0; ch < chunks; ++ch) {
    const int cur = static_cast<int>(ch & 1);
    const bool more = ch + 1 < chunks;
    if (more) {  // the next chunk's global loads overlap this chunk's products
      sa.load(a, va, m0, (ch + 1) * kBK, d.m, d.k, ra);
      sb.load(b, vbt, n0, (ch + 1) * kBK, d.n, d.k, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {  // the other buffer was last read before the previous barrier
      sa.store(as[cur ^ 1], ra);
      sb.store(bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= d.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < d.n) c[gm * d.n + gn] = acc[i][j];
    }
  }
}

template <bool AK, bool BK>
int launch(const float* a, const float* b, float* c, const Dims& d, const View& va,
           const View& vb, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((d.n + kBN - 1) / kBN),
                  static_cast<unsigned>((d.m + kBM - 1) / kBM), static_cast<unsigned>(d.r));
  matmul_tile_kernel<AK, BK><<<grid, kThreads, 0, s>>>(a, b, c, d, va, vb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dims: R, m, n, k.  strides: a's (batch, m, k) then b's (batch, k, n), in
// elements.  -> c (R, m, n) f32, contiguous.  Returns a cudaError_t code.
int bagua_matmul_tile(const float* a, const float* b, float* c, const int64_t* dims,
                      const int64_t* strides, void* stream) {
  const Dims d{dims[0], dims[1], dims[2], dims[3]};
  if (d.r <= 0 || d.m <= 0 || d.n <= 0 || d.k < 0 || d.r > 65535 ||
      (d.n + kBN - 1) / kBN > 0x7fffffffLL || (d.m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const View va{strides[0], strides[1], strides[2]};
  const View vb{strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // coalesce along the dim with stride 1: a's k (row-major x, g) or m (x^T);
  // b's n (row-major w, g) or k (w^T)
  const bool ak = va.sc == 1 && va.sr != 1;
  const bool bk = vb.sr == 1 && vb.sc != 1;
  if (ak)
    return bk ? launch<true, true>(a, b, c, d, va, vb, s) : launch<true, false>(a, b, c, d, va, vb, s);
  return bk ? launch<false, true>(a, b, c, d, va, vb, s)
            : launch<false, false>(a, b, c, d, va, vb, s);
}

}  // extern "C"
