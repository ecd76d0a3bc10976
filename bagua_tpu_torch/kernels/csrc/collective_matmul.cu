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
//   written contiguous.  Each c element is one chain of fused multiply-adds
//   in increasing k, started from zero: no split k, no atomics, so results
//   are deterministic and a batch entry's result does not depend on the
//   others.
//
// Bound: f32 operations on the CUDA cores, 67 TFLOP/s on an H100 SXM.  The
// rings' tiles at Llama-7B width do 2 m n k operations on about (mk + kn +
// mn) 4 bytes, some 600 operations a byte, far above the card's f32 balance
// (20 a byte).  The tensor cores are not used: their f32 inputs are TF32
// (10 mantissa bits), and split-TF32 sums three products per term in
// another order; the contract with the JAX reference is a full f32 product
// within 2 sqrt(K) 2^-24 (|x| |w|), which TF32 inputs miss at the rings'
// shapes.  So the kernel's work is to keep the FMA pipes issuing.
//
// Design.  A CTA of 256 threads (8 warps, one CTA per SM) owns a 128 x 256
// tile of c and walks k in chunks of kBK = 16 through a ring of kStages = 4
// shared-memory stages filled by asynchronous copies (cp.async): three
// chunks are in flight while one is multiplied, with one barrier per chunk,
// and no register holds a value on its way to shared memory.  Each thread
// keeps an 8 x 16 block of c in registers (128 accumulators): per k it reads
// 2 float4s of a and 4 of b from shared memory for 128 FMAs, into one of two
// register sets while the FMAs of the other run (a chunk's first operands are
// read right after its barrier, before the next copies are issued).  Warp w owns
// rows 32 (w / 2) .. +32 and columns 128 (w % 2) .. +128; lane (lane / 8,
// lane % 8) holds rows in two quads 16 apart and columns in four quads 32
// apart, so a warp's float4 reads take one wavefront each.  Both operands are
// staged s[k][row] (rows: a's m, b's n), rows padded by 4 floats; how a chunk
// is copied follows the operand's layout (Mode, chosen on the host):
//   kRowVec    rows of stride 1, 16-byte aligned: 16-byte copies along the
//              rows (a's x^T, b's row-major w and g);
//   kKMajor    k of stride 1 (a's row-major x and g, b's w^T): 4-byte copies,
//              a warp taking 8 consecutive k of 4 rows: whole 32-byte sectors
//              from memory, 32 distinct banks in shared memory;
//   kRowScalar anything else (off a 16-byte boundary; no dim of stride 1):
//              4-byte copies along the rows.
// At ragged edges of m, n and k the copies zero-fill (cp.async's source
// size), and the store is masked.
//
// Budget.  Shared memory: 4 stages of 16 x (132 + 260) floats = 100,352
// bytes, dynamic (opted into per launch).  Registers: 213-249 a thread under
// __launch_bounds__(256, 1), no spill (ptxas -v, in the build log).  The 8 x
// 8 block of the earlier design (128 x 128 tiles, two CTAs per SM under
// __launch_bounds__(256, 2); MATMUL_TN=8 below) keeps 64 accumulators but
// spills at that 128-register cap and reads shared memory twice as often per
// FMA.  chip_kernel_ab.py times it, uncapped (MATMUL_MIN_BLOCKS=1), and the
// other knobs below against this shape (PERF.md has the numbers).  What is
// left: the product with both operands k-major (Row dx) issues 24 4-byte
// copies a thread per chunk where the aligned row-major ones issue 6 16-byte
// copies; the m = 1024, n = 2752 products run 352 CTAs, 2.67 waves of 132,
// so their last wave is two-thirds full.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

// Compile-time shape of the kernel; chip_kernel_ab.py --variant="-DNAME=VALUE"
// times another choice beside this one.
#ifndef MATMUL_TN
#define MATMUL_TN 16  // columns of c per thread: 8 or 16
#endif
#ifndef MATMUL_MIN_BLOCKS
#define MATMUL_MIN_BLOCKS (MATMUL_TN == 8 ? 2 : 1)  // CTAs per SM for __launch_bounds__
#endif
#ifndef MATMUL_BK
#define MATMUL_BK 16  // k per shared-memory stage: 8, 16 or 32
#endif
#ifndef MATMUL_STAGES
#define MATMUL_STAGES 4
#endif

constexpr int kThreads = 256;
constexpr int kTN = MATMUL_TN;
constexpr int kWarpsN = 2;
constexpr int kBM = 128;                 // rows of c per CTA: 4 warps of 32
constexpr int kBN = kWarpsN * 8 * kTN;  // columns of c per CTA: 2 warps of 8 lanes x kTN
constexpr int kBK = MATMUL_BK;
constexpr int kStages = MATMUL_STAGES;
constexpr int kLDA = kBM + 4;  // row stride of a staged chunk, s[k][row]
constexpr int kLDB = kBN + 4;
constexpr int kStage = kBK * (kLDA + kLDB);  // floats of one stage: a, then b
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStage * sizeof(float);

static_assert(kTN == 8 || kTN == 16, "a thread holds 8 or 16 columns");
static_assert(kBK == 8 || kBK == 16 || kBK == 32, "the copy mappings cover 8, 16 or 32 k");
static_assert(kBK % 2 == 0, "the operand registers alternate by k");

struct Dims {
  int64_t r, m, n, k;
};

// An operand seen as (batch, rows, k): a's rows are m, b's are n.  Element
// strides.
struct View {
  int64_t sb, sr, sk;
};

// How an operand's chunks are copied (chosen on the host, per operand).
enum Mode {
  kRowVec = 0,     // rows of stride 1, 16-byte aligned: 16-byte copies along the rows
  kKMajor = 1,     // k of stride 1: 4-byte copies, a warp taking 8 k of 4 rows
  kRowScalar = 2,  // anything else: 4-byte copies along the rows
};

// Issues the copies of one chunk, rows r0.. and k k0.., of an operand with
// `rows` rows and `depth` k into s[k][row] (row stride ROWS + 4).
template <int M, int ROWS>
__device__ __forceinline__ void load_chunk(float* s, const float* __restrict__ p, const View& v,
                                           int64_t r0, int64_t k0, int64_t rows, int64_t depth) {
  constexpr int kLD = ROWS + 4;
  const int t = threadIdx.x;
  if constexpr (M == kRowVec) {  // a warp: 128 consecutive rows of one k
    constexpr int kPerK = ROWS / 4;  // copies per k
    const int k_t = t / kPerK, row_t = (t % kPerK) * 4;
#pragma unroll
    for (int i = 0; i < ROWS * kBK / 4 / kThreads; ++i) {
      const int k = k_t + i * (kThreads / kPerK);
      const int64_t gr = r0 + row_t, gk = k0 + k, left = rows - gr;
      const int bytes = gk < depth && left > 0 ? static_cast<int>(left < 4 ? left : 4) * 4 : 0;
      copy16(s + k * kLD + row_t, bytes ? p + gk * v.sk + gr : p, bytes);
    }
  } else if constexpr (M == kKMajor) {  // whole 32-byte sectors, 32 distinct banks
    const int row_t = (t / 32) * 4 + (t % 32) / 8, k_t = t % 8;
#pragma unroll
    for (int i = 0; i < ROWS * kBK / kThreads; ++i) {
      const int dr = (i / (kBK / 8)) * (kThreads / 8), dk = (i % (kBK / 8)) * 8;
      const int64_t gr = r0 + row_t + dr, gk = k0 + k_t + dk;
      const bool valid = gr < rows && gk < depth;
      copy4(s + (k_t + dk) * kLD + row_t + dr, valid ? p + gr * v.sr + gk : p, valid);
    }
  } else {  // rolled: more live addresses would spill at a register cap
#pragma unroll 1
    for (int i = 0; i < ROWS * kBK / kThreads; ++i) {
      const int row = t % ROWS, k = t / ROWS + i * (kThreads / ROWS);
      const int64_t gr = r0 + row, gk = k0 + k;
      const bool valid = gr < rows && gk < depth;
      copy4(s + k * kLD + row, valid ? p + gr * v.sr + gk * v.sk : p, valid);
    }
  }
}

template <int MA, int MB>
__global__ void __launch_bounds__(kThreads, MATMUL_MIN_BLOCKS)
    matmul_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ c, Dims d, View va, View vb, bool vec_store) {
  extern __shared__ float4 smem[];
  float* stages = reinterpret_cast<float*>(smem);  // [kStages][a: kBK x kLDA, b: kBK x kLDB]

  const int64_t batch = blockIdx.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  a += batch * va.sb;
  b += batch * vb.sb;
  c += batch * d.m * d.n;

  // warp w owns rows 32 (w / kWarpsN) .. +32 and columns 8 kTN (w % kWarpsN)
  // .. +8 kTN; lane (lane / 8, lane % 8) holds rows rm + {0..3} and rm + 16
  // + {0..3}, columns cn + 32q + {0..3} for q < kTN / 4
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rm = (warp / kWarpsN) * 32 + (lane / 8) * 4;
  const int cn = (warp % kWarpsN) * 8 * kTN + (lane % 8) * 4;

  float acc[8][kTN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  const int64_t chunks = (d.k + kBK - 1) / kBK;
  auto stage = [&](int64_t ch) { return stages + static_cast<int>(ch % kStages) * kStage; };
  auto load = [&](int64_t ch) {
    load_chunk<MA, kBM>(stage(ch), a, va, m0, ch * kBK, d.m, d.k);
    load_chunk<MB, kBN>(stage(ch) + kBK * kLDA, b, vb, n0, ch * kBK, d.n, d.k);
  };
  // this thread's operands at k = kk of a stage: 8 values of a, kTN of b
  float av[2][8], bv[2][kTN];
  auto fetch = [&](const float* s, int kk, float (&x)[8], float (&y)[kTN]) {
    const float4 a0 = *reinterpret_cast<const float4*>(s + kk * kLDA + rm);
    const float4 a1 = *reinterpret_cast<const float4*>(s + kk * kLDA + rm + 16);
    x[0] = a0.x, x[1] = a0.y, x[2] = a0.z, x[3] = a0.w;
    x[4] = a1.x, x[5] = a1.y, x[6] = a1.z, x[7] = a1.w;
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(s + kBK * kLDA + kk * kLDB + cn + 32 * q);
      y[4 * q] = t.x, y[4 * q + 1] = t.y, y[4 * q + 2] = t.z, y[4 * q + 3] = t.w;
    }
  };

#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) {
    if (ch < chunks) load(ch);
    commit();  // empty groups keep the count uniform
  }
  for (int64_t ch = 0; ch < chunks; ++ch) {
    wait_pending<kStages - 2>();  // chunk ch has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage ch - 1 is free
    const float* s = stage(ch);
    fetch(s, 0, av[0], bv[0]);  // read before the copies are issued
    if (ch + kStages - 1 < chunks) load(ch + kStages - 1);
    commit();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int cur = kk % 2;  // the operands of k = kk
      if (kk + 1 < kBK)        // the other set fills while these FMAs run
        fetch(s, kk + 1, av[cur ^ 1], bv[cur ^ 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[cur][i], bv[cur][j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + rm + (i < 4 ? i : 12 + i);
    if (gm >= d.m) continue;
    float* row = c + gm * d.n;
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      const int64_t gn = n0 + cn + 32 * q;
      if (vec_store && gn + 3 < d.n) {
        *reinterpret_cast<float4*>(row + gn) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < d.n) row[gn + j] = acc[i][4 * q + j];
    }
  }
}

template <int MA, int MB>
int launch(const float* a, const float* b, float* c, const Dims& d, const View& va,
           const View& vb, bool vec_store, cudaStream_t s) {
  auto kernel = matmul_tile_kernel<MA, MB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((d.n + kBN - 1) / kBN),
                  static_cast<unsigned>((d.m + kBM - 1) / kBM), static_cast<unsigned>(d.r));
  kernel<<<grid, kThreads, kSmemBytes, s>>>(a, b, c, d, va, vb, vec_store);
  return static_cast<int>(cudaGetLastError());
}

template <int MA>
int launch_b(int mb, const float* a, const float* b, float* c, const Dims& d, const View& va,
             const View& vb, bool vec_store, cudaStream_t s) {
  switch (mb) {
    case kRowVec: return launch<MA, kRowVec>(a, b, c, d, va, vb, vec_store, s);
    case kKMajor: return launch<MA, kKMajor>(a, b, c, d, va, vb, vec_store, s);
    default: return launch<MA, kRowScalar>(a, b, c, d, va, vb, vec_store, s);
  }
}

// How an operand's chunks are copied (see Mode).
int mode_of(const float* p, const View& v) {
  if (v.sr == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && v.sk % 4 == 0 && v.sb % 4 == 0)
    return kRowVec;
  return v.sk == 1 ? kKMajor : kRowScalar;
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
  const View vb{strides[3], strides[5], strides[4]};  // b as (batch, n, k)
  // float4 stores where every row of every batch entry starts 16-byte aligned
  const bool vec_store = reinterpret_cast<uintptr_t>(c) % 16 == 0 && d.n % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mb = mode_of(b, vb);
  switch (mode_of(a, va)) {
    case kRowVec: return launch_b<kRowVec>(mb, a, b, c, d, va, vb, vec_store, s);
    case kKMajor: return launch_b<kKMajor>(mb, a, b, c, d, va, vb, vec_store, s);
    default: return launch_b<kRowScalar>(mb, a, b, c, d, va, vb, vec_store, s);
  }
}

}  // extern "C"
