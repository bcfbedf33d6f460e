// ResNet fused-block 1x1 convolutions: a matrix product with a fused
// batch-norm-apply prologue, and a matrix product with the next batch
// norm's per-channel sums in its epilogue.
//
// Replaces: tools/fused_block_pallas.py, the Pallas kernels _prologue_kernel
// (reached from fused_prologue_conv1x1) and _stats_kernel (reached from
// conv1x1_with_stats), the two halves of the JAX package's fused-block A/B.
//
// Function. Prologue: z = relu(x * scale + shift + res), each operation
// rounded in fp32 as the Pallas body computes it, then z rounded to x's
// type; y = z @ w accumulated in fp32 and stored in x's type. Stats: y =
// x @ w accumulated in fp32 and stored in x's type, and per column
// sum(y) and sum(y * y) taken from the fp32 accumulator before the cast.
// x, res [M, K]; scale, shift [K] fp32; w [K, N]; y [M, N]; float32 or
// bf16.
//
// What bounds it on the H100: at the ResNet-50 b256 bottleneck shapes
// (M 802816 / 200704 / 50176, K 256 / 512 / 1024, N 64 / 128 / 256) each
// product is 26.3 GFLOP (0.027 ms at the bf16 tensor-core rate) against
// 0.26-0.92 GB of bytes (0.08-0.28 ms at 3.35 TB/s): the bytes bound it.
//
// Design, simple first: one block of 256 threads per 128 x 64 tile of y.
// The block walks K in steps of 32: it stages the [128, 32] slice of the
// prologue's z (or of x) and the [32, 64] slice of w in shared memory as
// float, and each thread accumulates an 8 x 4 register tile with FMAs
// (no tensor cores yet: wgmma and TMA are the next step). Rows past M and
// columns past N are masked, so any M works where Pallas needs a multiple
// of its 512-row block. The Pallas grid adds each block's column sums to
// one accumulator in grid order; blocks here run in no order, so each
// writes its own partial row and a second launch sums the partials of
// each column in a fixed order: no atomics, the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FB_BM 128
#define FB_BN 64
#define FB_BK 32
#define FB_TM 8
#define FB_TN 4
#define FB_THREADS 256
#define FB_RED_THREADS 256

__device__ __forceinline__ float fb_to_float(float x) { return x; }
__device__ __forceinline__ float fb_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T fb_from_float(float x);
template <>
__device__ __forceinline__ float fb_from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 fb_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(FB_THREADS)
fused_block_gemm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift, const T* __restrict__ res,
                        const T* __restrict__ w, T* __restrict__ y,
                        float* __restrict__ part_sum, float* __restrict__ part_sumsq,
                        int M, int K, int N) {
  // As[k][m]: the A slice transposed, so a thread reads its 8 rows as two
  // float4; the row pitch keeps those reads 16-byte aligned
  __shared__ __align__(16) float As[FB_BK][FB_BM + 4];
  __shared__ __align__(16) float Ws[FB_BK][FB_BN];
  const int tid = threadIdx.x;
  const int tx = tid % (FB_BN / FB_TN);  // columns tx * 4 .. + 4
  const int ty = tid / (FB_BN / FB_TN);  // rows ty * 8 .. + 8
  const int m0 = blockIdx.x * FB_BM;
  const int n0 = blockIdx.y * FB_BN;
  float acc[FB_TM][FB_TN];
#pragma unroll
  for (int i = 0; i < FB_TM; ++i)
#pragma unroll
    for (int j = 0; j < FB_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FB_BK) {
    // A: each thread one column (k) of 16 rows; a warp reads 32
    // consecutive k of one row
    const int c = tid % FB_BK;
    const int k = k0 + c;
    float sc = 0.f, sh = 0.f;
    if (PROLOGUE && k < K) {
      sc = scale[k];
      sh = shift[k];
    }
#pragma unroll 4
    for (int i = 0; i < FB_BM / (FB_THREADS / FB_BK); ++i) {
      const int r = tid / FB_BK + (FB_THREADS / FB_BK) * i;
      const int m = m0 + r;
      float v = 0.f;
      if (m < M && k < K) {
        const long long off = (long long)m * K + k;
        v = fb_to_float(x[off]);
        if (PROLOGUE) {
          // the body's order, each step rounded in fp32 (no FMA
          // contraction), then z.astype(x.dtype) before the product
          float z = __fadd_rn(__fmul_rn(v, sc), sh);
          z = fmaxf(__fadd_rn(z, fb_to_float(res[off])), 0.f);
          v = fb_to_float(fb_from_float<T>(z));
        }
      }
      As[c][r] = v;
    }
    // w: each thread one column (n) of 8 rows (k)
#pragma unroll
    for (int j = 0; j < FB_BK / (FB_THREADS / FB_BN); ++j) {
      const int r = tid / FB_BN + (FB_THREADS / FB_BN) * j;
      const int cn = tid % FB_BN;
      const int kk = k0 + r, n = n0 + cn;
      Ws[r][cn] = (kk < K && n < N) ? fb_to_float(w[(long long)kk * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FB_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * FB_TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * FB_TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * FB_TN]);
      const float a[FB_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[FB_TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < FB_TM; ++i)
#pragma unroll
        for (int j = 0; j < FB_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FB_TM; ++i) {
    const int m = m0 + ty * FB_TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < FB_TN; ++j) {
      const int n = n0 + tx * FB_TN + j;
      if (n < N) y[(long long)m * N + n] = fb_from_float<T>(acc[i][j]);
    }
  }

  if (STATS) {
    // column sums of this thread's valid rows, from the fp32 accumulator
    float s[FB_TN], q[FB_TN];
#pragma unroll
    for (int j = 0; j < FB_TN; ++j) s[j] = q[j] = 0.f;
#pragma unroll
    for (int i = 0; i < FB_TM; ++i) {
      if (m0 + ty * FB_TM + i >= M) continue;
#pragma unroll
      for (int j = 0; j < FB_TN; ++j) {
        s[j] += acc[i][j];
        q[j] += acc[i][j] * acc[i][j];
      }
    }
    // then the 16 row groups of each column, in row-group order (the
    // K loop ended with a barrier, so As is free to reuse)
    const int groups = FB_THREADS / (FB_BN / FB_TN);
    float* red_s = &As[0][0];
    float* red_q = red_s + groups * FB_BN;
#pragma unroll
    for (int j = 0; j < FB_TN; ++j) {
      red_s[ty * FB_BN + tx * FB_TN + j] = s[j];
      red_q[ty * FB_BN + tx * FB_TN + j] = q[j];
    }
    __syncthreads();
    if (tid < FB_BN && n0 + tid < N) {
      float ts = 0.f, tq = 0.f;
      for (int g = 0; g < groups; ++g) {
        ts += red_s[g * FB_BN + tid];
        tq += red_q[g * FB_BN + tid];
      }
      part_sum[(long long)blockIdx.x * N + n0 + tid] = ts;
      part_sumsq[(long long)blockIdx.x * N + n0 + tid] = tq;
    }
  }
}

// sum[n] and sumsq[n] over the [parts, N] partial rows: one block per
// column; thread t sums rows t, t + 256, ... in order, then a fixed tree
__global__ void __launch_bounds__(FB_RED_THREADS)
fused_block_stats_reduce_kernel(const float* __restrict__ part_sum,
                                const float* __restrict__ part_sumsq, int parts, int N,
                                float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float ss[FB_RED_THREADS], sq[FB_RED_THREADS];
  const int n = blockIdx.x, tid = threadIdx.x;
  float a = 0.f, b = 0.f;
  for (int i = tid; i < parts; i += FB_RED_THREADS) {
    a += part_sum[(long long)i * N + n];
    b += part_sumsq[(long long)i * N + n];
  }
  ss[tid] = a;
  sq[tid] = b;
  __syncthreads();
  for (int s = FB_RED_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      ss[tid] += ss[tid + s];
      sq[tid] += sq[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    sum[n] = ss[0];
    sumsq[n] = sq[0];
  }
}

template <typename T, bool PROLOGUE, bool STATS>
static int launch_gemm(const void* x, const float* scale, const float* shift, const void* res,
                       const void* w, void* y, float* part_sum, float* part_sumsq, int M,
                       int K, int N, cudaStream_t stream) {
  const dim3 grid((M + FB_BM - 1) / FB_BM, (N + FB_BN - 1) / FB_BN);
  fused_block_gemm_kernel<T, PROLOGUE, STATS><<<grid, FB_THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<T*>(y), part_sum, part_sumsq, M, K, N);
  return (int)cudaGetLastError();
}

// C entry points, bound with ctypes; each returns the cudaError_t of its
// launches (0 = success). All tensors contiguous; x, res, w, y of one type
// (is_bf16), scale, shift and the sums float32.

// y [M, N] = (relu(x * scale + shift + res) rounded to x's type) @ w
extern "C" int fused_prologue_conv1x1(const void* x, const float* scale, const float* shift,
                                      const void* res, const void* w, void* y, int is_bf16,
                                      int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_gemm<__nv_bfloat16, true, false>(x, scale, shift, res, w, y, nullptr,
                                                   nullptr, M, K, N, s);
  return launch_gemm<float, true, false>(x, scale, shift, res, w, y, nullptr, nullptr, M, K,
                                         N, s);
}

// y [M, N] = x @ w; sum, sumsq [N] over the rows of the fp32 product;
// part_sum, part_sumsq: [ceil(M / 128), N] scratch
extern "C" int conv1x1_with_stats(const void* x, const void* w, void* y, float* part_sum,
                                  float* part_sumsq, float* sum, float* sumsq, int is_bf16,
                                  int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = is_bf16 ? launch_gemm<__nv_bfloat16, false, true>(x, nullptr, nullptr, nullptr, w,
                                                              y, part_sum, part_sumsq, M, K,
                                                              N, s)
                    : launch_gemm<float, false, true>(x, nullptr, nullptr, nullptr, w, y,
                                                      part_sum, part_sumsq, M, K, N, s);
  if (err != 0) return err;
  const int parts = (M + FB_BM - 1) / FB_BM;
  fused_block_stats_reduce_kernel<<<N, FB_RED_THREADS, 0, s>>>(part_sum, part_sumsq, parts, N,
                                                               sum, sumsq);
  return (int)cudaGetLastError();
}

// rows of y per block: the wrapper sizes the partial-sum scratch with it
extern "C" int fused_block_rows_per_block() { return FB_BM; }
