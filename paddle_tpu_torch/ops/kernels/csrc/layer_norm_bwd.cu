// LayerNorm backward: dx and per-row-block partial dscale / dbias.
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py, the Pallas kernel _kernel
// (reached from ln_bwd), which the JAX package's layer_norm_grad calls.
//
// Function, per row i of x, dy [n, k] with the forward's mean[i] and
// rstd[i] = rsqrt(var[i] + eps): nrm = (x - mean) * rstd, dyg = dy * scale,
// m1 = mean(dyg), m2 = mean(dyg * nrm), dx = rstd * (dyg - m1 - nrm * m2).
// Per block of R rows: dscale_part = sum_rows dy * nrm and
// dbias_part = sum_rows dy; the wrapper sums the [n / R, k] partials with
// torch.sum, as ln_bwd sums the Pallas kernel's per-block rows outside it.
// With bf16 x the dscale terms are bf16(dy) * bf16(nrm), summed in fp32,
// as the JAX package's layer_norm_grad computes them for bf16 X
// (paddle_tpu/ops/nn_ops.py:598-605; XLA keeps the product of the two
// bf16 factors in fp32, where it is exact).
//
// What bounds it on the H100: x, dy and dx once each plus the row stats;
// about 7 operations per element, so at n 1024, k 768 (9.4 MB in fp32,
// 2.8 us at 3.35 TB/s) the bytes bound it.
//
// Design: one block of 256 threads per R rows, R chosen by the wrapper
// from k so that the block's x and dy rows fit shared memory (as float).
// x and dy are read from device memory once, into shared memory; one warp
// per row takes the two row means with shuffles and writes dx, leaving the
// normalized value in place of x; then each thread sums its columns over
// the block's rows in row order. No atomics: the column sums run in a fixed
// order and the result is the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LN_THREADS 256

__device__ __forceinline__ float ln_to_float(float x) { return x; }
__device__ __forceinline__ float ln_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T ln_from_float(float x);
template <>
__device__ __forceinline__ float ln_from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 ln_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one dscale term: dy * nrm in fp32; for bf16 x nrm rounded to bf16
// first (dy is bf16 already), the product exact in fp32
template <typename T>
__device__ __forceinline__ float ln_dscale_term(float d, float nrm) {
  return d * nrm;
}
template <>
__device__ __forceinline__ float ln_dscale_term<__nv_bfloat16>(float d, float nrm) {
  return __fmul_rn(d, __bfloat162float(__float2bfloat16(nrm)));
}

__device__ __forceinline__ float ln_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      float* __restrict__ dg_part, float* __restrict__ db_part, int n,
                      int k, int rows) {
  extern __shared__ float smem[];
  float* xs = smem;               // [rows][k] x, then the normalized value
  float* dys = xs + rows * k;     // [rows][k] dy
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const long long base = (long long)r0 * k;

  for (int idx = threadIdx.x; idx < nr * k; idx += blockDim.x) {
    xs[idx] = ln_to_float(x[base + idx]);
    dys[idx] = ln_to_float(dy[base + idx]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nr; r += LN_THREADS / 32) {
    const float mu = mean[r0 + r], rs = rstd[r0 + r];
    float* xr = xs + r * k;
    const float* dr = dys + r * k;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < k; c += 32) {
      const float nrm = (xr[c] - mu) * rs;
      const float dyg = dr[c] * scale[c];
      s1 += dyg;
      s2 += dyg * nrm;
      xr[c] = nrm;
    }
    const float m1 = ln_warp_sum(s1) / (float)k;
    const float m2 = ln_warp_sum(s2) / (float)k;
    for (int c = lane; c < k; c += 32) {
      const float dyg = dr[c] * scale[c];
      dx[base + (long long)r * k + c] = ln_from_float<T>(rs * (dyg - m1 - xr[c] * m2));
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int r = 0; r < nr; ++r) {
      const float d = dys[r * k + c];
      g += ln_dscale_term<T>(d, xs[r * k + c]);
      b += d;
    }
    dg_part[(long long)blockIdx.x * k + c] = g;
    db_part[(long long)blockIdx.x * k + c] = b;
  }
}

template <typename T>
static int launch(const void* x, const void* dy, const float* mean, const float* rstd,
                  const float* scale, void* dx, float* dg_part, float* db_part, int n,
                  int k, int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)rows * k;
  cudaError_t err = cudaFuncSetAttribute(layer_norm_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + rows - 1) / rows;
  layer_norm_bwd_kernel<T><<<blocks, LN_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd, scale,
      static_cast<T*>(dx), dg_part, db_part, n, k, rows);
  return (int)cudaGetLastError();
}

// C entry point, bound with ctypes. x, dy, dx: [n, k] contiguous, float32
// or bf16 (is_bf16); mean, rstd: [n] float32; scale: [k] float32;
// dg_part, db_part: [ceil(n / rows), k] float32. Returns the cudaError_t
// of the launch (0 = success).
extern "C" int layer_norm_bwd(const void* x, const void* dy, const float* mean,
                              const float* rstd, const float* scale, void* dx,
                              float* dg_part, float* db_part, int is_bf16, int n, int k,
                              int rows, void* stream) {
  if (n < 1 || k < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dy, mean, rstd, scale, dx, dg_part, db_part, n, k,
                                 rows, s);
  return launch<float>(x, dy, mean, rstd, scale, dx, dg_part, db_part, n, k, rows, s);
}
