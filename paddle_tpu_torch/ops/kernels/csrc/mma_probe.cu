// A probe of mma_common.cuh's fragment layouts and TF32 rounding, built
// only by its tests (tests/test_torch_short_bwd_tc.py and
// test_torch_short_fwd_tc.py, `gpu` marker), not by the package: one warp
// multiplies 16 x 16 tiles through each loader pair, and the test holds
// the result against torch.matmul; mma_tf32_probe rounds n floats both
// ways.
#include <cuda_runtime.h>

#include "mma_common.cuh"

// One warp on 16 x 16 inputs a, b, b2 of T: mode 0 c = a b[:8]^T
// (load_a, load_b_nk), mode 1 c = a b[:, :8] (load_a_kn, load_b_kn),
// mode 2 c = (a b^T) b2[:, :8] with the first product's C fragments as A
// (a_from_c). c: [16][8] float.
template <typename T>
__global__ void mma_probe_kernel(const T* a, const T* b, const T* b2, float* c, int mode) {
  typedef MmaOps<T> M;
  constexpr int LD = 24;
  __shared__ __align__(16) T a_s[16 * LD], b_s[16 * LD], b2_s[16 * LD];
  for (int i = threadIdx.x; i < 256; i += 32) {
    a_s[(i / 16) * LD + i % 16] = a[i];
    b_s[(i / 16) * LD + i % 16] = b[i];
    b2_s[(i / 16) * LD + i % 16] = b2[i];
  }
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode == 2) {
    float c1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < 16; kk += M::K) {
      typename M::A x;
      M::load_a(x, a_s, LD, 0, kk);
      for (int j = 0; j < 2; ++j) {
        typename M::B y;
        M::load_b_nk(y, b_s, LD, 8 * j, kk);
        M::mma(c1[j], x, y);
      }
    }
    for (int kk = 0; kk < 16; kk += M::K) {
      typename M::A x;
      M::a_from_c(x, c1 + kk / 8);
      typename M::B y;
      M::load_b_kn(y, b2_s, LD, kk, 0);
      M::mma(acc, x, y);
    }
  } else {
    for (int kk = 0; kk < 16; kk += M::K) {
      typename M::A x;
      typename M::B y;
      if (mode == 0) {
        M::load_a(x, a_s, LD, 0, kk);
        M::load_b_nk(y, b_s, LD, 0, kk);
      } else {
        M::load_a_kn(x, a_s, LD, 0, kk);
        M::load_b_kn(y, b_s, LD, kk, 0);
      }
      M::mma(acc, x, y);
    }
  }
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  for (int e = 0; e < 4; ++e) c[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = acc[e];
}

// dtype: 0 float32, 1 bf16, 2 fp16
template <typename T>
static void mma_probe_launch(const void* a, const void* b, const void* b2, float* c, int mode,
                             cudaStream_t s) {
  mma_probe_kernel<T><<<1, 32, 0, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                       static_cast<const T*>(b2), c, mode);
}

extern "C" int mma_probe(const void* a, const void* b, const void* b2, float* c, int dtype,
                         int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    mma_probe_launch<__nv_bfloat16>(a, b, b2, c, mode, s);
  else if (dtype == 2)
    mma_probe_launch<__half>(a, b, b2, c, mode, s);
  else
    mma_probe_launch<float>(a, b, b2, c, mode, s);
  return (int)cudaGetLastError();
}

// out[2 i] = mma_tf32(x[i]) (integer operations), out[2 i + 1] =
// cvt.rna.tf32.f32 of x[i].
__global__ void mma_tf32_probe_kernel(const float* x, uint32_t* out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x[i]));
    out[2 * i] = mma_tf32(x[i]);
    out[2 * i + 1] = r;
  }
}

extern "C" int mma_tf32_probe(const float* x, uint32_t* out, int n, void* stream) {
  mma_tf32_probe_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return (int)cudaGetLastError();
}
