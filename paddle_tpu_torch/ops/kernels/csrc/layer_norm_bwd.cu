// LayerNorm backward in one launch: dx, dscale and dbias.
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py, the Pallas kernel _kernel
// (reached from ln_bwd), which the JAX package's layer_norm_grad calls,
// together with the [blocks, k] sum that finishes its dscale / dbias
// outside it.
//
// Function, per row i of x, dy [n, k] with the forward's mean[i] and
// rstd[i] = rsqrt(var[i] + eps): nrm = (x - mean) * rstd, dyg = dy * scale,
// m1 = mean(dyg), m2 = mean(dyg * nrm), dx = rstd * (dyg - m1 - nrm * m2);
// dscale = sum_rows dy * nrm and dbias = sum_rows dy, in fp32. With bf16 x
// the dscale terms are bf16(dy) * bf16(nrm), summed in fp32, as the JAX
// package's layer_norm_grad computes them for bf16 X
// (paddle_tpu/ops/nn_ops.py:598-605; the product of two bf16 is exact in
// fp32). fp16 x keeps the fp32 terms dy * nrm, as that lowering does for
// every X but bf16.
//
// What bounds it on the H100: x, dy and dx once each plus the row stats;
// about 11 operations an element, so the bytes (9.4 MB in fp32 at n 1024,
// k 768: 2.8 us at 3.35 TB/s). At the main path's shapes that is less than
// a wave of loads, so latency and launches bound it.
//
// Design: one cooperative launch (a grid-wide barrier) of blocks of W
// warps, the grid no larger than the card holds at once.
// - One warp a row: warp w of the grid's T = blocks x W takes rows w,
//   w + T, w + 2T, ... Lane l holds the vectors v = 32 j + l of V columns
//   (V = 16 bytes: 4 fp32 or 8 bf16 / fp16), so a row's loads are 16 bytes a lane.
// - Register path (16-byte aligned tensors, k % V == 0, k <= 1024): the
//   row's VPL vectors a lane are loaded into registers, all before their
//   first use, and the next row's loads are in flight during the current
//   row's math. The two row means come from xor-shuffle trees (every lane
//   gets the same bits). The lane's dscale / dbias partials stay in
//   registers over all the warp's rows.
// - General path (any other k up to the wrapper's limit, or tensors not
//   16-byte aligned, then V = 1): two passes over the row, the second
//   through L1 / L2; the partials in the warp's slice of shared memory.
// - Each block sums its warps' partials in warp order into its row of
//   part [blocks, 2k]. After the grid barrier, block b takes the 32-column
//   tiles b, b + blocks, ..., several at once when it has several: the S
//   warps of a tile sum every S-th part row in order, their loads in
//   flight together, and the S sums are added in warp order into out [2,
//   k] (dscale, then dbias).
// No atomics: every sum runs in an order fixed by (n, k) and the grid, so
// two launches on the same inputs give the same bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define LN_MAX_WARPS 8
#define LN_REG_MAX_K 1024  // the register path's widest row
#define LN_TILE 32         // columns of a tile of the column sums
#define LN_BATCH 16        // a warp's partial rows in flight in the column sums

template <typename T>
struct LnArgs {
  const T* x;
  const T* dy;
  const float* mean;
  const float* rstd;
  const float* scale;
  T* dx;
  float* part;  // [gridDim.x, 2k] the blocks' partial dscale, dbias
  float* out;   // [2, k] dscale, dbias
  int n;
  int k;
};

__device__ __forceinline__ float ln_to_float(float x) { return x; }
__device__ __forceinline__ float ln_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float ln_to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T ln_from_float(float x);
template <>
__device__ __forceinline__ float ln_from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 ln_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half ln_from_float<__half>(float x) {
  return __float2half_rn(x);
}

// 16 bytes of T: V elements, unpacked from and packed into four 32-bit
// words (element 2i of bf16 or fp16 is the low half of word i)
template <typename T>
struct LnVec;
template <>
struct LnVec<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& w, float (&f)[4]) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct LnVec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& w, float (&f)[8]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

template <>
struct LnVec<__half> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& w, float (&f)[8]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// one dscale term: dy * nrm in fp32; for bf16 x nrm rounded to bf16
// first (dy is bf16 already), the product exact in fp32. fp16 keeps the
// fp32 product, as the JAX package's layer_norm_grad does for any X but
// bf16 (nn_ops.py:597-607)
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

// V elements of T at p -> floats: one 16-byte load, or a scalar (V = 1)
template <typename T, int V>
__device__ __forceinline__ void ln_load(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = ln_to_float(p[0]);
  } else {
    LnVec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
}

// V scale values at p (16-byte aligned when V > 1)
template <int V>
__device__ __forceinline__ void ln_load_scale(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = s.x;
      f[4 * i + 1] = s.y;
      f[4 * i + 2] = s.z;
      f[4 * i + 3] = s.w;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void ln_store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = ln_from_float<T>(f[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = LnVec<T>::pack(f);
  }
}

// acc[0..V) = f (add = false) or += f, in 16-byte accesses when V > 1
template <int V>
__device__ __forceinline__ void ln_smem_acc(float* acc, const float (&f)[V], bool add) {
  if constexpr (V == 1) {
    acc[0] = add ? acc[0] + f[0] : f[0];
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      float4* p = reinterpret_cast<float4*>(acc) + i;
      float4 a = add ? *p : make_float4(0.f, 0.f, 0.f, 0.f);
      a.x += f[4 * i];
      a.y += f[4 * i + 1];
      a.z += f[4 * i + 2];
      a.w += f[4 * i + 3];
      *p = a;
    }
  }
}

// The block's warps' partials acc [W][2k] in shared memory -> part row of
// this block (warp order); the grid barrier; then the column sums over
// all blocks' rows into out. The block takes the 32-column tiles b, b + G,
// ..., P of them at once, S = W / P warps a tile (P the least power of two
// not below the block's count of tiles, at most W): warp sub of a tile sums the part
// rows sub, sub + S, ... in order, LN_BATCH loads in flight, and the S
// sums are added in order.
__device__ __forceinline__ void ln_finish(float* smem, int k, float* __restrict__ part,
                                          float* __restrict__ out) {
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k2 = 2 * k, G = gridDim.x;
  __syncthreads();
  for (int c = threadIdx.x; c < k2; c += blockDim.x) {
    float s = smem[c];
    for (int w = 1; w < W; ++w) s += smem[w * k2 + c];
    part[(size_t)blockIdx.x * k2 + c] = s;
  }
  cg::this_grid().sync();
  const int tiles = (k2 + LN_TILE - 1) / LN_TILE, per_block = (tiles + G - 1) / G;
  int P = 1;
  while (P < W && P < per_block) P *= 2;
  const int S = W / P, sub = warp % S;
  float* red = smem;  // [W][LN_TILE]
  for (int i = warp / S; i - warp / S < per_block; i += P) {
    const int c = (blockIdx.x + i * G) * LN_TILE + lane;
    float s = 0.f;
    if (c < k2) {
      const float* q = part + c;
      for (int g = sub; g < G; g += LN_BATCH * S) {
        float r[LN_BATCH];
#pragma unroll
        for (int u = 0; u < LN_BATCH; ++u)
          r[u] = g + u * S < G ? __ldcg(q + (size_t)(g + u * S) * k2) : 0.f;
#pragma unroll
        for (int u = 0; u < LN_BATCH; ++u) s += r[u];
      }
    }
    red[warp * LN_TILE + lane] = s;
    __syncthreads();
    if (sub == 0 && c < k2) {
      float tot = red[warp * LN_TILE + lane];
      for (int w = 1; w < S; ++w) tot += red[(warp + w) * LN_TILE + lane];
      out[c] = tot;
    }
    __syncthreads();
  }
}

// The register path: VPL vectors of V = 16 bytes a lane, k <= 32 VPL V.
template <typename T, int VPL>
__global__ void __launch_bounds__(LN_MAX_WARPS * 32)
layer_norm_bwd_reg_kernel(const LnArgs<T> a) {
  constexpr int V = LnVec<T>::V;
  extern __shared__ float smem[];
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stride = gridDim.x * W, n = a.n, k = a.k, nv = k / V;
  const uint4* x = reinterpret_cast<const uint4*>(a.x);
  const uint4* dy = reinterpret_cast<const uint4*>(a.dy);
  uint4* dx = reinterpret_cast<uint4*>(a.dx);

  float g[VPL][V], b[VPL][V];
#pragma unroll
  for (int j = 0; j < VPL; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) g[j][e] = b[j][e] = 0.f;

  uint4 xc[VPL], dc[VPL], xn[VPL], dn[VPL];
  float mu = 0.f, rs = 0.f, mun = 0.f, rsn = 0.f;
  int r = blockIdx.x * W + warp;
  if (r < n) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = j * 32 + lane;
      if (v < nv) {
        xc[j] = __ldg(x + (size_t)r * nv + v);
        dc[j] = __ldg(dy + (size_t)r * nv + v);
      }
    }
    mu = __ldg(a.mean + r);
    rs = __ldg(a.rstd + r);
  }
  while (r < n) {
    const int rn = r + stride;
    if (rn < n) {  // the next row's loads in flight during this row's math
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = j * 32 + lane;
        if (v < nv) {
          xn[j] = __ldg(x + (size_t)rn * nv + v);
          dn[j] = __ldg(dy + (size_t)rn * nv + v);
        }
      }
      mun = __ldg(a.mean + rn);
      rsn = __ldg(a.rstd + rn);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = j * 32 + lane;
      if (v < nv) {
        float xf[V], df[V], sc[V];
        LnVec<T>::unpack(xc[j], xf);
        LnVec<T>::unpack(dc[j], df);
        ln_load_scale<V>(a.scale + v * V, sc);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float nrm = (xf[e] - mu) * rs;
          const float dyg = df[e] * sc[e];
          s1 += dyg;
          s2 += dyg * nrm;
        }
      }
    }
    const float m1 = ln_warp_sum(s1) / (float)k;
    const float m2 = ln_warp_sum(s2) / (float)k;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = j * 32 + lane;
      if (v < nv) {
        float xf[V], df[V], sc[V], o[V];
        LnVec<T>::unpack(xc[j], xf);
        LnVec<T>::unpack(dc[j], df);
        ln_load_scale<V>(a.scale + v * V, sc);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float nrm = (xf[e] - mu) * rs;
          const float dyg = df[e] * sc[e];
          o[e] = rs * (dyg - m1 - nrm * m2);
          g[j][e] += ln_dscale_term<T>(df[e], nrm);
          b[j][e] += df[e];
        }
        dx[(size_t)r * nv + v] = LnVec<T>::pack(o);
      }
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      xc[j] = xn[j];
      dc[j] = dn[j];
    }
    mu = mun;
    rs = rsn;
    r = rn;
  }
  float* acc = smem + warp * 2 * k;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int v = j * 32 + lane;
    if (v < nv) {
      ln_smem_acc<V>(acc + v * V, g[j], false);
      ln_smem_acc<V>(acc + k + v * V, b[j], false);
    }
  }
  ln_finish(smem, k, a.part, a.out);
}

// The general path: any k the shared memory holds W x 2k floats for; V = 16
// bytes of T (16-byte aligned tensors, k % V == 0) or 1. Each pass over the
// row loads U of the lane's vectors before it uses them.
template <typename T, int V>
__global__ void __launch_bounds__(LN_MAX_WARPS * 32)
layer_norm_bwd_gen_kernel(const LnArgs<T> a) {
  constexpr int U = V == 1 ? 8 : 4;
  extern __shared__ float smem[];
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stride = gridDim.x * W, n = a.n, k = a.k, nv = k / V;
  float* acc = smem + warp * 2 * k;
  for (int c = lane; c < 2 * k; c += 32) acc[c] = 0.f;
  __syncwarp();
  for (int r = blockIdx.x * W + warp; r < n; r += stride) {
    const float mu = __ldg(a.mean + r), rs = __ldg(a.rstd + r);
    const T* xr = a.x + (size_t)r * k;
    const T* dr = a.dy + (size_t)r * k;
    T* dxr = a.dx + (size_t)r * k;
    float s1 = 0.f, s2 = 0.f;
    for (int v0 = lane; v0 < nv; v0 += 32 * U) {
      float xf[U][V], df[U][V], sc[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) {
          ln_load<T, V>(xr + v * V, xf[u]);
          ln_load<T, V>(dr + v * V, df[u]);
          ln_load_scale<V>(a.scale + v * V, sc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (v0 + 32 * u < nv) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float nrm = (xf[u][e] - mu) * rs;
            const float dyg = df[u][e] * sc[u][e];
            s1 += dyg;
            s2 += dyg * nrm;
          }
        }
      }
    }
    const float m1 = ln_warp_sum(s1) / (float)k;
    const float m2 = ln_warp_sum(s2) / (float)k;
    for (int v0 = lane; v0 < nv; v0 += 32 * U) {
      float xf[U][V], df[U][V], sc[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) {
          ln_load<T, V>(xr + v * V, xf[u]);
          ln_load<T, V>(dr + v * V, df[u]);
          ln_load_scale<V>(a.scale + v * V, sc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) {
          float o[V], t[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float nrm = (xf[u][e] - mu) * rs;
            const float dyg = df[u][e] * sc[u][e];
            o[e] = rs * (dyg - m1 - nrm * m2);
            t[e] = ln_dscale_term<T>(df[u][e], nrm);
          }
          ln_store<T, V>(dxr + v * V, o);
          ln_smem_acc<V>(acc + v * V, t, true);
          ln_smem_acc<V>(acc + k + v * V, df[u], true);
        }
      }
    }
  }
  ln_finish(smem, k, a.part, a.out);
}

// the register kernel for vpl, or nullptr past the register path's widest row
template <typename T, int VPL>
static const void* ln_reg_kernel(int vpl) {
  if constexpr (VPL * 32 * LnVec<T>::V > LN_REG_MAX_K) {
    return nullptr;
  } else {
    if (vpl == VPL) return (const void*)layer_norm_bwd_reg_kernel<T, VPL>;
    return ln_reg_kernel<T, VPL + 1>(vpl);
  }
}

// The kernel of a geometry (vec: 16-byte vectors; vpl: vectors a lane of
// the register path, 0 = the general path) with its dynamic shared
// memory, or nullptr if the geometry does not fit k.
template <typename T>
static const void* ln_kernel(int vec, int vpl, int warps, int k, size_t* smem) {
  constexpr int V = LnVec<T>::V;
  if (warps < 1 || warps > LN_MAX_WARPS || k < 1) return nullptr;
  if (vec && k % V != 0) return nullptr;
  *smem = sizeof(float) * (size_t)warps * (2 * (size_t)k > LN_TILE ? 2 * (size_t)k : LN_TILE);
  if (vpl == 0) {
    return vec ? (const void*)layer_norm_bwd_gen_kernel<T, V>
               : (const void*)layer_norm_bwd_gen_kernel<T, 1>;
  }
  if (!vec || (k / V + 31) / 32 != vpl) return nullptr;
  return ln_reg_kernel<T, 1>(vpl);
}

// dtype: 0 float32, 1 bf16, 2 fp16
static const void* ln_kernel_of(int dtype, int vec, int vpl, int warps, int k,
                                size_t* smem) {
  switch (dtype) {
    case 0:
      return ln_kernel<float>(vec, vpl, warps, k, smem);
    case 1:
      return ln_kernel<__nv_bfloat16>(vec, vpl, warps, k, smem);
    case 2:
      return ln_kernel<__half>(vec, vpl, warps, k, smem);
  }
  return nullptr;
}

template <typename T>
static cudaError_t ln_launch(const void* fn, const void* x, const void* dy, const float* mean,
                             const float* rstd, const float* scale, void* dx, float* part,
                             float* out, int n, int k, int blocks, int warps, size_t smem,
                             cudaStream_t s) {
  LnArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd, scale,
              static_cast<T*>(dx), part, out, n, k};
  void* args[] = {&a};
  // a cooperative launch through cudaLaunchKernelEx, which stream capture
  // records as a cooperative kernel node of a CUDA graph
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

// C entry points, bound with ctypes; each returns a cudaError_t (0 =
// success).
//
// layer_norm_bwd_max_blocks: *blocks = the most blocks of the geometry's
// kernel (dtype, vec, vpl, warps, k) the current device holds at once,
// the largest grid layer_norm_bwd may launch it with.
extern "C" int layer_norm_bwd_max_blocks(int dtype, int vec, int vpl, int warps, int k,
                                         int* blocks) {
  size_t smem = 0;
  const void* fn = ln_kernel_of(dtype, vec, vpl, warps, k, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// layer_norm_bwd: x, dy, dx [n, k] contiguous, float32, bf16 or fp16 (dtype
// 0, 1, 2);
// mean, rstd [n], scale [k] float32; part [blocks, 2k] float32 scratch; out
// [2, k] float32 (dscale, dbias). With vec every one of x, dy, dx and scale
// must be 16-byte aligned and k a multiple of 16 bytes of x's type. One
// cooperative launch of `blocks` blocks of `warps` warps on `stream`; a
// grid larger than the device holds at once is refused, never run.
extern "C" int layer_norm_bwd(const void* x, const void* dy, const float* mean,
                              const float* rstd, const float* scale, void* dx, float* part,
                              float* out, int dtype, int vec, int vpl, int warps, int n,
                              int k, int blocks, void* stream) {
  size_t smem = 0;
  const void* fn = ln_kernel_of(dtype, vec, vpl, warps, k, &smem);
  if (fn == nullptr || n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (vec && (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx | (uintptr_t)scale) & 15))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    err = ln_launch<__nv_bfloat16>(fn, x, dy, mean, rstd, scale, dx, part, out, n, k, blocks,
                                   warps, smem, s);
  else if (dtype == 2)
    err = ln_launch<__half>(fn, x, dy, mean, rstd, scale, dx, part, out, n, k, blocks, warps,
                            smem, s);
  else
    err = ln_launch<float>(fn, x, dy, mean, rstd, scale, dx, part, out, n, k, blocks, warps,
                           smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
