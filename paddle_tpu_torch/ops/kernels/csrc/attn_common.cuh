// Pieces shared by the attention kernels: the strides of the [b, s, h, d]
// views, the dropout hash, the float / bf16 conversions, the base-2
// constants of the flash kernels, and the tile loads and FMA
// micro-kernels of the short forward (mha_short_fwd.cu).
//
// The short forward keeps every operand in shared memory as float and
// multiplies with plain fp32 FMAs: fp32 inputs get full fp32 products (no
// TF32), and bf16 inputs, whose products are exact in fp32, get the same
// fp32 accumulation the TPU kernels ask of the MXU
// (preferred_element_type f32). The other kernels multiply on the tensor
// cores (mma_common.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ATTN_NEG_INF (-1e30f)  // the finite mask sentinel of the TPU kernels
#define ATTN_THREADS 256       // 16 x 16 threads, 8 warps
#define ATTN_TQ 64             // query rows per block
#define ATTN_TK 64             // keys per K / V tile
#define ATTN_MAX_D 128         // head dims the 4 x 8 output register tile covers

// The flash kernels' scores in base 2 (S log2(e), then exp2). The mask
// sentinel there is NEG_INF log2(e), so a row that sees no key gets
// m ln(2) = NEG_INF in its lse, as the plain version does.
#define FLASH_LOG2E 1.4426950408889634f
#define FLASH_LN2 0.6931471805599453f
#define FLASH_NEG_INF2 (ATTN_NEG_INF * FLASH_LOG2E)

// Element strides of the b, s and h axes of q, k, v and out; the d axis is
// contiguous (stride 1), which the Python wrappers check.
struct AttnStrides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float attn_to_float(float x) { return x; }
__device__ __forceinline__ float attn_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T attn_from_float(float x);
template <>
__device__ __forceinline__ float attn_from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 attn_from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// p is cast to v's dtype before P.V (mha_short.py:112,
// flash_attention.py:146-149): a no-op for fp32, a bf16 rounding for bf16.
template <typename T>
__device__ __forceinline__ float attn_round_like(float x) {
  return attn_to_float(attn_from_float<T>(x));
}

// Dropout keep-mask: the murmur-style hash of the global (batch*head,
// query, key) coordinates and the seed, bit for bit the hash of
// flash_attention._dropout_keep and mha_short._keep3. Keep iff
// h >= thresh, thresh = min(int(p * 2^32), 2^32 - 1).
__device__ __forceinline__ bool attn_dropout_keep(uint32_t seed, uint32_t bh,
                                                  uint32_t qi, uint32_t ki,
                                                  uint32_t thresh) {
  uint32_t h = (qi * 0x9E3779B1u) ^ (ki * 0x85EBCA6Bu) ^ (seed + bh * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= thresh;
}

// Rows [s0, s0 + rows) of one (b, h) slice into shared memory as float,
// row stride ld. Rows at or past `valid` are zero-filled.
template <typename T>
__device__ __forceinline__ void attn_load_tile(float* dst, int ld, const T* src,
                                               long long base, long long s_stride,
                                               int s0, int rows, int valid, int d) {
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    float x = 0.f;
    if (s0 + r < valid) x = attn_to_float(src[base + (long long)(s0 + r) * s_stride + c]);
    dst[r * ld + c] = x;
  }
}

// acc[i][j] = sum_c Q[ty + 16 i][c] * K[tx + 16 j][c] over a 64 x 64 tile.
// Rows of both tiles have stride ld = d + 1, so the 16 threads of a
// half-warp read 16 different banks of K and one broadcast word of Q.
__device__ __forceinline__ void attn_qk_tile(float acc[4][4], const float* qs,
                                             const float* ks, int ld, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < nk} P[ty + 16 i][k] * V[k][tx + 16 j] for the
// columns tx + 16 j < d. P has row stride ldp, V row stride ld.
__device__ __forceinline__ void attn_pv_tile(float acc[4][8], const float* ps, int ldp,
                                             const float* vs, int ld, int nk, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < nk; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * ldp + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        const float v = vs[k * ld + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float attn_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float attn_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

static inline AttnStrides attn_strides_from(const long long* s) {
  AttnStrides st;
  st.qb = s[0]; st.qs = s[1]; st.qh = s[2];
  st.kb = s[3]; st.ks = s[4]; st.kh = s[5];
  st.vb = s[6]; st.vs = s[7]; st.vh = s[8];
  st.ob = s[9]; st.os = s[10]; st.oh = s[11];
  return st;
}

// The backward kernels' element strides of the b, s and h axes of q, k,
// v, dO, dQ, dK, dV; the d axis is contiguous.
struct AttnBwdStrides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
  long long dqb, dqs, dqh, dkb, dks, dkh, dvb, dvs, dvh;
};

static inline AttnBwdStrides attn_bwd_strides_from(const long long* s) {
  AttnBwdStrides st;
  st.qb = s[0]; st.qs = s[1]; st.qh = s[2];
  st.kb = s[3]; st.ks = s[4]; st.kh = s[5];
  st.vb = s[6]; st.vs = s[7]; st.vh = s[8];
  st.ob = s[9]; st.os = s[10]; st.oh = s[11];
  st.dqb = s[12]; st.dqs = s[13]; st.dqh = s[14];
  st.dkb = s[15]; st.dks = s[16]; st.dkh = s[17];
  st.dvb = s[18]; st.dvs = s[19]; st.dvh = s[20];
  return st;
}
