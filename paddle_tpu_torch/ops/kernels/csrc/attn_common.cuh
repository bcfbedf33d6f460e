// Pieces shared by the attention kernels: the strides of the [b, s, h, d]
// views, the dropout hash, the float / bf16 conversions and the base-2
// constants of the tensor-core kernels (which multiply through
// mma_common.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ATTN_NEG_INF (-1e30f)  // the finite mask sentinel of the TPU kernels
#define ATTN_MAX_D 128         // head dims the kernels take (padded to 64 or 128)

// The forward kernels' scores in base 2 (S log2(e), then exp2). The mask
// sentinel there is NEG_INF log2(e), so a flash row that sees no key gets
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
__device__ __forceinline__ float attn_to_float(__half x) { return __half2float(x); }

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
// round to nearest even, past 65504 to inf, as astype(float16)
template <>
__device__ __forceinline__ __half attn_from_float<__half>(float x) {
  return __float2half_rn(x);
}

// p is cast to v's dtype before P.V (mha_short.py:112,
// flash_attention.py:146-149): a no-op for fp32, a rounding for bf16 and fp16.
template <typename T>
__device__ __forceinline__ float attn_round_like(float x) {
  return attn_to_float(attn_from_float<T>(x));
}

// Dropout keep-mask: the murmur-style hash of the global (batch*head,
// query, key) coordinates and the seed, bit for bit the hash of
// flash_attention._dropout_keep and mha_short._keep3. Keep iff
// h >= thresh, thresh = min(int(p * 2^32), 2^32 - 1). `bh` is the global
// (batch, head) index, AttnSeed::global_bh.
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

// The dropout seed of a launch: the word `value`, or, when `ptr` is not
// NULL, the word at `ptr` in device memory, which each kernel reads once
// (the TPU kernels' seed_ref). A CUDA graph holds the pointer, so each
// replay draws the word written there before it. A launch over heads
// [head0, head0 + H) of `heads_global` (a tensor-parallel rank's chunk)
// hashes the global (batch, head) index of its local (bi, hi):
// bi * heads_global + head0 + hi, which is (bh / H) * heads_global + head0
// + bh % H of the local bh = bi * H + hi; with head0 = 0 and
// heads_global = H it is bh.
struct AttnSeed {
  uint32_t value;
  const uint32_t* ptr;
  int heads_global;
  int head0;
  __device__ __forceinline__ uint32_t get() const { return ptr != nullptr ? __ldg(ptr) : value; }
  __device__ __forceinline__ uint32_t global_bh(int bi, int hi) const {
    return (uint32_t)(bi * heads_global + head0 + hi);
  }
};

// Whether a launch's head chunk lies inside its global heads.
static inline bool attn_heads_ok(int H, int heads_global, int head0) {
  return head0 >= 0 && heads_global >= H && head0 + H <= heads_global;
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

// The dtype codes of the C entry points: 0 float32, 1 bf16, 2 fp16. Each
// entry point runs its kernel for the code's type and refuses any other
// code.
#define ATTN_F32 0
#define ATTN_BF16 1
#define ATTN_F16 2

static inline long long attn_elem_size(int dtype) { return dtype == ATTN_F32 ? 4 : 2; }
