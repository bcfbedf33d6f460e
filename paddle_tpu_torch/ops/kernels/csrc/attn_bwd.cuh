// The attention backward shared by the short (mha_short_bwd.cu) and flash
// (flash_bwd.cu) kernels: two passes over the saved forward, a dQ pass
// over query tiles and a dK / dV pass over key tiles.
//
// Function (paddle_tpu/ops/pallas/mha_short.py:149-177 _bwd_math and
// flash_attention.py:227-371 _bwd_dq_kernel / _bwd_dkv_kernel): per
// (query, key) pair, s = q.k * scale + bias[key], causal keys past
// q + (sk - sq) set to NEG_INF, p = exp(s - lse) with the forward's lse
// (the short forward clamped its row max, so a fully masked row gives
// p == 0), dp = dO.v, and with dropout the murmur keep mask of the
// forward: p_drop = keep ? p * scale_d : 0, dp = keep ? dp * scale_d : 0,
// where scale_d multiplies by 1/(1-rate) (short) or divides by 1-rate
// (flash, template DIV), as each Pallas kernel does. Then
// dV = sum_q (p_drop as dO's dtype) dO, dS = (p (dp - delta) scale as q's
// dtype), dQ = sum_k dS K and dK = sum_q dS Q, with
// delta = rowsum(dO * O) computed by the wrapper in plain torch, as the
// JAX package computes it outside its kernels.
//
// Why two passes: the TPU short kernel makes all three products in one
// pass because VMEM holds the whole [s, s] tile and dK / dV of the head.
// Here dK and dV at sk 512, d 128 in float are 512 KB, more than an SM's
// shared memory, and a sum across blocks would need atomics (and lose the
// fixed summation order). So the dQ pass gives each block 64 query rows
// and loops over key tiles, and the dK / dV pass gives each block 64 keys
// and loops over query tiles; each recomputes p, and every output element
// is summed by one thread in a fixed order.
//
// Both passes multiply on the FMA units from shared memory with the
// forward's tile micro-kernels (attn_common.cuh), no tensor cores. With a
// causal mask a pass skips the tiles whose pairs are all masked (their
// p == 0 exactly whenever the row keeps a live key).
#pragma once

#include "attn_common.cuh"

// Element strides of the b, s and h axes of q, k, v, dO, dQ, dK, dV; the
// d axis is contiguous.
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

// acc[i][j] += sum_{r < n} P[r][ty + 16 i] * V[r][tx + 16 j] for the
// columns tx + 16 j < d: the transposed product P^T V (dV and dK).
__device__ __forceinline__ void attn_ptv_tile(float acc[4][8], const float* ps, int ldp,
                                              const float* vs, int ld, int n, int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int r = 0; r < n; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ps[r * ldp + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        const float v = vs[r * ld + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
      }
    }
  }
}

template <bool DIV>
__device__ __forceinline__ float attn_drop_scale(float x, float drop_scale) {
  return DIV ? x / drop_scale : x * drop_scale;
}

// The score of one live (query, key) pair as the forward computed it.
__device__ __forceinline__ float attn_score(float qk, float sm_scale, const float* bias,
                                            int bi, int sk, int qi, int key, int offset,
                                            int causal) {
  float s = qk * sm_scale;
  if (bias != nullptr) s += bias[(long long)bi * sk + key];
  if (causal && qi + offset < key) s = ATTN_NEG_INF;
  return s;
}

template <typename T>
__device__ __forceinline__ void attn_store_rows(T* out, long long base, long long s_stride,
                                                int s0, int valid, float acc[4][8],
                                                int d) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = s0 + ty + 16 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) out[base + (long long)r * s_stride + col] = attn_from_float<T>(acc[i][j]);
    }
  }
}

// Pass 1: dQ for 64 query rows of one (batch, head).
template <typename T, bool DIV>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, AttnBwdStrides st,
                   int H, int sq, int sk, int d, float sm_scale, int causal, int dropout_on,
                   float drop_scale, uint32_t thresh, uint32_t seed) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = ATTN_TK + 1;
  float* q_s = smem;                  // [TQ][ld]
  float* do_s = q_s + ATTN_TQ * ld;   // [TQ][ld]
  float* k_s = do_s + ATTN_TQ * ld;   // [TK][ld]
  float* v_s = k_s + ATTN_TK * ld;    // [TK][ld]
  float* ds_s = v_s + ATTN_TK * ld;   // [TQ][ldp]
  float* lse_s = ds_s + ATTN_TQ * ldp;
  float* dl_s = lse_s + ATTN_TQ;

  const int q0 = blockIdx.x * ATTN_TQ;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offset = sk - sq;
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const long long row0 = (long long)bh * sq;

  attn_load_tile(q_s, ld, q, bi * st.qb + hi * st.qh, st.qs, q0, ATTN_TQ, sq, d);
  attn_load_tile(do_s, ld, dout, bi * st.ob + hi * st.oh, st.os, q0, ATTN_TQ, sq, d);
  for (int r = threadIdx.x; r < ATTN_TQ; r += blockDim.x) {
    const bool ok = q0 + r < sq;
    lse_s[r] = ok ? lse[row0 + q0 + r] : 0.f;
    dl_s[r] = ok ? delta[row0 + q0 + r] : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // causal: keys past the last row's limit are masked for every row
  const int k_end = causal ? min(sk, min(q0 + ATTN_TQ, sq) + offset) : sk;
  for (int k0 = 0; k0 < k_end; k0 += ATTN_TK) {
    __syncthreads();
    attn_load_tile(k_s, ld, k, bi * st.kb + hi * st.kh, st.ks, k0, ATTN_TK, sk, d);
    attn_load_tile(v_s, ld, v, bi * st.vb + hi * st.vh, st.vs, k0, ATTN_TK, sk, d);
    __syncthreads();
    float s4[4][4], dp4[4][4];
    attn_qk_tile(s4, q_s, k_s, ld, d);
    attn_qk_tile(dp4, do_s, v_s, ld, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qi = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float ds = 0.f;
        if (qi < sq && key < sk) {
          const float s = attn_score(s4[i][j], sm_scale, bias, bi, sk, qi, key, offset, causal);
          const float p = expf(s - lse_s[row]);
          float dp = dp4[i][j];
          if (dropout_on)
            dp = attn_dropout_keep(seed, bh, (uint32_t)qi, (uint32_t)key, thresh)
                     ? attn_drop_scale<DIV>(dp, drop_scale) : 0.f;
          ds = attn_round_like<T>(p * (dp - dl_s[row]) * sm_scale);
        }
        ds_s[row * ldp + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    attn_pv_tile(acc, ds_s, ldp, k_s, ld, min(ATTN_TK, sk - k0), d);
  }
  attn_store_rows(dq, bi * st.dqb + hi * st.dqh, st.dqs, q0, sq, acc, d);
}

// Pass 2: dK and dV for 64 keys of one (batch, head).
template <typename T, bool DIV>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, AttnBwdStrides st, int H, int sq, int sk, int d,
                    float sm_scale, int causal, int dropout_on, float drop_scale,
                    uint32_t thresh, uint32_t seed) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = ATTN_TK + 1;
  float* k_s = smem;                  // [TK][ld]
  float* v_s = k_s + ATTN_TK * ld;    // [TK][ld]
  float* q_s = v_s + ATTN_TK * ld;    // [TQ][ld]
  float* do_s = q_s + ATTN_TQ * ld;   // [TQ][ld]
  float* pd_s = do_s + ATTN_TQ * ld;  // [TQ][ldp] p_drop, query-major
  float* ds_s = pd_s + ATTN_TQ * ldp; // [TQ][ldp] dS, query-major
  float* lse_s = ds_s + ATTN_TQ * ldp;
  float* dl_s = lse_s + ATTN_TQ;

  const int k0 = blockIdx.x * ATTN_TK;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offset = sk - sq;
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const long long row0 = (long long)bh * sq;

  attn_load_tile(k_s, ld, k, bi * st.kb + hi * st.kh, st.ks, k0, ATTN_TK, sk, d);
  attn_load_tile(v_s, ld, v, bi * st.vb + hi * st.vh, st.vs, k0, ATTN_TK, sk, d);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows before the first one that sees key k0 are masked
  const int q_begin = causal ? max(0, k0 - offset) / ATTN_TQ * ATTN_TQ : 0;
  for (int q0 = q_begin; q0 < sq; q0 += ATTN_TQ) {
    __syncthreads();
    attn_load_tile(q_s, ld, q, bi * st.qb + hi * st.qh, st.qs, q0, ATTN_TQ, sq, d);
    attn_load_tile(do_s, ld, dout, bi * st.ob + hi * st.oh, st.os, q0, ATTN_TQ, sq, d);
    for (int r = threadIdx.x; r < ATTN_TQ; r += blockDim.x) {
      const bool ok = q0 + r < sq;
      lse_s[r] = ok ? lse[row0 + q0 + r] : 0.f;
      dl_s[r] = ok ? delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();
    float s4[4][4], dp4[4][4];
    attn_qk_tile(s4, q_s, k_s, ld, d);
    attn_qk_tile(dp4, do_s, v_s, ld, d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;  // query row of the tile
      const int qi = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;  // key of the block
        const int key = k0 + col;
        float pd = 0.f, ds = 0.f;
        if (qi < sq && key < sk) {
          const float s = attn_score(s4[i][j], sm_scale, bias, bi, sk, qi, key, offset, causal);
          const float p = expf(s - lse_s[row]);
          float dp = dp4[i][j];
          float p_drop = p;
          if (dropout_on) {
            const bool keep = attn_dropout_keep(seed, bh, (uint32_t)qi, (uint32_t)key, thresh);
            p_drop = keep ? attn_drop_scale<DIV>(p, drop_scale) : 0.f;
            dp = keep ? attn_drop_scale<DIV>(dp, drop_scale) : 0.f;
          }
          pd = attn_round_like<T>(p_drop);
          ds = attn_round_like<T>(p * (dp - dl_s[row]) * sm_scale);
        }
        pd_s[row * ldp + col] = pd;
        ds_s[row * ldp + col] = ds;
      }
    }
    __syncthreads();
    const int nq = min(ATTN_TQ, sq - q0);
    attn_ptv_tile(dv_acc, pd_s, ldp, do_s, ld, nq, d);
    attn_ptv_tile(dk_acc, ds_s, ldp, q_s, ld, nq, d);
  }
  attn_store_rows(dk, bi * st.dkb + hi * st.dkh, st.dks, k0, sk, dk_acc, d);
  attn_store_rows(dv, bi * st.dvb + hi * st.dvh, st.dvs, k0, sk, dv_acc, d);
}

template <typename T, bool DIV>
static int attn_bwd_launch_t(const void* q, const void* k, const void* v, const float* bias,
                             const void* dout, const float* lse, const float* delta,
                             void* dq, void* dk, void* dv, int B, int H, int sq, int sk,
                             int d, const AttnBwdStrides& st, float sm_scale, int causal,
                             int dropout_on, float drop_scale, uint32_t thresh,
                             uint32_t seed, cudaStream_t stream) {
  const size_t ld = d + 1, ldp = ATTN_TK + 1;
  const size_t smem_dq =
      sizeof(float) * ((2 * ATTN_TQ + 2 * ATTN_TK) * ld + ATTN_TQ * ldp + 2 * ATTN_TQ);
  const size_t smem_dkv =
      sizeof(float) * ((2 * ATTN_TQ + 2 * ATTN_TK) * ld + 2 * ATTN_TQ * ldp + 2 * ATTN_TQ);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DIV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, DIV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  dim3 grid_q((sq + ATTN_TQ - 1) / ATTN_TQ, H, B);
  attn_bwd_dq_kernel<T, DIV><<<grid_q, ATTN_THREADS, smem_dq, stream>>>(
      qt, kt, vt, bias, ot, lse, delta, static_cast<T*>(dq), st, H, sq, sk, d, sm_scale,
      causal, dropout_on, drop_scale, thresh, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((sk + ATTN_TK - 1) / ATTN_TK, H, B);
  attn_bwd_dkv_kernel<T, DIV><<<grid_k, ATTN_THREADS, smem_dkv, stream>>>(
      qt, kt, vt, bias, ot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), st, H,
      sq, sk, d, sm_scale, causal, dropout_on, drop_scale, thresh, seed);
  return (int)cudaGetLastError();
}

template <bool DIV>
static int attn_bwd_launch(const void* q, const void* k, const void* v, const float* bias,
                           const void* dout, const float* lse, const float* delta, void* dq,
                           void* dk, void* dv, int is_bf16, int B, int H, int sq, int sk,
                           int d, const long long* strides, float sm_scale, int causal,
                           int dropout_on, float drop_scale, unsigned int thresh,
                           unsigned int seed, void* stream) {
  const AttnBwdStrides st = attn_bwd_strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return attn_bwd_launch_t<__nv_bfloat16, DIV>(q, k, v, bias, dout, lse, delta, dq, dk,
                                                 dv, B, H, sq, sk, d, st, sm_scale, causal,
                                                 dropout_on, drop_scale, thresh, seed, s);
  return attn_bwd_launch_t<float, DIV>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, H,
                                       sq, sk, d, st, sm_scale, causal, dropout_on,
                                       drop_scale, thresh, seed, s);
}
