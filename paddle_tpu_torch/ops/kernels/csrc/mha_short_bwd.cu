// Short-sequence attention backward (sq, sk <= 512) on the tensor cores:
// dQ, dK and dV from the saved lse and delta.
//
// Replaces: paddle_tpu/ops/pallas/mha_short.py, the Pallas kernels
// _bwd_kernel_bshd / _bwd_bshd_nobias (bshd, reached from
// _short_core_bshd_bwd) and _bwd_kernel / _bwd_nobias (head-major, from
// _short_core_bwd), which share _bwd_math. One kernel pair serves both
// layouts through the strides it is given.
//
// Function: _bwd_math (mha_short.py:149-177). Per (query, key) pair
// s = q.k * scale + bias[key], causal keys past q + (sk - sq) set to
// NEG_INF, p = exp(s - lse) from the forward's clamped lse (a fully
// masked row gives 0), dp = dO.v; with dropout the forward's murmur keep
// mask of the global (batch*head, query, key) coordinates, kept values
// scaled by p * (1 / (1 - rate)). Then dV = sum_q (p_drop as dO's
// dtype) dO, dS = (p (dp - delta) scale as q's dtype), dQ = sum_k dS K,
// dK = sum_q dS Q; delta = rowsum(dO * O) comes from the wrapper.
//
// What bounds it on the H100: at BERT's training shape (b 8, h 12,
// s 128, d 64) the function is 10 sq sk d operations per head, 1.007
// GFLOP, against seven [8, 128, 12, 64] tensors (q, k, v, dO, dQ, dK,
// dV) of 786,432 elements: 22 MB in fp32, 11 MB in bf16, 6.6 us and
// 3.3 us at 3.35 TB/s. On the fp32 FMA units that is 15.0 us of
// operations; on the tensor cores 3xTF32 makes three TF32 products of
// each fp32 one, 3 x 1.007 GFLOP at 495 TFLOP/s = 6.1 us, under the 6.6
// us of bytes (bf16: 1.0 us of operations, 3.3 us of bytes).
//
// Design:
// - fp16 takes the bf16 path: m16n8k16 on f16 inputs (the same fragments),
//   fp32 sums, p_drop and dS rounded to fp16 where bf16 rounds them; a dS
//   past fp16's 65504 (a large loss scale) becomes inf, as the Pallas
//   kernel's astype(float16) gives it, and the step's finite check skips it.
// - All five products run on the tensor cores with warp-level mma.sync
//   (mma_common.cuh): bf16 as m16n8k16 with fp32 accumulation (bf16
//   products are exact in fp32); fp32 as 3xTF32 on m16n8k8, x = hi + lo
//   with hi = tf32(x), lo = tf32(x - hi) and hi*hi + hi*lo + lo*hi
//   accumulated in fp32, which keeps each product to ~2^-22 of its size
//   (single-pass TF32 keeps ~2^-11 and is not used).
// - One pass over the scores. Launch 1 gives each block BK keys of one
//   (batch, head), K and V resident in shared memory, and walks the
//   query tiles in order, each tile of Q, dO, lse and delta copied in by
//   cp.async. Warp (kw, qh) owns 16 keys and one half of each tile's
//   query rows: it computes S^T = K Q^T and dP^T = V dO^T, then p, the
//   keep mask and dS once per pair in registers, feeds them as A
//   fragments straight into dV += P_drop^T dO and dK += dS^T Q, and
//   writes dS (already rounded to q's dtype, so exactly) to a scratch
//   [b, h, sq, skp] the wrapper allocates (6.3 MB in fp32 at BERT's
//   shape, which L2 holds). At the end the second half's dK / dV go
//   through shared memory and are added to the first half's. Launch 2
//   gives each block 64 query rows (8 warps: 4 row groups x 2 halves of
//   d) and sums dQ = dS K over the key tiles in order, double-buffered.
//   Every output element is summed in one fixed order: no atomics, and
//   two launches (and the two key tiles) agree bit for bit. 10 sq sk d
//   operations (the two-pass FMA kernel made 14), exp and the hash once
//   per pair.
// - Filling the card: at BERT's shape launch 1 has only 96 x 128 keys,
//   768 warps of 16 keys. Splitting each tile's queries over two warps
//   doubles that, and 32-key blocks (4 warps, 168 registers, 53 KB of
//   shared memory in fp32) run 3 to an SM, so the 384 blocks fit one
//   wave. A second query stage would cost that third block, so tiles are
//   copied in one stage and the other blocks on the SM hide the copy.
//   64-key blocks (8 warps, 1 block an SM by registers) need two waves
//   there and measured slower, so BK is 32.
// - Edges: d is padded with zeros in shared memory to DP in {16, 32, 64,
//   128}; ragged query rows and keys are masked. A copy of 16 bytes runs
//   where the rows and bases are 16-byte aligned, a scalar copy inside
//   the kernel otherwise. At d > 64, 32-row query tiles keep the
//   accumulators in registers (fp32: 236 registers, no spills).
//   A causal mask skips the query tiles whose pairs are all masked;
//   launch 2 zeroes the scratch entries launch 1 skipped.
#include "attn_common.cuh"  // AttnBwdStrides
#include "mma_common.cuh"

template <typename T, int DP>
struct ShortBwdTile {
  static constexpr int BQ = DP <= 64 ? 64 : 32;      // query rows per tile (launch 1)
  static constexpr int LD = DP + 16 / (int)sizeof(T);  // row stride: 16-byte pad
};

// Launch 1: dK, dV and the dS scratch for BK keys of one (batch, head).
// Warps: BK / 16 key groups x 2 query halves; warp (kw, qh) owns keys
// kw * 16.. and query rows qh * BQ / 2.. of every tile, and the two
// halves' dK / dV are added at the end in a fixed order.
template <typename T, int DP>
struct ShortBwdDkv {
  static constexpr int BK = 32;  // keys per block
  static constexpr int NT = BK * 4;
  static constexpr int BQ = ShortBwdTile<T, DP>::BQ, LD = ShortBwdTile<T, DP>::LD;
  // K, V, one Q and dO tile, lse and delta; the halves' reduction reuses it
  static constexpr size_t TILES = sizeof(T) * (2 * BK + 2 * BQ) * LD + sizeof(float) * 2 * BQ;
  static constexpr size_t RED = sizeof(float) * 2 * BK * DP;
  static constexpr size_t SMEM = TILES > RED ? TILES : RED;
  // three blocks an SM where registers allow: the BERT-shape grid in one wave
  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 1;
};

template <typename T, int DP>
__global__ void __launch_bounds__(ShortBwdDkv<T, DP>::NT, ShortBwdDkv<T, DP>::MIN_BLOCKS)
short_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, T* __restrict__ ds_out, AttnBwdStrides st, int H,
                     int sq, int sk, int skp, int d, float sm_scale, int causal,
                     int dropout_on, float drop_scale, uint32_t thresh, AttnSeed seed_in,
                     int vec) {
  typedef MmaOps<T> M;
  const uint32_t seed = dropout_on ? seed_in.get() : 0u;
  typedef ShortBwdDkv<T, DP> P;
  constexpr int BK = P::BK, NT = P::NT, BQ = P::BQ, LD = P::LD;
  constexpr int BQH = BQ / 2, NQ = BQH / 8, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* v_s = k_s + BK * LD;                   // [BK][LD]
  T* q_s = v_s + BK * LD;                   // [BQ][LD]
  T* do_s = q_s + BQ * LD;                  // [BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);  // [BQ]
  float* dl_s = lse_s + BQ;                                 // [BQ]

  const int k0 = blockIdx.x * BK;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % (BK / 16), qh = warp / (BK / 16);
  const int wk = kw * 16;   // this warp's keys in the tile
  const int wq = qh * BQH;  // and query rows
  const int offset = sk - sq;
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const uint32_t gbh = seed_in.global_bh(bi, hi);
  const long long row0 = (long long)bh * sq;
  const long long qbase = bi * st.qb + hi * st.qh, obase = bi * st.ob + hi * st.oh;

  mma_load_rows<T, BK, DP, LD, NT>(k_s, k, bi * st.kb + hi * st.kh, st.ks, k0, sk, d, vec);
  mma_load_rows<T, BK, DP, LD, NT>(v_s, v, bi * st.vb + hi * st.vh, st.vs, k0, sk, d, vec);
  cp_async_commit();

  // this thread's two keys (rows g and g + 8 of the warp's C fragments)
  int key[2];
  float kbias[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    key[h2] = k0 + wk + g + 8 * h2;
    kbias[h2] = (bias != nullptr && key[h2] < sk) ? bias[(long long)bi * sk + key[h2]] : 0.f;
  }

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // causal: query rows before the first one that sees key k0 are masked
  const int q_begin = causal ? max(0, k0 - offset) / BQ * BQ : 0;
  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    // one stage: the other blocks on the SM overlap this one's copies
    mma_load_rows<T, BQ, DP, LD, NT>(q_s, q, qbase, st.qs, q0, sq, d, vec);
    mma_load_rows<T, BQ, DP, LD, NT>(do_s, dout, obase, st.os, q0, sq, d, vec);
    cp_async_commit();
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < sq;
      lse_s[r] = ok ? lse[row0 + q0 + r] : 0.f;
      dl_s[r] = ok ? delta[row0 + q0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQH queries
    float s_acc[NQ][4], p_acc[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = p_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += M::K) {
      typename M::A ak, av;
      M::load_a(ak, k_s, LD, wk, kk);
      M::load_a(av, v_s, LD, wk, kk);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        typename M::B b;
        M::load_b_nk(b, q_s, LD, wq + 8 * j, kk);
        M::mma(s_acc[j], ak, b);
        M::load_b_nk(b, do_s, LD, wq + 8 * j, kk);
        M::mma(p_acc[j], av, b);
      }
    }

    // p, the keep mask and dS once per pair; s_acc becomes p_drop, p_acc dS
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1;
        const int ql = wq + 8 * j + 2 * t + (e & 1);
        const int qi = q0 + ql;
        const int ki = key[h2];
        float pd = 0.f, ds = 0.f;
        if (qi < sq && ki < sk) {
          float s = s_acc[j][e] * sm_scale + kbias[h2];
          if (causal && qi + offset < ki) s = ATTN_NEG_INF;
          const float p = expf(s - lse_s[ql]);
          float dp = p_acc[j][e];
          float p_drop = p;
          if (dropout_on) {
            const bool keep = attn_dropout_keep(seed, gbh, (uint32_t)qi, (uint32_t)ki, thresh);
            p_drop = keep ? p * drop_scale : 0.f;
            dp = keep ? dp * drop_scale : 0.f;
          }
          pd = attn_round_like<T>(p_drop);
          ds = attn_round_like<T>(p * (dp - dl_s[ql]) * sm_scale);
        }
        if (qi < sq && ki < skp) ds_out[(row0 + qi) * skp + ki] = attn_from_float<T>(ds);
        s_acc[j][e] = pd;
        p_acc[j][e] = ds;
      }
    }

    // dV += P_drop^T dO, dK += dS^T Q: the C fragments are the A operands
#pragma unroll
    for (int m = 0; m < BQH; m += M::K) {
      typename M::A ap, as;
      M::a_from_c(ap, s_acc + m / 8);
      M::a_from_c(as, p_acc + m / 8);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        typename M::B b;
        M::load_b_kn(b, do_s, LD, wq + m, 8 * n);
        M::mma(dv_acc[n], ap, b);
        M::load_b_kn(b, q_s, LD, wq + m, 8 * n);
        M::mma(dk_acc[n], as, b);
      }
    }
    __syncthreads();  // the next tile overwrites Q and dO
  }
  cp_async_wait<0>();  // K and V, where no tile was visited
  __syncthreads();

  // dK, dV = the first half's sums + the second half's, in that order
  float* red = reinterpret_cast<float*>(smem_raw);  // [BK / 16][ND][4][2][32]
  if (qh == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* r = red + (((kw * ND + n) * 4 + e) * 2) * 32 + lane;
        r[0] = dk_acc[n][e];
        r[32] = dv_acc[n][e];
      }
  }
  __syncthreads();
  if (qh == 1) return;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* r = red + (((kw * ND + n) * 4 + e) * 2) * 32 + lane;
      const int ki = key[e >> 1], col = 8 * n + 2 * t + (e & 1);
      if (ki < sk && col < d) {
        dk[bi * st.dkb + hi * st.dkh + (long long)ki * st.dks + col] =
            attn_from_float<T>(dk_acc[n][e] + r[0]);
        dv[bi * st.dvb + hi * st.dvh + (long long)ki * st.dvs + col] =
            attn_from_float<T>(dv_acc[n][e] + r[32]);
      }
    }
}

// Launch 2: dQ = dS K for 64 query rows of one (batch, head), over key
// tiles of 64 in order. Warps: 4 row groups of 16 x 2 halves of d.
constexpr int SB_DQ_ROWS = 64, SB_DQ_KEYS = 64, SB_DQ_THREADS = 256;

template <typename T, int DP>
__global__ void __launch_bounds__(SB_DQ_THREADS)
short_bwd_dq_kernel(const T* __restrict__ k, const T* __restrict__ ds_in,
                    T* __restrict__ dq, AttnBwdStrides st, int H, int sq, int sk, int skp,
                    int d, int causal, int vec) {
  typedef MmaOps<T> M;
  constexpr int NT = SB_DQ_THREADS, BQ = SB_DQ_ROWS, BK = SB_DQ_KEYS;
  constexpr int LD = ShortBwdTile<T, DP>::LD;
  constexpr int LDS = BK + 8;  // conflict-free A loads: fp32 float2 pairs, bf16 words
  constexpr int ND = DP / 16;  // n8 tiles of this warp's half of d
  constexpr int C = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ds_s = reinterpret_cast<T*>(smem_raw);  // [2][BQ][LDS]
  T* k_s = ds_s + 2 * BQ * LDS;             // [2][BK][LD]

  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int wq = (warp & 3) * 16, wn = (warp >> 2) * (DP / 2);
  const int offset = sk - sq;
  const long long row0 = (long long)(bi * H + hi) * sq;
  const long long kbase = bi * st.kb + hi * st.kh;

  auto prefetch = [&](int k0, int buf) {
    T* dst = ds_s + buf * BQ * LDS;
    for (int idx = threadIdx.x; idx < BQ * (BK / C); idx += NT) {
      const int r = idx / (BK / C), c = (idx % (BK / C)) * C;
      const bool ok = q0 + r < sq && k0 + c < skp;
      cp_async16(dst + r * LDS + c, ok ? ds_in + (row0 + q0 + r) * skp + k0 + c : ds_in,
                 ok ? 16 : 0);
    }
    mma_load_rows<T, BK, DP, LD, NT>(k_s + buf * BK * LD, k, kbase, st.ks, k0, sk, d, vec);
    cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // causal: keys past the last row's limit are masked for every row
  const int k_end = causal ? min(sk, min(q0 + BQ, sq) + offset) : sk;
  if (k_end > 0) prefetch(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < k_end; k0 += BK, buf ^= 1) {
    if (k0 + BK < k_end) {
      prefetch(k0 + BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* dsb = ds_s + buf * BQ * LDS;
    if (causal && k0 + BK - 1 > q0 + offset) {
      // masked pairs: launch 1 skipped some of them, so their scratch is unset
      for (int idx = threadIdx.x; idx < BQ * BK; idx += NT) {
        const int r = idx / BK, c = idx % BK;
        if (q0 + r + offset < k0 + c) dsb[r * LDS + c] = attn_from_float<T>(0.f);
      }
      __syncthreads();
    }
    const T* kb = k_s + buf * BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += M::K) {
      typename M::A a;
      M::load_a_kn(a, dsb, LDS, wq, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        typename M::B b;
        M::load_b_kn(b, kb, LD, kk, wn + 8 * n);
        M::mma(acc[n], a, b);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + wq + g + 8 * (e >> 1), col = wn + 8 * n + 2 * t + (e & 1);
      if (qi < sq && col < d)
        dq[bi * st.dqb + hi * st.dqh + (long long)qi * st.dqs + col] =
            attn_from_float<T>(acc[n][e]);
    }
}

template <typename T, int DP>
static int short_bwd_launch(const void* q, const void* k, const void* v, const float* bias,
                            const void* dout, const float* lse, const float* delta,
                            void* dq, void* dk, void* dv, void* ds, int B, int H, int sq,
                            int sk, int skp, int d, const AttnBwdStrides& st,
                            float sm_scale, int causal, int dropout_on, float drop_scale,
                            uint32_t thresh, AttnSeed seed, int vec, cudaStream_t stream) {
  constexpr int LD = ShortBwdTile<T, DP>::LD;
  typedef ShortBwdDkv<T, DP> P;
  const size_t smem1 = P::SMEM;
  const size_t smem2 = sizeof(T) * (2 * SB_DQ_ROWS * (SB_DQ_KEYS + 8) +
                                    2 * SB_DQ_KEYS * LD);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  cudaError_t err = cudaFuncSetAttribute(short_bwd_dkv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return (int)err;
  short_bwd_dkv_kernel<T, DP><<<dim3((sk + P::BK - 1) / P::BK, H, B), P::NT, smem1, stream>>>(
      qt, kt, static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(ds), st, H, sq, sk, skp, d,
      sm_scale, causal, dropout_on, drop_scale, thresh, seed, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(short_bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  short_bwd_dq_kernel<T, DP><<<dim3((sq + SB_DQ_ROWS - 1) / SB_DQ_ROWS, H, B), SB_DQ_THREADS,
                               smem2, stream>>>(
      kt, static_cast<const T*>(ds), static_cast<T*>(dq), st, H, sq, sk, skp, d, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int short_bwd_dispatch_d(int d, const void* q, const void* k, const void* v,
                                const float* bias, const void* dout, const float* lse,
                                const float* delta, void* dq, void* dk, void* dv, void* ds,
                                int B, int H, int sq, int sk, int skp,
                                const AttnBwdStrides& st, float sm_scale, int causal,
                                int dropout_on, float drop_scale, uint32_t thresh,
                                AttnSeed seed, int vec, cudaStream_t s) {
#define SB_LAUNCH(DP)                                                                      \
  return short_bwd_launch<T, DP>(q, k, v, bias, dout, lse, delta, dq, dk, dv, ds, B, H, sq, \
                                 sk, skp, d, st, sm_scale, causal, dropout_on, drop_scale,  \
                                 thresh, seed, vec, s)
  if (d <= 16) SB_LAUNCH(16);
  if (d <= 32) SB_LAUNCH(32);
  if (d <= 64) SB_LAUNCH(64);
  SB_LAUNCH(128);
#undef SB_LAUNCH
}

// C entry point, bound with ctypes. dtype: ATTN_F32, ATTN_BF16 or ATTN_F16 (0,
// 1, 2), the type of q, k, v, dout and the grads. strides: 21 element strides
// (b, s, h) of q, k, v, dout, dq, dk, dv. bias: [B, sk] float32 or NULL. lse,
// delta: [B, H, sq] float32. ds: scratch [B, H, sq, skp] of q's dtype, skp = sk
// rounded up to a multiple of 8, written by launch 1 and read by launch 2.
// Returns the cudaError_t of the launches (0 = success).
// The dropout seed: seed_val, or the word at seed_ptr in device memory when
// seed_ptr is not NULL (AttnSeed). heads_global / head0: the launch's H heads
// are heads [head0, head0 + H) of heads_global, whose global (batch, head)
// index the dropout hash takes (H and 0 for a whole launch).
extern "C" int mha_short_bwd(const void* q, const void* k, const void* v, const float* bias,
                             const void* dout, const float* lse, const float* delta,
                             void* dq, void* dk, void* dv, void* ds, int dtype, int B,
                             int H, int sq, int sk, int d, const long long* strides,
                             float sm_scale, int causal, int dropout_on, float drop_mul,
                             unsigned int thresh, int heads_global, int head0,
                             unsigned int seed_val, const unsigned int* seed_ptr,
                             void* stream) {
  const AttnSeed seed{seed_val, seed_ptr, heads_global, head0};
  if (!attn_heads_ok(H, heads_global, head0)) return (int)cudaErrorInvalidValue;
  if (d < 1 || d > ATTN_MAX_D || sq < 1 || sk < 1 || sq > 512 || sk > 512)
    return (int)cudaErrorInvalidValue;
  const AttnBwdStrides st = attn_bwd_strides_from(strides);
  const int skp = (sk + 7) / 8 * 8;
  // 16-byte copies need every row of q, k, v and dO to start 16-byte aligned
  const long long esz = attn_elem_size(dtype);
  bool vec = d % (16 / esz) == 0;
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && (strides[i] * esz) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ATTN_F32:
      return short_bwd_dispatch_d<float>(d, q, k, v, bias, dout, lse, delta, dq, dk, dv, ds, B,
                                         H, sq, sk, skp, st, sm_scale, causal, dropout_on,
                                         drop_mul, thresh, seed, vec, s);
    case ATTN_BF16:
      return short_bwd_dispatch_d<__nv_bfloat16>(d, q, k, v, bias, dout, lse, delta, dq, dk,
                                                 dv, ds, B, H, sq, sk, skp, st, sm_scale,
                                                 causal, dropout_on, drop_mul, thresh, seed,
                                                 vec, s);
    case ATTN_F16:
      return short_bwd_dispatch_d<__half>(d, q, k, v, bias, dout, lse, delta, dq, dk, dv, ds,
                                          B, H, sq, sk, skp, st, sm_scale, causal, dropout_on,
                                          drop_mul, thresh, seed, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
