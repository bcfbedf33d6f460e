// Blocked online-softmax attention forward, any sequence length, on the
// tensor cores.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, the Pallas kernels
// _fwd_kernel / _fwd_kernel_nobias reached from _fwd_pallas (via
// flash_attention / _flash_core). The TPU kernel walks a sequential grid
// axis over key blocks and carries m / l / acc in VMEM scratch from one
// grid step to the next; here that axis is a loop inside the block, with
// the same running values in registers.
//
// Function: per key tile, S = Q K^T * scale + bias[key], causal keys past
// q + (sk - sq) set to NEG_INF; m_new = max(m, rowmax(S)) with m starting
// at NEG_INF (no clamp, unlike the short kernel), P = exp(S - m_new),
// alpha = exp(m - m_new), l = alpha l + rowsum(P), optional hash dropout
// (p / (1 - rate)), acc = alpha acc + (P as v's dtype) V. After the last
// tile: O = acc / l (l == 0 -> 1), lse = m + log(l), written once.
//
// What bounds it on the H100: the operations. At b 2, h 12, s 2048, d 64,
// causal, the 2,098,176 live (query, key) pairs of each of 24 heads need
// 4 d FLOPs each, 12.89 GFLOP, against 25 MB of q, k, v, out and lse
// (7.6 us at 3.35 TB/s). On the tensor cores fp32 runs as 3xTF32, three
// TF32 products per fp32 one: 3 x 12.89 GFLOP at 494.5 TFLOP/s = 78 us;
// bf16 12.89 GFLOP at 989 TFLOP/s = 13 us. (The FMA units would need
// 192 us in fp32.)
//
// Design, against what held the first (FMA) version back:
// - fp16 takes the bf16 path: m16n8k16 on f16 inputs (the same fragments),
//   fp32 sums, p rounded to fp16 before P V where bf16 rounds it to bf16.
// - Products on the tensor cores with warp-level mma.sync
//   (mma_common.cuh): bf16 as m16n8k16 with fp32 accumulation, fp32 as
//   3xTF32 on m16n8k8 (x = hi + lo; hi*hi + hi*lo + lo*hi keeps a product
//   to ~2^-22 of its size; one TF32 pass perturbs S by ~5e-4, which exp
//   carries past the 1e-4 gate). The FMA loops read 8 and 12 shared words
//   for 16 and 32 FMAs and were bound by shared memory, not arithmetic.
// - A block has 4 warps over 64 query rows, 16 rows a warp. The Q tile is
//   copied in once with cp.async and held as A fragments in registers for
//   the whole loop (fp32: hi / lo split once), except fp32 at d > 64, whose
//   128 registers of Q would spill: it reloads Q's fragments from shared
//   memory each tile.
// - S = Q K^T stays in registers as C fragments. Each row lives on the 4
//   lanes of a quad, so the online softmax's row max and sum are two
//   __shfl_xor_sync steps: no shared round trip of S, no barrier between
//   the softmax and P V. Dropout hashes each fragment element's own
//   (query, key). P feeds P V straight from registers (MmaOps::a_from_c;
//   for TF32 the permuted k order, which load_b_kn reads V in); the O
//   accumulator, 16 x d per warp, stays in registers and is rescaled by
//   alpha per tile. The softmax runs in base 2 with log2(e) folded into
//   the scale, so each score costs one exp2, a single MUFU op.
// - K, V and the key bias are double-buffered with cp.async in separate
//   buffers: the next tile's copy is in flight while this one computes,
//   and V no longer waits for the softmax. Rows are padded by 16 bytes, so
//   the fragment loads are free of bank conflicts; in bf16 one ldmatrix
//   (.trans for V) loads two B fragments. Two barriers a tile (the first
//   version had four).
// - Occupancy: fp32 at d <= 64 keeps Q's 64 registers of fragments and
//   runs 2 blocks (8 warps) an SM, held by its 87.5 KB of shared memory;
//   bf16 at d <= 64 (46.5 KB) is held to 168 registers, so 3 blocks fit
//   an SM (at 170 registers only 2 did, and a one-wave grid took two).
// - Causal: a query tile stops at the last key its last row sees, so the
//   tiles past the diagonal (496 of 1024 tile pairs at s 2048) are never
//   loaded, and the mask is evaluated only on tiles that cross it. This is
//   exact for every row with a live key (a later tile would give p = 0 and
//   alpha = 1). A row with no live key (sq > sk, q + sk - sq < 0) has
//   p = exp(0) = 1 over all sk keys in the reference, so a query tile that
//   holds one walks every key tile. Causal grids take the query tiles in
//   reverse order, longest rows first, so the tail of the grid is short.
// - Edges: d is padded with zeros in shared memory to DP in {64, 128};
//   ragged query rows and keys are masked (keys past sk get p = 0). A
//   16-byte copy runs where rows and bases are 16-byte aligned, a scalar
//   copy inside the kernel otherwise.
// - No atomics: each output element is one thread's sum over the key
//   tiles in order, so two launches agree bit for bit.
#include "attn_common.cuh"  // and the base-2 constants FLASH_*
#include "mma_common.cuh"

template <typename T, int DP>
struct FlashFwdTile {
  static constexpr int BQ = 64, BK = 64;  // query rows, keys per tile
  static constexpr int NT = 128;          // 4 warps x 16 query rows
  static constexpr int LD = DP + 16 / (int)sizeof(T);  // row stride: 16-byte pad
  // Q as A fragments in registers; fp32 at d > 64 would take 128 registers
  static constexpr bool Q_IN_REGS = sizeof(T) == 2 || DP <= 64;
  // Q, two stages of K and V, two of the key bias
  static constexpr size_t SMEM = sizeof(T) * (size_t)(BQ + 4 * BK) * LD + sizeof(float) * 2 * BK;
  // bf16 at d <= 64 (47 KB) runs 3 blocks an SM if it keeps to 168
  // registers; the others are held to 1-2 blocks by shared memory
  static constexpr int MIN_BLOCKS = sizeof(T) == 2 && DP <= 64 ? 3 : 1;
};

template <typename T, int DP>
__global__ void __launch_bounds__(FlashFwdTile<T, DP>::NT, FlashFwdTile<T, DP>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 AttnStrides st, int H, int sq, int sk, int d, float sm_scale, int causal,
                 int dropout_on, float drop_div, uint32_t thresh, AttnSeed seed_in, int vec) {
  typedef MmaOps<T> M;
  const uint32_t seed = dropout_on ? seed_in.get() : 0u;
  typedef FlashFwdTile<T, DP> P;
  constexpr int BQ = P::BQ, BK = P::BK, NT = P::NT, LD = P::LD;
  constexpr int NS = BK / 8;     // n8 tiles of S per warp
  constexpr int NO = DP / 8;     // n8 tiles of O per warp
  constexpr int KQ = DP / M::K;  // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                   // [BQ][LD]
  T* k_s = q_s + BQ * LD;                                    // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                                // [2][BK][LD]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // [2][BK]

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wq = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int offset = sk - sq;              // bottom-right aligned causal mask
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const uint32_t gbh = seed_in.global_bh(bi, hi);
  const long long kbase = bi * st.kb + hi * st.kh, vbase = bi * st.vb + hi * st.vh;
  const float* brow = bias != nullptr ? bias + (long long)bi * sk : nullptr;

  // causal: keys up to the tile's last row's limit; a tile with a row that
  // sees no key walks them all (see the note above)
  const int k_end = (causal && q0 + offset >= 0) ? min(sk, min(q0 + BQ, sq) + offset) : sk;
  const int ntiles = (k_end + BK - 1) / BK;

  auto prefetch = [&](int k0, int buf) {
    mma_load_rows<T, BK, DP, LD, NT>(k_s + buf * BK * LD, k, kbase, st.ks, k0, sk, d, vec);
    mma_load_rows<T, BK, DP, LD, NT>(v_s + buf * BK * LD, v, vbase, st.vs, k0, sk, d, vec);
    if (brow != nullptr)
      for (int j = threadIdx.x; j < BK; j += NT) {
        const bool ok = k0 + j < sk;
        cp_async4(b_s + buf * BK + j, ok ? brow + k0 + j : brow, ok ? 4 : 0);
      }
    cp_async_commit();
  };

  mma_load_rows<T, BQ, DP, LD, NT>(q_s, q, bi * st.qb + hi * st.qh, st.qs, q0, sq, d, vec);
  cp_async_commit();
  prefetch(0, 0);
  cp_async_wait<1>();  // Q; the first K / V tile may still be in flight
  __syncthreads();
  typename M::A qa[P::Q_IN_REGS ? KQ : 1];
  if constexpr (P::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) M::load_a(qa[kk], q_s, LD, wq, kk * M::K);
  }

  // rows g and g + 8 of the warp's 16: running max (base 2) and sum
  const float scale2 = sm_scale * FLASH_LOG2E;
  float m_r[2] = {FLASH_NEG_INF2, FLASH_NEG_INF2}, l_r[2] = {0.f, 0.f};
  float o_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, buf = it & 1;
    if (it + 1 < ntiles) {
      prefetch(k0 + BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys
    const T* kb = k_s + buf * BK * LD;
    float s_acc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; kk += 2) {
      typename M::A a0, a1;
      if constexpr (P::Q_IN_REGS) {
        a0 = qa[kk];
        a1 = qa[kk + 1];
      } else {
        M::load_a(a0, q_s, LD, wq, kk * M::K);
        M::load_a(a1, q_s, LD, wq, (kk + 1) * M::K);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        typename M::B b0, b1;
        M::load_b_nk2(b0, b1, kb, LD, 8 * j, kk * M::K);
        M::mma(s_acc[j], a0, b0);
        M::mma(s_acc[j], a1, b1);
      }
    }

    // scale, bias, masks and the row max, in base 2 (S log2(e)); element e
    // of n8 tile j is row g + 8 (e >> 1), key 8 j + 2 t + (e & 1)
    const float* bb = b_s + buf * BK;
    const bool diag = causal && k0 + BK - 1 > q0 + wq + offset;
    const bool edge = diag || k0 + BK > sk;
    float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1);
        float s = s_acc[j][e] * scale2;
        if (brow != nullptr) s = fmaf(bb[kl], FLASH_LOG2E, s);
        if (edge) {
          const int ki = k0 + kl, qi = q0 + wq + g + 8 * (e >> 1);
          if (causal && qi + offset < ki) s = FLASH_NEG_INF2;
          if (ki >= sk) s = -INFINITY;  // past the keys: p = 0
        }
        s_acc[j][e] = s;
        mc[e >> 1] = fmaxf(mc[e >> 1], s);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mc[h2] = fmaxf(mc[h2], __shfl_xor_sync(0xffffffffu, mc[h2], 1));
      mc[h2] = fmaxf(mc[h2], __shfl_xor_sync(0xffffffffu, mc[h2], 2));
      const float m_new = fmaxf(m_r[h2], mc[h2]);
      alpha[h2] = exp2f(m_r[h2] - m_new);
      m_r[h2] = m_new;
    }
    // P = exp(S - m); l sums P before dropout; P as v's dtype feeds P V
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1;
        float p = exp2f(s_acc[j][e] - m_r[h2]);
        rs[h2] += p;
        if (dropout_on) {
          const uint32_t qi = (uint32_t)(q0 + wq + g + 8 * h2);
          const uint32_t ki = (uint32_t)(k0 + 8 * j + 2 * t + (e & 1));
          p = attn_dropout_keep(seed, gbh, qi, ki, thresh) ? p / drop_div : 0.f;
        }
        s_acc[j][e] = p;
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      rs[h2] += __shfl_xor_sync(0xffffffffu, rs[h2], 1);
      rs[h2] += __shfl_xor_sync(0xffffffffu, rs[h2], 2);
      l_r[h2] = alpha[h2] * l_r[h2] + rs[h2];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];

    // O += P V: the C fragments of P are the A operands
    const T* vb = v_s + buf * BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += M::K) {
      typename M::A a;
      M::a_from_c(a, s_acc + kk / 8);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        typename M::B b0, b1;
        M::load_b_kn2(b0, b1, vb, LD, kk, 8 * n);
        M::mma(o_acc[n], a, b0);
        M::mma(o_acc[n + 1], a, b1);
      }
    }
    __syncthreads();  // the next prefetch overwrites this tile's buffers
  }

  const long long obase = bi * st.ob + hi * st.oh;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qi = q0 + wq + g + 8 * h2;
    if (qi >= sq) continue;
    const float l_safe = (l_r[h2] == 0.f) ? 1.f : l_r[h2];
    T* orow = out + obase + (long long)qi * st.os;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < d) orow[col] = attn_from_float<T>(o_acc[n][2 * h2 + c] / l_safe);
      }
    if (t == 0) lse[(long long)bh * sq + qi] = m_r[h2] * FLASH_LN2 + logf(l_safe);
  }
}

template <typename T, int DP>
static int flash_fwd_launch(const void* q, const void* k, const void* v, const float* bias,
                            void* out, float* lse, int B, int H, int sq, int sk, int d,
                            const AttnStrides& st, float sm_scale, int causal,
                            int dropout_on, float drop_div, uint32_t thresh, AttnSeed seed,
                            int vec, cudaStream_t stream) {
  typedef FlashFwdTile<T, DP> P;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (sq + P::BQ - 1) / P::BQ);
  flash_fwd_kernel<T, DP><<<grid, P::NT, P::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), lse, st, H, sq, sk, d, sm_scale, causal, dropout_on, drop_div,
      thresh, seed, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int flash_fwd_dispatch_d(const void* q, const void* k, const void* v,
                                const float* bias, void* out, float* lse, int B, int H,
                                int sq, int sk, int d, const AttnStrides& st, float sm_scale,
                                int causal, int dropout_on, float drop_div, uint32_t thresh,
                                AttnSeed seed, int vec, cudaStream_t s) {
  if (d <= 64)
    return flash_fwd_launch<T, 64>(q, k, v, bias, out, lse, B, H, sq, sk, d, st, sm_scale,
                                   causal, dropout_on, drop_div, thresh, seed, vec, s);
  return flash_fwd_launch<T, 128>(q, k, v, bias, out, lse, B, H, sq, sk, d, st, sm_scale,
                                  causal, dropout_on, drop_div, thresh, seed, vec, s);
}

// C entry point, bound with ctypes. dtype: ATTN_F32, ATTN_BF16 or ATTN_F16 (0,
// 1, 2), the type of q, k, v and out. strides: 12 element strides (b, s, h) of
// q, k, v, out. bias: [B, sk] float32 or NULL. lse: [B, H, sq] float32. Returns
// the cudaError_t of the launch (0 = success).
// The dropout seed: seed_val, or the word at seed_ptr in device memory when
// seed_ptr is not NULL (AttnSeed). heads_global / head0: the launch's H heads
// are heads [head0, head0 + H) of heads_global, whose global (batch, head)
// index the dropout hash takes (H and 0 for a whole launch).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, int dtype, int B, int H, int sq,
                         int sk, int d, const long long* strides, float sm_scale,
                         int causal, int dropout_on, float drop_div, unsigned int thresh,
                         int heads_global, int head0, unsigned int seed_val,
                         const unsigned int* seed_ptr,
                         void* stream) {
  const AttnSeed seed{seed_val, seed_ptr, heads_global, head0};
  if (!attn_heads_ok(H, heads_global, head0)) return (int)cudaErrorInvalidValue;
  if (d < 1 || d > ATTN_MAX_D || sq < 1 || sk < 1 || (sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnStrides st = attn_strides_from(strides);
  // 16-byte copies need every row of q, k and v to start 16-byte aligned
  const long long esz = attn_elem_size(dtype);
  bool vec = d % (16 / esz) == 0;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && (strides[i] * esz) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ATTN_F32:
      return flash_fwd_dispatch_d<float>(q, k, v, bias, out, lse, B, H, sq, sk, d, st,
                                         sm_scale, causal, dropout_on, drop_div, thresh, seed,
                                         vec, s);
    case ATTN_BF16:
      return flash_fwd_dispatch_d<__nv_bfloat16>(q, k, v, bias, out, lse, B, H, sq, sk, d, st,
                                                 sm_scale, causal, dropout_on, drop_div,
                                                 thresh, seed, vec, s);
    case ATTN_F16:
      return flash_fwd_dispatch_d<__half>(q, k, v, bias, out, lse, B, H, sq, sk, d, st,
                                          sm_scale, causal, dropout_on, drop_div, thresh, seed,
                                          vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
