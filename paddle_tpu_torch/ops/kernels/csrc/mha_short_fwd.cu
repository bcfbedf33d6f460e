// Short-sequence attention forward (sq, sk <= 512) on the tensor cores.
//
// Replaces: paddle_tpu/ops/pallas/mha_short.py, the Pallas kernels
// _fwd_kernel_bshd / _fwd_bshd_nobias (bshd, reached from _short_fwd_bshd)
// and _fwd_kernel / _fwd_nobias (head-major, reached from
// _short_fwd_pallas), which share _fwd_math. One kernel serves both
// layouts through the strides it is given.
//
// Function: S = Q K^T * scale + bias[key], causal keys past
// q + (sk - sq) set to NEG_INF, m = max(rowmax(S), NEG_INF / 8),
// P = exp(S - m), l = rowsum(P), optional hash dropout on P
// (p * 1/(1-rate)), O = (P as v's dtype) V / l (l == 0 -> 1),
// lse = m + log(l). The clamp at NEG_INF / 8 makes a row whose keys are
// all masked give O = 0 and lse = NEG_INF / 8.
//
// What bounds it on the H100: the bytes. At BERT's shape (b 8, h 12,
// s 128, d 64) q, k, v and out are 4 x 3.15 MB in fp32: 12.6 MB, 3.8 us
// at 3.35 TB/s (bf16: 1.9 us). Its 0.403 GFLOP take 2.4 us as 3xTF32 on
// the tensor cores (three TF32 products per fp32 one at 494.5 TFLOP/s)
// and 0.4 us in bf16; the FMA units would need 6.0 us in fp32. (The first
// version's note counted 1.6 MB and called it bound by operations.)
//
// Design, against what held the first (FMA) version back:
// - fp16 takes the bf16 path: m16n8k16 on f16 inputs (the same fragments),
//   fp32 sums, p rounded to fp16 before P V where bf16 rounds it to bf16.
// - Products on the tensor cores with mma.sync (mma_common.cuh): bf16 as
//   m16n8k16 with fp32 accumulation, fp32 as 3xTF32 on m16n8k8 (one TF32
//   pass perturbs S past the 1e-4 gate). The FMA loops fed every product
//   from shared memory and widened bf16 to float there, so bf16 ran no
//   faster than fp32.
// - No score buffer in shared memory. A warp owns 16 query rows and one
//   64-key tile at a time; S stays in registers as C fragments, the row
//   max and sum are quad shuffles, the softmax runs in base 2 (log2(e)
//   folded into the scale: one exp2 a score), and P feeds P V straight
//   from registers (MmaOps::a_from_c). The first version kept a [64,
//   sk + 1] float row buffer (131 KB at sk 512) and a separate whole-row
//   softmax pass, one warp a row.
// - The softmax is online over a warp's key tiles, its running max
//   starting at NEG_INF / 8: that start is exactly the clamp, so a row
//   with no live key keeps p = 0 and comes out 0. Whole-row scores would
//   need 256 registers a thread at sk 512; online, a warp holds one tile.
//   In bf16, p then rounds under the key group's running max rather than
//   the row's, up to one bf16 ulp of p apart from the reference. (On an
//   H100, sharing the row max between the key groups before the exponent
//   cost 2-3% and left the bf16 error of O as it was: the final rounding
//   of O sets it.)
// - Key warps: a block's warps are RW row groups x NKW key groups. Key
//   tile i goes to key group i % NKW, so at BERT's sk 128 the two key
//   groups each take one tile, in parallel, and every warp's softmax is
//   whole-row over its keys. At the end the key groups' (m, l, O) are
//   merged in the order of the groups through shared memory. The split
//   doubles the warps on the card (1536 at BERT's shape rather than 768)
//   without holding more query rows a block. (On an H100 at BERT's shape
//   4 x 2 warps beat 2 x 2 and 4 x 1, and beat warps of 32 rows.)
// - Asynchronous copies. Q is copied once with cp.async; a round of NKW
//   key tiles (K with its bias, then V, two copy groups) lands in a ring
//   of up to two stages, so at BERT's sk 128 all of a head's K and V is in
//   flight at once. S waits only for K: V's copy overlaps Q K^T and the
//   softmax. 16-byte copies where rows and bases are 16-byte aligned,
//   scalar copies otherwise. The first version loaded K, then V, by
//   plain loads through one buffer, two barriers a tile.
// - Occupancy: 87.5 KB of shared memory in fp32 and 46.6 KB in bf16 (84 KB
//   at sk 512, two stages) and 128 registers at d <= 64 (a bound of two
//   256-thread blocks an SM; ptxas spills 4-20 bytes), so BERT's grid of
//   192 blocks runs in one wave on 132 SMs.
// - Rows are padded by 16 bytes, so fragment loads are free of bank
//   conflicts; bf16 loads two B fragments with one ldmatrix (.trans for V).
// - Edges: d is padded with zeros to DP in {64, 128}; keys past sk get
//   p = 0 (-inf), ragged query rows are not written. Causal: a block loads
//   only the keys its rows see and a warp skips a tile whose keys its rows
//   all see masked, which is exact (p = 0, the running max unmoved), so a
//   block whose rows see no key (sq > sk) writes O = 0, lse = NEG_INF / 8.
// - No atomics: every sum runs in a fixed order, so two launches agree
//   bit for bit.
#include "attn_common.cuh"  // and the base-2 constants FLASH_*
#include "mma_common.cuh"

template <typename T, int DP>
struct ShortFwdTile {
  // 4 row groups x 2 key groups of warps (mha_short.py SHORT_FWD_KEY_GROUPS)
  static constexpr int RW = 4, NKW = 2;
  // bf16 keeps the next round's copy in flight (84 KB at sk 512); an fp32
  // stage takes 70 KB, and two would hold a block an SM
  static constexpr int MAXST = sizeof(T) == 2 ? 2 : 1;
  static constexpr int BK = 64;             // keys of a warp's tile
  static constexpr int BQ = 16 * RW;        // query rows of a block
  static constexpr int RK = BK * NKW;       // keys of a round
  static constexpr int NT = 32 * RW * NKW;  // threads
  static constexpr int LD = DP + 16 / (int)sizeof(T);  // row stride: 16-byte pad
  static constexpr int NO = DP / 8;                    // n8 tiles of O a warp
  // two blocks an SM at d <= 64; at d > 64 shared memory holds one in
  // fp32, and registers would spill under a bound for two
  static constexpr int MINB = DP <= 64 ? 2 : 1;
  static constexpr int PART = 4 * NO + 4;              // a thread's O, m and l
  // one stage of the ring: K, V, the key bias
  static constexpr size_t STAGE = sizeof(T) * 2 * RK * LD + sizeof(float) * RK;
  // the key groups' partials, merged at the end, reuse the ring
  static constexpr size_t MERGE = sizeof(float) * RW * (NKW - 1) * 32 * PART;
  static size_t smem(int nst) {
    const size_t ring = nst * STAGE;
    return sizeof(T) * BQ * LD + (ring > MERGE ? ring : MERGE);
  }
};

// cp.async.wait_group with a count known only at run time (0..3)
__device__ __forceinline__ void short_fwd_wait(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

template <typename T, int DP>
__global__ void __launch_bounds__(ShortFwdTile<T, DP>::NT, ShortFwdTile<T, DP>::MINB)
mha_short_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ lse, AttnStrides st, int H,
                     int sq, int sk, int d, float sm_scale, int causal, int dropout_on,
                     float drop_mul, uint32_t thresh, AttnSeed seed_in, int vec, int nst) {
  typedef MmaOps<T> M;
  const uint32_t seed = dropout_on ? seed_in.get() : 0u;
  typedef ShortFwdTile<T, DP> P;
  constexpr int RW = P::RW, NKW = P::NKW, BK = P::BK, BQ = P::BQ, RK = P::RK;
  constexpr int NT = P::NT, LD = P::LD, NO = P::NO, PART = P::PART;
  constexpr int NS = BK / 8;     // n8 tiles of S a warp
  constexpr int KQ = DP / M::K;  // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  unsigned char* ring = smem_raw + sizeof(T) * BQ * LD;
  // stage s: K [RK][LD], V [RK][LD], bias [RK]
  auto k_stage = [&](int s) { return reinterpret_cast<T*>(ring + s * P::STAGE); };
  auto v_stage = [&](int s) { return k_stage(s) + RK * LD; };
  auto b_stage = [&](int s) { return reinterpret_cast<float*>(v_stage(s) + RK * LD); };

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, kw = warp / RW;
  const int wq = rw * 16;       // this warp's rows in the block
  const int offset = sk - sq;   // bottom-right aligned causal mask
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const uint32_t gbh = seed_in.global_bh(bi, hi);
  const long long kbase = bi * st.kb + hi * st.kh, vbase = bi * st.vb + hi * st.vh;
  const float* brow = bias != nullptr ? bias + (long long)bi * sk : nullptr;

  // causal: the keys the block's last row sees, and the warp's
  const int k_end = causal ? max(0, min(sk, min(q0 + BQ, sq) + offset)) : sk;
  const int w_end = causal ? min(k_end, q0 + wq + 16 + offset) : k_end;
  const int nrounds = (k_end + RK - 1) / RK;

  // K and its bias, then V: two copy groups a round
  auto prefetch = [&](int r, int s) {
    const int k0 = r * RK;
    mma_load_rows<T, RK, DP, LD, NT>(k_stage(s), k, kbase, st.ks, k0, k_end, d, vec);
    if (brow != nullptr)
      for (int j = threadIdx.x; j < RK; j += NT) {
        const bool ok = k0 + j < k_end;
        cp_async4(b_stage(s) + j, ok ? brow + k0 + j : brow, ok ? 4 : 0);
      }
    cp_async_commit();
    mma_load_rows<T, RK, DP, LD, NT>(v_stage(s), v, vbase, st.vs, k0, k_end, d, vec);
    cp_async_commit();
  };

  if (nrounds > 0) {
    mma_load_rows<T, BQ, DP, LD, NT>(q_s, q, bi * st.qb + hi * st.qh, st.qs, q0, sq, d, vec);
    cp_async_commit();
    for (int r = 0; r < min(nst, nrounds); ++r) prefetch(r, r);
  }

  // rows g and g + 8 of the warp's 16: running max (base 2, from the
  // clamp) and sum, and the O accumulator
  const float scale2 = sm_scale * FLASH_LOG2E;
  const float clamp2 = FLASH_NEG_INF2 / 8.f;
  float m_r[2] = {clamp2, clamp2}, l_r[2] = {0.f, 0.f};
  float o_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

  for (int r = 0; r < nrounds; ++r) {
    const int s = r % nst;
    const int ahead = min(nst - 1, nrounds - 1 - r);  // rounds in flight behind this one
    short_fwd_wait(1 + 2 * ahead);  // Q and this round's K; V may still be in flight
    __syncthreads();
    const int k0 = r * RK + kw * BK;  // this warp's tile
    const bool live = k0 < w_end;     // some row of the warp sees a key of it
    const int ks0 = kw * BK;          // the tile's first row in the stage

    float s_acc[NS][4];
    if (live) {
      // S = Q K^T for the warp's 16 rows x 64 keys
      const T* kb = k_stage(s) + ks0 * LD;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; kk += 2) {
        typename M::A a0, a1;
        M::load_a(a0, q_s, LD, wq, kk * M::K);
        M::load_a(a1, q_s, LD, wq, (kk + 1) * M::K);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          typename M::B b0, b1;
          M::load_b_nk2(b0, b1, kb, LD, 8 * j, kk * M::K);
          M::mma(s_acc[j], a0, b0);
          M::mma(s_acc[j], a1, b1);
        }
      }

      // scale, bias, masks and the row max in base 2; element e of n8
      // tile j is row g + 8 (e >> 1), key 8 j + 2 t + (e & 1)
      const float* bb = b_stage(s) + ks0;
      const bool edge = (causal && k0 + BK - 1 > q0 + wq + offset) || k0 + BK > sk;
      float mc[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + 2 * t + (e & 1);
          float x = s_acc[j][e] * scale2;
          if (brow != nullptr) x = fmaf(bb[kl], FLASH_LOG2E, x);
          if (edge) {
            const int ki = k0 + kl, qi = q0 + wq + g + 8 * (e >> 1);
            if (causal && qi + offset < ki) x = FLASH_NEG_INF2;
            if (ki >= sk) x = -INFINITY;  // past the keys: p = 0
          }
          s_acc[j][e] = x;
          mc[e >> 1] = fmaxf(mc[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mc[h2] = fmaxf(mc[h2], __shfl_xor_sync(0xffffffffu, mc[h2], 1));
        mc[h2] = fmaxf(mc[h2], __shfl_xor_sync(0xffffffffu, mc[h2], 2));
        alpha[h2] = exp2f(m_r[h2] - mc[h2]);
        m_r[h2] = mc[h2];
      }
      // P = exp(S - m); l sums P before dropout; kept values * 1/(1-rate)
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
            p = attn_dropout_keep(seed, gbh, qi, ki, thresh) ? p * drop_mul : 0.f;
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
    }

    short_fwd_wait(2 * ahead);  // this round's V
    __syncthreads();
    if (live) {
      // O += P V: the C fragments of P are the A operands (P as v's dtype)
      const T* vb = v_stage(s) + ks0 * LD;
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
    }
    __syncthreads();  // the next prefetch, or the merge, overwrites the stage
    if (r + nst < nrounds) prefetch(r + nst, s);
  }

  // key groups 1.. hand their partials to group 0, which merges them in
  // order: m = max m_w, O and l scaled by exp2(m_w - m). Thread-private
  // slots [group][row warp][value][lane]: no bank conflicts.
  float* part = reinterpret_cast<float*>(ring);
  if (kw > 0) {
    float* p = part + (size_t)((kw - 1) * RW + rw) * PART * 32 + lane;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[(4 * n + e) * 32] = o_acc[n][e];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      p[(4 * NO + h2) * 32] = m_r[h2];
      p[(4 * NO + 2 + h2) * 32] = l_r[h2];
    }
  }
  __syncthreads();
  if (kw > 0) return;
#pragma unroll
  for (int w = 1; w < NKW; ++w) {
    const float* p = part + (size_t)((w - 1) * RW + rw) * PART * 32 + lane;
    float a0[2], a1[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float m_w = p[(4 * NO + h2) * 32], l_w = p[(4 * NO + 2 + h2) * 32];
      const float m_new = fmaxf(m_r[h2], m_w);
      a0[h2] = exp2f(m_r[h2] - m_new);
      a1[h2] = exp2f(m_w - m_new);
      l_r[h2] = a0[h2] * l_r[h2] + a1[h2] * l_w;
      m_r[h2] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o_acc[n][e] = a0[e >> 1] * o_acc[n][e] + a1[e >> 1] * p[(4 * n + e) * 32];
  }

  const long long obase = bi * st.ob + hi * st.oh;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qi = q0 + wq + g + 8 * h2;
    if (qi >= sq) continue;
    const float l_safe = (l_r[h2] == 0.f) ? 1.f : l_r[h2];
    T* orow = out + obase + (long long)qi * st.os;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * t;
      const float x0 = o_acc[n][2 * h2] / l_safe, x1 = o_acc[n][2 * h2 + 1] / l_safe;
      if (vec && col < d) {  // d even, rows aligned: the pair in one store
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(orow + col) = Mma16<T>::pack(x0, x1);
      } else {
        if (col < d) orow[col] = attn_from_float<T>(x0);
        if (col + 1 < d) orow[col + 1] = attn_from_float<T>(x1);
      }
    }
    // l == 0: no key above the clamp, lse = NEG_INF / 8 as the reference
    if (t == 0)
      lse[(long long)bh * sq + qi] =
          l_r[h2] == 0.f ? ATTN_NEG_INF / 8.f : m_r[h2] * FLASH_LN2 + logf(l_r[h2]);
  }
}

template <typename T, int DP>
static int short_fwd_launch(const void* q, const void* k, const void* v, const float* bias,
                            void* out, float* lse, int B, int H, int sq, int sk, int d,
                            const AttnStrides& st, float sm_scale, int causal,
                            int dropout_on, float drop_mul, uint32_t thresh, AttnSeed seed,
                            int vec, cudaStream_t stream) {
  typedef ShortFwdTile<T, DP> P;
  const int rounds = (sk + P::RK - 1) / P::RK;
  const int nst = rounds < P::MAXST ? rounds : P::MAXST;
  const size_t smem = P::smem(nst);
  cudaError_t err = cudaFuncSetAttribute(mha_short_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (sq + P::BQ - 1) / P::BQ);
  mha_short_fwd_kernel<T, DP><<<grid, P::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), lse, st, H, sq, sk, d, sm_scale, causal, dropout_on, drop_mul,
      thresh, seed, vec, nst);
  return (int)cudaGetLastError();
}

template <typename T>
static int short_fwd_dispatch_d(const void* q, const void* k, const void* v,
                                const float* bias, void* out, float* lse, int B, int H,
                                int sq, int sk, int d, const AttnStrides& st, float sm_scale,
                                int causal, int dropout_on, float drop_mul, uint32_t thresh,
                                AttnSeed seed, int vec, cudaStream_t s) {
  if (d <= 64)
    return short_fwd_launch<T, 64>(q, k, v, bias, out, lse, B, H, sq, sk, d, st, sm_scale,
                                   causal, dropout_on, drop_mul, thresh, seed, vec, s);
  return short_fwd_launch<T, 128>(q, k, v, bias, out, lse, B, H, sq, sk, d, st, sm_scale,
                                  causal, dropout_on, drop_mul, thresh, seed, vec, s);
}

// C entry point, bound with ctypes. dtype: ATTN_F32, ATTN_BF16 or ATTN_F16 (0,
// 1, 2), the type of q, k, v and out. strides: 12 element strides (b, s, h) of
// q, k, v, out. bias: [B, sk] float32 or NULL. lse: [B, H, sq] float32. Returns
// the cudaError_t of the launch (0 = success).
// The dropout seed: seed_val, or the word at seed_ptr in device memory when
// seed_ptr is not NULL (AttnSeed). heads_global / head0: the launch's H heads
// are heads [head0, head0 + H) of heads_global, whose global (batch, head)
// index the dropout hash takes (H and 0 for a whole launch).
extern "C" int mha_short_fwd(const void* q, const void* k, const void* v,
                             const float* bias, void* out, float* lse, int dtype,
                             int B, int H, int sq, int sk, int d,
                             const long long* strides, float sm_scale, int causal,
                             int dropout_on, float drop_mul, unsigned int thresh,
                             int heads_global, int head0, unsigned int seed_val,
                         const unsigned int* seed_ptr,
                             void* stream) {
  const AttnSeed seed{seed_val, seed_ptr, heads_global, head0};
  if (!attn_heads_ok(H, heads_global, head0)) return (int)cudaErrorInvalidValue;
  if (d < 1 || d > ATTN_MAX_D || sq < 1 || sk < 1 || sq > 512 || sk > 512)
    return (int)cudaErrorInvalidValue;
  const AttnStrides st = attn_strides_from(strides);
  // 16-byte copies need every row of q, k and v to start 16-byte aligned
  // (then d is even, and so are the rows of out, allocated like q)
  const long long esz = attn_elem_size(dtype);
  bool vec = d % (16 / esz) == 0;
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && (strides[i] * esz) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ATTN_F32:
      return short_fwd_dispatch_d<float>(q, k, v, bias, out, lse, B, H, sq, sk, d, st,
                                         sm_scale, causal, dropout_on, drop_mul, thresh, seed,
                                         vec, s);
    case ATTN_BF16:
      return short_fwd_dispatch_d<__nv_bfloat16>(q, k, v, bias, out, lse, B, H, sq, sk, d, st,
                                                 sm_scale, causal, dropout_on, drop_mul,
                                                 thresh, seed, vec, s);
    case ATTN_F16:
      return short_fwd_dispatch_d<__half>(q, k, v, bias, out, lse, B, H, sq, sk, d, st,
                                          sm_scale, causal, dropout_on, drop_mul, thresh, seed,
                                          vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
