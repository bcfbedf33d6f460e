// Blocked attention backward, any sequence length, on the tensor cores:
// dQ, dK and dV from the forward's lse and delta.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, the Pallas kernels
// _bwd_dkv_kernel / _bwd_dkv_nobias (dK, dV) and _bwd_dq_kernel /
// _bwd_dq_nobias (dQ), reached from _bwd_pallas. The TPU kernels walk a
// sequential grid axis (query blocks for dK / dV, key blocks for dQ) and
// carry the sums in VMEM scratch; here that axis is a loop inside the
// block, with the sums in registers.
//
// Function: the two Pallas kernels' (flash_attention.py:227-371). Per
// (query, key) pair s = q.k * scale + bias[key], causal keys past
// q + (sk - sq) set to NEG_INF, p = exp(s - lse) from the forward's
// unclamped lse, dp = dO.v; with dropout the forward's murmur keep mask of
// the global (batch*head, query, key) coordinates, kept values divided by
// (1 - rate). Then dV = sum_q (p_drop as dO's dtype) dO,
// dS = (p (dp - delta) scale as q's dtype), dQ = sum_k dS K and
// dK = sum_q dS Q; delta = rowsum(dO * O) comes from the wrapper. Ragged
// keys are masked in the kernel where the JAX path pads them with a
// NEG_INF bias (_pad_inputs), which gives them p == 0: the same function.
//
// What bounds it on the H100: at b 2, h 12, s 2048, d 64, causal, the
// 2,098,176 live pairs of each of 24 heads need 10 d operations each,
// 32.2 GFLOP, against ~88 MB of q, k, v, dO, dQ, dK, dV, lse and delta in
// fp32 (26 us at 3.35 TB/s). On the tensor cores fp32 runs as 3xTF32:
// 3 x 32.2 GFLOP at 494.5 TFLOP/s = 195 us; bf16 32.2 GFLOP at 989
// TFLOP/s = 33 us. (The FMA units would need 481 us in fp32.)
//
// Design:
// - fp16 takes the bf16 path: m16n8k16 on f16 inputs (the same fragments),
//   fp32 sums, p_drop and dS rounded to fp16 where bf16 rounds them; a dS
//   past fp16's 65504 (a large loss scale) becomes inf, as the Pallas
//   kernel's astype(float16) gives it, and the step's finite check skips it.
// - Every product on the tensor cores with warp-level mma.sync
//   (mma_common.cuh): bf16 as m16n8k16 with fp32 accumulation, fp32 as
//   3xTF32 on m16n8k8 (x = hi + lo; hi*hi + hi*lo + lo*hi keeps a product
//   to ~2^-22 of its size; a single TF32 pass perturbs S by ~5e-4, which
//   exp carries past the 1e-4 gate).
// - Two launches, no atomics, no scratch. Launch 1 gives each block 32
//   keys of one (batch, head), K and V resident in shared memory, and walks
//   the query tiles in order. Warp (kg, qh) of its 4 owns 16 keys and one
//   half of each tile's queries: it computes S^T = K Q^T and dP^T = V dO^T
//   as C fragments, then p, the keep mask and dS in registers, and feeds
//   them as A fragments straight into dV += P_drop^T dO and dK += dS^T Q
//   (MmaOps::a_from_c; for TF32 the permuted k order, which load_b_kn reads
//   Q and dO in); the halves' sums are added at the end. Launch 2 gives
//   each block 32 query rows, walks the key tiles in order, and warp
//   (rg, kh) recomputes S and dP for its 16 rows and one half of each
//   tile's keys and sums dQ += dS K the same way. 14 d operations a pair,
//   against the function's 10 d: a dS scratch shared by the launches (as
//   in mha_short_bwd.cu) would be [b, h, sq, sk], 402 MB in fp32 at s 2048,
//   and a dQ summed across key blocks would need atomics. Every output
//   element is a sum in a fixed order, so two launches agree bit for bit.
// - Each tile's products go into a fresh accumulator and are then added
//   to the running sums with fp32 adds (flash_bwd_flush): the tensor
//   cores truncate as they accumulate, and a sum carried there across the
//   tiles of a long sequence drifted by 3.6e-5 of dK at s 2048 (1.6e-6
//   this way, against 3.0e-6 for the earlier FMA kernel).
// - p = exp2(q.k scale log2(e) + (bias - lse) log2(e)): log2(e) folded into
//   the scale, the key bias and the lse, one FMA and one MUFU op a score
//   (flash_bwd_exp2). bias and lse log2(e) are rounded on their own
//   (__fmul_rn, never fused into a subtraction), so a masked score
//   NEG_INF log2(e) against lse = NEG_INF gives exactly 0.
// - Occupancy: at d <= 64 a block has 4 warps and 47-53 KB of shared
//   memory, held to 168 registers, so 3 blocks (12 warps) fit an SM; the
//   long-sequence step's grids (b 2, h 12, s 2048: 24 heads x 64 blocks
//   a launch) take ~4 waves, causal ones longest block first. fp32 tiles
//   are copied in one stage (two would hold an SM to 2 blocks, measured
//   slower) and the other blocks on the SM overlap the copy; bf16 tiles in
//   two, the next tile's cp.async in flight while this one computes, one
//   barrier a tile.
// - Causal: launch 1 starts at the first query tile that sees any of its
//   keys, launch 2 stops at the last key its last row sees, and the mask
//   is evaluated only on tiles that cross the diagonal. Exact for every
//   row with a live key (the skipped pairs have p == 0). A row with no
//   live key (sq > sk, q + sk - sq < 0) has lse = NEG_INF, so p =
//   exp(NEG_INF - NEG_INF) = 1 over all sk keys, as in the reference: a
//   query tile that holds such a row is never skipped, in either launch
//   (the backward twin of flash_fwd.cu's rule).
// - Edges: d is padded with zeros in shared memory to DP in {64, 128};
//   ragged query rows and keys are masked. A 16-byte copy runs where rows
//   and bases are 16-byte aligned, a scalar copy otherwise. At d > 64
//   launch 1 takes query tiles of 32 rows, to keep its dK and dV sums in
//   registers.
#include "attn_common.cuh"  // AttnBwdStrides, the base-2 constants FLASH_*
#include "mma_common.cuh"

// 2^x as one MUFU op (ex2.approx.ftz): a p below 2^-126 flushes to 0, under
// 1e-38 of any sum it joins; exp2f's handling of such results cost 2-4% of
// the kernel's time.
__device__ __forceinline__ float flash_bwd_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int DP>
struct FlashBwdTile {
  static constexpr int NT = 128;                       // 4 warps
  static constexpr int LD = DP + 16 / (int)sizeof(T);  // row stride: 16-byte pad
  // fp32 tiles are copied in one stage, so 3 blocks fit an SM; bf16's
  // half-size tiles in two
  static constexpr int STAGES = sizeof(T) == 2 ? 2 : 1;
  // launch 1: keys per block (2 groups of 16) and query rows per tile (2
  // halves); launch 2: query rows per block (2 groups of 16) and keys per
  // tile (2 halves of 32)
  static constexpr int BK1 = 32, BQ1 = DP <= 64 ? 64 : 32;
  static constexpr int BQ2 = 32, BK2 = 64;
  // n8 tiles of a sum that one flush carries at once: launch 1 holds dK
  // and dV, so in fp32 it flushes 4 at a time to stay within 168 registers
  static constexpr int NF2 = DP / 8 < 8 ? DP / 8 : 8;
  static constexpr int NF1 = sizeof(T) == 4 ? 4 : NF2;
  // K, V; the stages of Q, dO, lse and delta; then the halves' dK / dV
  static constexpr size_t TILES1 = sizeof(T) * (size_t)(2 * BK1 + 2 * STAGES * BQ1) * LD +
                                   sizeof(float) * 2 * STAGES * BQ1;
  static constexpr size_t RED1 = sizeof(float) * 2 * BK1 * DP;
  static constexpr size_t SMEM1 = TILES1 > RED1 ? TILES1 : RED1;
  // Q, dO; the stages of K, V and the key bias; then the halves' dQ
  static constexpr size_t TILES2 = sizeof(T) * (size_t)(2 * BQ2 + 2 * STAGES * BK2) * LD +
                                   sizeof(float) * STAGES * BK2;
  static constexpr size_t RED2 = sizeof(float) * BQ2 * DP;
  static constexpr size_t SMEM2 = TILES2 > RED2 ? TILES2 : RED2;
  // 3 blocks an SM at d <= 64 (<= 168 registers, 53 KB of shared memory in
  // fp32); d 128's accumulators take more registers
  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 1;
};

// acc[n] += sum_{k < KN} A[k] B[b0 + k][n], for the n8 tiles of DP: A from
// this warp's C fragments c (its 16 rows, columns as k), B a [k][n] tile of
// row stride LD. One tile's products are summed in a fresh accumulator
// first, NF n8 tiles at a time, and then added to acc with fp32 adds: the
// tensor cores' accumulation truncates, so a sum carried there across the
// hundreds of tiles of a long sequence drifts toward zero by up to 2^-24
// of itself per step, where one tile's sum drifts by ~1e-6.
template <typename T, int KN, int DP, int NF, int LD>
__device__ __forceinline__ void flash_bwd_flush(float (*acc)[4], float (*c)[4], const T* b,
                                                int b0) {
  typedef MmaOps<T> M;
#pragma unroll
  for (int n0 = 0; n0 < DP / 8; n0 += NF) {
    float tmp[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[n][e] = 0.f;
#pragma unroll
    for (int m = 0; m < KN; m += M::K) {
      typename M::A a;
      M::a_from_c(a, c + m / 8);
#pragma unroll
      for (int n = 0; n < NF; n += 2) {
        typename M::B x0, x1;
        M::load_b_kn2(x0, x1, b, LD, b0 + m, 8 * (n0 + n));
        M::mma(tmp[n], a, x0);
        M::mma(tmp[n + 1], a, x1);
      }
    }
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += tmp[n][e];
  }
}

// Launch 1: dK and dV for 32 keys of one (batch, head). Warp (kg, qh) owns
// keys 16 kg .. 16 kg + 15 of the block and one half of each query tile;
// the two halves' sums are added at the end in a fixed order.
template <typename T, int DP>
__global__ void __launch_bounds__(FlashBwdTile<T, DP>::NT, FlashBwdTile<T, DP>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, AttnBwdStrides st, int H, int sq, int sk, int d,
                     float sm_scale, int causal, int dropout_on, float drop_div,
                     uint32_t thresh, AttnSeed seed_in, int vec) {
  typedef MmaOps<T> M;
  const uint32_t seed = dropout_on ? seed_in.get() : 0u;
  typedef FlashBwdTile<T, DP> P;
  constexpr int BK = P::BK1, BQ = P::BQ1, NT = P::NT, LD = P::LD, S = P::STAGES;
  constexpr int BQH = BQ / 2;  // query rows of a tile per warp
  constexpr int NQ = BQH / 8;  // n8 tiles of S^T per warp
  constexpr int ND = DP / 8;   // n8 tiles of dK, dV per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);                       // [BK][LD]
  T* v_s = k_s + BK * LD;                                        // [BK][LD]
  T* q_s = v_s + BK * LD;                                        // [S][BQ][LD]
  T* do_s = q_s + S * BQ * LD;                                   // [S][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + S * BQ * LD);  // [S][BQ]
  float* dl_s = lse_s + S * BQ;                                  // [S][BQ]

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kg = warp & 1, qh = warp >> 1;
  const int wk = kg * 16, wq = qh * BQH;  // this warp's keys and query rows
  const int offset = sk - sq;              // bottom-right aligned causal mask
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const uint32_t gbh = seed_in.global_bh(bi, hi);
  const long long row0 = (long long)bh * sq;
  const long long qbase = bi * st.qb + hi * st.qh, obase = bi * st.ob + hi * st.oh;

  // causal: the query tiles before the first row that sees key k0 are
  // skipped, except those that hold a row with no live key (rows
  // 0 .. -offset - 1, a prefix), whose p is 1 on every key
  const int nqt = (sq + BQ - 1) / BQ;
  int dead = 0, skip = 0;
  if (causal) {
    dead = offset < 0 ? min(nqt, (-offset + BQ - 1) / BQ) : 0;
    skip = max(0, max(0, k0 - offset) / BQ - dead);
  }
  const int ntiles = nqt - skip;
  auto tile_q0 = [&](int i) { return (i < dead ? i : i + skip) * BQ; };

  auto prefetch = [&](int q0, int buf) {
    mma_load_rows<T, BQ, DP, LD, NT>(q_s + buf * BQ * LD, q, qbase, st.qs, q0, sq, d, vec);
    mma_load_rows<T, BQ, DP, LD, NT>(do_s + buf * BQ * LD, dout, obase, st.os, q0, sq, d,
                                     vec);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool ok = q0 + r < sq;
      const long long i = row0 + (ok ? q0 + r : 0);
      cp_async4(lse_s + buf * BQ + r, lse + i, ok ? 4 : 0);
      cp_async4(dl_s + buf * BQ + r, delta + i, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  mma_load_rows<T, BK, DP, LD, NT>(k_s, k, bi * st.kb + hi * st.kh, st.ks, k0, sk, d, vec);
  mma_load_rows<T, BK, DP, LD, NT>(v_s, v, bi * st.vb + hi * st.vh, st.vs, k0, sk, d, vec);
  cp_async_commit();
  if constexpr (S == 2) prefetch(tile_q0(0), 0);

  // this thread's keys: rows g and g + 8 of the warp's C fragments
  const float scale2 = sm_scale * FLASH_LOG2E;
  int key[2];
  float kbias2[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    key[h2] = k0 + wk + g + 8 * h2;
    kbias2[h2] = (bias != nullptr && key[h2] < sk)
                     ? __fmul_rn(bias[(long long)bi * sk + key[h2]], FLASH_LOG2E) : 0.f;
  }

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = tile_q0(it), buf = S == 2 ? it & 1 : 0;
    if constexpr (S == 1) prefetch(q0, 0);  // the other blocks on the SM overlap it
    cp_async_wait<0>();
    __syncthreads();  // the tile is in; every warp is done with the last one
    if (S == 2 && it + 1 < ntiles) prefetch(tile_q0(it + 1), buf ^ 1);
    const T* qb = q_s + buf * BQ * LD;
    const T* ob = do_s + buf * BQ * LD;
    const float* lb = lse_s + buf * BQ;
    const float* db = dl_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQH queries
    float s_acc[NQ][4], p_acc[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = p_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 2 * M::K) {
      typename M::A ak0, ak1, av0, av1;
      M::load_a(ak0, k_s, LD, wk, kk);
      M::load_a(ak1, k_s, LD, wk, kk + M::K);
      M::load_a(av0, v_s, LD, wk, kk);
      M::load_a(av1, v_s, LD, wk, kk + M::K);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        typename M::B b0, b1;
        M::load_b_nk2(b0, b1, qb, LD, wq + 8 * j, kk);
        M::mma(s_acc[j], ak0, b0);
        M::mma(s_acc[j], ak1, b1);
        M::load_b_nk2(b0, b1, ob, LD, wq + 8 * j, kk);
        M::mma(p_acc[j], av0, b0);
        M::mma(p_acc[j], av1, b1);
      }
    }

    // p, the keep mask and dS once per pair; s_acc becomes p_drop, p_acc
    // dS. Element e of n8 tile j is key g + 8 (e >> 1), query
    // wq + 8 j + 2 t + (e & 1) of the tile.
    const bool edge = (causal && q0 + wq + offset < k0 + wk + 15) || q0 + wq + BQH > sq ||
                      k0 + wk + 16 > sk;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float lse2[2], dl[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lse2[c] = __fmul_rn(lb[wq + 8 * j + 2 * t + c], FLASH_LOG2E);
        dl[c] = db[wq + 8 * j + 2 * t + c];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, c = e & 1;
        const int qi = q0 + wq + 8 * j + 2 * t + c, ki = key[h2];
        float x = fmaf(s_acc[j][e], scale2, kbias2[h2] - lse2[c]);
        if (edge && causal && qi + offset < ki) x = FLASH_NEG_INF2 - lse2[c];
        float p = flash_bwd_exp2(x);
        if (edge && (qi >= sq || ki >= sk)) p = 0.f;
        float dp = p_acc[j][e], pd = p;
        if (dropout_on) {
          const bool keep = attn_dropout_keep(seed, gbh, (uint32_t)qi, (uint32_t)ki, thresh);
          pd = keep ? p / drop_div : 0.f;
          dp = keep ? dp / drop_div : 0.f;
        }
        s_acc[j][e] = pd;
        p_acc[j][e] = p * (dp - dl[c]) * sm_scale;
      }
    }

    // dV += P_drop^T dO and dK += dS^T Q over this warp's queries: the C
    // fragments are the A operands, which a_from_c rounds to T (p_drop as
    // dO's dtype, dS as q's)
    flash_bwd_flush<T, BQH, DP, P::NF1, LD>(dv_acc, s_acc, ob, wq);
    flash_bwd_flush<T, BQH, DP, P::NF1, LD>(dk_acc, p_acc, qb, wq);
    if constexpr (S == 1) __syncthreads();  // the next copy overwrites the tile
  }

  // dK, dV = the first query half's sums + the second half's, in that order,
  // through the tile buffers once every warp is done with them
  if constexpr (S == 2) __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [BK / 16][ND][4][2][32]
  if (qh == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* r = red + (((kg * ND + n) * 4 + e) * 2) * 32 + lane;
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
      const float* r = red + (((kg * ND + n) * 4 + e) * 2) * 32 + lane;
      const int ki = key[e >> 1], col = 8 * n + 2 * t + (e & 1);
      if (ki < sk && col < d) {
        dk[bi * st.dkb + hi * st.dkh + (long long)ki * st.dks + col] =
            attn_from_float<T>(dk_acc[n][e] + r[0]);
        dv[bi * st.dvb + hi * st.dvh + (long long)ki * st.dvs + col] =
            attn_from_float<T>(dv_acc[n][e] + r[32]);
      }
    }
}

// Launch 2: dQ for 32 query rows of one (batch, head), over the key tiles
// in order. Warp (rg, kh) owns rows 16 rg .. 16 rg + 15 of the block and
// one half of each key tile; the halves' sums are added at the end in a
// fixed order.
template <typename T, int DP>
__global__ void __launch_bounds__(FlashBwdTile<T, DP>::NT, FlashBwdTile<T, DP>::MIN_BLOCKS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, AttnBwdStrides st,
                    int H, int sq, int sk, int d, float sm_scale, int causal, int dropout_on,
                    float drop_div, uint32_t thresh, AttnSeed seed_in, int vec) {
  typedef MmaOps<T> M;
  const uint32_t seed = dropout_on ? seed_in.get() : 0u;
  typedef FlashBwdTile<T, DP> P;
  constexpr int BQ = P::BQ2, BK = P::BK2, NT = P::NT, LD = P::LD, S = P::STAGES;
  constexpr int BKH = BK / 2;    // keys of a tile per warp
  constexpr int NS = BKH / 8;    // n8 tiles of S per warp
  constexpr int ND = DP / 8;     // n8 tiles of dQ per warp
  constexpr int KQ = DP / M::K;  // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                   // [BQ][LD]
  T* do_s = q_s + BQ * LD;                                   // [BQ][LD]
  T* k_s = do_s + BQ * LD;                                   // [S][BK][LD]
  T* v_s = k_s + S * BK * LD;                                // [S][BK][LD]
  float* b_s = reinterpret_cast<float*>(v_s + S * BK * LD);  // [S][BK]

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  // causal grids take the query tiles longest first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 1, kh = warp >> 1;
  const int wq = rg * 16, wk = kh * BKH;  // this warp's rows and keys
  const int offset = sk - sq;
  const uint32_t bh = (uint32_t)(bi * H + hi);
  const uint32_t gbh = seed_in.global_bh(bi, hi);
  const long long row0 = (long long)bh * sq;
  const long long kbase = bi * st.kb + hi * st.kh, vbase = bi * st.vb + hi * st.vh;
  const float* brow = bias != nullptr ? bias + (long long)bi * sk : nullptr;

  // causal: keys up to the block's last row's limit; a block with a row
  // that sees no key walks them all (see the note above)
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
  mma_load_rows<T, BQ, DP, LD, NT>(do_s, dout, bi * st.ob + hi * st.oh, st.os, q0, sq, d,
                                   vec);
  cp_async_commit();
  if constexpr (S == 2) prefetch(0, 0);

  // rows g and g + 8 of the warp's 16: lse (base 2) and delta
  const float scale2 = sm_scale * FLASH_LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int qi = q0 + wq + g + 8 * h2;
    lse2[h2] = qi < sq ? __fmul_rn(lse[row0 + qi], FLASH_LOG2E) : 0.f;
    dl[h2] = qi < sq ? delta[row0 + qi] : 0.f;
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK, buf = S == 2 ? it & 1 : 0;
    if constexpr (S == 1) prefetch(k0, 0);  // the other blocks on the SM overlap it
    cp_async_wait<0>();
    __syncthreads();  // the tile is in; every warp is done with the last one
    if (S == 2 && it + 1 < ntiles) prefetch(k0 + BK, buf ^ 1);
    const T* kb = k_s + buf * BK * LD;
    const T* vb = v_s + buf * BK * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BKH keys
    float s_acc[NS][4], p_acc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = p_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; kk += 2) {
      typename M::A a0, a1, c0, c1;
      M::load_a(a0, q_s, LD, wq, kk * M::K);
      M::load_a(a1, q_s, LD, wq, (kk + 1) * M::K);
      M::load_a(c0, do_s, LD, wq, kk * M::K);
      M::load_a(c1, do_s, LD, wq, (kk + 1) * M::K);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        typename M::B b0, b1;
        M::load_b_nk2(b0, b1, kb, LD, wk + 8 * j, kk * M::K);
        M::mma(s_acc[j], a0, b0);
        M::mma(s_acc[j], a1, b1);
        M::load_b_nk2(b0, b1, vb, LD, wk + 8 * j, kk * M::K);
        M::mma(p_acc[j], c0, b0);
        M::mma(p_acc[j], c1, b1);
      }
    }

    // p, the keep mask and dS once per pair; s_acc becomes dS. Element e
    // of n8 tile j is row g + 8 (e >> 1), key wk + 8 j + 2 t + (e & 1).
    const float* bb = b_s + buf * BK;
    const bool edge = (causal && k0 + wk + BKH - 1 > q0 + wq + offset) || k0 + wk + BKH > sk;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, kl = wk + 8 * j + 2 * t + (e & 1);
        const int qi = q0 + wq + g + 8 * h2, ki = k0 + kl;
        const float b2 = brow != nullptr ? __fmul_rn(bb[kl], FLASH_LOG2E) : 0.f;
        float x = fmaf(s_acc[j][e], scale2, b2 - lse2[h2]);
        if (edge && causal && qi + offset < ki) x = FLASH_NEG_INF2 - lse2[h2];
        float p = flash_bwd_exp2(x);
        if (edge && ki >= sk) p = 0.f;
        float dp = p_acc[j][e];
        if (dropout_on)
          dp = attn_dropout_keep(seed, gbh, (uint32_t)qi, (uint32_t)ki, thresh) ? dp / drop_div
                                                                                 : 0.f;
        s_acc[j][e] = p * (dp - dl[h2]) * sm_scale;
      }

    // dQ += dS K over this warp's keys: the C fragments of dS are the A
    // operands, which a_from_c rounds to q's dtype
    flash_bwd_flush<T, BKH, DP, P::NF2, LD>(dq_acc, s_acc, kb, wk);
    if constexpr (S == 1) __syncthreads();  // the next copy overwrites the tile
  }

  // dQ = the first key half's sums + the second half's, in that order,
  // through the tile buffers once every warp is done with them
  if constexpr (S == 2) __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [BQ / 16][ND][4][32]
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[((rg * ND + n) * 4 + e) * 32 + lane] = dq_acc[n][e];
  }
  __syncthreads();
  if (kh == 1) return;
  const long long dqbase = bi * st.dqb + hi * st.dqh;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + wq + g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      if (qi < sq && col < d)
        dq[dqbase + (long long)qi * st.dqs + col] =
            attn_from_float<T>(dq_acc[n][e] + red[((rg * ND + n) * 4 + e) * 32 + lane]);
    }
}

template <typename T, int DP>
static int flash_bwd_launch(const void* q, const void* k, const void* v, const float* bias,
                            const void* dout, const float* lse, const float* delta, void* dq,
                            void* dk, void* dv, int B, int H, int sq, int sk, int d,
                            const AttnBwdStrides& st, float sm_scale, int causal,
                            int dropout_on, float drop_div, uint32_t thresh, AttnSeed seed,
                            int vec, cudaStream_t stream) {
  typedef FlashBwdTile<T, DP> P;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::SMEM1);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, DP><<<dim3(B * H, (sk + P::BK1 - 1) / P::BK1), P::NT, P::SMEM1,
                                stream>>>(qt, kt, vt, bias, ot, lse, delta,
                                          static_cast<T*>(dk), static_cast<T*>(dv), st, H,
                                          sq, sk, d, sm_scale, causal, dropout_on, drop_div,
                                          thresh, seed, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM2);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, DP><<<dim3(B * H, (sq + P::BQ2 - 1) / P::BQ2), P::NT, P::SMEM2,
                               stream>>>(qt, kt, vt, bias, ot, lse, delta,
                                         static_cast<T*>(dq), st, H, sq, sk, d, sm_scale,
                                         causal, dropout_on, drop_div, thresh, seed, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int flash_bwd_dispatch_d(const void* q, const void* k, const void* v,
                                const float* bias, const void* dout, const float* lse,
                                const float* delta, void* dq, void* dk, void* dv, int B,
                                int H, int sq, int sk, int d, const AttnBwdStrides& st,
                                float sm_scale, int causal, int dropout_on, float drop_div,
                                uint32_t thresh, AttnSeed seed, int vec, cudaStream_t s) {
  if (d <= 64)
    return flash_bwd_launch<T, 64>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, H, sq, sk,
                                   d, st, sm_scale, causal, dropout_on, drop_div, thresh,
                                   seed, vec, s);
  return flash_bwd_launch<T, 128>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, H, sq, sk,
                                  d, st, sm_scale, causal, dropout_on, drop_div, thresh,
                                  seed, vec, s);
}

// C entry point, bound with ctypes. dtype: ATTN_F32, ATTN_BF16 or ATTN_F16 (0,
// 1, 2), the type of q, k, v, dout and the grads. strides: 21 element strides
// (b, s, h) of q, k, v, dout, dq, dk, dv. bias: [B, sk] float32 or NULL. lse,
// delta: [B, H, sq] float32. drop_div = 1 - rate. Returns the cudaError_t of
// the launches (0 = success).
// The dropout seed: seed_val, or the word at seed_ptr in device memory when
// seed_ptr is not NULL (AttnSeed). heads_global / head0: the launch's H heads
// are heads [head0, head0 + H) of heads_global, whose global (batch, head)
// index the dropout hash takes (H and 0 for a whole launch).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* dk, void* dv, int dtype, int B, int H, int sq, int sk,
                         int d, const long long* strides, float sm_scale, int causal,
                         int dropout_on, float drop_div, unsigned int thresh,
                         int heads_global, int head0, unsigned int seed_val,
                         const unsigned int* seed_ptr,
                         void* stream) {
  const AttnSeed seed{seed_val, seed_ptr, heads_global, head0};
  if (!attn_heads_ok(H, heads_global, head0)) return (int)cudaErrorInvalidValue;
  if (d < 1 || d > ATTN_MAX_D || sq < 1 || sk < 1 || (sq + 31) / 32 > 65535 ||
      (sk + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnBwdStrides st = attn_bwd_strides_from(strides);
  // 16-byte copies need every row of q, k, v and dO to start 16-byte aligned
  const long long esz = attn_elem_size(dtype);
  bool vec = d % (16 / esz) == 0;
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && (strides[i] * esz) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ATTN_F32:
      return flash_bwd_dispatch_d<float>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, H, sq,
                                         sk, d, st, sm_scale, causal, dropout_on, drop_div,
                                         thresh, seed, vec, s);
    case ATTN_BF16:
      return flash_bwd_dispatch_d<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, dk, dv,
                                                 B, H, sq, sk, d, st, sm_scale, causal,
                                                 dropout_on, drop_div, thresh, seed, vec, s);
    case ATTN_F16:
      return flash_bwd_dispatch_d<__half>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, H,
                                          sq, sk, d, st, sm_scale, causal, dropout_on,
                                          drop_div, thresh, seed, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
