// ResNet fused-block 1x1 convolutions on the tensor cores: a matrix
// product with a fused batch-norm-apply prologue (#9), and a matrix
// product with the next batch norm's per-channel sums in its epilogue
// (#10). One GEMM template, fused_block_gemm_kernel<T, WM, WARPS_N,
// PROLOGUE, STATS>, with the two as its instantiations.
//
// Replaces: tools/fused_block_pallas.py, the Pallas kernels _prologue_kernel
// (reached from fused_prologue_conv1x1) and _stats_kernel (reached from
// conv1x1_with_stats), the two halves of the JAX package's fused-block A/B.
//
// Function. Prologue: z = relu(x * scale + shift + res), each operation
// rounded in fp32 as the Pallas body computes it, then z rounded to x's
// type; y = z @ w accumulated in fp32 and stored in x's type. Stats: y =
// x @ w accumulated in fp32 and stored in x's type, and per column
// sum(y) and sum(y * y) taken from the fp32 accumulator before the cast.
// x, res [M, K]; scale, shift [K] fp32; w [K, N]; y [M, N]; float32 or
// bf16.
//
// What bounds it on the H100: at the ResNet-50 b256 bottleneck shapes
// (M 802816 / 200704 / 50176, K 256 / 512 / 1024, N 64 / 128 / 256) each
// product is 26.3 GFLOP, 0.027 ms at the dense bf16 tensor-core rate,
// against 0.15-0.28 ms (stage 2) down to 0.04-0.07 ms (stage 4) for the
// bytes at 3.35 TB/s: the bytes bind at stages 2 and 3, and at stage 4 the
// two are level, where mma.sync (not wgmma) may bind first. fp32 runs as
// 3xTF32, three products for one: there the operations bind.
//
// Design. A block of 8 warps owns BM rows of y and all of its columns for
// N <= 256, so each row of x and res is read from device memory once
// (wider N is cut into 256-column blocks on the grid, which then reads x
// once for each). The warps tile the block as (BM / WM) x (N / 64), each a
// WM x 64 fp32 accumulator in registers; the wrapper picks WM and the
// warp columns from N and the type (ops/kernels/fused_block.py,
// fused_block_geometry), so the accumulators fit without spills. The
// block walks K in slices of 128 bytes of a row (64 bf16, 32 fp32): x's
// slice (and #9's res slice) and w's [slice, N] tile (w is at most 512 KB
// at these shapes: it stays in L2) go by 16-byte cp.async into a ring of
// two slices in shared memory, the next slice in flight while the block
// multiplies the current one. #9 then rewrites each thread's own chunks
// of x in place with z, each operation rounded in fp32 (__fmul_rn /
// __fadd_rn, no contraction) and the result rounded to T, before the
// block's barrier; scale and shift are read once a slice. x's slice lies
// in shared memory as rows whose 16-byte chunks are XOR-swizzled by row,
// so ldmatrix reads and 16-byte stores meet no bank conflict; w's rows
// are padded by 8 elements. bf16 multiplies with mma.sync m16n8k16; fp32
// as 3xTF32 on m16n8k8, each slice's products in a fresh accumulator
// that is then added to the running one in fp32 (the tensor cores
// truncate as they accumulate: 384 truncating additions to one output at
// K 1024 would come near the fp32 tolerance).
//
// #10's sums, deterministic and without atomics: each thread sums its
// rows of a column in row order (g, g + 8, g + 16, ...), the warp its 8
// row groups by xor shuffles over lanes 4, 8 and 16, the block its warps
// of a column in warp order, written as one partial row of [parts =
// ceil(M / BM), N] per block. A second launch sums each column's partial
// rows: 1024 threads a block, 8 columns x 128 splits, split s adding rows
// s, s + 128, ... in order, then a fixed tree over the splits. The same
// bits on every run; tests/test_torch_fused_block_tc.py mirrors the
// order on the CPU.
//
// Any M (rows masked). K and N that are multiples of 8 (bf16) or 4 (fp32),
// with 16-byte aligned tensors, take the 16-byte loads; any other K or N
// takes masked scalar loads in the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_common.cuh"

#ifndef FB_SLICE
#define FB_SLICE 128  // bytes of a row in one K-slice: 64, 128 or 256
#endif
#ifndef FB_STAGES
#define FB_STAGES 2  // K-slices in the shared-memory ring
#endif
#define FB_THREADS 256     // 8 warps
#define FB_RED_COLS 8      // the sum launch: columns a block
#define FB_RED_SPLITS 128  // and splits of a column's partial rows

// A block's shape: 8 warps as (8 / WARPS_N) x WARPS_N, each a WM x 64 tile
// of y; K walked in slices of FB_SLICE bytes of a row through a ring of
// FB_STAGES slices in shared memory, each holding x's slice, res's (#9,
// RES) and w's. (128-byte slices in a ring of two were the fastest of 64
// to 256 bytes and 2 to 4 slices at every shape of the A/B:
// tools/fused_block_probe.py builds the others with -D.)
template <typename T, int WM, int WARPS_N, bool RES>
struct FbTile {
  static constexpr int SLICE = FB_SLICE, STAGES = FB_STAGES;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int BM = WARPS_M * WM;  // rows a block
  static constexpr int NB = 64 * WARPS_N;  // columns a block
  static constexpr int C = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int BK = SLICE / (int)sizeof(T);  // slice depth
  static constexpr int WP = NB + 8;  // w tile row pitch (elements)
  static constexpr int A_BYTES = BM * SLICE;
  static constexpr int R_BYTES = RES ? A_BYTES : 0;
  static constexpr int W_BYTES = BK * WP * (int)sizeof(T);
  static constexpr int STAGE = A_BYTES + R_BYTES + W_BYTES;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int MT = WM / 16;  // m16 tiles a warp
  static constexpr int CPR = SLICE / 16;  // 16-byte chunks of a row's slice
  static constexpr int PASS = FB_THREADS / CPR;  // rows the block stages at once
  static constexpr int RPT = BM / PASS;  // rows a thread stages a slice
  static constexpr int WCH = BK * NB / C;  // 16-byte chunks of a w slice
  static_assert(SLICE == 64 || SLICE == 128 || SLICE == 256, "64- to 256-byte slices");
  static_assert(STAGES >= 2, "a ring of two slices at least");
  static_assert(BM % PASS == 0, "x slices are staged in whole passes");
  static_assert(WCH % FB_THREADS == 0, "w slice chunks split evenly");
  static_assert(2 * WARPS_M * NB * 4 <= SMEM, "the sums' scratch fits the ring");
  static_assert(SMEM <= 227 * 1024, "the ring fits a block's shared memory");
  // Byte offset of 16-byte chunk c of row r in an x slice: chunks XOR-
  // swizzled by row pair (64-byte rows) or by row (longer rows, within
  // each 128 bytes), so 8 rows at one chunk (an ldmatrix matrix) and 128
  // bytes of neighbouring chunks (8 lanes' 16-byte stores) each cover the
  // 32 banks.
  static __device__ __forceinline__ int a_off(int r, int c) {
    return r * SLICE + ((c ^ (SLICE == 64 ? (r >> 1) & 3 : r & 7)) << 4);
  }
};

// A 32-bit word of T <-> P floats
template <typename T>
struct FbChunk;

template <>
struct FbChunk<float> {
  typedef uint32_t Bits;
  static constexpr int P = 1;
  static __device__ __forceinline__ void unpack(uint32_t u, float (&f)[1]) {
    f[0] = __uint_as_float(u);
  }
  static __device__ __forceinline__ uint32_t pack(const float (&f)[1]) {
    return __float_as_uint(f[0]);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct FbChunk<__nv_bfloat16> {
  typedef uint16_t Bits;
  static constexpr int P = 2;  // the lower index in the low half
  static __device__ __forceinline__ void unpack(uint32_t u, float (&f)[2]) {
    f[0] = __uint_as_float(u << 16);
    f[1] = __uint_as_float(u & 0xFFFF0000u);
  }
  static __device__ __forceinline__ uint32_t pack(const float (&f)[2]) {
    return mma_pack_bf16(f[0], f[1]);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = mma_pack_bf16(a, b);
  }
};

// The scalar path: elements col .. col + C - 1 of row `row` of a [*, width]
// matrix as 16 bytes, zero past the width or where !row_ok.
template <typename T>
__device__ __forceinline__ uint4 fb_gather(const T* p, long long row, bool row_ok, int width,
                                           int col) {
  typedef typename FbChunk<T>::Bits U;
  constexpr int C = 16 / (int)sizeof(T);
  const U* q = reinterpret_cast<const U*>(p) + row * width;
  U e[C];
#pragma unroll
  for (int j = 0; j < C; ++j) e[j] = (row_ok && col + j < width) ? q[col + j] : (U)0;
  uint4 v;
  memcpy(&v, e, 16);
  return v;
}

// ---- fragments by type --------------------------------------------------
// load_a: the A fragment at byte offset `off` of a swizzled x slice (this
// lane's row address of an x4 ldmatrix) by one ldmatrix (fp32: 8 rows x 4
// floats a matrix, the m16n8k8 TF32 layout; then split hi / lo); load_b2:
// two n8 tiles of B from the [k][n] w tile (bf16 one ldmatrix.trans; fp32
// four loads, conflict-free as the pitch is 8 mod 32 floats).
template <typename T>
struct FbOps;

template <>
struct FbOps<__nv_bfloat16> {
  typedef MmaOps<__nv_bfloat16> Ops;
  typedef Ops::A A;
  typedef Ops::B B;
  static constexpr int KS = 16;
  static __device__ __forceinline__ void load_a(A& a, const char* As, int off) {
    ldmatrix_x4(a.x, As + off);
  }
  static __device__ __forceinline__ void load_b2(B& b0, B& b1, const __nv_bfloat16* Ws, int ld,
                                                 int k0, int n0) {
    Ops::load_b_kn2(b0, b1, Ws, ld, k0, n0);
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    Ops::mma(c, a, b);
  }
};

template <>
struct FbOps<float> {
  typedef MmaOps<float> Ops;
  typedef Ops::A A;
  typedef Ops::B B;
  static constexpr int KS = 8;
  static __device__ __forceinline__ void load_a(A& a, const char* As, int off) {
    uint32_t v[4];
    ldmatrix_x4(v, As + off);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_split_tf32(__uint_as_float(v[j]), a.hi[j], a.lo[j]);
  }
  // b0 (k t, n g), b1 (k t + 4, n g) of tiles n0 and n0 + 8
  static __device__ __forceinline__ void load_b2(B& b0, B& b1, const float* Ws, int ld, int k0,
                                                 int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = Ws + (k0 + t) * ld + n0 + g;
    mma_split_tf32(p[0], b0.hi[0], b0.lo[0]);
    mma_split_tf32(p[4 * ld], b0.hi[1], b0.lo[1]);
    mma_split_tf32(p[8], b1.hi[0], b1.lo[0]);
    mma_split_tf32(p[4 * ld + 8], b1.hi[1], b1.lo[1]);
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    Ops::mma(c, a, b);
  }
};

// ---- staging -------------------------------------------------------------
// Thread tid stages 16-byte chunk tid % CPR of rows tid / CPR + PASS i.

// x's (or res's) slice k0 by cp.async (the scalar path by plain loads)
template <typename T, class G>
__device__ __forceinline__ void fb_load_x(char* As, const T* __restrict__ x, int m0, int M, int K,
                                          int k0, bool vec) {
  const int c = threadIdx.x % G::CPR, k = k0 + c * G::C;
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    const int r = threadIdx.x / G::CPR + G::PASS * i, m = m0 + r;
    char* dst = As + G::a_off(r, c);
    if (vec) {
      const bool ok = m < M && k < K;
      cp_async16(dst, ok ? x + (long long)m * K + k : x, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst) = fb_gather(x, m, m < M, K, k);
    }
  }
}

// E floats of p from index k: zero past K (the vector path: a multiple of
// E, wholly inside or past K, 4 E-byte aligned)
template <int E>
__device__ __forceinline__ void fb_load_floats(float (&f)[E], const float* __restrict__ p, int k,
                                               int K, bool vec) {
  if (vec) {
    if constexpr (E == 4) {
      const float4 v = k < K ? __ldg(reinterpret_cast<const float4*>(p + k))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else {
      const float2 v = k < K ? __ldg(reinterpret_cast<const float2*>(p + k)) : make_float2(0.f, 0.f);
      f[0] = v.x, f[1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = k + j < K ? __ldg(p + k + j) : 0.f;
  }
}

// #9: z = relu(x * scale + shift + res) of the thread's own chunks of slice
// k0, each operation rounded in fp32 (no contraction), rounded to T, in
// place of x; zero in rows past M and columns past K. Its own cp.async
// copies are complete and visible to the thread after cp_async_wait; the
// block's barrier follows. Half a chunk (two words) at a time, scale and
// shift read once for it: few registers beside the accumulators (#9 at
// 64 of them a warp fits 128 registers without spills).
template <typename T, class G>
__device__ __forceinline__ void fb_transform(char* As, const char* Rs,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ shift, int m0, int M,
                                             int K, int k0, bool vec) {
  constexpr int P = FbChunk<T>::P, E = 2 * P;  // elements a word, half a chunk
  const int c = threadIdx.x % G::CPR;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sc[E], sh[E];
    fb_load_floats<E>(sc, scale, k0 + c * G::C + h * E, K, vec);
    fb_load_floats<E>(sh, shift, k0 + c * G::C + h * E, K, vec);
#pragma unroll
    for (int i = 0; i < G::RPT; ++i) {
      const int r = threadIdx.x / G::CPR + G::PASS * i;
      const bool live = m0 + r < M;
      uint2* p = reinterpret_cast<uint2*>(As + G::a_off(r, c)) + h;
      const uint2 xv = *p, rv = *(reinterpret_cast<const uint2*>(Rs + G::a_off(r, c)) + h);
      const uint32_t xw[2] = {xv.x, xv.y}, rw[2] = {rv.x, rv.y};
      uint32_t zw[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float xf[P], rf[P], z[P];
        FbChunk<T>::unpack(xw[q], xf);
        FbChunk<T>::unpack(rw[q], rf);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float v = __fadd_rn(__fmul_rn(xf[j], sc[P * q + j]), sh[P * q + j]);
          z[j] = live ? fmaxf(__fadd_rn(v, rf[j]), 0.f) : 0.f;
        }
        zw[q] = FbChunk<T>::pack(z);
      }
      *p = make_uint2(zw[0], zw[1]);
    }
  }
}

// w's slice k0, columns n0 .. n0 + NB, into its [BK][WP] tile
template <typename T, class G>
__device__ __forceinline__ void fb_load_w(T* Ws, const T* __restrict__ w, int k0, int K, int N,
                                          int n0, bool vec) {
#pragma unroll
  for (int i = 0; i < G::WCH / FB_THREADS; ++i) {
    const int idx = threadIdx.x + FB_THREADS * i;
    const int kk = idx / (G::NB / G::C), cc = (idx % (G::NB / G::C)) * G::C;
    const int k = k0 + kk, n = n0 + cc;
    T* dst = Ws + kk * G::WP + cc;
    if (vec) {
      const bool ok = k < K && n < N;
      cp_async16(dst, ok ? w + (long long)k * N + n : w, ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst) = fb_gather(w, k, k < K, N, n);
    }
  }
}

// The products of one slice: warp rows wrow.., columns wcol .. wcol + 64.
template <typename T, class G>
__device__ __forceinline__ void fb_mma_slice(float (&acc)[G::MT][8][4], const char* As,
                                             const T* Ws, int wrow, int wcol) {
  typedef FbOps<T> O;
  const int lane = threadIdx.x & 31;
  // ldmatrix: lanes 8 j .. 8 j + 7 address matrix j: rows + 8 (j & 1),
  // chunk + (j >> 1)
  const int ar = wrow + (lane & 7) + 8 * ((lane >> 3) & 1), ac = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < G::BK / O::KS; ++ks) {
    typename O::A a[G::MT];
#pragma unroll
    for (int mi = 0; mi < G::MT; ++mi) O::load_a(a[mi], As, G::a_off(ar + 16 * mi, 2 * ks + ac));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      typename O::B b0, b1;
      O::load_b2(b0, b1, Ws, G::WP, ks * O::KS, wcol + 16 * np);
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        O::mma(acc[mi][2 * np], a[mi], b0);
        O::mma(acc[mi][2 * np + 1], a[mi], b1);
      }
    }
  }
}

// two blocks an SM where a warp holds 64 bf16-product accumulators and two
// rings fit the SM's shared memory
template <typename T, int WM, int WARPS_N, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(FB_THREADS, (sizeof(T) == 2 && WM <= 32 &&
                                               2 * FbTile<T, WM, WARPS_N, PROLOGUE>::SMEM <=
                                                   227 * 1024)
                                                  ? 2
                                                  : 1)
fused_block_gemm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift, const T* __restrict__ res,
                        const T* __restrict__ w, T* __restrict__ y,
                        float* __restrict__ part_sum, float* __restrict__ part_sumsq, int M,
                        int K, int N, int vec) {
  typedef FbTile<T, WM, WARPS_N, PROLOGUE> G;
  constexpr int STAGES = G::STAGES;
  extern __shared__ __align__(128) char fb_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = (warp / WARPS_N) * WM, wcol = (warp % WARPS_N) * 64;
  const int m0 = blockIdx.x * G::BM, n0 = blockIdx.y * G::NB;
  const int S = (K + G::BK - 1) / G::BK;
  auto a_tile = [&](int s) { return fb_smem + (s % STAGES) * G::STAGE; };
  auto r_tile = [&](int s) { return fb_smem + (s % STAGES) * G::STAGE + G::A_BYTES; };
  auto w_tile = [&](int s) {
    return reinterpret_cast<T*>(fb_smem + (s % STAGES) * G::STAGE + G::A_BYTES + G::R_BYTES);
  };
  auto load = [&](int s) {  // slice s's x (and res) and w into the ring
    fb_load_x<T, G>(a_tile(s), x, m0, M, K, s * G::BK, vec);
    if (PROLOGUE) fb_load_x<T, G>(r_tile(s), res, m0, M, K, s * G::BK, vec);
    fb_load_w<T, G>(w_tile(s), w, s * G::BK, K, N, n0, vec);
  };

  float acc[G::MT][8][4];
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < S) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < S; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice s are in
    if (PROLOGUE)
      fb_transform<T, G>(a_tile(s), r_tile(s), scale, shift, m0, M, K, s * G::BK, vec);
    __syncthreads();
    // the buffer of slice s + STAGES - 1 was read in slice s - 1
    if (s + STAGES - 1 < S) load(s + STAGES - 1);
    cp_async_commit();
    if constexpr (sizeof(T) == 4) {
      // 3xTF32: the slice's products in a fresh accumulator, added in fp32
      float part[G::MT][8][4];
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mi][ni][j] = 0.f;
      fb_mma_slice<T, G>(part, a_tile(s), w_tile(s), wrow, wcol);
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = __fadd_rn(acc[mi][ni][j], part[mi][ni][j]);
    } else {
      fb_mma_slice<T, G>(acc, a_tile(s), w_tile(s), wrow, wcol);
    }
  }

  // y: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, 2t..2t+1) of each tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wrow + 16 * mi + 8 * h + g;
      if (row >= M) continue;
      T* yr = y + (long long)row * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wcol + 8 * ni + 2 * t;
        const float a = acc[mi][ni][2 * h], b = acc[mi][ni][2 * h + 1];
        if (vec) {
          if (col < N) FbChunk<T>::store2(yr + col, a, b);
        } else {
          if (col < N) yr[col] = attn_from_float<T>(a);
          if (col + 1 < N) yr[col + 1] = attn_from_float<T>(b);
        }
      }
    }

  if (STATS) {
    // rows past M hold zeros (their x was zero-filled): adding them is exact
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    float* red = reinterpret_cast<float*>(fb_smem);  // [2][WARPS_M][NB]
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[mi][ni][2 * h + j];
            s = __fadd_rn(s, v);
            q = __fadd_rn(q, __fmul_rn(v, v));
          }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
          q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, o));
        }
        if (g == 0) {
          const int col = wcol + 8 * ni + 2 * t + j, wm = warp / WARPS_N;
          red[wm * G::NB + col] = s;
          red[(G::WARPS_M + wm) * G::NB + col] = q;
        }
      }
    __syncthreads();
    for (int col = threadIdx.x; col < G::NB; col += FB_THREADS) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int wm = 0; wm < G::WARPS_M; ++wm) {
        s = __fadd_rn(s, red[wm * G::NB + col]);
        q = __fadd_rn(q, red[(G::WARPS_M + wm) * G::NB + col]);
      }
      const int n = n0 + col;
      if (n < N) {
        part_sum[(long long)blockIdx.x * N + n] = s;
        part_sumsq[(long long)blockIdx.x * N + n] = q;
      }
    }
  }
}

// sum[n] and sumsq[n] over the [parts, N] partial rows: a block takes 8
// columns; thread (split p, column c) adds rows p, p + 128, ... in order,
// 8 neighbouring threads reading one 32-byte sector of a row; then a fixed
// tree over the 128 splits
__global__ void __launch_bounds__(FB_RED_COLS * FB_RED_SPLITS)
fused_block_stats_reduce_kernel(const float* __restrict__ part_sum,
                                const float* __restrict__ part_sumsq, int parts, int N,
                                float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float rs[FB_RED_SPLITS][FB_RED_COLS], rq[FB_RED_SPLITS][FB_RED_COLS];
  const int c = threadIdx.x % FB_RED_COLS, p = threadIdx.x / FB_RED_COLS;
  const int n = blockIdx.x * FB_RED_COLS + c;
  float a = 0.f, b = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int i = p; i < parts; i += FB_RED_SPLITS) {
      a = __fadd_rn(a, part_sum[(long long)i * N + n]);
      b = __fadd_rn(b, part_sumsq[(long long)i * N + n]);
    }
  }
  rs[p][c] = a;
  rq[p][c] = b;
#pragma unroll
  for (int h = FB_RED_SPLITS / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (p < h) {
      rs[p][c] = __fadd_rn(rs[p][c], rs[p + h][c]);
      rq[p][c] = __fadd_rn(rq[p][c], rq[p + h][c]);
    }
  }
  if (p == 0 && n < N) {
    sum[n] = rs[0][c];
    sumsq[n] = rq[0][c];
  }
}

template <typename T, int WM, int WARPS_N, bool PROLOGUE, bool STATS>
static int fb_launch(const void* x, const float* scale, const float* shift, const void* res,
                     const void* w, void* y, float* part_sum, float* part_sumsq, int M, int K,
                     int N, int vec, cudaStream_t stream) {
  typedef FbTile<T, WM, WARPS_N, PROLOGUE> G;
  auto kern = fused_block_gemm_kernel<T, WM, WARPS_N, PROLOGUE, STATS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + G::BM - 1) / G::BM, (N + G::NB - 1) / G::NB);
  kern<<<grid, FB_THREADS, G::SMEM, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<T*>(y), part_sum, part_sumsq, M, K, N, vec);
  return (int)cudaGetLastError();
}

// The geometries built, (WM, warp columns) by type, as
// ops/kernels/fused_block.py's fused_block_geometry picks them.
template <typename T, bool PROLOGUE, bool STATS>
static int fb_dispatch(int wm, int warps_n, const void* x, const float* scale,
                       const float* shift, const void* res, const void* w, void* y,
                       float* part_sum, float* part_sumsq, int M, int K, int N, int vec,
                       cudaStream_t s) {
#define FB_CASE(WM_, WN_)                                                                   \
  if (wm == WM_ && warps_n == WN_)                                                          \
    return fb_launch<T, WM_, WN_, PROLOGUE, STATS>(x, scale, shift, res, w, y, part_sum, \
                                                   part_sumsq, M, K, N, vec, s);
  if constexpr (sizeof(T) == 2) {
    FB_CASE(32, 1) FB_CASE(32, 2) FB_CASE(64, 4)
  } else {
    FB_CASE(32, 1) FB_CASE(32, 2) FB_CASE(32, 4)
  }
#undef FB_CASE
  return (int)cudaErrorInvalidValue;
}

static bool fb_aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// C entry points, bound with ctypes; each returns the cudaError_t of its
// launches (0 = success; cudaErrorInvalidValue for a geometry not built).
// All tensors contiguous; x, res, w, y of one type (is_bf16), scale, shift
// and the sums float32. wm, warps_n: the block geometry (rows a block =
// (8 / warps_n) * wm, columns 64 * warps_n).

// y [M, N] = (relu(x * scale + shift + res) rounded to x's type) @ w
extern "C" int fused_prologue_conv1x1(const void* x, const float* scale, const float* shift,
                                      const void* res, const void* w, void* y, int is_bf16,
                                      int M, int K, int N, int wm, int warps_n, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int c = is_bf16 ? 8 : 4;
  const int vec = K % c == 0 && N % c == 0 && fb_aligned(x) && fb_aligned(res) &&
                  fb_aligned(w) && fb_aligned(y) && fb_aligned(scale) && fb_aligned(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fb_dispatch<__nv_bfloat16, true, false>(wm, warps_n, x, scale, shift, res, w, y,
                                                   nullptr, nullptr, M, K, N, vec, s);
  return fb_dispatch<float, true, false>(wm, warps_n, x, scale, shift, res, w, y, nullptr,
                                         nullptr, M, K, N, vec, s);
}

// y [M, N] = x @ w; sum, sumsq [N] over the rows of the fp32 product;
// part_sum, part_sumsq: [parts, N] scratch, parts = ceil(M / rows a block)
extern "C" int conv1x1_with_stats(const void* x, const void* w, void* y, float* part_sum,
                                  float* part_sumsq, float* sum, float* sumsq, int is_bf16,
                                  int M, int K, int N, int wm, int warps_n, int parts,
                                  void* stream) {
  if (M < 1 || K < 1 || N < 1 || warps_n < 1 || 8 % warps_n != 0) return (int)cudaErrorInvalidValue;
  const int bm = (8 / warps_n) * wm;
  if (bm < 1 || parts != (M + bm - 1) / bm) return (int)cudaErrorInvalidValue;
  const int c = is_bf16 ? 8 : 4;
  const int vec = K % c == 0 && N % c == 0 && fb_aligned(x) && fb_aligned(w) && fb_aligned(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = is_bf16 ? fb_dispatch<__nv_bfloat16, false, true>(wm, warps_n, x, nullptr, nullptr,
                                                              nullptr, w, y, part_sum,
                                                              part_sumsq, M, K, N, vec, s)
                    : fb_dispatch<float, false, true>(wm, warps_n, x, nullptr, nullptr, nullptr,
                                                      w, y, part_sum, part_sumsq, M, K, N, vec,
                                                      s);
  if (err != 0) return err;
  fused_block_stats_reduce_kernel<<<(N + FB_RED_COLS - 1) / FB_RED_COLS,
                                    FB_RED_COLS * FB_RED_SPLITS, 0, s>>>(
      part_sum, part_sumsq, parts, N, sum, sumsq);
  return (int)cudaGetLastError();
}
