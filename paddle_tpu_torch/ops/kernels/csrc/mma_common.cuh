// Warp-level tensor-core and async-copy helpers for Hopper (sm_90a), in
// inline PTX: mma.sync m16n8k8 TF32 and m16n8k16 bf16 / fp16 with fp32
// accumulation, the TF32 rounding and the 3xTF32 split, cp.async copies
// of 16 and 4 bytes, strided row tiles into shared memory, and fragment
// loads from shared tiles.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16";
// the same as cute/arch/mma_sm80.hpp), with g = lane / 4, t = lane % 4:
//   C / D (both shapes): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   A tf32 m16n8k8:  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B tf32:          b0 (k t, n g), b1 (k t+4, n g)
//   A bf16 m16n8k16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B bf16:          b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
// Each bf16 register holds the lower k index in its low half. fp16's
// m16n8k16 fragments are laid out as bf16's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attn_common.cuh"  // attn_from_float

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero:
// half a TF32 ulp added to the magnitude, the low 13 bits dropped. Bit for
// bit what cvt.rna.tf32.f32 gives a finite float (held against it on the
// card by tests/test_torch_short_fwd_tc.py), in two integer operations
// rather than the conversion instruction: with them the fp32 short and
// flash forwards ran 14-18% faster on an H100.
__device__ __forceinline__ uint32_t mma_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo with hi, lo TF32: hi * b_hi + hi * b_lo + lo * b_hi keeps
// an fp32 product to about 2^-22 of its size (3xTF32).
__device__ __forceinline__ void mma_split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = mma_tf32(x);
  lo = mma_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32_m16n8k8(float c[4], const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_m16n8k16(float c[4], const uint32_t a[4],
                                                  const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16_m16n8k16(float c[4], const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats, each already a bf16 value or rounded to one (to nearest
// even), packed with `lo` in the low half.
__device__ __forceinline__ uint32_t mma_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t mma_pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The same for fp16: each float rounded to nearest even, a magnitude past
// fp16's largest finite value (65504) to inf, as astype(float16) rounds.
__device__ __forceinline__ uint32_t mma_pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t mma_pack_f16(__half lo, __half hi) {
  return (uint32_t)__half_as_ushort(lo) | ((uint32_t)__half_as_ushort(hi) << 16);
}

// the m16n8k16 product and the float pair packing of a 16-bit type
template <typename T>
struct Mma16;
template <>
struct Mma16<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    mma_bf16_m16n8k16(c, a, b);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return mma_pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return mma_pack_bf16(lo, hi);
  }
};
template <>
struct Mma16<__half> {
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    mma_f16_m16n8k16(c, a, b);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return mma_pack_f16(lo, hi);
  }
  static __device__ __forceinline__ uint32_t pack(__half lo, __half hi) {
    return mma_pack_f16(lo, hi);
  }
};

// cp.async of 16 bytes from device to shared memory; src_bytes 0 writes
// 16 zero bytes and reads nothing (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// cp.async of 4 bytes (cached at all levels); src_bytes 0 writes zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [s0, s0 + ROWS) of one (b, h) slice into a [ROWS][LD] shared tile,
// columns [0, DP): rows at or past `valid` and columns at or past d are
// zero. vec: 16-byte cp.async (rows, base and d 16-byte aligned), else a
// scalar copy.
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void mma_load_rows(T* dst, const T* src, long long base,
                                              long long s_stride, int s0, int valid, int d,
                                              bool vec) {
  if (vec) {
    constexpr int C = 16 / sizeof(T);
    constexpr int CPR = DP / C;
    for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
      const int r = idx / CPR, c = (idx % CPR) * C;
      const bool ok = s0 + r < valid && c < d;
      cp_async16(dst + r * LD + c, ok ? src + base + (long long)(s0 + r) * s_stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      T x = attn_from_float<T>(0.f);
      if (s0 + r < valid && c < d) x = src[base + (long long)(s0 + r) * s_stride + c];
      dst[r * LD + c] = x;
    }
  }
}

// ldmatrix of four 8 x 8 b16 matrices; lanes 8 m .. 8 m + 7 give the row
// addresses of matrix m, which lands in r[m]: row g, columns 2t, 2t+1
// (.trans: column g, rows 2t, 2t+1), the lower index in the low half.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---- fragments by input type ---------------------------------------------
// MmaOps<T>: the product step for T (float: 3xTF32 on m16n8k8, bf16 and
// fp16: one m16n8k16) and its fragment loads from shared tiles of T with
// row stride ld (elements):
//   load_a     A row-major [m][k], rows m0.., depth k0..
//   load_b_nk  B stored [n][k] (the k axis contiguous)
//   load_b_kn  B stored [k][n]; for float it reads rows k0 + 2t, 2t + 1
//              as the k indices t, t + 4, the order of a_from_c
//   load_a_kn  A row-major in the k order of load_b_kn
//   a_from_c   A from C fragments of this warp: K / 8 n8 tiles of an
//              accumulator become the k-step's A (rows kept, columns as k)
//   load_b_nk2 load_b_nk at k-steps k0 and k0 + K
//   load_b_kn2 load_b_kn at n-tiles n0 and n0 + 8
// (the 16-bit types' pairs are one ldmatrix each; rows 16-byte aligned)
template <typename T>
struct MmaOps;

template <>
struct MmaOps<float> {
  static constexpr int K = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    mma_tf32_m16n8k8(c, a.lo, b.hi);
    mma_tf32_m16n8k8(c, a.hi, b.lo);
    mma_tf32_m16n8k8(c, a.hi, b.hi);
  }
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld, int m0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (m0 + g) * ld + k0 + t;
    mma_split_tf32(p[0], a.hi[0], a.lo[0]);
    mma_split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
    mma_split_tf32(p[4], a.hi[2], a.lo[2]);
    mma_split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void load_a_kn(A& a, const float* s, int ld, int m0,
                                                   int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float2 x = *reinterpret_cast<const float2*>(s + (m0 + g) * ld + k0 + 2 * t);
    const float2 y = *reinterpret_cast<const float2*>(s + (m0 + g + 8) * ld + k0 + 2 * t);
    mma_split_tf32(x.x, a.hi[0], a.lo[0]);
    mma_split_tf32(y.x, a.hi[1], a.lo[1]);
    mma_split_tf32(x.y, a.hi[2], a.lo[2]);
    mma_split_tf32(y.y, a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void load_b_nk(B& b, const float* s, int ld, int n0,
                                                   int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (n0 + g) * ld + k0 + t;
    mma_split_tf32(p[0], b.hi[0], b.lo[0]);
    mma_split_tf32(p[4], b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ void load_b_kn(B& b, const float* s, int ld, int k0,
                                                   int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = s + (k0 + 2 * t) * ld + n0 + g;
    mma_split_tf32(p[0], b.hi[0], b.lo[0]);
    mma_split_tf32(p[ld], b.hi[1], b.lo[1]);
  }
  static __device__ __forceinline__ void load_b_nk2(B& b0, B& b1, const float* s, int ld,
                                                    int n0, int k0) {
    load_b_nk(b0, s, ld, n0, k0);
    load_b_nk(b1, s, ld, n0, k0 + K);
  }
  static __device__ __forceinline__ void load_b_kn2(B& b0, B& b1, const float* s, int ld,
                                                    int k0, int n0) {
    load_b_kn(b0, s, ld, k0, n0);
    load_b_kn(b1, s, ld, k0, n0 + 8);
  }
  // one n8 tile: c0 (g, 2t) -> k t, c1 (g, 2t+1) -> k t+4
  static __device__ __forceinline__ void a_from_c(A& a, const float (*c)[4]) {
    mma_split_tf32(c[0][0], a.hi[0], a.lo[0]);
    mma_split_tf32(c[0][2], a.hi[1], a.lo[1]);
    mma_split_tf32(c[0][1], a.hi[2], a.lo[2]);
    mma_split_tf32(c[0][3], a.hi[3], a.lo[3]);
  }
};

// bf16 and fp16: the same loads (ldmatrix moves any 16-bit type), the
// product and the packing of the type
template <typename T16>
struct MmaOps16 {
  static constexpr int K = 16;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    Mma16<T16>::mma(c, a.x, b.x);
  }
  static __device__ __forceinline__ uint32_t word(const T16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void load_a(A& a, const T16* s, int ld, int m0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T16* p = s + (m0 + g) * ld + k0 + 2 * t;
    a.x[0] = word(p);
    a.x[1] = word(p + 8 * ld);
    a.x[2] = word(p + 8);
    a.x[3] = word(p + 8 * ld + 8);
  }
  static __device__ __forceinline__ void load_a_kn(A& a, const T16* s, int ld, int m0,
                                                   int k0) {
    load_a(a, s, ld, m0, k0);
  }
  static __device__ __forceinline__ void load_b_nk(B& b, const T16* s, int ld, int n0,
                                                   int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T16* p = s + (n0 + g) * ld + k0 + 2 * t;
    b.x[0] = word(p);
    b.x[1] = word(p + 8);
  }
  static __device__ __forceinline__ void load_b_kn(B& b, const T16* s, int ld, int k0,
                                                   int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T16* p = s + (k0 + 2 * t) * ld + n0 + g;
    b.x[0] = Mma16<T16>::pack(p[0], p[ld]);
    b.x[1] = Mma16<T16>::pack(p[8 * ld], p[9 * ld]);
  }
  // matrices: rows n0.., columns k0, k0 + 8, k0 + 16, k0 + 24
  static __device__ __forceinline__ void load_b_nk2(B& b0, B& b1, const T16* s, int ld,
                                                    int n0, int k0) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldmatrix_x4(r, s + (n0 + (lane & 7)) * ld + k0 + 8 * (lane >> 3));
    b0.x[0] = r[0];
    b0.x[1] = r[1];
    b1.x[0] = r[2];
    b1.x[1] = r[3];
  }
  // matrices (transposed): rows k0.. and k0 + 8.., columns n0 and n0 + 8
  static __device__ __forceinline__ void load_b_kn2(B& b0, B& b1, const T16* s, int ld,
                                                    int k0, int n0) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    uint32_t r[4];
    ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + 8 * (m & 1)) * ld + n0 + 8 * (m >> 1));
    b0.x[0] = r[0];
    b0.x[1] = r[1];
    b1.x[0] = r[2];
    b1.x[1] = r[3];
  }
  // two n8 tiles make one k16 step; each value rounds to the type here
  static __device__ __forceinline__ void a_from_c(A& a, const float (*c)[4]) {
    a.x[0] = Mma16<T16>::pack(c[0][0], c[0][1]);
    a.x[1] = Mma16<T16>::pack(c[0][2], c[0][3]);
    a.x[2] = Mma16<T16>::pack(c[1][0], c[1][1]);
    a.x[3] = Mma16<T16>::pack(c[1][2], c[1][3]);
  }
};

template <>
struct MmaOps<__nv_bfloat16> : MmaOps16<__nv_bfloat16> {};
template <>
struct MmaOps<__half> : MmaOps16<__half> {};
