// Short-sequence attention backward (sq, sk <= 512): dQ, dK and dV from
// the saved lse and delta.
//
// Replaces: paddle_tpu/ops/pallas/mha_short.py, the Pallas kernels
// _bwd_kernel_bshd / _bwd_bshd_nobias (bshd, reached from
// _short_core_bshd_bwd) and _bwd_kernel / _bwd_nobias (head-major, from
// _short_core_bwd), which share _bwd_math. One kernel pair serves both
// layouts through the strides it is given.
//
// Function: _bwd_math (mha_short.py:149-177), with p = exp(s - lse) from
// the forward's clamped lse (a fully masked row gives 0) and kept dropout
// values scaled by p * (1 / (1 - rate)); see attn_bwd.cuh.
//
// What bounds it on the H100: at BERT's training shape (b 8, h 12, s 128,
// d 64, fp32) it does 10 sq sk d operations per head, 1.0 GFLOP, against
// ~3 MB of q, k, v, dO, dQ, dK, dV; 15 us of fp32 FMA time against 1 us
// of bytes, so the operations bound it. This first version multiplies on
// the FMA units from shared memory, two passes that each recompute
// S = Q K^T and dP = dO V^T (14 sq sk d operations in all); tensor cores
// are later work.
#include "attn_bwd.cuh"

// C entry point, bound with ctypes. strides: 21 element strides (b, s, h)
// of q, k, v, dout, dq, dk, dv. bias: [B, sk] float32 or NULL. lse, delta:
// [B, H, sq] float32. Returns the cudaError_t of the launches (0 = success).
extern "C" int mha_short_bwd(const void* q, const void* k, const void* v, const float* bias,
                             const void* dout, const float* lse, const float* delta,
                             void* dq, void* dk, void* dv, int is_bf16, int B, int H,
                             int sq, int sk, int d, const long long* strides,
                             float sm_scale, int causal, int dropout_on, float drop_mul,
                             unsigned int thresh, unsigned int seed, void* stream) {
  if (d < 1 || d > ATTN_MAX_D || sq < 1 || sk < 1 || sq > 512 || sk > 512)
    return (int)cudaErrorInvalidValue;
  return attn_bwd_launch<false>(q, k, v, bias, dout, lse, delta, dq, dk, dv, is_bf16, B, H,
                                sq, sk, d, strides, sm_scale, causal, dropout_on, drop_mul,
                                thresh, seed, stream);
}
