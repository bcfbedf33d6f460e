// Blocked attention backward, any sequence length: dQ, dK and dV.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, the Pallas kernels
// _bwd_dq_kernel / _bwd_dq_nobias (dQ) and _bwd_dkv_kernel /
// _bwd_dkv_nobias (dK, dV), reached from _bwd_pallas. The TPU kernels walk
// a sequential grid axis (key blocks for dQ, query blocks for dK / dV) and
// carry the sums in VMEM scratch; here that axis is a loop inside the
// block, with the sums in registers.
//
// Function: the two Pallas kernels' (flash_attention.py:227-371), with
// p = exp(s - lse) from the forward's unclamped lse, kept dropout values
// divided by (1 - rate), and the bottom-right causal offset sk - sq;
// ragged keys are masked in the kernel where the JAX path pads them with
// a NEG_INF bias (_pad_inputs), which gives them p == 0: the same function.
// See attn_bwd.cuh.
//
// What bounds it on the H100: at b 2, h 12, s 2048, d 64, causal, the live
// pairs need 10 d operations each, ~32 GFLOP, against ~25 MB of tensors:
// 0.48 ms of fp32 FMA time against 7.5 us of bytes, so the operations
// bound it. This first version multiplies on the FMA units from shared
// memory and skips the key (dQ pass) or query (dK / dV pass) tiles that the
// causal mask hides entirely; tensor cores are later work.
#include "attn_bwd.cuh"

// C entry point, bound with ctypes: the arguments of mha_short_bwd, with
// drop_div = 1 - rate. Returns the cudaError_t of the launches.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* dk, void* dv, int is_bf16, int B, int H, int sq, int sk,
                         int d, const long long* strides, float sm_scale, int causal,
                         int dropout_on, float drop_div, unsigned int thresh,
                         unsigned int seed, void* stream) {
  if (d < 1 || d > ATTN_MAX_D || sq < 1 || sk < 1) return (int)cudaErrorInvalidValue;
  return attn_bwd_launch<true>(q, k, v, bias, dout, lse, delta, dq, dk, dv, is_bf16, B, H,
                               sq, sk, d, strides, sm_scale, causal, dropout_on, drop_div,
                               thresh, seed, stream);
}
