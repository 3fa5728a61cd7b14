// Shared pieces of the three flash-attention kernels (forward, dQ, dK/dV).
//
// Layout contract (set by petastorm_tpu_torch/ops/flash_attention.py):
//   q, dout, o, dq : [B, Tq,  H,   D] contiguous, input dtype (f32 or bf16)
//   k, v, dk, dv   : [B, Tkv, Hkv, D] contiguous, input dtype
//   lse, delta     : [B*H, Tq] f32 (bh = b*H + h)
//   qseg / kvseg   : [B, Tq] / [B, Tkv] int32, or null (no segment mask)
//   kv_lens        : [B] int32, or null (static bound Tkv)
//
// All three keep tiles in shared memory in the input dtype and run their
// products on the tensor cores at f32 grade (flash_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ptt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The mask every kernel applies to score (row, col): keys past the valid
// bound, keys after the causal diagonal (col <= row + causal_offset), and
// keys of another packed segment.
__device__ __forceinline__ bool key_visible(int row, int col, int kv_limit, int causal,
                                            int causal_offset, bool has_seg, int q_seg,
                                            int kv_seg) {
  return col < kv_limit && (!causal || col <= row + causal_offset) &&
         (!has_seg || q_seg == kv_seg);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  // Above 48 KB a block's dynamic shared memory must be opted into per kernel.
  // The attribute is set per device, so it is set on every launch (it is
  // cheap) rather than once per process, which would miss a second card.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace ptt

// Instantiate LAUNCH(T, D) for the supported head dims of one dtype code
// (0 = f32, 1 = bf16); evaluates to cudaErrorInvalidValue otherwise.
#define PTT_DISPATCH(dtype, d, LAUNCH)                           \
  [&]() -> cudaError_t {                                         \
    if ((dtype) == 0) {                                          \
      switch (d) {                                               \
        case 16: return LAUNCH(float, 16);                       \
        case 32: return LAUNCH(float, 32);                       \
        case 64: return LAUNCH(float, 64);                       \
        case 128: return LAUNCH(float, 128);                     \
      }                                                          \
    } else if ((dtype) == 1) {                                   \
      switch (d) {                                               \
        case 16: return LAUNCH(__nv_bfloat16, 16);               \
        case 32: return LAUNCH(__nv_bfloat16, 32);               \
        case 64: return LAUNCH(__nv_bfloat16, 64);               \
        case 128: return LAUNCH(__nv_bfloat16, 128);             \
      }                                                          \
    }                                                            \
    return cudaErrorInvalidValue;                                \
  }()
