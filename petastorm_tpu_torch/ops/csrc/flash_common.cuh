// Shared pieces of the three flash-attention kernels (forward, dQ, dK/dV).
//
// Layout contract (set by petastorm_tpu_torch/ops/flash_attention.py):
//   q, dout, o, dq : [B, Tq,  H,   D] contiguous, input dtype (f32 or bf16)
//   k, v, dk, dv   : [B, Tkv, Hkv, D] contiguous, input dtype
//   lse, delta     : [B*H, Tq] f32 (bh = b*H + h)
//   qseg / kvseg   : [B, Tq] / [B, Tkv] int32, or null (no segment mask)
//   kv_lens        : [B] int32, or null (static bound Tkv)
//
// The dQ kernel keeps every tile in shared memory as f32 rows padded to D+1
// floats (load_tile): loads from device memory run along d (coalesced), and
// the two read patterns of its products (a warp reading two rows at one d,
// or sixteen consecutive d of one row) both fall in distinct banks. Its
// arithmetic is plain f32 FFMA, off the tensor cores. The forward and dK/dV
// kernels instead keep tiles in the input dtype and run their products on
// the tensor cores at f32 grade (flash_tc.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ptt {

constexpr int kThreads = 256;  // dQ's 16 x 16 thread grid: ty = tid / 16, tx = tid % 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [row0, row0 + ROWS) of one head's [T, D] slice (consecutive rows
// `row_stride` elements apart) into a padded f32 tile; rows at or past
// `t_valid` are zero-filled so masked products never touch garbage.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t_valid, long row_stride) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = row0 + r;
    dst[r * (D + 1) + d] = t < t_valid ? to_f32(src[(long)t * row_stride + d]) : 0.f;
  }
}

// Reductions over the 16 lanes that share a tile row (one half-warp).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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
