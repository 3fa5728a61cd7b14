// Tensor-core and async-copy pieces of the Hopper flash kernels: TF32
// mma.sync with an f32-grade three-pass split, cp.async tile loads, and the
// exact segment test that lets a block skip K tiles no query row can see.
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (PTX ISA), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):   a0 = A[g][t],   a1 = A[g+8][t],  a2 = A[g][t+4],  a3 = A[g+8][t+4]
//   B (8 x 8, col):    b0 = B[t][g],   b1 = B[t+4][g]
//   C (16 x 8, f32):   c0 = C[g][2t],  c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
//
// f32-grade products: an f32 x splits into hi, x rounded to TF32, and
// lo = x - hi (exact in f32), and a product takes three passes, lo*hi +
// hi*lo + hi*hi, accumulated in f32. The tensor core reads only the top 19
// bits of a TF32 operand, so hi is exact as read, and lo is read truncated:
// within 2^-21 of x, and the dropped lo*lo term within 2^-22. The split costs
// two integer operations and one add instead of two cvt.rna.tf32, which issue
// at a fraction of the ALU rate (a third of the forward's time, PERF.md). A bf16 value is
// exact in TF32, so its lo is zero and the passes that would multiply by it
// are dropped at compile time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// -- TF32 mma ----------------------------------------------------------------

// x rounded to the nearest TF32 value (ties away from zero): add half a
// TF32 ulp to the bits and clear the 13 that TF32 drops. A carry into the
// exponent is the correct rounding up; inputs are finite.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand of a three-pass product: hi and, for f32 inputs, lo. Without a
// split (bf16 inputs) hi is x itself, exact in TF32.
template <bool kSplit>
struct Tf32 {
  uint32_t hi, lo;
  __device__ __forceinline__ void set(float x) {
    hi = kSplit ? round_tf32(x) : __float_as_uint(x);
    lo = kSplit ? __float_as_uint(x - __uint_as_float(hi)) : 0u;
  }
};

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a * b to f32 grade: the small passes first, then hi * hi. kSplitA /
// kSplitB say whether a / b carry a lo part (f32) or not (exact, bf16).
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_3xtf32(float c[4], const Tf32<kSplitA> a[4],
                                           const Tf32<kSplitB> b[2]) {
  if (kSplitA) mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  if (kSplitB) mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

__device__ __forceinline__ float smem_f32(const float* p) { return *p; }
__device__ __forceinline__ float smem_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// -- cp.async ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Queue the copy of rows [row0, row0 + ROWS) of one head's [T, D] slice
// (consecutive rows `row_stride` elements apart) into a shared tile of rows
// LD elements apart, in the input dtype, 16 bytes per copy; rows at or past
// `t_valid` are zero-filled. Every thread of the block takes part.
template <typename T, int ROWS, int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int row0, int t_valid,
                                                long row_stride) {
  constexpr int kVec = 16 / sizeof(T), kChunks = ROWS * D / kVec;
#pragma unroll
  for (int it = 0; it < (kChunks + NTHREADS - 1) / NTHREADS; ++it) {
    const int i = threadIdx.x + it * NTHREADS;
    if (kChunks % NTHREADS != 0 && i >= kChunks) break;
    const int r = i / (D / kVec), d = (i % (D / kVec)) * kVec;
    const bool ok = row0 + r < t_valid;
    cp_async16(dst + r * LD + d, ok ? src + (long)(row0 + r) * row_stride + d : src, ok);
  }
}

// -- Exact segment skipping ------------------------------------------------------

// Sets bit (t % 32) of mask[t / 32] for every K tile t (of BK keys) that holds
// a key c < k_end whose segment id lies in [q_lo, q_hi], the id range of the
// Q tile's valid rows; the other bits stay clear. A visible pair (r, c) has
// kv_seg[c] == q_seg[r], inside that range, so a clear bit never hides one;
// a tile whose id range is disjoint from [q_lo, q_hi] has no such key, so its
// bit is clear. The ids need not be sorted (the packer pads with -1). Each
// warp tests 32 consecutive keys per step (BK is a multiple of 32, so they
// fall in one tile). Ends with the block synchronised.
template <int BK>
__device__ __forceinline__ void segment_tile_mask(unsigned* mask, int n_words,
                                                  const int* kvseg_b, int k_end, int q_lo,
                                                  int q_hi) {
  static_assert(BK % 32 == 0, "a warp's 32 keys must fall in one tile");
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) mask[w] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, stride = blockDim.x;
#pragma unroll 4
  for (int c0 = threadIdx.x - lane; c0 < k_end; c0 += stride) {
    const int c = c0 + lane;
    int id = 0;
    if (c < k_end) id = kvseg_b[c];
    const bool hit = c < k_end && id >= q_lo && id <= q_hi;
    if (__any_sync(0xffffffffu, hit) && lane == 0) {
      const int t = c0 / BK;
      atomicOr(&mask[t >> 5], 1u << (t & 31));
    }
  }
  __syncthreads();
}

// The first tile >= t whose mask bit is set, or n_tiles.
__device__ __forceinline__ int next_marked_tile(const unsigned* mask, int t, int n_tiles) {
  while (t < n_tiles) {
    const unsigned bits = mask[t >> 5] >> (t & 31);
    if (bits) return min(t + __ffs(bits) - 1, n_tiles);
    t = (t | 31) + 1;
  }
  return n_tiles;
}

}  // namespace ptt
