// Tensor-core and async-copy pieces of the Hopper flash kernels: TF32
// mma.sync with an f32-grade three-pass split, the register-fed tile product
// of the backward kernels, cp.async tile loads, and the exact segment test
// that lets a block skip the tiles of the other operand (K tiles in the
// forward and dQ, Q tiles in dK/dV) that none of its rows can see.
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

// acc += X R for one tile, to f32 grade. X (16 rows x 8 NX columns) is a
// warp's accumulator-layout tile (P^T or dS^T in dK/dV, dS in dQ), fed
// straight from registers as the A operand: fragment j's columns 8j + 2t and
// 8j + 2t + 1 are logical columns t and t + 4, so R's rows are read in that
// order. R (8 NX rows x 8 ND columns: dO or Q in dK/dV, K in dQ) lies in
// shared memory, rows LD elements apart. Unless kAccInMma, each 16 x 8 block
// of the tile's product is summed in a fresh quad and then added to acc in
// f32: the tensor cores truncate when they accumulate, so adding hundreds of
// tiles straight into acc grows a bias with the number of tiles: 5.0e-5 of
// the largest gradient where dK/dV's keys see up to 4,096 rows, against
// 4.7e-6 added this way (PERF.md).
template <bool kAccInMma, bool kSplitX, bool kSplitR, int LD, int NX, int ND, typename T>
__device__ __forceinline__ void add_tile_product(float (&acc)[ND][4], float (&x)[NX][4],
                                                 const T* rows, int g, int t4) {
  Tf32<kSplitX> a[NX][4];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    a[j][0].set(x[j][0]);
    a[j][1].set(x[j][2]);
    a[j][2].set(x[j][1]);
    a[j][3].set(x[j][3]);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    float* sum = kAccInMma ? acc[n] : t;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const T* r = rows + (j * 8 + 2 * t4) * LD + n * 8 + g;
      Tf32<kSplitR> b[2];
      b[0].set(smem_f32(r));
      b[1].set(smem_f32(r + LD));
      mma_3xtf32<kSplitX, kSplitR>(sum, a[j], b);
    }
    if (!kAccInMma) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
    }
  }
}

// -- Shared tiles and paired stores ---------------------------------------------

// Shared-memory row pitch in elements: 16 bytes past D keeps every row
// 16-byte aligned for cp.async and puts the 8 rows x 4 columns of a
// fragment read in 32 distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Two adjacent outputs (an accumulator's columns 2t and 2t+1) in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// Sets bit (t % 32) of mask[t / 32] for every tile t (of TILE entries) that
// holds an entry c in [begin, end) whose segment id seg_b[c] lies in
// [lo, hi]; the other bits stay clear. The forward and dQ kernels pass the id
// range of a Q tile's valid rows and scan keys; the dK/dV kernel passes the id range of
// a K tile's valid keys and scans query rows from the causal start on. A
// visible pair's two ids are equal, so inside the range: a clear bit never
// hides one, and a tile whose ids all fall outside the range stays clear.
// The ids need not be sorted (the packer pads with -1). Each warp tests 32
// consecutive entries per step, from a multiple of 32 and of TILE, so they
// cover one tile (TILE a multiple of 32) or 32 / TILE whole tiles. Ends with
// the block synchronised.
template <int TILE>
__device__ __forceinline__ void segment_tile_mask(unsigned* mask, int n_words,
                                                  const int* seg_b, int begin, int end,
                                                  int lo, int hi) {
  static_assert(TILE % 32 == 0 || 32 % TILE == 0, "a warp's 32 entries must cover whole tiles");
  constexpr int kStep = TILE > 32 ? TILE : 32;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) mask[w] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int c0 = begin - begin % kStep + (threadIdx.x - lane); c0 < end; c0 += blockDim.x) {
    const int c = c0 + lane;
    const bool in = c >= begin && c < end;
    const int id = in ? seg_b[c] : 0;
    const unsigned hits = __ballot_sync(0xffffffffu, in && id >= lo && id <= hi);
    if (lane == 0 && hits) {
      if constexpr (TILE >= 32) {
        const int t = c0 / TILE;
        atomicOr(&mask[t >> 5], 1u << (t & 31));
      } else {
#pragma unroll
        for (int s = 0; s < 32 / TILE; ++s) {
          if ((hits >> (s * TILE)) & ((1u << TILE) - 1u)) {
            const int t = c0 / TILE + s;
            atomicOr(&mask[t >> 5], 1u << (t & 31));
          }
        }
      }
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
