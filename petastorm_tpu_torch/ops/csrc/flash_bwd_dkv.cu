// Flash-attention backward, dK/dV sweep, for Hopper (sm_90a).
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel (the
// Pallas TPU kernel launched by _flash_backward) together with the wrapper's
// grouped-query reduction _group_sum_kv_grad. Per key it recomputes the same
// p = exp(s - lse) and ds = p * (dout v^T - delta) * scale as the dQ sweep
// and accumulates dv += p^T dout and dk += ds^T q in f32, summed over the
// query heads that share the K/V head. delta comes from the dQ kernel's
// buffer.
//
// What bounds it on this card: operations. Four T x T x D products per head
// (s, dout v^T, p^T dout, ds^T q) against one read of q, k, v, dout and one
// write of dk, dv: at the training shapes hundreds of FLOP per byte, far past
// the H100's balance point, so the limit is the tensor cores' rate for
// f32-grade products, three TF32 passes each (flash_tc.cuh), 495 / 3 = 165
// TFLOP/s.
//
// What the design does about it:
// - Work: one block per (b * h_kv, 64-key K tile). It visits, with no load
//   and no math, only the Q tiles holding a row at or after the tile's causal
//   start row (k0 - causal_offset) whose segment id lies in the id range of
//   the tile's valid keys (below the kv bound): the forward's exact test with
//   Q and K swapped (flash_tc.cuh::segment_tile_mask, any id order). Ids are
//   per batch row, so the bitmask of visited Q tiles is built once and serves
//   every query head of the K/V head's group. Within a loaded Q tile, a warp
//   runs the same test for its own 16 keys and skips the tile's math when it
//   fails: all its scores there would be masked, which changes nothing.
//   ops/flash_attention.py::visited_q_tiles is the plain mirror.
// - Products: each of the 4 warps owns 16 keys and runs all four products as
//   mma.sync m16n8k8 TF32, split hi/lo in registers (f32 inputs; bf16 inputs
//   are exact in TF32 and take one pass; P and dS are f32 and keep their lo
//   parts). They are oriented as S^T = K Q^T and dP^T = V dO^T, 16 keys x BQ
//   queries per warp, so P^T and dS^T come out in the accumulator layout and
//   feed dV += P^T dO and dK += dS^T Q straight from registers as the A
//   operand: the thread holding columns 2t, 2t+1 feeds them as logical
//   columns t, t+4, and dO's and Q's rows are read in that order. lse and
//   delta are per query, a column of S^T: each lane reads its columns' values
//   from shared memory. The explicit mask, not exp(-inf), zeroes p for
//   masked pairs, rows past T_q and rows with no visible key (lse = +inf).
// - Accumulators: dK and dV for the warp's 16 keys x D stay in f32 registers
//   over all Q tiles and all query heads of the group, and are written once:
//   no per-query-head partials, no wrapper group-sum, no atomics, so two
//   launches give bit-identical results. Each Q tile's products are summed
//   in fresh registers and added to them in f32
//   (flash_tc.cuh::add_tile_product): the tensor cores' own accumulation
//   truncates. 255 registers at f32 D = 128, no spills
//   (tools/flash_variants.py prints ptxas's counts).
// - Loads: K and V stay resident in shared memory for the whole sweep. Q and
//   dO tiles of BQ rows are double-buffered in the input dtype with 16-byte
//   cp.async copies, lse, delta and the rows' segment ids beside them; the
//   next visited tile's copy is issued before the current tile's math, with
//   one __syncthreads per tile. Rows are padded to D + 16 bytes so fragment
//   reads fall in distinct banks. BQ = 16 keeps a block at ~100 KB of shared
//   memory in f32 at D = 128, so two blocks share an SM (BQ = 32 spills and
//   runs one block per SM). The grid runs K-tile-major: every head's first
//   K tile (the most rows under the causal mask) starts in the first wave.
//
// Build-time switches, all at their defaults in the library the port loads:
// - PTT_DKV_BQ: query rows per Q tile (16; 32 also works);
// - PTT_DKV_ONE_PASS: products in plain TF32, without the lo passes;
// - PTT_DKV_NO_SEGMENT_SKIP: blocks load every Q tile from the causal start;
// - PTT_DKV_ACC_IN_MMA: dK/dV products accumulated in the mma accumulators
//   themselves (add_tile_product says why the kernel does not);
// - PTT_DKV_COUNT_TILES: count the Q tiles blocks load and the WK x BQ tiles
//   warps compute; ptt_flash_bwd_dkv_tile_counts reads and clears the counts.
// chip_smoke.py builds the counting library and holds its counts against
// ops/flash_attention.py::visited_q_tiles; tools/flash_variants.py times the
// others (the middle three compute another function on purpose).
#ifndef PTT_DKV_BQ
#define PTT_DKV_BQ 16
#endif
#ifndef PTT_DKV_ONE_PASS
#define PTT_DKV_ONE_PASS 0
#endif
#ifndef PTT_DKV_NO_SEGMENT_SKIP
#define PTT_DKV_NO_SEGMENT_SKIP 0
#endif
#ifndef PTT_DKV_ACC_IN_MMA
#define PTT_DKV_ACC_IN_MMA 0
#endif
#ifndef PTT_DKV_COUNT_TILES
#define PTT_DKV_COUNT_TILES 0
#endif
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int BK = 64;          // keys per block (resident K/V tile)
constexpr int WK = 16;          // keys per warp (one mma row block)
constexpr int BQ = PTT_DKV_BQ;  // query rows per Q/dO tile
constexpr int kWarps = BK / WK;
constexpr int kThreadsDkv = 32 * kWarps;
static_assert(BQ % 8 == 0 && BQ <= 32, "a Q tile is whole mma column blocks, one row per lane");

#if PTT_DKV_COUNT_TILES
__device__ unsigned long long g_tile_counts[2];  // Q tiles loaded, warp tiles computed
#define PTT_COUNT_TILE(i) atomicAdd(&g_tile_counts[i], 1ull)
#else
#define PTT_COUNT_TILE(i) ((void)0)
#endif

// K and V; two stages of Q and dO; two stages of lse, delta and the rows'
// segment ids. The tile mask words follow (their count depends on T_q).
template <typename T, int D>
constexpr int dkv_tile_bytes() {
  return (2 * BK + 4 * BQ) * ptt::pitch<T, D>() * static_cast<int>(sizeof(T)) + 2 * 3 * BQ * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsDkv)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ qseg,
                         const int* __restrict__ kvseg, const int* __restrict__ kv_lens, int H,
                         int Hkv, int Tq, int Tkv, int causal, int causal_offset,
                         float scale) {
  constexpr bool kSplitP = !PTT_DKV_ONE_PASS;                          // P, dS are f32
  constexpr bool kSplit = kSplitP && std::is_same<T, float>::value;  // bf16 is exact in TF32
  constexpr int LD = ptt::pitch<T, D>(), NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);                         // [BK][LD]
  T* v_s = k_s + BK * LD;                                          // [BK][LD]
  T* q_s = v_s + BK * LD;                                          // [2][BQ][LD]
  T* do_s = q_s + 2 * BQ * LD;                                     // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);     // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                                 // [2][BQ]
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * BQ);          // [2][BQ]
  unsigned* mask_s = reinterpret_cast<unsigned*>(qseg_s + 2 * BQ);  // [n_qt / 32]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bhkv = blockIdx.x, b = bhkv / Hkv, hkv = bhkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * BK;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * Tkv * Hkv + hkv) * D;
  const bool has_seg = qseg != nullptr;
  const int* qseg_b = has_seg ? qseg + (long)b * Tq : nullptr;
  const int* kvseg_b = has_seg ? kvseg + (long)b * Tkv : nullptr;
  const int kv_limit = kv_lens ? min(kv_lens[b], Tkv) : Tkv;

  ptt::load_tile_async<T, BK, D, LD, kThreadsDkv>(k_s, k + kv_off, k0, Tkv, kv_stride);
  ptt::load_tile_async<T, BK, D, LD, kThreadsDkv>(v_s, v + kv_off, k0, Tkv, kv_stride);
  ptt::cp_async_commit();

  // Rows that can see a key of this tile: at or after the causal start row
  // (col <= row + causal_offset for col >= k0), below T_q. Keys at or past
  // the kv bound see nothing, so a tile that starts there visits no Q tile
  // and writes zeros.
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int r_begin = causal ? max(k0 - causal_offset, 0) : 0;
  const int n_items = k0 < kv_limit && r_begin < Tq ? group * n_qt : 0;  // (head, Q tile)
  const int qt_first = r_begin / BQ;

  // This thread's two keys (fragment rows g and g + 8 of its warp's 16), and
  // the rows the warp's keys can see: at or after w_begin, ids in [w_lo, w_hi].
  const int w0 = k0 + warp * WK, key0 = w0 + g, key1 = key0 + 8;
  const bool w_valid = w0 < kv_limit;
  const int w_begin = causal ? w0 - causal_offset : INT_MIN;
  int ks0 = 0, ks1 = 0, w_lo = INT_MAX, w_hi = INT_MIN;
  if (has_seg) {
    if (key0 < Tkv) ks0 = kvseg_b[key0];
    if (key1 < Tkv) ks1 = kvseg_b[key1];
    if (w0 + (lane & 15) < kv_limit) w_lo = w_hi = kvseg_b[w0 + (lane & 15)];
    w_lo = __reduce_min_sync(0xffffffffu, w_lo);
    w_hi = __reduce_max_sync(0xffffffffu, w_hi);
  }
  if (has_seg && n_items > 0) {
    int lo = INT_MAX, hi = INT_MIN;  // id range of the tile's valid keys
    for (int c = k0 + lane; c < min(k0 + BK, kv_limit); c += 32) {
      const int id = kvseg_b[c];
      lo = min(lo, id);
      hi = max(hi, id);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
#if PTT_DKV_NO_SEGMENT_SKIP
    for (int w = threadIdx.x; w < (n_qt + 31) / 32; w += blockDim.x) mask_s[w] = ~0u;
    __syncthreads();
#else
    ptt::segment_tile_mask<BQ>(mask_s, (n_qt + 31) / 32, qseg_b, r_begin, Tq, lo, hi);
#endif
  }
  // The first visited (head, Q tile) item at or after `it`, or n_items; the
  // same Q tiles for every head of the group.
  auto next_item = [&](int it) {
    while (it < n_items) {
      const int gi = it / n_qt;
      int qt = max(it - gi * n_qt, qt_first);
      if (has_seg) qt = ptt::next_marked_tile(mask_s, qt, n_qt);
      if (qt < n_qt) return gi * n_qt + qt;
      it = (gi + 1) * n_qt;
    }
    return n_items;
  };
  auto load_q = [&](int it, int stage) {
    const int gi = it / n_qt, q0 = (it - gi * n_qt) * BQ;
    const int bh = b * H + hkv * group + gi;
    const long q_off = ((long)b * Tq * H + hkv * group + gi) * D;
    if (threadIdx.x == 0) PTT_COUNT_TILE(0);
    ptt::load_tile_async<T, BQ, D, LD, kThreadsDkv>(q_s + stage * BQ * LD, q + q_off, q0, Tq,
                                                     q_stride);
    ptt::load_tile_async<T, BQ, D, LD, kThreadsDkv>(do_s + stage * BQ * LD, dout + q_off, q0,
                                                     Tq, q_stride);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      const bool in = row < Tq;
      const long at = (long)bh * Tq + row;
      ptt::cp_async4(lse_s + stage * BQ + threadIdx.x, in ? lse + at : lse, in);
      ptt::cp_async4(delta_s + stage * BQ + threadIdx.x, in ? delta + at : delta, in);
      if (has_seg)
        ptt::cp_async4(qseg_s + stage * BQ + threadIdx.x, in ? qseg_b + row : qseg_b, in);
    }
  };

  int it = next_item(0);
  if (it < n_items) load_q(it, 0);
  ptt::cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const T* ks = k_s + warp * WK * LD;
  const T* vs = v_s + warp * WK * LD;
  for (int stage = 0; it < n_items; stage ^= 1) {
    ptt::cp_async_wait<0>();
    __syncthreads();  // tile `it` (and K/V) landed for all; nobody still reads the other stage
    const int nxt = next_item(it + 1);
    if (nxt < n_items) load_q(nxt, stage ^ 1);
    ptt::cp_async_commit();

    const T* qs = q_s + stage * BQ * LD;
    const T* dos = do_s + stage * BQ * LD;
    const float* lses = lse_s + stage * BQ;
    const float* deltas = delta_s + stage * BQ;
    const int* segs = qseg_s + stage * BQ;
    const int q0 = (it % n_qt) * BQ;
    bool sees = false;  // the tile test, for this warp's keys
    if (lane < BQ) {
      const int row = q0 + lane;
      sees = w_valid && row < Tq && row >= w_begin &&
             (!has_seg || (segs[lane] >= w_lo && segs[lane] <= w_hi));
    }
    if (!__any_sync(0xffffffffu, sees)) {
      it = nxt;
      continue;
    }
    if (lane == 0) PTT_COUNT_TILE(1);

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries, NQ
    // fragments of 8 queries each.
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const T* ka = ks + g * LD + kk * 8 + t4;
      const T* va = vs + g * LD + kk * 8 + t4;
      ptt::Tf32<kSplit> ak[4], av[4];
      ak[0].set(ptt::smem_f32(ka));
      ak[1].set(ptt::smem_f32(ka + 8 * LD));
      ak[2].set(ptt::smem_f32(ka + 4));
      ak[3].set(ptt::smem_f32(ka + 8 * LD + 4));
      av[0].set(ptt::smem_f32(va));
      av[1].set(ptt::smem_f32(va + 8 * LD));
      av[2].set(ptt::smem_f32(va + 4));
      av[3].set(ptt::smem_f32(va + 8 * LD + 4));
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const T* qb = qs + (j * 8 + g) * LD + kk * 8 + t4;
        const T* dob = dos + (j * 8 + g) * LD + kk * 8 + t4;
        ptt::Tf32<kSplit> bq[2], bdo[2];
        bq[0].set(ptt::smem_f32(qb));
        bq[1].set(ptt::smem_f32(qb + 4));
        bdo[0].set(ptt::smem_f32(dob));
        bdo[1].set(ptt::smem_f32(dob + 4));
        ptt::mma_3xtf32<kSplit, kSplit>(s[j], ak, bq);
        ptt::mma_3xtf32<kSplit, kSplit>(dp[j], av, bdo);
      }
    }

    // p and ds in place; element e of fragment j is key (e < 2 ? key0 : key1),
    // query column 8j + 2 t4 + (e & 1) of the tile.
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), row = q0 + col;
        const bool ok = row < Tq && ptt::key_visible(row, e < 2 ? key0 : key1, kv_limit, causal,
                                                     causal_offset, has_seg,
                                                     has_seg ? segs[col] : 0, e < 2 ? ks0 : ks1);
        const float p = ok ? expf(s[j][e] * scale - lses[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - deltas[col]) * scale;
      }

    constexpr bool kAccInMma = PTT_DKV_ACC_IN_MMA;
    ptt::add_tile_product<kAccInMma, kSplitP, kSplit, LD>(dv_acc, s, dos, g, t4);  // dV += P^T dO
    ptt::add_tile_product<kAccInMma, kSplitP, kSplit, LD>(dk_acc, dp, qs, g, t4);  // dK += dS^T Q
    it = nxt;
  }
  ptt::cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i == 0 ? key0 : key1;
    if (key >= Tkv) continue;
    T* dk_row = dk + kv_off + (long)key * kv_stride + 2 * t4;
    T* dv_row = dv + kv_off + (long)key * kv_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      ptt::store2(dk_row + n * 8, dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      ptt::store2(dv_row + n * 8, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const int* qseg, const int* kvseg, const int* kv_lens, int B, int H,
                       int Hkv, int Tq, int Tkv, int causal, int causal_offset, float scale,
                       cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows; every row offset is a multiple
  // of D elements, so the base pointers decide.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15)
    return cudaErrorMisalignedAddress;
  const int mask_words = ((Tq + BQ - 1) / BQ + 31) / 32;
  const int smem = dkv_tile_bytes<T, D>() + 4 * mask_words;
  const cudaError_t attr = ptt::allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  // Blocks start in order of their linear index: every head's first K tile,
  // then every head's second, ...
  const dim3 grid(B * Hkv, (Tkv + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreadsDkv, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), qseg,
      kvseg, kv_lens, H, Hkv, Tq, Tkv, causal, causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const void* qseg, const void* kvseg, const void* kv_lens,
                                 int B, int H, int Hkv, int Tq, int Tkv, int D, int dtype,
                                 int causal, int causal_offset, float scale, void* stream) {
#define LAUNCH_DKV(T, DD)                                                                    \
  launch_dkv<T, DD>(q, k, v, dout, static_cast<const float*>(lse),                           \
                    static_cast<const float*>(delta), dk, dv, static_cast<const int*>(qseg), \
                    static_cast<const int*>(kvseg), static_cast<const int*>(kv_lens), B, H,  \
                    Hkv, Tq, Tkv, causal, causal_offset, scale,                              \
                    static_cast<cudaStream_t>(stream))
  return static_cast<int>(PTT_DISPATCH(dtype, D, LAUNCH_DKV));
#undef LAUNCH_DKV
}

#if PTT_DKV_COUNT_TILES
// Copies the two tile counts to out[0], out[1] (host memory) and clears them;
// call it once the counted launches have finished.
extern "C" int ptt_flash_bwd_dkv_tile_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tile_counts, sizeof(g_tile_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[2] = {0ull, 0ull};
  return static_cast<int>(cudaMemcpyToSymbol(g_tile_counts, zero, sizeof(zero)));
}
#endif
