// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel launched by _flash_forward). Same function: per row, softmax of
// the masked scores scale * q k^T (causal, kv bound or per-example kv_lengths,
// packed segment ids), times v, plus the per-row log-sum-exp residual the
// backward kernels consume (+inf for a row with no visible key).
//
// What bounds it on this card: operations. At the training shapes the
// arithmetic intensity is ~T/4 FLOP per byte (hundreds at T = 4096), far
// past the H100's balance point, so the limit is the tensor cores' rate for
// f32-grade products: three TF32 passes each (flash_tc.cuh), 495 / 3 = 165
// TFLOP/s, as the reference's Precision.HIGHEST takes three MXU passes.
//
// What the design does about it:
// - Work: a block skips, with no load and no math, every K tile that the
//   loop bounds (causal diagonal, kv bound) exclude or in which no key's
//   segment id lies in the id range of the Q tile's rows (an exact test for
//   any ids, flash_tc.cuh::segment_tile_mask). With packed segments that is
//   most of the causal triangle. Within a loaded tile, a warp runs the same
//   test for its own 16 rows and skips the tile's math when it fails: all
//   its scores there would be masked, which changes nothing.
// - Products: one block per (b*h, 64-row Q tile); each of its 4 warps owns 16
//   Q rows and runs both products as mma.sync m16n8k8 TF32, split hi/lo in
//   registers (f32 inputs; bf16 inputs are exact in TF32 and take one pass).
//   The score accumulator is reused as the A operand of P V with no trip
//   through shared memory: the thread holding P[g][2t], P[g][2t+1] feeds them
//   as logical keys t and t+4, and reads V's rows 2t and 2t+1 to match.
// - The online softmax (running max and sum, fully-masked-row guard) stays
//   in f32 registers, reduced over the 4 lanes that share a row.
// - Loads: K/V tiles of 32 keys are double-buffered in shared memory in the
//   input dtype with 16-byte cp.async copies; the next visited tile's copy is
//   issued before the current tile's math, with one __syncthreads per tile.
//   Rows are padded to D + 16 bytes so fragment reads fall in distinct banks.
//   32 keys rather than 64: in f32 at D = 128 a block then needs 101 KB of
//   shared memory, so two blocks share an SM instead of one, and ~170
//   registers instead of 254; tools/flash_variants.py times both
//   (PERF.md).
// GQA reads K/V head h / (H / Hkv) directly. wgmma, TMA, warp specialisation
// and a bf16-rate path are later work.
//
// Build-time switches, all at their defaults in the library the port loads:
// - PTT_FWD_BK: keys per K/V tile (32);
// - PTT_FWD_ONE_PASS: products in plain TF32, without the lo passes;
// - PTT_FWD_NO_SEGMENT_SKIP: blocks load every K tile below their bound;
// - PTT_FWD_COUNT_TILES: count the K tiles blocks load and the WQ x BK tiles
//   warps compute; ptt_flash_fwd_tile_counts reads and clears the counts.
// chip_smoke.py builds the counting library and holds its counts against
// ops/flash_attention.py::visited_k_tiles; tools/flash_variants.py times
// the others (the middle two compute another function on purpose).
#ifndef PTT_FWD_BK
#define PTT_FWD_BK 32
#endif
#ifndef PTT_FWD_ONE_PASS
#define PTT_FWD_ONE_PASS 0
#endif
#ifndef PTT_FWD_NO_SEGMENT_SKIP
#define PTT_FWD_NO_SEGMENT_SKIP 0
#endif
#ifndef PTT_FWD_COUNT_TILES
#define PTT_FWD_COUNT_TILES 0
#endif
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int WQ = 16;                  // query rows per warp (one mma row block)
constexpr int BK = PTT_FWD_BK;          // keys per K/V tile
constexpr int kWarps = BQ / WQ;
constexpr int kThreadsFwd = 32 * kWarps;

#if PTT_FWD_COUNT_TILES
__device__ unsigned long long g_tile_counts[2];  // K tiles loaded, warp tiles computed
#define PTT_COUNT_TILE(i) atomicAdd(&g_tile_counts[i], 1ull)
#else
#define PTT_COUNT_TILE(i) ((void)0)
#endif

// Q tile, two stages of K and V, two stages of key segment ids; the tile mask
// words follow (their count depends on T_kv).
template <typename T, int D>
constexpr int fwd_tile_bytes() {
  return (BQ + 4 * BK) * ptt::pitch<T, D>() * static_cast<int>(sizeof(T)) + 2 * BK * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsFwd)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ qseg, const int* __restrict__ kvseg,
                     const int* __restrict__ kv_lens, int H, int Hkv, int Tq, int Tkv,
                     int causal, int causal_offset, float scale) {
  constexpr bool kSplitP = !PTT_FWD_ONE_PASS;                          // P is f32
  constexpr bool kSplit = kSplitP && std::is_same<T, float>::value;  // bf16 is exact in TF32
  constexpr int LD = ptt::pitch<T, D>(), NT = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                             // [BQ][LD]
  T* k_s = q_s + BQ * LD;                                              // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                                          // [2][BK][LD]
  int* kvseg_s = reinterpret_cast<int*>(v_s + 2 * BK * LD);            // [2][BK]
  unsigned* mask_s = reinterpret_cast<unsigned*>(kvseg_s + 2 * BK);    // [n_kt / 32]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  // Later Q tiles see more keys under the causal mask: they start first, so
  // the last wave holds short blocks.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const T* q_base = q + ((long)b * Tq * H + h) * D;
  const T* k_base = k + ((long)b * Tkv * Hkv + hkv) * D;
  const T* v_base = v + ((long)b * Tkv * Hkv + hkv) * D;
  const bool has_seg = qseg != nullptr;
  const int* qseg_b = has_seg ? qseg + (long)b * Tq : nullptr;
  const int* kvseg_b = has_seg ? kvseg + (long)b * Tkv : nullptr;
  const int kv_limit = kv_lens ? min(kv_lens[b], Tkv) : Tkv;

  ptt::load_tile_async<T, BQ, D, LD, kThreadsFwd>(q_s, q_base, q0, Tq, q_stride);
  ptt::cp_async_commit();

  // Keys this Q tile can see: below kv_limit and, causally, at or before
  // the last row's diagonal col <= (q0 + BQ - 1) + causal_offset.
  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BQ + causal_offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  // This thread's two rows (fragment rows g and g + 8 of its warp's 16),
  // and the keys the warp's rows can see: below w_end, and ids in [w_lo, w_hi].
  const int w0 = q0 + warp * WQ, row0 = w0 + g, row1 = row0 + 8;
  const int w_end = w0 >= Tq ? 0 : causal ? min(kv_limit, w0 + WQ + causal_offset) : kv_limit;
  int qs0 = 0, qs1 = 0, w_lo = INT_MAX, w_hi = INT_MIN;
  if (has_seg) {
    if (row0 < Tq) qs0 = qseg_b[row0];
    if (row1 < Tq) qs1 = qseg_b[row1];
    if (w0 + (lane & 15) < Tq) w_lo = w_hi = qseg_b[w0 + (lane & 15)];
    w_lo = __reduce_min_sync(0xffffffffu, w_lo);
    w_hi = __reduce_max_sync(0xffffffffu, w_hi);
    int lo = INT_MAX, hi = INT_MIN;  // id range of the tile's valid rows
    for (int r = q0 + lane; r < min(q0 + BQ, Tq); r += 32) {
      const int id = qseg_b[r];
      lo = min(lo, id);
      hi = max(hi, id);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
#if PTT_FWD_NO_SEGMENT_SKIP
    for (int w = threadIdx.x; w < (n_kt + 31) / 32; w += blockDim.x) mask_s[w] = ~0u;
    __syncthreads();
#else
    ptt::segment_tile_mask<BK>(mask_s, (n_kt + 31) / 32, kvseg_b, 0, k_end, lo, hi);
#endif
  }
  auto next_tile = [&](int t) {
    return has_seg ? ptt::next_marked_tile(mask_s, t, n_kt) : min(t, n_kt);
  };
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    if (threadIdx.x == 0) PTT_COUNT_TILE(0);
    ptt::load_tile_async<T, BK, D, LD, kThreadsFwd>(k_s + stage * BK * LD, k_base, k0, Tkv,
                                                    kv_stride);
    ptt::load_tile_async<T, BK, D, LD, kThreadsFwd>(v_s + stage * BK * LD, v_base, k0, Tkv,
                                                    kv_stride);
    if (has_seg && threadIdx.x < BK) {
      const int c = k0 + threadIdx.x;
      ptt::cp_async4(kvseg_s + stage * BK + threadIdx.x, c < Tkv ? kvseg_b + c : kvseg_b,
                     c < Tkv);
    }
  };

  int kt = next_tile(0);
  if (kt < n_kt) load_kv(kt, 0);
  ptt::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's partial sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int stage = 0; kt < n_kt; stage ^= 1) {
    ptt::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed for all; nobody still reads the other stage
    const int nxt = next_tile(kt + 1);
    if (nxt < n_kt) load_kv(nxt, stage ^ 1);
    ptt::cp_async_commit();

    const T* ks = k_s + stage * BK * LD;
    const T* vs = v_s + stage * BK * LD;
    const int* segs = kvseg_s + stage * BK;
    const int k0 = kt * BK;
    bool sees = false;  // the tile test, for this warp's rows
#pragma unroll
    for (int c = lane; c < BK; c += 32)
      sees |= k0 + c < w_end && (!has_seg || (segs[c] >= w_lo && segs[c] <= w_hi));
    if (!__any_sync(0xffffffffu, sees)) {
      kt = nxt;
      continue;
    }
    if (lane == 0) PTT_COUNT_TILE(1);

    // S = Q K^T: this warp's 16 rows x BK keys, NT fragments of 8 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const T* qa = q_s + (warp * WQ + g) * LD + kk * 8 + t4;
      ptt::Tf32<kSplit> a[4];
      a[0].set(ptt::smem_f32(qa));
      a[1].set(ptt::smem_f32(qa + 8 * LD));
      a[2].set(ptt::smem_f32(qa + 4));
      a[3].set(ptt::smem_f32(qa + 8 * LD + 4));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* kb = ks + (j * 8 + g) * LD + kk * 8 + t4;
        ptt::Tf32<kSplit> bk[2];
        bk[0].set(ptt::smem_f32(kb));
        bk[1].set(ptt::smem_f32(kb + 4));
        ptt::mma_3xtf32<kSplit, kSplit>(s[j], a, bk);
      }
    }

    // Mask, scale and the online softmax; element e of fragment j is row
    // (e < 2 ? row0 : row1), key k0 + 8j + 2 t4 + (e & 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        const bool ok = ptt::key_visible(e < 2 ? row0 : row1, k0 + col, kv_limit, causal,
                                         causal_offset, has_seg, e < 2 ? qs0 : qs1,
                                         has_seg ? segs[col] : 0);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float m_safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // A row can have no visible key in this tile (and so far): keep the
      // exponent finite instead of (-inf) - (-inf).
      const bool empty = m_new == -INFINITY;
      m_safe[i] = empty ? 0.f : m_new;
      alpha[i] = empty ? 1.f : expf(m[i] - m_safe[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_safe[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P straight from the score registers: fragment j's keys
    // 8j + 2 t4 and 8j + 2 t4 + 1 are the A operand's columns t4 and t4 + 4,
    // so B takes V's rows in the same order.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      ptt::Tf32<kSplitP> pa[4];
      pa[0].set(s[j][0]);
      pa[1].set(s[j][2]);
      pa[2].set(s[j][1]);
      pa[3].set(s[j][3]);
      const T* vb = vs + (j * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        ptt::Tf32<kSplit> bv[2];
        bv[0].set(ptt::smem_f32(vb + n * 8));
        bv[1].set(ptt::smem_f32(vb + LD + n * 8));
        ptt::mma_3xtf32<kSplitP, kSplit>(acc[n], pa, bv);
      }
    }
    kt = nxt;
  }
  ptt::cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = i == 0 ? row0 : row1;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o_row = o + (((long)b * Tq + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      ptt::store2(o_row + n * 8, acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    if (t4 == 0)
      lse[(long)bh * Tq + row] = l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const int* qseg, const int* kvseg, const int* kv_lens, int B, int H,
                       int Hkv, int Tq, int Tkv, int causal, int causal_offset, float scale,
                       cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows; every row offset is a multiple
  // of D elements, so the base pointers decide.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorMisalignedAddress;
  const int mask_words = ((Tkv + BK - 1) / BK + 31) / 32;
  const int smem = fwd_tile_bytes<T, D>() + 4 * mask_words;
  const cudaError_t attr = ptt::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreadsFwd, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, qseg, kvseg, kv_lens, H, Hkv, Tq, Tkv, causal, causal_offset,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* qseg, const void* kvseg, const void* kv_lens, int B,
                             int H, int Hkv, int Tq, int Tkv, int D, int dtype, int causal,
                             int causal_offset, float scale, void* stream) {
#define LAUNCH_FWD(T, DD)                                                                  \
  launch_fwd<T, DD>(q, k, v, o, static_cast<float*>(lse), static_cast<const int*>(qseg),   \
                    static_cast<const int*>(kvseg), static_cast<const int*>(kv_lens), B, H, \
                    Hkv, Tq, Tkv, causal, causal_offset, scale,                            \
                    static_cast<cudaStream_t>(stream))
  return static_cast<int>(PTT_DISPATCH(dtype, D, LAUNCH_FWD));
#undef LAUNCH_FWD
}

#if PTT_FWD_COUNT_TILES
// Copies the two tile counts to out[0], out[1] (host memory) and clears them;
// call it once the counted launches have finished.
extern "C" int ptt_flash_fwd_tile_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tile_counts, sizeof(g_tile_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[2] = {0ull, 0ull};
  return static_cast<int>(cudaMemcpyToSymbol(g_tile_counts, zero, sizeof(zero)));
}
#endif
