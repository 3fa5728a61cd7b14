// Flash-attention backward, dQ sweep, for Hopper (sm_90a).
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (the
// Pallas TPU kernel launched by _flash_backward). Per query row it computes
// delta = rowsum(dout * o), recomputes the masked scores s, then
// p = exp(s - lse) and ds = p * (dout v^T - delta) * scale, and accumulates
// dq += ds k in f32. It also writes delta to a [B*H, Tq] f32 buffer, which
// the dK/dV kernel (launched after it on the same stream) reads instead of
// re-reading o. With an lse cotangent dlse ([B*H, Tq] f32, or null), ds is
// p * (dout v^T - delta + dlse) * scale (the reference's dlse term, in both
// sweeps): the kernel keeps and writes delta - dlse in place of delta, so
// the one edit carries dlse into both kernels.
//
// What bounds it on this card: operations. Three T x T x D products per head
// (s, dout v^T, ds k) against one read of q, k, v, o, dout and one write of
// dq: at the training shapes hundreds of FLOP per byte, far past the H100's
// balance point, so the limit is the tensor cores' rate for f32-grade
// products, three TF32 passes each (flash_tc.cuh), 495 / 3 = 165 TFLOP/s.
//
// What the design does about it (the forward's, flash_fwd.cu, with a second
// resident tile):
// - Work: one block per (b*h, 64-row Q tile), later Q tiles first (they see
//   more keys under the causal mask, so the last wave holds short blocks).
//   A block skips, with no load and no math, every K tile that the causal
//   diagonal or the kv bound excludes or in which no key's segment id lies in
//   the id range of the Q tile's rows (the forward's exact test,
//   flash_tc.cuh::segment_tile_mask). Within a loaded tile, a warp runs the
//   same test for its own 16 rows and skips the tile's math when it fails.
//   ops/flash_attention.py::visited_k_tiles with the DQ_* tiles is the plain
//   mirror.
// - Products: each of the 4 warps owns 16 Q rows and runs all three products
//   as mma.sync m16n8k8 TF32, split hi/lo in registers (f32 inputs; bf16
//   inputs are exact in TF32 and take one pass; dS is f32 and keeps its lo
//   part). S = Q K^T and dP = dO V^T take A from the resident Q and dO
//   tiles. p and ds are computed in place in the accumulators; the explicit
//   mask, not exp(-inf), zeroes p for masked pairs, rows past T_q and rows
//   with no visible key (lse = +inf). dQ += dS K feeds dS straight from
//   registers as the A operand (flash_tc.cuh::add_tile_product): the lane
//   holding columns 2t and 2t+1 feeds them as logical columns t and t+4, and
//   K's rows are read in that order.
// - Accumulator: dQ for the warp's 16 rows x D stays in f32 registers over
//   all K tiles and is written once, so two launches give bit-identical
//   results. Each K tile's product is summed in fresh registers and added to
//   it in f32: the tensor cores' own accumulation truncates, and a row sees
//   up to T_kv keys.
// - delta and lse: once per row, in the prologue, from the resident dO tile
//   and o; kept in registers for the lane's two rows, as the forward keeps
//   its running max and sum.
// - Loads: Q and dO stay resident in shared memory, copied with cp.async.
//   K/V tiles of BK keys and their segment ids are double-buffered in the
//   input dtype with 16-byte cp.async copies; the next visited tile's copy is
//   issued before the current tile's math, with one __syncthreads per tile.
//   Rows are padded to D + 16 bytes so fragment reads fall in distinct banks.
//   With K/V tiles of 16 keys a block needs ~101 KB of shared memory in f32
//   at D = 128, so two blocks share an SM; with 32 keys ~135 KB, one block
//   per SM. tools/flash_variants.py times both (PERF.md).
//
// Build-time switches, all at their defaults in the library the port loads:
// - PTT_DQ_BK: keys per K/V tile (16);
// - PTT_DQ_ONE_PASS: products in plain TF32, without the lo passes;
// - PTT_DQ_NO_SEGMENT_SKIP: blocks load every K tile below their bound;
// - PTT_DQ_ACC_IN_MMA: dQ products accumulated in the mma accumulators
//   themselves (add_tile_product says why the kernel does not);
// - PTT_DQ_COUNT_TILES: count the K tiles blocks load and the WQ x BK tiles
//   warps compute; ptt_flash_bwd_dq_tile_counts reads and clears the counts.
// chip_smoke.py builds the counting library and holds its counts against
// ops/flash_attention.py::visited_k_tiles; tools/flash_variants.py times the
// others (the middle three compute another function on purpose).
#ifndef PTT_DQ_BK
#define PTT_DQ_BK 16
#endif
#ifndef PTT_DQ_ONE_PASS
#define PTT_DQ_ONE_PASS 0
#endif
#ifndef PTT_DQ_NO_SEGMENT_SKIP
#define PTT_DQ_NO_SEGMENT_SKIP 0
#endif
#ifndef PTT_DQ_ACC_IN_MMA
#define PTT_DQ_ACC_IN_MMA 0
#endif
#ifndef PTT_DQ_COUNT_TILES
#define PTT_DQ_COUNT_TILES 0
#endif
#include <climits>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block (resident Q and dO tiles)
constexpr int WQ = 16;         // query rows per warp (one mma row block)
constexpr int BK = PTT_DQ_BK;  // keys per K/V tile
constexpr int kWarps = BQ / WQ;
constexpr int kThreadsDq = 32 * kWarps;
static_assert(BK % 8 == 0 && BK <= kThreadsDq,
              "a K tile is whole mma fragments, one key id copied per thread");

#if PTT_DQ_COUNT_TILES
__device__ unsigned long long g_tile_counts[2];  // K tiles loaded, warp tiles computed
#define PTT_COUNT_TILE(i) atomicAdd(&g_tile_counts[i], 1ull)
#else
#define PTT_COUNT_TILE(i) ((void)0)
#endif

// Q and dO; two stages of K and V; two stages of key segment ids. The tile
// mask words follow (their count depends on T_kv).
template <typename T, int D>
constexpr int dq_tile_bytes() {
  return (2 * BQ + 4 * BK) * ptt::pitch<T, D>() * static_cast<int>(sizeof(T)) + 2 * BK * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsDq)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dlse, float* __restrict__ delta,
                        T* __restrict__ dq,
                        const int* __restrict__ qseg, const int* __restrict__ kvseg,
                        const int* __restrict__ kv_lens, int H, int Hkv, int Tq, int Tkv,
                        int causal, int causal_offset, float scale) {
  constexpr bool kSplitP = !PTT_DQ_ONE_PASS;                          // dS is f32
  constexpr bool kSplit = kSplitP && std::is_same<T, float>::value;  // bf16 is exact in TF32
  constexpr bool kAccInMma = PTT_DQ_ACC_IN_MMA;
  constexpr int LD = ptt::pitch<T, D>(), NT = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                             // [BQ][LD]
  T* do_s = q_s + BQ * LD;                                             // [BQ][LD]
  T* k_s = do_s + BQ * LD;                                             // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                                          // [2][BK][LD]
  int* kvseg_s = reinterpret_cast<int*>(v_s + 2 * BK * LD);            // [2][BK]
  unsigned* mask_s = reinterpret_cast<unsigned*>(kvseg_s + 2 * BK);    // [n_kt / 32]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const long q_off = ((long)b * Tq * H + h) * D;
  const T* k_base = k + ((long)b * Tkv * Hkv + hkv) * D;
  const T* v_base = v + ((long)b * Tkv * Hkv + hkv) * D;
  const bool has_seg = qseg != nullptr;
  const int* qseg_b = has_seg ? qseg + (long)b * Tq : nullptr;
  const int* kvseg_b = has_seg ? kvseg + (long)b * Tkv : nullptr;
  const int kv_limit = kv_lens ? min(kv_lens[b], Tkv) : Tkv;

  ptt::load_tile_async<T, BQ, D, LD, kThreadsDq>(q_s, q + q_off, q0, Tq, q_stride);
  ptt::load_tile_async<T, BQ, D, LD, kThreadsDq>(do_s, dout + q_off, q0, Tq, q_stride);
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
#if PTT_DQ_NO_SEGMENT_SKIP
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
    ptt::load_tile_async<T, BK, D, LD, kThreadsDq>(k_s + stage * BK * LD, k_base, k0, Tkv,
                                                   kv_stride);
    ptt::load_tile_async<T, BK, D, LD, kThreadsDq>(v_s + stage * BK * LD, v_base, k0, Tkv,
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

  // delta = rowsum(dout * o) (minus dlse) and lse for this lane's two rows:
  // each of the 4 lanes of a row sums every 4th column, then they combine.
  ptt::cp_async_wait<1>();
  __syncthreads();  // Q and dO have landed for all (the first K/V tile may not have)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * WQ + g + 8 * i, row = q0 + r;
    float part = 0.f;
    if (row < Tq) {
      const T* o_row = o + q_off + (long)row * q_stride;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const int d = 4 * c + t4;
        part = fmaf(ptt::smem_f32(do_s + r * LD + d), ptt::to_f32(o_row[d]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (dlse != nullptr && row < Tq) part -= dlse[(long)bh * Tq + row];
    delta_r[i] = part;
    lse_r[i] = row < Tq ? lse[(long)bh * Tq + row] : INFINITY;
    if (row < Tq && t4 == 0) delta[(long)bh * Tq + row] = part;
  }

  float acc[ND][4];  // dQ of the warp's 16 rows, in the accumulator layout
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const T* q_w = q_s + warp * WQ * LD;  // this warp's rows of Q and dO
  const T* do_w = do_s + warp * WQ * LD;
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

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK keys, NT fragments
    // of 8 keys each.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const T* qa = q_w + g * LD + kk * 8 + t4;
      const T* da = do_w + g * LD + kk * 8 + t4;
      ptt::Tf32<kSplit> aq[4], ado[4];
      aq[0].set(ptt::smem_f32(qa));
      aq[1].set(ptt::smem_f32(qa + 8 * LD));
      aq[2].set(ptt::smem_f32(qa + 4));
      aq[3].set(ptt::smem_f32(qa + 8 * LD + 4));
      ado[0].set(ptt::smem_f32(da));
      ado[1].set(ptt::smem_f32(da + 8 * LD));
      ado[2].set(ptt::smem_f32(da + 4));
      ado[3].set(ptt::smem_f32(da + 8 * LD + 4));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* kb = ks + (j * 8 + g) * LD + kk * 8 + t4;
        const T* vb = vs + (j * 8 + g) * LD + kk * 8 + t4;
        ptt::Tf32<kSplit> bk[2], bv[2];
        bk[0].set(ptt::smem_f32(kb));
        bk[1].set(ptt::smem_f32(kb + 4));
        bv[0].set(ptt::smem_f32(vb));
        bv[1].set(ptt::smem_f32(vb + 4));
        ptt::mma_3xtf32<kSplit, kSplit>(s[j], aq, bk);
        ptt::mma_3xtf32<kSplit, kSplit>(dp[j], ado, bv);
      }
    }

    // ds in place of dp; element e of fragment j is row (e < 2 ? row0 :
    // row1), key k0 + 8j + 2 t4 + (e & 1).
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), row = e < 2 ? row0 : row1;
        const bool ok = row < Tq && ptt::key_visible(row, k0 + col, kv_limit, causal,
                                                     causal_offset, has_seg, e < 2 ? qs0 : qs1,
                                                     has_seg ? segs[col] : 0);
        const float p = ok ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
      }

    ptt::add_tile_product<kAccInMma, kSplitP, kSplit, LD>(acc, dp, ks, g, t4);  // dQ += dS K
    kt = nxt;
  }
  ptt::cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row0 : row1;
    if (row >= Tq) continue;
    T* dq_row = dq + q_off + (long)row * q_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) ptt::store2(dq_row + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, const float* dlse, float* delta,
                      void* dq,
                      const int* qseg, const int* kvseg, const int* kv_lens, int B, int H,
                      int Hkv, int Tq, int Tkv, int causal, int causal_offset, float scale,
                      cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows; every row offset is a multiple
  // of D elements, so the base pointers decide. o is read directly.
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15)
    return cudaErrorMisalignedAddress;
  const int mask_words = ((Tkv + BK - 1) / BK + 31) / 32;
  const int smem = dq_tile_bytes<T, D>() + 4 * mask_words;
  const cudaError_t attr = ptt::allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreadsDq, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, dlse, delta,
      static_cast<T*>(dq),
      qseg, kvseg, kv_lens, H, Hkv, Tq, Tkv, causal, causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dlse may be null (no lse cotangent): the output is then the function
// without the dlse term, computed as before it had one.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, const void* dlse,
                                void* delta, void* dq,
                                const void* qseg, const void* kvseg, const void* kv_lens,
                                int B, int H, int Hkv, int Tq, int Tkv, int D, int dtype,
                                int causal, int causal_offset, float scale, void* stream) {
#define LAUNCH_DQ(T, DD)                                                                     \
  launch_dq<T, DD>(q, k, v, o, dout, static_cast<const float*>(lse),                         \
                   static_cast<const float*>(dlse), static_cast<float*>(delta), dq,          \
                   static_cast<const int*>(qseg),                                            \
                   static_cast<const int*>(kvseg), static_cast<const int*>(kv_lens), B, H,   \
                   Hkv, Tq, Tkv, causal, causal_offset, scale,                               \
                   static_cast<cudaStream_t>(stream))
  return static_cast<int>(PTT_DISPATCH(dtype, D, LAUNCH_DQ));
#undef LAUNCH_DQ
}

#if PTT_DQ_COUNT_TILES
// Copies the two tile counts to out[0], out[1] (host memory) and clears them;
// call it once the counted launches have finished.
extern "C" int ptt_flash_bwd_dq_tile_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tile_counts, sizeof(g_tile_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[2] = {0ull, 0ull};
  return static_cast<int>(cudaMemcpyToSymbol(g_tile_counts, zero, sizeof(zero)));
}
#endif
