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
// past the H100's balance point, so the limit is the FFMA rate: f32 inputs
// must stay full f32 (no TF32), which keeps every product on the CUDA cores.
//
// What the design does about it: one block per (b*h, 64-row Q tile); the
// TPU's sequential K grid axis becomes an in-block loop over 32-row K/V
// tiles staged in shared memory, so the [T, T] scores never reach device
// memory and each K/V tile read serves 64 query rows. Each thread owns a
// 4 x 2 score micro-tile and a 4 x D/16 slice of the output accumulator in
// registers; the online softmax (running max/sum, fully-masked-row guard)
// runs in f32 registers with half-warp shuffles. Causal skipping is the
// loop bound: tiles wholly past the diagonal are never loaded. GQA reads K/V
// head h / (H / Hkv) directly. Tensor cores (mma/wgmma for bf16), TMA and
// pipelining are later work; this version is the correct baseline.
#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 32;  // key rows per loop step

template <int D>
constexpr int fwd_smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * 4 + BK * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(ptt::kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ qseg, const int* __restrict__ kvseg,
                     const int* __restrict__ kv_lens, int H, int Hkv, int Tq, int Tkv,
                     int causal, int causal_offset, float scale) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][D+1]
  float* k_s = q_s + BQ * (D + 1);    // [BK][D+1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D+1]
  float* p_s = v_s + BK * (D + 1);    // [BQ][BK+1]
  int* kvseg_s = reinterpret_cast<int*>(p_s + BQ * (BK + 1));  // [BK]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const T* q_base = q + ((long)b * Tq * H + h) * D;
  const T* k_base = k + ((long)b * Tkv * Hkv + hkv) * D;
  const T* v_base = v + ((long)b * Tkv * Hkv + hkv) * D;
  const bool has_seg = qseg != nullptr;
  const int kv_limit = kv_lens ? min(kv_lens[b], Tkv) : Tkv;

  ptt::load_tile<T, BQ, D>(q_s, q_base, q0, Tq, q_stride);
  int qs[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    qs[i] = (has_seg && row < Tq) ? qseg[(long)b * Tq + row] : 0;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // Keys this Q tile can see: below kv_limit and, causally, at or before
  // the last row's diagonal col <= (q0 + BQ - 1) + causal_offset.
  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BQ + causal_offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step's reads of k_s / v_s / p_s are done
    ptt::load_tile<T, BK, D>(k_s, k_base, k0, Tkv, kv_stride);
    ptt::load_tile<T, BK, D>(v_s, v_base, k0, Tkv, kv_stride);
    if (has_seg) {
      for (int c = threadIdx.x; c < BK; c += ptt::kThreads)
        kvseg_s[c] = k0 + c < Tkv ? kvseg[(long)b * Tkv + k0 + c] : 0;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_s[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = k_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = ptt::key_visible(row, col, kv_limit, causal, causal_offset, has_seg,
                                         qs[i], has_seg ? kvseg_s[tx + 16 * j] : 0);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = ptt::row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      // A row can have no visible key in this tile (and so far): keep the
      // exponent finite instead of (-inf) - (-inf).
      const bool empty = m_new == -INFINITY;
      const float m_safe = empty ? 0.f : m_new;
      const float alpha = empty ? 1.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_safe);
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      rs = ptt::row_sum16(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = v_s[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = p_s[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o_row = o + (((long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) o_row[tx + 16 * c] = ptt::from_f32<T>(acc[i][c] / denom);
    if (tx == 0)
      lse[(long)bh * Tq + row] = l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const int* qseg, const int* kvseg, const int* kv_lens, int B, int H,
                       int Hkv, int Tq, int Tkv, int causal, int causal_offset, float scale,
                       cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  const cudaError_t attr = ptt::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, ptt::kThreads, smem, stream>>>(
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
