// Flash-attention backward, dQ sweep, for Hopper (sm_90a).
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (the
// Pallas TPU kernel launched by _flash_backward). Per query row it recomputes
// the masked scores s, then p = exp(s - lse), delta = rowsum(dout * o),
// ds = p * (dout v^T - delta) * scale, and accumulates dq += ds k in f32.
// It also writes delta to a [B*H, Tq] f32 buffer, which the dK/dV kernel
// (launched after it on the same stream) reads instead of re-reading o.
//
// What bounds it on this card: operations, as in the forward (three
// T x T x D products per head instead of two), with f32 kept off TF32.
//
// What the design does about it: one block per (b*h, 64-row Q tile) with an
// in-block loop over 32-row K/V tiles in shared memory (the TPU's
// sequential grid axis), the dq accumulator in registers, and the causal
// skip as the loop bound. q and dout stay resident for the whole sweep, so
// each K/V tile read from device memory serves 64 rows.
#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * 4 + BK * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(ptt::kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        const int* __restrict__ qseg, const int* __restrict__ kvseg,
                        const int* __restrict__ kv_lens, int H, int Hkv, int Tq, int Tkv,
                        int causal, int causal_offset, float scale) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][D+1]
  float* do_s = q_s + BQ * (D + 1);    // [BQ][D+1]
  float* k_s = do_s + BQ * (D + 1);    // [BK][D+1]
  float* v_s = k_s + BK * (D + 1);     // [BK][D+1]
  float* ds_s = v_s + BK * (D + 1);    // [BQ][BK+1]
  int* kvseg_s = reinterpret_cast<int*>(ds_s + BQ * (BK + 1));

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const long q_off = ((long)b * Tq * H + h) * D;
  const T* k_base = k + ((long)b * Tkv * Hkv + hkv) * D;
  const T* v_base = v + ((long)b * Tkv * Hkv + hkv) * D;
  const bool has_seg = qseg != nullptr;
  const int kv_limit = kv_lens ? min(kv_lens[b], Tkv) : Tkv;

  ptt::load_tile<T, BQ, D>(q_s, q + q_off, q0, Tq, q_stride);
  ptt::load_tile<T, BQ, D>(do_s, dout + q_off, q0, Tq, q_stride);
  __syncthreads();

  int qs[RQ];
  float lse_r[RQ], delta_r[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < Tq;
    qs[i] = (has_seg && in) ? qseg[(long)b * Tq + row] : 0;
    lse_r[i] = in ? lse[(long)bh * Tq + row] : INFINITY;
    float part = 0.f;
    if (in) {
      const T* o_row = o + q_off + (long)row * q_stride;
#pragma unroll
      for (int c = 0; c < CD; ++c)
        part = fmaf(do_s[(ty + 16 * i) * (D + 1) + tx + 16 * c], ptt::to_f32(o_row[tx + 16 * c]),
                    part);
    }
    delta_r[i] = ptt::row_sum16(part);
    if (in && tx == 0) delta[(long)bh * Tq + row] = delta_r[i];
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int k_end = kv_limit;
  if (causal) k_end = min(k_end, q0 + BQ + causal_offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    ptt::load_tile<T, BK, D>(k_s, k_base, k0, Tkv, kv_stride);
    ptt::load_tile<T, BK, D>(v_s, v_base, k0, Tkv, kv_stride);
    if (has_seg) {
      for (int c = threadIdx.x; c < BK; c += ptt::kThreads)
        kvseg_s[c] = k0 + c < Tkv ? kvseg[(long)b * Tkv + k0 + c] : 0;
    }
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], dov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = q_s[(ty + 16 * i) * (D + 1) + d];
        dov[i] = do_s[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = k_s[(tx + 16 * j) * (D + 1) + d];
        vv[j] = v_s[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = ptt::key_visible(row, col, kv_limit, causal, causal_offset, has_seg,
                                         qs[i], has_seg ? kvseg_s[tx + 16 * j] : 0);
        // lse is +inf for rows with no visible key: the exponent is then an
        // exact zero, never inf - inf.
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = k_s[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float g = ds_s[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(g, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    T* dq_row = dq + q_off + (long)row * q_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) dq_row[tx + 16 * c] = ptt::from_f32<T>(acc[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq,
                      const int* qseg, const int* kvseg, const int* kv_lens, int B, int H,
                      int Hkv, int Tq, int Tkv, int causal, int causal_offset, float scale,
                      cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  const cudaError_t attr = ptt::allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, ptt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
      qseg, kvseg, kv_lens, H, Hkv, Tq, Tkv, causal, causal_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* delta, void* dq,
                                const void* qseg, const void* kvseg, const void* kv_lens,
                                int B, int H, int Hkv, int Tq, int Tkv, int D, int dtype,
                                int causal, int causal_offset, float scale, void* stream) {
#define LAUNCH_DQ(T, DD)                                                                     \
  launch_dq<T, DD>(q, k, v, o, dout, static_cast<const float*>(lse),                         \
                   static_cast<float*>(delta), dq, static_cast<const int*>(qseg),            \
                   static_cast<const int*>(kvseg), static_cast<const int*>(kv_lens), B, H,   \
                   Hkv, Tq, Tkv, causal, causal_offset, scale,                               \
                   static_cast<cudaStream_t>(stream))
  return static_cast<int>(PTT_DISPATCH(dtype, D, LAUNCH_DQ));
#undef LAUNCH_DQ
}
