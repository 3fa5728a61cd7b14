// Flash-attention backward, dK/dV sweep, for Hopper (sm_90a).
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel (the
// Pallas TPU kernel launched by _flash_backward) together with the wrapper's
// grouped-query reduction _group_sum_kv_grad. Per key row it recomputes the
// same p = exp(s - lse) and ds = p * (dout v^T - delta) * scale as the dQ
// sweep and accumulates dv += p^T dout and dk += ds^T q in f32.
//
// What bounds it on this card: operations (four T x T x D products per
// head: s, dout v^T, p^T dout, ds^T q), on the CUDA cores in full f32.
//
// What the design does about it: one block per (b*h_kv, 32-row K tile). The
// block loops over the h / h_kv query heads that share this K/V head and
// over their Q tiles, so dk/dv for the K/V head accumulate in f32 registers
// inside one block: no per-query-head [B*H, T, D] partials, no wrapper
// group-sum and no atomics, hence a deterministic result. k and v stay
// resident in shared memory for the whole sweep; the causal skip is the
// first Q tile of the loop. delta comes from the dQ kernel's buffer.
#include "flash_common.cuh"

namespace {

constexpr int BQ = 32;  // query rows per loop step
constexpr int BK = 32;  // resident key rows per block

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ) * 4 + BQ * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(ptt::kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ qseg,
                         const int* __restrict__ kvseg, const int* __restrict__ kv_lens, int H,
                         int Hkv, int Tq, int Tkv, int causal, int causal_offset,
                         float scale) {
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                   // [BK][D+1]
  float* v_s = k_s + BK * (D + 1);     // [BK][D+1]
  float* q_s = v_s + BK * (D + 1);     // [BQ][D+1]
  float* do_s = q_s + BQ * (D + 1);    // [BQ][D+1]
  float* p_s = do_s + BQ * (D + 1);    // [BQ][BK+1]
  float* ds_s = p_s + BQ * (BK + 1);   // [BQ][BK+1]
  float* lse_s = ds_s + BQ * (BK + 1); // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);  // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bhkv = blockIdx.y, b = bhkv / Hkv, hkv = bhkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * BK;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * Tkv * Hkv + hkv) * D;
  const bool has_seg = qseg != nullptr;
  const int kv_limit = kv_lens ? min(kv_lens[b], Tkv) : Tkv;

  ptt::load_tile<T, BK, D>(k_s, k + kv_off, k0, Tkv, kv_stride);
  ptt::load_tile<T, BK, D>(v_s, v + kv_off, k0, Tkv, kv_stride);
  int ks[CK];
#pragma unroll
  for (int j = 0; j < CK; ++j) {
    const int col = k0 + tx + 16 * j;
    ks[j] = (has_seg && col < Tkv) ? kvseg[(long)b * Tkv + col] : 0;
  }

  float dk_acc[CK][CD], dv_acc[CK][CD];
#pragma unroll
  for (int i = 0; i < CK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // First Q tile whose causal diagonal reaches this K tile:
  // q0 + BQ - 1 + causal_offset >= k0.
  int qt_first = 0;
  if (causal) {
    const int need = k0 - causal_offset - (BQ - 1);
    qt_first = need > 0 ? (need + BQ - 1) / BQ : 0;
  }
  const int n_qt = k0 < kv_limit ? (Tq + BQ - 1) / BQ : 0;  // keys past the bound get no grad

  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const int bh = b * H + h;
    const long q_off = ((long)b * Tq * H + h) * D;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // previous step's reads of q_s / do_s / p_s / ds_s are done
      ptt::load_tile<T, BQ, D>(q_s, q + q_off, q0, Tq, q_stride);
      ptt::load_tile<T, BQ, D>(do_s, dout + q_off, q0, Tq, q_stride);
      for (int r = threadIdx.x; r < BQ; r += ptt::kThreads) {
        const int row = q0 + r;
        const bool in = row < Tq;
        lse_s[r] = in ? lse[(long)bh * Tq + row] : INFINITY;
        delta_s[r] = in ? delta[(long)bh * Tq + row] : 0.f;
        qseg_s[r] = (has_seg && in) ? qseg[(long)b * Tq + row] : 0;
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
        const int r = ty + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int col = k0 + tx + 16 * j;
          const bool ok = ptt::key_visible(row, col, kv_limit, causal, causal_offset, has_seg,
                                           qseg_s[r], ks[j]);
          const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * (BK + 1) + tx + 16 * j] = p;
          ds_s[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float dov[CD], qv[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dov[c] = do_s[r * (D + 1) + tx + 16 * c];
          qv[c] = q_s[r * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < CK; ++i) {
          const float p = p_s[r * (BK + 1) + ty + 16 * i];
          const float g2 = ds_s[r * (BK + 1) + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(g2, qv[c], dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < CK; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= Tkv) continue;
    T* dk_row = dk + kv_off + (long)t * kv_stride;
    T* dv_row = dv + kv_off + (long)t * kv_stride;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk_row[tx + 16 * c] = ptt::from_f32<T>(dk_acc[i][c]);
      dv_row[tx + 16 * c] = ptt::from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const int* qseg, const int* kvseg, const int* kv_lens, int B, int H,
                       int Hkv, int Tq, int Tkv, int causal, int causal_offset, float scale,
                       cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  const cudaError_t attr = ptt::allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Tkv + BK - 1) / BK, B * Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, ptt::kThreads, smem, stream>>>(
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
