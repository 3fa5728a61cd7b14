// Row-wise sparse SGD of an embedding table for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package updates its DLRM's tables densely
// (XLA scatters the looked-up rows' gradients into a table-sized gradient,
// then p - lr * g runs over every row). On this card that dense update of a
// 13.3 GB table stack is nearly all of a step, while a batch names under 1 %
// of the rows, and under plain SGD a row no id names has a zero gradient and
// stays as it is. So only the named rows are touched.
//
// Function (ops/sparse_sgd.py::sparse_sgd_plain is its plain version): for
// every row r that the index names,
//   table[r] = table[r] - lr * (((0 + g[i0]) + g[i1]) + ...)
// where i0 < i1 < ... are the positions of r in the unsorted index, the sum is
// taken in f32 in that order, and the product and the difference are each
// rounded once (__fmul_rn, __fsub_rn: never contracted to an FMA). That is
// the dense path's arithmetic: PyTorch's index backward sums each row's
// contributions serially in the stable sort's order from a zeroed gradient,
// then `lr * g` and `p - (lr * g)` round once each; so the two paths give the
// same tables bit for bit. The count of rows changed is added to *touched.
//
// Layout contract (set by ops/sparse_sgd.py): table [rows, D] f32 contiguous,
// updated in place, rows < 2^31; sorted [N] int32, the index sorted stably;
// order [N] int64, the unsorted position of each sorted entry; grads [N, D]
// f32 contiguous; touched one uint64; D a multiple of 4 and at most kMaxDim;
// table and grads on 16-byte boundaries.
//
// What bounds it on this card: latency more than bytes. The bytes are each
// row gradient and index entry read once and each named row read and
// written once: ~0.05 ms at 3.35 TB/s at the DLRM cell's size. But every
// step of the work is a dependent load (is this position a run's head? which
// gradient rows? then the rows), and the sums are serial chains: a Zipf
// table's hottest row is named thousands of times a batch, its rows
// scattered over the gradient buffer.
//
// What the design does about it:
// - One warp per sorted position (8 a block), in two dependent round trips:
//   the position's window of the sorted keys, its neighbours and its
//   window of `order` in one; the gradient rows and the table row in the
//   next. A warp whose position does not start a run of equal keys stops
//   after the first. 4 blocks an SM (the register cap of __launch_bounds__)
//   keep 32 warps in flight.
// - Most runs are short: a warp sums a run of at most kShortRun alone, each
//   lane owning a float4 column slice of D, with the run's unsorted positions
//   shuffled from the lanes that loaded them and kUnroll row loads in flight
//   before their adds.
// - A longer run (a hot id) is the whole block's, after its warps' short
//   runs: its 256 threads stream the run through shared memory in stages of
//   up to kStageFloats (64 rows at D = 128), each thread holding the next
//   stage's kStageLoads float4 loads in registers while the current stage is
//   summed, and the stage after next's `order` entries in flight too; one
//   thread per column sums each stage serially.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kShortRun = 32;                       // one warp's run, at most
constexpr int kUnroll = 8;                          // row loads a lane keeps in flight
constexpr int kStageFloats = 8192;                  // 32 KB of rows a stage
constexpr int kStageLoads = kStageFloats / 4 / kThreads;
constexpr int kMaxStageRows = kThreads;             // one order entry a thread, a stage
constexpr int kMaxDim = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sgd(float p, float lr, float g) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

// The warp's run [p, p + len), len <= kShortRun, of row `row`; lane l holds
// order[p + l] in `mine`.
__device__ __forceinline__ void short_run(float4* __restrict__ table,
                                          const float4* __restrict__ grads, long long mine,
                                          int len, long long row, int d4, float lr, int lane) {
  for (int c0 = 0; c0 < d4; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < d4;
    float4* dst = table + row * d4 + c;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) w = *dst;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < len; j0 += kUnroll) {
      float4 g[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long src = __shfl_sync(kFull, mine, (j0 + u) & 31);
        if (active && j0 + u < len) g[u] = __ldg(grads + src * d4 + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (active && j0 + u < len) {
          acc.x = __fadd_rn(acc.x, g[u].x);
          acc.y = __fadd_rn(acc.y, g[u].y);
          acc.z = __fadd_rn(acc.z, g[u].z);
          acc.w = __fadd_rn(acc.w, g[u].w);
        }
      }
    }
    if (active) {
      w.x = sgd(w.x, lr, acc.x);
      w.y = sgd(w.y, lr, acc.y);
      w.z = sgd(w.z, lr, acc.z);
      w.w = sgd(w.w, lr, acc.w);
      *dst = w;
    }
  }
}

// The block's run starting at p, longer than kShortRun; every thread calls
// it. `stage` holds one stage's rows, `ord` two stages' order entries, `acc`
// the run's sums.
__device__ void long_run(float* __restrict__ table, const int* __restrict__ sorted,
                         const long long* __restrict__ order,
                         const float4* __restrict__ grads, long long n, long long p, int dim,
                         float lr, float4* stage, long long (*ord)[kMaxStageRows],
                         float* acc) {
  const int row = sorted[p];
  // Its end: sorted, so the entries equal to `row` past p form a prefix.
  long long end = p + kShortRun;
  for (;;) {
    const long long q = end + threadIdx.x;
    const int same = __syncthreads_count(q < n && __ldg(sorted + q) == row);
    end += same;
    if (same < kThreads) break;
  }
  const long long len = end - p;
  const int d4 = dim / 4;
  const int stage_rows = min(kStageFloats / dim, kMaxStageRows);
  const int t = threadIdx.x;
  for (int c = t; c < dim; c += kThreads) acc[c] = 0.f;
  auto order_of = [&](long long base) -> long long {  // this thread's entry of a stage
    return t < stage_rows && base + t < len ? __ldg(order + p + base + t) : 0;
  };
  // Float4 f = u * kThreads + t of a stage is row f / d4, column slice
  // f % d4: the stage's rows lie in it as in a [stage_rows, D] array.
  float4 g[kStageLoads];
  auto load = [&](long long base, const long long* src) {
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int f = u * kThreads + t;
      const int j = f / d4;
      if (j < stage_rows && base + j < len) g[u] = __ldg(grads + src[j] * d4 + f % d4);
    }
  };

  ord[0][t] = order_of(0);
  ord[1][t] = order_of(stage_rows);
  __syncthreads();
  load(0, ord[0]);
  int k = 0;
  for (long long base = 0; base < len; base += stage_rows, k ^= 1) {
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int f = u * kThreads + t;
      const int j = f / d4;
      if (j < stage_rows && base + j < len) stage[f] = g[u];
    }
    const long long after_next = order_of(base + 2 * stage_rows);
    __syncthreads();
    if (base + stage_rows < len) load(base + stage_rows, ord[k ^ 1]);
    const int rows = static_cast<int>(min(static_cast<long long>(stage_rows), len - base));
    const float* s = reinterpret_cast<const float*>(stage);
    for (int c = t; c < dim; c += kThreads) {
      float a = acc[c];
#pragma unroll 8
      for (int j = 0; j < rows; ++j) a = __fadd_rn(a, s[j * dim + c]);  // loads ahead of adds
      acc[c] = a;
    }
    ord[k][t] = after_next;  // this stage's entries were read last round
    __syncthreads();
  }
  float* dst = table + static_cast<long long>(row) * dim;
  for (int c = t; c < dim; c += kThreads) dst[c] = sgd(dst[c], lr, acc[c]);
  __syncthreads();  // stage, ord and acc are the next long run's
}

__global__ void __launch_bounds__(kThreads, 4)
    sparse_sgd_kernel(float* __restrict__ table, const int* __restrict__ sorted,
                      const long long* __restrict__ order, const float* __restrict__ grads,
                      unsigned long long* __restrict__ touched, long long n, int dim,
                      float lr) {
  __shared__ float4 stage[kStageFloats / 4];
  __shared__ long long ord[2][kMaxStageRows];
  __shared__ float acc[kMaxDim];
  __shared__ long long long_heads[kWarps];
  __shared__ int n_long;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps + warp;
  bool head = false;
  if (p < n) {  // warp-uniform, as is every branch around a shuffle or ballot
    // One round trip: the window sorted[p, p + 32), the neighbours p - 1 and
    // p + 32, and (speculatively) the window of order.
    const long long q = p + lane;
    const int key = q < n ? __ldg(sorted + q) : -1;
    const long long mine = q < n ? __ldg(order + q) : 0;
    int prev = -1, after = -1;
    if (lane == 0) {
      prev = p > 0 ? __ldg(sorted + p - 1) : -1;
      after = p + kShortRun < n ? __ldg(sorted + p + kShortRun) : -1;
    }
    const int row = __shfl_sync(kFull, key, 0);
    head = __shfl_sync(kFull, prev, 0) != row;
    if (head) {
      const int len = __popc(__ballot_sync(kFull, key == row));
      if (len < kShortRun || __shfl_sync(kFull, after, 0) != row) {
        short_run(reinterpret_cast<float4*>(table), reinterpret_cast<const float4*>(grads),
                  mine, len, row, dim / 4, lr, lane);
      } else if (lane == 0) {
        long_heads[atomicAdd(&n_long, 1)] = p;
      }
    }
  }
  const int heads = __syncthreads_count(head && lane == 0);
  if (threadIdx.x == 0 && heads) atomicAdd(touched, static_cast<unsigned long long>(heads));
  for (int i = 0; i < n_long; ++i) {
    long_run(table, sorted, order, reinterpret_cast<const float4*>(grads), n, long_heads[i],
             dim, lr, stage, ord, acc);
  }
}

}  // namespace

// Applies the update to `table` on `stream` and adds the count of rows it
// changes to *touched; returns the launch's cudaError (0 on success). n = 0
// launches nothing.
extern "C" int ptt_sparse_sgd(void* table, const void* sorted, const void* order,
                              const void* grads, void* touched, long long n, int dim,
                              float lr, void* stream) {
  if (dim <= 0 || dim % 4 || dim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sparse_sgd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const int*>(sorted),
      static_cast<const long long*>(order), static_cast<const float*>(grads),
      static_cast<unsigned long long*>(touched), n, dim, lr);
  return static_cast<int>(cudaGetLastError());
}
