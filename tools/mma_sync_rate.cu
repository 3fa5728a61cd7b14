// The rate of mma.sync on this card: TF32 m16n8k8 (what the flash kernels
// issue) and bf16 m16n8k16 for comparison, with 1 to 16 independent
// accumulators per warp and 4 or 8 warps per block, 1 to 4 blocks per SM.
// One accumulator shows the latency of a dependent chain; many show the
// throughput the tensor cores give mma.sync (wgmma, which Hopper's 495
// TFLOP/s TF32 peak assumes, is not measured here).
//
// Build and run on the card (tools/flash_variants.py does both):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate tools/mma_sync_rate.cu
//   ./mma_sync_rate
// Prints one JSON object per configuration.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

__device__ __forceinline__ void mma(float c[4], uint32_t a, uint32_t b, bool bf16) {
  if (bf16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%4,%4,%4}, "
        "{%5,%5}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a), "r"(b));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%4,%4,%4}, "
        "{%5,%5}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a), "r"(b));
}

template <int NACC, bool BF16>
__global__ void chain(float* out, int iters) {
  float c[NACC][4] = {};
  const uint32_t a = 0x3f800000u ^ threadIdx.x, b = 0x3c000000u ^ threadIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma(c[j], a + j, b, BF16);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC, bool BF16>
void run(int warps, int blocks_per_sm) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * blocks_per_sm, threads = 32 * warps, iters = 4096;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  chain<NACC, BF16><<<blocks, threads>>>(out, 16);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chain<NACC, BF16><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * (BF16 ? 16 : 8) * double(blocks) * warps * iters * NACC;
  printf("{\"type\": \"%s\", \"accumulators\": %d, \"warps_per_block\": %d, "
         "\"blocks_per_sm\": %d, \"ms\": %.4f, \"tflops\": %.1f, \"error\": \"%s\"}\n",
         BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8", NACC, warps, blocks_per_sm, ms,
         flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
}

int main() {
  run<1, false>(4, 1);
  run<4, false>(4, 1);
  run<8, false>(4, 2);
  run<4, false>(8, 2);
  run<16, false>(4, 4);
  run<8, true>(4, 2);
  run<8, true>(8, 2);
  return 0;
}
