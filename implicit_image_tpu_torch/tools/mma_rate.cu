// The rate of mma.sync on this card: one block per SM of 4, 8 or 16 warps,
// each warp issuing iters x 16 independent products (16 accumulators) on
// register operands; TF32 m16n8k8 (the kernels' instruction) and bf16
// m16n8k16 beside it. Built and run by tools/kernel_breakdown.py.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__global__ void k(float* out, int iters, uint32_t seed) {
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed ^ (threadIdx.x * 7 + i);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 3 + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    a[0] += 1; b[1] ^= it;
  }
  float s = 0;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void kb(float* out, int iters, uint32_t seed) {  // bf16 m16n8k16 for comparison
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed ^ (threadIdx.x * 7 + i);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 3 + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    a[0] += 1; b[1] ^= it;
  }
  float s = 0;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out; cudaMalloc(&out, sms * 1024 * 4 * sizeof(float));
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const int iters = 4096;
  for (int kind = 0; kind < 2; ++kind)
  for (int warps : {4, 8, 16}) {
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      if (kind == 0) k<<<sms, warps * 32>>>(out, iters, 12345); else kb<<<sms, warps * 32>>>(out, iters, 12345);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double flop = (double)sms * warps * iters * 16 * (kind == 0 ? 2.0 * 16 * 8 * 8 : 2.0 * 16 * 8 * 16);
      if (rep) printf("%s warps/SM %2d: %.3f ms, %.1f TFLOP/s\n", kind == 0 ? "tf32 m16n8k8 " : "bf16 m16n8k16", warps, ms, flop / ms / 1e9);
    }
  }
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
