// The tensor cores' rates on this card, and a check of the Hopper building
// blocks the width-128 backward kernel uses (csrc/hopper.cuh).
//
// Rates: mma.sync (one block per SM of 4, 8 or 16 warps, each warp issuing
// iters x 16 independent products on register operands; TF32 m16n8k8, the
// forward's instruction, and bf16 m16n8k16), then wgmma with A from
// registers and B from shared memory (one block per SM of 1, 2 or 3
// warpgroups, each issuing iters x 16 products into one 64 x 128
// accumulator; bf16 m64n128k16, the backward's instruction, and TF32
// m64n128k8).
// Checks (each prints ok or the error and makes the exit code 1): the wgmma
// operand layouts of hopper.cuh (B N-major and K-major, two k-steps, against
// a host product), those of the width-192 backward (64 x 96, A from shared
// memory or registers), a bulk copy into shared memory completing on an
// mbarrier, and bulk reduce-adds into global memory after generic writes.
// Built and run by tools/kernel_breakdown.py.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <vector>

#include "../csrc/hopper.cuh"

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

// wgmma rate: each warpgroup issues iters x 16 products of 64 x 128 x K
// into its accumulator, B a 16 KB block of shared memory.
template <bool TF32>
__global__ void kw(float* out, int iters, uint32_t seed) {
  extern __shared__ __align__(128) uint8_t smem[];
  for (int i = threadIdx.x; i < 16384 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = (seed ^ i) & 0x3f803f80u;
  __syncthreads();
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = (seed ^ (threadIdx.x * 7 + i)) & 0x3f803f80u;
  const uint64_t desc = iit::wg_desc(iit::smem_u32(smem));
  for (int it = 0; it < iters; ++it) {
    iit::wg_fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (TF32)
        iit::wg_tf32_n128(d, a, desc + 8 * (j & 1), 1);
      else
        iit::wg_bf16_n128<1>(d, a, desc + 8 * (j & 1), 1);
    }
    iit::wg_commit();
    iit::wg_wait<0>();
    iit::fence_regs(d);
  }
  float s = 0;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// ---------------------------------------------------------------- checks

static uint16_t to_bf16(float x) {  // exact for the small integers used here
  uint32_t u;
  memcpy(&u, &x, 4);
  return (uint16_t)(u >> 16);
}

// D (64 x 128) = A (64 x 32) B (32 x 128) in two k-steps; B in shared memory
// in the layout of hopper.cuh for TB (1: N-major), the descriptor's leading
// and stride offsets as given.
template <int TB>
__global__ void layout_check(const float* A, const uint16_t* Bs, float* D, uint32_t lbo,
                             uint32_t sbo) {
  __shared__ __align__(128) uint16_t b_s[32 * 128];
  for (int i = threadIdx.x; i < 32 * 128; i += blockDim.x) b_s[i] = Bs[i];
  __syncthreads();
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 123.f;  // scale_d = 0 ignores it
  uint32_t a[2][4];
  for (int kk = 0; kk < 2; ++kk)
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * w + g + 8 * (j & 1), c = 16 * kk + 2 * t + 8 * (j >> 1);
      a[kk][j] = iit::bf16x2(A[r * 32 + c], A[r * 32 + c + 1]);
    }
  iit::wg_fence();
  for (int kk = 0; kk < 2; ++kk)
    iit::wg_bf16_n128<TB>(d, a[kk], iit::wg_desc(iit::smem_u32(b_s) + 4096 * kk, lbo, sbo),
                          kk);
  iit::wg_commit();
  iit::wg_wait<0>();
  iit::fence_regs(d);
  for (int ni = 0; ni < 16; ++ni)
    for (int q = 0; q < 4; ++q)
      D[(16 * w + g + 8 * (q >> 1)) * 128 + 8 * ni + 2 * t + (q & 1)] = d[4 * ni + q];
}

static int check_layouts() {
  const int K = 32;
  std::vector<float> A(64 * K), B(K * 128), ref(64 * 128, 0.f);
  for (int r = 0; r < 64; ++r)
    for (int c = 0; c < K; ++c) A[r * K + c] = (float)((r * 7 + c * 3) % 13 - 6);
  for (int kq = 0; kq < K; ++kq)
    for (int n = 0; n < 128; ++n) B[kq * 128 + n] = (float)((kq * 5 + n * 11) % 9 - 4);
  for (int r = 0; r < 64; ++r)
    for (int n = 0; n < 128; ++n)
      for (int kq = 0; kq < K; ++kq) ref[r * 128 + n] += A[r * K + kq] * B[kq * 128 + n];
  float *dA, *dD;
  uint16_t* dB;
  cudaMalloc(&dA, A.size() * 4);
  cudaMalloc(&dD, ref.size() * 4);
  cudaMalloc(&dB, B.size() * 2);
  cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
  int bad = 0;
  for (int tb = 0; tb < 2; ++tb) {
    std::vector<uint16_t> img(K * 128);
    for (int kq = 0; kq < K; ++kq)
      for (int n = 0; n < 128; ++n) {
        const int core = ((kq >> 3) * 16 + (n >> 3)) * 64;  // in bf16 values
        const int at = tb ? core + (kq & 7) * 8 + (n & 7) : core + (n & 7) * 8 + (kq & 7);
        img[at] = to_bf16(B[kq * 128 + n]);
      }
    cudaMemcpy(dB, img.data(), img.size() * 2, cudaMemcpyHostToDevice);
    cudaMemset(dD, 0, ref.size() * 4);
    if (tb)
      layout_check<1><<<1, 128>>>(dA, dB, dD, iit::kLbo, iit::kSbo);
    else
      layout_check<0><<<1, 128>>>(dA, dB, dD, iit::kLbo, iit::kSbo);
    std::vector<float> D(ref.size());
    const cudaError_t err = cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
    float worst = 0.f;
    for (size_t i = 0; i < D.size(); ++i) {
      const float e = D[i] > ref[i] ? D[i] - ref[i] : ref[i] - D[i];
      worst = e > worst ? e : worst;
    }
    const bool ok = err == cudaSuccess && worst == 0.f;
    printf("check wgmma layout B %s, lbo %u sbo %u: %s (max err %g, %s)\n",
           tb ? "N-major" : "K-major", iit::kLbo, iit::kSbo, ok ? "ok" : "WRONG", worst,
           cudaGetErrorString(err));
    bad |= !ok;
  }
  cudaFree(dA);
  cudaFree(dB);
  cudaFree(dD);
  return bad;
}

// The width-192 backward's products (csrc/sine_mlp.cu), D (64 x 96) = A (64
// x 32) B (32 x 96), two k-steps: (a) SS, A in its act_s layout (element
// (r, c) at ((c / 8) * 8 + r / 8) * 128 + (r % 8) * 16 + (c % 8) * 2 bytes),
// B the columns 96 h .. 96 h + 95 of a 32 x 192 W image (core matrix (kg,
// ng) at (kg * 24 + ng) * 128 bytes) in either major order; (b) RS, A from
// registers, B the columns 96 h .. of act_s read N-major (k = row).
template <int MODE>  // 0: SS, B K-major; 1: SS, B N-major; 2: RS, B from act_s
__global__ void layout_check96(const float* A, const uint16_t* As, const uint16_t* Bs, float* D,
                               int half) {
  __shared__ __align__(128) uint16_t a_s[64 * 32];
  __shared__ __align__(128) uint16_t b_s[64 * 192];
  for (int i = threadIdx.x; i < 64 * 32; i += blockDim.x) a_s[i] = As[i];
  for (int i = threadIdx.x; i < 64 * 192; i += blockDim.x) b_s[i] = Bs[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float d[48];
  for (int i = 0; i < 48; ++i) d[i] = 123.f;  // scale_d = 0 ignores it
  uint32_t a[2][4];
  for (int kk = 0; kk < 2; ++kk)
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * w + g + 8 * (j & 1), c = 16 * kk + 2 * t + 8 * (j >> 1);
      a[kk][j] = iit::bf16x2(A[r * 32 + c], A[r * 32 + c + 1]);
    }
  const uint32_t as = iit::smem_u32(a_s), bs = iit::smem_u32(b_s);
  iit::wg_fence();
  for (int kk = 0; kk < 2; ++kk) {
    if (MODE == 2)  // B: act_s of a 32-row (K) x 192 tile, k-step kk = rows 16 kk ..
      iit::wg_bf16_n96<1>(d, a[kk], iit::wg_desc(bs + half * 12 * 512 + kk * 2 * 128, 128, 512),
                          kk);
    else
      iit::wg_bf16_ss_n96<0, MODE>(d, iit::wg_desc(as + kk * 2 * 1024, 1024, 128),
                                   iit::wg_desc(bs + kk * 24 * 128 * 2 + half * 12 * 128,
                                                24 * 128, 128),
                                   kk);
  }
  iit::wg_commit();
  iit::wg_wait<0>();
  iit::fence_regs(d);
  for (int ni = 0; ni < 12; ++ni)
    for (int q = 0; q < 4; ++q)
      D[(16 * w + g + 8 * (q >> 1)) * 96 + 8 * ni + 2 * t + (q & 1)] = d[4 * ni + q];
}

static int check_layouts96() {
  const int K = 32, N = 192;
  std::vector<float> A(64 * K), B(K * N);
  for (int r = 0; r < 64; ++r)
    for (int c = 0; c < K; ++c) A[r * K + c] = (float)((r * 7 + c * 3) % 13 - 6);
  for (int kq = 0; kq < K; ++kq)
    for (int n = 0; n < N; ++n) B[kq * N + n] = (float)((kq * 5 + n * 11) % 9 - 4);
  // A in act_s's layout (64 rows, 32 columns: 4 column groups of 8 x 128 B)
  std::vector<uint16_t> a_img(64 * K);
  for (int r = 0; r < 64; ++r)
    for (int c = 0; c < K; ++c)
      a_img[(((c >> 3) * 8 + (r >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2) / 2] =
          to_bf16(A[r * K + c]);
  float *dA, *dD;
  uint16_t *dAs, *dB;
  cudaMalloc(&dA, A.size() * 4);
  cudaMalloc(&dD, 64 * 96 * 4);
  cudaMalloc(&dAs, a_img.size() * 2);
  cudaMalloc(&dB, 64 * 192 * 2);
  cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dAs, a_img.data(), a_img.size() * 2, cudaMemcpyHostToDevice);
  int bad = 0;
  for (int mode = 0; mode < 3; ++mode)
    for (int half = 0; half < 2; ++half) {
      std::vector<uint16_t> img(64 * 192, 0);
      for (int kq = 0; kq < K; ++kq)
        for (int n = 0; n < N; ++n) {
          int at;  // in bf16 values
          if (mode == 2)  // act_s of a 32 x 192 tile: (n / 8) * 4 row groups
            at = (((n >> 3) * 4 + (kq >> 3)) * 128 + (kq & 7) * 16 + (n & 7) * 2) / 2;
          else {
            const int core = ((kq >> 3) * 24 + (n >> 3)) * 64;
            at = mode ? core + (kq & 7) * 8 + (n & 7) : core + (n & 7) * 8 + (kq & 7);
          }
          img[at] = to_bf16(B[kq * N + n]);
        }
      cudaMemcpy(dB, img.data(), img.size() * 2, cudaMemcpyHostToDevice);
      cudaMemset(dD, 0, 64 * 96 * 4);
      if (mode == 0) layout_check96<0><<<1, 128>>>(dA, dAs, dB, dD, half);
      if (mode == 1) layout_check96<1><<<1, 128>>>(dA, dAs, dB, dD, half);
      if (mode == 2) layout_check96<2><<<1, 128>>>(dA, dAs, dB, dD, half);
      std::vector<float> D(64 * 96);
      const cudaError_t err = cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
      float worst = 0.f;
      for (int r = 0; r < 64; ++r)
        for (int n = 0; n < 96; ++n) {
          float ref = 0.f;
          for (int kq = 0; kq < K; ++kq) ref += A[r * K + kq] * B[kq * N + 96 * half + n];
          const float e = D[r * 96 + n] > ref ? D[r * 96 + n] - ref : ref - D[r * 96 + n];
          worst = e > worst ? e : worst;
        }
      const bool ok = err == cudaSuccess && worst == 0.f;
      printf("check wgmma m64n96 %s, columns %d..: %s (max err %g, %s)\n",
             mode == 0 ? "SS, B K-major" : mode == 1 ? "SS, B N-major" : "RS, B act_s N-major",
             96 * half, ok ? "ok" : "WRONG", worst, cudaGetErrorString(err));
      bad |= !ok;
    }
  cudaFree(dA);
  cudaFree(dAs);
  cudaFree(dB);
  cudaFree(dD);
  return bad;
}

// A bulk copy of 8 KB into shared memory on an mbarrier, then two bulk
// reduce-adds of it into out (zeroed here by generic stores first).
__global__ void bulk_check(const float* src, float* out) {
  __shared__ __align__(128) float buf[2048];
  __shared__ __align__(8) uint64_t bar;
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) out[i] = 0.f;
  iit::fence_async_global();
  if (threadIdx.x == 0) {
    iit::mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    iit::mbar_expect_tx(&bar, 8192);
    iit::bulk_g2s(buf, src, 8192, &bar);
  }
  iit::mbar_wait(&bar, 0);
  if (threadIdx.x == 0) {
    for (int rep = 0; rep < 2; ++rep) {
      iit::bulk_reduce_add(out, buf, 8192);
      iit::bulk_commit();
      iit::bulk_wait_all();
    }
  }
}

static int check_bulk() {
  std::vector<float> h(2048);
  for (int i = 0; i < 2048; ++i) h[i] = (float)(i % 97) * 0.25f;
  float *src, *out;
  cudaMalloc(&src, 8192);
  cudaMalloc(&out, 8192);
  cudaMemcpy(src, h.data(), 8192, cudaMemcpyHostToDevice);
  bulk_check<<<1, 128>>>(src, out);
  std::vector<float> o(2048);
  const cudaError_t err = cudaMemcpy(o.data(), out, 8192, cudaMemcpyDeviceToHost);
  int wrong = 0;
  for (int i = 0; i < 2048; ++i) wrong += o[i] != 2.f * h[i];
  printf("check bulk copy + reduce-add: %s (%d wrong, %s)\n",
         err == cudaSuccess && !wrong ? "ok" : "WRONG", wrong, cudaGetErrorString(err));
  cudaFree(src);
  cudaFree(out);
  return err != cudaSuccess || wrong;
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
  cudaFuncSetAttribute(kw<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, 16384);
  cudaFuncSetAttribute(kw<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, 16384);
  const int witers = 1024;
  for (int kind = 0; kind < 2; ++kind)
  for (int groups : {1, 2, 3}) {
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      if (kind == 0) kw<false><<<sms, groups * 128, 16384>>>(out, witers, 12345);
      else kw<true><<<sms, groups * 128, 16384>>>(out, witers, 12345);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double flop = (double)sms * groups * witers * 16 * 2.0 * 64 * 128 * (kind == 0 ? 16 : 8);
      if (rep) printf("%s warpgroups/SM %d: %.3f ms, %.1f TFLOP/s\n", kind == 0 ? "bf16 wgmma m64n128k16" : "tf32 wgmma m64n128k8 ", groups, ms, flop / ms / 1e9);
    }
  }
  printf("err %s\n", cudaGetErrorString(cudaGetLastError()));
  const int bad = check_layouts() | check_layouts96() | check_bulk();
  printf("checks %s\n", bad ? "FAILED" : "ok");
  return bad;
}
