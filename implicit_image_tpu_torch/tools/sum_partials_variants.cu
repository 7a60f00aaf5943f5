// Candidates for sum_partials (csrc/sine_mlp.cu) that are not variants of
// its constants, for tools/sum_partials_ab.py. Each entry point has the
// signature of the library's sum_partials:
//   (partials, out, n_blocks, n_part, stream) -> cudaError_t
// and each candidate's order of additions is that of
// sum_partials_reference(partials, groups) with the groups named below.
//
//   sum_scalar     the design sum_partials replaced: one thread per column,
//                  4-byte loads, all rows in index order (groups = 1), a
//                  grid of ceil(P / 256) blocks of 256 threads.
//   sum_cluster2   rows split over the 2 blocks of a thread-block cluster
//                  (groups = 2): each block sums its rows for the
//                  cluster's float4 columns, one column a thread, then
//                  block rank q adds the ranks' sums, read through
//                  distributed shared memory in rank order, for its share
//                  of the columns. One cluster per 2 SMs (at most as many
//                  as can be resident), each with an equal run of columns.
//                  (Clusters of 4, 768 threads, read 0.028 ms against
//                  0.021 on an H100.)
//   read_flat      not a sum: the same bytes read in address order (float4
//                  loads, a grid-stride loop, 4 blocks of 512 threads per
//                  SM), what reading the buffer once costs on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void sum_scalar_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                  int n_blocks, int n_part) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_part) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(size_t)b * n_part + p];
  out[p] = s;
}

template <int CS, int THREADS, int U>
__global__ void __launch_bounds__(THREADS)
sum_cluster_kernel(const float4* __restrict__ part, float4* __restrict__ out, int n_rows,
                   int n_cols) {
  __shared__ float4 red[THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_cl = gridDim.x / CS, cl = blockIdx.x / CS;
  const int groups = n_rows < CS ? n_rows : CS;
  const int r0 = rank < groups ? rank * n_rows / groups : 0;
  const int r1 = rank < groups ? (rank + 1) * n_rows / groups : 0;
  const int c0 = (int)((long long)cl * n_cols / n_cl);
  const int c1 = (int)((long long)(cl + 1) * n_cols / n_cl);
  const int t = threadIdx.x;
  for (int base = c0; base < c1; base += THREADS) {
    const int width = c1 - base < THREADS ? c1 - base : THREADS;
    if (t < width && rank < groups) {
      const float4* p = part + base + t;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = r0; r < r1; r += U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (r + u < r1) v[u] = __ldcs(p + (size_t)(r + u) * n_cols);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (r + u < r1) s = add4(s, v[u]);
      }
      red[t] = s;
    }
    cluster.sync();
    const int lo = rank * width / CS, hi = (rank + 1) * width / CS;
    for (int j = lo + t; j < hi; j += THREADS) {
      float4 s = *cluster.map_shared_rank(&red[j], 0);
      for (int q = 1; q < groups; ++q) s = add4(s, *cluster.map_shared_rank(&red[j], q));
      out[base + j] = s;
    }
    cluster.sync();
  }
}

__global__ void __launch_bounds__(512)
read_flat_kernel(const float4* __restrict__ p, float4* __restrict__ out, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += 8 * stride) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i + u * stride < n4) v[u] = __ldcs(p + i + u * stride);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i + u * stride < n4) s = add4(s, v[u]);
  }
  if (s.x == 12345.f) out[0] = s;  // keeps the loads
}

int sms_of_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <int CS, int THREADS, int U>
int launch_cluster(const float* partials, float* out, int n_blocks, int n_part, void* stream) {
  if (n_part <= 0 || n_blocks <= 0) return 0;
  if (n_part % 4 != 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = sms_of_device(&sms)) return err;
  auto kernel = sum_cluster_kernel<CS, THREADS, U>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  int n_cl = sms / CS;
  if (active > 0 && active < n_cl) n_cl = active;
  const int n_cols = n_part / 4;
  if (n_cl > n_cols) n_cl = n_cols;
  cfg.gridDim = dim3(n_cl * CS);
  return (int)cudaLaunchKernelEx(&cfg, kernel, reinterpret_cast<const float4*>(partials),
                                 reinterpret_cast<float4*>(out), n_blocks, n_cols);
}

}  // namespace

extern "C" {

int sum_scalar(const float* partials, float* out, int n_blocks, int n_part, void* stream) {
  if (n_part <= 0) return 0;
  sum_scalar_kernel<<<(n_part + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      partials, out, n_blocks, n_part);
  return (int)cudaGetLastError();
}

// 132 SMs, 99,844 floats: 66 clusters of 378 float4 columns, 384 threads
int sum_cluster2(const float* partials, float* out, int n_blocks, int n_part, void* stream) {
  return launch_cluster<2, 384, 16>(partials, out, n_blocks, n_part, stream);
}

int read_flat(const float* partials, float* out, int n_blocks, int n_part, void* stream) {
  int sms = 0;
  if (int err = sms_of_device(&sms)) return err;
  read_flat_kernel<<<4 * sms, 512, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partials), reinterpret_cast<float4*>(out),
      (long long)n_blocks * n_part / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
