// Hopper (sm_90a) building blocks of the wgmma kernels of sine_mlp.cu (the
// forward and backward at widths 128 and 192, the layer-wise
// hidden forward, hidden backward and dW) and of tools/mma_rate.cu, which
// checks them on the card: mbarriers, bulk copies and bulk reduce-adds (the
// TMA unit), tensor copies (a tensor map's box), proxy fences, named
// barriers, register reallocation between warpgroups, and bf16 wgmma with A
// from registers or shared memory and B from shared memory.
//
// Shared-memory operands of wgmma here use no swizzle: an operand is made of
// core matrices, 8 rows of 16 bytes (8 bf16) stored as 128 contiguous bytes.
// An operand of K x N (or M x K) is addressed by a descriptor holding its
// start, the byte stride between core matrices adjacent along K (the
// leading offset) and along N or M (the stride offset). In either major
// order (B K-major: a core matrix row is 8 K values of one n; B N-major,
// "transposed": 8 N values of one k) the width-128 kernels store the core
// matrix of k-group kg and n-group ng at (kg * 16 + ng) * 128 bytes, so
// kLbo = 2048 and kSbo = 128; the width-192 backward's strides are at its
// kernel (tools/mma_rate.cu checks both orders and both kernels' strides).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace iit {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// ------------------------------------------------------ bulk copies (TMA)

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of a tiled tensor map (cuTensorMapEncodeTiled, three dimensions,
// the map a __grid_constant__ kernel parameter) at coordinates {c0, c1, c2}
// (innermost first) from global to shared memory; completes on `bar`'s
// transaction count with the box's bytes (elements outside the tensor read
// as zeros).
__device__ __forceinline__ void tensor_g2s(void* dst, const void* map, int c0, int c1, int c2,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of float c (0-31) of row r in a box of 32-float (128-byte)
// rows as a tensor copy with 128-byte swizzle lays it out (the box 1024-byte
// aligned): the row's 16-byte chunks turned by r % 8.
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// dst[i] += src[i] over bytes / 4 floats, done by the memory system; one bulk
// async-group of the issuing thread until bulk_commit.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// An L2 cache policy (a 64-bit handle for the .L2::cache_hint forms): lines
// touched under evict_first leave L2 before others.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// bulk_reduce_add under an L2 cache policy.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes,
                                                uint64_t policy) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.L2::cache_hint.add.f32 [%0], [%1], "
      "%2, %3;\n" ::"l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the issuing thread's bulk groups are complete (their writes
// done), or READ: until they have read their shared-memory sources.
template <bool READ = false>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of the issuing thread's bulk groups, the most recent,
// are pending: every older one is complete (its writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order the thread's generic-proxy accesses of shared (global) memory
// before later async-proxy ones (bulk copies and reduce-adds).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// --------------------------------------------------------------- barriers

// Named barrier `id` (1-15) over `count` threads, whole warps.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- registers

// The executing warpgroup's registers a thread, raised to or lowered to N
// (a multiple of 8 in 24-256; all four warps execute it). A kernel that
// splits its warpgroups into roles calls one of them at the top of each
// role's branch, and the branches never rejoin.
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ wgmma

constexpr uint32_t kLbo = 2048, kSbo = 128;  // see the top

__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo = kLbo,
                                            uint32_t sbo = kSbo) {
  return (uint64_t)((saddr & 0x3ffff) >> 4) | ((uint64_t)((lbo & 0x3ffff) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffff) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers that an issued wgmma reads or
// writes until the wait that ends it: call on them after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats as a bf16 pair (x0 in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The planes of a float pair: p[0] = bf16(x), p[1] = bf16(x - p[0]),
// p[2] = bf16(x - p[0] - p[1]) (each difference exact in fp32), the first
// NP of them. Three planes hold a finite fp32 value exactly.
template <int NP>
__device__ __forceinline__ void split_planes(float x0, float x1, uint32_t (&p)[NP]) {
  p[0] = bf16x2(x0, x1);
  if constexpr (NP > 1) {
    x0 -= bf16_lo(p[0]);
    x1 -= bf16_hi(p[0]);
    p[1] = bf16x2(x0, x1);
  }
  if constexpr (NP > 2) {
    x0 -= bf16_lo(p[1]);
    x1 -= bf16_hi(p[1]);
    p[2] = bf16x2(x0, x1);
  }
}

#define IIT_D8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32, the accumulator layout below) = (scale_d ? d : 0) +
// A B, A 64 x 16 bf16 from registers (a: the fragment layout below), B 16 x
// 128 bf16 in shared memory at `desc`, N-major (TB = 1) or K-major (TB = 0).
// Thread (warp w of the warpgroup, lane = 4 g + t) holds
//   d[4 ni + q] = D(16 w + g + 8 (q >> 1), 8 ni + 2 t + (q & 1)),
//   a[j] = A(16 w + g + 8 (j & 1), 2 t + 8 (j >> 1) + {0, 1}), low half first,
// so the accumulator of one product is the A fragment of the next: k-step kk
// of A = columns 16 kk .. 16 kk + 15 = d[8 kk .. 8 kk + 7] in pairs.
template <int TB>
__device__ __forceinline__ void wg_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : IIT_D8(0), IIT_D8(8), IIT_D8(16), IIT_D8(24), IIT_D8(32), IIT_D8(40), IIT_D8(48),
        IIT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

// The same in TF32 (m64n128k8, B K-major only; A(16 w + g + 8 (j & 1),
// t + 4 (j >> 1)) in a[j]); tools/mma_rate.cu times it beside bf16.
__device__ __forceinline__ void wg_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : IIT_D8(0), IIT_D8(8), IIT_D8(16), IIT_D8(24), IIT_D8(32), IIT_D8(40), IIT_D8(48),
        IIT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The width-192 backward's products, 64 x 96 (half of the kernel width):
// d[4 ni + q] = D(16 w + g + 8 (q >> 1), 8 ni + 2 t + (q & 1)), ni < 12.
// A from registers (a as above) or from shared memory at `adesc`, K-major
// (TA = 0) or M-major (TA = 1); B as above.
template <int TB>
__device__ __forceinline__ void wg_bf16_n96(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : IIT_D8(0), IIT_D8(8), IIT_D8(16), IIT_D8(24), IIT_D8(32), IIT_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wg_bf16_ss_n96(float (&d)[48], uint64_t adesc, uint64_t bdesc,
                                               int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n}\n"
      : IIT_D8(0), IIT_D8(8), IIT_D8(16), IIT_D8(24), IIT_D8(32), IIT_D8(40)
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef IIT_D8

}  // namespace iit
