// Polynomial sine / cosine as device functions.
//
// Replaces implicit_image_tpu/ops/fast_math.py (fast_sin / fast_cos), which
// ran inside the Pallas SIREN kernels. Same coefficients and the same range
// reduction as the plain-torch version (implicit_image_tpu_torch/ops/
// fast_math.py):
//
//     r = x - 2*pi * round(x / 2*pi);  sin(x) ~ r * P(r^2),  cos(x) ~ Q(r^2)
//
// rintf rounds half to even, like jnp.round and torch.round. nvcc may fuse a
// multiply and an add into one FMA here, so values can differ from the plain
// version in the last bit; the kernels are held to it with a tolerance.
#pragma once

namespace iit {

constexpr float kInv2Pi = 0.15915494309189535f;
constexpr float k2Pi = 6.283185307179586f;

__device__ __forceinline__ float fast_reduce(float x) {
  return x - k2Pi * rintf(x * kInv2Pi);
}

// degree-11 odd minimax on [-pi, pi], max abs error 9.2e-6, of r reduced
__device__ __forceinline__ float sin_reduced(float r) {
  const float r2 = r * r;
  float p = -2.036590317570578e-08f * r2 + 2.6998131630169804e-06f;
  p = p * r2 + -0.00019808729483123406f;
  p = p * r2 + 0.008332407064488198f;
  p = p * r2 + -0.1666655332933119f;
  p = p * r2 + 0.9999996030550975f;
  return r * p;
}

// degree-12 even minimax on [-pi, pi], max abs error 1.1e-8, of r reduced
__device__ __forceinline__ float cos_reduced(float r) {
  const float r2 = r * r;
  float p = 1.7247600397804802e-09f * r2 + -2.707977385440803e-07f;
  p = p * r2 + 2.4769966014001128e-05f;
  p = p * r2 + -0.0013887807813544165f;
  p = p * r2 + 0.04166649019185378f;
  p = p * r2 + -0.4999998918402563f;
  p = p * r2 + 0.9999999892018047f;
  return p;
}

__device__ __forceinline__ float fast_sin(float x) { return sin_reduced(fast_reduce(x)); }
__device__ __forceinline__ float fast_cos(float x) { return cos_reduced(fast_reduce(x)); }

// fast_sin(x) and fast_cos(x) from one range reduction: the bits of the two
// calls (the same argument, the same arithmetic), one reduction less.
__device__ __forceinline__ void fast_sincos(float x, float& s, float& c) {
  const float r = fast_reduce(x);
  s = sin_reduced(r);
  c = cos_reduced(r);
}

}  // namespace iit
