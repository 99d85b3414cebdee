// f32 arithmetic that rounds as PyTorch's CUDA operations do, shared by
// the kernels that are bitwise their plain torch versions. A file that
// includes it is built with --fmad=false, so nothing is contracted into a
// fused multiply-add that the plain version does not make:
// - every product, sum and quotient is __fmul_rn/__fadd_rn/__fsub_rn/
//   __fdiv_rn in the plain version's order;
// - torch.sum over a last axis of 3 runs on two threads of a reduction
//   that start from +0, so it takes (a0 + a2) + a1, a zero sum +0;
// - math/geometry.py::fma32 rounds a * b + c once in f64 and once more to
//   f32, and dot3_fma chains two of them after an f32 product;
// - torch.clamp passes NaN through; sqrt_rn is the correctly rounded
//   __fsqrt_rn.
#pragma once

#include <cuda_runtime.h>

namespace szg {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return add(add(add(a0, a2), a1), 0.0f); }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}

// fma32(a, b, c): the f64 product is exact, the f64 sum rounds, then f32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
}

// dot3_fma: fma(a2, b2, fma(a1, b1, a0 * b0))
__device__ __forceinline__ float dot3_fma(const float* a, const float* b) {
  return fma32(a[2], b[2], fma32(a[1], b[1], mul(a[0], b[0])));
}

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp01(float v) { return clamp(v, 0.0f, 1.0f); }

__device__ __forceinline__ float safe_sqrt(float v) { return __fsqrt_rn(clamp_min(v, 0.0f)); }

// torch.amax, torch.minimum, torch.maximum: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// kernels/atmosphere.py::_norm: sqrt_rn(clamp(sum(v * v), 1e-20))
__device__ __forceinline__ float norm3(const float* v) {
  return __fsqrt_rn(clamp_min(dot3(v, v), static_cast<float>(1e-20)));
}

// kernels/lighting.py::_normalize: v / sqrt_rn(clamp(sum(v * v), 1e-20))
__device__ __forceinline__ void normalize3(const float* v, float* out) {
  const float len = norm3(v);
  for (int c = 0; c < 3; ++c) out[c] = div(v[c], len);
}

// kernels/sky.py::_norm3: sqrt_rn(clamp(dot3_fma(v, v), 1e-20))
__device__ __forceinline__ float norm3_fma(const float* v) {
  return __fsqrt_rn(clamp_min(dot3_fma(v, v), static_cast<float>(1e-20)));
}

// A texel's index: floor(x) of an x clamped to [0, extent - 1]; the clamp
// of the index only guards a NaN x
__device__ __forceinline__ int texel_index(long long floor_x, int extent) {
  return static_cast<int>(min(max(floor_x, 0LL), static_cast<long long>(extent - 1)));
}

}  // namespace szg
