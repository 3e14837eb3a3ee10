// What the v4 deformable kernels share (ms_deform_attn_v4.cu, the forward,
// and ms_deform_attn_v4_bwd.cu, the two backward kernels): the limits, the
// texel coordinate of a location, the hat and its slope, one corner's term
// of the bilinear matrix A, and A's rounding to the value's type.  The
// level table and the gathers' row reads are ms_deform_attn_common.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ms_deform_attn_common.cuh"

namespace {

using deform::fill_levels;
using deform::kMaxLevels;
using deform::Levels;
using deform::to_f32;

constexpr int kMaxP = 64;
constexpr int kMaxD = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float hat(float t) {
  return fmaxf(1.f - fabsf(t), 0.f);
}

// sign(t) where |t| < 1, else 0: the hat's derivative (0 at t = 0).
__device__ __forceinline__ float hat_slope(float t) {
  return fabsf(t) < 1.f ? (t > 0.f ? 1.f : (t < 0.f ? -1.f : 0.f)) : 0.f;
}

// A location in texels, loc * n - 0.5, as one fused multiply-add.  Every
// v4 kernel takes its coordinates from here, so that the forward and both
// gradients see the same texels and the same hats.
__device__ __forceinline__ float v4_coord(float loc, int n) {
  return fmaf(loc, (float)n, -0.5f);
}

// The term of A at texel (x, y) of a sample at (xs, ys) with attention
// weight aw: hat(x - xs) * (hat(y - ys) * aw), each step rounded as the
// TPU kernel's dense build rounds it (no fused multiply-add).
__device__ __forceinline__ float corner_term(float x, float y, float xs,
                                             float ys, float aw) {
  const float wy = __fmul_rn(hat(__fsub_rn(y, ys)), aw);
  return __fmul_rn(hat(__fsub_rn(x, xs)), wy);
}

// x rounded to V and back: A is rounded to the value's type after its sum
// over a query's points.
template <typename V>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<V, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

}  // namespace
