// What the v4 deformable kernels share (ms_deform_attn_v4.cu, the forward,
// and ms_deform_attn_v4_bwd.cu, the two backward kernels): the limits, the
// texel coordinate of a location, the hat and its slope; for the value
// gradient (the one kernel that still builds the dense bilinear matrix A)
// the tile sizes, the staging of a query tile's samples, one entry of A
// and the bf16 tensor-core product m16n8k16.  The level table and the
// gathers' row reads are ms_deform_attn_common.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_common.cuh"

namespace {

using deform::fill_levels;
using deform::kMaxLevels;
using deform::Levels;
using deform::to_f32;

constexpr int kMaxP = 64;
constexpr int kMaxD = 128;
constexpr int kTQ = 64;        // queries per tile
constexpr int kKC = 64;        // texels per chunk
constexpr int kThreads = 256;
constexpr int kPad = 8;        // bf16 elements of row padding
constexpr int kMaxNB = kMaxD / 16;  // n-blocks of 8 per warp (bf16)
constexpr int kMaxCols = kMaxD / 16;  // channels per thread (fp32)

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

// The tile's samples of level l in texel coordinates: xs, ys, aw, each
// [kTQ][P]; a query past Q gets weight 0, so its row of A is 0.
template <typename T>
__device__ void stage_samples(const T* __restrict__ loc,
                              const T* __restrict__ weight, float* xs,
                              float* ys, float* aw, int n, int h, int q0,
                              int Q, int H, int L, int P, int l, int hl,
                              int wl) {
  for (int i = threadIdx.x; i < kTQ * P; i += kThreads) {
    const int r = i / P, p = i - r * P;
    const int q = q0 + r;
    float x = 0.f, y = 0.f, a = 0.f;
    if (q < Q) {
      const int64_t s = (((int64_t)n * Q + q) * H + h) * L * P + l * P + p;
      x = v4_coord(to_f32(loc[2 * s]), wl);
      y = v4_coord(to_f32(loc[2 * s + 1]), hl);
      a = to_f32(weight[s]);
    }
    xs[i] = x;
    ys[i] = y;
    aw[i] = a;
  }
}

// A[r, texel (tx, ty)] = sum_p hat(tx - xs_p) * (hat(ty - ys_p) * aw_p), the
// order of the TPU kernel's build.
__device__ __forceinline__ float a_entry(const float* xs, const float* ys,
                                         const float* aw, int r, int P,
                                         float tx, float ty) {
  const float* xr = xs + r * P;
  const float* yr = ys + r * P;
  const float* ar = aw + r * P;
  float s = 0.f;
  for (int p = 0; p < P; ++p) {
    s += hat(tx - xr[p]) * (hat(ty - yr[p]) * ar[p]);
  }
  return s;
}

// c += a . b, a 16x16 row-major and b 16x8 column-major bf16 fragments.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Lets ``kernel`` take ``smem`` bytes of dynamic shared memory.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
