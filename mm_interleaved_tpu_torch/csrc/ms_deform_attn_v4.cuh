// What the v4 deformable kernels share (ms_deform_attn_v4.cu, the forward,
// and ms_deform_attn_v4_bwd.cu, the two backward kernels): the tile sizes,
// the level table, the staging of a query tile's samples, one entry of the
// bilinear matrix A, and the bf16 tensor-core product m16n8k16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxP = 64;
constexpr int kMaxD = 128;
constexpr int kTQ = 64;        // queries per tile
constexpr int kKC = 64;        // texels per chunk
constexpr int kThreads = 256;
constexpr int kPad = 8;        // bf16 elements of row padding
constexpr int kMaxNB = kMaxD / 16;  // n-blocks of 8 per warp (bf16)
constexpr int kMaxCols = kMaxD / 16;  // channels per thread (fp32)

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// level_hw: host array (h0, w0, h1, w1, ...).  Returns a cudaError_t code:
// the levels' texels must add up to S.
int fill_levels(const int* level_hw, int L, int S, Levels* lv) {
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float hat(float t) {
  return fmaxf(1.f - fabsf(t), 0.f);
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
      x = to_f32(loc[2 * s]) * wl - 0.5f;
      y = to_f32(loc[2 * s + 1]) * hl - 0.5f;
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
