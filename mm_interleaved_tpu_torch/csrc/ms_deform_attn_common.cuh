// Helpers shared by the deformable forward (ms_deform_attn.cu) and its
// backward (ms_deform_attn_bwd.cu): the level table, fp32 widening and
// narrowing of 16-byte vectors, the group width of the Hopper bodies, and
// the bilinear geometry of one sample.
//
// The geometry rounds as the plain version does (x = loc * W - 0.5 as a
// product, then a difference, no fused multiply-add), in every kernel that
// calls it: the value gradient bins a sample by its corner cell in one
// kernel and finds its corner weights again in another, and the two must
// agree on the floor of every coordinate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace deform {

constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// level_hw: host array (h0, w0, h1, w1, ...); 0, or an error if the levels
// do not sum to S.
inline int fill_levels(const int* level_hw, int L, int S, Levels* lv) {
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == S ? 0 : (int)cudaErrorInvalidValue;
}

// The lanes a sample (or a texel) takes in the grouped bodies:
// D * elem / 16 where that is 4, 8 or 16 whole 16-byte vectors, else 0.
inline int group_lanes(int D, int elem) {
  if ((D * elem) % 16) return 0;
  const int g = D * elem / 16;
  return g == 4 || g == 8 || g == 16 ? g : 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes widened to fp32: 8 bf16 (shift or mask) or 4 fp32
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// fp32 narrowed to 16 bytes of V, rounded to nearest even
__device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 narrow(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// The (x, y) location of sample g as one 4- or 8-byte load (the locations
// start on a boundary of two elements, which the caller checked).
__device__ __forceinline__ float2 load_xy(const __nv_bfloat16* loc,
                                          int64_t g) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(loc) + g);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 load_xy(const float* loc, int64_t g) {
  return __ldg(reinterpret_cast<const float2*>(loc) + g);
}

// x = l * n - 0.5, the product rounded, then the difference
__device__ __forceinline__ float grid_coord(float l, int n) {
  return __fsub_rn(__fmul_rn(l, (float)n), 0.5f);
}

// The bilinear corners of one sample on level (hl, wl): fractions, the
// texel of corner (x0, y0) in the level, and the in-bounds corners as bits
// 0-3 of (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1).
struct Corners {
  float fx, fy;
  int texel;
  unsigned mask;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int hl,
                                           int wl) {
  const float x = grid_coord(lx, wl);
  const float y = grid_coord(ly, hl);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const bool x0_in = x0 >= 0 && x0 < wl;
  const bool x1_in = x0 + 1 >= 0 && x0 + 1 < wl;
  const bool y0_in = y0 >= 0 && y0 < hl;
  const bool y1_in = y0 + 1 >= 0 && y0 + 1 < hl;
  Corners k;
  k.fx = x - x0f;
  k.fy = y - y0f;
  k.texel = y0 * wl + x0;
  k.mask = (unsigned)(y0_in && x0_in) | (unsigned)(y0_in && x1_in) << 1 |
           (unsigned)(y1_in && x0_in) << 2 | (unsigned)(y1_in && x1_in) << 3;
  return k;
}

// The cell of a sample on level (hl, wl): its corner (x0, y0) shifted by
// one, (y0 + 1) * (wl + 1) + x0 + 1 with x0 in -1 .. wl - 1 and y0 alike;
// -1 where no corner is in bounds (x0 or y0 outside that range, or NaN).
__device__ __forceinline__ int cell_of(float lx, float ly, int hl, int wl) {
  const float x0f = floorf(grid_coord(lx, wl));
  const float y0f = floorf(grid_coord(ly, hl));
  if (!(x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
        y0f <= (float)(hl - 1)))
    return -1;
  return ((int)y0f + 1) * (wl + 1) + (int)x0f + 1;
}

// The corners of the sample lane ``src`` set up (its texel, and its level
// width with the in-bounds bits as ``wl << 4 | mask``), loaded as this
// lane's 16-byte vector of each; zeros where out of bounds.
template <typename V>
__device__ __forceinline__ void load_corners(const V* vbase, int64_t row,
                                             int texel, int packed, int src,
                                             uint4 (&c)[4]) {
  const int t = __shfl_sync(kFull, texel, src);
  const int pk = __shfl_sync(kFull, packed, src);
  const int wl = pk >> 4;
  const int64_t off[4] = {t, t + 1, t + wl, t + wl + 1};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = pk >> i & 1 ? __ldg(reinterpret_cast<const uint4*>(
                             vbase + off[i] * row))
                       : make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace deform
