// Helpers shared by the deformable forward (ms_deform_attn.cu) and its
// backward (ms_deform_attn_bwd.cu), and by the v1 and v4 kernels
// (ms_deform_attn_v1.cu, ms_deform_attn_v4.cuh): the level table, fp32
// widening and narrowing of 16-byte vectors, the group width of the Hopper
// bodies, the bilinear geometry of one sample, a value row read in chunks
// of a lane, the location/weight gradient's gather, which kernel 3 and v4's
// kernel 8c run with their own corner blends, and the forward's gather,
// which kernel 1 and v1's kernel 9 run with theirs.
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

#include <initializer_list>
#include <type_traits>

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

// One lane's part of a value row in a gather: 16-byte vectors of VW =
// 16 / sizeof(V) elements where the row is whole vectors on a 16-byte
// boundary (VEC), else single elements.  A row of D elements is nch =
// D / VW chunks; lane ``sub`` of a group of G takes chunks sub + G * c for
// c < C.
template <typename V, bool VEC>
struct RowChunk {
  static constexpr int VW = VEC ? 16 / (int)sizeof(V) : 1;
  using Raw = typename std::conditional<VEC, uint4, V>::type;

  __device__ static Raw load(const V* p) {
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      return __ldg(p);
    }
  }
  __device__ static Raw zero() {
    if constexpr (VEC) {
      return make_uint4(0u, 0u, 0u, 0u);
    } else {
      return from_f32<V>(0.f);
    }
  }
  __device__ static void widen(const Raw& r, float (&f)[VW]) {
    if constexpr (VEC) {
      deform::widen(r, f);
    } else {
      f[0] = to_f32(r);
    }
  }
  __device__ static void store(V* p, const float (&f)[VW]) {
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(p) = narrow(f);
    } else {
      *p = from_f32<V>(f[0]);
    }
  }
};

// Whether a row of D elements of V reads as 16-byte vectors from each of
// ``ptrs`` (whole vectors, every base on a 16-byte boundary).
template <typename V>
bool rows_in_vectors(int D, std::initializer_list<const void*> ptrs) {
  if ((D * (int)sizeof(V)) % 16) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The lanes a row takes in a gather: the power of two, at least 2, that
// holds nch 16-byte chunks (at most 32).
inline int row_lanes(int nch) {
  int g = 2;
  while (g < nch) g <<= 1;
  return g;
}

// Calls ``launch(vec, lanes, chunks)`` (std::integral_constant values: the
// template arguments VEC, G and C of a gather body) for rows of D <= MaxD
// elements of V read from ``ptrs``: 16-byte chunks and row_lanes lanes a
// row where the rows are whole vectors on 16-byte boundaries, else single
// elements, 32 lanes a row and MaxD / 32 a lane.  Returns launch's result,
// or an error code for a row of more than 32 chunks.
template <typename V, int MaxD, typename F>
int with_row_body(int D, std::initializer_list<const void*> ptrs,
                  F&& launch) {
  using std::integral_constant;
  if (!rows_in_vectors<V>(D, ptrs))
    return launch(std::false_type{}, integral_constant<int, 32>{},
                  integral_constant<int, MaxD / 32>{});
  const integral_constant<int, 1> one{};
  switch (row_lanes(D * (int)sizeof(V) / 16)) {
    case 2: return launch(std::true_type{}, integral_constant<int, 2>{}, one);
    case 4: return launch(std::true_type{}, integral_constant<int, 4>{}, one);
    case 8: return launch(std::true_type{}, integral_constant<int, 8>{}, one);
    case 16:
      return launch(std::true_type{}, integral_constant<int, 16>{}, one);
    case 32:
      if constexpr (MaxD * sizeof(V) / 16 >= 32)
        return launch(std::true_type{}, integral_constant<int, 32>{}, one);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The four corner dot products of each group's sample summed over the
// group's G lanes, in one tree whatever G: the lanes that differ in bit
// G/2 first, then in G/4, ..., then in bit 1.  For G >= 4 a transposed
// butterfly (2 + 1 shuffles leave each corner's sums on G / 4 lanes,
// log2(G) - 2 butterfly steps finish them) leaves corner c's sum on lane
// (c >> 1) * (G / 2) + (c & 1) * (G / 4) of the group; for G = 2 every
// lane ends with all four.  Float addition commutes, so every lane that
// holds a corner's sum holds the same bits.
template <int G>
struct GroupSums {
  float r[G >= 4 ? 1 : 4];

  __device__ void reduce(const float (&a)[4], int lane) {
    if constexpr (G >= 4) {
      const bool hi_a = lane & (G / 2);
      float k0 = hi_a ? a[2] : a[0], k1 = hi_a ? a[3] : a[1];
      k0 += __shfl_xor_sync(kFull, hi_a ? a[0] : a[2], G / 2);
      k1 += __shfl_xor_sync(kFull, hi_a ? a[1] : a[3], G / 2);
      const bool hi_b = lane & (G / 4);
      float v = hi_b ? k1 : k0;
      v += __shfl_xor_sync(kFull, hi_b ? k0 : k1, G / 4);
#pragma unroll
      for (int off = G / 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
      r[0] = v;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        r[c] = a[c];
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          r[c] += __shfl_xor_sync(kFull, r[c], off);
      }
    }
  }

  // corner c's sum of group ``from``'s sample (every lane calls it)
  __device__ float read(int c, int from) const {
    if constexpr (G >= 4) {
      return __shfl_sync(kFull, r[0],
                         from * G + (c >> 1) * (G / 2) + (c & 1) * (G / 4));
    } else {
      return __shfl_sync(kFull, r[c], from * G);
    }
  }
};

constexpr int kGatherWarps = 8;   // warps of a location/weight gather CTA
constexpr int kGatherQTile = 32;  // queries it takes

// The location/weight gradient as a gather, for a blend of the four
// corners ``Blend``: a warp owns one (n, q, h) at a time with its dOut row
// in registers; a CTA's kGatherWarps warps take kGatherQTile neighbouring
// queries of one (n, h) (blockIdx.x = (n * H + h) * q_tiles + tile), whose
// corners share L1 and L2.  A query-head's L*P samples go in rounds of
// 32: lane j sets sample j up (Blend::setup: its corner (x0, y0) as a
// texel of its level, its in-grid corners as bits 0-3 in row-major order
// (x0,y0), (x1,y0), (x0,y1), (x1,y1)), and a group of G lanes takes one
// sample, each lane C chunks of each corner's value row, all four corners'
// loads issued before the dot products and the next sample's under this
// one's.  The dot products with dOut sum in fp32 over the lane's chunks,
// then over the group (GroupSums); lane j collects sample j's four sums
// (0 for a corner outside the grid) and Blend::finish writes its
// gradients, so a query-head's gradients are written by consecutive
// lanes.  Every sum runs in a fixed order: the same bits every run.
//
// Blend provides ``Out`` (the gradients' type), ``Sample`` (what the
// sample's lane keeps), ``setup(lx, ly, hl, wl, &texel, &mask)`` and
// ``finish(sample, aw, hl, wl, dA, si, grad_loc, grad_weight)``.
template <typename Blend, typename V, typename T, bool VEC, int G, int C>
__device__ __forceinline__ void loc_weight_gather(
    const V* __restrict__ value, const T* __restrict__ loc,
    const T* __restrict__ weight, const V* __restrict__ dout,
    typename Blend::Out* __restrict__ grad_loc,
    typename Blend::Out* __restrict__ grad_weight, int Q, int H, int D,
    int S, int L, int P, int q_tiles, const Levels& lv) {
  using R = RowChunk<V, VEC>;
  using Raw = typename R::Raw;
  constexpr int VW = R::VW;
  constexpr int NG = 32 / G;  // samples a warp holds at once
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  // constant indices: an indexed kernel parameter would go to local memory
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (threadIdx.x == i) {
      s_h[i] = lv.h[i];
      s_w[i] = lv.w[i];
      s_start[i] = lv.start[i];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G, sub = lane % G;
  const int LP = L * P;
  const int tile = blockIdx.x % q_tiles;
  const int64_t nh = blockIdx.x / q_tiles;
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const int64_t row = (int64_t)H * D;
  const int nch = D / VW;
  const V* vlane = value + n * (int64_t)S * row + (int64_t)h * D + sub * VW;
  const int q_end = min(Q, (tile + 1) * kGatherQTile);

  for (int q = tile * kGatherQTile + warp; q < q_end; q += kGatherWarps) {
    const int64_t nqh = (n * Q + q) * H + h;
    float g[C][VW];  // this lane's chunks of dOut, widened
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ch = sub + G * c;
      R::widen(ch < nch ? R::load(dout + nqh * D + ch * VW) : R::zero(),
               g[c]);
    }
    for (int base = 0; base < LP; base += 32) {
      const int batch = min(32, LP - base);  // samples this round
      const int iters = (batch + NG - 1) / NG;
      const bool own = lane < batch;
      const int64_t si = nqh * LP + base + lane;
      typename Blend::Sample smp = {};
      float aw = 0.f;
      int texel = 0, hl = 0, wl = 0;
      unsigned mask = 0u;
      if (own) {
        const int l = (base + lane) / P;
        hl = s_h[l];
        wl = s_w[l];
        smp = Blend::setup(to_f32(loc[2 * si]), to_f32(loc[2 * si + 1]), hl,
                           wl, &texel, &mask);
        texel += s_start[l];
        aw = to_f32(weight[si]);
      }
      const int packed = wl << 4 | (int)mask;
      // group grp takes samples grp * iters + it; lane j's was taken by
      // group j / iters at it = j % iters
      const int from = lane / iters;
      const int at = lane - from * iters;
      auto load = [&](int src, Raw (&r)[4][C]) {
        const int t = __shfl_sync(kFull, texel, src);
        const int pk = __shfl_sync(kFull, packed, src);
        const int w = pk >> 4;
        const int64_t off[4] = {t, t + 1, t + w, t + w + 1};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            r[k][c] = pk >> k & 1 && sub + G * c < nch
                          ? R::load(vlane + off[k] * row + G * c * VW)
                          : R::zero();
          }
      };
      float dA[4] = {0.f, 0.f, 0.f, 0.f};
      Raw cur[4][C];
      load(grp * iters, cur);
      for (int it = 0; it < iters; ++it) {
        Raw nxt[4][C];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) nxt[k][c] = R::zero();
        if (it + 1 < iters) load(grp * iters + it + 1, nxt);
        float a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[k] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float f[VW];
            R::widen(cur[k][c], f);
#pragma unroll
            for (int v = 0; v < VW; ++v) a[k] = fmaf(g[c][v], f[v], a[k]);
          }
        }
        GroupSums<G> sums;
        sums.reduce(a, lane);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = sums.read(k, from);
          if (at == it) dA[k] = v;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) cur[k][c] = nxt[k][c];
      }
      if (own)
        Blend::finish(smp, aw, hl, wl, dA, si, grad_loc, grad_weight);
    }
  }
}

constexpr int kForwardWarps = 8;   // warps of a forward gather CTA
constexpr int kForwardQTile = 32;  // queries it takes

// The deformable forward as a gather, for a blend of the four corners
// ``Blend`` (kernel 1's bilinear weights, v1's separable rows and
// columns): G lanes a sample, one 16-byte vector of each corner a lane
// (D = G * 16 / sizeof(V)).  A CTA takes kForwardQTile neighbouring
// queries of one (n, h) (blockIdx.x = (n * H + h) * q_tiles + tile), whose
// corners overlap in L1; each warp one query at a time, its L*P samples in
// rounds of 32.  Lane j sets sample j up (Blend::setup: the texel of its
// corner (x0, y0) on its level, its in-grid corners as bits 0-3 in
// row-major order (x0,y0), (x1,y0), (x0,y1), (x1,y1), and four
// coefficients) and hands it to the groups by shuffle; all four corners'
// loads issue before any math, and the next sample's loads are in flight
// under the current one's FMAs.  Each group takes its samples in order and
// Blend::apply adds each into the lane's fp32 sums; the groups' sums fold
// by a fixed butterfly and group 0 writes the [D] row as 16-byte stores in
// the value's dtype.  Every sum runs in a fixed order: the same bits every
// run.  The value must start on a 16-byte boundary (the wrappers refuse a
// view that does not).
//
// Blend provides ``setup(lx, ly, aw, hl, wl, &texel, &mask, coef)`` (coef:
// float[4]) and ``apply(coef, f, acc)``: f[4][VW] the four corners'
// widened vectors (zeros outside the grid), acc[VW] the lane's sums.
template <typename Blend, typename V, typename T, int G>
__device__ __forceinline__ void forward_gather(
    const V* __restrict__ value, const T* __restrict__ loc,
    const T* __restrict__ weight, V* __restrict__ out, int Q, int H, int S,
    int L, int P, int q_tiles, const Levels& lv) {
  constexpr int VW = 16 / (int)sizeof(V);
  constexpr int D = G * VW;
  constexpr int NG = 32 / G;  // samples a warp holds at once
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  // constant indices: an indexed kernel parameter would go to local memory
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (threadIdx.x == i) {
      s_h[i] = lv.h[i];
      s_w[i] = lv.w[i];
      s_start[i] = lv.start[i];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int LP = L * P;
  const int tile = blockIdx.x % q_tiles;
  const int64_t nh = blockIdx.x / q_tiles;
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const int64_t row = (int64_t)H * D;
  const V* vbase = value + n * (int64_t)S * row + (int64_t)h * D +
                   (lane % G) * VW;
  const int q_end = min(Q, (tile + 1) * kForwardQTile);

  for (int q = tile * kForwardQTile + warp; q < q_end; q += kForwardWarps) {
    const int64_t nqh = (n * Q + q) * H + h;
    float acc[VW];
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = 0.f;
    for (int base = 0; base < LP; base += 32) {
      const int R = min(32, LP - base);
      const int iters = (R + NG - 1) / NG;
      // lane j sets up sample base + j: its texel and coefficients
      int texel = 0, wl = 0;
      unsigned mask = 0u;
      float coef[4] = {0.f, 0.f, 0.f, 0.f};
      if (lane < R) {
        const int64_t si = nqh * LP + base + lane;
        const int l = (base + lane) / P;
        wl = s_w[l];
        Blend::setup(to_f32(loc[2 * si]), to_f32(loc[2 * si + 1]),
                     to_f32(weight[si]), s_h[l], wl, &texel, &mask, coef);
        texel += s_start[l];
      }
      const int packed = wl << 4 | (int)mask;
      // group grp takes samples grp * iters + it, in order
      uint4 cur[4];
      load_corners(vbase, row, texel, packed, grp * iters, cur);
      for (int it = 0; it < iters; ++it) {
        const int src = grp * iters + it;
        uint4 nxt[4] = {};
        if (it + 1 < iters)
          load_corners(vbase, row, texel, packed, src + 1, nxt);
        float c[4];
        float f[4][VW];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          c[k] = __shfl_sync(kFull, coef[k], src);
          widen(cur[k], f[k]);
        }
        Blend::apply(c, f, acc);
#pragma unroll
        for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
      }
    }
    // the groups' sums, folded in a fixed order
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int v = 0; v < VW; ++v)
        acc[v] += __shfl_xor_sync(kFull, acc[v], off);
    }
    if (grp == 0)
      *reinterpret_cast<uint4*>(out + nqh * D + lane * VW) = narrow(acc);
  }
}

}  // namespace deform
