// Multi-scale deformable attention, backward, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py::
// _kernel_v5_bwd_dv and ::_kernel_v5_bwd_dslab.  The TPU computes the value
// gradient as the transposed product dOut^T . A over dense bilinear
// matrices, accumulated across query tiles on its sequential grid, because
// it has no fast scatter; the location/weight gradient folds dA = dOut . V^T
// against separable hat factors.  A GPU scatters and gathers directly, as
// the original ms_deformable_col2im_gpu_kernel does:
//
//  * grad value (mmi_ms_deform_attn_bwd_value): one thread per (n, q, h, d)
//    that loops over the (level, point) samples of its query and adds
//    w * corner_weight * dOut[n, q, h, d] to the four corner texels with
//    fp32 atomicAdd into a zeroed fp32 [N, S, H, D] buffer (out-of-bounds
//    corners skipped).  Lanes run along D, so the atomics of a warp land on
//    consecutive addresses.  The wrapper casts the buffer to the value's
//    dtype.  The order of the atomic sums varies from run to run.
//  * grad locations and weights (mmi_ms_deform_attn_bwd_loc_weight): for
//    each in-bounds corner c of a sample (n, q, h, l, p) the dot product
//    g_c = sum_d dOut_d * V_c,d, then d_w = sum_c cw_c g_c and, with
//    x = loc_x * W_l - 0.5, d_loc_x = w * W_l * sum_c (d cw_c / d x) g_c
//    (and y alike): the derivative of the floor-based bilinear blend that
//    autograd takes through the plain version.  Two bodies, chosen by the
//    wrapper from (D, dtype) (ops/ms_deform_attn_cuda.py::
//    loc_weight_variant):
//    - "grouped", where a head's D channels are G = 4, 8 or 16 whole 16-byte
//      vectors (D = 64 bf16: G = 8).  A warp owns one (n, q, h) at a time,
//      so its dOut slice loads once into registers and serves all L*P
//      samples; a group of G lanes takes one sample, each lane one 16-byte
//      vector of each corner, so a warp holds 32 / G samples at once.
//      Lane j works out sample j's geometry (level, corners, bounds) and
//      hands the groups the corner texels by shuffle; all four corners'
//      loads issue before any reduction, the next sample's under the
//      current one's math; the four dot products reduce inside the group
//      by a transposed butterfly (2 + 1 shuffles leave each corner's sums
//      on G / 4 lanes, log2(G) - 2 butterfly steps finish them: at G = 8
//      one corner a lane pair, 4 shuffles a sample), and lane j collects
//      sample j's four sums, so the gradients of a query-head's samples
//      are written by consecutive lanes, coalesced.  A CTA's 8 warps take
//      neighbouring queries of one (n, h), whose corners overlap in L1.
//    - "warp", any D: one warp per sample, lanes along D, a full-warp
//      reduction per corner.
//    Both write the gradients in the locations' dtype.
//
// Bound: bytes (the gathered corners, dOut, the locations and weights, and
// the gradient written once), at about 8 flops per sample and channel in
// each kernel, far below the card's ridge point.  Accumulation is fp32, in
// a fixed order: the location/weight gradient is the same bits every run.
//
// C interface (ctypes): see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// value/dout type V, loc/weight type T.  dout [N, Q, H, D],
// loc [N, Q, H, L, P, 2], weight [N, Q, H, L, P], grad_value fp32
// [N, S, H, D] zeroed by the caller.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_value_kernel(const T* __restrict__ loc, const T* __restrict__ weight,
                 const V* __restrict__ dout, float* __restrict__ grad_value,
                 int Q, int H, int D, int S, int L, int P, int64_t total,
                 Levels lv) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % D);
  const int64_t nqh = i / D;
  const int h = (int)(nqh % H);
  const int64_t n = nqh / ((int64_t)Q * H);

  const T* lp = loc + nqh * (int64_t)L * P * 2;
  const T* wp = weight + nqh * (int64_t)L * P;
  const float g = to_f32(dout[i]);
  if (g == 0.f) return;
  const int64_t row = (int64_t)H * D;
  float* gbase = grad_value + n * (int64_t)S * row + (int64_t)h * D + d;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    float* gl = gbase + (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int lp_i = l * P + p;
      const float x = to_f32(lp[2 * lp_i]) * wl - 0.5f;
      const float y = to_f32(lp[2 * lp_i + 1]) * hl - 0.5f;
      const float a = to_f32(wp[lp_i]) * g;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float fx = x - x0f;
      const float fy = y - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const bool x0_in = x0 >= 0 && x0 < wl;
      const bool x1_in = x0 + 1 >= 0 && x0 + 1 < wl;
      const bool y0_in = y0 >= 0 && y0 < hl;
      const bool y1_in = y0 + 1 >= 0 && y0 + 1 < hl;
      if (y0_in && x0_in)
        atomicAdd(gl + ((int64_t)y0 * wl + x0) * row, (1.f - fx) * (1.f - fy) * a);
      if (y0_in && x1_in)
        atomicAdd(gl + ((int64_t)y0 * wl + x0 + 1) * row, fx * (1.f - fy) * a);
      if (y1_in && x0_in)
        atomicAdd(gl + ((int64_t)(y0 + 1) * wl + x0) * row, (1.f - fx) * fy * a);
      if (y1_in && x1_in)
        atomicAdd(gl + ((int64_t)(y0 + 1) * wl + x0 + 1) * row, fx * fy * a);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// (x, y) of one sample's location gradient, written as one pair
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The bilinear corners of one sample on level (hl, wl) of a [L, ...] level
// table: fractions, the texel of corner (x0, y0) in the level, and the
// in-bounds corners as bits 0-3 of (x0,y0), (x0+1,y0), (x0,y0+1),
// (x0+1,y0+1).
struct Corners {
  float fx, fy;
  int texel;
  unsigned mask;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int hl,
                                           int wl) {
  const float x = lx * wl - 0.5f;
  const float y = ly * hl - 0.5f;
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

// d_w, d_loc_x / (w W_l), d_loc_y / (w H_l) from the four corner sums
__device__ __forceinline__ void blend_grads(float fx, float fy,
                                            const float (&g)[4], float& dw,
                                            float& dx, float& dy) {
  dw = (1.f - fx) * (1.f - fy) * g[0] + fx * (1.f - fy) * g[1] +
       (1.f - fx) * fy * g[2] + fx * fy * g[3];
  dx = -(1.f - fy) * g[0] + (1.f - fy) * g[1] - fy * g[2] + fy * g[3];
  dy = -(1.f - fx) * g[0] - fx * g[1] + (1.f - fx) * g[2] + fx * g[3];
}

// value [N, S, H, D]; grad_loc [N, Q, H, L, P, 2], grad_weight
// [N, Q, H, L, P] in T.  One warp per sample.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_loc_weight_kernel(const V* __restrict__ value, const T* __restrict__ loc,
                      const T* __restrict__ weight, const V* __restrict__ dout,
                      T* __restrict__ grad_loc, T* __restrict__ grad_weight,
                      int Q, int H, int D, int S, int L, int P,
                      int64_t samples, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= samples) return;  // whole warps leave together
  const int lp_i = (int)(s % ((int64_t)L * P));
  const int l = lp_i / P;
  const int64_t nqh = s / ((int64_t)L * P);
  const int h = (int)(nqh % H);
  const int64_t n = nqh / ((int64_t)Q * H);

  const int hl = lv.h[l];
  const int wl = lv.w[l];
  const Corners k = corners(to_f32(loc[2 * s]), to_f32(loc[2 * s + 1]), hl,
                            wl);
  const float aw = to_f32(weight[s]);
  const int64_t texel[4] = {k.texel, k.texel + 1, k.texel + wl,
                            k.texel + wl + 1};

  const int64_t row = (int64_t)H * D;
  const V* vl = value + n * (int64_t)S * row + (int64_t)lv.start[l] * row +
                (int64_t)h * D;
  const V* go = dout + nqh * (int64_t)D;
  float g[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = 0.f;
    if (k.mask >> c & 1u) {
      const V* vc = vl + texel[c] * row;
      for (int d = lane; d < D; d += 32) acc += to_f32(go[d]) * to_f32(vc[d]);
    }
    g[c] = warp_sum(acc);  // 0 for an out-of-bounds corner
  }
  if (lane == 0) {
    float dw, dx, dy;
    blend_grads(k.fx, k.fy, g, dw, dx, dy);
    grad_weight[s] = from_f32<T>(dw);
    store_pair(grad_loc + 2 * s, aw * dx * wl, aw * dy * hl);
  }
}

// 16 bytes of V widened to fp32: 8 bf16 (shift or mask) or 4 fp32
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

template <int VW>
__device__ __forceinline__ float dot16(const uint4& u, const float (&go)[VW]) {
  float f[VW];
  widen(u, f);
  float a = 0.f;
#pragma unroll
  for (int v = 0; v < VW; ++v) a = fmaf(go[v], f[v], a);
  return a;
}

constexpr int kQTile = 32;  // queries a CTA of the grouped body takes
constexpr unsigned kFull = 0xffffffffu;

// The corners of the sample lane ``src`` set up (its texel, and its level
// width with the in-bounds bits), loaded as this lane's 16-byte vector of
// each; zeros where out of bounds.
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

// The "grouped" body: G lanes a sample, one 16-byte vector of each corner a
// lane (D = G * 16 / sizeof(V)).  A CTA takes kQTile queries of one (n, h);
// each warp one query at a time, its L*P samples in rounds of 32.
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kThreads, 3)
bwd_loc_weight_grouped(const V* __restrict__ value, const T* __restrict__ loc,
                       const T* __restrict__ weight, const V* __restrict__ dout,
                       T* __restrict__ grad_loc, T* __restrict__ grad_weight,
                       int Q, int H, int S, int L, int P, int q_tiles,
                       Levels lv) {
  constexpr int VW = 16 / (int)sizeof(V);
  constexpr int D = G * VW;
  constexpr int NG = 32 / G;  // samples a warp holds at once
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
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
  const int q_end = min(Q, (tile + 1) * kQTile);

  for (int q = tile * kQTile + warp; q < q_end; q += kWarps) {
    const int64_t nqh = (n * Q + q) * H + h;
    float go[VW];
    widen(__ldg(reinterpret_cast<const uint4*>(dout + nqh * D +
                                               (lane % G) * VW)),
          go);
    for (int base = 0; base < LP; base += 32) {
      const int R = min(32, LP - base);
      const int iters = (R + NG - 1) / NG;
      // lane j sets up sample base + j and collects its corner sums
      const bool own = lane < R;
      const int64_t si = nqh * LP + base + lane;
      Corners k = {0.f, 0.f, 0, 0u};
      float aw = 0.f;
      int hl = 0, wl = 0;
      if (own) {
        const int l = (base + lane) / P;
        hl = s_h[l];
        wl = s_w[l];
        k = corners(to_f32(loc[2 * si]), to_f32(loc[2 * si + 1]), hl, wl);
        k.texel += s_start[l];
        aw = to_f32(weight[si]);
      }
      const int packed = wl << 4 | (int)k.mask;
      // group grp takes samples grp * iters + it; lane j's was taken by
      // group j / iters at it = j % iters
      const int from = lane / iters;
      const int at = lane - from * iters;
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      uint4 cur[4];
      load_corners(vbase, row, k.texel, packed, grp * iters, cur);
      for (int it = 0; it < iters; ++it) {
        uint4 nxt[4] = {};
        if (it + 1 < iters)
          load_corners(vbase, row, k.texel, packed, grp * iters + it + 1,
                       nxt);
        float a[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = dot16<VW>(cur[c], go);
        const bool take = at == it;
        // corners {0, 1} | {2, 3} by bit G/2, then {0} | {1} by bit G/4,
        // then the rest of the group's lanes
        const bool hi_a = lane & (G / 2);
        float k0 = hi_a ? a[2] : a[0], k1 = hi_a ? a[3] : a[1];
        k0 += __shfl_xor_sync(kFull, hi_a ? a[0] : a[2], G / 2);
        k1 += __shfl_xor_sync(kFull, hi_a ? a[1] : a[3], G / 2);
        const bool hi_b = lane & (G / 4);
        float r = hi_b ? k1 : k0;
        r += __shfl_xor_sync(kFull, hi_b ? k0 : k1, G / 4);
#pragma unroll
        for (int off = G / 8; off > 0; off >>= 1)
          r += __shfl_xor_sync(kFull, r, off);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = __shfl_sync(
              kFull, r, from * G + (c >> 1) * (G / 2) + (c & 1) * (G / 4));
          if (take) g[c] = v;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) cur[c] = nxt[c];
      }
      if (own) {
        float dw, dx, dy;
        blend_grads(k.fx, k.fy, g, dw, dx, dy);
        grad_weight[si] = from_f32<T>(dw);
        store_pair(grad_loc + 2 * si, aw * dx * wl, aw * dy * hl);
      }
    }
  }
}

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

template <typename V, typename T>
void launch_value(const void* loc, const void* weight, const void* dout,
                  float* gv, int Q, int H, int D, int S, int L, int P,
                  int64_t total, const Levels& lv, cudaStream_t stream) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  bwd_value_kernel<V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(loc), static_cast<const T*>(weight),
      static_cast<const V*>(dout), gv, Q, H, D, S, L, P, total, lv);
}

// The lanes a sample takes in the grouped body: D * sizeof(V) / 16 where
// that is 4, 8 or 16 whole vectors, else 0 (the warp body).
int group_lanes(int D, int elem) {
  if ((D * elem) % 16) return 0;
  const int g = D * elem / 16;
  return g == 4 || g == 8 || g == 16 ? g : 0;
}

template <typename V, typename T, int G>
int launch_grouped(const void* value, const void* loc, const void* weight,
                   const void* dout, void* gl, void* gw, int N, int Q, int H,
                   int S, int L, int P, const Levels& lv,
                   cudaStream_t stream) {
  const int q_tiles = (Q + kQTile - 1) / kQTile;
  const int64_t blocks = (int64_t)N * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bwd_loc_weight_grouped<V, T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout),
      static_cast<T*>(gl), static_cast<T*>(gw), Q, H, S, L, P, q_tiles, lv);
  return 0;
}

template <typename V, typename T>
int launch_loc_weight(int grouped, const void* value, const void* loc,
                      const void* weight, const void* dout, void* gl,
                      void* gw, int N, int Q, int H, int D, int S, int L,
                      int P, const Levels& lv, cudaStream_t stream) {
  if (grouped) {
    switch (group_lanes(D, (int)sizeof(V))) {
      case 4: return launch_grouped<V, T, 4>(value, loc, weight, dout, gl, gw,
                                             N, Q, H, S, L, P, lv, stream);
      case 8: return launch_grouped<V, T, 8>(value, loc, weight, dout, gl, gw,
                                             N, Q, H, S, L, P, lv, stream);
      case 16: return launch_grouped<V, T, 16>(value, loc, weight, dout, gl,
                                               gw, N, Q, H, S, L, P, lv,
                                               stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int64_t samples = (int64_t)N * Q * H * L * P;
  const int64_t blocks = (samples + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bwd_loc_weight_kernel<V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout),
      static_cast<T*>(gl), static_cast<T*>(gw), Q, H, D, S, L, P, samples, lv);
  return 0;
}

int check_args(int L, int P, int D) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (value and dout share one; loc and
// weight share the other).  level_hw: host array (h0, w0, h1, w1, ...).
// grad_value: fp32 [N, S, H, D], zeroed.  Returns a cudaError_t code.
extern "C" int mmi_ms_deform_attn_bwd_value(int device, int value_dtype,
                                            int loc_dtype, const void* loc,
                                            const void* weight,
                                            const void* dout, float* grad_value,
                                            int N, int S, int Q, int H, int D,
                                            int L, int P, const int* level_hw,
                                            void* stream) {
  int err = check_args(L, P, D);
  if (err) return err;
  Levels lv = {};
  if ((err = fill_levels(level_hw, L, S, &lv))) return err;
  const int64_t total = (int64_t)N * Q * H * D;
  if (total == 0) return 0;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    launch_value<float, float>(loc, weight, dout, grad_value, Q, H, D, S, L, P,
                               total, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    launch_value<__nv_bfloat16, __nv_bfloat16>(loc, weight, dout, grad_value,
                                               Q, H, D, S, L, P, total, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    launch_value<__nv_bfloat16, float>(loc, weight, dout, grad_value, Q, H, D,
                                       S, L, P, total, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: 0 = warp (any D), 1 = grouped (D * itemsize 4, 8 or 16 whole
// 16-byte vectors; value and dout 16-byte aligned, which
// the caller checked).  grad_loc [N, Q, H, L, P, 2] and grad_weight
// [N, Q, H, L, P] in the locations' dtype, every element written.
extern "C" int mmi_ms_deform_attn_bwd_loc_weight(
    int device, int value_dtype, int loc_dtype, int variant,
    const void* value, const void* loc, const void* weight, const void* dout,
    void* grad_loc, void* grad_weight, int N, int S, int Q, int H, int D,
    int L, int P, const int* level_hw, void* stream) {
  int err = check_args(L, P, D);
  if (err) return err;
  Levels lv = {};
  if ((err = fill_levels(level_hw, L, S, &lv))) return err;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (variant == 1 && !group_lanes(D, value_dtype ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * Q * H * L * P == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    err = launch_loc_weight<float, float>(variant, value, loc, weight, dout,
                                          grad_loc, grad_weight, N, Q, H, D, S,
                                          L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch_loc_weight<__nv_bfloat16, __nv_bfloat16>(
        variant, value, loc, weight, dout, grad_loc, grad_weight, N, Q, H, D,
        S, L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    err = launch_loc_weight<__nv_bfloat16, float>(
        variant, value, loc, weight, dout, grad_loc, grad_weight, N, Q, H, D,
        S, L, P, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
