// Multi-scale deformable attention, forward, in the separable formulation
// (v1), for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas.py::_kernel.  Per
// (query, level, point) v1 blends the two rows y0 and y0 + 1 with the row
// weights r0 = 1 - ly and r1 = ly rounded to the value's type, the blend
// t = r0 v[y0] + r1 v[y1] accumulated in fp32 per column, then weights the
// two columns x0 and x0 + 1 by (aw (1 - lx), aw lx), in fp32.  A row or
// column outside the grid contributes zero.  The TPU selects the rows and
// columns with one-hot matmuls (R, E and G) because it has no fast gather;
// here each sample's four texels are read directly.
//
// Bound: gathered bytes, as kernel 1 (ms_deform_attn.cu): per output
// element and sample 4 value reads and about 7 flops, far below the card's
// ridge point, so what counts is how many corner bytes a warp has in
// flight.  Level 0 of the benchmark's unet case, 64 x 64 texels of 64 bf16
// channels (512 KB per head), does not fit a block's 227 KB of shared
// memory, so the texels are read from device memory and stay in the 50 MB
// L2.  Two bodies, chosen by the wrapper from (D, dtype) as kernel 1's
// (ops/ms_deform_attn_cuda.py::forward_variant):
//
//  * "grouped", where a head's D channels are G = 4, 8 or 16 whole 16-byte
//    vectors: kernel 1's body, deform::forward_gather
//    (ms_deform_attn_common.cuh), with v1's blend (V1Blend).  A warp owns
//    one (n, q, h) at a time, a group of G lanes one sample, each lane one
//    16-byte vector of each corner; lane j works out sample j's geometry
//    (deform::corners, the plain version's rounding) and its four
//    coefficients (r0, r1 and the two column weights) once and hands them
//    to the groups by shuffle; the next sample's loads are in flight under
//    the current one's FMAs.  The samples are summed in the body's fixed
//    order (each group's samples in turn, then the groups' butterfly), not
//    points then levels.  The value must start on a 16-byte boundary (the
//    wrapper refuses a view that does not).
//  * "channel", any D: one thread per (n, q, h, d), lanes along D: a warp
//    reads 32 consecutive channels of one texel per corner, and the
//    location and weight loads are one address across the warp; points
//    summed in order, then levels.
//
// Accumulation is fp32, in a fixed order: the same bits every run.
//
// C interface (ctypes): mmi_ms_deform_attn_v1_fwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_common.cuh"

namespace {

using deform::Corners;
using deform::from_f32;
using deform::kMaxLevels;
using deform::Levels;
using deform::to_f32;

constexpr int kThreads = 256;
static_assert(kThreads == 32 * deform::kForwardWarps, "one CTA of the gather");

// x rounded to V and back: v1's row weights are in the value's type
template <typename V>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<V>(x));
}

// value [N, S, H, D], loc [N, Q, H, L, P, 2] (x, y), weight [N, Q, H, L, P],
// out [N, Q, H, D]; V is the value/output type, T the loc/weight type.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
fwd_channel(const V* __restrict__ value, const T* __restrict__ loc,
            const T* __restrict__ weight, V* __restrict__ out, int Q, int H,
            int D, int S, int L, int P, int64_t total,
            const __grid_constant__ Levels lv) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % D);
  const int64_t nqh = i / D;  // flat (n, q, h)
  const int h = (int)(nqh % H);
  const int64_t n = nqh / ((int64_t)Q * H);

  const T* lp = loc + nqh * (int64_t)L * P * 2;
  const T* wp = weight + nqh * (int64_t)L * P;
  const int64_t row = (int64_t)H * D;  // stride of one texel
  const V* vbase = value + n * (int64_t)S * row + (int64_t)h * D + d;

  float acc = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const V* vl = vbase + (int64_t)lv.start[l] * row;
    float acc_l = 0.f;
    for (int p = 0; p < P; ++p) {
      const int lp_i = l * P + p;
      const float x = to_f32(lp[2 * lp_i]) * wl - 0.5f;
      const float y = to_f32(lp[2 * lp_i + 1]) * hl - 0.5f;
      const float aw = to_f32(wp[lp_i]);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float lx = x - x0f;
      const float ly = y - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float r0 = round_to<V>(1.f - ly);
      const float r1 = round_to<V>(ly);
      const bool y0_in = y0 >= 0 && y0 < hl;
      const bool y1_in = y0 + 1 >= 0 && y0 + 1 < hl;
      float s = 0.f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xc = x0 + dx;
        if (xc < 0 || xc >= wl) continue;
        float t = 0.f;  // the row blend of column xc, fp32
        if (y0_in) t += r0 * to_f32(vl[((int64_t)y0 * wl + xc) * row]);
        if (y1_in) t += r1 * to_f32(vl[((int64_t)(y0 + 1) * wl + xc) * row]);
        s += (aw * (dx ? lx : 1.f - lx)) * t;
      }
      acc_l += s;
    }
    acc += acc_l;
  }
  out[i] = from_f32<V>(acc);
}

// v1's blend for deform::forward_gather: the coefficients are the row
// weights r0 = round_V(1 - ly), r1 = round_V(ly) and the column weights
// aw (1 - lx), aw lx; per channel t_x = r0 v[y0, x] + r1 v[y1, x] for each
// column, s = aw (1 - lx) t_x0 + aw lx t_x1, added to the sums.  A corner
// outside the grid arrives as zeros, so its row or column adds nothing.
template <typename V>
struct V1Blend {
  __device__ static void setup(float lx, float ly, float aw, int hl, int wl,
                               int* texel, unsigned* mask, float (&c)[4]) {
    const Corners k = deform::corners(lx, ly, hl, wl);
    *texel = k.texel;
    *mask = k.mask;
    c[0] = round_to<V>(1.f - k.fy);
    c[1] = round_to<V>(k.fy);
    c[2] = aw * (1.f - k.fx);
    c[3] = aw * k.fx;
  }

  template <int VW>
  __device__ static void apply(const float (&c)[4], const float (&f)[4][VW],
                               float (&acc)[VW]) {
#pragma unroll
    for (int v = 0; v < VW; ++v) {
      const float t0 = fmaf(c[1], f[2][v], c[0] * f[0][v]);
      const float t1 = fmaf(c[1], f[3][v], c[0] * f[1][v]);
      acc[v] += fmaf(c[3], t1, c[2] * t0);
    }
  }
};

// The "grouped" body: deform::forward_gather with v1's blend, G lanes a
// sample, one 16-byte vector of each corner a lane (D = G * 16 /
// sizeof(V)).
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kThreads, 3)
fwd_grouped(const V* __restrict__ value, const T* __restrict__ loc,
            const T* __restrict__ weight, V* __restrict__ out, int Q, int H,
            int S, int L, int P, int q_tiles,
            const __grid_constant__ Levels lv) {
  deform::forward_gather<V1Blend<V>, V, T, G>(value, loc, weight, out, Q, H,
                                              S, L, P, q_tiles, lv);
}

template <typename V, typename T, int G>
int launch_grouped(const void* value, const void* loc, const void* weight,
                   void* out, int N, int Q, int H, int S, int L, int P,
                   const Levels& lv, cudaStream_t stream) {
  const int q_tiles =
      (Q + deform::kForwardQTile - 1) / deform::kForwardQTile;
  const int64_t blocks = (int64_t)N * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fwd_grouped<V, T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<V*>(out), Q, H, S, L, P,
      q_tiles, lv);
  return 0;
}

template <typename V, typename T>
int launch(int grouped, const void* value, const void* loc,
           const void* weight, void* out, int N, int Q, int H, int D, int S,
           int L, int P, const Levels& lv, cudaStream_t stream) {
  if (grouped) {
    switch (deform::group_lanes(D, (int)sizeof(V))) {
      case 4: return launch_grouped<V, T, 4>(value, loc, weight, out, N, Q, H,
                                             S, L, P, lv, stream);
      case 8: return launch_grouped<V, T, 8>(value, loc, weight, out, N, Q, H,
                                             S, L, P, lv, stream);
      case 16: return launch_grouped<V, T, 16>(value, loc, weight, out, N, Q,
                                               H, S, L, P, lv, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int64_t total = (int64_t)N * Q * H * D;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fwd_channel<V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<V*>(out), Q, H, D, S, L, P,
      total, lv);
  return 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  variant: 0 = channel (any D),
// 1 = grouped (D * itemsize 4, 8 or 16 whole 16-byte vectors; the value 16-
// byte aligned, which the caller checked).  level_hw: host array of 2*L
// ints (h0, w0, h1, w1, ...).  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_ms_deform_attn_v1_fwd(int device, int value_dtype,
                                         int loc_dtype, int variant,
                                         const void* value, const void* loc,
                                         const void* weight, void* out, int N,
                                         int S, int Q, int H, int D, int L,
                                         int P, const int* level_hw,
                                         void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  int err = deform::fill_levels(level_hw, L, S, &lv);
  if (err) return err;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (variant == 1 && !deform::group_lanes(D, value_dtype ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * Q * H == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    err = launch<float, float>(variant, value, loc, weight, out, N, Q, H, D, S,
                               L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(variant, value, loc, weight,
                                               out, N, Q, H, D, S, L, P, lv,
                                               s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    err = launch<__nv_bfloat16, float>(variant, value, loc, weight, out, N, Q,
                                       H, D, S, L, P, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
