// Multi-scale deformable attention, forward, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py::_kernel_v5.
// The TPU kernel builds a dense bilinear sampling matrix per row chunk and
// contracts it on the MXU, gated by host-computed occupancy bit-words and
// padded to 128 lanes, because a TPU has no fast gather.  A GPU gathers
// directly, as the original ms_deformable_im2col_gpu_kernel does: each
// output row reads the 4 bilinear corners of each (level, point) sample.
//
// Bound: gathered bytes.  Per output channel and sample the kernel reads 4
// value elements and does 4 FMAs, far below the card's ridge point, so
// what counts is how many corner bytes a warp has in flight.  Two bodies,
// chosen by the wrapper from (D, dtype) (ops/ms_deform_attn_cuda.py::
// forward_variant, the rule of the location/weight gradient's bodies):
//
//  * "grouped", where a head's D channels are G = 4, 8 or 16 whole 16-byte
//    vectors (D = 64 bf16: G = 8).  A warp owns one (n, q, h) at a time; a
//    group of G lanes takes one sample, each lane one 16-byte vector of
//    each corner, so a warp holds 32 / G samples at once.  Lane j works out
//    sample j's geometry (level, corners, bounds, the four corner weights
//    times the attention weight) and hands it to the groups by shuffle;
//    all four corners' loads issue before any math, and the next sample's
//    loads are in flight under the current one's FMAs.  Each group sums
//    its samples in order; the groups' sums fold by a fixed butterfly and
//    group 0 writes the [D] row as 16-byte stores in the value's dtype.  A
//    CTA's 8 warps take neighbouring queries of one (n, h), whose corners
//    overlap in L1.  The value must start on a 16-byte boundary (the
//    wrapper refuses a view that does not).  The body is
//    deform::forward_gather (ms_deform_attn_common.cuh) with this kernel's
//    blend, BilinearBlend; v1's kernel 9 (ms_deform_attn_v1.cu) runs it
//    with v1's.
//  * "channel", any D: one thread per (n, q, h, d) with lanes along D, so
//    the 32 lanes of a warp read 32 consecutive channels of one texel, and
//    the location/weight loads are the same address across the warp.  The
//    per-level sum is added to the total after the level, as the plain
//    version sums.
//
// Accumulation is fp32, in a fixed order: the output is the same bits
// every run.  The geometry is deform::corners (ms_deform_attn_common.cuh),
// rounded as the plain version rounds it.
//
// C interface (ctypes): mmi_ms_deform_attn_fwd, see the end of the file.

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
  // unrolled over the static bound so that lv stays in registers
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const V* vl = vbase + (int64_t)lv.start[l] * row;
    float acc_l = 0.f;
    for (int p = 0; p < P; ++p) {
      const int lp_i = l * P + p;
      const Corners k =
          deform::corners(to_f32(lp[2 * lp_i]), to_f32(lp[2 * lp_i + 1]), hl,
                          wl);
      const float aw = to_f32(wp[lp_i]);
      const float fx = k.fx, fy = k.fy;
      float s = 0.f;
      if (k.mask & 1u)
        s += (1.f - fx) * (1.f - fy) * to_f32(vl[(int64_t)k.texel * row]);
      if (k.mask & 2u)
        s += fx * (1.f - fy) * to_f32(vl[(int64_t)(k.texel + 1) * row]);
      if (k.mask & 4u)
        s += (1.f - fx) * fy * to_f32(vl[(int64_t)(k.texel + wl) * row]);
      if (k.mask & 8u)
        s += fx * fy * to_f32(vl[(int64_t)(k.texel + wl + 1) * row]);
      acc_l += s * aw;
    }
    acc += acc_l;
  }
  out[i] = from_f32<V>(acc);
}

// Kernel 1's blend for deform::forward_gather: the bilinear weights of
// deform::corners times the attention weight (0 where a corner is out of
// bounds), each corner's vector accumulated in row-major order.
struct BilinearBlend {
  __device__ static void setup(float lx, float ly, float aw, int hl, int wl,
                               int* texel, unsigned* mask, float (&cw)[4]) {
    const Corners k = deform::corners(lx, ly, hl, wl);
    *texel = k.texel;
    *mask = k.mask;
    const float gx = 1.f - k.fx, gy = 1.f - k.fy;
    cw[0] = k.mask & 1u ? gx * gy * aw : 0.f;
    cw[1] = k.mask & 2u ? k.fx * gy * aw : 0.f;
    cw[2] = k.mask & 4u ? gx * k.fy * aw : 0.f;
    cw[3] = k.mask & 8u ? k.fx * k.fy * aw : 0.f;
  }

  template <int VW>
  __device__ static void apply(const float (&cw)[4], const float (&f)[4][VW],
                               float (&acc)[VW]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = fmaf(cw[c], f[c][v], acc[v]);
  }
};

// The "grouped" body: deform::forward_gather with kernel 1's blend, G
// lanes a sample, one 16-byte vector of each corner a lane (D = G * 16 /
// sizeof(V)).
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kThreads, 3)
fwd_grouped(const V* __restrict__ value, const T* __restrict__ loc,
            const T* __restrict__ weight, V* __restrict__ out, int Q, int H,
            int S, int L, int P, int q_tiles,
            const __grid_constant__ Levels lv) {
  deform::forward_gather<BilinearBlend, V, T, G>(value, loc, weight, out, Q,
                                                 H, S, L, P, q_tiles, lv);
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
extern "C" int mmi_ms_deform_attn_fwd(int device, int value_dtype,
                                      int loc_dtype, int variant,
                                      const void* value, const void* loc,
                                      const void* weight, void* out, int N,
                                      int S, int Q, int H, int D, int L, int P,
                                      const int* level_hw, void* stream) {
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
