// Factorised multi-image deformable attention (the UNet's MMFS), forward,
// for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_mi.py::_kernel_mi.
// Sampling locations and weights split into a query part and a per-image
// part:
//   x = (ref_x + off_x * inv_base) * W_l - 0.5 + dx[b, h, n, l, p]
//   y = (ref_y + off_y * inv_base) * H_l - 0.5 + dy[b, h, n, l, p]
//   w = wq[b, q, h, l, p] * wi[b, h, n, l, p]
// so the [B, Lq, H, n_img, L, P, 2] location tensor is never built.  The
// image side (value and the (dx, dy, wi) delta table) may carry a smaller
// batch Bv than the queries: query row c * Bv + b reads image row b, which
// is how the denoise loop shares one image side between the two CFG
// halves.
//
// Bound: gathered bytes, as for the single-image kernel.  The TPU kernel
// builds dense bilinear matrices from value slabs, occupancy bit-words and
// a transposed query slab because a TPU has no gather; none of that is
// needed here.  One thread per (b, q, h, 4 channels), lanes along D, so
// 16 lanes read one 128-byte row of a bf16 texel per corner (D = 64) with
// 8-byte loads, and the location and weight arithmetic, which every lane of
// a (b, q, h) repeats, is done once per 4 channels instead of once per
// channel.  Where D or the pointers do not allow it the wrapper asks for
// one channel per thread.  Images, levels and points loop inside the
// thread with an fp32 accumulator; an image whose wi is all zero for the
// (b, h) is skipped, which is exact and makes masked images cost nothing.
//
// C interface (ctypes): mmi_ms_deform_attn_mi_fwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename V, int VEC>
struct alignas(sizeof(V) * VEC) Pack {
  V v[VEC];
};

template <typename V>
__device__ __forceinline__ V from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// value [Bv, n_img, S, H, D] (V), delta [Bv, H, n_img, L, P, 3] fp32,
// ref [B, Lq, 2] fp32, off_q [B, Lq, H, P, 2] fp32, wq [B, Lq, H, L, P] (V),
// out [B, Lq, H, D] (V).  Each thread owns VEC consecutive channels.
template <typename V, int VEC>
__global__ void __launch_bounds__(kThreads)
mi_fwd_kernel(const V* __restrict__ value, const float* __restrict__ delta,
              const float* __restrict__ ref, const float* __restrict__ off_q,
              const V* __restrict__ wq, V* __restrict__ out, int Bv, int Lq,
              int n_img, int S, int H, int D, int L, int P, float inv_base,
              int64_t total, Levels lv) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int DV = D / VEC;
  const int d = (int)(i % DV) * VEC;
  const int64_t bqh = i / DV;
  const int h = (int)(bqh % H);
  const int64_t bq = bqh / H;
  const int b = (int)(bq / Lq);
  const int bv = b % Bv;

  const float rx = ref[2 * bq];
  const float ry = ref[2 * bq + 1];
  const float* oq = off_q + bqh * (int64_t)P * 2;
  const V* wqp = wq + bqh * (int64_t)L * P;
  const int64_t texel = (int64_t)H * D;
  const int LP = L * P;

  using Vec = Pack<V, VEC>;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int n = 0; n < n_img; ++n) {
    const float* dl = delta + (((int64_t)bv * H + h) * n_img + n) * LP * 3;
    bool live = false;
    for (int lp = 0; lp < LP; ++lp) live |= dl[3 * lp + 2] != 0.f;
    if (!live) continue;
    const V* vimg = value + ((int64_t)bv * n_img + n) * S * texel +
                    (int64_t)h * D + d;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= L) break;
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const V* vl = vimg + (int64_t)lv.start[l] * texel;
      for (int p = 0; p < P; ++p) {
        const float* dp = dl + 3 * (l * P + p);
        const float x = (rx + oq[2 * p] * inv_base) * wl - 0.5f + dp[0];
        const float y = (ry + oq[2 * p + 1] * inv_base) * hl - 0.5f + dp[1];
        const float aw = to_f32(wqp[l * P + p]) * dp[2];
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
        float sv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) sv[e] = 0.f;
        const int yx[4][2] = {{y0, x0}, {y0, x0 + 1}, {y0 + 1, x0},
                              {y0 + 1, x0 + 1}};
        const float cw[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                             (1.f - fx) * fy, fx * fy};
        const bool in[4] = {y0_in && x0_in, y0_in && x1_in, y1_in && x0_in,
                            y1_in && x1_in};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!in[c]) continue;
          const Vec t = *reinterpret_cast<const Vec*>(
              vl + ((int64_t)yx[c][0] * wl + yx[c][1]) * texel);
#pragma unroll
          for (int e = 0; e < VEC; ++e) sv[e] += cw[c] * to_f32(t.v[e]);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += sv[e] * aw;
      }
    }
  }
  Vec o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<V>(acc[e]);
  reinterpret_cast<Vec*>(out)[i] = o;
}

template <typename V, int VEC>
void launch(const void* value, const float* delta, const float* ref,
            const float* off_q, const void* wq, void* out, int Bv, int Lq,
            int n_img, int S, int H, int D, int L, int P, float inv_base,
            int64_t total, const Levels& lv, cudaStream_t stream) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  mi_fwd_kernel<V, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), delta, ref, off_q,
      static_cast<const V*>(wq), static_cast<V*>(out), Bv, Lq, n_img, S, H, D,
      L, P, inv_base, total, lv);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (value, wq and out).  level_hw: host
// array of 2*L ints (h0, w0, h1, w1, ...).  Returns a cudaError_t code
// (0 = launched).
extern "C" int mmi_ms_deform_attn_mi_fwd(
    int device, int dtype, const void* value, const void* delta,
    const void* ref, const void* off_q, const void* wq, void* out, int Bv,
    int B, int Lq, int n_img, int S, int H, int D, int L, int P,
    float inv_base, const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1 || Bv < 1 || B % Bv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(value) |
                         reinterpret_cast<uintptr_t>(out);
  const int elem = dtype == 0 ? 4 : 2;
  const int vec = (D % 4 == 0 && addr % (4 * elem) == 0) ? 4 : 1;
  const int64_t total = (int64_t)B * Lq * H * (D / vec);
  if (total == 0) return 0;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  const float* rf = static_cast<const float*>(ref);
  const float* oq = static_cast<const float*>(off_q);
#define MMI_LAUNCH(V, VEC)                                                    \
  launch<V, VEC>(value, dl, rf, oq, wq, out, Bv, Lq, n_img, S, H, D, L, P,   \
                 inv_base, total, lv, s)
  if (dtype == 0) {
    if (vec == 4) MMI_LAUNCH(float, 4); else MMI_LAUNCH(float, 1);
  } else if (dtype == 1) {
    if (vec == 4) MMI_LAUNCH(__nv_bfloat16, 4); else MMI_LAUNCH(__nv_bfloat16, 1);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef MMI_LAUNCH
  return (int)cudaGetLastError();
}
