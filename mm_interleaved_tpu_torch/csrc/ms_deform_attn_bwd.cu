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
//  * grad locations and weights (mmi_ms_deform_attn_bwd_loc_weight): one
//    warp per sample (n, q, h, l, p).  For each in-bounds corner c it
//    reduces g_c = sum_d dOut_d * V_c,d across the warp, then
//    d_w = sum_c cw_c g_c and, with x = loc_x * W_l - 0.5,
//    d_loc_x = w * W_l * sum_c (d cw_c / d x) g_c (and y alike): the
//    derivative of the floor-based bilinear blend that autograd takes
//    through the plain version.
//
// Bound: bytes (the gathered corners, dOut, the locations and weights, and
// the gradient written once), at about 8 flops per sample and channel in
// each kernel, far below the card's ridge point.  Accumulation is fp32.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// value [N, S, H, D]; grad_loc fp32 [N, Q, H, L, P, 2], grad_weight fp32
// [N, Q, H, L, P].  One warp per sample.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_loc_weight_kernel(const V* __restrict__ value, const T* __restrict__ loc,
                      const T* __restrict__ weight, const V* __restrict__ dout,
                      float* __restrict__ grad_loc,
                      float* __restrict__ grad_weight, int Q, int H, int D,
                      int S, int L, int P, int64_t samples, Levels lv) {
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
  const float x = to_f32(loc[2 * s]) * wl - 0.5f;
  const float y = to_f32(loc[2 * s + 1]) * hl - 0.5f;
  const float aw = to_f32(weight[s]);
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
  const bool in[4] = {y0_in && x0_in, y0_in && x1_in, y1_in && x0_in,
                      y1_in && x1_in};
  const int64_t texel[4] = {(int64_t)y0 * wl + x0, (int64_t)y0 * wl + x0 + 1,
                            (int64_t)(y0 + 1) * wl + x0,
                            (int64_t)(y0 + 1) * wl + x0 + 1};

  const int64_t row = (int64_t)H * D;
  const V* vl = value + n * (int64_t)S * row + (int64_t)lv.start[l] * row +
                (int64_t)h * D;
  const V* go = dout + nqh * (int64_t)D;
  float g[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = 0.f;
    if (in[c]) {
      const V* vc = vl + texel[c] * row;
      for (int d = lane; d < D; d += 32) acc += to_f32(go[d]) * to_f32(vc[d]);
    }
    g[c] = warp_sum(acc);  // 0 for an out-of-bounds corner
  }
  if (lane == 0) {
    // corners (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1)
    const float dw = (1.f - fx) * (1.f - fy) * g[0] + fx * (1.f - fy) * g[1] +
                     (1.f - fx) * fy * g[2] + fx * fy * g[3];
    const float dx = -(1.f - fy) * g[0] + (1.f - fy) * g[1] - fy * g[2] +
                     fy * g[3];
    const float dy = -(1.f - fx) * g[0] - fx * g[1] + (1.f - fx) * g[2] +
                     fx * g[3];
    grad_weight[s] = dw;
    grad_loc[2 * s] = aw * dx * wl;
    grad_loc[2 * s + 1] = aw * dy * hl;
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

template <typename V, typename T>
void launch_loc_weight(const void* value, const void* loc, const void* weight,
                       const void* dout, float* gl, float* gw, int Q, int H,
                       int D, int S, int L, int P, int64_t samples,
                       const Levels& lv, cudaStream_t stream) {
  const int64_t blocks = (samples + kWarps - 1) / kWarps;
  bwd_loc_weight_kernel<V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout), gl, gw, Q, H,
      D, S, L, P, samples, lv);
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

// grad_loc fp32 [N, Q, H, L, P, 2] and grad_weight fp32 [N, Q, H, L, P],
// every element written.
extern "C" int mmi_ms_deform_attn_bwd_loc_weight(
    int device, int value_dtype, int loc_dtype, const void* value,
    const void* loc, const void* weight, const void* dout, float* grad_loc,
    float* grad_weight, int N, int S, int Q, int H, int D, int L, int P,
    const int* level_hw, void* stream) {
  int err = check_args(L, P, D);
  if (err) return err;
  Levels lv = {};
  if ((err = fill_levels(level_hw, L, S, &lv))) return err;
  const int64_t samples = (int64_t)N * Q * H * L * P;
  if (samples == 0) return 0;
  if ((samples + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    launch_loc_weight<float, float>(value, loc, weight, dout, grad_loc,
                                    grad_weight, Q, H, D, S, L, P, samples, lv,
                                    s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    launch_loc_weight<__nv_bfloat16, __nv_bfloat16>(
        value, loc, weight, dout, grad_loc, grad_weight, Q, H, D, S, L, P,
        samples, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    launch_loc_weight<__nv_bfloat16, float>(value, loc, weight, dout, grad_loc,
                                            grad_weight, Q, H, D, S, L, P,
                                            samples, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
