// Multi-scale deformable attention, forward, in the separable formulation
// (v1), for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas.py::_kernel.  Per
// (query, level, point) v1 blends the two rows y0 and y0 + 1 with the row
// weights (1 - ly, ly) rounded to the value's type, the blend accumulated
// in fp32, then weights the two columns x0 and x0 + 1 by (1 - lx, lx)
// times the attention weight, in fp32; points are summed in order, then
// levels.  A row or column outside the grid contributes zero.  The TPU
// selects the rows and columns with one-hot matmuls (R, E and G) because it
// has no fast gather; here each thread reads its four texels directly.
//
// Bound: gathered bytes, as kernel 1 (ms_deform_attn.cu): per output
// element and sample 4 value reads and about 12 flops.  Level 0 of the
// benchmark's unet case, 64 x 64 texels of 64 bf16 channels (512 KB per
// head), does not fit a block's 227 KB of shared memory, so the texels are
// read from device memory and stay in the 50 MB L2.  One thread per
// (n, q, h, d), lanes along D: a warp reads 32 consecutive channels of one
// texel per corner (one coalesced segment), and the location and weight
// loads are one address across the warp (a broadcast).
//
// C interface (ctypes): mmi_ms_deform_attn_v1_fwd, see the end of the file.

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

template <typename V>
__device__ __forceinline__ V from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to V and back: v1's row weights are in the value's type
template <typename V>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<V>(x));
}

// value [N, S, H, D], loc [N, Q, H, L, P, 2] (x, y), weight [N, Q, H, L, P],
// out [N, Q, H, D]; V is the value/output type, T the loc/weight type.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_v1_kernel(const V* __restrict__ value,
                         const T* __restrict__ loc,
                         const T* __restrict__ weight,
                         V* __restrict__ out,
                         int Q, int H, int D, int S, int L, int P,
                         int64_t total, Levels lv) {
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

template <typename V, typename T>
void launch(const void* value, const void* loc, const void* weight, void* out,
            int Q, int H, int D, int S, int L, int P, int64_t total,
            const Levels& lv, cudaStream_t stream) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  ms_deform_attn_v1_kernel<V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<V*>(out), Q, H, D, S, L, P,
      total, lv);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  level_hw: host array of 2*L
// ints (h0, w0, h1, w1, ...).  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_ms_deform_attn_v1_fwd(int device, int value_dtype,
                                         int loc_dtype, const void* value,
                                         const void* loc, const void* weight,
                                         void* out, int N, int S, int Q,
                                         int H, int D, int L, int P,
                                         const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1) {
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
  const int64_t total = (int64_t)N * Q * H * D;
  if (total == 0) return 0;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    launch<float, float>(value, loc, weight, out, Q, H, D, S, L, P, total, lv,
                         s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(value, loc, weight, out, Q, H, D, S,
                                         L, P, total, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    launch<__nv_bfloat16, float>(value, loc, weight, out, Q, H, D, S, L, P,
                                 total, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
