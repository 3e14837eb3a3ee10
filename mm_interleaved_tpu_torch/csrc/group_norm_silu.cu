// GroupNorm + SiLU, the apply pass, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/group_norm.py::_apply_silu_kernel.  The
// statistics stay plain PyTorch (the JAX package leaves them to XLA): the
// caller folds the group moments and the affine parameters into one fp32
// multiplier and offset per (batch, channel), and this pass computes
// y = silu(x * w[b, c] + b[b, c]) over an NHWC tensor in fp32, writing the
// input's dtype.
//
// Bound: bytes.  Each element is read once and written once with a few
// flops.  The design is a grid-stride loop over 16-byte vectors along C
// (8 bf16 or 4 fp32 values per load and per store), with w and b read per
// (batch, channel) from the small [B, C] tables, which stay in L1/L2.
// Where C is not a multiple of the vector width or the pointers are not
// 16-byte aligned the wrapper asks for the scalar version of the loop.
//
// C interface (ctypes): mmi_group_norm_silu_apply, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// x, y [B, N, C] contiguous; w, b [B, C] fp32.  n_vec = B * N * C / V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_silu_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y,
                     int64_t n_vec, int64_t NC, int C) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_vec;
       i += stride) {
    const int64_t e = i * V;
    const int64_t bi = e / NC;
    const int c = (int)(e % C);
    const float* wp = w + bi * C + c;
    const float* bp = b + bi * C + c;
    const Pack<T, V> in = reinterpret_cast<const Pack<T, V>*>(x)[i];
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = fmaf(to_f32(in.v[j]), wp[j], bp[j]);
      o.v[j] = from_f32<T>(t / (1.f + expf(-t)));
    }
    reinterpret_cast<Pack<T, V>*>(y)[i] = o;
  }
}

template <typename T, int V>
int launch(const void* x, const float* w, const float* b, void* y, int64_t B,
           int64_t N, int C, cudaStream_t stream) {
  const int64_t n_vec = B * N * C / V;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gn_silu_apply_kernel<T, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), n_vec, N * C, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vectorised: 1 = 16-byte loads (the
// caller checked C % (16 / itemsize) == 0 and 16-byte alignment), 0 =
// scalar.  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_group_norm_silu_apply(int device, int dtype, int vectorised,
                                         const void* x, const void* w,
                                         const void* b, void* y, int64_t B,
                                         int64_t N, int C, void* stream) {
  if (C < 1 || B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    if (vectorised) {
      if (C % 4) return (int)cudaErrorInvalidValue;
      return launch<float, 4>(x, wf, bf, y, B, N, C, s);
    }
    return launch<float, 1>(x, wf, bf, y, B, N, C, s);
  }
  if (dtype == 1) {
    if (vectorised) {
      if (C % 8) return (int)cudaErrorInvalidValue;
      return launch<__nv_bfloat16, 8>(x, wf, bf, y, B, N, C, s);
    }
    return launch<__nv_bfloat16, 1>(x, wf, bf, y, B, N, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
