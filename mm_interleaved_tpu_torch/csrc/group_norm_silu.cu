// GroupNorm and GroupNorm + SiLU over channel-last x, in two launches, for
// sm_90a.
//
// Replaces mm_interleaved_tpu/ops/group_norm.py::_apply_silu_kernel and
// takes over the moment code the JAX package leaves to XLA (group_norm,
// group_norm_silu): on the TPU XLA fuses the moments into one read pass, in
// eager PyTorch they were about 18 launches and three fp32 passes over x.
//
// The math is the JAX package's: per-channel fp32 sums s1 = sum(x) and
// s2 = sum(x^2) over the spatial rows, folded to groups, var = E[x^2] -
// E[x]^2 (no Welford), w = scale * rsqrt(var + eps), b = bias - mean * w,
// then t = x * w + b in fp32, silu(t) or t itself, cast to x's dtype.
//
//  * mmi_group_norm_moments: a CTA per (spatial chunk, batch).  Each thread
//    owns one column vector of the channels (16 bytes: 8 bf16 or 4 fp32
//    values, or one value where C is not a multiple of the vector) and
//    keeps its channels' s1, s2 in registers over every R-th row of the
//    chunk; the R row groups are summed in shared memory by a fixed-order
//    tree and the chunk's per-channel partials written to a workspace
//    [B, chunks, 2, C].  The last CTA of a batch to finish (a counter per
//    batch, after a __threadfence) folds that batch's partials (its threads
//    in S slices of every S-th chunk, the slices added in order), then by
//    group, into w and b [B, 2, C], and resets the counter for the next
//    call (a whole warp a group for the fold by group).  No float atomics, and
//    every order fixed by the shape: two runs give the same bits.
//  * mmi_group_norm_apply: the same grid and thread layout; each thread
//    holds its column vector's w and b in registers and streams its rows.
//
// Bound: bytes.  The op needs x read once and y written once; this design
// reads x twice (at the UNet's sizes the second read comes from the 50 MB
// L2).  The chunk plan (chunks, rows a chunk, threads) is a pure function
// of the shape, computed by the wrapper (ops/group_norm.py::gn_plan) and
// checked here.
//
// C interface (ctypes): see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxChannels = 4096;

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

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  const Pack<T, V> in = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = to_f32(in.v[v]);
}

__device__ __forceinline__ float param(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// x [B, N, C]; V values a thread along C; blockDim.x = R * (C / V).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
gn_moments_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                  const void* __restrict__ bias, int param_bf16,
                  float* __restrict__ partial, unsigned* __restrict__ counters,
                  float* __restrict__ wb, int64_t N, int C, int G,
                  int64_t rows_per_chunk, float eps) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int nvec = C / V;
  const int R = blockDim.x / nvec;
  const int tid = threadIdx.x;
  const int j = tid % nvec;
  const int rg = tid / nvec;
  const int chunks = gridDim.x;
  const int k = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t r0 = (int64_t)k * rows_per_chunk;
  const int64_t r1 = min(N, r0 + rows_per_chunk);

  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
  const T* xb = x + b * N * C + j * V;
#pragma unroll 4
  for (int64_t r = r0 + rg; r < r1; r += R) {
    float f[V];
    load_vec<T, V>(xb + r * C, f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s1[v] += f[v];
      s2[v] += f[v] * f[v];
    }
  }

  // the row groups by a fixed-order tree (each step adds the upper half of
  // the active groups onto the lower) in shared memory laid out [R][2][V]
  // [nvec], so a warp's lanes touch consecutive words; then the chunk's
  // partials, [2][C] of it
  float* mine = smem + rg * 2 * C + j;
  if (R > 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mine[v * nvec] = s1[v];
      mine[C + v * nvec] = s2[v];
    }
    __syncthreads();
    for (int active = R; active > 1;) {
      const int half = (active + 1) / 2;
      if (rg < active - half) {
        const float* other = mine + half * 2 * C;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s1[v] += other[v * nvec];
          s2[v] += other[C + v * nvec];
          mine[v * nvec] = s1[v];
          mine[C + v * nvec] = s2[v];
        }
      }
      __syncthreads();
      active = half;
    }
  }
  if (rg == 0) {
    float* out = partial + (b * chunks + k) * 2 * C + j * V;
    Pack<float, V> p1, p2;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p1.v[v] = s1[v];
      p2.v[v] = s2[v];
    }
    *reinterpret_cast<Pack<float, V>*>(out) = p1;
    *reinterpret_cast<Pack<float, V>*>(out + C) = p2;
  }

  // the last chunk of this batch folds
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[b], 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!last) return;

  // S slices of the block sum every S-th chunk of a channel, then each
  // channel's slices are added in order
  const int S = max(1, (int)blockDim.x / C);
  float* cs = smem;              // [S][2][C]: s1, s2
  float* gs = smem + 2 * S * C;  // [2][G]: mean, rsqrt(var + eps)
  const float* pb = partial + b * chunks * 2 * C;
  for (int i = tid; i < S * C; i += blockDim.x) {
    const int c = i % C;
    const int sl = i / C;
    float a = 0.f, q = 0.f;
#pragma unroll 8
    for (int kk = sl; kk < chunks; kk += S) {
      a += __ldcg(pb + (int64_t)kk * 2 * C + c);
      q += __ldcg(pb + (int64_t)kk * 2 * C + C + c);
    }
    cs[sl * 2 * C + c] = a;
    cs[sl * 2 * C + C + c] = q;
  }
  __syncthreads();
  if (S > 1) {
    for (int c = tid; c < C; c += blockDim.x) {
      for (int sl = 1; sl < S; ++sl) {
        cs[c] += cs[sl * 2 * C + c];
        cs[C + c] += cs[sl * 2 * C + C + c];
      }
    }
    __syncthreads();
  }
  // a warp a group: lane-strided sums, then a full-warp butterfly, so only
  // the block's whole warps take groups (a last warp of fewer than 32
  // threads takes none; the plan gives at least one whole warp)
  const int cpg = C / G;
  const float n = (float)(N * cpg);
  const int lane = tid & 31;
  const int warps = blockDim.x >> 5;
  for (int g = tid >> 5; g < G && (tid >> 5) < warps; g += warps) {
    float g1 = 0.f, g2 = 0.f;
    for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
      g1 += cs[c];
      g2 += cs[C + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      g1 += __shfl_xor_sync(0xffffffffu, g1, off);
      g2 += __shfl_xor_sync(0xffffffffu, g2, off);
    }
    if (lane == 0) {
      const float mean = g1 / n;
      const float var = g2 / n - mean * mean;
      gs[g] = mean;
      gs[G + g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const int g = c / cpg;
    const float w = param(scale, param_bf16, c) * gs[G + g];
    wb[b * 2 * C + c] = w;
    wb[b * 2 * C + C + c] = param(bias, param_bf16, c) - gs[g] * w;
  }
  if (tid == 0) counters[b] = 0u;
}

// y = x * w + b, then silu in fp32 (SILU), cast to T; wb [B, 2, C].
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ wb,
                T* __restrict__ y, int64_t N, int C,
                int64_t rows_per_chunk) {
  const int nvec = C / V;
  const int R = blockDim.x / nvec;
  const int j = threadIdx.x % nvec;
  const int rg = threadIdx.x / nvec;
  const int64_t b = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_chunk;
  const int64_t r1 = min(N, r0 + rows_per_chunk);
  float w[V], o[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    w[v] = wb[b * 2 * C + j * V + v];
    o[v] = wb[b * 2 * C + C + j * V + v];
  }
  const int64_t base = b * N * C + j * V;
#pragma unroll 4
  for (int64_t r = r0 + rg; r < r1; r += R) {
    float f[V];
    load_vec<T, V>(x + base + r * C, f);
    Pack<T, V> out;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float t = fmaf(f[v], w[v], o[v]);
      // t * sigmoid(t) by the fast exp and divide (exp(-t) = inf gives
      // -0, as the plain version)
      if (SILU) t = __fdividef(t, 1.f + __expf(-t));
      out.v[v] = from_f32<T>(t);
    }
    *reinterpret_cast<Pack<T, V>*>(y + base + r * C) = out;
  }
}

// The plan the wrapper computed: V the vector width (1, or 16 bytes of T
// where C allows it), threads = R * C / V with R >= 1 and at least one
// whole warp, the chunks cover the N rows, each nonempty.
int check_plan(int itemsize, int width, int64_t B, int64_t N, int C,
               int threads, int chunks, int64_t rows) {
  if (B < 1 || N < 1 || C < 1 || C > kMaxChannels || chunks < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (width != 1 && width != 16 / itemsize) return (int)cudaErrorInvalidValue;
  if (C % width) return (int)cudaErrorInvalidValue;
  const int nvec = C / width;
  if (threads < nvec || threads < 32 || threads > kMaxThreads ||
      threads % nvec)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)chunks * rows < N || (int64_t)(chunks - 1) * rows >= N)
    return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <typename T, int V>
int launch_moments(const void* x, const void* scale, const void* bias,
                   int param_bf16, float* partial, unsigned* counters,
                   float* wb, int64_t B, int64_t N, int C, int G, int threads,
                   int chunks, int64_t rows, float eps, cudaStream_t s) {
  const int R = threads / (C / V);
  const size_t row_groups = R > 1 ? (size_t)R * C * 2 : 0;
  const int S = threads / C > 1 ? threads / C : 1;
  const size_t fold = (size_t)2 * S * C + 2 * G;
  const size_t smem = (row_groups > fold ? row_groups : fold) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)B);
  gn_moments_kernel<T, V><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), scale, bias, param_bf16, partial, counters,
      wb, N, C, G, rows, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_apply(const void* x, const float* wb, void* y, int silu, int64_t B,
                 int64_t N, int C, int threads, int chunks, int64_t rows,
                 cudaStream_t s) {
  dim3 grid((unsigned)chunks, (unsigned)B);
  if (silu)
    gn_apply_kernel<T, V, true><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), wb, static_cast<T*>(y), N, C, rows);
  else
    gn_apply_kernel<T, V, false><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), wb, static_cast<T*>(y), N, C, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype, param_dtype: 0 = float32, 1 = bfloat16 (x; scale and bias).
// width: values a thread loads along C (1, or 16 bytes of x's dtype; the
// caller checked 16-byte alignment).  partial: fp32 [B, chunks, 2, C]
// scratch; counters: [B] zeros, left zero; wb: fp32 [B, 2, C] out (w, b).
// Returns a cudaError_t code (0 = launched).
extern "C" int mmi_group_norm_moments(
    int device, int dtype, int param_dtype, int width, const void* x,
    const void* scale, const void* bias, float* partial, unsigned* counters,
    float* wb, int64_t B, int64_t N, int C, int G, int threads, int chunks,
    int64_t rows, float eps, void* stream) {
  if (dtype < 0 || dtype > 1 || param_dtype < 0 || param_dtype > 1 || G < 1 ||
      C % G)
    return (int)cudaErrorInvalidValue;
  int err = check_plan(dtype ? 2 : 4, width, B, N, C, threads, chunks, rows);
  if (err) return err;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return width == 1
               ? launch_moments<float, 1>(x, scale, bias, param_dtype, partial,
                                          counters, wb, B, N, C, G, threads,
                                          chunks, rows, eps, s)
               : launch_moments<float, 4>(x, scale, bias, param_dtype, partial,
                                          counters, wb, B, N, C, G, threads,
                                          chunks, rows, eps, s);
  return width == 1
             ? launch_moments<__nv_bfloat16, 1>(x, scale, bias, param_dtype,
                                                partial, counters, wb, B, N, C,
                                                G, threads, chunks, rows, eps,
                                                s)
             : launch_moments<__nv_bfloat16, 8>(x, scale, bias, param_dtype,
                                                partial, counters, wb, B, N, C,
                                                G, threads, chunks, rows, eps,
                                                s);
}

// y [B, N, C] in x's dtype; silu: 1 = silu(t), 0 = t.  The plan is the
// moments launch's.
extern "C" int mmi_group_norm_apply(int device, int dtype, int width, int silu,
                                    const void* x, const float* wb, void* y,
                                    int64_t B, int64_t N, int C, int threads,
                                    int chunks, int64_t rows, void* stream) {
  if (dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  int err = check_plan(dtype ? 2 : 4, width, B, N, C, threads, chunks, rows);
  if (err) return err;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return width == 1 ? launch_apply<float, 1>(x, wb, y, silu, B, N, C,
                                               threads, chunks, rows, s)
                      : launch_apply<float, 4>(x, wb, y, silu, B, N, C,
                                               threads, chunks, rows, s);
  return width == 1 ? launch_apply<__nv_bfloat16, 1>(x, wb, y, silu, B, N, C,
                                                     threads, chunks, rows, s)
                    : launch_apply<__nv_bfloat16, 8>(x, wb, y, silu, B, N, C,
                                                     threads, chunks, rows, s);
}
