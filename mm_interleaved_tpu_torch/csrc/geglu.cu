// Fused GEGLU feed-forward, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/geglu.py::_kernel.  Computes
//   out = (a * gelu_erf(g)) @ w2^T + b2,  [a | g] = x @ w1^T + b1
// for x [T, C], w1 [2F, C], w2 [C, F] (PyTorch Linear layout, the GEGLU
// halves in diffusers order).  As on the TPU, a and g stay fp32 and the
// product a * gelu(g) is rounded to the input dtype before the second
// product; both products accumulate in fp32.
//
// Bound: operations (6 T C F flops against (2 T C + 3 C F) elements).
// What the fusion saves is the [T, 2F] intermediate, the largest stream of
// the unfused block: each CTA owns 32 tokens and walks the hidden width in
// chunks.  Per chunk it (1) forms the a and g chunk from the token tile and
// K slices of w1 staged in shared memory, (2) applies GEGLU in registers
// and parks the rounded chunk in shared memory, (3) stages the w2 columns
// of the chunk and adds the chunk's product into a [32, C] fp32
// accumulator held in registers (so C <= 640).  The intermediate never
// reaches device memory.  Two kernels:
//  * bf16 with C and F multiples of 64 and 16-byte aligned rows (every
//    call of the flagship): tensor cores via mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate), 64-column chunks and 64-wide K slices, the token
//    tile staged whole in shared memory.  Eight warps: in the first
//    product each owns 16 rows and 16 hidden columns of a and of g, in the
//    second 16 rows and a quarter of C.  No cp.async pipelining or wgmma
//    yet: the work of a later change.
//  * otherwise (fp32, or widths the tiny preset has): fp32 on the CUDA
//    cores, 32-column chunks and 32-wide K slices, 8 rows x C/64 output
//    columns per thread.
//
// C interface (ctypes): mmi_geglu_fwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTM = 32;         // tokens per CTA
constexpr int kFC = 32;         // hidden columns per chunk
constexpr int kKC = 32;         // K slice of the first product
constexpr int kThreads = 256;
constexpr int kMaxC = 640;
constexpr int kColGroups = kMaxC / 64;  // output columns per thread

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

size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)kTM * (kKC + 1) + 2 * (size_t)kFC * (kKC + 1) +
                          (size_t)kTM * (kFC + 1) + (size_t)C * (kFC + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
geglu_kernel(const T* __restrict__ x, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ b2, T* __restrict__ out, int Tn, int C,
             int F) {
  extern __shared__ float smem[];
  float* Xs = smem;                      // [kTM][kKC + 1]
  float* Was = Xs + kTM * (kKC + 1);     // [kFC][kKC + 1]  w1 rows of a
  float* Wgs = Was + kFC * (kKC + 1);    // [kFC][kKC + 1]  w1 rows of g
  float* Gs = Wgs + kFC * (kKC + 1);     // [kTM][kFC + 1]  GEGLU chunk
  float* W2s = Gs + kTM * (kFC + 1);     // [C][kFC + 1]    w2 columns

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTM;
  // first product: rows ra*4 .. +4, hidden column ja of the chunk
  const int ra = tid >> 5;
  const int ja = tid & 31;
  // second product: rows rb*8 .. +8, output columns cb + 64*i
  const int rb = tid >> 6;
  const int cb = tid & 63;

  float acc[8][kColGroups];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < kColGroups; ++i) acc[r][i] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kFC) {
    float av[4] = {0.f, 0.f, 0.f, 0.f};
    float gv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();  // previous reads of Xs/Was/Wgs (and Gs/W2s) done
      for (int i = tid; i < kTM * kKC; i += kThreads) {
        const int r = i / kKC, kk = i - r * kKC;
        const int t = t0 + r, kc = k0 + kk;
        Xs[r * (kKC + 1) + kk] =
            (t < Tn && kc < C) ? to_f32(x[(int64_t)t * C + kc]) : 0.f;
      }
      for (int i = tid; i < kFC * kKC; i += kThreads) {
        const int j = i / kKC, kk = i - j * kKC;
        const int f = f0 + j, kc = k0 + kk;
        const bool ok = f < F && kc < C;
        Was[j * (kKC + 1) + kk] = ok ? to_f32(w1[(int64_t)f * C + kc]) : 0.f;
        Wgs[j * (kKC + 1) + kk] =
            ok ? to_f32(w1[(int64_t)(F + f) * C + kc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float wa = Was[ja * (kKC + 1) + kk];
        const float wg = Wgs[ja * (kKC + 1) + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = Xs[(ra * 4 + i) * (kKC + 1) + kk];
          av[i] = fmaf(xv, wa, av[i]);
          gv[i] = fmaf(xv, wg, gv[i]);
        }
      }
    }

    const int f = f0 + ja;
    const float ba = f < F ? to_f32(b1[f]) : 0.f;
    const float bg = f < F ? to_f32(b1[F + f]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = av[i] + ba;
      const float g = gv[i] + bg;
      const float gelu = 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
      const float prod = f < F ? a * gelu : 0.f;
      Gs[(ra * 4 + i) * (kFC + 1) + ja] = to_f32(from_f32<T>(prod));
    }
    for (int i = tid; i < C * kFC; i += kThreads) {
      const int c = i / kFC, j = i - c * kFC;
      const int ff = f0 + j;
      W2s[c * (kFC + 1) + j] = ff < F ? to_f32(w2[(int64_t)c * F + ff]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFC; ++j) {
      float g[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) g[r] = Gs[(rb * 8 + r) * (kFC + 1) + j];
#pragma unroll
      for (int i = 0; i < kColGroups; ++i) {
        const int c = cb + 64 * i;
        if (c < C) {
          const float wv = W2s[c * (kFC + 1) + j];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][i] = fmaf(g[r], wv, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = t0 + rb * 8 + r;
    if (t >= Tn) continue;
#pragma unroll
    for (int i = 0; i < kColGroups; ++i) {
      const int c = cb + 64 * i;
      if (c < C) {
        out[(int64_t)t * C + c] = from_f32<T>(acc[r][i] + to_f32(b2[c]));
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 tensor-core kernel

constexpr int kMmaFC = 64;   // hidden columns per chunk
constexpr int kMmaKC = 64;   // K slice of the first product
constexpr int kPad = 8;      // bf16 elements of row padding
constexpr int kMaxNB = kMaxC / 32;  // output n-blocks per warp

size_t mma_smem_bytes(int C) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kTM * (C + kPad) + 2 * (size_t)kMmaFC * (kMmaKC + kPad) +
          (size_t)kTM * (kMmaFC + kPad) + (size_t)C * (kMmaFC + kPad));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x/out [Tn, C], w1 [2F, C], w2 [C, F] bf16; C % 64 == 0, F % 64 == 0,
// 16-byte aligned rows.
__global__ void __launch_bounds__(kThreads)
geglu_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w1,
                 const __nv_bfloat16* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2,
                 const __nv_bfloat16* __restrict__ b2,
                 __nv_bfloat16* __restrict__ out, int Tn, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XS = C + kPad, WS = kMmaKC + kPad, GS = kMmaFC + kPad;
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* W1s = Xs + kTM * XS;          // [2 * kMmaFC][WS]
  __nv_bfloat16* Gs = W1s + 2 * kMmaFC * WS;   // [kTM][GS]
  __nv_bfloat16* W2s = Gs + kTM * GS;          // [C][GS]
  constexpr int VEC = 8;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rb = warp & 1;   // row half of the tile
  const int wq = warp >> 1;  // hidden n-block pair (phase A), column
                             // quarter (phase B)
  const int t0 = blockIdx.x * kTM;
  const int r0 = rb * 16 + g;  // this thread's rows r0 and r0 + 8
  const int nbc = C / 32;      // output n-blocks per warp
  const int c_base = wq * (C / 4);

  for (int i = tid; i < kTM * C / VEC; i += kThreads) {
    const int r = i / (C / VEC), c = (i - r * (C / VEC)) * VEC;
    const int t = t0 + r;
    *reinterpret_cast<uint4*>(Xs + r * XS + c) =
        t < Tn ? *reinterpret_cast<const uint4*>(x + (int64_t)t * C + c)
               : zero4;
  }

  float acc[kMaxNB][4];
#pragma unroll
  for (int j = 0; j < kMaxNB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kMmaFC) {
    float a[2][4], gt[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[t][e] = gt[t][e] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kMmaKC) {
      __syncthreads();  // Xs is staged; the previous W1s (and Gs/W2s)
                        // reads are done
      for (int i = tid; i < 2 * kMmaFC * kMmaKC / VEC; i += kThreads) {
        const int j = i / (kMmaKC / VEC), kk = (i - j * (kMmaKC / VEC)) * VEC;
        const int f = j < kMmaFC ? f0 + j : F + f0 + (j - kMmaFC);
        *reinterpret_cast<uint4*>(W1s + j * WS + kk) =
            *reinterpret_cast<const uint4*>(w1 + (int64_t)f * C + k0 + kk);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kMmaKC / 16; ++ks) {
        const __nv_bfloat16* xr = Xs + r0 * XS + k0 + ks * 16 + tig * 2;
        const uint32_t a0 = ld32(xr), a1 = ld32(xr + 8 * XS);
        const uint32_t a2 = ld32(xr + 8), a3 = ld32(xr + 8 * XS + 8);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int nrow = (2 * wq + t) * 8 + g;
          const __nv_bfloat16* wa = W1s + nrow * WS + ks * 16 + tig * 2;
          const __nv_bfloat16* wg = wa + kMmaFC * WS;
          mma_bf16(a[t], a0, a1, a2, a3, ld32(wa), ld32(wa + 8));
          mma_bf16(gt[t], a0, a1, a2, a3, ld32(wg), ld32(wg + 8));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows r0, r0 + 8
        const int col = (2 * wq + t) * 8 + tig * 2;
        float v2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + col + e;
          const float av = a[t][2 * hh + e] + to_f32(b1[f]);
          const float gv = gt[t][2 * hh + e] + to_f32(b1[F + f]);
          v2[e] = av * (0.5f * gv * (1.f + erff(gv * 0.70710678118654752f)));
        }
        *reinterpret_cast<__nv_bfloat162*>(Gs + (r0 + 8 * hh) * GS + col) =
            __floats2bfloat162_rn(v2[0], v2[1]);
      }
    }
    for (int i = tid; i < C * kMmaFC / VEC; i += kThreads) {
      const int c = i / (kMmaFC / VEC), j = (i - c * (kMmaFC / VEC)) * VEC;
      *reinterpret_cast<uint4*>(W2s + c * GS + j) =
          *reinterpret_cast<const uint4*>(w2 + (int64_t)c * F + f0 + j);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaFC / 16; ++kk) {
      const __nv_bfloat16* gr = Gs + r0 * GS + kk * 16 + tig * 2;
      const uint32_t a0 = ld32(gr), a1 = ld32(gr + 8 * GS);
      const uint32_t a2 = ld32(gr + 8), a3 = ld32(gr + 8 * GS + 8);
#pragma unroll
      for (int j = 0; j < kMaxNB; ++j) {
        if (j < nbc) {
          const __nv_bfloat16* wr =
              W2s + (c_base + j * 8 + g) * GS + kk * 16 + tig * 2;
          mma_bf16(acc[j], a0, a1, a2, a3, ld32(wr), ld32(wr + 8));
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxNB; ++j) {
    if (j >= nbc) continue;
    const int c = c_base + j * 8 + tig * 2;
    const float bb0 = to_f32(b2[c]), bb1 = to_f32(b2[c + 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + r0 + 8 * hh;
      if (t < Tn) {
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)t * C + c) =
            __floats2bfloat162_rn(acc[j][2 * hh] + bb0,
                                  acc[j][2 * hh + 1] + bb1);
      }
    }
  }
}

int launch_mma(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, int Tn, int C, int F,
               cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      geglu_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Tn + kTM - 1) / kTM;
  geglu_mma_kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(out), Tn, C, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int Tn, int C, int F,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      geglu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Tn + kTM - 1) / kTM;
  geglu_kernel<T><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), Tn, C, F);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x/out [Tn, C], w1 [2F, C], b1 [2F],
// w2 [C, F], b2 [C].  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_geglu_fwd(int device, int dtype, const void* x,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int Tn, int C, int F,
                             void* stream) {
  if (C < 1 || C > kMaxC || F < 1 || Tn < 0) return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w1, b1, w2, b2, out, Tn, C, F, s);
  if (dtype == 1) {
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
        reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out);
    if (C % 64 == 0 && F % kMmaFC == 0 && addr % 16 == 0) {
      return launch_mma(x, w1, b1, w2, b2, out, Tn, C, F, s);
    }
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, Tn, C, F, s);
  }
  return (int)cudaErrorInvalidValue;
}
