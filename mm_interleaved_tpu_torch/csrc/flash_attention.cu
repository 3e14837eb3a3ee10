// Flash attention, forward, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/flash_attention.py::flash_attention, the
// wrapper around JAX's Pallas TPU flash-attention kernel.  The TPU kernel
// streams K/V blocks through VMEM with an online softmax on a sequential
// grid; here one CTA owns one (batch, head, 64-query tile) and loops over
// 64-key tiles itself, because CUDA blocks run in no order and carry
// nothing between each other.
//
// Bound: operations at the UNet's 64 and 32 px shapes (4 * Tq * Tk * D
// flops against (Tq + 2 Tk) * D elements moved), bytes at the small ones.
// The [Tq, Tk] logits never reach device memory, and the running max and
// sum stay fp32 per row.  Two kernels:
//  * bf16 with D % 16 == 0 (every call of the flagship): tensor cores via
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Four warps each own 16
//    query rows; Q stays in registers as A fragments, K is staged row-major
//    and V transposed in shared memory, the logits tile of a warp stays in
//    the accumulator registers, where the softmax runs, and is re-packed to
//    bf16 A fragments for P @ V (the FlashAttention-2 register reuse).  No
//    cp.async pipelining or wgmma yet: the work of a later change.
//  * otherwise (fp32, or the tiny preset's D = 8): fp32 on the CUDA cores.
//    K is staged transposed and V row-major, each thread keeps a 4x4 block
//    of logits and a 4 x D/16 block of the output in registers.
//
// Masked logits take the lowest finite fp32 value, as the plain version
// does, so a fully masked row averages V instead of producing NaN; keys
// past the end of the sequence take -inf and weigh exactly nothing.
//
// C interface (ctypes): mmi_flash_attention_fwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // queries per CTA
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kMaxD = 128;
constexpr int kPS = kBN + 4;   // row stride of the probability tile

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

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBM * (D + 4) + 2 * (size_t)kBN * D +
                          (size_t)kBM * kPS) +
         sizeof(int) * kBN;
}

// q [B, Tq, H, D], k/v [B, Tk, H, D], out [B, Tq, H, D]; qseg [B, Tq] and
// kseg [B, Tk] int32 or both null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 int Tq, int Tk, int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int QS = D + 4;
  float* Qs = smem;             // [kBM][QS]
  float* Kt = Qs + kBM * QS;    // [D][kBN]  (K transposed)
  float* Vs = Kt + D * kBN;     // [kBN][D]
  float* Ps = Vs + kBN * D;     // [kBM][kPS]
  int* Ks = reinterpret_cast<int*>(Ps + kBM * kPS);  // [kBN] kv segments

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // key columns tx + 16*j, output columns tx + 16*j
  const int64_t row = (int64_t)H * D;  // stride of one token
  const T* qb = q + (int64_t)b * Tq * row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Tk * row + (int64_t)h * D;
  const T* vb = v + (int64_t)b * Tk * row + (int64_t)h * D;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qs[r * QS + d] = qi < Tq ? to_f32(qb[(int64_t)qi * row + d]) : 0.f;
  }
  int qrow[4], qs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qrow[i] = q0 + ty * 4 + i;
    qs[i] = (qseg != nullptr && qrow[i] < Tq) ? qseg[(int64_t)b * Tq + qrow[i]]
                                              : 0;
  }

  float m[4], l[4], acc[4][kMaxD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) acc[i][j] = 0.f;
  }
  const int shift = Tk - Tq;  // end-aligned causal mask
  const float kNeg = -FLT_MAX;

  for (int n0 = 0; n0 < Tk; n0 += kBN) {
    __syncthreads();  // the previous tile's Kt/Vs/Ps reads are done
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const int kj = n0 + c;
      float kv = 0.f, vv = 0.f;
      if (kj < Tk) {
        kv = to_f32(kb[(int64_t)kj * row + d]);
        vv = to_f32(vb[(int64_t)kj * row + d]);
      }
      Kt[d * kBN + c] = kv;
      Vs[c * D + d] = vv;
    }
    if (tid < kBN) {
      const int kj = n0 + tid;
      Ks[tid] = (kseg != nullptr && kj < Tk) ? kseg[(int64_t)b * Tk + kj] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = n0 + c;
        float x;
        if (kj >= Tk) {
          x = -INFINITY;
        } else {
          x = s[i][j] * scale;
          if (causal && kj > qrow[i] + shift) x = kNeg;
          if (kseg != nullptr && Ks[c] != qs[i]) x = kNeg;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);  // finite: the tile has a real key
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int c = 0; c < kBN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* ob = out + (int64_t)b * Tq * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qrow[i] >= Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[(int64_t)qrow[i] * row + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 tensor-core kernel

constexpr int kMmaWarps = 4;          // 16 query rows each
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPad = 8;               // bf16 elements of row padding

size_t mma_smem_bytes(int D) {
  return sizeof(__nv_bfloat16) *
             (2 * (size_t)kBM * (D + kPad) + (size_t)D * (kBN + kPad)) +
         sizeof(int) * kBN;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The same contract as flash_fwd_kernel, bf16, D % 16 == 0, 16-byte
// aligned rows.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, int Tq, int Tk, int H,
                     float scale, int causal) {
  constexpr int QS = D + kPad;   // row stride of Qs and Ks
  constexpr int VS = kBN + kPad; // row stride of Vt
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;    // output n-blocks
  constexpr int NB_K = kBN / 8;  // logit n-blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBM * QS;
  __nv_bfloat16* Vt = Ks + kBN * QS;  // [D][VS]
  int* Ksg = reinterpret_cast<int*>(Vt + D * VS);

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int64_t row = (int64_t)H * D;
  const __nv_bfloat16* qb = q + (int64_t)b * Tq * row + (int64_t)h * D;
  const __nv_bfloat16* kb = k + (int64_t)b * Tk * row + (int64_t)h * D;
  const __nv_bfloat16* vb = v + (int64_t)b * Tk * row + (int64_t)h * D;
  constexpr int VEC = 8;  // bf16 per 16-byte load
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kBM * D / VEC; i += kMmaThreads) {
    const int r = i / (D / VEC), c = (i - r * (D / VEC)) * VEC;
    const int qi = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * QS + c) =
        qi < Tq ? *reinterpret_cast<const uint4*>(qb + (int64_t)qi * row + c)
                : zero4;
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = ld32(Qs + r0 * QS + c);
    qa[ks][1] = ld32(Qs + (r0 + 8) * QS + c);
    qa[ks][2] = ld32(Qs + r0 * QS + c + 8);
    qa[ks][3] = ld32(Qs + (r0 + 8) * QS + c + 8);
  }
  int qrow[2], qs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + r0 + 8 * i;
    qs[i] = (qseg != nullptr && qrow[i] < Tq) ? qseg[(int64_t)b * Tq + qrow[i]]
                                              : 0;
  }

  float o[NB_D][4];
#pragma unroll
  for (int j = 0; j < NB_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int shift = Tk - Tq;
  const float kNeg = -FLT_MAX;

  for (int n0 = 0; n0 < Tk; n0 += kBN) {
    __syncthreads();  // the previous tile's Ks/Vt reads are done
    for (int i = tid; i < kBN * D / VEC; i += kMmaThreads) {
      const int c = i / (D / VEC), d = (i - c * (D / VEC)) * VEC;
      const int kj = n0 + c;
      uint4 kv = zero4, vv = zero4;
      if (kj < Tk) {
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)kj * row + d);
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)kj * row + d);
      }
      *reinterpret_cast<uint4*>(Ks + c * QS + d) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vt[(d + e) * VS + c] = ve[e];
    }
    if (tid < kBN) {
      const int kj = n0 + tid;
      Ksg[tid] = (kseg != nullptr && kj < Tk) ? kseg[(int64_t)b * Tk + kj] : 0;
    }
    __syncthreads();

    float s[NB_K][4];
#pragma unroll
    for (int nb = 0; nb < NB_K; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const __nv_bfloat16* kr = Ks + (nb * 8 + g) * QS + tig * 2;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        mma_bf16(s[nb], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
      }
    }

    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB_K; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;  // row r0 (e < 2) or r0 + 8
        const int c = nb * 8 + tig * 2 + (e & 1);
        const int kj = n0 + c;
        float x;
        if (kj >= Tk) {
          x = -INFINITY;
        } else {
          x = s[nb][e] * scale;
          if (causal && kj > qrow[i] + shift) x = kNeg;
          if (kseg != nullptr && Ksg[c] != qs[i]) x = kNeg;
        }
        s[nb][e] = x;
        mt[i] = fmaxf(mt[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float mn = fmaxf(m[i], mt[i]);  // finite: the tile has a key
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB_K; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - m[e >> 1]);
        s[nb][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < NB_D; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NB_D; ++j) {
        const __nv_bfloat16* vr = Vt + (j * 8 + g) * VS + kk * 16 + tig * 2;
        mma_bf16(o[j], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* ob = out + (int64_t)b * Tq * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < NB_D; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qrow[i] * row + j * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* qseg, const int* kseg, int B, int Tq, int Tk, int H,
               float scale, int causal, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBM - 1) / kBM, H, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), qseg, kseg, Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

int launch_mma_any(int D, const void* q, const void* k, const void* v,
                   void* out, const int* qseg, const int* kseg, int B, int Tq,
                   int Tk, int H, float scale, int causal,
                   cudaStream_t stream) {
  switch (D) {
#define MMI_CASE(d)                                                          \
  case d:                                                                    \
    return launch_mma<d>(q, k, v, out, qseg, kseg, B, Tq, Tk, H, scale,      \
                         causal, stream);
    MMI_CASE(16) MMI_CASE(32) MMI_CASE(48) MMI_CASE(64) MMI_CASE(80)
    MMI_CASE(96) MMI_CASE(112) MMI_CASE(128)
#undef MMI_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* qseg, const int* kseg, int B, int Tq, int Tk, int H,
           int D, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qseg, kseg, Tq, Tk, H, D,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qseg/kseg: int32 segment ids or both
// null.  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_flash_attention_fwd(int device, int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, const void* qseg,
                                       const void* kseg, int B, int Tq, int Tk,
                                       int H, int D, float scale, int causal,
                                       void* stream) {
  if (D < 1 || D > kMaxD || D % 8 != 0 || Tk < 1 || H > 65535 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if ((qseg == nullptr) != (kseg == nullptr)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kseg);
  if (dtype == 0) {
    return launch<float>(q, k, v, out, qs, ks, B, Tq, Tk, H, D, scale, causal,
                         s);
  }
  if (dtype == 1) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(out);
    if (D % 16 == 0 && addr % 16 == 0) {
      return launch_mma_any(D, q, k, v, out, qs, ks, B, Tq, Tk, H, scale,
                            causal, s);
    }
    return launch<__nv_bfloat16>(q, k, v, out, qs, ks, B, Tq, Tk, H, D, scale,
                                 causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
