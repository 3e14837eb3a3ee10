// Multi-scale deformable attention, forward, in the dense bilinear-matrix
// formulation (v4), for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py::_kernel_v4.
// Per (n, h) and level l the output is A_l @ V_l, where
//   A_l[q, y*w + x] = sum_p aw_p[q] hat(x - xs_p[q]) hat(y - ys_p[q]),
// hat(t) = max(1 - |t|, 0), over the level's row-major texels; A is rounded
// to the value's type before the product and the products of all levels
// accumulate in fp32.  The formulation is kept, not replaced by a gather
// (kernel 1, ms_deform_attn.cu, does that), because it is what the
// benchmark measures.
//
// Bound: operations, and not the tensor cores'.  Building A costs
// Q * sum(h*w) * P hat products for every (n, h), about 1.1e10 at the
// benchmark's unet case (each some 8 fp32 operations), against about
// 1.8e11 flops of products on the tensor cores, so the build on the fp32
// units comes first.  The design: one block per (n, h, 64-query tile).  The
// block stages its 64 x P samples of a level in shared memory, then walks
// the level's texels in chunks of 64: each thread builds 16 entries of the
// A chunk in fp32 from the staged samples (a warp reads one query's
// samples, a broadcast), rounds them, and stores them beside the V chunk;
// then the chunk's product adds into the output tile held in registers.
//  * bf16 values: mma.sync m16n8k16 (bf16 in, fp32 accumulate); eight
//    warps, each 16 queries by half of D.  D a multiple of 16, at most 128.
//  * fp32 values: the same loop with fp32 FMAs on the CUDA cores (the TPU
//    asked for Precision.HIGHEST there; TF32 would miss fp32 parity); each
//    thread 4 queries by D/16 channels.  D at most 128.
// No wgmma, TMA or skipping of texel chunks that no sample touches yet:
// that is later work.
//
// C interface (ctypes): mmi_ms_deform_attn_v4_fwd, see the end of the file.

#include "ms_deform_attn_v4.cuh"

namespace {

size_t mma_smem_bytes(int P, int D) {
  return sizeof(float) * 3 * kTQ * P +
         sizeof(__nv_bfloat16) * ((size_t)kTQ + D) * (kKC + kPad);
}

// value [N, S, H, D] bf16, loc [N, Q, H, L, P, 2], weight [N, Q, H, L, P],
// out [N, Q, H, D] bf16.  Grid (ceil(Q / kTQ), N * H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
v4_mma_kernel(const __nv_bfloat16* __restrict__ value,
              const T* __restrict__ loc, const T* __restrict__ weight,
              __nv_bfloat16* __restrict__ out, int Q, int H, int D, int S,
              int L, int P, Levels lv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ys = xs + kTQ * P;
  float* aw = ys + kTQ * P;
  constexpr int AS = kKC + kPad;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(aw + kTQ * P);
  __nv_bfloat16* Vt = As + kTQ * AS;  // [D][AS]: V chunk, transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kTQ;
  const int n = blockIdx.y / H, h = blockIdx.y - n * H;
  const int mt = warp & 3;               // query rows mt*16 .. +16
  const int nb = D / 16;                 // n-blocks of this warp
  const int nbase = (warp >> 2) * nb;    // first n-block (of D / 8)
  const int r0 = mt * 16 + g;            // rows r0 and r0 + 8
  const int bt = tid & (kKC - 1);        // texel of the A build
  const int br = tid / kKC;              // first row of the A build
  const int64_t row = (int64_t)H * D;    // stride of one texel

  float acc[kMaxNB][4];
#pragma unroll
  for (int j = 0; j < kMaxNB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l], hw = hl * wl;
    const __nv_bfloat16* vl =
        value + ((int64_t)n * S + lv.start[l]) * row + (int64_t)h * D;
    __syncthreads();  // the previous level's build has read the samples
    stage_samples(loc, weight, xs, ys, aw, n, h, q0, Q, H, L, P, l, hl, wl);
    for (int c0 = 0; c0 < hw; c0 += kKC) {
      __syncthreads();  // samples staged; the previous product read As, Vt
      {
        const int f = c0 + bt;
        const float tx = (float)(f % wl), ty = (float)(f / wl);
        for (int r = br; r < kTQ; r += kThreads / kKC) {
          const float a = f < hw ? a_entry(xs, ys, aw, r, P, tx, ty) : 0.f;
          As[r * AS + bt] = __float2bfloat16(a);
        }
      }
      for (int i = tid; i < kKC * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        const int f = c0 + t;
        Vt[d * AS + t] = f < hw ? vl[(int64_t)f * row + d]
                                : __float2bfloat16(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const __nv_bfloat16* ar = As + r0 * AS + ks * 16 + tig * 2;
        const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * AS);
        const uint32_t a2 = ld32(ar + 8), a3 = ld32(ar + 8 * AS + 8);
#pragma unroll
        for (int j = 0; j < kMaxNB; ++j) {
          if (j < nb) {
            const __nv_bfloat16* br_ =
                Vt + ((nbase + j) * 8 + g) * AS + ks * 16 + tig * 2;
            mma_bf16(acc[j], a0, a1, a2, a3, ld32(br_), ld32(br_ + 8));
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxNB; ++j) {
    if (j >= nb) continue;
    const int d = (nbase + j) * 8 + tig * 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + r0 + 8 * hh;
      if (q < Q) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((int64_t)n * Q + q) * H + h) * D + d) =
            __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
    }
  }
}

size_t f32_smem_bytes(int P, int D) {
  return sizeof(float) *
         (3 * (size_t)kTQ * P + (size_t)kTQ * (kKC + 1) + (size_t)kKC * D);
}

// As v4_mma_kernel for fp32 values, on the CUDA cores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
v4_f32_kernel(const float* __restrict__ value, const T* __restrict__ loc,
              const T* __restrict__ weight, float* __restrict__ out, int Q,
              int H, int D, int S, int L, int P, Levels lv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ys = xs + kTQ * P;
  float* aw = ys + kTQ * P;
  constexpr int AS = kKC + 1;
  float* As = aw + kTQ * P;   // [kTQ][AS]
  float* Vs = As + kTQ * AS;  // [kKC][D]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;
  const int n = blockIdx.y / H, h = blockIdx.y - n * H;
  const int rq = (tid >> 4) * 4;  // rows rq .. rq + 4
  const int dc = tid & 15;        // channels dc + 16 j
  const int bt = tid & (kKC - 1);
  const int br = tid / kKC;
  const int64_t row = (int64_t)H * D;

  float acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l], hw = hl * wl;
    const float* vl = value + ((int64_t)n * S + lv.start[l]) * row +
                      (int64_t)h * D;
    __syncthreads();
    stage_samples(loc, weight, xs, ys, aw, n, h, q0, Q, H, L, P, l, hl, wl);
    for (int c0 = 0; c0 < hw; c0 += kKC) {
      __syncthreads();
      {
        const int f = c0 + bt;
        const float tx = (float)(f % wl), ty = (float)(f / wl);
        for (int r = br; r < kTQ; r += kThreads / kKC) {
          As[r * AS + bt] = f < hw ? a_entry(xs, ys, aw, r, P, tx, ty) : 0.f;
        }
      }
      for (int i = tid; i < kKC * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        const int f = c0 + t;
        Vs[i] = f < hw ? vl[(int64_t)f * row + d] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kKC; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(rq + i) * AS + k];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          const int d = dc + 16 * j;
          if (d < D) {
            const float v = Vs[k * D + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], v, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + rq + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int d = dc + 16 * j;
      if (d < D) out[(((int64_t)n * Q + q) * H + h) * D + d] = acc[i][j];
    }
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  level_hw: host array of 2*L
// ints (h0, w0, h1, w1, ...).  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_ms_deform_attn_v4_fwd(int device, int value_dtype,
                                         int loc_dtype, const void* value,
                                         const void* loc, const void* weight,
                                         void* out, int N, int S, int Q,
                                         int H, int D, int L, int P,
                                         const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || P > kMaxP || D < 1 ||
      D > kMaxD || (value_dtype == 1 && D % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  const int bad = fill_levels(level_hw, L, S, &lv);
  if (bad) return bad;
  if ((int64_t)N * Q * H == 0) return 0;
  if ((int64_t)N * H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kTQ - 1) / kTQ, N * H);
  if (value_dtype == 1 && (loc_dtype == 0 || loc_dtype == 1)) {
    const size_t smem = mma_smem_bytes(P, D);
    const auto* v = static_cast<const __nv_bfloat16*>(value);
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (loc_dtype == 0) {
      int e = allow_smem(v4_mma_kernel<float>, smem);
      if (e) return e;
      v4_mma_kernel<float><<<grid, kThreads, smem, s>>>(
          v, static_cast<const float*>(loc), static_cast<const float*>(weight),
          o, Q, H, D, S, L, P, lv);
    } else {
      int e = allow_smem(v4_mma_kernel<__nv_bfloat16>, smem);
      if (e) return e;
      v4_mma_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
          v, static_cast<const __nv_bfloat16*>(loc),
          static_cast<const __nv_bfloat16*>(weight), o, Q, H, D, S, L, P, lv);
    }
  } else if (value_dtype == 0 && loc_dtype == 0) {
    const size_t smem = f32_smem_bytes(P, D);
    int e = allow_smem(v4_f32_kernel<float>, smem);
    if (e) return e;
    v4_f32_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(weight), static_cast<float*>(out), Q, H, D,
        S, L, P, lv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
