// Multi-scale deformable attention, backward, in the dense bilinear-matrix
// formulation (v4), for sm_90a: the value gradient and the location/weight
// gradient.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py::
// _kernel_v4_bwd_dv and ::_kernel_v4_bwd_dslab.  With the forward's
//   A_l[q, y*w + x] = sum_p aw_p[q] hat(x - xs_p[q]) hat(y - ys_p[q])
// (ms_deform_attn_v4.cu) and g = dOut in the value's dtype:
//   dV_l  = A_l^T g, A rounded to the value's dtype;
//   dA_l  = g V_l^T, and per (query, point)
//   d_aw  = sum_f wx wy dA,  d_xs = aw sum_f sx wy dA,  d_ys = aw sum_f wx sy dA,
// wx = hat(x - xs), sx = sign(x - xs) where |x - xs| < 1 and 0 elsewhere (so
// 0 at x = xs), the same in y; d loc_x = d_xs * w and d loc_y = d_ys * h.
// Every sum is fp32.  The formulation is kept, not replaced by a scatter and
// a gather (kernels 2 and 3, ms_deform_attn_bwd.cu, do that), because it is
// what the benchmark measures.
//
// Bound: operations on the fp32 units, as the forward.  Each kernel
// evaluates the hats of every (query, point, texel): Q * sum(h*w) * P per
// (n, h), about 1.1e10 at the benchmark's unet case, against about 1.8e11
// flops of products on the tensor cores.
//  * Value gradient (mmi_ms_deform_attn_v4_bwd_value): one block per (n, h,
//    level, 64-texel chunk), looping over all 64-query tiles.  Each step
//    stages the tile's samples and dOut, builds the A tile in fp32 from the
//    samples (a warp reads one query's samples, a broadcast), rounds it and
//    adds A^T . dOut into the chunk's dV held in registers.  The block owns
//    its texels, so the sum over query tiles (the TPU's sequential grid)
//    needs no atomics and is the same on every run; the block writes its dV
//    rows once, in the value's dtype.  A padded query has weight 0 and dOut
//    0, so it adds nothing.
//  * Location/weight gradient (mmi_ms_deform_attn_v4_bwd_loc_weight): one
//    block per (n, h, 64-query tile) that holds its dOut tile and walks each
//    level's texels in chunks of 64: dA = dOut . V_chunk^T into shared
//    memory in fp32, then each thread adds, for its (query, point) pairs,
//    wx wy dA, sx wy dA and wx sy dA over the chunk's texels.  At the end of
//    a level the sums are scaled by aw and by w and h and written as fp32.
//  * bf16 values: the products on mma.sync m16n8k16 (bf16 in, fp32
//    accumulate), eight warps each 16 rows by a quarter or half of the
//    columns; D a multiple of 16, at most 128.  fp32 values: fp32 FMAs on
//    the CUDA cores (TF32 would miss fp32 parity); D at most 128.
// No wgmma, TMA or skipping of texels that no sample touches (each point
// touches at most 2 x 2) yet: that is later work.
//
// C interface (ctypes): see the end of the file.

#include <type_traits>

#include "ms_deform_attn_v4.cuh"

namespace {

constexpr int kAS = kKC + kPad;  // row stride of the bf16 A^T and dOut^T tiles
constexpr int kDS = kKC + 1;     // row stride of the fp32 A and dA tiles

template <typename V>
constexpr bool kIsBf16 = std::is_same<V, __nv_bfloat16>::value;

template <typename V>
__device__ __forceinline__ V zero_of() {
  if constexpr (kIsBf16<V>) {
    return __float2bfloat16(0.f);
  } else {
    return 0.f;
  }
}

template <typename V>
size_t dv_smem_bytes(int P, int D) {
  const size_t samples = sizeof(float) * 3 * kTQ * P;
  if (kIsBf16<V>) {
    return samples + sizeof(__nv_bfloat16) * ((size_t)kKC + D) * kAS;
  }
  return samples + sizeof(float) * ((size_t)kTQ * kDS + (size_t)kTQ * D);
}

// loc [N, Q, H, L, P, 2], weight [N, Q, H, L, P], dout [N, Q, H, D] and
// grad_value [N, S, H, D] in the value's type V.  Grid (sum over levels of
// ceil(h*w / kKC), N * H); every texel of grad_value is written once.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
v4_bwd_value_kernel(const T* __restrict__ loc, const T* __restrict__ weight,
                    const V* __restrict__ dout, V* __restrict__ grad_value,
                    int Q, int H, int D, int S, int L, int P, Levels lv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ys = xs + kTQ * P;
  float* aw = ys + kTQ * P;

  // the block's level and texel chunk
  int l = 0, c = blockIdx.x;
  for (; l < L - 1; ++l) {
    const int nc = (lv.h[l] * lv.w[l] + kKC - 1) / kKC;
    if (c < nc) break;
    c -= nc;
  }
  const int hl = lv.h[l], wl = lv.w[l], hw = hl * wl;
  const int c0 = c * kKC;
  const int n = blockIdx.y / H, h = blockIdx.y - n * H;
  const int tid = threadIdx.x;
  const int bt = tid & (kKC - 1);  // texel of the A build
  const int br = tid / kKC;        // first query of the A build
  const int f = c0 + bt;
  const float tx = (float)(f % wl), ty = (float)(f / wl);
  const int64_t row = (int64_t)H * D;  // stride of one texel or query
  const V* go = dout + (int64_t)n * Q * row + (int64_t)h * D;
  V* gv = grad_value + ((int64_t)n * S + lv.start[l] + c0) * row +
          (int64_t)h * D;

  if constexpr (kIsBf16<V>) {
    __nv_bfloat16* At = reinterpret_cast<__nv_bfloat16*>(aw + kTQ * P);
    __nv_bfloat16* Gt = At + kKC * kAS;  // [D][kAS]: dOut tile, transposed
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = (warp & 3) * 16 + g;  // texel rows r0 and r0 + 8
    const int nb = D / 16;               // n-blocks of this warp
    const int nbase = (warp >> 2) * nb;  // first n-block (of D / 8)
    float acc[kMaxNB][4];
#pragma unroll
    for (int j = 0; j < kMaxNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      __syncthreads();  // the previous product has read At and Gt
      stage_samples(loc, weight, xs, ys, aw, n, h, q0, Q, H, L, P, l, hl,
                    wl);
      for (int i = tid; i < kTQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        Gt[d * kAS + r] = q0 + r < Q ? go[(int64_t)(q0 + r) * row + d]
                                     : __float2bfloat16(0.f);
      }
      __syncthreads();
      for (int r = br; r < kTQ; r += kThreads / kKC) {
        const float a = f < hw ? a_entry(xs, ys, aw, r, P, tx, ty) : 0.f;
        At[bt * kAS + r] = __float2bfloat16(a);  // A^T: texel-major
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kTQ / 16; ++ks) {
        const __nv_bfloat16* ar = At + r0 * kAS + ks * 16 + tig * 2;
        const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * kAS);
        const uint32_t a2 = ld32(ar + 8), a3 = ld32(ar + 8 * kAS + 8);
#pragma unroll
        for (int j = 0; j < kMaxNB; ++j) {
          if (j < nb) {
            const __nv_bfloat16* bp =
                Gt + ((nbase + j) * 8 + g) * kAS + ks * 16 + tig * 2;
            mma_bf16(acc[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
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
        const int t = r0 + 8 * hh;
        if (c0 + t < hw) {
          *reinterpret_cast<__nv_bfloat162*>(gv + (int64_t)t * row + d) =
              __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
        }
      }
    }
  } else {
    float* As = aw + kTQ * P;  // [kTQ][kDS]: A tile, query-major
    float* Gs = As + kTQ * kDS;  // [kTQ][D]: dOut tile
    const int rt = (tid >> 4) * 4;  // texels rt .. rt + 4 of the chunk
    const int dc = tid & 15;        // channels dc + 16 j
    float acc[4][kMaxCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;

    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      __syncthreads();
      stage_samples(loc, weight, xs, ys, aw, n, h, q0, Q, H, L, P, l, hl,
                    wl);
      for (int i = tid; i < kTQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        Gs[i] = q0 + r < Q ? go[(int64_t)(q0 + r) * row + d] : 0.f;
      }
      __syncthreads();
      for (int r = br; r < kTQ; r += kThreads / kKC) {
        As[r * kDS + bt] = f < hw ? a_entry(xs, ys, aw, r, P, tx, ty) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kTQ; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k * kDS + rt + i];
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          const int d = dc + 16 * j;
          if (d < D) {
            const float v = Gs[k * D + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], v, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c0 + rt + i >= hw) continue;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int d = dc + 16 * j;
        if (d < D) gv[(int64_t)(rt + i) * row + d] = acc[i][j];
      }
    }
  }
}

// The row stride of the dOut and value tiles of the location/weight kernel.
template <typename V>
__host__ __device__ int lw_stride(int D) {
  return kIsBf16<V> ? D + kPad : D + 1;
}

template <typename V>
size_t lw_smem_bytes(int P, int D) {
  return sizeof(float) * 6 * kTQ * P +
         sizeof(V) * ((size_t)kTQ + kKC) * lw_stride<V>(D) +
         sizeof(float) * kTQ * kDS;
}

// sign(t) where |t| < 1, else 0: the hat's derivative.
__device__ __forceinline__ float hat_slope(float t) {
  return fabsf(t) < 1.f ? (t > 0.f ? 1.f : (t < 0.f ? -1.f : 0.f)) : 0.f;
}

// value [N, S, H, D] and dout [N, Q, H, D] in V; loc, weight as the value
// kernel; grad_loc fp32 [N, Q, H, L, P, 2], grad_weight fp32
// [N, Q, H, L, P], every element written.  Grid (ceil(Q / kTQ), N * H).
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
v4_bwd_loc_weight_kernel(const V* __restrict__ value,
                         const T* __restrict__ loc,
                         const T* __restrict__ weight,
                         const V* __restrict__ dout,
                         float* __restrict__ grad_loc,
                         float* __restrict__ grad_weight, int Q, int H, int D,
                         int S, int L, int P, Levels lv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* ys = xs + kTQ * P;
  float* aw = ys + kTQ * P;
  float* sx = aw + kTQ * P;  // per (query, point): sum sx wy dA
  float* sy = sx + kTQ * P;  // sum wx sy dA
  float* sw = sy + kTQ * P;  // sum wx wy dA
  const int GS = lw_stride<V>(D);
  V* Gs = reinterpret_cast<V*>(sw + kTQ * P);  // [kTQ][GS]: dOut tile
  V* Vs = Gs + kTQ * GS;                       // [kKC][GS]: value chunk
  float* dA = reinterpret_cast<float*>(Vs + kKC * GS);  // [kTQ][kDS]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;
  const int n = blockIdx.y / H, h = blockIdx.y - n * H;
  const int64_t row = (int64_t)H * D;
  const V zero = zero_of<V>();

  for (int i = tid; i < kTQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int q = q0 + r;
    Gs[r * GS + d] =
        q < Q ? dout[(((int64_t)n * Q + q) * H + h) * D + d] : zero;
  }

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l], hw = hl * wl;
    const V* vl = value + ((int64_t)n * S + lv.start[l]) * row +
                  (int64_t)h * D;
    __syncthreads();  // the previous level's sums have read dA
    stage_samples(loc, weight, xs, ys, aw, n, h, q0, Q, H, L, P, l, hl, wl);
    for (int i = tid; i < kTQ * P; i += kThreads) {
      sx[i] = sy[i] = sw[i] = 0.f;  // owned by this thread, as the samples
    }
    for (int c0 = 0; c0 < hw; c0 += kKC) {
      __syncthreads();  // the previous chunk's sums have read dA
      for (int i = tid; i < kKC * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        Vs[t * GS + d] = c0 + t < hw ? vl[(int64_t)(c0 + t) * row + d] : zero;
      }
      __syncthreads();
      // dA = dOut_tile . V_chunk^T, [kTQ queries][kKC texels]
      if constexpr (kIsBf16<V>) {
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, tig = lane & 3;
        const int r0 = (warp & 3) * 16 + g;  // query rows r0 and r0 + 8
        const int nt = (warp >> 2) * 4;      // first n-block of 8 texels
        float c[4][4] = {};
        for (int ks = 0; ks < D / 16; ++ks) {
          const __nv_bfloat16* ar = Gs + r0 * GS + ks * 16 + tig * 2;
          const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * GS);
          const uint32_t a2 = ld32(ar + 8), a3 = ld32(ar + 8 * GS + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat16* bp =
                Vs + ((nt + j) * 8 + g) * GS + ks * 16 + tig * 2;
            mma_bf16(c[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = (nt + j) * 8 + tig * 2;
          dA[r0 * kDS + t] = c[j][0];
          dA[r0 * kDS + t + 1] = c[j][1];
          dA[(r0 + 8) * kDS + t] = c[j][2];
          dA[(r0 + 8) * kDS + t + 1] = c[j][3];
        }
      } else {
        const int rq = (tid >> 4) * 4;  // queries rq .. rq + 4
        const int tc = tid & 15;        // texels tc + 16 j
        float c[4][4] = {};
        for (int d = 0; d < D; ++d) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Gs[(rq + i) * GS + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Vs[(tc + 16 * j) * GS + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dA[(rq + i) * kDS + tc + 16 * j] = c[i][j];
      }
      __syncthreads();
      // the chunk's texels against each (query, point) this thread owns
      const int cnt = min(kKC, hw - c0);
      const float wlf = (float)wl;
      for (int i = tid; i < kTQ * P; i += kThreads) {
        const float x = xs[i], y = ys[i];
        const float* da = dA + (i / P) * kDS;
        float fx = (float)(c0 % wl), fy = (float)(c0 / wl);
        float s_x = 0.f, s_y = 0.f, s_w = 0.f;
        for (int t = 0; t < cnt; ++t) {
          const float tx = fx - x, ty = fy - y;
          const float wx = hat(tx), wy = hat(ty);
          const float v = da[t];
          s_w += wx * wy * v;
          s_x += hat_slope(tx) * wy * v;
          s_y += wx * hat_slope(ty) * v;
          fx += 1.f;
          if (fx == wlf) {
            fx = 0.f;
            fy += 1.f;
          }
        }
        sx[i] += s_x;
        sy[i] += s_y;
        sw[i] += s_w;
      }
    }
    for (int i = tid; i < kTQ * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      const int q = q0 + r;
      if (q >= Q) continue;
      const int64_t s = (((int64_t)n * Q + q) * H + h) * L * P + l * P + p;
      grad_weight[s] = sw[i];
      grad_loc[2 * s] = aw[i] * sx[i] * (float)wl;
      grad_loc[2 * s + 1] = aw[i] * sy[i] * (float)hl;
    }
  }
}

template <typename V, typename T>
int launch_value(const void* loc, const void* weight, const void* dout,
                 void* grad_value, int N, int S, int Q, int H, int D, int L,
                 int P, const Levels& lv, cudaStream_t stream) {
  int chunks = 0;
  for (int l = 0; l < L; ++l) chunks += (lv.h[l] * lv.w[l] + kKC - 1) / kKC;
  const size_t smem = dv_smem_bytes<V>(P, D);
  const int e = allow_smem(v4_bwd_value_kernel<V, T>, smem);
  if (e) return e;
  v4_bwd_value_kernel<V, T><<<dim3(chunks, N * H), kThreads, smem, stream>>>(
      static_cast<const T*>(loc), static_cast<const T*>(weight),
      static_cast<const V*>(dout), static_cast<V*>(grad_value), Q, H, D, S, L,
      P, lv);
  return 0;
}

template <typename V, typename T>
int launch_loc_weight(const void* value, const void* loc, const void* weight,
                      const void* dout, float* grad_loc, float* grad_weight,
                      int N, int S, int Q, int H, int D, int L, int P,
                      const Levels& lv, cudaStream_t stream) {
  const size_t smem = lw_smem_bytes<V>(P, D);
  const int e = allow_smem(v4_bwd_loc_weight_kernel<V, T>, smem);
  if (e) return e;
  const dim3 grid((Q + kTQ - 1) / kTQ, N * H);
  v4_bwd_loc_weight_kernel<V, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout), grad_loc,
      grad_weight, Q, H, D, S, L, P, lv);
  return 0;
}

// Checks the sizes both kernels take and fills the level table; returns a
// cudaError_t code.
int prepare(int device, int value_dtype, int N, int S, int H, int D, int L,
            int P, const int* level_hw, Levels* lv) {
  if (L < 1 || L > kMaxLevels || P < 1 || P > kMaxP || D < 1 ||
      D > kMaxD || (value_dtype == 1 && D % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bad = fill_levels(level_hw, L, S, lv);
  if (bad) return bad;
  if ((int64_t)N * H > 65535) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSetDevice(device);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (value, dout and grad_value share
// one; loc and weight share the other: the value's, or float32).
// level_hw: host array (h0, w0, h1, w1, ...).  grad_value [N, S, H, D] in
// the value's dtype, every element written.  Returns a cudaError_t code
// (0 = launched).
extern "C" int mmi_ms_deform_attn_v4_bwd_value(
    int device, int value_dtype, int loc_dtype, const void* loc,
    const void* weight, const void* dout, void* grad_value, int N, int S,
    int Q, int H, int D, int L, int P, const int* level_hw, void* stream) {
  Levels lv = {};
  int err = prepare(device, value_dtype, N, S, H, D, L, P, level_hw, &lv);
  if (err) return err;
  if ((int64_t)N * H * S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 1 && loc_dtype == 0) {
    err = launch_value<__nv_bfloat16, float>(loc, weight, dout, grad_value, N,
                                             S, Q, H, D, L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch_value<__nv_bfloat16, __nv_bfloat16>(
        loc, weight, dout, grad_value, N, S, Q, H, D, L, P, lv, s);
  } else if (value_dtype == 0 && loc_dtype == 0) {
    err = launch_value<float, float>(loc, weight, dout, grad_value, N, S, Q,
                                     H, D, L, P, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

// grad_loc fp32 [N, Q, H, L, P, 2] and grad_weight fp32 [N, Q, H, L, P],
// every element written.
extern "C" int mmi_ms_deform_attn_v4_bwd_loc_weight(
    int device, int value_dtype, int loc_dtype, const void* value,
    const void* loc, const void* weight, const void* dout, float* grad_loc,
    float* grad_weight, int N, int S, int Q, int H, int D, int L, int P,
    const int* level_hw, void* stream) {
  Levels lv = {};
  int err = prepare(device, value_dtype, N, S, H, D, L, P, level_hw, &lv);
  if (err) return err;
  if ((int64_t)N * H * Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 1 && loc_dtype == 0) {
    err = launch_loc_weight<__nv_bfloat16, float>(
        value, loc, weight, dout, grad_loc, grad_weight, N, S, Q, H, D, L, P,
        lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch_loc_weight<__nv_bfloat16, __nv_bfloat16>(
        value, loc, weight, dout, grad_loc, grad_weight, N, S, Q, H, D, L, P,
        lv, s);
  } else if (value_dtype == 0 && loc_dtype == 0) {
    err = launch_loc_weight<float, float>(value, loc, weight, dout, grad_loc,
                                          grad_weight, N, S, Q, H, D, L, P, lv,
                                          s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
