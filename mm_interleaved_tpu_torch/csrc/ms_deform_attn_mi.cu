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
// Bound: the four corner FMAs of every sample and channel (fp32 on the CUDA
// cores) at the flagship's sites, the gathered bytes at small ones.  The
// TPU kernel builds dense bilinear matrices from value slabs, occupancy
// bit-words and a transposed query slab because a TPU has no gather; none
// of that is needed here.  An image whose wi is all zero for the (b, h) is
// skipped, which is exact and makes masked images cost nothing.  The
// wrapper picks the variant (ops/ms_deform_attn_mi.py::mi_variant) and
// passes it in:
//  * "tiled" (every call whose texel row is a whole number of 16-byte
//    lanes: D % 8 == 0 in bf16, D % 4 == 0 in fp32): a CTA owns one image
//    row bv, one head and a tile of spatially neighbouring queries taken
//    from every query row that reads bv (both CFG halves: rows bv and
//    bv + Bv), so that the texels a tile's samples touch are read from L1
//    by its neighbours and by the other half.  The wrapper passes the tile
//    order (8 x 8 blocks of a square query grid).  Each (b, q) is a stream
//    of LANES lanes, each lane 16 bytes of channels (8 in bf16); a warp
//    takes 32 / LANES streams at a time, 1-4 times (fewer where the grid
//    would not give every SM two CTAs: the 8 and 16 px sites).  The CTA
//    reads the (bv, h) delta rows, their liveness and the level table once
//    into shared memory; per chunk of LANES samples each lane computes one
//    sample's location, its corners' byte offsets (clamped into the level)
//    and weights (bilinear x attention) into a per-warp table, which the
//    stream's lanes then read; the lanes issue all corner loads of two
//    samples before the first FMA, and widen bf16 by a shift or a mask.
//    Every level is read through L1.  Measured on the H100, the kernel
//    takes the same time under
//    uniform locations as under the flagship's clustered ones: it is bound
//    by the instructions a sample costs (the FMAs, the widening, the
//    addresses), not by where the corners lie.
//  * "flat" (other widths): one thread per (b, q, h, 4 channels), lanes
//    along D; images, levels and points loop inside the thread.
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

// ---------------------------------------------------------------------------
// the tiled kernel

constexpr int kTThreads = 256;  // 8 warps
constexpr int kMaxRounds = 4;   // stream groups a warp takes in turn

// one sample of one stream: each corner's byte offset from the image's base
// and weight (bilinear x attention, 0 outside the level)
struct alignas(16) Entry {
  uint32_t o[4];
  float w[4];
};

size_t tiled_smem_bytes(int n_img, int LP) {
  return sizeof(Entry) * 8 * 32 + sizeof(float) * n_img * LP * 3 +
         sizeof(int) * (n_img + 3 * kMaxLevels);
}

// the four corners of a sample, 16 bytes of channels each, through the
// read-only path
__device__ __forceinline__ void load_corners(uint4 (&v)[4], const Entry& e,
                                             const char* gbase) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    v[c] = __ldg(reinterpret_cast<const uint4*>(gbase + e.o[c]));
}

// acc += w * the 16 bytes of channels in ``u`` (bf16 widened by a shift or
// a mask: one integer op a value)
__device__ __forceinline__ void fma16(float (&acc)[8], float w,
                                      const uint4& u, __nv_bfloat16) {
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(w, __uint_as_float(x[i] << 16), acc[2 * i]);
    acc[2 * i + 1] =
        fmaf(w, __uint_as_float(x[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}
__device__ __forceinline__ void fma16(float (&acc)[4], float w,
                                      const uint4& u, float) {
  acc[0] = fmaf(w, __uint_as_float(u.x), acc[0]);
  acc[1] = fmaf(w, __uint_as_float(u.y), acc[1]);
  acc[2] = fmaf(w, __uint_as_float(u.z), acc[2]);
  acc[3] = fmaf(w, __uint_as_float(u.w), acc[3]);
}

// value [Bv, n_img, S, H, D], the rest as mi_fwd_kernel; order [Lq] int32,
// the query of each tile slot (null: the identity).  Grid: (query tiles,
// H, Bv); a tile is 8 * (32 / LANES) * rounds streams, R = B / Bv of them
// per query.
template <typename V, int LANES>
__global__ void __launch_bounds__(kTThreads, 3)
mi_tiled_kernel(const V* __restrict__ value, const float* __restrict__ delta,
                const float* __restrict__ ref, const float* __restrict__ off_q,
                const V* __restrict__ wq, V* __restrict__ out,
                const int* __restrict__ order, int rounds, int Bv, int R,
                int Lq, int n_img, int S, int H, int D, int L, int P,
                float inv_base, Levels lv) {
  constexpr int VEC = 16 / sizeof(V);
  constexpr int SW = 32 / LANES;  // streams a warp
  using Vec = Pack<V, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Entry* ent = reinterpret_cast<Entry*>(smem_raw);  // [8 warps][32]
  const int LP = L * P;
  float* dsm = reinterpret_cast<float*>(ent + 8 * 32);  // [n_img][LP][3]
  int* live = reinterpret_cast<int*>(dsm + n_img * LP * 3);
  int* lh = live + n_img;
  int* lw = lh + kMaxLevels;
  int* lst = lw + kMaxLevels;

  const int tile = blockIdx.x, h = blockIdx.y, bv = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ks = lane / LANES;  // the lane's stream in the warp
  const int cc = lane % LANES;  // its 16-byte channel block
  const int TQ = 8 * SW * rounds / R;  // queries a tile

  const float* dg = delta + ((int64_t)bv * H + h) * n_img * LP * 3;
  for (int i = tid; i < n_img * LP * 3; i += kTThreads) dsm[i] = dg[i];
  if (tid == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      lh[l] = lv.h[l];
      lw[l] = lv.w[l];
      lst[l] = lv.start[l];
    }
  }
  __syncthreads();
  if (tid < n_img) {
    bool any = false;
    for (int lp = 0; lp < LP; ++lp) any |= dsm[(tid * LP + lp) * 3 + 2] != 0.f;
    live[tid] = any;
  }
  __syncthreads();

  const int64_t HD = (int64_t)H * D;
  const uint32_t stride = (uint32_t)HD * sizeof(V);  // bytes a texel
  Entry* my = ent + warp * 32;
  for (int r = 0; r < rounds; ++r) {
    const int s = (r * 8 + warp) * SW + ks;
    const int slot = s / R;
    const int pos = tile * TQ + slot;
    const bool ok = slot < TQ && pos < Lq;
    const int q = ok ? (order != nullptr ? order[pos] : pos) : 0;
    const int64_t bq = (int64_t)((s % R) * Bv + bv) * Lq + q;
    const float rx = ref[2 * bq], ry = ref[2 * bq + 1];
    const float* oq = off_q + (bq * H + h) * P * 2;
    const V* wqp = wq + (bq * H + h) * LP;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

    for (int n = 0; n < n_img; ++n) {
      if (!live[n]) continue;
      const char* gbase = reinterpret_cast<const char*>(
          value + ((int64_t)bv * n_img + n) * S * HD + h * D + cc * VEC);
      const float* dl = dsm + n * LP * 3;
      for (int k0 = 0; k0 < LP; k0 += LANES) {
        // the table: lane (ks, cc) builds sample k0 + cc of stream ks
        Entry e;
        const int j = k0 + cc;
        if (j < LP) {
          const int l = j / P, p = j - l * P;
          const int hl = lh[l], wl = lw[l];
          float aw = 0.f, x = 0.f, y = 0.f;
          if (ok) {
            x = (rx + oq[2 * p] * inv_base) * wl - 0.5f + dl[3 * j];
            y = (ry + oq[2 * p + 1] * inv_base) * hl - 0.5f + dl[3 * j + 1];
            aw = to_f32(wqp[j]) * dl[3 * j + 2];
          }
          const float x0f = floorf(x), y0f = floorf(y);
          const float fx = x - x0f, fy = y - y0f;
          const int x0 = (int)x0f, y0 = (int)y0f;
          const float cw[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                               (1.f - fx) * fy, fx * fy};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int xi = x0 + (c & 1), yi = y0 + (c >> 1);
            const bool in = xi >= 0 && xi < wl && yi >= 0 && yi < hl;
            e.o[c] = (uint32_t)(lst[l] + min(max(yi, 0), hl - 1) * wl +
                                min(max(xi, 0), wl - 1)) * stride;
            e.w[c] = in ? cw[c] * aw : 0.f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            e.o[c] = 0;
            e.w[c] = 0.f;
          }
        }
        __syncwarp();  // the last chunk's entries are read
        my[lane] = e;
        __syncwarp();
        // the gather: two samples' corners in flight at once
        const int nk = min(LANES, LP - k0);
        const Entry* se = my + ks * LANES;
        for (int i = 0; i < nk; i += 2) {
          const int i1 = i + 1 < nk ? i + 1 : i;
          const Entry e0 = se[i];
          Entry e1 = se[i1];
          if (i1 == i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) e1.w[c] = 0.f;
          }
          uint4 v0[4], v1[4];
          load_corners(v0, e0, gbase);
          load_corners(v1, e1, gbase);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            fma16(acc, e0.w[c], v0[c], V());
            fma16(acc, e1.w[c], v1[c], V());
          }
        }
      }
    }
    if (ok) {
      Vec o;
#pragma unroll
      for (int x = 0; x < VEC; ++x) o.v[x] = from_f32<V>(acc[x]);
      *reinterpret_cast<Vec*>(out + (bq * H + h) * D + cc * VEC) = o;
    }
  }
}

template <typename V, int LANES>
int launch_tiled_lanes(const void* value, const float* delta, const float* ref,
                       const float* off_q, const void* wq, void* out,
                       const int* order, int Bv, int B, int Lq, int n_img,
                       int S, int H, int D, int L, int P, float inv_base,
                       const Levels& lv, cudaStream_t stream) {
  const size_t bytes = tiled_smem_bytes(n_img, L * P);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mi_tiled_kernel<V, LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // the most rounds (the largest query tile) that still gives every SM two
  // CTAs
  const int R = B / Bv;
  const int per_round = 8 * (32 / LANES);
  int rounds = kMaxRounds;
  auto ctas = [&](int rr) {
    const int tq = per_round * rr / R;
    return tq < 1 ? 0L : (long)((Lq + tq - 1) / tq) * H * Bv;
  };
  while (rounds > 1 && ctas(rounds) < 2L * sms) rounds /= 2;
  while (per_round * rounds / R < 1 && rounds < 64) rounds *= 2;
  const long n_ctas = ctas(rounds);
  if (n_ctas < 1 || n_ctas / ((long)H * Bv) > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(n_ctas / ((long)H * Bv)), H, Bv);
  mi_tiled_kernel<V, LANES><<<grid, kTThreads, bytes, stream>>>(
      static_cast<const V*>(value), delta, ref, off_q,
      static_cast<const V*>(wq), static_cast<V*>(out), order, rounds, Bv, R,
      Lq, n_img, S, H, D, L, P, inv_base, lv);
  return (int)cudaGetLastError();
}

// LANES = D * sizeof(V) / 16, one of 1, 2, 4, 8, 16, 32
template <typename V>
int launch_tiled(const void* value, const float* delta, const float* ref,
                 const float* off_q, const void* wq, void* out,
                 const int* order, int Bv, int B, int Lq, int n_img, int S,
                 int H, int D, int L, int P, float inv_base, const Levels& lv,
                 cudaStream_t stream) {
  if ((D * (int)sizeof(V)) % 16 != 0) return (int)cudaErrorInvalidValue;
#define MMI_LANES(n)                                                         \
  case n:                                                                    \
    return launch_tiled_lanes<V, n>(value, delta, ref, off_q, wq, out, order, \
                                    Bv, B, Lq, n_img, S, H, D, L, P,         \
                                    inv_base, lv, stream);
  switch (D * (int)sizeof(V) / 16) {
    MMI_LANES(1) MMI_LANES(2) MMI_LANES(4) MMI_LANES(8) MMI_LANES(16)
    MMI_LANES(32)
  }
#undef MMI_LANES
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (value, wq and out).  variant: 0 =
// flat, 1 = tiled (ops/ms_deform_attn_mi.py::mi_variant).  order: int32
// [Lq], the tiled kernel's query order, or null.  level_hw: host array of
// 2*L ints (h0, w0, h1, w1, ...).  Returns a cudaError_t code (0 =
// launched); a variant that cannot take the call is cudaErrorInvalidValue.
extern "C" int mmi_ms_deform_attn_mi_fwd(
    int device, int dtype, int variant, const void* value, const void* delta,
    const void* ref, const void* off_q, const void* wq, void* out,
    const void* order, int Bv, int B, int Lq, int n_img, int S, int H, int D,
    int L, int P, float inv_base, const int* level_hw, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1 || Bv < 1 || B % Bv != 0 ||
      (dtype != 0 && dtype != 1)) {
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
  if ((int64_t)B * Lq * H == 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(value) |
                         reinterpret_cast<uintptr_t>(out);
  const int elem = dtype == 0 ? 4 : 2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dl = static_cast<const float*>(delta);
  const float* rf = static_cast<const float*>(ref);
  const float* oq = static_cast<const float*>(off_q);
  if (variant == 1) {
    if (addr % 16 != 0 || (int64_t)S * H * D * elem > 0xffffffffLL ||
        Bv > 65535 || H > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    const int* od = static_cast<const int*>(order);
    if (dtype == 0)
      return launch_tiled<float>(value, dl, rf, oq, wq, out, od, Bv, B, Lq,
                                 n_img, S, H, D, L, P, inv_base, lv, s);
    return launch_tiled<__nv_bfloat16>(value, dl, rf, oq, wq, out, od, Bv, B,
                                       Lq, n_img, S, H, D, L, P, inv_base, lv,
                                       s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const int vec = (D % 4 == 0 && addr % (4 * elem) == 0) ? 4 : 1;
  const int64_t total = (int64_t)B * Lq * H * (D / vec);
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
#define MMI_LAUNCH(V, VEC)                                                    \
  launch<V, VEC>(value, dl, rf, oq, wq, out, Bv, Lq, n_img, S, H, D, L, P,   \
                 inv_base, total, lv, s)
  if (dtype == 0) {
    if (vec == 4) MMI_LAUNCH(float, 4); else MMI_LAUNCH(float, 1);
  } else {
    if (vec == 4) MMI_LAUNCH(__nv_bfloat16, 4); else MMI_LAUNCH(__nv_bfloat16, 1);
  }
#undef MMI_LAUNCH
  return (int)cudaGetLastError();
}
