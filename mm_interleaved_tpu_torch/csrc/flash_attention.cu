// Flash attention, forward, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/flash_attention.py::flash_attention, the
// wrapper around JAX's Pallas TPU flash-attention kernel.  The TPU kernel
// streams K/V blocks through VMEM with an online softmax on a sequential
// grid; here a CTA owns a (batch, head, query tile) and loops over the key
// tiles itself, because CUDA blocks run in no order and carry nothing
// between each other.  The [Tq, Tk] logits never reach device memory; the
// running max and sum stay fp32 per row.
//
// Bound: operations at the UNet's 64 and 32 px shapes (4 * Tq * Tk * D
// flops against (Tq + 2 Tk) * D elements moved), bytes at the small ones.
// At D = 64 each (query, key) pair also costs one exp against 256
// tensor-core flops: the H100's 16 exps per clock per SM put the exps of
// UNet attn1 64 px at about the tensor cores' bound, so the design keeps
// the exps under the products.  Three kernels:
//  * bf16 at D = 64 and 128 (every call of the flagship): the Hopper
//    kernel, persistent: one CTA an SM walks the work items (b, h, 64 * C
//    queries), so that the next item's loads run under the current one's
//    epilogue (most sites have one to four key tiles an item).  A
//    producer warpgroup whose one thread keeps Q and a ring of K/V tiles
//    (128 keys) in flight by TMA (4-D tensor maps over [B, T, H, D],
//    128-byte swizzle, rows past the end read as zeros), with full/empty
//    mbarriers; and C
//    consumer warpgroups (C = 3 at D = 64, 2 at D = 128) of 64 queries
//    each, with their registers raised by setmaxnreg.  S = Q K^T is a
//    wgmma from shared memory (Q resident); the online softmax runs in base
//    2 in the accumulator registers; P is re-packed to bf16 A fragments in
//    registers and O += P V is a wgmma with V read through the descriptor
//    as the MN-major operand, so nobody transposes V.  The consumers take
//    turns to issue their products (named barriers), and each issues tile
//    n's S together with tile n - 1's P V, so that softmax runs under the
//    tensor cores.  Causal: key tiles past an item's diagonal are skipped,
//    the element-wise masks run only on tiles that straddle an edge.
//  * bf16 at other multiples of 16 (the small preset's D = 32): mma.sync
//    m16n8k16, four warps of 16 query rows, K staged row-major and V
//    transposed in shared memory, 64-key tiles.
//  * otherwise (fp32, or the tiny preset's D = 8): fp32 on the CUDA cores.
//    K is staged transposed and V row-major, each thread keeps a 4x4 block
//    of logits and a 4 x D/16 block of the output in registers.
//
// Masked logits take the lowest finite fp32 value, as the plain version
// does, so a fully masked row averages V instead of producing NaN (the
// Hopper kernel then visits every key tile: with segment ids, or when a
// row comes before the first key); keys past the end of the sequence take
// -inf and weigh exactly nothing.
//
// For the backward (csrc/flash_attention_bwd.cu) the forward can also
// write each row's log-sum-exp.
//
// C interface (ctypes): mmi_flash_attention_fwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// The log-sum-exp of a row's scaled logits, for the backward, from its
// running max ``m`` (in units of ``unit`` nats: ln 2 where the softmax runs
// in base 2) and sum ``l``; -FLT_MAX marks a row whose keys are all masked
// (it averages V uniformly).
__device__ __forceinline__ float row_lse(float m, float l, float unit = 1.f) {
  return m == -FLT_MAX ? -FLT_MAX : m * unit + logf(l);
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
                 float* __restrict__ lse, int Tq, int Tk, int H, int D,
                 float scale, int causal) {
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
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * H + h) * Tq + qrow[i]] = row_lse(m[i], l[i]);
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

using hopper::pack_bf16;

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
                     const int* __restrict__ kseg, float* __restrict__ lse,
                     int Tq, int Tk, int H, float scale, int causal) {
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
    if (lse != nullptr && tig == 0)
      lse[((int64_t)b * H + h) * Tq + qrow[i]] = row_lse(m[i], l[i]);
#pragma unroll
    for (int j = 0; j < NB_D; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qrow[i] * row + j * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 Hopper kernel (D = 64 or 128): TMA, mbarrier ring, wgmma, ping-pong

template <int D>
struct Tma {
  // consumer warpgroups of 64 queries each: three fit the registers at
  // D = 64 (160 a thread), two at D = 128 (240)
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kConsumers;  // queries per CTA
  static constexpr int kBN = 128;  // keys per tile
  static constexpr int kStages = D == 64 ? 4 : 3;  // K/V tiles in flight
  static constexpr int kHalves = D / 64;  // 64-channel swizzled tiles
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // one of K, V
  static constexpr int kTile = kBN * 64 * 2;    // one 64-channel tile
  static constexpr int kBarOff = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (3 * kStages + 2) + 1024;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + producer
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
};

// The online softmax of one tile, base 2, in the accumulator registers:
// ``sa`` holds the raw logits of keys n0 .. n0 + 127 for rows qrow[0..1]
// and leaves with P (unnormalised, fp32); m and l move to the tile, alpha
// is the factor for the running output.  Masks only on an ``edge`` tile.
__device__ __forceinline__ void softmax_tile(
    float (&sa)[2][32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int n0, int cq, const int (&qrow)[2], const int (&qs)[2],
    const int* __restrict__ kseg_b, int Tk, int shift, int causal, bool edge,
    float scale2) {
  const float kNeg = -FLT_MAX;
  float mt[2] = {-INFINITY, -INFINITY};
  if (edge) {  // scale, then mask
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kj = n0 + kh * 64 + nb * 8 + cq + j;
          const int ksg = (kseg_b != nullptr && kj < Tk) ? kseg_b[kj] : 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float xv = sa[kh][nb * 4 + i * 2 + j] * scale2;
            if (kj >= Tk) {
              xv = -INFINITY;
            } else if ((causal && kj > qrow[i] + shift) ||
                       (kseg_b != nullptr && ksg != qs[i])) {
              xv = kNeg;
            }
            sa[kh][nb * 4 + i * 2 + j] = xv;
            mt[i] = fmaxf(mt[i], xv);
          }
        }
      }
    }
  } else {  // the raw maximum; the scale folds into the exponent's FMA
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], sa[kh][e]);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    if (!edge) mt[i] *= scale2;
    const float mn = fmaxf(m[i], mt[i]);  // finite: the tile has a key
    alpha[i] = hopper::exp2_approx(m[i] - mn);
    m[i] = mn;
  }
  const float sc = edge ? 1.f : scale2;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const float p = hopper::exp2_approx(fmaf(sa[kh][e], sc, -m[i]));
      sa[kh][e] = p;
      rs[i] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
}

// q, k, v through their tensor maps (bf16 [B, T, H, D], boxes of 64
// channels by kBM (q) or 128 (k, v) tokens); out [B, Tq, H, D]; the rest as
// flash_fwd_kernel.  scale2 = scale * log2(e): the softmax runs in base 2.
// Persistent: each CTA takes the work items (query tile, head, batch)
// blockIdx.x, blockIdx.x + gridDim.x, ..., neighbouring items sharing a
// head's K and V in L2; the producer loads the next item's Q and first K/V
// tiles while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(Tma<D>::kThreads, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ out,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, float* __restrict__ lse,
                     int B, int Tq, int Tk, int H, float scale2, int causal) {
  using C = Tma<D>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;                // [kHalves][kBM][64]
  unsigned char* KVs = smem + C::kQBytes;  // [kStages][K, V][kHalves][kBN][64]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full_v = full_k + C::kStages;
  uint64_t* empty = full_v + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  uint64_t* q_empty = qbar + 1;

  const int q_tiles = (Tq + C::kBM - 1) / C::kBM;
  const int items = q_tiles * H * B;
  const int shift = Tk - Tq;  // end-aligned causal mask
  const int wg = threadIdx.x / 128;
  // the item's first query, head, batch and key tiles; causal: keys past
  // the diagonal of its last row weigh nothing, unless a row has no key at
  // all (it then averages every key): its first row before the first key,
  // or any row under segment ids
  auto item_of = [&](int w, int& q0, int& h, int& b) {
    q0 = (w % q_tiles) * C::kBM;
    h = (w / q_tiles) % H;
    b = w / (q_tiles * H);
    int n_end = Tk;
    if (causal && kseg == nullptr && q0 + shift >= 0)
      n_end = min(Tk, q0 + C::kBM + shift);
    return (n_end + C::kBN - 1) / C::kBN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * C::kConsumers);  // one per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init(q_empty, 4 * C::kConsumers);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the TMA loads of the ring in flight
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int g = 0;  // K/V tiles loaded so far
      for (int j = 0, w = blockIdx.x; w < items; ++j, w += gridDim.x) {
        int q0, h, b;
        const int n_tiles = item_of(w, q0, h, b);
        mbar_wait(q_empty, (j & 1) ^ 1);  // the last item's S is done
        mbar_expect_tx(qbar, C::kQBytes);
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x)
          tma_load_4d(Qs + x * C::kBM * 128, &tq, qbar, x * 64, h, q0, b);
        for (int n = 0; n < n_tiles; ++n, ++g) {
          const int s = g % C::kStages;
          mbar_wait(&empty[s], ((g / C::kStages) & 1) ^ 1);
          unsigned char* ks = KVs + s * 2 * C::kKVBytes;
          mbar_expect_tx(&full_k[s], C::kKVBytes);
#pragma unroll
          for (int x = 0; x < C::kHalves; ++x)
            tma_load_4d(ks + x * C::kTile, &tk, &full_k[s], x * 64, h,
                        n * C::kBN, b);
          mbar_expect_tx(&full_v[s], C::kKVBytes);
#pragma unroll
          for (int x = 0; x < C::kHalves; ++x)
            tma_load_4d(ks + C::kKVBytes + x * C::kTile, &tv, &full_v[s],
                        x * 64, h, n * C::kBN, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<C::kConsumerRegs>();
    const int c = wg - 1;  // consumer: query rows c*64 .. c*64 + 63
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int cq = (lane & 3) * 2;  // column pair within 8-column blocks
    const unsigned char* qa = Qs + c * 64 * 128;
    float o[C::kHalves][32];
    float m[2], l[2], alpha[2];
    float sa[2][32];    // logits, then P: keys 0-63 and 64-127 of a tile
    uint32_t pa[8][4];  // the previous tile's P in bf16, 8 A fragments

    // S = Q K^T of K/V tile g into sa (K-major A and B)
    auto issue_s = [&](int g) {
      const unsigned char* ks = KVs + (g % C::kStages) * 2 * C::kKVBytes;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int k16 = 0; k16 < D / 16; ++k16) {
          const int x = k16 / 4, off = (k16 % 4) * 32;
          wgmma_ss(sa[kh], desc_b128(qa + x * C::kBM * 128 + off, 0, 1024),
                   desc_b128(ks + x * C::kTile + kh * 64 * 128 + off, 0, 1024),
                   k16 > 0);
        }
    };
    // O += P V of tile g (V[keys][channels] is the MN-major B operand)
    auto issue_pv = [&](int g) {
      const unsigned char* vs =
          KVs + (g % C::kStages) * 2 * C::kKVBytes + C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x)
          wgmma_rs(o[x], pa[kk],
                   desc_b128(vs + x * C::kTile + kk * 16 * 128, 1024, 1024));
    };
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int x = 0; x < C::kHalves; ++x)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[x][e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], sa[kk / 4], kk % 4);
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // Turns: the consumers issue their products in turn, consumer 0 first,
    // so that one's softmax runs under the others' products.  Consumer c
    // waits on named barrier 1 + c, at which the one before it (c - 1,
    // cyclically) arrives after its own products; the turns run on across
    // the items.  Within a consumer, tile n's S is issued with tile n - 1's
    // P V, and its softmax runs while P V does.
    const int last = C::kConsumers - 1;
    const int my_turn = 1 + c, next_turn = 1 + (c + 1) % C::kConsumers;
    if (c == last) bar_arrive(1, 256);
    int g = 0;  // K/V tiles consumed so far
    for (int j = 0, w = blockIdx.x; w < items; ++j, w += gridDim.x) {
      int q0, h, b;
      const int n_tiles = item_of(w, q0, h, b);
      const int row_min = q0 + c * 64;  // the consumer's first row
      int qrow[2], qs[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qrow[i] = row_min + warp * 16 + (lane >> 2) + 8 * i;
        qs[i] = (qseg != nullptr && qrow[i] < Tq)
                    ? qseg[(int64_t)b * Tq + qrow[i]]
                    : 0;
      }
      const int* kseg_b = kseg == nullptr ? nullptr : kseg + (int64_t)b * Tk;
      auto edge_of = [&](int n0) {
        return n0 + C::kBN > Tk || kseg != nullptr ||
               (causal && n0 + C::kBN - 1 > row_min + shift);
      };
#pragma unroll
      for (int x = 0; x < C::kHalves; ++x)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
      }

      mbar_wait(qbar, j & 1);
      mbar_wait(&full_k[g % C::kStages], (g / C::kStages) & 1);
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_s(g);
      wgmma_commit();
      bar_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs<32>(sa[0]);
      fence_regs<32>(sa[1]);
      if (n_tiles == 1) release(q_empty);
      softmax_tile(sa, m, l, alpha, 0, cq, qrow, qs, kseg_b, Tk, shift,
                   causal, edge_of(0), scale2);
      rescale_and_pack();

      for (int n = 1; n < n_tiles; ++n) {
        const int gi = g + n;
        mbar_wait(&full_k[gi % C::kStages], (gi / C::kStages) & 1);
        mbar_wait(&full_v[(gi - 1) % C::kStages],
                  ((gi - 1) / C::kStages) & 1);
        bar_sync(my_turn, 256);
        wgmma_fence();
        issue_s(gi);
        wgmma_commit();
        issue_pv(gi - 1);
        wgmma_commit();
        bar_arrive(next_turn, 256);
        wgmma_wait<1>();  // S of tile n
        fence_regs<32>(sa[0]);
        fence_regs<32>(sa[1]);
        if (n == n_tiles - 1) release(q_empty);
        softmax_tile(sa, m, l, alpha, n * C::kBN, cq, qrow, qs, kseg_b, Tk,
                     shift, causal, edge_of(n * C::kBN), scale2);
        wgmma_wait<0>();  // P V of tile n - 1
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x) fence_regs<32>(o[x]);
        fence_regs<32>(&pa[0][0]);
        release(&empty[(gi - 1) % C::kStages]);
        rescale_and_pack();
      }
      {
        const int gl = g + n_tiles - 1;
        mbar_wait(&full_v[gl % C::kStages], (gl / C::kStages) & 1);
        bar_sync(my_turn, 256);
        wgmma_fence();
        issue_pv(gl);
        wgmma_commit();
        // consumer 0 went first, so the last one owes no final turn
        if (!(c == last && w + (int)gridDim.x >= items))
          bar_arrive(next_turn, 256);
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x) fence_regs<32>(o[x]);
        release(&empty[gl % C::kStages]);
      }
      g += n_tiles;

      __nv_bfloat16* ob = out + ((int64_t)b * Tq * H + h) * D;
      const int64_t row = (int64_t)H * D;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (qrow[i] >= Tq) continue;
        const float inv = 1.f / l[i];
        if (lse != nullptr && (lane & 3) == 0)
          lse[((int64_t)b * H + h) * Tq + qrow[i]] =
              row_lse(m[i], l[i], 0.69314718055994531f);
#pragma unroll
        for (int x = 0; x < C::kHalves; ++x)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            *reinterpret_cast<__nv_bfloat162*>(ob + qrow[i] * row + x * 64 +
                                               nb * 8 + cq) =
                __floats2bfloat162_rn(o[x][nb * 4 + i * 2] * inv,
                                      o[x][nb * 4 + i * 2 + 1] * inv);
      }
    }
  }
}

template <int D>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               const int* qseg, const int* kseg, float* lse, int B, int Tq,
               int Tk, int H, float scale, int causal, cudaStream_t stream) {
  using C = Tma<D>;
  CUtensorMap mq, mk, mv;
  int err = hopper::make_map_bthd(&mq, q, B, Tq, H, D, C::kBM);
  if (err == 0) err = hopper::make_map_bthd(&mk, k, B, Tk, H, D, C::kBN);
  if (err == 0) err = hopper::make_map_bthd(&mv, v, B, Tk, H, D, C::kBN);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long items = (long)((Tq + C::kBM - 1) / C::kBM) * H * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // one CTA an SM (the registers allow no second)
  flash_fwd_tma_kernel<D><<<(int)(items < sms ? items : sms), C::kThreads,
                            C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), qseg, kseg, lse, B, Tq,
      Tk, H, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* qseg, const int* kseg, float* lse, int B, int Tq,
               int Tk, int H, float scale, int causal, cudaStream_t stream) {
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
      static_cast<__nv_bfloat16*>(out), qseg, kseg, lse, Tq, Tk, H, scale,
      causal);
  return (int)cudaGetLastError();
}

int launch_mma_any(int D, const void* q, const void* k, const void* v,
                   void* out, const int* qseg, const int* kseg, float* lse,
                   int B, int Tq, int Tk, int H, float scale, int causal,
                   cudaStream_t stream) {
  switch (D) {
#define MMI_CASE(d)                                                          \
  case d:                                                                    \
    return launch_mma<d>(q, k, v, out, qseg, kseg, lse, B, Tq, Tk, H, scale, \
                         causal, stream);
    MMI_CASE(16) MMI_CASE(32) MMI_CASE(48) MMI_CASE(80) MMI_CASE(96)
    MMI_CASE(112)
#undef MMI_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* qseg, const int* kseg, float* lse, int B, int Tq,
           int Tk, int H, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qseg, kseg, lse, Tq, Tk,
      H, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qseg/kseg: int32 segment ids or both
// null.  lse: fp32 [B, H, Tq] for the backward, or null.  Returns a
// cudaError_t code (0 = launched).
extern "C" int mmi_flash_attention_fwd(int device, int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, const void* qseg,
                                       const void* kseg, float* lse, int B,
                                       int Tq, int Tk, int H, int D,
                                       float scale, int causal, void* stream) {
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
    return launch<float>(q, k, v, out, qs, ks, lse, B, Tq, Tk, H, D, scale,
                         causal, s);
  }
  if (dtype == 1) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) |
                           reinterpret_cast<uintptr_t>(out);
    if (D == 64 || D == 128) {  // TMA needs 16-byte aligned bases
      if (addr % 16 != 0) return (int)cudaErrorInvalidValue;
      return D == 64 ? launch_tma<64>(q, k, v, out, qs, ks, lse, B, Tq, Tk, H,
                                      scale, causal, s)
                     : launch_tma<128>(q, k, v, out, qs, ks, lse, B, Tq, Tk,
                                       H, scale, causal, s);
    }
    if (D % 16 == 0 && addr % 16 == 0) {
      return launch_mma_any(D, q, k, v, out, qs, ks, lse, B, Tq, Tk, H, scale,
                            causal, s);
    }
    return launch<__nv_bfloat16>(q, k, v, out, qs, ks, lse, B, Tq, Tk, H, D,
                                 scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
