// Flash attention, backward, for sm_90a.
//
// Replaces the backward half of the Pallas TPU flash-attention kernel that
// mm_interleaved_tpu/ops/flash_attention.py::flash_attention wraps (its
// dkv and dq kernels, blocks at :75-87).  Split as that kernel splits it,
// so that no kernel needs atomics and the result is deterministic:
//
//  1. delta_i = sum_j P_ij dP_ij / sum_j P_ij, from a first pass of the dQ
//     kernel over the keys, with P and dP recomputed exactly as the dK/dV
//     kernel recomputes them.  Then each row of dS sums to zero in the
//     kernels' own arithmetic, whatever the LSE's rounding (P sums to 1 only
//     within a few fp32 ulps of the LSE); otherwise the mean key leaks into
//     dQ, which swamps dQ where the keys share a large common component, as
//     the ViT's and the UNet's do.  FlashAttention-2's rowsum(dO * O) misses
//     by that much even from an fp32 O, and by far more from a bf16 one.
//     The dQ kernel writes delta for the dK/dV kernel, launched after it.
//  2. a dK/dV kernel takes one CTA per (batch, head, 64-key tile) and loops
//     over the query tiles, recomputing P = exp(S * scale - LSE) from the
//     forward's log-sum-exp, then dV += P^T dO, dP = dO V^T,
//     dS = P * (dP - delta) and dK += dS^T Q * scale;
//  3. the dQ kernel takes one CTA per (batch, head, 64-query tile) and, in
//     its second pass over the key tiles, computes dQ += dS K * scale.
//
// The masks are the forward's: end-aligned causal, segment ids, keys past
// the end weigh nothing.  A masked pair gets dS = 0 explicitly (no gradient
// reaches q or k through it, as in the plain version, which fills masked
// logits with the lowest finite fp32).  A row whose keys are all masked
// averages V uniformly in the forward; its LSE is -FLT_MAX, and its P is
// 1/Tk on every key, which dV takes.
//
// Bound: operations at the UNet's 64 and 32 px shapes (about 10 * Tq * Tk
// * D flops per head against (3 Tq + 4 Tk) * D elements moved), bytes at
// the small ones.  Two variants:
//  * bf16 with D % 16 == 0 (every call of the flagship): tensor cores via
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate), four warps of 16 rows;
//    P and dS are rounded to bf16 for dV and dK, as the forward rounds P;
//    for dQ, dS goes in as a bf16 pair (hi + lo), since a rounded dS no
//    longer sums to zero along its row.  No cp.async pipelining or wgmma
//    yet.
//  * otherwise (fp32, or the tiny preset's D = 8): fp32 on the CUDA cores.
//
// C interface (ctypes): mmi_flash_attention_bwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr float kNeg = -FLT_MAX;

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

// P and dS of one (query, key) pair.  lse is the query row's log-sum-exp
// (-FLT_MAX for a fully masked row), dlt its delta.
struct Pair {
  float p, ds;
};

__device__ __forceinline__ Pair pair_grad(float s, float dp, bool real,
                                          bool masked, float lse, float dlt,
                                          float scale, float inv_tk) {
  Pair r = {0.f, 0.f};
  if (!real) return r;
  if (masked) {
    r.p = lse == kNeg ? inv_tk : 0.f;
    return r;
  }
  r.p = expf(s * scale - lse);
  r.ds = r.p * (dp - dlt);
  return r;
}

// ---------------------------------------------------------------------------
// 2./3. fp32 on the CUDA cores (any T, D <= 128 and a multiple of 8).

constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kKT = 64;        // dK/dV: keys per CTA
constexpr int kQT = 32;        // dK/dV: queries per inner tile
constexpr int kQB = 64;        // dQ: queries per CTA
constexpr int kKB = 32;        // dQ: keys per inner tile

size_t dkdv_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)kKT * (D + 4) + 4 * (size_t)kQT * D +
                          2 * (size_t)kKT * (kQT + 4) + 2 * kQT) +
         sizeof(int) * (kKT + kQT);
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)kQB * (D + 4) + 3 * (size_t)kKB * D +
                          (size_t)kQB * (kKB + 4)) +
         sizeof(int) * kKB;
}

// q/dout [B, Tq, H, D], k/v [B, Tk, H, D], lse/delta fp32 [B, H, Tq],
// qseg [B, Tq] / kseg [B, Tk] int32 or both null; dk/dv [B, Tk, H, D].
template <typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ qseg, const int* __restrict__ kseg,
            T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H,
            int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int KS = D + 4;
  const int PS = kQT + 4;
  float* Ks = smem;               // [kKT][KS]
  float* Vs = Ks + kKT * KS;      // [kKT][KS]
  float* Qt = Vs + kKT * KS;      // [D][kQT]
  float* Qs = Qt + D * kQT;       // [kQT][D]
  float* dOt = Qs + kQT * D;      // [D][kQT]
  float* dOs = dOt + D * kQT;     // [kQT][D]
  float* Ps = dOs + kQT * D;      // [kKT][PS]
  float* dSs = Ps + kKT * PS;     // [kKT][PS]
  float* Ls = dSs + kKT * PS;     // [kQT]
  float* Ds = Ls + kQT;           // [kQT]
  int* Kseg = reinterpret_cast<int*>(Ds + kQT);  // [kKT]
  int* Qseg = Kseg + kKT;                        // [kQT]

  const int n0 = blockIdx.x * kKT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // keys ty*4 .. ty*4+3
  const int tx = tid & 15;  // queries tx + 16*j, dims tx + 16*j
  const int64_t row = (int64_t)H * D;
  const T* qb = q + (int64_t)b * Tq * row + (int64_t)h * D;
  const T* gb = dout + (int64_t)b * Tq * row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Tk * row + (int64_t)h * D;
  const T* vb = v + (int64_t)b * Tk * row + (int64_t)h * D;
  const float* lb = lse + ((int64_t)b * H + h) * Tq;
  const float* db = delta + ((int64_t)b * H + h) * Tq;

  for (int i = tid; i < kKT * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    const int kj = n0 + c;
    Ks[c * KS + d] = kj < Tk ? to_f32(kb[(int64_t)kj * row + d]) : 0.f;
    Vs[c * KS + d] = kj < Tk ? to_f32(vb[(int64_t)kj * row + d]) : 0.f;
  }
  if (tid < kKT) {
    const int kj = n0 + tid;
    Kseg[tid] = (kseg != nullptr && kj < Tk) ? kseg[(int64_t)b * Tk + kj] : 0;
  }

  float dk_acc[4][kMaxD / 16], dv_acc[4][kMaxD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  const int shift = Tk - Tq;
  const float inv_tk = 1.f / (float)Tk;

  for (int m0 = 0; m0 < Tq; m0 += kQT) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kQT * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int qi = m0 + r;
      const float qv = qi < Tq ? to_f32(qb[(int64_t)qi * row + d]) : 0.f;
      const float gv = qi < Tq ? to_f32(gb[(int64_t)qi * row + d]) : 0.f;
      Qs[r * D + d] = qv;
      Qt[d * kQT + r] = qv;
      dOs[r * D + d] = gv;
      dOt[d * kQT + r] = gv;
    }
    if (tid < kQT) {
      const int qi = m0 + tid;
      Ls[tid] = qi < Tq ? lb[qi] : 0.f;
      Ds[tid] = qi < Tq ? db[qi] : 0.f;
      Qseg[tid] = (qseg != nullptr && qi < Tq) ? qseg[(int64_t)b * Tq + qi] : 0;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[2], gv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * KS + d];
        vv[i] = Vs[(ty * 4 + i) * KS + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        qv[j] = Qt[d * kQT + tx + 16 * j];
        gv[j] = dOt[d * kQT + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
      const int kj = n0 + c;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ql = tx + 16 * j;
        const int qi = m0 + ql;
        const bool real = kj < Tk && qi < Tq;
        const bool masked = (causal && kj > qi + shift) ||
                            (kseg != nullptr && Kseg[c] != Qseg[ql]);
        const Pair pr = pair_grad(s[i][j], dp[i][j], real, masked, Ls[ql],
                                  Ds[ql], scale, inv_tk);
        Ps[c * PS + ql] = pr.p;
        dSs[c * PS + ql] = pr.ds;
      }
    }
    __syncthreads();

    for (int ql = 0; ql < kQT; ++ql) {
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = Ps[(ty * 4 + i) * PS + ql];
        dd[i] = dSs[(ty * 4 + i) * PS + ql];
      }
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float go = dOs[ql * D + d];
          const float qq = Qs[ql * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pp[i], go, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dd[i], qq, dk_acc[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + (int64_t)b * Tk * row + (int64_t)h * D;
  T* dvb = dv + (int64_t)b * Tk * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = n0 + ty * 4 + i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dkb[(int64_t)kj * row + d] = from_f32<T>(dk_acc[i][j] * scale);
        dvb[(int64_t)kj * row + d] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

// Two passes over the key tiles: delta (item 1 at the top; S and dP are the
// same fmaf chains as dkdv_kernel's, so P and dP are the same values), then
// dQ.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          const int* __restrict__ qseg, const int* __restrict__ kseg,
          T* __restrict__ dq, int Tq, int Tk, int H, int D, float scale,
          int causal) {
  extern __shared__ float smem[];
  const int QS = D + 4;
  const int SS = kKB + 4;
  float* Qs = smem;              // [kQB][QS]
  float* dOs = Qs + kQB * QS;    // [kQB][QS]
  float* Kt = dOs + kQB * QS;    // [D][kKB]
  float* Vt = Kt + D * kKB;      // [D][kKB]
  float* Ks = Vt + D * kKB;      // [kKB][D]
  float* dSs = Ks + kKB * D;     // [kQB][SS]
  int* Kseg = reinterpret_cast<int*>(dSs + kQB * SS);  // [kKB]

  const int q0 = blockIdx.x * kQB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // queries ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys tx + 16*j, dims tx + 16*j
  const int64_t row = (int64_t)H * D;
  const T* qb = q + (int64_t)b * Tq * row + (int64_t)h * D;
  const T* gb = dout + (int64_t)b * Tq * row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Tk * row + (int64_t)h * D;
  const T* vb = v + (int64_t)b * Tk * row + (int64_t)h * D;

  for (int i = tid; i < kQB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qi = q0 + r;
    Qs[r * QS + d] = qi < Tq ? to_f32(qb[(int64_t)qi * row + d]) : 0.f;
    dOs[r * QS + d] = qi < Tq ? to_f32(gb[(int64_t)qi * row + d]) : 0.f;
  }
  int qrow[4], qs[4];
  float ls[4], dl[4], pd[4], ps[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qrow[i] = q0 + ty * 4 + i;
    const bool in = qrow[i] < Tq;
    const int64_t li = ((int64_t)b * H + h) * Tq + qrow[i];
    qs[i] = (qseg != nullptr && in) ? qseg[(int64_t)b * Tq + qrow[i]] : 0;
    ls[i] = in ? lse[li] : 0.f;
    dl[i] = pd[i] = ps[i] = 0.f;
  }

  float dq_acc[4][kMaxD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) dq_acc[i][j] = 0.f;
  const int shift = Tk - Tq;
  const float inv_tk = 1.f / (float)Tk;

  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = 0; n0 < Tk; n0 += kKB) {
      __syncthreads();
      for (int i = tid; i < kKB * D; i += kThreads) {
        const int c = i / D, d = i - c * D;
        const int kj = n0 + c;
        const float kv = kj < Tk ? to_f32(kb[(int64_t)kj * row + d]) : 0.f;
        const float vv = kj < Tk ? to_f32(vb[(int64_t)kj * row + d]) : 0.f;
        Kt[d * kKB + c] = kv;
        Vt[d * kKB + c] = vv;
        Ks[c * D + d] = kv;
      }
      if (tid < kKB) {
        const int kj = n0 + tid;
        Kseg[tid] = (kseg != nullptr && kj < Tk) ? kseg[(int64_t)b * Tk + kj] : 0;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], gv[4], kv[2], vv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = Qs[(ty * 4 + i) * QS + d];
          gv[i] = dOs[(ty * 4 + i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          kv[j] = Kt[d * kKB + tx + 16 * j];
          vv[j] = Vt[d * kKB + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const int kj = n0 + c;
          const bool real = kj < Tk && qrow[i] < Tq;
          const bool masked = (causal && kj > qrow[i] + shift) ||
                              (kseg != nullptr && Kseg[c] != qs[i]);
          const Pair pr = pair_grad(s[i][j], dp[i][j], real, masked, ls[i],
                                    dl[i], scale, inv_tk);
          if (pass == 1) {
            dSs[(ty * 4 + i) * SS + c] = pr.ds;
          } else if (real && !masked) {
            pd[i] = fmaf(pr.p, dp[i][j], pd[i]);
            ps[i] += pr.p;
          }
        }
      }
      if (pass == 0) continue;
      __syncthreads();

      for (int c = 0; c < kKB; ++c) {
        float dd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dd[i] = dSs[(ty * 4 + i) * SS + c];
#pragma unroll
        for (int j = 0; j < kMaxD / 16; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float kk = Ks[c * D + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(dd[i], kk, dq_acc[i][j]);
          }
        }
      }
    }
    if (pass == 1) break;
    // delta: the row sums over the 16 lanes of a row group (a half-warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        pd[i] += __shfl_xor_sync(0xffffffffu, pd[i], off);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], off);
      }
      dl[i] = ps[i] > 0.f ? pd[i] / ps[i] : 0.f;
      if (tx == 0 && qrow[i] < Tq)
        delta[((int64_t)b * H + h) * Tq + qrow[i]] = dl[i];
    }
  }

  T* dqb = dq + (int64_t)b * Tq * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qrow[i] >= Tq) continue;
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dqb[(int64_t)qrow[i] * row + d] = from_f32<T>(dq_acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 2./3. bf16 on the tensor cores (D % 16 == 0, 16-byte aligned rows).

constexpr int kMmaWarps = 4;  // 16 rows each
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMT = 64;       // rows per CTA (keys for dK/dV, queries for dQ)
constexpr int kIT = 32;       // columns per inner tile
constexpr int kPad = 8;       // bf16 elements of row padding
constexpr int VEC = 8;        // bf16 per 16-byte load

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

// The A fragment of rows r0 and r0 + 8 of a row-major tile, k-step ks.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* t,
                                       int stride, int r0, int ks, int tig) {
  const int c = ks * 16 + tig * 2;
  a[0] = ld32(t + r0 * stride + c);
  a[1] = ld32(t + (r0 + 8) * stride + c);
  a[2] = ld32(t + r0 * stride + c + 8);
  a[3] = ld32(t + (r0 + 8) * stride + c + 8);
}

// The accumulator tiles x[2kk], x[2kk+1] (16 x 16) as a bf16 A fragment.
__device__ __forceinline__ void pack_a(uint32_t* a, const float (*x)[4],
                                       int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The same as a pair of fragments: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void pack_a_split(uint32_t* hi, uint32_t* lo,
                                             const float (*x)[4], int kk) {
  float r[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[t][e] = x[2 * kk + t][e] - bf16_round(x[2 * kk + t][e]);
  pack_a(hi, x, kk);
  lo[0] = pack_bf16(r[0][0], r[0][1]);
  lo[1] = pack_bf16(r[0][2], r[0][3]);
  lo[2] = pack_bf16(r[1][0], r[1][1]);
  lo[3] = pack_bf16(r[1][2], r[1][3]);
}

// Copy rows [r0, r0 + n) of a [T, H, D] head slice into a row-major tile
// (stride D + kPad) and, if t_out is not null, its transpose (stride
// n + kPad); rows past T are zero.
template <int D>
__device__ __forceinline__ void stage(const __nv_bfloat16* src, int64_t row,
                                      int r0, int n, int T,
                                      __nv_bfloat16* tile,
                                      __nv_bfloat16* t_out, int tid) {
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < n * D / VEC; i += kMmaThreads) {
    const int r = i / (D / VEC), c = (i - r * (D / VEC)) * VEC;
    const int ri = r0 + r;
    const uint4 x = ri < T ? *reinterpret_cast<const uint4*>(
                                 src + (int64_t)ri * row + c)
                           : zero4;
    *reinterpret_cast<uint4*>(tile + r * (D + kPad) + c) = x;
    if (t_out != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) t_out[(c + j) * (n + kPad) + r] = e[j];
    }
  }
}

template <int D>
size_t mma_dkdv_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (2 * (size_t)kMT * (D + kPad) + 2 * (size_t)kIT * (D + kPad) +
              2 * (size_t)D * (kIT + kPad)) +
         sizeof(float) * 2 * kIT + sizeof(int) * (kMT + kIT);
}

template <int D>
size_t mma_dq_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (2 * (size_t)kMT * (D + kPad) + 2 * (size_t)kIT * (D + kPad) +
              (size_t)D * (kIT + kPad)) +
         sizeof(int) * kIT;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ qseg,
                const int* __restrict__ kseg, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int Tq, int Tk, int H,
                float scale, int causal) {
  constexpr int RS = D + kPad;    // row stride of the row-major tiles
  constexpr int TS = kIT + kPad;  // row stride of the transposed tiles
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;
  constexpr int NB_I = kIT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kMT * RS;
  __nv_bfloat16* Qs = Vs + kMT * RS;  // [kIT][RS]
  __nv_bfloat16* dOs = Qs + kIT * RS;
  __nv_bfloat16* Qt = dOs + kIT * RS;  // [D][TS]
  __nv_bfloat16* dOt = Qt + D * TS;
  float* Ls = reinterpret_cast<float*>(dOt + D * TS);
  float* Ds = Ls + kIT;
  int* Kseg = reinterpret_cast<int*>(Ds + kIT);  // [kMT]
  int* Qseg = Kseg + kMT;                        // [kIT]

  const int n0 = blockIdx.x * kMT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int64_t row = (int64_t)H * D;
  const __nv_bfloat16* qb = q + (int64_t)b * Tq * row + (int64_t)h * D;
  const __nv_bfloat16* gb = dout + (int64_t)b * Tq * row + (int64_t)h * D;
  const float* lb = lse + ((int64_t)b * H + h) * Tq;
  const float* db = delta + ((int64_t)b * H + h) * Tq;

  stage<D>(k + (int64_t)b * Tk * row + (int64_t)h * D, row, n0, kMT, Tk, Ks,
           nullptr, tid);
  stage<D>(v + (int64_t)b * Tk * row + (int64_t)h * D, row, n0, kMT, Tk, Vs,
           nullptr, tid);
  if (tid < kMT) {
    const int kj = n0 + tid;
    Kseg[tid] = (kseg != nullptr && kj < Tk) ? kseg[(int64_t)b * Tk + kj] : 0;
  }
  const int r0 = warp * 16 + g;  // this thread's keys r0 and r0 + 8
  float dka[NB_D][4], dva[NB_D][4];
#pragma unroll
  for (int j = 0; j < NB_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int shift = Tk - Tq;
  const float inv_tk = 1.f / (float)Tk;

  for (int m0 = 0; m0 < Tq; m0 += kIT) {
    __syncthreads();
    stage<D>(qb, row, m0, kIT, Tq, Qs, Qt, tid);
    stage<D>(gb, row, m0, kIT, Tq, dOs, dOt, tid);
    if (tid < kIT) {
      const int qi = m0 + tid;
      Ls[tid] = qi < Tq ? lb[qi] : 0.f;
      Ds[tid] = qi < Tq ? db[qi] : 0.f;
      Qseg[tid] = (qseg != nullptr && qi < Tq) ? qseg[(int64_t)b * Tq + qi] : 0;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys
    float sT[NB_I][4], pT[NB_I][4];
#pragma unroll
    for (int nb = 0; nb < NB_I; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[nb][e] = pT[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t ak[4], av[4];
      load_a(ak, Ks, RS, r0, ks, tig);
      load_a(av, Vs, RS, r0, ks, tig);
#pragma unroll
      for (int nb = 0; nb < NB_I; ++nb) {
        const __nv_bfloat16* qr = Qs + (nb * 8 + g) * RS + ks * 16 + tig * 2;
        const __nv_bfloat16* gr = dOs + (nb * 8 + g) * RS + ks * 16 + tig * 2;
        mma_bf16(sT[nb], ak, ld32(qr), ld32(qr + 8));
        mma_bf16(pT[nb], av, ld32(gr), ld32(gr + 8));
      }
    }
    // P^T into sT, dS^T into pT
#pragma unroll
    for (int nb = 0; nb < NB_I; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = r0 + 8 * (e >> 1);
        const int kj = n0 + c;
        const int ql = nb * 8 + tig * 2 + (e & 1);
        const int qi = m0 + ql;
        const bool real = kj < Tk && qi < Tq;
        const bool masked = (causal && kj > qi + shift) ||
                            (kseg != nullptr && Kseg[c] != Qseg[ql]);
        const Pair pr = pair_grad(sT[nb][e], pT[nb][e], real, masked, Ls[ql],
                                  Ds[ql], scale, inv_tk);
        sT[nb][e] = pr.p;
        pT[nb][e] = pr.ds;
      }
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kIT / 16; ++kk) {
      uint32_t ap[4], ad[4];
      pack_a(ap, sT, kk);
      pack_a(ad, pT, kk);
#pragma unroll
      for (int j = 0; j < NB_D; ++j) {
        const __nv_bfloat16* gr = dOt + (j * 8 + g) * TS + kk * 16 + tig * 2;
        const __nv_bfloat16* qr = Qt + (j * 8 + g) * TS + kk * 16 + tig * 2;
        mma_bf16(dva[j], ap, ld32(gr), ld32(gr + 8));
        mma_bf16(dka[j], ad, ld32(qr), ld32(qr + 8));
      }
    }
  }

  __nv_bfloat16* dkb = dk + (int64_t)b * Tk * row + (int64_t)h * D;
  __nv_bfloat16* dvb = dv + (int64_t)b * Tk * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = n0 + r0 + 8 * i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int j = 0; j < NB_D; ++j) {
      const int64_t o = (int64_t)kj * row + j * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(dkb + o) = __floats2bfloat162_rn(
          dka[j][2 * i] * scale, dka[j][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + o) =
          __floats2bfloat162_rn(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

// Two passes over the key tiles, as dq_kernel's: delta, then dQ.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              const int* __restrict__ qseg, const int* __restrict__ kseg,
              __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H,
              float scale, int causal) {
  constexpr int RS = D + kPad;
  constexpr int TS = kIT + kPad;
  constexpr int KSTEPS = D / 16;
  constexpr int NB_D = D / 8;
  constexpr int NB_I = kIT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMT][RS]
  __nv_bfloat16* dOs = Qs + kMT * RS;
  __nv_bfloat16* Ks = dOs + kMT * RS;  // [kIT][RS]
  __nv_bfloat16* Vs = Ks + kIT * RS;
  __nv_bfloat16* Kt = Vs + kIT * RS;  // [D][TS]
  int* Kseg = reinterpret_cast<int*>(Kt + D * TS);  // [kIT]

  const int q0 = blockIdx.x * kMT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int64_t row = (int64_t)H * D;
  const __nv_bfloat16* kb = k + (int64_t)b * Tk * row + (int64_t)h * D;
  const __nv_bfloat16* vb = v + (int64_t)b * Tk * row + (int64_t)h * D;

  stage<D>(q + (int64_t)b * Tq * row + (int64_t)h * D, row, q0, kMT, Tq, Qs,
           nullptr, tid);
  stage<D>(dout + (int64_t)b * Tq * row + (int64_t)h * D, row, q0, kMT, Tq,
           dOs, nullptr, tid);
  const int r0 = warp * 16 + g;  // this thread's queries r0 and r0 + 8
  int qrow[2], qs[2];
  float ls[2], dl[2], pd[2], ps[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = q0 + r0 + 8 * i;
    const bool in = qrow[i] < Tq;
    const int64_t li = ((int64_t)b * H + h) * Tq + qrow[i];
    qs[i] = (qseg != nullptr && in) ? qseg[(int64_t)b * Tq + qrow[i]] : 0;
    ls[i] = in ? lse[li] : 0.f;
    dl[i] = pd[i] = ps[i] = 0.f;
  }
  float dqa[NB_D][4];
#pragma unroll
  for (int j = 0; j < NB_D; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  const int shift = Tk - Tq;
  const float inv_tk = 1.f / (float)Tk;

  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = 0; n0 < Tk; n0 += kIT) {
      __syncthreads();
      stage<D>(kb, row, n0, kIT, Tk, Ks, pass == 1 ? Kt : nullptr, tid);
      stage<D>(vb, row, n0, kIT, Tk, Vs, nullptr, tid);
      if (tid < kIT) {
        const int kj = n0 + tid;
        Kseg[tid] = (kseg != nullptr && kj < Tk) ? kseg[(int64_t)b * Tk + kj] : 0;
      }
      __syncthreads();

      float s[NB_I][4], dp[NB_I][4];
#pragma unroll
      for (int nb = 0; nb < NB_I; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t aq[4], ag[4];
        load_a(aq, Qs, RS, r0, ks, tig);
        load_a(ag, dOs, RS, r0, ks, tig);
#pragma unroll
        for (int nb = 0; nb < NB_I; ++nb) {
          const __nv_bfloat16* kr = Ks + (nb * 8 + g) * RS + ks * 16 + tig * 2;
          const __nv_bfloat16* vr = Vs + (nb * 8 + g) * RS + ks * 16 + tig * 2;
          mma_bf16(s[nb], aq, ld32(kr), ld32(kr + 8));
          mma_bf16(dp[nb], ag, ld32(vr), ld32(vr + 8));
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB_I; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = nb * 8 + tig * 2 + (e & 1);
          const int kj = n0 + c;
          const bool real = kj < Tk && qrow[i] < Tq;
          const bool masked = (causal && kj > qrow[i] + shift) ||
                              (kseg != nullptr && Kseg[c] != qs[i]);
          const Pair pr = pair_grad(s[nb][e], dp[nb][e], real, masked, ls[i],
                                    dl[i], scale, inv_tk);
          if (pass == 0 && real && !masked) {
            pd[i] = fmaf(pr.p, dp[nb][e], pd[i]);
            ps[i] += pr.p;
          }
          dp[nb][e] = pr.ds;
        }
      }
      if (pass == 0) continue;
#pragma unroll
      for (int kk = 0; kk < kIT / 16; ++kk) {
        uint32_t hi[4], lo[4];
        pack_a_split(hi, lo, dp, kk);
#pragma unroll
        for (int j = 0; j < NB_D; ++j) {
          const __nv_bfloat16* kr = Kt + (j * 8 + g) * TS + kk * 16 + tig * 2;
          const uint32_t b0 = ld32(kr), b1 = ld32(kr + 8);
          mma_bf16(dqa[j], hi, b0, b1);
          mma_bf16(dqa[j], lo, b0, b1);
        }
      }
    }
    if (pass == 1) break;
    // delta: the row sums over the quad of lanes that holds a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        pd[i] += __shfl_xor_sync(0xffffffffu, pd[i], off);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], off);
      }
      dl[i] = ps[i] > 0.f ? pd[i] / ps[i] : 0.f;
      if (tig == 0 && qrow[i] < Tq)
        delta[((int64_t)b * H + h) * Tq + qrow[i]] = dl[i];
    }
  }

  __nv_bfloat16* dqb = dq + (int64_t)b * Tq * row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= Tq) continue;
#pragma unroll
    for (int j = 0; j < NB_D; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)qrow[i] * row + j * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(dqa[j][2 * i] * scale, dqa[j][2 * i + 1] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const void* dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int *qseg, *kseg;
  int B, Tq, Tk, H, D;
  float scale;
  int causal;
};

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  typedef __nv_bfloat16 bf;
  const size_t b1 = mma_dkdv_smem_bytes<D>(), b2 = mma_dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return (int)err;
  // dQ first: it writes the delta that the dK/dV kernel reads
  dq_mma_kernel<D><<<dim3((a.Tq + kMT - 1) / kMT, a.H, a.B), kMmaThreads, b2,
                     stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, static_cast<bf*>(a.dq), a.Tq, a.Tk, a.H,
      a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_mma_kernel<D><<<dim3((a.Tk + kMT - 1) / kMT, a.H, a.B), kMmaThreads, b1,
                       stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
      a.Tq, a.Tk, a.H, a.scale, a.causal);
  return (int)cudaGetLastError();
}

int launch_mma_any(const Args& a, cudaStream_t stream) {
  switch (a.D) {
#define MMI_CASE(d) \
  case d:           \
    return launch_mma<d>(a, stream);
    MMI_CASE(16) MMI_CASE(32) MMI_CASE(48) MMI_CASE(64) MMI_CASE(80)
    MMI_CASE(96) MMI_CASE(112) MMI_CASE(128)
#undef MMI_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_cores(const Args& a, cudaStream_t stream) {
  const size_t b1 = dkdv_smem_bytes(a.D), b2 = dq_smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return (int)err;
  // dQ first: it writes the delta that the dK/dV kernel reads
  dq_kernel<T><<<dim3((a.Tq + kQB - 1) / kQB, a.H, a.B), kThreads, b2,
                 stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, static_cast<T*>(a.dq), a.Tq, a.Tk, a.H, a.D,
      a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T><<<dim3((a.Tk + kKT - 1) / kKT, a.H, a.B), kThreads, b1,
                   stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.Tq, a.Tk, a.H, a.D, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout, dq [B, Tq, H, D]; k, v, dk,
// dv [B, Tk, H, D]; lse fp32 [B, H, Tq] from the forward; delta fp32
// [B, H, Tq] scratch; qseg/kseg int32 segment ids or both null.  Launches
// the dQ kernel, which writes delta, and then the dK/dV kernel on
// ``stream``.  Returns a cudaError_t code (0 = launched).
extern "C" int mmi_flash_attention_bwd(
    int device, int dtype, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, const void* qseg, const void* kseg, int B,
    int Tq, int Tk, int H, int D, float scale, int causal, void* stream) {
  if (D < 1 || D > kMaxD || D % 8 != 0 || Tk < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0 || H == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {q, k, v, dout, lse, delta, dq, dk, dv,
                  static_cast<const int*>(qseg), static_cast<const int*>(kseg),
                  B, Tq, Tk, H, D, scale, causal};
  if (dtype == 0) return launch_cores<float>(a, s);
  if (dtype == 1) {
    const uintptr_t addr =
        reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
        reinterpret_cast<uintptr_t>(dv);
    if (D % 16 == 0 && addr % 16 == 0) return launch_mma_any(a, s);
    return launch_cores<__nv_bfloat16>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
