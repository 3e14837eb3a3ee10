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
// the unfused block: a CTA owns a tile of tokens and walks the hidden width
// in 64-column chunks, forming each chunk of a and g, applying GEGLU and
// adding the rounded chunk's product with w2 into an fp32 output
// accumulator held in registers.  The intermediate never reaches device
// memory.  The wrapper picks the variant by shape and dtype
// (ops/geglu.py::geglu_variant) and passes it in; a variant that cannot
// take the call returns an error, there is no fallback.  Three variants:
//  * "wgmma_rows" / "wgmma_cols", bf16 with F % 64 == 0 and 16-byte
//    aligned rows (every call of the flagship): the Hopper kernel.  One
//    producer warp keeps weight tiles (64 rows x 64 bf16, 8 KB) in flight
//    by TMA into a 12-stage mbarrier ring: for each chunk, the w1 rows of
//    a and of g for 32 hidden columns as one 64-row pair tile (rows f0..
//    and F + f0..), so a and g come out of one wgmma m64n64k16 in the same
//    fragment layout and GEGLU runs in registers; then the chunk's w2
//    columns, one tile per 64 output columns.  The token tile is loaded
//    once by TMA and stays resident.  Two consumer warpgroups, registers
//    raised by setmaxnreg, each keep a 64 x (up to 320) fp32 output
//    accumulator: at C <= 320 ("rows") the CTA owns 128 tokens and each
//    consumer 64 of them; at C = 384..640 ("cols") the accumulator of 128
//    tokens would not fit the register file, so the CTA owns 64 tokens,
//    each consumer forms half of every chunk and owns half of the output
//    columns.  The rounded GEGLU chunk goes to shared memory (128-byte
//    swizzled, double-buffered) and the second product reads it from
//    there.  Each CTA streams the weights once per 128 (or 64) tokens
//    through L2.  The output accumulator (160
//    registers a thread) leaves room for m64n64 products only, both
//    operands from shared memory; on the H100 the kernel reaches about 37%
//    of the tensor-core bound at both sites, and neither consumers taking
//    turns to issue nor CTA pairs sharing the weight stream by TMA
//    multicast made it faster (PERF.md, the GEGLU and mi redesign).
//  * "cuda_core" (fp32, and bf16 at the widths the Hopper kernel does not
//    take: the tiny preset's, C = 448, 576): fp32 on the CUDA cores,
//    32-column chunks and 32-wide K slices, 8 rows x C/64 output columns
//    per thread.
//
// C interface (ctypes): mmi_geglu_fwd, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// exact (erf) GELU
__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
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
      const float prod = f < F ? a * gelu_erf(g) : 0.f;
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
// bf16 Hopper kernel: wgmma, TMA, an mbarrier ring

constexpr int kWgStages = 12;          // weight tiles in flight
constexpr int kWgTile = 64 * 64 * 2;   // one tile: 64 rows x 64 bf16
constexpr int kWgThreads = 384;        // a producer and two consumers
constexpr int kWgConsumerRegs = 240;

// tokens per CTA: 128 with the output columns whole, 64 with them split
// between the consumers
__host__ __device__ constexpr int wg_rows(bool col_split) {
  return col_split ? 64 : 128;
}

size_t wg_smem_bytes(int C, bool col_split) {
  const size_t RM = wg_rows(col_split);
  return (size_t)(C / 64) * RM * 128   // the token tile, K-tiles of 64
         + 2 * RM * 128                // the GEGLU chunk, two buffers
         + (size_t)kWgStages * kWgTile // the ring
         + 8 * (2 * kWgStages + 1)     // mbarriers
         + 1024;                       // alignment
}

// x [Tn, C], w1 [2F, C], w2 [C, F] through their tensor maps (boxes of 64
// columns by RM, 32 and 64 rows); b1, b2, out as geglu_kernel.  NT is the
// number of 64-column output tiles a consumer owns: C / 64 ("rows"), C /
// 128 ("cols").  The producer streams, per 64-column chunk f0 of the
// hidden width: for each half s (32 columns) and each K tile kt, the pair
// tile [w1 rows f0 + 32 s.. | rows F + f0 + 32 s..] x [64 kt, +64); then
// for each output tile j the w2 tile [rows 64 j.., cols f0..].  Every
// consumer waits on every tile in that order and releases it (8 arrivals:
// one per consumer warp), reading only its own.
template <int NT, bool kColSplit>
__global__ void __launch_bounds__(kWgThreads, 1)
geglu_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw1,
                   const __grid_constant__ CUtensorMap tw2,
                   const __nv_bfloat16* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ b2,
                   __nv_bfloat16* __restrict__ out, int Tn, int C, int F) {
  using namespace hopper;
  constexpr int RM = wg_rows(kColSplit);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int KT = C / 64;
  unsigned char* Xs = smem;                     // [KT][RM][64]
  unsigned char* Ps = Xs + KT * RM * 128;       // [2][RM][64]
  unsigned char* ring = Ps + 2 * RM * 128;      // [kWgStages][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * kWgTile);
  uint64_t* empty = full + kWgStages;
  uint64_t* xbar = empty + kWgStages;
  const int t0 = blockIdx.x * RM;
  const int chunks = F / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(xbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(xbar, KT * RM * 128);
      for (int kt = 0; kt < KT; ++kt)
        tma_load_2d(Xs + kt * RM * 128, &tx, xbar, kt * 64, t0);
      int g = 0;  // tiles loaded so far
      auto slot = [&](int gi) {
        const int st = gi % kWgStages;
        mbar_wait(&empty[st], ((gi / kWgStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kWgTile);
        return st;
      };
      for (int ci = 0; ci < chunks; ++ci) {
        const int f0 = ci * 64;
        for (int s = 0; s < 2; ++s)
          for (int kt = 0; kt < KT; ++kt, ++g) {
            const int st = slot(g);
            unsigned char* dst = ring + st * kWgTile;
            tma_load_2d(dst, &tw1, &full[st], kt * 64, f0 + 32 * s);
            tma_load_2d(dst + 32 * 128, &tw1, &full[st], kt * 64,
                        F + f0 + 32 * s);
          }
        for (int j = 0; j < KT; ++j, ++g) {
          const int st = slot(g);
          tma_load_2d(ring + st * kWgTile, &tw2, &full[st], f0, 64 * j);
        }
      }
    }
  } else {
    setmaxnreg_inc<kWgConsumerRegs>();
    const int w = wg - 1;
    const int t = threadIdx.x - 128;
    const int warp = (t >> 5) & 3, lane = t & 31;
    const int row_off = kColSplit ? 0 : 64 * w;  // its rows in the tile
    const int tile0 = kColSplit ? NT * w : 0;    // its first output tile
    float o[NT][32];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] = 0.f;
    int g = 0;  // tiles consumed so far
    auto wait_full = [&](int gi) {
      mbar_wait(&full[gi % kWgStages], (gi / kWgStages) & 1);
    };
    auto release = [&](int gi) {
      if (lane == 0) mbar_arrive(&empty[gi % kWgStages]);
    };
    auto pass = [&](int n) {  // tiles another consumer reads
      for (int i = 0; i < n; ++i, ++g) {
        wait_full(g);
        release(g);
      }
    };
    const unsigned char* xw = Xs + row_off * 128;

    // [a | g] of half s of the chunk at f0 for the consumer's 64 rows, then
    // GEGLU and the rounded product into columns 32 s.. of P
    auto first = [&](int s, int f0, unsigned char* P) {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      auto issue = [&](int kt) {
        const unsigned char* wb = ring + (g % kWgStages) * kWgTile;
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          wgmma_ss(acc, desc_b128(xw + kt * RM * 128 + k16 * 32, 0, 1024),
                   desc_b128(wb + k16 * 32, 0, 1024), 1);
        wgmma_commit();
      };
      wait_full(g);
      issue(0);
      ++g;
      for (int kt = 1; kt < KT; ++kt, ++g) {
        wait_full(g);
        issue(kt);
        wgmma_wait<1>();
        release(g - 1);
      }
      wgmma_wait<0>();
      fence_regs<32>(acc);
      release(g - 1);
      const __nv_bfloat16* ba = b1 + f0 + 32 * s;
      const __nv_bfloat16* bg = b1 + F + f0 + 32 * s;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int j = nb * 8 + 2 * (lane & 3);
        const float ba0 = __bfloat162float(ba[j]);
        const float ba1 = __bfloat162float(ba[j + 1]);
        const float bg0 = __bfloat162float(bg[j]);
        const float bg1 = __bfloat162float(bg[j + 1]);
        const int c = 32 * s + j;  // column of P
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row_off + warp * 16 + (lane >> 2) + 8 * i;
          const float g0 = acc[(nb + 4) * 4 + 2 * i] + bg0;
          const float g1 = acc[(nb + 4) * 4 + 2 * i + 1] + bg1;
          const float p0 = (acc[nb * 4 + 2 * i] + ba0) * gelu_erf(g0);
          const float p1 = (acc[nb * 4 + 2 * i + 1] + ba1) * gelu_erf(g1);
          *reinterpret_cast<__nv_bfloat162*>(
              P + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
              __floats2bfloat162_rn(p0, p1);
        }
      }
    };

    // out[rows, tile j] += P[rows, 0..63] w2[tile j, f0..f0+63]^T
    auto second = [&](const unsigned char* P) {
      const unsigned char* pa = P + row_off * 128;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj, ++g) {
        wait_full(g);
        const unsigned char* wb = ring + (g % kWgStages) * kWgTile;
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          wgmma_ss(o[jj], desc_b128(pa + k16 * 32, 0, 1024),
                   desc_b128(wb + k16 * 32, 0, 1024), 1);
        wgmma_commit();
        if (jj > 0) {
          wgmma_wait<1>();
          release(g - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) fence_regs<32>(o[jj]);
      release(g - 1);
    };

    mbar_wait(xbar, 0);
    for (int ci = 0; ci < chunks; ++ci) {
      const int f0 = ci * 64;
      unsigned char* P = Ps + (ci & 1) * RM * 128;
      if constexpr (kColSplit) {
        // consumer w forms half w of the chunk for all 64 rows
        if (w == 1) pass(KT);
        first(w, f0, P);
        if (w == 0) pass(KT);
        fence_proxy_async();
        bar_sync(1, 256);
        if (w == 1) pass(NT);
        second(P);
        if (w == 0) pass(NT);
      } else {
        first(0, f0, P);
        first(1, f0, P);
        fence_proxy_async();
        bar_sync(1 + w, 128);
        second(P);
      }
    }

#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = (tile0 + jj) * 64 + nb * 8 + 2 * (lane & 3);
        const float bb0 = __bfloat162float(b2[col]);
        const float bb1 = __bfloat162float(b2[col + 1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = t0 + row_off + warp * 16 + (lane >> 2) + 8 * i;
          if (row < Tn)
            *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * C + col) =
                __floats2bfloat162_rn(o[jj][nb * 4 + 2 * i] + bb0,
                                      o[jj][nb * 4 + 2 * i + 1] + bb1);
        }
      }
  }
}

template <int NT, bool kColSplit>
int launch_wgmma_nt(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int Tn, int C,
                    int F, cudaStream_t stream) {
  constexpr int RM = wg_rows(kColSplit);
  CUtensorMap mx, mw1, mw2;
  int err = hopper::make_map_2d(&mx, x, Tn, C, RM);
  if (err == 0) err = hopper::make_map_2d(&mw1, w1, 2 * F, C, 32);
  if (err == 0) err = hopper::make_map_2d(&mw2, w2, C, F, 64);
  if (err != 0) return err;
  const size_t bytes = wg_smem_bytes(C, kColSplit);
  cudaError_t e = cudaFuncSetAttribute(
      geglu_wgmma_kernel<NT, kColSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  geglu_wgmma_kernel<NT, kColSplit>
      <<<(Tn + RM - 1) / RM, kWgThreads, bytes, stream>>>(
          mx, mw1, mw2, static_cast<const __nv_bfloat16*>(b1),
          static_cast<const __nv_bfloat16*>(b2),
          static_cast<__nv_bfloat16*>(out), Tn, C, F);
  return (int)cudaGetLastError();
}

// "rows": C = 64 NT, NT = 1..5; "cols": C = 128 NT, NT = 3..5
int launch_wgmma(bool col_split, const void* x, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out,
                 int Tn, int C, int F, cudaStream_t stream) {
  const int tile = col_split ? 128 : 64;
  if (C % tile != 0 || F % 64 != 0) return (int)cudaErrorInvalidValue;
#define MMI_WG(nt, cs)                                                     \
  return launch_wgmma_nt<nt, cs>(x, w1, b1, w2, b2, out, Tn, C, F, stream)
  if (!col_split) {
    switch (C / 64) {
      case 1: MMI_WG(1, false);
      case 2: MMI_WG(2, false);
      case 3: MMI_WG(3, false);
      case 4: MMI_WG(4, false);
      case 5: MMI_WG(5, false);
    }
  } else {
    switch (C / 128) {
      case 3: MMI_WG(3, true);
      case 4: MMI_WG(4, true);
      case 5: MMI_WG(5, true);
    }
  }
#undef MMI_WG
  return (int)cudaErrorInvalidValue;
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

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = cuda_core, 1 =
// wgmma_rows, 2 = wgmma_cols (ops/geglu.py::geglu_variant).  x/out
// [Tn, C], w1 [2F, C], b1 [2F], w2 [C, F], b2 [C].  Returns a cudaError_t
// code (0 = launched), or 1000 + a CUresult / 999 when a tensor map cannot
// be encoded; a variant that cannot take the call is cudaErrorInvalidValue.
extern "C" int mmi_geglu_fwd(int device, int dtype, int variant,
                             const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             int Tn, int C, int F, void* stream) {
  if (C < 1 || C > kMaxC || F < 1 || Tn < 0) return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
      reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out);
  if (dtype == 0 && variant == 0)
    return launch<float>(x, w1, b1, w2, b2, out, Tn, C, F, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, Tn, C, F, s);
    case 1:
    case 2:
      if (addr % 16 != 0) return (int)cudaErrorInvalidValue;
      return launch_wgmma(variant == 2, x, w1, b1, w2, b2, out, Tn, C, F, s);
  }
  return (int)cudaErrorInvalidValue;
}
