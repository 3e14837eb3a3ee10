// Int8 weight-only linear layer, for sm_90a.
//
// Replaces no Pallas kernel: it stands for the XLA fusion of
// mm_interleaved_tpu/ops/quant.py::QDense (:85-97), where XLA folds the
// int8 -> dtype convert and the per-channel scale into the dot's operand
// read.  Computes, for x [M, K] (fp32 or bf16), int8 codes q [N, K] and an
// fp32 scale s [N]:
//   w[n, k] = T(float(q[n, k]) * float(T(s[n])))   (T = x's dtype; as JAX's
//             dequantize_int8: q.astype(T) * s.astype(T))
//   y[m, n] = T(sum_k float(x[m, k]) * float(w[n, k]))   (fp32 accumulation)
//   y[m, n] = T(float(y[m, n]) + float(bias[n]))         (when a bias is given)
// The dequantized weight is rounded exactly as the plain version rounds it,
// so the two differ only in the order of the fp32 sums.  The codes are read
// once from device memory and no dequantized copy of the weight is ever
// written: each tile of codes is converted in registers.
//
// Bound: bytes at decode (M <= 16: the N K bytes of codes dominate, about
// 3.8 ms a token for the 13B LLM's 12.85 GB at 3.35 TB/s), operations at
// the prefill (2 M N K).  Three bodies, chosen by the wrapper
// (ops/quant.py::int8_linear_body) and passed in; a body that cannot take
// the call returns an error, there is no fallback:
//  * "gemv" (M <= 16, either dtype): 8 warps a CTA, each warp two output
//    columns n.  The CTA walks K in chunks of 512 with x[:, chunk] in
//    shared memory as fp32 (laid out so that lane l reads elements l, l+32,
//    ... without bank conflicts), two chunks' buffers: the next chunk's x
//    and codes are loaded into registers before the current chunk is
//    multiplied, and x is written to the other buffer after it, one
//    barrier a chunk.  Each lane reads 16 bytes of codes of each of its
//    columns, coalesced along K (a warp reads 512 contiguous bytes a
//    column), and accumulates its 16 products for every row m, each x
//    element read from shared memory once for both columns.  Instances for
//    M <= 4, 8 and 16 keep 2 x that many accumulators in registers (and
//    2 x 8, 16 or 32 KB of x in shared memory).  The lanes' partial sums
//    meet in a xor-butterfly of shuffles: a fixed order, no atomics, so two
//    runs give the same bits.
//  * "mma" (bf16, M > 16): 64 x 64 output tiles, 4 warps of 32 x 32, K in
//    slices of 32.  x's slice goes to shared memory as it is; the codes'
//    slice is dequantized on the way in (16 codes a thread, its row's
//    scale) and stored as bf16; mma.sync m16n8k16 bf16 with fp32
//    accumulators.  The next slice's loads are issued before the current
//    one is multiplied.
//  * "simt" (fp32, M > 16): 64 x 64 output tiles, 256 threads of 4 x 4
//    outputs, K in slices of 16, fp32 FMAs on the CUDA cores (the plain
//    version's fp32 product runs in full fp32 too).
// With K % 16 == 0 ("vec", every LLM projection) the codes and x move in
// 16-byte vectors and x, the codes and the output must sit on 16-byte
// boundaries; otherwise every load is a guarded scalar.
//
// C interface (ctypes): mmi_int8_linear, see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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
  return __float2bfloat16_rn(x);
}

// the scale as the weight's dtype rounds it
template <typename T>
__device__ __forceinline__ float rounded_scale(float s) {
  return to_f32(from_f32<T>(s));
}

// one dequantized weight element, rounded to T, back in fp32
template <typename T>
__device__ __forceinline__ float dequant(int8_t q, float s) {
  return to_f32(from_f32<T>(static_cast<float>(q) * s));
}

// y = T(acc), then T(y + bias)
template <typename T>
__device__ __forceinline__ T finish(float acc, const T* bias, int n) {
  T y = from_f32<T>(acc);
  if (bias != nullptr) y = from_f32<T>(to_f32(y) + to_f32(bias[n]));
  return y;
}

// 16 consecutive elements of x's row (zero past K) as fp32
template <typename T, bool VEC>
__device__ __forceinline__ void load16(const T* row, long k, int K,
                                       float* v) {
  if (VEC) {
    // K % 16 == 0 and k < K: the 16 elements are whole and 16-byte aligned
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < 16 / kPer; ++c) {
      uint4 raw = *reinterpret_cast<const uint4*>(row + k + c * kPer);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[c * kPer + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = (k + i < K) ? to_f32(row[k + i]) : 0.f;
  }
}

// 16 consecutive codes of a weight row (zero past K)
template <bool VEC>
__device__ __forceinline__ void codes16(const int8_t* row, long k, int K,
                                        int8_t* c) {
  if (VEC) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + k);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = e[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = (k + i < K) ? row[k + i] : 0;
  }
}

// ------------------------------------------------------------------ gemv

constexpr int kGemvWarps = 8;
constexpr int kGemvRows = 2;     // output columns per warp
constexpr int kMaxM = 16;
constexpr int kChunk = 512;      // K per chunk: 32 lanes x 16

// the codes of one output column's 16 elements at k (zero past K or for a
// column past N)
template <bool VEC>
__device__ __forceinline__ uint4 gemv_codes(const int8_t* q, int n, int N,
                                            long k, int K) {
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (n < N && k < K) codes16<VEC>(q + (long)n * K, k, K,
                                   reinterpret_cast<int8_t*>(&raw));
  return raw;
}

// byte i of 16 codes held in a register quad (i is a constant once the
// loops are unrolled: the selection folds to one shift)
__device__ __forceinline__ int8_t code_byte(const uint4& v, int i) {
  const unsigned w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return static_cast<int8_t>((w >> (8 * (i & 3))) & 0xffu);
}

// bf16 element e of 8 held in a register quad (e is a constant once the
// loops are unrolled)
__device__ __forceinline__ float packed_bf16(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __uint_as_float((e & 1 ? w >> 16 : w & 0xffffu) << 16);
}

// the staging of x: thread t holds its tasks' 16 elements of the chunk at
// k0 (task j: row (t + j * blockDim) / 32, lanes' slice (t + ...) % 32) in
// registers, then writes them to the chunk's shared buffer as fp32; bf16
// rows with vector loads stay packed until the write (8 registers a task,
// not 16)
template <typename T, bool VEC, int MT>
struct XStage {
  static constexpr int kTasks = (MT * 32 + kGemvWarps * 32 - 1) /
                                (kGemvWarps * 32);
  static constexpr bool kPacked = VEC && sizeof(T) == 2;
  static constexpr int kWords = kPacked ? 2 : 16;  // uint4 or float each
  typename std::conditional<kPacked, uint4, float>::type v[kTasks][kWords];

  __device__ __forceinline__ void load(const T* x, int M, long k0, int K) {
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      const int t = threadIdx.x + j * kGemvWarps * 32;
      const int m = t >> 5;
      const long k = k0 + (t & 31) * 16;
      const bool live = m < M && k < K;
      if constexpr (kPacked) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (long)m * K + k);
        v[j][0] = live ? src[0] : make_uint4(0, 0, 0, 0);
        v[j][1] = live ? src[1] : make_uint4(0, 0, 0, 0);
      } else if (live) {
        load16<T, VEC>(x + (long)m * K, k, K, v[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[j][i] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* xs, int M) const {
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      const int t = threadIdx.x + j * kGemvWarps * 32;
      const int m = t >> 5, l = t & 31;
      if (m < M) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float e;
          if constexpr (kPacked) {
            e = packed_bf16(v[j][i / 8], i % 8);
          } else {
            e = v[j][i];
          }
          xs[(m * 16 + i) * 32 + l] = e;
        }
      }
    }
  }
};

// MT: the most rows of x the instance takes (M <= MT); the accumulators
// of kGemvRows columns x MT rows stay in registers
template <typename T, bool VEC, int MT>
__global__ void __launch_bounds__(kGemvWarps * 32)
    gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, const T* __restrict__ bias,
                T* __restrict__ out, int M, int N, int K) {
  // two chunks of x (dynamic shared memory, 2 * MT * kChunk floats):
  // xs[b * MT * kChunk + (m * 16 + i) * 32 + l] = x[m, k0 + l * 16 + i]
  extern __shared__ float xs[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * kGemvWarps + warp) * kGemvRows;
  float s[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
    s[r] = (n0 + r < N) ? rounded_scale<T>(scale[n0 + r]) : 0.f;
  float acc[kGemvRows][MT];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  // this lane's codes of the current chunk
  uint4 codes[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
    codes[r] = gemv_codes<VEC>(q, n0 + r, N, lane * 16, K);
  XStage<T, VEC, MT> stage;
  stage.load(x, M, 0, K);
  stage.store(xs, M);
  __syncthreads();
  int b = 0;
  for (long k0 = 0; k0 < K; k0 += kChunk, b ^= 1) {
    // the next chunk's codes and x are loaded before the current chunk is
    // multiplied, and x lands in the other buffer after it
    const bool more = k0 + kChunk < K;
    uint4 next[kGemvRows];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r)
      next[r] = gemv_codes<VEC>(q, n0 + r, N, k0 + kChunk + lane * 16, K);
    if (more) stage.load(x, M, k0 + kChunk, K);
    // element i of every column, then every row m: each x element read
    // from shared memory once for the warp's kGemvRows columns
    const float* xb = xs + b * MT * kChunk;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float w[kGemvRows];
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r)
        w[r] = dequant<T>(code_byte(codes[r], i), s[r]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float xv = xb[(m * 16 + i) * 32 + lane];
#pragma unroll
          for (int r = 0; r < kGemvRows; ++r)
            acc[r][m] = fmaf(w[r], xv, acc[r][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) codes[r] = next[r];
    if (more) stage.store(xs + (b ^ 1) * MT * kChunk, M);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) {
    const int n = n0 + r;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float a = acc[r][m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0 && n < N) out[(long)m * N + n] = finish<T>(a, bias, n);
      }
    }
  }
}

// ------------------------------------------------------------------- mma

constexpr int kTile = 64;        // output rows and columns of a CTA
constexpr int kSliceK = 32;      // K per slice
constexpr int kPad = 40;         // smem row stride in bf16 (80 bytes)
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the registers a thread carries from device memory to shared memory for
// one K slice: two 8-element pieces of x, 16 codes of one weight row
struct MmaStage {
  uint4 a[2];
  int8_t c[16];
};

template <bool VEC>
__device__ __forceinline__ void mma_load(MmaStage& st,
                                         const __nv_bfloat16* x,
                                         const int8_t* q, int M, int N,
                                         int K, int m0, int n0, long k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int piece = t + j * kMmaThreads;  // 256 pieces of 8 elements
    const int row = piece >> 2, col = (piece & 3) * 8;
    const long k = k0 + col;
    if (m0 + row < M && VEC && k < K) {
      st.a[j] = *reinterpret_cast<const uint4*>(x + (long)(m0 + row) * K + k);
      continue;
    }
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&st.a[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = (m0 + row < M && k + i < K) ? x[(long)(m0 + row) * K + k + i]
                                         : __float2bfloat16_rn(0.f);
  }
  const int n = t >> 1;
  const long k = k0 + (t & 1) * 16;
  if (n0 + n < N && k < K) {
    codes16<VEC>(q + (long)(n0 + n) * K, k, K, st.c);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) st.c[i] = 0;
  }
}

__device__ __forceinline__ void mma_store(const MmaStage& st,
                                          __nv_bfloat16* As,
                                          __nv_bfloat16* Bs, float s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int piece = t + j * kMmaThreads;
    const int row = piece >> 2, col = (piece & 3) * 8;
    *reinterpret_cast<uint4*>(As + row * kPad + col) = st.a[j];
  }
  uint4 packed[2];
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(packed);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = __float2bfloat16_rn(static_cast<float>(st.c[i]) * s);
  const int n = t >> 1, col = (t & 1) * 16;
  uint4* dst = reinterpret_cast<uint4*>(Bs + n * kPad + col);
  dst[0] = packed[0];
  dst[1] = packed[1];
}

template <bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
    mma_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ q, const float* __restrict__ scale,
               const __nv_bfloat16* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[kTile * kPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[kTile * kPad];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tq = lane & 3;
  // the scale of the weight row this thread stages
  const int sn = n0 + (threadIdx.x >> 1);
  const float s = sn < N ? rounded_scale<__nv_bfloat16>(scale[sn]) : 0.f;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  MmaStage st;
  mma_load<VEC>(st, x, q, M, N, K, m0, n0, 0);
  for (long k0 = 0; k0 < K; k0 += kSliceK) {
    __syncthreads();
    mma_store(st, As, Bs, s);
    __syncthreads();
    if (k0 + kSliceK < K) mma_load<VEC>(st, x, q, M, N, K, m0, n0,
                                        k0 + kSliceK);
#pragma unroll
    for (int kk = 0; kk < kSliceK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* base = As + (wm + i * 16 + g) * kPad + kk + tq * 2;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kPad);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kPad + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* base = Bs + (wn + j * 8 + g) * kPad + kk + tq * 2;
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + tq * 2 + (e & 1);
        if (m < M && n < N)
          out[(long)m * N + n] = finish<__nv_bfloat16>(acc[i][j][e], bias, n);
      }
}

// ------------------------------------------------------------------ simt

constexpr int kSimtK = 16;
constexpr int kSimtPad = kTile + 4;
constexpr int kSimtThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kSimtThreads)
    simt_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K) {
  __shared__ __align__(16) float As[kSimtK * kSimtPad];  // [k][m]
  __shared__ __align__(16) float Bs[kSimtK * kSimtPad];  // [k][n]
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int bn = t;  // threads 0..63 stage one weight row each
  const float s = (bn < kTile && n0 + bn < N) ? scale[n0 + bn] : 0.f;

  for (long k0 = 0; k0 < K; k0 += kSimtK) {
    __syncthreads();
    {
      const int row = t >> 2, k4 = (t & 3) * 4;
      const long k = k0 + k4;
      float v[4];
      if (VEC && m0 + row < M && k < K) {
        float4 raw = *reinterpret_cast<const float4*>(x + (long)(m0 + row) * K + k);
        v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = (m0 + row < M && k + i < K) ? x[(long)(m0 + row) * K + k + i]
                                             : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) As[(k4 + i) * kSimtPad + row] = v[i];
    }
    if (bn < kTile) {
      int8_t c[16];
      if (n0 + bn < N) {
        codes16<VEC>(q + (long)(n0 + bn) * K, k0, K, c);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) c[i] = 0;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        Bs[i * kSimtPad + bn] = static_cast<float>(c[i]) * s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSimtK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * kSimtPad + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * kSimtPad + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) out[(long)m * N + n] = finish<float>(acc[i][j], bias, n);
    }
}

template <typename T, int MT>
int launch_gemv(bool vec, const void* x, const int8_t* q, const float* s,
                const void* bias, void* out, int M, int N, int K,
                cudaStream_t stream) {
  const int per_cta = kGemvWarps * kGemvRows;
  dim3 grid((N + per_cta - 1) / per_cta);
  auto kernel = vec ? gemv_kernel<T, true, MT> : gemv_kernel<T, false, MT>;
  const int smem = 2 * MT * kChunk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kGemvWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), q, s, static_cast<const T*>(bias),
      static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gemv(bool vec, const void* x, const int8_t* q, const float* s,
                const void* bias, void* out, int M, int N, int K,
                cudaStream_t stream) {
  if (M <= 4)
    return launch_gemv<T, 4>(vec, x, q, s, bias, out, M, N, K, stream);
  if (M <= 8)
    return launch_gemv<T, 8>(vec, x, q, s, bias, out, M, N, K, stream);
  return launch_gemv<T, kMaxM>(vec, x, q, s, bias, out, M, N, K, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  body: 0 gemv (M <= 16), 1 mma (bf16), 2 simt
// (fp32).  vec: K % 16 == 0, with x, q and out on 16-byte boundaries.
// bias may be null.  Returns a cudaError_t (0 on success).
extern "C" int mmi_int8_linear(int device, int dtype, int body, int vec,
                               const void* x, const void* q,
                               const void* scale, const void* bias,
                               void* out, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (vec) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(out);
    if (K % 16 != 0 || addr % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* codes = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (body == 0) {
    if (M > kMaxM) return (int)cudaErrorInvalidValue;
    return dtype == 1 ? launch_gemv<__nv_bfloat16>(vec, x, codes, sc, bias,
                                                   out, M, N, K, s)
                      : launch_gemv<float>(vec, x, codes, sc, bias, out, M,
                                           N, K, s);
  }
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  if (body == 1 && dtype == 1) {
    auto kernel = vec ? mma_kernel<true> : mma_kernel<false>;
    kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), codes, sc,
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  if (body == 2 && dtype == 0) {
    auto kernel = vec ? simt_kernel<true> : simt_kernel<false>;
    kernel<<<grid, kSimtThreads, 0, s>>>(
        static_cast<const float*>(x), codes, sc,
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
