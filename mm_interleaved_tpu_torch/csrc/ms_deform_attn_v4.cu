// Multi-scale deformable attention, forward, v4's function and numerics,
// for sm_90a: a per-query gather that forms only the non-zero entries of the
// bilinear matrix.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py::_kernel_v4.
// Per (n, h) and level l the output is A_l @ V_l, where
//   A_l[q, y*w + x] = sum_p hat(x - xs_p[q]) * (hat(y - ys_p[q]) * aw_p[q]),
// hat(t) = max(1 - |t|, 0), xs = loc_x * w - 0.5 (v4_coord); A is rounded
// to the value's type after the sum over the points, and the products of
// all levels accumulate in fp32.  The TPU kernel builds A densely because
// a TPU has no fast gather.  A sample's hats are non-zero on at most its
// 2 x 2 corner texels, floor(xs) and floor(xs) + 1 in each axis, so a row
// of A has at most 4P non-zero entries of the level's h*w.
//
// Bound: gathered bytes.  Per sample the kernel reads at most 4 value rows
// and does 4 FMAs an element, far below the card's ridge point.  Design:
// a warp owns one (n, q, h) at a time; a CTA's 8 warps take 32
// neighbouring queries of one (n, h), whose corners share L1 and L2.  Per
// level the warp
//  1. enumerates the query's 4P corners, corner i = 4p + c of point p,
//     c in row-major order (x0,y0), (x1,y0), (x0,y1), (x1,y1): its texel
//     (or none, outside the grid) and hat(x - xs) * (hat(y - ys) * aw),
//     each product rounded as the dense build rounds it;
//  2. merges the corners by texel (__match_any_sync within a round of 32
//     corners, a scan of the staged keys across rounds where 4P > 32): the
//     first corner of a texel leads and sums the texel's terms in corner
//     order, which is the order of the points, rounds the sum to the
//     value's type and appends (texel, A) to the warp's list; the rest are
//     dropped.  Entries that round to 0 are dropped too;
//  3. gathers: a group of G lanes takes one listed texel, each lane 16
//     bytes of its row (single elements where the row is not whole 16-byte
//     vectors on a 16-byte boundary), four rows a group in flight before
//     any FMA, accumulating A * V in fp32.
// At the end the groups' sums fold by a fixed butterfly and group 0 writes
// the row in the value's dtype.  No hat is evaluated and no product formed
// at a texel none of the query's samples touch.  No float atomics; every
// sum in an order fixed by the data, so the output is the same bits every
// run.
//
// C interface (ctypes): mmi_ms_deform_attn_v4_fwd, see the end of the file.

#include "ms_deform_attn_v4.cuh"

namespace {

using deform::RowChunk;

constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 32;   // queries a CTA takes
constexpr int kInFlight = 4; // rows a group loads before its FMAs

// value [N, S, H, D], loc [N, Q, H, L, P, 2], weight [N, Q, H, L, P],
// out [N, Q, H, D] in V.  Grid N * H * q_tiles, blockIdx.x = (n * H + h) *
// q_tiles + tile.  Dynamic shared memory: kWarps * 4 arrays of 4P words.
template <typename V, typename T, bool VEC, int G, int C>
__global__ void __launch_bounds__(kThreads)
v4_gather_fwd(const V* __restrict__ value, const T* __restrict__ loc,
              const T* __restrict__ weight, V* __restrict__ out, int Q,
              int H, int D, int S, int L, int P, int q_tiles,
              const __grid_constant__ Levels lv) {
  using R = RowChunk<V, VEC>;
  constexpr int VW = R::VW;
  constexpr int NG = 32 / G;  // rows a warp reads at once
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  extern __shared__ __align__(16) int smem_words[];
  // constant indices: an indexed kernel parameter would go to local memory
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (threadIdx.x == i) {
      s_h[i] = lv.h[i];
      s_w[i] = lv.w[i];
      s_start[i] = lv.start[i];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G, sub = lane % G;
  const unsigned below = (1u << lane) - 1u;
  const int NC = 4 * P;  // corners of a (query, level)
  int* key = smem_words + warp * 4 * NC;  // texel, or -1 - i: no texel
  float* term = reinterpret_cast<float*>(key + NC);
  int* lead_texel = key + 2 * NC;
  float* lead_a = reinterpret_cast<float*>(key + 3 * NC);

  const int tile = blockIdx.x % q_tiles;
  const int64_t nh = blockIdx.x / q_tiles;
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const int64_t row = (int64_t)H * D;
  const int nch = D / VW;
  const V* vbase = value + n * (int64_t)S * row + (int64_t)h * D;
  const int q_end = min(Q, (tile + 1) * kQTile);

  for (int q = tile * kQTile + warp; q < q_end; q += kWarps) {
    const int64_t nqh = (n * Q + q) * H + h;
    float acc[C][VW];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[c][v] = 0.f;

    for (int l = 0; l < L; ++l) {
      const int hl = s_h[l], wl = s_w[l];
      const int64_t s0 = nqh * L * P + (int64_t)l * P;  // point 0's sample
      // 1. every corner's texel and term
      for (int i = lane; i < NC; i += 32) {
        const int p = i >> 2, c = i & 3;
        const float xs = v4_coord(to_f32(loc[2 * (s0 + p)]), wl);
        const float ys = v4_coord(to_f32(loc[2 * (s0 + p) + 1]), hl);
        const float x0f = floorf(xs), y0f = floorf(ys);
        int k = -1 - i;
        float t = 0.f;
        if (x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
            y0f <= (float)(hl - 1)) {
          const int x = (int)x0f + (c & 1), y = (int)y0f + (c >> 1);
          if (x >= 0 && x < wl && y >= 0 && y < hl) {
            k = y * wl + x;
            t = corner_term((float)x, (float)y, xs, ys,
                            to_f32(weight[s0 + p]));
          }
        }
        key[i] = k;
        term[i] = t;
      }
      __syncwarp();
      // 2. merged by texel, the first corner of each texel leading
      int listed = 0;
      for (int base = 0; base < NC; base += 32) {
        const int i = base + lane;
        const int k = i < NC ? key[i] : -1 - i;
        const unsigned peers = __match_any_sync(deform::kFull, k);
        bool lead = k >= 0 && !(peers & below);
        for (int j = 0; lead && j < base; ++j) lead = key[j] != k;
        float a = 0.f;
        if (lead) {
          float s = 0.f;
          for (unsigned m = peers; m; m &= m - 1u)
            s = __fadd_rn(s, term[base + __ffs(m) - 1]);
          for (int j = base + 32; j < NC; ++j)
            if (key[j] == k) s = __fadd_rn(s, term[j]);
          a = round_to<V>(s);
          lead = a != 0.f;
        }
        const unsigned ballot = __ballot_sync(deform::kFull, lead);
        if (lead) {
          const int at = listed + __popc(ballot & below);
          lead_texel[at] = k;
          lead_a[at] = a;
        }
        listed += __popc(ballot);
      }
      __syncwarp();
      // 3. the listed rows, a group a row, kInFlight rows a group at once
      const V* vl = vbase + (int64_t)s_start[l] * row;
      for (int k0 = grp; k0 < listed; k0 += kInFlight * NG) {
        typename R::Raw raw[kInFlight][C];
        float a[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int k = k0 + u * NG;
          const bool in = k < listed;
          a[u] = in ? lead_a[k] : 0.f;
          const V* vr = vl + (in ? (int64_t)lead_texel[k] * row : 0);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int ch = sub + G * c;
            raw[u][c] = in && ch < nch ? R::load(vr + ch * VW) : R::zero();
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float f[VW];
            R::widen(raw[u][c], f);
#pragma unroll
            for (int v = 0; v < VW; ++v) acc[c][v] = fmaf(a[u], f[v], acc[c][v]);
          }
        }
      }
      __syncwarp();  // the next level rewrites the warp's arrays
    }
    // the groups' sums, folded in a fixed order
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int v = 0; v < VW; ++v)
          acc[c][v] += __shfl_xor_sync(deform::kFull, acc[c][v], off);
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = sub + G * c;
        if (ch < nch) R::store(out + nqh * D + ch * VW, acc[c]);
      }
    }
  }
}

template <typename V, typename T, bool VEC, int G, int C>
int launch_body(const void* value, const void* loc, const void* weight,
                void* out, int N, int Q, int H, int D, int S, int L, int P,
                const Levels& lv, cudaStream_t stream) {
  const int q_tiles = (Q + kQTile - 1) / kQTile;
  const int64_t blocks = (int64_t)N * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(int) * kWarps * 4 * 4 * (size_t)P;
  v4_gather_fwd<V, T, VEC, G, C><<<(unsigned)blocks, kThreads, smem,
                                   stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<V*>(out), Q, H, D, S, L, P,
      q_tiles, lv);
  return 0;
}

template <typename V, typename T>
int launch(const void* value, const void* loc, const void* weight, void* out,
           int N, int Q, int H, int D, int S, int L, int P, const Levels& lv,
           cudaStream_t stream) {
  return deform::with_row_body<V, kMaxD>(
      D, {value, out}, [&](auto vec, auto lanes, auto chunks) {
        return launch_body<V, T, decltype(vec)::value, decltype(lanes)::value,
                           decltype(chunks)::value>(
            value, loc, weight, out, N, Q, H, D, S, L, P, lv, stream);
      });
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
  int err = fill_levels(level_hw, L, S, &lv);
  if (err) return err;
  if ((int64_t)N * Q * H == 0) return 0;
  if ((int64_t)N * H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 1 && loc_dtype == 0) {
    err = launch<__nv_bfloat16, float>(value, loc, weight, out, N, Q, H, D, S,
                                       L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(value, loc, weight, out, N, Q,
                                               H, D, S, L, P, lv, s);
  } else if (value_dtype == 0 && loc_dtype == 0) {
    err = launch<float, float>(value, loc, weight, out, N, Q, H, D, S, L, P,
                               lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
