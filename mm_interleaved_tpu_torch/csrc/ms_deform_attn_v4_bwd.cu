// Multi-scale deformable attention, backward, v4's function and numerics,
// for sm_90a: the value gradient (a texel-major gather over the samples'
// corners, stably binned by texel) and the location/weight gradient (a
// per-query gather).
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py::
// _kernel_v4_bwd_dv and ::_kernel_v4_bwd_dslab.  With the forward's
//   A_l[q, y*w + x] = sum_p hat(x - xs_p[q]) * (hat(y - ys_p[q]) * aw_p[q])
// (ms_deform_attn_v4.cu) and g = dOut in the value's dtype:
//   dV_l  = A_l^T g, A rounded to the value's dtype;
//   dA_l  = g V_l^T, and per (query, point)
//   d_aw  = sum_f wx wy dA,  d_xs = aw sum_f sx wy dA,  d_ys = aw sum_f wx sy dA,
// wx = hat(x - xs), sx = sign(x - xs) where |x - xs| < 1 and 0 elsewhere (so
// 0 at x = xs), the same in y; d loc_x = d_xs * w and d loc_y = d_ys * h.
// Every sum is fp32.  A sample's hats are non-zero on at most its 2 x 2
// corner texels, floor(xs) and floor(xs) + 1 in each axis (xs = v4_coord),
// so of a row of A or dA only the corners' entries count; the TPU builds
// them densely because a TPU has no fast gather.
//
//  * Value gradient (mmi_ms_deform_attn_v4_bwd_value), texel-major, in
//    three launches, no float atomics:
//    - v4_corner_keys, a thread a sample: its four corners' keys at slot
//      4 i + c of the (n, h, level)'s [4 Q P] (i = q P + p, c row-major
//      (x0,y0), (x1,y0), (x0,y1), (x1,y1), as 8a enumerates them): the
//      corner's texel y w + x, or -1 outside the grid;
//    - bin_samples (ms_deform_attn_bin.cuh, kernel 2's stable counting
//      sort) with h w bins a level: each texel's run holds its corner
//      entries in entry order, by query and within a query by point;
//    - v4_value_gather: a team of lanes a texel (a warp where runs are
//      long, a group of G lanes where they are short: the plan's walks)
//      takes its run a round of team-width entries at a time.  Each lane
//      forms its entry's term as 8a does (corner_term); the first entry of
//      each query sums the query's terms one after another in point order
//      (a segment that reaches the round's end carries into the next),
//      rounds the sum to the value's dtype and lists (q, A) unless it is
//      0: the entry of A that 8a forms, bit for bit.  Groups of G lanes
//      then read the listed queries' g rows, 16 bytes a lane (single
//      elements where rows are not whole 16-byte vectors), four rows a
//      group in flight, and accumulate A g in fp32; the team's groups fold
//      by a fixed butterfly and the texel's row is written once, in the
//      value's dtype (zeros for an empty run).
//    Bound: bytes (dOut, the locations and weights read, dV written once);
//    each corner entry reads its sample's location and weight again, and
//    each (query, texel) pair one row of g.  No hat is evaluated at a
//    texel no corner touches.  Every sum runs in an order fixed by the
//    data: the same bits every run.  An (n, h)'s 4 Q L P entry ids must fit
//    in int32.
//  * Location/weight gradient (mmi_ms_deform_attn_v4_bwd_loc_weight), a
//    gather: dA_c = g . V_c at the four corners.  Bound: gathered bytes (4
//    rows of D a sample, one FMA an element).  The body is kernel 3's,
//    deform::loc_weight_gather (ms_deform_attn_common.cuh), with v4's blend
//    (V4Blend): a warp owns one (n, q, h) at a time with its dOut row in
//    registers, a CTA's 8 warps take 32 neighbouring queries of one (n, h);
//    a group of G lanes takes one sample, each lane 16 bytes of each of its
//    four corners' rows (single elements where the rows are not whole
//    16-byte vectors on a 16-byte boundary), all four loads issued before
//    the dot products and the next sample's under this one's; the group's
//    sums reduce in a fixed tree and the sample's own lane takes its four
//    dA_c (0 for a corner outside the grid) and forms d_aw, d_xs, d_ys from
//    the corners' hats and slopes in row-major order.  d_loc and d_w are
//    written in fp32.  No float atomics; the same bits every run.
//
// C interface (ctypes): see the end of the file.

#include "ms_deform_attn_bin.cuh"
#include "ms_deform_attn_v4.cuh"

namespace {

using deform::kFull;
using deform::RowChunk;

constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;  // g rows a group loads before its FMAs

// Each sample's four corner keys (the corner's texel on the sample's level,
// -1 outside the grid): a thread a sample i = q * L * P + l * P + p of one
// (n, h), so a warp reads whole lines of the locations; written per (n, h,
// level) at slot 4 (q * P + p) + c: keys [N*H, L, 4*Q*P].  The corners are
// 8a's: x0 = floor(v4_coord(loc_x, w)), y0 alike.
template <typename T>
__global__ void __launch_bounds__(kThreads)
v4_corner_keys(const T* __restrict__ loc, int* __restrict__ keys, int Q,
               int H, int L, int P, int per_nh,
               const __grid_constant__ Levels lv,
               const __grid_constant__ BinLevels bl, FastDiv div_lp,
               FastDiv div_p) {
  __shared__ LevelTables s;
  load_tables(s, lv, bl);
  const int64_t nh = blockIdx.x / per_nh;
  const int i = (int)(blockIdx.x - nh * per_nh) * kThreads + threadIdx.x;
  const int LP = L * P;
  if (i >= Q * LP) return;
  const int q = div_by(i, div_lp);
  const int lp = i - q * LP;
  const int l = div_by(lp, div_p);
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const int64_t g = ((n * Q + q) * H + h) * LP + lp;
  const int hl = s.h[l], wl = s.w[l];
  const float x0f = floorf(v4_coord(to_f32(loc[2 * g]), wl));
  const float y0f = floorf(v4_coord(to_f32(loc[2 * g + 1]), hl));
  int k[4] = {-1, -1, -1, -1};
  if (x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
      y0f <= (float)(hl - 1)) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = (int)x0f + (c & 1), y = (int)y0f + (c >> 1);
      if (x >= 0 && x < wl && y >= 0 && y < hl) k[c] = y * wl + x;
    }
  }
  *reinterpret_cast<int4*>(
      keys + 4 * ((nh * L + l) * (int64_t)Q * P + q * P + (lp - l * P))) =
      make_int4(k[0], k[1], k[2], k[3]);
}

// One texel a team of TW lanes (TW = 32: a warp a texel; TW = G: a group
// a texel, 32 / TW texels a warp), the team's groups of G lanes taking the
// listed (query, A) pairs in turn.  ``lq`` / ``la``: the warp's list, 32
// pairs, the team's from tm * TW on.
template <int TW, typename V, typename T, bool VEC, int G, int C>
__device__ __forceinline__ void texel_walk(
    const LevelTables& s, int l, int r, int64_t nh,
    const T* __restrict__ loc, const T* __restrict__ weight,
    const V* __restrict__ dout, const int* __restrict__ ids,
    const int* __restrict__ bin_start, V* __restrict__ grad_value, int Q,
    int H, int D, int S, int L, int P, int bins_all, FastDiv div_p, int* lq,
    float* la) {
  using R = RowChunk<V, VEC>;
  constexpr int VW = R::VW;
  constexpr int NT = 32 / TW;  // texels a warp
  constexpr int NGT = TW / G;  // groups a team
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tm = lane / TW, t = lane % TW;
  const int gi = t / G, sub = t % G;
  const unsigned team = (TW == 32 ? kFull : (1u << (TW & 31)) - 1u)
                        << (tm * TW);
  const unsigned below = (1u << lane) - 1u;
  const int hl = s.h[l], wl = s.w[l];
  const int tl = ((r - s.tile[l]) * kWarps + warp) * NT + tm;
  const bool live = tl < hl * wl;
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const int* cs = bin_start + nh * (int64_t)(bins_all + L) + s.slot[l];
  const int b = live ? __ldg(cs + tl) : 0;
  const int len = live ? __ldg(cs + tl + 1) - b : 0;  // the texel's run
  const int* run = ids + nh * (int64_t)L * 4 * Q * P + b;
  const float tx = (float)(live ? tl % wl : 0);
  const float ty = (float)(live ? tl / wl : 0);
  const int64_t g0 = (n * Q * H + h) * (int64_t)L * P + l * P;
  const int64_t qstride = (int64_t)H * L * P;
  const int64_t row = (int64_t)H * D;
  const V* grow = dout + (n * Q * H + h) * (int64_t)D + sub * VW;
  const int nch = D / VW;
  int* tq = lq + tm * TW;
  float* ta = la + tm * TW;
  float acc[C][VW];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[c][v] = 0.f;

  // entry id e's query and its sample's location and weight (the sample
  // is e / 4 = q * P + p of the level)
  auto fetch = [&](int e, int& q, float& lx, float& ly, float& aw) {
    const int i = e >> 2;
    q = div_by(i, div_p);
    const int64_t gs = g0 + q * qstride + (i - q * P);
    lx = to_f32(loc[2 * gs]);
    ly = to_f32(loc[2 * gs + 1]);
    aw = to_f32(weight[gs]);
  };
  const int most = (int)__reduce_max_sync(kFull, (unsigned)len);
  int carry_q = -1;  // the query whose sum goes on from the last round
  float carry_s = 0.f;
  int q = -1;  // this round's entry: -1 past the run's end
  float lx = 0.f, ly = 0.f, aw = 0.f;
  if (t < len) fetch(__ldg(run + t), q, lx, ly, aw);
  for (int base = 0; base < most; base += TW) {
    // 1. this lane's entry's term; the next round's entry ids load under
    // this round's work, their samples under its rows
    const int j = base + t;
    const bool valid = j < len;
    const int nid = j + TW < len ? __ldg(run + j + TW) : -1;
    const float term = valid ? corner_term(tx, ty, v4_coord(lx, wl),
                                           v4_coord(ly, hl), aw)
                             : 0.f;
    // 2. the first entry of each query sums its terms in point order
    const int qp = __shfl_up_sync(kFull, q, 1, TW);
    const bool lead = valid && (t == 0 || qp != q);
    float sum = __fadd_rn(t == 0 && q == carry_q ? carry_s : 0.f, term);
    bool open = lead;
    for (int k = 1; __any_sync(kFull, open); ++k) {
      const float tk = __shfl_down_sync(kFull, term, k, TW);
      const int qk = __shfl_down_sync(kFull, q, k, TW);
      open = open && t + k < TW && qk == q;
      if (open) sum = __fadd_rn(sum, tk);
    }
    // the team's last query goes on into the next round (whose first
    // entry is the same query's): its first entry hands its sum on
    // instead of listing it
    const int first_next = __shfl_sync(kFull, nid, 0, TW);
    const int qn = first_next >= 0 ? div_by(first_next >> 2, div_p) : -1;
    const bool cont =
        __shfl_sync(kFull, (int)(valid && qn == q), TW - 1, TW) != 0;
    const unsigned leads = __ballot_sync(kFull, lead) & team;
    const int last = leads ? 31 - __clz(leads) : lane;
    const float last_sum = __shfl_sync(kFull, sum, last);
    const int last_q = __shfl_sync(kFull, q, last);
    carry_q = cont ? last_q : -1;
    carry_s = last_sum;
    const float a = round_to<V>(sum);
    const bool list = lead && !(cont && lane == last) && a != 0.f;
    const unsigned listed = __ballot_sync(kFull, list) & team;
    if (list) {
      const int at = __popc(listed & below);
      tq[at] = q;
      ta[at] = a;
    }
    __syncwarp();
    int nq = -1;
    float nlx = 0.f, nly = 0.f, naw = 0.f;
    if (nid >= 0) fetch(nid, nq, nlx, nly, naw);
    // 3. the listed pairs: group gi of the team takes pairs gi, gi + NGT,
    // ..., kInFlight rows at once
    const int npairs = __popc(listed);
    for (int k0 = gi; k0 < npairs; k0 += kInFlight * NGT) {
      typename R::Raw raw[kInFlight][C];
      float av[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int k = k0 + u * NGT;
        const bool in = k < npairs;
        av[u] = in ? ta[k] : 0.f;
        const V* gr = grow + (in ? (int64_t)tq[k] * row : 0);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          raw[u][c] = in && sub + G * c < nch ? R::load(gr + G * c * VW)
                                              : R::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float f[VW];
          R::widen(raw[u][c], f);
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[c][v] = fmaf(av[u], f[v], acc[c][v]);
        }
      }
    }
    __syncwarp();  // the next round rewrites the list
    q = nq;
    lx = nlx;
    ly = nly;
    aw = naw;
  }
  // the team's groups' sums, folded in a fixed order
#pragma unroll
  for (int off = G; off < TW; off <<= 1)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < VW; ++v)
        acc[c][v] += __shfl_xor_sync(kFull, acc[c][v], off);
  if (live && gi == 0) {
    V* out = grad_value + ((n * S + s.start[l] + tl) * H + h) * (int64_t)D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ch = sub + G * c;
      if (ch < nch) R::store(out + ch * VW, acc[c]);
    }
  }
}

// ids / bin_start from bin_samples over v4_corner_keys' keys; dout [N, Q,
// H, D] and grad_value [N, S, H, D] in V, loc / weight in T.  A CTA takes
// neighbouring texels of one level of one (n, h): kWarps of them where the
// level's bit of ``group_levels`` is clear (a warp a texel), kWarps * 32 /
// G where it is set (a group a texel).  Every texel is written once.
template <typename V, typename T, bool VEC, int G, int C>
__global__ void __launch_bounds__(kThreads)
v4_value_gather(const T* __restrict__ loc, const T* __restrict__ weight,
                const V* __restrict__ dout, const int* __restrict__ ids,
                const int* __restrict__ bin_start, V* __restrict__ grad_value,
                int Q, int H, int D, int S, int L, int P, int bins_all,
                int group_levels, const __grid_constant__ Levels lv,
                const __grid_constant__ BinLevels bl, FastDiv div_p) {
  __shared__ LevelTables s;
  __shared__ int s_q[kWarps][32];
  __shared__ float s_a[kWarps][32];
  load_tables(s, lv, bl);
  const int64_t nh = blockIdx.x / s.tile[L];
  const int r = (int)(blockIdx.x % s.tile[L]);
  int l = 0;
  while (l + 1 < L && r >= s.tile[l + 1]) ++l;
  const int warp = threadIdx.x >> 5;
  if (group_levels >> l & 1) {
    texel_walk<G, V, T, VEC, G, C>(s, l, r, nh, loc, weight, dout, ids,
                                   bin_start, grad_value, Q, H, D, S, L, P,
                                   bins_all, div_p, s_q[warp], s_a[warp]);
  } else {
    texel_walk<32, V, T, VEC, G, C>(s, l, r, nh, loc, weight, dout, ids,
                                    bin_start, grad_value, Q, H, D, S, L, P,
                                    bins_all, div_p, s_q[warp], s_a[warp]);
  }
}

// v4's corner blend for deform::loc_weight_gather: the hats and slopes of
// each axis's two texels (x0 = floor(xs) and x0 + 1, where the dense walk's
// hats and slopes are the only non-zero ones), d_w, d_xs and d_ys summed
// over the corners in row-major order, the gradients in fp32.
struct V4Blend {
  using Out = float;
  struct Sample {
    float xs, ys, x0, y0;
  };

  __device__ static Sample setup(float lx, float ly, int hl, int wl,
                                 int* texel, unsigned* mask) {
    const float xs = v4_coord(lx, wl), ys = v4_coord(ly, hl);
    const float x0f = floorf(xs), y0f = floorf(ys);
    if (x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f &&
        y0f <= (float)(hl - 1)) {
      const int x0 = (int)x0f, y0 = (int)y0f;
      const bool x0_in = x0 >= 0, x1_in = x0 + 1 < wl;
      const bool y0_in = y0 >= 0, y1_in = y0 + 1 < hl;
      *mask = (unsigned)(y0_in && x0_in) | (unsigned)(y0_in && x1_in) << 1 |
              (unsigned)(y1_in && x0_in) << 2 |
              (unsigned)(y1_in && x1_in) << 3;
      *texel = y0 * wl + x0;
    }
    return {xs, ys, x0f, y0f};
  }

  __device__ static void finish(const Sample& s, float aw, int hl, int wl,
                                const float (&dA)[4], int64_t si,
                                float* grad_loc, float* grad_weight) {
    const float tx[2] = {__fsub_rn(s.x0, s.xs), __fsub_rn(s.x0 + 1.f, s.xs)};
    const float ty[2] = {__fsub_rn(s.y0, s.ys), __fsub_rn(s.y0 + 1.f, s.ys)};
    float s_w = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float tx_k = tx[k & 1], ty_k = ty[k >> 1];
      s_w += hat(tx_k) * hat(ty_k) * dA[k];
      s_x += hat_slope(tx_k) * hat(ty_k) * dA[k];
      s_y += hat(tx_k) * hat_slope(ty_k) * dA[k];
    }
    grad_weight[si] = s_w;
    grad_loc[2 * si] = aw * s_x * (float)wl;
    grad_loc[2 * si + 1] = aw * s_y * (float)hl;
  }
};

// value [N, S, H, D] and dout [N, Q, H, D] in V; loc, weight as the value
// kernel; grad_loc fp32 [N, Q, H, L, P, 2], grad_weight fp32
// [N, Q, H, L, P], every element written.  Grid N * H * q_tiles.  Three
// CTAs an SM, as kernel 3: left to itself ptxas takes about 98 registers
// a thread, two CTAs an SM, and the gather has fewer loads in flight.
template <typename V, typename T, bool VEC, int G, int C>
__global__ void __launch_bounds__(kThreads, 3)
v4_gather_loc_weight(const V* __restrict__ value, const T* __restrict__ loc,
                     const T* __restrict__ weight, const V* __restrict__ dout,
                     float* __restrict__ grad_loc,
                     float* __restrict__ grad_weight, int Q, int H, int D,
                     int S, int L, int P, int q_tiles,
                     const __grid_constant__ Levels lv) {
  deform::loc_weight_gather<V4Blend, V, T, VEC, G, C>(
      value, loc, weight, dout, grad_loc, grad_weight, Q, H, D, S, L, P,
      q_tiles, lv);
}

template <typename V, typename T, bool VEC, int G, int C>
int launch_value_body(int bin_warps, int shared_table, int group_levels,
                      const void* loc, const void* weight, const void* dout,
                      int* keys, int* ids, int* bin_start, int* table,
                      void* grad_value, int N, int S, int Q, int H, int D,
                      int L, int P, const Levels& lv, cudaStream_t stream) {
  BinLevels bl = {};
  const int bins = fill_bin_levels(lv, L, group_levels, kWarps * (32 / G),
                                   kWarps, [](int h, int w) { return h * w; },
                                   &bl);
  if (bins < 0) return (int)cudaErrorInvalidValue;
  const int64_t nh = (int64_t)N * H;
  const int per_nh = (int)(((int64_t)Q * L * P + kThreads - 1) / kThreads);
  if (nh * bl.tile[L] > 0x7fffffffLL || nh * per_nh > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (shared_table) {
    table = nullptr;
  } else if (table == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const T* lp = static_cast<const T*>(loc);
  if (per_nh > 0) {
    v4_corner_keys<T><<<(unsigned)(nh * per_nh), kThreads, 0, stream>>>(
        lp, keys, Q, H, L, P, per_nh, lv, bl, fast_div(L * P), fast_div(P));
  }
  const int e = launch_bins(bin_warps, table, keys, ids, bin_start, nh,
                            4 * Q * P, L, bins, lv, bl, stream);
  if (e) return e;
  v4_value_gather<V, T, VEC, G, C><<<(unsigned)(nh * bl.tile[L]), kThreads,
                                     0, stream>>>(
      lp, static_cast<const T*>(weight), static_cast<const V*>(dout), ids,
      bin_start, static_cast<V*>(grad_value), Q, H, D, S, L, P, bins,
      group_levels, lv, bl, fast_div(P));
  return 0;
}

// The value gradient's body for rows of D elements of V read from dout:
// 16-byte chunks where the rows are whole vectors (the wrapper refuses a
// dout off a 16-byte boundary there), else single elements, lanes along D.
template <typename V, typename T>
int launch_value(int bin_warps, int shared_table, int group_levels,
                 const void* loc, const void* weight, const void* dout,
                 int* keys, int* ids, int* bin_start, int* table,
                 void* grad_value, int N, int S, int Q, int H, int D, int L,
                 int P, const Levels& lv, cudaStream_t stream) {
  return deform::with_row_body<V, kMaxD>(
      D, {dout}, [&](auto vec, auto lanes, auto chunks) {
        return launch_value_body<V, T, decltype(vec)::value,
                                 decltype(lanes)::value,
                                 decltype(chunks)::value>(
            bin_warps, shared_table, group_levels, loc, weight, dout, keys,
            ids, bin_start, table, grad_value, N, S, Q, H, D, L, P, lv,
            stream);
      });
}

template <typename V, typename T, bool VEC, int G, int C>
int launch_lw_body(const void* value, const void* loc, const void* weight,
                   const void* dout, float* grad_loc, float* grad_weight,
                   int N, int S, int Q, int H, int D, int L, int P,
                   const Levels& lv, cudaStream_t stream) {
  const int q_tiles = (Q + deform::kGatherQTile - 1) / deform::kGatherQTile;
  const int64_t blocks = (int64_t)N * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  v4_gather_loc_weight<V, T, VEC, G, C><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout), grad_loc,
      grad_weight, Q, H, D, S, L, P, q_tiles, lv);
  return 0;
}

template <typename V, typename T>
int launch_loc_weight(const void* value, const void* loc, const void* weight,
                      const void* dout, float* grad_loc, float* grad_weight,
                      int N, int S, int Q, int H, int D, int L, int P,
                      const Levels& lv, cudaStream_t stream) {
  return deform::with_row_body<V, kMaxD>(
      D, {value, dout}, [&](auto vec, auto lanes, auto chunks) {
        return launch_lw_body<V, T, decltype(vec)::value,
                              decltype(lanes)::value,
                              decltype(chunks)::value>(
            value, loc, weight, dout, grad_loc, grad_weight, N, S, Q, H, D,
            L, P, lv, stream);
      });
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
// level_hw: host array (h0, w0, h1, w1, ...).  The plan
// (ops/ms_deform_attn_v4.py::value_grad_plan): bin_warps, the warps of a
// binning CTA; shared_table 1 = its [bin_warps + 1, h*w] table in shared
// memory, 0 = in ``table``, int32 [N*H, bin_warps + 1, bins] (bins = sum
// over levels of h * w); group_levels: bit l set = a group of lanes a texel
// on level l, else a warp.  keys: int32 [N*H, L, 4*Q*P], ids: int32
// [N*H, L*4*Q*P], bin_start: int32 [N*H, bins + L], all scratch; dout 16-
// byte aligned where D * itemsize is a multiple of 16 (the caller checked).
// grad_value [N, S, H, D] in the value's dtype, every element written.
// Returns a cudaError_t code (0 = launched).
extern "C" int mmi_ms_deform_attn_v4_bwd_value(
    int device, int value_dtype, int loc_dtype, int bin_warps,
    int shared_table, int group_levels, const void* loc, const void* weight,
    const void* dout, int* keys, int* ids, int* bin_start, int* table,
    void* grad_value, int N, int S, int Q, int H, int D, int L, int P,
    const int* level_hw, void* stream) {
  Levels lv = {};
  int err = prepare(device, value_dtype, N, S, H, D, L, P, level_hw, &lv);
  if (err) return err;
  if (4LL * Q * L * P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((int64_t)N * H * S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 1 && loc_dtype == 0) {
    err = launch_value<__nv_bfloat16, float>(
        bin_warps, shared_table, group_levels, loc, weight, dout, keys, ids,
        bin_start, table, grad_value, N, S, Q, H, D, L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch_value<__nv_bfloat16, __nv_bfloat16>(
        bin_warps, shared_table, group_levels, loc, weight, dout, keys, ids,
        bin_start, table, grad_value, N, S, Q, H, D, L, P, lv, s);
  } else if (value_dtype == 0 && loc_dtype == 0) {
    err = launch_value<float, float>(
        bin_warps, shared_table, group_levels, loc, weight, dout, keys, ids,
        bin_start, table, grad_value, N, S, Q, H, D, L, P, lv, s);
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
