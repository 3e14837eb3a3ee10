// Multi-scale deformable attention, backward, for sm_90a.
//
// Replaces mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py::
// _kernel_v5_bwd_dv and ::_kernel_v5_bwd_dslab.  The TPU computes the value
// gradient as the transposed product dOut^T . A over dense bilinear
// matrices, accumulated across query tiles on its sequential grid, in a
// fixed order; the location/weight gradient folds dA = dOut . V^T against
// separable hat factors.  A GPU gathers directly:
//
//  * grad value (mmi_ms_deform_attn_bwd_value): dV[n, t, h, :] is the sum
//    of w * cw_c * dOut[n, q, h, :] over every sample (q, l, p) whose
//    in-bounds corner c lands on texel t.  It is gathered by texel, in an
//    order fixed by the data, with no float atomics and no fp32 buffer, in
//    three launches:
//    - cell_keys: each sample's cell, its corner (x0, y0) with x0 in
//      -1 .. W_l - 1 and y0 alike ((H_l + 1)(W_l + 1) cells a level; -1 for
//      a sample with no corner in bounds), a thread a sample in the
//      locations' order, written per (n, h, level) in sample order.
//    - bin_samples, one CTA per (n, h, level): a stable counting sort of
//      the level's sample ids by cell.  Each warp owns a contiguous run of
//      the samples and a row of a [W, cells_l] table: it counts its samples
//      per cell (integer atomics: a count does not depend on their order),
//      the rows become each warp's offset within each cell in warp order,
//      the cells' totals an exclusive scan (the cell offsets), and each warp
//      places its samples in sample order, 32 at a time, ranking the lanes
//      of a step that share a cell by __match_any_sync.  A cell holds its
//      samples in sample order, whatever the schedule.  The table sits in
//      shared memory where W >= 4 warps' rows fit (the "shared" plan: 12
//      warps at the UNet's 64 px level), else in a device scratch.
//    - the gather: it walks the four cells whose samples can reach a
//      texel, those whose corner (x0, y0) is the texel less (0, 0), (1, 0),
//      (0, 1), (1, 1), in that order, each cell's samples in stored order;
//      a lane reads a sample's id, location and weight and works out its
//      corner weight by deform::corners' rounding.  "grouped" (D = 4, 8 or
//      16 whole 16-byte vectors; ops/ms_deform_attn_cuda.py::
//      value_grad_plan): G lanes a sample, each lane a 16-byte vector of
//      its dOut row, eight rows in flight a lane; by level, a warp a texel
//      (the groups take every (32 / G)-th sample, their fp32 sums folded by
//      a fixed butterfly) where a texel's walk is long, or a group of G
//      lanes a texel (its samples one after another) where it is short.
//      The texel's [D] row is written once, in the value's dtype.  "lanes"
//      (any D): a warp a texel, lanes along D, the samples one after
//      another.
//    Every sum runs in an order fixed by the data, so the gradient is the
//    same bits every run.  An (n, h)'s Q*L*P ids must fit in int32.
//  * grad locations and weights (mmi_ms_deform_attn_bwd_loc_weight): for
//    each in-bounds corner c of a sample (n, q, h, l, p) the dot product
//    g_c = sum_d dOut_d * V_c,d, then d_w = sum_c cw_c g_c and, with
//    x = loc_x * W_l - 0.5, d_loc_x = w * W_l * sum_c (d cw_c / d x) g_c
//    (and y alike): the derivative of the floor-based bilinear blend that
//    autograd takes through the plain version.  Two bodies, chosen by the
//    wrapper from (D, dtype) (ops/ms_deform_attn_cuda.py::
//    loc_weight_variant):
//    - "grouped", where a head's D channels are G = 4, 8 or 16 whole 16-byte
//      vectors (D = 64 bf16: G = 8).  A warp owns one (n, q, h) at a time,
//      so its dOut slice loads once into registers and serves all L*P
//      samples; a group of G lanes takes one sample, each lane one 16-byte
//      vector of each corner, so a warp holds 32 / G samples at once.
//      Lane j works out sample j's geometry (level, corners, bounds) and
//      hands the groups the corner texels by shuffle; all four corners'
//      loads issue before any reduction, the next sample's under the
//      current one's math; the four dot products reduce inside the group
//      by a transposed butterfly (2 + 1 shuffles leave each corner's sums
//      on G / 4 lanes, log2(G) - 2 butterfly steps finish them: at G = 8
//      one corner a lane pair, 4 shuffles a sample), and lane j collects
//      sample j's four sums, so the gradients of a query-head's samples
//      are written by consecutive lanes, coalesced.  A CTA's 8 warps take
//      neighbouring queries of one (n, h), whose corners overlap in L1.
//    - "warp", any D: one warp per sample, lanes along D, a full-warp
//      reduction per corner.
//    Both write the gradients in the locations' dtype.
//
// Bound: bytes (dOut, the locations and weights, the corners the location
// gradient gathers, each gradient written once), at about 8 flops per
// sample and channel in each kernel, far below the card's ridge point.
// The value gradient's gather reads each walked sample's location and
// weight at random, a 32-byte sector for 6 bytes (bf16), four times a
// sample; that traffic, not dOut's, is what holds it.  Accumulation is
// fp32, in a fixed order: both gradients are the same bits every run.
//
// C interface (ctypes): see the end of the file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_common.cuh"

namespace {

using deform::Corners;
using deform::corners;
using deform::from_f32;
using deform::kFull;
using deform::kMaxLevels;
using deform::Levels;
using deform::load_corners;
using deform::to_f32;
using deform::widen;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (x, y) of one sample's location gradient, written as one pair
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}


// --------------------------------------------------------------------------
// the value gradient: binning, then the gather

constexpr int kMaxBinWarps = 32;
// steps of 32 samples whose loads a binning warp issues at once
constexpr int kSteps = 16;
// dynamic shared memory a binning block may take on sm_90 (227 KB, less
// room for its static tables)
constexpr int kMaxShared = 232448 - 1024;

// q = n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1):
// s = ceil(log2 d), m = floor(2^32 (2^s - d) / d) + 1, q = (hi(n m) + n) >> s
struct FastDiv {
  unsigned m;
  int s;
};

FastDiv fast_div(int d) {
  int s = 0;
  while ((1LL << s) < d) ++s;
  const unsigned long long m =
      (1ULL << 32) * ((1ULL << s) - (unsigned long long)d) / d + 1;
  return {(unsigned)m, s};
}

__device__ __forceinline__ int div_by(int n, FastDiv f) {
  return (int)((__umulhi((unsigned)n, f.m) + (unsigned)n) >> f.s);
}

// Per level: where its [cells] block starts in an (n, h)'s cell tables
// (cell), where its cell offsets start in the (n, h)'s row of cell_start
// (slot: cell + l, each level keeps one end slot), and the first of its
// gather's tiles (tile; tile[L] is an (n, h)'s count).
struct CellLevels {
  int cell[kMaxLevels];
  int slot[kMaxLevels];
  int tile[kMaxLevels + 1];
};

// The level tables of a block, in shared memory.
struct LevelTables {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels], cell[kMaxLevels],
      slot[kMaxLevels], tile[kMaxLevels + 1];
};

__device__ __forceinline__ void load_tables(LevelTables& s, const Levels& lv,
                                            const CellLevels& cl) {
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (threadIdx.x == i) {
      s.h[i] = lv.h[i];
      s.w[i] = lv.w[i];
      s.start[i] = lv.start[i];
      s.cell[i] = cl.cell[i];
      s.slot[i] = cl.slot[i];
      s.tile[i] = cl.tile[i];
    }
  }
  if (threadIdx.x == kMaxLevels) s.tile[kMaxLevels] = cl.tile[kMaxLevels];
  __syncthreads();
}

// The cell of every sample (deform::cell_of; -1 for none): a thread a
// sample i = q * L * P + l * P + p of one (n, h), so a warp reads whole
// lines of the locations; written per (n, h, level) in sample order,
// q * P + p: keys [N*H, L, Q*P].
template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_keys(const T* __restrict__ loc, int* __restrict__ keys, int Q, int H,
          int L, int P, int per_nh, const __grid_constant__ Levels lv,
          const __grid_constant__ CellLevels cl, FastDiv div_lp,
          FastDiv div_p) {
  __shared__ LevelTables s;
  load_tables(s, lv, cl);
  const int64_t nh = blockIdx.x / per_nh;
  const int i = (int)(blockIdx.x - nh * per_nh) * kThreads + threadIdx.x;
  const int LP = L * P;
  if (i >= Q * LP) return;
  const int q = div_by(i, div_lp);
  const int lp = i - q * LP;
  const int l = div_by(lp, div_p);
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const float2 xy = deform::load_xy(loc, ((n * Q + q) * H + h) * LP + lp);
  keys[(nh * L + l) * Q * P + q * P + (lp - l * P)] =
      deform::cell_of(xy.x, xy.y, s.h[l], s.w[l]);
}

// One CTA per (n, h, level), blockDim.x / 32 warps.  The level's Q*P
// samples, i = q * P + p, are binned by their cells (from cell_keys): ids
// [N*H, Q*L*P] holds, from l * Q * P on, the level's sample ids cell after
// cell, each cell's in sample order; cell_start [N*H, cells + L] where
// each cell's ids begin (from slot[l]; the level's last slot is its end).
// table: null (the [W + 1, cells_l] table in dynamic shared memory) or a
// device scratch of [N*H, W + 1, cells] (its level's block at (W + 1) *
// cell[l]).
__global__ void __launch_bounds__(kMaxBinWarps * 32)
bin_samples(const int* __restrict__ keys, int* __restrict__ ids,
            int* __restrict__ cell_start, int* __restrict__ gtable, int Q,
            int L, int P, int cells_all,
            const __grid_constant__ Levels lv,
            const __grid_constant__ CellLevels cl) {
  extern __shared__ int smem[];
  __shared__ LevelTables s;
  __shared__ int s_part[kMaxBinWarps];
  load_tables(s, lv, cl);
  const int W = blockDim.x >> 5;
  const int l = (int)(blockIdx.x % L);
  const int64_t nh = blockIdx.x / L;
  const int hl = s.h[l], wl = s.w[l];
  const int cells = (hl + 1) * (wl + 1);
  int* table = gtable ? gtable + (nh * cells_all + s.cell[l]) * (W + 1)
                      : smem;
  int* total = table + (int64_t)W * cells;
  for (int i = threadIdx.x; i < W * cells; i += blockDim.x) table[i] = 0;
  __syncthreads();
  const int QP = Q * P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = (QP + W - 1) / W;
  const int s0 = min(QP, warp * seg);
  const int s1 = min(QP, s0 + seg);
  int* mine = table + (int64_t)warp * cells;
  const int* kl = keys + (nh * L + l) * (int64_t)QP;  // this level's cells
  // kSteps steps of 32 from base on: their cells (-1: none, or past the
  // warp's run), loaded at once
  auto keys_of = [&](int base, int (&key)[kSteps]) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int i = base + 32 * u + lane;
      key[u] = i < s1 ? __ldg(kl + i) : -1;
    }
  };

  // 1. each warp counts its samples per cell in its own row
  for (int base = s0; base < s1; base += 32 * kSteps) {
    int key[kSteps];
    keys_of(base, key);
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (key[u] >= 0) atomicAdd(mine + key[u], 1);
  }
  __syncthreads();
  // 2. a cell's counts become the warps' offsets in it, in warp order
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    int run = 0;
    for (int w = 0; w < W; ++w) {
      int* p = table + (int64_t)w * cells + c;
      const int t = *p;
      *p = run;
      run += t;
    }
    total[c] = run;
  }
  __syncthreads();
  // 3. the cells' starts: an exclusive scan of their totals, a thread a
  // contiguous run of cells, after the level's l * Q * P; each warp's
  // offsets become its cursors
  const int per = (cells + blockDim.x - 1) / blockDim.x;
  const int c0 = min(cells, (int)threadIdx.x * per);
  const int c1 = min(cells, c0 + per);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += total[c];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int run = l * QP + incl - sum;
  for (int w = 0; w < warp; ++w) run += s_part[w];
  int* cs = cell_start + nh * (int64_t)(cells_all + L) + s.slot[l];
  for (int c = c0; c < c1; ++c) {
    const int t = total[c];
    cs[c] = run;
    for (int w = 0; w < W; ++w) table[(int64_t)w * cells + c] += run;
    run += t;
  }
  if (threadIdx.x == blockDim.x - 1) cs[cells] = run;
  __syncthreads();
  // 4. each warp places its samples in sample order: a lane's rank among
  // the lanes of its step that share its cell, after the cell's cursor
  int* out = ids + nh * (int64_t)L * QP;
  for (int base = s0; base < s1; base += 32 * kSteps) {
    int key[kSteps];
    keys_of(base, key);
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (base + 32 * u < s1) {  // the same for the whole warp
        const unsigned peers = __match_any_sync(kFull, key[u]);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int pos = key[u] >= 0 ? mine[key[u]] + rank : 0;
        __syncwarp();
        if (key[u] >= 0 && rank == 0) mine[key[u]] += __popc(peers);
        __syncwarp();
        if (key[u] >= 0) out[pos] = base + 32 * u + lane;
      }
    }
  }
}

// The four cells a texel's gather walks, and where each one's samples
// start in the walk.
struct Walk {
  int b[4];    // the cell's first id in the (n, h)'s ids
  int off[4];  // where the cell's samples start in the walk
  int total;
};

// Texel (ty, tx) of a level whose cell offsets start at cs: corner c = dy *
// 2 + dx of the cell whose corner (x0, y0) is the texel less (dx, dy).
// Lanes 0-3 of each ``width``-lane segment read, the segment shares.
__device__ __forceinline__ Walk walk_of(int ty, int tx, int wl,
                                        const int* cs, int sub, int width) {
  int b = 0, e = 0;
  if (sub < 4 && cs != nullptr) {
    const int dx = sub & 1, dy = sub >> 1;
    const int key = (ty - dy + 1) * (wl + 1) + tx - dx + 1;
    b = __ldg(cs + key);
    e = __ldg(cs + key + 1);
  }
  Walk wk;
  int run = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    wk.b[c] = __shfl_sync(kFull, b, c, width);
    wk.off[c] = run;
    run += __shfl_sync(kFull, e, c, width) - wk.b[c];
  }
  wk.total = run;
  return wk;
}

// Sample j of the walk: its query (in q) and its coefficient, the
// attention weight times the bilinear weight of the walked texel's corner.
// ``g0`` is where sample (q = 0, p = 0) of the level sits in loc / weight.
template <typename T>
__device__ __forceinline__ float walk_sample(const Walk& wk, int j,
                                             const int* idrow,
                                             const T* __restrict__ loc,
                                             const T* __restrict__ weight,
                                             int64_t g0, int64_t qstride,
                                             int P, FastDiv div_p, int hl,
                                             int wl, int& q) {
  const int c = (j >= wk.off[1]) + (j >= wk.off[2]) + (j >= wk.off[3]);
  const int b = c == 0 ? wk.b[0] : c == 1 ? wk.b[1] : c == 2 ? wk.b[2]
                                                               : wk.b[3];
  const int o = c == 0 ? 0 : c == 1 ? wk.off[1] : c == 2 ? wk.off[2]
                                                          : wk.off[3];
  const int i = __ldg(idrow + b + j - o);
  q = div_by(i, div_p);
  const int64_t g = g0 + q * qstride + (i - q * P);
  const float2 xy = deform::load_xy(loc, g);
  const float x = deform::grid_coord(xy.x, wl);
  const float y = deform::grid_coord(xy.y, hl);
  const float fx = x - floorf(x);
  const float fy = y - floorf(y);
  const float wx = c & 1 ? fx : 1.f - fx;
  const float wy = c & 2 ? fy : 1.f - fy;
  return to_f32(weight[g]) * (wx * wy);
}

// An (n, h)'s place in the gather: its texel grid on level l, where level
// l's samples start in loc / weight and dOut, and its ids and offsets.
struct GatherCtx {
  int64_t n;
  int h, hl, wl, Sl;
  int64_t g0, qstride, drow0;
  const int* idrow;
  const int* cs;
};

__device__ __forceinline__ GatherCtx gather_ctx(const LevelTables& s,
                                                int64_t nh, int l, int Q,
                                                int H, int L, int P, int D,
                                                int cells_all, const int* ids,
                                                const int* cell_start) {
  GatherCtx x;
  x.h = (int)(nh % H);
  x.n = nh / H;
  x.hl = s.h[l];
  x.wl = s.w[l];
  x.Sl = x.hl * x.wl;
  x.g0 = (x.n * Q * H + x.h) * (int64_t)L * P + l * P;
  x.qstride = (int64_t)H * L * P;
  x.drow0 = (x.n * Q * H + x.h) * (int64_t)D;
  x.idrow = ids + nh * (int64_t)L * Q * P;
  x.cs = cell_start + nh * (int64_t)(cells_all + L) + s.slot[l];
  return x;
}

// The "grouped" gather (D = G * 16 / sizeof(V)).  Per level, by
// ``group_levels``' bit l: a warp a texel (the groups take every NG-th
// sample of 32, their sums folded by a fixed butterfly), for levels whose
// cells hold many samples, or a group of G lanes a texel (its lanes take G
// samples at a time, summed one after another), for levels whose cells hold
// few.  A CTA takes neighbouring texels of one level of one (n, h).
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kThreads, 4)
bwd_value_grouped(const T* __restrict__ loc, const T* __restrict__ weight,
                  const V* __restrict__ dout, const int* __restrict__ ids,
                  const int* __restrict__ cell_start,
                  V* __restrict__ grad_value, int Q, int H, int S, int L,
                  int P, int cells_all, int group_levels,
                  const __grid_constant__ Levels lv,
                  const __grid_constant__ CellLevels cl, FastDiv div_p) {
  constexpr int VW = 16 / (int)sizeof(V);
  constexpr int D = G * VW;
  constexpr int NG = 32 / G;  // groups a warp
  constexpr int kR = 2;       // samples a lane sets up a round
  constexpr int kChunk = G < 8 ? G : 8;  // dOut rows a lane loads at once
  __shared__ LevelTables s;
  load_tables(s, lv, cl);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int sub = lane % G;
  const int64_t nh = blockIdx.x / s.tile[L];
  const int r = (int)(blockIdx.x % s.tile[L]);
  int l = 0;
  while (l + 1 < L && r >= s.tile[l + 1]) ++l;
  const GatherCtx x = gather_ctx(s, nh, l, Q, H, L, P, D, cells_all, ids,
                                 cell_start);
  const int64_t hd = (int64_t)H * D;
  const V* drow = dout + x.drow0 + sub * VW;
  float acc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) acc[v] = 0.f;
  if (group_levels >> l & 1) {
    // a group a texel: R * G samples a round, lane sub sets up samples
    // base + r * G + sub
    const int tl = ((r - s.tile[l]) * kWarps + warp) * NG + grp;
    const bool live = tl < x.Sl;
    const int ty = live ? tl / x.wl : 0, tx = live ? tl - ty * x.wl : 0;
    const Walk wk = walk_of(ty, tx, x.wl, live ? x.cs : nullptr, sub, G);
    const int most = (int)__reduce_max_sync(kFull, (unsigned)wk.total);
    for (int base = 0; base < most; base += kR * G) {
      int q[kR];
      float coef[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int j = base + rr * G + sub;
        q[rr] = 0;
        coef[rr] = j < wk.total
                       ? walk_sample(wk, j, x.idrow, loc, weight, x.g0,
                                     x.qstride, P, div_p, x.hl, x.wl, q[rr])
                       : 0.f;
      }
      const int cnt = wk.total - base;  // this group's samples in the round
      const int upto = min(kR * G, most - base);
#pragma unroll
      for (int k0 = 0; k0 < kR * G; k0 += kChunk) {
        if (k0 < upto) {  // the same for the whole warp
          uint4 row[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const int kk = k0 + k;
            const int qq = __shfl_sync(kFull, q[kk / G], kk % G, G);
            row[k] = __ldg(reinterpret_cast<const uint4*>(drow + qq * hd));
          }
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            const int kk = k0 + k;
            const float cf = __shfl_sync(kFull, coef[kk / G], kk % G, G);
            if (kk < cnt) {
              float f[VW];
              widen(row[k], f);
#pragma unroll
              for (int v = 0; v < VW; ++v) acc[v] = fmaf(cf, f[v], acc[v]);
            }
          }
        }
      }
    }
    if (live)
      *reinterpret_cast<uint4*>(
          grad_value + ((x.n * S + s.start[l] + tl) * H + x.h) * D +
          sub * VW) = deform::narrow(acc);
    return;
  }
  // a warp a texel: R * 32 samples a round, lane j sets up samples base +
  // r * 32 + j; group grp takes samples grp, grp + NG, ... (sample k * NG +
  // grp sits in lane (k % G) * NG + grp, register k / G)
  const int tl = (r - s.tile[l]) * kWarps + warp;
  if (tl >= x.Sl) return;  // whole warps leave together
  const int ty = tl / x.wl, tx = tl - ty * x.wl;
  const Walk wk = walk_of(ty, tx, x.wl, x.cs, lane, 32);
  for (int base = 0; base < wk.total; base += kR * 32) {
    int q[kR];
    float coef[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int j = base + rr * 32 + lane;
      q[rr] = 0;  // past the walk's end: a row that exists, weight 0
      coef[rr] = j < wk.total
                     ? walk_sample(wk, j, x.idrow, loc, weight, x.g0,
                                   x.qstride, P, div_p, x.hl, x.wl, q[rr])
                     : 0.f;
    }
    const int cnt = min(kR * 32, wk.total - base);
#pragma unroll
    for (int k0 = 0; k0 < kR * G; k0 += kChunk) {
      if (k0 * NG < cnt) {  // the same for the whole warp
        uint4 row[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int kk = k0 + k;
          const int qq = __shfl_sync(kFull, q[kk / G], (kk % G) * NG + grp);
          row[k] = __ldg(reinterpret_cast<const uint4*>(drow + qq * hd));
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int kk = k0 + k;
          const float cf =
              __shfl_sync(kFull, coef[kk / G], (kk % G) * NG + grp);
          if (kk * NG + grp < cnt) {
            float f[VW];
            widen(row[k], f);
#pragma unroll
            for (int v = 0; v < VW; ++v) acc[v] = fmaf(cf, f[v], acc[v]);
          }
        }
      }
    }
  }
  // the groups' sums, folded in a fixed order
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] += __shfl_xor_sync(kFull, acc[v], off);
  }
  if (grp == 0)
    *reinterpret_cast<uint4*>(grad_value +
                              ((x.n * S + s.start[l] + tl) * H + x.h) * D +
                              lane * VW) = deform::narrow(acc);
}

// The "lanes" gather, any D: a warp a texel, lanes along D in rounds of 32
// channels, the walk's samples one after another.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_value_lanes(const T* __restrict__ loc, const T* __restrict__ weight,
                const V* __restrict__ dout, const int* __restrict__ ids,
                const int* __restrict__ cell_start,
                V* __restrict__ grad_value, int Q, int H, int D, int S, int L,
                int P, int cells_all, const __grid_constant__ Levels lv,
                const __grid_constant__ CellLevels cl,
                FastDiv div_p) {
  __shared__ LevelTables s;
  load_tables(s, lv, cl);
  const int lane = threadIdx.x & 31;
  const int64_t nh = blockIdx.x / s.tile[L];
  const int r = (int)(blockIdx.x % s.tile[L]);
  int l = 0;
  while (l + 1 < L && r >= s.tile[l + 1]) ++l;
  const int tl = (r - s.tile[l]) * kWarps + (threadIdx.x >> 5);
  const GatherCtx x = gather_ctx(s, nh, l, Q, H, L, P, D, cells_all, ids,
                                 cell_start);
  if (tl >= x.Sl) return;
  const int ty = tl / x.wl, tx = tl - ty * x.wl;
  const Walk wk = walk_of(ty, tx, x.wl, x.cs, lane, 32);
  const V* dbase = dout + x.drow0;
  const int64_t hd = (int64_t)H * D;
  V* gout = grad_value + ((x.n * S + s.start[l] + tl) * H + x.h) * (int64_t)D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int base = 0; base < wk.total; base += 32) {
      const int j = base + lane;
      int q = 0;
      const float coef =
          j < wk.total ? walk_sample(wk, j, x.idrow, loc, weight, x.g0,
                                     x.qstride, P, div_p, x.hl, x.wl, q)
                       : 0.f;
      const int cnt = min(32, wk.total - base);
      for (int k = 0; k < cnt; ++k) {
        const float cf = __shfl_sync(kFull, coef, k);
        const int qq = __shfl_sync(kFull, q, k);
        if (d < D) acc = fmaf(cf, to_f32(dbase[qq * hd + d]), acc);
      }
    }
    if (d < D) gout[d] = from_f32<V>(acc);
  }
}

// Fills the per-level tables; returns the cells of all levels, or -1.
int fill_cell_levels(const Levels& lv, int L, int group_levels, int ng,
                     CellLevels* cl) {
  int64_t cells = 0, tiles = 0;
  for (int l = 0; l < L; ++l) {
    cl->cell[l] = (int)cells;
    cl->slot[l] = (int)cells + l;
    cl->tile[l] = (int)tiles;
    const int per = kWarps * (group_levels >> l & 1 ? ng : 1);
    tiles += ((int64_t)lv.h[l] * lv.w[l] + per - 1) / per;
    cells += (int64_t)(lv.h[l] + 1) * (lv.w[l] + 1);
    if (cells > 0x7fffffffLL - kMaxLevels || tiles > 0x7fffffffLL) return -1;
  }
  cl->tile[L] = (int)tiles;
  return (int)cells;
}

template <typename V, typename T>
int launch_value(int bin_warps, int shared_table, int grouped,
                 int group_levels, const void* loc, const void* weight,
                 const void* dout, int* keys, int* ids, int* cell_start,
                 int* table, void* gv, int N, int Q, int H, int D, int S,
                 int L, int P, const Levels& lv, cudaStream_t stream) {
  const T* lp = static_cast<const T*>(loc);
  const T* wp = static_cast<const T*>(weight);
  const int g = grouped ? deform::group_lanes(D, (int)sizeof(V)) : 0;
  if (grouped && !g) return (int)cudaErrorInvalidValue;
  CellLevels cl = {};
  const int cells = fill_cell_levels(lv, L, grouped ? group_levels : 0,
                                     g ? 32 / g : 1, &cl);
  if (cells < 0) return (int)cudaErrorInvalidValue;
  const int64_t nh = (int64_t)N * H;
  if (nh * L > 0x7fffffffLL || nh * cl.tile[L] > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (bin_warps < 1 || bin_warps > kMaxBinWarps)
    return (int)cudaErrorInvalidValue;
  const FastDiv div_p = fast_div(P);
  const int per_nh = (int)(((int64_t)Q * L * P + kThreads - 1) / kThreads);
  if (nh * per_nh > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  size_t smem = 0;
  if (shared_table) {
    int most = 0;
    for (int l = 0; l < L; ++l)
      most = max(most, (lv.h[l] + 1) * (lv.w[l] + 1));
    smem = (size_t)(bin_warps + 1) * most * sizeof(int);
    if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        bin_samples, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    table = nullptr;
  } else if (table == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (per_nh > 0) {
    cell_keys<T><<<(unsigned)(nh * per_nh), kThreads, 0, stream>>>(
        lp, keys, Q, H, L, P, per_nh, lv, cl, fast_div(L * P), fast_div(P));
  }
  bin_samples<<<(unsigned)(nh * L), bin_warps * 32, smem, stream>>>(
      keys, ids, cell_start, table, Q, L, P, cells, lv, cl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(nh * cl.tile[L]);
  const V* dp = static_cast<const V*>(dout);
  V* out = static_cast<V*>(gv);
  switch (g) {
    case 0:
      bwd_value_lanes<V, T><<<blocks, kThreads, 0, stream>>>(
          lp, wp, dp, ids, cell_start, out, Q, H, D, S, L, P, cells, lv, cl,
          div_p);
      return 0;
    case 4:
      bwd_value_grouped<V, T, 4><<<blocks, kThreads, 0, stream>>>(
          lp, wp, dp, ids, cell_start, out, Q, H, S, L, P, cells,
          group_levels, lv, cl, div_p);
      return 0;
    case 8:
      bwd_value_grouped<V, T, 8><<<blocks, kThreads, 0, stream>>>(
          lp, wp, dp, ids, cell_start, out, Q, H, S, L, P, cells,
          group_levels, lv, cl, div_p);
      return 0;
    case 16:
      bwd_value_grouped<V, T, 16><<<blocks, kThreads, 0, stream>>>(
          lp, wp, dp, ids, cell_start, out, Q, H, S, L, P, cells,
          group_levels, lv, cl, div_p);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------------------
// the location/weight gradient

// d_w, d_loc_x / (w W_l), d_loc_y / (w H_l) from the four corner sums
__device__ __forceinline__ void blend_grads(float fx, float fy,
                                            const float (&g)[4], float& dw,
                                            float& dx, float& dy) {
  dw = (1.f - fx) * (1.f - fy) * g[0] + fx * (1.f - fy) * g[1] +
       (1.f - fx) * fy * g[2] + fx * fy * g[3];
  dx = -(1.f - fy) * g[0] + (1.f - fy) * g[1] - fy * g[2] + fy * g[3];
  dy = -(1.f - fx) * g[0] - fx * g[1] + (1.f - fx) * g[2] + fx * g[3];
}

// value [N, S, H, D]; grad_loc [N, Q, H, L, P, 2], grad_weight
// [N, Q, H, L, P] in T.  One warp per sample.
template <typename V, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_loc_weight_kernel(const V* __restrict__ value, const T* __restrict__ loc,
                      const T* __restrict__ weight, const V* __restrict__ dout,
                      T* __restrict__ grad_loc, T* __restrict__ grad_weight,
                      int Q, int H, int D, int S, int L, int P,
                      int64_t samples, const __grid_constant__ Levels lv) {
  const int lane = threadIdx.x & 31;
  const int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= samples) return;  // whole warps leave together
  const int lp_i = (int)(s % ((int64_t)L * P));
  const int l = lp_i / P;
  const int64_t nqh = s / ((int64_t)L * P);
  const int h = (int)(nqh % H);
  const int64_t n = nqh / ((int64_t)Q * H);

  const int hl = lv.h[l];
  const int wl = lv.w[l];
  const Corners k = corners(to_f32(loc[2 * s]), to_f32(loc[2 * s + 1]), hl,
                            wl);
  const float aw = to_f32(weight[s]);
  const int64_t texel[4] = {k.texel, k.texel + 1, k.texel + wl,
                            k.texel + wl + 1};

  const int64_t row = (int64_t)H * D;
  const V* vl = value + n * (int64_t)S * row + (int64_t)lv.start[l] * row +
                (int64_t)h * D;
  const V* go = dout + nqh * (int64_t)D;
  float g[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float acc = 0.f;
    if (k.mask >> c & 1u) {
      const V* vc = vl + texel[c] * row;
      for (int d = lane; d < D; d += 32) acc += to_f32(go[d]) * to_f32(vc[d]);
    }
    g[c] = warp_sum(acc);  // 0 for an out-of-bounds corner
  }
  if (lane == 0) {
    float dw, dx, dy;
    blend_grads(k.fx, k.fy, g, dw, dx, dy);
    grad_weight[s] = from_f32<T>(dw);
    store_pair(grad_loc + 2 * s, aw * dx * wl, aw * dy * hl);
  }
}


template <int VW>
__device__ __forceinline__ float dot16(const uint4& u, const float (&go)[VW]) {
  float f[VW];
  widen(u, f);
  float a = 0.f;
#pragma unroll
  for (int v = 0; v < VW; ++v) a = fmaf(go[v], f[v], a);
  return a;
}

constexpr int kQTile = 32;  // queries a CTA of the grouped body takes

// The "grouped" body: G lanes a sample, one 16-byte vector of each corner a
// lane (D = G * 16 / sizeof(V)).  A CTA takes kQTile queries of one (n, h);
// each warp one query at a time, its L*P samples in rounds of 32.
template <typename V, typename T, int G>
__global__ void __launch_bounds__(kThreads, 3)
bwd_loc_weight_grouped(const V* __restrict__ value, const T* __restrict__ loc,
                       const T* __restrict__ weight, const V* __restrict__ dout,
                       T* __restrict__ grad_loc, T* __restrict__ grad_weight,
                       int Q, int H, int S, int L, int P, int q_tiles,
                       const __grid_constant__ Levels lv) {
  constexpr int VW = 16 / (int)sizeof(V);
  constexpr int D = G * VW;
  constexpr int NG = 32 / G;  // samples a warp holds at once
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      s_h[i] = lv.h[i];
      s_w[i] = lv.w[i];
      s_start[i] = lv.start[i];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int LP = L * P;
  const int tile = blockIdx.x % q_tiles;
  const int64_t nh = blockIdx.x / q_tiles;
  const int h = (int)(nh % H);
  const int64_t n = nh / H;
  const int64_t row = (int64_t)H * D;
  const V* vbase = value + n * (int64_t)S * row + (int64_t)h * D +
                   (lane % G) * VW;
  const int q_end = min(Q, (tile + 1) * kQTile);

  for (int q = tile * kQTile + warp; q < q_end; q += kWarps) {
    const int64_t nqh = (n * Q + q) * H + h;
    float go[VW];
    widen(__ldg(reinterpret_cast<const uint4*>(dout + nqh * D +
                                               (lane % G) * VW)),
          go);
    for (int base = 0; base < LP; base += 32) {
      const int R = min(32, LP - base);
      const int iters = (R + NG - 1) / NG;
      // lane j sets up sample base + j and collects its corner sums
      const bool own = lane < R;
      const int64_t si = nqh * LP + base + lane;
      Corners k = {0.f, 0.f, 0, 0u};
      float aw = 0.f;
      int hl = 0, wl = 0;
      if (own) {
        const int l = (base + lane) / P;
        hl = s_h[l];
        wl = s_w[l];
        k = corners(to_f32(loc[2 * si]), to_f32(loc[2 * si + 1]), hl, wl);
        k.texel += s_start[l];
        aw = to_f32(weight[si]);
      }
      const int packed = wl << 4 | (int)k.mask;
      // group grp takes samples grp * iters + it; lane j's was taken by
      // group j / iters at it = j % iters
      const int from = lane / iters;
      const int at = lane - from * iters;
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      uint4 cur[4];
      load_corners(vbase, row, k.texel, packed, grp * iters, cur);
      for (int it = 0; it < iters; ++it) {
        uint4 nxt[4] = {};
        if (it + 1 < iters)
          load_corners(vbase, row, k.texel, packed, grp * iters + it + 1,
                       nxt);
        float a[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = dot16<VW>(cur[c], go);
        const bool take = at == it;
        // corners {0, 1} | {2, 3} by bit G/2, then {0} | {1} by bit G/4,
        // then the rest of the group's lanes
        const bool hi_a = lane & (G / 2);
        float k0 = hi_a ? a[2] : a[0], k1 = hi_a ? a[3] : a[1];
        k0 += __shfl_xor_sync(kFull, hi_a ? a[0] : a[2], G / 2);
        k1 += __shfl_xor_sync(kFull, hi_a ? a[1] : a[3], G / 2);
        const bool hi_b = lane & (G / 4);
        float r = hi_b ? k1 : k0;
        r += __shfl_xor_sync(kFull, hi_b ? k0 : k1, G / 4);
#pragma unroll
        for (int off = G / 8; off > 0; off >>= 1)
          r += __shfl_xor_sync(kFull, r, off);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = __shfl_sync(
              kFull, r, from * G + (c >> 1) * (G / 2) + (c & 1) * (G / 4));
          if (take) g[c] = v;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) cur[c] = nxt[c];
      }
      if (own) {
        float dw, dx, dy;
        blend_grads(k.fx, k.fy, g, dw, dx, dy);
        grad_weight[si] = from_f32<T>(dw);
        store_pair(grad_loc + 2 * si, aw * dx * wl, aw * dy * hl);
      }
    }
  }
}

template <typename V, typename T, int G>
int launch_grouped(const void* value, const void* loc, const void* weight,
                   const void* dout, void* gl, void* gw, int N, int Q, int H,
                   int S, int L, int P, const Levels& lv,
                   cudaStream_t stream) {
  const int q_tiles = (Q + kQTile - 1) / kQTile;
  const int64_t blocks = (int64_t)N * H * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bwd_loc_weight_grouped<V, T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout),
      static_cast<T*>(gl), static_cast<T*>(gw), Q, H, S, L, P, q_tiles, lv);
  return 0;
}

template <typename V, typename T>
int launch_loc_weight(int grouped, const void* value, const void* loc,
                      const void* weight, const void* dout, void* gl,
                      void* gw, int N, int Q, int H, int D, int S, int L,
                      int P, const Levels& lv, cudaStream_t stream) {
  if (grouped) {
    switch (deform::group_lanes(D, (int)sizeof(V))) {
      case 4: return launch_grouped<V, T, 4>(value, loc, weight, dout, gl, gw,
                                             N, Q, H, S, L, P, lv, stream);
      case 8: return launch_grouped<V, T, 8>(value, loc, weight, dout, gl, gw,
                                             N, Q, H, S, L, P, lv, stream);
      case 16: return launch_grouped<V, T, 16>(value, loc, weight, dout, gl,
                                               gw, N, Q, H, S, L, P, lv,
                                               stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const int64_t samples = (int64_t)N * Q * H * L * P;
  const int64_t blocks = (samples + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bwd_loc_weight_kernel<V, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const T*>(loc),
      static_cast<const T*>(weight), static_cast<const V*>(dout),
      static_cast<T*>(gl), static_cast<T*>(gw), Q, H, D, S, L, P, samples, lv);
  return 0;
}

int check_args(int L, int P, int D) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (value and dout share one; loc and
// weight share the other).  level_hw: host array (h0, w0, h1, w1, ...).
// The plan (ops/ms_deform_attn_cuda.py::value_grad_plan): bin_warps, the
// warps of a binning CTA; shared_table 1 = its [bin_warps + 1, cells_l]
// table in shared memory (at most kMaxShared bytes), 0 = in ``table``,
// int32 [N*H, bin_warps + 1, cells] (cells = sum over levels of (h + 1) *
// (w + 1)); grouped 1 = D * itemsize 4, 8 or 16 whole 16-byte vectors,
// dout 16-byte aligned (the caller checked), 0 = lanes along D;
// group_levels: bit l set = a group a texel on level l (grouped only).
// keys: int32 [N*H, L, Q*P], ids: int32 [N*H, Q*L*P], cell_start: int32
// [N*H, cells + L], all scratch; grad_value [N, S, H, D] in the value's
// dtype, every element written.  Returns a cudaError_t code.
extern "C" int mmi_ms_deform_attn_bwd_value(
    int device, int value_dtype, int loc_dtype, int bin_warps,
    int shared_table, int grouped, int group_levels, const void* loc,
    const void* weight, const void* dout, int* keys, int* ids,
    int* cell_start, int* table, void* grad_value, int N, int S, int Q, int H,
    int D, int L, int P, const int* level_hw, void* stream) {
  int err = check_args(L, P, D);
  if (err) return err;
  Levels lv = {};
  if ((err = deform::fill_levels(level_hw, L, S, &lv))) return err;
  if ((int64_t)Q * L * P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (grouped != 0 && grouped != 1) return (int)cudaErrorInvalidValue;
  if ((int64_t)N * H * S == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    err = launch_value<float, float>(bin_warps, shared_table, grouped,
                                     group_levels, loc, weight, dout, keys,
                                     ids, cell_start, table, grad_value, N, Q,
                                     H, D, S, L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch_value<__nv_bfloat16, __nv_bfloat16>(
        bin_warps, shared_table, grouped, group_levels, loc, weight, dout, keys,
        ids, cell_start, table, grad_value, N, Q, H, D, S, L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    err = launch_value<__nv_bfloat16, float>(
        bin_warps, shared_table, grouped, group_levels, loc, weight, dout, keys,
        ids, cell_start, table, grad_value, N, Q, H, D, S, L, P, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// variant: 0 = warp (any D), 1 = grouped (D * itemsize 4, 8 or 16 whole
// 16-byte vectors; value and dout 16-byte aligned, which
// the caller checked).  grad_loc [N, Q, H, L, P, 2] and grad_weight
// [N, Q, H, L, P] in the locations' dtype, every element written.
extern "C" int mmi_ms_deform_attn_bwd_loc_weight(
    int device, int value_dtype, int loc_dtype, int variant,
    const void* value, const void* loc, const void* weight, const void* dout,
    void* grad_loc, void* grad_weight, int N, int S, int Q, int H, int D,
    int L, int P, const int* level_hw, void* stream) {
  int err = check_args(L, P, D);
  if (err) return err;
  Levels lv = {};
  if ((err = deform::fill_levels(level_hw, L, S, &lv))) return err;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (variant == 1 && !deform::group_lanes(D, value_dtype ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * Q * H * L * P == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && loc_dtype == 0) {
    err = launch_loc_weight<float, float>(variant, value, loc, weight, dout,
                                          grad_loc, grad_weight, N, Q, H, D, S,
                                          L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 1) {
    err = launch_loc_weight<__nv_bfloat16, __nv_bfloat16>(
        variant, value, loc, weight, dout, grad_loc, grad_weight, N, Q, H, D,
        S, L, P, lv, s);
  } else if (value_dtype == 1 && loc_dtype == 0) {
    err = launch_loc_weight<__nv_bfloat16, float>(
        variant, value, loc, weight, dout, grad_loc, grad_weight, N, Q, H, D,
        S, L, P, lv, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
