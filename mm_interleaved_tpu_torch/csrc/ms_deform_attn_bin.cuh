// The stable binning of the deformable value gradients: kernel 2
// (ms_deform_attn_bwd.cu) bins each sample by its corner cell, v4's 8b
// (ms_deform_attn_v4_bwd.cu) each of a sample's four corners by its texel.
// Both hand ``bin_samples`` one int key a bin (or -1: none) for each of a
// level's n entries, and get back the entry ids bin after bin, each bin's
// in entry order, with where each bin starts.  The bins of a level are
// ``BinLevels::bins[l]``: (h + 1) * (w + 1) cells for kernel 2, h * w
// texels for 8b.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_common.cuh"

namespace {

using deform::kFull;
using deform::kMaxLevels;
using deform::Levels;

constexpr int kMaxBinWarps = 32;
// steps of 32 keys whose loads a binning warp issues at once
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

// Per level: its bins' count (bins), where its block starts in an (n, h)'s
// bin tables (bin), where its bin offsets start in the (n, h)'s row of
// bin_start (slot: bin + l, each level keeps one end slot), and the first
// of its gather's tiles (tile; tile[L] is an (n, h)'s count).
struct BinLevels {
  int bins[kMaxLevels];
  int bin[kMaxLevels];
  int slot[kMaxLevels];
  int tile[kMaxLevels + 1];
};

// The level tables of a block, in shared memory.
struct LevelTables {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels], bins[kMaxLevels],
      bin[kMaxLevels], slot[kMaxLevels], tile[kMaxLevels + 1];
};

__device__ __forceinline__ void load_tables(LevelTables& s, const Levels& lv,
                                            const BinLevels& bl) {
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (threadIdx.x == i) {
      s.h[i] = lv.h[i];
      s.w[i] = lv.w[i];
      s.start[i] = lv.start[i];
      s.bins[i] = bl.bins[i];
      s.bin[i] = bl.bin[i];
      s.slot[i] = bl.slot[i];
      s.tile[i] = bl.tile[i];
    }
  }
  if (threadIdx.x == kMaxLevels) s.tile[kMaxLevels] = bl.tile[kMaxLevels];
  __syncthreads();
}

// Fills ``bins`` (per level: ``bins_of(h, w)``), ``bin`` and ``slot``, and
// the gather's tiles: ``per_group`` texels a tile on a level whose bit is
// set in ``group_levels``, else ``per_warp``.  Returns the bins of all
// levels, or -1 past int32.
template <typename F>
int fill_bin_levels(const Levels& lv, int L, int group_levels, int per_group,
                    int per_warp, F bins_of, BinLevels* bl) {
  int64_t bins = 0, tiles = 0;
  for (int l = 0; l < L; ++l) {
    bl->bins[l] = bins_of(lv.h[l], lv.w[l]);
    bl->bin[l] = (int)bins;
    bl->slot[l] = (int)bins + l;
    bl->tile[l] = (int)tiles;
    const int per = group_levels >> l & 1 ? per_group : per_warp;
    tiles += ((int64_t)lv.h[l] * lv.w[l] + per - 1) / per;
    bins += bl->bins[l];
    if (bins > 0x7fffffffLL - kMaxLevels || tiles > 0x7fffffffLL) return -1;
  }
  bl->tile[L] = (int)tiles;
  return (int)bins;
}

// One CTA per (n, h, level), blockDim.x / 32 warps.  The level's n entries
// (ids 0 .. n - 1), whose bins ``keys`` holds as [N*H, L, n] (-1: none),
// are binned: ids [N*H, L*n] holds, from l * n on, the level's entry ids bin
// after bin, each bin's in entry order; bin_start [N*H, bins_all + L] where
// each bin's ids begin (from slot[l]; the level's last slot is its end).
// Each warp owns a contiguous run of the entries and a row of a
// [W, bins_l] table: it counts its entries per bin (integer atomics: a
// count does not depend on their order), the rows become each warp's
// offset within each bin in warp order, the bins' totals an exclusive scan
// (the bin offsets), and each warp places its entries in entry order, 32
// at a time, ranking the lanes of a step that share a bin by
// __match_any_sync.  A bin holds its entries in entry order, whatever the
// schedule.  table: null (the [W + 1, bins_l] table in dynamic shared
// memory) or a device scratch of [N*H, W + 1, bins_all] (its level's block
// at (W + 1) * bin[l]).
__global__ void __launch_bounds__(kMaxBinWarps * 32)
bin_samples(const int* __restrict__ keys, int* __restrict__ ids,
            int* __restrict__ bin_start, int* __restrict__ gtable, int n,
            int L, int bins_all, const __grid_constant__ Levels lv,
            const __grid_constant__ BinLevels bl) {
  extern __shared__ int smem[];
  __shared__ LevelTables s;
  __shared__ int s_part[kMaxBinWarps];
  load_tables(s, lv, bl);
  const int W = blockDim.x >> 5;
  const int l = (int)(blockIdx.x % L);
  const int64_t nh = blockIdx.x / L;
  const int cells = s.bins[l];
  int* table = gtable ? gtable + (nh * bins_all + s.bin[l]) * (W + 1)
                      : smem;
  int* total = table + (int64_t)W * cells;
  for (int i = threadIdx.x; i < W * cells; i += blockDim.x) table[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = (n + W - 1) / W;
  const int s0 = min(n, warp * seg);
  const int s1 = min(n, s0 + seg);
  int* mine = table + (int64_t)warp * cells;
  const int* kl = keys + (nh * L + l) * (int64_t)n;  // this level's bins
  // kSteps steps of 32 from base on: their bins (-1: none, or past the
  // warp's run), loaded at once
  auto keys_of = [&](int base, int (&key)[kSteps]) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int i = base + 32 * u + lane;
      key[u] = i < s1 ? __ldg(kl + i) : -1;
    }
  };

  // 1. each warp counts its entries per bin in its own row
  for (int base = s0; base < s1; base += 32 * kSteps) {
    int key[kSteps];
    keys_of(base, key);
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      if (key[u] >= 0) atomicAdd(mine + key[u], 1);
  }
  __syncthreads();
  // 2. a bin's counts become the warps' offsets in it, in warp order
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
  // 3. the bins' starts: an exclusive scan of their totals, a thread a
  // contiguous run of bins, after the level's l * n; each warp's offsets
  // become its cursors
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
  int run = l * n + incl - sum;
  for (int w = 0; w < warp; ++w) run += s_part[w];
  int* cs = bin_start + nh * (int64_t)(bins_all + L) + s.slot[l];
  for (int c = c0; c < c1; ++c) {
    const int t = total[c];
    cs[c] = run;
    for (int w = 0; w < W; ++w) table[(int64_t)w * cells + c] += run;
    run += t;
  }
  if (threadIdx.x == blockDim.x - 1) cs[cells] = run;
  __syncthreads();
  // 4. each warp places its entries in entry order: a lane's rank among
  // the lanes of its step that share its bin, after the bin's cursor
  int* out = ids + nh * (int64_t)L * n;
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

// Launches bin_samples on ``keys`` (n a level) with ``bin_warps`` warps a
// CTA, its table in shared memory (``table`` null; at most kMaxShared
// bytes for the largest level's) or in ``table``; returns a cudaError_t
// code.
inline int launch_bins(int bin_warps, int* table, const int* keys, int* ids,
                       int* bin_start, int64_t nh, int n, int L,
                       int bins_all, const Levels& lv, const BinLevels& bl,
                       cudaStream_t stream) {
  if (bin_warps < 1 || bin_warps > kMaxBinWarps)
    return (int)cudaErrorInvalidValue;
  if (nh * L > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  size_t smem = 0;
  if (table == nullptr) {
    int most = 0;
    for (int l = 0; l < L; ++l) most = max(most, bl.bins[l]);
    smem = (size_t)(bin_warps + 1) * most * sizeof(int);
    if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        bin_samples, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bin_samples<<<(unsigned)(nh * L), bin_warps * 32, smem, stream>>>(
      keys, ids, bin_start, table, n, L, bins_all, lv, bl);
  return (int)cudaGetLastError();
}

}  // namespace
