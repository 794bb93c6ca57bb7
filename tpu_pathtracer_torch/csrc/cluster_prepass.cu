// Cluster prepass kernels (K4 dense, K5 gated, K10 rows, K8 probe) for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of tpu_pathtracer/ops/intersect_pallas.py:
//   prepass_kernel<kGroups> -> _kernel_prepass_groups and
//                      _kernel_prepass_groups_seg (K4, the dense grid form,
//                      reached through _prepass_groups below 16 blocks of
//                      128 clusters, and inside _quarter_gate at any size);
//   tile_kernel<kGroupWords, *> -> _kernel_prepass_groups_fused (+ _plain /
//                      _seg) (K5, the gated form): only a tile's gate-ON
//                      32-cluster quarters are tested; everything else
//                      keeps the empty result (no group bit, tn = inf, no
//                      texit). The culled queries pass every quarter ON:
//                      the kernel's warp cull does _quarter_gate's work;
// and of tpu_pathtracer/ops/intersect_pallas_legacy.py:
//   tile_kernel<kRowBits, false> -> _kernel_prepass (K10, via _prepass,
//             feeding _cluster_list): 8 row bits instead of 128 group bits,
//             and c_best;
//   tile_kernel<kProbe, false> -> _kernel_prepass_probe (K8, via
//             _prepass_probe): c_best only.
// The Python side is tpu_pathtracer_torch/ops/intersect_culled.py, whose
// prepass_plain is the plain torch version of K4 and K5, and
// ops/intersect_culled_legacy.py (prepass_rows_plain, prepass_probe_plain).
//
// What it computes, per (1024-ray tile, cluster): the slab test of every ray
// of the tile against the cluster's box (t_min clamped entry, exit > 0, and
// with maxd the entry no later than the segment's end), reduced to
//   gmask  (tiles, 4, cpad) i32 (K4, K5): bit b of word w = some ray of
//          group 32w+b (rays 8g .. 8g+7 of the tile) hits;
//   rowbits (tiles, cpad) i32 (K10): bit r = some ray of row r (rays
//          128r .. 128r+127 of the tile, the OR of 16 groups) hits;
//   tn     (tiles, cpad) f32: the least entry over the tile's hitting rays;
//   texit  (rays,) f32: each ray's greatest exit over the boxes it hits, at
//          least t_min (the wrapper initialises it to t_min);
//   cbest  (rays,) u64 (K10, K8): the least key (entry bits << 32 |
//          cluster id) over the boxes the ray hits, the wrapper's sentinel
//          0x7fffffff7fffffff where it hits none: the nearest touched
//          cluster, the lowest id on equal entry.
// Slab arithmetic in _prepass_block_vals' op order with IEEE ops (built with
// -fmad=false, no fast math); the min/max propagate NaN as torch.minimum and
// torch.maximum do, so NaN bounds (padding clusters) and NaN origins
// (padding rays) hit nothing. Every reduction is a min, max or OR, so the
// result does not depend on the order of evaluation and equals the plain
// version bitwise; texit is reduced across cluster spans with atomicMax on
// the int bits of non-negative floats, which order as the floats do, and
// cbest with a 64-bit atomicMin (the entry is at least t_min > 0).
//
// What bounds them. Instruction issue: ~24 flops per (ray, cluster) pair
// plus the hit test and its reductions, and a few bytes per pair of output.
// Under -fmad=false a pair is ~28-35 instructions, so the floor is the pair
// count over ~3.3e13 instructions a second.
//
// K4 (prepass_kernel): one block is one (tile, 128-cluster block),
// 1024 threads, one per ray, the block's 128 boxes in shared memory. A
// warp's four 8-ray groups fold into a 4-bit nibble with one __ballot_sync
// per pair, its least entry with one __reduce_min_sync on the entry's bits
// (positive floats order as ints); lane k keeps cluster k's ballot and
// minimum, and 128 threads combine the 32 warps at the end. NaN handling
// leaves the pair loop (a box with a NaN bound is flagged at staging; a
// warp with an open lane whose origin or direction has an infinite
// component runs the NaN-propagating arithmetic), and a warp whose lanes
// are all decided (NaN origin; in segment mode maxd < t_min or NaN) skips
// the loop.
//
// K5, K10 and K8 (tile_kernel): register tiles instead of per-pair warp
// work.
//   * A thread holds 4 rays (half an 8-ray group: 4 origins and inverse
//     directions in registers) and walks the span's boxes from shared
//     memory; its hit bit and least entry for a cluster are an OR and a
//     min inside the thread. A warp is 128 rays, one row: its ballot of
//     the lanes' bits for a cluster is that cluster's row bit (K10: any
//     bit) or 16 group bits (K5: lanes 2j and 2j+1 are group j). The warp
//     merges (one ballot, one __reduce_min_sync, the lane select) run once
//     per cluster over 4 pairs a lane; the 8 warps of a tile merge tn,
//     the group words' halves and the row bits once per block in shared
//     memory.
//   * A block is 256 threads: one tile against a span of 1, 2 or 4
//     quarters of 32 clusters, the most that still give the grid 8 blocks
//     an SM (stress100k's 64 tiles x 795 clusters: 1,792 blocks of one
//     quarter; the 1M scene's 64 x 7,844: 3,968 of four), so there is no
//     1.7-wave tail and a thread's 12 divisions (inverse directions) are
//     spread over at least 32 clusters. 8 rays a thread (80-96 registers,
//     a 256-ray warp, whose cull fires less) ran slower on the 1M scene's
//     rays and no faster on stress100k's.
//   * Quarter cull: a warp whose open rays all miss a quarter's union box
//     (the min / max of its real boxes, built once per block) skips the
//     quarter's 32 clusters. Exact: the slab is monotone under box
//     inclusion ((lo - o) * inv rounds monotonely in lo), so a ray that
//     misses the union misses each member; a ray with an infinite
//     direction component hits nothing, with NaN-propagating arithmetic
//     in both tests.
//   * K5's gated-off spans write the empty result and exit before staging
//     boxes or loading rays; K5's ON quarters are cut further by the cull.
//   * Decided rays: in segment mode maxd is replaced by NaN (the entry test
//     fails); in ray mode (NaN origins) a warp holding one runs the
//     NaN-propagating arithmetic, and a warp of decided rays skips.
//   * K10 and K8 keep each ray's least (entry bits, cluster id) in
//     registers: clusters are walked in id order, so a strictly smaller
//     entry wins and equal entries keep the lower id; one 64-bit atomicMin
//     per ray and span with a hit.
//   * K8 (kProbe) has no per-cluster output: no ballot, no warp min, no
//     block merge and no shared merge arrays; a pair is the slab, the hit
//     test and the key compare (122 SASS instructions a cluster of 4
//     rays, ~30.5 a pair, against K10's 147). Without the merge a span may
//     take up to 8 quarters (one union box a warp); the span is the most
//     quarters that still give the grid 16 blocks an SM (probe_quarters).
//     On the H100 (kernel_ab.py --cases sweep, device time, ms; spans of
//     1, 2, 4, 8 quarters) stress100k's bounce rays took 0.084, 0.088,
//     0.097, 0.098 and its camera rays 0.041, 0.046, 0.058, 0.081 (64
//     tiles x 28 quarters: one quarter, 1,792 blocks); the 1M scene's
//     bounce rays 0.479, 0.442, 0.432, 0.438 and camera rays 0.127,
//     0.095, 0.092, 0.109 (248 quarters: four, 3,968 blocks). Wider spans
//     leave SMs idle at the end of the grid; a block per quarter repeats
//     the rays' loads and divisions too often on the 1M scene. The sweep
//     forces the span by replacing probe_quarters' return line as text
//     (kernel_ab.py's SWEEPS holds it exactly): change both together.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int kTile = 1024;            // rays per tile
constexpr int kWarps = kTile / 32;     // prepass_kernel: one thread a ray
constexpr int kBlock = 128;            // clusters per block (gate word)
constexpr int kQuarter = 32;           // clusters per gate bit
constexpr int kWords = 4;              // 128 group bits per cluster
constexpr int kRays = 4;               // tile_kernel: rays per thread
constexpr int kTileThreads = kTile / kRays;       // 256: one tile
constexpr int kTileWarps = kTileThreads / 32;     // 8: one 128-ray row each
constexpr int kSpanBlocks = 8;         // tile_kernel blocks an SM to aim at
constexpr int kProbeBlocks = 16;       // K8's aim (probe_quarters)
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kFull = 0xffffffffu;

// tile_kernel's outputs: K5's group words, K10's row bits, K8's c_best only
enum TileMode { kGroupWords = 0, kRowBits = 1, kProbe = 2 };

// The most quarters a tile_kernel block takes: one 128-cluster gate word
// and block merge, or for K8 one quarter a warp (its union box).
__host__ __device__ constexpr int max_quarters(int mode) {
  return mode == kProbe ? kTileWarps : kBlock / kQuarter;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One axis of the slab test: the running entry tn and exit tf against the
// box's bounds lo, hi on that axis, with NaN-propagating min / max (NAN_SAFE)
// or the plain ones (no argument may then be NaN).
template <bool NAN_SAFE>
__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float& tn, float& tf) {
  const float a = (lo - o) * inv;
  const float b = (hi - o) * inv;
  if (NAN_SAFE) {
    tn = max_nan(tn, min_nan(a, b));
    tf = min_nan(tf, max_nan(a, b));
  } else {
    tn = fmaxf(tn, fminf(a, b));
    tf = fminf(tf, fmaxf(a, b));
  }
}

template <bool NAN_SAFE>
__device__ __forceinline__ void slab(const float4& lo, const float4& hi,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float& tn,
                                     float& tf) {
  slab_axis<NAN_SAFE>(lo.x, hi.x, ox, ix, tn, tf);
  slab_axis<NAN_SAFE>(lo.y, hi.y, oy, iy, tn, tf);
  slab_axis<NAN_SAFE>(lo.z, hi.z, oz, iz, tn, tf);
}

// The slab test from scratch: tn = max(t_min, entry), tf = exit. The plain
// form drops the first axis' min against +inf, which changes nothing when
// no argument is NaN.
template <bool NAN_SAFE>
__device__ __forceinline__ void slab_from(const float4& lo, const float4& hi,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float t_min, float& tn, float& tf) {
  if (NAN_SAFE) {
    tn = t_min;
    tf = __int_as_float(0x7f800000);
    slab<true>(lo, hi, ox, oy, oz, ix, iy, iz, tn, tf);
  } else {
    const float a = (lo.x - ox) * ix;
    const float b = (hi.x - ox) * ix;
    tn = fmaxf(t_min, fminf(a, b));
    tf = fmaxf(a, b);
    slab_axis<false>(lo.y, hi.y, oy, iy, tn, tf);
    slab_axis<false>(lo.z, hi.z, oz, iz, tn, tf);
  }
}

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) > 1e-8f ? x : 1e-8f);
}

// K4: one thread per ray, one block per (tile, 128-cluster block).
__global__ void __launch_bounds__(kTile)
prepass_kernel(const float* __restrict__ cmin, const float* __restrict__ cmax,
               int c, int cpad, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ maxd,
               float t_min, int* __restrict__ gmask,
               float* __restrict__ tn_out, unsigned* __restrict__ texit) {
  // box[k][0] = (min, 1 if a bound is NaN else 0), box[k][1] = (max, 0)
  __shared__ float4 box[kBlock][2];
  __shared__ unsigned char nib[kWarps][kBlock];
  __shared__ unsigned tnw[kWarps][kBlock];

  const int j = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = j * kBlock;
  const int nc = min(kBlock, c - c0);        // the block's real clusters

  if (tid < nc) {
    const int cl = c0 + tid;
    float4 lo, hi;
    lo.x = cmin[3 * cl];
    lo.y = cmin[3 * cl + 1];
    lo.z = cmin[3 * cl + 2];
    hi.x = cmax[3 * cl];
    hi.y = cmax[3 * cl + 1];
    hi.z = cmax[3 * cl + 2];
    const bool nan_bound = (lo.x != lo.x) | (lo.y != lo.y) | (lo.z != lo.z) |
                           (hi.x != hi.x) | (hi.y != hi.y) | (hi.z != hi.z);
    lo.w = nan_bound ? 1.f : 0.f;
    hi.w = 0.f;
    box[tid][0] = lo;
    box[tid][1] = hi;
  }
  __syncthreads();

  const int ray = tile * kTile + tid;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float md = maxd ? maxd[ray] : 0.f;
  // a lane that hits no box: a NaN origin component makes every slab NaN;
  // the entry is at least t_min, so a segment ending before it (or a NaN
  // maxd or t_min) is never entered
  const bool decided = (ox != ox) | (oy != oy) | (oz != oz) |
                       (t_min != t_min) | (maxd && !(md >= t_min));
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const bool open = !__all_sync(kFull, decided);
  // an infinite origin or direction component of an open lane can make a
  // slab NaN with no NaN bound: that warp keeps the NaN-propagating
  // arithmetic (decided lanes' results are discarded)
  const bool nan_safe = __any_sync(
      kFull, !decided & !(isfinite(ox) & isfinite(oy) & isfinite(oz) &
                          isfinite(dx) & isfinite(dy) & isfinite(dz)));
  float ex = __int_as_float(0xff800000);     // -inf: no box hit yet
  for (int q = 0; q < kBlock / kQuarter; ++q) {
    unsigned my_bal = 0u;                    // lane k: cluster q*32+k's
    unsigned my_tn = kInfBits;
    if (open) {                              // uniform over the warp
      const int kc = min(kQuarter, nc - q * kQuarter);
      for (int k = 0; k < kc; ++k) {
        const int cl = q * kQuarter + k;
        const float4 lo = box[cl][0];
        const float4 hi = box[cl][1];
        float tn = t_min;
        float tf = __int_as_float(0x7f800000);
        if (nan_safe) {
          slab<true>(lo, hi, ox, oy, oz, ix, iy, iz, tn, tf);
        } else {
          slab<false>(lo, hi, ox, oy, oz, ix, iy, iz, tn, tf);
        }
        bool hit = !decided & (lo.w == 0.f) & (tf >= tn) & (tf > 0.f);
        if (maxd) hit = hit & (tn <= md);
        const unsigned bal = __ballot_sync(kFull, hit);
        const unsigned tmin = __reduce_min_sync(
            kFull, hit ? __float_as_uint(tn) : kInfBits);
        if (hit) ex = fmaxf(ex, tf);
        if (lane == k) {
          my_bal = bal;
          my_tn = tmin;
        }
      }
    }
    nib[warp][q * kQuarter + lane] = static_cast<unsigned char>(
        ((my_bal & 0x000000ffu) ? 1 : 0) |
        ((my_bal & 0x0000ff00u) ? 2 : 0) |
        ((my_bal & 0x00ff0000u) ? 4 : 0) |
        ((my_bal & 0xff000000u) ? 8 : 0));
    tnw[warp][q * kQuarter + lane] = my_tn;
  }
  if (ex > 0.f) atomicMax(&texit[ray], __float_as_uint(ex));
  __syncthreads();

  if (tid < kBlock) {
    unsigned tmin = kInfBits;
    unsigned words[kWords] = {0u, 0u, 0u, 0u};
    for (int w = 0; w < kWarps; ++w) {
      tmin = min(tmin, tnw[w][tid]);
      words[w >> 3] |= static_cast<unsigned>(nib[w][tid]) << (4 * (w & 7));
    }
    const size_t col = static_cast<size_t>(c0 + tid);
    for (int k = 0; k < kWords; ++k) {
      gmask[(static_cast<size_t>(tile) * kWords + k) * cpad + col] =
          static_cast<int>(words[k]);
    }
    tn_out[static_cast<size_t>(tile) * cpad + col] = __uint_as_float(tmin);
  }
}

// The 16 bits (b[2j] | b[2j+1]) of a 32-bit ballot, bit j each.
__device__ __forceinline__ unsigned pack_pairs(unsigned b) {
  unsigned x = (b | (b >> 1)) & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// A thread's 4 rays (half an 8-ray group): origins, inverse directions,
// maxd (NaN for a decided ray: its entry test fails), greatest exit, and
// for K10 the least (entry bits, cluster id).
struct Rays {
  float ox[kRays], oy[kRays], oz[kRays];
  float ix[kRays], iy[kRays], iz[kRays];
  float md[kRays];
  float ex[kRays];
  unsigned bb[kRays];
  int bid[kRays];
};

// Does some ray of the thread slab-hit the box (lo, hi)?
template <bool NAN_SAFE, bool HAS_MAXD>
__device__ __forceinline__ bool some_hit(const Rays& g, const float4& lo,
                                         const float4& hi, float t_min) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    float tn, tf;
    slab_from<NAN_SAFE>(lo, hi, g.ox[r], g.oy[r], g.oz[r], g.ix[r], g.iy[r],
                        g.iz[r], t_min, tn, tf);
    bool h = (tf >= tn) & (tf > 0.f);
    if (HAS_MAXD) h = h & (tn <= g.md[r]);
    any |= h;
  }
  return any;
}

// One quarter's kc clusters (boxes bx[0 .. kc)) against a warp's rays:
// lane k ends with cluster k's ballot (bit l: some ray of lane l hits) and
// least entry bits (K5, K10); K10 and K8 fold each hit into the ray's
// least (entry bits, cluster id), K8 nothing else.
template <bool NAN_SAFE, int MODE, bool HAS_MAXD>
__device__ __forceinline__ void quarter(Rays& g, const float4 (*bx)[2],
                                        int kc, int cl0, float t_min,
                                        int lane, unsigned& my_bal,
                                        unsigned& my_tn) {
  for (int k = 0; k < kc; ++k) {
    const float4 lo = bx[k][0];
    const float4 hi = bx[k][1];
    bool any = false;
    float tmin = __int_as_float(0x7f800000);
    if (lo.w == 0.f) {                       // uniform: a NaN bound misses
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float tn, tf;
        slab_from<NAN_SAFE>(lo, hi, g.ox[r], g.oy[r], g.oz[r], g.ix[r],
                            g.iy[r], g.iz[r], t_min, tn, tf);
        bool h = (tf >= tn) & (tf > 0.f);
        if (HAS_MAXD) h = h & (tn <= g.md[r]);
        if (MODE != kProbe) {
          any |= h;
          if (h) {
            tmin = fminf(tmin, tn);
            g.ex[r] = fmaxf(g.ex[r], tf);
          }
        }
        if (MODE != kGroupWords) {
          const unsigned b = __float_as_uint(tn);
          if (h && b < g.bb[r]) {
            g.bb[r] = b;
            g.bid[r] = cl0 + k;
          }
        }
      }
    }
    if (MODE != kProbe) {
      const unsigned bal = __ballot_sync(kFull, any);
      const unsigned tw = __reduce_min_sync(kFull, __float_as_uint(tmin));
      if (lane == k) {
        my_bal = bal;
        my_tn = tw;
      }
    }
  }
}

// The block merge's arrays: per warp and cluster of the span, the ballot
// and the least entry bits. K8 has no per-cluster output and none.
template <int MODE>
struct BlockMerge {
  unsigned tnw[kTileWarps][kBlock];
  unsigned balw[kTileWarps][kBlock];
};
template <>
struct BlockMerge<kProbe> {};

// K5 (kGroupWords: gate words), K10 (kRowBits: no gate, no maxd) and K8
// (kProbe: no gate, no maxd, c_best only): one block is one tile (256
// threads, 4 rays each) against a span of nq 32-cluster quarters,
// blockIdx.x = the span.
template <int MODE, bool HAS_MAXD>
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const float* __restrict__ cmin, const float* __restrict__ cmax,
            int c, int cpad, int nq, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ maxd,
            float t_min, const int* __restrict__ gate,
            int* __restrict__ bits_out, float* __restrict__ tn_out,
            unsigned* __restrict__ texit,
            unsigned long long* __restrict__ cbest) {
  constexpr int kSpan = max_quarters(MODE) * kQuarter;
  // box[k][0] = (min, 1 if a bound is NaN or k is past c else 0),
  // box[k][1] = (max, 0); uni[q] the union of quarter q's real boxes
  // (w = 1: it has none)
  __shared__ float4 box[kSpan][2];
  __shared__ float4 uni[max_quarters(MODE)][2];
  __shared__ BlockMerge<MODE> merge;

  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int span = nq * kQuarter;
  const int c0 = blockIdx.x * span;
  const int nc = min(span, c - c0);          // the span's real clusters
  int word = (1 << nq) - 1;                  // the span's quarters
  if (gate) {
    word &= gate[tile * (cpad / kBlock) + c0 / kBlock] >>
            ((c0 % kBlock) / kQuarter);
  }
  if (word == 0 || nc <= 0) {                // uniform: the empty result
    if (MODE != kProbe && tid < span) {
      const size_t col = static_cast<size_t>(c0 + tid);
      constexpr int kOut = MODE == kRowBits ? 1 : kWords;
      for (int w = 0; w < kOut; ++w) {
        bits_out[(static_cast<size_t>(tile) * kOut + w) * cpad + col] = 0;
      }
      tn_out[static_cast<size_t>(tile) * cpad + col] =
          __uint_as_float(kInfBits);
    }
    return;
  }

  if (tid < span) {
    float4 lo = make_float4(0.f, 0.f, 0.f, 1.f);
    float4 hi = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < nc) {
      const int cl = c0 + tid;
      lo.x = cmin[3 * cl];
      lo.y = cmin[3 * cl + 1];
      lo.z = cmin[3 * cl + 2];
      hi.x = cmax[3 * cl];
      hi.y = cmax[3 * cl + 1];
      hi.z = cmax[3 * cl + 2];
      const bool nan_bound = (lo.x != lo.x) | (lo.y != lo.y) |
                             (lo.z != lo.z) | (hi.x != hi.x) |
                             (hi.y != hi.y) | (hi.z != hi.z);
      lo.w = nan_bound ? 1.f : 0.f;
    }
    box[tid][0] = lo;
    box[tid][1] = hi;
  }
  __syncthreads();
  if (warp < nq) {                           // warp q: quarter q's union
    const float4 lo = box[tid][0];
    const float4 hi = box[tid][1];
    const bool real = lo.w == 0.f;
    const float inf = __int_as_float(0x7f800000);
    float ux = real ? lo.x : inf, uy = real ? lo.y : inf,
          uz = real ? lo.z : inf;
    float vx = real ? hi.x : -inf, vy = real ? hi.y : -inf,
          vz = real ? hi.z : -inf;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ux = fminf(ux, __shfl_xor_sync(kFull, ux, off));
      uy = fminf(uy, __shfl_xor_sync(kFull, uy, off));
      uz = fminf(uz, __shfl_xor_sync(kFull, uz, off));
      vx = fmaxf(vx, __shfl_xor_sync(kFull, vx, off));
      vy = fmaxf(vy, __shfl_xor_sync(kFull, vy, off));
      vz = fmaxf(vz, __shfl_xor_sync(kFull, vz, off));
    }
    const bool some = __any_sync(kFull, real);
    if (lane == 0) {
      uni[warp][0] = make_float4(ux, uy, uz, some ? 0.f : 1.f);
      uni[warp][1] = make_float4(vx, vy, vz, 0.f);
    }
  }
  __syncthreads();

  Rays g;
  const int ray0 = tile * kTile + tid * kRays;
  bool open_ray = false;                     // some ray of the thread
  bool nonfinite = false;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = ray0 + r;
    const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
    const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    const float m = HAS_MAXD ? maxd[ray] : 0.f;
    // hits no box: a NaN origin component makes every slab NaN; the entry
    // is at least t_min, so a segment ending before it (or a NaN maxd or
    // t_min) is never entered
    const bool decided = (ox != ox) | (oy != oy) | (oz != oz) |
                         (t_min != t_min) | (HAS_MAXD && !(m >= t_min));
    const bool finite = isfinite(ox) & isfinite(oy) & isfinite(oz) &
                        isfinite(dx) & isfinite(dy) & isfinite(dz);
    g.ox[r] = ox;
    g.oy[r] = oy;
    g.oz[r] = oz;
    g.ix[r] = inv_dir(dx);
    g.iy[r] = inv_dir(dy);
    g.iz[r] = inv_dir(dz);
    g.md[r] = decided ? __int_as_float(0x7fc00000) : m;
    g.ex[r] = __int_as_float(0xff800000);    // -inf: no box hit yet
    g.bb[r] = ~0u;
    g.bid[r] = 0;
    open_ray |= !decided;
    // an infinite component can make a slab NaN with no NaN bound; in ray
    // mode a decided ray (NaN origin) is kept from hitting by NaN
    nonfinite |= !finite & (!HAS_MAXD | !decided);
  }
  const bool open = __any_sync(kFull, open_ray);
  const bool nan_safe = __any_sync(kFull, nonfinite);

  for (int q = 0; q < nq; ++q) {
    unsigned my_bal = 0u;                    // lane k: cluster q*32+k's
    unsigned my_tn = kInfBits;
    const int kc = min(kQuarter, nc - q * kQuarter);
    const float4 ulo = uni[q][0];
    const float4 uhi = uni[q][1];
    // uniform over the warp: the vote, the gate word, the union's flag
    if (open && ((word >> q) & 1) && kc > 0 && ulo.w == 0.f) {
      const int cl0 = c0 + q * kQuarter;
      const float4 (*bx)[2] = box + q * kQuarter;
      if (nan_safe) {
        if (__any_sync(kFull, some_hit<true, HAS_MAXD>(g, ulo, uhi, t_min))) {
          quarter<true, MODE, HAS_MAXD>(g, bx, kc, cl0, t_min, lane, my_bal,
                                        my_tn);
        }
      } else if (__any_sync(kFull,
                            some_hit<false, HAS_MAXD>(g, ulo, uhi, t_min))) {
        quarter<false, MODE, HAS_MAXD>(g, bx, kc, cl0, t_min, lane, my_bal,
                                       my_tn);
      }
    }
    if constexpr (MODE != kProbe) {
      merge.balw[warp][q * kQuarter + lane] = my_bal;
      merge.tnw[warp][q * kQuarter + lane] = my_tn;
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    if (MODE != kProbe && g.ex[r] > 0.f) {
      atomicMax(&texit[ray0 + r], __float_as_uint(g.ex[r]));
    }
    if (MODE != kGroupWords && g.bb[r] != ~0u) {
      atomicMin(&cbest[ray0 + r],
                (static_cast<unsigned long long>(g.bb[r]) << 32) |
                    static_cast<unsigned>(g.bid[r]));
    }
  }
  if constexpr (MODE != kProbe) {            // the per-cluster outputs
    __syncthreads();
    if (tid < span) {
      unsigned tmin = kInfBits;
      unsigned rows = 0u;
      unsigned half[kTileWarps];             // warp w: groups 16w .. 16w+15
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) {
        tmin = min(tmin, merge.tnw[w][tid]);
        rows |= (merge.balw[w][tid] ? 1u : 0u) << w;
        half[w] = pack_pairs(merge.balw[w][tid]);
      }
      const size_t col = static_cast<size_t>(c0 + tid);
      if (MODE == kRowBits) {
        bits_out[static_cast<size_t>(tile) * cpad + col] = rows;
      } else {                               // word k: warps 2k and 2k+1
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          bits_out[(static_cast<size_t>(tile) * kWords + k) * cpad + col] =
              static_cast<int>(half[2 * k] | (half[2 * k + 1] << 16));
        }
      }
      tn_out[static_cast<size_t>(tile) * cpad + col] = __uint_as_float(tmin);
    }
  }
}

// Quarters a tile_kernel block takes: the most (most, a power of two, then
// halved down to 1) that still give the grid `aim` blocks an SM (fewer
// spans, fewer texit and c_best atomics and ray loads).
int span_quarters(int tiles, int cpad, int most, int aim) {
  const int quarters = cpad / kQuarter;
  return most / fewest_parts(most, aim, [=](int parts) {
    const int nq = most / parts;
    return static_cast<long long>(tiles) * ((quarters + nq - 1) / nq);
  });
}

// K5's and K10's span (4 quarters at most: one gate word, one block merge).
int tile_quarters(int tiles, int cpad) {
  return span_quarters(tiles, cpad, kBlock / kQuarter, kSpanBlocks);
}

// K8's span (8 quarters at most).
int probe_quarters(int tiles, int cpad) {
  return span_quarters(tiles, cpad, max_quarters(kProbe), kProbeBlocks);
}

bool bad_shape(int n_rays, int c, int cpad) {
  return n_rays % kTile || cpad % kBlock || c > cpad || n_rays / kTile > 65535;
}

template <int MODE, bool HAS_MAXD>
int launch_tiles(const float* cmin, const float* cmax, int c, int cpad,
                 const float* o, const float* d, const float* maxd,
                 int n_rays, float t_min, const int* gate, int* bits_out,
                 float* tn_out, float* texit, long long* cbest,
                 void* stream) {
  const int tiles = n_rays / kTile;
  const int nq = MODE == kProbe ? probe_quarters(tiles, cpad)
                                : tile_quarters(tiles, cpad);
  const int span = kQuarter * nq;
  const dim3 grid((cpad + span - 1) / span, tiles);
  tile_kernel<MODE, HAS_MAXD>
      <<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          cmin, cmax, c, cpad, nq, o, d, maxd, t_min, gate, bits_out, tn_out,
          reinterpret_cast<unsigned*>(texit),
          reinterpret_cast<unsigned long long*>(cbest));
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int shape_of(Kernel kernel, int blocks, int threads, int quarters,
             int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = threads;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.numRegs;
  out[4] = quarters;
  return 0;
}

}  // namespace

extern "C" {

// The prepass over n_rays = 1024 * tiles rays and c cluster boxes ((c, 3)
// f32 each; cpad = c rounded up to whole 128-cluster blocks). maxd may be
// null (rays) and gate may be null (dense, K4); with gate ((tiles, cpad /
// 128) i32 words) it is K5. texit must hold t_min on entry. Returns the
// CUDA error code of the launch (0 = cudaSuccess).
int tpt_prepass(const float* cmin, const float* cmax, int c, int cpad,
                const float* o, const float* d, const float* maxd, int n_rays,
                float t_min, const int* gate, int* gmask, float* tn_out,
                float* texit, void* stream) {
  if (bad_shape(n_rays, c, cpad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  if (gate == nullptr) {
    const dim3 grid(cpad / kBlock, n_rays / kTile);
    prepass_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        cmin, cmax, c, cpad, o, d, maxd, t_min, gmask, tn_out,
        reinterpret_cast<unsigned*>(texit));
    return static_cast<int>(cudaGetLastError());
  }
  if (maxd) {
    return launch_tiles<kGroupWords, true>(cmin, cmax, c, cpad, o, d, maxd,
                                           n_rays, t_min, gate, gmask, tn_out,
                                           texit, nullptr, stream);
  }
  return launch_tiles<kGroupWords, false>(cmin, cmax, c, cpad, o, d, nullptr,
                                          n_rays, t_min, gate, gmask, tn_out,
                                          texit, nullptr, stream);
}

// K10: rowbits and tn (tiles, cpad), texit (n_rays,) holding t_min on entry
// and cbest (n_rays,) holding the sentinel key 0x7fffffff7fffffff on entry.
int tpt_prepass_rows(const float* cmin, const float* cmax, int c, int cpad,
                     const float* o, const float* d, int n_rays, float t_min,
                     int* rowbits, float* tn_out, float* texit,
                     long long* cbest, void* stream) {
  if (bad_shape(n_rays, c, cpad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  return launch_tiles<kRowBits, false>(cmin, cmax, c, cpad, o, d, nullptr,
                                       n_rays, t_min, nullptr, rowbits,
                                       tn_out, texit, cbest, stream);
}

// K8: cbest (n_rays,) only, holding the sentinel key on entry.
int tpt_prepass_probe(const float* cmin, const float* cmax, int c, int cpad,
                      const float* o, const float* d, int n_rays, float t_min,
                      long long* cbest, void* stream) {
  if (bad_shape(n_rays, c, cpad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  return launch_tiles<kProbe, false>(cmin, cmax, c, cpad, o, d, nullptr,
                                     n_rays, t_min, nullptr, nullptr, nullptr,
                                     nullptr, cbest, stream);
}

// The launch of `kernel` (0 K4, 1 K5 on rays, 2 K5 on segments, 3 K8, 4
// K10) at n_rays rays and cpad padded clusters: out[0..5) = blocks,
// threads a block, static shared bytes a block, registers a thread, and
// the 32-cluster quarters a block takes (4 for K4).
int tpt_prepass_shape(int kernel, int n_rays, int cpad, int* out) {
  if (bad_shape(n_rays, 0, cpad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = n_rays / kTile;
  const int nq = kernel == 3 ? probe_quarters(tiles, cpad)
                             : tile_quarters(tiles, cpad);
  const int spans = (cpad + kQuarter * nq - 1) / (kQuarter * nq);
  const int blocks = tiles * spans;
  switch (kernel) {
    case 0:
      return shape_of(prepass_kernel, tiles * (cpad / kBlock), kTile, 4, out);
    case 1:
      return shape_of(tile_kernel<kGroupWords, false>, blocks, kTileThreads,
                      nq, out);
    case 2:
      return shape_of(tile_kernel<kGroupWords, true>, blocks, kTileThreads,
                      nq, out);
    case 3:
      return shape_of(tile_kernel<kProbe, false>, blocks, kTileThreads, nq,
                      out);
    case 4:
      return shape_of(tile_kernel<kRowBits, false>, blocks, kTileThreads,
                      nq, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
