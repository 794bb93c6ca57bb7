// Cluster prepass kernels (K4 dense, K5 gated, K10 rows, K8 probe) for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of tpu_pathtracer/ops/intersect_pallas.py:
//   kGroups, gate == nullptr -> _kernel_prepass_groups and
//                      _kernel_prepass_groups_seg (K4, the dense grid form,
//                      reached through _prepass_groups below 16 blocks of
//                      128 clusters, and inside _quarter_gate at any size);
//   kGroups, gate != nullptr -> _kernel_prepass_groups_fused (+ _plain /
//                      _seg) (K5, the gated form): only a tile's gate-ON
//                      128-cluster blocks, and within them only the ON
//                      32-cluster quarters, are tested; everything else
//                      keeps the empty result (no group bit, tn = inf, no
//                      texit);
// and of tpu_pathtracer/ops/intersect_pallas_legacy.py:
//   kRows  -> _kernel_prepass (K10, via _prepass, feeding _cluster_list):
//             8 row bits instead of 128 group bits, and c_best;
//   kProbe -> _kernel_prepass_probe (K8, via _prepass_probe): c_best only.
// The Python side is tpu_pathtracer_torch/ops/intersect_culled.py, whose
// prepass_plain is the plain torch version of K4 and K5, and
// ops/intersect_culled_legacy.py (prepass_rows_plain, prepass_probe_plain).
//
// What it computes, per (1024-ray tile, cluster): the slab test of every ray
// of the tile against the cluster's box (t_min clamped entry, exit > 0, and
// with maxd the entry no later than the segment's end), reduced to
//   gmask  (tiles, 4, cpad) i32 (kGroups): bit b of word w = some ray of
//          group 32w+b (rays 8g .. 8g+7 of the tile) hits;
//   rowbits (tiles, cpad) i32 (kRows): bit r = some ray of row r (rays
//          128r .. 128r+127 of the tile, the OR of 16 groups) hits;
//   tn     (tiles, cpad) f32: the least entry over the tile's hitting rays;
//   texit  (rays,) f32: each ray's greatest exit over the boxes it hits, at
//          least t_min (the wrapper initialises it to t_min);
//   cbest  (rays,) u64 (kRows, kProbe): the least key (entry bits << 32 |
//          cluster id) over the boxes the ray hits, the wrapper's sentinel
//          0x7fffffff7fffffff where it hits none: the nearest touched
//          cluster, the lowest id on equal entry.
// Slab arithmetic in _prepass_block_vals' op order with IEEE ops (built with
// -fmad=false, no fast math); the min/max propagate NaN as torch.minimum and
// torch.maximum do, so NaN bounds (padding clusters) and NaN origins
// (padding rays) hit nothing. Every reduction is a min, max or OR, so the
// result does not depend on the order of evaluation and equals the plain
// version bitwise; texit is reduced across cluster blocks with atomicMax on
// the int bits of non-negative floats, which order as the floats do, and
// cbest with a 64-bit atomicMin (the entry is at least t_min > 0).
//
// What bounds it. Instruction issue: ~24 flops per (ray, cluster) pair and
// a few bytes per pair of output. One block is one (tile, 128-cluster
// block): 1024 threads, one per ray, the block's 128 boxes in shared memory
// (two 16-byte loads a box, which every lane of a warp reads at once and
// shared memory broadcasts). A warp's four 8-ray groups fold into a 4-bit
// nibble with one __ballot_sync, its least entry with one __reduce_min_sync
// on the entry's bits (positive floats order as ints); over 32 clusters,
// lane k keeps cluster k's ballot and minimum in registers and each lane
// stores its own once, and 128 threads combine the 32 warps at the end (a
// row is 4 warps), so there are no atomics on the per-cluster outputs.
//
// What the design does about it, exactly:
//   * NaN handling leaves the pair loop. The inverse direction is finite;
//     with a finite origin and direction, (bound - o) * inv is NaN only for
//     a NaN bound, so a box with a NaN bound is flagged once at staging and
//     misses, and the loop uses fminf / fmaxf, equal to the NaN-propagating
//     min / max when no argument is NaN. A warp with an open lane whose
//     origin or direction has an infinite component runs the
//     NaN-propagating arithmetic for the whole warp.
//   * Lanes that can hit no box are decided once: a NaN origin component
//     (padding lanes) and, in segment mode, maxd < t_min or NaN (the entry
//     is at least t_min); a warp whose 32 lanes are all decided skips the
//     cluster loop and stores the empty result (no group bit, tn = inf, no
//     texit), which is what the loop would have produced. Padding lanes and
//     non-facing form-factor pairs come in runs, so whole warps skip.
// The probe needs no per-cluster output and keeps only its per-ray key in
// a register. A gated-off block only writes its empty result; the TPU
// kernel's worklist of ON blocks is a grid-step-overhead workaround.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;            // rays per tile, one thread each
constexpr int kWarps = kTile / 32;
constexpr int kWarpsPerRow = 4;        // 128-ray rows
constexpr int kBlock = 128;            // clusters per block
constexpr int kQuarter = 32;           // clusters per gate bit
constexpr int kWords = 4;              // 128 group bits per cluster
constexpr unsigned kInfBits = 0x7f800000u;

enum Mode { kGroups = 0, kRows = 1, kProbe = 2 };

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

template <int MODE>
__global__ void __launch_bounds__(kTile)
prepass_kernel(const float* __restrict__ cmin, const float* __restrict__ cmax,
               int c, int cpad, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ maxd,
               float t_min, const int* __restrict__ gate,
               int* __restrict__ gmask, float* __restrict__ tn_out,
               unsigned* __restrict__ texit,
               unsigned long long* __restrict__ cbest) {
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
  const int word = gate ? gate[tile * (cpad / kBlock) + j] : 0xF;

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
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float md = 0.f;
  bool decided = true;                       // a gated-off block tests none
  if (word != 0) {                           // uniform over the block
    ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
    dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    if (maxd) md = maxd[ray];
    // a lane that hits no box: a NaN origin component makes every slab
    // NaN; the entry is at least t_min, so a segment ending before it (or
    // a NaN maxd or t_min) is never entered
    decided = (ox != ox) | (oy != oy) | (oz != oz) | (t_min != t_min) |
              (maxd && !(md >= t_min));
  }
  const float ix = 1.0f / (fabsf(dx) > 1e-8f ? dx : 1e-8f);
  const float iy = 1.0f / (fabsf(dy) > 1e-8f ? dy : 1e-8f);
  const float iz = 1.0f / (fabsf(dz) > 1e-8f ? dz : 1e-8f);
  const bool open = !__all_sync(0xffffffffu, decided);
  // an infinite origin or direction component of an open lane can make a
  // slab NaN with no NaN bound: that warp keeps the NaN-propagating
  // arithmetic (decided lanes' results are discarded)
  const bool nan_safe = __any_sync(
      0xffffffffu, !decided & !(isfinite(ox) & isfinite(oy) & isfinite(oz) &
                                isfinite(dx) & isfinite(dy) & isfinite(dz)));
  float ex = __int_as_float(0xff800000);     // -inf: no box hit yet
  unsigned long long best = ~0ull;           // no box hit yet
  for (int q = 0; q < kBlock / kQuarter; ++q) {
    unsigned my_bal = 0u;                    // lane k: cluster q*32+k's
    unsigned my_tn = kInfBits;
    // uniform over the warp: the gate word, the decided vote, nc
    if (open && ((word >> q) & 1)) {
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
        if (MODE != kGroups && hit) {
          const unsigned long long key =
              (static_cast<unsigned long long>(__float_as_uint(tn)) << 32) |
              static_cast<unsigned>(c0 + cl);
          if (key < best) best = key;
        }
        if (MODE == kProbe) continue;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        const unsigned tmin = __reduce_min_sync(
            0xffffffffu, hit ? __float_as_uint(tn) : kInfBits);
        if (hit) ex = fmaxf(ex, tf);
        if (lane == k) {
          my_bal = bal;
          my_tn = tmin;
        }
      }
    }
    if (MODE != kProbe) {
      nib[warp][q * kQuarter + lane] = static_cast<unsigned char>(
          ((my_bal & 0x000000ffu) ? 1 : 0) |
          ((my_bal & 0x0000ff00u) ? 2 : 0) |
          ((my_bal & 0x00ff0000u) ? 4 : 0) |
          ((my_bal & 0xff000000u) ? 8 : 0));
      tnw[warp][q * kQuarter + lane] = my_tn;
    }
  }
  if (MODE != kProbe && ex > 0.f) {
    atomicMax(&texit[ray], __float_as_uint(ex));
  }
  if (MODE != kGroups && best != ~0ull) atomicMin(&cbest[ray], best);
  if (MODE == kProbe) return;                // uniform: no per-cluster output
  __syncthreads();

  if (tid < kBlock) {
    unsigned tmin = kInfBits;
    unsigned words[kWords] = {0u, 0u, 0u, 0u};
    unsigned rows = 0u;
    for (int w = 0; w < kWarps; ++w) {
      tmin = min(tmin, tnw[w][tid]);
      if (MODE == kGroups) {
        words[w >> 3] |= static_cast<unsigned>(nib[w][tid]) << (4 * (w & 7));
      } else if (nib[w][tid]) {
        rows |= 1u << (w / kWarpsPerRow);
      }
    }
    const size_t col = static_cast<size_t>(c0 + tid);
    if (MODE == kGroups) {
      for (int k = 0; k < kWords; ++k) {
        gmask[(static_cast<size_t>(tile) * kWords + k) * cpad + col] =
            static_cast<int>(words[k]);
      }
    } else {
      gmask[static_cast<size_t>(tile) * cpad + col] = static_cast<int>(rows);
    }
    tn_out[static_cast<size_t>(tile) * cpad + col] = __uint_as_float(tmin);
  }
}

template <int MODE>
int launch(const float* cmin, const float* cmax, int c, int cpad,
           const float* o, const float* d, const float* maxd, int n_rays,
           float t_min, const int* gate, int* gmask, float* tn_out,
           float* texit, long long* cbest, void* stream) {
  if (n_rays % kTile || cpad % kBlock || c > cpad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const dim3 grid(cpad / kBlock, n_rays / kTile);
  prepass_kernel<MODE><<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      cmin, cmax, c, cpad, o, d, maxd, t_min, gate, gmask, tn_out,
      reinterpret_cast<unsigned*>(texit),
      reinterpret_cast<unsigned long long*>(cbest));
  return static_cast<int>(cudaGetLastError());
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
  return launch<kGroups>(cmin, cmax, c, cpad, o, d, maxd, n_rays, t_min, gate,
                         gmask, tn_out, texit, nullptr, stream);
}

// K10: rowbits and tn (tiles, cpad), texit (n_rays,) holding t_min on entry
// and cbest (n_rays,) holding the sentinel key 0x7fffffff7fffffff on entry.
int tpt_prepass_rows(const float* cmin, const float* cmax, int c, int cpad,
                     const float* o, const float* d, int n_rays, float t_min,
                     int* rowbits, float* tn_out, float* texit,
                     long long* cbest, void* stream) {
  return launch<kRows>(cmin, cmax, c, cpad, o, d, nullptr, n_rays, t_min,
                       nullptr, rowbits, tn_out, texit, cbest, stream);
}

// K8: cbest (n_rays,) only, holding the sentinel key on entry.
int tpt_prepass_probe(const float* cmin, const float* cmax, int c, int cpad,
                      const float* o, const float* d, int n_rays, float t_min,
                      long long* cbest, void* stream) {
  return launch<kProbe>(cmin, cmax, c, cpad, o, d, nullptr, n_rays, t_min,
                        nullptr, nullptr, nullptr, nullptr, cbest, stream);
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
