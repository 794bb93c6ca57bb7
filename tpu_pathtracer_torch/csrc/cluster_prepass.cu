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
// What bounds it. About 18 flops and 40 instructions per (ray, cluster)
// pair and a few bytes per pair of output: arithmetic and warp-collective
// bound. One block is one (tile, 128-cluster block): 1024 threads, one per
// ray, the block's 128 boxes in shared memory (every thread of a warp reads
// the same box, which shared memory broadcasts). A warp's four 8-ray groups
// fold into a 4-bit nibble with one __ballot_sync, its least entry with one
// __reduce_min_sync on the entry's bits (positive floats order as ints);
// lane 0 stores both per (warp, cluster) in shared memory and 128 threads
// combine the 32 warps at the end (a row is 4 warps), so there are no
// atomics on the per-cluster outputs. The probe needs no per-cluster
// output and keeps only its per-ray key in a register. A gated-off block
// only writes its empty result; the TPU kernel's worklist of ON blocks is
// a grid-step-overhead workaround.

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

template <int MODE>
__global__ void __launch_bounds__(kTile)
prepass_kernel(const float* __restrict__ cmin, const float* __restrict__ cmax,
               int c, int cpad, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ maxd,
               float t_min, const int* __restrict__ gate,
               int* __restrict__ gmask, float* __restrict__ tn_out,
               unsigned* __restrict__ texit,
               unsigned long long* __restrict__ cbest) {
  __shared__ float box[6][kBlock];
  __shared__ unsigned char nib[kWarps][kBlock];
  __shared__ unsigned tnw[kWarps][kBlock];

  const int j = blockIdx.x;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = j * kBlock;
  const int word = gate ? gate[tile * (cpad / kBlock) + j] : 0xF;

  if (MODE != kProbe) {
    for (int k = tid; k < kWarps * kBlock; k += kTile) {
      (&nib[0][0])[k] = 0;
      (&tnw[0][0])[k] = kInfBits;
    }
  }
  if (tid < kBlock && c0 + tid < c) {
    const int cl = c0 + tid;
    for (int ax = 0; ax < 3; ++ax) {
      box[ax][tid] = cmin[3 * cl + ax];
      box[3 + ax][tid] = cmax[3 * cl + ax];
    }
  }
  __syncthreads();

  if (word != 0) {
    const int ray = tile * kTile + tid;
    const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
    const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
    const float ix = 1.0f / (fabsf(dx) > 1e-8f ? dx : 1e-8f);
    const float iy = 1.0f / (fabsf(dy) > 1e-8f ? dy : 1e-8f);
    const float iz = 1.0f / (fabsf(dz) > 1e-8f ? dz : 1e-8f);
    const float md = maxd ? maxd[ray] : 0.f;
    float ex = __int_as_float(0xff800000);   // -inf: no box hit yet
    unsigned long long best = ~0ull;         // no box hit yet
    for (int q = 0; q < kBlock / kQuarter; ++q) {
      if (!((word >> q) & 1)) continue;      // uniform over the block
      for (int k = 0; k < kQuarter; ++k) {
        const int cl = q * kQuarter + k;
        bool hit = false;
        float tn = t_min;
        float tf = __int_as_float(0x7f800000);
        if (c0 + cl < c) {                   // uniform over the block
          float lo = (box[0][cl] - ox) * ix;
          float hi = (box[3][cl] - ox) * ix;
          tn = max_nan(tn, min_nan(lo, hi));
          tf = min_nan(tf, max_nan(lo, hi));
          lo = (box[1][cl] - oy) * iy;
          hi = (box[4][cl] - oy) * iy;
          tn = max_nan(tn, min_nan(lo, hi));
          tf = min_nan(tf, max_nan(lo, hi));
          lo = (box[2][cl] - oz) * iz;
          hi = (box[5][cl] - oz) * iz;
          tn = max_nan(tn, min_nan(lo, hi));
          tf = min_nan(tf, max_nan(lo, hi));
          hit = (tf >= tn) & (tf > 0.f);
          if (maxd) hit = hit & (tn <= md);
        }
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
        if (lane == 0) {
          nib[warp][cl] = static_cast<unsigned char>(
              ((bal & 0x000000ffu) ? 1 : 0) | ((bal & 0x0000ff00u) ? 2 : 0) |
              ((bal & 0x00ff0000u) ? 4 : 0) | ((bal & 0xff000000u) ? 8 : 0));
          tnw[warp][cl] = tmin;
        }
      }
    }
    if (MODE != kProbe && ex > 0.f) {
      atomicMax(&texit[ray], __float_as_uint(ex));
    }
    if (MODE != kGroups && best != ~0ull) atomicMin(&cbest[ray], best);
  }
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
