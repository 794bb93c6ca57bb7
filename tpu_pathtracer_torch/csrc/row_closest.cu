// Row-granular culled closest-hit kernel (K11) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel _kernel_culled_dma of
// tpu_pathtracer/ops/intersect_pallas_legacy.py, reached through
// pallas_closest_tuv_dma: the walk of CulledScene(grouped=False) and of
// CulledScene(sort_rays=True). The Python side is
// tpu_pathtracer_torch/ops/intersect_culled_legacy.py, whose
// closest_rows_plain is the plain torch version of the same function.
//
// What it computes. Rays come in 1024-ray tiles of 8 rows of 128
// consecutive rays; the triangles in an ordered (tpad, 16) pack of 128-row
// clusters (row: inv (9) | inv @ v0 (3) | prim (f32) | original triangle
// index (int32 bits) | pad). For each tile the K10 prepass and
// cluster_list give `count` active clusters, one packed key per cluster
// slot (bit 30 inactive | bits 21..29 entry bucket | bits 13..20 row bits
// | bits 0..12 cluster id) and (lo, step), which turn a bucket into a lower
// bound lo + bucket * step of the cluster's entry distance. The block
// counting-sorts the tile's active keys into 256 distance bins (the bucket
// bits above the lowest 2), stable in slot order, and walks them front to
// back. Every 8 clusters it refreshes the early-out: row r stays open while
// some ray of the row has min(t, texit) >= the bin's lower edge (texit,
// from K10, bounds every hit of the ray). A cluster is tested against the
// rows whose bit is set and that are open, and the walk stops when every
// row has closed; `visited` is the number of schedule entries walked, the
// JAX kernel's stats output, and `row_tests` the (row, cluster) pairs
// tested, 128 x 128 ray-triangle pairs each. Per pair: the affine t/u/v in
// the Pallas op order (built with -fmad=false and IEEE division), accepted
// where u >= 0, v >= 0, u + v <= 1, t > 1e-8 and t >= t_min. Each ray
// keeps the least key (t bits << 32 | original id), so on equal t the
// lowest original id wins, K2's and K6's rule, in any visit order (the JAX
// kernel keeps the lower reordered id, and schedule order across
// clusters). The early-out is exact (a later cluster's hits lie at or
// beyond the bound, above every open ray's min(t, texit)), so (t, id)
// equal the plain version's, K6's and K2's bitwise.
//
// What bounds it. Per pair about 40 flops, one of them an IEEE division;
// per visited cluster 8 KB of triangle constants. Work is proportional to
// the (row, cluster) pairs walked, 128 rays x 128 triangles each: a row is
// 16 of the grouped backend's 8-ray groups, so it tests more pairs than K6
// for the same rays. One block is one tile, one thread per ray (1024), so
// a tile's walk is serial, as on the TPU; the block's rows vote with a warp
// __any_sync each (4 warps a row) into shared memory. The counting sort
// runs in shared memory: a histogram with shared atomics (counts are
// order-free), a one-warp prefix, and a one-warp stable placement (32 slots
// a step, ranks within a bin by __match_any_sync). A visited cluster's 128
// rows are staged in shared memory by plain loads; the TPU kernel's
// double-buffered DMA and its skip of clusters whose rows have all closed
// become a skip before the load. cp.async/TMA staging and splitting a tile
// over blocks are later perf work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;          // rays per tile, one thread each
constexpr int kRowRays = 128;        // rays per row
constexpr int kRows = kTile / kRowRays;
constexpr int kWarpsPerRow = kRowRays / 32;
constexpr int kChunk = 128;          // triangles per cluster
constexpr int kRowVec = 4;           // float4s per pack row
constexpr int kIdBits = 13;          // key layout, ops/cluster_layout.py
constexpr int kBitsShift = kIdBits;
constexpr int kBucketShift = kIdBits + kRows;
constexpr int kBuckets = 1 << (30 - kBucketShift);
constexpr int kMaxClusters = 1 << kIdBits;
constexpr int kInactive = 1 << 30;
constexpr int kEarlyBlock = 8;       // clusters between early-out refreshes
constexpr int kSortBins = 256;       // counting-sort distance bins
constexpr int kBinSubBits = 2;       // bucket bits below a bin
constexpr int kBinShift = kBucketShift + kBinSubBits;
constexpr int kBinEdgeMask = (kBuckets - 1) ^ ((1 << kBinSubBits) - 1);
constexpr unsigned long long kMissKey = 0x7f8000007fffffffull;  // inf, max id

__global__ void __launch_bounds__(kTile)
row_closest_kernel(const float4* __restrict__ tri,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ texit,
                   const int* __restrict__ count, const int* __restrict__ keys,
                   const float* __restrict__ lostep, int cpad, float t_min,
                   float* __restrict__ t_out, int* __restrict__ id_out,
                   int* __restrict__ visited, int* __restrict__ row_tests) {
  __shared__ int sched[kMaxClusters];
  __shared__ int hist[kSortBins];
  __shared__ float4 rows[kChunk * kRowVec];
  __shared__ int warp_open[kTile / 32];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = tid / kRowRays;
  const int* tkeys = keys + static_cast<size_t>(tile) * cpad;
  const int n_active = count[tile];
  const float lo = lostep[2 * tile];
  const float step = lostep[2 * tile + 1];

  // 1. counting sort of the active keys by distance bin
  for (int i = tid; i < kSortBins; i += kTile) hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < cpad; i += kTile) {
    const int k = tkeys[i];
    if (k < kInactive) atomicAdd(&hist[(k >> kBinShift) & (kSortBins - 1)], 1);
  }
  __syncthreads();
  if (warp == 0) {                       // exclusive prefix, 8 bins a lane
    constexpr int kPer = kSortBins / 32;
    int v[kPer];
    int sum = 0;
    for (int j = 0; j < kPer; ++j) {
      v[j] = hist[lane * kPer + j];
      sum += v[j];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    int at = incl - sum;
    for (int j = 0; j < kPer; ++j) {
      hist[lane * kPer + j] = at;
      at += v[j];
    }
    __syncwarp();
    for (int base = 0; base < cpad; base += 32) {   // stable placement
      const int i = base + lane;
      const int k = i < cpad ? tkeys[i] : kInactive;
      const bool act = k < kInactive;
      const int bin = act ? (k >> kBinShift) & (kSortBins - 1) : kSortBins;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      const int leader = __ffs(peers) - 1;
      int at0 = 0;
      if (act && lane == leader) {
        at0 = hist[bin];
        hist[bin] = at0 + __popc(peers);
      }
      at0 = __shfl_sync(0xffffffffu, at0, leader);
      if (act) sched[at0 + __popc(peers & ((1u << lane) - 1u))] = k;
      __syncwarp();
    }
  }
  __syncthreads();

  // 2. the front-to-back walk
  const int ray = tile * kTile + tid;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float tex = texit[ray];
  unsigned long long best = kMissKey;
  int open_bits = (1 << kRows) - 1;      // uniform over the block
  int tested = 0;                        // (row, cluster) pairs walked
  int k = 0;
  for (; k < n_active && open_bits != 0; ++k) {
    const int key = sched[k];
    if (k % kEarlyBlock == 0) {
      const int bucket = (key >> kBucketShift) & kBinEdgeMask;
      const float bound = lo + static_cast<float>(bucket) * step;
      const float t_cur = __uint_as_float(static_cast<unsigned>(best >> 32));
      const bool open = fminf(t_cur, tex) >= bound;
      const unsigned any = __any_sync(0xffffffffu, open);
      if (lane == 0) warp_open[warp] = any;
      __syncthreads();
      int bits = 0;
      for (int w = 0; w < kTile / 32; ++w) {
        if (warp_open[w]) bits |= 1 << (w / kWarpsPerRow);
      }
      open_bits = bits;
      __syncthreads();                   // warp_open is read by all
    }
    const int eff = (key >> kBitsShift) & open_bits & ((1 << kRows) - 1);
    if (eff == 0) continue;              // uniform over the block
    tested += __popc(eff);
    const float4* src =
        tri + static_cast<size_t>(key & (kMaxClusters - 1)) * kChunk * kRowVec;
    __syncthreads();                     // the previous cluster is not read
    if (tid < kChunk * kRowVec) rows[tid] = src[tid];
    __syncthreads();
    if ((eff >> row) & 1) {
      for (int r = 0; r < kChunk; ++r) {
        const float4 a = rows[r * kRowVec];      // c0 c1 c2 c3
        const float4 b = rows[r * kRowVec + 1];  // c4 c5 c6 c7
        const float4 c = rows[r * kRowVec + 2];  // c8 c9 c10 c11
        const float os = b.z * ox + b.w * oy + c.x * oz - c.w;
        const float ds = b.z * dx + b.w * dy + c.x * dz;
        const float t = -os / ds;
        const float u = (a.x * ox + a.y * oy + a.z * oz - c.y) +
                        t * (a.x * dx + a.y * dy + a.z * dz);
        const float v = (a.w * ox + b.x * oy + b.y * oz - c.z) +
                        t * (a.w * dx + b.x * dy + b.y * dz);
        const bool ok = (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                        (t > 1e-8f) & (t >= t_min);
        if (ok) {
          const unsigned long long k2 =
              (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
              static_cast<unsigned>(__float_as_int(rows[r * kRowVec + 3].y));
          if (k2 < best) best = k2;
        }
      }
    }
  }
  const float t = __uint_as_float(static_cast<unsigned>(best >> 32));
  t_out[ray] = t;
  id_out[ray] = isinf(t) ? 0 : static_cast<int>(best & 0x7fffffffu);
  if (tid == 0) {
    visited[tile] = k;
    row_tests[tile] = tested;
  }
}

}  // namespace

extern "C" {

// Closest hit per ray over the row schedule (the K11 kernel): n_rays = 1024
// * tiles; texit (n_rays,) f32 and count (tiles,), keys (tiles, cpad) i32,
// lostep (tiles, 2) f32 from K10 and cluster_list; cpad <= 8192. Writes t,
// the original id (0 on a miss), and per tile visited (schedule entries
// walked) and row_tests ((row, cluster) pairs tested). Returns the CUDA
// error code of the launch (0 = cudaSuccess).
int tpt_row_closest(const float* tri, const float* o, const float* d,
                    const float* texit, int n_rays, const int* count,
                    const int* keys, const float* lostep, int cpad,
                    float t_min, float* t_out, int* id_out, int* visited,
                    int* row_tests, void* stream) {
  if (n_rays % kTile || cpad > kMaxClusters || cpad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  row_closest_kernel<<<n_rays / kTile, kTile, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri), o, d, texit, count, keys, lostep,
      cpad, t_min, t_out, id_out, visited, row_tests);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
