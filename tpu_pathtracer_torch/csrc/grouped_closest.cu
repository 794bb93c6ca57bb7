// Grouped culled closest-hit kernels (K6, K12) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// K6 replaces the Pallas TPU kernel _kernel_grouped_dma of
// tpu_pathtracer/ops/intersect_pallas.py, reached through
// pallas_closest_tuv_dma_grouped: the production large-scene closest hit.
// K12 replaces _kernel_grouped_dma_sc of
// tpu_pathtracer/ops/intersect_pallas_lab.py, the same query over the
// supercluster schedule (below). The Python side is
// tpu_pathtracer_torch/ops/intersect_culled.py, whose closest_grouped_plain
// and closest_grouped_sc_plain are the plain torch versions.
//
// What it computes. Rays come in 1024-ray tiles of 128 groups of 8
// consecutive rays; the triangles in an ordered (tpad, 16) pack of 128-row
// clusters (row: inv (9) | inv @ v0 (3) | prim (f32) | original triangle
// index (int32 bits) | pad). For each tile the schedule lists its active
// clusters (count, ids, and per cluster 4 words of 128 group bits). A ray is
// tested against the 128 triangles of a listed cluster iff its group's bit
// is set. Per pair: the affine t/u/v in the Pallas op order (built with
// -fmad=false and IEEE division, as closest_hit.cu), accepted where
// u >= 0, v >= 0, u + v <= 1, t > 1e-8 and t >= t_min. The result per ray is
// the least key (t bits << 32 | original id): t is positive, so its bits
// order as the floats do, and on equal t the lowest original id wins, the
// rule of K1/K2 and the brute query. A min does not depend on the order of
// the pairs, so the kernel equals the plain version bitwise (the Pallas
// kernel instead breaks exact ties across clusters in schedule order).
//
// What bounds it. Per pair about 40 flops, one of them an IEEE division;
// per cluster visit 8 KB of triangle constants. Work is proportional to the
// set (group, cluster) bits, which the prepass keeps small. One block is
// one tile's 32-group mask word (256 rays, one thread each) and one of
// `slices` interleaved shares of the tile's schedule, so even a 64-tile
// batch spreads over every SM; slices combine with a 64-bit atomicMin per
// ray, exact and order-free. The block stages each schedule chunk (cluster
// ids and its mask word) in shared memory, skips clusters whose word is 0
// without touching memory, and stages a visited cluster's 128 rows in
// shared memory, where every thread of a group reads the same row
// (broadcast). The TPU kernel's DMA ring, SMEM schedule ring and lane-
// broadcast ray expansion are TPU workarounds and have no counterpart.
//
// K12, the supercluster walk. A schedule entry is 8 consecutive clusters,
// whose 1024 pack rows are one contiguous span (packs are padded to whole
// 128-cluster blocks, so every span is in bounds), with an 8-bit bitmap of
// the members some group of the tile hits. The TPU kernel's point was to
// pay one DMA and one schedule read per 8 clusters instead of per cluster;
// here a block stages an entry's whole span (64 KiB, dynamic shared memory,
// above the 48 KiB static limit) once, then pops the members whose mask word
// for this block is non-zero and runs K6's pair test on each member's
// 128-row slice. The words are read from the (tiles, 4, cpad) mask by
// cluster id. Same keys and atomicMin as K6, so K12 equals K6 bitwise. What
// bounds it is what bounds K6; the span costs 8 clusters' bytes per visit
// even when one member is live, which is the trade the TPU measured.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // rays per block: one mask word of a tile
constexpr int kTile = 1024;     // rays per tile
constexpr int kWords = 4;       // mask words per (tile, cluster)
constexpr int kChunk = 128;     // triangles per cluster
constexpr int kRowVec = 4;      // float4s per pack row
constexpr int kSC = 8;          // clusters per supercluster entry
constexpr int kSpanVec = kSC * kChunk * kRowVec;   // float4s of a span
constexpr int kSpanBytes = kSpanVec * 16;          // 65,536

// Fold the accepted pairs of one ray and one staged cluster (rows: its 128
// pack rows) into the ray's least key (t bits << 32 | original id).
__device__ __forceinline__ void closest_rows(
    const float4* rows, float ox, float oy, float oz, float dx, float dy,
    float dz, float t_min, unsigned long long& key) {
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
      if (k2 < key) key = k2;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_closest_kernel(const float4* __restrict__ tri,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const int* __restrict__ count,
                       const int* __restrict__ clusters,
                       const int* __restrict__ masks, int cpad, int slices,
                       float t_min, unsigned long long* __restrict__ best) {
  __shared__ float4 rows[kChunk * kRowVec];
  __shared__ int s_cid[kThreads];
  __shared__ unsigned s_mask[kThreads];

  const int per_tile = kWords * slices;
  const int tile = blockIdx.x / per_tile;
  const int rem = blockIdx.x - tile * per_tile;
  const int w = rem / slices;
  const int s = rem - w * slices;
  const int tid = threadIdx.x;
  const int ray = tile * kTile + w * kThreads + tid;
  const unsigned bit = 1u << (tid >> 3);

  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  unsigned long long key = ~0ull;

  const int n_active = count[tile];
  const int* cl_list = clusters + static_cast<size_t>(tile) * cpad;
  const int* m_list =
      masks + (static_cast<size_t>(tile) * kWords + w) * cpad;
  for (int base = 0; base < n_active; base += kThreads) {
    __syncthreads();   // the previous chunk is no longer read
    if (base + tid < n_active) {
      s_cid[tid] = cl_list[base + tid];
      s_mask[tid] = static_cast<unsigned>(m_list[base + tid]);
    }
    __syncthreads();
    const int n = min(kThreads, n_active - base);
    for (int e = s; e < n; e += slices) {
      const unsigned m = s_mask[e];
      if (m == 0u) continue;             // uniform over the block
      const float4* src =
          tri + static_cast<size_t>(s_cid[e]) * kChunk * kRowVec;
      __syncthreads();                   // the previous cluster is not read
      for (int k = tid; k < kChunk * kRowVec; k += kThreads) rows[k] = src[k];
      __syncthreads();
      if (m & bit) closest_rows(rows, ox, oy, oz, dx, dy, dz, t_min, key);
    }
  }
  if (key != ~0ull) atomicMin(best + ray, key);
}

// K12: blocks as K6's; the schedule lists entries (ids, member bitmaps) and
// the member words are read from gmask (tiles, 4, cpad) by cluster id.
__global__ void __launch_bounds__(kThreads)
grouped_closest_sc_kernel(const float4* __restrict__ tri,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const int* __restrict__ count,
                          const int* __restrict__ entries,
                          const int* __restrict__ bitmaps,
                          const int* __restrict__ gmask, int cpad, int slices,
                          float t_min, unsigned long long* __restrict__ best) {
  extern __shared__ float4 span[];   // kSpanVec: one entry's 1024 rows
  __shared__ int s_eid[kThreads];
  __shared__ unsigned s_bits[kThreads];

  const int per_tile = kWords * slices;
  const int tile = blockIdx.x / per_tile;
  const int rem = blockIdx.x - tile * per_tile;
  const int w = rem / slices;
  const int s = rem - w * slices;
  const int tid = threadIdx.x;
  const int ray = tile * kTile + w * kThreads + tid;
  const unsigned bit = 1u << (tid >> 3);

  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  unsigned long long key = ~0ull;

  const int n_entries = cpad / kSC;
  const int n_active = count[tile];
  const int* e_list = entries + static_cast<size_t>(tile) * n_entries;
  const int* b_list = bitmaps + static_cast<size_t>(tile) * n_entries;
  const unsigned* words = reinterpret_cast<const unsigned*>(gmask) +
                          (static_cast<size_t>(tile) * kWords + w) * cpad;
  for (int base = 0; base < n_active; base += kThreads) {
    __syncthreads();   // the previous chunk is no longer read
    if (base + tid < n_active) {
      s_eid[tid] = e_list[base + tid];
      s_bits[tid] = static_cast<unsigned>(b_list[base + tid]);
    }
    __syncthreads();
    const int n = min(kThreads, n_active - base);
    for (int e = s; e < n; e += slices) {
      const int first = s_eid[e] * kSC;   // the entry's first cluster
      const unsigned members = s_bits[e];
      unsigned live = 0u;                 // members with a word for us
      for (int m = 0; m < kSC; ++m) {
        if (((members >> m) & 1u) && words[first + m] != 0u) live |= 1u << m;
      }
      if (live == 0u) continue;           // uniform over the block
      const float4* src = tri + static_cast<size_t>(first) * kChunk * kRowVec;
      __syncthreads();                    // the previous span is not read
      for (int k = tid; k < kSpanVec; k += kThreads) span[k] = src[k];
      __syncthreads();
      while (live) {
        const int m = __ffs(live) - 1;
        live &= live - 1u;
        if (words[first + m] & bit) {
          closest_rows(span + m * kChunk * kRowVec, ox, oy, oz, dx, dy, dz,
                       t_min, key);
        }
      }
    }
  }
  if (key != ~0ull) atomicMin(best + ray, key);
}

}  // namespace

extern "C" {

// Closest hit per ray over the schedule (the K6 kernel): n_rays = 1024 *
// tiles; count (tiles,), clusters (tiles, cpad) and masks (tiles, 4, cpad)
// i32 from the prepass; best (n_rays,) 64-bit keys, holding the miss key on
// entry. Returns the CUDA error code of the launch (0 = cudaSuccess).
int tpt_grouped_closest(const float* tri, const float* o, const float* d,
                        int n_rays, const int* count, const int* clusters,
                        const int* masks, int cpad, int slices, float t_min,
                        long long* best, void* stream) {
  if (n_rays % kTile || slices < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const int blocks = n_rays / kTile * kWords * slices;
  grouped_closest_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri), o, d, count, clusters, masks,
      cpad, slices, t_min, reinterpret_cast<unsigned long long*>(best));
  return static_cast<int>(cudaGetLastError());
}

// Closest hit per ray over the supercluster schedule (the K12 kernel):
// count (tiles,), entries and bitmaps (tiles, cpad / 8) i32 from
// supercluster_list, gmask (tiles, 4, cpad) i32 from the prepass; the rest
// as for tpt_grouped_closest. Returns the CUDA error code of the shared-
// memory attribute call or of the launch (0 = cudaSuccess).
int tpt_grouped_closest_sc(const float* tri, const float* o, const float* d,
                           int n_rays, const int* count, const int* entries,
                           const int* bitmaps, const int* gmask, int cpad,
                           int slices, float t_min, long long* best,
                           void* stream) {
  if (n_rays % kTile || slices < 1 || cpad % kSC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      grouped_closest_sc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSpanBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = n_rays / kTile * kWords * slices;
  grouped_closest_sc_kernel<<<blocks, kThreads, kSpanBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri), o, d, count, entries, bitmaps,
      gmask, cpad, slices, t_min, reinterpret_cast<unsigned long long*>(best));
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
