// Grouped culled any-hit (visibility) kernels (K7, K13) for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// K7 replaces the Pallas TPU kernel _kernel_grouped_anyhit_dma of
// tpu_pathtracer/ops/intersect_pallas.py, reached through
// pallas_occluded_dma_grouped: the form-factor visibility of the radiosity
// solve and NEE's shadow rays on scenes held as a CulledScene. K13 replaces
// _kernel_grouped_anyhit_dma_sc of tpu_pathtracer/ops/intersect_pallas_lab.py,
// the same query over the supercluster schedule. The Python side is
// tpu_pathtracer_torch/ops/intersect_culled.py, whose occluded_grouped_plain
// and occluded_grouped_sc_plain are the plain torch versions.
//
// What it computes. K6's walk (grouped_closest.cu) for segments: a segment
// is tested against the 128 triangles of a scheduled cluster iff its
// group's bit is set (the prepass ran in segment mode, so clusters whose
// entry lies beyond the segment are not scheduled), and it is blocked if
// some pair satisfies u >= 0, v >= 0, u + v <= 1, 1e-5 < t < maxd and the
// triangle's primitive (row 12 of the pack, f32) differs from both excluded
// ids (compared as f32, exact below 2**24, as the Pallas kernel does). The
// affine t/u/v is the Pallas op order with IEEE ops (-fmad=false, no fast
// math). The result is an OR of pair tests, so stopping early and testing
// in another order change nothing: the kernel equals the plain version
// bitwise.
//
// What bounds it. Instruction issue: a pair test is ~40 flops around an
// IEEE division, ~60 instructions, and the rows come from L2 (the sub-5
// pack is 2 MiB). A set (group, cluster) bit is 8 segments x 128 rows of
// work, and on the sub-5 form-factor segments a (word, cluster) visit
// carries ~8 of the word's 32 bits, so one lane per segment with
// clusters visited block-wide (vote, stage, barrier, test) would leave
// ~3/4 of the lanes waiting at each visit's barrier.
//
// The design makes the set bit the unit of work. A block is one tile's
// 32-group mask word (256 segments) times `slices` interleaved shares of
// the schedule, as in K6. It holds its segments in shared memory and takes
// its share of the schedule in chunks of 256 clusters: it drops the bits of
// groups whose 8 segments are all decided, counts the remaining bits with a
// block prefix sum, and lists them as work items (cluster, group). Each
// warp takes one item at a time, with no block barrier between items: lane
// l tests segment l & 7 of the group against rows l >> 3, (l >> 3) + 4, ...
// of the cluster, read through L1 (a load instruction covers 4 consecutive
// rows; the items of one cluster run on neighbouring warps at once, so one
// fetch from L2 serves them). The 4 lanes of a segment OR their answers
// with two shuffles. The early exits are exact for an OR: a segment with
// maxd <= 0 (or NaN) is decided from the start, a decided segment's lanes
// skip an item, a lane stops at its first blocking row, and the block leaves
// when every segment is decided (a shared count, decremented once per
// segment by the lane that flips its flag). A blocked segment writes 1 (the
// output starts at 0), which any share may do.
//
// K13 walks K12's supercluster schedule (grouped_closest.cu): a block
// stages an entry's 1024-row span (64 KiB of dynamic shared memory) once and
// runs the pair test on the slices of the members whose mask word for the
// block is non-zero, one lane per segment, with block votes: the block
// leaves when every lane is decided. An OR again, so K13 equals K7 and its
// plain version bitwise. Both kernels test a pair with pair_blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // segments per block: one mask word of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;     // segments per tile
constexpr int kWords = 4;       // mask words per (tile, cluster)
constexpr int kChunk = 128;     // triangles per cluster
constexpr int kRowVec = 4;      // float4s per pack row
constexpr int kLanesPerSeg = 4; // lanes of a K7 work item per segment
constexpr int kSC = 8;          // clusters per supercluster entry
constexpr int kSpanVec = kSC * kChunk * kRowVec;   // float4s of a span
constexpr int kSpanBytes = kSpanVec * 16;          // 65,536
constexpr unsigned kFull = 0xffffffffu;

// Does the segment hit the triangle of pack row (a, b, c, p) (c0-c3,
// c4-c7, c8-c11, c12 the primitive id) at 1e-5 < t < md, on a primitive
// other than fa and fb? The Pallas op order; every op rounds (-fmad=false).
__device__ __forceinline__ bool pair_blocks(
    float4 a, float4 b, float4 c, float p, float ox, float oy, float oz,
    float dx, float dy, float dz, float md, float fa, float fb) {
  const float os = b.z * ox + b.w * oy + c.x * oz - c.w;
  const float ds = b.z * dx + b.w * dy + c.x * dz;
  const float t = -os / ds;
  const float u = (a.x * ox + a.y * oy + a.z * oz - c.y) +
                  t * (a.x * dx + a.y * dy + a.z * dz);
  const float v = (a.w * ox + b.x * oy + b.y * oz - c.z) +
                  t * (a.w * dx + b.x * dy + b.y * dz);
  return (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) & (t > 1e-5f) &
         (t < md) & (p != fa) & (p != fb);
}

// Does the segment hit one of a staged cluster's 128 rows (rows: its pack
// rows)?
__device__ __forceinline__ bool anyhit_rows(
    const float4* rows, float ox, float oy, float oz, float dx, float dy,
    float dz, float md, float fa, float fb) {
  for (int r = 0; r < kChunk; ++r) {
    const float4* row = rows + r * kRowVec;
    if (pair_blocks(row[0], row[1], row[2], row[3].x, ox, oy, oz, dx, dy,
                    dz, md, fa, fb)) {
      return true;
    }
  }
  return false;
}

// K7: one block per (tile, mask word, slice); work items are the set
// (group, cluster) bits of the block's share of the schedule.
__global__ void __launch_bounds__(kThreads)
grouped_anyhit_kernel(const float4* __restrict__ tri,
                      const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ maxd,
                      const int* __restrict__ ex_a,
                      const int* __restrict__ ex_b,
                      const int* __restrict__ count,
                      const int* __restrict__ clusters,
                      const int* __restrict__ masks, int cpad, int slices,
                      unsigned char* __restrict__ blocked_out) {
  __shared__ float s_seg[9][kThreads];  // o, d, maxd, ex_a, ex_b (f32)
  __shared__ int s_done[kThreads];      // 1 once the segment is decided
  __shared__ int s_cid[kThreads];       // a chunk's clusters
  __shared__ unsigned s_mask[kThreads]; // and their live group bits
  __shared__ int s_end[kThreads];       // inclusive prefix sum of the bits
  __shared__ int s_wsum[kWarps];
  __shared__ unsigned s_live[kWarps];   // per warp: its 4 groups' open bits
  __shared__ int s_left;                // segments still open

  const int per_tile = kWords * slices;
  const int tile = blockIdx.x / per_tile;
  const int rem = blockIdx.x - tile * per_tile;
  const int w = rem / slices;
  const int s = rem - w * slices;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ray0 = tile * kTile + w * kThreads;

  {
    const int ray = ray0 + tid;
    const float md = maxd[ray];
    for (int k = 0; k < 3; ++k) {
      s_seg[k][tid] = o[3 * ray + k];
      s_seg[3 + k][tid] = d[3 * ray + k];
    }
    s_seg[6][tid] = md;
    s_seg[7][tid] = static_cast<float>(ex_a[ray]);
    s_seg[8][tid] = static_cast<float>(ex_b[ray]);
    s_done[tid] = !(md > 0.f);           // maxd <= 0 (or NaN): never blocked
    const int open = __syncthreads_count(md > 0.f);
    if (tid == 0) s_left = open;         // published by the next barrier
  }
  volatile int* done = s_done;
  volatile int* left = &s_left;

  const int n_active = count[tile];
  const int n_mine = n_active > s ? (n_active - s + slices - 1) / slices : 0;
  const int* cl_list = clusters + static_cast<size_t>(tile) * cpad;
  const int* m_list =
      masks + (static_cast<size_t>(tile) * kWords + w) * cpad;
  for (int base = 0; base < n_mine; base += kThreads) {
    // the groups that still have an open segment
    const unsigned open = __ballot_sync(kFull, !done[tid]);
    if (lane == 0) {
      s_live[warp] = ((open & 0x000000ffu) ? 1u : 0u) |
                     ((open & 0x0000ff00u) ? 2u : 0u) |
                     ((open & 0x00ff0000u) ? 4u : 0u) |
                     ((open & 0xff000000u) ? 8u : 0u);
    }
    // barrier: s_left and s_live published, the previous chunk not read
    __syncthreads();
    if (*left == 0) break;               // uniform: no writer until the items
    unsigned live = 0u;
    for (int k = 0; k < kWarps; ++k) live |= s_live[k] << (4 * k);
    const int j = base + tid;
    unsigned m = 0u;
    int cid = 0;
    if (j < n_mine) {
      const int e = s + j * slices;
      m = static_cast<unsigned>(m_list[e]) & live;
      cid = cl_list[e];
    }
    s_cid[tid] = cid;
    s_mask[tid] = m;
    int x = __popc(m);                   // inclusive scan over the block
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(kFull, x, k);
      if (lane >= k) x += y;
    }
    if (lane == 31) s_wsum[warp] = x;
    __syncthreads();
    int total = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int v = s_wsum[k];
      if (k < warp) x += v;
      total += v;
    }
    s_end[tid] = x;
    __syncthreads();

    for (int i = warp; i < total; i += kWarps) {
      if (__shfl_sync(kFull, *left, 0) == 0) break;   // warp-uniform
      // item i: the e-th chunk entry with s_end[e - 1] <= i < s_end[e],
      // and the k-th set bit of its mask
      int lo = 0, hi = kThreads - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] > i) hi = mid; else lo = mid + 1;
      }
      unsigned mm = s_mask[lo];
      for (int k = i - (lo ? s_end[lo - 1] : 0); k > 0; --k) mm &= mm - 1u;
      const int seg = (__ffs(mm) - 1) * 8 + (lane & 7);
      int hit = 0;
      if (!done[seg]) {
        const float ox = s_seg[0][seg], oy = s_seg[1][seg],
                    oz = s_seg[2][seg], dx = s_seg[3][seg],
                    dy = s_seg[4][seg], dz = s_seg[5][seg],
                    md = s_seg[6][seg], fa = s_seg[7][seg],
                    fb = s_seg[8][seg];
        const float4* rows =
            tri + static_cast<size_t>(s_cid[lo]) * kChunk * kRowVec;
        for (int r = lane >> 3; r < kChunk; r += kLanesPerSeg) {
          const float4* row = rows + r * kRowVec;
          if (pair_blocks(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                          __ldg(&row[3].x), ox, oy, oz, dx, dy, dz, md, fa,
                          fb)) {
            hit = 1;
            break;
          }
        }
      }
      hit |= __shfl_xor_sync(kFull, hit, 8);
      hit |= __shfl_xor_sync(kFull, hit, 16);
      if (hit && lane < 8 && atomicExch(&s_done[seg], 1) == 0) {
        blocked_out[ray0 + seg] = 1;
        atomicSub(&s_left, 1);
      }
    }
  }
}

// K13: K7's blocks and votes over K12's supercluster schedule.
__global__ void __launch_bounds__(kThreads)
grouped_anyhit_sc_kernel(const float4* __restrict__ tri,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ maxd,
                         const int* __restrict__ ex_a,
                         const int* __restrict__ ex_b,
                         const int* __restrict__ count,
                         const int* __restrict__ entries,
                         const int* __restrict__ bitmaps,
                         const int* __restrict__ gmask, int cpad, int slices,
                         unsigned char* __restrict__ blocked_out) {
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
  const float md = maxd[ray];
  const float fa = static_cast<float>(ex_a[ray]);
  const float fb = static_cast<float>(ex_b[ray]);
  bool blocked = false;
  bool decided = !(md > 0.f);    // maxd <= 0 (or NaN): never blocked

  const int n_entries = cpad / kSC;
  const int n_active = count[tile];
  const int* e_list = entries + static_cast<size_t>(tile) * n_entries;
  const int* b_list = bitmaps + static_cast<size_t>(tile) * n_entries;
  const unsigned* words = reinterpret_cast<const unsigned*>(gmask) +
                          (static_cast<size_t>(tile) * kWords + w) * cpad;
  for (int base = 0; base < n_active; base += kThreads) {
    // barrier (the previous chunk is no longer read) and block-wide vote
    if (__syncthreads_and(decided)) break;
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
      // barrier (the previous span is not read) and block-wide vote
      if (__syncthreads_and(decided)) break;
      for (int k = tid; k < kSpanVec; k += kThreads) span[k] = src[k];
      __syncthreads();
      if (!decided) {
        while (live && !blocked) {
          const int m = __ffs(live) - 1;
          live &= live - 1u;
          if (words[first + m] & bit) {
            blocked = anyhit_rows(span + m * kChunk * kRowVec, ox, oy, oz, dx,
                                  dy, dz, md, fa, fb);
          }
        }
        decided = blocked;
      }
    }
  }
  if (blocked) blocked_out[ray] = 1;
}

}  // namespace

extern "C" {

// Any hit per segment over the schedule (the K7 kernel): n_rays = 1024 *
// tiles; maxd (n_rays,) f32, ex_a / ex_b (n_rays,) i32; count, clusters and
// masks as for tpt_grouped_closest; blocked_out (n_rays,) bytes, zero on
// entry. Returns the CUDA error code of the launch (0 = cudaSuccess).
int tpt_grouped_anyhit(const float* tri, const float* o, const float* d,
                       const float* maxd, const int* ex_a, const int* ex_b,
                       int n_rays, const int* count, const int* clusters,
                       const int* masks, int cpad, int slices,
                       unsigned char* blocked_out, void* stream) {
  if (n_rays % kTile || slices < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const int blocks = n_rays / kTile * kWords * slices;
  grouped_anyhit_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri), o, d, maxd, ex_a, ex_b, count,
      clusters, masks, cpad, slices, blocked_out);
  return static_cast<int>(cudaGetLastError());
}

// Any hit per segment over the supercluster schedule (the K13 kernel):
// count, entries and bitmaps as for tpt_grouped_closest_sc, gmask (tiles, 4,
// cpad) i32 from the segment prepass; the rest as for tpt_grouped_anyhit.
// Returns the CUDA error code of the shared-memory attribute call or of the
// launch (0 = cudaSuccess).
int tpt_grouped_anyhit_sc(const float* tri, const float* o, const float* d,
                          const float* maxd, const int* ex_a, const int* ex_b,
                          int n_rays, const int* count, const int* entries,
                          const int* bitmaps, const int* gmask, int cpad,
                          int slices, unsigned char* blocked_out,
                          void* stream) {
  if (n_rays % kTile || slices < 1 || cpad % kSC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      grouped_anyhit_sc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSpanBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = n_rays / kTile * kWords * slices;
  grouped_anyhit_sc_kernel<<<blocks, kThreads, kSpanBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri), o, d, maxd, ex_a, ex_b, count,
      entries, bitmaps, gmask, cpad, slices, blocked_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
