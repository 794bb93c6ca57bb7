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
// What bounds it. Per pair about 40 flops around an IEEE division; built
// with -fmad=false every flop is its own instruction and the division
// about ten, ~63 instructions a pair (closest_hit.cu's SASS), so the floor
// is instruction issue: at 1,980 MHz an H100 issues ~3.3e13 thread-
// instructions a second. Work is proportional to the set (group, cluster)
// bits, which the prepass keeps small: a bit is 8 rays x 128 rows.
//
// The design makes the set bit the unit of work, as K7's does
// (grouped_anyhit.cu). A block is one tile's 32-group mask word (256 rays)
// times `slices` interleaved shares of the tile's schedule, so even a
// 16-tile batch spreads over every SM. It holds its rays in shared memory
// and takes its share of the schedule in chunks of 256 clusters: it counts
// the chunk's set bits with a block prefix sum and lists them as work items
// (cluster, group). Each warp takes one item at a time, with no block
// barrier between items: lane l tests ray l & 7 of the group against rows
// l >> 3, (l >> 3) + 4, ... of the cluster, read through L1 (a load
// instruction covers 4 consecutive rows; the items of one cluster run on
// neighbouring warps at once, so one fetch from L2 serves them), and keeps
// its least key. The 4 lanes of a ray merge by a 64-bit min over two
// shuffles; the ray's key goes into the block's shared key with a 64-bit
// atomicMin, and one global atomicMin a ray at the end combines the
// slices. A min is order-free, so every split is exact; a closest hit
// tests every scheduled pair, so there is no early exit. The wrapper asks
// for about 32 blocks an SM (intersect_culled._closest_slices, at most 32
// slices): a block's share of set bits varies, and on the H100 more blocks
// than fit at once beat the walk's usual 6 an SM at 16 and 64 tiles, while
// items of 8 rays x 2 lanes (two a warp) or x 1 lane did no better than
// 8 x 4. (The port's first design visited each cluster block-wide: a
// barrier, all 256 threads staging the cluster, a barrier, and then only
// the threads of set groups testing, 8k of 256 lanes busy for k set bits
// in the word.) The TPU
// kernel's DMA ring, SMEM schedule ring and lane-broadcast ray expansion
// are TPU workarounds and have no counterpart.
//
// K12, the supercluster walk. A schedule entry is 8 consecutive clusters,
// whose 1024 pack rows are one contiguous span (packs are padded to whole
// 128-cluster blocks, so every span is in bounds), with an 8-bit bitmap of
// the members some group of the tile hits; a member's words are read from
// the (tiles, 4, cpad) mask by cluster id. K12 is K6's kernel over entries:
// the slices deal the tile's active entries, a chunk is 32 entries, and
// thread t of the chunk holds member t & 7 of entry t >> 3, reading the
// member's word for the block's mask word once (no read where the bitmap
// bit is clear; padding clusters have none). The chunk's set bits are then
// K6's items, so K12 tests exactly K6's pairs and equals it bitwise; a
// member with a zero word for this block costs no item. The TPU kernel's
// point was one DMA and one schedule read per 8 clusters.
//
// The rows of an item come in one of two ways (kScBulk). (a) Through L1
// with __ldg, as in K6: neighbouring warps on items of one member share the
// L2 fetch. (b) Staged: the block lists its live members (non-zero words)
// in chunk order, and one thread copies each member's 8 KiB slice into a
// ring of kRing shared-memory slots with a TMA 1-D bulk copy
// (cp.async.bulk) that completes on the slot's mbarrier. The first kRing
// members are copied when the chunk's items are listed; the lane that
// finishes the last item of member k copies member k + kRing into the freed
// slot. A warp waits only on its item's slot, never on a block barrier.
// Items come in member order and a warp takes them in order, so the least
// unfinished item always has its member staged: no wait can deadlock. (b)
// is the one built: on the H100 it took 0.93x (a)'s device time on the 1M
// scene's bounce rays and 0.84x on its camera rays (kernel_ab.py's sweep,
// which builds both; PERF.md). Four slots (32 KiB, no opt-in past 48 KiB
// a block) were the best of the sweep's 2-8: fewer leave warps waiting for
// staged members, more cost resident blocks. The wrapper asks for 32
// blocks an SM (intersect_culled._SC_CLOSEST_PER_SM), the sweep's best of
// 4-32.

#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;   // rays per block: one mask word of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;     // rays per tile
constexpr int kWords = 4;       // mask words per (tile, cluster)
constexpr int kChunk = 128;     // triangles per cluster
constexpr int kRowVec = 4;      // float4s per pack row
constexpr int kGroup = 8;       // rays per group (one mask bit)
constexpr int kRowLanes = 4;    // lanes of a work item per ray
constexpr int kSC = 8;          // clusters per supercluster entry
constexpr bool kScBulk = true;  // K12's rows: staged (b), not via L1 (a)
constexpr int kRing = 4;        // (b): shared-memory slots of 8 KiB
constexpr int kSliceBytes = kChunk * kRowVec * 16;   // a cluster's rows
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kMiss = ~0ull;

// Is the pair of a ray and the pack row (a, b, c) (c0-c3, c4-c7, c8-c11)
// accepted, and at which t? The Pallas op order; every op rounds
// (-fmad=false).
__device__ __forceinline__ bool accept(float4 a, float4 b, float4 c,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float t_min, float& t) {
  const float os = b.z * ox + b.w * oy + c.x * oz - c.w;
  const float ds = b.z * dx + b.w * dy + c.x * dz;
  t = -os / ds;
  const float u = (a.x * ox + a.y * oy + a.z * oz - c.y) +
                  t * (a.x * dx + a.y * dy + a.z * dz);
  const float v = (a.w * ox + b.x * oy + b.y * oz - c.z) +
                  t * (a.w * dx + b.x * dy + b.y * dz);
  return (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) & (t > 1e-8f) &
         (t >= t_min);
}

// The key of an accepted pair: t bits << 32 | original id (the int32 bits
// of pack column 13).
__device__ __forceinline__ unsigned long long key_of(float t, float id) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(__float_as_int(id));
}

// One block per (tile, mask word, slice); work items are the set (group,
// cluster) bits of the block's share of the schedule. K6 (kPer = 1): the
// schedule lists clusters, masks (tiles, 4, cpad) holds their words in
// schedule order. K12 (kPer = 8): it lists supercluster entries with their
// member bitmaps, masks is the prepass's gmask, read by cluster id. kBulk:
// design (b) of the rows (above); ring is its dynamic shared memory.
template <int kPer, bool kBulk>
__global__ void __launch_bounds__(kThreads)
grouped_closest_kernel(const float4* __restrict__ tri,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const int* __restrict__ count,
                       const int* __restrict__ list,
                       const int* __restrict__ bitmaps,
                       const int* __restrict__ masks, int cpad, int slices,
                       float t_min, unsigned long long* __restrict__ best) {
  __shared__ float s_o[3 * kThreads];   // the block's rays, as in o and d
  __shared__ float s_d[3 * kThreads];
  __shared__ unsigned long long s_key[kThreads];   // their least keys
  __shared__ int s_cid[kThreads];       // a chunk's clusters
  __shared__ unsigned s_mask[kThreads]; // and their group bits
  __shared__ int s_end[kThreads];       // inclusive prefix sum of the bits
  __shared__ int s_wsum[kWarps];
  extern __shared__ float4 ring[];      // (b): kRing cluster slices
  __shared__ unsigned long long s_full[kBulk ? kRing : 1];  // (b): a slot
  __shared__ int s_issued[kBulk ? kRing : 1];  // copied into, its copies
  __shared__ int s_done[kBulk ? kRing : 1];    // and its member's items done
  __shared__ int s_live[kBulk ? kThreads : 1]; // (b): live members' slots

  const int per_tile = kWords * slices;
  const int tile = blockIdx.x / per_tile;
  const int rem = blockIdx.x - tile * per_tile;
  const int w = rem / slices;
  const int s = rem - w * slices;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ray0 = tile * kTile + w * kThreads;
  const int q = lane / kGroup;          // the lane's row lane in an item

  for (int k = tid; k < 3 * kThreads; k += kThreads) {
    s_o[k] = o[3 * ray0 + k];
    s_d[k] = d[3 * ray0 + k];
  }
  s_key[tid] = kMiss;
  if constexpr (kBulk) {
    if (tid < kRing) {
      bar_init(&s_full[tid]);
      s_issued[tid] = 0;
      s_done[tid] = 0;
    }
  }

  const int n_active = count[tile];
  const int n_mine = n_active > s ? (n_active - s + slices - 1) / slices : 0;
  const int n_slots = n_mine * kPer;    // kPer slots per schedule entry
  const int* l_list = list + static_cast<size_t>(tile) * (cpad / kPer);
  const int* b_list = bitmaps + static_cast<size_t>(tile) * (cpad / kPer);
  const int* m_list =
      masks + (static_cast<size_t>(tile) * kWords + w) * cpad;
  int staged = 0;                       // (b): live members before the chunk
  for (int base = 0; base < n_slots; base += kThreads) {
    // barrier: the rays published, the previous chunk no longer read
    __syncthreads();
    const int j = base + tid;
    unsigned m = 0u;
    int cid = 0;
    if (j < n_slots) {
      const int e = s + (j / kPer) * slices;
      if (kPer == 1) {
        m = static_cast<unsigned>(m_list[e]);
        cid = l_list[e];
      } else if ((b_list[e] >> (j % kPer)) & 1) {
        cid = l_list[e] * kPer + j % kPer;
        m = static_cast<unsigned>(m_list[cid]);
      }
    }
    s_cid[tid] = cid;
    s_mask[tid] = m;
    // inclusive scan over the block: bits, and with (b) live members << 16
    int x = __popc(m) + (kBulk && m ? 1 << 16 : 0);
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
    const int n_live = total >> 16;
    total &= 0xffff;
    if (kBulk && m) s_live[(x >> 16) - 1] = tid;
    __syncthreads();
    if constexpr (kBulk) {
      if (tid < kRing && tid < n_live) {  // the chunk's first members
        const int r = (staged + tid) % kRing;
        bulk_copy(ring + r * kChunk * kRowVec,
                  tri + static_cast<size_t>(s_cid[s_live[tid]]) * kChunk *
                            kRowVec,
                  kSliceBytes, &s_full[r], &s_issued[r]);
      }
    }

    for (int i = warp; i < total; i += kWarps) {
      // item i: the e-th chunk slot with s_end[e - 1] <= i < s_end[e],
      // and the k-th set bit of its mask
      int lo = 0, hi = kThreads - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((s_end[mid] & 0xffff) > i) hi = mid; else lo = mid + 1;
      }
      const unsigned m_lo = s_mask[lo];
      unsigned mm = m_lo;
      for (int k = i - (lo ? s_end[lo - 1] & 0xffff : 0); k > 0; --k) {
        mm &= mm - 1u;
      }
      const int ray = (__ffs(mm) - 1) * kGroup + (lane & (kGroup - 1));
      const float ox = s_o[3 * ray], oy = s_o[3 * ray + 1],
                  oz = s_o[3 * ray + 2], dx = s_d[3 * ray],
                  dy = s_d[3 * ray + 1], dz = s_d[3 * ray + 2];
      const float4* rows =
          tri + static_cast<size_t>(s_cid[lo]) * kChunk * kRowVec;
      int member = 0, r = 0;
      if constexpr (kBulk) {            // wait for the member's slice
        member = (s_end[lo] >> 16) - 1;
        r = (staged + member) % kRing;
        wait_slot(&s_issued[r], &s_full[r], (staged + member) / kRing,
                  nullptr);
        rows = ring + r * kChunk * kRowVec;
      }
      unsigned long long key = kMiss;
#pragma unroll 4
      for (int row_i = q; row_i < kChunk; row_i += kRowLanes) {
        const float4* row = rows + row_i * kRowVec;
        float t;
        if (accept(row_load<kBulk>(row), row_load<kBulk>(row + 1),
                   row_load<kBulk>(row + 2), ox, oy, oz, dx, dy, dz, t_min,
                   t)) {
          const unsigned long long k2 = key_of(t, row_load<kBulk>(&row[3].y));
          if (k2 < key) key = k2;
        }
      }
      for (int k = kGroup; k < 32; k <<= 1) {   // the ray's 4 lanes
        const unsigned long long y = __shfl_xor_sync(kFull, key, k);
        if (y < key) key = y;
      }
      if (q == 0 && key != kMiss) atomicMin(&s_key[ray], key);
      if constexpr (kBulk) {
        // the last item of the member frees its slot for member + kRing
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&s_done[r], 1) + 1 == __popc(m_lo)) {
            __threadfence_block();
            s_done[r] = 0;
            if (member + kRing < n_live) {
              bulk_copy(ring + r * kChunk * kRowVec,
                        tri + static_cast<size_t>(
                                  s_cid[s_live[member + kRing]]) *
                                  kChunk * kRowVec,
                        kSliceBytes, &s_full[r], &s_issued[r]);
            }
          }
        }
      }
    }
    staged += n_live;
  }
  __syncthreads();
  const unsigned long long key = s_key[tid];
  if (key != kMiss) atomicMin(best + ray0 + tid, key);
}

template <int kPer, bool kBulk>
int launch(const float* tri, const float* o, const float* d, int n_rays,
           const int* count, const int* list, const int* bitmaps,
           const int* masks, int cpad, int slices, float t_min,
           long long* best, void* stream) {
  if (n_rays % kTile || slices < 1 || cpad % kPer) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const int blocks = n_rays / kTile * kWords * slices;
  const int ring_bytes = kBulk ? kRing * kSliceBytes : 0;
  if (ring_bytes > 32 * 1024) {
    // a block past 48 KiB of shared memory needs the opt-in: only rings of
    // more than 4 slots (kernel_ab.py's sweep builds 6 and 8)
    const cudaError_t attr = cudaFuncSetAttribute(
        grouped_closest_kernel<kPer, kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  grouped_closest_kernel<kPer, kBulk>
      <<<blocks, kThreads, ring_bytes, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const float4*>(tri), o, d, count, list, bitmaps,
          masks, cpad, slices, t_min,
          reinterpret_cast<unsigned long long*>(best));
  return static_cast<int>(cudaGetLastError());
}

template <int kPer, bool kBulk>
int shape(int n_rays, int slices, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, grouped_closest_kernel<kPer, kBulk>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = n_rays / kTile * kWords * slices;
  out[1] = kThreads;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.numRegs;
  out[4] = kBulk ? kRing * kSliceBytes : 0;
  return 0;
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
  return launch<1, false>(tri, o, d, n_rays, count, clusters, clusters,
                          masks, cpad, slices, t_min, best, stream);
}

// The K6 launch shape for n_rays rays and `slices` shares of a schedule:
// out[0..4] = blocks, threads a block, static shared bytes a block,
// registers a thread and dynamic shared bytes a block. Returns a CUDA error
// code.
int tpt_grouped_closest_shape(int n_rays, int slices, int* out) {
  return shape<1, false>(n_rays, slices, out);
}

// Closest hit per ray over the supercluster schedule (the K12 kernel):
// count (tiles,), entries and bitmaps (tiles, cpad / 8) i32 from
// supercluster_list, gmask (tiles, 4, cpad) i32 from the prepass; the rest
// as for tpt_grouped_closest. Returns the CUDA error code of the launch.
int tpt_grouped_closest_sc(const float* tri, const float* o, const float* d,
                           int n_rays, const int* count, const int* entries,
                           const int* bitmaps, const int* gmask, int cpad,
                           int slices, float t_min, long long* best,
                           void* stream) {
  return launch<kSC, kScBulk>(tri, o, d, n_rays, count, entries, bitmaps,
                              gmask, cpad, slices, t_min, best, stream);
}

// The K12 launch shape, as tpt_grouped_closest_shape's.
int tpt_grouped_closest_sc_shape(int n_rays, int slices, int* out) {
  return shape<kSC, kScBulk>(n_rays, slices, out);
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
