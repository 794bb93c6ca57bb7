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
// K13 is K7's kernel over K12's supercluster schedule (grouped_closest.cu):
// the slices deal the tile's active entries, a chunk is 32 entries, thread
// t holds member t & 7 of entry t >> 3 and reads its word once (none where
// the bitmap bit is clear), the bits of decided groups are dropped, and the
// rest are K7's items. So K13 tests exactly K7's pairs, with K7's exits: an
// OR again, equal to K7 and its plain version bitwise. Both kernels test a
// pair with pair_blocks. kScBulk picks K12's design (b) for the rows (the
// one built; (a) reads them through L1 as K7 does): live members' slices
// copied by TMA bulk copies into a ring of kRing slots; a warp waiting on a
// slot also watches the block's open count, and before the block leaves it
// waits for every copy it issued, so no copy lands in shared memory the
// block has released. At 32 blocks an SM (intersect_culled.
// _SC_ANYHIT_PER_SM, the sweep's best) (b) took 0.97x (a)'s device time
// on the 1M scene's NEE shadow segments (PERF.md).

#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;   // segments per block: one mask word of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;     // segments per tile
constexpr int kWords = 4;       // mask words per (tile, cluster)
constexpr int kChunk = 128;     // triangles per cluster
constexpr int kRowVec = 4;      // float4s per pack row
constexpr int kLanesPerSeg = 4; // lanes of a work item per segment
constexpr int kSC = 8;          // clusters per supercluster entry
constexpr bool kScBulk = true;  // K13's rows: staged (b), not via L1 (a)
constexpr int kRing = 4;        // (b): shared-memory slots of 8 KiB
constexpr int kSliceBytes = kChunk * kRowVec * 16;   // a cluster's rows
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

// One block per (tile, mask word, slice); work items are the set (group,
// cluster) bits of the block's share of the schedule whose group has an
// open segment. K7 (kPer = 1) and K13 (kPer = 8, kBulk) as the closest-hit
// kernels of grouped_closest.cu.
template <int kPer, bool kBulk>
__global__ void __launch_bounds__(kThreads)
grouped_anyhit_kernel(const float4* __restrict__ tri,
                      const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ maxd,
                      const int* __restrict__ ex_a,
                      const int* __restrict__ ex_b,
                      const int* __restrict__ count,
                      const int* __restrict__ list,
                      const int* __restrict__ bitmaps,
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
  extern __shared__ float4 ring[];      // (b): kRing cluster slices
  __shared__ unsigned long long s_full[kBulk ? kRing : 1];  // (b): a slot
  __shared__ int s_issued[kBulk ? kRing : 1];  // copied into, its copies
  __shared__ int s_items[kBulk ? kRing : 1];   // and its member's items done
  __shared__ int s_member[kBulk ? kThreads : 1];  // live members' slots

  const int per_tile = kWords * slices;
  const int tile = blockIdx.x / per_tile;
  const int rem = blockIdx.x - tile * per_tile;
  const int w = rem / slices;
  const int s = rem - w * slices;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ray0 = tile * kTile + w * kThreads;

  if constexpr (kBulk) {
    if (tid < kRing) {
      bar_init(&s_full[tid]);
      s_issued[tid] = 0;
      s_items[tid] = 0;
    }
  }
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

  auto stage = [&](int member, int r) {  // (b): a live member's slice
    bulk_copy(ring + r * kChunk * kRowVec,
              tri + static_cast<size_t>(s_cid[s_member[member]]) * kChunk *
                        kRowVec,
              kSliceBytes, &s_full[r], &s_issued[r]);
  };

  const int n_active = count[tile];
  const int n_mine = n_active > s ? (n_active - s + slices - 1) / slices : 0;
  const int n_slots = n_mine * kPer;    // kPer slots per schedule entry
  const int* l_list = list + static_cast<size_t>(tile) * (cpad / kPer);
  const int* b_list = bitmaps + static_cast<size_t>(tile) * (cpad / kPer);
  const int* m_list =
      masks + (static_cast<size_t>(tile) * kWords + w) * cpad;
  int staged = 0;                       // (b): live members before the chunk
  for (int base = 0; base < n_slots; base += kThreads) {
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
    if (j < n_slots) {
      const int e = s + (j / kPer) * slices;
      if (kPer == 1) {
        m = static_cast<unsigned>(m_list[e]) & live;
        cid = l_list[e];
      } else if ((b_list[e] >> (j % kPer)) & 1) {
        cid = l_list[e] * kPer + j % kPer;
        m = static_cast<unsigned>(m_list[cid]) & live;
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
    if (kBulk && m) s_member[(x >> 16) - 1] = tid;
    __syncthreads();
    if constexpr (kBulk) {
      if (tid < kRing && tid < n_live) stage(tid, (staged + tid) % kRing);
    }

    for (int i = warp; i < total; i += kWarps) {
      if (__shfl_sync(kFull, *left, 0) == 0) break;   // warp-uniform
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
      const int seg = (__ffs(mm) - 1) * 8 + (lane & 7);
      const float4* rows =
          tri + static_cast<size_t>(s_cid[lo]) * kChunk * kRowVec;
      int member = 0, r = 0;
      if constexpr (kBulk) {            // wait for the member's slice
        member = (s_end[lo] >> 16) - 1;
        r = (staged + member) % kRing;
        // false: every segment was decided meanwhile
        const bool ready = wait_slot(&s_issued[r], &s_full[r],
                                     (staged + member) / kRing, &s_left);
        if (!__all_sync(kFull, ready)) break;
        rows = ring + r * kChunk * kRowVec;
      }
      int hit = 0;
      if (!done[seg]) {
        const float ox = s_seg[0][seg], oy = s_seg[1][seg],
                    oz = s_seg[2][seg], dx = s_seg[3][seg],
                    dy = s_seg[4][seg], dz = s_seg[5][seg],
                    md = s_seg[6][seg], fa = s_seg[7][seg],
                    fb = s_seg[8][seg];
        for (int row_i = lane >> 3; row_i < kChunk; row_i += kLanesPerSeg) {
          const float4* row = rows + row_i * kRowVec;
          if (pair_blocks(row_load<kBulk>(row), row_load<kBulk>(row + 1),
                          row_load<kBulk>(row + 2),
                          row_load<kBulk>(&row[3].x), ox, oy, oz, dx, dy, dz,
                          md, fa, fb)) {
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
      if constexpr (kBulk) {
        // the last item of the member frees its slot for member + kRing
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&s_items[r], 1) + 1 == __popc(m_lo)) {
            __threadfence_block();
            s_items[r] = 0;
            if (member + kRing < n_live) stage(member + kRing, r);
          }
        }
      }
    }
    staged += n_live;
  }
  if constexpr (kBulk) {   // no copy may land after the block has left
    __syncthreads();
    if (tid < kRing && s_issued[tid] > 0) {
      wait_slot(&s_issued[tid], &s_full[tid], s_issued[tid] - 1, nullptr);
    }
  }
}

template <int kPer, bool kBulk>
int launch(const float* tri, const float* o, const float* d,
           const float* maxd, const int* ex_a, const int* ex_b, int n_rays,
           const int* count, const int* list, const int* bitmaps,
           const int* masks, int cpad, int slices,
           unsigned char* blocked_out, void* stream) {
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
        grouped_anyhit_kernel<kPer, kBulk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  grouped_anyhit_kernel<kPer, kBulk>
      <<<blocks, kThreads, ring_bytes, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const float4*>(tri), o, d, maxd, ex_a, ex_b,
          count, list, bitmaps, masks, cpad, slices, blocked_out);
  return static_cast<int>(cudaGetLastError());
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
  return launch<1, false>(tri, o, d, maxd, ex_a, ex_b, n_rays, count,
                          clusters, clusters, masks, cpad, slices,
                          blocked_out, stream);
}

// Any hit per segment over the supercluster schedule (the K13 kernel):
// count, entries and bitmaps as for tpt_grouped_closest_sc, gmask (tiles, 4,
// cpad) i32 from the segment prepass; the rest as for tpt_grouped_anyhit.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
int tpt_grouped_anyhit_sc(const float* tri, const float* o, const float* d,
                          const float* maxd, const int* ex_a, const int* ex_b,
                          int n_rays, const int* count, const int* entries,
                          const int* bitmaps, const int* gmask, int cpad,
                          int slices, unsigned char* blocked_out,
                          void* stream) {
  return launch<kSC, kScBulk>(tri, o, d, maxd, ex_a, ex_b, n_rays, count,
                              entries, bitmaps, gmask, cpad, slices,
                              blocked_out, stream);
}

// The K13 launch shape for n_rays segments and `slices` shares of a
// schedule: out[0..4] = blocks, threads a block, static shared bytes a
// block, registers a thread and dynamic shared bytes a block. Returns a
// CUDA error code.
int tpt_grouped_anyhit_sc_shape(int n_rays, int slices, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, grouped_anyhit_kernel<kSC, kScBulk>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = n_rays / kTile * kWords * slices;
  out[1] = kThreads;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.numRegs;
  out[4] = kScBulk ? kRing * kSliceBytes : 0;
  return 0;
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
