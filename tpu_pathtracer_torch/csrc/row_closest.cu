// Row-granular culled closest-hit kernel (K11) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel _kernel_culled_dma of
// tpu_pathtracer/ops/intersect_pallas_legacy.py:572, reached through
// pallas_closest_tuv_dma (:829): the walk of CulledScene(grouped=False) and
// of CulledScene(sort_rays=True). The Python side is
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
// bound lo + bucket * step of the cluster's entry distance. The tile's
// active keys are counting-sorted into 256 distance bins (the bucket bits
// above the lowest 2), stable in slot order, and walked front to back.
// Every 8 schedule entries a row refreshes its early-out: it stays open
// while some ray of the row has min(t, texit) >= the bin's lower edge
// (texit, from K10, bounds every hit of the ray). A cluster is tested
// against a row while the row is open and its bit is set. Per pair: the
// affine t/u/v in the Pallas op order (built with -fmad=false and IEEE
// division), accepted where u >= 0, v >= 0, u + v <= 1, t > 1e-8 and t >=
// t_min. Each ray keeps the least key (t bits << 32 | original id), so on
// equal t the lowest original id wins, K2's and K6's rule, in any visit
// order (the JAX kernel keeps the lower reordered id, and schedule order
// across clusters). The early-out is exact (a later cluster's hits lie at
// or beyond the bound, above every open ray's min(t, texit)), so (t, id)
// equal the plain version's, K6's and K2's bitwise. Stats per tile:
// `visited`, the schedule entries walked (the JAX kernel's stats output),
// and `row_tests`, the (row, cluster) pairs tested.
//
// What bounds it. Per pair about 40 flops, built without FMA, one of them
// an IEEE division (a dozen instructions): issue, not memory, bounds the
// walk; per tested (row, cluster) 8 KB of triangle constants serve 16,384
// pair tests. The work is the (row, cluster) tests, and a bounce-ray tile
// sets a row's bit on about one entry in eight of its schedule.
//
// The design. The TPU walked one tile per grid step; a block of 1024
// threads did the same here, so 65,536 rays filled 64 of 132 SMs, and at
// every visited cluster the whole block passed two barriers while only the
// warps of the rows whose bit was set tested. Now:
//   * a row walks alone: one block per (tile, row), 512 blocks for 65,536
//     rays. Its 512 threads are 4 parts of 128 (one ray each): part p tests
//     rows [32 p, 32 p + 32) of every cluster the row tests, so a row's
//     clusters are tested by 16 warps (with 128 threads a row, one part,
//     the longest rows bounded the walk: 3.08 against 2.46 ms on
//     stress100k's bounce rays, 2.23 against 1.21 on the 1M scene's camera
//     rays, in one call on the H100);
//   * a row skips an entry whose bit is clear without a load or a barrier:
//     each warp finds the row's next set entry 32 schedule slots at a time
//     with a ballot;
//   * copies overlap tests: while the block tests one cluster it stages the
//     row's next set entry with cp.async into the other of two 8 KB
//     buffers, one barrier per tested cluster (a prefetch that the next
//     refresh makes useless is harmless);
//   * the early-out is the tile kernel's decision for that row: at every
//     schedule position k with k % 8 == 0 and k < count the parts share
//     their t through shared memory, the row votes with __syncthreads_or,
//     and it stops at the first refresh that finds it closed. The bound is
//     non-decreasing along the sorted schedule and a row's best t only
//     falls, so a row that closed stays closed; what a tile walked (visited
//     = the largest K_r + 1 over rows r closing at refresh K_r, else count)
//     and tested (row_tests = the sum over rows of the set entries before
//     K_r) are the plain version's, gathered with atomicMax / atomicAdd into
//     counters the wrapper zeroes. The parts' (t, original id) merge once,
//     at the end;
//   * the sort is ours and runs once per tile: a first kernel (one block a
//     tile) counting-sorts the keys into a (tiles, cpad) scratch that the
//     wrapper allocates; a histogram with shared atomics (counts are
//     order-free), a one-warp prefix, and a one-warp stable placement (32
//     slots a step, ranks within a bin by __match_any_sync). On the 1M
//     scene (cpad 7,936) it takes 0.04 ms of the walk's 1.1-2.5.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;          // rays per tile
constexpr int kRowRays = 128;        // rays per row: one block, a ray a part
constexpr int kRows = kTile / kRowRays;
constexpr int kChunk = 128;          // triangles per cluster
constexpr int kRowVec = 4;           // float4s per pack row
constexpr int kIdBits = 13;          // key layout, ops/cluster_layout.py
constexpr int kBitsShift = kIdBits;
constexpr int kBucketShift = kIdBits + kRows;
constexpr int kBuckets = 1 << (30 - kBucketShift);
constexpr int kMaxClusters = 1 << kIdBits;
constexpr int kInactive = 1 << 30;
constexpr int kEarlyBlock = 8;       // entries between early-out refreshes
constexpr int kSortBins = 256;       // counting-sort distance bins
constexpr int kBinSubBits = 2;       // bucket bits below a bin
constexpr int kBinShift = kBucketShift + kBinSubBits;
constexpr int kBinEdgeMask = (kBuckets - 1) ^ ((1 << kBinSubBits) - 1);
constexpr int kSortThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kParts = 4;            // triangle parts of a row block
constexpr int kThreads = kRowRays * kParts;
constexpr int kPartRows = kChunk / kParts;

// Counting sort of one tile's active keys by distance bin, stable in slot
// order, into sched[tile * cpad + 0 .. count).
__global__ void __launch_bounds__(kSortThreads)
row_sort_kernel(const int* __restrict__ keys, int cpad,
                int* __restrict__ sched) {
  __shared__ int hist[kSortBins];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int* tkeys = keys + static_cast<size_t>(blockIdx.x) * cpad;
  int* out = sched + static_cast<size_t>(blockIdx.x) * cpad;

  for (int i = tid; i < kSortBins; i += kSortThreads) hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < cpad; i += kSortThreads) {
    const int k = tkeys[i];
    if (k < kInactive) atomicAdd(&hist[(k >> kBinShift) & (kSortBins - 1)], 1);
  }
  __syncthreads();
  if (tid >= 32) return;
  constexpr int kPer = kSortBins / 32;   // exclusive prefix, 8 bins a lane
  int v[kPer];
  int sum = 0;
  for (int j = 0; j < kPer; ++j) {
    v[j] = hist[lane * kPer + j];
    sum += v[j];
  }
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  int at = incl - sum;
  for (int j = 0; j < kPer; ++j) {
    hist[lane * kPer + j] = at;
    at += v[j];
  }
  __syncwarp();
  for (int base = 0; base < cpad; base += 32) {    // stable placement
    const int i = base + lane;
    const int k = i < cpad ? tkeys[i] : kInactive;
    const bool act = k < kInactive;
    const int bin = act ? (k >> kBinShift) & (kSortBins - 1) : kSortBins;
    const unsigned peers = __match_any_sync(kFull, bin);
    const int leader = __ffs(peers) - 1;
    int at0 = 0;
    if (act && lane == leader) {
      at0 = hist[bin];
      hist[bin] = at0 + __popc(peers);
    }
    at0 = __shfl_sync(kFull, at0, leader);
    if (act) out[at0 + __popc(peers & ((1u << lane) - 1u))] = k;
    __syncwarp();
  }
}

// The first schedule position p in [from, n) whose key has `bit` set, or n;
// the same answer in every lane of the warp.
__device__ __forceinline__ int next_set(const int* __restrict__ s, int from,
                                        int n, int bit, int lane) {
  for (int base = from; base < n; base += 32) {
    const int i = base + lane;
    const bool on = i < n && ((__ldg(s + i) >> bit) & 1);
    const unsigned m = __ballot_sync(kFull, on);
    if (m) return base + __ffs(m) - 1;
  }
  return n;
}

// Stage cluster `cl`'s 128 rows (8 KB) into dst with cp.async, one 16 B
// copy a thread, as one commit group.
__device__ __forceinline__ void stage(float4* dst, const float4* tri, int cl,
                                      int tid) {
  static_assert(kChunk * kRowVec == kThreads, "one float4 a thread");
  const float4* src = tri + static_cast<size_t>(cl) * kChunk * kRowVec;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst + tid));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src + tid));
  asm volatile("cp.async.commit_group;\n" ::);
}

// One block per (tile, row): thread tid takes ray tid % 128 of the row and
// the triangles [32 part, 32 part + 32) of every tested cluster, part =
// tid / 128.
__global__ void __launch_bounds__(kThreads)
row_walk_kernel(const float4* __restrict__ tri,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ texit,
                const int* __restrict__ count, const int* __restrict__ sched,
                const float* __restrict__ lostep, int cpad, float t_min,
                float* __restrict__ t_out, int* __restrict__ id_out,
                int* __restrict__ visited, int* __restrict__ row_tests) {
  __shared__ float4 rows[2][kChunk * kRowVec];
  __shared__ float part_t[kParts][kRowRays];
  __shared__ int part_id[kParts][kRowRays];

  const int tile = blockIdx.x / kRows;
  const int row = blockIdx.x % kRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = tid % kRowRays;
  const int part = tid / kRowRays;
  const int bit = kBitsShift + row;
  const int* s = sched + static_cast<size_t>(tile) * cpad;
  const int n = count[tile];
  const float lo = lostep[2 * tile];
  const float step = lostep[2 * tile + 1];

  const int ray = tile * kTile + row * kRowRays + slot;
  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float tex = texit[ray];
  float best_t = __int_as_float(0x7f800000);   // +inf, this part's rows
  int best_id = 0x7fffffff;

  int pos = next_set(s, 0, n, bit, lane);      // the next entry to test
  int buf = 0;
  if (pos < n) {
    stage(rows[0], tri, __ldg(s + pos) & (kMaxClusters - 1), tid);
  }
  int tested = 0;
  int closed_at = -1;
  for (int k0 = 0; k0 < n; k0 += kEarlyBlock) {
    // the refresh at k0: the bin's lower edge bounds every entry from k0 on
    const int bucket = (__ldg(s + k0) >> kBucketShift) & kBinEdgeMask;
    const float bound = lo + static_cast<float>(bucket) * step;
    part_t[part][slot] = best_t;   // the ray's t: the least over the parts
    __syncthreads();
    float t_cur = best_t;
#pragma unroll
    for (int p = 0; p < kParts; ++p) t_cur = fminf(t_cur, part_t[p][slot]);
    // one vote of the row; its barrier also frees part_t for the next write
    if (!__syncthreads_or(fminf(t_cur, tex) >= bound)) {
      closed_at = k0;
      break;
    }
    const int end = min(k0 + kEarlyBlock, n);
    while (pos < end) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();    // rows[buf] staged; rows[buf ^ 1] no longer read
      const int nxt = next_set(s, pos + 1, n, bit, lane);
      if (nxt < n) {
        stage(rows[buf ^ 1], tri, __ldg(s + nxt) & (kMaxClusters - 1), tid);
      }
      const float4* r4 = rows[buf] + part * kPartRows * kRowVec;
#pragma unroll 4
      for (int r = 0; r < kPartRows; ++r) {
        const float4 a = r4[r * kRowVec];      // c0 c1 c2 c3
        const float4 b = r4[r * kRowVec + 1];  // c4 c5 c6 c7
        const float4 c = r4[r * kRowVec + 2];  // c8 c9 c10 c11
        const float os = b.z * ox + b.w * oy + c.x * oz - c.w;
        const float ds = b.z * dx + b.w * dy + c.x * dz;
        const float t = -os / ds;
        const float u = (a.x * ox + a.y * oy + a.z * oz - c.y) +
                        t * (a.x * dx + a.y * dy + a.z * dz);
        const float v = (a.w * ox + b.x * oy + b.y * oz - c.z) +
                        t * (a.w * dx + b.x * dy + b.y * dz);
        const bool ok = (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                        (t > 1e-8f) & (t >= t_min);
        if (ok && t <= best_t) {
          const int id = __float_as_int(r4[r * kRowVec + 3].y);
          if (t < best_t || id < best_id) {
            best_t = t;
            best_id = id;
          }
        }
      }
      ++tested;
      buf ^= 1;
      pos = nxt;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // no copy outlives the block
  part_t[part][slot] = best_t;   // the least (t, original id) over parts
  part_id[part][slot] = best_id;
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int p = 1; p < kParts; ++p) {
    const float t = part_t[p][slot];
    const int id = part_id[p][slot];
    if (t < best_t || (t == best_t && id < best_id)) {
      best_t = t;
      best_id = id;
    }
  }
  t_out[ray] = best_t;
  id_out[ray] = isinf(best_t) ? 0 : best_id;
  if (tid == 0 && n > 0) {
    atomicMax(visited + tile, closed_at < 0 ? n : closed_at + 1);
    if (tested) atomicAdd(row_tests + tile, tested);
  }
}

int walk_blocks(int n_rays) { return n_rays / kTile * kRows; }

}  // namespace

extern "C" {

// Closest hit per ray over the row schedule (the K11 kernel): n_rays = 1024
// * tiles; texit (n_rays,) f32 and count (tiles,), keys (tiles, cpad) i32,
// lostep (tiles, 2) f32 from K10 and cluster_list; cpad <= 8192; sched a
// (tiles, cpad) i32 scratch for the sorted schedule. Writes t, the original
// id (0 on a miss), and per tile visited (schedule entries walked) and
// row_tests ((row, cluster) pairs tested) into counters that must be zero.
// Returns the CUDA error code of the launches (0 = cudaSuccess).
int tpt_row_closest(const float* tri, const float* o, const float* d,
                    const float* texit, int n_rays, const int* count,
                    const int* keys, const float* lostep, int cpad,
                    float t_min, float* t_out, int* id_out, int* visited,
                    int* row_tests, int* sched, void* stream) {
  if (n_rays % kTile || cpad > kMaxClusters || cpad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_sort_kernel<<<n_rays / kTile, kSortThreads, 0, st>>>(keys, cpad, sched);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_walk_kernel<<<walk_blocks(n_rays), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(tri), o, d, texit, count, sched, lostep,
      cpad, t_min, t_out, id_out, visited, row_tests);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for n_rays: out[0..3] = the walk's blocks, threads a
// block, static shared bytes a block and registers a thread; out[4..7] the
// same for the sort. Returns a CUDA error code.
int tpt_row_closest_shape(int n_rays, int* out) {
  cudaFuncAttributes walk, sort;
  cudaError_t err = cudaFuncGetAttributes(&walk, row_walk_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&sort, row_sort_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shape[8] = {walk_blocks(n_rays), kThreads,
                        static_cast<int>(walk.sharedSizeBytes), walk.numRegs,
                        n_rays / kTile, kSortThreads,
                        static_cast<int>(sort.sharedSizeBytes), sort.numRegs};
  for (int i = 0; i < 8; ++i) out[i] = shape[i];
  return 0;
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
