// All-pairs closest-hit kernels for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels of tpu_pathtracer/ops/intersect_pallas.py:
//   N_OUT = 11  -> _kernel_full (:240, + _row_closest_full), reached
//                  through pallas_closest_record (:319): closest hit plus
//                  the winner's 11 shading attributes (K2);
//   N_OUT = 27  -> the same on a guide-augmented (32-row) attribute pack:
//                  the 11 plus the 16 guided-sampling rows [16:32] (K2's
//                  guide instance);
//   N_OUT = 0   -> _kernel (:167, + _row_closest), reached through
//                  pallas_closest_tuv: closest (t, triangle id) only (K1);
//   culled      -> _kernel_culled of tpu_pathtracer/ops/
//                  intersect_pallas_legacy.py:196 (K9, via
//                  pallas_closest_tuv_culled): closest (t, original id)
//                  over an ordered pack of 128-row clusters, skipping each
//                  cluster whose mask word for the ray's 1024-ray tile is
//                  0; the least key (t bits << 32 | original id, pack
//                  column 13), so on equal t the lowest original id wins,
//                  as in K2 and K6.
// The Python side is tpu_pathtracer_torch/ops/intersect_allpairs.py, whose
// closest_tuv_plain / closest_record_plain are the plain torch versions of
// the same function (ops/intersect_culled_legacy.py closest_culled_plain
// for K9); the kernels equal them bitwise when built with -fmad=false (no
// contraction into FMA, as eager torch rounds every op) and without
// --use_fast_math (IEEE division keeps the NaN rejection of padding rows,
// whose inverse is zero).
//
// Layout. The triangle pack is (tpad, 16) f32 rows [inv (9) | inv @ v0 (3) |
// pad]; the attribute pack is (16, tpad) f32 rows [n(3) albedo(3)
// emission(3) material prim pad], or (32, tpad) with the guide rows below;
// rays are (n, 3) f32 origins and directions; outputs are t (n,) f32,
// id (n,) i32 and attrs (N_OUT, n) f32, output row k being pack row k for
// k < 11 and pack row k + 5 beyond.
//
// What bounds it. About 40 flops a ray-triangle pair, one of them an IEEE
// division, and 48 B of triangle constants a row shared by every ray: the
// kernel is bound by instruction issue, not by device memory. Built with
// -fmad=false every flop is its own instruction and the division takes
// about ten (reciprocal, four FMAs, the range check and its branch), so the
// loop runs about 63 instructions a pair (this build's SASS: 8 pairs in
// 503): at 65,536 rays x 2,048 rows the floor is about 0.25 ms on an H100
// at 1,980 MHz, three times the 40-flop bound at the f32 FMA rate.
//
// The design (K1, K2). A block is 4 warps sharing 64 rays, two a thread,
// and the pack's rows in 4 parts, one a warp: a row read from L1 serves
// 64 pair tests of a warp, the two rays' chains run side by side, and
// 65,536 rays make 1,024 blocks (about 31 warps an SM, where one ray a
// thread and 128-thread blocks made 15.5). Rows are read straight from the
// pack through L1 (every lane of a warp reads the same address): nothing
// is staged, and the loop has no barrier. Each thread keeps its rays'
// least (t, row) within its part, rows in ascending order; one barrier,
// then one thread a ray merges the parts by the min of 64-bit (t bits <<
// 32 | row) keys in shared memory (an accepted t is positive and finite,
// so the key orders as (t, row) and on equal t the lowest row wins, as
// the plain version's first minimum) and writes t and the id; after a
// second barrier the block's threads write the N_OUT attribute rows of
// the winners, reading the attribute columns straight from the pack (the
// TPU kernel's one-hot matmul select has no counterpart). The parts are 4
// at every pack size: on the H100 (device time at 65,536 rays) 4 parts
// beat 2 and none at 32, 512 and 2,048 rows; against the port's first
// design (one ray a thread, no parts) they win at 512 and 2,048 rows and
// for K1 at 32, and lose for K2 at the main path's 32 rows (8.2 against
// 7.7 us: the merge and the attribute writes outweigh 16 pair tests a
// thread).
//
// The design (K9) is K2's, over the tile's ON clusters. The mask is
// uniform over a 1024-ray tile, so a block (4 warps, 64 rays of one tile,
// two a thread) first lists its tile's ON clusters in shared memory: each
// warp ballots its share of a window of 1,024 mask words, one barrier
// publishes the warps' counts, each warp writes its entries after the
// earlier warps', and a second barrier closes the list (one window at
// stress100k's 896 padded clusters; larger packs take more rounds). The
// list is cut into S x 4 contiguous shares of equal length, one a warp of
// the S blocks (blockIdx.y) that hold the same 64 rays, so no warp spins
// over OFF words and the shares differ by at most one cluster. A warp
// walks its clusters' 128 rows with K2's loop (rows read through L1,
// every lane at the same address, no barrier), keeping each ray's least
// (t, original id): the id (pack column 13) is read only when an accepted
// t is no greater than the ray's best, and on equal t the lower id wins.
// The block's warps merge by the min of 64-bit keys in shared memory, the
// S blocks by a 64-bit atomicMin into the wrapper's key buffer, and a
// second small kernel writes t and id: every merge is a min, so the result
// does not depend on the cut. S is the fewest power of two that gives the
// grid 32 blocks an SM (culled_shares; at most 32): 8 at 65,536 rays,
// 8,192 blocks. On the H100 at stress100k's 65,536 rays (kernel_ab.py
// --cases sweep, device time, ms; S = 1, 2, 4, 8, 16) bounce 9.81, 9.00,
// 8.31, 7.99, 7.85 and camera 1.09, 0.75, 0.63, 0.59, 0.63: one block a
// (64 rays, tile) left the wave's end to the SMs that drew the fullest
// tiles (ON words per tile 423-525 on the bounce rays, 0-96 on the camera
// rays); the sweep forces S by replacing culled_shares' return line as
// text (kernel_ab.py's SWEEPS holds it exactly). The pair test runs ~58 instructions on the loop's usual path
// (116 a row of two rays, no id read), so the floor at ~4.0e9 masked pairs
// is ~7.0 ms. The design replaces the port's first one: one thread a ray,
// 128-thread blocks, 128-row chunks staged in shared memory between two
// barriers, every mask word read by every thread.
//
// Semantics kept exactly from the Pallas kernels: the affine arithmetic in
// their op order (os = c6*ox + c7*oy + c8*oz - c11, t = -os/ds, ...); the
// accept test u>=0 & v>=0 & u+v<=1 & t>1e-8 & t>=t_min; on equal t the
// lowest triangle id wins; on a miss t = +inf, id = 0 and all attributes
// are zero.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int kWarps = 4;            // warps per block (K1, K2): row parts
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockRays = 64;       // two rays a thread
constexpr int kTriCols = 16;         // floats per triangle row
constexpr int kAttrs = 11;           // shading attribute rows of a record
constexpr int kAttrCols = 16;        // rows of the plain attribute pack
constexpr int kChunk = 128;          // rows per cluster (K9)
constexpr int kTile = 1024;          // rays per cull-mask tile (K9)
constexpr int kWindow = 1024;        // mask words listed per round (K9)
constexpr int kCulledAim = 32;       // K9 blocks an SM to aim at
constexpr int kMostShares = 32;      // K9's most shares of a list
constexpr unsigned long long kMissKey = 0x7f8000007fffffffull;  // inf, max id

// One ray-triangle pair in the Pallas op order: writes t, returns accepted.
__device__ __forceinline__ bool pair_test(float4 a, float4 b, float4 c,
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

__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(id);
}

// The pack's rows in kWarps parts, one a warp; the warps share 64 rays.
template <int N_OUT>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float4* __restrict__ tri, const float* __restrict__ attr,
               int tpad, const float* __restrict__ o,
               const float* __restrict__ d, int n, float t_min,
               float* __restrict__ t_out, int* __restrict__ id_out,
               float* __restrict__ attr_out) {
  __shared__ unsigned long long keys[kWarps][kBlockRays];
  __shared__ int winner[kBlockRays];

  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  const int first = blockIdx.x * kBlockRays;
  const int i0 = first + lane, i1 = first + 32 + lane;
  float o0x = 0.f, o0y = 0.f, o0z = 0.f, d0x = 0.f, d0y = 0.f, d0z = 0.f;
  float o1x = 0.f, o1y = 0.f, o1z = 0.f, d1x = 0.f, d1y = 0.f, d1z = 0.f;
  if (i0 < n) {
    o0x = o[3 * i0], o0y = o[3 * i0 + 1], o0z = o[3 * i0 + 2];
    d0x = d[3 * i0], d0y = d[3 * i0 + 1], d0z = d[3 * i0 + 2];
  }
  if (i1 < n) {
    o1x = o[3 * i1], o1y = o[3 * i1 + 1], o1z = o[3 * i1 + 2];
    d1x = d[3 * i1], d1y = d[3 * i1 + 1], d1z = d[3 * i1 + 2];
  }

  // this warp's rows [lo, hi), tested in ascending order: a strict '<'
  // keeps the lowest row of equal t
  const int lo = static_cast<int>(static_cast<long long>(tpad) * part / kWarps);
  const int hi =
      static_cast<int>(static_cast<long long>(tpad) * (part + 1) / kWarps);
  const float inf = __int_as_float(0x7f800000);
  float bt0 = inf, bt1 = inf;
  int bi0 = -1, bi1 = -1;
#pragma unroll 4
  for (int r = lo; r < hi; ++r) {
    const float4* row = tri + static_cast<size_t>(r) * (kTriCols / 4);
    const float4 a = __ldg(row);      // c0 c1 c2 c3
    const float4 b = __ldg(row + 1);  // c4 c5 c6 c7
    const float4 c = __ldg(row + 2);  // c8 c9 c10 c11
    float t0, t1;
    const bool ok0 = pair_test(a, b, c, o0x, o0y, o0z, d0x, d0y, d0z, t_min,
                               t0);
    const bool ok1 = pair_test(a, b, c, o1x, o1y, o1z, d1x, d1y, d1z, t_min,
                               t1);
    if (ok0 && t0 < bt0) {
      bt0 = t0;
      bi0 = r;
    }
    if (ok1 && t1 < bt1) {
      bt1 = t1;
      bi1 = r;
    }
  }
  keys[part][lane] = bi0 < 0 ? kMissKey : hit_key(bt0, bi0);
  keys[part][32 + lane] = bi1 < 0 ? kMissKey : hit_key(bt1, bi1);
  __syncthreads();

  // the merge, one thread a ray: t, the id and the winner for the
  // attribute rows
  if (threadIdx.x < kBlockRays) {
    const int q = threadIdx.x;
    unsigned long long key = keys[0][q];
#pragma unroll
    for (int p = 1; p < kWarps; ++p) key = min(key, keys[p][q]);
    const float t = __uint_as_float(static_cast<unsigned>(key >> 32));
    const bool hit = !isinf(t);
    winner[q] = hit ? static_cast<int>(key & 0x7fffffffu) : -1;
    if (first + q < n) {
      t_out[first + q] = t;
      id_out[first + q] = hit ? winner[q] : 0;
    }
  }
  if (N_OUT == 0) return;
  __syncthreads();
  // attribute row k of ray q, consecutive threads on consecutive rays
  for (int e = threadIdx.x; e < kBlockRays * N_OUT; e += kThreads) {
    const int q = e % kBlockRays;
    const int k = e / kBlockRays;
    if (first + q >= n) continue;
    const int id = winner[q];
    const int row = k < kAttrs ? k : k + (kAttrCols - kAttrs);
    attr_out[static_cast<size_t>(k) * n + first + q] =
        id < 0 ? 0.f : attr[static_cast<size_t>(row) * tpad + id];
  }
}

// K9: a block is 4 warps sharing 64 rays of one tile, two a thread; the
// tile's ON clusters are listed in shared memory, kWindow mask words a
// round, and each round's list is cut into gridDim.y * kWarps contiguous
// shares, one a warp (blockIdx.y picks the block's kWarps). The block's
// least key of a ray goes into best with a 64-bit atomicMin.
__global__ void __launch_bounds__(kThreads)
culled_kernel(const float4* __restrict__ tri, const int* __restrict__ mask,
              int cpad, const float* __restrict__ o,
              const float* __restrict__ d, float t_min,
              unsigned long long* __restrict__ best) {
  __shared__ unsigned long long keys[kWarps][kBlockRays];
  __shared__ int list[kWindow];
  __shared__ int counts[kWarps];

  const int lane = threadIdx.x & 31;
  const int part = threadIdx.x >> 5;
  const int share = blockIdx.y * kWarps + part;
  const int shares = gridDim.y * kWarps;
  const int first = blockIdx.x * kBlockRays;   // the block lies in one tile
  const int i0 = first + lane, i1 = first + 32 + lane;   // n % 1024 == 0
  const float o0x = o[3 * i0], o0y = o[3 * i0 + 1], o0z = o[3 * i0 + 2];
  const float d0x = d[3 * i0], d0y = d[3 * i0 + 1], d0z = d[3 * i0 + 2];
  const float o1x = o[3 * i1], o1y = o[3 * i1 + 1], o1z = o[3 * i1 + 2];
  const float d1x = d[3 * i1], d1y = d[3 * i1 + 1], d1z = d[3 * i1 + 2];
  const int* tile_mask = mask + static_cast<size_t>(first / kTile) * cpad;
  const unsigned below = (1u << lane) - 1u;

  // each ray's least (t, original id): t first, the id (pack column 13)
  // read only for a t no greater than the best
  const float inf = __int_as_float(0x7f800000);
  float bt0 = inf, bt1 = inf;
  int bi0 = 0x7fffffff, bi1 = 0x7fffffff;
  for (int w0 = 0; w0 < cpad; w0 += kWindow) {
    // list the window's ON words in order: warp p ballots words w0 + p *
    // kWindow / kWarps .. and writes its entries after the earlier warps'
    constexpr int kScan = kWindow / kWarps / 32;   // ballots a warp
    unsigned bal[kScan];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int w = w0 + (part * kScan + k) * 32 + lane;
      bal[k] = __ballot_sync(0xffffffffu, w < cpad && tile_mask[w] != 0);
      mine += __popc(bal[k]);
    }
    if (lane == 0) counts[part] = mine;
    __syncthreads();                  // counts set; the last list is read
    int at = 0, total = 0;
#pragma unroll
    for (int p = 0; p < kWarps; ++p) {
      at += p < part ? counts[p] : 0;
      total += counts[p];
    }
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int w = w0 + (part * kScan + k) * 32 + lane;
      if ((bal[k] >> lane) & 1u) list[at + __popc(bal[k] & below)] = w;
      at += __popc(bal[k]);
    }
    __syncthreads();                  // the list is complete
    // this warp's share of the list; rows of a cluster in ascending order
    const int lo = total * share / shares;
    const int hi = total * (share + 1) / shares;
    for (int e = lo; e < hi; ++e) {
      const float4* rows = tri + static_cast<size_t>(list[e]) * kChunk *
                                     (kTriCols / 4);
#pragma unroll 4
      for (int r = 0; r < kChunk; ++r) {
        const float4* row = rows + r * (kTriCols / 4);
        const float4 a = __ldg(row);      // c0 c1 c2 c3
        const float4 b = __ldg(row + 1);  // c4 c5 c6 c7
        const float4 c = __ldg(row + 2);  // c8 c9 c10 c11
        float t0, t1;
        const bool ok0 = pair_test(a, b, c, o0x, o0y, o0z, d0x, d0y, d0z,
                                   t_min, t0);
        const bool ok1 = pair_test(a, b, c, o1x, o1y, o1z, d1x, d1y, d1z,
                                   t_min, t1);
        if ((ok0 && t0 <= bt0) || (ok1 && t1 <= bt1)) {
          const int id = __ldg(reinterpret_cast<const int*>(row) + 13);
          if (ok0 && (t0 < bt0 || (t0 == bt0 && id < bi0))) {
            bt0 = t0;
            bi0 = id;
          }
          if (ok1 && (t1 < bt1 || (t1 == bt1 && id < bi1))) {
            bt1 = t1;
            bi1 = id;
          }
        }
      }
    }
  }
  keys[part][lane] = isinf(bt0) ? kMissKey : hit_key(bt0, bi0);
  keys[part][32 + lane] = isinf(bt1) ? kMissKey : hit_key(bt1, bi1);
  __syncthreads();
  if (threadIdx.x < kBlockRays) {
    const int q = threadIdx.x;
    unsigned long long key = keys[0][q];
#pragma unroll
    for (int p = 1; p < kWarps; ++p) key = min(key, keys[p][q]);
    if (key != kMissKey) atomicMin(&best[first + q], key);
  }
}

// K9's last step: t and id (0 on a miss) of each ray's least key.
__global__ void hits_kernel(const unsigned long long* __restrict__ best,
                            int n, float* __restrict__ t_out,
                            int* __restrict__ id_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = best[i];
  const float t = __uint_as_float(static_cast<unsigned>(key >> 32));
  t_out[i] = t;
  id_out[i] = isinf(t) ? 0 : static_cast<int>(key & 0x7fffffffu);
}

// K9's shares of a tile's list: the fewest (1, 2, 4, .. kMostShares) that
// give the grid kCulledAim blocks an SM.
int culled_shares(int n) {
  const long long blocks = n / kBlockRays;
  return fewest_parts(kMostShares, kCulledAim,
                      [=](int shares) { return blocks * shares; });
}

template <int N_OUT>
int launch(const float* tri, const float* attr, int tpad, const float* o,
           const float* d, int n, float t_min, float* t_out, int* id_out,
           float* attr_out, void* stream) {
  closest_kernel<N_OUT><<<(n + kBlockRays - 1) / kBlockRays, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri), attr, tpad, o, d, n, t_min, t_out,
      id_out, attr_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Closest (t, triangle id) per ray (the K1 instance). Returns the CUDA error
// code of the launch (0 = cudaSuccess).
int tpt_closest_tuv(const float* tri, int tpad, const float* o,
                    const float* d, int n, float t_min, float* t_out,
                    int* id_out, void* stream) {
  return launch<0>(tri, nullptr, tpad, o, d, n, t_min, t_out, id_out,
                   nullptr, stream);
}

// Closest hit plus the winner's n_out = 11 attributes, or 27 with the guide
// rows of a 32-row pack (the K2 instances). Any other n_out is refused.
int tpt_closest_record(const float* tri, const float* attr, int tpad,
                       int n_out, const float* o, const float* d, int n,
                       float t_min, float* t_out, int* id_out,
                       float* attr_out, void* stream) {
  if (n_out == kAttrs) {
    return launch<kAttrs>(tri, attr, tpad, o, d, n, t_min, t_out, id_out,
                          attr_out, stream);
  }
  if (n_out == kAttrs + kAttrCols) {
    return launch<kAttrs + kAttrCols>(tri, attr, tpad, o, d, n, t_min, t_out,
                                      id_out, attr_out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The K1/K2 launch shape for n_out (0, 11 or 27) and n rays: out[0..3] =
// blocks, threads a block, static shared bytes a block and registers a
// thread. Returns a CUDA error code.
int tpt_closest_shape(int n_out, int n, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (n_out == 0) err = cudaFuncGetAttributes(&a, closest_kernel<0>);
  if (n_out == kAttrs) err = cudaFuncGetAttributes(&a, closest_kernel<kAttrs>);
  if (n_out == kAttrs + kAttrCols) {
    err = cudaFuncGetAttributes(&a, closest_kernel<kAttrs + kAttrCols>);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (n + kBlockRays - 1) / kBlockRays;
  out[1] = kThreads;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.numRegs;
  return 0;
}

// Closest (t, original triangle id) per ray over an ordered pack of
// 128-row clusters (column 13 the original id), skipping each cluster whose
// mask word for the ray's 1024-ray tile is 0 (the K9 instance): mask
// (n / 1024, cpad) i32, tpad = 128 * cpad, n a multiple of 1024; best (n,)
// u64 scratch holding the miss key 0x7f8000007fffffff on entry. On equal t
// the lowest original id wins; on a miss t = inf, id = 0.
int tpt_closest_culled(const float* tri, int tpad, const int* mask, int cpad,
                       const float* o, const float* d, int n, float t_min,
                       long long* best, float* t_out, int* id_out,
                       void* stream) {
  if (n % kTile || tpad != cpad * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(best);
  culled_kernel<<<dim3(n / kBlockRays, culled_shares(n)), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(tri), mask, cpad, o, d, t_min, keys);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hits_kernel<<<(n + 255) / 256, 256, 0, s>>>(keys, n, t_out, id_out);
  return static_cast<int>(cudaGetLastError());
}

// The K9 launch shape at n rays (a multiple of 1024): out[0..4] = blocks,
// threads a block, static shared bytes a block, registers a thread and
// the shares of a tile's list (blockIdx.y). Returns a CUDA error code.
int tpt_closest_culled_shape(int n, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, culled_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int shares = culled_shares(n);
  out[0] = n / kBlockRays * shares;
  out[1] = kThreads;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.numRegs;
  out[4] = shares;
  return 0;
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
