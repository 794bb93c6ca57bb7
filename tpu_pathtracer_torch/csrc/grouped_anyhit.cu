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
// What bounds it. Per pair ~40 flops; on the sub-5 solve a call tests
// 2**20 segments, about half with maxd = 0. The design spends that
// arithmetic only where the answer is still open: a lane with maxd <= 0 is
// decided from the start, a lane stops testing once blocked, and the block
// leaves its walk when every lane is decided (__syncthreads_and, reached by
// every thread, so the exit is uniform). Blocks are one tile's 32-group mask
// word (256 segments) times `slices` interleaved shares of the schedule, as
// in K6; a blocked lane writes 1 (the output starts at 0), which any share
// may do.
//
// K13 walks K12's supercluster schedule (grouped_closest.cu): a block
// stages an entry's 1024-row span (64 KiB of dynamic shared memory) once and
// runs K7's pair test on the slices of the members whose mask word for the
// block is non-zero, with K7's votes: the block leaves when every lane is
// decided. An OR again, so K13 equals K7 and its plain version bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // segments per block: one mask word of a tile
constexpr int kTile = 1024;     // segments per tile
constexpr int kWords = 4;       // mask words per (tile, cluster)
constexpr int kChunk = 128;     // triangles per cluster
constexpr int kRowVec = 4;      // float4s per pack row
constexpr int kSC = 8;          // clusters per supercluster entry
constexpr int kSpanVec = kSC * kChunk * kRowVec;   // float4s of a span
constexpr int kSpanBytes = kSpanVec * 16;          // 65,536

// Does the segment hit one of a staged cluster's 128 rows (rows: its pack
// rows) at 1e-5 < t < md, on a primitive other than fa and fb?
__device__ __forceinline__ bool anyhit_rows(
    const float4* rows, float ox, float oy, float oz, float dx, float dy,
    float dz, float md, float fa, float fb) {
  for (int r = 0; r < kChunk; ++r) {
    const float4 a = rows[r * kRowVec];      // c0 c1 c2 c3
    const float4 b = rows[r * kRowVec + 1];  // c4 c5 c6 c7
    const float4 c = rows[r * kRowVec + 2];  // c8 c9 c10 c11
    const float p = rows[r * kRowVec + 3].x; // c12: primitive id
    const float os = b.z * ox + b.w * oy + c.x * oz - c.w;
    const float ds = b.z * dx + b.w * dy + c.x * dz;
    const float t = -os / ds;
    const float u = (a.x * ox + a.y * oy + a.z * oz - c.y) +
                    t * (a.x * dx + a.y * dy + a.z * dz);
    const float v = (a.w * ox + b.x * oy + b.y * oz - c.z) +
                    t * (a.w * dx + b.x * dy + b.y * dz);
    if ((u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) & (t > 1e-5f) &
        (t < md) & (p != fa) & (p != fb)) {
      return true;
    }
  }
  return false;
}

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
  const float md = maxd[ray];
  const float fa = static_cast<float>(ex_a[ray]);
  const float fb = static_cast<float>(ex_b[ray]);
  bool blocked = false;
  bool decided = !(md > 0.f);    // maxd <= 0 (or NaN): never blocked

  const int n_active = count[tile];
  const int* cl_list = clusters + static_cast<size_t>(tile) * cpad;
  const int* m_list =
      masks + (static_cast<size_t>(tile) * kWords + w) * cpad;
  for (int base = 0; base < n_active; base += kThreads) {
    // barrier (the previous chunk is no longer read) and block-wide vote
    if (__syncthreads_and(decided)) break;
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
      // barrier (the previous cluster is not read) and block-wide vote
      if (__syncthreads_and(decided)) break;
      for (int k = tid; k < kChunk * kRowVec; k += kThreads) rows[k] = src[k];
      __syncthreads();
      if (!decided && (m & bit)) {
        blocked = anyhit_rows(rows, ox, oy, oz, dx, dy, dz, md, fa, fb);
        decided = blocked;
      }
    }
  }
  if (blocked) blocked_out[ray] = 1;
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
