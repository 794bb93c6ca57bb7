// All-pairs any-hit (visibility) kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel _kernel_anyhit of
// tpu_pathtracer/ops/intersect_pallas.py, reached through pallas_occluded:
// for each segment i, whether any triangle satisfies
//   u >= 0 & v >= 0 & u + v <= 1 & 1e-5 < t < maxd[i]
//   & prim != ex_a[i] & prim != ex_b[i].
// It is the form-factor visibility of the radiosity solve and NEE's shadow
// rays on the all-pairs backend. The Python side is
// tpu_pathtracer_torch/ops/intersect_allpairs.py, whose occluded_plain is the
// plain torch version of the same function. Each pair's t, u and v are the
// affine arithmetic of the Pallas kernel in its op order, built with
// -fmad=false and IEEE division (no --use_fast_math) as in closest_hit.cu, so
// every pair test equals the plain version's; the result is an OR of those
// tests, so the order in which they are made, and tests made beyond the
// first blocking row, do not matter: the kernel equals the plain version
// bitwise.
//
// Layout. The triangle pack is (tpad, 16) f32 rows [inv (9) | inv @ v0 (3) |
// pad]; prim ids are (tpad,) i32, -2 on padding rows (whose zero inverse
// gives t = NaN, rejected by every comparison); segments are (n, 3) f32
// origins and unit directions, maxd (n,) f32 and ex_a, ex_b (n,) i32;
// the output is (n,) bool as one byte each.
//
// What bounds it. ~40 flops a pair around an IEEE division, ~63
// instructions under -fmad=false (closest_hit.cu's SASS), against 64 B of
// triangle constants a row shared by every segment: instruction issue. On
// the radiosity path (2,048 triangles, a million segments a sample pass)
// most of the batch needs no test at all: the form-factor estimator zeroes
// maxd on every inactive pair, over half the batch, and a segment is
// decided by its first blocking row.
//
// The design spends lanes only on open segments. A block of 8 warps takes
// a window of 256 consecutive segments: it writes 0 for every segment
// with maxd <= 0 (or NaN: t > 1e-5 and t < maxd cannot both hold) and
// lists the open ones with their data in shared memory (a ballot a warp,
// one shared atomic a warp for the list's slots, so the list keeps each
// warp's order; the loads are the window's, coalesced, so that no item
// waits on device memory for its segments). The list is given out
// as items of 8 segments x 4 row lanes, claimed one at a time by a warp
// from a shared counter, with no block barrier after the listing: lane l
// tests segment l & 7 against rows l >> 3, (l >> 3) + 4, ..., two rows
// at a time, read straight from the pack through L1 (a load instruction
// covers 4 consecutive rows, and every segment of the window reads the same
// rows; a vote step wholly inside the pack skips the row bound checks). A
// lane stops at its first blocking row; every 8 rows of a lane (32 of the
// item) the warp votes, a segment whose 4 lanes saw no hit yet stays
// open, and the item ends when its 8 segments are decided. The output
// byte of an open segment is written once, by its first lane. One design
// serves the solve's 2,048 rows and NEE's 32: on the H100, items of 16 x 2
// and 32 x 1 lanes were slower at 2,048 rows, votes every 16 or 32 rows a
// lane cost the 32-row batches more than they saved at 2,048, and windows
// of 512 and 1,024 segments left too few blocks at 65,536 segments. (The
// port's first design ran one thread a segment in 128-segment blocks,
// staging 128 rows between two barriers and leaving the chunk loop when
// every lane of the block was decided: inactive and early-blocked lanes
// idled while their block finished its rows.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // 8 warps a block
constexpr int kWindow = 256;         // consecutive segments a block
constexpr int kSegs = 8;             // segments of a work item
constexpr int kRowLanes = 32 / kSegs;   // lanes of an item per segment
constexpr int kVote = 8;             // rows a lane tests between votes
constexpr int kAtOnce = 2;           // rows a lane tests side by side
constexpr int kStep = kRowLanes * kVote;   // rows of an item between votes
constexpr int kRowVec = 4;           // float4s per triangle row
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAll = kSegs == 32 ? kFull : (1u << kSegs) - 1u;

static_assert(kWindow % kThreads == 0, "every lane takes part in a ballot");
static_assert(32 % kSegs == 0, "an item is one warp");
static_assert(kVote % kAtOnce == 0, "a vote's rows come in whole steps");

// Does segment (o, d, md, ea, eb) hit pack row r on another primitive at
// 1e-5 < t < md? The Pallas op order; every op rounds (-fmad=false).
__device__ __forceinline__ bool pair_blocks(
    const float4* __restrict__ tri4, const int* __restrict__ prim, int r,
    float ox, float oy, float oz, float dx, float dy, float dz, float md,
    int ea, int eb) {
  const float4* row = tri4 + r * kRowVec;
  const float4 a = __ldg(row);       // c0 c1 c2 c3
  const float4 b = __ldg(row + 1);   // c4 c5 c6 c7
  const float4 c = __ldg(row + 2);   // c8 c9 c10 c11
  const int p = __ldg(prim + r);
  const float os = b.z * ox + b.w * oy + c.x * oz - c.w;
  const float ds = b.z * dx + b.w * dy + c.x * dz;
  const float t = -os / ds;
  const float u = (a.x * ox + a.y * oy + a.z * oz - c.y) +
                  t * (a.x * dx + a.y * dy + a.z * dz);
  const float v = (a.w * ox + b.x * oy + b.y * oz - c.z) +
                  t * (a.w * dx + b.x * dy + b.y * dz);
  return (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) & (t > 1e-5f) &
         (t < md) & (p != ea) & (p != eb);
}

// Does one of the lane's kVote rows r, r + kRowLanes, ... block the
// segment? kTail: the rows may run past tpad.
template <bool kTail>
__device__ __forceinline__ bool lane_rows_block(
    const float4* __restrict__ tri4, const int* __restrict__ prim, int tpad,
    int r, float ox, float oy, float oz, float dx, float dy, float dz,
    float md, int ea, int eb) {
  for (int k = 0; k < kVote; k += kAtOnce) {
    bool h = false;
#pragma unroll
    for (int m = 0; m < kAtOnce; ++m) {
      const int rr = r + kRowLanes * (k + m);
      h |= (!kTail || rr < tpad) &&
           pair_blocks(tri4, prim, rr, ox, oy, oz, dx, dy, dz, md, ea, eb);
    }
    if (h) return true;
  }
  return false;
}

// The item's segments (bit s, s < kSegs) some lane of which has `flag`.
__device__ __forceinline__ unsigned per_segment(bool flag) {
  unsigned b = __ballot_sync(kFull, flag);
  for (int sh = 16; sh >= kSegs; sh >>= 1) b |= b >> sh;
  return b & kAll;
}

// The next item of a warp's block that no warp has claimed.
__device__ __forceinline__ int next_item(int* s_next, int lane) {
  int item = 0;
  if (lane == 0) item = atomicAdd(s_next, 1);
  return __shfl_sync(kFull, item, 0);
}

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ tri, const int* __restrict__ prim,
               int tpad, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ maxd,
               const int* __restrict__ ex_a, const int* __restrict__ ex_b,
               int n, unsigned char* __restrict__ blocked_out) {
  __shared__ int s_open[kWindow];    // the window's open segments
  __shared__ float s_seg[7][kWindow];  // and their o, d and maxd
  __shared__ int s_ex[2][kWindow];   // and ex_a, ex_b
  __shared__ int s_count;            // how many
  __shared__ int s_next;             // the next item no warp has claimed

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int base = blockIdx.x * kWindow;
  if (tid == 0) {
    s_count = 0;
    s_next = 0;
  }
  __syncthreads();
  for (int k = tid; k < kWindow; k += kThreads) {
    const int i = base + k;
    float seg[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // o, d, maxd
    int ea = 0, eb = 0;
    if (i < n) {                      // all at once: one trip to memory
      for (int c = 0; c < 3; ++c) {
        seg[c] = o[3 * i + c];
        seg[3 + c] = d[3 * i + c];
      }
      seg[6] = maxd[i];
      ea = ex_a[i];
      eb = ex_b[i];
      if (!(seg[6] > 0.f)) blocked_out[i] = 0;   // decided: never blocked
    }
    const bool open = seg[6] > 0.f;
    const unsigned bal = __ballot_sync(kFull, open);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(&s_count, __popc(bal));
    at = __shfl_sync(kFull, at, 0);
    if (open) {
      const int j = at + __popc(bal & ((1u << lane) - 1u));
      s_open[j] = i;
      for (int c = 0; c < 7; ++c) s_seg[c][j] = seg[c];
      s_ex[0][j] = ea;
      s_ex[1][j] = eb;
    }
  }
  __syncthreads();

  const float4* tri4 = reinterpret_cast<const float4*>(tri);
  const int n_open = s_count;
  const int n_items = (n_open + kSegs - 1) / kSegs;
  const int sl = lane % kSegs;        // the lane's segment of an item
  const int q = lane / kSegs;         // and its row lane
  for (int item = next_item(&s_next, lane); item < n_items;
       item = next_item(&s_next, lane)) {   // warp-uniform
    const int slot = item * kSegs + sl;
    const bool valid = slot < n_open;
    const int j = valid ? slot : 0;
    const int i = s_open[j];
    const float ox = s_seg[0][j], oy = s_seg[1][j], oz = s_seg[2][j],
                dx = s_seg[3][j], dy = s_seg[4][j], dz = s_seg[5][j],
                md = s_seg[6][j];
    const int ea = s_ex[0][j], eb = s_ex[1][j];
    const unsigned absent = per_segment(!valid);   // past the list's end
    unsigned blocked = 0u;
    bool hit = false;
    for (int r0 = 0; r0 < tpad && (blocked | absent) != kAll;
         r0 += kStep) {                // warp-uniform: every lane votes
      if (!(((blocked | absent) >> sl) & 1u)) {
        hit = r0 + kStep <= tpad
                  ? lane_rows_block<false>(tri4, prim, tpad, r0 + q, ox, oy,
                                           oz, dx, dy, dz, md, ea, eb)
                  : lane_rows_block<true>(tri4, prim, tpad, r0 + q, ox, oy,
                                          oz, dx, dy, dz, md, ea, eb);
      }
      blocked = per_segment(hit);
    }
    if (valid && q == 0) blocked_out[i] = (blocked >> sl) & 1u;
  }
}

}  // namespace

extern "C" {

// Any hit per segment (the K3 kernel). Returns the CUDA error code of the
// launch (0 = cudaSuccess).
int tpt_any_hit(const float* tri, const int* prim, int tpad, const float* o,
                const float* d, const float* maxd, const int* ex_a,
                const int* ex_b, int n, unsigned char* blocked_out,
                void* stream) {
  if (n < 0 || tpad < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + kWindow - 1) / kWindow;
  any_hit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, prim, tpad, o, d, maxd, ex_a, ex_b, n, blocked_out);
  return static_cast<int>(cudaGetLastError());
}

// The K3 launch shape for n segments: out[0..3] = blocks, threads a block,
// static shared bytes a block and registers a thread. Returns a CUDA error
// code.
int tpt_any_hit_shape(int n, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, any_hit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (n + kWindow - 1) / kWindow;
  out[1] = kThreads;
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.numRegs;
  return 0;
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
