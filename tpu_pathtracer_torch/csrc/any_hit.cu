// All-pairs any-hit (visibility) kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel _kernel_anyhit of
// tpu_pathtracer/ops/intersect_pallas.py, reached through pallas_occluded:
// for each segment i, whether any triangle satisfies
//   u >= 0 & v >= 0 & u + v <= 1 & 1e-5 < t < maxd[i]
//   & prim != ex_a[i] & prim != ex_b[i].
// It is the form-factor visibility of the radiosity solve. The Python side is
// tpu_pathtracer_torch/ops/intersect_allpairs.py, whose occluded_plain is the
// plain torch version of the same function. Each pair's t, u and v are the
// affine arithmetic of the Pallas kernel in its op order, built with
// -fmad=false and IEEE division (no --use_fast_math) as in closest_hit.cu, so
// every pair test equals the plain version's; the result is an OR of those
// tests, so the order in which they are made does not matter and the kernel
// equals the plain version bitwise.
//
// Layout. The triangle pack is (tpad, 16) f32 rows [inv (9) | inv @ v0 (3) |
// pad]; prim ids are (tpad,) i32, -2 on padding rows (whose zero inverse
// gives t = NaN, rejected by every comparison); segments are (n, 3) f32
// origins and unit directions, maxd (n,) f32 and ex_a, ex_b (n,) i32;
// the output is (n,) bool as one byte each.
//
// What bounds it. On the radiosity path the subdivided Cornell box has 2,048
// triangles and a solve step tests up to a million segments: ~40 flops (one
// an IEEE division) per segment-triangle pair, 32 KB of triangle constants
// against 40 B per segment, so it is bound by arithmetic. The design spends
// that arithmetic only where the answer is still open: one thread per
// segment keeps its segment in registers; a block stages 128 triangle rows
// and their prim ids in shared memory at a time (every thread of a warp
// reads the same row, which shared memory broadcasts); a lane is decided
// from the start where maxd <= 0 (t > 1e-5 and t < maxd cannot both hold,
// and the form-factor estimator zeroes maxd on every inactive pair, over
// half the batch) and stops testing once it is blocked; the block leaves its
// chunk loop when every lane is decided (__syncthreads_and, a barrier that
// every thread of the block reaches, so the exit is uniform).

#include <cuda_runtime.h>

namespace {

constexpr int kSegsPerBlock = 128;   // one thread per segment
constexpr int kChunk = 128;          // triangle rows staged per step
constexpr int kTriCols = 16;         // floats per triangle row
constexpr int kRowVec = 3;           // float4s read per row (columns 0..11)

__global__ void __launch_bounds__(kSegsPerBlock)
any_hit_kernel(const float* __restrict__ tri, const int* __restrict__ prim,
               int tpad, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ maxd,
               const int* __restrict__ ex_a, const int* __restrict__ ex_b,
               int n, unsigned char* __restrict__ blocked_out) {
  __shared__ float4 rows[kChunk * kRowVec];
  __shared__ int prims[kChunk];

  const int i = blockIdx.x * kSegsPerBlock + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float md = 0.f;
  int ea = 0, eb = 0;
  bool blocked = false;
  bool decided = true;   // out of range, maxd <= 0 (or NaN), or blocked
  if (i < n) {
    md = maxd[i];
    decided = !(md > 0.f);
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    ea = ex_a[i];
    eb = ex_b[i];
  }

  const float4* tri4 = reinterpret_cast<const float4*>(tri);
  for (int base = 0; base < tpad; base += kChunk) {
    // Barrier (the previous chunk is no longer read) and block-wide vote.
    if (__syncthreads_and(decided)) break;
    const int count = min(kChunk, tpad - base);
    for (int k = threadIdx.x; k < count * kRowVec; k += kSegsPerBlock) {
      const int r = k / kRowVec;
      rows[k] = tri4[(base + r) * (kTriCols / 4) + (k - r * kRowVec)];
    }
    for (int k = threadIdx.x; k < count; k += kSegsPerBlock) {
      prims[k] = prim[base + k];
    }
    __syncthreads();
    if (!decided) {
      for (int r = 0; r < count; ++r) {
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
        const int p = prims[r];
        if ((u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) & (t > 1e-5f) &
            (t < md) & (p != ea) & (p != eb)) {
          blocked = true;
          break;
        }
      }
      decided = blocked;
    }
  }

  if (i < n) blocked_out[i] = blocked ? 1 : 0;
}

}  // namespace

extern "C" {

// Any hit per segment (the K3 kernel). Returns the CUDA error code of the
// launch (0 = cudaSuccess).
int tpt_any_hit(const float* tri, const int* prim, int tpad, const float* o,
                const float* d, const float* maxd, const int* ex_a,
                const int* ex_b, int n, unsigned char* blocked_out,
                void* stream) {
  const int blocks = (n + kSegsPerBlock - 1) / kSegsPerBlock;
  any_hit_kernel<<<blocks, kSegsPerBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      tri, prim, tpad, o, d, maxd, ex_a, ex_b, n, blocked_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
