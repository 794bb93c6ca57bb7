// All-pairs closest-hit kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of tpu_pathtracer/ops/intersect_pallas.py:
//   N_OUT = 11  -> _kernel_full (+ _row_closest_full), reached through
//                  pallas_closest_record: closest hit plus the winner's 11
//                  shading attributes;
//   N_OUT = 27  -> the same on a guide-augmented (32-row) attribute pack:
//                  the 11 plus the 16 guided-sampling rows [16:32];
//   N_OUT = 0   -> _kernel (+ _row_closest), reached through
//                  pallas_closest_tuv: closest (t, triangle id) only.
// The Python side is tpu_pathtracer_torch/ops/intersect_allpairs.py, whose
// closest_tuv_plain / closest_record_plain are the plain torch versions of
// the same function; the kernel equals them bitwise when built with
// -fmad=false (no contraction into FMA, as eager torch rounds every op) and
// without --use_fast_math (IEEE division keeps the NaN rejection of padding
// rows, whose inverse is zero).
//
// Layout. The triangle pack is (tpad, 16) f32 rows [inv (9) | inv @ v0 (3) |
// pad]; the attribute pack is (16, tpad) f32 rows [n(3) albedo(3)
// emission(3) material prim pad], or (32, tpad) with the guide rows below;
// rays are (n, 3) f32 origins and directions; outputs are t (n,) f32,
// id (n,) i32 and attrs (N_OUT, n) f32, output row k being pack row k for
// k < 11 and pack row k + 5 beyond.
//
// What bounds it. The main path's scene is the 32-triangle Cornell box:
// 32 x 64 B of triangle constants against 24 B of ray and 56 B of output per
// ray, and about 40 flops (one of them an IEEE division) per ray-triangle
// pair, so the kernel is bound by arithmetic per ray, not by device memory.
// The design therefore spends no bandwidth or instructions on anything but
// that arithmetic: one thread per ray keeps its ray and its running (t, id)
// in registers; a block stages triangle rows into shared memory 128 at a
// time, and every thread of a warp reads the same row, which shared memory
// broadcasts. The TPU kernel's one-hot matmul attribute select has no
// counterpart: after the loop the thread loads the winner's attribute
// column straight from the (16, tpad) pack.
//
// Semantics kept exactly from the Pallas kernels: the affine arithmetic in
// their op order (os = c6*ox + c7*oy + c8*oz - c11, t = -os/ds, ...); the
// accept test u>=0 & v>=0 & u+v<=1 & t>1e-8 & t>=t_min; a strict '<' in
// triangle order, so on equal t the lowest triangle id wins; on a miss
// t = +inf, id = 0 and all attributes are zero.

#include <cuda_runtime.h>

namespace {

constexpr int kRaysPerBlock = 128;   // one thread per ray
constexpr int kChunk = 128;          // triangle rows staged per step
constexpr int kTriCols = 16;         // floats per triangle row
constexpr int kRowVec = 3;           // float4s read per row (columns 0..11)
constexpr int kAttrs = 11;           // shading attribute rows of a record
constexpr int kAttrCols = 16;        // rows of the plain attribute pack

template <int N_OUT>
__global__ void __launch_bounds__(kRaysPerBlock)
closest_hit_kernel(const float* __restrict__ tri, const float* __restrict__ attr,
                   int tpad, const float* __restrict__ o,
                   const float* __restrict__ d, int n, float t_min,
                   float* __restrict__ t_out, int* __restrict__ id_out,
                   float* __restrict__ attr_out) {
  __shared__ float4 rows[kChunk * kRowVec];

  const int i = blockIdx.x * kRaysPerBlock + threadIdx.x;
  const bool active = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
  }

  float best_t = __int_as_float(0x7f800000);  // +inf
  int best_id = -1;
  const float4* tri4 = reinterpret_cast<const float4*>(tri);

  for (int base = 0; base < tpad; base += kChunk) {
    const int count = min(kChunk, tpad - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < count * kRowVec; k += kRaysPerBlock) {
      const int r = k / kRowVec;
      rows[k] = tri4[(base + r) * (kTriCols / 4) + (k - r * kRowVec)];
    }
    __syncthreads();
    if (active) {
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
        const bool ok = (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                        (t > 1e-8f) & (t >= t_min);
        if (ok && t < best_t) {
          best_t = t;
          best_id = base + r;
        }
      }
    }
  }

  if (!active) return;
  t_out[i] = best_t;
  id_out[i] = best_id < 0 ? 0 : best_id;
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) {
    const int row = k < kAttrs ? k : k + (kAttrCols - kAttrs);
    attr_out[k * n + i] = best_id < 0 ? 0.f : attr[row * tpad + best_id];
  }
}

template <int N_OUT>
int launch(const float* tri, const float* attr, int tpad, const float* o,
           const float* d, int n, float t_min, float* t_out, int* id_out,
           float* attr_out, void* stream) {
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  closest_hit_kernel<N_OUT>
      <<<blocks, kRaysPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          tri, attr, tpad, o, d, n, t_min, t_out, id_out, attr_out);
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

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
