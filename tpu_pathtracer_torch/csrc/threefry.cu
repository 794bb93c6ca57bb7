// Counter-mode threefry-2x32 draws for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package draws with jax.random's threefry
// (tpu_pathtracer/core/rng.py), which XLA fuses into the ops around it. The
// port's plain version is tpu_pathtracer_torch/core/rng.py's threefry2x32,
// int64 tensor ops masked to 32 bits: on the card each of its ~180 ops is one
// elementwise launch over int64 tensors. This kernel is the whole draw in
// one launch, bit for bit the plain version's: the key schedule
// (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) in registers, 20 rounds in uint32 with
// rotations by funnel shifts, the five key injections, then the mantissa
// fill ((bits >> 9) | 0x3F800000) as float32, less 1.0f (exact), or the key
// words for fold_in. Every op is an integer op or an exact float op, so no
// build flag changes a bit.
//
// Three modes, chosen by `mode` (the Python side is core/rng.py):
//   kLane    (B, n) float32: block k of lane i hashes (lane_ids[i],
//            k + sub_ids[i] * 256), or (lane_ids[i], k) without sub ids, and
//            yields draws 2k and 2k + 1 (the second dropped when n is odd).
//            lane_ids and sub_ids are int64, read with their strides (0
//            broadcasts one sub id), so no copy or mask runs first. The key
//            is the scalar one, or the broadcast key (key0[0], key1[0]) read
//            from device memory: a CUDA graph that replays the launch then
//            draws under whatever key the buffer holds.
//   kUniform (K, n) float32: element j of key g hashes (0, j) and yields
//            its bits y0 ^ y1; key g is (key0[g], key1[g]) or the scalar
//            key. A thread makes kVec consecutive draws of one key and
//            stores them as one float4 where the row allows it.
//   kFold    two (n,) int64 key-word arrays: threefry(key, 0, data) of each
//            element, the key per element (key0, key1) or scalar, the data
//            per element (ids, with its stride) or the scalar `data`.
//
// What bounds it. A hash is ~77 uint32 ops (2 + 20 x 3 + 5 x 3) for 8 B of
// output in lane mode and 4 B in uniform mode; at the H100's 33.5 TOPS of
// int32 throughput (128 lanes an SM a clock) that is ~4.3e11 hashes a second
// against ~8.4e11 float32 stores a second of HBM bandwidth: the integer
// rounds bound it. The design keeps every thread on rounds: no shared
// memory, no barrier, one 8- or 16-byte store per thread, kVec independent
// hashes a thread in uniform mode for instruction-level parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                 // draws a thread in uniform mode
constexpr long long kMaxBlocks = 1 << 20;   // grid-stride beyond this
constexpr uint32_t kParity = 0x1BD11BDAu;

enum Mode : int { kLane = 0, kUniform = 1, kFold = 2 };

struct Args {
  uint32_t k0, k1;            // scalar key words (key0 == nullptr)
  const long long* key0;      // key words: kUniform K, kFold n, kLane 1
  const long long* key1;
  const long long* ids;       // kLane lane ids, kFold data (or nullptr)
  long long ids_stride;
  const long long* sub;       // kLane sub ids (or nullptr)
  long long sub_stride;
  uint32_t data;              // kFold scalar data (ids == nullptr)
  long long rows, n;          // kLane B x n draws; kUniform K x n; kFold n
  float* out;                 // kLane, kUniform
  long long* out0;            // kFold
  long long* out1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds with rotations r0..r3, then key injection `i` (0-based).
#define TPT_ROUND(r)                                                     \
  x0 += x1;                                                              \
  x1 = rotl(x1, r) ^ x0;
#define TPT_GROUP(r0, r1, r2, r3, ka, kb, i)                             \
  TPT_ROUND(r0) TPT_ROUND(r1) TPT_ROUND(r2) TPT_ROUND(r3)                \
  x0 += ka;                                                              \
  x1 += kb + (i) + 1u;

// threefry2x32 (20 rounds) of the counter (x0, x1) under (k0, k1), as
// jax.extend.random.threefry_2x32 and core/rng.py's threefry2x32 compute it.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  TPT_GROUP(13, 15, 26, 6, k1, k2, 0u)
  TPT_GROUP(17, 29, 16, 24, k2, k0, 1u)
  TPT_GROUP(13, 15, 26, 6, k0, k1, 2u)
  TPT_GROUP(17, 29, 16, 24, k1, k2, 3u)
  TPT_GROUP(13, 15, 26, 6, k2, k0, 4u)
}

#undef TPT_GROUP
#undef TPT_ROUND

// 32 random bits -> float32 in [0, 1) by the mantissa fill.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// q / d for q, d >= 0: a 32-bit division where both fit (the draws of the
// port's paths), else a 64-bit one.
__device__ __forceinline__ long long quotient(long long q, long long d) {
  if ((q | d) < (1ll << 32))
    return static_cast<uint32_t>(q) / static_cast<uint32_t>(d);
  return q / d;
}

__device__ __forceinline__ void lane_item(const Args& a, long long q) {
  const long long half = (a.n + 1) >> 1;
  const long long i = quotient(q, half);
  const uint32_t k = static_cast<uint32_t>(q - i * half);
  uint32_t x0 = static_cast<uint32_t>(a.ids[i * a.ids_stride]);
  uint32_t x1 = k;
  if (a.sub != nullptr)
    x1 += static_cast<uint32_t>(a.sub[i * a.sub_stride]) * 256u;
  uint32_t k0 = a.k0, k1 = a.k1;
  if (a.key0 != nullptr) {
    k0 = static_cast<uint32_t>(a.key0[0]);
    k1 = static_cast<uint32_t>(a.key1[0]);
  }
  threefry(k0, k1, x0, x1);
  float* row = a.out + i * a.n;
  const float f0 = unit_float(x0), f1 = unit_float(x1);
  if ((a.n & 1) == 0) {        // the row and 2k are even: 8-byte aligned
    reinterpret_cast<float2*>(row)[k] = make_float2(f0, f1);
  } else {
    row[2 * k] = f0;
    if (2 * k + 1 < a.n) row[2 * k + 1] = f1;
  }
}

__device__ __forceinline__ void uniform_item(const Args& a, long long q) {
  const long long nq = (a.n + kVec - 1) / kVec;
  const long long g = quotient(q, nq);
  const long long j0 = (q - g * nq) * kVec;
  uint32_t k0 = a.k0, k1 = a.k1;
  if (a.key0 != nullptr) {
    k0 = static_cast<uint32_t>(a.key0[g]);
    k1 = static_cast<uint32_t>(a.key1[g]);
  }
  float f[kVec];
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(j0 + m);
    threefry(k0, k1, x0, x1);
    f[m] = unit_float(x0 ^ x1);
  }
  float* row = a.out + g * a.n;
  if (a.n % kVec == 0) {       // every row and j0 are 16-byte aligned
    reinterpret_cast<float4*>(row + j0)[0] = make_float4(f[0], f[1], f[2],
                                                         f[3]);
  } else {
#pragma unroll
    for (int m = 0; m < kVec; ++m)
      if (j0 + m < a.n) row[j0 + m] = f[m];
  }
}

__device__ __forceinline__ void fold_item(const Args& a, long long q) {
  uint32_t k0 = a.k0, k1 = a.k1;
  if (a.key0 != nullptr) {
    k0 = static_cast<uint32_t>(a.key0[q]);
    k1 = static_cast<uint32_t>(a.key1[q]);
  }
  uint32_t x0 = 0u;
  uint32_t x1 = a.ids != nullptr
                    ? static_cast<uint32_t>(a.ids[q * a.ids_stride])
                    : a.data;
  threefry(k0, k1, x0, x1);
  a.out0[q] = static_cast<long long>(x0);
  a.out1[q] = static_cast<long long>(x1);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const Args a, const long long items) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       q < items; q += step) {
    if (kMode == kLane)
      lane_item(a, q);
    else if (kMode == kUniform)
      uniform_item(a, q);
    else
      fold_item(a, q);
  }
}

long long work_items(int mode, long long rows, long long n) {
  switch (mode) {
    case kLane: return rows * ((n + 1) / 2);
    case kUniform: return rows * ((n + kVec - 1) / kVec);
    case kFold: return n;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// One draw (see the modes above) on `stream`. Returns the CUDA error code of
// the launch (0 = cudaSuccess; nothing is launched for an empty draw).
int tpt_threefry(int mode, uint32_t k0, uint32_t k1, const long long* key0,
                 const long long* key1, const long long* ids,
                 long long ids_stride, const long long* sub,
                 long long sub_stride, uint32_t data, long long rows,
                 long long n, void* out, long long* out1, void* stream) {
  const Args a{k0, k1, key0, key1, ids, ids_stride, sub, sub_stride, data,
               rows, n, static_cast<float*>(out),
               static_cast<long long*>(out), out1};
  const long long items = work_items(mode, rows, n);
  if (items < 0 || rows < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return 0;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kLane)
    threefry_kernel<kLane><<<grid, kThreads, 0, st>>>(a, items);
  else if (mode == kUniform)
    threefry_kernel<kUniform><<<grid, kThreads, 0, st>>>(a, items);
  else
    threefry_kernel<kFold><<<grid, kThreads, 0, st>>>(a, items);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
