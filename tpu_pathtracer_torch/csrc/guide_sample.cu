// Radiosity-guided direction sampling for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package's sample_grid and sample_grid_mis
// (tpu_pathtracer/ops/guiding.py) are XLA ops that XLA fuses. The port's
// plain version is tpu_pathtracer_torch/ops/guiding.py's
// _sample_grid_eager / _sample_grid_mis_eager: on the card each of its
// ~70-110 ops (rank counts, row gathers, the Frisvad frame, normalise, two
// cell-pdf chains) is one small launch. This kernel is the whole sampler in
// one launch, one thread a lane, bit for bit the plain version's:
//   - the theta rank over the lane's guide row (clamp xi to 0.999999, count
//     cdf <= xi, clip to 7), the theta_table row prim * 8 + theta, the phi
//     rank over its 16 CDF entries;
//   - the jittered direction (idx + j) * GRID_INV_HALF_RES * (pi / 2) (phi:
//     * GRID_INV_RES * 2 pi), the theta clamp, sinf / cosf, the Frisvad
//     frame with its z < -0.9999999 branch, normalise as v * (1 / len);
//   - the cell pdf of the sampled cell and, in MIS mode, of the given
//     cosine bins (tb, pb), 0 where `below`; and the grid's validity.
// Every op rounds as the eager op does: the Python scalars are the f32
// values PyTorch makes of them (the k* constants), each product and sum is
// rounded on its own (__fmul_rn / __fadd_rn cannot be contracted into an
// FMA), division and sqrt are IEEE, sinf / cosf are libdevice's, as
// torch.sin / torch.cos on the card.
//
// Inputs are read in place, through their strides: the guide row is
// either the hit record's transposed view of K2-guide's output (a lane's 16
// floats strided by B) or a gather of prim_table; the four draws are
// columns of the lane draws; prim, tb and pb are int32 or int64. A lane's
// prim lies in [0, N) (a miss is 0); theta and phi are clipped and tb, pb
// clamped to their ranges, so no read leaves the tables.
//
// What bounds it. A lane reads 10 floats of its guide row, 16 + 2 of the
// theta_table, its normal, 4 draws and its two bins, and writes a
// direction, two pdfs and a flag: ~200 B, ~13 MB at 65,536 lanes, ~4 us at
// 3.35 TB/s. At that size the call is latency-bound (256 blocks for 132
// SMs); the design keeps it one pass: no shared memory, no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;   // grid-stride beyond this
constexpr int kHalfRes = 8;                 // GRID_HALF_RES theta rows
constexpr int kRes = 16;                    // GRID_RES phi cells
constexpr int kTableRow = 32;               // [phi CDF(16) | pdf row(16)]

// The f32 values of the Python scalars (torch rounds a Python float to the
// tensor's float32 before the op).
constexpr float kXiMax = 0x1.ffffdep-1f;       // 0.999999
constexpr float kInvHalfRes = 0x1p-3f;         // GRID_INV_HALF_RES
constexpr float kInvRes = 0x1p-4f;             // GRID_INV_RES
constexpr float kHalfPi = 0x1.921fb6p+0f;      // PI * 0.5
constexpr float kThetaMax = 0x1.8f905ap+0f;    // PI * 0.5 - 0.01
constexpr float kTwoPi = 0x1.921fb6p+2f;       // TWO_PI
constexpr float kSingular = -0x1.fffffcp-1f;   // -0.9999999
constexpr float kLenEps = 0x1.79ca1p-67f;      // 1e-20
constexpr float kPdfEps = 0x1.0c6f7ap-20f;     // 1e-6
constexpr float kCellEps = 0x1.5798eep-27f;    // 1e-8
constexpr float kSinFloor = 0x1.47ae14p-7f;    // 0.01
constexpr float kDTheta = 0x1.921fb6p-3f;      // GRID_D_THETA
constexpr float kDPhi = 0x1.921fb6p-2f;        // GRID_D_PHI

}  // namespace

extern "C" {

// The launch's arguments (mirrored by ops/guiding.py's _Args): pointers,
// then strides in elements, then flags. u = (xi1, xi2, jt, jp); tb, pb,
// below, pdf_b and valid are read or written only when `mis` is set.
struct GuideArgs {
  const void* row;       // (B, 16) float32 guide rows
  const void* prim;      // (B,) int32 / int64
  const void* table;     // (N * 8, 32) float32 theta_table, contiguous
  const void* normal;    // (B, 3) float32
  const void* u[4];      // (B,) float32 each
  const void* tb;        // (B,) int32 / int64: d_b's theta bin
  const void* pb;        // (B,) int32 / int64: d_b's phi bin
  const void* below;     // (B,) bool: d_b below the horizon
  void* dir;             // (B, 3) float32 out, contiguous
  void* pdf_g;           // (B,) float32 out
  void* pdf_b;           // (B,) float32 out
  void* valid;           // (B,) bool out
  long long row_s0, row_s1, prim_s, n_s0, n_s1, u_s[4], tb_s, pb_s, below_s;
  long long lanes;
  int mis, prim64, tb64, pb64;
};

}  // extern "C"

static_assert(sizeof(GuideArgs) == 240, "GuideArgs must match _Args");

namespace {

__device__ __forceinline__ long long load_index(const void* p, long long i,
                                                long long s, int is64) {
  return is64 ? static_cast<const long long*>(p)[i * s]
              : static_cast<long long>(static_cast<const int*>(p)[i * s]);
}

__device__ __forceinline__ int clamp_index(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

// torch.clamp's NaN rule: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// _rank_cdf: #{k : cdf[k] <= clamp(xi, 0, 0.999999)}, at most kN - 1.
template <int kN>
__device__ __forceinline__ int rank_cdf(const float* cdf, long long stride,
                                        float xi) {
  xi = clamp_max(clamp_min(xi, 0.0f), kXiMax);
  int c = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) c += cdf[k * stride] <= xi ? 1 : 0;
  return min(c, kN - 1);
}

// _cell_pdf_math: the cell's probability over its solid angle.
__device__ __forceinline__ float cell_pdf(float cell, float total,
                                          int theta_idx) {
  const float prob = __fdiv_rn(cell, clamp_min(total, kPdfEps));
  const float theta_c = __fmul_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(theta_idx), 0.5f), kInvHalfRes),
      kHalfPi);
  const float sin_t = clamp_min(sinf(theta_c), kSinFloor);
  const float solid = __fmul_rn(__fmul_rn(sin_t, kDTheta), kDPhi);
  const float val = __fdiv_rn(prob, clamp_min(solid, kPdfEps));
  return cell < kCellEps ? kPdfEps : val;
}

// _sampled_direction: spherical_to_local, then from_local through
// build_frame's Frisvad frame of n, then normalize.
__device__ __forceinline__ void sampled_direction(int ti, int pi, float jt,
                                                  float jp, float nx,
                                                  float ny, float nz,
                                                  float* out) {
  const float theta = clamp_max(
      __fmul_rn(__fmul_rn(__fadd_rn(static_cast<float>(ti), jt), kInvHalfRes),
                kHalfPi),
      kThetaMax);
  const float phi = __fmul_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(pi), jp), kInvRes), kTwoPi);
  const float sin_t = sinf(theta);
  const float lx = __fmul_rn(sin_t, cosf(phi));
  const float ly = __fmul_rn(sin_t, sinf(phi));
  const float lz = cosf(theta);

  const bool singular = nz < kSingular;
  const float a = __fdiv_rn(1.0f, singular ? 1.0f : __fadd_rn(1.0f, nz));
  const float b = singular ? -1.0f : __fmul_rn(__fmul_rn(-nx, ny), a);
  // t = (tx, b, tz), bitangent = (b, by, bz)
  const float tx = singular ? 0.0f
                            : __fsub_rn(1.0f, __fmul_rn(__fmul_rn(nx, nx), a));
  const float tz = singular ? 0.0f : -nx;
  const float by = singular ? 0.0f
                            : __fsub_rn(1.0f, __fmul_rn(__fmul_rn(ny, ny), a));
  const float bz = singular ? 0.0f : -ny;

  const float wx = __fadd_rn(__fadd_rn(__fmul_rn(tx, lx), __fmul_rn(b, ly)),
                             __fmul_rn(nx, lz));
  const float wy = __fadd_rn(__fadd_rn(__fmul_rn(b, lx), __fmul_rn(by, ly)),
                             __fmul_rn(ny, lz));
  const float wz = __fadd_rn(__fadd_rn(__fmul_rn(tz, lx), __fmul_rn(bz, ly)),
                             __fmul_rn(nz, lz));
  const float len = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)), __fmul_rn(wz, wz)));
  const float inv = __fdiv_rn(1.0f, clamp_min(len, kLenEps));
  out[0] = __fmul_rn(wx, inv);
  out[1] = __fmul_rn(wy, inv);
  out[2] = __fmul_rn(wz, inv);
}

__global__ void __launch_bounds__(kThreads)
    guide_sample_kernel(const GuideArgs a) {
  const float* __restrict__ table = static_cast<const float*>(a.table);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < a.lanes; i += step) {
    const float* row = static_cast<const float*>(a.row) + i * a.row_s0;
    const float xi1 = static_cast<const float*>(a.u[0])[i * a.u_s[0]];
    const float xi2 = static_cast<const float*>(a.u[1])[i * a.u_s[1]];
    const float jt = static_cast<const float*>(a.u[2])[i * a.u_s[2]];
    const float jp = static_cast<const float*>(a.u[3])[i * a.u_s[3]];
    const float* n = static_cast<const float*>(a.normal) + i * a.n_s0;
    const long long prim = load_index(a.prim, i, a.prim_s, a.prim64);

    const int ti = rank_cdf<kHalfRes>(row, a.row_s1, xi1);
    const float total = row[kHalfRes * a.row_s1];
    const float* trow = table + (prim * kHalfRes + ti) * kTableRow;
    const int pi = rank_cdf<kRes>(trow, 1, xi2);

    float d[3];
    sampled_direction(ti, pi, jt, jp, n[0], n[a.n_s1], n[2 * a.n_s1], d);
    float* dir = static_cast<float*>(a.dir) + 3 * i;
    dir[0] = d[0];
    dir[1] = d[1];
    dir[2] = d[2];
    static_cast<float*>(a.pdf_g)[i] = cell_pdf(trow[kRes + pi], total, ti);

    if (a.mis) {
      const int tb =
          clamp_index(load_index(a.tb, i, a.tb_s, a.tb64), kHalfRes - 1);
      const int pb = clamp_index(load_index(a.pb, i, a.pb_s, a.pb64), kRes - 1);
      const float cell_b =
          table[(prim * kHalfRes + tb) * kTableRow + kRes + pb];
      const bool below = static_cast<const bool*>(a.below)[i * a.below_s];
      static_cast<float*>(a.pdf_b)[i] =
          below ? 0.0f : cell_pdf(cell_b, total, tb);
      static_cast<bool*>(a.valid)[i] = row[(kHalfRes + 1) * a.row_s1] > 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// One sampler call (see GuideArgs) on `stream`. Returns the CUDA error code
// of the launch (0 = cudaSuccess; nothing is launched for 0 lanes).
int tpt_guide_sample(const GuideArgs* args, void* stream) {
  const GuideArgs a = *args;
  if (a.lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.lanes == 0) return 0;
  long long blocks = (a.lanes + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  guide_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_guide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
