// ORB orientation + rotated-BRIEF descriptor bits for integer corners, sm_90a.
//
// Replaces the TPU kernel ros_stereo_slam_tpu/ops/orb_pallas.py::_orb_desc_kernel
// (entry point orb_descriptors).  Per keypoint (px, py):
//   1. the intensity-centroid moments m10 = sum v * dx, m01 = sum v * dy over
//      the M offsets of the radius-15 circular mask (orb._CENT);
//   2. cos and sin of the orientation from the normalized moments
//      (r = sqrt(max(m10^2 + m01^2, 1e-18)), no atan2), as the TPU kernel does;
//   3. the 256 BRIEF pairs (orb._PAT_P / _PAT_Q) rotated by that angle and
//      sampled bilinearly at absolute image positions, with the border clamp
//      of interp.bilinear_at (x in [0, W - 1.001], y in [0, H - 1.001]);
//   4. bit b = vp_b < vq_b, written as +1 / -1.
// The arithmetic of each sample and each rotated position follows the plain
// version's operation order with round-to-nearest intrinsics (no FMA
// contraction), so the two differ only through the moments' summation order
// and cos/sin from m / r instead of cos(atan2(m01, m10)).
//
// Lanes (the batched entry point orb_desc_batch_f32, replacing the TPU entry
// point orb_descriptors_batch): blockIdx.y is the lane; lane b reads its image
// at offset b * H * W, its corners at b * n_pts * 2 and writes its signs at
// b * n_pts * 256 and its moments at b * n_pts * 2.  The single-lane entry
// point orb_desc_f32 is the same kernel with one lane.
//
// What bounds it on an H100: about 1,220 bilinear samples (4 loads each) per
// keypoint, ~512 keypoints per frame over four levels; the level image
// (1.9 MB at 1241x376) stays in L2.  So it is bound by the latency of those
// L2 loads, not by FLOPs or DRAM bandwidth.
//
// Design: one warp per keypoint, kWarpsPerBlock warps per block.  Lane l sums
// the moments of offsets l, l + 32, ...; a shuffle reduction gives the sums,
// broadcast from lane 0 so every lane rotates with bit-identical cos / sin.
// Lane l then computes bits l + 32 w for w = 0..7, so each store of 32 signs
// is one coalesced 128-byte write.
//
// What the TPU kernel does and this one does not: (56, 256) aligned superblock
// loads and one-hot selection matmuls, the clamp of the 44x44 tile into the
// image (which moves corners within 21 px of a border: fault F3), tent-weight
// sampling matmuls, SMEM point arrays, _UNROLL point groups, the bf16 select
// type, and the edge pad of every lane's image to the (8, 128) tile geometry.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBits = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return __shfl_sync(kFullMask, v, 0);
}

// interp.bilinear_at for one point: clamp (NaN -> 0, as nan_to_num), then
// v00 (1 - fy)(1 - fx) + v01 (1 - fy) fx + v10 fy (1 - fx) + v11 fy fx,
// evaluated left to right.
__device__ __forceinline__ float bilinear_at(const float* __restrict__ img, int W, float xmax,
                                             float ymax, float x, float y) {
  x = fminf(fmaxf(x, 0.f), xmax);
  y = fminf(fmaxf(y, 0.f), ymax);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f);
  const float fy = __fsub_rn(y, y0f);
  const float omfx = __fsub_rn(1.f, fx);
  const float omfy = __fsub_rn(1.f, fy);
  const float* r0 = img + static_cast<int>(y0f) * W + static_cast<int>(x0f);
  const float* r1 = r0 + W;
  const float a = __fmul_rn(__fmul_rn(__ldg(r0), omfy), omfx);
  const float b = __fmul_rn(__fmul_rn(__ldg(r0 + 1), omfy), fx);
  const float c = __fmul_rn(__fmul_rn(__ldg(r1), fy), omfx);
  const float d = __fmul_rn(__fmul_rn(__ldg(r1 + 1), fy), fx);
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
orb_desc_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ pts,
                int n_pts, const float* __restrict__ cent, int n_cent,
                const float* __restrict__ pat_p, const float* __restrict__ pat_q,
                float* __restrict__ out_sign, float* __restrict__ out_moments) {
  const int p = blockIdx.x * kWarpsPerBlock + static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (p >= n_pts) return;  // uniform per warp
  // This block's sequence lane: its image, corners and output rows.
  img += static_cast<size_t>(blockIdx.y) * H * W;
  pts += static_cast<size_t>(blockIdx.y) * n_pts * 2;
  out_sign += static_cast<size_t>(blockIdx.y) * n_pts * kBits;
  out_moments += static_cast<size_t>(blockIdx.y) * n_pts * 2;
  // W - 1.001 in double, then rounded to float: the bound the plain version uses.
  const float xmax = static_cast<float>(W - 1.001);
  const float ymax = static_cast<float>(H - 1.001);
  const float px = pts[2 * p];
  const float py = pts[2 * p + 1];

  float m10 = 0.f, m01 = 0.f;
  for (int i = lane; i < n_cent; i += 32) {
    const float dx = __ldg(cent + 2 * i);
    const float dy = __ldg(cent + 2 * i + 1);
    const float v = bilinear_at(img, W, xmax, ymax, __fadd_rn(px, dx), __fadd_rn(py, dy));
    m10 = __fadd_rn(m10, __fmul_rn(v, dx));
    m01 = __fadd_rn(m01, __fmul_rn(v, dy));
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  const float r = sqrtf(fmaxf(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)), 1e-18f));
  const float ca = __fdiv_rn(m10, r);
  const float sa = __fdiv_rn(m01, r);

#pragma unroll 2
  for (int w = 0; w < kBits / 32; ++w) {
    const int b = w * 32 + lane;
    const float ppx = __ldg(pat_p + 2 * b), ppy = __ldg(pat_p + 2 * b + 1);
    const float pqx = __ldg(pat_q + 2 * b), pqy = __ldg(pat_q + 2 * b + 1);
    // rot @ pattern + point: x = ca * ox + (-sa) * oy, y = sa * ox + ca * oy.
    const float xp = __fadd_rn(__fadd_rn(__fmul_rn(ca, ppx), __fmul_rn(-sa, ppy)), px);
    const float yp = __fadd_rn(__fadd_rn(__fmul_rn(sa, ppx), __fmul_rn(ca, ppy)), py);
    const float xq = __fadd_rn(__fadd_rn(__fmul_rn(ca, pqx), __fmul_rn(-sa, pqy)), px);
    const float yq = __fadd_rn(__fadd_rn(__fmul_rn(sa, pqx), __fmul_rn(ca, pqy)), py);
    const float vp = bilinear_at(img, W, xmax, ymax, xp, yp);
    const float vq = bilinear_at(img, W, xmax, ymax, xq, yq);
    out_sign[static_cast<size_t>(p) * kBits + b] = vp < vq ? 1.f : -1.f;
  }
  if (lane == 0) {
    out_moments[2 * p] = m10;
    out_moments[2 * p + 1] = m01;
  }
}

// Both entry points: n_lanes lanes of an (H, W) image and (n_pts, 2) corners.
int orb_desc_lanes(const void* img, int n_lanes, int H, int W, const void* pts, int n_pts,
                   const void* cent, int n_cent, const void* pat_p, const void* pat_q,
                   void* out_sign, void* out_moments, void* stream) {
  if (n_pts <= 0 || n_lanes <= 0) return static_cast<int>(cudaSuccess);
  if (H < 2 || W < 2 || n_cent <= 0 || n_lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_pts + kWarpsPerBlock - 1) / kWarpsPerBlock, n_lanes);
  orb_desc_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(pts), n_pts,
      static_cast<const float*>(cent), n_cent, static_cast<const float*>(pat_p),
      static_cast<const float*>(pat_q), static_cast<float*>(out_sign),
      static_cast<float*>(out_moments));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  img (H, W) f32 row-major with
// H, W >= 2; pts (n_pts, 2) f32 xy; cent (n_cent, 2), pat_p and pat_q (256, 2)
// f32 offsets; out_sign (n_pts, 256) f32; out_moments (n_pts, 2) f32 (m10, m01).
// Launch on `stream` and return cudaGetLastError().
extern "C" int orb_desc_f32(const void* img, int H, int W, const void* pts, int n_pts,
                            const void* cent, int n_cent, const void* pat_p, const void* pat_q,
                            void* out_sign, void* out_moments, void* stream) {
  return orb_desc_lanes(img, 1, H, W, pts, n_pts, cent, n_cent, pat_p, pat_q, out_sign,
                        out_moments, stream);
}

// The same for n_lanes lanes stacked on a leading axis: img (n_lanes, H, W),
// pts (n_lanes, n_pts, 2), out_sign (n_lanes, n_pts, 256), out_moments
// (n_lanes, n_pts, 2); one launch, lanes on blockIdx.y (1 <= n_lanes <= 65535).
extern "C" int orb_desc_batch_f32(const void* img, int n_lanes, int H, int W, const void* pts,
                                  int n_pts, const void* cent, int n_cent, const void* pat_p,
                                  const void* pat_q, void* out_sign, void* out_moments,
                                  void* stream) {
  return orb_desc_lanes(img, n_lanes, H, W, pts, n_pts, cent, n_cent, pat_p, pat_q, out_sign,
                        out_moments, stream);
}
