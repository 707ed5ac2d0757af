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
//   4. bit b = vp_b < vq_b, written as +1 / -1;
// and what the caller did after it, per keypoint with a `valid` flag: the
// signs of an invalid keypoint written as 0, and the 256 bits packed into 8
// words (bit j of word w is descriptor bit 32 w + j, orb.pack_bits's layout;
// all 0 for an invalid keypoint).
// The arithmetic of each sample and each rotated position follows the plain
// version's operation order with round-to-nearest intrinsics (no FMA
// contraction), so the two differ only through the moments' summation order
// and cos/sin from m / r instead of cos(atan2(m01, m10)).
//
// Lanes (the entry point orb_desc_f32 takes n_lanes, replacing also the TPU
// entry point orb_descriptors_batch; one image is one lane): blockIdx.y is
// the lane; lane b reads its image at offset b * H * W and its corners at
// b * n_pts * 2, and writes its n_pts output rows after those of lane b - 1.
//
// What bounds it on an H100: bytes.  A corner needs the ~2,000 pixels under
// its patch (L2-resident: a 1241x376 f32 level is 1.9 MB) and writes 1 KB of
// signs; ~0.01 MFLOP per corner.  The least time is a fraction of a
// microsecond, so what the kernel pays is latency: patch load, moments,
// reduce, samples.
//
// Design: one thread block per corner, 256 threads.  The block stages the
// corner's 44 x 44 patch (origin floor(corner) - 21, NOT clamped into the
// image) in shared memory with row-wise (coalesced) loads, once; every
// centroid and pattern tap then comes from shared memory, where the old
// one-warp-per-corner body made 4,884 L2 loads per corner.  The 709 centroid
// offsets are spread over the block; thread b then owns descriptor bit b, so
// a warp's 32 signs are one 128-byte store and its __ballot_sync is one
// packed word.  Border semantics are the plain version's, not the TPU
// kernel's tile clamp (fault F3): the sample POSITION is clamped as
// interp.bilinear_at clamps it and then addressed relative to the unclamped
// patch origin; patch pixels outside the image are filled with 0 and never
// addressed after that clamp.  A tap whose clamped position falls outside the
// patch (a corner outside the image, a NaN) is read from the image instead,
// so any corner gives what the old body gave.  When the corner is integer and
// >= 15 px inside the sampled range (always, on the main path) a centroid
// sample is one shared-memory read: bilinear_at's weights are (1, 0, 0, 0)
// there and, for finite pixels, its value is that pixel.  Reductions are
// deterministic: warp shuffles, then every thread adds the per-warp partials
// from shared memory in warp order (no atomics), so all threads rotate with
// bit-identical cos / sin and two runs give the same bits.
//
// What the TPU kernel does and this one does not: (56, 256) aligned superblock
// loads and one-hot selection matmuls, the clamp of the 44x44 tile into the
// image (which moves corners within 21 px of a border: fault F3), tent-weight
// sampling matmuls, SMEM point arrays, _UNROLL point groups, the bf16 select
// type, and the edge pad of every lane's image to the (8, 128) tile geometry.

#include <cuda_runtime.h>

namespace {

constexpr int kBits = 256;
constexpr int kThreads = kBits;  // thread b owns descriptor bit b
constexpr int kWarps = kThreads / 32;
constexpr int kPatch = 44;   // patch side
constexpr int kCentre = 21;  // the corner's pixel sits at (kCentre, kCentre)
constexpr int kRadius = 15;  // centroid mask radius
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;  // lane 0 holds the warp's sum
}

struct Patch {
  const float* tile;  // kPatch x kPatch staged pixels, row-major
  int ox, oy;         // image coordinates of tile[0]
  const float* img;
  int W;
  float xmax, ymax;
};

// interp.bilinear_at for one point: clamp (NaN -> 0, as nan_to_num), then
// v00 (1 - fy)(1 - fx) + v01 (1 - fy) fx + v10 fy (1 - fx) + v11 fy fx,
// evaluated left to right.  The four taps come from the staged patch when the
// clamped position lies in it, else from the image.
__device__ __forceinline__ float bilinear_at(const Patch& P, float x, float y) {
  x = fminf(fmaxf(x, 0.f), P.xmax);
  y = fminf(fmaxf(y, 0.f), P.ymax);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f);
  const float fy = __fsub_rn(y, y0f);
  const float omfx = __fsub_rn(1.f, fx);
  const float omfy = __fsub_rn(1.f, fy);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int tx = x0 - P.ox;
  const int ty = y0 - P.oy;
  float v00, v01, v10, v11;
  if (static_cast<unsigned>(tx) < static_cast<unsigned>(kPatch - 1) &&
      static_cast<unsigned>(ty) < static_cast<unsigned>(kPatch - 1)) {
    const float* t = P.tile + ty * kPatch + tx;
    v00 = t[0];
    v01 = t[1];
    v10 = t[kPatch];
    v11 = t[kPatch + 1];
  } else {
    const float* r0 = P.img + static_cast<size_t>(y0) * P.W + x0;
    v00 = __ldg(r0);
    v01 = __ldg(r0 + 1);
    v10 = __ldg(r0 + P.W);
    v11 = __ldg(r0 + P.W + 1);
  }
  const float a = __fmul_rn(__fmul_rn(v00, omfy), omfx);
  const float b = __fmul_rn(__fmul_rn(v01, omfy), fx);
  const float c = __fmul_rn(__fmul_rn(v10, fy), omfx);
  const float d = __fmul_rn(__fmul_rn(v11, fy), fx);
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__global__ void __launch_bounds__(kThreads)
orb_desc_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ pts,
                const unsigned char* __restrict__ valid, int n_pts,
                const float* __restrict__ cent, int n_cent, const float* __restrict__ pat_p,
                const float* __restrict__ pat_q, float* __restrict__ out_sign,
                float* __restrict__ out_moments, int* __restrict__ out_bits) {
  __shared__ float tile[kPatch * kPatch];
  __shared__ float red[kWarps * 2];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // This block's corner, and its sequence lane's image and rows.
  img += static_cast<size_t>(blockIdx.y) * H * W;
  const size_t row = static_cast<size_t>(blockIdx.y) * n_pts + blockIdx.x;
  const float px = pts[2 * row];
  const float py = pts[2 * row + 1];

  Patch P;
  P.tile = tile;
  P.img = img;
  P.W = W;
  // W - 1.001 in double, then rounded to float: the bound the plain version uses.
  P.xmax = static_cast<float>(W - 1.001);
  P.ymax = static_cast<float>(H - 1.001);
  // The patch origin follows the corner, unclamped; a far or NaN corner is
  // bounded so the integer stays small (its taps then read the image).
  P.ox = static_cast<int>(floorf(fminf(fmaxf(px, -1e6f), 1e6f))) - kCentre;
  P.oy = static_cast<int>(floorf(fminf(fmaxf(py, -1e6f), 1e6f))) - kCentre;
  // This thread's pattern pair, asked for before the patch so that one L2
  // round trip covers both.
  const int b = tid;
  const float2 pp = __ldg(reinterpret_cast<const float2*>(pat_p) + b);
  const float2 pq = __ldg(reinterpret_cast<const float2*>(pat_q) + b);
  for (int k = tid; k < kPatch * kPatch; k += kThreads) {
    const int r = k / kPatch;
    const int gy = P.oy + r;
    const int gx = P.ox + (k - r * kPatch);
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    tile[k] = inside ? __ldg(img + static_cast<size_t>(gy) * W + gx) : 0.f;
  }
  __syncthreads();

  // Integer corner with every centroid sample unclamped: block-uniform.
  const bool direct = px == floorf(px) && py == floorf(py) && px >= kRadius &&
                      py >= kRadius && px <= static_cast<float>(W - 2 - kRadius) &&
                      py <= static_cast<float>(H - 2 - kRadius);
  float m10 = 0.f, m01 = 0.f;
  for (int i = tid; i < n_cent; i += kThreads) {
    const float2 off = __ldg(reinterpret_cast<const float2*>(cent) + i);
    const float dx = off.x, dy = off.y;
    float v;
    if (direct) {
      // v00 * 1 * 1 + v01 * 1 * 0 + v10 * 0 * 1 + v11 * 0 * 0
      v = tile[(kCentre + static_cast<int>(dy)) * kPatch + kCentre + static_cast<int>(dx)];
    } else {
      v = bilinear_at(P, __fadd_rn(px, dx), __fadd_rn(py, dy));
    }
    m10 = __fadd_rn(m10, __fmul_rn(v, dx));
    m01 = __fadd_rn(m01, __fmul_rn(v, dy));
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  if (lane == 0) {
    red[2 * warp] = m10;
    red[2 * warp + 1] = m01;
  }
  __syncthreads();
  m10 = red[0];
  m01 = red[1];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {  // fixed order, the same in every thread
    m10 = __fadd_rn(m10, red[2 * w]);
    m01 = __fadd_rn(m01, red[2 * w + 1]);
  }
  const float r = sqrtf(fmaxf(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)), 1e-18f));
  const float ca = __fdiv_rn(m10, r);
  const float sa = __fdiv_rn(m01, r);

  const float ppx = pp.x, ppy = pp.y, pqx = pq.x, pqy = pq.y;
  // rot @ pattern + point: x = ca * ox + (-sa) * oy, y = sa * ox + ca * oy.
  const float xp = __fadd_rn(__fadd_rn(__fmul_rn(ca, ppx), __fmul_rn(-sa, ppy)), px);
  const float yp = __fadd_rn(__fadd_rn(__fmul_rn(sa, ppx), __fmul_rn(ca, ppy)), py);
  const float xq = __fadd_rn(__fadd_rn(__fmul_rn(ca, pqx), __fmul_rn(-sa, pqy)), px);
  const float yq = __fadd_rn(__fadd_rn(__fmul_rn(sa, pqx), __fmul_rn(ca, pqy)), py);
  const bool bit = bilinear_at(P, xp, yp) < bilinear_at(P, xq, yq);
  const bool keep = valid == nullptr || valid[row] != 0;
  out_sign[row * kBits + b] = keep ? (bit ? 1.f : -1.f) : 0.f;
  const unsigned word = __ballot_sync(kFullMask, bit);
  if (lane == 0) out_bits[row * (kBits / 32) + warp] = keep ? static_cast<int>(word) : 0;
  if (tid == 0) {
    out_moments[2 * row] = m10;
    out_moments[2 * row + 1] = m01;
  }
}

// Both entry points: n_lanes lanes of an (H, W) image and (n_pts, 2) corners.
int orb_desc_lanes(const void* img, int n_lanes, int H, int W, const void* pts,
                   const void* valid, int n_pts, const void* cent, int n_cent,
                   const void* pat_p, const void* pat_q, void* out_sign, void* out_moments,
                   void* out_bits, void* stream) {
  if (n_pts <= 0 || n_lanes <= 0) return static_cast<int>(cudaSuccess);
  if (H < 2 || W < 2 || n_cent <= 0 || n_lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_pts, n_lanes);
  orb_desc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, static_cast<const float*>(pts),
      static_cast<const unsigned char*>(valid), n_pts, static_cast<const float*>(cent), n_cent,
      static_cast<const float*>(pat_p), static_cast<const float*>(pat_q),
      static_cast<float*>(out_sign), static_cast<float*>(out_moments),
      static_cast<int*>(out_bits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plain C entry point (loaded with ctypes), for n_lanes lanes stacked on
// a leading axis (1 <= n_lanes <= 65535; one image is one lane).  img
// (n_lanes, H, W) f32 row-major with H, W >= 2; pts (n_lanes, n_pts, 2) f32
// xy; valid (n_lanes, n_pts) bytes, or null for "all valid"; cent (n_cent, 2)
// integer-valued f32 offsets within the radius-15 mask, pat_p and pat_q
// (256, 2) f32 offsets, all three 8-byte aligned; out_sign (n_lanes, n_pts,
// 256) f32 (+-1, 0 where not valid); out_moments (n_lanes, n_pts, 2) f32
// (m10, m01); out_bits (n_lanes, n_pts, 8) int32 packed bits (0 where not
// valid).  One launch on `stream`, lanes on blockIdx.y; returns
// cudaGetLastError().
extern "C" int orb_desc_f32(const void* img, int n_lanes, int H, int W, const void* pts,
                            const void* valid, int n_pts, const void* cent, int n_cent,
                            const void* pat_p, const void* pat_q, void* out_sign,
                            void* out_moments, void* out_bits, void* stream) {
  return orb_desc_lanes(img, n_lanes, H, W, pts, valid, n_pts, cent, n_cent, pat_p, pat_q,
                        out_sign, out_moments, out_bits, stream);
}
