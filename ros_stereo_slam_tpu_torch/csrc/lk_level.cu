// One pyramid level of batched forward-additive Lucas-Kanade, for sm_90a.
//
// Replaces the TPU kernel ros_stereo_slam_tpu/ops/lk_pallas.py::_lk_level_kernel
// (entry point track_level).  It computes what that kernel computes, per point:
//   1. an (S+2)^2 bilinear template around the reference point, and the
//      Scharr gradients of that sampled patch (not of pre-filtered gradient
//      images: away from borders the two agree);
//   2. the 2x2 structure tensor (a, b, c); min_eig / S^2 is the `ok` gate;
//   3. `iters` Gauss-Newton steps, each resampling an S x S patch of the
//      current image at the guess; a step of 0 once |delta| < eps;
//   4. residual = mean |cur - tmpl| / (std(tmpl) + 1e-3).
// Tile starts are clamped into the image and the sub-pixel fraction is taken
// against the clamped start (the reference's _select_tile), so reads never
// leave the image.  All arithmetic is f32.
//
// Lanes (the batched entry point lk_level_batch_f32, replacing the TPU entry
// point track_level_batch): blockIdx.y is the lane; lane b reads images at
// offset b * H * W and points and outputs at offset b * n_pts * 2.  The
// single-lane entry point lk_level_f32 is the same kernel with one lane.
//
// What bounds it on an H100: per call about 0.05 GFLOP and a few tens of MB
// of bilinear loads that hit L2 (a 1241x376 f32 level is 1.87 MB; L2 is
// 50 MB), plus one warp reduction per GN iteration.  At N = 768 points there
// are only ~6 warps per SM, so the kernel is bound by the latency of those
// dependent loads and reductions, not by FLOPs or DRAM bandwidth.
//
// Design: one warp per point, kWarpsPerBlock warps per block.  Each lane owns
// pixels lane, lane + 32, ... of the S x S window and keeps their template
// values and gradients in registers; the (S+2)^2 template tile passes through
// shared memory once to form the gradients.  Samples load straight from
// global memory (L2-resident).  Warp shuffles reduce a, b, c once and bx, by
// every iteration; the reduced value is broadcast from lane 0 so every lane
// holds bit-identical sums and takes the same branch.  A warp leaves its loop
// once |delta| < eps: the reference then repeats the same zero step, so the
// early exit changes no result.
//
// What the TPU kernel does and this one does not: (40, 256) aligned
// superblock loads, one-hot selection matmuls, pltpu.roll, SMEM point arrays,
// _UNROLL point groups, custom_vmap, the bf16 select type, and the edge pad of
// every lane's images to the (8, 128) tile geometry.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return __shfl_sync(kFullMask, v, 0);
}

// Integer start of an (n+1) x (n+1) tile whose top-left sample sits at real
// coordinate `pos`: floor(pos) clamped to [0, dim - (n+1)]; the fraction is
// pos minus the clamped start.  NaN positions clamp to 0 (fmaxf drops NaN).
__device__ __forceinline__ void tile_start(float pos, int n, int dim, int* i0, float* frac) {
  const float s = fminf(fmaxf(floorf(pos), 0.f), static_cast<float>(dim - (n + 1)));
  *i0 = static_cast<int>(s);
  *frac = pos - s;
}

// Bilinear sample between integer pixels (y, x) .. (y + 1, x + 1).
__device__ __forceinline__ float bilerp(const float* __restrict__ img, int W, int y, int x,
                                        float fx, float fy) {
  const float* p = img + static_cast<size_t>(y) * W + x;
  const float top = __ldg(p) * (1.f - fx) + __ldg(p + 1) * fx;
  const float bot = __ldg(p + W) * (1.f - fx) + __ldg(p + W + 1) * fx;
  return top * (1.f - fy) + bot * fy;
}

// PPL: window pixels per lane, ceil(S * S / 32) rounded up to an instance.
template <int PPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_level_kernel(const float* __restrict__ ref, const float* __restrict__ cur, int H, int W,
                const float* __restrict__ ref_pts, const float* __restrict__ guesses,
                int n_pts, int S, int iters, float eps,
                float* __restrict__ out_pts, float* __restrict__ out_meta) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_pts) return;  // warp-uniform
  // This block's sequence lane: its images and point rows.
  const size_t img_off = static_cast<size_t>(blockIdx.y) * H * W;
  const size_t pt_off = static_cast<size_t>(blockIdx.y) * n_pts * 2;
  ref += img_off;
  cur += img_off;
  ref_pts += pt_off;
  guesses += pt_off;
  out_pts += pt_off;
  out_meta += pt_off;

  const int T = S + 2;
  const int SS = S * S;
  float* tile = smem + warp * T * T;
  const float half = (S - 1) * 0.5f;

  // Template tile: (S+2)^2 samples from (py - half - 1, px - half - 1).
  int ty0, tx0;
  float tfy, tfx;
  tile_start(ref_pts[2 * p + 1] - half - 1.f, T, H, &ty0, &tfy);
  tile_start(ref_pts[2 * p] - half - 1.f, T, W, &tx0, &tfx);
  for (int k = lane; k < T * T; k += 32) {
    const int r = k / T, c = k - (k / T) * T;
    tile[k] = bilerp(ref, W, ty0 + r, tx0 + c, tfx, tfy);
  }
  __syncwarp();

  float tm[PPL], gx[PPL], gy[PPL];
  float a = 0.f, b = 0.f, c = 0.f, st = 0.f, st2 = 0.f;
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    const int k = lane + 32 * j;
    tm[j] = gx[j] = gy[j] = 0.f;
    if (k < SS) {
      const int r = k / S, cc = k - (k / S) * S;
      const float* t = tile + r * T + cc;  // top-left of the 3x3 neighbourhood
      const float dx0 = 0.5f * (t[2] - t[0]);
      const float dx1 = 0.5f * (t[T + 2] - t[T]);
      const float dx2 = 0.5f * (t[2 * T + 2] - t[2 * T]);
      const float dy0 = 0.5f * (t[2 * T] - t[0]);
      const float dy1 = 0.5f * (t[2 * T + 1] - t[1]);
      const float dy2 = 0.5f * (t[2 * T + 2] - t[2]);
      gx[j] = (3.f * dx0 + 10.f * dx1 + 3.f * dx2) / 16.f;
      gy[j] = (3.f * dy0 + 10.f * dy1 + 3.f * dy2) / 16.f;
      tm[j] = t[T + 1];
    }
    a += gx[j] * gx[j];
    b += gx[j] * gy[j];
    c += gy[j] * gy[j];
    st += tm[j];
    st2 += tm[j] * tm[j];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  st = warp_sum(st);
  st2 = warp_sum(st2);

  const float det = a * c - b * b;
  const float trace = a + c;
  const float min_eig =
      (trace - sqrtf(fmaxf(trace * trace - 4.f * det, 0.f))) * 0.5f / static_cast<float>(SS);
  const float inv_det = det > 1e-12f ? 1.f / fmaxf(det, 1e-12f) : 0.f;

  float gxp = guesses[2 * p];
  float gyp = guesses[2 * p + 1];
  for (int it = 0; it < iters; ++it) {
    int cy0, cx0;
    float cfy, cfx;
    tile_start(gyp - half, S, H, &cy0, &cfy);
    tile_start(gxp - half, S, W, &cx0, &cfx);
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int k = lane + 32 * j;
      if (k < SS) {
        const int r = k / S, cc = k - (k / S) * S;
        const float d = bilerp(cur, W, cy0 + r, cx0 + cc, cfx, cfy) - tm[j];
        bx += gx[j] * d;
        by += gy[j] * d;
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float ddx = (c * bx - b * by) * inv_det;
    const float ddy = (a * by - b * bx) * inv_det;
    if (ddx * ddx + ddy * ddy < eps * eps) break;  // warp-uniform
    gxp -= ddx;
    gyp -= ddy;
  }

  // Residual at the final guess.
  int cy0, cx0;
  float cfy, cfx;
  tile_start(gyp - half, S, H, &cy0, &cfy);
  tile_start(gxp - half, S, W, &cx0, &cfx);
  float sad = 0.f;
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    const int k = lane + 32 * j;
    if (k < SS) {
      const int r = k / S, cc = k - (k / S) * S;
      sad += fabsf(bilerp(cur, W, cy0 + r, cx0 + cc, cfx, cfy) - tm[j]);
    }
  }
  sad = warp_sum(sad);
  if (lane == 0) {
    const float inv_n = 1.f / static_cast<float>(SS);
    const float mean_t = st * inv_n;
    const float var_t = st2 * inv_n - mean_t * mean_t;
    const float contrast = sqrtf(fmaxf(var_t, 0.f)) + 1e-3f;
    out_pts[2 * p] = gxp;
    out_pts[2 * p + 1] = gyp;
    out_meta[2 * p] = min_eig;
    out_meta[2 * p + 1] = sad * inv_n / contrast;
  }
}

template <int PPL>
cudaError_t launch(const float* ref, const float* cur, int n_lanes, int H, int W,
                   const float* ref_pts, const float* guesses, int n_pts, int S, int iters,
                   float eps, float* out_pts, float* out_meta, cudaStream_t stream) {
  const dim3 grid((n_pts + kWarpsPerBlock - 1) / kWarpsPerBlock, n_lanes);
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * (S + 2) * (S + 2) * sizeof(float);
  lk_level_kernel<PPL><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      ref, cur, H, W, ref_pts, guesses, n_pts, S, iters, eps, out_pts, out_meta);
  return cudaGetLastError();
}

// Both entry points: n_lanes lanes of (H, W) images and (n_pts, 2) points.
int lk_level_lanes(const void* ref, const void* cur, int n_lanes, int H, int W,
                   const void* ref_pts, const void* guesses, int n_pts, int S, int iters,
                   float eps, void* out_pts, void* out_meta, void* stream) {
  if (n_pts <= 0 || n_lanes <= 0) return static_cast<int>(cudaSuccess);
  if (S < 1 || S > 32 || H < S + 3 || W < S + 3 || n_lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const float*>(ref);
  const auto* cu = static_cast<const float*>(cur);
  const auto* rp = static_cast<const float*>(ref_pts);
  const auto* g = static_cast<const float*>(guesses);
  auto* op = static_cast<float*>(out_pts);
  auto* om = static_cast<float*>(out_meta);
  auto st = static_cast<cudaStream_t>(stream);
  const int ppl = (S * S + 31) / 32;
  cudaError_t err;
  if (ppl <= 8) {
    err = launch<8>(r, cu, n_lanes, H, W, rp, g, n_pts, S, iters, eps, op, om, st);
  } else if (ppl <= 16) {
    err = launch<16>(r, cu, n_lanes, H, W, rp, g, n_pts, S, iters, eps, op, om, st);
  } else {
    err = launch<32>(r, cu, n_lanes, H, W, rp, g, n_pts, S, iters, eps, op, om, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Images (H, W) f32 row-major;
// ref_pts, guesses, out_pts, out_meta (n_pts, 2) f32 row-major; out_meta
// holds (min_eig, resid).  Requires 1 <= S <= 32, H >= S + 3, W >= S + 3
// (the caller checks).  Launch on `stream` and return cudaGetLastError().
extern "C" int lk_level_f32(const void* ref, const void* cur, int H, int W, const void* ref_pts,
                            const void* guesses, int n_pts, int S, int iters, float eps,
                            void* out_pts, void* out_meta, void* stream) {
  return lk_level_lanes(ref, cur, 1, H, W, ref_pts, guesses, n_pts, S, iters, eps, out_pts,
                        out_meta, stream);
}

// The same for n_lanes independent lanes stacked on a leading axis: images
// (n_lanes, H, W), points and outputs (n_lanes, n_pts, 2); one launch, lanes
// on blockIdx.y (1 <= n_lanes <= 65535).
extern "C" int lk_level_batch_f32(const void* ref, const void* cur, int n_lanes, int H, int W,
                                  const void* ref_pts, const void* guesses, int n_pts, int S,
                                  int iters, float eps, void* out_pts, void* out_meta,
                                  void* stream) {
  return lk_level_lanes(ref, cur, n_lanes, H, W, ref_pts, guesses, n_pts, S, iters, eps,
                        out_pts, out_meta, stream);
}
