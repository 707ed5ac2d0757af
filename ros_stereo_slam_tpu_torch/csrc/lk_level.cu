// One pyramid level of batched forward-additive Lucas-Kanade, for sm_90a.
//
// Replaces the TPU kernel ros_stereo_slam_tpu/ops/lk_pallas.py::_lk_level_kernel
// (entry point track_level).  It computes what that kernel computes, per point:
//   1. an (S+2)^2 bilinear template around the reference point, and the
//      Scharr gradients of that sampled patch (not of pre-filtered gradient
//      images: away from borders the two agree);
//   2. the 2x2 structure tensor (a, b, c); min_eig / S^2 is the `ok` gate;
//   3. `iters` Gauss-Newton steps, a step of 0 once |delta| < eps: the first
//      walk = min(iters, walk_iters) resample an S x S patch of the current
//      image at the guess; the remaining ones (freeze-polish) sample a frozen
//      (S+2)^2 tile anchored at the post-walk guess, at the guess clamped to
//      the ~±1 px cell the tile covers;
//   4. residual = mean |cur - tmpl| / (std(tmpl) + 1e-3), sampled where the
//      last step sampled (the clamped position after a polish phase);
// and what the caller did after it: ok = min_eig > min_eig_thresh, and a point
// that is not ok gets its input guess back.
// Tile starts are clamped into the image and the sub-pixel fraction is taken
// against the clamped start (the reference's _select_tile), so reads never
// leave the image.  All arithmetic is f32.
//
// Lanes (the entry point lk_level_f32 takes n_lanes, replacing also the TPU
// entry point track_level_batch; one image pair is one lane): blockIdx.y is
// the lane; lane b reads images at offset b * H * W and points at offset
// b * n_pts * 2, and writes its n_pts output rows after those of lane b - 1.
//
// What bounds it on an H100: bytes.  A call touches the sectors under the
// (S+3)^2 template tiles and the (S+1)^2 sample tiles (tens of thousands of
// 32-byte sectors, L2-resident: a 1241x376 f32 level is 1.87 MB, L2 50 MB)
// and does about 0.05 GFLOP, so the least time is well under a microsecond
// and what the kernel really pays is latency: the chain of tile load, sample,
// reduce, step, once per Gauss-Newton iteration.
//
// Design: one thread block per point, kThreads = 64 threads, PPT window
// pixels per thread (4 for S <= 15), at most 64 registers a thread, so an SM
// holds 16 blocks and the card 2,112: the 768 points of a call, or the 1,536
// of two lanes, are resident at once.  Measured on an H100 (768 points, S =
// 15, 6 iterations; one lane, two lanes): 256 threads and one pixel per
// thread (61 registers, 4 blocks an SM, so two and three waves) 12.2 and
// 20.0 us; 128 threads 8.3 and 12.4 us; 64 threads 7.5 and 10.3 us; 32
// threads 10.9 and 11.9 us; the one-warp-per-point body without tiles 14.0
// and 15.1 us.  What a block waits for is the chain of barriers and L2 round
// trips of each step, not its arithmetic, so more and smaller blocks win.
// The raw (S+3)^2 reference footprint is staged in shared memory once with
// row-wise (coalesced) loads and the (S+2)^2 template is sampled from it;
// each Gauss-Newton step stages the raw (S+1)^2 footprint of the current
// image the same way, and all four taps of every bilinear sample come from
// shared memory: each pixel is read from L2 once per step, not ~3.5 times.
// Each thread's window row and column, and its offsets into the staged tile,
// are computed once, outside the iteration loop.  Reductions are deterministic:
// warp shuffles, then every thread adds the per-warp partials from shared
// memory in warp order, so all threads of the block hold bit-identical sums,
// take the same |delta| < eps exit, and two runs give the same bits (no
// atomics).  The block leaves its loop once |delta| < eps: the reference then
// repeats the same zero step, so the early exit changes no result, and the
// patch sampled for that step is the residual's.
//
// Freeze-polish: after the walk, the block stages the raw (S+2)^2 tile at
// the anchor base = clamp(floor(g - half) - 1, 0, dim - S - 3) into shared
// memory once, with the same row-wise loads, and every polish step samples it
// at base + clamp(g - half - base, 0, 2 - 1e-4): the top-left tap moves by
// 0 or 1 px in each axis, so the step reads no device memory at all (the TPU
// kernel keeps the same tile in registers).  The |delta| < eps exit ends only
// the phase it happens in: a walk that converges still runs the polish
// phase, whose clamped sample can move a point near a border.
//
// TMA tiled copies are not used: a tensor map needs a row pitch that is a
// multiple of 16 bytes, and a level row is 1241 * 4 = 4,964 bytes (620, 310
// and 155 columns above it are no better); the pyramid is not re-pitched.
//
// What the TPU kernel does and this one does not: (40, 256) aligned
// superblock loads, one-hot selection matmuls, pltpu.roll, SMEM point arrays,
// _UNROLL point groups, custom_vmap, the bf16 select type, and the edge pad of
// every lane's images to the (8, 128) tile geometry.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;        // threads of a block, which serves one point
constexpr int kBlocksPerSM = 16;    // resident blocks asked of the compiler (register cap)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSums = 5;  // values reduced together at most

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;  // lane 0 holds the warp's sum
}

// Sum v[0..K) over the block; every thread returns with the same bits in v.
// `red` holds kWarps * kMaxSums floats.  The caller keeps a __syncthreads()
// between the reads here and the next call's writes (every call is followed
// by a tile load and its barrier before the next one).
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) red[warp * kMaxSums + i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * kMaxSums + i];  // fixed order
    v[i] = s;
  }
}

// Integer start of an (n+1) x (n+1) tile whose top-left sample sits at real
// coordinate `pos`: floor(pos) clamped to [0, dim - (n+1)]; the fraction is
// pos minus the clamped start.  NaN positions clamp to 0 (fmaxf drops NaN).
__device__ __forceinline__ void tile_start(float pos, int n, int dim, int* i0, float* frac) {
  const float s = fminf(fmaxf(floorf(pos), 0.f), static_cast<float>(dim - (n + 1)));
  *i0 = static_cast<int>(s);
  *frac = pos - s;
}

// Bilinear sample between the staged pixels t[0], t[1], t[pitch], t[pitch+1].
__device__ __forceinline__ float bilerp(const float* t, int pitch, float fx, float fy) {
  const float top = t[0] * (1.f - fx) + t[1] * fx;
  const float bot = t[pitch] * (1.f - fx) + t[pitch + 1] * fx;
  return top * (1.f - fy) + bot * fy;
}

constexpr int per_thread(int n) { return (n + kThreads - 1) / kThreads; }

// PPT: window pixels per thread, per_thread(S * S) rounded up to an
// instance; PPR: pixels of the (S+1)^2 footprint that a thread stages.
template <int PPT, int PPR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
lk_level_kernel(const float* __restrict__ ref, const float* __restrict__ cur, int H, int W,
                const float* __restrict__ ref_pts, const float* __restrict__ guesses,
                int n_pts, int S, int iters, int walk_iters, float eps,
                float min_eig_thresh, float* __restrict__ out_pts, float* __restrict__ out_resid,
                unsigned char* __restrict__ out_ok) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // This block's point, and its sequence lane's images and point rows.
  const size_t img_off = static_cast<size_t>(blockIdx.y) * H * W;
  const size_t row = static_cast<size_t>(blockIdx.y) * n_pts + blockIdx.x;
  ref += img_off;
  cur += img_off;

  const int T = S + 2;  // template side
  const int R = S + 1;  // side of the raw footprint of an S x S sample patch
  const int SS = S * S;
  float* raw = smem;                      // (S+3)^2: raw footprints, reference then current
  float* tmpl = raw + (S + 3) * (S + 3);  // (S+2)^2: the sampled template
  float* red = tmpl + T * T;              // kWarps * kMaxSums partial sums
  const float half = (S - 1) * 0.5f;

  // Template: (S+2)^2 samples from (py - half - 1, px - half - 1), out of the
  // raw (S+3)^2 footprint; consecutive threads stage consecutive pixels of a row.
  int ty0, tx0;
  float tfy, tfx;
  tile_start(ref_pts[2 * row + 1] - half - 1.f, T, H, &ty0, &tfy);
  tile_start(ref_pts[2 * row] - half - 1.f, T, W, &tx0, &tfx);
  {
    const float* src = ref + static_cast<size_t>(ty0) * W + tx0;
    for (int k = tid; k < (T + 1) * (T + 1); k += kThreads) {
      const int r = k / (T + 1);
      raw[k] = __ldg(src + r * W + (k - r * (T + 1)));
    }
  }
  __syncthreads();
  for (int k = tid; k < T * T; k += kThreads) {
    const int r = k / T;
    tmpl[k] = bilerp(raw + r * (T + 1) + (k - r * T), T + 1, tfx, tfy);
  }
  __syncthreads();

  // This thread's window pixels: template value, gradients, and the offset
  // of the pixel's top-left tap in a staged (S+1)^2 footprint (tap) and in
  // the frozen (S+2)^2 polish tile (ptap).
  const int P = S + 2;  // side of the frozen polish tile
  float tm[PPT], gx[PPT], gy[PPT];
  int tap[PPT], ptap[PPT];
  float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // a, b, c, sum t, sum t^2
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int k = tid + kThreads * j;
    tm[j] = gx[j] = gy[j] = 0.f;
    tap[j] = -1;
    ptap[j] = 0;
    if (k < SS) {
      const int r = k / S, cc = k - (k / S) * S;
      tap[j] = r * R + cc;
      ptap[j] = r * P + cc;
      const float* t = tmpl + r * T + cc;  // top-left of the 3x3 neighbourhood
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
    sums[0] += gx[j] * gx[j];
    sums[1] += gx[j] * gy[j];
    sums[2] += gy[j] * gy[j];
    sums[3] += tm[j];
    sums[4] += tm[j] * tm[j];
  }
  // Offsets (into the image, from the tile start) of the footprint pixels
  // this thread stages every step; -1 past the footprint's end.
  int stage[PPR];
#pragma unroll
  for (int j = 0; j < PPR; ++j) {
    const int k = tid + kThreads * j;
    const int r = k / R;
    stage[j] = k < R * R ? r * W + (k - r * R) : -1;
  }
  block_sum(sums, red, warp, lane);
  const float a = sums[0], b = sums[1], c = sums[2], st = sums[3], st2 = sums[4];

  const float det = a * c - b * b;
  const float trace = a + c;
  const float min_eig =
      (trace - sqrtf(fmaxf(trace * trace - 4.f * det, 0.f))) * 0.5f / static_cast<float>(SS);
  const float inv_det = det > 1e-12f ? 1.f / fmaxf(det, 1e-12f) : 0.f;

  const float guess_x = guesses[2 * row];
  const float guess_y = guesses[2 * row + 1];
  float gxp = guess_x, gyp = guess_y;
  const int walk = min(iters, walk_iters);
  float bx = 0.f, by = 0.f;  // the frozen tile's start (integers) in polish
  // One pass per Gauss-Newton step, and a last one (it == iters) for the
  // residual at the final guess.  Every value that steers the loop comes from
  // block_sum, so it is the same in all threads and the barriers line up.
  float sad = 0.f;
  for (int it = 0;; ++it) {
    const bool polish = iters > walk && it >= walk;
    const float* base;  // top-left tap of this step's sample in shared memory
    int pitch;
    float cfy, cfx;
    // No barrier is needed before the stores: every thread read raw before
    // the barrier inside the last block_sum, and red is next written after
    // the barrier below (which polish steps keep for that reason alone).
    if (!polish) {
      int cy0, cx0;
      tile_start(gyp - half, S, H, &cy0, &cfy);
      tile_start(gxp - half, S, W, &cx0, &cfx);
      const float* src = cur + static_cast<size_t>(cy0) * W + cx0;
#pragma unroll
      for (int j = 0; j < PPR; ++j) {
        if (stage[j] >= 0) raw[tid + kThreads * j] = __ldg(src + stage[j]);
      }
      base = raw;
      pitch = R;
    } else {
      if (it == walk) {  // stage the frozen tile once, at the post-walk anchor
        by = fminf(fmaxf(floorf(gyp - half) - 1.f, 0.f), static_cast<float>(H - S - 3));
        bx = fminf(fmaxf(floorf(gxp - half) - 1.f, 0.f), static_cast<float>(W - S - 3));
        const float* src =
            cur + static_cast<size_t>(static_cast<int>(by)) * W + static_cast<int>(bx);
        for (int k = tid; k < P * P; k += kThreads) {
          const int r = k / P;
          raw[k] = __ldg(src + r * W + (k - r * P));
        }
      }
      // NaN guesses clamp to the anchor (fmaxf drops NaN).
      const float oy = fminf(fmaxf(gyp - half - by, 0.f), 2.f - 1e-4f);
      const float ox = fminf(fmaxf(gxp - half - bx, 0.f), 2.f - 1e-4f);
      const int iy1 = oy >= 1.f, ix1 = ox >= 1.f;
      cfy = oy - static_cast<float>(iy1);
      cfx = ox - static_cast<float>(ix1);
      base = raw + iy1 * P + ix1;
      pitch = P;
    }
    __syncthreads();
    float part[3] = {0.f, 0.f, 0.f};  // bx, by, sum |d|
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (tap[j] >= 0) {
        const float d = bilerp(base + (polish ? ptap[j] : tap[j]), pitch, cfx, cfy) - tm[j];
        part[0] += gx[j] * d;
        part[1] += gy[j] * d;
        part[2] += fabsf(d);
      }
    }
    block_sum(part, red, warp, lane);
    sad = part[2];
    if (it >= iters) break;  // block-uniform
    const float ddx = (c * part[0] - b * part[1]) * inv_det;
    const float ddy = (a * part[1] - b * part[0]) * inv_det;
    if (ddx * ddx + ddy * ddy < eps * eps) {  // block-uniform
      // Converged: the guess stays, so within a phase every later step
      // repeats this zero step and the patch just sampled is the
      // residual's.  A walk that converges still runs the polish phase.
      if (polish || walk >= iters) break;
      it = walk - 1;
      continue;
    }
    gxp -= ddx;
    gyp -= ddy;
  }

  if (tid == 0) {
    const float inv_n = 1.f / static_cast<float>(SS);
    const float mean_t = st * inv_n;
    const float var_t = st2 * inv_n - mean_t * mean_t;
    const float contrast = sqrtf(fmaxf(var_t, 0.f)) + 1e-3f;
    const bool ok = min_eig > min_eig_thresh;  // false for NaN, as the plain version
    out_pts[2 * row] = ok ? gxp : guess_x;
    out_pts[2 * row + 1] = ok ? gyp : guess_y;
    out_resid[row] = sad * inv_n / contrast;
    out_ok[row] = ok ? 1 : 0;
  }
}

// The cost of a launch alone on this card and its runtime: the floor under every
// kernel time measured from the host.
__global__ void empty_kernel() {}

template <int PPT, int PPR>
cudaError_t launch(const float* ref, const float* cur, int n_lanes, int H, int W,
                   const float* ref_pts, const float* guesses, int n_pts, int S, int iters,
                   int walk_iters, float eps, float min_eig_thresh, float* out_pts,
                   float* out_resid, unsigned char* out_ok, cudaStream_t stream) {
  const dim3 grid(n_pts, n_lanes);
  const size_t smem =
      static_cast<size_t>((S + 3) * (S + 3) + (S + 2) * (S + 2) + kWarps * kMaxSums) *
      sizeof(float);
  lk_level_kernel<PPT, PPR><<<grid, kThreads, smem, stream>>>(
      ref, cur, H, W, ref_pts, guesses, n_pts, S, iters, walk_iters, eps, min_eig_thresh,
      out_pts, out_resid, out_ok);
  return cudaGetLastError();
}

// Both entry points: n_lanes lanes of (H, W) images and (n_pts, 2) points.
int lk_level_lanes(const void* ref, const void* cur, int n_lanes, int H, int W,
                   const void* ref_pts, const void* guesses, int n_pts, int S, int iters,
                   int walk_iters, float eps, float min_eig_thresh, void* out_pts,
                   void* out_resid, void* out_ok, void* stream) {
  if (n_pts <= 0 || n_lanes <= 0) return static_cast<int>(cudaSuccess);
  if (S < 1 || S > 32 || H < S + 3 || W < S + 3 || n_lanes > 65535 || iters < 0 ||
      walk_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const float*>(ref);
  const auto* cu = static_cast<const float*>(cur);
  const auto* rp = static_cast<const float*>(ref_pts);
  const auto* g = static_cast<const float*>(guesses);
  auto* op = static_cast<float*>(out_pts);
  auto* ores = static_cast<float*>(out_resid);
  auto* ok = static_cast<unsigned char*>(out_ok);
  auto st = static_cast<cudaStream_t>(stream);
  // Three instances: windows up to 15 (225 window pixels, a 16 x 16
  // footprint), up to 22 and up to 32 px (the larger ones spill registers).
  cudaError_t err;
  if (S <= 15) {
    err = launch<per_thread(15 * 15), per_thread(16 * 16)>(
        r, cu, n_lanes, H, W, rp, g, n_pts, S, iters, walk_iters, eps, min_eig_thresh, op,
        ores, ok, st);
  } else if (S <= 22) {
    err = launch<per_thread(22 * 22), per_thread(23 * 23)>(
        r, cu, n_lanes, H, W, rp, g, n_pts, S, iters, walk_iters, eps, min_eig_thresh, op,
        ores, ok, st);
  } else {
    err = launch<per_thread(32 * 32), per_thread(33 * 33)>(
        r, cu, n_lanes, H, W, rp, g, n_pts, S, iters, walk_iters, eps, min_eig_thresh, op,
        ores, ok, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// The plain C entry point (loaded with ctypes), for n_lanes independent
// lanes stacked on a leading axis (1 <= n_lanes <= 65535; one image pair is
// one lane).  Images (n_lanes, H, W) f32 row-major; ref_pts, guesses, out_pts
// (n_lanes, n_pts, 2) f32 row-major; out_resid (n_lanes, n_pts) f32; out_ok
// (n_lanes, n_pts) bytes, 1 where min_eig > min_eig_thresh; where it is 0,
// out_pts holds the input guess.  The first min(iters, walk_iters) steps
// resample, the rest polish.  Requires 1 <= S <= 32, H >= S + 3, W >= S + 3,
// iters >= 0, walk_iters >= 0 (the caller checks).  One launch on `stream`,
// lanes on blockIdx.y; returns cudaGetLastError().
extern "C" int lk_level_f32(const void* ref, const void* cur, int n_lanes, int H, int W,
                            const void* ref_pts, const void* guesses, int n_pts, int S,
                            int iters, int walk_iters, float eps, float min_eig_thresh,
                            void* out_pts, void* out_resid, void* out_ok, void* stream) {
  return lk_level_lanes(ref, cur, n_lanes, H, W, ref_pts, guesses, n_pts, S, iters, walk_iters,
                        eps, min_eig_thresh, out_pts, out_resid, out_ok, stream);
}

// One empty kernel (one thread, no work) on `stream`.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
