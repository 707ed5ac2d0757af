// Vocabulary-tree descent through the deep levels, sm_90a.
//
// Replaces the TPU kernel ros_stereo_slam_tpu/ops/vocab_pallas.py::_deep_descend_kernel
// (entry point deep_descend).  Per descriptor q (256 components in {-1, 0, +1})
// and per level l, starting from its entry node:
//   dot_j = q . T_l[node * k + j]   for the k sibling rows j = 0..k-1,
//   best  = the first max (highest dot; among equal dots the lowest j),
//   node  = node * k + best.
// Every dot is an integer |dot| <= 256, summed here in int32, so the result is
// bit-identical to the gather route of vocab._descend (torch.argmax takes the
// first max too).  An all-zero (invalid) descriptor ties every sibling at 0
// and takes child 0 at every level, as the gather route does.
//
// What bounds it on an H100: at k = 9 a sibling group is 9 x 256 = 2,304
// bytes of int8 rows, read once per descriptor and level from tables of
// 15 MB and 136 MB (the larger does not fit the 50 MB L2).  512 descriptors
// over 2 levels read ~2.4 MB at random row offsets, a chain of two dependent
// loads per descriptor, so the kernel is bound by DRAM latency, not by
// bandwidth or arithmetic.
//
// Design: one warp per descriptor, kWarpsPerBlock warps per block.  Lane l
// holds components 8 l .. 8 l + 7 as integers and reads the matching 8 bytes
// of each sibling row as one 64-bit load, so a row is one coalesced 256-byte
// warp read.  A butterfly of integer shuffles gives every lane the same exact
// dot; the first-max compare is strict, so lower siblings win ties.  The
// tables are read as they are: no packing, no tail pad and no DMA windows.
// A node whose sibling group would lie outside its table writes -1 and stops
// (the caller hands in valid nodes; the guard keeps every read in bounds).
//
// What the TPU kernel does and this one does not: 8-aligned 16-row DMA windows
// over tail-padded tables, the NBUF-deep semaphore pipeline, SMEM node arrays,
// the masked (16, 256) f32 multiply and the custom_vmap lane flattening.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kDim = 256;
constexpr int kMaxLevels = 8;
constexpr unsigned kFullMask = 0xffffffffu;

struct Tables {
  const int8_t* rows[kMaxLevels];  // level l: (n_rows[l], 256) int8, row-major
  int n_rows[kMaxLevels];
};

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ int dot8(const int (&q)[8], uint2 packed) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += q[i] * static_cast<int>(static_cast<int8_t>((packed.x >> (8 * i)) & 0xffu));
    s += q[4 + i] * static_cast<int>(static_cast<int8_t>((packed.y >> (8 * i)) & 0xffu));
  }
  return s;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vocab_descend_kernel(const float* __restrict__ q_sign, const int* __restrict__ node_in,
                     int n, const __grid_constant__ Tables tables, int n_levels, int k,
                     int* __restrict__ node_out) {
  const int p = blockIdx.x * kWarpsPerBlock + static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (p >= n) return;  // uniform per warp
  const float4* qrow = reinterpret_cast<const float4*>(q_sign + static_cast<size_t>(p) * kDim);
  const float4 a = qrow[2 * lane];
  const float4 b = qrow[2 * lane + 1];
  const int q[8] = {__float2int_rn(a.x), __float2int_rn(a.y), __float2int_rn(a.z),
                    __float2int_rn(a.w), __float2int_rn(b.x), __float2int_rn(b.y),
                    __float2int_rn(b.z), __float2int_rn(b.w)};
  int node = node_in[p];
  for (int l = 0; l < n_levels; ++l) {
    const long long first = static_cast<long long>(node) * k;
    if (node < 0 || first + k > tables.n_rows[l]) {
      node = -1;
      break;
    }
    const int8_t* group = tables.rows[l] + first * kDim + 8 * lane;
    int best_dot = -(kDim + 1);
    int best = 0;
    for (int j = 0; j < k; ++j) {
      const uint2 packed = __ldg(reinterpret_cast<const uint2*>(group + j * kDim));
      const int dot = warp_sum_int(dot8(q, packed));
      if (dot > best_dot) {  // strict: the first max wins ties
        best_dot = dot;
        best = j;
      }
    }
    node = static_cast<int>(first) + best;
  }
  if (lane == 0) node_out[p] = node;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q_sign (n, 256) f32 with entries
// in {-1, 0, +1}, 16-byte aligned; node_in, node_out (n,) int32; tables[l]
// (n_rows[l], 256) int8 row-major, 8-byte aligned, for l < n_levels <= 8;
// k >= 1.  Launches on `stream` and returns cudaGetLastError().
extern "C" int vocab_descend_f32(const void* q_sign, const void* node_in, int n,
                                 const void* const* tables, const int* n_rows, int n_levels,
                                 int k, void* node_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_levels < 1 || n_levels > kMaxLevels || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables t{};
  for (int l = 0; l < n_levels; ++l) {
    t.rows[l] = static_cast<const int8_t*>(tables[l]);
    t.n_rows[l] = n_rows[l];
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  vocab_descend_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_sign), static_cast<const int*>(node_in), n, t, n_levels, k,
      static_cast<int*>(node_out));
  return static_cast<int>(cudaGetLastError());
}
