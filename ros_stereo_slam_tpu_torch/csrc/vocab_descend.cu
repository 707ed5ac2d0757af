// Vocabulary-tree descent over a bit-packed tree, sm_90a: every level in one launch.
//
// Replaces the TPU kernel ros_stereo_slam_tpu/ops/vocab_pallas.py::_deep_descend_kernel
// (entry point deep_descend) and the dense masked-argmax levels before it in
// ros_stereo_slam_tpu/models/vocab.py::_descend: the whole descent, from the root.
//
// The tree: every level's sign centers (+-1) packed at one bit per component
// into one (R, 8) table of 32-bit words, levels one after another (level l is
// rows offset[l] .. offset[l + 1] - 1); bit j of word w is component 32 w + j
// being +1, the layout of ops/orb.py::pack_bits.  A query is ORB's packed
// (8,) words and a valid flag.  Per valid query and per level l:
//   ham_j = popc(q ^ c_j) over the 8 words, c_j the sibling row node * k + j,
//   dot_j = 256 - 2 ham_j  (exact: both vectors are +-1),
//   best  = the first max of dot_j = the first min of ham_j (lowest j on ties),
//   node  = node * k + best.
// An invalid query takes child 0 at every level (word 0), as an all-zero sign
// row does in the reference (every dot ties at 0).  The word ids are therefore
// bit-identical to the reference's argmax-dot descent.
//
// What bounds it on an H100: at k = 9, L = 6 the packed tree is 597,870 rows x
// 32 bytes = 19.1 MB (the int8 tables were 153 MB), so it stays in the 50 MB
// L2.  A query reads one 288-byte sibling group per level, 6 dependent loads;
// 512 queries visit well under 1 MB.  The byte bound (~0.3 us) lies far under
// a launch, so the kernel is bound by the latency of its chain of L2 loads.
// So: no shared memory, every sibling load of a level issued before any
// reduction, few instructions between one level's loads and the next's.
//
// Design: a warp per query.  Lanes 2 j and 2 j + 1 read the two 16-byte halves
// of sibling row j (one 32-byte sector, requested once), popcount 4 words each,
// add the halves in one xor-shuffle, and the warp takes the min of
// (ham << 22 | j) in 4 more, which is the first min; 16 siblings a pass.  Two
// other designs were measured and dropped (PERF.md): 16 lanes per query, each
// reading a whole row as two 16-byte loads (slower L2-cold), and 8 lanes per
// query, lane w reading word w of every sibling (slower hot and cold).  No
// atomics: two runs agree bit for bit.  A sibling group that would lie
// outside its level (offsets that do not match k) writes -1 and stops.
//
// What the TPU kernel does and this one does not: 8-aligned 16-row DMA windows
// over tail-padded int8 tables, the semaphore pipeline, the masked (16, 256)
// f32 multiply, and the MXU masked argmax over whole shallow levels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;
constexpr int kLanes = 32;            // a warp per query
constexpr int kSiblingsPerPass = 16;  // two lanes per sibling row
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kIdxBits = 22;          // ham (<= 256) above, the sibling index below
constexpr int kIdxMask = (1 << kIdxBits) - 1;

struct Levels {
  int offset[kMaxLevels + 1];  // level l: tree rows offset[l] .. offset[l + 1] - 1
};

__device__ __forceinline__ int ham4(const uint4& q, const uint4& c) {
  return __popc(q.x ^ c.x) + __popc(q.y ^ c.y) + __popc(q.z ^ c.z) + __popc(q.w ^ c.w);
}

__global__ void __launch_bounds__(kThreads)
descend_packed(const uint4* __restrict__ q_bits, const uint8_t* __restrict__ valid, int n,
               const uint4* __restrict__ tree, const __grid_constant__ Levels lv, int n_levels,
               int k, long long* __restrict__ word_out) {
  const int t = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  const int p = t / kLanes;  // one query per warp
  const int lane = t % kLanes;
  const int half = lane & 1;  // which 16 bytes of a row this lane reads
  const int jl = lane >> 1;   // its sibling within a pass of kSiblingsPerPass
  if (p >= n) return;  // uniform per warp
  const uint4 qh = __ldg(q_bits + 2 * p + half);
  const bool ok = valid[p] != 0;
  long long node = 0;
  for (int l = 0; l < n_levels; ++l) {
    const long long first = node * k;
    if (first + k > lv.offset[l + 1] - lv.offset[l]) {
      node = -1;
      break;
    }
    if (!ok) {  // child 0
      node = first;
      continue;
    }
    const uint4* group = tree + 2 * (lv.offset[l] + first) + half;
    int best = 0x7fffffff;
    for (int j0 = 0; j0 < k; j0 += kSiblingsPerPass) {
      const int j = j0 + jl;
      int ham = 0;
      if (j < k) ham = ham4(qh, __ldg(group + 2 * j));
      ham += __shfl_xor_sync(kFullMask, ham, 1);  // the row's other half
      int key = j < k ? (ham << kIdxBits) | j : 0x7fffffff;
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) key = min(key, __shfl_xor_sync(kFullMask, key, off));
      best = min(best, key);  // an earlier pass holds lower j: first min kept
    }
    node = first + (best & kIdxMask);
  }
  if (lane == 0) word_out[p] = node;
}

}  // namespace

// Plain C entry point (loaded with ctypes):
// q_bits (n, 8) 32-bit words, 16-byte aligned; valid (n,) bytes (0 = invalid);
// tree (R, 8) 32-bit words, 16-byte aligned; offsets (n_levels + 1,) host ints,
// level l = tree rows offsets[l] .. offsets[l + 1] - 1; 1 <= n_levels <= 8;
// 1 <= k < 2^22; word_out (n,) int64.  Launch on `stream`, return
// cudaGetLastError().
extern "C" int vocab_descend_packed(const void* q_bits, const void* valid, int n, const void* tree,
                                    const int* offsets, int n_levels, int k, void* word_out,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_levels < 1 || n_levels > kMaxLevels || k < 1 || k > kIdxMask) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  for (int l = 0; l <= n_levels; ++l) lv.offset[l] = offsets[l];
  const long long threads = static_cast<long long>(n) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  descend_packed<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q_bits), static_cast<const uint8_t*>(valid), n,
      static_cast<const uint4*>(tree), lv, n_levels, k, static_cast<long long*>(word_out));
  return static_cast<int>(cudaGetLastError());
}
