// Sum tree for prioritized replay: batched stratified descent and batched
// last-write-wins leaf update with parent recomputation.
//
// Replaces the TPU kernels sumtree_find_pallas and sumtree_update_pallas
// (src/repro/kernels/sum_tree/sum_tree_pallas.py). The tree is flat, leaves
// first: level k (size cap >> k) starts at 2 * cap - 2 * (cap >> k), and the
// root is the last element. cap is a power of two, log2cap levels above the
// leaves.
//
// sumtree_find: a warp per mass descends 5 levels a trip (find_trip): the
// 31 left children below the warp's node are one load a lane, all issued
// at once; then each lane walks one of the 32 candidate paths of the 5
// choices in registers, with the plain version's comparison and
// subtraction on the stored nodes (go right when mass >= left, then
// subtract left), and the one path whose choices are all its own is the
// descent's. So it is exact, and at 2^20 leaves a mass makes 4 dependent
// trips to global memory where a thread a mass made 20. A batch above
// kFindWarpBatch takes the plain walk, a thread a mass. The tree is 8 MB
// and is read from L2. Bound on an H100: HBM bytes of the nodes the
// batch's paths touch, but its time is latency: the launch and the trips
// (an L2 round trip each, plus a trip's shuffles and walk). Staging the
// top 8 to 12 levels in shared memory (one coalesced load a block, then
// the walk through them) measured slower than reading them through L1 and
// L2; so did each lane loading its own path's 5 nodes, and 6 to 8 levels a
// trip (2 to 8 paths a lane).
//
// sumtree_update: last write wins at the leaves, then every touched parent
// recomputed as left + right from the children after the write. One host
// call:
// - up to 256 indices (the learner's priorities): one launch of
//   walk_kernel, one block, a thread per index. atomicMax(winner[i], j)
//   picks the last position of each leaf and that thread writes it; then
//   every thread recomputes its path's parent, a level at a time (a
//   __syncthreads() and a global round trip each; a parent two paths share
//   is written twice with the same sum). This is the one-block walk the
//   port had, one index per thread: on an H100 it beat the alternatives
//   measured for this batch (the subtree kernel below; the top 11 levels in
//   shared memory; the paths' nodes in a shared-memory hash table);
// - more (an add of 20,000): two launches. mark_kernel, a thread per
//   index, leaves the atomicMax winners and a flag per touched subtree of
//   2^11 leaves. update_kernel has a block of 256 per such subtree (512 at
//   2^20 leaves). A block whose flag is not set is done at once. Otherwise
//   it writes its winning leaves and loads the subtree's nodes into shared
//   memory (every load issued before any is used: one round trip),
//   recomputes level by level (a __syncthreads() each) only the parents
//   with a touched child, writes exactly those, and flags its root at the
//   root level of every group of levels above (groups of 11 levels, the
//   top one shorter; sumtree_update_scratch gives the scratch this layout
//   needs, and the wrapper allocates that). The block that counts itself
//   done last does the upper groups the same way, a subtree at a time (one
//   at 2^20 leaves). No block waits on another.
// Each winner, flag and the done counter go back to -1, so the scratch is
// all -1 between calls and both paths can be replayed from a CUDA graph. A
// parent's children are final before it is computed (level barriers;
// across launches, stream order; across groups, the done counter), so every
// touched parent is computed from the same operands as the plain version's
// in-order recomputation, and the result is the plain version's bit for
// bit. An index in [-cap, 0) counts from the end and one outside [-cap,
// cap) is dropped, as jnp's scatter does. Bound on an H100: HBM bytes of
// idx and values read, each distinct leaf written once, and for each
// touched parent one 4-byte write plus a 4-byte read of each child that is
// not itself on a touched path. Its time is latency: the launches and the
// chains of dependent round trips (20 levels in the walk).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFindThreads = 256;
constexpr int kFindLevels = 5;          // a warp's levels a trip
// Up to this batch a warp takes a mass. Above, the warps have no lanes and
// issue slots to spare and the plain walk wins (an H100 at 2^20 leaves:
// 4.17 against 4.59 us at 4,096 masses, 6.64 against 4.67 at 8,192).
constexpr int kFindWarpBatch = 4096;
constexpr int kWalkThreads = 256;      // walk_kernel: up to this batch
constexpr int kUpdateThreads = 256;
constexpr int kGroupLevels = 11;        // levels per group (the top less)
constexpr int kGroupNodes = 1 << kGroupLevels;
constexpr int kNodesPerThread = kGroupNodes / kUpdateThreads;

__device__ __forceinline__ long long level_offset(long long cap, int k) {
  return 2 * cap - 2 * (cap >> k);
}

// idx in [-cap, 0) counts from the end, as jnp indexing does; -1 marks an
// index outside [-cap, cap), which the update drops. ucap = cap <= 2^31:
// an index below -cap wraps to 2^31 or more, so one unsigned compare
// rejects it and every index at or above cap.
__device__ __forceinline__ int leaf_index(int32_t i, unsigned ucap) {
  unsigned n = (unsigned)i + (i < 0 ? ucap : 0u);
  return n < ucap ? (int)n : -1;
}

__device__ __forceinline__ unsigned level_offset32(unsigned cap, int k) {
  return (cap - (cap >> k)) * 2u;
}

// One trip of a warp's descent, from node idx at level `level` down k =
// min(kFindLevels, level) levels. A path through the k levels is k
// choices, the first the highest bit of t in [0, 2^k); lane t takes path
// t mod 2^k. The left children on all the paths are 2^k - 1 nodes, one a
// lane: the r-th of the s-th level below idx's is lane 2^s - 1 + r's (one
// load a lane, all issued at once: one round trip). Each lane takes its
// path's k nodes from their lanes (shuffles) and walks the path with the
// plain version's compare and subtract, noting whether every choice it
// makes is the path's own. Exactly one path is, the descent's (a path that
// follows the descent's first choices reads the descent's nodes with its
// mass, so it makes its next choice); the warp takes that lane's mass.
__device__ __forceinline__ void find_trip(float& m, unsigned& idx,
                                          int& level, int lane,
                                          const float* __restrict__ flat,
                                          unsigned cap) {
  constexpr int K = kFindLevels;
  const int k = min(K, level);
  const unsigned paths = (1u << k) - 1;
  const int s_mine = 31 - __clz(lane + 1);
  float mine = 0.0f;
  if (lane < (int)paths)
    mine = flat[level_offset32(cap, level - 1 - s_mine) +
                2 * ((idx << s_mine) + (unsigned)(lane + 1 - (1 << s_mine)))];
  const unsigned t = lane & paths;
  float left[K];
#pragma unroll
  for (int s = 0; s < K; ++s)
    left[s] = __shfl_sync(0xffffffffu, mine,
                          (1 << s) - 1 + (s < k ? (int)(t >> (k - s)) : 0));
  float x = m;
  bool own = true;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      const bool right = x >= left[s];
      x = right ? x - left[s] : x;
      own = own && right == (((t >> (k - 1 - s)) & 1u) != 0);
    }
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, own)) - 1;
  m = __shfl_sync(0xffffffffu, x, src);
  idx = (idx << k) + ((unsigned)src & paths);
  level -= k;
}

// kWarp: a warp a mass (find_trip); else the plain walk, a thread a mass
// and a level a trip.
template <bool kWarp>
__global__ void __launch_bounds__(kFindThreads) find_kernel(
    const float* __restrict__ flat, const float* __restrict__ masses,
    int32_t* __restrict__ out, unsigned cap, int log2cap, int batch) {
  const int t = blockIdx.x * kFindThreads + threadIdx.x;
  const int j = kWarp ? t / 32 : t;
  if (j >= batch) return;                 // with kWarp, the whole warp
  float m = masses[j];
  unsigned idx = 0;
  for (int level = log2cap; level > 0;) {
    if constexpr (kWarp) {
      find_trip(m, idx, level, t % 32, flat, cap);
    } else {
      const float left = flat[level_offset32(cap, level - 1) + 2 * idx];
      const bool right = m >= left;
      m = right ? m - left : m;
      idx = 2 * idx + (right ? 1u : 0u);
      --level;
    }
  }
  if (!kWarp || t % 32 == 0) out[j] = (int32_t)idx;
}

// One block, a thread per index (batch <= kWalkThreads).
__global__ void __launch_bounds__(kWalkThreads) walk_kernel(
    float* flat, int32_t* winner, const int32_t* __restrict__ idx,
    const float* __restrict__ values, long long cap, int log2cap,
    int batch) {
  const int j = threadIdx.x;
  const int i = j < batch ? leaf_index(idx[j], (unsigned)cap) : -1;
  if (i >= 0) atomicMax(&winner[i], j);
  __syncthreads();
  if (i >= 0 && __ldcg(&winner[i]) == j) flat[i] = values[j];
  __syncthreads();
  if (i >= 0) winner[i] = -1;
  for (int k = 0; k < log2cap; ++k) {
    __syncthreads();
    if (i < 0) continue;
    const long long p = i >> (k + 1);
    const float* lo = flat + level_offset(cap, k);
    flat[level_offset(cap, k + 1) + p] = __ldcg(&lo[2 * p]) +
                                         __ldcg(&lo[2 * p + 1]);
  }
}

// One thread per index j of a larger batch: winner[i] = the last j with
// leaf i, and the flag of i's bottom subtree (a flag the thread before j
// set for the same subtree is skipped).
__global__ void mark_kernel(int32_t* winner, int32_t* flags,
                            const int32_t* __restrict__ idx, long long cap,
                            int lr0, int batch) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  const unsigned ucap = (unsigned)cap;
  const int i = leaf_index(idx[j], ucap);
  if (i < 0) return;
  atomicMax(&winner[i], j);
  const int prev = j > 0 ? leaf_index(idx[j - 1], ucap) : -1;
  if (prev < 0 || (prev >> lr0) != (i >> lr0)) flags[i >> lr0] = 0;
}

// The touched parents of subtree s of h levels above level lb (2^h bottom
// nodes), bottom up in shared memory, by the whole block; writes exactly
// the touched nodes. Bottom nodes are touched where win[m] >= 0 (the bottom
// group: values[win[m]] is the leaf's new mass) or, above, where the group
// below flagged them (the flag is consumed: set back to -1). Each thread
// issues all its loads before it uses one. They bypass L1 (__ldcg): upper
// nodes were written by other blocks of this launch.
__device__ void rebuild(float* flat, const float* __restrict__ values,
                        const int* win, int32_t* bottom_flags, long long cap,
                        int lb, int h, long long s, float* val,
                        unsigned char* hit) {
  const int M = 1 << h;
  float* bottom = flat + level_offset(cap, lb) + s * M;
  float v[kNodesPerThread], up[kNodesPerThread];
  bool touched[kNodesPerThread];
#pragma unroll
  for (int i = 0; i < kNodesPerThread; ++i) {
    const int m = threadIdx.x + i * kUpdateThreads;
    touched[i] = false;
    if (m >= M) continue;
    if (win != nullptr) {
      const int w = win[m];
      touched[i] = w >= 0;
      v[i] = __ldcg(touched[i] ? values + w : bottom + m);
    } else {
      touched[i] = __ldcg(bottom_flags + s * M + m) != -1;
      v[i] = __ldcg(bottom + m);
    }
  }
#pragma unroll
  for (int i = 0; i < kNodesPerThread; ++i) {   // the nodes above, u >= M
    const int u = M + threadIdx.x + i * kUpdateThreads;
    if (u >= 2 * M - 1) continue;
    const int k = h - (31 - __clz(2 * M - u - 1)), cnt = M >> k;
    up[i] = __ldcg(flat + level_offset(cap, lb + k) + s * cnt + u -
                   (2 * M - 2 * cnt));
  }
#pragma unroll
  for (int i = 0; i < kNodesPerThread; ++i) {
    const int m = threadIdx.x + i * kUpdateThreads, u = M + m;
    if (m < M) {
      val[m] = v[i];
      hit[m] = touched[i];
      if (touched[i] && win != nullptr) bottom[m] = v[i];
      if (touched[i] && win == nullptr) bottom_flags[s * M + m] = -1;
    }
    if (u < 2 * M - 1) val[u] = up[i];
  }
  __syncthreads();
  for (int k = 1; k <= h; ++k) {
    const int cnt = M >> k, lo = 2 * M - 4 * cnt, hi = 2 * M - 2 * cnt;
    float* level = flat + level_offset(cap, lb + k) + s * cnt;
    for (int p = threadIdx.x; p < cnt; p += kUpdateThreads) {
      const bool t = hit[lo + 2 * p] | hit[lo + 2 * p + 1];
      hit[hi + p] = t;
      if (t) level[p] = val[hi + p] = val[lo + 2 * p] + val[lo + 2 * p + 1];
    }
    __syncthreads();
  }
}

// One block per subtree s of the bottom group, after mark_kernel. flags:
// one array per group, of cap >> (its root level) entries; done counts the
// bottom subtrees from -1.
__global__ void __launch_bounds__(kUpdateThreads) update_kernel(
    float* flat, int32_t* winner, int32_t* flags, int32_t* done,
    const float* __restrict__ values, long long cap, int log2cap) {
  __shared__ float val[2 * kGroupNodes];
  __shared__ unsigned char hit[2 * kGroupNodes];
  __shared__ int win[kGroupNodes];
  __shared__ int last;
  const int lr0 = min(kGroupLevels, log2cap), M = 1 << lr0;
  const long long s = blockIdx.x;
  if (__ldcg(&flags[s]) != -1) {          // the same word for all
#pragma unroll
    for (int i = 0; i < kNodesPerThread; ++i) {
      const int m = threadIdx.x + i * kUpdateThreads;
      if (m < M) win[m] = __ldcg(&winner[s * M + m]);
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += kUpdateThreads)
      if (win[m] >= 0) winner[s * M + m] = -1;
    rebuild(flat, values, win, nullptr, cap, 0, lr0, s, val, hit);
    if (threadIdx.x == 0) {               // flag s's root in every group
      long long off = 0;
      int lr = 0;
      do {
        lr = min(lr + kGroupLevels, log2cap);
        flags[off + (s >> (lr - lr0))] = lr0 == log2cap ? -1 : 0;
        off += cap >> lr;
      } while (lr < log2cap);
    }
  }
  if (lr0 == log2cap) return;             // one group: nothing above
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 2;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int32_t* below = flags;
  long long off = cap >> lr0;
  for (int lb = lr0, lr; lb < log2cap; lb = lr) {
    lr = min(lb + kGroupLevels, log2cap);
    int32_t* roots = flags + off;
    for (long long t = 0; t < cap >> lr; ++t) {
      if (__ldcg(&roots[t]) == -1) continue;   // the same word for all
      rebuild(flat, values, nullptr, below, cap, lb, lr - lb, t, val, hit);
      if (lr == log2cap && threadIdx.x == 0) roots[t] = -1;
    }
    below = roots;
    off += cap >> lr;
  }
  if (threadIdx.x == 0) *done = -1;
}

}  // namespace

// flat (2 cap - 1,) f32, masses (batch,) f32 -> out (batch,) int32;
// cap <= 2^31. One launch.
extern "C" int sumtree_find(const void* flat, const void* masses, void* out,
                            long long cap, int log2cap, int batch,
                            void* stream) {
  const bool warp = batch <= kFindWarpBatch;
  const long long threads = warp ? 32LL * batch : batch;
  auto kernel = warp ? find_kernel<true> : find_kernel<false>;
  kernel<<<(unsigned)((threads + kFindThreads - 1) / kFindThreads),
           kFindThreads, 0, (cudaStream_t)stream>>>(
      (const float*)flat, (const float*)masses, (int32_t*)out, (unsigned)cap,
      log2cap, batch);
  return (int)cudaGetLastError();
}

// The dependent global round trips of a mass's descent through a tree of
// log2cap levels, in a batch of `batch` masses (the mass's load goes with
// the first).
extern "C" int sumtree_find_trips(int log2cap, int batch) {
  return batch <= kFindWarpBatch ? (log2cap + kFindLevels - 1) / kFindLevels
                                 : log2cap;
}

// int32 flags of the groups' root levels: cap >> (root level) each.
static long long group_flags(long long cap, int log2cap) {
  long long n = 0;
  int lr = 0;
  do {
    lr = lr + kGroupLevels < log2cap ? lr + kGroupLevels : log2cap;
    n += cap >> lr;
  } while (lr < log2cap);
  return n;
}

// int32 entries of sumtree_update's scratch for cap leaves: cap winners,
// the groups' flags, the done counter.
extern "C" long long sumtree_update_scratch(long long cap) {
  int log2cap = 0;
  while ((2LL << log2cap) <= cap) ++log2cap;
  return cap + group_flags(cap, log2cap) + 1;
}

// In place on flat; idx (batch,) int32 (one in [-cap, 0) counts from the
// end, one outside [-cap, cap) is dropped), values (batch,) f32, batch >= 1;
// scratch int32 of sumtree_update_scratch(cap) entries, all -1 (left so on
// return); cap <= 2^31. One launch up to 256 indices, two above.
extern "C" int sumtree_update(void* flat, void* scratch, const void* idx,
                              const void* values, long long cap, int log2cap,
                              int batch, void* stream) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int32_t* winner = (int32_t*)scratch;
  if (batch <= kWalkThreads) {
    walk_kernel<<<1, kWalkThreads, 0, st>>>(
        (float*)flat, winner, (const int32_t*)idx, (const float*)values, cap,
        log2cap, batch);
    return (int)cudaGetLastError();
  }
  int32_t* flags = winner + cap;
  const int lr0 = kGroupLevels < log2cap ? kGroupLevels : log2cap;
  mark_kernel<<<(batch + kUpdateThreads - 1) / kUpdateThreads,
                kUpdateThreads, 0, st>>>(winner, flags, (const int32_t*)idx,
                                         cap, lr0, batch);
  update_kernel<<<(unsigned)(cap >> lr0), kUpdateThreads, 0, st>>>(
      (float*)flat, winner, flags, flags + group_flags(cap, log2cap),
      (const float*)values, cap, log2cap);
  return (int)cudaGetLastError();
}
