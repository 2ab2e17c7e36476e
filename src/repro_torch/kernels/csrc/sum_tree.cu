// Sum tree for prioritized replay: batched stratified descent and batched
// last-write-wins leaf update with parent recomputation.
//
// Replaces the TPU kernels sumtree_find_pallas and sumtree_update_pallas
// (src/repro/kernels/sum_tree/sum_tree_pallas.py). The tree is flat, leaves
// first: level k (size cap >> k) starts at 2 * cap - 2 * (cap >> k), and the
// root is the last element. cap is a power of two, log2cap levels above the
// leaves.
//
// sumtree_find: one thread per mass walks from the root to a leaf, at each
// level reading the left child and going right when mass >= left (then
// subtracting left), the plain version's comparison and subtraction, so it
// is exact. At 2^20 leaves the tree is 8 MB and does not fit in shared
// memory; the walk reads it from global memory, where the upper levels stay
// in L2. Bound on an H100: HBM bytes of the nodes the batch's paths touch,
// but its time is latency: log2cap dependent loads per thread.
//
// sumtree_update: one block of 1024 threads in phases, __syncthreads()
// between them:
//   1. atomicMax(winner[idx[j]], j): the last position of each leaf index
//      (winner is an int32 scratch of cap entries, -1 between calls);
//   2. the winner alone writes its leaf, so duplicates resolve
//      last-write-wins, as the reference's in-order scatter does;
//   3. winner[idx[j]] = -1, the scratch reset for the next call;
//   4. level by level, every touched parent = left + right from the
//      post-write children. Duplicate parents store the same sum.
// This is the reference's touched-path recomputation, so it is exact. An
// index in [-cap, 0) counts from the end and one outside [-cap, cap) is
// dropped, as jnp's scatter does. Bound on an H100: HBM bytes of idx and
// values read, each distinct leaf written once, and for each touched parent
// one 4-byte write plus a 4-byte read of each child that is not itself on a
// touched path (a touched child's value was just written by this call). One
// block keeps the phase barriers cheap, and its threads stride over the
// indices (about 20,000 consecutive ones when a batch of transitions is
// added, 256 when the learner's priorities come back).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFindThreads = 256;
constexpr int kUpdateThreads = 1024;

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

__global__ void find_kernel(const float* __restrict__ flat,
                            const float* __restrict__ masses,
                            int32_t* __restrict__ out, long long cap,
                            int log2cap, int batch) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= batch) return;
  float m = masses[j];
  long long idx = 0;
  for (int k = log2cap - 1; k >= 0; --k) {
    idx *= 2;
    float left = flat[level_offset(cap, k) + idx];
    bool right = m >= left;
    m = right ? m - left : m;
    idx = right ? idx + 1 : idx;
  }
  out[j] = (int32_t)idx;
}

__global__ void update_kernel(float* flat, int32_t* winner,
                              const int32_t* __restrict__ idx,
                              const float* __restrict__ values, long long cap,
                              int log2cap, int batch) {
  const unsigned ucap = (unsigned)cap;
  for (int j = threadIdx.x; j < batch; j += blockDim.x) {
    int i = leaf_index(idx[j], ucap);
    if (i >= 0) atomicMax(&winner[i], j);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < batch; j += blockDim.x) {
    int i = leaf_index(idx[j], ucap);
    if (i >= 0 && winner[i] == j) flat[i] = values[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < batch; j += blockDim.x) {
    int i = leaf_index(idx[j], ucap);
    if (i >= 0) winner[i] = -1;
  }
  for (int k = 0; k < log2cap; ++k) {
    __syncthreads();
    const float* lo = flat + level_offset(cap, k);
    float* hi = flat + level_offset(cap, k + 1);
    for (int j = threadIdx.x; j < batch; j += blockDim.x) {
      int i = leaf_index(idx[j], ucap);
      if (i < 0) continue;
      int p = i >> (k + 1);
      hi[p] = lo[2 * p] + lo[2 * p + 1];
    }
  }
}

}  // namespace

// flat (2 cap - 1,) f32, masses (batch,) f32 -> out (batch,) int32.
extern "C" int sumtree_find(const void* flat, const void* masses, void* out,
                            long long cap, int log2cap, int batch,
                            void* stream) {
  int blocks = (batch + kFindThreads - 1) / kFindThreads;
  find_kernel<<<blocks, kFindThreads, 0, (cudaStream_t)stream>>>(
      (const float*)flat, (const float*)masses, (int32_t*)out, cap, log2cap,
      batch);
  return (int)cudaGetLastError();
}

// In place on flat; idx (batch,) int32 (one in [-cap, 0) counts from the
// end, one outside [-cap, cap) is dropped), values (batch,) f32, winner
// (cap,) int32 all -1 (left so on return); cap <= 2^31.
extern "C" int sumtree_update(void* flat, void* winner, const void* idx,
                              const void* values, long long cap, int log2cap,
                              int batch, void* stream) {
  update_kernel<<<1, kUpdateThreads, 0, (cudaStream_t)stream>>>(
      (float*)flat, (int32_t*)winner, (const int32_t*)idx,
      (const float*)values, cap, log2cap, batch);
  return (int)cudaGetLastError();
}
