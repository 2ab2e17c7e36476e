// Replay ring: insert N rows at the write head, gather B rows at indices.
//
// Replaces the TPU kernels ring_insert_pallas and ring_gather_pallas
// (src/repro/kernels/replay_ring/replay_ring_pallas.py). Both only move
// bytes, so one pair of kernels serves every dtype: a storage leaf is seen
// as (cap, row_bytes) and copied in chunks of the widest of 16, 8, 4, 2 or
// 1 bytes that divides the row and both base addresses. One thread per
// (row, chunk), in a grid-stride loop; consecutive threads copy consecutive
// chunks of a row, so loads and stores coalesce row by row.
//
// ring_insert: batch row j goes to slot (start + j) % cap, in place. The TPU
// kernel writes rows in order, so when N > cap the last write to a slot
// wins; here only rows j >= N - cap are copied (first = max(0, N - cap)), so
// every slot is written by exactly one thread, with the row that wins there.
// ring_gather: output row r is storage row idx[r]; as in jnp indexing, a
// negative index counts from the end and the result is clamped into [0, cap).
//
// Bound on an H100: HBM bytes, each copied row read once and written once
// (the main path inserts about 20,000 rows of 144 B per iteration and
// gathers 256 rows); there is no arithmetic. Exact for every dtype.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

template <typename T>
__global__ void insert_rows(T* __restrict__ dst, const T* __restrict__ src,
                            long long cap, long long first, long long count,
                            long long start, long long chunks) {
  long long total = count * chunks;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    long long r = i / chunks;
    long long c = i - r * chunks;
    long long j = first + r;
    long long slot = (start + j) % cap;
    dst[slot * chunks + c] = src[j * chunks + c];
  }
}

template <typename T>
__global__ void gather_rows(T* __restrict__ dst, const T* __restrict__ src,
                            const int32_t* __restrict__ idx, long long cap,
                            long long rows, long long chunks) {
  long long total = rows * chunks;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    long long r = i / chunks;
    long long c = i - r * chunks;
    long long s = idx[r];
    s = s < 0 ? s + cap : s;
    s = s < 0 ? 0 : (s >= cap ? cap - 1 : s);
    dst[r * chunks + c] = src[s * chunks + c];
  }
}

// The widest chunk that divides the row and keeps both bases aligned.
int chunk_width(const void* a, const void* b, long long row_bytes) {
  for (int w = 16; w > 1; w /= 2) {
    if (row_bytes % w == 0 && (uintptr_t)a % w == 0 && (uintptr_t)b % w == 0)
      return w;
  }
  return 1;
}

int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
void launch_insert(void* dst, const void* src, long long cap, long long first,
                   long long count, long long start, long long row_bytes,
                   cudaStream_t stream) {
  long long chunks = row_bytes / (long long)sizeof(T);
  insert_rows<T><<<blocks_for(count * chunks), kThreads, 0, stream>>>(
      (T*)dst, (const T*)src, cap, first, count, start, chunks);
}

template <typename T>
void launch_gather(void* dst, const void* src, const int32_t* idx,
                   long long cap, long long rows, long long row_bytes,
                   cudaStream_t stream) {
  long long chunks = row_bytes / (long long)sizeof(T);
  gather_rows<T><<<blocks_for(rows * chunks), kThreads, 0, stream>>>(
      (T*)dst, (const T*)src, idx, cap, rows, chunks);
}

}  // namespace

// storage (cap, row_bytes) bytes, batch (n, row_bytes) bytes, 0 <= start <
// cap. Returns the cudaError_t of the launch.
extern "C" int ring_insert(void* storage, const void* batch, long long cap,
                           long long n, long long start, long long row_bytes,
                           void* stream) {
  long long first = n > cap ? n - cap : 0;
  long long count = n - first;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk_width(storage, batch, row_bytes)) {
    case 16: launch_insert<uint4>(storage, batch, cap, first, count, start, row_bytes, s); break;
    case 8: launch_insert<uint2>(storage, batch, cap, first, count, start, row_bytes, s); break;
    case 4: launch_insert<uint32_t>(storage, batch, cap, first, count, start, row_bytes, s); break;
    case 2: launch_insert<uint16_t>(storage, batch, cap, first, count, start, row_bytes, s); break;
    default: launch_insert<uint8_t>(storage, batch, cap, first, count, start, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}

// storage (cap, row_bytes) bytes, idx (rows,) int32, out (rows, row_bytes).
extern "C" int ring_gather(void* out, const void* storage, const void* idx,
                           long long cap, long long rows, long long row_bytes,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  switch (chunk_width(out, storage, row_bytes)) {
    case 16: launch_gather<uint4>(out, storage, ix, cap, rows, row_bytes, s); break;
    case 8: launch_gather<uint2>(out, storage, ix, cap, rows, row_bytes, s); break;
    case 4: launch_gather<uint32_t>(out, storage, ix, cap, rows, row_bytes, s); break;
    case 2: launch_gather<uint16_t>(out, storage, ix, cap, rows, row_bytes, s); break;
    default: launch_gather<uint8_t>(out, storage, ix, cap, rows, row_bytes, s); break;
  }
  return (int)cudaGetLastError();
}
