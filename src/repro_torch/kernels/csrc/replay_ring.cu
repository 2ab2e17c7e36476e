// Replay ring: insert N rows at the write head, gather B rows at indices,
// over every leaf of a storage dict in one launch per op.
//
// Replaces the TPU kernels ring_insert_pallas and ring_gather_pallas
// (src/repro/kernels/replay_ring/replay_ring_pallas.py). Both only move
// bytes, so they serve every dtype exactly: a storage leaf is seen as
// (cap, row_bytes). Bound on an H100: HBM bytes, each copied row read once
// and written once; there is no arithmetic. At the main path's shapes (an
// insert of 20,000 rows of 144 B in 5 leaves, a gather of 256 rows) the
// time of one launch per leaf was launch latency, not bytes, so each op is
// one launch over a table of all its leaves, passed by value as a kernel
// parameter: nothing is copied to the device before the launch, and both
// ops can be captured in a CUDA graph.
//
// ring_insert: batch row j goes to slot (start + j) % cap. When N > cap the
// last write to a slot wins, so only rows j >= N - cap are copied, and they
// land in at most two contiguous runs of slots. The wrapper turns each leaf
// into at most two byte segments (src, dst, nbytes), and the kernel is a
// memcpy of up to kMaxSegments segments. Each block copies a fixed span of
// one segment (kSpan bytes, 16 KB: about 180 blocks at the main path's
// insert, every SM streaming), found from a prefix table of block starts.
// Within a segment the body moves in the widest unit w of 16, 8 or 4 bytes
// for which source and destination agree mod w, kUnroll loads in flight per
// thread before the stores, consecutive threads on consecutive units; the
// unaligned head and tail bytes are peeled. Where the two differ mod 4 the
// body is still written in aligned 4-byte words, each put together from the
// two aligned source words it straddles with a funnel shift.
//
// ring_gather: output row r of a leaf is storage row idx[r]; as in jnp
// indexing, a negative index counts from the end and the result is clamped
// into [0, cap). A block takes a tile of kTileRows rows (32 blocks for B =
// 256), reads and clamps their indices once into shared memory, then copies
// those rows of every leaf into that leaf's output block, in the widest
// chunk that divides the leaf's row and keeps both bases aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kMaxSegments = 2 * kMaxLeaves;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kSpan = (long long)kThreads * kUnroll * 16;
constexpr int kTileRows = 8;
constexpr int kGatherThreads = 128;

struct Segment {
  const uint8_t* src;
  uint8_t* dst;
  long long nbytes;
  long long units;  // body units after the head bytes
  int head;         // bytes before the first aligned destination unit
  int width;        // body unit: 16, 8 or 4 bytes; 0 = shifted 4-byte words
  int first_block;  // the segment's blocks are [first_block, next's)
};

struct InsertTable {
  Segment seg[kMaxSegments];
  int count;
};

struct GatherLeaf {
  const uint8_t* storage;
  uint8_t* out;
  int row_bytes;
  int width;   // chunk: 16, 8, 4, 2 or 1 bytes
  int chunks;  // row_bytes / width
};

struct GatherTable {
  GatherLeaf leaf[kMaxLeaves];
  int count;
  long long cap;
  long long rows;
};

// Copy units [u0, u1) of T from s to d, kUnroll loads in flight per thread.
template <typename T>
__device__ void copy_units(T* __restrict__ d, const T* __restrict__ s,
                           long long u0, long long u1) {
  for (long long u = u0 + threadIdx.x; u < u1;
       u += (long long)kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      long long i = u + (long long)k * kThreads;
      if (i < u1) v[k] = s[i];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      long long i = u + (long long)k * kThreads;
      if (i < u1) d[i] = v[k];
    }
  }
}

// Aligned 4-byte words [u0, u1) of d from a source that starts ``shift``
// bytes (1..3) past the aligned word s[0]: word u is bytes shift.. of s[u]
// followed by bytes ..shift-1 of s[u + 1]. s[u + 1] holds at least one byte
// of the segment, so it lies in the same allocation's pages.
__device__ void copy_shifted(uint32_t* __restrict__ d,
                             const uint32_t* __restrict__ s, int shift,
                             long long u0, long long u1) {
  for (long long u = u0 + threadIdx.x; u < u1;
       u += (long long)kThreads * kUnroll) {
    uint32_t lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      long long i = u + (long long)k * kThreads;
      if (i < u1) {
        lo[k] = s[i];
        hi[k] = s[i + 1];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      long long i = u + (long long)k * kThreads;
      if (i < u1) d[i] = __funnelshift_r(lo[k], hi[k], 8 * shift);
    }
  }
}

// The body unit of a segment, from its two addresses.
int segment_width(const void* src, const void* dst) {
  uintptr_t diff = (uintptr_t)src ^ (uintptr_t)dst;
  for (int w = 16; w >= 4; w /= 2) {
    if (diff % w == 0) return w;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
insert_segments(const __grid_constant__ InsertTable table) {
  int s = 0;
  while (s + 1 < table.count &&
         (int)blockIdx.x >= table.seg[s + 1].first_block)
    ++s;
  const Segment& g = table.seg[s];
  int w = g.width ? g.width : 4;
  long long block = blockIdx.x - g.first_block;
  long long per_block = kSpan / w;
  long long u0 = block * per_block;
  long long u1 = u0 + per_block < g.units ? u0 + per_block : g.units;
  const uint8_t* src = g.src + g.head;
  uint8_t* dst = g.dst + g.head;
  switch (g.width) {
    case 16: copy_units((uint4*)dst, (const uint4*)src, u0, u1); break;
    case 8: copy_units((uint2*)dst, (const uint2*)src, u0, u1); break;
    case 4: copy_units((uint32_t*)dst, (const uint32_t*)src, u0, u1); break;
    default: {
      int shift = (int)((uintptr_t)src % 4);
      copy_shifted((uint32_t*)dst, (const uint32_t*)(src - shift), shift, u0,
                   u1);
    }
  }
  if (block == 0) {  // the peeled head and tail bytes, fewer than w each
    int t = threadIdx.x;
    long long tail = g.head + g.units * w;
    if (t < g.head) g.dst[t] = g.src[t];
    if (t >= 16 && t - 16 < g.nbytes - tail)
      g.dst[tail + t - 16] = g.src[tail + t - 16];
  }
}

// One chunk of ``width`` bytes, held in the low bytes of a uint4.
__device__ uint4 load_chunk(const uint8_t* p, int width) {
  uint4 x = make_uint4(0, 0, 0, 0);
  switch (width) {
    case 16: x = *(const uint4*)p; break;
    case 8: {
      uint2 y = *(const uint2*)p;
      x.x = y.x;
      x.y = y.y;
    } break;
    case 4: x.x = *(const uint32_t*)p; break;
    case 2: x.x = *(const uint16_t*)p; break;
    default: x.x = *p;
  }
  return x;
}

__device__ void store_chunk(uint8_t* p, int width, uint4 x) {
  switch (width) {
    case 16: *(uint4*)p = x; break;
    case 8: *(uint2*)p = make_uint2(x.x, x.y); break;
    case 4: *(uint32_t*)p = x.x; break;
    case 2: *(uint16_t*)p = (uint16_t)x.x; break;
    default: *p = (uint8_t)x.x;
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_rows(const __grid_constant__ GatherTable table,
            const int32_t* __restrict__ idx) {
  __shared__ long long slot[kTileRows];
  long long row0 = (long long)blockIdx.x * kTileRows;
  int rows = table.rows - row0 < kTileRows ? (int)(table.rows - row0)
                                           : kTileRows;
  if (threadIdx.x < rows) {
    long long c = table.cap;
    long long x = idx[row0 + threadIdx.x];
    x = x < 0 ? x + c : x;
    slot[threadIdx.x] = x < 0 ? 0 : (x >= c ? c - 1 : x);
  }
  __syncthreads();
  // The tile's work items, leaf after leaf: (row, chunk) of each leaf.
  int items = 0;
  for (int l = 0; l < table.count; ++l) items += rows * table.leaf[l].chunks;
  for (int base = threadIdx.x; base < items;
       base += kGatherThreads * kUnroll) {
    uint4 v[kUnroll];
    uint8_t* to[kUnroll];
    int width[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int i = base + k * kGatherThreads;
      width[k] = 0;
      if (i >= items) continue;
      int l = 0;
      while (i >= rows * table.leaf[l].chunks) {
        i -= rows * table.leaf[l].chunks;
        ++l;
      }
      const GatherLeaf& f = table.leaf[l];
      int r = i / f.chunks;
      long long off = (long long)(i - r * f.chunks) * f.width;
      to[k] = f.out + (row0 + r) * f.row_bytes + off;
      width[k] = f.width;
      v[k] = load_chunk(f.storage + slot[r] * f.row_bytes + off, f.width);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (width[k]) store_chunk(to[k], width[k], v[k]);
    }
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

}  // namespace

// table: count rows of (src, dst, nbytes), nbytes > 0, count <= 2 *
// kMaxLeaves. One launch copies every segment; the head bytes, body units
// and first block of each are worked out here. Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a table it cannot take).
extern "C" int ring_insert(const long long* table, int count, void* stream) {
  if (count < 1 || count > kMaxSegments) return (int)cudaErrorInvalidValue;
  InsertTable t;
  t.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    Segment& g = t.seg[i];
    g.src = (const uint8_t*)table[3 * i];
    g.dst = (uint8_t*)table[3 * i + 1];
    g.nbytes = table[3 * i + 2];
    g.width = segment_width(g.src, g.dst);
    int w = g.width ? g.width : 4;
    long long head = (w - (long long)((uintptr_t)g.dst % w)) % w;
    g.head = (int)(head < g.nbytes ? head : g.nbytes);
    g.units = (g.nbytes - g.head) / w;
    g.first_block = (int)blocks;
    long long per_block = kSpan / w;
    long long n = (g.units + per_block - 1) / per_block;
    blocks += n > 0 ? n : 1;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  insert_segments<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// table: count rows of (storage, out_offset, row_bytes), row_bytes > 0
// and kTileRows times their sum below 2^31, count <= kMaxLeaves; idx
// (rows,) int32; every leaf has cap rows. Output row r of leaf l is at
// out + out_offset_l + r * row_bytes_l.
extern "C" int ring_gather(const long long* table, int count, void* out,
                           const void* idx, long long cap, long long rows,
                           void* stream) {
  if (count < 1 || count > kMaxLeaves || rows < 1)
    return (int)cudaErrorInvalidValue;
  GatherTable t;
  t.count = count;
  t.cap = cap;
  t.rows = rows;
  for (int i = 0; i < count; ++i) {
    GatherLeaf& f = t.leaf[i];
    f.storage = (const uint8_t*)table[3 * i];
    f.out = (uint8_t*)out + table[3 * i + 1];
    f.row_bytes = (int)table[3 * i + 2];
    f.width = chunk_width(f.storage, f.out, f.row_bytes);
    f.chunks = f.row_bytes / f.width;
  }
  long long blocks = (rows + kTileRows - 1) / kTileRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_rows<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      t, (const int32_t*)idx);
  return (int)cudaGetLastError();
}
