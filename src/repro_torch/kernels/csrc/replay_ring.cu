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
// ring_insert: batch row j goes to slot (start + j) % cap, with start a
// 0-dim int32 in device memory that the kernel reads itself, so the head of
// a ring kept on the device (a CUDA graph captures the pointer, not the
// value) needs no host read. When N > cap the last write to a slot wins, so
// only rows j >= N - cap are copied: per leaf one contiguous source span of
// count = min(N, cap) rows, which lands from slot head = (start + N - count)
// % cap on. The wrapper gives each leaf's span (src, dst, nbytes,
// row_bytes) and the blocks follow from those shapes alone: each block
// copies a fixed span of one leaf's source bytes (kSpan bytes, 16 KB: about
// 180 blocks at the main path's insert, every SM streaming), found from a
// prefix table of block starts. The wrap is worked out on the card: the
// span's first split = min(count, cap - head) rows go to slot head on, the
// rest to slot 0 on. A block loads its bytes in 16-byte units aligned on
// the source before it reads the head, so the two reads overlap; where
// both destinations keep that alignment (most of the main path's leaves)
// it stores those units and peels the edges. Else it copies one or (the
// block the split falls in) two byte ranges again, from L1 now: a range's
// body moves in the widest unit w of 16, 8 or 4 bytes for which source
// and destination agree mod w, kUnroll loads in flight per thread before
// the stores, consecutive threads on consecutive units; the unaligned
// head and tail bytes are peeled. Where the two differ mod 4 the body is
// still written in aligned 4-byte words, each put together from the two
// aligned source words it straddles with a funnel shift. No unit has to
// divide a row.
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
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kSpan = (long long)kThreads * kUnroll * 16;
constexpr int kTileRows = 8;
constexpr int kGatherThreads = 128;

struct Span {
  const uint8_t* src;   // the leaf's copied rows
  uint8_t* dst;         // the leaf's storage, slot 0
  long long nbytes;     // count * row_bytes
  long long row_bytes;
  int first_block;      // the span's blocks are [first_block, next's)
};

struct InsertTable {
  Span span[kMaxLeaves];
  int count;
  long long first;      // batch rows before the copied ones: max(0, N - cap)
  long long cap;
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
// of the range, so it lies in the same allocation's pages.
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

// Bytes [0, n) of s to d, n <= kSpan, by the whole block: the body in the
// widest unit for which s and d agree mod it, the head bytes before d's
// first aligned unit and the tail after its last peeled (fewer than 16
// each).
__device__ void copy_range(uint8_t* __restrict__ d,
                           const uint8_t* __restrict__ s, long long n) {
  uintptr_t diff = (uintptr_t)s ^ (uintptr_t)d;
  int width = diff % 16 == 0 ? 16 : diff % 8 == 0 ? 8 : diff % 4 == 0 ? 4 : 0;
  int w = width ? width : 4;
  long long head = (w - (long long)((uintptr_t)d % w)) % w;
  if (head > n) head = n;
  long long units = (n - head) / w;
  const uint8_t* sb = s + head;
  uint8_t* db = d + head;
  switch (width) {
    case 16: copy_units((uint4*)db, (const uint4*)sb, 0, units); break;
    case 8: copy_units((uint2*)db, (const uint2*)sb, 0, units); break;
    case 4: copy_units((uint32_t*)db, (const uint32_t*)sb, 0, units); break;
    default: {
      int shift = (int)((uintptr_t)sb % 4);
      copy_shifted((uint32_t*)db, (const uint32_t*)(sb - shift), shift, 0,
                   units);
    }
  }
  int t = threadIdx.x;
  long long tail = head + units * w;
  if (t < head) d[t] = s[t];
  if (t >= 16 && t - 16 < n - tail) d[tail + t - 16] = s[tail + t - 16];
}

// The widest unit that divides the row and keeps both bases aligned.
int unit_width(const void* a, const void* b, long long row_bytes) {
  for (int w = 16; w > 1; w /= 2) {
    if (row_bytes % w == 0 && (uintptr_t)a % w == 0 && (uintptr_t)b % w == 0)
      return w;
  }
  return 1;
}

__global__ void __launch_bounds__(kThreads)
insert_rows(const __grid_constant__ InsertTable table,
            const int* __restrict__ start) {
  int s = 0;
  while (s + 1 < table.count &&
         (int)blockIdx.x >= table.span[s + 1].first_block)
    ++s;
  const Span& g = table.span[s];
  long long o0 = (long long)(blockIdx.x - g.first_block) * kSpan;
  long long o1 = o0 + kSpan < g.nbytes ? o0 + kSpan : g.nbytes;
  // The block's bytes in 16-byte units aligned on the source, loaded
  // before the head is known, so the head's read and the source's overlap.
  const uint8_t* s0 = g.src + o0;
  long long lead = (16 - (long long)((uintptr_t)s0 % 16)) % 16;
  if (lead > o1 - o0) lead = o1 - o0;
  long long units = (o1 - o0 - lead) / 16;
  const uint4* su = (const uint4*)(s0 + lead);
  uint4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    int i = threadIdx.x + k * kThreads;
    if (i < units) v[k] = su[i];
  }
  long long head = ((long long)*start + table.first) % table.cap;
  if (head < 0) head += table.cap;
  // the span's bytes before the wrap go to slot head on, the rest to slot 0
  long long split = (table.cap - head) * g.row_bytes;
  if (split > g.nbytes) split = g.nbytes;
  uint8_t* da = g.dst + head * g.row_bytes;  // byte o < split: da + o
  uintptr_t src = (uintptr_t)g.src;
  // Where both destinations keep the source's alignment mod 16 and the
  // wrap falls on a unit's edge (slot 0 aligned), the loaded units are
  // the destination's: store them and peel the edges. Else copy each part
  // as copy_range does.
  if (((uintptr_t)da - src) % 16 == 0 && (uintptr_t)g.dst % 16 == 0 &&
      ((uintptr_t)g.dst - (uintptr_t)split - src) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int i = threadIdx.x + k * kThreads;
      long long o = o0 + lead + 16LL * i;
      if (i < units)
        *(uint4*)(o < split ? da + o : g.dst + (o - split)) = v[k];
    }
    int t = threadIdx.x;
    long long o = -1;
    if (t < lead) o = o0 + t;
    long long tail = o0 + lead + 16 * units;
    if (t >= 16 && t - 16 < o1 - tail) o = tail + t - 16;
    if (o >= 0) (o < split ? da + o : g.dst + (o - split))[0] = g.src[o];
    return;
  }
  if (o0 < split)
    copy_range(da + o0, g.src + o0, (o1 < split ? o1 : split) - o0);
  if (o1 > split) {
    long long a = o0 > split ? o0 : split;
    copy_range(g.dst + (a - split), g.src + a, o1 - a);
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

}  // namespace

// table: count rows of (src, dst, nbytes, row_bytes), one per leaf,
// nbytes a positive multiple of row_bytes and at most cap * row_bytes,
// count <= kMaxLeaves; start: a 0-dim int32 in device memory; first: the
// batch rows before the copied ones. One launch copies every leaf; each
// leaf's first block is worked out here, from the shapes alone. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a table it cannot
// take).
extern "C" int ring_insert(const long long* table, int count,
                           const void* start, long long first, long long cap,
                           void* stream) {
  if (count < 1 || count > kMaxLeaves || cap < 1 || first < 0)
    return (int)cudaErrorInvalidValue;
  InsertTable t;
  t.count = count;
  t.first = first;
  t.cap = cap;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    Span& g = t.span[i];
    g.src = (const uint8_t*)table[4 * i];
    g.dst = (uint8_t*)table[4 * i + 1];
    g.nbytes = table[4 * i + 2];
    g.row_bytes = table[4 * i + 3];
    if (g.row_bytes < 1 || g.nbytes < 1 || g.nbytes % g.row_bytes ||
        g.nbytes > cap * g.row_bytes)
      return (int)cudaErrorInvalidValue;
    g.first_block = (int)blocks;
    blocks += (g.nbytes + kSpan - 1) / kSpan;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  insert_rows<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, (const int*)start);
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
    f.width = unit_width(f.storage, f.out, f.row_bytes);
    f.chunks = f.row_bytes / f.width;
  }
  long long blocks = (rows + kTileRows - 1) / kTileRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_rows<<<(unsigned)blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      t, (const int32_t*)idx);
  return (int)cudaGetLastError();
}
