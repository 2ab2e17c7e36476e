// Generalised advantage estimation and discounted returns: reverse-time
// scans over (T, B).
//
// gae replaces the TPU kernel gae_pallas, discounted_returns replaces
// discounted_returns_pallas (src/repro/kernels/gae/gae_pallas.py). Both
// walk each column b from t = T-1 down to 0 with the carry in registers;
// gae's recurrence, with the carry (adv_{t+1}, v_{t+1}), is
//
//   nt    = 1 - done[t]
//   delta = r[t] + gamma * v_{t+1} * nt - v[t]
//   adv   = delta + (gamma * lam) * nt * adv_{t+1}
//   ret   = adv + v[t]
//
// in the expression order of the plain version (gamma * lam is folded on the
// host in double, as Python folds it), and the returns', with the carry
// R_{t+1} seeded by last_value[b],
//
//   nt  = 1 - done[t]
//   R_t = r[t] + (gamma * nt) * R_{t+1}
//
// The walk stays serial in t: the chunked (decay, increment) form would
// reassociate the sums and end the bit-for-bit equality. What the kernels
// take out of the walk is the memory. Both run one schedule (scan_chunks):
// a block of 32 columns stages 64-step chunks in two shared-memory buffers,
// loaded by eight warps with every load of a chunk issued before any is
// used (float4 and uchar4 loads where B is a multiple of 4 and the pointers
// are aligned, scalar loads otherwise), and the loaders precompute there the
// terms that do not depend on the carry, so that one warp walks a chunk at
// one multiply and one add a step, x = a + g * x, while the others load the
// next. Ragged T and B need no padding. dones are read as stored (bool, one
// byte).
//
// Bound on an H100: HBM bytes. gae moves 17 per (t, b) element (r, v:
// 4 + 4; done: 1; adv, ret: 4 + 4) against 7 float operations;
// discounted_returns 9 (r: 4, done: 1, R: 4) against 4. Both are far below
// the card's operations-per-byte balance; their time is the walk's chain of
// T dependent steps. Built with -fmad=false, so with only + - * each kernel
// equals its plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The schedule both scans share (scan_chunks): a block owns kCols columns;
// its first warp (the walker) walks them, one lane per column, and the
// other warps (the loaders) feed it. Time goes in chunks of kChunk steps,
// the latest first, through two shared-memory buffers. While the walker
// walks one chunk, the loaders issue every load of the next, write out the
// chunk walked before, and then put the next chunk's terms that do not
// depend on the carry into the other buffer. The walk (walk) is then
// x = a + g * x a step, in the plain version's order, and it leaves x in
// place of a for the loaders to write out as rows of consecutive floats.
//
// gae stages a = delta = r + gamma * v_next * nt - v and g = gamma_lam * nt
// (and v, for ret = adv + v); the returns stage a = r and g = gamma * nt.
constexpr int kCols = 32;
constexpr int kChunk = 64;
constexpr int kLoaders = 256;
constexpr int kScanThreads = 32 + kLoaders;
constexpr int kWalkStep = 16;             // rows the walker reads at once
// scalar loads (any B): a loader takes one column and every 8th row
constexpr int kLoaderRows = kLoaders / kCols;                // 8
constexpr int kRowsEach = kChunk / kLoaderRows;              // 8
// vector loads (B a multiple of 4, aligned pointers): a loader takes 4
// consecutive columns (a float4; a uchar4 of done) of every 32nd row, so a
// warp load moves 4 rows at once
constexpr int kVecRows = kLoaders / (kCols / 4);             // 32
constexpr int kVecEach = kChunk / kVecRows;                  // 2

typedef float Tile[kChunk][kCols];

struct GaeStage {
  Tile delta;                             // delta, then the walk's adv
  Tile gl;                                // gamma_lam * nt
  Tile v;
};                                        // 24 KB; two fill the static 48
struct GaeScalar {
  float r[kRowsEach], v[kRowsEach], v_next[kRowsEach];
  bool done[kRowsEach];
};
struct GaeVector {
  float4 r[kVecEach], v[kVecEach], v_next[kVecEach];
  uint32_t done[kVecEach];
};

struct ReturnsStage {
  Tile r;                                 // r, then the walk's R
  Tile g;                                 // gamma * nt
};                                        // 16 KB
struct ReturnsScalar {
  float r[kRowsEach];
  bool done[kRowsEach];
};
struct ReturnsVector {
  float4 r[kVecEach];
  uint32_t done[kVecEach];
};

// the loader ``tid``'s row for its m-th load, and its (first) column
template <bool kVec>
__device__ __forceinline__ int row_of(int tid, int m) {
  return kVec ? kVecRows * m + tid / 8 : tid / kCols + kLoaderRows * m;
}
template <bool kVec>
__device__ __forceinline__ int col_of(int tid) {
  return kVec ? 4 * (tid % 8) : tid % kCols;
}
// a loader's loads (rows) per chunk
template <bool kVec>
constexpr int kLoadsEach = kVec ? kVecEach : kRowsEach;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float not_done(bool done) {
  return 1.0f - (done ? 1.0f : 0.0f);
}

// x = a[row] + g[row] * x from the chunk's last row up, x left in a[row]
__device__ __forceinline__ float walk(Tile& a, const Tile& g, int rows,
                                      int lane, float x) {
  int row = rows - 1;
  for (; row >= kWalkStep - 1; row -= kWalkStep) {
    float d[kWalkStep], f[kWalkStep];
#pragma unroll
    for (int m = 0; m < kWalkStep; ++m) {
      d[m] = a[row - m][lane];
      f[m] = g[row - m][lane];
    }
#pragma unroll
    for (int m = 0; m < kWalkStep; ++m) {
      x = d[m] + f[m] * x;
      a[row - m][lane] = x;
    }
  }
  for (; row >= 0; --row) {
    x = a[row][lane] + g[row][lane] * x;
    a[row][lane] = x;
  }
  return x;
}

// The chunk schedule over T steps. load(lo, rows) issues a chunk's loads
// into the loader's registers, fill(stage, rows) puts their terms into a
// buffer, write(stage, lo, rows) writes a walked chunk out, walk(stage,
// rows) walks one; chunk c covers rows [lo(c), lo(c) + rows(c)).
template <class Stage, class Load, class Fill, class Write, class Walk>
__device__ __forceinline__ void scan_chunks(Stage (&stage)[2], int T,
                                            Load load, Fill fill,
                                            Write write, Walk walk_chunk) {
  const bool walker = threadIdx.x < 32;
  const int chunks = (T + kChunk - 1) / kChunk;
  auto lo_of = [&](int c) { return max(T - (c + 1) * kChunk, 0); };
  auto rows_of = [&](int c) { return T - c * kChunk - lo_of(c); };
  if (!walker) {
    load(lo_of(0), rows_of(0));
    fill(stage[0], rows_of(0));
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (walker) {
      walk_chunk(stage[c & 1], rows_of(c));
    } else {
      Stage& other = stage[(c + 1) & 1];
      if (c + 1 < chunks) load(lo_of(c + 1), rows_of(c + 1));
      if (c > 0) write(other, lo_of(c - 1), rows_of(c - 1));
      if (c + 1 < chunks) fill(other, rows_of(c + 1));
    }
    __syncthreads();
  }
  if (!walker)
    write(stage[(chunks - 1) & 1], lo_of(chunks - 1), rows_of(chunks - 1));
}

// ------------------------------------------------------------------ gae
template <bool kVec, class X>
__device__ __forceinline__ void gae_load(X& x, int lo, int rows, int T, int B,
                                         int b0, int tid,
                                         const float* __restrict__ r,
                                         const float* __restrict__ v,
                                         const uint8_t* __restrict__ done,
                                         const float* __restrict__ last_value) {
  const int b = b0 + col_of<kVec>(tid);
#pragma unroll
  for (int m = 0; m < kLoadsEach<kVec>; ++m) {
    int row = row_of<kVec>(tid, m);
    if (row < rows && b < B) {
      size_t k = (size_t)(lo + row) * B + b;
      if constexpr (kVec) {
        x.r[m] = ld4(r + k);
        x.v[m] = ld4(v + k);
        x.done[m] = *reinterpret_cast<const uint32_t*>(done + k);
        x.v_next[m] = lo + row + 1 < T ? ld4(v + k + B) : ld4(last_value + b);
      } else {
        x.r[m] = r[k];
        x.v[m] = v[k];
        x.done[m] = done[k] != 0;
        x.v_next[m] = lo + row + 1 < T ? v[k + B] : last_value[b];
      }
    }
  }
}

__device__ __forceinline__ void gae_terms(GaeStage& s, int row, int col,
                                          float r, float v, float v_next,
                                          bool done, float gamma,
                                          float gamma_lam) {
  float nt = not_done(done);
  s.delta[row][col] = r + gamma * v_next * nt - v;
  s.gl[row][col] = gamma_lam * nt;
  s.v[row][col] = v;
}

template <bool kVec, class X>
__device__ __forceinline__ void gae_fill(GaeStage& s, const X& x, int rows,
                                         int B, int b0, int tid, float gamma,
                                         float gamma_lam) {
  const int col = col_of<kVec>(tid);
  if (b0 + col >= B) return;
#pragma unroll
  for (int m = 0; m < kLoadsEach<kVec>; ++m) {
    int row = row_of<kVec>(tid, m);
    if (row >= rows) continue;
    if constexpr (kVec) {
      const float* r = &x.r[m].x;
      const float* v = &x.v[m].x;
      const float* vn = &x.v_next[m].x;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gae_terms(s, row, col + e, r[e], v[e], vn[e],
                  (x.done[m] >> (8 * e)) & 0xffu, gamma, gamma_lam);
    } else {
      gae_terms(s, row, col, x.r[m], x.v[m], x.v_next[m], x.done[m], gamma,
                gamma_lam);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void gae_write(const GaeStage& s, int lo, int rows,
                                          int B, int b0, int tid,
                                          float* __restrict__ adv,
                                          float* __restrict__ ret) {
  const int col = col_of<kVec>(tid), b = b0 + col;
  if (b >= B) return;
#pragma unroll
  for (int m = 0; m < kLoadsEach<kVec>; ++m) {
    int row = row_of<kVec>(tid, m);
    if (row >= rows) continue;
    size_t k = (size_t)(lo + row) * B + b;
    if constexpr (kVec) {
      float4 a = *reinterpret_cast<const float4*>(&s.delta[row][col]);
      float4 vt = *reinterpret_cast<const float4*>(&s.v[row][col]);
      *reinterpret_cast<float4*>(adv + k) = a;
      *reinterpret_cast<float4*>(ret + k) =
          make_float4(a.x + vt.x, a.y + vt.y, a.z + vt.z, a.w + vt.w);
    } else {
      float a = s.delta[row][col];
      adv[k] = a;
      ret[k] = a + s.v[row][col];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kScanThreads) gae_kernel(
    int T, int B, const float* __restrict__ r, const float* __restrict__ v,
    const uint8_t* __restrict__ done, const float* __restrict__ last_value,
    float* __restrict__ adv, float* __restrict__ ret, float gamma,
    float gamma_lam) {
  __shared__ __align__(16) GaeStage stage[2];
  const int b0 = blockIdx.x * kCols;
  const int tid = threadIdx.x - 32;       // a loader's index
  typename std::conditional<kVec, GaeVector, GaeScalar>::type x;
  float adv_next = 0.0f;
  scan_chunks(
      stage, T,
      [&](int lo, int rows) {
        gae_load<kVec>(x, lo, rows, T, B, b0, tid, r, v, done, last_value);
      },
      [&](GaeStage& s, int rows) {
        gae_fill<kVec>(s, x, rows, B, b0, tid, gamma, gamma_lam);
      },
      [&](const GaeStage& s, int lo, int rows) {
        gae_write<kVec>(s, lo, rows, B, b0, tid, adv, ret);
      },
      [&](GaeStage& s, int rows) {
        adv_next = walk(s.delta, s.gl, rows, threadIdx.x, adv_next);
      });
}

// ---------------------------------------------------- discounted returns
template <bool kVec, class X>
__device__ __forceinline__ void returns_load(X& x, int lo, int rows, int B,
                                             int b0, int tid,
                                             const float* __restrict__ r,
                                             const uint8_t* __restrict__ done) {
  const int b = b0 + col_of<kVec>(tid);
#pragma unroll
  for (int m = 0; m < kLoadsEach<kVec>; ++m) {
    int row = row_of<kVec>(tid, m);
    if (row < rows && b < B) {
      size_t k = (size_t)(lo + row) * B + b;
      if constexpr (kVec) {
        x.r[m] = ld4(r + k);
        x.done[m] = *reinterpret_cast<const uint32_t*>(done + k);
      } else {
        x.r[m] = r[k];
        x.done[m] = done[k] != 0;
      }
    }
  }
}

template <bool kVec, class X>
__device__ __forceinline__ void returns_fill(ReturnsStage& s, const X& x,
                                             int rows, int B, int b0,
                                             int tid, float gamma) {
  const int col = col_of<kVec>(tid);
  if (b0 + col >= B) return;
#pragma unroll
  for (int m = 0; m < kLoadsEach<kVec>; ++m) {
    int row = row_of<kVec>(tid, m);
    if (row >= rows) continue;
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(&s.r[row][col]) = x.r[m];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s.g[row][col + e] = gamma * not_done((x.done[m] >> (8 * e)) & 0xffu);
    } else {
      s.r[row][col] = x.r[m];
      s.g[row][col] = gamma * not_done(x.done[m]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void returns_write(const ReturnsStage& s, int lo,
                                              int rows, int B, int b0,
                                              int tid,
                                              float* __restrict__ ret) {
  const int col = col_of<kVec>(tid), b = b0 + col;
  if (b >= B) return;
#pragma unroll
  for (int m = 0; m < kLoadsEach<kVec>; ++m) {
    int row = row_of<kVec>(tid, m);
    if (row >= rows) continue;
    size_t k = (size_t)(lo + row) * B + b;
    if constexpr (kVec)
      *reinterpret_cast<float4*>(ret + k) =
          *reinterpret_cast<const float4*>(&s.r[row][col]);
    else
      ret[k] = s.r[row][col];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kScanThreads) discounted_returns_kernel(
    int T, int B, const float* __restrict__ r,
    const uint8_t* __restrict__ done, const float* __restrict__ last_value,
    float* __restrict__ ret, float gamma) {
  __shared__ __align__(16) ReturnsStage stage[2];
  const int b0 = blockIdx.x * kCols;
  const int tid = threadIdx.x - 32;       // a loader's index
  typename std::conditional<kVec, ReturnsVector, ReturnsScalar>::type x;
  // the walker's carry: lane b - b0 walks column b
  const int lane = threadIdx.x;
  float carry = lane < 32 && b0 + lane < B ? last_value[b0 + lane] : 0.0f;
  scan_chunks(
      stage, T,
      [&](int lo, int rows) {
        returns_load<kVec>(x, lo, rows, B, b0, tid, r, done);
      },
      [&](ReturnsStage& s, int rows) {
        returns_fill<kVec>(s, x, rows, B, b0, tid, gamma);
      },
      [&](const ReturnsStage& s, int lo, int rows) {
        returns_write<kVec>(s, lo, rows, B, b0, tid, ret);
      },
      [&](ReturnsStage& s, int rows) {
        carry = walk(s.r, s.g, rows, lane, carry);
      });
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

extern "C" int gae(int T, int B, const void* r, const void* v,
                   const void* done, const void* last_value, void* adv,
                   void* ret, float gamma, float gamma_lam, void* stream) {
  bool vec = B % 4 == 0 && aligned(r, 16) && aligned(v, 16) &&
             aligned(last_value, 16) && aligned(adv, 16) &&
             aligned(ret, 16) && aligned(done, 4);
  auto kernel = vec ? gae_kernel<true> : gae_kernel<false>;
  int blocks = (B + kCols - 1) / kCols;
  kernel<<<blocks, kScanThreads, 0, (cudaStream_t)stream>>>(
      T, B, (const float*)r, (const float*)v, (const uint8_t*)done,
      (const float*)last_value, (float*)adv, (float*)ret, gamma, gamma_lam);
  return (int)cudaGetLastError();
}

// the walker reads last_value one float a lane, so its alignment does not
// matter here
extern "C" int discounted_returns(int T, int B, const void* r,
                                  const void* done, const void* last_value,
                                  void* ret, float gamma, void* stream) {
  bool vec = B % 4 == 0 && aligned(r, 16) && aligned(ret, 16) &&
             aligned(done, 4);
  auto kernel = vec ? discounted_returns_kernel<true>
                    : discounted_returns_kernel<false>;
  int blocks = (B + kCols - 1) / kCols;
  kernel<<<blocks, kScanThreads, 0, (cudaStream_t)stream>>>(
      T, B, (const float*)r, (const uint8_t*)done, (const float*)last_value,
      (float*)ret, gamma);
  return (int)cudaGetLastError();
}
