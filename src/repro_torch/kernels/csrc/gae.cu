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
// host in double, as Python folds it). The walk stays serial in t: the
// chunked (decay, increment) form would reassociate the sums and end the
// bit-for-bit equality. What gae_kernel takes out of the walk is the memory:
// a block of 32 columns stages 64-step chunks in shared memory, loaded by
// eight warps with every load of a chunk issued before any is used (float4
// loads where B is a multiple of 4), and precomputes there the terms that
// do not depend on the carry, so that one warp walks a chunk at one
// multiply and one add a step while the others load the next. Ragged T and
// B need no padding. dones are read as stored (bool, one byte).
//
// discounted_returns walks with one thread per column and the one carry
// R_{t+1}, seeded by last_value[b], loading each step as it goes:
//
//   nt  = 1 - done[t]
//   R_t = r[t] + (gamma * nt) * R_{t+1}
//
// Bound on an H100: HBM bytes. gae moves 17 per (t, b) element (r, v:
// 4 + 4; done: 1; adv, ret: 4 + 4) against 7 float operations;
// discounted_returns 9 (r: 4, done: 1, R: 4) against 4. Both are far below
// the card's operations-per-byte balance. Built with -fmad=false, so with
// only + - * each kernel equals its plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// gae: a block owns kGaeCols columns; its first warp walks them, one lane
// per column, and the other warps (the loaders) feed it. Time goes in
// chunks of kGaeChunk steps, the latest first, through two shared-memory
// buffers. While the walker walks one chunk, the loaders issue every load of
// the next (r, v, done and the v one step later), write out the chunk
// walked before, and then put the next chunk's terms that do not depend on
// the carry into the other buffer: delta = r + gamma * v_next * nt - v and
// gamma_lam * nt, in the plain version's order. The walk itself is then one
// multiply and one add a step, a = delta + (gamma_lam * nt) * adv_next; it
// leaves a in place of delta, and the loaders write adv = a and ret = a + v
// as rows of consecutive floats.
constexpr int kGaeCols = 32;
constexpr int kGaeChunk = 64;
constexpr int kGaeLoaders = 256;
constexpr int kGaeThreads = 32 + kGaeLoaders;
constexpr int kGaeWalkStep = 16;          // rows the walker reads at once
// scalar loads (any B): a loader takes one column and every 8th row
constexpr int kGaeLoaderRows = kGaeLoaders / kGaeCols;       // 8
constexpr int kGaeRowsEach = kGaeChunk / kGaeLoaderRows;     // 8
// vector loads (B a multiple of 4, 16-byte aligned pointers): a loader
// takes 4 consecutive columns (a float4; a uchar4 of done) of every 32nd
// row, so a warp load moves 4 rows at once
constexpr int kGaeVecRows = kGaeLoaders / (kGaeCols / 4);    // 32
constexpr int kGaeVecEach = kGaeChunk / kGaeVecRows;         // 2

struct GaeStage {
  float delta[kGaeChunk][kGaeCols];       // delta, then the walk's adv
  float gl[kGaeChunk][kGaeCols];          // gamma_lam * nt
  float v[kGaeChunk][kGaeCols];
};                                        // 24 KB; two fill the static 48

struct GaeScalar {
  float r[kGaeRowsEach], v[kGaeRowsEach], v_next[kGaeRowsEach];
  bool done[kGaeRowsEach];
};
struct GaeVector {
  float4 r[kGaeVecEach], v[kGaeVecEach], v_next[kGaeVecEach];
  uint32_t done[kGaeVecEach];
};

// the loader ``tid``'s row for its m-th load, and its (first) column
template <bool kVec>
__device__ __forceinline__ int gae_row(int tid, int m) {
  return kVec ? kGaeVecRows * m + tid / 8 : tid / kGaeCols + kGaeLoaderRows * m;
}
template <bool kVec>
__device__ __forceinline__ int gae_col(int tid) {
  return kVec ? 4 * (tid % 8) : tid % kGaeCols;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kVec, class X>
__device__ __forceinline__ void gae_load(X& x, int lo, int rows, int T, int B,
                                         int b0, int tid,
                                         const float* __restrict__ r,
                                         const float* __restrict__ v,
                                         const uint8_t* __restrict__ done,
                                         const float* __restrict__ last_value) {
  const int b = b0 + gae_col<kVec>(tid);
  constexpr int n = kVec ? kGaeVecEach : kGaeRowsEach;
#pragma unroll
  for (int m = 0; m < n; ++m) {
    int row = gae_row<kVec>(tid, m);
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
  float nt = 1.0f - (done ? 1.0f : 0.0f);
  s.delta[row][col] = r + gamma * v_next * nt - v;
  s.gl[row][col] = gamma_lam * nt;
  s.v[row][col] = v;
}

template <bool kVec, class X>
__device__ __forceinline__ void gae_fill(GaeStage& s, const X& x, int rows,
                                         int B, int b0, int tid, float gamma,
                                         float gamma_lam) {
  const int col = gae_col<kVec>(tid);
  constexpr int n = kVec ? kGaeVecEach : kGaeRowsEach;
  if (b0 + col >= B) return;
#pragma unroll
  for (int m = 0; m < n; ++m) {
    int row = gae_row<kVec>(tid, m);
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
  const int col = gae_col<kVec>(tid), b = b0 + col;
  constexpr int n = kVec ? kGaeVecEach : kGaeRowsEach;
  if (b >= B) return;
#pragma unroll
  for (int m = 0; m < n; ++m) {
    int row = gae_row<kVec>(tid, m);
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

__device__ __forceinline__ float gae_walk(GaeStage& s, int rows, int lane,
                                          float adv_next) {
  int row = rows - 1;
  for (; row >= kGaeWalkStep - 1; row -= kGaeWalkStep) {
    float d[kGaeWalkStep], gl[kGaeWalkStep];
#pragma unroll
    for (int m = 0; m < kGaeWalkStep; ++m) {
      d[m] = s.delta[row - m][lane];
      gl[m] = s.gl[row - m][lane];
    }
#pragma unroll
    for (int m = 0; m < kGaeWalkStep; ++m) {
      adv_next = d[m] + gl[m] * adv_next;
      s.delta[row - m][lane] = adv_next;
    }
  }
  for (; row >= 0; --row) {
    adv_next = s.delta[row][lane] + s.gl[row][lane] * adv_next;
    s.delta[row][lane] = adv_next;
  }
  return adv_next;
}

template <bool kVec>
__global__ void __launch_bounds__(kGaeThreads) gae_kernel(
    int T, int B, const float* __restrict__ r, const float* __restrict__ v,
    const uint8_t* __restrict__ done, const float* __restrict__ last_value,
    float* __restrict__ adv, float* __restrict__ ret, float gamma,
    float gamma_lam) {
  __shared__ __align__(16) GaeStage stage[2];
  const int b0 = blockIdx.x * kGaeCols;
  const bool walker = threadIdx.x < 32;
  const int tid = threadIdx.x - 32;       // a loader's index
  const int chunks = (T + kGaeChunk - 1) / kGaeChunk;
  // chunk c covers rows [lo(c), hi(c)), hi(c) = T - c * kGaeChunk
  auto lo_of = [&](int c) { return max(T - (c + 1) * kGaeChunk, 0); };
  auto rows_of = [&](int c) { return T - c * kGaeChunk - lo_of(c); };
  float adv_next = 0.0f;
  typename std::conditional<kVec, GaeVector, GaeScalar>::type x;
  if (!walker) {
    gae_load<kVec>(x, lo_of(0), rows_of(0), T, B, b0, tid, r, v, done,
                   last_value);
    gae_fill<kVec>(stage[0], x, rows_of(0), B, b0, tid, gamma, gamma_lam);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (walker) {
      adv_next = gae_walk(stage[c & 1], rows_of(c), threadIdx.x, adv_next);
    } else {
      GaeStage& other = stage[(c + 1) & 1];
      if (c + 1 < chunks)
        gae_load<kVec>(x, lo_of(c + 1), rows_of(c + 1), T, B, b0, tid, r, v,
                       done, last_value);
      if (c > 0)
        gae_write<kVec>(other, lo_of(c - 1), rows_of(c - 1), B, b0, tid, adv,
                        ret);
      if (c + 1 < chunks)
        gae_fill<kVec>(other, x, rows_of(c + 1), B, b0, tid, gamma,
                       gamma_lam);
    }
    __syncthreads();
  }
  if (!walker)
    gae_write<kVec>(stage[(chunks - 1) & 1], lo_of(chunks - 1),
                    rows_of(chunks - 1), B, b0, tid, adv, ret);
}

__global__ void discounted_returns_kernel(int T, int B,
                                          const float* __restrict__ r,
                                          const uint8_t* __restrict__ done,
                                          const float* __restrict__ last_value,
                                          float* __restrict__ ret,
                                          float gamma) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float carry = last_value[b];
  for (int t = T - 1; t >= 0; --t) {
    size_t k = (size_t)t * B + b;
    float nt = 1.0f - (done[k] ? 1.0f : 0.0f);
    carry = r[k] + gamma * nt * carry;
    ret[k] = carry;
  }
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int gae(int T, int B, const void* r, const void* v,
                   const void* done, const void* last_value, void* adv,
                   void* ret, float gamma, float gamma_lam, void* stream) {
  auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  bool vec = B % 4 == 0 && aligned(r, 16) && aligned(v, 16) &&
             aligned(last_value, 16) && aligned(adv, 16) &&
             aligned(ret, 16) && aligned(done, 4);
  auto kernel = vec ? gae_kernel<true> : gae_kernel<false>;
  int blocks = (B + kGaeCols - 1) / kGaeCols;
  kernel<<<blocks, kGaeThreads, 0, (cudaStream_t)stream>>>(
      T, B, (const float*)r, (const float*)v, (const uint8_t*)done,
      (const float*)last_value, (float*)adv, (float*)ret, gamma, gamma_lam);
  return (int)cudaGetLastError();
}

extern "C" int discounted_returns(int T, int B, const void* r,
                                  const void* done, const void* last_value,
                                  void* ret, float gamma, void* stream) {
  int blocks = (B + kThreads - 1) / kThreads;
  discounted_returns_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      T, B, (const float*)r, (const uint8_t*)done, (const float*)last_value,
      (float*)ret, gamma);
  return (int)cudaGetLastError();
}
