// Mamba1 selective scan over (B, S, Di) channels with an N-wide state.
//
// Replaces the TPU kernel selective_scan
// (src/repro/kernels/selective_scan/selective_scan.py:55, pallas_call at :73).
// Per channel (b, d), state n and time step t:
//
//   abar = exp(dt[t] * A[d, n])
//   h[n] = abar * h[n] + (dt[t] * x[t]) * B[t, n]
//   y[t] = sum_n h[n] * C[t, n]
//
// starting from h0 and returning the last h. All float32.
//
// Bound on an H100: the bytes (dt, x and y, 12 per (b, t, d)) and, as
// large, the exps: one MUFU.EX2 per (b, t, d, n) at 16 per SM per clock,
// about 4.2e12/s. A walk that is not to wait on either has to keep the
// exps of many recurrences in flight and its loads off the critical path.
//
// Design:
// - State across lanes. kLanes = 4 lanes share a channel, each holding
//   kPerLane = 4 of its N <= 16 states (states n >= N hold 0 with A = 0 and
//   B = C = 0, so they add nothing). A block of 128 threads walks 32
//   channels. Each lane leaves its part of y[t] (its states' h * C) in
//   shared memory; after each tile the block adds a channel's kLanes parts
//   and writes whole rows of y, so no shuffle or scattered store sits in
//   the step. exp(dt * A) is ex2.approx of dt * (A * log2 e), with
//   A * log2 e folded once per thread, and the update is one FMA:
//   abar * h + dx * B.
// - Staged tiles. The block walks time in tiles of kSteps steps: dt and x
//   (kSteps x 32 channels) and B and C (kSteps x 16, zero-padded past N)
//   sit in shared memory, and the next tile's loads are issued into
//   registers before this tile's walk, so each step reads shared memory
//   only; a whole tile's steps are unrolled, so later steps' loads and
//   exps issue early. Ragged Di, S and N are masked by zero-filled loads.
// - Time in chunks of 128 steps where (b, d) alone cannot fill the card
//   (the wrapper picks the chunk length; chunk >= S is one walk, one
//   launch). Then, in the reference's (decay, increment) form
//   (src/repro/models/ssm.py:74):
//     1. chunk_kernel walks every chunk but the last from h = 0 and stores
//        its end state pb and its decay pa = exp(A * sum dt) (the product
//        of its abar) in the scratch;
//     2. carry_kernel folds h_in[c + 1] = pa[c] * h_in[c] + pb[c] from h0
//        over the chunks, writing h_in[c + 1] over pa[c];
//     3. scan_kernel re-walks each chunk from its h_in, writing y, and the
//        last chunk writes the final h.
//   The chunked form does the exps twice (and reads dt and x twice) for
//   all chunks but the last: it pays where one walk per channel would
//   leave most of the card idle (B 1 x Di 3,200 is 100 blocks on 132 SMs).
//   The walk is latency-bound, not bound by the exps: on an H100 at that
//   shape 128-step chunks (33) were the fastest measured, ahead of one walk
//   and of chunks of 256 to 1,056 steps.
// - Sums in another order than the plain version (FMAs, y's sum over n,
//   the carried chunk states) and ex2.approx: held by a tolerance, not bit
//   for bit; this source builds without -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxState = 16;
constexpr int kLanes = 4;
constexpr int kPerLane = kMaxState / kLanes;
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kLanes;
constexpr int kSteps = 32;
constexpr int kXPerThread = kSteps * kChannels / kThreads;   // dt, x
constexpr int kBPerThread = kSteps * kMaxState / kThreads;   // B, C
constexpr int kYPerThread = kSteps * kChannels / kThreads;   // y sums
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A lane's kPerLane = 4 consecutive floats of a 16-float row in shared
// memory, in one vector load.
__device__ __forceinline__ void lane_row(const float* row,
                                         float (&o)[kPerLane]) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

struct Inputs {
  const float* dt;
  const float* A;
  const float* b;
  const float* c;
  const float* x;
  int S, Di, N;
};

// One thread's share of a tile, in registers between its load and its
// store to shared memory.
template <bool kC>
struct Staged {
  float dt[kXPerThread], x[kXPerThread], b[kBPerThread],
      c[kC ? kBPerThread : 1];

  __device__ void load(const Inputs& in, int bi, int d0, int t0, int t1) {
#pragma unroll
    for (int k = 0; k < kXPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int t = t0 + i / kChannels, d = d0 + i % kChannels;
      const bool on = t < t1 && d < in.Di;
      const size_t g = ((size_t)bi * in.S + t) * in.Di + d;
      dt[k] = on ? in.dt[g] : 0.0f;
      x[k] = on ? in.x[g] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int t = t0 + i / kMaxState, n = i % kMaxState;
      const bool on = t < t1 && n < in.N;
      const size_t g = ((size_t)bi * in.S + t) * in.N + n;
      b[k] = on ? in.b[g] : 0.0f;
      if (kC) c[k] = on ? in.c[g] : 0.0f;
    }
  }

  __device__ void store(float* s_dt, float* s_x, float* s_b,
                        float* s_c) const {
#pragma unroll
    for (int k = 0; k < kXPerThread; ++k) {
      s_dt[threadIdx.x + k * kThreads] = dt[k];
      s_x[threadIdx.x + k * kThreads] = x[k];
    }
#pragma unroll
    for (int k = 0; k < kBPerThread; ++k) {
      s_b[threadIdx.x + k * kThreads] = b[k];
      if (kC) s_c[threadIdx.x + k * kThreads] = c[k];
    }
  }
};

// Walk time steps [t0, t1) of the block's channels of batch row bi from h
// (this thread's kPerLane states). kY: write y (scan_kernel): each lane
// leaves its part of y[t] in shared memory, and after the tile the block
// sums the kLanes parts of each (t, channel) and writes whole rows of y.
// Otherwise (chunk_kernel) sum dt. Returns the sum of dt over the walk.
template <bool kY>
__device__ float walk(const Inputs& in, int bi, int d0, int t0, int t1,
                      const float (&a2)[kPerLane], float (&h)[kPerLane],
                      float* y) {
  __shared__ float s_dt[kSteps * kChannels], s_x[kSteps * kChannels];
  __shared__ __align__(16) float s_b[kSteps * kMaxState];
  __shared__ __align__(16) float s_c[kY ? kSteps * kMaxState : 4];
  __shared__ __align__(16) float s_y[kY ? kSteps * kThreads : 4];
  const int ch = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  float dsum = 0.0f;
  Staged<kY> next;
  if (t0 < t1) next.load(in, bi, d0, t0, t1);
  for (int t = t0; t < t1; t += kSteps) {
    __syncthreads();          // every thread is done with the last tile
    next.store(s_dt, s_x, s_b, s_c);
    __syncthreads();
    if (t + kSteps < t1) next.load(in, bi, d0, t + kSteps, t1);
    const int steps = min(kSteps, t1 - t);
    const auto step = [&](int s) {
      const float dtv = s_dt[s * kChannels + ch];
      const float dx = dtv * s_x[s * kChannels + ch];
      float bq[kPerLane];
      lane_row(s_b + s * kMaxState + sub * kPerLane, bq);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        h[q] = fmaf(ex2(dtv * a2[q]), h[q], dx * bq[q]);
      if (kY) {
        float cq[kPerLane];
        lane_row(s_c + s * kMaxState + sub * kPerLane, cq);
        float acc = h[0] * cq[0];
#pragma unroll
        for (int q = 1; q < kPerLane; ++q) acc = fmaf(h[q], cq[q], acc);
        s_y[s * kThreads + threadIdx.x] = acc;
      } else {
        dsum += dtv;
      }
    };
    if (steps == kSteps) {    // a whole tile: unrolled, so the exps and
#pragma unroll                // loads of later steps are issued early
      for (int s = 0; s < kSteps; ++s) step(s);
    } else {
#pragma unroll 4
      for (int s = 0; s < steps; ++s) step(s);
    }
    if (kY) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kYPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int s = i / kChannels, c = i % kChannels, d = d0 + c;
        const float* part = s_y + s * kThreads + c * kLanes;
        float sum = part[0];
#pragma unroll
        for (int l = 1; l < kLanes; ++l) sum += part[l];
        if (s < steps && d < in.Di)
          y[((size_t)bi * in.S + t + s) * in.Di + d] = sum;
      }
    }
  }
  return dsum;
}

// This thread's states' A * log2 e (0 past N and past Di) and the offset
// of its first state in a (., Di, N) array, or -1 past Di.
__device__ __forceinline__ long long lane_states(const Inputs& in, int d0,
                                                 float (&a2)[kPerLane]) {
  const int d = d0 + threadIdx.x / kLanes;
  const int n0 = (threadIdx.x % kLanes) * kPerLane;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const bool on = d < in.Di && n0 + q < in.N;
    a2[q] = on ? in.A[(size_t)d * in.N + n0 + q] * kLog2e : 0.0f;
  }
  return d < in.Di ? (long long)d * in.N + n0 : -1;
}

// Grid (ceil(Di / 32), chunks - 1, B): chunk c's end state from h = 0 and
// its decay, into pa and pb at ((b * (chunks - 1) + c) * Di + d) * N + n.
__global__ void __launch_bounds__(kThreads) chunk_kernel(
    Inputs in, int chunk, float* __restrict__ pa, float* __restrict__ pb) {
  const int bi = blockIdx.z, c = blockIdx.y, d0 = blockIdx.x * kChannels;
  float a2[kPerLane], h[kPerLane] = {};
  const long long off = lane_states(in, d0, a2);
  const int t0 = c * chunk;
  const float dsum = walk<false>(in, bi, d0, t0, min(t0 + chunk, in.S), a2,
                                 h, nullptr);
  if (off < 0) return;
  const size_t base = ((size_t)bi * gridDim.y + c) * in.Di * in.N + off;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    if ((threadIdx.x % kLanes) * kPerLane + q < in.N) {
      pa[base + q] = ex2(a2[q] * dsum);
      pb[base + q] = h[q];
    }
  }
}

// One thread per (b, d, n): h_in of chunks 1 .. chunks - 1, from h0,
// written over pa. Loads go kCarryBatch chunks at a time, off the FMA
// chain.
__global__ void __launch_bounds__(kCarryThreads) carry_kernel(
    long long states, int links, long long per_chunk,
    const float* __restrict__ h0, float* pa, const float* pb) {
  const long long e = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (e >= states) return;
  const long long bi = e / per_chunk;
  float* a = pa + (bi * links) * per_chunk + e % per_chunk;
  const float* b = pb + (bi * links) * per_chunk + e % per_chunk;
  float h = h0[e];
  for (int c0 = 0; c0 < links; c0 += kCarryBatch) {
    float av[kCarryBatch], bv[kCarryBatch];
#pragma unroll
    for (int k = 0; k < kCarryBatch; ++k) {
      if (c0 + k < links) {
        av[k] = a[(c0 + k) * per_chunk];
        bv[k] = b[(c0 + k) * per_chunk];
      }
    }
#pragma unroll
    for (int k = 0; k < kCarryBatch; ++k) {
      if (c0 + k < links) {
        h = fmaf(av[k], h, bv[k]);
        a[(c0 + k) * per_chunk] = h;
      }
    }
  }
}

// Grid (ceil(Di / 32), chunks, B): chunk c walked from h0 (c = 0) or its
// carried h_in (over pa), writing y; the last chunk writes h_out.
__global__ void __launch_bounds__(kThreads) scan_kernel(
    Inputs in, int chunk, const float* __restrict__ h0,
    const float* __restrict__ h_in, float* __restrict__ y,
    float* __restrict__ h_out) {
  const int bi = blockIdx.z, c = blockIdx.y, d0 = blockIdx.x * kChannels;
  float a2[kPerLane], h[kPerLane];
  const long long off = lane_states(in, d0, a2);
  const size_t plane = (size_t)in.Di * in.N;
  const float* from = c == 0
      ? h0 + bi * plane
      : h_in + ((size_t)bi * (gridDim.y - 1) + c - 1) * plane;
  const int n0 = (threadIdx.x % kLanes) * kPerLane;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    h[q] = off >= 0 && n0 + q < in.N ? from[off + q] : 0.0f;
  const int t0 = c * chunk;
  walk<true>(in, bi, d0, t0, min(t0 + chunk, in.S), a2, h, y);
  if (off < 0 || c + 1 != (int)gridDim.y) return;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    if (n0 + q < in.N) h_out[bi * plane + off + q] = h[q];
}

}  // namespace

// dt, x (B, S, Di), A (Di, N), b, c (B, S, N), h0 (B, Di, N) -> y (B, S,
// Di), h_out (B, Di, N); float32, contiguous, 1 <= N <= 16, B <= 65,535.
// Time in chunks of `chunk` steps; with more than one chunk, scratch holds
// 2 * B * (chunks - 1) * Di * N floats. One launch for one chunk, three
// otherwise.
extern "C" int selective_scan(int B, int S, int Di, int N, int chunk,
                              const void* dt, const void* A, const void* b,
                              const void* c, const void* x, const void* h0,
                              void* y, void* h_out, void* scratch,
                              void* stream) {
  if (N < 1 || N > kMaxState || chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Inputs in{(const float*)dt, (const float*)A, (const float*)b,
                  (const float*)c,  (const float*)x, S, Di, N};
  const int chunks = S > chunk ? (S + chunk - 1) / chunk : 1;
  const int dblocks = (Di + kChannels - 1) / kChannels;
  float* pa = (float*)scratch;
  if (chunks > 1) {
    const long long per_chunk = (long long)Di * N;
    float* pb = pa + (size_t)B * (chunks - 1) * per_chunk;
    chunk_kernel<<<dim3(dblocks, chunks - 1, B), kThreads, 0, st>>>(
        in, chunk, pa, pb);
    const long long states = (long long)B * per_chunk;
    carry_kernel<<<(unsigned)((states + kCarryThreads - 1) / kCarryThreads),
                   kCarryThreads, 0, st>>>(states, chunks - 1, per_chunk,
                                           (const float*)h0, pa, pb);
  }
  scan_kernel<<<dim3(dblocks, chunks, B), kThreads, 0, st>>>(
      in, chunk, (const float*)h0, pa, (float*)y, (float*)h_out);
  return (int)cudaGetLastError();
}
