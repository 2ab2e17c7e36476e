// Mamba1 selective scan over (B, S, Di) channels with an N-wide state.
//
// Replaces the TPU kernel selective_scan
// (src/repro/kernels/selective_scan/selective_scan.py:55, pallas_call at :73).
// Per channel (b, d) and time step t, in the plain version's order:
//
//   abar = exp(dt[t] * A[d, n])
//   h[n] = abar * h[n] + (dt[t] * x[t]) * B[t, n]
//   y[t] = sum_n h[n] * C[t, n]
//
// starting from h0 and returning the last h. All float32.
//
// Design: one thread per (b, d) channel holds h[N] and A[d, :] in registers
// (N <= 16; the wrapper raises above) and walks time. Consecutive threads
// are consecutive d, so each step's dt, x and y accesses are coalesced.
// B and C (B, S, N) are shared by all channels of a batch row: each block
// stages kChunk time steps of both in shared memory, one cooperative load
// per chunk. Ragged Di and S are masked (threads past Di load but do not
// compute); the TPU kernel's d_block and t_chunk multiples do not apply.
// expf, not __expf, and -fmad=false, so each step rounds as the plain
// version's expressions do; only the order of y's sum over n differs.
//
// Bound on an H100: bytes. The function moves about 12 bytes per
// (b, t, d) (dt, x, y) for about 7 float operations per (b, t, d, n): at
// N = 16 that is 9 operations per byte, below the card's float32 balance
// of 20. In practice the sequential walk is latency-bound: one thread per
// channel gives B * Di threads, 12,800 for hymba's prefill at B = 4
// (about 100 blocks of 128 on 132 SMs) and 3,200 at B = 1, each waiting
// on its step's loads S times. Splitting time across threads (a chunked
// scan) or prefetching the next step is a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxState = 16;
constexpr int kThreads = 128;
constexpr int kChunk = 64;

__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    int S, int Di, int N, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ x,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_out) {
  __shared__ float b_s[kChunk * kMaxState];
  __shared__ float c_s[kChunk * kMaxState];
  const int bi = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < Di;
  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    const bool on = live && n < N;
    a[n] = on ? A[(size_t)d * N + n] : 0.0f;
    h[n] = on ? h0[((size_t)bi * Di + d) * N + n] : 0.0f;
  }
  const float* brow = bmat + (size_t)bi * S * N;
  const float* crow = cmat + (size_t)bi * S * N;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      b_s[i] = brow[(size_t)t0 * N + i];
      c_s[i] = crow[(size_t)t0 * N + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const size_t k = ((size_t)bi * S + t0 + t) * Di + d;
      const float dtv = dt[k];
      const float dx = dtv * x[k];
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n) {
        if (n < N) {
          const float abar = expf(dtv * a[n]);
          h[n] = abar * h[n] + dx * b_s[t * N + n];
          acc = acc + h[n] * c_s[t * N + n];
        }
      }
      y[k] = acc;
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    if (n < N) h_out[((size_t)bi * Di + d) * N + n] = h[n];
  }
}

}  // namespace

extern "C" int selective_scan(int B, int S, int Di, int N, const void* dt,
                              const void* A, const void* b, const void* c,
                              const void* x, const void* h0, void* y,
                              void* h_out, void* stream) {
  if (N < 1 || N > kMaxState) return (int)cudaErrorInvalidValue;
  dim3 grid((Di + kThreads - 1) / kThreads, B);
  selective_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      S, Di, N, (const float*)dt, (const float*)A, (const float*)b,
      (const float*)c, (const float*)x, (const float*)h0, (float*)y,
      (float*)h_out);
  return (int)cudaGetLastError();
}
