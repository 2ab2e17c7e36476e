// FlashAttention-2-style prefill forward in the model's own layout.
//
// Replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:89, pallas_call at
// :112). For each query row r of head h = kh * G + g (GQA: key/value head
// kh), over the key columns c it may see (c <= r when causal,
// r - c < window when windowed; rows and columns both counted from 0):
//
//   s_c = (q_r . k_c) * scale
//   o_r = sum_c softmax(s)_c v_c
//
// with the streaming softmax (running max m, denominator l and f32
// accumulator acc), and a row that sees no column gives 0, as the TPU
// kernel's l == 0 guard does. q (B, Sq, K, G, hd) and k/v (B, Skv, K, hd),
// float32 or bfloat16, are read in place by their batch and sequence
// strides (no transpose to (B, H, S, hd)); the output has q's layout and
// dtype. All math is float32; p stays float32 for the PV product.
//
// Design: one block per (b, h, 64-row query tile). Each query row is
// owned by hd / 32 adjacent threads, each holding 32 of its features of q
// and of acc in float32 registers (features part, part + hd/32, ...): at
// every hd that is 64 registers of state, no spills. Key/value tiles of 32
// rows are converted to float32 into shared memory by all threads
// (coalesced along hd). The tile is walked key by key with the streaming
// softmax: the row's threads add their partial dot products with a
// butterfly of shuffles (every thread gets the same sum), and acc is
// rescaled only when the running max grows. The TPU kernel takes one max
// per KV block instead; the two agree to rounding. Only the key range the
// tile's rows can see is walked ([q0 - window + 1, q0 + 64) for causal
// windowed attention): the fully masked tiles that the TPU kernel skips
// with pl.when are never loaded. Products are explicit fmaf. hd is 32, 64
// or 128 (a template parameter; the wrapper raises on others).
//
// Bound on an H100: a row does 4 * hd operations per key it sees, on K/V
// rows that all rows of a head share. At hymba's short prefill (S 144)
// that is 0.27 GFLOP against 4.4 MB, so bytes bound it; at a long one
// (S 4,224, window 2,048) 42 GFLOP against 32 MB, so operations do, at
// the bf16 tensor-core rate. This kernel runs the products on the CUDA
// cores in float32; the tensor cores (wgmma, TMA, warp specialisation)
// are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;
constexpr int kKeys = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kRows * (HD / 32)) flash_attention_kernel(
    int Sq, int Skv, int G, int causal, int window, float scale,
    const T* __restrict__ q, long long q_sb, long long q_ss,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_sb,
    long long kv_ss, T* __restrict__ o, long long o_sb, long long o_ss) {
  constexpr int kSplit = HD / 32;  // threads per query row
  constexpr int kThreads = kRows * kSplit;
  __shared__ float k_s[kKeys][HD];
  __shared__ float v_s[kKeys][HD];
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const int row = q0 + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;  // features part + kSplit * i
  const bool live = row < Sq;

  float qr[32], acc[32];
  const T* qp = q + b * q_sb + (long long)row * q_ss + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    qr[i] = live ? to_f32(qp[part + kSplit * i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  // the columns any row of this tile can see
  int lo = 0, hi = Skv;
  if (causal) hi = min(Skv, q0 + kRows);
  if (window) lo = max(0, q0 - window + 1);
  const T* kb = k + b * kv_sb + (long long)kh * HD;
  const T* vb = v + b * kv_sb + (long long)kh * HD;

  for (int c0 = lo; c0 < hi; c0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, col = c0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (col < hi) {
        kv = to_f32(kb[(long long)col * kv_ss + d]);
        vv = to_f32(vb[(long long)col * kv_ss + d]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    __syncthreads();
    const int keys = min(kKeys, hi - c0);
    for (int j = 0; j < keys; ++j) {
      // every thread takes part in the shuffles; the mask comes after
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dot = fmaf(qr[i], k_s[j][part + kSplit * i], dot);
#pragma unroll
      for (int off = kSplit / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int col = c0 + j;
      bool seen = live;
      if (causal) seen = seen && col <= row;
      if (window) seen = seen && row - col < window;
      if (!seen) continue;
      const float s = dot * scale;
      if (s > m) {  // a new running max: rescale what is summed so far
        const float alpha = (m == -INFINITY) ? 0.0f : expf(m - s);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha;
        l *= alpha;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = fmaf(p, v_s[j][part + kSplit * i], acc[i]);
    }
  }
  if (!live) return;
  const float denom = (l == 0.0f) ? 1.0f : l;
  T* op = o + b * o_sb + (long long)row * o_ss + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < 32; ++i) store(op + part + kSplit * i, acc[i] / denom);
}

template <typename T, int HD>
int launch(int B, int H, int Sq, int Skv, int G, int causal, int window,
           float scale, const void* q, long long q_sb, long long q_ss,
           const void* k, const void* v, long long kv_sb, long long kv_ss,
           void* o, long long o_sb, long long o_ss, cudaStream_t stream) {
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_attention_kernel<T, HD><<<grid, kRows * (HD / 32), 0, stream>>>(
      Sq, Skv, G, causal, window, scale, (const T*)q, q_sb, q_ss,
      (const T*)k, (const T*)v, kv_sb, kv_ss, (T*)o, o_sb, o_ss);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, int B, int H, int Sq, int Skv, int G, int causal,
                int window, float scale, const void* q, long long q_sb,
                long long q_ss, const void* k, const void* v,
                long long kv_sb, long long kv_ss, void* o, long long o_sb,
                long long o_ss, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(B, H, Sq, Skv, G, causal, window, scale, q, q_sb,
                           q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss, stream);
    case 64:
      return launch<T, 64>(B, H, Sq, Skv, G, causal, window, scale, q, q_sb,
                           q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss, stream);
    case 128:
      return launch<T, 128>(B, H, Sq, Skv, G, causal, window, scale, q, q_sb,
                            q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements.
extern "C" int flash_attention(int dtype, int hd, int B, int H, int Sq,
                               int Skv, int G, int causal, int window,
                               float scale, const void* q, long long q_sb,
                               long long q_ss, const void* k, const void* v,
                               long long kv_sb, long long kv_ss, void* o,
                               long long o_sb, long long o_ss, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, B, H, Sq, Skv, G, causal, window, scale, q,
                              q_sb, q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss,
                              s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, B, H, Sq, Skv, G, causal, window,
                                      scale, q, q_sb, q_ss, k, v, kv_sb,
                                      kv_ss, o, o_sb, o_ss, s);
  return (int)cudaErrorInvalidValue;
}
