// Decode attention: one query row per (batch, head) against a KV cache.
//
// Replaces the TPU kernel decode_attention
// (src/repro/kernels/decode_attention/decode_attention.py:61, pallas_call
// at :77). For batch row b and head h = kh * G + g, over the cache slots s
// whose valid[s] is set (one validity vector shared by the batch):
//
//   s_s = (q . k_s) * scale,   o = sum_s softmax(s)_s v_s
//
// with no valid slot giving 0, as the TPU kernel's l == 0 guard does.
// q (B, K, G, hd) and the caches (B, Sc, K, hd), float32 or bfloat16, are
// read in place by their strides: the model's (B, Sc, K, hd) ring is never
// transposed or copied. Output (B, K, G, hd) in q's dtype; math in float32.
//
// Design: one block of 128 threads per (b, h). Phase 1: each warp takes
// every 4th slot, its lanes read the slot's key row (coalesced along hd)
// against q held in registers, and a shuffle tree sums the dot product;
// the scores go to shared memory (Sc floats). Phase 2: a block max over
// the scores, then p = exp(s - max) written back and a block sum l.
// Phase 3: thread t owns feature t % hd of the slots s = t / hd (mod
// 128 / hd), so each step of the PV sum reads a value row coalesced; the
// partial sums are added across the groups in shared memory. hd is a
// template parameter (32, 64 or 128; the wrapper raises on others).
//
// Bound on an H100: bytes. Each valid slot's key and value rows are read
// once per query head (G times per KV head; the G heads of one kv head
// run in different blocks and share them through L2) for 4 * hd
// operations, well below the card's operations-per-byte balance. With one
// block per (b, h) hymba's decode at B = 4 runs 100 blocks on 132 SMs;
// splitting the cache across blocks (split-KV) is a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    int Sc, int H, int G, float scale, const T* __restrict__ q,
    long long q_sb, const T* __restrict__ kc, const T* __restrict__ vc,
    long long c_sb, long long c_ss, const uint8_t* __restrict__ valid,
    T* __restrict__ o) {
  constexpr int kPerLane = HD / 32;
  constexpr int kGroups = kThreads / HD;
  extern __shared__ float scores[];  // Sc
  __shared__ float red[kWarps];
  __shared__ float part[kGroups][HD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = kc + b * c_sb + (long long)kh * HD;
  const T* vb = vc + b * c_sb + (long long)kh * HD;

  // phase 1: scores
  float qv[kPerLane];
  const T* qp = q + b * q_sb + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) qv[i] = to_f32(qp[lane + 32 * i]);
  float local_max = -INFINITY;
  for (int s = warp; s < Sc; s += kWarps) {
    float dot = 0.0f;
    if (valid[s]) {
      const T* kp = kb + (long long)s * c_ss;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        dot = fmaf(qv[i], to_f32(kp[lane + 32 * i]), dot);
      dot = warp_sum(dot) * scale;
    }
    const float sc = valid[s] ? dot : -INFINITY;
    if (lane == 0) scores[s] = sc;
    local_max = fmaxf(local_max, sc);
  }
  if (lane == 0) red[warp] = local_max;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused below

  // phase 2: probabilities and their sum
  float local_sum = 0.0f;
  for (int s = threadIdx.x; s < Sc; s += kThreads) {
    const float sc = scores[s];
    const float p = (sc == -INFINITY) ? 0.0f : expf(sc - m);
    scores[s] = p;
    local_sum += p;
  }
  local_sum = warp_sum(local_sum);
  if (lane == 0) red[warp] = local_sum;
  __syncthreads();
  float l = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += red[w];

  // phase 3: PV, one feature per thread, slots split across kGroups
  const int d = threadIdx.x % HD, grp = threadIdx.x / HD;
  float acc = 0.0f;
  for (int s = grp; s < Sc; s += kGroups) {
    const float p = scores[s];
    if (p != 0.0f) acc = fmaf(p, to_f32(vb[(long long)s * c_ss + d]), acc);
  }
  part[grp][d] = acc;
  __syncthreads();
  if (threadIdx.x < HD) {
    float total = part[0][d];
#pragma unroll
    for (int g2 = 1; g2 < kGroups; ++g2) total += part[g2][d];
    const float denom = (l == 0.0f) ? 1.0f : l;
    store(o + (long long)bh * HD + d, total / denom);
  }
}

template <typename T, int HD>
int launch(int B, int H, int Sc, int G, float scale, const void* q,
           long long q_sb, const void* kc, const void* vc, long long c_sb,
           long long c_ss, const void* valid, void* o, cudaStream_t stream) {
  const size_t smem = (size_t)Sc * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, HD><<<B * H, kThreads, smem, stream>>>(
      Sc, H, G, scale, (const T*)q, q_sb, (const T*)kc, (const T*)vc, c_sb,
      c_ss, (const uint8_t*)valid, (T*)o);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, int B, int H, int Sc, int G, float scale,
                const void* q, long long q_sb, const void* kc, const void* vc,
                long long c_sb, long long c_ss, const void* valid, void* o,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(B, H, Sc, G, scale, q, q_sb, kc, vc, c_sb, c_ss,
                           valid, o, stream);
    case 64:
      return launch<T, 64>(B, H, Sc, G, scale, q, q_sb, kc, vc, c_sb, c_ss,
                           valid, o, stream);
    case 128:
      return launch<T, 128>(B, H, Sc, G, scale, q, q_sb, kc, vc, c_sb, c_ss,
                            valid, o, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements; the output is
// contiguous (B, H, hd).
extern "C" int decode_attention(int dtype, int hd, int B, int H, int Sc,
                                int G, float scale, const void* q,
                                long long q_sb, const void* kc,
                                const void* vc, long long c_sb,
                                long long c_ss, const void* valid, void* o,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, B, H, Sc, G, scale, q, q_sb, kc, vc, c_sb,
                              c_ss, valid, o, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, B, H, Sc, G, scale, q, q_sb, kc,
                                      vc, c_sb, c_ss, valid, o, s);
  return (int)cudaErrorInvalidValue;
}
