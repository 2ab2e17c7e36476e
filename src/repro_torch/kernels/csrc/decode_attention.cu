// Decode attention: one query row per (batch, head) against a KV cache,
// split across the cache (split-KV) and combined in a second launch.
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
// read in place by their strides: the model's (B, Sc, K, hd) ring (one
// layer's slice of the (L, B, Sc, K, hd) cache) is never transposed or
// copied. Output (B, K, G, hd) in q's dtype; math in float32. Any Sc.
//
// Bound on an H100: bytes. Each valid slot's key and value rows must be
// read once for the G query heads of their kv head (4 * hd * G operations
// per slot, far below the card's operations-per-byte balance). At hymba's
// decode (B 4, 176 slots, 5 kv heads of 64) that is 0.9 MB; at the long
// request (B 1, 2,048 slots) 2.6 MB: under a microsecond at 3.35 TB/s, so
// the time is latency: how many loads are in flight, on how many SMs.
//
// Design. Split pass, grid (chunks, K, B), 128 threads: a block takes one
// kv head kh of batch row b and one chunk of slots (a multiple of 32,
// chosen by the wrapper so that B * K * chunks covers the SMs), and serves
// all G query heads of kh, so each valid K/V row is read from device
// memory once. The chunk is walked in sub-tiles of 32 slots, double
// buffered: 16-byte cp.async copies (8 bf16 or 4 f32) bring the next
// sub-tile's K and V rows into shared memory while the current one is
// computed; an invalid slot is not loaded (its row is zero-filled). Rows
// are padded by 16 bytes so that 8 lanes reading 16 bytes each from 8
// rows hit distinct banks. Each warp takes query heads g = warp, warp + 4,
// ...: lane j scores slot j against q (held in shared memory as float),
// and the warp updates the head's running max and sum (exp2, with
// scale * log2(e) folded in) with shuffles. Then all threads take
// (head, feature pair)s and add p * v over the sub-tile into the head's
// f32 accumulator, rescaled by the max's growth. The block writes
// (m, l, acc[hd]) per query head into scratch the wrapper allocates.
// Combine pass, grid (B * H), hd threads: merges the chunks of one (b, h)
// with the usual rescale; a chunk with no valid slot (m = -inf, l = 0)
// adds nothing, and a row with no valid slot at all gives 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;  // slots per sub-tile: one per lane

template <typename T, int HD>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kRowVecs = HD / kVec;   // 16-byte pieces per row
  static constexpr int kPitch = HD + kVec;     // padded row, in elements
  static constexpr int kStage = kSlots * kPitch;
};

// dynamic shared memory: K and V sub-tiles (2 stages each), then q, acc
// (G x hd floats each), p (G x 32), and m, l, alpha (G each)
template <typename T, int HD>
size_t smem_bytes(int G) {
  return 4 * Cfg<T, HD>::kStage * sizeof(T) +
         sizeof(float) * (size_t)G * (2 * HD + kSlots + 3);
}

__device__ __forceinline__ void to_f32(const float4& raw, float* out) {
  out[0] = raw.x;
  out[1] = raw.y;
  out[2] = raw.z;
  out[3] = raw.w;
}
__device__ __forceinline__ void to_f32x8(const uint4& raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes global -> shared; ``bytes`` 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q . k for one 16-byte piece of a key row against floats of q
template <typename T>
__device__ __forceinline__ float dot_piece(const T* k, const float* q);
template <>
__device__ __forceinline__ float dot_piece<float>(const float* k,
                                                  const float* q) {
  float kv[4], qv[4];
  to_f32(*reinterpret_cast<const float4*>(k), kv);
  to_f32(*reinterpret_cast<const float4*>(q), qv);
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) d = fmaf(qv[i], kv[i], d);
  return d;
}
template <>
__device__ __forceinline__ float dot_piece<__nv_bfloat16>(
    const __nv_bfloat16* k, const float* q) {
  float kv[8], qv[8];
  to_f32x8(*reinterpret_cast<const uint4*>(k), kv);
  to_f32(*reinterpret_cast<const float4*>(q), qv);
  to_f32(*reinterpret_cast<const float4*>(q + 4), qv + 4);
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) d = fmaf(qv[i], kv[i], d);
  return d;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_split(
    int Sc, int G, int chunk, float scale_log2, const T* __restrict__ q,
    long long q_sb, const T* __restrict__ kc, const T* __restrict__ vc,
    long long c_sb, long long c_ss, const uint8_t* __restrict__ valid,
    float* __restrict__ part) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + 2 * C::kStage;
  float* q_s = reinterpret_cast<float*>(v_s + 2 * C::kStage);
  float* acc_s = q_s + G * HD;
  float* p_s = acc_s + G * HD;
  float* m_s = p_s + G * kSlots;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y, n_chunks = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s0 = c * chunk, s1 = min(Sc, s0 + chunk);
  const int n_sub = (s1 - s0 + kSlots - 1) / kSlots;
  const T* kb = kc + b * c_sb + (long long)kh * HD;
  const T* vb = vc + b * c_sb + (long long)kh * HD;

  // sub-tile u's rows into stage u % 2; invalid or past-the-end slots are
  // zero-filled without a read
  auto issue = [&](int u) {
    T* kd = k_s + (u & 1) * C::kStage;
    T* vd = v_s + (u & 1) * C::kStage;
    for (int i = threadIdx.x; i < kSlots * C::kRowVecs; i += kThreads) {
      const int j = i / C::kRowVecs, piece = i % C::kRowVecs;
      const int slot = s0 + u * kSlots + j;
      const bool ok = slot < s1 && valid[slot];
      const long long off = ok ? (long long)slot * c_ss + piece * C::kVec : 0;
      cp_async16(kd + j * C::kPitch + piece * C::kVec, kb + off, ok ? 16 : 0);
      cp_async16(vd + j * C::kPitch + piece * C::kVec, vb + off, ok ? 16 : 0);
    }
  };
  issue(0);
  cp_async_commit();

  const T* qb = q + b * q_sb + (long long)kh * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }

  for (int u = 0; u < n_sub; ++u) {
    if (u + 1 < n_sub) issue(u + 1);
    cp_async_commit();  // (an empty group on the last sub-tile)
    cp_async_wait_1();  // sub-tile u has landed
    __syncthreads();
    const T* ks = k_s + (u & 1) * C::kStage;
    const T* vs = v_s + (u & 1) * C::kStage;

    // scores and the running softmax: a warp per query head, a lane per
    // slot
    const int slot = s0 + u * kSlots + lane;
    const bool ok = slot < s1 && valid[slot];
    for (int g = warp; g < G; g += kWarps) {
      float x = -INFINITY;
      if (ok) {
        float d = 0.0f;
#pragma unroll
        for (int v = 0; v < C::kRowVecs; ++v)
          d += dot_piece<T>(ks + lane * C::kPitch + v * C::kVec,
                            q_s + g * HD + v * C::kVec);
        x = d * scale_log2;
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const bool none = m_new == -INFINITY;  // no valid slot so far
      const float p = none ? 0.0f : exp2f(x - m_new);
      const float sum = warp_sum(p);
      p_s[g * kSlots + lane] = p;
      if (lane == 0) {
        const float alpha = none ? 1.0f : exp2f(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + sum_j p_j v_j, a thread per (head, feature pair)
    for (int i = threadIdx.x; i < G * (HD / 2); i += kThreads) {
      const int g = i / (HD / 2), f = 2 * (i % (HD / 2));
      const float alpha = alpha_s[g];
      float a0 = acc_s[g * HD + f] * alpha, a1 = acc_s[g * HD + f + 1] * alpha;
      const float* pg = p_s + g * kSlots;
#pragma unroll 8
      for (int j = 0; j < kSlots; ++j) {
        const float pj = pg[j];
        const float2 vj = pair_f32(vs + j * C::kPitch + f);
        a0 = fmaf(pj, vj.x, a0);
        a1 = fmaf(pj, vj.y, a1);
      }
      acc_s[g * HD + f] = a0;
      acc_s[g * HD + f + 1] = a1;
    }
    __syncthreads();  // stage u % 2 and p are free for sub-tile u + 2
  }

  // (m, l, acc[hd]) of each query head of kh for this chunk
  const int H = K * G;
  for (int i = threadIdx.x; i < G * (HD + 2); i += kThreads) {
    const int g = i / (HD + 2), e = i % (HD + 2);
    const float val = e == 0 ? m_s[g] : e == 1 ? l_s[g] : acc_s[g * HD + e - 2];
    part[(((long long)b * H + kh * G + g) * n_chunks + c) * (HD + 2) + e] =
        val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_combine(
    int n_chunks, const float* __restrict__ part, T* __restrict__ o) {
  const int bh = blockIdx.x, f = threadIdx.x;
  const float* pp = part + (long long)bh * n_chunks * (HD + 2);
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, pp[c * (HD + 2)]);
  float out = 0.0f;  // no valid slot at all
  if (M != -INFINITY) {
    float L = 0.0f, A = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* pc = pp + c * (HD + 2);
      const float w = exp2f(pc[0] - M);  // 0 for a chunk with no valid slot
      L = fmaf(w, pc[1], L);
      A = fmaf(w, pc[2 + f], A);
    }
    out = A / L;
  }
  store(o + (long long)bh * HD + f, out);
}

template <typename T, int HD>
int launch(int B, int K, int G, int Sc, int chunk, float scale,
           const void* q, long long q_sb, const void* kc, const void* vc,
           long long c_sb, long long c_ss, const void* valid, void* part,
           void* o, cudaStream_t stream) {
  const int n_chunks = max(1, (Sc + chunk - 1) / chunk);
  const size_t smem = smem_bytes<T, HD>(G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_split<T, HD><<<dim3(n_chunks, K, B), kThreads, smem, stream>>>(
      Sc, G, chunk, scale * 1.4426950408889634f, (const T*)q, q_sb,
      (const T*)kc, (const T*)vc, c_sb, c_ss, (const uint8_t*)valid,
      (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T, HD><<<B * K * G, HD, 0, stream>>>(
      n_chunks, (const float*)part, (T*)o);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, int B, int K, int G, int Sc, int chunk, float scale,
                const void* q, long long q_sb, const void* kc, const void* vc,
                long long c_sb, long long c_ss, const void* valid, void* part,
                void* o, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(B, K, G, Sc, chunk, scale, q, q_sb, kc, vc, c_sb,
                           c_ss, valid, part, o, stream);
    case 64:
      return launch<T, 64>(B, K, G, Sc, chunk, scale, q, q_sb, kc, vc, c_sb,
                           c_ss, valid, part, o, stream);
    case 128:
      return launch<T, 128>(B, K, G, Sc, chunk, scale, q, q_sb, kc, vc,
                            c_sb, c_ss, valid, part, o, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements; the caches' rows
// must be 16-byte aligned (the wrapper checks). ``part`` is float32 scratch
// of B * K * G * max(1, ceil(Sc / chunk)) * (hd + 2); the output is contiguous
// (B, K, G, hd). Two launches: the split pass and the combine.
extern "C" int decode_attention(int dtype, int hd, int B, int K, int G,
                                int Sc, int chunk, float scale,
                                const void* q, long long q_sb,
                                const void* kc, const void* vc,
                                long long c_sb, long long c_ss,
                                const void* valid, void* part, void* o,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, B, K, G, Sc, chunk, scale, q, q_sb, kc, vc,
                              c_sb, c_ss, valid, part, o, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, B, K, G, Sc, chunk, scale, q, q_sb,
                                      kc, vc, c_sb, c_ss, valid, part, o, s);
  return (int)cudaErrorInvalidValue;
}
