// FlashAttention prefill forward in the model's own layout.
//
// Replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:89, pallas_call at
// :112). For each query row r of head h = kh * G + g (GQA: key/value head
// kh), over the key columns c it may see (c <= r when causal,
// r - c < window when windowed; one sequence length S for queries and
// keys, as the TPU kernel takes):
//
//   s_c = (q_r . k_c) * scale
//   o_r = sum_c softmax(s)_c v_c
//
// with the streaming softmax (running max m, denominator l and f32
// accumulator acc), and a row that sees no column gives 0, as the TPU
// kernel's l == 0 guard does. q (B, S, K, G, hd) and k/v (B, S, K, hd) are
// read in place by their strides (no transpose to (B, H, S, hd)); the
// output has q's layout and dtype. hd is 32, 64 or 128 (a template
// parameter; the wrapper raises on others). Only the key range a tile's
// rows can see is walked ([q0 - window + 1, q0 + rows) for causal windowed
// attention): the fully masked blocks that the TPU kernel skips with
// pl.when are never loaded.
//
// Bound on an H100: a row does 4 * hd operations per key it sees, on K/V
// rows that all rows of a head share. At hymba's short prefill (S 144)
// that is 0.27 GFLOP against 4.4 MB, so bytes bound it; at a long one
// (S 4,224, window 2,048) 42 GFLOP against 32 MB, so operations do, at
// the bf16 tensor-core rate (989 TFLOP/s).
//
// The kernel is chosen by dtype; neither is a fallback for the other.
//
// bfloat16 (the model's serving dtype): the tensor cores. One warpgroup
// (128 threads) owns 64 query rows of one (b, h). Q and each 64-key K/V
// tile reach shared memory by TMA (cp.async.bulk.tensor, issued by one
// thread, completion on an mbarrier) into a ring of kStages stages: the
// next tiles' loads are in flight while the current one is computed. The
// tensor maps, encoded on the host for each call, describe q as
// (hd, K*G, S, B) and k/v as (hd, K, S, B) by their strides, with the
// swizzle that wgmma's shared-memory descriptor reads: 128 B rows at hd 64,
// two 64-column boxes at hd 128, 64 B rows at hd 32. S = Q K^T is a
// wgmma m64n64k16 (bf16 in, f32 accumulate) with both operands in shared
// memory; the causal, window and ragged-edge masks are applied only on the
// tiles that cross them; the softmax runs in exp2 with scale * log2(e)
// folded in, the row max reduced across the 4 threads that share a row of
// the accumulator, and O rescaled only when a row's max grows. P is
// rounded to bf16 in registers and is the A operand of O += P V (wgmma
// m64n{hd}k16, V read from shared memory with the transpose bit, since it
// is stored key-major), with O in f32 registers. TMA zero-fills rows past
// S: the kernel masks those columns and never writes those rows.
//
// float32: no tensor-core mode keeps full float32, so float32 inputs run
// the CUDA-core kernel: each query row is owned by hd / 32 adjacent
// threads, each holding 32 of its features of q and of acc in float32
// registers (features part, part + hd/32, ...); key/value tiles of 32 rows
// are loaded into shared memory by all threads; the tile is walked key by
// key with the streaming softmax (a butterfly of shuffles sums a row's
// partial dot products; acc is rescaled only when the running max grows).
// The TPU kernel takes one max per KV block instead; the two agree to
// rounding. Products are explicit fmaf.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------- float32: CUDA cores
constexpr int kRows = 64;
constexpr int kKeys = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ------------------------------------------- bfloat16: tensor cores
namespace tc {

constexpr int kTile = 64;    // query rows per block, keys per K/V tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;

template <int HD>
struct Cfg {
  static constexpr int kBox = HD < 64 ? HD : 64;  // columns per TMA box
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kRowBytes = kBox * 2;      // 64 or 128: the swizzle
  static constexpr int kBoxBytes = kTile * kRowBytes;
  static constexpr int kTileBytes = kTile * HD * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows of the swizzle
  static constexpr uint64_t kLayout = HD < 64 ? 2 : 1;  // SW64 : SW128
  static constexpr int kSmem = 1024 + kTileBytes * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  while (!done) {
    if (++spins == (1u << 24)) __trap();  // a lost load: fail, do not hang
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout in bits 62-63
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) = A (64 x 16, smem) * B (16 x 64, smem), both K-major;
// ``accumulate`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// D (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 32) wgmma_rs_m64n32(o, a, b);
  if constexpr (HD == 64) wgmma_rs_m64n64(o, a, b);
  if constexpr (HD == 128) wgmma_rs_m64n128(o, a, b);
}

// 2^x by the SFU's ex2 (relative error about 2^-22; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of a wgmma m64nN: thread (warp w, lane l) holds, for
// i in [0, N / 2), row 16 w + l / 4 + 8 * ((i >> 1) & 1) and column
// 8 * (i / 4) + 2 * (l % 4) + (i & 1).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_tc(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, int S, int G, int causal,
    int window, float scale_log2, __nv_bfloat16* __restrict__ o,
    long long o_sb, long long o_ss) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  auto k_s = [&](int st) { return base + C::kTileBytes * (1 + 2 * st); };
  auto v_s = [&](int st) { return base + C::kTileBytes * (2 + 2 * st); };
  auto bar = [&](int i) { return smem_u32(&bars[i]); };

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  // the key tiles any row of this block can see
  int lo = 0, hi = S;
  if (causal) hi = min(S, q0 + kTile);
  if (window) lo = max(0, q0 - window + 1) & ~(kTile - 1);
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  const CUtensorMap* kmp = &k_map;
  const CUtensorMap* vmp = &v_map;

  auto load_kv = [&](int t) {
    const int st = t % kStages;
    mbar_expect(bar(1 + st), 2 * C::kTileBytes);
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load(k_s(st) + x * C::kBoxBytes, kmp, x * C::kBox, kh,
               lo + t * kTile, b, bar(1 + st));
      tma_load(v_s(st) + x * C::kBoxBytes, vmp, x * C::kBox, kh,
               lo + t * kTile, b, bar(1 + st));
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(bar(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar(0), C::kTileBytes);
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x)
      tma_load(q_s + x * C::kBoxBytes, &q_map, x * C::kBox, h, q0, b,
               bar(0));
    for (int t = 0; t < min(n_tiles, kStages - 1); ++t) load_kv(t);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;  // and row0 + 8
  const int col_in = 2 * (lane % 4);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  mbar_wait(bar(0), 0);
  __syncwarp();

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // every warp is done with tile t - 1's stage
    if (threadIdx.x == 0 && t + kStages - 1 < n_tiles)
      load_kv(t + kStages - 1);
    const int st = t % kStages;
    mbar_wait(bar(1 + st), (t / kStages) & 1);
    __syncwarp();

    // S = Q K^T over hd in steps of 16 (32 bytes of a row)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      const uint32_t off = (k * 32 / C::kRowBytes) * C::kBoxBytes +
                           (k * 32) % C::kRowBytes;
      wgmma_ss_m64n64(s, desc(q_s + off, 16, C::kAtomBytes, C::kLayout),
                      desc(k_s(st) + off, 16, C::kAtomBytes, C::kLayout),
                      k > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // mask where the tile crosses an edge; row max of the raw scores
    const int c0 = lo + t * kTile;
    const bool edge = c0 + kTile > S || (causal && c0 + kTile - 1 > q0) ||
                      (window && q0 + kTile - 1 - c0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (edge) {
        const int col = c0 + 8 * (i / 4) + col_in + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= S || (causal && col > row) ||
            (window && row - col >= window))
          s[i] = -INFINITY;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float bias[2];  // -m * scale * log2(e): p = exp2(s * scale_log2 + bias)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (mx[r] > m[r]) {  // a new running max: rescale what is summed
        const float alpha = exp2_approx((m[r] - mx[r]) * scale_log2);
        l[r] *= alpha;     // (0 when m was -inf)
#pragma unroll
        for (int i = 0; i < HD / 2; ++i)
          if (((i >> 1) & 1) == r) acc[i] *= alpha;
        m[r] = mx[r];
      }
      bias[r] = m[r] == -INFINITY ? 0.0f : -m[r] * scale_log2;
    }
    // P, one FFMA and one ex2 per score, rounded to bf16 as the A operand
    // of P V
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2_approx(fmaf(s[i], scale_log2, bias[r]));
      const float p1 = exp2_approx(fmaf(s[i + 1], scale_log2, bias[r]));
      l[r] += p0 + p1;
      p[i / 2] = pack_bf16(p0, p1);
    }
    fence_regs(acc);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      // keys 16 j .. 16 j + 15: n8 blocks 2 j and 2 j + 1 of S
      const uint32_t a[4] = {p[4 * j], p[4 * j + 1], p[4 * j + 2],
                             p[4 * j + 3]};
      wgmma_pv<HD>(acc, a, desc(v_s(st) + j * 16 * C::kRowBytes,
                                C::kBoxBytes, C::kAtomBytes, C::kLayout));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.0f) l[r] = 1.0f;  // a row that sees no key gives 0
  }
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    if (row < S) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[i] / l[r],
                                               acc[i + 1] / l[r]);
      *reinterpret_cast<__nv_bfloat162*>(
          o + b * o_sb + (long long)row * o_ss + (long long)h * HD +
          8 * (i / 4) + col_in) = v;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, heads, S, B) bf16 rows of ``heads`` packed heads, strides in
// elements; boxes of (kBox, 1, 64, 1)
template <int HD>
bool encode(CUtensorMap* map, EncodeTiled fn, const void* ptr, int heads,
            int S, int B, long long s_seq, long long s_batch) {
  using C = Cfg<HD>;
  // a dim of length 1 may carry any stride; give the map a valid one
  if (S == 1) s_seq = (long long)heads * HD;
  if (B == 1) s_batch = s_seq * S;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)s_seq * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kBox, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            HD < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(int B, int H, int S, int G, int causal, int window, float scale,
           const void* q, long long q_sb, long long q_ss, const void* k,
           const void* v, long long kv_sb, long long kv_ss, void* o,
           long long o_sb, long long o_ss, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (C::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (!encode<HD>(&q_map, fn, q, H, S, B, q_ss, q_sb) ||
      !encode<HD>(&k_map, fn, k, H / G, S, B, kv_ss, kv_sb) ||
      !encode<HD>(&v_map, fn, v, H / G, S, B, kv_ss, kv_sb))
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attention_tc<HD><<<grid, kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, S, G, causal, window, scale * 1.4426950408889634f,
      (__nv_bfloat16*)o, o_sb, o_ss);
  return (int)cudaGetLastError();
}

}  // namespace tc


template <int HD>
int launch_f32(int B, int H, int S, int G, int causal, int window,
               float scale, const void* q, long long q_sb, long long q_ss,
               const void* k, const void* v, long long kv_sb,
               long long kv_ss, void* o, long long o_sb, long long o_ss,
               cudaStream_t stream) {
  dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<float, HD><<<grid, kRows * (HD / 32), 0, stream>>>(
      S, S, G, causal, window, scale, (const float*)q, q_sb, q_ss,
      (const float*)k, (const float*)v, kv_sb, kv_ss, (float*)o, o_sb, o_ss);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, int B, int H, int S, int G, int causal, int window,
           float scale, const void* q, long long q_sb, long long q_ss,
           const void* k, const void* v, long long kv_sb, long long kv_ss,
           void* o, long long o_sb, long long o_ss, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<HD>(B, H, S, G, causal, window, scale, q, q_sb, q_ss,
                          k, v, kv_sb, kv_ss, o, o_sb, o_ss, stream);
  if (dtype == 1)
    return tc::launch<HD>(B, H, S, G, causal, window, scale, q, q_sb, q_ss,
                          k, v, kv_sb, kv_ss, o, o_sb, o_ss, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). One sequence
// length S for q and k/v. Strides are in elements; bfloat16 needs 16-byte
// aligned pointers and strides (the wrapper checks).
extern "C" int flash_attention(int dtype, int hd, int B, int H, int S, int G,
                               int causal, int window, float scale,
                               const void* q, long long q_sb, long long q_ss,
                               const void* k, const void* v, long long kv_sb,
                               long long kv_ss, void* o, long long o_sb,
                               long long o_ss, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(dtype, B, H, S, G, causal, window, scale, q, q_sb,
                        q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss, s);
    case 64:
      return launch<64>(dtype, B, H, S, G, causal, window, scale, q, q_sb,
                        q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss, s);
    case 128:
      return launch<128>(dtype, B, H, S, G, causal, window, scale, q, q_sb,
                         q_ss, k, v, kv_sb, kv_ss, o, o_sb, o_ss, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
