// Generalised advantage estimation and discounted returns: reverse-time
// scans over (T, B).
//
// gae replaces the TPU kernel gae_pallas, discounted_returns replaces
// discounted_returns_pallas (src/repro/kernels/gae/gae_pallas.py).
// In gae, one thread per column b walks t = T-1 ... 0 with the carry
// (adv_{t+1}, v_{t+1}) in registers:
//
//   nt    = 1 - done[t]
//   delta = r[t] + gamma * v_{t+1} * nt - v[t]
//   adv   = delta + (gamma * lam) * nt * adv_{t+1}
//   ret   = adv + v[t]
//
// in the expression order of the plain version (gamma * lam is folded on the
// host in double, as Python folds it). Consecutive threads read consecutive
// b, so every load and store of a time step is coalesced. Ragged T and B need
// no padding; the TPU kernel's time chunks and VMEM carry are not carried
// over. dones are read as stored (bool, one byte).
//
// discounted_returns walks the same way with the one carry R_{t+1}, seeded
// by last_value[b]:
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

namespace {

__global__ void gae_kernel(int T, int B, const float* __restrict__ r,
                           const float* __restrict__ v,
                           const uint8_t* __restrict__ done,
                           const float* __restrict__ last_value,
                           float* __restrict__ adv, float* __restrict__ ret,
                           float gamma, float gamma_lam) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float adv_next = 0.0f;
  float v_next = last_value[b];
  for (int t = T - 1; t >= 0; --t) {
    size_t k = (size_t)t * B + b;
    float nt = 1.0f - (done[k] ? 1.0f : 0.0f);
    float vt = v[k];
    float delta = r[k] + gamma * v_next * nt - vt;
    float a = delta + gamma_lam * nt * adv_next;
    adv[k] = a;
    ret[k] = a + vt;
    adv_next = a;
    v_next = vt;
  }
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
  int blocks = (B + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
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
