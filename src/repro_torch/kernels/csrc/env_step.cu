// Fused batched env step + auto-reset for pendulum, cart-pole and cheetah.
//
// Replaces the TPU kernels pendulum_step_pallas, cartpole_step_pallas and
// cheetah_step_pallas (src/repro/kernels/env_step/env_step_pallas.py). One thread per env
// instance evaluates the physics, reward, termination and observation in the
// expression order of the plain versions (repro_torch/kernels/env_step/ref.py),
// then selects the reset candidates where the episode ended. The TPU kernels'
// (leaf, B) lane tiles are not carried over: the public layout is kept, i.e.
// state leaves (B,) or (B, 6), actions (B, act_dim), reset obs (B, obs_dim).
//
// Bound on an H100: HBM bytes. Each instance reads its state and actions
// once and writes its next state, obs, reward and done once (cheetah: 84 B
// read + 121 B written; cart-pole: 24 B read + 41 B written; pendulum:
// 16 B read + 29 B written); only an instance whose episode ended also
// reads its reset candidates (cheetah 116 B, cart-pole 36 B, pendulum
// 24 B). Against those bytes stand a few dozen float
// operations per instance, far below the card's operations-per-byte
// balance. The design keeps everything per thread
// in registers (cheetah's joint roll, 5-term thrust mean and 6-term control
// sum are unrolled) and makes one pass over memory.
//
// Built with -fmad=false: no FMA contraction, so results round like the
// plain PyTorch version's separate elementwise ops. sinf/cosf are CUDA's
// full-range versions (no fast math). Cart-pole's constants that the
// reference folds in Python (total mass, pole mass x half-length, 4/3) and
// its two fall limits arrive as floats rounded once from the host's double,
// so every comparison and division is the float32 one of the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

// jnp.clip / torch.clamp: NaN passes through.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// ((x + pi) % (2 pi)) - pi with the floor-mod of jnp's % (sign of divisor):
// fmodf is exact; add the divisor where the remainder's sign disagrees.
__device__ __forceinline__ float angle_norm(float x) {
  float r = fmodf(x + kPi, kTwoPi);
  if (r != 0.0f && ((r < 0.0f) != (kTwoPi < 0.0f))) r = r + kTwoPi;
  return r - kPi;
}

constexpr int kJ = 6;                  // cheetah joints
constexpr int kCheetahObs = 2 * kJ + 2;

__global__ void pendulum_step_kernel(
    int B, const float* __restrict__ th, const float* __restrict__ thdot,
    const int32_t* __restrict__ t, const float* __restrict__ act,
    const float* __restrict__ rth, const float* __restrict__ rtd,
    const int32_t* __restrict__ rt, const float* __restrict__ robs,
    float* __restrict__ oth, float* __restrict__ otd,
    int32_t* __restrict__ ot, float* __restrict__ oobs,
    float* __restrict__ orew, uint8_t* __restrict__ odone,
    int max_episode_steps, float max_torque, float reward_scale,
    float grav_coef, float torque_coef) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float th_i = th[i];
  float td = thdot[i];
  float u = clip(act[i], -max_torque, max_torque);
  float an = angle_norm(th_i);
  float cost = an * an + 0.1f * (td * td) + 0.001f * (u * u);
  td = td + (grav_coef * sinf(th_i) + torque_coef * u) * 0.05f;
  td = clip(td, -8.0f, 8.0f);
  float nth = th_i + td * 0.05f;
  int32_t nt = t[i] + 1;
  bool done = nt >= max_episode_steps;
  float rew = -cost;
  if (reward_scale != 1.0f) rew = rew * reward_scale;
  orew[i] = rew;
  odone[i] = done ? 1 : 0;
  if (done) {
    oth[i] = rth[i];
    otd[i] = rtd[i];
    ot[i] = rt[i];
    oobs[3 * i + 0] = robs[3 * i + 0];
    oobs[3 * i + 1] = robs[3 * i + 1];
    oobs[3 * i + 2] = robs[3 * i + 2];
  } else {
    oth[i] = nth;
    otd[i] = td;
    ot[i] = nt;
    oobs[3 * i + 0] = cosf(nth);
    oobs[3 * i + 1] = sinf(nth);
    oobs[3 * i + 2] = td / 8.0f;
  }
}

__global__ void cheetah_step_kernel(
    int B, const float* __restrict__ th, const float* __restrict__ om,
    const float* __restrict__ vx, const float* __restrict__ pitch,
    const int32_t* __restrict__ t, const float* __restrict__ act,
    const float* __restrict__ rth, const float* __restrict__ rom,
    const float* __restrict__ rvx, const float* __restrict__ rpi,
    const int32_t* __restrict__ rt, const float* __restrict__ robs,
    float* __restrict__ oth, float* __restrict__ oom,
    float* __restrict__ ovx, float* __restrict__ opi,
    int32_t* __restrict__ ot, float* __restrict__ oobs,
    float* __restrict__ orew, uint8_t* __restrict__ odone,
    int max_episode_steps, float ctrl_cost, float reward_scale) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float a[kJ], th0[kJ], th1[kJ], om1[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    a[j] = clip(act[kJ * i + j], -1.0f, 1.0f);
    th0[j] = th[kJ * i + j];
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    // roll(th, 1): joint j couples to joint j-1 (joint 0 to joint 5)
    float neighbour = 0.8f * (th0[(j + kJ - 1) % kJ] - th0[j]);
    float o = om[kJ * i + j];
    om1[j] = o + 0.05f * (6.0f * a[j] - 1.5f * o - 4.0f * th0[j] + neighbour);
    th1[j] = th0[j] + 0.05f * om1[j];
  }
  float thrust = 0.0f;
  float th_sum = th1[0];
#pragma unroll
  for (int j = 0; j < kJ - 1; ++j) {
    float term = sinf(th1[j] - th1[j + 1]) * (om1[j] - om1[j + 1]);
    thrust = j == 0 ? term : thrust + term;
    th_sum = th_sum + th1[j + 1];
  }
  thrust = thrust / 5.0f;
  float nvx = 0.9f * vx[i] + 0.05f * (8.0f * thrust);
  float npi = 0.95f * pitch[i] + 0.05f * (th_sum / 6.0f);
  int32_t nt = t[i] + 1;
  float asq = a[0] * a[0];
#pragma unroll
  for (int j = 1; j < kJ; ++j) asq = asq + a[j] * a[j];
  float rew = nvx - ctrl_cost * asq;
  if (reward_scale != 1.0f) rew = rew * reward_scale;
  bool done = nt >= max_episode_steps;
  orew[i] = rew;
  odone[i] = done ? 1 : 0;
  float* obs = oobs + kCheetahObs * i;
  if (done) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      oth[kJ * i + j] = rth[kJ * i + j];
      oom[kJ * i + j] = rom[kJ * i + j];
    }
    ovx[i] = rvx[i];
    opi[i] = rpi[i];
    ot[i] = rt[i];
#pragma unroll
    for (int k = 0; k < kCheetahObs; ++k) obs[k] = robs[kCheetahObs * i + k];
  } else {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      oth[kJ * i + j] = th1[j];
      oom[kJ * i + j] = om1[j];
      obs[j] = th1[j];
      obs[kJ + j] = om1[j];
    }
    ovx[i] = nvx;
    opi[i] = npi;
    ot[i] = nt;
    obs[2 * kJ] = nvx;
    obs[2 * kJ + 1] = npi;
  }
}

__global__ void cartpole_step_kernel(
    int B, const float* __restrict__ x, const float* __restrict__ xdot,
    const float* __restrict__ th, const float* __restrict__ thdot,
    const int32_t* __restrict__ t, const float* __restrict__ act,
    const float* __restrict__ rx, const float* __restrict__ rxd,
    const float* __restrict__ rth, const float* __restrict__ rtd,
    const int32_t* __restrict__ rt, const float* __restrict__ robs,
    float* __restrict__ ox, float* __restrict__ oxd,
    float* __restrict__ oth, float* __restrict__ otd,
    int32_t* __restrict__ ot, float* __restrict__ oobs,
    float* __restrict__ orew, uint8_t* __restrict__ odone,
    int max_episode_steps, float force_max, float reward_scale,
    float total_m, float pm_l, float four_thirds, float x_limit,
    float th_limit) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float a0 = act[i];
  float x_i = x[i], xd = xdot[i], th_i = th[i], td = thdot[i];
  float force = clip(a0, -1.0f, 1.0f) * force_max;
  float costh = cosf(th_i);
  float sinth = sinf(th_i);
  float temp = (force + pm_l * (td * td) * sinth) / total_m;
  float th_acc = (9.8f * sinth - costh * temp) /
                 (0.5f * (four_thirds - 0.1f * (costh * costh) / total_m));
  float x_acc = temp - pm_l * th_acc * costh / total_m;
  float nx = x_i + 0.02f * xd;
  float nxd = xd + 0.02f * x_acc;
  float nth = th_i + 0.02f * td;
  float ntd = td + 0.02f * th_acc;
  int32_t nt = t[i] + 1;
  bool fell = (fabsf(nx) > x_limit) | (fabsf(nth) > th_limit);
  bool done = fell | (nt >= max_episode_steps);
  // the control cost takes the unclipped action, as the reference's does
  float rew = 1.0f - 0.01f * (a0 * a0) - (fell ? 1.0f : 0.0f);
  if (reward_scale != 1.0f) rew = rew * reward_scale;
  orew[i] = rew;
  odone[i] = done ? 1 : 0;
  float* obs = oobs + 4 * i;
  if (done) {
    ox[i] = rx[i];
    oxd[i] = rxd[i];
    oth[i] = rth[i];
    otd[i] = rtd[i];
    ot[i] = rt[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) obs[k] = robs[4 * i + k];
  } else {
    ox[i] = nx;
    oxd[i] = nxd;
    oth[i] = nth;
    otd[i] = ntd;
    ot[i] = nt;
    obs[0] = nx;
    obs[1] = nxd;
    obs[2] = nth;
    obs[3] = ntd;
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int pendulum_step(
    int B, const void* th, const void* thdot, const void* t, const void* act,
    const void* rth, const void* rtd, const void* rt, const void* robs,
    void* oth, void* otd, void* ot, void* oobs, void* orew, void* odone,
    int max_episode_steps, float max_torque, float reward_scale,
    float grav_coef, float torque_coef, void* stream) {
  int blocks = (B + kThreads - 1) / kThreads;
  pendulum_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      B, (const float*)th, (const float*)thdot, (const int32_t*)t,
      (const float*)act, (const float*)rth, (const float*)rtd,
      (const int32_t*)rt, (const float*)robs, (float*)oth, (float*)otd,
      (int32_t*)ot, (float*)oobs, (float*)orew, (uint8_t*)odone,
      max_episode_steps, max_torque, reward_scale, grav_coef, torque_coef);
  return (int)cudaGetLastError();
}

extern "C" int cartpole_step(
    int B, const void* x, const void* xdot, const void* th,
    const void* thdot, const void* t, const void* act, const void* rx,
    const void* rxd, const void* rth, const void* rtd, const void* rt,
    const void* robs, void* ox, void* oxd, void* oth, void* otd, void* ot,
    void* oobs, void* orew, void* odone, int max_episode_steps,
    float force_max, float reward_scale, float total_m, float pm_l,
    float four_thirds, float x_limit, float th_limit, void* stream) {
  int blocks = (B + kThreads - 1) / kThreads;
  cartpole_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      B, (const float*)x, (const float*)xdot, (const float*)th,
      (const float*)thdot, (const int32_t*)t, (const float*)act,
      (const float*)rx, (const float*)rxd, (const float*)rth,
      (const float*)rtd, (const int32_t*)rt, (const float*)robs, (float*)ox,
      (float*)oxd, (float*)oth, (float*)otd, (int32_t*)ot, (float*)oobs,
      (float*)orew, (uint8_t*)odone, max_episode_steps, force_max,
      reward_scale, total_m, pm_l, four_thirds, x_limit, th_limit);
  return (int)cudaGetLastError();
}

extern "C" int cheetah_step(
    int B, const void* th, const void* om, const void* vx, const void* pitch,
    const void* t, const void* act, const void* rth, const void* rom,
    const void* rvx, const void* rpi, const void* rt, const void* robs,
    void* oth, void* oom, void* ovx, void* opi, void* ot, void* oobs,
    void* orew, void* odone, int max_episode_steps, float ctrl_cost,
    float reward_scale, void* stream) {
  int blocks = (B + kThreads - 1) / kThreads;
  cheetah_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      B, (const float*)th, (const float*)om, (const float*)vx,
      (const float*)pitch, (const int32_t*)t, (const float*)act,
      (const float*)rth, (const float*)rom, (const float*)rvx,
      (const float*)rpi, (const int32_t*)rt, (const float*)robs, (float*)oth,
      (float*)oom, (float*)ovx, (float*)opi, (int32_t*)ot, (float*)oobs,
      (float*)orew, (uint8_t*)odone, max_episode_steps, ctrl_cost,
      reward_scale);
  return (int)cudaGetLastError();
}
