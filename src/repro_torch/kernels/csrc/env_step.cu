// Fused batched env step + auto-reset for pendulum, cart-pole and cheetah.
//
// Replaces the TPU kernels pendulum_step_pallas, cartpole_step_pallas and
// cheetah_step_pallas (src/repro/kernels/env_step/env_step_pallas.py). Each
// kernel evaluates the physics, reward, termination and observation in the
// expression order of the plain versions (repro_torch/kernels/env_step/ref.py),
// then selects the reset candidates where the episode ended. The TPU kernels'
// (leaf, B) lane tiles are not carried over: the public layout is kept, i.e.
// state leaves (B,) or (B, 6), actions (B, act_dim), reset obs (B, obs_dim).
// Pendulum and cart-pole take one thread per env, 256 a block. Cheetah takes
// six lanes per env (one per joint, see cheetah_step_kernel), so that its
// (B, 6) and (B, 14) leaves are read and written by consecutive lanes and a
// batch of 4,096 spreads over the whole card, and so that the five thrust
// sines of an env run side by side on five lanes.
//
// Bound on an H100: HBM bytes. Each instance reads its state and actions
// once and writes its next state, obs, reward and done once (cheetah: 84 B
// read + 121 B written; cart-pole: 24 B read + 41 B written; pendulum:
// 16 B read + 29 B written); only an instance whose episode ended also
// reads its reset candidates (cheetah 116 B, cart-pole 36 B, pendulum
// 24 B). Against those bytes stand a few dozen float operations per
// instance, far below the card's operations-per-byte balance. At the
// batches the RL runs use (16 and 4,096 envs) the bytes take well under a
// microsecond; what is left is the launch and one dependent chain of
// loads, sines and stores per env, which the designs keep short.
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

// cheetah: six lanes per env, one per joint, five envs on lanes 0..29 of a
// warp (lanes 30 and 31 idle) and kCheetahWarps warps a block, so B 4,096
// spreads over 205 blocks. Each lane reads its env's whole row of act, th
// and om (the env's six lanes read the same addresses) and updates all six
// joints, then takes the one thrust sine of its own joint; __shfl_sync
// gathers the five sines to each lane of the env, which sums them in the
// plain order (j = 0 ... 4). A lane writes its own joint of oth and oom
// and its own floats of obs: consecutive lanes, consecutive floats. The
// reset candidates of a row whose episode ended are read as soon as its t
// is known, so their round trip overlaps the physics.
constexpr int kCheetahWarps = 4;
constexpr int kCheetahEnvsPerWarp = 32 / kJ;                      // 5
constexpr int kCheetahEnvs = kCheetahWarps * kCheetahEnvsPerWarp;  // 20
constexpr int kCheetahThreads = 32 * kCheetahWarps;

__global__ void __launch_bounds__(kCheetahThreads) cheetah_step_kernel(
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
  const int lane = threadIdx.x & 31;
  const int g = lane / kJ, j = lane - g * kJ, base = g * kJ;
  const int i = (blockIdx.x * kCheetahWarps + threadIdx.x / 32) *
                    kCheetahEnvsPerWarp + g;
  const bool active = g < kCheetahEnvsPerWarp && i < B;
  const size_t k6 = (size_t)kJ * i + j, k14 = (size_t)kCheetahObs * i + j;
  float a[kJ], th0[kJ], o[kJ];
#pragma unroll
  for (int m = 0; m < kJ; ++m) a[m] = th0[m] = o[m] = 0.0f;
  float vx_i = 0.0f, pi_i = 0.0f;
  int32_t t_i = 0;
  if (active) {
    t_i = t[i];
    vx_i = vx[i];
    pi_i = pitch[i];
#pragma unroll
    for (int m = 0; m < kJ; ++m) {
      a[m] = clip(act[kJ * i + m], -1.0f, 1.0f);
      th0[m] = th[kJ * i + m];
      o[m] = om[kJ * i + m];
    }
  }
  const int32_t nt = t_i + 1;
  const bool done = nt >= max_episode_steps;
  // lane j's floats of the reset candidates; lanes 0, 1, 2 also vx, pitch, t
  float r_th = 0.0f, r_om = 0.0f, r_ob0 = 0.0f, r_ob1 = 0.0f, r_ob2 = 0.0f;
  float r_row = 0.0f;
  int32_t r_t = 0;
  if (active && done) {
    r_th = rth[k6];
    r_om = rom[k6];
    r_ob0 = robs[k14];
    r_ob1 = robs[k14 + kJ];
    if (j < 2) r_ob2 = robs[k14 + 2 * kJ];
    if (j == 0) r_row = rvx[i];
    if (j == 1) r_row = rpi[i];
    if (j == 2) r_t = rt[i];
  }
  float th1[kJ], om1[kJ];
#pragma unroll
  for (int m = 0; m < kJ; ++m) {
    // roll(th, 1): joint m couples to joint m-1 (joint 0 to joint 5)
    float neighbour = 0.8f * (th0[(m + kJ - 1) % kJ] - th0[m]);
    om1[m] = o[m] + 0.05f * (6.0f * a[m] - 1.5f * o[m] - 4.0f * th0[m] +
                             neighbour);
    th1[m] = th0[m] + 0.05f * om1[m];
  }
  // this lane's joint and thrust term, picked without indexing by j
  float my_th1 = th1[0], my_om1 = om1[0], x = 0.0f, y = 0.0f;
#pragma unroll
  for (int m = 0; m < kJ; ++m) {
    if (j == m) {
      my_th1 = th1[m];
      my_om1 = om1[m];
      if (m < kJ - 1) {
        x = th1[m] - th1[m + 1];
        y = om1[m] - om1[m + 1];
      }
    }
  }
  float term = 0.0f;
  if (active && j < kJ - 1) term = sinf(x) * y;
  float thrust = __shfl_sync(0xffffffffu, term, base);
#pragma unroll
  for (int m = 1; m < kJ - 1; ++m)
    thrust = thrust + __shfl_sync(0xffffffffu, term, base + m);
  if (!active) return;
  thrust = thrust / 5.0f;
  float th_sum = th1[0];
#pragma unroll
  for (int m = 1; m < kJ; ++m) th_sum = th_sum + th1[m];
  float asq = a[0] * a[0];
#pragma unroll
  for (int m = 1; m < kJ; ++m) asq = asq + a[m] * a[m];
  float nvx = 0.9f * vx_i + 0.05f * (8.0f * thrust);
  float npi = 0.95f * pi_i + 0.05f * (th_sum / 6.0f);
  float rew = nvx - ctrl_cost * asq;
  if (reward_scale != 1.0f) rew = rew * reward_scale;
  if (done) {
    oth[k6] = r_th;
    oom[k6] = r_om;
    oobs[k14] = r_ob0;
    oobs[k14 + kJ] = r_ob1;
    if (j < 2) oobs[k14 + 2 * kJ] = r_ob2;
  } else {
    oth[k6] = my_th1;
    oom[k6] = my_om1;
    oobs[k14] = my_th1;
    oobs[k14 + kJ] = my_om1;
    if (j < 2) oobs[k14 + 2 * kJ] = j == 0 ? nvx : npi;
  }
  if (j == 0) {
    orew[i] = rew;
    odone[i] = done ? 1 : 0;
    ovx[i] = done ? r_row : nvx;
  } else if (j == 1) {
    opi[i] = done ? r_row : npi;
  } else if (j == 2) {
    ot[i] = done ? r_t : nt;
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
  int blocks = (B + kCheetahEnvs - 1) / kCheetahEnvs;
  cheetah_step_kernel<<<blocks, kCheetahThreads, 0, (cudaStream_t)stream>>>(
      B, (const float*)th, (const float*)om, (const float*)vx,
      (const float*)pitch, (const int32_t*)t, (const float*)act,
      (const float*)rth, (const float*)rom, (const float*)rvx,
      (const float*)rpi, (const int32_t*)rt, (const float*)robs, (float*)oth,
      (float*)oom, (float*)ovx, (float*)opi, (int32_t*)ot, (float*)oobs,
      (float*)orew, (uint8_t*)odone, max_episode_steps, ctrl_cost,
      reward_scale);
  return (int)cudaGetLastError();
}
