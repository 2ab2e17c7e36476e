// Fused batched env step + auto-reset for pendulum, cart-pole and cheetah.
//
// Replaces the TPU kernels pendulum_step_pallas, cartpole_step_pallas and
// cheetah_step_pallas (src/repro/kernels/env_step/env_step_pallas.py). Each
// kernel evaluates the physics, reward, termination and observation in the
// expression order of the plain versions (repro_torch/kernels/env_step/ref.py),
// then selects the reset candidates where the episode ended. The TPU kernels'
// (leaf, B) lane tiles are not carried over: the public layout is kept, i.e.
// state leaves (B,) or (B, 6), actions (B, act_dim), reset obs (B, obs_dim).
//
// Bound on an H100: HBM bytes. Each instance reads its state and actions
// once and writes its next state, obs, reward and done once (cheetah: 84 B
// read + 121 B written; cart-pole: 24 B read + 41 B written; pendulum:
// 16 B read + 29 B written), and its reset candidates (cheetah 116 B where
// its episode ended; cart-pole 36 B and pendulum 24 B on every row).
// Against those bytes stand a few dozen float operations per instance, far
// below the card's operations-per-byte balance. At the batches the RL runs
// use (16 to 4,096 envs) the bytes take well under a microsecond; what is
// left is the launch and one dependent chain of loads, sines and stores
// per env, which the designs keep short:
//
// * pendulum and cart-pole: one thread per env, 256 a block. Every load is
//   issued before any arithmetic, the reset candidates of every row too, so
//   a row whose episode ends pays no second trip to memory; outputs are
//   selected, never branched on. One range reduction per trig argument:
//   sincosf, which gives the bits of sinf and cosf (held over all 2^32
//   float32 inputs on the card). A cart-pole row of obs and of reset obs
//   moves as one float4 (where both are 16-byte aligned; else four
//   floats); a pendulum row is three floats a lane, and a warp's 32 rows
//   one run of 384 bytes, which L2 merges. Blocks of 32 or 64 threads,
//   blocks sized from B, reading the candidates only where an episode
//   ends, and a warp's pendulum obs staged in shared memory all measured
//   slower on the H100 (PERF.md).
// * cheetah: six lanes per env (one per joint, see cheetah_step_kernel),
//   so that its (B, 6) and (B, 14) leaves are read and written by
//   consecutive lanes and a batch of 4,096 spreads over the whole card,
//   and so that the five thrust sines of an env run side by side.
//
// Each entry point takes one packed argument block (the *Args structs; the
// wrapper packs it with struct.pack in the same layout), so a launch
// converts one ctypes argument.
//
// Built with -fmad=false: no FMA contraction, so results round like the
// plain PyTorch version's separate elementwise ops. sinf/cosf/sincosf are
// CUDA's full-range versions (no fast math); fmodf is exact. Cart-pole's
// constants that the reference folds in Python (total mass, pole mass x
// half-length, 4/3) and its two fall limits arrive as floats rounded once
// from the host's double, so every comparison and division is the float32
// one of the plain version.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kThreads = 256;          // pendulum and cart-pole

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

// The packed argument blocks, in the order of the wrappers' struct formats
// (ops.py): the inputs, the outputs (the next state's leaves, obs, reward,
// done), the stream, B and the horizon, the float scalars.
struct PendulumArgs {
  const float* th; const float* thdot; const int32_t* t; const float* act;
  const float* rth; const float* rtd; const int32_t* rt; const float* robs;
  float* oth; float* otd; int32_t* ot; float* oobs; float* orew;
  uint8_t* odone;
  void* stream;
  int B, max_episode_steps;
  float max_torque, reward_scale, grav_coef, torque_coef;
};

struct CartpoleArgs {
  const float* x; const float* xdot; const float* th; const float* thdot;
  const int32_t* t; const float* act;
  const float* rx; const float* rxd; const float* rth; const float* rtd;
  const int32_t* rt; const float* robs;
  float* ox; float* oxd; float* oth; float* otd; int32_t* ot; float* oobs;
  float* orew; uint8_t* odone;
  void* stream;
  int B, max_episode_steps;
  float force_max, reward_scale, total_m, pm_l, four_thirds, x_limit,
      th_limit;
};

struct CheetahArgs {
  const float* th; const float* om; const float* vx; const float* pitch;
  const int32_t* t; const float* act;
  const float* rth; const float* rom; const float* rvx; const float* rpi;
  const int32_t* rt; const float* robs;
  float* oth; float* oom; float* ovx; float* opi; int32_t* ot; float* oobs;
  float* orew; uint8_t* odone;
  void* stream;
  int B, max_episode_steps;
  float ctrl_cost, reward_scale;
};

// pendulum: one thread per env; a lane reads its env's row of reset obs
// and writes its row of obs, three floats at a stride of three.
__global__ void __launch_bounds__(kThreads) pendulum_step_kernel(
    const PendulumArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  float th_i = a.th[i], td = a.thdot[i], u = a.act[i];
  const int32_t t_i = a.t[i];
  const float r_th = a.rth[i], r_td = a.rtd[i];
  const int32_t r_t = a.rt[i];
  float r_ob[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) r_ob[c] = a.robs[3 * (size_t)i + c];
  const int32_t nt = t_i + 1;
  const bool done = nt >= a.max_episode_steps;
  u = clip(u, -a.max_torque, a.max_torque);
  float an = angle_norm(th_i);
  float cost = an * an + 0.1f * (td * td) + 0.001f * (u * u);
  td = td + (a.grav_coef * sinf(th_i) + a.torque_coef * u) * 0.05f;
  td = clip(td, -8.0f, 8.0f);
  float nth = th_i + td * 0.05f;
  // -cost times the scale, also where the scale is 1 (exact there), as
  // one multiply by -scale that the compiler cannot turn into a sign flip:
  // a NaN cost then gives the canonical NaN that the plain version's
  // negation gives, where -cost alone flipped the NaN's sign bit
  const float rew = __fmul_rn(cost, -a.reward_scale);
  float ob[3];
  sincosf(nth, &ob[1], &ob[0]);
  ob[2] = td / 8.0f;
  a.oth[i] = done ? r_th : nth;
  a.otd[i] = done ? r_td : td;
  a.ot[i] = done ? r_t : nt;
  a.orew[i] = rew;
  a.odone[i] = done ? 1 : 0;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.oobs[3 * (size_t)i + c] = done ? r_ob[c] : ob[c];
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

// cart-pole: one thread per env; a row of obs and of reset obs is one
// float4 where both arrays are 16-byte aligned (kVec), else four floats.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) cartpole_step_kernel(
    const CartpoleArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  const float a0 = a.act[i];
  const float x_i = a.x[i], xd = a.xdot[i], th_i = a.th[i], td = a.thdot[i];
  const int32_t t_i = a.t[i];
  const float r_x = a.rx[i], r_xd = a.rxd[i], r_th = a.rth[i],
              r_td = a.rtd[i];
  const int32_t r_t = a.rt[i];
  float4 r_ob;
  if (kVec) {
    r_ob = reinterpret_cast<const float4*>(a.robs)[i];
  } else {
    const float* ro = a.robs + 4 * (size_t)i;
    r_ob = make_float4(ro[0], ro[1], ro[2], ro[3]);
  }
  const float nx = x_i + 0.02f * xd;
  const float nth = th_i + 0.02f * td;
  const int32_t nt = t_i + 1;
  const bool fell = (fabsf(nx) > a.x_limit) | (fabsf(nth) > a.th_limit);
  const bool done = fell | (nt >= a.max_episode_steps);
  const float total_m = a.total_m, pm_l = a.pm_l;
  const float force = clip(a0, -1.0f, 1.0f) * a.force_max;
  float sinth, costh;
  sincosf(th_i, &sinth, &costh);
  float temp = (force + pm_l * (td * td) * sinth) / total_m;
  float th_acc = (9.8f * sinth - costh * temp) /
                 (0.5f * (a.four_thirds - 0.1f * (costh * costh) / total_m));
  float x_acc = temp - pm_l * th_acc * costh / total_m;
  const float nxd = xd + 0.02f * x_acc;
  const float ntd = td + 0.02f * th_acc;
  // the control cost takes the unclipped action, as the reference's does
  float rew = 1.0f - 0.01f * (a0 * a0) - (fell ? 1.0f : 0.0f);
  if (a.reward_scale != 1.0f) rew = rew * a.reward_scale;
  a.ox[i] = done ? r_x : nx;
  a.oxd[i] = done ? r_xd : nxd;
  a.oth[i] = done ? r_th : nth;
  a.otd[i] = done ? r_td : ntd;
  a.ot[i] = done ? r_t : nt;
  a.orew[i] = rew;
  a.odone[i] = done ? 1 : 0;
  const float4 ob = done ? r_ob : make_float4(nx, nxd, nth, ntd);
  if (kVec) {
    reinterpret_cast<float4*>(a.oobs)[i] = ob;
  } else {
    float* o = a.oobs + 4 * (size_t)i;
    o[0] = ob.x;
    o[1] = ob.y;
    o[2] = ob.z;
    o[3] = ob.w;
  }
}

template <typename Args>
Args unpack(const void* packed) {
  Args a;
  memcpy(&a, packed, sizeof a);
  return a;
}

}  // namespace

extern "C" int pendulum_args_size() { return (int)sizeof(PendulumArgs); }
extern "C" int cartpole_args_size() { return (int)sizeof(CartpoleArgs); }
extern "C" int cheetah_args_size() { return (int)sizeof(CheetahArgs); }

extern "C" int pendulum_step(const void* packed) {
  const PendulumArgs a = unpack<PendulumArgs>(packed);
  pendulum_step_kernel<<<(a.B + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)a.stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int cartpole_step(const void* packed) {
  const CartpoleArgs a = unpack<CartpoleArgs>(packed);
  const int blocks = (a.B + kThreads - 1) / kThreads;
  const cudaStream_t stream = (cudaStream_t)a.stream;
  if ((((uintptr_t)a.robs | (uintptr_t)a.oobs) & 15u) == 0)
    cartpole_step_kernel<true><<<blocks, kThreads, 0, stream>>>(a);
  else
    cartpole_step_kernel<false><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int cheetah_step(const void* packed) {
  const CheetahArgs a = unpack<CheetahArgs>(packed);
  int blocks = (a.B + kCheetahEnvs - 1) / kCheetahEnvs;
  cheetah_step_kernel<<<blocks, kCheetahThreads, 0,
                        (cudaStream_t)a.stream>>>(
      a.B, a.th, a.om, a.vx, a.pitch, a.t, a.act, a.rth, a.rom, a.rvx,
      a.rpi, a.rt, a.robs, a.oth, a.oom, a.ovx, a.opi, a.ot, a.oobs,
      a.orew, a.odone, a.max_episode_steps, a.ctrl_cost, a.reward_scale);
  return (int)cudaGetLastError();
}
