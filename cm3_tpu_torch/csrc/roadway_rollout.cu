// The fused random-policy roadway rollout for Hopper (sm_90a).
//
// Replaces the Pallas kernel of cm3_tpu/ops/roadway_rollout.py
// (pallas_call at :83 in rollout_prng and at :113 in rollout_actions;
// body _body at :46, done select _select at :37).  One thread runs one
// instance of the struct-of-arrays roadway game
// (cm3_tpu_torch/envs/roadway_soa.py) for the whole trajectory with its
// cars in registers: each step the time-to-collision filter
// (soa_check_actions), the control step (soa_step), then the reset to
// soa_init on done.  It writes only its reward sum and episode count.  The
// bound and the design are in the note of the wrapper's module,
// cm3_tpu_torch/ops/roadway_rollout.py, beside the plain version.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into a fused multiply-add, and every
// division __fdiv_rn, so each operation rounds as eager PyTorch rounds it.
#include <cstdint>

#include <cuda_runtime.h>

#include "occupancy.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxCars = 2;

// The parameters, in the order ops/roadway_rollout.py packs them: the
// config's constants, then per car its goal and its reset state
// (soa_init), kMaxCars values each.
enum RoadwayFloat {
  kDt, kAccVal, kDecVal, kVMax, kVMin, kCarLength, kCarWidth, kTtcThres,
  kSublaneRes, kTotalWidth, kTotalLength, kNearLo, kNearHi, kOverspeed,
  kNSublanesF, kGoalPos, kInitX = kGoalPos + kMaxCars,
  kInitVel = kInitX + kMaxCars, kNumFloats = kInitVel + kMaxCars
};
enum RoadwayInt {
  kNSublanes, kMaxStep, kGoalSub, kInitSub = kGoalSub + kMaxCars,
  kInitSteps = kInitSub + kMaxCars, kInitRem = kInitSteps + kMaxCars,
  kNumInts = kInitRem + kMaxCars
};

enum Action { kNoop, kAcc, kDec, kLeft, kRight };

struct Params {
  float dt, acc_val, dec_val, v_max, v_min, car_length, car_width, ttc_thres;
  float sublane_res, total_width, total_length, near_lo, near_hi, overspeed;
  float n_sublanes_f;
  float goal_pos[kMaxCars], x[kMaxCars], vel[kMaxCars];
  int n_sublanes, max_step;
  int goal_sub[kMaxCars], sub[kMaxCars], steps[kMaxCars], rem[kMaxCars];
};

constexpr int kThreads = 256;

// lateral position of a sublane: sublane_res * sub - total_width
__device__ __forceinline__ float lateral(const Params& p, int sub) {
  return __fsub_rn(__fmul_rn(p.sublane_res, static_cast<float>(sub)),
                   p.total_width);
}

// N cars; FED reads actions[t, i, b] (int32 [T, N, B]), else each step
// draws Philox4x32-10 with counter (t, b, 0, 0) and key (seed, 0), and
// car i takes (word i >> 7) % 5.
template <int N, bool FED>
__global__ void __launch_bounds__(kThreads)
roadway_rollout_kernel(const Params p, const int32_t* __restrict__ actions,
                       const int batch, const int n_steps,
                       const uint32_t seed, float* __restrict__ rew_out,
                       int32_t* __restrict__ ep_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  // the state that reaches an output: x, sublane, velocity, steps, removed
  // (the terminal and collided flags of SoaState never do)
  float x[N], vel[N];
  int sub[N], steps[N];
  bool rem[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = p.x[i];
    vel[i] = p.vel[i];
    sub[i] = p.sub[i];
    steps[i] = p.steps[i];
    rem[i] = p.rem[i] != 0;
  }
  int ep = 0;
  float rew = 0.0f;

#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    int act[N];
    if (FED) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        act[i] = actions[(static_cast<size_t>(t) * N + i) * batch + b];
    } else {
      const Philox4 bits = philox4x32_10(t, b, 0, 0, seed, 0);
#pragma unroll
      for (int i = 0; i < N; ++i)
        act[i] = static_cast<int>((bits.w[i] >> 7) % 5u);
    }

    // --- soa_check_actions: an infeasible action becomes the first
    // feasible one in index order ---
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = lateral(p, sub[i]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      bool danger = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const float dx = __fsub_rn(x[j], x[i]);
        const float rel_v = fmaxf(__fsub_rn(vel[i], vel[j]), 1e-6f);
        const float ttc = __fdiv_rn(__fsub_rn(dx, p.car_length), rel_v);
        danger = danger || (dx > 0.0f && vel[j] < vel[i] &&
                            fabsf(__fsub_rn(y[j], y[i])) < p.car_width &&
                            ttc <= p.ttc_thres && !rem[j]);
      }
      // bit k: action k is feasible (NOOP, ACC, DEC, LEFT, RIGHT)
      const unsigned feas = (!danger ? 1u : 0u)
                          | (vel[i] < p.v_max && !danger ? 2u : 0u)
                          | (vel[i] > p.v_min ? 4u : 0u)
                          | (sub[i] < p.n_sublanes - 1 ? 8u : 0u)
                          | (sub[i] > 1 ? 16u : 0u);
      const unsigned a = static_cast<unsigned>(act[i]);
      if (a > kRight || !((feas >> a) & 1u))
        act[i] = __ffs(feas | 16u) - 1;  // RIGHT when nothing else is
    }

    // --- soa_step: apply controls ---
    bool live[N];
    float ynew[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      live[i] = !rem[i];
      const int a = act[i];
      const float acc = a == kAcc ? p.acc_val : a == kDec ? -p.dec_val : 0.0f;
      const float v = fminf(fmaxf(__fadd_rn(vel[i], __fmul_rn(p.dt, acc)),
                                  0.0f), p.v_max);
      const int dsub = (a == kLeft) - (a == kRight);
      const int sb = min(max(sub[i] + dsub, 0), p.n_sublanes - 1);
      if (live[i]) {
        vel[i] = v;
        sub[i] = sb;
        x[i] = __fadd_rn(x[i], __fmul_rn(v, p.dt));
        ++steps[i];
      }
      ynew[i] = lateral(p, sub[i]);
    }

    // --- pairwise overlap collisions and adjacency flags ---
    bool crashed[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      bool hit = false, on_left = false, on_right = false;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const bool pair = live[i] && live[j];
        hit = hit || (pair && fabsf(__fsub_rn(x[i], x[j])) < p.car_length &&
                      fabsf(__fsub_rn(ynew[i], ynew[j])) < p.car_width);
        const float fwd = __fsub_rn(x[j], x[i]);
        const bool near = pair && fwd > p.near_lo && fwd < p.near_hi;
        const int sd = sub[j] - sub[i];
        on_left = on_left || (near && sd >= 1 && sd <= 2);
        on_right = on_right || (near && sd <= -1 && sd >= -2);
      }
      crashed[i] = hit || (on_left && act[i] == kLeft) ||
                   (on_right && act[i] == kRight);
    }

    // --- rewards, terminals, removal ---
    bool episode_crash = false, term[N];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int delta = p.goal_sub[i] - sub[i];
      const float dist = __fdiv_rn(__fsub_rn(p.goal_pos[i], x[i]),
                                   p.total_length);
      const bool at_goal = dist <= 0.0f;
      const bool timed_out = steps[i] >= p.max_step;
      const float r_goal =
          delta == 0 ? 10.0f
                     : __fmul_rn(10.0f, __fsub_rn(1.0f, __fdiv_rn(
                           static_cast<float>(abs(delta)), p.n_sublanes_f)));
      float r = crashed[i] ? -1.0f
              : at_goal    ? r_goal
              : timed_out  ? -10.0f : 0.0f;
      r = __fsub_rn(r, __fmul_rn(0.1f, vel[i] >= p.overspeed ? 1.0f : 0.0f));
      r = live[i] ? r : 0.0f;
      sum = i == 0 ? r : __fadd_rn(sum, r);
      term[i] = live[i] && (crashed[i] || at_goal || timed_out);
      episode_crash = episode_crash || (live[i] && crashed[i]);
    }
    rew = __fadd_rn(rew, sum);
    bool done = true;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      rem[i] = rem[i] || term[i] || episode_crash;
      done = done && rem[i];
    }
    ep += done;
    if (done) {  // auto-reset to soa_init
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = p.x[i];
        vel[i] = p.vel[i];
        sub[i] = p.sub[i];
        steps[i] = p.steps[i];
        rem[i] = p.rem[i] != 0;
      }
    }
  }
  rew_out[b] = rew;
  ep_out[b] = ep;
}

template <int N>
const void* kernel_of(bool fed) {
  return fed ? reinterpret_cast<const void*>(roadway_rollout_kernel<N, true>)
             : reinterpret_cast<const void*>(roadway_rollout_kernel<N, false>);
}

template <int N>
void launch(const Params& p, const int32_t* actions, int batch, int n_steps,
            uint32_t seed, float* rew, int32_t* ep, cudaStream_t stream) {
  const dim3 grid((batch + kThreads - 1) / kThreads);
  if (actions != nullptr)
    roadway_rollout_kernel<N, true><<<grid, kThreads, 0, stream>>>(
        p, actions, batch, n_steps, seed, rew, ep);
  else
    roadway_rollout_kernel<N, false><<<grid, kThreads, 0, stream>>>(
        p, actions, batch, n_steps, seed, rew, ep);
}

}  // namespace

// floats / ints: kNumFloats and kNumInts values in RoadwayFloat's and
// RoadwayInt's order (host memory); n_agents in {1, 2}; actions: int32
// [n_steps, n_agents, batch] on the device, or null for the Philox
// variant; rew (float32 [batch]) and ep (int32 [batch]) on the device.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int cm3_roadway_rollout(const float* floats, int n_floats,
                                   const int32_t* ints, int n_ints,
                                   int n_agents, const int32_t* actions,
                                   int batch, int n_steps, uint32_t seed,
                                   float* rew, int32_t* ep, void* stream) {
  if (n_floats != kNumFloats || n_ints != kNumInts || batch < 0 ||
      n_steps < 0 || n_agents < 1 || n_agents > kMaxCars)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.dt = floats[kDt];
  p.acc_val = floats[kAccVal];
  p.dec_val = floats[kDecVal];
  p.v_max = floats[kVMax];
  p.v_min = floats[kVMin];
  p.car_length = floats[kCarLength];
  p.car_width = floats[kCarWidth];
  p.ttc_thres = floats[kTtcThres];
  p.sublane_res = floats[kSublaneRes];
  p.total_width = floats[kTotalWidth];
  p.total_length = floats[kTotalLength];
  p.near_lo = floats[kNearLo];
  p.near_hi = floats[kNearHi];
  p.overspeed = floats[kOverspeed];
  p.n_sublanes_f = floats[kNSublanesF];
  p.n_sublanes = ints[kNSublanes];
  p.max_step = ints[kMaxStep];
  for (int i = 0; i < kMaxCars; ++i) {
    p.goal_pos[i] = floats[kGoalPos + i];
    p.x[i] = floats[kInitX + i];
    p.vel[i] = floats[kInitVel + i];
    p.goal_sub[i] = ints[kGoalSub + i];
    p.sub[i] = ints[kInitSub + i];
    p.steps[i] = ints[kInitSteps + i];
    p.rem[i] = ints[kInitRem + i];
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_agents == 1)
    launch<1>(p, actions, batch, n_steps, seed, rew, ep, st);
  else
    launch<2>(p, actions, batch, n_steps, seed, rew, ep, st);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy (occupancy.cuh) of the kernel that cm3_roadway_rollout
// launches for n_agents; fed != 0: the fed variant.
extern "C" int cm3_roadway_rollout_occupancy(int n_agents, int fed,
                                             int* out) {
  if (n_agents < 1 || n_agents > kMaxCars)
    return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(n_agents == 1 ? kernel_of<1>(fed != 0)
                                        : kernel_of<2>(fed != 0),
                          kThreads, out);
}
