// The fused random-policy Checkers rollout for Hopper (sm_90a).
//
// Replaces the Pallas kernel of cm3_tpu/ops/checkers_rollout.py
// (pallas_call at :75 in rollout_prng and at :106 in rollout_actions;
// body _body at :40).  One thread runs one instance for the whole
// trajectory with its packed state (cm3_tpu_torch/envs/checkers_packed.py)
// in registers, and writes only its reward sum and episode count.  The
// bound and the design are in the note of the wrapper's module,
// cm3_tpu_torch/ops/checkers_rollout.py, beside the plain version.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

// The spec's words, in the order ops/checkers_rollout.py packs them.
enum SpecWord {
  kWidth, kGreen, kOrange, kFull, kUp, kDown, kLeft, kRight,
  kInit0, kInit1, kGoalGreen, kMaxSteps
};

struct Spec {
  uint32_t width, green, orange, full, up, down, left, right;
  uint32_t init[2];
  float pick_green[2], pick_orange[2];  // pickup reward per agent
  int max_steps;
};

constexpr int kThreads = 256;

// N agents; FED reads actions[t, i, b] (int32 [T, N, B]), else each step
// draws Philox4x32-10 with counter (t, b, 0, 0) and key (seed, 0), and
// agent i takes (word i >> 7) % 5.
template <int N, bool FED>
__global__ void __launch_bounds__(kThreads)
checkers_rollout_kernel(const Spec s, const int32_t* __restrict__ actions,
                        const int batch, const int n_steps,
                        const uint32_t seed, float* __restrict__ rew_out,
                        int32_t* __restrict__ ep_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  uint32_t pos[N];
#pragma unroll
  for (int i = 0; i < N; ++i) pos[i] = s.init[i];
  uint32_t collected = 0;
  int steps = 0, ep = 0;
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
    // agents in index order; agent i sees the new positions of agents < i
    float r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int a = act[i];
      const uint32_t p = pos[i];
      const uint32_t tgt = a == 1 ? p >> s.width
                         : a == 2 ? p << s.width
                         : a == 3 ? p >> 1
                         : a == 4 ? p << 1 : p;
      const uint32_t edge = a == 1 ? p & s.up
                          : a == 2 ? p & s.down
                          : a == 3 ? p & s.left
                          : a == 4 ? p & s.right : 0u;
      uint32_t others = 0;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j != i) others |= pos[j];
      const bool can = a != 0 && edge != 0 && (tgt & others) == 0;
      const uint32_t np = can ? tgt : p;
      const bool has_g = (np & s.green & ~collected) != 0;
      const bool has_o = (np & s.orange & ~collected) != 0;
      if (has_g || has_o) collected |= np;
      // the JAX step's sum (green + orange) + invalid; with 0/1 flags the
      // selects give the same float32 values as its products
      r[i] = ((has_g ? s.pick_green[i] : 0.0f)
              + (has_o ? s.pick_orange[i] : 0.0f))
             + (a != 0 && !can ? -0.1f : 0.0f);
      pos[i] = np;
    }
    float sum = r[0];
#pragma unroll
    for (int i = 1; i < N; ++i) sum = sum + r[i];
    rew = rew + sum;
    ++steps;
    const bool done = steps >= s.max_steps || (collected & s.full) == s.full;
    ep += done;
    if (done) {  // auto-reset
#pragma unroll
      for (int i = 0; i < N; ++i) pos[i] = s.init[i];
      collected = 0;
      steps = 0;
    }
  }
  rew_out[b] = rew;
  ep_out[b] = ep;
}

template <int N>
void launch(const Spec& s, const int32_t* actions, int batch, int n_steps,
            uint32_t seed, float* rew, int32_t* ep, cudaStream_t stream) {
  const dim3 grid((batch + kThreads - 1) / kThreads);
  if (actions != nullptr)
    checkers_rollout_kernel<N, true><<<grid, kThreads, 0, stream>>>(
        s, actions, batch, n_steps, seed, rew, ep);
  else
    checkers_rollout_kernel<N, false><<<grid, kThreads, 0, stream>>>(
        s, actions, batch, n_steps, seed, rew, ep);
}

}  // namespace

// spec: the words of SpecWord, in its order; actions: int32 [n_steps,
// n_agents, batch] on the device, or null for the Philox variant; rew
// (float32 [batch]) and ep (int32 [batch]) on the device.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int cm3_checkers_rollout(const uint32_t* spec, int n_agents,
                                    const int32_t* actions, int batch,
                                    int n_steps, uint32_t seed, float* rew,
                                    int32_t* ep, void* stream) {
  if (n_agents < 1 || n_agents > 2 || batch < 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Spec s;
  s.width = spec[kWidth];
  s.green = spec[kGreen];
  s.orange = spec[kOrange];
  s.full = spec[kFull];
  s.up = spec[kUp];
  s.down = spec[kDown];
  s.left = spec[kLeft];
  s.right = spec[kRight];
  s.init[0] = spec[kInit0];
  s.init[1] = spec[kInit1];
  for (int i = 0; i < 2; ++i) {
    const bool green_goal = (spec[kGoalGreen] >> i) & 1u;
    s.pick_green[i] = green_goal ? 1.0f : -0.5f;
    s.pick_orange[i] = green_goal ? -0.5f : 1.0f;
  }
  s.max_steps = static_cast<int>(spec[kMaxSteps]);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_agents == 1)
    launch<1>(s, actions, batch, n_steps, seed, rew, ep, st);
  else
    launch<2>(s, actions, batch, n_steps, seed, rew, ep, st);
  return static_cast<int>(cudaGetLastError());
}
