// The fused random-policy Checkers rollout for Hopper (sm_90a).
//
// Replaces the Pallas kernel of cm3_tpu/ops/checkers_rollout.py
// (pallas_call at :75 in rollout_prng and at :106 in rollout_actions;
// body _body at :40).  One thread runs one instance for the whole
// trajectory with its packed state (cm3_tpu_torch/envs/checkers_packed.py)
// in registers, and writes only its reward sum and episode count.  The
// move is branch-free: a five-entry table in shared memory gives each
// action its edge mask and its two shift counts, so every lane of a warp
// runs the same instructions whatever its action.  The bound and the
// design are in the note of the wrapper's module,
// cm3_tpu_torch/ops/checkers_rollout.py, beside the plain version.
#include <cstdint>

#include <cuda_runtime.h>

#include "occupancy.cuh"
#include "philox.cuh"

namespace {

constexpr int kActions = 5;  // stay, up, down, left, right

// The spec's words, in the order ops/checkers_rollout.py packs them: the
// masks, the start positions, the goal bits and the step cap, then the
// move table, kActions words each: the edge mask of the positions from
// which the action may move, and the counts of its left and right shifts
// (the target is (p << shl) >> shr).
enum SpecWord {
  kGreen, kOrange, kFull, kInit0, kInit1, kGoalGreen, kMaxSteps,
  kEdge, kShl = kEdge + kActions, kShr = kShl + kActions,
  kNumWords = kShr + kActions
};

struct Spec {
  uint32_t green, orange, full;
  uint32_t init[2];
  uint32_t edge[kActions], shl[kActions], shr[kActions];
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
  // the move table, one 16-byte entry per action {edge, shl, shr, 0}:
  // lanes with the same action read the same word (a broadcast), and the
  // five entries lie in distinct banks
  __shared__ uint4 move[kActions];
  if (threadIdx.x < kActions)
    move[threadIdx.x] = make_uint4(s.edge[threadIdx.x], s.shl[threadIdx.x],
                                   s.shr[threadIdx.x], 0u);
  __syncthreads();
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
      const uint4 m = move[a];
      // stay has edge mask 0, so it never moves
      const uint32_t tgt = (p << m.y) >> m.z;
      uint32_t others = 0;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j != i) others |= pos[j];
      const bool can = (p & m.x) != 0 && (tgt & others) == 0;
      const uint32_t np = can ? tgt : p;
      const bool has_g = (np & s.green & ~collected) != 0;
      const bool has_o = (np & s.orange & ~collected) != 0;
      collected |= has_g || has_o ? np : 0u;
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
    // auto-reset
#pragma unroll
    for (int i = 0; i < N; ++i) pos[i] = done ? s.init[i] : pos[i];
    collected = done ? 0u : collected;
    steps = done ? 0 : steps;
  }
  rew_out[b] = rew;
  ep_out[b] = ep;
}

template <int N>
const void* kernel_of(bool fed) {
  return fed ? reinterpret_cast<const void*>(checkers_rollout_kernel<N, true>)
             : reinterpret_cast<const void*>(checkers_rollout_kernel<N, false>);
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

// spec: the kNumWords words of SpecWord, in its order (host memory);
// actions: int32 [n_steps, n_agents, batch] on the device, or null for the
// Philox variant; rew (float32 [batch]) and ep (int32 [batch]) on the
// device.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int cm3_checkers_rollout(const uint32_t* spec, int n_words,
                                    int n_agents, const int32_t* actions,
                                    int batch, int n_steps, uint32_t seed,
                                    float* rew, int32_t* ep, void* stream) {
  if (n_words != kNumWords || n_agents < 1 || n_agents > 2 || batch < 0 ||
      n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Spec s;
  s.green = spec[kGreen];
  s.orange = spec[kOrange];
  s.full = spec[kFull];
  s.init[0] = spec[kInit0];
  s.init[1] = spec[kInit1];
  for (int a = 0; a < kActions; ++a) {
    s.edge[a] = spec[kEdge + a];
    s.shl[a] = spec[kShl + a];
    s.shr[a] = spec[kShr + a];
  }
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

// The occupancy (occupancy.cuh) of the kernel that cm3_checkers_rollout
// launches for n_agents; fed != 0: the fed variant.
extern "C" int cm3_checkers_rollout_occupancy(int n_agents, int fed,
                                              int* out) {
  if (n_agents < 1 || n_agents > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(n_agents == 1 ? kernel_of<1>(fed != 0)
                                        : kernel_of<2>(fed != 0),
                          kThreads, out);
}
