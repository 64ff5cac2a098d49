// The fused random-policy particle rollout for Hopper (sm_90a).
//
// Replaces the Pallas kernel of cm3_tpu/ops/particle_rollout.py
// (pallas_call at :64 in _pallas, for rollout_prng :87 and
// rollout_actions :100; body _body at :35).  One thread runs one instance
// of the struct-of-arrays particle game (cm3_tpu_torch/envs/particle_soa.py)
// for the whole trajectory with its state in registers, and writes only
// its reward sum and episode count.  The bound and the design are in the
// note of the wrapper's module, cm3_tpu_torch/ops/particle_rollout.py,
// beside the plain version.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into a fused multiply-add, and every
// division __fdiv_rn, so each operation rounds as eager PyTorch rounds it;
// sqrtf, expf and log1pf are the CUDA math library's (no fast math), as in
// PyTorch's own CUDA kernels.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxAgents = 4;

// The parameters' floats, in the order ops/particle_rollout.py packs
// them: the constants, then the reset state (soa_init) field by field,
// kMaxAgents values each.
enum ParticleParam {
  kDt, kKeep, kAccel, kContactForce, kMargin, kDmin, kReach,
  kInitPx, kInitPy = kInitPx + kMaxAgents, kInitVx = kInitPy + kMaxAgents,
  kInitVy = kInitVx + kMaxAgents, kLx = kInitVy + kMaxAgents,
  kLy = kLx + kMaxAgents, kNumParams = kLy + kMaxAgents
};

struct Params {
  float dt, keep, accel, contact_force, margin, dmin, reach;
  float px[kMaxAgents], py[kMaxAgents], vx[kMaxAgents], vy[kMaxAgents];
  float lx[kMaxAgents], ly[kMaxAgents];
  int max_steps;
};

constexpr int kThreads = 256;

__device__ __forceinline__ float norm2(float dx, float dy) {
  return sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// N agents; FED reads actions[t, i, b] (int32 [T, N, B]), else each step
// draws Philox4x32-10 with counter (t, b, 0, 0) and key (seed, 0), and
// agent i takes (word i >> 7) % 5.
template <int N, bool FED>
__global__ void __launch_bounds__(kThreads)
particle_rollout_kernel(const Params p, const int32_t* __restrict__ actions,
                        const int batch, const int n_steps,
                        const uint32_t seed, float* __restrict__ rew_out,
                        int32_t* __restrict__ ep_out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  float px[N], py[N], vx[N], vy[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    px[i] = p.px[i];
    py[i] = p.py[i];
    vx[i] = p.vx[i];
    vy[i] = p.vy[i];
  }
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

    // soft-contact force on i from j, from the positions before the move;
    // each unordered pair once: (j, i) is the negation of (i, j) exactly
    float cx[N][N], cy[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        const float dx = __fsub_rn(px[i], px[j]);
        const float dy = __fsub_rn(py[i], py[j]);
        const float dist = norm2(dx, dy);
        const float z = __fdiv_rn(-__fsub_rn(dist, p.dmin), p.margin);
        // logaddexp(0, z) as JAX writes it: max(0, z) + log1p(exp(-|0 - z|))
        const float lae = __fadd_rn(
            fmaxf(0.0f, z), log1pf(expf(-fabsf(__fsub_rn(0.0f, z)))));
        const float pen = __fmul_rn(lae, p.margin);
        const float scale = __fdiv_rn(__fmul_rn(p.contact_force, pen), dist);
        cx[i][j] = __fmul_rn(dx, scale);
        cy[i][j] = __fmul_rn(dy, scale);
        cx[j][i] = -cx[i][j];
        cy[j][i] = -cy[i][j];
      }
    }
    // thrust plus contact forces in index order; damped velocity; move
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int a = act[i];
      float fx = a == 2 ? p.accel : a == 1 ? -p.accel : 0.0f;
      float fy = a == 4 ? p.accel : a == 3 ? -p.accel : 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        fx = __fadd_rn(fx, cx[i][j]);
        fy = __fadd_rn(fy, cy[i][j]);
      }
      vx[i] = __fadd_rn(__fmul_rn(vx[i], p.keep), __fmul_rn(fx, p.dt));
      vy[i] = __fadd_rn(__fmul_rn(vy[i], p.keep), __fmul_rn(fy, p.dt));
      px[i] = __fadd_rn(px[i], __fmul_rn(vx[i], p.dt));
      py[i] = __fadd_rn(py[i], __fmul_rn(vy[i], p.dt));
    }

    // rewards on the new positions: -distance to the own landmark, minus
    // one per agent in collision with it
    bool hit[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        hit[i][j] = norm2(__fsub_rn(px[i], px[j]),
                          __fsub_rn(py[i], py[j])) < p.dmin;
        hit[j][i] = hit[i][j];
      }
    }
    bool all_reached = true;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d_goal = norm2(__fsub_rn(px[i], p.lx[i]),
                                 __fsub_rn(py[i], p.ly[i]));
      all_reached = all_reached && -d_goal >= -p.reach;
      float n_coll = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j != i) n_coll = __fadd_rn(n_coll, hit[i][j] ? 1.0f : 0.0f);
      const float r = __fsub_rn(-d_goal, n_coll);
      sum = i == 0 ? r : __fadd_rn(sum, r);
    }
    rew = __fadd_rn(rew, sum);
    ++steps;
    const bool done = steps == p.max_steps || all_reached;
    ep += done;
    if (done) {  // auto-reset to soa_init
#pragma unroll
      for (int i = 0; i < N; ++i) {
        px[i] = p.px[i];
        py[i] = p.py[i];
        vx[i] = p.vx[i];
        vy[i] = p.vy[i];
      }
      steps = 0;
    }
  }
  rew_out[b] = rew;
  ep_out[b] = ep;
}

template <int N>
void launch(const Params& p, const int32_t* actions, int batch, int n_steps,
            uint32_t seed, float* rew, int32_t* ep, cudaStream_t stream) {
  const dim3 grid((batch + kThreads - 1) / kThreads);
  if (actions != nullptr)
    particle_rollout_kernel<N, true><<<grid, kThreads, 0, stream>>>(
        p, actions, batch, n_steps, seed, rew, ep);
  else
    particle_rollout_kernel<N, false><<<grid, kThreads, 0, stream>>>(
        p, actions, batch, n_steps, seed, rew, ep);
}

}  // namespace

// params: kNumParams floats in ParticleParam's order (host memory);
// n_agents in {1, 2, 4}; actions: int32 [n_steps, n_agents, batch] on the
// device, or null for the Philox variant; rew (float32 [batch]) and ep
// (int32 [batch]) on the device.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int cm3_particle_rollout(const float* params, int n_params,
                                    int n_agents, int max_steps,
                                    const int32_t* actions, int batch,
                                    int n_steps, uint32_t seed, float* rew,
                                    int32_t* ep, void* stream) {
  if (n_params != kNumParams || batch < 0 || n_steps < 0 ||
      (n_agents != 1 && n_agents != 2 && n_agents != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.dt = params[kDt];
  p.keep = params[kKeep];
  p.accel = params[kAccel];
  p.contact_force = params[kContactForce];
  p.margin = params[kMargin];
  p.dmin = params[kDmin];
  p.reach = params[kReach];
  for (int i = 0; i < kMaxAgents; ++i) {
    p.px[i] = params[kInitPx + i];
    p.py[i] = params[kInitPy + i];
    p.vx[i] = params[kInitVx + i];
    p.vy[i] = params[kInitVy + i];
    p.lx[i] = params[kLx + i];
    p.ly[i] = params[kLy + i];
  }
  p.max_steps = max_steps;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_agents == 1)
    launch<1>(p, actions, batch, n_steps, seed, rew, ep, st);
  else if (n_agents == 2)
    launch<2>(p, actions, batch, n_steps, seed, rew, ep, st);
  else
    launch<4>(p, actions, batch, n_steps, seed, rew, ep, st);
  return static_cast<int>(cudaGetLastError());
}
