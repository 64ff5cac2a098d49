// The fused random-policy particle rollout for Hopper (sm_90a).
//
// Replaces the Pallas kernel of cm3_tpu/ops/particle_rollout.py
// (pallas_call at :64 in _pallas, for rollout_prng :87 and
// rollout_actions :100; body _body at :35).  One thread runs one instance
// of the struct-of-arrays particle game (cm3_tpu_torch/envs/particle_soa.py)
// for the whole trajectory with its state in registers, and writes only
// its reward sum and episode count.  Each step does the work the bound
// counts: a pair's soft-contact term only where its squared distance is
// under far_d2 (beyond it the force is exactly +-0), the collision test as
// a squared distance against hit_d2 (no square root); both thresholds come
// from the host.  The bound and the design are in the note of the
// wrapper's module, cm3_tpu_torch/ops/particle_rollout.py, beside the
// plain version.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into a fused multiply-add, and every
// division __fdiv_rn, so each operation rounds as eager PyTorch rounds it;
// sqrtf, expf and log1pf are the CUDA math library's (no fast math), as in
// PyTorch's own CUDA kernels.
#include <cstdint>

#include <cuda_runtime.h>

#include "occupancy.cuh"
#include "philox.cuh"

// Threads per block and the least number of resident blocks per SM that
// __launch_bounds__ asks for (it caps the registers at 65536 / (threads x
// blocks)).  scripts/torch_particle_variants.py builds other settings with
// -D to time them against each other.
#ifndef CM3_PARTICLE_THREADS
#define CM3_PARTICLE_THREADS 256
#endif
#ifndef CM3_PARTICLE_MIN_BLOCKS
#define CM3_PARTICLE_MIN_BLOCKS 4
#endif

namespace {

constexpr int kMaxAgents = 4;

// The parameters' floats, in the order ops/particle_rollout.py packs
// them: the constants, then the reset state (soa_init) field by field,
// kMaxAgents values each.
enum ParticleParam {
  kDt, kKeep, kAccel, kContactForce, kMargin, kDmin, kReach, kFarD2, kHitD2,
  kInitPx, kInitPy = kInitPx + kMaxAgents, kInitVx = kInitPy + kMaxAgents,
  kInitVy = kInitVx + kMaxAgents, kLx = kInitVy + kMaxAgents,
  kLy = kLx + kMaxAgents, kNumParams = kLy + kMaxAgents
};

struct Params {
  float dt, keep, accel, contact_force, margin, dmin, reach, far_d2, hit_d2;
  float px[kMaxAgents], py[kMaxAgents], vx[kMaxAgents], vy[kMaxAgents];
  float lx[kMaxAgents], ly[kMaxAgents];
  int max_steps;
};

constexpr int kThreads = CM3_PARTICLE_THREADS;

// dx * dx + dy * dy, each operation rounded as the plain version rounds it
__device__ __forceinline__ float sq_norm(float dx, float dy) {
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// N agents; FED reads actions[t, i, b] (int32 [T, N, B]), else each step
// draws Philox4x32-10 with counter (t, b, 0, 0) and key (seed, 0), and
// agent i takes (word i >> 7) % 5.
template <int N, bool FED>
__global__ void __launch_bounds__(kThreads, CM3_PARTICLE_MIN_BLOCKS)
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

    // thrust, then the soft-contact forces from the positions before the
    // move, each unordered pair once in the order (0,1), (0,2), ..., so
    // that every agent adds its contacts in index order as the plain
    // version does ((j, i) is the negation of (i, j) exactly).  A pair
    // at d2 >= far_d2 adds +-0, which leaves fx unchanged (fx is never
    // -0), so it adds nothing.
    float fx[N], fy[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int a = act[i];
      fx[i] = a == 2 ? p.accel : a == 1 ? -p.accel : 0.0f;
      fy[i] = a == 4 ? p.accel : a == 3 ? -p.accel : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        const float dx = __fsub_rn(px[i], px[j]);
        const float dy = __fsub_rn(py[i], py[j]);
        const float d2 = sq_norm(dx, dy);
        if (d2 < p.far_d2) {
          const float dist = sqrtf(d2);
          const float z = __fdiv_rn(-__fsub_rn(dist, p.dmin), p.margin);
          // logaddexp(0, z) as JAX writes it: max(0, z) + log1p(exp(-|0 - z|))
          const float lae = __fadd_rn(
              fmaxf(0.0f, z), log1pf(expf(-fabsf(__fsub_rn(0.0f, z)))));
          const float pen = __fmul_rn(lae, p.margin);
          const float scale = __fdiv_rn(__fmul_rn(p.contact_force, pen), dist);
          const float cx = __fmul_rn(dx, scale);
          const float cy = __fmul_rn(dy, scale);
          fx[i] = __fadd_rn(fx[i], cx);
          fy[i] = __fadd_rn(fy[i], cy);
          fx[j] = __fadd_rn(fx[j], -cx);
          fy[j] = __fadd_rn(fy[j], -cy);
        }
      }
    }
    // damped velocity; move
#pragma unroll
    for (int i = 0; i < N; ++i) {
      vx[i] = __fadd_rn(__fmul_rn(vx[i], p.keep), __fmul_rn(fx[i], p.dt));
      vy[i] = __fadd_rn(__fmul_rn(vy[i], p.keep), __fmul_rn(fy[i], p.dt));
      px[i] = __fadd_rn(px[i], __fmul_rn(vx[i], p.dt));
      py[i] = __fadd_rn(py[i], __fmul_rn(vy[i], p.dt));
    }

    // rewards on the new positions: -distance to the own landmark, minus
    // one per agent in collision with it (sqrt(d2) < dmin is d2 < hit_d2)
    float n_coll[N];
#pragma unroll
    for (int i = 0; i < N; ++i) n_coll[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        const float c = sq_norm(__fsub_rn(px[i], px[j]),
                                __fsub_rn(py[i], py[j])) < p.hit_d2
                            ? 1.0f : 0.0f;
        n_coll[i] = __fadd_rn(n_coll[i], c);
        n_coll[j] = __fadd_rn(n_coll[j], c);
      }
    }
    bool all_reached = true;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d_goal = sqrtf(sq_norm(__fsub_rn(px[i], p.lx[i]),
                                         __fsub_rn(py[i], p.ly[i])));
      all_reached = all_reached && -d_goal >= -p.reach;
      const float r = __fsub_rn(-d_goal, n_coll[i]);
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
const void* kernel_of(bool fed) {
  return fed ? reinterpret_cast<const void*>(particle_rollout_kernel<N, true>)
             : reinterpret_cast<const void*>(particle_rollout_kernel<N, false>);
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
  p.far_d2 = params[kFarD2];
  p.hit_d2 = params[kHitD2];
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

// The occupancy (occupancy.cuh) of the kernel that cm3_particle_rollout
// launches for n_agents; fed != 0: the fed variant.
extern "C" int cm3_particle_rollout_occupancy(int n_agents, int fed,
                                              int* out) {
  if (n_agents != 1 && n_agents != 2 && n_agents != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return kernel_occupancy(n_agents == 1   ? kernel_of<1>(fed != 0)
                          : n_agents == 2 ? kernel_of<2>(fed != 0)
                                          : kernel_of<4>(fed != 0),
                          kThreads, out);
}
