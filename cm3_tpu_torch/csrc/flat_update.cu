// The port's two flat float32 optimizer-tail kernels, for Hopper (sm_90a):
//
//  * B1, cm3_adam_polyak: one Adam step, the parameter apply and the Polyak
//    blend of the target, over up to kMaxSegments networks in one launch
//    (replaces _adam_polyak_flat, cm3_tpu/ops/fused_opt.py:60).  Per element
//      mu' = b1*mu + (1-b1)*g          nu' = b2*nu + ((1-b2)*g)*g
//      p'  = p - lr*((mu'/c1) / (sqrt(nu'/c2) + eps))
//      t'  = tau*p' + (1-tau)*t
//    with each segment's own lr, its bias corrections c1 = 1 - b1^t and
//    c2 = 1 - b2^t of the step t = count + 1 computed in the kernel from
//    the segment's step count in device memory (which the kernel also
//    advances), and tau shared.
//  * B3, cm3_polyak: t <- tau*m + (1-tau)*t over one buffer (replaces
//    _polyak_flat, cm3_tpu/ops/polyak.py:45).
//
// Each B1 segment and the B3 buffer may carry a device predicate (a bool;
// null for none): where it is false the launch writes nothing but B1's
// unchanged count, so an update that a device-side gate turns off (the fill
// chunks of a K-chunk dispatch, an actor while it is frozen) needs no value
// from the host and leaves every buffer and count bit for bit as it was.
// B1 reads a segment's count from one tensor and writes count + (predicate)
// to another, so that no block reads a count that another has written and
// a state that shares the old count keeps it.
//
// Both are streams, 36 and 12 bytes an element, at sizes (1.8-10.4 MB)
// where the launch and the first loads' latency cost as much as the
// traffic.  So each thread of a 128-thread block takes one 16-byte group of
// every operand and issues all its loads before it uses one; the grid has
// a block for every 128 groups (one wave at the main path's sizes, several
// blocks resident on each SM), so the whole working set is in flight at
// once and one warp's division chain overlaps another's loads.  The kernels
// are kept lean, as a short fixed cost is what wins at these sizes: 32-bit
// indices, no grid-stride loop, and the aligned path apart from the
// kernels for any alignment (a view at an odd offset: one float a thread),
// which the host picks at launch.  Segments map to blocks through their
// first_block prefix, so the two critics of a CM3 update take one launch.
// Notes and measurements: cm3_tpu_torch/ops/fused_opt.py and
// cm3_tpu_torch/ops/polyak.py.
//
// Rounding: every product, sum, quotient and root is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: never contracted
// into a fused multiply-add), in the plain versions' order, with their
// constants rounded once from the same doubles, so each kernel equals its
// plain version on the card bit for bit.

#include <cuda_runtime.h>

#include <climits>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSegments = 4;

// the float32 roundings of the Python doubles the plain version multiplies
// and adds by (cm3_tpu_torch/algs/common.py: B1, B2, EPS)
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-8);

struct AdamSegment {
  float* p;
  float* t;
  float* mu;
  float* nu;
  const float* g;
  const int* count;  // the steps taken before this one, in device memory
  int* count_out;    // count + (predicate), written by the first thread
  const bool* pred;  // false: write nothing but count_out; null: always
  int n;             // floats
  float lr;
  int first_block;  // the segment's first block; blocks ascend with segments
};

struct AdamTable {
  AdamSegment seg[kMaxSegments];
  int count;
  float tau, keep;  // keep = 1 - tau, rounded once on the host
  float b1, b2;     // kB1, kB2 as launch arguments: powf of a runtime base,
                    // as PyTorch's torch.pow computes the plain version's
};

struct PolyakSegment {
  float* t;
  const float* m;
  const bool* pred;  // false: write nothing; null: always write
  int n;
  float tau, keep;
};

__device__ __forceinline__ bool off(const bool* pred) {
  return pred != nullptr && !*pred;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// blocks over n floats: one per kThreads 16-byte groups (the n % 4 floats
// after the last group go to the first threads), or one per kThreads floats
// where not every pointer is 16-byte aligned; one at least
int blocks_for(int n, bool vec) {
  const int items = vec ? n / 4 : n;
  const int b = (items + kThreads - 1) / kThreads;
  return b < 1 ? 1 : b;
}

__device__ __forceinline__ void adam1(float& p, float& t, float& m, float& v,
                                      float g, float c1, float c2, float lr,
                                      float tau, float keep) {
  m = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
  v = __fadd_rn(__fmul_rn(kB2, v), __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  const float upd = __fdiv_rn(__fdiv_rn(m, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), kEps));
  p = __fsub_rn(p, __fmul_rn(lr, upd));
  t = __fadd_rn(__fmul_rn(tau, p), __fmul_rn(keep, t));
}

__device__ __forceinline__ float polyak1(float t, float m, float tau,
                                         float keep) {
  return __fadd_rn(__fmul_rn(tau, m), __fmul_rn(keep, t));
}

// The block's segment: the last whose first block it has reached, by
// selects over the table's constant indices (a dynamic index would copy
// the table to local memory).
__device__ __forceinline__ AdamSegment block_segment(const AdamTable& tab) {
  AdamSegment s = tab.seg[0];
#pragma unroll
  for (int k = 1; k < kMaxSegments; ++k)
    if (k < tab.count
        && static_cast<int>(blockIdx.x) >= tab.seg[k].first_block)
      s = tab.seg[k];
  return s;
}

// the thread's index in the blocks from `first_block` on
__device__ __forceinline__ int thread_in(int first_block) {
  return (static_cast<int>(blockIdx.x) - first_block) * kThreads
         + static_cast<int>(threadIdx.x);
}

// The segment's step, as the plain version takes it (algs/common.py:
// advance): its count advanced by the predicate, written once, by the
// segment's first thread; and the bias corrections c1 = 1 - b1^t and
// c2 = 1 - b2^t of the step t = count + 1, each rounded on its own, which
// every thread computes for itself.  False where the predicate turns the
// segment off.
__device__ __forceinline__ bool segment_step(const AdamSegment& s,
                                             const AdamTable& tab, float& c1,
                                             float& c2) {
  const int steps = *s.count;
  const bool live = !off(s.pred);
  if (static_cast<int>(blockIdx.x) == s.first_block && threadIdx.x == 0)
    *s.count_out = steps + (live ? 1 : 0);
  const float t = static_cast<float>(steps + 1);
  c1 = __fsub_rn(1.0f, powf(tab.b1, t));
  c2 = __fsub_rn(1.0f, powf(tab.b2, t));
  return live;
}

__device__ __forceinline__ void adam_scalar(const AdamSegment& s, int i,
                                            float c1, float c2, float tau,
                                            float keep) {
  float p = s.p[i], t = s.t[i], m = s.mu[i], v = s.nu[i];
  adam1(p, t, m, v, s.g[i], c1, c2, s.lr, tau, keep);
  s.p[i] = p;
  s.t[i] = t;
  s.mu[i] = m;
  s.nu[i] = v;
}

// Every pointer 16-byte aligned: a thread takes one float4 of each operand.
__global__ void __launch_bounds__(kThreads)
    adam_polyak_kernel(const AdamTable tab) {
  const AdamSegment s = block_segment(tab);
  const int i = thread_in(s.first_block);
  const int n4 = s.n / 4;
  // all five loads in flight before the count's powers and the first use
  float4 p{}, t{}, m{}, v{}, g{};
  float4* p4 = reinterpret_cast<float4*>(s.p) + i;
  float4* t4 = reinterpret_cast<float4*>(s.t) + i;
  float4* m4 = reinterpret_cast<float4*>(s.mu) + i;
  float4* v4 = reinterpret_cast<float4*>(s.nu) + i;
  if (i < n4) {
    p = *p4;
    t = *t4;
    m = *m4;
    v = *v4;
    g = *(reinterpret_cast<const float4*>(s.g) + i);
  }
  float c1, c2;
  // the whole block: one segment, one predicate
  if (!segment_step(s, tab, c1, c2)) return;
  if (i < n4) {
    adam1(p.x, t.x, m.x, v.x, g.x, c1, c2, s.lr, tab.tau, tab.keep);
    adam1(p.y, t.y, m.y, v.y, g.y, c1, c2, s.lr, tab.tau, tab.keep);
    adam1(p.z, t.z, m.z, v.z, g.z, c1, c2, s.lr, tab.tau, tab.keep);
    adam1(p.w, t.w, m.w, v.w, g.w, c1, c2, s.lr, tab.tau, tab.keep);
    *p4 = p;
    *t4 = t;
    *m4 = m;
    *v4 = v;
  }
  if (i < s.n % 4) adam_scalar(s, n4 * 4 + i, c1, c2, tab.tau, tab.keep);
}

// Any alignment: one float a thread.
__global__ void __launch_bounds__(kThreads)
    adam_polyak_any_kernel(const AdamTable tab) {
  const AdamSegment s = block_segment(tab);
  float c1, c2;
  if (!segment_step(s, tab, c1, c2)) return;
  const int i = thread_in(s.first_block);
  if (i < s.n) adam_scalar(s, i, c1, c2, tab.tau, tab.keep);
}

__global__ void __launch_bounds__(kThreads)
    polyak_kernel(const PolyakSegment s) {
  if (off(s.pred)) return;
  const int i = thread_in(0);
  const int n4 = s.n / 4;
  if (i < n4) {
    float4* t4 = reinterpret_cast<float4*>(s.t) + i;
    float4 t = *t4;
    const float4 m = *(reinterpret_cast<const float4*>(s.m) + i);
    t.x = polyak1(t.x, m.x, s.tau, s.keep);
    t.y = polyak1(t.y, m.y, s.tau, s.keep);
    t.z = polyak1(t.z, m.z, s.tau, s.keep);
    t.w = polyak1(t.w, m.w, s.tau, s.keep);
    *t4 = t;
  }
  if (i < s.n % 4) {
    const int j = n4 * 4 + i;
    s.t[j] = polyak1(s.t[j], s.m[j], s.tau, s.keep);
  }
}

__global__ void __launch_bounds__(kThreads)
    polyak_any_kernel(const PolyakSegment s) {
  if (off(s.pred)) return;
  const int i = thread_in(0);
  if (i < s.n) s.t[i] = polyak1(s.t[i], s.m[i], s.tau, s.keep);
}

}  // namespace

// B1 over `count` (1..4) segments of fewer than 2^31 floats each, in one
// launch on `stream`: ptrs is (p, t, mu, nu, g, step count, new step count,
// pred) per segment (the counts 0-dim int32 tensors in device memory, two
// different ones; pred its device bool predicate or null), n its floats,
// lr its learning rate; keep = 1 - tau rounded once by the caller.  In
// place, but for the count, which goes to the new tensor.
extern "C" int cm3_adam_polyak(int count, void* const* ptrs,
                               const long long* n, const float* lr,
                               float tau, float keep, cudaStream_t stream) {
  if (count < 1 || count > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < count; ++k)
    if (n[k] < 0 || n[k] > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
  bool vec = true;
  for (int k = 0; k < count; ++k)
    for (int j = 0; j < 5; ++j) vec = vec && aligned16(ptrs[8 * k + j]);
  AdamTable tab{};
  tab.count = count;
  tab.tau = tau;
  tab.keep = keep;
  tab.b1 = kB1;
  tab.b2 = kB2;
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    void* const* q = ptrs + 8 * k;
    AdamSegment& s = tab.seg[k];
    s.p = static_cast<float*>(q[0]);
    s.t = static_cast<float*>(q[1]);
    s.mu = static_cast<float*>(q[2]);
    s.nu = static_cast<float*>(q[3]);
    s.g = static_cast<const float*>(q[4]);
    s.count = static_cast<const int*>(q[5]);
    s.count_out = static_cast<int*>(q[6]);
    s.pred = static_cast<const bool*>(q[7]);
    s.n = static_cast<int>(n[k]);
    s.lr = lr[k];
    s.first_block = blocks;
    blocks += blocks_for(s.n, vec);
  }
  if (vec)
    adam_polyak_kernel<<<blocks, kThreads, 0, stream>>>(tab);
  else
    adam_polyak_any_kernel<<<blocks, kThreads, 0, stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

// B3 over one buffer of fewer than 2^31 floats on `stream`, in place on t,
// where the device bool predicate `pred` (null for none) holds.
extern "C" int cm3_polyak(float* t, const float* m, long long n, float tau,
                          float keep, const bool* pred, cudaStream_t stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const PolyakSegment seg{t, m, pred, static_cast<int>(n), tau, keep};
  const bool vec = aligned16(t) && aligned16(m);
  const int blocks = blocks_for(seg.n, vec);
  if (vec)
    polyak_kernel<<<blocks, kThreads, 0, stream>>>(seg);
  else
    polyak_any_kernel<<<blocks, kThreads, 0, stream>>>(seg);
  return static_cast<int>(cudaGetLastError());
}

// registers, resident blocks per SM, threads, local bytes of each aligned
// kernel (the one the main path launches)
extern "C" int cm3_adam_polyak_occupancy(int* out) {
  return kernel_occupancy(reinterpret_cast<const void*>(adam_polyak_kernel),
                          kThreads, out);
}

extern "C" int cm3_polyak_occupancy(int* out) {
  return kernel_occupancy(reinterpret_cast<const void*>(polyak_kernel),
                          kThreads, out);
}
