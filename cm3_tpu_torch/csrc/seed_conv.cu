// The seed-stacked convolution of the port's conv nets, for Hopper (sm_90a):
// S seeds' own convolutions over their own rows in one launch each way.
//
//  * cm3_seed_conv_forward: out[s, r, (h*W + w)*F + f] = relu(b[s, f]
//      + sum_{c,i,j} x[s, r, h+i-ph, w+j-pw, c] * w[s, f, c, i, j])
//    with x NHWC [S, R, H, W, C], zero "same" padding (ph = (kh-1)/2,
//    pw = (kw-1)/2, as nn.Conv2d(padding="same") pads an odd kernel), and
//    the output written in the (H, W, F) flatten order of
//    models/nets.py:_relu_flat_conv: one launch in place of a permute copy,
//    a grouped convolution, the ReLU and a second permute copy.
//  * cm3_seed_conv_wgrad: dw[s, f, c, i, j] and db[s, f] from the output's
//    gradient g, the saved output y (ReLU's mask, y > 0, read as ReLU's own
//    backward reads it: a NaN passes) and the saved input x, every seed in
//    two launches: partial sums over slices of a seed's R*H*W positions,
//    then their sum in a fixed order.  The input gradient is never formed
//    (every conv of the port reads observations or state grids).
//
// No Pallas kernel of cm3_tpu is replaced: the JAX package leaves this
// convolution to XLA.  It was added because the port's seed axis
// (torch.func.vmap over nets.SeedStack) made every conv one cuDNN grouped
// convolution with groups = S, whose weight gradient took most of a
// 256-seed update's device time (PERF.md).
//
// What bounds it.  The convs are tiny (2-3 input channels, 2-8 filters,
// 3x3 to 5x3 taps), so each pass reads its operands once and does 120-162
// multiply-adds per position: bound by memory traffic.  Design:
//  * forward: a block of kSlicePositions positions of one seed; the seed's
//    filters and bias sit in shared memory, transposed so one tap's F
//    weights are adjacent (every thread reads the same tap at once: a
//    broadcast), and so do the whole images the block's positions lie in
//    (read once, coalesced); each thread makes two positions' F outputs
//    in registers (F is a template parameter; the two positions kThreads
//    apart share each weight read) and stores each as F adjacent floats,
//    so a warp stores 32*F contiguous floats at a time.
//  * weight gradient: a block of 8 warps sums one slice of kSlicePositions
//    positions of one seed.  It first copies the slice's images and its
//    masked output gradient (ReLU's mask applied once) into shared memory,
//    coalesced.  A lane owns one tap (c, i, j), the bias being the last
//    tap with x = 1, and its F sums; the warp's lanes read the same
//    position's F masked gradients (a broadcast) and their own window
//    value, and the 8 warps take every 8th position, stepping its row and
//    column without a division.  The warps' sums are added in warp order
//    through shared memory, the slices' sums by the second kernel in slice
//    order: no float atomics, so a seed's gradient is the same bits in every
//    run.  The number of slices comes from the seed's own R*H*W alone, never
//    from S, so a seed's gradient is the same bits whether 1 or 256 seeds
//    run beside it, and one seed's reduction still spreads over
//    ceil(R*H*W / 512) blocks.
//  * Both hold whole images of the input in shared memory, and the forward
//    its seed's filters (kTiled true): (512 + 2*H*W)*C floats within
//    kTileFloats and C*kh*kw within kMaxTaps, where every conv of the port
//    lies with room (at most 1,686 floats of 4,096).  Larger images, or
//    more taps, take the same kernels with kTiled false, which read both
//    from global memory through the caches: the same sums in the same
//    order.
//  * A launch takes 1 to kMaxFilters filters (a template parameter); the
//    wrapper (ops/seed_conv.py) runs more in groups of kMaxFilters.
//
// The wrapper reads kMaxFilters, kSlicePositions and kMaxSeeds from this
// file, so these constants are the one place they are set.
//
// Precision: float32 throughout, products and sums in float32 (fused
// multiply-adds), no TF32.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFilters = 8;         // F: a template parameter, 1-8
constexpr int kMaxTaps = 256;          // C * kh * kw
constexpr int kSlicePositions = 512;   // positions of one seed a block sums
// floats of the input a block holds: the images its positions lie in
constexpr int kTileFloats = 4096;
constexpr int kMaxSeeds = 65535;       // the grid's y dimension

// kTiled: the seed's filters and the block's images in shared memory;
// otherwise both are read from global memory
template <int F, bool kTiled>
__global__ void __launch_bounds__(kThreads)
seed_conv_forward_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, long long w_stride,
                         const float* __restrict__ b, long long b_stride,
                         float* __restrict__ out, int R, int H, int W, int C,
                         int kh, int kw) {
  __shared__ float sw[kTiled ? kMaxTaps * kMaxFilters : 1];   // [tap][F]
  __shared__ float sb[kMaxFilters];
  // the images the positions lie in
  __shared__ float sx[kTiled ? kTileFloats : 1];
  const int s = blockIdx.y;
  const int taps = C * kh * kw;
  const float* ws = w + s * w_stride;
  if constexpr (kTiled) {
    for (int k = threadIdx.x; k < taps * F; k += kThreads) {
      const int f = k / taps;
      sw[(k - f * taps) * F + f] = ws[k];
    }
  }
  if (threadIdx.x < F) sb[threadIdx.x] = b[s * b_stride + threadIdx.x];
  const int hw = H * W, n = R * hw;
  const int p0 = blockIdx.x * kSlicePositions;
  const int first = p0 / hw * hw;
  const float* xg = x + (static_cast<size_t>(s) * n + first) * C;
  if constexpr (kTiled) {
    const int tile =
        ((min(p0 + kSlicePositions, n) - 1) / hw + 1) * hw - first;
    for (int k = threadIdx.x; k < tile * C; k += kThreads) sx[k] = xg[k];
  }
  __syncthreads();
  // two positions a thread, kThreads apart (a warp's stay adjacent); the
  // second repeats the first past the end
  const int pa = p0 + threadIdx.x;
  if (pa >= n) return;
  const bool two = pa + kThreads < n;
  const int pb = two ? pa + kThreads : pa;
  const int qa = pa - first, ra = qa / hw, ha = (qa - ra * hw) / W;
  const int ca = qa - ra * hw - ha * W;
  const int qb = pb - first, rb = qb / hw, hb = (qb - rb * hw) / W;
  const int cb = qb - rb * hw - hb * W;
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2, khw = kh * kw;
  const float* xt = kTiled ? sx : xg;
  const float* xa = xt + ra * hw * C;
  const float* xb = xt + rb * hw * C;
  float acc_a[F], acc_b[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc_a[f] = acc_b[f] = 0.f;
  for (int i = 0; i < kh; ++i) {
    const int ya = ha + i - ph, yb = hb + i - ph;
    for (int j = 0; j < kw; ++j) {
      const int za = ca + j - pw, zb = cb + j - pw;
      // a tap outside the image adds nothing (it is skipped, as before)
      const bool ina = ya >= 0 && ya < H && za >= 0 && za < W;
      const bool inb = yb >= 0 && yb < H && zb >= 0 && zb < W;
      const int tap = i * kw + j;
      for (int c = 0; c < C; ++c) {
        const float va = ina ? xa[(ya * W + za) * C + c] : 0.f;
        const float vb = inb ? xb[(yb * W + zb) * C + c] : 0.f;
        const int t = c * khw + tap;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float wf = kTiled ? sw[t * F + f] : ws[f * taps + t];
          if (ina) acc_a[f] = fmaf(va, wf, acc_a[f]);
          if (inb) acc_b[f] = fmaf(vb, wf, acc_b[f]);
        }
      }
    }
  }
  float* oa = out + (static_cast<size_t>(s) * n + pa) * F;
  float* ob = out + (static_cast<size_t>(s) * n + pb) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float ya = acc_a[f] + sb[f], yb = acc_b[f] + sb[f];
    oa[f] = (ya <= 0.f) ? 0.f : ya;   // a NaN passes, as in torch.relu
    if (two) ob[f] = (yb <= 0.f) ? 0.f : yb;
  }
}

// partial[s, slice, t, f] for the taps t = (c*kh + i)*kw + j and the bias
// (t = C*kh*kw); kTiled: the slice's images in shared memory
template <int F, bool kTiled>
__global__ void __launch_bounds__(kThreads)
seed_conv_wgrad_partial_kernel(const float* __restrict__ g,
                               const float* __restrict__ y,
                               const float* __restrict__ x,
                               float* __restrict__ partial, int R, int H,
                               int W, int C, int kh, int kw, int slices) {
  // the images the slice lies in
  __shared__ float sx[kTiled ? kTileFloats : 1];
  __shared__ float sd[kSlicePositions * F];   // masked gradient [pos][F]
  __shared__ float red[kThreads * F];   // [warp][lane][F]
  const int s = blockIdx.y, slice = blockIdx.x;
  const int hw = H * W, n = R * hw;
  const int khw = kh * kw, taps = C * khw + 1;
  const int ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int begin = slice * kSlicePositions;
  const int end = min(begin + kSlicePositions, n);
  const int first = begin / hw * hw;
  const size_t seed = static_cast<size_t>(s) * n;
  const float* xg = x + (seed + first) * C;
  if constexpr (kTiled) {
    const int tile = ((end - 1) / hw + 1) * hw - first;
    for (int k = threadIdx.x; k < tile * C; k += kThreads) sx[k] = xg[k];
  }
  const float* xt = kTiled ? sx : xg;
  const float* gs = g + (seed + begin) * F;
  const float* ys = y + (seed + begin) * F;
  for (int k = threadIdx.x; k < (end - begin) * F; k += kThreads)
    sd[k] = (ys[k] <= 0.f) ? 0.f : gs[k];   // a NaN output passes g
  __syncthreads();
  float* ps = partial + (static_cast<size_t>(s) * slices + slice) * taps * F;
  for (int t0 = 0; t0 < taps; t0 += 32) {
    const int t = t0 + lane;
    const bool bias = t == taps - 1, tap = t < taps - 1;
    const int c = t / khw, i = (t - c * khw) / kw - ph, j = t % kw - pw;
    // the tap's input at position p lies at (p + i*W + j)*C + c
    const int shift = (i * W + j) * C + c;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    // the position's row and column, stepped without a division
    int p = begin + warp;
    const int r0 = p / hw;
    int h = (p - r0 * hw) / W, col = p - r0 * hw - h * W;
    for (; p < end; p += kWarps) {
      float xv = bias ? 1.f : 0.f;
      if (tap && h + i >= 0 && h + i < H && col + j >= 0 && col + j < W)
        xv = xt[(p - first) * C + shift];
      const float* d = sd + (p - begin) * F;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(d[f], xv, acc[f]);
      col += kWarps;
      while (col >= W) {
        col -= W;
        if (++h == H) h = 0;
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) red[threadIdx.x * F + f] = acc[f];
    __syncthreads();
    for (int k = threadIdx.x; k < 32 * F; k += kThreads) {
      float sum = red[k];
      for (int q = 1; q < kWarps; ++q) sum += red[q * 32 * F + k];
      if (t0 + k / F < taps) ps[t0 * F + k] = sum;
    }
    __syncthreads();
  }
}

// dw[s, f, t] (t over C*kh*kw) and db[s, f]: the slices' partial sums
// added in slice order, one thread a sum
__global__ void __launch_bounds__(kThreads)
seed_conv_wgrad_sum_kernel(const float* __restrict__ partial,
                           float* __restrict__ dw, float* __restrict__ db,
                           int S, int F, int taps, int slices) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= S * F * taps) return;
  const int s = k / (F * taps), rest = k - s * F * taps;
  const int f = rest / taps, t = rest - f * taps;
  const float* p = partial + static_cast<size_t>(s) * slices * taps * F
                   + t * F + f;
  float sum = p[0];
  for (int q = 1; q < slices; ++q) sum += p[static_cast<size_t>(q) * taps * F];
  if (t == taps - 1)
    db[s * F + f] = sum;
  else
    dw[(static_cast<size_t>(s) * F + f) * (taps - 1) + t] = sum;
}

// what the kernels take: the wrapper (ops/seed_conv.py:check) refuses the
// rest before it calls
bool valid(int S, int R, int H, int W, int C, int F, int kh, int kw) {
  if (S < 1 || S > kMaxSeeds || R < 1 || H < 1 || W < 1 || C < 1 || F < 1 ||
      F > kMaxFilters || kh < 1 || kw < 1)
    return false;
  const long long taps = static_cast<long long>(C) * kh * kw + 1;
  const long long rows = static_cast<long long>(S) * R * H * W;
  return rows * (C > F ? C : F) <= INT_MAX && S * taps * F <= INT_MAX;
}

// whether the forward's filters and images fit its shared memory, and the
// weight gradient's images fit its own
bool forward_tiled(int H, int W, int C, int kh, int kw) {
  return C * kh * kw <= kMaxTaps &&
         (kSlicePositions + 2LL * H * W) * C <= kTileFloats;
}
bool partial_tiled(int H, int W, int C) {
  return (kSlicePositions + 2LL * H * W) * C <= kTileFloats;
}

// fn(std::integral_constant<int, F>) for the launch's filter count f
template <int F = 1, class Fn>
void with_filters(int f, Fn&& fn) {
  if constexpr (F <= kMaxFilters) {
    if (f == F)
      fn(std::integral_constant<int, F>{});
    else
      with_filters<F + 1>(f, fn);
  }
}

// the forward (which 0) or the partial sums (1), for the occupancy report
template <int F, bool kTiled>
const void* kernel_of(int which) {
  if (which == 0)
    return reinterpret_cast<const void*>(seed_conv_forward_kernel<F, kTiled>);
  return reinterpret_cast<const void*>(
      seed_conv_wgrad_partial_kernel<F, kTiled>);
}

}  // namespace

// x [S, R, H, W, C] contiguous; w [S, F, C, kh, kw] and b [S, F], each
// seed's block contiguous at w + s*w_stride and b + s*b_stride (a row of a
// seed stack's flat buffer, or stride 0 for one network shared by every
// seed); out [S, R, H*W*F].
extern "C" int cm3_seed_conv_forward(const float* x, const float* w,
                                     long long w_stride, const float* b,
                                     long long b_stride, float* out, int S,
                                     int R, int H, int W, int C, int F,
                                     int kh, int kw, cudaStream_t stream) {
  if (!valid(S, R, H, W, C, F, kh, kw) || w_stride < 0 || b_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R * H * W + kSlicePositions - 1) / kSlicePositions, S);
  const bool tiled = forward_tiled(H, W, C, kh, kw);
  with_filters(F, [&](auto f) {
    constexpr int Fc = decltype(f)::value;
    if (tiled)
      seed_conv_forward_kernel<Fc, true><<<grid, kThreads, 0, stream>>>(
          x, w, w_stride, b, b_stride, out, R, H, W, C, kh, kw);
    else
      seed_conv_forward_kernel<Fc, false><<<grid, kThreads, 0, stream>>>(
          x, w, w_stride, b, b_stride, out, R, H, W, C, kh, kw);
  });
  return static_cast<int>(cudaGetLastError());
}

// g and y [S, R, H*W*F], x [S, R, H, W, C], all contiguous; partial
// [S, slices, C*kh*kw + 1, F] scratch with slices = ceil(R*H*W /
// kSlicePositions); dw [S, F, C, kh, kw] and db [S, F] contiguous.
extern "C" int cm3_seed_conv_wgrad(const float* g, const float* y,
                                   const float* x, float* partial, float* dw,
                                   float* db, int S, int R, int H, int W,
                                   int C, int F, int kh, int kw, int slices,
                                   cudaStream_t stream) {
  if (!valid(S, R, H, W, C, F, kh, kw) ||
      slices != (R * H * W + kSlicePositions - 1) / kSlicePositions)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(slices, S);
  const bool tiled = partial_tiled(H, W, C);
  with_filters(F, [&](auto f) {
    constexpr int Fc = decltype(f)::value;
    if (tiled)
      seed_conv_wgrad_partial_kernel<Fc, true><<<grid, kThreads, 0, stream>>>(
          g, y, x, partial, R, H, W, C, kh, kw, slices);
    else
      seed_conv_wgrad_partial_kernel<Fc, false><<<grid, kThreads, 0, stream>>>(
          g, y, x, partial, R, H, W, C, kh, kw, slices);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int taps = C * kh * kw + 1;
  const int blocks = (S * F * taps + kThreads - 1) / kThreads;
  seed_conv_wgrad_sum_kernel<<<blocks, kThreads, 0, stream>>>(
      partial, dw, db, S, F, taps, slices);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 the forward, 1 the partial sums, 2 their sum; F the filters;
// tiled: the variant that holds its operands in shared memory
extern "C" int cm3_seed_conv_occupancy(int which, int F, int tiled,
                                       int* out) {
  if (which < 0 || which > 2 || F < 1 || F > kMaxFilters)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      reinterpret_cast<const void*>(seed_conv_wgrad_sum_kernel);
  with_filters(F, [&](auto f) {
    constexpr int Fc = decltype(f)::value;
    if (which < 2)
      kernel = tiled ? kernel_of<Fc, true>(which) : kernel_of<Fc, false>(which);
  });
  return kernel_occupancy(kernel, kThreads, out);
}
