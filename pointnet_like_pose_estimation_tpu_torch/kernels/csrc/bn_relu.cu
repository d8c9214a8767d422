// BatchNorm followed by ReLU over channels-last [R, C] float32, for Hopper
// (sm_90a): in train mode forward and backward; in eval mode one forward
// pass, one that also takes the max over each group of rows (below,
// "Eval mode"), and one that forms its input by a gather (below,
// "Gathered eval mode").
//
// Replaces no TPU kernel. On the TPU, XLA fused the JAX package's
// train-mode BatchNorm (nn/layers.py batch_norm_f32) and the ReLU after it
// into the neighbouring ops. On the card PyTorch ran them as its own passes
// (var_mean, three broadcast passes, the ReLU, and the backward of each),
// some ten reads and writes of every activation of a shared MLP.
//
// What it computes, from the mean and the biased variance var of each
// channel over the R rows (torch.var_mean, the plain pair's own reduction;
// see below), with rstd = rsqrt(var + eps) and scale = rstd * w:
//
//   forward   y  = max((x - mean) * scale + b, 0)
//             running_mean = running_mean * (1 - momentum) + mean * momentum
//             running_var  = running_var  * (1 - momentum) + var  * momentum
//   backward  g  = dy where (x - mean) * scale + b > 0, else 0
//             xh = (x - mean) * rstd
//             grad_b = sum g,  grad_w = sum g * xh   (over the rows)
//             dx = scale * ((g - grad_b / R) - xh * (grad_w / R))
//
// The backward forms the ReLU's mask from x, mean and rstd as the forward
// formed it, bit for bit, so nothing but x, mean and rstd is kept between
// the two.
//
// The forward equals the plain pair (torch.relu of nn/layers.py
// BatchNormF32) bit for bit: the same statistics, and every later step
// rounded as PyTorch's kernels round it (the subtraction, the product and
// the sum each on their own; -fmad=false, kernels/_build.py, contracts
// nothing). A PointNet++ train step turns any other rounding of the
// forward into other ReLU masks and other winners of the max over a group,
// and Adam's first steps, which follow the sign of each gradient element,
// carry those on: a statistics pass of this file's own (Welford's update in
// a thread, Chan's merge between threads and blocks) parted the loss after
// three steps at batch 256 by up to 3.0e-3 from the plain pair's, and
// another rounding of the plain pair's own variance by 4.2e-3, where a
// different backward alone parted it by 7e-5 (PERF.md). So the statistics
// are the plain pair's.
//
// What bounds it: device memory. Each element costs a few flops against 4
// bytes a pass. Two kernels forward after torch.var_mean, three backward:
//
//   forward:  (torch.var_mean: read x) -> scale ([C]) -> apply (read x, write y)
//   backward: grad_sums (read x, dy) -> finish_grad (the partials) -> grad_input (read x, dy, write dx)
//
// so an activation is read three times and written twice, x kept in place.
// The design keeps the passes at the rate of device memory:
//
// - A block is 256 threads. tpr = min(C / 4, 256) threads span a row, one
//   16-byte column group (4 channels) each, and rpi = 256 / tpr rows go at
//   once: one step of a block reads rpi whole rows, contiguous. blockIdx.y
//   picks the chunk of 256 column groups where C > 1024. A thread keeps
//   its four channels' sums and constants in registers for the whole of
//   its block's rows.
// - At most kMaxRowBlocks (four of 256 threads on each of the 132 SMs)
//   row blocks, each a slab of contiguous rows; a thread issues several
//   16-byte loads of each input before it uses them, so that enough bytes
//   are in flight to cover the latency of device memory.
// - No float atomics: the threads of a block add in a fixed tree through
//   shared memory, each block writes one partial per channel to a scratch
//   tensor, and a second small kernel adds the partials in a fixed order
//   (one warp a channel: lane l the partials l, l + 32, ... in order, then a
//   shuffle tree). The same inputs give the same bits, so a CUDA graph's
//   replay computes what its eager step computed.
// - Offsets are formed in 64 bits: R * C passes 2^31 at the model's shapes
//   at batch 256.
// - Every launch goes on the caller's stream; the scratch is the caller's
//   (torch.empty), so the passes capture into a CUDA graph.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 4 * 132;
constexpr int kUnrollOne = 4;   // loads in flight a thread, one input
constexpr int kUnrollTwo = 2;   // of each input, two inputs

struct Geometry {
  int64_t rows;    // R
  int channels;    // C
  int groups;      // C / 4
  int tpr;         // threads a row
  int rpi;         // rows a block takes at once
  int64_t slab;    // rows a block, a multiple of rpi
  int blocks;      // row blocks
  int chunks;      // column chunks (gridDim.y)
};

// The same rule as kernels/bn_relu.py bn_relu_plan.
bool make_geometry(int64_t R, int C, Geometry* g) {
  if (R <= 0 || C <= 0 || C % 4 != 0) return false;
  g->rows = R;
  g->channels = C;
  g->groups = C / 4;
  g->tpr = g->groups < kThreads ? g->groups : kThreads;
  g->rpi = kThreads / g->tpr;
  g->chunks = (g->groups + g->tpr - 1) / g->tpr;
  const int64_t steps = (R + g->rpi - 1) / g->rpi;
  const int64_t blocks = steps < kMaxRowBlocks ? steps : kMaxRowBlocks;
  int64_t slab = (R + blocks - 1) / blocks;
  slab = (slab + g->rpi - 1) / g->rpi * g->rpi;
  g->slab = slab;
  g->blocks = static_cast<int>((R + slab - 1) / slab);
  return true;
}

// Where a thread sits: its row offset in the block's step, its column
// group, and the rows of its block.
struct Place {
  int ty;
  int cg;
  bool active;
  int64_t r0, r1;
};

__device__ __forceinline__ Place place_of(const Geometry& g) {
  Place p;
  p.ty = threadIdx.x / g.tpr;
  p.cg = blockIdx.y * g.tpr + (threadIdx.x - p.ty * g.tpr);
  p.active = p.ty < g.rpi && p.cg < g.groups;
  p.r0 = static_cast<int64_t>(blockIdx.x) * g.slab;
  const int64_t end = p.r0 + g.slab;
  p.r1 = end < g.rows ? end : g.rows;
  return p;
}

__device__ __forceinline__ float4 load4(const float* base, int64_t row, const Geometry& g, int cg) {
  return __ldg(reinterpret_cast<const float4*>(base + row * g.channels) + cg);
}

__device__ __forceinline__ void store4(float* base, int64_t row, const Geometry& g, int cg, float4 v) {
  reinterpret_cast<float4*>(base + row * g.channels)[cg] = v;
}

__device__ __forceinline__ float at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 make4(const float* v) { return make_float4(v[0], v[1], v[2], v[3]); }

// Four channels' constants of a column group, read once a thread.
__device__ __forceinline__ void load_channels(const float* v, int cg, float* out) {
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = __ldg(v + 4 * cg + c);
}

// One thread a channel, from the plain pair's own mean and biased
// variance: rstd = rsqrt(var + eps) and scale = rstd * w, each rounded as
// torch.rsqrt and the product round them, and the running statistics
// updated in place as BatchNormF32 updates them.
__global__ void __launch_bounds__(kThreads) bn_relu_scale_kernel(
    const float* __restrict__ mean, const float* __restrict__ var, const float* __restrict__ weight,
    float* __restrict__ running_mean, float* __restrict__ running_var, float* __restrict__ rstd_out,
    float* __restrict__ scale_out, int C, float keep, float momentum, float eps) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float rstd = rsqrtf(var[c] + eps);
  rstd_out[c] = rstd;
  scale_out[c] = rstd * weight[c];
  running_mean[c] = running_mean[c] * keep + mean[c] * momentum;
  running_var[c] = running_var[c] * keep + var[c] * momentum;
}

__global__ void __launch_bounds__(kThreads) bn_relu_apply_kernel(const float* __restrict__ x,
                                                                 float* __restrict__ y,
                                                                 const float* __restrict__ mean,
                                                                 const float* __restrict__ scale,
                                                                 const float* __restrict__ bias, Geometry g) {
  const Place p = place_of(g);
  if (!p.active) return;
  float m[4], s[4], b[4];
  load_channels(mean, p.cg, m);
  load_channels(scale, p.cg, s);
  load_channels(bias, p.cg, b);
  auto one = [&](const float4& v) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t = (at(v, c) - m[c]) * s[c] + b[c];
      o[c] = t != t ? t : fmaxf(t, 0.0f);  // torch.relu's clamp: NaN passes
    }
    return make4(o);
  };
  int64_t r = p.r0 + p.ty;
  for (; r + (kUnrollOne - 1) * g.rpi < p.r1; r += kUnrollOne * g.rpi) {
    float4 v[kUnrollOne];
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) v[u] = load4(x, r + u * g.rpi, g, p.cg);
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) store4(y, r + u * g.rpi, g, p.cg, one(v[u]));
  }
  for (; r < p.r1; r += g.rpi) store4(y, r, g, p.cg, one(load4(x, r, g, p.cg)));
}

// ---- backward ----------------------------------------------------------

// What the two backward passes share: a thread's four channels' mean,
// rstd, scale = rstd * w (the forward's bits) and bias.
struct Channels {
  float m[4], r[4], s[4], b[4];
};

__device__ __forceinline__ Channels channels_of(const float* mean, const float* rstd, const float* weight,
                                                const float* bias, int cg) {
  Channels k;
  load_channels(mean, cg, k.m);
  load_channels(rstd, cg, k.r);
  load_channels(bias, cg, k.b);
  float w[4];
  load_channels(weight, cg, w);
#pragma unroll
  for (int c = 0; c < 4; ++c) k.s[c] = k.r[c] * w[c];
  return k;
}

// g, the ReLU's gradient passed where the forward's output was positive,
// and xh of one element.
__device__ __forceinline__ void grad_and_xhat(const Channels& k, int c, float x, float dy, float& g, float& xh) {
  const float d = x - k.m[c];
  g = d * k.s[c] + k.b[c] <= 0.0f ? 0.0f : dy;
  xh = d * k.r[c];
}

struct Sums {
  float g[4], gx[4];
};

__device__ __forceinline__ void sums_add(Sums& a, const Sums& b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) a.g[c] = a.g[c] + b.g[c], a.gx[c] = a.gx[c] + b.gx[c];
}

// Partial sum g and sum g * xh of each channel over the rows of each
// block: part[0][block][c] and part[1][block][c].
__global__ void __launch_bounds__(kThreads) bn_relu_grad_sums_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ part, Geometry g) {
  __shared__ Sums tree[kThreads];
  const Place p = place_of(g);
  Sums acc = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  if (p.active) {
    const Channels k = channels_of(mean, rstd, weight, bias, p.cg);
    auto add = [&](const float4& xv, const float4& dv) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float gg, xh;
        grad_and_xhat(k, c, at(xv, c), at(dv, c), gg, xh);
        acc.g[c] = acc.g[c] + gg;
        acc.gx[c] = acc.gx[c] + gg * xh;
      }
    };
    int64_t r = p.r0 + p.ty;
    for (; r + (kUnrollTwo - 1) * g.rpi < p.r1; r += kUnrollTwo * g.rpi) {
      float4 xv[kUnrollTwo], dv[kUnrollTwo];
#pragma unroll
      for (int u = 0; u < kUnrollTwo; ++u) {
        xv[u] = load4(x, r + u * g.rpi, g, p.cg);
        dv[u] = load4(dy, r + u * g.rpi, g, p.cg);
      }
#pragma unroll
      for (int u = 0; u < kUnrollTwo; ++u) add(xv[u], dv[u]);
    }
    for (; r < p.r1; r += g.rpi) add(load4(x, r, g, p.cg), load4(dy, r, g, p.cg));
  }
  tree[threadIdx.x] = acc;
  for (int s = 1; s < g.rpi; s <<= 1) {
    __syncthreads();
    if (p.active && p.ty % (2 * s) == 0 && p.ty + s < g.rpi) {
      sums_add(acc, tree[threadIdx.x + s * g.tpr]);
      tree[threadIdx.x] = acc;
    }
  }
  if (p.active && p.ty == 0) {
    const int64_t at0 = static_cast<int64_t>(blockIdx.x) * g.channels;
    const int64_t at1 = (static_cast<int64_t>(g.blocks) + blockIdx.x) * g.channels;
    reinterpret_cast<float4*>(part + at0)[p.cg] = make4(acc.g);
    reinterpret_cast<float4*>(part + at1)[p.cg] = make4(acc.gx);
  }
}

// One warp a channel: the partial sums added in a fixed order into
// grad_b = sum g and grad_w = sum g * xh; their means over the rows into
// coef[0][c] and coef[1][c].
__global__ void __launch_bounds__(kThreads) bn_relu_finish_grad_kernel(const float* __restrict__ part,
                                                                       float* __restrict__ grad_w,
                                                                       float* __restrict__ grad_b,
                                                                       float* __restrict__ coef, Geometry g) {
  const int c = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (c >= g.channels) return;  // the whole warp
  float sg = 0.0f, sgx = 0.0f;
  for (int b = lane; b < g.blocks; b += 32) {
    sg = sg + part[static_cast<int64_t>(b) * g.channels + c];
    sgx = sgx + part[(static_cast<int64_t>(g.blocks) + b) * g.channels + c];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float a = __shfl_down_sync(0xffffffffu, sg, off);
    const float b = __shfl_down_sync(0xffffffffu, sgx, off);
    if (lane < off) sg = sg + a, sgx = sgx + b;
  }
  if (lane == 0) {
    const float rows = static_cast<float>(g.rows);
    grad_b[c] = sg;
    grad_w[c] = sgx;
    coef[c] = sg / rows;
    coef[g.channels + c] = sgx / rows;
  }
}

__global__ void __launch_bounds__(kThreads) bn_relu_grad_input_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ coef, float* __restrict__ dx, Geometry g) {
  const Place p = place_of(g);
  if (!p.active) return;
  const Channels k = channels_of(mean, rstd, weight, bias, p.cg);
  float mg[4], mgx[4];
  load_channels(coef, p.cg, mg);
  load_channels(coef + g.channels, p.cg, mgx);
  auto one = [&](const float4& xv, const float4& dv) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float gg, xh;
      grad_and_xhat(k, c, at(xv, c), at(dv, c), gg, xh);
      o[c] = k.s[c] * ((gg - mg[c]) - xh * mgx[c]);
    }
    return make4(o);
  };
  int64_t r = p.r0 + p.ty;
  for (; r + (kUnrollTwo - 1) * g.rpi < p.r1; r += kUnrollTwo * g.rpi) {
    float4 xv[kUnrollTwo], dv[kUnrollTwo];
#pragma unroll
    for (int u = 0; u < kUnrollTwo; ++u) {
      xv[u] = load4(x, r + u * g.rpi, g, p.cg);
      dv[u] = load4(dy, r + u * g.rpi, g, p.cg);
    }
#pragma unroll
    for (int u = 0; u < kUnrollTwo; ++u) store4(dx, r + u * g.rpi, g, p.cg, one(xv[u], dv[u]));
  }
  for (; r < p.r1; r += g.rpi) store4(dx, r, g, p.cg, one(load4(x, r, g, p.cg), load4(dy, r, g, p.cg)));
}

// ---- eval mode ---------------------------------------------------------
//
// Eval mode: the running statistics. Replaces no TPU kernel either: XLA
// fused the JAX package's eval BatchNorm, the ReLU and the max over each
// group into the neighbouring ops. PyTorch ran them as three passes of its
// own (batch_norm_transform_input_channels_last_kernel, the ReLU's clamp
// and, where a max over the group follows, a MaxNanFunctor reduce), which
// read every activation three times and wrote it twice, and the last
// layer of an MLP once more.
//
// What it computes, per channel c, with invstd = rsqrtf(running_var + eps)
// (PyTorch's batch_norm_calc_invstd on the card: the approximate
// reciprocal square root, as torch.rsqrt, and not 1 / sqrt, which parts
// from it in about a third of the channels):
//
//   y = relu(w * (x - running_mean) * invstd + b)
//
// rounded as PyTorch's channels-last transform
// (batch_norm_transform_input_channels_last_kernel) rounds it: the
// difference and the product with w each on their own, then the product
// with invstd and the sum with b in one fused multiply-add (PyTorch's
// build contracts them; this file builds with -fmad=false, so the FMA is
// spelled out; the two roundings apart part from it in about a quarter of
// the elements). So y equals the plain pair, torch.relu(BatchNormF32(x)), bit
// for bit. PyTorch takes that kernel for tensors of fewer than 2^31 - 1
// elements; a larger one goes to its general kernel, which rounds
// otherwise, and kernels/bn_relu.py leaves those to the plain pair. The
// ReLU is torch.relu's clamp (NaN passes).
//
// The pooled pass reads [G, K, C] (K rows a group, contiguous) and writes
// only out[g][c] = max over k of y[g][k][c], with amax's NaN rule (a NaN
// anywhere in the group gives NaN). The max is exact in any order, so it
// equals .amax(dim=-2) of the plain pair's output. A running maximum starts
// at +0 (the ReLU's floor) and takes t where t > it or t is NaN.
//
// What bounds both: device memory. Each element costs five flops against
// 8 bytes (apply: read x, write y) or 4 bytes (pooled: read x; the output
// is K times smaller). The design:
//
// - The apply pass is the train apply's geometry (Geometry above): 16-byte
//   column groups, four loads in flight a thread, at most kMaxRowBlocks
//   slabs. A thread forms its four channels' invstd once.
// - The pooled pass gives each row of a block's threads (a "lane", tpr
//   threads across the channels) one piece of a group: the whole group,
//   or, where G * C / 4 threads would not fill the card (kPoolThreads: 512
//   on each SM), a part of it, of at least kMinPieceRows rows, so that
//   the few large groups of the global layers and the heads' global max
//   (G = 32, K up to 1024, C = 1024) are read by the whole card. A lane
//   reads its rows eight 16-byte loads at a time and keeps the maxima in
//   registers. A group of one
//   piece writes its maxima with one store. Pieces of one group merge
//   through atomicMax on the bits into an output zeroed first on the
//   stream: the maxima are +0 or above, or NaN, and all of those order as
//   unsigned integers (+0 < positive floats < +inf < NaN), so the merge
//   gives the same bits in any order, and a NaN wins.
// - Nothing is allocated; every launch (and the zeroing) goes on the
//   caller's stream, so both passes capture into a CUDA graph.

constexpr int kUnrollPool = 8;        // loads in flight a thread, pooled pass
constexpr int kPoolThreads = 512 * 132;
constexpr int kMinPieceRows = 8;

// Four channels' running mean, invstd (as batch_norm_calc_invstd forms
// it), weight and bias.
struct EvalChannels {
  float m[4], inv[4], w[4], b[4];
};

__device__ __forceinline__ EvalChannels eval_channels_of(const float* running_mean, const float* running_var,
                                                         const float* weight, const float* bias, int cg,
                                                         float eps) {
  EvalChannels k;
  load_channels(running_mean, cg, k.m);
  load_channels(running_var, cg, k.inv);
  load_channels(weight, cg, k.w);
  load_channels(bias, cg, k.b);
#pragma unroll
  for (int c = 0; c < 4; ++c) k.inv[c] = rsqrtf(__fadd_rn(k.inv[c], eps));
  return k;
}

// The eval BatchNorm of one element, before the ReLU, as PyTorch's
// channels-last transform rounds it.
__device__ __forceinline__ float eval_bn(const EvalChannels& k, int c, float x) {
  return __fmaf_rn(__fmul_rn(k.w[c], __fsub_rn(x, k.m[c])), k.inv[c], k.b[c]);
}

__global__ void __launch_bounds__(kThreads) bn_relu_eval_kernel(
    const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ running_mean,
    const float* __restrict__ running_var, const float* __restrict__ weight, const float* __restrict__ bias,
    float eps, Geometry g) {
  const Place p = place_of(g);
  if (!p.active) return;
  const EvalChannels k = eval_channels_of(running_mean, running_var, weight, bias, p.cg, eps);
  auto one = [&](const float4& v) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t = eval_bn(k, c, at(v, c));
      o[c] = t != t ? t : fmaxf(t, 0.0f);  // torch.relu's clamp: NaN passes
    }
    return make4(o);
  };
  int64_t r = p.r0 + p.ty;
  for (; r + (kUnrollOne - 1) * g.rpi < p.r1; r += kUnrollOne * g.rpi) {
    float4 v[kUnrollOne];
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) v[u] = load4(x, r + u * g.rpi, g, p.cg);
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) store4(y, r + u * g.rpi, g, p.cg, one(v[u]));
  }
  for (; r < p.r1; r += g.rpi) store4(y, r, g, p.cg, one(load4(x, r, g, p.cg)));
}

struct PoolGeometry {
  int64_t groups;  // G
  int rows;        // K, rows a group
  int channels;    // C
  int cgroups;     // C / 4
  int tpr;         // threads a lane
  int rpi;         // lanes a block
  int chunks;      // column chunks (gridDim.y)
  int pieces;      // pieces a group
  int piece_rows;  // rows a piece (the last may have fewer)
  int64_t blocks;  // gridDim.x
};

// The same rule as kernels/bn_relu.py bn_relu_pool_plan.
bool make_pool_geometry(int64_t G, int K, int C, PoolGeometry* g) {
  if (G <= 0 || K <= 0 || C <= 0 || C % 4 != 0) return false;
  g->groups = G;
  g->rows = K;
  g->channels = C;
  g->cgroups = C / 4;
  g->tpr = g->cgroups < kThreads ? g->cgroups : kThreads;
  g->rpi = kThreads / g->tpr;
  g->chunks = (g->cgroups + g->tpr - 1) / g->tpr;
  const int64_t threads = G * g->cgroups;
  int64_t pieces = (kPoolThreads + threads - 1) / threads;  // 1 where the groups fill the card
  if (pieces > K / kMinPieceRows) pieces = K / kMinPieceRows;
  if (pieces < 1) pieces = 1;
  g->piece_rows = static_cast<int>((K + pieces - 1) / pieces);
  g->pieces = (K + g->piece_rows - 1) / g->piece_rows;
  g->blocks = (G * g->pieces + g->rpi - 1) / g->rpi;
  return g->blocks < (int64_t{1} << 31);
}

__global__ void __launch_bounds__(kThreads) bn_relu_eval_max_kernel(
    const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ running_mean,
    const float* __restrict__ running_var, const float* __restrict__ weight, const float* __restrict__ bias,
    float eps, PoolGeometry g) {
  const int ty = threadIdx.x / g.tpr;
  const int cg = blockIdx.y * g.tpr + (threadIdx.x - ty * g.tpr);
  const int64_t piece = static_cast<int64_t>(blockIdx.x) * g.rpi + ty;
  if (ty >= g.rpi || cg >= g.cgroups || piece >= g.groups * g.pieces) return;
  const int64_t grp = piece / g.pieces;
  const int k0 = static_cast<int>(piece - grp * g.pieces) * g.piece_rows;
  const int k1 = min(g.rows, k0 + g.piece_rows);
  const EvalChannels k = eval_channels_of(running_mean, running_var, weight, bias, cg, eps);
  const float4* rows = reinterpret_cast<const float4*>(x + grp * g.rows * g.channels) + cg;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto take = [&](const float4& v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t = eval_bn(k, c, at(v, c));
      acc[c] = (t != t || t > acc[c]) ? t : acc[c];  // amax of the ReLU: NaN wins, -0 never replaces +0
    }
  };
  int r = k0;
  for (; r + kUnrollPool <= k1; r += kUnrollPool) {
    float4 v[kUnrollPool];
#pragma unroll
    for (int u = 0; u < kUnrollPool; ++u) v[u] = __ldg(rows + static_cast<int64_t>(r + u) * g.cgroups);
#pragma unroll
    for (int u = 0; u < kUnrollPool; ++u) take(v[u]);
  }
  for (; r < k1; ++r) take(__ldg(rows + static_cast<int64_t>(r) * g.cgroups));
  float* out = y + grp * g.channels + 4 * cg;
  if (g.pieces == 1) {
    *reinterpret_cast<float4*>(out) = make4(acc);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicMax(reinterpret_cast<unsigned int*>(out) + c, __float_as_uint(acc[c]));
  }
}

// ---- gathered eval mode ------------------------------------------------
//
// Gathered eval mode: the first eval-mode pair of a ball-query set
// abstraction whose first Linear was taken per point (ops/grouping.py
// per_point_products). Replaces no TPU kernel: the JAX package, and the
// port before it, gathered every neighbour's features and coordinates,
// subtracted the centroid, concatenated the two into a [B, S, K, D + P]
// tensor and ran the first Linear on it, once per (centroid, neighbour).
// The Linear is linear, so the port now takes it once per point,
// pf = W [x_j, f_j] ([B, N, C]), and once per centroid on the coordinate
// columns, qc = W_x c ([B, S, C]); this pass forms the first layer's
// output from them and applies the eval BatchNorm + ReLU:
//
//   t = (pf[b][idx[b][s][k]] - qc[b][s]) + bias      (each rounded on its own)
//   y[b][s][k] = relu(w * (t - running_mean) * invstd + b)   (eval_bn above)
//
// so no grouped tensor exists, and the first layer's output is written once
// and never read back by a separate eval pass. kernels/bn_relu.py
// eval_gather_reference spells the same roundings.
//
// What bounds it: its writes, [B, S, K, C] float32 at the rate of device
// memory. It reads K indices and K rows of pf a group, but pf is at most a
// few tens of MB a launch (N rows) and each point is read by many groups,
// so the reads come from the 50 MB L2. The design:
//
// - One warp a group (b, s). tpr = min(C / 4, 32) lanes span a row, one
//   16-byte column group each, and rpw = 32 / tpr rows go at once; where C
//   > 128, blockIdx.y picks the chunk of 32 column groups. A lane keeps its
//   four channels' BatchNorm constants, the bias and qc[b][s] in
//   registers for the whole group.
// - A lane loads four indices, then four 16-byte rows of pf, before it
//   stores, so that enough reads from L2 are in flight; the stores are
//   streaming (__stcs) so that the output does not push pf out of L2.
// - pf, qc and idx may be column slices of wider tensors (the MSG layer's
//   scales share one product, and one ball query's indices): each takes a
//   row stride. Offsets are formed in 64 bits.
// - Nothing is allocated and the launch goes on the caller's stream, so it
//   captures into a CUDA graph; the output equals its plain version bit for
//   bit, so a replay equals its eager call.

constexpr int kGatherWarps = kThreads / 32;  // groups a block

struct GatherGeometry {
  int64_t groups;  // B * S
  int points;      // N
  int centroids;   // S
  int rows;        // K, rows a group
  int channels;    // C
  int cgroups;     // C / 4
  int tpr;         // lanes a row
  int rpw;         // rows a warp takes at once
  int chunks;      // column chunks (gridDim.y)
  int ld_pf, ld_qc, ld_idx;  // row strides in elements
};

bool make_gather_geometry(int B, int N, int S, int K, int C, int ld_pf, int ld_qc, int ld_idx,
                          GatherGeometry* g) {
  if (B <= 0 || N <= 0 || S <= 0 || K <= 0 || C <= 0 || C % 4 != 0) return false;
  if (ld_pf < C || ld_qc < C || ld_idx < K || ld_pf % 4 != 0 || ld_qc % 4 != 0) return false;
  g->groups = static_cast<int64_t>(B) * S;
  g->points = N;
  g->centroids = S;
  g->rows = K;
  g->channels = C;
  g->cgroups = C / 4;
  g->tpr = g->cgroups < 32 ? g->cgroups : 32;
  g->rpw = 32 / g->tpr;
  g->chunks = (g->cgroups + g->tpr - 1) / g->tpr;
  g->ld_pf = ld_pf;
  g->ld_qc = ld_qc;
  g->ld_idx = ld_idx;
  return (g->groups + kGatherWarps - 1) / kGatherWarps < (int64_t{1} << 31);
}

__global__ void __launch_bounds__(kThreads) bn_relu_eval_gather_kernel(
    const float* __restrict__ pf, const float* __restrict__ qc, const int* __restrict__ idx,
    const float* __restrict__ lin_bias, const float* __restrict__ running_mean,
    const float* __restrict__ running_var, const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ y, float eps, GatherGeometry g) {
  const int lane = threadIdx.x & 31;
  const int64_t grp = static_cast<int64_t>(blockIdx.x) * kGatherWarps + threadIdx.x / 32;
  const int ty = lane / g.tpr;
  const int cg = blockIdx.y * g.tpr + (lane - ty * g.tpr);
  if (grp >= g.groups || ty >= g.rpw || cg >= g.cgroups) return;
  const int64_t b = grp / g.centroids;
  const EvalChannels k = eval_channels_of(running_mean, running_var, weight, bias, cg, eps);
  float lb[4];
  load_channels(lin_bias, cg, lb);
  const float4 q = __ldg(reinterpret_cast<const float4*>(qc + grp * g.ld_qc) + cg);
  const float* rows = pf + b * g.points * g.ld_pf + 4 * cg;
  const int* nb = idx + grp * g.ld_idx;
  float4* out = reinterpret_cast<float4*>(y + grp * g.rows * g.channels) + cg;
  auto one = [&](const float4& v) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t = eval_bn(k, c, __fadd_rn(__fsub_rn(at(v, c), at(q, c)), lb[c]));
      o[c] = t != t ? t : fmaxf(t, 0.0f);  // torch.relu's clamp: NaN passes
    }
    return make4(o);
  };
  auto row = [&](int j) {
    return __ldg(reinterpret_cast<const float4*>(rows + static_cast<int64_t>(j) * g.ld_pf));
  };
  int r = ty;
  for (; r + (kUnrollOne - 1) * g.rpw < g.rows; r += kUnrollOne * g.rpw) {
    int j[kUnrollOne];
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) j[u] = __ldg(nb + r + u * g.rpw);
    float4 v[kUnrollOne];
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) v[u] = row(j[u]);
#pragma unroll
    for (int u = 0; u < kUnrollOne; ++u) __stcs(out + static_cast<int64_t>(r + u * g.rpw) * g.cgroups, one(v[u]));
  }
  for (; r < g.rows; r += g.rpw) __stcs(out + static_cast<int64_t>(r) * g.cgroups, one(row(__ldg(nb + r))));
}

int finish_blocks(const Geometry& g) { return (g.channels + kThreads / 32 - 1) / (kThreads / 32); }

}  // namespace

extern "C" {

// The forward of one train-mode BatchNorm + ReLU over [R, C] (C % 4 == 0;
// x and y 16-byte aligned) from the batch's mean and biased variance ([C]
// each): writes y, rstd and scale ([C] each) and updates running_mean and
// running_var in place. `blocks` is the plan of kernels/bn_relu.py
// bn_relu_plan; a launch whose plan differs is refused. Launches on
// `stream`; returns the cudaError_t of the first launch that failed (0 on
// success).
int plpe_bn_relu_forward(const float* x, float* y, const float* mean, const float* var, const float* weight,
                         const float* bias, float* running_mean, float* running_var, float* rstd, float* scale,
                         long long R, int C, int blocks, float keep, float momentum, float eps, void* stream) {
  Geometry g;
  if (!make_geometry(R, C, &g) || g.blocks != blocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_relu_scale_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      mean, var, weight, running_mean, running_var, rstd, scale, C, keep, momentum, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_relu_apply_kernel<<<dim3(g.blocks, g.chunks), kThreads, 0, st>>>(x, y, mean, scale, bias, g);
  return static_cast<int>(cudaGetLastError());
}

// The backward: dx ([R, C]), grad_w and grad_b ([C]) from x, dy and the
// forward's mean and rstd; coef is a [2, C] scratch and part a [2, blocks,
// C] one. The same checks and stream as the forward.
int plpe_bn_relu_backward(const float* x, const float* dy, const float* mean, const float* rstd,
                          const float* weight, const float* bias, float* dx, float* grad_w, float* grad_b,
                          float* coef, float* part, long long R, int C, int blocks, void* stream) {
  Geometry g;
  if (!make_geometry(R, C, &g) || g.blocks != blocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(g.blocks, g.chunks);
  bn_relu_grad_sums_kernel<<<grid, kThreads, 0, st>>>(x, dy, mean, rstd, weight, bias, part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_relu_finish_grad_kernel<<<finish_blocks(g), kThreads, 0, st>>>(part, grad_w, grad_b, coef, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_relu_grad_input_kernel<<<grid, kThreads, 0, st>>>(x, dy, mean, rstd, weight, bias, coef, dx, g);
  return static_cast<int>(cudaGetLastError());
}

// One eval-mode BatchNorm + ReLU over [R, C] (C % 4 == 0; x and y 16-byte
// aligned) from the running statistics: y = relu(w * (x - running_mean) *
// invstd + b). `blocks` is kernels/bn_relu.py bn_relu_plan's; a launch
// whose plan differs is refused.
int plpe_bn_relu_eval(const float* x, float* y, const float* running_mean, const float* running_var,
                      const float* weight, const float* bias, long long R, int C, int blocks, float eps,
                      void* stream) {
  Geometry g;
  if (!make_geometry(R, C, &g) || g.blocks != blocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(g.blocks, g.chunks);
  bn_relu_eval_kernel<<<grid, kThreads, 0, st>>>(x, y, running_mean, running_var, weight, bias, eps, g);
  return static_cast<int>(cudaGetLastError());
}

// The same over [G, K, C] with the max over each group's K rows: writes
// y [G, C] only. `pieces` is kernels/bn_relu.py bn_relu_pool_plan's; a
// launch whose plan differs is refused. Where a group is cut into more
// than one piece, y is zeroed on the stream first and the pieces merge
// with atomicMax.
int plpe_bn_relu_eval_max(const float* x, float* y, const float* running_mean, const float* running_var,
                          const float* weight, const float* bias, long long G, int K, int C, int pieces,
                          float eps, void* stream) {
  PoolGeometry g;
  if (!make_pool_geometry(G, K, C, &g) || g.pieces != pieces) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.pieces > 1) {
    const cudaError_t err = cudaMemsetAsync(y, 0, static_cast<size_t>(G) * C * sizeof(float), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(g.blocks), g.chunks);
  bn_relu_eval_max_kernel<<<grid, kThreads, 0, st>>>(x, y, running_mean, running_var, weight, bias, eps, g);
  return static_cast<int>(cudaGetLastError());
}

// The gathered eval pass: y [B, S, K, C] (contiguous, 16-byte aligned) from
// pf [B, N, C], qc [B, S, C] and idx [B, S, K] (int32, every index below
// N), each with its row stride (ld_pf, ld_qc: multiples of 4, rows at a
// 16-byte boundary), lin_bias the first Linear's bias and the BatchNorm's
// running statistics, weight and bias ([C] each).
int plpe_bn_relu_eval_gather(const float* pf, const float* qc, const int* idx, const float* lin_bias,
                             const float* running_mean, const float* running_var, const float* weight,
                             const float* bias, float* y, int B, int N, int S, int K, int C, int ld_pf, int ld_qc,
                             int ld_idx, float eps, void* stream) {
  GatherGeometry g;
  if (!make_gather_geometry(B, N, S, K, C, ld_pf, ld_qc, ld_idx, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((g.groups + kGatherWarps - 1) / kGatherWarps), g.chunks);
  bn_relu_eval_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pf, qc, idx, lin_bias, running_mean, running_var, weight, bias, y, eps, g);
  return static_cast<int>(cudaGetLastError());
}

const char* plpe_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
