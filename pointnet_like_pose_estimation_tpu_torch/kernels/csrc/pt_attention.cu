// Point Transformer's vector attention in one pass for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Point Transformer. It was
// added for nn/point_transformer.py PointTransformerLayer in eval mode,
// which PyTorch ran as some thirty launches a layer over nine [B, N, K, .]
// neighbourhood tensors (the position encoding, the gathered keys and
// values, the relation, its pair, the weights, their softmax, the values
// with the encoding and their product), each written to device memory and
// read back.
//
// What it computes, for every query point i of every cloud, from q, k, v
// [B, N, C], the points p [B, N, 3] and the neighbours idx [B, N, K]
// (int64), with c = C / share_planes and j over the K neighbours of i:
//
//   delta_j = W1 relu(bn_p(W0 (p_j - p_i) + b0)) + b1           (3 -> 3 -> C)
//   h_j     = relu(bn_w((k_j - q_i) + delta_j))
//   w_j     = Wb relu(bn_m(Wa h_j + ba)) + bb                    (C -> c -> c)
//   s_j[t]  = exp(w_j[t] - max_j w_j[t]) / sum_j exp(...)        (softmax over j)
//   y[g c + t] = sum_j (v_j + delta_j)[g c + t] * s_j[t]
//   out_i   = relu(bn2(y))                                      (the block's bn2 pair)
//
// and writes out [B, N, C] alone. Every BatchNorm is the eval pass of
// csrc/bn_relu.cu (invstd = rsqrtf(var + eps); w * (x - mean) rounded, then
// one FMA with invstd and b; the ReLU lets NaN pass). A product is a chain
// of FMAs over its inputs in ascending order and its bias added after, the
// weighted sum a product and an add a neighbour, in order: float32
// throughout (the library builds with -fmad=false; the FMAs are spelled
// out), but summed in another order than cuBLAS and PyTorch's reductions,
// so the output parts from the composed layer by float32 reordering.
// kernels/pt_attention.py pt_attention_reference spells the same function.
//
// What bounds it: device memory and the L2. At the request's shapes a layer
// reads q, k, v and writes the output once (16 bytes a point and channel,
// 4-17 MB a layer), some 2-6 us at 3.35 TB/s; its operations (the C -> c
// product, 2 C c a neighbour, dominates) take as long at 67 TFLOP/s. The
// composed layer moved its nine neighbourhood tensors through device
// memory instead, K times the size of its inputs each. The design keeps
// every [K, .] intermediate on the SM:
//
// - A BLOCK A TILE OF QUERIES of one cloud, `tile` queries (rows = tile *
//   K neighbour rows, rows * C <= kTileElements), 256 threads. It stages
//   the layer's small weights (Wa at most 64 x 512, 128 KB, at C = 512,
//   16 bytes a load and eight loads in flight a thread) and its
//   neighbours' indices in shared memory, once.
// - Each phase spreads over all 256 threads, with a __syncthreads between:
//   (1) the position encoder's hidden layer, a row a thread; (2) h, a
//   16-byte group of 4 channels a thread, k_j gathered from the L2 as a
//   float4 and delta recomputed from the 3 hidden values; (3) Wa h, 4
//   outputs of one row a thread, the row read as float4 from shared memory
//   (rows padded by 4 floats: no bank conflict) and Wa's rows broadcast to
//   the warp's lanes, which share them; (4) Wb u the same way; (5) the
//   softmax, a (query, t) a thread, in shared memory: no second pass over
//   device memory; (6) the weighted sum, 4 channels of one query a thread,
//   v_j gathered as in (2), delta recomputed bit for bit as in (2), then
//   bn2's pair and one float4 store.
// - The tile keeps 1,024 outputs of the C -> c product to a block at every
//   stage (rows * c = kTileElements / share_planes), 4 a thread, and fills
//   the card down to the fourth stage (256 blocks at N = 16); the fifth (N
//   = 4, 32 blocks) is the smallest in work too. A thread's 4 channels are
//   the same in every item of phases (2) and (6) (C / 4 divides the block's
//   threads), so their weights and BatchNorm constants stay in registers.
//
// The launch plan (queries a block, threads, shared bytes) is made by
// kernels/pt_attention.py pt_attention_plan and computed here again by the
// same rule: a launch whose plan differs is refused.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElements = 8192;  // neighbour rows x channels of a block's h tile, at most
constexpr int kMaxC = 512;
constexpr int kMaxPlanes = 64;       // c = C / share_planes
constexpr int kMaxK = 16;
constexpr int kPad = 4;              // floats after each row of a shared matrix
constexpr int kPosFloats = 24;       // W0 (9), b0 (3), bn_p's mean, invstd, weight, bias (3 each)
constexpr int kMaxSharedBytes = 227 * 1024;

struct EvalBn {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

struct Args {
  const float* p;
  const float* q;
  const float* k;
  const float* v;
  const long long* idx;
  float* out;
  const float* pos_w0;  // [3, 3]
  const float* pos_b0;
  const float* pos_w1;  // [C, 3]
  const float* pos_b1;
  const float* mlp_w0;  // [c, C]
  const float* mlp_b0;
  const float* mlp_w1;  // [c, c]
  const float* mlp_b1;
  EvalBn pos_bn, weight_bn, mlp_bn, bn2;
  int N, K, C, c, tile;
};

// Offsets (floats) of the shared arrays of a block of `rows` neighbour rows.
struct Layout {
  int wa, wb, mlp, pos, h, u, w, r1, ids, floats;
};

__host__ __device__ inline Layout layout_of(int C, int c, int rows) {
  Layout l;
  l.wa = 0;                          // Wa, c rows of C
  l.wb = l.wa + c * (C + kPad);      // Wb, c rows of c
  l.mlp = l.wb + c * (c + kPad);     // ba, bn_m's mean, invstd, weight, bias, bb: c each
  l.pos = l.mlp + 6 * c;
  l.h = l.pos + kPosFloats;          // h, rows of C
  l.u = l.h + rows * (C + kPad);     // relu(bn_m(Wa h + ba)), rows of c
  l.w = l.u + rows * (c + kPad);     // w, then its softmax, rows of c
  l.r1 = l.w + rows * (c + kPad);    // the position encoder's hidden layer, 4 a row (3 used)
  l.ids = l.r1 + 4 * rows;           // the neighbours' indices, int
  l.floats = l.ids + rows;
  return l;
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The eval BatchNorm + ReLU of one element, as csrc/bn_relu.cu eval_bn
// rounds it and torch.relu clamps it.
__device__ __forceinline__ float bn_relu(float x, float mean, float inv, float weight, float bias) {
  const float t = __fmaf_rn(__fmul_rn(weight, __fsub_rn(x, mean)), inv, bias);
  return t != t ? t : fmaxf(t, 0.0f);
}

__device__ __forceinline__ float invstd(const EvalBn& bn, int ch) {
  return rsqrtf(__fadd_rn(bn.var[ch], bn.eps));
}

// Four channels' eval BatchNorm constants.
struct Bn4 {
  float mean[4], inv[4], weight[4], bias[4];
};

__device__ __forceinline__ Bn4 bn4_of(const EvalBn& bn, int c0) {
  Bn4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.mean[i] = bn.mean[c0 + i];
    r.inv[i] = invstd(bn, c0 + i);
    r.weight[i] = bn.weight[c0 + i];
    r.bias[i] = bn.bias[c0 + i];
  }
  return r;
}

// Four channels of the position encoder's last Linear.
struct Pos4 {
  float w[4][3], b[4];
};

// delta of channel i of a Pos4 from the hidden layer r: the same bits
// wherever it is formed.
__device__ __forceinline__ float delta_of(const Pos4& P, int i, const float4& r) {
  float d = __fmul_rn(r.x, P.w[i][0]);
  d = __fmaf_rn(r.y, P.w[i][1], d);
  d = __fmaf_rn(r.z, P.w[i][2], d);
  return __fadd_rn(d, P.b[i]);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[i] += the dot product of `row` with row i of the 4 rows at `mat`
// (stride `ld`), over `n` inputs, as FMAs in ascending input order.
__device__ __forceinline__ void dot4(const float* row, const float* mat, int ld, int n, float acc[4]) {
  for (int j = 0; j < n; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 m = *reinterpret_cast<const float4*>(mat + i * ld + j);
      acc[i] = __fmaf_rn(x.x, m.x, acc[i]);
      acc[i] = __fmaf_rn(x.y, m.y, acc[i]);
      acc[i] = __fmaf_rn(x.z, m.z, acc[i]);
      acc[i] = __fmaf_rn(x.w, m.w, acc[i]);
    }
  }
}

// Copy a [rows, n] matrix (n % 4 == 0, 16-byte aligned) into shared rows
// of n + kPad floats, 16 bytes a thread, kStageLoads loads in flight: the
// largest, Wa at C = 512, is 32 float4 a thread.
constexpr int kStageLoads = 8;

__device__ __forceinline__ void stage_rows(const float* src, float* dst, int rows, int n, int tid) {
  const int n4 = n / 4, total = rows * n4;
  for (int e0 = tid; e0 < total; e0 += kStageLoads * kThreads) {
    float4 t[kStageLoads];
#pragma unroll
    for (int s = 0; s < kStageLoads; ++s)
      if (e0 + s * kThreads < total) t[s] = load4(src + 4 * (e0 + s * kThreads));
#pragma unroll
    for (int s = 0; s < kStageLoads; ++s) {
      const int e = e0 + s * kThreads;
      if (e >= total) break;
      *reinterpret_cast<float4*>(dst + (e / n4) * (n + kPad) + 4 * (e % n4)) = t[s];
    }
  }
}

__global__ void __launch_bounds__(kThreads) pt_attention_kernel(const Args a) {
  extern __shared__ float4 shared4[];
  float* sh = reinterpret_cast<float*>(shared4);
  const int C = a.C, c = a.c, K = a.K;
  const Layout L = layout_of(C, c, a.tile * K);
  float* wa = sh + L.wa;
  float* wb = sh + L.wb;
  float* mlp = sh + L.mlp;
  float* pos = sh + L.pos;
  float* h = sh + L.h;
  float* u = sh + L.u;
  float* w = sh + L.w;
  float* r1 = sh + L.r1;
  int* ids = reinterpret_cast<int*>(sh + L.ids);
  const int ldC = C + kPad, ldc = c + kPad;

  const int q0 = blockIdx.x * a.tile;
  const int nq = min(a.tile, a.N - q0);  // queries of this block
  const int rows = nq * K;
  const long long cloud = static_cast<long long>(blockIdx.y) * a.N;  // the cloud's first point
  const int tid = threadIdx.x;

  // 0: the layer's small weights and the tile's neighbours
  stage_rows(a.mlp_w0, wa, c, C, tid);
  stage_rows(a.mlp_w1, wb, c, c, tid);
  for (int t = tid; t < c; t += kThreads) {
    mlp[t] = a.mlp_b0[t];
    mlp[c + t] = a.mlp_bn.mean[t];
    mlp[2 * c + t] = invstd(a.mlp_bn, t);
    mlp[3 * c + t] = a.mlp_bn.weight[t];
    mlp[4 * c + t] = a.mlp_bn.bias[t];
    mlp[5 * c + t] = a.mlp_b1[t];
  }
  if (tid < 9) pos[tid] = a.pos_w0[tid];
  if (tid < 3) {
    pos[9 + tid] = a.pos_b0[tid];
    pos[12 + tid] = a.pos_bn.mean[tid];
    pos[15 + tid] = invstd(a.pos_bn, tid);
    pos[18 + tid] = a.pos_bn.weight[tid];
    pos[21 + tid] = a.pos_bn.bias[tid];
  }
  for (int r = tid; r < rows; r += kThreads) ids[r] = static_cast<int>(a.idx[(cloud + q0) * K + r]);
  __syncthreads();

  // 1: relu(bn_p(W0 (p_j - p_i) + b0)), a row a thread
  for (int r = tid; r < rows; r += kThreads) {
    const float* pi = a.p + (cloud + q0 + r / K) * 3;
    const float* pj = a.p + (cloud + ids[r]) * 3;
    const float rel[3] = {__fsub_rn(pj[0], pi[0]), __fsub_rn(pj[1], pi[1]), __fsub_rn(pj[2], pi[2])};
    float hid[4];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float d = __fmul_rn(rel[0], pos[3 * t]);
      d = __fmaf_rn(rel[1], pos[3 * t + 1], d);
      d = __fmaf_rn(rel[2], pos[3 * t + 2], d);
      hid[t] = bn_relu(__fadd_rn(d, pos[9 + t]), pos[12 + t], pos[15 + t], pos[18 + t], pos[21 + t]);
    }
    hid[3] = 0.0f;
    *reinterpret_cast<float4*>(r1 + 4 * r) = make_float4(hid[0], hid[1], hid[2], hid[3]);
  }

  // this thread's 4 channels in phases 2 and 6 (C / 4 divides kThreads)
  const int groups = C / 4;
  const int c0 = 4 * (tid % groups);
  Pos4 P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int t = 0; t < 3; ++t) P.w[i][t] = a.pos_w1[(c0 + i) * 3 + t];
    P.b[i] = a.pos_b1[c0 + i];
  }
  __syncthreads();

  // 2: h = relu(bn_w((k_j - q_i) + delta_j)), 4 channels of a row a thread,
  // four rows' gathers in flight
  {
    const Bn4 bw = bn4_of(a.weight_bn, c0);
    const int items = rows * groups;
    for (int e0 = tid; e0 < items; e0 += 4 * kThreads) {
      float4 kv[4], qv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = (e0 + s * kThreads) / groups;
        if (e0 + s * kThreads < items) {
          kv[s] = load4(a.k + (cloud + ids[r]) * C + c0);
          qv[s] = load4(a.q + (cloud + q0 + r / K) * C + c0);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = (e0 + s * kThreads) / groups;
        if (e0 + s * kThreads >= items) break;
        const float4 hid = *reinterpret_cast<const float4*>(r1 + 4 * r);
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float rel = __fadd_rn(__fsub_rn(at(kv[s], i), at(qv[s], i)), delta_of(P, i, hid));
          o[i] = bn_relu(rel, bw.mean[i], bw.inv[i], bw.weight[i], bw.bias[i]);
        }
        *reinterpret_cast<float4*>(h + r * ldC + c0) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  __syncthreads();

  // 3: u = relu(bn_m(Wa h + ba)), outputs t0..t0+3 of a row a thread; the
  // lanes of a warp take consecutive rows and share Wa's rows
  const int tgroups = c / 4;
  for (int e = tid; e < rows * tgroups; e += kThreads) {
    const int r = e % rows, t0 = 4 * (e / rows);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    dot4(h + r * ldC, wa + t0 * ldC, ldC, C, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      u[r * ldc + t] = bn_relu(__fadd_rn(acc[i], mlp[t]), mlp[c + t], mlp[2 * c + t], mlp[3 * c + t],
                               mlp[4 * c + t]);
    }
  }
  __syncthreads();

  // 4: w = Wb u + bb
  for (int e = tid; e < rows * tgroups; e += kThreads) {
    const int r = e % rows, t0 = 4 * (e / rows);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    dot4(u + r * ldc, wb + t0 * ldc, ldc, c, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[r * ldc + t0 + i] = __fadd_rn(acc[i], mlp[5 * c + t0 + i]);
  }
  __syncthreads();

  // 5: the softmax over each query's K rows, a (query, t) a thread, in place
  for (int e = tid; e < nq * c; e += kThreads) {
    float* col = w + (e / c) * K * ldc + e % c;
    float m = col[0];
    for (int j = 1; j < K; ++j) m = fmaxf(m, col[j * ldc]);
    float sum = 0.0f;
    for (int j = 0; j < K; ++j) {
      const float x = expf(__fsub_rn(col[j * ldc], m));
      col[j * ldc] = x;
      sum = __fadd_rn(sum, x);
    }
    for (int j = 0; j < K; ++j) col[j * ldc] = __fdiv_rn(col[j * ldc], sum);
  }
  __syncthreads();

  // 6: y = sum_j (v_j + delta_j) * s_j, then relu(bn2(y)): 4 channels of a
  // query a thread
  const Bn4 b2 = bn4_of(a.bn2, c0);
  const int t0 = c0 % c;  // the weights' index of channel c0 (c % 4 == 0)
  for (int e = tid; e < nq * groups; e += kThreads) {
    const int ql = e / groups;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      const int r = ql * K + j;
      const float4 vv = load4(a.v + (cloud + ids[r]) * C + c0);
      const float4 hid = *reinterpret_cast<const float4*>(r1 + 4 * r);
      const float4 s = *reinterpret_cast<const float4*>(w + r * ldc + t0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__fadd_rn(at(vv, i), delta_of(P, i, hid)), at(s, i)));
    }
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = bn_relu(acc[i], b2.mean[i], b2.inv[i], b2.weight[i], b2.bias[i]);
    *reinterpret_cast<float4*>(a.out + (cloud + q0 + ql) * C + c0) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// The plan, by the rule of pt_attention_plan: queries a block so that
// their neighbour rows times C stay within kTileElements (one at least, N
// at most), kThreads threads, the shared bytes of layout_of. Returns false
// for a shape the kernel does not take.
bool make_plan(int B, int N, int K, int C, int c, int* tile, int* threads, int* shared_bytes) {
  if (B <= 0 || B > 65535 || N <= 0 || K <= 0 || K > kMaxK || K > N || C <= 0 || C > kMaxC || c <= 0 ||
      c > kMaxPlanes || c % 4 != 0 || C % c != 0 || kThreads % (C / 4) != 0)
    return false;
  const int fit = kTileElements / (K * C);
  *tile = fit < 1 ? 1 : (fit < N ? fit : N);
  *threads = kThreads;
  *shared_bytes = 4 * layout_of(C, c, *tile * K).floats;
  return *shared_bytes <= kMaxSharedBytes;
}

}  // namespace

extern "C" {

// Point Transformer's attention and its block's bn2 pair over B clouds of
// N points: p [B, N, 3], q, k, v [B, N, C], idx [B, N, K] int64 and out
// [B, N, C], contiguous and 16-byte aligned (q, k, v, out, mlp_w0,
// mlp_w1); the position
// encoder's Linears pos_w0 [3, 3], pos_b0 [3], pos_w1 [C, 3], pos_b1 [C];
// the weight MLP's mlp_w0 [c, C], mlp_b0 [c], mlp_w1 [c, c], mlp_b1 [c];
// the four eval BatchNorms' running mean, running variance, weight and
// bias (bn_p 3 channels, bn_w C, bn_m c, bn2 C) and their eps. `tile`,
// `threads` and `shared_bytes` are the launch plan of
// kernels/pt_attention.py pt_attention_plan; they are computed here again
// and a launch whose plan differs is refused. Launches on `stream`;
// returns the cudaError_t of the launch (0 on success).
int plpe_pt_attention(const float* p, const float* q, const float* k, const float* v, const long long* idx,
                      float* out, const float* pos_w0, const float* pos_b0, const float* pos_w1,
                      const float* pos_b1, const float* mlp_w0, const float* mlp_b0, const float* mlp_w1,
                      const float* mlp_b1, const float* pos_mean, const float* pos_var, const float* pos_weight,
                      const float* pos_bias, const float* w_mean, const float* w_var, const float* w_weight,
                      const float* w_bias, const float* m_mean, const float* m_var, const float* m_weight,
                      const float* m_bias, const float* o_mean, const float* o_var, const float* o_weight,
                      const float* o_bias, int B, int N, int K, int C, int c, int tile, int threads,
                      int shared_bytes, float pos_eps, float w_eps, float m_eps, float o_eps, void* stream) {
  int my_tile, my_threads, my_shared;
  if (!make_plan(B, N, K, C, c, &my_tile, &my_threads, &my_shared) || tile != my_tile || threads != my_threads ||
      shared_bytes != my_shared)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.p = p;
  a.q = q;
  a.k = k;
  a.v = v;
  a.idx = idx;
  a.out = out;
  a.pos_w0 = pos_w0;
  a.pos_b0 = pos_b0;
  a.pos_w1 = pos_w1;
  a.pos_b1 = pos_b1;
  a.mlp_w0 = mlp_w0;
  a.mlp_b0 = mlp_b0;
  a.mlp_w1 = mlp_w1;
  a.mlp_b1 = mlp_b1;
  a.pos_bn = EvalBn{pos_mean, pos_var, pos_weight, pos_bias, pos_eps};
  a.weight_bn = EvalBn{w_mean, w_var, w_weight, w_bias, w_eps};
  a.mlp_bn = EvalBn{m_mean, m_var, m_weight, m_bias, m_eps};
  a.bn2 = EvalBn{o_mean, o_var, o_weight, o_bias, o_eps};
  a.N = N;
  a.K = K;
  a.C = C;
  a.c = c;
  a.tile = tile;
  if (shared_bytes > 48 * 1024) {
    // the most any launch takes, so that a graph's earlier launches of more
    // stay allowed after a later one of less
    cudaError_t err =
        cudaFuncSetAttribute(pt_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + tile - 1) / tile, B);
  pt_attention_kernel<<<grid, threads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
