// Fused eval-mode set abstraction for Hopper (sm_90a).
//
// Replaces the TPU kernel pointnet_like_pose_estimation_tpu/kernels/
// fused_sa.py (_fused_sa_kernel, driven by fused_sa_infer).
//
// What it computes, for each (cloud b, centroid s) and each radius scale l:
// select the K_l lowest point indices within r_l of the centroid, on the
// first 3 channels only (the ball scan of ball_scan.cuh, so the neighbours
// equal ball_group.cu's bit for bit); gather those rows of ptsfeat
// [B, N, P] and subtract the centroid from their first 3 channels; run the
// shared MLP relu(x @ W + b) layer by layer, BatchNorm already folded into
// (W, b); take the max over the K rows. Scale l's features sit at channel
// offset sum(C_last[:l]) of the [B, S, sum C_last] f32 output. Nothing of
// shape [B, S, K, C] ever reaches device memory.
//
// What bounds it: f32 operations. The MLP costs 2 * sum(Cin * Cout) flops
// per neighbour row, which outweighs the bytes (one read of ptsfeat, the
// centroids and the weights, one write of the output) by far. The design
// keeps those flops on the FMA pipes with few other instructions: one
// block of 256 threads per (cloud, centroid) walks its K neighbours in
// chunks of up to 32 rows. A chunk is gathered, centred and stored
// channel-major ([C][rows], pitch 36) in shared memory; each layer writes
// the next into a second buffer (ping-pong); the last layer folds into a
// running max per output channel. A thread owns one output channel and 8
// rows of a chunk, so each weight it reads from global memory (L1/L2
// resident) feeds 8 explicit fused multiply-adds, and the 8 inputs arrive
// as two float4 broadcasts from shared memory. With -fmad=false nothing
// else is contracted; __fmaf_rn is kept. Tensor cores (wgmma, 3xTF32) and
// TMA are later work.
//
// Rows past K in the last chunk repeat a selected neighbour, which leaves
// the max unchanged, so no row is masked.

#include <cuda_runtime.h>

#include "ball_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxScales = kThreads / 32;  // one warp selects each scale
constexpr int kMaxLayers = 4;
constexpr int kRowsPerItem = 8;
constexpr int kMaxRows = 32;               // neighbour rows per chunk
constexpr int kPitch = kMaxRows + 4;       // float4 stores of 8 threads hit 32 banks
constexpr int kGroups = kMaxRows / kRowsPerItem;
constexpr int kMaxDynamicShared = 227 * 1024 - 1024;

struct Layer {
  const float* w;  // [cin, cout]
  const float* b;  // [cout]
  int cin;
  int cout;
};

struct Scale {
  float r2;
  int k;
  int k_off;  // offset of this scale's indices in sel / idx_out
  int c_off;  // offset of this scale's features in the output
  int n_layers;
  Layer layer[kMaxLayers];
};

struct Params {
  int count;
  int k_total;
  int c_total;
  Scale scale[kMaxScales];
};

__global__ void __launch_bounds__(kThreads)
fused_sa_kernel(const float* __restrict__ ptsfeat,    // [B, N, P]
                const float* __restrict__ centroids,  // [B, S, 3]
                float* __restrict__ out,              // [B, S, c_total]
                int* __restrict__ idx_out,            // [B, S, k_total] or null
                int N, int S, int P, int buf0_rows, int buf1_rows, int pool_cols,
                const __grid_constant__ Params prm) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);        // [max(P, odd widths)][kPitch]
  float* buf1 = buf0 + buf0_rows * kPitch;              // [even widths][kPitch]
  float* pool = buf1 + buf1_rows * kPitch;              // [kGroups][c_last]
  int* sel = reinterpret_cast<int*>(pool + kGroups * pool_cols);  // [k_total]
  __shared__ float cen[3];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long task = blockIdx.x;  // b * S + s
  const float* cloud = ptsfeat + static_cast<size_t>(task / S) * N * P;
  if (tid < 3) cen[tid] = centroids[task * 3 + tid];
  __syncthreads();

  if (warp < prm.count) {
    const Scale& sc = prm.scale[warp];
    plpe::ball_scan(cloud, P, N, cen, 3, plpe::sq_norm(cen, 3), sc.r2, sc.k, sel + sc.k_off);
  }
  __syncthreads();
  if (idx_out != nullptr)
    for (int i = tid; i < prm.k_total; i += kThreads) idx_out[task * prm.k_total + i] = sel[i];

  for (int l = 0; l < prm.count; ++l) {
    const Scale& sc = prm.scale[l];
    const int K = sc.k;
    const int rows = min(kMaxRows, (K + kRowsPerItem - 1) / kRowsPerItem * kRowsPerItem);
    const int groups = rows / kRowsPerItem;
    const int c_last = sc.layer[sc.n_layers - 1].cout;
    for (int i = tid; i < groups * c_last; i += kThreads) pool[i] = 0.0f;  // relu >= 0

    for (int k0 = 0; k0 < K; k0 += rows) {
      __syncthreads();  // the previous chunk is done with buf0
      for (int i = tid; i < rows * P; i += kThreads) {
        const int r = i / P;
        const int c = i - r * P;
        const int j = sel[sc.k_off + (k0 + r < K ? k0 + r : k0)];
        float v = cloud[static_cast<size_t>(j) * P + c];
        if (c < 3) v = __fsub_rn(v, cen[c]);
        buf0[c * kPitch + r] = v;
      }
      __syncthreads();

      const float* in = buf0;
      for (int li = 0; li < sc.n_layers; ++li) {
        const Layer& L = sc.layer[li];
        const bool last = li == sc.n_layers - 1;
        float* dst = (li & 1) ? buf0 : buf1;
        for (int item = tid; item < groups * L.cout; item += kThreads) {
          const int g = item / L.cout;
          const int o = item - g * L.cout;
          const float* x = in + g * kRowsPerItem;
          const float* w = L.w + o;
          float acc[kRowsPerItem] = {};
#pragma unroll 4
          for (int c = 0; c < L.cin; ++c) {
            const float wc = __ldg(w + static_cast<size_t>(c) * L.cout);
            const float4 x0 = *reinterpret_cast<const float4*>(x + c * kPitch);
            const float4 x1 = *reinterpret_cast<const float4*>(x + c * kPitch + 4);
            acc[0] = __fmaf_rn(x0.x, wc, acc[0]);
            acc[1] = __fmaf_rn(x0.y, wc, acc[1]);
            acc[2] = __fmaf_rn(x0.z, wc, acc[2]);
            acc[3] = __fmaf_rn(x0.w, wc, acc[3]);
            acc[4] = __fmaf_rn(x1.x, wc, acc[4]);
            acc[5] = __fmaf_rn(x1.y, wc, acc[5]);
            acc[6] = __fmaf_rn(x1.z, wc, acc[6]);
            acc[7] = __fmaf_rn(x1.w, wc, acc[7]);
          }
          const float bias = __ldg(L.b + o);
#pragma unroll
          for (int r = 0; r < kRowsPerItem; ++r) acc[r] = fmaxf(__fadd_rn(acc[r], bias), 0.0f);
          if (!last) {
            float* y = dst + o * kPitch + g * kRowsPerItem;
            *reinterpret_cast<float4*>(y) = make_float4(acc[0], acc[1], acc[2], acc[3]);
            *reinterpret_cast<float4*>(y + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
          } else {
            float m = acc[0];
#pragma unroll
            for (int r = 1; r < kRowsPerItem; ++r) m = fmaxf(m, acc[r]);
            float* p = pool + g * c_last + o;  // owned by this item alone
            *p = fmaxf(*p, m);
          }
        }
        __syncthreads();
        in = dst;
      }
    }

    float* row = out + task * prm.c_total + sc.c_off;
    for (int o = tid; o < c_last; o += kThreads) {
      float m = pool[o];
      for (int g = 1; g < groups; ++g) m = fmaxf(m, pool[g * c_last + o]);
      row[o] = m;
    }
    __syncthreads();  // the next scale re-initialises the pool
  }
}

}  // namespace

extern "C" {

// Host arrays: r2, ks and layer_counts hold one entry per scale; widths
// one per layer (scale-major), and weights two device pointers per layer,
// W [cin, cout] then b [cout]. Layer 1's cin is P, with W rows ordered
// [coords, features]. idx_out may be null. Launches on `stream`; returns
// the cudaError_t of the launch (0 on success).
int plpe_fused_sa(const float* ptsfeat, const float* centroids, float* out, int* idx_out,
                  int B, int N, int S, int P, int num_scales, const float* r2, const int* ks,
                  const int* layer_counts, const int* widths, const void* const* weights,
                  void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || P < 3 || num_scales <= 0 || num_scales > kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  prm.count = num_scales;
  int buf0_rows = P, buf1_rows = 0, pool_cols = 0, w_i = 0, k_off = 0, c_off = 0;
  for (int l = 0; l < num_scales; ++l) {
    const int n = layer_counts[l];
    if (ks[l] <= 0 || n <= 0 || n > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
    Scale& sc = prm.scale[l];
    sc.r2 = r2[l];
    sc.k = ks[l];
    sc.k_off = k_off;
    sc.c_off = c_off;
    sc.n_layers = n;
    int cin = P;
    for (int li = 0; li < n; ++li, ++w_i) {
      const int cout = widths[w_i];
      if (cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
      sc.layer[li] = {static_cast<const float*>(weights[2 * w_i]),
                      static_cast<const float*>(weights[2 * w_i + 1]), cin, cout};
      if (li < n - 1) {
        if (li & 1) buf0_rows = buf0_rows > cout ? buf0_rows : cout;
        else buf1_rows = buf1_rows > cout ? buf1_rows : cout;
      }
      cin = cout;
    }
    pool_cols = pool_cols > cin ? pool_cols : cin;
    k_off += ks[l];
    c_off += cin;
  }
  prm.k_total = k_off;
  prm.c_total = c_off;
  const size_t shared = sizeof(float) * (static_cast<size_t>(buf0_rows + buf1_rows) * kPitch +
                                         static_cast<size_t>(kGroups) * pool_cols) +
                        sizeof(int) * static_cast<size_t>(k_off);
  const long long blocks = static_cast<long long>(B) * S;
  if (shared > static_cast<size_t>(kMaxDynamicShared) || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sa_kernel<<<static_cast<unsigned>(blocks), kThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      ptsfeat, centroids, out, idx_out, N, S, P, buf0_rows, buf1_rows, pool_cols, prm);
  return static_cast<int>(cudaGetLastError());
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
