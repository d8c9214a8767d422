// Single- and multi-scale ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel pointnet_like_pose_estimation_tpu/kernels/
// ball_group.py (_ball_query_kernel, driven by ball_query_multi_pallas and
// ball_query_pallas).
//
// What it computes: for every centroid and every scale l, the K_l lowest
// point indices whose squared distance over all P channels is <= r_l^2.
// Empty slots repeat the first in-ball index; a ball with no point at all
// is filled with N-1. Scale l sits at K-offset sum(ks[:l]) of the
// [B, S, sum(ks)] int32 output.
//
// What bounds it: the distance arithmetic, B*S*N*(3P+3) flops for a full
// scan, against bytes that are tiny (one read of the points and centroids,
// one write of the indices). The design cuts the arithmetic the data does
// not need: one warp per (cloud, centroid) runs the ballot scan of
// ball_scan.cuh, which stops a scale as soon as K in-ball points are found.
// The [S, N] distance tile is never stored. The scan rounds d2 exactly as
// the PyTorch version (ops/geometry.py square_distance) does, so no point
// flips across the radius boundary between the two.

#include <cuda_runtime.h>

#include "ball_scan.cuh"

namespace {

constexpr int kMaxScales = 8;
constexpr int kMaxChannels = 32;
constexpr int kWarpsPerBlock = 8;

struct Scales {
  int count;
  float r2[kMaxScales];
  int k[kMaxScales];
};

__global__ void ball_query_kernel(const float* __restrict__ points,     // [B, N, P]
                                  const float* __restrict__ centroids,  // [B, S, P]
                                  int* __restrict__ out,                // [B, S, sum K]
                                  int B, int N, int S, int P, int k_total,
                                  Scales scales) {
  __shared__ float cen[kWarpsPerBlock][kMaxChannels];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (task >= static_cast<long long>(B) * S) return;  // whole warp leaves together
  const int b = static_cast<int>(task / S);

  const float* c_ptr = centroids + task * P;
  for (int c = lane; c < P; c += 32) cen[warp][c] = c_ptr[c];
  __syncwarp();
  const float cc = plpe::sq_norm(cen[warp], P);

  const float* cloud = points + static_cast<size_t>(b) * N * P;
  int* row = out + task * k_total;
  for (int l = 0; l < scales.count; ++l) {
    plpe::ball_scan(cloud, P, N, cen[warp], P, cc, scales.r2[l], scales.k[l], row);
    row += scales.k[l];
  }
}

}  // namespace

extern "C" {

// r2[l] and ks[l] are host arrays of `num_scales` entries. Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
int plpe_ball_query(const float* points, const float* centroids, int* out,
                    int B, int N, int S, int P, const float* r2, const int* ks,
                    int num_scales, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || P <= 0 || P > kMaxChannels ||
      num_scales <= 0 || num_scales > kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  Scales scales;
  scales.count = num_scales;
  int k_total = 0;
  for (int l = 0; l < num_scales; ++l) {
    if (ks[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    scales.r2[l] = r2[l];
    scales.k[l] = ks[l];
    k_total += ks[l];
  }
  const long long tasks = static_cast<long long>(B) * S;
  const long long blocks = (tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      points, centroids, out, B, N, S, P, k_total, scales);
  return static_cast<int>(cudaGetLastError());
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
