// Ball selection by one warp, used by fused_sa.cu, whose warps select the
// neighbours of the centroids of a block's tile. The ball query itself
// (ball_group.cu) scans with one centroid a thread instead; both form d2
// with the same rounding, so the two pick the same neighbours bit for bit,
// and both are held against ball_query_reference.
//
// The warp scans the points in index order 32 at a time. __ballot_sync on
// d2 <= r^2 yields the in-ball points of the chunk already in index order,
// and the scan stops as soon as K of them are found. The distances of
// kUnroll chunks are formed together, so that their loads overlap (the
// fused kernel's selecting warps have nothing else to hide them behind);
// the ballots still go chunk by chunk and stop at K. d2 is
// (-2*inner + |c|^2) + |p|^2, with inner and both norms summed over the
// channels in order, every step with __fmul_rn/__fadd_rn so that nothing
// is contracted into an FMA: the form and order of the PyTorch version
// (ops/geometry.py square_distance).

#pragma once

#include <cuda_runtime.h>

namespace plpe {

// |v|^2 over n channels, summed in channel order, each step rounded.
__device__ __forceinline__ float sq_norm(const float* v, int n) {
  float acc = 0.0f;
  for (int c = 0; c < n; ++c) acc = __fadd_rn(acc, __fmul_rn(v[c], v[c]));
  return acc;
}

// Called by a whole warp for one centroid `cen` of `nch` channels, whose
// |cen|^2 is `cc`. Point j starts at cloud + j * stride and its first
// `nch` channels count. Writes the K lowest in-ball indices to row[0, K):
// empty slots repeat the first in-ball index, a ball with no point in it
// is filled with N-1.
__device__ __forceinline__ void ball_scan(const float* __restrict__ cloud, int stride, int N,
                                          const float* cen, int nch, float cc, float r2, int K,
                                          int* row) {
  constexpr int kUnroll = 4;
  const int lane = threadIdx.x & 31;
  const unsigned lower_lanes = (1u << lane) - 1u;
  int found = 0;
  int first = N - 1;  // the fill of a ball with no point in it
  for (int base = 0; base < N && found < K; base += 32 * kUnroll) {
    // channels outermost, so that the chunks' loads of one channel go together
    const float* p[kUnroll];
    float inner[kUnroll], pp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = min(base + u * 32 + lane, N - 1);
      p[u] = cloud + static_cast<size_t>(j) * stride;
      inner[u] = pp[u] = 0.0f;
    }
    for (int c = 0; c < nch; ++c) {
      const float cv = cen[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float v = p[u][c];
        inner[u] = __fadd_rn(inner[u], __fmul_rn(cv, v));
        pp[u] = __fadd_rn(pp[u], __fmul_rn(v, v));
      }
    }
    bool in_ball[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(-2.0f, inner[u]), cc), pp[u]);
      in_ball[u] = base + u * 32 + lane < N && d2 <= r2;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (found < K) {  // the same for every lane
        const int first_j = base + u * 32;
        const unsigned mask = __ballot_sync(0xffffffffu, in_ball[u]);
        if (in_ball[u]) {
          const int slot = found + __popc(mask & lower_lanes);
          if (slot < K) row[slot] = first_j + lane;
        }
        if (found == 0 && mask != 0u) first = first_j + __ffs(mask) - 1;
        found += __popc(mask);
      }
    }
  }
  for (int slot = found + lane; slot < K; slot += 32) row[slot] = first;
}

}  // namespace plpe
