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
// What bounds it: the rate at which an SM takes instructions. The bytes are tiny (one read of the
// points and centroids, one write of the indices) and the distance
// arithmetic is B*S*N*(2P+2) flops for a full scan beside B*N*2P for the
// points' norms, but every rounding
// step is an instruction of its own (no FMA, see below), and around them
// sit the loads, the compare and the compaction of the in-ball indices.
// The design cuts the instructions per (centroid, point) pair and keeps
// enough warps in flight to keep the schedulers fed:
//
// - A block owns one cloud and a tile of its centroids, ONE CENTROID A
//   THREAD. It stages the cloud once into shared memory, point-major,
//   each point as [|p|^2, p_0 .. p_{P-1}] padded to a multiple of four
//   floats, so |p|^2 is formed once per point and block, not once per
//   centroid. In the scan every lane of a warp reads the same point: one
//   broadcast 16-byte load serves 32 centroids and has no bank conflict.
//   (A warp per centroid with a ballot needs the loads, a vote, two
//   popcounts and the slot arithmetic for every 32 pairs and scale; a
//   thread per centroid needs a compare and a predicated store.)
// - The centroid sits in registers as -2*c, so that the inner product
//   comes out already scaled: the distance is P multiplies and P+1 adds.
// - One pass serves all scales: one distance per pair, one compare and
//   one predicated store per scale, each scale with its own count. A warp
//   leaves the scan when every scale of its 32 centroids is full; the
//   test is made once per kStep points, whose loads go out together.
// - The scan is straight-line code. A thread collects its indices in a
//   tile of shared memory: a store there is one predicated instruction on
//   a 32-bit address, where a store to the output row cost a divergent
//   branch and 64-bit address arithmetic for every point and scale.
// - A centroid a thread leaves only B*S/32 warps, one a scheduler at the
//   model's shapes, and nothing hides the latency of a step's chain. So
//   `split` threads (4, 2 or 1, the launch plan) share a centroid: thread
//   q scans the q-th part of the points into a segment of its own, all 32
//   lanes of a warp on the same part, so the loads stay broadcasts. After
//   the scan the parts' counts are exchanged through shared memory, part
//   q appends its indices behind those of the parts before it, up to K,
//   part 0 fills the tail with the first in-ball index, and the block
//   copies the finished rows, which are contiguous in the output, fully
//   coalesced. A part cannot know that the parts before it are full, so it
//   stops only when it holds K itself.
// - A cloud that does not fit the 227 KB of opt-in shared memory beside the
//   index segments takes the global path of the same kernel: the points
//   are read through L1 by broadcast loads and |p|^2 is formed once per
//   point and warp. Before that the plan gives up the split and halves the
//   centroid tile.
//
// Rounding: d2 = (-2*inner + |c|^2) + |p|^2 with inner and both norms
// summed over the channels in order and every step rounded on its own
// (__fmul_rn/__fadd_rn, nothing contracted into an FMA): the form and
// order of the PyTorch version (ops/geometry.py square_distance). Scaling
// by -2 is exact in binary floating point, so (-2*c_i)*p_i rounds to
// -2*(c_i*p_i) and the sum of the scaled products equals -2*inner bit for
// bit. No point flips across a radius boundary between the two versions.
//
// The launch plan (centroid tile, split, shared bytes) is made by kernels/ball_group.py ball_query_plan and computed here again by
// the same rule: a launch whose plan differs is refused.

#include <cuda_runtime.h>

#include <cmath>

// points whose loads and distances a thread forms together; STEP of
// kernels/ball_group.py (a macro so that the tuning script can vary it)
#ifndef PLPE_BQ_STEP
#define PLPE_BQ_STEP 16
#endif

namespace {

constexpr int kStep = PLPE_BQ_STEP;
constexpr int kMaxScales = 8;
constexpr int kMaxChannels = 32;
constexpr int kMaxThreads = 256;               // tile * split
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kSplitMaxIndices = 64;           // sum(ks) up to which four threads share a centroid
constexpr unsigned kFull = 0xffffffffu;

struct Scales {
  int count;
  float r2[kMaxScales];   // -inf past `count`: never in the ball
  int k[kMaxScales];      // 0 past `count`: full from the start
  int k_off[kMaxScales];
};

// One launch: the problem and its plan.
struct Launch {
  int B, N, S, P, k_total;
  int tile, split;        // centroids a block; threads a centroid
  long long cloud_bytes;  // the staged cloud, 0 on the global path
  long long shared_bytes;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// floats of one staged point: |p|^2, then the channels, padded to 16 bytes
__host__ __device__ constexpr int point_stride(int P) { return round_up(P + 1, 4); }

// kP > 0: exactly kP channels, all loops unrolled to it. kP == 0: any
// P <= kMaxChannels at run time. kL: the scales held in registers, at
// least the call's count. kShared: the cloud is staged in shared memory.
template <int kP, int kL, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
ball_query_kernel(const float* __restrict__ points,     // [B, N, P]
                  const float* __restrict__ centroids,  // [B, S, P]
                  int* __restrict__ out,                // [B, S, sum K]
                  int N, int S, int P_any, int tiles, int k_total, int tile, int split,
                  Scales sc) {
  constexpr int kCh = kP > 0 ? kP : kMaxChannels;  // channels a thread can hold
  constexpr int kVec = point_stride(kCh) / 4;
  const int P = kP > 0 ? kP : P_any;
  const int vecs = kP > 0 ? kVec : point_stride(P) / 4;  // float4s per staged point

  // [round_up(N, kStep)][vecs] float4 when kShared; then the index segments
  // [split][tile][k_total] (part 0's hold the finished rows); then the
  // parts' counts [kL][split][tile]
  extern __shared__ float4 staged[];
  const int threads = tile * split;
  const int b = blockIdx.x / tiles;
  const int first_s = (blockIdx.x - b * tiles) * tile;
  const float* cloud = points + static_cast<size_t>(b) * N * P;
  const int n_pad = round_up(N, kStep);
  int* segments = reinterpret_cast<int*>(staged + (kShared ? static_cast<size_t>(n_pad) * vecs : 0));
  int* counts = segments + threads * k_total;

  if (kShared) {
    float* flat = reinterpret_cast<float*>(staged);
    for (int j = threadIdx.x; j < n_pad; j += threads) {
      float* dst = flat + static_cast<size_t>(j) * vecs * 4;
      float pp = INFINITY;  // a point past N is in no ball
      if (j < N) {
        pp = 0.0f;
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          if (c < P) {
            const float v = cloud[static_cast<size_t>(j) * P + c];
            dst[1 + c] = v;
            pp = __fadd_rn(pp, __fmul_rn(v, v));
          }
      } else {
        for (int c = 0; c < P; ++c) dst[1 + c] = 0.0f;
      }
      dst[0] = pp;
      for (int c = P + 1; c < vecs * 4; ++c) dst[c] = 0.0f;
    }
    __syncthreads();
  }

  // thread = (part q, centroid c of the tile); a warp lies within one part
  const int q = threadIdx.x / tile;
  const int c_tile = threadIdx.x - q * tile;
  const int s = first_s + c_tile;
  const bool active = s < S;
  const float* cen = centroids + (static_cast<size_t>(b) * S + (active ? s : S - 1)) * P;
  float c2[kCh];
  float cc = 0.0f;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const float v = c < P ? cen[c] : 0.0f;
    cc = c < P ? __fadd_rn(cc, __fmul_rn(v, v)) : cc;
    c2[c] = -2.0f * v;
  }

  int* row = segments + threadIdx.x * k_total;
  int found[kL], want[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    found[l] = 0;
    want[l] = active ? sc.k[l] : 0;
  }

  const int part = round_up((n_pad + split - 1) / split, kStep);
  const int j_end = min(n_pad, (q + 1) * part);
  for (int j0 = q * part; j0 < j_end; j0 += kStep) {
    bool full = true;
#pragma unroll
    for (int l = 0; l < kL; ++l) full = full && found[l] >= want[l];
    if (__all_sync(kFull, full)) break;
    // first every distance of the step, so that the loads and the
    // rounding chains of its points overlap; then the compares and the
    // predicated stores, whose counts chain from point to point
    float d2[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const int j = j0 + u;
      float v[kVec * 4];
      if (kShared) {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (kP > 0 || i < vecs) {
            const float4 t = staged[static_cast<size_t>(j) * vecs + i];
            v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
          }
      } else {
        const float* p = cloud + static_cast<size_t>(min(j, N - 1)) * P;
        float pp = 0.0f;
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          if (c < P) {
            v[1 + c] = p[c];
            pp = __fadd_rn(pp, __fmul_rn(v[1 + c], v[1 + c]));
          }
        v[0] = j < N ? pp : INFINITY;
      }
      float acc = __fmul_rn(c2[0], v[1]);
#pragma unroll
      for (int c = 1; c < kCh; ++c)
        if (c < P) acc = __fadd_rn(acc, __fmul_rn(c2[c], v[1 + c]));
      d2[u] = __fadd_rn(__fadd_rn(acc, cc), v[0]);
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const bool in_ball = d2[u] <= sc.r2[l];
        if (in_ball && found[l] < want[l]) row[sc.k_off[l] + found[l]] = j0 + u;
        found[l] += in_ball ? 1 : 0;
      }
    }
  }

  // Merge the parts: counts through shared memory; part q appends behind
  // the parts before it, into part 0's segment, which becomes the row.
#pragma unroll
  for (int l = 0; l < kL; ++l) counts[(l * split + q) * tile + c_tile] = min(found[l], want[l]);
  __syncthreads();
  int* final_row = segments + c_tile * k_total;
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    int before = 0;
    for (int p = 0; p < q; ++p) before += counts[(l * split + p) * tile + c_tile];
    if (q > 0) {
      const int take = min(min(found[l], want[l]), want[l] - before);
      for (int i = 0; i < take; ++i)
        final_row[sc.k_off[l] + before + i] = row[sc.k_off[l] + i];
    }
  }
  __syncthreads();
  // Part 0 fills the tail with the first in-ball index, slot 0 of the
  // merged row, or with N-1; then the block copies its rows out.
  if (q == 0) {
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      int total = 0;
      for (int p = 0; p < split; ++p) total += counts[(l * split + p) * tile + c_tile];
      int* dst = final_row + sc.k_off[l];
      const int fill = total > 0 ? dst[0] : N - 1;
      for (int slot = total; slot < want[l]; ++slot) dst[slot] = fill;
    }
  }
  __syncthreads();
  const int rows = min(tile, S - first_s);
  int* out_tile = out + (static_cast<size_t>(b) * S + first_s) * k_total;
  for (int i = threadIdx.x; i < rows * k_total; i += threads) out_tile[i] = segments[i];
}

template <int kP, int kL, bool kShared>
cudaError_t launch(const float* points, const float* centroids, int* out, const Launch& a,
                   const Scales& sc, cudaStream_t stream) {
  const int tiles = (a.S + a.tile - 1) / a.tile;
  const long long blocks = static_cast<long long>(a.B) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.shared_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ball_query_kernel<kP, kL, kShared>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(a.shared_bytes));
    if (err != cudaSuccess) return err;
  }
  ball_query_kernel<kP, kL, kShared>
      <<<static_cast<unsigned>(blocks), a.tile * a.split, a.shared_bytes, stream>>>(
          points, centroids, out, a.N, a.S, a.P, tiles, a.k_total, a.tile, a.split, sc);
  return cudaGetLastError();
}

template <int kP, int kL>
cudaError_t launch_path(const float* points, const float* centroids, int* out, const Launch& a,
                        const Scales& sc, cudaStream_t stream) {
  return a.cloud_bytes > 0 ? launch<kP, kL, true>(points, centroids, out, a, sc, stream)
                           : launch<kP, kL, false>(points, centroids, out, a, sc, stream);
}

template <int kP>
cudaError_t launch_scales(int held, const float* points, const float* centroids, int* out,
                          const Launch& a, const Scales& sc, cudaStream_t stream) {
  if (held == 1) return launch_path<kP, 1>(points, centroids, out, a, sc, stream);
  if (held == 3) return launch_path<kP, 3>(points, centroids, out, a, sc, stream);
  return launch_path<kP, kMaxScales>(points, centroids, out, a, sc, stream);
}

// The plan, by the rule of ball_query_plan: (tile, split) is the first of
// (64, 4) [only while sum K <= kSplitMaxIndices], (128, 2), (64, 2),
// (128, 1), (64, 1), (32, 1) whose index segments and counts fit beside the staged
// cloud; if none does, the first that fits without it (the global path).
bool make_plan(int N, int P, int k_total, int held, Launch* a) {
  const long long staged = 16LL * (point_stride(P) / 4) * round_up(N, kStep);
  const int options[6][2] = {{64, 4}, {128, 2}, {64, 2}, {128, 1}, {64, 1}, {32, 1}};
  for (int pass = 0; pass < 2; ++pass) {
    const long long cloud = pass == 0 ? staged : 0;
    for (const auto& option : options) {
      if (option[1] == 4 && k_total > kSplitMaxIndices) continue;
      const long long threads = static_cast<long long>(option[0]) * option[1];
      const long long nbytes = cloud + 4 * threads * k_total + 4 * threads * held;
      if (nbytes <= kMaxSharedBytes) {
        a->tile = option[0], a->split = option[1];
        a->cloud_bytes = cloud, a->shared_bytes = nbytes;
        return true;
      }
    }
  }
  return false;
}

}  // namespace

extern "C" {

// r2[l] and ks[l] are host arrays of `num_scales` entries. `tile`
// (centroids a block), `split` (threads a centroid), `held` (scales held in registers: 1, 3 or 8), `cloud_bytes`
// (the staged cloud; 0: the global path) and `shared_bytes` (cloud, index
// segments and counts) are the launch plan of kernels/ball_group.py
// ball_query_plan; they are computed here again by the same rule and a
// launch whose plan differs is refused. Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
int plpe_ball_query(const float* points, const float* centroids, int* out,
                    int B, int N, int S, int P, const float* r2, const int* ks,
                    int num_scales, int tile, int split, int held, int cloud_bytes,
                    int shared_bytes, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || P <= 0 || P > kMaxChannels ||
      num_scales <= 0 || num_scales > kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  Scales sc;
  sc.count = num_scales;
  int k_total = 0;
  for (int l = 0; l < kMaxScales; ++l) {
    if (l < num_scales && ks[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    sc.r2[l] = l < num_scales ? r2[l] : -INFINITY;
    sc.k[l] = l < num_scales ? ks[l] : 0;
    sc.k_off[l] = k_total;
    k_total += sc.k[l];
  }
  const int my_held = num_scales == 1 ? 1 : num_scales <= 3 ? 3 : kMaxScales;
  Launch a = {B, N, S, P, k_total, 0, 0, 0, 0};
  if (!make_plan(N, P, k_total, my_held, &a)) return static_cast<int>(cudaErrorInvalidValue);
  if (tile != a.tile || split != a.split || held != my_held ||
      cloud_bytes != a.cloud_bytes || shared_bytes != a.shared_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (P == 3)
    err = launch_scales<3>(held, points, centroids, out, a, sc, st);
  else if (P == 10)
    err = launch_scales<10>(held, points, centroids, out, a, sc, st);
  else
    err = launch_scales<0>(held, points, centroids, out, a, sc, st);
  return static_cast<int>(err);
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
