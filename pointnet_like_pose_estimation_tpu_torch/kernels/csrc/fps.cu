// Batched farthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel pointnet_like_pose_estimation_tpu/kernels/fps.py
// (_fps_kernel, driven by fps_pallas).
//
// What it computes: for each cloud, S sequential steps. Step i records the
// current farthest index, updates the running minimum squared distance
// (initialised to 1e10) against that point, and takes the argmax of the
// running minimum; on equal values the lower index wins (jnp.argmax's rule).
//
// What bounds it: not bytes (one read of the cloud, one write of [B, S]
// indices) and not arithmetic (3C flops per point per step), but the S
// dependent block-wide argmax reductions: the time of a call is S times the
// latency of one step's chain, whatever the number of clouds (one block per
// cloud, up to one per SM). The design shortens that chain:
//
// - Register path (C == 3, N <= threads * PPT): thread t owns points t,
//   t + T, ..., PPT of them, and keeps their coordinates and running
//   distances in registers, loaded once, coalesced, before the loop. The
//   distance pass touches no memory.
// - The winner's coordinates are a broadcast read from a copy of the cloud
//   in shared memory, so no global load sits on the chain.
// - Distances are >= 0, so their bits order as unsigned integers. A warp
//   reduces with two redux.sync: __reduce_max_sync on the bits, then
//   __reduce_min_sync on the index among the lanes that hold the maximum.
//   Idle lanes carry bits 0 and index N.
// - One barrier a step: lane 0 of each warp stores its (bits, index) pair in
//   a slot of a double-buffered shared array (parity of the step); after the
//   single __syncthreads() every warp reads all the partials and reduces
//   them itself, so every thread knows the winner.
// - Shared path (any C <= 16, any N up to what shared memory holds): the
//   running distances live in dynamic shared memory and the coordinates are
//   read through L1, with the same one-barrier reduction.
// - Global path (any C <= 16, any N): the same loop, with the running
//   distances in a [B, N] float32 scratch in global memory that the caller
//   allocates. Each step streams the cloud and its distances through L2
//   from the one SM of the block: simple and right for clouds above shared
//   memory, not fast. It needs no dynamic shared memory. Offsets into the
//   cloud, the scratch and the output are formed in 64 bits, so that B * N
//   * C may pass 2^31.
//
// Rounding: every distance term is formed with __fsub_rn/__fmul_rn/__fadd_rn
// in channel order, so no multiply-add is contracted into an FMA and the
// result equals the elementwise PyTorch version bit for bit. Within a thread
// the points are visited in rising index order with a strict >, so the lower
// index wins ties there too.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxChannels = 16;
constexpr int kMaxPointsPerThread = 8;
// codes of the plan's points_per_thread that name the two loops without
// registers (1, 2, 4 and 8 name the register path)
constexpr int kSharedPath = 0;
constexpr int kGlobalPath = -1;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide argmax of (bits, idx), lower index on ties, with one barrier.
// `slots` is [2][32] pairs; `parity` alternates from step to step. Every
// thread returns the winner's index.
__device__ __forceinline__ int block_argmax(unsigned bits, unsigned idx, uint2* slots, int parity,
                                            int lane, int warp, int num_warps) {
  const unsigned wmax = __reduce_max_sync(kFull, bits);
  const unsigned widx = __reduce_min_sync(kFull, bits == wmax ? idx : 0xffffffffu);
  uint2* slot = slots + parity * 32;
  if (lane == 0) slot[warp] = make_uint2(wmax, widx);
  __syncthreads();
  const uint2 part = lane < num_warps ? slot[lane] : make_uint2(0u, 0xffffffffu);
  const unsigned bmax = __reduce_max_sync(kFull, part.x);
  return static_cast<int>(__reduce_min_sync(kFull, part.x == bmax ? part.y : 0xffffffffu));
}

template <int PPT>
__global__ void fps_register_kernel(const float* __restrict__ points,  // [B, N, 3]
                                    const int* __restrict__ start,     // [B]
                                    int* __restrict__ out,             // [B, S]
                                    int N, int S) {
  extern __shared__ float cloud_copy[];  // [N * 3]
  __shared__ uint2 slots[2 * 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = T >> 5;
  const float* cloud = points + static_cast<size_t>(b) * N * 3;

  for (int j = tid; j < N * 3; j += T) cloud_copy[j] = cloud[j];
  __syncthreads();

  float x[PPT], y[PPT], z[PPT], dist[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int j = tid + p * T;
    const bool valid = j < N;
    x[p] = valid ? cloud_copy[j * 3 + 0] : 0.0f;
    y[p] = valid ? cloud_copy[j * 3 + 1] : 0.0f;
    z[p] = valid ? cloud_copy[j * 3 + 2] : 0.0f;
    dist[p] = valid ? 1e10f : -1.0f;  // -1 never beats a distance, which is >= 0
  }

  int far = start[b];
  int* row = out + static_cast<size_t>(b) * S;
  for (int i = 0; i < S; ++i) {
    if (tid == 0) row[i] = far;
    const float cx = cloud_copy[far * 3 + 0];
    const float cy = cloud_copy[far * 3 + 1];
    const float cz = cloud_copy[far * 3 + 2];
    float best_v = -1.0f;
    int best_i = N;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const float tx = __fsub_rn(x[p], cx);
      const float ty = __fsub_rn(y[p], cy);
      const float tz = __fsub_rn(z[p], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)), __fmul_rn(tz, tz));
      const float m = fminf(dist[p], d);
      dist[p] = m;
      if (m > best_v) {  // the index rises with p, so a strict > keeps the lower one
        best_v = m;
        best_i = tid + p * T;
      }
    }
    const unsigned bits = best_i < N ? __float_as_uint(best_v) : 0u;
    far = block_argmax(bits, static_cast<unsigned>(best_i), slots, i & 1, lane, warp, num_warps);
  }
}

// The shared path (kGlobal false: distances in dynamic shared memory) and the
// global path (kGlobal true: distances in the caller's [B, N] scratch).
template <bool kGlobal>
__global__ void fps_dist_kernel(const float* __restrict__ points,  // [B, N, C]
                                const int* __restrict__ start,     // [B]
                                int* __restrict__ out,             // [B, S]
                                float* __restrict__ scratch,       // [B, N], global path only
                                int N, int C, int S) {
  extern __shared__ float shared_dist[];  // [N], shared path only
  __shared__ uint2 slots[2 * 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = T >> 5;
  const float* cloud = points + static_cast<size_t>(b) * N * C;
  float* dist = kGlobal ? scratch + static_cast<size_t>(b) * N : shared_dist;

  for (int j = tid; j < N; j += T) dist[j] = 1e10f;  // each thread only ever touches its own j

  int far = start[b];
  int* row = out + static_cast<size_t>(b) * S;
  for (int i = 0; i < S; ++i) {
    if (tid == 0) row[i] = far;
    float cen[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      cen[c] = c < C ? cloud[static_cast<size_t>(far) * C + c] : 0.0f;
    float best_v = -1.0f;
    int best_i = N;
    for (int j = tid; j < N; j += T) {
      const float* p = cloud + static_cast<size_t>(j) * C;
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) {
          const float t = __fsub_rn(p[c], cen[c]);
          d = __fadd_rn(d, __fmul_rn(t, t));
        }
      }
      const float m = fminf(dist[j], d);
      dist[j] = m;
      if (m > best_v) {  // j rises, so a strict > keeps the lower index
        best_v = m;
        best_i = j;
      }
    }
    const unsigned bits = best_i < N ? __float_as_uint(best_v) : 0u;
    far = block_argmax(bits, static_cast<unsigned>(best_i), slots, i & 1, lane, warp, num_warps);
  }
}

template <int PPT>
cudaError_t launch_register(const float* points, const int* start, int* out, int B, int N, int S,
                            int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_register_kernel<PPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_register_kernel<PPT><<<B, threads, smem, stream>>>(points, start, out, N, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `threads` and `points_per_thread` are the launch plan (kernels/fps.py
// fps_plan): points_per_thread in {1, 2, 4, 8} takes the register path and
// needs C == 3 and N <= threads * points_per_thread; kSharedPath takes the
// shared path; kGlobalPath the global path, which needs `scratch`, a [B, N]
// float32 buffer (ignored by the other paths). N must leave room for a
// block's stride below 2^31. Launches on `stream`; returns the cudaError_t
// of the launch (0 on success).
int plpe_fps(const float* points, const int* start, int* out, float* scratch, int B, int N, int C,
             int S, int threads, int points_per_thread, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || C <= 0 || C > kMaxChannels || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || N > 0x7fffffff - kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (points_per_thread == kGlobalPath) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_dist_kernel<true><<<B, threads, 0, st>>>(points, start, out, scratch, N, C, S);
    return static_cast<int>(cudaGetLastError());
  }
  if (points_per_thread == kSharedPath) {
    const size_t smem = static_cast<size_t>(N) * sizeof(float);
    err = cudaFuncSetAttribute(fps_dist_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fps_dist_kernel<false><<<B, threads, smem, st>>>(points, start, out, nullptr, N, C, S);
    return static_cast<int>(cudaGetLastError());
  }
  if (C != 3 || points_per_thread < 0 || points_per_thread > kMaxPointsPerThread ||
      static_cast<long long>(threads) * points_per_thread < N)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (points_per_thread) {
    case 1: err = launch_register<1>(points, start, out, B, N, S, threads, st); break;
    case 2: err = launch_register<2>(points, start, out, B, N, S, threads, st); break;
    case 4: err = launch_register<4>(points, start, out, B, N, S, threads, st); break;
    case 8: err = launch_register<8>(points, start, out, B, N, S, threads, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
