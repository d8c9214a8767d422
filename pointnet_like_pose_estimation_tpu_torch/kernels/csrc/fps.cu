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
// dependent argmax reductions: the time of a call is S times the latency of
// one step's chain (the distance pass over the points a block holds, then
// the reduction), whatever the number of clouds. The paths shorten that
// chain where the cloud lets them:
//
// - Register path (C == 3 or C == 10, N <= 512 * 8): one block a cloud;
//   thread t owns points t, t + T, ..., PPT of them, and keeps their C
//   coordinates and running distances in registers, loaded once, coalesced,
//   before the loop: PPT * (C + 1) floats, 88 at C = 10 and PPT = 8 (117
//   registers with the rest, under the 128 that the C = 10 kernel's
//   __launch_bounds__(512) leaves; no spills). The distance pass
//   touches no memory. C = 10 is a pose head's cloud spliced with a 7-class
//   one-hot; 3 and 10 are the only channel counts the models' FPS calls use.
// - The winner's coordinates are a broadcast read from a copy of the cloud
//   in shared memory (N * C floats, 40 KB at 1024 x 10), so no global load
//   sits on the chain.
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
// - Cluster path (any C <= 16, N up to cluster * 57,280): one cloud on a
//   thread-block cluster of `cluster` blocks, launched with
//   cudaLaunchKernelEx. One block streaming a cloud from L2 is bound by
//   what one SM can pull (about 37 GB/s measured: 160 us a step at 300,000
//   points); a cluster splits the pass over `cluster` SMs. Block r owns the
//   contiguous slice [r * L, (r + 1) * L), L = ceil(N / cluster), keeps its
//   running distances in its own shared memory and, in the shared memory
//   left over, the coordinates of the slice's first points, so that only the
//   rest streams from L2 each step (1 x 300,000 x 3 over 16 blocks: 12,843
//   of each slice's 18,750 points held; 70,000 x 10: all of them). Each
//   thread keeps its candidate's coordinates beside its (value, index) as
//   it scans. A step then costs one __syncthreads() (the block's argmax, as
//   above), one round of stores into distributed shared memory (lane r of
//   the warp that owns the block's winner writes (bits, index, coordinates)
//   into block r's inbox through map_shared_rank), one cluster barrier
//   (barrier.cluster arrive.release / wait.acquire), and a reduction of the
//   inbox that every warp reads from its own shared memory, lowest index on
//   ties; so no global load sits on the chain. Pulling the records instead
//   (every warp of every block reading every block's record) cost 10 us a
//   step at 16 blocks of 1024 threads, whatever the slice: the pushes are
//   16 stores a block. The inbox is double-buffered by the step's parity:
//   the barrier of step i + 1 cannot pass until every block has read the
//   inbox of step i. The pass over the slice is what grows with N, the
//   barriers what stays: about 1.7 us a step at 57,857 points over 16
//   blocks of 512 threads, 4.4 us at 300,000 over 16 of 1024 (PERF.md).
// - Global path (any C <= 16, any N, for clouds above the cluster's
//   limit): the shared path's loop with the running distances in a [B, N]
//   float32 scratch in global memory that the caller allocates, one block a
//   cloud streaming it from one SM: simple and right, not fast. Offsets into
//   the cloud, the scratch and the output are formed in 64 bits, so that B *
//   N * C may pass 2^31.
//
// Rounding: every distance term is formed with __fsub_rn/__fmul_rn/__fadd_rn
// in channel order, so no multiply-add is contracted into an FMA and the
// result equals the elementwise PyTorch version bit for bit. Within a thread
// the points are visited in rising index order with a strict >, so the lower
// index wins ties there too; across warps, blocks and the cluster the lowest
// index among the maxima wins.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxChannels = 16;
constexpr int kMaxPointsPerThread = 8;
// the most threads the plan gives the register path (the C = 10 kernel's
// __launch_bounds__)
constexpr int kRegisterThreads = 512;
// the channel counts with register-path and cluster-path instances of their
// own: a cloud, and a pose head's cloud spliced with a 7-class one-hot
constexpr int kCloudChannels = 3;
constexpr int kSplicedChannels = 10;
// codes of the plan's points_per_thread that name the loops without
// registers (1, 2, 4 and 8 name the register path)
constexpr int kSharedPath = 0;
constexpr int kGlobalPath = -1;
constexpr int kClusterPath = -2;
// a cluster above 8 blocks is non-portable; Hopper schedules up to 16
constexpr int kMaxClusterBlocks = 16;
// threads of a cluster block of the any-C instance: its arrays of 16
// channels spill at the 64 registers a thread of 1024 may have
constexpr int kAnyChannelThreads = 512;
// dynamic shared memory of a block on the shared and cluster paths: the 227 KB
// a block may have, less 1 KB for the static arrays
constexpr int kMaxSharedBytes = 227 * 1024 - 1024;
// a cluster block's distances, less its inbox of 2 * 16 candidates of up to
// 2 + 16 words (the Candidate struct below)
constexpr int kMaxSliceBytes = kMaxSharedBytes - 2 * kMaxClusterBlocks * (2 + kMaxChannels) * 4;
constexpr int kMaxSlicePoints = kMaxSliceBytes / 4;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide argmax of (bits, idx), lower index on ties, with one barrier.
// `slots` is [2][32] pairs; `parity` alternates from step to step. Every
// thread returns the winner's (bits, index).
__device__ __forceinline__ uint2 block_max(unsigned bits, unsigned idx, uint2* slots, int parity,
                                           int lane, int warp, int num_warps) {
  const unsigned wmax = __reduce_max_sync(kFull, bits);
  const unsigned widx = __reduce_min_sync(kFull, bits == wmax ? idx : 0xffffffffu);
  uint2* slot = slots + parity * 32;
  if (lane == 0) slot[warp] = make_uint2(wmax, widx);
  __syncthreads();
  const uint2 part = lane < num_warps ? slot[lane] : make_uint2(0u, 0xffffffffu);
  const unsigned bmax = __reduce_max_sync(kFull, part.x);
  return make_uint2(bmax, __reduce_min_sync(kFull, part.x == bmax ? part.y : 0xffffffffu));
}

__device__ __forceinline__ int block_argmax(unsigned bits, unsigned idx, uint2* slots, int parity,
                                            int lane, int warp, int num_warps) {
  return static_cast<int>(block_max(bits, idx, slots, parity, lane, warp, num_warps).y);
}

// One cloud (block b) on the register path: kC channels, PPT points a thread.
template <int kC, int PPT>
__device__ __forceinline__ void register_steps(const float* __restrict__ points,  // [B, N, kC]
                                               const int* __restrict__ start,     // [B]
                                               int* __restrict__ out,             // [B, S]
                                               int N, int S, float* cloud_copy,   // [N * kC]
                                               uint2* slots) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = T >> 5;
  const float* cloud = points + static_cast<size_t>(b) * N * kC;

  for (int j = tid; j < N * kC; j += T) cloud_copy[j] = cloud[j];
  __syncthreads();

  float v[kC][PPT], dist[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int j = tid + p * T;
    const bool valid = j < N;
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c][p] = valid ? cloud_copy[j * kC + c] : 0.0f;
    dist[p] = valid ? 1e10f : -1.0f;  // -1 never beats a distance, which is >= 0
  }

  int far = start[b];
  int* row = out + static_cast<size_t>(b) * S;
  for (int i = 0; i < S; ++i) {
    if (tid == 0) row[i] = far;
    float cen[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) cen[c] = cloud_copy[far * kC + c];
    float best_v = -1.0f;
    int best_i = N;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      float t[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) t[c] = __fsub_rn(v[c][p], cen[c]);
      float d = __fmul_rn(t[0], t[0]);
#pragma unroll
      for (int c = 1; c < kC; ++c) d = __fadd_rn(d, __fmul_rn(t[c], t[c]));
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

// C = 3 takes no launch bound: its state stays far under the 64 registers a
// thread of 1024 may have, and a bound of 512 or 1024 made the compiler
// schedule the loop 20% slower on the card.
template <int PPT>
__global__ void fps_register_kernel(const float* __restrict__ points, const int* __restrict__ start,
                                    int* __restrict__ out, int N, int S) {
  extern __shared__ float cloud_copy[];  // [N * 3]
  __shared__ uint2 slots[2 * 32];
  register_steps<kCloudChannels, PPT>(points, start, out, N, S, cloud_copy, slots);
}

// C = 10 holds up to 88 floats of state a thread: the bound keeps the
// compiler at the 128 registers that 512 threads may have.
template <int PPT>
__global__ void __launch_bounds__(kRegisterThreads)
fps_register_spliced_kernel(const float* __restrict__ points, const int* __restrict__ start,
                            int* __restrict__ out, int N, int S) {
  extern __shared__ float cloud_copy[];  // [N * 10]
  __shared__ uint2 slots[2 * 32];
  register_steps<kSplicedChannels, PPT>(points, start, out, N, S, cloud_copy, slots);
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

// A block's candidate of one step, as it arrives in every block of the cluster.
template <int kC>
struct Candidate {
  unsigned bits;
  unsigned idx;
  float c[kC];
};

// The cluster path. kC is the channel count, or kMaxChannels for any C up to
// it given at run time. `slice` is L, the points a block owns; `cached` how
// many of a slice's first points keep their coordinates in shared memory.
template <int kC>
__global__ void __launch_bounds__(kC < kMaxChannels ? kMaxThreads : kAnyChannelThreads, 1)
fps_cluster_kernel(const float* __restrict__ points,  // [B, N, C]
                   const int* __restrict__ start,     // [B]
                   int* __restrict__ out,             // [B, S]
                   int N, int C, int S, int slice, int cached) {
  extern __shared__ float smem[];  // [slice] distances, then [cached * C] coordinates
  __shared__ uint2 slots[2 * 32];
  // [parity][block]: what each block of the cluster published at a step
  __shared__ Candidate<kC> inbox[2][kMaxClusterBlocks];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / blocks;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = T >> 5;
  const int nc = kC < kMaxChannels ? kC : C;  // a constant unless kC is the any-C instance
  const float* cloud = points + static_cast<size_t>(b) * N * nc;
  const int lo = rank * slice;
  const int len = max(0, min(slice, N - lo));
  const int held = min(cached, len);
  float* dist = smem;
  float* cache = smem + slice;

  for (int k = tid; k < len; k += T) dist[k] = 1e10f;
  for (int k = tid; k < held * nc; k += T) cache[k] = cloud[static_cast<size_t>(lo) * nc + k];
  int far = start[b];
  float cen[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) cen[c] = c < nc ? cloud[static_cast<size_t>(far) * nc + c] : 0.0f;
  int* row = out + static_cast<size_t>(b) * S;
  cluster.sync();  // every block of the cluster runs before any writes into its shared memory

  for (int i = 0; i < S; ++i) {
    if (rank == 0 && tid == 0) row[i] = far;
    float best_v = -1.0f;
    int best_i = N;
    float bc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) bc[c] = 0.0f;
    // point lo + k, its coordinates at p; k rises, so a strict > keeps the lower index
    auto visit = [&](const float* p, int k) {
      float x[kC];
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c < nc) {
          x[c] = p[c];
          const float t = __fsub_rn(x[c], cen[c]);
          d = __fadd_rn(d, __fmul_rn(t, t));
        }
      }
      const float m = fminf(dist[k], d);
      dist[k] = m;
      if (m > best_v) {
        best_v = m;
        best_i = lo + k;
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (c < nc) bc[c] = x[c];
      }
    };
    int k = tid;
    for (; k < held; k += T) visit(cache + static_cast<size_t>(k) * nc, k);
#pragma unroll 4
    for (; k < len; k += T) visit(cloud + static_cast<size_t>(lo + k) * nc, k);

    // the block's winner; the warp of its owner (warp 0 for a block without
    // points) pushes it, with its coordinates, into every block's inbox:
    // lane r writes block r's
    const unsigned bits = best_i < N ? __float_as_uint(best_v) : 0u;
    const uint2 win =
        block_max(bits, static_cast<unsigned>(best_i), slots, i & 1, lane, warp, num_warps);
    const bool found = win.y < static_cast<unsigned>(N);
    const unsigned owner = __ballot_sync(kFull, found && best_i == static_cast<int>(win.y));
    if (found ? owner != 0u : warp == 0) {
      const int src = found ? __ffs(owner) - 1 : 0;
      float wc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) wc[c] = __shfl_sync(kFull, bc[c], src);
      if (lane < blocks) {
        Candidate<kC>* to = cluster.map_shared_rank(&inbox[i & 1][rank], lane);
        to->bits = win.x;
        to->idx = win.y;
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (c < nc) to->c[c] = wc[c];
      }
    }
    cluster.sync();

    // every warp reduces the blocks' candidates from its own inbox
    unsigned rb = 0u, ri = 0xffffffffu;
    if (lane < blocks) {
      rb = inbox[i & 1][lane].bits;
      ri = inbox[i & 1][lane].idx;
    }
    const unsigned cmax = __reduce_max_sync(kFull, rb);
    const unsigned cidx = __reduce_min_sync(kFull, rb == cmax ? ri : 0xffffffffu);
    const int src = __ffs(__ballot_sync(kFull, lane < blocks && ri == cidx)) - 1;
    far = static_cast<int>(cidx);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c < nc) cen[c] = inbox[i & 1][src].c[c];
  }
  // every write into another block's inbox came before a cluster barrier that
  // block waited at, so no block can be written to after it leaves
}

template <int kC, int PPT>
cudaError_t launch_register(const float* points, const int* start, int* out, int B, int N, int S,
                            int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * kC * sizeof(float);
  const auto kernel =
      kC == kCloudChannels ? fps_register_kernel<PPT> : fps_register_spliced_kernel<PPT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(points, start, out, N, S);
  return cudaGetLastError();
}

template <int kC>
cudaError_t launch_register_c(const float* points, const int* start, int* out, int B, int N, int S,
                              int threads, int points_per_thread, cudaStream_t stream) {
  switch (points_per_thread) {
    case 1: return launch_register<kC, 1>(points, start, out, B, N, S, threads, stream);
    case 2: return launch_register<kC, 2>(points, start, out, B, N, S, threads, stream);
    case 4: return launch_register<kC, 4>(points, start, out, B, N, S, threads, stream);
    case 8: return launch_register<kC, 8>(points, start, out, B, N, S, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int kC>
cudaError_t launch_cluster(const float* points, const int* start, int* out, int B, int N, int C,
                           int S, int threads, int cluster, cudaStream_t stream) {
  // the slice a block owns (bad_cluster has checked that it fits), and the
  // points of it whose coordinates fit in the shared memory its distances leave
  const int slice = (N + cluster - 1) / cluster;
  const int cached = std::min(slice, (kMaxSliceBytes - slice * 4) / (4 * C));
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(slice) + static_cast<size_t>(cached) * C);
  cudaError_t err = cudaFuncSetAttribute(fps_cluster_kernel<kC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(fps_cluster_kernel<kC>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, fps_cluster_kernel<kC>, points, start, out, N, C, S, slice,
                           cached);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int B, int N, int C, int threads) {
  return B <= 0 || N <= 0 || C <= 0 || C > kMaxChannels || threads <= 0 ||
         threads > kMaxThreads || threads % 32 != 0 || N > 0x7fffffff - kMaxThreads;
}

bool bad_cluster(int N, int C, int threads, int cluster) {
  const bool own_instance = C == kCloudChannels || C == kSplicedChannels;
  return cluster < 2 || cluster > kMaxClusterBlocks ||
         (N + cluster - 1) / cluster > kMaxSlicePoints ||
         (!own_instance && threads > kAnyChannelThreads);
}

}  // namespace

extern "C" {

// `threads` and `points_per_thread` are the launch plan (kernels/fps.py
// fps_plan): points_per_thread in {1, 2, 4, 8} takes the register path and
// needs C == 3 or 10, threads <= kRegisterThreads and N <= threads *
// points_per_thread; kSharedPath takes the shared path; kClusterPath the
// cluster path, on clusters of `cluster` blocks (2 to 16), which needs N <=
// cluster * kMaxSlicePoints and, for C other than 3 and 10, threads <=
// kAnyChannelThreads; kGlobalPath the global path, which needs
// `scratch`, a [B, N] float32 buffer (ignored by the other paths). N must
// leave room for a block's stride below 2^31. Launches on `stream`; returns
// the cudaError_t of the launch (0 on success), so a refused cluster launch
// is an error.
int plpe_fps(const float* points, const int* start, int* out, float* scratch, int B, int N, int C,
             int S, int threads, int points_per_thread, int cluster, void* stream) {
  if (bad_shape(B, N, C, threads) || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
  if (points_per_thread == kClusterPath) {
    if (bad_cluster(N, C, threads, cluster)) return static_cast<int>(cudaErrorInvalidValue);
    if (C == kCloudChannels)
      err = launch_cluster<kCloudChannels>(points, start, out, B, N, C, S, threads, cluster, st);
    else if (C == kSplicedChannels)
      err = launch_cluster<kSplicedChannels>(points, start, out, B, N, C, S, threads, cluster, st);
    else
      err = launch_cluster<kMaxChannels>(points, start, out, B, N, C, S, threads, cluster, st);
    return static_cast<int>(err);
  }
  if (points_per_thread < 0 || points_per_thread > kMaxPointsPerThread ||
      threads > kRegisterThreads || static_cast<long long>(threads) * points_per_thread < N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == kCloudChannels)
    err = launch_register_c<kCloudChannels>(points, start, out, B, N, S, threads,
                                            points_per_thread, st);
  else if (C == kSplicedChannels)
    err = launch_register_c<kSplicedChannels>(points, start, out, B, N, S, threads,
                                              points_per_thread, st);
  return static_cast<int>(err);
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
