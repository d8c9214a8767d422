// Exact k-nearest-neighbour query for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no model that selects
// neighbours by rank. It was added for Point Transformer
// (nn/point_transformer.py), whose attention and TransitionDown group the
// k nearest points of each query.
//
// What it computes: for every query q of a cloud of N points, the indices
// of the k points nearest to it, nearest first, a tie in distance going to
// the lower index; k <= min(kMaxK, N). The squared distance is
// ((dx*dx + dy*dy) + dz*dz), each step rounded on its own
// (__fsub_rn/__fmul_rn/__fadd_rn, and the library is built with
// -fmad=false), so that it equals the plain version's
// (kernels/knn.py knn_reference) bit for bit and both rank alike.
//
// What bounds it: the rate at which the SMs take instructions. The bytes
// are the points, the queries and the int64 indices once; the arithmetic
// is 9 operations a (query, point) pair (3 subtractions, 3 multiplies, 2 adds,
// 1 compare), B*S*N*9 in all, some 300 MFLOP at a request's first stage,
// 4.5 us at the float32 peak. The design keeps the lanes busy with those 9
// and keeps the rest per candidate, not per pair:
//
// - ONE WARP A QUERY. A block owns one cloud and a tile of its queries; it
//   stages the cloud once into shared memory (12 bytes a point) and each
//   warp takes its share of the tile's queries in turn. The warp scans the
//   points 32 at a time, one a lane, so the lanes never wait on each
//   other's branches. (One thread a query kept its own sorted list, and a
//   warp then ran an insertion whenever any of its 32 lists took a point:
//   at a request's shapes almost every step, and the kernel ran at 0.5% of
//   its bound.)
// - The K best (distance, index) pairs so far are held across the warp,
//   slot t in lane t, sorted ascending; the K-th distance is known to every
//   lane. A ballot of the chunk's distances below it gives the candidates,
//   already in index order; each is broadcast and, if still below the K-th
//   (an earlier candidate may have lowered it), inserted by one shift of
//   the slots behind it (shfl_up) in a handful of warp instructions. The
//   candidates come in increasing index, so a strict compare breaks ties to
//   the lower index. After the first chunks few distances pass the ballot.
//
// - K is 4, 8 or 16, the first of them that holds k, and the first k
//   slots are written: the list is sorted by (distance, index), so they
//   are the k nearest. Point Transformer asks for k = 4, 8 and 16, and no
//   other K is built.
//
// The launch plan (threads a block, queries a block, shared bytes) is made
// by kernels/knn.py knn_plan and computed here again by the same rule: a
// launch whose plan differs is refused.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxWarps = 8;
constexpr int kMaxTile = 32;
constexpr int kMaxPoints = 16384;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(32 * kMaxWarps)
    knn_kernel(const float* __restrict__ points, const float* __restrict__ queries,
               long long* __restrict__ out, int N, int S, int k, int tile) {
  extern __shared__ float cloud[];  // N * 3 floats
  const int b = blockIdx.y;
  const float* pts = points + static_cast<long long>(b) * N * 3;
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) cloud[i] = pts[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * tile;
  const int last = min(first + tile, S);
  for (int s = first + (threadIdx.x >> 5); s < last; s += warps) {
    const float* q = queries + (static_cast<long long>(b) * S + s) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    float slot_d = INFINITY;  // lane t < K: the t-th nearest so far
    int slot_i = 0x7fffffff;
    float worst = INFINITY;   // the K-th nearest distance so far, the same in every lane
    for (int base = 0; base < N; base += 32) {
      const int j = base + lane;
      float d = INFINITY;
      if (j < N) {
        const float dx = __fsub_rn(cloud[3 * j], qx);
        const float dy = __fsub_rn(cloud[3 * j + 1], qy);
        const float dz = __fsub_rn(cloud[3 * j + 2], qz);
        d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
      unsigned cand = __ballot_sync(kAll, d < worst);
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float cd = __shfl_sync(kAll, d, src);
        if (!(cd < worst)) continue;  // the same in every lane
        const bool after = cd < slot_d;               // the candidate goes at or before this slot
        const bool moved = __shfl_up_sync(kAll, after, 1) && lane > 0;  // ... and before the slot ahead
        const float up_d = __shfl_up_sync(kAll, slot_d, 1);
        const int up_i = __shfl_up_sync(kAll, slot_i, 1);
        slot_d = moved ? up_d : (after ? cd : slot_d);
        slot_i = moved ? up_i : (after ? base + src : slot_i);
        worst = __shfl_sync(kAll, slot_d, K - 1);
      }
    }
    if (lane < k) out[(static_cast<long long>(b) * S + s) * k + lane] = slot_i;
  }
}

// The plan, by the rule of knn_plan: a warp a query up to kMaxWarps,
// kMaxTile queries a block at most, the staged cloud's bytes.
void make_plan(int N, int S, int* threads, int* tile, int* shared_bytes) {
  *threads = 32 * (S < kMaxWarps ? S : kMaxWarps);
  *tile = S < kMaxTile ? S : kMaxTile;
  *shared_bytes = 12 * N;
}

template <int K>
cudaError_t launch(const float* points, const float* queries, long long* out, int B, int N, int S, int k,
                   int threads, int tile, int shared_bytes, cudaStream_t stream) {
  if (shared_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(knn_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           shared_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + tile - 1) / tile, B);
  knn_kernel<K><<<grid, threads, shared_bytes, stream>>>(points, queries, out, N, S, k, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// points [B, N, 3] and queries [B, S, 3] float32, out [B, S, k] int64 (the
// type the gathers take, so that none converts them), all
// contiguous. `threads`, `tile` (queries a block) and `shared_bytes` are
// the launch plan of kernels/knn.py knn_plan; they are computed here again
// by the same rule and a launch whose plan differs is refused. Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
int plpe_knn(const float* points, const float* queries, long long* out, int B, int N, int S, int k,
             int threads, int tile, int shared_bytes, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0 || k <= 0 || k > kMaxK || k > N || N > kMaxPoints || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int my_threads, my_tile, my_shared;
  make_plan(N, S, &my_threads, &my_tile, &my_shared);
  if (threads != my_threads || tile != my_tile || shared_bytes != my_shared || my_shared > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 4) return static_cast<int>(launch<4>(points, queries, out, B, N, S, k, threads, tile, shared_bytes, st));
  if (k <= 8) return static_cast<int>(launch<8>(points, queries, out, B, N, S, k, threads, tile, shared_bytes, st));
  return static_cast<int>(launch<16>(points, queries, out, B, N, S, k, threads, tile, shared_bytes, st));
}

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
