// Fused eval-mode set abstraction for Hopper (sm_90a).
//
// Replaces the TPU kernel pointnet_like_pose_estimation_tpu/kernels/
// fused_sa.py (_fused_sa_kernel, driven by fused_sa_infer).
//
// What it computes, for each (cloud b, centroid s) and each radius scale l:
// select the K_l lowest point indices within r_l of the centroid, on the
// first 3 channels only (the ball scan of ball_scan.cuh, which rounds d2
// as ball_group.cu does, so the neighbours equal the ball query's bit for
// bit); gather those rows of ptsfeat
// [B, N, P] and subtract the centroid from their first 3 channels; run the
// shared MLP relu(x @ W + b) layer by layer, BatchNorm already folded into
// (W, b); take the max over the K rows. Scale l's features sit at channel
// offset sum(C_last[:l]) of the [B, S, sum C_last] f32 output. Nothing of
// shape [B, S, K, C] ever reaches device memory.
//
// What bounds it: operations. The MLP costs 2 * sum(Cin * Cout) flops per
// neighbour row, which outweighs the bytes (one read of ptsfeat, the
// centroids and the weights, one write of the output) by far. The design
// puts those flops on the tensor cores and feeds them from shared memory:
//
// - A block of 512 threads owns a tile of TC centroids of one cloud. A
//   scale's K is padded to a multiple of 16 (Kp), so the TC * Kp neighbour
//   rows of the tile form 16-row MMA tiles that never straddle a centroid,
//   and the MLP runs over chunks of R = 64 or 128 rows that span several
//   centroids where K < R. Rows past K repeat the centroid's first
//   neighbour, rows past the tile and centroids past S (the ragged last
//   tile of a cloud) repeat the last centroid: duplicates leave a max
//   unchanged, so nothing is masked but the final store. The wrapper gives
//   a block up to four chunks' worth of centroids, so that the block's
//   set-up and its selection are shared by more work.
// - Every warp selects: one warp per (centroid, scale) pair runs the ball
//   scan, looping when there are more pairs than warps.
// - Activations are f32, row-major [R][pitch] in two ping-pong buffers; a
//   pitch of 4 mod 8 floats makes the A-fragment loads conflict-free. The
//   gather uses 4-byte cp.async, coalesced along a row and all in flight at
//   once: rows of ptsfeat with P = 131 or 323 start on 4-byte boundaries
//   only, and padding ptsfeat for 16-byte copies would cost the executor
//   another pass over it for a gather that is about 1/Cout of the MLP's
//   work.
// - Weights pass through a ring of kStages shared-memory stages in slices
//   of kSliceRows input channels by up to 128 output channels, filled with
//   16-byte cp.async (zero-filled past Cin) kStages - 1 slices ahead of the
//   MMAs, across layers, chunks and scales. A weight is read from L2 once
//   per chunk of R rows. The stage pitch of 136 floats (8 mod 32) makes the
//   B-fragment loads conflict-free.
// - The products are mma.sync.m16n8k8 TF32 with the three-product error
//   compensation (3xTF32): each f32 operand is split into hi = x rounded to
//   TF32 and lo = x - hi cut to TF32, in registers as its fragment is
//   loaded, with integer operations (cvt.rna.tf32.f32 measured slower),
//   activations and weights alike (splitting in shared memory would double
//   both the activation buffers and the ring), and a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi accumulate in f32, small terms first, term by term over a
//   warp's tiles so that no MMA waits on the one before it. mma.sync was
//   taken over wgmma: it reads row-major f32 fragments from plain padded
//   shared memory, needs no K-major swizzled layouts or descriptors, and
//   its accumulator layout makes the max over K a few shuffles. A warp owns
//   32 rows by up to 32 columns of a chunk. Measured on an H100, mma.sync
//   m16n8k8 TF32 takes about 9 cycles of an SM sub-partition
//   (scripts/profile_torch_fused_sa.py), under half the tensor cores' wgmma
//   rate: that, times three, is this kernel's ceiling, near the f32 FMA
//   peak.
// - Layer 1 of a call on bare coordinates (P == 3) stays in __fmaf_rn,
//   three per output.
// - Biases are copied to shared memory once per block. Bias, ReLU and the
//   max over K stay in registers: the last layer's accumulators are reduced
//   over the 16 rows of an MMA tile with shuffles and merged across warps
//   and chunks with shared-memory atomicMax on the bits (ReLU outputs are
//   >= 0, so they order as integers). The output is written once.

#include <cuda_runtime.h>

#include "ball_scan.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxScales = 8;
constexpr int kMaxLayers = 4;
constexpr int kSliceRows = 32;   // input channels per weight slice
constexpr int kStages = 3;       // ring depth
constexpr int kChunkCols = 128;  // output channels per pass over a layer's input
constexpr int kStagePitch = kChunkCols + 8;
constexpr int kStageFloats = kSliceRows * kStagePitch;
constexpr int kMaxDynamicShared = 227 * 1024 - 1024;

struct Layer {
  const float* w;  // [cin, cout]
  const float* b;  // [cout]
  int cin;
  int cin_pad;  // cin rounded up to the MMA depth of 8
  int cout;
  int b_off;    // offset of this layer's bias in the block's shared copy
};

struct Scale {
  float r2;
  int k;
  int kp;         // k rounded up to 16
  int k_off;      // offset of this scale's indices in sel / idx_out
  int c_off;      // offset of this scale's features in the output
  int n_layers;
  int first_mma;  // 1 when layer 0 runs as FMAs (P == 3), else 0
  int n_chunks;   // ceil(TC * kp / R)
  Layer layer[kMaxLayers];
};

struct Params {
  int count;
  int k_total;
  int c_total;
  int b_total;  // biases of all layers
  Scale scale[kMaxScales];
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row pitch of an activation buffer `c` channels wide: 4 mod 8 floats.
__host__ __device__ constexpr int act_pitch(int c) { return round_up(c, 8) + 4; }

// A profiling build (-DPLPE_PROFILE, scripts/profile_torch_fused_sa.py)
// has thread 0 of every block add the cycles it spends in each phase to
// g_phase_cycles. None of this is in the library the port loads.
#ifdef PLPE_PROFILE
enum Phase { kSetUp, kSelect, kGather, kLayer0, kRingWait, kProducts, kEpilogue, kStore, kPhases };
__device__ unsigned long long g_phase_cycles[kPhases];
#define PLPE_PHASE(phase)                                                          \
  do {                                                                             \
    if (threadIdx.x == 0) {                                                        \
      const long long now = clock64();                                             \
      atomicAdd(&g_phase_cycles[phase], static_cast<unsigned long long>(now - phase_start)); \
      phase_start = now;                                                           \
    }                                                                              \
  } while (0)
#else
#define PLPE_PHASE(phase)
#endif

// hi = x rounded to TF32's 10 mantissa bits (to nearest, ties away from
// zero), lo = x - hi cut to 10 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// c += a * b for one 16x8 (row-major) by 8x8 (column) TF32 tile. Thread
// (g = lane / 4, t = lane % 4) holds a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, c = {C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The compensated product: small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&a_hi)[4],
                                           const unsigned (&a_lo)[4], const unsigned (&b_hi)[2],
                                           const unsigned (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Position in the block's sequence of weight slices: scale, chunk of rows,
// layer, chunk of output columns, first input channel.
struct Cursor {
  int sc, chunk, li, nc, k0;
};

// Moves `c` forward to the next position that names a slice; c.sc ==
// prm.count when the sequence is over.
__device__ __forceinline__ void settle(Cursor& c, const Params& prm) {
  while (c.sc < prm.count) {
    const Scale& s = prm.scale[c.sc];
    if (c.chunk >= s.n_chunks) {
      c.chunk = 0;
      ++c.sc;
      c.li = c.sc < prm.count ? prm.scale[c.sc].first_mma : 0;
    } else if (c.li >= s.n_layers) {
      c.li = s.first_mma;
      ++c.chunk;
    } else if (c.nc * kChunkCols >= s.layer[c.li].cout) {
      c.nc = 0;
      ++c.li;
    } else if (c.k0 >= s.layer[c.li].cin_pad) {
      c.k0 = 0;
      ++c.nc;
    } else {
      return;
    }
  }
}

// Starts the copy of the slice at `c` into `stage`.
__device__ __forceinline__ void copy_slice(const Cursor& c, const Params& prm, float* stage) {
  const Layer& L = prm.scale[c.sc].layer[c.li];
  const int col0 = c.nc * kChunkCols;
  const int vecs = min(kChunkCols, L.cout - col0) / 4;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < kSliceRows * vecs; e += kThreads) {
    const int r = e / vecs;
    const int v = e - r * vecs;
    const bool valid = c.k0 + r < L.cin;
    const float* src = valid ? L.w + static_cast<size_t>(c.k0 + r) * L.cout + col0 + v * 4 : L.w;
    cp_async_16(stage + r * kStagePitch + v * 4, src, valid);
  }
}

template <int WARPS_M>
__global__ void __launch_bounds__(kThreads, 1)  // 128 registers a thread at most
fused_sa_kernel(const float* __restrict__ ptsfeat,    // [B, N, P]
                const float* __restrict__ centroids,  // [B, S, 3]
                float* __restrict__ out,              // [B, S, c_total]
                int* __restrict__ idx_out,            // [B, S, k_total] or null
                int N, int S, int P, int TC, int tiles, int pitch0, int pitch1,
                const __grid_constant__ Params prm) {
  constexpr int R = 32 * WARPS_M;            // neighbour rows per chunk
  constexpr int WARPS_N = kWarps / WARPS_M;  // warps across the output columns
  constexpr int NT = kChunkCols / 8 / WARPS_N;  // 8-column MMA tiles a warp owns at most

  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);  // [R][pitch0]: gathered rows, odd layers' outputs
  float* buf1 = buf0 + R * pitch0;                // [R][pitch1]: even layers' outputs
  float* ring = buf1 + R * pitch1;                // [kStages][kSliceRows][kStagePitch]
  int* pool = reinterpret_cast<int*>(ring + kStages * kStageFloats);  // [TC][c_total] max, as bits
  float* cen = reinterpret_cast<float*>(pool + TC * prm.c_total);     // [TC][4]
  int* sel = reinterpret_cast<int*>(cen + TC * 4);                    // [TC][k_total]
  float* bias = reinterpret_cast<float*>(sel + TC * prm.k_total);     // [b_total]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int b = blockIdx.x / tiles;
  const int s0 = (blockIdx.x - b * tiles) * TC;  // the tile's first centroid
  const float* cloud = ptsfeat + static_cast<size_t>(b) * N * P;

#ifdef PLPE_PROFILE
  long long phase_start = clock64();
#endif
  // the weight ring starts filling before anything else
  Cursor prod = {0, 0, prm.scale[0].first_mma, 0, 0};
  settle(prod, prm);
  int prod_stage = 0, cons_stage = 0;
  for (int i = 0; i < kStages - 1; ++i) {
    if (prod.sc < prm.count) {
      copy_slice(prod, prm, ring + prod_stage * kStageFloats);
      prod.k0 += kSliceRows;
      settle(prod, prm);
    }
    cp_async_commit();
    prod_stage = (prod_stage + 1) % kStages;
  }

  for (int i = tid; i < TC * prm.c_total; i += kThreads) pool[i] = 0;  // relu >= 0
  for (int l = 0; l < prm.count; ++l)
    for (int li = 0; li < prm.scale[l].n_layers; ++li) {
      const Layer& L = prm.scale[l].layer[li];
      for (int o = tid; o < L.cout; o += kThreads) bias[L.b_off + o] = L.b[o];
    }
  if (tid < TC * 3) {
    const int c = tid / 3;
    const int ch = tid - c * 3;
    const int s = min(s0 + c, S - 1);
    cen[c * 4 + ch] = centroids[(static_cast<size_t>(b) * S + s) * 3 + ch];
  }
  __syncthreads();
  PLPE_PHASE(kSetUp);

  for (int pair = warp; pair < TC * prm.count; pair += kWarps) {
    const int c = pair / prm.count;
    const Scale& sc = prm.scale[pair - c * prm.count];
    const float* cc = cen + c * 4;
    plpe::ball_scan(cloud, P, N, cc, 3, plpe::sq_norm(cc, 3), sc.r2, sc.k,
                    sel + c * prm.k_total + sc.k_off);
  }
  __syncthreads();
  PLPE_PHASE(kSelect);
  if (idx_out != nullptr)
    for (int i = tid; i < TC * prm.k_total; i += kThreads) {
      const int c = i / prm.k_total;
      if (s0 + c < S)
        idx_out[(static_cast<size_t>(b) * S + s0) * prm.k_total + i] = sel[i];
    }

  const int p_fill = P == 3 ? 3 : round_up(P, 8);  // channels of a gathered row, zero-padded
  for (int l = 0; l < prm.count; ++l) {
    const Scale& sc = prm.scale[l];
    for (int chunk = 0; chunk < sc.n_chunks; ++chunk) {
      const int q0 = chunk * R;  // the chunk's first row among the tile's TC * kp rows
      __syncthreads();           // the previous chunk is done with both buffers

      // gather: one thread per row of bare coordinates; else one warp per
      // row, the lanes along the channels, by 4-byte asynchronous copies
      // that are all in flight at once (the wait also covers the ring's
      // copies in flight, which does the ring no harm)
      const bool wide = P != 3;
      for (int r = wide ? warp : tid; r < R; r += wide ? kWarps : kThreads) {
        const int q = q0 + r;
        int c = q / sc.kp;
        int k = q - c * sc.kp;
        if (c >= TC) {
          c = TC - 1;
          k = 0;
        }
        if (k >= sc.k) k = 0;
        const int j = sel[c * prm.k_total + sc.k_off + k];
        const float* src = cloud + static_cast<size_t>(j) * P;
        float* dst = buf0 + r * pitch0;
        if (wide) {
          for (int ch = lane; ch < p_fill; ch += 32) {
            if (ch < P) cp_async_4(dst + ch, src + ch);
            else dst[ch] = 0.0f;
          }
        } else {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) dst[ch] = __fsub_rn(src[ch], cen[c * 4 + ch]);
        }
      }
      if (wide) {
        cp_async_commit();
        cp_async_wait<0>();
        // a lane centres the coordinates it copied itself
        if (lane < 3)
          for (int r = warp; r < R; r += kWarps) {
            const int c = min((q0 + r) / sc.kp, TC - 1);
            buf0[r * pitch0 + lane] = __fsub_rn(buf0[r * pitch0 + lane], cen[c * 4 + lane]);
          }
      }
      __syncthreads();
      PLPE_PHASE(kGather);

      if (sc.first_mma == 1) {  // layer 0 on bare coordinates: three FMAs per output
        const Layer& L = sc.layer[0];
        const bool last = sc.n_layers == 1;
        const int cw = min(L.cout, kThreads);  // columns a pass covers, one a thread
        const int rp = kThreads / cw;          // rows a pass covers
        for (int ob = 0; ob < L.cout; ob += cw) {
          const int o = ob + tid % cw;
          if (o < L.cout && tid < rp * cw) {
            const float w0 = __ldg(L.w + o);
            const float w1 = __ldg(L.w + L.cout + o);
            const float w2 = __ldg(L.w + 2 * L.cout + o);
            const float bo = bias[L.b_off + o];
            for (int r = tid / cw; r < R; r += rp) {
              const float* x = buf0 + r * pitch0;
              const float y = fmaxf(
                  __fmaf_rn(x[2], w2, __fmaf_rn(x[1], w1, __fmaf_rn(x[0], w0, bo))), 0.0f);
              if (!last) {
                buf1[r * pitch1 + o] = y;
              } else {
                const int c = min((q0 + r) / sc.kp, TC - 1);
                atomicMax(pool + c * prm.c_total + sc.c_off + o, __float_as_int(y));
              }
            }
          }
        }
      }
      PLPE_PHASE(kLayer0);
      for (int li = sc.first_mma; li < sc.n_layers; ++li) {
        const Layer& L = sc.layer[li];
        const bool last = li == sc.n_layers - 1;
        const float* in = (li & 1) ? buf1 : buf0;
        const int in_pitch = (li & 1) ? pitch1 : pitch0;
        float* dst = (li & 1) ? buf0 : buf1;
        const int dst_pitch = (li & 1) ? pitch0 : pitch1;
        const float* a_row = in + (wm * 32 + g) * in_pitch + t;

        for (int col0 = 0; col0 < L.cout; col0 += kChunkCols) {
          const int tiles_n = min(kChunkCols, L.cout - col0) / 8;
          const int per_warp = (tiles_n + WARPS_N - 1) / WARPS_N;
          const int nt0 = wn * per_warp;
          const int my_nt = max(0, min(per_warp, tiles_n - nt0));
          float acc[2][NT][4] = {};

          for (int k0 = 0; k0 < L.cin_pad; k0 += kSliceRows) {
            // take the next slice from the ring and keep the ring full
            PLPE_PHASE(kProducts);
            cp_async_wait<kStages - 2>();
            __syncthreads();
            PLPE_PHASE(kRingWait);
            if (prod.sc < prm.count) {
              copy_slice(prod, prm, ring + prod_stage * kStageFloats);
              prod.k0 += kSliceRows;
              settle(prod, prm);
            }
            cp_async_commit();
            prod_stage = (prod_stage + 1) % kStages;
            const float* w_st = ring + cons_stage * kStageFloats + nt0 * 8 + g;
            cons_stage = (cons_stage + 1) % kStages;

            const int steps = min(kSliceRows, L.cin_pad - k0) / 8;
#pragma unroll
            for (int ks = 0; ks < kSliceRows / 8; ++ks) {
              if (ks >= steps) break;
              unsigned a_hi[2][4], a_lo[2][4];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float* a = a_row + i * 16 * in_pitch + k0 + ks * 8;
                split_tf32(a[0], a_hi[i][0], a_lo[i][0]);
                split_tf32(a[8 * in_pitch], a_hi[i][1], a_lo[i][1]);
                split_tf32(a[4], a_hi[i][2], a_lo[i][2]);
                split_tf32(a[8 * in_pitch + 4], a_hi[i][3], a_lo[i][3]);
              }
              const float* w_k = w_st + (ks * 8 + t) * kStagePitch;
              unsigned b_hi[NT][2], b_lo[NT][2];
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                if (nt < my_nt) {
                  split_tf32(w_k[nt * 8], b_hi[nt][0], b_lo[nt][0]);
                  split_tf32(w_k[nt * 8 + 4 * kStagePitch], b_hi[nt][1], b_lo[nt][1]);
                }
              }
              // the compensated product, small terms first; term by term over
              // all of the warp's tiles, so that the three MMAs into one
              // accumulator never wait on each other
#pragma unroll
              for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  if (nt < my_nt) {
#pragma unroll
                    for (int i = 0; i < 2; ++i)
                      mma_tf32(acc[i][nt], term == 0 ? a_lo[i] : a_hi[i],
                               term == 1 ? b_lo[nt] : b_hi[nt]);
                  }
                }
              }
            }
          }

          PLPE_PHASE(kProducts);
          // epilogue: bias and ReLU in registers; store, or max over the rows
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt < my_nt) {
              const int col = col0 + (nt0 + nt) * 8 + 2 * t;
              const float bias0 = bias[L.b_off + col];
              const float bias1 = bias[L.b_off + col + 1];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int row = wm * 32 + i * 16 + g;
                float (&c)[4] = acc[i][nt];
                if (!last) {
                  float2* y = reinterpret_cast<float2*>(dst + row * dst_pitch + col);
                  y[0] = make_float2(fmaxf(__fadd_rn(c[0], bias0), 0.0f),
                                     fmaxf(__fadd_rn(c[1], bias1), 0.0f));
                  y[4 * dst_pitch] = make_float2(fmaxf(__fadd_rn(c[2], bias0), 0.0f),
                                                 fmaxf(__fadd_rn(c[3], bias1), 0.0f));
                } else {
                  // x -> relu(x + bias) is monotonic, so the max goes first
                  float m0 = fmaxf(c[0], c[2]);
                  float m1 = fmaxf(c[1], c[3]);
#pragma unroll
                  for (int off = 4; off < 32; off <<= 1) {
                    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
                    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
                  }
                  if (g == 0) {
                    const int cidx = min((q0 + wm * 32 + i * 16) / sc.kp, TC - 1);
                    int* p = pool + cidx * prm.c_total + sc.c_off + col;
                    atomicMax(p, __float_as_int(fmaxf(__fadd_rn(m0, bias0), 0.0f)));
                    atomicMax(p + 1, __float_as_int(fmaxf(__fadd_rn(m1, bias1), 0.0f)));
                  }
                }
              }
            }
          }
          PLPE_PHASE(kEpilogue);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < TC * prm.c_total; i += kThreads) {
    const int c = i / prm.c_total;
    if (s0 + c < S)
      out[(static_cast<size_t>(b) * S + s0) * prm.c_total + i] = __int_as_float(pool[i]);
  }
  PLPE_PHASE(kStore);
}

// One warp: C[16][8] = A[16][8] @ B[8][8] by the compensated product, all
// row-major, to hold the fragment layouts against a scalar loop.
__global__ void mma_selftest_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                    float* __restrict__ C) {
  const int g = threadIdx.x >> 2;
  const int t = threadIdx.x & 3;
  unsigned a_hi[4], a_lo[4], b_hi[2], b_lo[2];
  split_tf32(A[g * 8 + t], a_hi[0], a_lo[0]);
  split_tf32(A[(g + 8) * 8 + t], a_hi[1], a_lo[1]);
  split_tf32(A[g * 8 + t + 4], a_hi[2], a_lo[2]);
  split_tf32(A[(g + 8) * 8 + t + 4], a_hi[3], a_lo[3]);
  split_tf32(B[t * 8 + g], b_hi[0], b_lo[0]);
  split_tf32(B[(t + 4) * 8 + g], b_hi[1], b_lo[1]);
  float c[4] = {};
  mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}

template <int WARPS_M>
cudaError_t launch(const float* ptsfeat, const float* centroids, float* out, int* idx_out, int B,
                   int N, int S, int P, int TC, int pitch0, int pitch1, size_t shared,
                   const Params& prm, cudaStream_t stream) {
  const int tiles = (S + TC - 1) / TC;
  const long long blocks = static_cast<long long>(B) * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_sa_kernel<WARPS_M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  fused_sa_kernel<WARPS_M><<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(
      ptsfeat, centroids, out, idx_out, N, S, P, TC, tiles, pitch0, pitch1, prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Host arrays: r2, ks and layer_counts hold one entry per scale; widths
// one per layer (scale-major), and weights two device pointers per layer,
// W [cin, cout] then b [cout], 16-byte aligned, every cout a multiple of 8.
// Layer 1's cin is P, with W rows ordered [coords, features]. idx_out may
// be null. `rows` (64 or 128 neighbour rows per chunk), `centroids_per_block`
// and `shared_bytes` are the launch plan of kernels/fused_sa.py
// (launch_plan); the shared memory is computed here again by the same
// formula and the launch is refused if the two differ. Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
int plpe_fused_sa(const float* ptsfeat, const float* centroids, float* out, int* idx_out,
                  int B, int N, int S, int P, int num_scales, const float* r2, const int* ks,
                  const int* layer_counts, const int* widths, const void* const* weights,
                  int rows, int centroids_per_block, int shared_bytes, void* stream) {
  const int TC = centroids_per_block;
  if (B <= 0 || N <= 0 || S <= 0 || P < 3 || num_scales <= 0 || num_scales > kMaxScales ||
      (rows != 64 && rows != 128) || TC <= 0 || TC * 3 > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  prm.count = num_scales;
  int width0 = P == 3 ? 4 : P, width1 = 0, w_i = 0, k_off = 0, c_off = 0, b_off = 0;
  for (int l = 0; l < num_scales; ++l) {
    const int n = layer_counts[l];
    if (ks[l] <= 0 || n <= 0 || n > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
    Scale& sc = prm.scale[l];
    sc.r2 = r2[l];
    sc.k = ks[l];
    sc.kp = round_up(ks[l], 16);
    sc.k_off = k_off;
    sc.c_off = c_off;
    sc.n_layers = n;
    sc.first_mma = P == 3 ? 1 : 0;
    sc.n_chunks = (TC * sc.kp + rows - 1) / rows;
    int cin = P;
    for (int li = 0; li < n; ++li, ++w_i) {
      const int cout = widths[w_i];
      const float* w = static_cast<const float*>(weights[2 * w_i]);
      if (cout <= 0 || cout % 8 != 0 || reinterpret_cast<size_t>(w) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      sc.layer[li] = {w, static_cast<const float*>(weights[2 * w_i + 1]), cin, round_up(cin, 8),
                      cout, b_off};
      b_off += cout;
      if (li < n - 1) {
        if (li & 1) width0 = width0 > cout ? width0 : cout;
        else width1 = width1 > cout ? width1 : cout;
      }
      cin = cout;
    }
    k_off += ks[l];
    c_off += cin;
  }
  prm.k_total = k_off;
  prm.c_total = c_off;
  prm.b_total = b_off;
  const int pitch0 = act_pitch(width0);
  const int pitch1 = width1 > 0 ? act_pitch(width1) : 0;
  const size_t shared =
      sizeof(float) * (static_cast<size_t>(rows) * (pitch0 + pitch1) + kStages * kStageFloats +
                       static_cast<size_t>(TC) * (c_off + 4 + k_off) + b_off);
  if (shared != static_cast<size_t>(shared_bytes) || shared > static_cast<size_t>(kMaxDynamicShared))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows == 128 ? launch<4>(ptsfeat, centroids, out, idx_out, B, N, S, P, TC, pitch0, pitch1,
                              shared, prm, st)
                  : launch<2>(ptsfeat, centroids, out, idx_out, B, N, S, P, TC, pitch0, pitch1,
                              shared, prm, st);
  return static_cast<int>(err);
}

// C[16][8] = A[16][8] @ B[8][8] (row-major device arrays) through the
// kernel's compensated TF32 product, one warp.
int plpe_fused_sa_mma_selftest(const float* A, const float* B, float* C, void* stream) {
  mma_selftest_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, C);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PLPE_PROFILE
// Copies the cycles per phase (8 counters) to `host`, or zeroes them.
int plpe_fused_sa_phase_cycles(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[kPhases] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif

const char* plpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
