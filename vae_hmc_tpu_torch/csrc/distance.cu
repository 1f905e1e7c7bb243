// Tiled pairwise euclidean distances, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `pairwise_dists_pallas` (body `_kernel`) in
// vae_hmc_tpu/ops/pallas/distance_kernel.py:
//   D[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))
// for x (N, d), y (M, d) -> D (N, M).  The caller centres the inputs (as
// metrics.internal does) to bound the f32 cancellation of the cross term.
//
// Bound on an H100 SXM.  On the main path (latent mu, d = 32) the kernel is
// bound by bytes: it must write N*M*4 bytes (4.2 MB at N = 1,024, ~1.3 us at
// 3.35 TB/s) and reads next to nothing.  On the mel-flat representation
// (d = 82,688) it is bound by operations: for y = x the symmetric output
// needs N(N+1)/2 dot products, N(N+1)d = 5.4 GFLOP at N = 256, ~0.08 ms at
// 67 TFLOP/s fp32 without tensor cores.
//
// Design.
//   - One 128-thread block per 64x64 output tile and d-slice.  Its two
//     groups of 64 threads each hold the whole tile, one 8x8 sub-tile a
//     thread (rows ty + 8i, columns tx + 8j, so the reads of a quarter-warp
//     fall on distinct banks), and sum the two halves of every 32-column
//     chunk; at the end group 0 adds group 1's sums (a fixed order).  8x8
//     keeps the shared-memory reads at a quarter float per FMA, which the
//     SM's 128 B/clock can feed at the FMA rate; a 4x4 sub-tile needs twice
//     that, more than shared memory delivers.  The
//     two groups halve each warp's chain of FMAs, which the small main-path
//     shape (d = 32, one chunk) waits on.  IEEE fmaf; no TF32 or bf16: bf16
//     inputs give ~5e-3 relative distance error at d = 82k and break
//     sklearn-parity metrics.
//   - The d loop streams 32-wide chunks of the two tiles' rows through a
//     3-stage cp.async ring (16-byte copies when d is a multiple of 4, else
//     4-byte ones, e.g. d = 17; out-of-range rows and columns are zero-filled
//     by the copy), so the next chunks load while this one is summed.
//   - The squared row norms are fused: each thread sums the squares of one
//     row of x and one of y over its half of the chunks the block already
//     holds, in the same order for both, so one call is one launch (two when
//     split).
//   - For y = x only the tiles with i <= j run, and each writes D[i, j] and,
//     through a transpose in shared memory, D[j, i]: the output is exactly
//     symmetric and its diagonal exactly 0 (sklearn's convention, ROADMAP
//     parity rule 5).
//   - Split-K: when the tiles cannot fill the card (10 tiles at N = 256),
//     the wrapper cuts d into S slices (ops/kernels/distance.split_k_bounds:
//     as many as fit one round of resident blocks, 26 there); each block
//     writes its partial products and partial norms to a workspace the
//     wrapper allocates, and a second launch, one thread per output element,
//     sums them in slice order and applies the epilogue.  No atomics:
//     repeated calls give bit-identical results.
//   - The clamp (which keeps NaN, as jnp.maximum does) and the sqrt are the
//     epilogue, so D is written once.
// What holds it above its bound (PERF.md has its times): at the mel-flat
// shape, the FMA loop with two blocks (8 warps) on an SM, as many as the
// 226 registers a thread allow; at the main-path shape, the latency of one
// load, one chunk of FMAs and the stores of each block.
// Left for later: 3xTF32 on the tensor cores for the compute-bound mel-flat
// shape, and an (x, y) squared-distance entry.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;            // rows of x and of y per tile
constexpr int BK = 32;            // columns of d per ring stage
constexpr int STAGES = 3;
constexpr int TT = 8;             // outputs per thread along each axis
constexpr int TD = BT / TT;       // threads along each axis of the tile
constexpr int GROUP = TD * TD;    // 64 threads hold the whole tile ...
constexpr int THREADS = 2 * GROUP;  // ... twice: each group sums half of a chunk
constexpr int HALF = BK / 2;
constexpr int RP = BK + 4;        // row pitch in shared memory (floats)
constexpr int STAGE_WORDS = 2 * BT * RP;          // x rows then y rows
constexpr int TILE_WORDS = BT * BT + 2 * BT;      // partial products, norms
constexpr size_t MAIN_SMEM = (size_t)STAGES * STAGE_WORDS * sizeof(float);
constexpr int CT = BT + 1;        // pitch of the transpose buffer
static_assert(BT * CT <= STAGES * STAGE_WORDS, "transpose fits in the ring");
static_assert(BT == GROUP, "one x row and one y row per thread of a group");
static_assert(BT * BT <= STAGES * STAGE_WORDS, "group 1's sums fit in the ring");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tile index -> (row tile, column tile); for y = x only tiles bi <= bj
__device__ __forceinline__ void tile_coords(int tile, int nbj, int self_dist,
                                            int* bi, int* bj) {
  if (!self_dist) {
    *bi = tile / nbj;
    *bj = tile - *bi * nbj;
    return;
  }
  int i = 0, rem = tile;
  while (rem >= nbj - i) {
    rem -= nbj - i;
    ++i;
  }
  *bi = i;
  *bj = i + rem;
}

// d from a squared-norm pair and a dot product: clamp at 0 but keep NaN,
// as jnp.maximum does
__device__ __forceinline__ float dist_of(float xn, float yn, float dot) {
  const float d2 = xn + yn - 2.f * dot;
  return sqrtf((d2 > 0.f || d2 != d2) ? d2 : 0.f);
}

typedef float Acc[TT][TT];

// D from the 8x8 sums of the threads of group 0 and the tile's squared norms
// (xn, yn in shared memory); for an off-diagonal tile of y = x also D^T
// through `ct`, written by the whole block.
__device__ void epilogue(const Acc& acc, const float* xn, const float* yn,
                         float* ct, float* __restrict__ out, int N, int M,
                         int i0, int j0, int self_dist, bool mirror) {
  const int tx = threadIdx.x % TD, ty = threadIdx.x / TD;
#pragma unroll
  for (int i = 0; i < TT && threadIdx.x < GROUP; ++i) {
    const int r = ty + TD * i, gi = i0 + r;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int c = tx + TD * j, gj = j0 + c;
      // a point's distance to itself is exactly 0, not the f32 residue of
      // |x|^2 + |x|^2 - 2 x.x
      float v = dist_of(xn[r], yn[c], acc[i][j]);
      if (self_dist && gi == gj) v = 0.f;
      if (gi < N && gj < M) out[(size_t)gi * M + gj] = v;
      if (mirror) ct[c * CT + r] = v;
    }
  }
  if (!mirror) return;
  __syncthreads();
  for (int e = threadIdx.x; e < BT * BT; e += THREADS) {
    const int c = e / BT, r = e - c * BT;
    const int gj = j0 + c, gi = i0 + r;
    if (gj < N && gi < N) out[(size_t)gj * N + gi] = ct[c * CT + r];
  }
}

// grid (tiles, slices).  Slice s covers columns [s * kslice, min(d, ...)).
// slices == 1: the block writes D; else its partial sums go to ws.
__global__ void __launch_bounds__(THREADS)
pairwise_tile(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ out, float* __restrict__ ws, int N, int M,
              int d, int self_dist, int kslice) {
  extern __shared__ __align__(16) float ring[];   // [STAGES][2][BT][RP]
  __shared__ float norms[2 * BT];                 // |x_r|^2, then |y_c|^2

  const int tid = threadIdx.x;
  const int g = tid / GROUP, u = tid % GROUP;     // group, thread in group
  const int tx = u % TD, ty = u / TD;
  int bi, bj;
  tile_coords(blockIdx.x, (M + BT - 1) / BT, self_dist, &bi, &bj);
  const int i0 = bi * BT, j0 = bj * BT;
  const int kbeg = blockIdx.y * kslice;
  const int kend = min(d, kbeg + kslice);
  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0)
                    && (reinterpret_cast<uintptr_t>(y) % 16 == 0);

  auto load_chunk = [&](int c) {
    if (c >= nk) return;
    const int k0 = kbeg + c * BK;
    float* st = ring + (size_t)(c % STAGES) * STAGE_WORDS;
    if (vec4) {                  // kend is a multiple of 4 here
#pragma unroll
      for (int r = 0; r < (2 * BT * BK / 4) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int row2 = e / (BK / 4), kv = e % (BK / 4);   // row2 < 2 BT
        const int side = row2 / BT, row = row2 % BT;
        const int grow = (side ? j0 : i0) + row, gk = k0 + 4 * kv;
        const float* base = side ? y : x;
        const bool ok = grow < (side ? M : N) && gk < kend;
        cp_async16(st + row2 * RP + 4 * kv,
                   ok ? base + (size_t)grow * d + gk : base, ok ? 16 : 0);
      }
    } else {
#pragma unroll 8
      for (int r = 0; r < (2 * BT * BK) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int row2 = e / BK, k = e % BK;
        const int side = row2 / BT, row = row2 % BT;
        const int grow = (side ? j0 : i0) + row, gk = k0 + k;
        const float* base = side ? y : x;
        const bool ok = grow < (side ? M : N) && gk < kend;
        cp_async4(st + row2 * RP + k,
                  ok ? base + (size_t)grow * d + gk : base, ok ? 4 : 0);
      }
    }
  };

  Acc acc;
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;
  float nx = 0.f, ny = 0.f;      // squared norms of x row u and y row u

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_chunk(s);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // chunk c landed everywhere; slot c-1 free
    load_chunk(c + STAGES - 1);
    cp_async_commit();

    // group g takes columns [g HALF, g HALF + HALF) of the chunk
    const float* xs = ring + (size_t)(c % STAGES) * STAGE_WORDS + g * HALF;
    const float* ys = xs + BT * RP;
#pragma unroll
    for (int k = 0; k < HALF; k += 4) {   // same order for x rows and y rows
      const float4 p = *reinterpret_cast<const float4*>(xs + u * RP + k);
      const float4 q = *reinterpret_cast<const float4*>(ys + u * RP + k);
      nx = fmaf(p.x, p.x, nx);
      nx = fmaf(p.y, p.y, nx);
      nx = fmaf(p.z, p.z, nx);
      nx = fmaf(p.w, p.w, nx);
      ny = fmaf(q.x, q.x, ny);
      ny = fmaf(q.y, q.y, ny);
      ny = fmaf(q.z, q.z, ny);
      ny = fmaf(q.w, q.w, ny);
    }
#pragma unroll 4
    for (int k = 0; k < HALF; k += 2) {
      float2 a[TT], b[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i)
        a[i] = *reinterpret_cast<const float2*>(xs + (ty + TD * i) * RP + k);
#pragma unroll
      for (int j = 0; j < TT; ++j)
        b[j] = *reinterpret_cast<const float2*>(ys + (tx + TD * j) * RP + k);
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();               // the ring is free

  // group 0 adds group 1's sums (group 0's + group 1's, a fixed order)
  if (g == 1) {
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < TT; ++j) ring[(i * TT + j) * GROUP + u] = acc[i][j];
    norms[u] = nx;
    norms[BT + u] = ny;
  }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < TT; ++j) acc[i][j] += ring[(i * TT + j) * GROUP + u];
    nx += norms[u];
    ny += norms[BT + u];
  }
  __syncthreads();               // ring and norms are read
  if (gridDim.y == 1) {
    if (g == 0) {
      norms[u] = nx;
      norms[BT + u] = ny;
    }
    __syncthreads();
    epilogue(acc, norms, norms + BT, ring, out, N, M, i0, j0, self_dist,
             self_dist && bi != bj);
    return;
  }
  if (g) return;
  float* part = ws + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE_WORDS;
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j)
      part[(ty + TD * i) * BT + tx + TD * j] = acc[i][j];
  part[BT * BT + u] = nx;
  part[BT * BT + BT + u] = ny;
}

constexpr int RED_ROWS = 4;                  // tile rows per reducer block
constexpr int RED_THREADS = RED_ROWS * BT;   // one output element a thread

// grid (tiles, BT / RED_ROWS): sums the slices' partials in slice order, one
// thread per output element, then the epilogue (both halves for y = x).
__global__ void __launch_bounds__(RED_THREADS)
reduce_slices(const float* __restrict__ ws, float* __restrict__ out, int N,
              int M, int self_dist, int slices) {
  __shared__ float xn[RED_ROWS], yn[BT];
  const int tid = threadIdx.x;
  const int tiles = gridDim.x;
  int bi, bj;
  tile_coords(blockIdx.x, (M + BT - 1) / BT, self_dist, &bi, &bj);
  const int r = blockIdx.y * RED_ROWS + tid / BT, c = tid % BT;
  const size_t stride = (size_t)tiles * TILE_WORDS;
  const float* part = ws + (size_t)blockIdx.x * TILE_WORDS;
  if (tid < BT + RED_ROWS) {     // the norms this block needs
    const int w = tid < BT ? BT * BT + BT + tid
                           : BT * BT + blockIdx.y * RED_ROWS + tid - BT;
    float n = 0.f;
    for (int s = 0; s < slices; ++s) n += part[s * stride + w];
    if (tid < BT) yn[tid] = n;
    else xn[tid - BT] = n;
  }
  float dot = 0.f;
  for (int s = 0; s < slices; ++s) dot += part[s * stride + r * BT + c];
  __syncthreads();
  const int gi = bi * BT + r, gj = bj * BT + c;
  float v = dist_of(xn[tid / BT], yn[c], dot);
  if (self_dist && gi == gj) v = 0.f;
  if (gi < N && gj < M) {
    out[(size_t)gi * M + gj] = v;
    if (self_dist && bi != bj) out[(size_t)gj * N + gi] = v;
  }
}

cudaError_t g_smem_err = cudaErrorNotReady;   // not tried yet

cudaError_t prepare() {
  if (g_smem_err == cudaErrorNotReady)
    g_smem_err = cudaFuncSetAttribute(
        pairwise_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)MAIN_SMEM);
  return g_smem_err;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the tile kernel resident on one SM, written to *blocks; returns
// the cudaError_t (0 = ok).  The wrapper's split rule fills one round of them.
extern "C" int pairwise_blocks_per_sm(int* blocks) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pairwise_tile, THREADS, MAIN_SMEM));
}

// x (N, d), y (M, d), out (N, M): float32, contiguous, on the device of
// `stream`; self_dist != 0 says y is x (only tiles i <= j run, the diagonal
// is 0).  slices > 1 splits d into slices of kslice columns (a multiple of
// 32; the last may be shorter, none empty) and needs ws: float32 of
// slices x tiles x (64 x 64 + 128) words, tiles = nb(nb+1)/2 for y = x and
// ceil(N/64) ceil(M/64) otherwise.  One launch, two when slices > 1.
// Returns the cudaError_t (0 = ok).
extern "C" int pairwise_dists(const void* x, const void* y, void* out, void* ws,
                              int N, int M, int d, int self_dist, int slices,
                              int kslice, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nbi = (N + BT - 1) / BT, nbj = (M + BT - 1) / BT;
  const int tiles = self_dist ? nbi * (nbi + 1) / 2 : nbi * nbj;
  if (slices < 1 || (slices > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  pairwise_tile<<<dim3(tiles, slices), THREADS, MAIN_SMEM, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), static_cast<float*>(ws), N, M, d, self_dist,
      slices > 1 ? kslice : d);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  reduce_slices<<<dim3(tiles, BT / RED_ROWS), RED_THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), N, M, self_dist,
      slices);
  return static_cast<int>(cudaGetLastError());
}
