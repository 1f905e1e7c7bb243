// Tiled pairwise euclidean distances, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `pairwise_dists_pallas` (body `_kernel`) in
// vae_hmc_tpu/ops/pallas/distance_kernel.py:
//   D[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0))
// for x (N, d), y (M, d) -> D (N, M).  The caller centres the inputs (as
// metrics.internal does) to bound the f32 cancellation of the cross term.
//
// Bound on an H100 SXM.  On the main path (latent mu, d = 32) the kernel is
// bound by bytes: it must write N*M*4 bytes (34 MB at N = 2,924, ~10 us at
// 3.35 TB/s) and reads next to nothing.  On the mel-flat representation
// (d = 82,688) it is bound by operations: 2*N*M*d = 1.41 TFLOP at N = 2,924,
// ~21 ms at 67 TFLOP/s fp32 without tensor cores.
//
// Design.  Each block owns a 64x64 output tile and loops over d inside the
// block (Hopper blocks run in no order, so nothing carries across the grid as
// the TPU grid's sequential K axis did), streaming 16-wide K chunks of x and
// y through shared memory; each thread accumulates a 4x4 sub-tile with IEEE
// fmaf.  No TF32 or bf16: bf16 inputs give ~5e-3 relative distance error at
// d = 82k and break sklearn-parity metrics.  The squared row norms come from
// a small warp-per-row kernel launched first.  Ragged edges are masked in the
// loads and the stores rather than padded on the host.  The clamp and the
// sqrt are the epilogue, so D is written once; for y = x the diagonal is
// set to exactly 0, as sklearn's euclidean_distances does.  Left for later: 3xTF32 or
// symmetric (i <= j) tiles for the compute-bound mel-flat shape, and split-K
// when N is too small to fill the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;     // rows of x per block
constexpr int BN = 64;     // rows of y per block
constexpr int BK = 16;     // feature chunk through shared memory
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int NORM_THREADS = 256;                // 8 rows per block
static_assert(BM == BN, "one load loop fills both tiles");

__global__ void __launch_bounds__(NORM_THREADS)
row_sqnorm(const float* __restrict__ x, float* __restrict__ out, int n,
           int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const float* __restrict__ r = x + (size_t)row * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s = fmaf(r[k], r[k], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(THREADS)
pairwise_tile(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ xn, const float* __restrict__ yn,
              float* __restrict__ out, int N, int M, int d, int self_dist) {
  // [k][row] layout, +4 for 16-byte aligned float4 reads and fewer conflicts
  __shared__ __align__(16) float Xs[BK][BM + 4];
  __shared__ __align__(16) float Ys[BK][BN + 4];

  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // rows are contiguous along d: neighbouring threads read neighbouring k
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int m = e / BK, k = e % BK;
      const int gk = k0 + k;
      const int gi = i0 + m, gj = j0 + m;
      Xs[k][m] = (gi < N && gk < d) ? x[(size_t)gi * d + gk] : 0.f;
      Ys[k][m] = (gj < M && gk < d) ? y[(size_t)gj * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + ty * TM + i;
    if (gi >= N) continue;
    const float ni = xn[gi];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + tx * TN + j;
      if (gj < M) {
        const float d2 = ni + yn[gj] - 2.f * acc[i][j];
        // clamp at 0 but keep NaN, as jnp.maximum does; a point's distance
        // to itself is exactly 0 (sklearn's convention), not the f32
        // cancellation residue of |x|^2 + |x|^2 - 2 x.x
        const float v = sqrtf((d2 > 0.f || d2 != d2) ? d2 : 0.f);
        out[(size_t)gi * M + gj] = (self_dist && gi == gj) ? 0.f : v;
      }
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (N, d), y (M, d), out (N, M), scratch xn (N,), yn (M,): float32,
// contiguous, on the device of `stream`.  self_dist != 0 says y is x (and
// yn is xn): the norms are taken once and the diagonal is 0.  Returns the
// cudaError_t of the launches (0 = ok).
extern "C" int pairwise_dists(const void* x, const void* y, void* xn,
                              void* yn, void* out, int N, int M, int d,
                              int self_dist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = NORM_THREADS / 32;
  row_sqnorm<<<(N + rows_per_block - 1) / rows_per_block, NORM_THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(xn), N, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!self_dist) {
    row_sqnorm<<<(M + rows_per_block - 1) / rows_per_block, NORM_THREADS, 0, s>>>(
        static_cast<const float*>(y), static_cast<float*>(yn), M, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((M + BN - 1) / BN, (N + BM - 1) / BM);
  pairwise_tile<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(xn), static_cast<const float*>(yn),
      static_cast<float*>(out), N, M, d, self_dist);
  return static_cast<int>(cudaGetLastError());
}
