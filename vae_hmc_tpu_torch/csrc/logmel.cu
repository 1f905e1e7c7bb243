// Fused mel -> dB -> (floor) -> per-sample standardize, fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `mel_db_standardize` (body `_kernel`) in
// vae_hmc_tpu/ops/pallas/logmel_kernel.py.  Per sample b:
//   mel = fb (M, F) @ spec[b] (F, T)
//   dB  = 10 log10(max(mel, 1e-10)) - 10 log10(max(max(mel), 1e-10))  [ref_max]
//   dB  = max(dB, max(dB) - top_db)                                    [top_db]
//   out = (dB - mean) / (pop_std + eps)                                [standardize]
//
// Bound on an H100 SXM: bytes.  The kernel must read the spectrogram once
// (B x 1025 x 646 x 4 B = 2.65 MB a sample) and write the features once
// (0.33 MB a sample): 382 MB for a 128-track batch, ~0.11 ms at 3.35 TB/s.
// Dense, the GEMM is 21.7 GFLOP a batch (~0.32 ms at 67 TFLOP/s fp32 without
// tensor cores); only 1.5% of the filterbank is nonzero, so the work these
// inputs need is far below the byte time.
//
// Design.  The Pallas kernel holds a whole (F, T) sample (2.6 MB) in VMEM;
// a Hopper block has at most 227 KB of shared memory, so the work is split:
//   pass 1 (mel_gemm): a tiled fp32 GEMM, 32x64 output tiles per block,
//     looping only over the frequency bins where some row of its tile has
//     a nonzero weight (the caller passes each filterbank row's band,
//     computed once on the host; the Slaney bands are narrow: the four
//     tiles of the 128-mel bank span 26% of the dense K work), streamed
//     through shared memory in
//     chunks of 16 bins, 2x4 outputs per thread, IEEE fmaf (no TF32:
//     tensor-core TF32 would break parity with the reference's
//     Precision.HIGHEST).  It writes mel into `out`.
//   pass 2 (db_standardize): one block per sample over its (M, T) block
//     (0.33 MB, mostly L2-resident after pass 1): max, dB and floor written
//     in place, then the mean and a two-pass centred variance (as jnp.std),
//     accumulated in fp64, and the normalisation in place.
// Bins where two tiles' bands overlap are read by both (the blocks of one
// sample run close together, so mostly from L2), and mel makes one extra
// round trip through L2/HBM.  What this leaves on the table (the zeros
// inside each tile's band, no tensor cores, the mel round trip) is work for
// a later change, such as a single pass holding the sample in a cluster's
// distributed shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 32;     // mel rows per block (one filterbank band tile)
constexpr int BN = 64;     // frames per block
constexpr int BK = 16;     // frequency bins per shared-memory chunk
constexpr int TM = 2;      // rows per thread
constexpr int TN = 4;      // columns per thread
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int NORM_THREADS = 1024;

// 10 / ln(10): dB = C * ln(x), as the Pallas kernel writes it
constexpr float DB_SCALE = 4.342944819032518f;
constexpr float AMIN = 1e-10f;

// mel[b] (M, T) = fb (M, F) @ spec[b] (F, T), summing only over the tile's
// band, the union of its rows' bands [bands[2m], bands[2m+1]) of nonzero
// bins: the skipped bins have weight 0 in every row of the tile, so the sum
// equals the dense one (for finite spec; a non-finite frame still reaches
// the bins that are summed, so the sample's features stay non-finite).
__global__ void __launch_bounds__(GEMM_THREADS)
mel_gemm(const float* __restrict__ fb, const float* __restrict__ spec,
         const int* __restrict__ bands, float* __restrict__ mel, int M, int F,
         int T) {
  // +4 keeps 16-byte rows for vector reads and spreads the transposed stores
  __shared__ __align__(16) float As[BK][BM + 4];   // fb tile, [k][m]
  __shared__ __align__(16) float Bs[BK][BN];       // spec tile, [k][n]

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float* __restrict__ S = spec + (size_t)b * F * T;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  int k_lo = F, k_hi = 0;       // every thread reads the same few words
  for (int m = m0; m < min(m0 + BM, M); ++m) {
    k_lo = min(k_lo, bands[2 * m]);
    k_hi = max(k_hi, bands[2 * m + 1]);
  }
  k_lo = (k_lo / BK) * BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    // fb rows are contiguous along F: neighbouring threads read neighbouring k
#pragma unroll
    for (int r = 0; r < (BM * BK) / GEMM_THREADS; ++r) {
      const int e = tid + r * GEMM_THREADS;
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < F) ? fb[(size_t)gm * F + gk] : 0.f;
    }
    // spec rows are contiguous along T: neighbouring threads read neighbouring n
#pragma unroll
    for (int r = 0; r < (BK * BN) / GEMM_THREADS; ++r) {
      const int e = tid + r * GEMM_THREADS;
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < F && gn < T) ? S[(size_t)gk * T + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(&As[k][ty * TM]);
      const float4 c = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y};
      const float cv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* __restrict__ C = mel + (size_t)b * M * T;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < T) C[(size_t)gm * T + gn] = acc[i][j];
    }
  }
}

// max that propagates NaN, as jnp.maximum / torch.maximum do (fmaxf drops
// it, which would hide a non-finite sample from the caller's finite check)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; every thread gets the result.  `scratch` holds one
// slot per warp plus the broadcast slot.
__device__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < (int)(blockDim.x / 32) ? scratch[lane] : -INFINITY;
    w = warp_max(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const float out = scratch[32];
  __syncthreads();
  return out;
}

__device__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < (int)(blockDim.x / 32) ? scratch[lane] : 0.0;
    w = warp_sum(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const double out = scratch[32];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(NORM_THREADS)
db_standardize(float* __restrict__ x, int n, int ref_max, int use_top_db,
               float top_db, int standardize, float eps) {
  __shared__ float fscratch[33];
  __shared__ double dscratch[33];
  float* __restrict__ p = x + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, step = blockDim.x;

  float ref_db = 0.f;
  if (ref_max) {
    float mx = -INFINITY;
    for (int i = tid; i < n; i += step) mx = max_nan(mx, p[i]);
    mx = block_max(mx, fscratch);
    ref_db = DB_SCALE * logf(max_nan(mx, AMIN));
  }
  float floor_db = -INFINITY;
  if (use_top_db) {
    float mx = -INFINITY;
    for (int i = tid; i < n; i += step)
      mx = max_nan(mx, DB_SCALE * logf(max_nan(p[i], AMIN)) - ref_db);
    floor_db = block_max(mx, fscratch) - top_db;
  }
  // each thread revisits only its own elements, so no barrier between passes
  double s = 0.0;
  for (int i = tid; i < n; i += step) {
    const float v = max_nan(DB_SCALE * logf(max_nan(p[i], AMIN)) - ref_db, floor_db);
    p[i] = v;
    s += v;
  }
  if (!standardize) return;
  const double mean = block_sum(s, dscratch) / n;
  double q = 0.0;
  for (int i = tid; i < n; i += step) {
    const double c = (double)p[i] - mean;
    q += c * c;
  }
  const double sd = sqrt(block_sum(q, dscratch) / n) + (double)eps;
  for (int i = tid; i < n; i += step) p[i] = (float)(((double)p[i] - mean) / sd);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// spec (B, F, T), fb (M, F), out (B, M, T): float32; bands (M, 2): int32,
// each fb row's [lo, hi) of nonzero bins; all contiguous, on the device of
// `stream`.  Returns the cudaError_t of the launches (0 = ok).
extern "C" int mel_db_standardize(const void* spec, const void* fb,
                                  const void* bands, void* out, int B, int M,
                                  int F, int T, int ref_max, int use_top_db,
                                  float top_db, int standardize, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + BN - 1) / BN, (M + BM - 1) / BM, B);
  mel_gemm<<<grid, GEMM_THREADS, 0, s>>>(static_cast<const float*>(fb),
                                          static_cast<const float*>(spec),
                                          static_cast<const int*>(bands),
                                          static_cast<float*>(out), M, F, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  db_standardize<<<B, NORM_THREADS, 0, s>>>(static_cast<float*>(out), M * T,
                                            ref_max, use_top_db, top_db,
                                            standardize, eps);
  return static_cast<int>(cudaGetLastError());
}
