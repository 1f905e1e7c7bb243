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
// (1025 x 646 x 4 B = 2.65 MB a sample) and write the features once
// (0.33 MB a sample): 382 MB for a 128-track batch, ~0.11 ms at 3.35 TB/s.
// The Slaney filterbank has 2,018 nonzeros of 131,200 (each row's band is
// 4-53 bins wide and every bin lies in at most two rows), so the product
// these inputs need is 0.33 GFLOP a batch, far below the byte time.
//
// Design: one launch, the spectrogram read once, mel never in device memory.
//   - One thread-block cluster of 8 blocks (512 threads each) per sample.
//     Block r of the cluster owns all M mel rows over a contiguous range of
//     ceil(T / 8) frames rounded up to a multiple of 4 (84 of 646: a 43 KB
//     slice at M = 128); the slice stays in shared memory from the product
//     to the final write.  Two blocks fit on an SM.
//   - Loads are TMA tensor copies.  Chunk c of a block is the box of 64 bins
//     x its frames of sample b: one cp.async.bulk.tensor by one thread into a
//     2-stage shared-memory ring, completing on an mbarrier, so the next
//     chunk lands while this one is summed, and no other thread spends an
//     instruction on loads (in an earlier version the warps that sum also
//     issued per-thread cp.async copies of 4 or 8 bytes, and stalled on
//     them: the loads and the sums did not overlap).  The tensor map needs
//     16-byte row strides, and a row of
//     T = 646 frames is 2,584 bytes, so ops/stft.power_spectrogram pads its
//     rows to a multiple of 4 frames and returns a view (same values); the
//     wrapper copies any other layout into one.  Frames past T and bins past
//     F arrive as zeros.
//   - Per-row band loops instead of a dense tile product: the filterbank
//     comes in as each row's band [lo, hi) plus its nonzero weights packed
//     row after row (ops/mel.filterbank_weights, ~8 KB in shared memory).
//     At set-up the block builds a table of (row, chunk) pairs (183 at 128
//     mels), and for each chunk every (pair, two frames) item sums w * spec
//     over the row's bins in the chunk, so each bin feeds only the one or
//     two rows whose band holds it and the FLOPs are the 2 x nnz x T these
//     inputs need.  Bins in no band -- for the Slaney bank bin n_fft/2
//     (1024), and bin 0, which is loaded with the first chunk -- are never
//     summed: a NaN there alone would not reach the features (the dense
//     product of the plain version would carry it).  A non-finite
//     waveform makes every bin of its frames NaN, so the sample's features
//     still come out non-finite and the feature driver drops the row.
//   - The three per-sample reductions cross the cluster through distributed
//     shared memory: each block reduces its slice, thread 0 publishes the
//     partial in its shared memory, and after cluster.sync() thread 0 of
//     every block reads the 8 partials and combines them in rank order (so
//     all blocks agree and repeated calls are bit-identical).  They are
//     max(mel), the sum of floored dB, and the centred sum of squares (two
//     passes, accumulated in fp64, as jnp.std).  dB is monotone in mel, so
//     max(dB) = 10 log10(max(max(mel), amin)) - ref_db and the top_db floor
//     needs no sweep of its own.  The normalisation is (dB - mean) * (1/sd)
//     in fp32, and dB = 10 log10(2) log2(x) with the SFU's log2 (2 ulp).
//   - Every max propagates NaN (fmaxf would drop it).  IEEE fmaf throughout;
//     no TF32 (tensor-core TF32 would break parity with the reference's
//     Precision.HIGHEST).
// What holds it above the byte bound (PERF.md has its time): 128 clusters
// run 30 at a time, so the fifth round holds 8 of them; the rounds start
// together, so the blocks of an SM reach their per-sample epilogues, which
// load nothing, at the same time; each block builds its (row, chunk) table
// at start.
// A launch the card cannot place (no co-resident cluster at this shared
// memory size: at 128 mels, T beyond about 1,700 frames) comes back as an
// error code.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;      // blocks per sample
constexpr int THREADS = 512;
constexpr int KC = 64;          // frequency bins per ring stage
constexpr int STAGES = 2;       // ring depth

// 10 log10(2): dB = C log2(x) (the Pallas kernel writes 10/ln(10) ln(x));
// __log2f is the SFU's log2, within 2 ulp, ~1e-5 dB here
constexpr float DB2_SCALE = 3.0102999566398120f;
constexpr float AMIN = 1e-10f;

// frames per block: ceil(T / CLUSTER) rounded up to a multiple of 4, as a
// row of a TMA box must be a multiple of 16 bytes
__host__ __device__ inline int frames_per_block(int T) {
  return ((T + CLUSTER - 1) / CLUSTER + 3) / 4 * 4;
}

// (row, chunk) pairs with a nonzero weight, at most: a band of w bins meets
// at most w / KC + 2 chunks
__host__ __device__ inline int max_entries(int M, int nnz) {
  return nnz / KC + 2 * M + 1;
}

__host__ __device__ inline int max_chunks(int F) { return (F + KC - 1) / KC + 1; }

// dynamic shared memory, in 4-byte words: 128-byte alignment slack, ring,
// (row, chunk) table, mel slice, packed weights, lo / hi / offset per row,
// chunk starts and cursors
__host__ __device__ inline size_t smem_words(int M, int F, int T, int nnz) {
  const size_t tbp = frames_per_block(T);
  return 32 + (size_t)STAGES * KC * tbp + 4 * (size_t)max_entries(M, nnz) +
         (size_t)M * tbp + nnz + 3 * (size_t)M + 2 * (size_t)(max_chunks(F) + 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// the one arrival of a ring stage's phase, announcing `bytes` of copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// TMA tile copy of the box at (x, y, z) of a 3-D tensor map into shared
// memory (128-byte aligned); out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            unsigned long long* bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.tile"
               ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
               ::"r"(smem_addr(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
                 "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
               : "memory");
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

// Block-wide reductions; the result is valid in thread 0.  `scratch` holds
// one slot per warp.
__device__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_max(lane < THREADS / 32 ? scratch[lane] : -INFINITY);
  return v;
}

__device__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < THREADS / 32 ? scratch[lane] : 0.0);
  return v;
}

// Thread 0 of every block publishes `part`, then combines all blocks'
// partials in rank order, so every block of the cluster gets the same value.
template <class T, class Op>
__device__ T cluster_reduce(cg::cluster_group& cluster, T part, T* slot,
                            T* bcast, Op op) {
  if (threadIdx.x == 0) *slot = part;
  cluster.sync();
  if (threadIdx.x == 0) {
    T v[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v[r] = *cluster.map_shared_rank(slot, r);
    T acc = v[0];
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r) acc = op(acc, v[r]);
    *bcast = acc;
  }
  __syncthreads();
  return *bcast;
}

struct MaxNan {
  __device__ float operator()(float a, float b) const { return max_nan(a, b); }
};
struct Add {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// grid (CLUSTER, B), cluster (CLUSTER, 1, 1): blockIdx.y is the sample,
// the cluster rank the frame range.
__global__ void __launch_bounds__(THREADS, 2)
mel_db_cluster(const __grid_constant__ CUtensorMap spec,
               const int* __restrict__ bands, const float* __restrict__ weights,
               float* __restrict__ out, int M, int F, int T, int nnz,
               int ref_max, int use_top_db, float top_db, int standardize,
               float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float fscratch[32];
  __shared__ double dscratch[32];
  __shared__ int bin_end;
  __shared__ unsigned long long full[STAGES];   // ring stage has landed
  // this block's partials, read by the whole cluster, and their combination
  __shared__ float part_max, all_max;
  __shared__ double part_sum, all_sum, part_sq, all_sq;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tbp = frames_per_block(T);      // row pitch of ring and slice
  const int t0 = rank * tbp;
  const int ncols = max(0, min(tbp, T - t0));
  const int npairs = (ncols + 1) / 2;       // items are frame pairs
  const int nch_max = max_chunks(F);

  float* ring = reinterpret_cast<float*>(                      // [STAGES][KC][tbp]
      (reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t(127));
  int4* ent = reinterpret_cast<int4*>(ring + (size_t)STAGES * KC * tbp);
  float* mel = reinterpret_cast<float*>(ent + max_entries(M, nnz));  // [M][tbp]
  float* wts = mel + (size_t)M * tbp;                          // [nnz]
  int* lo = reinterpret_cast<int*>(wts + nnz);                 // [M]
  int* hi = lo + M;
  int* off = hi + M;                                           // packed offset of row m
  int* start = off + M;                                        // [nch_max + 1]
  int* cur = start + nch_max + 1;                              // [nch_max + 1]

  // --- the spectrogram loads: chunk c is the box of bins [c KC, c KC + KC)
  // x the block's frames [t0, t0 + tbp) of sample b, one TMA copy (zeros
  // past T and past F).  The first chunks land during the set-up.
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_chunk = [&](int c) {             // thread 0 only
    unsigned long long* bar = &full[c % STAGES];
    mbar_expect(bar, KC * tbp * sizeof(float));
    tma_load_3d(ring + (size_t)(c % STAGES) * KC * tbp, &spec, t0, c * KC, b, bar);
  };
  const int n_pro = min(STAGES - 1, (F + KC - 1) / KC);   // chunks loaded ahead
  if (tid == 0)
    for (int c = 0; c < n_pro; ++c) load_chunk(c);

  // --- set-up: band table, packed weights, zeroed slice
  for (int m = tid; m < M; m += THREADS) {
    lo[m] = bands[2 * m];
    hi[m] = bands[2 * m + 1];
  }
  for (int i = tid; i < nnz; i += THREADS) wts[i] = weights[i];
  for (int i = tid; i < M * tbp; i += THREADS) mel[i] = 0.f;
  for (int c = tid; c <= nch_max; c += THREADS) cur[c] = 0;
  __syncthreads();
  if (warp == 0) {                    // prefix sum of band widths; last bin
    int base = 0, ke = 0;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      const int len = m < M ? max(hi[m] - lo[m], 0) : 0;
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (m < M) off[m] = base + incl - len;
      base += __shfl_sync(0xffffffffu, incl, 31);
      if (len > 0) ke = max(ke, hi[m]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ke = max(ke, __shfl_xor_sync(0xffffffffu, ke, o));
    if (lane == 0) bin_end = ke;
  }
  __syncthreads();
  const int ke = bin_end;                     // bins past the last band: unread
  const int nchunks = (ke + KC - 1) / KC;

  // --- table of (row, chunk) pairs, grouped by chunk: the rows whose band
  // meets the chunk, with the bins they sum there.  Built once, in parallel;
  // the order of the rows inside a chunk does not change any sum.
  for (int m = tid; m < M; m += THREADS)
    for (int c = lo[m] / KC; hi[m] > lo[m] && c <= (hi[m] - 1) / KC; ++c)
      atomicAdd(&cur[c], 1);
  __syncthreads();
  if (warp == 0) {                    // start = exclusive prefix of counts
    int base = 0;
    for (int c0 = 0; c0 <= nchunks; c0 += 32) {
      const int c = c0 + lane;
      const int n = c < nchunks ? cur[c] : 0;
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (c <= nchunks) start[c] = base + incl - n;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  for (int c = tid; c < nchunks; c += THREADS) cur[c] = start[c];
  __syncthreads();
  for (int m = tid; m < M; m += THREADS)
    for (int c = lo[m] / KC; hi[m] > lo[m] && c <= (hi[m] - 1) / KC; ++c) {
      const int c0 = c * KC;
      const int f0 = max(lo[m], c0), f1 = min(hi[m], c0 + KC);
      ent[atomicAdd(&cur[c], 1)] =
          make_int4(f0 - c0, f1 - f0, off[m] + f0 - lo[m], m * tbp);
    }
  // (the barrier at the top of the first chunk publishes the table)

  // --- the product, two frames an item (an odd last frame pairs with the
  // slice's padding column, which nothing reads)
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(&full[c % STAGES], (c / STAGES) & 1);   // chunk c has landed
    __syncthreads();                  // everyone is past chunk c-1: its slot is free
    if (tid == 0 && c + STAGES - 1 < nchunks) load_chunk(c + STAGES - 1);

    const float* chunk = ring + (size_t)(c % STAGES) * KC * tbp;
    const int e0 = start[c];
    const int items = (start[c + 1] - e0) * npairs;
    for (int i = tid; i < items; i += THREADS) {
      const int r = i / npairs, t = 2 * (i - r * npairs);
      const int4 e = ent[e0 + r];     // bin offset, bins, weight offset, row
      const float* w = wts + e.z;
      const float* sp = chunk + e.x * tbp + t;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int f = 0; f < e.y; ++f) {
        const float2 v = *reinterpret_cast<const float2*>(sp + f * tbp);
        a0 = fmaf(w[f], v.x, a0);
        a1 = fmaf(w[f], v.y, a1);
      }
      float2* dst = reinterpret_cast<float2*>(mel + e.w + t);
      const float2 old = *dst;
      *dst = make_float2(old.x + a0, old.y + a1);
    }
  }
  for (int c = nchunks; c < n_pro; ++c)     // loaded ahead, past the bands
    mbar_wait(&full[c % STAGES], (c / STAGES) & 1);
  __syncthreads();

  // The passes below walk the slice [M][tbp] flat, thread by thread, and
  // skip the padding columns t >= ncols; (m, t) advance without a division.
  const int dm = THREADS / tbp, dt = THREADS % tbp;
  auto each = [&](auto&& f) {
    int m = tid / tbp, t = tid % tbp;
    for (int i = tid; i < M * tbp; i += THREADS) {
      if (t < ncols) f(m, t, mel[i]);
      m += dm;
      t += dt;
      if (t >= tbp) {
        t -= tbp;
        ++m;
      }
    }
  };
  // --- max(mel) over the sample
  float mx = -INFINITY;
  each([&](int, int, float& v) { mx = max_nan(mx, v); });
  const float gmax = cluster_reduce(cluster, block_max(mx, fscratch),
                                    &part_max, &all_max, MaxNan());

  // --- dB against the reference, floor at max(dB) - top_db
  const float top = DB2_SCALE * __log2f(max_nan(gmax, AMIN));
  const float ref_db = ref_max ? top : 0.f;
  const float floor_db = use_top_db ? (top - ref_db) - top_db : -INFINITY;
  double s = 0.0;
  each([&](int, int, float& v) {
    v = max_nan(DB2_SCALE * __log2f(max_nan(v, AMIN)) - ref_db, floor_db);
    s += v;
  });
  float shift = 0.f, scale = 1.f;
  if (standardize) {
    // --- mean, then the centred sum of squares (two passes, fp64)
    const double n = (double)M * T;
    const double mean =
        cluster_reduce(cluster, block_sum(s, dscratch), &part_sum, &all_sum, Add()) / n;
    double q = 0.0;
    each([&](int, int, float& v) {
      const double cdev = (double)v - mean;
      q += cdev * cdev;
    });
    const double sd =
        sqrt(cluster_reduce(cluster, block_sum(q, dscratch), &part_sq, &all_sq, Add()) / n) +
        (double)eps;
    shift = (float)mean;
    scale = (float)(1.0 / sd);
  }
  // --- the features, written once
  float* __restrict__ O = out + (size_t)b * M * T + t0;
  each([&](int m, int t, float& v) { O[(size_t)m * T + t] = (v - shift) * scale; });
  // no block may leave while another can still read its partials
  cluster.sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int g_smem_attr = 0;          // dynamic shared memory granted so far
size_t g_occ_bytes = 0;       // shared memory size of the cached occupancy
int g_occ_clusters = 0;

cudaError_t prepare(size_t bytes) {
  if ((int)bytes > g_smem_attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mel_db_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    g_smem_attr = (int)bytes;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(int B, size_t bytes, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of this launch the card can hold at once (0: it cannot place one)
cudaError_t active_clusters(size_t bytes, int* clusters) {
  if (bytes == g_occ_bytes && g_occ_clusters > 0) {
    *clusters = g_occ_clusters;
    return cudaSuccess;
  }
  cudaError_t err = prepare(bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, bytes, 0, attr);
  err = cudaOccupancyMaxActiveClusters(clusters, mel_db_cluster, &cfg);
  if (err != cudaSuccess) return err;
  g_occ_bytes = bytes;
  g_occ_clusters = *clusters;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of 8 blocks that the card holds at once for (M, F, T, nnz), written
// to *clusters; returns the cudaError_t (0 = ok).
extern "C" int mel_db_cluster_occupancy(int M, int F, int T, int nnz,
                                        int* clusters) {
  return static_cast<int>(
      active_clusters(smem_words(M, F, T, nnz) * sizeof(float), clusters));
}

// spec (B, F, T) with rows `pitch` floats apart and samples `sstride` floats
// apart, both multiples of 4, and a 16-byte aligned base (pitch >= T rounded
// up to 4; ops/stft.row_aligned); out (B, M, T) contiguous: float32;
// bands (M, 2): int32, each filterbank
// row's [lo, hi) of nonzero bins; weights (nnz,): float32, the rows' nonzero
// weights packed in row order (nnz = sum of hi - lo); all on the device of
// `stream`.  One launch.  Returns the cudaError_t (0 = ok).
extern "C" int mel_db_standardize(const void* spec, const void* bands,
                                  const void* weights, void* out, int B, int M,
                                  int F, int T, int pitch, long long sstride,
                                  int nnz, int ref_max, int use_top_db,
                                  float top_db, int standardize, float eps,
                                  void* stream) {
  const size_t bytes = smem_words(M, F, T, nnz) * sizeof(float);
  int clusters = 0;
  cudaError_t err = active_clusters(bytes, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // spec as a 3-D tensor (T, F, B) with byte strides (pitch, sample) and a
  // box of (frames per block, KC bins, 1 sample)
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)T, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * sizeof(float),
                                 (cuuint64_t)sstride * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)frames_per_block(T), (cuuint32_t)KC, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(spec),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(B, bytes, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, mel_db_cluster, map,
                           static_cast<const int*>(bands),
                           static_cast<const float*>(weights),
                           static_cast<float*>(out), M, F, T, nnz, ref_max,
                           use_top_db, top_db, standardize, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
