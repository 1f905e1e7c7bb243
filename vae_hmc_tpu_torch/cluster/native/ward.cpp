// NN-chain Ward linkage over a precomputed squared-distance matrix.
//
// A copy of vae_hmc_tpu/cluster/native/ward.cpp, owned by the PyTorch port.
// The device computes the (N, N) distances (kernel 2); this library runs the
// inherently-sequential merge loop at native speed (the numpy NN-chain in
// cluster/agglomerative.py is its plain version; both must give the same
// sorted linkage).
//
// C ABI:
//   int ward_nn_chain(double* d2 /* N*N, modified in place */, long n,
//                     double* merges /* (n-1)*4 out: lo, hi, dist, size */);

#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

extern "C" int ward_nn_chain(double* d2, long n, double* merges) {
  if (n < 2) return -1;
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> size((size_t)n, 1.0);
  std::vector<char> active((size_t)n, 1);
  std::vector<long> cluster_id((size_t)n);
  for (long i = 0; i < n; ++i) cluster_id[i] = i;
  for (long i = 0; i < n; ++i) d2[i * n + i] = INF;

  std::vector<long> chain;
  chain.reserve((size_t)n);
  long first_active = 0;

  for (long step = 0; step < n - 1; ++step) {
    if (chain.empty()) {
      while (!active[first_active]) ++first_active;
      chain.push_back(first_active);
    }
    long a, b;
    for (;;) {
      a = chain.back();
      const double* row = d2 + a * n;
      double best = INF;
      b = -1;
      for (long j = 0; j < n; ++j) {
        if (!active[j] || j == a) continue;
        if (row[j] < best) {
          best = row[j];
          b = j;
        }
      }
      if (chain.size() > 1 && b == chain[chain.size() - 2]) break;
      chain.push_back(b);
    }
    // (a, b) are the mutual nearest neighbors; drop both chain entries
    chain.pop_back();   // a
    chain.pop_back();   // b

    const double dist = std::sqrt(d2[a * n + b]);
    long ia = cluster_id[a], ib = cluster_id[b];
    long lo = ia < ib ? ia : ib, hi = ia < ib ? ib : ia;
    merges[step * 4 + 0] = (double)lo;
    merges[step * 4 + 1] = (double)hi;
    merges[step * 4 + 2] = dist;
    merges[step * 4 + 3] = size[a] + size[b];

    // Lance-Williams Ward update into slot a
    const double sa = size[a], sb = size[b], dab = d2[a * n + b];
    for (long k = 0; k < n; ++k) {
      if (!active[k] || k == a || k == b) continue;
      const double sk = size[k];
      const double v = ((sa + sk) * d2[a * n + k] + (sb + sk) * d2[b * n + k] -
                        sk * dab) /
                       (sa + sb + sk);
      d2[a * n + k] = v;
      d2[k * n + a] = v;
    }
    d2[a * n + a] = INF;
    active[b] = 0;
    for (long k = 0; k < n; ++k) {
      d2[b * n + k] = INF;
      d2[k * n + b] = INF;
    }
    size[a] = sa + sb;
    cluster_id[a] = n + step;
  }
  return 0;
}
