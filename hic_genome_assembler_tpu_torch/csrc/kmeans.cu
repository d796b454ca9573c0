// Two-centre k-means on the card, in float64: the statistics, the k-means++
// seeding and the Lloyd iterations that start the HMM's EM.
//
// Replaces the k-means of hic_genome_assembler_tpu/ops/gaussian_hmm.py
// (GaussianHMM2._init_params: sklearn's KMeans(n_clusters=2) and the data's
// diagonal covariance), whose numpy reproduction in ops/kmeans.py is the
// plain version and the oracle of these kernels:
//   kmeans_col_stats     <- X.mean(axis=0), np.var(X, axis=0) (k-means' tol)
//                           and diag_covars' ddof-1 variance
//   kmeans_center        <- X -= mean; x_sq = row norms of the centred rows
//   kmeans_seed_closest  <- _plusplus' closest distances to the first centre
//   kmeans_seed_pots     <- the two candidates' potentials, per block
//   kmeans_seed_pick     <- their fold, the argmin, the two starting centres
//   kmeans_step          <- _labels + the sums of _update_centers (one pass)
//   kmeans_fold          <- _update_centers' scaling, the shift, the new norms
//   kmeans_choose        <- the inertia and kmeans2's choice among the inits
// The host keeps what does not depend on the data: the RandomState draws, the
// candidate indices (numpy's cumsum and searchsorted over the closest
// distances, read back) and the loop's stopping rule (read back once an
// iteration); the rare empty-cluster relocation runs in plain torch.
//
// What bounds it on this card: nothing in the arithmetic.  A fit's matrix is
// at most [17,162 x 8,600] (the 16K genome) and mostly [3,715 x 743] (22 MB,
// which stays in the 50 MB L2); a pass over it is ~7 us of HBM bytes, two
// dot products a row are ~0.3 us of f64 FMAs.  The launches, the host's
// readbacks between them and the latency of each warp's dependent loads set
// the time.  So each Lloyd step is one pass and one fold: a warp a row
// computes both centres' dot products (unrolled, so that loads overlap) and
// the label, then the block walks its own rows again by columns and adds each
// into its label's sum, in row order; about two blocks an SM of ~one row a
// warp.  The per-label sums of a block go to global memory ([blocks, 2, d]:
// no shared memory per column, so every d runs), and the fold's blocks, one a
// tile of 32 columns, add them in block order; the last tile to finish (an
// atomic ticket, never an atomic sum) adds the tiles' shift and norms in tile
// order.
//
// Every sum has a fixed order (warp butterflies, warps in order, blocks in
// order, tiles in order; the integer counts are exact in any order), so a
// rerun gives the same bits.  Against numpy only the association of the f64
// sums differs, as numpy itself differs from scikit-learn.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;                // warps of a row kernel's block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 2048;            // rows of a block: ops/kmeans.py's _MAX_ROWS
constexpr int kStatCols = 8;              // columns of a column-statistics block
constexpr int kStatGroups = 128;          // its row groups: 1024 threads / kStatCols
constexpr int kFoldThreads = 1024;        // the folds: one block, or one a tile of 32 columns
constexpr int kCounts = 6;                // a step's integers: see kmeans_step_kernel
constexpr int kTileStats = 5;             // a fold tile's sums: see kmeans_fold_kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr double kMinCovar = 1e-3;        // ops/kmeans.py's MIN_COVAR
constexpr double kTol = 1e-4;             // ops/kmeans.py's _TOL

// The sum over a warp, the same bits in every lane: each butterfly level adds
// two equal pairs of operands, and addition commutes exactly.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum over the block, the same in every thread: the warps' sums added in
// warp order.  `scratch` holds 32 doubles of shared memory.
__device__ double block_sum(double v, double* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += scratch[w];
  return total;
}

// The block adds ints first .. first + count - 1 of `records` records of
// `stride` ints into `totals` (shared, zeroed): each warp's sum, then one
// atomic a warp; integer sums, exact in any order.
__device__ void add_counts(const int* counts, int records, int stride, int first, int count,
                           int* totals) {
  for (int k = 0; k < count; ++k) {
    int v = 0;
    for (int b = threadIdx.x; b < records; b += blockDim.x) v += counts[b * stride + first + k];
    v = __reduce_add_sync(kFull, v);
    if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(&totals[k], v);
  }
}

// np.maximum(v, 0) and np.minimum(a, b) as numpy has them (a NaN stays).
__device__ __forceinline__ double clip0(double v) { return v < 0.0 ? 0.0 : v; }
__device__ __forceinline__ double min_np(double a, double b) { return b < a ? b : a; }

// A block of kStatCols columns and kStatGroups row groups (thread t: column
// t % kStatCols, group t / kStatCols, rows group, group + kStatGroups, ...);
// the groups' sums added in group order.  Two passes: the mean, then the
// squared deviations from it.
__global__ void __launch_bounds__(kStatCols * kStatGroups)
kmeans_col_stats_kernel(const double* __restrict__ X, int n, int d, double* __restrict__ mean,
                        double* __restrict__ var0, double* __restrict__ covars) {
  __shared__ double part[kStatGroups][kStatCols];
  __shared__ double mu[kStatCols];
  const int c = threadIdx.x % kStatCols, g = threadIdx.x / kStatCols;
  const int j = blockIdx.x * kStatCols + c;
  const bool live = j < d;
  double s = 0.0;
  if (live) {
#pragma unroll 4
    for (int r = g; r < n; r += kStatGroups) s += X[static_cast<size_t>(r) * d + j];
  }
  part[g][c] = s;
  __syncthreads();
  if (g == 0) {
    double t = 0.0;
    for (int k = 0; k < kStatGroups; ++k) t += part[k][c];
    mu[c] = t / n;
  }
  __syncthreads();
  const double m = mu[c];
  s = 0.0;
  if (live) {
#pragma unroll 4
    for (int r = g; r < n; r += kStatGroups) {
      const double e = X[static_cast<size_t>(r) * d + j] - m;
      s += e * e;
    }
  }
  part[g][c] = s;  // group 0 read `part` before the last barrier
  __syncthreads();
  if (g == 0 && live) {
    double t = 0.0;
    for (int k = 0; k < kStatGroups; ++k) t += part[k][c];
    mean[j] = m;
    var0[j] = t / n;
    const double v = t * (1.0 / (n - 1)) + kMinCovar;
    const double cv = v < kMinCovar ? kMinCovar : v;
    covars[j] = cv;
    covars[d + j] = cv;
  }
}

// The row kernels: block b takes rows [b * rows, (b + 1) * rows), warp w of it
// rows w, w + kWarps, ...; each row's dot products are a warp's strided sums.
__global__ void __launch_bounds__(kThreads)
kmeans_center_kernel(const double* __restrict__ X, const double* __restrict__ mean, int n, int d,
                     int rows, double* __restrict__ Xc, double* __restrict__ x_sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const double* x = X + static_cast<size_t>(r) * d;
    double* xc = Xc + static_cast<size_t>(r) * d;
    double s = 0.0;
#pragma unroll 4
    for (int j = lane; j < d; j += 32) {
      const double v = x[j] - mean[j];
      xc[j] = v;
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) x_sq[r] = s;
  }
}

// _sq_distances(c, X, x_sq) for c = Xc[first]: (-2 c.x + |c|^2) + |x|^2, clipped.
__global__ void __launch_bounds__(kThreads)
kmeans_seed_closest_kernel(const double* __restrict__ Xc, const double* __restrict__ x_sq, int n,
                           int d, int rows, int first, double* __restrict__ closest) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  const double* c = Xc + static_cast<size_t>(first) * d;
  const double cn = x_sq[first];
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const double* x = Xc + static_cast<size_t>(r) * d;
    double dot = 0.0;
#pragma unroll 4
    for (int j = lane; j < d; j += 32) dot += x[j] * c[j];
    dot = warp_sum(dot);
    if (lane == 0) closest[r] = clip0(-2.0 * dot + cn + x_sq[r]);
  }
}

// Each block's share of the two candidates' potentials
// sum_r min(closest[r], _sq_distances(Xc[cand], Xc[r])): part[b] = {pot0, pot1}.
__global__ void __launch_bounds__(kThreads)
kmeans_seed_pots_kernel(const double* __restrict__ Xc, const double* __restrict__ x_sq,
                        const double* __restrict__ closest, int n, int d, int rows, int cand0,
                        int cand1, double* __restrict__ part) {
  __shared__ double acc[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  const double* c0 = Xc + static_cast<size_t>(cand0) * d;
  const double* c1 = Xc + static_cast<size_t>(cand1) * d;
  const double cn0 = x_sq[cand0], cn1 = x_sq[cand1];
  double p0 = 0.0, p1 = 0.0;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const double* x = Xc + static_cast<size_t>(r) * d;
    double dot0 = 0.0, dot1 = 0.0;
#pragma unroll 4
    for (int j = lane; j < d; j += 32) {
      const double v = x[j];
      dot0 += v * c0[j];
      dot1 += v * c1[j];
    }
    dot0 = warp_sum(dot0);
    dot1 = warp_sum(dot1);
    p0 += min_np(closest[r], clip0(-2.0 * dot0 + cn0 + x_sq[r]));
    p1 += min_np(closest[r], clip0(-2.0 * dot1 + cn1 + x_sq[r]));
  }
  if (lane == 0) {
    acc[warp][0] = p0;
    acc[warp][1] = p1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s0 = 0.0, s1 = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      s0 += acc[w][0];
      s1 += acc[w][1];
    }
    part[2 * blockIdx.x] = s0;
    part[2 * blockIdx.x + 1] = s1;
  }
}

// One block: the potentials folded in block order, the lower one's candidate
// (the first on a tie, as np.argmin) beside the first centre.
__global__ void __launch_bounds__(kFoldThreads)
kmeans_seed_pick_kernel(const double* __restrict__ Xc, const double* __restrict__ x_sq,
                        const double* __restrict__ part, int nb, int d, int first, int cand0,
                        int cand1, double* __restrict__ centers, double* __restrict__ cn) {
  __shared__ double scratch[32];
  double p0 = 0.0, p1 = 0.0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    p0 += part[2 * b];
    p1 += part[2 * b + 1];
  }
  p0 = block_sum(p0, scratch);
  p1 = block_sum(p1, scratch);
  const int pick = p1 < p0 ? cand1 : cand0;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    centers[j] = Xc[static_cast<size_t>(first) * d + j];
    centers[d + j] = Xc[static_cast<size_t>(pick) * d + j];
  }
  if (threadIdx.x == 0) {
    cn[0] = x_sq[first];
    cn[1] = x_sq[pick];
  }
}

// One Lloyd pass over the block's rows.
//   1. A warp a row: the label of min(|c_k|^2 - 2 x.c_k) (label 0 on a tie, as
//      np.argmin), or labels_in's when `relabel` is 0; the integers: rows of
//      label 1, rows whose label changed (all of them without labels_in), and
//      rows of each (label, best label) pair where `best` is given.
//   2. The block by columns: each thread adds its columns of the block's rows,
//      in row order, into its label's sum, and sums (x - c_label)^2 (the
//      inertia, read after the last pass).
// labels_in may be labels_out: a row's label is read before it is written.
__global__ void __launch_bounds__(kThreads)
kmeans_step_kernel(const double* __restrict__ Xc, int n, int d, int rows,
                   const double* __restrict__ centers, const double* __restrict__ cn,
                   const int* labels_in, int* labels_out, int relabel,
                   const int* __restrict__ best, double* __restrict__ part_sums,
                   double* __restrict__ part_inertia, int* __restrict__ part_counts) {
  __shared__ int lab[kMaxRows];
  __shared__ int counts[kCounts];  // label 1, changed, pairs 00, 01, 10, 11
  __shared__ double scratch[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  if (threadIdx.x < kCounts) counts[threadIdx.x] = 0;
  __syncthreads();
  const double cn0 = cn[0], cn1 = cn[1];
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int old = labels_in != nullptr ? labels_in[r] : -1;
    int label = old;
    if (relabel) {
      const double* x = Xc + static_cast<size_t>(r) * d;
      double dot0 = 0.0, dot1 = 0.0;
#pragma unroll 4
      for (int j = lane; j < d; j += 32) {
        const double v = x[j];
        dot0 += v * centers[j];
        dot1 += v * centers[d + j];
      }
      dot0 = warp_sum(dot0);
      dot1 = warp_sum(dot1);
      label = cn1 - 2.0 * dot1 < cn0 - 2.0 * dot0 ? 1 : 0;
    }
    __syncwarp();  // every lane has read labels_in[r] before lane 0 writes it
    if (lane == 0) {
      lab[r - r0] = label;
      labels_out[r] = label;
      if (label) atomicAdd(&counts[0], 1);
      if (label != old) atomicAdd(&counts[1], 1);
      if (best != nullptr) atomicAdd(&counts[2 + 2 * label + best[r]], 1);
    }
  }
  __syncthreads();
  double inertia = 0.0;
  double* sums = part_sums + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const double c0 = centers[j], c1 = centers[d + j];
    double s0 = 0.0, s1 = 0.0;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const double v = Xc[static_cast<size_t>(r) * d + j];
      if (lab[r - r0]) {
        s1 += v;
        const double e = v - c1;
        inertia += e * e;
      } else {
        s0 += v;
        const double e = v - c0;
        inertia += e * e;
      }
    }
    sums[j] = s0;
    sums[d + j] = s1;
  }
  inertia = block_sum(inertia, scratch);
  if (threadIdx.x == 0) part_inertia[blockIdx.x] = inertia;
  if (threadIdx.x < kCounts) part_counts[blockIdx.x * kCounts + threadIdx.x] = counts[threadIdx.x];
}

// A block a tile of 32 columns: warp w adds the step blocks w, w + 32, ... of
// its lane's column, then warp 0 adds the warps' sums in order and scales them
// by the reciprocal weight (an empty cluster's row is left to the host).  The
// tile's sums of (new - old)^2 for each centre, of new^2 for each and of var0
// go to tile_part; the last tile to take a ticket adds the tiles' in a fixed
// order (its first warp): the squared shift as numpy takes it (each centre's
// root, squared, summed), the new centres' squared norms and tol =
// mean(var0) * 1e-4.
// status = {shift^2, tol, weight 0, weight 1, changed}; the ticket is left 0.
__global__ void __launch_bounds__(kFoldThreads)
kmeans_fold_kernel(const double* __restrict__ part_sums, const int* __restrict__ part_counts,
                   int nb, int n, int d, const double* __restrict__ centers,
                   const double* __restrict__ var0, double* __restrict__ centers_new,
                   double* __restrict__ cn_new, double* tile_part, int* ticket,
                   double* __restrict__ status) {
  __shared__ double part[2][32][33];
  __shared__ int total[2];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  if (threadIdx.x < 2) total[threadIdx.x] = 0;
  __syncthreads();
  add_counts(part_counts, nb, kCounts, 0, 2, total);
  double s0 = 0.0, s1 = 0.0;
  if (j < d) {
#pragma unroll 4
    for (int b = warp; b < nb; b += 32) {
      s0 += part_sums[static_cast<size_t>(b) * 2 * d + j];
      s1 += part_sums[static_cast<size_t>(b) * 2 * d + d + j];
    }
  }
  part[0][warp][lane] = s0;
  part[1][warp][lane] = s1;
  __syncthreads();
  if (warp == 0) {
    const double w1 = total[0], w0 = n - total[0];
    double stats[kTileStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
    if (j < d) {
      double t0 = 0.0, t1 = 0.0;
      for (int w = 0; w < 32; ++w) {
        t0 += part[0][w][lane];
        t1 += part[1][w][lane];
      }
      const double c0 = t0 * (1.0 / w0), c1 = t1 * (1.0 / w1);
      centers_new[j] = c0;
      centers_new[d + j] = c1;
      const double e0 = c0 - centers[j], e1 = c1 - centers[d + j];
      stats[0] = e0 * e0;
      stats[1] = e1 * e1;
      stats[2] = c0 * c0;
      stats[3] = c1 * c1;
      stats[4] = var0[j];
    }
    for (int k = 0; k < kTileStats; ++k) {
      const double v = warp_sum(stats[k]);
      if (lane == 0) tile_part[blockIdx.x * kTileStats + k] = v;
    }
    if (lane == 0) {
      __threadfence();
      last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
    }
  }
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();
  double sums[kTileStats] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int t = lane; t < static_cast<int>(gridDim.x); t += 32)
    for (int k = 0; k < kTileStats; ++k) sums[k] += __ldcg(&tile_part[t * kTileStats + k]);
  for (int k = 0; k < kTileStats; ++k) sums[k] = warp_sum(sums[k]);
  if (lane == 0) {
    const double a = sqrt(sums[0]), b = sqrt(sums[1]);
    status[0] = a * a + b * b;
    status[1] = sums[4] / d * kTol;
    status[2] = n - total[0];
    status[3] = total[0];
    status[4] = total[1];
    cn_new[0] = sums[2];
    cn_new[1] = sums[3];
    *ticket = 0;
  }
}

// One block: the last pass's inertia in block order, and kmeans2's rule: the
// first init, or a lower inertia and not the same clustering (the labels do
// not map onto the best's by a function: some label meets both best labels).
// The taken init's centres plus the mean, labels and inertia become the best.
__global__ void __launch_bounds__(kFoldThreads)
kmeans_choose_kernel(const double* __restrict__ part_inertia,
                     const int* __restrict__ part_counts, int nb, int n, int d, int first_init,
                     const double* __restrict__ centers, const double* __restrict__ mean,
                     const int* __restrict__ labels, double* __restrict__ best_centers,
                     int* __restrict__ best_labels, double* __restrict__ best_inertia) {
  __shared__ double scratch[32];
  __shared__ int pairs[4];
  __shared__ int take;
  if (threadIdx.x < 4) pairs[threadIdx.x] = 0;
  __syncthreads();
  add_counts(part_counts, nb, kCounts, 2, 4, pairs);
  double inertia = 0.0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) inertia += part_inertia[b];
  inertia = block_sum(inertia, scratch);  // its barriers also publish `pairs`
  if (threadIdx.x == 0) {
    const bool same = (pairs[0] == 0 || pairs[1] == 0) && (pairs[2] == 0 || pairs[3] == 0);
    take = first_init || (inertia < *best_inertia && !same);
    if (take) *best_inertia = inertia;
  }
  __syncthreads();
  if (!take) return;
  for (int j = threadIdx.x; j < 2 * d; j += blockDim.x) best_centers[j] = centers[j] + mean[j % d];
  for (int i = threadIdx.x; i < n; i += blockDim.x) best_labels[i] = labels[i];
}

int row_blocks(int n, int rows) { return (n + rows - 1) / rows; }

}  // namespace

// Every entry point queues one kernel on `stream` and returns
// cudaGetLastError(); the wrappers in ops/kmeans.py check shapes and types.

extern "C" int kmeans_col_stats(const double* X, int n, int d, double* mean, double* var0,
                                double* covars, cudaStream_t stream) {
  kmeans_col_stats_kernel<<<(d + kStatCols - 1) / kStatCols, kStatCols * kStatGroups, 0,
                            stream>>>(X, n, d, mean, var0, covars);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_center(const double* X, const double* mean, int n, int d, int rows,
                             double* Xc, double* x_sq, cudaStream_t stream) {
  kmeans_center_kernel<<<row_blocks(n, rows), kThreads, 0, stream>>>(X, mean, n, d, rows, Xc,
                                                                     x_sq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_seed_closest(const double* Xc, const double* x_sq, int n, int d, int rows,
                                   int first, double* closest, cudaStream_t stream) {
  kmeans_seed_closest_kernel<<<row_blocks(n, rows), kThreads, 0, stream>>>(Xc, x_sq, n, d, rows,
                                                                           first, closest);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_seed_pots(const double* Xc, const double* x_sq, const double* closest,
                                int n, int d, int rows, int cand0, int cand1, double* part,
                                cudaStream_t stream) {
  kmeans_seed_pots_kernel<<<row_blocks(n, rows), kThreads, 0, stream>>>(
      Xc, x_sq, closest, n, d, rows, cand0, cand1, part);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_seed_pick(const double* Xc, const double* x_sq, const double* part, int nb,
                                int d, int first, int cand0, int cand1, double* centers,
                                double* cn, cudaStream_t stream) {
  kmeans_seed_pick_kernel<<<1, kFoldThreads, 0, stream>>>(Xc, x_sq, part, nb, d, first, cand0,
                                                          cand1, centers, cn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_step(const double* Xc, int n, int d, int rows, const double* centers,
                           const double* cn, const int* labels_in, int* labels_out, int relabel,
                           const int* best, double* part_sums, double* part_inertia,
                           int* part_counts, cudaStream_t stream) {
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  kmeans_step_kernel<<<row_blocks(n, rows), kThreads, 0, stream>>>(
      Xc, n, d, rows, centers, cn, labels_in, labels_out, relabel, best, part_sums, part_inertia,
      part_counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_fold(const double* part_sums, const int* part_counts, int nb, int n, int d,
                           const double* centers, const double* var0, double* centers_new,
                           double* cn_new, double* tile_part, int* ticket, double* status,
                           cudaStream_t stream) {
  kmeans_fold_kernel<<<(d + 31) / 32, kFoldThreads, 0, stream>>>(
      part_sums, part_counts, nb, n, d, centers, var0, centers_new, cn_new, tile_part, ticket,
      status);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmeans_choose(const double* part_inertia, const int* part_counts, int nb, int n,
                             int d, int first_init, const double* centers, const double* mean,
                             const int* labels, double* best_centers, int* best_labels,
                             double* best_inertia, cudaStream_t stream) {
  kmeans_choose_kernel<<<1, kFoldThreads, 0, stream>>>(part_inertia, part_counts, nb, n, d,
                                                       first_init, centers, mean, labels,
                                                       best_centers, best_labels, best_inertia);
  return static_cast<int>(cudaGetLastError());
}
