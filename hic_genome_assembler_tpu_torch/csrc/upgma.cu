// Part 1's UPGMA linkage (average linkage) on the card, with scipy's bits.
//
// Replaces no TPU kernel: the JAX package runs scipy.cluster.hierarchy.average
// on the host (hic_genome_assembler_tpu/cluster/upgma.py) over the float64
// distances of hic_genome_assembler_tpu/ops/oracle.py's to_distance.  scipy's
// average linkage is its nearest-neighbour chain (_hierarchy.nn_chain), and
// this kernel walks the same chain with the same float64 operations:
//
//   grow the chain from its last cluster x: y = the active cluster nearest to
//   x (strictly nearer than the chain's previous cluster, else that one; the
//   earliest index among equal distances); stop when y is the chain's
//   previous cluster.  Merge x and y into the larger index (the smaller one
//   goes inactive) and, for every other active i,
//     d(y, i) = (n_x * d(x, i) + n_y * d(y, i)) / (n_x + n_y)
//   with round-to-nearest intrinsics only, so nvcc cannot contract the
//   expression into an FMA (scipy's C does none).
//
// The distances sit in a symmetric N x N matrix, made from the upper
// triangle by upgma_symmetrize, whose diagonal and every merged-away
// cluster's column read +inf: a row's minimum is then the nearest active
// cluster, and the update's formula gives +inf again for an inactive i.  The
// merges (x, y, distance, size) come back in the order made; the host sorts
// them by distance (stable) and relabels them (ops/linkage.py), as scipy
// does after its chain.  Its plain version is scipy on the host, and
// ops/linkage.nn_chain_plain is this walk in numpy.
//
// What bounds it on this card: latency.  The chain is sequential, about 3N
// steps at N = 17,162, each a scan of one row (137 KB) and a block-wide
// argmin, and each of the N - 1 merges rewrites one row and two columns.
// One block of 1024 threads walks the whole chain in one launch: a step is
// a few microseconds of dependent loads and barriers, so no launch or
// readback sits between the steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr unsigned kFull = 0xffffffffu;

// The lower triangle from the upper, and +inf on the diagonal: a tile below
// the diagonal is the transpose of its mirror tile above it.
__global__ void upgma_symmetrize(double* W, int n) {
  const int ti = blockIdx.y, tj = blockIdx.x;  // tile row, tile column
  if (tj > ti) return;
  __shared__ double tile[kTile][kTile + 1];
  const int tx = threadIdx.x;
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    // mirror tile: rows tj, columns ti of the upper triangle
    const int row = tj * kTile + r, col = ti * kTile + tx;
    if (row < n && col < n) tile[r][tx] = W[(size_t)row * n + col];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int row = ti * kTile + r, col = tj * kTile + tx;
    if (row < n && col < n && col <= row)
      W[(size_t)row * n + col] = col == row ? __longlong_as_double(0x7ff0000000000000LL)
                                            : tile[tx][r];
  }
}

struct Best {
  double v;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// The block's (minimum, earliest index) of each thread's candidate, known to
// every thread.
__device__ Best block_min(Best b, Best* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o{__shfl_down_sync(kFull, b.v, off), __shfl_down_sync(kFull, b.i, off)};
    b = better(b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  if (warp == 0) {
    b = scratch[lane];
    for (int off = 16; off > 0; off >>= 1) {
      Best o{__shfl_down_sync(kFull, b.v, off), __shfl_down_sync(kFull, b.i, off)};
      b = better(b, o);
    }
    if (lane == 0) scratch[kWarps] = b;
  }
  __syncthreads();
  b = scratch[kWarps];
  __syncthreads();  // scratch is free again
  return b;
}

__global__ void __launch_bounds__(kThreads) upgma_chain(
    double* W, int n, int* size, int* chain, int* zx, int* zy, double* zd, int* zs) {
  // no __restrict__: the chain reads what its own merges wrote, which a
  // read-only (non-coherent) load could miss
  __shared__ Best scratch[kWarps + 1];
  const int t = threadIdx.x;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  int len = 0;  // the chain's length, the same in every thread
  for (int k = 0; k < n - 1; ++k) {
    if (len == 0) {  // the chain restarts at the first active cluster
      Best b{0.0, n};
      for (int i = t; i < n; i += kThreads)
        if (size[i] > 0) { b.i = i; break; }
      b = block_min(b, scratch);
      if (t == 0) chain[0] = b.i;
      len = 1;
      __syncthreads();
    }
    int x, y;
    double cur;
    while (true) {
      x = chain[len - 1];
      if (len > 1) {
        y = chain[len - 2];
        cur = W[(size_t)x * n + y];
      } else {
        y = -1;
        cur = inf;
      }
      const double* row = W + (size_t)x * n;
      Best b{inf, n};
#pragma unroll 4
      for (int i = t; i < n; i += kThreads) {
        const double v = row[i];
        if (v < b.v) { b.v = v; b.i = i; }
      }
      b = block_min(b, scratch);
      if (b.v < cur) { cur = b.v; y = b.i; }
      if (len > 1 && y == chain[len - 2]) break;
      __syncthreads();  // every thread has read chain[len - 2]
      if (t == 0) chain[len] = y;
      ++len;
      __syncthreads();
    }
    len -= 2;
    const int a = x < y ? x : y, c = x < y ? y : x;  // a goes inactive, c holds the merge
    const int na = size[a], nc = size[c];
    __syncthreads();  // every thread has read the sizes and the chain
    if (t == 0) {
      zx[k] = a;
      zy[k] = c;
      zd[k] = cur;
      zs[k] = na + nc;
      size[a] = 0;
      size[c] = na + nc;
    }
    const double fa = (double)na, fc = (double)nc, fs = (double)(na + nc);
    double* row_a = W + (size_t)a * n;
    double* row_c = W + (size_t)c * n;
    for (int i = t; i < n; i += kThreads) {
      W[(size_t)i * n + a] = inf;
      if (i == c) continue;
      const double d = __ddiv_rn(__dadd_rn(__dmul_rn(fa, row_a[i]), __dmul_rn(fc, row_c[i])), fs);
      row_c[i] = d;
      W[(size_t)i * n + c] = d;
    }
    __syncthreads();
  }
}

}  // namespace

// W [n, n] float64 (row-major, its upper triangle the distances; made
// symmetric and consumed in place), n >= 2, size int32 [n] (all 1), chain
// int32 [n] scratch, merges zx, zy, zs int32 [n - 1] and zd float64 [n - 1]
// in the order made.
extern "C" int upgma_linkage(double* W, int n, int* size, int* chain, int* zx, int* zy,
                             double* zd, int* zs, cudaStream_t stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kTile - 1) / kTile;
  upgma_symmetrize<<<dim3(tiles, tiles), dim3(kTile, 8), 0, stream>>>(W, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  upgma_chain<<<1, kThreads, 0, stream>>>(W, n, size, chain, zx, zy, zd, zs);
  return (int)cudaGetLastError();
}
