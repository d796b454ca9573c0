// Part 2's exact float64 re-scoring of a batch of candidates, on the card.
//
// Replaces no TPU kernel: the JAX package re-scores each candidate on the host
// (hic_genome_assembler_tpu/ops/cost.py, SubsetScorer.score_host), gathering
// the candidate's bin order out of the group's float64 matrix with np.ix_ and
// calling oracle.cost_function, one np.trace a diagonal.  That host path is
// this kernel's plain version (ops/score_kernels.py, f64_rescores_plain) and
// the oracle of its tests.  For a candidate with bin order bo of length K
// over the group's matrix M, G[j, k] = M[bo[j], bo[k]], and
//
//   trace_i    = sum_j G[j, j + i]                     (i = 1 .. K - 1)
//   cumulative += trace_i;  cost += cumulative / total / i
//
// with the same bits as the host: each diagonal is summed in np.trace's order
// (numpy's reduction takes the diagonal in chunks of `chunk` elements, its
// buffer, added one after another onto 0.0; each chunk is numpy's pairwise
// sum: under 8 elements in sequence from 0.0; up to 128 with eight strided
// accumulators combined ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the rest in
// sequence; above 128 split at n/2 rounded down to a multiple of 8, left +
// right), and every add and divide is an explicit round-to-nearest intrinsic,
// so nvcc cannot contract any of them into an FMA.  G is never built: the
// kernel reads M[bo[j], bo[j + i]] itself (M need not be symmetric, so the
// transpose is never read).
//
// What bounds it on this card: bytes.  A candidate reads K(K - 1)/2 float64
// elements once (47 MB at K = 3,430, 14 us of HBM) and adds each once; the
// order of the adds is numpy's, so the work a lane does is fixed, and the
// layout is what the design chooses.  A warp takes 32 neighbouring diagonals
// i0 .. i0 + 31, one a lane, and walks j in groups of 8: at each j the lanes
// read M[bo[j], bo[j + i0 + lane]], one row of M and 32 columns that are
// neighbours wherever the candidate's bin order runs along a scaffold (a
// tile of 8 rows by 32 columns of G a step), so the loads coalesce.  Every
// leaf of numpy's tree starts at a multiple of 8 from the diagonal's start
// (a left child's length is a multiple of 8, and so is the chunk), so all the
// lanes of a warp are at the same place in their eight accumulators, and a
// lane's leaves end at its own j: each lane keeps its own small stack of the
// tree's pending right children and left values.  Only the last leaf of a
// diagonal has a sequential rest.  The last warp of a candidate to finish
// (an atomic ticket, never an atomic sum) adds the traces in order: the
// cumulative sums in one lane, the divisions across the warp, the cost in
// one lane.  No sum depends on the schedule, so a rerun gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLeaf = 128;      // numpy's PW_BLOCKSIZE
constexpr int kDepth = 16;      // pending right children: about log2(chunk / 64) + 1 levels
constexpr unsigned kFull = 0xffffffffu;

// One lane's walk over its diagonal's pairwise tree, leaf by leaf.
struct Walk {
  int L;                        // the diagonal's length
  int chunk;                    // numpy's reduction chunk (a multiple of 8)
  int chunk_end;                // end of the current chunk
  int sp;                       // pending frames
  int right_start[kDepth], right_len[kDepth];
  double left[kDepth];          // a frame's left value, once its right child runs
  bool on_right[kDepth];
  int leaf_start, main_end, leaf_end;
  double trace;
  bool done;

  // Walk down from node [s, s + n) to its first leaf.
  __device__ void descend(int s, int n) {
    while (n > kLeaf) {
      const int n2 = (n >> 1) & ~7;
      right_start[sp] = s + n2;
      right_len[sp] = n - n2;
      on_right[sp] = false;
      ++sp;
      n = n2;
    }
    leaf_start = s;
    leaf_end = s + n;
    main_end = n < 8 ? s : s + n - (n & 7);
  }

  __device__ void start_chunk(int s) {
    chunk_end = min(s + chunk, L);
    descend(s, chunk_end - s);
  }

  // The current leaf summed to x: fold it into the tree and find the next leaf.
  __device__ void finish_leaf(double x) {
    while (sp > 0) {
      const int top = sp - 1;
      if (!on_right[top]) {
        left[top] = x;
        on_right[top] = true;
        descend(right_start[top], right_len[top]);
        return;
      }
      x = __dadd_rn(left[top], x);
      --sp;
    }
    trace = __dadd_rn(trace, x);   // the chunk's sum onto the reduction's total
    if (chunk_end < L) {
      start_chunk(chunk_end);
    } else {
      done = true;
    }
  }
};

__global__ void __launch_bounds__(32)
f64_rescore_kernel(const double* __restrict__ M, int64_t ld, const int* __restrict__ bin_orders,
                   int K, int chunk, double total, double* __restrict__ traces,
                   int* __restrict__ tickets, double* __restrict__ costs) {
  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int* __restrict__ bo = bin_orders + static_cast<int64_t>(b) * K;
  double* tr = traces + static_cast<int64_t>(b) * K;
  const int i0 = 1 + blockIdx.x * 32;
  const int i = i0 + lane;                 // this lane's diagonal
  const int Lmax = K - i0;                 // lane 0's length, the warp's walk

  Walk w;
  w.L = K - i;
  w.chunk = chunk;
  w.sp = 0;
  w.trace = 0.0;
  w.done = w.L <= 0;
  if (!w.done) w.start_chunk(0);
  double r[8];
  double res = 0.0;

  for (int j = 0; j < Lmax; j += 8) {
    double a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = 0.0;
      if (j + k < w.L) {
        const int64_t row = __ldg(&bo[j + k]);
        a[k] = __ldg(&M[row * ld + __ldg(&bo[j + k + i])]);
      }
    }
    if (w.done) continue;
    if (j < w.main_end) {                  // a group of the leaf's eight accumulators
      if (j == w.leaf_start) {
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = a[k];
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = __dadd_rn(r[k], a[k]);
      }
      if (j + 8 == w.main_end) {
        res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                        __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
        if (w.leaf_end == w.main_end) w.finish_leaf(res);
      }
    } else {                               // the last leaf's rest, or a leaf under 8
      if (w.main_end == w.leaf_start) res = 0.0;
      const int rest = w.leaf_end - j;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < rest) res = __dadd_rn(res, a[k]);
      w.finish_leaf(res);
    }
  }
  if (i < K) tr[i] = w.trace;

  // the candidate's last warp adds the traces in order
  __threadfence();
  int last = 0;
  if (lane == 0) last = atomicAdd(&tickets[b], 1) == static_cast<int>(gridDim.x) - 1;
  last = __shfl_sync(kFull, last, 0);
  if (!last) return;
  __threadfence();
  if (lane == 0) {
    double cumulative = 0.0;
    for (int d = 1; d < K; ++d) {
      cumulative = __dadd_rn(cumulative, __ldcg(&tr[d]));
      tr[d] = cumulative;
    }
  }
  __syncwarp();
  for (int d = 1 + lane; d < K; d += 32)
    tr[d] = __ddiv_rn(__ddiv_rn(tr[d], total), static_cast<double>(d));
  __syncwarp();
  if (lane == 0) {
    double cost = 0.0;
    for (int d = 1; d < K; ++d) cost = __dadd_rn(cost, tr[d]);
    costs[b] = cost;
    tickets[b] = 0;
  }
}

}  // namespace

// M [C, C] float64 with row stride ld, bin_orders int32 [B, K] (K >= 2,
// entries in [0, C)), chunk a positive multiple of 8, traces float64 [B, K]
// scratch, tickets int32 [B] zeroed (left zeroed), costs float64 [B].
extern "C" int f64_rescore(const double* M, int64_t ld, const int* bin_orders, int B, int K,
                           int chunk, double total, double* traces, int* tickets, double* costs,
                           cudaStream_t stream) {
  const dim3 grid((K - 1 + 31) / 32, B);
  f64_rescore_kernel<<<grid, 32, 0, stream>>>(M, ld, bin_orders, K, chunk, total, traces,
                                              tickets, costs);
  return static_cast<int>(cudaGetLastError());
}
