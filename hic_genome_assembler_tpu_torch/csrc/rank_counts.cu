// Rank-membership counts for the part-1 breakpoint scans, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hic_genome_assembler_tpu/ops/pallas_kernels.py
// :: _counts_kernel (launched by _counts_call, batched K-wide by
// _counts_call_many).  For each params row k = (start, cut, flag) and each
// row i of the rank matrix R:
//
//     out[k, i] = #{ j < hi - start : start <= R[i, j] <= hi }
//     hi = i    when flag == 1   (growing-window scan)
//     hi = cut  when flag == 0   (fixed window of the cut-noise filter)
//
// R may be one block of a larger matrix whose top-left element is the
// global (row0, col0): then i = row0 + row and j = col0 + col, and the block
// counts only its own columns.  The partial counts of a row's blocks along
// the mesh's model axis add up to the row's count; offsets of 0 give the
// whole-matrix counts.
//
// Pad entries of R are -1 (or 65535 widened from a uint16 upload); neither
// lies in [start, hi] for any row of a matrix with n < 65535, so padding
// never counts.
//
// What bounds it on this card: memory bandwidth.  Every element compared is
// one 4-byte load with no reuse and two integer compares, so the scan is a
// stream over the rank matrix (a 17K-bin genome's padded matrix is 1.28 GB).
// The Pallas grid walks every (512, 2048) tile and masks columns past the
// prefix to zero, carrying each row's sum across the column grid in an
// output block.  Hopper's blocks run in no order, so nothing is carried:
// one warp owns one row, its lanes stride over the row's prefix only
// (j < min(hi - start, n_cols)), and the warp reduces with
// __reduce_add_sync.  A growing scan therefore reads the triangle below the
// diagonal band, not the square.  Consecutive lanes read consecutive
// columns, so each warp load is one 128-byte transaction.
//
// Simple first: int32 loads, no vector loads, no TMA, no uint16 reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rank_counts_kernel(const int32_t* __restrict__ R, int64_t ld, int n_rows,
                   int n_cols, int row0, int col0, const int32_t* __restrict__ params,
                   int32_t* __restrict__ out) {
  const int k = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp: one row per warp

  const int start = params[3 * k];
  const int cut = params[3 * k + 1];
  const int hi = params[3 * k + 2] == 1 ? row0 + row : cut;
  // columns of this block that lie in the prefix j < hi - start, in int64
  // so that a block past the prefix end clamps to zero iterations
  const int64_t prefix_end = static_cast<int64_t>(hi) - start - col0;
  const int end = prefix_end <= 0 ? 0
                  : (prefix_end < n_cols ? static_cast<int>(prefix_end) : n_cols);

  const int32_t* r = R + static_cast<int64_t>(row) * ld;
  unsigned count = 0;
#pragma unroll 4
  for (int j = lane; j < end; j += 32) {
    const int v = __ldg(r + j);
    count += (v >= start) & (v <= hi);
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) out[static_cast<int64_t>(k) * n_rows + row] = static_cast<int32_t>(count);
}

}  // namespace

// R: int32 rows with row stride ld (elements) and unit column stride, the
// block of a matrix whose top-left element is the global (row0, col0);
// params: int32[K, 3]; out: int32[K, n_rows].  All pointers on the device.
// Launches on `stream` and returns the launch status; does not synchronise.
extern "C" int rank_counts(const int32_t* R, int64_t ld, int n_rows, int n_cols,
                           int row0, int col0, const int32_t* params, int K,
                           int32_t* out, cudaStream_t stream) {
  if (n_rows <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (K > 65535 || n_cols < 0 || ld < n_cols || row0 < 0 || col0 < 0 ||
      static_cast<int64_t>(row0) + n_rows > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock, K);
  rank_counts_kernel<<<grid, kWarpsPerBlock * 32, 0, stream>>>(R, ld, n_rows, n_cols, row0,
                                                                col0, params, out);
  return static_cast<int>(cudaGetLastError());
}
