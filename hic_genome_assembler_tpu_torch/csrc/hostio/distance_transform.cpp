// Fused f64 distance transform feeding UPGMA (part 1).
//
// The reference computes dist[i][j] = (1 - m[i][j]/rowsum[i]) + 1 with a
// Python double loop (scaffoldToChromosomes.py:138-148); the framework's
// f64 oracle replaced that with vectorized numpy, but the numpy
// expression still makes three full-matrix temporaries (m/rs, 1-x, x+1:
// ~6 passes over 2.1 GB at 16K plus allocator traffic — 15.35 s recorded
// in the round-3 16K chain).  This kernel fuses the three ops into ONE
// read + ONE write pass, split across hardware threads by row blocks.
//
// Bit-exactness contract: each output element is produced by the same
// IEEE-754 double sequence as the numpy expression — divide, subtract
// from 1.0, add 1.0 — and elements are independent (no reductions), so
// threading/blocking cannot change a single bit.  The row sums are NOT
// computed here: numpy's pairwise-summation order is part of the parity
// contract, so the caller passes `m.sum(axis=1)` in.  (There is no
// multiply-add in the expression, so FMA contraction cannot alter it;
// compiled without -ffast-math.)
//
// Why host, not TPU: the UPGMA feed must be f64 for scipy-bit-identical
// linkage (SURVEY §7 "bit-identical UPGMA"), and TPU hardware has no
// f64 — so the TPU-native design puts this transform in the native host
// runtime (like the COO/validPairs scanners) and keeps the f32 device
// transform (ops/matrix.py) for the similarity/rank stages where
// integer-count exactness, not f64 bitness, is the contract.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// out[i*n+j] = (1.0 - m[i*n+j] / row_sums[i]) + 1.0
// `out` may alias `m` (elementwise, in-place safe).
void distance_transform_f64(const double* m, const double* row_sums,
                            double* out, int64_t n_rows, int64_t n_cols) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n_rows));
    // small matrices: threading overhead dominates
    if (n_rows * n_cols < (int64_t)1 << 20) n_threads = 1;

    auto worker = [&](int64_t row_lo, int64_t row_hi) {
        for (int64_t i = row_lo; i < row_hi; ++i) {
            const double rs = row_sums[i];
            const double* src = m + i * n_cols;
            double* dst = out + i * n_cols;
            for (int64_t j = 0; j < n_cols; ++j) {
                dst[j] = (1.0 - src[j] / rs) + 1.0;
            }
        }
    };

    if (n_threads == 1) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// out[i*n+j] = row_sums[i] * (1.0 - (m[i*n+j] - 1.0))
// The similarity inverse (convertMatrix similarity branch,
// scaffoldToChromosomes.py:150-155): subtract, subtract-from-1,
// multiply — basic IEEE ops only (no libm), so the C sequence is
// bit-identical to the numpy expression per element; no mul+add pair
// exists, so FMA contraction is impossible.  Same threading layout as
// the distance kernel above.
void similarity_transform_f64(const double* m, const double* row_sums,
                              double* out, int64_t n_rows, int64_t n_cols) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n_rows));
    if (n_rows * n_cols < (int64_t)1 << 20) n_threads = 1;

    auto worker = [&](int64_t row_lo, int64_t row_hi) {
        for (int64_t i = row_lo; i < row_hi; ++i) {
            const double rs = row_sums[i];
            const double* src = m + i * n_cols;
            double* dst = out + i * n_cols;
            for (int64_t j = 0; j < n_cols; ++j) {
                dst[j] = rs * (1.0 - (src[j] - 1.0));
            }
        }
    };

    if (n_threads == 1) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
