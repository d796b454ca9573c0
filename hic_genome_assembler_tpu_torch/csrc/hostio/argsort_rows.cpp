// Row-parallel clone of numpy's argsort(kind='quicksort') for f64 rows.
//
// The part-1 rank matrix is `numpy.argsort(sim, axis=1)[:, ::-1]`
// (scaffoldToChromosomes.py:1132).  Its TIE ORDER — the order equal
// values appear in — is an artifact of numpy's introsort
// implementation, and the growing/fixed window membership counts
// consume that order wherever a tie group straddles a window prefix
// (ubiquitous: every zero contact lands in one huge equal-value
// group).  Byte-parity with the reference therefore requires numpy's
// EXACT algorithm, not just any descending sort; no device sort can
// reproduce it, which pins the rank build to the host (see
// models/part1_cluster.py matrix_mode docstring).
//
// This kernel reimplements numpy's npysort aquicksort_double +
// aheapsort_double (median-of-3 introsort, insertion sort below 16,
// heapsort at depth exhaustion, Tag::less = (a < b) || (b != b && a ==
// a) NaN-aware compare) and fans rows out across hardware threads —
// rows are independent, so parallelism cannot change a single entry.
// Equality with np.argsort is asserted empirically over adversarial
// tie-heavy batteries (tests/test_ops_matrix.py) and the caller falls
// back to numpy when the probe at import disagrees — so a future
// numpy changing its sort (e.g. AVX-512 x86-simd-sort dispatch)
// degrades to the slow path instead of breaking parity.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kSmallQuicksort = 15;
constexpr int kQsStack = 100;

inline bool lt(double a, double b) {
    return (a < b) || (b != b && a == a);
}

inline int msb(int64_t unum) {
    int depth = 0;
    while (unum >>= 1) ++depth;
    return depth;
}

void aheapsort(const double* v, int64_t* tosort, int64_t n) {
    int64_t* a = tosort - 1;  // heapsort uses 1-based indexing
    int64_t i, j, l, tmp;

    for (l = n >> 1; l > 0; --l) {
        tmp = a[l];
        for (i = l, j = l << 1; j <= n;) {
            if (j < n && lt(v[a[j]], v[a[j + 1]])) j += 1;
            if (lt(v[tmp], v[a[j]])) {
                a[i] = a[j];
                i = j;
                j += j;
            } else {
                break;
            }
        }
        a[i] = tmp;
    }

    for (; n > 1;) {
        tmp = a[n];
        a[n] = a[1];
        n -= 1;
        for (i = 1, j = 2; j <= n;) {
            if (j < n && lt(v[a[j]], v[a[j + 1]])) j += 1;
            if (lt(v[tmp], v[a[j]])) {
                a[i] = a[j];
                i = j;
                j += j;
            } else {
                break;
            }
        }
        a[i] = tmp;
    }
}

void aquicksort(const double* v, int64_t* tosort, int64_t num) {
    double vp;
    int64_t* pl = tosort;
    int64_t* pr = tosort + num - 1;
    int64_t* stack[kQsStack];
    int64_t** sptr = stack;
    int64_t *pm, *pi, *pj, *pk;
    int64_t vi, tmp;
    int depth_limit = msb(num) * 2;

    for (;;) {
        while ((pr - pl) > kSmallQuicksort) {
            if (depth_limit-- < 0) {
                aheapsort(v, pl, pr - pl + 1);
                goto stack_pop;
            }
            // median-of-3 pivot
            pm = pl + ((pr - pl) >> 1);
            if (lt(v[*pm], v[*pl])) { tmp = *pm; *pm = *pl; *pl = tmp; }
            if (lt(v[*pr], v[*pm])) { tmp = *pr; *pr = *pm; *pm = tmp; }
            if (lt(v[*pm], v[*pl])) { tmp = *pm; *pm = *pl; *pl = tmp; }
            vp = v[*pm];
            pi = pl;
            pj = pr - 1;
            tmp = *pm; *pm = *pj; *pj = tmp;
            for (;;) {
                do ++pi; while (lt(v[*pi], vp));
                do --pj; while (lt(vp, v[*pj]));
                if (pi >= pj) break;
                tmp = *pi; *pi = *pj; *pj = tmp;
            }
            pk = pr - 1;
            tmp = *pi; *pi = *pk; *pk = tmp;
            // push largest partition on stack
            if (pi - pl < pr - pi) {
                *sptr++ = pi + 1;
                *sptr++ = pr;
                pr = pi - 1;
            } else {
                *sptr++ = pl;
                *sptr++ = pi - 1;
                pl = pi + 1;
            }
        }
        // insertion sort
        for (pi = pl + 1; pi <= pr; ++pi) {
            vi = *pi;
            vp = v[vi];
            pj = pi;
            pk = pi - 1;
            while (pj > pl && lt(vp, v[*pk])) {
                *pj-- = *pk--;
            }
            *pj = vi;
        }
    stack_pop:
        if (sptr == stack) break;
        pr = *(--sptr);
        pl = *(--sptr);
    }
}

}  // namespace

extern "C" {

// argsort each row of the n_rows x n_cols f64 matrix into `out`
// (int64, same shape), numpy-quicksort-identical per row, rows split
// across hardware threads.  reverse != 0 additionally reverses each
// output row in place (the `[:, ::-1]` of the rank-matrix build).
void argsort_rows_f64(const double* m, int64_t* out, int64_t n_rows,
                      int64_t n_cols, int reverse) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads =
        std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n_rows));
    if (n_rows * n_cols < (int64_t)1 << 18) n_threads = 1;

    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int64_t* row_out = out + i * n_cols;
            for (int64_t j = 0; j < n_cols; ++j) row_out[j] = j;
            aquicksort(m + i * n_cols, row_out, n_cols);
            if (reverse) {
                for (int64_t a = 0, b = n_cols - 1; a < b; ++a, --b) {
                    int64_t t = row_out[a];
                    row_out[a] = row_out[b];
                    row_out[b] = t;
                }
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
