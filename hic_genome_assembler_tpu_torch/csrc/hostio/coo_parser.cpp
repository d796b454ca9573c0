// Native COO triplet parser for HiC-Pro iced.matrix files.
//
// The matrix file holds one `binID1\tbinID2\tvalue` triplet per line —
// up to ~10^8 lines at 100 Kb resolution on a 1.6 Gb genome
// (scaffoldToChromosomes.py:70-98 consumes it line by line).
//
// Two-call protocol (io/native.py): coo_max_rows() counts newlines so
// the caller can allocate the exact numpy buffer, then parse_coo_into()
// mmap-reads the file once, splits it across hardware threads at
// newline boundaries, and each thread parses its slice DIRECTLY into
// its disjoint region of the caller's buffer — no intermediate
// allocations, no concat copy, no page-fault storm on throwaway arenas.
// Slice regions are laid out in FILE ORDER, so the caller's
// last-write-wins duplicate semantics (hicpro.build_adjacency_matrix)
// are preserved exactly; blank lines shrink a slice and trigger a
// single left-compaction pass.
//
// pandas' C parser is the fallback at the call site.

#include <charconv>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    bool ok = false;
};

Mapped map_file(const char* path) {
    Mapped m;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return m;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return m; }
    m.size = static_cast<size_t>(st.st_size);
    m.ok = true;
    if (m.size == 0) { close(fd); return m; }
    void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (p == MAP_FAILED) { m.ok = false; return m; }
    madvise(p, m.size, MADV_SEQUENTIAL | MADV_WILLNEED);
    m.data = static_cast<const char*>(p);
    return m;
}

size_t pick_threads(size_t size) {
    unsigned hw = std::thread::hardware_concurrency();
    size_t n = hw ? hw : 1;
    if (size < (1u << 20)) n = 1;  // small files: skip thread setup
    return n;
}

// slice boundaries snapped forward past the next newline
std::vector<size_t> slice_bounds(const char* data, size_t size, size_t n) {
    std::vector<size_t> bounds(n + 1, size);
    bounds[0] = 0;
    for (size_t t = 1; t < n; ++t) {
        size_t pos = size * t / n;
        const void* nl = memchr(data + pos, '\n', size - pos);
        bounds[t] = nl ? static_cast<const char*>(nl) - data + 1 : size;
    }
    return bounds;
}

size_t count_newlines(const char* p, const char* end) {
    size_t count = 0;
    while (p < end) {
        const void* nl = memchr(p, '\n', end - p);
        if (!nl) break;
        ++count;
        p = static_cast<const char*>(nl) + 1;
    }
    return count;
}

const double kPow10[16] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
                           1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};

// Parse one whitespace-delimited double starting at p. Fast path for the
// dominant fixed-point format (`123`, `57.49217134`): an integer
// mantissa of <= 15 digits and a power-of-10 divisor are both exactly
// representable, so one division yields the correctly-rounded value —
// bit-identical to strtod/from_chars/pandas. Exponents, long mantissas,
// inf/nan fall back to std::from_chars. Returns nullptr on a malformed
// field.
inline const char* read_field(const char* p, const char* end, double& out) {
    while (p < end && (*p == '\t' || *p == ' ')) ++p;
    const char* q = p;
    bool neg = false;
    if (q < end && (*q == '-' || *q == '+')) { neg = (*q == '-'); ++q; }
    uint64_t mant = 0;
    int digits = 0, frac = 0;
    while (q < end && *q >= '0' && *q <= '9' && digits < 15) {
        mant = mant * 10 + static_cast<uint64_t>(*q - '0');
        ++digits; ++q;
    }
    if (q < end && *q == '.') {
        ++q;
        while (q < end && *q >= '0' && *q <= '9' && digits < 15) {
            mant = mant * 10 + static_cast<uint64_t>(*q - '0');
            ++digits; ++frac; ++q;
        }
    }
    // anything still pending (more digits, exponent, second dot, or an
    // empty/garbage field) -> exact slow path
    if (digits == 0 ||
        (q < end && (*q == 'e' || *q == 'E' || *q == '.' ||
                     (*q >= '0' && *q <= '9')))) {
        auto res = std::from_chars(p, end, out);
        if (res.ec != std::errc() || res.ptr == p) return nullptr;
        return res.ptr;
    }
    double v = static_cast<double>(mant) / kPow10[frac];
    out = neg ? -v : v;
    return q;
}

// Parse [p, end) of complete lines into out (row-major triplets).
// Returns the number of rows written, or -1 on a malformed line.
int64_t parse_slice(const char* p, const char* end, double* out) {
    int64_t rows = 0;
    while (p < end) {
        if (*p == '\n') { ++p; continue; }  // skip blank lines
        double* trip = out + rows * 3;
        for (int f = 0; f < 3; ++f) {
            p = read_field(p, end, trip[f]);
            if (!p) return -1;
        }
        while (p < end && *p != '\n') ++p;  // tolerate \r / trailing junk
        if (p < end) ++p;
        ++rows;
    }
    return rows;
}

}  // namespace

extern "C" {

// Upper bound on triplet rows (newline count, +1 for an unterminated
// final line). -1 on IO error. Also warms the page cache for the
// parse pass.
int64_t coo_max_rows(const char* path) {
    Mapped m = map_file(path);
    if (!m.ok) return -1;
    if (m.size == 0) return 0;
    size_t lines = count_newlines(m.data, m.data + m.size);
    if (m.data[m.size - 1] != '\n') ++lines;
    munmap(const_cast<char*>(m.data), m.size);
    return static_cast<int64_t>(lines);
}

// Parse the triplet file into caller-owned out[capacity*3] (row-major
// id1, id2, value). Returns 0 and the actual row count on success,
// 1 on IO error, 2 on a malformed line, 3 if capacity is too small.
int parse_coo_into(const char* path, double* out, int64_t capacity,
                   int64_t* out_rows) {
    *out_rows = 0;
    Mapped m = map_file(path);
    if (!m.ok) return 1;
    if (m.size == 0) return 0;
    const char* data = m.data;
    size_t size = m.size;

    size_t n_threads = pick_threads(size);
    std::vector<size_t> bounds = slice_bounds(data, size, n_threads);

    // per-slice row upper bounds -> disjoint output offsets in file order
    std::vector<int64_t> max_rows(n_threads);
    {
        std::vector<std::thread> pool;
        for (size_t t = 0; t < n_threads; ++t)
            pool.emplace_back([&, t] {
                size_t lines =
                    count_newlines(data + bounds[t], data + bounds[t + 1]);
                if (bounds[t + 1] > bounds[t] &&
                    data[bounds[t + 1] - 1] != '\n')
                    ++lines;
                max_rows[t] = static_cast<int64_t>(lines);
            });
        for (auto& th : pool) th.join();
    }
    std::vector<int64_t> offsets(n_threads + 1, 0);
    for (size_t t = 0; t < n_threads; ++t)
        offsets[t + 1] = offsets[t] + max_rows[t];
    if (offsets[n_threads] > capacity) {
        munmap(const_cast<char*>(data), size);
        return 3;
    }

    std::vector<int64_t> got(n_threads, 0);
    {
        std::vector<std::thread> pool;
        for (size_t t = 0; t < n_threads; ++t)
            pool.emplace_back([&, t] {
                got[t] = parse_slice(data + bounds[t], data + bounds[t + 1],
                                     out + offsets[t] * 3);
            });
        for (auto& th : pool) th.join();
    }
    munmap(const_cast<char*>(data), size);
    for (size_t t = 0; t < n_threads; ++t)
        if (got[t] < 0) return 2;

    // blank lines shrink a slice below its bound: compact left once
    int64_t write = got[0];
    for (size_t t = 1; t < n_threads; ++t) {
        if (offsets[t] != write)
            memmove(out + write * 3, out + offsets[t] * 3,
                    static_cast<size_t>(got[t]) * 3 * sizeof(double));
        write += got[t];
    }
    *out_rows = write;
    return 0;
}

}  // extern "C"
