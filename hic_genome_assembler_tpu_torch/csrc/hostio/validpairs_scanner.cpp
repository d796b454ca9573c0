// Native validPairs stream scanner — threaded.
//
// The HiC-Pro allValidPairs file can be 10^8-10^9 lines; part3 needs only
// the pairs whose (scaffold1, scaffold4) key is in a small set of
// adjacent-scaffold keys (orientSmallScaffolds.py:159-177 streams this in
// Python).  This scanner applies the same newline-sliced threaded design
// as coo_parser.cpp: mmap the file, snap slice boundaries forward past
// the next newline, each hardware thread filters its slice into a
// private growing buffer, and the per-slice buffers are concatenated IN
// FILE ORDER — so the append order of kept pairs is identical to the
// serial scan (decision parity: part3's orientation votes consume the
// records in file order).
//
// C ABI (ctypes):
//   scan_validpairs(path, keys, n_keys, &out, &out_len) -> 0 on success
//   free_buffer(out)
//
// "keys" is a newline-joined list of "scaffA\tscaffB" strings.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Out {
    char* data = nullptr;
    size_t len = 0;
    size_t cap = 0;

    void append(const char* s, size_t n) {
        if (len + n > cap) {
            cap = (cap ? cap * 2 : 1 << 20);
            while (cap < len + n) cap *= 2;
            data = static_cast<char*>(realloc(data, cap));
        }
        memcpy(data + len, s, n);
        len += n;
    }
};

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
    // HIC_SCAN_THREADS overrides (scaling experiments / pinned hosts), clamped
    // to 4 threads a core: a huge value would otherwise ask for that many
    // threads and slice vectors
    if (const char* env = getenv("HIC_SCAN_THREADS")) {
        long v = strtol(env, nullptr, 10);
        if (v >= 1) return std::min(static_cast<size_t>(v), 4 * static_cast<size_t>(hw ? hw : 1));
    }
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
        if (pos < bounds[t - 1]) pos = bounds[t - 1];
        const void* nl = memchr(data + pos, '\n', size - pos);
        bounds[t] = nl ? static_cast<const char*>(nl) - data + 1 : size;
    }
    return bounds;
}

// Find the first `upto` tab-separated fields; returns (ptr, len) pairs.
inline bool split_fields(const char* line, size_t line_len,
                         const char** f, size_t* flen, int upto) {
    int field = 0;
    const char* start = line;
    const char* end = line + line_len;
    const char* p = line;
    while (field < upto) {
        const char* tab = static_cast<const char*>(memchr(p, '\t', end - p));
        const char* stop = tab ? tab : end;
        f[field] = start;
        flen[field] = stop - start;
        ++field;
        if (!tab) break;
        p = tab + 1;
        start = p;
    }
    return field >= upto;
}

// Filter complete lines in [p, end) into out (the final line may be
// unterminated when the slice is the file tail).  s1set holds the first
// scaffold of every key: the overwhelming majority of lines fail the
// key test already at scaffold1 (only scaffolds adjacent to a triplet
// appear in any key), so a cheap 2-field probe skips the other 4 field
// splits and the key assembly for them.
void scan_slice(const char* p, const char* end,
                const std::unordered_set<std::string>& keyset,
                const std::unordered_set<std::string>& s1set, Out& out) {
    std::string key;
    key.reserve(256);
    const char* f[6];
    size_t flen[6];
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* stop = nl ? nl : end;
        size_t line_len = static_cast<size_t>(stop - p);
        if (line_len && p[line_len - 1] == '\r') --line_len;
        if (line_len && split_fields(p, line_len, f, flen, 2)) {
            key.assign(f[1], flen[1]);
            if (s1set.count(key) && split_fields(p, line_len, f, flen, 6)) {
                key.push_back('\t');
                key.append(f[4], flen[4]);
                if (keyset.count(key)) {
                    out.append(f[1], flen[1]);
                    out.append("\t", 1);
                    out.append(f[4], flen[4]);
                    out.append("\t", 1);
                    out.append(f[2], flen[2]);
                    out.append("\t", 1);
                    out.append(f[5], flen[5]);
                    out.append("\n", 1);
                }
            }
        }
        if (!nl) break;
        p = nl + 1;
    }
}

}  // namespace

extern "C" {

int scan_validpairs(const char* path, const char* keys, int64_t n_keys,
                    char** out_data, int64_t* out_len) {
    std::unordered_set<std::string> keyset;
    std::unordered_set<std::string> s1set;
    {
        const char* p = keys;
        for (int64_t i = 0; i < n_keys; ++i) {
            const char* nl = strchr(p, '\n');
            size_t n = nl ? static_cast<size_t>(nl - p) : strlen(p);
            keyset.emplace(p, n);
            const char* tab = static_cast<const char*>(memchr(p, '\t', n));
            if (tab) s1set.emplace(p, static_cast<size_t>(tab - p));
            if (!nl) break;
            p = nl + 1;
        }
    }

    Mapped m = map_file(path);
    if (!m.ok) return 1;
    if (m.size == 0) {
        *out_data = nullptr;
        *out_len = 0;
        return 0;
    }

    size_t n_threads = pick_threads(m.size);
    std::vector<size_t> bounds = slice_bounds(m.data, m.size, n_threads);
    std::vector<Out> outs(n_threads);
    {
        std::vector<std::thread> pool;
        for (size_t t = 0; t < n_threads; ++t)
            pool.emplace_back([&, t] {
                scan_slice(m.data + bounds[t], m.data + bounds[t + 1],
                           keyset, s1set, outs[t]);
            });
        for (auto& th : pool) th.join();
    }
    munmap(const_cast<char*>(m.data), m.size);

    // concatenate per-slice buffers in file order (decision parity)
    size_t total = 0;
    for (const Out& o : outs) total += o.len;
    char* final_buf = total ? static_cast<char*>(malloc(total)) : nullptr;
    if (total && !final_buf) {
        for (Out& o : outs) free(o.data);
        return 2;
    }
    size_t w = 0;
    for (Out& o : outs) {
        if (o.len) memcpy(final_buf + w, o.data, o.len);
        w += o.len;
        free(o.data);
    }
    *out_data = final_buf;
    *out_len = static_cast<int64_t>(total);
    return 0;
}

void free_buffer(char* p) { free(p); }

}  // extern "C"
