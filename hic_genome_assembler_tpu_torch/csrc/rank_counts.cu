// Rank-membership counts for the part-1 breakpoint scans, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hic_genome_assembler_tpu/ops/pallas_kernels.py:45
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
// whole-matrix counts.  R is int16 (a padded size below 32,767) or int32,
// two instantiations of one template; pad entries are -1.
//
// What bounds it on this card.  A batch's scans read nested prefixes of the
// same rows: a fixed scan (s, c) the first c - s columns of every row, a
// growing scan from s the first i - s of row i.  Read once, a batch needs
// the union of its prefixes (per row, the widest), 2 bytes an element at
// int16: 9.4 GB over the 16K main path's 45 launches, 2.8 ms at the 3.35
// TB/s of an NVIDIA H100 80GB HBM3 at 700 W, where a kernel that reads
// each scan's own prefix streams 284.5 GB (85 ms there).
// Compared once per scan and element, the same union costs the card's
// integer lanes several times its bytes.  So the kernel reads each row once
// for a chunk of scans, and uses the scans' nesting:
//
//   * fixed scans of start s, cuts sorted ascending: an element v = R[i, j]
//     with v >= s counts in exactly the scans whose cut c >= max(j + s + 1, v);
//   * growing scans, starts sorted ascending: an element with v <= i counts
//     in exactly the scans whose start <= min(v, i - j - 1).
//
// The host (ops/count_kernels.py::plan_batch) de-duplicates the batch's
// scans (the pow2 padding repeats its last row), sorts them into those
// groups and cuts them into chunks of at most 1,024 scans: gridDim.y.  A
// scan's position in its chunk is its bin.  One block owns 8 rows (one warp
// each) and one chunk.  A lane streams its share of the row's union prefix
// with vector loads, two in flight (cp.async or TMA would stage into
// shared memory, but every element is used by the one lane that loads it,
// so registers are its stage): 16 bytes for the register counters, 4
// elements (8 or 16 bytes) for the search.  Then, by the chunk's shape:
//
//   * one group of at most 16 scans (the main path's growing batches and its
//     cut-noise batches of one start): each lane keeps one counter a scan in
//     registers and adds, per element, one compare a scan against the
//     element's threshold above (min(v, i - j - 1), or max(j + s + 1, v)):
//     about 8 integer operations an element and 2 a scan, no memory traffic
//     beside the row; the warp sums its lanes' counters with shuffles;
//   * otherwise (many starts, or large groups): per element and group one
//     binary search over the group's keys in shared memory finds the first
//     scan that counts it, and one increment records it in that bin; the
//     searches of 4 consecutive elements of a lane advance side by side, by
//     halving steps of one length, so their shared-memory reads are in
//     flight together (a run none of whose elements lies in a group's
//     prefix and value range skips it); groups are ordered by prefix end, so a
//     run stops at the first group it has passed, and a suffix (growing) or
//     prefix (fixed) sum over each group's bins gives every scan's count.  Up
//     to 32 bins each lane keeps its own histogram (bank = lane, plain
//     increments); above, the warp shares one with shared-memory atomics.
//     The cost is the (element, group) pairs of the union, about 30
//     operations each: the main path's batch of 488 scans over 38 starts has
//     3.3G of them against 163M elements of union.
//
// Every count is an exact integer.  The block writes each scan's count for
// each of the caller's rows k (repeats included), 8 consecutive rows at a
// time.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kThreads = kRowsPerBlock * 32;
constexpr int kPrivateBins = 32;  // per-lane histograms up to this many bins
constexpr int kRegisterScans = 16;  // one group of at most this many: counters in registers
constexpr int kChunkScans = 1024;
constexpr int kChunkHeader = 8;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Calls f(j0, v, n) for the elements of the first e columns of row r, in
// runs of n consecutive elements (n an std::integral_constant: kVec, or 1
// in the tail), j0 the global column of v[0], with vector loads of kVec
// elements (16 or 8 bytes), two in flight a lane, where the row is 16-byte
// aligned (kVec > 1).
template <class T, int kVec, class F>
__device__ __forceinline__ void stream_row(const T* __restrict__ r, int e, int col0, int lane,
                                           F&& f) {
  int tail = 0;
  if (kVec > 1) {
    const int nv = e / kVec;
    using Vec = typename std::conditional<kVec * sizeof(T) == 16, uint4, uint2>::type;
    const Vec* rv = reinterpret_cast<const Vec*>(r);
    auto unpack = [&](const Vec& x, int c) {
      const T* vals = reinterpret_cast<const T*>(&x);
      int v[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) v[q] = vals[q];
      f(col0 + c, v, std::integral_constant<int, kVec>{});
    };
    for (int q = lane; q < nv; q += 64) {
      const Vec a = __ldg(rv + q);
      const bool more = q + 32 < nv;
      Vec b = {};
      if (more) b = __ldg(rv + q + 32);
      unpack(a, q * kVec);
      if (more) unpack(b, (q + 32) * kVec);
    }
    tail = nv * kVec;
  }
  for (int c = tail + lane; c < e; c += 32) {
    const int v = __ldg(r + c);
    f(col0 + c, &v, std::integral_constant<int, 1>{});
  }
}

// The chunk header of this block and its arrays in the plan.
struct Chunk {
  int n_bins, n_groups, has_growing, n_out;
  const int32_t* keys;
  const int32_t* groups;
  const int32_t* outmap;
};

__device__ __forceinline__ Chunk chunk_of(const int32_t* __restrict__ plan) {
  const int32_t* hdr = plan + 1 + kChunkHeader * blockIdx.y;
  return {hdr[0], hdr[1], hdr[2], hdr[6], plan + hdr[3], plan + hdr[4], plan + hdr[5]};
}

// The block's 8 rows' counts, bins[w * row_bins + bin * stride], written to
// out[k, row] for each (k, bin) of the chunk's out map.
__device__ __forceinline__ void write_rows(const Chunk& ch, const int32_t* bins, int row_bins,
                                           int stride, int n_rows, int32_t* __restrict__ out) {
  const int base = blockIdx.x * kRowsPerBlock;
  for (int q = threadIdx.x; q < ch.n_out * kRowsPerBlock; q += kThreads) {
    const int w = q & (kRowsPerBlock - 1), o = q / kRowsPerBlock;
    if (base + w < n_rows)
      out[static_cast<int64_t>(ch.outmap[2 * o]) * n_rows + base + w] =
          bins[w * row_bins + ch.outmap[2 * o + 1] * stride];
  }
}

constexpr bool kAtLeast = true, kAtMost = false;

// cnt[b] += ok && x >= key[b] (kGe) or ok && x <= key[b], for b < kScans:
// one predicated compare (setp, and-ed with the element's predicate) and one
// predicated add a scan, 8 scans an asm statement (its operand limit).
#define RC_STEP(c, k) \
  "setp." RC_CMP ".and.s32 p, %16, %" #k ", ok;\n\t@p add.s32 %" #c ", %" #c ", 1;\n\t"
#define RC_COUNT8                                                                             \
  asm("{\n\t.reg .pred ok, p;\n\tsetp.ne.s32 ok, %17, 0;\n\t" RC_STEP(0, 8) RC_STEP(1, 9)       \
      RC_STEP(2, 10) RC_STEP(3, 11) RC_STEP(4, 12) RC_STEP(5, 13) RC_STEP(6, 14)               \
      RC_STEP(7, 15) "}"                                                                      \
      : "+r"(cnt[b0]), "+r"(cnt[b0 + 1]), "+r"(cnt[b0 + 2]), "+r"(cnt[b0 + 3]),               \
        "+r"(cnt[b0 + 4]), "+r"(cnt[b0 + 5]), "+r"(cnt[b0 + 6]), "+r"(cnt[b0 + 7])            \
      : "r"(key[b0]), "r"(key[b0 + 1]), "r"(key[b0 + 2]), "r"(key[b0 + 3]), "r"(key[b0 + 4]), \
        "r"(key[b0 + 5]), "r"(key[b0 + 6]), "r"(key[b0 + 7]), "r"(x), "r"(okv))

template <int kScans, bool kGe>
__device__ __forceinline__ void count_where(int (&cnt)[kScans], const int (&key)[kScans], int x,
                                            bool ok) {
  const int okv = ok;
#pragma unroll
  for (int b0 = 0; b0 + 8 <= kScans; b0 += 8) {
    if (kGe) {
#define RC_CMP "ge"
      RC_COUNT8;
#undef RC_CMP
    } else {
#define RC_CMP "le"
      RC_COUNT8;
#undef RC_CMP
    }
  }
#pragma unroll
  for (int b = kScans / 8 * 8; b < kScans; ++b) cnt[b] += ok & (kGe ? x >= key[b] : x <= key[b]);
}
#undef RC_COUNT8
#undef RC_STEP

// A chunk of one group of at most kScans scans: one counter a scan in
// registers.  Keys past the group's count never count (a growing start of
// INT_MAX above every min(v, i - j - 1) < i; a fixed cut of INT_MIN below
// every max(j + s + 1, v), which exceeds INT_MIN wherever v >= s).
template <class T, int kVec, int kScans>
__global__ void __launch_bounds__(kThreads)
rank_counts_registers(const T* __restrict__ R, int64_t ld, int n_rows, int n_cols, int row0,
                      int col0, const int32_t* __restrict__ plan, int32_t* __restrict__ out) {
  __shared__ int32_t bins[kRowsPerBlock * kScans];
  const Chunk ch = chunk_of(plan);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  const bool growing = ch.has_growing;
  const int start = ch.groups[0], end = ch.groups[1], n = ch.groups[3];
  if (row < n_rows) {  // uniform across the warp
    const int gi = row0 + row;
    int key[kScans], cnt[kScans];
#pragma unroll
    for (int b = 0; b < kScans; ++b) {
      key[b] = b < n ? ch.keys[b] : (growing ? INT32_MAX : INT32_MIN);
      cnt[b] = 0;
    }
    const int64_t union_end = growing ? static_cast<int64_t>(gi) - key[0] : end;
    const int e = static_cast<int>(clamp64(union_end - col0, 0, n_cols));
    const T* r = R + static_cast<int64_t>(row) * ld;
    if (growing) {
      stream_row<T, kVec>(r, e, col0, lane, [&](int j0, const int* v, auto n) {
#pragma unroll
        for (int q = 0; q < decltype(n)::value; ++q) {
          const int m = min(v[q], gi - j0 - q - 1);
          count_where<kScans, kAtLeast>(cnt, key, m, v[q] <= gi);
        }
      });
    } else {
      stream_row<T, kVec>(r, e, col0, lane, [&](int j0, const int* v, auto n) {
#pragma unroll
        for (int q = 0; q < decltype(n)::value; ++q) {
          // j < end <= max cut - start, so j + start + 1 does not overflow where it counts
          const int j = j0 + q;
          const int t = max(static_cast<int>(static_cast<unsigned>(j) + start + 1u), v[q]);
          count_where<kScans, kAtMost>(cnt, key, t, (j < end) & (v[q] >= start));
        }
      });
    }
#pragma unroll
    for (int b = 0; b < kScans; ++b) {
      int x = cnt[b];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == b) bins[warp * kScans + b] = x;
    }
  }
  __syncthreads();
  write_rows(ch, bins, kScans, 1, n_rows, out);
}

// Any chunk: a binary search a group, a bin an element (see the note above).
template <class T, bool kPrivate, int kVec>
__global__ void __launch_bounds__(kThreads)
rank_counts_search(const T* __restrict__ R, int64_t ld, int n_rows, int n_cols, int row0,
                   int col0, const int32_t* __restrict__ plan, int max_bins, int max_groups,
                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr int kStride = kPrivate ? 32 : 1;  // a bin's entries in a row's histogram
  const Chunk ch = chunk_of(plan);
  const int n_bins = ch.n_bins, n_groups = ch.n_groups, has_growing = ch.has_growing;
  int32_t* keys = smem;                                                   // [max_bins]
  int4* groups = reinterpret_cast<int4*>(smem + ((max_bins + 3) & ~3));   // [max_groups]
  int32_t* hist = reinterpret_cast<int32_t*>(groups + max_groups);        // [8][n_bins][kStride]
  const int row_hist = n_bins * kStride;
  for (int q = threadIdx.x; q < n_bins; q += kThreads) keys[q] = ch.keys[q];
  for (int q = threadIdx.x; q < n_groups; q += kThreads)
    groups[q] = make_int4(ch.groups[4 * q], ch.groups[4 * q + 1], ch.groups[4 * q + 2],
                          ch.groups[4 * q + 3]);
  for (int q = threadIdx.x; q < kRowsPerBlock * row_hist; q += kThreads) hist[q] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  int32_t* h = hist + warp * row_hist;
  if (row < n_rows) {  // uniform across the warp
    const int gi = row0 + row;
    const int g0 = has_growing ? 1 : 0;
    int gbin0 = 0, gn = 0;
    int64_t end = 0;  // the union prefix of this row, in global columns
    if (has_growing) {
      gbin0 = groups[0].z;
      gn = groups[0].w;
      end = static_cast<int64_t>(gi) - keys[gbin0];
    }
    if (n_groups > g0) end = end > groups[g0].y ? end : groups[g0].y;
    const int e = static_cast<int>(clamp64(end - col0, 0, n_cols));

    auto bump = [&](int b) {
      if (kPrivate)
        h[b * 32 + lane] += 1;
      else
        atomicAdd(h + b, 1);
    };
    stream_row<T, kVec>(R + static_cast<int64_t>(row) * ld, e, col0, lane,
                        [&](int j0, const int* v, auto run) {
      constexpr int kN = decltype(run)::value;
      constexpr int kSide = kN < 4 ? kN : 4;
#pragma unroll
      for (int q = 0; q < kN; ++q) {  // growing scans: one search an element
        if (gn > 0 && v[q] <= gi) {
          const int m = min(v[q], gi - j0 - q - 1);
          const int32_t* gk = keys + gbin0;
          int lo = 0, len = gn;  // lo: scans with start <= m
          while (len > 0) {
            const int half = len >> 1;
            if (gk[lo + half] <= m) {
              lo += half + 1;
              len -= half + 1;
            } else {
              len = half;
            }
          }
          if (lo > 0) bump(gbin0 + lo - 1);
        }
      }
      // fixed groups: the searches of up to 4 elements side by side
#pragma unroll
      for (int h = 0; h < kN; h += kSide) {
        const int jh = j0 + h;
        const int* vh = v + h;
        for (int g = g0; g < n_groups; ++g) {
          const int4 grp = groups[g];  // (start, end, bin0, n)
          if (jh >= grp.y) break;     // past this prefix, and every later one
          bool ok[kSide], any = false;
#pragma unroll
          for (int q = 0; q < kSide; ++q) {
            ok[q] = (jh + q < grp.y) & (vh[q] >= grp.x);
            any |= ok[q];
          }
          if (!any) continue;  // no element of the run in this group: no search
          const int32_t* ck = keys + grp.z;
          int t[kSide], pos[kSide];
#pragma unroll
          for (int q = 0; q < kSide; ++q) {
            // j < end <= max cut - start: no overflow where it counts
            t[q] = max(static_cast<int>(static_cast<unsigned>(jh + q) + grp.x + 1u), vh[q]);
            pos[q] = 0;
          }
          // pos = the scans with cut < t, by halving steps of one length for all
          for (int step = 1 << (31 - __clz(grp.w)); step > 0; step >>= 1) {
#pragma unroll
            for (int q = 0; q < kSide; ++q) {
              const int next = pos[q] + step;
              if (next <= grp.w && ck[next - 1] < t[q]) pos[q] = next;
            }
          }
#pragma unroll
          for (int q = 0; q < kSide; ++q)
            if (ok[q] && pos[q] < grp.w) bump(grp.z + pos[q]);
        }
      }
    });

    __syncwarp();
    if (kPrivate) {  // each lane folds the 32 lanes' counts of its bins into entry 0
      for (int b = lane; b < n_bins; b += 32) {
        int sum = 0;
        for (int x = 0; x < 32; ++x) sum += h[b * 32 + ((lane + x) & 31)];
        h[b * 32] = sum;
      }
      __syncwarp();
    }
    for (int g = lane; g < n_groups; g += 32) {  // each group's counts from its bins
      const int4 grp = groups[g];
      const bool suffix = has_growing && g == 0;
      int run = 0;
      for (int q = 0; q < grp.w; ++q) {
        int32_t* bin = h + (grp.z + (suffix ? grp.w - 1 - q : q)) * kStride;
        run += *bin;
        *bin = run;
      }
    }
  }
  __syncthreads();
  write_rows(ch, hist, row_hist, kStride, n_rows, out);
}

struct Launch {
  const void* R;
  int64_t ld;
  int n_rows, n_cols, row0, col0;
  const int32_t* plan;
  int n_chunks, max_bins, max_groups;
  int32_t* out;
  cudaStream_t stream;
  dim3 grid() const { return dim3((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, n_chunks); }
};

template <class T, int kVec, int kScans>
cudaError_t launch_registers(const Launch& a) {
  rank_counts_registers<T, kVec, kScans><<<a.grid(), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.R), a.ld, a.n_rows, a.n_cols, a.row0, a.col0, a.plan, a.out);
  return cudaGetLastError();
}

template <class T, bool kPrivate, int kVec>
cudaError_t launch_search(const Launch& a) {
  const size_t smem = sizeof(int32_t) * (((a.max_bins + 3) & ~3) + 4 * a.max_groups +
                                         kRowsPerBlock * a.max_bins * (kPrivate ? 32 : 1));
  auto kernel = &rank_counts_search<T, kPrivate, kVec>;
  if (smem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.grid(), kThreads, smem, a.stream>>>(static_cast<const T*>(a.R), a.ld, a.n_rows,
                                                a.n_cols, a.row0, a.col0, a.plan, a.max_bins,
                                                a.max_groups, a.out);
  return cudaGetLastError();
}

template <class T, int kVec>
cudaError_t dispatch_shape(const Launch& a) {
  // one group in every chunk, of at most kRegisterScans scans (then one chunk)
  if (a.max_groups == 1 && a.max_bins <= kRegisterScans) {
    if (a.max_bins <= 1) return launch_registers<T, kVec, 1>(a);
    if (a.max_bins <= 4) return launch_registers<T, kVec, 4>(a);
    if (a.max_bins <= 8) return launch_registers<T, kVec, 8>(a);
    return launch_registers<T, kVec, kRegisterScans>(a);
  }
  // the search takes runs of at most 4 elements (int16 in 8-byte loads):
  // with 8-element runs it took 4.96 ms against 3.52 on the main path's
  // 488-scan batch (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
  constexpr int kSearchVec = kVec > 4 ? 4 : kVec;
  if (a.max_bins <= kPrivateBins) return launch_search<T, true, kSearchVec>(a);
  return launch_search<T, false, kSearchVec>(a);
}

template <class T>
cudaError_t dispatch(const Launch& a) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a.R) % 16 == 0 &&
                       (a.ld * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  return aligned ? dispatch_shape<T, kVec>(a) : dispatch_shape<T, 1>(a);
}

}  // namespace

// R: int16 (elem_bytes 2) or int32 (4) rows with row stride ld (elements)
// and unit column stride, the block of a matrix whose top-left element is
// the global (row0, col0); plan: int32, ops/count_kernels.py::plan_batch's
// layout, n_chunks chunks of at most max_bins scans and max_groups groups;
// out: int32[K, n_rows].  All pointers on the device.  Launches on `stream`
// and returns the launch status; does not synchronise.
extern "C" int rank_counts(const void* R, int elem_bytes, int64_t ld, int n_rows, int n_cols,
                           int row0, int col0, const int32_t* plan, int n_chunks, int max_bins,
                           int max_groups, int32_t* out, cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (n_chunks < 1 || n_chunks > 65535 || max_bins < 1 || max_bins > kChunkScans ||
      max_groups < 1 || max_groups > max_bins || n_cols < 0 || ld < n_cols || row0 < 0 ||
      col0 < 0 || static_cast<int64_t>(row0) + n_rows > INT32_MAX ||
      static_cast<int64_t>(col0) + n_cols > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{R, ld, n_rows, n_cols, row0, col0, plan, n_chunks, max_bins, max_groups, out,
                 stream};
  cudaError_t err = cudaErrorInvalidValue;
  if (elem_bytes == 2) err = dispatch<int16_t>(a);
  if (elem_bytes == 4) err = dispatch<int32_t>(a);
  return static_cast<int>(err);
}
