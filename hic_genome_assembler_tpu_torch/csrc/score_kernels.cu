// Part 2's scoring kernels, for Hopper (sm_90a): pair profiles, combo top-k,
// block scores and pair scores.
//
// Replace the device functions of hic_genome_assembler_tpu/ops/cost.py, each
// a jitted XLA program on the TPU (no Pallas kernel):
//
//   pair_profiles     _skew_profile_chunk (:82-151), _build_pair_profiles (:158-188)
//   combo_score_topk  _combo_score_kernel / _combo_score_topk_kernel (:382-399)
//                     with the group epilogue _group_argmax (:251-270)
//   group_topk        _group_argmax alone, on scores in device memory
//   topk_fold         the fold of a mesh's blocks' partial group triples
//                     (the mesh paths' _group_argmax, with combo_score_topk
//                     and block_score in their partials form)
//   block_score       _block_score_kernel / _block_score_topk_kernel (:203-248)
//   pair_score        _pair_score_kernel (:402-417)
//
// Shared conventions.  F is the float32 table F[row, delta] of one scaffold
// subset, flat, with rows (s*Sp + t)*4 + e and C + 1 columns; an index into it
// is int64, as ((s_i*Sp + s_j)*4 + e)*(C+1) + delta passes 2^31 on
// chromosomes of a few hundred scaffolds.  Offsets and deltas are int32.
// Floating-point sums never use atomics: each is made by one thread in a
// fixed order, or by a fixed shuffle tree, so every launch on the same inputs
// gives the same bits.  A result whose inputs break the layout (an id outside
// [0, Sp), an orientation other than 0 or 1, sizes that overrun the table or
// the matrix) is NaN.  Every entry point launches on `stream`, does not
// synchronise, allocates nothing and returns cudaGetLastError().
//
// Every kernel here is designed for the card (the notes below); none uses
// TMA or the tensor cores.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// Dynamic shared memory past the default 48 KB, less what a kernel's static
// arrays take (at most 4 KB here), needs the opt-in.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmemDefault - 4096)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// pair_profiles
//
// h[(s*Sp + t)*4 + e, m] for s != t: the sums of the c_s x c_t block
// B[a, b] = M[offs_s + a, offs_t + b] along the lines of one orientation's
// offset, shift = cmax - 1:
//
//   e = 0 (+,+): m = (b - a) + shift
//   e = 1 (+,-): m = (c_t - 1 - (a + b)) + shift
//   e = 2 (-,+): m = (a + b) - c_s + 1 + shift
//   e = 3 (-,-): m = (c_t - c_s) - (b - a) + shift
//
// so each row is a shifted or reversed copy of the block's anti-diagonal sums
// Dsum[u] (u = a + b) or diagonal sums Ddiff[d] (d = b - a + c_s - 1); rows
// of s = t and of pad slots (size 0) are zero.
//
// What bounds it on this card: memory.  The output, 4*Sp^2*L floats (38.5 MB
// at Sp = 56, cmax = 384), is written once and outweighs the C x C matrix
// read once; the adds, two per matrix element, take far less at the f32 rate.
// The XLA program materialises a padded [k, Sp, cmax, cmax] block view G (up
// to 256 MB a chunk), skews it twice and gathers the four rows from it.
//
// The design.  A block of 512 threads owns up to `pairs` pairs of one wrapped
// diagonal, (s, (s + k) mod Sp) for s in [s0, s0 + pairs) (at most 8, as
// many as 48 KB of sums hold: 8 at cmax 384, 4 at cmax 704): grid (chunks
// of s, k).  A block so holds at most one pair of any row s and one of any
// column t, and the pairs of a chromosome's largest scaffold, the most work,
// spread over 2 Sp - 1 blocks instead of crowding a few.
//  1. Offsets: one block-wide scan of the sizes (int64, warp shuffles), up
//     to the largest id that the block's pairs name; the thread of each such
//     id keeps its exclusive prefix.  No thread sums a prefix alone.
//  2. Sums: the diagonals of the block's pairs (nd = c_s + c_t - 1 each; none
//     for a zero or NaN pair) form one list, and thread j takes items j,
//     j + 512, ...: item d of a pair is its anti-diagonal u = d and its
//     diagonal d, each summed by that thread alone over rows a in ascending
//     order into the pair's slot of shared memory.  A warp's 32 consecutive
//     items walk the rows together, so the lanes of one pair read
//     neighbouring columns of one row (coalesced), each adding only the rows
//     of its own line.  A large pair's diagonals spread over all 512 threads,
//     and small pairs share a block.  Each sum is one thread's, in a fixed
//     order: no atomics and no fold.
//  3. Stores: each pair's 4L floats (16-byte aligned: 4L*4 bytes is a
//     multiple of 16) as L float4 stores, thread v storing floats 4v..4v+3 of
//     the block's pairs in turn, each float's (e, m) found by compares, with
//     no division.  The zeros outside a pair's diagonals and the rows of
//     s = t, pad slots and NaN pairs are written in the same pass.
// Shared memory holds 2L floats a pair (its sums) and nothing a row.  One
// launch a chromosome.
// ---------------------------------------------------------------------------

constexpr int kProfileThreads = 512;
constexpr int kProfileMaxPairs = 8;

enum ProfileState { kSums = 0, kZero = 1, kNan = 2 };

struct ProfilePair {
  int64_t offs_s, offs_t;
  int64_t raw_s, raw_t;  // the sizes as read, before the layout check
  int s, t, cs, ct, nd, item0, state;
};

__global__ void __launch_bounds__(kProfileThreads)
pair_profiles_kernel(const float* __restrict__ M, int C, const int64_t* __restrict__ sizes,
                     int Sp, int cmax, int pairs_per_block, float* __restrict__ h) {
  __shared__ ProfilePair pairs[kProfileMaxPairs];
  __shared__ int64_t warp_total[kProfileThreads / 32];
  __shared__ int n_items;
  float* sums = reinterpret_cast<float*>(dyn_smem);  // [pairs][Dsum: L | Ddiff: L]
  const int L = 2 * cmax - 1, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * pairs_per_block, k = blockIdx.y;
  const int P = min(pairs_per_block, Sp - s0);
  if (tid < P) {
    ProfilePair& p = pairs[tid];
    p.s = s0 + tid;
    p.t = (p.s + k) % Sp;
    p.raw_s = sizes[p.s];
    p.raw_t = sizes[p.t];
  }
  __syncthreads();

  // 1. the exclusive prefix of the sizes at every id the block's pairs name
  int last = 0;
  for (int i = 0; i < P; ++i) last = max(last, max(pairs[i].s, pairs[i].t));
  int64_t carry = 0;
  for (int base = 0; base <= last; base += kProfileThreads) {
    const int j = base + tid;
    const int64_t v = j <= last ? sizes[j] : 0;
    int64_t incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t u = __shfl_up_sync(kFull, static_cast<long long>(incl), o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int64_t before = carry;
    for (int w = 0; w < kProfileThreads / 32; ++w) {
      if (w < warp) before += warp_total[w];
      carry += warp_total[w];
    }
    if (j <= last) {
      const int64_t excl = before + incl - v;
      for (int i = 0; i < P; ++i) {  // one thread owns id j
        if (pairs[i].s == j) pairs[i].offs_s = excl;
        if (pairs[i].t == j) pairs[i].offs_t = excl;
      }
    }
    __syncthreads();  // warp_total is rewritten by the next chunk
  }

  // each pair's state and diagonals, and its first item (a scan in warp 0)
  if (warp == 0) {
    int nd = 0;
    if (lane < P) {
      ProfilePair& p = pairs[lane];
      const int64_t cs = p.raw_s, ct = p.raw_t;
      const bool bad = cs < 0 || ct < 0 || cs > cmax || ct > cmax || p.offs_s + cs > C ||
                       p.offs_t + ct > C;
      p.state = bad ? kNan : (p.s == p.t || cs == 0 || ct == 0) ? kZero : kSums;
      p.cs = p.state == kSums ? static_cast<int>(cs) : 0;
      p.ct = p.state == kSums ? static_cast<int>(ct) : 0;
      nd = p.state == kSums ? p.cs + p.ct - 1 : 0;
      p.nd = nd;
    }
    int incl = nd;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane < P) pairs[lane].item0 = incl - nd;
    if (lane == 31) n_items = incl;
  }
  __syncthreads();

  // 2. the sums: item it = tid + 512 j; the warp's lanes walk rows A0..A1
  // together, each adding the rows of its own line
  int i = 0;
  for (int base = warp * 32; base < n_items; base += kProfileThreads) {
    const int it = base + lane;
    const bool live = it < n_items;
    int d = 0, cs = 1, ct = 1;
    const float* blk = M;
    if (live) {
      while (it >= pairs[i].item0 + pairs[i].nd) ++i;
      const ProfilePair& p = pairs[i];
      d = it - p.item0;
      cs = p.cs;
      ct = p.ct;
      blk = M + p.offs_s * C + p.offs_t;
    }
    float su = 0.0f;  // anti-diagonal u = d: b = d - a
    {
      const int a0 = live ? max(0, d - ct + 1) : INT32_MAX, a1 = live ? min(cs - 1, d) : -1;
      const int A0 = __reduce_min_sync(kFull, a0), A1 = __reduce_max_sync(kFull, a1);
      const float* x = blk + static_cast<int64_t>(A0) * C + (d - A0);
#pragma unroll 4
      for (int a = A0; a <= A1; ++a, x += C - 1)
        if (a >= a0 && a <= a1) su += __ldg(x);
    }
    float sd = 0.0f;  // diagonal d: b = a + d - cs + 1
    {
      const int off = d - cs + 1;
      const int a0 = live ? max(0, -off) : INT32_MAX;
      const int a1 = live ? min(cs - 1, ct - 1 - off) : -1;
      const int A0 = __reduce_min_sync(kFull, a0), A1 = __reduce_max_sync(kFull, a1);
      const float* x = blk + static_cast<int64_t>(A0) * C + (A0 + off);
#pragma unroll 4
      for (int a = A0; a <= A1; ++a, x += C + 1)
        if (a >= a0 && a <= a1) sd += __ldg(x);
    }
    if (live) {
      sums[2 * L * i + d] = su;
      sums[2 * L * i + L + d] = sd;
    }
  }
  __syncthreads();

  // 3. each pair's span, one float4 a thread and step
  const int shift = cmax - 1;
  int j = tid / L, v = tid - j * L;  // the pair and float4 of the thread's first store
  for (int f4 = tid; f4 < P * L; f4 += kProfileThreads) {
    const ProfilePair& p = pairs[j];
    const int state = p.state, cs = p.cs, ct = p.ct, nd = p.nd;
    const float* dsum = sums + 2 * L * j;
    float f[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * v + q;  // float r of the pair's 4L: e = r / L, m = r % L
      const int e = (r >= L) + (r >= 2 * L) + (r >= 3 * L);
      const int m = r - e * L;
      // e = 0 -> Ddiff[m - shift + cs - 1], 1 -> Dsum[ct - 1 + shift - m],
      // e = 2 -> Dsum[m + cs - 1 - shift],  3 -> Ddiff[ct - 1 + shift - m]
      const int x = (e == 0 || e == 2) ? m + cs - 1 - shift : ct - 1 + shift - m;
      f[q] = state == kNan ? NAN
             : (x >= 0 && x < nd) ? dsum[(e == 0 || e == 3) ? L + x : x] : 0.0f;
    }
    float4* out = reinterpret_cast<float4*>(h + (static_cast<int64_t>(p.s) * Sp + p.t) * 4 * L);
    out[v] = make_float4(f[0], f[1], f[2], f[3]);
    v += kProfileThreads;
    while (v >= L) {
      v -= L;
      ++j;
    }
  }
}

// ---------------------------------------------------------------------------
// Group top-k: for k groups of G = ceil(N / k) consecutive candidates (the
// last padded with -inf), each group's max, its argmax (the lowest index
// among ties) and the max over the group without the argmax's position.
//
// A (max, argmax, second) triple merges exactly: the winner of two triples is
// the better of their maxima, and the union's second is the larger of the
// winner's second and the loser's max.  The merge is commutative and
// associative, so any tree of merges gives the bits of torch's argmax and
// masked max.  A block reduces one tile of candidates of a group (lanes, then
// shuffles, then the block's warps); a group of one tile writes its result, a
// longer group writes one partial per tile and topk_merge folds them, one
// warp a group.  group_topk reads its scores from device memory (topk_tiles);
// combo_score_topk and block_score score their candidates themselves.
//
// On a mesh (the partials form).  A batch of N_glob candidates is split over
// D data-axis blocks, block i holding [n0, n0 + N) on its own card, and the
// k groups are the whole batch's (G = ceil(N_glob / k)), so a group may
// start in one block and end in the next.  Each block's launch clips its
// tiles to the block's span and writes the triple of every group over the
// candidates it holds, the empty triple (-inf, -inf, INT64_MAX) for a group
// it does not touch; the last block also holds the -inf padding past
// N_glob.  The D blocks' [k] triples, on one card as [D, k], go through
// topk_fold: one warp a group, the body of topk_merge with D tiles.  Only
// 16 bytes a group and block cross cards, where the XLA program (and the
// port before it) wrote every score, gathered them all onto one card and
// read them again.  With n0 = 0 and N_glob = N the partials are the final
// result: the one-device form is the same launch.  What bounds topk_fold on
// this card: its launch; it reads 16 D bytes a group and writes 16.
// ---------------------------------------------------------------------------

template <class I>
struct Top2T {
  float v1;  // the max
  float v2;  // the max without the argmax's position
  I i1;      // the argmax
};
using Top2 = Top2T<int64_t>;   // a candidate's index
using Top2L = Top2T<int32_t>;  // a candidate's offset from its block's first

__device__ __forceinline__ Top2 top2_empty() { return {-INFINITY, -INFINITY, INT64_MAX}; }
__device__ __forceinline__ Top2L top2l_empty() { return {-INFINITY, -INFINITY, INT32_MAX}; }

template <class I>
__device__ __forceinline__ Top2T<I> merge(const Top2T<I>& a, const Top2T<I>& b) {
  const bool a_wins = a.v1 > b.v1 || (a.v1 == b.v1 && a.i1 < b.i1);
  const Top2T<I>& w = a_wins ? a : b;
  const Top2T<I>& l = a_wins ? b : a;
  return {w.v1, fmaxf(w.v2, l.v1), w.i1};
}

// merge(x, {v, -inf, i}) where x is empty or i is above x.i1: the
// candidate wins an empty x, else unless v <= x.v1 (NaN wins, as in merge).
__device__ __forceinline__ Top2L push(const Top2L& x, float v, int32_t i) {
  const bool wins = !(v <= x.v1) || x.i1 == INT32_MAX;
  return {wins ? v : x.v1, wins ? fmaxf(-INFINITY, x.v1) : fmaxf(x.v2, v), wins ? i : x.i1};
}

__device__ __forceinline__ int32_t shfl_xor(int32_t v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}
__device__ __forceinline__ int64_t shfl_xor(int64_t v, int o) {
  return __shfl_xor_sync(kFull, static_cast<long long>(v), o);
}

template <class I>
__device__ __forceinline__ Top2T<I> warp_merge(Top2T<I> x) {
  for (int o = 16; o > 0; o >>= 1) {
    Top2T<I> y;
    y.v1 = __shfl_xor_sync(kFull, x.v1, o);
    y.v2 = __shfl_xor_sync(kFull, x.v2, o);
    y.i1 = shfl_xor(x.i1, o);
    x = merge(x, y);
  }
  return x;
}

// The block's merged triple, in thread 0; every thread of the block calls it.
template <class I>
__device__ Top2T<I> block_merge(Top2T<I> x, const Top2T<I>& empty) {
  __shared__ Top2T<I> warps[kThreads / 32];
  x = warp_merge(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < static_cast<int>(blockDim.x >> 5) ? warps[lane] : empty;
    x = warp_merge(x);
  }
  return x;
}

// One tile of a group of the scores x: grid (tiles, k).  With one tile a
// group the result goes straight to (vals, idx, second); otherwise to
// parts[g * tiles + t].
__global__ void __launch_bounds__(kThreads)
topk_tiles(const float* __restrict__ x, int64_t N, int64_t G, int64_t tile,
           Top2* __restrict__ parts, float* __restrict__ vals, int64_t* __restrict__ idx,
           float* __restrict__ second) {
  const int64_t g = blockIdx.y, t = blockIdx.x;
  const int64_t start = g * G + t * tile;
  const int64_t end = min64(start + tile, (g + 1) * G);
  Top2 m = top2_empty();
  for (int64_t n = start + threadIdx.x; n < end; n += blockDim.x)
    m = merge(m, {n < N ? x[n] : -INFINITY, -INFINITY, n});
  m = block_merge(m, top2_empty());
  if (threadIdx.x != 0) return;
  if (gridDim.x == 1) {
    vals[g] = m.v1;
    idx[g] = m.i1;
    second[g] = m.v2;
  } else {
    parts[g * gridDim.x + t] = m;
  }
}

// One warp folds group g's n triples, part(t) for t < n, into (vals, idx,
// second)[g]: lane l merges triples l, l + 32, ..., then the warp's butterfly.
template <class Part>
__device__ __forceinline__ void fold_group(int n, Part part, int64_t g, float* __restrict__ vals,
                                           int64_t* __restrict__ idx,
                                           float* __restrict__ second) {
  Top2 x = top2_empty();
  for (int t = threadIdx.x; t < n; t += 32) x = merge(x, part(t));
  x = warp_merge(x);
  if (threadIdx.x == 0) {
    vals[g] = x.v1;
    idx[g] = x.i1;
    second[g] = x.v2;
  }
}

// One warp a group folds the tile partials of group g0 + blockIdx.x.
__global__ void topk_merge(const Top2* __restrict__ parts, int tiles, int g0,
                           float* __restrict__ vals, int64_t* __restrict__ idx,
                           float* __restrict__ second) {
  const int64_t b = blockIdx.x;
  fold_group(tiles, [&](int t) { return parts[b * tiles + t]; }, g0 + b, vals, idx, second);
}

// One warp a group folds the D mesh blocks' triples of the group, read from
// the [D, k] arrays (block t's triple of group g at t * k + g).
__global__ void topk_fold_kernel(const float* __restrict__ in_vals,
                                 const int64_t* __restrict__ in_idx,
                                 const float* __restrict__ in_second, int D, int k,
                                 float* __restrict__ vals, int64_t* __restrict__ idx,
                                 float* __restrict__ second) {
  const int64_t g = blockIdx.x;
  fold_group(
      D,
      [&](int t) {
        const int64_t at = static_cast<int64_t>(t) * k + g;
        return Top2{in_vals[at], in_second[at], in_idx[at]};
      },
      g, vals, idx, second);
}

// How a scoring launch divides its N candidates among thread blocks
// (score_grid).  k = 0: block x holds [x * tile, (x + 1) * tile) of [0, N).
// k > 0: the launch holds [n0, n0 + N) of a batch in k groups of G; its span
// [n0, span_hi) ends at n0 + N, or, for the launch that ends the batch, at
// the end of the last group's -inf padding, k * G; it touches groups [g0,
// g0 + ng), and block (x, y) holds tile x of group g0 + y clipped to the
// span: [max(g * G, n0) + x * tile, ...), at most tile candidates.
struct ScoreGrid {
  int64_t tile, n0, G, span_hi;
  int k, g0, ng;
  int64_t tiles;  // blocks a group (gridDim.x)
};

// The range of block (blockIdx.x, blockIdx.y) in the launch's own
// candidates [0, N) (global less n0); [real_hi, hi) is the last group's
// -inf padding, and lo >= hi a tile past the group's part in the span.
template <bool kTopk>
__device__ __forceinline__ void block_range(int64_t N, const ScoreGrid& grid, int64_t* lo,
                                            int64_t* hi, int64_t* real_hi) {
  if (kTopk) {
    const int64_t g = grid.g0 + blockIdx.y;
    const int64_t glo = max64(g * grid.G, grid.n0) + blockIdx.x * grid.tile;
    *lo = glo - grid.n0;
    *hi = min64(min64(glo + grid.tile, (g + 1) * grid.G), grid.span_hi) - grid.n0;
  } else {
    *lo = static_cast<int64_t>(blockIdx.x) * grid.tile;
    *hi = min64(*lo + grid.tile, N);
  }
  *real_hi = min64(*hi, N);
}

// A top-k block's result: its triple with the global index (lo is the
// range's first candidate in the launch), into (vals, idx, second)[g] or,
// where a group spans blocks, its tile partial for topk_merge.  Block (0, 0)
// also writes the empty triple of every group the launch does not touch.
__device__ __forceinline__ void store_topk(Top2L x, const ScoreGrid& grid, int64_t lo,
                                           Top2* parts, float* vals, int64_t* idx,
                                           float* second) {
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int g = threadIdx.x; g < grid.k; g += blockDim.x) {
      if (g >= grid.g0 && g < grid.g0 + grid.ng) continue;
      vals[g] = -INFINITY;
      idx[g] = INT64_MAX;
      second[g] = -INFINITY;
    }
  }
  if (threadIdx.x != 0) return;
  const int64_t g = grid.g0 + blockIdx.y;
  const Top2 w = x.i1 == INT32_MAX ? top2_empty() : Top2{x.v1, x.v2, grid.n0 + lo + x.i1};
  if (gridDim.x == 1) {
    vals[g] = w.v1;
    idx[g] = w.i1;
    second[g] = w.v2;
  } else {
    parts[static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x] = w;
  }
}

// ---------------------------------------------------------------------------
// combo_score_topk
//
// Scores of the combo factorization, candidate n = b*R + r:
// cost(b, r) = sum_p V4[cid[b, p], e(r, p)] + c0 with V4[c, e] = F[idx4[c, e]]
// and e(r, p) = 2*orients[r, i] + orients[r, j] for the p-th position pair
// i < j; NaN where a cid leaves [0, n_combo), an idx4 value leaves F, or a
// flag is not 0 or 1.  k > 0: the group top-k of the scores; k = 0: every
// score.
//
// What bounds it on this card: the adds, P a candidate (5.16M candidates x
// 28 terms at S = 8), against a few MB of cid read once; in practice the P
// shared-memory reads a candidate.  The XLA program writes vals = V4[cid]
// [Bo, P, 4] to device memory and folds it with a one-hot [P, 4, R] selector
// in a matrix product.
//
// The design.  A block of 8 warps owns a range of `tile` candidates inside one
// group, [g*G + t*tile, min(g*G + (t+1)*tile, (g+1)*G)) (k = 0: any range);
// G need not be a multiple of R, so a range may start and end inside an
// order.  The block builds each orientation row's bit mask once (bit 31 marks
// a flag other than 0 or 1), in chunks of kComboMaskChunk rows.  A warp takes
// whole orders b of the range: it reads the order's P cid once and gathers
// its 4P values F[idx4[cid[b, p], e]] once, into its slice of shared memory
// (the gather is part of the kernel), then its lanes score orientations r =
// lane + 32i of the range.  For a term p the address 4p + e(r, p) takes at
// most 4 values across the warp, all in one 16-byte word: a broadcast.  No
// division a candidate.  Each sum adds p ascending, then c0, as the first
// kernel did, so the scores keep its bits.  They go straight into each lane's
// (max, argmax, second), whose argmax is an int32 offset from the range's
// first candidate, merged over the block and widened to int64 at the end; a
// group of several blocks is folded by topk_merge, a second launch.  The -inf
// padding past N is merged as its first index alone, which gives the same
// triple as every padding candidate.  On a mesh (the partials form, see the
// group top-k note) the launch holds candidates [n0, n0 + N) of the whole
// batch's N_glob: its tiles are clipped to that span, its indices are
// global, and it launches only the groups it touches (ScoreGrid).
// ---------------------------------------------------------------------------

constexpr int kComboWarps = kThreads / 32;
constexpr int kComboMaskChunk = 2048;  // orientation masks a block holds at once

// sum_p values[4p + e(r, p)] of one orientation row's mask m, p ascending.
template <int kS>
__device__ __forceinline__ float combo_sum(const float* values, uint32_t m, int S) {
  float acc = 0.0f;
  int p = 0;
  if (kS > 0) {
#pragma unroll
    for (int i = 0; i < kS - 1; ++i) {
      const int hi = ((m >> i) & 1) * 2;
#pragma unroll
      for (int j = i + 1; j < kS; ++j, ++p) acc += values[4 * p + hi + ((m >> j) & 1)];
    }
  } else {
    for (int i = 0; i < S - 1; ++i) {
      const int hi = ((m >> i) & 1) * 2;
      for (int j = i + 1; j < S; ++j, ++p) acc += values[4 * p + hi + ((m >> j) & 1)];
    }
  }
  return acc;
}

// Masks of orientation rows [r0, r1), by the whole block: bit q is row r's
// flag q, bit 31 marks a flag other than 0 or 1.
__device__ __forceinline__ void build_masks(const int32_t* __restrict__ orients, int S, int r0,
                                            int r1, uint32_t* masks) {
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    uint32_t m = 0;
    for (int q = 0; q < S; ++q) {
      const int32_t f = orients[static_cast<int64_t>(r) * S + q];
      m |= (f & ~1) ? 0x80000000u : static_cast<uint32_t>(f) << q;
    }
    masks[r - r0] = m;
  }
}

template <int kS, bool kTopk>
__global__ void __launch_bounds__(kThreads)
combo_kernel(const float* __restrict__ F, int64_t f_numel, const int64_t* __restrict__ idx4,
             int n_combo, const int32_t* __restrict__ cid, int64_t N,
             const int32_t* __restrict__ orients, int R, int S, const float* __restrict__ c0,
             const ScoreGrid grid, Top2* __restrict__ parts, float* __restrict__ costs,
             float* __restrict__ vals, int64_t* __restrict__ idx, float* __restrict__ second) {
  const int P = S * (S - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* masks = reinterpret_cast<uint32_t*>(dyn_smem);  // [min(R, kComboMaskChunk)]
  float* values = reinterpret_cast<float*>(masks + min(R, kComboMaskChunk)) + warp * 4 * P;
  int64_t lo, hi, real_hi;
  block_range<kTopk>(N, grid, &lo, &hi, &real_hi);
  const float c0v = *c0;
  Top2L x = top2l_empty();
  // a tile past its group's part of the span builds no masks: the whole
  // block skips the loop
  for (int r0 = 0; lo < hi && r0 < R; r0 += kComboMaskChunk) {
    const int r1 = min(R, r0 + kComboMaskChunk);
    __syncthreads();  // the previous chunk's masks have been read
    build_masks(orients, S, r0, r1, masks);
    __syncthreads();
    if (lo >= real_hi) continue;
    for (int64_t b = lo / R + warp, b_last = (real_hi - 1) / R; b <= b_last; b += kComboWarps) {
      const int64_t nb = b * R;
      const int rl = static_cast<int>(max64(r0, lo - nb));
      const int rh = static_cast<int>(min64(r1, real_hi - nb));
      if (rl >= rh) continue;  // the order has no candidate of this chunk in the range
      const int32_t* row = cid + b * P;
      for (int q = lane; q < 4 * P; q += 32) {
        const unsigned c = static_cast<unsigned>(row[q >> 2]);
        float v = NAN;
        if (c < static_cast<unsigned>(n_combo)) {
          const int64_t i = idx4[4 * static_cast<int64_t>(c) + (q & 3)];
          if (i >= 0 && i < f_numel) v = F[i];
        }
        values[q] = v;
      }
      __syncwarp();
      for (int r = r0 + lane; r < rh; r += 32) {
        if (r < rl) continue;
        const uint32_t m = masks[r - r0];
        const float score = (m >> 31) ? NAN : combo_sum<kS>(values, m, S) + c0v;
        if (kTopk)
          x = merge(x, Top2L{score, -INFINITY, static_cast<int32_t>(nb + r - lo)});
        else
          costs[nb + r] = score;
      }
      __syncwarp();  // the values are read before the next order's gather
    }
  }
  if (!kTopk) return;
  if (threadIdx.x == 0 && lo < hi && real_hi < hi)
    x = merge(x, Top2L{-INFINITY, -INFINITY, static_cast<int32_t>(max64(lo, N) - lo)});
  x = block_merge(x, top2l_empty());
  store_topk(x, grid, lo, parts, vals, idx, second);
}

// The ScoreGrid of a launch of N candidates, `tile` a block: k = 0, tiles
// of [0, N) (n0 = 0, N_glob = N); k > 0, the candidates [n0, n0 + N) of a
// batch of N_glob in k groups, ceil(min(G, span) / tile) tiles a group.
cudaError_t score_grid(int64_t N, int k, int64_t n0, int64_t N_glob, int64_t tile,
                       ScoreGrid* grid) {
  if (k == 0 ? (n0 != 0 || N_glob != N) : (n0 < 0 || N_glob < 1 || n0 + N > N_glob))
    return cudaErrorInvalidValue;
  ScoreGrid& gr = *grid;
  gr.tile = tile;
  gr.n0 = n0;
  gr.k = k;
  if (k == 0) {
    gr.G = gr.span_hi = N;
    gr.g0 = 0;
    gr.ng = 1;
    gr.tiles = (N + tile - 1) / tile;
  } else {
    gr.G = (N_glob + k - 1) / k;
    gr.span_hi = n0 + N < N_glob ? n0 + N : static_cast<int64_t>(k) * gr.G;
    gr.g0 = static_cast<int>(n0 / gr.G);
    gr.ng = static_cast<int>((gr.span_hi - 1) / gr.G + 1 - gr.g0);
    gr.tiles = (std::min(gr.G, gr.span_hi - n0) + tile - 1) / tile;
  }
  return gr.tiles > INT32_MAX ? cudaErrorInvalidValue : cudaSuccess;
}

template <int kS>
cudaError_t launch_combo(const float* F, int64_t f_numel, const int64_t* idx4, int n_combo,
                         const int32_t* cid, int64_t Bo, const int32_t* orients, int R, int S,
                         const float* c0, int k, int64_t n0, int64_t N_glob, int64_t tile,
                         Top2* parts, float* costs, float* vals, int64_t* idx, float* second,
                         cudaStream_t stream) {
  const int64_t N = Bo * R;
  const size_t smem = sizeof(uint32_t) * std::min(R, kComboMaskChunk) +
                      sizeof(float) * kComboWarps * 2 * S * (S - 1);
  ScoreGrid grid;
  cudaError_t err = score_grid(N, k, n0, N_glob, tile, &grid);
  if (err != cudaSuccess) return err;
  const void* kernel = k > 0 ? reinterpret_cast<const void*>(&combo_kernel<kS, true>)
                             : reinterpret_cast<const void*>(&combo_kernel<kS, false>);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>(grid.tiles);
  if (k == 0) {
    combo_kernel<kS, false><<<tiles, kThreads, smem, stream>>>(
        F, f_numel, idx4, n_combo, cid, N, orients, R, S, c0, grid, parts, costs, vals, idx,
        second);
    return cudaGetLastError();
  }
  combo_kernel<kS, true><<<dim3(tiles, grid.ng), kThreads, smem, stream>>>(
      F, f_numel, idx4, n_combo, cid, N, orients, R, S, c0, grid, parts, costs, vals, idx,
      second);
  if (tiles > 1)
    topk_merge<<<grid.ng, 32, 0, stream>>>(parts, static_cast<int>(tiles), grid.g0, vals, idx,
                                           second);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// block_score
//
// Replaces _block_score_kernel and _block_score_topk_kernel
// (hic_genome_assembler_tpu/ops/cost.py:203-248).  Per order b of S ids (ids
// may repeat): offsets from the sizes prefix, the 4P values
// fv[4p + e] = F[((s_i*Sp + s_j)*4 + e)*(C+1) + offs_j - offs_i] of the
// position pairs p = (i < j), and for every orientation row r
// cost[b, r] = sum_p fv[4p + e(r, p)] + c0, with e(r, p) = 2*orients[r, i] +
// orients[r, j].  k = 0: every score into costs [Bo, R]; k > 0: the group
// top-k of the scores, as combo_score_topk gives it, and no score reaches
// device memory.  NaN for an order with an id outside [0, Sp), a negative
// size or sizes that reach C + 1, and for a row with a flag other than 0 or 1.
//
// Its callers.  Part 2's dense escalation scores S = 8 orders in grid
// launches of 2,048 orders x 256 orientations (cost.score_batch); the top-k
// form serves the non-combo path, which part 2 reaches only for a
// chromosome of one scaffold (S = 1, 2 candidates), since nScaffolds is at
// most 8 and a brute-force order's ids are distinct.
//
// What bounds it on this card.  The grid form writes 4 bytes a candidate
// (2.1 MB a 2,048 x 256 launch) and reads a few bytes an order: bytes.  The
// top-k form writes 3k values: the adds, P a candidate summed directly.
// The XLA program gathers [Bo, P, 4] values into device memory and applies
// the orientations as a one-hot [4P, R] matrix product.
//
// The design (combo_kernel's, with the order's own gather).  A block of 8
// warps owns `tile` candidates: 8 whole orders for k = 0, one a warp, and
// for k > 0 a range of TOPK_TILE inside one group (clipped as in
// combo_kernel), which a warp walks an order at a time.  The block builds the
// orientation rows' bit masks once, in chunks of kComboMaskChunk rows, and
// the (i, j) of each pair p once.  A warp takes whole orders: lanes q < S
// load the ids and sizes and a shuffle scan gives the offsets (no thread
// walks the order alone); the warp gathers the 4P values into its slice of
// shared memory, then its lanes score orientations.  Two sums:
//  - direct: sum_p fv[4p + e(r, p)], p ascending (combo_sum), P lookups;
//  - halves (S <= 10, where the rule in score_kernels.block_halves picks
//    it): with A = positions [0, a = S/2) and B = the rest, the warp first
//    builds TB[bits_B], the sums of the pairs inside B, and X_j[bits_A,
//    b_j], the pairs (i in A, j) of each j in B, X_a with the pairs inside A
//    added (at S = 8: 16 + 4 x 32 floats); a score is then
//    TB + sum_{j in B} X_j + c0, S - S/2 + 1 lookups.  Every score is the
//    same P non-negative terms plus c0 grouped otherwise, so integer tables
//    stay exact and floats within sum_bound(P + 1).
// The tables are at most 32 floats for TB and 64 a cross row, so the lanes'
// reads of one table never conflict.  k = 0 stores float4s of four
// orientations a lane where R is a multiple of 4 (each row 16-byte aligned),
// else one float a lane; k > 0 merges each score into the lane's (max,
// argmax, second) as combo_kernel does (push, when the masks fit one chunk
// and a lane's indices ascend), folded by topk_merge when a group spans
// blocks.  A warp with several orders loads its next order's ids while it
// scores the current one.  On a mesh the top-k form takes the partials form
// of combo_kernel (n0, N_glob; see the group top-k note).
//
// What was measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6, with
// tools/block_kernel_turns.py): the escalation's 2,048 x 256 launch takes
// 0.0064 ms on the device against PR 5's one-block-an-order kernel's
// 0.0175 (0.0079 with the direct sums), and 20,160 x 256 in one launch
// 0.0304 against 0.1151 (0.0452 direct).
// ---------------------------------------------------------------------------

constexpr int kBlockWarps = kThreads / 32;
constexpr int kHalvesMaxS = 10;  // the halves split's tables: 32 + 5 x 64 floats at S = 10

// Floats of the halves tables TB [2^b] and X [b][2^(a+1)] at S positions.
__host__ __device__ constexpr int halves_entries(int S) {
  return (1 << (S - S / 2)) + (S - S / 2) * (2 << (S / 2));
}

// A warp slice of the block kernel's shared memory: ids [32], offsets [32],
// values [4P], halves tables.
__host__ __device__ constexpr int block_warp_words(int S) {
  return 64 + 2 * S * (S - 1) + (S <= kHalvesMaxS ? halves_entries(S) : 0);
}

__device__ __forceinline__ constexpr int pair_index(int i, int j, int S) {
  return i * (2 * S - i - 1) / 2 + (j - i - 1);
}

// One warp: the ids (lane q < S holds id q of the order) and exclusive
// size offsets of an order into ids/offs, and whether the order breaks the
// layout (in every lane).
__device__ __forceinline__ bool load_order(int32_t id, int S, const int64_t* __restrict__ sizes,
                                           int Sp, int64_t Cp1, int32_t* ids, int32_t* offs,
                                           int lane) {
  int64_t sz = 0;
  bool bad = false;
  if (lane < S) {
    bad = id < 0 || id >= Sp;
    sz = bad ? 0 : __ldg(sizes + id);
    bad |= sz < 0;
  }
  int64_t incl = sz;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, static_cast<long long>(incl), o);
    if (lane >= o) incl += u;
  }
  bad |= lane < S && incl >= Cp1;
  if (lane < S) {
    ids[lane] = id;
    offs[lane] = static_cast<int32_t>(incl - sz);
  }
  return __any_sync(kFull, bad);
}

// One warp: values[q] = F[((ids_i*Sp + ids_j)*4 + e)*Cp1 + offs_j - offs_i]
// for q = 4p + e, the loads of a lane issued before its stores.
template <int kS>
__device__ __forceinline__ void gather_values(const float* __restrict__ F, int64_t Cp1, int Sp,
                                              const uint32_t* pairs, const int32_t* ids,
                                              const int32_t* offs, int P, float* values,
                                              int lane) {
  constexpr int kIters = kS > 0 ? (2 * kS * (kS - 1) + 31) / 32 : 4;
  for (int q0 = 0; q0 < 4 * P; q0 += 32 * kIters) {
    float v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = q0 + lane + 32 * it;
      v[it] = 0.0f;
      if (q < 4 * P) {
        const uint32_t pr = pairs[q >> 2];
        const int i = pr >> 8, j = pr & 255;
        const int64_t row = (static_cast<int64_t>(ids[i]) * Sp + ids[j]) * 4 + (q & 3);
        v[it] = __ldg(F + row * Cp1 + (offs[j] - offs[i]));
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = q0 + lane + 32 * it;
      if (q < 4 * P) values[q] = v[it];
    }
  }
}

// One warp: the halves tables of an order's values (see the note above).
// TB's entries go to lanes t < 2^b; X's entries u = jj*2^(a+1) + 2*mA + b_j
// to lanes u mod 32, in unrolled steps, so that jj, and with it each term's
// pair, is a constant of the step wherever 2^(a+1) >= 32.
template <int kS>
__device__ __forceinline__ void build_halves(const float* values, float* tabs, int lane) {
  constexpr int a = kS / 2, b = kS - a, nB = 1 << b, nX = 2 << a;
  for (int t = lane; t < nB; t += 32) {  // TB[t]: the pairs inside B
    float acc = 0.0f;
#pragma unroll
    for (int i = a; i < kS; ++i)
#pragma unroll
      for (int j = i + 1; j < kS; ++j)
        acc += values[4 * pair_index(i, j, kS) + ((t >> (i - a)) & 1) * 2 + ((t >> (j - a)) & 1)];
    tabs[t] = acc;
  }
#pragma unroll
  for (int step = 0; step < (b * nX + 31) / 32; ++step) {
    const int u = lane + 32 * step;
    if (u < b * nX) {  // X_j[mA, b_j]: the pairs (i in A, j); X_a also the pairs inside A
      const int jj = u / nX, mA = (u % nX) >> 1, bj = u & 1;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < a; ++i)
        acc += values[4 * pair_index(i, a + jj, kS) + ((mA >> i) & 1) * 2 + bj];
      if (jj == 0) {
#pragma unroll
        for (int i = 0; i < a; ++i)
#pragma unroll
          for (int i2 = i + 1; i2 < a; ++i2)
            acc += values[4 * pair_index(i, i2, kS) + ((mA >> i) & 1) * 2 + ((mA >> i2) & 1)];
      }
      tabs[nB + u] = acc;
    }
  }
}

// TB[bits_B] + sum_{j in B} X_j[bits_A, b_j] of a row's mask m.
template <int kS>
__device__ __forceinline__ float halves_sum(const float* tabs, uint32_t m) {
  constexpr int a = kS / 2, b = kS - a, nA = 1 << a, nB = 1 << b;
  float acc = tabs[(m >> a) & (nB - 1)];
  const float* X = tabs + nB + 2 * (m & (nA - 1));
#pragma unroll
  for (int jj = 0; jj < b; ++jj) acc += X[jj * 2 * nA + ((m >> (a + jj)) & 1)];
  return acc;
}

template <int kS, bool kTopk>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ F, int64_t Cp1, const int64_t* __restrict__ sizes, int Sp,
             const int32_t* __restrict__ orders, int64_t N, const int32_t* __restrict__ orients,
             int R, int S_arg, int halves, int vec4, const float* __restrict__ c0,
             const ScoreGrid grid, Top2* __restrict__ parts, float* __restrict__ costs,
             float* __restrict__ vals, int64_t* __restrict__ idx, float* __restrict__ second) {
  const int S = kS > 0 ? kS : S_arg;
  const int P = S * (S - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* masks = reinterpret_cast<uint32_t*>(dyn_smem);  // [min(R, kComboMaskChunk)]
  uint32_t* pairs = masks + min(R, kComboMaskChunk);         // [P]: i << 8 | j
  int32_t* ids = reinterpret_cast<int32_t*>(pairs + P) + warp * block_warp_words(S);
  int32_t* offs = ids + 32;
  float* values = reinterpret_cast<float*>(offs + 32);       // [4P]
  float* tabs = values + 4 * P;                               // the halves tables
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int i = 0, rest = p;
    while (rest >= S - 1 - i) rest -= S - 1 - i++;
    pairs[p] = static_cast<uint32_t>(i) << 8 | static_cast<uint32_t>(i + 1 + rest);
  }
  int64_t lo, hi, real_hi;
  block_range<kTopk>(N, grid, &lo, &hi, &real_hi);
  const float c0v = *c0;
  Top2L x = top2l_empty();
  for (int r0 = 0; lo < hi && r0 < R; r0 += kComboMaskChunk) {  // as in combo_kernel
    const int r1 = min(R, r0 + kComboMaskChunk);
    __syncthreads();  // the previous chunk's masks have been read
    build_masks(orients, S, r0, r1, masks);
    __syncthreads();
    if (lo >= real_hi) continue;
    // the warp's orders b, b + 8, ...; each one's ids are loaded while the
    // order before it is scored
    const int64_t b_last = (real_hi - 1) / R;
    int32_t next_id = 0;
    if (lo / R + warp <= b_last && lane < S) next_id = __ldg(orders + (lo / R + warp) * S + lane);
    for (int64_t b = lo / R + warp; b <= b_last; b += kBlockWarps) {
      const int32_t id = next_id;
      if (b + kBlockWarps <= b_last && lane < S)
        next_id = __ldg(orders + (b + kBlockWarps) * S + lane);
      const int64_t nb = b * R;
      const int rl = static_cast<int>(max64(r0, lo - nb));
      const int rh = static_cast<int>(min64(r1, real_hi - nb));
      if (rl >= rh) continue;  // the order has no candidate of this chunk in the range
      const bool bad = load_order(id, S, sizes, Sp, Cp1, ids, offs, lane);
      __syncwarp();
      if (!bad) {
        gather_values<kS>(F, Cp1, Sp, pairs, ids, offs, P, values, lane);
        __syncwarp();
        if constexpr (kS > 0) {
          if (halves) {
            build_halves<kS>(values, tabs, lane);
            __syncwarp();
          }
        }
      }
      // the scores of the order's rows [rl, rh), `sum` giving a row's P-term
      // sum; one instance each for a bad order, the halves and the direct sums
      auto score_rows = [&](auto sum) {
        auto score = [&](uint32_t m) -> float { return (m >> 31) ? NAN : sum(m) + c0v; };
        if constexpr (kTopk) {
          if (R <= kComboMaskChunk) {  // one chunk: a lane's indices ascend, push is merge
            for (int r = r0 + lane; r < rh; r += 32)
              if (r >= rl) x = push(x, score(masks[r - r0]), static_cast<int32_t>(nb + r - lo));
          } else {
            for (int r = r0 + lane; r < rh; r += 32)
              if (r >= rl)
                x = merge(x, Top2L{score(masks[r - r0]), -INFINITY,
                                   static_cast<int32_t>(nb + r - lo)});
          }
        } else if (vec4) {  // whole orders, R a multiple of 4: rl = r0, rh = r1
          for (int r = r0 + 4 * lane; r < rh; r += 128) {
            const uint4 m = *reinterpret_cast<const uint4*>(masks + (r - r0));
            *reinterpret_cast<float4*>(costs + nb + r) =
                make_float4(score(m.x), score(m.y), score(m.z), score(m.w));
          }
        } else {
          for (int r = r0 + lane; r < rh; r += 32) costs[nb + r] = score(masks[r - r0]);
        }
      };
      if (bad) {
        score_rows([](uint32_t) { return NAN; });
      } else if (kS > 0 && halves) {
        if constexpr (kS > 0) score_rows([&](uint32_t m) { return halves_sum<kS>(tabs, m); });
      } else {
        score_rows([&](uint32_t m) { return combo_sum<kS>(values, m, S); });
      }
      __syncwarp();  // the values and tables are read before the next order's
    }
  }
  if constexpr (!kTopk) return;
  if (threadIdx.x == 0 && lo < hi && real_hi < hi)
    x = merge(x, Top2L{-INFINITY, -INFINITY, static_cast<int32_t>(max64(lo, N) - lo)});
  x = block_merge(x, top2l_empty());
  store_topk(x, grid, lo, parts, vals, idx, second);
}

template <int kS>
cudaError_t launch_block(const float* F, int64_t Cp1, const int64_t* sizes, int Sp,
                         const int32_t* orders, int64_t Bo, int S, const int32_t* orients, int R,
                         int halves, const float* c0, int k, int64_t n0, int64_t N_glob,
                         int64_t tile, Top2* parts, float* costs, float* vals, int64_t* idx,
                         float* second, cudaStream_t stream) {
  const int64_t N = Bo * R;
  const size_t smem = sizeof(uint32_t) * (std::min(R, kComboMaskChunk) + S * (S - 1) / 2 +
                                          kBlockWarps * block_warp_words(S));
  ScoreGrid grid;
  cudaError_t err = score_grid(N, k, n0, N_glob, tile, &grid);
  if (err != cudaSuccess) return err;
  const int vec4 = R % 4 == 0 && reinterpret_cast<uintptr_t>(costs) % 16 == 0;
  const void* kernel = k > 0 ? reinterpret_cast<const void*>(&block_kernel<kS, true>)
                             : reinterpret_cast<const void*>(&block_kernel<kS, false>);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>(grid.tiles);
  if (k == 0) {
    block_kernel<kS, false><<<tiles, kThreads, smem, stream>>>(
        F, Cp1, sizes, Sp, orders, N, orients, R, S, halves, vec4, c0, grid, parts, costs, vals,
        idx, second);
    return cudaGetLastError();
  }
  block_kernel<kS, true><<<dim3(tiles, grid.ng), kThreads, smem, stream>>>(
      F, Cp1, sizes, Sp, orders, N, orients, R, S, halves, vec4, c0, grid, parts, costs, vals,
      idx, second);
  if (tiles > 1)
    topk_merge<<<grid.ng, 32, 0, stream>>>(parts, static_cast<int>(tiles), grid.g0, vals, idx,
                                           second);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pair_score
//
// Replaces _pair_score_kernel (hic_genome_assembler_tpu/ops/cost.py:402).
// Per candidate row of W ids and W orientation flags:
//   score = sum_{i<j} F[((s_i*Sp + s_j)*4 + 2*o_i + o_j)*(C+1) + offs_j - offs_i] + c0.
//
// What bounds it on this card: the scattered table reads, one 4-byte value
// each out of a table of tens of MB, of which a batch needs the distinct
// values it gathers (27.8 MB of the 38.6 MB table at B = 30,720, W = 56;
// it fits the 50 MB L2).  The XLA program (and the plain version)
// materialises the [B, P] index and value tensors, 378 MB of int64 indices
// at B = 30,720.  One warp owns one candidate: it compacts the row's real
// slots (size > 0; a pad slot's F rows are exactly zero, so skipping its
// pairs leaves the sum unchanged) with their offsets into shared memory (a
// ballot and a shuffle scan).  The n real slots' triangle i < j is walked
// by rows, row t folded with row n - 2 - t, so that each of the n / 2
// folded steps holds n pairs (the middle row alone holds n / 2): item u of
// the walk is step u / n, position u % n, and a lane's items lie 32 apart,
// so its (step, position) advances by a constant, with no search.  A lane
// forms the indices of 8 items, starts their 8 __ldg gathers, then adds the
// values in item order; the warp adds its lanes' sums with a fixed shuffle
// tree, so two launches give the same bits.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md), the gathers in flight did not make the walk
// faster: it is bound by the 32-byte sectors its scattered gathers move (a
// warp-wide gather touches 32 table rows), not by L2's latency.
// ---------------------------------------------------------------------------

constexpr int kPairWarps = 8;   // candidates a block, one warp each
constexpr int kPairUnroll = 8;  // gathers a lane keeps in flight

// The sum of this lane's items of the folded walk of the n compacted slots.
__device__ __forceinline__ float pair_walk(const float* __restrict__ F, int64_t Cp1, int Sp,
                                           const int32_t* code, const int32_t* offs, int n,
                                           int lane) {
  constexpr int team = 32;  // the warp's lanes
  float acc = 0.0f;
  if (n < 2) return acc;
  const int steps = n / 2;
  const int64_t items = static_cast<int64_t>(steps) * n;
  const int d_step = team / n, d_pos = team % n;
  int step = lane / n, pos = lane % n;
  for (int64_t u0 = lane; u0 < items; u0 += static_cast<int64_t>(kPairUnroll) * team) {
    float v[kPairUnroll];
#pragma unroll
    for (int k = 0; k < kPairUnroll; ++k) {
      const int first = n - 1 - step;  // pairs of row `step`; the rest belong to row n - 2 - step
      const bool in_first = pos < first;
      const int i = in_first ? step : n - 2 - step;
      const int j = in_first ? step + 1 + pos : i + 1 + (pos - first);
      // the middle row (step == n - 2 - step) holds only its own pairs
      const bool valid = u0 + static_cast<int64_t>(k) * team < items &&
                         (in_first || step != n - 2 - step);
      v[k] = 0.0f;
      if (valid) {
        const int ci = code[i], cj = code[j];
        const int64_t row = (static_cast<int64_t>(ci >> 1) * Sp + (cj >> 1)) * 4 +
                            (ci & 1) * 2 + (cj & 1);
        v[k] = __ldg(F + row * Cp1 + (offs[j] - offs[i]));
      }
      pos += d_pos;
      step += d_step;
      if (pos >= n) {
        pos -= n;
        ++step;
      }
    }
#pragma unroll
    for (int k = 0; k < kPairUnroll; ++k) acc += v[k];
  }
  return acc;
}

// Compacts one candidate's real slots into code (id*2 + flag) and offs, in
// one warp; returns the count n in every lane, and sets bad where an id or
// flag breaks the layout or the offsets overrun the table.
__device__ __forceinline__ int pair_compact(const int64_t* __restrict__ sizes, int Sp,
                                            int64_t Cp1, const int32_t* __restrict__ cand,
                                            int64_t b, int W, int32_t* code, int32_t* offs,
                                            bool* bad_out) {
  const int lane = threadIdx.x & 31;
  const int32_t* ids = cand + b * 2 * W;
  const int32_t* flags = ids + W;
  int n = 0, carry = 0;
  bool bad = false;
  for (int base = 0; base < W; base += 32) {
    const int pos = base + lane;
    int code_v = 0, sz = 0;
    if (pos < W) {
      const int32_t id = ids[pos], f = flags[pos];
      if (id < 0 || id >= Sp || (f & ~1)) {
        bad = true;
      } else {
        sz = static_cast<int>(sizes[id]);
        code_v = id * 2 + f;
      }
    }
    int incl = sz;  // inclusive scan of the sizes over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned real = __ballot_sync(kFull, sz > 0);
    if (sz > 0) {
      const int slot = n + __popc(real & ((1u << lane) - 1u));
      code[slot] = code_v;
      offs[slot] = carry + incl - sz;
    }
    n += __popc(real);
    carry += __shfl_sync(kFull, incl, 31);
  }
  *bad_out = __any_sync(kFull, bad) || carry >= Cp1;
  return n;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One warp a candidate, `warps` candidates a block.
__global__ void __launch_bounds__(kPairWarps * 32)
pair_score_kernel(const float* __restrict__ F, int64_t Cp1, const int64_t* __restrict__ sizes,
                  int Sp, const int32_t* __restrict__ cand, int B, int W, int warps,
                  const float* __restrict__ c0, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (warp >= warps || b >= B) return;  // whole warps leave; only __syncwarp below
  int32_t* code = reinterpret_cast<int32_t*>(dyn_smem) + 2 * W * warp;
  int32_t* offs = code + W;
  bool bad;
  const int n = pair_compact(sizes, Sp, Cp1, cand, b, W, code, offs, &bad);
  __syncwarp();
  const float acc = warp_sum(bad ? 0.0f : pair_walk(F, Cp1, Sp, code, offs, n, lane));
  if (lane == 0) out[b] = bad ? NAN : acc + *c0;
}

}  // namespace

// M: float32 [C, C] row-major; sizes: int64 [Sp]; h: float32 [4*Sp*Sp, 2*cmax - 1];
// pairs_per_block: 1..8 pairs of a wrapped diagonal a block (2 * (2*cmax - 1)
// floats of shared memory each).
extern "C" int pair_profiles(const float* M, int C, const int64_t* sizes, int Sp, int cmax,
                             int pairs_per_block, float* h, cudaStream_t stream) {
  if (C < 1 || Sp < 1 || Sp > 65535 || cmax < 1 || pairs_per_block < 1 ||
      pairs_per_block > kProfileMaxPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 2 * (2 * cmax - 1) * pairs_per_block;
  const int chunks = (Sp + pairs_per_block - 1) / pairs_per_block;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&pair_profiles_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_profiles_kernel<<<dim3(chunks, Sp), kProfileThreads, smem, stream>>>(
      M, C, sizes, Sp, cmax, pairs_per_block, h);
  return static_cast<int>(cudaGetLastError());
}

// Combo scores of Bo orders x R orientations, `tile` candidates a block.
// k == 0: every score into costs [Bo, R] (n0 = 0, N_glob = Bo * R).  k > 0:
// the group top-k into vals/idx/second [k] of the candidates [n0, n0 + Bo *
// R) of a batch of N_glob in k groups (one device: n0 = 0, N_glob = Bo * R;
// a mesh block: its partial triples, see topk_fold); parts: k * tiles
// 16-byte partials when a group spans blocks, tiles = ceil(min(G, span) /
// tile) with G = ceil(N_glob / k) and span = Bo * R, or N_glob's padded end
// less n0 for the block that ends the batch.
extern "C" int combo_score_topk(const float* F, int64_t f_numel, const int64_t* idx4,
                                int n_combo, const int32_t* cid, int64_t Bo,
                                const int32_t* orients, int R, int S, const float* c0, int k,
                                int64_t n0, int64_t N_glob, int64_t tile, void* parts,
                                float* costs, float* vals, int64_t* idx, float* second,
                                cudaStream_t stream) {
  if (n_combo < 1 || Bo < 1 || R < 1 || S < 2 || S > 31 || k < 0 || k > 65535 || tile < 1 ||
      tile > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Top2* p = static_cast<Top2*>(parts);
  switch (S) {
#define COMBO_CASE(n)                                                                       \
  case n:                                                                                  \
    return static_cast<int>(launch_combo<n>(F, f_numel, idx4, n_combo, cid, Bo, orients, R, \
                                            S, c0, k, n0, N_glob, tile, p, costs, vals, idx, \
                                            second, stream));
    COMBO_CASE(2) COMBO_CASE(3) COMBO_CASE(4) COMBO_CASE(5) COMBO_CASE(6) COMBO_CASE(7)
    COMBO_CASE(8)
#undef COMBO_CASE
    default:  // S > 8: the sums' loops are not unrolled
      return static_cast<int>(launch_combo<0>(F, f_numel, idx4, n_combo, cid, Bo, orients, R, S,
                                              c0, k, n0, N_glob, tile, p, costs, vals, idx,
                                              second, stream));
  }
}

// The group top-k of the float32 scores x [N] in k groups (see combo_score_topk).
extern "C" int group_topk(const float* x, int64_t N, int k, int64_t tile, void* parts,
                          float* vals, int64_t* idx, float* second, cudaStream_t stream) {
  if (N < 1 || k < 1 || k > 65535 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t G = (N + k - 1) / k;
  const int64_t tiles = (G + tile - 1) / tile;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Top2* p = static_cast<Top2*>(parts);
  topk_tiles<<<dim3(static_cast<unsigned>(tiles), k), kThreads, 0, stream>>>(x, N, G, tile, p,
                                                                             vals, idx, second);
  if (tiles > 1)
    topk_merge<<<k, 32, 0, stream>>>(p, static_cast<int>(tiles), 0, vals, idx, second);
  return static_cast<int>(cudaGetLastError());
}

// The fold of a mesh's D blocks' partial group triples, [D, k] each (block
// t's triple of group g at t * k + g, as combo_score_topk and block_score
// write them), into vals/idx/second [k]: one warp a group, one launch.
extern "C" int topk_fold(const float* in_vals, const int64_t* in_idx, const float* in_second,
                         int D, int k, float* vals, int64_t* idx, float* second,
                         cudaStream_t stream) {
  if (D < 1 || k < 1 || k > INT32_MAX / D) return static_cast<int>(cudaErrorInvalidValue);
  topk_fold_kernel<<<k, 32, 0, stream>>>(in_vals, in_idx, in_second, D, k, vals, idx, second);
  return static_cast<int>(cudaGetLastError());
}

// Block scores of Bo orders (int32 [Bo, S]) x R orientation rows (int32
// [R, S]), `tile` candidates a block.  k == 0: every score into costs
// [Bo, R], tile a multiple of R (whole orders a block), n0 = 0 and N_glob =
// Bo * R.  k > 0: the group top-k into vals/idx/second [k] of the candidates
// [n0, n0 + Bo * R) of a batch of N_glob (parts: as combo_score_topk).
// halves = 1 sums through the halves tables (2 <= S <= 10), 0 directly.
extern "C" int block_score(const float* F, int64_t Cp1, const int64_t* sizes, int Sp,
                           const int32_t* orders, int64_t Bo, int S, const int32_t* orients,
                           int R, int halves, const float* c0, int k, int64_t n0,
                           int64_t N_glob, int64_t tile, void* parts, float* costs, float* vals,
                           int64_t* idx, float* second, cudaStream_t stream) {
  if (Bo < 1 || S < 1 || S > 31 || R < 1 || Sp < 1 || k < 0 || k > 65535 || tile < 1 ||
      tile > INT32_MAX || (k == 0 && tile % R) || (halves && (S < 2 || S > kHalvesMaxS)))
    return static_cast<int>(cudaErrorInvalidValue);
  Top2* p = static_cast<Top2*>(parts);
  switch (S) {
#define BLOCK_CASE(n)                                                                        \
  case n:                                                                                   \
    return static_cast<int>(launch_block<n>(F, Cp1, sizes, Sp, orders, Bo, S, orients, R,   \
                                            halves, c0, k, n0, N_glob, tile, p, costs, vals,  \
                                            idx, second, stream));
    BLOCK_CASE(2) BLOCK_CASE(3) BLOCK_CASE(4) BLOCK_CASE(5) BLOCK_CASE(6) BLOCK_CASE(7)
    BLOCK_CASE(8) BLOCK_CASE(9) BLOCK_CASE(10)
#undef BLOCK_CASE
    default:  // S = 1 or S > 10: direct sums, the loops not unrolled
      return static_cast<int>(launch_block<0>(F, Cp1, sizes, Sp, orders, Bo, S, orients, R,
                                              halves, c0, k, n0, N_glob, tile, p, costs, vals,
                                              idx, second, stream));
  }
}

// cand: int32 [B, 2*W], each row's W ids then its W orientation flags; out: float32 [B].
extern "C" int pair_score(const float* F, int64_t Cp1, const int64_t* sizes, int Sp,
                          const int32_t* cand, int B, int W, const float* c0, float* out,
                          cudaStream_t stream) {
  if (B < 1 || W < 1 || Sp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_warp = sizeof(int32_t) * 2 * W;
  if (per_warp > static_cast<size_t>(kSmemDefault)) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(
      std::min<size_t>(kPairWarps, std::max<size_t>(1, kSmemDefault / per_warp)));
  const int blocks = (B + warps - 1) / warps;
  pair_score_kernel<<<blocks, kPairWarps * 32, per_warp * warps, stream>>>(F, Cp1, sizes, Sp,
                                                                           cand, B, W, warps, c0,
                                                                           out);
  return static_cast<int>(cudaGetLastError());
}
