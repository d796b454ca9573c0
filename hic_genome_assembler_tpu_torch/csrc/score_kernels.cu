// Part 2's scoring kernels, for Hopper (sm_90a): pair profiles, combo top-k,
// block scores and pair scores.
//
// Replace the device functions of hic_genome_assembler_tpu/ops/cost.py, each
// a jitted XLA program on the TPU (no Pallas kernel):
//
//   pair_profiles     _skew_profile_chunk (:82-151), _build_pair_profiles (:158-188)
//   combo_score_topk  _combo_score_kernel / _combo_score_topk_kernel (:382-399)
//                     with the group epilogue _group_argmax (:251-270)
//   group_topk        _group_argmax alone (scores gathered from a mesh's blocks)
//   block_score       _block_score_kernel (:203-230); its top-k form
//                     _block_score_topk_kernel (:233-248) is group_topk of it
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
// pair_profiles, combo_score_topk and block_score are the first, simple
// form: no TMA, no tensor cores, no vector loads.  pair_score is redesigned
// for the card (its note below).

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

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
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
// to 256 MB a chunk), skews it twice and gathers the four rows from it.  Here
// one block owns one (s, t) pair: it stages rows of its matrix block into
// shared memory with coalesced loads (each element read once from device
// memory), each thread owns a set of diagonals and sums them over the staged
// rows in order of a, keeping both sums in shared memory, and the block then
// writes its four rows in full.  No transient and no chunk budget: one launch
// a chromosome.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pair_profiles_kernel(const float* __restrict__ M, int C, const int64_t* __restrict__ sizes,
                     int Sp, int cmax, int rows_per_tile, float* __restrict__ h) {
  const int L = 2 * cmax - 1;
  const int s = blockIdx.y, t = blockIdx.x;
  int64_t offs_s = 0, offs_t = 0;  // Sp is small: every thread sums the prefix
  for (int q = 0; q < s; ++q) offs_s += sizes[q];
  for (int q = 0; q < t; ++q) offs_t += sizes[q];
  const int64_t cs64 = sizes[s], ct64 = sizes[t];
  float* out = h + (static_cast<int64_t>(s) * Sp + t) * 4 * L;
  const bool bad = cs64 < 0 || ct64 < 0 || cs64 > cmax || ct64 > cmax ||
                   offs_s + cs64 > C || offs_t + ct64 > C;
  if (bad || s == t || cs64 == 0 || ct64 == 0) {
    const float fill = bad ? NAN : 0.0f;
    for (int q = threadIdx.x; q < 4 * L; q += blockDim.x) out[q] = fill;
    return;
  }
  const int cs = static_cast<int>(cs64), ct = static_cast<int>(ct64);
  const int nd = cs + ct - 1;  // diagonals (and anti-diagonals) of the block
  float* acc_sum = reinterpret_cast<float*>(dyn_smem);  // [L]  Dsum[u]
  float* acc_diff = acc_sum + L;                        // [L]  Ddiff[d]
  float* tile = acc_diff + L;                           // [rows_per_tile][ct]
  for (int d = threadIdx.x; d < nd; d += blockDim.x) acc_sum[d] = acc_diff[d] = 0.0f;
  const float* block = M + offs_s * C + offs_t;
  for (int a0 = 0; a0 < cs; a0 += rows_per_tile) {
    const int rows = min(rows_per_tile, cs - a0);
    __syncthreads();  // the previous tile has been read
    for (int q = threadIdx.x; q < rows * ct; q += blockDim.x) {
      const int r = q / ct;
      tile[q] = block[static_cast<int64_t>(a0 + r) * C + (q - r * ct)];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < nd; d += blockDim.x) {
      // anti-diagonal u = d: b = d - a0 - r in [0, ct)
      float su = 0.0f;
      for (int r = max(0, d - a0 - ct + 1), hi = min(rows - 1, d - a0); r <= hi; ++r)
        su += tile[r * ct + (d - a0 - r)];
      // diagonal d: b = (d - cs + 1 + a0) + r in [0, ct)
      const int off = d - cs + 1 + a0;
      float di = 0.0f;
      for (int r = max(0, -off), hi = min(rows - 1, ct - 1 - off); r <= hi; ++r)
        di += tile[r * ct + off + r];
      acc_sum[d] += su;  // thread d alone owns entry d
      acc_diff[d] += di;
    }
  }
  __syncthreads();
  const int shift = cmax - 1;
  for (int m = threadIdx.x; m < L; m += blockDim.x) {
    const int d0 = m - shift + cs - 1;   // e = 0 -> Ddiff
    const int u1 = ct - 1 + shift - m;   // e = 1 -> Dsum
    const int u2 = m + cs - 1 - shift;   // e = 2 -> Dsum
    const int d3 = ct - 1 + shift - m;   // e = 3 -> Ddiff
    out[m] = (d0 >= 0 && d0 < nd) ? acc_diff[d0] : 0.0f;
    out[L + m] = (u1 >= 0 && u1 < nd) ? acc_sum[u1] : 0.0f;
    out[2 * L + m] = (u2 >= 0 && u2 < nd) ? acc_sum[u2] : 0.0f;
    out[3 * L + m] = (d3 >= 0 && d3 < nd) ? acc_diff[d3] : 0.0f;
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
// masked max.  A block reduces one tile of TOPK_TILE candidates of a group
// (lanes strided over the tile, then shuffles, then the block's warps); a
// group of one tile writes its result, a longer group writes one partial per
// tile and topk_merge folds them, one warp a group.
// ---------------------------------------------------------------------------

struct Top2 {
  float v1;    // the max
  float v2;    // the max without the argmax's position
  int64_t i1;  // the argmax
};

__device__ __forceinline__ Top2 top2_empty() { return {-INFINITY, -INFINITY, INT64_MAX}; }

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = a.v1 > b.v1 || (a.v1 == b.v1 && a.i1 < b.i1);
  const Top2& w = a_wins ? a : b;
  const Top2& l = a_wins ? b : a;
  return {w.v1, fmaxf(w.v2, l.v1), w.i1};
}

__device__ __forceinline__ Top2 warp_merge(Top2 x) {
  for (int o = 16; o > 0; o >>= 1) {
    Top2 y;
    y.v1 = __shfl_xor_sync(kFull, x.v1, o);
    y.v2 = __shfl_xor_sync(kFull, x.v2, o);
    y.i1 = __shfl_xor_sync(kFull, static_cast<long long>(x.i1), o);
    x = merge(x, y);
  }
  return x;
}

// The block's merged triple, in thread 0.
__device__ Top2 block_merge(Top2 x) {
  __shared__ Top2 warps[kThreads / 32];
  x = warp_merge(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < static_cast<int>(blockDim.x >> 5) ? warps[lane] : top2_empty();
    x = warp_merge(x);
  }
  return x;
}

// Candidate scores read from device memory.
struct MemorySource {
  const float* x;
  __device__ void stage() {}
  __device__ float value(int64_t n) const { return x[n]; }
};

// Scores of the combo factorization: cost(b, r) = sum_p V4[cid[b, p], e(r, p)]
// + c0 with e(r, p) = 2*orients[r, i] + orients[r, j] for the p-th position
// pair i < j.  stage() copies V4 (gathered from F once per launch) and each
// orientation row as a bit mask into shared memory; bit 31 marks a row with a
// flag other than 0 or 1.
//
// What bounds combo_score_topk on this card: the adds, P a candidate (5.16M
// candidates x 28 terms at S = 8), against a few MB of cid read once.  The
// XLA program writes vals = V4[cid] [Bo, P, 4] to device memory and folds it
// with a one-hot [P, 4, R] selector in a matrix product.  Here V4 and the
// masks sit in shared memory, each thread scores its candidates with P
// shared-memory reads whose orientation comes from the row's bits, and the
// scores go straight into the group merge: they never reach device memory.
struct ComboSource {
  const float* v4;
  const int32_t* cid;
  const int32_t* orients;
  const float* c0;
  int n_combo, R, S;
  float* sv4;
  uint32_t* masks;
  float c0v;

  __device__ void stage() {
    sv4 = reinterpret_cast<float*>(dyn_smem);
    masks = reinterpret_cast<uint32_t*>(sv4 + 4 * n_combo);
    for (int q = threadIdx.x; q < 4 * n_combo; q += blockDim.x) sv4[q] = v4[q];
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      uint32_t m = 0;
      for (int q = 0; q < S; ++q) {
        const int32_t f = orients[static_cast<int64_t>(r) * S + q];
        m |= (f & ~1) ? 0x80000000u : static_cast<uint32_t>(f) << q;
      }
      masks[r] = m;
    }
    c0v = *c0;
  }

  __device__ float value(int64_t n) const {
    const int64_t b = n / R;
    const uint32_t m = masks[n - b * R];
    const int P = S * (S - 1) / 2;
    const int32_t* row = cid + b * P;
    bool bad = (m >> 31) != 0;
    float acc = 0.0f;
    int p = 0;
    for (int i = 0; i < S - 1; ++i) {
      const int ei = ((m >> i) & 1) * 2;
      for (int j = i + 1; j < S; ++j, ++p) {
        const unsigned c = static_cast<unsigned>(row[p]);
        if (c >= static_cast<unsigned>(n_combo)) {
          bad = true;
          continue;
        }
        acc += sv4[4 * c + ei + ((m >> j) & 1)];
      }
    }
    return bad ? NAN : acc + c0v;
  }
};

// One tile of a group: grid (tiles, k).  With one tile a group the result
// goes straight to (vals, idx, second); otherwise to parts[g * tiles + t].
template <class Source>
__global__ void __launch_bounds__(kThreads)
topk_tiles(Source src, int64_t N, int64_t G, int64_t tile, Top2* __restrict__ parts,
           float* __restrict__ vals, int64_t* __restrict__ idx, float* __restrict__ second) {
  src.stage();
  __syncthreads();
  const int64_t g = blockIdx.y, t = blockIdx.x;
  const int64_t start = g * G + t * tile;
  const int64_t end = min64(start + tile, (g + 1) * G);
  Top2 x = top2_empty();
  for (int64_t n = start + threadIdx.x; n < end; n += blockDim.x)
    x = merge(x, {n < N ? src.value(n) : -INFINITY, -INFINITY, n});
  x = block_merge(x);
  if (threadIdx.x != 0) return;
  if (gridDim.x == 1) {
    vals[g] = x.v1;
    idx[g] = x.i1;
    second[g] = x.v2;
  } else {
    parts[g * gridDim.x + t] = x;
  }
}

// One warp a group folds the group's tile partials.
__global__ void topk_merge(const Top2* __restrict__ parts, int tiles, float* __restrict__ vals,
                           int64_t* __restrict__ idx, float* __restrict__ second) {
  const int64_t g = blockIdx.x;
  Top2 x = top2_empty();
  for (int t = threadIdx.x; t < tiles; t += 32) x = merge(x, parts[g * tiles + t]);
  x = warp_merge(x);
  if (threadIdx.x == 0) {
    vals[g] = x.v1;
    idx[g] = x.i1;
    second[g] = x.v2;
  }
}

// Every score of a source, one per candidate (the combo kernel's k = 0 form).
template <class Source>
__global__ void __launch_bounds__(kThreads)
all_scores(Source src, int64_t N, int64_t per_block, float* __restrict__ out) {
  src.stage();
  __syncthreads();
  const int64_t start = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = min64(start + per_block, N);
  for (int64_t n = start + threadIdx.x; n < end; n += blockDim.x) out[n] = src.value(n);
}

__global__ void gather_v4(const float* __restrict__ F, int64_t f_numel,
                          const int64_t* __restrict__ idx4, int64_t n, float* __restrict__ v4) {
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; q < n;
       q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = idx4[q];
    v4[q] = (i >= 0 && i < f_numel) ? F[i] : NAN;
  }
}

template <class Source>
cudaError_t launch_topk(Source src, size_t smem, int64_t N, int k, int64_t tile, void* parts,
                        float* vals, int64_t* idx, float* second, cudaStream_t stream) {
  const int64_t G = (N + k - 1) / k;
  const int64_t tiles = (G + tile - 1) / tile;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&topk_tiles<Source>), smem);
  if (err != cudaSuccess) return err;
  topk_tiles<Source><<<dim3(static_cast<unsigned>(tiles), k), kThreads, smem, stream>>>(
      src, N, G, tile, static_cast<Top2*>(parts), vals, idx, second);
  if (tiles > 1)
    topk_merge<<<k, 32, 0, stream>>>(static_cast<const Top2*>(parts), static_cast<int>(tiles),
                                      vals, idx, second);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// block_score
//
// Per order b of S ids (ids may repeat): offsets from the sizes prefix, the
// P*4 values fv[p*4 + e] = F[((s_i*Sp + s_j)*4 + e)*(C+1) + offs_j - offs_i]
// for every position pair p = (i < j), then for every orientation row r
// cost[b, r] = sum_p fv[p*4 + e(r, p)] + c0.
//
// What bounds it on this card: the gathers.  Each order reads P*4 scattered
// table values, and every orientation row reuses them; the XLA program
// fetches them once too and applies the orientation rows as a one-hot [P*4, R]
// matrix product.  Here one block owns one order: it gathers its P*4 values
// into shared memory, and each thread sums one orientation row's P selected
// values, its selector computed from the row's bits: no one-hot matrix, no
// matrix product.
// ---------------------------------------------------------------------------

constexpr int kBlockThreads = 128;

__global__ void __launch_bounds__(kBlockThreads)
block_score_kernel(const float* __restrict__ F, int64_t Cp1, const int64_t* __restrict__ sizes,
                   int Sp, const int32_t* __restrict__ orders, int S,
                   const int32_t* __restrict__ orients, int R, const float* __restrict__ c0,
                   float* __restrict__ costs) {
  const int P = S * (S - 1) / 2;
  float* fv = reinterpret_cast<float*>(dyn_smem);              // [P * 4]
  uint32_t* masks = reinterpret_cast<uint32_t*>(fv + 4 * P);   // [R]
  int32_t* ids = reinterpret_cast<int32_t*>(masks + R);        // [S]
  int32_t* offs = ids + S;                                      // [S]
  __shared__ int bad_order;
  const int64_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    int64_t o = 0;
    int bad = 0;
    for (int q = 0; q < S; ++q) {
      const int32_t id = orders[b * S + q];
      bad |= id < 0 || id >= Sp;
      ids[q] = bad ? 0 : id;
      offs[q] = static_cast<int32_t>(o);
      o += bad ? 0 : sizes[ids[q]];
      bad |= o >= Cp1;
    }
    bad_order = bad;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    uint32_t m = 0;
    for (int q = 0; q < S; ++q) {
      const int32_t f = orients[static_cast<int64_t>(r) * S + q];
      m |= (f & ~1) ? 0x80000000u : static_cast<uint32_t>(f) << q;
    }
    masks[r] = m;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 4 * P; q += blockDim.x) {
    int p = q >> 2, i = 0, row_len = S - 1;
    while (p >= row_len) {
      p -= row_len;
      ++i;
      --row_len;
    }
    const int j = i + 1 + p;
    const int64_t row = (static_cast<int64_t>(ids[i]) * Sp + ids[j]) * 4 + (q & 3);
    fv[q] = bad_order ? 0.0f : F[row * Cp1 + (offs[j] - offs[i])];
  }
  __syncthreads();
  const float c0v = *c0;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const uint32_t m = masks[r];
    float acc = 0.0f;
    int p = 0;
    for (int i = 0; i < S - 1; ++i) {
      const int ei = ((m >> i) & 1) * 2;
      for (int j = i + 1; j < S; ++j, ++p) acc += fv[4 * p + ei + ((m >> j) & 1)];
    }
    costs[b * R + r] = (bad_order || (m >> 31)) ? NAN : acc + c0v;
  }
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

// M: float32 [C, C] row-major; sizes: int64 [Sp]; h: float32 [4*Sp*Sp, 2*cmax - 1].
extern "C" int pair_profiles(const float* M, int C, const int64_t* sizes, int Sp, int cmax,
                             float* h, cudaStream_t stream) {
  if (C < 1 || Sp < 1 || Sp > 65535 || cmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int L = 2 * cmax - 1;
  const size_t acc = sizeof(float) * 2 * L;
  int rows = 16;  // staged rows: as many as fit the default 48 KB, at least one
  while (rows > 1 && acc + sizeof(float) * rows * cmax > static_cast<size_t>(kSmemDefault))
    rows /= 2;
  const size_t smem = acc + sizeof(float) * rows * cmax;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&pair_profiles_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_profiles_kernel<<<dim3(Sp, Sp), kThreads, smem, stream>>>(M, C, sizes, Sp, cmax, rows, h);
  return static_cast<int>(cudaGetLastError());
}

// Combo scores of Bo orders x R orientations.  k == 0: every score into
// costs [Bo, R].  k > 0: the group top-k into vals/idx/second [k] (parts:
// k * ceil(ceil(N / k) / tile) 16-byte partials when a group spans tiles).
// v4: float32 scratch [n_combo * 4].
extern "C" int combo_score_topk(const float* F, int64_t f_numel, const int64_t* idx4,
                                int n_combo, const int32_t* cid, int64_t Bo,
                                const int32_t* orients, int R, int S, const float* c0, int k,
                                int64_t tile, float* v4, void* parts, float* costs, float* vals,
                                int64_t* idx, float* second, cudaStream_t stream) {
  if (n_combo < 1 || Bo < 1 || R < 1 || S < 2 || S > 31 || k < 0 || k > 65535 || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = 4 * static_cast<int64_t>(n_combo);
  gather_v4<<<static_cast<unsigned>(std::min<int64_t>((n4 + kThreads - 1) / kThreads, 1024)),
              kThreads, 0, stream>>>(F, f_numel, idx4, n4, v4);
  ComboSource src{v4, cid, orients, c0, n_combo, R, S, nullptr, nullptr, 0.0f};
  const size_t smem = sizeof(float) * n4 + sizeof(uint32_t) * R;
  const int64_t N = Bo * R;
  if (k > 0) return static_cast<int>(launch_topk(src, smem, N, k, tile, parts, vals, idx,
                                                 second, stream));
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&all_scores<ComboSource>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (N + tile - 1) / tile;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  all_scores<ComboSource><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      src, N, tile, costs);
  return static_cast<int>(cudaGetLastError());
}

// The group top-k of the float32 scores x [N] in k groups (see combo_score_topk).
extern "C" int group_topk(const float* x, int64_t N, int k, int64_t tile, void* parts,
                          float* vals, int64_t* idx, float* second, cudaStream_t stream) {
  if (N < 1 || k < 1 || k > 65535 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_topk(MemorySource{x}, 0, N, k, tile, parts, vals, idx, second,
                                      stream));
}

// orders: int32 [Bo, S]; orients: int32 [R, S]; costs: float32 [Bo, R].
extern "C" int block_score(const float* F, int64_t Cp1, const int64_t* sizes, int Sp,
                           const int32_t* orders, int Bo, int S, const int32_t* orients, int R,
                           const float* c0, float* costs, cudaStream_t stream) {
  if (Bo < 1 || S < 1 || S > 31 || R < 1 || Sp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int P = S * (S - 1) / 2;
  const size_t smem = sizeof(float) * 4 * P + sizeof(uint32_t) * R + sizeof(int32_t) * 2 * S;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&block_score_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_score_kernel<<<Bo, kBlockThreads, smem, stream>>>(F, Cp1, sizes, Sp, orders, S, orients,
                                                          R, c0, costs);
  return static_cast<int>(cudaGetLastError());
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
