// The 2-state HMM's time recursions, for Hopper (sm_90a), in float64.
//
// Replaces the XLA scans of hic_genome_assembler_tpu/ops/gaussian_hmm.py:
//   hmm_forward_backward  <- _forward_backward (:61-93), the unmasked form of
//                            fb in _fit_predict_masked (:159-194)
//   hmm_viterbi           <- _viterbi (:263-280), vstep + backtrack in
//                            _fit_predict_masked (:215-231)
// Inputs are log_b [T, 2] (per-frame log-densities), log_start [2] and
// log_trans [2, 2], all row-major float64 on the device.
//
// Every log-sum-exp is the JAX package's _logsumexp over two values: shift by
// the max, but by 0 when the max is not finite, so that a pair of -inf (a
// transmat entry the M step set to 0) gives -inf and not NaN.
//
// The algebra.  With A_t[i][j] = log_trans[i][j] + log_b[t][j]:
//   alpha_t = alpha_{t-1} (x) A_t          (forward, a row vector)
//   beta_t  = A_{t+1} (x) beta_{t+1}       (backward, a column vector)
//   delta_t = delta_{t-1} (x) A_t          (Viterbi, max in place of lse)
// where (X (x) Y)[i][j] = lse_k(X[i][k] + Y[k][j]) is the log-semiring
// product (max-plus for Viterbi).  Both products are associative, so each
// recursion is a scan over 2x2 matrices, and forward and backward scan the
// same matrices A_1 .. A_{T-1}, once from each end.
//
// What bounds it on this card: a one-thread recursion is bound by the latency
// of T dependent steps (f64 exp/log are software FMA chains); the bytes (16 a
// step) and the FLOPs are nothing.  So the design is a chunked parallel scan
// in one block of P threads (512 for forward-backward, 1024 for Viterbi):
//   1. each thread owns a chunk of about (T-1)/P consecutive steps and
//      forms the 2x2 product of its A_t (four independent lse2 a step, which
//      gives the chain instruction-level parallelism; an empty chunk holds the
//      identity [[0, -inf], [-inf, 0]]);
//   2. an exclusive prefix scan and an exclusive suffix scan of the chunk
//      products over the block: warp shuffles, then the warps' totals in
//      warp 0 (log2 P levels, at most 1 KB of shared memory);
//   3. each thread re-walks its chunk from alpha_0 (x) prefix and from
//      suffix (x) 0 with the one-step arithmetic of the sequential recursion,
//      forward and backward interleaved, and writes alpha and beta to scratch;
//   4. gamma, the xi sums and the log-likelihood over the whole block.
// Viterbi adds a parallel backtrack: the re-walk writes the backpointers and
// composes its chunk's map {end state -> start state}; a suffix scan of
// those maps (exact integer work) gives each chunk its end state, and each
// chunk writes its own stretch of the path.
//
// Only the association of the f64 sums changes against the sequential JAX
// scan: the log-likelihood moves by about 1e-14 relative, gamma and the xi
// sums by 1e-11 or less at T in the ten thousands.  Viterbi decisions move
// only if two candidate scores tie to within rounding (~1e-10 at T ~ 1e5);
// exact ties in exactly representable inputs keep the tie rule.  The whole
// block lives on one SM, so the scan is bound by that SM's f64 rate (the
// exp/log sequences of ~4 lse2 a step in each phase, and the scans' fixed
// log2 P levels at small T), not by the card; one block suffices for T up to
// the genome's bins (17K at the north star).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads a block: forward-backward's four-lse2 steps need more than the 64
// registers a thread that 1024 threads leave (they spill there), and
// Viterbi's cheap steps gain from the shorter chunks of 1024.
constexpr int kFbThreads = 512;
constexpr int kViterbiThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double safe_shift(double m) { return isfinite(m) ? m : 0.0; }

// _logsumexp of {a, b}: max, safe shift, log of the sum of the two exps.
__device__ __forceinline__ double lse2(double a, double b) {
  const double m = safe_shift(fmax(a, b));
  return m + log(exp(a - m) + exp(b - m));
}

// A 2x2 matrix [[a, b], [c, d]].
struct M2 {
  double a, b, c, d;
};

// The log semiring (forward-backward) and the max-plus semiring (Viterbi).
struct LogSemiring {
  __device__ static double add(double x, double y) { return lse2(x, y); }
};
struct MaxPlus {
  __device__ static double add(double x, double y) { return fmax(x, y); }
};

template <class S>
__device__ __forceinline__ M2 mat_mul(const M2& x, const M2& y) {
  return {S::add(x.a + y.a, x.b + y.c), S::add(x.a + y.b, x.b + y.d),
          S::add(x.c + y.a, x.d + y.c), S::add(x.c + y.b, x.d + y.d)};
}

// M (x) A_t, with log_b[t] = (b0, b1) factored out of the sum:
// (M (x) A_t)[i][j] = add_k(M[i][k] + lt[k][j]) + b_j.
template <class S>
__device__ __forceinline__ M2 mat_step(const M2& m, const M2& lt, double b0, double b1) {
  return {S::add(m.a + lt.a, m.b + lt.c) + b0, S::add(m.a + lt.b, m.b + lt.d) + b1,
          S::add(m.c + lt.a, m.d + lt.c) + b0, S::add(m.c + lt.b, m.d + lt.d) + b1};
}

__device__ __forceinline__ M2 identity(M2) { return {0.0, -INFINITY, -INFINITY, 0.0}; }

__device__ __forceinline__ M2 shfl_up(const M2& v, int o) {
  return {__shfl_up_sync(kFull, v.a, o), __shfl_up_sync(kFull, v.b, o),
          __shfl_up_sync(kFull, v.c, o), __shfl_up_sync(kFull, v.d, o)};
}

__device__ __forceinline__ M2 shfl_down(const M2& v, int o) {
  return {__shfl_down_sync(kFull, v.a, o), __shfl_down_sync(kFull, v.b, o),
          __shfl_down_sync(kFull, v.c, o), __shfl_down_sync(kFull, v.d, o)};
}

// A map of the two states {0, 1} onto themselves: bit x holds the image of x.
struct Map2 {
  int bits;
};

__device__ __forceinline__ Map2 identity(Map2) { return {0b10}; }
__device__ __forceinline__ int apply(Map2 f, int x) { return (f.bits >> x) & 1; }
// (f o h)(x) = f(h(x))
__device__ __forceinline__ Map2 compose(Map2 f, Map2 h) {
  return {apply(f, apply(h, 0)) | (apply(f, apply(h, 1)) << 1)};
}
__device__ __forceinline__ Map2 shfl_up(Map2 v, int o) { return {__shfl_up_sync(kFull, v.bits, o)}; }
__device__ __forceinline__ Map2 shfl_down(Map2 v, int o) {
  return {__shfl_down_sync(kFull, v.bits, o)};
}

// Exclusive scan over a block of kThreads, in thread order: x_0 (x) .. (x)
// x_{i-1} for thread i (kSuffix false), or x_{i+1} (x) .. (x) x_{last}
// (kSuffix true), each thread holding one x.  `mul(earlier, later)` is the
// associative product; `sh` holds kThreads / 32 values.  Every thread of the
// block must call it.
template <int kThreads, bool kSuffix, class V, class Mul>
__device__ V block_exclusive_scan(V x, Mul mul, V* sh) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const V id = identity(x);
  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    if constexpr (kSuffix) {
      const V later = shfl_down(x, o);
      if (lane + o < 32) x = mul(x, later);
    } else {
      const V earlier = shfl_up(x, o);
      if (lane >= o) x = mul(earlier, x);
    }
  }
  if (lane == (kSuffix ? 0 : 31)) sh[warp] = x;  // the warp's total
  __syncthreads();
  if (warp == 0) {
    // inclusive scan of the warps' totals
    V w = lane < kWarps ? sh[lane] : id;
    for (int o = 1; o < 32; o <<= 1) {
      if constexpr (kSuffix) {
        const V later = shfl_down(w, o);
        if (lane + o < 32) w = mul(w, later);
      } else {
        const V earlier = shfl_up(w, o);
        if (lane >= o) w = mul(earlier, w);
      }
    }
    if (lane < kWarps) sh[lane] = w;
  }
  __syncthreads();
  V out;
  if constexpr (kSuffix) {
    const V within = shfl_down(x, 1);
    out = lane < 31 ? within : id;
    if (warp < kWarps - 1) out = mul(out, sh[warp + 1]);
  } else {
    const V within = shfl_up(x, 1);
    out = lane > 0 ? within : id;
    if (warp > 0) out = mul(sh[warp - 1], out);
  }
  __syncthreads();  // sh may be reused by the caller
  return out;
}

// This thread's chunk [s, e) of the steps 1 .. T-1, split as evenly as a
// block of kThreads allows; an empty chunk has s == e.
template <int kThreads>
__device__ __forceinline__ void chunk_of(int T, int64_t& s, int64_t& e) {
  const int64_t steps = static_cast<int64_t>(T) - 1;
  const int64_t base = steps / kThreads, extra = steps % kThreads;
  const int64_t c = threadIdx.x;
  s = 1 + c * base + (c < extra ? c : extra);
  e = s + base + (c < extra ? 1 : 0);
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide reduction of 4 values (max or sum) over kThreads; every thread
// gets the result.
template <int kThreads, bool kMax>
__device__ void block_reduce4(double v[4], double (*smem)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = kMax ? warp_max(v[k]) : warp_sum(v[k]);
    if (lane == 0) smem[warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    double r = smem[0][k];
    for (int w = 1; w < kThreads / 32; ++w) r = kMax ? fmax(r, smem[w][k]) : r + smem[w][k];
    v[k] = r;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kFbThreads, 1)
forward_backward_kernel(const double* __restrict__ log_b, const double* __restrict__ log_start,
                        const double* __restrict__ log_trans, int T,
                        double* __restrict__ alpha, double* __restrict__ beta,
                        double* __restrict__ gamma, double* __restrict__ xi_sum,
                        double* __restrict__ logprob) {
  constexpr int kThreads = kFbThreads;
  __shared__ M2 sh_scan[kThreads / 32];
  __shared__ double smem[kThreads / 32][4];
  const M2 lt = {log_trans[0], log_trans[1], log_trans[2], log_trans[3]};
  const auto log_mul = [](const M2& x, const M2& y) { return mat_mul<LogSemiring>(x, y); };
  int64_t s, e;
  chunk_of<kThreads>(T, s, e);

  // 1. the product of this chunk's A_t
  M2 prod = identity(M2{});
#pragma unroll 2
  for (int64_t t = s; t < e; ++t) prod = mat_step<LogSemiring>(prod, lt, log_b[2 * t], log_b[2 * t + 1]);

  // 2. the products of the chunks before and after this one
  const M2 pre = block_exclusive_scan<kThreads, false>(prod, log_mul, sh_scan);
  const M2 suf = block_exclusive_scan<kThreads, true>(prod, log_mul, sh_scan);

  // 3. re-walk: alpha_t for t in [s, e) from alpha_{s-1} = alpha_0 (x) pre;
  // beta_{t-1} for t in (e, s] from beta_{e-1} = suf (x) 0, interleaved
  const double a00 = log_start[0] + log_b[0], a01 = log_start[1] + log_b[1];
  if (threadIdx.x == 0) {
    alpha[0] = a00;
    alpha[1] = a01;
    beta[2 * (static_cast<int64_t>(T) - 1)] = 0.0;
    beta[2 * (static_cast<int64_t>(T) - 1) + 1] = 0.0;
  }
  if (s < e) {
    double a0 = lse2(a00 + pre.a, a01 + pre.c), a1 = lse2(a00 + pre.b, a01 + pre.d);
    double b0 = lse2(suf.a, suf.b), b1 = lse2(suf.c, suf.d);
    for (int64_t k = 0; k < e - s; ++k) {
      // nxt[j] = _logsumexp_i(alpha[i] + log_trans[i, j]) + log_b[t, j]
      const int64_t t = s + k;
      const double n0 = lse2(a0 + lt.a, a1 + lt.c) + log_b[2 * t];
      const double n1 = lse2(a0 + lt.b, a1 + lt.d) + log_b[2 * t + 1];
      a0 = n0;
      a1 = n1;
      alpha[2 * t] = a0;
      alpha[2 * t + 1] = a1;
      // prev[i] = _logsumexp_j(log_trans[i, j] + (log_b[u, j] + beta[u, j])), u = e-1-k
      const int64_t u = e - 1 - k;
      const double c0 = log_b[2 * u] + b0, c1 = log_b[2 * u + 1] + b1;
      b0 = lse2(lt.a + c0, lt.b + c1);
      b1 = lse2(lt.c + c0, lt.d + c1);
      beta[2 * (u - 1)] = b0;
      beta[2 * (u - 1) + 1] = b1;
    }
  }
  __syncthreads();

  // 4. the log-likelihood, gamma, and the xi sums, over the block.
  const int64_t last = static_cast<int64_t>(T) - 1;
  const double lp = lse2(alpha[2 * last], alpha[2 * last + 1]);
  if (threadIdx.x == 0) *logprob = lp;
  for (int64_t t = threadIdx.x; t <= last; t += kThreads) {
    const double g0 = alpha[2 * t] + beta[2 * t] - lp;
    const double g1 = alpha[2 * t + 1] + beta[2 * t + 1] - lp;
    const double norm = lse2(g0, g1);
    gamma[2 * t] = exp(g0 - norm);
    gamma[2 * t + 1] = exp(g1 - norm);
  }

  // log_xi[t, i, j] = alpha[t, i] + log_trans[i, j] + (log_b[t+1, j] + beta[t+1, j]) - lp,
  // then xi_sum[i, j] = exp(_logsumexp over t): a max pass, then a sum pass.
  const double ltk[4] = {lt.a, lt.b, lt.c, lt.d};
  double m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int64_t t = threadIdx.x; t < last; t += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = k >> 1, j = k & 1;
      const double x = alpha[2 * t + i] + ltk[k] + (log_b[2 * (t + 1) + j] + beta[2 * (t + 1) + j]) - lp;
      m[k] = fmax(m[k], x);
    }
  }
  block_reduce4<kThreads, true>(m, smem);
  double sum[4] = {0.0, 0.0, 0.0, 0.0};
  for (int k = 0; k < 4; ++k) m[k] = safe_shift(m[k]);
  for (int64_t t = threadIdx.x; t < last; t += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = k >> 1, j = k & 1;
      const double x = alpha[2 * t + i] + ltk[k] + (log_b[2 * (t + 1) + j] + beta[2 * (t + 1) + j]) - lp;
      sum[k] += exp(x - m[k]);
    }
  }
  block_reduce4<kThreads, false>(sum, smem);
  if (threadIdx.x < 4) xi_sum[threadIdx.x] = exp(m[threadIdx.x] + log(sum[threadIdx.x]));
}

__global__ void __launch_bounds__(kViterbiThreads, 1)
viterbi_kernel(const double* __restrict__ log_b, const double* __restrict__ log_start,
               const double* __restrict__ log_trans, int T, uint8_t* __restrict__ backptr,
               int32_t* __restrict__ path) {
  constexpr int kThreads = kViterbiThreads;
  __shared__ M2 sh_scan[kThreads / 32];
  __shared__ Map2 sh_maps[kThreads / 32];
  __shared__ int sh_last;
  const M2 lt = {log_trans[0], log_trans[1], log_trans[2], log_trans[3]};
  int64_t s, e;
  chunk_of<kThreads>(T, s, e);

  // 1. the max-plus product of this chunk's A_t, then 2. the products before it
  M2 prod = identity(M2{});
#pragma unroll 4
  for (int64_t t = s; t < e; ++t) prod = mat_step<MaxPlus>(prod, lt, log_b[2 * t], log_b[2 * t + 1]);
  const M2 pre = block_exclusive_scan<kThreads, false>(
      prod, [](const M2& x, const M2& y) { return mat_mul<MaxPlus>(x, y); }, sh_scan);

  // 3. re-walk from delta_{s-1} = delta_0 (x) pre: write the backpointers and
  // compose this chunk's map from the state at e-1 to the state at s-1
  const double d00 = log_start[0] + log_b[0], d01 = log_start[1] + log_b[1];
  Map2 map = identity(Map2{});
  if (s < e) {
    double d0 = fmax(d00 + pre.a, d01 + pre.c), d1 = fmax(d00 + pre.b, d01 + pre.d);
#pragma unroll 4
    for (int64_t t = s; t < e; ++t) {
      // scores[i, j] = delta[i] + log_trans[i, j]; argmax over i (state 0 wins
      // a tie, as jnp.argmax), max over i plus log_b[t, j]
      const double s00 = d0 + lt.a, s10 = d1 + lt.c;
      const double s01 = d0 + lt.b, s11 = d1 + lt.d;
      const int up0 = s10 > s00, up1 = s11 > s01;
      backptr[2 * (t - 1)] = up0;
      backptr[2 * (t - 1) + 1] = up1;
      d0 = (up0 ? s10 : s00) + log_b[2 * t];
      d1 = (up1 ? s11 : s01) + log_b[2 * t + 1];
      map = compose(map, Map2{up0 | (up1 << 1)});
    }
    if (e == T) sh_last = d1 > d0 ? 1 : 0;  // the last frame's state
  }
  if (T == 1 && threadIdx.x == 0) sh_last = d01 > d00 ? 1 : 0;

  // 4. the state at e-1: the maps of the chunks after this one, composed
  const Map2 after = block_exclusive_scan<kThreads, true>(  // syncs: sh_last is set
      map, [](Map2 f, Map2 h) { return compose(f, h); }, sh_maps);
  const int last = sh_last;
  if (threadIdx.x == 0) path[T - 1] = last;
  if (s < e) {
    int state = apply(after, last);
    for (int64_t t = e - 1; t >= s; --t) {
      state = backptr[2 * (t - 1) + state];
      path[t - 1] = state;
    }
  }
}

}  // namespace

// log_b: float64 [T, 2]; log_start: [2]; log_trans: [2, 2]; scratch: float64
// [2, T, 2] (alpha, then beta); gamma: float64 [T, 2]; xi_sum: [2, 2];
// logprob: [1].  All pointers on the device, contiguous.  Launches one block on
// `stream` and returns the launch status; does not synchronise.
extern "C" int hmm_forward_backward(const double* log_b, const double* log_start,
                                    const double* log_trans, int T, double* scratch,
                                    double* gamma, double* xi_sum, double* logprob,
                                    cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  forward_backward_kernel<<<1, kFbThreads, 0, stream>>>(
      log_b, log_start, log_trans, T, scratch, scratch + 2 * static_cast<int64_t>(T), gamma,
      xi_sum, logprob);
  return static_cast<int>(cudaGetLastError());
}

// log_b: float64 [T, 2]; log_start: [2]; log_trans: [2, 2]; scratch: uint8
// [max(T - 1, 1), 2] backpointers; path: int32 [T].  As above.
extern "C" int hmm_viterbi(const double* log_b, const double* log_start, const double* log_trans,
                           int T, uint8_t* scratch, int32_t* path, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_kernel<<<1, kViterbiThreads, 0, stream>>>(log_b, log_start, log_trans, T, scratch, path);
  return static_cast<int>(cudaGetLastError());
}
