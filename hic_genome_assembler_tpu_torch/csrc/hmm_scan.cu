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
// What bounds it on this card: latency, not bandwidth or arithmetic.  Step t
// of a scan needs step t-1, and each step is a chain of float64 exp and log
// (software sequences of dependent FMAs), so a scan is one thread walking T
// steps; T is at most the genome's bins (17K at the north star), so the bytes
// (16 per step) are nothing.  What the design does about it: the forward and
// the backward scan run at the same time in two warps of one block; the two
// target states of a step are independent, which gives the chain some
// instruction-level parallelism; everything after the scans (gamma, the xi
// sums, the log-likelihood) is spread over the whole block.  alpha and beta
// live in global scratch given by the caller: they are written once and read
// once, from L2.
//
// Simple first: one block, no cross-step parallelism (a parallel-prefix form
// over the log-semiring would change the summation order against the JAX
// reference).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double safe_shift(double m) { return isfinite(m) ? m : 0.0; }

// _logsumexp of {a, b}: max, safe shift, log of the sum of the two exps.
__device__ __forceinline__ double lse2(double a, double b) {
  const double m = safe_shift(fmax(a, b));
  return m + log(exp(a - m) + exp(b - m));
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction of 4 values (max or sum); every thread gets the result.
template <bool kMax>
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
    for (int w = 1; w < kWarps; ++w) r = kMax ? fmax(r, smem[w][k]) : r + smem[w][k];
    v[k] = r;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
forward_backward_kernel(const double* __restrict__ log_b, const double* __restrict__ log_start,
                        const double* __restrict__ log_trans, int T,
                        double* __restrict__ alpha, double* __restrict__ beta,
                        double* __restrict__ gamma, double* __restrict__ xi_sum,
                        double* __restrict__ logprob) {
  __shared__ double smem[kWarps][4];
  const double lt00 = log_trans[0], lt01 = log_trans[1];
  const double lt10 = log_trans[2], lt11 = log_trans[3];

  // Phase 1: forward scan in warp 0, backward scan in warp 1, one lane each.
  if (threadIdx.x == 0) {
    double a0 = log_start[0] + log_b[0], a1 = log_start[1] + log_b[1];
    alpha[0] = a0;
    alpha[1] = a1;
#pragma unroll 4
    for (int t = 1; t < T; ++t) {
      // nxt[j] = _logsumexp_i(alpha[i] + log_trans[i, j]) + log_b[t, j]
      const double n0 = lse2(a0 + lt00, a1 + lt10) + log_b[2 * t];
      const double n1 = lse2(a0 + lt01, a1 + lt11) + log_b[2 * t + 1];
      a0 = n0;
      a1 = n1;
      alpha[2 * t] = a0;
      alpha[2 * t + 1] = a1;
    }
  } else if (threadIdx.x == 32) {
    double b0 = 0.0, b1 = 0.0;
    beta[2 * (T - 1)] = 0.0;
    beta[2 * (T - 1) + 1] = 0.0;
#pragma unroll 4
    for (int t = T - 2; t >= 0; --t) {
      // prev[i] = _logsumexp_j(log_trans[i, j] + (log_b[t+1, j] + beta[j]))
      const double c0 = log_b[2 * (t + 1)] + b0, c1 = log_b[2 * (t + 1) + 1] + b1;
      b0 = lse2(lt00 + c0, lt01 + c1);
      b1 = lse2(lt10 + c0, lt11 + c1);
      beta[2 * t] = b0;
      beta[2 * t + 1] = b1;
    }
  }
  __syncthreads();

  // Phase 2: the log-likelihood, gamma, and the xi sums, over the block.
  const double lp = lse2(alpha[2 * (T - 1)], alpha[2 * (T - 1) + 1]);
  if (threadIdx.x == 0) *logprob = lp;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const double g0 = alpha[2 * t] + beta[2 * t] - lp;
    const double g1 = alpha[2 * t + 1] + beta[2 * t + 1] - lp;
    const double norm = lse2(g0, g1);
    gamma[2 * t] = exp(g0 - norm);
    gamma[2 * t + 1] = exp(g1 - norm);
  }

  // log_xi[t, i, j] = alpha[t, i] + log_trans[i, j] + (log_b[t+1, j] + beta[t+1, j]) - lp,
  // then xi_sum[i, j] = exp(_logsumexp over t): a max pass, then a sum pass.
  const double lt[4] = {lt00, lt01, lt10, lt11};
  double m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int t = threadIdx.x; t < T - 1; t += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = k >> 1, j = k & 1;
      const double x = alpha[2 * t + i] + lt[k] + (log_b[2 * (t + 1) + j] + beta[2 * (t + 1) + j]) - lp;
      m[k] = fmax(m[k], x);
    }
  }
  block_reduce4<true>(m, smem);
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int k = 0; k < 4; ++k) m[k] = safe_shift(m[k]);
  for (int t = threadIdx.x; t < T - 1; t += kThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = k >> 1, j = k & 1;
      const double x = alpha[2 * t + i] + lt[k] + (log_b[2 * (t + 1) + j] + beta[2 * (t + 1) + j]) - lp;
      s[k] += exp(x - m[k]);
    }
  }
  block_reduce4<false>(s, smem);
  if (threadIdx.x < 4) xi_sum[threadIdx.x] = exp(m[threadIdx.x] + log(s[threadIdx.x]));
}

__global__ void viterbi_kernel(const double* __restrict__ log_b, const double* __restrict__ log_start,
                               const double* __restrict__ log_trans, int T,
                               uint8_t* __restrict__ backptr, int32_t* __restrict__ path) {
  if (threadIdx.x != 0) return;
  const double lt00 = log_trans[0], lt01 = log_trans[1];
  const double lt10 = log_trans[2], lt11 = log_trans[3];
  double d0 = log_start[0] + log_b[0], d1 = log_start[1] + log_b[1];
#pragma unroll 4
  for (int t = 1; t < T; ++t) {
    // scores[i, j] = delta[i] + log_trans[i, j]; argmax over i (state 0 wins
    // a tie, as jnp.argmax), max over i plus log_b[t, j]
    const double s00 = d0 + lt00, s10 = d1 + lt10;
    const double s01 = d0 + lt01, s11 = d1 + lt11;
    const bool up0 = s10 > s00, up1 = s11 > s01;
    backptr[2 * (t - 1)] = up0;
    backptr[2 * (t - 1) + 1] = up1;
    d0 = (up0 ? s10 : s00) + log_b[2 * t];
    d1 = (up1 ? s11 : s01) + log_b[2 * t + 1];
  }
  int state = d1 > d0 ? 1 : 0;
  path[T - 1] = state;
  for (int t = T - 2; t >= 0; --t) {
    state = backptr[2 * t + state];
    path[t] = state;
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
  forward_backward_kernel<<<1, kThreads, 0, stream>>>(
      log_b, log_start, log_trans, T, scratch, scratch + 2 * static_cast<int64_t>(T), gamma,
      xi_sum, logprob);
  return static_cast<int>(cudaGetLastError());
}

// log_b: float64 [T, 2]; log_start: [2]; log_trans: [2, 2]; scratch: uint8
// [max(T - 1, 1), 2] backpointers; path: int32 [T].  As above.
extern "C" int hmm_viterbi(const double* log_b, const double* log_start, const double* log_trans,
                           int T, uint8_t* scratch, int32_t* path, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  viterbi_kernel<<<1, 32, 0, stream>>>(log_b, log_start, log_trans, T, scratch, path);
  return static_cast<int>(cudaGetLastError());
}
