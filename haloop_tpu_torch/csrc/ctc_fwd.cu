// CTC forward lattice: per-utterance negative log-likelihood.
//
// Replaces: haloop_tpu/ops/ctc_pallas.py _ctc_fwd_kernel (launched by
// _fwd_call, entry ctc_loss_pallas), the forward half of the fused CTC
// loss. Plain version: haloop_tpu_torch/ops/ctc.py ctc_forward_score.
//
// Computes the log-space alpha recursion over the S' = 2U+1 states of the
// blank-interspersed targets (blank = 0):
//   alpha_0[s]  = em_0[s] for s < 2, NEG otherwise
//   alpha_t[s]  = lse(alpha[s], alpha[s-1], alpha[s-2] + skip_mask[s])
//                 + em_t[s]                        for t < input_length
//   (the skip from s-2 is allowed only into a label state whose label
//   differs from the one at s-2), frozen for t >= input_length, and
//   loss = -lse(alpha[2u], alpha[2u-1]) (state 0 alone when u = 0).
// Masked entries use the TPU kernel's big-finite NEG = -1e9, so an
// infeasible item (too few frames for its labels) gives a loss of about
// 1e9, finite, never inf or NaN.
//
// What bounds it on the H100: the T steps are sequential and each is a
// 3-point stencil over at most 4096 states, so the lattice is latency
// bound (one emission load and one block barrier per step), not bound by
// bytes or FLOPs: at N=48, T'=385, S'=193 it touches ~3.5 MB.
//
// This design: one block per utterance, each thread the states tid,
// tid + blockDim, ... (PER of them, a template parameter: 1 up to 1024
// states, then 2 and 4: at most 1024 threads, 4096 states);
// alpha is double-buffered in shared memory and the block steps through
// time with __syncthreads(). The emissions are gathered inside the kernel
// straight from the (T, N, C) log-probs, one step ahead of their use, so
// the (N, T, S') tensor the TPU path builds with a one-hot matmul never
// exists. The alpha history (N, T, S'), which the backward lattice
// needs, is written only when the caller passes a buffer for it.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e9f;
constexpr int MAX_STATES = 4096;
constexpr int MAX_PER = 4;          // states a thread, at 1024 threads

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

template <int PER>
__global__ void ctc_fwd(const float* __restrict__ log_probs,   // (T, N, C)
                        const int* __restrict__ targets,        // (N, U)
                        const int* __restrict__ input_lengths,  // (N,)
                        const int* __restrict__ target_lengths, // (N,)
                        float* __restrict__ loss,               // (N,)
                        float* __restrict__ hist,   // (N, T, S) or null
                        int T, int N, int C, int U) {
  extern __shared__ float alpha[];   // 2 * PER * blockDim.x
  const int n = blockIdx.x;
  const int S = 2 * U + 1;
  const int nt = blockDim.x;
  const int* tg = targets + (size_t)n * U;

  // each state's label (clamped into the vocabulary, like a gather) and
  // whether the skip from s-2 is allowed into it
  float skip_mask[PER];
  const float* em[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = threadIdx.x + k * nt;
    int label = 0;
    bool skip = false;
    if (s < S && (s & 1)) {
      label = min(max(tg[s / 2], 0), C - 1);
      const int prev = s >= 3 ? min(max(tg[s / 2 - 1], 0), C - 1) : -1;
      skip = label != 0 && label != prev;
    }
    skip_mask[k] = skip ? 0.f : NEG;
    em[k] = log_probs + (size_t)n * C + label;
  }

  const int len = min(input_lengths[n], T);
  const int steps = hist ? T : len;
  const size_t t_stride = (size_t)N * C;
  const int lanes = PER * nt;
  float* cur = alpha;
  float* nxt = alpha + lanes;
  float* hist_n = hist ? hist + (size_t)n * T * S : nullptr;

  float e_next[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = threadIdx.x + k * nt;
    e_next[k] = (s < S && steps > 1) ? em[k][t_stride] : 0.f;
    if (s < S) {
      const float a0 = (s < 2 && steps > 0) ? em[k][0] : NEG;
      cur[s] = len > 0 ? a0 : 0.f;
      if (hist && T > 0) hist_n[s] = cur[s];
    }
  }
  __syncthreads();
  for (int t = 1; t < steps; ++t) {
    // the next step's emissions first, a step ahead of their use
    float e[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      e[k] = e_next[k];
      if (threadIdx.x + k * nt < S && t + 1 < steps)
        e_next[k] = em[k][(t + 1) * t_stride];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int s = threadIdx.x + k * nt;
      if (s < S) {
        const float a0 = cur[s];
        const float a1 = s >= 1 ? cur[s - 1] : NEG;
        const float a2 = (s >= 2 ? cur[s - 2] : NEG) + skip_mask[k];
        const float v = t < len ? lse3(a0, a1, a2) + e[k] : a0;
        nxt[s] = v;
        if (hist) hist_n[(size_t)t * S + s] = v;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (threadIdx.x == 0) {
    if (len <= 0) {
      loss[n] = -NEG;
    } else {
      const int last = min(2 * max(target_lengths[n], 0), S - 1);
      const float x = cur[last];
      const float y = last > 0 ? cur[last - 1] : NEG;
      const float m = fmaxf(x, y);
      loss[n] = -(m + logf(expf(x - m) + expf(y - m)));
    }
  }
}

}  // namespace

// log_probs (T, N, C) fp32; targets (N, U), input_lengths and
// target_lengths (N,) int32; loss (N,) fp32; hist (N, T, 2U+1) fp32 or
// null. Returns the launch's cudaError_t (cudaErrorInvalidValue when
// 2U+1 exceeds 4096 states).
extern "C" int hl_ctc_fwd(const void* log_probs, const void* targets,
                          const void* input_lengths,
                          const void* target_lengths, void* loss, void* hist,
                          int T, int N, int C, int U, void* stream) {
  const int S = 2 * U + 1;
  if (S > MAX_STATES || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min((S + 31) / 32 * 32, MAX_STATES / MAX_PER);
  const int per = (S + threads - 1) / threads;     // 1, 2, 3 or 4
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lp = static_cast<const float*>(log_probs);
  const auto tg = static_cast<const int*>(targets);
  const auto il = static_cast<const int*>(input_lengths);
  const auto tl = static_cast<const int*>(target_lengths);
  const auto ls = static_cast<float*>(loss);
  const auto h = static_cast<float*>(hist);
  if (per == 1)
    ctc_fwd<1><<<N, threads, 2 * threads * sizeof(float), st>>>(
        lp, tg, il, tl, ls, h, T, N, C, U);
  else if (per == 2)
    ctc_fwd<2><<<N, threads, 4 * threads * sizeof(float), st>>>(
        lp, tg, il, tl, ls, h, T, N, C, U);
  else
    ctc_fwd<4><<<N, threads, 8 * threads * sizeof(float), st>>>(
        lp, tg, il, tl, ls, h, T, N, C, U);
  return static_cast<int>(cudaGetLastError());
}
