// Star-CTC forward lattice: per-utterance negative log-likelihood.
//
// Replaces: haloop_tpu/ops/star_pallas.py _star_fwd_kernel (launched by
// _lattice_fwd, entry star_ctc_loss_pallas), together with the one-hot
// gather of emissions in front of it (_prepare). Plain version:
// haloop_tpu_torch/ops/star.py star_forward_history.
//
// The trellis has S = 4U+3 states over the doubled (2V) vocabulary: blank,
// <star>\t1, blank, t1, ..., blank, <star>, blank (state s: a blank when
// s % 2 == 0, a star when s % 4 == 1, a label when s % 4 == 3; its class
// is star_targets[(s-1)/2] for odd s). The padded lane layout is the TPU
// kernel's: PAD = 4 virtual start lanes at 0.0 (NEG after the first
// frame), the S state lanes, and a SENTINEL lane (-7007.7007) after them.
// For frame t < input_length, with a = alpha_{t-1} by lane L = PAD + s:
//   pos   = lse(a[L-1], a[L])                      (from prev or self)
//   reach = lse(a[L-3], a[L-1], a[L-2])
//   blank: pos;   star: lse(pos, a[L+1]) + penalty (the back edge from
//   the blank after the star);   label: reach if its label equals the one
//   at s-4, else lse(reach, a[L-4]);
//   alpha_t[L] = that + em_t[s]
// where lse is the TPU kernel's (max clamped at NEG = -1e9, exps summed
// in order). alpha is frozen from the input length on, and
//   loss = -lse(alpha at the last four state lanes, PAD+4u-1 .. PAD+4u+2)
// at t = input_length - 1 (1e9 for an item with no frames).
//
// What bounds it on the H100: the frames are sequential and each is a
// 6-point stencil over at most 4096 lanes, so the lattice is latency
// bound (one emission load and one block barrier a frame), not by bytes
// or operations: at N=48, T'=385, S=387 it reads ~7 MB of emissions.
//
// This design: K3's (ctc_fwd.cu). One block per utterance, each thread
// the padded lanes tid, tid + blockDim, ... (PER of them: 1, 2 or 4; at
// most 1024 threads, 4096 lanes); alpha is double-buffered in shared
// memory; each state's emission is gathered inside the kernel straight
// from the (T, N, 2V) star log-probs, one frame ahead of its use, so the
// (N, T, S) tensor the TPU path builds with a one-hot matmul never
// exists. The alpha history (N, T, S), which the backward needs, is
// written only when asked for.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e9f;
constexpr float SENTINEL = -7007.7007f;
constexpr int PAD = 4;
constexpr int MAX_LANES = 4096;
constexpr int MAX_PER = 4;          // lanes a thread, at 1024 threads

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  return m + logf(expf(a - m) + expf(b - m));
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), NEG);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

template <int PER>
__global__ void star_fwd(const float* __restrict__ star_lp,      // (T, N, C2)
                         const int* __restrict__ star_targets,   // (N, 2U+1)
                         const int* __restrict__ input_lengths,  // (N,)
                         const int* __restrict__ target_lengths, // (N,)
                         float* __restrict__ loss,               // (N,)
                         float* __restrict__ hist,  // (N, T, S) or null
                         float penalty, int T, int N, int C2, int U) {
  extern __shared__ float alpha[];   // 2 * PER * blockDim.x
  const int n = blockIdx.x;
  const int S = 4 * U + 3;
  const int lanes = PAD + S + 1;
  const int nt = blockDim.x;
  const int* st = star_targets + (size_t)n * (2 * U + 1);

  // each lane's state type, class (clamped into the vocabulary, like a
  // gather) and whether its label repeats the one at s-4
  unsigned blank = 0, star = 0, same = 0;   // bit k: lane tid + k nt
  const float* em[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int s = threadIdx.x + k * nt - PAD;
    const bool real = s >= 0 && s < S;
    int label = 0;
    if (real && s % 2 == 0) blank |= 1u << k;
    if (real && s % 4 == 1) star |= 1u << k;
    if (real && s % 2 != 0) {
      const int raw = st[(s - 1) / 2];
      label = min(max(raw, 0), C2 - 1);
      if (s % 4 == 3 && s >= 4 && raw == st[(s - 5) / 2]) same |= 1u << k;
    }
    em[k] = star_lp + (size_t)n * C2 + label;
  }

  const int len = max(min(input_lengths[n], T), 0);
  const int ulen = min(max(target_lengths[n], 0), U);
  const int last = PAD + 4 * ulen + 2;       // lane of the final blank
  const size_t t_stride = (size_t)N * C2;
  float* cur = alpha;
  float* nxt = alpha + PER * nt;
  float* hist_n = hist ? hist + (size_t)n * T * S : nullptr;

  float e_next[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int L = threadIdx.x + k * nt, s = L - PAD;
    const bool real = s >= 0 && s < S;
    if (L < lanes) cur[L] = L < PAD ? 0.f : (L == PAD + S ? SENTINEL : NEG);
    e_next[k] = (real && len > 0) ? em[k][0] : 0.f;
  }
  float final_score = NEG;
  __syncthreads();
  for (int t = 0; t < len; ++t) {
    // the next frame's emissions first, a frame ahead of their use
    float e[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int s = threadIdx.x + k * nt - PAD;
      e[k] = e_next[k];
      if (s >= 0 && s < S && t + 1 < len)
        e_next[k] = em[k][(t + 1) * t_stride];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int L = threadIdx.x + k * nt, s = L - PAD;
      if (L >= lanes) continue;
      const bool real = s >= 0 && s < S;
      float v = L == PAD + S ? SENTINEL : NEG;   // non-state lanes
      if (real) {
        const float from_prev = cur[L - 1], from_self = cur[L];
        const float pos = lse2(from_prev, from_self);
        float trans;
        if ((blank >> k) & 1) {
          trans = pos;
        } else if ((star >> k) & 1) {
          trans = lse2(pos, cur[L + 1]) + penalty;
        } else {
          const float reach = lse3(cur[L - 3], from_prev, cur[L - 2]);
          trans = (same >> k) & 1 ? reach : lse2(reach, cur[L - 4]);
        }
        v = trans + e[k];
        if (hist) hist_n[(size_t)t * S + s] = v;
      }
      nxt[L] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // frames past the input length keep the frozen lattice
  if (hist) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int L = threadIdx.x + k * nt, s = L - PAD;
      if (s >= 0 && s < S)
        for (int t = len; t < T; ++t) hist_n[(size_t)t * S + s] = cur[L];
    }
  }

  if (threadIdx.x == 0) {
    if (len > 0) {
      const float a = cur[last - 3], b = cur[last - 2], c = cur[last - 1],
                  d = cur[last];
      const float m = fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), NEG);
      final_score = m + logf(expf(d - m) + expf(c - m) + expf(b - m) +
                             expf(a - m));
    }
    loss[n] = -final_score;
  }
}

}  // namespace

// star_lp (T, N, C2) fp32, the star-vocabulary log-probs; star_targets
// (N, 2U+1), input_lengths and target_lengths (N,) int32; loss (N,) fp32;
// hist (N, T, 4U+3) fp32 or null. Returns the launch's cudaError_t
// (cudaErrorInvalidValue beyond 4096 lanes).
extern "C" int hl_star_fwd(const void* star_lp, const void* star_targets,
                           const void* input_lengths,
                           const void* target_lengths, void* loss, void* hist,
                           float penalty, int T, int N, int C2, int U,
                           void* stream) {
  const int lanes = PAD + 4 * U + 3 + 1;
  if (lanes > MAX_LANES || N <= 0 || C2 <= 0 || U < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min((lanes + 31) / 32 * 32, MAX_LANES / MAX_PER);
  const int per = (lanes + threads - 1) / threads;   // 1, 2, 3 or 4
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lp = static_cast<const float*>(star_lp);
  const auto tg = static_cast<const int*>(star_targets);
  const auto il = static_cast<const int*>(input_lengths);
  const auto tl = static_cast<const int*>(target_lengths);
  const auto ls = static_cast<float*>(loss);
  const auto h = static_cast<float*>(hist);
  if (per == 1)
    star_fwd<1><<<N, threads, 2 * threads * sizeof(float), st>>>(
        lp, tg, il, tl, ls, h, penalty, T, N, C2, U);
  else if (per == 2)
    star_fwd<2><<<N, threads, 4 * threads * sizeof(float), st>>>(
        lp, tg, il, tl, ls, h, penalty, T, N, C2, U);
  else
    star_fwd<4><<<N, threads, 8 * threads * sizeof(float), st>>>(
        lp, tg, il, tl, ls, h, penalty, T, N, C2, U);
  return static_cast<int>(cudaGetLastError());
}
