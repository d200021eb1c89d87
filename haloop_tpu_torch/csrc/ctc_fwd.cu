// CTC forward lattice: per-utterance negative log-likelihood and, when
// asked for, the alpha history the backward reads.
//
// Replaces: haloop_tpu/ops/ctc_pallas.py _ctc_fwd_kernel (launched by
// _fwd_call, entry ctc_loss_pallas), the forward half of the fused CTC
// loss, together with the one-hot gather of emissions in front of it
// (_prepare). Plain versions: haloop_tpu_torch/ops/ctc.py
// ctc_forward_score, and ctc_forward_history with the history.
//
// Computes the log-space alpha recursion over the S' = 2U+1 states of the
// blank-interspersed targets (blank = 0):
//   alpha_0[s]  = em_0[s] for s < 2, NEG otherwise
//   alpha_t[s]  = lse(alpha[s], alpha[s-1], alpha[s-2] + skip_mask[s])
//                 + em_t[s]                        for t < input_length
//   (the skip from s-2 is allowed only into a label state whose label
//   differs from the one at s-2; a blank has no skip term), frozen for
//   t >= input_length, and loss = -lse(alpha[2u], alpha[2u-1]) (state 0
//   alone when u = 0; 1e9 for an item with no frames). Masked entries use
//   the TPU kernel's big-finite NEG = -1e9, so an infeasible item (too few
//   frames for its labels) gives a loss of about 1e9, finite, never inf or
//   NaN.
//
// What bounds it on the H100: the frames are sequential and each is a
// 3-point stencil over at most 4095 states, so an utterance's lattice is a
// chain of T dependent stencils (a blank one exponential and a logarithm,
// a label two and one); its floor is T times one frame's latency, not its
// bytes (at N=48, T'=385, S'=193: ~3.5 MB of emissions in, a 14 MB history
// out, 0.0074 ms at 3.35 TB/s), plus ~15 us of launch, set-up and the
// ring's first fill.
//
// This design: the forward lattice skeleton of lattice.cuh, as K8a
// (star_fwd.cu) uses it. One block an utterance.
// - Sweep warps hold K contiguous states a lane in registers
//   (ops/lattice_cuda.py forward_plan via ops/ctc_cuda.fwd_plan): K = 2
//   over a warpgroup at S' = 193, 4 over up to 8 warps to 1,024 states, 8
//   over up to 16 warps to 4,095. K is even, so a register's index fixes
//   its state's type: even registers are blanks (a 2-term lse), odd ones
//   labels (a 3-term lse, the skip mask in a register's bit). s-1 and s-2
//   come from the lane's own registers; only the lane's first two states
//   read the previous lane's last state, by one __shfl_up_sync. Only a
//   warp's last lane hands its last state to the next warp, through shared
//   memory, once a frame: behind a named barrier of the sweep warps, or at
//   8 states a lane as a tagged word the next warp waits for, no barrier
//   (the long lattices: a 9- to 16-warp barrier a frame cost ~40% there).
//   Every per-lane choice is a select, not a branch (branches around the
//   edge read and the first frame cost ~30%: PERF.md).
// - Loader warps gather each frame's emissions from the (T, N, C)
//   log-probs into an mbarrier ring in shared memory by cp.async, `depth`
//   slots of `frames` frames ahead (lattice.cuh fwd_load): each label
//   state's, and the blank's once, which every blank state reads by
//   broadcast. So the (N, T, S') tensor the TPU path builds with a one-hot
//   matmul never exists; the sweep meets the ring once a slot.
// - lse in log2 units, ex2 and lg2 of the special function unit, the
//   largest term's exponential (1) left out: a blank pays one ex2, a label
//   two.
// - The history (N, T, S'), when asked for, is written straight from the
//   sweep's registers (lattice.cuh fwd_sweep); the frozen rows past the
//   input length the same way, without stepping the stencil or meeting the
//   ring. Without the history (serving) the sweep runs the item's frames
//   only.
// - The loss: the last two states' alphas through shared memory, their lse
//   (exact expf and logf) by one thread.

#include <cuda_runtime.h>

#include "lattice.cuh"

namespace {

using namespace hl::lat;
using hl::ex2;

constexpr float NEG = LAT_NEG;

// lse(a, b) + e = max + e + log(1 + e^-|a - b|)
__device__ __forceinline__ float lse2(float a, float b, float e) {
  const float m = fmaxf(a, b);
  return fmaf(lg2(1.f + exp_rel(fminf(a, b), m)), LN2, m + e);
}

// lse(a, b, c) + e: the largest, and the two others' exponentials against
// it
__device__ __forceinline__ float lse3(float a, float b, float c, float e) {
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float m = fmaxf(hi, c), mid = fminf(hi, c);
  return fmaf(lg2(1.f + exp_rel(mid, m) + exp_rel(lo, m)), LN2, m + e);
}

__device__ __forceinline__ int clamp_class(int raw, int C) {
  return min(max(raw, 0), C - 1);
}

template <int K>
__device__ void sweep(const Fwd& L, char* sm, const int* tg, int C, int len,
                      int ulen, int T, float* hist_n, float* loss) {
  static_assert(K % 2 == 0, "a state's type from its register");
  const int ls = threadIdx.x;
  const int S = L.S;

  // alpha before the first frame: 0, as the TPU kernel's (a frameless
  // item's history holds it); the first frame sets every state
  float a[K];
  uint32_t skip = 0;   // bit j: a label that may skip from s-2
  uint32_t live = 0;   // bit j: a state of the lattice
  uint32_t start = 0;  // bit j: state 0 or 1, where the first frame starts
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = ls * K + j;
    a[j] = 0.f;
    live |= (s < S ? 1u : 0u) << j;
    start |= (s < 2 ? 1u : 0u) << j;
    if (j % 2 == 1 && s < S) {
      const int label = clamp_class(tg[s / 2], C);
      const int before = s >= 3 ? clamp_class(tg[s / 2 - 1], C) : -1;
      if (label != 0 && label != before) skip |= 1u << j;
    }
  }
  fwd_sweep<K>(L, sm, len, T, hist_n, a,
               [&](int i, float prev, const float (&e)[K], float (&x)[K]) {
    float v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // (indices mod K: the branch not taken is a valid register too)
      const float l1 = j > 0 ? x[(j + K - 1) % K] : prev;
      if (j % 2 == 0) {
        v[j] = lse2(x[j], l1, e[j]);
      } else {
        const float l2 = j > 1 ? x[(j + K - 2) % K] : prev;
        v[j] = lse3(x[j], l1, l2 + ((skip >> j) & 1 ? 0.f : NEG), e[j]);
      }
    }
    // (selects, not branches)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float first = (start >> j) & 1 ? e[j] : NEG;
      const float y = i > 0 ? v[j] : first;
      x[j] = (live >> j) & 1 ? y : NEG;
    }
  });

  // the loss: the states 2u and 2u-1
  float* fin = reinterpret_cast<float*>(sm + L.fin);
  const int last = min(2 * ulen, S - 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = ls * K + j;
    if (s == last) fin[0] = a[j];
    if (s == last - 1) fin[1] = a[j];
  }
  if (ls == 0 && last == 0) fin[1] = NEG;
  sweep_bar(L.lanes);
  if (ls == 0) {
    if (len <= 0) {
      *loss = -NEG;
    } else {
      const float x = fin[0], y = fin[1];
      const float m = fmaxf(x, y);
      *loss = -(m + logf(expf(x - m) + expf(y - m)));
    }
  }
}

template <int K>
__global__ void __launch_bounds__(fwd_max_threads(K))
    ctc_fwd(const float* __restrict__ log_probs,    // (T, N, C)
            const int* __restrict__ targets,        // (N, U)
            const int* __restrict__ input_lengths,  // (N,)
            const int* __restrict__ target_lengths, // (N,)
            float* __restrict__ loss,               // (N,)
            float* __restrict__ hist,   // (N, T, S') or null
            int T, int N, int C, int U, int sweep_warps, int loaders,
            int frames, int depth) {
  extern __shared__ __align__(16) char sm[];
  const int S = 2 * U + 1;
  const Fwd L = fwd_layout(S, K, sweep_warps, loaders, frames, depth);
  const int n = blockIdx.x;
  const int* tg = targets + (size_t)n * U;
  fwd_init(L, sm, [&](int s) {
    return (s % 2) ? clamp_class(tg[s / 2], C) : 0;
  });
  const int len = max(min(input_lengths[n], T), 0);
  if (threadIdx.x < L.lanes) {
    sweep<K>(L, sm, tg, C, len, max(target_lengths[n], 0), T,
             hist ? hist + (size_t)n * T * S : nullptr, loss + n);
  } else {
    fwd_load<K>(L, sm, log_probs + (size_t)n * C, (size_t)N * C, len);
  }
}

template <int K>
cudaError_t launch(const Fwd& L, cudaStream_t stream, const float* lp,
                   const int* tg, const int* il, const int* tl, float* loss,
                   float* hist, int T, int N, int C, int U) {
  static unsigned done = 0;
  const cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(ctc_fwd<K>), 232448);
  if (err != cudaSuccess) return err;
  ctc_fwd<K><<<N, 32 * (L.sweep + L.loaders), L.bytes, stream>>>(
      lp, tg, il, tl, loss, hist, T, N, C, U, L.sweep, L.loaders, L.frames,
      L.depth);
  return cudaGetLastError();
}

}  // namespace

// log_probs (T, N, C) fp32; targets (N, U), input_lengths and
// target_lengths (N,) int32; loss (N,) fp32; hist (N, T, 2U+1) fp32 or
// null. The plan (ops/lattice_cuda.py forward_plan): K states a lane (2, 4
// or 8), sweep and loader warps, frames a ring slot, the ring's slots and
// the shared-memory bytes. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a plan that does not fit the lattice).
extern "C" int hl_ctc_fwd(const void* log_probs, const void* targets,
                          const void* input_lengths,
                          const void* target_lengths, void* loss, void* hist,
                          int T, int N, int C, int U, int K, int sweep_warps,
                          int loaders, int frames, int depth, int smem,
                          void* stream) {
  const Fwd L = fwd_layout(2 * U + 1, K, sweep_warps, loaders, frames, depth);
  if (N <= 0 || C <= 0 || U < 0 || smem < 0 || !fwd_plan_ok(L, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lp = static_cast<const float*>(log_probs);
  const auto tg = static_cast<const int*>(targets);
  const auto il = static_cast<const int*>(input_lengths);
  const auto tl = static_cast<const int*>(target_lengths);
  const auto ls = static_cast<float*>(loss);
  const auto h = static_cast<float*>(hist);
  cudaError_t err;
  switch (K) {
    case 2: err = launch<2>(L, st, lp, tg, il, tl, ls, h, T, N, C, U); break;
    case 4: err = launch<4>(L, st, lp, tg, il, tl, ls, h, T, N, C, U); break;
    case 8: err = launch<8>(L, st, lp, tg, il, tl, ls, h, T, N, C, U); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the --phases build's stamps of the last launch (block 0's frames)
extern "C" int hl_ctc_fwd_phases(void* out) { return hl::copy_phases(out); }
#endif
