// CTC backward lattice: d loss / d log_probs from the forward's alpha
// history.
//
// Replaces: haloop_tpu/ops/ctc_pallas.py _ctc_bwd_kernel (launched by
// _ctc_bwd, the VJP of ctc_loss_pallas), together with the one-hot
// scatter that follows it there. Plain version:
// haloop_tpu_torch/ops/ctc.py ctc_grad.
//
// Computes, over the S' = 2U+1 states of the blank-interspersed targets,
// the time-reversed beta' sweep for t = len-1 down to 0:
//   beta_t[s] = 0 at the final states (2u, and 2u-1 when u > 0), NEG
//               elsewhere, for t = len-1;
//             = lse(q[s], q[s+1], q[s+2] + skip_mask[s+2]) otherwise,
//               where q = em_{t+1} + beta_{t+1} and the skip s -> s+2
//               exists iff the skip into s+2 is allowed (NEG out of range)
//   dem[t][s] = -g * exp(clip(alpha_t[s] + beta_t[s] - logZ, -60, 60))
// with logZ = -loss and dem = 0 for t >= len; then
//   dlogp[t, n, c] = sum of dem[t][s] over the states s whose label is c.
// The clip, the masking and NEG = -1e9 are the TPU kernel's, so an
// infeasible item (loss ~1e9) and an empty target give its values.
//
// What bounds it on the H100: the bytes are the alpha history and the
// gathered emissions of the active frames in, and the whole (T, N, C)
// gradient out (66 MB at N=48, T'=385, S'=193, C=512: ~20 us at 3.35
// TB/s); but the frames are sequential, so an utterance's sweep is a chain
// of T dependent 3-point stencils, and its floor is T times the latency of
// one frame's stencil (a few hundred cycles), not the bytes.
//
// This design (lattice_bwd.cuh): one block an utterance; a warpgroup runs
// the sweep alone with K states a lane in registers (neighbours s+1, s+2
// from the lane or the next one by shuffle, across warps through shared
// memory behind a named barrier), reading its emissions from and writing
// its betas into a shared-memory ring; scatter warps fill the ring ahead
// of it by cp.async and, behind it, turn the betas into d em and each
// C-wide row, written whole with fixed-order class sums (no atomics: the
// same bits on every run). lse in ex2/lg2 with log2(e) folded in. The
// plan (warps, K, the ring, shared memory) comes from ops/lattice_cuda.py.

#include <cuda_runtime.h>

#include "lattice_bwd.cuh"

namespace {

using namespace hl::lat;
using hl::ex2;

constexpr float NEG = -1e9f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float sum = exp_rel(a, m) + exp_rel(b, m) + exp_rel(c, m);
  return fmaf(lg2(sum), LN2, m);
}

__device__ __forceinline__ int label_of(const int* tg, int s, int C) {
  return (s & 1) ? min(max(tg[s / 2], 0), C - 1) : 0;
}

template <int K>
__device__ void sweep(const Layout& L, char* sm, const int* tg, int C,
                      int len, int last) {
  static_assert(K >= 2, "the stencil reads two states of the next lane");
  const int ls = threadIdx.x, w = ls >> 5, lane = ls & 31;
  const int S = L.S;
  float* edge = reinterpret_cast<float*>(sm + L.edge);

  float q[K];
  uint32_t skip = 0;                 // bit j: the skip s -> s+2 exists
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = ls * K + j;
    q[j] = NEG;
    if ((s & 1) && s + 2 < S) {
      const int l2 = label_of(tg, s + 2, C);
      if (l2 != 0 && l2 != label_of(tg, s, C)) skip |= 1u << j;
    }
  }
  const int F = L.frames;
  const bool ph_on = blockIdx.x == 0 && ls == 0;   // --phases stamps
  for (int b = 0; b * F < len; ++b) {
    const long long tw = hl::stamp();
    sweep_enter(L, sm, b);
    long long ring_wait = hl::stamp() - tw;
    const int r = b % L.depth;
    for (int f = 0; f < F && b * F + f < len; ++f) {
      const int i = b * F + f;
      const long long ts0 = hl::stamp();
      const float* em = ring_row(L, sm, r, 0, f);
      float* be = ring_row(L, sm, r, 2, f);
      float e[K];
#pragma unroll
      for (int j = 0; j < K; ++j) e[j] = em[j * L.lanes + ls];
      float beta[K];
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = ls * K + j;
          beta[j] = (s == last || (last > 0 && s == last - 1)) ? 0.f : NEG;
        }
      } else {
        // q[s+1], q[s+2] past this lane's run: the next lane's first two
        float n0 = __shfl_down_sync(0xffffffffu, q[0], 1);
        float n1 = __shfl_down_sync(0xffffffffu, q[1], 1);
        if (lane == 31) {
          const float* ed = edge + (((i - 1) & 1) * L.sweep + w + 1) * 8;
          const bool more = w + 1 < L.sweep;
          n0 = more ? ed[0] : NEG;
          n1 = more ? ed[1] : NEG;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          // (indices mod K: the branch not taken is a valid register too)
          const float a1 = j + 1 < K ? q[(j + 1) % K] : n0;
          const float a2 =
              (j + 2 < K ? q[(j + 2) % K] : (j + 2 == K ? n0 : n1)) +
              ((skip >> j) & 1 ? 0.f : NEG);
          beta[j] = lse3(q[j], a1, a2);
        }
      }
      const long long ts1 = hl::stamp();
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (ls * K + j < S) {
          be[j * L.lanes + ls] = beta[j];
          q[j] = e[j] + beta[j];
        }
      }
      const long long ts2 = hl::stamp();
      if (L.sweep > 1 && i + 1 < len) {   // the edges for the next frame
        float* ed = edge + ((i & 1) * L.sweep + w) * 8;
        if (lane == 0) {
          ed[0] = q[0];
          ed[1] = q[1];
        }
        sweep_bar(L.lanes);
      }
      // frame i's cycles: its slot's ring wait (at the slot's first
      // frame), the stencil, the beta row, the edge barrier
      hl::keep_phase(ph_on, 0, i, ring_wait);
      hl::keep_phase(ph_on, 1, i, ts1 - ts0);
      hl::keep_phase(ph_on, 2, i, ts2 - ts1);
      hl::keep_phase(ph_on, 3, i, hl::stamp() - ts2);
      ring_wait = 0;
    }
    sweep_leave(L, sm, b);
  }
}

template <int K>
__global__ void __launch_bounds__(max_threads(K))
    ctc_bwd(const float* __restrict__ log_probs,   // (T, N, C)
            const int* __restrict__ targets,        // (N, U)
            const int* __restrict__ input_lengths,  // (N,)
            const int* __restrict__ target_lengths, // (N,)
            const float* __restrict__ hist,         // (N, T, S)
            const float* __restrict__ loss,         // (N,)
            const float* __restrict__ g,            // (N,)
            float* __restrict__ dlogp,              // (T, N, C)
            int T, int N, int C, int U, int sweep_warps, int scatter_warps,
            int frames, int depth, bool dense) {
  extern __shared__ __align__(16) char sm[];
  const int S = 2 * U + 1;
  const Layout L =
      layout(S, C, K, sweep_warps, scatter_warps, frames, depth, dense);
  const int n = blockIdx.x;
  const int* tg = targets + (size_t)n * U;
  build_lists<K>(L, sm, [&](int s) { return label_of(tg, s, C); });
  const int len = max(min(input_lengths[n], T), 0);
  if (threadIdx.x < L.lanes) {
    const int last = min(2 * max(target_lengths[n], 0), S - 1);
    sweep<K>(L, sm, tg, C, len, last);
  } else {
    scatter<K>(L, sm, hist + (size_t)n * T * S, log_probs + (size_t)n * C,
            (size_t)N * C, dlogp + (size_t)n * C, (size_t)N * C, T, len,
            -loss[n], g[n]);
  }
}

template <int K>
cudaError_t launch(const Layout& L, cudaStream_t stream, const float* lp,
                   const int* tg, const int* il, const int* tl,
                   const float* hist, const float* loss, const float* g,
                   float* dlogp, int T, int N, int C, int U) {
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_bwd<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.bytes);
    if (err != cudaSuccess) return err;
  }
  ctc_bwd<K><<<N, 32 * (L.sweep + L.scatter), L.bytes, stream>>>(
      lp, tg, il, tl, hist, loss, g, dlogp, T, N, C, U, L.sweep, L.scatter,
      L.frames, L.depth, L.dense);
  return cudaGetLastError();
}

}  // namespace

// log_probs (T, N, C) fp32; targets (N, U), input_lengths and
// target_lengths (N,) int32; hist (N, T, 2U+1) fp32, the forward's alpha
// history; loss (N,) fp32, its NLL; g (N,) fp32, the upstream gradient of
// the loss; dlogp (T, N, C) fp32 receives d(sum g*loss)/d log_probs,
// every element written. The plan (ops/lattice_cuda.py): K states a lane
// (2, 4, 8, 16 or 32), sweep and scatter warps, frames a ring slot, the
// ring's slots and the shared-memory bytes. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan that does not fit the
// lattice).
extern "C" int hl_ctc_bwd(const void* log_probs, const void* targets,
                          const void* input_lengths,
                          const void* target_lengths, const void* hist,
                          const void* loss, const void* g, void* dlogp,
                          int T, int N, int C, int U, int K, int sweep_warps,
                          int scatter_warps, int frames, int depth, int dense,
                          int smem, void* stream) {
  const Layout L = layout(2 * U + 1, C, K, sweep_warps, scatter_warps,
                          frames, depth, dense != 0);
  if (N <= 0 || U < 0 || smem < 0 || !plan_ok(L, (size_t)smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lp = static_cast<const float*>(log_probs);
  const auto tg = static_cast<const int*>(targets);
  const auto il = static_cast<const int*>(input_lengths);
  const auto tl = static_cast<const int*>(target_lengths);
  const auto h = static_cast<const float*>(hist);
  const auto ls = static_cast<const float*>(loss);
  const auto gg = static_cast<const float*>(g);
  const auto out = static_cast<float*>(dlogp);
  cudaError_t err;
  switch (K) {
    case 2: err = launch<2>(L, st, lp, tg, il, tl, h, ls, gg, out, T, N, C, U); break;
    case 4: err = launch<4>(L, st, lp, tg, il, tl, h, ls, gg, out, T, N, C, U); break;
    case 8: err = launch<8>(L, st, lp, tg, il, tl, h, ls, gg, out, T, N, C, U); break;
    case 16: err = launch<16>(L, st, lp, tg, il, tl, h, ls, gg, out, T, N, C, U); break;
    case 32: err = launch<32>(L, st, lp, tg, il, tl, h, ls, gg, out, T, N, C, U); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the --phases build's stamps of the last launch (block 0's frames)
extern "C" int hl_ctc_bwd_phases(void* out) { return hl::copy_phases(out); }
#endif
