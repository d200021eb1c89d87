// Star-CTC backward lattice: d loss / d star log-probs from the forward's
// alpha history.
//
// Replaces: haloop_tpu/ops/star_pallas.py _star_bwd_kernel (launched by
// _lattice_bwd, the VJP of star_ctc_loss_pallas's lattice), together
// with the one-hot scatter that follows it there. Plain version:
// haloop_tpu_torch/ops/star.py star_grad.
//
// The reverse sweep on the transposed stencil of star_fwd.cu, over the
// S = 4U+3 states, for t = len-1 down to 0, with q = em_{t+1} + pen +
// beta_{t+1} (pen = the penalty at star states, 0 elsewhere):
//   beta_t[s] = 0 at the last four states (4u-1 .. 4u+2), NEG elsewhere,
//               for t = len-1;
//             = lse(q[s] + m0, q[s+1], q[s+2] + m2, q[s+3] + m2,
//                   q[s+4] + m4, q[s-1] + mm1)       otherwise,
//   with each edge's additive mask (0 or NEG) taken at its target: m0 the
//   self loop into blanks and stars, m2 into labels, m4 into labels that
//   differ from the previous label, mm1 the back edge into a star; a
//   term from outside the states is FILL = 2 NEG.
//   dem[t][s] = -g * exp(clip(alpha_t[s] + beta_t[s] - logZ, -60, 60))
// with logZ = -loss and dem = 0 for t >= len; then
//   d star_lp[t, n, c] = sum of dem[t][s] over the states whose class is c.
// The clip, the masking and NEG = -1e9 are the TPU kernel's, so an
// infeasible item (loss ~1e9) gives its gradients.
//
// What bounds it on the H100: the bytes are the history and the gathered
// emissions of the active frames in and the whole (T, N, 2V) gradient out
// (76 MB at N=48, T'=385, 2V=1024: ~23 us at 3.35 TB/s); but an
// utterance's frames are a chain of T dependent 6-point stencils (six
// exponentials and a logarithm a state), so its floor is T times one
// frame's stencil latency, not the bytes.
//
// This design: K4's (ctc_bwd.cu, lattice_bwd.cuh), with K a multiple of
// 4 states a lane, so that a state's type (s % 4) is its register's index
// mod 4 and the masks m0, m2, m3 and mm1 are constants; m4 is a bit a
// state. Neighbours s+1 .. s+4 come from the lane or the next one (its
// first four states), across warps through shared memory behind a named
// barrier. s-1 comes from the lane's own run, except at a lane's first
// state, a blank (s = 0 mod 4): there the back edge is masked, and its
// term is left out. It adds an exact 0: where s-1 (a label) reaches the
// end, so does s, through the same successors (s itself or s+3), and its
// open terms are larger by ~1e9. The scatter warps feed the sweep its
// emissions and turn its betas into d em and each 2V-wide row. Several states map to one class (every blank; <star> at
// the final star and at padded targets; a label and its <star>\t
// repeated across the targets): the scatter warps sum them in a fixed
// order. No atomics.

#include <cuda_runtime.h>

#include "lattice_bwd.cuh"

namespace {

using namespace hl::lat;
using hl::ex2;

constexpr float NEG = -1e9f;
constexpr float FILL = 2.f * NEG;

__device__ __forceinline__ float lse6(float a, float b, float c, float d,
                                      float e, float f) {
  const float m = fmaxf(
      fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), e), f), NEG);
  const float sum = exp_rel(a, m) + exp_rel(b, m) + exp_rel(c, m) +
                    exp_rel(d, m) + exp_rel(e, m) + exp_rel(f, m);
  return fmaf(lg2(sum), LN2, m);
}

__device__ __forceinline__ int clamp_class(int raw, int C2) {
  return min(max(raw, 0), C2 - 1);
}

template <int K>
__device__ void sweep(const Layout& L, char* sm, const int* st,
                      float penalty, int len, int ulen) {
  static_assert(K % 4 == 0, "a state's type is its register index mod 4");
  const int ls = threadIdx.x, w = ls >> 5, lane = ls & 31;
  const int S = L.S;
  float* edge = reinterpret_cast<float*>(sm + L.edge);

  float q[K];
  uint32_t m4 = 0;                   // bit j: the edge s -> s+4 exists
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = ls * K + j;
    q[j] = s < S ? NEG : FILL;
    // s + 4 is a label when s is; it takes the edge unless its label
    // repeats the one at s
    if (j % 4 == 3 && s + 4 < S && st[(s + 3) / 2] != st[(s - 1) / 2])
      m4 |= 1u << j;
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
      for (int j = 0; j < K; ++j)
        e[j] = em[j * L.lanes + ls] + (j % 4 == 1 ? penalty : 0.f);
      float beta[K];
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = ls * K + j;
          beta[j] = (s >= 4 * ulen - 1 && s <= 4 * ulen + 2) ? 0.f : NEG;
        }
      } else {
        // the next lane's first four states
        float nx[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          nx[k] = __shfl_down_sync(0xffffffffu, q[k], 1);
        if (lane == 31) {
          const float* ed = edge + (((i - 1) & 1) * L.sweep + w + 1) * 8;
          const bool more = w + 1 < L.sweep;
#pragma unroll
          for (int k = 0; k < 4; ++k) nx[k] = more ? ed[k] : FILL;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          // (indices mod K and 4: the branch not taken is valid too)
          const float r1 = j + 1 < K ? q[(j + 1) % K] : nx[(j + 1) % 4];
          const float r2 = j + 2 < K ? q[(j + 2) % K] : nx[(j + 2) % 4];
          const float r3 = j + 3 < K ? q[(j + 3) % K] : nx[(j + 3) % 4];
          const float r4 = j + 4 < K ? q[(j + 4) % K] : nx[(j + 4) % 4];
          // the masks at each edge's target, by the state's type j % 4:
          // m0 blanks and stars, m2 (s+2) and m3 (s+3) labels, mm1 stars
          // (at j = 0 the masked back edge adds 0: see the header)
          const float l1 = j > 0 ? q[(j + K - 1) % K] : FILL;
          const float m0 = (j % 2 == 0 || j % 4 == 1) ? 0.f : NEG;
          const float m2 = j % 4 == 1 ? 0.f : NEG;
          const float m3 = j % 4 == 0 ? 0.f : NEG;
          const float mm1 = j % 4 == 2 ? 0.f : NEG;
          beta[j] = lse6(q[j] + m0, r1, r2 + m2, r3 + m3,
                         r4 + ((m4 >> j) & 1 ? 0.f : NEG), l1 + mm1);
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
#pragma unroll
          for (int k = 0; k < 4; ++k) ed[k] = q[k];
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
    star_bwd(const float* __restrict__ star_lp,      // (T, N, C2)
             const int* __restrict__ star_targets,   // (N, 2U+1)
             const int* __restrict__ input_lengths,  // (N,)
             const int* __restrict__ target_lengths, // (N,)
             const float* __restrict__ hist,         // (N, T, S)
             const float* __restrict__ loss,         // (N,)
             const float* __restrict__ g,            // (N,)
             float* __restrict__ dlp,                // (T, N, C2)
             float penalty, int T, int N, int C2, int U, int sweep_warps,
             int scatter_warps, int frames, int depth, bool dense) {
  extern __shared__ __align__(16) char sm[];
  const int S = 4 * U + 3;
  const Layout L =
      layout(S, C2, K, sweep_warps, scatter_warps, frames, depth, dense);
  const int n = blockIdx.x;
  const int* st = star_targets + (size_t)n * (2 * U + 1);
  build_lists<K>(L, sm, [&](int s) {
    return (s % 2) ? clamp_class(st[(s - 1) / 2], C2) : 0;
  });
  const int len = max(min(input_lengths[n], T), 0);
  if (threadIdx.x < L.lanes) {
    const int ulen = min(max(target_lengths[n], 0), U);
    sweep<K>(L, sm, st, penalty, len, ulen);
  } else {
    scatter<K>(L, sm, hist + (size_t)n * T * S, star_lp + (size_t)n * C2,
            (size_t)N * C2, dlp + (size_t)n * C2, (size_t)N * C2, T, len,
            -loss[n], g[n]);
  }
}

template <int K>
cudaError_t launch(const Layout& L, cudaStream_t stream, const float* lp,
                   const int* st, const int* il, const int* tl,
                   const float* hist, const float* loss, const float* g,
                   float* dlp, float penalty, int T, int N, int C2, int U) {
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        star_bwd<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.bytes);
    if (err != cudaSuccess) return err;
  }
  star_bwd<K><<<N, 32 * (L.sweep + L.scatter), L.bytes, stream>>>(
      lp, st, il, tl, hist, loss, g, dlp, penalty, T, N, C2, U, L.sweep,
      L.scatter, L.frames, L.depth, L.dense);
  return cudaGetLastError();
}

}  // namespace

// star_lp (T, N, C2) fp32; star_targets (N, 2U+1), input_lengths and
// target_lengths (N,) int32; hist (N, T, 4U+3) fp32, the forward's alpha
// history; loss (N,) fp32, its NLL; g (N,) fp32, the upstream gradient;
// dlp (T, N, C2) fp32 receives d(sum g*loss)/d star_lp, every element
// written. The plan (ops/lattice_cuda.py): K states a lane (4, 8, 16 or
// 32), sweep and scatter warps, frames a ring slot, the ring's slots and
// the shared-memory bytes. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a plan that does not fit the lattice).
extern "C" int hl_star_bwd(const void* star_lp, const void* star_targets,
                           const void* input_lengths,
                           const void* target_lengths, const void* hist,
                           const void* loss, const void* g, void* dlp,
                           float penalty, int T, int N, int C2, int U, int K,
                           int sweep_warps, int scatter_warps, int frames,
                           int depth, int dense, int smem, void* stream) {
  const Layout L = layout(4 * U + 3, C2, K, sweep_warps, scatter_warps,
                          frames, depth, dense != 0);
  if (N <= 0 || U < 0 || smem < 0 || !plan_ok(L, (size_t)smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lp = static_cast<const float*>(star_lp);
  const auto tg = static_cast<const int*>(star_targets);
  const auto il = static_cast<const int*>(input_lengths);
  const auto tl = static_cast<const int*>(target_lengths);
  const auto h = static_cast<const float*>(hist);
  const auto ls = static_cast<const float*>(loss);
  const auto gg = static_cast<const float*>(g);
  const auto out = static_cast<float*>(dlp);
  cudaError_t err;
  switch (K) {
    case 4: err = launch<4>(L, st, lp, tg, il, tl, h, ls, gg, out, penalty, T, N, C2, U); break;
    case 8: err = launch<8>(L, st, lp, tg, il, tl, h, ls, gg, out, penalty, T, N, C2, U); break;
    case 16: err = launch<16>(L, st, lp, tg, il, tl, h, ls, gg, out, penalty, T, N, C2, U); break;
    case 32: err = launch<32>(L, st, lp, tg, il, tl, h, ls, gg, out, penalty, T, N, C2, U); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the --phases build's stamps of the last launch (block 0's frames)
extern "C" int hl_star_bwd_phases(void* out) { return hl::copy_phases(out); }
#endif
