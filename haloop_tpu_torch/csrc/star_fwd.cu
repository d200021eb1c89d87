// Star-CTC forward lattice: per-utterance negative log-likelihood and,
// when asked for, the alpha history the backward reads.
//
// Replaces: haloop_tpu/ops/star_pallas.py _star_fwd_kernel (launched by
// _lattice_fwd, entry star_ctc_loss_pallas), together with the one-hot
// gather of emissions in front of it (_prepare). Plain version:
// haloop_tpu_torch/ops/star.py star_forward_history.
//
// The trellis has S = 4U+3 states over the doubled (2V) vocabulary: blank,
// <star>\t1, blank, t1, ..., blank, <star>, blank (state s: a blank when
// s % 2 == 0, a star when s % 4 == 1, a label when s % 4 == 3; its class
// is star_targets[(s-1)/2] for odd s). Before state 0 the TPU kernel's
// padded layout has PAD = 4 virtual start lanes at 0.0 (NEG after the
// first frame); of them the stencil reads only the last, "state -1". For
// frame t < input_length, with a = alpha_{t-1}:
//   blank: lse(a[s-1], a[s])
//   star:  lse(a[s-1], a[s], a[s+1]) + penalty   (a[s+1]: the back edge
//          from the blank after the star)
//   label: lse(a[s-3], a[s-1], a[s-2]) if its label equals the one at s-4,
//          else lse(a[s-3], a[s-1], a[s-2], a[s-4])
//   alpha_t[s] = that + em_t[s]
// where lse is the TPU kernel's (max clamped at NEG = -1e9). alpha is
// frozen from the input length on, and
//   loss = -lse(alpha at the last four states, 4u-1 .. 4u+2)
// at t = input_length - 1 (1e9 for an item with no frames).
//
// What bounds it on the H100: the frames are sequential and each is a
// 6-point stencil over at most 4091 states, so an utterance's lattice is a
// chain of T dependent stencils (three to five exponentials and a
// logarithm a state); its floor is T times one frame's latency, not its
// bytes (at N=48, T'=385, S=387: ~7 MB of emissions in, a 29 MB history
// out).
//
// This design: the forward mirror of K8b (star_bwd.cu) on the lattice
// skeleton (lattice.cuh). One block an utterance.
// - Sweep warps hold K contiguous states a lane in registers
//   (ops/lattice_cuda.py forward_plan): K = 4 over a warpgroup at S = 387
//   (up to 8 warps), 8 over up to 16 warps for longer lattices (4,096
//   states), so that a state's type (s % 4) is its
//   register's index mod 4: the stencil's left neighbours s-1 .. s-4 come
//   from the lane's own registers except at its first blank (s-1) and its
//   first label (s-4), which read the previous lane's last state by one
//   __shfl_up_sync; the star's back edge s+1 is always the lane's own.
//   Only a warp's last lane hands its last state to the next warp, through
//   shared memory, once a frame: behind a named barrier of the sweep warps,
//   or from 8 states a lane on as a tagged word the next warp waits for
//   (lattice.cuh fwd_sweep, K3's too). (2 states a lane over 7 warps, K4's
//   stencil, read 11% slower at S = 387: PERF.md.)
// - Loader warps gather each frame's emissions from the (T, N, 2V) star
//   log-probs into an mbarrier ring in shared memory by cp.async, `depth`
//   slots of `frames` frames ahead (lattice.cuh fwd_load): the odd states',
//   and the blank's (every even state's) once. So the (N, T, S) tensor the
//   TPU path builds with a one-hot matmul never exists; the sweep meets the
//   ring once a slot.
// - lse in log2 units, ex2 and lg2 of the special function unit.
// - The history (N, T, S), when asked for, is written straight from the
//   sweep's registers: a lane's K contiguous states as 16-byte stores where
//   the row is 16-byte aligned (8-byte, or single, stores elsewhere); the
//   frozen rows past the input length the same way.
// - The loss: the last four states' alphas through shared memory, their lse
//   (exact expf and logf) by one thread.

#include <cuda_runtime.h>

#include "lattice.cuh"

namespace {

using namespace hl::lat;
using hl::ex2;

constexpr float NEG = LAT_NEG;
constexpr float FILL = 2.f * NEG;    // a term that is not in the lattice

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  return fmaf(lg2(exp_rel(a, m) + exp_rel(b, m)), LN2, m);
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), NEG);
  return fmaf(lg2(exp_rel(a, m) + exp_rel(b, m) + exp_rel(c, m)), LN2, m);
}

__device__ __forceinline__ float lse4(float a, float b, float c, float d) {
  const float m = fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), NEG);
  return fmaf(lg2(exp_rel(a, m) + exp_rel(b, m) + exp_rel(c, m) +
                  exp_rel(d, m)),
              LN2, m);
}

__device__ __forceinline__ int clamp_class(int raw, int C2) {
  return min(max(raw, 0), C2 - 1);
}

template <int K>
__device__ void sweep(const Fwd& L, char* sm, const int* st, float penalty,
                      int len, int ulen, int T, float* hist_n, float* loss) {
  static_assert(K % 4 == 0, "a state's type from its register");
  const int ls = threadIdx.x;
  const int S = L.S;

  float a[K];
  uint32_t same = 0;   // bit j: a label whose label repeats the one at s-4
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = ls * K + j;
    a[j] = NEG;
    if (s % 4 == 3 && s >= 4 && s < S && st[(s - 1) / 2] == st[(s - 5) / 2])
      same |= 1u << j;
  }
  fwd_sweep<K>(L, sm, len, T, hist_n, a,
               [&](int, float prev, const float (&e)[K], float (&x)[K]) {
    float v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // (indices mod K: the branch not taken is a valid register too)
      const float l1 = j > 0 ? x[(j + K - 1) % K] : prev;
      if (j % 4 == 0) {
        v[j] = lse2(l1, x[j]);
      } else if (j % 4 == 1) {
        v[j] = lse3(l1, x[j], x[(j + 1) % K]) + penalty;
      } else if (j % 4 == 2) {
        v[j] = lse2(l1, x[j]);
      } else {
        const float l4 = j >= 4 ? x[(j + K - 4) % K] : prev;
        v[j] = lse4(x[(j + K - 3) % K], l1, x[(j + K - 2) % K],
                    (same >> j) & 1 ? FILL : l4);
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = ls * K + j < S ? v[j] + e[j] : NEG;
  });

  // the loss: the last four states (4u-1 .. 4u+2; state -1 the start lane)
  float* fin = reinterpret_cast<float*>(sm + L.fin);
  const int f0 = 4 * ulen - 1;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = ls * K + j;
    if (s >= f0 && s <= f0 + 3) fin[s - f0] = a[j];
  }
  if (ls == 0 && f0 < 0) fin[0] = NEG;
  sweep_bar(L.lanes);
  if (ls == 0) {
    float final_score = NEG;
    if (len > 0) {
      const float a0 = fin[0], b0 = fin[1], c0 = fin[2], d0 = fin[3];
      const float m = fmaxf(fmaxf(fmaxf(fmaxf(a0, b0), c0), d0), NEG);
      final_score = m + logf(expf(d0 - m) + expf(c0 - m) + expf(b0 - m) +
                             expf(a0 - m));
    }
    *loss = -final_score;
  }
}

template <int K>
__global__ void __launch_bounds__(fwd_max_threads(K))
    star_fwd(const float* __restrict__ star_lp,      // (T, N, C2)
             const int* __restrict__ star_targets,   // (N, 2U+1)
             const int* __restrict__ input_lengths,  // (N,)
             const int* __restrict__ target_lengths, // (N,)
             float* __restrict__ loss,               // (N,)
             float* __restrict__ hist,  // (N, T, S) or null
             float penalty, int T, int N, int C2, int U, int sweep_warps,
             int loaders, int frames, int depth) {
  extern __shared__ __align__(16) char sm[];
  const int S = 4 * U + 3;
  const Fwd L = fwd_layout(S, K, sweep_warps, loaders, frames, depth);
  const int n = blockIdx.x;
  const int* st = star_targets + (size_t)n * (2 * U + 1);
  fwd_init(L, sm, [&](int s) {
    return (s % 2) ? clamp_class(st[(s - 1) / 2], C2) : 0;
  });
  const int len = max(min(input_lengths[n], T), 0);
  if (threadIdx.x < L.lanes) {
    const int ulen = min(max(target_lengths[n], 0), U);
    sweep<K>(L, sm, st, penalty, len, ulen, T,
             hist ? hist + (size_t)n * T * S : nullptr, loss + n);
  } else {
    fwd_load<K>(L, sm, star_lp + (size_t)n * C2, (size_t)N * C2, len);
  }
}

template <int K>
cudaError_t launch(const Fwd& L, cudaStream_t stream, const float* lp,
                   const int* st, const int* il, const int* tl, float* loss,
                   float* hist, float penalty, int T, int N, int C2, int U) {
  static unsigned done = 0;
  const cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(star_fwd<K>), 232448);
  if (err != cudaSuccess) return err;
  star_fwd<K><<<N, 32 * (L.sweep + L.loaders), L.bytes, stream>>>(
      lp, st, il, tl, loss, hist, penalty, T, N, C2, U, L.sweep, L.loaders,
      L.frames, L.depth);
  return cudaGetLastError();
}

}  // namespace

// star_lp (T, N, C2) fp32, the star-vocabulary log-probs; star_targets
// (N, 2U+1), input_lengths and target_lengths (N,) int32; loss (N,) fp32;
// hist (N, T, 4U+3) fp32 or null. The plan (ops/lattice_cuda.py
// forward_plan): K states a lane (4 or 8), sweep and loader
// warps, frames a ring slot, the ring's slots and the shared-memory bytes.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a plan that
// does not fit the lattice).
extern "C" int hl_star_fwd(const void* star_lp, const void* star_targets,
                           const void* input_lengths,
                           const void* target_lengths, void* loss, void* hist,
                           float penalty, int T, int N, int C2, int U, int K,
                           int sweep_warps, int loaders, int frames,
                           int depth, int smem, void* stream) {
  const Fwd L =
      fwd_layout(4 * U + 3, K, sweep_warps, loaders, frames, depth);
  if (N <= 0 || C2 <= 0 || U < 0 || smem < 0 || !fwd_plan_ok(L, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lp = static_cast<const float*>(star_lp);
  const auto tg = static_cast<const int*>(star_targets);
  const auto il = static_cast<const int*>(input_lengths);
  const auto tl = static_cast<const int*>(target_lengths);
  const auto ls = static_cast<float*>(loss);
  const auto h = static_cast<float*>(hist);
  cudaError_t err;
  switch (K) {
    case 4:
      err = launch<4>(L, st, lp, tg, il, tl, ls, h, penalty, T, N, C2, U);
      break;
    case 8:
      err = launch<8>(L, st, lp, tg, il, tl, ls, h, penalty, T, N, C2, U);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the --phases build's stamps of the last launch (block 0's frames)
extern "C" int hl_star_fwd_phases(void* out) { return hl::copy_phases(out); }
#endif
