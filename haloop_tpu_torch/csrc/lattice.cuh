// The skeleton shared by the lattice kernels written for Hopper: the
// forwards K3 and K8a (ctc_fwd.cu, star_fwd.cu, on this file's forward
// pieces) and the backwards K4 and K8b (ctc_bwd.cu, star_bwd.cu, on
// lattice_bwd.cuh). One block an utterance, warp-specialized:
//
//   * Sweep warps (a warpgroup, up to 16 for the forward's longest
//     lattices, fewer for short ones) run the frames' serial stencil and
//     nothing else: lane l of the sweep owns the contiguous states l K ..
//     l K + K - 1 in registers. A state's neighbours come from the lane's own
//     registers or a neighbouring lane's by shuffle; only the lanes at a
//     warp's edge hand their values to the next warp through shared memory,
//     behind a named barrier of the sweep warps (bar.sync 1), or in the
//     forwards' long lattices as a tagged word the next warp waits for (no
//     barrier: a warp runs ahead of the next), never __syncthreads. The
//     sweep reads each frame's gathered emissions from a
//     ring in shared memory and meets the ring's mbarriers once a slot of
//     `frames` frames, not once a frame.
//   * The other warps feed the ring by cp.async (each state's emission
//     gathered from its class's column, completing on an mbarrier by
//     cp.async.mbarrier.arrive.noinc), `depth` slots ahead; in the
//     backwards they also drain it (lattice_bwd.cuh).
//
// Ring rows are transposed, so that each sweep lane's accesses are free of
// bank conflicts: state s = l K + j sits at j * LANES + l (LANES = 32 x
// sweep warps). lse is taken in log2 units, ex2 and lg2 of the special
// function unit, log2(e) folded in after the exact difference.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace hl {
namespace lat {

constexpr int MAX_FRAMES = 4;
constexpr int MAX_DEPTH = 4;
constexpr int MAX_WARPS = 12;   // the warps of a block

// the kernels' launch bound for K states a lane: from 16 on, 8 warps (the
// sweep's registers)
__host__ __device__ constexpr int max_threads(int K) {
  return K >= 16 ? 256 : 32 * MAX_WARPS;
}
constexpr float L2E = 1.4426950408889634f;
constexpr float LN2 = 0.69314718055994531f;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^(a - m), with log2(e) folded in after the exact difference
__device__ __forceinline__ float exp_rel(float a, float m) {
  return ex2((a - m) * L2E);
}

__device__ __forceinline__ void sweep_bar(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// wait until the phase of parity ``parity`` has completed, the thread
// suspended meanwhile (a time hint of 10 ms, as CUTLASS's barriers): a
// waiting warp leaves its sub-partition's issue slots to the others
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(0x989680)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the mbarrier's arrival once this thread's earlier cp.asyncs have landed
// (its count holds one arrival a thread: noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// state s's address in a ring row of `lanes` sweep lanes (K states a lane,
// a power of 2)
template <int K>
__device__ __forceinline__ int addr_of(int lanes, int s) {
  return (s % K) * lanes + s / K;
}

// ------------------------------------------------------------ the forward

// the TPU kernels' big-finite mask: the start lane from the second frame on
constexpr float LAT_NEG = -1e9f;

constexpr int FWD_MAX_SWEEP = 16;    // sweep warps
// a warp's edge words in the forward: more than a warp can run ahead of
// the next (the ring holds it to depth x frames + frames - 1 <= 19)
constexpr int FWD_EDGES = 32;

// the forward hands its warps' edges on as tagged words from 8 states a
// lane on (the long lattices: up to 16 sweep warps, whose barrier a frame
// cost ~40% of K3's time at 4,095 states on the H100), behind the sweep's
// barrier below (a warpgroup or less: there the words' waits cost ~10%
// more than the barrier; PERF.md)
__host__ __device__ constexpr bool fwd_tagged(int K) { return K >= 8; }

// the forward's launch bound for K states a lane: 12 warps at 2 and 4
// states a lane (a wider bound cost K8a's K = 4 a quarter of its speed on
// the H100: fewer registers a thread), 18 at 8 (16 sweep warps hold 4,096
// states)
__host__ __device__ constexpr int fwd_max_threads(int K) {
  return K >= 8 ? 32 * 18 : 32 * MAX_WARPS;
}

struct Fwd {
  int S, K, lanes, sweep, loaders, frames, depth, slot;
  size_t bars, edge, fin, lab, ring, bytes;
};

// byte offsets into the forward's dynamic shared memory (the layout
// ops/lattice_cuda.py forward_plan sizes; the launcher refuses a plan
// whose size differs):
//   bars   in[depth], empty[depth] (mbarriers)
//   edge   [sweep warps][FWD_EDGES] 64-bit words: each warp's last lane's
//          last state of frame i with its tag i, at i % FWD_EDGES, for the
//          next warp's first lane (fwd_tagged); else the first [2
//          parities][sweep warps] floats, behind the sweep's barrier
//   fin    [4] floats: the last four states' alphas (the loss)
//   lab    [S] each state's class (the emission gather), by state
//   ring   [depth][frames][slot] floats: the gathered emission rows
__host__ __device__ inline Fwd fwd_layout(int S, int K, int sweep,
                                          int loaders, int frames,
                                          int depth) {
  Fwd L;
  L.S = S;
  L.K = K;
  L.lanes = 32 * sweep;
  L.sweep = sweep;
  L.loaders = loaders;
  L.frames = frames;
  L.depth = depth;
  L.slot = K * L.lanes;
  size_t o = 0;
  L.bars = o;
  o += align16(2 * (size_t)depth * 8);
  L.edge = o;
  o += (size_t)sweep * FWD_EDGES * 8;
  L.fin = o;
  o += 16;
  L.lab = o;
  o += align16((size_t)S * 4);
  L.ring = o;
  o += (size_t)depth * frames * L.slot * 4;
  L.bytes = o;
  return L;
}

// the launcher's check of a forward plan: every state owned, the block's
// warps, the ring, and the plan's shared-memory size equal to the layout's
inline bool fwd_plan_ok(const Fwd& L, size_t smem) {
  return L.S >= 1 && L.sweep >= 1 && L.sweep <= FWD_MAX_SWEEP &&
         L.loaders >= 1 &&
         32 * (L.sweep + L.loaders) <= fwd_max_threads(L.K) &&
         L.frames >= 1 && L.frames <= MAX_FRAMES && L.depth >= 2 &&
         L.depth <= MAX_DEPTH && L.slot >= L.S && L.bytes == smem &&
         smem <= 232448;
}

__device__ __forceinline__ uint32_t fwd_in_bar(const Fwd& L, char* sm,
                                               int r) {
  return smem_u32(sm + L.bars) + 8 * r;
}
__device__ __forceinline__ uint32_t fwd_empty_bar(const Fwd& L, char* sm,
                                                  int r) {
  return smem_u32(sm + L.bars) + 8 * (L.depth + r);
}

// the emission row of frame f of slot r
__device__ __forceinline__ float* fwd_row(const Fwd& L, char* sm, int r,
                                          int f) {
  return reinterpret_cast<float*>(sm + L.ring) +
         ((size_t)r * L.frames + f) * L.slot;
}

// Entry of every thread of the block: the mbarriers, the edge words' tags
// (none: ~0) and each state's class in lab (class_of(s) in [0, C)). Ends
// in __syncthreads.
template <class ClassOf>
__device__ inline void fwd_init(const Fwd& L, char* sm, ClassOf class_of) {
  int* lab = reinterpret_cast<int*>(sm + L.lab);
  unsigned long long* edges =
      reinterpret_cast<unsigned long long*>(sm + L.edge);
  for (int k = threadIdx.x; k < L.sweep * FWD_EDGES; k += blockDim.x)
    edges[k] = ~0ull;
  if (threadIdx.x == 0) {
    for (int r = 0; r < L.depth; ++r) {
      mbar_init(fwd_in_bar(L, sm, r), 32 * L.loaders);
      mbar_init(fwd_empty_bar(L, sm, r), 32 * L.sweep);
    }
    fence_barrier_init();
  }
  for (int s = threadIdx.x; s < L.S; s += blockDim.x) lab[s] = class_of(s);
  __syncthreads();
}

// The sweep's meetings with the ring, once a slot: before slot b's frames
// (their emissions landed) and after them (the slot may be refilled).
__device__ __forceinline__ void fwd_enter(const Fwd& L, char* sm, int b) {
  bar_wait(fwd_in_bar(L, sm, b % L.depth), (b / L.depth) & 1);
}
__device__ __forceinline__ void fwd_leave(const Fwd& L, char* sm, int b) {
  mbar_arrive(fwd_empty_bar(L, sm, b % L.depth));
}

// The loader warps: for each slot b of the item's `len` frames, once the
// sweep has left the slot's previous use, the emissions of frames b F ..
// b F + F - 1 at their ring addresses: each odd state's, and the blank's
// (class 0, every even state's in both lattices) once, at state 0's; the
// loader threads take them in turn; `em_n` is the item's emission row at
// t = 0 (rows `em_step` apart; the state's class added).
template <int K>
__device__ inline void fwd_load(const Fwd& L, char* sm, const float* em_n,
                                size_t em_step, int len) {
  const int tid = threadIdx.x - L.lanes, nl = 32 * L.loaders;
  const int* lab = reinterpret_cast<const int*>(sm + L.lab);
  const int F = L.frames, R = L.depth;
  const int nb = (len + F - 1) / F;
  for (int b = 0; b < nb; ++b) {
    const int r = b % R;
    if (b >= R) bar_wait(fwd_empty_bar(L, sm, r), ((b / R) + 1) & 1);
    const int nf = min(F, len - b * F);
    float* em = fwd_row(L, sm, r, 0);
    const float* src = em_n + (size_t)b * F * em_step;
    for (int k = tid; k < (L.S + 1) / 2; k += nl) {
      const int s = k ? 2 * k - 1 : 0;   // the blank, then the odd states
      const int a = addr_of<K>(L.lanes, s);
      const float* e = src + lab[s];
#pragma unroll
      for (int f = 0; f < MAX_FRAMES; ++f)
        if (f < nf)
          cp_async4(em + (size_t)f * L.slot + a, e + (size_t)f * em_step);
    }
    cp_async_arrive(fwd_in_bar(L, sm, r));
  }
  cp_async_wait_all();
}

// a lane's K states to p, those of them in the lattice (`valid`): where K
// is a multiple of 4 and every state is, 16-byte stores where p is 16-byte
// aligned, 8-byte where it is 8-byte aligned (either the same for every
// lane of a warp); else single stores, predicated, not branched
template <int K>
__device__ __forceinline__ void store_run(float* p, const float (&a)[K],
                                          int valid) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(p);
  if (K % 4 == 0 && valid >= K && (x & 15) == 0) {
#pragma unroll
    for (int j = 0; j + 3 < K; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
  } else if (K % 4 == 0 && valid >= K && (x & 7) == 0) {
#pragma unroll
    for (int j = 0; j + 1 < K; j += 2)
      *reinterpret_cast<float2*>(p + j) = make_float2(a[j], a[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < valid) p[j] = a[j];
  }
}

// The sweep warps' frames, K3's and K8a's: for each slot of the item's
// `len` frames the ring is met once (fwd_enter, fwd_leave); for each frame
// i, the lane's K emissions come from the slot's row (an even state's, a
// blank's, from state 0's place by broadcast), `prev` is the previous
// lane's last state (a shuffle; across a warp's edge the previous warp's
// state of frame i - 1; before state 0 the start lane, 0 at the first
// frame and LAT_NEG after), and step(i, prev, e, a) replaces the lane's
// alphas a with frame i's; the history row (N, T, S) is stored straight
// from the registers. A warp's last state goes to the next warp behind
// the sweep's barrier, or (fwd_tagged) at once as its tagged edge word,
// which the next warp waits for: no barrier, a warp runs as far ahead of
// the next as the ring lets it. Selects, not branches, wherever lanes
// differ. The rows past the input length hold the frozen lattice, stored
// without stepping the stencil or meeting the ring. Built with
// -DHL_PHASES, block 0's lane 0 keeps each frame's cycles: its slot's ring
// wait (at the slot's first frame), the stencil (with the tagged words,
// their wait too), the history row, the edge barrier.
template <int K, class Step>
__device__ __forceinline__ void fwd_sweep(const Fwd& L, char* sm, int len,
                                          int T, float* hist_n,
                                          float (&a)[K], Step step) {
  const int ls = threadIdx.x, w = ls >> 5, lane = ls & 31;
  float* edge = reinterpret_cast<float*>(sm + L.edge);
  volatile unsigned long long* words =
      reinterpret_cast<unsigned long long*>(sm + L.edge);
  const int F = L.frames;
  const bool ph_on = blockIdx.x == 0 && ls == 0;
  for (int b = 0; b * F < len; ++b) {
    const long long tw = stamp();
    fwd_enter(L, sm, b);
    long long ring_wait = stamp() - tw;
    for (int f = 0; f < F && b * F + f < len; ++f) {
      const int i = b * F + f;
      const long long ts0 = stamp();
      const float* em = fwd_row(L, sm, b % L.depth, f);
      float e[K];
#pragma unroll
      for (int j = 0; j < K; ++j) e[j] = j % 2 ? em[j * L.lanes + ls] : em[0];
      const float up = __shfl_up_sync(0xffffffffu, a[K - 1], 1);
      float over;
      if (fwd_tagged(K)) {
        over = LAT_NEG;
        if (w > 0 && i > 0) {   // the previous warp's word of frame i - 1
          const volatile unsigned long long* x =
              words + (w - 1) * FWD_EDGES + ((i - 1) & (FWD_EDGES - 1));
          unsigned long long word;
          do {
            word = *x;
          } while (static_cast<unsigned>(word) !=
                   static_cast<unsigned>(i - 1));
          over = __uint_as_float(static_cast<unsigned>(word >> 32));
        }
      } else {   // read by every lane (a broadcast)
        over = i == 0 ? LAT_NEG
                      : edge[((i + 1) & 1) * L.sweep + max(w - 1, 0)];
      }
      const float first = w == 0 ? (i == 0 ? 0.f : LAT_NEG) : over;
      step(i, lane == 0 ? first : up, e, a);
      if (fwd_tagged(K) && lane == 31 && w + 1 < L.sweep)
        words[w * FWD_EDGES + (i & (FWD_EDGES - 1))] =
            static_cast<unsigned long long>(__float_as_uint(a[K - 1])) << 32 |
            static_cast<unsigned>(i);
      const long long ts1 = stamp();
      if (hist_n) store_run<K>(hist_n + (size_t)i * L.S + ls * K, a,
                               L.S - ls * K);
      const long long ts2 = stamp();
      if (!fwd_tagged(K) && L.sweep > 1 && i + 1 < len) {
        if (lane == 31) edge[(i & 1) * L.sweep + w] = a[K - 1];
        sweep_bar(L.lanes);
      }
      keep_phase(ph_on, 0, i, ring_wait);
      keep_phase(ph_on, 1, i, ts1 - ts0);
      keep_phase(ph_on, 2, i, ts2 - ts1);
      keep_phase(ph_on, 3, i, stamp() - ts2);
      ring_wait = 0;
    }
    fwd_leave(L, sm, b);
  }
  if (hist_n)
    for (int t = len; t < T; ++t)
      store_run<K>(hist_n + (size_t)t * L.S + ls * K, a, L.S - ls * K);
}

}  // namespace lat
}  // namespace hl
