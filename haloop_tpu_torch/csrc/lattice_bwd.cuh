// The backward pieces of the lattice skeleton (lattice.cuh), shared by the
// lattice backward kernels K4 (ctc_bwd.cu) and K8b (star_bwd.cu): one
// block an utterance, warp-specialized.
//
//   * Sweep warps (a warpgroup, or fewer for short lattices) run the
//     reverse beta sweep and nothing else: lane l of the sweep owns the
//     contiguous states l K .. l K + K - 1 in registers. A state's right
//     neighbours come from the lane's own registers or from the next lane
//     by __shfl_down_sync (K8b's left one, its back edge, from the lane's
//     own, or masked); only the first lane of each warp hands its edge
//     values to the previous warp through shared memory, behind a named
//     barrier of the sweep warps (bar.sync 1), never __syncthreads. A frame reads its
//     emissions from, and writes its betas into, a ring in shared memory.
//   * Scatter warps feed the ring and drain it. Ahead of the sweep they
//     bring each frame's alpha history row and gathered emissions into the
//     ring by cp.async, completing on an mbarrier (cp.async.mbarrier.
//     arrive.noinc); behind it they sum each class's
//     d em = -g exp(clip(alpha + beta - logZ)) over its states, in one
//     fixed order, into a shared-memory row of the frame: a class of more
//     than LONG states summed by a warp (lane i takes the class's states
//     i, i + 32, ... in order, then a fixed butterfly of shuffles), a
//     shorter one by one thread in state order, the classes with states
//     dealt round-robin; then (after the group's named barrier) each
//     C-wide row is copied out whole and coalesced (float4 where C % 4 ==
//     0), zeroed behind. They work in two groups that take alternate
//     slots, so that two slots are in flight. No atomics: the bits are
//     the same on every run. Rows of frames past the item's length are
//     zeros and need no sweep.
//   * The ring holds `depth` slots of `frames` frames each (em, alpha and
//     beta rows); three mbarriers a slot order it: in (the loads landed;
//     the scatter threads arrive), beta (the sweep wrote the slot's betas)
//     and empty (the scatter read them). The sweep meets them once a slot,
//     not once a frame.
//
// Ring rows are transposed, so that each sweep lane's accesses are free of
// bank conflicts: state s = l K + j sits at j * LANES + l (LANES = 32 x
// sweep warps). The class lists hold these addresses. The layout below is
// the one ops/lattice_cuda.py plans; the wrappers pass the plan and the
// launcher refuses a plan whose size differs from this layout's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "lattice.cuh"

namespace hl {
namespace lat {

constexpr int LONG = 4;         // classes of more states: a warp's sum
constexpr int LONG_REGS = 8;    // a long class's addresses a lane keeps
constexpr int GROUPS = 2;       // scatter groups, taking alternate slots

struct Layout {
  int S, C, K, lanes, sweep, scatter, frames, depth, slot;
  bool dense;   // the gradient rows staged in shared memory
  size_t bars, edge, longs, shorts, start, order, lab, rows, ring, bytes;
};

// byte offsets into the block's dynamic shared memory:
//   bars   in[depth], beta[depth], empty[depth] (mbarriers)
//   edge   [2 parities][sweep warps][8] floats: lane 0's q[0..3] (K4
//          reads two), the rest padding
//   longs  [0] the count, then the long classes in class order
//   shorts [0] the count, then the other classes with states, in order
//   start  [C+1] class c's addresses are order[start[c] .. start[c+1])
//   order  [S] ring addresses, by class, in state order within a class
//   lab    [S] each state's class (the emission gather), by state
//   rows   [GROUPS][2][frames][C] floats (dense plans): each scatter
//          group's gradient rows of a slot, double-buffered, zero but for
//          the class sums between their writing and their copying out; a
//          plan whose rows do not fit writes the sums straight to the
//          gradient and zeros its empty columns
//   ring   [depth][3][frames][slot] floats: em, alpha, beta rows (the
//          lists' scratch before the roles start)
__host__ __device__ inline Layout layout(int S, int C, int K, int sweep,
                                         int scatter, int frames, int depth,
                                         bool dense) {
  Layout L;
  L.S = S;
  L.C = C;
  L.K = K;
  L.lanes = 32 * sweep;
  L.sweep = sweep;
  L.scatter = scatter;
  L.frames = frames;
  L.depth = depth;
  L.dense = dense;
  L.slot = K * L.lanes;
  size_t o = 0;
  L.bars = o;
  o += align16(3 * (size_t)depth * 8);
  L.edge = o;
  o += align16(2 * (size_t)sweep * 8 * 4);
  L.longs = o;
  o += align16(((size_t)S / (LONG + 1) + 2) * 4);
  L.shorts = o;
  o += align16(((size_t)S + 1) * 4);
  L.start = o;
  o += align16(((size_t)C + 1) * 4);
  L.order = o;
  o += align16((size_t)S * 4);
  L.lab = o;
  o += align16((size_t)S * 4);
  L.rows = o;
  o += dense ? align16((size_t)GROUPS * 2 * frames * C * 4) : 0;
  L.ring = o;
  o += (size_t)depth * 3 * frames * L.slot * 4;
  L.bytes = o;
  return L;
}

// the launcher's check of a plan: every state owned, the block's warps,
// the ring, and the plan's shared-memory size equal to this layout's
inline bool plan_ok(const Layout& L, size_t smem) {
  return L.S >= 1 && L.C >= 1 && L.sweep >= 1 && L.sweep <= 4 &&
         L.scatter >= GROUPS && L.scatter % GROUPS == 0 &&
         32 * (L.sweep + L.scatter) <= max_threads(L.K) && L.frames >= 1 &&
         L.frames <= MAX_FRAMES && L.depth >= 2 && L.depth <= MAX_DEPTH &&
         L.depth % GROUPS == 0 && L.slot >= L.S && L.bytes == smem &&
         smem <= 232448;
}

// the named barrier of scatter group g (2 + g)
__device__ __forceinline__ void group_bar(int g, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + g), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t in_bar(const Layout& L, char* sm,
                                           int r) {
  return smem_u32(sm + L.bars) + 8 * r;
}
__device__ __forceinline__ uint32_t beta_bar(const Layout& L, char* sm,
                                             int r) {
  return smem_u32(sm + L.bars) + 8 * (L.depth + r);
}
__device__ __forceinline__ uint32_t empty_bar(const Layout& L, char* sm,
                                              int r) {
  return smem_u32(sm + L.bars) + 8 * (2 * L.depth + r);
}

// row `kind` (0 em, 1 alpha, 2 beta) of frame f of slot r
__device__ __forceinline__ float* ring_row(const Layout& L, char* sm, int r,
                                           int kind, int f) {
  return reinterpret_cast<float*>(sm + L.ring) +
         ((size_t)(r * 3 + kind) * L.frames + f) * L.slot;
}

// Entry of every thread of the block: the mbarriers, each state's class in
// lab, and the class lists: class c's ring addresses in state order, and
// the classes of more than LONG states. class_of(s) is the class of state
// s in [0, C). Ends in __syncthreads.
template <int K, class ClassOf>
__device__ inline void build_lists(const Layout& L, char* sm,
                                   ClassOf class_of) {
  int* longs = reinterpret_cast<int*>(sm + L.longs);
  int* shorts = reinterpret_cast<int*>(sm + L.shorts);
  int* start = reinterpret_cast<int*>(sm + L.start);
  int* order = reinterpret_cast<int*>(sm + L.order);
  int* lab = reinterpret_cast<int*>(sm + L.lab);
  float* rows = reinterpret_cast<float*>(sm + L.rows);
  int* rank = reinterpret_cast<int*>(sm + L.ring);   // scratch: S, 32
  int* warp_tot = rank + L.S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int r = 0; r < L.depth; ++r) {
      mbar_init(in_bar(L, sm, r), 32 * L.scatter / GROUPS);
      mbar_init(beta_bar(L, sm, r), 32 * L.sweep);
      mbar_init(empty_bar(L, sm, r), 32 * L.scatter / GROUPS);
    }
    fence_barrier_init();
  }
  for (int s = tid; s < L.S; s += nt) lab[s] = class_of(s);
  for (int c = tid; c <= L.C; c += nt) start[c] = 0;
  if (L.dense)
    for (int i = tid; i < GROUPS * 2 * L.frames * L.C; i += nt) rows[i] = 0.f;
  __syncthreads();

  // a state's rank in its class, in state order: warp 0 walks the states
  // 32 at a time, each class's running count in start[]
  if (warp == 0) {
    for (int s0 = 0; s0 < L.S; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < L.S;
      const int c = live ? lab[s] : -1 - lane;     // dead lanes: alone
      const unsigned same = __match_any_sync(0xffffffffu, c);
      if (live) rank[s] = start[c] + __popc(same & ((1u << lane) - 1));
      __syncwarp();
      if (live && 31 - __clz(same) == lane) start[c] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();

  // exclusive scan of the C + 1 counts: each thread a contiguous chunk,
  // then a scan of the chunk totals across the block
  const int per = (L.C + nt) / nt;
  const int lo = min(tid * per, L.C + 1), hi = min(lo + per, L.C + 1);
  int local = 0;
  for (int c = lo; c < hi; ++c) local += start[c];
  int incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int run = incl - local;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  for (int c = lo; c < hi; ++c) {
    const int v = start[c];
    start[c] = run;
    run += v;
  }
  __syncthreads();
  for (int s = tid; s < L.S; s += nt)
    order[start[lab[s]] + rank[s]] = addr_of<K>(L.lanes, s);
  if (warp < 2) {       // the long classes, and the others with states
    int* list = warp == 0 ? longs : shorts;
    int count = 0;
    for (int c0 = 0; c0 < L.C; c0 += 32) {
      const int c = c0 + lane;
      const int m = c < L.C ? start[c + 1] - start[c] : 0;
      const bool in = warp == 0 ? m > LONG : m > 0 && m <= LONG;
      const unsigned b = __ballot_sync(0xffffffffu, in);
      if (in) list[1 + count + __popc(b & ((1u << lane) - 1))] = c;
      count += __popc(b);
    }
    if (lane == 0) list[0] = count;
  }
  __syncthreads();
}

// The sweep's meetings with the ring, once a slot: before slot b's frames
// (their emissions landed; the scatter read the slot's previous betas),
// and after them (the betas are written).
__device__ __forceinline__ void sweep_enter(const Layout& L, char* sm,
                                            int b) {
  const int r = b % L.depth;
  bar_wait(in_bar(L, sm, r), (b / L.depth) & 1);
  if (b >= L.depth)
    bar_wait(empty_bar(L, sm, r), ((b / L.depth) + 1) & 1);
}
__device__ __forceinline__ void sweep_leave(const Layout& L, char* sm,
                                            int b) {
  mbar_arrive(beta_bar(L, sm, b % L.depth));
}

// -g e^clip(alpha + beta - logZ, -60, 60) at ring address a
__device__ __forceinline__ float dem(const float* al, const float* be,
                                     int a, float logZ, float gn) {
  const float x = fminf(fmaxf(al[a] + be[a] - logZ, -60.f), 60.f);
  return -gn * ex2(x * L2E);
}

// The scatter warps, in GROUPS groups: group g takes the slots b = g, g +
// GROUPS, ... (the ring's depth a multiple of GROUPS, so a slot always
// belongs to one group). For each slot: the class sums, each state's
// d em computed where it is summed (a state is in one class); the group's
// named barrier (the slot is read, its rows are complete); the slot handed
// back to the sweep and refilled; the rows copied out. `hist_n` is the
// item's alpha history (T, S), `em_n` its emission row at t = 0 (rows
// `em_step` apart; the state's class added), `out` its gradient row at
// t = 0 (rows `t_stride` apart).
template <int K>
__device__ inline void scatter(const Layout& L, char* sm,
                               const float* hist_n, const float* em_n,
                               size_t em_step, float* out, size_t t_stride,
                               int T, int len, float logZ, float gn) {
  const int tid = threadIdx.x - L.lanes, nsc = 32 * L.scatter;
  const int nsg = nsc / GROUPS, gid = tid / nsg, gt = tid % nsg;
  const int wg = L.scatter / GROUPS, warp = gt >> 5, lane = tid & 31;
  const int* longs = reinterpret_cast<const int*>(sm + L.longs);
  const int* shorts = reinterpret_cast<const int*>(sm + L.shorts);
  const int* start = reinterpret_cast<const int*>(sm + L.start);
  const int* order = reinterpret_cast<const int*>(sm + L.order);
  const int* lab = reinterpret_cast<const int*>(sm + L.lab);
  float* rows = reinterpret_cast<float*>(sm + L.rows);
  const int F = L.frames, R = L.depth;
  const int nb = (len + F - 1) / F;

  // slot b's loads: each thread of the group the states gt, gt + nsg, ...,
  // every frame of the slot
  auto load = [&](int b) {
    const int r = b % R;
    const int nf = min(F, len - b * F), t0 = len - 1 - b * F;
    float* em = ring_row(L, sm, r, 0, 0);
    float* al = ring_row(L, sm, r, 1, 0);
    for (int s = gt; s < L.S; s += nsg) {
      const int a = addr_of<K>(L.lanes, s);
      const float* h = hist_n + (size_t)t0 * L.S + s;
      const float* e = em_n + (size_t)t0 * em_step + lab[s];
#pragma unroll
      for (int f = 0; f < MAX_FRAMES; ++f) {
        if (f < nf) {
          cp_async4(al + (size_t)f * L.slot + a, h - (size_t)f * L.S);
          cp_async4(em + (size_t)f * L.slot + a, e - (size_t)f * em_step);
        }
      }
    }
    cp_async_arrive(in_bar(L, sm, r));
  };
  for (int b = gid; b < R && b < nb; b += GROUPS) load(b);

  for (int t = len; t < T; ++t) {
    float* o = out + (size_t)t * t_stride;
    for (int c = tid; c < L.C; c += nsc) o[c] = 0.f;
  }

  // this warp's first long class: the addresses of its lane's states
  const int n_long = longs[0], n_short = shorts[0];
  int lb = 0, le = 0;
  if (warp < n_long) {
    lb = start[longs[1 + warp]];
    le = start[longs[1 + warp] + 1];
  }
  int lregs[LONG_REGS];
#pragma unroll
  for (int x = 0; x < LONG_REGS; ++x) {
    const int k = lb + lane + 32 * x;
    lregs[x] = k < le ? order[k] : -1;
  }
  const bool vec = (L.C & 3) == 0;   // 16-byte rows: copied as float4

  for (int b = gid; b < nb; b += GROUPS) {
    const int r = b % R;
    const int nf = min(F, len - b * F);
    const long long ts0 = stamp();
    bar_wait(in_bar(L, sm, r), (b / R) & 1);
    bar_wait(beta_bar(L, sm, r), (b / R) & 1);
    const long long ts1 = stamp();
    float* row = rows + (size_t)(gid * 2 + ((b / GROUPS) & 1)) * F * L.C;
    // where class c's sum of frame f goes
    auto sum_at = [&](int f, int c) -> float* {
      return L.dense ? row + f * L.C + c
                     : out + (size_t)(len - 1 - b * F - f) * t_stride + c;
    };
    // the slot's frames, unrolled: frame f reads row min(f, F - 1) of the
    // slot (a row that exists) and writes only where f < nf, so that the
    // frames' chains overlap
    const float* al[MAX_FRAMES];
    const float* be[MAX_FRAMES];
#pragma unroll
    for (int f = 0; f < MAX_FRAMES; ++f) {
      al[f] = ring_row(L, sm, r, 1, min(f, F - 1));
      be[f] = ring_row(L, sm, r, 2, min(f, F - 1));
    }
    // the class sums: a short class a thread (its states in order), a
    // long one a warp
    for (int k = gt; k < n_short; k += nsg) {
      const int c = shorts[1 + k];
      const int b0 = start[c], m = start[c + 1] - b0;
      int a[LONG];
#pragma unroll
      for (int x = 0; x < LONG; ++x) a[x] = order[b0 + min(x, m - 1)];
      float v[MAX_FRAMES];
#pragma unroll
      for (int f = 0; f < MAX_FRAMES; ++f) {
        v[f] = 0.f;
#pragma unroll
        for (int x = 0; x < LONG; ++x) {
          const float u = dem(al[f], be[f], a[x], logZ, gn);
          v[f] += x < m ? u : 0.f;
        }
      }
#pragma unroll
      for (int f = 0; f < MAX_FRAMES; ++f)
        if (f < nf) *sum_at(f, c) = v[f];
    }
    for (int k = warp; k < n_long; k += wg) {
      const int c = longs[1 + k];
      const int e = start[c + 1];
      float v[MAX_FRAMES];
#pragma unroll
      for (int f = 0; f < MAX_FRAMES; ++f) v[f] = 0.f;
      if (k == warp) {
#pragma unroll
        for (int x = 0; x < LONG_REGS; ++x) {
          const int a = lregs[x] >= 0 ? lregs[x] : 0;
#pragma unroll
          for (int f = 0; f < MAX_FRAMES; ++f) {
            const float u = dem(al[f], be[f], a, logZ, gn);
            v[f] += lregs[x] >= 0 ? u : 0.f;
          }
        }
      }
      for (int x = start[c] + lane + (k == warp ? 32 * LONG_REGS : 0);
           x < e; x += 32) {
        const int a = order[x];
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f)
          v[f] += dem(al[f], be[f], a, logZ, gn);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f)
          v[f] += __shfl_xor_sync(0xffffffffu, v[f], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f)
          if (f < nf) *sum_at(f, c) = v[f];
      }
    }
    group_bar(gid, nsg);         // the slot is read; its rows are complete
    const long long ts2 = stamp();
    mbar_arrive(empty_bar(L, sm, r));
    if (b + R < nb) load(b + R);
    const long long ts3 = stamp();
    // copy the rows out whole, zeroing them behind (or, without staged
    // rows, zero the empty columns)
    if (!L.dense) {
      for (int c = gt; c < L.C; c += nsg) {
        if (start[c + 1] != start[c]) continue;
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f)
          if (f < nf) out[(size_t)(len - 1 - b * F - f) * t_stride + c] = 0.f;
      }
    } else if (vec) {
      for (int c = 4 * gt; c < L.C; c += 4 * nsg) {
        float4 v[MAX_FRAMES];
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f)
          v[f] = *reinterpret_cast<const float4*>(row + min(f, F - 1) * L.C +
                                                  c);
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f) {
          if (f < nf) {
            *reinterpret_cast<float4*>(row + f * L.C + c) =
                make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(
                out + (size_t)(len - 1 - b * F - f) * t_stride + c) = v[f];
          }
        }
      }
    } else {
      for (int c = gt; c < L.C; c += nsg) {
#pragma unroll
        for (int f = 0; f < MAX_FRAMES; ++f) {
          if (f < nf) {
            out[(size_t)(len - 1 - b * F - f) * t_stride + c] =
                row[f * L.C + c];
            row[f * L.C + c] = 0.f;
          }
        }
      }
    }
    // the --phases build's cycles of group 0's slot b: ring wait, class
    // sums, refill, copy-out
    const bool ph_on = blockIdx.x == 0 && tid == 0;
    keep_phase(ph_on, 4, b / GROUPS, ts1 - ts0);
    keep_phase(ph_on, 5, b / GROUPS, ts2 - ts1);
    keep_phase(ph_on, 6, b / GROUPS, ts3 - ts2);
    keep_phase(ph_on, 7, b / GROUPS, stamp() - ts3);
  }
  cp_async_wait_all();
}

}  // namespace lat
}  // namespace hl
