// RNN-T joint logsumexp over the vocabulary (backward).
//
// Replaces: haloop_tpu/ops/joint_pallas.py _dfg_kernel (launched by
// _lse_bwd_impl, the VJP of pairwise_lse). Plain version:
// haloop_tpu_torch/ops/joint.py pairwise_lse_grad.
//
// Computes, from f (N, T, V), g (N, U1, V), the forward's lse (N, T, U1)
// and row maxima mf (N, T), mg (N, U1) (K9a writes them beside lse), and
// the upstream gradient dlse (N, T, U1), all fp32, both sums of the joint
// softmax p = dlse e^(f + g - lse): df = sum_u p, dg = sum_t p. In the
// factored form of K9a (ops/joint.py):
//   W  = dlse e^(mf + mg - lse)                 (N, T, U1)
//   df = e^(f - mf) * (W . e^(g - mg))          (T x U1) . (U1 x V)
//   dg = e^(g - mg) * (W^T . e^(f - mf))        (U1 x T) . (T x V)
// an fp32 product on the CUDA cores (FFMA) with N (T + U1) V exponentials
// where the direct form takes N T U1 V. A cell with mf + mg - lse > 64 ln 2
// (its factored sum under 2^-64: where f and g peak at different v) is
// marked: its W is 0 and its exact term dlse e^(f + g - lse) is added to df
// and dg in the same launch. W is 0 by a select where dlse is 0 (frames past
// an item's length), so df is exactly 0 there. W's exponent keeps the
// rounding of mf + mg (two-sum): with logits near 100 the form is then
// nearer the exact sums than the direct fp32 e^(f + g - lse) (PERF.md).
//
// What bounds it on the H100: at rnn-transducer:lstm:512's joint (N=16,
// T'=301, U1=25, V=512) the bytes are f, g, lse, dlse, mf, mg in and df, dg
// out, 22.4 MB (~6.7 us at 3.35 TB/s), against 2 FMAs for each of the 61.6 M
// (cell, column) pairs (~3.7 us at the fp32 rate) and 2.7 M exponentials:
// bound by bytes. At V = 16384 f and df are 315 MB each (~204 us of bytes,
// ~118 us of FMAs).
//
// This design: one block of 8 warps (4 where the grid fills every SM twice:
// two blocks an SM then overlap one's set-up and merge with the other's
// frames) for each (item, slice of 64 vocabulary columns), a lane's 2
// columns its own: it holds e^(g - mg) of its columns
// and their dg sums for a chunk of up to 32 of the U1 rows in registers, and
// computes e^(f - mf) once for each (t, v). The warps take the item's frames
// in groups, 4 a warp, so the whole of T passes through the block:
// - f streams through each thread's own ring of DEPTH frames (RING groups)
//   in shared memory (cp.async of its 8 bytes, a group committed at once; a
//   thread reads only what it copied, so no barrier), one pass over f;
// - each warp computes its 4 frames' W from lse, dlse and the maxima (read a
//   group ahead), lane u a row: the marks by ballot, W into shared memory,
//   which each lane then reads by broadcast as float4: one read feeds 16
//   FMAs (a 4 x 2 block of df's and of dg's sums);
// - a warp takes its 4 frames of a group in one straight run of code, and
//   a frame's W . e^(g - mg) in four partial sums: the latencies of one
//   frame hide under the others' FMAs;
// - dg's sums stay in registers over all T; at the end each warp adds its
//   marked cells' exact terms (summed in shared memory as they come) and
//   the warps' rows are summed in warp order. No partial scratch, no second
//   kernel, no atomics: the same inputs give the same bits.
// Each block recomputes its item's W (N T U1 exponentials a slice: ~1 M at
// (16, 301, 25, 512), 31 M at V = 16384) rather than a prologue writing it
// once: that needs no second launch and no grid-wide order, and costs a few
// percent of the block's FMAs. Past 32 rows of U1 the grid also splits by
// chunk of 32 rows, so that a long target fills the card: a block per chunk
// of U1's rows streams T's frames and writes dg alone, a block per chunk of
// T's rows streams U1's rows of g as its frames and writes df alone (the
// same code with f and g swapped). No sum crosses a block: any U1, and
// still no scratch, no atomics and the same bits every run.
// What holds it back (scripts/joint_probe.py --phases, PERF.md): the 112
// registers of e^(g - mg) and dg's sums leave room for 8 warps an SM, and a
// frame's other instructions beside its 112 FMAs are issued by them.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using hl::ex2;

constexpr int CPT = 2;                 // vocabulary columns a lane
constexpr int SLICE = 32 * CPT;        // a block's columns
constexpr int FW = 4;                  // frames a warp takes of a group
constexpr int DEPTH = 16;              // f frames in flight a thread
constexpr int RING = DEPTH / FW;       // groups of them
constexpr float L2E = 1.4426950408889634f;
constexpr float MARK = 44.3614195558365f;   // 64 ln 2: -ln(2^-64)
static_assert(CPT == 2, "a lane's columns are read and written as float2");
static_assert(DEPTH % FW == 0, "the ring holds whole groups");

struct Layout {
  int ring, red, w, bytes;   // byte offsets
};

// the dynamic shared memory (ops/joint_cuda.py bwd_plan sizes it; the
// launcher refuses a plan whose size differs):
//   ring [DEPTH][32 WARPS][CPT] floats: each thread's f frames
//   red  [WARPS][UC][SLICE] floats: each warp's dg rows (its marked cells'
//        exact terms while the frames pass, then its sums)
//   w    [WARPS][FW][UC] floats: each warp's W rows of the group
__host__ __device__ constexpr Layout layout(int nq, int warps) {
  const int uc = 4 * nq;
  const int ring = 0;
  const int red = ring + DEPTH * 32 * warps * CPT * 4;
  const int w = red + warps * uc * SLICE * 4;
  return Layout{ring, red, w, w + warps * FW * uc * 4};
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   hl::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hl::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's place in its frame sequence: group k, whose frames t .. t + FW -
// 1 are the warp's, and their columns' offset in the item's rows (of the
// frames and of their sums), advanced a group at a time
template <int GROUP>
struct Cursor {
  int k, t;
  size_t off;
  __device__ __forceinline__ void next(int V) {
    ++k;
    t += GROUP;
    off += (size_t)GROUP * V;
  }
};

template <int NQ, bool VEC, int WARPS, bool BOTH>
__global__ void __launch_bounds__(32 * WARPS, 1)
    joint_lse_bwd(const float* __restrict__ f,      // (N, T, V)
                  const float* __restrict__ g,      // (N, U1, V)
                  const float* __restrict__ lse,    // (N, T, U1)
                  const float* __restrict__ dlse,   // (N, T, U1)
                  const float* __restrict__ mf,     // (N, T)
                  const float* __restrict__ mg,     // (N, U1)
                  float* __restrict__ df,           // (N, T, V)
                  float* __restrict__ dg,           // (N, U1, V)
                  int N, int T, int U1, int V, int tchunks) {
  constexpr int UC = 4 * NQ, THREADS = 32 * WARPS;
  constexpr int GROUP = WARPS * FW;      // frames a group
  constexpr Layout L = layout(NQ, WARPS);
  extern __shared__ __align__(16) char sm[];
  float* red = reinterpret_cast<float*>(sm + L.red);
  // one linear grid, (chunk z, item n, slice) from the slowest: no grid
  // dimension bounds N or the chunks, and the chunks are dealt in z order
  const int slices = (V + SLICE - 1) / SLICE;
  const int sx = blockIdx.x % slices, zn = blockIdx.x / slices;
  const int n = zn % N, z = zn / N;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The block's frames stream, its rows stay in registers. BOTH: the frames
  // are T's, the rows all of U1's (one chunk), df and dg written. Otherwise
  // a block writes its rows' sums alone: blocks z < tchunks hold chunk z of
  // T's rows and stream U1's as their frames (df), f and g, mf and mg, and
  // lse's strides swapped; they are the longer ones where U1 > T, so they
  // go first. The others hold chunk z - tchunks of U1's rows and stream
  // T's frames (dg). W's exponent (an exact two-sum) and the exact terms
  // take the same bits either way.
  const bool tr = !BOTH && z < tchunks;
  const int u0 = (BOTH || tr ? z : z - tchunks) * UC;
  const int Ta = tr ? U1 : T, Ub = tr ? T : U1;       // frames, rows
  const size_t sa = tr ? 1 : U1, sb = tr ? U1 : 1;   // lse's strides
  const float* an = (tr ? g : f) + (size_t)n * Ta * V;
  const float* bn = (tr ? f : g) + (size_t)n * Ub * V;
  const float* man = (tr ? mg : mf) + (size_t)n * Ta;
  const float* mbn = (tr ? mf : mg) + (size_t)n * Ub;
  const float* lsn = lse + (size_t)n * T * U1;
  const float* dln = dlse + (size_t)n * T * U1;
  float* dbn = (tr ? df : dg) + (size_t)n * Ub * V;  // the rows' sums
  float* dan = df + (size_t)n * T * V;               // the frames' (BOTH)
  const int v0 = sx * SLICE + CPT * lane;   // this lane's columns
  bool ok[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) ok[c] = v0 + c < V;
  const int groups = (Ta + GROUP - 1) / GROUP;       // this warp's sequence
  float* slots = reinterpret_cast<float*>(sm + L.ring) + threadIdx.x * CPT;
  float* myred = red + w * UC * SLICE + CPT * lane;  // [u * SLICE + c]
  float* myw = reinterpret_cast<float*>(sm + L.w) + w * FW * UC;
  // frame x of group k in ring slot (k FW + x) % DEPTH
  auto slot = [&](int k, int x) {
    return slots + ((k * FW + x) % DEPTH) * THREADS * CPT;
  };

  // a group's copies into the ring, committed as one (empty past the frames,
  // so that the wait below counts groups); group k + RING - 1 goes out as
  // group k is read, into the slots of group k - 1
  auto issue = [&](const Cursor<GROUP>& q) {
#pragma unroll
    for (int x = 0; x < FW; ++x) {
      if (q.t + x < Ta) {
        float* dst = slot(q.k, x);
        const float* src = an + q.off + (size_t)x * V;
        if (VEC) {
          if (ok[0]) cp_async8(dst, src);
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (ok[c]) cp_async4(dst + c, src + c);
        }
      }
    }
    commit();
  };

  // phase stamps (-DHL_PHASES only): thread 0's cycles of the set-up,
  // frames and dg merge
  const long long c0 = hl::stamp();
  // the first groups in flight during the set-up
  Cursor<GROUP> rd{0, w * FW, (size_t)w * FW * V + v0}, wr = rd;
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    issue(wr);
    wr.next(V);
  }
  // the rows' e^(b - mb) at this lane's columns: every load issued first,
  // from clamped addresses (a load behind a condition waits out its latency
  // row by row), then the exponentials, masked
  float eg[UC][CPT], dga[UC][CPT], mgr[UC];
#pragma unroll
  for (int u = 0; u < UC; ++u) {
    const int uu = min(u0 + u, Ub - 1);
    mgr[u] = mbn[uu];
    const float* gr = bn + (size_t)uu * V;
#pragma unroll
    for (int c = 0; c < CPT; ++c) eg[u][c] = gr[min(v0 + c, V - 1)];
  }
  // lane u's row of W: its maximum, and a group's lse, dlse and frame
  // maxima read a group ahead (clamped addresses, then selects)
  const bool ulive = lane < UC && u0 + lane < Ub;
  const int ul = min(u0 + lane, Ub - 1);
  const float mgu = mbn[ul];
  float pl[FW], pd[FW], pm[FW];
  auto fetch = [&](int k) {
#pragma unroll
    for (int j = 0; j < FW; ++j) {
      const int t = min(k * GROUP + w * FW + j, Ta - 1);
      const size_t at = t * sa + ul * sb;
      pl[j] = lsn[at];
      pd[j] = dln[at];
      pm[j] = man[t];
    }
  };
  fetch(0);
  // (x - mb <= 0 on every row read, so the mask multiplies a finite value)
#pragma unroll
  for (int u = 0; u < UC; ++u) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float on = ok[c] && u0 + u < Ub ? 1.f : 0.f;
      eg[u][c] = on * ex2((eg[u][c] - mgr[u]) * L2E);
      dga[u][c] = 0.f;
    }
    *reinterpret_cast<float2*>(myred + u * SLICE) = make_float2(0.f, 0.f);
  }
  const long long c1 = hl::stamp();

  // The groups in this warp's ring order, a group's FW frames in one
  // straight run of code (selects, no branch but the rare exact terms'), so
  // that one frame's latencies hide under the others' FMAs. First the warp
  // writes its W rows of the group; lane j keeps frame j's marks and
  // maximum, shuffled to the warp.
#pragma unroll 1
  for (; rd.k < groups; rd.next(V), wr.next(V)) {
    const int k = rd.k, t = rd.t;   // frames t .. t + FW - 1
    unsigned gmask = 0;
    float gmf = 0.f;
    __syncwarp();   // the last group's W read before this one's is written
#pragma unroll
    for (int jj = 0; jj < FW; ++jj) {
      // ma + mb - lse with the rounding of ma + mb put back (two-sum: where
      // ma + mb is ~100 and lse as close, the plain sum would leave W off
      // by its ulp, ops/joint.py _exponent)
      const float s = pm[jj] + mgu, bb = s - pm[jj];
      const float e = (s - pl[jj]) + ((pm[jj] - (s - bb)) + (mgu - bb));
      const bool live = ulive && t + jj < Ta && pd[jj] != 0.f;
      const bool big = e > MARK;
      const float wt = live && !big ? pd[jj] * expf(e) : 0.f;
      if (lane < UC) myw[jj * UC + lane] = wt;
      const unsigned m = __ballot_sync(0xffffffffu, live && big);
      gmask = lane == jj ? m : gmask;
      gmf = lane == jj ? pm[jj] : gmf;
    }
    if (k + 1 < groups) fetch(k + 1);
    __syncwarp();
    issue(wr);
    wait_groups<RING - 1>();               // group k landed
    if (t >= Ta) continue;                 // the same for the whole warp
    unsigned mask[FW];
    bool on[FW];
    float ef[FW][CPT], acc[FW][4][CPT];
#pragma unroll
    for (int x = 0; x < FW; ++x) {
      on[x] = t + x < Ta;
      mask[x] = __shfl_sync(0xffffffffu, gmask, x);
      const float mft = __shfl_sync(0xffffffffu, gmf, x);
      const float2 y = *reinterpret_cast<const float2*>(slot(k, x));
      const float fv[CPT] = {y.x, y.y};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        // (a slot past the frames holds none: its ef is 0, and its W rows)
        ef[x][c] = ok[c] && on[x] ? ex2((fv[c] - mft) * L2E) : 0.f;
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[x][h][c] = 0.f;
      }
    }
    // W . e^(b - mb) in 4 partial sums (rows u % 4) a frame, so that a
    // chain of dependent FMAs is NQ long (BOTH only); the rows' sums take
    // the frames' products in frame order
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float ys[FW][4];
#pragma unroll
      for (int x = 0; x < FW; ++x) {
        const float4 y = *reinterpret_cast<const float4*>(
            myw + x * UC + 4 * q);
        ys[x][0] = y.x;
        ys[x][1] = y.y;
        ys[x][2] = y.z;
        ys[x][3] = y.w;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (BOTH) {
#pragma unroll
            for (int x = 0; x < FW; ++x)
              acc[x][h][c] = fmaf(ys[x][h], eg[4 * q + h][c], acc[x][h][c]);
          }
#pragma unroll
          for (int x = 0; x < FW; ++x)
            dga[4 * q + h][c] = fmaf(ys[x][h], ef[x][c], dga[4 * q + h][c]);
        }
    }
    float d[FW][CPT];
#pragma unroll
    for (int x = 0; x < FW; ++x)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        d[x][c] = ef[x][c] * ((acc[x][0][c] + acc[x][1][c]) +
                              (acc[x][2][c] + acc[x][3][c]));
    // the marked cells of the group, frame by frame in the rows' order:
    // their exact terms, each one's loads issued before its arithmetic
    unsigned marked = 0;
#pragma unroll
    for (int x = 0; x < FW; ++x) marked |= mask[x];
    if (marked) {
#pragma unroll
      for (int x = 0; x < FW; ++x) {
        const float2 y = *reinterpret_cast<const float2*>(slot(k, x));
        const float fv[CPT] = {y.x, y.y};
        for (unsigned m = mask[x]; m; m &= m - 1) {
          const int u = __ffs(m) - 1;
          const size_t at = (t + x) * sa + (u0 + u) * sb;
          const float ls = lsn[at], dl = dln[at];
          const float* gr = bn + (size_t)(u0 + u) * V;
          float gv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) gv[c] = gr[min(v0 + c, V - 1)];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float p = ok[c] ? dl * expf(fv[c] + gv[c] - ls) : 0.f;
            d[x][c] += p;
            myred[u * SLICE + c] += p;
          }
        }
      }
    }
    if (BOTH) {
#pragma unroll
      for (int x = 0; x < FW; ++x) {
        if (!on[x]) break;
        float* drow = dan + rd.off + (size_t)x * V;   // this lane's columns
        if (VEC) {
          if (ok[0])
            *reinterpret_cast<float2*>(drow) = make_float2(d[x][0], d[x][1]);
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (ok[c]) drow[c] = d[x][c];
        }
      }
    }
  }
  wait_groups<0>();
  const long long c2 = hl::stamp();

  // the rows' sums: each warp's e^(b - mb) * sums + exact terms, then the
  // warps' rows summed in warp order
#pragma unroll
  for (int u = 0; u < UC; ++u) {
    float2* r = reinterpret_cast<float2*>(myred + u * SLICE);
    const float2 e = *r;
    *r = make_float2(fmaf(eg[u][0], dga[u][0], e.x),
                     fmaf(eg[u][1], dga[u][1], e.y));
  }
  __syncthreads();
  for (int x = threadIdx.x; x < UC * SLICE; x += THREADS) {
    float s = red[x];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) s += red[ww * UC * SLICE + x];
    const int u = u0 + x / SLICE, v = sx * SLICE + x % SLICE;
    if (u < Ub && v < V) dbn[(size_t)u * V + v] = s;
  }
  const int item = blockIdx.x;
  hl::keep_phase(threadIdx.x == 0, 0, item, c1 - c0);
  hl::keep_phase(threadIdx.x == 0, 1, item, c2 - c1);
  hl::keep_phase(threadIdx.x == 0, 2, item, hl::stamp() - c2);
}

// a launch's pointers and sizes
struct Args {
  const float *f, *g, *lse, *dlse, *mf, *mg;
  float *df, *dg;
  int N, T, U1, V, chunks, tchunks;
};

template <int NQ, bool VEC, int WARPS, bool BOTH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int bytes = layout(NQ, WARPS).bytes;
  const auto kernel = joint_lse_bwd<NQ, VEC, WARPS, BOTH>;
  cudaError_t err =
      hl::allow_smem(done, reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return err;
  const int slices = (a.V + SLICE - 1) / SLICE;
  const int grid = slices * a.N * (BOTH ? 1 : a.chunks + a.tchunks);
  kernel<<<grid, 32 * WARPS, bytes, stream>>>(a.f, a.g, a.lse, a.dlse, a.mf,
                                              a.mg, a.df, a.dg, a.N, a.T,
                                              a.U1, a.V, a.tchunks);
  return cudaGetLastError();
}

template <bool VEC, int WARPS>
cudaError_t launch_nq(int nq, const Args& a, cudaStream_t s) {
  if (a.chunks > 1) return launch<8, VEC, WARPS, false>(a, s);
  switch (nq) {
    case 1: return launch<1, VEC, WARPS, true>(a, s);
    case 2: return launch<2, VEC, WARPS, true>(a, s);
    case 3: return launch<3, VEC, WARPS, true>(a, s);
    case 4: return launch<4, VEC, WARPS, true>(a, s);
    case 5: return launch<5, VEC, WARPS, true>(a, s);
    case 6: return launch<6, VEC, WARPS, true>(a, s);
    case 7: return launch<7, VEC, WARPS, true>(a, s);
    default: return launch<8, VEC, WARPS, true>(a, s);
  }
}

}  // namespace

// f (N, T, V), g (N, U1, V), lse and dlse (N, T, U1), mf (N, T), mg (N, U1)
// fp32 contiguous; df (N, T, V) and dg (N, U1, V) fp32 receive the
// gradients, every element written. The plan (ops/joint_cuda.py bwd_plan):
// nq, the float4 groups of a chunk of U1's rows (a chunk is 4 nq rows, 1 <=
// nq <= 8), chunks of them; where that is more than one (nq 8), tchunks,
// the chunks of 32 of T's rows, else 0; warps a block (4 or 8), smem the
// block's shared-memory bytes, vec whether f's, g's and df's rows are
// 8-byte aligned (V even and aligned pointers). Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan that does not fit the
// shapes).
extern "C" int hl_joint_lse_bwd(const void* f, const void* g, const void* lse,
                                const void* dlse, const void* mf,
                                const void* mg, void* df, void* dg, int N,
                                int T, int U1, int V, int nq, int chunks,
                                int tchunks, int warps, int smem, int vec,
                                void* stream) {
  const bool split = chunks > 1;
  const long long blocks = (long long)((V + SLICE - 1) / SLICE) * N *
                           (split ? chunks + tchunks : 1);
  if (N <= 0 || T <= 0 || U1 <= 0 || V <= 0 || nq < 1 ||
      nq > 8 || chunks != (U1 + 4 * nq - 1) / (4 * nq) ||
      (split && nq != 8) || tchunks != (split ? (T + 31) / 32 : 0) ||
      blocks > 0x7fffffff || (warps != 4 && warps != 8) ||
      smem != layout(nq, warps).bytes || (vec && V % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(f),  static_cast<const float*>(g),
               static_cast<const float*>(lse), static_cast<const float*>(dlse),
               static_cast<const float*>(mf), static_cast<const float*>(mg),
               static_cast<float*>(df),       static_cast<float*>(dg),
               N, T, U1, V, chunks, tchunks};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (warps == 4)
    err = vec ? launch_nq<true, 4>(nq, a, s) : launch_nq<false, 4>(nq, a, s);
  else
    err = vec ? launch_nq<true, 8>(nq, a, s) : launch_nq<false, 8>(nq, a, s);
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the last launch's stamps: per block ((z * N + n) * slices + slice, the
// first PHASE_ITEMS; past one chunk of U1 the
// blocks of T's rows first) thread 0's cycles of set-up (0), frames (1) and
// the rows' merge (2)
extern "C" int hl_joint_bwd_phases(void* out) { return hl::copy_phases(out); }
#endif
