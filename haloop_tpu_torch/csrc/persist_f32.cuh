// The fp32 pieces of the persistent LSTM kernels (lstm_fwd.cu K1 and
// lstm_bwd.cu K2 in fp32, `persist_f32` there), built on persist.cuh's
// grid barrier, cooperative cluster launch and distributed shared memory.
//
// Why not persist.cuh's product: in fp32 the recurrent weight no longer
// fits the SMs (W_hh is 64 MiB at H = 2048, against ~30 MB of shared
// memory on 132 SMs), and the products must stay exact fp32 FFMA on the
// CUDA cores (the JAX kernel's fp32 path is full precision; no TF32). So
// each block keeps as many of its W columns resident as fit and streams
// the rest every step through the same ring as the exchanged rows, and the
// product is a register tile of FFMAs with float4 operands from shared
// memory.
//
// Each step a block waits at the grid barrier, multiplies its slices,
// stores its partials into the ring's region, sums its own u units' over
// the cluster in rank order (one cell a lane: i = tid + THREADS e of its
// BM u cells), updates them, and arrives; the next product's first W
// slots are issued once the cluster is done with the partials.
//
// The plan (Plan, filled by haloop_tpu_torch/nn/lstm_cuda.py f32_plan and
// passed as a host int array) fixes, for one (kind, H, B):
//   c, u, clusters, kc, n  as persist.cuh's Plan: blocks a cluster (4 for
//             K1, 8 for K2), units a block owns for the cell update, the
//             grid's clusters, the contraction a block takes (a multiple
//             of KS), the rows of W a block multiplies (K1: the four gate
//             rows of the cluster's c u units, gate-major; K2: the rows of
//             W^T of its c u units)
//   tm, tn, wk  the threads' tile: 8 warps as 2 (batch) x 32 / wk / 8
//             (rows of W) x wk (k groups, each summing a contiguous eighth,
//             quarter or half of every slice into its own partial slab);
//             a thread owns tm batch rows (mi + 8 i) and tn rows of W
//             (ni + 32 / wk j): a batch tile of BM = 8 tm rows (the whole
//             of hal's 64 in one), ncap = 32 / wk tn >= n rows of W
//   stages    ring slots: each holds one KS-wide slice of the exchanged
//             rows (h or dgates, BM rows) and, for the streamed slices, of
//             W (ncap rows); the fewest (at least 2) that keep 32 KB in
//             flight beside the slot being multiplied (a deeper ring
//             leaves fewer slices resident, and read slower on an H100)
//   nres      the last nres slices of the block's kc columns of W, kept
//             resident in shared memory for the whole launch; the first
//             nsl - nres are streamed every product. Slices are multiplied
//             in k order either way, so the split changes no sum
//   smem      dynamic shared memory (Layout)
//
// Shared memory, from its first 1024-byte boundary: the resident slices
// (ncap rows of KS floats each); one region that holds the ring during a
// product and the partials (wk slabs of BM x n fp32, owner-major as
// persist.cuh's) after it; one mbarrier a slot and one for the resident
// slices. Rows of KS floats are 128 bytes, and TMA's 128-byte swizzle
// puts 16-byte chunk c of row r at chunk c ^ (r % 8): a warp's eight rows
// at one chunk fall on distinct banks, and a thread's rows (mi + 8 i;
// ni + 32 / wk j) share r % 8, so one xor serves all its loads.
//
// Memory order: a step's outputs are generic stores by every SM, read by
// other SMs' TMA (the async proxy) after the grid barrier: the issuing
// thread's acquire, then a proxy fence (fence.proxy.async), then the
// boxes. The ring also holds the partials, written by generic stores,
// before TMA refills it: thread 0 fences again after the cluster barrier
// that frees them.

#pragma once

#include "persist.cuh"

namespace hl {
namespace pf32 {

using persist::THREADS;
constexpr int KS = 32;              // contraction a slice (fp32 elements)
constexpr int ROW = KS * 4;         // bytes a slice row
constexpr int CH = ROW / 16;        // 16-byte chunks a row
constexpr int CMAX = 8;             // cells a thread: BM u <= CMAX THREADS

struct Plan {
  int c, u, clusters, kc, n, tm, tn, wk, stages, nres, smem;
};

// the (tm, tn, wk) tiles compiled (nn/lstm_cuda.py F32_TMS, F32_TNS,
// F32_WKS): X(tm, tn, wk) for each
#define HL_F32_TILES(X)                                                    \
  X(1, 5, 1) X(1, 7, 1) X(1, 9, 1) X(1, 5, 2) X(1, 7, 2) X(1, 9, 2)         \
  X(1, 5, 4) X(1, 7, 4) X(1, 9, 4) X(8, 5, 1) X(8, 7, 1) X(8, 9, 1)         \
  X(8, 5, 2) X(8, 7, 2) X(8, 9, 2) X(8, 5, 4) X(8, 7, 4) X(8, 9, 4)
constexpr int PLAN_INTS = 11;

inline Plan read_plan(const int* p) {
  return Plan{p[0], p[1], p[2], p[3], p[4], p[5],
              p[6], p[7], p[8], p[9], p[10]};
}

// the dynamic shared memory of a plan: offsets in bytes from its first
// 1024-byte boundary (TMA's 128-byte swizzle wants boxes so aligned; size
// counts the 1024 bytes of slack), as nn/lstm_cuda.py f32_layout
struct Layout {
  int bm, ncap, nsl, nstr, hpart, wrows, slot, region, bars, size;
  __host__ __device__ explicit Layout(const Plan& p) {
    bm = 8 * p.tm;
    ncap = 32 / p.wk * p.tn;
    nsl = p.kc / KS;
    nstr = nsl - p.nres;
    hpart = bm * ROW;
    wrows = ncap * ROW;
    slot = hpart + (nstr ? wrows : 0);
    const int ring = p.stages * slot, part = p.wk * bm * p.n * 4;
    region = p.nres * wrows;
    bars = region + ((ring > part ? ring : part) + 15) / 16 * 16;
    size = 1024 + bars + 8 * (p.stages + 1);
  }
};

// ---------------------------------------------------------- device side

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// the thread's place in the product's tile
template <int WK>
struct Geo {
  static constexpr int NTH = 32 / WK;     // threads along the rows of W
  int mi, ni, wkg;
  __device__ __forceinline__ Geo() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    mi = (warp % 2) * 4 + lane / 8;
    ni = ((warp / 2) % (NTH / 8)) * 8 + lane % 8;
    wkg = warp / (NTH / 4);
  }
};

// acc[i][j] += x row (mi + 8 i) . W row (ni + NTH j) over this thread's k
// group of one slice (x's rows at shared address hs, W's at ws): its
// CH / WK chunks of 4 columns in order, each column's product added by
// one FFMA, in column order (the FFMAs of one column for every cell
// before the next column's, so that no FFMA waits for the one before)
template <int TM, int TN, int WK>
__device__ __forceinline__ void mult_slice(uint32_t hs, uint32_t ws,
                                           const Geo<WK>& g,
                                           float (&acc)[TM][TN]) {
  constexpr int NTH = 32 / WK, CG = CH / WK;
  const uint32_t hb = hs + g.mi * ROW, wb = ws + g.ni * ROW;
  const int xh = g.mi & 7, xw = g.ni & 7;
#ifdef HL_ABLATE_OPERAND_LOADS
  // (kernels.ABLATIONS) the operands loaded once a slice: the FFMAs alone
  float4 a0[TM], b0[TN];
#endif
#pragma unroll
  for (int q = 0; q < CG; ++q) {
    const int ch = g.wkg * CG + q;
    const uint32_t ha = hb + ((ch ^ xh) << 4), wa = wb + ((ch ^ xw) << 4);
    float4 a[TM], b[TN];
#ifdef HL_ABLATE_OPERAND_LOADS
    if (q == 0) {
      for (int i = 0; i < TM; ++i) a0[i] = lds4(ha + i * 8 * ROW);
      for (int j = 0; j < TN; ++j) b0[j] = lds4(wa + j * NTH * ROW);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = a0[i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = b0[j];
#else
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = lds4(ha + i * 8 * ROW);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = lds4(wa + j * NTH * ROW);
#endif
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
  }
}

// The ring and the resident slices of one launch, fed by TMA from thread
// 0 alone (the other threads issue no load). A product takes nsl slices
// of KS columns in k order: the first nstr with W from the ring, the rest
// with W resident; every slice's rows of the exchanged matrix (x: h or
// dgates) come through the ring. Slices are numbered across products
// (base), slot seq % stages; each slot's mbarrier (count 1) is armed by
// thread 0's expect_tx of the slot's bytes and completed by its TMA
// boxes: W's n rows (K1: a 3-D box of the cluster's units' four gates,
// WR = 3; K2: a 2-D box of its units' rows of W^T, WR = 2) and x's bm.
template <int WR>
struct Ring {
  uint32_t ring, res, bars;       // slots, resident slices, mbarriers
  const CUtensorMap* wmap;
  int slot, hpart, wrows, wbytes, stages, nsl, nstr, k0, j0;
  unsigned base;                  // slices of earlier products

  __device__ __forceinline__ uint32_t at(int s) const {
    return ring + ((base + s) % stages) * slot;
  }
  __device__ __forceinline__ uint32_t bar(int s) const {
    return bars + 8 * ((base + s) % stages);
  }
  __device__ __forceinline__ void load_w(uint32_t dst, uint32_t b,
                                         int s) const {
    if constexpr (WR == 3)
      tma_load_3d(dst, wmap, b, k0 + s * KS, j0, 0);
    else
      tma_load_2d(dst, wmap, b, k0 + s * KS, j0);
  }
  // thread 0: slice s's slot expects its bytes, and W's rows are issued
  // if the slice is streamed (with HL_ABLATE_W_STREAM, kernels.ABLATIONS,
  // never: the product multiplies whatever the slot holds)
  __device__ __forceinline__ void arm(int s) const {
#ifndef HL_ABLATE_W_STREAM
    if (s < nstr) {
      mbar_expect_tx(bar(s), hpart + wbytes);
      load_w(at(s) + hpart, bar(s), s);
    } else
#endif
    {
      mbar_expect_tx(bar(s), hpart);
    }
  }
  // thread 0: slice s's rows of x: the box at (k0 + s KS, b0) of a 2-D
  // map, or (k0 + s KS, b0, c2) of a 3-D one (c2 >= 0)
  __device__ __forceinline__ void load_x(int s, const CUtensorMap* xm,
                                         int b0, int c2) const {
    if (c2 < 0)
      tma_load_2d(at(s), xm, bar(s), k0 + s * KS, b0);
    else
      tma_load_3d(at(s), xm, bar(s), k0 + s * KS, b0, c2);
  }
  // The mbarriers, and the resident slices' loads once at the start (all
  // threads call it). The first product waits for them only when it
  // reaches them (the last slices): the streamed slices' loads overlap
  // theirs, which is most of a one-step call's time.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int i = 0; i <= stages; ++i) mbar_init(bars + 8 * i, 1);
      fence_barrier_init();
      prefetch_map(wmap);
      if (nsl > nstr) {
        const uint32_t rb = bars + 8 * stages;
        mbar_expect_tx(rb, (nsl - nstr) * wbytes);
        for (int s = nstr; s < nsl; ++s)
          load_w(res + (s - nstr) * wrows, rb, s);
      }
    }
    __syncthreads();
  }
  // the W rows of the first slots of the next product, issued while the
  // block does other work (all threads call it, the ring free: the
  // partials it held were read)
  __device__ __forceinline__ void prefetch() const {
    if (threadIdx.x != 0) return;
    fence_proxy_async();          // after the partials' generic stores
    for (int s = 0; s < min(stages, nstr); ++s) arm(s);
  }
};

// acc = x rows (b0 .. b0 + bm) . W rows^T over this block's kc columns,
// x from map xm (see Ring::load_x), through the ring; the first
// min(stages, nstr) slots were armed before (Ring::prefetch). `waited`
// adds thread 0's cycles in the ring's waits, `first` those of the first
// slice (phase stamps only). All threads call it; it returns with the
// ring free.
template <int TM, int TN, int WK, int WR>
__device__ __forceinline__ void product(Ring<WR>& rg, const CUtensorMap* xm,
                                        int b0, int c2, const Geo<WK>& g,
                                        float (&acc)[TM][TN],
                                        long long& waited, long long& first) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (threadIdx.x == 0) {
    // x was written by other SMs' generic stores before the grid barrier
    fence_proxy_async();
    for (int s = 0; s < min(rg.stages, rg.nsl); ++s) {
      if (s >= rg.nstr) rg.arm(s);
      rg.load_x(s, xm, b0, c2);
    }
  }
  for (int s = 0; s < rg.nsl; ++s) {
    const unsigned q = rg.base + s;
    const uint32_t hs = rg.ring + (q % rg.stages) * rg.slot;
    const long long t0 = stamp();
    mbar_wait(rg.bars + 8 * (q % rg.stages), (q / rg.stages) & 1);
    waited += stamp() - t0;
    if (s == 0) first = waited;
    // the resident slices' mbarrier completes once, at the first product
    if (s == rg.nstr) mbar_wait(rg.bars + 8 * rg.stages, 0);
    const uint32_t ws = s < rg.nstr
        ? hs + rg.hpart : rg.res + (s - rg.nstr) * rg.wrows;
    mult_slice<TM, TN, WK>(hs, ws, g, acc);
    if (s + rg.stages < rg.nsl) {
      __syncthreads();              // every warp is done with this slot
      if (threadIdx.x == 0) {
        rg.arm(s + rg.stages);
        rg.load_x(s + rg.stages, xm, b0, c2);
      }
    }
  }
  __syncthreads();                  // every warp is done with the ring
  rg.base += rg.nsl;
}

// The accumulators into the thread's k group's partial slab, owner-major
// (persist.cuh): slab row nr is gate nr / cu, unit nr % cu of the
// cluster, which block (nr % cu) / u updates; G gates (K1 4, K2 1)
template <int TM, int TN, int WK>
__device__ __forceinline__ void store_partials(float* p_s, int n, int u,
                                               int cu, int G, int bm,
                                               const Geo<WK>& g,
                                               const float (&acc)[TM][TN]) {
  constexpr int NTH = 32 / WK;
  float* ps = p_s + (size_t)g.wkg * bm * n;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int nr = g.ni + NTH * j;
    if (nr >= n) continue;
    const int gate = nr / cu, unit = nr % cu, ro = unit / u, jl = unit % u;
    float* q = ps + ((ro * G + gate) * bm) * u + jl;
#pragma unroll
    for (int i = 0; i < TM; ++i) q[(g.mi + 8 * i) * u] = acc[i][j];
  }
}

// the wk slabs summed into slab 0 in a fixed order (0, 1, ...)
__device__ __forceinline__ void fold(float* p_s, int total, int wk) {
  if (wk == 1) return;
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += THREADS) {
    float s = p_s[i];
    for (int w = 1; w < wk; ++w) s += p_s[(size_t)w * total + i];
    p_s[i] = s;
  }
}

}  // namespace pf32
}  // namespace hl
