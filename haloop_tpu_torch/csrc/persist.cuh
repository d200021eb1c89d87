// Building blocks of the persistent LSTM kernels (lstm_fwd.cu K1,
// lstm_bwd.cu K2, and their int8 modes K1-q8 and K2-q8 in lstm_q8.cu):
// one block per SM for the whole sequence, the block's slice of the
// recurrent weight resident in shared memory, blocks grouped in clusters
// that split the contraction of each step's product between them and sum
// their partials through distributed shared memory, and one grid-wide
// barrier a step (K2-q8: two, see lstm_q8.cu).
//
// The operands are bf16 with fp32 sums (mma.sync m16n8k16) or int8 with
// exact int32 sums (m16n8k32): Op<E> below. Both are laid out in bytes
// the same way: a k-step is 32 bytes of a row (16 bf16, 32 int8), a ring
// slot KS = 64 elements of a row, so kc and the plans' arithmetic count
// elements alike in both.
//
// The plan (Plan, filled by haloop_tpu_torch/nn/lstm_cuda.py persist_plan
// and passed as a host int array) fixes, for one (kind, H):
//   c         blocks a cluster (the kernel's CL: 4 for K1, 8 for K2; the
//             int8 kinds' own, nn/lstm_cuda.py CLUSTERS)
//   u         hidden units a block owns for the elementwise update; a
//             cluster owns c u consecutive units
//   clusters  clusters of the grid (ceil(H / (c u))); the grid is c
//             clusters blocks, launched cooperatively, so all of them are
//             resident at once or the launch fails
//   kc        the contraction a block takes, a multiple of KS: block r of
//             a cluster multiplies columns [r kc, (r + 1) kc) of the
//             exchanged rows (h or hq for K1, dgates or their int8
//             quantization for K2), zero past the end
//   n         rows of the resident slab (the product's N): 4 c u gate rows
//             for K1, c u units for K2 (whole 8-row n-tiles)
//   npw, nw, wk  the warps' split: nw groups of npw 8-row n-tiles, times
//             wk groups that take every wk-th 32-byte k-step (each writes
//             its own partial slab; fold_slabs sums them); warps past
//             nw wk sit out the product
//   stages    slots of the ring (KS-wide slices of the exchanged rows in
//             flight), as many as the shared memory left beside the slab
//             holds, at most the kc / KS slices of a step
//   smem      dynamic shared memory (Layout): the slab, n rows of kc
//             elements (kc es + 16 bytes apart); one region that holds the
//             ring (stages x BM rows of KS es + 16 bytes) during a product
//             and the partials (wk x n x BM fp32 or int32) after it; one
//             mbarrier a slot
//
// The partials are owner-major: slab w, block ro of the cluster that
// updates the units, gate g (K1's four; K2 has one), batch row b, unit
// jl: p_s[(((w c + ro) G + g) BM + b) u + jl], so that each block finds
// what it needs from a peer in one contiguous run of G BM u values and
// reads it 16 bytes at a time, four consecutive cells a thread.
//
// Memory order: a step's outputs are written with generic stores by every
// SM and read by every SM after the grid barrier (its release and acquire
// at gpu scope). The readers load them with cp.async.cg (or ld.global.cg),
// which reads L2 and never L1, so no SM can see a stale line of a buffer
// another SM wrote (a stale L1 line would give an answer that is wrong
// only sometimes); cp.async is a generic-proxy access, so the barrier's
// acquire orders it without a proxy fence.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "mma.cuh"
#include "sm90.cuh"

namespace hl {
namespace persist {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BM = 48;              // batch rows a tile: 3 m-tiles
constexpr int MT = BM / 16;
constexpr int KS = 64;              // contraction a ring slot (elements)
constexpr int LDX = KS + 8;         // ring row stride (bf16): 144 bytes
constexpr int UMAX = 16;            // units a block at most
constexpr int GC = 4;               // cells a thread a tile (consecutive)
static_assert(BM % 16 == 0 && BM * UMAX <= GC * THREADS, "tiling");

// the product's operand type E: its size, the accumulator and the
// mma.sync that adds a 32-byte k-step into it
template <typename E> struct Op;
template <> struct Op<bf16> {
  using Acc = float;
  static constexpr int ES = 2;
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};
template <> struct Op<int8_t> {
  using Acc = int;
  static constexpr int ES = 1;
  static __device__ __forceinline__ void mma(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_s8(c, a, b0, b1);
  }
};

struct Plan {
  int c, u, clusters, kc, n, npw, nw, wk, stages, smem;
};
constexpr int PLAN_INTS = 10;

inline Plan read_plan(const int* p) {
  return Plan{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
}

// The dynamic shared memory of a plan whose operands are es bytes each:
// the slab; the region that holds the ring during a product and the
// partials after it; the ring's mbarriers
struct Layout {
  int slab, region, bars;
  __host__ __device__ explicit Layout(const Plan& p, int es = 2) {
    slab = p.n * (p.kc * es + 16);
    const int ring = p.stages * BM * (KS * es + 16);
    const int part = p.wk * BM * p.n * 4;
    region = ((ring > part ? ring : part) + 15) / 16 * 16;
    bars = slab + region;
  }
};

// ---------------------------------------------------------- device side

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// The grid barrier, a monotone counter (zero at launch) that each block
// raises once a step. arrive: after every thread of the block has
// written its outputs of the step (the block barrier orders them before
// thread 0's release at gpu scope). wait: until all blocks arrived
// `target` times in all (thread 0's acquire, then the block barrier).
// The spin ends the launch with a trap after ~2^35 cycles (tens of
// seconds), so a protocol fault fails the call instead of hanging the
// card.
__device__ __forceinline__ void grid_arrive(unsigned* ctr) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(ctr) : "memory");
}
__device__ __forceinline__ void grid_wait(const unsigned* ctr,
                                          unsigned target) {
  if (threadIdx.x == 0) {
    uint32_t tries = 0;
    long long since = 0;
    while (true) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(ctr) : "memory");
      if (static_cast<int>(v - target) >= 0) break;
      if (++tries == 1u << 12) {
        tries = 0;
        const long long now = clock64();
        if (!since)
          since = now;
        else if (now - since > (1ll << 35))
          __trap();
      }
    }
  }
  __syncthreads();
}

// The block's resident slab: n rows of kc elements (row stride kc es + 16
// bytes, so that ldmatrix's 8 rows fall on distinct banks). row(i) gives
// the global source of slab row i at column 0 of this block's range, or
// null for a zero row; cols is the number of valid columns from there (a
// whole number of 16-byte chunks); `any` is a global address that
// zero-filled copies name. Waits for the copies.
template <typename E, typename Row>
__device__ __forceinline__ void load_slab(E* w_s, int n, int kc, int cols,
                                          const E* any, Row row) {
  constexpr int EC = 16 / sizeof(E);          // elements a 16-byte chunk
  const int ch = kc / EC, ldw = kc + 16 / sizeof(E);
  for (int i = threadIdx.x; i < n * ch; i += THREADS) {
    const int r = i / ch, k = (i % ch) * EC;
    const E* src = row(r);
    const bool ok = src && k < cols;
    cp_async16_zfill(w_s + r * ldw + k, ok ? src + k : any, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// the mbarrier at `bar` receives this thread's arrival once all of its
// cp.async issued so far have landed (its count holds the arrival)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// The warps that load the ring: those past the nw wk that multiply, if
// there are two or more (they load while the others multiply the slices
// that have landed; one warp alone issued the loads more slowly than all
// eight did), else all of them. Returns the first loading warp.
__device__ __forceinline__ int first_loader(int nw, int wk) {
  return nw * wk + 2 <= WARPS ? nw * wk : 0;
}

// The ring's mbarriers (one a slot, at shared address `bars`, 8 bytes
// apart), each completed by the arrivals of the loading threads (warps
// lw0 ..) once a slice's loads have landed
__device__ __forceinline__ void init_ring(uint32_t bars, int stages,
                                          int lw0) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i)
      mbar_init(bars + 8 * i, THREADS - 32 * lw0);
    fence_barrier_init();
  }
  __syncthreads();
}

// acc[j][mt] += X[b0 + rows, k0 + (0..kc)] . slab^T over this warp's
// n-tiles (group ng: tiles ng npw .. + npw) and k-steps (those with index
// % wk == wkg; a warp with wkg >= wk takes none). X is row-major with row
// stride ld and `cols` valid columns from k0 (a whole number of 16-byte
// chunks). Its KS-wide slices stream through the ring x_s of `stages`
// slots (rows of KS es + 16 bytes) by cp.async.cg (16 bytes a thread;
// TMA bulk copies of a row each, issued by one warp, read slower), issued
// by the loading warps (lw0 .., see first_loader), all slots in flight at
// once, each refilled as soon as every warp is done with it; par holds
// the parity each slot's mbarrier waits for next. Columns past `cols`
// load as zeros; rows past `rows` are not loaded (their products land in
// rows that no one reads). All threads of the block call it; it returns
// with the ring free.
template <int NPW, typename E>
__device__ __forceinline__ void product(
    const E* __restrict__ x, int ld, int k0, int cols, int b0, int rows,
    int kc, const E* w_s, void* x_s, uint32_t bars, int stages,
    uint32_t& par, int ng, int wkg, int wk, int lw0,
    typename Op<E>::Acc (&acc)[NPW][MT][4]) {
  constexpr int EC = 16 / sizeof(E), CH = KS / EC;   // 16-byte chunks
  constexpr int SB = KS * sizeof(E), LDB = SB + 16;  // a slot row's bytes
  constexpr int STEPS = SB / 32;                     // k-steps a slot
  const int lane = threadIdx.x % 32;
  const int nsl = kc / KS, ldw = kc * sizeof(E) + 16;
  unsigned char* ring = static_cast<unsigned char*>(x_s);
  const unsigned char* slab = reinterpret_cast<const unsigned char*>(w_s);
  auto issue = [&](int s, int first, int stride) {
    const int slot = s % stages;
    unsigned char* dst = ring + slot * BM * LDB;
    for (int i = first; i < rows * CH; i += stride) {
      const int r = i / CH, k = s * KS + (i % CH) * EC;
      const bool ok = k < cols;
      cp_async16_zfill(dst + r * LDB + (i % CH) * 16,
                       ok ? x + (size_t)(b0 + r) * ld + k0 + k : x, ok);
    }
    cp_async_arrive(bars + 8 * slot);
  };
  auto load = [&](int s) {
    if (lw0 == 0)
      issue(s, threadIdx.x, THREADS);
    else if (threadIdx.x >= 32 * lw0)
      issue(s, threadIdx.x - 32 * lw0, THREADS - 32 * lw0);
  };
  const int ahead = min(stages, nsl);
  // HL_ABLATE_LOADS / HL_ABLATE_MMA (kernels.ABLATIONS): the ring's
  // loads or the mma.sync left out, for the phase stamps' ablations
#ifndef HL_ABLATE_LOADS
  for (int s = 0; s < ahead; ++s) load(s);
#endif
  for (int s = 0; s < nsl; ++s) {
    const int slot = s % stages;
#ifndef HL_ABLATE_LOADS
    mbar_wait(bars + 8 * slot, (par >> slot) & 1);
#endif
    par ^= 1u << slot;
    const unsigned char* xt = ring + slot * BM * LDB;
    // this warp's n-tiles of the slab at this slice's columns
    const unsigned char* wk_s = slab + (size_t)ng * NPW * 8 * ldw + s * SB;
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
#ifdef HL_ABLATE_MMA
      continue;
#endif
      if (wkg >= wk || (wk > 1 && (s * STEPS + kk) % wk != wkg))
        continue;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (mt * 16 < rows)
          ldsm_x4(a[mt], xt + (mt * 16 + lane % 16) * LDB + kk * 32 +
                             (lane / 16) * 16);
#pragma unroll
      for (int j = 0; j + 1 < NPW; j += 2) {   // two n-tiles a ldmatrix
        uint32_t b[4];
        ldsm_x4(b, wk_s + (size_t)(j * 8 + lane % 8 + (lane / 16) * 8) * ldw +
                       kk * 32 + ((lane / 8) % 2) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt * 16 < rows) {
            Op<E>::mma(acc[j][mt], a[mt], b[0], b[1]);
            Op<E>::mma(acc[j + 1][mt], a[mt], b[2], b[3]);
          }
      }
      if (NPW % 2) {
        uint32_t b[2];
        ldsm_x2(b, wk_s + (size_t)((NPW - 1) * 8 + lane % 8) * ldw + kk * 32 +
                       ((lane / 8) % 2) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt * 16 < rows) Op<E>::mma(acc[NPW - 1][mt], a[mt], b[0], b[1]);
      }
    }
    if (s + stages < nsl) {
      __syncthreads();            // every warp is done with this slot
#ifndef HL_ABLATE_LOADS
      load(s + stages);
#endif
    }
  }
  __syncthreads();                // every warp is done with the ring
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(int* p, int x, int y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}

// The accumulators into this warp's partial slab wkg, owner-major:
// column n of the product is gate n / cu, unit n % cu of the cluster,
// which block (n % cu) / u updates
template <int NPW, typename A>
__device__ __forceinline__ void store_partial(A* p_s, int n, int u, int cu,
                                              int ng, int wkg,
                                              const A (&acc)[NPW][MT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  A* p = p_s + (size_t)wkg * n * BM;
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int col = (ng * NPW + j) * 8 + 2 * t, gate = col / cu;
    const int ro = col % cu / u, jl = col % u;   // u even: jl + 1 < u
    A* q = p + ((ro * (n / cu) + gate) * BM) * u + jl;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 16 + g;
      st2(q + row * u, acc[j][mt][0], acc[j][mt][1]);
      st2(q + (row + 8) * u, acc[j][mt][2], acc[j][mt][3]);
    }
  }
}

// After every warp stored its slab: the wk slabs summed into slab 0, in a
// fixed order (slab 0, 1, ...), so that a peer reads one value a rank.
// The cluster barrier that follows also orders these writes before the
// block's own reads.
template <typename A>
__device__ __forceinline__ void fold_slabs(A* p_s, int n, int wk) {
  if (wk == 1) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n * BM; i += THREADS) {
    A s = p_s[i];
    for (int w = 1; w < wk; ++w) s += p_s[(size_t)w * n * BM + i];
    p_s[i] = s;
  }
}

__device__ __forceinline__ void ld_cluster4(float4& v, uint32_t addr) {
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ld_cluster4(int4& v, uint32_t addr) {
  asm volatile("ld.shared::cluster.v4.s32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
}

// The shared address of this block's partials (p_base) in each block of
// a cluster of CL
template <int CL>
__device__ __forceinline__ void peers(uint32_t (&peer)[CL], uint32_t p_base) {
#pragma unroll
  for (int r = 0; r < CL; ++r) peer[r] = map_rank(p_base, r);
}

// v[r] = the 4 values (float4 or int4) at `off` of slab 0 of block r of
// the cluster: issued back to back, so that their latencies overlap
template <int CL, typename V>
__device__ __forceinline__ void gather(V (&v)[CL], const uint32_t (&peer)[CL],
                                       int off) {
#pragma unroll
  for (int r = 0; r < CL; ++r) ld_cluster4(v[r], peer[r] + 4u * off);
}

// element e of the cluster's product: the ranks' partials summed in a
// fixed order (rank 0, 1, ...); exact in int32
template <int CL, typename V>
__device__ __forceinline__ auto rank_sum(const V (&v)[CL], int e) {
  decltype(v[0].x) s = 0;
#pragma unroll
  for (int r = 0; r < CL; ++r)
    s += e == 0 ? v[r].x : e == 1 ? v[r].y : e == 2 ? v[r].z : v[r].w;
  return s;
}

// ------------------------------------------------------------ host side

// Launch `kernel` on grid blocks in clusters of c, cooperatively: every
// block is resident at once, or the launch fails (and the caller's
// wrapper raises) instead of deadlocking at the first grid barrier.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int grid, int c, int smem,
                   cudaStream_t stream, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of c blocks of `kernel` at `smem` bytes the card holds
// at once (cudaOccupancyMaxActiveClusters), or a negative cudaError_t
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int c, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

}  // namespace persist
}  // namespace hl
