// LSTM backward sweep for one layer (exact weights).
//
// Replaces: haloop_tpu/nn/lstm_pallas.py _bwd_kernel (launched by _bwd,
// from the custom VJP of lstm_scan_pallas) in its quant=False mode.
// Plain version: haloop_tpu_torch/nn/lstm.py lstm_scan_bwd.
//
// Computes, for t = T-1 down to 0, from the residuals of the forward
// (acts[t] = post-activation i, f, g, o; cs[t] = c_t; c_prev = c_{t-1},
// c0 for t = 0) in the residual dtype:
//   dh  = dh_rec + dys[t]      dh_rec = dgates[t+1] . W  (dh_last at T-1)
//   do  = dh * tanh(c_t) * o * (1 - o)
//   dc  = dc + dh * o * (1 - tanh(c_t)^2)
//   di  = dc * g * i * (1 - i);  df = dc * c_prev * f * (1 - f)
//   dg  = dc * i * (1 - g^2)
//   dgates[t] = (di, df, dg, do) in the residual dtype;  dc <- dc * f
// and finally dh0 = dgates[0] . W, dc0 = the last dc, both fp32. The
// recurrent product takes dgates rounded to W's dtype (the stored
// dgates: the residual dtype is W's dtype on both kernel paths) and sums
// in fp32, as the TPU kernel's dot_general does; dh and dc are fp32.
//
// What bounds it on the H100: as for the forward (lstm_fwd.cu), the steps
// are strictly sequential and each is a small product (0.9 GFLOP at
// (385, 48, 1536), ~1 us of tensor-core time; 0.36 ms over the call);
// W (4H x H) fits the SMs together but no one SM. Here the exchange is
// larger: step t's product needs all of dgates[t+1] (B x 4H bf16, 590 KB
// at lstm:512), four times h, so if every block read all of it the grid
// would read 75 MB of L2 a step, what the per-step design read with W.
//
// This design (bf16, H % 8 == 0, W slices that fit: every hac width;
// persist_step below, built from persist.cuh): one persistent launch a
// layer call, one block an SM, launched cooperatively in clusters of 8.
// The wrapper passes W^T (H, 4H), transposed once a call. Cluster q owns
// 8u consecutive hidden units; block r of it keeps columns [r kc,
// (r + 1) kc) of their rows of W^T resident in shared memory (u = 14, 14
// clusters, 172 KB a block at H=1536; the card holds 15 clusters of 8 at
// once), i.e. it takes an eighth of the 4H-deep contraction. Step t
// (t = T-1 down to 0): each block loads its cells' residuals (acts[t],
// cs[t], c_prev, dys[t]) and dc ahead; waits at the grid barrier for
// dgates[t+1]; multiplies its eighth of dgates[t+1]'s columns (streamed
// through L2 by cp.async.cg, an mbarrier ring of 64-wide slices) by its
// slab on tensor cores (mma.sync m16n8k16, fp32 sums); after a cluster
// barrier sums its own u units' dh_rec over the eight blocks' partials
// through distributed shared memory in a fixed order (rank 0..7); forms
// the elementwise delta in registers, writes its units' dgates[t] and dc,
// and arrives at the grid barrier. So each block reads an eighth of
// dgates a step (8.3 MB of L2 for the grid, not 75), no sum depends on
// timing (two runs give the same bits), and dh0 = dgates[0] . W is one
// more product in the same launch. The grid barrier is a counter word the
// wrapper zeroes (release/acquire at gpu scope; its spin traps after tens
// of seconds). At a batch over 48 rows a step loops over 48-row tiles.
// fp32 (hal; persist_f32 below, on persist_f32.cuh): the same launch in
// clusters of 8, dh0 in it, exact fp32 FFMA products (no TF32), as
// lstm_fwd.cu's fp32 kernel: W^T's columns resident as far as the plan's
// shared memory allows (8 of a block's 32 slices at hal's shape, 120
// blocks of 8 x 18 units) and the rest streamed with each step's dgates
// through a TMA ring; a register tile of 8 batch rows x 9 units a thread
// in two k groups whose partial slabs are summed in order; one cell a lane
// for the delta; dgates[t] before the grid arrive, dc after it.
// Other routes, chosen by the wrapper before the launch (nn/lstm_cuda.py
// route), one launch a step and one more for dh0, a block owning 16 units
// for 64 batch rows:
//  * bf16 whose W slices do not fit (H above ~1,600 on an H100): tc_step,
//    tensor cores (WMMA 16x16x16, fp32 accumulators), dgates[t+1] and W^T
//    streamed through shared memory in 128-wide K slices by a 4-stage
//    cp.async pipeline, 4 warps.
//  * H % 8 != 0 in bf16 (fp32 takes persist_f32 at every width its plan
//    tiles): fma_step, CUDA-core FMAs in fp32; each thread owns one unit
//    for 4 batch rows and reads 32-wide k-major slices from shared memory,
//    fetching the next slice meanwhile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "persist.cuh"
#include "persist_f32.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}

// One step's pointers. dg_next null: the carried dh is dh_init (t = T-1).
// dg_out null: product only, dh goes to dh_out (the final dh0 launch).
template <typename T>
struct Step {
  const T* dg_next;     // (B, 4H): dgates[t+1]
  const T* wt;          // (H, 4H): W^T
  const float* dh_init; // (B, H)
  const T* dys;         // (B, H): dys[t]
  const T* acts;        // (B, 4H): acts[t]
  const T* cs;          // (B, H): cs[t]
  const T* c_prev;      // (B, H): cs[t-1] or c0
  float* dc;            // (B, H), updated in place
  T* dg_out;            // (B, 4H): dgates[t]
  float* dh_out;        // (B, H): dh0
};

// The inputs of cell (b, j)'s delta, loaded ahead of the product.
struct Cell {
  float dy, i, f, g, o, c, cp, dc;
};

template <typename T>
__device__ __forceinline__ Cell load_cell(const Step<T>& p, size_t b, int j,
                                          int H) {
  Cell x;
  const size_t o = b * H + j;
  const T* a = p.acts + b * 4 * H + j;
  x.dy = to_float(p.dys[o]);
  x.i = to_float(a[0]);
  x.f = to_float(a[H]);
  x.g = to_float(a[2 * H]);
  x.o = to_float(a[3 * H]);
  x.c = to_float(p.cs[o]);
  x.cp = to_float(p.c_prev[o]);
  x.dc = p.dc[o];
  return x;
}

// The elementwise delta of a cell given dh_rec, the recurrent part of
// dh: the four gate deltas (i, f, g, o) into d; returns the carried dc.
__device__ __forceinline__ float delta(const Cell& x, float dh_rec,
                                       float (&d)[4]) {
  const float dh = dh_rec + x.dy;
  const float tc = tanhf(x.c);
  d[3] = dh * tc * x.o * (1.f - x.o);
  const float dc = x.dc + dh * x.o * (1.f - tc * tc);
  d[0] = dc * x.g * x.i * (1.f - x.i);
  d[1] = dc * x.cp * x.f * (1.f - x.f);
  d[2] = dc * x.i * (1.f - x.g * x.g);
  return dc * x.f;
}

// delta for cell (b, j): writes the four gate deltas and the carried dc.
template <typename T>
__device__ __forceinline__ void cell_delta(const Step<T>& p, const Cell& x,
                                           float dh_rec, size_t b, int j,
                                           int H) {
  float d[4];
  const float dc = delta(x, dh_rec, d);
  T* o = p.dg_out + b * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) o[g * H] = from_float<T>(d[g]);
  p.dc[b * H + j] = dc;
}

// ------------------------------------------------ CUDA-core FMA step

namespace fma_step {

constexpr int JU = 16;              // hidden units per block
constexpr int RPT = 4;              // batch rows per thread
constexpr int BM = 64;              // batch rows per block
constexpr int THREADS = JU * BM / RPT;  // 256: one unit x 4 rows each
constexpr int KT = 32;              // K slice per tile
constexpr int ALD = BM + 4;         // k-major tiles: float4-aligned rows
constexpr int WLD = JU + 4;
constexpr int LA = BM * KT / THREADS;   // dgates elements each thread fetches
constexpr int LW = JU * KT / THREADS;   // W^T elements each thread fetches
static_assert(RPT == 4 && BM * KT % THREADS == 0 && JU * KT % THREADS == 0,
              "one float4 of rows per thread; whole slices per fetch");

template <typename T>
__global__ void __launch_bounds__(THREADS)
step(const Step<T> p, int B, int H) {
  __shared__ __align__(16) float a_s[2][KT][ALD];
  __shared__ __align__(16) float w_s[2][KT][WLD];

  const int jl = threadIdx.x % JU, rb = threadIdx.x / JU;
  const int j0 = blockIdx.x * JU, b0 = blockIdx.y * BM;
  const int j = j0 + jl;
  const int K = 4 * H;

  Cell cell[RPT];
  if (p.dg_out && j < H) {
#pragma unroll
    for (int n = 0; n < RPT; ++n) {
      const int b = b0 + rb * RPT + n;
      if (b < B) cell[n] = load_cell(p, (size_t)b, j, H);
    }
  }

  float acc[RPT];
#pragma unroll
  for (int n = 0; n < RPT; ++n) acc[n] = 0.f;

  if (p.dg_next) {
    float ar[LA], wr[LW];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int e = 0; e < LA; ++e) {
        const int i = threadIdx.x + e * THREADS, b = b0 + i / KT;
        const int k = k0 + i % KT;
        ar[e] = (b < B && k < K) ? to_float(p.dg_next[(size_t)b * K + k])
                                 : 0.f;
      }
#pragma unroll
      for (int e = 0; e < LW; ++e) {
        const int i = threadIdx.x + e * THREADS, jj = j0 + i / KT;
        const int k = k0 + i % KT;
        wr[e] = (jj < H && k < K) ? to_float(p.wt[(size_t)jj * K + k]) : 0.f;
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int e = 0; e < LA; ++e) {
        const int i = threadIdx.x + e * THREADS;
        a_s[buf][i % KT][i / KT] = ar[e];
      }
#pragma unroll
      for (int e = 0; e < LW; ++e) {
        const int i = threadIdx.x + e * THREADS;
        w_s[buf][i % KT][i / KT] = wr[e];
      }
    };

    const int nk = (K + KT - 1) / KT;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < nk) fetch((kt + 1) * KT);
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        const float4 av =
            *reinterpret_cast<const float4*>(&a_s[buf][kk][rb * RPT]);
        const float wv = w_s[buf][kk][jl];
        acc[0] = fmaf(av.x, wv, acc[0]);
        acc[1] = fmaf(av.y, wv, acc[1]);
        acc[2] = fmaf(av.z, wv, acc[2]);
        acc[3] = fmaf(av.w, wv, acc[3]);
      }
      if (kt + 1 < nk) stash(buf ^ 1);   // read by the last iteration: free
      __syncthreads();
    }
  }

  if (j >= H) return;
#pragma unroll
  for (int n = 0; n < RPT; ++n) {
    const int b = b0 + rb * RPT + n;
    if (b >= B) continue;
    const size_t o = (size_t)b * H + j;
    const float dh_rec = p.dg_next ? acc[n] : p.dh_init[o];
    if (p.dg_out)
      cell_delta(p, cell[n], dh_rec, (size_t)b, j, H);
    else
      p.dh_out[o] = dh_rec;
  }
}

}  // namespace fma_step

// ------------------------------------------- tensor-core (bf16) step

namespace tc_step {

using namespace nvcuda;

constexpr int JU = 16;              // hidden units per block (one n-tile)
constexpr int BM = 64;              // batch rows per block (4 m-tiles)
constexpr int KT = 128;             // K slice per pipeline stage
constexpr int STAGES = 4;           // 3 slices in flight per block
constexpr int LD = KT + 8;          // smem row stride in bf16: 16B-aligned
constexpr int WARPS = BM / 16;      // one m-tile each
constexpr int THREADS = 32 * WARPS; // 128
constexpr int EPT = BM * JU / THREADS;  // cells per thread in the epilogue
constexpr int CLD = JU + 4;         // fp32 stride of the product tile
constexpr size_t SMEM = (size_t)STAGES * (BM + JU) * LD * sizeof(bf16);
static_assert((size_t)BM * CLD * sizeof(float) <= SMEM, "epilogue tile");
static_assert(BM * JU % THREADS == 0, "whole cells per thread");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// requires H % 8 == 0: every 8-wide (16-byte) chunk is in or out whole
__global__ void __launch_bounds__(THREADS)
step(const Step<bf16> p, int B, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);      // [STAGES][BM][LD]: dg
  bf16* b_s = a_s + STAGES * BM * LD;             // [STAGES][JU][LD]: W^T
  float* c_s = reinterpret_cast<float*>(smem);    // [BM][CLD], after the loop

  const int mt = threadIdx.x / 32;                // this warp's m-tile
  const int j0 = blockIdx.x * JU;
  const int b0 = blockIdx.y * BM;
  const int K = 4 * H;
  const int nk = (K + KT - 1) / KT;
  const bool live_warp = b0 + mt * 16 < B;
  constexpr int CH = KT / 8;                      // 16-byte chunks per row

  auto load = [&](int slot, int k0) {
    for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 8, b = b0 + r;
      bf16* dst = a_s + (slot * BM + r) * LD + (i % CH) * 8;
      if (b < B && k < K)
        cp_async16(dst, p.dg_next + (size_t)b * K + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int i = threadIdx.x; i < JU * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 8, j = j0 + r;
      bf16* dst = b_s + (slot * JU + r) * LD + (i % CH) * 8;
      if (j < H && k < K)
        cp_async16(dst, p.wt + (size_t)j * K + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  if (p.dg_next) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s * KT);
      cp_async_commit();
    }
  }

  // this thread's cells, loaded now so that their latency hides behind
  // the product loop instead of the epilogue's
  Cell cell[EPT];
  if (p.dg_out) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = threadIdx.x + e * THREADS;
      const int b = b0 + i / JU, j = j0 + i % JU;
      if (b < B && j < H) cell[e] = load_cell(p, (size_t)b, j, H);
    }
  }

  if (p.dg_next) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();        // slice kt landed; slot (kt-1) is free
      const int next = kt + STAGES - 1;
      if (next < nk) load(next % STAGES, next * KT);
      cp_async_commit();
      if (live_warp) {
        const int slot = kt % STAGES;
        const bf16* a = a_s + (slot * BM + mt * 16) * LD;
        const bf16* bb = b_s + slot * JU * LD;
#pragma unroll
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa;
          // B[k][n] = W^T[j0 + n][k]: W^T's rows are B's columns
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fa, a + kk, LD);
          wmma::load_matrix_sync(fb, bb + kk, LD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();          // the pipeline's smem becomes the product tile
    if (live_warp)
      wmma::store_matrix_sync(c_s + mt * 16 * CLD, acc, CLD,
                              wmma::mem_row_major);
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int r = i / JU, jl = i % JU, b = b0 + r, j = j0 + jl;
    if (b < B && j < H) {
      const size_t o = (size_t)b * H + j;
      const float dh_rec = p.dg_next ? c_s[r * CLD + jl] : p.dh_init[o];
      if (p.dg_out)
        cell_delta(p, cell[e], dh_rec, (size_t)b, j, H);
      else
        p.dh_out[o] = dh_rec;
    }
  }
}

}  // namespace tc_step

// --------------------------------------- persistent (bf16) kernel

namespace persist_step {

using namespace hl::persist;

// requires H % 8 == 0; the grid is p.clusters clusters of p.c == CL
// blocks
constexpr int CL = 8;

template <int NPW>
__global__ void __launch_bounds__(THREADS, 1)
bwd(const bf16* __restrict__ dys, const bf16* __restrict__ acts,
    const bf16* __restrict__ cs, const bf16* __restrict__ c0,
    const bf16* __restrict__ wt, const float* __restrict__ dh_init,
    float* __restrict__ dc, bf16* __restrict__ dgates,
    float* __restrict__ dh0, unsigned* __restrict__ bar, int T, int B,
    int H, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cu = p.c * p.u, K = 4 * H;
  const Layout lay(p);
  bf16* w_s = reinterpret_cast<bf16*>(smem);          // [n][kc + 8]
  bf16* x_s = reinterpret_cast<bf16*>(smem + lay.slab);   // [stages][BM][LDX]
  float* p_s = reinterpret_cast<float*>(smem + lay.slab);  // [wk][BM][n + 4]
  uint32_t peer[CL];                        // the partials of the cluster
  peers(peer, hl::smem_addr(p_s));
  const uint32_t bars = hl::smem_addr(smem + lay.bars);
  uint32_t par = 0;                         // the ring's next parities
  const int rank = static_cast<int>(hl::cluster_rank());
  const int q = blockIdx.x / p.c;           // this block's cluster
  const int j0 = q * cu;                    // the cluster's first unit
  const int k0 = rank * p.kc;               // this block's columns of 4H
  const int cols = min(p.kc, K - k0);
  const int warp = threadIdx.x / 32, ng = warp % p.nw, wkg = warp / p.nw;
  const int ju = j0 + rank * p.u;           // this block's first unit
  const int nu = max(0, min(p.u, H - ju));  // and how many it has

  // slab row jl: W^T row j0 + jl (column j0 + jl of W), this block's
  // columns
  load_slab(w_s, p.n, p.kc, cols, wt, [&](int r) -> const bf16* {
    return r < cu && j0 + r < H ? wt + (size_t)(j0 + r) * K + k0 : nullptr;
  });

  const int lw0 = first_loader(p.nw, p.wk);
  init_ring(bars, p.stages, lw0);
  const size_t g4 = (size_t)B * K, g1 = (size_t)B * H;
  // phase stamps (-DHL_PHASES only): block 0's thread 0, each product
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  hl::cluster_arrive();                     // the partials are free
  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;    // the step whose delta follows; -1: dh0
    Step<bf16> st{};
    if (t >= 0)
      st = Step<bf16>{nullptr, wt, dh_init, dys + t * g1, acts + t * g4,
                      cs + t * g1, t ? cs + (t - 1) * g1 : c0, dc,
                      dgates + t * g4, dh0};
    for (int b0 = 0; b0 < B; b0 += BM) {
      const int rows = min(BM, B - b0);
      // this thread's cells (b0 + i / u, ju + i % u), i = 4 tid .. + 3:
      // residuals and dc, loaded before the barrier so that their latency
      // hides
      const int i0 = GC * threadIdx.x;
      const bool live = i0 < rows * p.u;
      Cell cell[GC];
      float dhr[GC];
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        dhr[e] = 0.f;
        if (b < rows && jl < nu) {
          const size_t bb = b0 + b;
          if (t >= 0) cell[e] = load_cell(st, bb, ju + jl, H);
          if (s == 0) dhr[e] = dh_init[bb * H + ju + jl];
        }
      }
      if (s > 0) {              // dh_rec = dgates[t+1] . W
        hl::keep_phase(on && b0 == 0, 0, s, hl::stamp());
        if (b0 == 0) grid_wait(bar, (unsigned)s * gridDim.x);
        hl::keep_phase(on && b0 == 0, 1, s, hl::stamp());
        float acc[NPW][MT][4];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.f;
        hl::cluster_wait();     // the cluster is done with the partials
        product<NPW>(dgates + (t + 1) * g4, K, k0, cols, b0, rows, p.kc,
                     w_s, x_s, bars, p.stages, par, ng, wkg, p.wk, lw0, acc);
        hl::keep_phase(on && b0 == 0, 2, s, hl::stamp());
        if (wkg < p.wk) store_partial<NPW>(p_s, p.n, p.u, cu, ng, wkg, acc);
        fold_slabs(p_s, p.n, p.wk);
        hl::cluster_arrive();
        hl::cluster_wait();     // every block's partials are written
        hl::keep_phase(on && b0 == 0, 3, s, hl::stamp());
        float4 v[CL];           // the cells' dh_rec from the CL blocks
        if (live) {
          gather(v, peer, rank * BM * p.u + i0);
#pragma unroll
          for (int e = 0; e < GC; ++e) dhr[e] = rank_sum(v, e);
        }
        hl::keep_phase(on && b0 == 0, 4, s, hl::stamp());
        hl::cluster_arrive();   // this block is done with the partials
      }
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        if (b < rows && jl < nu) {
          const size_t bb = b0 + b;
          if (t >= 0)
            cell_delta(st, cell[e], dhr[e], bb, ju + jl, H);
          else
            dh0[bb * H + ju + jl] = dhr[e];
        }
      }
    }
    if (t >= 0) grid_arrive(bar);
    hl::keep_phase(on, 5, s, hl::stamp());
  }
  hl::cluster_wait();           // no block leaves while a peer reads it
}

template <int NPW>
cudaError_t run(const bf16* dys, const bf16* acts, const bf16* cs,
                const bf16* c0, const bf16* wt, const float* dh_init,
                float* dc, bf16* dgates, float* dh0, unsigned* bar, int T_,
                int B, int H, const Plan& p, cudaStream_t stream) {
  return hl::persist::launch(bwd<NPW>, p.clusters * p.c, p.c, p.smem,
                             stream, dys, acts, cs, c0, wt, dh_init, dc,
                             dgates, dh0, bar, T_, B, H, p);
}

cudaError_t run_plan(const bf16* dys, const bf16* acts, const bf16* cs,
                     const bf16* c0, const bf16* wt, const float* dh_init,
                     float* dc, bf16* dgates, float* dh0, unsigned* bar,
                     int T_, int B, int H, const Plan& p, cudaStream_t s) {
  if (p.c != CL) return cudaErrorInvalidValue;
  switch (p.npw) {
    case 1: return run<1>(dys, acts, cs, c0, wt, dh_init, dc, dgates, dh0,
                          bar, T_, B, H, p, s);
    case 2: return run<2>(dys, acts, cs, c0, wt, dh_init, dc, dgates, dh0,
                          bar, T_, B, H, p, s);
    case 3: return run<3>(dys, acts, cs, c0, wt, dh_init, dc, dgates, dh0,
                          bar, T_, B, H, p, s);
    case 4: return run<4>(dys, acts, cs, c0, wt, dh_init, dc, dgates, dh0,
                          bar, T_, B, H, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace persist_step

// --------------------------------------- persistent (fp32) kernel

namespace persist_f32 {

using namespace hl::pf32;

// the grid is p.clusters clusters of p.c == CL blocks
constexpr int CL = 8;

template <int TM, int TN, int WK>
__global__ void __launch_bounds__(THREADS, 1)
bwd(const __grid_constant__ CUtensorMap wmap,   // W^T (4H, H)
    const __grid_constant__ CUtensorMap dgmap,  // dgates (4H, B, T)
    const float* __restrict__ dys, const float* __restrict__ acts,
    const float* __restrict__ cs, const float* __restrict__ c0,
    const float* __restrict__ dh_init, float* __restrict__ dc,
    float* __restrict__ dgates, float* __restrict__ dh0,
    unsigned* __restrict__ bar, int T, int B, int H, const Plan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int BM = 8 * TM;
  const Layout lay(p);
  const uint32_t base =
      (hl::smem_u32(smem_raw) + 1023) & ~1023u;   // the first 1 KB boundary
  float* p_s = reinterpret_cast<float*>(
      smem_raw + (base - hl::smem_u32(smem_raw)) + lay.region);
  const int cu = p.c * p.u;
  const int rank = static_cast<int>(hl::cluster_rank());
  const int j0 = (blockIdx.x / p.c) * cu;   // the cluster's first unit
  const int ju = j0 + rank * p.u;           // this block's first unit
  const int nu = max(0, min(p.u, H - ju));  // and how many it has
  const Geo<WK> g;
  // W rows: W^T's rows of the cluster's units, columns from rank kc
  Ring<2> rg{base + lay.region, base, base + lay.bars, &wmap, lay.slot,
             lay.hpart, lay.wrows, p.n * ROW, p.stages, lay.nsl, lay.nstr,
             rank * p.kc, j0, 0u};
  rg.init();
  rg.prefetch();

  const size_t g4 = (size_t)B * 4 * H, g1 = (size_t)B * H;
  // phase stamps (-DHL_PHASES only): block 0's thread 0, each product
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  for (int s = 0; s <= T; ++s) {
    const int t = T - 1 - s;    // the step whose delta follows; -1: dh0
    for (int b0 = 0; b0 < B; b0 += BM) {
      const int rows = min(BM, B - b0);
      const bool stp = on && b0 == 0, last = b0 + BM >= B;
      if (s > 0) {              // dh_rec = dgates[t+1] . W
        long long waited = 0, first = 0;
        hl::keep_phase(stp, 0, s, hl::stamp());
        if (b0 == 0) hl::persist::grid_wait(bar, (unsigned)s * gridDim.x);
        hl::keep_phase(stp, 1, s, hl::stamp());
        float acc[TM][TN];
        product<TM, TN, WK>(rg, &dgmap, b0, t + 1, g, acc, waited, first);
        hl::keep_phase(stp, 2, s, waited);
        hl::keep_phase(stp, 7, s, first);
        hl::keep_phase(stp, 3, s, hl::stamp());
        store_partials<TM, TN, WK>(p_s, p.n, p.u, cu, 1, BM, g, acc);
        fold(p_s, BM * p.n, p.wk);
      }
      // this thread's cells: i = tid + THREADS e of the block's BM u, cell
      // (b0 + i / u, ju + i % u), so that a warp's loads and stores run
      // along a row's units: their residuals and dc (and dh_last at the
      // first step), loaded while the cluster's partials finish
      Step<float> sp{};
      if (t >= 0)
        sp = Step<float>{nullptr, nullptr, dh_init, dys + t * g1,
                         acts + t * g4, cs + t * g1,
                         t ? cs + (t - 1) * g1 : c0, dc, dgates + t * g4,
                         dh0};
      Cell cell[CMAX];
      float dhr[CMAX];
#pragma unroll
      for (int e = 0; e < CMAX; ++e) {
        const int i = threadIdx.x + THREADS * e;
        const int b = i / p.u, jl = i % p.u;
        dhr[e] = 0.f;
        if (i < BM * p.u && b < rows && jl < nu) {
          const size_t bb = b0 + b;
          if (t >= 0) cell[e] = load_cell(sp, bb, ju + jl, H);
          if (s == 0) dhr[e] = dh_init[bb * H + ju + jl];
        }
      }
      if (s > 0) {
        hl::cluster_arrive();
        hl::cluster_wait();       // every block's partials are written
        uint32_t peer[CL];        // the partials of the cluster
        hl::persist::peers(peer, hl::smem_addr(p_s));
#pragma unroll
        for (int e = 0; e < CMAX; ++e) {
          const int i = threadIdx.x + THREADS * e;
          if (i >= BM * p.u) continue;
          // the CL blocks' partials summed in rank order
          const uint32_t off = 4u * (rank * BM * p.u + i);
          float v[CL];
#pragma unroll
          for (int r = 0; r < CL; ++r) v[r] = hl::ld_cluster(peer[r] + off);
          float sum = 0.f;
#pragma unroll
          for (int r = 0; r < CL; ++r) sum += v[r];
          dhr[e] = sum;
        }
        hl::cluster_arrive();     // this block is done with the partials
        hl::keep_phase(stp, 4, s, hl::stamp());
      }
      // the cells: dgates[t] (the next product's rows, read by every
      // block) before the grid arrive; dc, which only this thread reads,
      // and dh0 after it
      float dcv[CMAX];
#pragma unroll
      for (int e = 0; e < CMAX; ++e) {
        const int i = threadIdx.x + THREADS * e;
        const int b = i / p.u, jl = i % p.u;
        if (t >= 0 && i < BM * p.u && b < rows && jl < nu) {
          float d[4];
          dcv[e] = delta(cell[e], dhr[e], d);
          float* o = sp.dg_out + (size_t)(b0 + b) * 4 * H + ju + jl;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) o[gt * H] = d[gt];
        }
      }
      if (last && t >= 0) hl::persist::grid_arrive(bar);
#pragma unroll
      for (int e = 0; e < CMAX; ++e) {
        const int i = threadIdx.x + THREADS * e;
        const int b = i / p.u, jl = i % p.u;
        if (i < BM * p.u && b < rows && jl < nu) {
          const size_t o = (size_t)(b0 + b) * H + ju + jl;
          if (t >= 0)
            dc[o] = dcv[e];
          else
            dh0[o] = dhr[e];
        }
      }
      hl::keep_phase(stp, 5, s, hl::stamp());
      if (s > 0) {
        hl::cluster_wait();       // the peers are done with these partials
        if (s < T || !last) rg.prefetch();
      }
      hl::keep_phase(stp, 6, s, hl::stamp());
    }
  }
}

template <int TM, int TN, int WK>
cudaError_t run(const CUtensorMap& wm, const CUtensorMap& dm,
                const float* dys, const float* acts, const float* cs,
                const float* c0, const float* dh_init, float* dc,
                float* dgates, float* dh0, unsigned* bar, int T_, int B,
                int H, const Plan& p, cudaStream_t stream) {
  return hl::persist::launch(bwd<TM, TN, WK>, p.clusters * p.c, p.c, p.smem,
                             stream, wm, dm, dys, acts, cs, c0, dh_init, dc,
                             dgates, dh0, bar, T_, B, H, p);
}

cudaError_t run_plan(const float* dys, const float* acts, const float* cs,
                     const float* c0, const float* wt, const float* dh_init,
                     float* dc, float* dgates, float* dh0, unsigned* bar,
                     int T_, int B, int H, const Plan& p, cudaStream_t s) {
  if (p.c != CL || Layout(p).size != p.smem || p.c * p.u > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t k4 = (cuuint64_t)H * 16;     // a row of 4H, bytes
  const cuuint64_t wd[2] = {(cuuint64_t)H * 4, (cuuint64_t)H}, ws[1] = {k4},
                   dd[3] = {(cuuint64_t)H * 4, (cuuint64_t)B, (cuuint64_t)T_},
                   dst[2] = {k4, k4 * B};
  const cuuint32_t wb[2] = {KS, (cuuint32_t)(p.c * p.u)},
                   db[3] = {KS, (cuuint32_t)(8 * p.tm), 1};
  CUtensorMap wm, dm;
  if (!hl::slice_map_f32(&wm, wt, 2, wd, ws, wb) ||
      !hl::slice_map_f32(&dm, dgates, 3, dd, dst, db))
    return cudaErrorInvalidValue;
#define HL_F32_RUN(TM_, TN_, WK_)                                          \
  if (p.tm == TM_ && p.tn == TN_ && p.wk == WK_)                            \
    return run<TM_, TN_, WK_>(wm, dm, dys, acts, cs, c0, dh_init, dc,       \
                              dgates, dh0, bar, T_, B, H, p, s);
  HL_F32_TILES(HL_F32_RUN)
#undef HL_F32_RUN
  return cudaErrorInvalidValue;
}

}  // namespace persist_f32

template <typename T>
cudaError_t launch(const Step<T>& p, int B, int H, cudaStream_t stream,
                   bool tc) {
  if constexpr (sizeof(T) == 2) {
    if (tc) {
      using namespace tc_step;
      const dim3 grid((H + JU - 1) / JU, (B + BM - 1) / BM);
      step<<<grid, THREADS, SMEM, stream>>>(p, B, H);
      return cudaGetLastError();
    }
  }
  using namespace fma_step;
  const dim3 grid((H + JU - 1) / JU, (B + BM - 1) / BM);
  fma_step::step<T><<<grid, THREADS, 0, stream>>>(p, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* dys, const T* acts, const T* cs, const T* c0,
                const T* wt, const float* dh_init, float* dc, T* dgates,
                float* dh0, int T_, int B, int H, cudaStream_t stream,
                bool tc) {
  if (tc) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_step::step, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_step::SMEM);
    if (err != cudaSuccess) return err;
  }
  const size_t g4 = (size_t)B * 4 * H, g1 = (size_t)B * H;
  for (int t = T_ - 1; t >= 0; --t) {
    const Step<T> p{t == T_ - 1 ? nullptr : dgates + (t + 1) * g4, wt,
                    dh_init, dys + t * g1, acts + t * g4, cs + t * g1,
                    t ? cs + (t - 1) * g1 : c0, dc, dgates + t * g4,
                    nullptr};
    const cudaError_t err = launch(p, B, H, stream, tc);
    if (err != cudaSuccess) return err;
  }
  // dh0 = dgates[0] . W
  const Step<T> p{dgates, wt, dh_init, nullptr, nullptr, nullptr, nullptr,
                  dc, nullptr, dh0};
  return launch(p, B, H, stream, tc);
}

}  // namespace

// dys (T, B, H), acts (T, B, 4H), cs (T, B, H), c0 (B, H) and W^T (H, 4H)
// in fp32 (bf16 == 0) or bf16; dh_init (B, H) fp32, the carried dh at
// T-1; dc (B, H) fp32 holds the carried dc at T-1 and is left holding
// dc0; dgates (T, B, 4H) in the same dtype and dh0 (B, H) fp32 receive
// the results. T >= 1. plan (host ints: hl::persist::PLAN_INTS in bf16,
// hl::pf32::PLAN_INTS in fp32) selects the persistent kernel (bf16 with
// H % 8 == 0, or fp32), with bar a zeroed 32-bit word on the card; null
// selects the per-step kernels (tc_step for bf16 with H % 8 == 0, else
// fma_step). Returns the launches' cudaError_t.
extern "C" int hl_lstm_bwd(const void* dys, const void* acts, const void* cs,
                           const void* c0, const void* wt,
                           const void* dh_init, void* dc, void* dgates,
                           void* dh0, int T, int B, int H, int bf16_,
                           const int* plan, void* bar, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dhi = static_cast<const float*>(dh_init);
  float* dcc = static_cast<float*>(dc);
  float* dh0_ = static_cast<float*>(dh0);
  cudaError_t err;
  if (plan && !bf16_) {
    if (!bar) return cudaErrorInvalidValue;
    err = persist_f32::run_plan(
        static_cast<const float*>(dys), static_cast<const float*>(acts),
        static_cast<const float*>(cs), static_cast<const float*>(c0),
        static_cast<const float*>(wt), dhi, dcc, static_cast<float*>(dgates),
        dh0_, static_cast<unsigned*>(bar), T, B, H,
        hl::pf32::read_plan(plan), s);
  } else if (plan) {
    if (H % 8 != 0 || !bar) return cudaErrorInvalidValue;
    err = persist_step::run_plan(
        static_cast<const bf16*>(dys), static_cast<const bf16*>(acts),
        static_cast<const bf16*>(cs), static_cast<const bf16*>(c0),
        static_cast<const bf16*>(wt), dhi, dcc, static_cast<bf16*>(dgates),
        dh0_, static_cast<unsigned*>(bar), T, B, H,
        hl::persist::read_plan(plan), s);
  } else if (bf16_)
    err = run(static_cast<const bf16*>(dys), static_cast<const bf16*>(acts),
              static_cast<const bf16*>(cs), static_cast<const bf16*>(c0),
              static_cast<const bf16*>(wt), dhi, dcc,
              static_cast<bf16*>(dgates), dh0_, T, B, H, s, H % 8 == 0);
  else
    err = run(static_cast<const float*>(dys),
              static_cast<const float*>(acts), static_cast<const float*>(cs),
              static_cast<const float*>(c0), static_cast<const float*>(wt),
              dhi, dcc, static_cast<float*>(dgates), dh0_, T, B, H, s,
              false);
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the phase stamps of the last persistent K2 launch (bf16 or fp32)
extern "C" int hl_lstm_bwd_phases(void* out) { return hl::copy_phases(out); }
#endif
