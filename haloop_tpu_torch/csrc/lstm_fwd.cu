// LSTM recurrence forward for one layer (exact weights), with or without
// the residuals the backward needs.
//
// Replaces: haloop_tpu/nn/lstm_pallas.py _fwd_kernel (launched by _fwd,
// entry lstm_scan_pallas) in its quant=False mode, residuals False (the
// primal, serving) or True (under autograd, feeding lstm_bwd.cu).
// Plain version: haloop_tpu_torch/nn/lstm.py lstm_scan.
//
// Computes, for t = 0..T-1:
//   gates = x_proj[t] + h_{t-1} . W_hh^T   (h rounded to W's dtype,
//                                            products summed in fp32)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide
//                gate blocks (torch order), in fp32
//   c_t = f * c_{t-1} + i * g ;  h_t = o * tanh(c_t)
//   ys[t] = h_t in x_proj's dtype; c is carried in fp32 and the last h is
//   returned in fp32. Residual mode also stores acts[t] = (i, f, g, o)
//   (B, 4H) and cs[t] = c_t (B, H) in x_proj's dtype, the residual dtype
//   (bf16 for bf16 compute, fp32 otherwise); it changes nothing else, so
//   ys are bit for bit those of the plain mode.
// Since x_proj, W_hh and ys share one dtype, h_{t-1} rounded to W's dtype
// is exactly ys[t-1]: each step reads its h from the previous step's
// output (h0 for the first), as the TPU kernel's h.astype(w.dtype) does.
//
// What bounds it on the H100: the steps are strictly sequential, and each
// is a small product: at lstm:512's (T, B, H) = (385, 48, 1536) a step is
// 0.9 GFLOP, about 1 us of tensor-core time (the bound over the whole
// call is 0.36 ms), against W_hh (4H x H, 18.9 MB in bf16), which no SM
// can hold (227 KB of shared memory) but the card's SMs can together. A
// per-step launch re-streams W_hh from L2 every step and pays a launch;
// once W_hh stays on chip what is left is the exchange of h between the
// SMs (B x H bf16 a step, which every SM needs a part of), the partial
// sums between the blocks that split a contraction, and one grid-wide
// barrier a step. Measured on an H100 (scripts/lstm_probe.py, clock64
// stamps a phase): the product, its loads through L2 included, is about
// half of a step and the exchange, cell update and barrier the rest.
//
// This design (bf16, H % 8 == 0, W_hh slices that fit the SMs' shared
// memory: every hac width; persist_step below, built from persist.cuh):
// one persistent launch a layer call, one block an SM, launched
// cooperatively in clusters of 4 (the launch fails rather than leaving a
// block unscheduled). Cluster q owns 4u consecutive hidden units and all
// four gate rows of each (16u rows of W_hh); block r of the cluster keeps
// columns [r kc, (r + 1) kc) of those rows resident in shared memory for
// the whole sequence (u = 14, 28 clusters, 172 KB a block at lstm:512;
// the card holds 30 clusters of 4 at once). Each step a block multiplies
// its quarter of h_{t-1} (= ys[t-1], read through L2 by cp.async.cg in
// 64-wide slices, all in flight at once through an mbarrier ring that
// shares its shared memory with the partials) by its slab on tensor cores
// (mma.sync m16n8k16, fp32 sums), writes the (B x 16u) fp32 partial into
// its shared memory, and after a cluster barrier sums, for its own u
// units, the four blocks' partials through distributed shared memory in
// a fixed order (rank 0..3, 16 bytes a load): so each block reads a
// quarter of h a step (4.1 MB of L2 for the grid at lstm:512, not 17),
// and no sum depends on timing (two runs give the same bits). The cell
// update then runs in registers, four consecutive cells a thread, with
// x_proj[t] and c loaded before the barrier wait; ys[t] (and acts[t],
// cs[t]) are written, and the grid barrier (a counter word the wrapper
// zeroes, release/acquire at gpu scope, a spin that traps after tens of
// seconds) opens step t+1. At a batch over 48 rows a step loops over
// 48-row tiles.
// fp32 (hal's 1 x 2048 and the parity runs; persist_f32 below, on
// persist_f32.cuh): the products stay exact fp32 FFMA on the CUDA cores, as
// the TPU kernel's fp32 path is full precision, and W_hh (64 MiB at H =
// 2048) no longer fits the SMs. The same launch, clusters and fixed-order
// sums, with: each block's W columns kept resident as far as the plan's
// shared memory allows (the last 3 of its 16 32-column slices at hal's
// shape, 116 blocks of 4 x 18 units) and the rest streamed every step
// through a ring of 128-byte-row slots that TMA fills from one thread
// (x's rows and W's in each slot, W's issued for the next product before
// the grid barrier); the product a register tile of 8 batch rows x 9 W
// rows a thread, float4 operands from the 128 B swizzle, the whole batch
// of 64 in one tile (an 8-row tile up to B = 8: hal's completion); the
// partials summed in rank order through distributed shared memory, one
// cell a lane so that a warp's x_proj loads and ys / residual stores run
// along a row; ys before the grid arrive, c, the residuals and the last
// h after it. Bound by its FFMAs (1.07 G a step at hal's shape, ~8.2 ms
// a call at 67 TFLOP/s); measured on an H100 (scripts/lstm_probe.py
// --f32 --phases) a step is ~80% product, the rest the cluster exchange,
// the cell update and the grid barrier.
// Other routes, chosen by the wrapper before the launch (nn/lstm_cuda.py
// route), one launch a step:
//  * bf16 whose W_hh slices do not fit (H above ~1,600 on an H100):
//    tc_step, tensor cores (WMMA 16x16x16, fp32 accumulators), h and W_hh
//    streamed through shared memory in 128-wide K slices by a 4-stage
//    cp.async pipeline; 16 hidden units x 64 batch rows a block, 8 warps.
//  * H % 8 != 0 in bf16, or H % 4 != 0 in fp32: fma_step, the same block
//    shape with CUDA-core FMAs in fp32; each thread owns one unit's four
//    gates for 4 batch rows, reads 32-wide k-major slices from shared
//    memory, and fetches the next slice into registers meanwhile.

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The cell update from the four gate pre-activations (x_proj + the
// recurrent product) of cell (b, j): updates c in place, stores the
// residuals when asked (acts/cs non-null: row b of this step's (B, 4H)
// and (B, H) slices) and returns the new h.
// i, f, g, o of a cell's four gate pre-activations, and the new c
__device__ __forceinline__ void activate(float zi, float zf, float zg,
                                         float zo, float (&a)[4],
                                         float& c) {
  a[0] = sigmoid(zi);
  a[1] = sigmoid(zf);
  a[2] = tanhf(zg);
  a[3] = sigmoid(zo);
  c = a[1] * c + a[0] * a[2];
}

template <typename T>
__device__ __forceinline__ float cell_update(float zi, float zf, float zg,
                                             float zo, float& c, T* acts,
                                             T* cs, size_t b, int j,
                                             int H) {
  float a[4];
  activate(zi, zf, zg, zo, a, c);
  const float i = a[0], f = a[1], g = a[2], o = a[3];
  if (acts) {
    T* a = acts + b * 4 * H + j;
    a[0] = from_float<T>(i);
    a[H] = from_float<T>(f);
    a[2 * H] = from_float<T>(g);
    a[3 * H] = from_float<T>(o);
    cs[b * H + j] = from_float<T>(c);
  }
  return o * tanhf(c);
}

// ------------------------------------------------ CUDA-core FMA step

namespace fma_step {

constexpr int JT = 16;              // hidden units per block
constexpr int NR = 4 * JT;          // gate rows per block
constexpr int RPT = 4;              // batch rows per thread
constexpr int BM = 64;              // batch rows per block
constexpr int THREADS = JT * BM / RPT;  // 256: one unit x 4 rows each
constexpr int KT = 32;              // K slice per tile
constexpr int HLD = BM + 4;         // k-major tiles: float4-aligned rows
constexpr int WLD = NR + 4;
constexpr int LH = BM * KT / THREADS;   // h elements each thread fetches
constexpr int LW = NR * KT / THREADS;   // W elements each thread fetches
static_assert(RPT == 4 && BM * KT % THREADS == 0 && NR * KT % THREADS == 0,
              "one float4 of rows per thread; whole slices per fetch");

template <typename T>
__global__ void __launch_bounds__(THREADS)
step(const T* __restrict__ xp,       // (B, 4H): x_proj[t]
     const T* __restrict__ w,        // (4H, H)
     const T* __restrict__ h_prev,   // (B, H): ys[t-1] or h0
     float* __restrict__ c,          // (B, H), updated in place
     T* __restrict__ y,              // (B, H): ys[t]
     float* __restrict__ h_out,      // (B, H) on the last step, else null
     T* __restrict__ acts,           // (B, 4H): acts[t], or null
     T* __restrict__ cs,             // (B, H): cs[t], or null
     int B, int H) {
  // k-major, so a thread reads its 4 rows of h as one float4 and the 16
  // lanes of a row group read 16 consecutive W rows
  __shared__ __align__(16) float h_s[2][KT][HLD];
  __shared__ __align__(16) float w_s[2][KT][WLD];

  const int jl = threadIdx.x % JT, rb = threadIdx.x / JT;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BM;
  const int j = j0 + jl;

  // the next slice travels in registers while this one is multiplied;
  // consecutive threads take consecutive k, so the loads coalesce
  float hr[LH], wr[LW];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < LH; ++e) {
      const int i = threadIdx.x + e * THREADS, b = b0 + i / KT;
      const int k = k0 + i % KT;
      hr[e] = (b < B && k < H) ? to_float(h_prev[(size_t)b * H + k]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < LW; ++e) {
      const int i = threadIdx.x + e * THREADS, r = i / KT;
      const int jj = j0 + r % JT, k = k0 + i % KT;
      wr[e] = (jj < H && k < H)
          ? to_float(w[(size_t)((r / JT) * H + jj) * H + k]) : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < LH; ++e) {
      const int i = threadIdx.x + e * THREADS;
      h_s[buf][i % KT][i / KT] = hr[e];
    }
#pragma unroll
    for (int e = 0; e < LW; ++e) {
      const int i = threadIdx.x + e * THREADS;
      w_s[buf][i % KT][i / KT] = wr[e];
    }
  };

  // this thread's cells: x_proj gates and c, loaded before the loop
  float zx[RPT][4], cv[RPT];
#pragma unroll
  for (int n = 0; n < RPT; ++n) {
    const int b = b0 + rb * RPT + n;
    cv[n] = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) zx[n][g] = 0.f;
    if (b < B && j < H) {
      const T* x = xp + (size_t)b * 4 * H + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) zx[n][g] = to_float(x[g * H]);
      cv[n] = c[(size_t)b * H + j];
    }
  }

  float acc[4][RPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int n = 0; n < RPT; ++n) acc[g][n] = 0.f;

  const int nk = (H + KT - 1) / KT;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * KT);
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&h_s[buf][kk][rb * RPT]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float wv = w_s[buf][kk][g * JT + jl];
        acc[g][0] = fmaf(hv.x, wv, acc[g][0]);
        acc[g][1] = fmaf(hv.y, wv, acc[g][1]);
        acc[g][2] = fmaf(hv.z, wv, acc[g][2]);
        acc[g][3] = fmaf(hv.w, wv, acc[g][3]);
      }
    }
    if (kt + 1 < nk) stash(buf ^ 1);   // read by the last iteration: free
    __syncthreads();
  }

  if (j >= H) return;
#pragma unroll
  for (int n = 0; n < RPT; ++n) {
    const int b = b0 + rb * RPT + n;
    if (b < B) {
      float cc = cv[n];
      const float hn = cell_update(zx[n][0] + acc[0][n], zx[n][1] + acc[1][n],
                                   zx[n][2] + acc[2][n],
                                   zx[n][3] + acc[3][n], cc, acts, cs,
                                   (size_t)b, j, H);
      const size_t o = (size_t)b * H + j;
      c[o] = cc;
      y[o] = from_float<T>(hn);
      if (h_out) h_out[o] = hn;
    }
  }
}

}  // namespace fma_step

// ------------------------------------------- tensor-core (bf16) step

namespace tc_step {

using namespace nvcuda;

constexpr int JT = 16;              // hidden units per block
constexpr int NR = 4 * JT;          // gate rows per block (4 n-tiles)
constexpr int BM = 64;              // batch rows per block (4 m-tiles)
constexpr int KT = 128;             // K slice per pipeline stage
constexpr int STAGES = 4;           // 3 slices (96 KB) in flight per block
constexpr int LD = KT + 8;          // smem row stride in bf16: 16B-aligned
constexpr int WARPS = 8;            // an m-tile and two n-tiles each
constexpr int THREADS = 32 * WARPS; // 256
constexpr int EPT = BM * JT / THREADS;  // cells per thread in the epilogue
constexpr int CLD = NR + 4;         // fp32 stride of the product tile
constexpr size_t SMEM = (size_t)STAGES * (BM + NR) * LD * sizeof(bf16);
static_assert((size_t)BM * CLD * sizeof(float) <= SMEM, "epilogue tile");
static_assert(WARPS == 2 * (BM / 16) && BM * JT % THREADS == 0, "tiling");

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
step(const bf16* __restrict__ xp, const bf16* __restrict__ w,
     const bf16* __restrict__ h_prev, float* __restrict__ c,
     bf16* __restrict__ y, float* __restrict__ h_out,
     bf16* __restrict__ acts, bf16* __restrict__ cs, int B, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);      // [STAGES][BM][LD]: h
  bf16* b_s = a_s + STAGES * BM * LD;             // [STAGES][NR][LD]: W
  float* c_s = reinterpret_cast<float*>(smem);    // [BM][CLD], after the loop

  const int warp = threadIdx.x / 32;
  const int mt = warp / 2, nt = (warp % 2) * 2;  // m-tile, first n-tile
  const int j0 = blockIdx.x * JT;
  const int b0 = blockIdx.y * BM;
  const int nk = (H + KT - 1) / KT;
  const bool live_warp = b0 + mt * 16 < B;
  constexpr int CH = KT / 8;                      // 16-byte chunks per row

  auto load = [&](int slot, int k0) {
    for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 8, b = b0 + r;
      bf16* dst = a_s + (slot * BM + r) * LD + (i % CH) * 8;
      if (b < B && k < H)
        cp_async16(dst, h_prev + (size_t)b * H + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int i = threadIdx.x; i < NR * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 8, j = j0 + r % JT;
      bf16* dst = b_s + (slot * NR + r) * LD + (i % CH) * 8;
      if (j < H && k < H)
        cp_async16(dst, w + (size_t)((r / JT) * H + j) * H + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * KT);
    cp_async_commit();
  }

  // this thread's cells: x_proj gates and c, loaded now so that their
  // latency hides behind the product loop instead of the epilogue's
  float zx[EPT][4], cv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int b = b0 + i / JT, j = j0 + i % JT;
    cv[e] = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) zx[e][g] = 0.f;
    if (b < B && j < H) {
      const bf16* x = xp + (size_t)b * 4 * H + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) zx[e][g] = __bfloat162float(x[g * H]);
      cv[e] = c[(size_t)b * H + j];
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // slice kt landed; slot (kt-1) is free
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, next * KT);
    cp_async_commit();
    if (live_warp) {
      const int slot = kt % STAGES;
      const bf16* a = a_s + (slot * BM + mt * 16) * LD;
      const bf16* bb = b_s + (slot * NR + nt * 16) * LD;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + kk, LD);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // B[k][n] = W[row n][k]: W's rows are B's columns
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, bb + n * 16 * LD + kk, LD);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the pipeline's smem becomes the product tile
  if (live_warp) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
      wmma::store_matrix_sync(c_s + mt * 16 * CLD + (nt + n) * 16, acc[n],
                              CLD, wmma::mem_row_major);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int r = i / JT, jl = i % JT, b = b0 + r, j = j0 + jl;
    if (b < B && j < H) {
      const float* p = c_s + r * CLD + jl;
      float cc = cv[e];
      const float hn = cell_update(zx[e][0] + p[0], zx[e][1] + p[JT],
                                   zx[e][2] + p[2 * JT],
                                   zx[e][3] + p[3 * JT], cc, acts, cs,
                                   (size_t)b, j, H);
      const size_t o = (size_t)b * H + j;
      c[o] = cc;
      y[o] = __float2bfloat16(hn);
      if (h_out) h_out[o] = hn;
    }
  }
}

}  // namespace tc_step

// --------------------------------------- persistent (bf16) kernel

namespace persist_step {

using namespace hl::persist;

// requires H % 8 == 0; the grid is p.clusters clusters of p.c == CL
// blocks
constexpr int CL = 4;

template <int NPW>
__global__ void __launch_bounds__(THREADS, 1)
fwd(const bf16* __restrict__ xp, const bf16* __restrict__ w,
    const bf16* __restrict__ h0, float* __restrict__ c,
    bf16* __restrict__ ys, float* __restrict__ h_last,
    bf16* __restrict__ acts, bf16* __restrict__ cs,
    unsigned* __restrict__ bar, int T, int B, int H, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cu = p.c * p.u;
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
  const int k0 = rank * p.kc;               // this block's columns of h
  const int cols = min(p.kc, H - k0);
  const int warp = threadIdx.x / 32, ng = warp % p.nw, wkg = warp / p.nw;
  const int ju = j0 + rank * p.u;           // this block's first unit
  const int nu = max(0, min(p.u, H - ju));  // and how many it has

  // slab row g cu + jl: W_hh row g H + j0 + jl, this block's columns
  load_slab(w_s, p.n, p.kc, cols, w, [&](int r) -> const bf16* {
    const int g = r / cu, j = j0 + r % cu;
    return g < 4 && j < H ? w + ((size_t)g * H + j) * H + k0 : nullptr;
  });

  const int lw0 = first_loader(p.nw, p.wk);
  init_ring(bars, p.stages, lw0);
  const size_t in = (size_t)B * 4 * H, out = (size_t)B * H;
  // phase stamps (-DHL_PHASES only): block 0's thread 0, each step
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  hl::cluster_arrive();                     // the partials are free
  for (int t = 0; t < T; ++t) {
    const bf16* h = t ? ys + (t - 1) * out : h0;
    for (int b0 = 0; b0 < B; b0 += BM) {
      const int rows = min(BM, B - b0);
      // this thread's cells (b0 + i / u, ju + i % u), i = 4 tid .. + 3:
      // x_proj's gates and c, loaded before the barrier so that their
      // latency hides
      const int i0 = GC * threadIdx.x;
      const bool live = i0 < rows * p.u;
      float zx[GC][4], cv[GC];
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        cv[e] = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) zx[e][g] = 0.f;
        if (b < rows && jl < nu) {
          const bf16* x = xp + t * in + (size_t)(b0 + b) * 4 * H + ju + jl;
#pragma unroll
          for (int g = 0; g < 4; ++g) zx[e][g] = __bfloat162float(x[g * H]);
          cv[e] = c[(size_t)(b0 + b) * H + ju + jl];
        }
      }
      hl::keep_phase(on && b0 == 0, 0, t, hl::stamp());
      if (t > 0 && b0 == 0) grid_wait(bar, (unsigned)t * gridDim.x);
      hl::keep_phase(on && b0 == 0, 1, t, hl::stamp());

      float acc[NPW][MT][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.f;
      hl::cluster_wait();         // the cluster is done with the partials
      product<NPW>(h, H, k0, cols, b0, rows, p.kc, w_s, x_s, bars, p.stages,
                   par, ng, wkg, p.wk, lw0, acc);
      hl::keep_phase(on && b0 == 0, 2, t, hl::stamp());
      if (wkg < p.wk) store_partial<NPW>(p_s, p.n, p.u, cu, ng, wkg, acc);
      fold_slabs(p_s, p.n, p.wk);
      hl::cluster_arrive();
      hl::cluster_wait();         // every block's partials are written
      hl::keep_phase(on && b0 == 0, 3, t, hl::stamp());

      float4 v[4][CL];            // the cells' gates from the CL blocks
      if (live)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gather(v[g], peer, (rank * 4 + g) * BM * p.u + i0);
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        if (live && b < rows && jl < nu) {
          float z[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] = zx[e][g] + rank_sum(v[g], e);
          const size_t bb = b0 + b, o = bb * H + ju + jl;
          float cc = cv[e];
          const float hn = cell_update(z[0], z[1], z[2], z[3], cc,
                                       acts ? acts + t * in : nullptr,
                                       cs ? cs + t * out : nullptr, bb,
                                       ju + jl, H);
          c[o] = cc;
          ys[t * out + o] = __float2bfloat16(hn);
          if (t == T - 1) h_last[o] = hn;
        }
      }
      hl::keep_phase(on && b0 == 0, 4, t, hl::stamp());
      hl::cluster_arrive();       // this block is done with the partials
    }
    if (t + 1 < T) grid_arrive(bar);
    hl::keep_phase(on, 5, t, hl::stamp());
  }
  hl::cluster_wait();             // no block leaves while a peer reads it
}

template <int NPW>
cudaError_t run(const bf16* xp, const bf16* w, const bf16* h0, float* c,
                bf16* ys, float* h_last, bf16* acts, bf16* cs,
                unsigned* bar, int T_, int B, int H, const Plan& p,
                cudaStream_t stream) {
  return hl::persist::launch(fwd<NPW>, p.clusters * p.c, p.c, p.smem,
                             stream, xp, w, h0, c, ys, h_last, acts, cs, bar,
                             T_, B, H, p);
}

cudaError_t run_plan(const bf16* xp, const bf16* w, const bf16* h0,
                     float* c, bf16* ys, float* h_last, bf16* acts, bf16* cs,
                     unsigned* bar, int T_, int B, int H, const Plan& p,
                     cudaStream_t s) {
  if (p.c != CL) return cudaErrorInvalidValue;
  switch (p.npw) {
    case 1: return run<1>(xp, w, h0, c, ys, h_last, acts, cs, bar, T_, B, H,
                          p, s);
    case 2: return run<2>(xp, w, h0, c, ys, h_last, acts, cs, bar, T_, B, H,
                          p, s);
    case 3: return run<3>(xp, w, h0, c, ys, h_last, acts, cs, bar, T_, B, H,
                          p, s);
    case 4: return run<4>(xp, w, h0, c, ys, h_last, acts, cs, bar, T_, B, H,
                          p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace persist_step

// --------------------------------------- persistent (fp32) kernel

namespace persist_f32 {

using namespace hl::pf32;

// the grid is p.clusters clusters of p.c == CL blocks; H % 4 == 0 (TMA's
// rows of 16-byte multiples)
constexpr int CL = 4;

template <int TM, int TN, int WK>
__global__ void __launch_bounds__(THREADS, 1)
fwd(const __grid_constant__ CUtensorMap wmap,   // W_hh (H, H, 4 gates)
    const __grid_constant__ CUtensorMap h0map,  // h0 (H, B)
    const __grid_constant__ CUtensorMap ysmap,  // ys (H, B, T)
    const float* __restrict__ xp, float* __restrict__ c,
    float* __restrict__ ys, float* __restrict__ h_last,
    float* __restrict__ acts, float* __restrict__ cs,
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
  // W rows: the cluster's units' four gates, columns from rank kc
  Ring<3> rg{base + lay.region, base, base + lay.bars, &wmap, lay.slot,
             lay.hpart, lay.wrows, p.n * ROW, p.stages, lay.nsl, lay.nstr,
             rank * p.kc, j0, 0u};
  rg.init();
  rg.prefetch();

  const size_t in = (size_t)B * 4 * H, out = (size_t)B * H;
  // phase stamps (-DHL_PHASES only): block 0's thread 0, each step
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += BM) {
      const int rows = min(BM, B - b0);
      const bool st = on && b0 == 0, last = b0 + BM >= B;
      long long waited = 0, first = 0;
      hl::keep_phase(st, 0, t, hl::stamp());
      if (t > 0 && b0 == 0)
        hl::persist::grid_wait(bar, (unsigned)t * gridDim.x);
      hl::keep_phase(st, 1, t, hl::stamp());
      float acc[TM][TN];
      // h_{t-1}: ys[t-1], h0 at t = 0
      product<TM, TN, WK>(rg, t ? &ysmap : &h0map, b0, t - 1, g, acc,
                          waited, first);
      hl::keep_phase(st, 2, t, waited);
      hl::keep_phase(st, 7, t, first);
      hl::keep_phase(st, 3, t, hl::stamp());
      store_partials<TM, TN, WK>(p_s, p.n, p.u, cu, 4, BM, g, acc);
      fold(p_s, BM * p.n, p.wk);
      // this thread's cells: i = tid + THREADS e of the block's BM u, cell
      // (b0 + i / u, ju + i % u), so that a warp's loads and stores run
      // along a row's units; x_proj's gates and c, loaded while the
      // cluster's partials are finished
      float zx[CMAX][4], cv[CMAX];
#pragma unroll
      for (int e = 0; e < CMAX; ++e) {
        const int i = threadIdx.x + THREADS * e;
        const int b = i / p.u, jl = i % p.u;
        cv[e] = 0.f;
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) zx[e][gt] = 0.f;
        if (i < BM * p.u && b < rows && jl < nu) {
          const float* x = xp + t * in + (size_t)(b0 + b) * 4 * H + ju + jl;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) zx[e][gt] = x[gt * H];
          cv[e] = c[(size_t)(b0 + b) * H + ju + jl];
        }
      }
      hl::cluster_arrive();
      hl::cluster_wait();         // every block's partials are written
      {
        uint32_t peer[CL];        // the partials of the cluster
        hl::persist::peers(peer, hl::smem_addr(p_s));
#pragma unroll
        for (int e = 0; e < CMAX; ++e) {
          const int i = threadIdx.x + THREADS * e;
          if (i >= BM * p.u) continue;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) {
            // the CL blocks' partials summed in rank order
            const uint32_t off = 4u * ((rank * 4 + gt) * BM * p.u + i);
            float v[CL];
#pragma unroll
            for (int r = 0; r < CL; ++r) v[r] = hl::ld_cluster(peer[r] + off);
            float sum = 0.f;
#pragma unroll
            for (int r = 0; r < CL; ++r) sum += v[r];
            zx[e][gt] += sum;
          }
        }
      }
      hl::cluster_arrive();       // this block is done with the partials
      hl::keep_phase(st, 4, t, hl::stamp());
      // the cells: ys (the next step's h, read by every block) before the
      // grid arrive; c, the residuals and the last h, which no other
      // block reads in this launch, after it
      float av[CMAX][4], hv[CMAX];
#pragma unroll
      for (int e = 0; e < CMAX; ++e) {
        const int i = threadIdx.x + THREADS * e;
        const int b = i / p.u, jl = i % p.u;
        if (i < BM * p.u && b < rows && jl < nu) {
          activate(zx[e][0], zx[e][1], zx[e][2], zx[e][3], av[e], cv[e]);
          hv[e] = av[e][3] * tanhf(cv[e]);
          ys[t * out + (size_t)(b0 + b) * H + ju + jl] = hv[e];
        }
      }
      if (last && t + 1 < T) hl::persist::grid_arrive(bar);
#pragma unroll
      for (int e = 0; e < CMAX; ++e) {
        const int i = threadIdx.x + THREADS * e;
        const int b = i / p.u, jl = i % p.u;
        if (i < BM * p.u && b < rows && jl < nu) {
          const size_t bb = b0 + b, o = bb * H + ju + jl;
          c[o] = cv[e];
          if (acts) {
            float* a = acts + t * in + bb * 4 * H + ju + jl;
#pragma unroll
            for (int gt = 0; gt < 4; ++gt) a[gt * H] = av[e][gt];
            cs[t * out + o] = cv[e];
          }
          if (t == T - 1) h_last[o] = hv[e];
        }
      }
      hl::keep_phase(st, 5, t, hl::stamp());
      hl::cluster_wait();         // the peers are done with these partials
      if (t + 1 < T || !last) rg.prefetch();
      hl::keep_phase(st, 6, t, hl::stamp());
    }
  }
}

template <int TM, int TN, int WK>
cudaError_t run(const CUtensorMap& wm, const CUtensorMap& hm,
                const CUtensorMap& ym, const float* xp, float* c, float* ys,
                float* h_last, float* acts, float* cs, unsigned* bar, int T_,
                int B, int H, const Plan& p, cudaStream_t stream) {
  return hl::persist::launch(fwd<TM, TN, WK>, p.clusters * p.c, p.c, p.smem,
                             stream, wm, hm, ym, xp, c, ys, h_last, acts, cs,
                             bar, T_, B, H, p);
}

cudaError_t run_plan(const float* xp, const float* w, const float* h0,
                     float* c, float* ys, float* h_last, float* acts,
                     float* cs, unsigned* bar, int T_, int B, int H,
                     const Plan& p, cudaStream_t s) {
  if (p.c != CL || Layout(p).size != p.smem || H % 4 || p.c * p.u > 256)
    return cudaErrorInvalidValue;
  const int bm = 8 * p.tm;
  const cuuint64_t h4 = (cuuint64_t)H * 4;
  const cuuint64_t wd[3] = {(cuuint64_t)H, (cuuint64_t)H, 4},
                   ws[2] = {h4, h4 * H},
                   hd[2] = {(cuuint64_t)H, (cuuint64_t)B}, hs[1] = {h4},
                   yd[3] = {(cuuint64_t)H, (cuuint64_t)B, (cuuint64_t)T_},
                   yst[2] = {h4, h4 * B};
  const cuuint32_t wb[3] = {KS, (cuuint32_t)(p.c * p.u), 4},
                   hb[2] = {KS, (cuuint32_t)bm}, yb[3] = {KS, (cuuint32_t)bm, 1};
  CUtensorMap wm, hm, ym;
  if (!hl::slice_map_f32(&wm, w, 3, wd, ws, wb) ||
      !hl::slice_map_f32(&hm, h0, 2, hd, hs, hb) ||
      !hl::slice_map_f32(&ym, ys, 3, yd, yst, yb))
    return cudaErrorInvalidValue;
#define HL_F32_RUN(TM_, TN_, WK_)                                          \
  if (p.tm == TM_ && p.tn == TN_ && p.wk == WK_)                            \
    return run<TM_, TN_, WK_>(wm, hm, ym, xp, c, ys, h_last, acts, cs, bar, \
                              T_, B, H, p, s);
  HL_F32_TILES(HL_F32_RUN)
#undef HL_F32_RUN
  return cudaErrorInvalidValue;
}

}  // namespace persist_f32

template <typename T>
cudaError_t run_fma(const T* xp, const T* w, const T* h0, float* c, T* ys,
                    float* h_last, T* acts, T* cs, int T_, int B, int H,
                    cudaStream_t stream) {
  using namespace fma_step;
  const dim3 grid((H + JT - 1) / JT, (B + BM - 1) / BM);
  const size_t in = (size_t)B * 4 * H, out = (size_t)B * H;
  for (int t = 0; t < T_; ++t) {
    step<T><<<grid, THREADS, 0, stream>>>(
        xp + t * in, w, t ? ys + (t - 1) * out : h0, c, ys + t * out,
        t == T_ - 1 ? h_last : nullptr, acts ? acts + t * in : nullptr,
        cs ? cs + t * out : nullptr, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t run_tc(const bf16* xp, const bf16* w, const bf16* h0, float* c,
                   bf16* ys, float* h_last, bf16* acts, bf16* cs, int T_,
                   int B, int H, cudaStream_t stream) {
  using namespace tc_step;
  cudaError_t err = cudaFuncSetAttribute(
      step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + JT - 1) / JT, (B + BM - 1) / BM);
  const size_t in = (size_t)B * 4 * H, out = (size_t)B * H;
  for (int t = 0; t < T_; ++t) {
    step<<<grid, THREADS, SMEM, stream>>>(
        xp + t * in, w, t ? ys + (t - 1) * out : h0, c, ys + t * out,
        t == T_ - 1 ? h_last : nullptr, acts ? acts + t * in : nullptr,
        cs ? cs + t * out : nullptr, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x_proj (T, B, 4H), W_hh (4H, H) and h0 (B, H) in fp32 (bf16 == 0) or
// bf16; c (B, H) fp32 holds c0 and is left holding the last c; ys
// (T, B, H) in the same dtype; h_last (B, H) fp32 receives the last h.
// acts (T, B, 4H) and cs (T, B, H) in the same dtype receive the
// residuals, or are both null. plan (host ints: hl::persist::PLAN_INTS
// in bf16, hl::pf32::PLAN_INTS in fp32) selects the persistent kernel
// (bf16 with H % 8 == 0, or fp32 with H % 4 == 0), with bar a zeroed
// 32-bit word on the card; null selects the per-step kernels (tc_step for
// bf16 with H % 8 == 0, else fma_step). Returns the launches'
// cudaError_t.
extern "C" int hl_lstm_fwd(const void* xp, const void* w, const void* h0,
                           void* c, void* ys, void* h_last, void* acts,
                           void* cs, int T, int B, int H, int bf16_,
                           const int* plan, void* bar, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cc = static_cast<float*>(c);
  float* hlast = static_cast<float*>(h_last);
  cudaError_t err;
  if (plan && !bf16_) {
    if (!bar) return cudaErrorInvalidValue;
    err = persist_f32::run_plan(
        static_cast<const float*>(xp), static_cast<const float*>(w),
        static_cast<const float*>(h0), cc, static_cast<float*>(ys), hlast,
        static_cast<float*>(acts), static_cast<float*>(cs),
        static_cast<unsigned*>(bar), T, B, H, hl::pf32::read_plan(plan), s);
  } else if (plan) {
    if (H % 8 != 0 || !bar) return cudaErrorInvalidValue;
    err = persist_step::run_plan(
        static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
        static_cast<const bf16*>(h0), cc, static_cast<bf16*>(ys), hlast,
        static_cast<bf16*>(acts), static_cast<bf16*>(cs),
        static_cast<unsigned*>(bar), T, B, H, hl::persist::read_plan(plan),
        s);
  } else if (bf16_ && H % 8 == 0)
    err = run_tc(static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
                 static_cast<const bf16*>(h0), cc, static_cast<bf16*>(ys),
                 hlast, static_cast<bf16*>(acts), static_cast<bf16*>(cs), T, B,
                 H, s);
  else if (bf16_)
    err = run_fma(static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
                  static_cast<const bf16*>(h0), cc, static_cast<bf16*>(ys),
                  hlast, static_cast<bf16*>(acts), static_cast<bf16*>(cs), T,
                  B, H, s);
  else
    err = run_fma(static_cast<const float*>(xp), static_cast<const float*>(w),
                  static_cast<const float*>(h0), cc, static_cast<float*>(ys),
                  hlast, static_cast<float*>(acts), static_cast<float*>(cs), T,
                  B, H, s);
  return static_cast<int>(err);
}

// What the current card offers the persistent kernels: out[0] SMs,
// out[1] shared memory a block may opt into, out[2] clusters of c blocks
// (one an SM, at out[1] bytes each) resident at once
// (cudaOccupancyMaxActiveClusters), out[3] cooperative launch supported,
// out[4] cluster launch supported. Returns a cudaError_t.
extern "C" int hl_lstm_card(int c, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[3], cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[4], cudaDevAttrClusterLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = hl::persist::max_clusters(persist_step::fwd<1>, c, out[1]);
  return out[2] < 0 ? -out[2] : 0;
}

#ifdef HL_PHASES
// the phase stamps of the last persistent K1 launch (bf16 or fp32)
extern "C" int hl_lstm_fwd_phases(void* out) { return hl::copy_phases(out); }
#endif
