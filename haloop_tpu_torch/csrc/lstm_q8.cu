// LSTM recurrence with int8 recurrent weights for one layer: the forward
// K1-q8 (with or without the residuals) and the backward sweep K2-q8.
//
// Replaces: haloop_tpu/nn/lstm_pallas.py _fwd_kernel and _bwd_kernel
// (launched by _fwd and _bwd, entry lstm_scan_pallas / lstm_scan_q8) in
// their quant=True mode, which hac --rnn-q8 selects.
// Plain versions: haloop_tpu_torch/nn/lstm.py lstm_scan_q8 and
// lstm_scan_bwd_q8.
//
// W_hh arrives as wq (4H, H) int8 with one fp32 scale s per row
// (nn/lstm.py quantize_rows, torch ops outside the kernels, as XLA does it
// in the JAX package). K1-q8 computes, for t = 0..T-1,
//   hq    = clip(round(h_{t-1} * 127), -127, 127)   (h the fp32 carried
//           state, h0 for the first step; round half to even)
//   acc   = hq . wq^T                                (exact int32 sums)
//   gates = x_proj[t] + float(acc) * sdiv            (sdiv = s / 127; two
//           fp32 roundings, never one fused multiply-add)
// and the exact mode's gates and cell update (lstm_fwd.cu). ys are in
// x_proj's dtype, h_last and c_last fp32, the residuals acts and cs
// always bf16. K2-q8 runs lstm_bwd.cu's sweep on bf16 residuals, except
// for the recurrent product: each step's fp32 dgates are scaled by s,
//   dgs = dgates * s;  m = max(max |dgs| over the row's 4H, 1e-20)
//   q   = clip(round(dgs / m * 127), -127, 127)
//   dh_prev = float(q . wq) * (m / 127)              (exact int32 sums)
// with one m per batch row, over all 4H columns; the stored dgates are
// bf16. The integer sums and the maxima do not depend on their order, so
// both kernels give the same bits on every run. The elementwise math uses
// round-to-nearest intrinsics where a product feeds a sum, so that each
// operation rounds once, as the plain version's tensor ops do.
//
// What bounds them on the H100: the same as the exact kernels. Every step
// needs all of wq (4H x H: 9.4 MB at H=1536, half of bf16 W_hh) and the
// steps are strictly sequential; at (T, B, H) = (385, 48, 1536) one step
// is 0.9 G int8 operations (0.46 us of tensor-core time), so what a step
// costs is moving its operands and synchronizing the SMs.
//
// The design (persist_q8 below, on persist.cuh's skeleton, as lstm_fwd.cu
// and lstm_bwd.cu run the bf16 modes): one persistent cooperative launch
// a layer call, one block an SM, blocks in clusters (4 for K1-q8, 8 for
// K2-q8, nn/lstm_cuda.py CLUSTERS), each block's int8 slice of wq
// resident in shared memory for the whole sequence (at lstm:512 16 units
// a block, 96 blocks: 102.4 KB for K1-q8, 100.4 KB for K2-q8), the int32
// partial products of a cluster summed through distributed shared memory
// in rank order. The
// integer sums are exact in any order, so both kernels give the per-step
// kernels' bits.
//  * K1-q8: cluster q owns 4u consecutive units and their four gate rows
//    of wq; block r keeps columns [r kc, (r + 1) kc) of those rows. The
//    launch's first phase quantizes h0 (each block its units) into half 0
//    of hq; step t streams the block's kc columns of hq (the half of t's
//    parity) through an mbarrier ring (cp.async.cg), multiplies them by
//    its slab (mma.sync m16n8k32, int32 sums), sums its u units' gates
//    over the cluster, runs `cell` (the per-step kernels' arithmetic),
//    writes its units' hq of h_t into the other half, with c, ys and the
//    residuals (moved after the arrive, those read no faster, c and ys
//    slower), and arrives at the grid barrier.
//  * K2-q8: cluster q owns 8u units; block r keeps columns [r kc,
//    (r + 1) kc) of 4H of their columns of wq, read from wq as it is and
//    transposed on the way into shared memory. m needs all 4H columns of a
//    batch row, which every block produces, so a step has two grid
//    barriers: each block forms its cells' deltas, raises its maximum of
//    |dgates * s| of each row in a zeroed global buffer (atomicMax on the
//    bits of non-negative floats) and arrives; stores dgates and dc while
//    the others arrive; then reads each row's m, quantizes its own cells
//    into q (int8, B x 4H) and arrives again; the next product reads q
//    (1 byte an element) through the ring. dh0 is one more product in
//    the same launch.
//  * The batch loops over 48-row tiles (K2-q8: two barriers a tile).
// Other routes, chosen by the wrapper before the launch (nn/lstm_cuda.py
// route), one launch a step: fp32 x_proj (K1-q8), shapes no plan fits
// (H = 2048 would need 18 units a block), and K1-q8 sequences shorter
// than Q8_FWD_MIN_T steps (the persistent launch's set-up against a few
// steps):
//  * H % 32 == 0: step_tc, tensor cores (mma.sync m16n8k32 s8 with int32
//    sums), both operands streamed through shared memory in 128-byte K
//    slices by a 4-stage cp.async pipeline, 16 units x 64 batch rows a
//    block; K1-q8's h0 quantized by a small launch first; K2-q8 over
//    wq^T (H, 4H), transposed once a call by the wrapper, each step's
//    block writing its cells' fp32 dgs and a partial row maximum, then a
//    launch a batch row (quant_rows) quantizing the whole row with one m,
//    and a last product-only launch forming dh0.
//  * Otherwise: step_int, CUDA-core int32 multiply-adds, each thread its
//    own cells' dot products from global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persist.cuh"

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

// round(x * 127) half to even, clipped to [-127, 127] (the TPU kernel's
// _q8_row)
__device__ __forceinline__ int8_t q8(float x) {
  const float r = rintf(__fmul_rn(x, 127.f));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr int KT = 128;             // K slice (bytes) per pipeline stage
constexpr int STAGES = 4;           // 3 slices in flight per block
constexpr int LD = KT + 16;         // smem row stride in bytes
constexpr int CH = KT / 16;         // 16-byte chunks per slice row

__global__ void quant_h0(const float* __restrict__ h0,
                         int8_t* __restrict__ hq, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) hq[i] = q8(h0[i]);
}

// ------------------------------------------------------------- K1-q8

namespace fwd {

constexpr int JT = 16;              // hidden units per block
constexpr int NR = 4 * JT;          // gate rows per block (8 n-tiles)
constexpr int BM = 64;              // batch rows per block (4 m-tiles)
constexpr int WARPS = 8;            // an m-tile and four n-tiles each
constexpr int THREADS = 32 * WARPS; // 256
constexpr int EPT = BM * JT / THREADS;  // cells per thread
constexpr int CLD = NR + 4;         // int32 stride of the product tile
constexpr size_t SMEM = (size_t)STAGES * (BM + NR) * LD;
static_assert((size_t)BM * CLD * sizeof(int) <= SMEM, "epilogue tile");
static_assert(WARPS == 2 * (BM / 16) && BM * JT % THREADS == 0, "tiling");

template <typename T>
struct Step {
  const T* xp;          // (B, 4H): x_proj[t]
  const int8_t* wq;     // (4H, H)
  const float* sdiv;    // (4H): s / 127
  const int8_t* hq;     // (B, H): h_{t-1} quantized
  float* c;             // (B, H), updated in place
  int8_t* hq_next;      // (B, H): h_t quantized, for step t+1
  T* y;                 // (B, H): ys[t]
  float* h_out;         // (B, H) on the last step, else null
  bf16* acts;           // (B, 4H): acts[t], or null
  bf16* cs;             // (B, H): cs[t], or null
};

// x_proj's four gates and c of cell (b, j)
template <typename T>
__device__ __forceinline__ void load_cell(const Step<T>& p, size_t b, int j,
                                          int H, float (&zx)[4], float& cv) {
  const T* x = p.xp + b * 4 * H + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) zx[g] = to_float(x[g * H]);
  cv = p.c[b * H + j];
}

// The cell update of (b, j) from its four int32 sums
template <typename T>
__device__ __forceinline__ void cell(const Step<T>& p, const float (&zx)[4],
                                     float cv, const int (&acc)[4], size_t b,
                                     int j, int H) {
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    z[g] = __fadd_rn(zx[g], __fmul_rn(__int2float_rn(acc[g]),
                                      p.sdiv[g * H + j]));
  const float i = sigmoid(z[0]), f = sigmoid(z[1]), g = tanhf(z[2]);
  const float o = sigmoid(z[3]);
  const float c = __fadd_rn(__fmul_rn(f, cv), __fmul_rn(i, g));
  const float h = __fmul_rn(o, tanhf(c));
  const size_t u = b * H + j;
  p.c[u] = c;
  p.y[u] = from_float<T>(h);
  p.hq_next[u] = q8(h);
  if (p.h_out) p.h_out[u] = h;
  if (p.acts) {
    bf16* a = p.acts + b * 4 * H + j;
    a[0] = __float2bfloat16(i);
    a[H] = __float2bfloat16(f);
    a[2 * H] = __float2bfloat16(g);
    a[3 * H] = __float2bfloat16(o);
    p.cs[u] = __float2bfloat16(c);
  }
}

// tensor cores; requires H % 32 == 0 (whole 16-byte chunks, 32-deep mma)
template <typename T>
__global__ void __launch_bounds__(THREADS)
step_tc(const Step<T> p, int B, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][LD]: hq
  int8_t* b_s = a_s + STAGES * BM * LD;           // [STAGES][NR][LD]: wq
  int* c_s = reinterpret_cast<int*>(smem);        // [BM][CLD], after the loop

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int mt = warp / 2, n0 = (warp % 2) * 4;   // m-tile, first n-tile
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BM;
  const int nk = (H + KT - 1) / KT;
  const bool live_warp = b0 + mt * 16 < B;

  auto load = [&](int slot, int k0) {
    for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 16, b = b0 + r;
      int8_t* dst = a_s + (slot * BM + r) * LD + (i % CH) * 16;
      if (b < B && k < H)
        hl::cp_async16(dst, p.hq + (size_t)b * H + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int i = threadIdx.x; i < NR * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 16, j = j0 + r % JT;
      int8_t* dst = b_s + (slot * NR + r) * LD + (i % CH) * 16;
      if (j < H && k < H)
        hl::cp_async16(dst, p.wq + (size_t)((r / JT) * H + j) * H + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * KT);
    hl::cp_async_commit();
  }

  // this thread's cells, loaded now so that their latency hides behind
  // the product loop
  float zx[EPT][4], cv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int b = b0 + i / JT, j = j0 + i % JT;
    if (b < B && j < H) load_cell(p, (size_t)b, j, H, zx[e], cv[e]);
  }

  int acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[n][v] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    hl::cp_async_wait<STAGES - 2>();
    __syncthreads();          // slice kt landed; slot (kt-1) is free
    const int next = kt + STAGES - 1;
    if (next < nk) load(next % STAGES, next * KT);
    hl::cp_async_commit();
    if (live_warp) {
      const int slot = kt % STAGES;
      const int8_t* a = a_s + (slot * BM + mt * 16 + g8) * LD + 4 * t4;
      const int8_t* bb = b_s + (slot * NR + n0 * 8 + g8) * LD + 4 * t4;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 32) {
        const uint32_t af[4] = {ld32(a + kk), ld32(a + 8 * LD + kk),
                                ld32(a + kk + 16), ld32(a + 8 * LD + kk + 16)};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          // B[k][n] = wq[row n][k]: wq's rows are B's columns
          const int8_t* w = bb + n * 8 * LD + kk;
          hl::mma_s8(acc[n], af, ld32(w), ld32(w + 16));
        }
      }
    }
  }
  hl::cp_async_wait<0>();
  __syncthreads();            // the pipeline's smem becomes the product tile
  if (live_warp) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      int* o = c_s + (mt * 16 + g8) * CLD + (n0 + n) * 8 + 2 * t4;
      o[0] = acc[n][0];
      o[1] = acc[n][1];
      o[8 * CLD] = acc[n][2];
      o[8 * CLD + 1] = acc[n][3];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int r = i / JT, jl = i % JT, b = b0 + r, j = j0 + jl;
    if (b < B && j < H) {
      const int* q = c_s + r * CLD + jl;
      const int sums[4] = {q[0], q[JT], q[2 * JT], q[3 * JT]};
      cell(p, zx[e], cv[e], sums, (size_t)b, j, H);
    }
  }
}

// CUDA-core int32 multiply-adds, any H
template <typename T>
__global__ void __launch_bounds__(THREADS)
step_int(const Step<T> p, int B, int H) {
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BM;
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int b = b0 + i / JT, j = j0 + i % JT;
    if (b >= B || j >= H) continue;
    const int8_t* h = p.hq + (size_t)b * H;
    int acc[4] = {0, 0, 0, 0};
    for (int k = 0; k < H; ++k) {
      const int hv = h[k];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g] += hv * p.wq[(size_t)(g * H + j) * H + k];
    }
    float zx[4], cv;
    load_cell(p, (size_t)b, j, H, zx, cv);
    cell(p, zx, cv, acc, (size_t)b, j, H);
  }
}

template <typename T>
cudaError_t run(const T* xp, const int8_t* wq, const float* sdiv,
                const float* h0, float* c, int8_t* hq, T* ys, float* h_last,
                bf16* acts, bf16* cs, int T_, int B, int H,
                cudaStream_t stream) {
  const bool tc = H % 32 == 0;
  if (tc) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return err;
  }
  const size_t n1 = (size_t)B * H, n4 = (size_t)B * 4 * H;
  quant_h0<<<(unsigned)((n1 + 255) / 256), 256, 0, stream>>>(h0, hq,
                                                             (int)n1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((H + JT - 1) / JT, (B + BM - 1) / BM);
  for (int t = 0; t < T_; ++t) {
    const Step<T> p{xp + t * n4, wq, sdiv, hq + (t & 1) * n1, c,
                    hq + ((t + 1) & 1) * n1, ys + t * n1,
                    t == T_ - 1 ? h_last : nullptr,
                    acts ? acts + t * n4 : nullptr,
                    cs ? cs + t * n1 : nullptr};
    if (tc)
      step_tc<T><<<grid, THREADS, SMEM, stream>>>(p, B, H);
    else
      step_int<T><<<grid, THREADS, 0, stream>>>(p, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace fwd

// ------------------------------------------------------------- K2-q8

namespace bwd {

constexpr int JU = 16;              // hidden units per block (2 n-tiles)
constexpr int BM = 64;              // batch rows per block (4 m-tiles)
constexpr int WARPS = BM / 16;      // one m-tile each
constexpr int THREADS = 32 * WARPS; // 128
constexpr int EPT = BM * JU / THREADS;  // cells per thread
constexpr int CLD = JU + 4;         // int32 stride of the product tile
constexpr size_t SMEM = (size_t)STAGES * (BM + JU) * LD;
static_assert((size_t)BM * CLD * sizeof(int) <= SMEM, "epilogue tile");
// the cells of one batch row are 16 consecutive lanes (a half warp)
static_assert(JU == 16 && THREADS % JU == 0, "row maxima by half warps");

// One step's pointers. q null: the carried dh is dh_init (t = T-1).
// dg_out null: product only, dh goes to dh_out (the final dh0 launch).
struct Step {
  const int8_t* q;      // (B, 4H): dgates[t+1] * s quantized
  const float* mq;      // (B): its m / 127
  const int8_t* wt;     // (H, 4H): wq^T
  const float* s;       // (4H)
  const float* dh_init; // (B, H)
  const bf16* dys;      // (B, H): dys[t]
  const bf16* acts;     // (B, 4H): acts[t]
  const bf16* cs;       // (B, H): cs[t]
  const bf16* c_prev;   // (B, H): cs[t-1] or c0
  float* dc;            // (B, H), updated in place
  bf16* dg_out;         // (B, 4H): dgates[t]
  float* dgs;           // (B, 4H): dgates[t] * s in fp32
  float* pmax;          // (B, gridDim.x): each block's max |dgs| of a row
  float* dh_out;        // (B, H): dh0
};

// The inputs of cell (b, j)'s delta, loaded ahead of the product.
struct Cell {
  float dy, i, f, g, o, c, cp, dc;
};

__device__ __forceinline__ Cell load_cell(const Step& p, size_t b, int j,
                                          int H) {
  Cell x;
  const size_t u = b * H + j;
  const bf16* a = p.acts + b * 4 * H + j;
  x.dy = to_float(p.dys[u]);
  x.i = to_float(a[0]);
  x.f = to_float(a[H]);
  x.g = to_float(a[2 * H]);
  x.o = to_float(a[3 * H]);
  x.c = to_float(p.cs[u]);
  x.cp = to_float(p.c_prev[u]);
  x.dc = p.dc[u];
  return x;
}

// The elementwise delta of a cell given dh_rec, the recurrent part of dh:
// the four gate deltas d and the dc carried to the step before
__device__ __forceinline__ void delta(const Cell& x, float dh_rec,
                                      float (&d)[4], float& dc_prev) {
  const float dh = __fadd_rn(dh_rec, x.dy);
  const float tc = tanhf(x.c);
  const float d_o = __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), x.o),
                              __fsub_rn(1.f, x.o));
  const float dc = __fadd_rn(
      x.dc, __fmul_rn(__fmul_rn(dh, x.o),
                      __fsub_rn(1.f, __fmul_rn(tc, tc))));
  d[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, x.g), x.i), __fsub_rn(1.f, x.i));
  d[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, x.cp), x.f), __fsub_rn(1.f, x.f));
  d[2] = __fmul_rn(__fmul_rn(dc, x.i), __fsub_rn(1.f, __fmul_rn(x.g, x.g)));
  d[3] = d_o;
  dc_prev = __fmul_rn(dc, x.f);
}

// The gate deltas d of a cell given dh_rec, their fp32 products v with
// s and the dc carried to the step before; returns the largest |v|
__device__ __forceinline__ float scaled_delta(const Step& p, const Cell& x,
                                              float dh_rec, int j, int H,
                                              float (&d)[4], float (&v)[4],
                                              float& dc_prev) {
  delta(x, dh_rec, d, dc_prev);
  float m = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    v[g] = __fmul_rn(d[g], p.s[g * H + j]);
    m = fmaxf(m, fabsf(v[g]));
  }
  return m;
}

// Cell (b, j)'s gate deltas (bf16), their products with s (into p.dgs
// when it is set) and its carried dc
__device__ __forceinline__ void store_delta(const Step& p, const float (&d)[4],
                                            const float (&v)[4],
                                            float dc_prev, size_t b, int j,
                                            int H) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const size_t r = b * 4 * H + g * H + j;
    p.dg_out[r] = __float2bfloat16(d[g]);
    if (p.dgs) p.dgs[r] = v[g];
  }
  p.dc[b * H + j] = dc_prev;
}

// The epilogue of one cell of this thread: its delta (or dh0), then each
// batch row's maximum of |dgates * s| over the block's cells into pmax.
// Every thread calls it for each of its cells, live or not: the cells of
// a batch row are a half warp, reduced by shuffles.
__device__ __forceinline__ void finish(const Step& p, const Cell& x,
                                       float dh_rec, int b, int j, int B,
                                       int H) {
  const bool live = b < B && j < H;
  if (!p.dg_out) {            // the dh0 launch (uniform across the grid)
    if (live) p.dh_out[(size_t)b * H + j] = dh_rec;
    return;
  }
  float d[4], v[4], dc;
  float m = 0.f;
  if (live) {
    m = scaled_delta(p, x, dh_rec, j, H, d, v, dc);
    store_delta(p, d, v, dc, (size_t)b, j, H);
  }
#pragma unroll
  for (int off = JU / 2; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % JU == 0 && b < B)
    p.pmax[(size_t)b * gridDim.x + blockIdx.x] = m;
}

// tensor cores; requires H % 32 == 0 (4H a whole number of slices)
__global__ void __launch_bounds__(THREADS)
step_tc(const Step p, int B, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][LD]: q
  int8_t* b_s = a_s + STAGES * BM * LD;           // [STAGES][JU][LD]: wq^T
  int* c_s = reinterpret_cast<int*>(smem);        // [BM][CLD], after the loop

  const int lane = threadIdx.x % 32, mt = threadIdx.x / 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int j0 = blockIdx.x * JU, b0 = blockIdx.y * BM;
  const int K = 4 * H, nk = K / KT;
  const bool live_warp = b0 + mt * 16 < B;

  auto load = [&](int slot, int k0) {
    for (int i = threadIdx.x; i < BM * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 16, b = b0 + r;
      int8_t* dst = a_s + (slot * BM + r) * LD + (i % CH) * 16;
      if (b < B)
        hl::cp_async16(dst, p.q + (size_t)b * K + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int i = threadIdx.x; i < JU * CH; i += THREADS) {
      const int r = i / CH, k = k0 + (i % CH) * 16, j = j0 + r;
      int8_t* dst = b_s + (slot * JU + r) * LD + (i % CH) * 16;
      if (j < H)
        hl::cp_async16(dst, p.wt + (size_t)j * K + k);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  if (p.q) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s * KT);
      hl::cp_async_commit();
    }
  }

  // this thread's cells, loaded now so that their latency hides behind
  // the product loop
  Cell cell[EPT];
  if (p.dg_out) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = threadIdx.x + e * THREADS;
      const int b = b0 + i / JU, j = j0 + i % JU;
      if (b < B && j < H) cell[e] = load_cell(p, (size_t)b, j, H);
    }
  }

  if (p.q) {
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int kt = 0; kt < nk; ++kt) {
      hl::cp_async_wait<STAGES - 2>();
      __syncthreads();        // slice kt landed; slot (kt-1) is free
      const int next = kt + STAGES - 1;
      if (next < nk) load(next % STAGES, next * KT);
      hl::cp_async_commit();
      if (live_warp) {
        const int slot = kt % STAGES;
        const int8_t* a = a_s + (slot * BM + mt * 16 + g8) * LD + 4 * t4;
        const int8_t* bb = b_s + (slot * JU + g8) * LD + 4 * t4;
#pragma unroll
        for (int kk = 0; kk < KT; kk += 32) {
          const uint32_t af[4] = {ld32(a + kk), ld32(a + 8 * LD + kk),
                                  ld32(a + kk + 16),
                                  ld32(a + 8 * LD + kk + 16)};
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            // B[k][n] = wq^T[j0 + n][k]: wq^T's rows are B's columns
            const int8_t* w = bb + n * 8 * LD + kk;
            hl::mma_s8(acc[n], af, ld32(w), ld32(w + 16));
          }
        }
      }
    }
    hl::cp_async_wait<0>();
    __syncthreads();          // the pipeline's smem becomes the product tile
    if (live_warp) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        int* o = c_s + (mt * 16 + g8) * CLD + n * 8 + 2 * t4;
        o[0] = acc[n][0];
        o[1] = acc[n][1];
        o[8 * CLD] = acc[n][2];
        o[8 * CLD + 1] = acc[n][3];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int r = i / JU, jl = i % JU, b = b0 + r, j = j0 + jl;
    float dh_rec = 0.f;
    if (b < B && j < H)
      dh_rec = p.q ? __fmul_rn(__int2float_rn(c_s[r * CLD + jl]), p.mq[b])
                   : p.dh_init[(size_t)b * H + j];
    finish(p, cell[e], dh_rec, b, j, B, H);
  }
}

// CUDA-core int32 multiply-adds, any H
__global__ void __launch_bounds__(THREADS)
step_int(const Step p, int B, int H) {
  const int j0 = blockIdx.x * JU, b0 = blockIdx.y * BM;
  const int K = 4 * H;
  for (int e = 0; e < EPT; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int b = b0 + i / JU, j = j0 + i % JU;
    Cell x{};
    float dh_rec = 0.f;
    if (b < B && j < H) {
      if (p.q) {
        const int8_t* q = p.q + (size_t)b * K;
        const int8_t* w = p.wt + (size_t)j * K;
        int acc = 0;
        for (int k = 0; k < K; ++k) acc += q[k] * w[k];
        dh_rec = __fmul_rn(__int2float_rn(acc), p.mq[b]);
      } else {
        dh_rec = p.dh_init[(size_t)b * H + j];
      }
      if (p.dg_out) x = load_cell(p, (size_t)b, j, H);
    }
    finish(p, x, dh_rec, b, j, B, H);
  }
}

// One block a batch row b: m = the largest of the row's partial maxima
// (at least 1e-20), then q = round(dgs / m * 127) over all 4H columns and
// mq = m / 127.
__global__ void quant_rows(const float* __restrict__ dgs,
                           const float* __restrict__ pmax, int nblk,
                           int8_t* __restrict__ q, float* __restrict__ mq,
                           int K) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  float m = 0.f;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x)
    m = fmaxf(m, pmax[(size_t)b * nblk + i]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)blockDim.x / 32; ++w) m = fmaxf(m, red[w]);
    red[0] = fmaxf(m, 1e-20f);
    mq[b] = __fdiv_rn(red[0], 127.f);
  }
  __syncthreads();
  m = red[0];
  const float* d = dgs + (size_t)b * K;
  int8_t* o = q + (size_t)b * K;
  for (int r = threadIdx.x; r < K; r += blockDim.x)
    o[r] = q8(__fdiv_rn(d[r], m));
}

cudaError_t launch(const Step& p, int B, int H, cudaStream_t stream,
                   bool tc) {
  const dim3 grid((H + JU - 1) / JU, (B + BM - 1) / BM);
  if (tc)
    step_tc<<<grid, THREADS, SMEM, stream>>>(p, B, H);
  else
    step_int<<<grid, THREADS, 0, stream>>>(p, B, H);
  return cudaGetLastError();
}

cudaError_t run(const bf16* dys, const bf16* acts, const bf16* cs,
                const bf16* c0, const int8_t* wt, const float* s,
                const float* dh_init, float* dc, bf16* dgates, float* dh0,
                float* dgs, float* pmax, int8_t* q, float* mq, int T_, int B,
                int H, cudaStream_t stream) {
  const bool tc = H % 32 == 0;
  if (tc) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return err;
  }
  const int K = 4 * H, nblk = (H + JU - 1) / JU;
  const size_t g4 = (size_t)B * K, g1 = (size_t)B * H;
  for (int t = T_ - 1; t >= 0; --t) {
    const Step p{t == T_ - 1 ? nullptr : q, mq, wt, s, dh_init,
                 dys + t * g1, acts + t * g4, cs + t * g1,
                 t ? cs + (t - 1) * g1 : c0, dc, dgates + t * g4, dgs, pmax,
                 nullptr};
    cudaError_t err = launch(p, B, H, stream, tc);
    if (err != cudaSuccess) return err;
    quant_rows<<<B, 256, 0, stream>>>(dgs, pmax, nblk, q, mq, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // dh0 = the dequantized q . wq of dgates[0]
  const Step p{q, mq, wt, s, dh_init, nullptr, nullptr, nullptr, nullptr,
               dc, nullptr, nullptr, nullptr, dh0};
  return launch(p, B, H, stream, tc);
}

}  // namespace bwd

// ------------------------------------------ persistent K1-q8 and K2-q8

namespace persist_q8 {

using namespace hl::persist;

// The grid barrier's arrivals so far, the same count in every block:
// wait() returns once every block has arrived as often as this one, and
// then sees every write a block made before that arrival.
struct Phase {
  unsigned n = 0;
  __device__ __forceinline__ void arrive(unsigned* bar) {
    grid_arrive(bar);
    ++n;
  }
  __device__ __forceinline__ void wait(const unsigned* bar) const {
    grid_wait(bar, n * gridDim.x);
  }
};

// K1-q8: bf16 x_proj, H % 16 == 0; the grid is p.clusters clusters of
// p.c == CL blocks. hq (2, B, H): step t reads half t % 2 and writes the
// other; half 0 holds h0's quantization, written by the launch's first
// phase.
template <int CL, int NPW>
__global__ void __launch_bounds__(THREADS, 1)
fwd_k(const bf16* __restrict__ xp, const int8_t* __restrict__ wq,
      const float* __restrict__ sdiv, const float* __restrict__ h0,
      float* __restrict__ c, int8_t* __restrict__ hq, bf16* __restrict__ ys,
      float* __restrict__ h_last, bf16* __restrict__ acts,
      bf16* __restrict__ cs, unsigned* __restrict__ bar, int T, int B,
      int H, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cu = p.c * p.u;
  const Layout lay(p, 1);
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);      // [n][kc + 16]
  void* x_s = smem + lay.slab;                        // [stages][BM][KS + 16]
  int* p_s = reinterpret_cast<int*>(smem + lay.slab);  // [wk][n][BM]
  uint32_t peer[CL];                        // the partials of the cluster
  peers(peer, hl::smem_addr(p_s));
  const uint32_t bars = hl::smem_addr(smem + lay.bars);
  uint32_t par = 0;                         // the ring's next parities
  const int rank = static_cast<int>(hl::cluster_rank());
  const int q = blockIdx.x / p.c;           // this block's cluster
  const int j0 = q * cu;                    // the cluster's first unit
  const int k0 = rank * p.kc;               // this block's columns of hq
  const int cols = min(p.kc, H - k0);
  const int warp = threadIdx.x / 32, ng = warp % p.nw, wkg = warp / p.nw;
  const int ju = j0 + rank * p.u;           // this block's first unit
  const int nu = max(0, min(p.u, H - ju));  // and how many it has
  const size_t n1 = (size_t)B * H, n4 = (size_t)B * 4 * H;
  Phase ph;

  // h0 quantized, this block's units: what step 0 multiplies
  for (int i = threadIdx.x; i < B * nu; i += THREADS) {
    const size_t o = (size_t)(i / nu) * H + ju + i % nu;
    hq[o] = q8(h0[o]);
  }
  ph.arrive(bar);
  // slab row g cu + jl: wq row g H + j0 + jl, this block's columns
  load_slab(w_s, p.n, p.kc, cols, wq, [&](int r) -> const int8_t* {
    const int g = r / cu, j = j0 + r % cu;
    return g < 4 && j < H ? wq + ((size_t)g * H + j) * H + k0 : nullptr;
  });

  const int lw0 = first_loader(p.nw, p.wk);
  init_ring(bars, p.stages, lw0);
  // phase stamps (-DHL_PHASES only): block 0's thread 0, each step
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  hl::cluster_arrive();                     // the partials are free
  for (int t = 0; t < T; ++t) {
    const int8_t* h = hq + (t & 1) * n1;
    const fwd::Step<bf16> st{xp + t * n4, wq, sdiv, h, c,
                             hq + ((t + 1) & 1) * n1, ys + t * n1,
                             t == T - 1 ? h_last : nullptr,
                             acts ? acts + t * n4 : nullptr,
                             cs ? cs + t * n1 : nullptr};
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
        if (b < rows && jl < nu)
          fwd::load_cell(st, (size_t)(b0 + b), ju + jl, H, zx[e], cv[e]);
      }
      hl::keep_phase(on && b0 == 0, 0, t, hl::stamp());
      if (b0 == 0) ph.wait(bar);
      hl::keep_phase(on && b0 == 0, 1, t, hl::stamp());

      int acc[NPW][MT][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0;
      hl::cluster_wait();         // the cluster is done with the partials
      product<NPW>(h, H, k0, cols, b0, rows, p.kc, w_s, x_s, bars, p.stages,
                   par, ng, wkg, p.wk, lw0, acc);
      hl::keep_phase(on && b0 == 0, 2, t, hl::stamp());
      if (wkg < p.wk) store_partial<NPW>(p_s, p.n, p.u, cu, ng, wkg, acc);
      fold_slabs(p_s, p.n, p.wk);
      hl::cluster_arrive();
      hl::cluster_wait();         // every block's partials are written
      hl::keep_phase(on && b0 == 0, 3, t, hl::stamp());

      int4 v[4][CL];              // the cells' gate sums from the CL blocks
      if (live)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gather(v[g], peer, (rank * 4 + g) * BM * p.u + i0);
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        if (live && b < rows && jl < nu) {
          int sums[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) sums[g] = rank_sum(v[g], e);
          fwd::cell(st, zx[e], cv[e], sums, (size_t)(b0 + b), ju + jl, H);
        }
      }
      hl::keep_phase(on && b0 == 0, 4, t, hl::stamp());
      hl::cluster_arrive();       // this block is done with the partials
    }
    if (t + 1 < T) ph.arrive(bar);
    hl::keep_phase(on, 5, t, hl::stamp());
  }
  hl::cluster_wait();             // no block leaves while a peer reads it
}

// K2-q8: H % 16 == 0; the grid is p.clusters clusters of p.c == CL
// blocks; two grid barriers a step (a tile of 48 batch rows). Each block
// computes its cells' deltas and raises each row's maximum of
// |dgates * s| in gmax (2, B: the bits of non-negative floats order as
// the floats; half t % 2, the other half zeroed by block 0 for the next
// step) and arrives; once every block has, each reads its rows' m,
// quantizes its own cells into q (B, 4H) int8 (block 0 also writes mq
// (B) = m / 127) and arrives again; the next product reads q.
template <int CL, int NPW>
__global__ void __launch_bounds__(THREADS, 1)
bwd_k(const bf16* __restrict__ dys, const bf16* __restrict__ acts,
      const bf16* __restrict__ cs, const bf16* __restrict__ c0,
      const int8_t* __restrict__ wq, const float* __restrict__ s,
      const float* __restrict__ dh_init, float* __restrict__ dc,
      bf16* __restrict__ dgates, float* __restrict__ dh0,
      int8_t* __restrict__ q, float* __restrict__ mq,
      unsigned* __restrict__ bar, int* __restrict__ gmax, int T, int B,
      int H, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float m_s[BM];                 // the tile's row scales m
  __shared__ int rmax_s[BM];                // this block's row maxima
  const int cu = p.c * p.u, K = 4 * H;
  const Layout lay(p, 1);
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);      // [n][kc + 16]
  void* x_s = smem + lay.slab;                        // [stages][BM][KS + 16]
  int* p_s = reinterpret_cast<int*>(smem + lay.slab);  // [wk][n][BM]
  uint32_t peer[CL];                        // the partials of the cluster
  peers(peer, hl::smem_addr(p_s));
  const uint32_t bars = hl::smem_addr(smem + lay.bars);
  uint32_t par = 0;                         // the ring's next parities
  const int rank = static_cast<int>(hl::cluster_rank());
  const int qc = blockIdx.x / p.c;          // this block's cluster
  const int j0 = qc * cu;                   // the cluster's first unit
  const int k0 = rank * p.kc;               // this block's columns of 4H
  const int cols = min(p.kc, K - k0);
  const int warp = threadIdx.x / 32, ng = warp % p.nw, wkg = warp / p.nw;
  const int ju = j0 + rank * p.u;           // this block's first unit
  const int nu = max(0, min(p.u, H - ju));  // and how many it has
  const size_t g4 = (size_t)B * K, g1 = (size_t)B * H;
  Phase ph;

  // slab row jl, column k: wq[k0 + k][j0 + jl] (wq^T's row j0 + jl; the
  // plan's n is the cluster's c u units), read from wq's rows in 8-byte
  // runs of units and transposed on the way in
  {
    const int ldw = p.kc + 16, runs = cu / 8;   // u even: 8 | c u
    for (int i = threadIdx.x; i < p.kc * runs; i += THREADS) {
      const int k = i % p.kc, r8 = i / p.kc, j = j0 + r8 * 8;
      uint2 w = make_uint2(0, 0);
      if (k < cols && j < H)
        w = __ldg(reinterpret_cast<const uint2*>(wq + (size_t)(k0 + k) * H +
                                                 j));
      const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int e = 0; e < 8; ++e) w_s[(r8 * 8 + e) * ldw + k] = b[e];
    }
    __syncthreads();
  }

  const int lw0 = first_loader(p.nw, p.wk);
  init_ring(bars, p.stages, lw0);
  // phase stamps (-DHL_PHASES only): block 0's thread 0, each step
  const bool on = blockIdx.x == 0 && threadIdx.x == 0;
  hl::cluster_arrive();                     // the partials are free
  for (int sidx = 0; sidx <= T; ++sidx) {
    const int t = T - 1 - sidx;   // the step whose delta follows; -1: dh0
    bwd::Step st{};
    if (t >= 0)
      st = bwd::Step{nullptr, nullptr, nullptr, s, dh_init, dys + t * g1,
                     acts + t * g4, cs + t * g1,
                     t ? cs + (t - 1) * g1 : c0, dc, dgates + t * g4,
                     nullptr, nullptr, nullptr};
    int* gm = gmax + (t & 1) * B;           // step t's row maxima
    for (int b0 = 0; b0 < B; b0 += BM) {
      const int rows = min(BM, B - b0);
      // this thread's cells (b0 + i / u, ju + i % u), i = 4 tid .. + 3:
      // residuals and dc, loaded before the barrier so that their latency
      // hides
      const int i0 = GC * threadIdx.x;
      const bool live = i0 < rows * p.u;
      bwd::Cell cell[GC];
      float dhr[GC];
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        dhr[e] = 0.f;
        if (b < rows && jl < nu) {
          const size_t bb = b0 + b;
          if (t >= 0) cell[e] = bwd::load_cell(st, bb, ju + jl, H);
          if (sidx == 0) dhr[e] = dh_init[bb * H + ju + jl];
        }
      }
      if (sidx > 0) {           // dh_rec = q(dgates[t+1] * s) . wq m / 127
        hl::keep_phase(on && b0 == 0, 0, sidx, hl::stamp());
        ph.wait(bar);
        hl::keep_phase(on && b0 == 0, 1, sidx, hl::stamp());
        int acc[NPW][MT][4];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0;
        hl::cluster_wait();     // the cluster is done with the partials
        product<NPW>(q, K, k0, cols, b0, rows, p.kc, w_s, x_s, bars,
                     p.stages, par, ng, wkg, p.wk, lw0, acc);
        hl::keep_phase(on && b0 == 0, 2, sidx, hl::stamp());
        if (wkg < p.wk) store_partial<NPW>(p_s, p.n, p.u, cu, ng, wkg, acc);
        fold_slabs(p_s, p.n, p.wk);
        hl::cluster_arrive();
        hl::cluster_wait();     // every block's partials are written
        hl::keep_phase(on && b0 == 0, 3, sidx, hl::stamp());
        int4 v[CL];             // the cells' sums from the CL blocks
        if (live) {
          gather(v, peer, rank * BM * p.u + i0);
#pragma unroll
          for (int e = 0; e < GC; ++e) {
            const int b = (i0 + e) / p.u;
            if (b < rows)
              dhr[e] = __fmul_rn(__int2float_rn(rank_sum(v, e)),
                                 __ldcg(mq + b0 + b));
          }
        }
        hl::keep_phase(on && b0 == 0, 4, sidx, hl::stamp());
        hl::cluster_arrive();   // this block is done with the partials
      }
      if (t < 0) {              // dh0
#pragma unroll
        for (int e = 0; e < GC; ++e) {
          const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
          if (b < rows && jl < nu)
            dh0[(size_t)(b0 + b) * H + ju + jl] = dhr[e];
        }
        continue;
      }
      // the cells' deltas; this block's maximum of |dgates * s| in each of
      // the tile's rows, raised in gm (its only write before the arrive,
      // whose release then waits for nothing else)
      if (threadIdx.x < BM) rmax_s[threadIdx.x] = 0;
      __syncthreads();
      float d[GC][4], v[GC][4], dcp[GC];
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        if (b < rows && jl < nu) {
          const float m = bwd::scaled_delta(st, cell[e], dhr[e], ju + jl, H,
                                            d[e], v[e], dcp[e]);
          atomicMax(rmax_s + b, __float_as_int(m));
        }
      }
      __syncthreads();
      if (threadIdx.x < rows)
        atomicMax(gm + b0 + threadIdx.x, rmax_s[threadIdx.x]);
      ph.arrive(bar);
      hl::keep_phase(on && b0 == 0, 5, sidx, hl::stamp());
      // while the others arrive: dgates[t] and dc, which no block reads
      // in this launch
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        if (b < rows && jl < nu)
          bwd::store_delta(st, d[e], v[e], dcp[e], (size_t)(b0 + b), ju + jl,
                           H);
      }
      // every block's maxima are in: each row's m (at least 1e-20); the
      // owners quantize their cells, and the next product reads q and mq
      hl::keep_phase(on && b0 == 0, 6, sidx, hl::stamp());
      ph.wait(bar);
      if (threadIdx.x < rows) {
        const float m = fmaxf(__int_as_float(__ldcg(gm + b0 + threadIdx.x)),
                              1e-20f);
        m_s[threadIdx.x] = m;
        if (blockIdx.x == 0) {
          mq[b0 + threadIdx.x] = __fdiv_rn(m, 127.f);
          gmax[((t + 1) & 1) * B + b0 + threadIdx.x] = 0;   // step t-1's
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < GC; ++e) {
        const int b = (i0 + e) / p.u, jl = (i0 + e) % p.u;
        if (b < rows && jl < nu) {
          int8_t* o = q + (size_t)(b0 + b) * K + ju + jl;
#pragma unroll
          for (int g = 0; g < 4; ++g)
            o[g * H] = q8(__fdiv_rn(v[e][g], m_s[b]));
        }
      }
      hl::keep_phase(on && b0 == 0, 7, sidx, hl::stamp());
      ph.arrive(bar);
    }
  }
  hl::cluster_wait();             // no block leaves while a peer reads it
}

template <int CL>
cudaError_t fwd_run(const bf16* xp, const int8_t* wq, const float* sdiv,
                    const float* h0, float* c, int8_t* hq, bf16* ys,
                    float* h_last, bf16* acts, bf16* cs, unsigned* bar,
                    int T_, int B, int H, const Plan& p, cudaStream_t st) {
  auto go = [&](auto kernel) {
    return hl::persist::launch(kernel, p.clusters * p.c, p.c, p.smem, st, xp,
                               wq, sdiv, h0, c, hq, ys, h_last, acts, cs, bar,
                               T_, B, H, p);
  };
  switch (p.npw) {
    case 1: return go(fwd_k<CL, 1>);
    case 2: return go(fwd_k<CL, 2>);
    case 3: return go(fwd_k<CL, 3>);
    case 4: return go(fwd_k<CL, 4>);
  }
  return cudaErrorInvalidValue;
}

template <int CL>
cudaError_t bwd_run(const bf16* dys, const bf16* acts, const bf16* cs,
                    const bf16* c0, const int8_t* wq, const float* s,
                    const float* dh_init, float* dc, bf16* dgates,
                    float* dh0, int8_t* q, float* mq, unsigned* bar, int T_,
                    int B, int H, const Plan& p, cudaStream_t st) {
  auto go = [&](auto kernel) {
    return hl::persist::launch(kernel, p.clusters * p.c, p.c, p.smem, st,
                               dys, acts, cs, c0, wq, s, dh_init, dc, dgates,
                               dh0, q, mq, bar,
                               reinterpret_cast<int*>(bar + 1), T_, B, H, p);
  };
  switch (p.npw) {
    case 1: return go(bwd_k<CL, 1>);
    case 2: return go(bwd_k<CL, 2>);
    case 3: return go(bwd_k<CL, 3>);
    case 4: return go(bwd_k<CL, 4>);
  }
  return cudaErrorInvalidValue;
}

}  // namespace persist_q8

}  // namespace

// K1-q8. x_proj (T, B, 4H) and ys (T, B, H) in fp32 (bf16 == 0) or bf16;
// wq (4H, H) int8; sdiv (4H) fp32 = s / 127; h0 (B, H) fp32; c (B, H)
// fp32 holds c0 and is left holding the last c; hq (2, B, H) int8 scratch;
// h_last (B, H) fp32 receives the last h; acts (T, B, 4H) and cs (T, B, H)
// bf16 receive the residuals, or are both null. plan (host,
// hl::persist::PLAN_INTS ints) selects the persistent kernel (bf16,
// H % 16 == 0), with bar a zeroed 32-bit word on the card; null the
// per-step kernels (step_tc for H % 32 == 0, else step_int). T >= 1.
// Returns the launches' cudaError_t.
extern "C" int hl_lstm_fwd_q8(const void* xp, const void* wq,
                              const void* sdiv, const void* h0, void* c,
                              void* hq, void* ys, void* h_last, void* acts,
                              void* cs, int T, int B, int H, int bf16_,
                              const int* plan, void* bar, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sd = static_cast<const float*>(sdiv);
  const float* h = static_cast<const float*>(h0);
  float* cc = static_cast<float*>(c);
  int8_t* q = static_cast<int8_t*>(hq);
  float* hlast = static_cast<float*>(h_last);
  bf16* a = static_cast<bf16*>(acts);
  bf16* cr = static_cast<bf16*>(cs);
  cudaError_t err;
  if (plan) {
    const hl::persist::Plan p = hl::persist::read_plan(plan);
    if (!bf16_ || H % 16 != 0 || !bar) return cudaErrorInvalidValue;
    const bf16* x = static_cast<const bf16*>(xp);
    bf16* y = static_cast<bf16*>(ys);
    unsigned* b = static_cast<unsigned*>(bar);
    err = p.c == 4 ? persist_q8::fwd_run<4>(x, w, sd, h, cc, q, y, hlast, a,
                                            cr, b, T, B, H, p, st)
                   : cudaErrorInvalidValue;
  } else if (bf16_)
    err = fwd::run(static_cast<const bf16*>(xp), w, sd, h, cc, q,
                   static_cast<bf16*>(ys), hlast, a, cr, T, B, H, st);
  else
    err = fwd::run(static_cast<const float*>(xp), w, sd, h, cc, q,
                   static_cast<float*>(ys), hlast, a, cr, T, B, H, st);
  return static_cast<int>(err);
}

// K2-q8. dys (T, B, H), acts (T, B, 4H), cs (T, B, H) and c0 (B, H) in
// bf16; s (4H) fp32; dh_init (B, H) fp32, the carried dh at T-1; dc (B, H)
// fp32 holds the carried dc at T-1 and is left holding dc0; dgates
// (T, B, 4H) bf16 and dh0 (B, H) fp32 receive the results; q (B, 4H) int8
// and mq (B) fp32 are scratch. T >= 1. plan (host, hl::persist::PLAN_INTS
// ints) selects the persistent kernel (H % 16 == 0, two grid barriers a
// step): w is wq (4H, H) int8, bar 1 + 2B zeroed 32-bit words on the card
// (the barrier's counter, then the row maxima of two steps). Null selects
// the per-step kernels (step_tc for H % 32 == 0, else step_int): w is
// wq^T (H, 4H), and dgs (B, 4H) and pmax (B, ceil(H / 16)) fp32 are
// scratch too. Returns the launches' cudaError_t.
extern "C" int hl_lstm_bwd_q8(const void* dys, const void* acts,
                              const void* cs, const void* c0, const void* w,
                              const void* s, const void* dh_init, void* dc,
                              void* dgates, void* dh0, void* dgs, void* pmax,
                              void* q, void* mq, int T, int B, int H,
                              const int* plan, void* bar, void* stream) {
  const bf16* dy = static_cast<const bf16*>(dys);
  const bf16* a = static_cast<const bf16*>(acts);
  const bf16* cr = static_cast<const bf16*>(cs);
  const bf16* c0_ = static_cast<const bf16*>(c0);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* s_ = static_cast<const float*>(s);
  const float* dhi = static_cast<const float*>(dh_init);
  float* dcc = static_cast<float*>(dc);
  bf16* dg = static_cast<bf16*>(dgates);
  float* dh0_ = static_cast<float*>(dh0);
  int8_t* q_ = static_cast<int8_t*>(q);
  float* mq_ = static_cast<float*>(mq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (plan) {
    const hl::persist::Plan p = hl::persist::read_plan(plan);
    if (H % 16 != 0 || !bar) return cudaErrorInvalidValue;
    unsigned* b = static_cast<unsigned*>(bar);
    err = p.c == 8 ? persist_q8::bwd_run<8>(dy, a, cr, c0_, w8, s_, dhi, dcc,
                                            dg, dh0_, q_, mq_, b, T, B, H, p,
                                            st)
                   : cudaErrorInvalidValue;
  } else {
    err = bwd::run(dy, a, cr, c0_, w8, s_, dhi, dcc, dg, dh0_,
                   static_cast<float*>(dgs), static_cast<float*>(pmax), q_,
                   mq_, T, B, H, st);
  }
  return static_cast<int>(err);
}

#ifdef HL_PHASES
// the phase stamps of the last persistent K1-q8 or K2-q8 launch
extern "C" int hl_lstm_q8_phases(void* out) { return hl::copy_phases(out); }
#endif
