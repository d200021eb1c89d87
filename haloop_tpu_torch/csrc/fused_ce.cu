// The lm_head product fused with its cross-entropy: per-row NLL and
// logsumexp of logits = x . w^T without writing the logits.
//
// Replaces: haloop_tpu/ops/fused_ce.py _ce_kernel (launched by
// _fused_ce_fwd_impl, entry fused_ce_nll). Plain version:
// haloop_tpu_torch/ops/fused_ce.py ce_nll_lse.
//
// Computes, for x (N, D), w (V, D), targets (N,):
//   logits[n, c] = x[n] . w[c] in fp32 (products of the input dtype);
//   lse[n] = log sum_c exp(logits[n, c]);  nll[n] = lse[n] - logits[n,
//   targets[n]]  (0 for the target term when the target is not in
//   [0, V)). Columns >= V do not exist (the TPU pads w with zero rows and
//   masks them to -1e30; here they are masked to -inf in the one tile
//   that has them).
//
// What bounds it on the H100: at hap's shape (N=16384, V=50304, D=768,
// bf16) the product is 1.27 TFLOP against 103 MB of x and w, so the
// tensor cores bound it: 1.28 ms at 989 TFLOP/s.
//
// This design (bf16, Hopper): a persistent kernel, one block of three
// warpgroups an SM, over work items (128-row tile of x, vocab chunk); a
// chunk is a run of 256-column vocab tiles, and the wrapper's plan
// (ops/fused_ce_cuda.py ``plan``) picks the chunk count that balances the
// blocks. Item i runs on block i mod gridDim.x, chunk-major (i = chunk *
// row_tiles + row tile), so the resident blocks read the same w tiles at
// about the same time: w comes from DRAM about once a wave and x from L2.
// Warpgroup 0 is the producer: it gives up its registers (setmaxnreg) and
// one thread issues TMA loads of each vocab tile's 64-column k slices, x's
// 128 rows (16 KB) and w's 256 rows (32 KB) a stage, into a ring of
// STAGES stages with a "full" and an "empty" mbarrier each; the ring runs
// on across tiles and items. Warpgroups 1 and 2 are the consumers, 64 rows
// of the tile each (setmaxnreg up): wgmma m64n256k16 with both operands in
// shared memory (128 B swizzle, csrc/sm90.cuh), fp32 accumulators, 128
// registers a thread. After a tile's last k slice each thread folds its 2
// rows' 64 columns into its running (max, sum of exps, target logit), in
// base 2 (log2(e) folded into the exponent's multiply-add, ex2 on MUFU);
// the columns past V are masked only in the last vocab tile, and the
// target logit is the one column equal to the target. At the end of an
// item the quad's states are merged by shuffles and written to the item's
// chunk; a second kernel merges the chunks of each row in a fixed order,
// so the result is the same from run to run.
// The fold is serial to the product: ~2,300 cycles of a tile's ~14,800
// (bound by MUFU and instruction issue), the product alone ~12,200
// (scripts/ce_probe.py --phases).
// Running the consumers k slices apart, so that one folds while the
// other's products run alone, read no faster: the 4-stage ring (all that
// fits at 48 KB a stage) then holds the slices the trailing consumer still
// needs, and the other waits for them instead (PERF.md §6).
// fp32 inputs take a CUDA-core kernel: 64 x 64 tiles of 4 x 4 outputs a
// thread, the same online state and merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// fold (m2, s2, g2) into (m, s, g)
__device__ __forceinline__ void merge(float& m, float& s, float& g, float m2,
                                     float s2, float g2) {
  const float mn = fmaxf(m, m2);
  s = s * __expf(m - mn) + s2 * __expf(m2 - mn);
  m = mn;
  g += g2;
}

// the vocab tiles [vt0, vt1) of one chunk
__device__ __forceinline__ void vocab_range(int V, int cols, int chunks,
                                            int chunk, int& vt0, int& vt1) {
  const int nvt = (V + cols - 1) / cols;
  const int per = (nvt + chunks - 1) / chunks;
  vt0 = min(nvt, chunk * per);
  vt1 = min(nvt, vt0 + per);
}

// ------------------------------------------------ bf16, wgmma and TMA

namespace wg {

constexpr int BM = 128;                 // rows of a tile, 64 a consumer
constexpr int BN = 256;                 // vocab columns of a tile
constexpr int KS = 64;                  // a k slice: a 128-byte bf16 row
constexpr int STAGES = 4;
constexpr int X_BYTES = BM * KS * 2;    // 16 KB
constexpr int W_BYTES = BN * KS * 2;    // 32 KB
constexpr int STAGE = X_BYTES + W_BYTES;
constexpr int BAR_OFF = STAGES * STAGE; // full[STAGES], empty[STAGES]
constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
constexpr int ATOM = 8 * 128;           // 8 swizzled rows of 128 bytes

// one item: the 128-row tile rt and the vocab tiles [vt0, vt1)
__device__ __forceinline__ void item_of(int item, int row_tiles, int V,
                                        int chunks, int& rt, int& vt0,
                                        int& vt1) {
  rt = item % row_tiles;
  vocab_range(V, BN, chunks, item / row_tiles, vt0, vt1);
}

__device__ __forceinline__ void merge2(float& m, float& s, float& g, float m2,
                                      float s2, float g2) {
  const float mn = fmaxf(m, m2);
  s = s * hl::ex2(m - mn) + s2 * hl::ex2(m2 - mn);
  m = mn;
  g += g2;
}

// Fold one tile's 64 columns of this thread's rows (16 w + g + 8 r, r =
// 0, 1: registers 4 j + 2 r + e hold column c0 + 8 j + 2 tq + e) into the
// running (m, base 2; s; g). Columns from ``lim`` on (counted from c0 + 2
// tq) do not exist.
__device__ __forceinline__ void fold(float (&acc)[128], float (&m)[2],
                                     float (&s)[2], float (&g)[2],
                                     const int (&tg)[2], int c0, int tq,
                                     int lim) {
  if (lim < BN) {                       // the last vocab tile only
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + e >= lim) {
          acc[4 * j + e] = -INFINITY;
          acc[4 * j + 2 + e] = -INFINITY;
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      mx0 = fmaxf(mx0, acc[4 * j + 2 * r]);
      mx1 = fmaxf(mx1, acc[4 * j + 2 * r + 1]);
    }
    const float mn = fmaxf(m[r], fmaxf(mx0, mx1) * LOG2E);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        p[(j & 1) * 2 + e] += hl::ex2(fmaf(acc[4 * j + 2 * r + e], LOG2E,
                                           -mn));
    s[r] = s[r] * hl::ex2(m[r] - mn) + ((p[0] + p[1]) + (p[2] + p[3]));
    m[r] = mn;
    // the target's column, if this thread holds it
    const unsigned off = (unsigned)(tg[r] - c0 - 2 * tq);
    if (off < (unsigned)BN && !(off & 6u)) {
      const int jt = off >> 3, et = off & 1;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j == jt) g[r] = et ? acc[4 * j + 2 * r + 1] : acc[4 * j + 2 * r];
    }
  }
}

// Persistent: block b runs items b, b + G, ... of the row_tiles * chunks
// items (G = gridDim.x). part (chunks, 3, N): each chunk's (max, sum of
// exps, target logit) of every row.
__global__ void __launch_bounds__(384, 1)
ce(const __grid_constant__ CUtensorMap xmap,
   const __grid_constant__ CUtensorMap wmap, const int* __restrict__ tgt,
   float* __restrict__ part, int N, int V, int D, int chunks) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hl::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = hl::smem_u32(smem);
  const uint32_t bar = base + BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  const int row_tiles = (N + BM - 1) / BM, nks = D / KS;
  const int items = row_tiles * chunks;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hl::mbar_init(full(s), 1);
      hl::mbar_init(empty(s), 8);         // each consumer warp
    }
    hl::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    // ---------------- producer: one thread issues every load
    hl::setmaxnreg_dec<40>();
    if (tid != 0) return;
    hl::prefetch_map(&xmap);
    hl::prefetch_map(&wmap);
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int rt, vt0, vt1;
      item_of(item, row_tiles, V, chunks, rt, vt0, vt1);
      for (int vt = vt0; vt < vt1; ++vt)
        for (int ks = 0; ks < nks; ++ks, ++it) {
          const int st = it % STAGES;
          hl::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
          const uint32_t xs = base + st * STAGE;
          // partial tiles still move whole boxes (zeros past N and V)
          hl::mbar_expect_tx(full(st), STAGE);
          hl::tma_load_2d(xs, &xmap, full(st), ks * KS, rt * BM);
          hl::tma_load_2d(xs + X_BYTES, &wmap, full(st), ks * KS, vt * BN);
        }
    }
    return;
  }

  // ---------------- consumers: 64 rows of each tile
  hl::setmaxnreg_inc<232>();
  const int c = wgi - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  float acc[128];
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int rt, vt0, vt1;
    item_of(item, row_tiles, V, chunks, rt, vt0, vt1);
    const int row0 = rt * BM + c * 64 + warp * 16 + g;    // and row0 + 8
    int tg[2];
    float m[2], s[2], gt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r < N ? __ldg(tgt + row0 + 8 * r) : -1;
      tg[r] = t >= 0 && t < V ? t : -1;
      m[r] = NEG * LOG2E;
      s[r] = 0.f;
      gt[r] = 0.f;
    }
    for (int vt = vt0; vt < vt1; ++vt) {
      for (int ks = 0; ks < nks; ++ks, ++it) {
        const int st = it % STAGES;
        hl::mbar_wait(full(st), (it / STAGES) & 1);
        const uint32_t xs = base + st * STAGE;
        const uint64_t da = hl::smem_desc(xs + c * 64 * 128, 16, ATOM, 1);
        const uint64_t db = hl::smem_desc(xs + X_BYTES, 16, ATOM, 1);
        hl::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)      // 32 bytes a k16 step
          hl::wgmma_ss_m64n256<0>(acc, da + 2 * kk, db + 2 * kk,
                                  (ks | kk) != 0);
        hl::wgmma_commit();
        if (ks > 0) {                   // the previous slice is read
          hl::wgmma_wait<1>();
          if (lane == 0) hl::mbar_arrive(empty((it - 1) % STAGES));
        }
      }
      hl::wgmma_wait<0>();
      if (lane == 0) hl::mbar_arrive(empty((it - 1) % STAGES));
      hl::fence_regs(acc);
      const int c0 = vt * BN;
      fold(acc, m, s, gt, tg, c0, tq, V - c0 - 2 * tq);
    }
    // the quad's 4 x 64 columns of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        merge2(m[r], s[r], gt[r], __shfl_xor_sync(0xffffffffu, m[r], off),
               __shfl_xor_sync(0xffffffffu, s[r], off),
               __shfl_xor_sync(0xffffffffu, gt[r], off));
      const int row = row0 + 8 * r;
      if (tq == 0 && row < N) {
        float* p = part + (size_t)(item / row_tiles) * 3 * N + row;
        p[0] = m[r] * LN2;
        p[N] = s[r];
        p[2 * (size_t)N] = gt[r];
      }
    }
  }
}

}  // namespace wg

// ------------------------------------------------ fp32, CUDA cores

namespace fp32k {

constexpr int BM = 64, BN = 64, KT = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ce(const float* __restrict__ x, const float* __restrict__ w,
   const int* __restrict__ tgt, float* __restrict__ part, int N, int V,
   int D) {
  __shared__ __align__(16) float As[KT][BM + 4];
  __shared__ __align__(16) float Bs[KT][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * BM, chunk = blockIdx.y;
  int vt0, vt1;
  vocab_range(V, BN, gridDim.y, chunk, vt0, vt1);

  int tg[4];
  float m[4], s[4], gt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    tg[i] = row < N ? tgt[row] : -1;
    m[i] = NEG;
    s[i] = 0.f;
    gt[i] = 0.f;
  }
  const int lr = tid / 4, lk = (tid % 4) * 4;      // the loads' row, k
  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * BN;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < D; k0 += KT) {
      const bool kin = k0 + lk < D;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (kin && r0 + lr < N)
        a = *reinterpret_cast<const float4*>(x + (size_t)(r0 + lr) * D + k0 +
                                             lk);
      if (kin && v0 + lr < V)
        b = *reinterpret_cast<const float4*>(w + (size_t)(v0 + lr) * D + k0 +
                                             lk);
      As[lk][lr] = a.x; As[lk + 1][lr] = a.y;
      As[lk + 2][lr] = a.z; As[lk + 3][lr] = a.w;
      Bs[lk][lr] = b.x; Bs[lk + 1][lr] = b.y;
      Bs[lk + 2][lr] = b.z; Bs[lk + 3][lr] = b.w;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx * 4 + j < V) tmax = fmaxf(tmax, acc[i][j]);
      const float mn = fmaxf(m[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx * 4 + j;
        if (col < V) {
          sum += expf(acc[i][j] - mn);
          if (col == tg[i]) gt[i] = acc[i][j];
        }
      }
      s[i] = s[i] * expf(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
  // the 16 threads of a row group are 16 consecutive lanes
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      merge(m[i], s[i], gt[i], __shfl_xor_sync(0xffffffffu, m[i], off),
            __shfl_xor_sync(0xffffffffu, s[i], off),
            __shfl_xor_sync(0xffffffffu, gt[i], off));
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      if (row < N) {
        float* p = part + (size_t)chunk * 3 * N + row;
        p[0] = m[i];
        p[N] = s[i];
        p[2 * (size_t)N] = gt[i];
      }
    }
}

}  // namespace fp32k

// the chunks of each row, merged in order
__global__ void merge_chunks(const float* __restrict__ part,
                             float* __restrict__ nll, float* __restrict__ lse,
                             int N, int chunks) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = NEG, s = 0.f, g = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float* p = part + (size_t)c * 3 * N + row;
    merge(m, s, g, p[0], p[N], p[2 * (size_t)N]);
  }
  const float l = m + logf(s);
  lse[row] = l;
  nll[row] = l - g;
}

cudaError_t run_wg(const void* x, const void* w, const int* targets,
                   float* partial, int N, int V, int D, int chunks, int grid,
                   cudaStream_t st) {
  CUtensorMap xm, wm;
  if (!hl::slice_map_bf16(&xm, x, D, N, wg::BM) ||
      !hl::slice_map_bf16(&wm, w, D, V, wg::BN))
    return cudaErrorInvalidValue;
  static unsigned done = 0;
  cudaError_t err = hl::allow_smem(done, reinterpret_cast<const void*>(wg::ce),
                                   wg::SMEM);
  if (err != cudaSuccess) return err;
  wg::ce<<<grid, 384, wg::SMEM, st>>>(xm, wm, targets, partial, N, V, D,
                                      chunks);
  return cudaGetLastError();
}

}  // namespace

// x (N, D) and w (V, D) both bf16 (bf16 != 0: D a multiple of 64, both
// 16-byte aligned) or both fp32 (D a multiple of 4), contiguous; targets
// (N,) int32; nll, lse (N,) fp32 out; partial (chunks, 3, N) fp32
// scratch. bf16: ``grid`` persistent blocks (at most one an SM); fp32: a
// (row tile, chunk) grid, ``grid`` unused. Returns the launches'
// cudaError_t.
extern "C" int hl_fused_ce(const void* x, const void* w, const int* targets,
                           float* nll, float* lse, float* partial, int N,
                           int V, int D, int chunks, int grid, int bf16_,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_) {
    err = run_wg(x, w, targets, partial, N, V, D, chunks, grid, st);
  } else {
    const dim3 g((N + fp32k::BM - 1) / fp32k::BM, chunks);
    fp32k::ce<<<g, fp32k::THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), targets,
        partial, N, V, D);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_chunks<<<(N + 255) / 256, 256, 0, st>>>(partial, nll, lse, N, chunks);
  return static_cast<int>(cudaGetLastError());
}
