// RNN-T joint logsumexp over the vocabulary (forward).
//
// Replaces: haloop_tpu/ops/joint_pallas.py _lse_kernel (launched by
// _lse_fwd_impl, entry pairwise_lse), the forward of the fused joint.
// Plain version: haloop_tpu_torch/ops/joint.py pairwise_lse.
//
// Computes lse[n, t, u] = logsumexp_v(f[n, t, v] + g[n, u, v]) for
// f (N, T, V), g (N, U1, V) fp32 -> lse (N, T, U1) fp32, in the factored
// form
//   lse = mf[n, t] + mg[n, u] + log(s[n, t, u]),
//   s   = sum_v e^(f[n, t, v] - mf[n, t]) e^(g[n, u, v] - mg[n, u]),
// mf and mg the row maxima over v: per item an fp32 product (T x V) .
// (V x U1) of the exponentiated rows, N (T + U1) V exponentials where the
// direct form takes N T U1 V. Exact mathematics, but both shifts can
// overshoot where f and g peak at different v: if mf + mg exceeds
// max_v(f + g) by more than ~44 nats every product can underflow. So a cell
// whose s < 2^-64 (or 0) is marked, and recomputed exactly in the same
// launch from f's and g's rows in L2: m = max_v(f + g), then m + log of the
// sum of e^(f + g - m). The threshold leaves V 2^-126 (the most the
// underflowed products can lose) at 2^-42 of s for V <= 2^20. The (N, T,
// U1, V) joint is never written.
//
// What bounds it on the H100: at rnn-transducer:lstm:512's joint (N=16,
// T'=301, U1=25, V=512) it reads f and g once (10.7 MB) and writes 0.5 MB,
// ~3.3 us at 3.35 TB/s, against 123 MFLOP of FMA (~1.8 us at the fp32
// rate) and 2.7 M exponentials: bound by bytes, under the ~5 us of a
// launch. At V = 16384 f alone is 315 MB (~94 us), the FMAs ~59 us.
//
// This design: one block of 8 warps per (item, tile of 32 frames, chunk of
// up to 32 of the U1 rows); lane l of a warp owns frames t0 + l % 16 and
// t0 + l % 16 + 16, and the 16 half-warps split each stage's 64
// vocabulary columns, 4 each. V streams as
// the product's k dimension through a 4-stage ring of shared-memory tiles
// (the stage's f rows and g rows, by cp.async). Each stage:
// - g's rows are exponentiated once for the block: each column's running
//   maximum mg (a block-wide online rescale, K10's idea; a warp's columns'
//   reductions interleaved), the stage's e^(g - mg) stored transposed for
//   the product, and the factor by which the columns' sums shrink where mg
//   grew;
// - each thread exponentiates its own frames' 4 f values once against its
//   own running maxima (rescaling its sums where they grew) and adds the
//   2 x 4 x U1 products into registers, g's values read by broadcast: a
//   shared-memory read feeds 8 FMAs (with one frame a lane it fed 4, and
//   those reads, not the FMAs, set the time: PERF.md).
// The copies a thread issues are the same every stage but for the column:
// their addresses are computed once. The maxima come online, not from a
// prologue pass, so f is read once: at V = 16384 a block's tile of f (2
// MB) would not stay in L2 for a second pass.
// ex2 with log2(e) folded in after the exact difference. At the end the 16
// half-warps' sums of each cell are merged in warp order (their f maxima
// differ), the threshold read, and the marked cells recomputed, one a warp.
// The row maxima mf and mg come out beside lse: the backward K9b
// (csrc/joint_lse_bwd.cu) takes the same factored form.
// Every sum is taken in a fixed order: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using hl::ex2;

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROWS = 32;         // frames a block, one a lane
constexpr int KS = 64;           // vocabulary columns a stage
constexpr int GROUPS = 2 * WARPS; // of them a half-warp's: KG
constexpr int KG = KS / GROUPS;
constexpr int KSP = KS + 4;      // a ring row's stride in floats
constexpr int DEPTH = 4;         // ring stages
constexpr float L2E = 1.4426950408889634f;
constexpr float TINY = 5.421010862427522e-20f;   // 2^-64: the fix-up's mark

// a row of e^(g - mg) in the product's layout: 4 NQ floats, stepped so that
// the lanes' stores hit 8 different banks
__host__ __device__ constexpr int g_stride(int nq) {
  return nq % 2 ? 4 * nq : 4 * nq + 4;
}

struct Layout {
  int ring, eg, mg, sg, moved, marks, bytes;   // byte offsets
};

// the dynamic shared memory (ops/joint_cuda.py plan sizes it; the launcher
// refuses a plan whose size differs):
//   ring  [DEPTH][ROWS + UC][KSP] floats: the stages' f rows, then g rows
//   eg    [2 stage parities][KS][g_stride] floats: a stage's e^(g - mg),
//         k-major; after the sweep the marked cells' list
//   mg    [32] the columns' running maxima
//   sg    [2 stage parities][32] a stage's rescale of the columns' sums
//   moved [2 stage parities][WARPS] bytes: whether a warp's columns' mg grew
//   marks an int: the marked cells
// after the sweep the ring holds the half-warps' sums and f maxima
__host__ __device__ constexpr Layout layout(int nq) {
  const int uc = 4 * nq;
  const int ring = 0;
  const int eg = ring + DEPTH * (ROWS + uc) * KSP * 4;
  const int mg = eg + 2 * KS * g_stride(nq) * 4;
  const int sg = mg + 32 * 4;
  const int moved = sg + 2 * 32 * 4;
  const int marks = moved + 2 * WARPS;
  return Layout{ring, eg, mg, sg, moved, marks, marks + 16};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A thread's copies of a stage's f and g rows into its ring slot: ROWS
// frames from t0 and UC rows of g from u0 (rows past T or U1 repeat the
// last: computed, never stored), the stage's columns that exist. 16-byte
// copies where the rows are 16-byte aligned (VEC): a thread's PER pieces
// are the same every stage but for the column, their addresses computed
// once; else 4-byte ones, from the loop.
template <int NQ, bool VEC>
struct Copies {
  static constexpr int UC = 4 * NQ;
  static constexpr int PIECES = (ROWS + UC) * (KS / 4);
  static constexpr int PER = (PIECES + THREADS - 1) / THREADS;
  const float* src[PER];
  int dst[PER], k[PER];
  const float *fn, *gn;
  int t0, u0, T, U1, V;

  __device__ __forceinline__ const float* row(int r) const {
    return r < ROWS ? fn + (size_t)min(t0 + r, T - 1) * V
                    : gn + (size_t)min(u0 + r - ROWS, U1 - 1) * V;
  }

  __device__ __forceinline__ Copies(const float* fn_, const float* gn_,
                                    int t0_, int u0_, int T_, int U1_,
                                    int V_)
      : fn(fn_), gn(gn_), t0(t0_), u0(u0_), T(T_), U1(U1_), V(V_) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int c = threadIdx.x + m * THREADS;
      const int r = min(c, PIECES - 1) / (KS / 4);
      k[m] = c < PIECES ? 4 * (c % (KS / 4)) : V;   // (V: never copied)
      src[m] = row(r) + k[m] % KS;
      dst[m] = r * KSP + k[m] % KS;
    }
  }

  __device__ __forceinline__ void load(float* slot, int st) const {
    const int k0 = st * KS;
    if (VEC) {
#pragma unroll
      for (int m = 0; m < PER; ++m)
        if (k0 + k[m] < V) cp_async16(slot + dst[m], src[m] + k0);
    } else {
      for (int c = threadIdx.x; c < (ROWS + UC) * KS; c += THREADS) {
        const int r = c / KS, kk = c % KS;
        if (k0 + kk < V) cp_async4(slot + r * KSP + kk, row(r) + k0 + kk);
      }
    }
  }
};

template <int NQ, bool VEC>
__global__ void __launch_bounds__(THREADS)
    joint_lse(const float* __restrict__ f,    // (N, T, V)
              const float* __restrict__ g,    // (N, U1, V)
              float* __restrict__ lse,        // (N, T, U1)
              float* __restrict__ mf_out,     // (N, T)
              float* __restrict__ mg_out,     // (N, U1)
              int T, int U1, int V) {
  constexpr int UC = 4 * NQ, SG = g_stride(NQ);
  constexpr Layout L = layout(NQ);
  extern __shared__ __align__(16) char sm[];
  float* ring = reinterpret_cast<float*>(sm + L.ring);
  float* eg = reinterpret_cast<float*>(sm + L.eg);
  float* mg = reinterpret_cast<float*>(sm + L.mg);
  float* sg = reinterpret_cast<float*>(sm + L.sg);
  unsigned char* moved = reinterpret_cast<unsigned char*>(sm + L.moved);
  int* marks = reinterpret_cast<int*>(sm + L.marks);
  const int n = blockIdx.z, t0 = blockIdx.x * ROWS, u0 = blockIdx.y * UC;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* fn = f + (size_t)n * T * V;
  const float* gn = g + (size_t)n * U1 * V;
  const int stages = (V + KS - 1) / KS;
  const Copies<NQ, VEC> copies(fn, gn, t0, u0, T, U1, V);

  if (threadIdx.x < UC) mg[threadIdx.x] = -CUDART_INF_F;
#pragma unroll
  for (int st = 0; st < DEPTH - 1; ++st) {
    if (st < stages) copies.load(ring + st * (ROWS + UC) * KSP, st);
    commit();
  }

  // Stage st's g rows exponentiated into eg[st % 2]: each warp's columns
  // c = w, w + WARPS, ..., their reductions interleaved (a lane's k =
  // lane, lane + 32, ...), each column's running maximum mg and the
  // rescale of its sums sg, and whether the warp's columns moved.
  auto g_stage = [&](int st) {
    constexpr int CPW = (UC + WARPS - 1) / WARPS, XS = KS / 32;
    const float* slot = ring + (st % DEPTH) * (ROWS + UC) * KSP;
    const int valid = V - st * KS;
    float* egs = eg + (st & 1) * KS * SG;
    float x[CPW][XS], m[CPW], old[CPW];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const float* row = slot + (ROWS + min(w + WARPS * q, UC - 1)) * KSP;
      m[q] = -CUDART_INF_F;
#pragma unroll
      for (int h = 0; h < XS; ++h) {
        x[q][h] = lane + 32 * h < valid ? row[lane + 32 * h] : -CUDART_INF_F;
        m[q] = fmaxf(m[q], x[q][h]);
      }
      old[q] = mg[min(w + WARPS * q, UC - 1)];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < CPW; ++q)
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
    bool grew = false;
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = w + WARPS * q;
      if (c >= UC) continue;
      const float mm = fmaxf(old[q], m[q]);
#pragma unroll
      for (int h = 0; h < XS; ++h)
        egs[(lane + 32 * h) * SG + c] = ex2((x[q][h] - mm) * L2E);
      grew |= mm > old[q];
      if (lane == 0) {
        sg[(st & 1) * 32 + c] = ex2((old[q] - mm) * L2E);
        mg[c] = mm;
      }
    }
    if (lane == 0) moved[(st & 1) * WARPS + w] = grew;
  };

  wait_groups<DEPTH - 2>();
  __syncthreads();   // stage 0 landed
  g_stage(0);

  // this thread's frames r and r + 16; its half-warp hw's KG columns of
  // each stage
  const int r = lane & 15, hw = 2 * w + (lane >> 4);
  float acc[2][UC];
#pragma unroll
  for (int c = 0; c < UC; ++c) acc[0][c] = acc[1][c] = 0.f;
  float mf[2] = {-CUDART_INF_F, -CUDART_INF_F};   // its frames' maxima
  // A stage: g of stage st + 1 beside the product of stage st, one barrier
  // between stages (g's latency hidden behind the other warps' FMAs)
  for (int st = 0; st < stages; ++st) {
    wait_groups<DEPTH - 3>();
    // stage st + 1 landed; stage st's g done; stage st - 1's readers done
    __syncthreads();
    if (st + DEPTH - 1 < stages)
      copies.load(ring + ((st + DEPTH - 1) % DEPTH) * (ROWS + UC) * KSP,
                  st + DEPTH - 1);
    commit();
    if (st + 1 < stages) g_stage(st + 1);

    const float* slot = ring + (st % DEPTH) * (ROWS + UC) * KSP;
    const int valid = V - st * KS;   // columns of this stage that exist
    const float* egs = eg + (st & 1) * KS * SG;
    const float* sgs = sg + (st & 1) * 32;
    // f: this thread's frames at its KG columns
    float e[2][KG];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float4 v = *reinterpret_cast<const float4*>(
          slot + (r + 16 * x) * KSP + KG * hw);
      e[x][0] = v.x;
      e[x][1] = v.y;
      e[x][2] = v.z;
      e[x][3] = v.w;
    }
    if (valid < KS) {
#pragma unroll
      for (int j = 0; j < KG; ++j)
        if (KG * hw + j >= valid) e[0][j] = e[1][j] = -CUDART_INF_F;
    }
    const bool mg_moved =
        *reinterpret_cast<const unsigned long long*>(moved + (st & 1) * WARPS);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float m = e[x][0];
#pragma unroll
      for (int j = 1; j < KG; ++j) m = fmaxf(m, e[x][j]);
      if (m > mf[x]) {
        const float rs = ex2((mf[x] - m) * L2E);
#pragma unroll
        for (int c = 0; c < UC; ++c) acc[x][c] *= rs;
        mf[x] = m;
      }
      if (mg_moved) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 rs = *reinterpret_cast<const float4*>(sgs + 4 * q);
          acc[x][4 * q] *= rs.x;
          acc[x][4 * q + 1] *= rs.y;
          acc[x][4 * q + 2] *= rs.z;
          acc[x][4 * q + 3] *= rs.w;
        }
      }
      // a thread with no column yet (all -inf) adds nothing
      const float base = mf[x] == -CUDART_INF_F ? 0.f : mf[x];
#pragma unroll
      for (int j = 0; j < KG; ++j) e[x][j] = ex2((e[x][j] - base) * L2E);
    }
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const float* er = egs + (KG * hw + j) * SG;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(er + 4 * q);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          acc[x][4 * q] = fmaf(e[x][j], y.x, acc[x][4 * q]);
          acc[x][4 * q + 1] = fmaf(e[x][j], y.y, acc[x][4 * q + 1]);
          acc[x][4 * q + 2] = fmaf(e[x][j], y.z, acc[x][4 * q + 2]);
          acc[x][4 * q + 3] = fmaf(e[x][j], y.w, acc[x][4 * q + 3]);
        }
      }
    }
  }
  wait_groups<0>();
  __syncthreads();

  // the half-warps' sums and f maxima, merged in their order
  constexpr int CS = UC + 1;             // a sums row's stride
  float* sums = ring;                    // [GROUPS][ROWS][CS]
  float* maxes = ring + GROUPS * ROWS * CS;
  static_assert((GROUPS * ROWS * CS + GROUPS * ROWS) * 4 <= L.eg - L.ring,
                "the merge fits in the ring");
  int* marked = reinterpret_cast<int*>(eg);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int c = 0; c < UC; ++c)
      sums[(hw * ROWS + r + 16 * x) * CS + c] = acc[x][c];
    maxes[hw * ROWS + r + 16 * x] = mf[x];
  }
  if (threadIdx.x == 0) *marks = 0;
  __syncthreads();
  const int t = t0 + lane;
  float fmax = maxes[lane];
#pragma unroll
  for (int x = 1; x < GROUPS; ++x) fmax = fmaxf(fmax, maxes[x * ROWS + lane]);
  // the row maxima, for K9b: f's by the first chunk's blocks, g's by the
  // first frame tile's
  if (blockIdx.y == 0 && w == 0 && t < T)
    mf_out[(size_t)n * T + t] = fmax;
  if (blockIdx.x == 0 && threadIdx.x < UC && u0 + threadIdx.x < U1)
    mg_out[(size_t)n * U1 + u0 + threadIdx.x] = mg[threadIdx.x];
  float scale[GROUPS];
#pragma unroll
  for (int x = 0; x < GROUPS; ++x)
    scale[x] = ex2((maxes[x * ROWS + lane] - fmax) * L2E);
  float* out = lse + ((size_t)n * T + t) * U1;
  for (int c = w; c < UC; c += WARPS) {
    float s = 0.f;
#pragma unroll
    for (int x = 0; x < GROUPS; ++x)
      s = fmaf(sums[(x * ROWS + lane) * CS + c], scale[x], s);
    const int u = u0 + c;
    if (t >= T || u >= U1) continue;
    if (s >= TINY)
      out[u] = fmax + mg[c] + logf(s);
    else
      marked[atomicAdd(marks, 1)] = lane * UC + c;
  }
  __syncthreads();

  // the marked cells, one a warp: max_v(f + g), then the sum of exps
  const int nm = *marks;
  for (int i = w; i < nm; i += WARPS) {
    const int row = marked[i] / UC, c = marked[i] % UC;
    const float* fr = fn + (size_t)(t0 + row) * V;
    const float* gr = gn + (size_t)(u0 + c) * V;
    float m = -CUDART_INF_F;
    for (int v = lane; v < V; v += 32) m = fmaxf(m, fr[v] + gr[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < V; v += 32) s += expf(fr[v] + gr[v] - m);
    s = warp_sum(s);
    if (lane == 0) lse[((size_t)n * T + t0 + row) * U1 + u0 + c] = m + logf(s);
  }
}

template <int NQ, bool VEC>
cudaError_t launch(const float* f, const float* g, float* lse, float* mf,
                   float* mg, int N, int T, int U1, int V, int chunks,
                   cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int bytes = layout(NQ).bytes;
  cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(joint_lse<NQ, VEC>), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + ROWS - 1) / ROWS, chunks, N);
  joint_lse<NQ, VEC><<<grid, THREADS, bytes, stream>>>(f, g, lse, mf, mg, T,
                                                        U1, V);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_nq(int nq, const float* f, const float* g, float* lse,
                      float* mf, float* mg, int N, int T, int U1, int V,
                      int chunks, cudaStream_t s) {
  switch (nq) {
    case 1:
      return launch<1, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 2:
      return launch<2, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 3:
      return launch<3, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 4:
      return launch<4, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 5:
      return launch<5, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 6:
      return launch<6, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 7:
      return launch<7, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    case 8:
      return launch<8, VEC>(f, g, lse, mf, mg, N, T, U1, V, chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// f (N, T, V), g (N, U1, V) fp32 contiguous; lse (N, T, U1) fp32
// receives the joint's logsumexp, and mf (N, T), mg (N, U1) fp32 the row
// maxima of f and g over v (K9b takes them). The plan (ops/joint_cuda.py
// plan): nq, the float4 groups of a chunk of g's rows (a chunk is 4 nq rows,
// 1 <= nq <= 8), chunks of them, smem the block's shared-memory bytes, vec
// whether f's and g's rows are 16-byte aligned (V % 4 == 0 and aligned
// pointers).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a plan that
// does not fit the shapes).
extern "C" int hl_joint_lse(const void* f, const void* g, void* lse, void* mf,
                            void* mg, int N, int T, int U1, int V, int nq,
                            int chunks, int smem, int vec, void* stream) {
  if (N <= 0 || T <= 0 || U1 <= 0 || V <= 0 || nq < 1 || nq > 8 ||
      chunks != (U1 + 4 * nq - 1) / (4 * nq) || smem != layout(nq).bytes ||
      (vec && V % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fp = static_cast<const float*>(f);
  const auto gp = static_cast<const float*>(g);
  const auto lp = static_cast<float*>(lse);
  const auto xp = static_cast<float*>(mf);
  const auto yp = static_cast<float*>(mg);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_nq<true>(nq, fp, gp, lp, xp, yp, N, T, U1, V, chunks, s)
          : launch_nq<false>(nq, fp, gp, lp, xp, yp, N, T, U1, V, chunks, s);
  return static_cast<int>(err);
}
