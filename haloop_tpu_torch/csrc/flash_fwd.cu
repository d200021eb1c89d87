// Flash attention forward: blockwise attention with an online softmax,
// with per-batch key lengths and a causal offset (K5) or per-token
// segment ids for packed rows (K7).
//
// Replaces: haloop_tpu/ops/flash.py _flash_kernel / _flash_kernel_lse
// (launched by _flash_forward, entry flash_attention; K5) and
// _flash_seg_kernel (launched by _packed_impl, entry
// flash_attention_packed; K7). Plain versions:
// haloop_tpu_torch/ops/flash.py _reference and _packed_reference.
//
// Computes, for each (n, h) and query row t (absolute position t0 + t):
//   s[t, c] = (q[t] . k[c]) / sqrt(D) in fp32, set to -1e30 where c >=
//   kv_lengths[n], or c > t0 + t (causal), or seg[t] != seg[c] (K7:
//   T == S, t0 == 0, every key valid);
//   o[t] = softmax_c(s[t]) . v in the input dtype, and, when asked,
//   lse[t] = m + log(max(l, 1e-30)) of the running max m and sum l.
// A row whose every column is masked (kv_lengths[n] == 0) gives the
// mean of v over the S real columns, as _reference does (the TPU
// kernel's value there depends on its tiling; see the port's notes).
//
// What bounds it on the H100: at hap --no-pack (N=32, H=12, T=S=512,
// D=64, causal) the causal half of the scores is 3.2 GFLOP of bf16
// products against 75 MB of q, k, v and o: about 1/100 of the card's
// operations-per-byte balance point, so the bound is the bytes (26 us);
// at hala's (8, 12, 1024, 64) with the lse, 18 us. In fp32 every product
// is exact FFMA on the CUDA cores (no TF32: the port's fp32 products run
// with TF32 off, and the --grad-norms rows this mode serves are held to
// the JAX package's): at hala's fp32 (2, 12, 1024, 64) causal 3.3 GFLOP
// against 25 MB, so the fp32 rate (67 TFLOP/s: 49 us) and not the bytes;
// at --grad-norms' (1, 8, 384, 64) non-causal 0.31 GFLOP (4.6 us), under
// a launch's ~5 us floor, where 64-row query tiles number 48 for 132 SMs.
//
// This design (bf16, Hopper): a persistent kernel, at most one block of
// three warpgroups per SM, each block running a contiguous run of work
// items, one item per (n*h, 128-row query tile); items run head by head,
// and when causal each head's query tiles in heavy-light pairs (the last
// with the first, ...), so that blocks get about equal work and a head's
// k and v are re-read from L2 by the same block. Warpgroup 0 is the
// producer: it gives up its registers (setmaxnreg) and one thread of
// warp 0 issues TMA loads, each item's Q tile into one of two Q buffers,
// then each key tile's 128 rows of k and of v into a ring of STAGES
// stages, each half with its own "full" mbarrier and the stage and the Q
// buffer with an "empty" one that the consumers' warps arrive on when
// they are done with it, so the next tiles, and the next item's Q, load
// while this one is computed and written. Warpgroups 1 and 2 are
// consumers, 64 query rows each (setmaxnreg up): S = Q K^T is wgmma
// m64n128k16 with both operands in shared memory (the 128 B swizzle at
// D = 64, 64 B at D = 32; csrc/sm90.cuh), the online softmax runs per row
// in fp32 on the accumulator's fragments, in base 2 (log2(e)/sqrt(D)
// folded into the exponent's multiply-add), and O += P V is wgmma
// m64nDk16 with P in registers: the score fragments rounded to bf16 are
// its A operand, V the transposed (MN-major) B operand. P is rounded
// before the normalization, as in the CUDA-core version. The tensor maps
// are 4-D (D, rows, H, N) over the strided views as they lie (the GPT's
// q, k, v are views of its fused projection); rows past T or S load as
// zeros. Key tiles wholly past kv_lengths[n] or above the causal diagonal
// (with t0) are never loaded (one ``plan`` for producer and consumers),
// and a consumer skips a tile wholly above its own 64 rows' diagonal; in
// K7 the producer lists the key tiles whose segment ids can meet the
// query tile's, loads only those, and stages each one's segment ids in
// shared memory beside it. The elementwise mask runs only on tiles that
// straddle a boundary, as one compare of each column against a per-row
// limit (testing each condition in turn for every score cost the kernel
// more than its exponentials).
//
// This design (fp32, fwd_f32; the tiling of csrc/flash_f32.cuh, shared
// with the fp32 backward): a block of 128 threads owns a 64-row query
// tile, Q resident in shared memory, and streams the 64-key tiles of k
// and v through a 2-stage cp.async ring, the next tile loading while
// this one is computed. Each thread computes a 4 x 8 patch of S = Q K^T
// in one loop from float4 loads of padded rows, the FFMAs of its 32
// independent sums interleaved; the online softmax runs on the patches
// in base 2 (a row's max and sum over its 8 lanes by __shfl_xor_sync,
// log2(e)/sqrt(D) folded into the exponent's multiply-add, the rescale a
// row, the normalization once at the end); P goes to shared memory over
// the k tile it came from, and O += P V runs the same tiling into a 4 x
// D/8 patch of the output. The skip rules are ``plan``'s and, in K7,
// ``seg_tile_live``'s; the mask only on tiles that straddle a row's last
// key. Where the query tiles leave SMs idle, flash_cuda.fwd_f32_plan
// splits each tile's keys into P ranges of whole tiles, a block each
// (``split_range``); each split writes its (m, l, acc) to an fp32
// scratch, and the last split of a tile to arrive (a per-tile counter,
// left 0 for the next call) merges them in split order: m = max m_s, l =
// sum l_s 2^(m_s - m), o = sum acc_s 2^(m_s - m) / max(l, 1e-30). One
// launch a call, no atomics in any sum, the same bits from run to run.
// K7's fp32 mode runs unsplit (its live key tiles depend on the segment
// ids, which the plan does not read).
// Later perf_opt: the two consumers' ping-pong, as FlashAttention-3
// does (issuing the next Q K^T ahead of the softmax alone, without it,
// read 15% slower here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "flash_f32.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

using namespace hl::f32;    // fp32: FT, FTHREADS, Tiles, ...
using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = NEG * LOG2E;     // NEG in base 2: m2 * LN2 == NEG
constexpr int BM = 128;     // bf16: query rows per block
constexpr int BN = 128;     // bf16: keys per tile
constexpr int STAGES = 3;   // bf16: k/v tiles in flight

struct Dims {
  int N, H, T, S, D;
  int q_sn, q_sh, q_st, k_sn, k_sh, k_st, v_sn, v_sh, v_st, o_sn, o_sh, o_st;
};

// The key range a query tile of QT rows must visit, in tiles of KT keys.
struct Plan {
  int kvlen;        // keys >= kvlen are masked
  bool uniform;     // every key masked: the mean of v over S
  int nk;           // key tiles to visit
};

template <int QT, int KT>
__device__ __forceinline__ Plan plan(const Dims& d, const int* kvl,
                                     const int* seg, int n, int q0,
                                     int causal, int t0) {
  Plan p;
  p.kvlen = seg ? d.S : kvl[n];
  p.uniform = p.kvlen <= 0;
  int kend = d.S;
  if (!p.uniform) {
    kend = min(kend, p.kvlen);
    if (causal) kend = min(kend, t0 + min(q0 + QT, d.T));  // <= last row
  }
  p.nk = (max(kend, 0) + KT - 1) / KT;
  return p;
}

// K7: whether key tile [k0, k0 + FT) can hold a segment of the query
// tile (its [min, max] of segment ids meets [qmin, qmax]). Each warp
// reduces the tile's ids itself, so every warp reaches the same answer
// with no barrier.
__device__ __forceinline__ bool seg_tile_live(const int* segn, int S, int k0,
                                              int qmin, int qmax) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int c = k0 + threadIdx.x % 32; c < min(k0 + FT, S); c += 32) {
    lo = min(lo, segn[c]);
    hi = max(hi, segn[c]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  return !(hi < qmin || lo > qmax);
}

// the query tile's segment range (rows < T); ends in a barrier
__device__ __forceinline__ void seg_query_range(const int* segn, int T, int q0,
                                                int* range) {
  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  if (segn && threadIdx.x < FT && q0 + threadIdx.x < T) {
    atomicMin(&range[0], segn[q0 + threadIdx.x]);
    atomicMax(&range[1], segn[q0 + threadIdx.x]);
  }
  __syncthreads();
}

// ------------------------------------------------ bf16, wgmma and TMA

template <int HD>
struct Tile {
  static constexpr int RB = HD * 2;                 // bytes a row
  static constexpr int BYTES = BN * RB;             // a q, k or v tile
  static constexpr int ATOM = 8 * RB;               // 8 swizzled rows
  static constexpr int LAYOUT = RB == 128 ? 1 : 2;  // 128 B or 64 B
  // Q[2] | K[STAGES] | V[STAGES] | barriers | K7: the key tiles' segment
  // ids [STAGES][BN], then per Q buffer a count and a list of key tiles
  static constexpr int K_OFF = 2 * BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * BYTES;
  // qfull[2], qempty[2], kfull, vfull, empty [STAGES]
  static constexpr int NBAR = 4 + 3 * STAGES;
  static constexpr int SEGK_OFF = BAR_OFF + NBAR * 8;
  static constexpr int LIST_OFF = SEGK_OFF + STAGES * BN * 4;
};

// A work item: one (n*h, 128-row query tile). Items run head by head;
// when causal, each head's tiles in heavy-light pairs (the last with the
// first, and so on), so that every pair visits about as many key tiles
__device__ __forceinline__ void item(long long w, int QT, int causal,
                                     int* nh, int* q0) {
  *nh = (int)(w / QT);
  const int j = (int)(w % QT);
  const int qt = !causal ? j : (j % 2 == 0 ? QT - 1 - j / 2 : j / 2);
  *q0 = qt * BM;
}

// K7, the producer warp: the key tiles (of the first nk) whose [min, max]
// of segment ids meets the query tile's, in order, into list -> count
__device__ __forceinline__ int seg_tile_list(const int* segn, const Dims& d,
                                             int q0, int nk, int* list) {
  const int lane = threadIdx.x % 32;
  int qlo = INT_MAX, qhi = INT_MIN;
#pragma unroll
  for (int i = 0; i < BM / 32; ++i) {
    const int r = q0 + lane + 32 * i;
    if (r < d.T) {
      qlo = min(qlo, __ldg(segn + r));
      qhi = max(qhi, __ldg(segn + r));
    }
  }
  qlo = __reduce_min_sync(0xffffffffu, qlo);
  qhi = __reduce_max_sync(0xffffffffu, qhi);
  int cnt = 0;
  for (int base = 0; base < nk; base += 4) {     // 4 tiles' loads at once
    int lo[4], hi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lo[u] = INT_MAX;
      hi[u] = INT_MIN;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int c = (base + u) * BN + lane + 32 * i;
        if (base + u < nk && c < d.S) {
          lo[u] = min(lo[u], __ldg(segn + c));
          hi[u] = max(hi[u], __ldg(segn + c));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lo[u] = __reduce_min_sync(0xffffffffu, lo[u]);
      hi[u] = __reduce_max_sync(0xffffffffu, hi[u]);
      if (base + u < nk && !(hi[u] < qlo || lo[u] > qhi)) {
        if (lane == 0) list[cnt] = base + u;
        ++cnt;
      }
    }
  }
  return cnt;
}

// O += P V for one key tile: P (64 x 128, bf16) in registers, V through
// its transposed descriptor, 16 keys (16 rows of V) a k16 step
template <int HD>
__device__ __forceinline__ void pv(float (&acc)[HD / 2],
                                   const uint32_t (&p)[32], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    if constexpr (HD == 64)
      hl::wgmma_rs_m64n64<1>(acc, a, dv + kk * (16 * HD * 2 >> 4), 1);
    else
      hl::wgmma_rs_m64n32<1>(acc, a, dv + kk * (16 * HD * 2 >> 4), 1);
  }
}

// Persistent: block b runs the items [b I / G, (b + 1) I / G) of the I =
// N H ceil(T / 128) items, G = gridDim.x (at most one block per SM). SEG:
// K7 (seg != null), else K5.
template <int HD, bool SEG>
__global__ void __launch_bounds__(384, 1)
flash_wg(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const int* __restrict__ kvl,
         const int* __restrict__ seg, bf16* __restrict__ o,
         float* __restrict__ lse, Dims d, int causal, int t0, float scale2,
         int lmax) {
  using L = Tile<HD>;
  constexpr int NO = HD / 2;                 // o accumulator registers
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hl::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = hl::smem_u32(smem);
  const uint32_t sk = sq + L::K_OFF, sv = sq + L::V_OFF;
  const uint32_t bar = sq + L::BAR_OFF;
  auto qfull = [&](int b) { return bar + 8 * b; };
  auto qempty = [&](int b) { return bar + 8 * (2 + b); };
  auto kfull = [&](int s) { return bar + 8 * (4 + s); };
  auto vfull = [&](int s) { return bar + 8 * (4 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (4 + 2 * STAGES + s); };
  int* segk = reinterpret_cast<int*>(smem + L::SEGK_OFF);
  int* lists = reinterpret_cast<int*>(smem + L::LIST_OFF);

  const int tid = threadIdx.x;
  const int T = d.T, S = d.S, QT = (T + BM - 1) / BM;
  const long long items = (long long)d.N * d.H * QT;
  const long long w0 = items * blockIdx.x / gridDim.x;
  const long long w1 = items * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      hl::mbar_init(qfull(b), 1);
      hl::mbar_init(qempty(b), 8);           // each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      hl::mbar_init(kfull(s), 1);
      hl::mbar_init(vfull(s), 1);
      hl::mbar_init(empty(s), 8);
    }
    hl::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // ---------------- producer: warp 0, lane 0 issues every load
    hl::setmaxnreg_dec<56>();
    if (tid >= 32) return;
    if (tid == 0) {
      hl::prefetch_map(&qmap);
      hl::prefetch_map(&kmap);
      hl::prefetch_map(&vmap);
    }
    int it = 0, qi = 0;
    for (long long w = w0; w < w1; ++w, ++qi) {
      int nh, q0;
      item(w, QT, causal, &nh, &q0);
      const int n = nh / d.H, h = nh % d.H, qb = qi & 1;
      const Plan pl = plan<BM, BN>(d, kvl, seg, n, q0, causal, t0);
      const int* segn = SEG ? seg + (size_t)n * T : nullptr;
      int* list = lists + qb * (1 + lmax);
      // the list of this buffer is free once its last item released Q
      hl::mbar_wait(qempty(qb), ((qi >> 1) & 1) ^ 1);
      int ntiles = pl.nk;
      if (SEG) {
        ntiles = seg_tile_list(segn, d, q0, pl.nk, list + 1);
        if (tid == 0) list[0] = ntiles;
      }
      if (tid == 0) {            // the arrive publishes the list
        hl::mbar_expect_tx(qfull(qb), L::BYTES);
        hl::tma_load_4d(sq + qb * L::BYTES, &qmap, qfull(qb), 0, q0, h, n);
      }
      for (int i = 0; i < ntiles; ++i, ++it) {
        const int s = it % STAGES;
        hl::mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (SEG ? list[1 + i] : i) * BN;
        if (SEG) {               // the key tile's ids, published by kfull
#pragma unroll
          for (int j = 0; j < BN / 32; ++j) {
            const int cl = tid + 32 * j;
            segk[s * BN + cl] = k0 + cl < S ? __ldg(segn + k0 + cl) : -1;
          }
          __syncwarp();
        }
        if (tid == 0) {
          // a partial last tile still moves the whole box (zeros past S)
          hl::mbar_expect_tx(kfull(s), L::BYTES);
          hl::tma_load_4d(sk + s * L::BYTES, &kmap, kfull(s), 0, k0, h, n);
          hl::mbar_expect_tx(vfull(s), L::BYTES);
          hl::tma_load_4d(sv + s * L::BYTES, &vmap, vfull(s), 0, k0, h, n);
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 query rows each
  hl::setmaxnreg_inc<224>();
  const int c = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  int it = 0, qi = 0;
  for (long long w = w0; w < w1; ++w, ++qi) {
    int nh, q0;
    item(w, QT, causal, &nh, &q0);
    const int n = nh / d.H, h = nh % d.H, qb = qi & 1;
    const Plan pl = plan<BM, BN>(d, kvl, seg, n, q0, causal, t0);
    const int* list = lists + qb * (1 + lmax);
    const int row0 = q0 + c * 64 + warp * 16 + g;   // and row0 + 8
    const int wg_first = q0 + c * 64, wg_last = wg_first + 63;
    // the last column rows row0 and row0 + 8 attend (masked past it; a
    // uniform row, kv_lengths 0, has every column masked), and the least
    // of that over these 64 rows
    int cmax[2], segq[2] = {-1, -1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cmax[r] = min(pl.kvlen, S) - 1;
      if (causal && !pl.uniform) cmax[r] = min(cmax[r], t0 + row0 + 8 * r);
      if (SEG && row0 + 8 * r < T)
        segq[r] = __ldg(seg + (size_t)n * T + row0 + 8 * r);
    }
    int cmax_wg = min(pl.kvlen, S) - 1;
    if (causal && !pl.uniform) cmax_wg = min(cmax_wg, t0 + wg_first);

    float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float s[64];
    uint32_t p[32];                     // P in bf16, the A fragments

    const uint64_t dq = hl::smem_desc(sq + qb * L::BYTES + c * 64 * L::RB,
                                      16, L::ATOM, L::LAYOUT);
    hl::mbar_wait(qfull(qb), (qi >> 1) & 1);
    const int ntiles = SEG ? list[0] : pl.nk;
    auto key0 = [&](int i) { return (SEG ? list[1 + i] : i) * BN; };
    // the tiles these 64 rows use: a tile wholly above their diagonal adds
    // nothing (the tiles run in key order, so those come last)
    int nrun = wg_first < T ? ntiles : 0;
    if (causal && !pl.uniform)
      while (nrun > 0 && key0(nrun - 1) > t0 + wg_last) --nrun;

    // Tile i: S = Q K^T, the softmax, O = O corr + P V; the two
    // consumers' products and softmaxes interleave on the SM (issuing
    // Q K(i+1)^T ahead of tile i's softmax read 15% slower)
    for (int i = 0; i < nrun; ++i) {
      const int st = (it + i) % STAGES, k0 = key0(i);
      hl::mbar_wait(kfull(st), ((it + i) / STAGES) & 1);
      const uint64_t dk = hl::smem_desc(sk + st * L::BYTES, 16, L::ATOM,
                                        L::LAYOUT);
      hl::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)         // 32 bytes a k16 step
        hl::wgmma_ss_m64n128<0>(s, dq + 2 * kk, dk + 2 * kk, kk);
      hl::wgmma_commit();
      hl::wgmma_wait<0>();
      hl::fence_regs(s);

      // mask only a tile where some column can be masked for these rows;
      // elsewhere the scale (base 2) folds into the exponent's
      // multiply-add. Column 8 j + 2 tq + e of the tile is masked past
      // lim[r], and -inf (weight 0) past slim
      float mx[2] = {-INFINITY, -INFINITY};
      float sc = scale2;
      if (SEG || k0 + BN - 1 > cmax_wg) {
        sc = 1.f;
        const int lim[2] = {cmax[0] - k0 - 2 * tq, cmax[1] - k0 - 2 * tq};
        const int slim = S - 1 - k0 - 2 * tq;
        const int* sg = segk + st * BN + 2 * tq;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          int2 sk2 = make_int2(0, 0);
          if (SEG) sk2 = *reinterpret_cast<const int2*>(sg + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, jc = 8 * j + (e & 1);
            float x = s[4 * j + e] * scale2;
            bool masked = jc > lim[r];
            if (SEG) masked |= segq[r] != ((e & 1) ? sk2.y : sk2.x);
            x = masked ? NEG2 : x;
            x = jc > slim ? -INFINITY : x;
            s[4 * j + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        mx[0] *= scale2;
        mx[1] *= scale2;
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        corr[r] = hl::ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 64; ++j) {   // registers 4 jj + {0,1} | {2,3}
        const int r = (j >> 1) & 1;
        s[j] = hl::ex2(fmaf(s[j], sc, -m[r]));
        l[r] += s[j];
      }

#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        p[j] = hl::pack_bf16(s[2 * j], s[2 * j + 1]);
      hl::mbar_wait(vfull(st), ((it + i) / STAGES) & 1);
      hl::wgmma_fence();
      pv<HD>(acc, p, hl::smem_desc(sv + st * L::BYTES, L::ATOM, L::ATOM,
                                   L::LAYOUT));
      hl::wgmma_commit();
      hl::wgmma_wait<0>();
      hl::fence_regs(acc);
      if (lane == 0) hl::mbar_arrive(empty(st));
    }
    for (int i = nrun; i < ntiles; ++i) {          // loaded for the others
      const int st = (it + i) % STAGES;
      const uint32_t ph = ((it + i) / STAGES) & 1;
      hl::mbar_wait(kfull(st), ph);
      hl::mbar_wait(vfull(st), ph);
      if (lane == 0) hl::mbar_arrive(empty(st));
    }
    it += ntiles;
    if (lane == 0) hl::mbar_arrive(qempty(qb));    // Q and the list read
    if (wg_first >= T) continue;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= T) continue;
      const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
      bf16* orow = o + (size_t)n * d.o_sn + (size_t)h * d.o_sh +
                   (size_t)row * d.o_st;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = hl::pack_bf16(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      // a uniform row's m is NEG2: its lse is NEG + log(l), as in fp32
      if (lse && tq == 0)
        lse[(size_t)nh * T + row] =
            (pl.uniform ? NEG : m[r] * LN2) + logf(lc);
    }
  }
}

// ------------------------------------------------ fp32, CUDA cores

// S = A B^T over rows of HD of two tiles (csrc/flash_f32.cuh's layout):
// acc[r][c] += A[ty + 16 r] . B[tx + 8 c], each sum in e's order. A step
// has 32 independent sums, each FFMA 32 behind its sum's last one, the
// next step's loads in flight behind them
template <int HD>
__device__ __forceinline__ void rows_dot(float (&acc)[4][8], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = Tiles<HD>::LD;
#pragma unroll 4
  for (int e = 0; e < HD; e += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * LD + e);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 8 * c) * LD + e);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(comp(a[r], u), comp(b[c], u), acc[r][c]);
  }
}

// the max of a row over its 8 threads (neighbouring lanes)
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// K5 and K7 in fp32. Block b: split s = b % P of the (n*h, 64-row query
// tile) b / P, the query tiles latest first (the causal ones with the
// most keys), the heads within. Q stays in shared memory; the split's
// key tiles (K7: those whose segment ids can meet the query tile's)
// stream through a 2-stage ring of k and v; P takes the place of the k
// tile it came from. With P > 1 each split writes its (m, l, acc) to
// ``part`` and the last of the tile's splits to arrive (``ctr``) merges
// them in split order. m is the running max in base 2 (the scores times
// log2(e)/sqrt(D)), NEG2 for a masked score, -inf past S.
template <int HD, bool SEG>
__global__ void __launch_bounds__(FTHREADS, 2)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int* __restrict__ kvl,
        const int* __restrict__ seg, float* __restrict__ o,
        float* __restrict__ lse, float* part, int* ctr, Dims d, int causal,
        int t0, float scale2, int P) {
  using L = Tiles<HD>;
  constexpr int CW = L::CW, SLOT = FT * HD + 2 * FT;   // a split's partial
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* ring = fsm + L::TILE;                         // [2] (K | V)
  int* segk = reinterpret_cast<int*>(fsm + 5 * L::TILE);   // [2][FT]
  __shared__ int range[2], last;

  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int T = d.T, S = d.S, NH = d.N * d.H, QT = (T + FT - 1) / FT;
  const int s = blockIdx.x % P, w = blockIdx.x / P;
  const int nh = w % NH, qt = QT - 1 - w / NH;
  const int n = nh / d.H, h = nh % d.H, q0 = qt * FT;
  const long long tile = (long long)nh * QT + qt;
  const float* kb = k + (size_t)n * d.k_sn + (size_t)h * d.k_sh;
  const float* vb = v + (size_t)n * d.v_sn + (size_t)h * d.v_sh;
  const int* segn = SEG ? seg + (size_t)n * T : nullptr;
  const Plan pl = plan<FT, FT>(d, kvl, seg, n, q0, causal, t0);
  int k_lo, k_hi;
  split_range(pl.nk, P, s, &k_lo, &k_hi);

  int qmin = 0, qmax = 0;
  if (SEG) {
    seg_query_range(segn, T, q0, range);
    qmin = range[0];
    qmax = range[1];
  }
  // the split's next key tile after kt (K7: the next live one); every
  // warp reaches the same answer
  auto next = [&](int kt) {
    for (++kt; SEG && kt < k_hi; ++kt)
      if (seg_tile_live(segn, S, kt * FT, qmin, qmax)) break;
    return kt;
  };
  auto issue = [&](int kt, int st) {
    float* Ks = ring + st * 2 * L::TILE;
    issue_tile<HD>(Ks, kb, kt * FT, S, d.k_st);
    issue_tile<HD>(Ks + L::TILE, vb, kt * FT, S, d.v_st);
    if (SEG && tid < FT)          // published by the loop's barrier
      segk[st * FT + tid] = kt * FT + tid < S ? __ldg(segn + kt * FT + tid)
                                              : -1;
  };
  issue_tile<HD>(Qs, q + (size_t)n * d.q_sn + (size_t)h * d.q_sh, q0, T,
                 d.q_st);
  int kt = next(k_lo - 1);
  if (kt < k_hi) issue(kt, 0);
  hl::cp_async_commit();

  // the last key each of this thread's rows attends (masked past it; a
  // uniform row, kv_lengths 0, has every key masked), and the least of
  // that over the tile's 64 rows: a key tile past it needs the mask
  const int kvlen = min(pl.kvlen, S);
  int cmax[4], segq[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    cmax[r] = causal && !pl.uniform ? min(kvlen - 1, t0 + row) : kvlen - 1;
    segq[r] = SEG && row < T ? __ldg(segn + row) : -1;
  }
  const int cmax_tile =
      causal && !pl.uniform ? min(kvlen - 1, t0 + q0) : kvlen - 1;

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG2;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < CW; ++u) acc[r][u] = 0.f;
  }

  for (int i = 0; kt < k_hi; ++i) {
    const int st = i & 1, k0 = kt * FT;
    float* Ks = ring + st * 2 * L::TILE;
    float* Vs = Ks + L::TILE;
    hl::cp_async_wait<0>();
    __syncthreads();              // tile i landed; tile i - 1's reads done
    const int kn = next(kt);
    if (kn < k_hi) {              // the next k and v tiles, during this one
      issue(kn, st ^ 1);
      hl::cp_async_commit();
    }
    float sc[4][8] = {};
    rows_dot<HD>(sc, Qs, Ks, ty, tx);                   // Q K^T
    // mask only a tile where some key can be masked for these rows, as
    // one compare against each row's last key; elsewhere the scale folds
    // into the exponent's multiply-add
    float mx[4], sc2 = scale2;
    if (SEG || k0 + FT - 1 > cmax_tile) {
      sc2 = 1.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mx[r] = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = k0 + tx + 8 * c;
          bool masked = col > cmax[r];
          if (SEG) masked |= segq[r] != segk[st * FT + tx + 8 * c];
          float x = masked ? NEG2 : sc[r][c] * scale2;
          x = col >= S ? -INFINITY : x;
          sc[r][c] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mx[r] = sc[r][0];
#pragma unroll
        for (int c = 1; c < 8; ++c) mx[r] = fmaxf(mx[r], sc[r][c]);
        mx[r] *= scale2;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float mn = fmaxf(m[r], row_max(mx[r]));
      const float corr = hl::ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= corr;
#pragma unroll
      for (int u = 0; u < CW; ++u) acc[r][u] *= corr;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sc[r][c] = hl::ex2(fmaf(sc[r][c], sc2, -m[r]));
        l[r] += sc[r][c];
      }
    }
    __syncthreads();              // every read of K done: P takes its place
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        Ks[(ty + 16 * r) * L::SLD + tx + 8 * c] = sc[r][c];
    __syncthreads();
    rows_times<HD>(acc, Ks, Vs, ty, tx);                // O += P V
    kt = kn;
  }
  hl::cp_async_wait<0>();         // nothing in flight at exit (no keys)
#pragma unroll
  for (int r = 0; r < 4; ++r) l[r] = row_sum(l[r]);

  if (P > 1) {
    // this split's partial, then the last split to arrive merges all of
    // them in split order: m = max m_s, l = sum l_s 2^(m_s - m), acc =
    // sum acc_s 2^(m_s - m)
    auto slot = [&](int sp) { return part + (tile * P + sp) * SLOT; };
    float* mine = slot(s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
#pragma unroll
      for (int g = 0; g < CW / 4; ++g)
        *reinterpret_cast<float4*>(mine + row * HD + tx * 4 + 32 * g) =
            make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2],
                        acc[r][4 * g + 3]);
      if (tx == 0) {
        mine[FT * HD + row] = m[r];
        mine[FT * HD + FT + row] = l[r];
      }
    }
    __threadfence();              // the partial, before the count
    __syncthreads();
    if (tid == 0) last = atomicAdd(ctr + tile, 1) == P - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();              // every split's partial is seen
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      float mm = NEG2;
      for (int sp = 0; sp < P; ++sp)
        mm = fmaxf(mm, __ldcg(slot(sp) + FT * HD + row));
      m[r] = mm;
      l[r] = 0.f;
#pragma unroll
      for (int u = 0; u < CW; ++u) acc[r][u] = 0.f;
      for (int sp = 0; sp < P; ++sp) {
        const float* ps = slot(sp);
        const float wgt = hl::ex2(__ldcg(ps + FT * HD + row) - mm);
        l[r] = fmaf(__ldcg(ps + FT * HD + FT + row), wgt, l[r]);
#pragma unroll
        for (int g = 0; g < CW / 4; ++g) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(
              ps + row * HD + tx * 4 + 32 * g));
          acc[r][4 * g] = fmaf(a.x, wgt, acc[r][4 * g]);
          acc[r][4 * g + 1] = fmaf(a.y, wgt, acc[r][4 * g + 1]);
          acc[r][4 * g + 2] = fmaf(a.z, wgt, acc[r][4 * g + 2]);
          acc[r][4 * g + 3] = fmaf(a.w, wgt, acc[r][4 * g + 3]);
        }
      }
    }
    if (tid == 0) ctr[tile] = 0;
  }

  float* ob = o + (size_t)n * d.o_sn + (size_t)h * d.o_sh + tx * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= T) continue;
    const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
#pragma unroll
    for (int g = 0; g < CW / 4; ++g)
      *reinterpret_cast<float4*>(ob + (size_t)row * d.o_st + 32 * g) =
          make_float4(acc[r][4 * g] * inv, acc[r][4 * g + 1] * inv,
                      acc[r][4 * g + 2] * inv, acc[r][4 * g + 3] * inv);
    // in the natural log; a uniform row's m is NEG2: its lse is NEG + log(l)
    if (lse && tx == 0)
      lse[(size_t)nh * T + row] = (pl.uniform ? NEG : m[r] * LN2) + logf(lc);
  }
}

// (N H ceil(T / FT)) query tiles, each in P splits, one block a split
template <int HD, bool SEG>
cudaError_t run_fp32(const Dims& d, const void* q, const void* k,
                     const void* v, const int* kvl, const int* seg, void* o,
                     float* lse, float* part, int* ctr, int causal, int t0,
                     int P, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int smem = 5 * Tiles<HD>::TILE * 4 + 2 * FT * 4;
  cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(fwd_f32<HD, SEG>), smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)d.N * d.H * ((d.T + FT - 1) / FT) * P;
  fwd_f32<HD, SEG><<<(unsigned)blocks, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kvl, seg, static_cast<float*>(o), lse,
      part, ctr, d, causal, t0, LOG2E / sqrtf((float)HD), P);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_bf16(const Dims& d, const void* q, const void* k,
                     const void* v, const int* kvl, const int* seg, void* o,
                     float* lse, int causal, int t0, cudaStream_t stream) {
  using L = Tile<HD>;
  // S == 0 visits no key tile; the maps still need a row
  const int S = max(d.S, 1);
  CUtensorMap qm, km, vm;
  if (!hl::tile_map_bf16(&qm, q, HD, d.T, d.H, d.N, d.q_st, d.q_sh, d.q_sn,
                         BM) ||
      !hl::tile_map_bf16(&km, k, HD, S, d.H, d.N, d.k_st, d.k_sh, d.k_sn,
                         BN) ||
      !hl::tile_map_bf16(&vm, v, HD, S, d.H, d.N, d.v_st, d.v_sh, d.v_sn,
                         BN))
    return cudaErrorInvalidValue;
  const int lmax = (d.S + BN - 1) / BN;
  const int smem = 1024 + L::LIST_OFF + 2 * (1 + lmax) * (int)sizeof(int);
  auto kern = seg ? flash_wg<HD, true> : flash_wg<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms;
  if ((err = hl::sm_count(&sms)) != cudaSuccess) return err;
  const long long items = (long long)d.N * d.H * ((d.T + BM - 1) / BM);
  const int grid = (int)(items < sms ? items : sms);
  kern<<<grid, 384, smem, stream>>>(
      qm, km, vm, kvl, seg, static_cast<bf16*>(o), lse, d, causal, t0,
      LOG2E / sqrtf((float)d.D), lmax);
  return cudaGetLastError();
}

}  // namespace

// q (N, H, T, D), k and v (N, H, S, D), o (N, H, T, D): bf16 (bf16 != 0)
// or fp32, any strides with contiguous, 16-byte-aligned rows (TMA's rule
// for the bf16 kernel's maps: byte strides multiples of 16, under 2^40);
// dims (host) = {N, H, T, S, D, then the (n, h, t) strides of q, k, v and
// o}.
// kv_lengths (N,) int32 for K5, null for K7; seg (N, T) int32 for K7
// (T == S, t0 == 0), else null; lse (N*H, T) fp32 or null. fp32 only
// (bf16 ignores them): ``splits`` (flash_cuda.fwd_f32_plan), and where it
// is over 1 ``part``, [tiles][splits][FT * D + 2 FT] fp32, and ``ctr``,
// an int32 counter a query tile, 0 before the launch and after it. D is
// 32 or 64. Returns the launch's cudaError_t.
extern "C" int hl_flash_fwd(const void* q, const void* k, const void* v,
                            const int* kv_lengths, const int* seg, void* o,
                            float* lse, float* part, int* ctr,
                            const int* dims, int causal, int t0, int bf16_,
                            int splits, void* stream) {
  Dims d;
  int* f = &d.N;
  for (int i = 0; i < 17; ++i) f[i] = dims[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (!bf16_ && splits > 1 && (!part || !ctr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto fp32 = [&](auto kern) {
    return kern(d, q, k, v, kv_lengths, seg, o, lse, part, ctr, causal, t0,
                splits, s);
  };
  cudaError_t err;
  if (d.D == 64)
    err = bf16_ ? run_bf16<64>(d, q, k, v, kv_lengths, seg, o, lse, causal,
                               t0, s)
                : fp32(seg ? &run_fp32<64, true> : &run_fp32<64, false>);
  else if (d.D == 32)
    err = bf16_ ? run_bf16<32>(d, q, k, v, kv_lengths, seg, o, lse, causal,
                               t0, s)
                : fp32(seg ? &run_fp32<32, true> : &run_fp32<32, false>);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
