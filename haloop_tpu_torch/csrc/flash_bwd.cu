// Flash attention backward: dq (K6a) and dk, dv (K6b) from q, k, v, the
// forward's o and row lse, and the output gradient do, with per-batch key
// lengths and a causal offset.
//
// Replaces: haloop_tpu/ops/flash.py _flash_bwd_dq_kernel (K6a) and
// _flash_bwd_dkv_kernel (K6b), both launched by _flash_backward (the
// custom VJP of flash_attention). Plain version:
// haloop_tpu_torch/ops/flash.py _backward_reference.
//
// Computes, for each (n, h), query row t (absolute position t0 + t) and
// key c, with scale = 1/sqrt(D):
//   masked(t, c) = c >= kv_lengths[n] or (causal and c > t0 + t);
//   p = exp(q[t] . k[c] * scale - lse[t]), 0 where masked;
//   delta[t] = rowsum(do[t] * o[t]); ds = p * (do[t] . v[c] - delta[t]);
//   dq[t] = sum_c bf16(ds) k[c] * scale          (K6a)
//   dv[c] = sum_t bf16(p) do[t],
//   dk[c] = sum_t bf16(ds) q[t] * scale          (K6b)
// with every product summed in fp32 and the operands rounded where the
// TPU kernels round them (ds to k's and q's dtype, p to do's). A row
// whose every column is masked (kv_lengths[n] == 0) gets zero gradients,
// as on the TPU. delta is K6a's prologue: K6a computes it for its rows and
// writes it out with lse log2(e), and K6b, launched after K6a on the same
// stream, reads both (the JAX package leaves delta to XLA, outside its
// kernels).
//
// What bounds it on the H100: at hala's shape (N=8, H=12, T=S=1024,
// D=64, causal) the causal half of the pairs is 19 GFLOP of bf16 products
// in K6a and 26 in K6b, with ~0.3 G fp32 operations each (exp, mask,
// delta), against 79 MB of q, k, v, o, do and the outputs (0.0235 ms at
// 3.35 TB/s): near the card's operations-per-byte balance point, and by
// chip_smoke.k6_bound the operations bound both, 0.0241 ms for K6a and
// 0.0306 for K6b. What stands between a kernel and that bound is keeping
// the tensor cores fed while the exponentials and the masks run, and
// reading each operand tile from L2 as few times as the split into two
// kernels allows.
//
// This design (bf16, Hopper): the forward's skeleton (flash_fwd.cu,
// flash_wg), twice. Each kernel is persistent, at most one block of three
// warpgroups per SM, each block running a contiguous run of work items
// that go head by head, causal heads' tiles in heavy-light pairs.
// Warpgroup 0 is the producer: it gives up its registers (setmaxnreg) and
// one thread issues every TMA load into shared memory, each tile's bytes
// completing on a "full" mbarrier; the consumers' warps arrive on an
// "empty" one when done, so the next tiles load while this one is
// computed. Warpgroups 1 and 2 are consumers, 64 rows of the item's
// output tile each. The tensor maps are 4-D (D, rows, H, N) over the
// strided views as they lie (the GPT's q, k, v are views of its fused
// projection, do a head-split view of c_proj's input gradient), swizzled
// (128 B at D = 64, 64 B at D = 32; csrc/sm90.cuh); rows past T or S load
// as zeros.
//   K6a: one item per (n*h, 128-row query tile). Per item the producer
//     loads the Q, dO and O tiles into one of two buffers, then 128-key k
//     and v tiles into a ring of A_STAGES stages, skipping the tiles past
//     kv_lengths[n] or above the causal diagonal (t0 included; one
//     ``key_end`` for producer and consumers). A consumer first sums
//     delta = rowsum(dO O) for its rows from the two swizzled tiles (a
//     swizzle moves 16-byte chunks within a row, so one offset addresses
//     the same element in both) and writes lse log2(e) and delta to the
//     scratch. Per key tile: S = Q K^T and dP = dO V^T by wgmma m64n128k16
//     (both operands in shared memory, K-major), P = 2^(S log2(e)/sqrt(D)
//     - lse log2(e)) and dS = P (dP - delta) on the accumulators'
//     fragments, dS rounded to bf16 in pairs and fed from registers to
//     dQ += dS K, wgmma m64nDk16 with K the transposed (MN-major) B
//     operand, as V is in the forward's P V. A consumer skips a tile
//     wholly above its own rows' diagonal.
//   K6b: one item per (n*h, 128-key tile). Its k and v tiles load once
//     into one of two buffers; the ring of B_STAGES stages carries 64-row
//     query tiles of q and do with their slices of lse log2(e) and delta
//     (one 2-D TMA box from the scratch), from the first query tile that
//     can see the key tile (the TPU kernel's q_index clamp) to the last;
//     an item whose key tile starts at or past kv_lengths[n] writes zeros
//     and loads nothing. With the keys on the wgmma M side, S^T = K Q^T
//     and dP^T = V dO^T are wgmma m64n64k16 with Q and dO K-major, then
//     dV += P^T dO and dK += dS^T Q take P^T and dS^T from registers and
//     read the same Q and dO tiles again as the MN-major B operand,
//     through a second descriptor. Query columns past T hold zeros in q,
//     do, lse and delta, so their p is 1 and their ds and dO rows 0: they
//     add nothing. A consumer skips a query tile wholly below its rows'
//     diagonal.
// The elementwise mask runs only on tiles that straddle a boundary, as one
// compare of each element against a per-row limit (the last live key of
// a query row in K6a, the first live query of a key row in K6b). No
// block adds into another's output: no atomics, every sum in a fixed
// order, the gradients the same bits from run to run. The scratch of lse
// log2(e) and delta is (N*H, 2, Tp) fp32, Tp = T rounded up to 4, so that
// its rows meet TMA's 16-byte stride rule at any T.
//
// fp32 (bwd_dq_f32, bwd_dkv_f32). Every product and sum is exact fp32 on
// the CUDA cores (FFMA): no TF32 in any form, not even a 3xTF32 split,
// since the port's fp32 products run with TF32 off and the --grad-norms
// rows this mode serves are held to the JAX package's. What bounds them:
// at --grad-norms' (1, 8, 384, 64) non-causal, 453 MFLOP (K6a, three
// products a pair) and 604 (K6b, four) against 4.7 MB, so the fp32 rate
// (67 TFLOP/s: 6.9 and 9.1 us) and not the bytes; the card fills only
// if each block keeps its FFMA pipes busy and there are blocks for all
// 132 SMs. So each block owns a 64-row output tile (K6a: 64 query rows,
// Q and dO resident; K6b: 64 keys, K and V resident) with 128 threads,
// and streams the other side's 64-row tiles (K6a: k and v through a
// 2-stage cp.async ring, the next tile loading while this one is
// computed; K6b: q, do and their lse and delta, one tile at a time, two
// blocks an SM covering each other's loads). Tiles lie in shared memory
// row-major with padded rows, so a thread's 4 x 8 patch of S = Q K^T and
// dP = dO V^T (K6b: S^T = K Q^T, dP^T = V dO^T) reads its operands as
// float4 with no bank conflict: 12 loads of 16 bytes a 128 FFMA,
// SGEMM-style register tiling, the two products in one loop so that a
// step has 64 independent sums. On an H100 the FFMA pipes run at ~42% of
// their peak this way (scripts/flash_fwd_probe.py --clocks), with one or
// two blocks an SM alike.
// P and dS are computed on the patch, written to shared memory (K6a: dS
// over the stage's V, which dP has read; K6b: P^T and dS^T tiles), and
// dQ += dS K (K6b: dV += P^T dO, dK += dS^T Q) runs the same tiling into
// each thread's 4 x D/8 patch of the output. The causal and key-length
// skips are the bf16 kernels': ``key_end`` bounds K6a's key tiles,
// ``first_query_tile`` K6b's query tiles, a key tile at or past
// kv_lengths[n] has none, and the mask runs only on tiles that straddle
// a boundary. At small N H the tiles alone leave most SMs idle (48 tiles
// at (1, 8, 384, 64)), so flash_cuda.bwd_f32_plan splits the reduction
// (keys for K6a, queries for K6b) into P ranges of whole tiles, a block
// each, each output tile's live tiles shared out evenly (``split_range``,
// so causal splits balance by live tiles); P is 1 where the tiles fill
// the card. Each split writes its sums to an fp32 scratch; the last split
// of a tile to finish, found by a per-tile arrival counter (K12's
// pattern), adds them in split order, writes the output and sets the
// counter back to 0: one launch a kernel call, no atomics in any sum, the
// same bits from run to run. K6a's blocks run the latest query tiles
// first and K6b's the earliest key tiles (causal: the ones with the most
// work). delta is (N*H, T) fp32, written by K6a's split 0.
// Later perf_opt: one pass for dq, dk and dv with a fixed-order dq
// reduction; the consumers' ping-pong.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_f32.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
using namespace hl::f32;      // fp32: FT, FTHREADS, Tiles, ...
constexpr int BM = 128;       // bf16: K6a's query rows an item, K6b's keys
constexpr int BN = 128;       // bf16: K6a's keys a tile
constexpr int BT = 64;        // bf16: K6b's query rows a tile
constexpr int A_STAGES = 3;   // K6a: k/v tiles in flight
constexpr int B_STAGES = 4;   // K6b: q/do tiles in flight
constexpr int NDIMS = 29;

struct Dims {
  int N, H, T, S, D;
  // (n, h, t) strides of q, k, v, o, do, dq, dk, dv
  int q_sn, q_sh, q_st, k_sn, k_sh, k_st, v_sn, v_sh, v_st;
  int o_sn, o_sh, o_st, do_sn, do_sh, do_st;
  int dq_sn, dq_sh, dq_st, dk_sn, dk_sh, dk_st, dv_sn, dv_sh, dv_st;
};

// the keys a query tile of QT rows starting at q0 must visit: [0, kend)
template <int QT = FT>
__device__ __forceinline__ int key_end(int kvlen, int causal, int t0, int q0) {
  int kend = kvlen;
  if (causal) kend = min(kend, t0 + q0 + QT);   // keys <= the last row
  return max(kend, 0);
}

// the first query tile (of QT rows) that can see key k0
template <int QT = FT>
__device__ __forceinline__ int first_query_tile(int causal, int t0, int k0) {
  return causal ? max(k0 - t0, 0) / QT : 0;
}

// ------------------------------------------------ bf16, wgmma and TMA

// a bf16 row of HD as TMA swizzles it and wgmma reads it
template <int HD>
struct Rows {
  static constexpr int RB = HD * 2;                 // bytes a row
  static constexpr int ATOM = 8 * RB;               // 8 swizzled rows
  static constexpr int LAYOUT = RB == 128 ? 1 : 2;  // 128 B or 64 B
  static constexpr int KSTEP_T = 16 * RB >> 4;      // MN-major k16 step
};

// K6a: Q[2] | dO[2] | O[2] | K[A_STAGES] | V[A_STAGES] (128-row tiles) |
// qfull[2], qempty[2], kfull, vfull, empty [A_STAGES]
template <int HD>
struct DqSmem : Rows<HD> {
  static constexpr int BYTES = BM * Rows<HD>::RB;
  static constexpr int DO_OFF = 2 * BYTES, O_OFF = 4 * BYTES;
  static constexpr int K_OFF = 6 * BYTES;
  static constexpr int V_OFF = K_OFF + A_STAGES * BYTES;
  static constexpr int BAR_OFF = V_OFF + A_STAGES * BYTES;
  static constexpr int SIZE = 1024 + BAR_OFF + (4 + 3 * A_STAGES) * 8;
};

// K6b: K[2] | V[2] (128-row tiles) | Q[B_STAGES] | dO[B_STAGES] (64-row
// tiles) | [B_STAGES][2][BT] fp32 lse log2(e), delta | kvfull[2],
// kvempty[2], full, empty [B_STAGES]
template <int HD>
struct DkvSmem : Rows<HD> {
  static constexpr int KBYTES = BM * Rows<HD>::RB;
  static constexpr int QBYTES = BT * Rows<HD>::RB;
  static constexpr int LBYTES = 2 * BT * 4;
  static constexpr int V_OFF = 2 * KBYTES, Q_OFF = 4 * KBYTES;
  static constexpr int DO_OFF = Q_OFF + B_STAGES * QBYTES;
  static constexpr int L_OFF = DO_OFF + B_STAGES * QBYTES;
  static constexpr int BAR_OFF = L_OFF + B_STAGES * LBYTES;
  static constexpr int SIZE = 1024 + BAR_OFF + (4 + 2 * B_STAGES) * 8;
};

// A work item: (n*h, tile of NT). Items run head by head; when causal,
// each head's tiles in heavy-light pairs, the heavy one first: the late
// query tiles in K6a (``late``), the early key tiles in K6b
__device__ __forceinline__ void item(long long w, int NT, int causal,
                                     bool late, int* nh, int* tile) {
  *nh = (int)(w / NT);
  const int j = (int)(w % NT), a = j / 2;
  const int heavy = late ? NT - 1 - a : a, light = late ? a : NT - 1 - a;
  *tile = !causal ? j : (j % 2 == 0 ? heavy : light);
}

// K6a: the key tiles (of BN) the query tile at q0 visits
__device__ __forceinline__ int dq_tiles(const Dims& d, const int* kvl, int n,
                                        int q0, int causal, int t0) {
  return (key_end<BM>(min(kvl[n], d.S), causal, t0, q0) + BN - 1) / BN;
}

// K6b: the query tiles (of BT) the key tile at k0 visits, from *qt0; none
// when it starts at or past kv_lengths[n] (its rows' gradients are 0)
__device__ __forceinline__ int dkv_tiles(const Dims& d, const int* kvl, int n,
                                         int k0, int causal, int t0,
                                         int* qt0) {
  *qt0 = first_query_tile<BT>(causal, t0, k0);
  const int nq = (d.T + BT - 1) / BT;
  return k0 < min(kvl[n], d.S) ? max(nq - *qt0, 0) : 0;
}

// K6b: the first query that key row ``row`` attends (before it: masked);
// a row at or past kv_lengths[n] attends none
__device__ __forceinline__ int first_query(int row, int kvlen, int causal,
                                           int t0) {
  return row >= kvlen ? 1 << 30 : causal ? max(row - t0, 0) : 0;
}

// sum of the products of two 16-byte chunks of 8 bf16
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// rows ``row0`` and ``row0 + 8`` of an m64nHD accumulator, times ``mul``,
// as bf16 into rows of stride st (rows >= limit skipped)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, int st, int row0,
                                           int limit, int tq,
                                           const float (&acc)[HD / 2],
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    bf16* out = dst + (size_t)row * st;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + tq * 2) = hl::pack_bf16(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// acc (m64nHD) += A (64 x 16 k16 steps from registers a) . B (an MN-major
// tile of rows along k at desc bt), KS k16 steps
template <int HD, int KS>
__device__ __forceinline__ void rs_steps(float (&acc)[HD / 2],
                                         const uint32_t (&a)[4 * KS],
                                         uint64_t bt) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    if constexpr (HD == 64)
      hl::wgmma_rs_m64n64<1>(acc, f, bt + kk * Rows<HD>::KSTEP_T, 1);
    else
      hl::wgmma_rs_m64n32<1>(acc, f, bt + kk * Rows<HD>::KSTEP_T, 1);
  }
}

// K6a. Persistent: block b runs the items [b I / G, (b + 1) I / G) of the
// I = N H ceil(T / 128) items, G = gridDim.x (at most one block per SM).
// ld: the (N*H, 2, ldp) scratch, lse log2(e) then delta
template <int HD>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                const __grid_constant__ CUtensorMap domap,
                const int* __restrict__ kvl, const float* __restrict__ lse,
                float* __restrict__ ld, bf16* __restrict__ dq, Dims d,
                int causal, int t0, float scale2, float scale, int ldp) {
  using L = DqSmem<HD>;
  constexpr int NO = HD / 2;                  // dq accumulator registers
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hl::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = hl::smem_u32(smem);
  const uint32_t sdo = sq + L::DO_OFF, so = sq + L::O_OFF;
  const uint32_t sk = sq + L::K_OFF, sv = sq + L::V_OFF;
  const uint32_t bar = sq + L::BAR_OFF;
  auto qfull = [&](int b) { return bar + 8 * b; };
  auto qempty = [&](int b) { return bar + 8 * (2 + b); };
  auto kfull = [&](int s) { return bar + 8 * (4 + s); };
  auto vfull = [&](int s) { return bar + 8 * (4 + A_STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (4 + 2 * A_STAGES + s); };

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
    for (int s = 0; s < A_STAGES; ++s) {
      hl::mbar_init(kfull(s), 1);
      hl::mbar_init(vfull(s), 1);
      hl::mbar_init(empty(s), 8);
    }
    hl::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // ---------------- producer: thread 0 issues every load
    hl::setmaxnreg_dec<56>();
    if (tid != 0) return;
    hl::prefetch_map(&qmap);
    hl::prefetch_map(&kmap);
    hl::prefetch_map(&vmap);
    hl::prefetch_map(&omap);
    hl::prefetch_map(&domap);
    int it = 0, qi = 0;
    for (long long w = w0; w < w1; ++w, ++qi) {
      int nh, qt;
      item(w, QT, causal, true, &nh, &qt);
      const int q0 = qt * BM, n = nh / d.H, h = nh % d.H, qb = qi & 1;
      const int nk = dq_tiles(d, kvl, n, q0, causal, t0);
      hl::mbar_wait(qempty(qb), ((qi >> 1) & 1) ^ 1);
      hl::mbar_expect_tx(qfull(qb), 3 * L::BYTES);
      hl::tma_load_4d(sq + qb * L::BYTES, &qmap, qfull(qb), 0, q0, h, n);
      hl::tma_load_4d(sdo + qb * L::BYTES, &domap, qfull(qb), 0, q0, h, n);
      hl::tma_load_4d(so + qb * L::BYTES, &omap, qfull(qb), 0, q0, h, n);
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % A_STAGES;
        hl::mbar_wait(empty(s), ((it / A_STAGES) & 1) ^ 1);
        // a partial last tile still moves the whole box (zeros past S)
        hl::mbar_expect_tx(kfull(s), L::BYTES);
        hl::tma_load_4d(sk + s * L::BYTES, &kmap, kfull(s), 0, i * BN, h, n);
        hl::mbar_expect_tx(vfull(s), L::BYTES);
        hl::tma_load_4d(sv + s * L::BYTES, &vmap, vfull(s), 0, i * BN, h, n);
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
    int nh, qt;
    item(w, QT, causal, true, &nh, &qt);
    const int q0 = qt * BM, n = nh / d.H, h = nh % d.H, qb = qi & 1;
    const int nk = dq_tiles(d, kvl, n, q0, causal, t0);
    const int kvlen = min(kvl[n], S);
    const int tr = c * 64 + warp * 16 + g;      // tile rows tr, tr + 8
    const int row0 = q0 + tr;
    const int wg_first = q0 + c * 64, wg_last = wg_first + 63;
    // the last key rows row0 and row0 + 8 attend (masked past it), and the
    // least of that over these 64 rows; lse in base 2
    int cmax[2];
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      cmax[r] = kvlen - 1;
      if (causal) cmax[r] = min(cmax[r], t0 + row);
      lse2[r] = row < T ? lse[(size_t)nh * T + row] * LOG2E : 0.f;
    }
    int cmax_wg = kvlen - 1;
    if (causal) cmax_wg = min(cmax_wg, t0 + wg_first);

    hl::mbar_wait(qfull(qb), (qi >> 1) & 1);
    {
      // delta = rowsum(dO O): a swizzle moves 16-byte chunks within a row,
      // so one offset in the two tiles holds the same element; the four
      // lanes of a row group each sum a quarter of the row
      constexpr int CH = HD / 32;             // 16-byte chunks a lane
      const unsigned char* dot = smem + L::DO_OFF + qb * L::BYTES;
      const unsigned char* ot = smem + L::O_OFF + qb * L::BYTES;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int off = (tr + 8 * r) * L::RB + (tq * CH + u) * 16;
          acc = dot8(*reinterpret_cast<const uint4*>(dot + off),
                     *reinterpret_cast<const uint4*>(ot + off), acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        dl[r] = acc;
        const int row = row0 + 8 * r;
        if (tq == 0 && row < T) {
          ld[(size_t)nh * 2 * ldp + row] = lse2[r];
          ld[((size_t)nh * 2 + 1) * ldp + row] = acc;
        }
      }
    }

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    const uint64_t dqa = hl::smem_desc(sq + qb * L::BYTES + c * 64 * L::RB,
                                       16, L::ATOM, L::LAYOUT);
    const uint64_t doa = hl::smem_desc(sdo + qb * L::BYTES + c * 64 * L::RB,
                                       16, L::ATOM, L::LAYOUT);
    // the tiles these 64 rows use: a tile wholly above their diagonal adds
    // nothing (the tiles run in key order, so those come last)
    int nrun = wg_first < T ? nk : 0;
    if (causal)
      while (nrun > 0 && (nrun - 1) * BN > t0 + wg_last) --nrun;

    for (int i = 0; i < nrun; ++i) {
      const int st = (it + i) % A_STAGES, k0 = i * BN;
      const uint32_t ph = ((it + i) / A_STAGES) & 1;
      const uint32_t kt = sk + st * L::BYTES, vt = sv + st * L::BYTES;
      const uint64_t kb = hl::smem_desc(kt, 16, L::ATOM, L::LAYOUT);
      const uint64_t vb = hl::smem_desc(vt, 16, L::ATOM, L::LAYOUT);
      float s[64], dp[64];
      hl::mbar_wait(kfull(st), ph);
      hl::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)         // 32 bytes a k16 step
        hl::wgmma_ss_m64n128<0>(s, dqa + 2 * kk, kb + 2 * kk, kk);
      hl::mbar_wait(vfull(st), ph);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hl::wgmma_ss_m64n128<0>(dp, doa + 2 * kk, vb + 2 * kk, kk);
      hl::wgmma_commit();
      hl::wgmma_wait<0>();
      hl::fence_regs(s);
      hl::fence_regs(dp);

      // p in base 2, 0 past each row's last key on a tile that straddles
      // a boundary for these rows; ds = p (dp - delta), rounded in pairs:
      // register 4 j + 2 r + e is column 8 j + 2 tq + e of row r
      uint32_t a[32];
      if (k0 + BN - 1 > cmax_wg) {
        const int lim[2] = {cmax[0] - k0 - 2 * tq, cmax[1] - k0 - 2 * tq};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = hl::ex2(fmaf(s[4 * j + e], scale2, -lse2[r]));
            p = 8 * j + (e & 1) > lim[r] ? 0.f : p;
            s[4 * j + e] = p * (dp[4 * j + e] - dl[r]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int r = (j >> 1) & 1;
          s[j] = hl::ex2(fmaf(s[j], scale2, -lse2[r])) * (dp[j] - dl[r]);
        }
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        a[j] = hl::pack_bf16(s[2 * j], s[2 * j + 1]);
      hl::wgmma_fence();
      rs_steps<HD, BN / 16>(acc, a,
                            hl::smem_desc(kt, L::ATOM, L::ATOM, L::LAYOUT));
      hl::wgmma_commit();
      hl::wgmma_wait<0>();
      hl::fence_regs(acc);
      if (lane == 0) hl::mbar_arrive(empty(st));
    }
    for (int i = nrun; i < nk; ++i) {              // loaded for the other
      const int st = (it + i) % A_STAGES;
      const uint32_t ph = ((it + i) / A_STAGES) & 1;
      hl::mbar_wait(kfull(st), ph);
      hl::mbar_wait(vfull(st), ph);
      if (lane == 0) hl::mbar_arrive(empty(st));
    }
    it += nk;
    if (lane == 0) hl::mbar_arrive(qempty(qb));    // Q, dO and O read
    if (wg_first >= T) continue;
    store_rows<HD>(dq + (size_t)n * d.dq_sn + (size_t)h * d.dq_sh, d.dq_st,
                   row0, T, tq, acc, scale);
  }
}

// K6b. Persistent as K6a, over the I = N H ceil(S / 128) items; ldmap is
// the 2-D map of the scratch that K6a wrote, (T, 2 N H) with rows ldp
// apart, box (BT, 2): a query tile's lse log2(e) and delta
template <int HD>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wg(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap ldmap,
                 const int* __restrict__ kvl, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Dims d, int causal, int t0,
                 float scale2, float scale) {
  using L = DkvSmem<HD>;
  constexpr int NO = HD / 2;                  // dk, dv accumulator registers
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hl::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sk = hl::smem_u32(smem);
  const uint32_t sv = sk + L::V_OFF, sq = sk + L::Q_OFF;
  const uint32_t sdo = sk + L::DO_OFF, sl = sk + L::L_OFF;
  const uint32_t bar = sk + L::BAR_OFF;
  auto kvfull = [&](int b) { return bar + 8 * b; };
  auto kvempty = [&](int b) { return bar + 8 * (2 + b); };
  auto full = [&](int s) { return bar + 8 * (4 + s); };
  auto empty = [&](int s) { return bar + 8 * (4 + B_STAGES + s); };

  const int tid = threadIdx.x;
  const int S = d.S, KT = (S + BM - 1) / BM;
  const long long items = (long long)d.N * d.H * KT;
  const long long w0 = items * blockIdx.x / gridDim.x;
  const long long w1 = items * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      hl::mbar_init(kvfull(b), 1);
      hl::mbar_init(kvempty(b), 8);          // each consumer warp
    }
    for (int s = 0; s < B_STAGES; ++s) {
      hl::mbar_init(full(s), 1);
      hl::mbar_init(empty(s), 8);
    }
    hl::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // ---------------- producer: thread 0 issues every load
    hl::setmaxnreg_dec<56>();
    if (tid != 0) return;
    hl::prefetch_map(&qmap);
    hl::prefetch_map(&kmap);
    hl::prefetch_map(&vmap);
    hl::prefetch_map(&domap);
    hl::prefetch_map(&ldmap);
    int it = 0, li = 0;                      // li: items that load k, v
    for (long long w = w0; w < w1; ++w) {
      int nh, kt, qt0;
      item(w, KT, causal, false, &nh, &kt);
      const int k0 = kt * BM, n = nh / d.H, h = nh % d.H;
      const int nt = dkv_tiles(d, kvl, n, k0, causal, t0, &qt0);
      if (nt == 0) continue;
      const int kb = li & 1;
      hl::mbar_wait(kvempty(kb), ((li >> 1) & 1) ^ 1);
      hl::mbar_expect_tx(kvfull(kb), 2 * L::KBYTES);
      hl::tma_load_4d(sk + kb * L::KBYTES, &kmap, kvfull(kb), 0, k0, h, n);
      hl::tma_load_4d(sv + kb * L::KBYTES, &vmap, kvfull(kb), 0, k0, h, n);
      for (int i = 0; i < nt; ++i, ++it) {
        const int s = it % B_STAGES, q0 = (qt0 + i) * BT;
        hl::mbar_wait(empty(s), ((it / B_STAGES) & 1) ^ 1);
        // a partial last tile still moves the whole boxes (zeros past T)
        hl::mbar_expect_tx(full(s), 2 * L::QBYTES + L::LBYTES);
        hl::tma_load_4d(sq + s * L::QBYTES, &qmap, full(s), 0, q0, h, n);
        hl::tma_load_4d(sdo + s * L::QBYTES, &domap, full(s), 0, q0, h, n);
        hl::tma_load_2d(sl + s * L::LBYTES, &ldmap, full(s), q0, 2 * nh);
      }
      ++li;
    }
    return;
  }

  // ---------------- consumers: 64 key rows each
  hl::setmaxnreg_inc<224>();
  const int c = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  int it = 0, li = 0;
  for (long long w = w0; w < w1; ++w) {
    int nh, kt, qt0;
    item(w, KT, causal, false, &nh, &kt);
    const int k0 = kt * BM, n = nh / d.H, h = nh % d.H;
    const int nt = dkv_tiles(d, kvl, n, k0, causal, t0, &qt0);
    const int kvlen = min(kvl[n], S);
    const int row0 = k0 + c * 64 + warp * 16 + g;   // key rows, and + 8
    // the first query each key row attends; over these 64 rows, the least
    // of that (a query tile wholly before it is skipped) and the most (a
    // query tile that starts before it straddles the boundary)
    const int qmin[2] = {first_query(row0, kvlen, causal, t0),
                         first_query(row0 + 8, kvlen, causal, t0)};
    const int live_from = first_query(k0 + c * 64, kvlen, causal, t0);
    const int mask_to = first_query(k0 + c * 64 + 63, kvlen, causal, t0);

    float dka[NO], dva[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
    if (nt > 0) {
      const int kb = li & 1;
      const uint64_t ka = hl::smem_desc(sk + kb * L::KBYTES + c * 64 * L::RB,
                                        16, L::ATOM, L::LAYOUT);
      const uint64_t va = hl::smem_desc(sv + kb * L::KBYTES + c * 64 * L::RB,
                                        16, L::ATOM, L::LAYOUT);
      hl::mbar_wait(kvfull(kb), (li >> 1) & 1);
      for (int i = 0; i < nt; ++i) {
        const int st = (it + i) % B_STAGES, q0 = (qt0 + i) * BT;
        hl::mbar_wait(full(st), ((it + i) / B_STAGES) & 1);
        if (q0 + BT - 1 >= live_from) {
          const uint32_t qt = sq + st * L::QBYTES, dt = sdo + st * L::QBYTES;
          const uint64_t qb = hl::smem_desc(qt, 16, L::ATOM, L::LAYOUT);
          const uint64_t db = hl::smem_desc(dt, 16, L::ATOM, L::LAYOUT);
          float s[32], dp[32];
          hl::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)       // S^T = K Q^T
            hl::wgmma_ss_m64n64<0>(s, ka + 2 * kk, qb + 2 * kk, kk);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)       // dP^T = V dO^T
            hl::wgmma_ss_m64n64<0>(dp, va + 2 * kk, db + 2 * kk, kk);
          hl::wgmma_commit();
          hl::wgmma_wait<0>();
          hl::fence_regs(s);
          hl::fence_regs(dp);

          // register 4 j + 2 r + e is key row r, query column 8 j + 2 tq +
          // e of the tile: that column's lse (base 2) and delta
          const float* lt = reinterpret_cast<const float*>(
              smem + L::L_OFF + st * L::LBYTES) + 2 * tq;
          const bool edge = q0 < mask_to;
          const int lim[2] = {qmin[0] - q0 - 2 * tq, qmin[1] - q0 - 2 * tq};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j);
            const float2 de =
                *reinterpret_cast<const float2*>(lt + BT + 8 * j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              float p = hl::ex2(fmaf(s[4 * j + e], scale2,
                                     -((e & 1) ? l2.y : l2.x)));
              if (edge) p = 8 * j + (e & 1) < lim[r] ? 0.f : p;
              s[4 * j + e] = p;
              dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? de.y : de.x));
            }
          }
          uint32_t pa[16], da[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            pa[j] = hl::pack_bf16(s[2 * j], s[2 * j + 1]);
            da[j] = hl::pack_bf16(dp[2 * j], dp[2 * j + 1]);
          }
          hl::wgmma_fence();
          rs_steps<HD, BT / 16>(                     // dV += P^T dO
              dva, pa, hl::smem_desc(dt, L::ATOM, L::ATOM, L::LAYOUT));
          rs_steps<HD, BT / 16>(                     // dK += dS^T Q
              dka, da, hl::smem_desc(qt, L::ATOM, L::ATOM, L::LAYOUT));
          hl::wgmma_commit();
          hl::wgmma_wait<0>();
          hl::fence_regs(dva);
          hl::fence_regs(dka);
        }
        if (lane == 0) hl::mbar_arrive(empty(st));
      }
      it += nt;
      if (lane == 0) hl::mbar_arrive(kvempty(kb));   // K and V read
      ++li;
    }
    store_rows<HD>(dk + (size_t)n * d.dk_sn + (size_t)h * d.dk_sh, d.dk_st,
                   row0, S, tq, dka, scale);
    store_rows<HD>(dv + (size_t)n * d.dv_sn + (size_t)h * d.dv_sh, d.dv_st,
                   row0, S, tq, dva, 1.f);
  }
}

// ------------------------------------------------ fp32, CUDA cores

// fp32 shared memory (csrc/flash_f32.cuh's tiles)
template <int HD>
struct F32 : Tiles<HD> {
  // K6a: Q | dO | [2] (K | V) tiles, then lse log2(e) and delta of the
  // tile's rows; K6b: K | V | Q | dO | P^T | dS^T tiles, then lse and
  // delta of the query tile's rows. K6a writes dS over a V tile.
  static constexpr int DQ_BYTES = (6 * Tiles<HD>::TILE + 2 * FT) * 4;
  static constexpr int DKV_BYTES = (6 * Tiles<HD>::TILE + 2 * FT) * 4;
};

// one float by cp.async; zero where !valid
__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* g,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hl::smem_addr(smem)), "l"(g), "r"(valid ? 4 : 0));
}

// S = A B^T and S2 = A2 B2^T over rows of HD of four tiles: acc[r][c] +=
// A[ty + 16 r] . B[tx + 8 c], acc2 likewise, each sum in e's order. The
// two products share a loop so that a step has 64 independent FFMA
// chains (a chain's next FFMA waits for its last; the others issue
// meanwhile), the loads of the next step in flight behind them
template <int HD>
__device__ __forceinline__ void rows_dot2(float (&acc)[4][8],
                                          float (&acc2)[4][8],
                                          const float* A, const float* B,
                                          const float* A2, const float* B2,
                                          int ty, int tx) {
  constexpr int LD = F32<HD>::LD;
#pragma unroll 2
  for (int e = 0; e < HD; e += 4) {
    float4 a[4], b[8], a2[4], b2[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * LD + e);
      a2[r] = *reinterpret_cast<const float4*>(A2 + (ty + 16 * r) * LD + e);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      b[c] = *reinterpret_cast<const float4*>(B + (tx + 8 * c) * LD + e);
      b2[c] = *reinterpret_cast<const float4*>(B2 + (tx + 8 * c) * LD + e);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[r][c] = fmaf(comp(a[r], u), comp(b[c], u), acc[r][c]);
          acc2[r][c] = fmaf(comp(a2[r], u), comp(b2[c], u), acc2[r][c]);
        }
  }
}

// a thread's 4 x CW output patch: row r's floats 4 g .. 4 g + 3 at
// ``row(r) + 32 g``, times ``mul`` (to), or from L2 (from)
template <int CW, typename F>
__device__ __forceinline__ void patch_to(F row, const float (&x)[4][CW],
                                         float mul) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* p = row(r);
    if (p == nullptr) continue;
#pragma unroll
    for (int g = 0; g < CW / 4; ++g)
      *reinterpret_cast<float4*>(p + 32 * g) =
          make_float4(x[r][4 * g] * mul, x[r][4 * g + 1] * mul,
                      x[r][4 * g + 2] * mul, x[r][4 * g + 3] * mul);
  }
}

template <int CW>
__device__ __forceinline__ void patch_add(float (&x)[4][CW], const float* p,
                                          int ld, bool first) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < CW / 4; ++g) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(p + 16 * r * ld + 32 * g));
      const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[r][4 * g + u] = first ? y[u] : x[r][4 * g + u] + y[u];
    }
}

// The splits' merge. Every split of an output tile writes its sums
// ``acc`` (G outputs: dq, or dk then dv) to its slot of ``part``,
// [tile][split][G][FT][HD]; the last split to finish (a per-tile counter,
// left 0 for the next call) adds the slots in split order into ``acc``.
// -> whether this block is that last one. With one split, acc is the sum
// already.
template <int HD, int G>
__device__ __forceinline__ bool merge_splits(float (&acc)[G][4][F32<HD>::CW],
                                             float* part, int* ctr,
                                             long long tile, int P, int s,
                                             int ty, int tx) {
  constexpr int CW = F32<HD>::CW;
  __shared__ int last;
  if (P == 1) return true;
  auto slot = [&](int sp, int g) {
    return part + ((tile * P + sp) * G + g) * FT * HD + ty * HD + tx * 4;
  };
#pragma unroll
  for (int g = 0; g < G; ++g)
    patch_to<CW>([&](int r) { return slot(s, g) + 16 * r * HD; }, acc[g],
                 1.f);
  __threadfence();                          // the partial, before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ctr + tile, 1) == P - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();                          // every split's partial is seen
  for (int sp = 0; sp < P; ++sp)
#pragma unroll
    for (int g = 0; g < G; ++g)
      patch_add<CW>(acc[g], slot(sp, g), HD, sp == 0);
  if (threadIdx.x == 0) ctr[tile] = 0;
  return true;
}

// K6a in fp32. Block b: split s = b % P of the (n*h, 64-row query tile)
// b / P, the query tiles latest first (the causal ones with most keys),
// the heads within; its key tiles stream through a 2-stage ring. Writes
// delta (split 0) and dq, through ``part`` and ``ctr`` when P > 1.
template <int HD>
__global__ void __launch_bounds__(FTHREADS, 2)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ o,
           const float* __restrict__ dout, const int* __restrict__ kvl,
           const float* __restrict__ lse, float* __restrict__ delta,
           float* __restrict__ dq, float* part, int* ctr, Dims d, int causal,
           int t0, float scale2, float scale, int P) {
  using L = F32<HD>;
  constexpr int CW = L::CW, TPR = FTHREADS / FT;   // threads a row (delta)
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ds = fsm + L::TILE;
  float* ring = fsm + 2 * L::TILE;              // [2] (K | V)
  float* lse2_s = fsm + 6 * L::TILE;
  float* dl_s = lse2_s + FT;

  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int T = d.T, S = d.S, NH = d.N * d.H, QT = (T + FT - 1) / FT;
  const int s = blockIdx.x % P, w = blockIdx.x / P;
  const int nh = w % NH, qt = QT - 1 - w / NH;
  const int n = nh / d.H, h = nh % d.H, q0 = qt * FT;
  const long long tile = (long long)nh * QT + qt;
  const float* kb = k + (size_t)n * d.k_sn + (size_t)h * d.k_sh;
  const float* vb = v + (size_t)n * d.v_sn + (size_t)h * d.v_sh;
  const float* db = dout + (size_t)n * d.do_sn + (size_t)h * d.do_sh;
  const float* ob = o + (size_t)n * d.o_sn + (size_t)h * d.o_sh;
  const int kvlen = min(kvl[n], S);
  int k_lo, k_hi;
  split_range((key_end(kvlen, causal, t0, q0) + FT - 1) / FT, P, s, &k_lo,
              &k_hi);

  issue_tile<HD>(Qs, q + (size_t)n * d.q_sn + (size_t)h * d.q_sh, q0, T,
                 d.q_st);
  issue_tile<HD>(Ds, db, q0, T, d.do_st);
  if (k_lo < k_hi) {
    issue_tile<HD>(ring, kb, k_lo * FT, S, d.k_st);
    issue_tile<HD>(ring + L::TILE, vb, k_lo * FT, S, d.v_st);
  }
  hl::cp_async_commit();
  {
    // delta = rowsum(dO O) from device memory, TPR threads a row (each a
    // share of the row, then summed by shuffles: a fixed order), while
    // the tiles land
    const int row = q0 + tid / TPR, part_r = tid % TPR;
    float acc = 0.f;
    if (row < T) {
      const float* dr = db + (size_t)row * d.do_st + part_r * (HD / TPR);
      const float* orow = ob + (size_t)row * d.o_st + part_r * (HD / TPR);
#pragma unroll
      for (int e = 0; e < HD / TPR; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(dr + e);
        const float4 b = *reinterpret_cast<const float4*>(orow + e);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    }
#pragma unroll
    for (int m = 1; m < TPR; m *= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (part_r == 0) {
      dl_s[tid / TPR] = acc;
      if (row < T && s == 0) delta[(size_t)nh * T + row] = acc;
    }
    if (tid < FT)
      lse2_s[tid] = q0 + tid < T ? lse[(size_t)nh * T + q0 + tid] * LOG2E
                                 : 0.f;
  }

  // the last key each of this thread's rows attends, and the least of
  // that over the tile's 64 rows (a key tile past it needs the mask)
  int cmax[4];
  const int cmax_tile = causal ? min(kvlen - 1, t0 + q0) : kvlen - 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    cmax[r] = causal ? min(kvlen - 1, t0 + q0 + ty + 16 * r) : kvlen - 1;

  float acc[1][4][CW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < CW; ++u) acc[0][r][u] = 0.f;
  float l2[4], dl[4];

  for (int kt = k_lo; kt < k_hi; ++kt) {
    const int i = kt - k_lo, k0 = kt * FT;
    float* Ks = ring + (i & 1) * 2 * L::TILE;
    float* Vs = Ks + L::TILE;
    hl::cp_async_wait<0>();
    __syncthreads();              // tile i landed; tile i - 1's reads done
    if (i == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        l2[r] = lse2_s[ty + 16 * r];
        dl[r] = dl_s[ty + 16 * r];
      }
    if (kt + 1 < k_hi) {          // the next k and v tiles, during this one
      float* nk = ring + ((i + 1) & 1) * 2 * L::TILE;
      issue_tile<HD>(nk, kb, k0 + FT, S, d.k_st);
      issue_tile<HD>(nk + L::TILE, vb, k0 + FT, S, d.v_st);
      hl::cp_async_commit();
    }
    float sc[4][8] = {}, dp[4][8] = {};
    rows_dot2<HD>(sc, dp, Qs, Ks, Ds, Vs, ty, tx);      // Q K^T, dO V^T
    // p = 2^(s log2(e)/sqrt(D) - lse log2(e)), 0 past each row's last key
    // on a tile that crosses the tile's first row's; ds = p (dp - delta)
    const bool edge = k0 + FT - 1 > cmax_tile;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float p = hl::ex2(fmaf(sc[r][c], scale2, -l2[r]));
        if (edge && k0 + tx + 8 * c > cmax[r]) p = 0.f;
        sc[r][c] = p * (dp[r][c] - dl[r]);
      }
    __syncthreads();              // every read of V done: dS takes its place
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        Vs[(ty + 16 * r) * L::SLD + tx + 8 * c] = sc[r][c];
    __syncthreads();
    rows_times<HD>(acc[0], Vs, Ks, ty, tx);             // dQ += dS K
  }
  hl::cp_async_wait<0>();         // nothing in flight at exit (no keys)

  if (!merge_splits<HD, 1>(acc, part, ctr, tile, P, s, ty, tx)) return;
  float* out = dq + (size_t)n * d.dq_sn + (size_t)h * d.dq_sh + tx * 4;
  patch_to<CW>([&](int r) {
    const int row = q0 + ty + 16 * r;
    return row < T ? out + (size_t)row * d.dq_st : nullptr;
  }, acc[0], scale);
}

// K6b in fp32. Block b: split s = b % P of the (n*h, 64-key tile) b / P,
// the key tiles earliest first (the causal ones with most queries), the
// heads within; its query tiles load one at a time with their lse and
// K6a's delta (two blocks share an SM, each loading while the other
// computes). Writes dk and dv, through ``part`` and ``ctr`` when P > 1.
template <int HD>
__global__ void __launch_bounds__(FTHREADS, 2)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const int* __restrict__ kvl, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk,
            float* __restrict__ dv, float* part, int* ctr, Dims d,
            int causal, int t0, float scale2, float scale, int P) {
  using L = F32<HD>;
  constexpr int CW = L::CW;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;
  float* Vs = fsm + L::TILE;
  float* Qs = fsm + 2 * L::TILE;
  float* Ds = fsm + 3 * L::TILE;
  float* Pt = fsm + 4 * L::TILE;
  float* dSt = fsm + 5 * L::TILE;
  float* lt = fsm + 6 * L::TILE;                // lse | delta

  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int T = d.T, S = d.S, NH = d.N * d.H, KT = (S + FT - 1) / FT;
  const int s = blockIdx.x % P, w = blockIdx.x / P;
  const int nh = w % NH, kt = w / NH;
  const int n = nh / d.H, h = nh % d.H, k0 = kt * FT;
  const long long tile = (long long)nh * KT + kt;
  const float* qb = q + (size_t)n * d.q_sn + (size_t)h * d.q_sh;
  const float* db = dout + (size_t)n * d.do_sn + (size_t)h * d.do_sh;
  const float* lb = lse + (size_t)nh * T;
  const float* deb = delta + (size_t)nh * T;
  const int kvlen = min(kvl[n], S);
  // the query tiles that can see this key tile: from the first (the TPU
  // kernel's q_index clamp) to the last; none at or past kv_lengths[n]
  const int qt0 = first_query_tile(causal, t0, k0);
  int q_lo, q_hi;
  split_range(k0 < kvlen ? max((T + FT - 1) / FT - qt0, 0) : 0, P, s, &q_lo,
              &q_hi);
  q_lo += qt0, q_hi += qt0;

  auto issue = [&](int qt) {
    issue_tile<HD>(Qs, qb, qt * FT, T, d.q_st);
    issue_tile<HD>(Ds, db, qt * FT, T, d.do_st);
    for (int i = tid; i < 2 * FT; i += FTHREADS) {
      const int row = qt * FT + i % FT;
      cp_async4_zfill(lt + i, (i < FT ? lb : deb) + (row < T ? row : 0),
                      row < T);
    }
  };
  if (q_lo < q_hi) {
    issue_tile<HD>(Ks, k + (size_t)n * d.k_sn + (size_t)h * d.k_sh, k0, S,
                   d.k_st);
    issue_tile<HD>(Vs, v + (size_t)n * d.v_sn + (size_t)h * d.v_sh, k0, S,
                   d.v_st);
    issue(q_lo);
  }
  hl::cp_async_commit();

  // the first query each of this thread's key rows attends (before it:
  // masked), and over the tile's 64 rows the most of that: a query tile
  // that starts before it needs the mask
  int qmin[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    qmin[r] = first_query(k0 + ty + 16 * r, kvlen, causal, t0);
  const int mask_to = first_query(k0 + FT - 1, kvlen, causal, t0);

  float acc[2][4][CW];                          // dk, dv
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < CW; ++u) acc[g][r][u] = 0.f;

  for (int qt = q_lo; qt < q_hi; ++qt) {
    const int q0 = qt * FT;
    hl::cp_async_wait<0>();
    __syncthreads();              // the tile landed
    float sc[4][8] = {}, dp[4][8] = {};
    rows_dot2<HD>(sc, dp, Ks, Qs, Vs, Ds, ty, tx);      // K Q^T, V dO^T
    const bool edge = q0 < mask_to;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 8 * c;
      const float l2 = lt[col] * LOG2E, de = lt[FT + col];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = hl::ex2(fmaf(sc[r][c], scale2, -l2));
        if (edge && q0 + col < qmin[r]) p = 0.f;
        Pt[(ty + 16 * r) * L::SLD + col] = p;
        dSt[(ty + 16 * r) * L::SLD + col] = p * (dp[r][c] - de);
      }
    }
    __syncthreads();
    rows_times<HD>(acc[1], Pt, Ds, ty, tx);             // dV += P^T dO
    rows_times<HD>(acc[0], dSt, Qs, ty, tx);            // dK += dS^T Q
    if (qt + 1 < q_hi) {
      __syncthreads();            // every read of this tile done
      issue(qt + 1);
      hl::cp_async_commit();
    }
  }

  if (!merge_splits<HD, 2>(acc, part, ctr, tile, P, s, ty, tx)) return;
  float* ko = dk + (size_t)n * d.dk_sn + (size_t)h * d.dk_sh + tx * 4;
  float* vo = dv + (size_t)n * d.dv_sn + (size_t)h * d.dv_sh + tx * 4;
  patch_to<CW>([&](int r) {
    const int row = k0 + ty + 16 * r;
    return row < S ? ko + (size_t)row * d.dk_st : nullptr;
  }, acc[0], scale);
  patch_to<CW>([&](int r) {
    const int row = k0 + ty + 16 * r;
    return row < S ? vo + (size_t)row * d.dv_st : nullptr;
  }, acc[1], 1.f);
}

template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

Dims read_dims(const int* dims) {
  Dims d;
  int* f = &d.N;
  for (int i = 0; i < NDIMS; ++i) f[i] = dims[i];
  return d;
}

// the scratch's row length: T rounded up to 4 fp32 (16 bytes)
int scratch_row(int T) { return (T + 3) & ~3; }

// a persistent grid: one block per SM, or per item if fewer
cudaError_t persistent_grid(long long items, int* grid) {
  int sms;
  const cudaError_t err = hl::sm_count(&sms);
  *grid = (int)(items < sms ? items : sms);
  return err;
}

// fp32: (N H ceil(T / FT)) query tiles (K6a) or (N H ceil(S / FT)) key
// tiles (K6b), each in P splits, one block a split
template <int HD>
cudaError_t run_dq_f32(const Dims& d, const void* q, const void* k,
                       const void* v, const void* o, const void* dout,
                       const int* kvl, const float* lse, float* delta,
                       void* dq, float* part, int* ctr, int causal, int t0,
                       int P, cudaStream_t s) {
  static unsigned done = 0;
  constexpr int smem = F32<HD>::DQ_BYTES;
  cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(bwd_dq_f32<HD>), smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)HD);
  const long long blocks =
      (long long)d.N * d.H * ((d.T + FT - 1) / FT) * P;
  bwd_dq_f32<HD><<<(unsigned)blocks, FTHREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), kvl, lse, delta,
      static_cast<float*>(dq), part, ctr, d, causal, t0, LOG2E * scale,
      scale, P);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_dkv_f32(const Dims& d, const void* q, const void* k,
                        const void* v, const void* dout, const int* kvl,
                        const float* lse, const float* delta, void* dk,
                        void* dv, float* part, int* ctr, int causal, int t0,
                        int P, cudaStream_t s) {
  static unsigned done = 0;
  constexpr int smem = F32<HD>::DKV_BYTES;
  cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(bwd_dkv_f32<HD>), smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)HD);
  const long long blocks =
      (long long)d.N * d.H * ((d.S + FT - 1) / FT) * P;
  bwd_dkv_f32<HD><<<(unsigned)blocks, FTHREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), kvl,
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), part,
      ctr, d, causal, t0, LOG2E * scale, scale, P);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_dq(const Dims& d, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const int* kvl, const float* lse, float* delta, void* dq,
                   int causal, int t0, cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)HD);
  CUtensorMap qm, km, vm, om, dom;
  if (!hl::tile_map_bf16(&qm, q, HD, d.T, d.H, d.N, d.q_st, d.q_sh, d.q_sn,
                         BM) ||
      !hl::tile_map_bf16(&km, k, HD, d.S, d.H, d.N, d.k_st, d.k_sh, d.k_sn,
                         BN) ||
      !hl::tile_map_bf16(&vm, v, HD, d.S, d.H, d.N, d.v_st, d.v_sh, d.v_sn,
                         BN) ||
      !hl::tile_map_bf16(&om, o, HD, d.T, d.H, d.N, d.o_st, d.o_sh, d.o_sn,
                         BM) ||
      !hl::tile_map_bf16(&dom, dout, HD, d.T, d.H, d.N, d.do_st, d.do_sh,
                         d.do_sn, BM))
    return cudaErrorInvalidValue;
  int grid;
  cudaError_t err =
      persistent_grid((long long)d.N * d.H * ((d.T + BM - 1) / BM), &grid);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_wg<HD>, dim3(grid), 384, DqSmem<HD>::SIZE, s,
                qm, km, vm, om, dom, kvl, lse, delta, static_cast<bf16*>(dq),
                d, causal, t0, LOG2E * scale, scale, scratch_row(d.T));
}

template <int HD>
cudaError_t run_dkv(const Dims& d, const void* q, const void* k,
                    const void* v, const void* dout, const int* kvl,
                    const float* lse, const float* delta, void* dk, void* dv,
                    int causal, int t0, cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)HD);
  CUtensorMap qm, km, vm, dom, ldm;
  if (!hl::tile_map_bf16(&qm, q, HD, d.T, d.H, d.N, d.q_st, d.q_sh, d.q_sn,
                         BT) ||
      !hl::tile_map_bf16(&km, k, HD, d.S, d.H, d.N, d.k_st, d.k_sh, d.k_sn,
                         BM) ||
      !hl::tile_map_bf16(&vm, v, HD, d.S, d.H, d.N, d.v_st, d.v_sh, d.v_sn,
                         BM) ||
      !hl::tile_map_bf16(&dom, dout, HD, d.T, d.H, d.N, d.do_st, d.do_sh,
                         d.do_sn, BT) ||
      !hl::tile_map_f32(&ldm, delta, d.T, 2 * d.N * d.H, scratch_row(d.T),
                        BT, 2))
    return cudaErrorInvalidValue;
  int grid;
  cudaError_t err =
      persistent_grid((long long)d.N * d.H * ((d.S + BM - 1) / BM), &grid);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dkv_wg<HD>, dim3(grid), 384, DkvSmem<HD>::SIZE, s,
                qm, km, vm, dom, ldm, kvl, static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), d, causal, t0, LOG2E * scale, scale);
}

}  // namespace

// q, o, do, dq (N, H, T, D), k, v, dk, dv (N, H, S, D): bf16 (bf16 != 0)
// or fp32, any strides with contiguous, 16-byte-aligned rows (in bf16,
// TMA's rule for the maps of q, k, v, o and do: byte strides multiples of
// 16, under 2^40); dims (host) = {N, H, T, S, D, then the (n, h, t)
// strides of q, k, v, o, do, dq, dk, dv}. kv_lengths (N,) int32; lse
// (N*H, T) fp32 from the forward. delta: the scratch that K6a writes and
// K6b reads, so K6a runs first on the stream; in bf16 (N*H, 2, Tp) fp32,
// lse log2(e) then delta, Tp = T rounded up to 4; in fp32 (N*H, T) delta.
// fp32 only (bf16 ignores them): ``splits`` (flash_cuda.bwd_f32_plan),
// and where it is over 1 ``part``, [tiles][splits][FT][D] fp32 (K6b: [2]
// within, dk then dv), and ``ctr``, an int32 counter a tile, 0 before the
// launch and after it. D is 32 or 64. Each returns its launch's
// cudaError_t.
extern "C" int hl_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const int* kv_lengths, const float* lse,
                               float* delta, void* dq, float* part, int* ctr,
                               const int* dims, int causal, int t0, int bf16_,
                               int splits, void* stream) {
  const Dims d = read_dims(dims);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (splits < 1) return static_cast<int>(err);
  if (d.D == 64)
    err = bf16_ ? run_dq<64>(d, q, k, v, o, dout, kv_lengths, lse, delta,
                             dq, causal, t0, s)
                : run_dq_f32<64>(d, q, k, v, o, dout, kv_lengths, lse, delta,
                                 dq, part, ctr, causal, t0, splits, s);
  else if (d.D == 32)
    err = bf16_ ? run_dq<32>(d, q, k, v, o, dout, kv_lengths, lse, delta,
                             dq, causal, t0, s)
                : run_dq_f32<32>(d, q, k, v, o, dout, kv_lengths, lse, delta,
                                 dq, part, ctr, causal, t0, splits, s);
  return static_cast<int>(err);
}

extern "C" int hl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const int* kv_lengths,
                                const float* lse, const float* delta,
                                void* dk, void* dv, float* part, int* ctr,
                                const int* dims, int causal, int t0,
                                int bf16_, int splits, void* stream) {
  const Dims d = read_dims(dims);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (splits < 1) return static_cast<int>(err);
  if (d.D == 64)
    err = bf16_ ? run_dkv<64>(d, q, k, v, dout, kv_lengths, lse, delta, dk,
                              dv, causal, t0, s)
                : run_dkv_f32<64>(d, q, k, v, dout, kv_lengths, lse, delta,
                                  dk, dv, part, ctr, causal, t0, splits, s);
  else if (d.D == 32)
    err = bf16_ ? run_dkv<32>(d, q, k, v, dout, kv_lengths, lse, delta, dk,
                              dv, causal, t0, s)
                : run_dkv_f32<32>(d, q, k, v, dout, kv_lengths, lse, delta,
                                  dk, dv, part, ctr, causal, t0, splits, s);
  return static_cast<int>(err);
}
