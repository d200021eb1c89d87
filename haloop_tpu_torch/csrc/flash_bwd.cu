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
// its rows meet TMA's 16-byte stride rule at any T. fp32 inputs take
// CUDA-core kernels, one thread per query row (K6a) or per key (K6b),
// with a (N*H, T) delta.
// Later perf_opt: one pass for dq, dk and dv with a fixed-order dq
// reduction; the consumers' ping-pong.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;        // fp32: query rows a tile
constexpr int BK = 64;        // fp32: keys a tile
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

// rows [r0, r0 + 64) of a (rows, HD) fp32 matrix with row stride st into
// shared memory [64][LDS] (LDS = HD, or HD + 1 for rows that one thread
// reads alone); rows past ``rows`` are zero
template <int HD, int LDS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int r0, int rows, int st) {
  for (int i = threadIdx.x; i < 64 * HD / 4; i += blockDim.x) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * st + c);
    float* out = dst + r * LDS + c;
    out[0] = val.x;
    out[1] = val.y;
    out[2] = val.z;
    out[3] = val.w;
  }
}

// the keys a query tile of QT rows starting at q0 must visit: [0, kend)
template <int QT = BQ>
__device__ __forceinline__ int key_end(int kvlen, int causal, int t0, int q0) {
  int kend = kvlen;
  if (causal) kend = min(kend, t0 + q0 + QT);   // keys <= the last row
  return max(kend, 0);
}

// the first query tile (of QT rows) that can see key k0
template <int QT = BQ>
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

template <int HD>
__global__ void __launch_bounds__(BQ)
bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ o,
            const float* __restrict__ dout, const int* __restrict__ kvl,
            const float* __restrict__ lse, float* __restrict__ delta,
            float* __restrict__ dq, Dims d, int causal, int t0,
            float scale) {
  constexpr int LDD = HD + 1;     // one thread reads each do row
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [BK][HD]
  float* Vs = Ks + BK * HD;                     // [BK][HD]
  float* Ds = Vs + BK * HD;                     // [BQ][LDD]

  const int tid = threadIdx.x;
  const int nh = blockIdx.y, n = nh / d.H, h = nh % d.H;
  const int q0 = blockIdx.x * BQ, row = q0 + tid;
  const int T = d.T, S = d.S;
  const float* kb = k + (size_t)n * d.k_sn + (size_t)h * d.k_sh;
  const float* vb = v + (size_t)n * d.v_sn + (size_t)h * d.v_sh;
  const float* db = dout + (size_t)n * d.do_sn + (size_t)h * d.do_sh;
  const int kvlen = min(kvl[n], S);

  load_tile_f32<HD, LDD>(Ds, db, q0, T, d.do_st);
  float qr[HD], acc[HD];
  float lse_r = 0.f, dl = 0.f;
  if (row < T) {
    const float* qrow = q + (size_t)n * d.q_sn + (size_t)h * d.q_sh +
                        (size_t)row * d.q_st;
    const float* orow = o + (size_t)n * d.o_sn + (size_t)h * d.o_sh +
                        (size_t)row * d.o_st;
    const float* drow = db + (size_t)row * d.do_st;
#pragma unroll
    for (int e = 0; e < HD; ++e) {
      qr[e] = qrow[e];
      dl += drow[e] * orow[e];
    }
    lse_r = lse[(size_t)nh * T + row];
    delta[(size_t)nh * T + row] = dl;
  } else {
#pragma unroll
    for (int e = 0; e < HD; ++e) qr[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = 0.f;

  const int nk = (key_end(kvlen, causal, t0, q0) + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    load_tile_f32<HD, HD>(Ks, kb, k0, S, d.k_st);
    load_tile_f32<HD, HD>(Vs, vb, k0, S, d.v_st);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const int c = k0 + j;
      if (row >= T || c >= kvlen || (causal && c > t0 + row)) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < HD; ++e) {
        s = fmaf(qr[e], Ks[j * HD + e], s);
        dp = fmaf(Ds[tid * LDD + e], Vs[j * HD + e], dp);
      }
      const float ds = expf(s * scale - lse_r) * (dp - dl);
#pragma unroll
      for (int e = 0; e < HD; ++e) acc[e] = fmaf(ds, Ks[j * HD + e], acc[e]);
    }
    __syncthreads();
  }
  if (row >= T) return;
  float* out = dq + (size_t)n * d.dq_sn + (size_t)h * d.dq_sh +
               (size_t)row * d.dq_st;
#pragma unroll
  for (int e = 0; e < HD; ++e) out[e] = acc[e] * scale;
}

template <int HD>
__global__ void __launch_bounds__(BK)
bwd_dkv_fp32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const int* __restrict__ kvl, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dk,
             float* __restrict__ dv, Dims d, int causal, int t0,
             float scale) {
  constexpr int LDK = HD + 1;     // one thread reads each k and v row
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BQ][HD]
  float* Ds = Qs + BQ * HD;                     // [BQ][HD] do
  float* Ks = Ds + BQ * HD;                     // [BK][LDK]
  float* Vs = Ks + BK * LDK;                    // [BK][LDK]
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x;
  const int nh = blockIdx.y, n = nh / d.H, h = nh % d.H;
  const int k0 = blockIdx.x * BK, c = k0 + tid;
  const int T = d.T, S = d.S;
  const float* qb = q + (size_t)n * d.q_sn + (size_t)h * d.q_sh;
  const float* kb = k + (size_t)n * d.k_sn + (size_t)h * d.k_sh;
  const float* vb = v + (size_t)n * d.v_sn + (size_t)h * d.v_sh;
  const float* db = dout + (size_t)n * d.do_sn + (size_t)h * d.do_sh;
  const int kvlen = min(kvl[n], S);

  float dka[HD], dva[HD];
#pragma unroll
  for (int e = 0; e < HD; ++e) dka[e] = dva[e] = 0.f;

  if (k0 < kvlen) {
    load_tile_f32<HD, LDK>(Ks, kb, k0, S, d.k_st);
    load_tile_f32<HD, LDK>(Vs, vb, k0, S, d.v_st);
    const int nq = (T + BQ - 1) / BQ;
    for (int qt = first_query_tile(causal, t0, k0); qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();               // the last tile's reads are done
      load_tile_f32<HD, HD>(Qs, qb, q0, T, d.q_st);
      load_tile_f32<HD, HD>(Ds, db, q0, T, d.do_st);
      const bool in = q0 + tid < T;
      lse_s[tid] = in ? lse[(size_t)nh * T + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[(size_t)nh * T + q0 + tid] : 0.f;
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const int row = q0 + i;
        if (c >= kvlen || row >= T || (causal && c > t0 + row)) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < HD; ++e) {
          s = fmaf(Ks[tid * LDK + e], Qs[i * HD + e], s);
          dp = fmaf(Vs[tid * LDK + e], Ds[i * HD + e], dp);
        }
        const float p = expf(s * scale - lse_s[i]);
        const float ds = p * (dp - delta_s[i]);
#pragma unroll
        for (int e = 0; e < HD; ++e) {
          dva[e] = fmaf(p, Ds[i * HD + e], dva[e]);
          dka[e] = fmaf(ds, Qs[i * HD + e], dka[e]);
        }
      }
    }
  }
  if (c >= S) return;
  float* ko = dk + (size_t)n * d.dk_sn + (size_t)h * d.dk_sh +
              (size_t)c * d.dk_st;
  float* vo = dv + (size_t)n * d.dv_sn + (size_t)h * d.dv_sh +
              (size_t)c * d.dv_st;
#pragma unroll
  for (int e = 0; e < HD; ++e) {
    ko[e] = dka[e] * scale;
    vo[e] = dva[e];
  }
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

template <int HD>
cudaError_t run_dq(const Dims& d, const void* q, const void* k,
                   const void* v, const void* o, const void* dout,
                   const int* kvl, const float* lse, float* delta, void* dq,
                   int causal, int t0, int bf16_, cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)HD);
  if (!bf16_)
    return launch(bwd_dq_fp32<HD>, dim3((d.T + BQ - 1) / BQ, d.N * d.H), BQ,
                  (size_t)(2 * BK * HD + BQ * (HD + 1)) * sizeof(float), s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(o),
                  static_cast<const float*>(dout), kvl, lse, delta,
                  static_cast<float*>(dq), d, causal, t0, scale);
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
                    int causal, int t0, int bf16_, cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)HD);
  if (!bf16_)
    return launch(bwd_dkv_fp32<HD>, dim3((d.S + BK - 1) / BK, d.N * d.H), BK,
                  (size_t)(2 * BQ * HD + 2 * BK * (HD + 1)) * sizeof(float),
                  s, static_cast<const float*>(q),
                  static_cast<const float*>(k), static_cast<const float*>(v),
                  static_cast<const float*>(dout), kvl, lse, delta,
                  static_cast<float*>(dk), static_cast<float*>(dv), d, causal,
                  t0, scale);
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
// D is 32 or 64. Each returns its launch's cudaError_t.
extern "C" int hl_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const int* kv_lengths, const float* lse,
                               float* delta, void* dq, const int* dims,
                               int causal, int t0, int bf16_, void* stream) {
  const Dims d = read_dims(dims);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d.D == 64)
    err = run_dq<64>(d, q, k, v, o, dout, kv_lengths, lse, delta, dq, causal,
                     t0, bf16_, s);
  else if (d.D == 32)
    err = run_dq<32>(d, q, k, v, o, dout, kv_lengths, lse, delta, dq, causal,
                     t0, bf16_, s);
  return static_cast<int>(err);
}

extern "C" int hl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const int* kv_lengths,
                                const float* lse, const float* delta,
                                void* dk, void* dv, const int* dims,
                                int causal, int t0, int bf16_, void* stream) {
  const Dims d = read_dims(dims);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (d.D == 64)
    err = run_dkv<64>(d, q, k, v, dout, kv_lengths, lse, delta, dk, dv,
                      causal, t0, bf16_, s);
  else if (d.D == 32)
    err = run_dkv<32>(d, q, k, v, dout, kv_lengths, lse, delta, dk, dv,
                      causal, t0, bf16_, s);
  return static_cast<int>(err);
}
