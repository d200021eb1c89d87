// Int8-weight matrix product: y = (x . w_q^T) * scale.
//
// Replaces: haloop_tpu/ops/q8_matmul.py _kernel (launched by q8_matmul).
// Plain version: haloop_tpu_torch/ops/q8_matmul.py q8_matmul.
//
// Computes, for x (M <= 64, K) in bf16 or fp32, w_q (N, K) int8 with one
// scale per output row (quant.quantize_weight), and every m < M, n < N:
//   y[m, n] = (sum_k x[m, k] * w_q[n, k]) * scale[n]
// summed in fp32, y in x's dtype. The TPU kernel's ragged tiles read past
// the weight's end; here every load is bounds-checked instead.
//
// What bounds it on the H100: the weight's bytes. GPT-2 small's decode
// step at M <= 64 streams 123.6 MB of int8 weights (36.9 us at 3.35 TB/s,
// against 73.8 us for the same weights in bf16); the products are
// 2 M N K, far below the tensor cores' rate at this M.
//
// This design, bf16 x: Hopper has no int8 x bf16 mma, so the int8 bytes
// cross HBM and are converted to bf16 on chip (exact: |w_q| <= 127) for
// mma.sync m16n8k16 with fp32 sums. A warp's unit of work is a 64-k chunk
// of 8-column tiles: a lane holds 16 weight bytes of one column and the 32
// x values of its A-fragment rows (the chunk's k order permuted alike in A
// and B, so that one lane's 16 contiguous bytes feed four mma steps). The
// int8 to bf16 conversion is integer work: x ^ 0x80 as the low byte of an
// fp32 2^23 + byte (one byte_perm), less 2^23 + 128, is x exactly, and the
// top half of that fp32 is its bf16 (one byte_perm packs two). Two
// kernels, picked by the wrapper's plan:
// - q8_persist, long weights (lm_head: 786 tiles of 64 columns at N =
//   50304): one block of 16 warps an SM walks its tiles with a ring of 3
//   tiles in shared memory, each tile whole rows of the weight (64
//   columns x K) by cp.async, so that each row crosses HBM in one piece
//   and the loads of the next two tiles overlap this one's products; x
//   sits in shared memory for the whole call. The warps are 4 column
//   groups of 16 columns times 4 k groups, each group every 4th chunk;
//   both operands' rows are swizzled so that a warp's reads hit every bank
//   once; the tile's scales are read before its products, the outputs
//   stored in pairs.
// - q8_stripes, the other linears of a decode step (N <= 3072 at GPT-2
//   small): a block of 8 warps a 16-column tile, the warps taking chunks round
//   robin, every lane's loads for up to two chunks issued before the
//   first product (one round trip to memory); where K has more chunks
//   than that (mlp.c_proj's 48), clusters of 2 or 4 blocks split K, and
//   the ranks' partials are summed in rank order through distributed
//   shared memory, each rank finishing every cl-th output. The cluster
//   code is compiled into a kernel of its own (on an H100 the kernel with
//   it read 0.8 us slower at c_attn, launched without a cluster). Shared
//   memory is static and small.
// The k groups' (warps') partial sums are added in group order, then the
// scale, the cast and the store: the same bits on every run.
// fp32 x: on the CUDA cores in fp32 (exact products, as the TPU kernel's
// HIGHEST precision), one warp an output column, lanes across K, a fixed
// shuffle tree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 64;

__device__ __forceinline__ float scale_at(const void* scale, int sbf16,
                                          int n) {
  return sbf16 ? __bfloat162float(static_cast<const bf16*>(scale)[n])
               : static_cast<const float*>(scale)[n];
}

// bytes i and i+1 of w (each already ^ 0x80) as a bf16 pair, the first low
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int i) {
  const float lo =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541 + i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// one lane's share of a 64-k chunk: the 16 weight bytes of column 8 nt +
// g (each ^ 0x80) and the 16 x values of rows 16 mt + g and 16 mt + g + 8
// at the lane's 16 k
template <int MT, int NT>
struct Frag {
  uint32_t w[NT][4], xa[MT][8], xb[MT][8];
};

// acc += the chunk's products. Step j pairs fragment k 2t, 2t+1 with k +
// 4j, +1 and fragment k 2t+8, +9 with k + 4j+2, +3
template <int MT, int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NT][4],
                                          const Frag<MT, NT>& f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b0[NT], b1[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b0[nt] = i8x2_bf16(f.w[nt][j], 0);
      b1[nt] = i8x2_bf16(f.w[nt][j], 2);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t a[4] = {f.xa[mt][2 * j], f.xb[mt][2 * j],
                             f.xa[mt][2 * j + 1], f.xb[mt][2 * j + 1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) hl::mma_bf16(acc[mt][nt], a, b0[nt],
                                                   b1[nt]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// the lane's fragment of the chunk at k (this lane's first k), straight
// from global memory; zeros past M, N and k1. AL: K % 16 == 0 and 16-byte
// aligned x and w (whole vector loads; k1 is then a multiple of 16)
template <int MT, int NT, bool AL>
__device__ __forceinline__ void load_frag(Frag<MT, NT>& f,
                                          const bf16* __restrict__ x,
                                          const int8_t* __restrict__ w, int M,
                                          int N, int K, int n0, int k,
                                          int k1, int g) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + g;
    if (AL) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && k < k1)
        v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)n * K + k));
      f.w[nt][0] = v.x ^ 0x80808080u; f.w[nt][1] = v.y ^ 0x80808080u;
      f.w[nt][2] = v.z ^ 0x80808080u; f.w[nt][3] = v.w ^ 0x80808080u;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = k + 4 * i + e;
          const uint32_t byte = n < N && kk < k1
              ? static_cast<uint8_t>(w[(size_t)n * K + kk]) : 0u;
          word |= byte << (8 * e);
        }
        f.w[nt][i] = word ^ 0x80808080u;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      uint32_t* dst = half ? f.xb[mt] : f.xa[mt];
      if (AL) {
        uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
        if (r < M && k < k1) {
          const uint4* src =
              reinterpret_cast<const uint4*>(x + (size_t)r * K + k);
          v0 = __ldg(src);
          v1 = __ldg(src + 1);
        }
        dst[0] = v0.x; dst[1] = v0.y; dst[2] = v0.z; dst[3] = v0.w;
        dst[4] = v1.x; dst[5] = v1.y; dst[6] = v1.z; dst[7] = v1.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = k + 2 * i;
          const bool in = r < M;
          const float lo = in && kk < k1
              ? __bfloat162float(x[(size_t)r * K + kk]) : 0.f;
          const float hi = in && kk + 1 < k1
              ? __bfloat162float(x[(size_t)r * K + kk + 1]) : 0.f;
          dst[i] = hl::pack_bf16(lo, hi);   // exact: bf16 values
        }
      }
    }
}

// one output: y = bf16(v * scale) at row m, column n
__device__ __forceinline__ void store_y(bf16* __restrict__ y,
                                        const void* __restrict__ scale,
                                        int sbf16, int M, int N, int m,
                                        int n, float v) {
  if (m < M && n < N)
    y[(size_t)m * N + n] = __float2bfloat16(v * scale_at(scale, sbf16, n));
}

// the scales of a lane's output columns n0 + 8 nt + 2t and + 1 (0 past
// N), read before the products so that their latency hides behind them
template <int NT>
__device__ __forceinline__ void lane_scales(float (&sc)[NT][2],
                                            const void* __restrict__ scale,
                                            int sbf16, int N, int n0,
                                            int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + nt * 8 + 2 * t + e;
      sc[nt][e] = n < N ? scale_at(scale, sbf16, n) : 0.f;
    }
}

// a C fragment's pair of outputs, row m, columns n and n + 1 (c0, c1 of
// row g or c2, c3 of row g + 8, at n = n0 + 8 nt + 2t): bf16(v * scale),
// one 4-byte store where both columns exist and the pair is aligned
__device__ __forceinline__ void store_pair(bf16* __restrict__ y, int M,
                                           int N, int m, int n, float v0,
                                           float v1, const float (&sc)[2]) {
  if (m >= M || n >= N) return;
  bf16* p = y + (size_t)m * N + n;
  const bf16 a = __float2bfloat16(v0 * sc[0]);
  if (n + 1 < N) {
    const bf16 b = __float2bfloat16(v1 * sc[1]);
    if ((reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
      return;
    }
    p[1] = b;
  }
  p[0] = a;
}

// warp 0's acc += the other warps' (through red), in warp order
template <int MT, int NT>
__device__ __forceinline__ void warp_sums(
    float (&acc)[MT][NT][4], float (&red)[WARPS - 1][MT][NT][4][32],
    int warp, int lane) {
  if (warp > 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[warp - 1][mt][nt][i][lane] =
            acc[mt][nt][i];
  __syncthreads();
  if (warp == 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < WARPS - 1; ++q)
            acc[mt][nt][i] += red[q][mt][nt][i][lane];
}

// a warp's C fragments of columns n0.. as bf16(acc * scale)
template <int MT, int NT>
__device__ __forceinline__ void store_acc(bf16* __restrict__ y, int M,
                                          int N, int n0, int g, int t,
                                          const float (&acc)[MT][NT][4],
                                          const float (&sc)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair(y, M, N, mt * 16 + g + 8 * h, n0 + nt * 8 + 2 * t,
                   acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1], sc[nt]);
}

// q8_stripes: 16 columns a cluster, the block's k range [rank kr, (rank +
// 1) kr); CPW chunks a warp a round. CL: launched in clusters (the
// cluster code is compiled only there: a kernel without it launches
// faster)
template <int MT, int CPW, bool AL, bool CL>
__global__ void __launch_bounds__(THREADS)
q8_stripes(const bf16* __restrict__ x, const int8_t* __restrict__ w,
           const void* __restrict__ scale, int sbf16, bf16* __restrict__ y,
           int M, int N, int K, int kr) {
  constexpr int NT = 2;
  __shared__ float red[WARPS - 1][MT][NT][4][32];
  __shared__ float fin[CL ? MT * NT * 4 * 32 : 1];   // the block's partials
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const unsigned rank = CL ? hl::cluster_rank() : 0u;
  const unsigned ncta = CL ? hl::cluster_blocks() : 1u;
  const int n0 = (CL ? (int)hl::cluster_id_x() : (int)blockIdx.x) * 8 * NT;
  const int k0 = rank * kr, k1 = min(K, k0 + kr);
  const int chunks = k1 > k0 ? (k1 - k0 + 63) / 64 : 0;
  float sc[NT][2];
  if constexpr (!CL) lane_scales(sc, scale, sbf16, N, n0, t);
  float acc[MT][NT][4];
  zero(acc);
  for (int base = 0; base < chunks; base += WARPS * CPW) {
    Frag<MT, NT> f[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const int ch = base + c * WARPS + warp;
      load_frag<MT, NT, AL>(f[c], x, w, M, N, K, n0,
                            ch < chunks ? k0 + ch * 64 + t * 16 : k1, k1, g);
    }
#pragma unroll
    for (int c = 0; c < CPW; ++c) chunk_mma(acc, f[c]);
  }
  warp_sums(acc, red, warp, lane);
  if constexpr (!CL) {
    if (warp == 0) store_acc(y, M, N, n0, g, t, acc, sc);
  } else {
    if (warp == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            fin[((mt * NT + nt) * 4 + i) * 32 + lane] = acc[mt][nt][i];
    hl::cluster_arrive();
    hl::cluster_wait();                // every rank's partials are written
    for (int e = threadIdx.x * ncta + rank; e < MT * NT * 128;
         e += THREADS * ncta) {
      const uint32_t a = hl::smem_u32(fin + e);
      float v = 0.f;
      for (unsigned q = 0; q < ncta; ++q)
        v += hl::ld_cluster(hl::map_rank(a, q));
      const int ln = e % 32, i = e / 32 % 4, nt = e / 128 % NT, mt = e / 256;
      store_y(y, scale, sbf16, M, N, mt * 16 + ln / 4 + (i >= 2 ? 8 : 0),
              n0 + nt * 8 + 2 * (ln % 4) + (i & 1), v);
    }
    hl::cluster_arrive();
    hl::cluster_wait();                // the peers are done reading fin
  }
}

// q8_bulk, timed against q8_stripes by scripts/decode_probe.py (kind 2;
// no plan picks it): q8_stripes' block of a 16-column stripe without a
// cluster, aligned only, with the stripe's weight rows and x's rows
// brought into shared memory by cp.async.bulk, one copy a row, all on one
// mbarrier, then every fragment read from there. Rows are padded (64
// bytes a weight row, 16 an x row) so that a quarter warp's reads hit
// every bank once at K = 768. On an H100 it read 1.1 to 2.4 us slower
// than q8_stripes at M = 32 (x's rows, four times the stripe's bytes,
// all land before the first product) and within 0.3 us at M = 1
template <int MT, int CPW>
__global__ void __launch_bounds__(THREADS)
q8_bulk(const bf16* __restrict__ x, const int8_t* __restrict__ w,
        const void* __restrict__ scale, int sbf16, bf16* __restrict__ y,
        int M, int N, int K) {
  constexpr int NT = 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[WARPS - 1][MT][NT][4][32];
  __shared__ __align__(8) uint64_t bar;
  const int wld = K + 64, xld = 2 * K + 16;
  const unsigned char* ws = smem;                  // [16][wld]
  const unsigned char* xs = smem + 16 * wld;       // [M][xld]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * 8 * NT, nrow = min(8 * NT, N - n0);
  const uint32_t b = hl::smem_u32(&bar);
  if (threadIdx.x == 0) {
    hl::mbar_init(b, 1);
    hl::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) hl::mbar_expect_tx(b, (nrow + 2 * M) * K);
    __syncwarp();
    for (int r = lane; r < nrow + M; r += 32)
      if (r < nrow)
        hl::bulk_load(hl::smem_u32(ws + r * wld), w + (size_t)(n0 + r) * K,
                      K, b);
      else
        hl::bulk_load(hl::smem_u32(xs + (r - nrow) * xld),
                      x + (size_t)(r - nrow) * K, 2 * K, b);
  }
  float sc[NT][2];
  lane_scales(sc, scale, sbf16, N, n0, t);
  float acc[MT][NT][4];
  zero(acc);
  const int chunks = (K + 63) / 64;
  hl::mbar_wait(b, 0);
  for (int base = 0; base < chunks; base += WARPS * CPW) {
    Frag<MT, NT> f[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const int k = (base + c * WARPS + warp) * 64 + t * 16;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + g;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col < nrow && k < K)
          v = *reinterpret_cast<const uint4*>(ws + col * wld + k);
        f[c].w[nt][0] = v.x ^ 0x80808080u; f[c].w[nt][1] = v.y ^ 0x80808080u;
        f[c].w[nt][2] = v.z ^ 0x80808080u; f[c].w[nt][3] = v.w ^ 0x80808080u;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + 8 * half;
          uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
          if (r < M && k < K) {
            const uint4* src =
                reinterpret_cast<const uint4*>(xs + r * xld + 2 * k);
            v0 = src[0];
            v1 = src[1];
          }
          uint32_t* dst = half ? f[c].xb[mt] : f[c].xa[mt];
          dst[0] = v0.x; dst[1] = v0.y; dst[2] = v0.z; dst[3] = v0.w;
          dst[4] = v1.x; dst[5] = v1.y; dst[6] = v1.z; dst[7] = v1.w;
        }
    }
#pragma unroll
    for (int c = 0; c < CPW; ++c) chunk_mma(acc, f[c]);
  }
  warp_sums(acc, red, warp, lane);
  if (warp == 0) store_acc(y, M, N, n0, g, t, acc, sc);
}

// q8_persist's tiling: NW warps, WC column groups of NT 8-column tiles
// times WK = NW / WC k groups, each group every WK-th chunk, CPW chunks a
// round with all their loads from shared memory before the products; a
// tile is NB columns x K; x (16 MT x Kp, Kp = K rounded up to 64) stays in
// shared memory; a ring of 3 tiles
template <int MT, int NW, int WC, int NT, int CPW>
struct Persist {
  static constexpr int WK = NW / WC, NB = 8 * NT * WC, THREADS = 32 * NW;
  static constexpr int STAGES = 3;
  static int smem(int Kp) {
    return 16 * MT * Kp * 2 + STAGES * NB * Kp +
           (WK - 1) * WC * MT * NT * 128 * 4;
  }
};

template <int MT, int NW, int WC, int NT, int CPW>
__global__ void __launch_bounds__(32 * NW, 1)
q8_persist(const bf16* __restrict__ x, const int8_t* __restrict__ w,
           const void* __restrict__ scale, int sbf16, bf16* __restrict__ y,
           int M, int N, int K) {
  using P = Persist<MT, NW, WC, NT, CPW>;
  constexpr int WK = P::WK, NB = P::NB, STAGES = P::STAGES;
  constexpr int NTH = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Kp = (K + 63) / 64 * 64;
  const int xch = Kp / 8, wch = Kp / 16, nch = Kp / 64;
  uint4* xs = reinterpret_cast<uint4*>(smem);          // [16 MT][xch]
  uint4* ring = xs + 16 * MT * xch;                    // [STAGES][NB][wch]
  float* red = reinterpret_cast<float*>(ring + STAGES * NB * wch);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp % WC, kg = warp / WC;
  // rows of 128-byte multiples alternate their halves (2-way conflicts
  // otherwise); a row of 64 mod 128 bytes does so by itself
  const int wswz = Kp % 128 == 0 ? 4 : 0;
  const int ntile = (N + NB - 1) / NB;
  const int mine = (int)blockIdx.x < ntile
      ? (ntile - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  for (int i = tid; i < 16 * MT * xch; i += NTH) {
    const int r = i / xch, c = i % xch, k = c * 8;
    const bool ok = r < M && k < K;
    hl::cp_async16_zfill(xs + r * xch + (c ^ (r & 1)),
                     ok ? x + (size_t)r * K + k : x, ok);
  }
  auto load = [&](int s) {             // this block's tile s into its slot
    uint4* dst = ring + (s % STAGES) * NB * wch;
    const int n0 = (blockIdx.x + s * gridDim.x) * NB;
    for (int i = tid; i < NB * wch; i += NTH) {
      const int r = i / wch, c = i % wch, n = n0 + r, k = c * 16;
      const bool ok = n < N && k < K;
      hl::cp_async16_zfill(dst + r * wch + (c ^ ((r & 1) * wswz)),
                       ok ? w + (size_t)n * K + k : w, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {   // x joins the first group
    if (s < mine) load(s);
    hl::cp_async_commit();
  }
  for (int s = 0; s < mine; ++s) {
    hl::cp_async_wait<STAGES - 2>();
    __syncthreads();                   // tile s is in; slot s - 1 is free
    if (s + STAGES - 1 < mine) load(s + STAGES - 1);
    hl::cp_async_commit();
    const uint4* ws = ring + (s % STAGES) * NB * wch;
    const int n0 = (blockIdx.x + s * gridDim.x) * NB + wc * NT * 8;
    float sc[NT][2];
    if (kg == 0) lane_scales(sc, scale, sbf16, N, n0, t);
    float acc[MT][NT][4];
    zero(acc);
    for (int c0 = kg; c0 < nch; c0 += WK * CPW) {
      Frag<MT, NT> f[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int ch = min(c0 + c * WK, nch - 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = (wc * NT + nt) * 8 + g;
          const uint4 v =
              ws[col * wch + ((ch * 4 + t) ^ ((col & 1) * wswz))];
          f[c].w[nt][0] = v.x ^ 0x80808080u;
          f[c].w[nt][1] = v.y ^ 0x80808080u;
          f[c].w[nt][2] = v.z ^ 0x80808080u;
          f[c].w[nt][3] = v.w ^ 0x80808080u;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + g + 8 * half;
            const uint4* row = xs + r * xch;
            const uint4 v0 = row[(ch * 8 + 2 * t) ^ (r & 1)];
            const uint4 v1 = row[(ch * 8 + 2 * t + 1) ^ (r & 1)];
            uint32_t* dst = half ? f[c].xb[mt] : f[c].xa[mt];
            dst[0] = v0.x; dst[1] = v0.y; dst[2] = v0.z; dst[3] = v0.w;
            dst[4] = v1.x; dst[5] = v1.y; dst[6] = v1.z; dst[7] = v1.w;
          }
      }
#pragma unroll
      for (int c = 0; c < CPW; ++c)
        if (c0 + c * WK < nch) chunk_mma(acc, f[c]);
    }
    // the k groups' sums in group order
    if (kg > 0) {
      float* r = red + ((kg - 1) * WC + wc) * MT * NT * 128;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[((mt * NT + nt) * 4 + i) * 32 + lane] = acc[mt][nt][i];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = acc[mt][nt][i];
#pragma unroll
            for (int q = 1; q < WK; ++q)
              v[i] += red[((q - 1) * WC + wc) * MT * NT * 128 +
                          ((mt * NT + nt) * 4 + i) * 32 + lane];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store_pair(y, M, N, mt * 16 + g + 8 * h, n0 + nt * 8 + 2 * t,
                       v[2 * h], v[2 * h + 1], sc[nt]);
        }
    }
  }
}

// fp32 x: one warp an output column; each lane 4 k values at a time
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
q8_fp32(const float* __restrict__ x, const int8_t* __restrict__ w,
        const void* __restrict__ scale, int sbf16, float* __restrict__ y,
        int M, int N, int K) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + threadIdx.x / 32;
  if (n >= N) return;
  const int8_t* wr = w + (size_t)n * K;
  const float s = scale_at(scale, sbf16, n);
  for (int m = 0; m < M; ++m) {
    const float* xr = x + (size_t)m * K;
    float acc = 0.f;
    for (int k = 4 * lane; k < K; k += 128) {
      if (ALIGNED) {
        const char4 wv = *reinterpret_cast<const char4*>(wr + k);
        const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + k));
        acc = fmaf(xv.x, static_cast<float>(wv.x), acc);
        acc = fmaf(xv.y, static_cast<float>(wv.y), acc);
        acc = fmaf(xv.z, static_cast<float>(wv.z), acc);
        acc = fmaf(xv.w, static_cast<float>(wv.w), acc);
      } else {
        for (int e = 0; e < 4 && k + e < K; ++e)
          acc = fmaf(xr[k + e], static_cast<float>(wr[k + e]), acc);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) y[(size_t)m * N + n] = acc * s;
  }
}

template <typename... Args>
cudaError_t launch(void (*kernel)(Args...), int grid, int threads, int cl,
                   int smem, cudaStream_t stream, const void* x,
                   const void* w, const void* scale, int sbf16, void* y,
                   int M, int N, int K, int kr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  if constexpr (sizeof...(Args) == 9)      // q8_stripes takes kr
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                              static_cast<const int8_t*>(w), scale, sbf16,
                              static_cast<bf16*>(y), M, N, K, kr);
  else
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                              static_cast<const int8_t*>(w), scale, sbf16,
                              static_cast<bf16*>(y), M, N, K);
}

// kind 1: q8_persist (aligned, at most 32 rows; 16 warps: 4 column groups
// of 16 columns times 4 k groups, a chunk at a time); kind 0:
// q8_stripes, two chunks a warp a round up to 32 rows of x, else one;
// kind 2: q8_bulk (aligned, no cluster, a block a stripe)
template <int MT>
cudaError_t launch_bf16(int kind, int grid, int cl, int kr, bool aligned,
                        const void* x, const void* w, const void* scale,
                        int sbf16, void* y, int M, int N, int K,
                        cudaStream_t s) {
  constexpr int CPW = MT <= 2 ? 2 : 1;
  if (kind == 1) {
    if constexpr (MT <= 2) {
      using P = Persist<MT, 16, 4, 2, 1>;
      if (!aligned) return cudaErrorInvalidValue;
      auto* kernel = q8_persist<MT, 16, 4, 2, 1>;
      const int smem = P::smem((K + 63) / 64 * 64);
      static unsigned done = 0;
      const cudaError_t err =
          hl::allow_smem(done, reinterpret_cast<const void*>(kernel), smem);
      if (err != cudaSuccess) return err;
      return launch(kernel, grid, P::THREADS, 1, smem, s, x, w, scale,
                    sbf16, y, M, N, K, 0);
    }
    return cudaErrorInvalidValue;      // x of more than 32 rows: stripes
  }
  if (kind == 2) {
    // a bound under a block's 227 KB less q8_bulk's static red and bar
    constexpr int most = 200 * 1024;
    const int smem = 16 * (K + 64) + M * (2 * K + 16);
    if (!aligned || cl != 1 || grid != (N + 15) / 16 || smem > most)
      return cudaErrorInvalidValue;
    auto* kernel = q8_bulk<MT, CPW>;
    static unsigned done = 0;
    const cudaError_t err =
        hl::allow_smem(done, reinterpret_cast<const void*>(kernel), most);
    if (err != cudaSuccess) return err;
    return launch(kernel, grid, THREADS, 1, smem, s, x, w, scale, sbf16, y,
                  M, N, K, 0);
  }
  if (cl > 1)
    return aligned ? launch(q8_stripes<MT, CPW, true, true>, grid, THREADS,
                            cl, 0, s, x, w, scale, sbf16, y, M, N, K, kr)
                   : launch(q8_stripes<MT, CPW, false, true>, grid, THREADS,
                            cl, 0, s, x, w, scale, sbf16, y, M, N, K, kr);
  return aligned ? launch(q8_stripes<MT, CPW, true, false>, grid, THREADS, 1,
                          0, s, x, w, scale, sbf16, y, M, N, K, kr)
                 : launch(q8_stripes<MT, CPW, false, false>, grid, THREADS,
                          1, 0, s, x, w, scale, sbf16, y, M, N, K, kr);
}

__global__ void empty() {}

}  // namespace

// x (M, K) bf16 (x_bf16 != 0) or fp32, w (N, K) int8, scale (N,) bf16
// (scale_bf16 != 0) or fp32, y (M, N) in x's dtype; all contiguous; 1 <=
// M <= 64; aligned != 0 when K % 16 == 0 and x and w are 16-byte aligned.
// bf16 x takes a plan (ops/q8_matmul_cuda.py plan): kind 1 for the
// persistent 64-column tiles (aligned only), 0 for the 16-column
// stripes; grid blocks in clusters of cl (kind 0; grid a multiple of cl),
// each cluster rank taking kr of K (a multiple of 64, cl kr >= K); kind 2
// (q8_bulk, which no plan picks) a block a stripe, aligned, cl 1.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a shape or
// a plan it does not take).
extern "C" int hl_q8_matmul(const void* x, const void* w, const void* scale,
                            void* y, int M, int N, int K, int x_bf16,
                            int scale_bf16, int aligned, int kind, int grid,
                            int cl, int kr, void* stream) {
  if (M < 1 || M > MAX_ROWS || N < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (grid < 1 || cl < 1 || cl > 4 || grid % cl || kr < 1 || kr % 64 ||
        (kind == 0 && (long long)kr * cl < K) || (kind == 1 && cl != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch ((M + 15) / 16) {
      case 1: err = launch_bf16<1>(kind, grid, cl, kr, aligned, x, w, scale,
                                   scale_bf16, y, M, N, K, s);
              break;
      case 2: err = launch_bf16<2>(kind, grid, cl, kr, aligned, x, w, scale,
                                   scale_bf16, y, M, N, K, s);
              break;
      case 3: err = launch_bf16<3>(kind, grid, cl, kr, aligned, x, w, scale,
                                   scale_bf16, y, M, N, K, s);
              break;
      default:
        err = launch_bf16<4>(kind, grid, cl, kr, aligned, x, w, scale,
                             scale_bf16, y, M, N, K, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const dim3 grid((N + WARPS - 1) / WARPS);
    const auto* xf = static_cast<const float*>(x);
    const auto* wb = static_cast<const int8_t*>(w);
    auto* yf = static_cast<float*>(y);
    if (aligned)
      q8_fp32<true><<<grid, THREADS, 0, s>>>(xf, wb, scale, scale_bf16, yf,
                                             M, N, K);
    else
      q8_fp32<false><<<grid, THREADS, 0, s>>>(xf, wb, scale, scale_bf16, yf,
                                              M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, one block of 32 threads: timed beside K13, it is the
// floor that a launch costs on this card under the same timing.
extern "C" int hl_empty(void* stream) {
  empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
