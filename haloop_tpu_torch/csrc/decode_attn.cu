// One-token decode attention over a flat (B, S, E) KV cache, with the new
// token's k/v row written into the cache.
//
// Replaces: haloop_tpu/ops/decode_attn.py _kernel (launched by
// decode_attend_update). Plain version: haloop_tpu_torch/ops/
// decode_attn.py decode_attend.
//
// Computes, for each row b and head h (D = E / H):
//   k_cache[b, length] = k_new[b]; v_cache[b, length] = v_new[b]
//   s[j] = (q[b, h] . k_cache[b, j, h]) / sqrt(D) in fp32 for
//          starts[b] <= j <= length (the rest is not attended);
//   p = softmax(s) in fp32, the normalized p rounded to the cache dtype
//       (the TPU kernel's (e / l).astype(v.dtype));
//   y[b, h] = sum_j p[j] v_cache[b, j, h], summed in fp32, in the cache
//   dtype.
// Only the new row is written: the TPU kernel's write-back of the whole
// cache through its output alias is not copied.
//
// What bounds it on the H100: the cache rows it reads. At hat --batch
// (B=32, 12 heads of 64, bf16) a step at fill level L reads
// 2 x 32 x (L + 1) x 1.5 KB: 9.5 MB at L = 96, 2.8 us at 3.35 TB/s; at
// B=1 and L = 1000 (GPT-2 small's longest fill) 3 MB, 0.9 us. The
// arithmetic is negligible, so the design is about having every byte in
// flight at once and no long chain of dependent loads, instructions or
// barriers behind them.
//
// This design: a block of 256 threads (8 warps) per (head, row), or, on
// the tensor cores, a thread-block cluster of C blocks that split the
// (head, row)'s attended rows into C contiguous runs
// (ops/decode_attn_cuda.py plan: C > 1 only where B H blocks leave the
// card's SMs idle and the fill reaches 640 rows). At hat's shapes a block's
// chain of dependent instructions, not its bytes, set the CUDA-core
// version's time (a row step's loads, converts, products and shuffles with
// one or two warps a sub-partition), so in bf16 with heads of 32, 64 or
// 128 (gpt-nano's, GPT-2's) the products run on the tensor cores
// (`decode_tc`; a block's q . k and p . v then take a sixth of its cycles
// at hat's B=32: scripts/decode_probe.py --phases), elsewhere on the CUDA
// cores (`decode`: fp32, narrower heads; one block a (head, row)). Both:
// - take D as a template parameter, so every loop over a row unrolls;
// - request every chunk of k and then of v a thread (or warp) takes by
//   cp.async into its own slots of a ring in shared memory, all at once
//   behind one wait where they fit the ring (hat's fills), else streaming
//   a few slots ahead, so the v chunks land while the scores are
//   computed; a slot is read only by the lanes (the warp) that requested
//   it, so the ring needs no block barrier. Rows outside [start, length]
//   are zero-filled, not read; row `length` is never read from the cache
//   but staged from k_new / v_new (the TPU kernel's jnp.where(is_new, kn,
//   kc)), and the block that holds it writes it into the cache;
// - keep the scores, in log2 units (the scale carries log2 e), in shared
//   memory; the max and then the sum of e = 2^(s - max) each take a
//   warp's shuffle tree and one shared exchange (one barrier); in a
//   cluster each block's (max, sum) goes to its peers through distributed
//   shared memory behind a cluster barrier, and every block takes all of
//   them in rank order. p = e (1 / sum) is rounded to the cache dtype
//   where p . v reads it: every block rounds the same normalized p;
// - add the warps' p . v sums in warp order and the cluster's blocks' in
//   rank order (rank 0 reads its peers' through distributed shared memory
//   and writes y). The bits do not depend on timing; one launch a call.
// `decode_tc`: a warp takes chunks of 16 rows (chunk i of the block to warp
// i % 8), each a slot of 16 rows x D with the 16-byte pieces of a row
// XOR-swizzled by its row (ldmatrix without bank conflicts); q . k is
// mma.sync m16n8k16 with q as row 0 of A and the chunk's rows as two
// 8-column tiles of B (ldmatrix), so lanes 0-3 hold the chunk's 16 scores;
// p . v takes the chunk's rounded p as row 0 of A (the same lanes and
// positions) and its v rows as B (ldmatrix.trans), fp32 sums. `decode`:
// a row is read by G = D / VEC lanes (VEC values, 16 bytes, a lane), R =
// 32 / G rows a warp step, the warps taking the steps in turn; q . k is a
// lane's VEC products summed over the row's lanes by a fixed shuffle tree,
// p . v reads v 16 bytes a lane into VEC fp32 sums, the warp's row groups
// summed by a butterfly.
// scripts/decode_probe.py --phases builds decode_tc with its phase stamps
// (-DHL_PHASES, sm90.cuh stamp / keep_phase) and reads them through
// hl_k11_phases.
//
// Kernel K12, the same function over a cache past the JAX package's
// 10 MiB a row for K11 (replaces haloop_tpu/ops/decode_attn.py
// _kernel_gridded, launched by decode_attend_update_gridded; plain
// version the same decode_attend). The TPU kernel walks S in blocks on
// one core, carrying a running max, sum and accumulator (online softmax).
// Here S is cut into splits of `rows` rows that run in parallel
// (flash-decoding): grid (split, head, batch row), with the split size
// picked by the wrapper from the card's SM count (decode_attn_cuda.py
// split_rows). Bound: the attended rows' k and v, 2 x 32 x 4001 x 1.5 KB
// = 393 MB at B=32 and a fill level of 4000 (117 us at 3.35 TB/s), so the
// design is about bytes in flight and one pass over them:
// - the head width D is a template parameter (8 to 128 in bf16, 4 to 128
//   in fp32), so every loop over a row unrolls;
// - each split is one pass: tiles of TILE rows of k and v (16 KB a tile)
//   go through a ring of STAGES slots in shared memory by cp.async, every
//   thread 4 + 4 16-byte copies a tile, two tiles in flight behind the one
//   being read; rows outside [starts[b], length] are zero-filled, not read;
// - a row is read by a group of G = D / VEC lanes (VEC values, 16 bytes, a
//   lane), R = 32 / G rows a warp at once, ITER times a tile: q . k is a
//   lane's VEC products summed over the group by a fixed shuffle tree, and
//   p . v reads v 16 bytes a lane into VEC fp32 sums;
// - each warp keeps its own running max m, sum l and unnormalized D-wide
//   accumulator in fp32 (p is never rounded to bf16, as in the TPU
//   kernel), updated once a tile; scores are kept in log2 units (the scale
//   carries log2 e) for exp2; at the split's end the warp's row groups
//   are summed by a butterfly and the four warps combined in warp order;
// - the new row: the split that holds row `length` writes k_new / v_new
//   there with ordinary stores, and its tile takes that row from k_new /
//   v_new (the TPU kernel's jnp.where(is_new, kn, kc)): the loads leave
//   the row out, and once the tile is in, its first G threads write k_new's
//   and v_new's chunks into the tile in shared memory. The row is never
//   loaded from the cache, so no load can see it stale;
// - one launch a call: each split writes its (m, l, acc) to `part` and
//   counts itself in a per-(b, h) counter (threadfence, then atomicAdd);
//   the split that counts last merges every split's partial in split
//   order, m* = max m_i, y = sum_i acc_i 2^(m_i - m*) / sum_i l_i
//   2^(m_i - m*) (the weights 128 splits at a time in shared memory, the
//   sums' loads unrolled), writes y and sets the counter back to 0 for the
//   next call. The bits do not depend on which split finishes last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128, WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[N]) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = to_f(v[e]);
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool max_) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = max_ ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                   // red's previous readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < WARPS; ++i) v = max_ ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

// K11's CUDA-core kernel's shapes for one (T, D): see the design note
constexpr int K11_THREADS = 256, K11_WARPS = K11_THREADS / 32;
template <typename T, int D>
struct K11 {
  static constexpr int VEC = 16 / sizeof(T);    // values a 16-byte chunk
  static constexpr int G = D / VEC;             // lanes a row
  static constexpr int R = 32 / G;              // rows a warp step
  static constexpr int STEP = K11_WARPS * R;    // rows a step of every warp
  static_assert(D % VEC == 0 && 32 % G == 0, "tiling");
};
// a thread's ring slots when its chunks stream (ops/decode_attn_cuda.py
// K11_DEPTH; a power of two); fewer when they all fit at once
constexpr int K11_DEPTH = 16;
// the most dynamic shared memory a plan takes: a block's 227 KB less the
// kernel's static arrays (at most 4.6 KB at D = 128)
constexpr int K11_SMEM = 225280;

// K11's exchanges, shared by its two kernels. The block's max of `v` (each
// warp's lane 0 holding its warp's, in red[warp]), then over the cluster's
// blocks through distributed shared memory, in rank order; `stat` is the
// block's cell its peers read. Ends behind a block (or cluster) barrier.
template <bool CL>
__device__ __forceinline__ float k11_max(float v, float* red, float* stat,
                                         int nr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < K11_WARPS; ++w) v = fmaxf(v, red[w]);
  if (CL) {
    if (threadIdx.x == 0) *stat = v;
    hl::cluster_arrive();
    hl::cluster_wait();
    const uint32_t a = hl::smem_u32(stat);
    v = -INFINITY;
    for (int r = 0; r < nr; ++r)
      v = fmaxf(v, hl::ld_cluster(hl::map_rank(a, r)));
  }
  return v;
}

// e = 2^(s - mx) over the block's `nrow` scores in sc (a thread the rows
// tid, tid + K11_THREADS, ...), written back; their sum over the block in
// a fixed order, then over the cluster's blocks in rank order
template <bool CL>
__device__ __forceinline__ float k11_sum(float* sc, int nrow, float mx,
                                         float* red, float* stat, int nr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float v = 0.f;
  for (int r = threadIdx.x; r < nrow; r += K11_THREADS) {
    const float e = exp2f(sc[r] - mx);
    sc[r] = e;
    v += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < K11_WARPS; ++w) v += red[w];
  if (CL) {
    if (threadIdx.x == 0) *stat = v;
    hl::cluster_arrive();
    hl::cluster_wait();
    const uint32_t a = hl::smem_u32(stat);
    v = 0.f;
    for (int r = 0; r < nr; ++r) v += hl::ld_cluster(hl::map_rank(a, r));
  }
  return v;
}

// y's D values of the (row, head): the warps' p . v sums (wacc[warp][d],
// complete) added in warp order, then the cluster's blocks in rank order
// (rank 0 reads its peers' through distributed shared memory and writes)
template <typename T, int D, bool CL>
__device__ __forceinline__ void k11_store(const float (*wacc)[D],
                                          float* bacc, T* y, int rank,
                                          int nr) {
  const int tid = threadIdx.x;
  __syncthreads();
  float out = 0.f;
  if (tid < D) {
    out = wacc[0][tid];
#pragma unroll
    for (int w = 1; w < K11_WARPS; ++w) out += wacc[w][tid];
  }
  if (CL) {
    if (tid < D) bacc[tid] = out;
    hl::cluster_arrive();
    hl::cluster_wait();
    if (rank == 0 && tid < D) {
      const uint32_t a = hl::smem_u32(bacc + tid);
      out = 0.f;
      for (int r = 0; r < nr; ++r) out += hl::ld_cluster(hl::map_rank(a, r));
    }
    hl::cluster_arrive();              // peers' shared memory read: exit
    hl::cluster_wait();
  }
  if (rank == 0 && tid < D) y[tid] = from_f<T>(out);
}

// K11 on the CUDA cores: one block a (head, batch row). ring:
// [depth][K11_THREADS] 16-byte slots; sc: [span] scores of the attended
// rows, then their e = 2^(s - max).
template <typename T, int D>
__global__ void __launch_bounds__(K11_THREADS)
decode(const T* __restrict__ q, const T* __restrict__ kn,
       const T* __restrict__ vn, T* kc, T* vc,
       const int* __restrict__ starts, T* __restrict__ y, int S, int E,
       int H, int length, int q_sb, int kn_sb, int vn_sb, float scale,
       int span, int depth) {
  using P = K11<T, D>;
  constexpr int VEC = P::VEC, G = P::G, R = P::R, STEP = P::STEP;
  constexpr int NT = K11_THREADS, NW = K11_WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* sc = reinterpret_cast<float*>(smem + (size_t)depth * NT * 16);
  __shared__ float red_m[NW], red_l[NW];
  __shared__ float wacc[NW][D];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % G, rr = lane / G;
  // the attended rows [lo, hi]
  const int lo = starts ? max(starts[b], 0) : 0, hi = length;
  T* kb = kc + (size_t)b * S * E + h * D;
  T* vb = vc + (size_t)b * S * E + h * D;

  // this warp's steps w, w + NW, ...: the lane's rows j0, j0 + STEP, ...;
  // units 0 .. nw-1 its k chunks, nw .. 2 nw - 1 its v chunks, unit u in
  // slot u % K11_DEPTH
  const int steps = lo <= hi ? (hi - lo) / R + 1 : 0;
  const int nw = steps > warp ? (steps - warp + NW - 1) / NW : 0;
  const int nu = 2 * nw;
  const bool whole = nu <= depth;      // every chunk in flight at once
  const int j0 = lo + warp * R + rr;
  uint4* slots = ring + tid;
  auto issue = [&](int u) {
    const bool kpart = u < nw;
    const int j = j0 + (kpart ? u : u - nw) * STEP;
    const bool ok = j <= hi && j != length;
    hl::cp_async16_zfill(slots + (u & (K11_DEPTH - 1)) * NT,
                         (kpart ? kb : vb) + (size_t)(ok ? j : lo) * E +
                             c * VEC,
                         ok);
  };
  if (whole) {
    for (int u = 0; u < nu; ++u) issue(u);
    hl::cp_async_commit();
  } else {
#pragma unroll
    for (int u = 0; u < K11_DEPTH - 1; ++u) {
      issue(u);                          // nu > depth = K11_DEPTH
      hl::cp_async_commit();
    }
  }

  // q and the new row's chunk c, requested behind the cache's chunks; the
  // block that holds row `length` writes it into the cache
  float qf[VEC];
  alignas(16) T knc[VEC], vnc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int d = h * D + c * VEC + e;
    qf[e] = to_f(q[(size_t)b * q_sb + d]);
    knc[e] = kn[(size_t)b * kn_sb + d];
    vnc[e] = vn[(size_t)b * vn_sb + d];
  }
  const uint4 kraw = *reinterpret_cast<const uint4*>(knc);
  const uint4 vraw = *reinterpret_cast<const uint4*>(vnc);
  if (lo <= length && length <= hi && tid < G) {
    *reinterpret_cast<uint4*>(kb + (size_t)length * E + tid * VEC) = kraw;
    *reinterpret_cast<uint4*>(vb + (size_t)length * E + tid * VEC) = vraw;
  }
  if (whole) hl::cp_async_wait<0>();

  // unit u's chunk: all in flight, landed behind the one wait above;
  // streaming, landed behind a wait that leaves the later 15 pending, the
  // slot refilled being the one this thread read one unit ago (before the
  // __syncwarp). Each loop below runs once in each mode, so that the
  // whole mode's iterations have no wait between them.
  auto fetch = [&](int u) {
    __syncwarp();
    if (u + K11_DEPTH - 1 < nu) issue(u + K11_DEPTH - 1);
    hl::cp_async_commit();
    hl::cp_async_wait<K11_DEPTH - 1>();
    return slots[(u & (K11_DEPTH - 1)) * NT];
  };

  // q . k: scores in log2 units to shared memory, this lane's max
  float mx = -INFINITY;
  auto score = [&](int i, const uint4& raw) {
    const int j = j0 + i * STEP;
    float kf[VEC];
    unpack<T>(j == length ? kraw : raw, kf);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (j <= hi) {
      const float s = dot * scale;
      if (c == 0) sc[j - lo] = s;
      mx = fmaxf(mx, s);
    }
  };
  if (whole) {
#pragma unroll 4
    for (int i = 0; i < nw; ++i) score(i, slots[i * NT]);
  } else {
    for (int i = 0; i < nw; ++i) score(i, fetch(i));
  }
  // behind the scores' barrier
  mx = k11_max<false>(mx, red_m, nullptr, 1);
  const float sum = k11_sum<false>(sc, hi - lo + 1, mx, red_l, nullptr, 1);

  // p . v with p = e / sum rounded to the cache dtype
  const float inv = 1.f / sum;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  auto accumulate = [&](int i, const uint4& raw) {
    const int j = j0 + i * STEP;
    const float p = j <= hi ? to_f(from_f<T>(sc[j - lo] * inv)) : 0.f;
    float vf[VEC];
    unpack<T>(j == length ? vraw : raw, vf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
  };
  if (whole) {
#pragma unroll 4
    for (int i = 0; i < nw; ++i) accumulate(i, slots[(nw + i) * NT]);
  } else {
    for (int i = 0; i < nw; ++i) accumulate(i, fetch(nw + i));
  }
  // the warp's row groups (a butterfly: every lane the same bits), then
  // the warps in warp order
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane < G)
#pragma unroll
    for (int e = 0; e < VEC; ++e) wacc[warp][c * VEC + e] = acc[e];
  k11_store<T, D, false>(wacc, nullptr, y + (size_t)b * E + h * D, 0, 1);
}

// K11 on the tensor cores (bf16, D = 32, 64 or 128): each warp takes chunks
// of 16 rows (chunk i of the block to warp i % 8), staged by cp.async in
// its own ring of `depth` slots, each slot a chunk's 16 rows of D values
// with the 16-byte pieces of a row XOR-swizzled by its row (tc_swz:
// ldmatrix without bank conflicts). q . k: mma.sync m16n8k16 with q as
// row 0 of A, a chunk's 16 rows as two 8-column tiles of B (ldmatrix);
// p . v: the chunk's p, rounded to bf16, as row 0 of A (lanes 0-3 hold
// exactly the scores' C fragments' positions), the chunk's v as B
// (ldmatrix.trans), fp32 sums.
constexpr int TC_ROWS = 16;     // rows a chunk
constexpr int TC_DEPTH = 4;     // a warp's ring slots when its chunks stream

// two consecutive bf16 values, the first in the low half
__device__ __forceinline__ uint32_t pair(const bf16* p) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) |
         ((uint32_t)__bfloat16_as_ushort(p[1]) << 16);
}

// piece `piece` of row r in a slot: rows of 128 bytes or more XOR their
// pieces with r % 8; rows of 64 bytes (D = 32), two to a 128-byte line,
// with r / 2 % 4. Either way the eight rows an ldmatrix reads at one piece
// land in eight different 16-byte bank groups.
template <int D>
__device__ __forceinline__ uint32_t tc_swz(int r, int piece) {
  const int x = D >= 64 ? (r & 7) : ((r >> 1) & 3);
  return r * (2 * D) + ((piece ^ x) << 4);
}

template <int D, bool CL>
__global__ void __launch_bounds__(K11_THREADS)
decode_tc(const bf16* __restrict__ q, const bf16* __restrict__ kn,
          const bf16* __restrict__ vn, bf16* kc, bf16* vc,
          const int* __restrict__ starts, bf16* __restrict__ y, int S, int E,
          int H, int length, int q_sb, int kn_sb, int vn_sb, float scale,
          int span, int depth) {
  constexpr int PIECES = D / 8;                  // 16 bytes of a row
  constexpr int SLOT = TC_ROWS * 2 * D;          // bytes a chunk
  constexpr int PER = TC_ROWS * PIECES / 32;     // pieces a lane a chunk
  constexpr int NW = K11_WARPS;
  static_assert(D % 32 == 0 && PIECES <= 32 && 32 % PIECES == 0, "tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red_m[NW], red_l[NW];
  __shared__ float wacc[NW][D];
  __shared__ float stat[2];
  __shared__ float bacc[CL ? D : 1];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long t0 = hl::stamp();
  const int rank = CL ? (int)hl::cluster_rank() : 0;
  const int nr = CL ? (int)hl::cluster_blocks() : 1;
  const int start = starts ? max(starts[b], 0) : 0;
  const int n = length - start + 1;
  const int per = ((n + nr - 1) / nr + TC_ROWS - 1) / TC_ROWS * TC_ROWS;
  const int lo = start + rank * per, hi = min(lo + per - 1, length);
  bf16* kb = kc + (size_t)b * S * E + h * D;
  bf16* vb = vc + (size_t)b * S * E + h * D;
  unsigned char* ring = smem + (size_t)warp * depth * SLOT;
  float* sc = reinterpret_cast<float*>(smem + (size_t)NW * depth * SLOT);

  // this warp's chunks: units 0 .. nc-1 their k, nc .. 2 nc - 1 their v;
  // unit u in slot u % TC_DEPTH (whole: u < depth <= TC_DEPTH)
  const int chunks = lo <= hi ? (hi - lo) / TC_ROWS + 1 : 0;
  const int nc = chunks > warp ? (chunks - warp + NW - 1) / NW : 0;
  const int nu = 2 * nc;
  const bool whole = nu <= depth;
  const int piece = lane % PIECES;     // the same piece of every row a lane
  // the new row's piece, for the lanes that stage row `length`
  alignas(16) bf16 knc[8], vnc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    knc[e] = kn[(size_t)b * kn_sb + h * D + piece * 8 + e];
    vnc[e] = vn[(size_t)b * vn_sb + h * D + piece * 8 + e];
  }
  const uint4 knp = *reinterpret_cast<const uint4*>(knc);
  const uint4 vnp = *reinterpret_cast<const uint4*>(vnc);
  auto issue = [&](int u) {
    const bool kpart = u < nc;
    const int row0 = lo + (warp + (kpart ? u : u - nc) * NW) * TC_ROWS;
    unsigned char* slot = ring + (u & (TC_DEPTH - 1)) * SLOT;
    const bf16* src = kpart ? kb : vb;
#pragma unroll
    for (int x = 0; x < PER; ++x) {
      const int r = (lane + 32 * x) / PIECES;
      const int j = row0 + r;
      void* dst = slot + tc_swz<D>(r, piece);
      if (j == length)           // never read from the cache
        *reinterpret_cast<uint4*>(dst) = kpart ? knp : vnp;
      else
        hl::cp_async16_zfill(dst, src + (size_t)(j <= hi ? j : lo) * E +
                                      piece * 8,
                             j <= hi);
    }
  };
  if (whole) {
    for (int u = 0; u < nu; ++u) issue(u);
    hl::cp_async_commit();
  } else {
#pragma unroll
    for (int u = 0; u < TC_DEPTH - 1; ++u) {
      issue(u);                          // nu > depth = TC_DEPTH
      hl::cp_async_commit();
    }
  }
  const long long t1 = hl::stamp();
  if (lo <= length && length <= hi && tid < PIECES) {   // the new row
    *reinterpret_cast<uint4*>(kb + (size_t)length * E + tid * 8) = knp;
    *reinterpret_cast<uint4*>(vb + (size_t)length * E + tid * 8) = vnp;
  }
  // q as row 0 of A, a k16 step a register pair (lanes 0-3; zeros else)
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* qp = q + (size_t)b * q_sb + h * D + 16 * ks + 2 * t;
    qa[ks][0] = g == 0 ? pair(qp) : 0u;
    qa[ks][1] = g == 0 ? pair(qp + 8) : 0u;
  }
  if (whole) {
    hl::cp_async_wait<0>();
    __syncwarp();                        // every lane's pieces landed
  }
  const long long t2 = hl::stamp();
  // unit u's slot, landed (streaming: the slot refilled is the one the warp
  // read one unit ago, behind the first __syncwarp)
  auto fetch = [&](int u) {
    if (!whole) {
      __syncwarp();
      if (u + TC_DEPTH - 1 < nu) issue(u + TC_DEPTH - 1);
      hl::cp_async_commit();
      hl::cp_async_wait<TC_DEPTH - 1>();
      __syncwarp();
    }
    return ring + (u & (TC_DEPTH - 1)) * SLOT;
  };

  // q . k: a chunk's scores in lanes 0-3 (rows 8 nt + 2 t, + 1 of tile nt)
  float mx = -INFINITY;
  const int lrow = lane % 8, lmat = lane / 8;    // ldmatrix: the row a lane
  for (int i = 0; i < nc; ++i) {
    const unsigned char* slot = fetch(i);
    const int row0 = lo + (warp + i * NW) * TC_ROWS;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t bq[4];      // pieces 4 kk .. 4 kk + 3 of rows 8 nt + 0..7
        hl::ldsm_x4(bq, slot + tc_swz<D>(8 * nt + lrow, 4 * kk + lmat));
        const uint32_t a0[4] = {qa[2 * kk][0], 0u, qa[2 * kk][1], 0u};
        const uint32_t a1[4] = {qa[2 * kk + 1][0], 0u, qa[2 * kk + 1][1],
                                0u};
        hl::mma_bf16(c[nt], a0, bq[0], bq[1]);
        hl::mma_bf16(c[nt], a1, bq[2], bq[3]);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = row0 + 8 * nt + 2 * t + e;
          if (j <= hi) {
            const float s = c[nt][e] * scale;
            sc[j - lo] = s;
            mx = fmaxf(mx, s);
          }
        }
    }
  }
  const long long t3 = hl::stamp();
  mx = k11_max<CL>(mx, red_m, stat, nr);   // behind the scores' barrier
  const long long t4 = hl::stamp();
  const float inv =
      1.f / k11_sum<CL>(sc, hi - lo + 1, mx, red_l, stat + 1, nr);
  const long long t5 = hl::stamp();

  // p . v: the chunk's p (rounded to bf16) as row 0 of A
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int i = 0; i < nc; ++i) {
    const unsigned char* slot = fetch(nc + i);
    const int row0 = lo + (warp + i * NW) * TC_ROWS;
    uint32_t pa[4] = {0u, 0u, 0u, 0u};
    if (g == 0) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = row0 + 2 * t + (e & 1) + 8 * (e >> 1);
        p[e] = j <= hi ? sc[j - lo] * inv : 0.f;
      }
      pa[0] = hl::pack_bf16(p[0], p[1]);
      pa[2] = hl::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      uint32_t bv[4];   // rows (lmat & 1) 8 + 0..7 of pieces 2 m, 2 m + 1
      hl::ldsm_x4_t(bv, slot + tc_swz<D>((lmat & 1) * 8 + lrow,
                                         2 * m + (lmat >> 1)));
      hl::mma_bf16(acc[2 * m], pa, bv[0], bv[1]);
      hl::mma_bf16(acc[2 * m + 1], pa, bv[2], bv[3]);
    }
  }
  const long long t6 = hl::stamp();
  if (g == 0)
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      wacc[warp][8 * nt + 2 * t] = acc[nt][0];
      wacc[warp][8 * nt + 2 * t + 1] = acc[nt][1];
    }
  k11_store<bf16, D, CL>(wacc, bacc, y + (size_t)b * E + h * D, rank, nr);
  // the --phases build's cycles of this block: issue, q and landing, q . k,
  // max, sum, p . v, store
  const long long t7 = hl::stamp();
  const int bid = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                  blockIdx.x;
  const long long ts[8] = {t0, t1, t2, t3, t4, t5, t6, t7};
#pragma unroll
  for (int k = 1; k < 8; ++k) hl::keep_phase(tid == 0, k - 1, bid,
                                             ts[k] - ts[k - 1]);
}

int k11_kernels = 0;                   // K11 kernels launched (host side)

template <typename T, int D>
cudaError_t run_d(const void* q, const void* kn, const void* vn, void* kc,
                  void* vc, const int* starts, void* y, int B, int S, int E,
                  int H, int length, int q_sb, int kn_sb, int vn_sb,
                  int cluster, int span, int depth, int smem,
                  cudaStream_t stream) {
  using P = K11<T, D>;
  // the plan's span and depth for this fill (decode_attn_cuda.plan): one
  // block a (head, row) on the CUDA cores
  const int units = 2 * ((span / P::R + K11_WARPS - 1) / K11_WARPS);
  if (cluster != 1 || span < length + 1 || span % P::STEP ||
      depth != (units < K11_DEPTH ? units : K11_DEPTH) ||
      smem != depth * K11_THREADS * 16 + span * 4 || smem > K11_SMEM)
    return cudaErrorInvalidValue;
  const float scale = 1.4426950408889634f / sqrtf((float)D);
  static unsigned done = 0;
  cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(decode<T, D>), K11_SMEM);
  if (err != cudaSuccess) return err;
  decode<T, D><<<dim3(1, H, B), K11_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kc), static_cast<T*>(vc),
      starts, static_cast<T*>(y), S, E, H, length, q_sb, kn_sb, vn_sb, scale,
      span, depth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++k11_kernels;
  return cudaSuccess;
}

template <int D>
cudaError_t run_tc(const void* q, const void* kn, const void* vn, void* kc,
                   void* vc, const int* starts, void* y, int B, int S, int E,
                   int H, int length, int q_sb, int kn_sb, int vn_sb,
                   int cluster, int span, int depth, int smem,
                   cudaStream_t stream) {
  // the plan's span and depth for this fill (decode_attn_cuda.plan)
  const int per = ((length + 1 + cluster - 1) / cluster + TC_ROWS - 1) /
                  TC_ROWS * TC_ROWS;
  const int units = 2 * ((span / TC_ROWS + K11_WARPS - 1) / K11_WARPS);
  if (cluster < 1 || cluster > 8 || span < per || span % TC_ROWS ||
      depth != (units < TC_DEPTH ? units : TC_DEPTH) ||
      smem != K11_WARPS * depth * TC_ROWS * 2 * D + span * 4 ||
      smem > K11_SMEM)
    return cudaErrorInvalidValue;
  const float scale = 1.4426950408889634f / sqrtf((float)D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(K11_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(kn),
             *vv = static_cast<const bf16*>(vn);
  bf16 *k = static_cast<bf16*>(kc), *v = static_cast<bf16*>(vc),
       *yy = static_cast<bf16*>(y);
  cudaError_t err;
  if (cluster > 1) {
    static unsigned done = 0;
    err = hl::allow_smem(
        done, reinterpret_cast<const void*>(decode_tc<D, true>), K11_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, decode_tc<D, true>, qq, kk, vv, k, v,
                             starts, yy, S, E, H, length, q_sb, kn_sb, vn_sb,
                             scale, span, depth);
  } else {
    static unsigned done = 0;
    err = hl::allow_smem(
        done, reinterpret_cast<const void*>(decode_tc<D, false>), K11_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, decode_tc<D, false>, qq, kk, vv, k, v,
                             starts, yy, S, E, H, length, q_sb, kn_sb, vn_sb,
                             scale, span, depth);
  }
  if (err != cudaSuccess) return err;
  ++k11_kernels;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int D, const void* q, const void* kn, const void* vn,
                void* kc, void* vc, const int* starts, void* y, int B, int S,
                int E, int H, int length, int q_sb, int kn_sb, int vn_sb,
                int cluster, int span, int depth, int smem,
                cudaStream_t stream) {
  auto go = [&](auto d) {
    return run_d<T, decltype(d)::value>(
        q, kn, vn, kc, vc, starts, y, B, S, E, H, length, q_sb, kn_sb, vn_sb,
        cluster, span, depth, smem, stream);
  };
  using std::integral_constant;
  if constexpr (sizeof(T) == 2) {   // bf16 heads of 32-128: tensor cores
    if (D == 32)
      return run_tc<32>(q, kn, vn, kc, vc, starts, y, B, S, E, H, length,
                        q_sb, kn_sb, vn_sb, cluster, span, depth, smem,
                        stream);
    if (D == 64)
      return run_tc<64>(q, kn, vn, kc, vc, starts, y, B, S, E, H, length,
                        q_sb, kn_sb, vn_sb, cluster, span, depth, smem,
                        stream);
    if (D == 128)
      return run_tc<128>(q, kn, vn, kc, vc, starts, y, B, S, E, H, length,
                         q_sb, kn_sb, vn_sb, cluster, span, depth, smem,
                         stream);
  }
  switch (D) {
    case 8: return go(integral_constant<int, 8>());
    case 16: return go(integral_constant<int, 16>());
    case 32:
      if constexpr (sizeof(T) == 4) return go(integral_constant<int, 32>());
      return cudaErrorInvalidValue;
    case 64:
      if constexpr (sizeof(T) == 4) return go(integral_constant<int, 64>());
      return cudaErrorInvalidValue;
    case 128:
      if constexpr (sizeof(T) == 4) return go(integral_constant<int, 128>());
      return cudaErrorInvalidValue;
    case 4:
      if constexpr (sizeof(T) == 4) return go(integral_constant<int, 4>());
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// K12's shapes for one (T, D): see the design note above
template <typename T, int D>
struct K12 {
  static constexpr int VEC = 16 / sizeof(T);    // values a 16-byte chunk
  static constexpr int G = D / VEC;             // lanes a row
  static constexpr int R = 32 / G;              // rows a warp step
  static constexpr int ITER = 4;                // warp steps a tile
  static constexpr int TILE = WARPS * ITER * R; // rows a tile
  static constexpr int CH = TILE * G;           // chunks of k (of v) a tile
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * 2 * CH * 16 + WARPS * (D + 2) * 4;
  static constexpr int BLOCKS_PER_SM = 4;       // split_rows plans on it
  static_assert(D % VEC == 0 && 32 % G == 0 && CH % THREADS == 0, "tiling");
  // an H100's 227 KB a block, and BLOCKS_PER_SM blocks (each with its
  // static red and wsh and the 1 KB the card reserves) in an SM's 228 KB
  static_assert(SMEM <= 232448 &&
                    BLOCKS_PER_SM * (SMEM + (WARPS + THREADS) * 4 + 1024) <=
                        233472,
                "shared memory");
};

// K12: one split of one (head, batch row), and the merge by the last
// split of the (head, batch row) to finish. part holds (m, l, acc) per
// (b, h, split); ctr one counter per (b, h), 0 between calls.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ kn,
             const T* __restrict__ vn, T* kc, T* vc,
             const int* __restrict__ starts, T* __restrict__ y,
             float* part, int* ctr, int S, int E, int H, int length,
             int rows, int q_sb, int kn_sb, int vn_sb, float scale) {
  using P = K12<T, D>;
  constexpr int VEC = P::VEC, G = P::G, ITER = P::ITER, TILE = P::TILE,
                CH = P::CH, STAGES = P::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);       // [STAGES][k, v][CH]
  float* wst = reinterpret_cast<float*>(smem + STAGES * 2 * CH * 16);
  __shared__ int last;
  __shared__ float red[WARPS], wsh[THREADS];
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % G;                 // this lane's chunk of a row
  const int start = starts ? max(starts[b], 0) : 0;
  const int r0 = sp * rows;
  const int lo = max(r0, start), hi = min(r0 + rows - 1, length);
  T* kb = kc + (size_t)b * S * E + h * D;
  T* vb = vc + (size_t)b * S * E + h * D;
  const int bh = b * H + h;

  if (r0 <= length && length < r0 + rows)
    for (int d = tid; d < D; d += THREADS) {
      kb[(size_t)length * E + d] = kn[(size_t)b * kn_sb + h * D + d];
      vb[(size_t)length * E + d] = vn[(size_t)b * vn_sb + h * D + d];
    }
  float qf[VEC];
  alignas(16) T knc[VEC], vnc[VEC];    // chunk c of the new row's k, v
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int d = h * D + c * VEC + e;
    qf[e] = to_f(q[(size_t)b * q_sb + d]);
    knc[e] = kn[(size_t)b * kn_sb + d];
    vnc[e] = vn[(size_t)b * vn_sb + d];
  }

  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (lo <= hi) {
    const int tb = r0 + (lo - r0) / TILE * TILE;   // first row, first tile
    const int nt = (hi - tb) / TILE + 1;
    auto load = [&](int i) {
      uint4* dst = ring + (i % STAGES) * 2 * CH;
      const int row0 = tb + i * TILE;
#pragma unroll
      for (int u = 0; u < CH / THREADS; ++u) {
        const int ch = tid + u * THREADS;
        const int j = row0 + ch / G;
        const bool ok = j >= lo && j <= hi && j != length;
        const size_t off = (size_t)(ok ? j : lo) * E + (ch % G) * VEC;
        hl::cp_async16_zfill(dst + ch, kb + off, ok);
        hl::cp_async16_zfill(dst + CH + ch, vb + off, ok);
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nt) load(i);
      hl::cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      hl::cp_async_wait<STAGES - 2>();
      __syncthreads();                 // tile i is in; slot i - 1 is free
      if (i + STAGES - 1 < nt) load(i + STAGES - 1);
      hl::cp_async_commit();
      uint4* ks = ring + (i % STAGES) * 2 * CH;
      uint4* vs = ks + CH;
      const int row0 = tb + i * TILE;
      if (row0 <= length && length < row0 + TILE) {
        // the new row, left out of the loads, from k_new / v_new
        if (tid < G) {
          ks[(length - row0) * G + tid] = *reinterpret_cast<uint4*>(knc);
          vs[(length - row0) * G + tid] = *reinterpret_cast<uint4*>(vnc);
        }
        __syncthreads();
      }
      float s[ITER];
      float tmax = -INFINITY;
#pragma unroll
      for (int it = 0; it < ITER; ++it) {
        const int idx = (warp * ITER + it) * 32 + lane;
        const int j = row0 + idx / G;
        float kf[VEC];
        unpack<T>(ks[idx], kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[it] = j >= lo && j <= hi ? dot * scale : -INFINITY;
        tmax = fmaxf(tmax, s[it]);
      }
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mn = fmaxf(m, tmax);
      if (mn != -INFINITY) {           // the warp has an attended row
        const float alpha = exp2f(m - mn);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
        m = mn;
#pragma unroll
        for (int it = 0; it < ITER; ++it) {
          const float p = exp2f(s[it] - m);
          l += p;
          float vf[VEC];
          unpack<T>(vs[(warp * ITER + it) * 32 + lane], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
        }
      }
    }
  }
  // the warp's row groups summed (a butterfly: every lane the same bits)
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  float* ws = wst + warp * (D + 2);
  if (lane < G)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ws[2 + c * VEC + e] = acc[e];
  if (lane == 0) {
    ws[0] = m;
    ws[1] = l;
  }
  __syncthreads();
  // the warps combined in warp order: this split's partial
  float* out = part + ((size_t)bh * gridDim.x + sp) * (D + 2);
  if (tid < D) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, wst[w * (D + 2)]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* pw = wst + w * (D + 2);
      if (pw[0] == -INFINITY) continue;   // no attended row
      const float f = exp2f(pw[0] - mm);
      ll = fmaf(pw[1], f, ll);
      aa = fmaf(pw[2 + tid], f, aa);
    }
    out[2 + tid] = aa;
    if (tid == 0) {
      out[0] = mm;
      out[1] = ll;
    }
    __threadfence();                   // the partial, before the count
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ctr + bh, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                     // every split's partial is visible
  // the merge: the splits' max; then, 128 splits at a time, their weights
  // in shared memory and each output's sum over them in split order
  const float* pb = part + (size_t)bh * gridDim.x * (D + 2);
  const int splits = gridDim.x;
  float mm = -INFINITY;
  for (int i = tid; i < splits; i += THREADS)
    mm = fmaxf(mm, __ldcg(pb + (size_t)i * (D + 2)));
  mm = block_reduce(mm, red, true);
  float ll = 0.f, aa = 0.f;
  for (int c0 = 0; c0 < splits; c0 += THREADS) {
    float f = 0.f;                     // no attended row: no weight
    if (c0 + tid < splits) {
      const float mi = __ldcg(pb + (size_t)(c0 + tid) * (D + 2));
      if (mi != -INFINITY) f = exp2f(mi - mm);
    }
    __syncthreads();                   // the last chunk's weights are read
    wsh[tid] = f;
    __syncthreads();
    if (tid < D) {
      const int n = min(THREADS, splits - c0);
      const float* pc = pb + (size_t)c0 * (D + 2);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        ll = fmaf(__ldcg(pc + (size_t)j * (D + 2) + 1), wsh[j], ll);
        aa = fmaf(__ldcg(pc + (size_t)j * (D + 2) + 2 + tid), wsh[j], aa);
      }
    }
  }
  if (tid < D) y[(size_t)b * E + h * D + tid] = from_f<T>(aa / ll);
  if (tid == 0) ctr[bh] = 0;
}

int k12_kernels = 0;                   // K12 kernels launched (host side)

template <typename T, int D>
cudaError_t run_split_d(const void* q, const void* kn, const void* vn,
                        void* kc, void* vc, const int* starts, void* y,
                        float* part, int* ctr, int B, int S, int E, int H,
                        int length, int rows, int q_sb, int kn_sb, int vn_sb,
                        cudaStream_t stream) {
  constexpr int smem = K12<T, D>::SMEM;
  static unsigned done = 0;
  cudaError_t err = hl::allow_smem(
      done, reinterpret_cast<const void*>(decode_split<T, D>), smem);
  if (err != cudaSuccess) return err;
  decode_split<T, D><<<dim3(length / rows + 1, H, B), THREADS, smem,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kc), static_cast<T*>(vc),
      starts, static_cast<T*>(y), part, ctr, S, E, H, length, rows, q_sb,
      kn_sb, vn_sb, 1.4426950408889634f / sqrtf((float)D));
  ++k12_kernels;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_split(int D, const void* q, const void* kn, const void* vn,
                      void* kc, void* vc, const int* starts, void* y,
                      float* part, int* ctr, int B, int S, int E, int H,
                      int length, int rows, int q_sb, int kn_sb, int vn_sb,
                      cudaStream_t stream) {
  auto go = [&](auto d) {
    return run_split_d<T, decltype(d)::value>(
        q, kn, vn, kc, vc, starts, y, part, ctr, B, S, E, H, length, rows,
        q_sb, kn_sb, vn_sb, stream);
  };
  using std::integral_constant;
  switch (D) {
    case 8: return go(integral_constant<int, 8>());
    case 16: return go(integral_constant<int, 16>());
    case 32: return go(integral_constant<int, 32>());
    case 64: return go(integral_constant<int, 64>());
    case 128: return go(integral_constant<int, 128>());
    case 4:
      if constexpr (sizeof(T) == 4) return go(integral_constant<int, 4>());
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel K11. q, k_new, v_new (B, E) with row strides q_sb, kn_sb, vn_sb
// (elements); k_cache, v_cache (B, S, E) contiguous, updated at row
// `length`; starts (B,) int32 or null; y (B, E) contiguous. All bf16
// (bf16 != 0) or fp32; E / H is one of 8, 16, 32, 64, 128 (and 4 in
// fp32), the caches 16-byte aligned. The plan (ops/decode_attn_cuda.py
// plan): cluster, the blocks a (head, row) takes (1 but on the tensor
// cores); span, the rows a block holds scores for; depth, a thread's (on
// the tensor cores a warp's) ring slots; smem, the dynamic shared memory.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// plan that does not fit the fill). One launch.
extern "C" int hl_decode_attn(const void* q, const void* k_new,
                              const void* v_new, void* k_cache, void* v_cache,
                              const int* starts, void* y, int B, int S, int E,
                              int H, int length, int q_sb, int kn_sb,
                              int vn_sb, int bf16_, int cluster, int span,
                              int depth, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || E % H) return cudaErrorInvalidValue;
  const cudaError_t err =
      bf16_ ? run<bf16>(E / H, q, k_new, v_new, k_cache, v_cache, starts, y,
                        B, S, E, H, length, q_sb, kn_sb, vn_sb, cluster, span,
                        depth, smem, s)
            : run<float>(E / H, q, k_new, v_new, k_cache, v_cache, starts, y,
                         B, S, E, H, length, q_sb, kn_sb, vn_sb, cluster,
                         span, depth, smem, s);
  return static_cast<int>(err);
}

// The kernels hl_decode_attn has launched in this process: one a call.
extern "C" int hl_decode_kernels() { return k11_kernels; }

#ifdef HL_PHASES
// decode_tc's cycles by phase (PHASES x PHASE_ITEMS int64, a block a
// column) of the last call: the --phases build only
extern "C" int hl_k11_phases(void* out) { return hl::copy_phases(out); }
#endif

// Kernel K12: the arguments of hl_decode_attn, and rows, the split size
// (rows of the cache a block attends); part, fp32 scratch of (B, H,
// length / rows + 1, E / H + 2) elements; ctr, B H int32 counters that are
// 0 before the call and are left 0 (calls that share them run on one
// stream). E / H is one of 8, 16, 32, 64, 128 (and 4 in fp32). One launch.
extern "C" int hl_decode_attn_split(const void* q, const void* k_new,
                                    const void* v_new, void* k_cache,
                                    void* v_cache, const int* starts,
                                    void* y, void* part, void* ctr, int B,
                                    int S, int E, int H, int length, int rows,
                                    int q_sb, int kn_sb, int vn_sb, int bf16_,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(ctr);
  if (H < 1 || E % H || rows < 1) return cudaErrorInvalidValue;
  const cudaError_t err =
      bf16_ ? run_split<bf16>(E / H, q, k_new, v_new, k_cache, v_cache,
                              starts, y, pt, ct, B, S, E, H, length, rows,
                              q_sb, kn_sb, vn_sb, s)
            : run_split<float>(E / H, q, k_new, v_new, k_cache, v_cache,
                               starts, y, pt, ct, B, S, E, H, length, rows,
                               q_sb, kn_sb, vn_sb, s);
  return static_cast<int>(err);
}

// The kernels hl_decode_attn_split has launched in this process: one a
// call.
extern "C" int hl_decode_split_kernels() { return k12_kernels; }
