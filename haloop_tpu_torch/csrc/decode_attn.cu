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
//   p = softmax(s) in fp32, rounded to the cache dtype;
//   y[b, h] = sum_j p[j] v_cache[b, j, h], summed in fp32, in the cache
//   dtype.
// Only the new row is written: the TPU kernel's write-back of the whole
// cache through its output alias is not copied. Row `length` is always
// attended, so the softmax never sees an empty row.
//
// What bounds it on the H100: the cache rows it reads. At hat --batch
// (B=32, 12 heads of 64, bf16) a step at fill level L reads
// 2 x 32 x (L + 1) x 1.5 KB: 9.5 MB at L = 96, 2.8 us at 3.35 TB/s; the
// arithmetic is negligible.
//
// This design: one block of 128 threads per (head, row), which indexes
// heads directly (the TPU's block-diagonal head matrices exist only for
// its 128-lane layout). The block writes its head's slice of the new
// row; then each thread scores whole cache rows (t, t + 128, ...), so the
// rows' loads are all in flight at once, each a run of 16-byte loads of
// the head's D values; the scores sit in shared memory for the block's
// softmax; for p . v the threads split into D-wide groups, each summing
// a residue class of rows (four at a time) over contiguous D-wide
// slices, and the groups' sums are added in a fixed order. At B=1 this
// is 12 blocks on 132 SMs.
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

// cache pointers are plain (not __restrict__ const): the block reads back
// the row it has just written
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode(const T* __restrict__ q, const T* __restrict__ kn,
       const T* __restrict__ vn, T* kc, T* vc,
       const int* __restrict__ starts, T* __restrict__ y, int S, int E,
       int H, int length, int q_sb, int kn_sb, int vn_sb, float scale) {
  extern __shared__ float sm[];
  const int D = E / H;
  float* qs = sm;                    // [D]
  float* ps = qs + D;                // [S] scores, then probabilities
  float* ys = ps + S;                // [THREADS] partial sums of p . v
  __shared__ float red[WARPS];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int start = starts ? max(starts[b], 0) : 0;
  T* kb = kc + (size_t)b * S * E + h * D;
  T* vb = vc + (size_t)b * S * E + h * D;

  for (int d = tid; d < D; d += THREADS) {
    kb[(size_t)length * E + d] = kn[(size_t)b * kn_sb + h * D + d];
    vb[(size_t)length * E + d] = vn[(size_t)b * vn_sb + h * D + d];
    qs[d] = to_f(q[(size_t)b * q_sb + h * D + d]);
  }
  __syncthreads();                   // the new row is visible to the block

  constexpr int VEC = 16 / sizeof(T);       // values per 16-byte load
  for (int j = start + tid; j <= length; j += THREADS) {
    const T* kr = kb + (size_t)j * E;
    float acc = 0.f;
    for (int d = 0; d < D; d += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
      const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(qs[d + e], to_f(kv[e]), acc);
    }
    ps[j] = acc * scale;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = start + tid; j <= length; j += THREADS) mx = fmaxf(mx, ps[j]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int j = start + tid; j <= length; j += THREADS) {
    const float e = expf(ps[j] - mx);
    ps[j] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  const float inv = 1.f / sum;
  for (int j = start + tid; j <= length; j += THREADS)
    ps[j] = to_f(from_f<T>(ps[j] * inv));
  __syncthreads();

  // groups of D threads: group gi sums rows start + gi, + G, ...
  const int G = THREADS / D, gi = tid / D, d = tid % D;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (gi < G) {
    int j = start + gi;
    for (; j + 3 * G <= length; j += 4 * G)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(ps[j + u * G], to_f(vb[(size_t)(j + u * G) * E + d]),
                      acc[u]);
    for (; j <= length; j += G)
      acc[0] = fmaf(ps[j], to_f(vb[(size_t)j * E + d]), acc[0]);
  }
  ys[tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (tid < D) {
    float out = ys[tid];
    for (int i = 1; i < G; ++i) out += ys[i * D + tid];
    y[(size_t)b * E + h * D + tid] = from_f<T>(out);
  }
}

template <typename T>
cudaError_t run(const void* q, const void* kn, const void* vn, void* kc,
                void* vc, const int* starts, void* y, int B, int S, int E,
                int H, int length, int q_sb, int kn_sb, int vn_sb,
                cudaStream_t stream) {
  const int D = E / H;
  const size_t smem = (size_t)(D + S + THREADS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode<T><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kc), static_cast<T*>(vc),
      starts, static_cast<T*>(y), S, E, H, length, q_sb, kn_sb, vn_sb,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
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

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[N]) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = to_f(v[e]);
}

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

// q, k_new, v_new (B, E) with row strides q_sb, kn_sb, vn_sb (elements);
// k_cache, v_cache (B, S, E) contiguous, updated at row `length`; starts
// (B,) int32 or null; y (B, E) contiguous. All bf16 (bf16 != 0) or fp32;
// E / H divides 128 and is a multiple of 8 (16 bytes of bf16; of 4 for
// fp32), the caches 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int hl_decode_attn(const void* q, const void* k_new,
                              const void* v_new, void* k_cache, void* v_cache,
                              const int* starts, void* y, int B, int S, int E,
                              int H, int length, int q_sb, int kn_sb,
                              int vn_sb, int bf16_, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16_ ? run<bf16>(q, k_new, v_new, k_cache, v_cache, starts, y, B, S,
                        E, H, length, q_sb, kn_sb, vn_sb, s)
            : run<float>(q, k_new, v_new, k_cache, v_cache, starts, y, B, S,
                         E, H, length, q_sb, kn_sb, vn_sb, s);
  return static_cast<int>(err);
}

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
