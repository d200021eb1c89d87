// The register tiling shared by the fp32 flash kernels: the forward
// (fwd_f32, csrc/flash_fwd.cu; K5 and K7 in fp32) and the backward
// (bwd_dq_f32, bwd_dkv_f32, csrc/flash_bwd.cu; K6a and K6b in fp32).
// Every product is exact fp32 FFMA on the CUDA cores, no TF32.
//
// A block's 128 threads as 16 rows of 8 (ty, tx). Over a 64 x 64 tile of
// scores a thread owns the 4 x 8 patch of rows ty + 16 r and columns
// tx + 8 c; over a 64 x HD output tile the 4 x HD/8 patch of the same
// rows and columns tx * 4 + 32 g + (0..3), g < HD/32. The 8 threads of a
// row are 8 neighbouring lanes of a warp (a row's max and sum by
// __shfl_xor_sync over 1, 2 and 4). Tiles lie in shared memory
// row-major, FT rows: rows of q, k, v or do LD floats apart, rows of
// scores SLD apart, 64 wide at any HD (a D = 32 stride overlapped them).
// With these strides the float4 loads of a warp (4 rows ty, or 8 rows
// tx + 8 c, or 8 neighbouring chunks of one row) and its scattered stores
// of scores each touch every bank at most once. Every tile has room for
// FT rows of SLD, so a tile of scores can take the place of a k or v
// tile that has been read.

#pragma once

#include <cuda_runtime.h>

#include "mma.cuh"

namespace hl {
namespace f32 {

constexpr int FT = 64;        // query rows a tile, keys a tile
constexpr int FTHREADS = 128; // 16 x 8 threads, a 4 x 8 patch each

template <int HD>
struct Tiles {
  static_assert(HD == 32 || HD == 64, "head widths");
  static constexpr int LD = HD + 4, SLD = FT + 8;
  static constexpr int TILE = FT * SLD;         // floats a tile
  static constexpr int CW = HD / 8;             // output columns a thread
};

// rows [r0, r0 + FT) of a (rows, HD) fp32 matrix with row stride st into
// a tile by cp.async; rows past ``rows`` are zeros
template <int HD>
__device__ __forceinline__ void issue_tile(float* dst, const float* src,
                                           int r0, int rows, int st) {
  constexpr int CH = HD / 4;                     // 16-byte chunks a row
  for (int i = threadIdx.x; i < FT * CH; i += FTHREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r0 + r < rows;
    hl::cp_async16_zfill(dst + r * Tiles<HD>::LD + c,
                         src + (size_t)(ok ? r0 + r : 0) * st + c, ok);
  }
}

// component u of a float4
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc[r][4 g + u] += sum_j W[ty + 16 r][j] X[j][tx 4 + 32 g + u] over the
// FT rows j of X, in j's order; W a tile of scores
template <int HD>
__device__ __forceinline__ void rows_times(float (&acc)[4][Tiles<HD>::CW],
                                           const float* W, const float* X,
                                           int ty, int tx) {
  constexpr int LD = Tiles<HD>::LD, SLD = Tiles<HD>::SLD, NG = HD / 32;
#pragma unroll 4
  for (int j = 0; j < FT; j += 4) {
    float4 w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const float4*>(W + (ty + 16 * r) * SLD + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 x[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        x[g] = *reinterpret_cast<const float4*>(X + (j + jj) * LD + tx * 4 +
                                                32 * g);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float wr = comp(w[r], jj);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[r][4 * g] = fmaf(wr, x[g].x, acc[r][4 * g]);
          acc[r][4 * g + 1] = fmaf(wr, x[g].y, acc[r][4 * g + 1]);
          acc[r][4 * g + 2] = fmaf(wr, x[g].z, acc[r][4 * g + 2]);
          acc[r][4 * g + 3] = fmaf(wr, x[g].w, acc[r][4 * g + 3]);
        }
      }
    }
  }
}

// the [s n / P, (s + 1) n / P) share of n reduction tiles that split s of
// P takes (flash_cuda.f32_split_range)
__device__ __forceinline__ void split_range(int n, int P, int s, int* lo,
                                            int* hi) {
  *lo = (int)((long long)n * s / P);
  *hi = (int)((long long)n * (s + 1) / P);
}

}  // namespace f32
}  // namespace hl
