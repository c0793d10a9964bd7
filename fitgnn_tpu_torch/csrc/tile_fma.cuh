// The dense 128x128 tile product core of the block-diagonal run
// (diag_spmm.cu: K8).  The BCSR walks (K1, K2, K9, K10, K4, K4T) walk each
// tile's non-zeros instead (tile_sparse.cuh); att_bsr.cu's walks keep a
// copy of this tiling.
//
// One CTA of 256 threads owns a 128-row output block and a slice of FT=64
// feature columns.  Each thread keeps an 8x4 block of the output in f32
// registers.  A tile is staged through shared memory in KC=32-deep chunks:
// As[k][row] holds the tile's column k transposed, so a thread reads its 8
// rows for one k as two float4, and Xs[k][c] holds the matching X rows; a
// chunk costs 32 FMAs a thread per 3 shared-memory vector loads.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace tile {

constexpr int BLK = 128;                          // tile edge (rows = cols)
constexpr int FT = 64;                            // feature columns a CTA
constexpr int KC = 32;                            // tile columns a stage
constexpr int TM = 8;                             // output rows a thread
constexpr int TN = 4;                             // output cols a thread
constexpr int THREADS = (BLK / TM) * (FT / TN);   // 256

using ATile = float[KC][BLK + 4];   // +4 keeps rows 16-byte aligned
using XTile = float[KC][FT];

__device__ __forceinline__ int row0_of(int tid) {
  return (tid / (FT / TN)) * TM;
}

__device__ __forceinline__ int col0_of(int tid) {
  return (tid % (FT / TN)) * TN;
}

// acc = init[block rows r*BLK + row0 .., columns f0 + col0 ..], or 0 when
// init is null
__device__ __forceinline__ void load_acc(float (&acc)[TM][TN],
                                         const float* __restrict__ init,
                                         int64_t r, int64_t f0, int row0,
                                         int col0, int64_t feat) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t base = (r * BLK + row0 + i) * feat;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = f0 + col0 + j;
      acc[i][j] = (init != nullptr && c < feat) ? init[base + c] : 0.f;
    }
  }
}

__device__ __forceinline__ void store_acc(const float (&acc)[TM][TN],
                                          float* __restrict__ out, int64_t r,
                                          int64_t f0, int row0, int col0,
                                          int64_t feat) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t base = (r * BLK + row0 + i) * feat;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = f0 + col0 + j;
      if (c < feat) out[base + c] = acc[i][j];
    }
  }
}

// As[c][row] = a[row][kc + c] for the 32 columns kc .. kc+31 of a row-major
// 128x128 tile (128 rows x 8 float4)
__device__ __forceinline__ void stage_a_cols(ATile& As,
                                             const float* __restrict__ a,
                                             int kc, int tid) {
  for (int q = tid; q < BLK * (KC / 4); q += THREADS) {
    const int row = q / (KC / 4);
    const int c4 = (q % (KC / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(
        a + static_cast<int64_t>(row) * BLK + kc + c4);
    As[c4 + 0][row] = v.x;
    As[c4 + 1][row] = v.y;
    As[c4 + 2][row] = v.z;
    As[c4 + 3][row] = v.w;
  }
}

// Xs[k][c] = xb[k][f0 + c] for 32 rows of an X slab, coalesced along the
// feature axis; columns past feat read as 0
__device__ __forceinline__ void stage_x_rows(XTile& Xs,
                                             const float* __restrict__ xb,
                                             int64_t f0, int64_t feat,
                                             int tid) {
  for (int q = tid; q < KC * FT; q += THREADS) {
    const int kk = q / FT;
    const int c = q % FT;
    const int64_t gc = f0 + c;
    Xs[kk][c] = gc < feat ? xb[static_cast<int64_t>(kk) * feat + gc] : 0.f;
  }
}

// acc += As^T-chunk . Xs-chunk (32 deep)
__device__ __forceinline__ void fma_chunk(const ATile& As, const XTile& Xs,
                                          float (&acc)[TM][TN], int row0,
                                          int col0) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][row0]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][row0 + 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Xs[kk][col0]);
    const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

}  // namespace tile
