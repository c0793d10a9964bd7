// K4 and K5: the dynamic-tile BSR walk and its tile gradient.
//
// K4, fitgnn_bsr_dyn_apply:
//   out[rows[k]] += scale[k] . (B[sel[k]] or B[sel[k]]^T) @ x[cols[k]],
// from zero.  Replaces the TPU kernel
// fitgnn_tpu/ops/pallas/bsr_dynamic.py:_make_dyn_kernel (grid built by
// _dyn_apply, entry bsr_spmm_dyn and its backward).  The tile values are a
// runtime tensor (GAT's attention numerators where(mask, exp(.), 0)), so
// the walk reads them like any operand.  Both orientations are the
// non-zero walk of tile_sparse.cuh: one CTA owns one output block-row and
// one 128-column feature slice, walks its slots row_splits[r] ..
// row_splits[r+1] and writes every output row once, as zeros when no slot
// adds to it.  No atomics, so the result is deterministic.
//   Forward (trans == 0, K4): the rows orientation, slot k = tile k with
// scale 1, as K9 and K10 (bsr_spmm.cu).  Output row i takes row i of B[k].
//   Transposed (trans != 0, K4T, the dx of bsr_spmm_dyn): the columns
// orientation over the transpose plan.  Output row i takes column i of
// B[sel[k]]: the tile is staged in shared memory under an XOR swizzle of
// its 16-byte chunks, so a warp reads a column conflict-free.  A slot with
// scale 0 (a coverage filler of the transpose plan) is skipped uniformly
// across the CTA.
// tile_sparse.cuh has the bank-conflict choice and the one way the walk's
// result departs from the dense product (an inf or NaN in x that only
// zero tile entries reach).
//
// K5, fitgnn_dyn_grad_blocks:
//   dB[k] = g[rows[k]*128 : +128, :] @ x[cols[k]*128 : +128, :]^T,
// for every tile, fillers included.  Replaces
// fitgnn_tpu/ops/pallas/bsr_dynamic.py:_dB_kernel (grid built by
// _dyn_grad_blocks).  One CTA owns one tile's 128x128 output: 256 threads,
// 8x8 outputs each in registers.  It walks F in 32-wide chunks, staging
// the g and x slabs transposed (Gs[f][i], Xs[f][j]) from coalesced loads
// along the feature axis, and writes its tile once.
//
// Bound on an H100.  K4 and K4T: bytes.  The function needs 2 FLOPs per
// tile non-zero and feature, and the attention tiles are ~3% full, so the
// dense tiles (64 KiB each), the slabs and the output bound it; a dense
// 128x128 product would spend ~97% of its FMAs on zeros.  The walk votes
// on each tile and applies only its non-zeros, so the coverage fillers
// (zero values) cost their read and nothing more.  K5: operations.  dB is
// dense (2.192k tiles x 128 x 128 outputs, 2.F FLOPs each: 36.8 GFLOP at
// F=512), against ~1.2 GB of slab reads.  The design reuses each staged
// value 8 times from registers (64 FMAs per four 16-byte shared loads).
// Tensor cores (TF32 or bf16 wgmma), TMA pipelining and a product sampled
// at the tile mask (only ~3% of dB is kept downstream) are later work.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

constexpr int BLK = 128;                          // tile edge (rows = cols)

// K5 tiling
constexpr int FC = 32;                            // features a stage
constexpr int GT = 8;                             // outputs a thread, per axis
constexpr int GTHREADS = (BLK / GT) * (BLK / GT); // 256

__global__ void __launch_bounds__(GTHREADS)
dyn_grad_blocks_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ g,
                       const float* __restrict__ x, float* __restrict__ dB,
                       int64_t feat) {
  // Gs[f][i] = g[row i][f0+f], Xs[f][j] = x[row j][f0+f]; +4 keeps each
  // row 16-byte aligned for the float4 reads of the product loop
  __shared__ __align__(16) float Gs[FC][BLK + 4];
  __shared__ __align__(16) float Xs[FC][BLK + 4];

  const int64_t k = blockIdx.x;
  const int tid = threadIdx.x;
  const int i0 = (tid / (BLK / GT)) * GT;
  const int j0 = (tid % (BLK / GT)) * GT;
  const float* gb = g + static_cast<int64_t>(rows[k]) * BLK * feat;
  const float* xb = x + static_cast<int64_t>(cols[k]) * BLK * feat;

  float acc[GT][GT];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
#pragma unroll
    for (int j = 0; j < GT; ++j) acc[i][j] = 0.f;
  }

  for (int64_t f0 = 0; f0 < feat; f0 += FC) {
    // one warp reads 32 consecutive features of one slab row
    for (int q = tid; q < BLK * FC; q += GTHREADS) {
      const int row = q / FC;
      const int f = q % FC;
      const int64_t gf = f0 + f;
      const int64_t off = static_cast<int64_t>(row) * feat + gf;
      Gs[f][row] = gf < feat ? gb[off] : 0.f;
      Xs[f][row] = gf < feat ? xb[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < FC; ++f) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Gs[f][i0]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Gs[f][i0 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Xs[f][j0]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Xs[f][j0 + 4]);
      const float av[GT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[GT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < GT; ++i) {
#pragma unroll
        for (int j = 0; j < GT; ++j) {
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* o = dB + k * BLK * BLK;
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    float4* dst = reinterpret_cast<float4*>(
        o + static_cast<int64_t>(i0 + i) * BLK + j0);
    dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

// blocks (K,128,128) f32, 16-byte aligned; row_splits (num_row_blocks+1,)
// int32 slot range per output block-row; cols (slots,) int32 input block
// per slot; x, out (num_row_blocks*128, feat) f32.  trans != 0 reads each
// tile transposed: sel, scale (slots,) int32 are then the tile read by a
// slot and its scale (0 = filler).  The forward (trans == 0) reads tile k
// for slot k at scale 1 and passes sel and scale as null.
// All contiguous.  Returns cudaErrorInvalidConfiguration when the grid
// would exceed 2^31 - 1 CTAs, else cudaGetLastError() after the launch.
extern "C" int fitgnn_bsr_dyn_apply(const void* blocks, const void* row_splits,
                                    const void* sel, const void* scale,
                                    const void* cols, const void* x, void* out,
                                    int64_t num_row_blocks, int64_t feat,
                                    int trans, void* stream) {
  const auto* b = static_cast<const float*>(blocks);
  const auto* rs = static_cast<const int32_t*>(row_splits);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (trans) {
    return static_cast<int>(sparse::launch<true, false>(
        b, rs, static_cast<const int32_t*>(sel),
        static_cast<const int32_t*>(scale), c, xp, nullptr, op,
        num_row_blocks, feat, s));
  }
  return static_cast<int>(sparse::launch<false, false>(
      b, rs, nullptr, nullptr, c, xp, nullptr, op, num_row_blocks, feat, s));
}

// rows, cols (num_tiles,) int32 block ids; g, x (*, feat) f32; dB
// (num_tiles,128,128) f32, 16-byte aligned; all contiguous.  feat may be 0
// (dB is then written as zeros).  Returns cudaErrorInvalidConfiguration
// when num_tiles exceeds 2^31 - 1, else cudaGetLastError() after the
// launch.
extern "C" int fitgnn_dyn_grad_blocks(const void* rows, const void* cols,
                                      const void* g, const void* x, void* dB,
                                      int64_t num_tiles, int64_t feat,
                                      void* stream) {
  if (num_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (num_tiles > 0) {
    dyn_grad_blocks_kernel<<<static_cast<unsigned>(num_tiles), GTHREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<float*>(dB), feat);
  }
  return static_cast<int>(cudaGetLastError());
}
