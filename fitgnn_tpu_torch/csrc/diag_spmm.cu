// K8: the block-diagonal run, out_b = (init_b +) A_b . x_b, or
// (init_b +) A_b^T . x_b, for every 128-row block b.
//
// Replaces the TPU kernel fitgnn_tpu/ops/pallas/diag_spmm.py:_make_kernel
// (grids built by _diag_spmm and _diag_spmm_acc, entry diag_spmm_raw).
// There a grid step takes r consecutive diagonal blocks, so its X and out
// slabs are single contiguous DMAs, and the per-step pipeline cost is
// spread over r blocks.  A CUDA grid has no per-step cost to spread, and r
// only has to divide the block count, as on the TPU.
//
// Bound on an H100: bytes.  The function reads every diagonal block with a
// non-zero once (64 KiB each), x and init, and writes out, at 2 FLOPs per
// block non-zero and feature.  The blocks are sparse: on the bench graph
// 1,323 of the 1,324 diagonal blocks hold 977,892 non-zeros, 4.51% fill
// (5.8 a row on average, 18 at most), so a dense 128x128 product would
// spend ~95% of its FMAs on zeros.
//
// Design: the non-zero walk of tile_sparse.cuh under DIAG.  The forward is
// its rows orientation, the transpose its columns orientation (the stored
// block read transposed in place, no transposed copy), each from init or
// from zero.  One CTA owns one diagonal block b and one slice of 128
// feature columns; the run of block row b is the one tile b, read against
// x's slab b, so no index array is built or read.  Since the CTA walks one
// tile, the slab copy starts with the tile's read and init's.  A block
// without a non-zero stores init (or zero) bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

template <bool TRANS>
cudaError_t launch_diag(const float* blocks, const float* x,
                        const float* init, float* out, int64_t nb,
                        int64_t feat, cudaStream_t stream) {
  if (init != nullptr) {
    return sparse::launch<TRANS, true, true>(blocks, nullptr, nullptr,
                                             nullptr, nullptr, x, init, out,
                                             nb, feat, stream);
  }
  return sparse::launch<TRANS, false, true>(blocks, nullptr, nullptr,
                                            nullptr, nullptr, x, nullptr,
                                            out, nb, feat, stream);
}

}  // namespace

// blocks (nb,128,128) f32, 16-byte aligned; x, init (may be null), out
// (nb*128, feat) f32, all contiguous; transpose != 0 contracts each
// block's row axis.  Returns cudaErrorInvalidConfiguration when the grid
// would exceed 2^31 - 1 CTAs, else cudaGetLastError() after the launch.
extern "C" int fitgnn_diag_spmm(const void* blocks, const void* x,
                                const void* init, void* out, int64_t nb,
                                int64_t feat, int transpose, void* stream) {
  const auto* bl = static_cast<const float*>(blocks);
  const auto* xi = static_cast<const float*>(x);
  const auto* in = static_cast<const float*>(init);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      transpose ? launch_diag<true>(bl, xi, in, o, nb, feat, s)
                : launch_diag<false>(bl, xi, in, o, nb, feat, s));
}
