// K8: the block-diagonal run, out_b = (init_b +) A_b . x_b, or
// (init_b +) A_b^T . x_b, for every diagonal block b (of edge 128, or of
// any multiple of 128).
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
//
// Blocks of another edge (the JAX package's build_hybrid(block=E, use_diag=
// True): _make_kernel(r, block, ...) takes E from the blocks' shape): every
// entry takes the edge `block`, a multiple of 128; above 128 the walk takes
// each diagonal block as 128-wide quadrants (tile_sparse.cuh, QUAD), the
// transpose quadrant (q, h) read transposed; at 128 it is the walk above.
//
// bf16 blocks (the JAX package's tile_dtype=bfloat16, its diagonal blocks
// cast at fitgnn_tpu/ops/hybrid_spmm.py:160-165): fitgnn_diag_spmm_bf16
// walks them with x rounded to bf16 in both orientations, from init or
// zero, as _make_kernel casts x when the blocks are bf16; the sums and
// init stay f32.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

// T the block type; bf16 blocks round x to bf16; quads the edge over 128
template <bool TRANS, class T = float>
cudaError_t launch_diag(const T* blocks, const float* x, const float* init,
                        float* out, int64_t nb, int64_t feat, int quads,
                        cudaStream_t stream) {
  constexpr bool ROUND_X = !std::is_same<T, float>::value;
  if (init != nullptr) {
    return sparse::launch<TRANS, true, true, ROUND_X, true>(
        blocks, nullptr, nullptr, nullptr, nullptr, x, init, out, nb, feat,
        stream, sparse::Plain{}, quads);
  }
  return sparse::launch<TRANS, false, true, ROUND_X, true>(
      blocks, nullptr, nullptr, nullptr, nullptr, x, nullptr, out, nb, feat,
      stream, sparse::Plain{}, quads);
}

template <class T>
int diag_entry(const void* blocks, const void* x, const void* init,
               void* out, int64_t nb, int64_t feat, int64_t block,
               int transpose, void* stream) {
  if (block < sparse::BLK || block % sparse::BLK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* bl = static_cast<const T*>(blocks);
  const auto* xi = static_cast<const float*>(x);
  const auto* in = static_cast<const float*>(init);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int q = static_cast<int>(block / sparse::BLK);
  return static_cast<int>(
      transpose ? launch_diag<true>(bl, xi, in, o, nb, feat, q, s)
                : launch_diag<false>(bl, xi, in, o, nb, feat, q, s));
}

}  // namespace

// blocks (nb,block,block) f32, 16-byte aligned; x, init (may be null),
// out (nb*block, feat) f32, all contiguous; transpose != 0 contracts each
// block's row axis.  Returns cudaErrorInvalidValue for a block that is not
// a multiple of 128, cudaErrorInvalidConfiguration when the grid would
// exceed 2^31 - 1 CTAs, else cudaGetLastError() after the launch.
extern "C" int fitgnn_diag_spmm(const void* blocks, const void* x,
                                const void* init, void* out, int64_t nb,
                                int64_t feat, int64_t block, int transpose,
                                void* stream) {
  return diag_entry<float>(blocks, x, init, out, nb, feat, block, transpose,
                           stream);
}

// the same on bf16 blocks (nb,block,block), 16-byte aligned, x rounded to
// bf16
extern "C" int fitgnn_diag_spmm_bf16(const void* blocks, const void* x,
                                     const void* init, void* out, int64_t nb,
                                     int64_t feat, int64_t block,
                                     int transpose, void* stream) {
  return diag_entry<__nv_bfloat16>(blocks, x, init, out, nb, feat, block,
                                   transpose, stream);
}
