// BCSR tile walks: K1 (out = init + sum_k A_k . X[col_k]) and K2 (the same
// from zero) on the layout with coverage fillers, K9 (from zero on the
// group-padded layout) and K10 (from zero on the filler-free row-walk
// layout), all four by the non-zero walk of tile_sparse.cuh, rows
// orientation.
//
// K1 replaces the TPU kernel fitgnn_tpu/ops/pallas/bsr_spmm.py:_kernel_acc
// (grid built by _bsr_spmm_fwd_acc, entry bsr_spmm_acc_raw), K2 its _kernel
// (grid _bsr_spmm_fwd, entry bsr_spmm), K9 _make_grouped_kernel (grid
// _bsr_spmm_fwd_grouped) and K10 _rowwalk_kernel (grid _bsr_spmm_rowwalk).
// There the grid walks the tiles in order and carries each output block in
// VMEM across grid steps.  Blocks of a CUDA grid run in parallel and in no
// order, so here one CTA owns one output block-row r and one slice of 128
// feature columns: it starts from init[r] (K1) or zero in f32 registers,
// walks the tiles row_splits[r] .. row_splits[r+1] of that row, applies
// each tile's non-zeros with f32 FMA and stores once.  No atomics: the
// result is deterministic and every row is written.  The grid is flat, its
// index row * slices + slice: the feature slice varies fastest, so the
// CTAs that reread one tile run together and find it in L2, and the row
// count is limited only by grid.x (2^31 - 1 CTAs).
//
// Bound on an H100: bytes, for all four.  The function needs 2 FLOPs per
// tile non-zero and feature, and the bench graph's tiles are ~3% full, so
// reading the tiles (64 KiB each), the X slabs (and init) and writing out
// bound it.  The walk votes on whether a tile has a non-zero, and only a
// live tile is stored to shared memory, gets its X slab copy and has its
// non-zeros applied, so the FMAs follow the non-zeros and the tile bytes
// are what is left to bound it.  The TPU's fused add of K1 (init read into
// the output block, saving two (N, F) passes over a separate sum) is kept:
// init goes straight into the accumulators.  The coverage fillers that
// build_bsr appends for K1 and K2 (zero tiles, so the TPU grid visits
// every output block) cost only their read: a block row whose run holds
// only a filler comes out as init, bit for bit, or zero.  The TPU's group
// amortises its per-grid-step cost over `group` tiles (one (group, 128,
// 128) DMA a step), and the layout pads every row's run to a multiple of
// `group` with zero tiles (57% more tiles on the bench graph).  A CUDA
// grid has no such per-step cost, so K9 walks the padded run as a plain
// run, and the group is not read at all.  The TPU's row walk
// double-buffers its tile and X DMAs and needs no coverage fillers; K10 is
// the same walk on that layout, whose next tile is already read into
// registers while the current one is applied, and a block row without
// tiles stores zeros.  tile_sparse.cuh says where the walk departs from
// the dense product on non-finite inputs.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

// the non-zero walk, rows orientation: tile k for slot k at scale 1, from
// init under INIT (K1), else from zero (init unused)
template <bool INIT>
int launch_nonzero(const void* blocks, const void* row_splits,
                   const void* cols, const void* x, const void* init,
                   void* out, int64_t num_row_blocks, int64_t feat,
                   void* stream) {
  return static_cast<int>(sparse::launch<false, INIT>(
      static_cast<const float*>(blocks),
      static_cast<const int32_t*>(row_splits), nullptr, nullptr,
      static_cast<const int32_t*>(cols), static_cast<const float*>(x),
      static_cast<const float*>(init), static_cast<float*>(out),
      num_row_blocks, feat, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// blocks (K,128,128) f32, 16-byte aligned; row_splits (num_row_blocks+1,)
// int32; cols (K,) int32; x, init, out (num_row_blocks*128, feat) f32, all
// contiguous (x and init at any 4-byte alignment: each takes its 16-byte
// path only where it starts on a 16-byte boundary and feat % 4 == 0).
// Each entry returns cudaErrorInvalidConfiguration when the grid would
// exceed 2^31 - 1 CTAs, else cudaGetLastError() after the launch.

// K1: out = init + A . x
extern "C" int fitgnn_bsr_spmm_acc(const void* blocks, const void* row_splits,
                                   const void* cols, const void* x,
                                   const void* init, void* out,
                                   int64_t num_row_blocks, int64_t feat,
                                   void* stream) {
  return launch_nonzero<true>(blocks, row_splits, cols, x, init, out,
                              num_row_blocks, feat, stream);
}

// K2: out = A . x
extern "C" int fitgnn_bsr_spmm(const void* blocks, const void* row_splits,
                               const void* cols, const void* x, void* out,
                               int64_t num_row_blocks, int64_t feat,
                               void* stream) {
  return launch_nonzero<false>(blocks, row_splits, cols, x, nullptr,
                               out, num_row_blocks, feat, stream);
}

// K9: out = A . x on the group-padded layout
extern "C" int fitgnn_bsr_spmm_grouped(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* x,
                                       void* out, int64_t num_row_blocks,
                                       int64_t feat, void* stream) {
  return launch_nonzero<false>(blocks, row_splits, cols, x, nullptr,
                               out, num_row_blocks, feat, stream);
}

// K10: out = A . x on the row-walk layout (no coverage fillers: a block
// row without tiles comes out as zeros)
extern "C" int fitgnn_bsr_spmm_rowwalk(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* x,
                                       void* out, int64_t num_row_blocks,
                                       int64_t feat, void* stream) {
  return launch_nonzero<false>(blocks, row_splits, cols, x, nullptr,
                               out, num_row_blocks, feat, stream);
}
