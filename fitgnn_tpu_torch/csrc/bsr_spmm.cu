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
//
// bf16 tiles (the JAX package's tile_dtype=bfloat16): the entries ending
// in _bf16 walk bf16 tiles, half the tile bytes.  K1, K2 and K9 round x to
// bf16 before the products, as _kernel_acc, _kernel and
// _make_grouped_kernel cast x when the tile is bf16; K10 does not, as
// _rowwalk_kernel's jnp.dot promotes the bf16 tile to f32 instead.  The
// sums stay f32, so each form's result is its f32 walk's on the rounded
// operands.
//
// Tiles of another edge: every entry takes the tile edge `block`, a
// multiple of 128 (the JAX package's build_bsr(block=...) and the static
// `block` of _bsr_spmm_fwd, _bsr_spmm_fwd_acc and _bsr_spmm_fwd_grouped).
// Above 128 the walk takes each tile as 128-wide quadrants
// (tile_sparse.cuh, QUAD); at 128 it is the walk above.  K10 walks 128-wide
// tiles only, as _rowwalk_kernel does: its entries return
// cudaErrorInvalidValue for another edge and build no quadrant walk.
//
// Occupancy words: every entry takes `words`, the tiles' occupancy words
// of build_bsr (tile_sparse.cuh, WORDS), or null.  Given (K1, K2 and K9
// above 128), the walk reads and applies the live quadrants alone, and
// starts each one's slab copy with its tile read; null walks every
// quadrant.  K10's entries take null only.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

// the non-zero walk, rows orientation: tile k for slot k at scale 1, from
// init under INIT (K1), else from zero (init unused); T the tile type,
// ROUND_X: x rounded to bf16; block the tile edge, a multiple of 128 under
// QUAD (the quadrant walk, with words where they are given), else 128
// (anything else: cudaErrorInvalidValue)
template <bool INIT, class T = float, bool ROUND_X = false, bool QUAD = true>
int launch_nonzero(const void* blocks, const void* row_splits,
                   const void* cols, const void* words, const void* x,
                   const void* init, void* out, int64_t num_row_blocks,
                   int64_t feat, int64_t block, void* stream) {
  if (QUAD ? block < sparse::BLK || block % sparse::BLK
           : block != sparse::BLK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      sparse::launch<false, INIT, false, ROUND_X, QUAD, T, sparse::Plain,
                     QUAD>(
          static_cast<const T*>(blocks),
          static_cast<const int32_t*>(row_splits), nullptr, nullptr,
          static_cast<const int32_t*>(cols), static_cast<const float*>(x),
          static_cast<const float*>(init), static_cast<float*>(out),
          num_row_blocks, feat, static_cast<cudaStream_t>(stream),
          sparse::Plain{}, static_cast<int>(block / sparse::BLK),
          static_cast<const uint64_t*>(words)));
}

}  // namespace

// blocks (K,block,block) f32, 16-byte aligned; row_splits
// (num_row_blocks+1,) int32; cols (K,) int32; words (K,) int64 or null; x,
// init, out (num_row_blocks*block, feat) f32, all contiguous (x and init
// at any 4-byte alignment: each takes its 16-byte path only where it
// starts on a 16-byte boundary and feat % 4 == 0).  Each entry returns
// cudaErrorInvalidValue for a block that is not a multiple of 128 (K10:
// not 128) and for words at 128 or above 1024 (K10: any words),
// cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1 CTAs,
// else cudaGetLastError() after the launch.

// K1: out = init + A . x
extern "C" int fitgnn_bsr_spmm_acc(const void* blocks, const void* row_splits,
                                   const void* cols, const void* words,
                                   const void* x, const void* init,
                                   void* out, int64_t num_row_blocks,
                                   int64_t feat, int64_t block,
                                   void* stream) {
  return launch_nonzero<true>(blocks, row_splits, cols, words, x, init, out,
                              num_row_blocks, feat, block, stream);
}

// K2: out = A . x
extern "C" int fitgnn_bsr_spmm(const void* blocks, const void* row_splits,
                               const void* cols, const void* words,
                               const void* x, void* out,
                               int64_t num_row_blocks, int64_t feat,
                               int64_t block, void* stream) {
  return launch_nonzero<false>(blocks, row_splits, cols, words, x, nullptr,
                               out, num_row_blocks, feat, block, stream);
}

// K9: out = A . x on the group-padded layout
extern "C" int fitgnn_bsr_spmm_grouped(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* words,
                                       const void* x, void* out,
                                       int64_t num_row_blocks, int64_t feat,
                                       int64_t block, void* stream) {
  return launch_nonzero<false>(blocks, row_splits, cols, words, x, nullptr,
                               out, num_row_blocks, feat, block, stream);
}

// K10: out = A . x on the row-walk layout (no coverage fillers: a block
// row without tiles comes out as zeros)
extern "C" int fitgnn_bsr_spmm_rowwalk(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* words,
                                       const void* x, void* out,
                                       int64_t num_row_blocks, int64_t feat,
                                       int64_t block, void* stream) {
  return launch_nonzero<false, float, false, false>(
      blocks, row_splits, cols, words, x, nullptr, out, num_row_blocks, feat,
      block, stream);
}

// The same four on bf16 tiles, blocks (K,block,block) bf16, 16-byte aligned;
// K1, K2 and K9 round x to bf16, K10 does not.
using bf16 = __nv_bfloat16;

// K1 bf16: out = init + A . bf16(x)
extern "C" int fitgnn_bsr_spmm_acc_bf16(const void* blocks,
                                        const void* row_splits,
                                        const void* cols, const void* words,
                                        const void* x, const void* init,
                                        void* out, int64_t num_row_blocks,
                                        int64_t feat, int64_t block,
                                        void* stream) {
  return launch_nonzero<true, bf16, true>(blocks, row_splits, cols, words,
                                          x, init, out, num_row_blocks,
                                          feat, block, stream);
}

// K2 bf16: out = A . bf16(x)
extern "C" int fitgnn_bsr_spmm_bf16(const void* blocks, const void* row_splits,
                                    const void* cols, const void* words,
                                    const void* x, void* out,
                                    int64_t num_row_blocks, int64_t feat,
                                    int64_t block, void* stream) {
  return launch_nonzero<false, bf16, true>(blocks, row_splits, cols, words,
                                           x, nullptr, out, num_row_blocks,
                                           feat, block, stream);
}

// K9 bf16: out = A . bf16(x) on the group-padded layout
extern "C" int fitgnn_bsr_spmm_grouped_bf16(const void* blocks,
                                            const void* row_splits,
                                            const void* cols,
                                            const void* words, const void* x,
                                            void* out, int64_t num_row_blocks,
                                            int64_t feat, int64_t block,
                                            void* stream) {
  return launch_nonzero<false, bf16, true>(blocks, row_splits, cols, words,
                                           x, nullptr, out, num_row_blocks,
                                           feat, block, stream);
}

// K10 bf16: out = A . x on the row-walk layout, x not rounded
extern "C" int fitgnn_bsr_spmm_rowwalk_bf16(const void* blocks,
                                            const void* row_splits,
                                            const void* cols,
                                            const void* words, const void* x,
                                            void* out, int64_t num_row_blocks,
                                            int64_t feat, int64_t block,
                                            void* stream) {
  return launch_nonzero<false, bf16, false, false>(
      blocks, row_splits, cols, words, x, nullptr, out, num_row_blocks, feat,
      block, stream);
}

// K1a and K1bfa: K1 on bf16 activations, the bf16 branch of _kernel_acc
// (fitgnn_tpu/ops/pallas/bsr_spmm.py:200-222, pallas_call :233): x, init
// and out (num_row_blocks*128, feat) bf16, each tile's products summed in
// f32 (on bf16 tiles bf16 x bf16, on f32 tiles the tile promotes x; exact
// in f32 either way), from init widened to f32, and each sum rounded to
// bf16 once as it is stored (to nearest even), where the Pallas kernel
// adds each tile's rounded product into its bf16 output block.  The walk
// is tile_sparse.cuh's rows walk from init with A = __nv_bfloat16: its slab
// copied as bf16 by cp.async, 8 values a 16-byte piece, and widened to f32
// in shared memory once it has landed.  Edge 128 only, no words (the walk
// of 128-wide tiles; the edge-256 and words forms of K1 take the widened
// route in ops/bsr_spmm.py): another block or any words give
// cudaErrorInvalidValue.  Bound on an H100: bytes, as K1's, with x, init
// and out at 2 bytes a value.
namespace {

template <class T>
int launch_acc_a(const void* blocks, const void* row_splits, const void* cols,
                 const void* words, const void* x, const void* init,
                 void* out, int64_t num_row_blocks, int64_t feat,
                 int64_t block, void* stream) {
  if (block != sparse::BLK || words != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      sparse::launch<false, true, false, false, false, T, sparse::Plain,
                     false, __nv_bfloat16>(
          static_cast<const T*>(blocks),
          static_cast<const int32_t*>(row_splits), nullptr, nullptr,
          static_cast<const int32_t*>(cols),
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(init),
          static_cast<__nv_bfloat16*>(out), num_row_blocks, feat,
          static_cast<cudaStream_t>(stream)));
}

}  // namespace

// K1a: out = init + A . x on f32 tiles, x, init, out bf16
extern "C" int fitgnn_bsr_spmm_acc_a(const void* blocks,
                                     const void* row_splits,
                                     const void* cols, const void* words,
                                     const void* x, const void* init,
                                     void* out, int64_t num_row_blocks,
                                     int64_t feat, int64_t block,
                                     void* stream) {
  return launch_acc_a<float>(blocks, row_splits, cols, words, x, init, out,
                             num_row_blocks, feat, block, stream);
}

// K1bfa: out = init + A . x on bf16 tiles, x, init, out bf16
extern "C" int fitgnn_bsr_spmm_acc_a_bf16(const void* blocks,
                                          const void* row_splits,
                                          const void* cols, const void* words,
                                          const void* x, const void* init,
                                          void* out, int64_t num_row_blocks,
                                          int64_t feat, int64_t block,
                                          void* stream) {
  return launch_acc_a<bf16>(blocks, row_splits, cols, words, x, init, out,
                            num_row_blocks, feat, block, stream);
}
