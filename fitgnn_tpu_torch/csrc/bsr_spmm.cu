// BCSR tile walks: K1 (out = init + sum_k A_k . X[col_k]) and K2 (the same
// from zero) by the dense tile product of tile_fma.cuh; K9 (from zero on
// the group-padded layout) and K10 (from zero on the filler-free row-walk
// layout) by the non-zero walk of tile_sparse.cuh.
//
// K1 replaces the TPU kernel fitgnn_tpu/ops/pallas/bsr_spmm.py:_kernel_acc
// (grid built by _bsr_spmm_fwd_acc, entry bsr_spmm_acc_raw), K2 its _kernel
// (grid _bsr_spmm_fwd, entry bsr_spmm), K9 _make_grouped_kernel (grid
// _bsr_spmm_fwd_grouped) and K10 _rowwalk_kernel (grid _bsr_spmm_rowwalk).
// There the grid walks the tiles in order and carries each output block in
// VMEM across grid steps.  Blocks of a CUDA grid run in parallel and in no
// order, so here one CTA owns one output block-row r and one slice of FT
// feature columns: it starts from init[r] (K1) or zero in f32 registers,
// walks the tiles row_splits[r] .. row_splits[r+1] of that row, accumulates
// with f32 FMA and stores once.  No atomics: the result is deterministic
// and every row is written, so a row without tiles comes out as init or
// zero (the coverage fillers build_bsr appends are harmless zero tiles).
// The grid is flat, its index row * slices + slice: the feature slice
// varies fastest, so the CTAs that reread one tile run together and find
// it in L2, and the row count is limited only by grid.x (2^31 - 1 CTAs).
//
// Bound on an H100: bytes, for all four.  The function needs 2 FLOPs per
// tile non-zero and feature, a few FLOPs a byte, so reading the tiles (64
// KiB each), the X slabs (and init) and writing out bound it.  The bench
// graph's tiles are ~3% full, so the dense tile product K1 and K2 do
// (tile_fma.cuh: 8x4 outputs a thread, 32 FMAs per 3 shared-memory vector
// loads) costs ~33x the FLOPs the function needs, and the CUDA cores' f32
// rate limits those kernels themselves.
//
// K9 and K10 walk each tile's non-zeros instead (tile_sparse.cuh, the rows
// orientation): the CTA votes on whether a tile has a non-zero, and only a
// live tile is stored to shared memory, gets its X slab copy and has its
// non-zeros applied, so the FMAs follow the non-zeros and the tile bytes
// are what is left to bound the walk.  The TPU's group amortises its
// per-grid-step cost over `group` tiles (one (group, 128, 128) DMA a
// step), and the layout pads every row's run to a multiple of `group` with
// zero tiles (57% more tiles on the bench graph).  A CUDA grid has no such
// per-step cost, so K9 walks the padded run as a plain run: a pad, like a
// coverage filler, costs only the read of its zeros, and the group is not
// read at all.  The TPU's row walk double-buffers its tile and X DMAs and
// needs no coverage fillers; K10 is the same walk on that layout, whose
// next tile is already read into registers while the current one is
// applied, and a block row without tiles stores zeros.  tile_sparse.cuh
// says where the walk departs from the dense product on non-finite inputs.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_fma.cuh"
#include "tile_sparse.cuh"

namespace {

using namespace tile;

// INIT: start from init (K1), else from zero (K2)
template <bool INIT>
__global__ void __launch_bounds__(THREADS)
bsr_walk_kernel(const float* __restrict__ blocks,
                const int32_t* __restrict__ row_splits,
                const int32_t* __restrict__ cols,
                const float* __restrict__ x, const float* __restrict__ init,
                float* __restrict__ out, int64_t feat, int64_t slices) {
  __shared__ __align__(16) ATile As;
  __shared__ __align__(16) XTile Xs;

  const int64_t r = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int row0 = row0_of(tid);
  const int col0 = col0_of(tid);

  float acc[TM][TN];
  load_acc(acc, INIT ? init : nullptr, r, f0, row0, col0, feat);

  const int lo = row_splits[r];
  const int hi = row_splits[r + 1];
  for (int k = lo; k < hi; ++k) {
    for (int s = 0; s < BLK / KC; ++s) {
      stage_a_cols(As, blocks + static_cast<int64_t>(k) * BLK * BLK,
                   s * KC, tid);
      stage_x_rows(Xs, x + (static_cast<int64_t>(cols[k]) * BLK + s * KC)
                           * feat, f0, feat, tid);
      __syncthreads();
      fma_chunk(As, Xs, acc, row0, col0);
      __syncthreads();
    }
  }
  store_acc(acc, out, r, f0, row0, col0, feat);
}

// the dense walk on the flat grid of num_row_blocks * ceil(feat / FT) CTAs
int launch_walk(const void* blocks, const void* row_splits, const void* cols,
                const void* x, const void* init, void* out,
                int64_t num_row_blocks, int64_t feat, void* stream) {
  if (num_row_blocks > 0 && feat > 0) {
    const int64_t slices = (feat + FT - 1) / FT;
    const int64_t ctas = num_row_blocks * slices;
    if (ctas > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* b = static_cast<const float*>(blocks);
    const auto* rs = static_cast<const int32_t*>(row_splits);
    const auto* c = static_cast<const int32_t*>(cols);
    const auto* xi = static_cast<const float*>(x);
    const auto* in = static_cast<const float*>(init);
    auto* o = static_cast<float*>(out);
    const unsigned grid = static_cast<unsigned>(ctas);
    if (in != nullptr) {
      bsr_walk_kernel<true><<<grid, THREADS, 0, s>>>(b, rs, c, xi, in, o,
                                                     feat, slices);
    } else {
      bsr_walk_kernel<false><<<grid, THREADS, 0, s>>>(b, rs, c, xi, nullptr,
                                                      o, feat, slices);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// the non-zero walk, rows orientation: tile k for slot k, scale 1
int launch_nonzero(const void* blocks, const void* row_splits,
                   const void* cols, const void* x, void* out,
                   int64_t num_row_blocks, int64_t feat, void* stream) {
  return static_cast<int>(sparse::launch<false>(
      static_cast<const float*>(blocks),
      static_cast<const int32_t*>(row_splits), nullptr, nullptr,
      static_cast<const int32_t*>(cols), static_cast<const float*>(x),
      static_cast<float*>(out), num_row_blocks, feat,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// blocks (K,128,128) f32; row_splits (num_row_blocks+1,) int32; cols (K,)
// int32; x, init, out (num_row_blocks*128, feat) f32, all contiguous.
// Each entry returns cudaErrorInvalidConfiguration when the grid would
// exceed 2^31 - 1 CTAs, else cudaGetLastError() after the launch.

// K1: out = init + A . x
extern "C" int fitgnn_bsr_spmm_acc(const void* blocks, const void* row_splits,
                                   const void* cols, const void* x,
                                   const void* init, void* out,
                                   int64_t num_row_blocks, int64_t feat,
                                   void* stream) {
  return launch_walk(blocks, row_splits, cols, x, init, out, num_row_blocks,
                     feat, stream);
}

// K2: out = A . x
extern "C" int fitgnn_bsr_spmm(const void* blocks, const void* row_splits,
                               const void* cols, const void* x, void* out,
                               int64_t num_row_blocks, int64_t feat,
                               void* stream) {
  return launch_walk(blocks, row_splits, cols, x, nullptr, out,
                     num_row_blocks, feat, stream);
}

// K9: out = A . x on the group-padded layout
extern "C" int fitgnn_bsr_spmm_grouped(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* x,
                                       void* out, int64_t num_row_blocks,
                                       int64_t feat, void* stream) {
  return launch_nonzero(blocks, row_splits, cols, x, out, num_row_blocks,
                        feat, stream);
}

// K10: out = A . x on the row-walk layout (no coverage fillers: a block
// row without tiles comes out as zeros)
extern "C" int fitgnn_bsr_spmm_rowwalk(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* x,
                                       void* out, int64_t num_row_blocks,
                                       int64_t feat, void* stream) {
  return launch_nonzero(blocks, row_splits, cols, x, out, num_row_blocks,
                        feat, stream);
}
