// BCSR tile walks: K1 (out = init + sum_k A_k . X[col_k]), K2 (the same
// from zero), K9 (from zero on the group-padded layout, by the non-zero
// walk of tile_sparse.cuh) and K10 (from zero, the row walk on the
// filler-free layout).
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
//
// Bound on an H100: memory.  The function needs 2 FLOPs per tile non-zero
// and feature, a few FLOPs a byte, so reading the tiles, the X slabs (and
// init) and writing out bound it.  The bench graph's tiles are ~3% full, so
// the dense tile product K1, K2 and K10 do costs ~33x the FLOPs the function
// needs and the CUDA cores' f32 rate limits the kernels themselves.  The
// design answers with a register-blocked product (tile_fma.cuh: 8x4
// outputs a thread, 32 FMAs per 3 shared-memory vector loads) and a flat
// grid whose index is row * slices + slice: the feature slice varies
// fastest, so the CTAs that reread one tile run together and find it in L2,
// and the row count is limited only by grid.x (2^31 - 1 CTAs).
//
// K9 is the exception: it walks each tile's non-zeros (tile_sparse.cuh,
// the rows orientation) instead of the dense product.  The TPU's group
// amortises its per-grid-step cost over `group` tiles (one (group, 128,
// 128) DMA a step), and the layout pads every row's run to a multiple of
// `group` with zero tiles (57% more tiles on the bench graph).  A CUDA grid
// has no such per-step cost, so K9 walks the padded run as a plain run: a
// pad, like a coverage filler, costs only the read of its zeros (no slab
// copy, no FMA), and the group is not read at all.  Bytes bound it, the
// tiles' first of all; tile_sparse.cuh says what the walk does about that
// and where it departs from the dense product on non-finite inputs.
//
// K10: the TPU's row walk double-buffers the tile and X DMAs so that tile
// k+1 arrives while tile k is multiplied, and it needs no coverage fillers.
// Here the same two-stage pipeline runs on cp.async: a stage holds one
// whole tile (row-major, rows padded to 132 floats) and its X slab (128 x
// 64), 98 KB, and the CTA starts tile k+1's copies before it waits for tile
// k's.  Two stages take 196 KB of dynamic shared memory, one CTA an SM;
// the copies bypass registers, and the product reads a tile row as float4
// along k (8 rows x 4 k and 4 X rows a step: 128 FMAs per 12 loads).

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_fma.cuh"
#include "tile_sparse.cuh"

namespace {

using namespace tile;
using sparse::cp_async16;
using sparse::cp_async4;
using sparse::cp_async_commit;
using sparse::cp_async_wait;

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

// --- K10: the row walk on a cp.async two-stage pipeline -------------------

constexpr int RW_LD = BLK + 4;                 // staged tile row stride
constexpr int RW_A = BLK * RW_LD;              // floats of a staged tile
constexpr int RW_X = BLK * FT;                 // floats of a staged X slab
constexpr int RW_SMEM = 2 * (RW_A + RW_X) * static_cast<int>(sizeof(float));

// VEC: x starts on a 16-byte boundary and feat % 4 == 0, so X rows copy as
// 16-byte pieces; otherwise 4-byte pieces.  Columns past feat zero-fill.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
bsr_rowwalk_kernel(const float* __restrict__ blocks,
                   const int32_t* __restrict__ row_splits,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ x, float* __restrict__ out,
                   int64_t feat, int64_t slices) {
  extern __shared__ __align__(16) float smem[];
  const int64_t r = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int row0 = row0_of(tid);
  const int col0 = col0_of(tid);

  auto start_copies = [&](int k, int st) {
    float* as = smem + st * RW_A;
    float* xs = smem + 2 * RW_A + st * RW_X;
    const float* a = blocks + static_cast<int64_t>(k) * BLK * BLK;
    for (int q = tid; q < BLK * BLK / 4; q += THREADS) {
      const int row = q / (BLK / 4);
      const int c4 = (q % (BLK / 4)) * 4;
      cp_async16(as + row * RW_LD + c4, a + row * BLK + c4, 16);
    }
    const float* xb = x + static_cast<int64_t>(cols[k]) * BLK * feat;
    if (VEC) {
      for (int q = tid; q < BLK * FT / 4; q += THREADS) {
        const int row = q / (FT / 4);
        const int c4 = (q % (FT / 4)) * 4;
        const int64_t gc = f0 + c4;
        const bool ok = gc < feat;
        cp_async16(xs + row * FT + c4, ok ? xb + row * feat + gc : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int q = tid; q < BLK * FT; q += THREADS) {
        const int row = q / FT;
        const int c = q % FT;
        const int64_t gc = f0 + c;
        const bool ok = gc < feat;
        cp_async4(xs + row * FT + c, ok ? xb + row * feat + gc : x,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[TM][TN];
  load_acc(acc, nullptr, r, f0, row0, col0, feat);
  const int lo = row_splits[r];
  const int nt = row_splits[r + 1] - lo;
  if (nt > 0) {
    start_copies(lo, 0);
    cp_async_commit();
  }
  for (int j = 0; j < nt; ++j) {
    // stage (j+1)&1 was last read in step j-1, which ended on a barrier
    if (j + 1 < nt) {
      start_copies(lo + j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = smem + (j & 1) * RW_A;
    const float* xs = smem + 2 * RW_A + (j & 1) * RW_X;
#pragma unroll 2
    for (int kk = 0; kk < BLK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(as + (row0 + i) * RW_LD + kk);
      }
      float4 b[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        b[t] = *reinterpret_cast<const float4*>(xs + (kk + t) * FT + col0);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[i][0] = fmaf(av[t], b[t].x, acc[i][0]);
          acc[i][1] = fmaf(av[t], b[t].y, acc[i][1]);
          acc[i][2] = fmaf(av[t], b[t].z, acc[i][2]);
          acc[i][3] = fmaf(av[t], b[t].w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
  store_acc(acc, out, r, f0, row0, col0, feat);
}

// the flat grid of a dense walk: num_row_blocks * ceil(feat / FT) CTAs, or
// 0 when it would exceed 2^31 - 1
int64_t walk_ctas(int64_t num_row_blocks, int64_t feat, int64_t* slices) {
  *slices = (feat + FT - 1) / FT;
  const int64_t ctas = num_row_blocks * *slices;
  return ctas > 0x7fffffff ? 0 : ctas;
}

int launch_walk(const void* blocks, const void* row_splits, const void* cols,
                const void* x, const void* init, void* out,
                int64_t num_row_blocks, int64_t feat, void* stream) {
  if (num_row_blocks > 0 && feat > 0) {
    int64_t slices;
    const int64_t ctas = walk_ctas(num_row_blocks, feat, &slices);
    if (ctas == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
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

// K9: out = A . x on the group-padded layout, by the non-zero walk
extern "C" int fitgnn_bsr_spmm_grouped(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* x,
                                       void* out, int64_t num_row_blocks,
                                       int64_t feat, void* stream) {
  return static_cast<int>(sparse::launch<false>(
      static_cast<const float*>(blocks),
      static_cast<const int32_t*>(row_splits), nullptr, nullptr,
      static_cast<const int32_t*>(cols), static_cast<const float*>(x),
      static_cast<float*>(out), num_row_blocks, feat,
      static_cast<cudaStream_t>(stream)));
}

// K10: out = A . x, the row walk; vec != 0 when x starts on a 16-byte
// boundary and feat % 4 == 0
extern "C" int fitgnn_bsr_spmm_rowwalk(const void* blocks,
                                       const void* row_splits,
                                       const void* cols, const void* x,
                                       void* out, int64_t num_row_blocks,
                                       int64_t feat, int vec, void* stream) {
  if (num_row_blocks > 0 && feat > 0) {
    int64_t slices;
    const int64_t ctas = walk_ctas(num_row_blocks, feat, &slices);
    if (ctas == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* b = static_cast<const float*>(blocks);
    const auto* rs = static_cast<const int32_t*>(row_splits);
    const auto* c = static_cast<const int32_t*>(cols);
    const auto* xi = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    if (vec) {
      const cudaError_t set = cudaFuncSetAttribute(
          bsr_rowwalk_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, RW_SMEM);
      if (set != cudaSuccess) return static_cast<int>(set);
      bsr_rowwalk_kernel<true>
          <<<static_cast<unsigned>(ctas), THREADS, RW_SMEM, s>>>(
              b, rs, c, xi, o, feat, slices);
    } else {
      const cudaError_t set = cudaFuncSetAttribute(
          bsr_rowwalk_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, RW_SMEM);
      if (set != cudaSuccess) return static_cast<int>(set);
      bsr_rowwalk_kernel<false>
          <<<static_cast<unsigned>(ctas), THREADS, RW_SMEM, s>>>(
              b, rs, c, xi, o, feat, slices);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
