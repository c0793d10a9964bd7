// K8: the block-diagonal run, out_b = (init_b +) A_b . x_b, or A_b^T . x_b,
// for every 128-row block b.
//
// Replaces the TPU kernel fitgnn_tpu/ops/pallas/diag_spmm.py:_make_kernel
// (grids built by _diag_spmm and _diag_spmm_acc, entry diag_spmm_raw).
// There a grid step takes r consecutive diagonal blocks, so its X and out
// slabs are single contiguous DMAs, and the per-step pipeline cost is
// spread over r blocks.  A CUDA grid has no per-step cost to spread: here
// one CTA owns one diagonal block b and one slice of 64 feature columns
// (tile_fma.cuh), and r only has to divide the block count, as on the TPU.
// The transpose contracts the stored block's row axis: a stage copies 32
// rows of A_b straight into the As[k][row] layout that the forward fills
// with 32 transposed columns, so no transposed copy is made anywhere.
//
// Bound on an H100: memory.  The function reads every diagonal block once
// (64 KiB each), x and init, and writes out, at 2 FLOPs per block non-zero
// and feature; the design reads each block once per 64-column slice (the
// slices of one block run together, so the rereads hit L2) and does the
// dense 128x128 product on the CUDA cores.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_fma.cuh"

namespace {

using namespace tile;

template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
diag_spmm_kernel(const float* __restrict__ blocks,
                 const float* __restrict__ x, const float* __restrict__ init,
                 float* __restrict__ out, int64_t feat, int64_t slices) {
  __shared__ __align__(16) ATile As;
  __shared__ __align__(16) XTile Xs;

  const int64_t b = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int row0 = row0_of(tid);
  const int col0 = col0_of(tid);

  float acc[TM][TN];
  load_acc(acc, init, b, f0, row0, col0, feat);

  const float* a = blocks + b * BLK * BLK;
  for (int kc = 0; kc < BLK; kc += KC) {
    if (TRANS) {
      // As[k][i] = A[kc + k][i]: 32 rows of the block, 32 float4 each
      for (int q = tid; q < KC * (BLK / 4); q += THREADS) {
        const int kk = q / (BLK / 4);
        const int c4 = (q % (BLK / 4)) * 4;
        *reinterpret_cast<float4*>(&As[kk][c4]) =
            *reinterpret_cast<const float4*>(
                a + static_cast<int64_t>(kc + kk) * BLK + c4);
      }
    } else {
      stage_a_cols(As, a, kc, tid);
    }
    stage_x_rows(Xs, x + (b * BLK + kc) * feat, f0, feat, tid);
    __syncthreads();
    fma_chunk(As, Xs, acc, row0, col0);
    __syncthreads();
  }
  store_acc(acc, out, b, f0, row0, col0, feat);
}

}  // namespace

// blocks (nb,128,128) f32; x, init (may be null), out (nb*128, feat) f32,
// all contiguous; transpose != 0 contracts each block's row axis.  Returns
// cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1 CTAs,
// else cudaGetLastError() after the launch.
extern "C" int fitgnn_diag_spmm(const void* blocks, const void* x,
                                const void* init, void* out, int64_t nb,
                                int64_t feat, int transpose, void* stream) {
  if (nb > 0 && feat > 0) {
    const int64_t slices = (feat + FT - 1) / FT;
    const int64_t ctas = nb * slices;
    if (ctas > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* bl = static_cast<const float*>(blocks);
    const auto* xi = static_cast<const float*>(x);
    const auto* in = static_cast<const float*>(init);
    auto* o = static_cast<float*>(out);
    if (transpose) {
      diag_spmm_kernel<true><<<static_cast<unsigned>(ctas), THREADS, 0, s>>>(
          bl, xi, in, o, feat, slices);
    } else {
      diag_spmm_kernel<false><<<static_cast<unsigned>(ctas), THREADS, 0, s>>>(
          bl, xi, in, o, feat, slices);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
