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
// for every tile, fillers included, dense and in f32.  Replaces
// fitgnn_tpu/ops/pallas/bsr_dynamic.py:_dB_kernel (grid built by
// _dyn_grad_blocks), whose dot_general is the dense product too.
//
// Bound on an H100.  K4 and K4T: bytes.  The function needs 2 FLOPs per
// tile non-zero and feature, and the attention tiles are ~3% full, so the
// dense tiles (64 KiB each), the slabs and the output bound it; a dense
// 128x128 product would spend ~97% of its FMAs on zeros.  The walk votes
// on each tile and applies only its non-zeros, so the coverage fillers
// (zero values) cost their read and nothing more.  K5: bytes, on the
// tensor cores.  dB is dense (2,192 tiles x 128 x 128 outputs on the bench
// graph, 2.F FLOPs each: 36.8 GFLOP at F=512); three TF32 passes at 495
// TFLOP/s take 0.223 ms there, under the bytes (0.250 ms: 143.6 MB of dB
// plus the distinct g and x slabs).  On the CUDA cores (67 TFLOP/s f32)
// the same work would take 0.549 ms and bind it.
//
// K5's design: one CTA of two warpgroups per tile runs the 3xTF32
// tensor-core product of tf32x3.cuh (wgmma m64n128k8 on TF32 hi/lo splits
// of both slabs, F in 32-wide chunks through two 128-byte-swizzled
// shared-memory stages; that header's note has the accuracy argument and
// the one departure from the plain product: an inf in g or x gives NaN,
// not inf) and stores its 64 accumulators a thread as float2 pairs.  F = 0
// writes zeros.  Tiles are sorted by block row and the CTAs start in tile
// order, so the CTAs that run together share their g slabs in L2.  K7's
// score-gradient pass (att_bsr.cu) runs the same product, one copy of it
// in the header.
// Not kept, as no faster at the bench graph's shapes: a third stage that
// keeps one wgmma group in flight across chunks
// (scripts/torch_design_variants.py times it), a cp.async ring of raw
// chunks in place of the register prefetch, and mma.sync m16n8k8 with the
// same split.  Left for later: two
// CTAs an SM (fewer registers and one stage), a persistent grid that
// overlaps a tile's store with the next tile's loads, and a product
// sampled at the tile mask (only ~3% of dB is used downstream, but that
// changes the op's output at every unmasked entry).

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32x3.cuh"
#include "tile_sparse.cuh"

namespace {

constexpr int BLK = tf32x3::BLK;
// the product's two stages, 1 KB aligned
constexpr int GSMEM = tf32x3::SMEM + 1024;

template <bool VEC>
__global__ void __launch_bounds__(tf32x3::THREADS, 1)
dyn_grad_blocks_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ g,
                       const float* __restrict__ x, float* __restrict__ dB,
                       int64_t feat) {
  extern __shared__ unsigned char graw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(graw));
  float* sm = reinterpret_cast<float*>(graw + ((1024 - base % 1024) % 1024));
  const int tid = threadIdx.x;
  const int wg = tid / 128;                     // output rows 64 wg ..
  const int64_t k = blockIdx.x;
  const float* gb = g + static_cast<int64_t>(rows[k]) * BLK * feat;
  const float* xb = x + static_cast<int64_t>(cols[k]) * BLK * feat;

  float d[64];
  tf32x3::product<VEC>(d, sm, gb, xb, feat, tid);

  // accumulator j of a thread: row 64 wg + 16 warp + lane / 4 (+8 for the
  // odd pair), columns 8 (j / 4) + 2 (lane % 4) + {0, 1}
  const int lane = tid & 31;
  const int i0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  float* o = dB + k * BLK * BLK + static_cast<int64_t>(i0) * BLK
             + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(o + 8 * j) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(o + 8 * BLK + 8 * j) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
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
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % 4 == 0;
    const auto kernel = vec ? dyn_grad_blocks_kernel<true>
                            : dyn_grad_blocks_kernel<false>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<static_cast<unsigned>(num_tiles), tf32x3::THREADS, GSMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<float*>(dB), feat);
  }
  return static_cast<int>(cudaGetLastError());
}
