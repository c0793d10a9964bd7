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
// for every tile, fillers included, dense and in f32 (above edge 128,
// given the plan's live list, on its live quadrants alone and +0 on the
// others: below).  Replaces fitgnn_tpu/ops/pallas/bsr_dynamic.py:_dB_kernel
// (grid built by _dyn_grad_blocks), whose dot_general is the dense
// product too.
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
// chunks in place of the register prefetch, mma.sync m16n8k8 with the
// same split, and on the live list (below) a persistent grid, one CTA an
// SM walking the list with the next quadrant's first F-chunk loaded while
// the current one's accumulators are stored
// (scripts/variants/dyn_grad_blocks_persistent.cu; at edge 256 on the
// bench graph 0.2655 / 0.7344 ms at F=128 / 512 against the live grid's
// 0.2597 / 0.7009, H100 80GB HBM3 at 700 W).  Left for later: two CTAs an
// SM (fewer registers and one stage), and a product sampled at the tile
// mask (only ~3% of dB is used downstream, but that changes the op's
// output at every unmasked entry).
//
// Tiles of another edge.  The JAX package's build_hybrid(block=E,
// semantics="att_unit") gives GAT (K, E, E) tiles for any E = 128 nq, and
// _dyn_apply and _dyn_grad_blocks take E as a static argument.  Both
// entries here take it as `block`.  K4 and K4T walk an E tile as nq x nq
// quadrants of 128 x 128 (tile_sparse.cuh, QUAD; the columns orientation
// reads quadrant (q, h) of tile sel[k] transposed), so an empty quadrant
// costs only its read.  K5 gives each quadrant (i, j) of a tile a CTA of
// its own, the nq^2 CTAs of a tile adjacent in the grid so that they share
// their slabs in L2: CTA (k, i, j) takes the g slab at node row
// rows[k] E + 128 i and the x slab at cols[k] E + 128 j, runs the same
// product, and stores it at row stride E.  One CTA a whole 256 x 256 tile
// would hold 256 accumulators a thread over two warpgroups, far over the
// register file.  At E = 256 the dense dB is 4x the work of a 128 tile, so
// the tensor cores (three TF32 passes), not the bytes, bound K5 on the
// bench graph.  At E = 128 (nq = 1) both are the kernels above, unchanged.
// With the live list (below) the product runs on the live quadrants alone:
// at F=512 their three TF32 passes still bind it, at F=128 the bytes (the
// dense output, zeros included, and the slabs the live quadrants reach).
//
// Occupancy words (E > 128).  GAT's tile values are pe = where(mask,
// exp(.), 0), zero wherever the att_unit mask is, so the mask's occupancy
// words (its BsrMatrix's quad_bits, tile_sparse.cuh WORDS) cover every
// non-zero of pe.  The plan carries them (ops/bsr_dynamic.py DynPlan:
// words a forward tile, t_words a transpose slot, the tile's word with bit
// i nq + j moved to j nq + i and 0 on a scale-0 filler), and
// fitgnn_bsr_dyn_apply hands them to the walk: K4 and K4T then read and
// apply only the quadrants whose bit is set, each one's slab copy started
// with its tile read (walk_live, rows and columns), and give the walk
// without words bit for bit.  Null words walk every quadrant.  The
// contract: the words are the mask's, and blocks_dyn is zero on every
// quadrant whose bit is clear.  The walk departs from the dense product
// (the plain versions and _dyn_apply, which read no words) only on inputs
// the main path never makes: a non-zero value in a cleared quadrant is
// dropped, and an inf or NaN in x that only such quadrants reach stays
// out of the output (ROADMAP.md §3).
//   K5 takes the plan's live list (DynPlan.live: the words' set bits as
// quadrant ids k nq^2 + qi nq + qj, ascending): CTA b runs the product of
// quadrant live[b] alone, the same code, product and stores as the full
// grid's CTA there, so a live quadrant of dB is the full grid's bit for
// bit; no CTA computes an empty quadrant's product (a third of the bench
// graph's quadrants at threshold 48).  The empty quadrants are written as
// +0 in the same launch: CTA b first stores zeros over the gap between
// live[b - 1] and live[b], and one CTA more covers the gap after the last
// live quadrant (tiles with no live quadrant, the coverage fillers,
// included); a gap's stores are issued before the product's loads and
// need no search and no CTA of their own.  Kept over a torch.empty output
// with a separate store-only pass, a second launch over the same gaps,
// because it is faster at both widths: 0.2597 / 0.7009 ms at F=128 / 512
// on the bench graph against 0.2974 / 0.7449, the full grid 0.3405 /
// 0.9928 (scripts/torch_design_variants.py --k5-live-only, H100 80GB
// HBM3 at 700 W).  The
// divergence (ROADMAP.md §3): on an empty quadrant dB is +0 where
// _dB_kernel gives g x^T.  GAT's only reader of dB is the backward of
// pe = where(mask, exp(.), 0), which keeps dB only where the mask is set,
// and an empty quadrant has no set entry, so no gradient the layer returns
// sees it (and an inf in g or x that only empty quadrants reach leaves dB
// finite).  Null live is the full grid, as before.
//
// bf16 activations (K4a, K4Ta, K5a; the conv stack's dtype=bfloat16, where
// GAT's pe, g and x are bf16).  The Pallas kernels' bf16 branches read
// bf16 tiles and activations and write bf16 (bsr_dynamic.py:82-86 for K4,
// :131-138 and out_dtype at :205-206 for K5).  fitgnn_bsr_dyn_apply_a is
// every walk above (edge 128, quadrants, live quadrants; both
// orientations) on bf16 tiles with bf16 x: the tile is read at 2 bytes an
// entry, the slab copied and read as bf16, the sums f32 and each rounded
// to bf16 once as it is stored (tile_sparse.cuh, A = __nv_bfloat16); the
// Pallas kernel rounds each tile's product into its bf16 block, so the two
// may differ by a bf16 step where a block row has several tiles.
// fitgnn_dyn_grad_blocks_a is K5's grid (full, quadrants, live list with
// its +0 quadrants) with the product of bf16x1.cuh: one wgmma m64n128k16
// pass on bf16 g and x, exact products and f32 sums (3xTF32 on the same
// widened values gives the same products, summed in another order: the
// two differ in the last f32 bits, ROADMAP.md §3), each sum rounded to
// bf16 once as dB is stored.  Its stages are half K5's (no hi/lo split),
// and its bound on the bench graph is the bytes at F=128 and the dense
// bf16 products (one pass at 989 TFLOP/s) at F=512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "bf16x1.cuh"
#include "tf32x3.cuh"
#include "tile_sparse.cuh"

namespace {

constexpr int BLK = tf32x3::BLK;
static_assert(bf16x1::BLK == BLK && bf16x1::THREADS == tf32x3::THREADS,
              "both products take the same CTA");
// the product's two stages, 1 KB aligned: E is g, x and dB's type (f32:
// tf32x3's stages; bf16: bf16x1's)
template <class E>
constexpr int grad_smem() {
  return (std::is_same<E, float>::value ? tf32x3::SMEM : bf16x1::SMEM)
         + 1024;
}

// four +0 entries of dB at p (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void zero4(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero4(__nv_bfloat16* p) {
  *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
}

// dB's entries (i, j), (i, j + 1) from two sums: f32 as they are, bf16
// each rounded once (to nearest even)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Writes dB's quadrants lo .. hi - 1 (ids k nq^2 + qi nq + qj: 128 rows of
// 128 entries at row stride nq 128) as +0, one after another; a warp stores
// one row's contiguous bytes (512 f32, 256 bf16) a step.
template <class E>
__device__ __forceinline__ void zero_quadrants(E* __restrict__ dB,
                                               int64_t lo, int64_t hi,
                                               int nq, int tid) {
  const int64_t edge = static_cast<int64_t>(nq) * BLK;
  for (int64_t q = lo; q < hi; ++q) {
    const int64_t k = q / (nq * nq);
    const int64_t qi = q / nq % nq, qj = q % nq;
    E* o = dB + k * edge * edge + qi * BLK * edge + qj * BLK + 4 * (tid & 31);
#pragma unroll 4
    for (int i = tid >> 5; i < BLK; i += tf32x3::THREADS / 32) {
      zero4(o + i * edge);
    }
  }
}

// E = float: K5 (3xTF32, tf32x3.cuh); E = __nv_bfloat16: K5a (one bf16
// pass, bf16x1.cuh), dB rounded to bf16 once from the f32 sums
template <bool VEC, bool LIVE, bool QUAD, class E = float>
__global__ void __launch_bounds__(tf32x3::THREADS, 1)
dyn_grad_blocks_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols,
                       const int32_t* __restrict__ live,
                       const E* __restrict__ g,
                       const E* __restrict__ x, E* __restrict__ dB,
                       int64_t feat, int64_t num_live, int64_t num_quads,
                       int nq) {
  extern __shared__ unsigned char graw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(graw));
  unsigned char* sm = graw + ((1024 - base % 1024) % 1024);
  const int tid = threadIdx.x;
  const int wg = tid / 128;                     // output rows 64 wg ..
  if (LIVE) {
    // the empty quadrants between live[b - 1] and live[b] (the last CTA,
    // b = num_live: after the last live one) as +0, their stores issued
    // before the product's loads
    const int64_t b = blockIdx.x;
    zero_quadrants(dB, b == 0 ? 0 : live[b - 1] + 1,
                   b == num_live ? num_quads : live[b], nq, tid);
    if (b == num_live) return;
  }
  // the tile, and under QUAD its quadrant (qi, qj): the nq^2 CTAs of a
  // tile are adjacent, so they run together and share their slabs in L2;
  // under LIVE CTA b takes quadrant live[b], ascending, so a tile's live
  // quadrants stay adjacent
  const unsigned id = LIVE ? static_cast<unsigned>(live[blockIdx.x])
                           : blockIdx.x;
  const int64_t k = QUAD ? id / (nq * nq) : id;
  const int quad = QUAD ? static_cast<int>(id % (nq * nq)) : 0;
  const int64_t qi = QUAD ? quad / nq : 0, qj = QUAD ? quad % nq : 0;
  const int64_t edge = QUAD ? static_cast<int64_t>(nq) * BLK : BLK;
  const E* gb = g + (static_cast<int64_t>(rows[k]) * edge + qi * BLK) * feat;
  const E* xb = x + (static_cast<int64_t>(cols[k]) * edge + qj * BLK) * feat;

  float d[64];
  if constexpr (std::is_same<E, float>::value) {
    tf32x3::product<VEC>(d, reinterpret_cast<float*>(sm), gb, xb, feat, tid);
  } else {
    bf16x1::product<VEC>(d, reinterpret_cast<__nv_bfloat16*>(sm), gb, xb,
                         feat, tid);
  }

  // accumulator j of a thread: row 64 wg + 16 warp + lane / 4 (+8 for the
  // odd pair), columns 8 (j / 4) + 2 (lane % 4) + {0, 1} of the quadrant,
  // whose rows lie edge floats apart in dB
  const int lane = tid & 31;
  const int i0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  E* o = dB + k * edge * edge + (qi * BLK + i0) * edge + qj * BLK
         + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store2(o + 8 * j, d[4 * j], d[4 * j + 1]);
    store2(o + 8 * edge + 8 * j, d[4 * j + 2], d[4 * j + 3]);
  }
}

// K4 (A = float, f32 tiles) and K4a / K4Ta (A = __nv_bfloat16, bf16 tiles:
// GAT's pe in the activations' type): the entries below
template <class A>
int launch_apply(const void* blocks, const void* row_splits, const void* sel,
                 const void* scale, const void* cols, const void* words,
                 const void* x, void* out, int64_t num_row_blocks,
                 int64_t feat, int64_t block, int trans, void* stream) {
  if (block < BLK || block % BLK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const A*>(blocks);
  const auto* rs = static_cast<const int32_t*>(row_splits);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* w = static_cast<const uint64_t*>(words);
  const auto* xp = static_cast<const A*>(x);
  auto* op = static_cast<A*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nq = static_cast<int>(block / BLK);
  using sparse::Plain;
  if (trans) {
    return static_cast<int>(
        sparse::launch<true, false, false, false, true, A, Plain, true, A>(
            b, rs, static_cast<const int32_t*>(sel),
            static_cast<const int32_t*>(scale), c, xp, nullptr, op,
            num_row_blocks, feat, s, Plain{}, nq, w));
  }
  return static_cast<int>(
      sparse::launch<false, false, false, false, true, A, Plain, true, A>(
          b, rs, nullptr, nullptr, c, xp, nullptr, op, num_row_blocks, feat,
          s, Plain{}, nq, w));
}

// K5 (E = float) and K5a (E = __nv_bfloat16): the entries below
template <class E>
int launch_grad(const void* rows, const void* cols, const void* live,
                const void* g, const void* x, void* dB, int64_t num_tiles,
                int64_t num_live, int64_t feat, int64_t block,
                void* stream) {
  if (block < BLK || block % BLK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq = static_cast<int>(block / BLK);
  const int64_t quads = num_tiles * nq * nq;
  const bool with_live = live != nullptr;
  if (with_live && (nq < 2 || nq > sparse::MAX_WORD_QUADS || num_live < 0
                    || num_live > quads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (quads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // under live one CTA a live quadrant and one for the empty ones after
  // the last
  const int64_t ctas = with_live ? num_live + 1 : quads;
  if (quads > 0) {
    // 16-byte loads: 4 f32 or 8 bf16 values
    constexpr int64_t PIECE = 16 / sizeof(E);
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % PIECE == 0;
    const auto kernel =
        with_live ? (vec ? dyn_grad_blocks_kernel<true, true, true, E>
                         : dyn_grad_blocks_kernel<false, true, true, E>)
        : nq > 1 ? (vec ? dyn_grad_blocks_kernel<true, false, true, E>
                        : dyn_grad_blocks_kernel<false, false, true, E>)
                 : (vec ? dyn_grad_blocks_kernel<true, false, false, E>
                        : dyn_grad_blocks_kernel<false, false, false, E>);
    constexpr int bytes = grad_smem<E>();
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<static_cast<unsigned>(ctas), tf32x3::THREADS, bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const int32_t*>(live), static_cast<const E*>(g),
        static_cast<const E*>(x), static_cast<E*>(dB), feat, num_live, quads,
        nq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (K,block,block) f32, 16-byte aligned; row_splits
// (num_row_blocks+1,) int32 slot range per output tile row; cols (slots,)
// int32 input tile per slot; words (slots,) int64 occupancy words or null;
// x, out (num_row_blocks*block, feat) f32.  trans != 0 reads each tile
// transposed: sel, scale (slots,) int32 are then the tile read by a slot
// and its scale (0 = filler), and words[k] tile sel[k]'s word transposed
// (0 where scale[k] is 0).  The forward (trans == 0) reads tile k for slot
// k at scale 1, words[k] its word, and passes sel and scale as null.
// block, the tile edge, is a multiple of 128; above 128 the walk takes
// each tile as 128-wide quadrants (tile_sparse.cuh, QUAD), given words
// only the live ones (WORDS); at 128 it is the walk above.  All
// contiguous.  Returns cudaErrorInvalidValue for a block that is not a
// multiple of 128 and for words at 128 or above 1024,
// cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1 CTAs,
// else cudaGetLastError() after the launch.
extern "C" int fitgnn_bsr_dyn_apply(const void* blocks, const void* row_splits,
                                    const void* sel, const void* scale,
                                    const void* cols, const void* words,
                                    const void* x, void* out,
                                    int64_t num_row_blocks, int64_t feat,
                                    int64_t block, int trans, void* stream) {
  return launch_apply<float>(blocks, row_splits, sel, scale, cols, words, x,
                             out, num_row_blocks, feat, block, trans, stream);
}

// K4a and K4Ta: fitgnn_bsr_dyn_apply on bf16 activations, the bf16 branch
// of _make_dyn_kernel (fitgnn_tpu/ops/pallas/bsr_dynamic.py:82-86: bf16
// tiles and x, bf16 x bf16 products in f32, an output of x's type).
// blocks (K,block,block), x and out bf16, the rest as above: the same
// walks (edge 128, the quadrant walk above it, with words the walk of the
// live quadrants) with A = __nv_bfloat16 (tile_sparse.cuh: the slab
// copied and read as bf16, each sum f32 and rounded to bf16 once as it is
// stored, where the Pallas kernel rounds each tile's product into its
// bf16 output block).  The vector slab copy needs x on a 16-byte boundary
// and feat % 8 == 0.  Bound on an H100: bytes, as K4's, with the tiles,
// the slabs and the output at 2 bytes a value.
extern "C" int fitgnn_bsr_dyn_apply_a(const void* blocks,
                                      const void* row_splits,
                                      const void* sel, const void* scale,
                                      const void* cols, const void* words,
                                      const void* x, void* out,
                                      int64_t num_row_blocks, int64_t feat,
                                      int64_t block, int trans,
                                      void* stream) {
  return launch_apply<__nv_bfloat16>(blocks, row_splits, sel, scale, cols,
                                     words, x, out, num_row_blocks, feat,
                                     block, trans, stream);
}

// rows, cols (num_tiles,) int32 tile-row and tile-column ids; g, x (*,
// feat) f32; dB (num_tiles,block,block) f32, 16-byte aligned; all
// contiguous.  block, the tile edge, is a multiple of 128: above 128 each
// tile's nq^2 quadrants (nq = block / 128) are CTAs of their own.  live,
// (num_live,) int32, the quadrants whose product is wanted (ids k nq^2 +
// qi nq + qj, ascending: the mask's live ones, DynPlan.live), or null for
// every quadrant of every tile; given, every other quadrant of dB is
// written as +0 (nq 2 to 8).  feat may be 0 (dB is then written as zeros).
// Returns cudaErrorInvalidValue for a block that is not a multiple of 128
// and for live at another nq or with num_live outside 0 .. num_tiles nq^2,
// cudaErrorInvalidConfiguration when the grid (num_tiles nq^2 CTAs, or
// num_live + 1) would exceed 2^31 - 1, else cudaGetLastError() after the
// launch.
extern "C" int fitgnn_dyn_grad_blocks(const void* rows, const void* cols,
                                      const void* live, const void* g,
                                      const void* x, void* dB,
                                      int64_t num_tiles, int64_t num_live,
                                      int64_t feat, int64_t block,
                                      void* stream) {
  return launch_grad<float>(rows, cols, live, g, x, dB, num_tiles, num_live,
                            feat, block, stream);
}

// K5a: fitgnn_dyn_grad_blocks on bf16 activations, the bf16 branch of
// _dB_kernel (fitgnn_tpu/ops/pallas/bsr_dynamic.py:131-138, out_dtype
// bf16 at :205-206): g, x and dB bf16, the rest as above.  The same grid,
// live list and +0 quadrants; the product is one bf16 wgmma pass
// (bf16x1.cuh, exact products, f32 sums) and each sum is rounded to bf16
// once as dB is stored, as the Pallas kernel rounds its f32 dot (one F
// chunk up to 512) into its bf16 block.  The vector load needs g and x on
// 16-byte boundaries and feat % 8 == 0.  Bound on an H100: bytes at F =
// 128 (dB and the slabs at 2 bytes a value), the dense bf16 products
// (989 TFLOP/s) above.
extern "C" int fitgnn_dyn_grad_blocks_a(const void* rows, const void* cols,
                                        const void* live, const void* g,
                                        const void* x, void* dB,
                                        int64_t num_tiles, int64_t num_live,
                                        int64_t feat, int64_t block,
                                        void* stream) {
  return launch_grad<__nv_bfloat16>(rows, cols, live, g, x, dB, num_tiles,
                                    num_live, feat, block, stream);
}
