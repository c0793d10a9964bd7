// K7: GAT's fused tile attention.  The tile scores are worked out inside
// the kernels from the per-node score vectors, so the (K, 128, 128) score
// and numerator tensors never exist in device memory.
//
// Replaces the TPU kernels of fitgnn_tpu/ops/pallas/att_bsr.py:
//   _rowmax_kernel (entry att_rowmax)  -> att_rowmax_kernel
//   _fwd_kernel    (entry _att_fwd)    -> the rows walk of tile_sparse.cuh
//                                         under the hook att::FwdScores
//   _bwd_t_kernel  (entry _att_bwd_t)  -> the columns walk of
//                                         tile_sparse.cuh under the hook
//                                         att::DxScores (dx); dssrc:
//                                         att_scores_kernel's column
//                                         partials, att_sums_kernel
//   _bwd_f_kernel  (entry _att_bwd_f)  -> dsdst: att_scores_kernel's row
//                                         partials, att_sums_kernel
//
// Notation.  Tile k covers the forward rows i of block rows[k] and the
// forward columns j of block cols[k]; its entry B[k][i][j] != 0 is the
// adjacency mask.  raw = sdst[i] + ssrc[j], e = LeakyReLU(raw) and
// pe = mask ? exp(e - m[i]) : 0.  The exp is taken only where the mask is
// set, so a masked entry never overflows, whatever m holds (-1e30 for a
// row without edges).  The TPU kernels take the exp first and mask after;
// every finite value is the same.
//
// att_rowmax_kernel: one CTA per block row, a warp per 16 rows; each warp
// reads a tile row as one 512-byte float4 load, masks the 128 scores and
// max-reduces them with shuffles; -1e30 where a row has no entry.
//
// The walks (K7f, and K7bt's dx): K4 and K4T of GAT's two-stage path with
// pe formed per non-zero instead of read from a tensor.  The walk of
// tile_sparse.cuh (one CTA of 512 threads per block row and 128-column
// feature slice, a warp per 8 output rows, each tile's non-zeros found by
// ballot and applied alone) calls a value hook on each lane's tile entry:
// the lane whose entry is set works out its pe, and pe is broadcast in the
// entry's place.  The score vectors sit in shared memory beside the tile
// and the slab: the CTA's own block's once, the slot's partner block's
// copied with the slab, so no load waits on them and none holds a
// register through the walk (the rows walk already takes up to 122 of the
// 128 registers that 512 threads may have).  Forward (att::FwdScores): num
// = sum pe @ x over the row's tiles, and the CTAs of slice 0 also write
// den = the row sums of pe (8 partials a lane, one a row, summed across
// the warp at the end); every row is written, 0 where it has no tile.
// Transposed (att::DxScores, the transpose plan's slots): dx[c] += scale .
// pe^T @ g[r]; a filler slot (scale 0) is skipped, but every row is still
// written.  No atomics.
// Each F-slice CTA works out the exps of its tiles' non-zeros again
// (F/128 = 4 times at F=512).  tile_sparse.cuh has the walk's one
// departure from the dense product: an inf in x or g that only masked-out
// entries reach leaves the output finite.
//
// The score gradients: att_scores_kernel, then att_sums_kernel.  d_raw =
// mask . LeakyReLU'(raw) . pe . (<g[i], x[j]> + dden[i]) is one number per
// tile entry; _bwd_f_kernel sums it over j into dsdst[i], the dssrc half
// of _bwd_t_kernel over i into dssrc[j].  The pass computes it once and
// reduces it along both axes: one CTA (two warpgroups) per forward tile k,
// K5's grid.  tf32x3.cuh's tensor-core product (K5's mainloop: wgmma
// m64n128k8 on 3xTF32 splits, F in 32-wide chunks) forms <g[i], x[j]> for
// the whole 128x128 tile, g[rows[k]] against x[cols[k]], while the tile
// and the score vectors (ssrc of the column block; sdst, m and dden of the
// row block) are copied into shared memory with cp.async.  The epilogue
// works in the accumulator's own layout (2 rows x 32 columns a thread):
// the mask, read from the staged tile, selects, and the exp's argument is
// 0 where it is not set; no branch, so the 64 entries interleave (with a
// branch per entry the epilogue took twice as long).  Its row sums are
// summed over the quad, its column sums over the warp's 16 rows with
// shuffles and then over the 8 warps
// through shared memory in a fixed order: one row and one column partial
// per (tile, row or column), two (K, 128) scratch tensors (1.1 MB each on
// the bench graph).  att_sums_kernel (one warp per 128-row block, its
// partial loads issued before its adds) then adds, in order, the row
// partials of block row r's tiles row_splits[r] .. row_splits[r+1] into
// dsdst, and scale . cpart[sel] over the transpose plan's slots of block
// c into dssrc, skipping the
// coverage fillers (scale 0): every real forward tile is one slot, so this
// is the JAX kernel's sum in the plan's order.  No atomics, so two launches
// are bit-equal.  The dense product costs nothing the bytes do not: at 3%
// fill the 97% of FMAs spent on zeros run on tensor cores that would
// otherwise idle.  Like K5, the split gives NaN, not inf, where an inf in
// g or x reaches a masked-in entry; an inf that only masked-out entries
// reach stays out of both sums (the select).
//
// Bound on an H100.  att_rowmax: bytes (every tile read once).  The walks:
// bytes (tiles, slabs, the three score vectors, output), 2.F + ~5 FLOPs
// per tile non-zero (the product, the score, LeakyReLU, subtract, exp and,
// forward, den's add).  att_scores: bytes (the tiles, the distinct g and x
// slabs, four vectors, dsdst and the partials); its dense product, 3 TF32
// passes of 2.F FLOPs per tile entry, takes 0.223 ms at F=512 on the bench
// graph's 2,192 tiles at 495 TFLOP/s, under those bytes.  The function
// needs 2.F + ~8 FLOPs per mask entry.  att_sums: bytes (the partials
// once, dssrc and dsdst once; with the words, the live quadrants'
// partials alone).
//
// Not kept: att_reduce_kernel, the two reductions before this pass (a CTA
// per block, each mask entry's partner feature row reread from L2 and
// dotted on the CUDA cores, the same d_raw computed twice; 3x the time on
// the bench graph); and, each timed against the pass on synthetic tiles of
// the bench graph's shape by scripts/torch_design_variants.py, one CTA
// per block row over its
// tiles with the row sums in registers (a row's g slab refetched per tile
// without the L2 sharing of the tile order; 12-33% slower); the mask read
// from device memory in the epilogue, or its copy started inside or after
// the product (no faster); a branch per entry in place of the selects;
// __expf; the column sums reduce-scattered over the lane groups (its
// array left registers); and the product sampled at the mask's entries on
// the CUDA cores (scripts/variants/att_scores_sampled.cu; 1.8-2.1x
// slower).  The epilogue still runs after the product with nothing to
// overlap it at one CTA an SM; one exp per entry shared between K7f's
// F-slices is later work too.
//
// bf16 masks (train --hybrid_bf16_tiles; the JAX package passes the bf16
// tiles to the same kernels, fitgnn_tpu/ops/tile_gat.py:366-378): the
// tiles are GAT's 0/1 mask, exact in bf16, and only their type changes;
// pe, x, g and every sum stay f32, and x is not rounded.  The entries
// ending in _bf16 read them: att_rowmax_kernel<bf16> reads a tile row as
// one 256-byte load a warp (8 bytes a lane, widened to f32); the walks are
// tile_sparse.cuh's bf16 instantiations under the same hooks; and
// att_scores_kernel<VEC, bf16> stages the tile as bf16 (32 KB), 16-byte
// chunk q (8 entries) of row i at chunk q ^ (i % 8), so that the
// epilogue's 4-byte pair reads of 8 rows spread over all banks.
//
// Tiles of another edge (QUAD): the JAX package's build_hybrid(block=E,
// semantics="att_unit") under FITGNN_GAT_FUSED_TILES=1 hands its (K, E, E)
// masks to the same kernels, whose entries take E as their static block
// (fitgnn_tpu/ops/pallas/att_bsr.py:96, 146, 223, 292).  Every entry here
// takes the edge, block = 128 nq; at 128 each kernel is the one above,
// unchanged (QUAD is a template flag, as in tile_sparse.cuh).  Above 128:
// * att_rowmax_kernel runs one CTA per 128-row output block ob (half
//   h = ob % nq of tile row ob / nq) and reads quadrants (h, q) of each
//   tile of the row, their rows at stride E, against ssrc of 128-column
//   block cols[k] nq + q; the max is bit-exact, as at 128;
// * the walks are tile_sparse.cuh's quadrant walk under the same hooks,
//   which keep their 128-row score slices: begin and finish take the CTA's
//   output block, the tile step the slab of the quadrant being applied
//   (the columns of quadrant (h, q) forward, the forward rows of quadrant
//   (q, h) for dx); an empty quadrant costs only its read, and a scale-0
//   filler slot skips all of its quadrants;
// * the score pass runs K5's quadrant grid: one CTA (two warpgroups) per
//   quadrant (qi, qj), the nq^2 CTAs of a tile adjacent so that they share
//   their slabs in L2; it multiplies the g slab of 128-row block
//   rows[k] nq + qi against the x slab of cols[k] nq + qj, stages the
//   quadrant (read at row stride E, the same swizzle), ssrc of the column
//   slab and sdst, m and dden of the row slab.  One CTA a whole 256 x 256
//   tile would hold 256 accumulators a thread (K5's finding).  Its partials
//   are (K, nq, E), rpart[k][qj][128 qi + i] (row i's sum over quadrant
//   column qj) and cpart[k][qi][128 qj + j] (column j's over quadrant row
//   qi), each written by one CTA: no atomics, so two launches stay
//   bit-equal, and at nq = 1 they are the (K, 128) partials above.
//   att_sums_kernel runs one warp per 128-row block and adds a tile's nq
//   partials of that half in order before it adds them as at 128.
// Occupancy words (QUAD up to nq = 8; the dynamic plan's words of the
// mask, DynPlan.words, and their live list, DynPlan.live): a third of the
// bench graph's quadrants at threshold 48 are empty (1,581 of 4,696).
// * K7f walks the live quadrants alone (tile_sparse.cuh's walk_live under
//   FwdScores: no read, vote or wait for an empty quadrant, the next live
//   quadrant's slab and ssrc copied while the current one is applied; den's
//   partials in shared memory, where in registers they would spill the
//   walk), and gives the walk of every quadrant bit for bit: the live
//   quadrants in the same order, the same adds;
// * K7bt's dx walks the live quadrants of the transpose slots' words
//   (DynPlan.t_words: each slot's tile word transposed, 0 on a filler) in
//   the columns form of walk_live under DxScores: the partner block's sdst
//   and m double-buffered beside the slabs and copied into each slab's
//   group, so the copy of the next live quadrant's slab and scores runs
//   beside the current apply, where the walk without words started both
//   after its vote on each quadrant; pe formed as there, four values of a
//   float4 before their ballots, so dx is that walk's bit for bit, f32 and
//   bf16 masks;
// * the score pass runs its grid on the live list (LIVE): CTA i takes
//   quadrant live[i] = k nq^2 + qi nq + qj, ascending, so a tile's live
//   quadrants stay adjacent; everything inside a CTA is as above.  The
//   wrapper zeroes the partials first: an empty quadrant's, which no CTA
//   writes, are +0, what its CTA writes without the list (the select
//   drops every product, inf or NaN ones too).  So the partials, dssrc and
//   dsdst are the full grid's bit for bit, and a third of the tensor-core
//   work and of the CTAs is gone on the bench graph;
// * the sums read the partials of the live quadrants alone: bit h nq + u
//   of words[k] for rpart[k][u][128 h + i], of t_words[s] for
//   cpart[t_sel[s]][u][128 h + j] (att_sums_kernel says why the result is
//   the sum of every partial bit for bit, on partials that are +0 where
//   the bit is clear).
// Bounds at E as at 128, each live tile read whole (256 KiB at 256, bf16
// 128 KiB); the pass's dense product is 4x a 128 tile's entries, so at
// E = 256 its three TF32 passes (2.F FLOPs an entry each) bound it by the
// operations on the bench graph.  With the words each live quadrant is
// read once (64 KiB, bf16 32 KiB) with the slabs the live quadrants reach
// (and each slot's word), and the dense product runs over the live
// quadrants alone.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32x3.cuh"
#include "tile_sparse.cuh"

namespace {

constexpr int BLK = 128;                          // tile edge (rows = cols)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;               // 256
constexpr int ROWS_PER_WARP = BLK / WARPS;        // 16
constexpr float NEG = -1e30f;

constexpr int MAX_F = 512;                        // the pass's widest F

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float att_pe(float mask, float raw, float m,
                                        float slope) {
  return mask != 0.f ? expf(leaky(raw, slope) - m) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// QUAD: (K, E, E) tiles, E = nq * 128 (nq > 1); CTA ob takes the 128-row
// output block ob, half h = ob % nq of tile row r = ob / nq, and walks
// quadrants (h, q), q < nq, of each tile of row r, their rows at stride E,
// against ssrc of 128-column block cols[k] nq + q.  Without QUAD nq is 1
// and unread.
template <class T, bool QUAD>
__global__ void __launch_bounds__(THREADS)
att_rowmax_kernel(const T* __restrict__ blocks,
                  const int32_t* __restrict__ row_splits,
                  const int32_t* __restrict__ cols,
                  const float* __restrict__ ssrc,
                  const float* __restrict__ sdst, float* __restrict__ out,
                  float slope, int nq) {
  const int64_t ob = blockIdx.x;
  const int64_t r = QUAD ? ob / nq : ob;
  const int64_t h = QUAD ? ob % nq : 0;
  const int64_t edge = QUAD ? static_cast<int64_t>(nq) * BLK : BLK;
  // QUAD: a tile row's entries; the row offsets i ld stay 32-bit (as
  // 64-bit products of a runtime edge they spilled registers)
  const int ld = nq * BLK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float rm[ROWS_PER_WARP];
  float sd[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    rm[q] = NEG;
    sd[q] = sdst[ob * BLK + warp + WARPS * q];
  }
  const int lo = row_splits[r];
  const int hi = row_splits[r + 1];
  for (int k = lo; k < hi; ++k) {
    for (int qc = 0; qc < (QUAD ? nq : 1); ++qc) {
      const int64_t cb = QUAD ? static_cast<int64_t>(cols[k]) * nq + qc
                              : cols[k];
      const float* ss = ssrc + cb * BLK + 4 * lane;
      const float s0 = ss[0], s1 = ss[1], s2 = ss[2], s3 = ss[3];
      const T* a = blocks + static_cast<int64_t>(k) * edge * edge
                   + h * BLK * edge + qc * BLK + 4 * lane;
#pragma unroll
      for (int q = 0; q < ROWS_PER_WARP; ++q) {
        const int i = warp + WARPS * q;
        const float4 v = sparse::load4(
            QUAD ? a + i * ld : a + static_cast<int64_t>(i) * BLK);
        float mx = NEG;
        if (v.x != 0.f) mx = fmaxf(mx, leaky(sd[q] + s0, slope));
        if (v.y != 0.f) mx = fmaxf(mx, leaky(sd[q] + s1, slope));
        if (v.z != 0.f) mx = fmaxf(mx, leaky(sd[q] + s2, slope));
        if (v.w != 0.f) mx = fmaxf(mx, leaky(sd[q] + s3, slope));
        rm[q] = fmaxf(rm[q], warp_max(mx));
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      out[ob * BLK + warp + WARPS * q] = rm[q];
    }
  }
}

// two consecutive staged tile entries as f32
__device__ __forceinline__ float2 mask_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 mask_pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(sparse::bf16_lo(w), sparse::bf16_hi(w));
}

// d_raw of one tile entry: the score gradient where the mask is set, else
// 0 by a select (an inf or NaN product at an unmasked entry never reaches
// the sums).  No branch, so the 64 entries of a thread interleave: every
// entry's exp is taken, of its score where the mask is set and of 0
// elsewhere, so none overflows whatever m holds (-1e30 for a row without
// edges).
__device__ __forceinline__ float score_grad(float acc, float mask, float raw,
                                            float m, float dd, float slope) {
  const bool set = mask != 0.f;
  const float v = (acc + dd) * expf(set ? leaky(raw, slope) - m : 0.f);
  return set ? (raw >= 0.f ? v : slope * v) : 0.f;
}

// shared memory of att_scores_kernel (floats after the 1 KB-aligned
// product stages): the tile, swizzled; ssrc of its column block; sdst, m
// and dden of its row block; the eight warps' column sums
constexpr int SC_TILE = BLK * BLK;
constexpr int SC_SMEM = tf32x3::SMEM + 1024
    + (SC_TILE + 4 * BLK + WARPS * BLK) * static_cast<int>(sizeof(float));
static_assert(tf32x3::THREADS == THREADS, "a warp per 16 tile rows");

template <bool VEC, class T, bool LIVE, bool QUAD>
__global__ void __launch_bounds__(THREADS, 1)
att_scores_kernel(const T* __restrict__ blocks,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ live,
                  const float* __restrict__ ssrc,
                  const float* __restrict__ sdst,
                  const float* __restrict__ m,
                  const float* __restrict__ dden,
                  const float* __restrict__ g, const float* __restrict__ x,
                  float* __restrict__ cpart, float* __restrict__ rpart,
                  int64_t feat, float slope, int nq) {
  extern __shared__ unsigned char sraw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sraw));
  float* sm = reinterpret_cast<float*>(sraw + ((1024 - base % 1024) % 1024));
  float* ts = sm + 2 * tf32x3::STAGE;             // the tile
  float* ss = ts + SC_TILE;                       // ssrc of block cols[k]
  float* rv = ss + BLK;                           // sdst, m, dden of rows[k]
  float* cs = rv + 3 * BLK;                       // [warp][column] sums
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // tile k and, under QUAD, its quadrant (qi, qj): quadrant id = k nq^2 +
  // qi nq + qj, CTA id, so the nq^2 CTAs of a tile run together and share
  // their slabs in L2 (K5's grid); under LIVE CTA i takes id live[i], the
  // live quadrants in ascending order (a tile's still adjacent); r and c
  // count 128-row blocks
  const unsigned id = LIVE ? static_cast<unsigned>(live[blockIdx.x])
                           : blockIdx.x;
  const int64_t k = QUAD ? id / (nq * nq) : id;
  const int64_t qi = QUAD ? id / nq % nq : 0;
  const int64_t qj = QUAD ? id % nq : 0;
  const int64_t edge = QUAD ? static_cast<int64_t>(nq) * BLK : BLK;
  const int64_t r = QUAD ? static_cast<int64_t>(rows[k]) * nq + qi : rows[k];
  const int64_t c = QUAD ? static_cast<int64_t>(cols[k]) * nq + qj : cols[k];
  // where its partials go, (K, nq, E) each: the row sums over its columns
  // at rpart[k][qj][128 qi + i], the column sums over its rows at
  // cpart[k][qi][128 qj + j]
  const int64_t rp = QUAD ? (k * nq + qj) * nq + qi : k;
  const int64_t cp = LIVE ? (k * nq + qi) * nq + qj
                          : QUAD ? static_cast<int64_t>(blockIdx.x) : k;
  // the tile (its quadrant, rows at stride E) and the score vectors into
  // shared memory while the product runs (no load waits): 16-byte chunk q
  // of tile row i at chunk q ^ (i % 8), so the epilogue's float2 (bf16:
  // 4-byte pair) reads of 8 rows and 4 column pairs spread over all banks
  constexpr int PER = 16 / sizeof(T);             // entries a chunk: 4 or 8
  const T* tile = blocks + k * edge * edge + qi * BLK * edge + qj * BLK;
  T* tt = reinterpret_cast<T*>(ts);
#pragma unroll
  for (int u = 0; u < SC_TILE / PER / THREADS; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (BLK / PER);
    sparse::cp_async16(
        reinterpret_cast<float*>(tt + i * BLK
                                 + PER * ((q % (BLK / PER)) ^ (i & 7))),
        reinterpret_cast<const float*>(
            QUAD ? tile + i * edge + PER * (q % (BLK / PER)) : tile + PER * q),
        16);
  }
  if (tid < BLK) {
    sparse::cp_async4(ss + tid, ssrc + c * BLK + tid, 4);
    sparse::cp_async4(rv + tid, sdst + r * BLK + tid, 4);
    sparse::cp_async4(rv + BLK + tid, m + r * BLK + tid, 4);
    sparse::cp_async4(rv + 2 * BLK + tid, dden + r * BLK + tid, 4);
  }
  sparse::cp_async_commit();

  float d[64];                                    // <g_i, x_j>, 3xTF32
  tf32x3::product<VEC>(d, sm, g + r * BLK * feat, x + c * BLK * feat, feat,
                       tid);
  sparse::cp_async_wait<0>();
  __syncthreads();

  // the accumulator's rows i0 and i0 + 8 (tf32x3.cuh's layout: 64 wg + 16
  // (warp % 4) = 16 warp), so both rows have the swizzle key lane / 4
  const int i0 = warp * 16 + (lane >> 2);
  const int key = lane >> 2;
  const float sd0 = rv[i0], sd1 = rv[i0 + 8];
  const float m0 = rv[BLK + i0], m1 = rv[BLK + i0 + 8];
  const float dd0 = rv[2 * BLK + i0], dd1 = rv[2 * BLK + i0 + 8];
  // d_raw in the accumulator's own layout: register 4j + {0, 1} is row i0
  // at columns 8j + 2 (lane % 4) + {0, 1}, 4j + {2, 3} row i0 + 8; the
  // column sums of the thread's two rows replace registers 4j and 4j + 1
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const int at = i0 * BLK + PER * ((col / PER) ^ key) + (col % PER);
    const float2 k0 = mask_pair(tt + at);
    const float2 k1 = mask_pair(tt + at + 8 * BLK);
    const float s0 = ss[col], s1 = ss[col + 1];
    const float a0 = score_grad(d[4 * j], k0.x, sd0 + s0, m0, dd0, slope);
    const float a1 = score_grad(d[4 * j + 1], k0.y, sd0 + s1, m0, dd0, slope);
    const float b0 = score_grad(d[4 * j + 2], k1.x, sd1 + s0, m1, dd1, slope);
    const float b1 = score_grad(d[4 * j + 3], k1.y, sd1 + s1, m1, dd1, slope);
    rs0 += a0 + a1;
    rs1 += b0 + b1;
    d[4 * j] = a0 + b0;
    d[4 * j + 1] = a1 + b1;
  }
  // the tile's row partials: the thread's 32 columns, then the quad's
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
  if ((lane & 3) == 0) {
    rpart[rp * BLK + i0] = rs0;
    rpart[rp * BLK + i0 + 8] = rs1;
  }
  // its column partials: the warp's 16 rows (the 8 lane groups), then the
  // 8 warps in a fixed order
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      d[4 * j] += __shfl_xor_sync(0xffffffffu, d[4 * j], o);
      d[4 * j + 1] += __shfl_xor_sync(0xffffffffu, d[4 * j + 1], o);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(cs + warp * BLK + 8 * j + 2 * lane) =
          make_float2(d[4 * j], d[4 * j + 1]);
    }
  }
  __syncthreads();
  if (tid < BLK) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += cs[w * BLK + tid];
    cpart[cp * BLK + tid] = v;
  }
}

// The partials' sums (K7sums): one warp per 128-row block, 8 warps a CTA
// (2,648 warps in 331 CTAs on the bench graph: one wave).  Warp b < nb
// gives dsdst[b] = the row partials of block row b's tiles row_splits[b]
// .. row_splits[b+1], in order; warp nb + c gives dssrc[c] = the column
// partials of the transpose plan's slots of block c, in order, times their
// scale (a coverage filler, scale 0, is skipped).  Lane l owns rows 4l ..
// 4l + 3 of the block, read and written as one float4.  Every row is
// written, 0 where no tile adds to it.  nb counts 128-row blocks, half h =
// b % nq of tile row (column) b / nq: a tile's partials of that half,
// rpart[k][u][128 h + i] over its quadrant columns u (cpart[t_sel][u][...]
// over its quadrant rows), are summed in order first, then added; at nq =
// 1 the one partial is added as it is.
//
// The loads before the adds: the warp reads its slot range once, then the
// range's slots 32 at a time, one a lane (the tile, its scale and its
// word, each a load of its own), and hands them out with shuffles,
// SUM_SLOTS slots at a time (a block row of the bench graph holds 1.77
// slots on average, 6 at most, at edge 256): every live partial of those
// slots is loaded into registers (QB of them a slot, fixed at nq = 1 and
// 2) before the first of their adds, which then run in the order above.
// A warp so waits for about three dependent loads (the range, the slots,
// the partials); the CTA a block it replaces (2,648 CTAs of 128 threads on
// the bench graph, 1.25 waves) loaded a tile's slot and then each partial,
// one after another.  At nq = 2, 4 slots a batch (80 registers) were
// slower than 3 (68), and 6 (110) did not fit the grid in one wave; a
// cursor that handed out one partial at a time
// (scripts/variants/att_sums_cursor.cu, 100 registers) was no faster than
// the CTA a block (scripts/torch_design_variants.py --k7sums-only).
//
// Occupancy words (words, t_words; nq 2 to 8): the partial of quadrant u
// of half h, bit h nq + u of the slot's word (the forward tile's for
// dsdst; for dssrc the transpose slot's, its tile's word transposed, 0 on
// a filler), is read only where that bit is set, and a tile without a set
// bit in the half is skipped whole.  The pass writes +0 into an empty
// quadrant's partials, so this is the sum of every partial bit for bit:
// leaving out a zero addend changes a tile's sum t at most in the sign of
// a zero (x + 0 is x unless x is a zero too), and v starts at +0 and is
// never -0 (under round-to-nearest a sum, or an fma, is -0 only when both
// of its addends are), so v + t and fmaf(1, t, v) absorb a zero t of
// either sign.  Null words read every partial.
constexpr int SUM_WARPS = 8;
constexpr int SUM_SLOTS = 3;                      // slots a batch of loads

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 fma4(float s, float4 a, float4 b) {
  return make_float4(fmaf(s, a.x, b.x), fmaf(s, a.y, b.y), fmaf(s, a.z, b.z),
                     fmaf(s, a.w, b.w));
}

// partial u of tile k's half at part (the half's offset and the lane's
// rows already added)
__device__ __forceinline__ float4 ld4(const float* part, int k, int nq,
                                      int u, int64_t stride) {
  return __ldg(reinterpret_cast<const float4*>(
      part + (static_cast<int64_t>(k) * nq + u) * stride));
}

// QB: the quadrants of a tile half (nq) where the instantiation fixes them
// (1, 2), else 0 (nq read at run time: each partial loaded where it is
// added)
template <int QB>
__global__ void __launch_bounds__(SUM_WARPS * 32)
att_sums_kernel(const float* __restrict__ cpart,
                const float* __restrict__ rpart,
                const int32_t* __restrict__ row_splits,
                const int32_t* __restrict__ t_splits,
                const int32_t* __restrict__ t_sel,
                const int32_t* __restrict__ t_scale,
                const int64_t* __restrict__ words,
                const int64_t* __restrict__ t_words,
                float* __restrict__ dssrc, float* __restrict__ dsdst,
                int64_t nb, int nq) {
  constexpr unsigned FULL = 0xffffffffu;
  if (QB) nq = QB;
  const int lane = threadIdx.x % 32;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * SUM_WARPS + threadIdx.x / 32;
  if (w >= 2 * nb) return;
  const bool dst = w < nb;
  const int64_t b = dst ? w : w - nb;
  const int h = static_cast<int>(b % nq);
  const int64_t* wd = dst ? words : t_words;
  const float* part = (dst ? rpart : cpart) + h * BLK + 4 * lane;
  const int64_t stride = static_cast<int64_t>(nq) * BLK;  // quadrant u + 1
  const int32_t* splits = (dst ? row_splits : t_splits) + b / nq;
  const int lo = splits[0], hi = splits[1];
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int n = min(32, hi - c0);
    // the lane's slot: its tile, its scale and the quadrants of half h it
    // reads, a bit each (without words all of them; none on a filler)
    int tile = 0;
    float scale = 0.f;
    uint32_t bits = 0;
    if (lane < n) {
      const int s = c0 + lane;
      tile = dst ? s : t_sel[s];
      scale = dst ? 1.f : static_cast<float>(t_scale[s]);
      const uint64_t word = wd == nullptr ? 0 : wd[s];
      if (scale != 0.f) {
        bits = wd == nullptr ? FULL
                             : static_cast<uint32_t>((word >> (h * nq)) &
                                                     ((1u << nq) - 1));
      }
    }
    for (int j0 = 0; j0 < n; j0 += SUM_SLOTS) {
      // SUM_SLOTS slots handed out, their partials loaded, then added
      float4 buf[SUM_SLOTS][QB ? QB : 1];
      uint32_t bj[SUM_SLOTS];
      int kj[SUM_SLOTS];
      float sj[SUM_SLOTS];
#pragma unroll
      for (int i = 0; i < SUM_SLOTS; ++i) {
        const int j = j0 + i;
        bj[i] = __shfl_sync(FULL, bits, j % 32);
        kj[i] = __shfl_sync(FULL, tile, j % 32);
        sj[i] = __shfl_sync(FULL, scale, j % 32);
        if (j >= n) bj[i] = 0;
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          if ((bj[i] >> u) & 1) buf[i][u] = ld4(part, kj[i], nq, u, stride);
        }
      }
#pragma unroll
      for (int i = 0; i < SUM_SLOTS; ++i) {
        if (bj[i] == 0) continue;
        float4 t = v;
        bool first = true;
#pragma unroll
        for (int u = 0; u < (QB ? QB : nq); ++u) {
          if (wd == nullptr || (bj[i] >> u) & 1) {
            const float4 q = QB ? buf[i][QB ? u : 0]
                                : ld4(part, kj[i], nq, u, stride);
            t = first ? q : add4(t, q);
            first = false;
          }
        }
        v = dst ? add4(v, t) : fma4(sj[i], t, v);
      }
    }
  }
  *reinterpret_cast<float4*>((dst ? dsdst : dssrc) + b * BLK + 4 * lane) = v;
}

}  // namespace

// The walk's value hooks (tile_sparse.cuh): a lane's tile entry e becomes
// pe where e != 0, from score vectors staged in the walk's shared memory hs:
// the CTA's own block once, the slot's partner block with each tile's slab
// (cp.async, 4 bytes a thread).  Entry (i, j) of a tile is (row0 + o,
// lane + 32m) in the rows orientation, (lane + 32m, row0 + o) in the
// columns orientation.  Blocks here are 128-row blocks: under QUAD the
// walk passes the CTA's output block and the current quadrant's partner
// slab, so (i, j) are entries of that quadrant.
namespace att {

constexpr int BLK = sparse::BLK;
constexpr int ROWS = sparse::ROWS;                // output rows a warp: 8

// K7f on the rows walk: entry (i, j) of a tile of output block r and input
// block c = cols[k] gives pe = exp(LeakyReLU(sdst[i] + ssrc[j]) - m[i]).
// hs holds sdst and m of block r, then ssrc of block c.  den's partials,
// one a warp's output row, are summed across the warp at the end and
// written by the CTAs of slice 0 (den null: not written).
struct FwdScores {
  static constexpr int SMEM = 3 * BLK;
  const float* ssrc;
  const float* sdst;
  const float* m;
  float* den;
  float slope;
  float dsum[ROWS];

  __device__ __forceinline__ void begin(float* hs, int64_t r, int tid) {
    if (tid < 2 * BLK) {
      hs[tid] = tid < BLK ? __ldg(sdst + r * BLK + tid)
                          : __ldg(m + r * BLK + tid - BLK);
    }
#pragma unroll
    for (int o = 0; o < ROWS; ++o) dsum[o] = 0.f;
  }
  __device__ __forceinline__ void tile(float* hs, int64_t c, int tid) {
    if (tid < BLK) {
      sparse::cp_async4(hs + 2 * BLK + tid, ssrc + c * BLK + tid, 4);
    }
    sparse::cp_async_commit();
  }
  __device__ __forceinline__ float value(float* hs, float e, int o, int mm,
                                         int row0, int lane) {
    const int i = row0 + o;
    const float p = att_pe(e, hs[i] + hs[2 * BLK + lane + 32 * mm],
                           hs[BLK + i], slope);
    dsum[o] += p;
    return p;
  }
  __device__ __forceinline__ void finish(int64_t r, int64_t f0, int row0,
                                         int lane) {
    if (den == nullptr || f0 != 0) return;        // uniform across the CTA
#pragma unroll
    for (int o = 0; o < ROWS; ++o) {
      const float v = warp_sum(dsum[o]);
      if (lane == 0) den[r * BLK + row0 + o] = v;
    }
  }

  // The walk of the live quadrants (WORDS): hs holds sdst and m of block
  // r, ssrc of the partner slab in two buffers (one a slab buffer, copied
  // into that slab's group), then den's partials, one a lane and output
  // row at hs[4 BLK + 32 i + lane]: in registers they spilled the walk,
  // which already takes 127-128 of its 128.  Each lane's partial is its
  // own, read and written by it alone, and takes the adds of dsum in the
  // same order, so den is the walk without words' bit for bit.
  static constexpr int SMEM_LIVE = 4 * BLK + sparse::THREADS * ROWS;

  __device__ __forceinline__ float* partial(float* hs, int i, int lane) {
    return hs + 4 * BLK + 32 * i + lane;
  }
  __device__ __forceinline__ void begin_live(float* hs, int64_t r, int tid) {
    begin(hs, r, tid);                            // dsum stays unread
    const int row0 = (tid >> 5) * ROWS;
#pragma unroll
    for (int o = 0; o < ROWS; ++o) *partial(hs, row0 + o, tid & 31) = 0.f;
  }
  __device__ __forceinline__ void stage(float* hs, int buf, int64_t c,
                                        int tid) {
    if (tid < BLK) {
      sparse::cp_async4(hs + (2 + buf) * BLK + tid, ssrc + c * BLK + tid, 4);
    }
  }
  __device__ __forceinline__ float value_live(float* hs, int buf, float e,
                                              int o, int mm, int row0,
                                              int lane) {
    const int i = row0 + o;
    const float p = att_pe(e, hs[i] + hs[(2 + buf) * BLK + lane + 32 * mm],
                           hs[BLK + i], slope);
    *partial(hs, i, lane) += p;
    return p;
  }
  __device__ __forceinline__ void finish_live(float* hs, int64_t r,
                                              int64_t f0, int row0,
                                              int lane) {
    if (den == nullptr || f0 != 0) return;        // uniform across the CTA
#pragma unroll
    for (int o = 0; o < ROWS; ++o) {
      const float v = warp_sum(*partial(hs, row0 + o, lane));
      if (lane == 0) den[r * BLK + row0 + o] = v;
    }
  }
};

// K7bt's dx on the columns walk: slot k reads tile sel[k], whose rows are
// forward block p = cols[k] and whose columns are the output block r, so
// entry (j, q) gives pe = exp(LeakyReLU(sdst[j] + ssrc[q]) - m[j]) (the
// walk scales it by the slot's scale).  hs holds ssrc of block r, then
// sdst and m of block p.
struct DxScores {
  static constexpr int SMEM = 3 * BLK;
  const float* ssrc;
  const float* sdst;
  const float* m;
  float slope;

  __device__ __forceinline__ void begin(float* hs, int64_t r, int tid) {
    if (tid < BLK) hs[tid] = __ldg(ssrc + r * BLK + tid);
  }
  __device__ __forceinline__ void tile(float* hs, int64_t p, int tid) {
    if (tid < 2 * BLK) {
      sparse::cp_async4(hs + BLK + tid,
                        tid < BLK ? sdst + p * BLK + tid
                                  : m + p * BLK + tid - BLK, 4);
    }
    sparse::cp_async_commit();
  }
  __device__ __forceinline__ float value(float* hs, float e, int o, int mm,
                                         int row0, int lane) {
    const int j = lane + 32 * mm;
    return att_pe(e, hs[BLK + j] + hs[row0 + o], hs[2 * BLK + j], slope);
  }
  __device__ __forceinline__ void finish(int64_t, int64_t, int, int) {}

  // The walk of the live quadrants (WORDS, the transpose slots' words):
  // hs holds ssrc of block r, then sdst and m of the partner block p in
  // two buffers of 2 BLK floats (one a slab buffer, copied into that
  // slab's group), so the copy of the next live quadrant's partner runs
  // beside the current apply.  pe is formed as value forms it, so dx is
  // the walk without words' bit for bit.
  static constexpr int SMEM_LIVE = 5 * BLK;

  __device__ __forceinline__ void begin_live(float* hs, int64_t r, int tid) {
    begin(hs, r, tid);
  }
  __device__ __forceinline__ void stage(float* hs, int buf, int64_t p,
                                        int tid) {
    if (tid < 2 * BLK) {
      sparse::cp_async4(hs + (1 + 2 * buf) * BLK + tid,
                        tid < BLK ? sdst + p * BLK + tid
                                  : m + p * BLK + tid - BLK, 4);
    }
  }
  __device__ __forceinline__ float value_live(float* hs, int buf, float e,
                                              int o, int mm, int row0,
                                              int lane) {
    const int j = lane + 32 * mm;
    const float* pb = hs + (1 + 2 * buf) * BLK;
    return att_pe(e, pb[j] + hs[row0 + o], pb[BLK + j], slope);
  }
  __device__ __forceinline__ void finish_live(float*, int64_t, int64_t, int,
                                              int) {}
};

}  // namespace att

// K7f's rows walk and K7bt's dx, the columns walk, take the occupancy
// words
namespace sparse {
template <>
struct takes_words<att::FwdScores, false> : std::true_type {};
template <>
struct takes_words<att::DxScores, true> : std::true_type {};
}  // namespace sparse

namespace {

// the entries' launches, T the tile type (float or __nv_bfloat16); block,
// the tile edge, a multiple of 128: nq = block / 128 above 1 takes the
// QUAD forms, 1 the kernels as they were
bool bad_edge(int64_t block) { return block < BLK || block % BLK; }

template <class T>
int rowmax(const void* blocks, const void* row_splits, const void* cols,
           const void* ssrc, const void* sdst, void* out,
           int64_t num_row_blocks, int64_t block, float slope,
           void* stream) {
  if (bad_edge(block)) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = static_cast<int>(block / BLK);
  const int64_t ctas = num_row_blocks * nq;
  if (ctas > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (ctas > 0) {
    const auto kernel = nq > 1 ? att_rowmax_kernel<T, true>
                               : att_rowmax_kernel<T, false>;
    kernel<<<static_cast<unsigned>(ctas), THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(blocks),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(cols), static_cast<const float*>(ssrc),
        static_cast<const float*>(sdst), static_cast<float*>(out), slope,
        nq);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int walk(const void* blocks, const void* splits, const void* sel,
         const void* scale, const void* cols, const void* words,
         const void* ssrc, const void* sdst, const void* m, const void* x,
         void* out, void* den, int64_t num_row_blocks, int64_t feat,
         int64_t block, int trans, float slope, void* stream) {
  if (bad_edge(block)) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = static_cast<int>(block / BLK);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const T*>(blocks);
  const auto* sp = static_cast<const int32_t*>(splits);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* ss = static_cast<const float*>(ssrc);
  const auto* sd = static_cast<const float*>(sdst);
  const auto* mm = static_cast<const float*>(m);
  const auto* xp = static_cast<const float*>(x);
  const auto* w = static_cast<const uint64_t*>(words);
  auto* op = static_cast<float*>(out);
  if (trans) {
    return static_cast<int>(
        sparse::launch<true, false, false, false, true, T, att::DxScores,
                       true>(
            b, sp, static_cast<const int32_t*>(sel),
            static_cast<const int32_t*>(scale), c, xp, nullptr, op,
            num_row_blocks, feat, st, att::DxScores{ss, sd, mm, slope}, nq,
            w));
  }
  return static_cast<int>(
      sparse::launch<false, false, false, false, true, T, att::FwdScores,
                     true>(
          b, sp, nullptr, nullptr, c, xp, nullptr, op, num_row_blocks, feat,
          st, att::FwdScores{ss, sd, mm, static_cast<float*>(den), slope},
          nq, w));
}

template <class T>
int scores(const void* blocks, const void* rows, const void* cols,
           const void* live, const void* ssrc, const void* sdst,
           const void* m, const void* dden, const void* g, const void* x,
           void* cpart, void* rpart, int64_t num_tiles, int64_t num_live,
           int64_t feat, int64_t block, float slope, void* stream) {
  if (feat <= 0 || feat > MAX_F || bad_edge(block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq = static_cast<int>(block / BLK);
  // the live grid: quadrants alone, nq > 1
  const bool with_live = live != nullptr;
  if (with_live && (nq < 2 || num_live < 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles * nq * nq > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int64_t ctas = with_live ? num_live : num_tiles * nq * nq;
  if (ctas > 0) {
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % 4 == 0;
    const auto kernel =
        with_live ? (vec ? att_scores_kernel<true, T, true, true>
                         : att_scores_kernel<false, T, true, true>)
        : nq > 1 ? (vec ? att_scores_kernel<true, T, false, true>
                        : att_scores_kernel<false, T, false, true>)
                 : (vec ? att_scores_kernel<true, T, false, false>
                        : att_scores_kernel<false, T, false, false>);
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SC_SMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<static_cast<unsigned>(ctas), THREADS, SC_SMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(blocks), static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(cols),
        static_cast<const int32_t*>(live), static_cast<const float*>(ssrc),
        static_cast<const float*>(sdst), static_cast<const float*>(m),
        static_cast<const float*>(dden), static_cast<const float*>(g),
        static_cast<const float*>(x), static_cast<float*>(cpart),
        static_cast<float*>(rpart), feat, slope, nq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each of the next three entries has a twin ending in _bf16 that takes
// blocks (K,block,block) bf16 in place of f32, with the same other
// operands.  block, the tile edge, is a multiple of 128 (else
// cudaErrorInvalidValue, nothing launched); above 128 each tile is walked
// as 128-wide quadrants, at 128 the kernels are the forms without QUAD.

// blocks (K,block,block) f32, 16-byte aligned; row_splits
// (num_row_blocks+1,) int32 tile range per tile row; cols (K,) int32;
// ssrc, sdst, out (num_row_blocks*block,) f32; all contiguous.  Returns
// cudaErrorInvalidConfiguration when the grid (num_row_blocks*block/128
// CTAs) would exceed 2^31 - 1, else cudaGetLastError() after the launch.
extern "C" int fitgnn_att_rowmax(const void* blocks, const void* row_splits,
                                 const void* cols, const void* ssrc,
                                 const void* sdst, void* out,
                                 int64_t num_row_blocks, int64_t block,
                                 float slope, void* stream) {
  return rowmax<float>(blocks, row_splits, cols, ssrc, sdst, out,
                       num_row_blocks, block, slope, stream);
}

extern "C" int fitgnn_att_rowmax_bf16(const void* blocks,
                                      const void* row_splits,
                                      const void* cols, const void* ssrc,
                                      const void* sdst, void* out,
                                      int64_t num_row_blocks, int64_t block,
                                      float slope, void* stream) {
  return rowmax<__nv_bfloat16>(blocks, row_splits, cols, ssrc, sdst, out,
                               num_row_blocks, block, slope, stream);
}

// The walk: trans == 0 is the forward (splits = row_splits, sel = scale =
// null, cols the input tiles, x the features, den (n,) f32 or null;
// words, the tiles' (K,) occupancy words, or null); trans != 0 the dx walk
// of the transpose plan (splits = t_row_splits, sel = t_sel, scale =
// t_scale, cols = t_cols, x = g, den null; words, the slots' (Kt,) words,
// each its tile's transposed and 0 on a scale-0 filler, DynPlan.t_words,
// or null).  blocks (K,block,block) f32, 16-byte aligned; ssrc, sdst, m
// (n,) f32; x, out (n, feat) f32 with n = num_row_blocks*block; all
// contiguous.  Given words, either walk takes the live quadrants alone
// (block 256 to 1024).  Returns cudaErrorInvalidValue for words at
// another block, cudaErrorInvalidConfiguration when the grid would exceed
// 2^31 - 1 CTAs, else cudaGetLastError() after the launch.
extern "C" int fitgnn_att_walk(const void* blocks, const void* splits,
                               const void* sel, const void* scale,
                               const void* cols, const void* words,
                               const void* ssrc, const void* sdst,
                               const void* m, const void* x, void* out,
                               void* den, int64_t num_row_blocks,
                               int64_t feat, int64_t block, int trans,
                               float slope, void* stream) {
  return walk<float>(blocks, splits, sel, scale, cols, words, ssrc, sdst, m,
                     x, out, den, num_row_blocks, feat, block, trans, slope,
                     stream);
}

extern "C" int fitgnn_att_walk_bf16(const void* blocks, const void* splits,
                                    const void* sel, const void* scale,
                                    const void* cols, const void* words,
                                    const void* ssrc, const void* sdst,
                                    const void* m, const void* x, void* out,
                                    void* den, int64_t num_row_blocks,
                                    int64_t feat, int64_t block, int trans,
                                    float slope, void* stream) {
  return walk<__nv_bfloat16>(blocks, splits, sel, scale, cols, words, ssrc,
                             sdst, m, x, out, den, num_row_blocks, feat,
                             block, trans, slope, stream);
}

// The score-gradient pass: the column partials cpart and the row partials
// rpart (K, nq, block) f32, nq = block / 128, of every forward tile k
// (rows tile rows[k], columns tile cols[k]): rpart[k][qj][i] the row sums
// of d_raw over the columns of quadrant column qj, cpart[k][qi][j] its
// column sums over the rows of quadrant row qi ((K, 128) at block 128).
// blocks (K,block,block) f32, 16-byte aligned; ssrc, sdst, m, dden (n,)
// f32; g, x (n, feat) f32 with 0 < feat <= 512; rows, cols (K,) int32; all
// contiguous.  live, (num_live,) int32, the quadrants to run (ids k nq^2 +
// qi nq + qj, ascending: the mask's live ones), or null for every quadrant
// of every tile; given, only their partials are written (the caller
// zeroes the rest).  Returns cudaErrorInvalidValue for another feat and
// for live at block 128, cudaErrorInvalidConfiguration when num_tiles nq^2
// exceeds 2^31 - 1, else cudaGetLastError() after the launch.
extern "C" int fitgnn_att_scores(const void* blocks, const void* rows,
                                 const void* cols, const void* live,
                                 const void* ssrc, const void* sdst,
                                 const void* m, const void* dden,
                                 const void* g, const void* x, void* cpart,
                                 void* rpart, int64_t num_tiles,
                                 int64_t num_live, int64_t feat,
                                 int64_t block, float slope, void* stream) {
  return scores<float>(blocks, rows, cols, live, ssrc, sdst, m, dden, g, x,
                       cpart, rpart, num_tiles, num_live, feat, block, slope,
                       stream);
}

extern "C" int fitgnn_att_scores_bf16(const void* blocks, const void* rows,
                                      const void* cols, const void* live,
                                      const void* ssrc, const void* sdst,
                                      const void* m, const void* dden,
                                      const void* g, const void* x,
                                      void* cpart, void* rpart,
                                      int64_t num_tiles, int64_t num_live,
                                      int64_t feat, int64_t block,
                                      float slope, void* stream) {
  return scores<__nv_bfloat16>(blocks, rows, cols, live, ssrc, sdst, m, dden,
                               g, x, cpart, rpart, num_tiles, num_live, feat,
                               block, slope, stream);
}

// dssrc and dsdst (n,) f32 from the pass's partials (K, nq, block) f32:
// the row partials over row_splits (num_row_blocks + 1), the column
// partials over the transpose plan (t_row_splits, t_sel, t_scale); int32,
// all contiguous; n = num_row_blocks*block; cpart, rpart, dssrc and dsdst
// 16-byte aligned.  words (K,) and t_words (Kt,) int64, the forward
// tiles' and the transpose slots' occupancy words (DynPlan.words and
// t_words; block 256 to 1024), or both null.  The contract of the words:
// the partials of a quadrant whose bit is clear are never read, and must
// be zeros (the +0 that the pass writes there) for the result to be the
// sum of every partial; given them, it is that sum bit for bit.  Returns
// cudaErrorInvalidValue for a block that is not a multiple of 128, for
// words at another block or only one of the two, and for a pointer off
// 16 bytes; cudaErrorInvalidConfiguration when 2 n / 128 exceeds 2^31 - 1;
// else cudaGetLastError() after the launch.
extern "C" int fitgnn_att_sums(const void* cpart, const void* rpart,
                               const void* row_splits, const void* t_splits,
                               const void* t_sel, const void* t_scale,
                               const void* words, const void* t_words,
                               void* dssrc, void* dsdst,
                               int64_t num_row_blocks, int64_t block,
                               void* stream) {
  if (bad_edge(block)) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = static_cast<int>(block / BLK);
  if ((words == nullptr) != (t_words == nullptr) ||
      (words != nullptr && (nq < 2 || nq > sparse::MAX_WORD_QUADS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto off16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (off16(cpart) || off16(rpart) || off16(dssrc) || off16(dsdst)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = num_row_blocks * nq;        // 128-row blocks
  if (2 * nb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (nb > 0) {
    const int64_t ctas = (2 * nb + SUM_WARPS - 1) / SUM_WARPS;
    const auto kernel = nq == 1   ? att_sums_kernel<1>
                        : nq == 2 ? att_sums_kernel<2>
                                  : att_sums_kernel<0>;
    kernel<<<static_cast<unsigned>(ctas), SUM_WARPS * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cpart), static_cast<const float*>(rpart),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(t_splits),
        static_cast<const int32_t*>(t_sel),
        static_cast<const int32_t*>(t_scale),
        static_cast<const int64_t*>(words),
        static_cast<const int64_t*>(t_words), static_cast<float*>(dssrc),
        static_cast<float*>(dsdst), nb, nq);
  }
  return static_cast<int>(cudaGetLastError());
}
