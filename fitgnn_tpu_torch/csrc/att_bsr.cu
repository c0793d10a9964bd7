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
// the bench graph).  att_sums_kernel (one CTA of 128 threads per block)
// then adds, in order, the row partials of block row r's tiles
// row_splits[r] .. row_splits[r+1] into dsdst, and scale . cpart[sel]
// over the transpose plan's slots of block c into dssrc, skipping the
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
// once, dssrc and dsdst once).
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

__global__ void __launch_bounds__(THREADS)
att_rowmax_kernel(const float* __restrict__ blocks,
                  const int32_t* __restrict__ row_splits,
                  const int32_t* __restrict__ cols,
                  const float* __restrict__ ssrc,
                  const float* __restrict__ sdst, float* __restrict__ out,
                  float slope) {
  const int64_t r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float rm[ROWS_PER_WARP];
  float sd[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    rm[q] = NEG;
    sd[q] = sdst[r * BLK + warp + WARPS * q];
  }
  const int lo = row_splits[r];
  const int hi = row_splits[r + 1];
  for (int k = lo; k < hi; ++k) {
    const float* ss = ssrc + static_cast<int64_t>(cols[k]) * BLK + 4 * lane;
    const float s0 = ss[0], s1 = ss[1], s2 = ss[2], s3 = ss[3];
    const float* a = blocks + static_cast<int64_t>(k) * BLK * BLK + 4 * lane;
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int i = warp + WARPS * q;
      const float4 v = *reinterpret_cast<const float4*>(
          a + static_cast<int64_t>(i) * BLK);
      float mx = NEG;
      if (v.x != 0.f) mx = fmaxf(mx, leaky(sd[q] + s0, slope));
      if (v.y != 0.f) mx = fmaxf(mx, leaky(sd[q] + s1, slope));
      if (v.z != 0.f) mx = fmaxf(mx, leaky(sd[q] + s2, slope));
      if (v.w != 0.f) mx = fmaxf(mx, leaky(sd[q] + s3, slope));
      rm[q] = fmaxf(rm[q], warp_max(mx));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      out[r * BLK + warp + WARPS * q] = rm[q];
    }
  }
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
att_scores_kernel(const float* __restrict__ blocks,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ cols,
                  const float* __restrict__ ssrc,
                  const float* __restrict__ sdst,
                  const float* __restrict__ m,
                  const float* __restrict__ dden,
                  const float* __restrict__ g, const float* __restrict__ x,
                  float* __restrict__ cpart, float* __restrict__ rpart,
                  int64_t feat, float slope) {
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
  const int64_t k = blockIdx.x;
  const int64_t r = rows[k];
  const int64_t c = cols[k];
  // the tile and the score vectors into shared memory while the product
  // runs (no load waits): 16-byte chunk q of tile row i at chunk
  // q ^ (i % 8), so the epilogue's float2 reads of 8 rows and 4 column
  // pairs spread over all banks
  const float* tile = blocks + k * SC_TILE;
#pragma unroll
  for (int u = 0; u < SC_TILE / 4 / THREADS; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (BLK / 4);
    sparse::cp_async16(ts + i * BLK + 4 * ((q % (BLK / 4)) ^ (i & 7)),
                       tile + 4 * q, 16);
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
    const int at = i0 * BLK + 4 * ((col >> 2) ^ key) + (col & 3);
    const float2 k0 = *reinterpret_cast<const float2*>(ts + at);
    const float2 k1 = *reinterpret_cast<const float2*>(ts + at + 8 * BLK);
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
    rpart[k * BLK + i0] = rs0;
    rpart[k * BLK + i0 + 8] = rs1;
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
    cpart[k * BLK + tid] = v;
  }
}

// The partials' sums, one CTA of 128 threads per block: CTA b < nb gives
// dsdst[b] = the row partials of block row b's tiles row_splits[b] ..
// row_splits[b+1], in order; CTA nb + c gives dssrc[c] = the column
// partials of the transpose plan's slots of block c, in order, times their
// scale (a coverage filler, scale 0, is skipped).  Every row is written, 0
// where no tile adds to it.
__global__ void __launch_bounds__(BLK)
att_sums_kernel(const float* __restrict__ cpart,
                const float* __restrict__ rpart,
                const int32_t* __restrict__ row_splits,
                const int32_t* __restrict__ t_splits,
                const int32_t* __restrict__ t_sel,
                const int32_t* __restrict__ t_scale,
                float* __restrict__ dssrc, float* __restrict__ dsdst,
                int64_t nb) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  float v = 0.f;
  if (b < nb) {
    const int hi = row_splits[b + 1];
    for (int k = row_splits[b]; k < hi; ++k) {
      v += rpart[static_cast<int64_t>(k) * BLK + tid];
    }
    dsdst[b * BLK + tid] = v;
    return;
  }
  const int64_t c = b - nb;
  const int hi = t_splits[c + 1];
  for (int k = t_splits[c]; k < hi; ++k) {
    const int32_t sc = t_scale[k];
    if (sc == 0) continue;
    v = fmaf(static_cast<float>(sc),
             cpart[static_cast<int64_t>(t_sel[k]) * BLK + tid], v);
  }
  dssrc[c * BLK + tid] = v;
}

}  // namespace

// The walk's value hooks (tile_sparse.cuh): a lane's tile entry e becomes
// pe where e != 0, from score vectors staged in the walk's shared memory hs:
// the CTA's own block once, the slot's partner block with each tile's slab
// (cp.async, 4 bytes a thread).  Entry (i, j) of a tile is (row0 + o,
// lane + 32m) in the rows orientation, (lane + 32m, row0 + o) in the
// columns orientation.
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
};

}  // namespace att

// blocks (K,128,128) f32, 16-byte aligned; row_splits (num_row_blocks+1,)
// int32 tile range per block row; cols (K,) int32; ssrc, sdst, out
// (num_row_blocks*128,) f32; all contiguous.  Returns cudaGetLastError()
// after the launch.
extern "C" int fitgnn_att_rowmax(const void* blocks, const void* row_splits,
                                 const void* cols, const void* ssrc,
                                 const void* sdst, void* out,
                                 int64_t num_row_blocks, float slope,
                                 void* stream) {
  if (num_row_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (num_row_blocks > 0) {
    att_rowmax_kernel<<<static_cast<unsigned>(num_row_blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blocks),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(cols), static_cast<const float*>(ssrc),
        static_cast<const float*>(sdst), static_cast<float*>(out), slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk: trans == 0 is the forward (splits = row_splits, sel = scale =
// null, cols the input blocks, x the features, den (n,) f32 or null);
// trans != 0 the dx walk of the transpose plan (splits = t_row_splits,
// sel = t_sel, scale = t_scale, cols = t_cols, x = g, den null).  blocks
// (K,128,128) f32, 16-byte aligned; ssrc, sdst, m (n,) f32; x, out (n,
// feat) f32 with n = num_row_blocks*128; all contiguous.  Returns
// cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1 CTAs,
// else cudaGetLastError() after the launch.
extern "C" int fitgnn_att_walk(const void* blocks, const void* splits,
                               const void* sel, const void* scale,
                               const void* cols, const void* ssrc,
                               const void* sdst, const void* m, const void* x,
                               void* out, void* den, int64_t num_row_blocks,
                               int64_t feat, int trans, float slope,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(blocks);
  const auto* sp = static_cast<const int32_t*>(splits);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* ss = static_cast<const float*>(ssrc);
  const auto* sd = static_cast<const float*>(sdst);
  const auto* mm = static_cast<const float*>(m);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  if (trans) {
    return static_cast<int>(sparse::launch<true, false, false>(
        b, sp, static_cast<const int32_t*>(sel),
        static_cast<const int32_t*>(scale), c, xp, nullptr, op,
        num_row_blocks, feat, st, att::DxScores{ss, sd, mm, slope}));
  }
  return static_cast<int>(sparse::launch<false, false, false>(
      b, sp, nullptr, nullptr, c, xp, nullptr, op, num_row_blocks, feat, st,
      att::FwdScores{ss, sd, mm, static_cast<float*>(den), slope}));
}

// The score-gradient pass: the column partials cpart and the row partials
// rpart (K, 128) f32 of every forward tile k (rows block rows[k], columns
// block cols[k]).  blocks (K,128,128) f32, 16-byte aligned; ssrc, sdst, m,
// dden (n,) f32; g, x (n, feat) f32 with 0 < feat <= 512; rows, cols (K,)
// int32; all contiguous.  Returns cudaErrorInvalidValue for another feat,
// cudaErrorInvalidConfiguration when num_tiles exceeds 2^31 - 1, else
// cudaGetLastError() after the launch.
extern "C" int fitgnn_att_scores(const void* blocks, const void* rows,
                                 const void* cols, const void* ssrc,
                                 const void* sdst, const void* m,
                                 const void* dden, const void* g,
                                 const void* x, void* cpart, void* rpart,
                                 int64_t num_tiles, int64_t feat,
                                 float slope, void* stream) {
  if (feat <= 0 || feat > MAX_F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (num_tiles > 0) {
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % 4 == 0;
    const auto kernel = vec ? att_scores_kernel<true>
                            : att_scores_kernel<false>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SC_SMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<static_cast<unsigned>(num_tiles), THREADS, SC_SMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blocks), static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(cols), static_cast<const float*>(ssrc),
        static_cast<const float*>(sdst), static_cast<const float*>(m),
        static_cast<const float*>(dden), static_cast<const float*>(g),
        static_cast<const float*>(x), static_cast<float*>(cpart),
        static_cast<float*>(rpart), feat, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// dssrc and dsdst (n,) f32 from the pass's partials (K, 128) f32: the row
// partials over row_splits (nb + 1), the column partials over the
// transpose plan (t_row_splits, t_sel, t_scale); int32, all contiguous.
// Returns cudaErrorInvalidConfiguration when 2 num_row_blocks exceeds
// 2^31 - 1, else cudaGetLastError() after the launch.
extern "C" int fitgnn_att_sums(const void* cpart, const void* rpart,
                               const void* row_splits, const void* t_splits,
                               const void* t_sel, const void* t_scale,
                               void* dssrc, void* dsdst,
                               int64_t num_row_blocks, void* stream) {
  if (2 * num_row_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (num_row_blocks > 0) {
    att_sums_kernel<<<static_cast<unsigned>(2 * num_row_blocks), BLK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cpart), static_cast<const float*>(rpart),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(t_splits),
        static_cast<const int32_t*>(t_sel),
        static_cast<const int32_t*>(t_scale), static_cast<float*>(dssrc),
        static_cast<float*>(dsdst), num_row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
