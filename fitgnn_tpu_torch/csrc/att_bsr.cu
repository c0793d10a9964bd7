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
//                                         att::DxScores (dx) and
//                                         att_reduce_kernel<true> (dssrc)
//   _bwd_f_kernel  (entry _att_bwd_f)  -> att_reduce_kernel<false> (dsdst)
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
// att_reduce_kernel: the score gradient d_raw = mask . LeakyReLU'(raw) .
// pe . (<g[i], x[j]> + dden[i]), summed over j into dsdst[i] (forward
// walk) or over i into dssrc[j], times scale (transpose plan).  The dot
// product runs over the whole feature axis, so one CTA owns one block
// (its "owner" rows: i forward, j transposed) for all F.  It stages up to
// 8 tiles at a time as 128x128 bit masks (2 KB each) in owner-major order,
// then each warp takes 16 owner rows: the owner's feature row sits in
// registers (16 floats a lane, F <= 512), and for each set bit the partner
// row is read from device memory (coalesced, mostly from L2) and dotted
// with it.  Only the mask's entries (~3% of each tile) are computed: a
// sampled product, where the TPU kernel did the dense 128x128xF one.
//
// Bound on an H100.  att_rowmax: bytes (every tile read once).  The walks:
// bytes (tiles, slabs, the three score vectors, output), 2.F + ~5 FLOPs
// per tile non-zero (the product, the score, LeakyReLU, subtract, exp and,
// forward, den's add).  att_reduce: bytes as a function (tiles, g and x
// slabs); the kernel re-reads a partner row for every entry, 2.2 GB at
// F=512 on the bench graph, mostly from L2.  One exp per entry shared
// across the F-slices, and the reductions' redesign, are later work.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

constexpr int BLK = 128;                          // tile edge (rows = cols)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;               // 256
constexpr int ROWS_PER_WARP = BLK / WARPS;        // 16
constexpr float NEG = -1e30f;

// the reduction's staging
constexpr int SG = 8;                             // tiles staged at once
constexpr int MAX_F = 512;
constexpr int FPL = MAX_F / 32;                   // features a lane

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

template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
att_reduce_kernel(const float* __restrict__ blocks,
                  const int32_t* __restrict__ splits,
                  const int32_t* __restrict__ sel,
                  const int32_t* __restrict__ scale,
                  const int32_t* __restrict__ part,
                  const float* __restrict__ ssrc,
                  const float* __restrict__ sdst,
                  const float* __restrict__ m,
                  const float* __restrict__ dden,
                  const float* __restrict__ own,
                  const float* __restrict__ other, float* __restrict__ out,
                  int64_t feat, float slope) {
  // Bits[s][o][w] bit b: staged tile s has an entry at owner row o and
  // partner row 32w+b (owner = forward row, partner = forward column; the
  // other way round when TRANS)
  __shared__ uint32_t Bits[SG][BLK][4];
  // the partner rows' scalars: ssrc (forward) or sdst, m, dden (TRANS)
  __shared__ float Pv[SG][3][BLK];
  __shared__ float Sc[SG];                        // slot scale, 0 = skip
  __shared__ int32_t Pb[SG];                      // partner block
  __shared__ float Osum[BLK];

  const int64_t o = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < BLK) Osum[tid] = 0.f;
  const int lo = splits[o];
  const int hi = splits[o + 1];
  for (int base = lo; base < hi; base += SG) {
    const int ns = min(SG, hi - base);
    uint32_t* flat = &Bits[0][0][0];
    for (int q = tid; q < SG * BLK * 4; q += THREADS) flat[q] = 0u;
    if (tid < SG) {
      const int k = base + tid;
      Sc[tid] = tid >= ns ? 0.f
                          : scale != nullptr ? static_cast<float>(scale[k])
                                             : 1.f;
      Pb[tid] = tid < ns ? part[k] : 0;
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      if (Sc[s] == 0.f) continue;                 // filler: uniform skip
      const int k = base + s;
      const int64_t t = sel != nullptr ? sel[k] : k;
      const int64_t p = Pb[s];
      if (tid < BLK) {
        if (TRANS) {
          Pv[s][0][tid] = sdst[p * BLK + tid];
          Pv[s][1][tid] = m[p * BLK + tid];
          Pv[s][2][tid] = dden[p * BLK + tid];
        } else {
          Pv[s][0][tid] = ssrc[p * BLK + tid];
        }
      }
      const float* a = blocks + t * BLK * BLK;
      for (int q = tid; q < BLK * (BLK / 4); q += THREADS) {
        const int i = q / (BLK / 4);
        const int j4 = (q % (BLK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            a + static_cast<int64_t>(i) * BLK + j4);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          if (vv[cc] != 0.f) {
            const int ow = TRANS ? j4 + cc : i;
            const int pa = TRANS ? i : j4 + cc;
            atomicOr(&Bits[s][ow][pa >> 5], 1u << (pa & 31));
          }
        }
      }
    }
    __syncthreads();
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int orow = warp + WARPS * q;
      const int64_t og = o * BLK + orow;
      float sd_o = 0.f, m_o = 0.f, dd_o = 0.f, ss_o = 0.f;
      if (TRANS) {
        ss_o = ssrc[og];
      } else {
        sd_o = sdst[og];
        m_o = m[og];
        dd_o = dden[og];
      }
      float ov[FPL];
      const float* orow_p = own + og * feat;
#pragma unroll
      for (int u = 0; u < FPL; ++u) {
        const int64_t f = u * 32 + lane;
        ov[u] = f < feat ? orow_p[f] : 0.f;
      }
      float sum = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float sc = Sc[s];
        if (sc == 0.f) continue;
        const float* pbase = other + static_cast<int64_t>(Pb[s]) * BLK * feat;
        for (int w = 0; w < 4; ++w) {
          uint32_t word = Bits[s][orow][w];       // uniform across the warp
          while (word != 0u) {
            const int pa = w * 32 + __ffs(word) - 1;
            word &= word - 1u;
            const float* pr = pbase + static_cast<int64_t>(pa) * feat;
            float d = 0.f;
#pragma unroll
            for (int u = 0; u < FPL; ++u) {
              const int64_t f = u * 32 + lane;
              if (f < feat) d = fmaf(ov[u], pr[f], d);
            }
            d = warp_sum(d);
            float sd, mi, dd, ss;
            if (TRANS) {
              sd = Pv[s][0][pa];
              mi = Pv[s][1][pa];
              dd = Pv[s][2][pa];
              ss = ss_o;
            } else {
              sd = sd_o;
              mi = m_o;
              dd = dd_o;
              ss = Pv[s][0][pa];
            }
            const float raw = sd + ss;
            float dr = (d + dd) * expf(leaky(raw, slope) - mi);
            if (raw < 0.f) dr *= slope;
            sum = fmaf(sc, dr, sum);
          }
        }
      }
      if (lane == 0) Osum[orow] += sum;           // one warp owns the row
    }
    __syncthreads();                              // before the next group
  }
  if (tid < BLK) out[o * BLK + tid] = Osum[tid];
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

// The score-gradient reduction: trans == 0 gives dsdst on the forward walk
// (splits = row_splits, sel = scale = null, part = cols, own = g, other =
// x); trans != 0 gives dssrc on the transpose plan (splits = t_row_splits,
// sel = t_sel, scale = t_scale, part = t_cols, own = x, other = g).
// blocks (K,128,128) f32, 16-byte aligned; ssrc, sdst, m, dden, out (n,)
// f32; g, x (n, feat) f32 with 0 < feat <= 512; all contiguous.  Returns
// cudaErrorInvalidValue for another feat, cudaErrorInvalidConfiguration
// when num_row_blocks exceeds 2^31 - 1, else cudaGetLastError() after the
// launch.
extern "C" int fitgnn_att_reduce(const void* blocks, const void* splits,
                                 const void* sel, const void* scale,
                                 const void* part, const void* ssrc,
                                 const void* sdst, const void* m,
                                 const void* dden, const void* own,
                                 const void* other, void* out,
                                 int64_t num_row_blocks, int64_t feat,
                                 int trans, float slope, void* stream) {
  if (feat <= 0 || feat > MAX_F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_row_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (num_row_blocks > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* b = static_cast<const float*>(blocks);
    const auto* sp = static_cast<const int32_t*>(splits);
    const auto* sl = static_cast<const int32_t*>(sel);
    const auto* sc = static_cast<const int32_t*>(scale);
    const auto* pt = static_cast<const int32_t*>(part);
    const auto* ss = static_cast<const float*>(ssrc);
    const auto* sd = static_cast<const float*>(sdst);
    const auto* mm = static_cast<const float*>(m);
    const auto* dd = static_cast<const float*>(dden);
    const auto* ow = static_cast<const float*>(own);
    const auto* ot = static_cast<const float*>(other);
    auto* op = static_cast<float*>(out);
    const auto grid = static_cast<unsigned>(num_row_blocks);
    if (trans) {
      att_reduce_kernel<true><<<grid, THREADS, 0, st>>>(
          b, sp, sl, sc, pt, ss, sd, mm, dd, ow, ot, op, feat, slope);
    } else {
      att_reduce_kernel<false><<<grid, THREADS, 0, st>>>(
          b, sp, sl, sc, pt, ss, sd, mm, dd, ow, ot, op, feat, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
