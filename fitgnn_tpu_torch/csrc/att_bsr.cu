// K7: GAT's fused tile attention.  The tile scores are worked out inside
// the kernels from the per-node score vectors, so the (K, 128, 128) score
// and numerator tensors never exist in device memory.
//
// Replaces the TPU kernels of fitgnn_tpu/ops/pallas/att_bsr.py:
//   _rowmax_kernel (entry att_rowmax)  -> att_rowmax_kernel
//   _fwd_kernel    (entry _att_fwd)    -> att_walk_kernel<false>
//   _bwd_t_kernel  (entry _att_bwd_t)  -> att_walk_kernel<true> (dx) and
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
// att_walk_kernel: a dense tile walk, one CTA of 256 threads per (block
// row, 64-column feature slice), each thread an 8x4 block of the output in
// f32 registers; a tile is staged through shared memory in 32-deep chunks
// (the tile's columns transposed, the matching X rows) and multiplied on
// the CUDA cores, with pe formed while a tile chunk is staged instead of
// read from a tensor.  The 128 score
// values of each side sit in shared memory.  Forward: num = sum pe @ x
// over the row's tiles, and the slice-0 CTA also writes den = the row sums
// of pe (per-thread partials, reduced across the 8 lanes that share a
// row).  Transposed (dx of the backward): the transpose plan's slots, each
// tile read transposed in place, dx[c] += scale . pe^T @ g[r]; a filler
// slot (scale 0) is skipped, but every row is still written.  No atomics.
// Cost of this design: every F-slice CTA recomputes the exps of its tiles
// (F/64 = 8 times at F=512).
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
// the function is bytes-bound (tiles, slabs, output), but the kernel does
// the dense 128x128 product on the CUDA cores' f32 FMA, ~33x the FLOPs of
// the tile non-zeros (the BCSR walks apply only the non-zeros:
// tile_sparse.cuh).  att_reduce: bytes as a function (tiles,
// g and x slabs); the kernel re-reads a partner row for every entry, 2.2 GB
// at F=512 on the bench graph, mostly from L2.  Tensor cores, TMA and one
// exp per entry shared across the F-slices are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLK = 128;                          // tile edge (rows = cols)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;               // 256
constexpr int ROWS_PER_WARP = BLK / WARPS;        // 16
constexpr float NEG = -1e30f;

// the dense walk's tiling
constexpr int FT = 64;                            // feature columns a CTA
constexpr int KC = 32;                            // tile columns a stage
constexpr int TM = 8;                             // output rows a thread
constexpr int TN = 4;                             // output cols a thread
static_assert((BLK / TM) * (FT / TN) == THREADS, "walk tiling");

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
att_walk_kernel(const float* __restrict__ blocks,
                const int32_t* __restrict__ splits,
                const int32_t* __restrict__ sel,
                const int32_t* __restrict__ scale,
                const int32_t* __restrict__ cols,
                const float* __restrict__ ssrc,
                const float* __restrict__ sdst, const float* __restrict__ m,
                const float* __restrict__ x, float* __restrict__ out,
                float* __restrict__ den, int64_t feat, int64_t slices,
                float slope) {
  __shared__ __align__(16) float As[KC][BLK + 4];
  __shared__ __align__(16) float Xs[KC][FT];
  // the tile rows' sdst and m, the tile columns' ssrc: forward, the rows
  // are the out block's and the columns the input block's; transposed,
  // the other way round
  __shared__ float Sd[BLK];
  __shared__ float Mi[BLK];
  __shared__ float Ss[BLK];

  const int64_t r = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int row0 = (tid / (FT / TN)) * TM;
  const int col0 = (tid % (FT / TN)) * TN;
  if (tid < BLK) {
    if (TRANS) {
      Ss[tid] = ssrc[r * BLK + tid];
    } else {
      Sd[tid] = sdst[r * BLK + tid];
      Mi[tid] = m[r * BLK + tid];
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  // forward: partial row sums of pe for rows tid/8 + 32*it
  constexpr int STAGE_ITERS = BLK * (KC / 4) / THREADS;   // 4
  float dsum[STAGE_ITERS];
#pragma unroll
  for (int it = 0; it < STAGE_ITERS; ++it) dsum[it] = 0.f;

  const int lo = splits[r];
  const int hi = splits[r + 1];
  for (int k = lo; k < hi; ++k) {
    const float s = scale != nullptr ? static_cast<float>(scale[k]) : 1.f;
    if (s == 0.f) continue;                       // filler: uniform skip
    const int64_t t = sel != nullptr ? sel[k] : k;
    const int64_t c = cols[k];
    __syncthreads();                              // previous slot staged
    if (tid < BLK) {
      if (TRANS) {
        Sd[tid] = sdst[c * BLK + tid];
        Mi[tid] = m[c * BLK + tid];
      } else {
        Ss[tid] = ssrc[c * BLK + tid];
      }
    }
    __syncthreads();
    const float* a = blocks + t * BLK * BLK;
    const float* xb = x + c * BLK * feat;
    for (int kc = 0; kc < BLK; kc += KC) {
      if constexpr (TRANS) {
        // As[kk][j] = pe[kc+kk][j]: 32 tile rows, a straight float4 copy
        for (int q = tid; q < KC * (BLK / 4); q += THREADS) {
          const int kk = q / (BLK / 4);
          const int c4 = (q % (BLK / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(
              a + static_cast<int64_t>(kc + kk) * BLK + c4);
          const float sd = Sd[kc + kk];
          const float mi = Mi[kc + kk];
          As[kk][c4 + 0] = s * att_pe(v.x, sd + Ss[c4 + 0], mi, slope);
          As[kk][c4 + 1] = s * att_pe(v.y, sd + Ss[c4 + 1], mi, slope);
          As[kk][c4 + 2] = s * att_pe(v.z, sd + Ss[c4 + 2], mi, slope);
          As[kk][c4 + 3] = s * att_pe(v.w, sd + Ss[c4 + 3], mi, slope);
        }
      } else {
        // As[kk][i] = pe[i][kc+kk]: 128 rows x 8 float4, stored transposed
#pragma unroll
        for (int it = 0; it < STAGE_ITERS; ++it) {
          const int q = tid + it * THREADS;
          const int row = q / (KC / 4);
          const int c4 = (q % (KC / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(
              a + static_cast<int64_t>(row) * BLK + kc + c4);
          const float sd = Sd[row];
          const float mi = Mi[row];
          const float p0 = att_pe(v.x, sd + Ss[kc + c4 + 0], mi, slope);
          const float p1 = att_pe(v.y, sd + Ss[kc + c4 + 1], mi, slope);
          const float p2 = att_pe(v.z, sd + Ss[kc + c4 + 2], mi, slope);
          const float p3 = att_pe(v.w, sd + Ss[kc + c4 + 3], mi, slope);
          As[c4 + 0][row] = p0;
          As[c4 + 1][row] = p1;
          As[c4 + 2][row] = p2;
          As[c4 + 3][row] = p3;
          dsum[it] += (p0 + p1) + (p2 + p3);
        }
      }
      // x[kc:kc+KC, f0:f0+FT], coalesced along the feature axis
      for (int q = tid; q < KC * FT; q += THREADS) {
        const int kk = q / FT;
        const int cc = q % FT;
        const int64_t gc = f0 + cc;
        Xs[kk][cc] = gc < feat
                         ? xb[static_cast<int64_t>(kc + kk) * feat + gc]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][row0]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][row0 + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Xs[kk][col0]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t base = (r * BLK + row0 + i) * feat;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t cc = f0 + col0 + j;
      if (cc < feat) out[base + cc] = acc[i][j];
    }
  }
  if (!TRANS && den != nullptr && f0 == 0) {      // uniform per CTA
#pragma unroll
    for (int it = 0; it < STAGE_ITERS; ++it) {
      float v = dsum[it];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if ((tid & 7) == 0) den[r * BLK + tid / 8 + 32 * it] = v;
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
  if (num_row_blocks > 0 && feat > 0) {
    const int64_t slices = (feat + FT - 1) / FT;
    const int64_t ctas = num_row_blocks * slices;
    if (ctas > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* b = static_cast<const float*>(blocks);
    const auto* sp = static_cast<const int32_t*>(splits);
    const auto* sl = static_cast<const int32_t*>(sel);
    const auto* sc = static_cast<const int32_t*>(scale);
    const auto* c = static_cast<const int32_t*>(cols);
    const auto* ss = static_cast<const float*>(ssrc);
    const auto* sd = static_cast<const float*>(sdst);
    const auto* mm = static_cast<const float*>(m);
    const auto* xp = static_cast<const float*>(x);
    auto* op = static_cast<float*>(out);
    auto* dp = static_cast<float*>(den);
    if (trans) {
      att_walk_kernel<true><<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(
          b, sp, sl, sc, c, ss, sd, mm, xp, op, nullptr, feat, slices, slope);
    } else {
      att_walk_kernel<false><<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(
          b, sp, sl, sc, c, ss, sd, mm, xp, op, dp, feat, slices, slope);
    }
  }
  return static_cast<int>(cudaGetLastError());
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
