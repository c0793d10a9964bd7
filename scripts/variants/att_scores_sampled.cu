// The alternative to K7's score-gradient pass (att_scores_kernel,
// fitgnn_tpu_torch/csrc/att_bsr.cu) that scripts/torch_design_variants.py
// times against it: the product sampled at the mask's entries on the CUDA
// cores, walked as the non-zero walk of tile_sparse.cuh walks a tile.
//
// One CTA (8 warps) per (block row r, 128-feature slice s), the slice
// varying fastest.  The CTA stages g[r]'s slice once; per tile k of the
// row it copies the tile and x[cols[k]]'s slice into shared memory
// (cp.async) and each warp takes 16 tile rows i: the row's mask entries
// are found by ballot, and for each entry j the slice's dot product
// <g_i, x_j>_s is formed from shared memory (4 features a lane) and summed
// across the warp.  d_raw is linear in the dot product, c_ij (<g_i, x_j> +
// dden_i) with c_ij = mask . LeakyReLU'(raw) . pe, so each slice adds
// c_ij <g_i, x_j>_s (slice 0 also c_ij dden_i) to a row partial (rpart, per
// slice) and to a per-warp column sum, whose 8 warps go in a fixed order
// into one column partial per (slice, tile) (cpart).  The caller sums the
// slices: dsdst = sum_s rpart[s], partial = sum_s cpart[s].  No atomics.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

constexpr int BLK = 128;
constexpr int FS = 128;                           // features a slice
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM = (3 * BLK * FS + WARPS * BLK + 5 * BLK)
                     * static_cast<int>(sizeof(float));

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [BLK] x FS of slab b from feature f0, zeros past feat, as cp.async
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ b,
                                      int64_t f0, int64_t feat, int tid) {
  if (VEC) {
    for (int q = tid; q < BLK * FS / 4; q += THREADS) {
      const int i = q / (FS / 4);
      const int64_t f = f0 + 4 * (q % (FS / 4));
      const bool ok = f < feat;
      sparse::cp_async16(dst + 4 * q, ok ? b + i * feat + f : b, ok ? 16 : 0);
    }
  } else {
    for (int q = tid; q < BLK * FS; q += THREADS) {
      const int i = q / FS;
      const int64_t f = f0 + q % FS;
      const bool ok = f < feat;
      sparse::cp_async4(dst + q, ok ? b + i * feat + f : b, ok ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
att_scores_sampled_kernel(const float* __restrict__ blocks,
                          const int32_t* __restrict__ row_splits,
                          const int32_t* __restrict__ cols,
                          const float* __restrict__ ssrc,
                          const float* __restrict__ sdst,
                          const float* __restrict__ m,
                          const float* __restrict__ dden,
                          const float* __restrict__ g,
                          const float* __restrict__ x,
                          float* __restrict__ rpart,
                          float* __restrict__ cpart, int64_t n, int64_t k_all,
                          int64_t feat, float slope) {
  extern __shared__ float sh[];
  float* gs = sh;                                 // g[r]'s slice
  float* xs = gs + BLK * FS;                      // x[cols[k]]'s slice
  float* ts = xs + BLK * FS;                      // the tile
  float* cs = ts + BLK * BLK;                     // [warp][column]
  float* ss = cs + WARPS * BLK;                   // ssrc of block cols[k]
  float* sd = ss + BLK;                           // sdst, m, dden of r
  float* mm = sd + BLK;
  float* dd = mm + BLK;
  float* rs = dd + BLK;                           // the row partials
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t slices = (feat + FS - 1) / FS;
  const int64_t r = blockIdx.x / slices;
  const int64_t s = blockIdx.x % slices;
  const int64_t f0 = s * FS;
  stage<VEC>(gs, g + r * BLK * feat, f0, feat, tid);
  sparse::cp_async_commit();
  if (tid < BLK) {
    sd[tid] = sdst[r * BLK + tid];
    mm[tid] = m[r * BLK + tid];
    dd[tid] = s == 0 ? dden[r * BLK + tid] : 0.f;
    rs[tid] = 0.f;
  }
  for (int q = tid; q < WARPS * BLK; q += THREADS) cs[q] = 0.f;
  const int lo = row_splits[r];
  const int hi = row_splits[r + 1];
  for (int k = lo; k < hi; ++k) {
    const int64_t c = cols[k];
    __syncthreads();                              // the last tile is done
    const float* tile = blocks + static_cast<int64_t>(k) * BLK * BLK;
    for (int q = tid; q < BLK * BLK / 4; q += THREADS) {
      sparse::cp_async16(ts + 4 * q, tile + 4 * q, 16);
    }
    stage<VEC>(xs, x + c * BLK * feat, f0, feat, tid);
    sparse::cp_async_commit();
    if (tid < BLK) ss[tid] = ssrc[c * BLK + tid];
    sparse::cp_async_wait<0>();
    __syncthreads();
    for (int q = 0; q < BLK / WARPS; ++q) {
      const int i = warp * (BLK / WARPS) + q;
      const float4 gi = *reinterpret_cast<const float4*>(gs + i * FS
                                                         + 4 * lane);
      const float4 e = *reinterpret_cast<const float4*>(ts + i * BLK
                                                        + 4 * lane);
      const float ev[4] = {e.x, e.y, e.z, e.w};
      float racc = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t bits = __ballot_sync(0xffffffffu, ev[u] != 0.f);
        while (bits != 0u) {
          const int j = 4 * (__ffs(bits) - 1) + u;
          bits &= bits - 1u;
          const float4 xj = *reinterpret_cast<const float4*>(xs + j * FS
                                                             + 4 * lane);
          float dot = gi.x * xj.x;
          dot = fmaf(gi.y, xj.y, dot);
          dot = fmaf(gi.z, xj.z, dot);
          dot = fmaf(gi.w, xj.w, dot);
          dot = warp_sum(dot) + dd[i];
          const float raw = sd[i] + ss[j];
          float v = dot * expf(leaky(raw, slope) - mm[i]);
          if (raw < 0.f) v *= slope;
          racc += v;
          if (lane == 0) cs[warp * BLK + j] += v;
        }
      }
      if (lane == 0) rs[i] += racc;
    }
    __syncthreads();
    if (tid < BLK) {
      float v = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        v += cs[w * BLK + tid];
        cs[w * BLK + tid] = 0.f;
      }
      cpart[(s * k_all + k) * BLK + tid] = v;
    }
  }
  __syncthreads();
  if (tid < BLK) rpart[s * n + r * BLK + tid] = rs[tid];
}

}  // namespace

// rpart (slices, n) and cpart (slices, K, 128) f32, slices = ceil(feat /
// 128); the other operands as fitgnn_att_scores takes them.
extern "C" int fitgnn_att_scores_sampled(
    const void* blocks, const void* row_splits, const void* cols,
    const void* ssrc, const void* sdst, const void* m, const void* dden,
    const void* g, const void* x, void* rpart, void* cpart,
    int64_t num_row_blocks, int64_t k_all, int64_t feat, float slope,
    void* stream) {
  const int64_t grid = num_row_blocks * ((feat + FS - 1) / FS);
  if (feat <= 0 || grid > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && feat % 4 == 0;
  const auto kernel = vec ? att_scores_sampled_kernel<true>
                          : att_scores_sampled_kernel<false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (grid > 0) {
    kernel<<<static_cast<unsigned>(grid), THREADS, SMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blocks),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(cols), static_cast<const float*>(ssrc),
        static_cast<const float*>(sdst), static_cast<const float*>(m),
        static_cast<const float*>(dden), static_cast<const float*>(g),
        static_cast<const float*>(x), static_cast<float*>(rpart),
        static_cast<float*>(cpart), num_row_blocks * BLK, k_all, feat,
        slope);
  }
  return static_cast<int>(cudaGetLastError());
}
