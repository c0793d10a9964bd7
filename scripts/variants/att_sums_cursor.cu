// An alternative to K7sums's kernel (att_sums_kernel<QB>,
// fitgnn_tpu_torch/csrc/att_bsr.cu) that scripts/torch_design_variants.py
// --k7sums-only times against it: the same warp a 128-row block and the
// same words, but the partials read are enumerated one at a time by a
// cursor that the warp moves with shuffles (the next set bit of the slot,
// else the next slot), up to 8 partials loaded before their adds, for any
// nq at run time.  Its output is the committed kernel's bit for bit.  The
// cursor's chain of shuffles and its unrolled code (100 registers) made it
// no faster than the kernel before the redesign on the bench graph.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLK = 128;

constexpr int SUM_WARPS = 8;
constexpr int SUM_BATCH = 8;                      // partials in flight a lane

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 fma4(float s, float4 a, float4 b) {
  return make_float4(fmaf(s, a.x, b.x), fmaf(s, a.y, b.y), fmaf(s, a.z, b.z),
                     fmaf(s, a.w, b.w));
}

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
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f), t = v;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int n = min(32, hi - c0);
    // the lane's slot: its tile, its scale and the quadrants of half h it
    // reads (a bit each; without words, 1 for a slot read at all)
    int64_t tile = 0;
    float scale = 0.f;
    uint32_t bits = 0;
    if (lane < n) {
      const int s = c0 + lane;
      tile = dst ? s : t_sel[s];
      scale = dst ? 1.f : static_cast<float>(t_scale[s]);
      const uint64_t word = wd == nullptr ? 0 : wd[s];
      if (scale != 0.f) {
        bits = wd == nullptr ? 1u : static_cast<uint32_t>(
                                        (word >> (h * nq)) & ((1u << nq) - 1));
      }
    }
    // the cursor: quadrant u of the chunk's slot j, with that slot's bits,
    // tile and scale; next() moves it to the next partial read (j = n
    // past the last), and the warp moves it as one
    int j = -1, u = -1;
    uint32_t bj = 0;
    int64_t kj = 0;
    float sj = 0.f;
    const auto next = [&]() {
      ++u;
      for (;;) {
        if (bj != 0) {
          if (wd == nullptr) {
            if (u < nq) return;
          } else if (const uint32_t r = bj >> u) {
            u += __ffs(r) - 1;
            return;
          }
        }
        if (++j >= n) return;
        bj = __shfl_sync(FULL, bits, j);
        kj = __shfl_sync(FULL, tile, j);
        sj = __shfl_sync(FULL, scale, j);
        u = 0;
      }
    };
    next();
    while (j < n) {
      float4 buf[SUM_BATCH];
      float sc[SUM_BATCH];
      bool ok[SUM_BATCH], first[SUM_BATCH], last[SUM_BATCH];
#pragma unroll
      for (int p = 0; p < SUM_BATCH; ++p) {
        ok[p] = j < n;
        if (ok[p]) {
          const int at = j;
          first[p] = u == (wd == nullptr ? 0 : __ffs(bj) - 1);
          sc[p] = sj;
          buf[p] = __ldg(reinterpret_cast<const float4*>(
              part + (kj * nq + u) * stride));
          next();
          last[p] = j != at;
        }
      }
#pragma unroll
      for (int p = 0; p < SUM_BATCH; ++p) {
        if (ok[p]) {
          t = first[p] ? buf[p] : add4(t, buf[p]);
          if (last[p]) v = dst ? add4(v, t) : fma4(sc[p], t, v);
        }
      }
    }
  }
  *reinterpret_cast<float4*>((dst ? dsdst : dssrc) + b * BLK + 4 * lane) = v;
}

}  // namespace

// fitgnn_att_sums's arguments and checks.
extern "C" int fitgnn_att_sums_cursor(const void* cpart, const void* rpart,
                                      const void* row_splits,
                                      const void* t_splits,
                                      const void* t_sel, const void* t_scale,
                                      const void* words, const void* t_words,
                                      void* dssrc, void* dsdst,
                                      int64_t num_row_blocks, int64_t block,
                                      void* stream) {
  if (block < BLK || block % BLK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq = static_cast<int>(block / BLK);
  if ((words == nullptr) != (t_words == nullptr) ||
      (words != nullptr && (nq < 2 || nq > 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = num_row_blocks * nq;
  if (2 * nb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (nb > 0) {
    att_sums_kernel<<<static_cast<unsigned>((2 * nb + SUM_WARPS - 1) /
                                            SUM_WARPS),
                      SUM_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
