// The kernel of K7sums before its redesign (att_sums_kernel,
// fitgnn_tpu_torch/csrc/att_bsr.cu), which
// scripts/torch_design_variants.py --k7sums-only times against the
// committed one: one CTA of 128 threads per 128-row block, one f32 a
// thread, each tile's partials loaded and added one after another, and no
// occupancy words (every partial of every tile read).  The committed
// kernel gives its output bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLK = 128;

bool bad_edge(int64_t block) { return block < BLK || block % BLK; }

// The partials' sums, one CTA of 128 threads per 128-row block: CTA b <
// nb gives dsdst[b] = the row partials of block row b's tiles row_splits[b]
// .. row_splits[b+1], in order; CTA nb + c gives dssrc[c] = the column
// partials of the transpose plan's slots of block c, in order, times their
// scale (a coverage filler, scale 0, is skipped).  Every row is written, 0
// where no tile adds to it.  QUAD: nb counts 128-row blocks, half h = b %
// nq of tile row (column) b / nq; a tile's nq partials of that half (over
// its quadrants' columns, or rows) are summed in order first, then added
// as the one partial is without QUAD.
template <bool QUAD>
__global__ void __launch_bounds__(BLK)
att_sums_kernel(const float* __restrict__ cpart,
                const float* __restrict__ rpart,
                const int32_t* __restrict__ row_splits,
                const int32_t* __restrict__ t_splits,
                const int32_t* __restrict__ t_sel,
                const int32_t* __restrict__ t_scale,
                float* __restrict__ dssrc, float* __restrict__ dsdst,
                int64_t nb, int nq) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  // the tile's partial of half h: rpart[k][0..nq)[128 h + tid] (cpart
  // alike), the first without an add
  const auto part = [&](const float* p, int64_t k, int64_t h) {
    if (!QUAD) return p[k * BLK + tid];
    const float* q = p + (k * nq * nq + h) * BLK + tid;
    float t = q[0];
    for (int u = 1; u < nq; ++u) t += q[static_cast<int64_t>(u) * nq * BLK];
    return t;
  };
  float v = 0.f;
  if (b < nb) {
    const int64_t r = QUAD ? b / nq : b;
    const int hi = row_splits[r + 1];
    for (int k = row_splits[r]; k < hi; ++k) {
      v += part(rpart, k, QUAD ? b % nq : 0);
    }
    dsdst[b * BLK + tid] = v;
    return;
  }
  const int64_t c = b - nb;
  const int64_t ct = QUAD ? c / nq : c;
  const int hi = t_splits[ct + 1];
  for (int k = t_splits[ct]; k < hi; ++k) {
    const int32_t sc = t_scale[k];
    if (sc == 0) continue;
    v = fmaf(static_cast<float>(sc), part(cpart, t_sel[k], QUAD ? c % nq : 0),
             v);
  }
  dssrc[c * BLK + tid] = v;
}

}  // namespace

// The committed entry's arguments without the words.
extern "C" int fitgnn_att_sums_per_block(const void* cpart,
                                         const void* rpart,
                                         const void* row_splits,
                                         const void* t_splits,
                                         const void* t_sel,
                                         const void* t_scale, void* dssrc,
                                         void* dsdst, int64_t num_row_blocks,
                                         int64_t block, void* stream) {
  if (bad_edge(block)) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = static_cast<int>(block / BLK);
  const int64_t nb = num_row_blocks * nq;        // 128-row blocks
  if (2 * nb > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (nb > 0) {
    const auto kernel = nq > 1 ? att_sums_kernel<true>
                               : att_sums_kernel<false>;
    kernel<<<static_cast<unsigned>(2 * nb), BLK, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cpart), static_cast<const float*>(rpart),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(t_splits),
        static_cast<const int32_t*>(t_sel),
        static_cast<const int32_t*>(t_scale), static_cast<float*>(dssrc),
        static_cast<float*>(dsdst), nb, nq);
  }
  return static_cast<int>(cudaGetLastError());
}
