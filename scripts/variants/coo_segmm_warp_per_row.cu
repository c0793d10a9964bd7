// The straggler segment sum (K3, K3w, K6) as the port ran it before its
// redesign: one warp per (row, 128-float chunk), the runtime weights formed
// by the caller.  scripts/torch_design_variants.py builds it to time the
// committed kernel (fitgnn_tpu_torch/csrc/coo_segmm.cu) against.
//
// K3: straggler segmented sum with the gather fused,
// out[r] = sum_{e in row r} w_e . x[s_e].
//
// Replaces the TPU kernel fitgnn_tpu/ops/pallas/coo_segmm.py:_kernel (grid
// built by _segmm_scatter, entry segmm_spmm).  On the TPU the gather
// y = x[senders] runs in XLA and streams an (E_pad, F) array into a kernel
// that multiplies a one-hot selector by each 128-edge chunk on the MXU,
// with every block-group's edge list padded to whole chunks.  A GPU needs
// none of that: the edges arrive as a receiver CSR (row_ptr over the
// receiver-sorted straggler list) and one warp owns one (row, 128-float
// feature chunk).  The warp reads 32 (sender, weight) pairs at a time,
// broadcasts each with a shuffle, gathers the sender's row slice with one
// 16-byte load a lane and accumulates in f32 in edge order.  Every row is
// written, zero where it has no edges, so no (E_pad, F) stream, no chunk
// padding and no filler chunks exist.
//
// Bound on an H100: memory.  Each edge gathers F floats of a random sender
// row; the sum is a few FLOPs a byte.  The design keeps every gather a
// full 512-byte warp transaction (16 bytes a lane) and writes each output
// element once.  The first_slot edge-0 hazard (coo_segmm.py:164-169) is a
// property of the TPU's padded slot stream and of K6's backward; this
// layout has no slots.
//
// K3w (segmm_weighted_spmm, GAT's straggler numerators; TPU entry
// fitgnn_tpu/ops/pallas/coo_segmm.py:370) is this same entry with the
// runtime per-edge weights w_edge * static_weight passed as `weights`, for
// the forward on the receiver CSR and for dx on the transpose CSR; it has
// no source of its own.
//
// K6, fitgnn_segmm_spmm_den (segmm_weighted_spmm_den: GAT's straggler
// numerator and softmax denominator in one pass) replaces the TPU kernel
// fitgnn_tpu/ops/pallas/coo_segmm.py:_kernel_den (grid built by
// _segmm_scatter_den).  The TPU gets den as the selector's row sums; here
// it is K3's kernel with a second output: each lane also sums the weights
// of the edges it reads, and the chunk-0 warp of a row reduces them with
// shuffles and writes den[r] (f32, every row, 0 where a row has no edge).
// The extra cost is one add an edge and one 4-byte store a row, so K6 is
// bound like K3: memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int WARPS = 8;                      // warps a CTA
constexpr int CHUNK = 128;                    // feature columns a warp

template <bool DEN>
__global__ void __launch_bounds__(WARPS * 32)
segmm_spmm_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ senders,
                  const float* __restrict__ weights,
                  const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ den, int64_t num_rows, int64_t feat,
                  int64_t chunks, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5);
  if (warp >= num_rows * chunks) return;      // uniform across the warp
  const int64_t r = warp / chunks;
  const int64_t c0 = (warp % chunks) * CHUNK + lane * 4;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float wsum = 0.f;                           // K6: this lane's edges
  const int lo = row_ptr[r];
  const int hi = row_ptr[r + 1];
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    int s = 0;
    float w = 0.f;
    if (e < hi) {
      s = senders[e];
      w = weights[e];
    }
    if (DEN) wsum += w;
    const int n = min(32, hi - base);
    for (int j = 0; j < n; ++j) {
      const int sj = __shfl_sync(0xffffffffu, s, j);
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* xr = x + static_cast<int64_t>(sj) * feat;
      if (vec) {
        if (c0 < feat) {
          const float4 v = *reinterpret_cast<const float4*>(xr + c0);
          acc[0] = fmaf(wj, v.x, acc[0]);
          acc[1] = fmaf(wj, v.y, acc[1]);
          acc[2] = fmaf(wj, v.z, acc[2]);
          acc[3] = fmaf(wj, v.w, acc[3]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (c0 + t < feat) acc[t] = fmaf(wj, xr[c0 + t], acc[t]);
        }
      }
    }
  }

  if (DEN && warp % chunks == 0) {             // uniform across the warp
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    }
    if (lane == 0) den[r] = wsum;
  }

  float* o = out + r * feat;
  if (vec) {
    if (c0 < feat) {
      *reinterpret_cast<float4*>(o + c0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (c0 + t < feat) o[c0 + t] = acc[t];
    }
  }
}

int launch(const void* row_ptr, const void* senders, const void* weights,
           const void* x, void* out, void* den, int64_t num_rows,
           int64_t feat, void* stream) {
  if (num_rows > 0 && feat > 0) {
    const int64_t chunks = (feat + CHUNK - 1) / CHUNK;
    const int64_t warps = num_rows * chunks;
    const bool vec = feat % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const unsigned grid = static_cast<unsigned>((warps + WARPS - 1) / WARPS);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int32_t*>(row_ptr);
    const auto* sp = static_cast<const int32_t*>(senders);
    const auto* wp = static_cast<const float*>(weights);
    const auto* xp = static_cast<const float*>(x);
    auto* op = static_cast<float*>(out);
    if (den != nullptr) {
      segmm_spmm_kernel<true><<<grid, WARPS * 32, 0, st>>>(
          rp, sp, wp, xp, op, static_cast<float*>(den), num_rows, feat,
          chunks, vec);
    } else {
      segmm_spmm_kernel<false><<<grid, WARPS * 32, 0, st>>>(
          rp, sp, wp, xp, op, nullptr, num_rows, feat, chunks, vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_ptr (num_rows+1,) int32; senders, weights (E,) int32 / f32 in
// receiver order; x (*, feat) f32; out (num_rows, feat) f32; contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int fitgnn_segmm_spmm(const void* row_ptr, const void* senders,
                                 const void* weights, const void* x,
                                 void* out, int64_t num_rows, int64_t feat,
                                 void* stream) {
  return launch(row_ptr, senders, weights, x, out, nullptr, num_rows, feat,
                stream);
}

// K6: as fitgnn_segmm_spmm, and den (num_rows,) f32 gets each row's weight
// sum.  feat must be positive (den is written by the feature chunks' warps).
extern "C" int fitgnn_segmm_spmm_den(const void* row_ptr, const void* senders,
                                     const void* weights, const void* x,
                                     void* out, void* den, int64_t num_rows,
                                     int64_t feat, void* stream) {
  return launch(row_ptr, senders, weights, x, out, den, num_rows, feat,
                stream);
}
