// K1: BCSR tile walk with fused init, out = init + sum_k A_k . X[col_k].
//
// Replaces the TPU kernel fitgnn_tpu/ops/pallas/bsr_spmm.py:_kernel_acc
// (grid built by _bsr_spmm_fwd_acc, entry bsr_spmm_acc_raw).  There the grid
// walks the tiles in order and carries each output block in VMEM across
// grid steps.  Blocks of a CUDA grid run in parallel and in no order, so
// here one CTA owns one output block-row r and one slice of FT feature
// columns: it loads init[r] into f32 registers, walks the tiles
// row_splits[r] .. row_splits[r+1] of that row, stages each tile and the
// matching X slab through shared memory in KC-deep chunks, accumulates
// with f32 FMA and stores once.  No atomics: the result is deterministic
// and every row is written, so the coverage-filler tiles build_bsr appends
// are harmless zero tiles.
//
// Bound on an H100: memory.  The function needs 2 FLOPs per tile non-zero
// and feature, a few FLOPs a byte, so reading the tiles, the X slabs and
// init and writing out bound it.  The bench graph's tiles are ~3% full, so
// the dense tile product this kernel does costs ~33x the FLOPs the
// function needs (~37 GFLOP at F=512) and the CUDA cores' f32 rate limits
// the kernel itself.  The design answers with a register-blocked product
// (8x4 outputs a thread, 32 FMAs per 3 shared-memory vector loads) and a
// flat grid whose index is row * slices + slice: the feature slice varies
// fastest, so the CTAs that reread one tile run together and find it in
// L2, and the row count is limited only by grid.x (2^31 - 1 CTAs).
// Tensor cores (TF32 or bf16 wgmma), a sparse walk of the tile non-zeros
// and TMA-fed pipelining are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLK = 128;                          // tile edge (rows = cols)
constexpr int FT = 64;                            // feature columns a CTA
constexpr int KC = 32;                            // tile columns a stage
constexpr int TM = 8;                             // output rows a thread
constexpr int TN = 4;                             // output cols a thread
constexpr int THREADS = (BLK / TM) * (FT / TN);   // 256

__global__ void __launch_bounds__(THREADS)
bsr_spmm_acc_kernel(const float* __restrict__ blocks,
                    const int32_t* __restrict__ row_splits,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ x,
                    const float* __restrict__ init,
                    float* __restrict__ out, int64_t feat,
                    int64_t slices) {
  // A chunk stored transposed (As[k][row]) so a thread reads its 8 rows
  // for one k as two float4; +4 keeps rows 16-byte aligned
  __shared__ __align__(16) float As[KC][BLK + 4];
  __shared__ __align__(16) float Xs[KC][FT];

  const int64_t r = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int row0 = (tid / (FT / TN)) * TM;
  const int col0 = (tid % (FT / TN)) * TN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t base = (r * BLK + row0 + i) * feat;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = f0 + col0 + j;
      acc[i][j] = c < feat ? init[base + c] : 0.f;
    }
  }

  const int lo = row_splits[r];
  const int hi = row_splits[r + 1];
  for (int k = lo; k < hi; ++k) {
    const float* a = blocks + static_cast<int64_t>(k) * BLK * BLK;
    const float* xb = x + static_cast<int64_t>(cols[k]) * BLK * feat;
    for (int kc = 0; kc < BLK; kc += KC) {
      // A[:, kc:kc+KC]: 128 rows x 8 float4
      for (int q = tid; q < BLK * (KC / 4); q += THREADS) {
        const int row = q / (KC / 4);
        const int c4 = (q % (KC / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            a + static_cast<int64_t>(row) * BLK + kc + c4);
        As[c4 + 0][row] = v.x;
        As[c4 + 1][row] = v.y;
        As[c4 + 2][row] = v.z;
        As[c4 + 3][row] = v.w;
      }
      // X[kc:kc+KC, f0:f0+FT], coalesced along the feature axis
      for (int q = tid; q < KC * FT; q += THREADS) {
        const int kk = q / FT;
        const int c = q % FT;
        const int64_t gc = f0 + c;
        Xs[kk][c] = gc < feat ? xb[static_cast<int64_t>(kc + kk) * feat + gc]
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
      const int64_t c = f0 + col0 + j;
      if (c < feat) out[base + c] = acc[i][j];
    }
  }
}

}  // namespace

// blocks (K,128,128) f32; row_splits (num_row_blocks+1,) int32; cols (K,)
// int32; x, init, out (num_row_blocks*128, feat) f32, all contiguous.
// Returns cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1
// CTAs, else cudaGetLastError() after the launch.
extern "C" int fitgnn_bsr_spmm_acc(const void* blocks, const void* row_splits,
                                   const void* cols, const void* x,
                                   const void* init, void* out,
                                   int64_t num_row_blocks, int64_t feat,
                                   void* stream) {
  if (num_row_blocks > 0 && feat > 0) {
    const int64_t slices = (feat + FT - 1) / FT;
    const int64_t ctas = num_row_blocks * slices;
    if (ctas > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    bsr_spmm_acc_kernel<<<static_cast<unsigned>(ctas), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(blocks),
        static_cast<const int32_t*>(row_splits),
        static_cast<const int32_t*>(cols), static_cast<const float*>(x),
        static_cast<const float*>(init), static_cast<float*>(out), feat,
        slices);
  }
  return static_cast<int>(cudaGetLastError());
}
