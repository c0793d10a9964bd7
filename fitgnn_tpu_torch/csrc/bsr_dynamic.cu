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
// for every tile, fillers included, dense and in f32.  Replaces
// fitgnn_tpu/ops/pallas/bsr_dynamic.py:_dB_kernel (grid built by
// _dyn_grad_blocks), whose dot_general is the dense product too.
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
// K5's design: one CTA of two warpgroups per tile, each warpgroup
// computing 64 rows of the 128x128 output with wgmma m64n128k8 (TF32
// operands, f32 accumulators: 64 registers a thread).  Both slabs are 128
// node rows x F with F contiguous, so both operands are K-major, the only
// layout wgmma takes for TF32, and no transpose is made.  F is walked in
// 32-wide chunks (one 128-byte row a slab row) through a ring of two
// shared-memory stages.  Accuracy: one TF32 pass keeps ~11 bits and misses
// f32's tolerance at F=512, so each value a is split once, as it is
// staged, into hi = tf32(a) and lo = tf32(a - hi), and the product is
// accumulated as glo.xhi + ghi.xlo + ghi.xhi ("3xTF32"; the dropped
// glo.xlo is ~2^-22 of the product).  The chunk goes from device memory
// into registers (the split needs them anyway), then as hi and lo into the
// stage under the 128-byte swizzle that the wgmma descriptors name (16-byte
// chunk c of row i at chunk c ^ (i % 8)).  Per chunk: the 12 wgmmas of
// the current stage are issued, the next chunk (already in registers) is
// split into the other stage while they run, and the chunk after it is
// loaded.  An F that is not a multiple of 32 reads as zeros past F, and
// F = 0 writes zeros.  Tiles are sorted by block row and the CTAs start in
// tile order, so the CTAs that run together share their g slabs in L2.
// The split departs from the plain product only on non-finite inputs: an
// inf in g or x gives NaN (inf - inf in its lo), not inf.
// Not kept, as no faster at the bench graph's shapes: a third stage that
// keeps one wgmma group in flight across chunks
// (scripts/torch_design_variants.py times it), a cp.async ring of raw
// chunks in place of the register prefetch, and mma.sync m16n8k8 with the
// same split.  Left for later: two
// CTAs an SM (fewer registers and one stage), a persistent grid that
// overlaps a tile's store with the next tile's loads, and a product
// sampled at the tile mask (only ~3% of dB is used downstream, but that
// changes the op's output at every unmasked entry).

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sparse.cuh"

namespace {

// K5's tiling
constexpr int BLK = 128;                          // tile edge (rows = cols)
constexpr int KC = 32;                            // features a stage
constexpr int GTHREADS = 256;                     // two warpgroups
constexpr int OPER = BLK * KC;                    // floats an operand a stage
constexpr int STAGE = 4 * OPER;                   // g hi, g lo, x hi, x lo
constexpr int PER = OPER / 4 / GTHREADS;          // float4 an operand a thread
constexpr int GSMEM =                             // two stages, 1 KB aligned
    2 * STAGE * static_cast<int>(sizeof(float)) + 1024;
static_assert(KC * sizeof(float) == 128, "a stage row is one swizzle row");

// chunk f0 .. f0+KC-1 of a 128 x feat slab: float4 u of the thread is
// chunk q % 8 of slab row q / 8, q = tid + GTHREADS u (a warp reads four
// whole 128-byte rows); zeros past feat.  VEC: the slab starts on a
// 16-byte boundary and feat % 4 == 0.
template <bool VEC>
__device__ __forceinline__ void load_chunk(float4 (&v)[PER],
                                           const float* __restrict__ slab,
                                           int64_t f0, int64_t feat,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = tid + GTHREADS * u;
    const int64_t c = f0 + 4 * (q % (KC / 4));
    const float* p = slab + (q / (KC / 4)) * feat + c;
    if (VEC) {
      v[u] = c < feat ? __ldg(reinterpret_cast<const float4*>(p))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      v[u].x = c < feat ? __ldg(p) : 0.f;
      v[u].y = c + 1 < feat ? __ldg(p + 1) : 0.f;
      v[u].z = c + 2 < feat ? __ldg(p + 2) : 0.f;
      v[u].w = c + 3 < feat ? __ldg(p + 3) : 0.f;
    }
  }
}

__device__ __forceinline__ float tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = tf32(a);
  lo = tf32(a - hi);                    // a - hi is exact in f32
}

// stores the loaded chunk as hi and lo, 16-byte chunk c of row i at chunk
// c ^ (i % 8): the 128-byte swizzle of the wgmma descriptors
__device__ __forceinline__ void put_chunk(float* hi, float* lo,
                                          const float4 (&v)[PER], int tid) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = tid + GTHREADS * u;
    const int i = q / (KC / 4);
    const int at = i * KC + 4 * ((q % (KC / 4)) ^ (i & 7));
    float4 h, l;
    split(v[u].x, h.x, l.x);
    split(v[u].y, h.y, l.y);
    split(v[u].z, h.z, l.z);
    split(v[u].w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: start address, leading offset 16 B (unused when swizzled),
// stride 1024 B between 8-row groups, layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t sdesc(const float* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (uint64_t{1} << 16)
         | (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (64 x 128, this warpgroup's rows) += A (64 x 8) . B (128 x 8)^T, both
// TF32 from shared memory
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <bool VEC>
__global__ void __launch_bounds__(GTHREADS, 1)
dyn_grad_blocks_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ g,
                       const float* __restrict__ x, float* __restrict__ dB,
                       int64_t feat) {
  extern __shared__ unsigned char graw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(graw));
  float* sm = reinterpret_cast<float*>(graw + ((1024 - base % 1024) % 1024));
  const int tid = threadIdx.x;
  const int wg = tid / 128;                     // output rows 64 wg ..
  const int64_t k = blockIdx.x;
  const float* gb = g + static_cast<int64_t>(rows[k]) * BLK * feat;
  const float* xb = x + static_cast<int64_t>(cols[k]) * BLK * feat;
  const int64_t chunks = (feat + KC - 1) / KC;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float4 vg[PER], vx[PER];                      // the next chunk
  auto load = [&](int64_t c) {
    load_chunk<VEC>(vg, gb, c * KC, feat, tid);
    load_chunk<VEC>(vx, xb, c * KC, feat, tid);
  };
  auto put = [&](int64_t c) {
    float* s = sm + (c & 1) * STAGE;
    put_chunk(s, s + OPER, vg, tid);
    put_chunk(s + 2 * OPER, s + 3 * OPER, vx, tid);
  };

  if (chunks > 0) {
    load(0);
    put(0);
  }
  if (chunks > 1) load(1);
  // the generic-proxy stores become visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int64_t c = 0; c < chunks; ++c) {
    const float* s = sm + (c & 1) * STAGE;
    const float* ghi = s + wg * 64 * KC;
    const float* glo = ghi + OPER;
    const float* xhi = s + 2 * OPER;
    const float* xlo = s + 3 * OPER;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {        // +32 bytes a step
      mma_tf32(d, sdesc(glo + kk), sdesc(xhi + kk));
      mma_tf32(d, sdesc(ghi + kk), sdesc(xlo + kk));
      mma_tf32(d, sdesc(ghi + kk), sdesc(xhi + kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(d);
    // the other stage was last read by chunk c - 1's wgmmas, waited for
    if (c + 1 < chunks) put(c + 1);
    if (c + 2 < chunks) load(c + 2);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // accumulator j of a thread: row 64 wg + 16 warp + lane / 4 (+8 for the
  // odd pair), columns 8 (j / 4) + 2 (lane % 4) + {0, 1}
  const int lane = tid & 31;
  const int i0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  float* o = dB + k * BLK * BLK + static_cast<int64_t>(i0) * BLK
             + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(o + 8 * j) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(o + 8 * BLK + 8 * j) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

}  // namespace

// blocks (K,128,128) f32, 16-byte aligned; row_splits (num_row_blocks+1,)
// int32 slot range per output block-row; cols (slots,) int32 input block
// per slot; x, out (num_row_blocks*128, feat) f32.  trans != 0 reads each
// tile transposed: sel, scale (slots,) int32 are then the tile read by a
// slot and its scale (0 = filler).  The forward (trans == 0) reads tile k
// for slot k at scale 1 and passes sel and scale as null.
// All contiguous.  Returns cudaErrorInvalidConfiguration when the grid
// would exceed 2^31 - 1 CTAs, else cudaGetLastError() after the launch.
extern "C" int fitgnn_bsr_dyn_apply(const void* blocks, const void* row_splits,
                                    const void* sel, const void* scale,
                                    const void* cols, const void* x, void* out,
                                    int64_t num_row_blocks, int64_t feat,
                                    int trans, void* stream) {
  const auto* b = static_cast<const float*>(blocks);
  const auto* rs = static_cast<const int32_t*>(row_splits);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (trans) {
    return static_cast<int>(sparse::launch<true, false>(
        b, rs, static_cast<const int32_t*>(sel),
        static_cast<const int32_t*>(scale), c, xp, nullptr, op,
        num_row_blocks, feat, s));
  }
  return static_cast<int>(sparse::launch<false, false>(
      b, rs, nullptr, nullptr, c, xp, nullptr, op, num_row_blocks, feat, s));
}

// rows, cols (num_tiles,) int32 block ids; g, x (*, feat) f32; dB
// (num_tiles,128,128) f32, 16-byte aligned; all contiguous.  feat may be 0
// (dB is then written as zeros).  Returns cudaErrorInvalidConfiguration
// when num_tiles exceeds 2^31 - 1, else cudaGetLastError() after the
// launch.
extern "C" int fitgnn_dyn_grad_blocks(const void* rows, const void* cols,
                                      const void* g, const void* x, void* dB,
                                      int64_t num_tiles, int64_t feat,
                                      void* stream) {
  if (num_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (num_tiles > 0) {
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % 4 == 0;
    const auto kernel = vec ? dyn_grad_blocks_kernel<true>
                            : dyn_grad_blocks_kernel<false>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<static_cast<unsigned>(num_tiles), GTHREADS, GSMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<float*>(dB), feat);
  }
  return static_cast<int>(cudaGetLastError());
}
