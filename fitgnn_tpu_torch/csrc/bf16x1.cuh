// The tensor-core product of two 128-row bf16 slabs, one pass:
//   d (this warpgroup's 64 rows x 128) = a[64 wg .. +64, :] @ b^T,
// a and b both 128 node rows x feat bf16, feat contiguous, d f32.  K5a's
// mainloop (dyn_grad_blocks_kernel on bf16 activations, bsr_dynamic.cu:
// one tile's dense dB from bf16 g and x), the bf16 branch of
// fitgnn_tpu/ops/pallas/bsr_dynamic.py:_dB_kernel, whose dot_general
// takes bf16 g and x with f32 accumulation.  tf32x3.cuh is the
// f32 operands' product (K5, K7s); its layout, stages and accumulator order
// are kept here, so the two read alike, and its descriptor (sdesc) and
// accumulator fence (fence_acc) are used as they are.
//
// Two warpgroups (256 threads) a CTA, each computing 64 rows of the 128x128
// output with wgmma m64n128k16 (bf16 operands, f32 accumulators: 64
// registers a thread).  Both slabs are K-major (no transpose is made) and
// F is walked in 64-wide chunks, one 128-byte row a slab row, through a
// ring of two shared-memory stages (32 KiB each, half tf32x3's: no hi/lo
// split).  Accuracy: a bf16 x bf16 product is exact in f32, so one pass is
// the whole product (tf32x3 needs three passes to keep f32's accuracy on
// f32 operands); the sums are the tensor cores' f32 accumulation, in
// another order than the plain version's, so they can differ from it (and
// from 3xTF32 on the same widened values) in the last f32 bits.  The chunk
// goes from device memory into registers, then into the stage under the
// 128-byte swizzle that the wgmma descriptors name (16-byte chunk c of row
// i at chunk c ^ (i % 8)).  Per chunk: the 4 wgmmas of the current stage
// are issued, the next chunk (already in registers) is stored into the
// other stage while they run, and the chunk after it is loaded.  An F that
// is not a multiple of 64 reads as zeros past F, and F = 0 leaves d at
// zero.  Non-finite inputs propagate as in the plain product (no split).
//
// Accumulator layout (tf32x3's): register j of a thread holds row 64 wg +
// 16 warp + lane / 4 (+8 when j % 4 >= 2) and column 8 (j / 4) + 2 (lane %
// 4) + (j % 2), warp being the warp within its warpgroup.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "tf32x3.cuh"

namespace bf16x1 {

using tf32x3::fence_acc;
using tf32x3::sdesc;

constexpr int BLK = 128;                          // slab rows (= output edge)
constexpr int KC = 64;                            // features a stage
constexpr int THREADS = 256;                      // two warpgroups
constexpr int OPER = BLK * KC;                    // values an operand a stage
constexpr int STAGE = 2 * OPER;                   // a, b
constexpr int PER = OPER / 8 / THREADS;           // uint4 an operand a thread
// the two stages in bytes; the caller aligns them to 1 KB
constexpr int SMEM = 2 * STAGE * static_cast<int>(sizeof(__nv_bfloat16));
static_assert(KC * sizeof(__nv_bfloat16) == 128,
              "a stage row is one swizzle row");

// chunk f0 .. f0+KC-1 of a 128 x feat slab: 16-byte piece u of the thread
// is piece q % 8 of slab row q / 8, q = tid + THREADS u (a warp reads four
// whole 128-byte rows); zeros past feat.  VEC: the slab starts on a
// 16-byte boundary and feat % 8 == 0.
template <bool VEC>
__device__ __forceinline__ void load_chunk(uint4 (&v)[PER],
                                           const __nv_bfloat16* __restrict__ slab,
                                           int64_t f0, int64_t feat,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = tid + THREADS * u;
    const int64_t c = f0 + 8 * (q % (KC / 8));
    const __nv_bfloat16* p = slab + (q / (KC / 8)) * feat + c;
    if (VEC) {
      v[u] = c < feat ? __ldg(reinterpret_cast<const uint4*>(p))
                      : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = c + 2 * i < feat ? __ldg(s + 2 * i) : 0u;
        const uint32_t hi = c + 2 * i + 1 < feat ? __ldg(s + 2 * i + 1) : 0u;
        w[i] = lo | (hi << 16);
      }
      v[u] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// stores the loaded chunk, 16-byte chunk c of row i at chunk c ^ (i % 8):
// the 128-byte swizzle of the wgmma descriptors
__device__ __forceinline__ void put_chunk(__nv_bfloat16* s,
                                          const uint4 (&v)[PER], int tid) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (KC / 8);
    *reinterpret_cast<uint4*>(s + i * KC + 8 * ((q % (KC / 8)) ^ (i & 7))) =
        v[u];
  }
}

// d (64 x 128, this warpgroup's rows) += A (64 x 16) . B (128 x 16)^T, both
// bf16 from shared memory, both K-major (transpose flags 0)
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
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

// d = a[64 wg .. +64, :] @ b^T over feat (d is zeroed first); sm is the two
// stages (SMEM bytes, 1 KB aligned).  Every thread of the CTA calls it; it
// ends with a barrier, after which both stages may be overwritten.
template <bool VEC>
__device__ __forceinline__ void product(float (&d)[64], __nv_bfloat16* sm,
                                        const __nv_bfloat16* __restrict__ a,
                                        const __nv_bfloat16* __restrict__ b,
                                        int64_t feat, int tid) {
  const int wg = tid / 128;                     // output rows 64 wg ..
  const int64_t chunks = (feat + KC - 1) / KC;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  uint4 va[PER], vb[PER];                       // the next chunk
  auto load = [&](int64_t c) {
    load_chunk<VEC>(va, a, c * KC, feat, tid);
    load_chunk<VEC>(vb, b, c * KC, feat, tid);
  };
  auto put = [&](int64_t c) {
    __nv_bfloat16* s = sm + (c & 1) * STAGE;
    put_chunk(s, va, tid);
    put_chunk(s + OPER, vb, tid);
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
    const __nv_bfloat16* s = sm + (c & 1) * STAGE;
    const __nv_bfloat16* as = s + wg * 64 * KC;
    const __nv_bfloat16* bs = s + OPER;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {       // +32 bytes a step
      mma_bf16(d, sdesc(as + kk), sdesc(bs + kk));
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
}

}  // namespace bf16x1
