// The tensor-core product of two 128-row slabs at f32 accuracy:
//   d (this warpgroup's 64 rows x 128) = a[64 wg .. +64, :] @ b^T,
// a and b both 128 node rows x feat, feat contiguous.  Shared by K5
// (dyn_grad_blocks_kernel, bsr_dynamic.cu: one tile's dense dB) and K7's
// score-gradient pass (att_scores_kernel, att_bsr.cu: <g_i, x_j> of every
// entry of a tile, masked in its epilogue).
//
// Two warpgroups (256 threads) a CTA, each computing 64 rows of the 128x128
// output with wgmma m64n128k8 (TF32 operands, f32 accumulators: 64
// registers a thread).  Both slabs are K-major, the only layout wgmma takes
// for TF32, and no transpose is made.  F is walked in 32-wide chunks (one
// 128-byte row a slab row) through a ring of two shared-memory stages.
// Accuracy: one TF32 pass keeps ~11 bits and misses f32's tolerance at
// F=512, so each value v is split once, as it is staged, into hi = tf32(v)
// and lo = tf32(v - hi), and the product is accumulated as alo.bhi +
// ahi.blo + ahi.bhi ("3xTF32"; the dropped alo.blo is ~2^-22 of the
// product).  The chunk goes from device memory into registers (the split
// needs them anyway), then as hi and lo into the stage under the 128-byte
// swizzle that the wgmma descriptors name (16-byte chunk c of row i at
// chunk c ^ (i % 8)).  Per chunk: the 12 wgmmas of the current stage are
// issued, the next chunk (already in registers) is split into the other
// stage while they run, and the chunk after it is loaded.  An F that is
// not a multiple of 32 reads as zeros past F, and F = 0 leaves d at zero.
// The split departs from the plain product only on non-finite inputs: an
// inf in a or b gives NaN (inf - inf in its lo), not inf.
//
// Accumulator layout: register j of a thread holds row 64 wg + 16 warp +
// lane / 4 (+8 when j % 4 >= 2) and column 8 (j / 4) + 2 (lane % 4) +
// (j % 2), warp being the warp within its warpgroup.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace tf32x3 {

constexpr int BLK = 128;                          // slab rows (= output edge)
constexpr int KC = 32;                            // features a stage
constexpr int THREADS = 256;                      // two warpgroups
constexpr int OPER = BLK * KC;                    // floats an operand a stage
constexpr int STAGE = 4 * OPER;                   // a hi, a lo, b hi, b lo
constexpr int PER = OPER / 4 / THREADS;           // float4 an operand a thread
// the two stages in bytes; the caller aligns them to 1 KB
constexpr int SMEM = 2 * STAGE * static_cast<int>(sizeof(float));
static_assert(KC * sizeof(float) == 128, "a stage row is one swizzle row");

// chunk f0 .. f0+KC-1 of a 128 x feat slab: float4 u of the thread is
// chunk q % 8 of slab row q / 8, q = tid + THREADS u (a warp reads four
// whole 128-byte rows); zeros past feat.  VEC: the slab starts on a
// 16-byte boundary and feat % 4 == 0.
template <bool VEC>
__device__ __forceinline__ void load_chunk(float4 (&v)[PER],
                                           const float* __restrict__ slab,
                                           int64_t f0, int64_t feat,
                                           int tid) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int q = tid + THREADS * u;
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
    const int q = tid + THREADS * u;
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
// stride 1024 B between 8-row groups, layout 1 = 128-byte swizzle (of any
// element type: bf16x1.cuh's operands too)
__device__ __forceinline__ uint64_t sdesc(const void* p) {
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
// asynchronous wgmma (bf16x1.cuh's too)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a[64 wg .. +64, :] @ b^T over feat (d is zeroed first); sm is the two
// stages (SMEM bytes, 1 KB aligned).  Every thread of the CTA calls it; it
// ends with a barrier, after which both stages may be overwritten.
template <bool VEC>
__device__ __forceinline__ void product(float (&d)[64], float* sm,
                                        const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        int64_t feat, int tid) {
  const int wg = tid / 128;                     // output rows 64 wg ..
  const int64_t chunks = (feat + KC - 1) / KC;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  float4 va[PER], vb[PER];                      // the next chunk
  auto load = [&](int64_t c) {
    load_chunk<VEC>(va, a, c * KC, feat, tid);
    load_chunk<VEC>(vb, b, c * KC, feat, tid);
  };
  auto put = [&](int64_t c) {
    float* s = sm + (c & 1) * STAGE;
    put_chunk(s, s + OPER, va, tid);
    put_chunk(s + 2 * OPER, s + 3 * OPER, vb, tid);
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
    const float* ahi = s + wg * 64 * KC;
    const float* alo = ahi + OPER;
    const float* bhi = s + 2 * OPER;
    const float* blo = s + 3 * OPER;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {        // +32 bytes a step
      mma_tf32(d, sdesc(alo + kk), sdesc(bhi + kk));
      mma_tf32(d, sdesc(ahi + kk), sdesc(blo + kk));
      mma_tf32(d, sdesc(ahi + kk), sdesc(bhi + kk));
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

}  // namespace tf32x3
