// The alternative to K5's live grid (dyn_grad_blocks_kernel<VEC, true,
// true>, fitgnn_tpu_torch/csrc/bsr_dynamic.cu) that
// scripts/torch_design_variants.py --k5-live-only times against it: a
// persistent grid over the plan's live list.
//
// One CTA of two warpgroups an SM (the grid is the SM count, or fewer
// when the list is shorter) walks live[blockIdx.x], live[blockIdx.x +
// gridDim.x], ... in turn, so the CTAs running at one time still take
// adjacent quadrants and share their slabs in L2.  Each quadrant's product
// is tf32x3.cuh's, with its first F-chunk already in registers: the next
// quadrant's first chunk is loaded while the current quadrant's 64
// accumulators a thread are stored, so that store overlaps those loads.
// Before its first product a CTA writes the gaps of empty quadrants j,
// j + gridDim.x, ... (gap j: between live[j - 1] and live[j]) as +0, as
// the committed kernel's CTA j does.  The values are the committed
// kernel's bit for bit: the same product and stores.  Live lists only.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int BLK = tf32x3::BLK;
constexpr int PER = tf32x3::PER;
constexpr int GSMEM = tf32x3::SMEM + 1024;

__device__ __forceinline__ void zero_quadrants(float* __restrict__ dB,
                                               int64_t lo, int64_t hi,
                                               int nq, int tid) {
  const int64_t edge = static_cast<int64_t>(nq) * BLK;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t q = lo; q < hi; ++q) {
    const int64_t k = q / (nq * nq);
    const int64_t qi = q / nq % nq, qj = q % nq;
    float* o = dB + k * edge * edge + qi * BLK * edge + qj * BLK
               + 4 * (tid & 31);
#pragma unroll 4
    for (int i = tid >> 5; i < BLK; i += tf32x3::THREADS / 32) {
      *reinterpret_cast<float4*>(o + i * edge) = z;
    }
  }
}

// tf32x3::product with chunk 0 of both slabs already loaded into va, vb
template <bool VEC>
__device__ __forceinline__ void product_from(float (&d)[64], float* sm,
                                             const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             int64_t feat, int tid,
                                             float4 (&va)[PER],
                                             float4 (&vb)[PER]) {
  using namespace tf32x3;
  const int wg = tid / 128;
  const int64_t chunks = (feat + KC - 1) / KC;
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  auto load = [&](int64_t c) {
    load_chunk<VEC>(va, a, c * KC, feat, tid);
    load_chunk<VEC>(vb, b, c * KC, feat, tid);
  };
  auto put = [&](int64_t c) {
    float* s = sm + (c & 1) * STAGE;
    put_chunk(s, s + OPER, va, tid);
    put_chunk(s + 2 * OPER, s + 3 * OPER, vb, tid);
  };
  if (chunks > 0) put(0);
  if (chunks > 1) load(1);
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
    for (int kk = 0; kk < KC; kk += 8) {
      mma_tf32(d, sdesc(alo + kk), sdesc(bhi + kk));
      mma_tf32(d, sdesc(ahi + kk), sdesc(blo + kk));
      mma_tf32(d, sdesc(ahi + kk), sdesc(bhi + kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(d);
    if (c + 1 < chunks) put(c + 1);
    if (c + 2 < chunks) load(c + 2);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

template <bool VEC>
__global__ void __launch_bounds__(tf32x3::THREADS, 1)
persistent_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ live,
                  const float* __restrict__ g, const float* __restrict__ x,
                  float* __restrict__ dB, int64_t feat, int64_t num_live,
                  int64_t num_quads, int nq) {
  extern __shared__ unsigned char graw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(graw));
  float* sm = reinterpret_cast<float*>(graw + ((1024 - base % 1024) % 1024));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  for (int64_t j = blockIdx.x; j <= num_live; j += gridDim.x) {
    zero_quadrants(dB, j == 0 ? 0 : live[j - 1] + 1,
                   j == num_live ? num_quads : live[j], nq, tid);
  }
  const int64_t edge = static_cast<int64_t>(nq) * BLK;
  const auto slabs = [&](int64_t i, const float*& gb, const float*& xb) {
    const unsigned id = static_cast<unsigned>(live[i]);
    const int64_t k = id / (nq * nq);
    const int quad = static_cast<int>(id % (nq * nq));
    gb = g + (static_cast<int64_t>(rows[k]) * edge + (quad / nq) * BLK)
             * feat;
    xb = x + (static_cast<int64_t>(cols[k]) * edge + (quad % nq) * BLK)
             * feat;
  };
  float4 va[PER], vb[PER];
  int64_t i = blockIdx.x;
  if (i < num_live) {
    const float *gb, *xb;
    slabs(i, gb, xb);
    tf32x3::load_chunk<VEC>(va, gb, 0, feat, tid);
    tf32x3::load_chunk<VEC>(vb, xb, 0, feat, tid);
  }
  const int lane = tid & 31;
  const int i0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  for (; i < num_live; i += gridDim.x) {
    const unsigned id = static_cast<unsigned>(live[i]);
    const int64_t k = id / (nq * nq);
    const int quad = static_cast<int>(id % (nq * nq));
    const int64_t qi = quad / nq, qj = quad % nq;
    const float *gb, *xb;
    slabs(i, gb, xb);
    float d[64];
    product_from<VEC>(d, sm, gb, xb, feat, tid, va, vb);
    // the next quadrant's first chunk, in flight during the stores
    if (i + gridDim.x < num_live) {
      const float *gn, *xn;
      slabs(i + gridDim.x, gn, xn);
      tf32x3::load_chunk<VEC>(va, gn, 0, feat, tid);
      tf32x3::load_chunk<VEC>(vb, xn, 0, feat, tid);
    }
    float* o = dB + k * edge * edge + (qi * BLK + i0) * edge + qj * BLK
               + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(o + 8 * edge + 8 * j) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

}  // namespace

// The committed entry's signature (bsr_dynamic.cu); live must be given,
// nq 2 to 8, else cudaErrorInvalidValue.
extern "C" int fitgnn_dyn_grad_blocks(const void* rows, const void* cols,
                                      const void* live, const void* g,
                                      const void* x, void* dB,
                                      int64_t num_tiles, int64_t num_live,
                                      int64_t feat, int64_t block,
                                      void* stream) {
  if (block < 2 * BLK || block % BLK || block > 8 * BLK || live == nullptr
      || num_live < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq = static_cast<int>(block / BLK);
  const int64_t quads = num_tiles * nq * nq;
  if (num_live > quads) return static_cast<int>(cudaErrorInvalidValue);
  if (quads > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t ctas = num_live + 1 < sms ? num_live + 1 : sms;
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % 4 == 0;
    const auto kernel = vec ? persistent_kernel<true>
                            : persistent_kernel<false>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<static_cast<unsigned>(ctas), tf32x3::THREADS, GSMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const int32_t*>(live), static_cast<const float*>(g),
        static_cast<const float*>(x), static_cast<float*>(dB), feat,
        num_live, quads, nq);
  }
  return static_cast<int>(cudaGetLastError());
}
