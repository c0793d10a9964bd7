// K11: dropout with its mask made in the kernel, out = keep ? x * scale : 0.
//
// Replaces the TPU kernel fitgnn_tpu/ops/pallas/dropout.py:_kernel (grid
// built by _apply, entry fused_dropout).  There each grid step seeds the
// core's hardware PRNG with seed + step and draws a (rows, F) block of bits
// in VMEM.  A GPU has no such generator, so the bits here are Philox4x32-10
// keyed by (seed, 0): element i of the flattened tensor takes word i % 4 of
// the block at the 64-bit counter i / 4.  A counter-based generator needs
// no state, so any thread can make any element's bits, and the backward
// regenerates the forward's mask from the same seed.  The keep rule is the
// JAX kernel's: keep = bits >= threshold (uint32(int(rate * 2^32))), and a
// kept element is multiplied by the f32 scale 1 / (1 - rate).  The plain
// version (ops/dropout.py) does the same integer rounds in torch int64
// arithmetic and gives the same bits.
//
// Bound on an H100: memory.  The function reads x once and writes out once
// (8 bytes an element); Philox costs ~10 multiply-high pairs and a few XORs
// per 4 elements, ~25 integer operations an element, well under the ratio
// at which the card's integer rate would bind.  The design keeps to one
// pass: one thread per Philox block (4 elements, one 16-byte load and
// store), a grid-stride loop over blocks, and the seed read from device
// memory so the host never waits on it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words philox4x32_10(uint64_t counter,
                                               uint32_t key0) {
  uint32_t c0 = static_cast<uint32_t>(counter);
  uint32_t c1 = static_cast<uint32_t>(counter >> 32);
  uint32_t c2 = 0, c3 = 0;
  uint32_t k0 = key0, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
philox_dropout_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const int32_t* __restrict__ seed, int64_t numel,
                      uint32_t threshold, float scale) {
  const uint32_t key0 = static_cast<uint32_t>(seed[0]);
  const int64_t blocks = (numel + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       b < blocks; b += stride) {
    const Words r = philox4x32_10(static_cast<uint64_t>(b), key0);
    const int64_t base = b * 4;
    if (VEC && base + 4 <= numel) {
      const float4 v = *reinterpret_cast<const float4*>(x + base);
      float4 o;
      o.x = r.w[0] >= threshold ? v.x * scale : 0.f;
      o.y = r.w[1] >= threshold ? v.y * scale : 0.f;
      o.z = r.w[2] >= threshold ? v.z * scale : 0.f;
      o.w = r.w[3] >= threshold ? v.w * scale : 0.f;
      *reinterpret_cast<float4*>(out + base) = o;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base + j < numel) {
          out[base + j] = r.w[j] >= threshold ? x[base + j] * scale : 0.f;
        }
      }
    }
  }
}

}  // namespace

// x, out (numel,) f32 contiguous; seed (1,) int32 on the device; vec != 0
// when x and out start on a 16-byte boundary.  Returns cudaGetLastError()
// after the launch.
extern "C" int fitgnn_philox_dropout(const void* x, void* out,
                                     const void* seed, int64_t numel,
                                     uint32_t threshold, float scale, int vec,
                                     void* stream) {
  if (numel > 0) {
    const int64_t blocks = (numel + 3) / 4;
    // enough CTAs to fill the card several times; the loop covers the rest
    const int64_t ctas = (blocks + THREADS - 1) / THREADS;
    const unsigned grid = static_cast<unsigned>(ctas < 65536 ? ctas : 65536);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* xi = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    const auto* sd = static_cast<const int32_t*>(seed);
    if (vec) {
      philox_dropout_kernel<true><<<grid, THREADS, 0, s>>>(
          xi, o, sd, numel, threshold, scale);
    } else {
      philox_dropout_kernel<false><<<grid, THREADS, 0, s>>>(
          xi, o, sd, numel, threshold, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
