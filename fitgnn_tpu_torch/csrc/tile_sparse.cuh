// The non-zero walk of a dense 128x128 tile, in two orientations: rows
// (K1, K2, K9 and K10, bsr_spmm.cu; K4, bsr_dynamic.cu; K8, diag_spmm.cu;
// K7f, att_bsr.cu) and columns (K4 transposed, K4T, bsr_dynamic.cu; K8
// transposed; K7bt's dx, att_bsr.cu).
//
// Both compute out[r] = init[r] + sum_k s_k . op(A_k) @ X[c_k] over a block
// row's run of tiles, where op is the identity (rows) or the transpose
// (columns), and init is zero unless the walk is given one (INIT: K1 and
// K8).  Under DIAG (K8, the block-diagonal run) the run of block row r is
// the one tile r, read against X's own slab r at scale 1, and no index
// array exists.  A value hook V turns each tile entry into the value that
// is applied: the identity (Plain) for every walk but K7's, whose tiles
// are the attention mask and whose values are GAT's softmax numerators
// pe = exp(LeakyReLU(sdst_i + ssrc_j) - m_i), worked out per non-zero
// (att_bsr.cu: its hooks and the TPU kernels _fwd_kernel and the dx half
// of _bwd_t_kernel that they replace).  The rows orientation replaces five
// TPU kernels over a sorted tile list:
//   fitgnn_tpu/ops/pallas/bsr_spmm.py:_kernel_acc (grid _bsr_spmm_fwd_acc;
//     K1, init + A . x on the layout with coverage fillers),
//   fitgnn_tpu/ops/pallas/bsr_spmm.py:_kernel (grid _bsr_spmm_fwd; K2,
//     A . x from zero on the same layout),
//   fitgnn_tpu/ops/pallas/bsr_spmm.py:_make_grouped_kernel (grid
//     _bsr_spmm_fwd_grouped; K9, the group-padded layout),
//   fitgnn_tpu/ops/pallas/bsr_spmm.py:_rowwalk_kernel (grid
//     _bsr_spmm_rowwalk; K10, the filler-free layout),
//   fitgnn_tpu/ops/pallas/bsr_dynamic.py:_make_dyn_kernel(trans=False)
//     (grid _dyn_apply; K4, GAT's runtime tile values);
// the columns orientation
// fitgnn_tpu/ops/pallas/bsr_dynamic.py:_make_dyn_kernel(trans=True) (grid
// _dyn_apply); under DIAG, both orientations replace
// fitgnn_tpu/ops/pallas/diag_spmm.py:_make_kernel (diag_spmm.cu).
//
// Bound on an H100: bytes.  The tiles are ~3% full on the bench graph
// (~3.9 non-zeros a tile row or column; the diagonal blocks ~4.5%, ~5.8 a
// row), so the function needs 2 FLOPs per tile non-zero and feature, and
// the dense tiles (64 KiB each), the X slabs, init (K1, K8) and the output
// bound it.  A dense 128x128 product on the CUDA cores spends ~95-97% of
// its FMAs on zeros and cannot reach that bound.  The walk reads each
// dense tile in place, finds its non-zeros with __ballot_sync and applies
// only those: the FMAs a tile costs are proportional to its non-zeros,
// and a tile with none (K9's group pads, the coverage fillers of K1, K2,
// K4 and K4T, whose values are zero) costs only its read: no
// shared-memory store, no slab copy, no FMA.  The group is not read: a
// padded run is a plain run.  A block row without tiles (K10's layout has
// no fillers) walks nothing and stores zeros; a block row of K1 or K8
// whose run has no non-zero stores init unchanged, bit for bit.  K1 and K8
// read init straight into the accumulators (one 16-byte load a row where
// init starts on a 16-byte boundary and F % 4 == 0), so the add that the
// TPU kernel fuses costs one read of init, as there.  Both orientations
// keep output rows warp*8 .. warp*8+7 in that warp's registers, so init
// loads the same way in both.
//
// Grid: one CTA per (output block row, FT=128 feature columns), the slice
// varying fastest, so the CTAs that reread one tile run together and find
// it in L2.  512 threads: each of the 16 warps owns 8 output rows in f32
// registers, a lane 4 feature columns.  One CTA an SM (the tile and the
// slab take 128 KB of shared memory); the registers hold the next tile (8
// float4 a thread) while the current one is applied.  Measured on the
// bench graph, FT=128 beats FT=64 at two CTAs an SM: half the rereads of
// each tile from L2 at F=512, each tile read once at F=128, and four FMAs
// per broadcast non-zero instead of two.
//
// Per tile, in order:
// 1. the CTA votes (__syncthreads_or) on whether the tile, already in
//    registers, has a non-zero; the vote is also the barrier after the
//    last apply, so shared memory may be overwritten;
// 2. if so, the tile goes to shared memory and its X slab (128 x FT) is
//    copied there with cp.async, 16-byte pieces where x starts on a
//    16-byte boundary and F % 4 == 0, else 4-byte pieces (columns past F
//    zero-filled);
// 3. the next tile's loads start (its indices were read one step earlier,
//    so no load waits on an index), then the slab is waited for and the
//    non-zeros applied while those loads are in flight.
// Under DIAG a CTA walks one tile, so there is no previous apply to hide
// its read behind.  Its slab is known before the vote (slab r), so the
// copy starts with the tile's read and init's: one memory latency before
// the apply instead of two.  A diagonal block without a non-zero then
// costs its slab's copy as well (one of the bench graph's 1,324).
//
// Bank conflicts: the tile is stored with chunk q (floats 4q .. 4q+3) of
// row i at chunk q ^ (i % 8), an XOR swizzle of the 16-byte chunks.  The
// columns orientation reads one chunk of 32 rows j = lane + 32m as float4,
// served 8 lanes a phase: at a plain stride of 128 floats those 8 rows
// hit the same 4 banks (8-way); swizzled they hit 8 distinct chunks, all
// 32 banks.  The rows orientation reads 32 consecutive floats of one row,
// which the swizzle keeps on 32 banks, and the 16-byte stores (8 chunks of
// a row a phase) stay conflict-free.  The alternative, a row stride of 129
// floats, needs 4-byte copies and 4-byte reads.
//
// Value hooks: the lane that holds entry e of the tile works out its value
// V::value(hs, e, o, m, row0, lane) for the tile entry (row0 + o,
// lane + 32m) in the rows orientation and (lane + 32m, row0 + o) in the
// columns orientation, row0 + o being the warp's output row o; the ballot
// stays on e != 0, and the value is broadcast in e's place.  The rows
// orientation works a value out only where its ballot found a non-zero
// (ahead of the ballots, the values of a warp's 32 entries spilled
// registers); the columns orientation works out the four values of a
// float4 before its four ballots, so that their work overlaps.  A hook's
// operands sit in V::SMEM floats of shared memory after the slab (hs):
// what is constant for the CTA is stored there once (begin, before the
// first vote, whose barrier publishes it), and what the slot's partner
// block gives is copied there with cp.async beside the tile's slab (tile,
// waited for with the slab), so no operand holds a register through the
// walk and no load waits.  A hook may write a result of its own after the
// last tile (finish).  Plain's steps are empty, its SMEM 0 and its value
// e, so the other walks compile as they would without a hook (the same
// register counts under ptxas -v).
//
// Order and numbers: each output element starts from init (or zero) and
// adds its products in ascending tile order and, within a tile, in
// ascending contraction index: a lane takes the contraction indices
// j = lane + 32m (m = 0..3), so one ballot per m lists them in order.  No
// atomics, so the result is deterministic.  An entry counts as a non-zero
// when e != 0, so a NaN entry is applied and propagates (as does a NaN
// value that a hook works out at a non-zero); a NaN in init stays in its
// own element.  A divergence from the dense product (and the TPU kernel):
// an inf or NaN in X at a row that only zero tile entries reach leaves the
// output at init or 0 there, not 0 * inf = NaN (for K7: an inf in x or g
// that only masked-out entries reach).  The main path never feeds one:
// GAT's tile values are where(mask, exp(.), 0) and the features are
// finite.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace sparse {

constexpr int BLK = 128;                        // tile edge (rows = cols)
constexpr int FT = 128;                         // feature columns a CTA
constexpr int FL = FT / 32;                     // feature columns a lane
static_assert(FL == 4, "a lane's columns are one float4");
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BLK / WARPS;               // output rows a warp: 8
constexpr unsigned FULL = 0xffffffffu;

// dynamic shared memory: the tile and the X slab, 128 KB
constexpr int SMEM = (BLK * BLK + BLK * FT) * static_cast<int>(sizeof(float));

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Starts the copy xs[j][c] = xb[j][f0 + c] of the 128 slab rows, 0 past
// feat, as one cp.async group.  VEC: x starts on a 16-byte boundary and
// feat % 4 == 0, so rows copy as 16-byte pieces; otherwise 4-byte pieces.
template <bool VEC>
__device__ __forceinline__ void start_slab(float* xs,
                                           const float* __restrict__ xb,
                                           int64_t f0, int64_t feat,
                                           int tid) {
  if (VEC) {
    for (int q = tid; q < BLK * FT / 4; q += THREADS) {
      const int j = q / (FT / 4);
      const int c4 = (q % (FT / 4)) * 4;
      const int64_t gc = f0 + c4;
      const bool ok = gc < feat;
      cp_async16(xs + j * FT + c4, ok ? xb + j * feat + gc : xb,
                 ok ? 16 : 0);
    }
  } else {
    for (int q = tid; q < BLK * FT; q += THREADS) {
      const int j = q / FT;
      const int c = q % FT;
      const int64_t gc = f0 + c;
      const bool ok = gc < feat;
      cp_async4(xs + j * FT + c, ok ? xb + j * feat + gc : xb, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// The identity hook: an entry's value is the entry (every walk but K7's)
struct Plain {
  static constexpr int SMEM = 0;                // floats of shared memory
  __device__ __forceinline__ void begin(float*, int64_t, int) {}
  __device__ __forceinline__ void tile(float*, int64_t, int) {}
  __device__ __forceinline__ float value(float*, float e, int, int, int,
                                         int) {
    return e;
  }
  __device__ __forceinline__ void finish(int64_t, int64_t, int, int) {}
};

// acc += sum, over the lanes' entries e != 0 in ascending lane order, of
// s.v . xs[32m + lane][the lane's 4 columns], v = get() the entry's value
// (called once, after a ballot that found a non-zero): one ballot, then a
// broadcast, a 16-byte slab read and 4 FMAs per non-zero
template <class Get>
__device__ __forceinline__ void apply(float e, Get get, int m, float s,
                                      const float* xs, int lane,
                                      float (&acc)[FL]) {
  unsigned nz = __ballot_sync(FULL, e != 0.f);
  if (nz == 0) return;
  const float w = get();
  while (nz) {
    const int src = __ffs(nz) - 1;
    nz &= nz - 1;
    const float v = __shfl_sync(FULL, w, src) * s;
    const float4 xv = *reinterpret_cast<const float4*>(
        xs + (32 * m + src) * FT + FL * lane);
    acc[0] = fmaf(v, xv.x, acc[0]);
    acc[1] = fmaf(v, xv.y, acc[1]);
    acc[2] = fmaf(v, xv.z, acc[2]);
    acc[3] = fmaf(v, xv.w, acc[3]);
  }
}

// acc = init rows r*BLK + row0 .. +ROWS-1, the lane's columns of slice f0
// (0 past feat): one 16-byte load a row where init starts on a 16-byte
// boundary and feat % 4 == 0 (its rows then all do), else one load a
// column
__device__ __forceinline__ void load_rows(float (&acc)[ROWS][FL],
                                          const float* __restrict__ init,
                                          int64_t r, int64_t f0, int row0,
                                          int lane, int64_t feat) {
  const int64_t c = f0 + FL * lane;
  const bool vec = reinterpret_cast<uintptr_t>(init) % 16 == 0
                   && feat % 4 == 0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float* p = init + (r * BLK + row0 + i) * feat + c;
    if (vec && c + FL <= feat) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      acc[i][0] = v.x;
      acc[i][1] = v.y;
      acc[i][2] = v.z;
      acc[i][3] = v.w;
    } else {
#pragma unroll
      for (int f = 0; f < FL; ++f) {
        acc[i][f] = c + f < feat ? __ldg(p + f) : 0.f;
      }
    }
  }
}

// out rows r*BLK + row0 .. +ROWS-1, the lane's columns of slice f0: one
// 16-byte store a row where feat % 4 == 0 (out is fresh, so its rows then
// start on 16-byte boundaries), else one store a column
__device__ __forceinline__ void store_rows(const float (&acc)[ROWS][FL],
                                           float* __restrict__ out,
                                           int64_t r, int64_t f0, int row0,
                                           int lane, int64_t feat) {
  const int64_t c = f0 + FL * lane;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float* o = out + (r * BLK + row0 + i) * feat + c;
    if (feat % 4 == 0 && c + FL <= feat) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int f = 0; f < FL; ++f) {
        if (c + f < feat) o[f] = acc[i][f];
      }
    }
  }
}

// The tile walk.  TRANS = false, rows orientation (K1, K2, K9, K10, K4,
// K8 and K7f): out[r] = init[r] + sum_k A_k @ X[cols[k]] over the run
// row_splits[r] .. row_splits[r+1]; sel and scale are unused (the callers
// pass null).  TRANS = true, columns orientation (K4T, K8 transposed and
// K7bt's dx): out[r] = init[r] + sum_k scale[k] . A_{sel[k]}^T @
// X[cols[k]]; a slot with scale 0 (a coverage filler of the transpose
// plan) is skipped uniformly.  init is read only under INIT (K1, K8), else
// zero.  DIAG (K8): the run of row r is tile r at column r and scale 1,
// and row_splits, sel, scale and cols are unused (null).  A's entries are
// applied as the values that the hook val gives them (Plain: as they
// are).
template <bool TRANS, bool INIT, bool VEC, bool DIAG, class V>
__global__ void __launch_bounds__(THREADS, 1)
walk_kernel(const float* __restrict__ blocks,
            const int32_t* __restrict__ row_splits,
            const int32_t* __restrict__ sel,
            const int32_t* __restrict__ scale,
            const int32_t* __restrict__ cols,
            const float* __restrict__ x, const float* __restrict__ init,
            float* __restrict__ out, int64_t feat, int64_t slices, V val) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                             // the swizzled tile
  float* xs = smem + BLK * BLK;                 // the X slab
  float* hs = xs + BLK * FT;                    // the hook's V::SMEM floats
  const int64_t r = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * ROWS;

  float acc[ROWS][FL];
  if (INIT) {
    load_rows(acc, init, r, f0, row0, lane, feat);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int f = 0; f < FL; ++f) acc[i][f] = 0.f;
    }
  }
  val.begin(hs, r, tid);

  // a slot's indices, read one step before they are used, so no load of
  // the walk waits on a load of an index
  struct Slot {
    int col;
    int tile;
    float s;                                    // 0: nothing to apply
  };
  auto slot = [&](int k) {
    if (DIAG) return Slot{k, k, 1.f};
    return TRANS ? Slot{cols[k], sel[k], static_cast<float>(scale[k])}
                 : Slot{cols[k], k, 1.f};
  };
  // the thread's chunks of a tile: chunk `lane` of the tile rows warp +
  // WARPS u, one coalesced 512-byte row a warp and load
  float4 ch[BLK / WARPS];
  auto fetch = [&](const Slot& c) {
    if (c.s != 0.f) {
      const float4* a = reinterpret_cast<const float4*>(
          blocks + static_cast<int64_t>(c.tile) * BLK * BLK) + lane;
#pragma unroll
      for (int u = 0; u < BLK / WARPS; ++u) {
        ch[u] = a[(warp + WARPS * u) * (BLK / 4)];
      }
    }
  };
  // float index of tile entry (i, j): chunk j / 4 of row i sits at chunk
  // (j / 4) ^ (i % 8)
  auto at = [](int i, int j) {
    return i * BLK + 4 * ((j >> 2) ^ (i & 7)) + (j & 3);
  };

  const int lo = DIAG ? static_cast<int>(r) : row_splits[r];
  const int nt = DIAG ? 1 : row_splits[r + 1] - lo;
  const Slot none{0, 0, 0.f};
  Slot c0 = nt > 0 ? slot(lo) : none;           // tile t, in ch
  Slot c1 = nt > 1 ? slot(lo + 1) : none;       // tile t + 1
  // DIAG: the one slab is known now, so its copy runs beside the tile read
  if (DIAG) start_slab<VEC>(xs, x + r * BLK * feat, f0, feat, tid);
  fetch(c0);
  for (int t = 0; t < nt; ++t) {
    bool any = false;
    if (c0.s != 0.f) {
#pragma unroll
      for (int u = 0; u < BLK / WARPS; ++u) {
        any |= ch[u].x != 0.f || ch[u].y != 0.f || ch[u].z != 0.f
               || ch[u].w != 0.f;
      }
    }
    // the vote is also the barrier after the last apply: the tile and the
    // slab may be overwritten
    const bool live = __syncthreads_or(any);
    if (live) {
#pragma unroll
      for (int u = 0; u < BLK / WARPS; ++u) {
        *reinterpret_cast<float4*>(as + at(warp + WARPS * u, 4 * lane)) =
            ch[u];
      }
      val.tile(hs, c0.col, tid);
      if (!DIAG) {
        start_slab<VEC>(xs, x + static_cast<int64_t>(c0.col) * BLK * feat,
                        f0, feat, tid);
      }
    }
    const float st = c0.s;
    c0 = c1;
    fetch(c0);                                  // lands during the apply
    c1 = t + 2 < nt ? slot(lo + t + 2) : none;
    if (!live) continue;
    cp_async_wait<0>();
    __syncthreads();
    if (TRANS) {
      // output rows 4q .. 4q+3 take tile columns 4q .. 4q+3: one float4
      // of each tile row j = lane + 32m
#pragma unroll
      for (int qd = 0; qd < ROWS / 4; ++qd) {
        const int q = warp * (ROWS / 4) + qd;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = lane + 32 * m;
          const float4 v = *reinterpret_cast<const float4*>(as + at(j, 4 * q));
          // the four values first, so that their work overlaps
          const float w[4] = {val.value(hs, v.x, 4 * qd + 0, m, row0, lane),
                              val.value(hs, v.y, 4 * qd + 1, m, row0, lane),
                              val.value(hs, v.z, 4 * qd + 2, m, row0, lane),
                              val.value(hs, v.w, 4 * qd + 3, m, row0, lane)};
          apply(v.x, [&] { return w[0]; }, m, st, xs, lane, acc[4 * qd + 0]);
          apply(v.y, [&] { return w[1]; }, m, st, xs, lane, acc[4 * qd + 1]);
          apply(v.z, [&] { return w[2]; }, m, st, xs, lane, acc[4 * qd + 2]);
          apply(v.w, [&] { return w[3]; }, m, st, xs, lane, acc[4 * qd + 3]);
        }
      }
    } else {
      // output row i takes tile row i: entries j = lane + 32m
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          // the value only where the ballot found a non-zero
          const float e = as[at(row0 + i, lane + 32 * m)];
          apply(e, [&] { return val.value(hs, e, i, m, row0, lane); }, m,
                1.f, xs, lane, acc[i]);
        }
      }
    }
  }
  if (DIAG) cp_async_wait<0>();                 // a block without a non-zero
  store_rows(acc, out, r, f0, row0, lane, feat);
  val.finish(r, f0, row0, lane);
}

// Launches the walk on the flat grid of num_row_blocks * ceil(feat / FT)
// CTAs (SMEM bytes of dynamic shared memory each, and the hook's V::SMEM
// floats), from init under INIT, else from zero (init unused); under DIAG
// over the diagonal blocks (the index arrays unused); nothing when either
// count is 0;
// cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1 CTAs,
// else cudaGetLastError() after the launch.  The vector slab copy is
// chosen on x's alignment; the kernel chooses the vector init load on
// init's own.  val is the value hook (Plain: the entries as they are).
template <bool TRANS, bool INIT, bool DIAG = false, class V = Plain>
cudaError_t launch(const float* blocks, const int32_t* row_splits,
                   const int32_t* sel, const int32_t* scale,
                   const int32_t* cols, const float* x, const float* init,
                   float* out, int64_t num_row_blocks, int64_t feat,
                   cudaStream_t stream, V val = V{}) {
  if (num_row_blocks > 0 && feat > 0) {
    const int64_t slices = (feat + FT - 1) / FT;
    const int64_t ctas = num_row_blocks * slices;
    if (ctas > 0x7fffffff) return cudaErrorInvalidConfiguration;
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % 4 == 0;
    const auto kernel = vec ? walk_kernel<TRANS, INIT, true, DIAG, V>
                            : walk_kernel<TRANS, INIT, false, DIAG, V>;
    const int bytes = SMEM + V::SMEM * static_cast<int>(sizeof(float));
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    kernel<<<static_cast<unsigned>(ctas), THREADS, bytes, stream>>>(
        blocks, row_splits, sel, scale, cols, x, init, out, feat, slices,
        val);
  }
  return cudaGetLastError();
}

}  // namespace sparse
