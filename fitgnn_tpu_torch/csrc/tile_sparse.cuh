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
// finite.  It covers the bf16 forms below too.
//
// Tile types.  The walk is templated on the stored tile's element type T
// and on ROUND_X.  T = float (every walk above) is the f32 tile.  T =
// __nv_bfloat16 is the tile of the JAX package's tile_dtype=bfloat16
// (train --hybrid_bf16_tiles): a tile row is 256 bytes, so a thread reads
// its share of a tile as four 16-byte loads of 8 entries (row 32u + 2 warp
// + lane / 16, entries 8 (lane % 16) .. +7: one contiguous 512-byte piece
// a warp and load), half the registers the f32 tile takes.  The vote reads
// the raw bits (an entry counts where its bits other than the sign are
// set, as e != 0 does), and a live tile is widened to f32 (exact: a bf16
// is the top half of an f32) as it is stored to shared memory, with the
// same swizzle; lanes whose 8 entries start in an odd 4-chunk of their
// row store their second 16-byte chunk first, so that each phase of 8
// lanes writes 8 distinct bank groups.  Past the store the walk is the
// f32 walk.  ROUND_X rounds each element of the X slab to bf16 (round to
// nearest even) once it has landed, by the thread that copied it, before
// the barrier that publishes it: the Pallas kernels cast x to bf16 when
// the tile is bf16 and take bf16 x bf16 products, exact in f32, summed in
// f32 (fitgnn_tpu/ops/pallas/bsr_spmm.py:168-169, 219-220, 285-286;
// diag_spmm.py:43-44).  The instantiations and the TPU kernels they
// replace with bf16 tiles:
//   <T = __nv_bfloat16, ROUND_X> rows from init (bsr_spmm.cu's K1 bf16)
//     _kernel_acc; rows from zero (K2 and K9 bf16) _kernel and
//     _make_grouped_kernel; under DIAG, both orientations, from init or
//     zero (diag_spmm.cu's K8 bf16) diag_spmm.py:_make_kernel;
//   <T = __nv_bfloat16, no ROUND_X> rows from zero (K10 bf16)
//     _rowwalk_kernel, whose jnp.dot of a bf16 tile and an f32 slab
//     promotes the tile and leaves x unrounded (bsr_spmm.py:364-365); the
//     hooks att::FwdScores and att::DxScores (K7f and K7bt's dx bf16)
//     att_bsr.py:_fwd_kernel and _bwd_t_kernel, whose bf16 tiles are GAT's
//     0/1 mask, exact in bf16, while pe and x stay f32.
// The shared-memory tile stays f32 (64 KB): holding it as bf16 and the
// apply's reads of it at 2 bytes an entry is later work.
//
// Activation types.  The walk's last template parameter A is the type of
// x, init and out: float for every walk above, __nv_bfloat16 for
//   the rows walk from init at edge 128 (K1a on f32 tiles, K1bfa on bf16
//     tiles, bsr_spmm.cu), the bf16 branch of _kernel_acc
//     (bsr_spmm.py:200-222);
//   the dynamic tiles' walks from zero on bf16 tiles (K4a rows, K4Ta
//     columns, bsr_dynamic.cu: GAT's pe in the activations' type), at
//     edge 128 and as the quadrant walk above it, with or without the
//     occupancy words (walk_live), the bf16 branch of _make_dyn_kernel
//     (bsr_dynamic.py:82-86);
// each under the Plain hook.  The slab is copied as bf16 (cp.async, 8
// values a 16-byte piece) into the f32 slab's place (in walk_live each of
// the two) and read as bf16 by the apply (an 8-byte read a lane a
// non-zero, half the f32 slab's), each value widened to f32 (exact); init
// is widened as it is read; the sums are f32 FMAs as above and each is
// rounded to bf16 once as it is stored (to nearest even), where the Pallas
// kernel rounds each tile's product into its bf16 output block.  On bf16
// tiles the products are bf16 x bf16, on f32 tiles the tile promotes x;
// exact in f32 either way, so ROUND_X has nothing to do (x is bf16
// already) and is off.  No other walk takes bf16 activations (a
// static_assert in walk_kernel): K1 above 128, K2, K9, K10, DIAG and the
// hook forms take the widened route (ops/kernels.py).
//
// Tiles of another edge (QUAD).  The JAX package's build_hybrid(block=E)
// and build_bsr(block=E) store (K, E, E) tiles for any E = 128 nq (Mosaic
// needs the multiple of 128, fitgnn_tpu/ops/pallas/att_bsr.py:28-29); K1,
// K2 and K9 take E as a static argument (bsr_spmm.py:174-175, 225-226,
// 294-296), K8 from its blocks' shape (diag_spmm.py:34), and GAT's K4 and
// K4T (build_hybrid(block=E, semantics="att_unit")) through _dyn_apply's
// static block (bsr_dynamic.py:91-92).  One f32 tile
// of edge 256 is 256 KiB, above the 227 KiB of shared memory a block can
// have, so the walk keeps its 128-wide staging and walks an E tile as
// nq x nq quadrants of 128 x 128: output block R (128 rows) is half
// h = R % nq of tile row r = R / nq, and its CTA walks quadrants (h, q),
// q < nq, of each tile of row r in turn (the columns orientation takes
// quadrant (q, h), read transposed as any tile is), against X's 128-row
// slab col nq + q.  A quadrant is read in place at row stride E: each of
// its 128-float rows is still 512 contiguous bytes.  The vote, the slab
// copy and the register prefetch work per quadrant, so an empty quadrant
// (most off-diagonal ones on the bench graph, and every quadrant of K9's
// pads) costs only its read, and the next (slot, quadrant)'s read is in
// flight while the current one is applied.  Under DIAG a CTA walks the nq
// quadrants of one tile, so its slab copies start after each vote as in
// the other walks.  QUAD is a template flag: at E = 128 (nq = 1) the walk
// is the code above, unchanged; the launches of K1, K2, K9, K8, K4 and K4T
// (the Plain hook) and of K7f and K7bt's dx (att_bsr.cu's hooks) build a
// QUAD form.  The columns walk over quadrants outside DIAG (K4T, K7bt's
// dx): its slots' sel, scale and column tiles count in E as the other
// indices do, and a scale-0 slot skips all nq of its quadrants.  A hook's
// operands are 128-row score slices, so under QUAD its begin and finish
// take the CTA's 128-row output block (ob = r nq + h), not the tile row r,
// and its tile step the partner's 128-row slab of the current quadrant
// (cols[k] nq + q, the slab that start_slab copies beside it): in the rows
// orientation the columns of quadrant (h, q), in the columns orientation
// the forward rows of quadrant (q, h).  Without QUAD both are r and
// cols[k], as they were.
//
// Occupancy words (WORDS).  build_bsr stores beside tiles wider than 128
// one 64-bit word a tile, bit i nq + j set where quadrant (i, j) holds an
// entry that the vote counts (f32 e != 0; bf16 the bits other than the
// sign): nq <= 8.  A QUAD launch of the Plain hook outside DIAG that is
// given them (K1, K2 and K9 at 256, bsr_spmm.cu; K4 and K4T at 256,
// bsr_dynamic.cu) walks the live quadrants of output half h only
// (walk_live): a slot carries row h's nq bits of its word, read with its
// column (and, in the columns orientation, its tile) one slot ahead, and
// an empty quadrant is never read, voted on or waited for; a slot whose
// row holds no live quadrant (every one of K9's pads, K4T's scale-0
// fillers) costs its index reads.  The columns orientation (K4T) takes per
// slot the word of tile sel[k] transposed, bit i nq + j moved to j nq + i
// (the transpose plan's t_words, ops/bsr_dynamic.py), so that its row-h
// bits are quadrants (q, h) of tile sel[k], the ones its output half h
// reads; a scale-0 slot's word is 0, and the walk applies at scale 1.  The
// empty quadrants applied nothing, and the live ones are taken in
// ascending (slot, q) order as the walk without words takes them, so the
// output is that walk's, bit for bit.  Since every
// quadrant walked is live, no vote gates the slab copy: the X slab is
// double-buffered (the tile and two slabs, 192 KiB), and the next live
// quadrant's slab copy starts with its tile's register prefetch, before
// the current quadrant is applied, as DIAG's does.  On bf16 tiles it
// rounds the landed slab two values a conversion (round_slab_pairs).  A set bit on an empty
// quadrant only costs its walk; a cleared bit on a live quadrant drops its
// product, as the plain versions with words drop it (K4 and K4T's plain
// versions read no words: there a value that only a cleared quadrant holds
// is the walk's divergence, bsr_dynamic.cu).  K7f's rows walk takes the
// words too (att_bsr.cu, the plan's words of the mask): its hook's
// partner operand (ssrc of the quadrant's slab) is double-buffered beside
// the slabs and staged into each slab's cp.async group (stage), its value
// step reads the buffer of the slab being applied (value_live), and its
// den partials sit in shared memory after them (begin_live, finish_live);
// the order of its adds is the walk without words', so num and den are
// that walk's bit for bit.  K7bt's dx, the columns walk under DxScores,
// takes the transpose slots' words (the plan's t_words) the same way: its
// partner operands (sdst and m of the quadrant's forward rows) ride each
// slab's group in two buffers, and its value step forms the four values
// of a float4 before their ballots, as the walk without words does, from
// the buffer of the slab being applied; a filler slot's word is 0, so no
// filler is walked, and dx is that walk's bit for bit.  The hooks a words
// walk takes are listed by takes_words (Plain in both orientations,
// FwdScores in the rows one, DxScores in the columns one).  WORDS is a
// template flag: every launch without words (null words; K8, every walk
// at 128) builds the code above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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
// with occupancy words: the tile and two X slabs, 192 KB
constexpr int SMEM_WORDS = SMEM + BLK * FT * static_cast<int>(sizeof(float));
constexpr int MAX_WORD_QUADS = 8;               // nq^2 bits in 64

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

// a bf16 pair's two values as f32 (exact): the low half is the first
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// four consecutive tile entries as f32, from a 16-byte (f32) or 8-byte
// (bf16) aligned address
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// v rounded to bf16 (to nearest even), as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// float index of tile entry (i, j) in the swizzled shared-memory tile:
// chunk j / 4 of row i sits at chunk (j / 4) ^ (i % 8)
__device__ __forceinline__ int swizzled(int i, int j) {
  return i * BLK + 4 * ((j >> 2) ^ (i & 7)) + (j & 3);
}

// A thread's share of one tile in registers, read one step ahead of its
// use; any() is the thread's vote, store() writes the share to the
// swizzled shared-memory tile as f32.
template <class T>
struct TileRegs;

// f32: chunk `lane` (4 entries) of the tile rows warp + WARPS u, one
// coalesced 512-byte row a warp and load
template <>
struct TileRegs<float> {
  float4 ch[BLK / WARPS];
  // STRIDED: a quadrant of a wider tile, its rows ld floats apart
  template <bool STRIDED>
  __device__ __forceinline__ void load(const float* tile, int64_t ld,
                                       int warp, int lane) {
    if (STRIDED) {
      const float* a = tile + 4 * lane;
#pragma unroll
      for (int u = 0; u < BLK / WARPS; ++u) {
        ch[u] = *reinterpret_cast<const float4*>(a + (warp + WARPS * u) * ld);
      }
      return;
    }
    const float4* a = reinterpret_cast<const float4*>(tile) + lane;
#pragma unroll
    for (int u = 0; u < BLK / WARPS; ++u) {
      ch[u] = a[(warp + WARPS * u) * (BLK / 4)];
    }
  }
  __device__ __forceinline__ bool any() const {
    bool any = false;
#pragma unroll
    for (int u = 0; u < BLK / WARPS; ++u) {
      any |= ch[u].x != 0.f || ch[u].y != 0.f || ch[u].z != 0.f
             || ch[u].w != 0.f;
    }
    return any;
  }
  __device__ __forceinline__ void store(float* as, int warp, int lane) const {
#pragma unroll
    for (int u = 0; u < BLK / WARPS; ++u) {
      *reinterpret_cast<float4*>(as + swizzled(warp + WARPS * u, 4 * lane)) =
          ch[u];
    }
  }
};

// bf16: 16-byte piece u of the thread, tile row 32u + 2 warp + lane / 16,
// entries 8 (lane % 16) .. +7; the pieces of a warp and load are one
// contiguous 512 bytes (piece index 512u + 32 warp + lane)
template <>
struct TileRegs<__nv_bfloat16> {
  static constexpr int N = BLK * BLK / 8 / THREADS;   // 4
  uint4 ch[N];
  // STRIDED: a quadrant of a wider tile, its rows ld entries apart
  template <bool STRIDED>
  __device__ __forceinline__ void load(const __nv_bfloat16* tile, int64_t ld,
                                       int warp, int lane) {
    if (STRIDED) {
      const __nv_bfloat16* a =
          tile + (2 * warp + (lane >> 4)) * ld + 8 * (lane & 15);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        ch[u] = *reinterpret_cast<const uint4*>(a + 32 * u * ld);
      }
      return;
    }
    const uint4* a = reinterpret_cast<const uint4*>(tile) + 32 * warp + lane;
#pragma unroll
    for (int u = 0; u < N; ++u) ch[u] = a[THREADS * u];
  }
  __device__ __forceinline__ bool any() const {
    uint32_t bits = 0;
#pragma unroll
    for (int u = 0; u < N; ++u) bits |= ch[u].x | ch[u].y | ch[u].z | ch[u].w;
    return (bits & 0x7fff7fffu) != 0;             // +-0 is no non-zero
  }
  __device__ __forceinline__ void store(float* as, int warp, int lane) const {
    const int c = lane & 15;                      // 8-entry piece of the row
    const bool odd = (c >> 2) & 1;                // second chunk first
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = 32 * u + 2 * warp + (lane >> 4);
      const float4 a = make_float4(bf16_lo(ch[u].x), bf16_hi(ch[u].x),
                                   bf16_lo(ch[u].y), bf16_hi(ch[u].y));
      const float4 b = make_float4(bf16_lo(ch[u].z), bf16_hi(ch[u].z),
                                   bf16_lo(ch[u].w), bf16_hi(ch[u].w));
      float* row = as + i * BLK;
      *reinterpret_cast<float4*>(row + 4 * ((2 * c + odd) ^ (i & 7))) =
          odd ? b : a;
      *reinterpret_cast<float4*>(row + 4 * ((2 * c + !odd) ^ (i & 7))) =
          odd ? a : b;
    }
  }
};

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

// The slab copy of bf16 activations (the walk's A = __nv_bfloat16): the
// 128 slab rows land as bf16 where the f32 slab would (xs, row stride FT
// values), 16-byte pieces of 8 values as one cp.async group, 0 past feat;
// the apply reads them as bf16 (half the shared-memory bytes of an f32
// slab a non-zero) and widens each to f32 (exact).  VEC: x starts on a
// 16-byte boundary and feat % 8 == 0; otherwise each value is loaded and
// stored here, and the group is empty.
template <bool VEC>
__device__ __forceinline__ void start_slab(float* xs,
                                           const __nv_bfloat16* __restrict__ xb,
                                           int64_t f0, int64_t feat,
                                           int tid) {
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(xs);
  if (VEC) {
    for (int q = tid; q < BLK * FT / 8; q += THREADS) {
      const int j = q / (FT / 8);
      const int c8 = (q % (FT / 8)) * 8;
      const int64_t gc = f0 + c8;
      const bool ok = gc < feat;
      cp_async16(reinterpret_cast<float*>(st + j * FT + c8),
                 reinterpret_cast<const float*>(ok ? xb + j * feat + gc : xb),
                 ok ? 16 : 0);
    }
  } else {
    for (int q = tid; q < BLK * FT; q += THREADS) {
      const int j = q / FT;
      const int c = q % FT;
      const int64_t gc = f0 + c;
      st[j * FT + c] = gc < feat ? xb[j * feat + gc] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
}

// Rounds to bf16 the slab elements that start_slab<VEC> had thread tid
// copy (those it sees once its copies have landed): 16-byte piece q at
// xs + 4q under VEC, else element q
template <bool VEC>
__device__ __forceinline__ void round_slab(float* xs, int tid) {
  if (VEC) {
    for (int q = tid; q < BLK * FT / 4; q += THREADS) {
      float4* p = reinterpret_cast<float4*>(xs) + q;
      const float4 v = *p;
      *p = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                       round_bf16(v.w));
    }
  } else {
    for (int q = tid; q < BLK * FT; q += THREADS) xs[q] = round_bf16(xs[q]);
  }
}

// round_slab with two values a conversion (cvt.rn.bf16x2.f32) under VEC:
// the same values, half the conversion instructions.  Only the words walk
// takes it: every walk without words keeps round_slab, so that it builds
// to the code, registers and times it had before the words (ROADMAP.md
// §2 has round_slab become this form once those walks are re-measured)
template <bool VEC>
__device__ __forceinline__ void round_slab_pairs(float* xs, int tid) {
  if (!VEC) {
    round_slab<false>(xs, tid);
    return;
  }
  for (int q = tid; q < BLK * FT / 4; q += THREADS) {
    float4* p = reinterpret_cast<float4*>(xs) + q;
    const float4 v = *p;
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    const uint32_t ua = *reinterpret_cast<const uint32_t*>(&a);
    const uint32_t ub = *reinterpret_cast<const uint32_t*>(&b);
    *p = make_float4(bf16_lo(ua), bf16_hi(ua), bf16_lo(ub), bf16_hi(ub));
  }
}

// The identity hook: an entry's value is the entry (every walk but K7's).
// The steps ending in _live are the walk of the live quadrants' (WORDS,
// walk_live): the hook's shared memory (SMEM_LIVE floats) lies after the
// two slabs, its partner operand copied into buffer buf beside slab buf
// (stage: into the slab's cp.async group, no commit of its own)
struct Plain {
  static constexpr int SMEM = 0;                // floats of shared memory
  static constexpr int SMEM_LIVE = 0;           // the same in walk_live
  __device__ __forceinline__ void begin(float*, int64_t, int) {}
  __device__ __forceinline__ void tile(float*, int64_t, int) {}
  __device__ __forceinline__ float value(float*, float e, int, int, int,
                                         int) {
    return e;
  }
  __device__ __forceinline__ void finish(int64_t, int64_t, int, int) {}
  __device__ __forceinline__ void begin_live(float*, int64_t, int) {}
  __device__ __forceinline__ void stage(float*, int, int64_t, int) {}
  __device__ __forceinline__ float value_live(float*, int, float e, int, int,
                                              int, int) {
    return e;
  }
  __device__ __forceinline__ void finish_live(float*, int64_t, int64_t, int,
                                              int) {}
};

// The hooks that the walk of the live quadrants takes, by orientation:
// Plain in both (K1, K2, K9, K4, K4T); att_bsr.cu adds K7f's FwdScores in
// the rows orientation and K7bt's DxScores in the columns one
template <class V, bool TRANS>
struct takes_words : std::is_same<V, Plain> {};

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

// apply on a bf16 slab (the walk's A = __nv_bfloat16): the lane's 4
// columns of slab row 32m + src one 8-byte read, widened to f32 (exact)
template <class Get>
__device__ __forceinline__ void apply(float e, Get get, int m, float s,
                                      const __nv_bfloat16* xs, int lane,
                                      float (&acc)[FL]) {
  unsigned nz = __ballot_sync(FULL, e != 0.f);
  if (nz == 0) return;
  const float w = get();
  while (nz) {
    const int src = __ffs(nz) - 1;
    nz &= nz - 1;
    const float v = __shfl_sync(FULL, w, src) * s;
    const uint2 u = *reinterpret_cast<const uint2*>(
        xs + (32 * m + src) * FT + FL * lane);
    acc[0] = fmaf(v, bf16_lo(u.x), acc[0]);
    acc[1] = fmaf(v, bf16_hi(u.x), acc[1]);
    acc[2] = fmaf(v, bf16_lo(u.y), acc[2]);
    acc[3] = fmaf(v, bf16_hi(u.y), acc[3]);
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

// load_rows for bf16 init, widened to f32 (exact): one 8-byte load a row
// where init starts on an 8-byte boundary and feat % 4 == 0, else one load
// a column
__device__ __forceinline__ void load_rows(float (&acc)[ROWS][FL],
                                          const __nv_bfloat16* __restrict__ init,
                                          int64_t r, int64_t f0, int row0,
                                          int lane, int64_t feat) {
  const int64_t c = f0 + FL * lane;
  const bool vec = reinterpret_cast<uintptr_t>(init) % 8 == 0
                   && feat % 4 == 0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const __nv_bfloat16* p = init + (r * BLK + row0 + i) * feat + c;
    if (vec && c + FL <= feat) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      acc[i][0] = bf16_lo(u.x);
      acc[i][1] = bf16_hi(u.x);
      acc[i][2] = bf16_lo(u.y);
      acc[i][3] = bf16_hi(u.y);
    } else {
#pragma unroll
      for (int f = 0; f < FL; ++f) {
        acc[i][f] = c + f < feat ? __bfloat162float(p[f]) : 0.f;
      }
    }
  }
}

// store_rows for a bf16 out: each sum rounded to bf16 once (to nearest
// even); one 8-byte store a row where feat % 4 == 0 (out is fresh, so its
// rows then start on 8-byte boundaries), else one store a column
__device__ __forceinline__ void store_rows(const float (&acc)[ROWS][FL],
                                           __nv_bfloat16* __restrict__ out,
                                           int64_t r, int64_t f0, int row0,
                                           int lane, int64_t feat) {
  const int64_t c = f0 + FL * lane;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    __nv_bfloat16* o = out + (r * BLK + row0 + i) * feat + c;
    if (feat % 4 == 0 && c + FL <= feat) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a);
      u.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(o) = u;
    } else {
#pragma unroll
      for (int f = 0; f < FL; ++f) {
        if (c + f < feat) o[f] = __float2bfloat16_rn(acc[i][f]);
      }
    }
  }
}

// acc += the walk of tile row r's run row_splits[r] .. row_splits[r+1]
// over the live quadrants of output half h, by the occupancy words (the
// header's WORDS), in ascending (slot, q) order.  Rows (TRANS = false):
// quadrant (h, q) of tile k against X's 128-row slab cols[k] nq + q; sel
// is unread.  Columns (TRANS): quadrant (q, h) of tile sel[k], read
// transposed, against slab cols[k] nq + q, at scale 1; words[k] is tile
// sel[k]'s word transposed (0 on a scale-0 slot).  smem holds the tile and
// two slabs, then the hook's SMEM_LIVE floats (hs); the hook's partner
// operand of each live quadrant is staged into the group of its slab, in
// the buffer of that slab (rows orientation: K7f's ssrc; columns: K7bt's
// sdst and m), and its value step sees that buffer.  Called by every
// thread of the CTA (the walk is uniform).
template <bool TRANS, bool VEC, class T, bool ROUND_X, class V, class A>
__device__ __forceinline__ void walk_live(
    const T* __restrict__ blocks, const int32_t* __restrict__ row_splits,
    const int32_t* __restrict__ sel, const int32_t* __restrict__ cols,
    const uint64_t* __restrict__ words, const A* __restrict__ x,
    float* smem, int64_t r, int h, int nq, int64_t f0, int64_t feat,
    int tid, float (&acc)[ROWS][FL], V& val, float* hs) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * ROWS;
  float* as = smem;
  float* const xs[2] = {smem + BLK * BLK, smem + BLK * BLK + BLK * FT};
  const int64_t edge = static_cast<int64_t>(nq) * BLK;
  const unsigned row_bits = (1u << nq) - 1;
  const int end = row_splits[r + 1];
  // slot k0 is the current one, m0 its live quadrants not yet walked (the
  // current quadrant the lowest); slot k1's column, bits (and under TRANS
  // its tile) are read one slot ahead
  int k0 = 0, col0 = 0, k1 = row_splits[r], col1 = 0;
  int tile0 = 0, tile1 = 0;                     // TRANS: sel of k0, k1
  unsigned m0 = 0, m1 = 0;
  auto read = [&] {
    if (k1 < end) {
      col1 = cols[k1];
      if (TRANS) tile1 = sel[k1];
      m1 = static_cast<unsigned>(words[k1] >> (h * nq)) & row_bits;
    }
  };
  // on to the next slot with a live quadrant, if m0 has none left
  auto seek = [&] {
    while (m0 == 0 && k1 < end) {
      k0 = k1;
      col0 = col1;
      if (TRANS) tile0 = tile1;
      m0 = m1;
      ++k1;
      read();
    }
  };
  TileRegs<T> ch;
  auto fetch = [&](int q) {
    if (TRANS) {
      ch.template load<true>(blocks + tile0 * edge * edge + q * BLK * edge
                                 + h * BLK, edge, warp, lane);
    } else {
      ch.template load<true>(blocks + k0 * edge * edge + h * BLK * edge
                                 + q * BLK, edge, warp, lane);
    }
  };
  auto slab = [&](float* to, int q) {
    start_slab<VEC>(to, x + (static_cast<int64_t>(col0) * nq + q) * BLK
                               * feat, f0, feat, tid);
  };
  read();
  seek();
  if (m0 != 0) {
    const int q = __ffs(m0) - 1;
    val.stage(hs, 0, static_cast<int64_t>(col0) * nq + q, tid);
    slab(xs[0], q);
    fetch(q);
  }
  // the current quadrant is in ch, its slab copy in flight into xs[buf]
  for (int buf = 0; m0 != 0; buf ^= 1) {
    // the last apply is done: the tile and slab buf ^ 1 may be overwritten
    __syncthreads();
    ch.store(as, warp, lane);
    m0 &= m0 - 1;
    seek();
    if (m0 != 0) {
      // the next live quadrant's slab (with the hook's operand) and tile,
      // in flight during the apply
      const int q = __ffs(m0) - 1;
      val.stage(hs, buf ^ 1, static_cast<int64_t>(col0) * nq + q, tid);
      slab(xs[buf ^ 1], q);
      fetch(q);
    } else {
      cp_async_commit();                        // an empty group
    }
    cp_async_wait<1>();                         // slab buf has landed
    if (ROUND_X) round_slab_pairs<VEC>(xs[buf], tid);
    __syncthreads();
    const A* xa = reinterpret_cast<const A*>(xs[buf]);  // as apply reads it
    if (TRANS) {
      // output rows 4q .. 4q+3 take tile columns 4q .. 4q+3: one float4
      // of each tile row j = lane + 32m, as the walk without words
#pragma unroll
      for (int qd = 0; qd < ROWS / 4; ++qd) {
        const int q = warp * (ROWS / 4) + qd;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(
              as + swizzled(lane + 32 * m, 4 * q));
          // the four values first, so that their work overlaps (Plain's
          // are the entries)
          const float w[4] = {
              val.value_live(hs, buf, v.x, 4 * qd + 0, m, row0, lane),
              val.value_live(hs, buf, v.y, 4 * qd + 1, m, row0, lane),
              val.value_live(hs, buf, v.z, 4 * qd + 2, m, row0, lane),
              val.value_live(hs, buf, v.w, 4 * qd + 3, m, row0, lane)};
          apply(v.x, [&] { return w[0]; }, m, 1.f, xa, lane,
                acc[4 * qd + 0]);
          apply(v.y, [&] { return w[1]; }, m, 1.f, xa, lane,
                acc[4 * qd + 1]);
          apply(v.z, [&] { return w[2]; }, m, 1.f, xa, lane,
                acc[4 * qd + 2]);
          apply(v.w, [&] { return w[3]; }, m, 1.f, xa, lane,
                acc[4 * qd + 3]);
        }
      }
    } else {
      // output row i takes tile row i: entries j = lane + 32m, the value
      // only where the ballot found a non-zero
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float e = as[swizzled(row0 + i, lane + 32 * m)];
          apply(e, [&] {
            return val.value_live(hs, buf, e, i, m, row0, lane);
          }, m, 1.f, xa, lane, acc[i]);
        }
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
// are).  T is the stored tile's element type (float or __nv_bfloat16);
// ROUND_X rounds the X slab to bf16 before the products (bf16 tiles only).
// QUAD: the tiles are (K, E, E), E = nq * 128 (nq > 1), and every index
// above (block rows, cols, the diagonal blocks) counts in E; the walk
// takes each tile as its nq x nq quadrants, and the hook sees 128-row
// blocks (its begin and finish the output block, its tile step the
// quadrant's partner slab).  Without QUAD, nq is 1 and unread.  WORDS
// (QUAD, no DIAG, a hook of takes_words: Plain in either orientation,
// K7f's FwdScores in the rows one, K7bt's DxScores in the columns one):
// words holds each slot's occupancy word
// (under TRANS its tile's, transposed) and the walk takes the live
// quadrants only (walk_live, the hook's shared memory after the two
// slabs); otherwise words is unread.  A is the activations' type (x, init
// and out): float, or __nv_bfloat16 (K1a and K1bfa, bsr_spmm.cu: the rows
// walk from init at edge 128; K4a and K4Ta, bsr_dynamic.cu: both walks
// from zero on bf16 tiles, at 128 and over quadrants, with or without
// words; Plain hook), whose slab is copied as bf16 and read as bf16 by
// the apply, which widens each value (start_slab, apply), whose init is
// widened as it is read and whose sums are rounded to bf16 once as they
// are stored; the sums are f32 as in the f32 walk.
template <bool TRANS, bool INIT, bool VEC, bool DIAG, class V, class T,
          bool ROUND_X, bool WORDS, bool QUAD, class A = float>
__global__ void __launch_bounds__(THREADS, 1)
walk_kernel(const T* __restrict__ blocks,
            const int32_t* __restrict__ row_splits,
            const int32_t* __restrict__ sel,
            const int32_t* __restrict__ scale,
            const int32_t* __restrict__ cols,
            const uint64_t* __restrict__ words,
            const A* __restrict__ x, const A* __restrict__ init,
            A* __restrict__ out, int64_t feat, int64_t slices, V val,
            int nq) {
  static_assert(!WORDS || (QUAD && !DIAG && takes_words<V, TRANS>::value),
                "occupancy words: the walk of quadrants, a hook it takes");
  static_assert(std::is_same<A, float>::value
                || (std::is_same<A, __nv_bfloat16>::value && !DIAG
                    && !ROUND_X && std::is_same<V, Plain>::value
                    && (!TRANS || std::is_same<T, __nv_bfloat16>::value)
                    && (!QUAD || (!INIT && std::is_same<T,
                                                        __nv_bfloat16>::value))),
                "bf16 activations: the rows walk from init at edge 128 (K1a, "
                "K1bfa) and the dynamic tiles' walks on bf16 tiles (K4a, "
                "K4Ta), Plain hook");
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                             // the swizzled tile
  float* xs = smem + BLK * BLK;                 // the X slab
  float* hs = xs + BLK * FT;                    // the hook's V::SMEM floats
  const A* xa = reinterpret_cast<const A*>(xs); // the slab as apply reads it
  // the 128-row output block, and under QUAD its tile row and half
  const int64_t ob = static_cast<int64_t>(blockIdx.x) / slices;
  const int64_t r = QUAD ? ob / nq : ob;
  const int h = QUAD ? static_cast<int>(ob % nq) : 0;
  const int64_t edge = static_cast<int64_t>(QUAD ? nq : 1) * BLK;
  const int64_t f0 = (static_cast<int64_t>(blockIdx.x) % slices) * FT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * ROWS;

  float acc[ROWS][FL];
  if (INIT) {
    load_rows(acc, init, ob, f0, row0, lane, feat);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int f = 0; f < FL; ++f) acc[i][f] = 0.f;
    }
  }
  if constexpr (WORDS) {
    // the hook's shared memory after the two slabs
    float* hl = smem + BLK * BLK + 2 * BLK * FT;
    val.begin_live(hl, ob, tid);
    walk_live<TRANS, VEC, T, ROUND_X>(blocks, row_splits, sel, cols, words,
                                      x, smem, r, h, nq, f0, feat, tid, acc,
                                      val, hl);
    store_rows(acc, out, ob, f0, row0, lane, feat);
    val.finish_live(hl, ob, f0, row0, lane);
    return;
  }
  val.begin(hs, ob, tid);

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
  // the thread's share of a tile (TileRegs<T>); under QUAD of quadrant
  // (h, q) of the tile, (q, h) in the columns orientation
  TileRegs<T> ch;
  auto fetch = [&](const Slot& c, int q) {
    if (c.s != 0.f) {
      if (QUAD) {
        const int64_t i = TRANS ? q : h, j = TRANS ? h : q;
        ch.template load<true>(
            blocks + c.tile * edge * edge + i * BLK * edge + j * BLK, edge,
            warp, lane);
      } else {
        ch.template load<false>(
            blocks + static_cast<int64_t>(c.tile) * BLK * BLK, BLK, warp,
            lane);
      }
    }
  };

  const int lo = DIAG ? static_cast<int>(r) : row_splits[r];
  const int nt = DIAG ? 1 : row_splits[r + 1] - lo;
  const Slot none{0, 0, 0.f};
  Slot c0 = nt > 0 ? slot(lo) : none;           // tile t, in ch
  Slot c1 = nt > 1 ? slot(lo + 1) : none;       // tile t + 1
  int quad = 0;                                 // QUAD: c0's quadrant in ch
  int next = lo + 2;                            // QUAD: c1's successor
  // DIAG: the one slab is known now, so its copy runs beside the tile read
  if (DIAG && !QUAD) start_slab<VEC>(xs, x + r * BLK * feat, f0, feat, tid);
  fetch(c0, 0);
  for (int t = 0; t < (QUAD ? nt * nq : nt); ++t) {
    bool any = false;
    if (c0.s != 0.f) any = ch.any();
    // the vote is also the barrier after the last apply: the tile and the
    // slab may be overwritten
    const bool live = __syncthreads_or(any);
    if (live) {
      ch.store(as, warp, lane);
      if (QUAD) {
        // the partner's 128-row slab of this quadrant, for the hook too
        const int64_t slab = static_cast<int64_t>(c0.col) * nq + quad;
        val.tile(hs, slab, tid);
        start_slab<VEC>(xs, x + slab * BLK * feat, f0, feat, tid);
      } else {
        val.tile(hs, c0.col, tid);
        if (!DIAG) {
          start_slab<VEC>(xs, x + static_cast<int64_t>(c0.col) * BLK * feat,
                          f0, feat, tid);
        }
      }
    }
    const float st = c0.s;
    if (QUAD) {
      // the next (slot, quadrant)
      if (++quad == nq) {
        quad = 0;
        c0 = c1;
        c1 = next < lo + nt ? slot(next) : none;
        ++next;
      }
      fetch(c0, quad);                          // lands during the apply
    } else {
      c0 = c1;
      fetch(c0, 0);                             // lands during the apply
      c1 = t + 2 < nt ? slot(lo + t + 2) : none;
    }
    if (!live) continue;
    cp_async_wait<0>();
    if (ROUND_X) round_slab<VEC>(xs, tid);      // before the barrier
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
          const float4 v =
              *reinterpret_cast<const float4*>(as + swizzled(j, 4 * q));
          // the four values first, so that their work overlaps
          const float w[4] = {val.value(hs, v.x, 4 * qd + 0, m, row0, lane),
                              val.value(hs, v.y, 4 * qd + 1, m, row0, lane),
                              val.value(hs, v.z, 4 * qd + 2, m, row0, lane),
                              val.value(hs, v.w, 4 * qd + 3, m, row0, lane)};
          apply(v.x, [&] { return w[0]; }, m, st, xa, lane, acc[4 * qd + 0]);
          apply(v.y, [&] { return w[1]; }, m, st, xa, lane, acc[4 * qd + 1]);
          apply(v.z, [&] { return w[2]; }, m, st, xa, lane, acc[4 * qd + 2]);
          apply(v.w, [&] { return w[3]; }, m, st, xa, lane, acc[4 * qd + 3]);
        }
      }
    } else {
      // output row i takes tile row i: entries j = lane + 32m
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          // the value only where the ballot found a non-zero
          const float e = as[swizzled(row0 + i, lane + 32 * m)];
          apply(e, [&] { return val.value(hs, e, i, m, row0, lane); }, m,
                1.f, xa, lane, acc[i]);
        }
      }
    }
  }
  if (DIAG) cp_async_wait<0>();                 // a block without a non-zero
  store_rows(acc, out, ob, f0, row0, lane, feat);
  val.finish(ob, f0, row0, lane);
}

// Launches the walk on the flat grid of num_row_blocks * quads *
// ceil(feat / FT) CTAs (SMEM bytes of dynamic shared memory each, and the
// hook's V::SMEM floats), from init under INIT, else from zero (init
// unused); under DIAG over the diagonal blocks (the index arrays unused);
// nothing when either count is 0.  quads: the tiles' edge over 128
// (num_row_blocks counts tile rows of that edge); above 1 the quadrant
// walk, which only a launch with QUAD builds (K1, K2, K9, K8, K4, K4T,
// K7f and K7bt's dx).  words: the slots' occupancy words (under TRANS the
// transposed words of their tiles), or null; given, the walk of the live
// quadrants (SMEM_WORDS bytes and the hook's V::SMEM_LIVE floats), which
// only a launch with WORDS builds (K1, K2, K9, K4 and K4T under Plain, K7f
// under FwdScores, K7bt's dx under DxScores; outside DIAG).
// Returns cudaErrorInvalidValue for quads < 1, or > 1 without QUAD, and
// for words without WORDS or with quads outside 2 .. MAX_WORD_QUADS,
// cudaErrorInvalidConfiguration when the grid would exceed 2^31 - 1 CTAs,
// else cudaGetLastError() after the launch.  The vector slab copy is
// chosen on x's alignment; the kernel chooses the vector init load on
// init's own.  val is the value hook (Plain: the entries as they are); T,
// the tile type, comes from blocks, which must start on a 16-byte
// boundary; ROUND_X (bf16 tiles only) rounds x to bf16.  A, the
// activations' type, names x, init and out: under bf16 (the forms
// walk_kernel lists) the vector slab copy needs feat % 8 == 0.
// bytes of dynamic shared memory of the walk of the live quadrants: the
// tile, two slabs and the hook's SMEM_LIVE floats (0 without WORDS: never
// launched)
template <class V, bool WORDS>
constexpr int words_smem() {
  if constexpr (WORDS) {
    constexpr int bytes = SMEM_WORDS
                          + V::SMEM_LIVE * static_cast<int>(sizeof(float));
    static_assert(bytes <= 232448, "over a block's shared memory");
    return bytes;
  } else {
    return 0;
  }
}

// the type A itself, in a context that deduces nothing (so a null init
// converts to const A* for the A a launch names, float by default)
template <class A>
struct Same {
  using type = A;
};

template <bool TRANS, bool INIT, bool DIAG = false, bool ROUND_X = false,
          bool QUAD = false, class T = float, class V = Plain,
          bool WORDS = false, class A = float>
cudaError_t launch(const T* blocks, const int32_t* row_splits,
                   const int32_t* sel, const int32_t* scale,
                   const int32_t* cols, const typename Same<A>::type* x,
                   const typename Same<A>::type* init,
                   typename Same<A>::type* out, int64_t num_row_blocks,
                   int64_t feat,
                   cudaStream_t stream, V val = V{}, int quads = 1,
                   const uint64_t* words = nullptr) {
  static_assert(std::is_same<T, float>::value
                || std::is_same<T, __nv_bfloat16>::value,
                "tiles are f32 or bf16");
  static_assert(!ROUND_X || std::is_same<T, __nv_bfloat16>::value,
                "x is rounded to bf16 for bf16 tiles only");
  if (quads < 1 || (quads > 1 && !QUAD)) return cudaErrorInvalidValue;
  const bool with_words = words != nullptr;
  if (with_words && (!WORDS || quads < 2 || quads > MAX_WORD_QUADS)) {
    return cudaErrorInvalidValue;
  }
  if (num_row_blocks > 0 && feat > 0) {
    const int64_t slices = (feat + FT - 1) / FT;
    const int64_t ctas = num_row_blocks * quads * slices;
    if (ctas > 0x7fffffff) return cudaErrorInvalidConfiguration;
    constexpr bool NARROW = !std::is_same<A, float>::value;
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && feat % (NARROW ? 8 : 4) == 0;
    const auto kernel =
        with_words
            ? (vec ? walk_kernel<TRANS, INIT, true, DIAG, V, T, ROUND_X,
                                 WORDS, QUAD, A>
                   : walk_kernel<TRANS, INIT, false, DIAG, V, T, ROUND_X,
                                 WORDS, QUAD, A>)
        : quads > 1
            ? (vec ? walk_kernel<TRANS, INIT, true, DIAG, V, T, ROUND_X,
                                 false, QUAD, A>
                   : walk_kernel<TRANS, INIT, false, DIAG, V, T, ROUND_X,
                                 false, QUAD, A>)
            : (vec ? walk_kernel<TRANS, INIT, true, DIAG, V, T, ROUND_X,
                                 false, false, A>
                   : walk_kernel<TRANS, INIT, false, DIAG, V, T, ROUND_X,
                                 false, false, A>);
    const int bytes = with_words ? words_smem<V, WORDS>()
                                 : SMEM + V::SMEM * static_cast<int>(
                                       sizeof(float));
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    kernel<<<static_cast<unsigned>(ctas), THREADS, bytes, stream>>>(
        blocks, row_splits, sel, scale, cols, words, x, init, out, feat,
        slices, val, quads);
  }
  return cudaGetLastError();
}

}  // namespace sparse
