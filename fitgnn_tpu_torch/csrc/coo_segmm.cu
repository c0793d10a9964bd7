// K3, K3w and K6: the straggler segmented sum with the gather fused,
// out[r] = sum_{e in row r} w_e . x[s_e], and for K6 also den[r] = sum w_e.
//
// Replaces the TPU kernels fitgnn_tpu/ops/pallas/coo_segmm.py:_kernel (grid
// built by _segmm_scatter; entries segmm_spmm and, with runtime weights,
// segmm_weighted_spmm and its dx) and :_kernel_den (_segmm_scatter_den,
// entry segmm_weighted_spmm_den).  On the TPU the gather y = x[senders]
// runs in XLA and streams an (E_pad, F) array into a kernel that multiplies
// a one-hot selector by each 128-edge chunk on the MXU; the runtime weights
// are formed in XLA before it (_dyn_aux: w_edge . static weight) and den is
// the selector's row sums.  Here the edges arrive as a receiver CSR
// (row_ptr over the receiver-sorted straggler list) and the kernel gathers
// x's rows itself: no (E_pad, F) stream, no chunk padding, no filler
// chunks.  The first_slot edge-0 hazard (coo_segmm.py:164-169) belongs to
// the TPU's padded slot stream; this layout has no slots.
//
// Bound on an H100: bytes in principle (each edge gathers F floats of a
// random sender row, each output row is written once, a few FLOPs a byte),
// latency in practice.  The straggler list is short and scattered (on the
// bench graph 1.37 edges a row, 30% of the rows empty), so a design that
// gives each row its own chain of dependent loads (row pointers, then
// sender and weight, then the gather) spends its time waiting, and at
// F <= 64 a 32-lane warp with 4 floats a lane leaves most lanes idle.  So:
//
// * A CTA (THREADS threads) owns a run of consecutive rows.  It loads their
//   row pointers into shared memory, then their edges' senders and weights,
//   both with coalesced loads, in windows of WINDOW edges: a hub row of any
//   length is walked window by window.  After that every gather address of
//   the window is known at once.
// * A row is served by a group of L lanes, 4*V floats a lane (two 16-byte
//   loads an edge): L is 8, 16 or 32, the smallest that covers F, so a warp
//   serves 32 / L rows (4 at F <= 64).  Above 4*V*32 columns the groups
//   take chunks of that width of the same rows and share the staged edges.
//   A group walks a contiguous run of ROWS rows as one edge sequence: it
//   issues the gathers of U edges before it applies them, so U*V 16-byte
//   loads are in flight a lane across row boundaries, and it writes each
//   row (zeros for an empty one, with the same 16-byte stores) as the walk
//   passes the row's end.
// * The runtime weights are formed while the edges are staged: K3w and K6
//   pass GAT's w_edge (on the transpose CSR with perm, the forward position
//   of each transpose entry), and the staged weight is
//   w_edge[perm[e]] * weights[e], the one f32 product the plain version
//   forms; no elementwise pass runs before the kernel.
//
// The loads in flight decide the speed.  The constants below beat their
// measured neighbours in scripts/torch_design_variants.py (PERF.md: 4
// floats a lane, 256 threads, U = 1 or 2, the edges read unstaged, 8 rows
// a group; 2 rows a group speed up K3w's forward but slow K6 and the
// transpose form more).  What is left is the gather itself: at F=512 the
// variants that keep enough loads in flight land within 2% of each other,
// about two thirds of the bytes bound, which counts each distinct sender
// row once where the walk reads one an edge.
//
// Order and numbers.  Each output element is the f32 fmaf chain over its
// row's edges in edge order; K6's den is the
// f32 sum of the row's weights in edge order, written once by the group's
// first lane (chunk 0): no atomics, so two launches are bit-equal.  F % 4
// != 0, or an x or out off a 16-byte boundary, takes 4-byte loads and
// stores (VEC = false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 128;     // 4 warps a CTA
constexpr int WINDOW = 1024;     // edges staged at a time
constexpr int ROWS = 4;          // rows a lane group walks
constexpr int U = 4;             // gathers in flight a lane
constexpr int V = 2;             // float4 columns a lane
// rows a CTA at most: THREADS / 8 groups of ROWS rows
constexpr int MAX_ROWS = THREADS / 8 * ROWS;

// A launch's shape for F columns: lanes a row group, column chunks a row,
// row runs a CTA (groups / chunks, at least 1), rows a CTA.
struct Shape {
  int lanes, chunks, splits, rows;
};

Shape shape_for(int64_t feat) {
  const int64_t need = (feat + 4 * V - 1) / (4 * V);
  Shape s;
  s.lanes = need <= 8 ? 8 : need <= 16 ? 16 : 32;
  const int64_t width = 4 * V * s.lanes;
  s.chunks = static_cast<int>((feat + width - 1) / width);
  s.splits = s.chunks >= THREADS / s.lanes ? 1
                                           : THREADS / s.lanes / s.chunks;
  s.rows = s.splits * ROWS;
  return s;
}

__device__ __forceinline__ float edge_weight(const float* weights,
                                             const float* w_edge,
                                             const int32_t* perm, int e) {
  const float w = weights[e];
  if (w_edge == nullptr) return w;
  return w_edge[perm != nullptr ? perm[e] : e] * w;
}

// 4 floats of row p from column c (c < feat); the scalar form reads only
// the columns below feat
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int64_t c,
                                        int64_t feat) {
  if (VEC) return *reinterpret_cast<const float4*>(p + c);
  float4 v = make_float4(p[c], 0.f, 0.f, 0.f);
  if (c + 1 < feat) v.y = p[c + 1];
  if (c + 2 < feat) v.z = p[c + 2];
  if (c + 3 < feat) v.w = p[c + 3];
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int64_t c, int64_t feat,
                                       float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + c) = v;
    return;
  }
  p[c] = v.x;
  if (c + 1 < feat) p[c + 1] = v.y;
  if (c + 2 < feat) p[c + 2] = v.z;
  if (c + 3 < feat) p[c + 3] = v.w;
}

// bf16 activations (A = __nv_bfloat16): 8 consecutive columns of row p
// from column c, widened to f32 (exact) as two float4; VEC one 16-byte
// load (feat % 8 == 0), else one load a column below feat
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int64_t c,
                                      int64_t feat, float4 (&g)[2]) {
  if (VEC) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + c);
    g[0] = make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
    g[1] = make_float4(__uint_as_float(u.z << 16),
                       __uint_as_float(u.z & 0xffff0000u),
                       __uint_as_float(u.w << 16),
                       __uint_as_float(u.w & 0xffff0000u));
    return;
  }
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = c + i < feat ? __bfloat162float(p[c + i]) : 0.f;
  }
  g[0] = make_float4(v[0], v[1], v[2], v[3]);
  g[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the 8 sums of load8's columns rounded to bf16 once (to nearest even)
template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int64_t c,
                                       int64_t feat, const float4 (&a)[2]) {
  const float v[8] = {a[0].x, a[0].y, a[0].z, a[0].w,
                      a[1].x, a[1].y, a[1].z, a[1].w};
  if (VEC) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p + c) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (c + i < feat) p[c + i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// A: the activations' type (x and out), float or __nv_bfloat16 (K3a: a
// lane's 4 V = 8 columns are consecutive, one 16-byte gather an edge, and
// each formed weight is rounded to bf16 before its products, as the
// Pallas kernels cast the selector; the sums stay f32 and den sums the
// unrounded weights)
template <bool DEN, int L, bool VEC, class A = float>
__global__ void __launch_bounds__(THREADS)
segmm_spmm_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ senders,
                  const float* __restrict__ weights,
                  const float* __restrict__ w_edge,
                  const int32_t* __restrict__ perm,
                  const A* __restrict__ x, A* __restrict__ out,
                  float* __restrict__ den, int64_t num_rows, int64_t feat,
                  int chunks, int splits) {
  constexpr bool NARROW = !std::is_same<A, float>::value;
  static_assert(!NARROW || V == 2, "a bf16 lane gathers 8 values");
  constexpr int G = THREADS / L;              // lane groups a CTA
  constexpr int WIDTH = 4 * V * L;            // columns a group
  __shared__ int s_rp[MAX_ROWS + 1];
  __shared__ int s_send[WINDOW];
  __shared__ float s_w[WINDOW];

  const int rows = splits * ROWS;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nr = num_rows - r0 < rows ? static_cast<int>(num_rows - r0)
                                      : rows;
  for (int i = threadIdx.x; i <= nr; i += THREADS) s_rp[i] = row_ptr[r0 + i];
  __syncthreads();
  const int lo = s_rp[0];
  const int hi = s_rp[nr];
  const int nwin = max(1, (hi - lo + WINDOW - 1) / WINDOW);
  const int grp = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int units = splits * chunks;          // (row run, chunk) pairs

  // rounds of units: more than one only when a row has more chunks than
  // the CTA has groups; the loop is uniform across the CTA (it syncs)
  for (int base = 0; base < units; base += G) {
    const int u = base + grp;
    const bool active = u < units;
    const int c = active ? u % chunks : 0;
    int k = active ? (u / chunks) * nr / splits : 0;   // the current row
    const int kend = active ? (u / chunks + 1) * nr / splits : 0;
    const int ga = s_rp[k];
    const int gb = s_rp[kend];
    int64_t col[V];
    if constexpr (NARROW) {
#pragma unroll
      for (int v = 0; v < V; ++v) col[v] = c * WIDTH + lane * 8 + 4 * v;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) col[v] = c * WIDTH + v * 4 * L + lane * 4;
    }
    float4 acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    float wsum = 0.f;

    // writes row k (zeros if it had no edge) and moves to the next
    auto flush = [&]() {
      const int64_t r = r0 + k;
      A* o = out + r * feat;
      if constexpr (NARROW) {
        if (col[0] < feat) store8<VEC>(o, col[0], feat, acc);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (col[v] < feat) store4<VEC>(o, col[v], feat, acc[v]);
          acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (DEN && c == 0 && lane == 0) den[r] = wsum;
      wsum = 0.f;
      ++k;
    };

    for (int win = 0; win < nwin; ++win) {
      const int wb = lo + win * WINDOW;
      const int we = min(hi, wb + WINDOW);
      if (nwin > 1 || base == 0) {
        __syncthreads();                      // the last window is read
        for (int i = threadIdx.x; i < we - wb; i += THREADS) {
          s_send[i] = senders[wb + i];
          s_w[i] = edge_weight(weights, w_edge, perm, wb + i);
        }
        __syncthreads();
      }
      const int ee = min(gb, we);
      for (int e = max(ga, wb); e < ee; e += U) {
        const int left = ee - e;
        int s[U];
        float w[U];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          s[j] = j < left ? s_send[e + j - wb] : 0;
          w[j] = j < left ? s_w[e + j - wb] : 0.f;
        }
        float4 g[U][V];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const A* xr = x + static_cast<int64_t>(s[j]) * feat;
          if constexpr (NARROW) {
            if (j < left && col[0] < feat) {
              load8<VEC>(xr, col[0], feat, g[j]);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                g[j][v] = make_float4(0.f, 0.f, 0.f, 0.f);
              }
            }
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              g[j][v] = j < left && col[v] < feat
                            ? load4<VEC>(xr, col[v], feat)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (j < left) {
            while (e + j >= s_rp[k + 1]) flush();
            // the weight of the products: rounded to bf16 under NARROW
            const float wp =
                NARROW ? __bfloat162float(__float2bfloat16_rn(w[j])) : w[j];
#pragma unroll
            for (int v = 0; v < V; ++v) fma4(acc[v], wp, g[j][v]);
            if (DEN) wsum += w[j];
          }
        }
      }
    }
    while (k < kend) flush();
  }
}

template <bool DEN, int L, class X, typename... A>
void launch_lanes(bool vec, unsigned grid, cudaStream_t st, A... a) {
  if (vec) {
    segmm_spmm_kernel<DEN, L, true, X><<<grid, THREADS, 0, st>>>(a...);
  } else {
    segmm_spmm_kernel<DEN, L, false, X><<<grid, THREADS, 0, st>>>(a...);
  }
}

template <bool DEN, class X, typename... A>
void launch_den(int lanes, A... a) {
  if (lanes == 8) {
    launch_lanes<DEN, 8, X>(a...);
  } else if (lanes == 16) {
    launch_lanes<DEN, 16, X>(a...);
  } else {
    launch_lanes<DEN, 32, X>(a...);
  }
}

// the launch over x, out of type X (float, or __nv_bfloat16 for K3a)
template <class X>
int launch_segmm(const void* row_ptr, const void* senders,
                 const void* weights, const void* w_edge, const void* perm,
                 const void* x, void* out, void* den, int64_t num_rows,
                 int64_t feat, void* stream) {
  if (num_rows > 0 && feat > 0) {
    const Shape sh = shape_for(feat);
    constexpr int64_t PIECE = std::is_same<X, float>::value ? 4 : 8;
    const bool vec = feat % PIECE == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const auto grid = static_cast<unsigned>((num_rows + sh.rows - 1) /
                                            sh.rows);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int32_t*>(row_ptr);
    const auto* sp = static_cast<const int32_t*>(senders);
    const auto* wp = static_cast<const float*>(weights);
    const auto* ep = static_cast<const float*>(w_edge);
    const auto* pp = static_cast<const int32_t*>(perm);
    const auto* xp = static_cast<const X*>(x);
    auto* op = static_cast<X*>(out);
    auto* dp = static_cast<float*>(den);
    if (den != nullptr) {
      launch_den<true, X>(sh.lanes, vec, grid, st, rp, sp, wp, ep, pp, xp,
                          op, dp, num_rows, feat, sh.chunks, sh.splits);
    } else {
      launch_den<false, X>(sh.lanes, vec, grid, st, rp, sp, wp, ep, pp, xp,
                           op, dp, num_rows, feat, sh.chunks, sh.splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_ptr (num_rows+1,) int32; senders, weights (E,) int32 / f32 in
// receiver order; w_edge (E,) f32 or null (the weights as they are); perm
// (E,) int32 or null (w_edge in this CSR's edge order), else the weight of
// edge e is w_edge[perm[e]] * weights[e]; x (*, feat) f32; out (num_rows,
// feat) f32; den (num_rows,) f32 or null (K6: each row's weight sum);
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int fitgnn_segmm_spmm(const void* row_ptr, const void* senders,
                                 const void* weights, const void* w_edge,
                                 const void* perm, const void* x, void* out,
                                 void* den, int64_t num_rows, int64_t feat,
                                 void* stream) {
  return launch_segmm<float>(row_ptr, senders, weights, w_edge, perm, x, out,
                             den, num_rows, feat, stream);
}

// K3a: the same on bf16 activations, x (*, feat) and out (num_rows, feat)
// bf16, the bf16 branch of _kernel and _kernel_den
// (fitgnn_tpu/ops/pallas/coo_segmm.py:187-205, 236-260; pallas_call :218,
// :272): each formed weight (weights[e], or w_edge[perm[e]] * weights[e])
// is rounded to bf16 before its products, as the selector is cast there;
// the products of two bf16 are exact in f32, the sums f32 fmaf chains in
// edge order, each rounded to bf16 once as it is stored (there each
// chunk's product is rounded into the bf16 output block); den (K6) stays
// f32 and sums the unrounded weights (:253-254).  16-byte gathers of 8
// values where feat % 8 == 0 and x and out start on 16-byte boundaries,
// else one load a column.  Bound on an H100: as K3's, at 2 bytes a value.
extern "C" int fitgnn_segmm_spmm_a(const void* row_ptr, const void* senders,
                                   const void* weights, const void* w_edge,
                                   const void* perm, const void* x, void* out,
                                   void* den, int64_t num_rows, int64_t feat,
                                   void* stream) {
  return launch_segmm<__nv_bfloat16>(row_ptr, senders, weights, w_edge, perm,
                                     x, out, den, num_rows, feat, stream);
}

// The launch shape for feat columns, into cfg[0..3]: lanes a row, floats a
// lane, gathers in flight a lane, rows a CTA.  Returns 0.
extern "C" int fitgnn_segmm_shape(int64_t feat, int32_t* cfg) {
  const Shape sh = shape_for(feat);
  cfg[0] = sh.lanes;
  cfg[1] = 4 * V;
  cfg[2] = U;
  cfg[3] = sh.rows;
  return 0;
}
