// The span structures build for Hopper (sm_90a): the principal frame, the
// records and the windows of one step.
//
// Not a port of a TPU kernel.  The JAX package builds the span structures
// as plain jnp, which XLA fuses into one program
// (wembed_tpu/kernels/span_sparse.py:917 build_span_structures, its
// projections from wembed_tpu/core/candidates.py:409 _power_iteration and
// :429 _principal_axes2).  The port's plain versions are in
// kernels/span_build.py (principal_frame_reference,
// principal_axes_reference, span_records_reference,
// span_windows_reference), and every operation here repeats one of their
// torch operations, in their order and rounding: each multiply, add,
// division and sqrt rounded alone (--fmad=false, IEEE division and sqrt),
// so each kernel is bitwise its plain version.
//
// The principal frame at d <= 8 (f32, f64), three grid-wide launches, from
// the positions to the first K = 2 (windows) or 3 (cells) axes and the
// projections on them:
//   frame_mean_kernel<T, D>     each CTA sums its aligned chunk of 1,024
//       rows as a pairwise tree (a thread's four rows, then xor shuffles
//       1, 2, ..., 16 across the warp, then the eight warps in shared
//       memory) and writes its partial; the last CTA to finish (a device
//       counter it resets for the next launch or graph replay) carries on
//       the same tree over the partials and divides by n.  Rows past n
//       count as -0.0, the additive identity, so the tree is the plain
//       version's over any power-of-two length;
//   frame_axes_kernel<T, D>     the same tree over each product c_i * c_k
//       (i <= k) of the centred rows c = p - mean, each rounded alone; the
//       last CTA folds the partials into the covariance and runs the power
//       iteration, deflation and re-orthogonalisation of
//       principal_axes_reference in ONE warp's registers: lane i holds row
//       i of the (deflated) covariance and component i of the iterate, the
//       other components come by shuffles, and every norm and dot product
//       is each lane's own left fold of the same shuffled values (no
//       barrier, no shared scalar);
//   frame_project_kernel<T, D>  a thread a row: proj[a][v] = c_v . axis_a,
//       folded in k order.
// Bound on an H100 by latency, not bytes: the positions are read three
// times (~0.8 MB at girg100k d=2, from L2), the projections written once;
// what costs is the three launches' dependency chain and the last CTA's
// 12 power steps an axis (a few shuffles and one division each).
//
// principal_axes_kernel<T, K> (K = 2, or 3 for the cell layout), ONE CTA,
// the general route's (d > 8): the first K principal axes of a (d, d)
// covariance by power iteration, 12 steps an axis from the perturbed
// all-ones start
//   v[i] = 1 + i * 1e-3,  v = v / |v|,
//   w[i] = c(i,0)*v[0] + c(i,1)*v[1] + ...   (k ascending, a left fold)
//   |w| = sqrt(w[0]*w[0] + w[1]*w[1] + ...)  (k ascending)
//   v = |w| > 0 ? w / |w| : v,
// on cov, then on cov1 = cov - lam1 * (v1 v1^T) and, for K = 3, on cov2 =
// cov1 - lam2 * (v2 v2^T), with lam = v . (c v) folded in k order; each
// later axis re-orthogonalised (v2 - (v2.v1) v1, then v3 - (v3.v1) v1 -
// (v3.v2) v2) and normalised where its norm is above 1e-12.  The deflated
// matrices are never stored: each element is recomputed from cov with the
// same operations.  A thread a row of the product; the norms and dot
// products are one thread's k-ordered fold (the axes and one row live in
// shared memory, opted in past 48 KB, so d reaches ~7,000 in f64).
//
// span_records_kernel<T, D> (D = 1 ... 8, 0 for any d): a CTA a section's
// 256 slots, the sections split by CTA (query slots, member slots, sorted
// ranks), each slot gathered through the step's permutation `order`
// (sorted rank -> vertex) from the position and ONE packed vertex row
// vrec[v] = [iw, lw * lw, 1 / iw, colour bits, bm2, lw, 0, 0], made once a
// weights tensor (kernels/span_build.py:vertex_records; 32 bytes in f32,
// so a gather is one sector):
//   query slot q  (NQ = NB * 256)  r = src_of_q[q]:
//       qrec[q] = [pos[v], iw, lw * lw, 1 / iw], qcol[q] = colour, with v =
//       order[r], or the query sentinel [+1e15 ..., 1, 0, 0], -2 where r =
//       n (padding);
//   member slot p (NPA)            r = src_of_pad[p]:
//       srec[p] = [pos[v], iw, bm2, 1 / iw], scol[p] = colour (a vertex
//       outside a partial index: position -1e15, bm2 0), or the member
//       sentinel [-1e15 ..., 1, 0, 0], -3;
//   sorted rank j (n)              v = order[j]:
//       the inverse maps inv[v] = [j - sorted_moff[j], (j + shift_q[j]) /
//       256, j + shift_q[j], row_of_sorted[j]] (rank in its row, query
//       block, query slot, row; two 16-byte stores) and the sorted values
//       x[v], y[v], lw[v] that the windows read.
// A slot CTA stages its 256 rows of d + 3 values in shared memory and
// writes them as 16-byte vectors (the general instance, d > 8, writes each
// row itself).  The slot maps are int32.  Every output is a copy.
//
// span_windows_kernel<T>: one CTA a query block b, every thread at work.
// First every load that no search waits on: the block's 256 slots (its
// radius factors and first-axis values), its second-axis extrema minx and
// maxx at the static ranks blk_first[b] and blk_last[b], and a target row
// a thread (its tables, its first-axis extrema at static ranks of the
// first sort, its first and last sorted second-axis values), so no chain
// before the searches is more than three loads deep.  The block's maxlw
// and first-axis ymin / ymax (padding counts 0, and is left out of ymin /
// ymax) by xor shuffles and one shared-memory step.  Then each thread's
// row: reach = maxlw * bmax[r] and the overlap of the first-axis ranges,
// and the window's two bounds over the row's own segment of the sorted
// second-axis values, as the JAX package searches it: start, the values
// x < minx - reach, and stop, the values x <= maxx + reach.  Both tests
// are monotone along a row sorted ascending with NaN last, so any search
// that finds where a test flips gives the plain version's bound.  Most
// bounds settle from the row's ends: a first value that does not go
// before the bound gives 0, a last value that does the row's size.  The
// windows with a bound left are listed by ballot and shared by the warps,
// four windows a warp: a group of 4 lanes finds a start, the next group
// its stop, in 4-ary rounds, a ballot of 4 pivots each, ending where the
// test flips.  Then each window's start tile, the members it needs and
// its overflow, in int64, written by its row's thread; the block's
// overflow by shuffles, one integer atomic into a device sum and a CTA
// count taken with release and acquire order, so the last CTA to finish
// sees the total, writes it and sets both back to 0 for the next launch
// or graph replay: integers, so the total is exact in any order, as is
// every output (the float values reach the integers through comparisons
// only, which the order of the max / min cannot change).

// What bounds the records and windows on an H100: bytes.  Read once, the
// positions, the vertex rows, the projections and the permutations;
// written once, the records (NQ + NPA rows of d + 3 values), the colours,
// the inverse maps (4 x 8 bytes a vertex), the sorted values and the
// (NB, R) window tables.  The records kernel gathers a vertex's rows
// through `order` (random rows, from L2).  The windows kernel is latency
// and L2 sectors: its chains of dependent loads (three before the
// searches, then a round of each search, ceil(log4(row + 1)) at most),
// its barriers and the finish's ordered atomic, and a 32-byte sector for each
// pivot of a round, which is why the bounds that settle from the row's
// ends are not searched and a bound takes 4 lanes, not 16.
//
// The device counters make two launches of one kernel on two streams at
// once unsafe; the port builds on one stream.

#include <cuda_runtime.h>

#include <cuda/atomic>

#include <cmath>
#include <cstdint>

namespace wembed_build {

constexpr int kThreads = 256;  // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 256;        // query slots a block (kernels/span_sweep.py Q)
constexpr int kST = 256;       // members a tile (kernels/span_sweep.py ST)
constexpr int kMaxFastDim = 8; // the frame's and the records' widest templated row
constexpr int kMaxAxes = 3;
constexpr int kFrameRows = 4;                       // rows a thread of the frame's sums
constexpr int kFrameChunk = kThreads * kFrameRows;  // rows a CTA sums (kernels/span_build.py FRAME_CHUNK)
constexpr int kVrecWidth = 8;                       // values a vertex row (VREC_WIDTH)
constexpr unsigned kFull = 0xffffffffu;
constexpr double kQSentinel = 1e15;   // padded query position (kernels/span_build.py _Q_SENTINEL)
constexpr double kSSentinel = -1e15;  // padded member position (_S_SENTINEL)
static_assert(kWarps == 8, "warps_tree adds eight warp sums");

// Mirrors kernels/span_build.py:_FrameArgs; every field is 8 bytes.
struct FrameArgs {
  const void* pos;  // (n, d) T
  void* mean;       // (d,) T
  void* part;       // (ctas, d (d + 1) / 2) T: each CTA's sums, then the whole tree's
  void* axes;       // (k, d) T
  void* proj;       // (k, n) T
  int64_t n, d;
  int64_t k;        // axes: 2 or 3
  int64_t iters;    // power iterations an axis
  int64_t ctas;     // ceil(n / kFrameChunk)
};

// Mirrors kernels/span_build.py:_AxesArgs; every field is 8 bytes.
struct AxesArgs {
  const void* cov;  // (d, d) T, row-major
  void* out;        // (K, d) T
  int64_t d;
  int64_t k;        // axes: 2 or 3
  int64_t iters;    // power iterations an axis
};

// Mirrors kernels/span_build.py:_RecordsArgs; every field is 8 bytes.
struct RecordsArgs {
  const int64_t* order;          // (n,) sorted rank -> vertex
  const void* pos;               // (n, d) T
  const void* vrec;              // (n, 8) T [iw, lw * lw, 1 / iw, colour bits, bm2, lw, 0, 0], 16-byte aligned
  const uint8_t* in_index;       // (n,) bool, or null for a whole index
  const void* x;                 // (n,) T second-axis projection (d = 1: the first)
  const void* y;                 // (n,) T first-axis projection
  const int32_t* src_of_q;       // (NQ,) query slot -> sorted rank, n = padding
  const int32_t* src_of_pad;     // (NPA,) member slot -> sorted rank, n = padding
  const int32_t* sorted_shift_q; // (n,) query offset less member offset of each rank's row
  const int32_t* sorted_moff;    // (n,) member offset of each rank's row
  const int32_t* row_of_sorted;  // (n,) row of each rank
  void* qrec;                    // (NQ, d + 3) T
  int32_t* qcol;                 // (NQ,)
  void* srec;                    // (NPA, d + 3) T
  int32_t* scol;                 // (NPA,)
  int64_t* inv;                  // (n, 4) rank in row, query block, query slot, row
  void* sorted;                  // (3, n) T  x, y and lw in sorted order
  int64_t n, d, nq, npa;
};

// Mirrors kernels/span_build.py:_WindowsArgs; every field is 8 bytes.
struct WindowsArgs {
  const void* sorted;      // (3, n) T  x, y and lw in sorted order
  const void* y;           // (n,) T first-axis projection, by vertex
  const int64_t* order1;   // (n,) the first sort's permutation
  const int32_t* src_of_q; // (NB * 256,) query slot -> sorted rank, n = padding
  const int64_t* blk_first;  // (NB,) first sorted rank of each block
  const int64_t* blk_last;   // (NB,) last sorted rank of each block
  const int64_t* row_lo;     // (R,) first sorted rank of each row
  const int64_t* row_hi;     // (R,) last sorted rank of each row
  const int64_t* row_tiles;  // (R,) tiles of each row
  const float* bmax_row;     // (R,) bmax^(1/d) of each row's group
  const int32_t* blk_t;      // (NB, R) window widths in tiles
  int32_t* start_tile;       // (NB, R) out
  int64_t* need;             // (NB, R) out
  int64_t* overflow;         // (1,) out
  int64_t n, nb, r, max_row;
};

// ---------------------------------------------------------- principal frame

// The pairwise tree across a warp, lane l's value the leaf l: xor 1 adds
// lanes 2i and 2i + 1, xor 2 those sums in pairs, ...; IEEE addition
// commutes, so every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) v = v + __shfl_xor_sync(kFull, v, m);
  return v;
}

// The tree over the eight warp sums w[0], w[stride], ..., w[7 stride].
template <typename T>
__device__ __forceinline__ T warps_tree(const T* w, int stride) {
  return ((w[0] + w[stride]) + (w[2 * stride] + w[3 * stride])) +
         ((w[4 * stride] + w[5 * stride]) + (w[6 * stride] + w[7 * stride]));
}

// A thread's four leaves 4t ... 4t + 3 as their subtree.
template <typename T>
__device__ __forceinline__ T tree4(const T (&l)[kFrameRows]) {
  return (l[0] + l[1]) + (l[2] + l[3]);
}

// Column k of the thread's rows first ... first + 3 of the (n, D)
// positions; -0.0 past n.
template <typename T, int D>
__device__ __forceinline__ void load_column(const T* pos, int64_t first, int64_t n, int k, T (&l)[kFrameRows]) {
#pragma unroll
  for (int j = 0; j < kFrameRows; ++j) l[j] = first + j < n ? pos[(first + j) * D + k] : static_cast<T>(-0.0);
}

// Stores the CTA's E sums (a warp's lane 0 put each warp's into `wpart`,
// (kWarps, E)) into its row of `part`, fenced; then whether this CTA is
// the last of the grid to do so (`done` counts them; the last sets it back
// to 0 once it has finished).
template <typename T, int E>
__device__ __forceinline__ bool store_partial(T* part, const T* wpart, unsigned int* done, bool* s_last) {
  __syncthreads();
  if (threadIdx.x < E) {
    part[static_cast<int64_t>(blockIdx.x) * E + threadIdx.x] = warps_tree(wpart + threadIdx.x, E);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// The last CTA carries the tree on over the `count` rows of CTA partials
// in part (E sums a row, rows past `count` -0.0): each round cuts them into
// aligned chunks of kFrameChunk rows, sums each chunk as a CTA sums its
// rows and writes chunk c's sums into row c, until one row is left (one
// round up to 1,024 CTAs, i.e. ~1M rows).  Chunk c reads its rows before
// its first barrier and writes row c after it, and row c < 1,024 c belongs
// to a chunk already read, so the rounds run in place.  Reads bypass L1
// (other CTAs wrote the rows).
template <typename T, int E>
__device__ __forceinline__ void finish_partials(T* part, int64_t count, T* wpart) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  while (count > 1) {
    const int64_t chunks = (count + kFrameChunk - 1) / kFrameChunk;
    for (int64_t c = 0; c < chunks; ++c) {
      const int64_t first = c * kFrameChunk + threadIdx.x * kFrameRows;
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        T l[kFrameRows];
#pragma unroll
        for (int j = 0; j < kFrameRows; ++j) {
          l[j] = first + j < count ? __ldcg(part + (first + j) * E + e) : static_cast<T>(-0.0);
        }
        const T v = warp_tree(tree4(l));
        if (lane == 0) wpart[warp * E + e] = v;
      }
      __syncthreads();
      if (threadIdx.x < E) part[c * E + threadIdx.x] = warps_tree(wpart + threadIdx.x, E);
      __syncthreads();
    }
    count = chunks;
  }
}

// CTAs of frame_mean_kernel ([0]) and frame_axes_kernel ([1]) that have
// finished this launch.
__device__ unsigned int g_frame_ctas_done[2];

// One CTA an SM is enough (kFrameChunk rows a CTA): the bounds leave
// ptxas every register it wants, so no instantiation spills.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) frame_mean_kernel(const FrameArgs a) {
  __shared__ T wpart[kWarps * D];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = a.n;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kFrameChunk + threadIdx.x * kFrameRows;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    T l[kFrameRows];
    load_column<T, D>(static_cast<const T*>(a.pos), first, n, k, l);
    const T v = warp_tree(tree4(l));
    if (lane == 0) wpart[warp * D + k] = v;
  }
  T* part = static_cast<T*>(a.part);
  if (!store_partial<T, D>(part, wpart, &g_frame_ctas_done[0], &s_last)) return;
  finish_partials<T, D>(part, gridDim.x, wpart);
  if (threadIdx.x < D) static_cast<T*>(a.mean)[threadIdx.x] = __ldcg(part + threadIdx.x) / static_cast<T>(n);
  if (threadIdx.x == 0) g_frame_ctas_done[0] = 0;
}

// a[0] * b[0] + a[1] * b[1] + ... over lanes 0 .. D-1 (lane k holds a[k],
// b[k]), folded in k order; every lane computes the same fold.
template <typename T, int D>
__device__ __forceinline__ T lane_dot(T a, T b) {
  T s = __shfl_sync(kFull, a, 0) * __shfl_sync(kFull, b, 0);
#pragma unroll
  for (int k = 1; k < D; ++k) s = s + __shfl_sync(kFull, a, k) * __shfl_sync(kFull, b, k);
  return s;
}

// w[0] * w[0] + w[1] * w[1] + ... over lanes 0 .. D-1, folded in k order
// (``lane_dot(w, w)``, each value shuffled once).
template <typename T, int D>
__device__ __forceinline__ T lane_norm2(T w) {
  T wk = __shfl_sync(kFull, w, 0);
  T s = wk * wk;
#pragma unroll
  for (int k = 1; k < D; ++k) {
    wk = __shfl_sync(kFull, w, k);
    s = s + wk * wk;
  }
  return s;
}

// Row i of c v (lane i holds row i of c and v[i]), folded in k order.
template <typename T, int D>
__device__ __forceinline__ T lane_matvec(const T (&crow)[D], T v) {
  T s = crow[0] * __shfl_sync(kFull, v, 0);
#pragma unroll
  for (int k = 1; k < D; ++k) s = s + crow[k] * __shfl_sync(kFull, v, k);
  return s;
}

// The dominant eigenvector of the (deflated) covariance whose row i lane i
// holds: principal_axes_reference's _power_iteration, component i a lane.
template <typename T, int D>
__device__ __forceinline__ T warp_power_iteration(const T (&crow)[D], int i, int64_t iters) {
  T v = T(1) + static_cast<T>(i) * static_cast<T>(1e-3);
  v = v / sqrt(lane_norm2<T, D>(v));
  for (int64_t it = 0; it < iters; ++it) {
    const T w = lane_matvec<T, D>(crow, v);
    const T norm = sqrt(lane_norm2<T, D>(w));
    v = norm > T(0) ? w / (norm > T(0) ? norm : T(1)) : v;
  }
  return v;
}

// The K axes from the covariance's upper triangle `upper` (row r, column
// q >= r at r D - r (r - 1) / 2 + q - r), by ONE warp: lane i < D holds
// row i of the covariance, deflated in place after each axis as the plain
// version forms cov - lam * outer(v, v), and component i of each axis.
template <typename T, int D>
__device__ __forceinline__ void warp_axes(const T* upper, const FrameArgs& a) {
  const int lane = threadIdx.x & 31;
  const int i = lane < D ? lane : 0;  // lanes past d shadow row 0; no lane reads their values
  T crow[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int r = i < k ? i : k, q = i < k ? k : i;
    crow[k] = __ldcg(upper + r * D - r * (r - 1) / 2 + (q - r));
  }
  T ax[kMaxAxes];
  T* axes = static_cast<T*>(a.axes);
#pragma unroll
  for (int level = 0; level < kMaxAxes; ++level) {
    if (level >= a.k) break;
    if (level > 0) {  // deflate by the axis before: lam = v . (c v), c - lam * (v_i v_k)
      const T prev = ax[level - 1];
      const T lam = lane_dot<T, D>(prev, lane_matvec<T, D>(crow, prev));
#pragma unroll
      for (int k = 0; k < D; ++k) crow[k] = crow[k] - lam * (prev * __shfl_sync(kFull, prev, k));
    }
    T v = warp_power_iteration<T, D>(crow, i, a.iters);
    if (level > 0) {
      // the dot products with the earlier axes come from the iterate before
      // any is taken off: (v - (v.v1) v1) - (v.v2) v2
      T dots[kMaxAxes];
#pragma unroll
      for (int b = 0; b < kMaxAxes; ++b) {
        if (b < level) dots[b] = lane_dot<T, D>(v, ax[b]);
      }
#pragma unroll
      for (int b = 0; b < kMaxAxes; ++b) {
        if (b < level) v = v - dots[b] * ax[b];
      }
      const T norm = sqrt(lane_norm2<T, D>(v));
      if (norm > static_cast<T>(1e-12)) v = v / (norm > T(0) ? norm : T(1));
    }
    ax[level] = v;
    if (lane < D) axes[level * D + lane] = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) frame_axes_kernel(const FrameArgs a) {
  constexpr int E = D * (D + 1) / 2;  // the upper triangle, row by row
  __shared__ T wpart[kWarps * E];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = a.n;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kFrameChunk + threadIdx.x * kFrameRows;
  const T* mean = static_cast<const T*>(a.mean);
  T c[D][kFrameRows];  // the centred rows, column by column
#pragma unroll
  for (int k = 0; k < D; ++k) {
    load_column<T, D>(static_cast<const T*>(a.pos), first, n, k, c[k]);
    const T m = mean[k];
#pragma unroll
    for (int j = 0; j < kFrameRows; ++j) c[k][j] = c[k][j] - m;
  }
  int e = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = i; k < D; ++k, ++e) {
      T l[kFrameRows];
#pragma unroll
      for (int j = 0; j < kFrameRows; ++j) l[j] = first + j < n ? c[i][j] * c[k][j] : static_cast<T>(-0.0);
      const T v = warp_tree(tree4(l));
      if (lane == 0) wpart[warp * E + e] = v;
    }
  }
  T* part = static_cast<T*>(a.part);
  if (!store_partial<T, E>(part, wpart, &g_frame_ctas_done[1], &s_last)) return;
  finish_partials<T, E>(part, gridDim.x, wpart);
  if (warp == 0) warp_axes<T, D>(part, a);
  if (threadIdx.x == 0) g_frame_ctas_done[1] = 0;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) frame_project_kernel(const FrameArgs a) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= a.n) return;
  const T* pos = static_cast<const T*>(a.pos) + v * D;
  const T* mean = static_cast<const T*>(a.mean);
  const T* axes = static_cast<const T*>(a.axes);
  T c[D];
#pragma unroll
  for (int k = 0; k < D; ++k) c[k] = pos[k] - mean[k];
#pragma unroll
  for (int b = 0; b < kMaxAxes; ++b) {
    if (b >= a.k) break;
    const T* u = axes + b * D;
    T s = c[0] * u[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = s + c[k] * u[k];
    static_cast<T*>(a.proj)[b * a.n + v] = s;
  }
}


// ----------------------------------------------------------- principal axes

// Element (i, k) of the covariance deflated `level` times: cov, then
// cov - lam1 * (v1[i] * v1[k]), then that - lam2 * (v2[i] * v2[k]), as
// torch forms cov - lam * torch.outer(v, v).
template <typename T>
__device__ __forceinline__ T deflated(const T* cov, const T* axes, const T* lam, int level, int64_t d,
                                      int64_t i, int64_t k) {
  T c = cov[i * d + k];
  for (int a = 0; a < level; ++a) {
    const T* v = axes + a * d;
    c = c - lam[a] * (v[i] * v[k]);
  }
  return c;
}

// a[0] * b[0] + a[1] * b[1] + ... folded in k order (one thread)
template <typename T>
__device__ __forceinline__ T dot_fold(const T* a, const T* b, int64_t d) {
  T s = a[0] * b[0];
  for (int64_t k = 1; k < d; ++k) s = s + a[k] * b[k];
  return s;
}

// w = c v for the covariance deflated `level` times: a thread a row i,
// each row folded in k order.
template <typename T>
__device__ void matvec(const T* cov, const T* axes, const T* lam, int level, int64_t d, const T* v, T* w) {
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
    T s = deflated(cov, axes, lam, level, d, i, 0) * v[0];
    for (int64_t k = 1; k < d; ++k) s = s + deflated(cov, axes, lam, level, d, i, k) * v[k];
    w[i] = s;
  }
  __syncthreads();
}

// v := v / |v| where |v| > thr (thr < 0: always, as the power iteration's
// start), the norm folded by thread 0; `scratch` is one shared T.
template <typename T>
__device__ void normalise(T* v, int64_t d, T thr, T* scratch) {
  if (threadIdx.x == 0) *scratch = sqrt(dot_fold(v, v, d));
  __syncthreads();
  const T norm = *scratch;
  if (thr < T(0) || norm > thr) {
    const T div = norm > T(0) ? norm : T(1);
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) v[i] = v[i] / div;
  }
  __syncthreads();
}

// The dominant eigenvector of the covariance deflated `level` times, into v.
template <typename T>
__device__ void power_iteration(const T* cov, const T* axes, const T* lam, int level, int64_t d,
                                int64_t iters, T* v, T* w, T* scratch) {
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x) v[i] = T(1) + T(i) * T(1e-3);
  __syncthreads();
  normalise(v, d, T(-1), scratch);
  for (int64_t it = 0; it < iters; ++it) {
    matvec(cov, axes, lam, level, d, v, w);
    if (threadIdx.x == 0) *scratch = sqrt(dot_fold(w, w, d));
    __syncthreads();
    const T norm = *scratch;
    const T div = norm > T(0) ? norm : T(1);
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) v[i] = norm > T(0) ? w[i] / div : v[i];
    __syncthreads();
  }
}

// lam = v . (c v) for the covariance deflated `level` times.
template <typename T>
__device__ void rayleigh(const T* cov, const T* axes, const T* lam, int level, int64_t d, const T* v, T* w,
                         T* out) {
  matvec(cov, axes, lam, level, d, v, w);
  if (threadIdx.x == 0) *out = dot_fold(v, w, d);
  __syncthreads();
}

// Shared memory: the K axes, w, and the re-orthogonalisation's dot products.
template <typename T, int K>
__global__ void __launch_bounds__(1024) principal_axes_kernel(const AxesArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t d = a.d;
  T* axes = reinterpret_cast<T*>(smem);  // (K, d)
  T* w = axes + K * d;                   // (d,)
  __shared__ T lam[kMaxAxes];
  __shared__ T dots[kMaxAxes];
  __shared__ T scratch;
  const T* cov = static_cast<const T*>(a.cov);
  for (int level = 0; level < K; ++level) {
    T* v = axes + level * d;
    if (level > 0) rayleigh(cov, axes, lam, level - 1, d, axes + (level - 1) * d, w, &lam[level - 1]);
    power_iteration(cov, axes, lam, level, d, a.iters, v, w, &scratch);
    if (level == 0) continue;
    // the dot products with the earlier axes come from the iterate before
    // any is taken off: (v - (v.v1) v1) - (v.v2) v2
    if (threadIdx.x == 0) {
      for (int b = 0; b < level; ++b) dots[b] = dot_fold(v, axes + b * d, d);
    }
    __syncthreads();
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
      T x = v[i];
      for (int b = 0; b < level; ++b) x = x - dots[b] * axes[b * d + i];
      v[i] = x;
    }
    __syncthreads();
    normalise(v, d, T(1e-12), &scratch);
  }
  T* out = static_cast<T*>(a.out);
  for (int64_t i = threadIdx.x; i < K * d; i += blockDim.x) out[i] = axes[i];
}


// ------------------------------------------------------------------ records

template <int D>
__device__ __forceinline__ int64_t dim_of(int64_t d) {
  return D > 0 ? D : d;
}

// One record row: [p[0 .. d) (or `fill` at every coordinate), iw, third, fourth].
template <typename T, int D>
__device__ __forceinline__ void write_record(T* row, const T* p, int64_t d, bool use_pos, T fill, T iw,
                                             T third, T fourth) {
  const int64_t dd = dim_of<D>(d);
#pragma unroll
  for (int64_t k = 0; k < (D > 0 ? D : 0); ++k) row[k] = use_pos ? p[k] : fill;
  if (D == 0) {
    for (int64_t k = 0; k < dd; ++k) row[k] = use_pos ? p[k] : fill;
  }
  row[dd] = iw;
  row[dd + 1] = third;
  row[dd + 2] = fourth;
}

// Values 0 ... 3 of a vertex row, [iw, lw * lw, 1 / iw, colour bits], as
// one 16-byte load (f32) or two (f64).
template <typename T>
struct VertexHead {
  T iw, lw2, rawexp;
  int32_t col;
};

template <typename T>
__device__ __forceinline__ VertexHead<T> load_head(const T* row) {
  constexpr int kVecs = 4 * sizeof(T) / 16;
  union {
    uint4 u[kVecs];
    T t[4];
    int32_t i[4 * sizeof(T) / 4];
  } b;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) b.u[j] = __ldg(reinterpret_cast<const uint4*>(row) + j);
  return {b.t[0], b.t[1], b.t[2], b.i[3 * sizeof(T) / 4]};
}

// The CTA's 256 query (or member) slots from `block * 256`: each thread
// gathers its slot's vertex and writes its colour; the rows go through the
// shared `stage` ((256, D + 3), 16-byte aligned) and out as 16-byte
// vectors, or, in the general instance (D = 0), each thread writes its
// row.
template <typename T, int D>
__device__ __forceinline__ void record_slots(const RecordsArgs& a, bool query, int64_t block, T* stage) {
  const int64_t n = a.n;
  const int64_t d = dim_of<D>(a.d);
  const int64_t slot = block * kThreads + threadIdx.x;
  const int64_t r = query ? a.src_of_q[slot] : a.src_of_pad[slot];
  const T* pos = static_cast<const T*>(a.pos);
  bool use_pos = false;
  T fill = static_cast<T>(query ? kQSentinel : kSSentinel), iw = T(1), third = T(0), fourth = T(0);
  int32_t col = query ? -2 : -3;
  const T* p = pos;
  if (r != n) {
    const int64_t v = a.order[r];
    const T* row = static_cast<const T*>(a.vrec) + v * kVrecWidth;
    const VertexHead<T> h = load_head(row);
    const bool member = query || a.in_index == nullptr || a.in_index[v] != 0;
    use_pos = member;
    fill = static_cast<T>(kSSentinel);  // a member slot's non-member
    iw = h.iw;
    third = query ? h.lw2 : (member ? row[4] : T(0));
    fourth = h.rawexp;
    col = h.col;
    p = pos + v * d;
  }
  (query ? a.qcol : a.scol)[slot] = col;
  T* out = static_cast<T*>(query ? a.qrec : a.srec);
  if (D == 0) {
    write_record<T, D>(out + slot * (d + 3), p, d, use_pos, fill, iw, third, fourth);
    return;
  }
  constexpr int W = D + 3;
  write_record<T, D>(stage + threadIdx.x * W, p, d, use_pos, fill, iw, third, fourth);
  __syncthreads();
  // the block's rows are contiguous, 256 W sizeof(T) bytes (a multiple of
  // 16) from a 16-byte aligned start
  constexpr int kVecs = kThreads * W * static_cast<int>(sizeof(T)) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(out + block * kThreads * W);
#pragma unroll
  for (int j = threadIdx.x; j < kVecs; j += kThreads) dst[j] = src[j];
}

// CTAs [0, NQ / 256) the query slots, then NPA / 256 CTAs the member
// slots, then the sorted ranks, 256 a CTA.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) span_records_kernel(const RecordsArgs a) {
  __shared__ __align__(16) T stage[kThreads * (D > 0 ? D + 3 : 1)];
  const int64_t query_ctas = a.nq / kQ, member_ctas = a.npa / kST;
  const int64_t b = blockIdx.x;
  if (b < query_ctas) {
    record_slots<T, D>(a, true, b, stage);
    return;
  }
  if (b < query_ctas + member_ctas) {
    record_slots<T, D>(a, false, b - query_ctas, stage);
    return;
  }
  const int64_t n = a.n;
  const int64_t j = (b - query_ctas - member_ctas) * kThreads + threadIdx.x;  // a sorted rank
  if (j >= n) return;
  const int64_t v = a.order[j];
  const int64_t q = j + a.sorted_shift_q[j];
  longlong2* inv = reinterpret_cast<longlong2*>(a.inv + 4 * v);
  inv[0] = make_longlong2(j - a.sorted_moff[j], q / kQ);
  inv[1] = make_longlong2(q, a.row_of_sorted[j]);
  T* sorted = static_cast<T*>(a.sorted);
  sorted[j] = static_cast<const T*>(a.x)[v];
  sorted[n + j] = static_cast<const T*>(a.y)[v];
  sorted[2 * n + j] = static_cast<const T*>(a.vrec)[v * kVrecWidth + 5];
}

// ------------------------------------------------------------------ windows

// torch.amax / amin propagate NaN; so do these (a NaN operand wins).
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// The JAX package's tests (wembed_tpu/kernels/span_sparse.py:1206 bsearch):
// x goes before `value` on the left when x < value, on the right when x <=
// value.  Along a row sorted ascending with NaN last both are monotone
// (true ... true, false ... false): a NaN goes before no value, and no
// value goes before NaN.
template <typename T>
__device__ __forceinline__ bool goes_before(T x, T value, bool right) {
  return right ? x <= value : x < value;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// What a thread reads of its target row r before its block's extrema are
// known: every load that no search waits on.
template <typename T>
struct WindowRow {
  int64_t lo;     // first sorted rank
  int64_t tiles;  // tiles of the row
  T ymin, ymax;   // its first-axis extrema, at static ranks of the first sort
  T first, last;  // its first and last sorted second-axis values
  float bmax;     // bmax^(1/d) of its group
  int size;       // members
  int t;          // the window's width in tiles, blk_t[b][r]
};

template <typename T>
__device__ __forceinline__ WindowRow<T> load_window_row(const WindowsArgs& a, int64_t b, int64_t r) {
  WindowRow<T> w{};
  if (r < a.r) {
    const T* xs = static_cast<const T*>(a.sorted);
    const T* y = static_cast<const T*>(a.y);
    const int64_t hi = a.row_hi[r];
    w.lo = a.row_lo[r];
    w.tiles = a.row_tiles[r];
    w.bmax = a.bmax_row[r];
    w.t = a.blk_t[b * a.r + r];
    w.size = static_cast<int>(hi - w.lo + 1);
    w.ymin = y[a.order1[w.lo]];
    w.ymax = y[a.order1[hi]];
    w.first = xs[w.lo];
    w.last = xs[hi];
  }
  return w;
}

// A bound that needs no search, or -1: 0 where the row's first value does
// not go before `v`, the row's size where its last value does, and a
// search inside the row else.
template <typename T>
__device__ __forceinline__ int settled_bound(T v, bool right, const WindowRow<T>& row) {
  if (!goes_before(row.first, v, right)) return 0;
  if (goes_before(row.last, v, right)) return row.size;
  return -1;
}

// Window w's outputs from its bounds [start, stop): the T-tile window slid
// to cover them where it can (end at ceil(stop / ST), never start after
// floor(start / ST), stay inside the row) and the members it needs;
// returns its overflow.
__device__ __forceinline__ int64_t place_window(const WindowsArgs& a, int64_t w, int64_t start, int64_t stop,
                                                int64_t t_blk, int64_t tiles) {
  int64_t st = imin((stop + kST - 1) / kST - t_blk, start / kST);
  st = imin(imax(st, 0), tiles - t_blk);
  const int64_t cov_end = (st + t_blk) * kST;
  a.start_tile[w] = static_cast<int32_t>(st);
  a.need[w] = stop > start ? stop - (start / kST) * kST : 0;
  return imax(imin(stop - cov_end, stop - start), 0);
}

// The slot (thread of the CTA) of the i-th listed window, in slot order:
// listed[w] holds warp w's ballot.
__device__ __forceinline__ int listed_slot(const unsigned* listed, int i) {
  int w = 0;
  while (i >= __popc(listed[w])) i -= __popc(listed[w++]);
  unsigned m = listed[w];
  for (; i > 0; --i) m &= m - 1;  // drop the i lowest listed slots
  return w * 32 + __ffs(m) - 1;
}

// The search's shape: each pivot is a scattered 4-byte load, a 32-byte L2
// sector of its own, so the sectors a search loads weigh as much as its
// rounds: 4 lanes a bound (a 4-ary search, 6 rounds and 24 pivots at 3,584
// values) rather than 16 (3 rounds, 48 pivots); PERF.md, the kernel table.
constexpr int kFan = 4;                             // lanes a bound, pivots a round
constexpr int kGroupWindows = 32 / (2 * kFan);      // windows a warp searches at once
static_assert(kFan * 2 * kGroupWindows == 32, "a warp holds whole windows");

// span_windows_kernel's finish: the overflow of the CTAs that have
// finished this launch, and their count.  A CTA adds its overflow, then
// counts itself with release and acquire order, so the CTA that counts
// gridDim.x - 1 sees every other's sum; it writes the total and sets both
// back to 0 for the next launch or graph replay.
__device__ unsigned long long g_window_overflow;
__device__ unsigned int g_window_ctas_done;

template <typename T>
__global__ void __launch_bounds__(kThreads) span_windows_kernel(const WindowsArgs a) {
  __shared__ T s_ext[3][kWarps];     // each warp's maxlw, ymin, ymax
  __shared__ T s_v[2][kThreads];     // a slot's values: minx - reach, maxx + reach
  __shared__ int s_bound[2][kThreads];  // a slot's start and stop; -1 until searched
  __shared__ int64_t s_lo[kThreads];
  __shared__ int s_size[kThreads];   // its row's size
  __shared__ unsigned s_listed[kWarps];
  __shared__ int64_t s_over[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  const int64_t n = a.n;
  const T* xs = static_cast<const T*>(a.sorted);
  const T big = sizeof(T) == 4 ? static_cast<T>(3.4028234663852886e38) : static_cast<T>(1.7976931348623157e308);

  // Every load that no search waits on goes out first: the block's slot,
  // its second-axis extrema at static ranks, the first target rows.
  const int64_t src = a.src_of_q[b * kQ + threadIdx.x];
  const int64_t first = a.blk_first[b], last = a.blk_last[b];
  WindowRow<T> row = load_window_row<T>(a, b, threadIdx.x);
  const bool valid = src < n;
  T lw = valid ? xs[2 * n + src] : T(0);
  const T yq = valid ? xs[n + src] : T(0);
  T ylo = valid ? yq : big;
  T yhi = valid ? yq : -big;
  const T minx = xs[first];
  const T maxx = xs[last];

  // The block's extrema over its 256 slots (padding: 0, and left out of
  // ymin / ymax): xor shuffles, then the eight warps' through shared memory.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lw = max_nan(lw, __shfl_xor_sync(kFull, lw, o));
    ylo = min_nan(ylo, __shfl_xor_sync(kFull, ylo, o));
    yhi = max_nan(yhi, __shfl_xor_sync(kFull, yhi, o));
  }
  if (lane == 0) {
    s_ext[0][warp] = lw;
    s_ext[1][warp] = ylo;
    s_ext[2][warp] = yhi;
  }
  __syncthreads();
  T maxlw = s_ext[0][0], ymin_blk = s_ext[1][0], ymax_blk = s_ext[2][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    maxlw = max_nan(maxlw, s_ext[0][w]);
    ymin_blk = min_nan(ymin_blk, s_ext[1][w]);
    ymax_blk = max_nan(ymax_blk, s_ext[2][w]);
  }

  const int group = lane / kFan, pivot = lane % kFan;
  const int side = group & 1;  // even groups search start, odd groups stop
  int64_t over = 0;
  for (int64_t base = 0; base < a.r; base += kThreads) {  // 256 target rows a round, a thread each
    const int64_t r = base + threadIdx.x;
    bool listed = false;
    if (r < a.r) {
      const T reach = maxlw * static_cast<T>(row.bmax);
      int start = 0, stop = 0;
      if ((ymin_blk - reach <= row.ymax) && (ymax_blk + reach >= row.ymin)) {
        const T lo_v = minx - reach, hi_v = maxx + reach;
        start = settled_bound(lo_v, false, row);
        stop = settled_bound(hi_v, true, row);
        s_v[0][threadIdx.x] = lo_v;
        s_v[1][threadIdx.x] = hi_v;
        s_lo[threadIdx.x] = row.lo;
        s_size[threadIdx.x] = row.size;
        listed = start < 0 || stop < 0;
      }
      s_bound[0][threadIdx.x] = start;
      s_bound[1][threadIdx.x] = stop;
    }
    const unsigned ballot = __ballot_sync(kFull, listed);
    if (lane == 0) s_listed[warp] = ballot;
    __syncthreads();
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) count += __popc(s_listed[w]);

    // The listed windows, kGroupWindows a warp: each bound left to find by
    // a group of kFan lanes, start on the even groups, stop on the odd ones.
    for (int first_window = warp * kGroupWindows; first_window < count; first_window += kWarps * kGroupWindows) {
      const int i = first_window + group / 2;
      int lo = 0, hi = 0, slot = -1, found = -1;
      T v = T(0);
      const T* xr = xs;
      if (i < count) {
        slot = listed_slot(s_listed, i);
        const int size = s_size[slot];
        found = s_bound[side][slot];
        v = s_v[side][slot];
        xr = xs + s_lo[slot];
        if (found < 0) {
          lo = 1;  // its first value goes before and its last does not
          hi = size - 1;
        }
      }
      // A round: lane k of a group tests pivot lo + (k + 1) s - 1 of the
      // m = hi - lo values left, s = ceil(m / kFan), a pivot at or past hi
      // testing false without a load; the test is monotone along the row,
      // so the c lanes whose value goes before are lanes 0 ... c - 1, and
      // the bound is in [lo + c s, lo + c s + s - 1]: m falls to at most
      // s - 1 a round.  Unsigned offsets and min(hi, ...) taken as a
      // difference keep every row below 2^31 - 1 inside int.
      for (;;) {
        const int m = hi - lo;
        const int step = (m + kFan - 1) / kFan;
        const unsigned off = (pivot + 1u) * static_cast<unsigned>(step) - 1u;  // m = 0: no pivot
        const bool before = off < static_cast<unsigned>(m) && goes_before(xr[lo + off], v, side == 1);
        const unsigned votes = (__ballot_sync(kFull, before) >> (group * kFan)) & ((1u << kFan) - 1u);
        if (m > 0) {
          const int next = lo + __popc(votes) * step;
          hi = hi - next < step ? hi : next + step - 1;
          lo = next;
        }
        if (!__any_sync(kFull, hi > lo)) break;
      }
      if (pivot == 0 && slot >= 0) s_bound[side][slot] = found >= 0 ? found : lo;
    }
    __syncthreads();
    if (r < a.r) over += place_window(a, b * a.r + r, s_bound[0][threadIdx.x], s_bound[1][threadIdx.x], row.t, row.tiles);
    if (base + kThreads < a.r) row = load_window_row<T>(a, b, base + kThreads + threadIdx.x);
  }

  // The block's overflow: a warp's by shuffles, the eight warps' in shared
  // memory, then integer atomics (exact in any order).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(kFull, over, o);
  if (lane == 0) s_over[warp] = over;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += static_cast<unsigned long long>(s_over[w]);
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> sum(g_window_overflow);
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> done(g_window_ctas_done);
    if (total != 0) sum.fetch_add(total, cuda::memory_order_relaxed);
    if (done.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1) {
      a.overflow[0] = static_cast<int64_t>(sum.exchange(0ull, cuda::memory_order_relaxed));
      done.store(0u, cuda::memory_order_relaxed);
    }
  }
}


// ---------------------------------------------------------------- launches

template <typename T, int D>
cudaError_t launch_frame_d(const FrameArgs& a, cudaStream_t s) {
  const unsigned ctas = static_cast<unsigned>(a.ctas);
  frame_mean_kernel<T, D><<<ctas, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  frame_axes_kernel<T, D><<<ctas, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  frame_project_kernel<T, D><<<static_cast<unsigned>((a.n + kThreads - 1) / kThreads), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_frame(const FrameArgs& a, cudaStream_t s) {
  switch (a.d) {
    case 1: return launch_frame_d<T, 1>(a, s);
    case 2: return launch_frame_d<T, 2>(a, s);
    case 3: return launch_frame_d<T, 3>(a, s);
    case 4: return launch_frame_d<T, 4>(a, s);
    case 5: return launch_frame_d<T, 5>(a, s);
    case 6: return launch_frame_d<T, 6>(a, s);
    case 7: return launch_frame_d<T, 7>(a, s);
    case 8: return launch_frame_d<T, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K>
cudaError_t launch_axes_k(const AxesArgs& a, int device, cudaStream_t s) {
  const int threads = static_cast<int>(a.d >= 1024 ? 1024 : ((a.d + 31) / 32) * 32);
  const size_t smem = static_cast<size_t>((K + 1) * a.d) * sizeof(T);
  if (smem > 48 * 1024) {  // wide rows (d > 1,536 in f64 at K = 3): opt in, up to the device's limit
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (smem > static_cast<size_t>(most)) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(principal_axes_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  principal_axes_kernel<T, K><<<1, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_axes(const AxesArgs& a, int device, cudaStream_t s) {
  return a.k == 2 ? launch_axes_k<T, 2>(a, device, s) : launch_axes_k<T, 3>(a, device, s);
}

template <typename T, int D>
void launch_records_d(const RecordsArgs& a, int64_t blocks, cudaStream_t s) {
  span_records_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
}

template <typename T>
cudaError_t launch_records(const RecordsArgs& a, cudaStream_t s) {
  const int64_t blocks = a.nq / kQ + a.npa / kST + (a.n + kThreads - 1) / kThreads;
  switch (a.d) {
    case 1: launch_records_d<T, 1>(a, blocks, s); break;
    case 2: launch_records_d<T, 2>(a, blocks, s); break;
    case 3: launch_records_d<T, 3>(a, blocks, s); break;
    case 4: launch_records_d<T, 4>(a, blocks, s); break;
    case 5: launch_records_d<T, 5>(a, blocks, s); break;
    case 6: launch_records_d<T, 6>(a, blocks, s); break;
    case 7: launch_records_d<T, 7>(a, blocks, s); break;
    case 8: launch_records_d<T, 8>(a, blocks, s); break;
    default: launch_records_d<T, 0>(a, blocks, s); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_windows(const WindowsArgs& a, cudaStream_t s) {
  span_windows_kernel<T><<<static_cast<unsigned>(a.nb), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wembed_build

extern "C" {

int wembed_span_build_query_block() { return wembed_build::kQ; }

int wembed_span_build_tile() { return wembed_build::kST; }

int wembed_span_build_max_fast_dim() { return wembed_build::kMaxFastDim; }

int wembed_span_build_frame_chunk() { return wembed_build::kFrameChunk; }

int wembed_span_build_vrec_width() { return wembed_build::kVrecWidth; }

const char* wembed_span_build_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry enqueues its launches on `stream`, in f64 when `f64` is set,
// else f32, and returns the first launch error.  None allocates or
// synchronises; every buffer comes from the caller (kernels/span_build.py).

int wembed_principal_frame(const wembed_build::FrameArgs* args, int f64, int device, void* stream) {
  using namespace wembed_build;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FrameArgs& a = *args;
  if (a.n < 1 || a.d < 1 || a.d > kMaxFastDim || (a.k != 2 && a.k != 3) || a.iters < 0 ||
      a.ctas != (a.n + kFrameChunk - 1) / kFrameChunk || (a.n + kThreads - 1) / kThreads > INT32_MAX ||
      a.pos == nullptr || a.mean == nullptr || a.part == nullptr || a.axes == nullptr || a.proj == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_frame<double>(a, s) : launch_frame<float>(a, s));
}

int wembed_principal_axes(const wembed_build::AxesArgs* args, int f64, int device, void* stream) {
  using namespace wembed_build;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AxesArgs& a = *args;
  if (a.d < 1 || (a.k != 2 && a.k != 3) || a.iters < 0 || a.cov == nullptr || a.out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_axes<double>(a, device, s) : launch_axes<float>(a, device, s));
}

int wembed_span_records(const wembed_build::RecordsArgs* args, int f64, int device, void* stream) {
  using namespace wembed_build;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RecordsArgs& a = *args;
  if (a.n < 1 || a.d < 1 || a.nq < 0 || a.npa < 0 || a.nq % kQ != 0 || a.npa % kST != 0 ||
      (reinterpret_cast<uintptr_t>(a.vrec) & 15) != 0 || (reinterpret_cast<uintptr_t>(a.inv) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(a.qrec) & 15) != 0 || (reinterpret_cast<uintptr_t>(a.srec) & 15) != 0 ||
      a.nq / kQ + a.npa / kST + (a.n + kThreads - 1) / kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_records<double>(a, s) : launch_records<float>(a, s));
}

int wembed_span_windows(const wembed_build::WindowsArgs* args, int f64, int device, void* stream) {
  using namespace wembed_build;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WindowsArgs& a = *args;
  if (a.n < 1 || a.nb < 1 || a.nb > INT32_MAX || a.r < 1 || a.max_row < 1 || a.max_row >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_windows<double>(a, s) : launch_windows<float>(a, s));
}

}  // extern "C"
