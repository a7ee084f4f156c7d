// Span edge pass for Hopper (sm_90a): attraction and the neighbour
// correction over the directed edges, each source vertex's edges summed
// and added to the sweep's force.
//
// Not a port of a TPU kernel.  The JAX package runs this pass as plain jnp
// (wembed_tpu/kernels/span_sparse.py:_edge_sides, _edge_inclusion,
// span_fused_forces, span_repulsion_forces; wembed_tpu/core/forces.py:
// attraction_forces).  The port's plain version is kernels/edge_pass.py:
// edge_pass_reference, and every operation here repeats one of its torch
// operations, in its order and rounding: each multiply, add, division and
// sqrt rounded alone (--fmad=false, IEEE division and sqrt), Python
// scalars rounded to T first as torch rounds them, x / y where torch
// divides and (1 / y) * x where it takes a reciprocal (a Python scalar
// over a tensor).  Per directed edge j = (s, t):
//   diff    = pos[t] - pos[s];  dist2 = 0 + diff_0^2 + diff_1^2 + ...
//   ws      = iw[s] * iw[t]  (or the sum, additive weights)
//   dist    = sqrt(dist2)
// attraction mode:
//   coeff   = dist * ws > L ? (att_scale * ws) / max(dist, 1e-30) : 0
// span modes (the sweep's query s against its member t):
//   included = dist2 <= (lw[s] * lw[s]) * bm2[j]  &&  col[s] != col[t]
//              && t is in the step's index  &&  s's block covers t
//   active_r = included && dist2 * (ws * ws) <= L^2 && dist2 > 0
//   fused:       inv = 1 / max(dist, 1e-30)
//                ca = dist * ws > L ? (att_scale * ws) * inv : 0
//                coeff = ca + (active_r ? (rep_scale * ws) * inv : 0)
//   correction:  coeff = active_r ? (rep_scale * ws) * (1 / dist) : 0
// and the edge's row is coeff * diff_k, or, where dist2 == 0 (fused and
// attraction), its kick: the caller's raw normal draw g_j normalised as
// core/edge_geometry.py:unit_rows normalises it, norm2 = 0 + g_0^2 + ...
// in ascending k, norm = sqrt(norm2), row = g / (norm > 0 ? norm : 1).
// Only coincident edges read their draw.  Coverage: the windowed layout's
// window of s's block on t's row (start_tile, blk_t), or the cell
// layout's window of s's block on t's cell cut at the block's capacity
// (start, stop, prefix, blk_t): kernels/span_sparse.py:
// SpanStructures.covers and kernels/span_compact.py:CellStructures.covers.
// Each vertex's rows are summed in edge order from 0, as
// torch.segment_reduce sums a 2-D tensor (a left fold), and added to the
// sweep's force; the sweep's zero counts lose the counted coincident
// neighbours.  So forces and zero counts are bitwise the plain version's.
//
// segment_pass_kernel<T, D, C> (d <= 8, f32 or f64; C: what a dst costs
// to read, attraction or either layout's window test): ONE launch a pass,
// no scratch rows.  Its grid is a schedule built once an edge set on the
// host (core/edge_schedule.py), an entry (vertex, vertices, first edge,
// edges) each: first a CTA for each heavy segment (more than 256 edges,
// the schedule's choice), the longest first, then CTAs of kWarps warps, a
// warp each medium segment (more than kLight edges, longest first), then
// CTAs of kWarps warps, a warp each light group (at most 32 consecutive
// vertices and 32 edges, empty segments included).
//  - Light group: lane i loads the group's edge i (dst index and row,
//    radius factor, colour, row and rank of the dst) while lane k loads
//    vertex v0 + k's offsets and per-source values (position, inverse
//    weight, lw, colour, block) once; lane i finds its source by a binary
//    search over the lanes' offsets and takes the source's values by
//    shuffles, tests the window and computes its row; then lane k folds
//    its vertex's rows in edge order through shuffles (as many steps as
//    the group's longest segment) and counts its coincident neighbours
//    from one ballot.
//  - Medium segment: 32 edges a round, an edge a lane (the next round's
//    dst indices loaded meanwhile), folded through shuffles in edge order.
//  - Heavy segment: warp 0 folds, one lane a column; the other 7 warps
//    compute the rows of a chunk of 224 edges (an edge a thread, the next
//    chunk's dst index loaded meanwhile) into one of two shared-memory
//    buffers while warp 0 folds the other (16-byte loads a block ahead of
//    the adds): one barrier a chunk, no row in device memory.  The fold is
//    a chain of dependent adds, one a row: ~10,000 edges take ~20 us at
//    1.98 GHz, the floor of this sum order, so the longest segment starts
//    first.
//  - Totals: each CTA's losses and counts (fixed trees) go to a slot of
//    part_loss and part_count; the last CTA to finish (a device counter,
//    which it resets for the next launch or graph replay) adds the slots
//    in index order, so the totals do not depend on which CTA is last.  No
//    float atomics.
// Registers are held to 80 a thread (3 CTAs an SM, min_ctas) for f32 at
// every D and f64 at D <= 2, where they do not spill: the light and medium
// warps, which carry most edges, need the occupancy to cover their
// gathers' latency.  Wider f64 rows take 2 CTAs an SM (128 registers)
// rather than spill.
//
// edge_pass_kernel<T> and edge_segment_kernel<T>, the general variant
// (d > 8, up to the 2,100 columns of chip_smoke.py's wide cases), are the
// earlier two-launch design, kept but for the kicks: one thread an edge
// writes its row to the (E, d) scratch `net` with a flag for a counted
// coincident neighbour, then each vertex's rows are folded from there
// (segments of more than kLight edges by a whole CTA, in slabs of
// kThreads columns).  kernels/edge_pass.py chooses by d.
//
// What bounds it on an H100.  Read once, the inputs are an edge's dst
// index (4 B) and radius factor (4 B), the CSR offsets and the per-vertex
// tables (not the schedule's entries, which follow from the offsets); kick
// rows only at coincident edges: at girg100k d = 4 (E = 1.39M, f32) about
// 21 MB with the outputs (chip_smoke.py:edge_pass_bound), ~0.006 ms at
// 3.35 TB/s.  The kernel
// gathers, for each edge, its dst's row, inverse weight, colour, row and
// rank (one 32-byte record) and two window entries: six random 32-byte
// sectors from tables that stay in the 50 MB L2, about 270 MB of L2
// sectors a pass at girg100k, which sets the time of the light and medium
// warps; beside them the longest segment's fold and chunk loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace wembed_edge {

constexpr int kThreads = 256;  // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kST = 256;       // members per sweep tile (kernels/span_sweep.py ST)
constexpr int kLight = 32;     // longest light segment (core/edge_schedule.py LIGHT), a warp's lanes
constexpr int kMaxFastDim = 8;   // segment_pass_kernel's widest row
constexpr int kComputeThreads = kThreads - 32;  // warps 1-7 of a heavy segment's CTA: an edge each a chunk
constexpr int kChunk = 2048;   // general variant: staged values of a long segment
constexpr int kPer = kChunk / kThreads;  // of which each thread loads
constexpr double kMinDist = 1e-30;  // torch.clamp_min(dist, 1e-30) in the plain version
constexpr unsigned kFull = 0xffffffffu;

// CTAs an SM holds for segment_pass_kernel<T, D, C>, which caps its
// registers at 65536 / (kThreads * n) a thread: 80 at 3, 128 at 2.  Each
// choice is the most CTAs without a spill (chip_smoke.py's ptxas check
// covers every instantiation): f64 at D >= 3 spills under 80 (20-260
// bytes) and uses 116-128 under 128.
template <typename T, int D>
constexpr int min_ctas() { return sizeof(T) == 4 || D <= 2 ? 3 : 2; }

enum Mode { kFused = 0, kCorrection = 1, kAttraction = 2 };
enum Layout { kWindows = 0, kCells = 1 };

// Mirrors kernels/edge_pass.py:_Args; every field is 8 bytes.
struct Args {
  const void* pos;           // (n, d) T
  const void* inv_w;         // (n,) T
  const int64_t* src;        // (E,) source of each edge, ascending: general variant
  const int64_t* dst;        // (E,): general variant
  const int64_t* row_ptr;    // (n + 1,) each vertex's edges, offsets into [0, E)
  const void* kicks;         // (E, d) T raw normal draws: fused, attraction
  const float* bm2;          // (E,) radius factor of each edge's dst: span modes
  const void* lwpow;         // (n,) T L * w^(1/d): span modes
  const int32_t* colors;     // (n,)
  const uint8_t* in_index;   // (n,) bool, or null for a whole index
  const int64_t* block_of;   // query block of each vertex (strided)
  const int64_t* row_of;     // row (windows) or cell (cells) of each vertex
  const int64_t* rank_of;    // rank within that row or cell
  const int32_t* blk_t;      // (NB, R) window tiles, or (NB, 1) capacities
  const int32_t* start_tile; // windows: (NB, R) first tile of each window
  const int64_t* start;      // cells: (NB, CE) window start, stop and the
  const int64_t* stop;       //   block's members in earlier cells
  const int64_t* prefix;
  const void* base_force;    // (n, d) T the sweep's force: span modes
  const int32_t* base_zero;  // (n,) the sweep's zero counts: span modes
  const int64_t* sched;      // (heavy + medium + groups, 4) the schedule's entries: d <= 8
  const int32_t* dst32;      // (E,) each edge's dst: d <= 8
  void* net;                 // scratch (E, d) T each edge's row: general variant
  uint8_t* zflag;            // scratch (E,) counted coincident neighbours: general variant, span modes
  void* part_loss;           // scratch (parts, 2) T each CTA's losses
  int64_t* part_count;       // scratch (parts,) each CTA's counted neighbours
  void* force;               // out (n, d) T
  int32_t* zero;             // out (n,): span modes
  void* loss;                // out (2,) T attraction, correction
  int64_t* count;            // out (1,) counted neighbours
  int64_t block_stride, row_stride, rank_stride;  // element strides
  int64_t blk_s0, blk_s1, tile_s0, tile_s1;
  int64_t start_s0, start_s1, stop_s0, stop_s1, prefix_s0, prefix_s1;
  int64_t n, d, E, mode, layout, additive;
  int64_t heavy, medium, groups;  // the schedule's heavy and medium segments and light groups
  double L, L2, att_scale, rep_scale;  // rounded to T where they are used
};

// CTAs of segment_pass_kernel that have finished this launch; the last
// resets it.  One pass runs at a time on a device (one stream).
__device__ unsigned int g_ctas_done;

__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }

// torch.clamp_min: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

// Whether the sweep of query block blk (a source's) visits the member at
// row (windows) or cell (cells) `row`, rank `rank` there.
template <int C>
__device__ __forceinline__ bool covered_at(const Args& a, int64_t blk, int64_t row, int64_t rank) {
  if (C == kWindows) {
    const int64_t lo = static_cast<int64_t>(a.start_tile[blk * a.tile_s0 + row * a.tile_s1]) * kST;
    const int64_t hi = lo + static_cast<int64_t>(a.blk_t[blk * a.blk_s0 + row * a.blk_s1]) * kST;
    return rank >= lo && rank < hi;
  }
  const int64_t lo = a.start[blk * a.start_s0 + row * a.start_s1];
  return rank >= lo && rank < a.stop[blk * a.stop_s0 + row * a.stop_s1] &&
         a.prefix[blk * a.prefix_s0 + row * a.prefix_s1] + (rank - lo) <
             static_cast<int64_t>(a.blk_t[blk * a.blk_s0]) * kST;
}

// Whether the sweep of query block blk visits member t.
__device__ __forceinline__ bool covered(const Args& a, int64_t blk, int64_t t) {
  const int64_t row = a.row_of[t * a.row_stride];
  const int64_t rank = a.rank_of[t * a.rank_stride];
  return a.layout == kWindows ? covered_at<kWindows>(a, blk, row, rank) : covered_at<kCells>(a, blk, row, rank);
}

// A kick row: the raw draw g (d values) over its norm, as unit_rows.
template <typename T>
__device__ __forceinline__ T kick_scale(const T* g, int d) {
  T norm2 = T(0);
  for (int k = 0; k < d; ++k) norm2 = norm2 + g[k] * g[k];
  const T norm = ieee_sqrt(norm2);
  return norm > T(0) ? norm : T(1);
}

// Sums v over the CTA in a fixed tree; the result in buf[0].
template <typename V>
__device__ void tree_sum(V* buf, V v) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] = buf[threadIdx.x] + buf[threadIdx.x + w];
    __syncthreads();
  }
}

// ---------------------------------------------------------------- d <= 8

// What a pass reads of a dst beside its row: nothing more (attraction),
// or its coverage by the windowed or the cell layout (span modes).
enum Cover { kCoverWindows = kWindows, kCoverCells = kCells, kCoverNone = 2 };

// A thread's share of a pass's tallies.
template <typename T>
struct Tallies {
  T att = T(0), closs = T(0);
  int64_t inc = 0;  // counted neighbours
  int zc = 0;       // counted coincident neighbours (a heavy segment's)
};

// Sums v over the warp in a fixed tree; the result in lane 0.
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = v + __shfl_down_sync(kFull, v, w);
  return v;
}

// Sums every thread's tallies over the CTA (warp trees, then the warps in
// order); the result in thread 0.
template <typename T>
__device__ Tallies<T> cta_sum(Tallies<T> t) {
  __shared__ T s_att[kWarps], s_closs[kWarps];
  __shared__ int64_t s_inc[kWarps];
  __shared__ int s_zc[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  t.att = warp_sum(t.att);
  t.closs = warp_sum(t.closs);
  t.inc = warp_sum(t.inc);
  t.zc = warp_sum(t.zc);
  if (lane == 0) {
    s_att[warp] = t.att;
    s_closs[warp] = t.closs;
    s_inc[warp] = t.inc;
    s_zc[warp] = t.zc;
  }
  __syncthreads();
  Tallies<T> out;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      out.att = out.att + s_att[w];
      out.closs = out.closs + s_closs[w];
      out.inc += s_inc[w];
      out.zc += s_zc[w];
    }
  }
  __syncthreads();
  return out;
}

// What the pass reads of a segment's source vertex.
template <typename T, int D>
struct Source {
  T pos[D] = {};
  T iw = T(0), lw = T(0);
  int32_t col = 0;
  int64_t blk = 0;
};

template <typename T, int D, int C>
__device__ __forceinline__ Source<T, D> load_source(const Args& a, int64_t v) {
  Source<T, D> s;
  const T* p = static_cast<const T*>(a.pos) + v * D;
#pragma unroll
  for (int k = 0; k < D; ++k) s.pos[k] = p[k];
  s.iw = static_cast<const T*>(a.inv_w)[v];
  if (C != kCoverNone) {
    s.lw = static_cast<const T*>(a.lwpow)[v];
    s.col = a.colors[v];
    s.blk = a.block_of[v * a.block_stride];
  }
  return s;
}

// What the pass reads of an edge j and its dst t.  load_dst issues every
// load that needs only j and t; cover adds the window test, which needs
// the source's block and the dst's row and rank.
template <typename T, int D>
struct Dst {
  T pos[D] = {};
  T iw = T(0);
  float bm2 = 0.0f;
  int32_t col = 0;
  bool member = true;  // in the step's index
  bool cov = true;     // the source's block covers it
  int64_t row = 0, rank = 0;
};

template <typename T, int D, int C>
__device__ __forceinline__ void load_dst(const Args& a, int64_t j, int64_t t, Dst<T, D>& e) {
  const T* p = static_cast<const T*>(a.pos) + t * D;
#pragma unroll
  for (int k = 0; k < D; ++k) e.pos[k] = p[k];
  e.iw = static_cast<const T*>(a.inv_w)[t];
  if (C != kCoverNone) {
    e.bm2 = a.bm2[j];
    e.col = a.colors[t];
    if (a.in_index != nullptr) e.member = a.in_index[t] != 0;
    e.row = a.row_of[t * a.row_stride];
    e.rank = a.rank_of[t * a.rank_stride];
  }
}

template <typename T, int D, int C>
__device__ __forceinline__ void cover(const Args& a, int64_t blk, Dst<T, D>& e) {
  if (C != kCoverNone) e.cov = covered_at<C>(a, blk, e.row, e.rank);
}

// Edge j's row (its pull, or its kick) and its share of the tallies; zf:
// whether it is a counted coincident neighbour.
template <typename T, int D, int C>
__device__ __forceinline__ void edge_row(const Args& a, int64_t j, const Source<T, D>& s, const Dst<T, D>& e,
                                         T (&row)[D], Tallies<T>& tl, bool& zf) {
  T diff[D];
  T dist2 = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    diff[k] = e.pos[k] - s.pos[k];
    dist2 = dist2 + diff[k] * diff[k];
  }
  const T ws = a.additive ? s.iw + e.iw : s.iw * e.iw;
  const T L = static_cast<T>(a.L);
  const T dist = ieee_sqrt(dist2);
  const bool posd = dist2 > T(0);
  T coeff;
  zf = false;
  if (C == kCoverNone) {
    const bool act = dist * ws > L;
    coeff = act ? (static_cast<T>(a.att_scale) * ws) / clamp_min(dist, static_cast<T>(kMinDist)) : T(0);
    if (act) tl.att = tl.att + (dist - (T(1) / ws) * L);
  } else {
    const bool included =
        dist2 <= (s.lw * s.lw) * static_cast<T>(e.bm2) && s.col != e.col && e.member && e.cov;
    const bool active_r = included && dist2 * (ws * ws) <= static_cast<T>(a.L2) && posd;
    if (a.mode == kFused) {
      const T inv_dist = T(1) / clamp_min(dist, static_cast<T>(kMinDist));
      const bool act_a = dist * ws > L;
      const T ca = act_a ? (static_cast<T>(a.att_scale) * ws) * inv_dist : T(0);
      if (act_a) tl.att = tl.att + (dist - (T(1) / ws) * L);
      const T cr = active_r ? (static_cast<T>(a.rep_scale) * ws) * inv_dist : T(0);
      coeff = ca + cr;
    } else {
      coeff = active_r ? (static_cast<T>(a.rep_scale) * ws) * (T(1) / dist) : T(0);
    }
    if (active_r) {
      const T l_over_ws = a.additive ? (T(1) / ws) * L : (L * (T(1) / s.iw)) * (T(1) / e.iw);
      tl.closs = tl.closs + (l_over_ws - dist);
    }
    tl.inc += included;
    zf = included && !posd;
  }
  if (a.mode != kCorrection && !posd) {
    const T* g = static_cast<const T*>(a.kicks) + j * D;
    const T den = kick_scale(g, D);
#pragma unroll
    for (int k = 0; k < D; ++k) row[k] = g[k] / den;
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) row[k] = coeff * diff[k];
  }
}

// Vertex v's output: the sweep's force (span modes) plus its fold.
template <typename T>
__device__ __forceinline__ void write_force(const Args& a, int64_t o, T acc) {
  const T* base = static_cast<const T*>(a.base_force);
  static_cast<T*>(a.force)[o] = base != nullptr ? base[o] + acc : acc;
}

// Light group g, one warp: at most 32 vertices from v0 (lane k holds
// v0 + k) with at most 32 edges (lane i computes the group's edge i).
template <typename T, int D, int C>
__device__ void light_group(const Args& a, int64_t g, Tallies<T>& tl) {
  const int lane = threadIdx.x & 31;
  const int64_t* entry = a.sched + 4 * (a.heavy + a.medium + g);
  const int64_t v0 = entry[0], base = entry[2];
  const int nv = static_cast<int>(entry[1]), ne = static_cast<int>(entry[3]);
  const bool owner = lane < nv;
  const bool live = lane < ne;
  const int64_t v = v0 + lane;
  const int64_t j = base + (live ? lane : 0);
  // the edges' loads beside the vertices' offsets, then the source's
  const int32_t t = live ? a.dst32[j] : 0;
  int64_t lo = 0, hi = 0;
  if (owner) {
    lo = a.row_ptr[v];
    hi = a.row_ptr[v + 1];
  }
  Dst<T, D> e;
  if (live) load_dst<T, D, C>(a, j, t, e);
  const int first = owner ? static_cast<int>(lo - base) : 0;  // the vertex's first edge lane
  const int len = static_cast<int>(hi - lo);
  Source<T, D> mine;
  if (owner && len > 0) mine = load_source<T, D, C>(a, v);
  // the source of edge `lane`: the last vertex lane whose first edge is at
  // or before it (empty segments share their successor's first edge)
  int k = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int c = k + step;
    const int fc = __shfl_sync(kFull, first, c);
    if (c < nv && fc <= lane) k = c;
  }
  Source<T, D> s;
#pragma unroll
  for (int c = 0; c < D; ++c) s.pos[c] = __shfl_sync(kFull, mine.pos[c], k);
  s.iw = __shfl_sync(kFull, mine.iw, k);
  s.lw = __shfl_sync(kFull, mine.lw, k);
  s.col = __shfl_sync(kFull, mine.col, k);
  s.blk = __shfl_sync(kFull, mine.blk, k);
  T row[D];
#pragma unroll
  for (int c = 0; c < D; ++c) row[c] = T(0);
  bool zf = false;
  if (live) {
    cover<T, D, C>(a, s.blk, e);
    edge_row<T, D, C>(a, j, s, e, row, tl, zf);
  }
  // each vertex lane folds its rows in edge order from 0
  const int longest = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(owner ? len : 0)));
  T acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = T(0);
  for (int i = 0; i < longest; ++i) {
    const int from = first + i < 32 ? first + i : 31;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const T x = __shfl_sync(kFull, row[c], from);
      if (i < len) acc[c] = acc[c] + x;
    }
  }
  const unsigned zmask = __ballot_sync(kFull, zf);
  if (owner) {
#pragma unroll
    for (int c = 0; c < D; ++c) write_force(a, v * D + c, acc[c]);
    if (a.zero != nullptr) {
      const unsigned span = len == 0 ? 0u : (len == 32 ? kFull : ((1u << len) - 1u) << first);
      a.zero[v] = a.base_zero[v] - __popc(zmask & span);
    }
  }
}

// Medium segment v, one warp: 32 edges a round, lane i computing the
// round's edge i (the next round's dst indices loaded meanwhile); every
// lane folds the round's rows in edge order through shuffles, and lane 0
// writes the sums.
template <typename T, int D, int C>
__device__ void medium_segment(const Args& a, const int64_t* entry, Tallies<T>& tl) {
  const int lane = threadIdx.x & 31;
  const int64_t v = entry[0], lo = entry[2], hi = lo + entry[3];
  const Source<T, D> s = load_source<T, D, C>(a, v);  // the same addresses for every lane
  T acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = T(0);
  int zc = 0;
  int64_t t = lo + lane < hi ? a.dst32[lo + lane] : 0;
  for (int64_t c0 = lo; c0 < hi; c0 += 32) {
    const int cnt = hi - c0 < 32 ? static_cast<int>(hi - c0) : 32;
    const int64_t next = c0 + 32 + lane;
    const int64_t t_next = next < hi ? a.dst32[next] : 0;
    T row[D];
#pragma unroll
    for (int c = 0; c < D; ++c) row[c] = T(0);
    bool zf = false;
    if (lane < cnt) {
      const int64_t j = c0 + lane;
      Dst<T, D> e;
      load_dst<T, D, C>(a, j, t, e);
      cover<T, D, C>(a, s.blk, e);
      edge_row<T, D, C>(a, j, s, e, row, tl, zf);
    }
    for (int i = 0; i < cnt; ++i) {
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = acc[c] + __shfl_sync(kFull, row[c], i);
    }
    zc += __popc(__ballot_sync(kFull, zf));
    t = t_next;
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) write_force(a, v * D + c, acc[c]);
    if (a.zero != nullptr) a.zero[v] = a.base_zero[v] - zc;
  }
}

// A heavy segment's row buffers: two chunks of kComputeThreads rows,
// column-major, each column padded by 16 bytes so that the folding lanes'
// 16-byte loads fall in different banks.
template <typename T>
struct Heavy {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values a 16-byte load
  static constexpr int kStride = kComputeThreads + kVec;         // a column of a buffer
};

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  __device__ static float at(const V& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
};
template <>
struct Vec16<double> {
  using V = double2;
  __device__ static double at(const V& v, int i) { return i == 0 ? v.x : v.y; }
};

// acc + col[0] + col[1] + ... + col[cnt - 1], left to right: 16-byte loads
// a block of kBlock values ahead of the adds.
template <typename T>
__device__ __forceinline__ T fold_column(const T* col, int cnt, T acc) {
  using Q = Vec16<T>;
  using V = typename Q::V;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kLoads = 4;  // 16-byte loads a block
  constexpr int kBlock = kLoads * kVec;
  const V* vcol = reinterpret_cast<const V*>(col);
  V cur[kLoads], nxt[kLoads];
  int r = 0;
  if (cnt >= kBlock) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) cur[u] = vcol[u];
  }
  for (; r + kBlock <= cnt; r += kBlock) {
    const int rn = r + 2 * kBlock <= cnt ? r + kBlock : r;  // the next block, or this one again
#pragma unroll
    for (int u = 0; u < kLoads; ++u) nxt[u] = vcol[rn / kVec + u];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc = acc + Q::at(cur[u], i);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) cur[u] = nxt[u];
  }
  for (; r < cnt; ++r) acc = acc + col[r];
  return acc;
}

// Heavy segment v, the whole CTA: warps 1-7 compute chunk i (an edge a
// thread) into one buffer while warp 0 folds chunk i - 1 from the other,
// one lane a column.  A computing thread loads its next chunk's dst index
// while it computes this chunk.
template <typename T, int D, int C>
__device__ void heavy_segment(const Args& a, const int64_t* entry, T* buf, Tallies<T>& tl) {
  constexpr int kStride = Heavy<T>::kStride;
  const int64_t v = entry[0], lo = entry[2], m = entry[3];
  const int64_t hi = lo + m;
  const int chunks = static_cast<int>((m + kComputeThreads - 1) / kComputeThreads);
  const int tid = threadIdx.x;
  const Source<T, D> s = load_source<T, D, C>(a, v);  // the same addresses for every thread
  const int64_t first = lo + (tid - 32);  // a computing thread's edge of chunk 0
  int32_t t = tid >= 32 && first < hi ? a.dst32[first] : 0;
  T acc = T(0);
  for (int i = 0; i <= chunks; ++i) {
    if (tid >= 32) {
      if (i < chunks) {
        const int64_t j = first + static_cast<int64_t>(i) * kComputeThreads;
        const int32_t t_next = j + kComputeThreads < hi ? a.dst32[j + kComputeThreads] : 0;
        if (j < hi) {
          Dst<T, D> e;
          load_dst<T, D, C>(a, j, t, e);
          cover<T, D, C>(a, s.blk, e);
          T row[D];
          bool zf;
          edge_row<T, D, C>(a, j, s, e, row, tl, zf);
          tl.zc += zf;
          T* out = buf + (i & 1) * D * kStride + (tid - 32);
#pragma unroll
          for (int c = 0; c < D; ++c) out[c * kStride] = row[c];
        }
        t = t_next;
      }
    } else if (i > 0 && tid < D) {
      const int64_t left = m - static_cast<int64_t>(i - 1) * kComputeThreads;
      const int cnt = left < kComputeThreads ? static_cast<int>(left) : kComputeThreads;
      acc = fold_column(buf + ((i - 1) & 1) * D * kStride + tid * kStride, cnt, acc);
    }
    __syncthreads();
  }
  if (tid < D) write_force(a, v * D + tid, acc);
}

// The `parts` per-CTA partials added by one CTA, in index order: each
// thread a strided run, then a fixed tree.  The partials were written by
// other CTAs, so they are read past L1.
template <typename T>
__device__ void totals(const Args& a, int64_t parts, T* s_loss, int64_t* s_count) {
  const T* part = static_cast<const T*>(a.part_loss);
  T att = T(0), closs = T(0);
  int64_t inc = 0;
  for (int64_t i = threadIdx.x; i < parts; i += kThreads) {
    att = att + __ldcg(part + 2 * i);
    closs = closs + __ldcg(part + 2 * i + 1);
    inc += __ldcg(reinterpret_cast<const long long*>(a.part_count) + i);
  }
  T* out = static_cast<T*>(a.loss);
  tree_sum(s_loss, att);
  if (threadIdx.x == 0) out[0] = s_loss[0];
  __syncthreads();
  tree_sum(s_loss, closs);
  if (threadIdx.x == 0) out[1] = s_loss[0];
  tree_sum(s_count, inc);
  if (threadIdx.x == 0) a.count[0] = s_count[0];
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads, (min_ctas<T, D>())) segment_pass_kernel(const Args a) {
  __shared__ __align__(16) T buf[2 * D * Heavy<T>::kStride];
  __shared__ bool s_last;
  Tallies<T> tl;
  const int64_t b = blockIdx.x;
  const int64_t medium_ctas = (a.medium + kWarps - 1) / kWarps;
  const int warp = threadIdx.x >> 5;
  const bool heavy = b < a.heavy;
  if (heavy) {
    heavy_segment<T, D, C>(a, a.sched + 4 * b, buf, tl);
  } else if (b < a.heavy + medium_ctas) {
    const int64_t i = (b - a.heavy) * kWarps + warp;
    if (i < a.medium) medium_segment<T, D, C>(a, a.sched + 4 * (a.heavy + i), tl);
  } else {
    const int64_t g = (b - a.heavy - medium_ctas) * kWarps + warp;
    if (g < a.groups) light_group<T, D, C>(a, g, tl);
  }
  const Tallies<T> sum = cta_sum(tl);
  if (threadIdx.x == 0) {
    if (heavy && a.zero != nullptr) {
      const int64_t v = a.sched[4 * b];
      a.zero[v] = a.base_zero[v] - sum.zc;
    }
    T* part = static_cast<T*>(a.part_loss) + 2 * b;
    part[0] = sum.att;
    part[1] = sum.closs;
    a.part_count[b] = sum.inc;
    __threadfence();
    s_last = atomicAdd(&g_ctas_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    T* s_loss = buf;  // every CTA is past its buffer
    __shared__ int64_t s_count[kThreads];
    totals<T>(a, gridDim.x, s_loss, s_count);
    if (threadIdx.x == 0) g_ctas_done = 0;
  }
}

// --------------------------------------------------- general variant, d > 8

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_pass_kernel(const Args a) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T att = T(0), closs = T(0);
  int64_t inc = 0;
  if (j < a.E) {
    const int d = static_cast<int>(a.d);
    const T* pos = static_cast<const T*>(a.pos);
    const T* iw = static_cast<const T*>(a.inv_w);
    const int64_t s = a.src[j], t = a.dst[j];
    const T* ps = pos + s * d;
    const T* pt = pos + t * d;
    T dist2 = T(0);
    for (int k = 0; k < d; ++k) {
      const T diff = pt[k] - ps[k];
      dist2 = dist2 + diff * diff;
    }
    const T iw_s = iw[s], iw_t = iw[t];
    const T ws = a.additive ? iw_s + iw_t : iw_s * iw_t;
    const T L = static_cast<T>(a.L);
    const T dist = ieee_sqrt(dist2);
    const bool posd = dist2 > T(0);
    T coeff;
    if (a.mode == kAttraction) {
      const bool act = dist * ws > L;
      coeff = act ? (static_cast<T>(a.att_scale) * ws) / clamp_min(dist, static_cast<T>(kMinDist)) : T(0);
      if (act) att = dist - (T(1) / ws) * L;
    } else {
      const T lw = static_cast<const T*>(a.lwpow)[s];
      bool included = dist2 <= (lw * lw) * static_cast<T>(a.bm2[j]) && a.colors[s] != a.colors[t];
      if (included && a.in_index != nullptr) included = a.in_index[t] != 0;
      if (included) included = covered(a, a.block_of[s * a.block_stride], t);
      const bool active_r = included && dist2 * (ws * ws) <= static_cast<T>(a.L2) && posd;
      if (a.mode == kFused) {
        const T inv_dist = T(1) / clamp_min(dist, static_cast<T>(kMinDist));
        const bool act_a = dist * ws > L;
        const T ca = act_a ? (static_cast<T>(a.att_scale) * ws) * inv_dist : T(0);
        if (act_a) att = dist - (T(1) / ws) * L;
        const T cr = active_r ? (static_cast<T>(a.rep_scale) * ws) * inv_dist : T(0);
        coeff = ca + cr;
      } else {
        coeff = active_r ? (static_cast<T>(a.rep_scale) * ws) * (T(1) / dist) : T(0);
      }
      if (active_r) {
        const T l_over_ws = a.additive ? (T(1) / ws) * L : (L * (T(1) / iw_s)) * (T(1) / iw_t);
        closs = l_over_ws - dist;
      }
      inc = included;
      a.zflag[j] = included && !posd;
    }
    T* row = static_cast<T*>(a.net) + j * d;
    if (a.mode != kCorrection && !posd) {
      const T* kick = static_cast<const T*>(a.kicks) + j * d;
      const T den = kick_scale(kick, d);
      for (int k = 0; k < d; ++k) row[k] = kick[k] / den;
    } else {
      for (int k = 0; k < d; ++k) row[k] = coeff * (pt[k] - ps[k]);
    }
  }
  __shared__ T s_loss[kThreads];
  __shared__ int64_t s_count[kThreads];
  T* part = static_cast<T*>(a.part_loss) + 2 * static_cast<int64_t>(blockIdx.x);
  tree_sum(s_loss, att);
  if (threadIdx.x == 0) part[0] = s_loss[0];
  __syncthreads();
  tree_sum(s_loss, closs);
  if (threadIdx.x == 0) part[1] = s_loss[0];
  tree_sum(s_count, inc);
  if (threadIdx.x == 0) a.part_count[blockIdx.x] = s_count[0];
}

// The chunk of `cnt` edges from edge c0, columns [c, c + w) of their
// rows: this thread's values into vals (kPer independent loads, staged
// edge by edge, w values each) and, when `flags`, its flags added to zc.
template <typename T>
__device__ __forceinline__ void load_chunk(const Args& a, int64_t c0, int cnt, int c, int w, bool flags,
                                           T (&vals)[kPer], int& zc) {
  const int d = static_cast<int>(a.d);
  const T* rows = static_cast<const T*>(a.net) + c0 * d;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < cnt * w) vals[u] = rows[w == d ? i : (i / w) * d + c + i % w];
    if (flags && i < cnt) zc += a.zflag[c0 + i];
  }
}

// Vertex v's long segment, folded by the whole CTA, kThreads columns at a
// time: each chunk of those columns' values loaded into registers (the
// next chunk's loads in flight while this one is folded), staged in shared
// memory, and folded there in edge order by one thread a column.
template <typename T>
__device__ void long_segment(const Args& a, int64_t v, T* buf, int* s_zero) {
  const int d = static_cast<int>(a.d);
  const int64_t lo = a.row_ptr[v], hi = a.row_ptr[v + 1];
  const bool flags = a.zflag != nullptr;
  int zc = 0;
  for (int c = 0; c < d; c += kThreads) {
    const int w = d - c < kThreads ? d - c : kThreads;  // columns of this slab
    const int per = kChunk / w;                          // edges a chunk
    T vals[kPer];
    T acc = T(0);
    load_chunk(a, lo, static_cast<int>(hi - lo < per ? hi - lo : per), c, w, flags && c == 0, vals, zc);
    for (int64_t c0 = lo; c0 < hi; c0 += per) {
      const int cnt = static_cast<int>(hi - c0 < per ? hi - c0 : per);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < cnt * w) buf[i] = vals[u];
      }
      __syncthreads();
      const int64_t next = c0 + per;
      if (next < hi) {
        load_chunk(a, next, static_cast<int>(hi - next < per ? hi - next : per), c, w, flags && c == 0, vals, zc);
      }
      if (threadIdx.x < w) {
#pragma unroll 8
        for (int e = 0; e < cnt; ++e) acc = acc + buf[e * w + threadIdx.x];
      }
      __syncthreads();
    }
    if (threadIdx.x < w) write_force(a, v * d + c + threadIdx.x, acc);
  }
  if (a.zero != nullptr) {
    if (threadIdx.x == 0) *s_zero = 0;
    __syncthreads();
    if (zc != 0) atomicAdd(s_zero, zc);  // integers: any order gives the same sum
    __syncthreads();
    if (threadIdx.x == 0) a.zero[v] = a.base_zero[v] - *s_zero;
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_segment_kernel(const Args a) {
  __shared__ T buf[kChunk];
  __shared__ int64_t s_long[kThreads];
  __shared__ int s_nlong, s_zero;
  __shared__ T s_loss[kThreads];
  __shared__ int64_t s_count[kThreads];
  const int d = static_cast<int>(a.d);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t v = g / d;
  const int k = static_cast<int>(g - v * d);
  if (threadIdx.x == 0) s_nlong = 0;
  __syncthreads();
  if (v < a.n) {
    const int64_t lo = a.row_ptr[v], hi = a.row_ptr[v + 1];
    if (hi - lo > kLight) {
      if (k == 0) s_long[atomicAdd(&s_nlong, 1)] = v;  // any order: each is summed alone
    } else {
      const T* net = static_cast<const T*>(a.net);
      T acc = T(0);
      for (int64_t j = lo; j < hi; ++j) acc = acc + net[j * d + k];
      write_force(a, g, acc);
      if (k == 0 && a.zero != nullptr) {
        int zc = 0;
        for (int64_t j = lo; j < hi; ++j) zc += a.zflag[j];
        a.zero[v] = a.base_zero[v] - zc;
      }
    }
  }
  __syncthreads();
  const int nlong = s_nlong;
  for (int i = 0; i < nlong; ++i) long_segment(a, s_long[i], buf, &s_zero);
  if (blockIdx.x == 0) totals<T>(a, (a.E + kThreads - 1) / kThreads, s_loss, s_count);
}

// ---------------------------------------------------------------- launches

template <typename T, int D>
cudaError_t launch_segments(const Args& a, cudaStream_t stream) {
  const unsigned ctas =
      static_cast<unsigned>(a.heavy + (a.medium + kWarps - 1) / kWarps + (a.groups + kWarps - 1) / kWarps);
  if (a.mode == kAttraction) {
    segment_pass_kernel<T, D, kCoverNone><<<ctas, kThreads, 0, stream>>>(a);
  } else if (a.layout == kWindows) {
    segment_pass_kernel<T, D, kCoverWindows><<<ctas, kThreads, 0, stream>>>(a);
  } else {
    segment_pass_kernel<T, D, kCoverCells><<<ctas, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fast(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 1: return launch_segments<T, 1>(a, stream);
    case 2: return launch_segments<T, 2>(a, stream);
    case 3: return launch_segments<T, 3>(a, stream);
    case 4: return launch_segments<T, 4>(a, stream);
    case 5: return launch_segments<T, 5>(a, stream);
    case 6: return launch_segments<T, 6>(a, stream);
    case 7: return launch_segments<T, 7>(a, stream);
    case 8: return launch_segments<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_general(const Args& a, cudaStream_t stream) {
  if (a.E > 0) {
    const int64_t parts = (a.E + kThreads - 1) / kThreads;
    edge_pass_kernel<T><<<static_cast<unsigned>(parts), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (a.n * a.d + kThreads - 1) / kThreads;
  edge_segment_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace wembed_edge

extern "C" {

int wembed_edge_pass_block() { return wembed_edge::kThreads; }

int wembed_edge_pass_tile() { return wembed_edge::kST; }

int wembed_edge_pass_light() { return wembed_edge::kLight; }

int wembed_edge_pass_warps() { return wembed_edge::kWarps; }

int wembed_edge_pass_max_fast_dim() { return wembed_edge::kMaxFastDim; }

const char* wembed_edge_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one edge pass on `stream`, in f64 when `f64` is set, else f32,
// and returns the first launch error.  Allocates nothing and does not
// synchronise; every buffer comes from the caller (kernels/edge_pass.py:
// edge_pass).  d <= 8: segment_pass_kernel over the schedule (`sched`,
// `dst32`, `heavy`, `medium`, `groups`), `part_loss` and `part_count`
// holding one slot a CTA, heavy + ceil(medium / 8) + ceil(groups / 8);
// d > 8: the general variant's two
// kernels, with `net`, `zflag` (span modes) and ceil(E / 256) slots, at
// least one.
int wembed_edge_pass(const wembed_edge::Args* args, int f64, int device, void* stream) {
  using namespace wembed_edge;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args& a = *args;
  const bool span = a.mode != kAttraction;
  const bool fast = a.d <= kMaxFastDim;
  if (a.n < 1 || a.d < 1 || a.E < 0 || a.mode < kFused || a.mode > kAttraction ||
      (span && (a.zero == nullptr || a.base_zero == nullptr)) ||
      (a.mode != kCorrection && a.E > 0 && a.kicks == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fast && (a.sched == nullptr || a.dst32 == nullptr || a.heavy < 0 || a.medium < 0 || a.groups < 0 ||
               a.heavy + a.medium + a.groups < 1 ||
               a.heavy + (a.medium + kWarps - 1) / kWarps + (a.groups + kWarps - 1) / kWarps > INT32_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!fast && ((a.n * a.d + kThreads - 1) / kThreads > INT32_MAX || (a.E + kThreads - 1) / kThreads > INT32_MAX ||
                a.net == nullptr || (span && a.zflag == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast) {
    err = f64 ? launch_fast<double>(a, s) : launch_fast<float>(a, s);
  } else {
    err = f64 ? launch_general<double>(a, s) : launch_general<float>(a, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
