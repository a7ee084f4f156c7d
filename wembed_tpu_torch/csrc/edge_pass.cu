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
// segment_pass_general_kernel<T, C> (d > 8, up to the 2,100 columns of
// chip_smoke.py's wide cases, f32 or f64): the same single launch over the
// same schedule, no (E, d) scratch, the same last-CTA totals.  A warp works
// on rounds of at most 32 edges, an edge a lane, then folds them a lane a
// column:
//  - the edge's lane reads its dst row LaneSlab<T>::kCols (16 f32, 4 f64)
//    columns at a time into registers, all of a slab's loads in flight,
//    adds the squares in ascending k into dist2, and computes the
//    coefficient, tallies and, at a coincident edge, its kick's norm.
//    Where the row fits those registers (f32 at d <= 16) the lane writes
//    the row itself to its row of the warp's stage in shared memory;
//    otherwise the coefficient, the norm and the dst;
//  - lane c folds column c over the round's edges in order: the staged
//    rows, or each row formed again from the positions (coeff * diff, or
//    kick / norm).
// What an edge reads beside its row (the dst's inverse weight, colour,
// membership, row and rank, and then its window of the source's block,
// Window) is loaded a round ahead in a segment, the dst index two rounds
// ahead, and the dst row asked into L1 (prefetch_l1) a round ahead.
// Light group: one round (its vertices' rows and the sweep's force rows
// asked into L1 first); at d <= 16 two vertices are folded at a time, a
// half-warp each.  Medium segment: rounds of 32 edges, each column's sum
// carried in a register (d <= 32) or in the output row.  Heavy segment:
// chunks of 32 edges a computing warp.  At d <= kSplitDim = 32, warps 1-7
// compute chunk i, each lane its row into one of two buffers (column-major
// in dynamic shared memory; heavy_row), while warp 0 folds chunk i - 1
// from the other, a lane a column, as segment_pass_kernel's warp 0 does:
// one barrier a chunk.  Wider rows: the 8 warps compute a chunk's
// coefficients, then the CTA folds it from the positions, a thread a
// column, in slabs of kThreads columns, the sums carried in the output row.
// Every operation repeats the plain version's, in its order, so forces and
// zero counts are bitwise the plain version's at any d, as they are at
// d <= 8.  Registers: 2 CTAs an SM (128 a thread, kGeneralCtas); at 3, 80
// registers, f32 spills.
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
// warps; beside them the longest segment's fold and chunk loads.  At d =
// 16 the inputs and outputs are ~36 MB (girg100k, E = 1.44M, f32), ~0.011
// ms; the general variant reads each dst row once (a lane a row, 16-byte
// loads), and not the bytes but its chains of dependent loads set its time:
// a light group's entry, its edges and vertices, its dsts' values and
// rows, their windows; a heavy segment's ~45 chunks one after another.

#include <cuda_runtime.h>

#include <cstdint>

namespace wembed_edge {

constexpr int kThreads = 256;  // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kST = 256;       // members per sweep tile (kernels/span_sweep.py ST)
constexpr int kLight = 32;     // longest light segment (core/edge_schedule.py LIGHT), a warp's lanes
constexpr int kMaxFastDim = 8;   // segment_pass_kernel's widest row
constexpr int kComputeThreads = kThreads - 32;  // warps 1-7 of a heavy segment's CTA: an edge each a chunk
constexpr int kSlab = 16;      // general variant: columns of an f32 lane's row slab, and of a stage row
constexpr int kStageStride = kSlab + 1;  // a stage row, padded so that a column's reads fall in distinct banks
constexpr int kSplitDim = 32;  // general variant: widest row whose heavy fold is warp 0's, beside 7 computing warps
constexpr int kLightPerWarp = 2;  // general variant: light groups a warp takes in turn (the next one's data into L1)
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
  const int64_t* sched;      // (heavy + medium + groups, 4) the schedule's entries
  const int32_t* dst32;      // (E,) each edge's dst
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

// CTAs an SM holds for segment_pass_general_kernel<T, C>: its registers are
// capped at 65536 / (kThreads * 2) = 128 a thread (chip_smoke.py's ptxas
// check covers every instantiation; at 3 CTAs, 80 registers, f32 spills).
constexpr int kGeneralCtas = 2;

// The kernel's dynamic shared memory: each warp's stage (a round's rows at
// d <= kSlab in f32, a padded row an edge); the rounds' results, each edge's
// coefficient, its kick's norm (never 0; 0 marks a pull row) and its dst,
// in two buffers of kThreads slots (warp w's round in slots [32 w, 32 w +
// 32) of the first; a wide heavy segment's chunk in either); and, for a
// heavy segment of d <= kSplitDim columns, two chunks of kComputeThreads
// rows, column-major (a column Heavy<T>::kStride values), which warp 0
// folds.  The same offsets on the host (the launch's bytes) and the card.
template <typename T>
struct GeneralLayout {
  static constexpr size_t kStage = 0;
  static constexpr size_t kCoef = kStage + sizeof(T) * kWarps * 32 * kStageStride;
  static constexpr size_t kDen = kCoef + sizeof(T) * 2 * kThreads;
  static constexpr size_t kDst = kDen + sizeof(T) * 2 * kThreads;
  static constexpr size_t kRows = (kDst + sizeof(int32_t) * 2 * kThreads + 15) / 16 * 16;
  // bytes of the rows buffer (one chunk) and of the whole layout at width d
  __host__ __device__ static size_t chunk_rows(int64_t d) {
    return d <= kSplitDim ? sizeof(T) * static_cast<size_t>(d) * Heavy<T>::kStride : 0;
  }
  __host__ __device__ static size_t bytes(int64_t d) { return kRows + 2 * chunk_rows(d); }
};

template <typename T>
struct GeneralSmem {
  T* stage;  // warp w's at stage + w * 32 * kStageStride
  T* coef;   // two buffers of kThreads
  T* den;
  int32_t* dst;
  T* rows;   // two chunks of d columns of Heavy<T>::kStride (d <= kSplitDim)

  __device__ explicit GeneralSmem(unsigned char* base)
      : stage(reinterpret_cast<T*>(base + GeneralLayout<T>::kStage)),
        coef(reinterpret_cast<T*>(base + GeneralLayout<T>::kCoef)),
        den(reinterpret_cast<T*>(base + GeneralLayout<T>::kDen)),
        dst(reinterpret_cast<int32_t*>(base + GeneralLayout<T>::kDst)),
        rows(reinterpret_cast<T*>(base + GeneralLayout<T>::kRows)) {}
};

// What the pass reads of an edge's source vertex beside its row.
template <typename T>
struct GSource {
  int64_t v = 0;
  T iw = T(0), lw = T(0);
  int32_t col = 0;
  int64_t blk = 0;
};

template <typename T, int C>
__device__ __forceinline__ GSource<T> general_source(const Args& a, int64_t v) {
  GSource<T> s;
  s.v = v;
  s.iw = static_cast<const T*>(a.inv_w)[v];
  if (C != kCoverNone) {
    s.lw = static_cast<const T*>(a.lwpow)[v];
    s.col = a.colors[v];
    s.blk = a.block_of[v * a.block_stride];
  }
  return s;
}

// kick_scale over a row of runtime width: eight loads before their adds.
template <typename T>
__device__ __forceinline__ T kick_norm(const T* g, int d) {
  T norm2 = T(0);
  for (int k0 = 0; k0 < d; k0 += 8) {
    T x[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) x[m] = k0 + m < d ? g[k0 + m] : T(0);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (k0 + m < d) norm2 = norm2 + x[m] * x[m];
    }
  }
  const T norm = ieee_sqrt(norm2);
  return norm > T(0) ? norm : T(1);
}

// Asks L1 for the lines holding values [0, n) of p (a warp's lanes a line
// each in turn), so that the loads that follow hit it: a vertex row, or a
// run of consecutive vertices' rows, whose address is known a level of
// dependent loads before its values are needed.
template <typename T>
__device__ __forceinline__ void prefetch_l1(const T* p, int64_t n, int lane, int lanes) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(127);
  const uintptr_t end = reinterpret_cast<uintptr_t>(p + n);
  for (uintptr_t q = lo + static_cast<uintptr_t>(lane) * 128; q < end; q += static_cast<uintptr_t>(lanes) * 128) {
    asm volatile("prefetch.L1 [%0];" ::"l"(q));
  }
}

// The window of a source's query block on a dst's row (windows: its first
// tile and tiles) or cell (cells: start, stop, the block's earlier members
// there, and the block's capacity), loaded apart from covered_at's test of
// it, so that a segment loads its next round's windows during this round.
// The loaded values stay as they are until the test.
struct Window {
  int64_t start = 0, stop = 0, prefix = 0;  // cells
  int32_t tile = 0, tiles = 0;              // windows: start_tile, blk_t; cells: tiles = the capacity
};

template <int C>
__device__ __forceinline__ Window load_window(const Args& a, int64_t blk, int64_t row) {
  Window w;
  if (C == kCoverWindows) {
    w.tile = a.start_tile[blk * a.tile_s0 + row * a.tile_s1];
    w.tiles = a.blk_t[blk * a.blk_s0 + row * a.blk_s1];
  } else if (C == kCoverCells) {
    w.start = a.start[blk * a.start_s0 + row * a.start_s1];
    w.stop = a.stop[blk * a.stop_s0 + row * a.stop_s1];
    w.prefix = a.prefix[blk * a.prefix_s0 + row * a.prefix_s1];
    w.tiles = a.blk_t[blk * a.blk_s0];
  }
  return w;
}

// covered_at's test on a loaded window.
template <int C>
__device__ __forceinline__ bool in_window(const Window& w, int64_t rank) {
  if (C == kCoverWindows) {
    const int64_t lo = static_cast<int64_t>(w.tile) * kST;
    return rank >= lo && rank < lo + static_cast<int64_t>(w.tiles) * kST;
  }
  if (C == kCoverCells) {
    return rank >= w.start && rank < w.stop && w.prefix + (rank - w.start) < static_cast<int64_t>(w.tiles) * kST;
  }
  return true;
}

// What the pass reads of an edge's dst beside its row, loaded ahead of the
// row (a round ahead in a segment) so that their latency overlaps; the
// window (load_window) follows from row once it has arrived.
template <typename T>
struct GDst {
  T iw = T(0);
  float bm2 = 0.0f;
  int32_t col = 0;
  bool member = true;  // in the step's index
  int64_t row = 0, rank = 0;
  Window w;
};

template <typename T, int C>
__device__ __forceinline__ GDst<T> general_dst(const Args& a, int64_t j, int64_t t) {
  GDst<T> e;
  e.iw = static_cast<const T*>(a.inv_w)[t];
  if (C != kCoverNone) {
    e.bm2 = a.bm2[j];
    e.col = a.colors[t];
    if (a.in_index != nullptr) e.member = a.in_index[t] != 0;
    e.row = a.row_of[t * a.row_stride];
    e.rank = a.rank_of[t * a.rank_stride];
  }
  return e;
}

// Edge j = (s, t)'s coefficient from its dist2 (edge_row's arithmetic but
// for the row) and its share of the tallies; zf: whether it is a counted
// coincident neighbour.
template <typename T, int C>
__device__ __forceinline__ T general_coeff(const Args& a, const GSource<T>& s, const GDst<T>& e, T dist2,
                                           Tallies<T>& tl, bool& zf) {
  const T ws = a.additive ? s.iw + e.iw : s.iw * e.iw;
  const T L = static_cast<T>(a.L);
  const T dist = ieee_sqrt(dist2);
  const bool posd = dist2 > T(0);
  zf = false;
  if (C == kCoverNone) {
    const bool act = dist * ws > L;
    if (act) tl.att = tl.att + (dist - (T(1) / ws) * L);
    return act ? (static_cast<T>(a.att_scale) * ws) / clamp_min(dist, static_cast<T>(kMinDist)) : T(0);
  }
  const bool included =
      dist2 <= (s.lw * s.lw) * static_cast<T>(e.bm2) && s.col != e.col && e.member && in_window<C>(e.w, e.rank);
  const bool active_r = included && dist2 * (ws * ws) <= static_cast<T>(a.L2) && posd;
  T coeff;
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
  return coeff;
}

// Columns a lane holds of its edge's row: 16 f32 (kSlab, a stage row) or
// 4 f64 (wider f64 slabs spill).
template <typename T>
struct LaneSlab {
  static constexpr int kCols = sizeof(T) == 4 ? kSlab : 4;
};

// dist2 of the row pt[0, d) - ps[0, d), one lane: LaneSlab<T>::kCols
// columns loaded at a time (all in flight; 16-byte loads where both rows
// start 16-byte aligned and d is a multiple of 16 / sizeof(T): the same
// lines in a quarter of the requests), added in ascending k; the
// last slab's diffs are left in diff.
template <typename T>
__device__ __forceinline__ T lane_dist2(const T* pt, const T* ps, int d, T (&diff)[LaneSlab<T>::kCols]) {
  constexpr int kW = LaneSlab<T>::kCols;
  using Q = Vec16<T>;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool vec = ((reinterpret_cast<uintptr_t>(pt) | reinterpret_cast<uintptr_t>(ps)) & 15) == 0 && d % kVec == 0;
  T dist2 = T(0);
  for (int c0 = 0; c0 < d; c0 += kW) {
    if (vec && c0 + kW <= d) {
      typename Q::V vt[kW / kVec], vs[kW / kVec];
#pragma unroll
      for (int u = 0; u < kW / kVec; ++u) {
        vt[u] = reinterpret_cast<const typename Q::V*>(pt + c0)[u];
        vs[u] = reinterpret_cast<const typename Q::V*>(ps + c0)[u];
      }
#pragma unroll
      for (int k = 0; k < kW; ++k) diff[k] = Q::at(vt[k / kVec], k % kVec) - Q::at(vs[k / kVec], k % kVec);
    } else {
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        if (c0 + k < d) diff[k] = pt[c0 + k] - ps[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      if (c0 + k < d) dist2 = dist2 + diff[k] * diff[k];
    }
  }
  return dist2;
}

// One warp's round of cnt <= 32 edges, an edge a lane: lane i < cnt holds
// edge j, its dst t, what general_dst loaded of t and its window (the
// caller issues those loads early, a round ahead where it can) and its
// source s.  The lane reads its row (lane_dist2), computes the coefficient
// and, at a coincident edge, its kick's norm; where the row fits the
// lane's registers (d <= LaneSlab<T>::kCols) it writes the row itself to
// its stage row, stage[i * kStageStride + c], as fold_rows would form it;
// otherwise its coefficient, kick norm (0 for a pull row) and t to coef[i],
// den[i], dst[i], from which fold_rows forms the row again.
template <typename T, int C>
__device__ void general_round(const Args& a, int cnt, int64_t j, int32_t t, const GDst<T>& e, const GSource<T>& s,
                              T* stage, T* coef, T* den, int32_t* dst, Tallies<T>& tl, bool& zf) {
  constexpr int kW = LaneSlab<T>::kCols;
  const int lane = threadIdx.x & 31;
  const int d = static_cast<int>(a.d);
  const T* pos = static_cast<const T*>(a.pos);
  __syncwarp();  // the warp's reads of the last round's stage and slots are done
  zf = false;
  if (lane >= cnt) return;
  T diff[kW];
  const T dist2 = lane_dist2(pos + static_cast<int64_t>(t) * d, pos + s.v * d, d, diff);
  const T coeff = general_coeff<T, C>(a, s, e, dist2, tl, zf);
  const bool kick = a.mode != kCorrection && !(dist2 > T(0));
  const T* g = static_cast<const T*>(a.kicks) + j * d;
  const T norm = kick ? kick_norm(g, d) : T(0);
  if (d <= kW) {
    T* row = stage + lane * kStageStride;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      if (k < d) row[k] = kick ? g[k] / norm : coeff * diff[k];
    }
  } else {
    coef[lane] = coeff;
    den[lane] = norm;
    dst[lane] = t;
  }
}

// acc plus the rows of slots [e0, e1) (edges j0 + e) in column c, in slot
// order, formed again from the positions (sp: the source's column c): a
// kick's column over its norm, or the coefficient times the diff.
template <typename T>
__device__ __forceinline__ T fold_rows(const Args& a, T acc, int e0, int e1, int64_t j0, const T* coef, const T* den,
                                       const int32_t* dst, int c, T sp) {
  const int64_t d = a.d;
  const T* pos = static_cast<const T*>(a.pos);
  const T* kicks = static_cast<const T*>(a.kicks);
  constexpr int kAhead = 4;  // diffs loaded before their adds (a kick's division would hold back the next load)
  int e = e0;
  for (; e + kAhead <= e1; e += kAhead) {
    T diff[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) diff[u] = pos[dst[e + u] * d + c] - sp;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      T row = coef[e + u] * diff[u];
      if (den[e + u] != T(0)) row = kicks[(j0 + e + u) * d + c] / den[e + u];
      acc = acc + row;
    }
  }
  for (; e < e1; ++e) {
    T row = coef[e] * (pos[dst[e] * d + c] - sp);
    if (den[e] != T(0)) row = kicks[(j0 + e) * d + c] / den[e];
    acc = acc + row;
  }
  return acc;
}

// acc plus the staged rows [e0, e1) in column c, in row order.
template <typename T>
__device__ __forceinline__ T fold_stage(T acc, const T* stage, int e0, int e1, int c) {
  for (int e = e0; e < e1; ++e) acc = acc + stage[e * kStageStride + c];
  return acc;
}

// A heavy chunk's edge j (dst t, what general_dst loaded of it), one lane:
// the row read into registers LaneSlab<T>::kCols columns at a time (the
// source's columns from shared memory, sp), dist2 added in ascending k,
// the coefficient, then the row (its columns read again where they span
// more than one slab) written to the chunk's buffer at
// rows[c * Heavy<T>::kStride], column c.
template <typename T, int C>
__device__ __forceinline__ void heavy_row(const Args& a, int64_t j, int32_t t, GDst<T> e, const GSource<T>& s,
                                          const T* sp, T* rows, Tallies<T>& tl, bool& zf) {
  constexpr int kW = LaneSlab<T>::kCols;
  const int d = static_cast<int>(a.d);
  const T* pt = static_cast<const T*>(a.pos) + static_cast<int64_t>(t) * d;
  T diff[kW];
  const T dist2 = lane_dist2(pt, sp, d, diff);
  const T coeff = general_coeff<T, C>(a, s, e, dist2, tl, zf);
  const bool kick = a.mode != kCorrection && !(dist2 > T(0));
  const T* g = static_cast<const T*>(a.kicks) + j * d;
  const T den = kick ? kick_norm(g, d) : T(1);
  for (int c0 = 0; c0 < d; c0 += kW) {
    if (d > kW) {  // the last slab's diffs are in registers; this one's again
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        if (c0 + k < d) diff[k] = pt[c0 + k] - sp[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      if (c0 + k < d) rows[(c0 + k) * Heavy<T>::kStride] = kick ? g[c0 + k] / den : coeff * diff[k];
    }
  }
}

// Light group g, one warp: one round over its edges (lane i the group's
// edge i, lane k the vertex v0 + k), then each vertex's fold: with the
// rows staged, two vertices at a time (a half-warp each, lane c of a half
// its column); otherwise one vertex at a time, 32 columns at a time.
template <typename T, int C>
__device__ void general_light_group(const Args& a, int64_t g, int64_t next, const GeneralSmem<T>& sh, Tallies<T>& tl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = static_cast<int>(a.d);
  const int64_t* entry = a.sched + 4 * (a.heavy + a.medium + g);
  const int64_t v0 = entry[0], base = entry[2];
  const int nv = static_cast<int>(entry[1]), ne = static_cast<int>(entry[3]);
  const bool owner = lane < nv;
  const int64_t j = base + (lane < ne ? lane : 0);
  const T* pos = static_cast<const T*>(a.pos);
  // every load that needs only the entry first: the edges' dst, the
  // vertices' offsets and values, and into L1 the vertices' rows and the
  // sweep's force rows (consecutive vertices: one run each)
  const int32_t t = lane < ne ? a.dst32[j] : 0;
  int64_t lo = 0, hi = 0;
  GSource<T> mine;
  if (owner) {
    lo = a.row_ptr[v0 + lane];
    hi = a.row_ptr[v0 + lane + 1];
    mine = general_source<T, C>(a, v0 + lane);
  }
  prefetch_l1(pos + v0 * d, static_cast<int64_t>(nv) * d, lane, 32);
  if (a.base_force != nullptr) {
    prefetch_l1(static_cast<const T*>(a.base_force) + v0 * d, static_cast<int64_t>(nv) * d, lane, 32);
  }
  // then what needs the dst: its values, and its row into L1
  GDst<T> e;
  if (lane < ne) {
    e = general_dst<T, C>(a, j, t);
    prefetch_l1(pos + static_cast<int64_t>(t) * d, d < 32 ? d : 32, 0, 1);
  }
  // the warp's next group (next >= 0): its edges' dst indices, its
  // vertices' offsets, values and rows into L1 while this one waits
  if (next >= 0) {
    const int64_t* ne_entry = a.sched + 4 * (a.heavy + a.medium + next);
    const int64_t nv0 = ne_entry[0], nbase = ne_entry[2], nnv = ne_entry[1];
    prefetch_l1(a.dst32 + nbase, ne_entry[3], lane, 32);
    prefetch_l1(a.row_ptr + nv0, nnv + 1, lane, 32);
    prefetch_l1(static_cast<const T*>(a.inv_w) + nv0, nnv, lane, 32);
    prefetch_l1(pos + nv0 * d, nnv * d, lane, 32);
    if (C != kCoverNone) {
      prefetch_l1(static_cast<const T*>(a.lwpow) + nv0, nnv, lane, 32);
      prefetch_l1(a.colors + nv0, nnv, lane, 32);
    }
  }
  const int first = owner ? static_cast<int>(lo - base) : 0;  // the vertex's first edge lane
  const int len = static_cast<int>(hi - lo);
  // the source of edge `lane`: the last vertex lane whose first edge is at
  // or before it (empty segments share their successor's first edge)
  int k = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int cand = k + step;
    const int fc = __shfl_sync(kFull, first, cand);
    if (cand < nv && fc <= lane) k = cand;
  }
  GSource<T> s;
  s.v = v0 + k;
  s.iw = __shfl_sync(kFull, mine.iw, k);
  s.lw = __shfl_sync(kFull, mine.lw, k);
  s.col = __shfl_sync(kFull, mine.col, k);
  s.blk = __shfl_sync(kFull, mine.blk, k);
  if (lane < ne) e.w = load_window<C>(a, s.blk, e.row);
  T* stage = sh.stage + warp * 32 * kStageStride;
  T* coef = sh.coef + 32 * warp;
  T* den = sh.den + 32 * warp;
  int32_t* dst = sh.dst + 32 * warp;
  bool zf;
  general_round<T, C>(a, ne, j, t, e, s, stage, coef, den, dst, tl, zf);
  const unsigned zmask = __ballot_sync(kFull, zf);
  __syncwarp();
  const bool staged = d <= LaneSlab<T>::kCols;  // the rows in the stage
  const int fw = staged ? kSlab : 32, fsub = lane / fw, fc = lane % fw;
  for (int r = 0; r < nv; r += 32 / fw) {
    const int vi = r + fsub;
    const int f = __shfl_sync(kFull, first, vi & 31);
    const int l = __shfl_sync(kFull, len, vi & 31);
    if (vi < nv) {
      const int64_t v = v0 + vi;
      for (int c = fc; c < d; c += fw) {
        write_force(a, v * d + c, staged ? fold_stage(T(0), stage, f, f + l, c)
                                         : fold_rows(a, T(0), f, f + l, base, coef, den, dst, c, pos[v * d + c]));
      }
    }
  }
  if (owner && a.zero != nullptr) {
    const unsigned span = len == 0 ? 0u : (len == 32 ? kFull : ((1u << len) - 1u) << first);
    a.zero[v0 + lane] = a.base_zero[v0 + lane] - __popc(zmask & span);
  }
}

// Medium segment v, one warp: rounds of 32 edges, each folded a lane a
// column (from the stage where the rows are staged), the sums carried from
// round to round in a register (d <= 32) or in v's output row; the last
// round adds the sweep's force.
template <typename T, int C>
__device__ void general_medium_segment(const Args& a, const int64_t* entry, const GeneralSmem<T>& sh,
                                       Tallies<T>& tl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = static_cast<int>(a.d);
  const int64_t v = entry[0], lo = entry[2], hi = lo + entry[3];
  const GSource<T> s = general_source<T, C>(a, v);
  const bool staged = d <= LaneSlab<T>::kCols;  // the rows in the stage
  const T* pos = static_cast<const T*>(a.pos);
  T* out = static_cast<T*>(a.force) + v * d;
  T* stage = sh.stage + warp * 32 * kStageStride;
  T* coef = sh.coef + 32 * warp;
  T* den = sh.den + 32 * warp;
  int32_t* dst = sh.dst + 32 * warp;
  int zc = 0;
  T acc = T(0);
  const T sp = d <= 32 && lane < d ? pos[v * d + lane] : T(0);
  // lane i's edges of the coming rounds: the dst two rounds ahead; what
  // general_dst loads of it, its row into L1 and its window, after this
  // round (a round ahead of their use)
  int32_t t = lo + lane < hi ? a.dst32[lo + lane] : 0;
  int32_t t_next = lo + 32 + lane < hi ? a.dst32[lo + 32 + lane] : 0;
  GDst<T> e;
  if (lo + lane < hi) {
    e = general_dst<T, C>(a, lo + lane, t);
    prefetch_l1(pos + static_cast<int64_t>(t) * d, d < 32 ? d : 32, 0, 1);
    e.w = load_window<C>(a, s.blk, e.row);
  }
  for (int64_t j0 = lo; j0 < hi; j0 += 32) {
    const int cnt = hi - j0 < 32 ? static_cast<int>(hi - j0) : 32;
    const int64_t jn = j0 + 32 + lane;
    const int32_t t_after = jn + 32 < hi ? a.dst32[jn + 32] : 0;
    bool zf;
    general_round<T, C>(a, cnt, j0 + lane, t, e, s, stage, coef, den, dst, tl, zf);
    GDst<T> e_next;
    if (jn < hi) {
      e_next = general_dst<T, C>(a, jn, t_next);
      prefetch_l1(pos + static_cast<int64_t>(t_next) * d, d < 32 ? d : 32, 0, 1);
      e_next.w = load_window<C>(a, s.blk, e_next.row);
    }
    t = t_next;
    t_next = t_after;
    e = e_next;
    zc += __popc(__ballot_sync(kFull, zf));
    __syncwarp();
    if (d <= 32) {  // lane c's column, its sum in a register
      if (lane < d) {
        acc = staged ? fold_stage(acc, stage, 0, cnt, lane) : fold_rows(a, acc, 0, cnt, j0, coef, den, dst, lane, sp);
      }
      continue;
    }
    for (int c = lane; c < d; c += 32) {
      const T x = fold_rows(a, j0 == lo ? T(0) : out[c], 0, cnt, j0, coef, den, dst, c,
                            pos[v * d + c]);
      if (j0 + 32 >= hi) {
        write_force(a, v * d + c, x);
      } else {
        out[c] = x;
      }
    }
  }
  if (d <= 32 && lane < d) write_force(a, v * d + lane, acc);
  if (lane == 0 && a.zero != nullptr) a.zero[v] = a.base_zero[v] - zc;
}

// Heavy segment v, the whole CTA, in chunks of 32 edges a computing warp.
// At d <= kSplitDim warps 1-7 compute chunk i (an edge a lane, heavy_row:
// its row into the chunk's buffer) while warp 0 folds
// chunk i - 1 from the other buffer (lane c column c, 16-byte loads a block
// ahead of the adds, the sum in a register): one barrier a chunk.  Wider
// rows: all 8 warps compute chunk i's coefficients, then the CTA folds it
// from the positions, a thread a column, kThreads columns at a time, the
// sums carried in v's output row.
template <typename T, int C>
__device__ void general_heavy_segment(const Args& a, const int64_t* entry, const GeneralSmem<T>& sh, Tallies<T>& tl) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = static_cast<int>(a.d);
  const int64_t v = entry[0], lo = entry[2], hi = lo + entry[3];
  const bool split = d <= kSplitDim;
  const int w0 = split ? 1 : 0;        // the first computing warp
  const int per = (kWarps - w0) * 32;  // edges a chunk: kComputeThreads when split
  const int chunks = static_cast<int>((hi - lo + per - 1) / per);
  const GSource<T> s = general_source<T, C>(a, v);  // the same addresses for every thread
  const T* pos = static_cast<const T*>(a.pos);
  T* out = static_cast<T*>(a.force) + v * d;
  T* stage = sh.stage + warp * 32 * kStageStride;
  const size_t chunk = static_cast<size_t>(d) * Heavy<T>::kStride;  // values of a chunk's rows buffer
  const int e0 = (warp - w0) * 32;  // a computing warp's first slot of a chunk
  if (split) {  // the source's row, which every lane's diffs read, in warp 0's stage
    if (tid < d) sh.stage[tid] = pos[v * d + tid];
    __syncthreads();
  }
  // a computing lane's edges of the coming chunks: the dst two chunks
  // ahead; what general_dst loads of it and its row into L1 a chunk ahead,
  // its window (once those have arrived) after this chunk
  int32_t t = 0, t_next = 0;
  GDst<T> e;
  if (warp >= w0) {
    const int64_t j = lo + e0 + lane;
    if (j < hi) t = a.dst32[j];
    if (j + per < hi) t_next = a.dst32[j + per];
    if (j < hi) {
      e = general_dst<T, C>(a, j, t);
      prefetch_l1(pos + static_cast<int64_t>(t) * d, d < 32 ? d : 32, 0, 1);
      e.w = load_window<C>(a, s.blk, e.row);
    }
  }
  T acc = T(0);
  for (int i = 0; i <= chunks; ++i) {
    if (warp >= w0 && i < chunks) {
      const int64_t j0 = lo + static_cast<int64_t>(i) * per + e0;
      const int cnt = hi - j0 <= 0 ? 0 : (hi - j0 < 32 ? static_cast<int>(hi - j0) : 32);
      const int64_t jn = j0 + per + lane;
      const int32_t t_after = jn + per < hi ? a.dst32[jn + per] : 0;
      GDst<T> e_next;
      if (jn < hi) {
        e_next = general_dst<T, C>(a, jn, t_next);
        prefetch_l1(pos + static_cast<int64_t>(t_next) * d, d < 32 ? d : 32, 0, 1);
      }
      if (cnt > 0) {
        bool zf;
        if (split) {  // an edge a lane, its row into the chunk's buffer
          zf = false;
          T* rows = sh.rows + (i & 1) * chunk + e0 + lane;
          if (lane < cnt) heavy_row<T, C>(a, j0 + lane, t, e, s, sh.stage, rows, tl, zf);
        } else {
          const int b = (i & 1) * kThreads + e0;
          general_round<T, C>(a, cnt, j0 + lane, t, e, s, stage, sh.coef + b, sh.den + b, sh.dst + b, tl, zf);
        }
        tl.zc += zf;
      }
      if (jn < hi) e_next.w = load_window<C>(a, s.blk, e_next.row);
      t = t_next;
      t_next = t_after;
      e = e_next;
    }
    if (split && warp == 0 && i > 0 && lane < d) {
      const int64_t j0 = lo + static_cast<int64_t>(i - 1) * per;
      const int cnt = hi - j0 < per ? static_cast<int>(hi - j0) : per;
      acc = fold_column(sh.rows + ((i - 1) & 1) * chunk + lane * Heavy<T>::kStride, cnt, acc);
    }
    __syncthreads();
    if (!split && i < chunks) {
      const int64_t j0 = lo + static_cast<int64_t>(i) * per;
      const int cnt = hi - j0 < per ? static_cast<int>(hi - j0) : per;
      const int b = (i & 1) * kThreads;
      for (int c = tid; c < d; c += kThreads) {
        const T x = fold_rows(a, i == 0 ? T(0) : out[c], 0, cnt, j0, sh.coef + b, sh.den + b, sh.dst + b, c,
                              pos[v * d + c]);
        if (i + 1 == chunks) {
          write_force(a, v * d + c, x);
        } else {
          out[c] = x;
        }
      }
    }
  }
  if (split && warp == 0 && lane < d) write_force(a, v * d + lane, acc);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, kGeneralCtas) segment_pass_general_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char general_smem[];
  const GeneralSmem<T> sh(general_smem);
  __shared__ bool s_last;
  Tallies<T> tl;
  const int64_t b = blockIdx.x;
  const int64_t medium_ctas = (a.medium + kWarps - 1) / kWarps;
  const int warp = threadIdx.x >> 5;
  const bool heavy = b < a.heavy;
  if (heavy) {
    general_heavy_segment<T, C>(a, a.sched + 4 * b, sh, tl);
  } else if (b < a.heavy + medium_ctas) {
    const int64_t i = (b - a.heavy) * kWarps + warp;
    if (i < a.medium) general_medium_segment<T, C>(a, a.sched + 4 * (a.heavy + i), sh, tl);
  } else {
    const int64_t g0 = ((b - a.heavy - medium_ctas) * kWarps + warp) * kLightPerWarp;
    for (int r = 0; r < kLightPerWarp && g0 + r < a.groups; ++r) {
      const int64_t g = g0 + r;
      general_light_group<T, C>(a, g, r + 1 < kLightPerWarp && g + 1 < a.groups ? g + 1 : -1, sh, tl);
    }
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
    // every CTA is past its stage: two warps' stages hold the totals' trees
    totals<T>(a, gridDim.x, sh.stage, reinterpret_cast<int64_t*>(sh.stage + 2 * 32 * kStageStride));
    if (threadIdx.x == 0) g_ctas_done = 0;
  }
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

constexpr int kMaxDevices = 64;

// Launches segment_pass_general_kernel<T, C> with the dynamic shared memory
// of width d, opting in above the default 48 KB once a device (to the most
// any width takes).
template <typename T, int C>
cudaError_t launch_general_cover(const Args& a, int device, cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  const size_t most = GeneralLayout<T>::bytes(kSplitDim);
  if (device < 0 || device >= kMaxDevices || !opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(segment_pass_general_kernel<T, C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted[device] = true;
  }
  // a CTA a heavy segment, one for every kWarps medium segments and every
  // kWarps * kLightPerWarp light groups: at most the schedule's CTAs, whose
  // slots the caller allocates
  constexpr int64_t kGroups = kWarps * kLightPerWarp;
  const unsigned ctas =
      static_cast<unsigned>(a.heavy + (a.medium + kWarps - 1) / kWarps + (a.groups + kGroups - 1) / kGroups);
  segment_pass_general_kernel<T, C><<<ctas, kThreads, GeneralLayout<T>::bytes(a.d), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_general(const Args& a, int device, cudaStream_t stream) {
  if (a.mode == kAttraction) return launch_general_cover<T, kCoverNone>(a, device, stream);
  if (a.layout == kWindows) return launch_general_cover<T, kCoverWindows>(a, device, stream);
  return launch_general_cover<T, kCoverCells>(a, device, stream);
}

}  // namespace wembed_edge

extern "C" {

int wembed_edge_pass_block() { return wembed_edge::kThreads; }

int wembed_edge_pass_tile() { return wembed_edge::kST; }

int wembed_edge_pass_light() { return wembed_edge::kLight; }

int wembed_edge_pass_warps() { return wembed_edge::kWarps; }

int wembed_edge_pass_max_fast_dim() { return wembed_edge::kMaxFastDim; }

int wembed_edge_pass_slab() { return wembed_edge::kSlab; }

int wembed_edge_pass_split_dim() { return wembed_edge::kSplitDim; }

const char* wembed_edge_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one edge pass on `stream`, in f64 when `f64` is set, else f32,
// and returns the first launch error.  Allocates nothing and does not
// synchronise; every buffer comes from the caller (kernels/edge_pass.py:
// edge_pass).  One launch over the schedule (`sched`, `dst32`, `heavy`,
// `medium`, `groups`), `part_loss` and `part_count` holding one slot a
// CTA, heavy + ceil(medium / 8) + ceil(groups / 8): segment_pass_kernel
// at d <= 8, segment_pass_general_kernel above.
int wembed_edge_pass(const wembed_edge::Args* args, int f64, int device, void* stream) {
  using namespace wembed_edge;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args& a = *args;
  const bool span = a.mode != kAttraction;
  if (a.n < 1 || a.d < 1 || a.E < 0 || a.mode < kFused || a.mode > kAttraction ||
      (span && (a.zero == nullptr || a.base_zero == nullptr)) ||
      (a.mode != kCorrection && a.E > 0 && a.kicks == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.sched == nullptr || a.dst32 == nullptr || a.heavy < 0 || a.medium < 0 || a.groups < 0 ||
      a.heavy + a.medium + a.groups < 1 ||
      a.heavy + (a.medium + kWarps - 1) / kWarps + (a.groups + kWarps - 1) / kWarps > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d <= kMaxFastDim) {
    err = f64 ? launch_fast<double>(a, s) : launch_fast<float>(a, s);
  } else {
    err = f64 ? launch_general<double>(a, device, s) : launch_general<float>(a, device, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
