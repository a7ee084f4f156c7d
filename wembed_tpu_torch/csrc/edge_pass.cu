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
// and the edge's row is coeff * diff_k, or its kick row where dist2 == 0
// (fused and attraction).  Coverage: the windowed layout's window of s's
// block on t's row (start_tile, blk_t), or the cell layout's window of
// s's block on t's cell cut at the block's capacity (start, stop, prefix,
// blk_t): kernels/span_sparse.py:SpanStructures.covers and
// kernels/span_compact.py:CellStructures.covers.
//
// Two kernels.  edge_pass_kernel: one thread an edge computes the edge's
// row and writes it (coalesced) with a flag for a counted coincident
// neighbour, and each CTA sums its edges' losses and counts in a fixed
// tree.  edge_segment_kernel: each vertex's rows summed in edge order from
// 0, as torch.segment_reduce sums a 2-D tensor (one thread a (segment,
// column), a left fold), then added to the sweep's force; the sweep's zero
// counts less the flags; the first CTA adds the per-CTA partials in a
// fixed order.  The fold is sequential by definition, and the girg100k
// graphs are power-law (one vertex of ~10,000 edges): a thread walking
// such a segment through device memory waits a load latency every few
// edges.  So a segment of more than kLight edges is summed by the whole
// CTA of its first column: its rows are staged kChunk values at a time
// into shared memory by every thread (coalesced, many loads in flight)
// and folded from there by one thread a column, the next chunk's loads in
// flight meanwhile; a row wider than kThreads is folded in slabs of
// kThreads columns, each a walk of the segment.
//
// What bounds it on an H100: bytes.  Read once, the inputs are an edge's
// two indices, radius factor and kick row (20 B + d T) and the per-vertex
// tables; at girg100k d = 4 (E = 1.39M, f32) about 60 MB with the
// outputs, 0.018 ms at 3.35 TB/s (chip_smoke.py:edge_pass_bound).  The
// kernel moves more: each edge gathers its endpoints' rows, inverse
// weights, colours, ranks, rows and blocks and one window entry, from
// tables that stay in the 50 MB L2, and writes its row (d T) to be read
// back once by the fold.  The work per edge is a few dozen operations.

#include <cuda_runtime.h>

#include <cstdint>

namespace wembed_edge {

constexpr int kThreads = 256;  // threads of a CTA
constexpr int kST = 256;       // members per sweep tile (kernels/span_sweep.py ST)
constexpr int kLight = 32;     // longest segment a thread folds alone
constexpr int kChunk = 2048;   // staged values of a long segment, at least 8 edges' slabs of kThreads columns
constexpr int kPer = kChunk / kThreads;  // of which each thread loads
constexpr double kMinDist = 1e-30;  // torch.clamp_min(dist, 1e-30) in the plain version

enum Mode { kFused = 0, kCorrection = 1, kAttraction = 2 };
enum Layout { kWindows = 0, kCells = 1 };

// Mirrors kernels/edge_pass.py:_Args; every field is 8 bytes.
struct Args {
  const void* pos;           // (n, d) T
  const void* inv_w;         // (n,) T
  const int64_t* src;        // (E,) source of each edge, ascending
  const int64_t* dst;        // (E,)
  const int64_t* row_ptr;    // (n + 1,) each vertex's edges, offsets into [0, E)
  const void* kicks;         // (E, d) T: fused, attraction
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
  void* net;                 // scratch (E, d) T each edge's row
  uint8_t* zflag;            // scratch (E,) counted coincident neighbours: span modes
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
  double L, L2, att_scale, rep_scale;  // rounded to T where they are used
};

__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }

// torch.clamp_min: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

// Whether the sweep of s's query block visits member t.
__device__ __forceinline__ bool covered(const Args& a, int64_t s, int64_t t) {
  const int64_t blk = a.block_of[s * a.block_stride];
  const int64_t row = a.row_of[t * a.row_stride];
  const int64_t rank = a.rank_of[t * a.rank_stride];
  if (a.layout == kWindows) {
    const int64_t lo = static_cast<int64_t>(a.start_tile[blk * a.tile_s0 + row * a.tile_s1]) * kST;
    const int64_t hi = lo + static_cast<int64_t>(a.blk_t[blk * a.blk_s0 + row * a.blk_s1]) * kST;
    return rank >= lo && rank < hi;
  }
  const int64_t lo = a.start[blk * a.start_s0 + row * a.start_s1];
  return rank >= lo && rank < a.stop[blk * a.stop_s0 + row * a.stop_s1] &&
         a.prefix[blk * a.prefix_s0 + row * a.prefix_s1] + (rank - lo) <
             static_cast<int64_t>(a.blk_t[blk * a.blk_s0]) * kST;
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
      if (included) included = covered(a, s, t);
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
      for (int k = 0; k < d; ++k) row[k] = kick[k];
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

// The per-CTA partials of edge_pass_kernel added by one CTA: each thread
// a strided run in order, then a fixed tree.
template <typename T>
__device__ void totals(const Args& a, T* s_loss, int64_t* s_count) {
  const int64_t parts = (a.E + kThreads - 1) / kThreads;
  const T* part = static_cast<const T*>(a.part_loss);
  T att = T(0), closs = T(0);
  int64_t inc = 0;
  for (int64_t i = threadIdx.x; i < parts; i += kThreads) {
    att = att + part[2 * i];
    closs = closs + part[2 * i + 1];
    inc += a.part_count[i];
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
    if (threadIdx.x < w) {
      const int64_t o = v * d + c + threadIdx.x;
      const T* base = static_cast<const T*>(a.base_force);
      static_cast<T*>(a.force)[o] = base != nullptr ? base[o] + acc : acc;
    }
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
      const T* base = static_cast<const T*>(a.base_force);
      static_cast<T*>(a.force)[g] = base != nullptr ? base[g] + acc : acc;
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
  if (blockIdx.x == 0) totals(a, s_loss, s_count);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
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

const char* wembed_edge_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one edge pass (both kernels) on `stream`, in f64 when `f64` is
// set, else f32, and returns the first launch error.  Allocates nothing
// and does not synchronise; every buffer comes from the caller
// (kernels/edge_pass.py:edge_pass): `part_loss` and `part_count` hold
// ceil(E / 256) CTAs' partials, at least one.
int wembed_edge_pass(const wembed_edge::Args* args, int f64, int device, void* stream) {
  using namespace wembed_edge;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args& a = *args;
  const bool span = a.mode != kAttraction;
  if (a.n < 1 || a.d < 1 || a.E < 0 || a.mode < kFused || a.mode > kAttraction ||
      (a.n * a.d + kThreads - 1) / kThreads > INT32_MAX || (a.E + kThreads - 1) / kThreads > INT32_MAX ||
      (span && (a.zflag == nullptr || a.zero == nullptr || a.base_zero == nullptr)) ||
      (a.mode != kCorrection && a.E > 0 && a.kicks == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = f64 ? launch<double>(a, s) : launch<float>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
