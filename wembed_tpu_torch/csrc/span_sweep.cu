// Span sweep kernel for Hopper (sm_90a): the repulsion candidate sweep of
// the span path, query blocks of 256 vertices against the member tiles of
// their candidate windows.
//
// Replaces the TPU kernel wembed_tpu/kernels/span_sparse.py:_span_kernel
// and _span_kernel_packed (both bodies are _span_tile_body; launched by
// sweep_work_tiles through the pl.pallas_call sites at span_sparse.py:1735
// and :1784).  For every (query slot q, window member s) pair it computes
// what that body computes:
//   dist2  = sum_k (q[k] - s[k])^2, per-dimension differences in ascending k
//   valid  = dist2 <= lw_q^2 * bm2_s  (per-class radius)  &&  col_q != col_s
//   ws     = invw_q * invw_s (or invw_q + invw_s, additive weights)
//   active = valid && dist2 * ws^2 <= L^2 && dist2 > 0
//   coeff  = rep_scale * ws / dist,   loss += L/ws - dist   (active pairs)
// and per query slot: force = sum coeff * (q - s), the loss, the candidate
// count (valid pairs) and the coincident count (valid pairs at dist2 == 0).
// The TPU forms the force as q * rowsum - coeff @ S on the matrix unit,
// two large terms that cancel; here the d products are summed directly.
// L/ws is L * rawexp_q * rawexp_s with rawexp = 1/invw (multiplicative
// weights), as the TPU kernel forms it.  The inverse distance is IEEE
// 1.0f / sqrtf(dist2) (the TPU takes rsqrt and one Newton step); the masks
// do not depend on it.  The radius test multiplies the same two f32
// channels that the edge pass (kernels/span_sparse.py:_edge_terms)
// multiplies, so that pass cancels exactly the neighbour pairs counted here.
//
// The masks must agree bit for bit with the plain PyTorch twin
// (kernels/span_sweep.py:span_sweep_reference), so this file is compiled
// with --fmad=false and never with --use_fast_math.
//
// Work layout.  The windows of query block i are the tiles
// start_tile[i, g] ... start_tile[i, g] + blk_t[i, g] - 1 of every row g with
// blk_t[i, g] > 0, in block-major order.  A host-built table cuts each
// block's tiles into WORK ITEMS of at most K tiles (kernels/span_sweep.py:
// work_items): (block, first row g, tiles to skip in row g's window,
// tiles).  One CTA takes one item and walks the windows from there with
// this step's start_tile.  The heaviest weight group's blocks reach every
// row (393 tiles at girg100k against a mean of 50), so one CTA a block ran
// as long as its longest block; items of <= K tiles spread that work over
// the whole card.  The same work-list form serves the cells layout and
// the halo sweep, which walk their own tile lists.
//
// Inside an item: 256 threads, each holding QPT query slots in registers
// and sweeping one of QPT member phases (a contiguous quarter of the tile
// at d <= 4), so each shared-memory member read serves QPT pairs.  Member
// records are staged as [pos(d), invw, bm2, rawexp, colour] padded to a
// multiple of 4 floats and read as float4; the next tile is copied with
// cp.async while the current one is swept (one barrier a tile).  The rare
// path (valid pairs, ~1% at girg100k) holds the sqrt and the division.
// At the end of an item the phases' sums are added in phase order through
// shared memory and written to a per-item scratch buffer; a second kernel
// adds each block's items in item order.  No atomics: deterministic.
//
// What bounds it on an H100: FP32 work.  Every pair costs d subtractions,
// d multiplies, d - 1 adds, the radius product and its compare (3d + 1
// FLOP); a valid pair ~14 more, with a sqrt and a division.  girg100k d=2
// at iteration 20: 11,853 tiles = 776.8M pairs x 7 FLOP plus ~9.6M valid
// pairs x 14, 5.6 GFLOP, 0.083 ms at 67 TFLOP/s.  The bytes (query and
// member records, the tables) are a few MB: ~2 us at 3.35 TB/s.
//
// The general kernel, span_sweep_general_kernel<T>, runs what the fast one
// does not take: f32 at d > kMaxDim and f64 at any d, over the same work
// items and the same per-item scratch layout.  The record width is a
// run-time value, so nothing is staged: one thread a query slot reads its
// query record and each member record (the same address across the CTA)
// straight from device memory through L1, and adds each active pair's
// coeff * diff into its slot's scratch column in member order.  Counts go
// through the scratch as T (at most 4 x 256 pairs an item, exact in f32).
// span_reduce_general_kernel<T> adds each block's items in item order.
//
// One rank's share of the replicated multi-device step is a contiguous
// slice items[lo:hi] of the table: a block with no items in the slice gets
// zeros from the reduction, so the slice sweeps exactly that share.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 256;        // query slots per block
constexpr int kST = 256;       // members per tile
constexpr int kThreads = 256;  // threads per item CTA
constexpr int kMaxDim = 8;

static_assert(kThreads == kQ, "the item epilogue gives each thread one slot");

template <int D>
struct Cfg {
  static constexpr int C = D + 3;                    // record channels in global memory
  static constexpr int P = (D + 4 + 3) / 4 * 4;      // staged floats a member (+ colour), float4-padded
  static constexpr int QPT = D <= 4 ? 4 : 2;         // query slots a thread
  static constexpr int SG = kQ / QPT;                // threads sharing a member phase
  static constexpr int MG = kThreads / SG;           // member phases
  static constexpr int MPP = kST / MG;               // members a phase sweeps
  static constexpr int kStage = 2 * kST * P;         // two staging buffers (floats)
  static constexpr int kRed = MG * C * kQ;           // epilogue partials (words)
  static constexpr int kSmem = kStage > kRed ? kStage : kRed;
  static_assert(SG % 32 == 0, "a warp must share one member phase");
};

struct Params {
  const float* qrec;       // (nb * kQ, D + 3): pos(D), invw, lw^2, rawexp
  const int* qcol;         // (nb * kQ,)
  const float* srec;       // (tiles * kST, D + 3): pos(D), invw, bm2, rawexp
  const int* scol;         // (tiles * kST,)
  const int* blk_t;        // (nb, R) window widths in tiles
  const int* start_tile;   // (nb, R) first tile of each window, row-local
  const int* tile_off;     // (R,) first tile of each row's padded range
  const int4* items;       // (n_items,) block, first row, tiles to skip, tiles
  int n_items;
  int R;
  float L;
  float L2;
  float rep_scale;
  int additive;
  float* scratch;          // (n_items, D + 3, kQ): force(D), loss, count, zero
  float* force;            // out (nb * kQ, D)
  float* loss;             // out (nb * kQ,)
  int* count;              // out (nb * kQ,)
  int* zero;               // out (nb * kQ,)
};

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies member tile `tile` into `buf` as [pos(D), invw, bm2, rawexp, colour]
// records of P floats.
template <int D>
__device__ __forceinline__ void stage_tile(const Params& p, float* buf, int tile) {
  using K = Cfg<D>;
  const float* src = p.srec + (size_t)tile * kST * K::C;
  for (int e = threadIdx.x; e < kST * K::C; e += kThreads) {
    const int m = e / K::C;
    cp_async4(buf + m * K::P + (e - m * K::C), src + e);
  }
  cp_async4(buf + threadIdx.x * K::P + K::C, p.scol + (size_t)tile * kST + threadIdx.x);
  cp_async_commit();
}

// The walk over one item's tiles: row g, tile t of that row's window.
struct Walk {
  int blk, g, t, width, base;

  template <class P>
  __device__ void load_row(const P& p) {
    width = p.blk_t[blk * p.R + g];
    base = p.tile_off[g] + p.start_tile[blk * p.R + g];
  }

  __device__ int tile() const { return base + t; }

  template <class P>
  __device__ void next(const P& p) {
    if (++t < width) return;
    t = 0;
    do {
      ++g;
    } while (g < p.R && p.blk_t[blk * p.R + g] <= 0);
    if (g < p.R) load_row(p);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2) span_sweep_kernel(Params p) {
  using K = Cfg<D>;
  constexpr int C = K::C, P = K::P, QPT = K::QPT, SG = K::SG, MPP = K::MPP;
  __shared__ __align__(16) float smem[K::kSmem];

  const int4 item = p.items[blockIdx.x];
  const int tid = threadIdx.x;
  const int sg = tid % SG;
  const int mp = tid / SG;  // uniform across a warp

  float q[QPT][C];
  int qc[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const size_t slot = (size_t)item.x * kQ + sg + j * SG;
#pragma unroll
    for (int c = 0; c < C; ++c) q[j][c] = p.qrec[slot * C + c];
    qc[j] = p.qcol[slot];
  }
  float acc[QPT][D];
  float lsum[QPT];
  int cnt[QPT], zc[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[j][k] = 0.0f;
    lsum[j] = 0.0f;
    cnt[j] = 0;
    zc[j] = 0;
  }

  Walk walk{item.x, item.y, item.z, 0, 0};
  walk.load_row(p);
  stage_tile<D>(p, smem, walk.tile());

  for (int i = 0; i < item.w; ++i) {
    float* buf = smem + (i & 1) * (kST * P);
    cp_async_wait_all();
    __syncthreads();  // tile i is in place; every thread is done with tile i - 1
    if (i + 1 < item.w) {
      walk.next(p);
      stage_tile<D>(p, smem + ((i + 1) & 1) * (kST * P), walk.tile());
    }

    const float4* rec = reinterpret_cast<const float4*>(buf + mp * MPP * P);
#pragma unroll 2
    for (int m = 0; m < MPP; ++m) {
      float r[P];
#pragma unroll
      for (int v = 0; v < P / 4; ++v) {
        const float4 x = rec[m * (P / 4) + v];
        r[4 * v] = x.x;
        r[4 * v + 1] = x.y;
        r[4 * v + 2] = x.z;
        r[4 * v + 3] = x.w;
      }
      const int sc = __float_as_int(r[C]);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        float diff[D];
        float dist2 = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = q[j][k] - r[k];
          dist2 = dist2 + diff[k] * diff[k];
        }
        if (!((dist2 <= q[j][D + 1] * r[D + 1]) && (qc[j] != sc))) continue;
        // the rare path: a candidate
        ++cnt[j];
        if (!(dist2 > 0.0f)) {
          ++zc[j];
          continue;
        }
        const float ws = p.additive ? q[j][D] + r[D] : q[j][D] * r[D];
        if (!(dist2 * (ws * ws) <= p.L2)) continue;
        const float dist = sqrtf(dist2);
        const float inv = 1.0f / dist;
        const float coeff = p.rep_scale * ws * inv;
#pragma unroll
        for (int k = 0; k < D; ++k) acc[j][k] = acc[j][k] + coeff * diff[k];
        const float l_over_ws = p.additive ? p.L / ws : (p.L * q[j][D + 2]) * r[D + 2];
        lsum[j] = lsum[j] + (l_over_ws - dist);
      }
    }
  }

  // the phases' partial sums, added in phase order; smem is free once every
  // thread has swept the last tile
  __syncthreads();
  int* smem_i = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int slot = sg + j * SG;
    const int o = mp * C * kQ + slot;
#pragma unroll
    for (int k = 0; k < D; ++k) smem[o + k * kQ] = acc[j][k];
    smem[o + D * kQ] = lsum[j];
    smem_i[o + (D + 1) * kQ] = cnt[j];
    smem_i[o + (D + 2) * kQ] = zc[j];
  }
  __syncthreads();
  float* out = p.scratch + (size_t)blockIdx.x * C * kQ + tid;
#pragma unroll
  for (int c = 0; c < D + 1; ++c) {
    float s = smem[c * kQ + tid];
#pragma unroll
    for (int ph = 1; ph < K::MG; ++ph) s = s + smem[(ph * C + c) * kQ + tid];
    out[c * kQ] = s;
  }
#pragma unroll
  for (int c = D + 1; c < C; ++c) {
    int s = smem_i[c * kQ + tid];
#pragma unroll
    for (int ph = 1; ph < K::MG; ++ph) s += smem_i[(ph * C + c) * kQ + tid];
    out[c * kQ] = __int_as_float(s);
  }
}

// Adds each query block's items in item order (the table is block-major);
// a block without items gets zeros.  One CTA a block, one thread a slot.
template <int D>
__global__ void __launch_bounds__(kQ) span_reduce_kernel(Params p) {
  constexpr int C = D + 3;
  const int blk = blockIdx.x;
  const int slot = threadIdx.x;
  int lo = 0, hi = p.n_items;  // first item of this block
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (p.items[mid].x < blk) lo = mid + 1; else hi = mid;
  }
  float acc[D + 1];
#pragma unroll
  for (int c = 0; c <= D; ++c) acc[c] = 0.0f;
  int cnt = 0, zc = 0;
  for (int it = lo; it < p.n_items && p.items[it].x == blk; ++it) {
    const float* src = p.scratch + (size_t)it * C * kQ + slot;
#pragma unroll
    for (int c = 0; c <= D; ++c) acc[c] = acc[c] + src[c * kQ];
    cnt += __float_as_int(src[(D + 1) * kQ]);
    zc += __float_as_int(src[(D + 2) * kQ]);
  }
  const size_t s = (size_t)blk * kQ + slot;
#pragma unroll
  for (int k = 0; k < D; ++k) p.force[s * D + k] = acc[k];
  p.loss[s] = acc[D];
  p.count[s] = cnt;
  p.zero[s] = zc;
}

template <int D>
cudaError_t launch(const Params& p, int nb, cudaStream_t stream) {
  if (p.n_items > 0) {
    span_sweep_kernel<D><<<p.n_items, kThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  span_reduce_kernel<D><<<nb, kQ, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- general

template <typename T>
struct GeneralParams {
  const T* qrec;           // (nb * kQ, d + 3)
  const int* qcol;
  const T* srec;           // (tiles * kST, d + 3)
  const int* scol;
  const int* blk_t;
  const int* start_tile;
  const int* tile_off;
  const int4* items;
  int n_items;
  int R;
  int d;
  T L;
  T L2;
  T rep_scale;
  int additive;
  T* scratch;              // (n_items, d + 3, kQ): force(d), loss, count, zero
  T* force;                // out (nb * kQ, d)
  T* loss;                 // out (nb * kQ,)
  int* count;              // out (nb * kQ,)
  int* zero;               // out (nb * kQ,)
};

__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) span_sweep_general_kernel(GeneralParams<T> p) {
  const int4 item = p.items[blockIdx.x];
  const int d = p.d;
  const int C = d + 3;
  const size_t qslot = (size_t)item.x * kQ + threadIdx.x;
  const T* q = p.qrec + qslot * C;
  const int qc = p.qcol[qslot];
  const T q_iw = q[d];
  const T q_lw2 = q[d + 1];
  const T q_raw = q[d + 2];
  T* out = p.scratch + (size_t)blockIdx.x * C * kQ + threadIdx.x;  // channel c at out[c * kQ]
  for (int k = 0; k < d; ++k) out[k * kQ] = T(0);
  T lsum = T(0);
  int cnt = 0, zc = 0;

  Walk walk{item.x, item.y, item.z, 0, 0};
  walk.load_row(p);
  for (int i = 0; i < item.w; ++i) {
    if (i > 0) walk.next(p);
    const size_t first = (size_t)walk.tile() * kST;
    for (int m = 0; m < kST; ++m) {
      const T* s = p.srec + (first + m) * C;
      T dist2 = T(0);
      for (int k = 0; k < d; ++k) {
        const T diff = q[k] - s[k];
        dist2 = dist2 + diff * diff;
      }
      if (!((dist2 <= q_lw2 * s[d + 1]) && (qc != p.scol[first + m]))) continue;
      // the rare path: a candidate
      ++cnt;
      if (!(dist2 > T(0))) {
        ++zc;
        continue;
      }
      const T ws = p.additive ? q_iw + s[d] : q_iw * s[d];
      if (!(dist2 * (ws * ws) <= p.L2)) continue;
      const T dist = ieee_sqrt(dist2);
      const T inv = T(1) / dist;
      const T coeff = p.rep_scale * ws * inv;
      for (int k = 0; k < d; ++k) out[k * kQ] = out[k * kQ] + coeff * (q[k] - s[k]);
      const T l_over_ws = p.additive ? p.L / ws : (p.L * q_raw) * s[d + 2];
      lsum = lsum + (l_over_ws - dist);
    }
  }
  out[d * kQ] = lsum;
  out[(d + 1) * kQ] = static_cast<T>(cnt);
  out[(d + 2) * kQ] = static_cast<T>(zc);
}

// Adds each query block's items in item order; a block without items gets
// zeros.  One CTA a block, one thread a slot.
template <typename T>
__global__ void __launch_bounds__(kQ) span_reduce_general_kernel(GeneralParams<T> p) {
  const int blk = blockIdx.x;
  const int slot = threadIdx.x;
  const int d = p.d;
  const int C = d + 3;
  int lo = 0, hi = p.n_items;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (p.items[mid].x < blk) lo = mid + 1; else hi = mid;
  }
  int end = lo;
  while (end < p.n_items && p.items[end].x == blk) ++end;
  const size_t s = (size_t)blk * kQ + slot;
  for (int c = 0; c <= d; ++c) {
    T acc = T(0);
    for (int it = lo; it < end; ++it) acc = acc + p.scratch[((size_t)it * C + c) * kQ + slot];
    if (c < d) p.force[s * d + c] = acc; else p.loss[s] = acc;
  }
  int cnt = 0, zc = 0;
  for (int it = lo; it < end; ++it) {
    cnt += static_cast<int>(p.scratch[((size_t)it * C + d + 1) * kQ + slot]);
    zc += static_cast<int>(p.scratch[((size_t)it * C + d + 2) * kQ + slot]);
  }
  p.count[s] = cnt;
  p.zero[s] = zc;
}

template <typename T>
cudaError_t launch_general(const GeneralParams<T>& p, int nb, cudaStream_t stream) {
  if (p.n_items > 0) {
    span_sweep_general_kernel<T><<<p.n_items, kThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  span_reduce_general_kernel<T><<<nb, kQ, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t general(const void* qrec, const int* qcol, const void* srec, const int* scol,
                    const int* blk_t, const int* start_tile, const int* tile_off,
                    const int* items, int n_items, int nb, int R, int dim, double L,
                    double rep_scale, int additive, void* scratch, void* force, void* loss,
                    int* count, int* zero, cudaStream_t stream) {
  GeneralParams<T> p;
  p.qrec = static_cast<const T*>(qrec);
  p.qcol = qcol;
  p.srec = static_cast<const T*>(srec);
  p.scol = scol;
  p.blk_t = blk_t;
  p.start_tile = start_tile;
  p.tile_off = tile_off;
  p.items = reinterpret_cast<const int4*>(items);
  p.n_items = n_items;
  p.R = R;
  p.d = dim;
  p.L = static_cast<T>(L);
  p.L2 = static_cast<T>(L * L);
  p.rep_scale = static_cast<T>(rep_scale);
  p.additive = additive;
  p.scratch = static_cast<T*>(scratch);
  p.force = static_cast<T*>(force);
  p.loss = static_cast<T*>(loss);
  p.count = count;
  p.zero = zero;
  return launch_general<T>(p, nb, stream);
}

}  // namespace

extern "C" {

int wembed_span_sweep_block() { return kQ; }

int wembed_span_sweep_tile() { return kST; }

int wembed_span_sweep_max_dim() { return kMaxDim; }

const char* wembed_span_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues the sweep (the item kernel, then the per-block reduction) on
// `stream` and returns the first launch error.  Allocates nothing and does
// not synchronise; every buffer comes from the caller.  `scratch` holds
// n_items * (dim + 3) * 256 words; `items` is the block-major work-item
// table of these blk_t (kernels/span_sweep.py:work_items).
int wembed_span_sweep(const float* qrec, const int* qcol, const float* srec,
                      const int* scol, const int* blk_t, const int* start_tile,
                      const int* tile_off, const int* items, int n_items, int nb, int R,
                      int dim, double L, double rep_scale, int additive, float* scratch,
                      float* force, float* loss, int* count, int* zero, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || R < 1 || n_items < 0 || dim < 1 || dim > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.qrec = qrec;
  p.qcol = qcol;
  p.srec = srec;
  p.scol = scol;
  p.blk_t = blk_t;
  p.start_tile = start_tile;
  p.tile_off = tile_off;
  p.items = reinterpret_cast<const int4*>(items);
  p.n_items = n_items;
  p.R = R;
  p.L = static_cast<float>(L);
  p.L2 = static_cast<float>(L * L);  // as the TPU kernel: L*L in double, compared in f32
  p.rep_scale = static_cast<float>(rep_scale);
  p.additive = additive;
  p.scratch = scratch;
  p.force = force;
  p.loss = loss;
  p.count = count;
  p.zero = zero;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: err = launch<1>(p, nb, s); break;
    case 2: err = launch<2>(p, nb, s); break;
    case 3: err = launch<3>(p, nb, s); break;
    case 4: err = launch<4>(p, nb, s); break;
    case 5: err = launch<5>(p, nb, s); break;
    case 6: err = launch<6>(p, nb, s); break;
    case 7: err = launch<7>(p, nb, s); break;
    case 8: err = launch<8>(p, nb, s); break;
  }
  return static_cast<int>(err);
}

// Enqueues the general sweep (records, scratch and outputs in f64 when
// `f64` is set, else f32; any dim >= 1) on `stream`, with the buffers of
// wembed_span_sweep: `scratch` holds n_items * (dim + 3) * 256 values.
int wembed_span_sweep_general(const void* qrec, const int* qcol, const void* srec,
                              const int* scol, const int* blk_t, const int* start_tile,
                              const int* tile_off, const int* items, int n_items, int nb, int R,
                              int dim, int f64, double L, double rep_scale, int additive,
                              void* scratch, void* force, void* loss, int* count, int* zero,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || R < 1 || n_items < 0 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    err = general<double>(qrec, qcol, srec, scol, blk_t, start_tile, tile_off, items, n_items,
                          nb, R, dim, L, rep_scale, additive, scratch, force, loss, count, zero, s);
  } else {
    err = general<float>(qrec, qcol, srec, scol, blk_t, start_tile, tile_off, items, n_items,
                         nb, R, dim, L, rep_scale, additive, scratch, force, loss, count, zero, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
