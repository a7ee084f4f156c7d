// The span structures build for Hopper (sm_90a): the principal axes, the
// records and the windows of one step, in three launches.
//
// Not a port of a TPU kernel.  The JAX package builds the span structures
// as plain jnp, which XLA fuses into one program
// (wembed_tpu/kernels/span_sparse.py:917 build_span_structures, its
// projections from wembed_tpu/core/candidates.py:409 _power_iteration and
// :429 _principal_axes2).  The port's plain versions are in
// kernels/span_build.py (principal_axes_reference, span_records_reference,
// span_windows_reference), and every operation here repeats one of their
// torch operations, in their order and rounding: each multiply, add,
// division and sqrt rounded alone (--fmad=false, IEEE division and sqrt),
// so each kernel is bitwise its plain version.
//
// principal_axes_kernel<T, K> (K = 2, or 3 for the cell layout), ONE CTA:
// the first K principal axes of a (d, d) covariance by power iteration,
// 12 steps an axis from the perturbed all-ones start
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
// products are one thread's k-ordered fold (d is 1 ... 16 on the port's
// main paths; the axes and one row live in shared memory, opted in past
// 48 KB, so d reaches ~7,000 in f64).
//
// span_records_kernel<T, D> (D = 1 ... 8, 0 for any d): one thread a slot
// of the three layouts the sweep and the edge pass read, gathered through
// the step's permutation `order` (sorted rank -> vertex):
//   query slot q  (NQ = NB * 256)  r = src_of_q[q]:
//       qrec[q] = [pos[v], iw[v], lw[v] * lw[v], 1 / iw[v]], qcol[q] = col[v]
//       with v = order[r], or the query sentinel [+1e15 ..., 1, 0, 0], -2
//       where r = n (padding);
//   member slot p (NPA)            r = src_of_pad[p]:
//       srec[p] = [pos[v], iw[v], bm2[v], 1 / iw[v]], scol[p] = col[v]
//       (a vertex outside a partial index: position -1e15, bm2 0), or the
//       member sentinel [-1e15 ..., 1, 0, 0], -3;
//   sorted rank j (n)              v = order[j]:
//       the inverse maps inv[v] = [j - sorted_moff[j], (j + shift_q[j]) /
//       256, j + shift_q[j], row_of_sorted[j]] (rank in its row, query
//       block, query slot, row) and the sorted values x[v], y[v], lw[v]
//       that the windows read.
// Every output is a copy, or one 1 / x or x * x rounded alone.
//
// span_windows_kernel<T>: one CTA a query block b.  Its extrema: minx and
// maxx at the static ranks blk_first[b] and blk_last[b] of the sorted
// second-axis values, maxlw and the first-axis ymin / ymax over its 256
// slots (padding counts 0, and is left out of ymin / ymax); then a thread
// a target row r: reach = maxlw * bmax[r], overlap of the first-axis
// ranges, and two binary searches over row r's own segment of the sorted
// second-axis values, read as padded to the longest row with +inf, which
// is what torch.searchsorted(side="left" / "right") sees in the plain
// version's (R, max row size) matrix.  Then the window's start tile, the
// members it needs and its overflow, in int64.  The block's overflow goes
// to a slot of `part`; the last CTA to finish (a device counter, which it
// resets for the next launch or graph replay) adds the slots: integers,
// so the total is exact in any order.
//
// What bounds the build on an H100: bytes.  Read once, the positions,
// inverse weights, radius factors, colours, lw and the permutations;
// written once, the records (NQ + NPA rows of d + 3 values), the colours,
// the inverse maps (4 x 8 bytes a vertex), the sorted values and the
// (NB, R) window tables.  The records kernel gathers a vertex's row
// through `order` (random rows, from L2); the windows kernel's searches
// are ~log2(row) dependent loads a window.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace wembed_build {

constexpr int kThreads = 256;  // threads of a CTA
constexpr int kQ = 256;        // query slots a block (kernels/span_sweep.py Q)
constexpr int kST = 256;       // members a tile (kernels/span_sweep.py ST)
constexpr int kMaxFastDim = 8; // span_records_kernel's widest templated row
constexpr int kMaxAxes = 3;
constexpr double kQSentinel = 1e15;   // padded query position (kernels/span_build.py _Q_SENTINEL)
constexpr double kSSentinel = -1e15;  // padded member position (_S_SENTINEL)

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
  const void* inv_w;             // (n,) T
  const void* lwpow;             // (n,) T  L * w^(1/d)
  const int32_t* colors;         // (n,)
  const float* class_bm2;        // (n,) radius factor of each vertex's class
  const uint8_t* in_index;       // (n,) bool, or null for a whole index
  const void* x;                 // (n,) T second-axis projection (d = 1: the first)
  const void* y;                 // (n,) T first-axis projection
  const int64_t* src_of_q;       // (NQ,) query slot -> sorted rank, n = padding
  const int64_t* src_of_pad;     // (NPA,) member slot -> sorted rank, n = padding
  const int64_t* sorted_shift_q; // (n,) query offset less member offset of each rank's row
  const int64_t* sorted_moff;    // (n,) member offset of each rank's row
  const int64_t* row_of_sorted;  // (n,) row of each rank
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
  const int64_t* src_of_q; // (NB * 256,) query slot -> sorted rank, n = padding
  const int64_t* blk_first;  // (NB,) first sorted rank of each block
  const int64_t* blk_last;   // (NB,) last sorted rank of each block
  const int64_t* row_lo;     // (R,) first sorted rank of each row
  const int64_t* row_hi;     // (R,) last sorted rank of each row
  const int64_t* row_tiles;  // (R,) tiles of each row
  const float* bmax_row;     // (R,) bmax^(1/d) of each row's group
  const int32_t* blk_t;      // (NB, R) window widths in tiles
  int32_t* start_tile;       // (NB, R) out
  int64_t* need;             // (NB, R) out
  int64_t* part;             // (NB,) scratch: each block's overflow
  int64_t* overflow;         // (1,) out
  int64_t n, nb, r, max_row;
};

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) span_records_kernel(const RecordsArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t d = dim_of<D>(a.d);
  const int64_t width = d + 3;
  const int64_t n = a.n;
  const T* pos = static_cast<const T*>(a.pos);
  const T* iw = static_cast<const T*>(a.inv_w);
  if (t < a.nq) {  // a query slot
    const int64_t r = a.src_of_q[t];
    T* row = static_cast<T*>(a.qrec) + t * width;
    if (r == n) {
      write_record<T, D>(row, pos, d, false, static_cast<T>(kQSentinel), T(1), T(0), T(0));
      a.qcol[t] = -2;
      return;
    }
    const int64_t v = a.order[r];
    const T lw = static_cast<const T*>(a.lwpow)[v];
    const T w = iw[v];
    write_record<T, D>(row, pos + v * d, d, true, T(0), w, lw * lw, T(1) / w);
    a.qcol[t] = a.colors[v];
    return;
  }
  if (t < a.nq + a.npa) {  // a member slot
    const int64_t p = t - a.nq;
    const int64_t r = a.src_of_pad[p];
    T* row = static_cast<T*>(a.srec) + p * width;
    const T sentinel = static_cast<T>(kSSentinel);
    if (r == n) {
      write_record<T, D>(row, pos, d, false, sentinel, T(1), T(0), T(0));
      a.scol[p] = -3;
      return;
    }
    const int64_t v = a.order[r];
    const bool member = a.in_index == nullptr || a.in_index[v] != 0;
    const T w = iw[v];
    write_record<T, D>(row, pos + v * d, d, member, sentinel, w,
                       member ? static_cast<T>(a.class_bm2[v]) : T(0), T(1) / w);
    a.scol[p] = a.colors[v];
    return;
  }
  const int64_t j = t - a.nq - a.npa;  // a sorted rank
  if (j >= n) return;
  const int64_t v = a.order[j];
  const int64_t q = j + a.sorted_shift_q[j];
  int64_t* inv = a.inv + 4 * v;
  inv[0] = j - a.sorted_moff[j];
  inv[1] = q / kQ;
  inv[2] = q;
  inv[3] = a.row_of_sorted[j];
  T* sorted = static_cast<T*>(a.sorted);
  sorted[j] = static_cast<const T*>(a.x)[v];
  sorted[n + j] = static_cast<const T*>(a.y)[v];
  sorted[2 * n + j] = static_cast<const T*>(a.lwpow)[v];
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

// The first i in [0, len) with !(x(i) < value) (right: !(x(i) <= value)),
// len if none, where x(i) = xs[i] below `size` and +inf from there: the
// row as torch.searchsorted sees it in the plain version's +inf-padded
// (R, max row size) matrix.
template <typename T, bool kRight>
__device__ __forceinline__ int search_row(const T* xs, int size, int len, T value) {
  int lo = 0, hi = len;  // 32-bit: rows are shorter than 2^31 (the wrapper checks); 64-bit spilled
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    const T x = mid < size ? xs[mid] : static_cast<T>(INFINITY);
    const bool before = kRight ? (x <= value) : (x < value);
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// CTAs of span_windows_kernel that have finished this launch; the last
// one adds the blocks' overflow and sets it back to 0.
__device__ unsigned int g_window_ctas_done;

template <typename T>
__global__ void __launch_bounds__(kThreads) span_windows_kernel(const WindowsArgs a) {
  __shared__ T s_max[kThreads], s_ymin[kThreads], s_ymax[kThreads];
  __shared__ int64_t s_over[kThreads];
  __shared__ bool s_last;
  const int64_t b = blockIdx.x;
  const int64_t n = a.n;
  const T* xs = static_cast<const T*>(a.sorted);
  const T* ys = xs + n;
  const T* lws = xs + 2 * n;
  const T big = sizeof(T) == 4 ? static_cast<T>(3.4028234663852886e38) : static_cast<T>(1.7976931348623157e308);
  {
    const int64_t r = a.src_of_q[b * kQ + threadIdx.x];
    const bool valid = r < n;
    s_max[threadIdx.x] = valid ? lws[r] : T(0);
    s_ymin[threadIdx.x] = valid ? ys[r] : big;
    s_ymax[threadIdx.x] = valid ? ys[r] : -big;
  }
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_max[threadIdx.x] = max_nan(s_max[threadIdx.x], s_max[threadIdx.x + stride]);
      s_ymin[threadIdx.x] = min_nan(s_ymin[threadIdx.x], s_ymin[threadIdx.x + stride]);
      s_ymax[threadIdx.x] = max_nan(s_ymax[threadIdx.x], s_ymax[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  const T maxlw = s_max[0], ymin_blk = s_ymin[0], ymax_blk = s_ymax[0];
  const T minx = xs[a.blk_first[b]];
  const T maxx = xs[a.blk_last[b]];
  const T* y = static_cast<const T*>(a.y);
  int64_t over = 0;
  for (int64_t r = threadIdx.x; r < a.r; r += kThreads) {
    const int64_t lo_rank = a.row_lo[r], hi_rank = a.row_hi[r];
    const T row_ymin = y[a.order1[lo_rank]];
    const T row_ymax = y[a.order1[hi_rank]];
    const T reach = maxlw * static_cast<T>(a.bmax_row[r]);
    const bool overlap = (ymin_blk - reach <= row_ymax) && (ymax_blk + reach >= row_ymin);
    int64_t start = 0, stop = 0;
    if (overlap) {
      const T* row = xs + lo_rank;
      const int size = static_cast<int>(hi_rank - lo_rank + 1);
      start = search_row<T, false>(row, size, static_cast<int>(a.max_row), minx - reach);
      stop = search_row<T, true>(row, size, static_cast<int>(a.max_row), maxx + reach);
    }
    const int64_t t_blk = a.blk_t[b * a.r + r];
    int64_t st = imin((stop + kST - 1) / kST - t_blk, start / kST);
    st = imin(imax(st, 0), a.row_tiles[r] - t_blk);
    const int64_t cov_end = (st + t_blk) * kST;
    over += imax(imin(stop - cov_end, stop - start), 0);
    a.start_tile[b * a.r + r] = static_cast<int32_t>(st);
    a.need[b * a.r + r] = stop > start ? stop - (start / kST) * kST : 0;
  }
  s_over[threadIdx.x] = over;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s_over[threadIdx.x] += s_over[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.part[b] = s_over[0];
    __threadfence();
    s_last = atomicAdd(&g_window_ctas_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    int64_t total = 0;
    for (int64_t i = threadIdx.x; i < a.nb; i += kThreads) total += a.part[i];
    s_over[threadIdx.x] = total;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) s_over[threadIdx.x] += s_over[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      a.overflow[0] = s_over[0];
      g_window_ctas_done = 0;
    }
  }
}

// ---------------------------------------------------------------- launches

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
  const int64_t blocks = (a.nq + a.npa + a.n + kThreads - 1) / kThreads;
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

const char* wembed_span_build_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry enqueues one launch on `stream`, in f64 when `f64` is set,
// else f32, and returns the launch error.  None allocates or synchronises;
// every buffer comes from the caller (kernels/span_build.py).

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
  if (a.n < 1 || a.d < 1 || a.nq < 0 || a.npa < 0 ||
      (a.nq + a.npa + a.n + kThreads - 1) / kThreads > INT32_MAX) {
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
