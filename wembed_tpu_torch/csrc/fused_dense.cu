// Fused all-pairs force kernel for Hopper (sm_90a): attraction, repulsion,
// both losses, the repulsion-candidate count and the per-row coincident
// counts of one embedding step, in one pass over the n x n pair matrix.
//
// Replaces the TPU kernel wembed_tpu/kernels/fused_dense.py:_kernel
// (launched by fused_dense_forces through the pl.pallas_call at
// fused_dense.py:192).  It computes what that kernel computes, pair by pair:
//   dist2   = sum_k (p_v[k] - p_u[k])^2, per-dimension differences in
//             ascending k (never the Gram form, which cancels)
//   ws      = invw_v * invw_u (or invw_v + invw_u, additive weights)
//   repel   : not a neighbour, colours differ, dist2 * ws^2 <= L^2
//   attract : a neighbour with dist2 * ws^2 > L^2
//   coeff   = rep_scale * ws / dist (repel, dist > 0), -att_scale * ws / dist
//   force_v = sum_u coeff * (p_v - p_u)
// which is the TPU kernel's p_v * rowsum(coeff) - coeff @ P, accumulated
// here as d multiply-adds per pair in registers instead of as a matrix
// product (no cancellation between two large terms, no tensor cores).
//
// The masks must agree bit for bit with the plain PyTorch twin
// (kernels/fused_dense.py:fused_dense_forces_reference), so this file is
// compiled with --fmad=false and never with --use_fast_math: a contracted
// dist2 rounds differently and flips dead-zone pairs.  sqrtf and the
// divisions are the IEEE ones (nvcc's default -prec-sqrt/-prec-div).
//
// The adjacency is one bit a pair: (n, ceil(n / 32)) 32-bit words, bit
// c % 32 of word c / 32 of row v set where (v, c) is an edge
// (kernels/fused_dense.py:adjacency_bits): 12.5 MB at n = 10,000, 32 MiB at
// n = 16,384, so it stays in the 50 MB L2.
//
// What bounds it on an H100: FP32 work.  Every pair costs the distance
// (3d - 1 FLOP), the weight scale and the weighted distance (3) and the
// compare: 9 FLOP at d = 2, 1e8 pairs at girg10k, 0.0135 ms at 67 TFLOP/s;
// the bit adjacency (12.5 MB) takes 0.004 ms at 3.35 TB/s.
//
// Layout.  A CTA of 8 warps owns kRows = 32 consecutive rows, kRowsPerWarp
// = 4 a warp held in every lane's registers, and sweeps one range of
// column tiles of kTileC columns; lane l takes columns 32 i + l of each
// tile, so one staged column serves 4 pairs.  Column tiles (positions,
// inverse weights, colours) are double-buffered in shared memory with
// cp.async, one barrier a tile; each lane loads one adjacency word a row
// per 32 columns of the tile (coalesced) for the next tile while it sweeps
// this one, and a shuffle hands each lane its word.  Pairs neither close
// (dist2 * ws^2 <= L^2) nor neighbours, nearly all of them, leave after one
// compare; the colour test, the tallies, the sqrt and the divisions are on
// the rare path.  Columns past n read +inf positions and zero adjacency
// bits, which every mask rejects.
//
// Whole waves: the column range of a row block is cut into S splits,
// chosen from the SM count and the occupancy so that (row blocks x S)
// CTAs fill the card's resident slots as evenly as can be (girg10k at
// d = 2, 3 CTAs an SM: 313 row blocks fill 79% of the 396 slots, S = 5
// fills 99% of four waves).  Each row's force and coincident
// count are reduced over the warp's lanes with shuffles and written once
// per split; a second kernel adds the splits in split order.  The two
// losses and the candidate count go out as per-CTA partials, summed in a
// fixed order by a third kernel, so results are deterministic.  The count
// is integer (the TPU kernel counts in f32, exact only below 2^24).
//
// Row range.  A launch covers rows [row0, row0 + rows) against all n
// columns (one rank's share of the replicated multi-device step); its
// outputs hold those rows only.  The splits are the whole pass's, so each
// row of a range is summed exactly as the whole pass sums it, bit for bit,
// and a launch over [0, n) is the whole pass.
//
// The general kernel, fused_dense_general_kernel<T, RW>, runs what the fast
// one does not take: f32 at d > kMaxDim and f64 at any d >= 1.  Its outputs
// are bitwise those of the simple kernel it replaced (one warp a row,
// positions read through L1, the force summed in device memory): each
// row's force is a left fold from +0 over its active columns in ascending
// column order of coeff * (p_r[k] - p_c[k]), dist2 is summed in ascending
// k, and the masks are the operations above in T (in f64 the dead-zone test
// and the losses run in double).  Counts are exact; the losses are tallies
// summed in another order.  What bounds it is the common path's 3d + 3
// operations a pair in T (d = 16 f32 at girg10k: 0.076 ms at 67 TFLOP/s),
// so it stages and reuses:
//   - a CTA of 8 warps owns R = 8 RW consecutive rows, RW a warp (RW = 8, 4
//     or 2 in f32, 4 or 2 in f64, chosen so that the CTAs spread evenly over
//     the SMs: whole waves, as choose_splits does for the fast kernel), and
//     sweeps every column: column tiles of kGenTileC = 128, each staged in
//     slabs of GenSlab<T> dimensions (16 in f32, 8 in f64) with cp.async
//     in a ring of kGenStages = 4 (copies issued three steps ahead, so
//     that a short step at a small d does not wait on memory), one barrier
//     a slab; the rows' slab beside it (staged once where d fits one
//     slab); each tile's inverse weights, colours and adjacency words with
//     its last slab;
//   - lane l takes columns 32 j + l (j < 4) and keeps RW x 4 dist2 sums in
//     registers across the slabs, so each staged column value serves RW
//     pairs and each row value (a 16-byte broadcast load) 4;
//   - after a tile's last slab a pair is rare when close or a neighbour:
//     one ballot of `close` ORed with the row's adjacency word finds the
//     rare lanes of a (row, 32-column group), and such groups are taken in
//     ascending order.  Each rare lane runs the masks, the tallies, the sqrt
//     and the division for its pair; then lane k % 32 adds the group's
//     active pairs in lane (column) order into dimension k's sum, held in
//     a register across the group (a hub row's neighbours crowd into few
//     groups), two pairs' loads in flight at a time, the positions from
//     the staged slabs (one slab) or through L1.
// The sums are kept in shared memory, R x d values, or, for a d too wide
// for that, in the row's own output in device memory; either way one warp
// owns a row, so the fold has a single order and needs no split, and the
// CTAs are many and small instead (hence the rows-a-warp choice).  Tiles of
// a CTA walk the columns in order, so the fold is the column-order fold of
// the simple kernel whatever RW is, and a row range's rows equal the whole
// launch's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kTileC = 512;
constexpr int kTileWords = kTileC / 32;
constexpr int kMaxDim = 8;
constexpr int kMaxSplits = 16;
constexpr int kFinalizeThreads = 256;

struct Params {
  const float* pos;        // (n, D) row-major
  const float* invw;       // (n,)
  const int* colors;       // (n,)
  const uint32_t* adj;     // (n, W) adjacency bits
  int n;
  int W;                   // words a row, ceil(n / 32)
  int row0;                // first row of the launch
  int rows;                // rows of the launch
  int splits;              // S: column splits a row block
  float L;
  float L2;
  float att_scale;
  float rep_scale;
  int additive;
  float* part_force;       // (S, rows, D) per-split forces
  int* part_zero;          // (S, rows) per-split coincident counts
  double* part_loss;       // (gridDim.x, 2): attraction, repulsion
  long long* part_count;   // (gridDim.x,)
  float* force;            // out (rows, D)
  int* zero_count;         // out (rows,)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
struct Tile {
  float pos[D][kTileC];
  float invw[kTileC];
  int col[kTileC];
};

// Stages columns c0 ... c0 + kTileC - 1; those past n get +inf positions.
template <int D>
__device__ __forceinline__ void stage_tile(const Params& p, Tile<D>& t, int c0) {
  const int tc = min(kTileC, p.n - c0);
  const float* src = p.pos + (size_t)c0 * D;
  for (int e = threadIdx.x; e < kTileC * D; e += kThreads) {
    const int i = e / D;
    const int k = e - i * D;
    if (i < tc) cp_async4(&t.pos[k][i], src + e);
    else t.pos[k][i] = INFINITY;
  }
  for (int i = threadIdx.x; i < tc; i += kThreads) {
    cp_async4(&t.invw[i], p.invw + c0 + i);
    cp_async4(&t.col[i], p.colors + c0 + i);
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) fused_dense_kernel(Params p) {
  __shared__ __align__(16) Tile<D> s_tile[2];
  __shared__ double s_att[kWarps];
  __shared__ double s_rep[kWarps];
  __shared__ long long s_cnt[kWarps];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rb = blockIdx.x / p.splits;
  const int split = blockIdx.x - rb * p.splits;
  const int lrow0 = rb * kRows + warp * kRowsPerWarp;  // within the launch's rows
  const int row0 = p.row0 + lrow0;
  const int tiles = (p.n + kTileC - 1) / kTileC;
  const int t_lo = (int)((long long)split * tiles / p.splits);
  const int t_hi = (int)((long long)(split + 1) * tiles / p.splits);

  float pr[kRowsPerWarp][D];
  float facc[kRowsPerWarp][D];
  float iwr[kRowsPerWarp];
  int cr[kRowsPerWarp];
  int zc[kRowsPerWarp];
  uint32_t word[kRowsPerWarp];
  // rows past the launch's get NaN positions and no adjacency bits: every
  // pair of theirs fails both the distance test and the neighbour test
  bool rv[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    rv[r] = lrow0 + r < p.rows;
    const int rr = rv[r] ? row0 + r : 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      pr[r][k] = rv[r] ? p.pos[(size_t)rr * D + k] : NAN;
      facc[r][k] = 0.0f;
    }
    iwr[r] = p.invw[rr];
    cr[r] = p.colors[rr];
    zc[r] = 0;
  }
  // lane l reads word l of a tile's 16 (lanes 16-31 repeat 0-15)
  auto load_words = [&](int t) {
    const int w = t * kTileWords + (lane % kTileWords);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      word[r] = rv[r] && w < p.W ? __ldg(p.adj + (size_t)(row0 + r) * p.W + w) : 0u;
    }
  };
  double att_loss = 0.0;  // the loss terms are f32; their sums are kept in double
  double rep_loss = 0.0;
  int count = 0;

  if (t_lo < t_hi) {
    stage_tile<D>(p, s_tile[t_lo & 1], t_lo * kTileC);
    load_words(t_lo);
  }
  for (int t = t_lo; t < t_hi; ++t) {
    const Tile<D>& tile = s_tile[t & 1];
    uint32_t cur[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) cur[r] = word[r];
    cp_async_wait_all();
    __syncthreads();  // tile t is in place; every thread is done with tile t - 1
    if (t + 1 < t_hi) {
      stage_tile<D>(p, s_tile[(t + 1) & 1], (t + 1) * kTileC);
      load_words(t + 1);
    }

#pragma unroll 2
    for (int i = 0; i < kTileWords; ++i) {
      const int ci = 32 * i + lane;
      float pc[D];
#pragma unroll
      for (int k = 0; k < D; ++k) pc[k] = tile.pos[k][ci];
      const float iwc = tile.invw[ci];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const bool nbr = (__shfl_sync(0xffffffffu, cur[r], i) >> lane) & 1u;
        float diff[D];
        float dist2 = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = pr[r][k] - pc[k];
          dist2 = dist2 + diff[k] * diff[k];
        }
        const float ws = p.additive ? iwr[r] + iwc : iwr[r] * iwc;
        const float wdist2 = dist2 * (ws * ws);
        const bool close = wdist2 <= p.L2;
        if (!(close || nbr)) continue;
        // the rare path: a repulsion candidate or a neighbour
        const bool rep = !nbr && (cr[r] != tile.col[ci]) && close;
        const bool att = nbr && (wdist2 > p.L2);
        const bool posd = dist2 > 0.0f;
        count += rep ? 1 : 0;
        zc[r] += (!posd && (nbr || rep)) ? 1 : 0;
        if ((rep && posd) || att) {
          const float dist = sqrtf(dist2);
          const float inv = 1.0f / fmaxf(dist, 1e-30f);
          const float linvws = p.L / ws;
          float coeff;
          if (rep) {
            coeff = p.rep_scale * ws * inv;
            rep_loss += linvws - dist;
          } else {
            coeff = -(p.att_scale * ws * inv);
            att_loss += dist - linvws;
          }
#pragma unroll
          for (int k = 0; k < D; ++k) facc[r][k] += coeff * diff[k];
        }
      }
    }
  }

  // each row's sums across its warp, in a fixed butterfly order
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float v = facc[r][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      facc[r][k] = v;
    }
    int z = zc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
    zc[r] = z;
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!rv[r]) continue;
      const size_t o = (size_t)split * p.rows + lrow0 + r;
#pragma unroll
      for (int k = 0; k < D; ++k) p.part_force[o * D + k] = facc[r][k];
      p.part_zero[o] = zc[r];
    }
  }

  // the CTA's partial losses and count
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    att_loss += __shfl_xor_sync(0xffffffffu, att_loss, off);
    rep_loss += __shfl_xor_sync(0xffffffffu, rep_loss, off);
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if (lane == 0) {
    s_att[warp] = att_loss;
    s_rep[warp] = rep_loss;
    s_cnt[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    long long c = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_att[w];
      b += s_rep[w];
      c += s_cnt[w];
    }
    p.part_loss[2 * blockIdx.x] = a;
    p.part_loss[2 * blockIdx.x + 1] = b;
    p.part_count[blockIdx.x] = c;
  }
}

// Adds each row's splits in split order.
template <int D>
__global__ void __launch_bounds__(kFinalizeThreads) rows_kernel(Params p) {
  const int row = blockIdx.x * kFinalizeThreads + threadIdx.x;
  if (row >= p.rows) return;
  float f[D];
#pragma unroll
  for (int k = 0; k < D; ++k) f[k] = 0.0f;
  int z = 0;
  for (int s = 0; s < p.splits; ++s) {
    const size_t o = (size_t)s * p.rows + row;
#pragma unroll
    for (int k = 0; k < D; ++k) f[k] = f[k] + p.part_force[o * D + k];
    z += p.part_zero[o];
  }
#pragma unroll
  for (int k = 0; k < D; ++k) p.force[(size_t)row * D + k] = f[k];
  p.zero_count[row] = z;
}

// Sums the per-CTA partials in a fixed order; the losses leave as T.
template <typename T>
__global__ void __launch_bounds__(kFinalizeThreads)
finalize_kernel(const double* part_loss, const long long* part_count, int num_parts,
                T* loss_out, long long* count_out) {
  __shared__ double s_a[kFinalizeThreads];
  __shared__ double s_b[kFinalizeThreads];
  __shared__ long long s_c[kFinalizeThreads];
  double a = 0.0, b = 0.0;
  long long c = 0;
  for (int i = threadIdx.x; i < num_parts; i += kFinalizeThreads) {
    a += part_loss[2 * i];
    b += part_loss[2 * i + 1];
    c += part_count[i];
  }
  s_a[threadIdx.x] = a;
  s_b[threadIdx.x] = b;
  s_c[threadIdx.x] = c;
  __syncthreads();
  for (int half = kFinalizeThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      s_a[threadIdx.x] += s_a[threadIdx.x + half];
      s_b[threadIdx.x] += s_b[threadIdx.x + half];
      s_c[threadIdx.x] += s_c[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    loss_out[0] = (T)s_a[0];
    loss_out[1] = (T)s_b[0];
    count_out[0] = s_c[0];
  }
}

// The number of column splits S <= kMaxSplits (and <= the column tiles)
// whose (row blocks x S) CTAs fill the resident slots best: the largest
// mean share of a wave in use, the fewest splits on a tie.
template <int D>
cudaError_t choose_splits(int n, int device, int* splits) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_dense_kernel<D>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long row_blocks = (n + kRows - 1) / kRows;
  const int tiles = (n + kTileC - 1) / kTileC;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= kMaxSplits && s <= tiles; ++s) {
    const long long ctas = row_blocks * s;
    const long long waves = (ctas + slots - 1) / slots;
    const double fill = (double)ctas / (double)(waves * slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = s;
    }
  }
  *splits = best;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream, float* loss_out, long long* count_out) {
  const int blocks = ((p.rows + kRows - 1) / kRows) * p.splits;
  fused_dense_kernel<D><<<blocks, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<D><<<(p.rows + kFinalizeThreads - 1) / kFinalizeThreads, kFinalizeThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<float><<<1, kFinalizeThreads, 0, stream>>>(p.part_loss, p.part_count, blocks,
                                                             loss_out, count_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- general

// The general kernel's shape (header): a warp owns RW rows, lane l takes
// columns 32 j + l (j < kGenJC) of each staged column tile, and d is staged
// in slabs of GenSlab<T> dimensions.
constexpr int kGenJC = 4;                     // 32-column groups a tile
constexpr int kGenTileC = 32 * kGenJC;        // columns a tile
constexpr int kGenColStride = kGenTileC + 1;  // a staged slab's row, padded against bank conflicts
constexpr int kGenMinRowsPerWarp = 2;         // the fewest rows a warp of any instantiation
constexpr int kGenStages = 4;                 // steps in flight: copies issued kGenStages - 1 steps ahead
constexpr int kMaxDevices = 64;               // devices whose attributes are cached

static_assert(kGenJC == 4, "a row's adjacency words of a tile are read as one uint4");
static_assert(kThreads % kGenTileC == 0, "the threads stage whole columns of a tile");

template <typename T>
struct GenSlab;
template <>
struct GenSlab<float> {
  static constexpr int value = 16;
};
template <>
struct GenSlab<double> {
  static constexpr int value = 8;
};

template <typename T>
struct GeneralParams {
  const T* pos;            // (n, d) row-major
  const T* invw;           // (n,)
  const int* colors;       // (n,)
  const uint32_t* adj;     // (n, W) adjacency bits
  int n;
  int W;
  int d;
  int slabs;               // ceil(d / GenSlab<T>)
  int row0;
  int rows;
  T L;
  T L2;
  T att_scale;
  T rep_scale;
  int additive;
  int smem_acc;            // the rows' force sums in shared memory, else in `force`
  T* force;                // out (rows, d)
  int* zero_count;         // out (rows,)
  double* part_loss;       // (gridDim.x, 2)
  long long* part_count;   // (gridDim.x,)
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Byte offsets of the general kernel's dynamic shared memory at dimension d
// (slab buffers of min(d, DS) rows), with or without the force sums.
template <typename T, int RW>
struct GenLayout {
  static constexpr int DS = GenSlab<T>::value;
  static constexpr int R = kWarps * RW;  // rows a CTA
  int kr;       // rows of a slab buffer
  size_t col;   // kGenStages x [kr][kGenColStride] T
  size_t row;   // kGenStages x [kr][R] T, or one where d fits one slab
  size_t ciw;   // kGenStages x [kGenTileC] T
  size_t riw;   // [R] T
  size_t cf;    // [kWarps][32] T: a warp's coefficients of one (row, group)
  size_t adj;   // kGenStages x [R][kGenJC] words
  size_t ccol;  // kGenStages x [kGenTileC] int
  size_t rcol;  // [R] int
  size_t zc;    // [R] int
  size_t acc;   // [R][d] T, when the sums are kept here
  size_t bytes;
  __host__ __device__ GenLayout(int d, bool smem_acc) {
    kr = d < DS ? d : DS;
    col = 0;
    row = align16(col + kGenStages * kr * kGenColStride * sizeof(T));
    ciw = align16(row + (d > DS ? kGenStages : 1) * kr * R * sizeof(T));
    riw = ciw + kGenStages * kGenTileC * sizeof(T);
    cf = riw + R * sizeof(T);
    adj = align16(cf + kWarps * 32 * sizeof(T));
    ccol = adj + kGenStages * R * kGenJC * 4;
    rcol = ccol + kGenStages * kGenTileC * 4;
    zc = rcol + R * 4;
    acc = align16(zc + R * 4);
    bytes = acc + (smem_acc ? static_cast<size_t>(R) * d * sizeof(T) : 0);
  }
};

// CTAs an SM the general kernel is built for (its register budget): more
// where a warp's rows are fewer and its registers with them, so that the
// rare path's dependent chains (sqrt, divisions) have warps to hide behind.
template <typename T, int RW>
struct GenMinBlocks {
  static constexpr int value = RW >= 8 ? 2 : (RW == 4 ? (sizeof(T) == 4 ? 3 : 2) : (sizeof(T) == 4 ? 4 : 3));
};

__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }

__device__ __forceinline__ void cp_async_t(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void cp_async_t(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// N consecutive values from shared memory in 16-byte (or 8-byte) loads;
// src is aligned to the load.
template <int N>
__device__ __forceinline__ void load_values(float (&v)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(src)[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "rows a warp: 2, 4 or 8");
    const float2 x = *reinterpret_cast<const float2*>(src);
    v[0] = x.x;
    v[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void load_values(double (&v)[N], const double* src) {
  static_assert(N % 2 == 0, "rows a warp: 2 or 4");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 x = reinterpret_cast<const double2*>(src)[i];
    v[2 * i] = x.x;
    v[2 * i + 1] = x.y;
  }
}

template <typename T, int RW>
__global__ void __launch_bounds__(kThreads, GenMinBlocks<T, RW>::value)
    fused_dense_general_kernel(GeneralParams<T> p) {
  using Lay = GenLayout<T, RW>;
  constexpr int DS = Lay::DS, R = Lay::R, JC = kGenJC, TC = kGenTileC, CS = kGenColStride;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char gen_smem[];
  const Lay lay(p.d, p.smem_acc != 0);
  const int KR = lay.kr;
  T* const s_col = reinterpret_cast<T*>(gen_smem + lay.col);
  T* const s_row = reinterpret_cast<T*>(gen_smem + lay.row);
  T* const s_ciw = reinterpret_cast<T*>(gen_smem + lay.ciw);
  T* const s_riw = reinterpret_cast<T*>(gen_smem + lay.riw);
  uint32_t* const s_adj = reinterpret_cast<uint32_t*>(gen_smem + lay.adj);
  int* const s_ccol = reinterpret_cast<int*>(gen_smem + lay.ccol);
  int* const s_rcol = reinterpret_cast<int*>(gen_smem + lay.rcol);
  int* const s_zc = reinterpret_cast<int*>(gen_smem + lay.zc);
  T* const s_acc = reinterpret_cast<T*>(gen_smem + lay.acc);
  __shared__ double s_att[kWarps];
  __shared__ double s_rep[kWarps];
  __shared__ long long s_cnt[kWarps];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* const s_cf = reinterpret_cast<T*>(gen_smem + lay.cf) + warp * 32;
  const int d = p.d;
  const int slabs = p.slabs;
  const int lrow0 = blockIdx.x * R;          // the CTA's first row within the launch's
  const int nrows = min(R, p.rows - lrow0);  // and its rows
  const int wr0 = warp * RW;                 // the warp's first row within the CTA's
  const int steps = (p.n + TC - 1) / TC * slabs;
  T* const acc = p.smem_acc ? s_acc : p.force + static_cast<size_t>(lrow0) * d;  // (nrows, d)

  // rows past the launch's repeat its last row; every mask leaves them out
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int row = p.row0 + lrow0 + min(i, nrows - 1);
    s_riw[i] = p.invw[row];
    s_rcol[i] = p.colors[row];
    s_zc[i] = 0;
  }
  for (int e = threadIdx.x; e < nrows * d; e += kThreads) acc[e] = T(0);

  // step s: slab s % slabs of column tile s / slabs, into stage s %
  // kGenStages; the rows' slab with it (a single slab once, into stage 0),
  // and the tile's inverse weights, colours and adjacency words with its
  // last slab, which runs the tile's masks
  auto stage = [&](int s) {
    const int t = s / slabs, sl = s - t * slabs;
    const int c0 = t * TC, k0 = sl * DS, kn = min(DS, d - k0);
    const int tc = min(TC, p.n - c0);
    const int g = s % kGenStages;
    // a thread a column (a row), every (kThreads / TC)-th dimension of it:
    // conflict-free stores, each column's values from one L1 line
    T* const col = s_col + g * KR * CS;
    const int ci = threadIdx.x % TC;
    const T* const csrc = p.pos + static_cast<size_t>(c0 + ci) * d + k0;
    for (int k = threadIdx.x / TC; k < kn; k += kThreads / TC) {
      if (ci < tc) cp_async_t(col + k * CS + ci, csrc + k);
      else col[k * CS + ci] = T(0);
    }
    if (slabs > 1 || s == 0) {
      T* const row = s_row + (slabs > 1 ? g : 0) * KR * R;
      const int ri = threadIdx.x % R;
      const T* const rsrc = p.pos + static_cast<size_t>(p.row0 + lrow0 + min(ri, nrows - 1)) * d + k0;
      for (int k = threadIdx.x / R; k < kn; k += kThreads / R) cp_async_t(row + k * R + ri, rsrc + k);
    }
    if (sl == slabs - 1) {
      const int tb = g;
      for (int i = threadIdx.x; i < TC; i += kThreads) {
        if (i < tc) {
          cp_async_t(s_ciw + tb * TC + i, p.invw + c0 + i);
          cp_async4(s_ccol + tb * TC + i, p.colors + c0 + i);
        } else {
          s_ciw[tb * TC + i] = T(0);
          s_ccol[tb * TC + i] = 0;
        }
      }
      for (int e = threadIdx.x; e < R * JC; e += kThreads) {
        const int i = e / JC, j = e - i * JC;
        const int w = c0 / 32 + j;
        uint32_t* const dst = s_adj + (tb * R + i) * JC + j;
        if (i < nrows && w < p.W) cp_async4(dst, p.adj + static_cast<size_t>(p.row0 + lrow0 + i) * p.W + w);
        else *dst = 0u;
      }
    }
    cp_async_commit();
  };

  T dist2[RW][JC];
  double att_loss = 0.0;  // the loss terms are T; their sums are kept in double
  double rep_loss = 0.0;
  long long count = 0;
  for (int s = 0; s < kGenStages - 1; ++s) {
    if (s < steps) stage(s);
    else cp_async_commit();  // an empty group keeps the count of groups a step
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kGenStages - 2>();
    __syncthreads();  // step s is in place; every thread is done with step s - 1
    if (s + kGenStages - 1 < steps) stage(s + kGenStages - 1);  // into step s - 1's stage
    else cp_async_commit();
    const int t = s / slabs, sl = s - t * slabs;
    const int g = s % kGenStages;
    const int kn = min(DS, d - sl * DS);
    const T* const col = s_col + g * KR * CS;
    const T* const row = s_row + (slabs > 1 ? g : 0) * KR * R;
    if (sl == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
#pragma unroll
        for (int j = 0; j < JC; ++j) dist2[r][j] = T(0);
      }
    }
    // dist2 over the slab's dimensions, in ascending k after the earlier slabs'
#pragma unroll 2
    for (int k = 0; k < kn; ++k) {
      T rv[RW];
      load_values(rv, row + k * R + wr0);
      T cv[JC];
#pragma unroll
      for (int j = 0; j < JC; ++j) cv[j] = col[k * CS + 32 * j + lane];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          const T diff = rv[r] - cv[j];
          dist2[r][j] = dist2[r][j] + diff * diff;
        }
      }
    }
    if (sl < slabs - 1) continue;

    // the tile's pairs: a (row, 32-column group) is pending when a pair of
    // it is close or a neighbour, found by one ballot
    const int tb = g, c0 = t * TC;
    const T* const ciw = s_ciw + tb * TC;
    const uint32_t* const adj = s_adj + tb * R * JC;
    T iwc[JC];
    bool cin[JC];
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      iwc[j] = ciw[32 * j + lane];
      cin[j] = c0 + 32 * j + lane < p.n;
    }
    uint32_t pending = 0u;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const T iwr = s_riw[wr0 + r];
      const uint4 w4 = *reinterpret_cast<const uint4*>(adj + (wr0 + r) * JC);
      const uint32_t words[JC] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const T ws = p.additive ? iwr + iwc[j] : iwr * iwc[j];
        const bool close = cin[j] && dist2[r][j] * (ws * ws) <= p.L2;
        const uint32_t m = __ballot_sync(kAll, close) | words[j];
        if (m != 0u && wr0 + r < nrows) pending |= 1u << (r * JC + j);
      }
    }

    // the rare path, (row, group) in ascending order: each lane tests its
    // pair, then the warp adds the active pairs' coeff * (p_r - p_c) into
    // the row's sums in column order, lane k % 32 owning dimension k
    while (pending != 0u) {
      const int idx = __ffs(pending) - 1;
      pending &= pending - 1u;
      const int r = idx / JC, j = idx - r * JC;
      T d2 = T(0);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          if (rr * JC + jj == idx) d2 = dist2[rr][jj];
        }
      }
      const int i = 32 * j + lane;
      const T iwr = s_riw[wr0 + r];
      const T ws = p.additive ? iwr + ciw[i] : iwr * ciw[i];
      const T wdist2 = d2 * (ws * ws);
      const bool close = c0 + i < p.n && wdist2 <= p.L2;
      const bool nbr = (adj[(wr0 + r) * JC + j] >> lane) & 1u;
      T coeff = T(0);
      bool act = false, zero = false;
      if (close || nbr) {
        const bool rep = !nbr && (s_rcol[wr0 + r] != s_ccol[tb * TC + i]) && close;
        const bool att = nbr && (wdist2 > p.L2);
        const bool posd = d2 > T(0);
        count += rep ? 1 : 0;
        zero = !posd && (nbr || rep);
        if ((rep && posd) || att) {
          const T dist = ieee_sqrt(d2);
          const T inv = T(1) / max_of(dist, T(1e-30));
          const T linvws = p.L / ws;
          if (rep) {
            coeff = p.rep_scale * ws * inv;
            rep_loss += linvws - dist;
          } else {
            coeff = -(p.att_scale * ws * inv);
            att_loss += dist - linvws;
          }
          act = true;
        }
      }
      const uint32_t zeros = __ballot_sync(kAll, zero);
      if (lane == 0) s_zc[wr0 + r] += __popc(zeros);
      uint32_t active = __ballot_sync(kAll, act);
      if (active == 0u) continue;
      // the row's sums take the group's active pairs in column order: lane
      // k % 32 holds dimension k's sum in a register across them
      s_cf[lane] = coeff;
      __syncwarp();
      T* const fr = acc + static_cast<size_t>(wr0 + r) * d;
      const T* const pr = p.pos + static_cast<size_t>(p.row0 + lrow0 + wr0 + r) * d;
      const T* const pc = p.pos + static_cast<size_t>(c0 + 32 * j) * d;  // the group's first column
      for (int k = lane; k < d; k += 32) {
        const T prk = slabs == 1 ? row[k * R + wr0 + r] : pr[k];
        T sum = fr[k];
        uint32_t bits = active;
        while (bits != 0u) {  // two pairs' loads in flight at a time
          const int b0 = __ffs(bits) - 1;
          bits &= bits - 1u;
          const bool two = bits != 0u;
          const int b1 = two ? __ffs(bits) - 1 : b0;
          if (two) bits &= bits - 1u;
          const T pc0 = slabs == 1 ? col[k * CS + 32 * j + b0] : pc[static_cast<size_t>(b0) * d + k];
          const T pc1 = slabs == 1 ? col[k * CS + 32 * j + b1] : pc[static_cast<size_t>(b1) * d + k];
          const T t0 = s_cf[b0] * (prk - pc0);
          const T t1 = s_cf[b1] * (prk - pc1);
          sum = sum + t0;
          if (two) sum = sum + t1;
        }
        fr[k] = sum;
      }
      __syncwarp();  // the coefficients are read before the next group's
    }
  }

  // the CTA's partial losses and count
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    att_loss += __shfl_xor_sync(kAll, att_loss, off);
    rep_loss += __shfl_xor_sync(kAll, rep_loss, off);
    count += __shfl_xor_sync(kAll, count, off);
  }
  if (lane == 0) {
    s_att[warp] = att_loss;
    s_rep[warp] = rep_loss;
    s_cnt[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    long long c = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_att[w];
      b += s_rep[w];
      c += s_cnt[w];
    }
    p.part_loss[2 * blockIdx.x] = a;
    p.part_loss[2 * blockIdx.x + 1] = b;
    p.part_count[blockIdx.x] = c;
  }
  if (p.smem_acc) {
    T* const out = p.force + static_cast<size_t>(lrow0) * d;
    for (int e = threadIdx.x; e < nrows * d; e += kThreads) out[e] = s_acc[e];
  }
  for (int i = threadIdx.x; i < nrows; i += kThreads) p.zero_count[lrow0 + i] = s_zc[i];
}

struct DeviceInfo {
  int sms;
  int optin;  // shared memory a block may opt in to
};

cudaError_t device_info(int device, DeviceInfo* out) {
  static DeviceInfo cache[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cache[device].sms > 0) {
    *out = cache[device];
    return cudaSuccess;
  }
  DeviceInfo info;
  cudaError_t err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&info.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) cache[device] = info;
  *out = info;
  return cudaSuccess;
}

// The general kernel's dynamic shared memory for dim on the device (the
// force sums in it where they fit, else in the output rows), opted in.
template <typename T, int RW>
cudaError_t prepare(int dim, int device, const DeviceInfo& info, int* smem_acc, size_t* bytes) {
  *smem_acc = GenLayout<T, RW>(dim, true).bytes <= static_cast<size_t>(info.optin) ? 1 : 0;
  *bytes = GenLayout<T, RW>(dim, *smem_acc != 0).bytes;
  if (*bytes > static_cast<size_t>(info.optin)) return cudaErrorInvalidValue;
  static size_t opted[kMaxDevices] = {};
  if (*bytes > 48 * 1024 && (device < 0 || device >= kMaxDevices || opted[device] < *bytes)) {
    const cudaError_t err = cudaFuncSetAttribute(fused_dense_general_kernel<T, RW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(*bytes));
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted[device] = *bytes;
  }
  return cudaSuccess;
}

// The mean share of the resident slots in use over the waves of a launch of
// `rows` rows at RW rows a warp (as choose_splits for the fast kernel).
template <typename T, int RW>
cudaError_t wave_fill(int rows, int dim, int device, const DeviceInfo& info, double* fill) {
  int smem_acc = 0, per_sm = 0;
  size_t bytes = 0;
  cudaError_t err = prepare<T, RW>(dim, device, info, &smem_acc, &bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_dense_general_kernel<T, RW>, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(info.sms) * (per_sm > 0 ? per_sm : 1);
  const long long ctas = (rows + kWarps * RW - 1) / (kWarps * RW);
  const long long waves = (ctas + slots - 1) / slots;
  *fill = static_cast<double>(ctas) / static_cast<double>(waves * slots);
  return cudaSuccess;
}

// The rows a warp whose CTAs fill the card's resident slots best (the
// largest mean share of a wave in use), the most rows a warp (more pairs
// served by each staged value) on a tie: 8, 4 or 2 in f32, 4 or 2 in f64.
// Each row is summed alike whichever CTA owns it, so the choice moves no
// force bit.  Remembered for the last (rows, dim) of each device.
template <typename T>
cudaError_t choose_rows_per_warp(int rows, int dim, int device, const DeviceInfo& info, int* rw) {
  static int last[kMaxDevices][3] = {};  // rows, dim, choice
  if (device >= 0 && device < kMaxDevices && last[device][0] == rows && last[device][1] == dim &&
      last[device][2] > 0) {
    *rw = last[device][2];
    return cudaSuccess;
  }
  double fill[3] = {0.0, 0.0, 0.0};
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = wave_fill<T, 8>(rows, dim, device, info, &fill[0]);
    if (err == cudaSuccess) err = wave_fill<T, 4>(rows, dim, device, info, &fill[1]);
  } else {
    err = wave_fill<T, 4>(rows, dim, device, info, &fill[1]);
  }
  if (err == cudaSuccess) err = wave_fill<T, 2>(rows, dim, device, info, &fill[2]);
  if (err != cudaSuccess) return err;
  const int options[3] = {8, 4, 2};
  int best = 0;
  for (int o = 1; o < 3; ++o) {
    if (fill[o] > fill[best] + 1e-9) best = o;
  }
  *rw = options[best];
  if (device >= 0 && device < kMaxDevices) {
    last[device][0] = rows;
    last[device][1] = dim;
    last[device][2] = *rw;
  }
  return cudaSuccess;
}

template <typename T, int RW>
cudaError_t launch_general(GeneralParams<T> p, int device, const DeviceInfo& info, cudaStream_t stream,
                           T* loss_out, long long* count_out) {
  size_t bytes = 0;
  cudaError_t err = prepare<T, RW>(p.d, device, info, &p.smem_acc, &bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.rows + kWarps * RW - 1) / (kWarps * RW);
  fused_dense_general_kernel<T, RW><<<blocks, kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<T><<<1, kFinalizeThreads, 0, stream>>>(p.part_loss, p.part_count, blocks,
                                                         loss_out, count_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t general(const void* pos, const void* invw, const int* colors, const int* adj, int n,
                    int dim, int row0, int rows, double L, double att_scale, double rep_scale,
                    int additive, void* force, int* zero_count, double* part_loss,
                    long long* part_count, void* loss_out, long long* count_out, int device,
                    cudaStream_t stream) {
  GeneralParams<T> p;
  p.pos = static_cast<const T*>(pos);
  p.invw = static_cast<const T*>(invw);
  p.colors = colors;
  p.adj = reinterpret_cast<const uint32_t*>(adj);
  p.n = n;
  p.W = (n + 31) / 32;
  p.d = dim;
  p.slabs = (dim + GenSlab<T>::value - 1) / GenSlab<T>::value;
  p.row0 = row0;
  p.rows = rows;
  p.L = static_cast<T>(L);
  p.L2 = static_cast<T>(L * L);
  p.att_scale = static_cast<T>(att_scale);
  p.rep_scale = static_cast<T>(rep_scale);
  p.additive = additive;
  p.smem_acc = 0;
  p.force = static_cast<T*>(force);
  p.zero_count = zero_count;
  p.part_loss = part_loss;
  p.part_count = part_count;
  DeviceInfo info;
  cudaError_t err = device_info(device, &info);
  if (err != cudaSuccess) return err;
  int rw = 2;
  err = choose_rows_per_warp<T>(rows, dim, device, info, &rw);
  if (err != cudaSuccess) return err;
  T* const lo = static_cast<T*>(loss_out);
  switch (rw) {
    case 8:
      if constexpr (sizeof(T) == 4) return launch_general<T, 8>(p, device, info, stream, lo, count_out);
      return cudaErrorInvalidValue;
    case 4: return launch_general<T, 4>(p, device, info, stream, lo, count_out);
    default: return launch_general<T, 2>(p, device, info, stream, lo, count_out);
  }
}

}  // namespace

extern "C" {

// Rows per CTA of the fast kernel: the wrapper sizes the
// (ceil(rows / kRows) * S, 2) and (ceil(rows / kRows) * S,) partial
// buffers from it.
int wembed_fused_dense_rows_per_block() { return kRows; }

// The fewest rows a CTA of the general kernel: the wrapper sizes the
// (ceil(rows / that), 2) and (ceil(rows / that),) partial buffers from it.
int wembed_fused_dense_general_rows_per_block() { return kWarps * kGenMinRowsPerWarp; }

int wembed_fused_dense_max_dim() { return kMaxDim; }

const char* wembed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes the column splits S of the fast kernel for n vertices at dimension
// dim on `device` to *splits and returns a cudaError_t.  S is chosen for
// the whole pass and used for a row range too, so that a range sums each
// of its rows exactly as the whole pass does.
int wembed_fused_dense_splits(int n, int dim, int device, int* splits) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || dim < 1 || dim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  switch (dim) {
    case 1: err = choose_splits<1>(n, device, splits); break;
    case 2: err = choose_splits<2>(n, device, splits); break;
    case 3: err = choose_splits<3>(n, device, splits); break;
    case 4: err = choose_splits<4>(n, device, splits); break;
    case 5: err = choose_splits<5>(n, device, splits); break;
    case 6: err = choose_splits<6>(n, device, splits); break;
    case 7: err = choose_splits<7>(n, device, splits); break;
    case 8: err = choose_splits<8>(n, device, splits); break;
  }
  return static_cast<int>(err);
}

// Enqueues the force pass of rows [row0, row0 + rows) on `stream` (the
// fast kernel: f32, dim <= kMaxDim) and returns the first launch error.
// Allocates nothing and does not synchronise; every buffer comes from the
// caller.  adj holds n * ceil(n / 32) words; part_force S * rows * dim
// floats, part_zero S * rows ints, part_loss 2 * ceil(rows / kRows) * S
// doubles, part_count ceil(rows / kRows) * S int64s, force rows * dim
// floats, zero_count rows ints, loss_out 2 floats, count_out one int64.
int wembed_fused_dense_forces(const float* pos, const float* invw, const int* colors,
                              const int* adj, int n, int dim, int row0, int rows, int splits,
                              double L,
                              double att_scale, double rep_scale, int additive,
                              float* part_force, int* part_zero, double* part_loss,
                              long long* part_count, float* force, int* zero_count,
                              float* loss_out, long long* count_out, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || dim < 1 || dim > kMaxDim || splits < 1 || splits > kMaxSplits || row0 < 0 ||
      rows < 1 || row0 + rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.pos = pos;
  p.invw = invw;
  p.colors = colors;
  p.adj = reinterpret_cast<const uint32_t*>(adj);
  p.n = n;
  p.W = (n + 31) / 32;
  p.row0 = row0;
  p.rows = rows;
  p.splits = splits;
  p.L = static_cast<float>(L);
  p.L2 = static_cast<float>(L * L);  // as the TPU kernel: L*L in double, compared in f32
  p.att_scale = static_cast<float>(att_scale);
  p.rep_scale = static_cast<float>(rep_scale);
  p.additive = additive;
  p.part_force = part_force;
  p.part_zero = part_zero;
  p.part_loss = part_loss;
  p.part_count = part_count;
  p.force = force;
  p.zero_count = zero_count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: err = launch<1>(p, s, loss_out, count_out); break;
    case 2: err = launch<2>(p, s, loss_out, count_out); break;
    case 3: err = launch<3>(p, s, loss_out, count_out); break;
    case 4: err = launch<4>(p, s, loss_out, count_out); break;
    case 5: err = launch<5>(p, s, loss_out, count_out); break;
    case 6: err = launch<6>(p, s, loss_out, count_out); break;
    case 7: err = launch<7>(p, s, loss_out, count_out); break;
    case 8: err = launch<8>(p, s, loss_out, count_out); break;
  }
  return static_cast<int>(err);
}

// Enqueues the general kernel's force pass of rows [row0, row0 + rows)
// on `stream`: positions, inverse weights, force and loss_out in f64 when
// `f64` is set, else f32, any dim >= 1.  part_loss holds
// 2 * ceil(rows / 16) doubles, part_count ceil(rows / 16) int64s, force
// rows * dim values, zero_count rows ints, loss_out 2 values, count_out
// one int64.
int wembed_fused_dense_general(const void* pos, const void* invw, const int* colors,
                               const int* adj, int n, int dim, int row0, int rows, int f64,
                               double L, double att_scale, double rep_scale, int additive,
                               void* force, int* zero_count, double* part_loss,
                               long long* part_count, void* loss_out, long long* count_out,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || dim < 1 || row0 < 0 || rows < 1 || row0 + rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    err = general<double>(pos, invw, colors, adj, n, dim, row0, rows, L, att_scale, rep_scale,
                          additive, force, zero_count, part_loss, part_count, loss_out,
                          count_out, device, s);
  } else {
    err = general<float>(pos, invw, colors, adj, n, dim, row0, rows, L, att_scale, rep_scale,
                         additive, force, zero_count, part_loss, part_count, loss_out,
                         count_out, device, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
