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
// The general kernel, fused_dense_general_kernel<T>, runs what the fast
// one does not take: f32 at d > kMaxDim and f64 at any d.  The dimension
// is a run-time value, so nothing is staged in tiles of compile-time
// width: one warp owns one row, each lane strides over the columns
// (positions read through L1/L2, the same bit adjacency), and a pair on
// the rare path hands its coefficient to the warp, which adds coeff * diff
// into the row's force in device memory, lane k % 32 owning dimension k,
// pairs in column order.  The masks' operations are those above, in T: in
// f64 the dead-zone test and the losses run in double.  Each row is summed
// by its own warp, so there are no splits.

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

template <typename T>
struct GeneralParams {
  const T* pos;            // (n, d) row-major
  const T* invw;           // (n,)
  const int* colors;       // (n,)
  const uint32_t* adj;     // (n, W) adjacency bits
  int n;
  int W;
  int d;
  int row0;
  int rows;
  T L;
  T L2;
  T att_scale;
  T rep_scale;
  int additive;
  T* force;                // out (rows, d), accumulated in place
  int* zero_count;         // out (rows,)
  double* part_loss;       // (gridDim.x, 2)
  long long* part_count;   // (gridDim.x,)
};

__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_dense_general_kernel(GeneralParams<T> p) {
  __shared__ double s_att[kWarps];
  __shared__ double s_rep[kWarps];
  __shared__ long long s_cnt[kWarps];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lrow = blockIdx.x * kWarps + warp;
  double att_loss = 0.0;
  double rep_loss = 0.0;
  long long count = 0;
  int zc = 0;
  if (lrow < p.rows) {  // uniform across the warp
    const int row = p.row0 + lrow;
    const T* pr = p.pos + (size_t)row * p.d;
    T* fr = p.force + (size_t)lrow * p.d;
    for (int k = lane; k < p.d; k += 32) fr[k] = T(0);
    const T iwr = p.invw[row];
    const int cr = p.colors[row];
    const uint32_t* arow = p.adj + (size_t)row * p.W;
    for (int c0 = 0; c0 < p.n; c0 += 32) {
      const int c = c0 + lane;
      const uint32_t word = arow[c0 / 32];
      T coeff = T(0);
      bool act = false;
      if (c < p.n) {
        const T* pc = p.pos + (size_t)c * p.d;
        T dist2 = T(0);
        for (int k = 0; k < p.d; ++k) {
          const T diff = pr[k] - pc[k];
          dist2 = dist2 + diff * diff;
        }
        const bool nbr = (word >> lane) & 1u;
        const T iwc = p.invw[c];
        const T ws = p.additive ? iwr + iwc : iwr * iwc;
        const T wdist2 = dist2 * (ws * ws);
        const bool close = wdist2 <= p.L2;
        if (close || nbr) {
          const bool rep = !nbr && (cr != p.colors[c]) && close;
          const bool att = nbr && (wdist2 > p.L2);
          const bool posd = dist2 > T(0);
          count += rep ? 1 : 0;
          zc += (!posd && (nbr || rep)) ? 1 : 0;
          if ((rep && posd) || att) {
            const T dist = ieee_sqrt(dist2);
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
      }
      // the warp adds each active pair's coeff * diff, in column order
      unsigned pending = __ballot_sync(0xffffffffu, act);
      while (pending) {
        const int j = __ffs(pending) - 1;
        pending &= pending - 1;
        const T cj = __shfl_sync(0xffffffffu, coeff, j);
        const T* pc = p.pos + (size_t)(c0 + j) * p.d;
        for (int k = lane; k < p.d; k += 32) fr[k] = fr[k] + cj * (pr[k] - pc[k]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) zc += __shfl_xor_sync(0xffffffffu, zc, off);
    if (lane == 0) p.zero_count[lrow] = zc;
  }
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

template <typename T>
cudaError_t launch_general(const GeneralParams<T>& p, cudaStream_t stream, T* loss_out,
                           long long* count_out) {
  const int blocks = (p.rows + kWarps - 1) / kWarps;
  fused_dense_general_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<T><<<1, kFinalizeThreads, 0, stream>>>(p.part_loss, p.part_count, blocks,
                                                         loss_out, count_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t general(const void* pos, const void* invw, const int* colors, const int* adj, int n,
                    int dim, int row0, int rows, double L, double att_scale, double rep_scale,
                    int additive, void* force, int* zero_count, double* part_loss,
                    long long* part_count, void* loss_out, long long* count_out,
                    cudaStream_t stream) {
  GeneralParams<T> p;
  p.pos = static_cast<const T*>(pos);
  p.invw = static_cast<const T*>(invw);
  p.colors = colors;
  p.adj = reinterpret_cast<const uint32_t*>(adj);
  p.n = n;
  p.W = (n + 31) / 32;
  p.d = dim;
  p.row0 = row0;
  p.rows = rows;
  p.L = static_cast<T>(L);
  p.L2 = static_cast<T>(L * L);
  p.att_scale = static_cast<T>(att_scale);
  p.rep_scale = static_cast<T>(rep_scale);
  p.additive = additive;
  p.force = static_cast<T*>(force);
  p.zero_count = zero_count;
  p.part_loss = part_loss;
  p.part_count = part_count;
  return launch_general<T>(p, stream, static_cast<T*>(loss_out), count_out);
}

}  // namespace

extern "C" {

// Rows per CTA of the fast kernel: the wrapper sizes the
// (ceil(rows / kRows) * S, 2) and (ceil(rows / kRows) * S,) partial
// buffers from it.
int wembed_fused_dense_rows_per_block() { return kRows; }

// Rows per CTA of the general kernel (one warp a row).
int wembed_fused_dense_general_rows_per_block() { return kWarps; }

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
// 2 * ceil(rows / 8) doubles, part_count ceil(rows / 8) int64s, force
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
                          count_out, s);
  } else {
    err = general<float>(pos, invw, colors, adj, n, dim, row0, rows, L, att_scale, rep_scale,
                         additive, force, zero_count, part_loss, part_count, loss_out,
                         count_out, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
