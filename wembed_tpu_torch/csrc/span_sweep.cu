// Span sweep kernel for Hopper (sm_90a): the repulsion candidate sweep of
// the span path, one query block of 256 vertices against the member tiles
// of its candidate windows.
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
// do not depend on it.
//
// The masks must agree bit for bit with the plain PyTorch twin
// (kernels/span_sweep.py:span_sweep_reference), so this file is compiled
// with --fmad=false and never with --use_fast_math.
//
// Work layout, in place of the TPU's sequential grid over a flattened work
// list with its `first` flags: one CTA per query block i, 256 threads, one
// query slot a thread, its record held in registers.  The CTA walks its own
// windows: for each row g with blk_t[i, g] > 0 it takes the tiles
// start_tile[i, g] ... start_tile[i, g] + blk_t[i, g] - 1 of row g's padded
// member range, stages each tile's 256 member records in shared memory and
// loops over them.  Each slot's sums live in registers and are written
// once: no atomics, no revisits, deterministic.  A block with no tile
// writes zeros.
//
// What bounds it on an H100: FP32 work, about 20 operations on each of
// roughly 1e9 pairs a step at girg100k mid-run (the byte traffic is one
// 256-member tile of (d + 3) floats per 65,536 pairs).  Known and left for
// later work: load imbalance across blocks (girg100k has 393 CTAs on 132
// SMs, with very uneven tile counts per block), so splitting a block's
// tiles across CTAs, and cp.async/TMA staging of the next tile.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 256;   // query slots per block (one per thread)
constexpr int kST = 256;  // members per tile
constexpr int kMaxDim = 8;

struct Params {
  const float* qrec;       // (nb * kQ, D + 3): pos(D), invw, lw^2, rawexp
  const int* qcol;         // (nb * kQ,)
  const float* srec;       // (tiles * kST, D + 3): pos(D), invw, bm2, rawexp
  const int* scol;         // (tiles * kST,)
  const int* blk_t;        // (nb, R) window widths in tiles
  const int* start_tile;   // (nb, R) first tile of each window, row-local
  const int* tile_off;     // (R,) first tile of each row's padded range
  int R;
  float L;
  float L2;
  float rep_scale;
  int additive;
  float* force;            // out (nb * kQ, D)
  float* loss;             // out (nb * kQ,)
  int* count;              // out (nb * kQ,)
  int* zero;               // out (nb * kQ,)
};

template <int D>
__global__ void __launch_bounds__(kQ) span_sweep_kernel(Params p) {
  constexpr int C = D + 3;
  __shared__ float s_rec[kST * C];
  __shared__ int s_col[kST];

  const int blk = blockIdx.x;
  const size_t slot = (size_t)blk * kQ + threadIdx.x;
  float q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = p.qrec[slot * C + c];
  const int qc = p.qcol[slot];

  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.0f;
  float lsum = 0.0f;
  int cnt = 0;
  int zc = 0;

  for (int g = 0; g < p.R; ++g) {
    const int t_len = p.blk_t[blk * p.R + g];  // uniform across the CTA
    if (t_len <= 0) continue;
    const int t0 = p.tile_off[g] + p.start_tile[blk * p.R + g];
    for (int t = 0; t < t_len; ++t) {
      const size_t base = (size_t)(t0 + t) * kST;
      __syncthreads();  // the previous tile is consumed
      for (int e = threadIdx.x; e < kST * C; e += kQ) s_rec[e] = p.srec[base * C + e];
      s_col[threadIdx.x] = p.scol[base + threadIdx.x];
      __syncthreads();

      for (int m = 0; m < kST; ++m) {
        const float* s = s_rec + m * C;
        float diff[D];
        float dist2 = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = q[k] - s[k];
          dist2 = dist2 + diff[k] * diff[k];
        }
        const bool valid = (dist2 <= q[D + 1] * s[D + 1]) && (qc != s_col[m]);
        if (!valid) continue;
        ++cnt;
        if (!(dist2 > 0.0f)) {
          ++zc;
          continue;
        }
        const float ws = p.additive ? q[D] + s[D] : q[D] * s[D];
        if (!(dist2 * (ws * ws) <= p.L2)) continue;
        const float dist = sqrtf(dist2);
        const float inv = 1.0f / dist;
        const float coeff = p.rep_scale * ws * inv;
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = acc[k] + coeff * diff[k];
        const float l_over_ws = p.additive ? p.L / ws : (p.L * q[D + 2]) * s[D + 2];
        lsum = lsum + (l_over_ws - dist);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < D; ++k) p.force[slot * D + k] = acc[k];
  p.loss[slot] = lsum;
  p.count[slot] = cnt;
  p.zero[slot] = zc;
}

template <int D>
void launch(const Params& p, int nb, cudaStream_t stream) {
  span_sweep_kernel<D><<<nb, kQ, 0, stream>>>(p);
}

}  // namespace

extern "C" {

int wembed_span_sweep_block() { return kQ; }

int wembed_span_sweep_tile() { return kST; }

int wembed_span_sweep_max_dim() { return kMaxDim; }

const char* wembed_span_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues the sweep on `stream` and returns cudaGetLastError().  Allocates
// nothing and does not synchronise; every buffer comes from the caller.
int wembed_span_sweep(const float* qrec, const int* qcol, const float* srec,
                      const int* scol, const int* blk_t, const int* start_tile,
                      const int* tile_off, int nb, int R, int dim, double L,
                      double rep_scale, int additive, float* force, float* loss,
                      int* count, int* zero, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || R < 1 || dim < 1 || dim > kMaxDim) {
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
  p.R = R;
  p.L = static_cast<float>(L);
  p.L2 = static_cast<float>(L * L);  // as the TPU kernel: L*L in double, compared in f32
  p.rep_scale = static_cast<float>(rep_scale);
  p.additive = additive;
  p.force = force;
  p.loss = loss;
  p.count = count;
  p.zero = zero;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: launch<1>(p, nb, s); break;
    case 2: launch<2>(p, nb, s); break;
    case 3: launch<3>(p, nb, s); break;
    case 4: launch<4>(p, nb, s); break;
    case 5: launch<5>(p, nb, s); break;
    case 6: launch<6>(p, nb, s); break;
    case 7: launch<7>(p, nb, s); break;
    case 8: launch<8>(p, nb, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
