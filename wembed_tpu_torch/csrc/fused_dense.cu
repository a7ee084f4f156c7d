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
// What bounds it on an H100: per step it reads the n*n u8 adjacency
// (100 MB at n = 10,000, 105 MB at n = 10,240), does about 30 FP32
// operations on every pair for the distance, the masks and the tallies,
// and an IEEE sqrt and two divisions on every active pair (at most n^2,
// about 1e8 at n = 10,000).  The simple design reads every adjacency byte
// exactly once (each warp loads 32 consecutive bytes of its row), stages
// each column tile's positions, inverse weights and colours once per CTA in
// shared memory, and pays the sqrt and divisions only on active pairs.
// A bitmask adjacency (8x fewer bytes), cp.async/TMA staging of the next
// tile and a wider row block per warp are left for later work.
//
// Layout: one CTA owns kRows consecutive rows (kRowsPerWarp per warp) and
// walks over all columns in tiles of kTileC.  Each row's force and
// coincident count belong to one warp, so they are reduced with shuffles
// and written once: no atomics, no revisits.  The two losses and the
// candidate count go out as per-CTA partials and are summed by a second
// kernel in a fixed order, so results are deterministic.  The count is
// integer (the TPU kernel counts in f32, exact only below 2^24).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kTileC = 512;
constexpr int kMaxDim = 8;
constexpr int kFinalizeThreads = 256;

struct Params {
  const float* pos;        // (n, D) row-major
  const float* invw;       // (n,)
  const int* colors;       // (n,)
  const uint8_t* adj;      // (n, n) row-major, nonzero where an edge exists
  int n;
  float L;
  float L2;
  float att_scale;
  float rep_scale;
  int additive;
  float* force;            // out (n, D)
  int* zero_count;         // out (n,)
  double* part_loss;       // out (gridDim.x, 2): attraction, repulsion
  long long* part_count;   // out (gridDim.x,)
};

template <int D>
__global__ void __launch_bounds__(kThreads) fused_dense_kernel(Params p) {
  __shared__ float s_pos[D][kTileC];
  __shared__ float s_invw[kTileC];
  __shared__ int s_col[kTileC];
  __shared__ double s_att[kWarps];
  __shared__ double s_rep[kWarps];
  __shared__ long long s_cnt[kWarps];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows + warp * kRowsPerWarp;

  float pr[kRowsPerWarp][D];
  float facc[kRowsPerWarp][D];
  float iwr[kRowsPerWarp];
  int cr[kRowsPerWarp];
  int zc[kRowsPerWarp];
  bool rv[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    rv[r] = row < p.n;
    const int rr = rv[r] ? row : 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      pr[r][k] = p.pos[(size_t)rr * D + k];
      facc[r][k] = 0.0f;
    }
    iwr[r] = p.invw[rr];
    cr[r] = p.colors[rr];
    zc[r] = 0;
  }
  double att_loss = 0.0;  // the loss terms are f32; their sums are kept in double
  double rep_loss = 0.0;
  int count = 0;

  for (int c0 = 0; c0 < p.n; c0 += kTileC) {
    const int tc = min(kTileC, p.n - c0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < tc; i += kThreads) {
      const int c = c0 + i;
#pragma unroll
      for (int k = 0; k < D; ++k) s_pos[k][i] = p.pos[(size_t)c * D + k];
      s_invw[i] = p.invw[c];
      s_col[i] = p.colors[c];
    }
    __syncthreads();

    for (int i = lane; i < tc; i += 32) {
      float pc[D];
#pragma unroll
      for (int k = 0; k < D; ++k) pc[k] = s_pos[k][i];
      const float iwc = s_invw[i];
      const int cc = s_col[i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (!rv[r]) continue;  // uniform across the warp
        const bool nbr = p.adj[(size_t)(row0 + r) * p.n + c0 + i] != 0;
        float diff[D];
        float dist2 = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = pr[r][k] - pc[k];
          dist2 = dist2 + diff[k] * diff[k];
        }
        const float ws = p.additive ? iwr[r] + iwc : iwr[r] * iwc;
        const float wdist2 = dist2 * (ws * ws);
        const bool rep = !nbr && (cr[r] != cc) && (wdist2 <= p.L2);
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
      const int row = row0 + r;
#pragma unroll
      for (int k = 0; k < D; ++k) p.force[(size_t)row * D + k] = facc[r][k];
      p.zero_count[row] = zc[r];
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

// Sums the per-CTA partials in a fixed order; the losses leave as f32.
__global__ void __launch_bounds__(kFinalizeThreads)
finalize_kernel(const double* part_loss, const long long* part_count, int num_parts,
                float* loss_out, long long* count_out) {
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
    loss_out[0] = (float)s_a[0];
    loss_out[1] = (float)s_b[0];
    count_out[0] = s_c[0];
  }
}

template <int D>
void launch(const Params& p, int blocks, cudaStream_t stream) {
  fused_dense_kernel<D><<<blocks, kThreads, 0, stream>>>(p);
}

}  // namespace

extern "C" {

// Rows per CTA: the wrapper sizes the (ceil(n / rows), 2) and
// (ceil(n / rows),) partial buffers from it.
int wembed_fused_dense_rows_per_block() { return kRows; }

int wembed_fused_dense_max_dim() { return kMaxDim; }

const char* wembed_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues the force pass on `stream` and returns cudaGetLastError().
// Allocates nothing and does not synchronise; every buffer comes from the
// caller.  part_loss holds 2 * ceil(n / rows) doubles, part_count
// ceil(n / rows) int64s, loss_out 2 floats, count_out one int64.
int wembed_fused_dense_forces(const float* pos, const float* invw, const int* colors,
                              const unsigned char* adj, int n, int dim, double L,
                              double att_scale, double rep_scale, int additive,
                              float* force, int* zero_count, double* part_loss,
                              long long* part_count, float* loss_out,
                              long long* count_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || dim < 1 || dim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.pos = pos;
  p.invw = invw;
  p.colors = colors;
  p.adj = adj;
  p.n = n;
  p.L = static_cast<float>(L);
  p.L2 = static_cast<float>(L * L);  // as the TPU kernel: L*L in double, compared in f32
  p.att_scale = static_cast<float>(att_scale);
  p.rep_scale = static_cast<float>(rep_scale);
  p.additive = additive;
  p.force = force;
  p.zero_count = zero_count;
  p.part_loss = part_loss;
  p.part_count = part_count;
  const int blocks = (n + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: launch<1>(p, blocks, s); break;
    case 2: launch<2>(p, blocks, s); break;
    case 3: launch<3>(p, blocks, s); break;
    case 4: launch<4>(p, blocks, s); break;
    case 5: launch<5>(p, blocks, s); break;
    case 6: launch<6>(p, blocks, s); break;
    case 7: launch<7>(p, blocks, s); break;
    case 8: launch<8>(p, blocks, s); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<1, kFinalizeThreads, 0, s>>>(part_loss, part_count, blocks, loss_out,
                                                  count_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
