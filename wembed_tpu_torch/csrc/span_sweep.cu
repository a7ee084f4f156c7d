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
// tiles).  One CTA (256 threads, 8 warps) takes one item and walks the
// windows from there with this step's start_tile.  The same work-list form
// serves the cells layout and the halo sweep.  About 99% of the pairs fail
// the radius test, so a member tile goes through two stages:
//
// 1. Prefilter on the tensor cores.  The tile's 256 x 256 pairs are first
//    tested with one product of depth d + 3.  With c the midpoint of the
//    bounding box of the block's queries that have a positive radius
//    factor and finite positions (the padding slots carry 0),
//    qt = fl(q - c), st = fl(s - c) and
//      u_q = [qt, Nq, 1, |lw_q^2|],   v_s = [-2 st, 1, Ns, -fl(|bm2_s| (1 + EPS))],
//      N = fmaf(n, 1 - EPS, -TAU / 2),  n = sum_k t_k^2 (fmaf, any order),
//    with N = -inf when n >= 2^110 or n is NaN, u_q . v_s approximates
//    dist2 - lw_q^2 bm2_s less a margin.  Each entry x is split into two
//    TF32 values, x_b = tf32(x), x_s = tf32(x - x_b) (round to nearest,
//    ties away), and mma.sync (m16n8k4 at d = 1, m16n8k8 at d = 2-5, two
//    k8 steps at d = 6-8) sums A_s B_b + A_b B_s + A_b B_b in f32: the
//    3xTF32 product, A.  A pair is REJECTED when A > 0.  Each warp holds
//    the split rows of 32 query slots in registers for the whole item and
//    reads the tile's split member fragments (built once a tile, one thread
//    a member) from shared memory.  The members are ordered in the B
//    fragments so that each lane's accumulators cover its four query rows
//    against one contiguous quarter of the tile: a lane sets its rows' pass
//    bits in registers, one compare and one OR a pair, and writes them as
//    words of a per-(query slot, member) mask in shared memory (32 words a
//    slot; no vote, no shuffle).
//
//    No pair that the exact test accepts is rejected: whenever
//    dist2 <= fl(lw^2 * bm2) (the exact test's f32 values), A < 0 or A is
//    NaN.  u = 2^-24; a = |qt|, b = |st|, T = |lw^2| |bm2| (reals);
//    D = |q - s|^2, Dt = |qt - st|^2.  For n < 2^110 (else A is -inf or
//    NaN):
//    (i) centring: fl(x - c) = (x - c)(1 + e), |e| <= u, so
//        |(qt - st) - (q - s)| <= u'(a + b), u' = u / (1 - u); with
//        sqrt(D) <= (a + b) / (1 - u):  Dt <= D + 6.01 u (a^2 + b^2).
//    (ii) dist2 rounds d + 2 times in a chain (difference, square, d - 1
//        adds; no FMA): dist2 >= D (1 - (d + 2) u) - d 2^-149 (squares that
//        underflow), and D <= 2.01 (a^2 + b^2), so
//        Dt <= dist2 + (2d + 10.1) u (a^2 + b^2) + 2^-145.
//    (iii) the exact product: n <= a^2 (1 + 1.01 d u), so
//        N <= a^2 - (EPS - (d + 2) u) a^2 - 0.49 TAU, and
//        fl(|bm2| (1 + EPS)) >= |bm2| (1 + EPS - 2u), so
//        u_q . v_s <= Dt - (EPS - (d + 2) u)(a^2 + b^2) - 0.98 TAU
//                     - T (1 + EPS - 2u).
//    (iv) the split: |x - x_b| <= 2^-11 |x|, |x - x_b - x_s| <= 2^-22 |x|,
//        so each product loses at most 3.002 2^-22 |x| |y|; over the row,
//        with S = sum_k |u_k| |v_k| <= 2.01 (a^2 + b^2) + TAU + 1.0001 T:
//        at most 12.01 u S.
//    (v) the accumulation: a TF32 x TF32 product is exact in f32 (22 bits);
//        an mma.sync of k products and the accumulator is taken to be
//        within (k + 2) 2^-23 of the sum of the absolute values of its
//        k + 1 terms, which covers f32 additions in any order (each within
//        2^-23 relative, round to nearest or toward zero) and an aligned
//        sum in a window of >= 24 bits with truncation.  Each mma's terms
//        add to at most 1.003 S; three mma a k-step of depth 8, two
//        k-steps at most: 6 (8 + 2) 2 (1.003) u S <= 120.4 u S.  Subnormal
//        inputs or products flushed to zero change a product by at most
//        2^-126 max(1, |other factor|): at most 2^-118 (1 + a^2 + b^2 + T).
//    (vi) the threshold: fl(lw^2 * bm2) <= T (1 + u) + 2^-150.
//    Adding (i)-(vi), for dist2 <= fl(lw^2 * bm2):
//      A <= -(EPS - 302 u)(a^2 + b^2) - (EPS - 136 u) T - 0.97 TAU + 2^-116,
//    and EPS = 2^-14 = 1024 u, TAU = 2^-100 make that < 0 (the margins are
//    3.4 and 7.5 times the bounds).  A NaN entry makes A NaN, which
//    passes; the exact test rejects such a pair as before.  Sentinel
//    records (positions +-1e15, radius factor 0) take their margin from
//    their own norms, ~1e30, and still fail: their distance to anything
//    real is ~1e30 as well.
//
// 2. Exact pass, the parent kernel's arithmetic.  Each thread keeps QPT
//    query slots and one member phase (a contiguous quarter of the tile at
//    d <= 4, a half at d > 4) with its sums in registers, as before.  For
//    each slot it walks the set bits of its phase's mask in ascending
//    member order and runs the exact test and the candidate path on each:
//    the same operations on the same operands as before.  A pair that the
//    prefilter drops adds nothing to
//    any sum in the parent kernel either, so every sum sees the same
//    operands in the same order and the outputs are bitwise the parent's.
//
// Pipeline.  Between two barriers a CTA runs the exact pass of tile i,
// the prefilter of tile i + 1 and the split fragments of tile i + 2 (one
// thread a member, from the record it started copying one interval
// before), so a warp with a long exact pass delays no other warp's
// tensor-core work.  Fragments and masks are double-buffered; the member
// records are copied with cp.async into four staging buffers (at d <= 5:
// at d >= 6 the two-step fragments leave no room, so each thread holds its
// member's record in registers and the exact pass reads records through
// L1).  At the end of an item
// the phases' sums are added in phase order through shared memory and
// written to a per-item scratch buffer; a second kernel, span_reduce_kernel
// (below the item kernel), adds each block's items in item order.  No
// atomics: deterministic.
//
// What bounds it on an H100.  The prefilter: 3 NKS mma of 16 x 8 x KK a
// 128 pairs, i.e. 24 TF32 FLOP a pair at d = 1, 48 at d = 2-5 and 96 at
// d = 6-8, at 495 TFLOP/s dense; then a compare and an OR a pair.  The
// exact pass: (3d + 1) FLOP and ~16 instructions on the pairs that pass
// (chip_smoke.py prints their share beside the candidates'), ~14 more FLOP
// with a sqrt and a division on the candidates.  The bytes (query and member
// records, the tables) are a few MB: ~2 us at 3.35 TB/s.  The instruction
// stream and its latencies bound it: the mma, the compares with the
// pipeline's builds and barriers, and the exact pass's dependent chains
// (its lanes walk different numbers of passes).  The benchmark's bound
// still counts (3d + 1) FP32 FLOP a pair at 67 TFLOP/s.
//
// The general kernel, span_sweep_general_kernel<T>, runs what the fast one
// does not take: f32 at d > kMaxDim and f64 at any d, over the same work
// items and the same per-item scratch layout, with no prefilter.  Its
// outputs are bitwise those of the simple kernel it replaced (one thread a
// slot reading every member record through L1 and adding into the scratch
// in device memory): each slot's partial is a left fold from +0 over the
// item's members in walk order, with the operations of the exact pass
// above in T.  What bounds it is the common path's 3d + 1 operations a
// pair in T and the radius test, so it stages and reuses:
//   - a CTA still takes one item and a thread one query slot, whose
//     extras (inverse weight, lw^2, rawexp, colour) stay in registers;
//   - d is staged in slabs of GenCfg<T>::DS dimensions (16 in f32, 8 in
//     f64) with cp.async, double-buffered, one barrier a step: the block's
//     query slab ([k][slot], each thread reads its own) and the members'
//     ([k][member], read as 16-byte broadcasts), with the members' inverse
//     weights, bm2, rawexp and colours at a group's last slab.  Where d fits
//     one slab a step is a whole tile and the queries are staged once;
//     else a step is one slab of a sub-tile of MB members;
//   - each thread keeps the dist2 of its slot against a sub-tile of MB
//     members (32 in f32, 16 in f64) in registers across the slabs, so a
//     staged member value serves the CTA's 256 slots in one broadcast;
//   - after the last slab the radius and colour tests give the sub-tile's
//     candidate bits, and the thread walks them in member order: the
//     counts, the weighted test, the sqrt and division, and coeff * (q - s)
//     added into the slot's sums, which live in shared memory ([k][slot],
//     d x 256 values) or, for a d too wide for that, in its scratch column.
// Counts go through the scratch as T (at most 4 x 256 pairs an item, exact
// in f32).  span_reduce_general_kernel<T> adds each block's items in item
// order, one thread a slot, after the bounds search of the fast reduction.
//
// One rank's share of the replicated multi-device step is a contiguous
// slice items[lo:hi] of the table: a block with no items in the slice gets
// zeros from the reduction, so the slice sweeps exactly that share.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 256;        // query slots per block
constexpr int kST = 256;       // members per tile
constexpr int kThreads = 256;  // threads per item CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 8;
constexpr int kMaskWords = kST / 32;     // 32-bit prefilter mask words of a query slot
constexpr int kMaxDevices = 64;          // devices whose shared-memory attribute is cached
constexpr float kMarginRel = 0x1p-14f;   // EPS of the header's derivation
constexpr float kMarginAbs = 0x1p-100f;  // TAU
constexpr float kNormCap = 0x1p110f;     // squared norms at or above it pass unconditionally
constexpr int kLanes = kQ / 4;           // reduction threads a channel, four slots (16 bytes) each
constexpr int kUnroll = 8;               // items whose loads a reduction thread issues before it folds

static_assert(kThreads == kQ, "the item epilogue gives each thread one slot");
static_assert(kThreads == kST, "the tile's prefilter rows are built one thread a member");
static_assert(kQ == 32 * kWarps, "each warp takes 32 query rows of the prefilter");

template <int D>
struct Cfg {
  static constexpr int C = D + 3;                    // record channels in global memory
  static constexpr int P = (D + 4 + 3) / 4 * 4;      // staged floats a record (+ colour), float4-padded
  static constexpr int QPT = D <= 4 ? 4 : 2;         // query slots a thread
  static constexpr int SG = kQ / QPT;                // threads sharing a member phase
  static constexpr int MG = kThreads / SG;           // member phases
  static constexpr int MPP = kST / MG;               // members a phase sweeps
  static constexpr int KK = D + 3 <= 4 ? 4 : 8;      // mma depth: m16n8k4 or m16n8k8
  static constexpr int NKS = (D + 3 + KK - 1) / KK;  // k-steps
  static constexpr int KP = KK * NKS;                // padded depth of the prefilter rows
  // shared memory, in floats
  static constexpr int kFrag = 2 * kST * KP;         // split member fragments of one tile
  static constexpr int kQs = kQ * P;                 // the block's query records
  static constexpr int kMask = kQ * kMaskWords;      // prefilter masks of one tile
  // member records staged in shared memory by cp.async (four tiles in
  // flight) where two CTAs an SM still fit; else each thread holds its
  // member's record in registers until it builds the row, and the exact
  // pass reads records through L1
  static constexpr bool kStage = NKS == 1;
  static constexpr int kRaw = kStage ? kST * P : 0;
  static constexpr int kCen = kMaxDim + 2 * kWarps * kMaxDim;  // centre and its reduction
  static constexpr int kLayout = 2 * kFrag + 2 * kMask + 4 * kRaw + kQs + kCen;
  static constexpr int kRed = MG * C * kQ;           // epilogue partials (words), reusing the layout
  static constexpr int kSmemBytes = 4 * (kLayout > kRed ? kLayout : kRed);
  static_assert(SG % 32 == 0, "a warp must share one member phase");
  static_assert(MPP % 64 == 0, "a phase's mask is whole 64-bit words");
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

// Pairs the prefilter passed, added up while g_count_passes is set
// (wembed_span_sweep_count_passes); for measurement, off on the main path.
__device__ int g_count_passes;
__device__ unsigned long long g_passes;

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero, as a float whose low 13 bits are zero.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The squared-norm entry of a prefilter row: n less the margin, or -inf
// (the pair then always passes) for n >= 2^110 or NaN.
__device__ __forceinline__ float norm_entry(float n) {
  return n < kNormCap ? __fmaf_rn(n, 1.0f - kMarginRel, -0.5f * kMarginAbs)
                      : -__int_as_float(0x7f800000);
}

// d += a b over one k-step: m16n8k8 (a: 4 registers, b: 2) or m16n8k4 (2, 1).
template <int KK>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned* a, const unsigned* b);

template <>
__device__ __forceinline__ void mma_tf32<8>(float (&d)[4], const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma_tf32<4>(float (&d)[4], const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// Member `m` of tile `tile`: its record [pos(D), invw, bm2, rawexp] and colour.
template <int D>
struct Member {
  float r[D + 3];
  int col;
};

template <int D>
__device__ __forceinline__ void load_member(const Params& p, int tile, int m, Member<D>& s) {
  const float* r = p.srec + ((size_t)tile * kST + m) * (D + 3);
#pragma unroll
  for (int c = 0; c < D + 3; ++c) s.r[c] = __ldg(r + c);
  s.col = __ldg(p.scol + (size_t)tile * kST + m);
}

// Starts copying member `m` of tile `tile` into the staging buffer `raw` as
// [pos(D), invw, bm2, rawexp, colour], and commits the copy group (an empty
// one when `tile` < 0): one group an iteration, so that cp_async_wait<1>
// waits for the previous iteration's.
template <int D>
__device__ __forceinline__ void stage_member(const Params& p, int tile, int m, float* raw) {
  if (tile >= 0) {
    const float* r = p.srec + ((size_t)tile * kST + m) * (D + 3);
#pragma unroll
    for (int c = 0; c < D + 3; ++c) cp_async4(raw + m * Cfg<D>::P + c, r + c);
    cp_async4(raw + m * Cfg<D>::P + D + 3, p.scol + (size_t)tile * kST + m);
  }
  cp_async_commit();
}

// The split prefilter row of member `m` (its record `r`), written into
// `frag` as the mma B fragments of its n8 group.  Member 64t + 2n + e is
// column 2t + e of group n, so that lane (groupID g, threadID_in_group t)
// accumulates every pair of its four query rows with the contiguous
// quarter 64t ... 64t + 63 of the tile, bit 2n + e of the quarter's mask.
// `frag` holds, for each (group, k-step, lane), the lane's big then small
// halves.
template <int D>
__device__ __forceinline__ void build_member(const float* r, const float* cen, float* frag, int m) {
  using K = Cfg<D>;
  constexpr int KK = K::KK, NKS = K::NKS, KP = K::KP;
  float v[KP];
  float n = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float t = r[k] - cen[k];
    v[k] = -2.0f * t;
    n = __fmaf_rn(t, t, n);
  }
  v[D] = 1.0f;
  v[D + 1] = norm_entry(n);
  v[D + 2] = -(fabsf(r[D + 1]) * (1.0f + kMarginRel));
#pragma unroll
  for (int k = D + 3; k < KP; ++k) v[k] = 0.0f;
  const int grp = (m >> 1) & 31, col = 2 * (m >> 6) + (m & 1);
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int lane = 4 * col + t;  // the lane of groupID col, threadID_in_group t
      if constexpr (KK == 8) {
        const float x0 = v[ks * 8 + t], x1 = v[ks * 8 + t + 4];
        const float b0 = tf32(x0), b1 = tf32(x1);
        reinterpret_cast<float4*>(frag)[(grp * NKS + ks) * 32 + lane] =
            make_float4(b0, b1, tf32(x0 - b0), tf32(x1 - b1));
      } else {
        const float x0 = v[ks * 4 + t];
        const float b0 = tf32(x0);
        reinterpret_cast<float2*>(frag)[(grp * NKS + ks) * 32 + lane] = make_float2(b0, tf32(x0 - b0));
      }
    }
  }
}

// The B fragments (big and small halves) of n8 group `grp` for this lane.
template <int D>
__device__ __forceinline__ void load_group(const float* frag, int grp, int lane,
                                           unsigned (&sb)[Cfg<D>::NKS][Cfg<D>::KK / 4],
                                           unsigned (&ss)[Cfg<D>::NKS][Cfg<D>::KK / 4]) {
  using K = Cfg<D>;
#pragma unroll
  for (int ks = 0; ks < K::NKS; ++ks) {
    if constexpr (K::KK == 8) {
      const float4 x = reinterpret_cast<const float4*>(frag)[(grp * K::NKS + ks) * 32 + lane];
      sb[ks][0] = __float_as_uint(x.x);
      sb[ks][1] = __float_as_uint(x.y);
      ss[ks][0] = __float_as_uint(x.z);
      ss[ks][1] = __float_as_uint(x.w);
    } else {
      const float2 x = reinterpret_cast<const float2*>(frag)[(grp * K::NKS + ks) * 32 + lane];
      sb[ks][0] = __float_as_uint(x.x);
      ss[ks][0] = __float_as_uint(x.y);
    }
  }
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
  constexpr int KK = K::KK, NKS = K::NKS, KP = K::KP;
  extern __shared__ __align__(16) float smem[];
  float* const frag = smem;  // two buffers of split member fragments
  unsigned* const mask = reinterpret_cast<unsigned*>(smem + 2 * K::kFrag);  // two (kQ, kMaskWords)
  float* const raw = reinterpret_cast<float*>(mask + 2 * K::kMask);  // four staged member tiles
  float* const qs = raw + 4 * K::kRaw;  // query records [pos(D), invw, lw^2, rawexp, colour]
  float* const cen = qs + K::kQs;       // the block's centre
  float* const red = cen + kMaxDim;     // (kWarps, kMaxDim, 2)

  const int4 item = p.items[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sg = tid % SG;
  const int mp = tid / SG;  // uniform across a warp

  // ---- the block's queries: records into shared memory, the centre, the
  // split prefilter rows (through the second fragment buffer), each warp's
  // fragments of its 32 rows into registers
  unsigned qa[2][NKS][KK / 2], qb[2][NKS][KK / 2];  // small and big halves, two m16 groups
  {
    const size_t slot = (size_t)item.x * kQ + tid;
    float qv[C];
    bool real = true;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qv[c] = p.qrec[slot * C + c];
      qs[tid * P + c] = qv[c];
    }
    qs[tid * P + C] = __int_as_float(p.qcol[slot]);
#pragma unroll
    for (int k = 0; k < D; ++k) real = real && isfinite(qv[k]);
    real = real && qv[D + 1] > 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float lo = real ? qv[k] : __int_as_float(0x7f800000);
      float hi = real ? qv[k] : -__int_as_float(0x7f800000);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) {
        red[(warp * kMaxDim + k) * 2] = lo;
        red[(warp * kMaxDim + k) * 2 + 1] = hi;
      }
    }
    __syncthreads();
    if (tid < D) {
      float lo = red[tid * 2], hi = red[tid * 2 + 1];
      for (int w = 1; w < kWarps; ++w) {
        lo = fminf(lo, red[(w * kMaxDim + tid) * 2]);
        hi = fmaxf(hi, red[(w * kMaxDim + tid) * 2 + 1]);
      }
      cen[tid] = lo <= hi ? 0.5f * lo + 0.5f * hi : 0.0f;  // no real query: any centre will do
    }
    __syncthreads();
    float u[KP];
    float n = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float t = qv[k] - cen[k];
      u[k] = t;
      n = __fmaf_rn(t, t, n);
    }
    u[D] = norm_entry(n);
    u[D + 1] = 1.0f;
    u[D + 2] = fabsf(qv[D + 1]);
#pragma unroll
    for (int k = D + 3; k < KP; ++k) u[k] = 0.0f;
    float* big = frag + K::kFrag;
    float* small = big + kQ * KP;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const float b = tf32(u[k]);
      big[tid * KP + k] = b;
      small[tid * KP + k] = tf32(u[k] - b);
    }
    __syncthreads();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = 32 * warp + 16 * h + g;  // rows r0 and r0 + 8
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        const int k0 = ks * KK + t;
        qb[h][ks][0] = __float_as_uint(big[r0 * KP + k0]);
        qb[h][ks][1] = __float_as_uint(big[(r0 + 8) * KP + k0]);
        qa[h][ks][0] = __float_as_uint(small[r0 * KP + k0]);
        qa[h][ks][1] = __float_as_uint(small[(r0 + 8) * KP + k0]);
        if constexpr (KK == 8) {
          qb[h][ks][2] = __float_as_uint(big[r0 * KP + k0 + 4]);
          qb[h][ks][3] = __float_as_uint(big[(r0 + 8) * KP + k0 + 4]);
          qa[h][ks][2] = __float_as_uint(small[r0 * KP + k0 + 4]);
          qa[h][ks][3] = __float_as_uint(small[(r0 + 8) * KP + k0 + 4]);
        }
      }
    }
    // the first barrier of the tile loop frees the second buffer
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
  unsigned long long passes = 0;

  // the pipeline: at iteration i, the exact pass of tile i, the prefilter
  // of tile i + 1, the fragments of tile i + 2 and the load of tile i + 3's
  // member records (tile j staged in buffer j % 4)
  Walk walk{item.x, item.y, item.z, 0, 0};
  walk.load_row(p);
  Member<D> srow;  // unstaged: this thread's member of the next tile to build
  int tile_pre = walk.tile(), tile_ex = -1, tile_build = -1;
  if constexpr (K::kStage) {
    stage_member<D>(p, tile_pre, tid, raw);
    cp_async_wait<0>();
    build_member<D>(raw + tid * P, cen, frag, tid);
  } else {
    load_member<D>(p, tile_pre, tid, srow);
    build_member<D>(srow.r, cen, frag, tid);
  }
  if (item.w > 1) {
    walk.next(p);
    tile_build = walk.tile();
  }
  if constexpr (K::kStage) {
    stage_member<D>(p, tile_build, tid, raw + K::kRaw);
  } else if (tile_build >= 0) {
    load_member<D>(p, tile_build, tid, srow);
  }

  for (int i = -1; i < item.w; ++i) {
    __syncthreads();  // fragments i + 1 and mask i are complete; fragments i and mask i - 1 free
    int tile_next = -1;  // tile i + 3
    if (i + 3 < item.w) {
      walk.next(p);
      tile_next = walk.tile();
    }
    if constexpr (K::kStage) stage_member<D>(p, tile_next, tid, raw + ((i + 3) & 3) * K::kRaw);

    if (i >= 0) {
      // ---- the exact pass of tile i over the members its prefilter let
      // through, in ascending order within each (slot, phase): the parent
      // kernel's arithmetic on the same operands
      const unsigned* mk = mask + (i & 1) * K::kMask;
      const float* staged = raw + (i & 3) * K::kRaw;
      const float* tile_rec = p.srec + (size_t)tile_ex * kST * C;
      const int* tile_col = p.scol + (size_t)tile_ex * kST;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int slot = sg + j * SG;
        const unsigned long long* words =
            reinterpret_cast<const unsigned long long*>(mk + slot * kMaskWords) + mp * (MPP / 64);
        unsigned long long bits[MPP / 64];
        bool any = false;
#pragma unroll
        for (int w = 0; w < MPP / 64; ++w) {
          bits[w] = words[w];
          passes += __popcll(bits[w]);
          any = any || bits[w] != 0;
        }
        if (!any) continue;
        float q[P];
#pragma unroll
        for (int v = 0; v < P / 4; ++v) {
          const float4 x = reinterpret_cast<const float4*>(qs + slot * P)[v];
          q[4 * v] = x.x;
          q[4 * v + 1] = x.y;
          q[4 * v + 2] = x.z;
          q[4 * v + 3] = x.w;
        }
        const int qc = __float_as_int(q[C]);
#pragma unroll
        for (int w = 0; w < MPP / 64; ++w) {
          while (bits[w]) {
            const int m = mp * MPP + 64 * w + __ffsll(static_cast<long long>(bits[w])) - 1;
            bits[w] &= bits[w] - 1;
            float r[P];
            int sc;
            if constexpr (K::kStage) {
#pragma unroll
              for (int v = 0; v < P / 4; ++v) {
                const float4 x = reinterpret_cast<const float4*>(staged + m * P)[v];
                r[4 * v] = x.x;
                r[4 * v + 1] = x.y;
                r[4 * v + 2] = x.z;
                r[4 * v + 3] = x.w;
              }
              sc = __float_as_int(r[C]);
            } else {
#pragma unroll
              for (int c = 0; c < C; ++c) r[c] = __ldg(tile_rec + m * C + c);
              sc = __ldg(tile_col + m);
            }
            float diff[D];
            float dist2 = 0.0f;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              diff[k] = q[k] - r[k];
              dist2 = dist2 + diff[k] * diff[k];
            }
            if (!((dist2 <= q[D + 1] * r[D + 1]) && (qc != sc))) continue;
            // the rare path: a candidate
            ++cnt[j];
            if (!(dist2 > 0.0f)) {
              ++zc[j];
              continue;
            }
            const float ws = p.additive ? q[D] + r[D] : q[D] * r[D];
            if (!(dist2 * (ws * ws) <= p.L2)) continue;
            const float dist = sqrtf(dist2);
            const float inv = 1.0f / dist;
            const float coeff = p.rep_scale * ws * inv;
#pragma unroll
            for (int k = 0; k < D; ++k) acc[j][k] = acc[j][k] + coeff * diff[k];
            const float l_over_ws = p.additive ? p.L / ws : (p.L * q[D + 2]) * r[D + 2];
            lsum[j] = lsum[j] + (l_over_ws - dist);
          }
        }
      }
    }

    if (i + 1 < item.w) {
      // ---- the prefilter of tile i + 1.  Warp w takes query rows
      // 32w ... 32w + 31 (two m16 groups) against the tile's 32 n8 member
      // groups; lane (g, t) sets the pass bits of rows 32w + 16h + g + 8r
      // (h, r in {0, 1}) against members 64t ... 64t + 63 and writes them as
      // two mask words a row.
      const float* fr = frag + ((i + 1) & 1) * K::kFrag;
      unsigned* mk = mask + ((i + 1) & 1) * K::kMask;
      const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        unsigned bits[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {  // four groups at a time: bits 8q ... 8q + 7
          unsigned chunk[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            unsigned sb[NKS][KK / 4], ss[NKS][KK / 4];
            load_group<D>(fr, 16 * half + 4 * q + k, lane, sb, ss);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int ks = 0; ks < NKS; ++ks) {
                mma_tf32<KK>(d, qa[h][ks], sb[ks]);
                mma_tf32<KK>(d, qb[h][ks], ss[ks]);
              }
#pragma unroll
              for (int ks = 0; ks < NKS; ++ks) mma_tf32<KK>(d, qb[h][ks], sb[ks]);
              // c0, c1: row g, members 64t + 2n, 64t + 2n + 1; c2, c3: row g + 8
              if (!(d[0] > 0.0f)) chunk[h][0] |= 1u << (2 * k);
              if (!(d[1] > 0.0f)) chunk[h][0] |= 2u << (2 * k);
              if (!(d[2] > 0.0f)) chunk[h][1] |= 1u << (2 * k);
              if (!(d[3] > 0.0f)) chunk[h][1] |= 2u << (2 * k);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bits[h][0] |= chunk[h][0] << (8 * q);
            bits[h][1] |= chunk[h][1] << (8 * q);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mk[(32 * warp + 16 * h + g + 8 * r) * kMaskWords + 2 * t + half] = bits[h][r];
          }
        }
      }
    }

    if constexpr (K::kStage) {
      cp_async_wait<1>();  // tile i + 2's copies (this thread's own member)
      if (i + 2 < item.w) {
        build_member<D>(raw + ((i + 2) & 3) * K::kRaw + tid * P, cen, frag + (i & 1) * K::kFrag, tid);
      }
    } else {
      if (i + 2 < item.w) build_member<D>(srow.r, cen, frag + (i & 1) * K::kFrag, tid);
      if (tile_next >= 0) load_member<D>(p, tile_next, tid, srow);
    }
    tile_ex = tile_pre;
    tile_pre = tile_build;
    tile_build = tile_next;
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
  if (g_count_passes) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) passes += __shfl_xor_sync(0xffffffffu, passes, off);
    if (lane == 0) atomicAdd(&g_passes, passes);
  }
}

// ---------------------------------------------------------------- reduction
//
// The sum across the TPU kernel's grid steps (its output block is zeroed at
// a query block's first step and added into at every later one): each query
// block's work items are added in item order, each float channel from +0.0
// (acc = 0, then acc = acc + x item by item, so -0.0 and NaN come out as a
// sequential fold gives them), the counts as integers; a block without items
// gets zeros.  The work-item table is block-major, so a block's items are
// one run [lo, end) of it, also in a contiguous slice of it (one rank's
// share).
//
// What bounds it: the bytes, each item's (d + 3, 256) partials read once
// (27.5 MB at converged girg100k d=2, 65.7 MB at d=4), over the memory
// rate; the fold itself is a few adds a word.  So the design keeps loads in
// flight rather than chains of them:
// - block_bounds finds [lo, end) in a few parallel rounds: every thread
//   probes one entry of the bracket, evenly spaced, and a block-wide count
//   of the probes below the key narrows it to one stride (two rounds up to
//   T (T + 1) items, T = the CTA's threads);
// - a thread takes four slots (16 bytes) of one channel, 64 threads a
//   channel and (d + 3) 64 threads a CTA, and issues kUnroll items' loads
//   at independent addresses before it folds them in item order;
// - the force rows go out through shared memory as contiguous 16-byte
//   stores, the loss and counts straight from their channel's threads.

// [lo, end) of query block `blk`'s items in `items` (n entries sorted by
// .x), as (lo, end).  Every thread of the CTA calls it and gets the same
// answer.  Each search keeps the unknown bracket [a, b) of its lower bound
// (the entries below a are known below the key, those from b on not): its
// T probes a, a + s, ... (s = ceil((b - a) / T)) are counted across the CTA,
// and the count c leaves [a + (c - 1) s + 1, a + c s).
__device__ __forceinline__ int2 block_bounds(const int4* items, int n, int blk) {
  const int* key = reinterpret_cast<const int*>(items);  // .x of entry i at key[4 i]
  const int t = threadIdx.x, T = blockDim.x;
  int a0 = 0, b0 = n;  // first entry >= blk
  int a1 = 0, b1 = n;  // first entry > blk
  while (a0 < b0 || a1 < b1) {
    const int s0 = (b0 - a0 + T - 1) / T, s1 = (b1 - a1 + T - 1) / T;
    const int p0 = a0 + t * s0, p1 = a1 + t * s1;
    const bool in0 = p0 < b0, in1 = p1 < b1;
    const int x0 = in0 ? __ldg(key + 4 * (size_t)p0) : 0;  // both loads in flight at once
    const int x1 = in1 ? __ldg(key + 4 * (size_t)p1) : 0;
    const int c0 = __syncthreads_count(in0 && x0 < blk);
    const int c1 = __syncthreads_count(in1 && x1 <= blk);
    if (a0 < b0) {
      b0 = min(b0, a0 + c0 * s0);
      a0 = c0 > 0 ? a0 + (c0 - 1) * s0 + 1 : a0;
    }
    if (a1 < b1) {
      b1 = min(b1, a1 + c1 * s1);
      a1 = c1 > 0 ? a1 + (c1 - 1) * s1 + 1 : a1;
    }
  }
  return make_int2(a0, a1);
}

// One CTA a query block, (D + 3) x kLanes threads: channel c = tid / kLanes
// (whole warps), slots 4 v ... 4 v + 3 with v = tid % kLanes.
template <int D>
__global__ void __launch_bounds__(kLanes * (D + 3)) span_reduce_kernel(Params p) {
  constexpr int C = D + 3;
  __shared__ __align__(16) float rows[kQ * D];  // the block's force rows, row-major
  const int blk = blockIdx.x;
  const int c = threadIdx.x / kLanes;
  const int v = threadIdx.x % kLanes;
  const int2 range = block_bounds(p.items, p.n_items, blk);
  const float4* src = reinterpret_cast<const float4*>(p.scratch) + c * kLanes + v;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int4 cnt = make_int4(0, 0, 0, 0);
  for (int it = range.x; it < range.y; it += kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (it + u < range.y) x[u] = __ldcs(src + (size_t)(it + u) * C * kLanes);
    }
    if (c <= D) {  // force and loss: f32, in item order
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (it + u < range.y) {
          acc.x = acc.x + x[u].x;
          acc.y = acc.y + x[u].y;
          acc.z = acc.z + x[u].z;
          acc.w = acc.w + x[u].w;
        }
      }
    } else {  // the counts: int32 bits
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (it + u < range.y) {
          cnt.x += __float_as_int(x[u].x);
          cnt.y += __float_as_int(x[u].y);
          cnt.z += __float_as_int(x[u].z);
          cnt.w += __float_as_int(x[u].w);
        }
      }
    }
  }
  const size_t s = (size_t)blk * kQ + 4 * v;
  if (c < D) {
    rows[(4 * v) * D + c] = acc.x;
    rows[(4 * v + 1) * D + c] = acc.y;
    rows[(4 * v + 2) * D + c] = acc.z;
    rows[(4 * v + 3) * D + c] = acc.w;
  } else if (c == D) {
    *reinterpret_cast<float4*>(p.loss + s) = acc;
  } else {
    *reinterpret_cast<int4*>((c == D + 1 ? p.count : p.zero) + s) = cnt;
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(p.force + (size_t)blk * kQ * D);
  for (int i = threadIdx.x; i < kQ * D / 4; i += blockDim.x) out[i] = reinterpret_cast<const float4*>(rows)[i];
}

template <int D>
cudaError_t launch_reduce(const Params& p, int nb, cudaStream_t stream) {
  span_reduce_kernel<D><<<nb, kLanes * (D + 3), 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int nb, int device, cudaStream_t stream) {
  if (p.n_items > 0) {
    // the item kernel's dynamic shared memory exceeds the default 48 KB at
    // d >= 3: opt in once a device
    static bool ready[kMaxDevices] = {};
    if (device < 0 || device >= kMaxDevices || !ready[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          span_sweep_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmemBytes);
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < kMaxDevices) ready[device] = true;
    }
    span_sweep_kernel<D><<<p.n_items, kThreads, Cfg<D>::kSmemBytes, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce<D>(p, nb, stream);
}

// ---------------------------------------------------------------- general

// The general kernel's shape (header): d in slabs of DS dimensions, the
// distance pass in sub-tiles of MB members a thread.
template <typename T>
struct GenCfg;
template <>
struct GenCfg<float> {
  static constexpr int DS = 16;
  static constexpr int MB = 32;
};
template <>
struct GenCfg<double> {
  static constexpr int DS = 8;
  static constexpr int MB = 16;
};

// Byte offsets of the general kernel's dynamic shared memory at dimension d:
// slab buffers of min(d, DS) rows, padded by 16 bytes against bank
// conflicts in cp.async's stores; one query buffer where d fits one slab.
template <typename T>
struct GenLayout {
  static constexpr int DS = GenCfg<T>::DS;
  static constexpr int MS = kST + 16 / sizeof(T);  // a member slab's row
  static constexpr int QS = kQ + 16 / sizeof(T);   // a query slab's row
  int kr;       // rows of a slab buffer
  size_t mem;   // 2 x [kr][MS] T
  size_t qry;   // 1 or 2 x [kr][QS] T
  size_t mx;    // 2 x [3][kST] T: invw, bm2, rawexp
  size_t mcol;  // 2 x [kST] int
  size_t acc;   // [d][kQ] T, when the sums are kept here
  size_t bytes;
  __host__ __device__ GenLayout(int d, bool smem_acc) {
    kr = d < DS ? d : DS;
    mem = 0;
    qry = mem + 2 * kr * MS * sizeof(T);
    mx = qry + (d > DS ? 2 : 1) * kr * QS * sizeof(T);
    mcol = mx + 2 * 3 * kST * sizeof(T);
    acc = mcol + 2 * kST * 4;
    bytes = acc + (smem_acc ? static_cast<size_t>(d) * kQ * sizeof(T) : 0);
  }
};

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
  int slabs;               // ceil(d / GenCfg<T>::DS)
  int smem_acc;            // the slots' force sums in shared memory, else in `scratch`
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

// acc + x of the general reduction's fold.  f32 arithmetic returns one
// canonical NaN; add.f64 returns an input NaN's payload, and of two NaN
// inputs the one its operand order prefers, which the compiler may swap
// between copies of an unrolled loop.  So in f64 the fold states its NaN:
// x's (quieted) where x is NaN, else acc's, as the plain version does.
__device__ __forceinline__ float fold_add(float acc, float x) { return acc + x; }
__device__ __forceinline__ double fold_add(double acc, double x) {
  constexpr long long kQuiet = 1ll << 51;
  if (isnan(x)) return __longlong_as_double(__double_as_longlong(x) | kQuiet);
  if (isnan(acc)) return __longlong_as_double(__double_as_longlong(acc) | kQuiet);
  return acc + x;
}

__device__ __forceinline__ void cp_async_t(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void cp_async_t(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// 4 floats or 2 doubles from 16-byte aligned shared memory.
__device__ __forceinline__ void load16(float (&v)[4], const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load16(double (&v)[2], const double* src) {
  const double2 x = *reinterpret_cast<const double2*>(src);
  v[0] = x.x;
  v[1] = x.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2) span_sweep_general_kernel(GeneralParams<T> p) {
  using Lay = GenLayout<T>;
  constexpr int DS = Lay::DS, MB = GenCfg<T>::MB, MS = Lay::MS, QS = Lay::QS;
  constexpr int V = 16 / sizeof(T);  // values a 16-byte load
  extern __shared__ __align__(16) float smem[];
  unsigned char* const raw = reinterpret_cast<unsigned char*>(smem);
  const Lay lay(p.d, p.smem_acc != 0);
  const int KR = lay.kr;
  T* const s_mem = reinterpret_cast<T*>(raw + lay.mem);
  T* const s_qry = reinterpret_cast<T*>(raw + lay.qry);
  T* const s_mx = reinterpret_cast<T*>(raw + lay.mx);
  int* const s_mcol = reinterpret_cast<int*>(raw + lay.mcol);
  T* const s_acc = reinterpret_cast<T*>(raw + lay.acc);

  const int4 item = p.items[blockIdx.x];
  const int tid = threadIdx.x;
  const int d = p.d;
  const int C = d + 3;
  const int slabs = p.slabs;
  const size_t qslot = static_cast<size_t>(item.x) * kQ + tid;
  const T* const q = p.qrec + qslot * C;
  const int qc = p.qcol[qslot];
  const T q_iw = q[d];
  const T q_lw2 = q[d + 1];
  const T q_raw = q[d + 2];
  T* const out = p.scratch + static_cast<size_t>(blockIdx.x) * C * kQ + tid;  // channel c at out[c * kQ]
  T* const acc = p.smem_acc ? s_acc + tid : out;                             // dimension k at acc[k * kQ]
  for (int k = 0; k < d; ++k) acc[k * kQ] = T(0);
  T lsum = T(0);
  int cnt = 0, zc = 0;

  // a step is slab sl of member group g of a tile: the whole tile where d
  // fits one slab, else MB members (one sub-tile)
  const int gm = slabs == 1 ? kST : MB;  // members a group
  const int per_tile = kST / gm * slabs;  // steps a tile
  const int steps = item.w * per_tile;
  auto stage = [&](int s, int tile) {
    const int g = s % per_tile / slabs, sl = s % slabs;
    const int k0 = sl * DS, kn = min(DS, d - k0);
    const size_t m0 = static_cast<size_t>(tile) * kST + g * gm;  // the group's first member
    // a thread a member (a query slot), every (kThreads / gm)-th dimension
    // of it: conflict-free stores, each record's values from one L1 line
    T* const ms = s_mem + (s & 1) * KR * MS;
    const int m = tid % gm;
    const T* const msrc = p.srec + (m0 + m) * C;
    for (int k = tid / gm; k < kn; k += kThreads / gm) cp_async_t(ms + k * MS + m, msrc + k0 + k);
    if (sl == slabs - 1 && tid < gm) {  // what the masks and the fold read beside the positions
      T* const mx = s_mx + (s & 1) * 3 * kST;
      for (int c = 0; c < 3; ++c) cp_async_t(mx + c * kST + m, msrc + d + c);
      cp_async4(reinterpret_cast<float*>(s_mcol + (s & 1) * kST + m), p.scol + m0 + m);
    }
    if (slabs > 1 || s == 0) {  // the block's queries: a single slab once, into buffer 0
      T* const qs = s_qry + (s & 1) * KR * QS;
      const T* const qsrc = p.qrec + (static_cast<size_t>(item.x) * kQ + tid) * C + k0;
      for (int k = 0; k < kn; ++k) cp_async_t(qs + k * QS + tid, qsrc + k);
    }
    cp_async_commit();
  };

  Walk walk{item.x, item.y, item.z, 0, 0};
  int staged_tile = 0;
  if (steps > 0) {
    walk.load_row(p);
    staged_tile = walk.tile();
    stage(0, staged_tile);
  }
  T dist2[MB];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s is in place; every thread is done with step s - 1
    const int tile = staged_tile;
    if (s + 1 < steps) {
      if ((s + 1) % per_tile == 0) {
        walk.next(p);
        staged_tile = walk.tile();
      }
      stage(s + 1, staged_tile);
    }
    const int g = s % per_tile / slabs, sl = s % slabs;
    const int kn = min(DS, d - sl * DS);
    const T* const ms = s_mem + (s & 1) * KR * MS;
    const T* const qs = s_qry + (slabs > 1 ? (s & 1) : 0) * KR * QS;
    const T* const mx = s_mx + (s & 1) * 3 * kST;
    const int* const mcol = s_mcol + (s & 1) * kST;
    for (int u = 0; u < gm / MB; ++u) {  // sub-tiles of MB members
      if (sl == 0) {
#pragma unroll
        for (int j = 0; j < MB; ++j) dist2[j] = T(0);
      }
      // dist2 over the slab's dimensions, in ascending k after the earlier slabs'
#pragma unroll 2
      for (int k = 0; k < kn; ++k) {
        const T qv = qs[k * QS + tid];
        const T* const mrow = ms + k * MS + u * MB;
#pragma unroll
        for (int jb = 0; jb < MB; jb += V) {
          T mv[V];
          load16(mv, mrow + jb);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T diff = qv - mv[v];
            dist2[jb + v] = dist2[jb + v] + diff * diff;
          }
        }
      }
      if (sl < slabs - 1) continue;

      // the candidates of the sub-tile: the radius test and the colours
      unsigned bits = 0u;
#pragma unroll
      for (int jb = 0; jb < MB; jb += 4) {
        const int4 c4 = *reinterpret_cast<const int4*>(mcol + u * MB + jb);
        const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const T bm2 = mx[kST + u * MB + jb + v];
          const bool valid = (dist2[jb + v] <= q_lw2 * bm2) && (qc != cs[v]);
          bits |= static_cast<unsigned>(valid) << (jb + v);
        }
      }
      // the slot's fold: its candidates in member order
      while (bits != 0u) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1u;
        T d2 = T(0);
#pragma unroll
        for (int jj = 0; jj < MB; ++jj) {
          if (jj == j) d2 = dist2[jj];
        }
        ++cnt;
        if (!(d2 > T(0))) {
          ++zc;
          continue;
        }
        const int m = u * MB + j;  // within the step's members
        const T ws = p.additive ? q_iw + mx[m] : q_iw * mx[m];
        if (!(d2 * (ws * ws) <= p.L2)) continue;
        const T dist = ieee_sqrt(d2);
        const T inv = T(1) / dist;
        const T coeff = p.rep_scale * ws * inv;
        if (slabs == 1) {  // both records are staged whole
          for (int k = 0; k < d; ++k) acc[k * kQ] = acc[k * kQ] + coeff * (qs[k * QS + tid] - ms[k * MS + m]);
        } else {
          const T* const sg = p.srec + (static_cast<size_t>(tile) * kST + g * gm + m) * C;
          for (int k = 0; k < d; ++k) acc[k * kQ] = acc[k * kQ] + coeff * (q[k] - sg[k]);
        }
        const T l_over_ws = p.additive ? p.L / ws : (p.L * q_raw) * mx[2 * kST + m];
        lsum = lsum + (l_over_ws - dist);
      }
    }
  }
  if (p.smem_acc) {
    for (int k = 0; k < d; ++k) out[k * kQ] = acc[k * kQ];
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
  const int2 range = block_bounds(p.items, p.n_items, blk);
  const int lo = range.x, end = range.y;
  const size_t s = (size_t)blk * kQ + slot;
  for (int c = 0; c <= d; ++c) {
    T acc = T(0);
    for (int it = lo; it < end; ++it) acc = fold_add(acc, p.scratch[((size_t)it * C + c) * kQ + slot]);
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
cudaError_t launch_reduce_general(const GeneralParams<T>& p, int nb, cudaStream_t stream) {
  span_reduce_general_kernel<T><<<nb, kQ, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_general(GeneralParams<T> p, int nb, int device, cudaStream_t stream) {
  if (p.n_items > 0) {
    // the force sums in shared memory where they fit, else in the scratch
    static int optin[kMaxDevices] = {};
    static size_t opted[kMaxDevices] = {};
    int limit = 0;
    if (device >= 0 && device < kMaxDevices && optin[device] > 0) {
      limit = optin[device];
    } else {
      const cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < kMaxDevices) optin[device] = limit;
    }
    p.smem_acc = GenLayout<T>(p.d, true).bytes <= static_cast<size_t>(limit) ? 1 : 0;
    const size_t bytes = GenLayout<T>(p.d, p.smem_acc != 0).bytes;
    if (device < 0 || device >= kMaxDevices || opted[device] < bytes) {
      const cudaError_t err = cudaFuncSetAttribute(
          span_sweep_general_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < kMaxDevices) opted[device] = bytes;
    }
    span_sweep_general_kernel<T><<<p.n_items, kThreads, bytes, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_reduce_general<T>(p, nb, stream);
}

template <typename T>
cudaError_t reduce_general(const int* items, int n_items, int nb, int dim, const void* scratch, void* force,
                           void* loss, int* count, int* zero, cudaStream_t stream) {
  GeneralParams<T> p = {};
  p.items = reinterpret_cast<const int4*>(items);
  p.n_items = n_items;
  p.d = dim;
  p.scratch = static_cast<T*>(const_cast<void*>(scratch));
  p.force = static_cast<T*>(force);
  p.loss = static_cast<T*>(loss);
  p.count = count;
  p.zero = zero;
  return launch_reduce_general<T>(p, nb, stream);
}

template <typename T>
cudaError_t general(const void* qrec, const int* qcol, const void* srec, const int* scol,
                    const int* blk_t, const int* start_tile, const int* tile_off,
                    const int* items, int n_items, int nb, int R, int dim, double L,
                    double rep_scale, int additive, void* scratch, void* force, void* loss,
                    int* count, int* zero, int device, cudaStream_t stream) {
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
  p.slabs = (dim + GenCfg<T>::DS - 1) / GenCfg<T>::DS;
  p.smem_acc = 0;
  p.L = static_cast<T>(L);
  p.L2 = static_cast<T>(L * L);
  p.rep_scale = static_cast<T>(rep_scale);
  p.additive = additive;
  p.scratch = static_cast<T*>(scratch);
  p.force = static_cast<T*>(force);
  p.loss = static_cast<T*>(loss);
  p.count = count;
  p.zero = zero;
  return launch_general<T>(p, nb, device, stream);
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
    case 1: err = launch<1>(p, nb, device, s); break;
    case 2: err = launch<2>(p, nb, device, s); break;
    case 3: err = launch<3>(p, nb, device, s); break;
    case 4: err = launch<4>(p, nb, device, s); break;
    case 5: err = launch<5>(p, nb, device, s); break;
    case 6: err = launch<6>(p, nb, device, s); break;
    case 7: err = launch<7>(p, nb, device, s); break;
    case 8: err = launch<8>(p, nb, device, s); break;
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
                          nb, R, dim, L, rep_scale, additive, scratch, force, loss, count, zero,
                          device, s);
  } else {
    err = general<float>(qrec, qcol, srec, scol, blk_t, start_tile, tile_off, items, n_items,
                         nb, R, dim, L, rep_scale, additive, scratch, force, loss, count, zero,
                         device, s);
  }
  return static_cast<int>(err);
}

// Enqueues the reduction alone on `stream`: each of the nb query blocks'
// items of `items` (n_items entries, block-major) added in item order from
// `scratch`, (n_items, dim + 3, 256) values in the layout the sweep writes
// (the counts as int32 bits in the fast layout, f32 at dim <= 8; as values
// in the general one, f64 or a larger dim), into force (nb * 256, dim),
// loss, count and zero.  The kernel the sweep would launch after its items:
// span_reduce_kernel<dim>, or span_reduce_general_kernel<T>.
int wembed_span_reduce(const void* scratch, const int* items, int n_items, int nb, int dim, int f64,
                       void* force, void* loss, int* count, int* zero, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || n_items < 0 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    err = reduce_general<double>(items, n_items, nb, dim, scratch, force, loss, count, zero, s);
  } else if (dim > kMaxDim) {
    err = reduce_general<float>(items, n_items, nb, dim, scratch, force, loss, count, zero, s);
  } else {
    Params p = {};
    p.items = reinterpret_cast<const int4*>(items);
    p.n_items = n_items;
    p.scratch = static_cast<float*>(const_cast<void*>(scratch));
    p.force = static_cast<float*>(force);
    p.loss = static_cast<float*>(loss);
    p.count = count;
    p.zero = zero;
    switch (dim) {
      case 1: err = launch_reduce<1>(p, nb, s); break;
      case 2: err = launch_reduce<2>(p, nb, s); break;
      case 3: err = launch_reduce<3>(p, nb, s); break;
      case 4: err = launch_reduce<4>(p, nb, s); break;
      case 5: err = launch_reduce<5>(p, nb, s); break;
      case 6: err = launch_reduce<6>(p, nb, s); break;
      case 7: err = launch_reduce<7>(p, nb, s); break;
      case 8: err = launch_reduce<8>(p, nb, s); break;
    }
  }
  return static_cast<int>(err);
}

// Starts (enable != 0) or stops counting the pairs that the fast kernel's
// prefilter passes on `device`, and zeroes the count.  Synchronous.
int wembed_span_sweep_count_passes(int enable, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int flag = enable ? 1 : 0;
  const unsigned long long zero = 0;
  err = cudaMemcpyToSymbol(g_count_passes, &flag, sizeof flag);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(g_passes, &zero, sizeof zero));
}

// The pairs passed since the count was last started on `device`, into *out.
// Synchronous.
int wembed_span_sweep_passes(unsigned long long* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_passes, sizeof *out));
}

}  // extern "C"
