// Streaming Möbius-distance cross-entropy, forward and backward.
//
// For queries q [B, d] against every candidate x [N, d]:
//
//   p   = q_i . x_j,  qq = |q_i|^2,  xx = |x_j|^2,  c = cq_i
//   A   = 1 - 2 c p + c xx,   Bc = 1 - c qq,   D = 1 - 2 c p + c^2 qq xx + eps
//   diff_sq = max(A^2 qq - 2 A Bc p + Bc^2 xx, 0) / D^2   (|(-q) (+)_c x|^2)
//   dist    = min(diff_sq, (1/sqrt(c) - 2 eps)^2)                       (proxy)
//           | 2/(sqrt(c+eps)+eps) * artanh(min(sqrt(c+eps) dn, 1 - eps)),
//             dn = min(sqrt(max(diff_sq, eps^2)), 1/(sqrt(c+eps)+eps) - eps)  (true)
//   logit_ij = scale * (margin - dist) + bias_j
//   nll_i    = logsumexp_j logit_ij - logit_{i, target_i}
//
// and its gradient with respect to q, x, bias, cq (per query), scale and
// margin, given the upstream gradient g [B] of nll. Neither direction ever
// stores the [B, N] logits: each tile is computed, folded and dropped.
//
// Replaces the Pallas TPU kernel regcn_tpu/ops/pallas_scoring.py:_ce_kernel
// (driven by _streaming_ce_parts) and the tile-recompute backward of its
// custom VJP (_streaming_nll_bwd, a lax.scan over candidate tiles). On the TPU
// the grid walked the candidate tiles in order and carried the running
// (max, sum-exp, target) accumulator from one grid step to the next. Here
// blocks run in parallel and share nothing, so the work is cut three ways:
//
//   ce_forward_kernel   per tile of 128 queries, `splits` blocks cut
//                       the candidate tiles. Each walks its 16-row tiles and
//                       folds each query's logits into a running (max,
//                       sum-exp, target logit); the last block of a query tile
//                       to finish (a counter, atomically incremented) combines
//                       the splits in split order into nll and lse.
//   ce_backward_q_kernel  one thread-block cluster per 64 queries; its
//                       blocks split the candidate tiles. Each recomputes the
//                       logits of its 32-row candidate tiles and dlogit =
//                       g (softmax - onehot), then dq = sum_j dp x_j +
//                       2 q sum_j dqq, dc and the terms of dscale / dmargin;
//                       the cluster sums its blocks' partials in rank order
//                       through distributed shared memory and writes dq and
//                       dc once; the last cluster to finish (a counter) sums
//                       the clusters' dscale / dmargin terms in order.
//   ce_backward_x_kernel  one thread-block cluster per 64 candidates; its
//                       blocks split the query tiles. Each walks its 32-row
//                       query tiles: dx = sum_i dp q_i + 2 x sum_i dxx,
//                       dbias = sum_i dlogit; the cluster sums its blocks'
//                       partials in rank order through distributed shared
//                       memory and writes dx once.
//
// Every sum is taken in a fixed order: the forward's and backward_q's
// counters only decide which block does the combining, and the clusters'
// ranks are fixed, so results are the same from run to run. Candidates
// >= N and queries >= B are masked in the kernel (no -1e30 padding): they add
// exactly 0 to every sum and get no gradient. The clamps (max(num_sq, 0), the
// max_norm minimum, max(diff_sq, eps^2), min(z, 1 - eps)) pass no gradient
// where they bind, as JAX's VJP does away from ties.
//
// What bounds it on an H100: operations. At the hyperbolic config-3 entity
// loss (B = 512 padded queries, N = 7128 entities, d = 200) the forward is
// 2 B N d = 1.46 GFLOP of q.x products plus ~30 flops per logit, ~23 us at
// the 67 TFLOP/s fp32 rate, while its inputs are 6.1 MB (1.8 us of HBM). Each
// backward kernel recomputes p and does one more product of the same size
// plus ~90 flops per pair: 48.48 us. All products are fp32 FMAs (no TF32: the
// port is held to fp32 parity).
//
// backward_x: its first design (one block per candidate tile walking every
// query tile, 130 KB of shared memory, so one block of 8 warps per SM) used
// 112 of 132 SMs at the entity shape and 64 at the relation shape, loaded
// each query tile synchronously between barriers with nothing to overlap it,
// recomputed the per-query constants for every pair, idled 14 of 64 lanes
// in its dX product at d = 200, and merged its splits through device memory
// even when there was one. Now:
// - work: clusters of up to 8 blocks split the query axis (the wrapper picks
//   the size whose busiest SM walks the fewest query tiles, from the
//   occupancy), and the cluster merges on chip; with one split the merge is a
//   copy out of shared memory;
// - overlap: query tiles of 32 rows and their cq / target / lse / g are
//   double-buffered with cp.async, so tile t + 1 arrives while tile t is
//   computed; |q|^2 and the per-query constants of the distance are computed
//   once per row;
// - products: a warp-wide 128-bit shared-memory load is paid per quarter-warp
//   (8 lanes reading 8 distinct float4s cost as much as 32 lanes reading 32;
//   one float4 for the whole warp costs far less), so a 2 x 4 register tile
//   of float4 loads was bound by shared memory. Instead each thread keeps its
//   candidates (lane and lane + 32) at its warp's float4 columns (warp + 8 m,
//   m < ceil(d / 32), a template argument so the loops unroll) in registers
//   for the whole walk, and both products read only query rows, one float4
//   for the whole warp at a time, 8 rows per step: p as per-warp partial dot
//   products summed over the 8 warps in order through shared memory, dX into
//   registers of the same shape;
// - the elementwise chain has no branches (masked pairs give finite values
//   that are dropped), so a thread's 8 pairs interleave; the proxy, whose
//   clamp caps the distance, uses the fast division and exponential;
// - |x|^2 is summed in the forward's and backward_q's order, not from the
//   registers' column slices: p, |q|^2 and |x|^2 are then the same floats in
//   all three kernels, and so is each logit. Next to a candidate (a query
//   within ~1e-4 of it, as training drives a query towards its target) the
//   true distance's expansion cancels terms of ~|x|^2 down to rounding
//   noise, and a |x|^2 one ulp apart moved that pair's softmax weight away
//   from the forward's lse: on an H100, dx of such a target missed float64
//   by 1.4e-4 of 1.2, five times the plain version's miss.
//
// backward_q is the same design with q and x swapped; its v2 (one 64 x 64
// tile pair at a time from shared memory, like the forward's v2) had the same
// four faults. What differs: at B = 512 there are only 8 query tiles of 64,
// so the candidate axis carries the parallelism: per query tile, `splits`
// clusters of C blocks (C up to 16, above 8 a non-portable size) cut it, 32
// candidates per tile; a cluster merges on chip and the clusters of a query
// tile through L2. The wrapper picks C and splits from
// cudaOccupancyMaxActiveClusters: the fewest candidate tiles on the busiest
// SM, then the fewest splits. Each chain thread works on one query for the
// whole walk, so its per-query constants and its sums of dqq, dc,
// dlogit * block and dlogit stay in registers; dq's 2 q sum dqq term is added
// once, in the merge. The softmax weight keeps expf on both distances (see
// bwdq::pair_grad).
//
// The forward is backward_q's walk without the dQ product. Its v2 (64 x 64
// tiles of both operands in shared memory, a 4 x 4 register tile of logits
// per thread) had the same faults: bound by shared-memory loads, tiles loaded
// synchronously between three barriers, per-query constants recomputed per
// pair, and a p summed in another order than the backward kernels', so its
// lse belonged to logits a few ulp away from those they recompute. Now each
// lane keeps 4 queries (128 per block; one broadcast float4 of a candidate
// row feeds 16 FMAs) in registers, candidate tiles of
// 16 rows are double-buffered with cp.async, p, |q|^2 and |x|^2 are taken in
// backward_q's order and each logit by bwdq::pair_logit, so the forward's
// logits are backward_q's bit for bit. Each chain thread keeps a running
// (max, sum-exp, target) for its query, rescaled once per tile; the chain of
// one tile and the product of the next share a barrier interval (the p
// partials are double-buffered); the splits of a query tile (the wrapper
// sizes them from the occupancy to fill the SMs in one wave) merge three
// floats per query through L2.
// d <= 512, a multiple of 4, and q and x 16-byte aligned (every load is a
// float4; the wrapper zero-pads other widths to a multiple of 4, which adds
// nothing to q.x, |q|^2 or |x|^2).
//
// Widths 256 < d <= 512 take the same code with register tiles of 12 or 16
// float4 columns per warp (d <= 384, d <= 512), so they spill (PERF.md has
// ptxas's counts),
// and their forward cannot stage its 128-query tile through shared memory
// (2 KB a row at d = 512): it loads each lane's queries and |q|^2 straight from
// device memory instead, the same values in the same order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxD4 = 128;          // d <= 512
// instances up to kExactCol4 float4 columns per warp (d <= 256) have exactly
// ceil(d / 32) of them; the wide ones are built at 12 and 16 columns only (to
// keep the build short) and stop at each warp's last column at run time
constexpr int kExactCol4 = 8;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Shape {
  int d4, ld4;  // float4s per row, float4 row stride in shared memory (odd)
};

__host__ __device__ __forceinline__ Shape make_shape(int d) {
  const int d4 = d / 4;
  return Shape{d4, d4 | 1};
}

// (m, s) <- (m, s) (+) (m2, s2) for running (max, sum of exp(. - max)).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == neg_inf()) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Marks this block done for `counter`; true in the block that finishes last.
// Every thread's global writes are fenced before the count.
__device__ __forceinline__ bool last_to_finish(int* counter, int expected, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

struct Scalars {
  const float* scale;
  const float* margin;
};

// ----------------------------------------------------- backward: candidates
//
// One cluster per tile of kCands candidates; its blocks (ranks) split the
// query tiles. Each block keeps the candidate tile in registers and walks
// its query tiles of kRows rows, double-buffered with cp.async. At the end
// every block leaves its dx / dxx / dbias partial in its own shared memory,
// and after a cluster barrier the ranks sum them in rank order through
// distributed shared memory, each writing its share of dx once.

namespace bwdx {

constexpr int kCands = 64;     // candidates per cluster tile: lane l holds l and l + 32
constexpr int kRows = 32;      // queries per tile of a block's walk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kRowStep = 8;    // query rows per step of both products
// per-row values of the current query tile: |q|^2, c, lse, g, 1 - c|q|^2 and
// three constants of the distance (true: sqrt(c + eps), 2 / (sqrt(c + eps) +
// eps), the max-norm clamp; proxy: the squared clamp)
enum { kQQ, kC, kL, kG, kBc, kK0, kK1, kK2, kFields };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [row0, row0 + rows) of a row-major [nrows, d] matrix into shared memory
// (row stride sh.ld4), zero-filled past nrows; asynchronous.
__device__ __forceinline__ void load_tile_async(float4* s, const float* g, int row0, int rows,
                                                int nrows, Shape sh) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < rows * sh.d4; i += kThreads) {
    const int r = i / sh.d4, k = i - r * sh.d4;
    const bool ok = row0 + r < nrows;
    cp_async16(s + r * sh.ld4 + k, g4 + (ok ? static_cast<size_t>(row0 + r) * sh.d4 + k : 0), ok);
  }
}

// cq, target, lse and g of the query tile at row0 into raw[4][kRows]; asynchronous.
__device__ __forceinline__ void load_rows_async(float* raw, const float* cq, const int* target,
                                                const float* lse, const float* g, int row0,
                                                int B) {
  if (threadIdx.x < 4 * kRows) {
    const int f = threadIdx.x / kRows, r = threadIdx.x % kRows, row = row0 + r;
    const bool ok = row < B;
    const int at = ok ? row : 0;
    const void* src = f == 0 ? static_cast<const void*>(cq + at)
                      : f == 1 ? static_cast<const void*>(target + at)
                      : f == 2 ? static_cast<const void*>(lse + at)
                               : static_cast<const void*>(g + at);
    cp_async4(raw + f * kRows + r, src, ok);
  }
}

// |row|^2 of one shared row, summed over a warp (lane-strided, then a butterfly).
__device__ __forceinline__ float warp_row_sq(const float4* row, Shape sh, int lane) {
  const float* sf = reinterpret_cast<const float*>(row);
  float acc = 0.f;
  for (int k = lane; k < 4 * sh.d4; k += 32) acc = fmaf(sf[k], sf[k], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// The per-row values of a query tile, hoisted out of the per-pair chain;
// warp w sums |q|^2 of rows 4w .. 4w + 3, then lanes 0 .. 3 fill one row
// each. Rows past B get c = 1 (they are masked).
template <bool kTrue>
__device__ __forceinline__ void row_constants(const float4* Qb, const float* raw, int row0, int B,
                                              Shape sh, float (*rowc)[kRows], int* tgt) {
  constexpr int kPerWarp = kRows / kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float qq_r[kPerWarp];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr)
    qq_r[rr] = warp_row_sq(Qb + (warp * kPerWarp + rr) * sh.ld4, sh, lane);
  if (lane >= kPerWarp) return;
  float qq = qq_r[0];
#pragma unroll
  for (int rr = 1; rr < kPerWarp; ++rr)
    if (lane == rr) qq = qq_r[rr];
  const int r = warp * kPerWarp + lane;
  const bool ok = row0 + r < B;
  const float c = ok ? raw[r] : 1.f;
  rowc[kQQ][r] = qq;
  rowc[kC][r] = c;
  rowc[kL][r] = ok ? raw[2 * kRows + r] : 0.f;
  rowc[kG][r] = ok ? raw[3 * kRows + r] : 0.f;
  rowc[kBc][r] = 1.f - c * qq;
  tgt[r] = ok ? __float_as_int(raw[kRows + r]) : -1;
  if (kTrue) {
    const float sqrt_c = sqrtf(c + kEps);
    rowc[kK0][r] = sqrt_c;
    rowc[kK1][r] = 2.f / (sqrt_c + kEps);
    rowc[kK2][r] = 1.f / (sqrt_c + kEps) - kEps;
  } else {
    const float mx = 1.f / sqrtf(c) - 2.f * kEps;
    rowc[kK0][r] = mx * mx;
  }
}

// For one pair: dlogit, and the chain rule from it back to p and |x|^2 (the
// kernel needs no gradient of |q|^2 or c). The same expressions as
// bwdq::pair_logit and bwdq::pair_grad, with the per-row values precomputed.
template <bool kTrue>
__device__ __forceinline__ void pair_grad(float p, float xx, float b, bool is_target,
                                          float (*rowc)[kRows], int r, float scale,
                                          float margin, float& dlogit, float& gp, float& gxx) {
  const float qq = rowc[kQQ][r], c = rowc[kC][r], Bc = rowc[kBc][r];
  const float A = 1.f - 2.f * c * p + c * xx;
  const float D = 1.f - 2.f * c * p + (c * c) * qq * xx + kEps;
  const float num_sq = A * A * qq - 2.f * A * Bc * p + Bc * Bc * xx;
  // the proxy needs no IEEE division or expf: its clamp caps the distance,
  // while the true distance's artanh amplifies the rounding of diff_sq near
  // the edge
  const float diff_sq =
      kTrue ? fmaxf(num_sq, 0.f) / (D * D) : __fdividef(fmaxf(num_sq, 0.f), D * D);
  float dist, sqrt_c = 0.f, two_s1 = 0.f, mn = 0.f, dn0 = 0.f, dn = 0.f, z = 0.f;
  if (kTrue) {
    sqrt_c = rowc[kK0][r];
    two_s1 = rowc[kK1][r];
    mn = rowc[kK2][r];
    dn0 = sqrtf(fmaxf(diff_sq, kEps * kEps));
    dn = fminf(dn0, mn);
    z = fminf(sqrt_c * dn, 1.f - kEps);
    dist = two_s1 * atanhf(z);
  } else {
    dist = fminf(diff_sq, rowc[kK0][r]);
  }
  const float logit = scale * (margin - dist) + b;
  const float e = kTrue ? expf(logit - rowc[kL][r]) : __expf(logit - rowc[kL][r]);
  dlogit = rowc[kG][r] * (e - (is_target ? 1.f : 0.f));
  const float ddist = -scale * dlogit;
  float ddiff = 0.f;
  if (kTrue) {
    const float dz = (sqrt_c * dn < 1.f - kEps) ? ddist * two_s1 / (1.f - z * z) : 0.f;
    const float ddn0 = dn0 < mn ? dz * sqrt_c : 0.f;
    if (diff_sq > kEps * kEps) ddiff = ddn0 * 0.5f / dn0;
  } else if (diff_sq < rowc[kK0][r]) {
    ddiff = ddist;
  }
  const float inv_d = kTrue ? 1.f / D : __fdividef(1.f, D);
  const float inv_d2 = inv_d * inv_d;
  const float dnum = num_sq > 0.f ? ddiff * inv_d2 : 0.f;
  const float dD = -2.f * ddiff * fmaxf(num_sq, 0.f) * inv_d2 * inv_d;
  const float dA = dnum * (2.f * A * qq - 2.f * Bc * p);
  gp = -2.f * A * Bc * dnum - 2.f * c * dA - 2.f * c * dD;
  gxx = Bc * Bc * dnum + c * dA + c * c * qq * dD;
}

size_t smem_bytes(int d) {
  return 2 * static_cast<size_t>(kRows) * make_shape(d).ld4 * sizeof(float4) +
         static_cast<size_t>(kWarps + 1) * kRows * kCands * sizeof(float);
}

}  // namespace bwdx

// kCol4 = ceil(d / 32) float4 columns per warp: the loops over them are
// unrolled and only the last column, which some warps lack, is behind a
// (warp-uniform) branch, so the other columns' loads can be issued ahead.
template <bool kTrue, int kCol4>
__global__ void __launch_bounds__(bwdx::kThreads, 1)
    ce_backward_x_kernel(const float* __restrict__ q, const float* __restrict__ x,
                         const float* __restrict__ bias, const float* __restrict__ cq,
                         const int* __restrict__ target, Scalars sc,
                         const float* __restrict__ lse, const float* __restrict__ g,
                         float* __restrict__ dx, float* __restrict__ dbias, int B, int N, int d) {
  using namespace bwdx;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  unsigned cluster_size;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(cluster_size));
  const int splits = static_cast<int>(cluster_size);
  extern __shared__ float4 smem[];
  __shared__ float raw[2][4 * kRows];
  __shared__ float rowc[kFields][kRows];
  __shared__ int tgt_s[kRows];
  __shared__ float xx_s[kCands], csum[2][kCands];
  const Shape sh = make_shape(d);
  float4* Qs = smem;  // two buffers of kRows rows
  float* red = reinterpret_cast<float*>(Qs + 2 * kRows * sh.ld4);  // [kWarps][kRows][kCands]
  float* Gs = red + kWarps * kRows * kCands;                        // [kRows][kCands]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = static_cast<int>(blockIdx.x) / splits * kCands;
  const float scale = __ldg(sc.scale), margin = __ldg(sc.margin);

  // this rank's query tiles; the first is in flight while the candidates load
  const int q_tiles = (B + kRows - 1) / kRows;
  const int per = (q_tiles + splits - 1) / splits;
  const int t_begin = min(rank * per, q_tiles), t_end = min(t_begin + per, q_tiles);
  if (t_begin < t_end) {
    load_tile_async(Qs, q, t_begin * kRows, kRows, B, sh);
    load_rows_async(raw[0], cq, target, lse, g, t_begin * kRows, B);
  }
  cp_async_commit();

  // candidates lane and lane + 32, float4 columns warp + 8 m: in registers
  // for the whole walk (both products read only the query rows from shared
  // memory, every lane of a warp the same float4)
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const bool last = warp + kWarps * (kCol4 - 1) < sh.d4;  // this warp has column kCol4 - 1
  const int ncols = (sh.d4 - warp + kWarps - 1) / kWarps;  // this warp's columns (wide instances)
  float4 xr[2][kCol4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int cand = col0 + lane + 32 * c;
#pragma unroll
    for (int m = 0; m < kCol4; ++m) {
      const int k = warp + kWarps * m;
      xr[c][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cand < N && k < sh.d4) xr[c][m] = __ldg(x4 + static_cast<size_t>(cand) * sh.d4 + k);
    }
  }
  // |x|^2 of the tile's candidates in the forward's and backward_q's order
  // (warp_row_sq: lane-strided, then a butterfly; warp w takes candidates
  // 8w .. 8w + 7), so that the three kernels take each pair's logit from the
  // same p, |q|^2 and |x|^2. Next to a candidate the distance's expansion
  // cancels terms of ~|x|^2 down to rounding noise, and a |x|^2 one ulp
  // apart moves that pair's logit, and its softmax weight, away from the
  // logits the forward took lse over.
#pragma unroll
  for (int i = 0; i < kCands / kWarps; ++i) {
    const int e = warp * (kCands / kWarps) + i;
    const float* row = x + static_cast<size_t>(col0 + e) * d;
    float v[kCol4];  // every load issued before the first add; d <= 32 kCol4
#pragma unroll
    for (int j = 0; j < kCol4; ++j) {
      const int k = lane + 32 * j;
      v[j] = col0 + e < N && k < d ? __ldg(row + k) : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kCol4; ++j) acc = fmaf(v[j], v[j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) red[e] = acc;
  }
  __syncthreads();
  // the elementwise chain: candidate ec, rows er + 4 i
  const int ec = tid % kCands, er = tid / kCands;
  const float xx = red[ec];
  const bool col_ok = col0 + ec < N;
  const float bv = col_ok ? __ldg(bias + col0 + ec) : 0.f;
  float sum_xx = 0.f, sum_g = 0.f;
  float4 acc[2][kCol4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int m = 0; m < kCol4; ++m) acc[c][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1, row0 = t * kRows;
    const float4* Qb = Qs + buf * kRows * sh.ld4;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1 (and red, Gs) no longer read
    if (t + 1 < t_end) {
      load_tile_async(Qs + (buf ^ 1) * kRows * sh.ld4, q, row0 + kRows, kRows, B, sh);
      load_rows_async(raw[buf ^ 1], cq, target, lse, g, row0 + kRows, B);
    }
    cp_async_commit();
    row_constants<kTrue>(Qb, raw[buf], row0, B, sh, rowc, tgt_s);
    // this warp's share of p over its columns, kRowStep rows at a time
    for (int r0 = 0; r0 < kRows; r0 += kRowStep) {
      float pp[kRowStep][2];
#pragma unroll
      for (int s = 0; s < kRowStep; ++s) pp[s][0] = pp[s][1] = 0.f;
#pragma unroll
      for (int m = 0; m < kCol4; ++m) {
        if (kCol4 > kExactCol4 ? m >= ncols : m == kCol4 - 1 && !last) break;
#pragma unroll
        for (int s = 0; s < kRowStep; ++s) {
          const float4 qv = Qb[(r0 + s) * sh.ld4 + warp + kWarps * m];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = pp[s][c];
            v = fmaf(qv.x, xr[c][m].x, v);
            v = fmaf(qv.y, xr[c][m].y, v);
            v = fmaf(qv.z, xr[c][m].z, v);
            v = fmaf(qv.w, xr[c][m].w, v);
            pp[s][c] = v;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kRowStep; ++s) {
        red[(warp * kRows + r0 + s) * kCands + lane] = pp[s][0];
        red[(warp * kRows + r0 + s) * kCands + lane + 32] = pp[s][1];
      }
    }
    __syncthreads();  // red, rowc
    // without branches, so the eight chains interleave: rows past B (c = 1,
    // q = 0, g = 0) and candidates past N (x = 0) give finite values, dropped
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = er + 4 * i;
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) p += red[(w * kRows + r) * kCands + ec];
      float dlogit, gp, gxx;
      pair_grad<kTrue>(p, xx, bv, col0 + ec == tgt_s[r], rowc, r, scale, margin, dlogit, gp,
                       gxx);
      const bool ok = col_ok && row0 + r < B;
      sum_xx += ok ? gxx : 0.f;
      sum_g += ok ? dlogit : 0.f;
      Gs[r * kCands + ec] = ok ? gp : 0.f;
    }
    __syncthreads();  // Gs
    // acc[candidate lane + 32 c][warp + 8 m] += sum_r dp[r][candidate] * q[r][warp + 8 m],
    // kRowStep rows at a time so that each column's loads go out together
    for (int r0 = 0; r0 < kRows; r0 += kRowStep) {
      float ga[kRowStep], gb[kRowStep];
#pragma unroll
      for (int s = 0; s < kRowStep; ++s) {
        ga[s] = Gs[(r0 + s) * kCands + lane];
        gb[s] = Gs[(r0 + s) * kCands + lane + 32];
      }
#pragma unroll
      for (int m = 0; m < kCol4; ++m) {
        if (kCol4 > kExactCol4 ? m >= ncols : m == kCol4 - 1 && !last) break;
        float4 qv[kRowStep];
#pragma unroll
        for (int s = 0; s < kRowStep; ++s) qv[s] = Qb[(r0 + s) * sh.ld4 + warp + kWarps * m];
#pragma unroll
        for (int s = 0; s < kRowStep; ++s) {
          acc[0][m].x = fmaf(ga[s], qv[s].x, acc[0][m].x);
          acc[0][m].y = fmaf(ga[s], qv[s].y, acc[0][m].y);
          acc[0][m].z = fmaf(ga[s], qv[s].z, acc[0][m].z);
          acc[0][m].w = fmaf(ga[s], qv[s].w, acc[0][m].w);
          acc[1][m].x = fmaf(gb[s], qv[s].x, acc[1][m].x);
          acc[1][m].y = fmaf(gb[s], qv[s].y, acc[1][m].y);
          acc[1][m].z = fmaf(gb[s], qv[s].z, acc[1][m].z);
          acc[1][m].w = fmaf(gb[s], qv[s].w, acc[1][m].w);
        }
      }
    }
  }

  // this block's partials into its own shared memory: dx rows over the query
  // buffers, per-candidate sums over the four threads of a candidate in order
  __syncthreads();  // the walk no longer reads Qs, red or Gs
  red[er * kCands + ec] = sum_xx;
  red[(4 + er) * kCands + ec] = sum_g;
  float4* part = Qs;  // [kCands][d4]
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int m = 0; m < kCol4; ++m) {
      const int k = warp + kWarps * m;
      if (k < sh.d4) part[(lane + 32 * c) * sh.d4 + k] = acc[c][m];
    }
  __syncthreads();
  if (tid < kCands) {
    csum[0][tid] = ((red[tid] + red[kCands + tid]) + red[2 * kCands + tid]) + red[3 * kCands + tid];
    csum[1][tid] = ((red[4 * kCands + tid] + red[5 * kCands + tid]) + red[6 * kCands + tid]) +
                   red[7 * kCands + tid];
  }
  cluster.sync();  // every rank's partials are in its shared memory

  // the cluster's sums, in rank order: per-candidate totals, then this rank's share of dx
  if (tid < kCands) {
    float txx = 0.f, tg = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* cs = cluster.map_shared_rank(&csum[0][0], k);
      txx += cs[tid];
      tg += cs[kCands + tid];
    }
    xx_s[tid] = txx;
    if (tid % splits == rank && col0 + tid < N) dbias[col0 + tid] = tg;
  }
  const float4* parts[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k) parts[k] = k < splits ? cluster.map_shared_rank(part, k) : part;
  __syncthreads();  // xx_s
  const int cands = min(kCands, N - col0), total = cands * sh.d4;
  const int chunk = (total + splits - 1) / splits;
  const int e_end = min(total, (rank + 1) * chunk);
  const float4* xt4 = x4 + static_cast<size_t>(col0) * sh.d4;
  float4* dx4 = reinterpret_cast<float4*>(dx) + static_cast<size_t>(col0) * sh.d4;
  for (int e = rank * chunk + tid; e < e_end; e += bwdx::kThreads) {
    float4 v[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < splits) v[k] = parts[k][e];
    float4 s = v[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < splits) {
        s.x += v[k].x;
        s.y += v[k].y;
        s.z += v[k].z;
        s.w += v[k].w;
      }
    const float two = 2.f * xx_s[e / sh.d4];
    const float4 xv = __ldg(xt4 + e);
    dx4[e] = make_float4(fmaf(two, xv.x, s.x), fmaf(two, xv.y, s.y), fmaf(two, xv.z, s.z),
                         fmaf(two, xv.w, s.w));
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

// -------------------------------------------------------- backward: queries
//
// The mirror of backward_x, with q and x swapped. Each tile of kQueries
// queries gets `splits` clusters of C blocks, and the splits x C blocks cut
// its candidate tiles. Each block keeps the query tile in registers and walks
// its candidate tiles of kRows rows, double-buffered with cp.async. At the
// end every block leaves its dq / dqq / dc partial in its own shared memory;
// after a cluster barrier the ranks sum them in rank order through
// distributed shared memory and write the cluster's partial to device
// memory, each rank its share; the last cluster of the query tile to finish
// (a counter per query tile) sums the clusters' partials in split order and
// writes dq and dc once. Rank 0 of each cluster leaves the cluster's
// dscale / dmargin terms in device memory, and the last cluster of the grid
// (one more counter) sums them in cluster order. The card holds only 7
// clusters of 10 to 16 blocks at once and 15 of 8 (H100 SXM), so with 8
// query tiles it is clusters of 2, 8 per query tile (128 blocks), that fill
// the SMs in one wave.

namespace bwdq {

constexpr int kQueries = 64;    // queries per cluster tile: lane l holds l and l + 32
constexpr int kRows = 32;       // candidates per tile of a block's walk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // above 8 a non-portable cluster size
constexpr int kRowStep = 8;     // candidate rows per step of both products
constexpr int kBatch = 8;       // split partials loaded at once in the merge
// the dq partial of a block, [kQueries][d4], fits the two candidate buffers
static_assert(kQueries == 2 * kRows, "the merge reuses the candidate buffers");

// The per-query values of the chain, hoisted out of it: each thread of the
// chain works on one query for the whole walk and keeps them in registers.
// k0..k4: true distance, sqrt(c + eps), 2 / (sqrt(c + eps) + eps), the
// max-norm clamp 1 / (sqrt(c + eps) + eps) - eps, 1 / (sqrt(c + eps) + eps)^2
// and 0.5 / sqrt(c + eps); proxy, the squared clamp and d dist / d c where
// the clamp binds.
struct Query {
  float qq, c, l, g, Bc, k0, k1, k2, k3, k4;
  int tgt;
};

template <bool kTrue>
__device__ __forceinline__ Query query_constants(float qq, float c, float l, float g, int tgt) {
  Query k;
  k.qq = qq;
  k.c = c;
  k.l = l;
  k.g = g;
  k.tgt = tgt;
  k.Bc = 1.f - c * qq;
  if (kTrue) {
    const float sqrt_c = sqrtf(c + kEps);
    const float s1 = sqrt_c + kEps;
    k.k0 = sqrt_c;
    k.k1 = 2.f / s1;
    k.k2 = 1.f / s1 - kEps;
    k.k3 = 1.f / (s1 * s1);
    k.k4 = 0.5f / sqrt_c;
  } else {
    const float mx = 1.f / sqrtf(c) - 2.f * kEps;
    k.k0 = mx * mx;
    k.k1 = 2.f * mx * (-0.5f / (c * sqrtf(c)));
    k.k2 = k.k3 = k.k4 = 0.f;
  }
  return k;
}

// One pair's logit and the intermediates its gradient needs.
struct Logit {
  float A, D, num_sq, diff_sq, dn0, dn, z, at, block, logit;
};

// The logit of one pair (the header's expressions) with the per-query values
// precomputed. The forward and backward_q both call it, so that from the
// same p, |q|^2 and |x|^2 they compute the same logit, bit for bit.
template <bool kTrue>
__device__ __forceinline__ Logit pair_logit(float p, float xx, float b, const Query& k,
                                            float scale, float margin) {
  const float qq = k.qq, c = k.c, Bc = k.Bc;
  Logit e;
  e.A = 1.f - 2.f * c * p + c * xx;
  e.D = 1.f - 2.f * c * p + (c * c) * qq * xx + kEps;
  e.num_sq = e.A * e.A * qq - 2.f * e.A * Bc * p + Bc * Bc * xx;
  // the proxy needs no IEEE division: its clamp caps the distance, while the
  // true distance's artanh amplifies the rounding of diff_sq near the edge
  e.diff_sq = kTrue ? fmaxf(e.num_sq, 0.f) / (e.D * e.D)
                    : __fdividef(fmaxf(e.num_sq, 0.f), e.D * e.D);
  float dist;
  e.dn0 = e.dn = e.z = e.at = 0.f;
  if (kTrue) {
    e.dn0 = sqrtf(fmaxf(e.diff_sq, kEps * kEps));
    e.dn = fminf(e.dn0, k.k2);
    e.z = fminf(k.k0 * e.dn, 1.f - kEps);
    e.at = atanhf(e.z);
    dist = k.k1 * e.at;
  } else {
    dist = fminf(e.diff_sq, k.k0);
  }
  e.block = margin - dist;
  e.logit = scale * e.block + b;
  return e;
}

// For one pair: dlogit, block = margin - dist, and the chain rule from dlogit
// back to p, |q|^2 and c (the kernel needs no gradient of |x|^2): the
// derivative of each of pair_logit's expressions; the clamps pass no
// gradient where they bind.
template <bool kTrue>
__device__ __forceinline__ void pair_grad(float p, float xx, float b, bool is_target,
                                          const Query& k, float scale, float margin,
                                          float& dlogit, float& block, float& gp, float& gqq,
                                          float& gc) {
  const float qq = k.qq, c = k.c, Bc = k.Bc;
  const Logit e = pair_logit<kTrue>(p, xx, b, k, scale, margin);
  const float A = e.A, D = e.D, num_sq = e.num_sq, diff_sq = e.diff_sq;
  const float dn0 = e.dn0, dn = e.dn, z = e.z, at = e.at, logit = e.logit;
  block = e.block;
  // expf on both distances: __expf's bias (~1e-6 of each weight) shows in
  // dscale, a sum over B x N pairs
  dlogit = k.g * (expf(logit - k.l) - (is_target ? 1.f : 0.f));
  const float ddist = -scale * dlogit;
  float ddiff, dc;
  if (kTrue) {
    const float dz = (k.k0 * dn < 1.f - kEps) ? ddist * k.k1 / (1.f - z * z) : 0.f;
    const float ddn = dz * k.k0;
    const bool unclamped = dn0 < k.k2;  // the max-norm clamp does not bind
    const float ds1 = ddist * at * (-2.f * k.k3) - (unclamped ? 0.f : ddn * k.k3);
    dc = (dz * dn + ds1) * k.k4;
    ddiff = diff_sq > kEps * kEps ? (unclamped ? ddn : 0.f) * 0.5f / dn0 : 0.f;
  } else {
    const bool inside = diff_sq < k.k0;
    ddiff = inside ? ddist : 0.f;
    dc = inside ? 0.f : ddist * k.k1;
  }
  const float inv_d = kTrue ? 1.f / D : __fdividef(1.f, D);
  const float inv_d2 = inv_d * inv_d;
  const float dnum = num_sq > 0.f ? ddiff * inv_d2 : 0.f;
  const float dD = -2.f * ddiff * fmaxf(num_sq, 0.f) * inv_d2 * inv_d;
  const float dA = dnum * (2.f * A * qq - 2.f * Bc * p);
  const float dB = dnum * (2.f * Bc * xx - 2.f * A * p);
  gp = -2.f * A * Bc * dnum - 2.f * c * dA - 2.f * c * dD;
  gqq = A * A * dnum - c * dB + c * c * xx * dD;
  gc = dc + (xx - 2.f * p) * dA - qq * dB + (2.f * c * qq * xx - 2.f * p) * dD;
}

// |row|^2 of kN rows of a row-major [*, width] matrix (rows past `valid` give
// 0), each summed over the warp in the order of bwdx::warp_row_sq (lane-strided,
// then a butterfly), with every load issued before the first add: out[i] in
// every lane. kPerLane elements of a row per lane, width <= 32 kPerLane (the
// kernels pass kCol4); the zeros past the width add nothing, so any kPerLane
// that covers the width gives the same sums. Near the ball's edge 1 - c |q|^2 cancels to ~1e-3, and the true
// distance's artanh amplifies its rounding ~1000x, so |q|^2 keeps the
// summation order of the earlier kernels.
template <int kN, int kPerLane, typename Load>
__device__ __forceinline__ void warp_rows_sq(Load load, int width, int valid, int lane,
                                             float* out) {
  float v[kN][kPerLane];
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int k = lane + 32 * j;
      v[i][j] = i < valid && k < width ? load(i, k) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc = fmaf(v[i][j], v[i][j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    out[i] = acc;
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// bias of the candidate tile at col0 into s[rows], zero past N; asynchronous.
__device__ __forceinline__ void load_bias_async(float* s, const float* bias, int col0, int N,
                                                int rows = kRows) {
  if (static_cast<int>(threadIdx.x) < rows) {
    const bool ok = col0 + static_cast<int>(threadIdx.x) < N;
    bwdx::cp_async4(s + threadIdx.x, bias + (ok ? col0 + threadIdx.x : 0), ok);
  }
}

size_t smem_bytes(int d) {
  return 2 * static_cast<size_t>(kRows) * make_shape(d).ld4 * sizeof(float4) +
         static_cast<size_t>(kWarps + 1) * kRows * kQueries * sizeof(float);
}

}  // namespace bwdq

// kCol4 = ceil(d / 32) float4 columns per warp, as in backward_x.
template <bool kTrue, int kCol4>
__global__ void __launch_bounds__(bwdq::kThreads, 1)
    ce_backward_q_kernel(const float* __restrict__ q, const float* __restrict__ x,
                         const float* __restrict__ bias, const float* __restrict__ cq,
                         const int* __restrict__ target, Scalars sc,
                         const float* __restrict__ lse, const float* __restrict__ g,
                         float* __restrict__ dq_part, float* __restrict__ rows_part,
                         float* __restrict__ scal_part, float* __restrict__ dq,
                         float* __restrict__ dc, float* __restrict__ dscale,
                         float* __restrict__ dmargin, int* __restrict__ counters, int B, int N,
                         int d, int splits) {
  using namespace bwdq;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  unsigned cluster_size;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(cluster_size));
  const int C = static_cast<int>(cluster_size);
  extern __shared__ float4 smem[];
  __shared__ float bias_s[2][kRows], xx_s[kRows];
  __shared__ float qsum[2][kQueries], tqq_s[kQueries];
  __shared__ float wsum[2][kWarps], bsum[2];
  __shared__ int last_of_tile, last_of_grid;
  const Shape sh = make_shape(d);
  float4* Xs = smem;  // two buffers of kRows rows
  float* red = reinterpret_cast<float*>(Xs + 2 * kRows * sh.ld4);  // [kWarps][kRows][kQueries]
  float* Gs = red + kWarps * kRows * kQueries;                      // [kRows][kQueries]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cid = static_cast<int>(blockIdx.x) / C, n_clusters = static_cast<int>(gridDim.x) / C;
  const int qtile = cid / splits, csplit = cid % splits, row0 = qtile * kQueries;
  const int q_tiles = n_clusters / splits;
  const float scale = __ldg(sc.scale), margin = __ldg(sc.margin);

  // this block's candidate tiles (split csplit * C + rank of splits * C); the
  // first is in flight while the queries load
  const int c_tiles = (N + kRows - 1) / kRows;
  const int per = (c_tiles + splits * C - 1) / (splits * C);
  const int t_begin = min((csplit * C + rank) * per, c_tiles), t_end = min(t_begin + per, c_tiles);
  if (t_begin < t_end) {
    bwdx::load_tile_async(Xs, x, t_begin * kRows, kRows, N, sh);
    load_bias_async(bias_s[0], bias, t_begin * kRows, N);
  }
  bwdx::cp_async_commit();

  // queries lane and lane + 32, float4 columns warp + 8 m: in registers for
  // the whole walk (both products read only the candidate rows from shared
  // memory, every lane of a warp the same float4)
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const bool last = warp + kWarps * (kCol4 - 1) < sh.d4;  // this warp has column kCol4 - 1
  const int ncols = (sh.d4 - warp + kWarps - 1) / kWarps;  // this warp's columns (wide instances)
  float4 qr[2][kCol4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int row = row0 + lane + 32 * c;
#pragma unroll
    for (int m = 0; m < kCol4; ++m) {
      const int k = warp + kWarps * m;
      qr[c][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < B && k < sh.d4) qr[c][m] = __ldg(q4 + static_cast<size_t>(row) * sh.d4 + k);
    }
  }
  {  // |q|^2, warp w summing rows 8w .. 8w + 7
    constexpr int kPerWarp = kQueries / kWarps;
    const int r0 = warp * kPerWarp;
    const float* qw = q + static_cast<size_t>(row0 + r0) * d;
    float qq_r[kPerWarp];
    warp_rows_sq<kPerWarp, kCol4>([&](int i, int k) { return __ldg(qw + static_cast<size_t>(i) * d + k); },
                           d, B - row0 - r0, lane, qq_r);
    if (lane < kPerWarp) {
      float v = qq_r[0];
#pragma unroll
      for (int i = 1; i < kPerWarp; ++i)
        if (lane == i) v = qq_r[i];
      red[r0 + lane] = v;
    }
  }
  __syncthreads();
  // the elementwise chain: query eq, candidate rows er + 4 i; rows past B get
  // c = 1, lse = g = 0 (they are masked)
  const int eq = tid % kQueries, er = tid / kQueries;
  const float qq = red[eq];
  const int qrow = row0 + eq;
  const bool row_ok = qrow < B;
  const Query kq = query_constants<kTrue>(
      qq, row_ok ? __ldg(cq + qrow) : 1.f, row_ok ? __ldg(lse + qrow) : 0.f,
      row_ok ? __ldg(g + qrow) : 0.f, row_ok ? __ldg(target + qrow) : -1);
  float sum_qq = 0.f, sum_c = 0.f, sum_gblock = 0.f;
  // dmargin: a shift of all of a query's logits leaves its NLL unchanged, so
  // sum_j dlogit_ij = g_i (sum_j softmax_ij - [target_i < N]) = g_i [target_i
  // is no candidate], counted once per query. Summing the B x N dlogits
  // instead leaves rounding noise: that of lse and of the sums, and, while the
  // forward's logits differed from these by a few ulp, 1e-4 at config 3's
  // entity shape, against 0.
  const float sum_g =
      er == 0 && rank == 0 && csplit == 0 && (kq.tgt < 0 || kq.tgt >= N) ? kq.g : 0.f;
  float4 acc[2][kCol4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int m = 0; m < kCol4; ++m) acc[c][m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1, col0 = t * kRows;
    const float4* Xb = Xs + buf * kRows * sh.ld4;
    bwdx::cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 1 (and red, Gs, xx_s) no longer read
    if (t + 1 < t_end) {
      bwdx::load_tile_async(Xs + (buf ^ 1) * kRows * sh.ld4, x, col0 + kRows, kRows, N, sh);
      load_bias_async(bias_s[buf ^ 1], bias, col0 + kRows, N);
    }
    bwdx::cp_async_commit();
    {  // |x|^2 of the tile's rows: warp w sums rows 4w .. 4w + 3, lanes 0 .. 3 store them
      constexpr int kPerWarp = kRows / kWarps;
      const float* xw = reinterpret_cast<const float*>(Xb + warp * kPerWarp * sh.ld4);
      float xx_r[kPerWarp];
      warp_rows_sq<kPerWarp, kCol4>([&](int i, int k) { return xw[i * 4 * sh.ld4 + k]; }, d, kPerWarp,
                             lane, xx_r);
      float v = xx_r[0];
#pragma unroll
      for (int rr = 1; rr < kPerWarp; ++rr)
        if (lane == rr) v = xx_r[rr];
      if (lane < kPerWarp) xx_s[warp * kPerWarp + lane] = v;
    }
    // this warp's share of p over its columns, kRowStep candidates at a time
    for (int j0 = 0; j0 < kRows; j0 += kRowStep) {
      float pd[kRowStep][2];
#pragma unroll
      for (int s = 0; s < kRowStep; ++s) pd[s][0] = pd[s][1] = 0.f;
#pragma unroll
      for (int m = 0; m < kCol4; ++m) {
        if (kCol4 > kExactCol4 ? m >= ncols : m == kCol4 - 1 && !last) break;
#pragma unroll
        for (int s = 0; s < kRowStep; ++s) {
          const float4 xv = Xb[(j0 + s) * sh.ld4 + warp + kWarps * m];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = pd[s][c];
            v = fmaf(xv.x, qr[c][m].x, v);
            v = fmaf(xv.y, qr[c][m].y, v);
            v = fmaf(xv.z, qr[c][m].z, v);
            v = fmaf(xv.w, qr[c][m].w, v);
            pd[s][c] = v;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kRowStep; ++s) {
        red[(warp * kRows + j0 + s) * kQueries + lane] = pd[s][0];
        red[(warp * kRows + j0 + s) * kQueries + lane + 32] = pd[s][1];
      }
    }
    __syncthreads();  // red, xx_s
    // without branches, so the eight chains interleave: queries past B and
    // candidates past N (x = 0, bias = 0) give finite values, dropped
    const float* bt = bias_s[buf];
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int r = er + 4 * i;
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) p += red[(w * kRows + r) * kQueries + eq];
      float dlogit, block, gp, gqq, gc;
      pair_grad<kTrue>(p, xx_s[r], bt[r], col0 + r == kq.tgt, kq, scale, margin, dlogit, block,
                       gp, gqq, gc);
      const bool ok = row_ok && col0 + r < N;
      sum_qq += ok ? gqq : 0.f;
      sum_c += ok ? gc : 0.f;
      sum_gblock += ok ? dlogit * block : 0.f;
      Gs[r * kQueries + eq] = ok ? gp : 0.f;
    }
    __syncthreads();  // Gs
    // acc[query lane + 32 c][warp + 8 m] += sum_j dp[query][j] * x[j][warp + 8 m],
    // kRowStep candidates at a time so that each column's loads go out together
    for (int j0 = 0; j0 < kRows; j0 += kRowStep) {
      float g0[kRowStep], g1[kRowStep];
#pragma unroll
      for (int s = 0; s < kRowStep; ++s) {
        g0[s] = Gs[(j0 + s) * kQueries + lane];
        g1[s] = Gs[(j0 + s) * kQueries + lane + 32];
      }
#pragma unroll
      for (int m = 0; m < kCol4; ++m) {
        if (kCol4 > kExactCol4 ? m >= ncols : m == kCol4 - 1 && !last) break;
        float4 xv[kRowStep];
#pragma unroll
        for (int s = 0; s < kRowStep; ++s) xv[s] = Xb[(j0 + s) * sh.ld4 + warp + kWarps * m];
#pragma unroll
        for (int s = 0; s < kRowStep; ++s) {
          acc[0][m].x = fmaf(g0[s], xv[s].x, acc[0][m].x);
          acc[0][m].y = fmaf(g0[s], xv[s].y, acc[0][m].y);
          acc[0][m].z = fmaf(g0[s], xv[s].z, acc[0][m].z);
          acc[0][m].w = fmaf(g0[s], xv[s].w, acc[0][m].w);
          acc[1][m].x = fmaf(g1[s], xv[s].x, acc[1][m].x);
          acc[1][m].y = fmaf(g1[s], xv[s].y, acc[1][m].y);
          acc[1][m].z = fmaf(g1[s], xv[s].z, acc[1][m].z);
          acc[1][m].w = fmaf(g1[s], xv[s].w, acc[1][m].w);
        }
      }
    }
  }

  // this block's partials into its own shared memory: dq rows over the
  // candidate buffers, per-query sums over the four threads of a query in
  // order, the block's dscale / dmargin terms over the warps in order
  __syncthreads();  // the walk no longer reads Xs, red or Gs
  red[er * kQueries + eq] = sum_qq;
  red[(4 + er) * kQueries + eq] = sum_c;
  float4* part = Xs;  // [kQueries][d4]
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int m = 0; m < kCol4; ++m) {
      const int k = warp + kWarps * m;
      if (k < sh.d4) part[(lane + 32 * c) * sh.d4 + k] = acc[c][m];
    }
  {
    float a = sum_gblock, b = sum_g;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      wsum[0][warp] = a;
      wsum[1][warp] = b;
    }
  }
  __syncthreads();
  if (tid < kQueries) {
    qsum[0][tid] = ((red[tid] + red[kQueries + tid]) + red[2 * kQueries + tid]) +
                   red[3 * kQueries + tid];
    qsum[1][tid] = ((red[4 * kQueries + tid] + red[5 * kQueries + tid]) +
                    red[6 * kQueries + tid]) + red[7 * kQueries + tid];
  }
  if (tid == 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += wsum[0][w];
      b += wsum[1][w];
    }
    bsum[0] = a;
    bsum[1] = b;
  }
  cluster.sync();  // every rank's partials are in its shared memory

  // the cluster's sums, in rank order, into device memory: per-query dqq and
  // dc (by the rank that owns the query), the scalar terms (rank 0) and this
  // rank's share of the dq rows
  if (tid < kQueries) {
    float tq = 0.f, tc = 0.f;
    for (int k = 0; k < C; ++k) {
      const float* qs = cluster.map_shared_rank(&qsum[0][0], k);
      tq += qs[tid];
      tc += qs[kQueries + tid];
    }
    if (tid % C == rank && row0 + tid < B) {
      rows_part[static_cast<size_t>(csplit) * B + row0 + tid] = tq;
      rows_part[static_cast<size_t>(splits + csplit) * B + row0 + tid] = tc;
    }
  }
  if (rank == 0 && tid == kQueries) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < C; ++k) {
      const float* bs = cluster.map_shared_rank(bsum, k);
      a += bs[0];
      b += bs[1];
    }
    scal_part[2 * cid] = a;
    scal_part[2 * cid + 1] = b;
  }
  const float4* parts[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k) parts[k] = k < C ? cluster.map_shared_rank(part, k) : part;
  const int rows = min(kQueries, B - row0), total = rows * sh.d4;
  const int chunk = (total + C - 1) / C;
  const int e_begin = rank * chunk, e_end = min(total, (rank + 1) * chunk);
  float4* dq_part4 = reinterpret_cast<float4*>(dq_part);
  const size_t split_stride = static_cast<size_t>(B) * sh.d4;  // float4s per split
  float4* mine = dq_part4 + csplit * split_stride + static_cast<size_t>(row0) * sh.d4;
  for (int e = e_begin + tid; e < e_end; e += 2 * bwdq::kThreads) {
    const int e2 = e + bwdq::kThreads;  // two elements a thread, every load in flight
    const bool two = e2 < e_end;
    float4 v[kMaxCluster], w[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < C) {
        v[k] = parts[k][e];
        w[k] = two ? parts[k][e2] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    float4 s = v[0], s2 = w[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < C) {
        add4(s, v[k]);
        add4(s2, w[k]);
      }
    mine[e] = s;
    if (two) mine[e2] = s2;
  }
  __threadfence();
  cluster.sync();  // the cluster's partial is out; no rank reads another's shared memory any more
  if (rank == 0 && tid == 0) {
    const int last = atomicAdd(counters + qtile, 1) == splits - 1;
    for (int k = 0; k < C; ++k) *cluster.map_shared_rank(&last_of_tile, k) = last;
  }
  cluster.sync();

  // the last cluster of this query tile: the splits' partials in split order
  if (last_of_tile) {
    __threadfence();
    // (kBatch splits' loads in flight at a time, for two elements a thread)
    if (tid < kQueries && row0 + tid < B) {
      const float* tq_part = rows_part + row0 + tid;
      const float* tc_part = tq_part + static_cast<size_t>(splits) * B;
      float tq = 0.f, tc = 0.f;
      for (int k0 = 0; k0 < splits; k0 += kBatch) {
        float a[kBatch], b[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (k0 + u < splits) {
            a[u] = __ldcg(tq_part + static_cast<size_t>(k0 + u) * B);
            b[u] = __ldcg(tc_part + static_cast<size_t>(k0 + u) * B);
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (k0 + u < splits) {
            tq += a[u];
            tc += b[u];
          }
      }
      tqq_s[tid] = tq;
      if (tid % C == rank) dc[row0 + tid] = tc;
    }
    __syncthreads();  // tqq_s
    const float4* first = dq_part4 + static_cast<size_t>(row0) * sh.d4;
    const float4* qt4 = q4 + static_cast<size_t>(row0) * sh.d4;
    float4* dq4 = reinterpret_cast<float4*>(dq) + static_cast<size_t>(row0) * sh.d4;
    for (int e = e_begin + tid; e < e_end; e += 2 * bwdq::kThreads) {
      const int e2 = e + bwdq::kThreads;
      const bool two = e2 < e_end;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f), s2 = s;
      for (int k0 = 0; k0 < splits; k0 += kBatch) {
        float4 v[kBatch], w[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (k0 + u < splits) {
            v[u] = __ldcg(first + (k0 + u) * split_stride + e);
            if (two) w[u] = __ldcg(first + (k0 + u) * split_stride + e2);
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (k0 + u < splits) {
            add4(s, v[u]);
            if (two) add4(s2, w[u]);
          }
      }
      const float t1 = 2.f * tqq_s[e / sh.d4];
      const float4 qv = __ldg(qt4 + e);
      dq4[e] = make_float4(fmaf(t1, qv.x, s.x), fmaf(t1, qv.y, s.y), fmaf(t1, qv.z, s.z),
                           fmaf(t1, qv.w, s.w));
      if (two) {
        const float t2 = 2.f * tqq_s[e2 / sh.d4];
        const float4 qv2 = __ldg(qt4 + e2);
        dq4[e2] = make_float4(fmaf(t2, qv2.x, s2.x), fmaf(t2, qv2.y, s2.y),
                              fmaf(t2, qv2.z, s2.z), fmaf(t2, qv2.w, s2.w));
      }
    }
    if (rank == 0 && tid == 0) counters[qtile] = 0;  // ready for the next launch
  }

  // dscale and dmargin: the last cluster of the grid sums the clusters' terms in order
  // (a fixed order: thread t sums entries t, t + 256, ..., then the warps'
  // butterflies, then the warps in order)
  if (rank == 0 && last_to_finish(counters + q_tiles, n_clusters, &last_of_grid)) {
    float a = 0.f, b = 0.f;
    for (int k = tid; k < n_clusters; k += bwdq::kThreads) {
      a += __ldcg(scal_part + 2 * k);
      b += __ldcg(scal_part + 2 * k + 1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      wsum[0][warp] = a;
      wsum[1][warp] = b;
    }
    __syncthreads();
    if (tid == 0) {
      float ta = 0.f, tb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ta += wsum[0][w];
        tb += wsum[1][w];
      }
      *dscale = ta;
      *dmargin = scale * tb;
      counters[q_tiles] = 0;  // ready for the next launch
    }
  }
}

// ---------------------------------------------------------------- forward
//
// backward_q's walk without its dQ product. Per tile of kQueries queries,
// `splits` blocks cut the candidate tiles. Each block loads its query tile
// once, coalesced, into shared memory, takes |q|^2 from there and keeps its
// queries in registers; it walks its candidate tiles of kRows rows,
// double-buffered with cp.async, with one barrier per tile. It takes p,
// |q|^2 and |x|^2 in backward_q's order and each logit through
// bwdq::pair_logit, so the two kernels compute the same logits bit for bit.
// Each chain thread works on one query and folds its candidates into a
// running (max, sum-exp, target logit) in registers, rescaled once per tile;
// the threads of a query merge in order, the block writes one partial per
// query, and the last block of the query tile to finish (a counter) merges
// the splits in split order into lse and nll, one round trip to L2 for up
// to kBatch splits.

namespace fwd {

constexpr int kRows = 16;  // candidates per tile of a block's walk
// queries per lane: one broadcast float4 of a candidate row feeds 4 kQL
// FMAs. 2 (64 queries per block, two blocks per SM at <= 128 registers)
// measured slower at config 3's entity shape (PERF.md).
constexpr int kQL = 4;
constexpr int kQueries = 32 * kQL;  // per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowStep = 8;  // candidate rows per step of the product
constexpr int kBatch = 32;   // split partials loaded at once in the merge
// row stride of the p partials [kWarps][queries][kLd]: float4-aligned, and
// 80 bytes apart, so the 8 lanes of a quarter-warp hit distinct banks
constexpr int kLd = kRows + 4;
// the widest instance that stages its query tile through shared memory (d <=
// 256); wider ones load their queries from device memory
constexpr int kStagedCol4 = kExactCol4;
static_assert(kThreads == bwdx::kThreads, "tiles load through bwdx::load_tile_async");
static_assert(kRowStep % 4 == 0, "the product stores its partials as float4s");

// two candidate buffers and two of the per-warp p partials, which first
// hold the query tile [kQueries][ld4] where it is staged
size_t smem_bytes(int d) {
  const size_t ld4 = make_shape(d).ld4;
  const bool staged = (d / 4 + kWarps - 1) / kWarps <= kStagedCol4;
  return 2 * kRows * ld4 * sizeof(float4) +
         std::max(2 * static_cast<size_t>(kWarps) * kQueries * kLd * sizeof(float),
                  staged ? kQueries * ld4 * sizeof(float4) : 0);
}

}  // namespace fwd

// kCol4 = ceil(d / 32) float4 columns per warp, as in backward_q.
template <bool kTrue, int kCol4>
__global__ void __launch_bounds__(fwd::kThreads, 1)
    ce_forward_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      const float* __restrict__ bias, const float* __restrict__ cq,
                      const int* __restrict__ target, Scalars sc, float* __restrict__ part,
                      float* __restrict__ nll, float* __restrict__ lse,
                      int* __restrict__ counters, int B, int N, int d) {
  using namespace fwd;
  constexpr int kGroups = kThreads / kQueries;  // chain threads of one query
  constexpr int kPairs = kRows / kGroups;       // pairs of a chain thread per tile
  static_assert(kPairs % 4 == 0, "the chain loads its partials as float4s");
  extern __shared__ float4 smem[];
  __shared__ float bias_s[3][kRows], xx_s[2][kRows], qq_s[kQueries];
  __shared__ int flag;
  const Shape sh = make_shape(d);
  float4* Xs = smem;  // two buffers of kRows rows
  float* red = reinterpret_cast<float*>(Xs + 2 * kRows * sh.ld4);  // [2][kWarps][kQueries][kLd]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qtile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int row0 = qtile * kQueries;
  const float scale = __ldg(sc.scale), margin = __ldg(sc.margin);

  // this block's candidate tiles; the first and the query tile load together
  const int c_tiles = (N + kRows - 1) / kRows;
  const int per = (c_tiles + splits - 1) / splits;
  const int t_begin = min(split * per, c_tiles), t_end = min(t_begin + per, c_tiles);
  if (t_begin < t_end) {
    bwdx::load_tile_async(Xs, x, t_begin * kRows, kRows, N, sh);
    bwdq::load_bias_async(bias_s[0], bias, t_begin * kRows, N, kRows);
  }
  // the query tile, coalesced and read once, in the place of the p partials
  // (up to d = 256; a wider tile does not fit beside them)
  constexpr bool kStaged = kCol4 <= kStagedCol4;
  const float4* Qs = reinterpret_cast<const float4*>(red);  // [kQueries][ld4]
  if (kStaged) bwdx::load_tile_async(reinterpret_cast<float4*>(red), q, row0, kQueries, B, sh);
  bwdx::cp_async_commit();
  bwdx::cp_async_wait_all();
  __syncthreads();
  {  // |q|^2 as backward_q takes it (the same values in the same order), warp
     // w summing rows kPerWarp w .., eight at a time
    constexpr int kPerWarp = kQueries / kWarps;
    const float* qf = reinterpret_cast<const float*>(Qs);
#pragma unroll
    for (int h = 0; h < kPerWarp; h += 8) {
      const int r0 = warp * kPerWarp + h;
      float qq_r[8];
      if (kStaged)
        bwdq::warp_rows_sq<8, kCol4>([&](int i, int k) { return qf[(r0 + i) * 4 * sh.ld4 + k]; },
                                     d, 8, lane, qq_r);
      else
        bwdq::warp_rows_sq<8, kCol4>(
            [&](int i, int k) { return __ldg(q + static_cast<size_t>(row0 + r0 + i) * d + k); },
            d, B - row0 - r0, lane, qq_r);
      if (lane < 8) {
        float v = qq_r[0];
#pragma unroll
        for (int i = 1; i < 8; ++i)
          if (lane == i) v = qq_r[i];
        qq_s[r0 + lane] = v;
      }
    }
  }
  // queries lane + 32 c, float4 columns warp + 8 m: in registers for the
  // whole walk (the product reads only candidate rows from shared memory,
  // every lane of a warp the same float4); rows past B are zero
  const bool last = warp + kWarps * (kCol4 - 1) < sh.d4;  // this warp has column kCol4 - 1
  const int ncols = (sh.d4 - warp + kWarps - 1) / kWarps;  // this warp's columns (wide instances)
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float4 qr[kQL][kCol4];
#pragma unroll
  for (int c = 0; c < kQL; ++c)
#pragma unroll
    for (int m = 0; m < kCol4; ++m) {
      const int k = warp + kWarps * m, row = row0 + lane + 32 * c;
      qr[c][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kStaged && k < sh.d4)
        qr[c][m] = Qs[(lane + 32 * c) * sh.ld4 + k];
      else if (!kStaged && k < sh.d4 && row < B)
        qr[c][m] = __ldg(q4 + static_cast<size_t>(row) * sh.d4 + k);
    }
  __syncthreads();  // qq_s; Qs is no longer read
  // the elementwise chain: query eq, candidate rows kPairs er + i; rows past
  // B get c = 1 (they are not written)
  const int eq = tid % kQueries, er = tid / kQueries;
  const int qrow = row0 + eq;
  const bool row_ok = qrow < B;
  const bwdq::Query kq = bwdq::query_constants<kTrue>(
      qq_s[eq], row_ok ? __ldg(cq + qrow) : 1.f, 0.f, 0.f, row_ok ? __ldg(target + qrow) : -1);
  float m_run = neg_inf(), s_run = 0.f, t_run = 0.f;

  // The walk over this block's candidate tiles: step t folds tile t - 1 (the
  // chain) and takes the p partials of tile t (the product), with one barrier
  // per step, so that warps done with the chain go on to the product while
  // others finish it. The p partials and |x|^2 are double-buffered, the bias
  // triple-buffered (tile t + 1's is in flight while the chain reads tile
  // t - 1's).
  for (int t = t_begin; t <= t_end; ++t) {
    const int k = t - t_begin;
    bwdx::cp_async_wait_all();
    __syncthreads();  // tile t has landed; the product of tile t - 1 is done
    if (t + 1 < t_end) {
      bwdx::load_tile_async(Xs + ((k + 1) & 1) * kRows * sh.ld4, x, (t + 1) * kRows, kRows, N,
                            sh);
      bwdq::load_bias_async(bias_s[(k + 1) % 3], bias, (t + 1) * kRows, N, kRows);
    }
    bwdx::cp_async_commit();
    if (t > t_begin) {  // the chain of tile t - 1
      const float* red_t = red + ((k - 1) & 1) * kWarps * kQueries * kLd;
      const float* xx_t = xx_s[(k - 1) & 1];
      const float* bt = bias_s[(k - 1) % 3];
      const int col0 = (t - 1) * kRows, r0 = kPairs * er;
      // p of each pair: the warps' partials summed in warp order
      float ps[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) ps[i] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int h = 0; h < kPairs; h += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(red_t + (w * kQueries + eq) * kLd + r0 + h);
          ps[h] += v.x;
          ps[h + 1] += v.y;
          ps[h + 2] += v.z;
          ps[h + 3] += v.w;
        }
      // without branches: candidates past N (x = 0, bias = 0) give finite
      // logits that the select turns into -inf
      float l[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int r = r0 + i;
        const float p = ps[i];
        const bwdq::Logit e = bwdq::pair_logit<kTrue>(p, xx_t[r], bt[r], kq, scale, margin);
        const bool ok = col0 + r < N;
        t_run += ok && col0 + r == kq.tgt ? e.logit : 0.f;
        l[i] = ok ? e.logit : neg_inf();
      }
      float tile_max = l[0];
#pragma unroll
      for (int i = 1; i < kPairs; ++i) tile_max = fmaxf(tile_max, l[i]);
      const float mx = fmaxf(m_run, tile_max);
      const float ref = mx == neg_inf() ? 0.f : mx;  // no valid candidate yet: no exp(-inf - -inf)
      // expf, not __expf: its bias (~1e-6 of each term) adds up over N candidates
      float acc = s_run * expf(m_run - ref);
#pragma unroll
      for (int i = 0; i < kPairs; ++i) acc += expf(l[i] - ref);
      s_run = acc;
      m_run = mx;
    }
    if (t < t_end) {  // the product of tile t
      const float4* Xb = Xs + (k & 1) * kRows * sh.ld4;
      float* red_t = red + (k & 1) * kWarps * kQueries * kLd;
      {  // |x|^2 of the tile's rows: warp w sums rows kPerWarp w .., lanes 0 .. kPerWarp - 1 store them
        constexpr int kPerWarp = kRows / kWarps;
        const float* xw = reinterpret_cast<const float*>(Xb + warp * kPerWarp * sh.ld4);
        float xx_r[kPerWarp];
        bwdq::warp_rows_sq<kPerWarp, kCol4>([&](int i, int j) { return xw[i * 4 * sh.ld4 + j]; }, d,
                                     kPerWarp, lane, xx_r);
        float v = xx_r[0];
#pragma unroll
        for (int rr = 1; rr < kPerWarp; ++rr)
          if (lane == rr) v = xx_r[rr];
        if (lane < kPerWarp) xx_s[k & 1][warp * kPerWarp + lane] = v;
      }
      // this warp's share of p over its columns, kRowStep candidates at a time
      for (int j0 = 0; j0 < kRows; j0 += kRowStep) {
        float dot[kRowStep][kQL];
#pragma unroll
        for (int s = 0; s < kRowStep; ++s)
#pragma unroll
          for (int c = 0; c < kQL; ++c) dot[s][c] = 0.f;
#pragma unroll
        for (int m = 0; m < kCol4; ++m) {
          if (kCol4 > kExactCol4 ? m >= ncols : m == kCol4 - 1 && !last) break;
#pragma unroll
          for (int s = 0; s < kRowStep; ++s) {
            const float4 xv = Xb[(j0 + s) * sh.ld4 + warp + kWarps * m];
#pragma unroll
            for (int c = 0; c < kQL; ++c) {
              float v = dot[s][c];
              v = fmaf(xv.x, qr[c][m].x, v);
              v = fmaf(xv.y, qr[c][m].y, v);
              v = fmaf(xv.z, qr[c][m].z, v);
              v = fmaf(xv.w, qr[c][m].w, v);
              dot[s][c] = v;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kQL; ++c)
#pragma unroll
          for (int h = 0; h < kRowStep; h += 4)
            *reinterpret_cast<float4*>(red_t + (warp * kQueries + lane + 32 * c) * kLd + j0 + h) =
                make_float4(dot[h][c], dot[h + 1][c], dot[h + 2][c], dot[h + 3][c]);
      }
    }
  }

  // the chain threads of each query in order, then this split's partial
  __syncthreads();  // the walk no longer reads red
  red[er * kQueries + eq] = m_run;
  red[(kGroups + er) * kQueries + eq] = s_run;
  red[(2 * kGroups + er) * kQueries + eq] = t_run;
  __syncthreads();
  const size_t stride = static_cast<size_t>(splits) * B;  // floats per field of part
  if (tid < kQueries && row_ok) {
    float M = red[tid], S = red[kGroups * kQueries + tid], T = red[2 * kGroups * kQueries + tid];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      lse_merge(M, S, red[g * kQueries + tid], red[(kGroups + g) * kQueries + tid]);
      T += red[(2 * kGroups + g) * kQueries + tid];
    }
    float* mine = part + static_cast<size_t>(split) * B + qrow;
    mine[0] = M;
    mine[stride] = S;
    mine[2 * stride] = T;
  }

  if (!last_to_finish(counters + qtile, splits, &flag)) return;
  // the last block of this query tile: the splits in order, one thread a
  // query, kBatch splits' loads in flight at once (one round trip to L2 for
  // up to kBatch splits), each batch rescaled to its maximum
  if (tid < kQueries && row_ok) {
    const float* pm = part + qrow;
    float M = neg_inf(), S = 0.f, T = 0.f;
    for (int k0 = 0; k0 < splits; k0 += kBatch) {
      float a[kBatch], b[kBatch], c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = k0 + u < splits;
        const size_t at = static_cast<size_t>(in ? k0 + u : 0) * B;
        a[u] = in ? __ldcg(pm + at) : neg_inf();
        b[u] = in ? __ldcg(pm + stride + at) : 0.f;
        c[u] = in ? __ldcg(pm + 2 * stride + at) : 0.f;
      }
      float mx = M;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) mx = fmaxf(mx, a[u]);
      const float ref = mx == neg_inf() ? 0.f : mx;  // every split so far empty
      S *= expf(M - ref);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        S += b[u] * expf(a[u] - ref);
        T += c[u];
      }
      M = mx;
    }
    const float l = M + logf(fmaxf(S, 1e-30f));
    lse[qrow] = l;
    nll[qrow] = l - T;
  }
  if (tid == 0) counters[qtile] = 0;  // ready for the next launch
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The widths of this library's instances: d <= 256, or, built with
// STREAMING_CE_WIDE (the wrapper's second library, compiled in parallel with
// the first), 256 < d <= 512.
bool in_library(int d) {
#ifdef STREAMING_CE_WIDE
  return d > 32 * kExactCol4 && d <= 4 * kMaxD4;
#else
  return d >= 4 && d <= 32 * kExactCol4;
#endif
}

// Rows of q and x load as float4s: d a multiple of 4, both 16-byte aligned.
bool float4_rows(const float* q, const float* x, int d) {
  return d % 4 == 0 && aligned16(q) && aligned16(x);
}

typedef void (*Forward)(const float*, const float*, const float*, const float*, const int*,
                        Scalars, float*, float*, float*, int*, int, int, int);

// The instance of the forward for width d (<= 512).
template <bool kTrue>
Forward forward_kernel(int d) {
  switch ((d / 4 + fwd::kWarps - 1) / fwd::kWarps) {
#ifdef STREAMING_CE_WIDE
    case 9:
    case 10:
    case 11:
    case 12: return ce_forward_kernel<kTrue, 12>;
    default: return ce_forward_kernel<kTrue, 16>;
#else
    case 1: return ce_forward_kernel<kTrue, 1>;
    case 2: return ce_forward_kernel<kTrue, 2>;
    case 3: return ce_forward_kernel<kTrue, 3>;
    case 4: return ce_forward_kernel<kTrue, 4>;
    case 5: return ce_forward_kernel<kTrue, 5>;
    case 6: return ce_forward_kernel<kTrue, 6>;
    case 7: return ce_forward_kernel<kTrue, 7>;
    default: return ce_forward_kernel<kTrue, 8>;
#endif
  }
}

typedef void (*BackwardX)(const float*, const float*, const float*, const float*, const int*,
                          Scalars, const float*, const float*, float*, float*, int, int, int);

// The instance of the candidate-side backward for width d (<= 512).
template <bool kTrue>
BackwardX backward_x_kernel(int d) {
  switch ((d / 4 + bwdx::kWarps - 1) / bwdx::kWarps) {
#ifdef STREAMING_CE_WIDE
    case 9:
    case 10:
    case 11:
    case 12: return ce_backward_x_kernel<kTrue, 12>;
    default: return ce_backward_x_kernel<kTrue, 16>;
#else
    case 1: return ce_backward_x_kernel<kTrue, 1>;
    case 2: return ce_backward_x_kernel<kTrue, 2>;
    case 3: return ce_backward_x_kernel<kTrue, 3>;
    case 4: return ce_backward_x_kernel<kTrue, 4>;
    case 5: return ce_backward_x_kernel<kTrue, 5>;
    case 6: return ce_backward_x_kernel<kTrue, 6>;
    case 7: return ce_backward_x_kernel<kTrue, 7>;
    default: return ce_backward_x_kernel<kTrue, 8>;
#endif
  }
}

// The launch of one cluster of `splits` blocks per candidate tile.
cudaLaunchConfig_t backward_x_config(int N, int d, int splits, cudaStream_t stream,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + bwdx::kCands - 1) / bwdx::kCands) * splits);
  cfg.blockDim = dim3(bwdx::kThreads);
  cfg.dynamicSmemBytes = bwdx::smem_bytes(d);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kTrue>
cudaError_t launch_backward_x(const float* q, const float* x, const float* bias, const float* cq,
                              const int* target, Scalars sc, const float* lse, const float* g,
                              float* dx, float* dbias, int B, int N, int d, int splits,
                              cudaStream_t stream) {
  const BackwardX kernel = backward_x_kernel<kTrue>(d);
  cudaError_t err = allow_smem(kernel, bwdx::smem_bytes(d));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = backward_x_config(N, d, splits, stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, q, x, bias, cq, target, sc, lse, g, dx, dbias, B, N, d);
}

template <bool kTrue>
cudaError_t backward_x_occupancy(int d, int splits, int* blocks_per_sm, int* active_clusters) {
  const BackwardX kernel = backward_x_kernel<kTrue>(d);
  const size_t smem = bwdx::smem_bytes(d);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, bwdx::kThreads,
                                                        smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = backward_x_config(splits * bwdx::kCands, d, splits, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(active_clusters, kernel, &cfg);
}

typedef void (*BackwardQ)(const float*, const float*, const float*, const float*, const int*,
                          Scalars, const float*, const float*, float*, float*, float*, float*,
                          float*, float*, float*, int*, int, int, int, int);

// The instance of the query-side backward for width d (<= 512).
template <bool kTrue>
BackwardQ backward_q_kernel(int d) {
  switch ((d / 4 + bwdq::kWarps - 1) / bwdq::kWarps) {
#ifdef STREAMING_CE_WIDE
    case 9:
    case 10:
    case 11:
    case 12: return ce_backward_q_kernel<kTrue, 12>;
    default: return ce_backward_q_kernel<kTrue, 16>;
#else
    case 1: return ce_backward_q_kernel<kTrue, 1>;
    case 2: return ce_backward_q_kernel<kTrue, 2>;
    case 3: return ce_backward_q_kernel<kTrue, 3>;
    case 4: return ce_backward_q_kernel<kTrue, 4>;
    case 5: return ce_backward_q_kernel<kTrue, 5>;
    case 6: return ce_backward_q_kernel<kTrue, 6>;
    case 7: return ce_backward_q_kernel<kTrue, 7>;
    default: return ce_backward_q_kernel<kTrue, 8>;
#endif
  }
}

// Shared memory above 48 KB, and clusters above the portable 8 blocks.
cudaError_t prepare_backward_q(BackwardQ kernel, int d) {
  cudaError_t err = allow_smem(kernel, bwdq::smem_bytes(d));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The launch of `splits` clusters of `cluster` blocks per query tile.
cudaLaunchConfig_t backward_q_config(int B, int d, int cluster, int splits, cudaStream_t stream,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + bwdq::kQueries - 1) / bwdq::kQueries) * splits * cluster);
  cfg.blockDim = dim3(bwdq::kThreads);
  cfg.dynamicSmemBytes = bwdq::smem_bytes(d);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kTrue>
cudaError_t launch_backward_q(const float* q, const float* x, const float* bias, const float* cq,
                              const int* target, Scalars sc, const float* lse, const float* g,
                              float* dq_part, float* rows_part, float* scal_part, float* dq,
                              float* dc, float* dscale, float* dmargin, int* counters, int B,
                              int N, int d, int cluster, int splits, cudaStream_t stream) {
  const BackwardQ kernel = backward_q_kernel<kTrue>(d);
  cudaError_t err = prepare_backward_q(kernel, d);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = backward_q_config(B, d, cluster, splits, stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, q, x, bias, cq, target, sc, lse, g, dq_part, rows_part,
                            scal_part, dq, dc, dscale, dmargin, counters, B, N, d, splits);
}

template <bool kTrue>
cudaError_t backward_q_occupancy(int d, int cluster, int* blocks_per_sm, int* active_clusters) {
  const BackwardQ kernel = backward_q_kernel<kTrue>(d);
  cudaError_t err = prepare_backward_q(kernel, d);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, bwdq::kThreads,
                                                        bwdq::smem_bytes(d));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = backward_q_config(bwdq::kQueries, d, cluster, 1, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(active_clusters, kernel, &cfg);
  if (err == cudaErrorInvalidClusterSize) {  // no cluster of this size fits the card
    cudaGetLastError();
    *active_clusters = 0;
    err = cudaSuccess;
  }
  return err;
}

}  // namespace

extern "C" {

// Each function launches one kernel on `stream` and returns cudaGetLastError()
// (0 = launched). true_dist selects the distance; d <= 512 is a multiple of
// 4 and q and x are 16-byte aligned (else cudaErrorInvalidValue). `counters` are
// int32 zeros that each launch leaves at zero again: q_tiles of them for the
// forward, q_tiles + 1 for backward_q; launches sharing counters must not run
// concurrently. The forward launches `splits` blocks per tile of 128
// queries, which cut the 16-row candidate tiles evenly (a split past the
// last tile is empty), with partials of (max, sum-exp, target logit)
// [3, splits, B], and writes nll [B] and lse [B]. backward_q launches `splits` clusters of `cluster` (1 to 16)
// blocks per 64 queries, with partials of dq [splits, B, d], of dqq and dc
// [2, splits, B] and of dscale / dmargin [q_tiles * splits, 2]; backward_x uses
// no counters: it launches clusters of `splits` (1 to 8) blocks, one cluster
// per 64 candidates.

int streaming_ce_forward(const float* q, const float* x, const float* bias, const float* cq,
                         const int* target, const float* scale, const float* margin, float* part,
                         float* nll, float* lse, int* counters, int B, int N, int d, int splits,
                         int true_dist, cudaStream_t stream) {
  if (!in_library(d) || !float4_rows(q, x, d) || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Forward kernel = true_dist ? forward_kernel<true>(d) : forward_kernel<false>(d);
  const size_t smem = fwd::smem_bytes(d);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((B + fwd::kQueries - 1) / fwd::kQueries, splits);
    cfg.blockDim = dim3(fwd::kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    err = cudaLaunchKernelEx(&cfg, kernel, q, x, bias, cq, target, Scalars{scale, margin}, part,
                             nll, lse, counters, B, N, d);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int streaming_ce_backward_q(const float* q, const float* x, const float* bias, const float* cq,
                            const int* target, const float* scale, const float* margin,
                            const float* lse, const float* g, float* dq_part, float* rows_part,
                            float* scal_part, float* dq, float* dc, float* dscale, float* dmargin,
                            int* counters, int B, int N, int d, int cluster, int splits,
                            int true_dist, cudaStream_t stream) {
  if (!in_library(d) || !float4_rows(q, x, d) || cluster < 1 || cluster > bwdq::kMaxCluster ||
      splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars sc{scale, margin};
  const cudaError_t err =
      true_dist ? launch_backward_q<true>(q, x, bias, cq, target, sc, lse, g, dq_part, rows_part,
                                          scal_part, dq, dc, dscale, dmargin, counters, B, N, d,
                                          cluster, splits, stream)
                : launch_backward_q<false>(q, x, bias, cq, target, sc, lse, g, dq_part, rows_part,
                                           scal_part, dq, dc, dscale, dmargin, counters, B, N, d,
                                           cluster, splits, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int streaming_ce_backward_x(const float* q, const float* x, const float* bias, const float* cq,
                            const int* target, const float* scale, const float* margin,
                            const float* lse, const float* g, float* dx, float* dbias, int B, int N,
                            int d, int splits, int true_dist, cudaStream_t stream) {
  if (!in_library(d) || !float4_rows(q, x, d) || splits < 1 || splits > bwdx::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars sc{scale, margin};
  const cudaError_t err =
      true_dist ? launch_backward_x<true>(q, x, bias, cq, target, sc, lse, g, dx, dbias, B, N, d,
                                          splits, stream)
                : launch_backward_x<false>(q, x, bias, cq, target, sc, lse, g, dx, dbias, B, N, d,
                                           splits, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The forward's queries per block, the blocks of it that fit on one SM at
// width d, and the card's SMs.
int streaming_ce_forward_occupancy(int d, int true_dist, int* queries, int* blocks_per_sm,
                                   int* sms) {
  if (!in_library(d)) return static_cast<int>(cudaErrorInvalidValue);
  const Forward kernel = true_dist ? forward_kernel<true>(d) : forward_kernel<false>(d);
  *queries = fwd::kQueries;
  const size_t smem = fwd::smem_bytes(d);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, fwd::kThreads, smem);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}

// Blocks of the candidate-side backward that fit on one SM, and clusters of
// `splits` blocks that can be resident at once, at width d.
int streaming_ce_backward_x_occupancy(int d, int splits, int true_dist, int* blocks_per_sm,
                                      int* active_clusters) {
  if (!in_library(d) || splits < 1 || splits > bwdx::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(true_dist
                              ? backward_x_occupancy<true>(d, splits, blocks_per_sm,
                                                           active_clusters)
                              : backward_x_occupancy<false>(d, splits, blocks_per_sm,
                                                            active_clusters));
}

// Blocks of the query-side backward that fit on one SM, and clusters of
// `cluster` blocks (1 to 16) that can be resident at once (0 if none fits), at
// width d.
int streaming_ce_backward_q_occupancy(int d, int cluster, int true_dist, int* blocks_per_sm,
                                      int* active_clusters) {
  if (!in_library(d) || cluster < 1 || cluster > bwdq::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(true_dist
                              ? backward_q_occupancy<true>(d, cluster, blocks_per_sm,
                                                           active_clusters)
                              : backward_q_occupancy<false>(d, cluster, blocks_per_sm,
                                                            active_clusters));
}

const char* streaming_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
