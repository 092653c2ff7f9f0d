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
//   ce_forward_kernel   grid (query tile, candidate split). Each block folds
//                       its split's tiles into per-row partial (max, sum-exp,
//                       target logit); the last block of a query tile to
//                       finish (a counter, atomically incremented) combines
//                       the splits in split order into nll and lse.
//   ce_backward_q_kernel  grid (query tile, candidate split). Recomputes the
//                       logits and dlogit = g (softmax - onehot), then
//                       dq = sum_j dp x_j + 2 q sum_j dqq, dc, and partials of
//                       dscale / dmargin; the last block of a query tile sums
//                       the splits' dq and dc in split order, and the last
//                       block of the grid sums dscale / dmargin.
//   ce_backward_x_kernel  one thread-block cluster per 64 candidates; its
//                       blocks split the query tiles. Each walks its 32-row
//                       query tiles: dx = sum_i dp q_i + 2 x sum_i dxx,
//                       dbias = sum_i dlogit; the cluster sums its blocks'
//                       partials in rank order through distributed shared
//                       memory and writes dx once.
//
// Every sum is taken in a fixed order: the forward's and backward_q's
// counters only decide which block does the combining, and backward_x's
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
// Forward and backward_q: 64 x 64 tiles, 256 threads each owning a 4 x 4
// block of logits (rows ty + 16 i, columns tx + 16 j, so shared-memory reads
// are conflict-free); both operand tiles sit whole in shared memory (rows
// padded to an odd number of float4s) and the products read them as float4.
// The candidate axis is split across blocks (two forward blocks, or one
// backward block, fit on an SM; the last block of a query tile merges the
// splits) so that the SMs are full even with only B/64 = 8 query tiles.
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
//   clamp caps the distance, uses the fast division and exponential.
// d <= 256, a multiple of 4, and q and x 16-byte aligned (every load is a
// float4).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxD4 = 64;           // d <= 256
constexpr int kColsPerThread = kMaxD4 / 16;
constexpr int kGsLd = kTile + 1;     // dlogit/dp tile row stride
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Shape {
  int d4, ld4;  // float4s per row, float4 row stride in shared memory (odd)
};

__host__ __device__ __forceinline__ Shape make_shape(int d) {
  const int d4 = d / 4;
  return Shape{d4, d4 | 1};
}

// rows [row0, row0 + kTile) of a row-major [nrows, d] matrix into shared
// memory, zero-filled past nrows.
__device__ __forceinline__ void load_tile(float4* __restrict__ s, const float* __restrict__ g,
                                          int row0, int nrows, Shape sh) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < kTile * sh.d4; i += kThreads) {
    const int r = i / sh.d4, k = i - r * sh.d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) v = __ldg(g4 + static_cast<size_t>(row0 + r) * sh.d4 + k);
    s[r * sh.ld4 + k] = v;
  }
}

// out[r] = |row r|^2 for the kTile rows of a shared tile; one warp per row.
__device__ __forceinline__ void row_sq_norms(const float4* __restrict__ s, Shape sh,
                                             float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* sf = reinterpret_cast<const float*>(s);
  const int width = 4 * sh.d4, ld = 4 * sh.ld4;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float acc = 0.f;
    for (int k = lane; k < width; k += 32) acc = fmaf(sf[r * ld + k], sf[r * ld + k], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[r] = acc;
  }
}

// acc[i][j] = A row (ty + 16 i) . Bm row (tx + 16 j), both tiles in shared memory.
__device__ __forceinline__ void tile_dot(const float4* __restrict__ As, const float4* __restrict__ Bs,
                                         Shape sh, int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < sh.d4; ++k) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * sh.ld4 + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * sh.ld4 + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        acc[i][j] = t;
      }
  }
}

// One logit and the intermediates its gradient needs.
struct Elem {
  float A, Bc, D, num_sq, diff_sq, block, logit;
  float sqrt_c, dn0, mn, dn, z;  // true distance
  float mx;                      // proxy
};

template <bool kTrue>
__device__ __forceinline__ Elem eval_logit(float p, float qq, float xx, float c, float scale,
                                           float margin, float bias) {
  Elem e;
  e.A = 1.f - 2.f * c * p + c * xx;
  e.Bc = 1.f - c * qq;
  e.D = 1.f - 2.f * c * p + (c * c) * qq * xx + kEps;
  e.num_sq = e.A * e.A * qq - 2.f * e.A * e.Bc * p + e.Bc * e.Bc * xx;
  e.diff_sq = fmaxf(e.num_sq, 0.f) / (e.D * e.D);
  float dist;
  if (kTrue) {
    e.sqrt_c = sqrtf(c + kEps);
    e.dn0 = sqrtf(fmaxf(e.diff_sq, kEps * kEps));
    e.mn = 1.f / (e.sqrt_c + kEps) - kEps;
    e.dn = fminf(e.dn0, e.mn);
    e.z = fminf(e.sqrt_c * e.dn, 1.f - kEps);
    dist = (2.f / (e.sqrt_c + kEps)) * atanhf(e.z);
  } else {
    e.mx = 1.f / sqrtf(c) - 2.f * kEps;
    dist = fminf(e.diff_sq, e.mx * e.mx);
  }
  e.block = margin - dist;
  e.logit = scale * e.block + bias;
  return e;
}

struct Grad {
  float p, qq, xx, c;
};

// Chain rule from dlogit back to p, qq, xx and c.
template <bool kTrue>
__device__ __forceinline__ Grad grad_logit(const Elem& e, float dlogit, float p, float qq,
                                           float xx, float c, float scale) {
  const float ddist = -scale * dlogit;
  float ddiff = 0.f, dc = 0.f;
  if (kTrue) {
    const float s1 = e.sqrt_c + kEps;
    const float inv_s1_sq = 1.f / (s1 * s1);
    float ds1 = ddist * atanhf(e.z) * (-2.f * inv_s1_sq);
    const float dz = (e.sqrt_c * e.dn < 1.f - kEps) ? ddist * (2.f / s1) / (1.f - e.z * e.z) : 0.f;
    float dsqrt_c = dz * e.dn;
    const float ddn = dz * e.sqrt_c;
    float ddn0 = 0.f;
    if (e.dn0 < e.mn) {
      ddn0 = ddn;
    } else {
      ds1 -= ddn * inv_s1_sq;
    }
    dsqrt_c += ds1;
    dc += dsqrt_c * 0.5f / e.sqrt_c;
    if (e.diff_sq > kEps * kEps) ddiff = ddn0 * 0.5f / e.dn0;
  } else if (e.diff_sq < e.mx * e.mx) {
    ddiff = ddist;
  } else {
    dc += ddist * 2.f * e.mx * (-0.5f / (c * sqrtf(c)));
  }
  const float inv_d = 1.f / e.D;
  const float inv_d2 = inv_d * inv_d;
  const float dnum = e.num_sq > 0.f ? ddiff * inv_d2 : 0.f;
  const float dD = -2.f * ddiff * fmaxf(e.num_sq, 0.f) * inv_d2 * inv_d;
  const float dA = dnum * (2.f * e.A * qq - 2.f * e.Bc * p);
  const float dB = dnum * (2.f * e.Bc * xx - 2.f * e.A * p);
  Grad g;
  g.p = -2.f * e.A * e.Bc * dnum - 2.f * c * dA - 2.f * c * dD;
  g.qq = e.A * e.A * dnum - c * dB + c * c * xx * dD;
  g.xx = e.Bc * e.Bc * dnum + c * dA + c * c * qq * dD;
  g.c = dc + (xx - 2.f * p) * dA - qq * dB + (2.f * c * qq * xx - 2.f * p) * dD;
  return g;
}

// (m, s) <- (m, s) (+) (m2, s2) for running (max, sum of exp(. - max)).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == neg_inf()) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Sum over the 16 lanes that share ty (lanes 0-15 and 16-31 of a warp).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// sum_k part[k * stride + at] over k < splits, in a fixed order, with eight
// loads in flight (the split partials are read back from L2 by one block).
__device__ __forceinline__ float split_sum(const float* __restrict__ part, size_t stride,
                                           int splits, size_t at) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int k = 0;
  for (; k + 8 <= splits; k += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] += __ldcg(part + static_cast<size_t>(k + u) * stride + at);
  }
  for (; k < splits; ++k) s[0] += __ldcg(part + static_cast<size_t>(k) * stride + at);
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

struct Scalars {
  const float* scale;
  const float* margin;
};

// ---------------------------------------------------------------- forward

template <bool kTrue>
__global__ void __launch_bounds__(kThreads, 2)
    ce_forward_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      const float* __restrict__ bias, const float* __restrict__ cq,
                      const int* __restrict__ target, Scalars sc, float* __restrict__ part,
                      float* __restrict__ nll, float* __restrict__ lse, int* __restrict__ counters,
                      int B, int N, int d, int tiles_per_split) {
  extern __shared__ float4 smem[];
  __shared__ float qq_s[kTile], xx_s[kTile];
  __shared__ int flag;
  const Shape sh = make_shape(d);
  float4* Qs = smem;
  float4* Xs = smem + kTile * sh.ld4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kTile, split = blockIdx.y, splits = gridDim.y;
  const float scale = __ldg(sc.scale), margin = __ldg(sc.margin);

  load_tile(Qs, q, row0, B, sh);
  __syncthreads();
  row_sq_norms(Qs, sh, qq_s);
  __syncthreads();
  float qq[4], c[4], m[4], s[4], t[4];
  int tgt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    qq[i] = qq_s[ty + 16 * i];
    c[i] = row < B ? __ldg(cq + row) : 1.f;
    tgt[i] = row < B ? __ldg(target + row) : -1;
    m[i] = neg_inf();
    s[i] = 0.f;
    t[i] = 0.f;
  }

  const int n_tiles = (N + kTile - 1) / kTile;
  const int tile_end = min((split + 1) * tiles_per_split, n_tiles);
  for (int tile = split * tiles_per_split; tile < tile_end; ++tile) {
    const int col0 = tile * kTile;
    __syncthreads();  // the previous tile's Xs and xx_s are no longer read
    load_tile(Xs, x, col0, N, sh);
    __syncthreads();
    row_sq_norms(Xs, sh, xx_s);
    __syncthreads();
    float p[4][4];
    tile_dot(Qs, Xs, sh, ty, tx, p);
    float logit[4][4];
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      valid[j] = col < N;
      const float xx = xx_s[tx + 16 * j];
      const float b = valid[j] ? __ldg(bias + col) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        logit[i][j] = eval_logit<kTrue>(p[i][j], qq[i], xx, c[i], scale, margin, b).logit;
        if (valid[j] && col == tgt[i]) t[i] += logit[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid[j]) tile_max = fmaxf(tile_max, logit[i][j]);
      if (tile_max == neg_inf()) continue;  // no candidate of this thread in the tile
      const float mx = fmaxf(m[i], tile_max);
      float acc = s[i] * expf(m[i] - mx);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid[j]) acc += expf(logit[i][j] - mx);
      s[i] = acc;
      m[i] = mx;
    }
  }

  // combine the 16 threads of each row, then publish the split's partial
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], o);
      t[i] += __shfl_xor_sync(0xffffffffu, t[i], o);
      lse_merge(m[i], s[i], m2, s2);
    }
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < B) {
      const size_t at = static_cast<size_t>(split) * B + row;
      part[at] = m[i];
      part[static_cast<size_t>(splits) * B + at] = s[i];
      part[2 * static_cast<size_t>(splits) * B + at] = t[i];
    }
  }

  if (!last_to_finish(counters + blockIdx.x, splits, &flag)) return;
  // the last block of this query tile: the splits in order, one thread a row
  if (threadIdx.x < kTile && row0 + threadIdx.x < B) {
    const int row = row0 + threadIdx.x;
    float M = neg_inf(), S = 0.f, T = 0.f;
    for (int k = 0; k < splits; ++k) {
      const size_t at = static_cast<size_t>(k) * B + row;
      lse_merge(M, S, __ldcg(part + at), __ldcg(part + static_cast<size_t>(splits) * B + at));
      T += __ldcg(part + 2 * static_cast<size_t>(splits) * B + at);
    }
    const float l = M + logf(fmaxf(S, 1e-30f));
    lse[row] = l;
    nll[row] = l - T;
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

// -------------------------------------------------------- backward: queries

template <bool kTrue>
__global__ void __launch_bounds__(kThreads, 1)
    ce_backward_q_kernel(const float* __restrict__ q, const float* __restrict__ x,
                         const float* __restrict__ bias, const float* __restrict__ cq,
                         const int* __restrict__ target, Scalars sc,
                         const float* __restrict__ lse, const float* __restrict__ g,
                         float* __restrict__ dq_part, float* __restrict__ rows_part,
                         float* __restrict__ scal_part, float* __restrict__ dq,
                         float* __restrict__ dc, float* __restrict__ dscale,
                         float* __restrict__ dmargin, int* __restrict__ counters, int B, int N,
                         int d, int tiles_per_split) {
  extern __shared__ float4 smem[];
  __shared__ float qq_s[kTile], xx_s[kTile], red[2][kThreads / 32];
  __shared__ int flag_tile, flag_all;
  const Shape sh = make_shape(d);
  float4* Qs = smem;
  float4* Xs = smem + kTile * sh.ld4;
  float* Gs = reinterpret_cast<float*>(smem + 2 * kTile * sh.ld4);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kTile, split = blockIdx.y, splits = gridDim.y;
  const float scale = __ldg(sc.scale), margin = __ldg(sc.margin);

  load_tile(Qs, q, row0, B, sh);
  __syncthreads();
  row_sq_norms(Qs, sh, qq_s);
  __syncthreads();
  float qq[4], c[4], l[4], gr[4], sum_qq[4], sum_c[4];
  int tgt[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    row_ok[i] = row < B;
    qq[i] = qq_s[ty + 16 * i];
    c[i] = row_ok[i] ? __ldg(cq + row) : 1.f;
    tgt[i] = row_ok[i] ? __ldg(target + row) : -1;
    l[i] = row_ok[i] ? __ldg(lse + row) : 0.f;
    gr[i] = row_ok[i] ? __ldg(g + row) : 0.f;
    sum_qq[i] = 0.f;
    sum_c[i] = 0.f;
  }
  float sum_gblock = 0.f, sum_dblock = 0.f;
  float4 acc[4][kColsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int n_tiles = (N + kTile - 1) / kTile;
  const int tile_end = min((split + 1) * tiles_per_split, n_tiles);
  for (int tile = split * tiles_per_split; tile < tile_end; ++tile) {
    const int col0 = tile * kTile;
    __syncthreads();
    load_tile(Xs, x, col0, N, sh);
    __syncthreads();
    row_sq_norms(Xs, sh, xx_s);
    __syncthreads();
    float p[4][4];
    tile_dot(Qs, Xs, sh, ty, tx, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      const bool col_ok = col < N;
      const float xx = xx_s[tx + 16 * j];
      const float b = col_ok ? __ldg(bias + col) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float gp = 0.f;
        if (col_ok && row_ok[i]) {
          const Elem e = eval_logit<kTrue>(p[i][j], qq[i], xx, c[i], scale, margin, b);
          const float dlogit = gr[i] * (expf(e.logit - l[i]) - (col == tgt[i] ? 1.f : 0.f));
          const Grad gd = grad_logit<kTrue>(e, dlogit, p[i][j], qq[i], xx, c[i], scale);
          gp = gd.p;
          sum_qq[i] += gd.qq;
          sum_c[i] += gd.c;
          sum_gblock += dlogit * e.block;
          sum_dblock += scale * dlogit;
        }
        Gs[(ty + 16 * i) * kGsLd + tx + 16 * j] = gp;
      }
    }
    __syncthreads();
    // acc[row][cols] += sum_j dp[row][j] * x[j][cols]
    for (int jj = 0; jj < kTile; ++jj) {
      float gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = Gs[(ty + 16 * i) * kGsLd + jj];
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        if (tx + 16 * k >= sh.d4) break;
        const float4 xv = Xs[jj * sh.ld4 + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][k].x = fmaf(gv[i], xv.x, acc[i][k].x);
          acc[i][k].y = fmaf(gv[i], xv.y, acc[i][k].y);
          acc[i][k].z = fmaf(gv[i], xv.z, acc[i][k].z);
          acc[i][k].w = fmaf(gv[i], xv.w, acc[i][k].w);
        }
      }
    }
  }

  // publish this split's partials: dq rows, per-row sums, block scalars
  const size_t split_rows = static_cast<size_t>(split) * B;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    const float rq = sum16(sum_qq[i]);
    const float rc = sum16(sum_c[i]);
    if (!row_ok[i]) continue;
    if (tx == 0) {
      rows_part[split_rows + row] = rq;
      rows_part[static_cast<size_t>(gridDim.y) * B + split_rows + row] = rc;
    }
    float4* dst = reinterpret_cast<float4*>(dq_part + (split_rows + row) * d);
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      if (tx + 16 * k >= sh.d4) break;
      dst[tx + 16 * k] = acc[i][k];
    }
  }
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float a = sum_gblock, b = sum_dblock;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float ta = 0.f, tb = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        ta += red[0][w];
        tb += red[1][w];
      }
      const size_t blk = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
      scal_part[2 * blk] = ta;
      scal_part[2 * blk + 1] = tb;
    }
  }

  const int n_blocks = gridDim.x * gridDim.y;
  const bool last_tile = last_to_finish(counters + blockIdx.x, splits, &flag_tile);
  if (last_tile) {
    // dq = sum over splits of the partials + 2 q * sum over splits of dqq
    float* qsum = qq_s;  // reuse: per-row totals of dqq for this tile
    if (threadIdx.x < kTile && row0 + threadIdx.x < B) {
      const int row = row0 + threadIdx.x;
      qsum[threadIdx.x] = split_sum(rows_part, B, splits, row);
      dc[row] = split_sum(rows_part + static_cast<size_t>(splits) * B, B, splits, row);
    }
    __syncthreads();
    const int rows = min(kTile, B - row0);
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      const int r = e / d, col = e - r * d;
      const size_t at = static_cast<size_t>(row0 + r) * d + col;
      dq[at] = fmaf(2.f * qsum[r], __ldg(q + at),
                    split_sum(dq_part, static_cast<size_t>(B) * d, splits, at));
    }
    if (threadIdx.x == 0) counters[blockIdx.x] = 0;
  }
  if (last_to_finish(counters + gridDim.x, n_blocks, &flag_all)) {
    if (threadIdx.x == 0) {
      float ta = 0.f, tb = 0.f;
      for (int b = 0; b < n_blocks; ++b) {
        ta += __ldcg(scal_part + 2 * b);
        tb += __ldcg(scal_part + 2 * b + 1);
      }
      *dscale = ta;
      *dmargin = tb;
      counters[gridDim.x] = 0;
    }
  }
}

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
// eval_logit / grad_logit, with the per-row values precomputed.
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
  float4 xr[2][kCol4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int cand = col0 + lane + 32 * c;
    float xxp = 0.f;
#pragma unroll
    for (int m = 0; m < kCol4; ++m) {
      const int k = warp + kWarps * m;
      xr[c][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cand < N && k < sh.d4) xr[c][m] = __ldg(x4 + static_cast<size_t>(cand) * sh.d4 + k);
      xxp = fmaf(xr[c][m].x, xr[c][m].x, xxp);
      xxp = fmaf(xr[c][m].y, xr[c][m].y, xxp);
      xxp = fmaf(xr[c][m].z, xr[c][m].z, xxp);
      xxp = fmaf(xr[c][m].w, xr[c][m].w, xxp);
    }
    red[warp * kCands + lane + 32 * c] = xxp;
  }
  __syncthreads();
  // the elementwise chain: candidate ec, rows er + 4 i
  const int ec = tid % kCands, er = tid / kCands;
  float xx = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) xx += red[w * kCands + ec];
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
        if (m == kCol4 - 1 && !last) break;
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
        if (m == kCol4 - 1 && !last) break;
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

size_t tile_smem_bytes(int d, int extra_floats) {
  return (2 * static_cast<size_t>(kTile) * make_shape(d).ld4) * sizeof(float4) +
         static_cast<size_t>(extra_floats) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rows of q and x load as float4s: d a multiple of 4, both 16-byte aligned.
bool float4_rows(const float* q, const float* x, int d) {
  return d % 4 == 0 && aligned16(q) && aligned16(x);
}

typedef void (*BackwardX)(const float*, const float*, const float*, const float*, const int*,
                          Scalars, const float*, const float*, float*, float*, int, int, int);

// The instance of the candidate-side backward for width d (<= 256).
template <bool kTrue>
BackwardX backward_x_kernel(int d) {
  switch ((d / 4 + bwdx::kWarps - 1) / bwdx::kWarps) {
    case 1: return ce_backward_x_kernel<kTrue, 1>;
    case 2: return ce_backward_x_kernel<kTrue, 2>;
    case 3: return ce_backward_x_kernel<kTrue, 3>;
    case 4: return ce_backward_x_kernel<kTrue, 4>;
    case 5: return ce_backward_x_kernel<kTrue, 5>;
    case 6: return ce_backward_x_kernel<kTrue, 6>;
    case 7: return ce_backward_x_kernel<kTrue, 7>;
    default: return ce_backward_x_kernel<kTrue, 8>;
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

}  // namespace

extern "C" {

// Each function launches one kernel on `stream` and returns cudaGetLastError()
// (0 = launched). true_dist selects the distance; d <= 256 is a multiple of
// 4 and q and x are 16-byte aligned (else cudaErrorInvalidValue). `counters` are
// int32 zeros that each launch leaves at zero again: q_tiles of them for the
// forward, q_tiles + 1 for backward_q; launches sharing counters must not run
// concurrently. backward_x uses no counters: it launches clusters of `splits`
// (1 to 8) blocks, one cluster per 64 candidates.

int streaming_ce_forward(const float* q, const float* x, const float* bias, const float* cq,
                         const int* target, const float* scale, const float* margin, float* part,
                         float* nll, float* lse, int* counters, int B, int N, int d, int splits,
                         int tiles_per_split, int true_dist, cudaStream_t stream) {
  if (!float4_rows(q, x, d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem_bytes(d, 0);
  const dim3 grid((B + kTile - 1) / kTile, splits);
  const Scalars sc{scale, margin};
  cudaError_t err;
  if (true_dist) {
    err = allow_smem(ce_forward_kernel<true>, smem);
    if (err == cudaSuccess)
      ce_forward_kernel<true><<<grid, kThreads, smem, stream>>>(
          q, x, bias, cq, target, sc, part, nll, lse, counters, B, N, d, tiles_per_split);
  } else {
    err = allow_smem(ce_forward_kernel<false>, smem);
    if (err == cudaSuccess)
      ce_forward_kernel<false><<<grid, kThreads, smem, stream>>>(
          q, x, bias, cq, target, sc, part, nll, lse, counters, B, N, d, tiles_per_split);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int streaming_ce_backward_q(const float* q, const float* x, const float* bias, const float* cq,
                            const int* target, const float* scale, const float* margin,
                            const float* lse, const float* g, float* dq_part, float* rows_part,
                            float* scal_part, float* dq, float* dc, float* dscale, float* dmargin,
                            int* counters, int B, int N, int d, int splits, int tiles_per_split,
                            int true_dist, cudaStream_t stream) {
  if (!float4_rows(q, x, d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem_bytes(d, kTile * kGsLd);
  const dim3 grid((B + kTile - 1) / kTile, splits);
  const Scalars sc{scale, margin};
  cudaError_t err;
  if (true_dist) {
    err = allow_smem(ce_backward_q_kernel<true>, smem);
    if (err == cudaSuccess)
      ce_backward_q_kernel<true><<<grid, kThreads, smem, stream>>>(
          q, x, bias, cq, target, sc, lse, g, dq_part, rows_part, scal_part, dq, dc, dscale,
          dmargin, counters, B, N, d, tiles_per_split);
  } else {
    err = allow_smem(ce_backward_q_kernel<false>, smem);
    if (err == cudaSuccess)
      ce_backward_q_kernel<false><<<grid, kThreads, smem, stream>>>(
          q, x, bias, cq, target, sc, lse, g, dq_part, rows_part, scal_part, dq, dc, dscale,
          dmargin, counters, B, N, d, tiles_per_split);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int streaming_ce_backward_x(const float* q, const float* x, const float* bias, const float* cq,
                            const int* target, const float* scale, const float* margin,
                            const float* lse, const float* g, float* dx, float* dbias, int B, int N,
                            int d, int splits, int true_dist, cudaStream_t stream) {
  if (!float4_rows(q, x, d) || splits < 1 || splits > bwdx::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars sc{scale, margin};
  const cudaError_t err =
      true_dist ? launch_backward_x<true>(q, x, bias, cq, target, sc, lse, g, dx, dbias, B, N, d,
                                          splits, stream)
                : launch_backward_x<false>(q, x, bias, cq, target, sc, lse, g, dx, dbias, B, N, d,
                                           splits, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of the candidate-side backward that fit on one SM, and clusters of
// `splits` blocks that can be resident at once, at width d.
int streaming_ce_backward_x_occupancy(int d, int splits, int true_dist, int* blocks_per_sm,
                                      int* active_clusters) {
  if (d < 4 || d > 4 * kMaxD4 || splits < 1 || splits > bwdx::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(true_dist
                              ? backward_x_occupancy<true>(d, splits, blocks_per_sm,
                                                           active_clusters)
                              : backward_x_occupancy<false>(d, splits, blocks_per_sm,
                                                            active_clusters));
}

const char* streaming_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
