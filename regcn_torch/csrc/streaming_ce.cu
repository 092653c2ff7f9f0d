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
//   ce_backward_x_kernel  grid (candidate tile, query split). Walks its
//                       split's query tiles: dx = sum_i dp q_i + 2 x sum_i dxx,
//                       dbias = sum_i dlogit; the last block of a candidate
//                       tile sums the splits in split order.
//
// Splits are sized to fill the SMs in one wave (two forward blocks, or one
// backward block, fit on an SM). Every sum is taken in a fixed order: the
// counters only decide which block does the combining, so results are the
// same from run to run. Candidates
// >= N and queries >= B are masked in the kernel (no -1e30 padding): they add
// exactly 0 to every sum and get no gradient. The clamps (max(num_sq, 0), the
// max_norm minimum, max(diff_sq, eps^2), min(z, 1 - eps)) pass no gradient
// where they bind, as JAX's VJP does away from ties.
//
// What bounds it on an H100: operations. At the hyperbolic config-3 entity
// loss (B = 512 padded queries, N = 7128 entities, d = 200) the forward is
// 2 B N d = 1.46 GFLOP of q.x products plus ~30 flops per logit, ~23 us at
// the 67 TFLOP/s fp32 rate, while its inputs are 6.1 MB (1.8 us of HBM). Each
// backward kernel recomputes p and does one more product of the same size.
// All products are fp32 FMAs (no TF32: the port is held to fp32 parity).
// Design: 64 x 64 tiles, 256 threads each owning a 4 x 4 block of logits
// (rows ty + 16 i, columns tx + 16 j, so shared-memory reads are
// conflict-free); both operand tiles sit whole in shared memory (rows padded
// to an odd number of float4s) and the products read them as float4, so a
// thread does 64 FMAs per 8 shared loads. The candidate axis (or, for
// dx, the query axis) is split across blocks so that the SMs are full even
// with only B/64 = 8 query tiles. d <= 256, a multiple of 4, and q and x
// 16-byte aligned (every load is a float4).

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

template <bool kTrue>
__global__ void __launch_bounds__(kThreads, 1)
    ce_backward_x_kernel(const float* __restrict__ q, const float* __restrict__ x,
                         const float* __restrict__ bias, const float* __restrict__ cq,
                         const int* __restrict__ target, Scalars sc,
                         const float* __restrict__ lse, const float* __restrict__ g,
                         float* __restrict__ dx_part, float* __restrict__ cols_part,
                         float* __restrict__ dx, float* __restrict__ dbias,
                         int* __restrict__ counters, int B, int N, int d,
                         int tiles_per_split) {
  extern __shared__ float4 smem[];
  __shared__ float qq_s[kTile], xx_s[kTile], red[2][16][kTile];
  __shared__ int flag;
  const Shape sh = make_shape(d);
  float4* Xs = smem;
  float4* Qs = smem + kTile * sh.ld4;
  float* Gs = reinterpret_cast<float*>(smem + 2 * kTile * sh.ld4);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col0 = blockIdx.x * kTile;
  const float scale = __ldg(sc.scale), margin = __ldg(sc.margin);

  load_tile(Xs, x, col0, N, sh);
  __syncthreads();
  row_sq_norms(Xs, sh, xx_s);
  __syncthreads();
  float xx[4], b[4], sum_xx[4], sum_g[4];
  bool col_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tx + 16 * j;
    col_ok[j] = col < N;
    xx[j] = xx_s[tx + 16 * j];
    b[j] = col_ok[j] ? __ldg(bias + col) : 0.f;
    sum_xx[j] = 0.f;
    sum_g[j] = 0.f;
  }
  float4 acc[4][kColsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_tiles = (B + kTile - 1) / kTile;
  const int qt_end = min((blockIdx.y + 1) * tiles_per_split, q_tiles);
  for (int qt = blockIdx.y * tiles_per_split; qt < qt_end; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();
    load_tile(Qs, q, row0, B, sh);
    __syncthreads();
    row_sq_norms(Qs, sh, qq_s);
    __syncthreads();
    float p[4][4];
    tile_dot(Qs, Xs, sh, ty, tx, p);  // p[i][j]: query ty + 16 i, candidate tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      const bool row_ok = row < B;
      const float qq = qq_s[ty + 16 * i];
      const float c = row_ok ? __ldg(cq + row) : 1.f;
      const int tgt = row_ok ? __ldg(target + row) : -1;
      const float l = row_ok ? __ldg(lse + row) : 0.f;
      const float gr = row_ok ? __ldg(g + row) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float gp = 0.f;
        if (row_ok && col_ok[j]) {
          const int col = col0 + tx + 16 * j;
          const Elem e = eval_logit<kTrue>(p[i][j], qq, xx[j], c, scale, margin, b[j]);
          const float dlogit = gr * (expf(e.logit - l) - (col == tgt ? 1.f : 0.f));
          const Grad gd = grad_logit<kTrue>(e, dlogit, p[i][j], qq, xx[j], c, scale);
          gp = gd.p;
          sum_xx[j] += gd.xx;
          sum_g[j] += dlogit;
        }
        Gs[(ty + 16 * i) * kGsLd + tx + 16 * j] = gp;
      }
    }
    __syncthreads();
    // acc[candidate ty + 16 i][cols] += sum_r dp[r][candidate] * q[r][cols]
    for (int r = 0; r < kTile; ++r) {
      float gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = Gs[r * kGsLd + ty + 16 * i];
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        if (tx + 16 * k >= sh.d4) break;
        const float4 qv = Qs[r * sh.ld4 + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][k].x = fmaf(gv[i], qv.x, acc[i][k].x);
          acc[i][k].y = fmaf(gv[i], qv.y, acc[i][k].y);
          acc[i][k].z = fmaf(gv[i], qv.z, acc[i][k].z);
          acc[i][k].w = fmaf(gv[i], qv.w, acc[i][k].w);
        }
      }
    }
  }

  // per-candidate totals over the 16 thread rows, in ty order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = sum_xx[j];
    red[1][ty][tx + 16 * j] = sum_g[j];
  }
  __syncthreads();
  float* gsum = qq_s;  // reuse: per-candidate dbias of this block
  if (threadIdx.x < kTile) {
    float txx = 0.f, tg = 0.f;
    for (int r = 0; r < 16; ++r) {
      txx += red[0][r][threadIdx.x];
      tg += red[1][r][threadIdx.x];
    }
    xx_s[threadIdx.x] = txx;
    gsum[threadIdx.x] = tg;
  }
  __syncthreads();
  const int splits = gridDim.y;

  // publish this split's partials; the last block of the tile sums them
  const size_t slice = static_cast<size_t>(blockIdx.y) * N;
  if (threadIdx.x < kTile && col0 + threadIdx.x < N) {
    cols_part[slice + col0 + threadIdx.x] = xx_s[threadIdx.x];
    cols_part[static_cast<size_t>(splits) * N + slice + col0 + threadIdx.x] = gsum[threadIdx.x];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cand = ty + 16 * i;
    if (col0 + cand >= N) continue;
    float4* dst = reinterpret_cast<float4*>(dx_part + (slice + col0 + cand) * d);
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      if (tx + 16 * k >= sh.d4) break;
      dst[tx + 16 * k] = acc[i][k];
    }
  }
  if (!last_to_finish(counters + blockIdx.x, splits, &flag)) return;
  if (threadIdx.x < kTile && col0 + threadIdx.x < N) {
    const int col = col0 + threadIdx.x;
    xx_s[threadIdx.x] = split_sum(cols_part, N, splits, col);
    dbias[col] = split_sum(cols_part + static_cast<size_t>(splits) * N, N, splits, col);
  }
  __syncthreads();
  const int cands = min(kTile, N - col0);
  for (int e = threadIdx.x; e < cands * d; e += kThreads) {
    const int r = e / d;
    const size_t at = static_cast<size_t>(col0 + r) * d + (e - r * d);
    dx[at] = fmaf(2.f * xx_s[r], __ldg(x + at),
                  split_sum(dx_part, static_cast<size_t>(N) * d, splits, at));
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
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

}  // namespace

extern "C" {

// Each function launches one kernel on `stream` and returns cudaGetLastError()
// (0 = launched). true_dist selects the distance; d <= 256 is a multiple of
// 4 and q and x are 16-byte aligned (else cudaErrorInvalidValue). `counters` are
// int32 zeros that each launch leaves at zero again: q_tiles of them for the
// forward, q_tiles + 1 for backward_q; launches sharing counters must not run
// concurrently.

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
                            const float* lse, const float* g, float* dx_part, float* cols_part,
                            float* dx, float* dbias, int* counters, int B, int N, int d,
                            int splits, int tiles_per_split, int true_dist, cudaStream_t stream) {
  if (!float4_rows(q, x, d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem_bytes(d, kTile * kGsLd);
  const dim3 grid((N + kTile - 1) / kTile, splits);
  const Scalars sc{scale, margin};
  cudaError_t err;
  if (true_dist) {
    err = allow_smem(ce_backward_x_kernel<true>, smem);
    if (err == cudaSuccess)
      ce_backward_x_kernel<true><<<grid, kThreads, smem, stream>>>(
          q, x, bias, cq, target, sc, lse, g, dx_part, cols_part, dx, dbias, counters, B, N, d,
          tiles_per_split);
  } else {
    err = allow_smem(ce_backward_x_kernel<false>, smem);
    if (err == cudaSuccess)
      ce_backward_x_kernel<false><<<grid, kThreads, smem, stream>>>(
          q, x, bias, cq, target, sc, lse, g, dx_part, cols_part, dx, dbias, counters, B, N, d,
          tiles_per_split);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

const char* streaming_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
