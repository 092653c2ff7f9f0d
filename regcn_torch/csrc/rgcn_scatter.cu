// Destination-sorted edge scatter-add for the UnionRGCN aggregation.
//
//   out[v] = row_scale[v] * sum_{e : keys[e] == v} edge_weight[e] * msg[e, :]
//
// for v in [0, num_rows). keys are ascending; masked and padded edges carry
// key num_rows (or anything >= num_rows) and are never summed. A null
// edge_weight or row_scale means 1. Sums are taken in fp32 in a fixed order,
// with no float atomics, so the result is deterministic, and every output
// row is written exactly once, so the wrapper allocates it with torch.empty.
// Columns move as float4 when d % 4 == 0 and the pointers are 16-byte
// aligned, as scalars otherwise.
//
// Replaces the Pallas TPU kernel regcn_tpu/ops/pallas_rgcn.py:_scatter_kernel
// (driven by scatter_add_sorted / _scatter_fwd_impl). That kernel walks a
// (row tile x edge tile) grid in order and sums each edge tile into the row
// tile with a one-hot matmul on the MXU. None of that carries over.
//
// What bounds it on an H100: bytes. At the RE-GCN config-1 shape (N = 7128
// rows, d = 200, E = 640 edge slots, 492 real) it writes N*d*4 = 5.7 MB and
// reads ~0.4 MB of messages: 1.83 us of HBM traffic at 3.35 TB/s. In
// practice it is latency: one launch, a few dependent loads, then the
// output's writes.
//
// Why the work is cut by edges. The destinations are skewed: popular
// entities have low ids, so at config 1 the first 16-row tile holds 320 of
// the 492 edges (one row 126 of them). The previous version gave each block
// a 16-row tile, found its row bounds with 17 binary searches of ~10
// dependent loads, and summed its multi-edge rows one after another, each a
// block-wide pass: block 0 ran ~18 us while the other 445 blocks were long
// done (8 us with the same number of edges on distinct rows). Here one
// launch has two kinds of block, chosen by blockIdx:
//   1. edge chunks (blockIdx < num_chunks, scheduled first): chunk c owns the
//      kChunk consecutive edge slots [c*kChunk, (c+1)*kChunk) and writes every
//      row that has an edge there. Warp 0 asks for the chunk's keys; then
//      every (slot, column) thread asks for the messages of its run of
//      consecutive edges at its column, and warp 0 cuts the keys into row
//      segments with ballots and asks for the segments' row scales. Each
//      thread sums its run segment by segment into shared memory; a
//      segment's runs are added in slot order. A row cut by a chunk boundary
//      (only the first and the last segment can be) leaves one partial sum
//      per chunk in `partial` (slot 1 of a chunk for the segment that runs on
//      past its end, slot 0 for the one that ends in it) and adds to its
//      64-bit counter; while the adds are in flight, the rows that lie inside
//      the chunk are scaled and written. The chunk whose add completes a
//      row's count sums the row's partials in chunk order (both cut rows'
//      loads at once), scales and writes the row, and zeroes the counter for
//      the next launch. No chunk needs the row's extent: each
//      adds -1 to the counter's low field, the row's first chunk c0 also -c0
//      and its last chunk c1 also c1 + 1, so the field is 0 exactly when all
//      c1 - c0 + 1 chunks have added; c0 + 1 and c1 + 1 go to two higher
//      fields, so the merging chunk reads them from its own add's result.
//   2. row tiles (the other blocks): a tile of consecutive rows, sized for
//      about kTilesPerSm tiles per SM, finds its edge window with two
//      warp-wide 32-way searches (2 rounds of loads at E = 640, against ~10
//      of a binary search), marks the rows that have an edge, and writes
//      every other row as zeros.
// So the longest path is one chunk's loads, one counter add and one merge,
// whatever the skew, while the row tiles write the zeros.
//
// The counters make two launches of this kernel on two streams at once
// unsafe: they share them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // edge slots per chunk: one warp lane each
constexpr int kChunkCols = 64;  // most columns a chunk sums at once, so 4+ slots of <= 8 edges
constexpr int kMaxRows = 256;   // rows per row tile
constexpr int kTilesPerSm = 2;  // row tiles per SM the tile size aims at
constexpr int kBatch = 8;       // loads in flight per thread
constexpr int kMergeBatch = 4;  // loads in flight per thread and merged row

__device__ __forceinline__ float4 madd(float w, float4 x, float4 acc) {
  return make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y), fmaf(w, x.z, acc.z),
                     fmaf(w, x.w, acc.w));
}
__device__ __forceinline__ float madd(float w, float x, float acc) { return fmaf(w, x, acc); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 mul(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float mul(float a, float s) { return a * s; }
template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

// First index in [0, n) whose key is >= value, found by one whole warp: each
// round the 32 lanes probe 32 evenly spaced keys and the range shrinks to
// the gap between two probes (2 rounds for n <= 1056, 3 for n <= 33 K).
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys, int n, int value) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + (lane + 1) * step - 1;
    const bool less = pos < hi && __ldg(keys + pos) < value;
    lo += __popc(__ballot_sync(0xffffffffu, less)) * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// Adds v to *p at device scope with acquire-release order, returns the old value.
__device__ __forceinline__ unsigned long long add_acq_rel(unsigned long long* p,
                                                          unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

// The counter of a cut row packs three fields into 64 bits: c0 + 1 from bit
// 43, c1 + 1 from bit 22, and below them the running sum of the adds, which
// stays within +-2^21 while fewer than 2^19 chunks exist.
constexpr int kFirstShift = 43, kLastShift = 22;
constexpr unsigned long long kSumMask = (1ull << kLastShift) - 1;

// One chunk of edge slots: its rows' segments (role 1 above).
template <typename V>
__device__ __forceinline__ void chunk_block(const V* __restrict__ msg, const int* __restrict__ keys,
                                            const float* __restrict__ edge_weight,
                                            const float* __restrict__ row_scale,
                                            V* __restrict__ out, V* __restrict__ partial,
                                            unsigned long long* __restrict__ counters,
                                            int num_edges, int num_rows, int dv) {
  // (first slot, end slot, row, 1 if cut on the left | 2 if cut on the right)
  __shared__ int4 s_seg[kChunk];
  __shared__ int s_next[kChunk];            // each segment's first run start after its first slot
  __shared__ float s_scale[kChunk];         // each segment's row scale
  __shared__ int s_key[kChunk];
  __shared__ int s_nseg, s_valid;
  __shared__ int s_won[2], s_span[2][2];  // per cut segment: merged here?, its c0 and c1
  __shared__ V s_acc[kChunk * kChunkCols];  // each thread's run, by segment

  const int chunk = blockIdx.x;
  const int begin = chunk * kChunk, end = min(begin + kChunk, num_edges);
  // warp 0 asks for the keys first: everything waits on them
  const int lane = threadIdx.x, e = begin + lane;  // in warp 0
  int key = INT_MAX, before = -1, after = -1;
  if (threadIdx.x < 32) {
    if (e < end) key = __ldg(keys + e);
    if (lane == 0 && begin > 0) before = __ldg(keys + begin - 1);
    if (lane == 31 && end < num_edges) after = __ldg(keys + end);
  }

  // (slot, column) threads; slot s sums the run of edge slots [s * per, (s + 1) * per)
  const int cols = min(dv, kChunkCols);
  const int slots = kThreads / cols;  // >= 4, so per <= kBatch
  const int slot = threadIdx.x / cols, c0 = threadIdx.x - slot * cols;
  const int per = (end - begin + slots - 1) / slots;
  const int run0 = min(slot * per, end - begin), run1 = min(run0 + per, end - begin);
  V x[kBatch];
  float w[kBatch];
  const auto load_run = [&](int c) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (run0 + j < run1 && slot < slots && c < dv) {
        x[j] = msg[static_cast<size_t>(begin + run0 + j) * dv + c];
        w[j] = edge_weight != nullptr ? __ldg(edge_weight + begin + run0 + j) : 1.0f;
      }
    }
  };
  // the first columns' loads go out before the keys arrive: a masked slot
  // still has a message row, which is loaded and never summed
  load_run(c0);

  int seg_idx = -1;  // in warp 0: the segment that starts at this lane, and its row scale
  float seg_scale = 1.0f;
  if (threadIdx.x < 32) {
    after = __shfl_sync(0xffffffffu, after, 31);
    const int prev = __shfl_up_sync(0xffffffffu, key, 1);
    const int next = __shfl_down_sync(0xffffffffu, key, 1);
    const bool valid = e < end && key < num_rows;
    const bool first = valid && (lane == 0 || prev != key);
    const bool last = valid && (lane == 31 || e + 1 == end || next != key);
    const unsigned firsts = __ballot_sync(0xffffffffu, first);
    const unsigned lasts = __ballot_sync(0xffffffffu, last);
    const unsigned valids = __ballot_sync(0xffffffffu, valid);
    s_key[lane] = key;
    if (first) {
      // asked for now, stored in s_scale once the runs are summed
      if (row_scale != nullptr) seg_scale = __ldg(row_scale + key);
      const int stop = lane + __ffs(lasts >> lane);  // one past the segment's last slot
      const int cut = (lane == 0 && before == key ? 1 : 0) |
                      (stop == kChunk && after == key ? 2 : 0);
      seg_idx = __popc(firsts & ((1u << lane) - 1u));
      s_seg[seg_idx] = make_int4(lane, stop, key, cut);
      s_next[seg_idx] = (lane / per + 1) * per;
    }
    if (lane == 0) {
      s_nseg = __popc(firsts);
      s_valid = __popc(valids);
    }
  }
  __syncthreads();
  const int nseg = s_nseg, n_valid = s_valid;  // valid slots come first: keys ascend
  if (nseg == 0) return;
  // only the first segment can be cut on the left, only the last on the right
  const bool cut_first = s_seg[0].w != 0, cut_last = nseg > 1 && s_seg[nseg - 1].w != 0;

  // segment j's sum at column c: its runs' sums in slot order
  const auto segment_total = [&](int j, int c) {
    const int4 seg = s_seg[j];
    V total = s_acc[seg.x * cols + c];
    for (int i = s_next[j]; i < seg.y; i += per) total = add(total, s_acc[i * cols + c]);
    return total;
  };
  // this chunk's partial of cut segment j: slot 1 if it runs on past the chunk's end
  const auto partial_row = [&](int j) {
    return partial + (static_cast<size_t>(chunk) * 2 + (s_seg[j].w & 2 ? 1 : 0)) * dv;
  };

  for (int base = 0; base < dv; base += cols) {
    const int c = base + c0;
    if (base > 0) load_run(c);
    const bool active = slot < slots && c < dv;
    if (active && run0 < min(run1, n_valid)) {
      V acc = zero<V>();
      int start = run0;  // where the run's current segment began
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = run0 + j;
        if (i >= min(run1, n_valid)) break;
        if (i > start && s_key[i] != s_key[i - 1]) {
          s_acc[start * cols + c0] = acc;
          acc = zero<V>();
          start = i;
        }
        acc = madd(w[j], x[j], acc);
      }
      s_acc[start * cols + c0] = acc;
    }
    __syncthreads();
    // the cut segments' partials first: after the last columns' ones, the
    // counter adds below go out while the other rows are written
    if (active && slot == 0) {
      if (cut_first) partial_row(0)[c] = segment_total(0, c0);
      if (cut_last) partial_row(nseg - 1)[c] = segment_total(nseg - 1, c0);
    }
    // the row scales were read after the keys; stored only now, so that the
    // sums above did not wait for them
    if (base == 0 && seg_idx >= 0) s_scale[seg_idx] = seg_scale;
    const bool adds = base + cols >= dv && (cut_first || cut_last);
    if (base == 0 || adds) __syncthreads();
    if (adds) {
      // one add per cut segment by the block's last two threads, at device
      // scope with release order: the block's partials are written (the
      // barrier) before the add, and acquire order for the merge below
      const int which = kThreads - 1 - threadIdx.x;  // 0: the first segment, 1: the last
      if (which < 2) {
        const int j = which == 0 ? 0 : nseg - 1;
        bool won = false;
        if (which == 0 ? cut_first : cut_last) {
          const int4 seg = s_seg[j];
          long long delta = -1;
          if (!(seg.w & 1)) delta += (static_cast<long long>(chunk) + 1 << kFirstShift) - chunk;
          if (!(seg.w & 2)) delta += (static_cast<long long>(chunk) + 1 << kLastShift) + chunk + 1;
          unsigned long long* counter = counters + seg.z;
          const unsigned long long now =
              add_acq_rel(counter, static_cast<unsigned long long>(delta)) +
              static_cast<unsigned long long>(delta);
          if ((now & kSumMask) == 0) {  // every chunk of the row has added
            won = true;
            *counter = 0;  // for the next launch
            s_span[which][0] = static_cast<int>(now >> kFirstShift) - 1;
            s_span[which][1] = static_cast<int>((now >> kLastShift) & ((1u << 21) - 1)) - 1;
          }
        }
        s_won[which] = won;
      }
    }
    // the rows that lie inside the chunk
    if (active) {
      for (int j = slot; j < nseg; j += slots) {
        if (s_seg[j].w == 0) {
          out[static_cast<size_t>(s_seg[j].z) * dv + c] = mul(segment_total(j, c0), s_scale[j]);
        }
      }
    }
    __syncthreads();
  }
  if (!cut_first && !cut_last) return;
  if (!s_won[0] && !s_won[1]) return;

  // the rows whose last add this was (at most two): their partials in chunk
  // order (slot 1 of chunks c0 .. c1 - 1, slot 0 of c1), both rows' loads at once
  int first_chunk[2], n[2];
  for (int k = 0; k < 2; ++k) {
    first_chunk[k] = s_span[k][0];
    n[k] = s_won[k] ? s_span[k][1] - s_span[k][0] + 1 : 0;
  }
  const int mcols = min(dv, kThreads), mslots = kThreads / mcols;
  const int mslot = threadIdx.x / mcols, m0 = threadIdx.x - mslot * mcols;
  for (int base = 0; base < dv; base += mcols) {
    const int c = base + m0;
    const bool active = mslot < mslots && c < dv;
    V acc[2] = {zero<V>(), zero<V>()};
    if (active) {
      for (int i0 = mslot; i0 < max(n[0], n[1]); i0 += kMergeBatch * mslots) {
        V y[2][kMergeBatch];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int t = 0; t < kMergeBatch; ++t) {
            const int i = i0 + t * mslots;
            if (i < n[k]) {
              const size_t at =
                  static_cast<size_t>(first_chunk[k] + i) * 2 + (i + 1 < n[k] ? 1 : 0);
              y[k][t] = __ldcg(partial + at * dv + c);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int t = 0; t < kMergeBatch; ++t) {
            if (i0 + t * mslots < n[k]) acc[k] = add(acc[k], y[k][t]);
          }
        }
      }
    }
    s_acc[threadIdx.x] = acc[0];
    s_acc[kThreads + threadIdx.x] = acc[1];
    __syncthreads();
    if (active && mslot == 0) {
      for (int k = 0; k < 2; ++k) {
        if (n[k] == 0) continue;
        V total = s_acc[k * kThreads + m0];
        for (int t = 1; t < mslots; ++t) total = add(total, s_acc[k * kThreads + t * mcols + m0]);
        const int j = k == 0 ? 0 : nseg - 1;
        out[static_cast<size_t>(s_seg[j].z) * dv + c] = mul(total, s_scale[j]);
      }
    }
    __syncthreads();
  }
}

// One tile of rows: every row without an edge, as zeros (role 2 above).
template <typename V>
__device__ __forceinline__ void row_block(const int* __restrict__ keys, V* __restrict__ out,
                                          int tile, int tile_rows, int num_edges, int num_rows,
                                          int dv) {
  __shared__ int s_has[kMaxRows], s_window[2];

  const int row0 = tile * tile_rows;
  const int rows = min(tile_rows, num_rows - row0);
  for (int r = threadIdx.x; r < rows; r += kThreads) s_has[r] = 0;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int at = warp_lower_bound(keys, num_edges, row0 + warp * rows);
    if ((threadIdx.x & 31) == 0) s_window[warp] = at;
  }
  __syncthreads();
  for (int e = s_window[0] + threadIdx.x; e < s_window[1]; e += kThreads) {
    s_has[__ldg(keys + e) - row0] = 1;
  }
  __syncthreads();

  // (row slot, column) threads
  const int cols = min(dv, kThreads);
  const int slots = kThreads / cols;
  const int slot = threadIdx.x / cols, c0 = threadIdx.x - slot * cols;
  if (slot >= slots) return;
  for (int r = slot; r < rows; r += slots) {
    if (s_has[r]) continue;  // a chunk's
    V* __restrict__ out_row = out + static_cast<size_t>(row0 + r) * dv;
    for (int c = c0; c < dv; c += cols) out_row[c] = zero<V>();
  }
}

// V is float4 (dv = d / 4 vectors per row) or float (dv = d).
// Three blocks per SM: the row tiles' stores need the occupancy.
template <typename V>
__global__ void __launch_bounds__(kThreads, 3)
    scatter_sorted_kernel(const V* __restrict__ msg, const int* __restrict__ keys,
                          const float* __restrict__ edge_weight,
                          const float* __restrict__ row_scale, V* __restrict__ out,
                          V* __restrict__ partial, unsigned long long* __restrict__ counters,
                          int num_edges, int num_rows, int dv, int num_chunks, int tile_rows) {
  if (static_cast<int>(blockIdx.x) < num_chunks) {
    chunk_block(msg, keys, edge_weight, row_scale, out, partial, counters, num_edges, num_rows,
                dv);
  } else {
    row_block(keys, out, blockIdx.x - num_chunks, tile_rows, num_edges, num_rows, dv);
  }
}

}  // namespace

extern "C" {

// Edge slots per chunk: the wrapper sizes `partial` as 2 * d floats per chunk.
int rgcn_scatter_chunk_edges() { return kChunk; }

// Launches the kernel on `stream` and returns a CUDA error code (0 = launched).
// partial: 2 * d floats of scratch for each chunk of rgcn_scatter_chunk_edges() slots;
// counters: num_rows 64-bit zeros, which every launch leaves as zeros;
// num_edges < 2^24.
int rgcn_scatter_sorted(const float* msg, const int* keys, const float* edge_weight,
                        const float* row_scale, float* out, float* partial,
                        unsigned long long* counters,
                        int num_edges, int num_rows, int d, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // about kTilesPerSm row tiles per SM, a multiple of 16 rows each
  const int per_tile = (num_rows + kTilesPerSm * sms - 1) / (kTilesPerSm * sms);
  const int tile_rows = min(kMaxRows, max(16, (per_tile + 15) / 16 * 16));
  const int chunks = (num_edges + kChunk - 1) / kChunk;
  const int blocks = chunks + (num_rows + tile_rows - 1) / tile_rows;
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(msg) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(partial) % 16 == 0;
  if (vec4) {
    scatter_sorted_kernel<float4><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(msg), keys, edge_weight, row_scale,
        reinterpret_cast<float4*>(out), reinterpret_cast<float4*>(partial), counters,
        num_edges, num_rows, d / 4, chunks, tile_rows);
  } else {
    scatter_sorted_kernel<float><<<blocks, kThreads, 0, stream>>>(
        msg, keys, edge_weight, row_scale, out, partial, counters, num_edges, num_rows, d,
        chunks, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rgcn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
