// Row updates from a sorted id stream, for Hopper (sm_90a). Input: the
// stream (slid, order) of N positions, slid sorted and slid[j] the row of
// the cotangent ct[order[j], :]; ct is [N', dim] f32. For every row r that
// the stream touches, G[r] = the sum of ct[order[j], :] over the positions
// j with slid[j] == r, taken in the order of j, in f32. Then, in place on
// [rows, dim] f32 tables:
//
//   scatter_add_rows: out[r] = G (out zero-filled by the caller);
//   fused_adagrad_rows: acc[r] += G*G;  param[r] -= lr * G * rsqrt(acc[r] +
//     eps) where acc[r] > 0 (optax's scale_by_rss with duplicates summed
//     first);
//   fused_sgd_rows: param[r] -= lr * G (optax.sgd on the summed gradient);
//   fused_adam_rows: lazy Adam. A row is touched when G[r] is non-zero in
//     any of its dim columns; a touched row gets, in every column,
//     m = b1*m + (1-b1)*G, v = b2*v + (1-b2)*G*G and
//     param -= lr * (m*bc1) / (sqrt(v*bc2) + eps), with bc1, bc2 the
//     reciprocal bias corrections at step + 1 (computed by the caller); a
//     row whose G is zero in every column keeps param, m and v as they are.
//
// Rows that the stream does not touch are not read or written.
//
// The scalars that change from step to step (lr, and Adam's bc1 and bc2)
// are read from device memory, `hyper` = {lr} or {lr, bc1, bc2} in f32: a
// captured CUDA graph of training steps replays the launch with the pointer
// it was captured with, and the host writes each step's values there before
// the replay. The constants (eps, b1, b2, 1 - b1, 1 - b2) go by value. In
// the walk SGD and Adam load theirs once a thread at the kernel's start,
// Adagrad where it updates an element (the faster placements when a hot
// row was still one warp's serial sum; chip_lab_rows.py, PERF.md); the
// long path's pass 2 loads them where it updates an element.
//
// Replaces four TPU kernels of recommender_system_tpu/ops: embedding_grad.py
// _queue_kernel, and fused_adagrad.py _fused_adagrad_kernel,
// _fused_sgd_kernel and _fused_adam_kernel (their single-stream path; the
// Trainer concatenates a table's lookup sites into one stream). Plain
// versions: scatter_add_dense_ref, fused_adagrad_ref, fused_sgd_ref and
// fused_adam_ref in recommender_system_tpu_torch/ops/.
//
// The TPU kernels run a sequential grid over a (subtile, chunk) work queue
// and turn each chunk into a one-hot matrix product, since the TPU has no
// scatter. Here blocks run in parallel, so the design only makes sure that
// no two threads write the same element, with no atomics, deterministic.
//
// Bound on the card: device memory. Each rule must read slid and order (8
// bytes a position: rows and positions fit int32) and the N*dim*4 bytes of
// ct; Adagrad reads and writes param and acc on the U touched rows
// (16*U*dim bytes), SGD param (8*U*dim), Adam param, m and v (24*U*dim);
// the scatter-add writes the whole [rows, dim] output (the caller's zero
// fill plus the touched rows). Each does a few flops per byte. The stream
// is int64 here, as the sort gives it: 8 bytes a position more than the
// bound counts. Every rule rounds as its plain version does: _rn intrinsics
// keep nvcc from contracting a multiply and an add into one fused
// multiply-add.
//
// All four rules take the tile walk for their segments shorter than kLong.
// A first version gave each thread one (position, column) pair: every one
// of a position's dim threads loaded slid[i] and slid[i-1] (about 4*dim
// metadata loads a position), took a 64-bit division t / dim, and a
// segment's start thread ran a chain of 4-5 dependent round trips to memory
// (slid[i], slid[i+1] in the segment search, order[i], ct, param) behind
// branches that kept the compiler from hoisting any of them; it lost to one
// index_add_. Now one warp owns a tile of 32 consecutive positions
// [p0, p0 + 32): lane l loads slid[p0 + l] and order[p0 + l] (two coalesced
// loads, one round trip; lanes 0 and 31 also load slid[p0 - 1] and
// slid[p0 + 32]), a ballot of slid[p] != slid[p - 1] gives the tile's
// segment starts, and a start's segment ends at the next start. Only the
// tile's last segment can run past p0 + 32; it alone searches on (galloping
// over slid), and positions at the head of a tile that continue an earlier
// tile's segment are that tile's to sum. The starts' row, order, first
// position and end go to shared memory by rank; the warp's lanes then take
// the tile's S*dim (start, column) elements, lane l the elements l + 32k, so
// that neighbouring lanes read neighbouring columns of one cotangent row.
// An element's ct and table loads depend only on the tile's metadata: a
// lane starts them for kBatch elements before its first add or store, so an
// element costs two dependent round trips (the metadata, then ct and the
// table), and the metadata is read once a position. A segment longer than
// one position adds its other cotangents in stream order after that first
// one (the order from shared memory inside the tile, from order[] past it).
// Element indices advance by 32 with a quotient and remainder taken once, so
// the walk does no division.
//
// Lazy Adam must see all dim column sums of a segment before it writes any
// column. It takes the same tile, ballot, ranks and galloping, then votes:
// pass 1 sums each (segment, column) element of the tile as the other rules
// do and keeps the sum in a per-warp scratch row of shared memory (element
// e of the tile at scratch[e], so neighbouring lanes write neighbouring
// words); a lane whose sum is not zero sets its segment's touched flag,
// which the start lane zeroed while staging, so the flag is only ever
// written as 1 and needs no atomics. After a __syncwarp, pass 2 updates m,
// v and param for the elements of touched segments only, reading the sum
// back from the scratch row. For dim > 32 the columns go in chunks of 32:
// pass 1 ORs the flag over the chunks and keeps no sums, and pass 2 sums a
// touched segment's chunk again (the same sum in the same order).
//
// The walk sums a segment's column from 0.f in stream order with __fadd_rn,
// so its results do not depend on the launch. A hot row is one long serial
// sum for the dim lanes that own its (start, column) elements: right, but
// one warp's chain of loads. The TPU kernels cut the sorted stream into
// fixed chunks, each one work item, so that a hot row costs what any other
// row of as many positions costs. All four rules carry that over as the
// long path. A segment is long when it holds at least kLong
// positions (kLong == kChunk: a long segment then covers every chunk it
// starts or ends in up to that chunk's edge, and holds the whole of any
// chunk it crosses, so each chunk has at most two long pieces, one at each
// edge, and "long" is one load away from any end of a piece: slid sorted,
// slid[s + kLong - 1] == slid[s] for a segment that starts at s, slid[e -
// kLong] == slid[e - 1] for one that ends at e). In the launch that runs
// the walk, the first blocks run pass 1: one warp a chunk of kChunk
// positions finds the long pieces at its chunk's edges (a 32-ary search
// over slid, two rounds), sums each piece's columns in stream order (lane
// l column l + 32i, the orders of 32 positions one coalesced load, then
// shuffled, 32 cotangent loads in flight before the adds) into an f32
// scratch [chunks, 2, dim] (slot 0 the piece that holds the chunk's first
// position, slot 1 the one that holds its last), and writes the start of
// the long segment that begins in the chunk, or -1, to starts[chunk]. The
// walk skips long segments (it neither sums nor writes them); they are
// disjoint from its rows, so both run in one grid. Pass 2, a second
// kernel, gives a block 32 chunks' starts[] (one load and a ballot; a block
// with no segment leaves) and, for each segment there, warp 0 finds its
// end, then 8 shares of 32 threads add the segment's pieces
// (its first chunk's slot, then slot 0 of every later chunk it reaches):
// share q the pieces q, q + 8, ..., in order from 0.f, and a fixed tree
// ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)) joins the shares. Then
// the rule is applied to the row once, with the walk's operations. Lazy
// Adam first sums every 32-column chunk of the row and takes a block-wide
// vote on whether any sum is non-zero (DIN's padding row, whose cotangents
// are all zero, must keep param, m and v bitwise); only a touched row sums
// its chunks again, in the same order, and updates them, so that no limit
// on dim is added to the walk's. Every order is fixed, so two launches
// agree bitwise; no atomics, no host read, grids from N alone, two kernels
// every call (blocks with nothing long leave after a load or two). The
// bound is the walk's: the long path reads each long position's order and
// cotangent once and writes 2 * dim floats a chunk, a small fraction of
// the stream's bytes. A stream with no long segment pays pass 2's kernel,
// 1.7 us on the H100; a hot row of 185,000 positions at dim 32 now takes
// what the walk takes for as many positions of short rows (Adagrad 0.081
// ms for DIN's step stream against 18.9; PERF.md, chip_lab_rows.py).
// scatter_add_chunked_ref (ops/embedding_grad.py) is the same sum in the
// same order in PyTorch, and each rule's formula applied to it is what
// the kernels compute.
//
// C interface, loaded with ctypes: each function returns cudaGetLastError()
// after the launch; the Python wrapper checks shapes, types and devices.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// warps loop past this many blocks: 16 resident blocks on each of the
// H100's 132 SMs, a few waves
constexpr int64_t kMaxBlocks = 132 * 16 * 8;
constexpr unsigned kFull = 0xffffffffu;
// (start, column) elements whose loads a lane starts before its first store;
// lazy Adam's walk, in each of its two passes, starts fewer: at 4 its kernel
// (pass 1 of the long path beside it) spills at ptxas' 128 registers, and 2
// was the fastest on the card (chip_lab_rows.py, PERF.md)
constexpr int kBatch = 4;
constexpr int kAdamBatch = 2;
// the long path (see the note at the top): positions a chunk, the length
// from which a segment is long, and the shares of pass 2's sum. The port's
// plain version of the order (ops/embedding_grad.py) reads the same values.
constexpr int64_t kChunk = 256;
constexpr int64_t kLong = kChunk;
constexpr int kShares = 8;
static_assert(kLong == kChunk, "a chunk's long pieces are found at its edges only");
static_assert(kShares * 32 == kThreads, "pass 2: a warp a share");

enum class Rule { kScatterAdd, kAdagrad, kSgd, kAdam };

// The long path's scratch: pass 1 writes, pass 2 reads. partial is [chunks,
// 2, dim] f32, starts [chunks]; blocks is the number of pass-1 blocks at
// the head of the walk's grid.
struct Long {
  float* partial;
  int64_t* starts;
  int64_t blocks;
};

// The rules' scalars. Adam's bc1, bc2 are the reciprocal bias corrections,
// and 1 - b1, 1 - b2 are rounded once from double, as in the plain version.
// lr, bc1 and bc2 come from `step` (device memory): see the note at the top.
struct Hyper {
  float lr, eps, b1, b2, bc1, bc2, one_minus_b1, one_minus_b2;
  const float* step;
};

// First position after i whose id differs from row = slid[i] (n if none).
__device__ __forceinline__ int64_t segment_end(const int64_t* __restrict__ slid,
                                               int64_t i, int64_t n, int64_t row) {
  int64_t lo = i;  // slid[lo] == row
  int64_t step = 1;
  while (lo + step < n && slid[lo + step] == row) {
    lo += step;
    step <<= 1;
  }
  int64_t hi = lo + step < n ? lo + step : n;  // hi == n or slid[hi] != row
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (slid[mid] == row) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

// The first position p of [lo, hi) with (slid[p] == row) == equal, or hi if
// none, where that holds from some position on and not before it (slid is
// sorted): a 32-ary search, the warp's lanes probing at once. Every lane
// returns the same value.
__device__ __forceinline__ int64_t warp_first(const int64_t* __restrict__ slid, int64_t lo,
                                              int64_t hi, int64_t row, bool equal, int lane) {
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t q = lo + lane * step;
    const unsigned hit = __ballot_sync(kFull, q < hi && (slid[q] == row) == equal);
    if (hit == 0) {
      // past the last probe below hi
      const int64_t last = (hi - 1 - lo) / step < 31 ? (hi - 1 - lo) / step : 31;
      lo += last * step + 1;
    } else {
      const int f = __ffs(hit) - 1;
      if (f == 0) return lo;
      // after probe f - 1, at probe f at the latest
      hi = lo + f * step;
      lo += (f - 1) * step + 1;
    }
  }
  return hi;
}

// Pass 1 on a piece [a, b) of a long segment (b - a <= kChunk): its column
// sums in stream order from 0.f to out[0, dim). Lane l takes the columns l,
// l + 32, ...; the orders of 32 positions are one coalesced load, shuffled
// to the lanes, and the 32 cotangent loads go out before the adds.
__device__ __forceinline__ void piece_sum(const int64_t* __restrict__ order,
                                          const float* __restrict__ ct, int64_t a, int64_t b,
                                          int dim, int lane, float* __restrict__ out) {
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int c = c0 + lane;
    float g = 0.f;
    for (int64_t j0 = a; j0 < b; j0 += 32) {
      const int count = b - j0 < 32 ? static_cast<int>(b - j0) : 32;
      const int64_t ord = lane < count ? order[j0 + lane] : 0;
      float v[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int64_t o = __shfl_sync(kFull, ord, q);
        v[q] = q < count && c < dim ? ct[o * dim + c] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (q < count) g = __fadd_rn(g, v[q]);
      }
    }
    if (c < dim) out[c] = g;
  }
}

// Pass 1 on chunk k, by one warp (see the note at the top): the long pieces
// at the chunk's two edges summed into partial[k], and starts[k].
__device__ __forceinline__ void chunk_pass(const int64_t* __restrict__ slid,
                                           const int64_t* __restrict__ order,
                                           const float* __restrict__ ct, int64_t n, int dim,
                                           int64_t k, int lane, const Long& lng) {
  const int64_t c0 = k * kChunk;
  const int64_t c1 = c0 + kChunk < n ? c0 + kChunk : n;
  // one round trip: the chunk's first and last ids and their neighbours
  // outside it (-1 past the stream: ids are rows, never negative)
  int64_t v = -1;
  if (lane == 0) v = slid[c0];
  if (lane == 1) v = slid[c1 - 1];
  if (lane == 2 && c0 > 0) v = slid[c0 - 1];
  if (lane == 3 && c1 < n) v = slid[c1];
  const int64_t r0 = __shfl_sync(kFull, v, 0);
  const int64_t r1 = __shfl_sync(kFull, v, 1);
  const int64_t prev = __shfl_sync(kFull, v, 2);
  const int64_t next = __shfl_sync(kFull, v, 3);
  int64_t e0 = c1, s1 = c1, start = -1;
  bool long0 = false, long1 = false;
  if (r0 == r1) {
    // one row over the chunk: long if the chunk is whole, else the row's
    // segment ends the stream
    long0 = c1 - c0 == kChunk || (n >= kLong && slid[n - kLong] == r0);
    if (long0 && prev != r0) start = c0;
  } else {
    // a segment that ends inside the chunk is long only if it began before
    // it; one that starts inside only if it runs past it
    if (prev == r0) {
      e0 = warp_first(slid, c0 + 1, c1, r0, false, lane);
      long0 = e0 >= kLong && slid[e0 - kLong] == r0;
    }
    if (next == r1) {
      s1 = warp_first(slid, c0 + 1, c1, r1, true, lane);
      long1 = s1 + kLong <= n && slid[s1 + kLong - 1] == r1;
      if (long1) start = s1;
    }
  }
  if (lane == 0) lng.starts[k] = start;
  if (long0) piece_sum(order, ct, c0, e0, dim, lane, lng.partial + 2 * k * dim);
  if (long1) piece_sum(order, ct, s1, c1, dim, lane, lng.partial + (2 * k + 1) * dim);
}

// g plus column col of the cotangents at positions [i, end), added in
// stream order.
__device__ __forceinline__ float column_sum(float g, const int64_t* __restrict__ order,
                                            const float* __restrict__ ct, int64_t i,
                                            int64_t end, int dim, int col) {
#pragma unroll 8
  for (int64_t j = i; j < end; ++j) {
    g = __fadd_rn(g, ct[order[j] * dim + col]);
  }
  return g;
}

// One warp's view of its tile in shared memory: the tile's order by lane;
// its segments' row, first order, end (a stream position) and first lane by
// rank.
struct Tile {
  int64_t p0;
  const int64_t* order;
  const int64_t* row;
  const int64_t* first;
  const int64_t* end;
  const int* begin;
};

// The summed gradient of segment j in column c, whose first cotangent g0
// was loaded already: the tile's later positions from its orders in shared
// memory, the positions past the tile from order[].
__device__ __forceinline__ float segment_sum(const Tile& t, const int64_t* __restrict__ order,
                                             const float* __restrict__ ct, int dim, int j,
                                             int c, float g0) {
  float g = __fadd_rn(0.f, g0);
  const int64_t first = t.p0 + t.begin[j];
  const int64_t end = t.end[j];
  if (end - first > 1) {
    const int64_t inside = end < t.p0 + 32 ? end : t.p0 + 32;
    for (int64_t q = first + 1; q < inside; ++q) {
      g = __fadd_rn(g, ct[t.order[q - t.p0] * dim + c]);
    }
    g = column_sum(g, order, ct, inside, end, dim, c);
  }
  return g;
}

// A lane's elements in a chunk of cd columns: l, l + 32, ... as (rank j,
// column c), advanced by 32 = q * cd + r with one carry.
struct Walk {
  int q, r, j, c;
  __device__ __forceinline__ void next(int cd) {
    j += q;
    c += r;
    if (c >= cd) {
      c -= cd;
      ++j;
    }
  }
};

// Lazy Adam on one tile of `segments` segments (see the note at the top).
// first is the lane's walk when a chunk is all dim columns; scratch holds
// the warp's 32 x 32 sums, touched its segments' flags.
__device__ __forceinline__ void adam_tile(const Tile& t, const int64_t* __restrict__ order,
                                          const float* __restrict__ ct,
                                          float* __restrict__ param, float* __restrict__ m,
                                          float* __restrict__ v, int dim, int segments,
                                          int lane, Walk first, const Hyper& h,
                                          float* scratch, int* touched) {
  // pass 1: every element's sum, and the touched flags
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int cd = dim - c0 < 32 ? dim - c0 : 32;
    Walk w = first;
    if (cd != dim) w = Walk{32 / cd, 32 - 32 / cd * cd, lane / cd, lane - lane / cd * cd};
    while (w.j < segments) {
      int jk[kAdamBatch], ck[kAdamBatch];
      float g[kAdamBatch];
#pragma unroll
      for (int k = 0; k < kAdamBatch; ++k) {
        jk[k] = w.j;
        ck[k] = w.c;
        if (w.j < segments) g[k] = ct[t.first[w.j] * dim + c0 + w.c];
        w.next(cd);
      }
#pragma unroll
      for (int k = 0; k < kAdamBatch; ++k) {
        if (jk[k] >= segments) break;
        const float sum = segment_sum(t, order, ct, dim, jk[k], c0 + ck[k], g[k]);
        if (dim <= 32) scratch[jk[k] * cd + ck[k]] = sum;
        if (sum != 0.f) touched[jk[k]] = 1;
      }
    }
  }
  __syncwarp();
  // pass 2: the touched segments' m, v and param
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int cd = dim - c0 < 32 ? dim - c0 : 32;
    Walk w = first;
    if (cd != dim) w = Walk{32 / cd, 32 - 32 / cd * cd, lane / cd, lane - lane / cd * cd};
    while (w.j < segments) {
      int jk[kAdamBatch], ck[kAdamBatch];
      int64_t o[kAdamBatch];
      float g[kAdamBatch], pk[kAdamBatch], mk[kAdamBatch], vk[kAdamBatch];
      bool live[kAdamBatch];
#pragma unroll
      for (int k = 0; k < kAdamBatch; ++k) {
        jk[k] = w.j;
        ck[k] = w.c;
        live[k] = w.j < segments && touched[w.j] != 0;
        if (live[k]) {
          const int c = c0 + w.c;
          o[k] = t.row[w.j] * dim + c;
          g[k] = dim <= 32 ? scratch[w.j * cd + w.c] : ct[t.first[w.j] * dim + c];
          pk[k] = param[o[k]];
          mk[k] = m[o[k]];
          vk[k] = v[o[k]];
        }
        w.next(cd);
      }
#pragma unroll
      for (int k = 0; k < kAdamBatch; ++k) {
        if (!live[k]) continue;
        const float gk =
            dim <= 32 ? g[k] : segment_sum(t, order, ct, dim, jk[k], c0 + ck[k], g[k]);
        // fused_adam_ref's order of operations, with no fused multiply-add
        const float m_new = __fadd_rn(__fmul_rn(h.b1, mk[k]), __fmul_rn(h.one_minus_b1, gk));
        const float v_new = __fadd_rn(__fmul_rn(h.b2, vk[k]),
                                      __fmul_rn(__fmul_rn(h.one_minus_b2, gk), gk));
        const float num = __fmul_rn(h.lr, __fmul_rn(m_new, h.bc1));
        const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v_new, h.bc2)), h.eps);
        param[o[k]] = __fsub_rn(pk[k], __fdiv_rn(num, den));
        m[o[k]] = m_new;
        v[o[k]] = v_new;
      }
    }
  }
}

// The tile walk (see the note at the top): one warp a tile of 32 stream
// positions, grid-stride over tiles. s1 is Adagrad's acc or Adam's m, s2
// Adam's v. The first lng.blocks blocks run pass 1 of the long path, one
// warp a chunk, and the walk skips long segments.
template <Rule kRule>
__global__ void __launch_bounds__(kThreads)
sparse_rows_kernel(const int64_t* __restrict__ slid, const int64_t* __restrict__ order,
                   const float* __restrict__ ct, float* __restrict__ param,
                   float* __restrict__ s1, float* __restrict__ s2, int64_t n, int dim,
                   Hyper h, Long lng) {
  int64_t block = blockIdx.x, grid = gridDim.x;
  if (block < lng.blocks) {
    const int64_t chunks = (n + kChunk - 1) / kChunk;
    for (int64_t k = block * kWarps + (threadIdx.x >> 5); k < chunks;
         k += lng.blocks * kWarps) {
      chunk_pass(slid, order, ct, n, dim, k, threadIdx.x & 31, lng);
    }
    return;
  }
  block -= lng.blocks;
  grid -= lng.blocks;
  constexpr bool kAdam = kRule == Rule::kAdam;
  if constexpr (kRule == Rule::kSgd || kAdam) h.lr = h.step[0];
  if constexpr (kAdam) {
    h.bc1 = h.step[1];
    h.bc2 = h.step[2];
  }
  __shared__ int64_t s_order[kThreads];
  __shared__ int64_t s_row[kThreads];
  __shared__ int64_t s_first[kThreads];
  __shared__ int64_t s_end[kThreads];
  __shared__ int s_begin[kThreads];
  // lazy Adam's per-warp scratch rows (32 segments x 32 columns) and flags
  __shared__ float s_sum[kAdam ? kThreads * 32 : 1];
  __shared__ int s_touched[kAdam ? kThreads : 1];
  const int lane = threadIdx.x & 31;
  const int base = threadIdx.x & ~31;
  int64_t* const w_order = s_order + base;
  int64_t* const r_row = s_row + base;
  int64_t* const r_first = s_first + base;
  int64_t* const r_end = s_end + base;
  int* const r_begin = s_begin + base;
  const Tile view{0, w_order, r_row, r_first, r_end, r_begin};
  // a lane's elements l, l + 32, ... as (rank, column) over all dim columns
  const Walk first{32 / dim, 32 - 32 / dim * dim, lane / dim, lane - lane / dim * dim};

  const int64_t tiles = (n + 31) / 32;
  for (int64_t tile = block * kWarps + (threadIdx.x >> 5); tile < tiles;
       tile += grid * kWarps) {
    const int64_t p0 = tile * 32;
    const int count = n - p0 < 32 ? static_cast<int>(n - p0) : 32;
    const int64_t p = p0 + lane;
    const bool valid = lane < count;
    // one round trip: the tile's ids and orders, and its two neighbours' ids
    int64_t row = -1, ord = 0, edge = -1;
    if (valid) {
      row = slid[p];
      ord = order[p];
    }
    if (lane == 0 && p0 > 0) edge = slid[p0 - 1];
    if (lane == 31 && p0 + 32 < n) edge = slid[p0 + 32];
    int64_t prev = __shfl_up_sync(kFull, row, 1);
    if (lane == 0) prev = edge;
    const bool start = valid && (p == 0 || row != prev);
    const unsigned starts = __ballot_sync(kFull, start);
    // the tile's last segment runs on into the next tile
    const bool runs_on = __ballot_sync(kFull, lane == 31 && p0 + 32 < n && edge == row) != 0;
    if (starts == 0) continue;  // one segment from an earlier tile: its walker sums it
    const int segments = __popc(starts);

    __syncwarp();  // the previous tile's reads of shared memory are done
    w_order[lane] = ord;
    bool is_long = false;  // the tile's last segment, on the long path
    if (start) {
      const int rank = __popc(starts & ((1u << lane) - 1u));
      const unsigned later = lane == 31 ? 0u : starts >> (lane + 1);
      int64_t end = p + __ffs(later);  // the next start
      if (later == 0 && runs_on) is_long = p + kLong <= n && slid[p + kLong - 1] == row;
      if (later == 0) end = is_long ? n : runs_on ? segment_end(slid, p0 + 32, n, row)
                                                  : p0 + count;
      r_row[rank] = row;
      r_first[rank] = ord;
      r_end[rank] = end;
      r_begin[rank] = lane;
      if constexpr (kAdam) s_touched[base + rank] = 0;
    }
    // the segments the walk sums: all but a long last one
    const int walked = segments - (__ballot_sync(kFull, is_long) != 0);
    __syncwarp();
    Tile t = view;
    t.p0 = p0;

    if constexpr (kAdam) {
      adam_tile(t, order, ct, param, s1, s2, dim, walked, lane, first, h,
                s_sum + base * 32, s_touched + base);
      continue;
    }

    Walk w = first;
    while (w.j < walked) {
      // every load of kBatch elements first: ct at each segment's first
      // position, and the table entries the rule reads
      int jk[kBatch], ck[kBatch];
      int64_t o[kBatch];
      float g[kBatch], pk[kBatch], ak[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        jk[k] = w.j;
        ck[k] = w.c;
        if (w.j < walked) {
          o[k] = r_row[w.j] * dim + w.c;
          g[k] = ct[r_first[w.j] * dim + w.c];
          if constexpr (kRule != Rule::kScatterAdd) pk[k] = param[o[k]];
          if constexpr (kRule == Rule::kAdagrad) ak[k] = s1[o[k]];
        }
        w.next(dim);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (jk[k] >= walked) break;
        const float gk = segment_sum(t, order, ct, dim, jk[k], ck[k], g[k]);
        if constexpr (kRule == Rule::kAdagrad) {
          // the plain version's order of operations, with no fused multiply-add
          const float a = __fadd_rn(ak[k], __fmul_rn(gk, gk));
          s1[o[k]] = a;
          const float inv = a > 0.f ? rsqrtf(__fadd_rn(a, h.eps)) : 0.f;
          param[o[k]] = __fsub_rn(pk[k], __fmul_rn(__fmul_rn(h.step[0], gk), inv));
        } else if constexpr (kRule == Rule::kSgd) {
          param[o[k]] = __fsub_rn(pk[k], __fmul_rn(h.lr, gk));
        } else {
          param[o[k]] = gk;
        }
      }
    }
  }
}

// The sum of a long segment in the columns c0 + lane (see the note at the
// top): each share adds its pieces from 0.f, then share 0's lanes join the
// shares with the fixed tree. Every thread of the block calls it; the sum
// is on share 0's lanes whose column is below dim, 0.f elsewhere.
__device__ __forceinline__ float long_row_sum(const float* __restrict__ first,
                                              const float* __restrict__ later, int64_t pieces,
                                              int dim, int c0, int share, int lane,
                                              float (*s_share)[32]) {
  const int c = c0 + lane;
  float g = 0.f;
  if (c < dim) {
    int64_t q = share;
    if (share == 0) {
      g = __fadd_rn(g, first[c]);
      q = kShares;
    }
#pragma unroll 8
    for (; q < pieces; q += kShares) g = __fadd_rn(g, later[2 * q * dim + c]);
  }
  s_share[share][lane] = g;
  __syncthreads();
  float gk = 0.f;
  if (share == 0 && c < dim) {
    const float* const x = &s_share[0][lane];
    gk = __fadd_rn(__fadd_rn(__fadd_rn(x[0], x[32]), __fadd_rn(x[64], x[96])),
                   __fadd_rn(__fadd_rn(x[128], x[160]), __fadd_rn(x[192], x[224])));
  }
  __syncthreads();  // s_share is read
  return gk;
}

// Pass 2 of the long path (see the note at the top): block b looks at the
// chunks 32b .. 32b + 31 (one coalesced load and a ballot, after which a
// block with none leaves), and for each whose starts[] holds a long segment
// it sums the segment's pieces in shares and applies the rule to its row,
// with the walk's operations. s1 is Adagrad's acc or Adam's m, s2 Adam's v.
template <Rule kRule>
__global__ void __launch_bounds__(kThreads)
sparse_rows_long_kernel(const int64_t* __restrict__ slid, float* __restrict__ param,
                        float* __restrict__ s1, float* __restrict__ s2, int64_t n, int dim,
                        Hyper h, const float* __restrict__ partial,
                        const int64_t* __restrict__ starts) {
  __shared__ int64_t s_start[32];
  __shared__ unsigned s_mask;
  __shared__ int64_t s_end;
  __shared__ float s_share[kShares][32];
  const int lane = threadIdx.x & 31;
  const int share = threadIdx.x >> 5;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  for (int64_t k0 = static_cast<int64_t>(blockIdx.x) * 32; k0 < chunks;
       k0 += static_cast<int64_t>(gridDim.x) * 32) {
    __syncthreads();  // the previous round's reads of s_start and s_mask are done
    if (share == 0) {
      const int64_t s = k0 + lane < chunks ? starts[k0 + lane] : -1;
      const unsigned mask = __ballot_sync(kFull, s >= 0);
      s_start[lane] = s;
      if (lane == 0) s_mask = mask;
    }
    __syncthreads();
    for (unsigned mask = s_mask; mask != 0; mask &= mask - 1) {
      const int64_t s = s_start[__ffs(mask) - 1];
      const int64_t row = slid[s];
      if (share == 0) {
        const int64_t e = warp_first(slid, s + kLong, n, row, false, lane);
        if (lane == 0) s_end = e;
      }
      __syncthreads();
      const int64_t ks = s / kChunk;
      const int64_t pieces = (s_end - 1) / kChunk - ks + 1;
      // piece 0 is the first chunk's slot 0 or 1, piece i > 0 slot 0 of chunk ks + i
      const float* const first = partial + (2 * ks + (s == ks * kChunk ? 0 : 1)) * dim;
      const float* const later = partial + 2 * ks * dim;
      if constexpr (kRule == Rule::kAdam) {
        // lazy Adam: the row is touched when a column's sum is not zero,
        // which every column must know before any is written
        int nonzero = 0;
        for (int c0 = 0; c0 < dim; c0 += 32) {
          nonzero |= long_row_sum(first, later, pieces, dim, c0, share, lane, s_share) != 0.f;
        }
        if (!__syncthreads_or(nonzero)) continue;
      }
      for (int c0 = 0; c0 < dim; c0 += 32) {
        const float gk = long_row_sum(first, later, pieces, dim, c0, share, lane, s_share);
        if (share != 0 || c0 + lane >= dim) continue;
        const int64_t o = row * dim + c0 + lane;
        if constexpr (kRule == Rule::kAdagrad) {
          const float a = __fadd_rn(s1[o], __fmul_rn(gk, gk));
          s1[o] = a;
          const float inv = a > 0.f ? rsqrtf(__fadd_rn(a, h.eps)) : 0.f;
          param[o] = __fsub_rn(param[o], __fmul_rn(__fmul_rn(h.step[0], gk), inv));
        } else if constexpr (kRule == Rule::kSgd) {
          param[o] = __fsub_rn(param[o], __fmul_rn(h.step[0], gk));
        } else if constexpr (kRule == Rule::kAdam) {
          const float m_new = __fadd_rn(__fmul_rn(h.b1, s1[o]), __fmul_rn(h.one_minus_b1, gk));
          const float v_new = __fadd_rn(__fmul_rn(h.b2, s2[o]),
                                        __fmul_rn(__fmul_rn(h.one_minus_b2, gk), gk));
          const float num = __fmul_rn(h.step[0], __fmul_rn(m_new, h.step[1]));
          const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v_new, h.step[2])), h.eps);
          param[o] = __fsub_rn(param[o], __fdiv_rn(num, den));
          s1[o] = m_new;
          s2[o] = v_new;
        } else {
          param[o] = gk;
        }
      }
    }
  }
}

template <Rule kRule>
cudaError_t launch(const void* slid, const void* order, const void* ct, void* param,
                   void* s1, void* s2, int64_t n, int dim, const Hyper& h, void* stream,
                   void* partial, void* starts) {
  if (n <= 0 || dim <= 0) return cudaSuccess;
  // one warp a tile of 32 positions
  int64_t blocks = ((n + 31) / 32 + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the long path: one warp a chunk in pass 1, a block 32 chunks in pass 2
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  Long lng{static_cast<float*>(partial), static_cast<int64_t*>(starts),
           (chunks + kWarps - 1) / kWarps};
  if (lng.blocks > kMaxBlocks) lng.blocks = kMaxBlocks;
  int64_t long_blocks = (chunks + 31) / 32;
  if (long_blocks > kMaxBlocks) long_blocks = kMaxBlocks;
  const auto s = static_cast<cudaStream_t>(stream);
  sparse_rows_kernel<kRule><<<static_cast<unsigned>(blocks + lng.blocks), kThreads, 0, s>>>(
      static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
      static_cast<const float*>(ct), static_cast<float*>(param), static_cast<float*>(s1),
      static_cast<float*>(s2), n, dim, h, lng);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sparse_rows_long_kernel<kRule><<<static_cast<unsigned>(long_blocks), kThreads, 0, s>>>(
      static_cast<const int64_t*>(slid), static_cast<float*>(param), static_cast<float*>(s1),
      static_cast<float*>(s2), n, dim, h, lng.partial, lng.starts);
  return cudaGetLastError();
}

}  // namespace

// hyper: {lr} for Adagrad and SGD, {lr, bc1, bc2} for Adam, f32 in device
// memory. partial and starts: the long path's scratch, f32 [chunks, 2, dim]
// and int64 [chunks], chunks = ceil(n / 256), which the caller allocates
// and need not fill.
extern "C" int fused_adagrad_rows(const void* slid, const void* order, const void* ct,
                                  void* param, void* acc, void* partial, void* starts,
                                  long long n, int dim, const void* hyper, float eps,
                                  void* stream) {
  const Hyper h{0.f, eps, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, static_cast<const float*>(hyper)};
  return launch<Rule::kAdagrad>(slid, order, ct, param, acc, nullptr, n, dim, h, stream,
                                partial, starts);
}

extern "C" int fused_sgd_rows(const void* slid, const void* order, const void* ct,
                              void* param, void* partial, void* starts, long long n, int dim,
                              const void* hyper, void* stream) {
  const Hyper h{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, static_cast<const float*>(hyper)};
  return launch<Rule::kSgd>(slid, order, ct, param, nullptr, nullptr, n, dim, h, stream,
                            partial, starts);
}

extern "C" int scatter_add_rows(const void* slid, const void* order, const void* ct,
                                void* out, void* partial, void* starts, long long n, int dim,
                                void* stream) {
  const Hyper h{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, nullptr};
  return launch<Rule::kScatterAdd>(slid, order, ct, out, nullptr, nullptr, n, dim, h, stream,
                                   partial, starts);
}

extern "C" int fused_adam_rows(const void* slid, const void* order, const void* ct,
                               void* param, void* m, void* v, void* partial, void* starts,
                               long long n, int dim, const void* hyper, float b1, float b2,
                               float eps, float one_minus_b1, float one_minus_b2,
                               void* stream) {
  const Hyper h{0.f, eps, b1, b2, 0.f, 0.f, one_minus_b1, one_minus_b2,
                static_cast<const float*>(hyper)};
  return launch<Rule::kAdam>(slid, order, ct, param, m, v, n, dim, h, stream, partial,
                             starts);
}
