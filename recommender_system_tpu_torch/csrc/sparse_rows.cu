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
// The scatter-add, Adagrad and SGD are independent per column: the tile
// walk. A first version gave each thread one (position, column) pair: every
// one of a position's dim threads loaded slid[i] and slid[i-1] (about 4*dim
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
// Lazy Adam must see the whole row before it writes any column, so it takes
// one warp per position instead: lane l sums column c0 + l for c0 = 0, 32,
// ..., the warp votes (__any_sync) whether any column's sum is non-zero, and
// only then updates the row, each chunk of 32 columns summed again if
// dim > 32 (the same sum in the same order).
//
// Every rule sums a row's column from 0.f in stream order with __fadd_rn,
// so its results do not depend on the launch. A hot row is one long serial
// sum for the dim lanes that own its (start, column) elements, or for its
// one warp: right, but slow (see PERF.md).
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
// (start, column) elements whose loads a lane starts before its first store
constexpr int kBatch = 4;

enum class Rule { kScatterAdd, kAdagrad, kSgd };

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

// The tile walk (see the note at the top): one warp a tile of 32 stream
// positions, grid-stride over tiles.
template <Rule kRule>
__global__ void __launch_bounds__(kThreads)
sparse_rows_kernel(const int64_t* __restrict__ slid, const int64_t* __restrict__ order,
                   const float* __restrict__ ct, float* __restrict__ param,
                   float* __restrict__ acc, int64_t n, int dim, float lr, float eps) {
  // per warp: the tile's order by lane; its segments' row, first order,
  // end (a stream position) and first lane by rank
  __shared__ int64_t s_order[kThreads];
  __shared__ int64_t s_row[kThreads];
  __shared__ int64_t s_first[kThreads];
  __shared__ int64_t s_end[kThreads];
  __shared__ int s_begin[kThreads];
  const int lane = threadIdx.x & 31;
  const int base = threadIdx.x & ~31;
  int64_t* const w_order = s_order + base;
  int64_t* const r_row = s_row + base;
  int64_t* const r_first = s_first + base;
  int64_t* const r_end = s_end + base;
  int* const r_begin = s_begin + base;
  // a lane's elements l, l + 32, ... as (rank, column): 32 = q32 * dim + r32
  const int q32 = 32 / dim;
  const int r32 = 32 - q32 * dim;
  const int j0 = lane / dim;
  const int c0 = lane - j0 * dim;

  const int64_t tiles = (n + 31) / 32;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += static_cast<int64_t>(gridDim.x) * kWarps) {
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
    if (start) {
      const int rank = __popc(starts & ((1u << lane) - 1u));
      const unsigned later = lane == 31 ? 0u : starts >> (lane + 1);
      int64_t end = p + __ffs(later);  // the next start
      if (later == 0) end = runs_on ? segment_end(slid, p0 + 32, n, row) : p0 + count;
      r_row[rank] = row;
      r_first[rank] = ord;
      r_end[rank] = end;
      r_begin[rank] = lane;
    }
    __syncwarp();

    int j = j0, col = c0;
    while (j < segments) {
      // every load of kBatch elements first: ct at each segment's first
      // position, and the table entries the rule reads
      int jk[kBatch], ck[kBatch];
      int64_t o[kBatch];
      float g[kBatch], pk[kBatch], ak[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        jk[k] = j;
        ck[k] = col;
        if (j < segments) {
          o[k] = r_row[j] * dim + col;
          g[k] = ct[r_first[j] * dim + col];
          if constexpr (kRule != Rule::kScatterAdd) pk[k] = param[o[k]];
          if constexpr (kRule == Rule::kAdagrad) ak[k] = acc[o[k]];
        }
        j += q32;
        col += r32;
        if (col >= dim) {
          col -= dim;
          ++j;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (jk[k] >= segments) break;
        const int c = ck[k];
        float gk = __fadd_rn(0.f, g[k]);
        const int64_t first = p0 + r_begin[jk[k]];
        const int64_t end = r_end[jk[k]];
        if (end - first > 1) {
          const int64_t inside = end < p0 + 32 ? end : p0 + 32;
          for (int64_t q = first + 1; q < inside; ++q) {
            gk = __fadd_rn(gk, ct[w_order[q - p0] * dim + c]);
          }
          gk = column_sum(gk, order, ct, inside, end, dim, c);
        }
        if constexpr (kRule == Rule::kAdagrad) {
          // the plain version's order of operations, with no fused multiply-add
          const float a = __fadd_rn(ak[k], __fmul_rn(gk, gk));
          acc[o[k]] = a;
          const float inv = a > 0.f ? rsqrtf(__fadd_rn(a, eps)) : 0.f;
          param[o[k]] = __fsub_rn(pk[k], __fmul_rn(__fmul_rn(lr, gk), inv));
        } else if constexpr (kRule == Rule::kSgd) {
          param[o[k]] = __fsub_rn(pk[k], __fmul_rn(lr, gk));
        } else {
          param[o[k]] = gk;
        }
      }
    }
  }
}

struct AdamHyper {
  float lr, b1, b2, eps, bc1, bc2;
  float one_minus_b1, one_minus_b2;  // 1 - b rounded once from double, as the plain version
};

__global__ void __launch_bounds__(kThreads)
lazy_adam_rows_kernel(const int64_t* __restrict__ slid, const int64_t* __restrict__ order,
                      const float* __restrict__ ct, float* __restrict__ param,
                      float* __restrict__ m, float* __restrict__ v, int64_t n, int dim,
                      AdamHyper h) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  // Every lane of a warp has the same position i, so each branch on i, on
  // its segment or on the vote is taken by the whole warp, and the
  // full-mask vote is safe.
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
       i < n; i += warps) {
    const int64_t row = slid[i];
    if (i > 0 && slid[i - 1] == row) continue;
    const int64_t end = segment_end(slid, i, n, row);
    float g0 = 0.f;
    bool touched = false;
    for (int c0 = 0; c0 < dim && !touched; c0 += 32) {
      const int col = c0 + lane;
      const float g = col < dim ? column_sum(0.f, order, ct, i, end, dim, col) : 0.f;
      if (c0 == 0) g0 = g;
      touched = __any_sync(kFull, g != 0.f);
    }
    if (!touched) continue;
    for (int c0 = 0; c0 < dim; c0 += 32) {
      const int col = c0 + lane;
      if (col >= dim) continue;
      const float g = c0 == 0 ? g0 : column_sum(0.f, order, ct, i, end, dim, col);
      const int64_t o = row * dim + col;
      // fused_adam_ref's order of operations, with no fused multiply-add
      const float m_new = __fadd_rn(__fmul_rn(h.b1, m[o]), __fmul_rn(h.one_minus_b1, g));
      const float v_new = __fadd_rn(__fmul_rn(h.b2, v[o]),
                                    __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
      const float num = __fmul_rn(h.lr, __fmul_rn(m_new, h.bc1));
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v_new, h.bc2)), h.eps);
      param[o] = __fsub_rn(param[o], __fdiv_rn(num, den));
      m[o] = m_new;
      v[o] = v_new;
    }
  }
}

unsigned grid_for(int64_t threads) {
  int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

template <Rule kRule>
cudaError_t launch(const int64_t* slid, const int64_t* order, const float* ct,
                   float* param, float* acc, int64_t n, int dim, float lr, float eps,
                   cudaStream_t stream) {
  if (n <= 0 || dim <= 0) return cudaSuccess;
  // one warp a tile of 32 positions
  sparse_rows_kernel<kRule><<<grid_for((n + 31) / 32 * 32), kThreads, 0, stream>>>(
      slid, order, ct, param, acc, n, dim, lr, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_adagrad_rows(const void* slid, const void* order, const void* ct,
                                  void* param, void* acc, long long n, int dim,
                                  float lr, float eps, void* stream) {
  return launch<Rule::kAdagrad>(
      static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
      static_cast<const float*>(ct), static_cast<float*>(param), static_cast<float*>(acc),
      n, dim, lr, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_sgd_rows(const void* slid, const void* order, const void* ct,
                              void* param, long long n, int dim, float lr, void* stream) {
  return launch<Rule::kSgd>(
      static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
      static_cast<const float*>(ct), static_cast<float*>(param), nullptr, n, dim, lr, 0.f,
      static_cast<cudaStream_t>(stream));
}

extern "C" int scatter_add_rows(const void* slid, const void* order, const void* ct,
                                void* out, long long n, int dim, void* stream) {
  return launch<Rule::kScatterAdd>(
      static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
      static_cast<const float*>(ct), static_cast<float*>(out), nullptr, n, dim, 0.f, 0.f,
      static_cast<cudaStream_t>(stream));
}

extern "C" int fused_adam_rows(const void* slid, const void* order, const void* ct,
                               void* param, void* m, void* v, long long n, int dim,
                               float lr, float b1, float b2, float eps, float bc1, float bc2,
                               float one_minus_b1, float one_minus_b2, void* stream) {
  if (n <= 0 || dim <= 0) return cudaSuccess;
  const AdamHyper h{lr, b1, b2, eps, bc1, bc2, one_minus_b1, one_minus_b2};
  lazy_adam_rows_kernel<<<grid_for(n * 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
      static_cast<const float*>(ct), static_cast<float*>(param), static_cast<float*>(m),
      static_cast<float*>(v), n, dim, h);
  return cudaGetLastError();
}
