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
// The scatter-add, Adagrad and SGD are independent per column: thread t
// takes position i = t / dim and column col = t % dim (a warp is 32
// (position, column) pairs, so a 9-wide row does not leave 23 of 32 lanes
// idle). A thread whose position starts a segment (i == 0 or slid[i] !=
// slid[i-1]) finds the segment's end by a galloping search over slid (one
// load when the segment has one position, as most do), sums its column over
// the segment and writes the row's element; every other thread stops after
// two loads. Lazy Adam must see the whole row before it writes any column,
// and the dim threads of one position straddle warps when 32 % dim != 0,
// so it takes one warp per position instead: lane l sums column c0 + l for
// c0 = 0, 32, ..., the warp votes (__any_sync) whether any column's sum is
// non-zero, and only then updates the row, each chunk of 32 columns summed
// again if dim > 32 (the same sum in the same order). A hot row is one long
// serial sum for its dim threads, or for its one warp: right, but slow (see
// PERF.md).
//
// Bound on the card: device memory. Each rule must read slid and order (8
// bytes a position: rows and positions fit int32) and the N*dim*4 bytes of
// ct; Adagrad reads and writes param and acc on the U touched rows
// (16*U*dim bytes), SGD param (8*U*dim), Adam param, m and v (24*U*dim);
// the scatter-add writes the whole [rows, dim] output (the caller's zero
// fill plus the touched rows). Each does a few flops per byte. The design
// reads each stream element once (the threads of a position share its slid
// and order loads through L1) and touches each touched row once (Adam's
// rows wider than 32 columns: their cotangents twice); the cotangent rows
// are gathered in sorted order, dim*4 bytes each. The stream is int64 here,
// as the sort gives it: 8 bytes a position more than the bound counts.
// Every rule rounds as its plain version does: _rn intrinsics keep nvcc from
// contracting a multiply and an add into one fused multiply-add.
//
// C interface, loaded with ctypes: each function returns cudaGetLastError()
// after the launch; the Python wrapper checks shapes, types and devices.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// threads loop past this many blocks: 16 resident blocks on each of the
// H100's 132 SMs, a few waves
constexpr int64_t kMaxBlocks = 132 * 16 * 8;
constexpr unsigned kFull = 0xffffffffu;

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

// Column col of the segment [i, end): the sum of its cotangents in stream
// order.
__device__ __forceinline__ float column_sum(const int64_t* __restrict__ order,
                                            const float* __restrict__ ct, int64_t i,
                                            int64_t end, int dim, int col) {
  float g = 0.f;
#pragma unroll 8
  for (int64_t j = i; j < end; ++j) {
    g = __fadd_rn(g, ct[order[j] * dim + col]);
  }
  return g;
}

template <Rule kRule>
__global__ void __launch_bounds__(kThreads)
sparse_rows_kernel(const int64_t* __restrict__ slid, const int64_t* __restrict__ order,
                   const float* __restrict__ ct, float* __restrict__ param,
                   float* __restrict__ acc, int64_t n, int dim, float lr, float eps) {
  const int64_t total = n * dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / dim;
    const int col = static_cast<int>(t - i * dim);
    const int64_t row = slid[i];
    if (i > 0 && slid[i - 1] == row) continue;
    const float g = column_sum(order, ct, i, segment_end(slid, i, n, row), dim, col);
    const int64_t o = row * dim + col;
    if constexpr (kRule == Rule::kAdagrad) {
      // the plain version's order of operations, with no fused multiply-add
      const float a = __fadd_rn(acc[o], __fmul_rn(g, g));
      acc[o] = a;
      const float inv = a > 0.f ? rsqrtf(__fadd_rn(a, eps)) : 0.f;
      param[o] = __fsub_rn(param[o], __fmul_rn(__fmul_rn(lr, g), inv));
    } else if constexpr (kRule == Rule::kSgd) {
      param[o] = __fsub_rn(param[o], __fmul_rn(lr, g));
    } else {
      param[o] = g;
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
      const float g = col < dim ? column_sum(order, ct, i, end, dim, col) : 0.f;
      if (c0 == 0) g0 = g;
      touched = __any_sync(kFull, g != 0.f);
    }
    if (!touched) continue;
    for (int c0 = 0; c0 < dim; c0 += 32) {
      const int col = c0 + lane;
      if (col >= dim) continue;
      const float g = c0 == 0 ? g0 : column_sum(order, ct, i, end, dim, col);
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
  const int64_t total = n * dim;
  if (total <= 0) return cudaSuccess;
  sparse_rows_kernel<kRule><<<grid_for(total), kThreads, 0, stream>>>(
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
