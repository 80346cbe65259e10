// Row updates from a sorted id stream, for Hopper (sm_90a). Input: the
// stream (slid, order) of N positions, slid sorted and slid[j] the row of
// the cotangent ct[order[j], :]; ct is [N', dim] f32. For every row r that
// the stream touches, G[r] = the sum of ct[order[j], :] over the positions
// j with slid[j] == r, taken in the order of j, in f32. Then
//
//   fused_adagrad_rows: in place on param and acc [rows, dim] f32,
//     acc[r] += G*G;  param[r] -= lr * G * rsqrt(acc[r] + eps) where
//     acc[r] > 0 (optax's scale_by_rss with duplicates summed first);
//   scatter_add_rows: out[r] = G (out [rows, dim], zero-filled by the caller).
//
// Rows that the stream does not touch are not read or written.
//
// Replaces two TPU kernels of recommender_system_tpu/ops:
// fused_adagrad.py _fused_adagrad_kernel (its single-stream path) and
// embedding_grad.py _queue_kernel. Plain versions: fused_adagrad_ref and
// scatter_add_dense_ref in recommender_system_tpu_torch/ops/.
//
// The TPU kernels run a sequential grid over a (subtile, chunk) work queue
// and turn each chunk into a one-hot matrix product, since the TPU has no
// scatter. Here blocks run in parallel, so the design only makes sure that
// no two threads write the same element, with no atomics, deterministic:
// thread t takes position i = t / dim and column col = t % dim (a warp is
// 32 (position, column) pairs, so a 9-wide row does not leave 23 of 32 lanes
// idle). A thread whose position starts a segment (i == 0 or slid[i] !=
// slid[i-1]) finds the segment's end by a galloping search over slid (one
// load when the segment has one position, as most do), sums its column over
// the segment and writes the row's element; every other thread stops after
// two loads. A hot row is one long serial sum for its dim threads: right,
// but slow (see PERF.md).
//
// Bound on the card: device memory. fused_adagrad_rows must read slid and
// order (8 bytes a position: rows and positions fit int32), the N*dim*4
// bytes of ct, and read and write param and acc on the U touched rows
// (16*U*dim bytes); scatter_add_rows reads the same stream and writes the
// whole [rows, dim] output (the caller's zero fill plus the touched rows).
// Each does a few flops per byte. The design reads each stream element once
// (the dim threads of a position share its slid and order loads through L1)
// and touches each touched row once; the cotangent rows are gathered in
// sorted order, dim*4 bytes each. The stream is int64 here, as the sort
// gives it: 8 bytes a position more than the bound counts.
//
// C interface, loaded with ctypes: each function returns cudaGetLastError()
// after the launch; the Python wrapper checks shapes, types and devices.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

template <bool kAdagrad>
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
    const int64_t end = segment_end(slid, i, n, row);
    float g = 0.f;
#pragma unroll 8
    for (int64_t j = i; j < end; ++j) {
      g = __fadd_rn(g, ct[order[j] * dim + col]);
    }
    const int64_t o = row * dim + col;
    if constexpr (kAdagrad) {
      // the plain version's order of operations, with no fused multiply-add
      const float a = __fadd_rn(acc[o], __fmul_rn(g, g));
      acc[o] = a;
      const float inv = a > 0.f ? rsqrtf(__fadd_rn(a, eps)) : 0.f;
      param[o] = __fsub_rn(param[o], __fmul_rn(__fmul_rn(lr, g), inv));
    } else {
      param[o] = g;
    }
  }
}

template <bool kAdagrad>
cudaError_t launch(const int64_t* slid, const int64_t* order, const float* ct,
                   float* param, float* acc, int64_t n, int dim, float lr, float eps,
                   cudaStream_t stream) {
  const int64_t total = n * dim;
  if (total <= 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  // threads loop past this many blocks: 16 resident blocks on each of the
  // H100's 132 SMs, a few waves
  constexpr int64_t kMaxBlocks = 132 * 16 * 8;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sparse_rows_kernel<kAdagrad><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      slid, order, ct, param, acc, n, dim, lr, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_adagrad_rows(const void* slid, const void* order, const void* ct,
                                  void* param, void* acc, long long n, int dim,
                                  float lr, float eps, void* stream) {
  return launch<true>(static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
                      static_cast<const float*>(ct), static_cast<float*>(param),
                      static_cast<float*>(acc), n, dim, lr, eps,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int scatter_add_rows(const void* slid, const void* order, const void* ct,
                                void* out, long long n, int dim, void* stream) {
  return launch<false>(static_cast<const int64_t*>(slid), static_cast<const int64_t*>(order),
                       static_cast<const float*>(ct), static_cast<float*>(out), nullptr,
                       n, dim, 0.f, 0.f, static_cast<cudaStream_t>(stream));
}
