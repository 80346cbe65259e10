// FM logit for Hopper (sm_90a), without the global bias:
//
//   out[b] = x[b].w1 + 0.5 * sum_j ((x[b].v[:, j])^2 - (x[b]^2).(v[:, j]^2))
//
// for x [B, D], w1 [D, 1], v [D, k], out [B, 1], all f32.
//
// Replaces the TPU kernel _fm_kernel / fm_fused in
// recommender_system_tpu/ops/pallas_kernels.py (a 512-row VMEM tile and
// three matrix products). Plain version: fm_ref in
// recommender_system_tpu_torch/ops/kernels.py (x @ w1 + fm_interaction).
//
// Bound on the card: device memory. The function reads x once (B*D*4
// bytes: 14.5 MB at B=16,384, D=221), the small w1 and v once, and writes
// B*4 bytes; it does about 4*B*D*k + 2*B*D flops, under two flops per byte
// at k=8, far below the H100's f32 ratio of ~20 flops per byte. So the
// design reads x exactly once, coalesced, and keeps x.v and x^2.v^2 out of
// device memory: one warp owns one batch row, lane l reads x[b, l], x[b,
// l+32], ... and keeps partial sums of x.w1 and, for a chunk of kChunk
// factor columns, of x.v[:, j] and x^2.v^2[:, j] in registers; a
// __shfl_xor_sync butterfly gives every lane the row's sums. Factor counts
// above kChunk loop over chunks, each reading the row again (from L1; at
// k <= kChunk the row is read once). v, v*v (both transposed to [k][D], so
// that the 32 lanes read 32 consecutive words: no bank conflicts) and w1 are
// staged once per block in shared memory, (2k + 1)*D*4 bytes, opted in past
// 48 KB. Blocks loop over rows, so the staging is repeated at most
// kMaxBlocks times. f32 with f32 accumulation, v*v and x*x rounded as the
// plain version rounds them; the sums are taken in another order than
// cuBLAS's.
//
// C interface, loaded with ctypes: fm_forward returns cudaGetLastError()
// after the launch; the Python wrapper checks shapes, types, devices and
// the shared memory the shape needs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kChunk = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) s += __shfl_xor_sync(kFull, s, offset);
  return s;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fm_kernel(const float* __restrict__ x, const float* __restrict__ w1,
          const float* __restrict__ v, float* __restrict__ out, int batch, int dim,
          int factors) {
  extern __shared__ float smem[];
  float* vt = smem;                           // [factors][dim]
  float* v2t = smem + factors * dim;          // [factors][dim], v*v
  float* w_s = smem + 2 * factors * dim;      // [dim]
  const int n = factors * dim;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int d = e / factors;  // v is [dim][factors]: coalesced reads
    const int j = e - d * factors;
    const float ve = v[e];
    vt[j * dim + d] = ve;
    v2t[j * dim + d] = __fmul_rn(ve, ve);
  }
  for (int d = threadIdx.x; d < dim; d += blockDim.x) w_s[d] = w1[d];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The whole warp shares one row, so the row test never splits a warp and
  // the full-mask shuffles below are safe.
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp; row < batch;
       row += static_cast<int64_t>(gridDim.x) * kWarpsPerBlock) {
    const float* xr = x + row * dim;
    float linear = 0.f;
    for (int d = lane; d < dim; d += 32) linear = fmaf(xr[d], w_s[d], linear);
    float pair = 0.f;  // sum over the factors of (x.v_j)^2 - x^2.v_j^2
    for (int c0 = 0; c0 < factors; c0 += kChunk) {
      float s[kChunk], q[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = q[j] = 0.f;
      for (int d = lane; d < dim; d += 32) {
        const float xd = xr[d];
        const float x2 = __fmul_rn(xd, xd);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (c0 + j < factors) {
            s[j] = fmaf(xd, vt[(c0 + j) * dim + d], s[j]);
            q[j] = fmaf(x2, v2t[(c0 + j) * dim + d], q[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < factors) {  // the same for every lane
          const float sj = warp_sum(s[j]);
          const float qj = warp_sum(q[j]);
          pair += sj * sj - qj;
        }
      }
    }
    linear = warp_sum(linear);
    if (lane == 0) out[row] = linear + 0.5f * pair;
  }
}

}  // namespace

extern "C" int fm_forward(const void* x, const void* w1, const void* v, void* out,
                          int batch, int dim, int factors, void* stream) {
  if (batch <= 0) return cudaSuccess;
  const size_t shared_bytes = (2 * static_cast<size_t>(factors) + 1) * dim * sizeof(float);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return err;
  }
  int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fm_kernel<<<blocks, kWarpsPerBlock * 32, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(v), static_cast<float*>(out), batch, dim, factors);
  return cudaGetLastError();
}
