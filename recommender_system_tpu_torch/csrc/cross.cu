// DCN cross stack for Hopper (sm_90a): x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
// for l = 0..L-1, out = x_L.
//
// Replaces the TPU kernel _cross_kernel / cross_fused in
// recommender_system_tpu/ops/pallas_kernels.py (one Pallas kernel for the
// whole L-layer stack). Plain version: cross_network in
// recommender_system_tpu_torch/ops/interactions.py.
//
// Bound on the card: device memory. The stack reads x0 once (B*D*4 bytes)
// and writes the result once (B*D*4 bytes), plus 2*L*D*4 bytes of weights
// and biases; it does 5*B*D*L flops, about one flop per byte moved, far
// below the H100's f32 ratio of ~20 flops per byte. So the design keeps
// every intermediate x_l out of device memory: one warp owns one batch row,
// each lane keeps its ceil(D/32) elements of x0 and x in registers (lane j
// holds elements j, j+32, ...), loads and stores are coalesced 128-byte
// rows, and the L layers run entirely in registers. Per layer each lane
// forms a partial dot with w_l, a __shfl_xor_sync butterfly hands every lane
// the full s = x_l . w_l, and the lane updates its elements. Weights and
// biases are staged once per block in shared memory (2*L*D*4 bytes).
// Everything is f32 with f32 accumulation.
//
// C interface, loaded with ctypes: cross_forward returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a D the templates do not
// cover); the Python wrapper checks shapes, types and devices first.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
// Blocks loop over rows past this many, so the weights are staged at most
// kMaxBlocks times: 8 resident blocks on each of the H100's 132 SMs.
constexpr int kMaxBlocks = 132 * 8;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <int kPerLane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cross_stack_kernel(const float* __restrict__ x0, const float* __restrict__ weights,
                   const float* __restrict__ biases, float* __restrict__ out,
                   int batch, int dim, int layers) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* b_s = smem + layers * dim;
  const int n = layers * dim;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    w_s[i] = weights[i];
    b_s[i] = biases[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The whole warp shares one row, so the row test never splits a warp and
  // the full-mask shuffles below are safe.
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < batch;
       row += gridDim.x * kWarpsPerBlock) {
    const float* x0_row = x0 + static_cast<size_t>(row) * dim;
    float a[kPerLane];
    float x[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      a[k] = j < dim ? x0_row[j] : 0.f;
      x[k] = a[k];
    }
    for (int l = 0; l < layers; ++l) {
      const float* w = w_s + l * dim;
      const float* b = b_s + l * dim;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < dim) s = fmaf(x[k], w[j], s);
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, offset);
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < dim) x[k] = a[k] * s + b[j] + x[k];
      }
    }
    float* out_row = out + static_cast<size_t>(row) * dim;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < dim) out_row[j] = x[k];
    }
  }
}

template <int kPerLane>
cudaError_t launch(const float* x0, const float* weights, const float* biases,
                   float* out, int batch, int dim, int layers,
                   cudaStream_t stream) {
  const size_t shared_bytes = 2 * static_cast<size_t>(layers) * dim * sizeof(float);
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_stack_kernel<kPerLane>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return err;
  }
  int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cross_stack_kernel<kPerLane><<<blocks, kWarpsPerBlock * 32, shared_bytes, stream>>>(
      x0, weights, biases, out, batch, dim, layers);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cross_forward(const float* x0, const float* weights,
                             const float* biases, float* out, int batch,
                             int dim, int layers, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= 256) return launch<8>(x0, weights, biases, out, batch, dim, layers, s);
  if (dim <= 512) return launch<16>(x0, weights, biases, out, batch, dim, layers, s);
  if (dim <= 1024) return launch<32>(x0, weights, biases, out, batch, dim, layers, s);
  return cudaErrorInvalidValue;
}
