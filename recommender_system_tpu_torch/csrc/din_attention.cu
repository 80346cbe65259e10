// DIN target attention for Hopper (sm_90a): score every behaviour position
// of a row against the row's target with a 2-hidden-layer MLP over
// [q, k, q-k, q*k], mask, optionally softmax, then pool the keys (or return
// the weights).
//
// Replaces the TPU kernel _din_kernel / din_attention_fused in
// recommender_system_tpu/ops/pallas_kernels.py. Plain version:
// din_attention_ref in recommender_system_tpu_torch/ops/kernels.py.
//
// The first layer is folded as the plain version folds it,
//   concat([q, k, q-k, q*k]) W1 == q (Wq + Wm) + k (Wk - Wm) + (q*k) Wp,
// and once more per row: k (Wk - Wm) + (q*k) Wp == k W_q with
// W_q = (Wk - Wm) + diag(q) Wp, so a position costs K*H1 multiply-adds in
// the first layer instead of 2*K*H1, and a = q (Wq + Wm) is computed once
// per row. (The sums round differently from the plain version's, well
// inside the f32 tolerance.)
//
// Bound on the card: operations. At B=8192, T=50, K=32, H1=80, H2=40 the
// kernel does ~4.9 GFLOP of f32 work on 56 MB of input (about 90 flops per
// byte, far above the H100's ~20), outside the tensor cores (TF32 would
// not hold the f32 tolerance). So every operand of the MLP is kept in
// shared memory and the design works on the ratio of shared-memory loads
// to FMAs and on issue slots:
// - the folded weights (Wq+Wm, Wk-Wm, Wp, W2, biases, w3) are staged once
//   per block; blocks loop over groups of up to kMaxRows batch rows, and
//   stage each group's keys transposed, [K][T padded to 4], so that one
//   float4 broadcast load gives the key element k of kPositions positions;
// - one warp scores kPositions positions of one row at a time: lane j owns
//   hidden units j, j+32, ... (C1 of them in the first layer, C2 in the
//   second, both template parameters, so no unit is issued that the
//   widths do not need) and keeps kPositions x C accumulators in
//   registers, so one weight load feeds kPositions FMAs; the first layer's
//   output goes through a per-warp [H1][kPositions] buffer, written and
//   read back as float4; the score is a shuffle reduction over the lanes;
// - then one warp per row masks, takes the softmax (max subtracted) and
//   pools, or writes the weights.
// Everything is f32 with f32 accumulation. NEG_INF is the finite
// -(2**32)+1 of the reference: a row with no valid position gets weights
// of exactly 1/T.
//
// C interface, loaded with ctypes: din_attention_forward returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for sizes
// the kernel does not take (hidden widths past 32 * 8, shared memory past
// 227 KB); the Python wrapper checks shapes, types and devices first.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPositions = 4;  // positions a warp scores together (one float4)
constexpr int kMaxRows = 4;    // batch rows a block stages together
constexpr int kStageUnroll = 8;  // global loads in flight per thread while staging
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;
// at most this much per block keeps two blocks on an SM
constexpr size_t kTargetSharedBytes = 112 * 1024;
constexpr int kMaxBlocks = 132 * 2;
constexpr float kNegInf = -4294967295.0f;  // -(2**32) + 1
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int padded(int t) { return (t + kPositions - 1) / kPositions * kPositions; }

// Shared memory, in floats: keysT [rows][K][Tp] and the per-warp
// h1 [kWarps][H1][kPositions] first (float4 access), then W_q
// [rows][K][H1], the weights, and each row's q [K], mask [T], a [H1] and
// scores [T].
size_t shared_bytes(int T, int K, int H1, int H2, int rows) {
  const size_t per_row = static_cast<size_t>(K) * padded(T) + static_cast<size_t>(K) * H1
                         + K + 2 * T + H1;
  const size_t weights = 3 * static_cast<size_t>(K) * H1 + static_cast<size_t>(H1) * H2
                         + H1 + 2 * H2 + 1;
  return sizeof(float) * (rows * per_row + static_cast<size_t>(kWarps) * H1 * kPositions
                          + weights);
}

__device__ __forceinline__ float act(float x, bool relu) {
  return relu ? fmaxf(x, 0.f) : __frcp_rn(1.f + __expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, offset));
  return v;
}

// C1 = ceil(H1 / 32) and C2 = ceil(H2 / 32) hidden units per lane, or more
template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 2)
din_attention_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                     const float* __restrict__ mask, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out,
                     int batch, int T, int K, int H1, int H2, int rows, bool relu,
                     bool softmax, bool scores) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Tp = padded(T);
  const int KH = K * H1;
  float* keys_s = smem;                                       // [rows][K][Tp]
  float* h1_s = keys_s + static_cast<size_t>(rows) * K * Tp;  // [kWarps][H1][kPositions]
  float* wq_s = h1_s + kWarps * H1 * kPositions;              // [rows][K][H1]  W_q
  float* wqm = wq_s + rows * KH;                              // [K][H1]  Wq + Wm
  float* wkd = wqm + KH;                                      // [K][H1]  Wk - Wm
  float* wp = wkd + KH;                                       // [K][H1]
  float* w2_s = wp + KH;                                      // [H1][H2]
  float* b1_s = w2_s + H1 * H2;
  float* b2_s = b1_s + H1;
  float* w3_s = b2_s + H2;
  float* b3_s = w3_s + H2;
  float* q_s = b3_s + 1;                                      // [rows][K]
  float* mask_s = q_s + rows * K;                             // [rows][T]
  float* a_s = mask_s + rows * T;                             // [rows][H1]
  float* score_s = a_s + rows * H1;                           // [rows][T]

  for (int i = threadIdx.x; i < KH; i += kThreads) {
    const float wm = w1[2 * KH + i];
    wqm[i] = w1[i] + wm;
    wkd[i] = w1[KH + i] - wm;
    wp[i] = w1[3 * KH + i];
  }
  for (int i = threadIdx.x; i < H1 * H2; i += kThreads) w2_s[i] = w2[i];
  for (int i = threadIdx.x; i < H1; i += kThreads) b1_s[i] = b1[i];
  for (int i = threadIdx.x; i < H2; i += kThreads) {
    b2_s[i] = b2[i];
    w3_s[i] = w3[i];
  }
  if (threadIdx.x == 0) b3_s[0] = b3[0];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = Tp / kPositions;
  float* h1_w = h1_s + warp * H1 * kPositions;

  for (long long row0 = static_cast<long long>(blockIdx.x) * rows; row0 < batch;
       row0 += static_cast<long long>(gridDim.x) * rows) {
    const int nr = static_cast<int>(min(static_cast<long long>(rows), batch - row0));
    __syncthreads();  // weights staged; the previous group's tiles read out

    const float* q_g = query + row0 * K;
    for (int i = threadIdx.x; i < nr * K; i += kThreads) q_s[i] = q_g[i];
    const float* m_g = mask + row0 * T;
    for (int i = threadIdx.x; i < nr * T; i += kThreads) mask_s[i] = m_g[i];
    // keys: coalesced reads in [r][t][k] order, kStageUnroll in flight
    const float* k_g = keys + row0 * T * K;
    const int n = nr * T * K;
    for (int base = threadIdx.x; base < n; base += kThreads * kStageUnroll) {
      float v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = base + u * kThreads;
        v[u] = i < n ? k_g[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n) {
          const int rt = i / K;
          const int r = rt / T;
          keys_s[(static_cast<size_t>(r) * K + (i - rt * K)) * Tp + (rt - r * T)] = v[u];
        }
      }
    }
    for (int i = threadIdx.x; i < nr * K * (Tp - T); i += kThreads) {
      const int rk = i / (Tp - T);
      keys_s[static_cast<size_t>(rk) * Tp + T + (i - rk * (Tp - T))] = 0.f;
    }
    __syncthreads();

    // per row: a = q (Wq + Wm) and W_q = (Wk - Wm) + diag(q) Wp
    for (int rj = threadIdx.x; rj < nr * H1; rj += kThreads) {
      const int r = rj / H1;
      const int j = rj - r * H1;
      const float* q = q_s + r * K;
      float* wq = wq_s + r * KH;
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        const float qk = q[k];
        s = fmaf(qk, wqm[k * H1 + j], s);
        wq[k * H1 + j] = fmaf(qk, wp[k * H1 + j], wkd[k * H1 + j]);
      }
      a_s[rj] = s;
    }
    __syncthreads();

    // one warp scores kPositions positions of one row at a time
    for (int item = warp; item < nr * groups; item += kWarps) {
      const int r = item / groups;
      const int t0 = (item - r * groups) * kPositions;
      const float* kt = keys_s + static_cast<size_t>(r) * K * Tp + t0;
      const float* wq = wq_s + r * KH;

      float acc[C1][kPositions];
#pragma unroll
      for (int c = 0; c < C1; ++c) {
#pragma unroll
        for (int p = 0; p < kPositions; ++p) acc[c][p] = 0.f;
      }
      for (int k = 0; k < K; ++k) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + k * Tp);
#pragma unroll
        for (int c = 0; c < C1; ++c) {
          const int j = lane + 32 * c;
          const float w = j < H1 ? wq[k * H1 + j] : 0.f;
          acc[c][0] = fmaf(kv.x, w, acc[c][0]);
          acc[c][1] = fmaf(kv.y, w, acc[c][1]);
          acc[c][2] = fmaf(kv.z, w, acc[c][2]);
          acc[c][3] = fmaf(kv.w, w, acc[c][3]);
        }
      }
#pragma unroll
      for (int c = 0; c < C1; ++c) {
        const int j = lane + 32 * c;
        if (j < H1) {
          const float base = a_s[r * H1 + j];
          const float bias = b1_s[j];
          *reinterpret_cast<float4*>(h1_w + j * kPositions) = make_float4(
              act((base + acc[c][0]) + bias, relu), act((base + acc[c][1]) + bias, relu),
              act((base + acc[c][2]) + bias, relu), act((base + acc[c][3]) + bias, relu));
        }
      }
      __syncwarp();

      float acc2[C2][kPositions];
#pragma unroll
      for (int c = 0; c < C2; ++c) {
#pragma unroll
        for (int p = 0; p < kPositions; ++p) acc2[c][p] = 0.f;
      }
      for (int j = 0; j < H1; ++j) {
        const float4 h = *reinterpret_cast<const float4*>(h1_w + j * kPositions);
#pragma unroll
        for (int c = 0; c < C2; ++c) {
          const int i = lane + 32 * c;
          const float w = i < H2 ? w2_s[j * H2 + i] : 0.f;
          acc2[c][0] = fmaf(h.x, w, acc2[c][0]);
          acc2[c][1] = fmaf(h.y, w, acc2[c][1]);
          acc2[c][2] = fmaf(h.z, w, acc2[c][2]);
          acc2[c][3] = fmaf(h.w, w, acc2[c][3]);
        }
      }
      float part[kPositions] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        const int i = lane + 32 * c;
        if (i < H2) {
          const float bias = b2_s[i];
          const float w = w3_s[i];
#pragma unroll
          for (int p = 0; p < kPositions; ++p)
            part[p] = fmaf(act(acc2[c][p] + bias, relu), w, part[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPositions; ++p) part[p] = warp_sum(part[p]);
      if (lane == 0) {
#pragma unroll
        for (int p = 0; p < kPositions; ++p)
          if (t0 + p < T) score_s[r * T + t0 + p] = part[p] + b3_s[0];
      }
      __syncwarp();  // h1_w is rewritten by the warp's next item
    }
    __syncthreads();

    // mask, softmax and output: one warp per row
    for (int r = warp; r < nr; r += kWarps) {
      float* s = score_s + r * T;
      const float* m = mask_s + r * T;
      const long long row = row0 + r;
      if (softmax) {
        float mx = -INFINITY;
        for (int t = lane; t < T; t += 32) {
          const float v = m[t] > 0.5f ? s[t] : kNegInf;
          s[t] = v;
          mx = fmaxf(mx, v);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int t = lane; t < T; t += 32) {
          const float e = expf(s[t] - mx);
          s[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int t = lane; t < T; t += 32) s[t] = s[t] / sum;
      } else {
        for (int t = lane; t < T; t += 32) s[t] = m[t] > 0.5f ? s[t] : 0.f;
      }
      __syncwarp();
      if (scores) {
        for (int t = lane; t < T; t += 32) out[row * T + t] = s[t];
      } else {
        const float* kr = keys_s + static_cast<size_t>(r) * K * Tp;
        for (int k = lane; k < K; k += 32) {
          float pooled = 0.f;
          for (int t = 0; t < T; ++t) pooled = fmaf(s[t], kr[k * Tp + t], pooled);
          out[row * K + k] = pooled;
        }
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*,
                        const float*, float*, int, int, int, int, int, int, bool, bool,
                        bool);

// hidden units per lane that have an instantiation; a width rounds up
constexpr int kUnits[] = {1, 2, 3, 4, 8};
constexpr int kNumUnits = 5;

#define DIN_ROW(c1)                                                           \
  {din_attention_kernel<c1, 1>, din_attention_kernel<c1, 2>,                  \
   din_attention_kernel<c1, 3>, din_attention_kernel<c1, 4>,                  \
   din_attention_kernel<c1, 8>}
// indexed [C1 slot][C2 slot] over kUnits
const Kernel kKernels[kNumUnits][kNumUnits] = {DIN_ROW(1), DIN_ROW(2), DIN_ROW(3),
                                               DIN_ROW(4), DIN_ROW(8)};
#undef DIN_ROW

int unit_slot(int width) {
  const int need = (width + 31) / 32;
  for (int s = 0; s < kNumUnits; ++s)
    if (kUnits[s] >= need) return s;
  return -1;
}

}  // namespace

extern "C" int din_attention_forward(const float* query, const float* keys,
                                     const float* mask, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, const float* w3,
                                     const float* b3, float* out, int batch, int T,
                                     int K, int H1, int H2, int relu, int softmax,
                                     int scores, void* stream) {
  const int s1 = unit_slot(H1);
  const int s2 = unit_slot(H2);
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0 || s1 < 0 || s2 < 0) {
    return cudaErrorInvalidValue;
  }
  int rows = kMaxRows;
  while (rows > 1 && shared_bytes(T, K, H1, H2, rows) > kTargetSharedBytes) --rows;
  const size_t smem = shared_bytes(T, K, H1, H2, rows);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const Kernel kernel = kKernels[s1][s2];
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  long long blocks = (static_cast<long long>(batch) + rows - 1) / rows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kernel<<<static_cast<int>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      query, keys, mask, w1, b1, w2, b2, w3, b3, out, batch, T, K, H1, H2, rows,
      relu != 0, softmax != 0, scores != 0);
  return cudaGetLastError();
}
