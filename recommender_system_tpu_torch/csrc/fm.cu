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
// at k=8, far below the H100's f32 ratio of ~20 flops per byte.
//
// The first design (fm_wide_kernel below, kept for the shapes the register
// kernel does not take) gave a warp one row: per element of x a lane made
// 17 shared-memory loads (w1, v and v*v for 8 factors) and per row the warp
// ran 17 five-step butterflies (85 shuffles), ~200 shared-memory
// instructions a row; and each of up to 1,056 blocks staged v, v*v and w1
// again, 15.9 MB through L2 at the FMLayer shape, more than x itself. It ran
// at 16 % of the bound, held back by issue, not by memory.
//
// fm_rows_kernel, for D <= 256 and k <= 8 (the FMLayer path's D=221, k=8):
// - the arithmetic is folded: sum_j x_d^2 v_dj^2 = x_d^2 * vv_d with
//   vv_d = sum_j v_dj^2, so with a_d = w1_d and c_d = -vv_d / 2 the logit is
//   sum_d x_d * (a_d + c_d x_d) + 0.5 * sum_j s_j^2, s_j = x.v[:, j]: 9 sums
//   a row instead of 17, 10 FMAs an element instead of 17;
// - lane l owns columns l, l+32, ... (kPerLane of them, a template) and holds
//   their v (zero past k and D), a and c in registers for every row it
//   serves; a persistent grid of one block an SM forms them once per block
//   (v transposed through shared memory, ~1 MB through L2 in all);
// - a warp takes kRows = 4 rows at once, and their 36 partial sums go through
//   one reduce-scatter butterfly: the offsets 16 and 8 split the rows, 4, 2
//   and 1 the factors (t in a plain butterfly), then s_j^2 is summed over the
//   8 lanes that hold a row's s_j: 40 shuffles for 4 rows, 10 a row;
// - x stays in flight: a block issues its warps' first rows before it
//   stages v, and each warp issues its next rows' loads as soon as its
//   FMAs are done, before its shuffles; 12 warps an SM keep ~42 KB of x
//   in flight.
// Every value is summed over the lanes in the order 16, 8, 4, 2, 1, as a
// plain butterfly sums it (tests/test_torch_fm.py emulates the kernel's
// order on the CPU). f32 with f32 accumulation; the sums are taken in
// another order than cuBLAS's.
//
// What holds it back now (chip_lab_fm_cross.py on an NVIDIA H100 80GB HBM3
// at 700 W): x's loads. At 0.0076-0.0078 ms it is within 1.2x of
// torch.sum(x, 1), which reads the same bytes; issuing the next rows' loads
// after the shuffles costs 0.0083-0.0084 ms, 16 warps a block (128
// registers, spills) 0.0115-0.0119 ms, 8 warps 0.0074-0.0079 ms.
//
// fm_global_kernel takes the shapes whose v, v*v and w1 do not fit in a
// block's shared memory (4*D*(2k + 1) bytes past 227 KB: D past 3,418 at
// k=8, past 1,499 at k=19). Its first design was the wide kernel with v,
// v*v and w1 read through L1 and L2: k loads of v, k products v*v and 2k + 1
// FMAs an element of x, and 2k + 1 butterflies a row, at 23 % of the bound
// at x [16,384, 4,000], k=8. Now:
// - a small first kernel (fm_global_kernel_coefficients) folds w1 and v
//   once a call into a scratch buffer the wrapper allocates:
//   [groups of 8 factors][a, c, v_0..v_7][D rounded up to 128], so an
//   element costs k + 2 FMAs and a row keeps k + 1 running sums, as in the
//   rows kernel;
// - a persistent grid (the blocks resident at once, 2 an SM) walks tiles of
//   32 rows, a warp 4 of them, and each tile's columns in chunks of 128: a
//   lane owns columns 4l..4l+3 of a chunk and reads them, and the chunk's
//   coefficients, 16 bytes at a time from shared memory, each coefficient
//   serving the warp's 4 rows;
// - the x tile [32][128] and the chunk's coefficients arrive by cp.async
//   in a ring of 4 stages, 3 chunks ahead, across the tiles' boundaries (16
//   bytes a copy where D % 4 == 0 and x is 16-byte aligned, else 4: a row
//   of D % 4 != 0 floats starts off 16-byte alignment); a thread copies
//   the same column of every 8th (every 2nd) row, its addresses a step
//   apart; columns past D and rows past the batch are zero-filled;
// - each row's sums stay in registers across the chunks, and one
//   reduce-scatter butterfly per tile and factor group (the rows kernel's)
//   ends them. Factors past 8 take one more pass over the tile per group
//   of 8 (its a and c zero).
// A lane sums its columns in order (chunk by chunk, 4l..4l+3 in each),
// then the lanes in the order 16, 8, 4, 2, 1, the factors' s_j^2 in the
// order 4, 2, 1, the groups in order; out = fma(0.5, sq, t)
// (tests/test_torch_fm.py emulates it). Against the exact value (the plain
// version in float64) it is within 3.9e-6 at x [16,384, 3,419-4,001], the
// plain version in float32 on the card within 4.3e-5.
//
// What set its design (chip_lab_fm_cross.py, CUDA events around a graph of
// 100 launches, an NVIDIA H100 80GB HBM3 at 700 W, x [16,384, D], k=8):
// 0.111 ms at D=4,000 and 0.156 at D=3,419 with each copy's address formed
// from its row and column; 0.098 and 0.113 with a thread's addresses a
// step apart (kept; torch.sum(x, 1) 0.089 and 0.078). 3 stages: 0.101 and
// 0.117; 6 (one block an SM): 0.155 and 0.227. Rows of D % 4 != 0 shifted
// in shared memory to their own alignment, for 16-byte copies, and read a
// float at a time: 0.172 at D=3,419, against 0.156 for 4-byte copies in an
// earlier call.
//
// ptxas (sm_90a, CUDA 12.8): fm_rows_kernel<7> (D=221) 168 registers, no
// spills, 8,960 bytes of shared memory; <8> 168 registers, 4 bytes of
// spills; <1..6> 75-157 registers, no spills; fm_wide_kernel 48 registers,
// no spills, (2k + 1)*D*4 bytes of dynamic shared memory; fm_global_kernel
// 93 registers, no spills, 86,016 bytes of dynamic shared memory (two
// blocks an SM).
//
// C interface, loaded with ctypes: fm_forward (the rows and wide kernels)
// and fm_global_forward (the global kernel and its coefficients, into a
// scratch of ceil(k / 8) * 10 * D rounded up to 128
// floats) return cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape their kernels do not
// take; the Python wrapper checks shapes, types, devices and the shared
// memory the shape needs, and picks the entry point (ops/kernels.py
// fm_kernel_takes).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// --- fm_rows_kernel: D <= 32 * kMaxPerLane, k <= kFactors -------------------
constexpr int kFactors = 8;
constexpr int kMaxPerLane = 8;
constexpr int kRows = 4;
constexpr int kRowWarps = 12;

// Loads rows 4g..4g+3 of x into xr (zeros past the batch and past D).
template <int kPerLane>
__device__ __forceinline__ void load_rows(float (&xr)[kRows][kPerLane],
                                          const float* __restrict__ x, int64_t group,
                                          int batch, int dim, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = group * kRows + r;
    const float* xrow = x + row * dim;
#pragma unroll
    for (int p = 0; p < kPerLane; ++p) {
      const int d = lane + 32 * p;
      xr[r][p] = (row < batch && d < dim) ? __ldg(xrow + d) : 0.f;
    }
  }
}

// Keeps the half of the 2 * kHalf values in `in` that the lane's bit
// `offset` selects, each summed with the other lane's: afterwards out[i] is
// value i + kHalf * bit.
template <int kHalf>
__device__ __forceinline__ void split_sum(const float* in, float* out, int offset, int lane) {
  const bool bit = lane & offset;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = bit ? in[i + kHalf] : in[i];
    const float send = bit ? in[i] : in[i + kHalf];
    out[i] = keep + __shfl_xor_sync(kFull, send, offset);
  }
}

// Sums a warp's kRows rows' partial sums (acc[r * kVals + j]: s_j of row r
// for j < kFactors, t for j = kFactors) over the 32 lanes, each in the
// order 16, 8, 4, 2, 1: afterwards lane l holds row (l >> 3) & 3's t and
// sq = sum_j s_j^2 (summed over the factors in the order 4, 2, 1).
constexpr int kVals = kFactors + 1;

__device__ __forceinline__ void reduce_rows(const float* acc, int lane, float& t, float& sq) {
  // rows: offset 16 keeps rows {0, 1} or {2, 3}, offset 8 one of them, so
  // that lane l holds row (l >> 3) & 3 of the group
  float half[2 * kVals], row[kVals];
  split_sum<2 * kVals>(acc, half, 16, lane);
  split_sum<kVals>(half, row, 8, lane);
  // factors: offsets 4, 2, 1 leave lane l with s_{l & 7}; t in full
  t = row[kFactors];
  t += __shfl_xor_sync(kFull, t, 4);
  t += __shfl_xor_sync(kFull, t, 2);
  t += __shfl_xor_sync(kFull, t, 1);
  float s4[4], s2[2], s1[1];
  split_sum<4>(row, s4, 4, lane);
  split_sum<2>(s4, s2, 2, lane);
  split_sum<1>(s2, s1, 1, lane);
  sq = __fmul_rn(s1[0], s1[0]);
  sq += __shfl_xor_sync(kFull, sq, 4);
  sq += __shfl_xor_sync(kFull, sq, 2);
  sq += __shfl_xor_sync(kFull, sq, 1);
}

template <int kPerLane>
__global__ void __launch_bounds__(kRowWarps * 32, 1)
fm_rows_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ v, float* __restrict__ out, int batch, int dim,
               int factors) {
  constexpr int kCols = 32 * kPerLane;
  __shared__ float vt_s[kFactors][kCols];  // v transposed, zero past k and D
  __shared__ float a_s[kCols];
  __shared__ float c_s[kCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t groups = (static_cast<int64_t>(batch) + kRows - 1) / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowWarps;
  int64_t group = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;

  // the first rows are in flight while the block stages v
  float xr[kRows][kPerLane];
  load_rows<kPerLane>(xr, x, group, batch, dim, lane);

  for (int d = threadIdx.x; d < kCols; d += blockDim.x) {
    float vv = 0.f;
#pragma unroll
    for (int j = 0; j < kFactors; ++j) {
      const float vj = (d < dim && j < factors) ? v[d * factors + j] : 0.f;
      vt_s[j][d] = vj;
      vv = fmaf(vj, vj, vv);
    }
    a_s[d] = d < dim ? w1[d] : 0.f;
    c_s[d] = -0.5f * vv;
  }
  __syncthreads();
  float vr[kPerLane][kFactors], ar[kPerLane], cr[kPerLane];
#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    const int d = lane + 32 * p;
    ar[p] = a_s[d];
    cr[p] = c_s[d];
#pragma unroll
    for (int j = 0; j < kFactors; ++j) vr[p][j] = vt_s[j][d];
  }

  // The whole warp shares a group of rows, so the loop test never splits a
  // warp and the full-mask shuffles below are safe.
  for (; group < groups; group += stride) {
    // acc[r * kVals + j] = s_j of row r for j < kFactors, t for j = kFactors
    float acc[kRows * kVals];
#pragma unroll
    for (int i = 0; i < kRows * kVals; ++i) acc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < kPerLane; ++p) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xd = xr[r][p];
        float* a = acc + r * kVals;
        a[kFactors] = fmaf(xd, fmaf(cr[p], xd, ar[p]), a[kFactors]);
#pragma unroll
        for (int j = 0; j < kFactors; ++j) a[j] = fmaf(xd, vr[p][j], a[j]);
      }
    }
    // the next rows' loads go out before this group's shuffles
    load_rows<kPerLane>(xr, x, group + stride, batch, dim, lane);

    float t, sq;
    reduce_rows(acc, lane, t, sq);
    const int64_t r = group * kRows + ((lane >> 3) & 3);
    if ((lane & 7) == 0 && r < batch) out[r] = fmaf(0.5f, sq, t);
  }
}

// --- fm_wide_kernel: every other shape ------------------------------------
// One warp a row; v, v*v (both transposed to [k][D], so that the 32 lanes
// read 32 consecutive words: no bank conflicts) and w1 staged once per block
// in shared memory, (2k + 1)*D*4 bytes, opted in past 48 KB. Factor counts
// above kChunk loop over chunks, each reading the row again (from L1).
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kChunk = 8;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;  // a block's most on the H100

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) s += __shfl_xor_sync(kFull, s, offset);
  return s;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fm_wide_kernel(const float* __restrict__ x, const float* __restrict__ w1,
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

// --- fm_global_kernel: every shape, x walked in chunks of columns ----------
// A block of kGlobalWarps warps takes tiles of kTileRows = 32 rows (4 a
// warp, as fm_rows_kernel) and walks each tile's columns in chunks of
// kChunkCols = 128, a lane owning columns 4l..4l+3 of a chunk. For every
// chunk the block stages the x tile [32][128] and the chunk's coefficients
// [a, c, v_0..v_7][128] in a ring of kStages buffers by cp.async (16 bytes
// where every row of x starts 16-byte aligned, else 4), kStages - 1 chunks
// ahead, across the tiles' boundaries. Factors past 8 take further passes
// over the tile (a group of 8 a pass; the coefficients' a and c rows are
// zero past the first group).
constexpr int kGlobalWarps = 8;
constexpr int kTileRows = kGlobalWarps * kRows;
constexpr int kChunkCols = 128;
constexpr int kCoefRows = 2 + kFactors;
constexpr int kStages = 4;
constexpr int kStageFloats = (kTileRows + kCoefRows) * kChunkCols;
constexpr size_t kGlobalSharedBytes = kStages * kStageFloats * sizeof(float);
constexpr int kCoefThreads = 256;

// The coefficients of every factor group g, [groups][kCoefRows][padded]:
// row 0 a_d = w1_d and row 1 c_d = -vv_d / 2 (vv_d = sum_j v_dj^2 by fma in
// factor order, over all the factors) in group 0, zero in the others; rows
// 2..9 v_{d, 8g..8g+7}; zero past k and past D. Run before the global
// kernel, which stages them a chunk at a time.
__global__ void __launch_bounds__(kCoefThreads)
fm_global_kernel_coefficients(const float* __restrict__ w1, const float* __restrict__ v,
                              float* __restrict__ coef, int dim, int factors, int padded,
                              int groups) {
  const int d = blockIdx.x * kCoefThreads + threadIdx.x;
  if (d >= padded) return;
  const bool in = d < dim;
  const float* vd = v + static_cast<int64_t>(d) * factors;
  float vv = 0.f;
  if (in) {
    for (int j = 0; j < factors; ++j) vv = fmaf(vd[j], vd[j], vv);
  }
  for (int g = 0; g < groups; ++g) {
    float* base = coef + static_cast<int64_t>(g) * kCoefRows * padded + d;
    base[0] = in && g == 0 ? w1[d] : 0.f;
    base[padded] = in && g == 0 ? -0.5f * vv : 0.f;
#pragma unroll
    for (int jj = 0; jj < kFactors; ++jj) {
      const int j = g * kFactors + jj;
      base[static_cast<int64_t>(2 + jj) * padded] = in && j < factors ? vd[j] : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kGlobalWarps * 32, 2)
fm_global_kernel(const float* __restrict__ x, const float* __restrict__ coef,
                 float* __restrict__ out, int batch, int dim, int padded, int groups) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = padded / kChunkCols;
  const int64_t tiles = (static_cast<int64_t>(batch) + kTileRows - 1) / kTileRows;
  const int64_t my_tiles =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t tile_steps = static_cast<int64_t>(groups) * chunks;
  const int64_t steps = my_tiles * tile_steps;

  // Starts the copies of step i (tile, factor group, chunk) into its stage
  // and commits them as one group (an empty one past the last step), so
  // that every thread's count of groups stays the step's.
  auto stage_step = [&](int64_t i) {
    if (i < steps) {
      const int64_t row0 = (blockIdx.x + (i / tile_steps) * gridDim.x) * kTileRows;
      const int rem = static_cast<int>(i % tile_steps);
      const int g = rem / chunks;
      const int col0 = (rem - g * chunks) * kChunkCols;
      float* st = smem + (i % kStages) * kStageFloats;
      // a thread copies one column (or 16-byte group) of every
      // kGlobalWarps * 32 / kChunkCols-th (or ... / 32-th) row of the tile
      constexpr int kCopies = kVec ? kChunkCols / 4 : kChunkCols;
      constexpr int kRowStep = kGlobalWarps * 32 / kCopies;
      const int c = (kVec ? 4 : 1) * (threadIdx.x % kCopies);
      const int r1 = threadIdx.x / kCopies;
      const bool col_in = col0 + c < dim;  // D % 4 == 0 where kVec
      const float* src = x + (row0 + r1) * dim + col0 + c;
      float* dst = st + r1 * kChunkCols + c;
#pragma unroll
      for (int r = r1; r < kTileRows; r += kRowStep) {
        const bool in = col_in && row0 + r < batch;
        __pipeline_memcpy_async(dst, in ? src : x, kVec ? 16 : 4, in ? 0 : (kVec ? 16 : 4));
        src += kRowStep * static_cast<int64_t>(dim);
        dst += kRowStep * kChunkCols;
      }
      const float* cg = coef + static_cast<int64_t>(g) * kCoefRows * padded + col0;
      float* cs = st + kTileRows * kChunkCols;
      for (int e = threadIdx.x; e < kCoefRows * kChunkCols / 4; e += blockDim.x) {
        const int r = e / (kChunkCols / 4);
        const int q = 4 * (e - r * (kChunkCols / 4));
        __pipeline_memcpy_async(cs + r * kChunkCols + q, cg + static_cast<int64_t>(r) * padded + q,
                                16);
      }
    }
    __pipeline_commit();
  };

  for (int i = 0; i < kStages - 1; ++i) stage_step(i);
  float acc[kRows * kVals];
  float t_row = 0.f, sq_row = 0.f;  // lane l's row (l >> 3) & 3, over the groups
  for (int64_t i = 0; i < steps; ++i) {
    __pipeline_wait_prior(kStages - 2);  // step i has landed (this thread's copies)
    // every thread's copies have landed, and every warp is done with step
    // i - 1, whose stage the next copies fill
    __syncthreads();
    stage_step(i + kStages - 1);
    const int rem = static_cast<int>(i % tile_steps);
    const int g = rem / chunks;
    const int c = rem - g * chunks;
    if (c == 0) {
#pragma unroll
      for (int e = 0; e < kRows * kVals; ++e) acc[e] = 0.f;
    }
    const float* st = smem + (i % kStages) * kStageFloats;
    const float4* xs = reinterpret_cast<const float4*>(st + warp * kRows * kChunkCols);
    const float4* cs = reinterpret_cast<const float4*>(st + kTileRows * kChunkCols);
    constexpr int kRow4 = kChunkCols / 4;
    const float4 a4 = cs[lane];
    const float4 c4 = cs[kRow4 + lane];
    float4 v4[kFactors];
#pragma unroll
    for (int j = 0; j < kFactors; ++j) v4[j] = cs[(2 + j) * kRow4 + lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 x4 = xs[r * kRow4 + lane];
      float* a = acc + r * kVals;
      const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
      const float aq[4] = {a4.x, a4.y, a4.z, a4.w};
      const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xd = xq[q];
        a[kFactors] = fmaf(xd, fmaf(cq[q], xd, aq[q]), a[kFactors]);
#pragma unroll
        for (int j = 0; j < kFactors; ++j) {
          const float vq = q == 0 ? v4[j].x : q == 1 ? v4[j].y : q == 2 ? v4[j].z : v4[j].w;
          a[j] = fmaf(xd, vq, a[j]);
        }
      }
    }
    if (c == chunks - 1) {  // the tile's group is summed: one butterfly
      float t, sq;
      reduce_rows(acc, lane, t, sq);
      t_row += t;
      sq_row += sq;
      if (g == groups - 1) {
        const int64_t r = (blockIdx.x + (i / tile_steps) * gridDim.x) * kTileRows +
                          warp * kRows + ((lane >> 3) & 3);
        if ((lane & 7) == 0 && r < batch) out[r] = fmaf(0.5f, sq_row, t_row);
        t_row = sq_row = 0.f;
      }
    }
  }
}

template <int kPerLane>
cudaError_t launch_rows(const float* x, const float* w1, const float* v, float* out,
                        int batch, int dim, int factors, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t groups = (static_cast<int64_t>(batch) + kRows - 1) / kRows;
  const int blocks = static_cast<int>(groups < sms ? groups : sms);
  fm_rows_kernel<kPerLane><<<blocks, kRowWarps * 32, 0, stream>>>(x, w1, v, out, batch, dim,
                                                                   factors);
  return cudaGetLastError();
}

cudaError_t launch_wide(const float* x, const float* w1, const float* v, float* out,
                        int batch, int dim, int factors, cudaStream_t stream) {
  const size_t shared_bytes = (2 * static_cast<size_t>(factors) + 1) * dim * sizeof(float);
  if (shared_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared_bytes));
    if (err != cudaSuccess) return err;
  }
  int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fm_wide_kernel<<<blocks, kWarpsPerBlock * 32, shared_bytes, stream>>>(x, w1, v, out, batch,
                                                                       dim, factors);
  return cudaGetLastError();
}

int fm_global_padded_dim(int dim) { return (dim + kChunkCols - 1) / kChunkCols * kChunkCols; }

}  // namespace

extern "C" int fm_forward(const void* x_, const void* w1_, const void* v_, void* out_,
                          int batch, int dim, int factors, void* stream_) {
  if (batch <= 0) return cudaSuccess;
  const auto* x = static_cast<const float*>(x_);
  const auto* w1 = static_cast<const float*>(w1_);
  const auto* v = static_cast<const float*>(v_);
  auto* out = static_cast<float*>(out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (factors <= kFactors && dim <= 32 * kMaxPerLane) {
    switch ((dim + 31) / 32) {
      case 1: return launch_rows<1>(x, w1, v, out, batch, dim, factors, stream);
      case 2: return launch_rows<2>(x, w1, v, out, batch, dim, factors, stream);
      case 3: return launch_rows<3>(x, w1, v, out, batch, dim, factors, stream);
      case 4: return launch_rows<4>(x, w1, v, out, batch, dim, factors, stream);
      case 5: return launch_rows<5>(x, w1, v, out, batch, dim, factors, stream);
      case 6: return launch_rows<6>(x, w1, v, out, batch, dim, factors, stream);
      case 7: return launch_rows<7>(x, w1, v, out, batch, dim, factors, stream);
      default: return launch_rows<8>(x, w1, v, out, batch, dim, factors, stream);
    }
  }
  return launch_wide(x, w1, v, out, batch, dim, factors, stream);
}

extern "C" int fm_global_forward(const void* x_, const void* w1_, const void* v_, void* out_,
                                 void* coef_, int batch, int dim, int factors, void* stream_) {
  if (batch <= 0) return cudaSuccess;
  if (dim <= 0 || factors <= 0) return cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(x_);
  auto* coef = static_cast<float*>(coef_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int padded = fm_global_padded_dim(dim);
  const int groups = (factors + kFactors - 1) / kFactors;
  fm_global_kernel_coefficients<<<(padded + kCoefThreads - 1) / kCoefThreads, kCoefThreads, 0,
                                  stream>>>(static_cast<const float*>(w1_),
                                            static_cast<const float*>(v_), coef, dim, factors,
                                            padded, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = dim % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const auto kernel = vec ? fm_global_kernel<true> : fm_global_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kGlobalSharedBytes));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGlobalWarps * 32,
                                                        kGlobalSharedBytes);
  if (err != cudaSuccess) return err;
  // a persistent grid: at most the blocks that are resident at once
  const int64_t tiles = (static_cast<int64_t>(batch) + kTileRows - 1) / kTileRows;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<blocks, kGlobalWarps * 32, kGlobalSharedBytes, stream>>>(x, coef,
                                                                    static_cast<float*>(out_),
                                                                    batch, dim, padded, groups);
  return cudaGetLastError();
}
