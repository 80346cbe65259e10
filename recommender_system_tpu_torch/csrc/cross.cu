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
// below the H100's f32 ratio of ~20 flops per byte. So every intermediate
// x_l stays in registers: lane j of a warp holds elements j, j+32, ... of x0
// and x (kPerLane of them, a template); per layer each lane forms a partial
// dot with w_l, a butterfly gives the row's s = x_l . w_l, and the lane
// updates its elements.
//
// The first design gave each warp one row and each block of 8 warps its own
// copy of the weights: at B=4,096 its 512 blocks staged 2*L*D floats each
// (5.4 MB through L2, against 3.6 MB of x0) and issued their first x0 load
// only after that staging and a __syncthreads; then each warp ran its six
// dependent dot -> butterfly -> update rounds alone, with no second row to
// overlap. At B=4,096 it is one wave, 40 % of the bound.
//
// cross_tile_kernel, for D <= 256 with x0 16-byte aligned (the DCN paths:
// B=4,096 and 8,192, D=221, L=6):
// - a persistent grid of one block of 16 warps an SM; a block takes tiles
//   of kTileRows = 32 consecutive rows, one contiguous span of x0, copied
//   16 bytes at a time with cp.async into one of two shared-memory buffers:
//   the first tile's copy goes out before the weights', and each next
//   tile's while the block computes this one. The weights are staged once
//   an SM (1.4 MB through L2 at 132 blocks);
// - a warp takes 2 rows of the tile, their layers interleaved, and per layer
//   their dots share one butterfly (the offset 16 splits the rows, 8, 4, 2
//   and 1 sum in full, and a shuffle from each row's lanes hands every lane
//   both sums: 7 shuffles for 2 rows, against 10); an element of w_l or b_l
//   read from shared memory serves both rows; each warp stores its rows
//   straight from registers (128 bytes a warp's store).
// The arithmetic of a row is as in the first design: an fma dot in the
// lane's column order, summed over the lanes in the order 16, 8, 4, 2, 1,
// and the update x0 * s + b + x, all f32.
// cross_stack_kernel takes D up to 1024 with the weights in shared memory
// (2*L*D*4 bytes up to 227 KB), or x0 off 16-byte alignment: the same
// layers on rows loaded into registers, one block of 16 warps an SM, each
// warp's next rows' loads issued before its layers.
// cross_global_kernel takes every other shape (D past 1024, as DCN's x0 of
// 26 fields at dim 40 and 13 dense, 1,053 wide; or more layers than shared
// memory holds). Its first design gave a warp a row, kept x_l in the row of
// out and read w and b again for every row through L1 (2*L*D floats a row,
// 50 KB at D=1,053, L=6, against the row's own 8.4 KB), each warp's six
// dependent layers with no other row's loads in flight: 38 % of the bound
// at B=4,096, D=1,053, L=6. Now it is the tile kernel's design at larger
// widths: a persistent grid of one block of 8 warps an SM takes tiles of 8
// rows by cp.async into two buffers (16 bytes a copy, x0 off 16-byte
// alignment too: the buffers start as far off as x0); a warp loads its row
// into registers (x0 and x_l, kPerLane = 36, 64 or 96 columns a lane up to
// D = 1,152, 2,048 and 3,072), the block then refills the buffer with the
// tile after next, so that two tiles are in flight while it computes this
// one; each layer's update and the next layer's dot go in one pass over
// the lane's columns (apply_layers_fused); w and b are staged once a block
// (50.5 KB at D=1,053, L=6) where they fit beside the buffers, else
// chunk_layers layers at a time, every tile; each row is stored once, from
// registers. Past D = 3,072 (more than registers hold)
// cross_global_rows_kernel keeps the first design. The arithmetic is the
// other kernels': the lane's columns j, j+32, ... in order, the butterfly
// 16, 8, 4, 2, 1 and x0 * s + b + x, so cross_global_kernel equals
// cross_stack_kernel bitwise where both take a shape (chip_smoke.py phase
// 2 checks it at D=1,000 and 1,024).
//
// What set its design (chip_lab_fm_cross.py, CUDA events around a graph of
// 100 launches, an NVIDIA H100 80GB HBM3 at 700 W, B=4,096 / 8,192, D=1,053,
// L=6): the copies in and out alone take ~0.0115 / 0.029 ms, the layers
// without the stores ~0.016 / 0.029: the six dependent rounds of dot,
// butterfly and update of a block's rows, not the bytes, set the pace.
// Kept: 8 warps of 1 row, 0.0186 / 0.0367 ms. Slower, in the same call:
// 16 warps of 1 row (0.0195 / 0.040), 8 warps of 2 rows with their layers
// interleaved, the tile kernel's layout (181 registers, 0.0252 / 0.050),
// the update and the next dot in two passes (0.0244 / 0.048); in other
// calls: one tile in flight, 16 warps of 1 row, two passes (0.0252 /
// 0.049), 20 warps of 1 row (0.023 / 0.049), and this kernel with its ring
// written for any number of buffers (134 registers, 0.035 / 0.068; 3 or 4
// buffers no faster).
//
// What holds the tile kernel back (chip_lab_fm_cross.py on an NVIDIA H100
// 80GB HBM3 at 700 W): at B=4,096 it is one round of copy in, six layers
// and stores; the copy in and out alone (no layers) takes ~2.7-3.0 us of its
// ~4.6-4.7 us, against ~1.9-2.1 us for x0.clone(). Slower were: the results written
// back into the tile and stored by the block 16 bytes at a time after a
// barrier (~4.85 us), 4 rows a warp (half the SMs idle at B=4,096), 1 row a
// warp, 8 warps of 1 or 2 rows, 32 warps of 1 or 2 rows, the first layers'
// weights held in registers (128 registers, 7.8 us), and each warp copying
// and waiting for its own rows 8 bytes at a time (5.4 us).
//
// ptxas (sm_90a, CUDA 12.8): cross_tile_kernel<7> 63 registers, no spills,
// dynamic shared memory 2*32*D*4 + 2*L*D*4 bytes (67,184 at D=221, L=6);
// <1..8> 32-66 registers, no spills; cross_stack_kernel<8, 1> 64 registers,
// <16, 1> 88, <32, 1> 128 with 48 bytes of spills; cross_global_kernel<36,
// 1, 8> 111 registers, no spills, 2*8*D*4 + 2*L*D*4 bytes (117,968 at
// D=1,053, L=6).
//
// C interface, loaded with ctypes: cross_forward (the tile and stack
// kernels) and cross_global_forward (the global kernel) return
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// their kernels do not take; the Python wrapper checks shapes, types and
// devices first and picks the entry point (ops/kernels.py
// cross_kernel_takes).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;  // a block's most on the H100

// Keeps the half of the n values in h that the lane's bit `offset` selects,
// each summed with the other lane's: afterwards h[i] is value i + n/2 * bit.
template <int n>
__device__ __forceinline__ void split_sum(float* h, int offset, int lane) {
  const bool bit = lane & offset;
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float keep = bit ? h[i + n / 2] : h[i];
    const float send = bit ? h[i] : h[i + n / 2];
    h[i] = keep + __shfl_xor_sync(kFull, send, offset);
  }
}

// Every lane gets the full sum over the 32 lanes of each row's value s[r],
// summed in the order 16, 8, 4, 2, 1 as a plain butterfly sums it.
template <int kRows>
__device__ __forceinline__ void row_sums(float (&s)[kRows], int lane) {
  static_assert(kRows == 1 || kRows == 2 || kRows == 4, "1, 2 or 4 rows a warp");
  float h[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) h[r] = s[r];
  // the offsets 16 (and 8) split the rows; lane l then holds row
  // l / (32 / kRows)
  if constexpr (kRows >= 2) split_sum<kRows>(h, 16, lane);
  if constexpr (kRows == 4) split_sum<2>(h, 8, lane);
#pragma unroll
  for (int offset = 32 / kRows / 2; offset > 0; offset >>= 1)
    h[0] += __shfl_xor_sync(kFull, h[0], offset);
  if constexpr (kRows == 1) {
    s[0] = h[0];
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = __shfl_sync(kFull, h[0], r * (32 / kRows));
  }
}

// The L layers on kRows rows held in registers: lane j holds elements j,
// j+32, ... of x0 in a and of x_l in x; w_s and b_s are [L, D] in shared
// memory, and an element of w_l or b_l read once serves all the rows. The
// whole warp must call it.
template <int kPerLane, int kRows>
__device__ __forceinline__ void run_layers(const float (&a)[kRows][kPerLane],
                                           float (&x)[kRows][kPerLane], const float* w_s,
                                           const float* b_s, int dim, int layers, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) x[r][k] = a[r][k];
  }
  for (int l = 0; l < layers; ++l) {
    const float* w = w_s + l * dim;
    const float* b = b_s + l * dim;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < dim) {
        const float wj = w[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = fmaf(x[r][k], wj, s[r]);
      }
    }
    row_sums<kRows>(s, lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < dim) {
        const float bj = b[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) x[r][k] = a[r][k] * s[r] + bj + x[r][k];
      }
    }
  }
}

// Layers 0..layers-1 of w_s and b_s as run_layers runs them, continuing
// from x, with each layer's update and the next layer's dot in one pass
// over the lane's columns: the same operations in the same order, so the
// same results bitwise. The pass of the last layer forms a dot with
// the row of w_s after it (b_s's first, or a stale one) and drops it.
template <int kPerLane, int kRows>
__device__ __forceinline__ void apply_layers_fused(const float (&a)[kRows][kPerLane],
                                                   float (&x)[kRows][kPerLane],
                                                   const float* w_s, const float* b_s, int dim,
                                                   int layers, int lane) {
  if (layers == 0) return;
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    if (j < dim) {
      const float wj = w_s[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(x[r][k], wj, s[r]);
    }
  }
  for (int l = 0; l < layers; ++l) {
    const float* b = b_s + l * dim;
    const float* w_next = w_s + (l + 1) * dim;
    row_sums<kRows>(s, lane);
    float s_next[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s_next[r] = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < dim) {
        const float bj = b[j];
        const float wj = w_next[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          x[r][k] = a[r][k] * s[r] + bj + x[r][k];
          s_next[r] = fmaf(x[r][k], wj, s_next[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = s_next[r];
  }
}

// --- cross_tile_kernel: D <= 256, x0 16-byte aligned -----------------------
constexpr int kTileWarps = 16;
constexpr int kTileRowsPerWarp = 2;
// a multiple of 4, so that every tile starts 16-byte aligned
constexpr int kTileRows = kTileWarps * kTileRowsPerWarp;
constexpr int kTileMaxPerLane = 8;

// Starts the copy of n floats from src (16-byte aligned) to dst in shared
// memory, 16 bytes at a time, and commits it as this thread's next group.
__device__ __forceinline__ void fetch(float* dst, const float* src, int n) {
  const int n4 = n >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

template <int kPerLane>
__global__ void __launch_bounds__(kTileWarps * 32, 1)
cross_tile_kernel(const float* __restrict__ x0, const float* __restrict__ weights,
                  const float* __restrict__ biases, float* __restrict__ out,
                  int batch, int dim, int layers) {
  constexpr int kRows = kTileRowsPerWarp;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile_floats = kTileRows * dim;  // two tiles, then w and b
  float* w_s = smem + 2 * tile_floats;
  float* b_s = w_s + layers * dim;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (static_cast<int64_t>(batch) + kTileRows - 1) / kTileRows;
  auto rows_of = [batch](int64_t t) {
    const int64_t left = batch - t * kTileRows;
    return static_cast<int>(left < kTileRows ? left : kTileRows);
  };

  // the first tile's copy goes out before the weights'
  int64_t t = blockIdx.x;
  fetch(smem, x0 + t * kTileRows * dim, rows_of(t) * dim);
  for (int i = threadIdx.x; i < layers * dim; i += blockDim.x) {
    __pipeline_memcpy_async(w_s + i, weights + i, 4);
    __pipeline_memcpy_async(b_s + i, biases + i, 4);
  }
  __pipeline_commit();

  for (int buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    float* tile = smem + buf * tile_floats;
    // every thread is done with the other buffer (the tile before last)
    // before the next tile's copy fills it
    __syncthreads();
    const int64_t next = t + gridDim.x;
    if (next < tiles) {
      fetch(smem + (buf ^ 1) * tile_floats, x0 + next * kTileRows * dim, rows_of(next) * dim);
    } else {
      __pipeline_commit();  // an empty group keeps the count
    }
    __pipeline_wait_prior(1);  // this tile and the weights have landed
    __syncthreads();

    const int rows = rows_of(t);
    const int r0 = warp * kRows;
    if (r0 < rows) {  // the same for the whole warp
      float a[kRows][kPerLane], x[kRows][kPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int j = lane + 32 * k;
          a[r][k] = (r0 + r < rows && j < dim) ? tile[(r0 + r) * dim + j] : 0.f;
        }
      }
      run_layers<kPerLane, kRows>(a, x, w_s, b_s, dim, layers, lane);
      // the results go straight from registers to out, 128 bytes a warp's
      // store
      float* dst = out + t * kTileRows * dim;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int j = lane + 32 * k;
          if (r0 + r < rows && j < dim) dst[(r0 + r) * dim + j] = x[r][k];
        }
      }
    }
  }
}

size_t tile_shared_bytes(int dim, int layers) {
  return (2 * static_cast<size_t>(kTileRows) + 2 * static_cast<size_t>(layers)) * dim *
         sizeof(float);
}

// --- cross_stack_kernel: every other shape --------------------------------
// Registers only: a persistent grid of one block of 16 warps an SM stages
// the weights once, each warp takes kRows rows a group, issues the next
// group's x0 loads before this group's layers, and stores from registers.
constexpr int kWarps = 16;

// Loads rows kRows*g .. kRows*g + kRows-1 of x0 (zeros past the batch and D).
template <int kPerLane, int kRows>
__device__ __forceinline__ void load_rows(float (&a)[kRows][kPerLane],
                                          const float* __restrict__ x0, int64_t group,
                                          int batch, int dim, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = group * kRows + r;
    const float* src = x0 + row * dim;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lane + 32 * k;
      a[r][k] = (row < batch && j < dim) ? __ldg(src + j) : 0.f;
    }
  }
}

template <int kPerLane, int kRows>
__global__ void __launch_bounds__(kWarps * 32, 1)
cross_stack_kernel(const float* __restrict__ x0, const float* __restrict__ weights,
                   const float* __restrict__ biases, float* __restrict__ out,
                   int batch, int dim, int layers) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* b_s = w_s + layers * dim;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t groups = (static_cast<int64_t>(batch) + kRows - 1) / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t group = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;

  // the first rows are in flight while the block stages the weights
  float a[kRows][kPerLane];
  load_rows<kPerLane, kRows>(a, x0, group, batch, dim, lane);
  for (int i = threadIdx.x; i < layers * dim; i += blockDim.x) {
    w_s[i] = weights[i];
    b_s[i] = biases[i];
  }
  __syncthreads();

  // The whole warp shares a group of rows, so the loop test never splits a
  // warp and the full-mask shuffles are safe.
  for (; group < groups; group += stride) {
    // the next rows' loads go out before this group's layers
    float next[kRows][kPerLane];
    load_rows<kPerLane, kRows>(next, x0, group + stride, batch, dim, lane);
    float x[kRows][kPerLane];
    run_layers<kPerLane, kRows>(a, x, w_s, b_s, dim, layers, lane);
    const int64_t first = group * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (first + r >= batch) break;
      float* dst = out + (first + r) * dim;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < dim) dst[j] = x[r][k];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) a[r][k] = next[r][k];
    }
  }
}

// --- cross_global_kernel: every other shape ---------------------------------
// A persistent grid of kWarps warps a block takes tiles of kWarps * kRows
// consecutive rows, copied by cp.async into one of two shared-memory
// buffers (16 bytes a copy, x0 off 16-byte alignment included: a buffer
// starts as far off as x0 is); each warp loads its rows from the tile into
// registers (x0 and x_l, kPerLane columns a lane, zero past D), the buffer
// is refilled with the tile after next, and the warp runs the layers in
// registers and stores each row once. The weights are staged once a block
// where they fit beside the two buffers; where they do not, the block
// stages them chunk_layers at a time, every tile.
// widest x0 that registers hold, one row a warp
constexpr int kGlobalMaxPerLane = 96;
// the rows kernel's warps a block
constexpr int kGlobalWarps = 8;

// Starts the copy of n floats from src to dst in shared memory (dst as far
// off 16-byte alignment as src) and commits it as this thread's next group.
__device__ __forceinline__ void fetch_any(float* dst, const float* src, int n) {
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - off) & 3);
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
  const int n4 = (n - head) >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __pipeline_memcpy_async(dst + head + 4 * i, src + head + 4 * i, 16);
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// Floats of one tile buffer: its rows, and room for x0's offset, rounded
// to 16 bytes.
__host__ __device__ int global_tile_floats(int dim, int rows) {
  return (rows * dim + 3 + 3) / 4 * 4;
}

template <int kPerLane, int kRows, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 1)
cross_global_kernel(const float* __restrict__ x0, const float* __restrict__ weights,
                    const float* __restrict__ biases, float* __restrict__ out,
                    int batch, int dim, int layers, int chunk_layers) {
  constexpr int kTile = kWarps * kRows;  // a multiple of 4: every tile is
                                         // as far off as x0
  static_assert(kTile % 4 == 0, "tiles of a multiple of 4 rows");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile_floats = global_tile_floats(dim, kTile);
  float* w_s = smem + 2 * tile_floats;
  float* b_s = w_s + chunk_layers * dim;
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(x0) >> 2) & 3);
  const bool once = chunk_layers >= layers;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (static_cast<int64_t>(batch) + kTile - 1) / kTile;
  auto rows_of = [batch](int64_t t) {
    const int64_t left = batch - t * kTile;
    return static_cast<int>(left < kTile ? left : kTile);
  };

  // the first tile's copy goes out before the weights', the second's after
  // them
  int64_t t = blockIdx.x;
  fetch_any(smem + off, x0 + t * kTile * dim, rows_of(t) * dim);
  if (once) {
    for (int i = threadIdx.x; i < layers * dim; i += blockDim.x) {
      __pipeline_memcpy_async(w_s + i, weights + i, 4);
      __pipeline_memcpy_async(b_s + i, biases + i, 4);
    }
  }
  __pipeline_commit();
  if (t + gridDim.x < tiles) {
    fetch_any(smem + tile_floats + off, x0 + (t + gridDim.x) * kTile * dim,
              rows_of(t + gridDim.x) * dim);
  } else {
    __pipeline_commit();  // an empty group keeps the count
  }

  for (int buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    float* tile = smem + buf * tile_floats;
    __pipeline_wait_prior(1);  // this tile (and the weights) have landed
    __syncthreads();

    // every warp runs the layers, rows past the tile's on zeros, so that
    // the whole block meets the barriers of the staged chunks
    const int rows = rows_of(t);
    const int r0 = warp * kRows;
    float a[kRows][kPerLane], x[kRows][kPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        a[r][k] = (r0 + r < rows && j < dim) ? tile[off + (r0 + r) * dim + j] : 0.f;
        x[r][k] = a[r][k];
      }
    }
    // every warp holds its rows: the buffer takes the tile after next, two
    // tiles in flight while the block computes this one
    __syncthreads();
    const int64_t after = t + 2 * static_cast<int64_t>(gridDim.x);
    if (after < tiles) {
      fetch_any(tile + off, x0 + after * kTile * dim, rows_of(after) * dim);
    } else {
      __pipeline_commit();
    }
    for (int l0 = 0; l0 < layers; l0 += chunk_layers) {
      const int n = min(chunk_layers, layers - l0);
      if (!once) {
        __syncthreads();  // every warp is done with the last chunk
        for (int i = threadIdx.x; i < n * dim; i += blockDim.x) {
          w_s[i] = __ldg(weights + static_cast<int64_t>(l0) * dim + i);
          b_s[i] = __ldg(biases + static_cast<int64_t>(l0) * dim + i);
        }
        __syncthreads();
      }
      apply_layers_fused<kPerLane, kRows>(a, x, w_s, b_s, dim, n, lane);
    }
    float* dst = out + t * kTile * dim;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = lane + 32 * k;
        if (r0 + r < rows && j < dim) dst[(r0 + r) * dim + j] = x[r][k];
      }
    }
  }
}

// --- cross_global_rows_kernel: x0 wider than registers hold ----------------
// One warp a row, a grid of blocks of kGlobalWarps warps striding over the
// rows. x_l lives in the row of out: each lane reads back only the elements
// it wrote, so the warp needs no barrier between layers; the weights are
// read through L1 and L2. The same arithmetic as the other kernels.
__global__ void __launch_bounds__(kGlobalWarps * 32)
cross_global_rows_kernel(const float* __restrict__ x0, const float* __restrict__ weights,
                         const float* __restrict__ biases, float* __restrict__ out,
                         int batch, int dim, int layers) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGlobalWarps;
  // the whole warp shares a row, so the loop test never splits a warp
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kGlobalWarps + (threadIdx.x >> 5);
       row < batch; row += stride) {
    const float* a = x0 + row * dim;
    float* x = out + row * dim;
    if (layers == 0) {
      for (int j = lane; j < dim; j += 32) x[j] = a[j];
    }
    for (int l = 0; l < layers; ++l) {
      const float* w = weights + static_cast<int64_t>(l) * dim;
      const float* b = biases + static_cast<int64_t>(l) * dim;
      const float* xl = l == 0 ? a : x;
      float s[1] = {0.f};
      for (int j = lane; j < dim; j += 32) s[0] = fmaf(xl[j], __ldg(w + j), s[0]);
      row_sums<1>(s, lane);
      for (int j = lane; j < dim; j += 32) x[j] = a[j] * s[0] + __ldg(b + j) + xl[j];
    }
  }
}

int sm_count(cudaError_t* err) {
  int device = 0, sms = 0;
  *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kPerLane>
cudaError_t launch_tile(const float* x0, const float* weights, const float* biases,
                        float* out, int batch, int dim, int layers, cudaStream_t stream) {
  const size_t bytes = tile_shared_bytes(dim, layers);
  cudaError_t err = allow_shared(cross_tile_kernel<kPerLane>, bytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (static_cast<int64_t>(batch) + kTileRows - 1) / kTileRows;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  cross_tile_kernel<kPerLane><<<blocks, kTileWarps * 32, bytes, stream>>>(
      x0, weights, biases, out, batch, dim, layers);
  return cudaGetLastError();
}

template <int kPerLane, int kRows>
cudaError_t launch_stack(const float* x0, const float* weights, const float* biases,
                         float* out, int batch, int dim, int layers, cudaStream_t stream) {
  const size_t bytes = 2 * static_cast<size_t>(layers) * dim * sizeof(float);
  cudaError_t err = allow_shared(cross_stack_kernel<kPerLane, kRows>, bytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return err;
  const int64_t groups = (static_cast<int64_t>(batch) + kRows - 1) / kRows;
  const int blocks = static_cast<int>(groups < sms ? groups : sms);
  cross_stack_kernel<kPerLane, kRows><<<blocks, kWarps * 32, bytes, stream>>>(
      x0, weights, biases, out, batch, dim, layers);
  return cudaGetLastError();
}

template <int kPerLane, int kRows, int kWarps>
cudaError_t launch_global(const float* x0, const float* weights, const float* biases,
                          float* out, int batch, int dim, int layers, cudaStream_t stream) {
  // two tile buffers, then as many layers of w and b as fit (all, or a
  // chunk staged a tile at a time)
  constexpr int kTile = kWarps * kRows;
  const size_t tiles_bytes = 2 * static_cast<size_t>(global_tile_floats(dim, kTile)) *
                             sizeof(float);
  const size_t layer_bytes = 2 * static_cast<size_t>(dim) * sizeof(float);
  if (tiles_bytes + layer_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int64_t fit = static_cast<int64_t>((kMaxSharedBytes - tiles_bytes) / layer_bytes);
  const int chunk_layers = static_cast<int>(layers < fit ? (layers > 0 ? layers : 1) : fit);
  const size_t bytes = tiles_bytes + chunk_layers * layer_bytes;
  const auto kernel = cross_global_kernel<kPerLane, kRows, kWarps>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(&err);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, bytes);
  if (err != cudaSuccess) return err;
  // a persistent grid: the blocks resident at once
  const int64_t tiles = (static_cast<int64_t>(batch) + kTile - 1) / kTile;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<blocks, kWarps * 32, bytes, stream>>>(x0, weights, biases, out, batch, dim, layers,
                                                 chunk_layers);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int cross_forward(const float* x0, const float* weights,
                             const float* biases, float* out, int batch,
                             int dim, int layers, void* stream) {
  if (batch <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= 32 * kTileMaxPerLane && aligned16(x0) &&
      tile_shared_bytes(dim, layers) <= kMaxSharedBytes) {
    switch ((dim + 31) / 32) {
      case 1: return launch_tile<1>(x0, weights, biases, out, batch, dim, layers, s);
      case 2: return launch_tile<2>(x0, weights, biases, out, batch, dim, layers, s);
      case 3: return launch_tile<3>(x0, weights, biases, out, batch, dim, layers, s);
      case 4: return launch_tile<4>(x0, weights, biases, out, batch, dim, layers, s);
      case 5: return launch_tile<5>(x0, weights, biases, out, batch, dim, layers, s);
      case 6: return launch_tile<6>(x0, weights, biases, out, batch, dim, layers, s);
      case 7: return launch_tile<7>(x0, weights, biases, out, batch, dim, layers, s);
      default: return launch_tile<8>(x0, weights, biases, out, batch, dim, layers, s);
    }
  }
  if (2 * static_cast<size_t>(layers) * dim * sizeof(float) > kMaxSharedBytes) {
    return cudaErrorInvalidValue;
  }
  if (dim <= 256) return launch_stack<8, 1>(x0, weights, biases, out, batch, dim, layers, s);
  if (dim <= 512) return launch_stack<16, 1>(x0, weights, biases, out, batch, dim, layers, s);
  if (dim <= 1024) return launch_stack<32, 1>(x0, weights, biases, out, batch, dim, layers, s);
  return cudaErrorInvalidValue;
}

extern "C" int cross_global_forward(const float* x0, const float* weights,
                                    const float* biases, float* out, int batch,
                                    int dim, int layers, void* stream) {
  if (batch <= 0) return cudaSuccess;
  if (dim <= 0 || layers < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= 32 * 36) {
    return launch_global<36, 1, 8>(x0, weights, biases, out, batch, dim, layers, s);
  }
  if (dim <= 32 * 64) {
    return launch_global<64, 1, 8>(x0, weights, biases, out, batch, dim, layers, s);
  }
  if (dim <= 32 * kGlobalMaxPerLane) {
    return launch_global<kGlobalMaxPerLane, 1, 8>(x0, weights, biases, out, batch, dim, layers,
                                                  s);
  }
  cudaError_t err = cudaSuccess;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return err;
  const int64_t blocks_needed = (static_cast<int64_t>(batch) + kGlobalWarps - 1) / kGlobalWarps;
  const int64_t most = static_cast<int64_t>(sms) * 8;
  const int blocks = static_cast<int>(blocks_needed < most ? blocks_needed : most);
  cross_global_rows_kernel<<<blocks, kGlobalWarps * 32, 0, s>>>(x0, weights, biases, out, batch,
                                                                dim, layers);
  return cudaGetLastError();
}
