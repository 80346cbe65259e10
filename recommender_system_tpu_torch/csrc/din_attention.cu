// DIN target attention for Hopper (sm_90a): score every behaviour position
// of a row against the row's target with a 2-hidden-layer MLP over
// [q, k, q-k, q*k], mask, optionally softmax, then pool the keys (or return
// the weights).
//
// Replaces the TPU kernel _din_kernel / din_attention_fused in
// recommender_system_tpu/ops/pallas_kernels.py. Plain version:
// din_attention_ref in recommender_system_tpu_torch/ops/kernels.py.
//
// The first layer takes the Pallas kernel's form, with weights that every
// row shares:
//   concat([q, k, q-k, q*k]) W1 == q (Wq + Wm) + [k | q*k] [Wk - Wm ; Wp],
// the second term one product over all positions, the first a small
// product once per row.
//
// Bound on the card: operations. At B=8192, T=50, K=32, H1=80, H2=40 the
// scorer is ~4.9 GFLOP (counted with the first layer folded per row, the
// least form) on 56 MB of input. In f32 outside the tensor cores that is
// 0.0726 ms at 67 TFLOP/s; the bytes take 0.0167 ms at 3.35 TB/s. The
// tensor cores hold the f32 tolerance only as "3xTF32": x = big + small
// with big = tf32(x) and small = tf32(x - big), and
//   a b ~= a_small b_big + a_big b_small + a_big b_big,
// three TF32 products summed in f32 (the small*small term is below f32's
// rounding); each k-tile's three go into a fresh accumulator that a
// rounded f32 add takes into the running sum, since the tensor cores' own
// adds in a long chain drift past the f32 tolerance. Three passes over the
// same work at 495 TFLOP/s take 0.0295 ms, still above the bytes. The
// design:
// - positions are the M dimension: a block takes a group of `rows` batch
//   rows, whose keys are one contiguous [rows*T, K] range, as rows*T
//   positions in m-tiles of 16 (the ragged end masked); each warp takes
//   whole m-tiles, so nothing but the block's barriers is shared;
// - mma.sync.m16n8k8 with TF32 operands and f32 accumulators, chosen over
//   wgmma: the per-warp tile of 16 positions fits the ragged groups, the
//   layer chain stays in one warp's registers, and its fragment layouts
//   are fixed and documented, where wgmma's descriptors and swizzles would
//   cost more than the first design is worth;
// - both layers' weights are split into big and small once per block and
//   stored in shared memory in fragment order, {b0 big, b0 small, b1 big,
//   b1 small} a lane, so one 16-byte load feeds the three products of a
//   (k-tile, n-tile); activations are split as they are loaded;
// - layer 1, [k | q*k] (16 x 2K) @ [Wk-Wm ; Wp] (2K x H1), accumulates in
//   registers, adds q (Wq+Wm) and b1 per row, and takes the activation in
//   place. Its accumulator fragment is the next A fragment without a
//   shuffle: a thread holds columns 2i and 2i+1 of an n-tile, which layer 2
//   reads as its k-columns i and i+4, so W2's rows are staged in that
//   order. Layer 2 (H1 x H2) runs in chunks of 5 n-tiles, then the
//   activation, the dot with w3 and a reduction over the 4 lanes of a row
//   give one score a position. Layer 1 computes 8 * NT1 columns (NT1 a
//   template parameter, H1 rounded up to one of 9 tile counts) and layer 2
//   whole chunks, the columns past H1 and H2 with zero weights, so the
//   product loops hold no branch and the compiler interleaves a k-tile's
//   independent n-tiles;
// - a persistent grid loops over row groups; the next group's keys, query
//   and mask are copied with cp.async into a second buffer while the
//   current group computes. Key rows are padded to K rounded up to 8, plus
//   4 words, so the A loads of 8 rows x 4 columns hit 32 banks;
// - then one warp per row masks, takes the softmax (max subtracted) and
//   pools the keys still in shared memory, or writes the weights.
// The per-row term, the bias adds, the activations, the softmax and the
// pooling are f32. NEG_INF is the finite -(2**32)+1 of the reference: a row
// with no valid position gets weights of exactly 1/T. The products round
// differently from the plain version's f32 matmuls, well inside rtol 1e-4,
// atol 1e-5. torch's TF32 flags do not reach this kernel: it takes TF32
// operands only as the three-pass split.
//
// din_attention_global_kernel takes the shapes the tiled kernel does not
// (hidden widths past 256, or more than 227 KB of shared memory at one row
// a group: K=128 at T=50, K=64 past T=185, K=32 past T=514), on the tensor
// cores through wgmma, with the tiled kernel's 3xTF32 products and f32
// adds a k-step. Its shared memory does not grow with T, and holds the
// weights in chunks:
// - a warpgroup (4 warps) takes 64 positions, each warp its 16 as an A
//   fragment in registers, laid out as mma.sync's m16n8k8 one; a lane
//   loads it straight from global memory, 16 bytes a row, one 16-column
//   block ahead of the products: keys never pass through shared memory.
//   The k dimension is taken in a permuted order (k-step 2j of block j
//   reads the block's columns 4*i4 and 4*i4 + 1, k-step 2j + 1 columns
//   4*i4 + 2 and + 3; the weights are staged in the same order), so that
//   one float4 gives a lane both k-steps' values; the same float4 times
//   the row's query, staged in shared memory, gives the two [q*k] k-steps.
//   Past K the columns are zero on both sides;
// - B comes from shared memory as K-major core matrices of 8 rows x 16
//   bytes without swizzle (the descriptor's leading offset 128 bytes
//   along k, its stride 256 bytes along n), big and small parts apart. A
//   k-step is three m64nNk8 products (a_small b_big, a_big b_small, a_big
//   b_big) into a fresh accumulator, waited for, then added into the
//   running sums with rounded f32 adds, as mma3 does: the tensor cores'
//   own adds over a long chain drift past the f32 tolerance;
// - layer 1 [Wk-Wm ; Wp] goes in chunks of 16-column blocks of K times
//   h-chunks of N = 8 * NH columns of H1 (NH a template parameter, one of
//   4, 8, 10, 16, so N is one wgmma width), layer 2 in blocks of the
//   h-chunk's rows times z-chunks of 40 columns of H2 (zero past H2), each
//   split into big and small parts as they are staged. Layer 1's
//   accumulators are layer 2's A fragments without a shuffle (a lane holds
//   columns 2i, 2i+1 of an 8-column tile, read as its k-columns i, i+4).
//   Where every chunk fits in shared memory with a group (80-40 at K up to
//   128), they are staged once a block and stay; elsewhere each pass of
//   the warpgroups stages them in turn between two barriers. A z-chunk
//   past the first recomputes layer 1;
// - 3 warpgroups a block (2 for NH=16) and a persistent grid over groups
//   of up to 16 batch rows, the group's size picked for the fewest rounds
//   of 64-position tiles over the grid's waves. The per-row term
//   q (Wq + Wm) + b1 comes from a small f32 kernel launched first
//   (din_attention_global_kernel_row_terms, every row of the batch into a
//   scratch buffer the wrapper gives), which a group stages in shared
//   memory; the group's raw scores go to device memory (the output when
//   the weights are returned, else the same scratch buffer), so T is not
//   bounded;
// - the softmax takes a warp a row, or the block's warps split over fewer
//   rows (their maxima and sums added in order); the pooling spreads the
//   group's (row, column) pairs, 4 columns a thread where K % 4 == 0, over
//   every thread, with T split in slices where the pairs are too few, and
//   reads the keys a second time, from L2, where the group's just went.
// Its bound is the tiled kernel's, operations: three TF32 passes over the
// least work take 0.0696 ms at B=8,192, T=50, K=128, 80-40 (the keys'
// 210 MB take 0.0626 ms). It does more than the least work: [k | q*k] is
// 2K wide where the least form folds q into a per-row K x H1 matrix.
// The sums round differently from the plain version's (the per-row term's
// bias first, sliced and tiled sums), well inside the tolerance.
//
// The backward (the counterpart of _din_remat_bwd in
// recommender_system_tpu/ops/din_vjp.py, which XLA compiles: the TPU has no
// backward kernel) has three kernels. From the inputs, the forward's
// weights [B, T] (the tiled kernel writes them through a pointer that is
// null when serving; the global kernel's scratch holds them) and the
// output's cotangent g, each writes dq, dkeys and every weight's gradient.
// din_backward_tile_kernel (below, with its design) takes DIN's and
// DIEN's shapes, K <= 32, H1 <= 80, H2 <= 40, T <= 64, in two launches
// with the block-order reduction; din_backward_wide_kernel (below) the
// rest of K <= 128 at that scorer, any T (DIN at embedding dim 128,
// DIEN(gru_hidden=128), long histories), in three. The global kernel takes
// every other shape the forward takes (wider scorers, K past 128), in six
// launches:
// - the packed weights WX = [Wk - Wm ; Wp ; Wq + Wm] and W2, zero-padded;
//   the per-row terms b1 + q (Wq + Wm) (the global kernel's row-term
//   kernel); dlogit a row: dscore = g . k (or g), with the softmax the row
//   term c = sum_t s dscore and dlogit = s (dscore - c), 0 where masked.
//   Positions are then independent, so T is not bounded;
// - din_backward_kernel, a persistent grid over passes of 16 * warps
//   consecutive positions of the flattened batch: a warp takes 16 through
//   layers 1 and 2 again (3xTF32 mma.sync, as the tiled kernel), du =
//   dlogit w3 act'(h2), dh = du W2^T act'(h1) and dX = dh [Wk - Wm ; Wp]^T,
//   the first layer's cotangent per part (dkeys = s g + dX_k + dX_qk q, and
//   the dq terms e = dX_qk k, written a position); A fragments come from
//   shared memory, B ones are split as they are loaded. Then the block
//   sums dh over each row's positions of the pass: q^T (the sums) is dA's
//   part and (the sums) A^T the row's other dq term, added to e at the
//   row's first position of the pass. Its warps add the pass's h1^T du and
//   X^T dh (X = [k | q*k]) to the block's running sums, in tasks of 16 x 40
//   whose k-tiles go in order, and the biases' sums a warp in warp order.
//   A pass's activations, the weights and the running sums each live in
//   shared memory where they fit (back_launch), else in device memory;
// - din_backward_reduce adds the blocks' sums in block order, and
//   din_backward_dq each row's e over t in order.
// No atomics: two calls agree bitwise. Its bound is operations: 14.3 GFLOP
// at B=8,192, T=50, K=32, 80-40 in the least form (the first layer folded
// per row), 0.087 ms in 3xTF32; the design does ~20.5 GFLOP (the first
// layer and its cotangents 2K wide) and its passes wait on shared-memory
// loads, splits and barriers (chip_lab_din_backward.py).
//
// C interface, loaded with ctypes: din_attention_forward (the tiled kernel)
// and din_attention_global_forward (the global kernel) return
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for sizes
// their kernels do not take; the Python wrapper checks shapes, types and
// devices first and picks the entry point (ops/kernels.py
// din_kernel_takes). din_attention_backward_scratch gives the floats of
// scratch the tile kernel's backward takes (-1 where it does not take the
// shape), and din_attention_backward launches it and the reduction on it;
// din_attention_wide_backward_scratch and din_attention_wide_backward do
// the same for the wide kernel's three launches, and
// din_attention_global_backward_scratch and din_attention_global_backward
// for the global kernel's six (ops/kernels.py din_backward_route picks).
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kMaxRows = 16;  // batch rows a group may hold
constexpr int kTiles2 = 5;    // layer-2 n-tiles a warp accumulates at once
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;
constexpr float kNegInf = -4294967295.0f;  // -(2**32) + 1
constexpr unsigned kFull = 0xffffffffu;

// warps a block: 16 where a thread may keep 128 registers (layer 1 holds
// 4 * NT1 accumulators), 8 for the widest first layers
__host__ __device__ constexpr int warps_for(int nt1) { return nt1 <= 16 ? 16 : 8; }

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory layout, offsets in floats, each 16-byte aligned.
struct Layout {
  int S;    // key row stride: K rounded up to 8, plus 4
  int K2;   // 2K rounded up to 8: layer 1's depth
  int H1p;  // 8 * NT1: layer 1's width, layer 2's depth
  int H2p;  // H2 rounded up to whole chunks of kTiles2 n-tiles
  int rows;
  int w1f, w2f, wqm, b1, b2, w3, b3;
  int keys[2], q[2], mask[2];
  int a, score, total;
};

// tiles1: the kernel's NT1, whose 8 * NT1 columns layer 1 computes (those
// past H1 have zero weights)
Layout make_layout(int T, int K, int H1, int H2, int tiles1, int rows) {
  Layout L;
  L.S = round_up(K, 8) + 4;
  L.K2 = round_up(2 * K, 8);
  L.H1p = 8 * tiles1;
  L.H2p = round_up(H2, 8 * kTiles2);
  L.rows = rows;
  int at = 0;
  auto take = [&at](int floats) {
    const int here = at;
    at += round_up(floats, 4);
    return here;
  };
  L.w1f = take(2 * L.K2 * L.H1p);   // [K2/8][H1p/8][32 lanes][4]
  L.w2f = take(2 * L.H1p * L.H2p);  // [H1p/8][H2p/8][32 lanes][4]
  L.wqm = take(K * H1);             // [K][H1]  Wq + Wm
  L.b1 = take(L.H1p);
  L.b2 = take(L.H2p);
  L.w3 = take(L.H2p);
  L.b3 = take(1);
  for (int b = 0; b < 2; ++b) {
    L.keys[b] = take(rows * T * L.S);  // [rows*T][S]
    L.q[b] = take(rows * K);           // [rows][K]
    L.mask[b] = take(rows * T);        // [rows][T]
  }
  L.a = take(rows * L.H1p);  // [rows][H1p]  q (Wq + Wm)
  L.score = take(rows * T);  // [rows][T]
  L.total = at;
  return L;
}

// the approximate reciprocal (a few ulp, far inside the tolerance): the
// IEEE-rounded one cost a seventh of the kernel's time (chip_lab_din.py)
__device__ __forceinline__ float act(float x, bool relu) {
  return relu ? fmaxf(x, 0.f) : __fdividef(1.f, 1.f + __expf(-x));
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

// x = big + small, each a TF32 value (the low 13 mantissa bits zero)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// value for a finite x in two integer operations, where the hardware
// conversion takes four (it also checks for infinities). The backward's
// kernels split with it (chip_lab_din_backward.py on an H100 80GB HBM3:
// the tile kernel splits ~290 values a thread and tile, and took 0.92 ms
// with split, 0.70 with this); the forward's keep split.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, as split, for a finite x
__device__ __forceinline__ void split_fast(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// d += a b on one 16x8x8 tile, TF32 operands, f32 accumulators (no side
// effects: the compiler may interleave independent products)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += the three products of 3xTF32 on one k-tile, the small ones first.
// They go into a fresh accumulator that one rounded f32 add takes into d:
// the tensor cores' own adds do not round to nearest, and a chain of them
// over every k-tile drifts past the f32 tolerance.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], const uint4& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a_small, b.x, b.z);
  mma(t, a_big, b.y, b.w);
  mma(t, a_big, b.x, b.z);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
}

// B fragment of an m16n8k8 product for a lane: b0 = B[k0][n], b1 = B[k1][n],
// each split, as {b0 big, b0 small, b1 big, b1 small}
__device__ __forceinline__ uint4 b_fragment(float b0, float b1) {
  uint4 f;
  split(b0, f.x, f.y);
  split(b1, f.z, f.w);
  return f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copies of a group's keys (into rows of stride S), query and
// mask. vec: K % 4 == 0 and keys 16-byte aligned, so 16-byte copies.
__device__ __forceinline__ void stage_group(long long row0, int nr, float* keys_s, float* q_s,
                                            float* mask_s, const float* __restrict__ keys,
                                            const float* __restrict__ query,
                                            const float* __restrict__ mask, int T, int K,
                                            int S, bool vec, int tid, int threads) {
  const int n = nr * T;
  const float* k_g = keys + row0 * T * K;
  if (vec) {
    const int per = K / 4;
    for (int i = tid; i < n * per; i += threads) {
      const int pos = i / per;
      const int c = 4 * (i - pos * per);
      cp_async16(keys_s + pos * S + c, k_g + static_cast<long long>(pos) * K + c);
    }
  } else {
    for (int i = tid; i < n * K; i += threads) {
      const int pos = i / K;
      cp_async4(keys_s + pos * S + (i - pos * K), k_g + i);
    }
  }
  for (int i = tid; i < nr * K; i += threads) cp_async4(q_s + i, query + row0 * K + i);
  for (int i = tid; i < n; i += threads) cp_async4(mask_s + i, mask + row0 * T + i);
}

// NT1 >= ceil(H1 / 8): layer-1 n-tiles a warp holds (a template parameter,
// so the accumulators stay in registers; tiles past H1 are skipped)
template <int NT1>
__global__ void __launch_bounds__(warps_for(NT1) * 32, 1)
din_attention_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                     const float* __restrict__ mask, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ w3,
                     const float* __restrict__ b3, float* __restrict__ out,
                     float* __restrict__ weights_out, int batch, int T, int K, int H1, int H2,
                     Layout L, bool relu, bool softmax, bool scores, bool vec) {
  constexpr int kWarps = warps_for(NT1);
  constexpr int kThreads = kWarps * 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint4* w1f = reinterpret_cast<uint4*>(smem + L.w1f);
  uint4* w2f = reinterpret_cast<uint4*>(smem + L.w2f);
  float* wqm = smem + L.wqm;
  float* b1_s = smem + L.b1;
  float* b2_s = smem + L.b2;
  float* w3_s = smem + L.w3;
  float* a_s = smem + L.a;
  float* score_s = smem + L.score;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = L.S, H1p = L.H1p, rows = L.rows;
  const int kt1 = L.K2 / 8, nt2 = L.H2p / 8;
  const long long groups = (static_cast<long long>(batch) + rows - 1) / rows;

  // the first group's copies go out before the weights are staged
  long long group = blockIdx.x;
  if (group < groups) {
    const long long row0 = group * rows;
    stage_group(row0, static_cast<int>(min(static_cast<long long>(rows), batch - row0)),
                smem + L.keys[0], smem + L.q[0], smem + L.mask[0], keys, query, mask, T, K, S,
                vec, tid, kThreads);
  }
  cp_async_commit();

  // weights, split in fragment order; lane l of a tile: g = l / 4 is the
  // n column, i = l % 4 the k row
  for (int f = tid; f < kt1 * NT1 * 32; f += kThreads) {
    const int tile = f >> 5;
    const int kt = tile / NT1;
    const int n = (tile - kt * NT1) * 8 + ((f & 31) >> 2);
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = kt * 8 + (f & 3) + 4 * h;  // row of [Wk - Wm ; Wp]
      v[h] = 0.f;
      if (n < H1 && c < K) {
        v[h] = __fsub_rn(w1[(K + c) * H1 + n], w1[(2 * K + c) * H1 + n]);
      } else if (n < H1 && c < 2 * K) {
        v[h] = w1[(2 * K + c) * H1 + n];
      }
    }
    w1f[f] = b_fragment(v[0], v[1]);
  }
  for (int f = tid; f < NT1 * nt2 * 32; f += kThreads) {
    const int tile = f >> 5;
    const int kt = tile / nt2;
    const int n = (tile - kt * nt2) * 8 + ((f & 31) >> 2);
    // layer 2 reads k-columns i and i+4 from h1 columns 2i and 2i+1
    const int r = kt * 8 + 2 * (f & 3);
    const float v0 = n < H2 && r < H1 ? w2[r * H2 + n] : 0.f;
    const float v1 = n < H2 && r + 1 < H1 ? w2[(r + 1) * H2 + n] : 0.f;
    w2f[f] = b_fragment(v0, v1);
  }
  for (int i = tid; i < K * H1; i += kThreads) wqm[i] = __fadd_rn(w1[i], w1[2 * K * H1 + i]);
  for (int i = tid; i < H1p; i += kThreads) b1_s[i] = i < H1 ? b1[i] : 0.f;
  for (int i = tid; i < L.H2p; i += kThreads) {
    b2_s[i] = i < H2 ? b2[i] : 0.f;
    w3_s[i] = i < H2 ? w3[i] : 0.f;
  }
  const float bias3 = b3[0];

  const int g = lane >> 2;  // a fragment's row (and row + 8)
  const int i4 = lane & 3;  // a fragment's column pair
  for (int it = 0; group < groups; ++it, group += gridDim.x) {
    // this group's buffer and the next one's (a select, not an index into
    // the parameter, which would copy L to the stack)
    const bool odd = it & 1;
    const long long next = group + gridDim.x;
    if (next < groups) {
      const long long row0 = next * rows;
      stage_group(row0, static_cast<int>(min(static_cast<long long>(rows), batch - row0)),
                  smem + (odd ? L.keys[0] : L.keys[1]), smem + (odd ? L.q[0] : L.q[1]),
                  smem + (odd ? L.mask[0] : L.mask[1]), keys, query, mask, T, K, S, vec, tid,
                  kThreads);
    }
    cp_async_commit();
    cp_async_wait_one();  // this group's copies are in
    __syncthreads();      // for every thread; and the weights are staged

    const long long row0 = group * rows;
    const int nr = static_cast<int>(min(static_cast<long long>(rows), batch - row0));
    const int M = nr * T;
    const float* keys_s = smem + (odd ? L.keys[1] : L.keys[0]);
    const float* q_s = smem + (odd ? L.q[1] : L.q[0]);
    const float* mask_s = smem + (odd ? L.mask[1] : L.mask[0]);

    // per row: a = q (Wq + Wm), 0 past H1
    for (int rj = tid; rj < nr * H1p; rj += kThreads) {
      const int r = rj / H1p;
      const int j = rj - r * H1p;
      float s = 0.f;
      if (j < H1) {
        for (int k = 0; k < K; ++k) s = fmaf(q_s[r * K + k], wqm[k * H1 + j], s);
      }
      a_s[rj] = s;
    }
    __syncthreads();

    // scores: one warp an m-tile of 16 positions at a time
    for (int p0 = warp * 16; p0 < M; p0 += kWarps * 16) {
      const int p_lo = p0 + g;
      const int p_hi = p_lo + 8;
      const bool v_lo = p_lo < M;
      const bool v_hi = p_hi < M;
      const int r_lo = v_lo ? p_lo / T : 0;
      const int r_hi = v_hi ? p_hi / T : 0;
      const float* k_lo = keys_s + p_lo * S;
      const float* k_hi = keys_s + p_hi * S;
      const float* q_lo = q_s + r_lo * K;
      const float* q_hi = q_s + r_hi * K;
      // column c of [k | q*k] at a position, 0 past 2K or past the group
      auto a_elem = [K](bool valid, const float* kr, const float* qr, int c) {
        if (!valid || c >= 2 * K) return 0.f;
        return c < K ? kr[c] : __fmul_rn(qr[c - K], kr[c - K]);
      };

      float h[NT1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j) h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
      for (int kt = 0; kt < kt1; ++kt) {
        const int c = kt * 8 + i4;
        uint32_t ab[4], as[4];
        split(a_elem(v_lo, k_lo, q_lo, c), ab[0], as[0]);
        split(a_elem(v_hi, k_hi, q_hi, c), ab[1], as[1]);
        split(a_elem(v_lo, k_lo, q_lo, c + 4), ab[2], as[2]);
        split(a_elem(v_hi, k_hi, q_hi, c + 4), ab[3], as[3]);
        const uint4* bp = w1f + kt * NT1 * 32 + lane;
#pragma unroll
        for (int j = 0; j < NT1; ++j) mma3(h[j], ab, as, bp[j * 32]);
      }
      // + q (Wq + Wm) + b1, the activation; this lane holds columns
      // 8j + 2*i4 and 8j + 2*i4 + 1 of rows g and g + 8
      const float* a_lo = a_s + r_lo * H1p + 2 * i4;
      const float* a_hi = a_s + r_hi * H1p + 2 * i4;
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const float2 al = *reinterpret_cast<const float2*>(a_lo + 8 * j);
        const float2 ah = *reinterpret_cast<const float2*>(a_hi + 8 * j);
        const float2 bb = *reinterpret_cast<const float2*>(b1_s + 8 * j + 2 * i4);
        h[j][0] = act((al.x + h[j][0]) + bb.x, relu);
        h[j][1] = act((al.y + h[j][1]) + bb.y, relu);
        h[j][2] = act((ah.x + h[j][2]) + bb.x, relu);
        h[j][3] = act((ah.y + h[j][3]) + bb.y, relu);
      }

      float part_lo = 0.f, part_hi = 0.f;
      for (int n0 = 0; n0 < nt2; n0 += kTiles2) {
        float z[kTiles2][4];
#pragma unroll
        for (int j = 0; j < kTiles2; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
#pragma unroll
        for (int kt = 0; kt < NT1; ++kt) {
          // h1's accumulator fragment as the A fragment, k-columns
          // (i4, i4 + 4) = h1 columns (2*i4, 2*i4 + 1)
          uint32_t ab[4], as[4];
          split(h[kt][0], ab[0], as[0]);
          split(h[kt][2], ab[1], as[1]);
          split(h[kt][1], ab[2], as[2]);
          split(h[kt][3], ab[3], as[3]);
          const uint4* bp = w2f + (kt * nt2 + n0) * 32 + lane;
#pragma unroll
          for (int j = 0; j < kTiles2; ++j) mma3(z[j], ab, as, bp[j * 32]);
        }
#pragma unroll
        for (int j = 0; j < kTiles2; ++j) {
          const int col = (n0 + j) * 8 + 2 * i4;
          const float2 bb = *reinterpret_cast<const float2*>(b2_s + col);
          const float2 ww = *reinterpret_cast<const float2*>(w3_s + col);
          part_lo = fmaf(act(z[j][0] + bb.x, relu), ww.x, part_lo);
          part_lo = fmaf(act(z[j][1] + bb.y, relu), ww.y, part_lo);
          part_hi = fmaf(act(z[j][2] + bb.x, relu), ww.x, part_hi);
          part_hi = fmaf(act(z[j][3] + bb.y, relu), ww.y, part_hi);
        }
      }
      // the four lanes of a row hold its columns
      part_lo += __shfl_xor_sync(kFull, part_lo, 1);
      part_lo += __shfl_xor_sync(kFull, part_lo, 2);
      part_hi += __shfl_xor_sync(kFull, part_hi, 1);
      part_hi += __shfl_xor_sync(kFull, part_hi, 2);
      if (i4 == 0) {
        if (v_lo) score_s[p_lo] = part_lo + bias3;
        if (v_hi) score_s[p_hi] = part_hi + bias3;
      }
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
        // the weights, for the backward, where a gradient is needed
        if (weights_out != nullptr) {
          for (int t = lane; t < T; t += 32) weights_out[row * T + t] = s[t];
        }
        const float* kr = keys_s + r * T * S;
        for (int k = lane; k < K; k += 32) {
          // four sums in flight, added at the end
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          int t = 0;
          for (; t + 4 <= T; t += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u) p[u] = fmaf(s[t + u], kr[(t + u) * S + k], p[u]);
          }
          for (; t < T; ++t) p[0] = fmaf(s[t], kr[t * S + k], p[0]);
          out[row * K + k] = (p[0] + p[1]) + (p[2] + p[3]);
        }
      }
    }
    __syncthreads();  // scores, a and this buffer are rewritten by the next groups
  }
}

// --- din_attention_global_kernel: the shapes the tiled kernel does not take
constexpr int kZTiles = 5;  // layer-2 n-tiles of a z-chunk: 40 columns, one wgmma width
constexpr int kTermRows = 16;   // rows a block of the row-term kernel
constexpr int kTermCols = 128;  // columns (threads) a block of it
constexpr int kTermK = 64;      // columns of the query it stages at once

// warps a block, in warpgroups of 4: 12 where a thread may keep 168
// registers (an h-chunk's 4 * NH accumulators, a step's fresh ones, a
// z-chunk's 20), 8 for the widest h-chunk
__host__ __device__ constexpr int global_warps(int nh) { return nh <= 10 ? 12 : 8; }

// The global kernel's chunks and shared memory, offsets in floats, each
// 16-byte aligned. A W1 chunk is [jb blocks][4 k-steps][big, small][8 nh
// x 8] (stage_w1), a W2 block [nh k-steps][big, small][40 x 8] (stage_w2).
struct GlobalPlan {
  int hchunks;   // h-chunks of H1
  int zchunks;   // z-chunks of H2
  int nb;        // 16-column blocks of K
  int jb;        // blocks of a W1 chunk
  int jchunks;   // W1 chunks of an h-chunk
  int resident;  // every chunk staged once a block
  int rows;      // batch rows a group
  int Kp, H1p;   // 16 * nb; 8 * nh * hchunks
  int w1, w2, q, a, red;
  long long total;
};

GlobalPlan make_global_plan(int K, int H1, int H2, int nh, int rows, int jb, bool resident) {
  GlobalPlan P;
  P.hchunks = ((H1 + 7) / 8 + nh - 1) / nh;
  P.zchunks = ((H2 + 7) / 8 + kZTiles - 1) / kZTiles;
  P.nb = (K + 15) / 16;
  P.jb = resident ? P.nb : jb;
  P.jchunks = (P.nb + P.jb - 1) / P.jb;
  P.resident = resident;
  P.rows = rows;
  P.Kp = 16 * P.nb;
  P.H1p = 8 * nh * P.hchunks;
  const long long c1 = 64LL * P.jb * 8 * nh;    // floats of a W1 chunk
  const long long c2 = 16LL * nh * 8 * kZTiles;  // floats of a W2 block
  long long at = 0;
  auto take = [&at](long long floats) {
    const long long here = at;
    at += (floats + 3) / 4 * 4;
    return static_cast<int>(here < INT32_MAX ? here : 0);
  };
  P.w1 = take(resident ? c1 * P.hchunks * P.jchunks : c1);
  P.w2 = take(resident ? c2 * P.hchunks * P.zchunks : c2);
  P.q = take(static_cast<long long>(rows) * P.Kp);
  P.a = take(static_cast<long long>(rows) * P.H1p);
  P.red = take(4 * 32 * global_warps(nh));
  P.total = at;
  return P;
}

// --- wgmma: m64nNk8 TF32 products of a warpgroup, A from registers (each
// warp its 16 rows, in mma.sync's m16n8k8 fragment layout), B from shared
// memory as K-major core matrices of 8 rows x 16 bytes: element (n, k) of
// an N x 8 matrix at byte (n / 8) * kSbo + (k / 4) * kLbo + (n % 8) * 16 +
// (k % 4) * 4, no swizzle. The accumulators take mma.sync's layout too:
// d[4 j + e] holds rows g, g + 8 and columns 8 j + 2 i4, + 1 of n-tile j.
constexpr int kLbo = 128;  // bytes from the first 4 k-columns to the next 4
constexpr int kSbo = 256;  // bytes from 8 rows to the next 8

__device__ __forceinline__ int core_offset(int n, int k) {  // in floats
  return (n >> 3) * (kSbo / 4) + (k >> 2) * (kLbo / 4) + (n & 7) * 4 + (k & 3);
}

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (N / 2 floats a thread) += a b (= a b where accumulate is 0)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<40>(float (&d)[20], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<80>(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (N / 2 floats a thread) = a b: the first product of a fresh accumulator
template <int N>
__device__ __forceinline__ void wgmma_tf32_first(float (&d)[N / 2], const uint32_t (&a)[4],
                                                 uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32_first<32>(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<40>(float (&d)[20], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<64>(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<80>(float (&d)[40], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<128>(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
        "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}


// acc += the three products of 3xTF32 of one k-step, the small ones first,
// into a fresh accumulator that one rounded f32 add a value takes into acc
// (as mma3); A's values a warp's rows g (lo) and g + 8 (hi), columns i4 (0)
// and i4 + 4 (1); b the step's big part, its small part N x 8 floats on
template <int N>
__device__ __forceinline__ void wg_step(float (&acc)[N / 2], float lo0, float hi0, float lo1,
                                        float hi1, const float* b) {
  uint32_t ab[4], as[4];
  split(lo0, ab[0], as[0]);
  split(hi0, ab[1], as[1]);
  split(lo1, ab[2], as[2]);
  split(hi1, ab[3], as[3]);
  const uint64_t big = smem_desc(b), small = smem_desc(b + N * 8);
  float t[N / 2];
  wg_fence();
  wgmma_tf32_first<N>(t, as, big);
  wgmma_tf32<N>(t, ab, small, 1);
  wgmma_tf32<N>(t, ab, big, 1);
  wg_commit();
  wg_wait_all();
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
}

// Stage W1 chunk (hc, jc) into dst, split: [jb blocks][4 k-steps][big,
// small][8 NH x 8 K-major]; k-step 2j + s of block j takes [Wk - Wm] rows
// 16 j + 4 (k % 4) + 2 s + k / 4 as its columns k (a lane's float4 of keys
// gives its columns i4 and i4 + 4 of both), k-steps 2j + 2, 2j + 3 [Wp]'s
template <int NH>
__device__ __forceinline__ void stage_w1(float* dst, const float* __restrict__ w1, int K, int H1,
                                         const GlobalPlan& P, int hc, int jc, int tid) {
  constexpr int N = 8 * NH;
  const int n_el = P.jb * 4 * N * 8;
  for (int f = tid; f < n_el; f += 32 * global_warps(NH)) {
    const int k = f & 7;
    const int n = (f >> 3) % N;
    const int step = (f >> 3) / N;
    const int sub = step & 3;
    const int c = 16 * (jc * P.jb + (step >> 2)) + 4 * (k & 3) + 2 * (sub & 1) + (k >> 2);
    const int col = hc * N + n;
    float v = 0.f;
    if (col < H1 && c < K) {
      v = sub < 2 ? __fsub_rn(w1[(K + c) * H1 + col], w1[(2 * K + c) * H1 + col])
                  : w1[(3 * K + c) * H1 + col];
    }
    uint32_t big, small;
    split(v, big, small);
    float* m = dst + step * 2 * N * 8 + core_offset(n, k);
    m[0] = __uint_as_float(big);
    m[N * 8] = __uint_as_float(small);
  }
}

// Stage the W2 block of h-chunk hc and z-chunk zc into dst: [NH k-steps]
// [big, small][40 x 8 K-major]; layer 2 reads its k-columns i and i + 4
// from h1 columns 2i and 2i + 1 (a lane's pair of an accumulator tile)
template <int NH>
__device__ __forceinline__ void stage_w2(float* dst, const float* __restrict__ w2, int H1, int H2,
                                         int hc, int zc, int tid) {
  constexpr int N = 8 * kZTiles;
  const int n_el = NH * N * 8;
  for (int f = tid; f < n_el; f += 32 * global_warps(NH)) {
    const int k = f & 7;
    const int n = (f >> 3) % N;
    const int kt = (f >> 3) / N;
    const int r = (hc * NH + kt) * 8 + 2 * (k & 3) + (k >> 2);
    const int col = zc * N + n;
    const float v = col < H2 && r < H1 ? w2[r * H2 + col] : 0.f;
    uint32_t big, small;
    split(v, big, small);
    float* m = dst + kt * 2 * N * 8 + core_offset(n, k);
    m[0] = __uint_as_float(big);
    m[N * 8] = __uint_as_float(small);
  }
}

// A lane's 4 columns of a 16-column block of one position's key, zero past
// K or for a position past the group
__device__ __forceinline__ float4 load_key4(const float* __restrict__ kr, bool valid, int c, int K,
                                            bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!valid || c >= K) return v;
  if (vec) return __ldg(reinterpret_cast<const float4*>(kr + c));
  v.x = __ldg(kr + c);
  if (c + 1 < K) v.y = __ldg(kr + c + 1);
  if (c + 2 < K) v.z = __ldg(kr + c + 2);
  if (c + 3 < K) v.w = __ldg(kr + c + 3);
  return v;
}

// The per-row term a = b1 + q (Wq + Wm) of every row, [batch][H1], in f32
// (k in order, b1 first): a block takes kTermRows rows by kTermCols
// columns, a thread one column of every row, the rows' queries staged in
// shared memory kTermK columns at a time. Run before the global kernel,
// which reads each group's rows.
// (a block of kTermCols threads: rows kTermRows bx.., columns kTermCols by..)
__device__ __forceinline__ void row_terms_block(const float* __restrict__ query,
                                                const float* __restrict__ w1,
                                                const float* __restrict__ b1,
                                                float* __restrict__ terms, int batch, int K,
                                                int H1, long long bx, int by) {
  __shared__ float q_s[kTermRows][kTermK];
  const int tid = threadIdx.x;
  const long long row0 = bx * kTermRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kTermRows), batch - row0));
  const int j = by * kTermCols + tid;
  float acc[kTermRows];
#pragma unroll
  for (int r = 0; r < kTermRows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTermK) {
    const int kn = min(kTermK, K - k0);
    __syncthreads();  // the last columns are read
    for (int i = tid; i < kTermRows * kTermK; i += kTermCols) {
      const int r = i / kTermK;
      const int c = i - r * kTermK;
      q_s[r][c] = r < nr && c < kn ? query[(row0 + r) * K + k0 + c] : 0.f;
    }
    __syncthreads();
    if (j < H1) {
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float w = __fadd_rn(__ldg(w1 + static_cast<long long>(k0 + k) * H1 + j),
                                  __ldg(w1 + static_cast<long long>(2 * K + k0 + k) * H1 + j));
#pragma unroll
        for (int r = 0; r < kTermRows; ++r) acc[r] = fmaf(q_s[r][k], w, acc[r]);
      }
    }
  }
  if (j < H1) {
    const float bj = __ldg(b1 + j);
    for (int r = 0; r < nr; ++r) terms[(row0 + r) * H1 + j] = bj + acc[r];
  }
}

__global__ void __launch_bounds__(kTermCols)
din_attention_global_kernel_row_terms(const float* __restrict__ query,
                                      const float* __restrict__ w1,
                                      const float* __restrict__ b1, float* __restrict__ terms,
                                      int batch, int K, int H1) {
  row_terms_block(query, w1, b1, terms, batch, K, H1, blockIdx.x, blockIdx.y);
}

template <int NH>
__global__ void __launch_bounds__(32 * global_warps(NH), 1)
din_attention_global_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                            const float* __restrict__ mask, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2, const float* __restrict__ w3,
                            const float* __restrict__ b3, float* __restrict__ out,
                            const float* __restrict__ terms, float* __restrict__ scores,
                            int batch, int T, int K, int H1, int H2, GlobalPlan P, bool relu,
                            bool softmax, bool pool, bool vec) {
  constexpr int kGlobalWarps = global_warps(NH);
  constexpr int kGlobalThreads = 32 * kGlobalWarps;
  constexpr int kGroups = kGlobalWarps / 4;  // warpgroups
  constexpr int N1 = 8 * NH;
  constexpr int N2 = 8 * kZTiles;
  extern __shared__ __align__(1024) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w1f = smem + P.w1;
  float* w2f = smem + P.w2;
  float* q_s = smem + P.q;
  float* a_s = smem + P.a;
  float* red = smem + P.red;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // a fragment's row (and row + 8)
  const int i4 = lane & 3;  // a fragment's column pair
  const int rows = P.rows, Kp = P.Kp, H1p = P.H1p;
  const int c1 = P.jb * 4 * 2 * N1 * 8;  // floats of a W1 chunk
  constexpr int c2 = NH * 2 * N2 * 8;    // floats of a W2 block
  const float bias3 = b3[0];
  const long long groups = (static_cast<long long>(batch) + rows - 1) / rows;

  if (P.resident) {
    for (int hc = 0; hc < P.hchunks; ++hc) {
      for (int jc = 0; jc < P.jchunks; ++jc)
        stage_w1<NH>(w1f + (hc * P.jchunks + jc) * c1, w1, K, H1, P, hc, jc, tid);
      for (int zc = 0; zc < P.zchunks; ++zc)
        stage_w2<NH>(w2f + (hc * P.zchunks + zc) * c2, w2, H1, H2, hc, zc, tid);
    }
  }

  for (long long group = blockIdx.x; group < groups; group += gridDim.x) {
    const long long row0 = group * rows;
    const int nr = static_cast<int>(min(static_cast<long long>(rows), batch - row0));
    for (int i = tid; i < nr * Kp; i += kGlobalThreads) {
      const int r = i / Kp;
      const int c = i - r * Kp;
      q_s[i] = c < K ? query[(row0 + r) * K + c] : 0.f;
    }
    // the group's per-row terms, 0 past H1
    for (int i = tid; i < nr * H1p; i += kGlobalThreads) {
      const int r = i / H1p;
      const int j = i - r * H1p;
      a_s[i] = j < H1 ? terms[(row0 + r) * H1 + j] : 0.f;
    }
    __syncthreads();  // q and a; and the weights, where resident

    // scores: a warpgroup a tile of 64 positions at a time, each warp its
    // 16; where the chunks are staged in turn, the warpgroups go in passes
    const int M = nr * T;
    const int tiles = (M + 63) / 64;
    const int wg = warp >> 2;
    for (int base = 0; base < tiles; base += kGroups) {
      const int tile = base + wg;
      const bool active = tile < tiles;
      if (!active && P.resident) break;
      const int p_lo = tile * 64 + 16 * (warp & 3) + g;
      const int p_hi = p_lo + 8;
      const bool v_lo = active && p_lo < M;
      const bool v_hi = active && p_hi < M;
      const int r_lo = v_lo ? p_lo / T : 0;
      const int r_hi = v_hi ? p_hi / T : 0;
      const float* k_lo = keys + (row0 * T + (v_lo ? p_lo : 0)) * K;
      const float* k_hi = keys + (row0 * T + (v_hi ? p_hi : 0)) * K;
      const float* qs_lo = q_s + r_lo * Kp + 4 * i4;
      const float* qs_hi = q_s + r_hi * Kp + 4 * i4;
      float part_lo = 0.f, part_hi = 0.f;
      for (int zc = 0; zc < P.zchunks; ++zc) {
        float z[N2 / 2];
#pragma unroll
        for (int i = 0; i < N2 / 2; ++i) z[i] = 0.f;
        for (int hc = 0; hc < P.hchunks; ++hc) {
          float h[N1 / 2];
#pragma unroll
          for (int i = 0; i < N1 / 2; ++i) h[i] = 0.f;
          for (int jc = 0; jc < P.jchunks; ++jc) {
            const float* w1c = w1f;
            if (P.resident) {
              w1c += (hc * P.jchunks + jc) * c1;
            } else {
              __syncthreads();  // every warp is done with the last chunk
              stage_w1<NH>(w1f, w1, K, H1, P, hc, jc, tid);
              if (jc == 0) stage_w2<NH>(w2f, w2, H1, H2, hc, zc, tid);
              __syncthreads();
            }
            if (!active) continue;
            // layer 1 over the chunk's blocks, the next block's keys in
            // flight while a block's products run
            const int j0 = jc * P.jb;
            const int j1 = min(P.nb, j0 + P.jb);
            float4 kl = load_key4(k_lo, v_lo, 16 * j0 + 4 * i4, K, vec);
            float4 kh = load_key4(k_hi, v_hi, 16 * j0 + 4 * i4, K, vec);
            for (int j = j0; j < j1; ++j) {
              const float4 cl = kl, ch = kh;
              if (j + 1 < j1) {
                kl = load_key4(k_lo, v_lo, 16 * (j + 1) + 4 * i4, K, vec);
                kh = load_key4(k_hi, v_hi, 16 * (j + 1) + 4 * i4, K, vec);
              }
              const float4 ql = *reinterpret_cast<const float4*>(qs_lo + 16 * j);
              const float4 qh = *reinterpret_cast<const float4*>(qs_hi + 16 * j);
              const float* bp = w1c + (j - j0) * 4 * 2 * N1 * 8;
              wg_step<N1>(h, cl.x, ch.x, cl.y, ch.y, bp);
              wg_step<N1>(h, cl.z, ch.z, cl.w, ch.w, bp + 2 * N1 * 8);
              wg_step<N1>(h, __fmul_rn(ql.x, cl.x), __fmul_rn(qh.x, ch.x),
                          __fmul_rn(ql.y, cl.y), __fmul_rn(qh.y, ch.y), bp + 4 * N1 * 8);
              wg_step<N1>(h, __fmul_rn(ql.z, cl.z), __fmul_rn(qh.z, ch.z),
                          __fmul_rn(ql.w, cl.w), __fmul_rn(qh.w, ch.w), bp + 6 * N1 * 8);
            }
          }
          if (!active) continue;
          // + the per-row term, the activation; this lane holds columns
          // 8j + 2*i4 and 8j + 2*i4 + 1 of the h-chunk, rows g and g + 8
          const float* a_lo = a_s + r_lo * H1p + hc * N1 + 2 * i4;
          const float* a_hi = a_s + r_hi * H1p + hc * N1 + 2 * i4;
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            const float2 al = *reinterpret_cast<const float2*>(a_lo + 8 * j);
            const float2 ah = *reinterpret_cast<const float2*>(a_hi + 8 * j);
            h[4 * j] = act(al.x + h[4 * j], relu);
            h[4 * j + 1] = act(al.y + h[4 * j + 1], relu);
            h[4 * j + 2] = act(ah.x + h[4 * j + 2], relu);
            h[4 * j + 3] = act(ah.y + h[4 * j + 3], relu);
          }
          // layer 2: the h-chunk's accumulator tiles as A fragments
          const float* w2c = w2f + (P.resident ? (hc * P.zchunks + zc) * c2 : 0);
#pragma unroll
          for (int kt = 0; kt < NH; ++kt) {
            wg_step<N2>(z, h[4 * kt], h[4 * kt + 2], h[4 * kt + 1], h[4 * kt + 3],
                        w2c + kt * 2 * N2 * 8);
          }
        }
        if (!active) continue;
#pragma unroll
        for (int j = 0; j < kZTiles; ++j) {
          const int col = zc * N2 + 8 * j + 2 * i4;
          const float bx = col < H2 ? __ldg(b2 + col) : 0.f;
          const float by = col + 1 < H2 ? __ldg(b2 + col + 1) : 0.f;
          const float wx = col < H2 ? __ldg(w3 + col) : 0.f;
          const float wy = col + 1 < H2 ? __ldg(w3 + col + 1) : 0.f;
          part_lo = fmaf(act(z[4 * j] + bx, relu), wx, part_lo);
          part_lo = fmaf(act(z[4 * j + 1] + by, relu), wy, part_lo);
          part_hi = fmaf(act(z[4 * j + 2] + bx, relu), wx, part_hi);
          part_hi = fmaf(act(z[4 * j + 3] + by, relu), wy, part_hi);
        }
      }
      if (!active) continue;
      // the four lanes of a row hold its columns
      part_lo += __shfl_xor_sync(kFull, part_lo, 1);
      part_lo += __shfl_xor_sync(kFull, part_lo, 2);
      part_hi += __shfl_xor_sync(kFull, part_hi, 1);
      part_hi += __shfl_xor_sync(kFull, part_hi, 2);
      if (i4 == 0) {
        if (v_lo) scores[row0 * T + p_lo] = part_lo + bias3;
        if (v_hi) scores[row0 * T + p_hi] = part_hi + bias3;
      }
    }
    __syncthreads();  // the group's scores are written

    // mask and softmax: a warp a row, or the warps split over fewer rows
    float* sc = scores + row0 * T;
    const float* mk = mask + row0 * T;
    if (nr >= kGlobalWarps) {
      for (int r = warp; r < nr; r += kGlobalWarps) {
        float* s = sc + static_cast<long long>(r) * T;
        const float* m = mk + static_cast<long long>(r) * T;
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
      }
    } else {
      const int per = kGlobalWarps / nr;  // warps a row
      const int r = warp / per;
      const bool mine = r < nr;
      float* s = sc + static_cast<long long>(mine ? r : 0) * T;
      const float* m = mk + static_cast<long long>(mine ? r : 0) * T;
      const int first = (warp - r * per) * 32 + lane;
      const int stride = per * 32;
      if (softmax) {
        float mx = -INFINITY;
        if (mine) {
          for (int t = first; t < T; t += stride) {
            const float v = m[t] > 0.5f ? s[t] : kNegInf;
            s[t] = v;
            mx = fmaxf(mx, v);
          }
        }
        mx = warp_max(mx);
        if (lane == 0) red[warp] = mx;
        __syncthreads();
        float sum = 0.f;
        if (mine) {
          mx = red[r * per];
          for (int i = 1; i < per; ++i) mx = fmaxf(mx, red[r * per + i]);
          for (int t = first; t < T; t += stride) {
            const float e = expf(s[t] - mx);
            s[t] = e;
            sum += e;
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) red[kGlobalWarps + warp] = sum;
        __syncthreads();
        if (mine) {
          sum = red[kGlobalWarps + r * per];
          for (int i = 1; i < per; ++i) sum += red[kGlobalWarps + r * per + i];
          for (int t = first; t < T; t += stride) s[t] = s[t] / sum;
        }
      } else if (mine) {
        for (int t = first; t < T; t += stride) s[t] = m[t] > 0.5f ? s[t] : 0.f;
      }
    }
    __syncthreads();  // the weights are final

    if (pool) {
      // out[r][c..] = sum_t w[r][t] keys[r][t][c..], cw columns a pair
      const int cw = vec ? 4 : 1;
      const int cols = K / cw;
      const int pairs = nr * cols;
      const float* kg = keys + row0 * T * K;
      auto pool_sum = [&](int pr, int t0, int t1, float (&sum)[4]) {
        const int r = pr / cols;
        const int c = (pr - r * cols) * cw;
        const float* w = sc + static_cast<long long>(r) * T;
        const float* kr = kg + static_cast<long long>(r) * T * K + c;
        float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
        int t = t0;
        if (vec) {
          for (; t + 2 <= t1; t += 2) {
            const float4 x0 = __ldg(reinterpret_cast<const float4*>(kr + static_cast<long long>(t) * K));
            const float4 x1 = __ldg(reinterpret_cast<const float4*>(kr + static_cast<long long>(t + 1) * K));
            const float u0 = w[t], u1 = w[t + 1];
            p0.x = fmaf(u0, x0.x, p0.x); p0.y = fmaf(u0, x0.y, p0.y);
            p0.z = fmaf(u0, x0.z, p0.z); p0.w = fmaf(u0, x0.w, p0.w);
            p1.x = fmaf(u1, x1.x, p1.x); p1.y = fmaf(u1, x1.y, p1.y);
            p1.z = fmaf(u1, x1.z, p1.z); p1.w = fmaf(u1, x1.w, p1.w);
          }
          if (t < t1) {
            const float4 x0 = __ldg(reinterpret_cast<const float4*>(kr + static_cast<long long>(t) * K));
            const float u0 = w[t];
            p0.x = fmaf(u0, x0.x, p0.x); p0.y = fmaf(u0, x0.y, p0.y);
            p0.z = fmaf(u0, x0.z, p0.z); p0.w = fmaf(u0, x0.w, p0.w);
          }
        } else {
          for (; t + 4 <= t1; t += 4) {
            p0.x = fmaf(w[t], __ldg(kr + static_cast<long long>(t) * K), p0.x);
            p0.y = fmaf(w[t + 1], __ldg(kr + static_cast<long long>(t + 1) * K), p0.y);
            p0.z = fmaf(w[t + 2], __ldg(kr + static_cast<long long>(t + 2) * K), p0.z);
            p0.w = fmaf(w[t + 3], __ldg(kr + static_cast<long long>(t + 3) * K), p0.w);
          }
          for (; t < t1; ++t) p0.x = fmaf(w[t], __ldg(kr + static_cast<long long>(t) * K), p0.x);
          p0 = make_float4((p0.x + p0.y) + (p0.z + p0.w), 0.f, 0.f, 0.f);
        }
        sum[0] = p0.x + p1.x;
        sum[1] = p0.y + p1.y;
        sum[2] = p0.z + p1.z;
        sum[3] = p0.w + p1.w;
      };
      auto store = [&](int pr, const float (&sum)[4]) {
        const int r = pr / cols;
        float* o = out + (row0 + r) * K + (pr - r * cols) * cw;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(sum[0], sum[1], sum[2], sum[3]);
        } else {
          o[0] = sum[0];
        }
      };
      if (pairs >= kGlobalThreads) {
        for (int pr = tid; pr < pairs; pr += kGlobalThreads) {
          float sum[4];
          pool_sum(pr, 0, T, sum);
          store(pr, sum);
        }
      } else {
        // T in S slices, their sums added in order
        const int S = min(T, kGlobalThreads / pairs);
        const int pr = tid % pairs;
        const int s = tid / pairs;
        if (s < S) {
          float sum[4];
          pool_sum(pr, static_cast<int>(static_cast<long long>(s) * T / S),
                   static_cast<int>((static_cast<long long>(s) + 1) * T / S), sum);
          for (int e = 0; e < cw; ++e) red[(s * pairs + pr) * cw + e] = sum[e];
        }
        __syncthreads();
        if (tid < pairs) {
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
          for (int i = 0; i < S; ++i)
            for (int e = 0; e < cw; ++e) sum[e] += red[(i * pairs + tid) * cw + e];
          store(tid, sum);
        }
      }
    }
    __syncthreads();  // q, a, red and the scores are rewritten by the next groups
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int, int, int, Layout, bool,
                        bool, bool, bool);

// layer-1 n-tiles that have an instantiation; a width rounds up
constexpr int kTiles1[] = {2, 4, 6, 8, 10, 12, 16, 24, 32};
constexpr int kNumTiles1 = 9;
const Kernel kKernels[kNumTiles1] = {
    din_attention_kernel<2>,  din_attention_kernel<4>,  din_attention_kernel<6>,
    din_attention_kernel<8>,  din_attention_kernel<10>, din_attention_kernel<12>,
    din_attention_kernel<16>, din_attention_kernel<24>, din_attention_kernel<32>};

int tiles_slot(int H1) {
  const int need = (H1 + 7) / 8;
  for (int s = 0; s < kNumTiles1; ++s)
    if (kTiles1[s] >= need) return s;
  return -1;
}


using GlobalKernel = void (*)(const float*, const float*, const float*, const float*,
                              const float*, const float*, const float*, const float*,
                              const float*, float*, const float*, float*, int, int, int, int, int,
                              GlobalPlan, bool, bool, bool, bool);

// h-chunk widths, in n-tiles, that have an instantiation: the one that pads
// H1 the least (the widest on a tie)
constexpr int kHTiles[] = {4, 8, 10, 16};
constexpr int kNumHTiles = 4;
const GlobalKernel kGlobalKernels[kNumHTiles] = {
    din_attention_global_kernel<4>, din_attention_global_kernel<8>,
    din_attention_global_kernel<10>, din_attention_global_kernel<16>};

int h_tiles_slot(int H1) {
  const int need = (H1 + 7) / 8;
  int best = 0;
  for (int s = 1; s < kNumHTiles; ++s) {
    const int pad = (need + kHTiles[s] - 1) / kHTiles[s] * kHTiles[s];
    const int pad_best = (need + kHTiles[best] - 1) / kHTiles[best] * kHTiles[best];
    if (pad <= pad_best) best = s;
  }
  return best;
}
// The global kernel's plan for a shape, searched once a shape and device
// and kept: the search asks the occupancy of every group size, which costs
// more host time than a launch
struct GlobalLaunch {
  int device, batch, T, K, H1, H2;
  GlobalPlan plan;
  long long blocks;
};

cudaError_t global_launch(int device, int batch, int T, int K, int H1, int H2,
                          GlobalLaunch& out) {
  static std::mutex lock;
  static std::vector<GlobalLaunch> known;
  std::lock_guard<std::mutex> hold(lock);
  for (const GlobalLaunch& g : known) {
    if (g.device == device && g.batch == batch && g.T == T && g.K == K && g.H1 == H1 &&
        g.H2 == H2) {
      out = g;
      return cudaSuccess;
    }
  }
  const int slot = h_tiles_slot(H1);
  const int nh = kHTiles[slot];
  const GlobalKernel kernel = kGlobalKernels[slot];
  const int warps = global_warps(nh);
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSharedBytes));
  }
  if (err != cudaSuccess) return err;
  // the chunks stay where they all fit; the group size with the fewest
  // rounds of 64-position tiles over the grid's waves, counting half a
  // round for a group's fixed work (the smaller group on a tie)
  const bool resident =
      sizeof(float) * make_global_plan(K, H1, H2, nh, 1, 1, true).total <= kMaxSharedBytes;
  GlobalLaunch best{device, batch, T, K, H1, H2, {}, 0};
  double best_cost = -1.0;
  const int most = batch < kMaxRows ? batch : kMaxRows;
  for (int rows = 1; rows <= most; ++rows) {
    GlobalPlan P = make_global_plan(K, H1, H2, nh, rows, 1, resident);
    if (sizeof(float) * P.total > kMaxSharedBytes) break;
    if (!resident) {
      // as many blocks of K a W1 chunk as the rest leaves room for
      const long long per_block = 4LL * 4 * nh * 128;
      const long long room = kMaxSharedBytes - sizeof(float) * P.total;
      const long long more = room / per_block;
      P = make_global_plan(K, H1, H2, nh, rows,
                           static_cast<int>(1 + more < P.nb ? 1 + more : P.nb), false);
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps,
                                                        sizeof(float) * P.total);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) break;
    const long long blocks = static_cast<long long>(sms) * per_sm;
    const long long groups = (static_cast<long long>(batch) + rows - 1) / rows;
    const long long tiles = (static_cast<long long>(rows) * T + 63) / 64;
    const long long rounds = (tiles + warps / 4 - 1) / (warps / 4);
    const double cost = static_cast<double>((groups + blocks - 1) / blocks) * (rounds + 0.5);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best.plan = P;
      best.blocks = blocks < groups ? blocks : groups;
    }
  }
  if (best_cost < 0) return cudaErrorInvalidValue;
  known.push_back(best);
  out = best;
  return cudaSuccess;
}

// --- din_attention_backward: the hand-written backward (the counterpart of
// _din_remat_bwd in recommender_system_tpu/ops/din_vjp.py, which is XLA)
constexpr int kBackWarps = 16;  // most warps a block: each takes one m-tile of a pass
constexpr int kGroup = 40;      // columns of an h-, z- or n-group: 5 n-tiles
constexpr int kGroupTiles = 5;
constexpr int kPrepThreads = 256;
// the fewest warps a block takes with the weights in shared memory, before
// it takes the most with them in device memory
constexpr int kLeastSmemWarps = 8;

// The backward's plan: the padded widths, the warps a block (a pass holds
// MT = 16 * warps positions), the row strides, and three regions, each in
// shared memory where it fits or else in device memory: a pass's
// activations (per block), the packed weights (one copy, which the pack
// kernel writes), and the weight gradients' running sums (per block).
// Offsets in floats within their region, each 16-byte aligned.
struct BackPlan {
  int Kp;   // K rounded up to 16: each part of [k | q*k | q]
  int H1p;  // H1 rounded up to whole groups
  int H1m;  // H1p rounded up to 16: the m-tiles of dW2
  int H2p;  // H2 rounded up to whole groups
  int warps, MT, R;  // warps a block, positions a pass, rows a pass spans at most
  int Sk, Sh, Su, Sw, Sw2;  // strides: keys, h1 / dh, du, WX, W2
  long long act, wts, acc;  // region sizes
  long long o_keys, o_q, o_dl, o_s, o_rr, o_h, o_u, o_red, o_rs;  // in act
  long long o_wx, o_w2, o_b2, o_w3;                          // in wts
  long long o_ax, o_a2, o_ab1, o_ab2, o_aw3, o_ab3;          // in acc
  int act_smem, acc_smem;
  long long staged;  // floats of the weights' head in shared memory: all, WX's [Wk - Wm ; Wp], or 0
  long long smem;    // bytes
  long long blocks;  // the grid, and the number of partial sums
};

// which of the weights a plan stages in shared memory
enum Staged { kAllWeights, kLayer1, kNoWeights };

// The running sums' layout from Kp, H1p, H1m and H2p, offsets in floats:
// [Wk - Wm ; Wp ; Wq + Wm]'s gradient (3 Kp rows of H1p), W2's (H1m rows of
// H2p), db1, db2, dw3 and db3; din_backward_reduce reads a block's partial
// sums in this layout
void sums_layout(BackPlan& L) {
  long long at = 0;
  auto take = [&at](long long floats) {
    const long long here = at;
    at += (floats + 3) / 4 * 4;
    return here;
  };
  L.o_ax = take(3LL * L.Kp * L.H1p);
  L.o_a2 = take(static_cast<long long>(L.H1m) * L.H2p);
  L.o_ab1 = take(L.H1p);
  L.o_ab2 = take(L.H2p);
  L.o_aw3 = take(L.H2p);
  L.o_ab3 = take(1);
  L.acc = at;
}

BackPlan make_back_plan(int T, int K, int H1, int H2, int warps, bool act_smem, Staged staged,
                        bool acc_smem) {
  BackPlan L;
  L.Kp = round_up(K, 16);
  L.H1p = round_up(H1, kGroup);
  L.H1m = round_up(L.H1p, 16);
  L.H2p = round_up(H2, kGroup);
  L.warps = warps;
  L.MT = 16 * warps;
  L.R = (L.MT + T - 2) / T + 1;
  if (L.R > L.MT) L.R = L.MT;
  L.Sk = L.Kp + 4;
  L.Sh = L.H1m + 4;
  L.Su = L.H2p + 4;
  L.Sw = L.H1p + 4;
  L.Sw2 = L.H2p + 4;
  long long at = 0;
  auto take = [&at](long long floats) {
    const long long here = at;
    at += (floats + 3) / 4 * 4;
    return here;
  };
  L.o_keys = take(static_cast<long long>(L.MT) * L.Sk);
  L.o_q = take(static_cast<long long>(L.R) * L.Kp);
  L.o_dl = take(L.MT);
  L.o_s = take(L.MT);
  L.o_rr = take(L.MT);
  L.o_h = take(static_cast<long long>(L.MT) * L.Sh);
  L.o_u = take(static_cast<long long>(L.MT) * L.Su);
  L.o_red = take(static_cast<long long>(warps) * (L.H1p + 2 * L.H2p));
  L.o_rs = take(static_cast<long long>(L.R) * L.H1p);
  L.act = at;
  at = 0;
  L.o_wx = take(3LL * L.Kp * L.Sw);
  L.o_w2 = take(static_cast<long long>(L.H1p) * L.Sw2);
  L.o_b2 = take(L.H2p);
  L.o_w3 = take(L.H2p);
  L.wts = at;
  sums_layout(L);
  L.act_smem = act_smem;
  L.acc_smem = acc_smem;
  L.staged = staged == kAllWeights ? L.wts : staged == kLayer1 ? 2LL * L.Kp * L.Sw : 0;
  L.smem = 4 * ((act_smem ? L.act : 0) + L.staged + (acc_smem ? L.acc : 0));
  L.blocks = 0;
  return L;
}

// acc[j] += A B over k_tiles k-tiles of 8, 3xTF32 (mma3), for a warp's
// 16 x (8 NT) tile: a(r, k) is A's row r (0..15), column k; b(k, j) is B's
// row k, column g of n-tile j (g = lane / 4, which b captures)
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], int k_tiles, int g, int i4, FA a,
                                         FB b) {
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k = kt * 8 + i4;
    uint32_t ab[4], as[4];
    split_fast(a(g, k), ab[0], as[0]);
    split_fast(a(g + 8, k), ab[1], as[1]);
    split_fast(a(g, k + 4), ab[2], as[2]);
    split_fast(a(g + 8, k + 4), ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint4 f;
      split_fast(b(k, j), f.x, f.y);
      split_fast(b(k + 4, j), f.z, f.w);
      mma3(acc[j], ab, as, f);
    }
  }
}

// out's tile (rows m0 + 0..15, columns n0 + 0..39, row stride ld) += the
// product over k_tiles k-tiles: the k-tiles' fresh products are added in
// order to the tile's running sum, read and written back
template <typename FA, typename FB>
__device__ __forceinline__ void task_mma(float* out, long long ld, int m0, int n0, int k_tiles,
                                         int g, int i4, FA a, FB b) {
  float acc[kGroupTiles][4];
  float* lo = out + (m0 + g) * ld + n0 + 2 * i4;
  float* hi = lo + 8 * ld;
#pragma unroll
  for (int j = 0; j < kGroupTiles; ++j) {
    acc[j][0] = lo[8 * j];
    acc[j][1] = lo[8 * j + 1];
    acc[j][2] = hi[8 * j];
    acc[j][3] = hi[8 * j + 1];
  }
  tile_mma<kGroupTiles>(acc, k_tiles, g, i4, a, b);
#pragma unroll
  for (int j = 0; j < kGroupTiles; ++j) {
    lo[8 * j] = acc[j][0];
    lo[8 * j + 1] = acc[j][1];
    hi[8 * j] = acc[j][2];
    hi[8 * j + 1] = acc[j][3];
  }
}

// sum over the 8 lanes of a fragment's rows (g), in a fixed tree
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 16);
  return v;
}

// the activation's derivative from its output, as the JAX package's
// _act_fns: relu (a > 0), sigmoid a (1 - a)
__device__ __forceinline__ float dact(float a, bool relu) {
  return relu ? (a > 0.f ? 1.f : 0.f) : a * (1.f - a);
}

// The packed weights, padded with zeros: WX = [Wk - Wm ; Wp ; Wq + Wm]
// (each part Kp rows of Sw), W2 (H1p rows of Sw2), b2 and w3 (H2p each)
__global__ void din_backward_pack(const float* __restrict__ w1, const float* __restrict__ w2,
                                  const float* __restrict__ b2, const float* __restrict__ w3,
                                  float* __restrict__ packed, int K, int H1, int H2,
                                  BackPlan L) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < L.wts;
       i += stride) {
    float v = 0.f;
    if (i < L.o_w2) {
      const long long r = i / L.Sw;
      const int c = static_cast<int>(i - r * L.Sw);
      const int part = static_cast<int>(r / L.Kp);
      const long long rc = r - static_cast<long long>(part) * L.Kp;
      if (rc < K && c < H1 && part < 3) {
        const float* wq = w1 + rc * H1 + c;
        const long long kh = static_cast<long long>(K) * H1;
        v = part == 0 ? __fsub_rn(wq[kh], wq[2 * kh])
                      : part == 1 ? wq[3 * kh] : __fadd_rn(wq[0], wq[2 * kh]);
      }
    } else if (i < L.o_b2) {
      const long long r = (i - L.o_w2) / L.Sw2;
      const int c = static_cast<int>(i - L.o_w2 - r * L.Sw2);
      if (r < H1 && c < H2) v = w2[r * H2 + c];
    } else if (i < L.o_w3) {
      const long long c = i - L.o_b2;
      if (c < H2) v = b2[c];
    } else {
      const long long c = i - L.o_w3;
      if (c < H2) v = w3[c];
    }
    packed[i] = v;
  }
}

// dlogit of every position, a warp a row: dscore = g . k (pooled) or g;
// with the softmax, the row term c = sum_t s dscore (each lane's positions
// in order, then a fixed tree) and dlogit = s (dscore - c); 0 where the
// mask is not set. Pooled with vec (K % 4 == 0, keys 16-byte aligned),
// 8 lanes take a position, each a float4 of every 8, so that a load
// instruction reads 4 positions' consecutive keys, and a fixed tree over
// the 8 lanes gives dscore; else a lane takes a position.
__global__ void din_backward_dlogits(const float* __restrict__ keys,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ weights,
                                     const float* __restrict__ grad, float* __restrict__ dl,
                                     int batch, int T, int K, bool softmax, bool pool, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       row < batch; row += warps) {
    const float* s = weights + row * T;
    const float* m = mask + row * T;
    float* d = dl + row * T;
    float c = 0.f;
    if (pool && vec) {
      const float4* gr = reinterpret_cast<const float4*>(grad + row * K);
      const int sub = lane >> 3, l8 = lane & 7, k4 = K / 4;
      for (int t0 = 0; t0 < T; t0 += 4) {
        const int t = t0 + sub;
        float v = 0.f;
        if (t < T) {
          const float4* kr = reinterpret_cast<const float4*>(keys + (row * T + t) * K);
          for (int i = l8; i < k4; i += 8) {
            const float4 kv = __ldg(kr + i), gv = __ldg(gr + i);
            v = fmaf(gv.x, kv.x, v);
            v = fmaf(gv.y, kv.y, v);
            v = fmaf(gv.z, kv.z, v);
            v = fmaf(gv.w, kv.w, v);
          }
        }
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        v += __shfl_xor_sync(kFull, v, 4);
        if (l8 == 0 && t < T) {
          d[t] = v;
          c = fmaf(s[t], v, c);
        }
      }
      __syncwarp();  // d[t] is read below by another lane than wrote it
    } else {
      for (int t = lane; t < T; t += 32) {
        float v;
        if (pool) {
          const float* gr = grad + row * K;
          const float* kr = keys + (row * T + t) * K;
          v = 0.f;
          for (int k = 0; k < K; ++k) v = fmaf(gr[k], kr[k], v);
          d[t] = v;
        } else {
          v = grad[row * T + t];
        }
        c = fmaf(s[t], v, c);
      }
    }
    c = __shfl_sync(kFull, warp_sum(c), 0);
    for (int t = lane; t < T; t += 32) {
      const float ds = pool ? d[t] : grad[row * T + t];
      d[t] = m[t] > 0.5f ? (softmax ? s[t] * (ds - c) : ds) : 0.f;
    }
    __syncwarp();  // this row's d is final before the next row's writes
  }
}

// The backward over all positions: a block walks passes of MT consecutive
// positions (of the flattened [batch * T]), a persistent grid; a warp
// takes 16 of a pass's positions through the scorer and back, then the
// block adds the pass's weight gradients to its running sums.
__global__ void __launch_bounds__(32 * kBackWarps, 1)
din_backward_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                    const float* __restrict__ weights, const float* __restrict__ grad,
                    const float* __restrict__ terms, const float* __restrict__ dlg,
                    const float* __restrict__ packed, float* __restrict__ dkeys,
                    float* __restrict__ e, float* __restrict__ partials,
                    float* __restrict__ act_global, int batch, int T, int K, int H1,
                    BackPlan L, bool relu, bool pool) {
  extern __shared__ __align__(16) float4 back_smem4[];
  float* smem = reinterpret_cast<float*>(back_smem4);
  float* work = L.act_smem ? smem : act_global + blockIdx.x * L.act;
  float* staged = smem + (L.act_smem ? L.act : 0);
  float* accs = L.acc_smem ? staged + L.staged : partials + blockIdx.x * L.acc;
  // a part of the weights from shared memory where the plan staged it
  auto weights_at = [&](long long off) -> const float* {
    return off < L.staged ? staged + off : packed + off;
  };

  float* keys_s = work + L.o_keys;
  float* q_s = work + L.o_q;
  float* dl_s = work + L.o_dl;
  float* s_s = work + L.o_s;
  int* rr_s = reinterpret_cast<int*>(work + L.o_rr);
  float* h_s = work + L.o_h;
  float* u_s = work + L.o_u;
  float* red_b1 = work + L.o_red;
  float* red_b2 = red_b1 + L.warps * L.H1p;
  float* red_w3 = red_b2 + L.warps * L.H2p;
  float* rs_s = work + L.o_rs;
  const float* wx = weights_at(L.o_wx);                      // [Wk - Wm ; Wp]
  const float* wa = weights_at(L.o_wx + 2LL * L.Kp * L.Sw);  // Wq + Wm
  const float* w2 = weights_at(L.o_w2);
  const float* b2p = weights_at(L.o_b2);
  const float* w3p = weights_at(L.o_w3);

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int i4 = lane & 3;
  const int Kp = L.Kp, H1p = L.H1p, H2p = L.H2p, MT = L.MT;
  const int Sk = L.Sk, Sh = L.Sh, Su = L.Su, Sw = L.Sw, Sw2 = L.Sw2;
  const long long P = static_cast<long long>(batch) * T;
  const long long passes = (P + MT - 1) / MT;

  // the running sums start at 0; the weights are staged; h1's columns
  // past H1p (read as dW2's padding rows) stay 0
  for (long long i = tid; i < L.acc; i += threads) accs[i] = 0.f;
  for (long long i = tid; i < L.staged; i += threads) staged[i] = packed[i];
  for (int i = tid; i < MT * (L.H1m - H1p); i += threads) {
    const int p = i / (L.H1m - H1p);
    h_s[p * Sh + H1p + (i - p * (L.H1m - H1p))] = 0.f;
  }

  for (long long pass = blockIdx.x; pass < passes; pass += gridDim.x) {
    const long long pos0 = pass * MT;
    const int n = static_cast<int>(min(static_cast<long long>(MT), P - pos0));
    const long long row0 = pos0 / T;
    __syncthreads();  // the last pass is done with every buffer
    for (int i = tid; i < MT * Kp; i += threads) {
      const int p = i / Kp;
      const int c = i - p * Kp;
      keys_s[p * Sk + c] = p < n && c < K ? keys[(pos0 + p) * K + c] : 0.f;
    }
    for (int i = tid; i < L.R * Kp; i += threads) {
      const int r = i / Kp;
      const int c = i - r * Kp;
      q_s[i] = row0 + r < batch && c < K ? query[(row0 + r) * K + c] : 0.f;
    }
    for (int p = tid; p < MT; p += threads) {
      const bool valid = p < n;
      dl_s[p] = valid ? dlg[pos0 + p] : 0.f;
      s_s[p] = valid ? weights[pos0 + p] : 0.f;
      rr_s[p] = valid ? static_cast<int>((pos0 + p) / T - row0) : 0;
    }
    __syncthreads();

    // the warp's positions: rows r of kw, rw, dw, hw and uw
    const float* kw = keys_s + warp * 16 * Sk;
    const int* rw = rr_s + warp * 16;
    const float* dw = dl_s + warp * 16;
    float* hw = h_s + warp * 16 * Sh;
    float* uw = u_s + warp * 16 * Su;
    // layer 1: h1 = act(a + [k | q*k] [Wk - Wm ; Wp]), a = b1 + q (Wq + Wm)
    auto x_kq = [&](int r, int k) {
      const float* kr = kw + r * Sk;
      return k < Kp ? kr[k] : __fmul_rn(q_s[rw[r] * Kp + k - Kp], kr[k - Kp]);
    };
    for (int hc = 0; hc < H1p / kGroup; ++hc) {
      float acc[kGroupTiles][4] = {};
      const float* wc = wx + hc * kGroup + g;
      tile_mma<kGroupTiles>(acc, 2 * Kp / 8, g, i4, x_kq,
                            [&](int k, int j) { return wc[k * Sw + 8 * j]; });
#pragma unroll
      for (int j = 0; j < kGroupTiles; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = g + 8 * (v >> 1);
          const int col = hc * kGroup + 8 * j + 2 * i4 + (v & 1);
          const float a = col < H1 ? __ldg(terms + (row0 + rw[r]) * H1 + col) : 0.f;
          hw[r * Sh + col] = act(a + acc[j][v], relu);
        }
      }
    }
    __syncwarp();

    // layer 2 again, and du = dlogit w3 act'(h2); dw3 and db2 of the
    // warp's positions
    for (int zc = 0; zc < H2p / kGroup; ++zc) {
      float acc[kGroupTiles][4] = {};
      const float* wc = w2 + zc * kGroup + g;
      tile_mma<kGroupTiles>(acc, H1p / 8, g, i4, [&](int r, int k) { return hw[r * Sh + k]; },
                            [&](int k, int j) { return wc[k * Sw2 + 8 * j]; });
#pragma unroll
      for (int j = 0; j < kGroupTiles; ++j) {
        float sw3[2] = {0.f, 0.f}, sb2[2] = {0.f, 0.f};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = g + 8 * (v >> 1);
          const int col = zc * kGroup + 8 * j + 2 * i4 + (v & 1);
          const float h2 = act(acc[j][v] + b2p[col], relu);
          const float d = dw[r];
          const float du = (d * w3p[col]) * dact(h2, relu);
          uw[r * Su + col] = du;
          sw3[v & 1] = fmaf(h2, d, sw3[v & 1]);
          sb2[v & 1] += du;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float w3sum = rows_sum(sw3[c]);
          const float b2sum = rows_sum(sb2[c]);
          const int col = zc * kGroup + 8 * j + 2 * i4 + c;
          if (g == 0) {
            red_w3[warp * H2p + col] = w3sum;
            red_b2[warp * H2p + col] = b2sum;
          }
        }
      }
    }
    __syncthreads();  // every warp's h1 and du

    // dW2 += h1^T du over the pass: a warp a task of 16 rows by a group
    const int k_tiles = (n + 7) / 8;
    {
      const int ngroups = H2p / kGroup;
      const int tasks = (L.H1m / 16) * ngroups;
      for (int task = warp; task < tasks; task += L.warps) {
        const int m0 = (task / ngroups) * 16;
        const int n0 = (task - (task / ngroups) * ngroups) * kGroup;
        task_mma(accs + L.o_a2, H2p, m0, n0, k_tiles, g, i4,
                 [&](int r, int k) { return h_s[k * Sh + m0 + r]; },
                 [&](int k, int j) { return u_s[k * Su + n0 + 8 * j + g]; });
      }
    }
    __syncthreads();  // h1 is read: dh takes its place

    // dh = (du W2^T) act'(h1), in place of h1; db1 of the warp's positions
    for (int hc = 0; hc < H1p / kGroup; ++hc) {
      float acc[kGroupTiles][4] = {};
      const float* wc = w2 + (hc * kGroup + g) * Sw2;
      tile_mma<kGroupTiles>(acc, H2p / 8, g, i4, [&](int r, int k) { return uw[r * Su + k]; },
                            [&](int k, int j) { return wc[8 * j * Sw2 + k]; });
#pragma unroll
      for (int j = 0; j < kGroupTiles; ++j) {
        float sb1[2] = {0.f, 0.f};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = g + 8 * (v >> 1);
          const int col = hc * kGroup + 8 * j + 2 * i4 + (v & 1);
          float* hp = hw + r * Sh + col;
          const float dh = acc[j][v] * dact(*hp, relu);
          *hp = dh;
          sb1[v & 1] += dh;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float b1sum = rows_sum(sb1[c]);
          if (g == 0) red_b1[warp * H1p + hc * kGroup + 8 * j + 2 * i4 + c] = b1sum;
        }
      }
    }
    __syncwarp();

    // dX = dh [Wk - Wm ; Wp]^T, 16 columns of each part at a time: dkeys =
    // s g + dX_k + dX_qk q, and the dq terms e = dX_qk k
    for (int cp = 0; cp < Kp / 16; ++cp) {
      float acc[4][4] = {};
      tile_mma<4>(acc, H1p / 8, g, i4, [&](int r, int k) { return hw[r * Sh + k]; },
                  [&](int k, int j) {
                    return wx[((j >> 1) * Kp + cp * 16 + (j & 1) * 8 + g) * Sw + k];
                  });
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = g + 8 * (v >> 1);
          const int p = warp * 16 + r;
          const int c = cp * 16 + 8 * jj + 2 * i4 + (v & 1);
          if (p < n && c < K) {
            const long long pos = pos0 + p;
            const float dqk = acc[2 + jj][v];
            const float base = pool ? s_s[p] * __ldg(grad + (row0 + rw[r]) * K + c) : 0.f;
            dkeys[pos * K + c] = (base + acc[jj][v]) + dqk * q_s[rw[r] * Kp + c];
            e[pos * K + c] = dqk * kw[r * Sk + c];
          }
        }
      }
    }
    __syncthreads();  // every warp's dh

    // each row's sum of dh over its positions of the pass, in order
    const int nr = static_cast<int>((pos0 + n - 1) / T - row0) + 1;  // rows of the pass
    auto first = [&](int r) { return static_cast<int>(max(0LL, (row0 + r) * T - pos0)); };
    for (int i = tid; i < nr * H1p; i += threads) {
      const int r = i / H1p;
      const int col = i - r * H1p;
      const int p1 = static_cast<int>(min(static_cast<long long>(n), (row0 + r + 1) * T - pos0));
      float s = 0.f;
      for (int p = first(r); p < p1; ++p) s += h_s[p * Sh + col];
      rs_s[i] = s;
    }
    __syncthreads();

    // dWX += X^T dh over the pass, X = [k | q*k] a position; dA += q^T (the
    // rows' sums); each row's dq term (its sum) A^T, added to e at its first
    // position of the pass; the biases' sums of the warps, in warp order
    {
      const int ngroups = H1p / kGroup;
      const int tasks = (2 * Kp / 16) * ngroups;
      for (int task = warp; task < tasks; task += L.warps) {
        const int m0 = (task / ngroups) * 16;
        const int n0 = (task - (task / ngroups) * ngroups) * kGroup;
        const int part = m0 / Kp;  // Kp is a multiple of 16: a task is in one part
        const int c0 = m0 - part * Kp;
        auto b = [&](int k, int j) { return h_s[k * Sh + n0 + 8 * j + g]; };
        if (part == 0) {
          task_mma(accs + L.o_ax, H1p, m0, n0, k_tiles, g, i4,
                   [&](int r, int k) { return keys_s[k * Sk + c0 + r]; }, b);
        } else {
          task_mma(accs + L.o_ax, H1p, m0, n0, k_tiles, g, i4,
                   [&](int r, int k) {
                     return __fmul_rn(q_s[rr_s[k] * Kp + c0 + r], keys_s[k * Sk + c0 + r]);
                   }, b);
        }
      }
      for (int i = tid; i < Kp * H1p; i += threads) {
        const int c = i / H1p;
        const int col = i - c * H1p;
        float s = 0.f;
        for (int r = 0; r < nr; ++r) s = fmaf(q_s[r * Kp + c], rs_s[r * H1p + col], s);
        accs[L.o_ax + 2LL * Kp * H1p + i] += s;
      }
      for (int i = tid; i < nr * K; i += threads) {
        const int r = i / K;
        const int c = i - r * K;
        const float* a = wa + c * Sw;
        float s = 0.f;
#pragma unroll 8
        for (int col = 0; col < H1p; ++col) s = fmaf(rs_s[r * H1p + col], a[col], s);
        e[(pos0 + first(r)) * K + c] += s;
      }
      for (int c = tid; c < H1p; c += threads) {
        float s = 0.f;
        for (int w = 0; w < L.warps; ++w) s += red_b1[w * H1p + c];
        accs[L.o_ab1 + c] += s;
      }
      for (int c = tid; c < H2p; c += threads) {
        float s2 = 0.f, s3 = 0.f;
        for (int w = 0; w < L.warps; ++w) {
          s2 += red_b2[w * H2p + c];
          s3 += red_w3[w * H2p + c];
        }
        accs[L.o_ab2 + c] += s2;
        accs[L.o_aw3 + c] += s3;
      }
      if (warp == 0) {
        // db3: four positions a lane in order, then a fixed tree
        float s = 0.f;
        for (int p = lane; p < n; p += 32) s += dl_s[p];
        s = warp_sum(s);
        if (lane == 0) accs[L.o_ab3] += s;
      }
    }
  }
  if (L.acc_smem) {
    __syncthreads();
    float* out = partials + blockIdx.x * L.acc;
    for (long long i = tid; i < L.acc; i += threads) out[i] = accs[i];
  }
}

// The weight gradients, a warp an element: the sum of the blocks' partial
// sums (lane l adds blocks l, l + 32, ... in order, then a fixed tree; lane
// 0 writes), dW1 put together as [dA ; dBw ; dA - dBw ; dP] from WX's parts
__global__ void din_backward_reduce(const float* __restrict__ partials, float* __restrict__ dw1,
                                    float* __restrict__ db1, float* __restrict__ dw2,
                                    float* __restrict__ db2, float* __restrict__ dw3,
                                    float* __restrict__ db3, int K, int H1, int H2,
                                    BackPlan L) {
  const long long n1 = 4LL * K * H1, n2 = static_cast<long long>(H1) * H2;
  const long long total = n1 + H1 + n2 + 2 * H2 + 1;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  auto sum = [&](long long off) {
    float s = 0.f;
    for (long long b = lane; b < L.blocks; b += 32) s += partials[b * L.acc + off];
    return warp_sum(s);
  };
  for (long long i = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       i < total; i += stride) {
    float v;
    if (i < n1) {
      const long long r = i / H1;
      const int c = static_cast<int>(i - r * H1);
      const int part = static_cast<int>(r / K);
      const long long rc = r - static_cast<long long>(part) * K;
      const long long a = L.o_ax + (2LL * L.Kp + rc) * L.H1p + c;
      const long long bw = L.o_ax + rc * L.H1p + c;
      const long long pp = L.o_ax + (L.Kp + rc) * L.H1p + c;
      v = part == 0 ? sum(a) : part == 1 ? sum(bw) : part == 2 ? sum(a) - sum(bw) : sum(pp);
      if (lane == 0) dw1[i] = v;
    } else if (i < n1 + H1) {
      v = sum(L.o_ab1 + (i - n1));
      if (lane == 0) db1[i - n1] = v;
    } else if (i < n1 + H1 + n2) {
      const long long j = i - n1 - H1;
      const long long r = j / H2;
      v = sum(L.o_a2 + r * L.H2p + (j - r * H2));
      if (lane == 0) dw2[j] = v;
    } else if (i < n1 + H1 + n2 + H2) {
      v = sum(L.o_ab2 + (i - n1 - H1 - n2));
      if (lane == 0) db2[i - n1 - H1 - n2] = v;
    } else if (i < n1 + H1 + n2 + 2 * H2) {
      v = sum(L.o_aw3 + (i - n1 - H1 - n2 - H2));
      if (lane == 0) dw3[i - n1 - H1 - n2 - H2] = v;
    } else {
      v = sum(L.o_ab3);
      if (lane == 0) db3[0] = v;
    }
  }
}

// dq of a row: the sum over t of its positions' terms, in t order
__global__ void din_backward_dq(const float* __restrict__ e, float* __restrict__ dq, int batch,
                                int T, int K) {
  const long long total = static_cast<long long>(batch) * K;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long b = i / K;
    const long long c = i - b * K;
    const float* er = e + b * T * K + c;
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += er[static_cast<long long>(t) * K];
    dq[i] = s;
  }
}

// The backward's plan for a shape, chosen once a shape and device and
// kept: the most warps, kLeastSmemWarps or more, whose pass's activations
// and the weights fit in shared memory, with the running sums there too
// where they fit, or else with the first layer's [Wk - Wm ; Wp] alone
// there (the rest read from device memory); else the most warps whose
// activations fit, the weights read from device memory; else everything
// in device memory (chip_lab_din_backward.py: at K=128, 80-40, 8 warps
// with the weights in device memory took 6.35 ms, 4 with them in shared
// memory 7.66)
struct BackLaunch {
  int device, batch, T, K, H1, H2;
  BackPlan plan;
};

cudaError_t back_launch(int device, int batch, int T, int K, int H1, int H2, BackPlan& out) {
  static std::mutex lock;
  static std::vector<BackLaunch> known;
  std::lock_guard<std::mutex> hold(lock);
  for (const BackLaunch& b : known) {
    if (b.device == device && b.batch == batch && b.T == T && b.K == K && b.H1 == H1 &&
        b.H2 == H2) {
      out = b.plan;
      return cudaSuccess;
    }
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(din_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSharedBytes));
  }
  if (err != cudaSuccess) return err;
  BackPlan L;
  bool found = false;
  auto fits = [&](int warps, bool act, Staged wts, bool acc) {
    L = make_back_plan(T, K, H1, H2, warps, act, wts, acc);
    return L.smem <= static_cast<long long>(kMaxSharedBytes);
  };
  for (int warps = kBackWarps; warps >= kLeastSmemWarps && !found; warps /= 2) {
    found = fits(warps, true, kAllWeights, true) || fits(warps, true, kAllWeights, false) ||
            fits(warps, true, kLayer1, false);
  }
  for (int warps = kBackWarps; warps >= 1 && !found; warps /= 2) {
    found = fits(warps, true, kNoWeights, false);
  }
  if (!found) found = fits(kBackWarps, false, kNoWeights, false);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_backward_kernel, 32 * L.warps,
                                                      static_cast<size_t>(L.smem));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long passes = (static_cast<long long>(batch) * T + L.MT - 1) / L.MT;
  L.blocks = static_cast<long long>(sms) * per_sm;
  if (L.blocks > passes) L.blocks = passes;
  known.push_back({device, batch, T, K, H1, H2, L});
  out = L;
  return cudaSuccess;
}

// The scratch of a backward, in floats: the packed weights, the per-row
// terms [batch][H1], dlogit [batch * T], the dq terms [batch * T][K], the
// blocks' partial sums and, where they live in device memory, the blocks'
// activations
struct BackScratch {
  long long packed, terms, dl, e, partials, act, total;
};

BackScratch back_scratch(const BackPlan& L, int batch, int T, int K, int H1) {
  BackScratch S;
  long long at = 0;
  auto take = [&at](long long floats) {
    const long long here = at;
    at += (floats + 3) / 4 * 4;
    return here;
  };
  const long long P = static_cast<long long>(batch) * T;
  S.packed = take(L.wts);
  S.terms = take(static_cast<long long>(batch) * H1);
  S.dl = take(P);
  S.e = take(P * K);
  S.partials = take(L.blocks * L.acc);
  S.act = take(L.act_smem ? 0 : L.blocks * L.act);
  S.total = at;
  return S;
}

// --- din_backward_tile_kernel: the backward where K <= 32, H1 <= 80,
// H2 <= 40 and T <= 64 (DIN's and DIEN's scorer), on wgmma. Bound:
// operations, as din_backward_kernel's; what held that kernel back was
// latency, and this one is latency-bound too, at 8 warps an SM
// (chip_lab_din_backward.py), so its design cuts what a tile waits on:
// - a warpgroup takes a pair of batch rows and puts only their valid
//   positions through the products: both rows in one tile of up to 64
//   where their counts fit, else a tile each (at DIN's shape ~1.3 tiles a
//   pair against 2 of 64 positions holding 50); each row's sums stay in
//   the warpgroup. A masked position has dlogit 0, so its du, dh and dX
//   are 0 and its dkeys is s g (pooled) or 0, which the warp that finds
//   the row's mask bits writes, a column a lane. A persistent grid of
//   blocks of two warpgroups walks the pairs, each warpgroup on its own
//   with named barriers;
// - a tile's keys (a row each position, gathered), queries, cotangents and
//   weights come into shared memory by cp.async in one batch; the rows'
//   terms b1 + q (Wq + Wm) come from Wq + Wm staged once a block;
// - every product is m64nNk8 in 3xTF32 with A in registers, B the block's
//   weights staged once, split into big and small parts, as K-major core
//   matrices in both orientations the products need; each value is split
//   with two integer operations (split_fast);
// - layer 1 [k | q*k] [Wk - Wm ; Wp] (N = 80), + the row's term, the
//   activation: h1 (to shared memory, in the order dW2's A fragments read
//   it); layer 2 (N = 40) from h1's accumulators as A (a k permutation, as
//   the global forward kernel chains its layers); du = dlogit w3 act'(h2),
//   db2's and dw3's partial sums;
// - dW2 += h1^T du: 2 m-tiles of h1's columns (the second holds 16) by
//   N = 40, the tile's positions as k, in two halves of 32 (du's split
//   parts of a half in shared memory as B at a time);
// - dh = (du W2^T) act'(h1) (N = 80, du's accumulators as A), then dX = dh
//   [Wk - Wm ; Wp]^T (N = 64, dh's as A): dkeys = s g + dX_k + dX_qk q, and
//   each row's sums of dh and of dX_qk k over its positions (shuffles over
//   a warp's rows, then the 4 warps in order): dq = those sums plus (the
//   row's sum of dh) (Wq + Wm)^T, written once a row, and dA += q^T (the
//   sum), db1 += the sum;
// - dWX += X^T dh, X = [k | q*k]: M = 64 (X's columns), N = 80, over the
//   positions as k in two halves (dh's split parts of a half as B), X's
//   from the staged keys and query.
// Each warpgroup keeps its running dWX, dW2 and dA (in registers) and its
// bias sums (in shared memory) across all its pairs and writes them once
// as its partial, in din_backward_reduce's layout (sums_layout), which adds
// the partials in order: no atomics, and the pairs' order, the packing and
// every sum's order are fixed, so two calls agree bitwise. A weight
// gradient's k-steps go kTSumSteps at a time into a fresh accumulator,
// waited for, then one rounded f32 add a value into the running sums (as
// the global forward kernel's wg_step); a per-position product starts from
// zero each tile and takes its k-steps' products straight into its
// accumulators (tile_step), which leaves the registers that a fresh
// accumulator would take. Positions past a tile's count have dlogit 0.
constexpr int kTK = 32;       // K padded: X = [k | q*k] is 64 wide, dWX's one m-tile
constexpr int kTH1 = 80;      // H1 padded
constexpr int kTH2 = 40;      // H2 padded
constexpr int kTM = 64;       // positions a warpgroup's tile
constexpr int kTRows = 2;     // most batch rows a tile
constexpr int kTGroups = 2;   // warpgroups a block
constexpr int kTThreads = 128 * kTGroups;
constexpr int kTSK = kTK + 4;  // a staged key row's stride (dWX's A reads, 4 rows x 8 columns, 2 ways a bank)
constexpr int kTSumSteps = 4;  // k-steps a weight gradient's fresh accumulator takes
// floats of a k-step of B, big and small parts, at N = 80, 64 and 40
constexpr int kTStep1 = 2 * kTH1 * 8;
constexpr int kTStepX = 2 * 2 * kTK * 8;
constexpr int kTStep2 = 2 * kTH2 * 8;
// the block's part of shared memory, offsets in floats: layer 1's B (8
// k-steps), dX's (10), layer 2's (10), dh's (5), then b2 and w3 (zero
// past H2), b1 and Wq + Wm (zero past H1 and K), for the rows' terms and
// dq
constexpr int kTW1 = 0;
constexpr int kTWX = kTW1 + (2 * kTK / 8) * kTStep1;
constexpr int kTW2 = kTWX + (kTH1 / 8) * kTStepX;
constexpr int kTW2T = kTW2 + (kTH1 / 8) * kTStep2;
constexpr int kTB2 = kTW2T + (kTH2 / 8) * kTStep1;
constexpr int kTW3 = kTB2 + kTH2;
constexpr int kTB1 = kTW3 + kTH2;
constexpr int kTWa = kTB1 + kTH1;
constexpr int kTBlock = kTWa + kTK * kTH1;
// a warpgroup's part, offsets from its start: the region (h1, then a
// half's split parts of du from kTDu; then the row sums' scratch; then a
// half's split parts of dh, dWX's B), the staged keys, [4 warps][db2 |
// dw3] partial sums (whose space the rows' sums of dh and dq terms take
// once they are added), queries, cotangents and terms, the tile's
// dlogits, weights and positions (t), the rows' softmax terms and masks
// (a bit a position), and the running db1, db2, dw3, db3
constexpr int kTDu = kTM * kTH1;
constexpr int kTKeys = kTDu + (kTM / 16) * kTStep2;
constexpr int kTRed = kTKeys + kTM * kTSK;
constexpr int kTRs = kTRed;
constexpr int kTEq = kTRs + kTRows * kTH1;
constexpr int kTQ = kTRed + 4 * 2 * kTH2;
constexpr int kTG = kTQ + kTRows * kTK;
constexpr int kTA = kTG + kTRows * kTK;
constexpr int kTDl = kTA + kTRows * kTH1;
constexpr int kTS = kTDl + kTM;
constexpr int kTIdx = kTS + kTM;
constexpr int kTC = kTIdx + kTM;
constexpr int kTBal = kTC + 4;
constexpr int kTSums = kTBal + 4;
constexpr int kTGroupFloats = kTSums + kTH1 + 2 * kTH2 + 4;
constexpr int kTSmemBytes = 4 * (kTBlock + kTGroups * kTGroupFloats);
static_assert(kTSmemBytes <= static_cast<int>(kMaxSharedBytes), "tile kernel's shared memory");
static_assert(kTBlock % 4 == 0 && kTGroupFloats % 4 == 0 && kTKeys % 4 == 0 && kTQ % 4 == 0 &&
                  kTSums % 4 == 0, "16-byte aligned parts");
static_assert((kTM / 16) * kTStep1 <= kTKeys && 4 * kTRows * (kTH1 + kTK) <= kTKeys,
              "a half of dh's split parts, and the row sums' scratch, fit in the region");
static_assert(kTRows * (kTH1 + kTK) <= kTQ - kTRed, "the rows' sums fit where db2's and dw3's were");

__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x's big and small TF32 parts at b and b + small
__device__ __forceinline__ void put_split(float* b, int small, float x) {
  uint32_t big, sm;
  split_fast(x, big, sm);
  b[0] = __uint_as_float(big);
  b[small] = __uint_as_float(sm);
}

// A tile's h1 in its region, in the order dW2's A fragments read it: a
// float4 a thread and k-step, m-tile 0 (columns 0..63) for every thread of
// the warpgroup, then m-tile 1 (64..79) for its first warp. Position p,
// column h is at 4 (ks 128 + 32 (h / 16) + l) + e, or past 64 columns at
// 4096 + 4 (ks 32 + l) + e, with ks = p / 8, l = 4 (h % 8) + p % 4 and e =
// 2 ((p / 4) % 2) + (h / 8) % 2. For the accumulator element (hi, j, e1)
// of the thread (w, g, i4) (position 16 w + g + 8 hi, column 8 j + 2 i4 +
// e1) that is h1_slot's base plus immediates.
__device__ __forceinline__ int h1_slot(int base, int w, int hi, int j, int e1) {
  return j < 8 ? base + 1024 * w + 512 * hi + 128 * (j >> 1) + 16 * e1 + (j & 1)
               : base + kTM * 64 + 256 * w + 128 * hi + 16 * e1 + (j & 1);
}

// t = the 3 S TF32 products of S k-steps of a weight gradient's product,
// chained into the fresh accumulator t (not waited for); a[s] the s-th
// k-step's A values (as wg_step's), all 0 where zero (a warp-uniform
// flag: no splits), its B big part at b + s bstride, the small part N x 8 on
template <int N, int S>
__device__ __forceinline__ void tile_sum_issue(float (&t)[N / 2], const float (&a)[S][4],
                                               const float* b, int bstride,
                                               bool zero = false) {
  uint32_t ab[S][4], as[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ab[s][i] = as[s][i] = 0u;
      if (!zero) split_fast(a[s][i], ab[s][i], as[s][i]);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float* bs = b + s * bstride;
    if (s == 0) {
      wgmma_tf32_first<N>(t, as[0], smem_desc(bs));
    } else {
      wgmma_tf32<N>(t, as[s], smem_desc(bs), 1);
    }
    wgmma_tf32<N>(t, ab[s], smem_desc(bs + N * 8), 1);
    wgmma_tf32<N>(t, ab[s], smem_desc(bs), 1);
  }
}

// acc += t, one rounded f32 add a value, once t's products are waited for
template <int M>
__device__ __forceinline__ void tile_sum_add(float (&acc)[M], float (&t)[M]) {
  fence_regs(t);
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
}

// acc += S k-steps of a weight gradient's product (tile_sum_issue), waited for
template <int N, int S>
__device__ __forceinline__ void tile_sum_steps(float (&acc)[N / 2], const float (&a)[S][4],
                                               const float* b, int bstride) {
  float t[N / 2];
  wg_fence();
  tile_sum_issue<N, S>(t, a, b, bstride);
  wg_commit();
  wg_wait_all();
  tile_sum_add(acc, t);
}

// acc += one k-step of a per-position product: its three TF32 products
// (a_small b_big, a_big b_small, a_big b_big) straight into acc, waited for
template <int N>
__device__ __forceinline__ void tile_step(float (&acc)[N / 2], float lo0, float hi0, float lo1,
                                          float hi1, const float* b) {
  uint32_t ab[4], as[4];
  split_fast(lo0, ab[0], as[0]);
  split_fast(hi0, ab[1], as[1]);
  split_fast(lo1, ab[2], as[2]);
  split_fast(hi1, ab[3], as[3]);
  wg_fence();
  wgmma_tf32<N>(acc, as, smem_desc(b), 1);
  wgmma_tf32<N>(acc, ab, smem_desc(b + N * 8), 1);
  wgmma_tf32<N>(acc, ab, smem_desc(b), 1);
  wg_commit();
  wg_wait_all();
}

// after a per-position product's last k-step, before its accumulators are read
template <int M>
__device__ __forceinline__ void tile_end(float (&acc)[M]) {
  fence_regs(acc);
}

__global__ void __launch_bounds__(kTThreads, 1)
din_backward_tile_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                         const float* __restrict__ mask, const float* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ w3,
                         const float* __restrict__ weights, const float* __restrict__ grad,
                         float* __restrict__ dq, float* __restrict__ dkeys,
                         float* __restrict__ partials, BackPlan L, int batch, int T, int K,
                         int H1, int H2, bool relu, bool softmax, bool pool, bool vec) {
  extern __shared__ __align__(1024) float4 tile_smem4[];
  float* smem = reinterpret_cast<float*>(tile_smem4);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;  // thread of the warpgroup
  const int w = wt >> 5;     // warp of the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int i4 = lane & 3;
  float* grp = smem + kTBlock + wg * kTGroupFloats;
  float* region = grp;
  float* du_s = grp + kTDu;
  float* keys_s = grp + kTKeys;
  float* red = grp + kTRed;
  float* rs_s = grp + kTRs;
  float* eq_s = grp + kTEq;
  float* q_s = grp + kTQ;
  float* g_s = grp + kTG;
  float* a_s = grp + kTA;
  float* dl_s = grp + kTDl;
  float* s_s = grp + kTS;
  int* idx_s = reinterpret_cast<int*>(grp + kTIdx);
  float* c_s = grp + kTC;
  unsigned* bal_s = reinterpret_cast<unsigned*>(grp + kTBal);
  float* sums = grp + kTSums;  // db1 [80], db2 [40], dw3 [40], db3
  const float* b2_s = smem + kTB2;
  const float* w3_s = smem + kTW3;
  const float* b1_s = smem + kTB1;
  const float* wa_s = smem + kTWa;  // [32][80] Wq + Wm

  // the weights, split: layer 1's k-step 4j + sub reads [Wk - Wm] (sub 0,
  // 1) or [Wp] (2, 3) rows 16 j + 4 (k % 4) + 2 (sub % 2) + k / 4 as its k
  // columns (a lane's float4 of keys gives its columns i4 and i4 + 4 of two
  // k-steps); dX's, layer 2's and dh's k-step kt rows 8 kt + 2 (k % 4) +
  // k / 4 (a lane's accumulator pair read as its columns i4, i4 + 4)
  for (int f = tid; f < (2 * kTK / 8) * kTH1 * 8; f += kTThreads) {
    const int kk = f & 7, n = (f >> 3) % kTH1, st = (f >> 3) / kTH1;
    const int sub = st & 3;
    const int c = 16 * (st >> 2) + 4 * (kk & 3) + 2 * (sub & 1) + (kk >> 2);
    float v = 0.f;
    if (n < H1 && c < K) {
      v = sub < 2 ? __fsub_rn(w1[(K + c) * H1 + n], w1[(2 * K + c) * H1 + n])
                  : w1[(3 * K + c) * H1 + n];
    }
    put_split(smem + kTW1 + st * kTStep1 + core_offset(n, kk), kTH1 * 8, v);
  }
  for (int f = tid; f < (kTH1 / 8) * 2 * kTK * 8; f += kTThreads) {
    const int kk = f & 7, n = (f >> 3) % (2 * kTK), kt = (f >> 3) / (2 * kTK);
    const int h = 8 * kt + 2 * (kk & 3) + (kk >> 2);
    const int c = n & (kTK - 1);
    float v = 0.f;
    if (h < H1 && c < K) {
      v = n < kTK ? __fsub_rn(w1[(K + c) * H1 + h], w1[(2 * K + c) * H1 + h])
                  : w1[(3 * K + c) * H1 + h];
    }
    put_split(smem + kTWX + kt * kTStepX + core_offset(n, kk), 2 * kTK * 8, v);
  }
  for (int f = tid; f < (kTH1 / 8) * kTH2 * 8; f += kTThreads) {
    const int kk = f & 7, n = (f >> 3) % kTH2, kt = (f >> 3) / kTH2;
    const int h = 8 * kt + 2 * (kk & 3) + (kk >> 2);
    const float v = h < H1 && n < H2 ? w2[h * H2 + n] : 0.f;
    put_split(smem + kTW2 + kt * kTStep2 + core_offset(n, kk), kTH2 * 8, v);
  }
  for (int f = tid; f < (kTH2 / 8) * kTH1 * 8; f += kTThreads) {
    const int kk = f & 7, n = (f >> 3) % kTH1, kt = (f >> 3) / kTH1;
    const int z = 8 * kt + 2 * (kk & 3) + (kk >> 2);
    const float v = n < H1 && z < H2 ? w2[n * H2 + z] : 0.f;
    put_split(smem + kTW2T + kt * kTStep1 + core_offset(n, kk), kTH1 * 8, v);
  }
  for (int i = tid; i < kTH2; i += kTThreads) {
    smem[kTB2 + i] = i < H2 ? b2[i] : 0.f;
    smem[kTW3 + i] = i < H2 ? w3[i] : 0.f;
  }
  for (int i = tid; i < kTH1; i += kTThreads) smem[kTB1 + i] = i < H1 ? b1[i] : 0.f;
  for (int i = tid; i < kTK * kTH1; i += kTThreads) {
    const int c = i / kTH1, h = i - c * kTH1;
    smem[kTWa + i] = c < K && h < H1 ? __fadd_rn(w1[c * H1 + h], w1[(2 * K + c) * H1 + h]) : 0.f;
  }
  // the warpgroup's part starts at 0: the staged parts past K, H1, a tile's
  // rows or positions are never copied to and read as 0
  for (int i = wt; i < kTGroupFloats; i += 128) grp[i] = 0.f;
  fence_async_smem();
  __syncthreads();

  float dwx[kTH1 / 2], dw2a[kTH2 / 2], dw2b[kTH2 / 2], da[kTH1 / 4];
#pragma unroll
  for (int i = 0; i < kTH1 / 2; ++i) dwx[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTH2 / 2; ++i) dw2a[i] = dw2b[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTH1 / 4; ++i) da[i] = 0.f;
  const int p_lo = 16 * w + g;  // this thread's accumulator rows: positions p_lo, p_hi
  const int p_hi = p_lo + 8;
  const int ca = wt >> 2;       // dA's and dq's column of K for this thread
  const int hq = wt & 3;        // and its quarter of H1
  // tile-invariant bases, so that a tile's many shared-memory slots of this
  // thread are these plus immediates: h1's (h1_slot), and a k-step's split
  // B slot of its accumulator element (hi, j, e1) at (2 (w % 2) + hi) steps
  // + 64 j + 4 e1 from cb (core_offset's, the position's k being g)
  const int h1b = 4 * (g & 3) + 2 * (g >> 2) + 32 * i4;
  const int cb = 32 * (g >> 2) + 8 * i4 + (g & 3);
  const long long items = (static_cast<long long>(batch) + 1) / 2;  // pairs of rows
  const long long stride = static_cast<long long>(gridDim.x) * kTGroups;

  for (long long item = static_cast<long long>(blockIdx.x) * kTGroups + wg; item < items;
       item += stride) {
    const long long b0 = 2 * item;
    const int nrows = static_cast<int>(min(2LL, batch - b0));

    // each row's valid positions, a warp a row: a bit a position. Its
    // masked ones have dlogit 0, so their dkeys are s g (pooled) or 0: the
    // warp writes them a position at a time, a column a lane (K <= 32).
    wg_bar(wg);  // the last pair is done with every buffer
    if (w < nrows) {
      const long long b = b0 + w;
      const bool in0 = lane < T, in1 = lane + 32 < T;
      const float* mr = mask + b * T;
      const float* sr = weights + b * T;
      const float s0 = pool && in0 ? sr[lane] : 0.f, s1 = pool && in1 ? sr[lane + 32] : 0.f;
      const float gv = pool && lane < K ? grad[b * K + lane] : 0.f;
      const unsigned lo = __ballot_sync(kFull, in0 && mr[lane] > 0.5f);
      const unsigned hi = __ballot_sync(kFull, in1 && mr[lane + 32] > 0.5f);
      if (lane == 0) {
        bal_s[2 * w] = lo;
        bal_s[2 * w + 1] = hi;
      }
      unsigned m0 = ~lo & (T >= 32 ? kFull : (1u << T) - 1u);
      unsigned m1 = ~hi & (T >= 64 ? kFull : T > 32 ? (1u << (T - 32)) - 1u : 0u);
      float* dk = dkeys + b * T * K + lane;
      while (m0) {
        const int t = __ffs(m0) - 1;
        m0 &= m0 - 1;
        const float st = __shfl_sync(kFull, s0, t);
        if (lane < K) dk[t * K] = st * gv;
      }
      while (m1) {
        const int t = __ffs(m1) - 1;
        m1 &= m1 - 1;
        const float st = __shfl_sync(kFull, s1, t);
        if (lane < K) dk[(t + 32) * K] = st * gv;
      }
    }
    wg_bar(wg);
    // row r's mask bits: positions 0..31 in lo(r), 32..63 in hi(r)
    const unsigned lo0 = bal_s[0], hi0 = bal_s[1];
    const unsigned lo1 = nrows == 2 ? bal_s[2] : 0u, hi1 = nrows == 2 ? bal_s[3] : 0u;
    const int cnt0 = __popc(lo0) + __popc(hi0), cnt1 = __popc(lo1) + __popc(hi1);
    // dq = 0 for a pair with no valid position, which no tile takes
    if (cnt0 + cnt1 == 0) {
      for (int i = wt; i < nrows * K; i += 128) dq[b0 * K + i] = 0.f;
    }
    // the pair's valid positions in tiles of up to 64: both rows in one
    // where they fit, else a tile each
    const int ntiles = cnt0 + cnt1 == 0 ? 0 : cnt0 + cnt1 <= kTM ? 1 : 2;
    for (int tt = 0; tt < ntiles; ++tt) {
    const int r0 = ntiles == 1 ? 0 : tt;  // the tile's first row of the pair
    const int nr = ntiles == 1 ? nrows : 1;
    const long long row0 = b0 + r0;
    const int c0 = r0 ? cnt1 : cnt0;       // the first row's positions: 0 .. c0 - 1
    const int np = c0 + (nr == 2 ? cnt1 : 0);
    // a position's row of the tile, and its place in the flattened batch
    auto row_of = [&](int p) { return p >= c0 ? 1 : 0; };
    auto pos_of = [&](int p) { return (row0 + row_of(p)) * T + idx_s[p]; };
    const bool v_lo = p_lo < np, v_hi = p_hi < np;
    const int r_lo = v_lo ? row_of(p_lo) : 0;
    const int r_hi = v_hi ? row_of(p_hi) : 0;

    // the tile's positions (a warp a row, in t order), then its inputs by
    // cp.async
    if (tt > 0) wg_bar(wg);  // the last tile is done with every buffer
    if (w < nr) {
      const unsigned lo = r0 + w ? lo1 : lo0, hi = r0 + w ? hi1 : hi0;
      const unsigned below = (1u << lane) - 1u;
      const int base = w == 0 ? 0 : c0;
      if ((lo >> lane) & 1u) idx_s[base + __popc(lo & below)] = lane;
      if ((hi >> lane) & 1u) idx_s[base + __popc(lo) + __popc(hi & below)] = lane + 32;
    }
    wg_bar(wg);
    {
      if (vec) {
        const int per = K / 4;
        for (int i = wt; i < np * per; i += 128) {
          const int p = i / per;
          const int c = 4 * (i - p * per);
          cp_async16(keys_s + p * kTSK + c, keys + pos_of(p) * K + c);
        }
      } else {
        for (int i = wt; i < np * K; i += 128) {
          const int p = i / K;
          const int c = i - p * K;
          cp_async4(keys_s + p * kTSK + c, keys + pos_of(p) * K + c);
        }
      }
      for (int i = wt; i < nr * K; i += 128) {
        const int r = i / K, c = i - r * K;
        cp_async4(q_s + r * kTK + c, query + row0 * K + i);
        if (pool) cp_async4(g_s + r * kTK + c, grad + row0 * K + i);
      }
      if (wt < np) {
        const long long pos = pos_of(wt);
        cp_async4(s_s + wt, weights + pos);
        if (!pool) cp_async4(dl_s + wt, grad + pos);
      }
      cp_async_commit();
      cp_async_wait_all();
    }
    wg_bar(wg);

    // dscore = g . k (or g, copied): two threads a position, 16 columns
    // each; the rows' terms b1 + q (Wq + Wm) (k in order, b1 last)
    if (pool) {
      const int p = wt >> 1, half = wt & 1;
      const float* kr = keys_s + p * kTSK + 16 * half;
      const float* gr = g_s + (p < np ? row_of(p) : 0) * kTK + 16 * half;
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) v = fmaf(gr[c], kr[c], v);
      v += __shfl_xor_sync(kFull, v, 1);
      if (half == 0) dl_s[p] = v;
    }
    for (int i = wt; i < nr * kTH1; i += 128) {
      const int r = i / kTH1, h = i - r * kTH1;
      float v = 0.f;
      for (int c = 0; c < K; ++c) v = fmaf(q_s[r * kTK + c], wa_s[c * kTH1 + h], v);
      a_s[i] = b1_s[h] + v;
    }
    wg_bar(wg);
    // the rows' softmax terms c = sum_t s dscore, a warp a row; dlogit
    if (softmax) {
      if (w < nr) {
        float c = 0.f;
        for (int p = (w == 0 ? 0 : c0) + lane; p < (w == 0 ? c0 : np); p += 32) {
          c = fmaf(s_s[p], dl_s[p], c);
        }
        c = warp_sum(c);
        if (lane == 0) c_s[w] = c;
      }
      wg_bar(wg);
    }
    if (wt < kTM) {
      float d = 0.f;
      if (wt < np) {
        const float ds = dl_s[wt];
        d = softmax ? s_s[wt] * (ds - c_s[row_of(wt)]) : ds;
      }
      dl_s[wt] = d;
    }
    wg_bar(wg);

    // layer 1 again: h1 = act(a + [k | q*k] [Wk - Wm ; Wp])
    float hacc[kTH1 / 2];
#pragma unroll
    for (int i = 0; i < kTH1 / 2; ++i) hacc[i] = 0.f;
    {
      const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* kl = keys_s + p_lo * kTSK + 4 * i4;
      const float* kh = keys_s + p_hi * kTSK + 4 * i4;
      const float* ql = q_s + r_lo * kTK + 4 * i4;
      const float* qh = q_s + r_hi * kTK + 4 * i4;
#pragma unroll
      for (int j = 0; j < kTK / 16; ++j) {
        const float4 cl = v_lo ? *reinterpret_cast<const float4*>(kl + 16 * j) : zero4;
        const float4 ch = v_hi ? *reinterpret_cast<const float4*>(kh + 16 * j) : zero4;
        const float4 qa = *reinterpret_cast<const float4*>(ql + 16 * j);
        const float4 qb = *reinterpret_cast<const float4*>(qh + 16 * j);
        const float* bp = smem + kTW1 + 4 * j * kTStep1;
        tile_step<kTH1>(hacc, cl.x, ch.x, cl.y, ch.y, bp);
        tile_step<kTH1>(hacc, cl.z, ch.z, cl.w, ch.w, bp + kTStep1);
        tile_step<kTH1>(hacc, __fmul_rn(qa.x, cl.x), __fmul_rn(qb.x, ch.x), __fmul_rn(qa.y, cl.y),
                        __fmul_rn(qb.y, ch.y), bp + 2 * kTStep1);
        tile_step<kTH1>(hacc, __fmul_rn(qa.z, cl.z), __fmul_rn(qb.z, ch.z), __fmul_rn(qa.w, cl.w),
                        __fmul_rn(qb.w, ch.w), bp + 3 * kTStep1);
      }
    }
    tile_end(hacc);
#pragma unroll
    for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 8 * j + 2 * i4 + (e & 1);
        const float v = act(a_s[(e < 2 ? r_lo : r_hi) * kTH1 + h] + hacc[4 * j + e], relu);
        hacc[4 * j + e] = v;
        region[h1_slot(h1b, w, e >> 1, j, e & 1)] = v;
      }
    }

    // layer 2 again; du = dlogit w3 act'(h2); the warp's sums of du (db2)
    // and h2 dlogit (dw3)
    float z[kTH2 / 2];
#pragma unroll
    for (int i = 0; i < kTH2 / 2; ++i) z[i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kTH1 / 8; ++kt) {
      tile_step<kTH2>(z, hacc[4 * kt], hacc[4 * kt + 2], hacc[4 * kt + 1], hacc[4 * kt + 3],
                      smem + kTW2 + kt * kTStep2);
    }
    tile_end(z);
    {
      const float d_lo = dl_s[p_lo], d_hi = dl_s[p_hi];
#pragma unroll
      for (int j = 0; j < kTH2 / 8; ++j) {
        float sw3[2] = {0.f, 0.f}, sb2[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * i4 + (e & 1);
          const float d = e < 2 ? d_lo : d_hi;
          const float h2 = act(z[4 * j + e] + b2_s[col], relu);
          const float du = (d * w3_s[col]) * dact(h2, relu);
          z[4 * j + e] = du;
          sw3[e & 1] = fmaf(h2, d, sw3[e & 1]);
          sb2[e & 1] += du;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float b2sum = rows_sum(sb2[c]);
          const float w3sum = rows_sum(sw3[c]);
          if (g == 0) {
            red[w * 2 * kTH2 + 8 * j + 2 * i4 + c] = b2sum;
            red[w * 2 * kTH2 + kTH2 + 8 * j + 2 * i4 + c] = w3sum;
          }
        }
      }
    }

    // dW2 += h1^T du over the tile's positions, in two halves of 32: the
    // half's warps put their du's split parts as B
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if ((w >> 1) == half) {
        float* d = du_s + (2 * (w & 1)) * kTStep2 + cb;
#pragma unroll
        for (int j = 0; j < kTH2 / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            put_split(d + (e >> 1) * kTStep2 + 64 * j + 4 * (e & 1), kTH2 * 8, z[4 * j + e]);
          }
        }
      }
      fence_async_smem();
      wg_bar(wg);
#pragma unroll
      for (int k0 = 4 * half; k0 < 4 * half + 4; k0 += kTSumSteps) {
        float a0[kTSumSteps][4], a1[kTSumSteps][4];
#pragma unroll
        for (int s = 0; s < kTSumSteps; ++s) {
          const float4 v0 = *reinterpret_cast<const float4*>(region + 4 * ((k0 + s) * 128 + wt));
          const float4 v1 = w == 0 ? *reinterpret_cast<const float4*>(
                                         region + kTM * 64 + 4 * ((k0 + s) * 32 + lane))
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          a0[s][0] = v0.x; a0[s][1] = v0.y; a0[s][2] = v0.z; a0[s][3] = v0.w;
          a1[s][0] = v1.x; a1[s][1] = v1.y; a1[s][2] = v1.z; a1[s][3] = v1.w;
        }
        // the two m-tiles' products in flight together, one wait
        float ta[kTH2 / 2], tb[kTH2 / 2];
        wg_fence();
        tile_sum_issue<kTH2, kTSumSteps>(ta, a0, du_s + (k0 - 4 * half) * kTStep2, kTStep2);
        tile_sum_issue<kTH2, kTSumSteps>(tb, a1, du_s + (k0 - 4 * half) * kTStep2, kTStep2,
                                         w != 0);
        wg_commit();
        wg_wait_all();
        tile_sum_add(dw2a, ta);
        tile_sum_add(dw2b, tb);
      }
      if (half == 0) wg_bar(wg);  // the half's parts are read before the next half's go in
    }

    // dh = (du W2^T) act'(h1)
    float dh[kTH1 / 2];
#pragma unroll
    for (int i = 0; i < kTH1 / 2; ++i) dh[i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kTH2 / 8; ++kt) {
      tile_step<kTH1>(dh, z[4 * kt], z[4 * kt + 2], z[4 * kt + 1], z[4 * kt + 3],
                      smem + kTW2T + kt * kTStep1);
    }
    tile_end(dh);
#pragma unroll
    for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dh[4 * j + e] = dh[4 * j + e] * dact(region[h1_slot(h1b, w, e >> 1, j, e & 1)], relu);
      }
    }
    wg_bar(wg);  // h1 and du's parts are read: the region is scratch

    // dX = dh [Wk - Wm ; Wp]^T: dkeys = s g + dX_k + dX_qk q, and the dq
    // terms dX_qk k in place of dX_qk
    float x[kTK];
#pragma unroll
    for (int i = 0; i < kTK; ++i) x[i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kTH1 / 8; ++kt) {
      tile_step<2 * kTK>(x, dh[4 * kt], dh[4 * kt + 2], dh[4 * kt + 1], dh[4 * kt + 3],
                         smem + kTWX + kt * kTStepX);
    }
    tile_end(x);
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = 8 * j + 2 * i4;
        const int p = hi ? p_hi : p_lo;
        const int r = hi ? r_hi : r_lo;
        float dk[2], ev[2] = {0.f, 0.f};
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * hi + e1;
          const float dqk = x[4 * (j + kTK / 8) + e];
          const float base = pool ? s_s[p] * g_s[r * kTK + c + e1] : 0.f;
          dk[e1] = (base + x[4 * j + e]) + dqk * q_s[r * kTK + c + e1];
          ev[e1] = dqk * keys_s[p * kTSK + c + e1];
        }
        if (hi ? v_hi : v_lo) {
          float* o = dkeys + pos_of(p) * K + c;
          if (K % 2 == 0 && c < K) {
            *reinterpret_cast<float2*>(o) = make_float2(dk[0], dk[1]);
          } else {
            if (c < K) o[0] = dk[0];
            if (c + 1 < K) o[1] = dk[1];
          }
        } else {
          ev[0] = ev[1] = 0.f;
        }
        x[4 * (j + kTK / 8) + 2 * hi] = ev[0];
        x[4 * (j + kTK / 8) + 2 * hi + 1] = ev[1];
      }
    }

    // each row's sums of dh and of the dq terms over its positions: over a
    // warp's rows in a fixed tree, then the 4 warps in order
    float* red_rs = region;                       // [4 warps][kTRows][80]
    float* red_e = region + 4 * kTRows * kTH1;    // [4 warps][kTRows][32]
    for (int r = 0; r < nr; ++r) {
#pragma unroll
      for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = rows_sum((r_lo == r ? dh[4 * j + c] : 0.f) +
                                   (r_hi == r ? dh[4 * j + 2 + c] : 0.f));
          if (g == 0) red_rs[(w * kTRows + r) * kTH1 + 8 * j + 2 * i4 + c] = v;
        }
      }
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = rows_sum((r_lo == r ? x[4 * (j + kTK / 8) + c] : 0.f) +
                                   (r_hi == r ? x[4 * (j + kTK / 8) + 2 + c] : 0.f));
          if (g == 0) red_e[(w * kTRows + r) * kTK + 8 * j + 2 * i4 + c] = v;
        }
      }
    }
    if (wt < kTH2) {  // db2's and dw3's sums, before the rows' sums take their space
      float v2 = red[wt], v3 = red[kTH2 + wt];
      for (int ww = 1; ww < 4; ++ww) {
        v2 += red[ww * 2 * kTH2 + wt];
        v3 += red[ww * 2 * kTH2 + kTH2 + wt];
      }
      sums[kTH1 + wt] += v2;
      sums[kTH1 + kTH2 + wt] += v3;
    }
    wg_bar(wg);
    for (int i = wt; i < nr * kTH1; i += 128) {
      const int r = i / kTH1, h = i - r * kTH1;
      float v = red_rs[r * kTH1 + h];
      for (int ww = 1; ww < 4; ++ww) v += red_rs[(ww * kTRows + r) * kTH1 + h];
      rs_s[i] = v;
    }
    for (int i = wt; i < nr * kTK; i += 128) {
      const int r = i / kTK, c = i - r * kTK;
      float v = red_e[r * kTK + c];
      for (int ww = 1; ww < 4; ++ww) v += red_e[(ww * kTRows + r) * kTK + c];
      eq_s[i] = v;
    }
    if (w == 0) {
      const float v = warp_sum(dl_s[lane] + dl_s[lane + 32]);
      if (lane == 0) sums[kTH1 + 2 * kTH2] += v;
    }
    wg_bar(wg);

    // dq = (the row's dq terms) + (its sum of dh) (Wq + Wm)^T, a quarter of
    // H1 a thread, then a fixed tree over the 4; dA += q^T (the sums); the
    // bias sums
    {
      float part[kTRows];
#pragma unroll
      for (int r = 0; r < kTRows; ++r) part[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kTH1 / 4; ++i) {
        const int h = hq * (kTH1 / 4) + i;
        const float wa = wa_s[ca * kTH1 + h];
#pragma unroll
        for (int r = 0; r < kTRows; ++r) {
          if (r < nr) {
            const float v = rs_s[r * kTH1 + h];
            part[r] = fmaf(v, wa, part[r]);
            da[i] = fmaf(q_s[r * kTK + ca], v, da[i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kTRows; ++r) {
        part[r] += __shfl_xor_sync(kFull, part[r], 1);
        part[r] += __shfl_xor_sync(kFull, part[r], 2);
        if (hq == 0 && r < nr && ca < K) dq[(row0 + r) * K + ca] = eq_s[r * kTK + ca] + part[r];
      }
    }
    if (wt < kTH1) {
      float v = 0.f;
      for (int r = 0; r < nr; ++r) v += rs_s[r * kTH1 + wt];
      sums[wt] += v;
    }

    // dWX += X^T dh over the positions in two halves of 32: the half's
    // warps put their dh's split parts as B; X's columns 16 w + g and + 8
    // (keys' column xc, or the q*k part's) from the staged keys
    const int xc = (16 * w + g) & (kTK - 1);
    const float* xk = keys_s + i4 * kTSK + xc;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if ((w >> 1) == half) {
        float* d = region + (2 * (w & 1)) * kTStep1 + cb;
#pragma unroll
        for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            put_split(d + (e >> 1) * kTStep1 + 64 * j + 4 * (e & 1), kTH1 * 8, dh[4 * j + e]);
          }
        }
      }
      fence_async_smem();
      wg_bar(wg);
#pragma unroll
      for (int k0 = 4 * half; k0 < 4 * half + 4; k0 += kTSumSteps) {
        float xa[kTSumSteps][4];
#pragma unroll
        for (int s = 0; s < kTSumSteps; ++s) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 8 * (k0 + s) + i4 + 4 * (e >> 1);  // the row of p: p >= T, 2 T, 3 T
            float v = p < np ? xk[(8 * (k0 + s) + 4 * (e >> 1)) * kTSK + 8 * (e & 1)] : 0.f;
            if (w >= 2) v = __fmul_rn(q_s[(p < np ? row_of(p) : 0) * kTK + xc + 8 * (e & 1)], v);
            xa[s][e] = v;
          }
        }
        tile_sum_steps<kTH1, kTSumSteps>(dwx, xa, region + (k0 - 4 * half) * kTStep1, kTStep1);
      }
      if (half == 0) wg_bar(wg);  // the half's parts are read before the next half's go in
    }
    }
  }

  // this warpgroup's partial sums, in din_backward_reduce's layout
  wg_bar(wg);
  float* out = partials + (static_cast<long long>(blockIdx.x) * kTGroups + wg) * L.acc;
#pragma unroll
  for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = p_lo + 8 * (e >> 1);
      out[L.o_ax + m * kTH1 + 8 * j + 2 * i4 + (e & 1)] = dwx[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < kTH1 / 4; ++i) {
    out[L.o_ax + (2 * kTK + ca) * kTH1 + hq * (kTH1 / 4) + i] = da[i];
  }
#pragma unroll
  for (int j = 0; j < kTH2 / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = p_lo + 8 * (e >> 1);
      const int col = 8 * j + 2 * i4 + (e & 1);
      out[L.o_a2 + m * kTH2 + col] = dw2a[4 * j + e];
      if (m + 64 < kTH1) out[L.o_a2 + (m + 64) * kTH2 + col] = dw2b[4 * j + e];
    }
  }
  for (int i = wt; i < kTH1; i += 128) out[L.o_ab1 + i] = sums[i];
  for (int i = wt; i < kTH2; i += 128) {
    out[L.o_ab2 + i] = sums[kTH1 + i];
    out[L.o_aw3 + i] = sums[kTH1 + kTH2 + i];
  }
  if (wt == 0) out[L.o_ab3] = sums[kTH1 + 2 * kTH2];
}

bool tile_takes(int T, int K, int H1, int H2) {
  return T <= kTM && K <= kTK && H1 <= kTH1 && H2 <= kTH2;
}

// the tile kernel's running sums, one partial a warpgroup of `blocks`
BackPlan tile_sums(long long blocks) {
  BackPlan L{};
  L.Kp = kTK;
  L.H1p = kTH1;
  L.H1m = kTH1;
  L.H2p = kTH2;
  sums_layout(L);
  L.blocks = blocks * kTGroups;
  return L;
}

// The tile kernel's grid for a shape, chosen once a shape and device and
// kept: a block an SM, no more than the tiles need
struct TileLaunch {
  int device, batch, T;
  long long blocks;
};

cudaError_t tile_launch(int device, int batch, int T, long long& blocks) {
  static std::mutex lock;
  static std::vector<TileLaunch> known;
  std::lock_guard<std::mutex> hold(lock);
  for (const TileLaunch& t : known) {
    if (t.device == device && t.batch == batch && t.T == T) {
      blocks = t.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(din_backward_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_backward_tile_kernel,
                                                        kTThreads, kTSmemBytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (static_cast<long long>(batch) + 1) / 2;  // pairs of rows
  const long long need = (items + kTGroups - 1) / kTGroups;
  blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > need) blocks = need;
  known.push_back({device, batch, T, blocks});
  return cudaSuccess;
}

// --- din_backward_wide_kernel: the backward where K <= 128, H1 <= 80 and
// H2 <= 40 at the shapes the tile kernel does not take (K past 32, or rows
// past 64 positions: DIN at embedding dim 128, DIEN(gru_hidden=128), long
// behaviour histories). Bound: operations, as the tile kernel's; its
// design is the tile kernel's, widened:
// - a team takes a unit of batch rows at a time (two at K <= 32, three
//   past it; a persistent grid over the units) and puts only their valid
//   positions through the products: the first row's, then the next's, in
//   tiles of 64, so a tile holds the end of one row and the start of the
//   next, and a row past 64 valid positions spans tiles. Each row's sums
//   are carried across its tiles: the softmax's row term c (from a first
//   sweep over the unit, four threads a position, g . k from device memory,
//   which also counts the valid positions and writes the masked ones'
//   dkeys, s g or 0), the sums of dh and of dX_qk k, which give the row's
//   dq once the unit's tiles are done, and dA += q^T (the sum of dh), added
//   once a unit into the block's running sum in shared memory (at K <= 32
//   the team's partial in device memory);
// - past K = 32 both warpgroups of the block take the same tile. Layer 1
//   is split over K (a warpgroup its half of the 16-column blocks, the two
//   partial sums swapped through shared memory and added in one order);
//   layer 2 and dh (N = 40 and 80 over 10 and 5 k-steps) both warpgroups
//   compute alike, as each needs du and dh as A; dX (32-column chunks of
//   K, [k | q*k], N = 64), dWX (the same chunks as its m-tiles) and dW2
//   (its two m-tiles) are split between them, so that a thread's running
//   sums are 40 or 80 floats for dWX and 20 for dW2 at K = 128, where one
//   warpgroup would need 180. At K <= 32 a warpgroup's running sums fit
//   (dWX one m-tile, dW2 two: 80 floats), and each warpgroup takes its own
//   units and tiles (SOLO), with the tile kernel's memory plan: two tiles
//   in flight an SM, each waiting on its own chain, layer 1's and dX's B
//   resident in shared memory, dW2's and dWX's B a half of the tile's
//   positions at a time (chip_lab_din_backward.py: the shared tile spent
//   ~27 us a tile at K = 32, T = 1,000);
// - every product is m64nNk8 in 3xTF32 with A in registers (tile_step,
//   tile_sum_issue). The weights come split from a pack kernel
//   (din_backward_wide_pack) in the orientations the products read:
//   layer 2's and dh's B stay in shared memory; past K = 32 layer 1's and
//   dX's B (160 KB each at K = 128) stream through a ring of 4 k-steps a
//   warpgroup by cp.async, 3 k-steps ahead across tiles. Wq + Wm (dq) is
//   read from device memory, and every row's term b1 + q (Wq + Wm) comes
//   from the first launch;
// - the unit's queries, cotangents and row terms are staged once a unit;
//   a tile's keys, weights (s) and, for scores, its cotangents by
//   cp.async; the tile's positions come from the mask, a warp a row, from
//   a cursor a row.
// The running dWX, dW2 (registers), biases' sums and dA are written once a
// team as its partial in din_backward_reduce's layout (sums_layout with Kp
// = KT); every sum's order is fixed, so two calls agree bitwise. Three
// launches: the pack with every row's term, this kernel, the reduction.
constexpr int kWM = 64;                 // positions a tile
constexpr int kWThreads = 256;          // two warpgroups on one tile
constexpr int kWSlots = 4;              // a warpgroup's ring of weight k-steps
constexpr int kWSlot = kTStep1;         // floats of a ring slot: an N = 80 k-step
constexpr int kWStepX = 2 * 2 * 32 * 8;  // a dX k-step: N = 64, big and small

// The packed weights, offsets in floats: layer 1's B (KT / 4 k-steps, as
// the tile kernel's), dX's (KT / 32 chunks of 10 k-steps), then what a
// block keeps in shared memory at the same offsets from res: layer 2's B
// (10 k-steps), dh's (5), b2, w3 and Wq + Wm [KT][80]
struct WidePack {
  long long w1, wx, res, w2, w2t, b2, w3, wa, total;
};

__host__ __device__ inline WidePack wide_pack(int KT) {
  WidePack P;
  P.w1 = 0;
  P.wx = P.w1 + static_cast<long long>(KT / 4) * kTStep1;
  P.res = P.wx + static_cast<long long>(KT / 32) * 10 * kWStepX;
  P.w2 = 0;  // from res
  P.w2t = P.w2 + (kTH1 / 8) * kTStep2;
  P.b2 = P.w2t + (kTH2 / 8) * kTStep1;
  P.w3 = P.b2 + kTH2;
  P.wa = P.w3 + kTH2;
  P.total = P.res + P.wa + static_cast<long long>(KT) * kTH1;
  return P;
}

// A block's shared memory, offsets in floats: the resident weights and the
// two rings, then a team's part (the block's one team, or at K <= 32 each
// warpgroup's): the tile's keys, the region (the partial sums of layer 1
// swapped; then h1 in dW2's A order and du's split parts, dW2's B; then
// dh's split parts, dWX's B), the warps' sums of a tile's rows, the unit's
// rows (queries, cotangents, row terms, carried sums of dX_qk k and of
// dh), the tile's dlogits, weights and positions, the team's bias sums,
// and a few words
template <int KT>
struct WideSmem {
  // at K <= 32 a warpgroup's running sums fit in its registers (dWX one
  // m-tile, dW2 two), so each warpgroup takes its own units and tiles, two
  // tiles in flight an SM; past it the two share a tile
  static constexpr bool kSolo = KT == 32;
  static constexpr int kTeams = kSolo ? 2 : 1;
  // batch rows a team takes at a time: past K = 32 three, whose valid
  // positions fill a tile better than a pair's (at T = 50 ~1.7 tiles of 64
  // a unit against ~1.3 a pair) and share its fixed work
  static constexpr int kRows = kSolo ? 2 : 3;
  static constexpr int kSK = KT + 4;  // a staged key row's stride
  // layer 2's and dh's B, b2 and w3; then the block's dA [KT][80] (shared
  // tile) or layer 1's and dX's B (alone: resident, where the shared
  // tile's stream through its rings)
  static constexpr int kW2 = (kTH1 / 8) * kTStep2 + (kTH2 / 8) * kTStep1 + 2 * kTH2;
  static constexpr int kRing = kW2 + (kSolo ? (KT / 4) * kTStep1 + (KT / 32) * 10 * kWStepX
                                            : KT * kTH1);
  static constexpr int kTeam0 = (kRing + (kSolo ? 0 : 2 * kWSlots * kWSlot) + 31) / 32 * 32;
  // a team's part, offsets from its start; alone the region takes dW2's
  // and dWX's B a half of the tile's positions at a time
  static constexpr int kKeys = 0;
  static constexpr int kRegion = kKeys + kWM * kSK;
  static constexpr int kRegionFloats = kSolo ? kWM * kTH1 + (kWM / 16) * kTStep2 : 2 * kWM * kTH1;
  static constexpr int kRedRs = kRegion + kRegionFloats;  // [4 warps][kRows][80]
  static constexpr int kRedEs = kRedRs + 4 * kRows * kTH1;  // [4 warps][kRows][KT]
  static constexpr int kRed2 = kRedEs + 4 * kRows * KT;     // [4 warps][db2 40 | dw3 40]
  static constexpr int kQ = kRed2 + 4 * 2 * kTH2;           // [kRows][KT]
  static constexpr int kG = kQ + kRows * KT;
  static constexpr int kEs = kG + kRows * KT;
  static constexpr int kA = kEs + kRows * KT;  // [kRows][80]
  static constexpr int kRs = kA + kRows * kTH1;
  static constexpr int kDl = kRs + kRows * kTH1;
  static constexpr int kS = kDl + kWM;
  static constexpr int kIdx = kS + kWM;
  static constexpr int kSums = kIdx + kWM;  // db1 80, db2 40, dw3 40, db3
  // [8 warps][2 kRows] sums, c, counts and cursors [kRows] each
  static constexpr int kMisc = kSums + kTH1 + 2 * kTH2 + 4;
  static constexpr int kTeamFloats = (kMisc + 20 * kRows + 31) / 32 * 32;
  static constexpr int kTotal = kTeam0 + kTeams * kTeamFloats;
  static constexpr int kBytes = 4 * kTotal;
  static_assert(kRing % 4 == 0 && kTeam0 % 32 == 0 && kRegion % 32 == 0 && kQ % 4 == 0 &&
                    kG % 4 == 0 && kEs % 4 == 0, "aligned parts");
  static_assert(kBytes <= static_cast<int>(kMaxSharedBytes), "the wide kernel's shared memory");
  static_assert(kRegionFloats >= (kSolo ? (kWM / 16) * kTStep1 : 0), "a half of dh's parts fits");
};

// g . k over columns c_lo .. c_hi - 1 in order, one fma a column from 0
// (float4 loads with vq: c_lo and c_hi - c_lo multiples of 4, k 16-byte
// aligned); the wide kernel's sweep and tiles take dscore this way, a
// quarter of the columns a thread, so both get the same value
__device__ __forceinline__ float quarter_dot(const float* g, const float* k, int c_lo, int c_hi,
                                             bool vq) {
  float ds = 0.f;
  if (vq) {
    for (int c = c_lo; c < c_hi; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(k + c);
      const float4 gv = *reinterpret_cast<const float4*>(g + c);
      ds = fmaf(gv.x, kv.x, ds);
      ds = fmaf(gv.y, kv.y, ds);
      ds = fmaf(gv.z, kv.z, ds);
      ds = fmaf(gv.w, kv.w, ds);
    }
  } else {
    for (int c = c_lo; c < c_hi; ++c) ds = fmaf(g[c], k[c], ds);
  }
  return ds;
}

// The wide kernel's first launch, blocks of kTermCols threads: the first
// `pack` blocks write the packed weights, split into big and small TF32
// parts (split_fast) in the products' K-major core-matrix layouts; the rest
// every row's term b1 + q (Wq + Wm) into terms [batch][H1], as the global
// forward kernel's row-term kernel does, 16 rows a block
__global__ void __launch_bounds__(kTermCols)
din_backward_wide_pack(const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ w3, const float* __restrict__ query,
                       float* __restrict__ packed, float* __restrict__ terms, int batch, int K,
                       int H1, int H2, int KT, int pack) {
  if (static_cast<int>(blockIdx.x) >= pack) {
    row_terms_block(query, w1, b1, terms, batch, K, H1, blockIdx.x - pack, 0);
    return;
  }
  const WidePack P = wide_pack(KT);
  const int stride = pack * blockDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  auto wkm = [&](int c, int h) { return __fsub_rn(w1[(K + c) * H1 + h], w1[(2 * K + c) * H1 + h]); };
  auto wp = [&](int c, int h) { return w1[(3 * K + c) * H1 + h]; };
  // layer 1: k-step 4 j + sub reads [Wk - Wm] (sub 0, 1) or [Wp] (2, 3)
  // rows 16 j + 4 (k % 4) + 2 (sub % 2) + k / 4, as the tile kernel's
  for (int f = i0; f < (KT / 4) * kTH1 * 8; f += stride) {
    const int kk = f & 7, n = (f >> 3) % kTH1, st = (f >> 3) / kTH1;
    const int sub = st & 3;
    const int c = 16 * (st >> 2) + 4 * (kk & 3) + 2 * (sub & 1) + (kk >> 2);
    const float v = n < H1 && c < K ? (sub < 2 ? wkm(c, n) : wp(c, n)) : 0.f;
    put_split(packed + P.w1 + st * kTStep1 + core_offset(n, kk), kTH1 * 8, v);
  }
  // dX: chunk ch of 32 columns of K, k-step kt reads rows 8 kt + 2 (k % 4)
  // + k / 4 of H1; n < 32 the chunk's [Wk - Wm] columns, else its [Wp] ones
  for (int f = i0; f < (KT / 32) * 10 * 64 * 8; f += stride) {
    const int kk = f & 7, n = (f >> 3) & 63, kt = (f >> 9) % 10, ch = (f >> 9) / 10;
    const int h = 8 * kt + 2 * (kk & 3) + (kk >> 2);
    const int c = 32 * ch + (n & 31);
    const float v = h < H1 && c < K ? (n < 32 ? wkm(c, h) : wp(c, h)) : 0.f;
    put_split(packed + P.wx + (ch * 10 + kt) * kWStepX + core_offset(n, kk), 64 * 8, v);
  }
  float* res = packed + P.res;
  for (int f = i0; f < (kTH1 / 8) * kTH2 * 8; f += stride) {
    const int kk = f & 7, n = (f >> 3) % kTH2, kt = (f >> 3) / kTH2;
    const int h = 8 * kt + 2 * (kk & 3) + (kk >> 2);
    const float v = h < H1 && n < H2 ? w2[h * H2 + n] : 0.f;
    put_split(res + P.w2 + kt * kTStep2 + core_offset(n, kk), kTH2 * 8, v);
  }
  for (int f = i0; f < (kTH2 / 8) * kTH1 * 8; f += stride) {
    const int kk = f & 7, n = (f >> 3) % kTH1, kt = (f >> 3) / kTH1;
    const int z = 8 * kt + 2 * (kk & 3) + (kk >> 2);
    const float v = n < H1 && z < H2 ? w2[n * H2 + z] : 0.f;
    put_split(res + P.w2t + kt * kTStep1 + core_offset(n, kk), kTH1 * 8, v);
  }
  for (int i = i0; i < kTH2; i += stride) {
    res[P.b2 + i] = i < H2 ? b2[i] : 0.f;
    res[P.w3 + i] = i < H2 ? w3[i] : 0.f;
  }
  for (int i = i0; i < KT * kTH1; i += stride) {
    const int c = i / kTH1, h = i - c * kTH1;
    res[P.wa + i] = c < K && h < H1 ? __fadd_rn(w1[c * H1 + h], w1[(2 * K + c) * H1 + h]) : 0.f;
  }
}

template <int KT>
__global__ void __launch_bounds__(kWThreads, 1)
din_backward_wide_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                         const float* __restrict__ mask, const float* __restrict__ weights,
                         const float* __restrict__ grad, const float* __restrict__ packed,
                         const float* __restrict__ terms, float* __restrict__ dq,
                         float* __restrict__ dkeys, float* __restrict__ partials, BackPlan L,
                         int batch, int T, int K, int H1, bool relu, bool softmax, bool pool,
                         bool vec) {
  using S = WideSmem<KT>;
  constexpr bool SOLO = S::kSolo;
  constexpr int NT = SOLO ? 128 : kWThreads;   // a team's threads
  constexpr int NCH = KT / 32;                 // 32-column chunks of K
  constexpr int NXW = NCH >= 2 ? NCH / 2 : 1;  // dX chunks, dWX m-tiles a warpgroup may own
  constexpr int NW2 = SOLO ? 2 : 1;            // dW2's m-tiles a warpgroup owns
  constexpr int L1B = SOLO ? KT / 16 : KT / 32;  // layer-1 16-column blocks a warpgroup takes
  constexpr int L1S = 4 * L1B;                 // and its k-steps
  constexpr int R = S::kRows;                  // batch rows a unit
  extern __shared__ __align__(1024) float4 wide_smem4[];
  float* smem = reinterpret_cast<float*>(wide_smem4);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int w = wt >> 5;  // warp of the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int i4 = lane & 3;
  const int team = SOLO ? wg : 0;
  const int lt = SOLO ? wt : tid;  // thread of the team
  const WidePack PK = wide_pack(KT);
  const float* w2_s = smem + PK.w2;
  const float* w2t_s = smem + PK.w2t;
  const float* b2_s = smem + PK.b2;
  const float* w3_s = smem + PK.w3;
  // Wq + Wm [KT][80], for dq, from the packed weights in device memory;
  // past K = 32 the block's dA [KT][80] takes its place in shared memory
  // (dA's updates a unit cost 21 % of the time at K = 128 in device
  // memory, chip_lab_din_backward.py)
  const float* wa = packed + PK.res + PK.wa;
  const float* l1b_s = smem + S::kW2;                    // alone: layer 1's B
  const float* dxb_s = l1b_s + (KT / 4) * kTStep1;       // and dX's
  float* tsm = smem + S::kTeam0 + team * S::kTeamFloats;  // the team's part
  float* keys_s = tsm + S::kKeys;
  float* region = tsm + S::kRegion;
  float* du_s = region + kWM * kTH1;
  float* red_rs = tsm + S::kRedRs;
  float* red_es = tsm + S::kRedEs;
  float* red2 = tsm + S::kRed2;
  float* q_s = tsm + S::kQ;
  float* g_s = tsm + S::kG;
  float* es_s = tsm + S::kEs;
  float* a_s = tsm + S::kA;
  float* rs_s = tsm + S::kRs;
  float* dl_s = tsm + S::kDl;
  float* s_s = tsm + S::kS;
  int* idx_s = reinterpret_cast<int*>(tsm + S::kIdx);
  float* sums = tsm + S::kSums;
  float* misc = tsm + S::kMisc;  // [8 warps][2 R] sums, then c, counts, cursors [R] each
  float* c_s = misc + 16 * R;
  int* cnt_s = reinterpret_cast<int*>(misc + 17 * R);
  int* cur_s = reinterpret_cast<int*>(misc + 18 * R);

  // a team's barrier: its warpgroup's, or the block's
  auto bar = [&]() {
    if (SOLO) {
      wg_bar(wg);
    } else {
      __syncthreads();
    }
  };
  // a quarter of K's columns, each thread's of a position's g . k (float4
  // steps where a quarter is whole float4s)
  const int kq = (K + 3) / 4;
  const bool vq = vec && kq % 4 == 0;
  // what this warpgroup owns of a shared tile: dX chunks x0 .. x0 + nx - 1,
  // dWX m-tiles (the same chunks' [k | q*k] columns) x0 .. x0 + nm - 1,
  // dW2's m-tile wg, n-tiles of h1, du and dh that it stores (mine80,
  // mine40); alone (SOLO) every one of them
  const int x0 = SOLO ? 0 : NCH >= 2 ? wg * (NCH / 2) : 0;
  const int nx = SOLO ? 1 : NCH >= 2 ? NCH / 2 : wg;
  const int nm = SOLO ? 1 : NCH >= 2 ? NCH / 2 : 1 - wg;
  auto mine80 = [&](int j) { return SOLO || (j >= kTH1 / 16) == (wg == 1); };
  auto mine40 = [&](int j) { return SOLO || (j >= 3) == (wg == 1); };

  // the resident weights; shared memory past the rings 0 (keys' columns
  // past K are never copied to and read as 0)
  for (int i = tid; i < S::kW2 / 4; i += kWThreads) {
    cp_async16(smem + 4 * i, packed + PK.res + 4 * i);
  }
  if (SOLO) {
    for (int i = tid; i < PK.res / 4; i += kWThreads) {
      cp_async16(smem + S::kW2 + 4 * i, packed + 4 * i);
    }
  }
  cp_async_commit();
  for (int i = (SOLO ? S::kTeam0 : S::kW2) + tid; i < S::kTotal; i += kWThreads) {
    if (i < S::kRing || i >= S::kTeam0) smem[i] = 0.f;
  }
  float* out = partials + (static_cast<long long>(blockIdx.x) * S::kTeams + team) * L.acc;
  float* dA = SOLO ? out + L.o_ax + 2LL * KT * kTH1 : smem + PK.wa;
  if (SOLO) {
    for (int i = lt; i < KT * kTH1; i += NT) dA[i] = 0.f;
  }

  // the warpgroup's stream of weight k-steps, each tile the same: its
  // layer-1 k-steps, then its dX chunks' 10 each, copied into a ring of
  // kWSlots, kWSlots - 1 ahead
  float* ring = smem + S::kRing + wg * kWSlots * kWSlot;
  const int seq = L1S + 10 * nx;
  long long issued = 0, used = 0;
  auto issue = [&]() {
    const int j = static_cast<int>(issued % seq);
    const float* src;
    int n;
    if (j < L1S) {
      src = packed + PK.w1 + static_cast<long long>((SOLO ? 0 : wg * L1S) + j) * kTStep1;
      n = kTStep1;
    } else {
      const int jj = j - L1S;
      src = packed + PK.wx + static_cast<long long>((x0 + jj / 10) * 10 + jj % 10) * kWStepX;
      n = kWStepX;
    }
    float* dst = ring + (issued % kWSlots) * kWSlot;
    for (int i = wt; i < n / 4; i += 128) cp_async16(dst + 4 * i, src + 4 * i);
    cp_async_commit();
    ++issued;
  };
  // the next k-step's B: its copy waited for by every thread of the
  // warpgroup, whose barrier also ends the last k-step's reads of the slot
  // that the next copy takes
  auto take = [&]() -> const float* {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kWSlots - 2) : "memory");
    fence_async_smem();
    wg_bar(wg);
    issue();
    return ring + (used++ % kWSlots) * kWSlot;
  };
  // the tile's j-th k-step of B of this warpgroup's stream: alone from the
  // resident copies, else the ring's next
  auto wb = [&](int j) -> const float* {
    if (SOLO) return j < L1S ? l1b_s + j * kTStep1 : dxb_s + (j - L1S) * kWStepX;
    return take();
  };
  if (!SOLO) {
    for (int s = 0; s < kWSlots - 1; ++s) issue();
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  float dwx[NXW][kTH1 / 2], dw2[NW2][kTH2 / 2];
#pragma unroll
  for (int m = 0; m < NXW; ++m) {
#pragma unroll
    for (int i = 0; i < kTH1 / 2; ++i) dwx[m][i] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < NW2; ++m) {
#pragma unroll
    for (int i = 0; i < kTH2 / 2; ++i) dw2[m][i] = 0.f;
  }
  const int p_lo = 16 * w + g;  // this thread's accumulator rows: positions p_lo, p_hi
  const int p_hi = p_lo + 8;
  const int h1b = 4 * (g & 3) + 2 * (g >> 2) + 32 * i4;
  const int cb = 32 * (g >> 2) + 8 * i4 + (g & 3);
  const long long units = (static_cast<long long>(batch) + R - 1) / R;

  for (long long unit = static_cast<long long>(blockIdx.x) * S::kTeams + team; unit < units;
       unit += static_cast<long long>(gridDim.x) * S::kTeams) {
    const long long b0 = static_cast<long long>(R) * unit;
    const int nrows = static_cast<int>(min(static_cast<long long>(R), batch - b0));
    bar();  // the last unit is done with every buffer
    for (int i = lt; i < R * KT; i += NT) {
      const int r = i / KT, c = i - r * KT;
      const bool in = r < nrows && c < K;
      q_s[i] = in ? query[(b0 + r) * K + c] : 0.f;
      g_s[i] = in && pool ? grad[(b0 + r) * K + c] : 0.f;
      es_s[i] = 0.f;
    }
    for (int i = lt; i < R * kTH1; i += NT) {
      const int r = i / kTH1, h = i - r * kTH1;
      a_s[i] = r < nrows && h < H1 ? terms[(b0 + r) * H1 + h] : 0.f;
      rs_s[i] = 0.f;
    }
    bar();

    // the sweep, four threads a position (each a quarter of its columns),
    // U positions a thread in flight, their loads issued before the sums:
    // count the valid ones; a masked one's dkeys is s g (pooled) or 0 (its
    // dlogit is 0); under the softmax, c = sum_t s dscore over the valid
    // ones, dscore = g . k as each tile takes it (quarter_dot's order)
    {
      constexpr int U = KT == 32 ? 4 : KT == 64 ? 2 : 1;
      constexpr int KQ4 = KT / 16;  // float4s of a quarter, at most
      float part[2 * R];  // each row's c, then each row's count
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) part[k] = 0.f;
      const int qtr = lt & 3;
      const int c_lo = qtr * kq, c_hi = min(K, c_lo + kq);
      const bool dots = softmax;  // c needs g . k only under the softmax
      for (int r = 0; r < nrows; ++r) {
        const long long b = b0 + r;
        const float* gr = g_s + r * KT;
        for (int t0 = 0; t0 < T; t0 += U * (NT / 4)) {
          bool in[U], valid[U];
          float sv[U], ds[U];
          long long pos[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int t = t0 + u * (NT / 4) + (lt >> 2);
            in[u] = t < T;
            pos[u] = b * T + (in[u] ? t : 0);
            valid[u] = in[u] && mask[pos[u]] > 0.5f;
            sv[u] = in[u] ? weights[pos[u]] : 0.f;
          }
          if (vq) {
            float4 kv[U][KQ4];
#pragma unroll
            for (int u = 0; u < U; ++u) {
#pragma unroll
              for (int i = 0; i < KQ4; ++i) {
                kv[u][i] = valid[u] && dots && pool && c_lo + 4 * i < c_hi
                               ? *reinterpret_cast<const float4*>(keys + pos[u] * K + c_lo + 4 * i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
              }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
              float d = 0.f;
#pragma unroll
              for (int i = 0; i < KQ4; ++i) {
                if (c_lo + 4 * i < c_hi) {
                  const float4 gv = *reinterpret_cast<const float4*>(gr + c_lo + 4 * i);
                  d = fmaf(gv.x, kv[u][i].x, d);
                  d = fmaf(gv.y, kv[u][i].y, d);
                  d = fmaf(gv.z, kv[u][i].z, d);
                  d = fmaf(gv.w, kv[u][i].w, d);
                }
              }
              ds[u] = d;
            }
          } else {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              ds[u] = valid[u] && dots && pool
                          ? quarter_dot(gr, keys + pos[u] * K, c_lo, c_hi, false) : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (in[u] && !valid[u]) {
              float* dk = dkeys + pos[u] * K;
              if (vq) {
                for (int c = c_lo; c < c_hi; c += 4) {
                  const float4 gv = *reinterpret_cast<const float4*>(gr + c);
                  *reinterpret_cast<float4*>(dk + c) =
                      make_float4(sv[u] * gv.x, sv[u] * gv.y, sv[u] * gv.z, sv[u] * gv.w);
                }
              } else {
                for (int c = c_lo; c < c_hi; ++c) dk[c] = sv[u] * gr[c];
              }
            }
            if (!pool && valid[u] && dots && qtr == 0) ds[u] = grad[pos[u]];
            float d = ds[u];
            d += __shfl_xor_sync(kFull, d, 1);
            d += __shfl_xor_sync(kFull, d, 2);
            if (qtr == 0 && valid[u]) {
#pragma unroll
              for (int k = 0; k < R; ++k) {
                if (k == r) {
                  part[R + k] += 1.f;
                  part[k] = fmaf(sv[u], d, part[k]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) {
        const float v = warp_sum(part[k]);
        if (lane == 0) misc[(lt >> 5) * 2 * R + k] = v;
      }
    }
    bar();
    if (lt < 2 * R) {
      float v = 0.f;
      for (int i = 0; i < NT / 32; ++i) v += misc[i * 2 * R + lt];
      if (lt < R) {
        c_s[lt] = v;
        cur_s[lt] = 0;
      } else {
        cnt_s[lt - R] = static_cast<int>(v);
      }
    }
    bar();
    // the unit's valid positions, the rows' in turn: row r's are pre[r] ..
    // pre[r + 1] - 1
    int pre[R + 1];
    pre[0] = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) pre[r + 1] = pre[r] + cnt_s[r];
    const int n_all = pre[R];
    // the row of the unit's valid position gp
    auto row_at = [&](int gp) {
      int r = 0;
#pragma unroll
      for (int k = 1; k < R; ++k) r += gp >= pre[k];
      return r;
    };

    for (int tt = 0; tt * kWM < n_all; ++tt) {
      const int p0 = tt * kWM;
      const int np = min(kWM, n_all - p0);
      const int rA = row_at(p0), rB = row_at(p0 + np - 1);  // the tile's first and last rows
      const int nr = rB - rA + 1;
      auto row_of = [&](int p) { return row_at(p0 + p); };

      // the tile's positions: warp w takes row rA + w's next ones from its
      // cursor
      if (lt < 32 * R) {
        const int r = rA + w;
        int lo = 0, hi = 0;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (k == r) {
            lo = max(pre[k], p0);
            hi = min(pre[k + 1], p0 + np);
          }
        }
        const int m = r <= rB ? hi - lo : 0;
        const int base = lo - p0;
        if (m > 0) {
          const float* mr = mask + (b0 + r) * T;
          // windows of 32 positions, four loaded at once
          int t = cur_s[r], got = 0;
          while (got < m) {
            bool vv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int tl = t + 32 * k + lane;
              vv[k] = tl < T && mr[tl] > 0.5f;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (got < m) {
                const int tl = t + lane;
                const bool v = vv[k];
                const unsigned bal = __ballot_sync(kFull, v);
                const int rank = __popc(bal & ((1u << lane) - 1u));
                const int take_n = min(__popc(bal), m - got);
                if (v && rank < take_n) idx_s[base + got + rank] = tl;
                if (take_n < __popc(bal)) {
                  t += __ffs(__ballot_sync(kFull, v && rank == take_n - 1));
                } else {
                  t += 32;
                }
                got += take_n;
              }
            }
          }
          if (lane == 0) cur_s[r] = t;
        }
      }
      bar();
      // the tile's keys, weights and (for scores) cotangents, by cp.async
      {
        if (vec) {
          const int per = K / 4;
          for (int i = lt; i < np * per; i += NT) {
            const int p = i / per;
            const int c = 4 * (i - p * per);
            cp_async16(keys_s + p * S::kSK + c, keys + ((b0 + row_of(p)) * T + idx_s[p]) * K + c);
          }
        } else {
          for (int i = lt; i < np * K; i += NT) {
            const int p = i / K;
            const int c = i - p * K;
            cp_async4(keys_s + p * S::kSK + c, keys + ((b0 + row_of(p)) * T + idx_s[p]) * K + c);
          }
        }
        if (lt < np) {
          const long long pos = (b0 + row_of(lt)) * T + idx_s[lt];
          cp_async4(s_s + lt, weights + pos);
          if (!pool) cp_async4(dl_s + lt, grad + pos);
        }
        cp_async_commit();
        cp_async_wait_all();
      }
      bar();
      // dlogit: dscore = g . k (four threads a position, a quarter of the
      // columns each, then a fixed tree: as the sweep took it for c, so
      // where the softmax leaves a row's dlogits 0, as at T = 1, they come
      // out 0) or g; s (dscore - c) under the softmax; 0 past the tile's
      // positions
      for (int i = lt; i < 4 * kWM; i += NT) {
        const int p = i >> 2, qtr = i & 3;
        float ds = 0.f;
        if (p < np) {
          if (pool) {
            const int c_lo = qtr * kq;
            ds = quarter_dot(g_s + row_of(p) * KT, keys_s + p * S::kSK, c_lo,
                             min(K, c_lo + kq), vq);
          } else if (qtr == 0) {
            ds = dl_s[p];
          }
        }
        ds += __shfl_xor_sync(kFull, ds, 1);
        ds += __shfl_xor_sync(kFull, ds, 2);
        __syncwarp();
        if (qtr == 0) {
          dl_s[p] = p < np ? (softmax ? s_s[p] * (ds - c_s[row_of(p)]) : ds) : 0.f;
        }
      }
      bar();

      const bool v_lo = p_lo < np, v_hi = p_hi < np;
      const int r_lo = v_lo ? row_of(p_lo) : 0;
      const int r_hi = v_hi ? row_of(p_hi) : 0;

      // layer 1 again, this warpgroup's half of K's 16-column blocks:
      // [k | q*k] [Wk - Wm ; Wp]
      float hacc[kTH1 / 2];
#pragma unroll
      for (int i = 0; i < kTH1 / 2; ++i) hacc[i] = 0.f;
      {
        const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
        const float* kl = keys_s + p_lo * S::kSK + 4 * i4;
        const float* kh = keys_s + p_hi * S::kSK + 4 * i4;
        const float* ql = q_s + r_lo * KT + 4 * i4;
        const float* qh = q_s + r_hi * KT + 4 * i4;
#pragma unroll
        for (int jb = 0; jb < L1B; ++jb) {
          const int j = (SOLO ? 0 : wg * L1B) + jb;
          const float4 cl = v_lo ? *reinterpret_cast<const float4*>(kl + 16 * j) : zero4;
          const float4 ch = v_hi ? *reinterpret_cast<const float4*>(kh + 16 * j) : zero4;
          const float4 qa = *reinterpret_cast<const float4*>(ql + 16 * j);
          const float4 qb = *reinterpret_cast<const float4*>(qh + 16 * j);
          const float* b = wb(4 * jb);
          tile_step<kTH1>(hacc, cl.x, ch.x, cl.y, ch.y, b);
          b = wb(4 * jb + 1);
          tile_step<kTH1>(hacc, cl.z, ch.z, cl.w, ch.w, b);
          b = wb(4 * jb + 2);
          tile_step<kTH1>(hacc, __fmul_rn(qa.x, cl.x), __fmul_rn(qb.x, ch.x),
                          __fmul_rn(qa.y, cl.y), __fmul_rn(qb.y, ch.y), b);
          b = wb(4 * jb + 3);
          tile_step<kTH1>(hacc, __fmul_rn(qa.z, cl.z), __fmul_rn(qb.z, ch.z),
                          __fmul_rn(qa.w, cl.w), __fmul_rn(qb.w, ch.w), b);
        }
      }
      tile_end(hacc);
      if (!SOLO) {
        // the two halves' sums swapped (a thread the same elements in both
        // warpgroups), added in one order: h1 = act(a + (half 0 + half 1))
#pragma unroll
        for (int i = 0; i < kTH1 / 2; ++i) region[(wg * (kTH1 / 2) + i) * 128 + wt] = hacc[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kTH1 / 2; ++i) {
          hacc[i] = __fadd_rn(hacc[i], region[((1 - wg) * (kTH1 / 2) + i) * 128 + wt]);
        }
        __syncthreads();  // both have read the halves: the region takes h1
      }
#pragma unroll
      for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 8 * j + 2 * i4 + (e & 1);
          hacc[4 * j + e] = act(a_s[(e < 2 ? r_lo : r_hi) * kTH1 + h] + hacc[4 * j + e], relu);
        }
      }
      // h1 in dW2's A order, the first warpgroup its first 5 n-tiles, the
      // second the rest
#pragma unroll
      for (int j = 0; j < kTH1 / 8; ++j) {
        if (mine80(j)) {
#pragma unroll
          for (int e = 0; e < 4; ++e) region[h1_slot(h1b, w, e >> 1, j, e & 1)] = hacc[4 * j + e];
        }
      }

      // layer 2 again (both warpgroups); du = dlogit w3 act'(h2); the
      // warps' sums of du (db2) and h2 dlogit (dw3), and du's split parts
      // (dW2's B), the first warpgroup n-tiles 0-2, the second 3-4
      float z[kTH2 / 2];
#pragma unroll
      for (int i = 0; i < kTH2 / 2; ++i) z[i] = 0.f;
#pragma unroll
      for (int kt = 0; kt < kTH1 / 8; ++kt) {
        tile_step<kTH2>(z, hacc[4 * kt], hacc[4 * kt + 2], hacc[4 * kt + 1], hacc[4 * kt + 3],
                        w2_s + kt * kTStep2);
      }
      tile_end(z);
      {
        const float d_lo = dl_s[p_lo], d_hi = dl_s[p_hi];
#pragma unroll
        for (int j = 0; j < kTH2 / 8; ++j) {
          float sw3[2] = {0.f, 0.f}, sb2[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * i4 + (e & 1);
            const float d = e < 2 ? d_lo : d_hi;
            const float h2 = act(z[4 * j + e] + b2_s[col], relu);
            const float du = (d * w3_s[col]) * dact(h2, relu);
            z[4 * j + e] = du;
            sw3[e & 1] = fmaf(h2, d, sw3[e & 1]);
            sb2[e & 1] += du;
          }
          if (mine40(j)) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float b2sum = rows_sum(sb2[c]);
              const float w3sum = rows_sum(sw3[c]);
              if (g == 0) {
                red2[w * 2 * kTH2 + 8 * j + 2 * i4 + c] = b2sum;
                red2[w * 2 * kTH2 + kTH2 + 8 * j + 2 * i4 + c] = w3sum;
              }
            }
          }
        }
      }

      // dW2 += h1^T du over the tile's positions, the warpgroup's m-tiles:
      // h1's columns 0-63 (the first warpgroup), 64-79 (the second, its
      // first warp's rows), or both, their products in flight together;
      // du's split parts (dW2's B) put by the first warpgroup for n-tiles
      // 0-2, the second 3-4, or alone in halves of the positions, the
      // half's warps
      constexpr int HV = SOLO ? 2 : 1;
      constexpr int KS = kWM / 8 / HV;  // k-steps a half
#pragma unroll
      for (int half = 0; half < HV; ++half) {
        if (!SOLO || (w >> 1) == half) {
#pragma unroll
          for (int j = 0; j < kTH2 / 8; ++j) {
            if (mine40(j)) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                put_split(du_s + (2 * w + (e >> 1) - KS * half) * kTStep2 + cb + 64 * j +
                              4 * (e & 1),
                          kTH2 * 8, z[4 * j + e]);
              }
            }
          }
        }
        fence_async_smem();
        bar();
#pragma unroll
        for (int k0 = KS * half; k0 < KS * (half + 1); k0 += kTSumSteps) {
          float a[NW2][kTSumSteps][4], t[NW2][kTH2 / 2];
#pragma unroll
          for (int mi = 0; mi < NW2; ++mi) {
            const int mt = SOLO ? mi : wg;
#pragma unroll
            for (int s = 0; s < kTSumSteps; ++s) {
              const float4 v =
                  mt == 0 ? *reinterpret_cast<const float4*>(region + 4 * ((k0 + s) * 128 + wt))
                  : w == 0 ? *reinterpret_cast<const float4*>(region + kWM * 64 +
                                                              4 * ((k0 + s) * 32 + lane))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
              a[mi][s][0] = v.x; a[mi][s][1] = v.y; a[mi][s][2] = v.z; a[mi][s][3] = v.w;
            }
          }
          wg_fence();
#pragma unroll
          for (int mi = 0; mi < NW2; ++mi) {
            const int mt = SOLO ? mi : wg;
            tile_sum_issue<kTH2, kTSumSteps>(t[mi], a[mi], du_s + (k0 - KS * half) * kTStep2,
                                             kTStep2, mt == 1 && w != 0);
          }
          wg_commit();
          wg_wait_all();
#pragma unroll
          for (int mi = 0; mi < NW2; ++mi) tile_sum_add(dw2[mi], t[mi]);
        }
        if (half + 1 < HV) bar();  // the half's parts are read before the next half's go in
      }

      // dh = (du W2^T) act'(h1), both warpgroups
      float dh[kTH1 / 2];
#pragma unroll
      for (int i = 0; i < kTH1 / 2; ++i) dh[i] = 0.f;
#pragma unroll
      for (int kt = 0; kt < kTH2 / 8; ++kt) {
        tile_step<kTH1>(dh, z[4 * kt], z[4 * kt + 2], z[4 * kt + 1], z[4 * kt + 3],
                        w2t_s + kt * kTStep1);
      }
      tile_end(dh);
#pragma unroll
      for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dh[4 * j + e] = dh[4 * j + e] * dact(region[h1_slot(h1b, w, e >> 1, j, e & 1)], relu);
        }
      }
      bar();  // h1 and du's parts are read: the region takes dh's parts

      // the warps' sums of dh over each of the tile's rows, n-tile j
      auto rows_dh = [&](int j) {
        for (int r = rA; r < rA + nr; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float v = rows_sum((r_lo == r ? dh[4 * j + c] : 0.f) +
                                     (r_hi == r ? dh[4 * j + 2 + c] : 0.f));
            if (g == 0) red_rs[(w * R + r) * kTH1 + 8 * j + 2 * i4 + c] = v;
          }
        }
      };
      // dh's split parts (dWX's B) at k-step ks of the region, n-tile j
      auto put_dh = [&](int ks, int j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          put_split(region + (ks + (e >> 1)) * kTStep1 + cb + 64 * j + 4 * (e & 1), kTH1 * 8,
                    dh[4 * j + e]);
        }
      };
      // dX = dh [Wk - Wm ; Wp]^T, chunk ci of the warpgroup's: dkeys = s g +
      // dX_k + dX_qk q, and the warps' sums of the dq terms dX_qk k over
      // each of the tile's rows
      auto dx_chunk = [&](int ci) {
        const int chunk = x0 + ci;
        float x[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = 0.f;
#pragma unroll
        for (int kt = 0; kt < kTH1 / 8; ++kt) {
          const float* b = wb(L1S + 10 * ci + kt);
          tile_step<64>(x, dh[4 * kt], dh[4 * kt + 2], dh[4 * kt + 1], dh[4 * kt + 3], b);
        }
        tile_end(x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int c = 32 * chunk + 8 * j + 2 * i4;
            const int p = hi ? p_hi : p_lo;
            const int r = hi ? r_hi : r_lo;
            float dk[2], ev[2] = {0.f, 0.f};
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int e = 2 * hi + e1;
              const float dqk = x[4 * (j + 4) + e];
              const float base = pool ? s_s[p] * g_s[r * KT + c + e1] : 0.f;
              dk[e1] = (base + x[4 * j + e]) + dqk * q_s[r * KT + c + e1];
              ev[e1] = dqk * keys_s[p * S::kSK + c + e1];
            }
            if (hi ? v_hi : v_lo) {
              float* o = dkeys + ((b0 + r) * T + idx_s[p]) * K + c;
              if (K % 2 == 0 && c < K) {
                *reinterpret_cast<float2*>(o) = make_float2(dk[0], dk[1]);
              } else {
                if (c < K) o[0] = dk[0];
                if (c + 1 < K) o[1] = dk[1];
              }
            } else {
              ev[0] = ev[1] = 0.f;
            }
            x[4 * (j + 4) + 2 * hi] = ev[0];
            x[4 * (j + 4) + 2 * hi + 1] = ev[1];
          }
        }
        for (int r = rA; r < rA + nr; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float v = rows_sum((r_lo == r ? x[4 * (j + 4) + c] : 0.f) +
                                       (r_hi == r ? x[4 * (j + 4) + 2 + c] : 0.f));
              if (g == 0) red_es[(w * R + r) * KT + 32 * chunk + 8 * j + 2 * i4 + c] = v;
            }
          }
        }
      };
      // dWX += X^T dh over k-steps k0 .. k0 + kTSumSteps - 1 of the tile's
      // positions, m-tile mi of the warpgroup's (X's columns 16 w + g and
      // + 8 of the chunk's [k | q*k]), dh's parts at b
      auto dwx_steps = [&](int mi, int k0, const float* b) {
        const int xc = 32 * (x0 + mi) + ((16 * w + g) & 31);
        const float* xk = keys_s + i4 * S::kSK + xc;
        float xa[kTSumSteps][4];
#pragma unroll
        for (int s = 0; s < kTSumSteps; ++s) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 8 * (k0 + s) + i4 + 4 * (e >> 1);
            float v = p < np ? xk[(8 * (k0 + s) + 4 * (e >> 1)) * S::kSK + 8 * (e & 1)] : 0.f;
            if (w >= 2) v = __fmul_rn(q_s[(p < np ? row_of(p) : 0) * KT + xc + 8 * (e & 1)], v);
            xa[s][e] = v;
          }
        }
        tile_sum_steps<kTH1, kTSumSteps>(dwx[mi], xa, b, kTStep1);
      };
      // the rows' carried sums (the 4 warps in order), the bias sums, db3
      auto add_sums = [&]() {
        for (int i = lt; i < nr * kTH1; i += NT) {
          const int r = rA + i / kTH1, h = i % kTH1;
          float v = red_rs[r * kTH1 + h];
          for (int ww = 1; ww < 4; ++ww) v += red_rs[(ww * R + r) * kTH1 + h];
          rs_s[r * kTH1 + h] += v;
        }
        for (int i = lt; i < nr * KT; i += NT) {
          const int r = rA + i / KT, c = i % KT;
          float v = red_es[r * KT + c];
          for (int ww = 1; ww < 4; ++ww) v += red_es[(ww * R + r) * KT + c];
          es_s[r * KT + c] += v;
        }
        if (lt < kTH2) {
          float v2 = red2[lt], v3 = red2[kTH2 + lt];
          for (int ww = 1; ww < 4; ++ww) {
            v2 += red2[ww * 2 * kTH2 + lt];
            v3 += red2[ww * 2 * kTH2 + kTH2 + lt];
          }
          sums[kTH1 + lt] += v2;
          sums[kTH1 + kTH2 + lt] += v3;
        } else if (lt >= 64 && lt < 96) {
          const float v = warp_sum(dl_s[lane] + dl_s[lane + 32]);
          if (lane == 0) sums[kTH1 + 2 * kTH2] += v;
        }
      };

      if (SOLO) {
        // alone, as the tile kernel: the rows' sums, dX, then dWX over the
        // tile's positions in halves of 32, the half's warps putting their
        // dh's parts in the region
#pragma unroll
        for (int j = 0; j < kTH1 / 8; ++j) rows_dh(j);
        dx_chunk(0);
        bar();
        add_sums();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if ((w >> 1) == half) {
#pragma unroll
            for (int j = 0; j < kTH1 / 8; ++j) put_dh(2 * (w & 1), j);
          }
          fence_async_smem();
          bar();
          dwx_steps(0, 4 * half, region);
          if (half == 0) bar();  // the half's parts are read before the next half's go in
        }
      } else {
        // dh's parts, the first warpgroup n-tiles 0-4, the second 5-9, and
        // their rows' sums; then dX and dWX side by side
#pragma unroll
        for (int j = 0; j < kTH1 / 8; ++j) {
          if (mine80(j)) {
            put_dh(2 * w, j);
            rows_dh(j);
          }
        }
        fence_async_smem();
        bar();
#pragma unroll
        for (int ci = 0; ci < NXW; ++ci) {
          if (ci < nx) dx_chunk(ci);
        }
#pragma unroll
        for (int mi = 0; mi < NXW; ++mi) {
          if (mi < nm) {
#pragma unroll
            for (int k0 = 0; k0 < kWM / 8; k0 += kTSumSteps) {
              dwx_steps(mi, k0, region + k0 * kTStep1);
            }
          }
        }
        bar();
        add_sums();
      }
    }
    bar();  // the rows' carried sums are in

    // the unit's rows: dq = (the sum of dX_qk k) + (the sum of dh) (Wq +
    // Wm)^T, a warp a column c of every row, its lanes over H1 (a read of
    // Wq + Wm's row c), then a fixed tree, four columns at once, their
    // reads in flight together; dA += q^T (the sum of dh), the rows in
    // order; db1 += the sums of dh
    for (int c0 = lt >> 5; c0 < K; c0 += 4 * (NT / 32)) {
      float wv[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * (NT / 32);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int h = lane + 32 * k;
          wv[u][k] = c < K && h < kTH1 ? wa[c * kTH1 + h] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * (NT / 32);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int h = lane + 32 * k;
            if (h < kTH1) v = fmaf(rs_s[r * kTH1 + h], wv[u][k], v);
          }
          v = warp_sum(v);
          if (lane == 0 && c < K && r < nrows) dq[(b0 + r) * K + c] = es_s[r * KT + c] + v;
        }
      }
    }
    for (int i = lt; i < KT * kTH1; i += NT) {
      const int c = i / kTH1, h = i - c * kTH1;
      float v = dA[i];
      for (int r = 0; r < nrows; ++r) v = fmaf(q_s[r * KT + c], rs_s[r * kTH1 + h], v);
      dA[i] = v;
    }
    if (lt < kTH1) {
      float v = rs_s[lt];
      for (int r = 1; r < R; ++r) v += rs_s[r * kTH1 + lt];
      sums[lt] += v;
    }
  }

  // this team's partial sums, in din_backward_reduce's layout (dA there
  // already where it lives in device memory)
  cp_async_wait_all();
  __syncthreads();
  if (!SOLO) {
    for (int i = lt; i < KT * kTH1; i += NT) out[L.o_ax + 2LL * KT * kTH1 + i] = dA[i];
  }
#pragma unroll
  for (int mi = 0; mi < NXW; ++mi) {
    if (mi < nm) {
#pragma unroll
      for (int j = 0; j < kTH1 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = p_lo + 8 * (e >> 1);  // the m-tile's row: [k | q*k] column
          const int row = (m >> 5) * KT + 32 * (x0 + mi) + (m & 31);
          out[L.o_ax + row * kTH1 + 8 * j + 2 * i4 + (e & 1)] = dwx[mi][4 * j + e];
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < NW2; ++mi) {
#pragma unroll
    for (int j = 0; j < kTH2 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 64 * (SOLO ? mi : wg) + p_lo + 8 * (e >> 1);
        if (m < kTH1) out[L.o_a2 + m * kTH2 + 8 * j + 2 * i4 + (e & 1)] = dw2[mi][4 * j + e];
      }
    }
  }
  for (int i = lt; i < kTH1; i += NT) out[L.o_ab1 + i] = sums[i];
  for (int i = lt; i < kTH2; i += NT) {
    out[L.o_ab2 + i] = sums[kTH1 + i];
    out[L.o_aw3 + i] = sums[kTH1 + kTH2 + i];
  }
  if (lt == 0) out[L.o_ab3] = sums[kTH1 + 2 * kTH2];
}

using WideKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                            const float*, const float*, float*, float*, float*, BackPlan, int, int,
                            int, int, bool, bool, bool, bool);

// the wide kernel's K padded: 32, 64 or 128, a template instantiation each
constexpr int kWideK[] = {32, 64, 128};
const WideKernel kWideKernels[] = {din_backward_wide_kernel<32>, din_backward_wide_kernel<64>,
                                   din_backward_wide_kernel<128>};
const int kWideBytes[] = {WideSmem<32>::kBytes, WideSmem<64>::kBytes, WideSmem<128>::kBytes};
const int kWideTeams[] = {WideSmem<32>::kTeams, WideSmem<64>::kTeams, WideSmem<128>::kTeams};
const int kWideRows[] = {WideSmem<32>::kRows, WideSmem<64>::kRows, WideSmem<128>::kRows};

int wide_slot(int K) { return K <= 32 ? 0 : K <= 64 ? 1 : 2; }

bool wide_takes(int T, int K, int H1, int H2) {
  return K <= 128 && H1 <= kTH1 && H2 <= kTH2 && !tile_takes(T, K, H1, H2);
}

// the wide kernel's running sums, one partial a team of `blocks`
BackPlan wide_sums(int slot, long long blocks) {
  BackPlan L{};
  L.Kp = kWideK[slot];
  L.H1p = kTH1;
  L.H1m = kTH1;
  L.H2p = kTH2;
  sums_layout(L);
  L.blocks = blocks * kWideTeams[slot];
  return L;
}

// The wide kernel's grid for a shape, chosen once a shape and device and
// kept: a block an SM, no more than its teams' units of rows
struct WideLaunch {
  int device, batch, slot;
  long long blocks;
};

cudaError_t wide_launch(int device, int batch, int slot, long long& blocks) {
  static std::mutex lock;
  static std::vector<WideLaunch> known;
  std::lock_guard<std::mutex> hold(lock);
  for (const WideLaunch& t : known) {
    if (t.device == device && t.batch == batch && t.slot == slot) {
      blocks = t.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kWideKernels[slot], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWideBytes[slot]);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kWideKernels[slot], kWThreads,
                                                        kWideBytes[slot]);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = (static_cast<long long>(batch) + kWideRows[slot] - 1) / kWideRows[slot];
  const long long need = (units + kWideTeams[slot] - 1) / kWideTeams[slot];
  blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > need) blocks = need;
  known.push_back({device, batch, slot, blocks});
  return cudaSuccess;
}

}  // namespace

extern "C" int din_attention_forward(const float* query, const float* keys,
                                     const float* mask, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, const float* w3,
                                     const float* b3, float* out, float* weights,
                                     int batch, int T, int K, int H1, int H2, int relu,
                                     int softmax, int scores, void* stream) {
  const int slot = tiles_slot(H1);
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0 || H2 > 256 || slot < 0) {
    return cudaErrorInvalidValue;
  }
  const int warps = warps_for(kTiles1[slot]);
  // the group size that scores the most positions per unit of time, among
  // those whose shared memory fits (the larger on a tie): a group takes
  // one round of the warps per 16 * warps positions, and its fixed work
  // (the barriers, the per-row term, the tail) about half a round more
  // (chip_lab_din.py: at DIN's shape groups of 9 rows in two rounds beat
  // groups of 5 in one)
  int rows = 0;
  double best = -1.0;
  const int most = batch < kMaxRows ? batch : kMaxRows;
  for (int r = 1; r <= most; ++r) {
    if (sizeof(float) * make_layout(T, K, H1, H2, kTiles1[slot], r).total > kMaxSharedBytes) {
      break;
    }
    const int tiles = (r * T + 15) / 16;
    const int rounds = (tiles + warps - 1) / warps;
    const double rate = static_cast<double>(r) * T / (rounds + 0.5);
    if (rate >= best) {
      best = rate;
      rows = r;
    }
  }
  if (rows == 0) return cudaErrorInvalidValue;
  const Layout L = make_layout(T, K, H1, H2, kTiles1[slot], rows);
  const size_t smem = sizeof(float) * L.total;
  const Kernel kernel = kKernels[slot];
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (static_cast<long long>(batch) + rows - 1) / rows;
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > groups) blocks = groups;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  kernel<<<static_cast<int>(blocks), warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      query, keys, mask, w1, b1, w2, b2, w3, b3, out, scores != 0 ? nullptr : weights, batch, T,
      K, H1, H2, L, relu != 0, softmax != 0, scores != 0, vec);
  return cudaGetLastError();
}

extern "C" int din_attention_global_forward(const float* query, const float* keys,
                                            const float* mask, const float* w1,
                                            const float* b1, const float* w2,
                                            const float* b2, const float* w3,
                                            const float* b3, float* out, float* scratch,
                                            int batch, int T, int K, int H1, int H2, int relu,
                                            int softmax, int return_scores, void* stream) {
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0) return cudaErrorInvalidValue;
  const int slot = h_tiles_slot(H1);
  const GlobalKernel kernel = kGlobalKernels[slot];
  const int warps = global_warps(kHTiles[slot]);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  GlobalLaunch g;
  if (err == cudaSuccess) err = global_launch(device, batch, T, K, H1, H2, g);
  if (err != cudaSuccess) return err;
  // scratch: the per-row terms [batch][H1], then (where the keys are
  // pooled) the raw scores [batch][T]; returned weights are scored in out
  float* terms = scratch;
  float* scores = return_scores ? out : scratch + static_cast<long long>(batch) * H1;
  const dim3 term_grid((batch + kTermRows - 1) / kTermRows, (H1 + kTermCols - 1) / kTermCols);
  din_attention_global_kernel_row_terms<<<term_grid, kTermCols, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      query, w1, b1, terms, batch, K, H1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  kernel<<<static_cast<int>(g.blocks), 32 * warps, sizeof(float) * g.plan.total,
           static_cast<cudaStream_t>(stream)>>>(query, keys, mask, w1, b1, w2, b2, w3, b3, out,
                                                terms, scores, batch, T, K, H1, H2, g.plan,
                                                relu != 0, softmax != 0, return_scores == 0, vec);
  return cudaGetLastError();
}

extern "C" long long din_attention_global_backward_scratch(int batch, int T, int K, int H1, int H2) {
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0) return -1;
  int device = 0;
  BackPlan L;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (back_launch(device, batch, T, K, H1, H2, L) != cudaSuccess) return -1;
  return back_scratch(L, batch, T, K, H1).total;
}

extern "C" int din_attention_global_backward(const float* query, const float* keys, const float* mask,
                                      const float* w1, const float* b1, const float* w2,
                                      const float* b2, const float* w3, const float* b3,
                                      const float* weights, const float* grad, float* dq,
                                      float* dkeys, float* dw1, float* db1, float* dw2,
                                      float* db2, float* dw3, float* db3, float* scratch,
                                      int batch, int T, int K, int H1, int H2, int relu,
                                      int softmax, int scores, void* stream) {
  (void)b3;  // the softmax's shift: no gradient flows through it but db3
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0) return cudaErrorInvalidValue;
  int device = 0;
  BackPlan L;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = back_launch(device, batch, T, K, H1, H2, L);
  if (err != cudaSuccess) return err;
  const BackScratch S = back_scratch(L, batch, T, K, H1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto grid = [](long long work, long long most) {
    const long long blocks = (work + kPrepThreads - 1) / kPrepThreads;
    return static_cast<int>(blocks < most ? (blocks > 0 ? blocks : 1) : most);
  };
  din_backward_pack<<<grid(L.wts, 4096), kPrepThreads, 0, s>>>(w1, w2, b2, w3,
                                                                 scratch + S.packed, K, H1, H2, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 term_grid((batch + kTermRows - 1) / kTermRows, (H1 + kTermCols - 1) / kTermCols);
  din_attention_global_kernel_row_terms<<<term_grid, kTermCols, 0, s>>>(query, w1, b1,
                                                                        scratch + S.terms,
                                                                        batch, K, H1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  din_backward_dlogits<<<grid(32LL * batch, 65536), kPrepThreads, 0, s>>>(
      keys, mask, weights, grad, scratch + S.dl, batch, T, K, softmax != 0, scores == 0,
      K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(grad) % 16 == 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  din_backward_kernel<<<static_cast<int>(L.blocks), 32 * L.warps, static_cast<size_t>(L.smem),
                        s>>>(query, keys, weights, grad, scratch + S.terms, scratch + S.dl,
                             scratch + S.packed, dkeys, scratch + S.e, scratch + S.partials,
                             scratch + S.act, batch, T, K, H1, L, relu != 0, scores == 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long outs = 4LL * K * H1 + H1 + static_cast<long long>(H1) * H2 + 2LL * H2 + 1;
  din_backward_reduce<<<grid(32 * outs, 65536), kPrepThreads, 0, s>>>(
      scratch + S.partials, dw1, db1, dw2, db2, dw3, db3, K, H1, H2, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  din_backward_dq<<<grid(static_cast<long long>(batch) * K, 65536), kPrepThreads, 0, s>>>(
      scratch + S.e, dq, batch, T, K);
  return cudaGetLastError();
}

extern "C" long long din_attention_backward_scratch(int batch, int T, int K, int H1, int H2) {
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0 || !tile_takes(T, K, H1, H2)) {
    return -1;
  }
  int device = 0;
  long long blocks = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (tile_launch(device, batch, T, blocks) != cudaSuccess) return -1;
  const BackPlan L = tile_sums(blocks);
  return L.blocks * L.acc;
}

extern "C" int din_attention_backward(const float* query, const float* keys, const float* mask,
                                      const float* w1, const float* b1, const float* w2,
                                      const float* b2, const float* w3, const float* b3,
                                      const float* weights, const float* grad, float* dq,
                                      float* dkeys, float* dw1, float* db1, float* dw2,
                                      float* db2, float* dw3, float* db3, float* scratch,
                                      int batch, int T, int K, int H1, int H2, int relu,
                                      int softmax, int scores, void* stream) {
  (void)b3;  // the softmax's shift: no gradient flows through it but db3
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0 || !tile_takes(T, K, H1, H2)) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  long long blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = tile_launch(device, batch, T, blocks);
  if (err != cudaSuccess) return err;
  const BackPlan L = tile_sums(blocks);
  // scratch: the warpgroups' partials
  float* partials = scratch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  din_backward_tile_kernel<<<static_cast<int>(blocks), kTThreads, kTSmemBytes, s>>>(
      query, keys, mask, w1, b1, w2, b2, w3, weights, grad, dq, dkeys, partials, L, batch, T, K,
      H1, H2, relu != 0, softmax != 0, scores == 0, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long outs = 4LL * K * H1 + H1 + static_cast<long long>(H1) * H2 + 2LL * H2 + 1;
  const long long red_blocks = (32 * outs + kPrepThreads - 1) / kPrepThreads;
  din_backward_reduce<<<static_cast<int>(red_blocks < 65536 ? red_blocks : 65536), kPrepThreads,
                        0, s>>>(partials, dw1, db1, dw2, db2, dw3, db3, K, H1, H2, L);
  return cudaGetLastError();
}

extern "C" long long din_attention_wide_backward_scratch(int batch, int T, int K, int H1, int H2) {
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0 || !wide_takes(T, K, H1, H2)) {
    return -1;
  }
  const int slot = wide_slot(K);
  int device = 0;
  long long blocks = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (wide_launch(device, batch, slot, blocks) != cudaSuccess) return -1;
  const BackPlan L = wide_sums(slot, blocks);
  return wide_pack(kWideK[slot]).total + L.blocks * L.acc + static_cast<long long>(batch) * H1;
}

extern "C" int din_attention_wide_backward(const float* query, const float* keys, const float* mask,
                                           const float* w1, const float* b1, const float* w2,
                                           const float* b2, const float* w3, const float* b3,
                                           const float* weights, const float* grad, float* dq,
                                           float* dkeys, float* dw1, float* db1, float* dw2,
                                           float* db2, float* dw3, float* db3, float* scratch,
                                           int batch, int T, int K, int H1, int H2, int relu,
                                           int softmax, int scores, void* stream) {
  (void)b3;  // the softmax's shift: no gradient flows through it but db3
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0 || !wide_takes(T, K, H1, H2)) {
    return cudaErrorInvalidValue;
  }
  const int slot = wide_slot(K);
  const int KT = kWideK[slot];
  int device = 0;
  long long blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = wide_launch(device, batch, slot, blocks);
  if (err != cudaSuccess) return err;
  const BackPlan L = wide_sums(slot, blocks);
  // scratch: the packed weights, the teams' partials, the rows' terms
  const WidePack P = wide_pack(KT);
  float* packed = scratch;
  float* partials = scratch + P.total;
  float* terms = partials + L.blocks * L.acc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kPackBlocks = 64;
  const long long prep_blocks = kPackBlocks + (static_cast<long long>(batch) + kTermRows - 1) /
                                                  kTermRows;
  din_backward_wide_pack<<<static_cast<int>(prep_blocks), kTermCols, 0, s>>>(
      w1, b1, w2, b2, w3, query, packed, terms, batch, K, H1, H2, KT, kPackBlocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dkeys) % 16 == 0;
  kWideKernels[slot]<<<static_cast<int>(blocks), kWThreads, kWideBytes[slot], s>>>(
      query, keys, mask, weights, grad, packed, terms, dq, dkeys, partials, L, batch, T, K,
      H1, relu != 0, softmax != 0, scores == 0, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long outs = 4LL * K * H1 + H1 + static_cast<long long>(H1) * H2 + 2LL * H2 + 1;
  const long long red_blocks = (32 * outs + kPrepThreads - 1) / kPrepThreads;
  din_backward_reduce<<<static_cast<int>(red_blocks < 65536 ? red_blocks : 65536), kPrepThreads,
                        0, s>>>(partials, dw1, db1, dw2, db2, dw3, db3, K, H1, H2, L);
  return cudaGetLastError();
}
