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
// a group: K=128 at T=50, K=32 past T=514, K=64 past T=185). A block takes
// one batch row at a time; each warp scores kGlobalPos = 8 positions at
// once in f32 on the CUDA cores, lane j taking columns j, j+32, ... of each
// layer with the weights read from global memory through L1 and L2 (a
// weight load serves the 8 positions), [k | q*k] and the first layer's
// output held in the warp's slice of shared memory, position-minor, so
// that two 16-byte loads give a column's 8 positions. The first layer is
// folded as in the tiled kernel, Wk - Wm and Wq + Wm formed as the weights
// are read; the mask, the softmax and the pooling are the tiled kernel's.
// Its shared memory grows with K, H1 and T, not with the weights: 4*(K +
// H1 + T) bytes a block and 4*8*(2K + H1) a warp, each part rounded up to
// 4 floats; it takes every shape where one warp's fits in 227 KB. Staging
// the folded first layer in shared memory once a block, where it fits,
// gained no more than the spread between runs (PERF.md), so it is not
// kept.
//
// C interface, loaded with ctypes: din_attention_forward (the tiled kernel)
// and din_attention_global_forward (the global kernel) return
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for sizes
// their kernels do not take; the Python wrapper checks shapes, types and
// devices first and picks the entry point (ops/kernels.py
// din_kernel_takes).
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

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
                     const float* __restrict__ b3, float* __restrict__ out, int batch, int T,
                     int K, int H1, int H2, Layout L, bool relu, bool softmax, bool scores,
                     bool vec) {
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
constexpr int kGlobalPos = 8;    // positions a warp scores at once
constexpr int kGlobalWarps = 8;  // the most warps a block

// Shared memory of the global kernel, offsets in floats, 16-byte aligned:
// per block q [K], a = q (Wq + Wm) [H1] and the scores [T]; per warp
// [k | q*k] as [2K][kGlobalPos] and the first layer's output as
// [H1][kGlobalPos].
struct GlobalLayout {
  int q, a, score, warp0, h1, per_warp, total;
};

GlobalLayout make_global_layout(int T, int K, int H1, int warps) {
  GlobalLayout G;
  G.q = 0;
  G.a = G.q + round_up(K, 4);
  G.score = G.a + round_up(H1, 4);
  G.warp0 = G.score + round_up(T, 4);
  G.h1 = 2 * K * kGlobalPos;  // within a warp's slice
  G.per_warp = G.h1 + H1 * kGlobalPos;
  G.total = G.warp0 + warps * G.per_warp;
  return G;
}

__global__ void __launch_bounds__(kGlobalWarps * 32)
din_attention_global_kernel(const float* __restrict__ query, const float* __restrict__ keys,
                            const float* __restrict__ mask, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2, const float* __restrict__ w3,
                            const float* __restrict__ b3, float* __restrict__ out,
                            int batch, int T, int K, int H1, int H2, GlobalLayout G,
                            bool relu, bool softmax, bool scores) {
  constexpr int P = kGlobalPos;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem + G.q;
  float* a_s = smem + G.a;
  float* score_s = smem + G.score;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  float* ck = smem + G.warp0 + warp * G.per_warp;  // [2K][P]
  float* h1 = ck + G.h1;                           // [H1][P]
  const float bias3 = b3[0];
  const int groups = (T + P - 1) / P;

  for (long long row = blockIdx.x; row < batch; row += gridDim.x) {
    for (int i = tid; i < K; i += threads) q_s[i] = query[row * K + i];
    __syncthreads();
    for (int j = tid; j < H1; j += threads) {
      float s = 0.f;
      for (int k = 0; k < K; ++k)
        s = fmaf(q_s[k], __fadd_rn(w1[k * H1 + j], w1[(2 * K + k) * H1 + j]), s);
      a_s[j] = s;
    }
    __syncthreads();

    const float* krow = keys + row * T * K;
    // a group of P positions a warp; the whole warp shares a group
    for (int g = warp; g < groups; g += warps) {
      const int t0 = g * P;
      for (int i = lane; i < P * K; i += 32) {
        const int p = i / K;
        const int c = i - p * K;
        const float kv = t0 + p < T ? krow[static_cast<long long>(t0 + p) * K + c] : 0.f;
        ck[c * P + p] = kv;
        ck[(K + c) * P + p] = __fmul_rn(q_s[c], kv);
      }
      __syncwarp();
      // layer 1: lane j takes columns j, j + 32, ... for the P positions
      for (int j = lane; j < H1; j += 32) {
        float acc[P];
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = 0.f;
#pragma unroll 4
        for (int c = 0; c < 2 * K; ++c) {
          const float w = c < K ? __fsub_rn(__ldg(w1 + (K + c) * H1 + j),
                                            __ldg(w1 + (2 * K + c) * H1 + j))
                                : __ldg(w1 + (2 * K + c) * H1 + j);
          const float4 lo = *reinterpret_cast<const float4*>(ck + c * P);
          const float4 hi = *reinterpret_cast<const float4*>(ck + c * P + 4);
          acc[0] = fmaf(lo.x, w, acc[0]);
          acc[1] = fmaf(lo.y, w, acc[1]);
          acc[2] = fmaf(lo.z, w, acc[2]);
          acc[3] = fmaf(lo.w, w, acc[3]);
          acc[4] = fmaf(hi.x, w, acc[4]);
          acc[5] = fmaf(hi.y, w, acc[5]);
          acc[6] = fmaf(hi.z, w, acc[6]);
          acc[7] = fmaf(hi.w, w, acc[7]);
        }
        const float aj = a_s[j];
        const float bj = __ldg(b1 + j);
#pragma unroll
        for (int p = 0; p < P; ++p) h1[j * P + p] = act((aj + acc[p]) + bj, relu);
      }
      __syncwarp();
      // layer 2, its activation and the dot with w3: lane n takes columns
      // n, n + 32, ...
      float part[P];
#pragma unroll
      for (int p = 0; p < P; ++p) part[p] = 0.f;
      for (int n = lane; n < H2; n += 32) {
        float z[P];
#pragma unroll
        for (int p = 0; p < P; ++p) z[p] = 0.f;
#pragma unroll 4
        for (int j = 0; j < H1; ++j) {
          const float w = __ldg(w2 + j * H2 + n);
          const float4 lo = *reinterpret_cast<const float4*>(h1 + j * P);
          const float4 hi = *reinterpret_cast<const float4*>(h1 + j * P + 4);
          z[0] = fmaf(lo.x, w, z[0]);
          z[1] = fmaf(lo.y, w, z[1]);
          z[2] = fmaf(lo.z, w, z[2]);
          z[3] = fmaf(lo.w, w, z[3]);
          z[4] = fmaf(hi.x, w, z[4]);
          z[5] = fmaf(hi.y, w, z[5]);
          z[6] = fmaf(hi.z, w, z[6]);
          z[7] = fmaf(hi.w, w, z[7]);
        }
        const float bn = __ldg(b2 + n);
        const float wn = __ldg(w3 + n);
#pragma unroll
        for (int p = 0; p < P; ++p) part[p] = fmaf(act(z[p] + bn, relu), wn, part[p]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) part[p] = warp_sum(part[p]);
      if (lane == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (t0 + p < T) score_s[t0 + p] = part[p] + bias3;
      }
      __syncwarp();  // ck and h1 are rewritten by the warp's next group
    }
    __syncthreads();

    // mask and softmax: one warp, as the tiled kernel does
    if (warp == 0) {
      const float* m = mask + row * T;
      if (softmax) {
        float mx = -INFINITY;
        for (int t = lane; t < T; t += 32) {
          const float v = m[t] > 0.5f ? score_s[t] : kNegInf;
          score_s[t] = v;
          mx = fmaxf(mx, v);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int t = lane; t < T; t += 32) {
          const float e = expf(score_s[t] - mx);
          score_s[t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int t = lane; t < T; t += 32) score_s[t] = score_s[t] / sum;
      } else {
        for (int t = lane; t < T; t += 32) score_s[t] = m[t] > 0.5f ? score_s[t] : 0.f;
      }
    }
    __syncthreads();
    if (scores) {
      for (int t = tid; t < T; t += threads) out[row * T + t] = score_s[t];
    } else {
      for (int k = tid; k < K; k += threads) {
        // four sums in flight, added at the end
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        int t = 0;
        for (; t + 4 <= T; t += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            p[u] = fmaf(score_s[t + u], krow[static_cast<long long>(t + u) * K + k], p[u]);
        }
        for (; t < T; ++t) p[0] = fmaf(score_s[t], krow[static_cast<long long>(t) * K + k], p[0]);
        out[row * K + k] = (p[0] + p[1]) + (p[2] + p[3]);
      }
    }
    __syncthreads();  // q, a and the scores are rewritten for the next row
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*,
                        const float*, float*, int, int, int, int, int, Layout, bool, bool,
                        bool, bool);

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

}  // namespace

extern "C" int din_attention_forward(const float* query, const float* keys,
                                     const float* mask, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, const float* w3,
                                     const float* b3, float* out, int batch, int T,
                                     int K, int H1, int H2, int relu, int softmax,
                                     int scores, void* stream) {
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
      query, keys, mask, w1, b1, w2, b2, w3, b3, out, batch, T, K, H1, H2, L, relu != 0,
      softmax != 0, scores != 0, vec);
  return cudaGetLastError();
}

extern "C" int din_attention_global_forward(const float* query, const float* keys,
                                            const float* mask, const float* w1,
                                            const float* b1, const float* w2,
                                            const float* b2, const float* w3,
                                            const float* b3, float* out, int batch, int T,
                                            int K, int H1, int H2, int relu, int softmax,
                                            int scores, void* stream) {
  if (batch <= 0 || T <= 0 || K <= 0 || H1 <= 0 || H2 <= 0) return cudaErrorInvalidValue;
  // as many warps as the shared memory holds, up to one a group of positions
  const int groups = (T + kGlobalPos - 1) / kGlobalPos;
  int warps = groups < kGlobalWarps ? groups : kGlobalWarps;
  while (warps > 0 &&
         sizeof(float) * static_cast<size_t>(make_global_layout(T, K, H1, warps).total) >
             kMaxSharedBytes) {
    --warps;
  }
  if (warps == 0) return cudaErrorInvalidValue;
  const GlobalLayout G = make_global_layout(T, K, H1, warps);
  const size_t smem = sizeof(float) * G.total;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(din_attention_global_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_attention_global_kernel,
                                                        warps * 32, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > batch) blocks = batch;
  din_attention_global_kernel<<<static_cast<int>(blocks), warps * 32, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      query, keys, mask, w1, b1, w2, b2, w3, b3, out, batch, T, K, H1, H2, G, relu != 0,
      softmax != 0, scores != 0);
  return cudaGetLastError();
}
