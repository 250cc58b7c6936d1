// attn_block.cu — flash partials for one K/V block, on Hopper's tensor cores.
//
// Replaces the TPU kernel vtpu_manager/workloads/pallas_attention.py:28
// _attn_block_kernel (launched by attention_block:57, pl.pallas_call at :84).
// For q [B,H,Sq,D], k and v [B,H,Sk,D] and an additive bias [Sq,Sk] of 0 or
// -inf shared by every (b, h), it returns, per query row,
//   s = q.k^T * D^-1/2 + bias,  m = max_j s,  p = exp(s - m) (0 where s or
//   m is -inf),  o = p.v (unnormalised),  l = sum_j p,
// the triple ring_attention.merge_partials and combine_blocks consume.
//
// Bound on this card (H100 SXM, at the probe's shape 8 x 16 x 512 x 128,
// fp32): 4*B*H*Sq*Sk*D = 17.2 GFLOP and 135.8 MB moved (q, k, v, o, the
// bias, m and l, each once). At 3.35 TB/s the bytes take 0.041 ms; at the
// 494.7 TFLOP/s dense TF32 peak the operations take 0.035 ms, so the card's
// floor is 0.041 ms, set by bytes. This design does each product three
// times (split TF32, below), so its own floor is 3 x 0.035 = 0.104 ms.
//
// Accuracy: split TF32. A TF32 operand keeps 10 mantissa bits; one pass
// puts ~1e-3 of error into a score at D = 128, ten times the 1e-4 the
// partials are held to. So every fp32 operand x is split into two TF32
// values and each product is taken as big.small + small.big + big.big,
// accumulated in fp32 by the tensor cores: about fp32 accuracy for three
// mma instructions. big is x rounded to nearest, ties away, at 10 bits (what
// cvt.rna.tf32.f32 gives) by an integer add and mask; small = x - big is
// exact in fp32 and is handed to the mma as it is, which reads the top 19
// bits (truncation, 2^-21 of x). cvt.rna.tf32.f32 itself compiles to four
// instructions per value (its Inf/NaN guard), this to three per split. bf16
// inputs are exact in TF32 (small = 0): that instantiation takes one
// product for q.k^T and splits only p.
//
// Design. A block of 8 warps owns BLOCK_M = 128 query rows of one (b, h),
// 16 per warp: grid (ceil(Sq/128), B*H). Products are
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32; the scores of a 64-key tile
// (a 16 x 64 warp tile, 32 fp32 per thread), the running max and sum and
// the o accumulator (16 x D per warp, 64 fp32 per thread at D = 128) stay in
// registers, and p is split straight from the score accumulators into the
// A operand of p.v. Two permutations make every shared-memory fragment
// load a 16-byte (fp32) or 8-byte (bf16) access with no shuffles:
// - the contraction index of q.k^T: within each 16-wide slice of D, thread
//   t of a quad takes d = 4t..4t+3, so its k-steps 2i and 2i+1 read one
//   float4 of k (the same permutation on q's side);
// - the key index of p.v: A column t of k-step j is key 8j+2t and column
//   t+4 is key 8j+2t+1, which is where the score accumulator already holds
//   them, and V's B fragment reads those two rows; the output columns of
//   n-tile 4c+e are 32c+4g+e, so thread g reads one float4 of a V row and
//   writes o as two float4s per row and 32-column chunk.
// Each thread stages its own Q fragments once, in fragment order (one
// float4 per k-step). K and V tiles of 64 rows go through two shared-memory
// stages by cp.async (16-byte copies, commit/wait groups): tile j+1 lands
// while tile j is multiplied. Where d * sizeof(T) is not a multiple of 16
// or a pointer is not 16-byte aligned, the same kernel copies 4-byte
// elements (fp32) or plain bf16 elements instead. D is zero-padded to
// kD = 32, 64, 96 or 128, a template parameter, so every 1 <= d <= 128 is
// taken and every shared-memory offset is a constant. K and V rows are
// padded (+16 elements; +16 bytes) so that each fragment load hits every
// bank once per phase.
//
// Why 8 warps and 128 rows: with 4 warps and 64 rows (one warp per
// scheduler) a warp issues about one instruction in three cycles: the
// latencies of the shared loads, the splits and the mma chains are
// exposed. Two warps per scheduler hide more of them, and the 8 warps
// share each K/V tile. The cross terms of q.k^T go to their own
// accumulators, so a warp keeps 16 independent mma chains in flight in
// both products. One barrier a tile. Shared memory per block at kD = 128:
// fp32 206,848 B (Q 65,536; K and V, two stages, 141,312), bf16 137,216 B:
// one block per SM. Registers (ptxas, sm_90a): 244 for fp32 at kD = 128,
// no spills.
//
// What bounds it: the mma.sync stream. mma.sync TF32 alone reaches
// 307-312 TFLOP/s on an H100 SXM at 700 W (csrc/mma_peak.cu, timed by
// chip_smoke.py), not the 494.7 that wgmma reaches, so the three products
// need 0.165-0.168 ms at best; this kernel runs them at about half that
// rate (0.35 ms at the probe's shape; PERF.md has the runs).
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands only K-major from
// shared memory, so V (row-major, the p.v B operand, N-major) would have to
// be transposed in shared memory first, and the asynchronous warpgroup
// pipeline wants TMA and a producer warp around it. That is the next
// redesign; this one keeps one kernel launch per call and plain cp.async.
//
// Masking. A tile whose scores are all -inf while the row's running max is
// still -inf changes nothing; a row masked throughout ends with m = -inf,
// l = 0, o = 0, as the TPU kernel gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per tile
constexpr int kStages = 2;
constexpr int kMaxD = 128;
constexpr int kScoreTiles = kBlockN / 8;  // n-tiles of q.k^T, k-steps of p.v
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim padded to kD (a multiple of 32).
template <typename T, int kD>
struct Tiles {
  static constexpr bool kSplitInputs = std::is_same<T, float>::value;
  static constexpr int kQkSlices = kD / 16;  // pairs of q.k^T k-steps
  static constexpr int kPvChunks = kD / 32;  // 32-column chunks of p.v
  static constexpr int kKStride = kD + 16;   // elements
  static constexpr int kVStride = kD + 16 / (int)sizeof(T);
  static constexpr int kQFloats = kBlockM * kD;
  static constexpr int kKElems = kBlockN * kKStride;
  static constexpr int kVElems = kBlockN * kVStride;
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)kQFloats +
      sizeof(T) * (size_t)kStages * (kKElems + kVElems);
};

__device__ __forceinline__ float ToFloat(float x) { return x; }
__device__ __forceinline__ float ToFloat(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements of a shared array, as fp32.
__device__ __forceinline__ float4 Load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 Load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// x = big + small, both read by the mma as TF32 (it ignores the low 13
// bits): big rounds x to nearest, ties away; x - big is exact. Finite x
// (a NaN stays a NaN in small). Without a split (bf16 inputs, already TF32)
// small stays unused.
template <bool kSplit>
__device__ __forceinline__ void Split(float x, uint32_t& big,
                                      uint32_t& small) {
  if (kSplit) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
  }
}

// 2^x by MUFU.EX2, within a few ulp: far inside the 1e-4 p is held to.
__device__ __forceinline__ float Exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a.b on one m16n8k8 tile.
__device__ __forceinline__ void Mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b for p.v: a (p) split, b (v) split unless the inputs are bf16;
// the small terms first, then big.big.
template <bool kSplitB>
__device__ __forceinline__ void Mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  if (kSplitB) Mma(c, a_big, b_small[0], b_small[1]);
  Mma(c, a_small, b_big[0], b_big[1]);
  Mma(c, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ uint32_t SmemAddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void CpAsync16(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   SmemAddr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void CpAsync4(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   SmemAddr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void CpAsyncCommit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void CpAsyncWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Starts copying rows [row0, row0 + kBlockN) of a [n_rows, d] matrix into a
// shared tile with kStride elements a row; rows past the end are zeros.
// Columns from d on are not touched (ZeroPads clears them once).
template <typename T, int kStride>
__device__ __forceinline__ void LoadTileAsync(T* tile, const T* src, int row0,
                                              int n_rows, int d, bool wide) {
  if (wide) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = d / kPer;
    for (int i = threadIdx.x; i < kBlockN * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * kPer;
      const bool ok = row0 + r < n_rows;
      CpAsync16(tile + r * kStride + c,
                src + (size_t)(ok ? row0 + r : 0) * d + c, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBlockN * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const bool ok = row0 + r < n_rows;
      const T* from = src + (size_t)(ok ? row0 + r : 0) * d + c;
      if constexpr (sizeof(T) == 4)
        CpAsync4(tile + r * kStride + c, from, ok ? 4 : 0);
      else  // no 2-byte cp.async: a plain copy, seen after the barrier
        tile[r * kStride + c] = ok ? *from : T(0.f);
    }
  }
}

template <typename T, int kStride>
__device__ __forceinline__ void ZeroPads(T* tile, int from, int to) {
  const int w = to - from;
  for (int i = threadIdx.x; i < kBlockN * w; i += kThreads) {
    const int r = i / w;
    tile[r * kStride + from + (i - r * w)] = T(0.f);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
    AttnBlockKernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int sq, int sk, int d,
                    float scale, bool wide) {
  using L = Tiles<T, kD>;
  constexpr bool kSplit = L::kSplitInputs;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* q_frags = reinterpret_cast<float4*>(smem);
  T* k_tiles = reinterpret_cast<T*>(smem + sizeof(float) * L::kQFloats);
  T* v_tiles = k_tiles + kStages * L::kKElems;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row (and B column) in the tile
  const int t = lane % 4;  // thread in the quad
  const T* k_bh = k + (size_t)bh * sk * d;
  const T* v_bh = v + (size_t)bh * sk * d;
  const int n_tiles = (sk + kBlockN - 1) / kBlockN;

  // tile 0 starts landing while Q is staged
  LoadTileAsync<T, L::kKStride>(k_tiles, k_bh, 0, sk, d, wide);
  LoadTileAsync<T, L::kVStride>(v_tiles, v_bh, 0, sk, d, wide);
  CpAsyncCommit();
  for (int st = 0; st < kStages; st++) {
    ZeroPads<T, L::kKStride>(k_tiles + st * L::kKElems, d, kD);
    ZeroPads<T, L::kVStride>(v_tiles + st * L::kVElems, d, kD);
  }

  // rows g and g+8 of this warp's 16
  const int row0 = q0 + 16 * warp + g;
  const int row1 = row0 + 8;
  // this thread's Q fragments, in the order the k-steps read them: k-step
  // 2i+h takes d = 16i+4t+2h (A column t) and +1 (column t+4)
  float4* my_q = q_frags + warp * (2 * L::kQkSlices * 32) + lane;
  {
    const T* q_r0 = q + ((size_t)bh * sq + row0) * d;
    const T* q_r1 = q_r0 + 8 * (size_t)d;
#pragma unroll
    for (int i = 0; i < L::kQkSlices; i++)
#pragma unroll
      for (int h = 0; h < 2; h++) {
        float x[2][2];
#pragma unroll
        for (int e = 0; e < 2; e++) {
          const int col = 16 * i + 4 * t + 2 * h + e;
          x[0][e] = row0 < sq && col < d ? ToFloat(q_r0[col]) : 0.f;
          x[1][e] = row1 < sq && col < d ? ToFloat(q_r1[col]) : 0.f;
        }
        my_q[(2 * i + h) * 32] = make_float4(x[0][0], x[1][0], x[0][1],
                                             x[1][1]);
      }
  }

  // acc[4c+e] is the n-tile whose B column g' is output column 32c+4g'+e,
  // so this thread holds output columns 32c+8t+e (c0, c2) and 32c+8t+4+e
  // (c1, c3)
  float acc[4 * L::kPvChunks][4];
#pragma unroll
  for (int j = 0; j < 4 * L::kPvChunks; j++)
#pragma unroll
    for (int e = 0; e < 4; e++) acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this thread's columns; summed at the end

  for (int tile = 0; tile < n_tiles; tile++) {
    const int k0 = tile * kBlockN;
    const T* k_tile = k_tiles + (tile % kStages) * L::kKElems;
    const T* v_tile = v_tiles + (tile % kStages) * L::kVElems;
    // one barrier a tile: after it, this tile has landed for every thread
    // and every warp is done with the last one, whose stage the next tile
    // then refills while this one is multiplied
    CpAsyncWait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) {
      const int st = (tile + 1) % kStages;
      LoadTileAsync<T, L::kKStride>(k_tiles + st * L::kKElems, k_bh,
                                    k0 + kBlockN, sk, d, wide);
      LoadTileAsync<T, L::kVStride>(v_tiles + st * L::kVElems, v_bh,
                                    k0 + kBlockN, sk, d, wide);
    }
    CpAsyncCommit();

    // the bias of this thread's scores, in flight during q.k^T
    float s_bias[kScoreTiles][4];
#pragma unroll
    for (int j = 0; j < kScoreTiles; j++)
#pragma unroll
      for (int e = 0; e < 4; e++) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        s_bias[j][e] = (row < sq && col < sk)
                           ? __ldg(bias + (size_t)row * sk + col)
                           : -INFINITY;
      }

    // s = q.k^T on this warp's 16 rows and the tile's 64 keys: big.big
    // into s, the two cross terms into sx, so 16 accumulator chains (not 8)
    // hide the mma latency
    float s[kScoreTiles][4], sx[kScoreTiles][4];
#pragma unroll
    for (int j = 0; j < kScoreTiles; j++)
#pragma unroll
      for (int e = 0; e < 4; e++) s[j][e] = sx[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kQkSlices; i++) {
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int h = 0; h < 2; h++) {
        const float4 qa = my_q[(2 * i + h) * 32];
        Split<kSplit>(qa.x, a_big[h][0], a_small[h][0]);
        Split<kSplit>(qa.y, a_big[h][1], a_small[h][1]);
        Split<kSplit>(qa.z, a_big[h][2], a_small[h][2]);
        Split<kSplit>(qa.w, a_big[h][3], a_small[h][3]);
      }
#pragma unroll
      for (int j = 0; j < kScoreTiles; j++) {
        const float4 kv =
            Load4(k_tile + (8 * j + g) * L::kKStride + 16 * i + 4 * t);
        uint32_t kb[2][2], ks[2][2];
        Split<kSplit>(kv.x, kb[0][0], ks[0][0]);
        Split<kSplit>(kv.y, kb[0][1], ks[0][1]);
        Split<kSplit>(kv.z, kb[1][0], ks[1][0]);
        Split<kSplit>(kv.w, kb[1][1], ks[1][1]);
        if (kSplit) {
          Mma(sx[j], a_big[0], ks[0][0], ks[0][1]);
          Mma(sx[j], a_small[0], kb[0][0], kb[0][1]);
          Mma(sx[j], a_big[1], ks[1][0], ks[1][1]);
          Mma(sx[j], a_small[1], kb[1][0], kb[1][1]);
        }
        Mma(s[j], a_big[0], kb[0][0], kb[0][1]);
        Mma(s[j], a_big[1], kb[1][0], kb[1][1]);
      }
    }

    // online softmax; the four threads of a quad share rows g and g+8
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kScoreTiles; j++)
#pragma unroll
      for (int e = 0; e < 4; e++) {
        s[j][e] = fmaf(s[j][e] + sx[j][e], scale, s_bias[j][e]);
        tile_max[e / 2] = fmaxf(tile_max[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; r++) {
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_run[r], tile_max[r]);
      // while m_run is -inf, acc and l are still 0: alpha 0 changes nothing
      alpha[r] = m_run[r] == -INFINITY ? 0.f
                                       : Exp2((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kScoreTiles; j++)
#pragma unroll
      for (int e = 0; e < 4; e++) {
        const float x = s[j][e];
        const float p =
            x == -INFINITY ? 0.f : Exp2((x - m_run[e / 2]) * kLog2e);
        s[j][e] = p;
        l_part[e / 2] += p;
      }
#pragma unroll
    for (int j = 0; j < 4 * L::kPvChunks; j++)
#pragma unroll
      for (int e = 0; e < 4; e++) acc[j][e] *= alpha[e / 2];

    // acc += p.v: k-step j covers keys 8j + {2t, 2t+1}, held in s[j]
#pragma unroll
    for (int j = 0; j < kScoreTiles; j++) {
      uint32_t pb[4], ps[4];
      Split<true>(s[j][0], pb[0], ps[0]);  // row g,   key 2t
      Split<true>(s[j][2], pb[1], ps[1]);  // row g+8, key 2t
      Split<true>(s[j][1], pb[2], ps[2]);  // row g,   key 2t+1
      Split<true>(s[j][3], pb[3], ps[3]);  // row g+8, key 2t+1
      const T* v_row = v_tile + (8 * j + 2 * t) * L::kVStride + 4 * g;
#pragma unroll
      for (int c = 0; c < L::kPvChunks; c++) {
        const float4 x0 = Load4(v_row + 32 * c);
        const float4 x1 = Load4(v_row + L::kVStride + 32 * c);
        const float f0[4] = {x0.x, x0.y, x0.z, x0.w};
        const float f1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int e = 0; e < 4; e++) {
          uint32_t vb[2], vs[2];
          Split<kSplit>(f0[e], vb[0], vs[0]);
          Split<kSplit>(f1[e], vb[1], vs[1]);
          Mma3<kSplit>(acc[4 * c + e], pb, ps, vb, vs);
        }
      }
    }
  }

  const bool vec_out = d % 4 == 0;
#pragma unroll
  for (int r = 0; r < 2; r++) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r == 0 ? row0 : row1;
    if (row >= sq) continue;
    const size_t base = (size_t)bh * sq + row;
    float* o_row = o + base * d;
#pragma unroll
    for (int c = 0; c < L::kPvChunks; c++)
#pragma unroll
      for (int half = 0; half < 2; half++) {  // columns +0..3 and +4..7
        const int col = 32 * c + 8 * t + 4 * half;
        const float vals[4] = {
            acc[4 * c + 0][2 * r + half], acc[4 * c + 1][2 * r + half],
            acc[4 * c + 2][2 * r + half], acc[4 * c + 3][2 * r + half]};
        if (vec_out) {
          if (col < d)
            *reinterpret_cast<float4*>(o_row + col) =
                make_float4(vals[0], vals[1], vals[2], vals[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; e++)
            if (col + e < d) o_row[col + e] = vals[e];
        }
      }
    if (t == 0) {
      m_out[base] = m_run[r];
      l_out[base] = l;
    }
  }
}

// The kernel's dynamic shared memory is allowed once on each device (the
// attribute is per device, not per process).
template <typename T, int kD>
cudaError_t AllowSharedMemory() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(AttnBlockKernel<T, kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tiles<T, kD>::kBytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int kD>
int Launch(const void* q, const void* k, const void* v, const float* bias,
           float* o, float* m, float* l, int bh, int sq, int sk, int d,
           float scale, cudaStream_t stream) {
  cudaError_t err = AllowSharedMemory<T, kD>();
  if (err != cudaSuccess) return (int)err;
  const bool wide =
      (d * sizeof(T)) % 16 == 0 &&
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  AttnBlockKernel<T, kD><<<grid, kThreads, Tiles<T, kD>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, o, m, l, sq, sk, d, scale, wide);
  return (int)cudaGetLastError();
}

template <typename T>
int LaunchPadded(const void* q, const void* k, const void* v,
                 const float* bias, float* o, float* m, float* l, int bh,
                 int sq, int sk, int d, float scale, cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1:
      return Launch<T, 32>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                           stream);
    case 2:
      return Launch<T, 64>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                           stream);
    case 3:
      return Launch<T, 96>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                           stream);
    default:
      return Launch<T, kMaxD>(q, k, v, bias, o, m, l, bh, sq, sk, d, scale,
                              stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). Returns the
// cudaError_t of the launch; 0 is success. Shapes are checked by the caller.
extern "C" int attn_block_forward(const void* q, const void* k, const void* v,
                                  const float* bias, float* o, float* m,
                                  float* l, int batch_heads, int sq, int sk,
                                  int d, float scale, int dtype,
                                  void* stream) {
  if (d < 1 || d > kMaxD || sq < 1 || sk < 1 || batch_heads < 1 ||
      batch_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return LaunchPadded<float>(q, k, v, bias, o, m, l, batch_heads, sq, sk,
                               d, scale, s);
  if (dtype == 1)
    return LaunchPadded<__nv_bfloat16>(q, k, v, bias, o, m, l, batch_heads,
                                       sq, sk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
