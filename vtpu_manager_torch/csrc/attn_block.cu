// attn_block.cu — flash partials for one K/V block, for Hopper (sm_90a).
//
// Replaces the TPU kernel vtpu_manager/workloads/pallas_attention.py:28
// _attn_block_kernel (launched by attention_block:57, pl.pallas_call at :84).
// For q [B,H,Sq,D], k and v [B,H,Sk,D] and an additive bias [Sq,Sk] of 0 or
// -inf shared by every (b, h), it returns, per query row,
//   s = q.k^T * D^-1/2 + bias,  m = max_j s,  p = exp(s - m) (0 where s or
//   m is -inf),  o = p.v (unnormalised),  l = sum_j p,
// the triple ring_attention.merge_partials and combine_blocks consume.
//
// Design. The TPU program held one whole [S, D] tile per (b, h) in VMEM on
// a sequential (B, H) grid. Here a block of 128 threads owns BLOCK_M = 32
// query rows of one (b, h): grid (ceil(Sq/32), B*H). It stages its Q tile in
// shared memory once, then walks Sk in BLOCK_N = 32 key tiles, keeping a
// running max and sum per row (online softmax) in fp32 registers, so the
// scores never leave the SM and no tile larger than 32 x D is held. At the
// end o is written relative to the final m, which is what the TPU kernel
// wrote, so the partials merge unchanged. Thread (ty, tx) = (t / 8, t % 8)
// owns rows 2ty and 2ty+1; for the scores it owns key columns tx + 8c, for
// the output head columns tx + 8e. Shared rows are padded by 4 floats so the
// eight rows a warp reads at one d fall in eight banks.
//
// Masking. A tile whose scores are all -inf while the row's running max is
// still -inf changes nothing (no exp(-inf - -inf)); a row masked throughout
// ends with m = -inf, l = 0, o = 0, as the TPU kernel gives.
//
// Bound on this card (H100 SXM, at the capture's shape 8 x 16 x 512 x 128,
// fp32): 4*B*H*Sq*Sk*D = 17.2 GFLOP and about 136 MB moved (q, k, v, o and
// the bias; m and l). Memory floor 41 us at 3.35 TB/s; tensor-core (TF32)
// floor 35 us at 495 TFLOP/s; this kernel's arithmetic is plain fp32 FMA on
// the CUDA cores, whose floor is 256 us at 67 TFLOP/s. It is operation
// bound; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockM = 32;
constexpr int kBlockN = 32;
constexpr int kThreads = 128;
constexpr int kMaxD = 128;
constexpr int kColsPerThread = kBlockN / 8;  // 4 score columns
constexpr int kOutPerThread = kMaxD / 8;     // 16 output columns
static_assert(kBlockM == kBlockN, "LoadTile stages 32-row tiles of both");

__device__ __forceinline__ float ToFloat(float x) { return x; }
__device__ __forceinline__ float ToFloat(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool IsNegInf(float x) {
  return isinf(x) && x < 0.f;
}

// Copies rows [row0, row0 + rows) of a [n_rows, D] matrix into a shared
// tile with row stride `stride`, as fp32; rows past the end are zero.
template <typename T>
__device__ void LoadTile(float* tile, const T* src, int row0, int n_rows,
                         int d, int stride) {
  for (int i = threadIdx.x; i < kBlockN * d; i += kThreads) {
    int r = i / d;
    int c = i - r * d;
    int row = row0 + r;
    tile[r * stride + c] =
        row < n_rows ? ToFloat(src[(size_t)row * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    AttnBlockKernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int sq, int sk, int d,
                    float scale) {
  extern __shared__ float smem[];
  const int stride = d + 4;
  float* q_tile = smem;
  float* k_tile = q_tile + kBlockM * stride;
  float* v_tile = k_tile + kBlockN * stride;
  float* p_tile = v_tile + kBlockN * stride;  // [kBlockM][kBlockN + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const T* q_bh = q + (size_t)bh * sq * d;
  const T* k_bh = k + (size_t)bh * sk * d;
  const T* v_bh = v + (size_t)bh * sk * d;

  LoadTile(q_tile, q_bh, q0, sq, d, stride);

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[2][kOutPerThread];
#pragma unroll
  for (int r = 0; r < 2; r++)
#pragma unroll
    for (int e = 0; e < kOutPerThread; e++) acc[r][e] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done
    LoadTile(k_tile, k_bh, k0, sk, d, stride);
    LoadTile(v_tile, v_bh, k0, sk, d, stride);
    __syncthreads();

    // scores for rows 2ty, 2ty+1 and columns tx + 8c
    float s[2][kColsPerThread];
#pragma unroll
    for (int r = 0; r < 2; r++)
#pragma unroll
      for (int c = 0; c < kColsPerThread; c++) s[r][c] = 0.f;
    const float* q_row0 = q_tile + (2 * ty) * stride;
    const float* q_row1 = q_row0 + stride;
    for (int i = 0; i < d; i++) {
      float a0 = q_row0[i];
      float a1 = q_row1[i];
#pragma unroll
      for (int c = 0; c < kColsPerThread; c++) {
        float b = k_tile[(tx + 8 * c) * stride + i];
        s[0][c] = fmaf(a0, b, s[0][c]);
        s[1][c] = fmaf(a1, b, s[1][c]);
      }
    }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int r = 0; r < 2; r++) {
      int row = q0 + 2 * ty + r;
#pragma unroll
      for (int c = 0; c < kColsPerThread; c++) {
        int col = k0 + tx + 8 * c;
        float x = -INFINITY;
        if (row < sq && col < sk)
          x = s[r][c] * scale + bias[(size_t)row * sk + col];
        s[r][c] = x;
        tile_max[r] = fmaxf(tile_max[r], x);
      }
      // the eight threads of a row are lanes 8*(ty%4) .. +7 of one warp
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tile_max[r] =
            fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], off));
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; r++) {
      float m_new = fmaxf(m_run[r], tile_max[r]);
      float row_sum = 0.f;
      if (IsNegInf(m_new)) {
        // everything so far is masked: p = 0, nothing to rescale
        alpha[r] = 1.f;
#pragma unroll
        for (int c = 0; c < kColsPerThread; c++) s[r][c] = 0.f;
      } else {
        alpha[r] = IsNegInf(m_run[r]) ? 0.f : expf(m_run[r] - m_new);
#pragma unroll
        for (int c = 0; c < kColsPerThread; c++) {
          float p = IsNegInf(s[r][c]) ? 0.f : expf(s[r][c] - m_new);
          s[r][c] = p;
          row_sum += p;
        }
        m_run[r] = m_new;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_run[r] = l_run[r] * alpha[r] + row_sum;
#pragma unroll
      for (int c = 0; c < kColsPerThread; c++)
        p_tile[(2 * ty + r) * (kBlockN + 1) + tx + 8 * c] = s[r][c];
    }
    __syncthreads();

    // o[rows, tx + 8e] = o * alpha + p . v
#pragma unroll
    for (int r = 0; r < 2; r++)
#pragma unroll
      for (int e = 0; e < kOutPerThread; e++) acc[r][e] *= alpha[r];
    const float* p_row0 = p_tile + (2 * ty) * (kBlockN + 1);
    const float* p_row1 = p_row0 + (kBlockN + 1);
    for (int j = 0; j < kBlockN; j++) {
      float p0 = p_row0[j];
      float p1 = p_row1[j];
      const float* v_row = v_tile + j * stride;
#pragma unroll
      for (int e = 0; e < kOutPerThread; e++) {
        int col = tx + 8 * e;
        if (col < d) {
          float b = v_row[col];
          acc[0][e] = fmaf(p0, b, acc[0][e]);
          acc[1][e] = fmaf(p1, b, acc[1][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; r++) {
    int row = q0 + 2 * ty + r;
    if (row >= sq) continue;
    size_t base = (size_t)bh * sq + row;
#pragma unroll
    for (int e = 0; e < kOutPerThread; e++) {
      int col = tx + 8 * e;
      if (col < d) o[base * d + col] = acc[r][e];
    }
    if (tx == 0) {
      m_out[base] = m_run[r];
      l_out[base] = l_run[r];
    }
  }
}

template <typename T>
int Launch(const void* q, const void* k, const void* v, const float* bias,
           float* o, float* m, float* l, int bh, int sq, int sk, int d,
           float scale, cudaStream_t stream) {
  size_t smem = sizeof(float) *
                ((size_t)(kBlockM + 2 * kBlockN) * (d + 4) +
                 (size_t)kBlockM * (kBlockN + 1));
  static bool attribute_set = false;
  if (!attribute_set) {
    size_t most = sizeof(float) * ((size_t)(kBlockM + 2 * kBlockN) *
                                       (kMaxD + 4) +
                                   (size_t)kBlockM * (kBlockN + 1));
    cudaError_t err = cudaFuncSetAttribute(
        AttnBlockKernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  AttnBlockKernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, o, m, l, sq, sk, d, scale);
  return (int)cudaGetLastError();
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
    return Launch<float>(q, k, v, bias, o, m, l, batch_heads, sq, sk, d,
                         scale, s);
  if (dtype == 1)
    return Launch<__nv_bfloat16>(q, k, v, bias, o, m, l, batch_heads, sq, sk,
                                 d, scale, s);
  return (int)cudaErrorInvalidValue;
}
