// mma_peak.cu — the card's own rate for the instruction attn_block.cu is
// built on, mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, with no loads and
// no other arithmetic: each of 8 warps a block keeps 16 independent
// accumulators in flight. chip_smoke.py times it beside the kernel, so the
// kernel's time can be read against what mma.sync can do on this card, not
// only against the 494.7 TFLOP/s dense TF32 peak that wgmma reaches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;

__global__ void __launch_bounds__(kThreads, 1) MmaPeakKernel(float* out,
                                                             int iters) {
  // operands from the thread index, so nothing folds at compile time
  const uint32_t b0 = 0x3f800000u + threadIdx.x;
  const uint32_t b1 = 0x3f000000u ^ threadIdx.x;
  uint32_t a[4];
  for (int i = 0; i < 4; i++) a[i] = 0x3f800000u + threadIdx.x * (i + 1);
  float c[kChains][4] = {};
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int j = 0; j < kChains; j++)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float sum = 0.f;
  for (int j = 0; j < kChains; j++)
    for (int e = 0; e < 4; e++) sum += c[j][e];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// Runs blocks x iters x 8 warps x 16 mma (2048 flops each); out holds
// blocks * 256 floats. Returns the launch's cudaError_t.
extern "C" int mma_peak(float* out, int blocks, int iters, void* stream) {
  MmaPeakKernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return (int)cudaGetLastError();
}
