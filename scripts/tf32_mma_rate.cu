// The rate of mma.sync.m16n8k8 TF32 on one NVIDIA GPU, alone and with the
// operand splits of 3xTF32, to size what B3 and B4 (csrc/tc_tf32.cuh) can
// reach with mma.sync:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tf32_mma_rate \
//     scripts/tf32_mma_rate.cu && ./tf32_mma_rate
//
// Every warp runs NACC independent accumulator chains of MMAs on operands
// held in registers (no memory traffic). "split cvt" also rounds two fresh
// B values into hi and lo per MMA with cvt.rna.tf32.f32, "split int" with
// the integer add-and-mask tc_tf32.cuh uses. Prints one line per variant:
// ms and TFLOP/s counted as 2 * 16 * 8 * 8 per MMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

__device__ __forceinline__ uint32_t rna_cvt(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t rna_int(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// SPLIT 0: none, 1: cvt.rna, 2: integer add and mask
template <int NACC, int SPLIT>
__global__ void chains(float* out, int iters, float seed) {
  float acc[NACC][4] = {};
  uint32_t a[4];
  const float v = seed + threadIdx.x;
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(v + i);
  const uint32_t b0 = __float_as_uint(v * 2), b1 = __float_as_uint(v * 3);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (SPLIT) {
        const float x = __uint_as_float(b0) + j, y = __uint_as_float(b1) + it;
        const uint32_t h0 = SPLIT == 1 ? rna_cvt(x) : rna_int(x);
        const uint32_t h1 = SPLIT == 1 ? rna_cvt(y) : rna_int(y);
        const float rx = x - __uint_as_float(h0), ry = y - __uint_as_float(h1);
        const uint32_t l0 = SPLIT == 1 ? rna_cvt(rx) : rna_int(rx);
        const uint32_t l1 = SPLIT == 1 ? rna_cvt(ry) : rna_int(ry);
        mma(acc[j], a, h0 ^ l0, h1 ^ l1);
      } else {
        mma(acc[j], a, b0, b1);
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC, int SPLIT>
void run(const char* name, int warps) {
  const int blocks = 132 * 4, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps * 32);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  chains<NACC, SPLIT><<<blocks, warps * 32>>>(out, 16, 1.f);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  chains<NACC, SPLIT><<<blocks, warps * 32>>>(out, iters, 1.f);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double mmas = (double)blocks * warps * iters * NACC;
  printf("%s: %d warps per CTA, %d chains per warp: %.3f ms, %.1f TFLOP/s "
         "(%s)\n",
         name, warps, NACC, ms, mmas * 2 * 16 * 8 * 8 / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  run<4, 0>("mma only", 4);
  run<8, 0>("mma only", 8);
  run<4, 1>("mma + split cvt", 4);
  run<8, 1>("mma + split cvt", 8);
  run<4, 2>("mma + split int", 4);
  run<8, 2>("mma + split int", 8);
  return 0;
}
