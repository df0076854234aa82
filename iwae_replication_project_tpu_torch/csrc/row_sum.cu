// Fixed-order sum over one axis for Hopper (sm_90a): the serving programs'
// reductions over samples, latents and pixels, each output summed in one
// order whatever the batch.
//
// Not a port of a TPU kernel. torch.sum's CUDA reduction sizes its thread
// blocks from both the reduced length and the number of outputs, so with few
// outputs (a bucket of one row) it splits a row's sum over more threads, and
// an outer-axis sum (log-weights [k, B] over k) splits by B: the same row got
// other bits in another bucket. This kernel takes those sums on the serving
// path instead (ops/row_invariant.fixed_sum, under ModelConfig.row_invariant,
// chosen by ops/hot_loop.serving_dispatch_config on CUDA).
//
// What it computes, for x viewed as [outer, R, inner] (contiguous fp32):
//   y[o, i] = sum_{r=0}^{R-1} x[o, r, i]
// one thread per output, adding r = 0, 1, ..., R-1 in order into an fp32
// accumulator that starts at 0. An output's arithmetic depends on its own R
// inputs only.
//
// Bound: R adds per output against 4 (outer R inner + outer inner) bytes,
// under one operation per byte: bound by bytes. Threads of a warp take
// neighbouring i, so an outer-axis sum (inner > 1) reads coalesced; a
// last-axis sum (inner = 1: the latents' 50-100 and the pixels' 784) walks
// each row from one thread. The serving sums are small (at most k * bucket
// = 3200 rows at the flagship), so this simple form is kept until a
// measurement says otherwise.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    row_sum_kernel(const float* __restrict__ x, float* __restrict__ y,
                   long outputs, int R, long inner) {
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= outputs) return;
  const long o = t / inner, i = t - o * inner;
  const float* p = x + o * R * inner + i;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += p[(long)r * inner];
  y[t] = acc;
}

}  // namespace

extern "C" {

// y [outer, inner] = x [outer, R, inner] summed over R; contiguous fp32
// device buffers. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
int row_sum(const void* x, void* y, long long outer, int R, long long inner,
            void* stream) {
  if (outer <= 0 || R <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  const long long outputs = outer * inner;
  const long long blocks = (outputs + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  row_sum_kernel<<<(unsigned)blocks, THREADS, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (float*)y, (long)outputs, R, (long)inner);
  return (int)cudaGetLastError();
}

}  // extern "C"
