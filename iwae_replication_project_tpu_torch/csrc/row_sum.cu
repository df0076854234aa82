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
// each output by one thread, adding r = 0, 1, ..., R-1 in order into an fp32
// accumulator that starts at 0: an output's arithmetic depends on its own R
// inputs only (contract C6), never on how many outputs the call has or where
// its output falls in the grid. No atomics, no scratch in device memory.
//
// Bound: R - 1 adds per output against 4 (outer R inner + outer inner)
// bytes, under one operation per byte: bound by bytes, a few hundred
// nanoseconds at the serving shapes (at most k x bucket = 3200 rows of 784
// at the flagship). What held the first version back was its reads: for a
// last-axis sum (inner = 1: the latents' 50-100 columns, the pixels' 784)
// each thread walked its own row, so neighbouring threads read addresses R
// floats apart and every load was a sector of its own.
//
// Design, inner = 1 (row_sum_rows): a CTA of 128 threads owns up to 32 rows,
// as many as fit whole in its 32 KB of shared memory (32 up to R = 256, 10
// at R = 784), and stages them with the whole CTA's loads coalesced: the
// rows are one contiguous block (16-byte loads when it is aligned, 4-byte
// loads otherwise); a row too long for that is staged in chunks. Then
// thread t < rows adds its row's staged inputs in index order from shared
// memory (row stride odd: the threads read distinct banks), so the result
// is bitwise the first version's, whose arithmetic was the same chain. inner > 1 (row_sum_outer) is the first
// version as it was: one thread per output, a warp on neighbouring outputs,
// so each of its R reads is already coalesced (staging those through shared
// memory measured slower on the card: PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // row_sum_rows
constexpr int OUTS = 32;            // its rows (outputs) of a CTA, at most
constexpr int CAP = OUTS * 257;     // its staged floats
constexpr int OUTER_THREADS = 256;  // row_sum_outer

// inner = 1: a CTA's `rows` rows staged in shared memory, then each added
// by its own thread
__global__ void __launch_bounds__(THREADS)
    row_sum_rows(const float* __restrict__ x, float* __restrict__ y,
                 long outer, int R, int rows) {
  __shared__ float S[CAP];
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * rows;
  const int nt = (int)(outer - row0 < rows ? outer - row0 : rows);
  const int width = CAP / nt - 1;  // a chunk: nt * (width | 1) <= CAP
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += width) {
    const int cw = R - r0 < width ? R - r0 : width;
    const int st = cw | 1;  // odd row stride: conflict-free reads
    const int n = nt * cw;
    const float* src = x + row0 * R + r0;
    if (cw == R && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      // the CTA's rows are one contiguous, aligned block of n floats
      const int n4 = n / 4;
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int e4 = tid; e4 < n4; e4 += THREADS) {
        const float4 v = src4[e4];
        const float q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * e4 + j, t = e / cw;
          S[t * st + e - t * cw] = q[j];
        }
      }
      for (int e = 4 * n4 + tid; e < n; e += THREADS) {
        const int t = e / cw;
        S[t * st + e - t * cw] = src[e];
      }
    } else {
      for (int e = tid; e < n; e += THREADS) {
        const int t = e / cw, c = e - t * cw;
        S[t * st + c] = src[(long)t * R + c];
      }
    }
    __syncthreads();
    if (tid < nt) {
      const float* p = S + tid * st;
#pragma unroll 8
      for (int c = 0; c < cw; ++c) acc += p[c];
    }
    __syncthreads();
  }
  if (tid < nt) y[row0 + tid] = acc;
}

// inner > 1: one thread per output; a warp's threads take neighbouring i,
// so every r is one coalesced read
__global__ void __launch_bounds__(OUTER_THREADS)
    row_sum_outer(const float* __restrict__ x, float* __restrict__ y,
                  long outputs, int R, long inner) {
  const long t = (long)blockIdx.x * OUTER_THREADS + threadIdx.x;
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
// the CUDA error code (0 on success).
int row_sum(const void* x, void* y, long long outer, int R, long long inner,
            void* stream) {
  if (outer <= 0 || R <= 0 || inner <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (inner == 1) {
    // as many rows as fit whole in shared memory, up to OUTS (one chunk);
    // a row longer than that is staged in chunks
    const int fit = CAP / (R + 1);
    const int rows = fit < 1 ? 1 : (fit < OUTS ? fit : OUTS);
    const long long blocks = (outer + rows - 1) / rows;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    row_sum_rows<<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float*)x, (float*)y, (long)outer, R, rows);
  } else {
    const long long outputs = outer * inner;
    const long long blocks = (outputs + OUTER_THREADS - 1) / OUTER_THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    row_sum_outer<<<(unsigned)blocks, OUTER_THREADS, 0, s>>>(
        (const float*)x, (float*)y, (long)outputs, R, (long)inner);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
