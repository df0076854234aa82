// Row-invariant dense layer for Hopper (sm_90a): y = act(x W + b), with each
// output element summed over K in one fixed order whatever the row count.
//
// Not a port of a TPU kernel. The JAX serving programs make a served row's
// result bitwise independent of its batch (JAX serving/programs.py:1-11): XLA
// compiles each bucket's program with the same per-row arithmetic. On the
// card cuBLAS picks its algorithm per problem shape (split-K, another tile
// order, a GEMV at one row), so the same row gave other bits in another
// bucket. This kernel takes the serving programs' dense layers instead
// (models/mlp.py dense_apply under ModelConfig.row_invariant, chosen by
// ops/hot_loop.serving_dispatch_config on CUDA).
//
// What it computes, for x [M, K], W [K, N], b [N] (contiguous fp32):
//   y[m, n] = act(b[n] + sum_{k=0}^{K-1} op(x[m, k]) op(W[k, n]))
// where op rounds to bf16 (round to nearest even, as .to(bfloat16)) when
// bf16 = 1 and is the identity otherwise, and act is tanh or the identity.
// The sum runs k = 0, 1, ..., K-1 as one chain of fused multiply-adds into an
// fp32 accumulator that starts at 0, then adds the bias: the arithmetic of an
// output depends on its row of x, its column of W and K only. Neither M, the
// tile a row lands in, nor its position in the tile changes it, and nothing
// is split over K. A product of two bf16 values is exact in fp32, so with
// bf16 = 1 this is dense_apply's bf16 semantics (JAX jnp.dot on bf16 operands
// with fp32 accumulation) summed in one fixed order.
//
// Bound: 2 M K N operations against 4 (M K + K N + N + M N) bytes. The
// serving layers are small (K, N <= 784, M = bucket or k * bucket <= 3200 at
// the flagship), ~100 FLOP per byte at most: below the H100's
// operations-per-byte ridge in fp32 on the CUDA cores (67 TFLOP/s over
// 3.35 TB/s = 20) only for the narrowest layers, so most are bound by
// operations on the CUDA cores. This first version runs every product on the
// CUDA cores, so bf16 operands do not reach the tensor cores' rate; a later
// version can use mma.sync with a fixed accumulation order, as B1 does
// (tc_bf16.cuh).
//
// Design: a 256-thread CTA owns a 64 x 64 output tile, each thread a 4 x 4
// micro-tile; x and W stream through shared memory in slabs of 16 along K
// (rounded to bf16 as they are staged), and each thread walks the slab's
// 16 k in order. Rows past M and columns past N compute on zeros and are not
// written; K's ragged last slab adds exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <bool BF16>
__device__ __forceinline__ float op(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <bool BF16, bool TANH>
__global__ void __launch_bounds__(THREADS)
    row_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y,
                     int M, int K, int N) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const long m = m0 + r;
      const int k = k0 + c;
      As[c][r] = (m < M && k < K) ? op<BF16>(x[m * K + k]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? op<BF16>(w[(long)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float v = acc[i][j] + b[n];
      if (TANH) v = tanhf(v);
      y[m * N + n] = v;
    }
  }
}

template <bool BF16, bool TANH>
void launch(const float* x, const float* w, const float* b, float* y, int M,
            int K, int N, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  row_dense_kernel<BF16, TANH><<<grid, THREADS, 0, s>>>(x, w, b, y, M, K, N);
}

}  // namespace

extern "C" {

// y [M, N] = act(x [M, K] W [K, N] + b [N]); every pointer a contiguous fp32
// device buffer. bf16 = 1 rounds x and W to bf16 before the products; act = 1
// applies tanh. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
int row_dense(const void* x, const void* w, const void* b, void* y, int M,
              int K, int N, int bf16, int act, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fx = (const float*)x, *fw = (const float*)w,
              *fb = (const float*)b;
  float* fy = (float*)y;
  if (bf16) {
    if (act) launch<true, true>(fx, fw, fb, fy, M, K, N, s);
    else launch<true, false>(fx, fw, fb, fy, M, K, N, s);
  } else {
    if (act) launch<false, true>(fx, fw, fb, fy, M, K, N, s);
    else launch<false, false>(fx, fw, fb, fy, M, K, N, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
