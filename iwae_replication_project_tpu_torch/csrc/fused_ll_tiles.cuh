// Device helpers shared by fused_ll_fwd.cu and fused_ll_bwd.cu: the row tile,
// the weight-chunk staging and the 4x4 register-tile product, in fp32.
//
// They are the fp32 parts of the hot-loop kernels' helpers (hot_loop_fwd.cu,
// hot_loop_bwd.cu), copied here so that those two sources stay unchanged.
// A CTA of THREADS = 256 threads owns a tile of TM = 32 rows: warp w owns rows
// 4w..4w+3 and lane t columns 4t..4t+3 of the current NT = 128-column pass.
// A weight is streamed through shared memory in KC x NT chunks, so a CTA
// reads it from L2 once per tile whatever its size.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // rows per tile
constexpr int NT = 128;       // output columns per pass (32 lanes x 4)
constexpr int KC = 32;        // reduction rows of a weight staged per chunk
constexpr int WS = NT + 4;    // row stride of the staged chunk (fewer bank
                              // conflicts on the transposed stores)
constexpr int THREADS = 256;  // 8 warps x 4 rows = TM

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// softplus(l) = log(1 + exp(l)) in JAX's stable form logaddexp(l, 0)
__device__ __forceinline__ float softplus(float l) {
  return fmaxf(l, 0.f) + log1pf(expf(-fabsf(l)));
}

// The B operand w[k * ld + n] of a product, zero outside [0, K) x [0, N).
struct RowMajor {
  const float* w;
  int K, N, ld;
  static constexpr bool kFastK = false;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return (k < K && n < N) ? w[(size_t)k * ld + n] : 0.f;
  }
};

// The B operand w[n * ld + koff + k]: the transpose of a column block of a
// row-major weight starting at column koff, zero outside [0, K) x [0, N).
struct Transposed {
  const float* w;
  int K, N, ld, koff;
  static constexpr bool kFastK = true;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return (k < K && n < N) ? w[(size_t)n * ld + koff + k] : 0.f;
  }
};

// acc[i][j] = sum_k a[(4*warp + i) * lda + k] * b(k, n0 + 4*lane + j) for k
// in [0, K), summed in increasing k. `a` lives in shared memory with its
// columns [K, round4(K)) zero; `b` is staged through `ws` ([KC][WS]) in
// chunks. Starts with a barrier, so `a` may have been written just before.
template <class Load>
__device__ __forceinline__ void tile_product(float acc[4][4], const float* a,
                                             int lda, int K, const Load& b,
                                             float* ws, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KP = round4(K);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < KP; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed; `a` is complete
    for (int e = threadIdx.x; e < KC * NT; e += THREADS) {
      // consecutive threads read consecutive addresses of the weight
      const int kr = Load::kFastK ? e % KC : e / NT;
      const int c = Load::kFastK ? e / KC : e % NT;
      ws[kr * WS + c] = b(k0 + kr, n0 + c);
    }
    __syncthreads();
    const int kend = min(KC, KP - k0);
    for (int kk = 0; kk < kend; kk += 4) {
      float4 wv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wv[t] = *reinterpret_cast<const float4*>(ws + (kk + t) * WS + 4 * lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(
            a + (4 * warp + i) * lda + k0 + kk);
        const float as[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[i][0] += as[t] * wv[t].x;
          acc[i][1] += as[t] * wv[t].y;
          acc[i][2] += as[t] * wv[t].z;
          acc[i][3] += as[t] * wv[t].w;
        }
      }
    }
  }
}

// Stage rows r0..r0+TM-1 of the row-major [R, H] matrix h into shared memory
// [TM][round4(H)]; rows past R and the padding columns are zero.
__device__ __forceinline__ void load_rows(const float* __restrict__ h,
                                          float* hs, int r0, int R, int H) {
  const int HP = round4(H);
  for (int e = threadIdx.x; e < TM * HP; e += THREADS) {
    const int r = e / HP, c = e % HP;
    hs[e] = (r0 + r < R && c < H) ? h[(size_t)(r0 + r) * H + c] : 0.f;
  }
}

}  // namespace
