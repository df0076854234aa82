// fp32 device helpers on the CUDA cores, used by the fp32 paths of the
// hot-loop pair (hot_loop_fwd.cu, hot_loop_bwd.cu): the row tile, the
// weight-chunk staging, the 4x4 register-tile product, the per-CTA
// weight-gradient partials and their fixed-order reduction. fused_ll_bwd.cu
// (B4, on the tensor cores) uses only the fixed-order reduction
// (reduce_slots) and allow_smem.
//
// A CTA of THREADS = 256 threads owns a tile of TM = 32 rows: warp w owns rows
// 4w..4w+3 and lane t columns 4t..4t+3 of the current NT = 128-column pass.
// A weight is streamed through shared memory in KC x NT chunks, so a CTA
// reads it from L2 once per tile whatever its size. Everything is full fp32
// (no TF32), summed in one fixed order.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // rows per tile
constexpr int NT = 128;       // output columns per pass (32 lanes x 4)
constexpr int KC = 32;        // reduction rows of a weight staged per chunk
constexpr int WS = NT + 4;    // row stride of the staged chunk (fewer bank
                              // conflicts on the transposed stores)
constexpr int THREADS = 256;  // 8 warps x 4 rows = TM
constexpr int GROUPS = 128;   // row groups of a backward: CTAs and scratch
                              // slots, at most

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

// y = tanh(a W + bias) into shared memory [TM][ldy]; columns [N, ldy) are
// zeroed so the next layer's padded reduction adds nothing.
__device__ void dense_tanh(const float* a, int lda, int K, const RowMajor& w,
                           const float* __restrict__ bias, float* y, int ldy,
                           float* ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < ldy; n0 += NT) {
    float acc[4][4];
    tile_product(acc, a, lda, K, w, ws, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * lane + j;
        if (c < ldy)
          y[(4 * warp + i) * ldy + c] =
              c < w.N ? tanhf(acc[i][j] + bias[c]) : 0.f;
      }
  }
}

// out[i * ldo + j] (=, or += unless `first`) sum_{m < TM} a[m * lda + i] *
// b[m * ldb + j] for i < M, j < N: one tile's share of a weight gradient,
// into this CTA's own slot, rows summed in order m = 0..TM-1 by one fixed
// thread.
__device__ void outer_acc(const float* a, int lda, int M, const float* b,
                          int ldb, int N, float* __restrict__ out, int ldo,
                          bool first) {
  const int nbj = (N + 3) / 4, nblk = ((M + 3) / 4) * nbj;
  for (int blk = threadIdx.x; blk < nblk; blk += THREADS) {
    const int i0 = 4 * (blk / nbj), j0 = 4 * (blk % nbj);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int m = 0; m < TM; ++m) {
      const float4 av = *reinterpret_cast<const float4*>(a + m * lda + i0);
      const float4 bv = *reinterpret_cast<const float4*>(b + m * ldb + j0);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += ai[i] * bj[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + i < M && j0 + j < N) {
          float* p = out + (size_t)(i0 + i) * ldo + j0 + j;
          *p = first ? s[i][j] : *p + s[i][j];
        }
  }
}

// out[j] (=, or += unless `first`) sum_{m < TM} b[m * ldb + j] for j < N: a
// tile's share of a bias gradient, rows summed in order.
__device__ void col_sum(const float* b, int ldb, int N,
                        float* __restrict__ out, bool first) {
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float s = 0.f;
    for (int m = 0; m < TM; ++m) s += b[m * ldb + j];
    out[j] = first ? s : out[j] + s;
  }
}

// Row groups (CTAs, scratch slots) of an fp32 backward over R rows:
// min(GROUPS, row tiles). It depends on R only, never on the device, so the
// summation order does not.
__host__ __device__ inline int row_groups(int R) {
  const int tiles = (R + TM - 1) / TM;
  return tiles < GROUPS ? tiles : GROUPS;
}

// out[j] = sum_{g < G} slots[g * S + j], in order g = 0..G-1.
__global__ void reduce_slots_kernel(const float* __restrict__ slots,
                                    float* __restrict__ out, size_t S, int G) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < S;
       j += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int gi = 0; gi < G; ++gi) s += slots[(size_t)gi * S + j];
    out[j] = s;
  }
}

// Launch reduce_slots_kernel over S outputs on `stream`.
inline cudaError_t reduce_slots(const float* slots, float* out, size_t S,
                                int G, cudaStream_t stream) {
  const size_t want = (S + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  reduce_slots_kernel<<<blocks, 256, 0, stream>>>(slots, out, S, G);
  return cudaGetLastError();
}

// Raise the dynamic shared-memory limit of `kernel` to `smem` bytes where it
// is above the default 48 KB. It is an attribute of the kernel on the
// current device, so it is set on every launch rather than cached.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
