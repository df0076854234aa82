// Hot-loop decoder forward for Hopper (sm_90a): the whole IWAE decoder output
// block plus the Bernoulli log-likelihood reduced over pixels, fused.
//
// Replaces the TPU kernel iwae_replication_project_tpu/ops/hot_loop.py
// _fwd_kernel (:633-650), launched by _fwd_pallas (:661-695).
//
// What it computes, for each flattened row r = (kk, b) of h1 [k, B, H1]:
//   y1 = tanh(h1[r] W1 + b1)          [HID]
//   y2 = tanh(y1 W2 + b2)             [HID]
//   l  = y2 W3 + b3                   [D]
//   out[r] = sum_{d < D} x[b, d] * l[d] - softplus(l[d])
// with softplus(l) = max(l, 0) + log1p(exp(-|l|)) (JAX's logaddexp(l, 0)).
// With bf16 = 1 the matmul operands (h1, y1, y2 and the three weights) are
// rounded to bf16 (round to nearest even, as astype(bfloat16)) and the
// products are accumulated in fp32; biases, tanh and the likelihood stay fp32.
//
// Bound at the serving shape (k = 50, B = 64 -> R = 3200 rows, H1 = 100,
// HID = 200, D = 784): 2 * 3200 * (100*200 + 200*200 + 200*784) = 1.39 GFLOP
// against about 2.4 MB that must move (weights 0.87 MB in fp32, h1 1.28 MB,
// x 0.2 MB, out 12.8 KB): ~580 FLOP per byte, so it is bound by operations
// (in fp32 on the CUDA cores, 67 TFLOP/s -> 21 us; in bf16 on the tensor
// cores, 989 TFLOP/s -> 1.4 us) and, at small buckets (B = 1 -> 50 rows),
// by the launch itself.
//
// Design (a simple correct first version; wgmma, TMA and double buffering
// are later work):
// - One CTA of 256 threads owns a tile of TM = 32 rows. It stages the h1 rows,
//   then y1 and y2, in shared memory: the [k, B, HID] hiddens and the
//   [k, B, D] logits never reach device memory.
// - Each matmul streams its weight through shared memory in KC x NT chunks
//   (W3 alone is 627 KB in fp32, far above the 227 KB a CTA may hold), so a
//   CTA reads each weight from L2 once. Warp w owns rows 4w..4w+3 and lane t
//   columns 4t..4t+3 of the current 128-column pass: a 4x4 register tile
//   fed by float4 loads of broadcast activations and of the weight chunk.
// - The logits are consumed in registers pass by pass: each thread keeps a
//   running per-row sum of x*l - softplus(l) over its columns, masked at
//   d >= D; a fixed butterfly over the 32 lanes finishes the row. Every
//   row's sum runs in one fixed order that does not depend on the other rows
//   of the tile, so a row's result does not depend on the bucket it rides in.
// - No atomics: nothing is summed across CTAs in the forward.
// - Rows past R (the ragged last tile) compute on zeros and are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // rows per CTA
constexpr int NT = 128;       // output columns per pass (32 lanes x 4)
constexpr int KC = 32;        // reduction rows of a weight staged per chunk
constexpr int THREADS = 256;  // 8 warps x 4 rows = TM

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc[i][j] = sum_k a[(4*warp + i) * lda + k] * w[k * N + n0 + 4*lane + j],
// k over [0, K). `a` lives in shared memory with K padded by zeros to a
// multiple of 4; `w` is streamed through `ws` in KC x NT chunks, zero outside
// [0, K) x [0, N).
template <bool BF16>
__device__ __forceinline__ void tile_product(float acc[4][4], const float* a,
                                             int lda,
                                             const float* __restrict__ w,
                                             float* ws, int K, int N, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KP = round4(K);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < KP; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed; `a` is complete
    for (int e = threadIdx.x; e < KC * NT; e += THREADS) {
      const int kr = k0 + e / NT, c = n0 + e % NT;
      ws[e] = (kr < K && c < N) ? operand<BF16>(w[(size_t)kr * N + c]) : 0.f;
    }
    __syncthreads();
    const int kend = min(KC, KP - k0);
    for (int kk = 0; kk < kend; kk += 4) {
      float4 wv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        wv[t] = *reinterpret_cast<const float4*>(ws + (kk + t) * NT + 4 * lane);
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

// y = operand(tanh(a W + bias)) into shared memory [TM][ldy]; columns in
// [N, ldy) are zeroed so the next layer's padded reduction adds nothing.
template <bool BF16>
__device__ void dense_tanh(const float* a, int lda, const float* __restrict__ w,
                           const float* __restrict__ bias, int K, int N,
                           float* y, int ldy, float* ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < ldy; n0 += NT) {
    float acc[4][4];
    tile_product<BF16>(acc, a, lda, w, ws, K, N, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * lane + j;
        if (c < ldy)
          y[(4 * warp + i) * ldy + c] =
              c < N ? operand<BF16>(tanhf(acc[i][j] + bias[c])) : 0.f;
      }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    hot_loop_fwd_kernel(const float* __restrict__ h1,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ w3,
                        const float* __restrict__ b3,
                        const float* __restrict__ x, float* __restrict__ out,
                        int R, int B, int H1, int HID, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H1P = round4(H1), HP = round4(HID);
  float* hs = smem;             // [TM][H1P]
  float* y1s = hs + TM * H1P;   // [TM][HP]
  float* y2s = y1s + TM * HP;   // [TM][HP]
  float* ws = y2s + TM * HP;    // [KC][NT]
  const int r0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < TM * H1P; e += THREADS) {
    const int r = e / H1P, c = e % H1P;
    hs[e] = (r0 + r < R && c < H1)
                ? operand<BF16>(h1[(size_t)(r0 + r) * H1 + c])
                : 0.f;
  }
  dense_tanh<BF16>(hs, H1P, w1, b1, H1, HID, y1s, HP, ws);
  dense_tanh<BF16>(y1s, HP, w2, b2, HID, HID, y2s, HP, ws);

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < D; n0 += NT) {
    float acc[4][4];
    tile_product<BF16>(acc, y2s, HP, w3, ws, HID, D, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * warp + i;
      const float* xr = x + (size_t)((r < R ? r : 0) % B) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * lane + j;
        if (c < D) {
          const float l = acc[i][j] + b3[c];
          part[i] += xr[c] * l - (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = part[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int r = r0 + 4 * warp + i;
    if (lane == 0 && r < R) out[r] = v;
  }
}

template <bool BF16>
int launch(const float* h1, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, const float* x,
           float* out, int R, int B, int H1, int HID, int D, size_t smem,
           cudaStream_t stream) {
  // above the default 48 KB the limit must be raised; it is an attribute of
  // the kernel on the current device, so it is set on every launch rather
  // than cached for one device
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hot_loop_fwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + TM - 1) / TM);
  hot_loop_fwd_kernel<BF16><<<grid, THREADS, smem, stream>>>(
      h1, w1, b1, w2, b2, w3, b3, x, out, R, B, H1, HID, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for these widths (bytes).
size_t hot_loop_fwd_smem_bytes(int H1, int HID) {
  return sizeof(float) *
         ((size_t)TM * (round4(H1) + 2 * round4(HID)) + (size_t)KC * NT);
}

// out[r] for r < R = k * B; every pointer is a contiguous fp32 device buffer:
// h1 [R, H1], w1 [H1, HID], b1 [HID], w2 [HID, HID], b2 [HID], w3 [HID, D],
// b3 [D], x [B, D], out [R]. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
int hot_loop_fwd(const void* h1, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, const void* x, void* out, int R, int B,
                 int H1, int HID, int D, int bf16, void* stream) {
  if (R <= 0 || B <= 0 || H1 <= 0 || HID <= 0 || D <= 0 || R % B != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = hot_loop_fwd_smem_bytes(H1, HID);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fh1 = (const float*)h1, *fw1 = (const float*)w1,
              *fb1 = (const float*)b1, *fw2 = (const float*)w2,
              *fb2 = (const float*)b2, *fw3 = (const float*)w3,
              *fb3 = (const float*)b3, *fx = (const float*)x;
  float* fout = (float*)out;
  return bf16 ? launch<true>(fh1, fw1, fb1, fw2, fb2, fw3, fb3, fx, fout, R, B,
                             H1, HID, D, smem, s)
              : launch<false>(fh1, fw1, fb1, fw2, fb2, fw3, fb3, fx, fout, R,
                              B, H1, HID, D, smem, s);
}

}  // extern "C"
