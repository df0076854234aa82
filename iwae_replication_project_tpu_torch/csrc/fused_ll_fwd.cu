// Fused Bernoulli log-likelihood forward for Hopper (sm_90a): the decoder's
// last layer plus the Bernoulli log-likelihood reduced over pixels, with the
// logits never in device memory.
//
// Replaces the TPU kernel iwae_replication_project_tpu/ops/fused_likelihood.py
// _fwd_kernel (:206-215), launched by _fwd_pallas (:218-239).
//
// What it computes, for each flattened row r = (kk, b) of h [k, B, H]:
//   l = h[r] W + bias                                        [D]
//   out[r] = sum_{d < D} x[b, d] * l[d] - softplus(l[d])
// all in fp32, with softplus(l) = max(l, 0) + log1p(exp(-|l|)).
//
// Bound at the train shape (k = 50, B = 100 -> R = 5000 rows, H = 200,
// D = 784): 2 * R * H * D = 1.57 GFLOP against ~4.9 MB that must move (h
// 4.0 MB, W 0.63 MB, x 0.31 MB, out 20 KB), ~320 FLOP per byte, so it is
// bound by operations: 0.023 ms in fp32 on the CUDA cores (67 TFLOP/s). At
// the eval chunk (k = 250, B = 500) 0.59 ms.
//
// Design (a simple correct first version, like hot_loop_fwd.cu's last stage;
// tensor cores and a cp.async/TMA pipeline are later work):
// - Rows, not K-slabs: a CTA of 256 threads owns a tile of TM = 32 of the
//   flattened R = k * B rows (the Pallas TILE_K = 8 slab with the whole batch
//   per program is a TPU tiling rule and is not carried over). It stages its
//   h rows in shared memory.
// - W (627 KB in fp32 at the flagship, far above the 227 KB a CTA may hold)
//   is streamed through shared memory in 32 x 128 chunks; the logits of a
//   128-pixel pass live in registers (a 4 x 4 tile per thread) and are
//   consumed there: each thread keeps a running per-row sum of
//   x * l - softplus(l) over its columns, masked at d >= D, and a fixed
//   butterfly over the 32 lanes finishes the row. A row's sum runs in one
//   fixed order that does not depend on the other rows, so a row's result is
//   bitwise the same whatever B it comes in.
// - No atomics: nothing is summed across CTAs.
// - Rows past R (the ragged last tile) compute on zeros and are not written.

#include "tiles_fp32.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
    fused_ll_fwd_kernel(const float* __restrict__ h,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ x, float* __restrict__ out,
                        int R, int B, int H, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hs = smem;                   // [TM][round4(H)]
  float* ws = hs + TM * round4(H);    // [KC][WS]
  const int r0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows(h, hs, r0, R, H);
  const RowMajor W{w, H, D, D};
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < D; n0 += NT) {
    float acc[4][4];
    tile_product(acc, hs, round4(H), H, W, ws, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * warp + i;
      const float* xr = x + (size_t)((r < R ? r : 0) % B) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * lane + j;
        if (c < D) {
          const float l = acc[i][j] + bias[c];
          part[i] += xr[c] * l - softplus(l);
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

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for hidden width H (bytes).
size_t fused_ll_fwd_smem_bytes(int H) {
  return sizeof(float) * ((size_t)TM * round4(H) + (size_t)KC * WS);
}

// out[r] for r < R = k * B; every pointer is a contiguous fp32 device buffer:
// h [R, H], w [H, D], bias [D], x [B, D], out [R]. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
int fused_ll_fwd(const void* h, const void* w, const void* bias,
                 const void* x, void* out, int R, int B, int H, int D,
                 void* stream) {
  if (R <= 0 || B <= 0 || H <= 0 || D <= 0 || R % B != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fused_ll_fwd_smem_bytes(H);
  const cudaError_t e = allow_smem(fused_ll_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((R + TM - 1) / TM);
  fused_ll_fwd_kernel<<<grid, THREADS, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)h, (const float*)w, (const float*)bias, (const float*)x,
      (float*)out, R, B, H, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
