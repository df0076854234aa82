// Fused Bernoulli log-likelihood backward for Hopper (sm_90a): the gradients
// of fused_ll_fwd.cu, recomputing the logits tile by tile so the [k, B, D]
// logits and their cotangent never reach device memory.
//
// Replaces the TPU kernel iwae_replication_project_tpu/ops/fused_likelihood.py
// _bwd_kernel (:242-265), launched by _bwd_pallas (:268-300).
//
// What it computes, for each flattened row r = (kk, b) of h [k, B, H] with
// cotangent g [k, B] (the gradient of fused_ll_fwd.cu's [k, B] output):
//   l   = h[r] W + bias
//   dl  = g[r] * (x[b] - sigmoid(l))        (only pixels d < D)
//   dh[r] = dl W^T
// and over all rows dW = sum_r h[r]^T dl, db = sum_r dl, all in fp32.
//
// Bound at the train shape (k = 50, B = 100 -> R = 5000 rows, H = 200,
// D = 784): 6 * R * H * D = 4.70 GFLOP (the recompute plus the two backward
// products) against ~10 MB that must move (h and dh 4.0 MB each, W and dW
// 0.63 MB each, x 0.31 MB, g 20 KB), so it is bound by operations: 0.070 ms
// in fp32 on the CUDA cores (67 TFLOP/s).
//
// Design (a simple correct first version, like the last layer of
// hot_loop_bwd.cu; tensor cores and a cp.async/TMA pipeline are later work):
// - Rows, not K-slabs: a CTA works on tiles of TM = 32 of the flattened R rows.
//   The h tile and the running dh tile stay in shared memory; the pixels are
//   walked in 128-column chunks: the logits chunk lives in registers, its dl
//   chunk in shared memory, dl_chunk W[:, chunk]^T is added into dh and
//   h^T dl_chunk into this CTA's dW partial. W is streamed in 32 x 128 chunks
//   (627 KB in fp32 at the flagship, above the 227 KB a CTA may hold).
// - Deterministic dW and db, no float atomics: a fixed number of row groups
//   (min(GROUPS, row tiles), independent of the device) each own one CTA and
//   one slot of a [G, S] fp32 scratch buffer (S = H * D + D) that the wrapper
//   allocates. A CTA walks its tiles t = g, g + G, ... in order, storing into
//   its slot on the first tile and adding on the next; each element is owned
//   by one fixed thread and a tile's 32 rows are summed in order. A second
//   kernel sums the G slots in order 0..G-1, so two launches on the same
//   inputs give bitwise equal dW and db.
// - Rows past R load h = 0 and get dl = 0, so they add exactly zero to dW and
//   db and their dh is not written; pixels d >= D get dl = 0.

#include "tiles_fp32.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
    fused_ll_bwd_kernel(const float* __restrict__ h,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ x,
                        const float* __restrict__ g, float* __restrict__ dh,
                        float* __restrict__ slots, int R, int B, int H,
                        int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int HP = round4(H);
  float* hs = smem;            // [TM][HP]  h tile
  float* dhs = hs + TM * HP;   // [TM][HP]  running dh of the tile
  float* dls = dhs + TM * HP;  // [TM][NT]  dl of one pixel chunk
  float* ws = dls + TM * NT;   // [KC][WS]  staged weight chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* s_dw = slots + (size_t)blockIdx.x * ((size_t)H * D + D);
  float* s_db = s_dw + (size_t)H * D;

  const RowMajor W{w, H, D, D};
  const int n_tiles = (R + TM - 1) / TM;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    const int r0 = t * TM;
    __syncthreads();  // the previous tile's buffers are consumed
    load_rows(h, hs, r0, R, H);
    for (int e = threadIdx.x; e < TM * HP; e += THREADS) dhs[e] = 0.f;

    for (int n0 = 0; n0 < D; n0 += NT) {
      const int nc = min(NT, D - n0);
      float acc[4][4];
      tile_product(acc, hs, HP, H, W, ws, n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * warp + i;
        const bool live = r < R;
        const float gr = live ? g[r] : 0.f;
        const float* xr = x + (size_t)(live ? r % B : 0) * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 4 * lane + j;
          float dl = 0.f;
          if (live && c < D) {
            const float l = acc[i][j] + bias[c];
            dl = gr * (xr[c] - 1.f / (1.f + expf(-l)));
          }
          dls[(4 * warp + i) * NT + 4 * lane + j] = dl;
        }
      }
      // dh += dl_chunk W[:, chunk]^T
      for (int nb = 0; nb < HP; nb += NT) {
        tile_product(acc, dls, NT, nc, Transposed{w, nc, H, D, n0}, ws, nb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = nb + 4 * lane + j;
            if (c < H) dhs[(4 * warp + i) * HP + c] += acc[i][j];
          }
      }
      __syncthreads();
      outer_acc(hs, HP, H, dls, NT, nc, s_dw + n0, D, first);
      col_sum(dls, NT, nc, s_db + n0, first);
      __syncthreads();  // dls is rewritten by the next chunk
    }

    for (int e = threadIdx.x; e < TM * HP; e += THREADS) {
      const int r = e / HP, c = e % HP;
      if (r0 + r < R && c < H) dh[(size_t)(r0 + r) * H + c] = dhs[e];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for hidden width H (bytes).
size_t fused_ll_bwd_smem_bytes(int H) {
  return sizeof(float) *
         ((size_t)TM * (2 * round4(H) + NT) + (size_t)KC * WS);
}

// Row groups (CTAs, scratch slots) for R rows: min(GROUPS, row tiles). It
// depends on R only, never on the device, so the summation order does not.
int fused_ll_bwd_groups(int R) { return row_groups(R); }

// Every pointer is a contiguous fp32 device buffer: h [R, H], w [H, D],
// bias [D], x [B, D], g [R]; outputs dh [R, H] and grads [H * D + D] (dW
// then db); slots [G, H * D + D] scratch with G = fused_ll_bwd_groups(R).
// Launches both kernels on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
int fused_ll_bwd(const void* h, const void* w, const void* bias,
                 const void* x, const void* g, void* dh, void* grads,
                 void* slots, int R, int B, int H, int D, int G,
                 void* stream) {
  if (R <= 0 || B <= 0 || H <= 0 || D <= 0 || R % B != 0 ||
      G != fused_ll_bwd_groups(R))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fused_ll_bwd_smem_bytes(H);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = allow_smem(fused_ll_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fused_ll_bwd_kernel<<<G, THREADS, smem, s>>>(
      (const float*)h, (const float*)w, (const float*)bias, (const float*)x,
      (const float*)g, (float*)dh, (float*)slots, R, B, H, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_slots((const float*)slots, (float*)grads,
                           (size_t)H * D + D, G, s);
}

}  // extern "C"
