// Hot-loop decoder backward for Hopper (sm_90a): the gradients of the fused
// decoder output block + Bernoulli log-likelihood, recomputing the forward
// tile by tile so the [k, B, D] logits and their cotangent never reach device
// memory.
//
// Replaces the TPU kernel iwae_replication_project_tpu/ops/hot_loop.py
// _bwd_kernel (:698-746), launched by _bwd_pallas (:749-792).
//
// What it computes, for each flattened row r = (kk, b) of h1 [k, B, H1] with
// cotangent g [k, B] (the gradient of the [k, B] output of hot_loop_fwd.cu):
//   y1 = tanh(h1[r] W1 + b1), y2 = tanh(y1 W2 + b2), l = y2 W3 + b3
//   dl  = g[r] * (x[b] - sigmoid(l))             (only pixels d < D)
//   dy2 = (dl W3^T) * (1 - y2^2), dy1 = (dy2 W2^T) * (1 - y1^2)
//   dh[r] = dy1 W1^T
// and over all rows dW3 = sum y2^T dl, dW2 = sum y1^T dy2, dW1 = sum h1^T dy1,
// db3/db2/db1 = the row sums of dl/dy2/dy1.
// With bf16 = 1 every matmul OPERAND is rounded to bf16 (h1, y1, y2, dl, dy2,
// dy1 and the three weights), as the Pallas kernel's cast(...) does; products
// accumulate in fp32. The tanh derivatives and the bias sums use the UNROUNDED
// fp32 y1, y2, dl, dy2, dy1, so y1 and y2 are kept in fp32 on chip and
// rounded where they are read as operands.
//
// Bound at the train shape (k = 50, B = 100 -> R = 5000 rows, H1 = 100,
// HID = 200, D = 784): 6 * R * (H1*HID + HID^2 + HID*D) = 6.50 GFLOP (the
// recompute plus two backward products per matmul) against ~4.7 MB that must
// move, so it is bound by operations: 0.097 ms in fp32 on the CUDA cores,
// 0.0066 ms in bf16 on the tensor cores.
//
// Design (a simple correct first version; wgmma, TMA and pipelining are later
// work):
// - One CTA of 256 threads works on tiles of TM = 32 rows. The h1 tile, y1,
//   y2 and the running dy2 stay in shared memory; the pixels are walked in
//   128-column chunks: the logits chunk lives in registers, its dl chunk in
//   shared memory, dl_chunk W3[:, chunk]^T is added into dy2 and
//   y2^T dl_chunk into this CTA's dW3 partial.
// - Every weight is streamed through shared memory in 32 x 128 chunks (W3 is
//   627 KB in fp32, far above the 227 KB a CTA may hold); the transposed
//   products read the same row-major weights with the roles of the indices
//   swapped.
// - Deterministic weight gradients, no float atomics: a fixed number of row
//   groups (min(GROUPS, row tiles), independent of the device) each own one
//   CTA and one slot of a [G, S] fp32 scratch buffer (S = the floats of all
//   six weight/bias gradients). A CTA walks its tiles t = g, g + G, ... in
//   order, storing into its slot on the first tile and adding on the next.
//   A second kernel sums the G slots in order 0..G-1 for every element.
// - Rows past R (the ragged last tile) load h1 = 0 and get dl = 0, so dy2,
//   dy1 are exactly 0 there and they add exactly zero to every dW and db;
//   their dh is not written. Pixels d >= D get dl = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // rows per tile
constexpr int NT = 128;       // output columns per pass (32 lanes x 4)
constexpr int KC = 32;        // reduction rows of a weight staged per chunk
constexpr int WS = NT + 4;    // row stride of the staged chunk (fewer bank
                              // conflicts on the transposed stores)
constexpr int THREADS = 256;  // 8 warps x 4 rows = TM
constexpr int GROUPS = 128;   // row groups: CTAs and scratch slots, at most

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
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

// The B operand w[n * ld + koff + k]: the transpose of a row-major weight
// (or of a column block of it starting at koff), zero outside [0, K) x [0, N).
struct Transposed {
  const float* w;
  int K, N, ld, koff;
  static constexpr bool kFastK = true;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return (k < K && n < N) ? w[(size_t)n * ld + koff + k] : 0.f;
  }
};

// acc[i][j] = sum_k op(a[(4*warp + i) * lda + k]) * op(b(k, n0 + 4*lane + j))
// for k in [0, K). `a` lives in shared memory with its columns [K, round4(K))
// zero; `b` is staged through `ws` in KC x NT chunks. Starts with a barrier,
// so `a` may have been written just before the call.
template <bool BF16, class Load>
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
      ws[kr * WS + c] = operand<BF16>(b(k0 + kr, n0 + c));
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
        const float as[4] = {operand<BF16>(av.x), operand<BF16>(av.y),
                             operand<BF16>(av.z), operand<BF16>(av.w)};
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

// y = tanh(a W + bias) in fp32 (unrounded) into shared memory [TM][ldy];
// columns [N, ldy) are zeroed.
template <bool BF16>
__device__ void dense_tanh(const float* a, int lda, int K, const RowMajor& w,
                           const float* __restrict__ bias, float* y, int ldy,
                           float* ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < ldy; n0 += NT) {
    float acc[4][4];
    tile_product<BF16>(acc, a, lda, K, w, ws, n0);
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

// out[i * ldo + j] (=, or += unless `first`) sum_{m < TM} op(a[m * lda + i]) *
// op(b[m * ldb + j]) for i < M, j < N: one tile's share of a weight gradient,
// into this CTA's own slot. Each element is owned by one fixed thread, and
// the TM rows are summed in order m = 0..TM-1.
template <bool BF16>
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
      const float ai[4] = {operand<BF16>(av.x), operand<BF16>(av.y),
                           operand<BF16>(av.z), operand<BF16>(av.w)};
      const float bj[4] = {operand<BF16>(bv.x), operand<BF16>(bv.y),
                           operand<BF16>(bv.z), operand<BF16>(bv.w)};
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
// tile's share of a bias gradient (unrounded fp32), rows summed in order.
__device__ void col_sum(const float* b, int ldb, int N,
                        float* __restrict__ out, bool first) {
  for (int j = threadIdx.x; j < N; j += THREADS) {
    float s = 0.f;
    for (int m = 0; m < TM; ++m) s += b[m * ldb + j];
    out[j] = first ? s : out[j] + s;
  }
}

__host__ __device__ inline size_t slot_floats(int H1, int HID, int D) {
  return (size_t)H1 * HID + HID + (size_t)HID * HID + HID + (size_t)HID * D +
         D;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
    hot_loop_bwd_kernel(const float* __restrict__ h1,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ w3,
                        const float* __restrict__ b3,
                        const float* __restrict__ x,
                        const float* __restrict__ g, float* __restrict__ dh,
                        float* __restrict__ slots, int R, int B, int H1,
                        int HID, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H1P = round4(H1), HP = round4(HID);
  float* hs = smem;              // [TM][H1P]  h1 tile, operand-rounded
  float* y1s = hs + TM * H1P;    // [TM][HP]   y1, later dy1 (fp32)
  float* y2s = y1s + TM * HP;    // [TM][HP]   y2 (fp32)
  float* dy2s = y2s + TM * HP;   // [TM][HP]   dy2 (fp32)
  float* dls = dy2s + TM * HP;   // [TM][NT]   dl of one pixel chunk (fp32)
  float* ws = dls + TM * NT;     // [KC][WS]   staged weight chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float* s_dw1 = slots + (size_t)blockIdx.x * slot_floats(H1, HID, D);
  float* s_db1 = s_dw1 + (size_t)H1 * HID;
  float* s_dw2 = s_db1 + HID;
  float* s_db2 = s_dw2 + (size_t)HID * HID;
  float* s_dw3 = s_db2 + HID;
  float* s_db3 = s_dw3 + (size_t)HID * D;

  const RowMajor W1{w1, H1, HID, HID}, W2{w2, HID, HID, HID},
      W3{w3, HID, D, D};
  const int n_tiles = (R + TM - 1) / TM;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    const int r0 = t * TM;
    __syncthreads();  // the previous tile's buffers are consumed
    for (int e = threadIdx.x; e < TM * H1P; e += THREADS) {
      const int r = e / H1P, c = e % H1P;
      hs[e] = (r0 + r < R && c < H1)
                  ? operand<BF16>(h1[(size_t)(r0 + r) * H1 + c])
                  : 0.f;
    }
    for (int e = threadIdx.x; e < TM * HP; e += THREADS) dy2s[e] = 0.f;
    dense_tanh<BF16>(hs, H1P, H1, W1, b1, y1s, HP, ws);
    dense_tanh<BF16>(y1s, HP, HID, W2, b2, y2s, HP, ws);

    for (int n0 = 0; n0 < D; n0 += NT) {
      const int nc = min(NT, D - n0);
      float acc[4][4];
      tile_product<BF16>(acc, y2s, HP, HID, W3, ws, n0);
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
            const float l = acc[i][j] + b3[c];
            dl = gr * (xr[c] - 1.f / (1.f + expf(-l)));
          }
          dls[(4 * warp + i) * NT + 4 * lane + j] = dl;
        }
      }
      // dy2 += dl_chunk W3[:, chunk]^T
      for (int nb = 0; nb < HP; nb += NT) {
        tile_product<BF16>(acc, dls, NT, NT,
                           Transposed{w3, nc, HID, D, n0}, ws, nb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = nb + 4 * lane + j;
            if (c < HID) dy2s[(4 * warp + i) * HP + c] += acc[i][j];
          }
      }
      __syncthreads();
      outer_acc<BF16>(y2s, HP, HID, dls, NT, nc, s_dw3 + n0, D, first);
      col_sum(dls, NT, nc, s_db3 + n0, first);
      __syncthreads();  // dls is rewritten by the next chunk
    }

    for (int e = threadIdx.x; e < TM * HP; e += THREADS) {
      const float y = y2s[e];
      dy2s[e] *= 1.f - y * y;  // padding columns stay 0
    }
    __syncthreads();
    outer_acc<BF16>(y1s, HP, HID, dy2s, HP, HID, s_dw2, HID, first);
    col_sum(dy2s, HP, HID, s_db2, first);

    // dy1 = (dy2 W2^T) * (1 - y1^2), written over y1 (its last reader,
    // outer_acc above, finished at tile_product's opening barrier)
    for (int nb = 0; nb < HP; nb += NT) {
      float acc[4][4];
      tile_product<BF16>(acc, dy2s, HP, HID, Transposed{w2, HID, HID, HID, 0},
                         ws, nb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = nb + 4 * lane + j;
          if (c < HID) {
            float* p = y1s + (4 * warp + i) * HP + c;
            const float y = *p;
            *p = acc[i][j] * (1.f - y * y);
          }
        }
    }
    __syncthreads();
    outer_acc<BF16>(hs, H1P, H1, y1s, HP, HID, s_dw1, HID, first);
    col_sum(y1s, HP, HID, s_db1, first);

    // dh = dy1 W1^T
    for (int nb = 0; nb < H1P; nb += NT) {
      float acc[4][4];
      tile_product<BF16>(acc, y1s, HP, HID, Transposed{w1, HID, H1, HID, 0},
                         ws, nb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * warp + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = nb + 4 * lane + j;
          if (r < R && c < H1) dh[(size_t)r * H1 + c] = acc[i][j];
        }
      }
    }
  }
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

template <bool BF16>
int launch(const float* h1, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, const float* x,
           const float* g, float* dh, float* grads, float* slots, int R, int B,
           int H1, int HID, int D, int G, size_t smem, cudaStream_t stream) {
  // above the default 48 KB the limit must be raised; it is an attribute of
  // the kernel on the current device, so it is set on every launch
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hot_loop_bwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  hot_loop_bwd_kernel<BF16><<<G, THREADS, smem, stream>>>(
      h1, w1, b1, w2, b2, w3, b3, x, g, dh, slots, R, B, H1, HID, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t S = slot_floats(H1, HID, D);
  const size_t want = (S + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  reduce_slots_kernel<<<blocks, 256, 0, stream>>>(slots, grads, S, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for these widths (bytes).
size_t hot_loop_bwd_smem_bytes(int H1, int HID) {
  return sizeof(float) * ((size_t)TM * (round4(H1) + 3 * round4(HID) + NT) +
                          (size_t)KC * WS);
}

// Row groups (CTAs, scratch slots) for R rows: min(GROUPS, row tiles). It
// depends on R only, never on the device, so the summation order does not.
int hot_loop_bwd_groups(int R) {
  const int tiles = (R + TM - 1) / TM;
  return tiles < GROUPS ? tiles : GROUPS;
}

// Every pointer is a contiguous fp32 device buffer: h1 [R, H1], w1 [H1, HID],
// b1 [HID], w2 [HID, HID], b2 [HID], w3 [HID, D], b3 [D], x [B, D], g [R];
// outputs dh [R, H1] and grads [S] (dW1, db1, dW2, db2, dW3, db3 back to
// back); slots [G, S] scratch with G = hot_loop_bwd_groups(R). Launches both
// kernels on `stream` without synchronising and returns cudaGetLastError()
// (0 on success).
int hot_loop_bwd(const void* h1, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, const void* x, const void* g, void* dh,
                 void* grads, void* slots, int R, int B, int H1, int HID,
                 int D, int G, int bf16, void* stream) {
  if (R <= 0 || B <= 0 || H1 <= 0 || HID <= 0 || D <= 0 || R % B != 0 ||
      G != hot_loop_bwd_groups(R))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hot_loop_bwd_smem_bytes(H1, HID);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fh1 = (const float*)h1, *fw1 = (const float*)w1,
              *fb1 = (const float*)b1, *fw2 = (const float*)w2,
              *fb2 = (const float*)b2, *fw3 = (const float*)w3,
              *fb3 = (const float*)b3, *fx = (const float*)x,
              *fg = (const float*)g;
  float *fdh = (float*)dh, *fgr = (float*)grads, *fsl = (float*)slots;
  return bf16 ? launch<true>(fh1, fw1, fb1, fw2, fb2, fw3, fb3, fx, fg, fdh,
                             fgr, fsl, R, B, H1, HID, D, G, smem, s)
              : launch<false>(fh1, fw1, fb1, fw2, fb2, fw3, fb3, fx, fg, fdh,
                              fgr, fsl, R, B, H1, HID, D, G, smem, s);
}

}  // extern "C"
