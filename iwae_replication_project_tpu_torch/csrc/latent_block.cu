// Sample-level stochastic block for Hopper (sm_90a): one Gaussian conditional
// of the IWAE's 2-layer chain and its log-density, fused, for inference.
//
// Replaces no TPU kernel: the JAX package leaves this block to XLA, which
// fuses it. It was added because the port ran it as ~35 eager launches per
// block (four dense layers each bf16 casts, an fp32 CUDA-core GEMM, a bias
// add and a tanh; then exp, the floor, the draw and the Normal density), each
// a round trip of a [k, B, d] tensor through device memory: about 2 ms of a
// 3.9 ms k=5000 NLL chunk for 16 GFLOP. ops/latent_block.py is its wrapper
// and holds the plain version.
//
// What it computes, for each row r of in [R, IN] (R = k * B):
//   y1  = tanh(in[r] W1 + b1)                     [HID]
//   y2  = tanh(y1 W2 + b2)                        [HID]
//   mu  = y2 Wmu + bmu,  std = exp(y2 Wlstd + blstd) + std_floor   [L]
// then one of two epilogues:
//   sample  (q(h_i | h_{i-1}) of the encoder): h = mu + std * eps[r],
//           written to h_out [R, L], and lp_out[r] = sum_j log N(h_j; mu_j,
//           std_j);
//   density (p(h_{i-1} | h_i) of the prior chain): lp_out[r] = sum_j
//           log N(t[r, j]; mu_j, std_j) for the target t [R, L].
// log N(v; mu, std) is the plain version's own expression, z = (v - mu) /
// std, -0.5 z z - log(std) - log(2 pi) / 2, each step one rounded fp32 op
// (no contraction), exp and log at full fp32 accuracy. The matmul operands
// (in, y1, y2 and the four weights) are rounded to bf16 and the products
// accumulated in fp32, as the plain version's dense layers do; biases, tanh
// and the epilogue stay fp32. Neither y1, y2, mu nor std reach device
// memory.
//
// Bound at the eval chunk (k = 250, B = 500: R = 125000), bytes: the
// products are 2 R (IN HID + HID^2 + 2 HID L) = 7.5 GFLOP (q block, IN = 100,
// HID = 100, L = 50) and 8.75 GFLOP (p block, IN = 50, HID = 100, L = 100),
// 0.008 and 0.009 ms on the tensor cores (989 TFLOP/s); what must move is
// in, eps and h (q: 4 R (100 + 50 + 50) + 4 R = 100.5 MB, 0.030 ms at 3.35
// TB/s) or in and the target (p: 4 R (50 + 100) + 4 R = 75.5 MB, 0.022 ms).
// Every output column also pays an exp, a log and a division, and every
// hidden unit a tanh.
//
// Design (tc_bf16.cuh has the building blocks, and why mma.sync):
// - Launch anatomy: latent_prep writes bf16 copies of W1, W2 and the two
//   heads into the caller's scratch in the prepared layout of tc_bf16.cuh,
//   the heads as one weight of D = 2 L columns with their columns
//   interleaved (column 2j is Wmu[:, j], column 2j + 1 is Wlstd[:, j]); then
//   the row kernel. The wrapper counts the pair as one launch.
// - The interleave puts mu_j and lstd_j in one lane's accumulator pair
//   (mma.sync's c0, c1 and c2, c3): the epilogue needs no shuffle, and the
//   4 lanes of a row read 4 consecutive eps or target values.
// - The weights stay resident: all of them (97 KB for the q block, 115 KB
//   for the p block) land in shared memory by one TMA bulk copy when a CTA
//   starts, and the CTA is persistent, one per SM. Streaming them through
//   B1's ring instead (a 3-slot ring, every tile a CTA-wide barrier) took
//   0.40 ms a block at the eval chunk on an H100 (700 W), 14 times the
//   bound: the tiles are small, and each barrier waited for the slowest
//   warp of the CTA.
// - A CTA is 4 independent 16-row groups of 4 warps; each warp owns 16
//   columns of every 64-column tile. A group walks its own 16-row blocks
//   (block g, g + all groups, ...) and meets only its own warps, at named
//   barriers. While one block computes, cp.async copies the next block's
//   input rows and this block's eps or target rows into the group's shared
//   memory, so no warp waits on device memory in the chain. The input is
//   rounded to bf16 into the group's rows; y1 and y2 come from the tensor
//   cores with their tanh in registers and are stored as the next layer's
//   bf16 operands; the heads' tiles stay in the accumulators, where the
//   epilogue runs. The A fragments sit in registers, KS = 8 of them: the
//   reductions (IN and HID rounded up to 16) are at most 128 wide, which
//   holds the flagship's 100 and 50; wider blocks keep the unfused path.
// - No exact-rounding fixups (B1's tc::exact_fixups): the tensor cores sum
//   in another order than the plain version's GEMM, so a y1 or y2 within
//   that difference of a bf16 rounding boundary can round to the other
//   neighbour. Measured on an H100 at the eval chunk on the flagship's
//   initial weights, that moves a row's log q by at most 0.015 and a p
//   density by at most 1.9 (of |density| up to 1.4e4), against the plain
//   bf16 path's own spread from fp32 of 0.085 and 128: a sixth and a
//   sixtieth. The fixups cost 40% of the kernel's time (0.28 against
//   0.16 ms for the q block).
// - Row order: a row's density is summed over its columns per lane, then the
//   4 lanes of the row, then the 4 warps of the group, in one fixed order. No
//   atomics. Rows past R compute on zeros and are neither read nor written.

#include "tc_bf16.cuh"

namespace {

constexpr int WPG = 4;     // warps of a 16-row group
constexpr int GROUPS = 4;  // groups of a CTA
constexpr int THREADS = 32 * WPG * GROUPS;

// log(2 pi) / 2, as the plain version's Python float rounds to fp32
constexpr float HALF_LOG_2PI = 0.91893853320467274178f;

// Dynamic shared memory of a CTA: the prepared weights, then per group two
// activation buffers [16][AS] (bf16), the row partials [16][WPG], the input
// rows [16][IN] and the eps or target rows [16][L] (fp32, copied ahead).
inline size_t block_smem_bytes(const tc::Dims& d) {
  return d.prep_elems() * sizeof(tc::bf16) +
         GROUPS * (2 * 16 * d.AS * sizeof(tc::bf16) +
                   16 * (WPG + d.H1 + d.D / 2) * sizeof(float));
}

// The 4 warps of group `grp` meet (named barrier grp + 1; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(32 * WPG)
               : "memory");
}

// The prepared weights: tc_bf16.cuh's layout (tc::prep_weights) with W3 the
// two heads interleaved, [HID, D = 2 L].
__global__ void latent_prep(const float* __restrict__ w1,
                            const float* __restrict__ w2,
                            const float* __restrict__ wmu,
                            const float* __restrict__ wlstd,
                            tc::bf16* __restrict__ wp, tc::Dims d) {
  using namespace tc;
  const size_t total = d.prep_elems();
  const int L = d.D / 2;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int w = e < d.w_off(1) ? 0 : (e < d.w_off(2) ? 1 : 2);
    const size_t rel = e - d.w_off(w);
    const size_t tile = (size_t)d.kp(w) * TS;
    const int t = (int)(rel / tile), within = (int)(rel % tile);
    const int k = within / TS, n = t * NTILE + within % TS;
    const bool pad = within % TS >= NTILE;  // the slot's padding columns
    const int K = w == 0 ? d.H1 : d.HID, N = w == 2 ? d.D : d.HID;
    float v = 0.f;
    if (!pad && k < K && n < N) {
      if (w == 0)
        v = w1[(size_t)k * N + n];
      else if (w == 1)
        v = w2[(size_t)k * N + n];
      else
        v = ((n & 1) ? wlstd : wmu)[(size_t)k * L + (n >> 1)];
    }
    wp[e] = __float2bfloat16_rn(v);
  }
}

// log N(v; mu, std) of one element, the plain version's expression
__device__ __forceinline__ float normal_lp(float v, float mu, float sd) {
  const float z = __fdiv_rn(__fsub_rn(v, mu), sd);
  return __fsub_rn(__fsub_rn(__fmul_rn(__fmul_rn(-0.5f, z), z), logf(sd)),
                   HALF_LOG_2PI);
}

// One (mu, lstd) pair: the log-density term of `v` (the target), or in the
// sample mode of the draw mu + std v (v = eps), written to h_out[at].
template <bool SAMPLE>
__device__ __forceinline__ float head_term(float mu, float ls, float floor,
                                           float v, float* __restrict__ h_out,
                                           size_t at) {
  const float sd = __fadd_rn(expf(ls), floor);
  if (SAMPLE) {
    v = __fadd_rn(mu, __fmul_rn(sd, v));
    h_out[at] = v;
  }
  return normal_lp(v, mu, sd);
}

// Start copying rows r0 .. r0 + 15 of the fp32 [R, H] matrix `src` into
// `dst` [16][H] (zeros for rows past R), 4 bytes a cp.async, by the group's
// thread `t`; the caller commits and waits.
__device__ __forceinline__ void prefetch_rows(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int R, int H, int t) {
  const int n = 16 * H, valid = max(0, min(16, R - r0)) * H;
  const float* base = src + (size_t)r0 * H;
  for (int e = t; e < n; e += 32 * WPG)
    tma::cp_async4_zfill(dst + e, e < valid ? base + e : src,
                         e < valid ? 4u : 0u);
}

// The copied fp32 rows `x` [16][H] rounded to bf16 into `A` [16][ld],
// columns [0, width) (zero past H), by the group's thread `t`.
__device__ __forceinline__ void rows_to_bf16(tc::bf16* A, int ld, int width,
                                             const float* x, int H, int t) {
  for (int e = t; e < 16 * width; e += 32 * WPG) {
    const int r = e / width, c = e % width;
    A[r * ld + c] = __float2bfloat16_rn(c < H ? x[r * H + c] : 0.f);
  }
}

// The A fragments of a row block's 16 rows, KS k16 steps of them: the
// register budget of a block whose reductions are at most 16 KS wide.
constexpr int KS = 8;

// tc::load_afrags and tc::tile_fwd_r (two column groups, the products summed
// inside the tensor cores) with KS k16 steps in place of MAXK16.
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4],
                                       const tc::bf16* A, int lda, int KP) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  const tc::bf16* pa = A + ((q & 1) * 8 + (lane & 7)) * lda + (q >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (16 * kk < KP) tc::ldsm_x4(a[kk], pa + 16 * kk);
}

__device__ __forceinline__ void tile_mma(float (&acc)[2][4],
                                         const uint32_t (&a)[KS][4], int KP,
                                         const tc::bf16* st, int col,
                                         int n8) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (n8 <= 0) return;
  const tc::bf16* pb =
      st + ((q & 1) * 8 + (lane & 7)) * tc::TS + col + (q >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (16 * kk < KP) {
      uint32_t b[4];
      tc::ldsm_x4_t(b, pb + 16 * kk * tc::TS);
      tc::mma(acc[0], a[kk], b[0], b[1]);
      tc::mma(acc[1], a[kk], b[2], b[3]);
    }
}

// y1 = tanh(in W1 + b1) from A into B, then y2 = tanh(y1 W2 + b2) from B
// into A, for the group's 16 rows, from the resident weights `w`: the
// building blocks of tc::forward_hidden, with a group barrier in place of
// the ring's.
__device__ __forceinline__ void hidden_layers(const tc::Dims& d,
                                              const tc::bf16* w, tc::bf16* A,
                                              tc::bf16* B,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ b2,
                                              int col, int grp) {
  using namespace tc;
  float acc[2][4], y[2][4];
  uint32_t a[KS][4];
  for (int layer = 0; layer < 2; ++layer) {
    const bf16* src = layer == 0 ? A : B;
    bf16* dst = layer == 0 ? B : A;
    const int KP = d.kp(layer);
    const float* bias = layer == 0 ? b1 : b2;
    const bf16* wl = w + d.w_off(layer);
    load_a(a, src, d.AS, KP);
    for (int t = 0; t < d.nh; ++t) {
      const bf16* st = wl + (size_t)t * KP * TS;
      const int c0 = t * NTILE + col;
      const int n8 = max(0, min(2, (d.HP - c0) / 8));
      tile_mma(acc, a, KP, st, col, n8);
      bias_tanh(y, acc, c0, bias, d.HID);
      store_pairs(y, dst, d.AS, c0, n8);
    }
    group_sync(grp);  // dst complete; src's last reads done
  }
}

template <bool SAMPLE>
__global__ void __launch_bounds__(THREADS, 1)
    latent_block_tc(const tc::bf16* __restrict__ wp,
                    const float* __restrict__ in,
                    const float* __restrict__ b1,
                    const float* __restrict__ b2,
                    const float* __restrict__ bmu,
                    const float* __restrict__ blstd,
                    const float* __restrict__ noise,
                    float* __restrict__ h_out, float* __restrict__ lp_out,
                    int R, float std_floor, tc::Dims d) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / WPG, wg = warp % WPG, col = 16 * wg;
  const int gt = threadIdx.x % (32 * WPG);  // thread of the group
  const int L = d.D / 2;
  bf16* w = reinterpret_cast<bf16*>(smem_raw);
  bf16* A = w + d.prep_elems() + (size_t)grp * 2 * 16 * d.AS;
  bf16* B = A + 16 * d.AS;
  float* part = reinterpret_cast<float*>(w + d.prep_elems() +
                                         (size_t)GROUPS * 2 * 16 * d.AS) +
                grp * 16 * (WPG + d.H1 + L);
  float* xin = part + 16 * WPG;  // the next block's input rows
  float* nz = xin + 16 * d.H1;   // this block's eps or target rows
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_copy(w, wp, (uint32_t)(d.prep_elems() * sizeof(bf16)), &bar);

  const int g = lane >> 2, cq = 2 * (lane & 3);
  const int blocks = (R + 15) / 16, stride = gridDim.x * GROUPS;
  int blk = blockIdx.x * GROUPS + grp;
  if (blk < blocks) prefetch_rows(xin, in, 16 * blk, R, d.H1, gt);
  tma::cp_async_commit();
  mbar_wait(&bar, 0);
  for (; blk < blocks; blk += stride) {
    const int r0 = 16 * blk;
    tma::cp_async_wait<0>();
    group_sync(grp);  // this block's rows landed; last block's reads done
    rows_to_bf16(A, d.AS, d.H1P, xin, d.H1, gt);
    group_sync(grp);  // A complete, xin free
    prefetch_rows(nz, noise, r0, R, L, gt);
    if (blk + stride < blocks)
      prefetch_rows(xin, in, 16 * (blk + stride), R, d.H1, gt);
    tma::cp_async_commit();
    hidden_layers(d, w, A, B, b1, b2, col, grp);
    tma::cp_async_wait<0>();
    group_sync(grp);  // nz landed

    float sum_a = 0.f, sum_b = 0.f;
    float acc[2][4];
    uint32_t a[KS][4];
    load_a(a, A, d.AS, d.HP);  // y2, for every head tile
    const bf16* wh = w + d.w_off(2);
    for (int t = 0; t < d.nd; ++t) {
      const int c0 = t * NTILE + col;
      const int n8 = max(0, min(2, (d.D - c0 + 7) / 8));
      tile_mma(acc, a, d.HP, wh + (size_t)t * d.HP * TS, col, n8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + 8 * j + cq;  // even: mu_jl at c, lstd_jl at c + 1
        if (c < d.D) {
          const int jl = c >> 1;
          const float bm = bmu[jl], bl = blstd[jl];
          if (r0 + g < R)
            sum_a += head_term<SAMPLE>(acc[j][0] + bm, acc[j][1] + bl,
                                       std_floor, nz[g * L + jl], h_out,
                                       (size_t)(r0 + g) * L + jl);
          if (r0 + g + 8 < R)
            sum_b += head_term<SAMPLE>(acc[j][2] + bm, acc[j][3] + bl,
                                       std_floor, nz[(g + 8) * L + jl], h_out,
                                       (size_t)(r0 + g + 8) * L + jl);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    if ((lane & 3) == 0) {
      part[g * WPG + wg] = sum_a;
      part[(g + 8) * WPG + wg] = sum_b;
    }
    group_sync(grp);  // the partials complete
    if (gt < 16 && r0 + gt < R) {
      const float* p = part + gt * WPG;
      lp_out[r0 + gt] = ((p[0] + p[1]) + p[2]) + p[3];
    }
  }
}

template <bool SAMPLE>
cudaError_t launch_rows(dim3 grid, size_t smem, cudaStream_t s,
                        const tc::bf16* wp, const float* in, const float* b1,
                        const float* b2, const float* bmu,
                        const float* blstd, const float* noise, float* h_out,
                        float* lp_out, int R, float std_floor,
                        const tc::Dims& d) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        latent_block_tc<SAMPLE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  latent_block_tc<SAMPLE><<<grid, THREADS, smem, s>>>(
      wp, in, b1, b2, bmu, blstd, noise, h_out, lp_out, R, std_floor, d);
  return cudaGetLastError();
}

}  // namespace
extern "C" {

// Dynamic shared memory of a CTA at these widths (bytes).
size_t latent_block_smem_bytes(int IN, int HID, int L) {
  return block_smem_bytes(tc::Dims(IN, HID, 2 * L));
}

// 1 when the register budget takes these widths: a layer's A fragments sit
// in registers, so IN and HID rounded up to 16 are at most 16 KS = 128.
int latent_block_fits(int IN, int HID) {
  return tc::Dims(IN, HID, 2).KPMAX <= 16 * KS;
}

// Bytes of the scratch buffer a call takes: the prepared bf16 weights.
size_t latent_block_scratch_bytes(int IN, int HID, int L) {
  return tc::align256(tc::Dims(IN, HID, 2 * L).prep_elems() *
                      sizeof(tc::bf16));
}

// One call over R rows. Every pointer but `scratch` is a contiguous fp32
// device buffer: in [R, IN], w1 [IN, HID], b1 [HID], w2 [HID, HID], b2
// [HID], wmu and wlstd [HID, L], bmu and blstd [L], noise [R, L] (eps with
// sample = 1, the target with sample = 0), h_out [R, L] (sample = 1 only;
// may be null otherwise), lp_out [R]; scratch holds
// latent_block_scratch_bytes bytes (256-byte aligned). Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
int latent_block(const void* in, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* wmu,
                 const void* bmu, const void* wlstd, const void* blstd,
                 const void* noise, void* h_out, void* lp_out, void* scratch,
                 int R, int IN, int HID, int L, int sample, float std_floor,
                 void* stream) {
  if (R <= 0 || IN <= 0 || HID <= 0 || L <= 0 || !latent_block_fits(IN, HID) ||
      (sample && h_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const tc::Dims d(IN, HID, 2 * L);
  tc::bf16* wp = (tc::bf16*)scratch;
  const size_t want = (d.prep_elems() + 255) / 256;
  latent_prep<<<want < 1024 ? (int)want : 1024, 256, 0, s>>>(
      (const float*)w1, (const float*)w2, (const float*)wmu,
      (const float*)wlstd, wp, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // one persistent CTA per SM, or fewer where the rows need fewer groups
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks16 = (R + 15) / 16;
  const int ctas = (blocks16 + GROUPS - 1) / GROUPS;
  const size_t smem = block_smem_bytes(d);
  const dim3 grid(ctas < sms ? ctas : sms);
  const float *fin = (const float*)in, *fb1 = (const float*)b1,
              *fb2 = (const float*)b2, *fbmu = (const float*)bmu,
              *fbl = (const float*)blstd, *fnoise = (const float*)noise;
  float *fh = (float*)h_out, *flp = (float*)lp_out;
  if (sample)
    e = launch_rows<true>(grid, smem, s, wp, fin, fb1, fb2, fbmu, fbl,
                          fnoise, fh, flp, R, std_floor, d);
  else
    e = launch_rows<false>(grid, smem, s, wp, fin, fb1, fb2, fbmu, fbl,
                           fnoise, fh, flp, R, std_floor, d);
  return (int)e;
}

}  // extern "C"
