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
// It also serves the int8 weight-only policy (row_dense_int8 below): the
// JAX package's quantized decoder layer _dense_wq (ops/hot_loop.py:540-546,
// plain XLA there) went through torch.matmul here, which breaks C6 the same
// way, so it has a mode of this kernel.
//
// What it computes, for x [M, K], W [K, N], b [N] (contiguous fp32):
//   y[m, n] = act(b[n] + sum_k op(x[m, k]) op(W[k, n]))
// where op rounds to bf16 (round to nearest even, as .to(bfloat16)) when
// bf16 = 1 and is the identity otherwise, and act is tanh or the identity.
//
// The order of the sum, which is what keeps a row's bits the same in every
// bucket (contract C6):
//  - bf16: K is cut into P parts of whole 64-wide slabs, P a function of K
//    alone (1 up to K = 256, then ceil(slabs / 4), at most 8). In each part
//    one fp32 accumulator per output, starting at 0, takes the products of
//    the part's k16 steps in index order, K zero-padded to a multiple of 16,
//    each step one mma.sync.m16n8k16 (bf16 x bf16 -> fp32) on the tensor
//    cores; then the parts' sums are added in part order 0, 1, ..., P - 1;
//  - fp32: one chain of fused multiply-adds per output on the CUDA cores,
//    k = 0, 1, ..., K - 1 in order (then exact zeros up to the next multiple
//    of 16), never cut: bitwise the first version of this kernel;
// then the bias is added and act applied. None of it depends on M, on the
// tile a row lands in, on its place in the tile or on the grid: every tile
// of the menu walks the same steps with the same instruction per output,
// rows and columns start at multiples of 16 and 8 so an output keeps its
// place in its mma fragment. No atomics, no scratch in device memory: the
// parts meet in shared memory.
//
// Bound: 2 M K N operations against 4 (M K + K N + N + M N) bytes. At the
// serving shapes (K, N <= 784; M = a bucket of 1-64 rows for the encoder's
// first block and decode's output block, k x bucket <= 3200 rows for the
// rest) the bound is under a microsecond either way: bytes for most
// layers, the CUDA cores' rate for the wider fp32 ones. What holds the
// kernel back is latency, and on the card (PERF.md §6) the bytes one
// CTA pulls through its SM, at a rate far under the SM's: the 64-row,
// K = 784 layer needs more CTAs than its output tiles give.
//
// int8 mode: for x [M, K] fp32, W_q [K, N] int8, scale [N] and b [N] fp32,
//   y[m, n] = act(fl(fl(sum_k x[m, k] float(W_q[k, n])) * scale[n]) + b[n])
// with the sum fp32's one FMA chain (k in order, never cut) and the
// epilogue a rounded multiply, then a rounded add, as (x @ w_q) * scale + b
// rounds it. W_q is staged as bytes (4-byte cp.async where N % 4 == 0) and
// converted to fp32 as each value is read from shared memory; the tile menu,
// the plan and the ring are fp32's, so a row's bits are as invariant. Bound:
// 2 M K N operations against 4 M K + K N + 8 N + 4 M N bytes; the weights
// move a quarter of fp32's bytes, which is the policy's point where a
// layer is bound by its weights (a bucket's few rows).
//
// Design:
//  - the grid: output tiles from a fixed menu (64x64, 32x64, 16x64, 16x32),
//    chosen by the caller from (M, N) alone (ops/row_invariant.dense_tile:
//    the largest tile that still gives each of the 132 SMs a CTA, else the
//    smallest), times the P parts of K along z, the parts of a tile one
//    thread-block cluster. 64x784x200 in bf16 runs 28 tiles x 4 parts,
//    3200x100x100 200 tiles;
//  - the loads: x and W stream through shared memory in slabs of 64 along K
//    by cp.async (16-byte copies where K, or N, is a multiple of 4 and the
//    base is aligned, 4-byte ones otherwise; zero-filled past M, N and K),
//    in a ring of 3-8 slots (about 110 KB a CTA), so the next slabs' copies
//    are in flight while this one's products run; a part of up to seven
//    slabs on a 16-row tile (every served one) is in flight whole from the
//    start;
//  - bf16: the CTA's four warps each own 16 rows by 8-64 columns. A and B
//    fragments are packed from the fp32 slab with the round to nearest even
//    (cvt.rn.bf16x2.f32, tc::pack) as they are read, so the staged operands
//    stay fp32 and one loader serves both types (ldmatrix needs bf16 in
//    shared memory, which a copy engine cannot round to);
//  - fp32: each thread owns TM x TN outputs spread over the tile (rows
//    16 apart, columns 8 apart: the warp's reads of the slab fall in
//    distinct banks or broadcast);
//  - the epilogue: accumulators go through shared memory, so bias, tanh and
//    the stores run row-major with neighbouring threads on neighbouring
//    columns; with P parts each CTA of the cluster finishes a share of the
//    tile, reading the P partial tiles through distributed shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>
#include <type_traits>

#include "tc_bf16.cuh"

namespace cg = cooperative_groups;

namespace {
namespace rd {

constexpr int THREADS = 128;   // four warps
constexpr int BK = 64;         // a slab's extent along K
constexpr int XS = BK + 8;     // row stride of a staged x slab (floats)
constexpr int RING_BYTES = 114688;
constexpr int MAX_STAGES = 8;

// the menu of output tiles; the C interface's `tile` indexes it
constexpr int NTILES = 4;
constexpr int TILE_M[NTILES] = {64, 32, 16, 16};
constexpr int TILE_N[NTILES] = {64, 64, 64, 32};

template <int BM, int BN>
struct Tile {
  static constexpr int WS = BN + 4;  // row stride of a staged W slab
  static constexpr int CS = BN + 4;  // row stride of the epilogue's tile
  static constexpr int STAGE = BM * XS + BK * WS;  // floats in a slot
  static constexpr int STAGES =
      RING_BYTES / (STAGE * 4) < MAX_STAGES ? RING_BYTES / (STAGE * 4)
                                            : MAX_STAGES;
  static_assert(STAGES >= 2, "a ring needs two slots");
  static_assert(BM * CS <= STAGE, "the epilogue reuses slot 0");
};

// x rows [m0, m0 + BM), k in [k0, k0 + BK), into a slot's x slab [BM][XS];
// zeros outside [0, M) x [0, K)
template <int BM>
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x,
                                       long m0, int k0, int M, int K,
                                       bool vx) {
  if (vx) {
    for (int c = threadIdx.x; c < BM * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), q = (c % (BK / 4)) * 4;
      const long m = m0 + r;
      const int k = k0 + q;
      const bool in = m < M && k < K;  // K % 4 == 0: all four or none
      tma::cp_async16_zfill(xs + r * XS + q, in ? x + m * K + k : x,
                            in ? 16u : 0u);
    }
  } else {
    for (int c = threadIdx.x; c < BM * BK; c += THREADS) {
      const int r = c / BK, q = c % BK;
      const long m = m0 + r;
      const int k = k0 + q;
      const bool in = m < M && k < K;
      tma::cp_async4_zfill(xs + r * XS + q, in ? x + m * K + k : x,
                           in ? 4u : 0u);
    }
  }
}

// x rows [m0, m0 + BM) and W columns [n0, n0 + BN), k in [k0, k0 + BK),
// into one slot of the ring; zeros outside [0, M) x [0, K) x [0, N)
template <int BM, int BN>
__device__ __forceinline__ void load_slab(float* slot,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          long m0, int n0, int k0, int M,
                                          int K, int N, bool vx, bool vw) {
  typedef Tile<BM, BN> T;
  float* ws = slot + BM * XS;
  load_x<BM>(slot, x, m0, k0, M, K, vx);
  if (vw) {
    for (int c = threadIdx.x; c < BK * (BN / 4); c += THREADS) {
      const int r = c / (BN / 4), q = (c % (BN / 4)) * 4;
      const int k = k0 + r, n = n0 + q;
      const bool in = k < K && n < N;  // N % 4 == 0: all four or none
      tma::cp_async16_zfill(ws + r * T::WS + q,
                            in ? w + (long)k * N + n : w, in ? 16u : 0u);
    }
  } else {
    for (int c = threadIdx.x; c < BK * BN; c += THREADS) {
      const int r = c / BN, q = c % BN;
      const int k = k0 + r, n = n0 + q;
      const bool in = k < K && n < N;
      tma::cp_async4_zfill(ws + r * T::WS + q, in ? w + (long)k * N + n : w,
                           in ? 4u : 0u);
    }
  }
}

// The products of one staged slab, `steps` k16 steps of it, into the
// thread's accumulators. bf16: warp `wid` owns rows [wr, wr + 16) and
// columns [wc, wc + 8 NT) of the tile, acc[j] one m16n8 fragment.
template <int BM, int BN>
struct Bf16Math {
  static constexpr int RG = BM / 16;      // warps along the rows
  static constexpr int WC = 4 / RG;       // warps along the columns
  static constexpr int NT = BN / WC / 8;  // n8 fragments of a warp
  static constexpr int ACC = NT * 4;
  static_assert(RG * WC == 4 && NT >= 1, "four warps cover the tile");

  __device__ static void slab(float (&acc)[ACC], const float* slot,
                              int steps) {
    typedef Tile<BM, BN> T;
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = (wid / WC) * 16, wc = (wid % WC) * (BN / WC);
    const float* xa = slot + (wr + g) * XS + 2 * t;
    const float* wb = slot + BM * XS + 2 * t * T::WS + wc + g;
    for (int s = 0; s < steps; ++s) {
      const int kk = 16 * s;
      // A: rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9
      const float2 p0 = *reinterpret_cast<const float2*>(xa + kk);
      const float2 p1 = *reinterpret_cast<const float2*>(xa + 8 * XS + kk);
      const float2 p2 = *reinterpret_cast<const float2*>(xa + kk + 8);
      const float2 p3 =
          *reinterpret_cast<const float2*>(xa + 8 * XS + kk + 8);
      const uint32_t a[4] = {tc::pack(p0.x, p0.y), tc::pack(p1.x, p1.y),
                             tc::pack(p2.x, p2.y), tc::pack(p3.x, p3.y)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B: rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g of fragment j
        const float* pb = wb + kk * T::WS + 8 * j;
        const uint32_t b0 = tc::pack(pb[0], pb[T::WS]);
        const uint32_t b1 = tc::pack(pb[8 * T::WS], pb[9 * T::WS]);
        tc::mma(&acc[4 * j], a, b0, b1);
      }
    }
  }

  // the accumulators into the epilogue's tile [BM][CS]
  __device__ static void store(const float (&acc)[ACC], float* cs) {
    typedef Tile<BM, BN> T;
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = (wid / WC) * 16, wc = (wid % WC) * (BN / WC);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* p = cs + (wr + g) * T::CS + wc + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * T::CS) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// fp32: thread (tx, ty) = (tid % 8, tid / 8) owns rows ty + 16 i and columns
// tx + 8 j of the tile
template <int BM, int BN>
struct Fp32Math {
  static constexpr int TM = BM / 16, TN = BN / 8;
  static constexpr int ACC = TM * TN;

  __device__ static void slab(float (&acc)[ACC], const float* slot,
                              int steps) {
    typedef Tile<BM, BN> T;
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
    const float* xa = slot + ty * XS;
    const float* wb = slot + BM * XS + tx;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int kk = 16 * s; kk < 16 * s + 16; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xa[16 * i * XS + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = wb[kk * T::WS + 8 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i * TN + j] = fmaf(a[i], b[j], acc[i * TN + j]);
      }
    }
  }

  __device__ static void store(const float (&acc)[ACC], float* cs) {
    typedef Tile<BM, BN> T;
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        cs[(ty + 16 * i) * T::CS + tx + 8 * j] = acc[i * TN + j];
  }
};

// The parts of K: `splits` ranges of whole slabs, part p taking slabs
// [p nslab / splits, (p + 1) nslab / splits). bf16 splits a K of more than
// four slabs into up to 8 parts of about four slabs, each part a CTA of one
// cluster; fp32 never splits (its chain is the first version's). A function
// of K (and the type) alone.
__host__ __device__ inline int splits(int K, bool bf16) {
  const int nslab = (K + BK - 1) / BK;
  if (!bf16 || nslab <= 4) return 1;
  const int s = (nslab + 3) / 4;
  return s < 8 ? s : 8;
}

// y[m, n] = act(v + b[n])
template <bool TANH>
__device__ __forceinline__ void finish(float v, const float* __restrict__ b,
                                       float* __restrict__ y, long m, int n,
                                       int N) {
  v += b[n];
  if (TANH) v = tanhf(v);
  y[m * N + n] = v;
}

// One CTA: the tile (blockIdx.x, blockIdx.y) over part blockIdx.z of K. With
// one part the CTA finishes its tile; with several, the cluster's CTAs (one
// per part, gridDim.z of them) leave their partial tiles in shared memory
// and each finishes a share of the tile's outputs, adding the parts in
// order 0, 1, ... through distributed shared memory.
template <bool BF16, bool TANH, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
    row_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y,
                     int M, int K, int N, bool vx, bool vw) {
  typedef Tile<BM, BN> T;
  typedef typename std::conditional<BF16, Bf16Math<BM, BN>,
                                    Fp32Math<BM, BN>>::type Math;
  extern __shared__ __align__(16) float smem[];
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nslab = (K + BK - 1) / BK;
  const int k16 = (K + 15) / 16;  // k16 steps, K zero-padded
  const int parts = gridDim.z, part = blockIdx.z;
  const int first = (int)((long)part * nslab / parts);
  const int count = (int)((long)(part + 1) * nslab / parts) - first;

  float acc[Math::ACC];
#pragma unroll
  for (int i = 0; i < Math::ACC; ++i) acc[i] = 0.f;

  // the ring: the part's slab j in slot j % STAGES; one commit group per
  // slab (empty past the last), so waiting for all but STAGES - 2 groups
  // means slab j has landed
#pragma unroll
  for (int j = 0; j < T::STAGES - 1; ++j) {
    if (j < count)
      load_slab<BM, BN>(smem + j * T::STAGE, x, w, m0, n0, (first + j) * BK,
                        M, K, N, vx, vw);
    tma::cp_async_commit();
  }
  for (int j = 0; j < count; ++j) {
    tma::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // slab j is in; slab j - 1's slot is free
    const int nxt = j + T::STAGES - 1;
    if (nxt < count)
      load_slab<BM, BN>(smem + (nxt % T::STAGES) * T::STAGE, x, w, m0, n0,
                        (first + nxt) * BK, M, K, N, vx, vw);
    tma::cp_async_commit();
    const int left = k16 - 4 * (first + j);
    Math::slab(acc, smem + (j % T::STAGES) * T::STAGE, left < 4 ? left : 4);
  }
  tma::cp_async_wait<0>();
  __syncthreads();

  float* cs = smem;
  Math::store(acc, cs);
  if (parts == 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (m0 + r < M && n0 + c < N)
        finish<TANH>(cs[r * T::CS + c], b, y, m0 + r, n0 + c, N);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every part's tile is in its CTA's shared memory
  for (int e = (int)cluster.block_rank() * THREADS + threadIdx.x;
       e < BM * BN; e += parts * THREADS) {
    const int r = e / BN, c = e % BN;
    if (m0 + r < M && n0 + c < N) {
      float* at = cs + r * T::CS + c;
      float v = *cluster.map_shared_rank(at, 0);
      for (int q = 1; q < parts; ++q) v += *cluster.map_shared_rank(at, q);
      finish<TANH>(v, b, y, m0 + r, n0 + c, N);
    }
  }
  cluster.sync();  // no CTA leaves while the others read its shared memory
}

// ---------------------------------------------------------------------------
// int8-weight mode: fp32 x, int8 W_q staged as bytes, fp32's FMA chain
// ---------------------------------------------------------------------------

template <int BM, int BN>
struct QTile {
  static constexpr int WQS = BN + 16;  // row stride of a staged W_q slab (B)
  static constexpr int XBYTES = BM * XS * 4;
  static constexpr int STAGE = XBYTES + BK * WQS;  // bytes in a slot
  static constexpr int STAGES =
      RING_BYTES / STAGE < MAX_STAGES ? RING_BYTES / STAGE : MAX_STAGES;
  static_assert(STAGES >= 2, "a ring needs two slots");
  static_assert(STAGE % 16 == 0, "slots stay 16-byte aligned");
  static_assert(BM * Tile<BM, BN>::CS * 4 <= STAGE,
                "the epilogue reuses slot 0");
};

// W_q columns [n0, n0 + BN), k in [k0, k0 + BK), into a slot's byte slab
// [BK][WQS]; zeros outside [0, K) x [0, N). vw: N % 4 == 0 and W_q 4-byte
// aligned, four weights a copy; else plain byte loads and stores, which the
// ring's barrier orders like the copies.
template <int BN>
__device__ __forceinline__ void load_wq(int8_t* ws,
                                        const int8_t* __restrict__ w, int n0,
                                        int k0, int K, int N, bool vw) {
  constexpr int WQS = BN + 16;
  if (vw) {
    for (int c = threadIdx.x; c < BK * (BN / 4); c += THREADS) {
      const int r = c / (BN / 4), q = (c % (BN / 4)) * 4;
      const int k = k0 + r, n = n0 + q;
      const bool in = k < K && n < N;  // N % 4 == 0: all four or none
      tma::cp_async4_zfill(ws + r * WQS + q, in ? w + (long)k * N + n : w,
                           in ? 4u : 0u);
    }
  } else {
    for (int c = threadIdx.x; c < BK * BN; c += THREADS) {
      const int r = c / BN, q = c % BN;
      const int k = k0 + r, n = n0 + q;
      ws[r * WQS + q] = (k < K && n < N) ? w[(long)k * N + n] : (int8_t)0;
    }
  }
}

// the products of one staged slab, as Fp32Math's, each weight converted
// from its byte as it is read (an int8 value is exact in fp32)
template <int BM, int BN>
__device__ __forceinline__ void q_slab(float (&acc)[(BM / 16) * (BN / 8)],
                                       const unsigned char* slot,
                                       int steps) {
  typedef QTile<BM, BN> T;
  constexpr int TM = BM / 16, TN = BN / 8;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const float* xa = reinterpret_cast<const float*>(slot) + ty * XS;
  const int8_t* wb = reinterpret_cast<const int8_t*>(slot + T::XBYTES) + tx;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int kk = 16 * s; kk < 16 * s + 16; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xa[16 * i * XS + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = (float)wb[kk * T::WQS + 8 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i * TN + j] = fmaf(a[i], b[j], acc[i * TN + j]);
    }
  }
}

// One CTA: the tile (blockIdx.x, blockIdx.y) over the whole of K, the ring
// and the loop of row_dense_kernel with one part
template <bool TANH, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
    row_dense_int8_kernel(const float* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ b,
                          float* __restrict__ y, int M, int K, int N,
                          bool vx, bool vw) {
  typedef QTile<BM, BN> T;
  extern __shared__ __align__(16) unsigned char qsmem[];
  const long m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nslab = (K + BK - 1) / BK;
  const int k16 = (K + 15) / 16;

  float acc[Fp32Math<BM, BN>::ACC];
#pragma unroll
  for (int i = 0; i < Fp32Math<BM, BN>::ACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int j = 0; j < T::STAGES - 1; ++j) {
    if (j < nslab) {
      unsigned char* slot = qsmem + j * T::STAGE;
      load_x<BM>(reinterpret_cast<float*>(slot), x, m0, j * BK, M, K, vx);
      load_wq<BN>(reinterpret_cast<int8_t*>(slot + T::XBYTES), w, n0, j * BK,
                  K, N, vw);
    }
    tma::cp_async_commit();
  }
  for (int j = 0; j < nslab; ++j) {
    tma::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // slab j is in; slab j - 1's slot is free
    const int nxt = j + T::STAGES - 1;
    if (nxt < nslab) {
      unsigned char* slot = qsmem + (nxt % T::STAGES) * T::STAGE;
      load_x<BM>(reinterpret_cast<float*>(slot), x, m0, nxt * BK, M, K, vx);
      load_wq<BN>(reinterpret_cast<int8_t*>(slot + T::XBYTES), w, n0,
                  nxt * BK, K, N, vw);
    }
    tma::cp_async_commit();
    const int left = k16 - 4 * j;
    q_slab<BM, BN>(acc, qsmem + (j % T::STAGES) * T::STAGE,
                   left < 4 ? left : 4);
  }
  tma::cp_async_wait<0>();
  __syncthreads();

  typedef Tile<BM, BN> F;
  float* cs = reinterpret_cast<float*>(qsmem);
  Fp32Math<BM, BN>::store(acc, cs);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const long m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      float v = __fadd_rn(__fmul_rn(cs[r * F::CS + c], scale[n]), b[n]);
      if (TANH) v = tanhf(v);
      y[m * N + n] = v;
    }
  }
}

template <bool TANH, int BM, int BN>
cudaError_t allow_ring_q() {
  typedef QTile<BM, BN> T;
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? (uint64_t)1 << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(row_dense_int8_kernel<TANH, BM, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::STAGES * T::STAGE);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <bool TANH, int BM, int BN>
cudaError_t launch_q(const float* x, const int8_t* w, const float* scale,
                     const float* b, float* y, int M, int K, int N,
                     cudaStream_t s) {
  typedef QTile<BM, BN> T;
  const cudaError_t attr = allow_ring_q<TANH, BM, BN>();
  if (attr != cudaSuccess) return attr;
  const int nslab = (K + BK - 1) / BK;
  const size_t smem = (size_t)(nslab < T::STAGES ? nslab : T::STAGES) *
                      T::STAGE;
  const bool vx = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vw = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  row_dense_int8_kernel<TANH, BM, BN><<<grid, THREADS, smem, s>>>(
      x, w, scale, b, y, M, K, N, vx, vw);
  return cudaGetLastError();
}

template <bool TANH>
cudaError_t launch_q_tile(int tile, const float* x, const int8_t* w,
                          const float* scale, const float* b, float* y,
                          int M, int K, int N, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_q<TANH, 64, 64>(x, w, scale, b, y, M, K, N, s);
    case 1: return launch_q<TANH, 32, 64>(x, w, scale, b, y, M, K, N, s);
    case 2: return launch_q<TANH, 16, 64>(x, w, scale, b, y, M, K, N, s);
    default: return launch_q<TANH, 16, 32>(x, w, scale, b, y, M, K, N, s);
  }
}

inline long ctas(int M, int N, int K, bool bf16, int tile) {
  return (long)((M + TILE_M[tile] - 1) / TILE_M[tile]) *
         ((N + TILE_N[tile] - 1) / TILE_N[tile]) * splits(K, bf16);
}

// The kernel's ring above the default 48 KB of shared memory: set once per
// device (an attribute of the function in each device's context)
template <bool BF16, bool TANH, int BM, int BN>
cudaError_t allow_ring() {
  typedef Tile<BM, BN> T;
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? (uint64_t)1 << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(row_dense_kernel<BF16, TANH, BM, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::STAGES * T::STAGE * 4);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <bool BF16, bool TANH, int BM, int BN>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int M, int K, int N, cudaStream_t s) {
  typedef Tile<BM, BN> T;
  const cudaError_t attr = allow_ring<BF16, TANH, BM, BN>();
  if (attr != cudaSuccess) return attr;
  const int nslab = (K + BK - 1) / BK;
  const size_t smem =
      (size_t)(nslab < T::STAGES ? nslab : T::STAGES) * T::STAGE * 4;
  const bool vx = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vw = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int parts = splits(K, BF16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BM - 1) / BM, (N + BN - 1) / BN, parts);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = parts;
  cfg.attrs = cluster;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, row_dense_kernel<BF16, TANH, BM, BN>, x, w, b, y, M, K, N, vx,
      vw);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool BF16, bool TANH>
cudaError_t launch_tile(int tile, const float* x, const float* w,
                        const float* b, float* y, int M, int K, int N,
                        cudaStream_t s) {
  switch (tile) {
    case 0: return launch<BF16, TANH, 64, 64>(x, w, b, y, M, K, N, s);
    case 1: return launch<BF16, TANH, 32, 64>(x, w, b, y, M, K, N, s);
    case 2: return launch<BF16, TANH, 16, 64>(x, w, b, y, M, K, N, s);
    default: return launch<BF16, TANH, 16, 32>(x, w, b, y, M, K, N, s);
  }
}

}  // namespace rd
}  // namespace

extern "C" {

// CTAs of a call with output tile `tile` of the menu (the grid the launch
// uses: the tiles times the parts of K), or -1 for a tile outside the menu.
long long row_dense_ctas(int M, int N, int K, int bf16, int tile) {
  if (tile < 0 || tile >= rd::NTILES || M <= 0 || N <= 0 || K <= 0)
    return -1;
  return rd::ctas(M, N, K, bf16 != 0, tile);
}

// y [M, N] = act(x [M, K] W [K, N] + b [N]); every pointer a contiguous fp32
// device buffer. bf16 = 1 rounds x and W to bf16 before the products; act = 1
// applies tanh; `tile` indexes the menu of output tiles (64x64, 32x64,
// 16x64, 16x32), the caller's choice from (M, N). Launches on `stream`
// without synchronising and returns the CUDA error code (0 on success).
int row_dense(const void* x, const void* w, const void* b, void* y, int M,
              int K, int N, int bf16, int act, int tile, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || tile < 0 || tile >= rd::NTILES ||
      (N + rd::TILE_N[tile] - 1) / rd::TILE_N[tile] > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fx = (const float*)x, *fw = (const float*)w,
              *fb = (const float*)b;
  float* fy = (float*)y;
  cudaError_t rc;
  if (bf16)
    rc = act ? rd::launch_tile<true, true>(tile, fx, fw, fb, fy, M, K, N, s)
             : rd::launch_tile<true, false>(tile, fx, fw, fb, fy, M, K, N, s);
  else
    rc = act ? rd::launch_tile<false, true>(tile, fx, fw, fb, fy, M, K, N, s)
             : rd::launch_tile<false, false>(tile, fx, fw, fb, fy, M, K, N,
                                             s);
  return (int)rc;
}

// y [M, N] = act((x [M, K] W_q [K, N]) * scale [N] + b [N]): x, scale, b
// and y contiguous fp32 device buffers, W_q a contiguous int8 one; act = 1
// applies tanh; `tile` indexes the menu as row_dense's. Each output is one
// fp32 FMA chain over K in order (K never cut), then the rounded multiply
// by scale and the rounded add of b. Launches on `stream` without
// synchronising and returns the CUDA error code (0 on success).
int row_dense_int8(const void* x, const void* w_q, const void* scale,
                   const void* b, void* y, int M, int K, int N, int act,
                   int tile, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || tile < 0 || tile >= rd::NTILES ||
      (N + rd::TILE_N[tile] - 1) / rd::TILE_N[tile] > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fx = (const float*)x, *fs = (const float*)scale,
              *fb = (const float*)b;
  const int8_t* fw = (const int8_t*)w_q;
  float* fy = (float*)y;
  const cudaError_t rc =
      act ? rd::launch_q_tile<true>(tile, fx, fw, fs, fb, fy, M, K, N, s)
          : rd::launch_q_tile<false>(tile, fx, fw, fs, fb, fy, M, K, N, s);
  return (int)rc;
}

}  // extern "C"
