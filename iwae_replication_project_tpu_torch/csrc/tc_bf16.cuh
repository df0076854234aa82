// bf16 tensor-core building blocks shared by the bf16 paths of the hot-loop
// forward (hot_loop_fwd.cu, B1) and backward (hot_loop_bwd.cu, B2): the
// prepared-weight layout and the kernel that writes it, the weight ring fed
// by TMA bulk copies (its PTX wrappers in tma_ring.cuh), the mma.sync
// fragment helpers, and the forward row tile (a layer's product and its tanh
// epilogue, with B1's exact rounding).
//
// Products are mma.sync.m16n8k16 bf16 x bf16 -> fp32 on Hopper's tensor
// cores. Why mma.sync and not wgmma: the activation operand of every product
// is a warp's own 16 rows (h1, y1, y2, dl, dy2, dy1), held as A fragments in
// registers or in a warp's rows of shared memory; dl goes from the logits'
// accumulators straight into the A fragment of dl W3^T. A 16-row group walks
// its whole chain with no barrier but the weight ring's, and the rows per
// CTA can follow the row count of the call (16 to 128). wgmma would need
// 64-row warpgroup tiles, which leave the serving and training shapes
// (3200 and 5000 rows) with 50 to 80 CTAs for 132 SMs, and descriptor
// layouts for the activations of the transposed products too. Measured on
// the card the kernels are bound by per-warp latency (the epilogues' exp,
// log and tanh, the exact-rounding fixups), not by the MMA rate; wgmma
// is the next step once they are not.
//
// Layout of the prepared weights (bf16, written once per call by
// prep_weights): each weight W [K, N] is cut into 64-column tiles, each tile
// [KP][TS] contiguous with KP = K rounded up to 16, TS = 72 (8 padding
// columns, so ldmatrix rows fall in distinct banks) and zeros outside
// [0, K) x [0, N): W1 (K = H1, N = HID), then W2 (HID, HID), then W3
// (HID, D). A tile is the exact image of a ring slot, so one TMA bulk copy
// (cp.async.bulk, completion on an mbarrier) fills the slot. The same
// staged tile serves the forward product (ldmatrix .trans:
// B[k][n] = W[k][n]) and the transposed product of the backward
// (ldmatrix: B[k][n] = W[n][k] over the tile's 64 columns as k).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int NTILE = 64;       // columns of a staged weight tile
constexpr int TS = NTILE + 8;   // its row stride in shared memory (144 B:
                                // ldmatrix rows fall in distinct banks)
constexpr int STAGES = 3;       // ring slots
constexpr int MAX_WARPS = 8;    // warps of a CTA, 16 rows each
constexpr int MAX_ROWS = 16 * MAX_WARPS;

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int pad64(int v) { return (v + 63) & ~63; }
__host__ __device__ inline int tiles64(int v) { return (v + 63) / 64; }
__host__ __device__ inline size_t align256(size_t v) {
  return (v + 255) & ~(size_t)255;
}

// Widths of one call and everything derived from them.
struct Dims {
  int H1, HID, D;  // real widths
  int H1P, HP;     // reduction widths rounded up to the MMA's k = 16
  int nh, nd;      // 64-column tiles of a hidden layer and of the pixels
  int AS;          // row stride of an activation buffer (elements): the
                   // wider of H1P and HP plus 8, so ldmatrix rows fall in
                   // distinct banks
  int KPMAX;       // rows of a ring slot
  __host__ __device__ Dims(int h1, int hid, int d)
      : H1(h1), HID(hid), D(d), H1P(pad16(h1)), HP(pad16(hid)),
        nh(tiles64(hid)), nd(tiles64(d)),
        AS((pad16(h1) > pad16(hid) ? pad16(h1) : pad16(hid)) + 8),
        KPMAX(pad16(h1) > pad16(hid) ? pad16(h1) : pad16(hid)) {}
  // weight w (0, 1, 2 = W1, W2, W3): reduction rows of a tile, tiles, first
  // element of its tiles in the prepared buffer
  __host__ __device__ int kp(int w) const { return w == 0 ? H1P : HP; }
  __host__ __device__ int ntiles(int w) const { return w == 2 ? nd : nh; }
  __host__ __device__ size_t w_off(int w) const {
    const size_t t1 = (size_t)nh * H1P * TS, t2 = (size_t)nh * HP * TS;
    return w == 0 ? 0 : (w == 1 ? t1 : t1 + t2);
  }
  __host__ __device__ size_t prep_elems() const {
    return w_off(2) + (size_t)nd * HP * TS;
  }
  // dynamic shared memory of a CTA of `rows` rows: two activation buffers
  // and the ring
  __host__ __device__ size_t smem_bytes(int rows) const {
    return sizeof(bf16) *
           ((size_t)2 * rows * AS + (size_t)STAGES * KPMAX * TS);
  }
};

// The prepared weights: see the layout note at the top.
__global__ void prep_weights(const float* __restrict__ w1,
                             const float* __restrict__ w2,
                             const float* __restrict__ w3,
                             bf16* __restrict__ wp, Dims d) {
  const size_t total = d.prep_elems();
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int w = e < d.w_off(1) ? 0 : (e < d.w_off(2) ? 1 : 2);
    const size_t rel = e - d.w_off(w);
    const size_t tile = (size_t)d.kp(w) * TS;
    const int t = (int)(rel / tile), within = (int)(rel % tile);
    const int k = within / TS, n = t * NTILE + within % TS;
    const bool pad = within % TS >= NTILE;  // the slot's padding columns
    const int K = w == 0 ? d.H1 : d.HID, N = w == 2 ? d.D : d.HID;
    const float* src = w == 0 ? w1 : (w == 1 ? w2 : w3);
    wp[e] = __float2bfloat16_rn((!pad && k < K && n < N)
                                    ? src[(size_t)k * N + n]
                                    : 0.f);
  }
}

inline cudaError_t launch_prep(const float* w1, const float* w2,
                               const float* w3, bf16* wp, const Dims& d,
                               cudaStream_t stream) {
  const size_t want = (d.prep_elems() + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  prep_weights<<<blocks, 256, 0, stream>>>(w1, w2, w3, wp, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// smem_addr, cp.async, mbarriers and the TMA bulk copy: tma_ring.cuh
using tma::bulk_copy;
using tma::cp_async16;
using tma::cp_async_commit;
using tma::cp_async_wait;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_addr;

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives (row l / 4, columns 2 (l % 4), +1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: lane l receives (rows 2 (l % 4), +1, column l / 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even, as astype(bfloat16)); `lo`
// in the low half, the lower k or column of a fragment
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// The order in which a kernel consumes weight tiles: n segments, each all
// tiles of one weight in column order; segment i's weight (0, 1, 2) is bits
// 2i..2i+1 of `code`. Scalars only, so the ring stays in registers.
struct Schedule {
  int n;
  uint32_t code;
  __device__ __forceinline__ int weight(int i) const {
    return (code >> (2 * i)) & 3;
  }
  __device__ __forceinline__ void tile(const Dims& d, int idx, int& wi,
                                       int& t) const {
    wi = 0;
    t = 0;
    for (int i = 0; i < n; ++i) {
      const int w = weight(i), cnt = d.ntiles(w);
      if (idx < cnt) {
        wi = w;
        t = idx;
        return;
      }
      idx -= cnt;
    }
  }
  __device__ __forceinline__ int total(const Dims& d) const {
    int s = 0;
    for (int i = 0; i < n; ++i) s += d.ntiles(weight(i));
    return s;
  }
};

// Schedule code of weights w0, w1, ... in that order
__host__ __device__ constexpr uint32_t schedule_code(int w0, int w1 = 0,
                                                     int w2 = 0, int w3 = 0,
                                                     int w4 = 0, int w5 = 0,
                                                     int w6 = 0) {
  return (uint32_t)w0 | (uint32_t)w1 << 2 | (uint32_t)w2 << 4 |
         (uint32_t)w3 << 6 | (uint32_t)w4 << 8 | (uint32_t)w5 << 10 |
         (uint32_t)w6 << 12;
}

// STAGES slots of [KPMAX][TS], each filled by one TMA bulk copy that thread
// 0 starts, completion on the slot's mbarrier. next() waits for the oldest
// tile, then (one barrier, which also retires the slot the previous tile
// used) starts the copy of the tile STAGES - 1 ahead. `bars` (STAGES
// mbarriers in shared memory) are initialised by the constructor, which
// every thread of the CTA calls.
struct Ring {
  bf16* slots;
  uint64_t* bars;
  const bf16* wp;
  Dims d;
  Schedule s;
  int total, fetched, consumed;

  __device__ Ring(bf16* slots_, uint64_t* bars_, const bf16* wp_,
                  const Dims& d_, const Schedule& s_)
      : slots(slots_), bars(bars_), wp(wp_), d(d_), s(s_),
        total(s_.total(d_)), fetched(0), consumed(0) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  __device__ void fetch() {
    if (threadIdx.x == 0 && fetched < total) {
      int w, t;
      s.tile(d, fetched, w, t);
      const int kp = d.kp(w);
      // the slot's last readers passed the barrier before this call; order
      // their reads before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(slots + (size_t)(fetched % STAGES) * d.KPMAX * TS,
                wp + d.w_off(w) + (size_t)t * kp * TS,
                (uint32_t)(kp * TS * sizeof(bf16)), bars + fetched % STAGES);
    }
    ++fetched;
  }
  __device__ void prologue() {
    for (int i = 0; i < STAGES - 1; ++i) fetch();
  }
  __device__ const bf16* next() {
    const int slot = consumed % STAGES;
    mbar_wait(bars + slot, (consumed / STAGES) & 1);
    __syncthreads();
    fetch();
    ++consumed;
    return slots + (size_t)slot * d.KPMAX * TS;
  }
};

// ---------------------------------------------------------------------------
// Warp tiles. A warp owns 16 rows; `A` points at its first row. Fragment
// (C) layout of acc[j]: lane l holds rows l / 4 (elements 0, 1) and l / 4 + 8
// (elements 2, 3), columns 8 j + 2 (l % 4) and + 1.
// ---------------------------------------------------------------------------

// acc[j] = A[16 rows][0, KP) * W[0, KP)[8 j, 8 j + 8) for j < n8, from a
// staged tile `st` [KP][TS] of W; acc[j] = 0 for j >= n8.
__device__ __forceinline__ void tile_fwd(float acc[8][4], const bf16* A,
                                         int lda, int KP, const bf16* st,
                                         int n8) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* pa = A + ((q & 1) * 8 + (lane & 7)) * lda + (q >> 1) * 8;
  const bf16* pb = st + ((q & 1) * 8 + (lane & 7)) * TS + (q >> 1) * 8;
#pragma unroll 2
  for (int k0 = 0; k0 < KP; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, pa + k0);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      if (2 * jp < n8) {
        uint32_t b[4];
        ldsm_x4_t(b, pb + k0 * TS + jp * 16);
        mma(acc[2 * jp], a, b[0], b[1]);
        if (2 * jp + 1 < n8) mma(acc[2 * jp + 1], a, b[2], b[3]);
      }
  }
}

// k16 steps of a reduction held in registers: widths up to 240
constexpr int MAXK16 = 15;

// The A fragments of a warp's 16 rows, columns [0, KP) of a row-major bf16
// buffer [.][lda] (A points at the warp's first row), kept in registers
// across the column tiles of a layer.
__device__ __forceinline__ void load_afrags(uint32_t a[MAXK16][4],
                                            const bf16* A, int lda, int KP) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  const bf16* pa = A + ((q & 1) * 8 + (lane & 7)) * lda + (q >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < MAXK16; ++kk)
    if (16 * kk < KP) ldsm_x4(a[kk], pa + 16 * kk);
}

// tile_fwd with A in registers and the k loop unrolled, so the B fragments
// load ahead of the products. SEPARATE: each k16 step's product starts from
// zero and is added to acc in fp32, so the running sum rounds like a
// sequential fp32 sum instead of accumulating inside the tensor core.
// NJ column groups from column `col` of the tile (n8 of them valid).
template <int NJ, bool SEPARATE>
__device__ __forceinline__ void tile_fwd_r(float (&acc)[NJ][4],
                                           const uint32_t a[MAXK16][4],
                                           int KP, const bf16* st, int col,
                                           int n8) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bf16* pb = st + ((q & 1) * 8 + (lane & 7)) * TS + col + (q >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < MAXK16; ++kk)
    if (16 * kk < KP) {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp)
        if (2 * jp < n8) {
          uint32_t b[4];
          ldsm_x4_t(b, pb + 16 * kk * TS + jp * 16);
          if (SEPARATE) {
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
            mma(t0, a[kk], b[0], b[1]);
            mma(t1, a[kk], b[2], b[3]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[2 * jp][e] += t0[e];
              acc[2 * jp + 1][e] += t1[e];
            }
          } else {
            mma(acc[2 * jp], a[kk], b[0], b[1]);
            mma(acc[2 * jp + 1], a[kk], b[2], b[3]);
          }
        }
    }
}

// acc[j] += a * W_tile^T for the 16 x 16 A fragment `a` (k = the 16 tile
// columns from kk*16) and j < 2 * njp: B[k][n] = st[n][kk*16 + k], n over
// the tile's rows (the staged tile read the other way round).
template <int NJ>
__device__ __forceinline__ void tile_bwd(float (&acc)[NJ][4],
                                         const uint32_t a[4],
                                         const bf16* st, int kk, int njp) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  const bf16* pb = st + ((q >> 1) * 8 + (lane & 7)) * TS + kk * 16 +
                   (q & 1) * 8;
#pragma unroll
  for (int jp = 0; jp < NJ / 2; ++jp)
    if (jp < njp) {
      uint32_t b[4];
      ldsm_x4(b, pb + jp * 16 * TS);
      mma(acc[2 * jp], a, b[0], b[1]);
      mma(acc[2 * jp + 1], a, b[2], b[3]);
    }
}

// y = tanh(acc + bias[c]) for columns c = c0 + 8 j + 2 (l % 4) (+1) below N,
// else 0 (padding columns of a layer stay exactly zero); NJ column groups
template <int NJ>
__device__ __forceinline__ void bias_tanh(float (&y)[NJ][4],
                                          const float (&acc)[NJ][4], int c0,
                                          const float* __restrict__ bias,
                                          int N) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * j + cq + (e & 1);
      y[j][e] = c < N ? tanhf(acc[j][e] + bias[c]) : 0.f;
    }
}

// bf16 pairs of y into a warp's rows of a buffer [.][ld] (shared or global
// memory), n8 column groups from c0
template <int NJ>
__device__ __forceinline__ void store_pairs(const float (&y)[NJ][4], bf16* Y,
                                            int ld, int c0, int n8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < n8) {
      const int c = c0 + 8 * j + cq;
      *reinterpret_cast<uint32_t*>(Y + (size_t)g * ld + c) =
          pack(y[j][0], y[j][1]);
      *reinterpret_cast<uint32_t*>(Y + (size_t)(g + 8) * ld + c) =
          pack(y[j][2], y[j][3]);
    }
}

// The sums over a warp's 16 rows of the two columns a lane holds in one
// fragment column group: rows l / 4 and l / 4 + 8 first, then a butterfly
// over the 8 lanes of the same l % 4 (one fixed order; every lane ends with
// the same bits).
__device__ __forceinline__ float2 col_sums16(const float v[4]) {
  float s0 = v[0] + v[2], s1 = v[1] + v[3];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  return make_float2(s0, s1);
}

// bf16 copy of rows r0.. of the fp32 [R, H] matrix h into `buf` [rows][ld],
// columns [0, width) (zero past H and for rows past R); eight loads in flight
// per thread
__device__ __forceinline__ void load_rows_bf16(const float* __restrict__ h,
                                               bf16* buf, int ld, int rows,
                                               int width, int r0, int R,
                                               int H) {
  const int n = rows * width;
  for (int base = threadIdx.x; base < n; base += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * blockDim.x, r = e / width, c = e % width;
      v[u] = (e < n && r0 + r < R && c < H) ? h[(size_t)(r0 + r) * H + c]
                                            : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * blockDim.x;
      if (e < n)
        buf[(size_t)(e / width) * ld + e % width] = __float2bfloat16_rn(v[u]);
    }
  }
}

// softplus(l) = max(l, 0) + log(1 + exp(-|l|)) with the SFU's exp and log
// (absolute error ~1e-7 per pixel, far inside the kernels' tolerance)
__device__ __forceinline__ float softplus_fast(float l) {
  return fmaxf(l, 0.f) + __logf(1.f + __expf(-fabsf(l)));
}

// Exact rounding of the hidden layers, for B1. The plain version sums each
// pre-activation in fp32 one fused multiply-add per k, in increasing k, then
// rounds tanh to bf16 as the next product's operand. The tensor cores sum in
// another order, and where tanh lies within that difference of a bf16
// rounding boundary the value rounds to the other neighbour; one such flip
// moves a row's log-likelihood by up to a few 1e-2 nats. Measured on the
// card at the eval chunk: any other order, even the exact sum, leaves ~40
// of 125000 rows more than 1e-2 from the plain version. So each value
// whose tanh lies within FIX_DELTA of a boundary (in the pre-activation,
// scaled by tanh' and |p|; above the largest gap between the plain sum and
// the exact one measured, 3e-6) is summed again the plain way by its lane,
// from the same bf16 operands in shared memory, and overwritten. Every y1 is
// checked: a flip there shifts all of y2's pre-activations and can tip their
// roundings however small y1 is. y2 below FIX_MIN is left: a flip there
// moves y2 by at most 2^-11 and a row by ~1e-3.
constexpr float FIX_DELTA = 3.814697265625e-06f;  // 2^-18
constexpr float FIX_MIN = 0.125f;

template <int NJ>
__device__ __forceinline__ void exact_fixups(const float (&acc)[NJ][4],
                                             const float (&y)[NJ][4],
                                             const bf16* A, int lda, int K,
                                             const bf16* st, int col, int c0,
                                             const float* __restrict__ bias,
                                             int N, bf16* Y, int ldy,
                                             float min_abs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, cq = 2 * (lane & 3);
  uint32_t mask = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * j + cq + (e & 1);
      const float ay = fabsf(y[j][e]);
      if (c < N && ay >= min_abs) {
        const uint32_t u = __float_as_uint(ay);
        // one fp32 ulp of y, and y's distance to the bf16 rounding boundary
        const float ulp =
            __uint_as_float(u & 0x7f800000u) * 1.1920928955078125e-07f;
        const float dist = (float)abs((int)(u & 0xffffu) - 0x8000) * ulp;
        const float p = fabsf(acc[j][e] + bias[c]);
        if (dist <= (1.f - ay * ay) * FIX_DELTA * (1.f + 0.25f * p) + ulp)
          mask |= 1u << (4 * j + e);
      }
    }
  while (mask) {
    const int s = __ffs(mask) - 1;
    mask &= mask - 1;
    const int j = s >> 2, e = s & 3;
    const int c = c0 + 8 * j + cq + (e & 1), r = g + 8 * (e >> 1);
    const bf16* a = A + r * lda;
    const bf16* w = st + (c - c0) + col;
    float p = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)  // past K both operands are zero
      p = fmaf(__bfloat162float(a[k]), __bfloat162float(w[k * TS]), p);
    Y[r * ldy + c] = __float2bfloat16_rn(tanhf(p + bias[c]));
  }
}

// The forward of the block for a warp's 16 rows up to the logits, layer by
// layer through the ring: y1 = tanh(h1 W1 + b1) from buffer A into B, then
// y2 = tanh(y1 W2 + b2) from B into A (h1's rows are dead by then). EXACT:
// round like the plain version (exact_fixups). `y_out` receives each
// layer's bf16 tile too when not null (the backward keeps them as its
// weight-gradient operands): y1 at `y_out[0]`, y2 at `y_out[1]`, rows of
// stride `ldo`.
template <int NJ, bool EXACT>
__device__ __forceinline__ void forward_hidden(Ring& ring, const Dims& d,
                                               bf16* myA, bf16* myB,
                                               const float* __restrict__ b1,
                                               const float* __restrict__ b2,
                                               bf16* const* y_out, int ldo,
                                               int col) {
  float acc[NJ][4], y[NJ][4];
  uint32_t a[MAXK16][4];
  for (int layer = 0; layer < 2; ++layer) {
    const bf16* in = layer == 0 ? myA : myB;
    bf16* out = layer == 0 ? myB : myA;
    const int KP = layer == 0 ? d.H1P : d.HP;
    const float* bias = layer == 0 ? b1 : b2;
    for (int t = 0; t < d.nh; ++t) {
      const bf16* st = ring.next();  // for t = 0 also: h1 or y1 complete
      if (t == 0) load_afrags(a, in, d.AS, KP);
      const int c0 = t * NTILE + col;
      const int n8 = max(0, min(NJ, (d.HP - c0) / 8));
      tile_fwd_r<NJ, EXACT>(acc, a, KP, st, col, n8);
      bias_tanh(y, acc, c0, bias, d.HID);
      store_pairs(y, out, d.AS, c0, n8);
      // a flip in y1 moves the pre-activations of y2, where it can tip
      // further roundings however small y1 is: every y1 is checked
      if (EXACT)
        exact_fixups(acc, y, in, d.AS, layer == 0 ? d.H1 : d.HID, st, col, c0,
                     bias, d.HID, out, d.AS, layer == 0 ? 0.f : FIX_MIN);
      if (y_out) store_pairs(y, y_out[layer], ldo, c0, NJ);
    }
  }
}

// x[row][c] and b3[c] of a pixel tile's fragment columns (0 past D), loaded
// before the tile's products so their latency hides behind them
template <int NJ>
__device__ __forceinline__ void load_pixels(float (&xv)[NJ][4],
                                            float (&bv)[NJ][2],
                                            const float* __restrict__ xa,
                                            const float* __restrict__ xb,
                                            const float* __restrict__ b3,
                                            int c0, int D) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + cq + e;
      const bool in = c < D;
      bv[j][e] = in ? b3[c] : 0.f;
      xv[j][e] = in ? xa[c] : 0.f;
      xv[j][2 + e] = in ? xb[c] : 0.f;
    }
}

}  // namespace tc
}  // namespace
