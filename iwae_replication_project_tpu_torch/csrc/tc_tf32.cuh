// 3xTF32 tensor-core building blocks of the fused Bernoulli log-likelihood's
// forward (fused_ll_fwd.cu, B3) and backward (fused_ll_bwd.cu, B4): fp32
// accuracy from the TF32 tensor cores, the prepared-weight layout and the
// kernel that writes it, the row staging in fragment order, and the warp
// tiles of l = h W and dh = dl W^T.
//
// 3xTF32. The tensor cores read only the top 19 bits of an fp32 register
// (TF32: 10 mantissa bits), so every operand is rounded first, as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero): v = hi + lo
// with hi = rna(v) and lo = rna(v - hi). A product a b is then
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three mma.sync.m16n8k8 tf32 x tf32 ->
// fp32 into one fp32 accumulator (the small terms first); the dropped
// lo_a lo_b is ~2^-22 of the product. One TF32 pass would put a third of the
// flagship's rows outside the kernels' tolerance
// (tests/test_torch_tf32_split.py holds both on the CPU).
//
// Splitting costs more than the products: ptxas expands cvt.rna.tf32.f32
// into about four instructions (with checks for NaN), and mma.sync's TF32
// rate on an H100 halves when each product also splits two operands
// (scripts/tf32_mma_rate.cu, PERF.md). So:
// - rna is an integer add of half a TF32 ulp and a mask (two instructions,
//   the bits of cvt.rna for every finite value);
// - h is split once per CTA when its rows are staged, and dl once, by the
//   warp that forms it; W is staged in fp32 and split in the product loop,
//   where its 2 x 57.6 KB of hi and lo per tile would not fit beside the
//   rows, and where a 32-column hi/lo tile doubled the shared-memory bytes
//   per product and made B3 slower (PERF.md).
//
// Prepared weights (fp32, written once per call by prep_weights): W [H, D]
// cut into 64-column tiles, each [KP][TS] contiguous with KP = H rounded up
// to 8 (the MMA's k), TS = 72 (8 padding columns) and zeros outside
// [0, H) x [0, D). A tile is the exact image of a ring slot (tma_ring.cuh),
// filled by one TMA bulk copy; two slots (a tile's copy overlaps the
// previous tile's products) leave room for the split rows. TS = 72 = 8 mod
// 32 makes both reads of a slot conflict-free: the forward's B fragment
// (W[k0 + t][n0 + g], lanes t = l % 4 on rows, g = l / 4 on columns) and
// the backward's (W[n0 + g][k0 + 2t], W[.][k0 + 2t + 1], one 8-byte load).
//
// The backward's k = pixels is permuted in each k8 step: fragment column t
// stands for pixel 2t and t + 4 for pixel 2t + 1. Then the A fragment of
// dl W^T is exactly the accumulator of the forward's n8 group, (c0, c2, c1,
// c3), and its B fragment is two neighbouring pixels of one row of W. A sum
// over k does not depend on the order its terms are named in.
//
// Rows: a warp owns 16 rows (the MMA's m) and two n8 groups of each
// 64-column tile, wq and wq + 4 for warp wq (so the two n8 groups of
// D = 784's last tile go to two warps); the 4 warps of a 16-row group share
// the group's h rows, staged split, in fragment order: [hi, lo][k8 step]
// [lane] float4 {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}, two
// conflict-free 16-byte loads per k8 step. The forward sums even and odd k8
// steps in two accumulator chains (added at the end, one fixed order), so
// one step's loads and rounding overlap the other's products.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {
namespace tf {

using namespace tma;

constexpr int RING = 2;        // slots of the weight ring
constexpr int NT = 64;         // columns (pixels) of a weight tile
constexpr int TS = NT + 8;     // its row stride in a slot (8 mod 32)
constexpr int WPG = 4;         // warps of a 16-row group, 16 columns each
constexpr int MAXG = 4;        // 16-row groups of a CTA, at most
constexpr int SMS = 132;       // SMs of an H100 SXM: sizes the grid (a
                               // constant: the bits never depend on it)
constexpr size_t MAX_SMEM = 232448 - 256;  // dynamic shared memory of a
                                          // CTA beside its static mbarriers

__host__ __device__ inline int pad4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int pad8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline size_t align256(size_t v) {
  return (v + 255) & ~(size_t)255;
}

// Widths of one call and everything derived from them.
struct Dims {
  int H, D;  // hidden width (the reduction of l = h W) and pixels
  int KP;    // H rounded up to 8: rows of a tile, k of the forward
  int nks;   // k8 steps of the forward (KP / 8)
  int nd;    // 64-column tiles of the pixels
  __host__ __device__ Dims(int h, int d)
      : H(h), D(d), KP(pad8(h)), nks(pad8(h) / 8), nd((d + NT - 1) / NT) {}
  __host__ __device__ size_t tile_floats() const { return (size_t)KP * TS; }
  __host__ __device__ size_t prep_bytes() const {
    return align256(sizeof(float) * nd * tile_floats());
  }
  __host__ __device__ size_t ring_bytes() const {
    return sizeof(float) * RING * tile_floats();
  }
  // one 16-row group's h rows in fragment order, hi and lo
  __host__ __device__ size_t frag_bytes() const {
    return sizeof(float) * 2 * 4 * 32 * (size_t)nks;
  }
};

// Groups per CTA for R rows: enough that the grid fits the card in one
// wave where it can (ceil(groups / SMS), at most maxg), then fewer while
// `per_group` + `fixed` bytes of shared memory do not fit. It depends on R
// and the widths only; a row's arithmetic is the same for any value.
inline int cta_groups(int R, size_t fixed, size_t per_group,
                      int maxg = MAXG) {
  const int groups = (R + 15) / 16;
  int G = (groups + SMS - 1) / SMS;
  G = G < 1 ? 1 : (G > maxg ? maxg : G);
  while (G > 1 && fixed + G * per_group > MAX_SMEM) --G;
  return G;
}

// rna(v): v rounded to TF32, to nearest with ties away from zero (the bits
// of cvt.rna.tf32.f32 for every finite v): half a TF32 ulp added to the
// magnitude, the 13 bits below TF32's mantissa cleared
__device__ __forceinline__ float rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// v = hi + lo, both TF32 (lo carries the next 11 bits)
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = rna(v);
  lo = rna(v - hi);
}

// The prepared weights: see the layout note at the top.
__global__ void prep_weights(const float* __restrict__ w,
                             float* __restrict__ wp, Dims d) {
  const size_t total = (size_t)d.nd * d.tile_floats();
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(e / d.tile_floats());
    const int within = (int)(e % d.tile_floats());
    const int k = within / TS, c = within % TS, n = t * NT + c;
    wp[e] = (c < NT && k < d.H && n < d.D) ? w[(size_t)k * d.D + n] : 0.f;
  }
}

inline cudaError_t launch_prep(const float* w, float* wp, const Dims& d,
                               cudaStream_t stream) {
  const size_t want = ((size_t)d.nd * d.tile_floats() + 255) / 256;
  const int blocks = want < 1024 ? (int)want : 1024;
  prep_weights<<<blocks, 256, 0, stream>>>(w, wp, d);
  return cudaGetLastError();
}

// Tile i of the prepared weights (tma::TileRing's Tiles).
struct WeightTiles {
  const float* wp;
  size_t floats;  // of one tile
  __device__ void operator()(int i, const void*& src, uint32_t& bytes) const {
    src = wp + (size_t)i * floats;
    bytes = (uint32_t)(floats * sizeof(float));
  }
};

typedef PipeRing<WeightTiles, RING> Pipe;

// `bars` holds 2 * RING mbarriers
__device__ __forceinline__ Pipe make_pipe(float* slots, uint64_t* bars,
                                          const float* wp, const Dims& d,
                                          int consumers) {
  return Pipe(slots, bars, d.tile_floats() * sizeof(float),
              WeightTiles{wp, d.tile_floats()}, d.nd, consumers);
}

// barrier `id` (1..15; 0 is __syncthreads) for `threads` threads, whole warps
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 products of split operands
// ---------------------------------------------------------------------------

// c[16 x 8] += a[16 x 8] b[8 x 8], tf32 operands, fp32 accumulation (not
// volatile: the scheduler may interleave independent chains)
__device__ __forceinline__ void mma(float c[4], const float4& a, float b0,
                                    float b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// c += a b in 3xTF32: A fragment (ah, al), B fragment (bh0, bh1), (bl0, bl1)
__device__ __forceinline__ void mma3(float c[4], const float4& ah,
                                     const float4& al, float bh0, float bh1,
                                     float bl0, float bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// the hi and lo parts of four fp32 values
__device__ __forceinline__ void split4(const float4& v, float4& h, float4& l) {
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
}

// ---------------------------------------------------------------------------
// Rows and warp tiles. Fragment (C) layout of acc: lane l holds rows
// g = l / 4 (elements 0, 1) and g + 8 (elements 2, 3), columns 2t and 2t + 1
// of its n8 group, with t = l % 4.
// ---------------------------------------------------------------------------

// Stage rows r0 .. r0 + rows - 1 of the fp32 [R, H] matrix h into `frags`,
// split: per 16-row group a block of nks * 32 float4 of hi, then as many of
// lo, in fragment order; zero past R and past H. All threads of the CTA
// take part, eight loads in flight each.
__device__ __forceinline__ void stage_rows(const float* __restrict__ h,
                                           float* frags, int r0, int rows,
                                           int R, const Dims& d) {
  const int n = rows * d.KP;
  const size_t half = (size_t)d.nks * 128;  // floats of a group's hi block
  for (int base = threadIdx.x; base < n; base += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * blockDim.x, r = e / d.KP, k = e % d.KP;
      v[u] = (e < n && r0 + r < R && k < d.H)
                 ? h[(size_t)(r0 + r) * d.H + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + u * blockDim.x, r = e / d.KP, k = e % d.KP;
      if (e < n) {
        const int grp = r / 16, rl = r % 16, ks = k / 8, kk = k % 8;
        const int lane = (rl % 8) * 4 + kk % 4;
        float* p = frags + 2 * half * grp + ((size_t)ks * 32 + lane) * 4 +
                   rl / 8 + 2 * (kk / 4);
        split(v[u], p[0], p[half]);
      }
    }
  }
}

// The n8 groups of a tile warp wq owns: columns 8 wq + 32 j, j < 2
constexpr int NJ_STRIDE = 32;

// n8 groups of warp `wq`'s two that hold columns below `nvalid` (the first
// one or both)
__device__ __forceinline__ int fwd_groups(int wq, int nvalid) {
  return 8 * wq + NJ_STRIDE < nvalid ? 2 : (8 * wq < nvalid ? 1 : 0);
}

// The start of a row kernel on the Pipe: thread 0 issues the first tiles,
// every thread stages rows r0 .. r0 + rows - 1 of h (stage_rows) while they
// load, then warp 0, the producer, issues the rest. Returns whether the
// calling warp is the producer (it has no other work).
__device__ __forceinline__ bool stage_and_feed(Pipe& pipe,
                                               const float* __restrict__ h,
                                               float* frags, int r0, int rows,
                                               int R, const Dims& d) {
  if (threadIdx.x == 0)
    for (int i = 0; i < RING && i < d.nd; ++i) pipe.produce(i);
  stage_rows(h, frags, r0, rows, R, d);
  __syncthreads();
  if (threadIdx.x >= 32) return false;
  if (threadIdx.x == 0)
    for (int i = RING; i < d.nd; ++i) pipe.produce(i);
  return true;
}

// One k8 step of the forward: acc[j] += h[16 rows][k8 step ks]
// W_tile[k8 step ks][8 wq + 32 j .. + 8) for j < nj, in 3xTF32; `ah`, `al`
// point at the lane's hi and lo fragments of step 0, `pb` at its B element
// of step 0
__device__ __forceinline__ void fwd_step(float (&acc)[2][4], const float4* ah,
                                         const float4* al, const float* pb,
                                         int ks, int nj) {
  const float4 aH = ah[ks * 32], aL = al[ks * 32];
  const float* p = pb + ks * 8 * TS;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (j < nj) {
      float bh0, bl0, bh1, bl1;
      split(p[NJ_STRIDE * j], bh0, bl0);
      split(p[4 * TS + NJ_STRIDE * j], bh1, bl1);
      mma3(acc[j], aH, aL, bh0, bh1, bl0, bl1);
    }
}

// k8 steps of the forward, at most: hidden widths up to 256 (B4's dh
// accumulators, NJB in fused_ll_bwd.cu, take no more)
constexpr int MAXKS = 32;

// acc[j] = h[16 rows][k8 steps kb .. ke) W_tile[same][8 wq + 32 j .. + 8)
// for j < 2, 3xTF32: even and odd steps (by ks) in two chains, each in
// increasing k, then added; `af` is the group's split fragment block (hi,
// then lo at + nks * 32), `st` the staged tile. n8 groups at or past
// `nvalid` columns of the tile are skipped (their acc stays 0).
__device__ __forceinline__ void tile_fwd(float (&acc)[2][4], const float4* af,
                                         const float* st, int wq, int kb,
                                         int ke, int nks, int nvalid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float odd[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = odd[j][e] = 0.f;
  const int nj = fwd_groups(wq, nvalid);
  if (nj == 0) return;
  const float4* ah = af + lane;
  const float4* al = af + nks * 32 + lane;
  const float* pb = st + t * TS + 8 * wq + g;
  // a runtime loop, six steps a trip: a fully unrolled one outgrew the
  // instruction cache and was slower (PERF.md)
  int ks = kb;
  if ((ks & 1) && ks < ke) fwd_step(odd, ah, al, pb, ks++, nj);
#pragma unroll 3
  for (; ks + 1 < ke; ks += 2) {
    fwd_step(acc, ah, al, pb, ks, nj);
    fwd_step(odd, ah, al, pb, ks + 1, nj);
  }
  if (ks < ke) fwd_step(acc, ah, al, pb, ks, nj);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += odd[j][e];
}

// acc[j] += dl[16 rows][tile pixels] W_tile[n-rows (jb + j)*8 ..]^T for
// j < nj: the backward's dh product over the tile's first `nks` k8 steps of
// pixels (k permuted as in the note at the top). `dlf` is the group's dl in
// A-fragment order, split: [hi, lo][k8 step][lane] float4 (c0, c2, c1, c3)
// of the forward's accumulators, the lo block at + 8 * 32.
template <int NJ>
__device__ __forceinline__ void tile_bwd(float (&acc)[NJ][4],
                                         const float4* dlf, const float* st,
                                         int jb, int nj, int nks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pb = st + (jb * 8 + g) * TS + 2 * t;
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    const float4 ah = dlf[ks * 32 + lane], al = dlf[(8 + ks) * 32 + lane];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) {
        const float2 b =
            *reinterpret_cast<const float2*>(pb + j * 8 * TS + 8 * ks);
        float bh0, bl0, bh1, bl1;
        split(b.x, bh0, bl0);
        split(b.y, bh1, bl1);
        mma3(acc[j], ah, al, bh0, bh1, bl0, bl1);
      }
  }
}

// x[row][c] and bias[c] of a warp's fragment columns of a tile (n8 groups
// at c0 and c0 + 32; 0 past D), loaded before the tile's products so their
// latency hides behind them
__device__ __forceinline__ void load_pixels(float (&xv)[2][4],
                                            float (&bv)[2][2],
                                            const float* __restrict__ xa,
                                            const float* __restrict__ xb,
                                            const float* __restrict__ bias,
                                            int c0, int D) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + NJ_STRIDE * j + 2 * t + e;
      const bool in = c < D;
      bv[j][e] = in ? bias[c] : 0.f;
      xv[j][e] = in ? xa[c] : 0.f;
      xv[j][2 + e] = in ? xb[c] : 0.f;
    }
}

// The sums over a warp's 16 rows of the two columns a lane holds in one
// fragment column group: rows g and g + 8 first, then a butterfly over the 8
// lanes of the same t (one fixed order; every lane ends with the same bits)
__device__ __forceinline__ float2 col_sums16(const float v[4]) {
  float s0 = v[0] + v[2], s1 = v[1] + v[3];
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  return make_float2(s0, s1);
}

// softplus(l) = max(l, 0) + log(1 + exp(-|l|)) with the SFU's exp and log
// (absolute error ~1e-7 per pixel, far inside the kernels' tolerance)
__device__ __forceinline__ float softplus_fast(float l) {
  return fmaxf(l, 0.f) + __logf(1.f + __expf(-fabsf(l)));
}

}  // namespace tf
}  // namespace
