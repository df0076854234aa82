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
// Bound at the eval chunk (k = 250, B = 500 -> R = 125000 rows, H1 = 100,
// HID = 200, D = 784): 2 R (H1 HID + HID^2 + HID D) = 54.2 GFLOP against
// ~52 MB that must move (h1 50 MB in fp32, the weights, x, out), ~1000 FLOP
// per byte: bound by operations, 0.055 ms in bf16 on the tensor cores
// (989 TFLOP/s) and 0.81 ms in fp32 on the CUDA cores (67 TFLOP/s). Besides
// the products, every logit pays an exp and a log (98 M of each at the eval
// chunk) and every hidden unit a tanh.
//
// bf16 design (tc_bf16.cuh has the building blocks and why mma.sync):
// - Launch anatomy: prep_weights writes bf16 copies of W1..W3 into the
//   caller's scratch in 64-column tiles, each the image of a shared-memory
//   slot (once per call, not once per CTA), then the row kernel. The wrapper
//   counts the pair as one launch.
// - A 16-row group is 4 warps; each owns 16 columns of every 64-column tile
//   (WPG). A CTA holds 1 group (two CTAs per SM, while one wave covers the
//   call) or 4 by the rule fwd_groups, or 1..MAX_GROUPS as the caller pins
//   (`groups`, the tile ops/autotune.py measures: the port's counterpart of
//   the Pallas kernel's (tk, tb)). h1 is rounded to bf16 into shared memory; y1 and y2 are
//   produced by the tensor cores with their tanh in registers and stored as
//   bf16 operands in the group's rows; the logits of each tile stay in the
//   accumulators, where x l - softplus(l) (pixels d >= D masked, x from
//   x[r % B]) is added into per-lane running sums. Nothing of [k, B, HID]
//   or [k, B, D] reaches device memory.
// - Each layer's A fragments are loaded once into registers and the k loop
//   is unrolled, so the B fragments load ahead of the products; y2's
//   fragments serve all 13 pixel tiles.
// - The weights stream through a 3-slot ring, one tile per slot, each slot
//   filled by one TMA bulk copy (cp.async.bulk) that completes on an
//   mbarrier; tiles n+1 and n+2 are in flight while tile n multiplies.
// - Exact rounding of y1 and y2 (tc::exact_fixups): the plain version sums
//   each pre-activation in increasing k and rounds tanh to bf16; where the
//   tensor cores' sum could round the other way the lane sums that value
//   again the plain way. Without it ~40 rows in 125000 moved by more than
//   1e-2 nats.
// - Row order: a row's sum runs over pixel tiles and column groups, then the
//   4 lanes of the row, then the 4 warps of the group, in one fixed order
//   that depends on neither R, B nor the CTA size: a row's result is the
//   same bits in any bucket. No atomics.
// - Rows past R (the ragged last tile) compute on zeros and are not written.
//
// fp32 design: the CUDA-core tiles of tiles_fp32.cuh (full fp32, no TF32):
// a CTA of 256 threads owns 32 rows staged in shared memory, each weight
// streamed in 32 x 128 chunks, the logits consumed in registers.

#include "tc_bf16.cuh"
#include "tiles_fp32.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// The 4 warps of a 16-row group split every 64-column tile, 16 columns
// each; a CTA holds 1..MAX_GROUPS groups (fwd_groups, or the caller's pin).
constexpr int WPG = 4;
constexpr int MAX_GROUPS = 4;

// Row groups per CTA for R rows: 1 (two CTAs fit an SM) while the grid
// still fits the card in one wave, else MAX_GROUPS (fewer CTAs streaming the
// weights). A row's arithmetic is the same at any number of groups: a group
// computes its 16 rows alone, and the CTA size only sets how many groups
// share one stream of the weights. ops/hot_loop.fwd_groups mirrors it.
inline int fwd_groups(int R) {
  return (R + 15) / 16 <= 2 * 132 ? 1 : MAX_GROUPS;
}

// Whether y1 and y2 round exactly like the plain version (tc::exact_fixups
// and the SEPARATE accumulation). scripts/torch_hot_loop_profile.py builds a
// copy with -DHOT_LOOP_FWD_EXACT=false to measure what that costs.
#ifndef HOT_LOOP_FWD_EXACT
#define HOT_LOOP_FWD_EXACT true
#endif

inline size_t fwd_smem_bytes(const tc::Dims& d, int rows) {
  return d.smem_bytes(rows) + sizeof(float) * rows * WPG;
}

__global__ void __launch_bounds__(16 * MAX_GROUPS * 2 * WPG)
    hot_loop_fwd_tc(const tc::bf16* __restrict__ wp,
                    const float* __restrict__ h1,
                    const float* __restrict__ b1,
                    const float* __restrict__ b2,
                    const float* __restrict__ b3,
                    const float* __restrict__ x, float* __restrict__ out,
                    int R, int B, tc::Dims d) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / (2 * WPG);  // 16 rows per 4 warps
  bf16* bufA = reinterpret_cast<bf16*>(smem_raw);  // h1, then y2
  bf16* bufB = bufA + (size_t)rows * d.AS;        // y1
  bf16* slots = bufB + (size_t)rows * d.AS;
  float* part =
      reinterpret_cast<float*>(slots + (size_t)STAGES * d.KPMAX * TS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / WPG, col = 16 * (warp % WPG);
  const int r0 = blockIdx.x * rows;

  const Schedule sched{3, schedule_code(0, 1, 2)};
  __shared__ uint64_t bars[STAGES];
  Ring ring(slots, bars, wp, d, sched);
  ring.prologue();  // the first weight tiles load while h1 is staged
  load_rows_bf16(h1, bufA, d.AS, rows, d.H1P, r0, R, d.H1);
  bf16* myA = bufA + (size_t)grp * 16 * d.AS;
  bf16* myB = bufB + (size_t)grp * 16 * d.AS;
  forward_hidden<2, HOT_LOOP_FWD_EXACT>(ring, d, myA, myB, b1, b2, nullptr, 0,
                                       col);

  const int g = lane >> 2, cq = 2 * (lane & 3);
  const int ra = r0 + grp * 16 + g, rb = ra + 8;
  const float* xa = x + (size_t)((ra < R ? ra : 0) % B) * d.D;
  const float* xb = x + (size_t)((rb < R ? rb : 0) % B) * d.D;
  // per column group running sums (independent chains), then one fixed
  // order: the groups, the 4 lanes of the row, the 4 warps of the row group
  float sum_a[2] = {0.f, 0.f}, sum_b[2] = {0.f, 0.f};
  float acc[2][4];
  uint32_t a[MAXK16][4];
  for (int t = 0; t < d.nd; ++t) {
    const int c0 = t * NTILE + col;
    const int n8 = max(0, min(2, (d.D - c0 + 7) / 8));
    float xv[2][4], bv[2][2];
    load_pixels(xv, bv, xa, xb, b3, c0, d.D);
    const bf16* st = ring.next();
    if (t == 0) load_afrags(a, myA, d.AS, d.HP);  // y2, for every tile
    tile_fwd_r<2, false>(acc, a, d.HP, st, col, n8);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c0 + 8 * j + cq + e < d.D) {
          const float la = acc[j][e] + bv[j][e], lb = acc[j][2 + e] + bv[j][e];
          sum_a[j] += xv[j][e] * la - softplus_fast(la);
          sum_b[j] += xv[j][2 + e] * lb - softplus_fast(lb);
        }
  }
  float part_a = sum_a[0] + sum_a[1], part_b = sum_b[0] + sum_b[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    part_a += __shfl_xor_sync(0xffffffffu, part_a, off);
    part_b += __shfl_xor_sync(0xffffffffu, part_b, off);
  }
  if ((lane & 3) == 0) {
    part[(grp * 16 + g) * WPG + warp % WPG] = part_a;
    part[(grp * 16 + g + 8) * WPG + warp % WPG] = part_b;
  }
  __syncthreads();
  if ((int)threadIdx.x < rows && r0 + (int)threadIdx.x < R) {
    const float* p = part + threadIdx.x * WPG;
    out[r0 + threadIdx.x] = ((p[0] + p[1]) + p[2]) + p[3];
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    hot_loop_fwd_fp32(const float* __restrict__ h1,
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
  float* ws = y2s + TM * HP;    // [KC][WS]
  const int r0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows(h1, hs, r0, R, H1);
  dense_tanh(hs, H1P, H1, RowMajor{w1, H1, HID, HID}, b1, y1s, HP, ws);
  dense_tanh(y1s, HP, HID, RowMajor{w2, HID, HID, HID}, b2, y2s, HP, ws);

  const RowMajor W3{w3, HID, D, D};
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < D; n0 += NT) {
    float acc[4][4];
    tile_product(acc, y2s, HP, HID, W3, ws, n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * warp + i;
      const float* xr = x + (size_t)((r < R ? r : 0) % B) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * lane + j;
        if (c < D) {
          const float l = acc[i][j] + b3[c];
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

size_t fp32_smem_bytes(int H1, int HID) {
  return sizeof(float) *
         ((size_t)TM * (round4(H1) + 2 * round4(HID)) + (size_t)KC * WS);
}

}  // namespace

extern "C" {

// Dynamic shared memory the largest CTA needs for these widths (bytes): in
// bf16 the CTA of MAX_GROUPS row groups.
size_t hot_loop_fwd_smem_bytes(int H1, int HID, int bf16) {
  return bf16 ? fwd_smem_bytes(tc::Dims(H1, HID, 1), 16 * MAX_GROUPS)
              : fp32_smem_bytes(H1, HID);
}

// 1 when the register budget takes these widths: in bf16 a layer's A
// fragments sit in registers, so every reduction (H1 and HID rounded up to
// 16) is at most 16 * MAXK16 = 240 wide; fp32 has no such limit. The host's
// path selection reads it, and hot_loop_fwd refuses the widths it rejects.
int hot_loop_fwd_fits(int H1, int HID, int bf16) {
  return !bf16 || tc::Dims(H1, HID, 1).KPMAX <= 16 * tc::MAXK16;
}

// Bytes of the scratch buffer a call takes: the prepared bf16 weights (bf16
// path), nothing in fp32.
size_t hot_loop_fwd_scratch_bytes(int H1, int HID, int D, int bf16) {
  return bf16 ? tc::align256(tc::Dims(H1, HID, D).prep_elems() *
                             sizeof(tc::bf16))
              : 0;
}

// out[r] for r < R = k * B; every pointer but `scratch` is a contiguous fp32
// device buffer: h1 [R, H1], w1 [H1, HID], b1 [HID], w2 [HID, HID], b2 [HID],
// w3 [HID, D], b3 [D], x [B, D], out [R]; scratch holds
// hot_loop_fwd_scratch_bytes bytes (256-byte aligned). `groups` is the bf16
// kernel's 16-row groups per CTA: 0 = fwd_groups(R), 1..MAX_GROUPS pinned
// (the fp32 kernel has no such tile and takes only 0). Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
int hot_loop_fwd(const void* h1, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, const void* x, void* out, void* scratch,
                 int R, int B, int H1, int HID, int D, int bf16, int groups,
                 void* stream) {
  if (R <= 0 || B <= 0 || H1 <= 0 || HID <= 0 || D <= 0 || R % B != 0 ||
      groups < 0 || groups > MAX_GROUPS || (!bf16 && groups != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fh1 = (const float*)h1, *fb1 = (const float*)b1,
              *fb2 = (const float*)b2, *fb3 = (const float*)b3,
              *fx = (const float*)x;
  float* fout = (float*)out;
  if (!bf16) {
    const size_t smem = fp32_smem_bytes(H1, HID);
    const cudaError_t e = allow_smem(hot_loop_fwd_fp32, smem);
    if (e != cudaSuccess) return (int)e;
    hot_loop_fwd_fp32<<<(R + TM - 1) / TM, THREADS, smem, s>>>(
        fh1, (const float*)w1, fb1, (const float*)w2, fb2, (const float*)w3,
        fb3, fx, fout, R, B, H1, HID, D);
    return (int)cudaGetLastError();
  }
  const tc::Dims d(H1, HID, D);
  if (!hot_loop_fwd_fits(H1, HID, 1)) return (int)cudaErrorInvalidValue;
  tc::bf16* wp = (tc::bf16*)scratch;
  cudaError_t e = tc::launch_prep((const float*)w1, (const float*)w2,
                                  (const float*)w3, wp, d, s);
  if (e != cudaSuccess) return (int)e;
  const int rows = 16 * (groups ? groups : fwd_groups(R));
  e = allow_smem(hot_loop_fwd_tc, fwd_smem_bytes(d, 16 * MAX_GROUPS));
  if (e != cudaSuccess) return (int)e;
  hot_loop_fwd_tc<<<(R + rows - 1) / rows, rows * 2 * WPG,
                    fwd_smem_bytes(d, rows), s>>>(wp, fh1, fb1, fb2, fb3, fx,
                                                  fout, R, B, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
