// Hot-loop decoder backward for Hopper (sm_90a): the gradients of the fused
// decoder output block + Bernoulli log-likelihood, recomputing the forward
// tile by tile so the [k, B, D] logits never reach device memory in fp32.
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
// fp32 y1, y2, dl, dy2, dy1.
//
// Bound at the train shape (k = 50, B = 100 -> R = 5000 rows, H1 = 100,
// HID = 200, D = 784): 6 R (H1 HID + HID^2 + HID D) = 6.50 GFLOP (the
// recompute plus two backward products per matmul) against ~4.7 MB that must
// move, so it is bound by operations: 0.0066 ms in bf16 on the tensor cores,
// 0.097 ms in fp32 on the CUDA cores.
//
// bf16 design (tc_bf16.cuh has the building blocks and why mma.sync), four
// launches that the wrapper counts as one:
// - prep_weights: bf16 copies of W1..W3 in 64-column tiles, as for B1.
// - Row phase (hot_loop_bwd_rows): every row tile in one grid, 16 rows per
//   warp, weights through B1's TMA ring, with B1's forward tile
//   (tc::forward_hidden without the exact rounding, which B2's tolerances do
//   not need, then the logits of each 64-pixel tile in registers). dl is
//   formed in the accumulator registers, and its bf16 fragment multiplies
//   the same staged W3 tile read the other way (ldmatrix without .trans)
//   into dy2, accumulated in registers over the pixel loop. Then two passes
//   over W2's tiles and two over W1's: y2 recomputed chunk by chunk for
//   (1 - y2^2) (no fp32 copy of y1 or y2 is kept), dy1 = dy2 W2^T, y1
//   recomputed for (1 - y1^2), dh = dy1 W1^T. The bf16 operands of the
//   weight gradients (h1, y1, y2, dl, dy2, dy1) go to scratch rows, and each
//   warp's fp32 column sums of dl, dy2 and dy1 (its 16 rows, one fixed
//   order) to a per-16-row-group slot.
// - Weight-gradient phase (hot_loop_bwd_wgrad): dW1 = h1^T dy1,
//   dW2 = y1^T dy2, dW3 = y2^T dl as 64 x 64 output tiles of a 4-warp CTA,
//   each CTA summing one of S fixed row splits (S depends on R only) in
//   32-row chunks through a 3-slot cp.async ring, products on the tensor
//   cores; bias CTAs sum the split's 16-row groups in order. Every CTA
//   writes its split's slot.
// - reduce_slots_kernel (tiles_fp32.cuh, shared with B4) sums the S slots in
//   order 0..S-1. No float atomics anywhere: dW and db are bitwise the same
//   from one launch to the next.
// - Rows past R (up to the padded row count Rp, a multiple of 128) load
//   h1 = 0 and get dl = 0, so dy2 = dy1 = 0 there and they add exactly zero
//   to every dW and db; their dh is not written. Pixels d >= D get dl = 0 and
//   padding columns of the hidden layers stay 0.
// - Scratch at the train shape: ~26 MB (the bf16 operands ~20 MB, S = 5
//   slots 4.4 MB, the bias groups 1.5 MB), against 111.6 MB for the fp32
//   path's 128 slots.
//
// fp32 design: the CUDA-core tiles of tiles_fp32.cuh: a fixed number of row
// groups (min(GROUPS, row tiles)) each own one CTA and one slot of a [G, S]
// fp32 scratch; a CTA walks its 32-row tiles in order, storing into its slot
// on the first tile and adding on the next; reduce_slots_kernel sums the
// slots in order.

#include "tc_bf16.cuh"
#include "tiles_fp32.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// The bf16 path's scratch buffer and its split of the rows.
struct BwdLayout {
  tc::Dims d;
  int Rp;               // rows padded to a multiple of 128
  int wH1, wH, wD;      // bf16 operand widths, padded to 64 columns
  int BW;               // floats of one 16-row group's bias sums: 2 HID + D
  int S, rps;           // row splits and rows per split (a multiple of 128)
  size_t slot_len;      // floats of dW1, db1, dW2, db2, dW3, db3
  size_t o_prep, o_h, o_y1, o_y2, o_dl, o_dy2, o_dy1, o_bias, o_slots,
      total;            // byte offsets into the scratch buffer, and its size

  __host__ __device__ BwdLayout(int R, int H1, int HID, int D)
      : d(H1, HID, D) {
    Rp = (R + 127) / 128 * 128;
    wH1 = tc::pad64(H1);
    wH = tc::pad64(HID);
    wD = tc::pad64(D);
    BW = 2 * HID + D;
    // at most 16 splits of about 1024 rows or more, multiples of 128 rows,
    // none empty
    const int want = (Rp + 1023) / 1024, s0 = want < 16 ? want : 16;
    rps = ((Rp + s0 - 1) / s0 + 127) / 128 * 128;
    S = (Rp + rps - 1) / rps;
    slot_len = (size_t)H1 * HID + HID + (size_t)HID * HID + HID +
               (size_t)HID * D + D;
    size_t o = 0;
    const size_t two = sizeof(tc::bf16);
    o_prep = o; o = tc::align256(o + d.prep_elems() * two);
    o_h = o;    o = tc::align256(o + (size_t)Rp * wH1 * two);
    o_y1 = o;   o = tc::align256(o + (size_t)Rp * wH * two);
    o_y2 = o;   o = tc::align256(o + (size_t)Rp * wH * two);
    o_dl = o;   o = tc::align256(o + (size_t)Rp * wD * two);
    o_dy2 = o;  o = tc::align256(o + (size_t)Rp * wH * two);
    o_dy1 = o;  o = tc::align256(o + (size_t)Rp * wH * two);
    o_bias = o; o = tc::align256(o + (size_t)(Rp / 16) * BW * sizeof(float));
    o_slots = o;
    total = tc::align256(o + (size_t)S * slot_len * sizeof(float));
  }
  // offsets of the gradients in a slot and in the output
  __host__ __device__ size_t o_db1() const { return (size_t)d.H1 * d.HID; }
  __host__ __device__ size_t o_dW2() const { return o_db1() + d.HID; }
  __host__ __device__ size_t o_db2() const {
    return o_dW2() + (size_t)d.HID * d.HID;
  }
  __host__ __device__ size_t o_dW3() const { return o_db2() + d.HID; }
  __host__ __device__ size_t o_db3() const {
    return o_dW3() + (size_t)d.HID * d.D;
  }
};

template <class T>
__host__ __device__ __forceinline__ T* at(unsigned char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// The fp32 column sums of a warp's 16 rows for one fragment column group,
// stored by lanes 0..3 for columns below N.
__device__ __forceinline__ void store_col_sums(const float v[4], float* out,
                                               int c, int N) {
  const float2 s = tc::col_sums16(v);
  if ((threadIdx.x & 31) < 4) {
    if (c < N) out[c] = s.x;
    if (c + 1 < N) out[c + 1] = s.y;
  }
}

// NH8 = accumulator column groups a warp holds for a hidden-width product:
// at least max(H1P, HP) / 8.
template <int NH8>
__global__ void __launch_bounds__(tc::MAX_ROWS * 2, 1)
    hot_loop_bwd_rows(const float* __restrict__ h1,
                      const float* __restrict__ b1,
                      const float* __restrict__ b2,
                      const float* __restrict__ b3,
                      const float* __restrict__ x,
                      const float* __restrict__ g, float* __restrict__ dh,
                      unsigned char* __restrict__ scratch, int R, int B,
                      BwdLayout L) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims& d = L.d;
  const int rows = blockDim.x / 2;
  bf16* bufA = reinterpret_cast<bf16*>(smem_raw);  // h1, y2, dy2, h1
  bf16* bufB = bufA + (size_t)rows * d.AS;        // y1, dy1
  bf16* slots = bufB + (size_t)rows * d.AS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, cq = 2 * (lane & 3);
  const int r0 = blockIdx.x * rows, rw = r0 + warp * 16;
  bf16* myA = bufA + (size_t)warp * 16 * d.AS;
  bf16* myB = bufB + (size_t)warp * 16 * d.AS;
  bf16* sH = at<bf16>(scratch, L.o_h);
  bf16* sY1 = at<bf16>(scratch, L.o_y1) + (size_t)rw * L.wH;
  bf16* sY2 = at<bf16>(scratch, L.o_y2) + (size_t)rw * L.wH;
  bf16* sDl = at<bf16>(scratch, L.o_dl) + (size_t)rw * L.wD;
  bf16* sDy2 = at<bf16>(scratch, L.o_dy2) + (size_t)rw * L.wH;
  bf16* sDy1 = at<bf16>(scratch, L.o_dy1) + (size_t)rw * L.wH;
  float* part = at<float>(scratch, L.o_bias) + (size_t)(rw / 16) * L.BW;

  // forward W1, W2; pixels W3; y2 and dy1 over W2; y1 and dh over W1
  const Schedule sched{7, schedule_code(0, 1, 2, 1, 1, 0, 0)};
  __shared__ uint64_t bars[STAGES];
  Ring ring(slots, bars, at<bf16>(scratch, L.o_prep), d, sched);
  ring.prologue();
  load_rows_bf16(h1, bufA, d.AS, rows, d.H1P, r0, R, d.H1);
  load_rows_bf16(h1, sH + (size_t)r0 * L.wH1, L.wH1, rows, L.wH1, r0, R,
                 d.H1);
  bf16* const y_out[2] = {sY1, sY2};
  forward_hidden<8, false>(ring, d, myA, myB, b1, b2, y_out, L.wH, 0);

  // pixels: logits -> dl -> db3, dl to scratch, dy2 += dl W3^T
  const int ra = rw + (lane >> 2), rb = ra + 8;
  const float ga = ra < R ? g[ra] : 0.f, gb = rb < R ? g[rb] : 0.f;
  const float* xa = x + (size_t)((ra < R ? ra : 0) % B) * d.D;
  const float* xb = x + (size_t)((rb < R ? rb : 0) % B) * d.D;
  float dy2[NH8][4];
#pragma unroll
  for (int j = 0; j < NH8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dy2[j][e] = 0.f;
  const int hjp = d.HP / 16;
  for (int t = 0; t < d.nd; ++t) {
    const int n0 = t * NTILE, n8 = min(8, (d.D - n0 + 7) / 8);
    float xv[8][4], bv[8][2];
    load_pixels(xv, bv, xa, xb, b3, n0, d.D);
    const bf16* st = ring.next();
    float acc[8][4];
    tile_fwd(acc, myA, d.AS, d.HP, st, n8);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = n0 + 8 * j + cq + e < d.D;
        const float la = acc[j][e] + bv[j][e], lb = acc[j][2 + e] + bv[j][e];
        acc[j][e] = in && ra < R
                        ? ga * (xv[j][e] - 1.f / (1.f + __expf(-la))) : 0.f;
        acc[j][2 + e] = in && rb < R
                            ? gb * (xv[j][2 + e] - 1.f / (1.f + __expf(-lb)))
                            : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_col_sums(acc[j], part + 2 * d.HID, n0 + 8 * j + cq, d.D);
    store_pairs(acc, sDl, L.wD, n0, 8);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (16 * kk < d.D - n0) {
        const uint32_t a[4] = {pack(acc[2 * kk][0], acc[2 * kk][1]),
                               pack(acc[2 * kk][2], acc[2 * kk][3]),
                               pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                               pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
        tile_bwd<NH8>(dy2, a, st, kk, hjp);
      }
  }

  // W2: y2 recomputed chunk by chunk; dy2 *= 1 - y2^2 -> db2, dy2 to bufA
  // (y2's rows are dead) and to scratch
#pragma unroll
  for (int t = 0; t < (NH8 + 7) / 8; ++t)
    if (t < d.nh) {
      const bf16* st = ring.next();
      const int n0 = t * NTILE, n8 = min(8, (d.HP - n0) / 8);
      float acc[8][4], y[8][4];
      tile_fwd(acc, myB, d.AS, d.HP, st, n8);
      bias_tanh(y, acc, n0, b2, d.HID);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[j][e] = 8 * t + j < NH8
                        ? dy2[(8 * t + j) % NH8][e] * (1.f - y[j][e] * y[j][e])
                        : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_col_sums(y[j], part + d.HID, n0 + 8 * j + cq, d.HID);
      store_pairs(y, myA, d.AS, n0, n8);
      store_pairs(y, sDy2, L.wH, n0, 8);
    }

  // W2 again: dy1 = dy2 W2^T
  float dy1[NH8][4];
#pragma unroll
  for (int j = 0; j < NH8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dy1[j][e] = 0.f;
  const bf16* pa = myA + ((q & 1) * 8 + (lane & 7)) * d.AS + (q >> 1) * 8;
  for (int t = 0; t < d.nh; ++t) {
    const bf16* st = ring.next();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (t * NTILE + 16 * kk < d.HP) {
        uint32_t a[4];
        ldsm_x4(a, pa + t * NTILE + 16 * kk);
        tile_bwd<NH8>(dy1, a, st, kk, hjp);
      }
  }

  // W1: y1 recomputed from h1 (back into bufA from its bf16 copy); dy1 *=
  // 1 - y1^2 -> db1, dy1 to bufB (y1's rows are dead) and to scratch
  __syncwarp();
  for (int e = lane; e < 16 * d.H1P; e += 32) {
    const int r = e / d.H1P, c = e % d.H1P;
    myA[r * d.AS + c] = sH[(size_t)(rw + r) * L.wH1 + c];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < (NH8 + 7) / 8; ++t)
    if (t < d.nh) {
      const bf16* st = ring.next();
      const int n0 = t * NTILE, n8 = min(8, (d.HP - n0) / 8);
      float acc[8][4], y[8][4];
      tile_fwd(acc, myA, d.AS, d.H1P, st, n8);
      bias_tanh(y, acc, n0, b1, d.HID);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[j][e] = 8 * t + j < NH8
                        ? dy1[(8 * t + j) % NH8][e] * (1.f - y[j][e] * y[j][e])
                        : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_col_sums(y[j], part, n0 + 8 * j + cq, d.HID);
      store_pairs(y, myB, d.AS, n0, n8);
      store_pairs(y, sDy1, L.wH, n0, 8);
    }

  // W1 again: dh = dy1 W1^T
  float dha[NH8][4];
#pragma unroll
  for (int j = 0; j < NH8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dha[j][e] = 0.f;
  const bf16* pb = myB + ((q & 1) * 8 + (lane & 7)) * d.AS + (q >> 1) * 8;
  for (int t = 0; t < d.nh; ++t) {
    const bf16* st = ring.next();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (t * NTILE + 16 * kk < d.HP) {
        uint32_t a[4];
        ldsm_x4(a, pb + t * NTILE + 16 * kk);
        tile_bwd<NH8>(dha, a, st, kk, d.H1P / 16);
      }
  }
#pragma unroll
  for (int j = 0; j < NH8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + cq + e;
      if (c < d.H1) {
        if (ra < R) dh[(size_t)ra * d.H1 + c] = dha[j][e];
        if (rb < R) dh[(size_t)rb * d.H1 + c] = dha[j][2 + e];
      }
    }
}

constexpr int WG_THREADS = 128;  // weight-gradient CTA: 4 warps x 16 rows
constexpr int KCH = 32;          // rows per staged chunk

// Start the copy of chunk c (rows c*KCH.. of both operands, 64 columns
// each) into the slots `as`, `bs` [KCH][TS], and commit it (an empty group
// past the last chunk keeps the count).
__device__ __forceinline__ void wg_fetch(tc::bf16* as, tc::bf16* bs,
                                         const tc::bf16* a, int lda,
                                         const tc::bf16* b, int ldb, int c,
                                         int nchunks) {
  if (c < nchunks) {
    for (int e = threadIdx.x; e < KCH * 8; e += WG_THREADS) {
      const int row = c * KCH + (e >> 3), p = (e & 7) * 8;
      tc::cp_async16(as + (e >> 3) * tc::TS + p, a + (size_t)row * lda + p);
      tc::cp_async16(bs + (e >> 3) * tc::TS + p, b + (size_t)row * ldb + p);
    }
  }
  tc::cp_async_commit();
}

__global__ void __launch_bounds__(WG_THREADS)
    hot_loop_bwd_wgrad(unsigned char* __restrict__ scratch, BwdLayout L) {
  using namespace tc;
  __shared__ __align__(16) bf16 As[STAGES][KCH * TS];
  __shared__ __align__(16) bf16 Bs[STAGES][KCH * TS];
  const Dims& d = L.d;
  const int s = blockIdx.y;
  const int k_begin = s * L.rps;
  const int k_end = min(L.Rp, k_begin + L.rps);
  const int nchunks = k_end > k_begin ? (k_end - k_begin) / KCH : 0;
  float* slot = at<float>(scratch, L.o_slots) + (size_t)s * L.slot_len;
  const int m1 = L.wH1 / 64, mh = L.wH / 64, nd = L.wD / 64;
  const int n_w1 = m1 * mh, n_w2 = mh * mh, n_w3 = mh * nd;
  int bx = blockIdx.x;

  if (bx >= n_w1 + n_w2 + n_w3) {
    // bias CTA: the split's 16-row groups summed in order
    const int c = (bx - n_w1 - n_w2 - n_w3) * WG_THREADS + threadIdx.x;
    if (c < L.BW) {
      const float* bp = at<float>(scratch, L.o_bias);
      float acc = 0.f;
      for (int gq = k_begin / 16; gq < k_end / 16; ++gq)
        acc += bp[(size_t)gq * L.BW + c];
      const size_t pos = c < d.HID ? L.o_db1() + c
                         : c < 2 * d.HID ? L.o_db2() + (c - d.HID)
                                         : L.o_db3() + (c - 2 * d.HID);
      slot[pos] = acc;
    }
    return;
  }

  const bf16 *A, *Bm;
  int lda, ldb, M, N, mt, nt;
  size_t o;
  if (bx < n_w1) {  // dW1 = h1^T dy1
    A = at<bf16>(scratch, L.o_h); lda = L.wH1;
    Bm = at<bf16>(scratch, L.o_dy1); ldb = L.wH;
    M = d.H1; N = d.HID; o = 0; mt = bx / mh; nt = bx % mh;
  } else if ((bx -= n_w1) < n_w2) {  // dW2 = y1^T dy2
    A = at<bf16>(scratch, L.o_y1); lda = L.wH;
    Bm = at<bf16>(scratch, L.o_dy2); ldb = L.wH;
    M = d.HID; N = d.HID; o = L.o_dW2(); mt = bx / mh; nt = bx % mh;
  } else {  // dW3 = y2^T dl
    bx -= n_w2;
    A = at<bf16>(scratch, L.o_y2); lda = L.wH;
    Bm = at<bf16>(scratch, L.o_dl); ldb = L.wD;
    M = d.HID; N = d.D; o = L.o_dW3(); mt = bx / nd; nt = bx % nd;
  }
  const int m0 = mt * 64, n0 = nt * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane >> 3;

  const bf16* a_src = A + (size_t)k_begin * lda + m0;
  const bf16* b_src = Bm + (size_t)k_begin * ldb + n0;
  wg_fetch(As[0], Bs[0], a_src, lda, b_src, ldb, 0, nchunks);
  wg_fetch(As[1], Bs[1], a_src, lda, b_src, ldb, 1, nchunks);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    wg_fetch(As[(c + 2) % STAGES], Bs[(c + 2) % STAGES], a_src, lda, b_src,
             ldb, c + 2, nchunks);
    const bf16* as = As[c % STAGES];
    const bf16* bs = Bs[c % STAGES];
#pragma unroll
    for (int ks = 0; ks < KCH / 16; ++ks) {
      // A = (rows of the chunk as k) x (m): stored [k][m], so transposed
      uint32_t a[4];
      ldsm_x4_t(a, as + (ks * 16 + (q >> 1) * 8 + (lane & 7)) * TS +
                       warp * 16 + (q & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4_t(b, bs + (ks * 16 + (q & 1) * 8 + (lane & 7)) * TS +
                         jp * 16 + (q >> 1) * 8);
        mma(acc[2 * jp], a, b[0], b[1]);
        mma(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int ma = m0 + warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = ma + (e >> 1) * 8, n = n0 + 8 * j + cq + (e & 1);
      if (m < M && n < N) slot[o + (size_t)m * N + n] = acc[j][e];
    }
}

// Warps per CTA of the row phase for R rows: the fewest (2, 4 or 8) that
// keep the grid within one CTA per SM (132), else 8. A warp's arithmetic is
// the same whatever the CTA size.
inline int cta_warps(int R) {
  if ((R + 31) / 32 <= 132) return 2;
  if ((R + 63) / 64 <= 132) return 4;
  return 8;
}

template <int NH8>
cudaError_t launch_rows(const float* h1, const float* b1, const float* b2,
                        const float* b3, const float* x, const float* g,
                        float* dh, unsigned char* scratch, int R, int B,
                        const BwdLayout& L, cudaStream_t s) {
  const int rows = 16 * cta_warps(R);
  cudaError_t e = allow_smem(hot_loop_bwd_rows<NH8>,
                             L.d.smem_bytes(tc::MAX_ROWS));
  if (e != cudaSuccess) return e;
  hot_loop_bwd_rows<NH8><<<L.Rp / rows, rows * 2, L.d.smem_bytes(rows), s>>>(
      h1, b1, b2, b3, x, g, dh, scratch, R, B, L);
  return cudaGetLastError();
}

// A row-phase thread holds (KPMAX + 7) / 8 fragments of a reduction: the
// instantiations take up to 30 (reductions up to 240 wide).
inline bool rows_fit(int kpmax) { return (kpmax + 7) / 8 <= 30; }

cudaError_t launch_tc(const float* h1, const float* w1, const float* b1,
                      const float* w2, const float* b2, const float* w3,
                      const float* b3, const float* x, const float* g,
                      float* dh, float* grads, unsigned char* scratch, int R,
                      int B, int H1, int HID, int D, cudaStream_t s) {
  const BwdLayout L(R, H1, HID, D);
  if (!rows_fit(L.d.KPMAX)) return cudaErrorInvalidValue;
  const int need = (L.d.KPMAX + 7) / 8;
  cudaError_t e = tc::launch_prep(w1, w2, w3, at<tc::bf16>(scratch, L.o_prep),
                                  L.d, s);
  if (e != cudaSuccess) return e;
  e = need <= 16   ? launch_rows<16>(h1, b1, b2, b3, x, g, dh, scratch, R, B,
                                     L, s)
      : need <= 26 ? launch_rows<26>(h1, b1, b2, b3, x, g, dh, scratch, R, B,
                                     L, s)
                   : launch_rows<30>(h1, b1, b2, b3, x, g, dh, scratch, R, B,
                                     L, s);
  if (e != cudaSuccess) return e;
  const int n_tiles = (L.wH1 / 64) * (L.wH / 64) + (L.wH / 64) * (L.wH / 64) +
                      (L.wH / 64) * (L.wD / 64) +
                      (L.BW + WG_THREADS - 1) / WG_THREADS;
  hot_loop_bwd_wgrad<<<dim3(n_tiles, L.S), WG_THREADS, 0, s>>>(scratch, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_slots(at<float>(scratch, L.o_slots), grads, L.slot_len, L.S,
                      s);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t slot_floats(int H1, int HID, int D) {
  return (size_t)H1 * HID + HID + (size_t)HID * HID + HID + (size_t)HID * D +
         D;
}

__global__ void __launch_bounds__(THREADS)
    hot_loop_bwd_fp32(const float* __restrict__ h1,
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
  float* hs = smem;              // [TM][H1P]  h1 tile
  float* y1s = hs + TM * H1P;    // [TM][HP]   y1, later dy1
  float* y2s = y1s + TM * HP;    // [TM][HP]   y2
  float* dy2s = y2s + TM * HP;   // [TM][HP]   dy2
  float* dls = dy2s + TM * HP;   // [TM][NT]   dl of one pixel chunk
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
    load_rows(h1, hs, r0, R, H1);
    for (int e = threadIdx.x; e < TM * HP; e += THREADS) dy2s[e] = 0.f;
    dense_tanh(hs, H1P, H1, W1, b1, y1s, HP, ws);
    dense_tanh(y1s, HP, HID, W2, b2, y2s, HP, ws);

    for (int n0 = 0; n0 < D; n0 += NT) {
      const int nc = min(NT, D - n0);
      float acc[4][4];
      tile_product(acc, y2s, HP, HID, W3, ws, n0);
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
        tile_product(acc, dls, NT, NT, Transposed{w3, nc, HID, D, n0}, ws, nb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = nb + 4 * lane + j;
            if (c < HID) dy2s[(4 * warp + i) * HP + c] += acc[i][j];
          }
      }
      __syncthreads();
      outer_acc(y2s, HP, HID, dls, NT, nc, s_dw3 + n0, D, first);
      col_sum(dls, NT, nc, s_db3 + n0, first);
      __syncthreads();  // dls is rewritten by the next chunk
    }

    for (int e = threadIdx.x; e < TM * HP; e += THREADS) {
      const float y = y2s[e];
      dy2s[e] *= 1.f - y * y;  // padding columns stay 0
    }
    __syncthreads();
    outer_acc(y1s, HP, HID, dy2s, HP, HID, s_dw2, HID, first);
    col_sum(dy2s, HP, HID, s_db2, first);

    // dy1 = (dy2 W2^T) * (1 - y1^2), written over y1 (its last reader,
    // outer_acc above, finished at tile_product's opening barrier)
    for (int nb = 0; nb < HP; nb += NT) {
      float acc[4][4];
      tile_product(acc, dy2s, HP, HID, Transposed{w2, HID, HID, HID, 0}, ws,
                   nb);
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
    outer_acc(hs, H1P, H1, y1s, HP, HID, s_dw1, HID, first);
    col_sum(y1s, HP, HID, s_db1, first);

    // dh = dy1 W1^T
    for (int nb = 0; nb < H1P; nb += NT) {
      float acc[4][4];
      tile_product(acc, y1s, HP, HID, Transposed{w1, HID, H1, HID, 0}, ws,
                   nb);
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

size_t fp32_smem_bytes(int H1, int HID) {
  return sizeof(float) * ((size_t)TM * (round4(H1) + 3 * round4(HID) + NT) +
                          (size_t)KC * WS);
}

}  // namespace

extern "C" {

// Dynamic shared memory the largest CTA needs for these widths (bytes).
size_t hot_loop_bwd_smem_bytes(int H1, int HID, int bf16) {
  return bf16 ? tc::Dims(H1, HID, 1).smem_bytes(tc::MAX_ROWS)
              : fp32_smem_bytes(H1, HID);
}

// 1 when the register budget takes these widths (bf16: reductions up to
// 240 wide, see rows_fit; fp32 has no such limit). The host's path
// selection reads it, and hot_loop_bwd refuses the widths it rejects.
int hot_loop_bwd_fits(int H1, int HID, int bf16) {
  return !bf16 || rows_fit(tc::Dims(H1, HID, 1).KPMAX);
}

// Bytes of the scratch buffer a call over R rows takes: the bf16 path's
// prepared weights, operand rows, bias groups and split slots, or the fp32
// path's [G, S] slots.
size_t hot_loop_bwd_scratch_bytes(int R, int H1, int HID, int D, int bf16) {
  return bf16 ? BwdLayout(R, H1, HID, D).total
              : tc::align256((size_t)row_groups(R) *
                             slot_floats(H1, HID, D) * sizeof(float));
}

// Every pointer but `scratch` is a contiguous fp32 device buffer: h1 [R, H1],
// w1 [H1, HID], b1 [HID], w2 [HID, HID], b2 [HID], w3 [HID, D], b3 [D],
// x [B, D], g [R]; outputs dh [R, H1] and grads (dW1, db1, dW2, db2, dW3,
// db3 back to back); scratch holds hot_loop_bwd_scratch_bytes bytes
// (256-byte aligned). Launches every kernel on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
int hot_loop_bwd(const void* h1, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3,
                 const void* b3, const void* x, const void* g, void* dh,
                 void* grads, void* scratch, int R, int B, int H1, int HID,
                 int D, int bf16, void* stream) {
  if (R <= 0 || B <= 0 || H1 <= 0 || HID <= 0 || D <= 0 || R % B != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float *fh1 = (const float*)h1, *fw1 = (const float*)w1,
              *fb1 = (const float*)b1, *fw2 = (const float*)w2,
              *fb2 = (const float*)b2, *fw3 = (const float*)w3,
              *fb3 = (const float*)b3, *fx = (const float*)x,
              *fg = (const float*)g;
  float *fdh = (float*)dh, *fgr = (float*)grads;
  if (bf16)
    return (int)launch_tc(fh1, fw1, fb1, fw2, fb2, fw3, fb3, fx, fg, fdh, fgr,
                          (unsigned char*)scratch, R, B, H1, HID, D, s);
  const int G = row_groups(R);
  const size_t smem = fp32_smem_bytes(H1, HID);
  cudaError_t e = allow_smem(hot_loop_bwd_fp32, smem);
  if (e != cudaSuccess) return (int)e;
  float* slots = (float*)scratch;
  hot_loop_bwd_fp32<<<G, THREADS, smem, s>>>(fh1, fw1, fb1, fw2, fb2, fw3,
                                             fb3, fx, fg, fdh, slots, R, B,
                                             H1, HID, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_slots(slots, fgr, slot_floats(H1, HID, D), G, s);
}

}  // extern "C"
