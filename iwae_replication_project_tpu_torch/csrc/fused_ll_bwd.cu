// Fused Bernoulli log-likelihood backward for Hopper (sm_90a): the gradients
// of fused_ll_fwd.cu, recomputing the logits tile by tile so the [k, B, D]
// logits never reach device memory.
//
// Replaces the TPU kernel iwae_replication_project_tpu/ops/fused_likelihood.py
// _bwd_kernel (:242-265), launched by _bwd_pallas (:268-300).
//
// What it computes, for each flattened row r = (kk, b) of h [k, B, H] with
// cotangent g [k, B] (the gradient of fused_ll_fwd.cu's [k, B] output):
//   l   = h[r] W + bias
//   dl  = g[r] * (x[b] - sigmoid(l))        (only pixels d < D)
//   dh[r] = dl W^T
// and over all rows dW = sum_r h[r]^T dl, db = sum_r dl, fp32 in and out.
//
// Bound at the train shape (k = 50, B = 100 -> R = 5000 rows, H = 200,
// D = 784): 6 R H D = 4.70 GFLOP (the recompute plus the two backward
// products) against ~9.6 MB that must move (h and dh 4.0 MB each, W and dW
// 0.63 MB each, x 0.31 MB, g 20 KB), so it is bound by operations: in
// 3xTF32 on the tensor cores (tc_tf32.cuh) 14.1 GFLOP at 494.7 TFLOP/s,
// 0.0285 ms (0.070 ms for fp32 on the CUDA cores); 0.713 ms at the eval
// chunk (k = 250, B = 500).
//
// Design, four launches that the wrapper counts as one:
// - prep_weights: W once per call into 64-column fp32 tiles, as for B3.
// - Row phase (fused_ll_bwd_rows): 16-row groups of 4 warps as in B3 (no
//   K-split: each warp's dh accumulators fill its registers), G <= 3 groups
//   per CTA, h staged once split in fragment order, the 2-slot TMA ring fed
//   by a producer warp (tma::PipeRing); a group's warps meet on their own
//   named barrier, twice per tile, never the whole CTA. Per tile, each warp
//   recomputes the logits of its 16 columns in 3xTF32, forms dl in the
//   accumulators and writes them to scratch (fp32 dl rows, the
//   weight-gradient operand) and, split, as one A fragment per k8 step, to
//   the group's rows of shared memory; each warp's column sums of dl (its 16
//   rows, one fixed order) go to a per-16-row-group db slot. After the
//   group's barrier every warp adds dl W_tile^T into its quarter of the
//   hidden columns of dh (accumulators held over all tiles), reading the
//   same staged tile the other way round: W is staged once per tile for both
//   products.
// - Weight-gradient phase (fused_ll_bwd_wgrad): dW = h^T dl as 64 x 64
//   output tiles of a 4-warp CTA (32 x 32 per warp) in 3xTF32, each CTA
//   summing one of S fixed row splits (S <= 16, depends on R only) in
//   32-row chunks through a 3-slot cp.async ring, h read from the input and
//   dl from scratch, both zero-filled past R; bias CTAs sum the split's
//   16-row db slots in order. Every CTA writes its split's slot.
// - reduce_slots_kernel (tiles_fp32.cuh, shared with B2's fp32 path) sums
//   the S slots in order 0..S-1. No float atomics anywhere: dh, dW and db are
//   bitwise the same from one launch to the next.
// - Rows past R load h = 0 and get dl = 0; their dh and dl are not written.
//   Pixels d >= D get dl = 0.
// - Scratch (fused_ll_bwd_scratch_bytes): the prepared tiles, dl rows
//   [R][pad4(D)], the db slots [ceil(R / 16)][D] and S split slots of
//   H D + D floats: 20,562,432 bytes at the train shape.

#include "tc_tf32.cuh"
#include "tiles_fp32.cuh"

namespace {

// The scratch buffer of a call and its split of the rows.
struct BwdLayout {
  tf::Dims d;
  int ldD;          // row stride of the dl rows: D rounded up to 4
  int NGR;          // 16-row groups: ceil(R / 16)
  int Rp;           // rows padded to a multiple of 128
  int S, rps;       // row splits and rows per split (a multiple of 128)
  size_t slot_len;  // floats of one split's dW and db
  size_t o_dl, o_db, o_slots, total;  // byte offsets and the size

  __host__ __device__ BwdLayout(int R, int H, int D) : d(H, D) {
    ldD = tf::pad4(D);
    NGR = (R + 15) / 16;
    Rp = (R + 127) / 128 * 128;
    // at most 16 splits of about 1024 rows or more, as B2's
    const int want = (Rp + 1023) / 1024, s0 = want < 16 ? want : 16;
    rps = ((Rp + s0 - 1) / s0 + 127) / 128 * 128;
    S = (Rp + rps - 1) / rps;
    slot_len = (size_t)H * D + D;
    o_dl = d.prep_bytes();
    o_db = tf::align256(o_dl + sizeof(float) * R * (size_t)ldD);
    o_slots = tf::align256(o_db + sizeof(float) * NGR * (size_t)D);
    total = tf::align256(o_slots + sizeof(float) * S * slot_len);
  }
};

template <class T>
__host__ __device__ __forceinline__ T* at(unsigned char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

constexpr int NJB = 8;  // n8 groups of dh a warp holds: hidden widths <= 256

constexpr int MAXG_BWD = 3;  // groups per CTA (4 consumer warps each)
constexpr int ROWS_THREADS = (MAXG_BWD * tf::WPG + 1) * 32;

__global__ void __launch_bounds__(ROWS_THREADS, 1)
    fused_ll_bwd_rows(const float* __restrict__ h,
                      const float* __restrict__ bias,
                      const float* __restrict__ x,
                      const float* __restrict__ cot, float* __restrict__ dh,
                      unsigned char* __restrict__ scratch, int R, int B,
                      BwdLayout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * tf::RING];
  const tf::Dims& d = L.d;
  const int consumers = blockDim.x / 32 - 1;
  const int G = consumers / tf::WPG, rows = 16 * G;
  float* slots = reinterpret_cast<float*>(smem_raw);
  float* frags = slots + tf::RING * d.tile_floats();
  float4* dlf = reinterpret_cast<float4*>(frags + (size_t)G * d.nks * 256);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows;

  tf::Pipe pipe = tf::make_pipe(slots, bars, at<float>(scratch, 0), d,
                                consumers);
  if (tf::stage_and_feed(pipe, h, frags, r0, rows, R, d)) return;

  const int cw = warp - 1, grp = cw / tf::WPG, wq = cw % tf::WPG;
  const int col = 8 * wq, g = lane >> 2, t = lane & 3, rg = r0 + grp * 16;
  const float4* af =
      reinterpret_cast<const float4*>(frags) + (size_t)grp * d.nks * 64;
  float4* mydl = dlf + grp * 2 * 8 * 32;  // the group's dl, hi then lo

  const int ra = rg + g, rb = ra + 8;
  const float ga = ra < R ? cot[ra] : 0.f, gb = rb < R ? cot[rb] : 0.f;
  const float* xa = x + (size_t)((ra < R ? ra : 0) % B) * d.D;
  const float* xb = x + (size_t)((rb < R ? rb : 0) % B) * d.D;
  float* sdl = at<float>(scratch, L.o_dl);
  float* sdb = at<float>(scratch, L.o_db) + (size_t)(rg / 16) * d.D;
  const bool live = rg < R;  // the group has a row below R (warp-uniform)

  // this warp's n8 groups of dh: a quarter of the hidden columns
  const int n8h = d.KP / 8, per = (n8h + tf::WPG - 1) / tf::WPG;
  const int jb = wq * per, nj = max(0, min(per, n8h - jb));
  float dha[NJB][4];
#pragma unroll
  for (int j = 0; j < NJB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dha[j][e] = 0.f;

  for (int tile = 0; tile < d.nd; ++tile) {
    const int n0 = tile * tf::NT, c0 = n0 + col;
    float xv[2][4], bv[2][2];
    tf::load_pixels(xv, bv, xa, xb, bias, c0, d.D);
    const float* st = reinterpret_cast<const float*>(pipe.wait(tile));
    float acc[2][4];
    tf::tile_fwd(acc, af, st, wq, 0, d.nks, d.nks, d.D - n0);
    // the group's warps are done reading the previous tile's dl
    tf::named_sync(1 + grp, tf::WPG * 32);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = c0 + tf::NJ_STRIDE * j + 2 * t + e < d.D;
        const float la = acc[j][e] + bv[j][e], lb = acc[j][2 + e] + bv[j][e];
        acc[j][e] = in && ra < R
                        ? ga * (xv[j][e] - 1.f / (1.f + __expf(-la))) : 0.f;
        acc[j][2 + e] = in && rb < R
                            ? gb * (xv[j][2 + e] - 1.f / (1.f + __expf(-lb)))
                            : 0.f;
      }
      const int c = c0 + tf::NJ_STRIDE * j + 2 * t;
      if (live) {
        const float2 s = tf::col_sums16(acc[j]);
        if (g == 0) {
          if (c < d.D) sdb[c] = s.x;
          if (c + 1 < d.D) sdb[c + 1] = s.y;
        }
      }
      if (c + 1 < d.D) {
        if (ra < R)
          *reinterpret_cast<float2*>(sdl + (size_t)ra * L.ldD + c) =
              make_float2(acc[j][0], acc[j][1]);
        if (rb < R)
          *reinterpret_cast<float2*>(sdl + (size_t)rb * L.ldD + c) =
              make_float2(acc[j][2], acc[j][3]);
      } else if (c < d.D) {
        if (ra < R) sdl[(size_t)ra * L.ldD + c] = acc[j][0];
        if (rb < R) sdl[(size_t)rb * L.ldD + c] = acc[j][2];
      }
      const int ks = wq + 4 * j;  // the tile's n8 group = the k8 step of dh
      tf::split4(make_float4(acc[j][0], acc[j][2], acc[j][1], acc[j][3]),
                 mydl[ks * 32 + lane], mydl[(8 + ks) * 32 + lane]);
    }
    tf::named_sync(1 + grp, tf::WPG * 32);  // the group's dl is complete
    const int nksb = min(8, (d.D - n0 + 7) / 8);
    tf::tile_bwd<NJB>(dha, mydl, st, jb, nj, nksb);
    pipe.release(tile);
  }

#pragma unroll
  for (int j = 0; j < NJB; ++j)
    if (j < nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (jb + j) * 8 + 2 * t + e;
        if (c < d.H) {
          if (ra < R) dh[(size_t)ra * d.H + c] = dha[j][e];
          if (rb < R) dh[(size_t)rb * d.H + c] = dha[j][2 + e];
        }
      }
}

constexpr int WG_THREADS = 128;  // weight-gradient CTA: 2 x 2 warps
constexpr int KCH = 32;          // rows per staged chunk
constexpr int WG_TS = 72;        // row stride of a staged 64-column chunk
                                 // (8 mod 32: conflict-free fragments)
constexpr int WG_STAGES = 3;     // chunks in flight (cp.async groups)
constexpr size_t WG_SMEM = sizeof(float) * 2 * WG_STAGES * KCH * WG_TS;

// Start the copy of chunk c of a split (rows k0 + c KCH ..) into the slots
// `as` (h, columns m0 ..) and `bs` (dl, columns n0 ..), [KCH][TS] each, zero
// past R, H and D, and commit it (an empty group past the last chunk keeps
// the count). VEC: h's rows are 16-byte aligned (H % 4 == 0).
template <bool VEC>
__device__ __forceinline__ void wg_fetch(float* as, float* bs,
                                         const float* __restrict__ h,
                                         const float* __restrict__ dl,
                                         int k0, int c, int nchunks, int m0,
                                         int n0, int R, int H, int D,
                                         int ldD) {
  if (c < nchunks) {
    const int base = k0 + c * KCH;
    if (VEC) {
      for (int e = threadIdx.x; e < KCH * 16; e += WG_THREADS) {
        const int rr = e >> 4, q = e & 15, row = base + rr, m = m0 + 4 * q;
        const bool in = row < R && m < H;
        tma::cp_async16_zfill(as + rr * WG_TS + 4 * q,
                              in ? h + (size_t)row * H + m : h, in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < KCH * 64; e += WG_THREADS) {
        const int rr = e >> 6, q = e & 63, row = base + rr, m = m0 + q;
        const bool in = row < R && m < H;
        tma::cp_async4_zfill(as + rr * WG_TS + q,
                             in ? h + (size_t)row * H + m : h, in ? 4 : 0);
      }
    }
    for (int e = threadIdx.x; e < KCH * 16; e += WG_THREADS) {
      const int rr = e >> 4, q = e & 15, row = base + rr, n = n0 + 4 * q;
      const bool in = row < R && n < D;
      const int bytes = in ? 4 * min(4, D - n) : 0;
      tma::cp_async16_zfill(bs + rr * WG_TS + 4 * q,
                            in ? dl + (size_t)row * ldD + n : dl, bytes);
    }
  }
  tma::cp_async_commit();
}

template <bool VEC>
__global__ void __launch_bounds__(WG_THREADS)
    fused_ll_bwd_wgrad(const float* __restrict__ h,
                       unsigned char* __restrict__ scratch, int R,
                       BwdLayout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [WG_STAGES][KCH][WG_TS]
  float* Bs = As + WG_STAGES * KCH * WG_TS;
  const tf::Dims& d = L.d;
  const int s = blockIdx.y;
  const int k_begin = s * L.rps;
  const int k_end = min(L.Rp, k_begin + L.rps);
  const int nchunks = k_end > k_begin ? (k_end - k_begin) / KCH : 0;
  float* slot = at<float>(scratch, L.o_slots) + (size_t)s * L.slot_len;
  const int nn = (d.D + 63) / 64, n_w = ((d.H + 63) / 64) * nn;
  const int bx = blockIdx.x;

  if (bx >= n_w) {
    // bias CTA: the split's 16-row db slots summed in order
    const int c = (bx - n_w) * WG_THREADS + threadIdx.x;
    if (c < d.D) {
      const float* db = at<float>(scratch, L.o_db);
      const int gend = min(L.NGR, k_end / 16);
      float acc = 0.f;
      for (int gq = k_begin / 16; gq < gend; ++gq)
        acc += db[(size_t)gq * d.D + c];
      slot[(size_t)d.H * d.D + c] = acc;
    }
    return;
  }

  const int m0 = (bx / nn) * 64, n0 = (bx % nn) * 64;
  const float* dl = at<float>(scratch, L.o_dl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mw = (warp >> 1) * 32, nw = (warp & 1) * 32;

#pragma unroll
  for (int c = 0; c < WG_STAGES - 1; ++c)
    wg_fetch<VEC>(As + c * KCH * WG_TS, Bs + c * KCH * WG_TS, h, dl,
                  k_begin, c, nchunks, m0, n0, R, d.H, d.D, L.ldD);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    tma::cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    const int nx = (c + WG_STAGES - 1) % WG_STAGES;
    wg_fetch<VEC>(As + nx * KCH * WG_TS, Bs + nx * KCH * WG_TS, h, dl,
                  k_begin, c + WG_STAGES - 1, nchunks, m0, n0, R, d.H, d.D,
                  L.ldD);
    const float* as = As + (c % WG_STAGES) * KCH * WG_TS;
    const float* bs = Bs + (c % WG_STAGES) * KCH * WG_TS;
#pragma unroll
    for (int ks = 0; ks < KCH / 8; ++ks) {
      // A = h^T (m x rows): element (m, k) at as[k][m]
      const float* pa = as + (ks * 8 + t) * WG_TS + mw + g;
      const float* pb = bs + (ks * 8 + t) * WG_TS + nw + g;
      float4 ah[2], al[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tf::split4(make_float4(pa[16 * i], pa[16 * i + 8],
                               pa[4 * WG_TS + 16 * i],
                               pa[4 * WG_TS + 16 * i + 8]),
                   ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float bh0, bl0, bh1, bl1;
        tf::split(pb[8 * j], bh0, bl0);
        tf::split(pb[4 * WG_TS + 8 * j], bh1, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          tf::mma3(acc[i][j], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
  }
  tma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mw + 16 * i + g + 8 * (e >> 1);
        const int n = n0 + nw + 8 * j + 2 * t + (e & 1);
        if (m < d.H && n < d.D) slot[(size_t)m * d.D + n] = acc[i][j][e];
      }
}

// Dynamic shared memory of a row-phase CTA of G groups: the ring, the
// groups' split h fragments and their split dl fragments of one tile.
inline size_t rows_smem(const tf::Dims& d, int G) {
  return d.ring_bytes() +
         G * (d.frag_bytes() + sizeof(float) * 2 * 4 * 32 * 8);
}

inline int rows_groups(int R, const tf::Dims& d) {
  return tf::cta_groups(R, rows_smem(d, 0), rows_smem(d, 1) - rows_smem(d, 0),
                        MAXG_BWD);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the smallest row-phase CTA (one 16-row group)
// for hidden width H (bytes); wider CTAs are used only where they fit.
size_t fused_ll_bwd_smem_bytes(int H) {
  return rows_smem(tf::Dims(H, 1), 1);
}

// Bytes of the scratch buffer a call over R rows takes: the prepared
// weights, dl rows, db slots and split slots (BwdLayout).
size_t fused_ll_bwd_scratch_bytes(int R, int H, int D) {
  return BwdLayout(R, H, D).total;
}

// Rows of a row-phase CTA for R rows (16 per group), as the launch picks
// them.
int fused_ll_bwd_cta_rows(int R, int H) {
  return 16 * rows_groups(R, tf::Dims(H, 1));
}

// Row splits of the weight-gradient phase for R rows.
int fused_ll_bwd_splits(int R) { return BwdLayout(R, 1, 1).S; }

// Every pointer but `scratch` is a contiguous fp32 device buffer: h [R, H],
// w [H, D], bias [D], x [B, D], g [R]; outputs dh [R, H] and grads [H * D +
// D] (dW then db); scratch holds fused_ll_bwd_scratch_bytes (256-byte
// aligned). Launches every kernel on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
int fused_ll_bwd(const void* h, const void* w, const void* bias,
                 const void* x, const void* g, void* dh, void* grads,
                 void* scratch, int R, int B, int H, int D, void* stream) {
  if (R <= 0 || B <= 0 || H <= 0 || D <= 0 || R % B != 0)
    return (int)cudaErrorInvalidValue;
  const BwdLayout L(R, H, D);
  const tf::Dims& d = L.d;
  if (d.nks > tf::MAXKS || (d.nks + tf::WPG - 1) / tf::WPG > NJB)
    return (int)cudaErrorInvalidValue;  // H > 256
  const int G = rows_groups(R, d);
  const size_t smem = rows_smem(d, G);
  if (smem > tf::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned char* sc = (unsigned char*)scratch;
  const float* fh = (const float*)h;
  cudaError_t e = cudaFuncSetAttribute(
      fused_ll_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = tf::launch_prep((const float*)w, at<float>(sc, 0), d, s);
  if (e != cudaSuccess) return (int)e;
  fused_ll_bwd_rows<<<(R + 16 * G - 1) / (16 * G), (G * tf::WPG + 1) * 32,
                      smem, s>>>(fh, (const float*)bias, (const float*)x,
                           (const float*)g, (float*)dh, sc, R, B, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + 63) / 64) * ((D + 63) / 64) +
                      (D + WG_THREADS - 1) / WG_THREADS,
                  L.S);
  if (H % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0) {
    e = allow_smem(fused_ll_bwd_wgrad<true>, WG_SMEM);
    if (e != cudaSuccess) return (int)e;
    fused_ll_bwd_wgrad<true><<<grid, WG_THREADS, WG_SMEM, s>>>(fh, sc, R, L);
  } else {
    e = allow_smem(fused_ll_bwd_wgrad<false>, WG_SMEM);
    if (e != cudaSuccess) return (int)e;
    fused_ll_bwd_wgrad<false><<<grid, WG_THREADS, WG_SMEM, s>>>(fh, sc, R, L);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_slots(at<float>(sc, L.o_slots), (float*)grads,
                           L.slot_len, L.S, s);
}

}  // extern "C"
