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
// fp32 in and out, with softplus(l) = max(l, 0) + log1p(exp(-|l|)).
//
// Bound at the train shape (k = 50, B = 100 -> R = 5000 rows, H = 200,
// D = 784): 2 R H D = 1.57 GFLOP against ~4.96 MB that must move (h 4.0 MB,
// W 0.63 MB, x 0.31 MB, out 20 KB), so it is bound by operations. Done
// fp32-accurate on the tensor cores as three TF32 products (3xTF32,
// tc_tf32.cuh), that is 4.70 GFLOP at 494.7 TFLOP/s: 0.0095 ms (0.023 ms
// for fp32 on the CUDA cores). At the eval chunk (k = 250, B = 500) 0.238
// ms. Besides the products each logit pays an exp and a log.
//
// Design (tc_tf32.cuh has the building blocks):
// - Launch anatomy: prep_weights writes W once per call into 64-column fp32
//   tiles in the caller's scratch, each the image of a ring slot; then the
//   row kernel. The wrapper counts the pair as one launch.
// - A 16-row group is 4 warps, each owning 16 columns of every tile (two n8
//   groups, 32 columns apart, so the last tile's are shared). A CTA holds G
//   groups, G = ceil(row groups / 132) up to 3 (tf::cta_groups): 3 at the
//   train shape (105 CTAs, one wave) and at the eval chunk. Each warp's
//   products are split by k8 steps with a second warp (KS = 2): 8 consumer
//   warps per group, and one producer warp.
// - h is staged once, split into hi and lo, in fragment order; W streams
//   through a 2-slot ring of 64-column fp32 tiles, one TMA bulk copy per
//   tile, tile n + 1 in flight while n multiplies. Slots are handed over by
//   mbarriers alone (tma::PipeRing): no CTA-wide barrier stops the warps at
//   every tile, which cost more than the products (PERF.md).
// - Every product is 3xTF32 mma.sync: the logits of a tile stay in the
//   accumulators, where x l - softplus(l) (pixels d >= D masked, x from
//   x[r % B], both loaded before the products) is added into two running
//   sums per lane, one per row the lane holds.
// - Row order: a row's sum runs over tiles in order, then the 4 lanes of the
//   row (a fixed butterfly), then the 4 warps of the group in order. None of
//   it depends on R, B or G: a row's result is the same bits in any batch.
//   No atomics.
// - Rows past R (the ragged last CTA) compute on zeros and are not written.

#include "tc_tf32.cuh"

namespace {

// A 16-column slice's logits are two half-sums over k8 steps, [0,
// floor(nks / 2)) and the rest, added in that order, each taken by one warp
// of a pair (KS); the second's pass through shared memory. Warp 0 only
// feeds the ring (tma::PipeRing): no CTA-wide barrier is met per tile, only
// a pair's. More warps and no lockstep hide the loads' and products'
// latency, which bound the loop (PERF.md).
constexpr int KS = 2;
constexpr int MAXG_FWD = 3;  // groups per CTA: 3 x 4 x 2 consumer warps
constexpr int FWD_THREADS = (MAXG_FWD * tf::WPG * KS + 1) * 32;

__global__ void __launch_bounds__(FWD_THREADS, 1)
    fused_ll_fwd_tc(const float* __restrict__ wp, const float* __restrict__ h,
                    const float* __restrict__ bias,
                    const float* __restrict__ x, float* __restrict__ out,
                    int R, int B, tf::Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * tf::RING];
  const int consumers = blockDim.x / 32 - 1;
  const int G = consumers / (tf::WPG * KS), rows = 16 * G;
  float* slots = reinterpret_cast<float*>(smem_raw);
  float* frags = slots + tf::RING * d.tile_floats();
  // the second warps' partial sums, by tile parity: [2][G][WPG][lane] 2 float4
  float4* xch = reinterpret_cast<float4*>(frags + (size_t)G * d.nks * 256);
  float* part = reinterpret_cast<float*>(xch + 2 * G * tf::WPG * 64);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows;

  tf::Pipe pipe = tf::make_pipe(slots, bars, wp, d, consumers);
  if (!tf::stage_and_feed(pipe, h, frags, r0, rows, R, d)) {
    const int cw = warp - 1, kh = cw % KS, wq = (cw / KS) % tf::WPG;
    const int grp = cw / (KS * tf::WPG), col = 8 * wq;
    const int g = lane >> 2, t = lane & 3;
    // the first warp of a pair also runs the epilogue: it takes the
    // smaller half (PERF.md)
    const int khalf = d.nks / 2;
    const int kb = kh ? khalf : 0, ke = kh ? d.nks : khalf;
    const float4* af =
        reinterpret_cast<const float4*>(frags) + (size_t)grp * d.nks * 64;
    const int ra = r0 + grp * 16 + g, rb = ra + 8;
    const float* xa = x + (size_t)((ra < R ? ra : 0) % B) * d.D;
    const float* xb = x + (size_t)((rb < R ? rb : 0) % B) * d.D;
    float sa = 0.f, sb = 0.f;
    for (int tile = 0; tile < d.nd; ++tile) {
      const int n0 = tile * tf::NT;
      float xv[2][4], bv[2][2];
      if (kh == 0) tf::load_pixels(xv, bv, xa, xb, bias, n0 + col, d.D);
      const float* st = reinterpret_cast<const float*>(pipe.wait(tile));
      float acc[2][4];
      tf::tile_fwd(acc, af, st, wq, kb, ke, d.nks, d.D - n0);
      pipe.release(tile);
      float4* xp =
          xch + (((tile & 1) * G * tf::WPG + grp * tf::WPG + wq) * 32 + lane) *
                    2;
      if (kh) {
        xp[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
        xp[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
      }
      // the second half is in place
      tf::named_sync(1 + grp * tf::WPG + wq, KS * 32);
      if (kh) continue;
      const float4 o0 = xp[0], o1 = xp[1];
      const float other[2][4] = {{o0.x, o0.y, o0.z, o0.w},
                                 {o1.x, o1.y, o1.z, o1.w}};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n0 + col + tf::NJ_STRIDE * j + 2 * t + e < d.D) {
            const float la = (acc[j][e] + other[j][e]) + bv[j][e];
            const float lb = (acc[j][2 + e] + other[j][2 + e]) + bv[j][e];
            sa += xv[j][e] * la - tf::softplus_fast(la);
            sb += xv[j][2 + e] * lb - tf::softplus_fast(lb);
          }
    }
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    if (kh == 0 && t == 0) {
      part[(grp * 16 + g) * tf::WPG + wq] = sa;
      part[(grp * 16 + g + 8) * tf::WPG + wq] = sb;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < rows && r0 + (int)threadIdx.x < R) {
    const float* p = part + threadIdx.x * tf::WPG;
    out[r0 + threadIdx.x] = ((p[0] + p[1]) + p[2]) + p[3];
  }
}

// Dynamic shared memory of a CTA of G groups: the ring, the groups' h
// fragments, the second warps' partial sums (two tiles' worth) and the
// per-warp row sums.
inline size_t smem_bytes(const tf::Dims& d, int G) {
  return d.ring_bytes() +
         G * (d.frag_bytes() + sizeof(float) * 16 * 32 * tf::WPG +
              sizeof(float) * 16 * tf::WPG);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the smallest CTA (one 16-row group) for hidden
// width H (bytes); wider CTAs are used only where they fit.
size_t fused_ll_fwd_smem_bytes(int H) { return smem_bytes(tf::Dims(H, 1), 1); }

// Bytes of the scratch buffer a call takes: the prepared weight tiles.
size_t fused_ll_fwd_scratch_bytes(int H, int D) {
  return tf::Dims(H, D).prep_bytes();
}

// Rows of a CTA for R rows (16 per group), as the launch picks them.
int fused_ll_fwd_cta_rows(int R, int H) {
  const tf::Dims d(H, 1);
  return 16 * tf::cta_groups(R, smem_bytes(d, 0),
                             smem_bytes(d, 1) - smem_bytes(d, 0), MAXG_FWD);
}

// out[r] for r < R = k * B; h [R, H], w [H, D], bias [D], x [B, D], out [R]
// are contiguous fp32 device buffers, scratch holds
// fused_ll_fwd_scratch_bytes (256-byte aligned). Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
int fused_ll_fwd(const void* h, const void* w, const void* bias,
                 const void* x, void* out, void* scratch, int R, int B, int H,
                 int D, void* stream) {
  if (R <= 0 || B <= 0 || H <= 0 || D <= 0 || R % B != 0)
    return (int)cudaErrorInvalidValue;
  const tf::Dims d(H, D);
  if (d.nks > tf::MAXKS) return (int)cudaErrorInvalidValue;  // H > 256
  const int rows = fused_ll_fwd_cta_rows(R, H), G = rows / 16;
  const size_t smem = smem_bytes(d, G);
  if (smem > tf::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      fused_ll_fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  float* wp = (float*)scratch;
  e = tf::launch_prep((const float*)w, wp, d, s);
  if (e != cudaSuccess) return (int)e;
  fused_ll_fwd_tc<<<(R + rows - 1) / rows, (G * tf::WPG * KS + 1) * 32, smem,
                    s>>>(wp, (const float*)h, (const float*)bias,
                         (const float*)x, (float*)out, R, B, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
