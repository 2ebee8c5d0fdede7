// One forward-additive ECC Gauss-Newton iteration, reduced to raw moments.
//
// Replaces the Pallas TPU kernel libstacker_tpu/ops/ecc_pallas.py
// _moments_kernel (body _moments_tile_body :151-289, entry
// ecc_iteration_moments :299).  Per lane b and output pixel (x, y):
//
//   (sx, sy) = M_b (x, y, 1)                (inverse map, float32)
//   1/32-px quantised bilinear taps of image, gx, gy, BORDER_CONSTANT 0
//   mask     = INTER_NEAREST validity of the UNquantised (sx, sy)
//   jac_p    = the motion model's Jacobian (_jac_tile_fields :70)
//
// With MASKED (the 4-plane form, ecc_pallas.py:202-247) a 4th source
// plane holds cv2's preprocessed binary inputMask (ops/ecc.py
// _prepare_masked_input): its INTER_NEAREST tap at the unquantised
// (sx, sy), BORDER_CONSTANT 0, replaces the all-ones validity mask, as
// the XLA path's per-iteration nearest warp of the mask does
// (libstacker_tpu/ops/ecc.py:796-814).  The gradient planes arrive
// already multiplied by the mask.
//
// summed over the image into
//   [ n, S(m*i), S(m*i^2), S(m*t), S(m*t^2), S(m*t*i),
//     S(jac_p*i) (P), S(jac_p*m) (P), S(jac_p*m*t) (P)
//     [, S(jac_p*jac_q) upper triangle (P(P+1)/2) when HESS] ]
// (66 values for a homography).  The host solver (ops/ecc.py) rebuilds
// OpenCV's quantities from these sums.
//
// What bounds it on the H100.  The DRAM traffic is small: a sweep
// streams each lane's template once (4 B/px) and gathers 4 taps from
// each of the three shared source planes (image, gx, gy; 33 MB each at
// 4K, so the gathers mostly hit L2 when the warps are near the
// identity) -- ~3.4 GB for 99 lanes of 2160x3840, ~1 ms at 3.35 TB/s.
// No image-sized intermediate is written: the TPU kernel's point, kept
// here.  What binds is issue: ~200 separately rounded float operations
// per pixel-lane (66 products and sums, coordinates, 12 gathers) at
// 123 registers a thread for P=8 (a quarter of the SM's warps in
// flight).  Measured on an H100 80GB HBM3 at 700 W: 16.4 ms per 99-lane
// 4K sweep, about 3x the ~5 ms floor of those operations without FMA.
//
// Design: grid (pixel blocks, lane).  Each thread walks PIX_PER_THREAD
// pixels (coalesced template reads) and keeps the NOUT partial sums in
// registers; a block reduces them by warp shuffles and shared memory
// and writes one column of per-block partials [B, NOUT, nblk].  A second
// launch sums each lane's partials in double, in a fixed order: the
// result is deterministic, with no float atomics.  An inactive lane
// writes zero partials and returns at once.
//
// The window DMAs, pltpu.roll and the static (2k+4)^2 one-hot tap loop
// of the TPU kernel exist only for VMEM windows; a thread here gathers
// any source pixel, so there is no residual band and no k.
//
// The coordinates, taps, Jacobian and reductions it shares with B7
// (csrc/ecc_ic_moments.cu) are in csrc/ecc_moments_common.cuh.
//
// Build with --fmad=false (utils/cuda_build.py): every float expression
// is written in the order of the plain PyTorch version
// (ops/ecc_cuda.py ecc_iteration_moments_reference, built on
// ops/warp.py), so both land in the same 1/32-px bins.

#include "ecc_moments_common.cuh"

namespace {

template <int P, bool HESS, bool MASKED>
__global__ void __launch_bounds__(THREADS)
moments_kernel(const float* __restrict__ srcs, const float* __restrict__ tmpl,
               const float* __restrict__ m3,
               const uint8_t* __restrict__ active,
               float* __restrict__ partials, int H, int W, int nblk,
               int quant_affine) {
  constexpr int NOUT = Layout<P, HESS>::NOUT;
  const int b = blockIdx.y;
  float* part = partials + (size_t)b * NOUT * nblk + blockIdx.x;
  if (!active[b]) {
    zero_partials<NOUT>(part, nblk);
    return;
  }
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = m3[b * 9 + i];

  float acc[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;

  const size_t hw = (size_t)H * W;
  const float* img = srcs;
  const float* gxp = srcs + hw;
  const float* gyp = srcs + 2 * hw;
  const float* mkp = srcs + 3 * hw;  // read only when MASKED
  const float* tp = tmpl + (size_t)b * hw;
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const size_t base = (size_t)blockIdx.x * PIX_PER_BLOCK + threadIdx.x;

  for (int it = 0; it < PIX_PER_THREAD; ++it) {
    const size_t p = base + (size_t)it * THREADS;
    if (p >= hw) break;
    const int y = (int)(p / W);
    const int x = (int)(p - (size_t)y * W);
    const float xs = (float)x;
    const float ys = (float)y;
    float sx, sy;
    source_coords(m, xs, ys, sx, sy);

    // INTER_NEAREST validity mask from the unquantised coordinate
    const float xi = rintf(sx);
    const float yi = rintf(sy);
    const bool inside = xi >= 0.0f && xi <= wm1 && yi >= 0.0f && yi <= hm1;
    float mask = inside ? 1.0f : 0.0f;
    if constexpr (MASKED) {
      if (inside) mask = mkp[(size_t)(int)yi * W + (int)xi];
    }

    const Taps taps(sx, sy, H, W, quant_affine);
    const float imw = taps.sample(img);
    const float tm = tp[p];
    float jac[P];
    jacobian<P>(jac, taps.sample(gxp), taps.sample(gyp), xs, ys, sx, sy, m);

    const float mi = mask * imw;
    const float mt = mask * tm;
    acc[0] += mask;
    acc[1] += mi;
    acc[2] += mi * imw;
    acc[3] += mt;
    acc[4] += mt * tm;
    acc[5] += mt * imw;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      acc[6 + a] += jac[a] * imw;
      acc[6 + P + a] += jac[a] * mask;
      acc[6 + 2 * P + a] += jac[a] * mt;
    }
    if constexpr (HESS) {
      int idx = 6 + 3 * P;
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int q = a; q < P; ++q) acc[idx++] += jac[a] * jac[q];
      }
    }
  }
  block_reduce_store<NOUT>(acc, part, nblk);
}

}  // namespace

extern "C" {

int ecc_moments_pixels_per_block() { return PIX_PER_BLOCK; }

// srcs [3,H,W] f32 (masked: [4,H,W], the 4th plane the inputMask), tmpl
// [B,H,W] f32, m3 [B,3,3] f32 (inverse maps), active [B] u8, partials
// [B, n_out, nblk] f32 scratch, out [B, n_out] f32.
int ecc_moments(const void* srcs, const void* tmpl, const void* m3,
                const void* active, void* partials, void* out, int B, int H,
                int W, int n_params, int with_hessian, int quant_affine,
                int masked, void* stream) {
  const size_t hw = (size_t)H * W;
  const int nblk = (int)((hw + PIX_PER_BLOCK - 1) / PIX_PER_BLOCK);
  if (B <= 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(srcs);
  auto t = static_cast<const float*>(tmpl);
  auto m = static_cast<const float*>(m3);
  auto a = static_cast<const uint8_t*>(active);
  auto pp = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(n_params, with_hessian, [&](auto pc, auto hc) {
    constexpr int P = decltype(pc)::value;
    constexpr bool HESS = decltype(hc)::value;
    const dim3 grid(nblk, B);
    if (masked) {
      moments_kernel<P, HESS, true><<<grid, THREADS, 0, st>>>(
          s, t, m, a, pp, H, W, nblk, quant_affine);
    } else {
      moments_kernel<P, HESS, false><<<grid, THREADS, 0, st>>>(
          s, t, m, a, pp, H, W, nblk, quant_affine);
    }
    return reduce_partials<Layout<P, HESS>::NOUT>(pp, o, B, nblk, st);
  });
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
