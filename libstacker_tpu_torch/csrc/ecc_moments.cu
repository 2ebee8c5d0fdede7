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
// Build with --fmad=false (utils/cuda_build.py): every float expression
// below is written in the order of the plain PyTorch version
// (ops/ecc_cuda.py ecc_iteration_moments_reference, built on
// ops/warp.py), so both land in the same 1/32-px bins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int PIX_PER_THREAD = 32;
constexpr int PIX_PER_BLOCK = THREADS * PIX_PER_THREAD;
constexpr int RED_THREADS = 256;

template <int P, bool HESS>
struct Layout {
  static constexpr int NOUT = 6 + 3 * P + (HESS ? P * (P + 1) / 2 : 0);
};

// Motion-model Jacobian (OpenCV image_jacobian_*_ECC; P = 2/3/6/8).
template <int P>
__device__ __forceinline__ void jacobian(float* jac, float gxw, float gyw,
                                         float xs, float ys, float sx,
                                         float sy, const float* m) {
  if constexpr (P == 2) {
    jac[0] = gxw;
    jac[1] = gyw;
  } else if constexpr (P == 3) {
    const float h0 = m[0];  // cos(theta)
    const float h1 = m[3];  // sin(theta)
    const float hat_x = -xs * h1 - ys * h0;
    const float hat_y = xs * h0 - ys * h1;
    jac[0] = gxw * hat_x + gyw * hat_y;
    jac[1] = gxw;
    jac[2] = gyw;
  } else if constexpr (P == 6) {
    jac[0] = gxw * xs;
    jac[1] = gyw * xs;
    jac[2] = gxw * ys;
    jac[3] = gyw * ys;
    jac[4] = gxw;
    jac[5] = gyw;
  } else {
    // homography: hatX = sx, hatY = sy; den without a zero guard
    const float den = m[6] * xs + m[7] * ys + 1.0f;
    const float inv_den = 1.0f / den;
    const float gxd = gxw * inv_den;
    const float gyd = gyw * inv_den;
    const float tmp = sx * gxd + sy * gyd;
    jac[0] = gxd * xs;
    jac[1] = gyd * xs;
    jac[2] = -tmp * xs;
    jac[3] = gxd * ys;
    jac[4] = gyd * ys;
    jac[5] = -tmp * ys;
    jac[6] = gxd;
    jac[7] = gyd;
  }
}

template <int P, bool HESS, bool MASKED>
__global__ void __launch_bounds__(THREADS)
moments_kernel(const float* __restrict__ srcs, const float* __restrict__ tmpl,
               const float* __restrict__ m3,
               const uint8_t* __restrict__ active,
               float* __restrict__ partials, int H, int W, int nblk,
               int quant_affine) {
  constexpr int NOUT = Layout<P, HESS>::NOUT;
  __shared__ float red[THREADS / 32][NOUT];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  float* part = partials + (size_t)b * NOUT * nblk + blk;
  if (!active[b]) {
    for (int k = threadIdx.x; k < NOUT; k += THREADS) part[(size_t)k * nblk] = 0.0f;
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
  const float wm2 = (float)(W - 2), hm2 = (float)(H - 2);
  const size_t base = (size_t)blk * PIX_PER_BLOCK + threadIdx.x;

  for (int it = 0; it < PIX_PER_THREAD; ++it) {
    const size_t p = base + (size_t)it * THREADS;
    if (p >= hw) break;
    const int y = (int)(p / W);
    const int x = (int)(p - (size_t)y * W);
    const float xs = (float)x;
    const float ys = (float)y;

    // source coordinates (ops/warp.py _dst_coords, perspective form)
    const float den = m[6] * xs + m[7] * ys + m[8];
    const float inv = den != 0.0f ? 1.0f / den : 0.0f;
    const float sx = (m[0] * xs + m[1] * ys + m[2]) * inv;
    const float sy = (m[3] * xs + m[4] * ys + m[5]) * inv;

    // INTER_NEAREST validity mask from the unquantised coordinate
    const float xi = rintf(sx);
    const float yi = rintf(sy);
    const bool inside = xi >= 0.0f && xi <= wm1 && yi >= 0.0f && yi <= hm1;
    float mask = inside ? 1.0f : 0.0f;
    if constexpr (MASKED) {
      if (inside) mask = mkp[(size_t)(int)yi * W + (int)xi];
    }

    // 1/32-px quantisation (rintf rounds half to even, like torch.round)
    float xq, yq;
    if (quant_affine) {
      xq = floorf((rintf(sx * 1024.0f) + 16.0f) / 32.0f);
      yq = floorf((rintf(sy * 1024.0f) + 16.0f) / 32.0f);
    } else {
      xq = rintf(sx * 32.0f);
      yq = rintf(sy * 32.0f);
    }
    const float x0f = floorf(xq * (1.0f / 32.0f));
    const float y0f = floorf(yq * (1.0f / 32.0f));
    const float fx = (xq - x0f * 32.0f) * (1.0f / 32.0f);
    const float fy = (yq - y0f * 32.0f) * (1.0f / 32.0f);
    const bool vx0 = x0f >= 0.0f && x0f <= wm1;
    const bool vx1 = x0f >= -1.0f && x0f <= wm2;
    const bool vy0 = y0f >= 0.0f && y0f <= hm1;
    const bool vy1 = y0f >= -1.0f && y0f <= hm2;
    const int x0 = (vx0 || vx1) ? (int)x0f : 0;
    const int y0 = (vy0 || vy1) ? (int)y0f : 0;
    const size_t r0 = (size_t)y0 * W;
    const size_t r1 = r0 + W;

    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* s = c == 0 ? img : (c == 1 ? gxp : gyp);
      const float t00 = (vy0 && vx0) ? s[r0 + x0] : 0.0f;
      const float t01 = (vy0 && vx1) ? s[r0 + x0 + 1] : 0.0f;
      const float t10 = (vy1 && vx0) ? s[r1 + x0] : 0.0f;
      const float t11 = (vy1 && vx1) ? s[r1 + x0 + 1] : 0.0f;
      const float top = t00 * (1.0f - fx) + t01 * fx;
      const float bot = t10 * (1.0f - fx) + t11 * fx;
      v[c] = top * (1.0f - fy) + bot * fy;
    }
    const float imw = v[0];
    const float tm = tp[p];

    float jac[P];
    jacobian<P>(jac, v[1], v[2], xs, ys, sx, sy, m);

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

  // block reduction: warp shuffles, then the 4 warps in a fixed order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NOUT; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NOUT; k += THREADS) {
    float s = red[0][k];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) s += red[w][k];
    part[(size_t)k * nblk] = s;
  }
}

// out[b, k] = sum over blocks of partials[b, k, :], in double.
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
              int nblk, int nout) {
  __shared__ double sh[RED_THREADS];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const float* src = partials + ((size_t)b * nout + k) * nblk;
  double s = 0.0;
  for (int i = threadIdx.x; i < nblk; i += RED_THREADS) s += (double)src[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int st = RED_THREADS / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) sh[threadIdx.x] += sh[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(size_t)b * nout + k] = (float)sh[0];
}

template <int P, bool HESS>
cudaError_t launch(const float* srcs, const float* tmpl, const float* m3,
                   const uint8_t* active, float* partials, float* out, int B,
                   int H, int W, int nblk, int quant_affine, int masked,
                   cudaStream_t st) {
  constexpr int NOUT = Layout<P, HESS>::NOUT;
  if (masked) {
    moments_kernel<P, HESS, true><<<dim3(nblk, B), THREADS, 0, st>>>(
        srcs, tmpl, m3, active, partials, H, W, nblk, quant_affine);
  } else {
    moments_kernel<P, HESS, false><<<dim3(nblk, B), THREADS, 0, st>>>(
        srcs, tmpl, m3, active, partials, H, W, nblk, quant_affine);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_kernel<<<dim3(NOUT, B), RED_THREADS, 0, st>>>(partials, out, nblk,
                                                      NOUT);
  return cudaGetLastError();
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
  cudaError_t e;
  switch (n_params * 2 + (with_hessian ? 1 : 0)) {
    case 2 * 2 + 0: e = launch<2, false>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 2 * 2 + 1: e = launch<2, true>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 3 * 2 + 0: e = launch<3, false>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 3 * 2 + 1: e = launch<3, true>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 6 * 2 + 0: e = launch<6, false>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 6 * 2 + 1: e = launch<6, true>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 8 * 2 + 0: e = launch<8, false>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    case 8 * 2 + 1: e = launch<8, true>(s, t, m, a, pp, o, B, H, W, nblk, quant_affine, masked, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
