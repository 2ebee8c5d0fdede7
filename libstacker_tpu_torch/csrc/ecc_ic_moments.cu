// One inverse-compositional ECC Gauss-Newton iteration, reduced to raw
// moments (kernel B7).
//
// Replaces the Pallas TPU kernel libstacker_tpu/ops/ecc_pallas.py
// _ic_moments_kernel (:460, body :522-621; entry ecc_ic_iteration_moments
// :631).  Per lane b and output pixel (x, y):
//
//   (sx, sy) = M_b (x, y, 1)               (inverse map, float32)
//   imw      = 1/32-px quantised bilinear tap of the input image,
//              BORDER_CONSTANT 0 (one source plane, not B1's three)
//   mask     = INTER_NEAREST validity of the UNquantised (sx, sy)
//   t        = template_b at (x, y)        (the identity warp)
//   gtx, gty = 0.5 * (t[x+1] - t[x-1]), 0.5 * (t[y+1] - t[y-1]); zero on
//              the first and last column (gtx) or row (gty): reflect-101
//              central differences vanish there (:574-585)
//   jt_p     = the motion model's Jacobian of (gtx, gty) at the identity
//              warp, projective denominator 1 (:591-593)
//
// summed over the image into
//   [ n, S(m*i), S(m*i^2), S(m*t), S(m*t^2), S(m*t*i),
//     S(m*jt_p*i) (P), S(m*jt_p) (P), S(m*jt_p*t) (P)
//     [, S(m*jt_p*jt_q) upper triangle (P(P+1)/2) when HESS] ]
// (mask^2 == mask in the Gram, :613-617).  The host solver
// (ops/ecc.py, mode 'ic') computes the Gram once per lane and carries it.
//
// What bounds it on the H100.  A sweep reads each lane's template once
// (plus its 4 neighbours, L1/L2 hits) and gathers 4 taps of the one
// shared input plane: ~3.4 GB for 99 lanes of 2160x3840, ~1 ms at
// 3.35 TB/s.  As in B1 the float issue binds: ~190 separately rounded
// operations per pixel-lane with the Gram, ~120 without it.
//
// Design: B1's (csrc/ecc_moments.cu), on the same helpers
// (csrc/ecc_moments_common.cuh): grid (pixel blocks, lane), each thread
// walks PIX_PER_THREAD pixels with the NOUT partial sums in registers, a
// block reduces them by warp shuffles and shared memory into one column
// of per-block partials, and a second launch sums each lane's partials in
// double in a fixed order.  Inactive lanes write zero partials and
// return.  The TPU kernel's haloed template-window DMA, its
// pltpu.roll origin fix and the (8,128) pre-pad (:504-520, :548-555)
// exist for VMEM windows; a thread here reads t[y][x +- 1] directly.
//
// Build with --fmad=false (utils/cuda_build.py): the float expressions
// follow the plain PyTorch version (ops/ecc_cuda.py
// ecc_ic_iteration_moments_reference, built on ops/warp.py) term for term.

#include "ecc_moments_common.cuh"

namespace {

template <int P, bool HESS>
__global__ void __launch_bounds__(THREADS)
ic_moments_kernel(const float* __restrict__ src, const float* __restrict__ tmpl,
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
  const float ident[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};

  float acc[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;

  const size_t hw = (size_t)H * W;
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

    const float xi = rintf(sx);
    const float yi = rintf(sy);
    const float mask =
        (xi >= 0.0f && xi <= wm1 && yi >= 0.0f && yi <= hm1) ? 1.0f : 0.0f;
    const float imw = Taps(sx, sy, H, W, quant_affine).sample(src);

    // template at the identity and its central differences
    const float tm = tp[p];
    const float gtx = (x >= 1 && x <= W - 2) ? 0.5f * (tp[p + 1] - tp[p - 1]) : 0.0f;
    const float gty = (y >= 1 && y <= H - 2) ? 0.5f * (tp[p + W] - tp[p - W]) : 0.0f;

    float jac[P];
    jacobian<P>(jac, gtx, gty, xs, ys, xs, ys, ident);

    const float mi = mask * imw;
    const float mt = mask * tm;
    acc[0] += mask;
    acc[1] += mi;
    acc[2] += mi * imw;
    acc[3] += mt;
    acc[4] += mt * tm;
    acc[5] += mt * imw;
    float jm[P];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      jm[a] = jac[a] * mask;
      acc[6 + a] += jm[a] * imw;
      acc[6 + P + a] += jm[a];
      acc[6 + 2 * P + a] += jm[a] * tm;
    }
    if constexpr (HESS) {
      int idx = 6 + 3 * P;
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int q = a; q < P; ++q) acc[idx++] += jm[a] * jac[q];
      }
    }
  }
  block_reduce_store<NOUT>(acc, part, nblk);
}

}  // namespace

extern "C" {

int ecc_ic_moments_pixels_per_block() { return PIX_PER_BLOCK; }

// src [H,W] f32 (the blurred input image), tmpl [B,H,W] f32 (blurred
// templates), m3 [B,3,3] f32 (inverse maps), active [B] u8, partials
// [B, n_out, nblk] f32 scratch, out [B, n_out] f32.
int ecc_ic_moments(const void* src, const void* tmpl, const void* m3,
                   const void* active, void* partials, void* out, int B,
                   int H, int W, int n_params, int with_hessian,
                   int quant_affine, void* stream) {
  const size_t hw = (size_t)H * W;
  const int nblk = (int)((hw + PIX_PER_BLOCK - 1) / PIX_PER_BLOCK);
  if (B <= 0 || nblk <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto t = static_cast<const float*>(tmpl);
  auto m = static_cast<const float*>(m3);
  auto a = static_cast<const uint8_t*>(active);
  auto pp = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(n_params, with_hessian, [&](auto pc, auto hc) {
    constexpr int P = decltype(pc)::value;
    constexpr bool HESS = decltype(hc)::value;
    ic_moments_kernel<P, HESS><<<dim3(nblk, B), THREADS, 0, st>>>(
        s, t, m, a, pp, H, W, nblk, quant_affine);
    return reduce_partials<Layout<P, HESS>::NOUT>(pp, o, B, nblk, st);
  });
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
