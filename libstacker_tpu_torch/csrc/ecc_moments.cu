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
// What bounds it on the H100.  A sweep must stream each lane's template
// (4 B/px) and the shared sources once: ~3.4 GB for 99 lanes of
// 2160x3840, ~1 ms at 3.35 TB/s.  Issuing ~130-180 float operations
// per pixel-lane (coordinates, 1/32 binning, 3 bilinear lerps, the
// Jacobian, 30 or 66 sums) binds more: ~2.6 ms at 67 T operations/s with
// the Gram.
//
// Design:
// - The sources arrive interleaved as one texel array [H, W, 4] float32
//   (image, gx, gy, inputMask or 0), packed once per pyramid level
//   (ops/ecc_cuda.pack_texels): a bilinear tap is one 16-byte
//   ld.global.nc.v4, 4 loads a pixel-lane instead of 12.  The masked
//   form's nearest tap is a 4-byte read of component 3.
// - Grid (lane, tile), lanes fastest: the blocks resident at one time
//   work on a few tiles of every lane, so the tiles' texels are read
//   from DRAM once and then from L2 by the other lanes.  A tile is 128
//   columns by ROWS rows; each thread walks one column (the template
//   reads of a warp are coalesced, the column's products m0*x, m3*x,
//   m6*x are formed once), with the NOUT partial sums in registers.
//   ROWS = 64: a thread's float sum runs over 64 pixels (128 put B1
//   without the Gram at 8e-5 of a group's norm against its plain
//   version at 4K, near the 1e-4 bar; 64 gives ~1e-5).
// - The sums take fused multiply-adds (__fmaf_rn, honoured under
//   --fmad=false); every coordinate, bin and bilinear expression keeps
//   the plain version's order without contraction.  (Binning from
//   integers instead of rintf / floorf measured slower without the
//   Gram.)
// - __launch_bounds__ asks for 4 blocks per SM (<= 128 registers, no
//   spill) with 40 or more sums, 6 (<= 80) below: 5 blocks with the Gram
//   spilled ~100 bytes and ran slower.  chip_smoke.py prints what ptxas
//   allocated and spilled for each instance.
// - A block reduces its sums by a warp reduce-scatter (R * 31 shuffles a
//   lane for R = ceil(NOUT / 32), against 5 * NOUT for a shuffle tree per
//   sum) and shared memory into one column of per-block partials
//   [B, NOUT, nblk]; a second launch sums each lane's partials in double
//   in a fixed order: deterministic, no float atomics.  An inactive
//   lane's blocks write zero partials and return at once (10 of 99 lanes
//   active cost ~0.14 ms more than 10/99 of a full sweep, so they are
//   not skipped at launch).
//
// The window DMAs, pltpu.roll and the static (2k+4)^2 one-hot tap loop
// of the TPU kernel exist only for VMEM windows; a thread here gathers
// any source pixel, so there is no residual band and no k.
//
// Build with --fmad=false (utils/cuda_build.py): apart from the sums'
// explicit FMAs, every float expression is written in the order of the
// plain PyTorch version (ops/ecc_cuda.py ecc_iteration_moments_reference,
// built on ops/warp.py), so both land in the same 1/32-px bins.

#include "ecc_moments_common.cuh"

namespace {

constexpr int TILE_W = THREADS;  // a tile's columns: one per thread
constexpr int ROWS = 64;         // a tile's rows, walked by each thread

template <int P, bool HESS>
struct MinBlocks {
  static constexpr int value = Layout<P, HESS>::NOUT >= 40 ? 4 : 6;
};

// The homography Jacobian (hatX = sx, hatY = sy) given inv_den = 1 /
// (m6 * xs + m7 * ys + 1), the denominator without a zero guard: B1
// passes the reciprocal it already holds when m8 == 1.
__device__ __forceinline__ void jacobian_homography(float* jac, float gxw,
                                                    float gyw, float xs,
                                                    float ys, float sx,
                                                    float sy, float inv_den) {
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

// Motion-model Jacobian (OpenCV image_jacobian_*_ECC) for P = 2/3/6.
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
  } else {
    static_assert(P == 6, "the homography's is jacobian_homography");
    jac[0] = gxw * xs;
    jac[1] = gyw * xs;
    jac[2] = gxw * ys;
    jac[3] = gyw * ys;
    jac[4] = gxw;
    jac[5] = gyw;
  }
}

template <int P, bool HESS, bool MASKED>
__global__ void __launch_bounds__(THREADS, (MinBlocks<P, HESS>::value))
moments_kernel(const float4* __restrict__ tex, const float* __restrict__ tmpl,
               const float* __restrict__ m3,
               const uint8_t* __restrict__ active,
               float* __restrict__ partials, int H, int W, int ncol,
               int nblk, int quant_affine) {
  constexpr int NOUT = Layout<P, HESS>::NOUT;
  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  float* part = partials + (size_t)b * NOUT * nblk + tile;
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

  const int x = (tile % ncol) * TILE_W + threadIdx.x;
  const int y_begin = (tile / ncol) * ROWS;
  const int y_end = min(y_begin + ROWS, H);
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  if (x < W) {
    const float xs = (float)x;
    // the coordinates' column products, the same values in every row
    const float m0x = m[0] * xs, m3x = m[3] * xs, m6x = m[6] * xs;
    const float* tp = tmpl + (size_t)b * H * W + x;
    float ys = (float)y_begin;
    for (int y = y_begin; y < y_end; ++y, ys += 1.0f) {
      const float dxy = m6x + m[7] * ys;  // m6*x + m7*y
      const float den = dxy + m[8];
      const float inv = den != 0.0f ? 1.0f / den : 0.0f;
      const float sx = (m0x + m[1] * ys + m[2]) * inv;
      const float sy = (m3x + m[4] * ys + m[5]) * inv;

      // INTER_NEAREST validity mask from the unquantised coordinate
      const float xi = rintf(sx);
      const float yi = rintf(sy);
      const bool inside = xi >= 0.0f && xi <= wm1 && yi >= 0.0f && yi <= hm1;
      float mask = inside ? 1.0f : 0.0f;
      if constexpr (MASKED) {
        if (inside) {
          mask = __ldg(reinterpret_cast<const float*>(tex) +
                       ((int)yi * W + (int)xi) * 4 + 3);
        }
      }

      // int texel offsets (H * W * 4 < 2^31): 64-bit ones measured slower
      const Taps c(sx, sy, H, W, quant_affine);
      const int i00 = (int)c.r0 + c.x0;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 t00 = c.v00 ? __ldg(tex + i00) : zero;
      const float4 t01 = c.v01 ? __ldg(tex + i00 + 1) : zero;
      const float4 t10 = c.v10 ? __ldg(tex + i00 + W) : zero;
      const float4 t11 = c.v11 ? __ldg(tex + i00 + W + 1) : zero;
      const float imw = c.lerp(t00.x, t01.x, t10.x, t11.x);
      const float gxw = c.lerp(t00.y, t01.y, t10.y, t11.y);
      const float gyw = c.lerp(t00.z, t01.z, t10.z, t11.z);
      const float tm = tp[y * W];

      float jac[P];
      if constexpr (P == 8) {
        // den of the Jacobian is m6*x + m7*y + 1: the coordinate's den
        // when m8 == 1, as the solver keeps it
        float inv_den;
        if (m[8] == 1.0f && den != 0.0f) {
          inv_den = inv;
        } else {
          inv_den = 1.0f / (dxy + 1.0f);
        }
        jacobian_homography(jac, gxw, gyw, xs, ys, sx, sy, inv_den);
      } else {
        jacobian<P>(jac, gxw, gyw, xs, ys, sx, sy, m);
      }

      const float mi = mask * imw;
      const float mt = mask * tm;
      acc[0] += mask;
      acc[1] += mi;
      acc[2] = __fmaf_rn(mi, imw, acc[2]);
      acc[3] += mt;
      acc[4] = __fmaf_rn(mt, tm, acc[4]);
      acc[5] = __fmaf_rn(mt, imw, acc[5]);
#pragma unroll
      for (int a = 0; a < P; ++a) {
        acc[6 + a] = __fmaf_rn(jac[a], imw, acc[6 + a]);
        acc[6 + P + a] = __fmaf_rn(jac[a], mask, acc[6 + P + a]);
        acc[6 + 2 * P + a] = __fmaf_rn(jac[a], mt, acc[6 + 2 * P + a]);
      }
      if constexpr (HESS) {
        int idx = 6 + 3 * P;
#pragma unroll
        for (int a = 0; a < P; ++a) {
#pragma unroll
          for (int q = a; q < P; ++q) {
            acc[idx] = __fmaf_rn(jac[a], jac[q], acc[idx]);
            ++idx;
          }
        }
      }
    }
  }
  block_reduce_scatter_store<NOUT>(acc, part, nblk);
}

int num_cols(int W) { return (W + TILE_W - 1) / TILE_W; }
int num_tiles(int H, int W) { return num_cols(W) * ((H + ROWS - 1) / ROWS); }

}  // namespace

extern "C" {

// The number of per-block partials of one lane (the wrapper's scratch).
int ecc_moments_num_blocks(int H, int W) { return num_tiles(H, W); }

// tex [H,W,4] f32 texels (image, gx, gy, inputMask or 0), tmpl [B,H,W]
// f32, m3 [B,3,3] f32 (inverse maps), active [B] u8, partials
// [B, n_out, nblk] f32 scratch, out [B, n_out] f32.
int ecc_moments(const void* tex, const void* tmpl, const void* m3,
                const void* active, void* partials, void* out, int B, int H,
                int W, int n_params, int with_hessian, int quant_affine,
                int masked, void* stream) {
  // int texel offsets
  if (B <= 0 || H <= 0 || W <= 0 || (size_t)H * W * 4 > 0x7fffffffu) {
    return (int)cudaErrorInvalidValue;
  }
  const int nblk = num_tiles(H, W);
  if (nblk > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const int ncol = num_cols(W);
  auto tx = static_cast<const float4*>(tex);
  auto t = static_cast<const float*>(tmpl);
  auto m = static_cast<const float*>(m3);
  auto a = static_cast<const uint8_t*>(active);
  auto pp = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(n_params, with_hessian, [&](auto pc, auto hc) {
    constexpr int P = decltype(pc)::value;
    constexpr bool HESS = decltype(hc)::value;
    const dim3 grid(B, nblk);
    if (masked) {
      moments_kernel<P, HESS, true><<<grid, THREADS, 0, st>>>(
          tx, t, m, a, pp, H, W, ncol, nblk, quant_affine);
    } else {
      moments_kernel<P, HESS, false><<<grid, THREADS, 0, st>>>(
          tx, t, m, a, pp, H, W, ncol, nblk, quant_affine);
    }
    return reduce_partials<Layout<P, HESS>::NOUT>(pp, o, B, nblk, st);
  });
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
