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
// What bounds it on the H100.  A sweep must read each lane's template
// once and the one shared input plane once: ~3.4 GB for 99 lanes of
// 2160x3840, ~1 ms at 3.35 TB/s.  As in B1 the float issue binds more:
// ~180 operations per pixel-lane with the Gram, ~110 without it.
//
// Design (B1's, csrc/ecc_moments.cu, applied to B7):
// - Grid (lane, tile), lanes fastest: the blocks resident at one time
//   work on a few tiles of every lane, so the shared input plane comes
//   from L2 instead of once per lane from DRAM.  A tile is 128 columns
//   by ROWS = 64 rows (B1's accuracy choice).
// - Each thread walks one column down its tile and keeps t[y-1], t[y]
//   and t[y+1] in registers: one template load a row, issued a row
//   ahead, gty from the registers, gtx from the neighbouring lanes' t[y]
//   by __shfl (a warp's 32 lanes are 32 neighbouring columns); only the
//   warp's two edge lanes load their outer neighbour, also a row ahead.
//   The column's products m0*x, m3*x, m6*x are formed once.
// - The Jacobian is multiplied by the mask once; the Gram's
//   S(m*jt_p*jt_q) then sums (m*jt_p)*(m*jt_q), the same value for a
//   mask of 0 or 1.
// - The Jacobian at the identity is written out with the identity's
//   entries folded (the same float values as the plain version's: x * 1
//   and 1 / 1 are exact), so no division is left in it.
// - The sums take fused multiply-adds (__fmaf_rn, honoured under
//   --fmad=false); the coordinates, bins and lerps keep the plain
//   version's order without contraction.
// - __launch_bounds__ asks for B1's occupancy: 4 blocks a SM (<= 128
//   registers) with the Gram, 6 (<= 80) without.
// - A block reduces its sums by B1's warp reduce-scatter
//   (block_reduce_scatter_store) and shared memory into one column of
//   per-block partials [B, NOUT, nblk]; a
//   second launch sums each lane's partials in double in a fixed order.
//   An inactive lane's blocks write zero partials and return.
// The TPU kernel's haloed template-window DMA, its pltpu.roll origin fix
// and the (8,128) pre-pad (:504-520, :548-555) exist for VMEM windows.
//
// Build with --fmad=false (utils/cuda_build.py): apart from the sums'
// explicit FMAs, the float expressions follow the plain PyTorch version
// (ops/ecc_cuda.py ecc_ic_iteration_moments_reference, built on
// ops/warp.py) term for term.

#include "ecc_moments_common.cuh"

namespace {

constexpr int TILE_W = THREADS;  // a tile's columns: one per thread
constexpr int ROWS = 64;         // a tile's rows, walked by each thread
constexpr unsigned FULL = 0xffffffffu;

template <int P, bool HESS>
struct MinBlocks {
  static constexpr int value = Layout<P, HESS>::NOUT >= 40 ? 3 : 6;
};

// The motion model's Jacobian of (gtx, gty) at the identity warp: the
// plain version's expressions (ops/ecc_cuda._jacobian with sx = x,
// sy = y and the identity's entries) with the exact products by 1 and 0
// folded.
template <int P>
__device__ __forceinline__ void jacobian_at_identity(float* jac, float gtx,
                                                     float gty, float xs,
                                                     float ys) {
  if constexpr (P == 2) {
    jac[0] = gtx;
    jac[1] = gty;
  } else if constexpr (P == 3) {
    jac[0] = gtx * -ys + gty * xs;
    jac[1] = gtx;
    jac[2] = gty;
  } else if constexpr (P == 6) {
    jac[0] = gtx * xs;
    jac[1] = gty * xs;
    jac[2] = gtx * ys;
    jac[3] = gty * ys;
    jac[4] = gtx;
    jac[5] = gty;
  } else {
    const float tmp = xs * gtx + ys * gty;
    jac[0] = gtx * xs;
    jac[1] = gty * xs;
    jac[2] = -tmp * xs;
    jac[3] = gtx * ys;
    jac[4] = gty * ys;
    jac[5] = -tmp * ys;
    jac[6] = gtx;
    jac[7] = gty;
  }
}

template <int P, bool HESS>
__global__ void __launch_bounds__(THREADS, (MinBlocks<P, HESS>::value))
ic_moments_kernel(const float* __restrict__ src, const float* __restrict__ tmpl,
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

  const int lane = threadIdx.x & 31;
  const int x = (tile % ncol) * TILE_W + threadIdx.x;
  const int y_begin = (tile / ncol) * ROWS;
  const int y_end = min(y_begin + ROWS, H);
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const bool col = x < W;
  const bool gx_ok = x >= 1 && x <= W - 2;
  // the warp's edge lanes load their outer neighbour: -1 on lane 0, +1 on 31
  const bool edge = gx_ok && (lane == 0 || lane == 31);
  const int edge_dx = lane == 0 ? -1 : 1;
  const float xs = (float)x;
  // the coordinates' column products, the same values in every row
  const float m0x = m[0] * xs, m3x = m[3] * xs, m6x = m[6] * xs;
  const float* tp = tmpl + (size_t)b * H * W + x;
  // the column's template at rows y-1, y, y+1, and the edge lanes' outer
  // neighbour at row y; rows y+2 and y+1 of those are loaded a row ahead
  float t_up = (col && y_begin >= 1) ? tp[(size_t)(y_begin - 1) * W] : 0.0f;
  float t_mid = col ? tp[(size_t)y_begin * W] : 0.0f;
  float t_dn = (col && y_begin + 1 < H) ? tp[(size_t)(y_begin + 1) * W] : 0.0f;
  float e_mid = edge ? tp[(size_t)y_begin * W + edge_dx] : 0.0f;
  float ys = (float)y_begin;
  for (int y = y_begin; y < y_end; ++y, ys += 1.0f) {
    const float t_next = (col && y + 2 < H) ? tp[(size_t)(y + 2) * W] : 0.0f;
    const float e_next =
        (edge && y + 1 < y_end) ? tp[(size_t)(y + 1) * W + edge_dx] : 0.0f;
    float tl = __shfl_up_sync(FULL, t_mid, 1);
    float tr = __shfl_down_sync(FULL, t_mid, 1);
    if (lane == 0) tl = e_mid;
    if (lane == 31) tr = e_mid;
    if (col) {
      // ops/warp.py _dst_coords' perspective form, with the column products
      const float den = m6x + m[7] * ys + m[8];
      const float inv = den != 0.0f ? 1.0f / den : 0.0f;
      const float sx = (m0x + m[1] * ys + m[2]) * inv;
      const float sy = (m3x + m[4] * ys + m[5]) * inv;

      const float xi = rintf(sx);
      const float yi = rintf(sy);
      const bool inside = xi >= 0.0f && xi <= wm1 && yi >= 0.0f && yi <= hm1;
      const float mask = inside ? 1.0f : 0.0f;
      const float imw = Taps(sx, sy, H, W, quant_affine).sample(src);

      // the template at the identity and its central differences
      const float tm = t_mid;
      const float gtx = gx_ok ? 0.5f * (tr - tl) : 0.0f;
      const float gty = (y >= 1 && y <= H - 2) ? 0.5f * (t_dn - t_up) : 0.0f;

      // the Jacobian times the mask (mask * mask == mask in the Gram)
      float jm[P];
      jacobian_at_identity<P>(jm, gtx, gty, xs, ys);
#pragma unroll
      for (int a = 0; a < P; ++a) jm[a] = jm[a] * mask;

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
        acc[6 + a] = __fmaf_rn(jm[a], imw, acc[6 + a]);
        acc[6 + P + a] += jm[a];
        acc[6 + 2 * P + a] = __fmaf_rn(jm[a], tm, acc[6 + 2 * P + a]);
      }
      if constexpr (HESS) {
        int idx = 6 + 3 * P;
#pragma unroll
        for (int a = 0; a < P; ++a) {
#pragma unroll
          for (int q = a; q < P; ++q) {
            acc[idx] = __fmaf_rn(jm[a], jm[q], acc[idx]);
            ++idx;
          }
        }
      }
    }
    t_up = t_mid;
    t_mid = t_dn;
    t_dn = t_next;
    e_mid = e_next;
  }
  block_reduce_scatter_store<NOUT>(acc, part, nblk);
}

int num_cols(int W) { return (W + TILE_W - 1) / TILE_W; }
int num_tiles(int H, int W) { return num_cols(W) * ((H + ROWS - 1) / ROWS); }

}  // namespace

extern "C" {

// The number of per-block partials of one lane (the wrapper's scratch).
int ecc_ic_moments_num_blocks(int H, int W) { return num_tiles(H, W); }

// src [H,W] f32 (the blurred input image), tmpl [B,H,W] f32 (blurred
// templates), m3 [B,3,3] f32 (inverse maps), active [B] u8, partials
// [B, n_out, nblk] f32 scratch, out [B, n_out] f32.
int ecc_ic_moments(const void* src, const void* tmpl, const void* m3,
                   const void* active, void* partials, void* out, int B,
                   int H, int W, int n_params, int with_hessian,
                   int quant_affine, void* stream) {
  if (B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int nblk = num_tiles(H, W);
  if (nblk > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const int ncol = num_cols(W);
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
    ic_moments_kernel<P, HESS><<<dim3(B, nblk), THREADS, 0, st>>>(
        s, t, m, a, pp, H, W, ncol, nblk, quant_affine);
    return reduce_partials<Layout<P, HESS>::NOUT>(pp, o, B, nblk, st);
  });
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
