// Device code shared by the two ECC moment sweeps: csrc/ecc_moments.cu
// (B1, forward additive) and csrc/ecc_ic_moments.cu (B7, inverse
// compositional).  Both bin every source coordinate like ops/warp.py,
// reduce a block's sums by a warp reduce-scatter and the per-block
// partials in double; each walks its tiles, samples and sums in its own
// source.  Their register allocation, and so their times, can move with
// any change here.
//
// Build with --fmad=false (utils/cuda_build.py): every float expression
// here is written in the order of the plain PyTorch versions
// (ops/ecc_cuda.py, built on ops/warp.py), so both land in the same
// 1/32-px bins.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage: each source is its own library.
namespace {

constexpr int THREADS = 128;
constexpr int RED_THREADS = 256;

template <int P, bool HESS>
struct Layout {
  static constexpr int NOUT = 6 + 3 * P + (HESS ? P * (P + 1) / 2 : 0);
};

// The 4 taps of a 1/32-px quantised bilinear sample, BORDER_CONSTANT 0
// (rintf rounds half to even, like torch.round).
struct Taps {
  size_t r0, r1;
  int x0;
  float fx, fy;
  bool v00, v01, v10, v11;

  __device__ __forceinline__ Taps(float sx, float sy, int H, int W,
                                  int quant_affine) {
    const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
    const float wm2 = (float)(W - 2), hm2 = (float)(H - 2);
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
    fx = (xq - x0f * 32.0f) * (1.0f / 32.0f);
    fy = (yq - y0f * 32.0f) * (1.0f / 32.0f);
    const bool vx0 = x0f >= 0.0f && x0f <= wm1;
    const bool vx1 = x0f >= -1.0f && x0f <= wm2;
    const bool vy0 = y0f >= 0.0f && y0f <= hm1;
    const bool vy1 = y0f >= -1.0f && y0f <= hm2;
    x0 = (vx0 || vx1) ? (int)x0f : 0;
    const int y0 = (vy0 || vy1) ? (int)y0f : 0;
    r0 = (size_t)y0 * W;
    r1 = r0 + W;
    v00 = vy0 && vx0;
    v01 = vy0 && vx1;
    v10 = vy1 && vx0;
    v11 = vy1 && vx1;
  }

  // the bilinear value of 4 taps the caller fetched, as sample() forms it
  __device__ __forceinline__ float lerp(float t00, float t01, float t10,
                                        float t11) const {
    const float top = t00 * (1.0f - fx) + t01 * fx;
    const float bot = t10 * (1.0f - fx) + t11 * fx;
    return top * (1.0f - fy) + bot * fy;
  }

  __device__ __forceinline__ float sample(const float* s) const {
    const float t00 = v00 ? s[r0 + x0] : 0.0f;
    const float t01 = v01 ? s[r0 + x0 + 1] : 0.0f;
    const float t10 = v10 ? s[r1 + x0] : 0.0f;
    const float t11 = v11 ? s[r1 + x0 + 1] : 0.0f;
    const float top = t00 * (1.0f - fx) + t01 * fx;
    const float bot = t10 * (1.0f - fx) + t11 * fx;
    return top * (1.0f - fy) + bot * fy;
  }
};

// One halving step of a warp's reduce-scatter: lanes with bit OFF set
// keep the upper half of the N values and send the lower half to their
// partner, which keeps the lower half.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (OFF > 0) {
    constexpr int H = N / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_scatter<H, OFF / 2>(v, lane);
  }
}

// Block reduction of every thread's NOUT sums into one column of
// per-block partials.  Padded to R * 32 values, a warp's reduce-scatter
// (5 halving steps, R * 31 shuffles a lane where a shuffle tree per sum
// takes 5 * NOUT) leaves lane L the warp's sums of entries L*R .. L*R+R-1;
// the 4 warps' sums then add in a fixed order.
template <int NOUT>
__device__ __forceinline__ void block_reduce_scatter_store(const float* acc,
                                                           float* part,
                                                           int nblk) {
  constexpr int R = (NOUT + 31) / 32;
  __shared__ float red[THREADS / 32][R * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[R * 32];
#pragma unroll
  for (int k = 0; k < R * 32; ++k) v[k] = k < NOUT ? acc[k] : 0.0f;
  reduce_scatter<R * 32, 16>(v, lane);
#pragma unroll
  for (int j = 0; j < R; ++j) red[warp][lane * R + j] = v[j];
  __syncthreads();
  for (int k = threadIdx.x; k < NOUT; k += THREADS) {
    float s = red[0][k];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) s += red[w][k];
    part[(size_t)k * nblk] = s;
  }
}

// An inactive lane's block writes zero partials.
template <int NOUT>
__device__ __forceinline__ void zero_partials(float* part, int nblk) {
  for (int k = threadIdx.x; k < NOUT; k += THREADS) part[(size_t)k * nblk] = 0.0f;
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

// Calls f(std::integral_constant<int, P>, std::bool_constant<HESS>) for
// the motion model's parameter count and the Gram flag.
template <typename F>
cudaError_t dispatch(int n_params, int with_hessian, F&& f) {
  using std::integral_constant;
  using std::false_type;
  using std::true_type;
  switch (n_params * 2 + (with_hessian ? 1 : 0)) {
    case 2 * 2 + 0: return f(integral_constant<int, 2>{}, false_type{});
    case 2 * 2 + 1: return f(integral_constant<int, 2>{}, true_type{});
    case 3 * 2 + 0: return f(integral_constant<int, 3>{}, false_type{});
    case 3 * 2 + 1: return f(integral_constant<int, 3>{}, true_type{});
    case 6 * 2 + 0: return f(integral_constant<int, 6>{}, false_type{});
    case 6 * 2 + 1: return f(integral_constant<int, 6>{}, true_type{});
    case 8 * 2 + 0: return f(integral_constant<int, 8>{}, false_type{});
    case 8 * 2 + 1: return f(integral_constant<int, 8>{}, true_type{});
    default: return cudaErrorInvalidValue;
  }
}

// Called right after a sweep's launch: its launch error, or else the
// double-precision reduction of its partials into out [B, NOUT].
template <int NOUT>
cudaError_t reduce_partials(const float* partials, float* out, int B,
                            int nblk, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_kernel<<<dim3(NOUT, B), RED_THREADS, 0, st>>>(partials, out, nblk,
                                                      NOUT);
  return cudaGetLastError();
}

}  // namespace
