// Batched single-plane bilinear warp (B5), its forms on interleaved
// frames, and the three-plane shared-coordinate warp (B9).
//
// Replaces the Pallas TPU kernels libstacker_tpu/ops/warp_pallas.py
// _warp_kernel (:217, entry warp_bilinear_pallas :370) and _warp3_kernel
// (:475, entry warp3_bilinear_pallas :594).  Per output slot g and pixel
// (x, y) of an OH x OW grid:
//
//   (sx, sy) = M_g (x, y, 1)           (inverse map, float32)
//   1/32-px quantised bilinear taps of src[src_index[g]] (H x W)
//
// B5 applies the border mode in the kernel: BORDER_CONSTANT with a value
// per slot (BORDER_TRANSPARENT over a zero base is the same taps with the
// value 0, set by the wrapper), or one of the index-mapping modes
// REPLICATE / REFLECT / WRAP / REFLECT_101, which map each tap's row and
// column index by OpenCV's borderInterpolate.  The TPU kernel ran those
// modes as BORDER_CONSTANT over a source pre-extended by an apron
// (libstacker_tpu/ops/warp_batch.py:270-281), sized on the host from the
// matrices (pallas_required_apron :170-228): the apron, its pad pass and
// its host sync have no counterpart here, and no matrix falls back to
// another path.  B9 warps three shared planes (ECC's image, gx, gy) with
// one coordinate and weight set per pixel, BORDER_CONSTANT 0.
//
// What bounds them on the H100.  Each output value is written once (4 B)
// and each source pixel is read about once from DRAM (the 4 taps of
// neighbouring threads share cache lines): 2 x 33 MB per 4K plane, ~20 us
// at 3.35 TB/s.  Against that, ~45 separately rounded float operations
// and 4 gathers per output value; for 60 planes of 4K ~2.2e10
// operations, ~0.34 ms at 67 T/s, so operations bind.  The residual band,
// (8,128)-aligned window DMAs and dynamic rolls of the TPU kernels exist
// only for VMEM windows; a thread here reads any source pixel.
//
// Design: one thread per output pixel and slot (B5) or per four output
// pixels of a row and one lane covering the three planes (B9);
// coordinates exactly as warp_accum.cu and ops/warp.py evaluate them.
//
// Row origins (oy0, sy0; 0 and 0 on every whole-frame path).  A row band
// of a larger frame (parallel/mesh.py: warp_rows_sharded and
// ecc_stack_step_spatial) warps from its strip of source rows: output row
// y is global row y + oy0, and global source row r is row r - sy0 of the
// strip.  The coordinates are evaluated at the GLOBAL row, as the whole
// frame's warp evaluates them, and the integer origin is subtracted from
// the tap row after the 1/32 binning, so a band equals the rows of the
// whole frame's warp bitwise wherever its taps stay in the strip (the JAX
// package folds the origins into shifted float32 maps instead, which
// moves 1/32 bins at large row offsets).
//
// B9's bound is its bytes: the three planes read once (3 x 33 MB at 4K)
// and B x 3 planes written once (1.59 GB at 16 lanes, ~0.5 ms at 3.35
// TB/s), against ~65 operations a pixel-lane (~0.13 ms).  The first
// design ran the pixels fastest in its grid, so each lane swept the
// whole image before the next began and the 100 MB of planes, twice the
// 50 MB L2, came from DRAM once per lane (~1.6 GB more reads at 16
// lanes).  Its grid now runs the lanes fastest (block = tile * B +
// lane): the B lanes of one tile run side by side, and the planes come
// from DRAM about once (B1 on texels does the same, ecc_moments.cu).
// The output is written once and never read here, so its four pixels
// per plane leave as one 16-byte streaming store (__stcs, evict-first)
// that does not push the planes out of L2.  Build with --fmad=false
// (utils/cuda_build.py): the float expressions follow the plain PyTorch
// versions (ops/warp_cuda.py, built on ops/warp.py) term for term, so
// both land in the same 1/32-px bin and equal each other bitwise.
//
// B5 on interleaved frames (frames_kernel, accum_kernel; entry
// warp_frames).  The stacking stage of the keypoint path with an
// index-mapping border used to widen the burst to float32, copy it to
// planes and give B5 one slot per plane, so every pixel's homography
// division, 1/32 binning and border map ran once per channel, and a
// [N,H,W,3] float32 intermediate was written and summed back by PyTorch.
// The TPU kernel's plane-and-apron layout exists for its VMEM windows; a
// CUDA thread reads any texel.  Here one thread per output pixel (and
// frame) computes the coordinates and the four mapped tap offsets once,
// reads the taps of all C <= 4 channels of the [N,H,W,C] frame in its
// own type (u8 / u16 / f32) and widens each tap as warp_accum.cu does,
// (float)v * float32(1/255) (or 1/65535): bitwise what feeding
// ops/color.py's to_unit_f32(frames) gives.  Two outputs:
//   frames:     out[n, y, x, c] = warp(frames[n], minv[n])[y, x, c]
//   accumulate: out[y, x, c] = sum_n valid[n] * warp(...)[y, x, c],
//               frame by frame in frame order in one launch, the sums
//               in registers (B2's loop); a frame with valid[n] == 0 is
//               skipped whole, its map never read.
// What bounds them: the accumulate form reads the burst in its own type
// once and writes one [H,W,C] f32 image (0.47 GB + 0.1 GB for 19 u8
// frames of 4K, ~0.17 ms at 3.35 TB/s) against ~35 float operations a
// pixel-frame for the coordinates and ~16 a channel (~1.2e10 for the
// same burst, ~0.19 ms at 67 T/s): the two bounds are close, and B2's
// identical loop measures issue-bound (warp_accum.cu).  The index maps
// are applied only to taps outside the frame; inside, every mode is the
// identity.  The border values travel by value in the launch, so a
// call copies nothing to the device and never waits on it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// OpenCV's border-mode integers
constexpr int CONSTANT = 0, REPLICATE = 1, REFLECT = 2, WRAP = 3,
              REFLECT101 = 4;
// tap origins of the index-mapping modes are clamped to +-2^30 before
// the integer cast, as ops/warp.py does
constexpr float INDEX_LIMIT = 1073741824.0f;

template <int MODE>
__device__ __forceinline__ int map_index(int i, int n) {
  if constexpr (MODE == REPLICATE) {
    return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  } else if constexpr (MODE == WRAP) {
    const int m = i % n;
    return m < 0 ? m + n : m;
  } else if constexpr (MODE == REFLECT101) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    int m = i % period;
    if (m < 0) m += period;
    return m < period - m ? m : period - m;
  } else {  // REFLECT
    const int period = 2 * n;
    int m = i % period;
    if (m < 0) m += period;
    return m >= n ? period - 1 - m : m;
  }
}

// Source coordinates of output pixel (x, y) under inverse map m, then
// the 1/32-px quantisation: tap origin (x0f, y0f) and weights (fx, fy).
__device__ __forceinline__ void coords(const float* m, float xs, float ys,
                                       int perspective, float& x0f,
                                       float& y0f, float& fx, float& fy) {
  float sx = m[0] * xs + m[1] * ys + m[2];
  float sy = m[3] * xs + m[4] * ys + m[5];
  float xq, yq;
  if (perspective) {
    const float sw = m[6] * xs + m[7] * ys + m[8];
    const float inv = sw != 0.0f ? 1.0f / sw : 0.0f;
    sx = sx * inv;
    sy = sy * inv;
    xq = rintf(sx * 32.0f);
    yq = rintf(sy * 32.0f);
  } else {
    xq = floorf((rintf(sx * 1024.0f) + 16.0f) / 32.0f);
    yq = floorf((rintf(sy * 1024.0f) + 16.0f) / 32.0f);
  }
  x0f = floorf(xq * (1.0f / 32.0f));
  y0f = floorf(yq * (1.0f / 32.0f));
  fx = (xq - x0f * 32.0f) * (1.0f / 32.0f);
  fy = (yq - y0f * 32.0f) * (1.0f / 32.0f);
}

__device__ __forceinline__ float lerp2(float t00, float t01, float t10,
                                       float t11, float fx, float fy) {
  const float top = t00 * (1.0f - fx) + t01 * fx;
  const float bot = t10 * (1.0f - fx) + t11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

template <typename T>
__device__ __forceinline__ float widen(T v, float scale) {
  return (float)v * scale;
}
template <>
__device__ __forceinline__ float widen<float>(float v, float) {
  return v;
}

// map_index for a tap that may lie inside the frame, where every mode is
// the identity
template <int MODE>
__device__ __forceinline__ int map_tap(int i, int n) {
  return (unsigned)i < (unsigned)n ? i : map_index<MODE>(i, n);
}

// BORDER_CONSTANT's value per channel, passed by value
struct Border4 {
  float v[4];
};

// The four taps of one output pixel under one inverse map: pixel offsets
// into the frame (row * W + column), whether each reads the frame
// (BORDER_CONSTANT reads the border value where not), and the weights.
struct Taps {
  size_t i00, i01, i10, i11;
  bool v00, v01, v10, v11;
  float fx, fy;
};

template <int MODE>
__device__ __forceinline__ Taps frame_taps(const float* m, float xs, float ys,
                                           int H, int W, int perspective,
                                           float sy0) {
  Taps t;
  float x0f, y0f;
  coords(m, xs, ys, perspective, x0f, y0f, t.fx, t.fy);
  y0f -= sy0;
  if constexpr (MODE == CONSTANT) {
    const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
    const bool vx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
    const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
    const bool vy1 = y0f >= -1.0f && y0f <= (float)(H - 2);
    const int x0 = (vx0 || vx1) ? (int)x0f : 0;
    const int y0 = (vy0 || vy1) ? (int)y0f : 0;
    t.i00 = (size_t)((long long)y0 * W + x0);
    t.i01 = t.i00 + 1;
    t.i10 = t.i00 + W;
    t.i11 = t.i10 + 1;
    t.v00 = vy0 && vx0;
    t.v01 = vy0 && vx1;
    t.v10 = vy1 && vx0;
    t.v11 = vy1 && vx1;
  } else {
    const int x0 = (int)fminf(fmaxf(x0f, -INDEX_LIMIT), INDEX_LIMIT);
    const int y0 = (int)fminf(fmaxf(y0f, -INDEX_LIMIT), INDEX_LIMIT);
    const int mx0 = map_tap<MODE>(x0, W), mx1 = map_tap<MODE>(x0 + 1, W);
    const size_t r0 = (size_t)map_tap<MODE>(y0, H) * W;
    const size_t r1 = (size_t)map_tap<MODE>(y0 + 1, H) * W;
    t.i00 = r0 + mx0;
    t.i01 = r0 + mx1;
    t.i10 = r1 + mx0;
    t.i11 = r1 + mx1;
    t.v00 = t.v01 = t.v10 = t.v11 = true;
  }
  return t;
}

// channel c of frame f ([H,W,C] in its own type) at taps t
template <int MODE, typename T>
__device__ __forceinline__ float sample(const T* __restrict__ f,
                                        const Taps& t, int c, int C,
                                        float bv, float scale) {
  float t00, t01, t10, t11;
  if constexpr (MODE == CONSTANT) {
    t00 = t.v00 ? widen<T>(f[t.i00 * C + c], scale) : bv;
    t01 = t.v01 ? widen<T>(f[t.i01 * C + c], scale) : bv;
    t10 = t.v10 ? widen<T>(f[t.i10 * C + c], scale) : bv;
    t11 = t.v11 ? widen<T>(f[t.i11 * C + c], scale) : bv;
  } else {
    t00 = widen<T>(f[t.i00 * C + c], scale);
    t01 = widen<T>(f[t.i01 * C + c], scale);
    t10 = widen<T>(f[t.i10 * C + c], scale);
    t11 = widen<T>(f[t.i11 * C + c], scale);
  }
  return lerp2(t00, t01, t10, t11, t.fx, t.fy);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const float* __restrict__ src, const float* __restrict__ minv,
            const float* __restrict__ border,
            const int32_t* __restrict__ src_index, float* __restrict__ out,
            int H, int W, int OH, int OW, int perspective, int oy0, int sy0) {
  const size_t ohw = (size_t)OH * OW;
  const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= ohw) return;
  const int g = blockIdx.y;
  const int y = (int)(p / OW);
  const int x = (int)(p - (size_t)y * OW);
  const float* m = minv + 9 * g;
  const float* s = src + (size_t)src_index[g] * H * W;
  float x0f, y0f, fx, fy;
  coords(m, (float)x, (float)(y + oy0), perspective, x0f, y0f, fx, fy);
  y0f -= (float)sy0;
  float t00, t01, t10, t11;
  if constexpr (MODE == CONSTANT) {
    const float bv = border[g];
    const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
    const bool vx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
    const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
    const bool vy1 = y0f >= -1.0f && y0f <= (float)(H - 2);
    const int x0 = (vx0 || vx1) ? (int)x0f : 0;
    const int y0 = (vy0 || vy1) ? (int)y0f : 0;
    const size_t i00 = (size_t)y0 * W + x0;
    t00 = (vy0 && vx0) ? s[i00] : bv;
    t01 = (vy0 && vx1) ? s[i00 + 1] : bv;
    t10 = (vy1 && vx0) ? s[i00 + W] : bv;
    t11 = (vy1 && vx1) ? s[i00 + W + 1] : bv;
  } else {
    const int x0 = (int)fminf(fmaxf(x0f, -INDEX_LIMIT), INDEX_LIMIT);
    const int y0 = (int)fminf(fmaxf(y0f, -INDEX_LIMIT), INDEX_LIMIT);
    const int mx0 = map_index<MODE>(x0, W), mx1 = map_index<MODE>(x0 + 1, W);
    const size_t r0 = (size_t)map_index<MODE>(y0, H) * W;
    const size_t r1 = (size_t)map_index<MODE>(y0 + 1, H) * W;
    t00 = s[r0 + mx0];
    t01 = s[r0 + mx1];
    t10 = s[r1 + mx0];
    t11 = s[r1 + mx1];
  }
  out[(size_t)g * ohw + p] = lerp2(t00, t01, t10, t11, fx, fy);
}

// B9: one thread per W3PX consecutive pixels of a row and one lane, the
// lane fastest in the grid (block = tile * B + lane), so the B lanes of a
// tile run side by side and read the shared planes from L2; each output
// plane's W3PX values leave as one 16-byte streaming store where vector
// (W % 4 == 0), as scalar streaming stores elsewhere.
constexpr int W3PX = 4;

__global__ void __launch_bounds__(THREADS)
warp3_kernel(const float* __restrict__ srcs, const float* __restrict__ minv,
             float* __restrict__ out, int B, int H, int W, int perspective,
             int vector) {
  const int lane = (int)(blockIdx.x % (unsigned)B);
  const size_t tile = blockIdx.x / (unsigned)B;
  const int qpr = (W + W3PX - 1) / W3PX;  // quads per row
  const size_t q = tile * THREADS + threadIdx.x;
  if (q >= (size_t)H * qpr) return;
  const int y = (int)(q / qpr);
  const int x0 = (int)(q - (size_t)y * qpr) * W3PX;
  const int npx = min(W3PX, W - x0);
  const size_t hw = (size_t)H * W;
  const float* m = minv + 9 * lane;
  float o[3][W3PX];
#pragma unroll
  for (int j = 0; j < W3PX; ++j) {
    if (j >= npx) break;
    float x0f, y0f, fx, fy;
    coords(m, (float)(x0 + j), (float)y, perspective, x0f, y0f, fx, fy);
    const bool vx0 = x0f >= 0.0f && x0f <= (float)(W - 1);
    const bool vx1 = x0f >= -1.0f && x0f <= (float)(W - 2);
    const bool vy0 = y0f >= 0.0f && y0f <= (float)(H - 1);
    const bool vy1 = y0f >= -1.0f && y0f <= (float)(H - 2);
    const int tx = (vx0 || vx1) ? (int)x0f : 0;
    const int ty = (vy0 || vy1) ? (int)y0f : 0;
    const size_t i00 = (size_t)ty * W + tx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* s = srcs + (size_t)c * hw;
      const float t00 = (vy0 && vx0) ? s[i00] : 0.0f;
      const float t01 = (vy0 && vx1) ? s[i00 + 1] : 0.0f;
      const float t10 = (vy1 && vx0) ? s[i00 + W] : 0.0f;
      const float t11 = (vy1 && vx1) ? s[i00 + W + 1] : 0.0f;
      o[c][j] = lerp2(t00, t01, t10, t11, fx, fy);
    }
  }
  const size_t p = (size_t)y * W + x0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float* dst = out + ((size_t)lane * 3 + c) * hw + p;
    if (vector) {
#pragma unroll
      for (int k = 0; k < W3PX; k += 4)
        __stcs(reinterpret_cast<float4*>(dst + k),
               make_float4(o[c][k], o[c][k + 1], o[c][k + 2], o[c][k + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < W3PX; ++j)
        if (j < npx) __stcs(dst + j, o[c][j]);
    }
  }
}

// B5, frames form: one thread per output pixel of frame blockIdx.y
template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS)
frames_kernel(const T* __restrict__ frames, const float* __restrict__ minv,
              Border4 border, float* __restrict__ out, int H, int W, int C,
              int perspective, float scale, int oy0, int sy0) {
  const size_t hw = (size_t)H * W;
  const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.y;
  const int y = (int)(p / W);
  const int x = (int)(p - (size_t)y * W);
  const Taps t = frame_taps<MODE>(minv + 9 * n, (float)x, (float)(y + oy0),
                                  H, W, perspective, (float)sy0);
  const T* f = frames + (size_t)n * hw * C;
  float* o = out + ((size_t)n * hw + p) * C;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < C) o[c] = sample<MODE, T>(f, t, c, C, border.v[c], scale);
}

// B5, accumulate form: one thread per output pixel walks the frames in
// order; a dropped frame (valid[n] == 0) is skipped whole
template <int MODE, typename T>
__global__ void __launch_bounds__(THREADS)
accum_kernel(const T* __restrict__ frames, const float* __restrict__ minv,
             const float* __restrict__ valid, Border4 border,
             float* __restrict__ out, int N, int H, int W, int C,
             int perspective, float scale, int oy0, int sy0) {
  const size_t hw = (size_t)H * W;
  const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int y = (int)(p / W);
  const int x = (int)(p - (size_t)y * W);
  const float xs = (float)x, ys = (float)(y + oy0), sy0f = (float)sy0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = 0; n < N; ++n) {
    const float vn = valid[n];
    if (vn == 0.0f) continue;
    const Taps t =
        frame_taps<MODE>(minv + 9 * n, xs, ys, H, W, perspective, sy0f);
    const T* f = frames + (size_t)n * hw * C;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < C)
        acc[c] = acc[c] + sample<MODE, T>(f, t, c, C, border.v[c], scale) * vn;
  }
  float* o = out + p * C;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < C) o[c] = acc[c];
}

template <int MODE, typename T>
cudaError_t launch_frames(const void* frames, const float* minv,
                          const Border4& border, const float* valid,
                          float* out, int N, int H, int W, int C,
                          int perspective, float scale, int oy0, int sy0,
                          cudaStream_t st) {
  const size_t hw = (size_t)H * W;
  const unsigned blocks = (unsigned)((hw + THREADS - 1) / THREADS);
  const T* f = static_cast<const T*>(frames);
  if (valid) {
    accum_kernel<MODE, T><<<blocks, THREADS, 0, st>>>(
        f, minv, valid, border, out, N, H, W, C, perspective, scale, oy0,
        sy0);
  } else {
    frames_kernel<MODE, T><<<dim3(blocks, (unsigned)N), THREADS, 0, st>>>(
        f, minv, border, out, H, W, C, perspective, scale, oy0, sy0);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t frames_by_mode(int mode, const void* frames, const float* minv,
                           const Border4& border, const float* valid,
                           float* out, int N, int H, int W, int C,
                           int perspective, float scale, int oy0, int sy0,
                           cudaStream_t st) {
  switch (mode) {
    case CONSTANT: return launch_frames<CONSTANT, T>(frames, minv, border, valid, out, N, H, W, C, perspective, scale, oy0, sy0, st);
    case REPLICATE: return launch_frames<REPLICATE, T>(frames, minv, border, valid, out, N, H, W, C, perspective, scale, oy0, sy0, st);
    case REFLECT: return launch_frames<REFLECT, T>(frames, minv, border, valid, out, N, H, W, C, perspective, scale, oy0, sy0, st);
    case WRAP: return launch_frames<WRAP, T>(frames, minv, border, valid, out, N, H, W, C, perspective, scale, oy0, sy0, st);
    case REFLECT101: return launch_frames<REFLECT101, T>(frames, minv, border, valid, out, N, H, W, C, perspective, scale, oy0, sy0, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t launch(const float* src, const float* minv, const float* border,
                   const int32_t* sidx, float* out, int G, int H, int W,
                   int OH, int OW, int perspective, int oy0, int sy0,
                   cudaStream_t st) {
  const size_t ohw = (size_t)OH * OW;
  const dim3 grid((unsigned)((ohw + THREADS - 1) / THREADS), (unsigned)G);
  warp_kernel<MODE><<<grid, THREADS, 0, st>>>(src, minv, border, sidx, out,
                                              H, W, OH, OW, perspective, oy0,
                                              sy0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src [S,H,W] f32, minv [G,3,3] f32 inverse maps, border [G] f32 (read in
// BORDER_CONSTANT only), src_index [G] i32 (each in 0..S-1, checked by
// the wrapper), out [G,OH,OW] f32.  border_mode is OpenCV's integer
// (0 constant, 1 replicate, 2 reflect, 3 wrap, 4 reflect101); oy0 / sy0
// the row origins (header).
int warp_bilinear(const void* src, const void* minv, const void* border,
                  const void* src_index, void* out, int G, int H, int W,
                  int OH, int OW, int border_mode, int perspective, int oy0,
                  int sy0, void* stream) {
  if (G <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto m = static_cast<const float*>(minv);
  auto b = static_cast<const float*>(border);
  auto i = static_cast<const int32_t*>(src_index);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (border_mode) {
    case CONSTANT: return (int)launch<CONSTANT>(s, m, b, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case REPLICATE: return (int)launch<REPLICATE>(s, m, b, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case REFLECT: return (int)launch<REFLECT>(s, m, b, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case WRAP: return (int)launch<WRAP>(s, m, b, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case REFLECT101: return (int)launch<REFLECT101>(s, m, b, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// srcs [3,H,W] f32, minv [B,3,3] f32 inverse maps, out [B,3,H,W] f32.
// tiles and vector are ops/warp_cuda.warp3_plan's: tiles of THREADS
// threads of W3PX pixels cover the image, vector only where W % 4 == 0;
// a plan that does not fit the shapes is refused.
int warp3_bilinear(const void* srcs, const void* minv, void* out, int B,
                   int H, int W, int perspective, unsigned tiles, int vector,
                   void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long quads = (long long)H * ((W + W3PX - 1) / W3PX);
  if ((long long)tiles != (quads + THREADS - 1) / THREADS ||
      (vector && W % W3PX != 0) ||
      (unsigned long long)tiles * B > 0x7fffffffULL)
    return (int)cudaErrorInvalidValue;
  warp3_kernel<<<tiles * (unsigned)B, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(srcs), static_cast<const float*>(minv),
      static_cast<float*>(out), B, H, W, perspective, vector);
  return (int)cudaGetLastError();
}

// frames [N,H,W,C] (dtype_code 0 = u8, 1 = u16, 2 = f32; C in 1..4),
// minv [N,3,3] f32 inverse maps, border [C] f32 in HOST memory (read in
// BORDER_CONSTANT only), scale the widening factor of integer taps.  valid == NULL: the
// frames form, out [N,H,W,C] f32.  valid [N] f32: the accumulate form,
// out [H,W,C] f32 (N may be 0: zeros); oy0 / sy0 the row origins
// (header).
int warp_frames(const void* frames, const void* minv, const float* border,
                const void* valid, void* out, int N, int H, int W, int C,
                int dtype_code, int border_mode, int perspective,
                float scale, int oy0, int sy0, void* stream) {
  if (N < 0 || (N == 0 && !valid) || N > 65535 || H <= 0 || W <= 0 ||
      C < 1 || C > 4)
    return (int)cudaErrorInvalidValue;
  auto m = static_cast<const float*>(minv);
  Border4 b;
  for (int c = 0; c < 4; ++c) b.v[c] = c < C ? border[c] : 0.0f;
  auto v = static_cast<const float*>(valid);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return (int)frames_by_mode<uint8_t>(border_mode, frames, m, b, v, o, N, H, W, C, perspective, scale, oy0, sy0, st);
    case 1: return (int)frames_by_mode<uint16_t>(border_mode, frames, m, b, v, o, N, H, W, C, perspective, scale, oy0, sy0, st);
    case 2: return (int)frames_by_mode<float>(border_mode, frames, m, b, v, o, N, H, W, C, perspective, scale, oy0, sy0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
