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
// What bounds B5's planar form on the H100.  Each output value is
// written once (4 B) and each source pixel is read about once from DRAM
// (the four taps of neighbouring pixels share cache lines): for 60
// slots of 4K, 2.0 GB out and 2.0 GB in, 1.19 ms at 3.35 TB/s.  The
// first design (one thread an output value) spent 168-223 instructions
// an output value (utils/sass.py) and ran at a third of that bound on an
// H100: a 64-bit division to split its index, the compiler's IEEE
// 1.0f / sw, the bins on the conversion pipe (rint, floor, the
// float-to-int casts: 16 a clock per SM against FP32's 128), an integer
// modulo per tap in the wrapping and reflecting modes even inside the
// frame, the map and the border value read from global memory by every
// thread, and plain stores that kept the output in L2 over the sources.
//
// Design (warp_kernel).  A block is four warps on four output rows; a
// lane takes B5_PIXELS pixels of its row strided by 32 (each tap load of
// a warp covers 32 neighbouring pixels) and loops over up to B5_SLOTS
// slots, whose maps, border values and source planes the block stages
// in shared memory once.  The grid is 1-D, the slots slowest.  Per
// pixel and map, with 32-bit indexing and the row products m1*y, m4*y,
// m7*y formed once: the coordinates as ops/warp.py:56-62 writes them,
// the correctly rounded reciprocal and the bins off the conversion pipe
// (csrc/warp_bins.cuh), the tap offset and the two weights.  A slot whose
// map is bitwise the previous slot's (the channel planes of a frame)
// reuses all of that and pays only its four loads and the lerp.  When
// every reciprocal took the fast path and every tap of the thread's
// pixels lies inside the strip, the taps are read with no border select
// or index map (one branch a thread and map); otherwise each pixel takes
// the plain expressions, where the index-mapping modes map only the
// taps off the frame.  The output leaves by scalar streaming stores
// (__stcs, evict-first), 128 contiguous bytes a warp.  Measured on an
// H100 for 60 4K slots, three planes a map, where bytes bind (a device
// copy of the same bytes takes about 0.8 of its time): four
// consecutive pixels a lane with one 16-byte store ran 1-2 % slower
// (its tap loads span four times the sectors), 12 slots a block 1-3 %
// slower than 3 (more planes streaming at once), 6 as fast, and the
// same kernel without the map reuse 6 % slower.
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
// CUDA thread reads any texel.  Both forms compute a pixel's coordinates
// and taps once for all C <= 4 channels of the [N,H,W,C] frame, read
// the taps in the frame's own type (u8 / u16 / f32) and widen each as
// warp_accum.cu does, (float)v * float32(1/255) (or 1/65535): bitwise
// what feeding ops/color.py's to_unit_f32(frames) gives.  Two outputs:
//   frames:     out[n, y, x, c] = warp(frames[n], minv[n])[y, x, c]
//   accumulate: out[y, x, c] = sum_n valid[n] * warp(...)[y, x, c],
//               frame by frame in frame order in one launch, the sums
//               in registers; a frame with valid[n] == 0 is skipped
//               whole, its map never read.
//
// What bounds them.  The accumulate form reads the burst in its own type
// once and writes one [H,W,C] f32 image (0.47 GB + 0.1 GB for 18 kept u8
// frames of 4K, ~0.17 ms at 3.35 TB/s) against ~35 float operations a
// pixel-frame for the coordinates and ~16 a channel (~1.2e10, ~0.19 ms
// at 67 T/s); B2's identical loop measures issue-bound (warp_accum.cu).
// The frames form writes every frame's f32 warp: for 19 u8 RGB frames
// of 4K 1.89 GB out against 0.47 GB in, 0.71 ms at 3.35 TB/s, so its
// stores weigh as much as its taps.
//
// Design (frame_pixels, the body of accum_kernel and frames_kernel), B2's
// and the planar form's: a block is four warps on four output rows, a
// lane B5A_PIXELS (B5F_PIXELS) pixels of its row strided by 32 (each tap
// load of a warp covers 32 neighbouring pixels), and the block stages
// the maps in shared memory once: the accumulate form each chunk of B5A_CHUNK
// frames' maps and weights (a dropped frame is skipped by the whole
// block), the frames form its one frame's map (the frame on the grid's
// y axis).  Per thread-frame: the row products m1*y, m4*y, m7*y once,
// then per pixel the coordinates as ops/warp.py:56-62 writes them, the
// correctly rounded reciprocal and the bins off the conversion pipe
// (csrc/warp_bins.cuh), a 32-bit tap offset (frames of fewer than 2^31
// values) and the two weights.  Inside the strip every border mode is
// the identity: when every reciprocal took the fast path and every tap
// of the thread's pixels lies in the strip (the row test taken on the
// strip row, as the planar form's, so a strip above the frame stays
// exact), the taps are read with no index map and no border select, one
// branch a thread-frame; otherwise each pixel takes the plain expressions
// (frame_taps / sample).  The C channels are a template constant for RGB
// (a C read at run time measured 15-29 % slower on the accumulate form
// and 11-19 % on the frames form, H100).  The accumulate form's sums
// leave by streaming stores (__stcs).  The frames form's values leave as
// each warp's 32 x C contiguous floats of a k: the lanes put their
// pixels' C values in a shared buffer of the warp, and lane l streams
// float4 l of the span where rows are a multiple of 16 bytes (W % 4 ==
// 0), else elements l, l + 32, ... (coalesced __stcs, never C scalar
// stores at a stride of 4 * C bytes).  On an H100 for 19 u8 RGB 4K frames
// (chip_smoke.py phase 11) the float4 stores measured 2-3 % faster than
// the scalar ones.  The border values travel by value in the launch, so a
// call copies nothing to the device and never waits on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_bins.cuh"  // rcp_fast, quant, frac32

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

// B5, planar form: see the header.  A block's four warps take four
// output rows, a lane B5_PIXELS pixels of its row (x = x0 + lane + 32k),
// and each thread loops over the block's slots.
constexpr int B5_ROWS = 4;
constexpr int B5_THREADS = 32 * B5_ROWS;
constexpr int B5_PIXELS = 4;
constexpr int B5_TILE = 32 * B5_PIXELS;  // output columns a block
constexpr int B5_SLOTS = 3;              // slots a block

// One slot as a block stages it: its inverse map, border value and
// source plane; `same` where the map is bitwise the previous slot's
struct Slot {
  float m[9];
  float border;
  int same;
  const float* plane;
};

// The plain expressions for output pixel (xs, ys) of slot sl, as the
// first design and ops/warp.py evaluate them; the index-mapping
// modes map only the taps off the strip.
template <int MODE, bool PERSP>
__device__ __forceinline__ float plain_value(const Slot& sl,
                                             const float* __restrict__ s,
                                             float xs, float ys, int H, int W,
                                             float sy0f) {
  float x0f, y0f, fx, fy;
  coords(sl.m, xs, ys, PERSP, x0f, y0f, fx, fy);
  y0f -= sy0f;
  float t00, t01, t10, t11;
  if constexpr (MODE == CONSTANT) {
    const float bv = sl.border;
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
    const int mx0 = map_tap<MODE>(x0, W), mx1 = map_tap<MODE>(x0 + 1, W);
    const size_t r0 = (size_t)map_tap<MODE>(y0, H) * W;
    const size_t r1 = (size_t)map_tap<MODE>(y0 + 1, H) * W;
    t00 = s[r0 + mx0];
    t01 = s[r0 + mx1];
    t10 = s[r1 + mx0];
    t11 = s[r1 + mx1];
  }
  return lerp2(t00, t01, t10, t11, fx, fy);
}

// fast_w, fast_y0, fast_h: a tap origin (tx, ty) with tx < fast_w and
// fast_y0 <= ty < fast_y0 + fast_h has its four taps in the strip and
// exact integer bins (launch_planar)
template <int MODE, bool PERSP>
__global__ void __launch_bounds__(B5_THREADS)
warp_kernel(const float* __restrict__ src, const float* __restrict__ minv,
            const float* __restrict__ border, float border_value,
            const int32_t* __restrict__ src_index, float* __restrict__ out,
            int G, int H, int W, int OH, int OW, int tiles_x, int bands,
            int oy0, int sy0, unsigned fast_w, int fast_y0,
            unsigned fast_h) {
  constexpr int P = B5_PIXELS;
  __shared__ Slot slots[B5_SLOTS];
  const unsigned tile = blockIdx.x % (unsigned)tiles_x;
  const unsigned rest = blockIdx.x / (unsigned)tiles_x;
  const int band = (int)(rest % (unsigned)bands);
  const int g0 = (int)(rest / (unsigned)bands) * B5_SLOTS;
  const int count = min(B5_SLOTS, G - g0);
  if ((int)threadIdx.x < count) {
    const int j = (int)threadIdx.x, g = g0 + j;
    const float* m = minv + 9 * (size_t)g;
    bool same = j > 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      slots[j].m[i] = m[i];
      if (j > 0) same &= __float_as_uint(m[i]) == __float_as_uint(m[i - 9]);
    }
    slots[j].same = same;
    slots[j].border = border ? border[g] : border_value;
    slots[j].plane = src + (size_t)(src_index ? src_index[g] : g) * H * W;
  }
  __syncthreads();
  const int y = band * B5_ROWS + (int)(threadIdx.x >> 5);
  if (y >= OH) return;
  const int x0 = (int)tile * B5_TILE + (int)(threadIdx.x & 31);
  float xs[P];
#pragma unroll
  for (int k = 0; k < P; ++k) xs[k] = (float)min(x0 + 32 * k, OW - 1);
  const float ys = (float)(y + oy0), sy0f = (float)sy0;
  const size_t ohw = (size_t)OH * OW;
  float* orow = out + (size_t)g0 * ohw + (size_t)y * OW + x0;
  // the last map's tap offsets, weights and whether it took the fast path
  bool fast = false;
  unsigned off[P];
  float fx[P], fy[P], gx[P], gy[P];
#pragma unroll 1
  for (int j = 0; j < count; ++j, orow += ohw) {
    const Slot& sl = slots[j];
    if (!sl.same) {
      const float r1 = sl.m[1] * ys, r4 = sl.m[4] * ys, r7 = sl.m[7] * ys;
      fast = true;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        float sx = (sl.m[0] * xs[k] + r1) + sl.m[2];
        float sy = (sl.m[3] * xs[k] + r4) + sl.m[5];
        if (PERSP) {
          const float sw = (sl.m[6] * xs[k] + r7) + sl.m[8];
          bool ok;
          const float inv = rcp_fast(sw, ok);
          fast &= ok;
          sx = sx * inv;
          sy = sy * inv;
        }
        const int qx = quant<PERSP>(sx), qy = quant<PERSP>(sy);
        const int tx = qx >> 5, ty = (qy >> 5) - sy0;
        fast &= (unsigned)tx < fast_w && (unsigned)(ty - fast_y0) < fast_h;
        off[k] = (unsigned)ty * (unsigned)W + (unsigned)tx;
        fx[k] = frac32(qx);
        fy[k] = frac32(qy);
        gx[k] = 1.0f - fx[k];
        gy[k] = 1.0f - fy[k];
      }
    }
    const float* plane = sl.plane;
    float v[P];
    if (fast) {
      const float* below = plane + W;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        // __ldg: global loads through the read-only path, one 32-bit
        // offset each from the plane (a pointer from shared memory would
        // read as a generic one)
        const float* t0 = plane + off[k];
        const float* t1 = below + off[k];
        const float top = __ldg(t0) * gx[k] + __ldg(t0 + 1) * fx[k];
        const float bot = __ldg(t1) * gx[k] + __ldg(t1 + 1) * fx[k];
        v[k] = top * gy[k] + bot * fy[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k)
        v[k] = plain_value<MODE, PERSP>(sl, plane, xs[k], ys, H, W, sy0f);
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (x0 + 32 * k < OW) __stcs(orow + 32 * k, v[k]);
  }
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

// B5, accumulate form: see the header.  A block's four warps take four
// output rows, a lane B5A_PIXELS pixels of its row (x = x0 + lane + 32k),
// and each thread walks the frames in order with its sums in registers.
constexpr int B5A_ROWS = 4;
constexpr int B5A_THREADS = 32 * B5A_ROWS;
constexpr int B5A_PIXELS = 2;
constexpr int B5A_TILE = 32 * B5A_PIXELS;  // output columns a block
constexpr int B5A_CHUNK = 32;  // frames whose maps a block stages at once

// One frame's inverse map m0..m8 and valid[n], staged as three float4
struct FrameMap {
  float4 a, b, c;  // {m0 m1 m2 m3} {m4 m5 m6 m7} {m8 valid - -}
};

// The values v[k][c] (c < C) of output pixels (xs[k], ys) under the
// inverse map m of frame f ([H,W,C] in its own type; wc = W * C), the
// body of both interleaved forms: the row products once, then per pixel
// the coordinates as ops/warp.py:56-62 writes them, the reciprocal and
// the bins off the conversion pipe (csrc/warp_bins.cuh), a 32-bit tap
// offset and the two weights; with every reciprocal on its fast path and
// every tap in the strip (fast_w, fast_y0, fast_h as warp_kernel's) the
// taps are read with no index map or border select, else each pixel
// takes the plain expressions (frame_taps / sample).
template <int MODE, typename T, bool PERSP, int P>
__device__ __forceinline__ void frame_pixels(
    const float (&m)[9], const T* __restrict__ f, const float (&xs)[P],
    float ys, int sy0, int H, int W, int C, unsigned wc, float scale,
    const Border4& border, unsigned fast_w, int fast_y0, unsigned fast_h,
    float (&v)[P][4]) {
  const float r1 = m[1] * ys, r4 = m[4] * ys, r7 = m[7] * ys;
  // the P pixels' tap offsets and weights; `fast`: every reciprocal on
  // its fast path and every tap in the strip
  bool fast = true;
  unsigned off[P];
  float fx[P], fy[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float sx = (m[0] * xs[k] + r1) + m[2];
    float sy = (m[3] * xs[k] + r4) + m[5];
    if (PERSP) {
      const float sw = (m[6] * xs[k] + r7) + m[8];
      bool ok;
      const float inv = rcp_fast(sw, ok);
      fast &= ok;
      sx = sx * inv;
      sy = sy * inv;
    }
    const int qx = quant<PERSP>(sx), qy = quant<PERSP>(sy);
    const int tx = qx >> 5, ty = (qy >> 5) - sy0;
    fast &= (unsigned)tx < fast_w && (unsigned)(ty - fast_y0) < fast_h;
    off[k] = (unsigned)ty * wc + (unsigned)tx * (unsigned)C;
    fx[k] = frac32(qx);
    fy[k] = frac32(qy);
  }
  if (fast) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const T* p0 = f + off[k];
      const T* p1 = p0 + wc;
      const float gx = 1.0f - fx[k], gy = 1.0f - fy[k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= C) break;
        const float top = widen<T>(p0[c], scale) * gx +
                          widen<T>(p0[C + c], scale) * fx[k];
        const float bot = widen<T>(p1[c], scale) * gx +
                          widen<T>(p1[C + c], scale) * fx[k];
        v[k][c] = top * gy + bot * fy[k];
      }
    }
  } else {
    // a tap off the strip, or a reciprocal off its fast path: each pixel
    // as the plain version takes it
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const Taps t = frame_taps<MODE>(m, xs[k], ys, H, W, PERSP, (float)sy0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= C) break;
        v[k][c] = sample<MODE, T>(f, t, c, C, border.v[c], scale);
      }
    }
  }
}

// fast_w, fast_y0, fast_h as warp_kernel's (launch_accum); CH the
// channels where fixed at compile time (3), else 0 and C is read
template <int MODE, typename T, bool PERSP, int CH>
__global__ void __launch_bounds__(B5A_THREADS)
accum_kernel(const T* __restrict__ frames, const float* __restrict__ minv,
             const float* __restrict__ valid, Border4 border,
             float* __restrict__ out, int N, int H, int W, int C_any,
             float scale, int tiles_x, int oy0, int sy0, unsigned fast_w,
             int fast_y0, unsigned fast_h) {
  constexpr int P = B5A_PIXELS;
  const int C = CH ? CH : C_any;
  __shared__ FrameMap maps[B5A_CHUNK];
  const int tile = (int)(blockIdx.x % (unsigned)tiles_x);
  const int yy = (int)(blockIdx.x / (unsigned)tiles_x) * B5A_ROWS +
                 (int)(threadIdx.x >> 5);
  const int y = min(yy, H - 1);
  const int x0 = tile * B5A_TILE + (int)(threadIdx.x & 31);
  float xs[P];
#pragma unroll
  for (int k = 0; k < P; ++k) xs[k] = (float)min(x0 + 32 * k, W - 1);
  const float ys = (float)(y + oy0);
  const unsigned wc = (unsigned)W * (unsigned)C;  // a row's elements
  const size_t frame_elems = (size_t)H * W * C;
  float acc[P][4];
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[k][c] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += B5A_CHUNK) {
    const int count = min(B5A_CHUNK, N - n0);
    __syncthreads();
    if ((int)threadIdx.x < count) {
      const int n = n0 + (int)threadIdx.x;
      const float* m = minv + 9 * (size_t)n;
      maps[threadIdx.x].a = make_float4(m[0], m[1], m[2], m[3]);
      maps[threadIdx.x].b = make_float4(m[4], m[5], m[6], m[7]);
      maps[threadIdx.x].c = make_float4(m[8], valid[n], 0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < count; ++j) {
      const FrameMap fm = maps[j];
      const float vn = fm.c.y;
      if (vn == 0.0f) continue;  // dropped: the whole block skips it
      const float m[9] = {fm.a.x, fm.a.y, fm.a.z, fm.a.w, fm.b.x,
                          fm.b.y, fm.b.z, fm.b.w, fm.c.x};
      float v[P][4];
      frame_pixels<MODE, T, PERSP, P>(
          m, frames + (size_t)(n0 + j) * frame_elems, xs, ys, sy0, H, W, C,
          wc, scale, border, fast_w, fast_y0, fast_h, v);
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < C) acc[k][c] = acc[k][c] + v[k][c] * vn;
    }
  }
  if (yy >= H) return;
  float* orow = out + (size_t)y * wc;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int x = x0 + 32 * k;
    if (x >= W) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < C) __stcs(orow + (size_t)x * C + c, acc[k][c]);
  }
}

// B5, frames form: see the header.  Block (tile, band) of frame
// blockIdx.y: its four warps take four output rows, a lane B5F_PIXELS
// pixels of its row (x = x0 + lane + 32k), and each warp's 32 pixels of
// a k leave as 32 * C contiguous floats, transposed through shared
// memory so that lane l stores elements l, l + 32, ... of the span, or
// with `vec` (rows of a multiple of 16 bytes) its float4 l.
constexpr int B5F_PIXELS = 4;
constexpr int B5F_TILE = 32 * B5F_PIXELS;
template <int MODE, typename T, bool PERSP, int CH>
__global__ void __launch_bounds__(B5A_THREADS)
frames_kernel(const T* __restrict__ frames, const float* __restrict__ minv,
              Border4 border, float* __restrict__ out, int H, int W,
              int C_any, float scale, int tiles_x, int oy0, int sy0,
              unsigned fast_w, int fast_y0, unsigned fast_h, int vec) {
  constexpr int P = B5F_PIXELS;
  const int C = CH ? CH : C_any;
  __shared__ float map[9];
  __shared__ float4 stage[B5A_ROWS][32];
  const int n = (int)blockIdx.y;
  if (threadIdx.x < 9) map[threadIdx.x] = minv[9 * (size_t)n + threadIdx.x];
  __syncthreads();
  const int tile = (int)(blockIdx.x % (unsigned)tiles_x);
  const int wid = (int)(threadIdx.x >> 5), lane = (int)(threadIdx.x & 31);
  const int y = (int)(blockIdx.x / (unsigned)tiles_x) * B5A_ROWS + wid;
  if (y >= H) return;  // the whole warp
  const int x0 = tile * B5F_TILE + lane;
  float xs[P];
#pragma unroll
  for (int k = 0; k < P; ++k) xs[k] = (float)min(x0 + 32 * k, W - 1);
  const unsigned wc = (unsigned)W * (unsigned)C;
  const size_t frame_elems = (size_t)H * W * C;
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = map[i];
  float v[P][4];
  frame_pixels<MODE, T, PERSP, P>(m, frames + (size_t)n * frame_elems, xs,
                                  (float)(y + oy0), sy0, H, W, C, wc, scale,
                                  border, fast_w, fast_y0, fast_h, v);
  float* orow = out + (size_t)n * frame_elems + (size_t)y * wc;
  float* st = reinterpret_cast<float*>(stage[wid]);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int xb = tile * B5F_TILE + 32 * k;  // the span's first pixel
    if (xb >= W) break;  // the whole warp
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < C) st[lane * C + c] = v[k][c];
    __syncwarp();
    const int span = min(32, W - xb) * C;
    float* dst = orow + (size_t)xb * C;
    if (vec) {
      if (4 * lane < span)
        __stcs(reinterpret_cast<float4*>(dst) + lane, stage[wid][lane]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= C) break;
        const int e = lane + 32 * j;
        if (e < span) __stcs(dst + e, st[e]);
      }
    }
    __syncwarp();
  }
}

// The fast path's extents for a strip of H rows from global row sy0
// (0 where a frame's taps need offsets of 31 bits or more): a tap origin
// (tx, ty) with tx < fast_w and fast_y0 <= ty < fast_y0 + fast_h has its
// four taps in the strip and exact integer bins (not negative, below
// 2^18 per axis, 2^13 for the affine bins), its global row tested.
template <bool PERSP>
void fast_extents(long long H, long long W, long long C, int sy0,
                  unsigned& fast_w, int& fast_y0, unsigned& fast_h) {
  const long long lim = PERSP ? BIN_LIMIT_PERSP : BIN_LIMIT_AFFINE;
  const bool narrow = H * W * C <= 0x7fffffffLL;
  const long long ty_lo = sy0 < 0 ? -(long long)sy0 : 0;
  const long long ty_hi = H - 1 < lim - sy0 ? H - 1 : lim - sy0;
  fast_w = narrow ? (unsigned)(W - 1 < lim ? W - 1 : lim) : 0u;
  fast_y0 = (int)ty_lo;
  fast_h = narrow && ty_hi > ty_lo ? (unsigned)(ty_hi - ty_lo) : 0u;
}

template <int MODE, typename T, bool PERSP>
cudaError_t launch_accum(const T* f, const float* minv, const Border4& border,
                         const float* valid, float* out, int N, int H, int W,
                         int C, float scale, int oy0, int sy0,
                         cudaStream_t st) {
  const long long tiles_x = (W + B5A_TILE - 1) / B5A_TILE;
  const long long blocks = tiles_x * ((H + B5A_ROWS - 1) / B5A_ROWS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  unsigned fw, fh;
  int fy0;
  fast_extents<PERSP>(H, W, C, sy0, fw, fy0, fh);
  if (C == 3) {
    accum_kernel<MODE, T, PERSP, 3><<<(unsigned)blocks, B5A_THREADS, 0, st>>>(
        f, minv, valid, border, out, N, H, W, C, scale, (int)tiles_x, oy0,
        sy0, fw, fy0, fh);
  } else {
    accum_kernel<MODE, T, PERSP, 0><<<(unsigned)blocks, B5A_THREADS, 0, st>>>(
        f, minv, valid, border, out, N, H, W, C, scale, (int)tiles_x, oy0,
        sy0, fw, fy0, fh);
  }
  return cudaGetLastError();
}

// The frames form: the accumulate form's tiles for each frame, the frame
// on the grid's y axis
template <int MODE, typename T, bool PERSP>
cudaError_t launch_each(const T* f, const float* minv, const Border4& border,
                        float* out, int N, int H, int W, int C, float scale,
                        int oy0, int sy0, cudaStream_t st) {
  const long long tiles_x = (W + B5F_TILE - 1) / B5F_TILE;
  const long long blocks = tiles_x * ((H + B5A_ROWS - 1) / B5A_ROWS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  unsigned fw, fh;
  int fy0;
  fast_extents<PERSP>(H, W, C, sy0, fw, fy0, fh);
  const dim3 grid((unsigned)blocks, (unsigned)N);
  // every span a whole number of float4 from a 16-byte boundary
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (C == 3) {
    frames_kernel<MODE, T, PERSP, 3><<<grid, B5A_THREADS, 0, st>>>(
        f, minv, border, out, H, W, C, scale, (int)tiles_x, oy0, sy0, fw,
        fy0, fh, vec);
  } else {
    frames_kernel<MODE, T, PERSP, 0><<<grid, B5A_THREADS, 0, st>>>(
        f, minv, border, out, H, W, C, scale, (int)tiles_x, oy0, sy0, fw,
        fy0, fh, vec);
  }
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t launch_frames(const void* frames, const float* minv,
                          const Border4& border, const float* valid,
                          float* out, int N, int H, int W, int C,
                          int perspective, float scale, int oy0, int sy0,
                          cudaStream_t st) {
  const T* f = static_cast<const T*>(frames);
  if (valid) {
    return perspective
               ? launch_accum<MODE, T, true>(f, minv, border, valid, out, N,
                                             H, W, C, scale, oy0, sy0, st)
               : launch_accum<MODE, T, false>(f, minv, border, valid, out, N,
                                              H, W, C, scale, oy0, sy0, st);
  }
  return perspective
             ? launch_each<MODE, T, true>(f, minv, border, out, N, H, W, C,
                                          scale, oy0, sy0, st)
             : launch_each<MODE, T, false>(f, minv, border, out, N, H, W, C,
                                           scale, oy0, sy0, st);
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

// The grid and the fast path's extents of a planar launch, then the
// launch: a tap origin is fast where its four taps lie in the strip and
// its bins are exact (below 2^18 per axis, 2^13 for the affine bins, and
// not negative), and where a strip's offsets fit 32 bits.
template <int MODE, bool PERSP>
cudaError_t launch_planar(const float* src, const float* minv,
                          const float* border, float border_value,
                          const int32_t* sidx, float* out, int G, int H,
                          int W, int OH, int OW, int oy0, int sy0,
                          cudaStream_t st) {
  const long long tiles_x = (OW + B5_TILE - 1) / B5_TILE;
  const long long bands = (OH + B5_ROWS - 1) / B5_ROWS;
  const long long blocks =
      tiles_x * bands * ((G + B5_SLOTS - 1) / B5_SLOTS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long lim = PERSP ? BIN_LIMIT_PERSP : BIN_LIMIT_AFFINE;
  const bool narrow = (long long)H * W <= 0xffffffffLL;
  const long long ty_lo = sy0 < 0 ? -(long long)sy0 : 0;
  const long long ty_hi = H - 1 < lim - sy0 ? H - 1 : lim - sy0;
  const unsigned fast_w = narrow ? (unsigned)(W - 1 < lim ? W - 1 : lim) : 0u;
  const unsigned fast_h =
      narrow && ty_hi > ty_lo ? (unsigned)(ty_hi - ty_lo) : 0u;
  warp_kernel<MODE, PERSP><<<(unsigned)blocks, B5_THREADS, 0, st>>>(
      src, minv, border, border_value, sidx, out, G, H, W, OH, OW,
      (int)tiles_x, (int)bands, oy0, sy0, fast_w, (int)ty_lo, fast_h);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const float* src, const float* minv, const float* border,
                   float border_value, const int32_t* sidx, float* out, int G,
                   int H, int W, int OH, int OW, int perspective, int oy0,
                   int sy0, cudaStream_t st) {
  return perspective
             ? launch_planar<MODE, true>(src, minv, border, border_value,
                                         sidx, out, G, H, W, OH, OW, oy0,
                                         sy0, st)
             : launch_planar<MODE, false>(src, minv, border, border_value,
                                          sidx, out, G, H, W, OH, OW, oy0,
                                          sy0, st);
}

}  // namespace

extern "C" {

// src [S,H,W] f32, minv [G,3,3] f32 inverse maps, border [G] f32 or
// null (then border_value for every slot; either read in BORDER_CONSTANT
// only), src_index [G] i32 (each in 0..S-1, checked by the wrapper) or
// null (slot g reads plane g), out [G,OH,OW] f32.  border_mode is
// OpenCV's integer (0 constant, 1 replicate, 2 reflect, 3 wrap, 4
// reflect101); oy0 / sy0 the row origins (header).
int warp_bilinear(const void* src, const void* minv, const void* border,
                  float border_value, const void* src_index, void* out, int G,
                  int H, int W, int OH, int OW, int border_mode,
                  int perspective, int oy0, int sy0, void* stream) {
  if (G <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto m = static_cast<const float*>(minv);
  auto b = static_cast<const float*>(border);
  auto i = static_cast<const int32_t*>(src_index);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const float bv = border_value;
  switch (border_mode) {
    case CONSTANT: return (int)launch<CONSTANT>(s, m, b, bv, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case REPLICATE: return (int)launch<REPLICATE>(s, m, b, bv, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case REFLECT: return (int)launch<REFLECT>(s, m, b, bv, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case WRAP: return (int)launch<WRAP>(s, m, b, bv, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
    case REFLECT101: return (int)launch<REFLECT101>(s, m, b, bv, i, o, G, H, W, OH, OW, perspective, oy0, sy0, st);
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
