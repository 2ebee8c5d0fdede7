// FAST-9/16 segment test + cornerScore + 3x3 non-max suppression + the
// ORB edge band, in one pass over a batch of images:
//   out[n, y, x] = score if (y, x) is a kept corner inside the band, else 0
//
// Replaces the Pallas TPU kernel libstacker_tpu/ops/fast_pallas.py
// _fast_kernel (:52; call :219, entry fast_scores_batched :186).
// Semantics: ops/fast.py fast_detect (OpenCV FAST type 9_16 with
// nonmaxSuppression) followed by the edge_threshold band of ORB's
// detection (libstacker_tpu/ops/orb.py:245-254): a pixel is a corner if
// some contiguous arc of 9 of the 16 circle pixels is brighter than
// centre + t or darker than centre - t; its score is the max over arcs
// of the arc's min absolute difference, minus 1; pixels within 3 of the
// image edge are never corners; a corner is kept if its score is
// strictly greater than all 8 neighbours' (zero outside the image);
// kept corners outside [b, H-b) x [b, W-b) are zeroed.
//
// What bounds it on the H100.  The image is read once (1 byte a pixel
// for u8) and the float32 score map written once: 5 bytes a pixel,
// ~0.83 GB for 20 frames of 4K, ~0.25 ms at 3.35 TB/s.  The segment
// test is ~180 integer min/max/sub operations a pixel if done for every
// pixel; the exact compass pre-test below (an arc of 9 contains at
// least 2 of the circle pixels 0, 4, 8, 12) skips the arc tree for most
// pixels of natural content, so the pass is bound by memory traffic.
//
// Design: one block per 64x16 output tile of one frame.  The tile plus
// a 4-pixel halo (3 for the circle, 1 for the NMS ring) is staged in
// shared memory in the source type (edge-clamped reads; the values of
// clamped pixels never reach a kept score).  Scores are computed for
// the tile and its 1-pixel ring into shared memory, and the NMS reads
// them from there: the score map never makes a round trip through
// device memory.  u8 differences are exact in int; float sources are
// compared in float32, as the plain version does.  The TPU kernel's
// (8,128)-aligned windows, _PAD_T_U8 and bf16 tree existed for the
// TPU's DMA and vector units and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;
constexpr int TH = 16;
constexpr int HALO = 4;
constexpr int WW = TW + 2 * HALO;  // staged window
constexpr int WH = TH + 2 * HALO;
constexpr int EW = TW + 2;  // score region: tile + 1-px ring
constexpr int EH = TH + 2;
constexpr int THREADS = 256;

__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

template <typename T> struct Acc { typedef int type; };
template <> struct Acc<float> { typedef float type; };

// max over the 16 circular windows of length 9 of the window minimum
// (the log-doubling tree of ops/fast.py; min and max are exact)
template <typename A>
__device__ __forceinline__ A arc_strength(const A (&v)[16]) {
  A w2[16], w4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w2[i] = min(v[i], v[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) w4[i] = min(w2[i], w2[(i + 2) & 15]);
  A best = min(min(w4[0], w4[4]), v[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    best = max(best, min(min(w4[i], w4[(i + 4) & 15]), v[(i + 8) & 15]));
  }
  return best;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fast_kernel(const T* __restrict__ imgs, float* __restrict__ out, int H, int W,
            float threshold, int border) {
  typedef typename Acc<T>::type A;
  __shared__ T win[WH][WW];
  __shared__ float sc[EH][EW];
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const T* img = imgs + (size_t)n * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < WH * WW; i += THREADS) {
    const int r = i / WW, c = i - r * WW;
    const int gy = min(max(ty0 - HALO + r, 0), H - 1);
    const int gx = min(max(tx0 - HALO + c, 0), W - 1);
    win[r][c] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  const A t = (A)threshold;
  for (int i = tid; i < EH * EW; i += THREADS) {
    const int r = i / EW, c = i - r * EW;
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    float s = 0.0f;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int wy = r + HALO - 1, wx = c + HALO - 1;
      const A ctr = (A)win[wy][wx];
      A e[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) e[k] = (A)win[wy + c_dy[k]][wx + c_dx[k]] - ctr;
      int nb = 0, nd = 0;  // compass pre-test (exact, see the header)
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        nb += e[k] > t;
        nd += e[k] < -t;
      }
      if (nb >= 2 || nd >= 2) {
        const A tb = arc_strength<A>(e);
        A ne[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) ne[k] = -e[k];
        const A td = arc_strength<A>(ne);
        if (tb > t || td > t) s = (float)max(tb, td) - 1.0f;
      }
    }
    sc[r][c] = s;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += THREADS) {
    const int r = i / TW, c = i - r * TW;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= H || gx >= W) continue;
    const float ctr = sc[r + 1][c + 1];
    float nmax = sc[r][c];
    nmax = fmaxf(nmax, sc[r][c + 1]);
    nmax = fmaxf(nmax, sc[r][c + 2]);
    nmax = fmaxf(nmax, sc[r + 1][c]);
    nmax = fmaxf(nmax, sc[r + 1][c + 2]);
    nmax = fmaxf(nmax, sc[r + 2][c]);
    nmax = fmaxf(nmax, sc[r + 2][c + 1]);
    nmax = fmaxf(nmax, sc[r + 2][c + 2]);
    const bool in_band = gy >= border && gy < H - border && gx >= border &&
                         gx < W - border;
    out[(size_t)n * H * W + (size_t)gy * W + gx] =
        (in_band && ctr > nmax) ? ctr : 0.0f;
  }
}

template <typename T>
cudaError_t launch(const void* imgs, float* out, int N, int H, int W,
                   float threshold, int border, cudaStream_t st) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  fast_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(imgs), out,
                                           H, W, threshold, border);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// imgs [N,H,W] (dtype_code 0 = u8, 2 = f32), out [N,H,W] f32.
int fast_scores(const void* imgs, void* out, int N, int H, int W,
                int dtype_code, float threshold, int border, void* stream) {
  if (H <= 0 || W <= 0 || N <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return (int)launch<uint8_t>(imgs, o, N, H, W, threshold, border, st);
    case 2: return (int)launch<float>(imgs, o, N, H, W, threshold, border, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
