// Per-keypoint patch extraction with clamped origins:
//   out[n, k, r, c] = float(img[n, y0 + r, x0 + c]),
//   y0 = clamp(ys[n, k] - radius, 0, H - side),
//   x0 = clamp(xs[n, k] - radius, 0, W - side),  side = 2 * radius + 1
//
// Replaces the Pallas TPU kernel libstacker_tpu/ops/orb_pallas.py
// _extract_kernel (:54; call :111, entry extract_patches_batched :85).
// The ORB detector (ops/orb.py) cuts one 43x43 patch (radius 21, the
// rBRIEF taps plus the Gaussian blur support) per candidate keypoint of
// each pyramid level; Harris, the intensity-centroid angle, the patch
// blur and rBRIEF all read from these patches.
//
// What bounds it on the H100.  The work is a gather and a widening
// cast: no arithmetic.  At the 4K level-0 shape (20 frames x 218
// keypoints x 43x43) it writes 32 MB of float32 and reads at most 8 MB
// of u8 windows, ~0.012 ms at 3.35 TB/s; at that size launch latency
// and the few thousand blocks' ramp dominate, not bandwidth.
//
// Design: one block per (keypoint, frame); its threads walk the
// side x side window in raster order, so neighbouring threads read
// neighbouring bytes of a source row and write neighbouring floats of
// the output (coalesced).  The level image is read in its own type (u8
// on the ORB path) and widened in the kernel, so the result equals the
// TPU kernel's, which received the image already cast to float32.  The
// TPU kernel's (8,128)-aligned window DMA and the two dynamic rolls
// that re-aligned it have no counterpart: a CUDA thread reads any byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const T* __restrict__ imgs, const int* __restrict__ ys,
               const int* __restrict__ xs, float* __restrict__ out, int K,
               int H, int W, int radius) {
  const int k = blockIdx.x;
  const int n = blockIdx.y;
  const int side = 2 * radius + 1;
  const int i = n * K + k;
  const int y0 = min(max(ys[i] - radius, 0), H - side);
  const int x0 = min(max(xs[i] - radius, 0), W - side);
  const T* src = imgs + (size_t)n * H * W + (size_t)y0 * W + x0;
  float* dst = out + (size_t)i * side * side;
  for (int j = threadIdx.x; j < side * side; j += THREADS) {
    const int r = j / side, c = j - r * side;
    dst[j] = (float)src[(size_t)r * W + c];
  }
}

template <typename T>
cudaError_t launch(const void* imgs, const int* ys, const int* xs, float* out,
                   int N, int K, int H, int W, int radius, cudaStream_t st) {
  dim3 grid(K, N);
  extract_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(imgs), ys,
                                              xs, out, K, H, W, radius);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// imgs [N,H,W] (dtype_code 0 = u8, 2 = f32), ys/xs [N,K] int32,
// out [N,K,side,side] f32; requires H, W >= 2 * radius + 1.
int extract_patches(const void* imgs, const void* ys, const void* xs,
                    void* out, int N, int K, int H, int W, int radius,
                    int dtype_code, void* stream) {
  const int side = 2 * radius + 1;
  if (N <= 0 || K <= 0 || N > 65535 || radius < 0 || H < side || W < side)
    return (int)cudaErrorInvalidValue;
  auto y = static_cast<const int*>(ys);
  auto x = static_cast<const int*>(xs);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return (int)launch<uint8_t>(imgs, y, x, o, N, K, H, W, radius, st);
    case 2: return (int)launch<float>(imgs, y, x, o, N, K, H, W, radius, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
