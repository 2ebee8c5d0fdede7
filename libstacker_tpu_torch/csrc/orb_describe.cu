// ORB at the candidates and at the kept keypoints of one pyramid level,
// with every 43x43 window kept on chip:
//
//   B3h  candidate_harris: the Harris response of the 9x9 centre of each
//        candidate's clamped window, -inf where the candidate is invalid;
//   B3d  describe: at each kept keypoint, the intensity-centroid angle,
//        the 7x7 sigma-2 Gaussian blur of its window (VALID) and the 256
//        steered rBRIEF compares, packed LSB-first into 32 bytes.
//
// Replace the Pallas TPU kernel libstacker_tpu/ops/orb_pallas.py
// _extract_kernel (:54; call :111, entry extract_patches_batched :85)
// together with the eager chain that read its patches in ops/orb.py:
// fast.harris_from_patches on the patches' centres, the gather of the
// kept patches, _ic_angles_from_patches, _blur_patches_valid and
// _rbrief_from_patches (csrc/orb_extract.cu, the one-to-one port of the
// TPU kernel, wrote [N, 2q, 43, 43] float32 patches to device memory for
// that chain: 32 MB at the 4K level 0 of a 20-frame burst, then read by
// some 80 launches a level).  The TPU kernel exists to DMA each window
// into VMEM; on the H100 a window is 1.8 KB of shared memory, and
// nothing derived from it needs to reach device memory.
//
// The window of a keypoint (y, x) on an H x W level starts at
// (clamp(y - 21, 0, H - 43), clamp(x - 21, 0, W - 43)), as
// ops/orb_cuda.extract_patches_reference cuts it; Harris reads its rows
// and columns 17..25.
//
// What bounds them on the H100.  At the 4K level 0 of a 20-frame burst
// B3h reads 81 bytes for each of 20 x 218 candidates (~0.4 MB) and does
// ~1.3k integer operations for each; B3d reads 1849 bytes for each of
// 20 x 109 keypoints (~4 MB) and does ~41k float operations for each
// (the blur is most of them), ~0.09 G in all: ~1.3 us at 3.35 TB/s and
// 67 T/s.  Both are below a launch's latency: what they save is the
// launches and the patch tensor's round trip of the chain they replace.
//
// Design.  B3h: one warp per candidate stages the 9x9 block in shared
// memory and sums Ix^2, Iy^2 and Ix*Iy over its 7x7 positions exactly,
// in int32 (|Ix|, |Iy| <= 4 * 255, so each sum is at most 49 * 1020^2 <
// 2^31), then evaluates the response in float32.  The plain version
// sums the same integers exactly in float64 and casts once, so the two
// agree bitwise (a float32 sum of those products could round, 5.1e7 >
// 2^24, in an order no two libraries share).  B3d: one block of 128
// threads per keypoint loads the window once into shared memory as
// float32, takes the IC moments over the radius-15 circle as exact
// integers (|m10| <= 961 * 15 * 255 < 2^24, so any order gives the
// plain version's float32 sum), blurs rows then columns into shared
// tiles in the plain version's term order, each product and sum
// separately rounded (__fmul_rn / __fadd_rn, which are never fused),
// and makes each warp's 32 compares one __ballot_sync word of the
// descriptor.  atan2f, cosf and sinf are the CUDA math library's, the
// functions PyTorch's CUDA atan2 / cos / sin call.  The rBRIEF pattern
// and the circle's row extents are read from a small device buffer
// (copied once per device by the wrapper): each thread reads its own
// pattern row, which the constant cache would serialise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int R = 21;          // window radius (BLUR_RADIUS)
constexpr int SIDE = 2 * R + 1;  // 43
constexpr int PR = 18;         // blurred patch radius (PATCH_RADIUS)
constexpr int PS = 2 * PR + 1;   // 37
constexpr int HALF = 15;       // IC circle radius
constexpr int HB = 9;          // Harris block 7 plus the Sobel ring
constexpr int HO = R - 4;      // Harris block origin in the window (17)
constexpr int HARRIS_WARPS = 4;
constexpr int DESC_THREADS = 128;
constexpr int DESC_WARPS = DESC_THREADS / 32;

struct Gauss7 {
  float k[7];
};

__device__ __forceinline__ int origin(int c, int n) {
  return min(max(c - R, 0), n - SIDE);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(HARRIS_WARPS * 32)
harris_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ ys,
              const int* __restrict__ xs, const uint8_t* __restrict__ valid,
              float* __restrict__ out, int K, int total, int H, int W,
              float harris_k, float scale4) {
  __shared__ int pix[HARRIS_WARPS][HB * HB];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * HARRIS_WARPS + wid;
  if (i >= total) return;  // the whole warp
  if (!valid[i]) {
    if (lane == 0) out[i] = -INFINITY;
    return;
  }
  const int n = i / K;
  const int y0 = origin(ys[i], H) + HO, x0 = origin(xs[i], W) + HO;
  const uint8_t* src = imgs + (size_t)n * H * W + (size_t)y0 * W + x0;
  int* p = pix[wid];
  for (int j = lane; j < HB * HB; j += 32) {
    const int r = j / HB, c = j - r * HB;
    p[j] = src[(size_t)r * W + c];
  }
  __syncwarp();
  int a = 0, b = 0, c = 0;
  for (int j = lane; j < 49; j += 32) {
    const int r = j / 7, q = j - r * 7;
    const int* t = p + r * HB + q;  // rows r..r+2, columns q..q+2
    // fast.harris_from_patches: dx along a row, dy along a column, then
    // the Sobel sums 2 * d[1] + d[0] + d[2]
    const int dx0 = t[2] - t[0], dx1 = t[HB + 2] - t[HB],
              dx2 = t[2 * HB + 2] - t[2 * HB];
    const int dy0 = t[2 * HB] - t[0], dy1 = t[2 * HB + 1] - t[1],
              dy2 = t[2 * HB + 2] - t[2];
    const int ix = 2 * dx1 + dx0 + dx2;
    const int iy = 2 * dy1 + dy0 + dy2;
    a += ix * ix;
    b += iy * iy;
    c += ix * iy;
  }
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  if (lane == 0) {
    const float af = (float)a, bf = (float)b, cf = (float)c;
    // (a * b - c * c - k * (a + b) ** 2) * scale4, rounded term by term
    const float det = __fsub_rn(__fmul_rn(af, bf), __fmul_rn(cf, cf));
    const float tr = __fadd_rn(af, bf);
    const float r = __fsub_rn(det, __fmul_rn(harris_k, __fmul_rn(tr, tr)));
    out[i] = __fmul_rn(r, scale4);
  }
}

__global__ void __launch_bounds__(DESC_THREADS)
describe_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ ys,
                const int* __restrict__ xs, const int* __restrict__ consts,
                float* __restrict__ angle, uint32_t* __restrict__ desc,
                int Q, int H, int W, Gauss7 g, float rad2deg, float deg2rad) {
  __shared__ float win[SIDE * SIDE];
  __shared__ float rows[PS * SIDE];
  __shared__ float blur[PS * PS];
  __shared__ int umax[HALF + 1];
  __shared__ int part[2][DESC_WARPS];
  __shared__ float rot[2];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int i = blockIdx.x;
  const int n = i / Q;
  const int y0 = origin(ys[i], H), x0 = origin(xs[i], W);
  const uint8_t* src = imgs + (size_t)n * H * W + (size_t)y0 * W + x0;
  for (int j = tid; j < SIDE * SIDE; j += DESC_THREADS) {
    const int r = j / SIDE, c = j - r * SIDE;
    win[j] = (float)src[(size_t)r * W + c];
  }
  if (tid <= HALF) umax[tid] = consts[256 + tid];
  __syncthreads();

  // intensity-centroid moments over the radius-15 circle, exact
  int m10 = 0, m01 = 0;
  for (int j = tid; j < (2 * HALF + 1) * (2 * HALF + 1); j += DESC_THREADS) {
    const int v = j / (2 * HALF + 1) - HALF;
    const int u = j - (v + HALF) * (2 * HALF + 1) - HALF;
    if (abs(u) <= umax[abs(v)]) {
      const int pv = (int)win[(R + v) * SIDE + R + u];
      m10 += u * pv;
      m01 += v * pv;
    }
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  if (lane == 0) {
    part[0][wid] = m10;
    part[1][wid] = m01;
  }

  // _blur_patches_valid: rows (down a column) into 37 x 43, then
  // columns into 37 x 37, terms added in tap order
  for (int j = tid; j < PS * SIDE; j += DESC_THREADS) {
    const float* s = win + j;  // row j / SIDE, column j % SIDE
    float acc = __fmul_rn(g.k[0], s[0]);
#pragma unroll
    for (int t = 1; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(g.k[t], s[t * SIDE]));
    rows[j] = acc;
  }
  __syncthreads();
  for (int j = tid; j < PS * PS; j += DESC_THREADS) {
    const int r = j / PS, c = j - r * PS;
    const float* s = rows + r * SIDE + c;
    float acc = __fmul_rn(g.k[0], s[0]);
#pragma unroll
    for (int t = 1; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(g.k[t], s[t]));
    blur[j] = acc;
  }
  if (tid == 0) {
    int s10 = 0, s01 = 0;
    for (int w = 0; w < DESC_WARPS; ++w) {
      s10 += part[0][w];
      s01 += part[1][w];
    }
    // atan2(m01, m10) * (180 / pi), + 360 where negative
    float a = __fmul_rn(atan2f((float)s01, (float)s10), rad2deg);
    if (a < 0.0f) a = __fadd_rn(a, 360.0f);
    angle[i] = a;
    const float rad = __fmul_rn(a, deg2rad);
    rot[0] = cosf(rad);
    rot[1] = sinf(rad);
  }
  __syncthreads();

  // steered rBRIEF: taps rint(x cos - y sin), rint(x sin + y cos)
  const float ca = rot[0], sa = rot[1];
  const char4* pattern = reinterpret_cast<const char4*>(consts);
  for (int b = tid; b < 256; b += DESC_THREADS) {
    const char4 pt = pattern[b];
    const float x1 = pt.x, y1 = pt.y, x2 = pt.z, y2 = pt.w;
    const int rx1 = (int)rintf(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sa))) + PR;
    const int ry1 = (int)rintf(__fadd_rn(__fmul_rn(x1, sa), __fmul_rn(y1, ca))) + PR;
    const int rx2 = (int)rintf(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sa))) + PR;
    const int ry2 = (int)rintf(__fadd_rn(__fmul_rn(x2, sa), __fmul_rn(y2, ca))) + PR;
    const bool bit = blur[ry1 * PS + rx1] < blur[ry2 * PS + rx2];
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) desc[(size_t)i * 8 + (b >> 5)] = word;
  }
}

}  // namespace

extern "C" {

// imgs [N,H,W] u8, ys/xs [N,K] i32, valid [N,K] u8 (bool), out [N,K] f32;
// requires H, W >= 43.
int candidate_harris(const void* imgs, const void* ys, const void* xs,
                     const void* valid, void* out, int N, int K, int H,
                     int W, float harris_k, float scale4, void* stream) {
  if (N <= 0 || K <= 0 || H < SIDE || W < SIDE) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * K;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + HARRIS_WARPS - 1) / HARRIS_WARPS);
  harris_kernel<<<blocks, HARRIS_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int*>(ys),
      static_cast<const int*>(xs), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), K, (int)total, H, W, harris_k, scale4);
  return (int)cudaGetLastError();
}

// imgs [N,H,W] u8, ys/xs [N,Q] i32, consts [272] i32 on the device (the
// 256 rBRIEF pattern rows as int8 x1, y1, x2, y2, then the circle's 16
// row extents umax), blur_taps [7] f32 on the host, angle [N,Q] f32,
// desc [N,Q,32] u8; requires H, W >= 43.
int orb_describe(const void* imgs, const void* ys, const void* xs,
                 const void* consts, const float* blur_taps, void* angle,
                 void* desc, int N, int Q, int H, int W, float rad2deg,
                 float deg2rad, void* stream) {
  if (N <= 0 || Q <= 0 || H < SIDE || W < SIDE) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * Q;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Gauss7 g;
  for (int t = 0; t < 7; ++t) g.k[t] = blur_taps[t];
  describe_kernel<<<(unsigned)total, DESC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int*>(ys),
      static_cast<const int*>(xs), static_cast<const int*>(consts),
      static_cast<float*>(angle), static_cast<uint32_t*>(desc), Q, H, W, g,
      rad2deg, deg2rad);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
