// The four sharpness metrics of [N, H, W] grey frames (u8, u16 or
// float32) in one pass over the pixels: per frame the six sums
//   S1 = sum(|Lx| + |Ly|)   LAPM's plane (Lx, Ly: [-1,2,-1] x gauss3, reflect-101)
//   S2 = sum(lap)           LAPV's ksize-3 Laplacian, replicate border
//   S3 = sum(lap^2)
//   S4 = sum(gx^2 + gy^2)   TENG's Sobel gradients at ksize k, reflect-101
//   S5 = sum(x)             GLVN
//   S6 = sum(x^2)
// and from them LAPM = S1/n, LAPV = S3/n - (S2/n)^2, TENG = S4/n and
// GLVN = (S6/n - (S5/n)^2) / max(S5/n, f64::EPSILON), each rounded once to
// float32.  The plain version is ops/sharpness_cuda.sharpness_sums_reference.
//
// Replaces no TPU kernel: the JAX package scores with XLA-level jnp
// (libstacker_tpu/ops/sharpness.py :38-97).  On the card the port ran the
// plain version's eager chain: per metric a padded float32 copy, then a
// multiply and an add a tap and axis, abs, squares and two-pass means,
// ~175 plane passes a frame.
//
// The filtered values are formed in float32 with the plain version's taps
// in its order (ops/filters.sep_filter2d: the W pass, then the H pass; a
// product a non-zero tap, the products summed in order), so they equal its
// planes.  Two identities let the passes be shared, both exact in IEEE
// float32: rounding to nearest is odd-symmetric, and a power-of-two scale
// commutes with rounding while no quarter falls below the normal range
// (|v| < 2^-124, which no u8 / u16 grey and no image-scaled float reaches).
// With hm = W_[-1,2,-1](x), hs = W_[1,2,1](x), A = H_[1,2,1](hm) and
// B = H_[-1,2,-1](hs):
//   Lx = H_gauss3(hm) = A / 4,   Ly = H_[-1,2,-1](W_gauss3(x)) = B / 4,
//   lap = H_[1,2,1](W_[1,-2,1](x)) + H_[1,-2,1](W_[1,2,1](x)) = -(A + B)
// and at ksize 3, gy = H_[-1,0,1](hs).  The squares and the sums are taken
// in float64.  For u8 at ksize 1 and 3 every filtered value is an integer
// or a quarter (|lap| <= 2040, |gx|, |gy| <= 1020) and every square and
// partial sum an exact float64 below 2^53 for frames up to ~2^28 pixels:
// the sums are exact, whatever the order.  There a thread sums its four
// columns of a row in float32, where every such partial is below 2^24 and
// exact too, and widens once a row.  Elsewhere the sums round in their
// last bits, in this kernel's fixed order: two runs are bitwise equal.
//
// What bounds it on the H100.  Reading each pixel once is 265 MB at 32 4K
// u8 frames, 0.079 ms at 3.35 TB/s; 30 float operations a pixel at
// ksize 3 (stackbench/roofline/sharpness.py) are 8.0 G, 0.119 ms at
// 67 T/s.  The operations bound it; in practice the issue rate of ~40
// instructions a pixel.
//
// Design:
// - The interior, rows and columns R .. n-R-1 (R = max(1, ksize / 2)),
//   needs no border index.  A block owns a strip of STRIP columns of one
//   frame over a segment of rows, a thread 4 adjacent columns, and walks
//   down the segment's rows and R rows above and below it.  Each row is
//   copied into a shared-memory stage by cp.async, a 4-pixel quad a thread
//   plus a quad of halo each side, STAGES - 1 rows ahead.  A thread forms
//   the W passes of its 4 columns from the stage and keeps the last rows of
//   them in registers (hm, hs: 3; TENG's two: 2R + 1), then the H passes of
//   the rows they complete: LAPM and LAPV one row back, TENG R rows back,
//   GLVN the row itself.  No plane reaches device memory.
// - The rim, the frame's other pixels, takes blocks of its own: a thread a
//   pixel, every filter summed directly with reflect-101 or replicate
//   indices, the same terms in the same order.
// - Each block reduces its threads' sums in a fixed tree (warp butterflies,
//   then the warps in order) into a [N, blocks, 6] float64 scratch; a
//   second launch, a block a frame, sums a frame's partials in a fixed
//   order and writes the sums and the metrics.  No atomics.
//
// Build with --fmad=false (utils/cuda_build.py): a * b + c stays two
// rounded operations, as the plain version's separate passes evaluate it;
// the explicit fma()s below add products that are exact.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 192;           // a block's threads
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;                // a thread's adjacent columns
constexpr int STRIP = THREADS * COLS;  // a block's columns: 5 strips at 4K
constexpr int E = THREADS + 2;         // quads a staged row, with its halo
constexpr int MIN_ROWS = 32;           // a row segment's least height
constexpr long long TARGET_BLOCKS = 2048;
constexpr double F64_EPS = 2.220446049250313e-16;  // f64::EPSILON

// rows staged, STAGES - 1 of them in flight: ~5-6 KB of loads a block
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 1 ? 8 : sizeof(T) == 2 ? 6 : 4;
}

template <typename T>
struct alignas(COLS * sizeof(T)) Quad {
  T v[COLS];
};

// 1D taps of ops/filters.py: at(i) for i in 0 .. N-1
struct TapsM {  // [-1, 2, -1]
  static constexpr int N = 3;
  __host__ __device__ static constexpr float at(int i) {
    return i == 1 ? 2.f : -1.f;
  }
};
struct TapsG {  // gaussian_kernel(3)
  static constexpr int N = 3;
  __host__ __device__ static constexpr float at(int i) {
    return i == 1 ? 0.5f : 0.25f;
  }
};
struct TapsS {  // deriv_kernel(0, 3)
  static constexpr int N = 3;
  __host__ __device__ static constexpr float at(int i) {
    return i == 1 ? 2.f : 1.f;
  }
};
struct TapsD2 {  // deriv_kernel(2, 3)
  static constexpr int N = 3;
  __host__ __device__ static constexpr float at(int i) {
    return i == 1 ? -2.f : 1.f;
  }
};
// deriv_kernel(1, K): ksize 1 takes ksize 3's
template <int K>
struct D1 {
  static constexpr int N = K == 1 ? 3 : K;
  __host__ __device__ static constexpr float at(int i) {
    return K == 5 ? (i == 0 ? -1.f : i == 1 ? -2.f : i == 2 ? 0.f
                     : i == 3 ? 2.f : 1.f)
         : K == 7 ? (i == 0 ? -1.f : i == 1 ? -4.f : i == 2 ? -5.f
                     : i == 3 ? 0.f : i == 4 ? 5.f : i == 5 ? 4.f : 1.f)
         : (float)(i - 1);
  }
};
// deriv_kernel(0, K): [1] at ksize 1
template <int K>
struct D0 {
  static constexpr int N = K;
  __host__ __device__ static constexpr float at(int i) {
    return K == 1 ? 1.f
         : K == 3 ? TapsS::at(i)
         : K == 5 ? (i == 0 || i == 4 ? 1.f : i == 2 ? 6.f : 4.f)
         : (i == 0 || i == 6 ? 1.f : i == 1 || i == 5 ? 6.f
            : i == 2 || i == 4 ? 15.f : 20.f);
  }
};

// sum of v[i] * TAPS::at(i) over the non-zero taps, in order: the first
// product assigns, each further one adds (filters._correlate_axis)
template <typename TAPS>
__device__ __forceinline__ float tap_sum(const float* v) {
  float a = 0.f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < TAPS::N; ++i) {
    if (TAPS::at(i) == 0.f) continue;
    const float p = v[i] * TAPS::at(i);
    a = first ? p : a + p;
    first = false;
  }
  return a;
}

// OpenCV BORDER_REFLECT_101 / BORDER_REPLICATE of an index within one
// reflection of [0, n)
__device__ __forceinline__ int border(int i, int n, bool replicate) {
  if (replicate) return min(max(i, 0), n - 1);
  i = i < 0 ? -i : i;
  return i < n ? i : 2 * n - 2 - i;
}

// sep_filter2d(f, kx=TX, ky=TY) at pixel (y, x): each non-zero row tap's W
// pass, then their H sum
template <typename TX, typename TY, typename T>
__device__ float sep_at(const T* __restrict__ f, int H, int W, int y, int x,
                        bool replicate) {
  float a = 0.f;
  bool first = true;
#pragma unroll
  for (int b = 0; b < TY::N; ++b) {
    if (TY::at(b) == 0.f) continue;
    const T* row = f + (size_t)border(y - TY::N / 2 + b, H, replicate) * W;
    float v[TX::N];
#pragma unroll
    for (int i = 0; i < TX::N; ++i)
      v[i] = (float)row[border(x - TX::N / 2 + i, W, replicate)];
    const float p = tap_sum<TX>(v) * TY::at(b);
    a = first ? p : a + p;
    first = false;
  }
  return a;
}

// a frame's launch geometry: strips x segments of interior blocks, then
// the rim's blocks
struct Geometry {
  int r, strips, rows, interior;
  long long rim;
  int blocks;
};

Geometry geometry(long long N, int H, int W, int k) {
  Geometry g{};
  g.r = k == 7 ? 3 : k == 5 ? 2 : 1;
  const int hi = H - 2 * g.r, wi = W - 2 * g.r;
  g.strips = (W + STRIP - 1) / STRIP;
  if (hi > 0 && wi > 0) {
    long long segs = (TARGET_BLOCKS + N * g.strips - 1) / (N * g.strips);
    segs = max(1LL, min(segs, (long long)max(1, hi / MIN_ROWS)));
    g.rows = (int)((hi + segs - 1) / segs);
    g.interior = g.strips * ((hi + g.rows - 1) / g.rows);
    g.rim = (long long)H * W - (long long)hi * wi;
  } else {
    g.rows = 0;
    g.interior = 0;
    g.rim = (long long)H * W;
  }
  g.blocks = g.interior + (int)((g.rim + THREADS - 1) / THREADS);
  return g;
}

// the block's six sums, in a fixed order, to out[0..5] (threads 0-5)
__device__ void block_sums(double acc[6], double* __restrict__ out) {
  __shared__ double warp_sums[WARPS][6];
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
  }
  if ((t & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) warp_sums[t >> 5][q] = acc[q];
  }
  __syncthreads();
  if (t < 6) {
    double s = warp_sums[0][t];
    for (int w = 1; w < WARPS; ++w) s += warp_sums[w][t];
    out[t] = s;
  }
}

// columns c..c+3 of a row into a stage quad: a cp.async where they lie in
// the row and rows are aligned, else four clamped loads (the clamped
// columns feed only rim columns, which the interior does not count)
template <typename T>
__device__ __forceinline__ void stage_quad(Quad<T>* q,
                                           const T* __restrict__ row, int c,
                                           int W, bool vec) {
  if (vec && c >= 0 && c + COLS <= W) {
    __pipeline_memcpy_async(q, row + c, sizeof(Quad<T>));
    return;
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) q->v[j] = row[min(max(c + j, 0), W - 1)];
}

template <typename T, int K>
__device__ void interior(const T* __restrict__ f, int H, int W,
                         const Geometry& g, int b, bool vec, double acc[6]) {
  constexpr int R = D1<K>::N / 2;  // TENG's radius, and the rim's width
  constexpr int D = 2 * R + 1;     // TENG's ring of rows
  constexpr int S = stages<T>();
  constexpr bool EXACT = sizeof(T) == 1 && K <= 3;
  __shared__ Quad<T> stage[S][E];
  const int t = threadIdx.x;
  const int x0 = (b % g.strips) * STRIP;
  const int ys = R + (b / g.strips) * g.rows;  // the segment's rows
  const int ye = min(ys + g.rows, H - R);
  const int p0 = ys - R, p1 = ye + R;          // the rows it reads
  const int cx = x0 + COLS * t;
  bool ok[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) ok[j] = cx + j >= R && cx + j < W - R;
  auto issue = [&](int p, int s) {
    const T* row = f + (size_t)p * W;
    stage_quad(&stage[s][t + 1], row, cx, W, vec);
    if (t < 2)
      stage_quad(&stage[s][t == 0 ? 0 : E - 1], row,
                 t == 0 ? x0 - COLS : x0 + STRIP, W, vec);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (p0 + s < p1) issue(p0 + s, s);
    __pipeline_commit();
  }
  // W passes of the last rows, oldest first: hm and hs for LAPM / LAPV;
  // tx (deriv_kernel(1, K)) and ty (deriv_kernel(0, K), centred) for TENG
  // (at K 3, ty is hs)
  float hm[COLS][3] = {}, hs[COLS][3] = {}, tx[COLS][D] = {}, ty[COLS][D] = {};
  for (int p = p0, i = 0; p < p1; ++p, ++i) {
    __pipeline_wait_prior(S - 2);  // this thread's copies of row p
    __syncthreads();               // and every thread's
    if (p + S - 1 < p1) issue(p + S - 1, (i + S - 1) % S);
    __pipeline_commit();
    // columns cx - 4 .. cx + 7
    float win[3 * COLS];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const Quad<T> q = stage[i % S][t + e];
#pragma unroll
      for (int j = 0; j < COLS; ++j) win[COLS * e + j] = (float)q.v[j];
    }
    float part[6] = {};  // EXACT: the row's four columns in float32
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float* w = win + COLS + j;  // w[0]: column cx + j
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        hm[j][d] = hm[j][d + 1];
        hs[j][d] = hs[j][d + 1];
      }
#pragma unroll
      for (int d = 0; d < D - 1; ++d) {
        tx[j][d] = tx[j][d + 1];
        ty[j][d] = ty[j][d + 1];
      }
      hm[j][2] = tap_sum<TapsM>(w - 1);
      if (K != 3) hs[j][2] = tap_sum<TapsS>(w - 1);
      tx[j][D - 1] = tap_sum<D1<K>>(w - R);
      ty[j][D - 1] = tap_sum<D0<K>>(w - D0<K>::N / 2);
      const float* hsj = K == 3 ? ty[j] : hs[j];
      if (!ok[j]) continue;
      if (p >= ys && p < ye) {  // GLVN at row p
        const float x = w[0];
        if (EXACT) {
          part[4] += x;
          part[5] = fmaf(x, x, part[5]);
        } else {
          const double d = x;
          acc[4] += d;
          acc[5] = fma(d, d, acc[5]);
        }
      }
      if (p - 1 >= ys && p - 1 < ye) {  // LAPM and LAPV at row p - 1
        const float a = tap_sum<TapsS>(hm[j]);
        const float c = tap_sum<TapsM>(hsj);
        const float lapm = 0.25f * (fabsf(a) + fabsf(c));
        const float s = a + c;  // -lap
        if (EXACT) {
          part[0] += lapm;
          part[1] -= s;
          part[2] = fmaf(s, s, part[2]);
        } else {
          const double d = s;
          acc[0] += (double)lapm;
          acc[1] -= d;
          acc[2] = fma(d, d, acc[2]);
        }
      }
      if (p - R >= ys && p - R < ye) {  // TENG at row p - R
        const float gx = tap_sum<D0<K>>(tx[j] + R - D0<K>::N / 2);
        const float gy = tap_sum<D1<K>>(ty[j]);
        if (EXACT) {
          part[3] = fmaf(gy, gy, fmaf(gx, gx, part[3]));
        } else {
          const double dx = gx, dy = gy;
          acc[3] += fma(dy, dy, dx * dx);
        }
      }
    }
    if (EXACT) {
#pragma unroll
      for (int q = 0; q < 6; ++q) acc[q] += (double)part[q];
    }
  }
}

template <typename T, int K>
__device__ void rim(const T* __restrict__ f, int H, int W, const Geometry& g,
                    long long i, double acc[6]) {
  if (i >= g.rim) return;
  const int r = g.r;
  int y, x;
  if (g.interior == 0) {
    y = (int)(i / W);
    x = (int)(i % W);
  } else if (i < (long long)r * W) {  // the top rows
    y = (int)(i / W);
    x = (int)(i % W);
  } else if ((i -= (long long)r * W) < (long long)r * W) {  // the bottom
    y = H - r + (int)(i / W);
    x = (int)(i % W);
  } else {  // the side columns of the rows between
    i -= (long long)r * W;
    y = r + (int)(i / (2 * r));
    const int c = (int)(i % (2 * r));
    x = c < r ? c : W - 2 * r + c;
  }
  const float lx = sep_at<TapsM, TapsG>(f, H, W, y, x, false);
  const float ly = sep_at<TapsG, TapsM>(f, H, W, y, x, false);
  const float lapm = fabsf(lx) + fabsf(ly);
  const float lap = sep_at<TapsD2, TapsS>(f, H, W, y, x, true) +
                    sep_at<TapsS, TapsD2>(f, H, W, y, x, true);
  const float gx = sep_at<D1<K>, D0<K>>(f, H, W, y, x, false);
  const float gy = sep_at<D0<K>, D1<K>>(f, H, W, y, x, false);
  const double v = (float)f[(size_t)y * W + x];
  const double l = lap, dx = gx, dy = gy;
  acc[0] += (double)lapm;
  acc[1] += l;
  acc[2] = fma(l, l, acc[2]);
  acc[3] += fma(dy, dy, dx * dx);
  acc[4] += v;
  acc[5] = fma(v, v, acc[5]);
}

// block b of frame n (blockIdx.x = n * blocks + b): an interior strip
// segment or THREADS rim pixels; its six sums to partials[n][b]
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
sharpness_kernel(const T* __restrict__ src, double* __restrict__ partials,
                 int H, int W, Geometry g, bool vec) {
  const long long n = blockIdx.x / g.blocks;
  const int b = (int)(blockIdx.x % g.blocks);
  const T* f = src + (size_t)n * H * W;
  double acc[6] = {};
  if (b < g.interior)
    interior<T, K>(f, H, W, g, b, vec, acc);
  else
    rim<T, K>(f, H, W, g, (long long)(b - g.interior) * THREADS + threadIdx.x,
              acc);
  block_sums(acc, partials + (size_t)blockIdx.x * 6);
}

// a block a frame: the frame's partials summed in a fixed order, then the
// sums [N, 6] and the metrics [4, N] (LAPM, LAPV, TENG, GLVN)
__global__ void __launch_bounds__(THREADS)
sharpness_finalize(const double* __restrict__ partials,
                   double* __restrict__ sums, float* __restrict__ metrics,
                   int N, int blocks, double npx) {
  __shared__ double tot[6];
  const int n = blockIdx.x, t = threadIdx.x;
  const double* p = partials + (size_t)n * blocks * 6;
  double acc[6] = {};
  for (int b = t; b < blocks; b += THREADS) {
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[q] += p[(size_t)b * 6 + q];
  }
  block_sums(acc, tot);
  __syncthreads();
  if (t < 6) sums[(size_t)n * 6 + t] = tot[t];
  if (t == 0) {
    const double lapm = tot[0] / npx;
    const double ml = tot[1] / npx;
    const double lapv = tot[2] / npx - ml * ml;
    const double teng = tot[3] / npx;
    const double mu = tot[4] / npx;
    // torch.clamp(mu, min=eps): a NaN stays NaN
    const double glvn = (tot[5] / npx - mu * mu) / (mu < F64_EPS ? F64_EPS : mu);
    metrics[n] = (float)lapm;
    metrics[N + n] = (float)lapv;
    metrics[2 * N + n] = (float)teng;
    metrics[3 * N + n] = (float)glvn;
  }
}

template <typename T>
cudaError_t launch(const void* src, double* partials, double* sums,
                   float* metrics, int N, int H, int W, int k,
                   cudaStream_t st) {
  const Geometry g = geometry(N, H, W, k);
  const T* s = static_cast<const T*>(src);
  const bool vec = W % COLS == 0 && (uintptr_t)s % sizeof(Quad<T>) == 0;
  const unsigned grid = (unsigned)((long long)N * g.blocks);
  switch (k) {
    case 1:
      sharpness_kernel<T, 1><<<grid, THREADS, 0, st>>>(s, partials, H, W, g, vec);
      break;
    case 3:
      sharpness_kernel<T, 3><<<grid, THREADS, 0, st>>>(s, partials, H, W, g, vec);
      break;
    case 5:
      sharpness_kernel<T, 5><<<grid, THREADS, 0, st>>>(s, partials, H, W, g, vec);
      break;
    default:
      sharpness_kernel<T, 7><<<grid, THREADS, 0, st>>>(s, partials, H, W, g, vec);
      break;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sharpness_finalize<<<N, THREADS, 0, st>>>(partials, sums, metrics, N,
                                            g.blocks, (double)H * W);
  return cudaGetLastError();
}

bool valid(int N, int H, int W, int dtype, int k) {
  const int r = k == 7 ? 3 : k == 5 ? 2 : 1;
  return N > 0 && (k == 1 || k == 3 || k == 5 || k == 7) && dtype >= 0 &&
         dtype <= 2 && H > r && W > r &&
         (long long)N * geometry(N, H, W, k).blocks < (1LL << 31);
}

}  // namespace

extern "C" {

// partials per frame that sharpness_metrics needs: [N, slots, 6] float64;
// 0 where the arguments are refused
int sharpness_slots(int N, int H, int W, int dtype, int k) {
  return valid(N, H, W, dtype, k) ? geometry(N, H, W, k).blocks : 0;
}

// src [N,H,W] of dtype 0 u8, 1 u16, 2 float32, contiguous; partials
// [N, sharpness_slots(...), 6] f64 scratch; sums [N,6] f64; metrics [4,N]
// f32; TENG at ksize k in {1, 3, 5, 7}; requires H and W above the radius
// max(1, k / 2), as the plain version's reflect pad does.  Two launches.
int sharpness_metrics(const void* src, void* partials, void* sums,
                      void* metrics, int N, int H, int W, int dtype, int k,
                      void* stream) {
  if (!valid(N, H, W, dtype, k)) return (int)cudaErrorInvalidValue;
  auto p = static_cast<double*>(partials);
  auto s = static_cast<double*>(sums);
  auto m = static_cast<float*>(metrics);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<uint8_t>(src, p, s, m, N, H, W, k, st);
    case 1: return (int)launch<uint16_t>(src, p, s, m, N, H, W, k, st);
    default: return (int)launch<float>(src, p, s, m, N, H, W, k, st);
  }
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
