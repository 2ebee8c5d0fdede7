// The ECC solve's Gaussian pre-filter: OpenCV GaussianBlur(ksize, sigma 0,
// BORDER_REFLECT_101) of [N, H, W] float32 planes, bitwise equal to the
// plain version ops/filters.gaussian_blur.
//
// Replaces no TPU kernel: the JAX package blurs with XLA-level jnp
// (libstacker_tpu/ops/ecc.py _input_fields :236 and the solve's template
// prep).  On the card the port ran the plain version's eager chain: a
// reflect-101 padded copy, then per axis ksize multiplies and ksize - 1
// in-place adds, each a full pass over every lane (~110 GB of traffic for
// 99 lanes of 2160x3840 at ksize 5).
//
// The plain version's arithmetic, kept term for term: the W axis first,
// then the H axis; each tap fl32(x * c), c the float32 tap; the taps
// summed in order, each add rounded to float32.  A Gaussian's taps are
// all positive, so the plain version skips none.  Rows -r..-1 and
// H..H+r-1 of the H pass are reflect-101 copies, whose W-filtered values
// are those of their source rows: each source row is filtered once and
// its index reflected.
//
// What bounds it on the H100.  A (2r+1)-tap separable stencil does 4r+2
// multiplies and 4r adds a pixel, far below the ridge.  The bound is
// reading each input pixel once and writing each output once, 8 B a
// pixel: 6.57 GB, 1.96 ms at 3.35 TB/s, for 99 lanes of 2160x3840.
//
// Design, for r <= MAX_R (ksize <= 17):
// - A block owns one lane's strip of 960 columns over a segment of rows,
//   a thread 4 adjacent columns.  The block walks down its rows.  Each
//   source row is read once into a shared-memory stage: a 16-byte copy a
//   thread where W % 4 == 0, plus the strip's r-column halo on each side,
//   copied by a few threads and reflected at the frame's edges.  Each
//   thread filters its 4 columns along W from the stage and keeps the
//   last 2r+1 W-filtered rows in registers; from the segment's first row
//   on it filters them along H and writes its 4 outputs (one 16-byte
//   store).  No padded copy and no intermediate plane reach device
//   memory.
// - The stage has STAGES rows: a row is copied with cp.async
//   (__pipeline_memcpy_async) STAGES - 1 rows ahead of the one being
//   filtered, so each block keeps ~11 KB of loads in flight without
//   holding them in registers; one barrier a row.
// - 960 columns, a quarter of a 4K row and half of its octave's: each
//   staged row is 3.8 KB of contiguous reads.  Strips of 256 and 512
//   columns ran 5 % and 3 % slower at 99 4K lanes, 1024 and 1280 the
//   same (PERF.md section 6).
// - Row segments of at least MIN_ROWS rows, as many as give about
//   TARGET_BLOCKS blocks: 99 lanes x 4 strips x 6 segments at 4K (2r
//   extra rows a segment, ~1 %), 31 x 4 x 17, 1 x 4 x 66.
// Above MAX_R a direct form serves: a thread an output pixel, summing
// each of its 2r+1 rows along W, then the rows along H, the same terms in
// the same order, with (2r+1)^2 loads a pixel through the cache.
//
// Build with --fmad=false (utils/cuda_build.py): x * c + acc stays two
// rounded operations, as the plain version's separate multiply and add
// passes evaluate it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 240;           // a block's threads
constexpr int COLS = 4;                // a thread's adjacent columns
constexpr int STRIP = THREADS * COLS;  // a block's columns
constexpr int STAGES = 4;              // rows staged, STAGES - 1 in flight
constexpr int MAX_R = 8;               // the staged form's largest radius
constexpr int MIN_ROWS = 32;           // a row segment's least height
constexpr long long TARGET_BLOCKS = 2048;
constexpr int DIRECT_THREADS = 256;

// OpenCV BORDER_REFLECT_101 of an index within one reflection of [0, n);
// clamped, so that columns past W - 1 + r, which no output reads, stay
// inside the row.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i < n ? i : 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// Columns c..c+3 of a row into a stage slot: one 16-byte copy where they
// lie in the row and rows are 16-byte aligned, else four reflected
// 4-byte copies.
__device__ __forceinline__ void stage_cols(float4* slot,
                                           const float* __restrict__ row,
                                           int c, int W, bool vec) {
  if (vec && c >= 0 && c + COLS <= W) {
    __pipeline_memcpy_async(slot, row + c, sizeof(float4));
    return;
  }
  float* f = reinterpret_cast<float*>(slot);
  for (int j = 0; j < COLS; ++j)
    __pipeline_memcpy_async(f + j, row + reflect101(c + j, W), sizeof(float));
}

__device__ __forceinline__ float& lane(float4& v, int j) {
  return reinterpret_cast<float*>(&v)[j];
}

template <int R>
__global__ void __launch_bounds__(THREADS)
blur_kernel(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ taps, int H, int W, int strips,
            int rows, bool vec) {
  constexpr int K = (R + COLS - 1) / COLS;  // halo elements a side
  constexpr int T = 2 * R + 1;
  constexpr int E = THREADS + 2 * K;        // elements a staged row
  __shared__ float4 stage[STAGES][E];
  const int t = threadIdx.x;
  const int x0 = (blockIdx.x % strips) * STRIP;
  const int y0 = (blockIdx.x / strips) * rows;
  const int y1 = min(y0 + rows, H);
  const size_t plane = (size_t)blockIdx.y * H * W;
  float c[T];
#pragma unroll
  for (int k = 0; k < T; ++k) c[k] = __ldg(taps + k);
  // the thread's own columns (element K + t of a staged row) and, for the
  // first 2K threads, one halo element: left of the strip for t < K,
  // right of it for K <= t < 2K
  const int cx = x0 + COLS * t;
  const bool halo = t < 2 * K;
  const int hx = t < K ? x0 - COLS * (K - t) : x0 + STRIP + COLS * (t - K);
  const int he = t < K ? t : THREADS + t;
  const int p0 = y0 - R, p1 = y1 + R;  // padded rows the segment reads
  auto issue = [&](int p, int s) {
    const float* row = src + plane + (size_t)reflect101(p, H) * W;
    stage_cols(&stage[s][K + t], row, cx, W, vec);
    if (halo) stage_cols(&stage[s][he], row, hx, W, vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (p0 + s < p1) issue(p0 + s, s);
    __pipeline_commit();
  }
  float4 ring[T] = {};  // W-filtered padded rows p - 2R .. p
  float* out = dst + plane;
  for (int p = p0, i = 0; p < p1; ++p, ++i) {
    __pipeline_wait_prior(STAGES - 2);  // this thread's copies of row p
    __syncthreads();                    // and every thread's
    // the slot refilled here was read in the previous row, before the
    // barrier
    if (p + STAGES - 1 < p1) issue(p + STAGES - 1, (i + STAGES - 1) % STAGES);
    __pipeline_commit();
    // the window: columns cx - 4K .. cx + 4K + 3
    const float4* st = stage[i % STAGES] + t;
    float win[COLS * (2 * K + 1)];
#pragma unroll
    for (int e = 0; e <= 2 * K; ++e) {
      float4 v = st[e];
#pragma unroll
      for (int j = 0; j < COLS; ++j) win[COLS * e + j] = lane(v, j);
    }
#pragma unroll
    for (int k = 0; k < T - 1; ++k) ring[k] = ring[k + 1];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float* w = win + COLS * K - R + j;
      float a = w[0] * c[0];
#pragma unroll
      for (int k = 1; k < T; ++k) a = a + w[k] * c[k];
      lane(ring[T - 1], j) = a;
    }
    const int y = p - R;  // rows y - R .. y + R are in the ring
    if (y < y0) continue;
    float4 o;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float a = lane(ring[0], j) * c[0];
#pragma unroll
      for (int k = 1; k < T; ++k) a = a + lane(ring[k], j) * c[k];
      lane(o, j) = a;
    }
    float* orow = out + (size_t)y * W;
    if (vec && cx + COLS <= W) {
      *reinterpret_cast<float4*>(orow + cx) = o;
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (cx + j < W) orow[cx + j] = lane(o, j);
    }
  }
}

__global__ void __launch_bounds__(DIRECT_THREADS)
blur_direct_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   const float* __restrict__ taps, int H, int W, int r) {
  const long long i = (long long)blockIdx.x * DIRECT_THREADS + threadIdx.x;
  if (i >= (long long)H * W) return;
  const int y = (int)(i / W), x = (int)(i % W);
  const size_t plane = (size_t)blockIdx.y * H * W;
  float acc = 0.0f;
  for (int ky = 0; ky <= 2 * r; ++ky) {
    const float* row = src + plane + (size_t)reflect101(y - r + ky, H) * W;
    float s = __ldg(row + reflect101(x - r, W)) * __ldg(taps);
    for (int kx = 1; kx <= 2 * r; ++kx)
      s = s + __ldg(row + reflect101(x - r + kx, W)) * __ldg(taps + kx);
    acc = ky == 0 ? s * __ldg(taps) : acc + s * __ldg(taps + ky);
  }
  dst[plane + i] = acc;
}

template <int R>
cudaError_t launch(const float* s, float* d, const float* c, int N, int H,
                   int W, cudaStream_t st) {
  const int strips = (W + STRIP - 1) / STRIP;
  const long long lanes_strips = (long long)N * strips;
  long long segs = (TARGET_BLOCKS + lanes_strips - 1) / lanes_strips;
  segs = max(1LL, min(segs, (long long)(H / MIN_ROWS)));
  const int rows = (int)((H + segs - 1) / segs);
  segs = (H + rows - 1) / rows;
  const bool vec = W % COLS == 0 &&
                   ((uintptr_t)s % sizeof(float4) == 0) &&
                   ((uintptr_t)d % sizeof(float4) == 0);
  const unsigned blocks = (unsigned)(strips * segs);
  blur_kernel<R><<<dim3(blocks, N), THREADS, 0, st>>>(s, d, c, H, W, strips,
                                                      rows, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src, dst [N,H,W] f32, taps [2r+1] f32 on the device (the Gaussian's,
// all positive); requires r < H and r < W, as a reflect-101 pad does.
int gaussian_prefilter(const void* src, void* dst, const void* taps, int N,
                       int H, int W, int r, void* stream) {
  if (N <= 0 || N > 65535 || r < 0 || H <= r || W <= r)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto d = static_cast<float*>(dst);
  auto c = static_cast<const float*>(taps);
  auto st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 0: return (int)launch<0>(s, d, c, N, H, W, st);
    case 1: return (int)launch<1>(s, d, c, N, H, W, st);
    case 2: return (int)launch<2>(s, d, c, N, H, W, st);
    case 3: return (int)launch<3>(s, d, c, N, H, W, st);
    case 4: return (int)launch<4>(s, d, c, N, H, W, st);
    case 5: return (int)launch<5>(s, d, c, N, H, W, st);
    case 6: return (int)launch<6>(s, d, c, N, H, W, st);
    case 7: return (int)launch<7>(s, d, c, N, H, W, st);
    case 8: return (int)launch<8>(s, d, c, N, H, W, st);
    default: break;
  }
  const long long px = (long long)H * W;
  const unsigned blocks = (unsigned)((px + DIRECT_THREADS - 1) /
                                     DIRECT_THREADS);
  blur_direct_kernel<<<dim3(blocks, N), DIRECT_THREADS, 0, st>>>(s, d, c, H,
                                                                 W, r);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
