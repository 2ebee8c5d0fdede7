// ORB at the candidates and at the kept keypoints of one pyramid level,
// with every window kept on chip:
//
//   B3h  select_keypoints: the Harris response of the 9x9 centre of each
//        candidate's clamped window (-inf where the candidate is
//        invalid), then the level's `quota` best candidates by response,
//        ties to the lower candidate index, with their response, row,
//        column and validity (finite response and a valid candidate);
//   B3d  describe: at each kept keypoint, the intensity-centroid angle,
//        the 7x7 sigma-2 Gaussian blur of its window (VALID) and the 256
//        steered rBRIEF compares, packed LSB-first into 32 bytes.
//
// Replace the Pallas TPU kernel libstacker_tpu/ops/orb_pallas.py
// _extract_kernel (:54; call :111, entry extract_patches_batched :85)
// together with the eager chain that read its patches in ops/orb.py:
// fast.harris_from_patches on the patches' centres, the top-k of the
// responses (libstacker_tpu/ops/orb.py:270-272, jax.lax.top_k), the
// gathers of the kept candidates, _ic_angles_from_patches,
// _blur_patches_valid and _rbrief_from_patches (csrc/orb_extract.cu, the
// one-to-one port of the TPU kernel, wrote [N, 2q, 43, 43] float32
// patches to device memory for that chain: 32 MB at the 4K level 0 of a
// 20-frame burst, then read by some 80 launches a level).  The TPU kernel
// exists to DMA each window into VMEM; on the H100 a window is 1.8 KB of
// shared memory, and nothing derived from it needs to reach device
// memory.
//
// The window of a keypoint (y, x) on an H x W level starts at
// (clamp(y - 21, 0, H - 43), clamp(x - 21, 0, W - 43)), as
// ops/orb_cuda.extract_patches_reference cuts it; Harris reads its rows
// and columns 17..25.
//
// What bounds them on the H100.  At the 4K level 0 of a 20-frame burst
// B3h reads 81 bytes for each of 20 x 218 candidates (~0.4 MB) and does
// ~1k integer operations for each and ~2k compares a frame to rank them;
// B3d reads 1849 bytes for each of 20 x 109 keypoints (~4 MB) and does
// ~41k float operations for each (the blur is most of them), ~0.09 G in
// all: ~1.3 us at 3.35 TB/s and 67 T/s.  Both are below a launch's
// latency: what they save is the launches, and the round trips through
// device memory, of the chain they replace.
//
// Design.  B3h (select_kernel): one block a frame.  Each thread takes
// whole candidates: it stages a candidate's 9x9 block row by row in
// registers, each row's 9 bytes from the three aligned words that hold
// them (a funnel shift; never a word past the row's last block byte), and
// sums Ix^2, Iy^2 and Ix*Iy over its 7x7 positions exactly, in int32
// (|Ix|, |Iy| <= 4 * 255, so each sum is at most 49 * 1020^2 < 2^31),
// then evaluates the response in float32 term by term.  The plain
// version sums the same integers exactly in float64 and casts once, so
// the two agree bitwise (a float32 sum of those products could round,
// 5.1e7 > 2^24, in an order no two libraries share).  The response
// becomes the order-preserving int32 key fast.topk_stable builds (the
// float's bits, negative ones with their magnitude bits flipped: -0.0
// below +0.0, every -inf equal), and key and index one unique 64-bit
// word: key above, the complement of the index below, so a descending
// order is topk_stable's (ties to the lower index).  The block sorts the
// frame's words descending by a bitonic network over the next power of
// two (padding words 0, below every candidate's), and the thread of
// each of the first `quota` slots writes its response (the key's float
// again), row, column and validity.  The words stay in dynamic shared
// memory (8 bytes a candidate, opted in up to SELECT_SHARED_BYTES); a
// level whose words do not fit sorts them in a scratch row of device
// memory that only its own block touches.  The sort's steps of stride
// 16 or less (30 of the 36 at K=218) run in registers, a word a lane,
// by shuffles: a stage of the network loads and stores each word once
// for them, and only its steps of stride 32 or more meet in memory at a
// block barrier.
//
// B3d: one block of 128 threads per keypoint, four barrier-separated
// steps, every result in the plain version's term order, each product
// and sum separately rounded (__fmul_rn / __fadd_rn, which are never
// fused):
//   1. the window into shared memory as float32 rows of 11 float4: a
//      thread takes 4 bytes of a row from the two aligned words that
//      hold them (a funnel shift; never a word past the row's last
//      window byte) and widens them exactly as 2^23 + b less 2^23;
//   2. warp 3 takes the IC moments over the radius-15 circle, a lane a
//      column, as exact integers in float32 (|m10|, |m01| < 2^24, so any
//      order gives the plain version's float32 sums), then the angle,
//      while warps 0-2 blur down the columns (_blur_patches_valid's
//      rows): a thread 4 columns by 5 output rows, each window row read
//      once as a float4 and added to the sums it reaches in tap order;
//   3. every thread blurs along the rows 4 outputs at a time from 12
//      row-blur values, into the window's space;
//   4. each warp's 32 steered rBRIEF compares become one __ballot_sync
//      word of the descriptor, the taps rounded by the 1.5 * 2^23 add.
// atan2f, cosf and sinf are the CUDA math library's, the functions
// PyTorch's CUDA atan2 / cos / sin call.  The rBRIEF pattern and the
// circle's row extents are read from a small device buffer (copied once
// per device by the wrapper): each thread reads its own pattern row,
// which the constant cache would serialise.

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
constexpr int SELECT_THREADS = 512;
constexpr int DESC_THREADS = 128;
constexpr int DESC_WARPS = DESC_THREADS / 32;

struct Gauss7 {
  float k[7];
};

__device__ __forceinline__ int origin(int c, int n) {
  return min(max(c - R, 0), n - SIDE);
}

// The shared memory a select_kernel block may hold its sort words in:
// the H100's opt-in limit for one block (227 KB).  A host build of this
// source sets a smaller one, so that its tests reach the scratch path.
#ifndef SELECT_SHARED_BYTES
#define SELECT_SHARED_BYTES 232448
#endif
#ifndef DYNAMIC_SHARED
#define DYNAMIC_SHARED(T, name) extern __shared__ T name[]
#endif

// The 9 bytes of a block row at p, from the three aligned words that hold
// them (read-only loads): bytes o..o+8 of words w0 w1 w2, o = p & 3, each
// byte zero-extended by one byte permute
__device__ __forceinline__ void block_row(const uint8_t* p, int b[HB]) {
  const int o = (int)(reinterpret_cast<uintptr_t>(p) & 3);
  const unsigned* w = reinterpret_cast<const unsigned*>(p - o);
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
  const int s = 8 * o;
  const uint32_t lo = (uint32_t)((((uint64_t)w1 << 32) | w0) >> s);
  const uint32_t hi = (uint32_t)((((uint64_t)w2 << 32) | w1) >> s);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = (int)__byte_perm(lo, 0u, 0x4440u | j);
    b[4 + j] = (int)__byte_perm(hi, 0u, 0x4440u | j);
  }
  b[8] = (int)__byte_perm(w2, 0u, 0x4440u | o);
}

// The Harris response of the 9x9 block at src (row pitch W), as
// fast.harris_from_patches takes it: dx along a row, dy along a column,
// the Sobel sums 2 * d[1] + d[0] + d[2], exact int32 block sums over the
// 7x7 positions, then (a * b - c * c - k * (a + b) ** 2) * scale4 rounded
// term by term.  Three rows at a time in registers.
__device__ __forceinline__ float harris_at(const uint8_t* src, int W,
                                           float harris_k, float scale4) {
  int p0[HB], p1[HB], p2[HB];
  int dx0[7], dx1[7];
  block_row(src, p0);
  block_row(src + W, p1);
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    dx0[q] = p0[q + 2] - p0[q];
    dx1[q] = p1[q + 2] - p1[q];
  }
  int a = 0, b = 0, c = 0;
#pragma unroll
  for (int r = 2; r < HB; ++r) {
    block_row(src + r * W, p2);
    int dy[HB];
#pragma unroll
    for (int j = 0; j < HB; ++j) dy[j] = p2[j] - p0[j];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const int dx2 = p2[q + 2] - p2[q];
      const int ix = 2 * dx1[q] + dx0[q] + dx2;
      const int iy = 2 * dy[q + 1] + dy[q] + dy[q + 2];
      a += ix * ix;
      b += iy * iy;
      c += ix * iy;
      dx0[q] = dx1[q];
      dx1[q] = dx2;
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      p0[j] = p1[j];
      p1[j] = p2[j];
    }
  }
  const float af = (float)a, bf = (float)b, cf = (float)c;
  const float det = __fsub_rn(__fmul_rn(af, bf), __fmul_rn(cf, cf));
  const float tr = __fadd_rn(af, bf);
  const float r = __fsub_rn(det, __fmul_rn(harris_k, __fmul_rn(tr, tr)));
  return __fmul_rn(r, scale4);
}

// fast.topk_stable's order-preserving int32 key of a float, offset by
// 2^31 so that it orders as an unsigned word; and back
__device__ __forceinline__ uint32_t order_key(float v) {
  const int bits = __float_as_int(v);
  return (uint32_t)(bits >= 0 ? bits : bits ^ 0x7FFFFFFF) ^ 0x80000000u;
}
__device__ __forceinline__ float from_order_key(uint32_t u) {
  const int key = (int)(u ^ 0x80000000u);
  return __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
}

// B3h: see the header.  Block n takes frame n's K candidates; n2 is the
// power of two the words are sorted over (32 at least); SCRATCH: they
// are sorted in scratch [N, n2], else in shared memory (an instance
// each, so that each addresses its own space).
template <bool SCRATCH>
__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ ys,
              const int* __restrict__ xs, const uint8_t* __restrict__ valid,
              uint64_t* __restrict__ scratch, float* __restrict__ hval,
              int* __restrict__ kys, int* __restrict__ kxs,
              uint8_t* __restrict__ kvalid, int K, int Q, int H, int W,
              int n2, float harris_k, float scale4) {
  DYNAMIC_SHARED(uint64_t, shared_words);
  const int n = blockIdx.x, tid = threadIdx.x;
  uint64_t* words = SCRATCH ? scratch + (size_t)n * n2 : shared_words;
  const size_t base = (size_t)n * K;
  const uint8_t* img = imgs + (size_t)n * H * W;
  for (int i = tid; i < n2; i += SELECT_THREADS) {
    uint64_t word = 0;  // padding: below every candidate's word
    if (i < K) {
      float r = -INFINITY;
      if (valid[base + i]) {
        const int y0 = origin(ys[base + i], H) + HO;
        const int x0 = origin(xs[base + i], W) + HO;
        r = harris_at(img + (size_t)y0 * W + x0, W, harris_k, scale4);
      }
      word = (uint64_t)order_key(r) << 32 | (uint32_t)~(uint32_t)i;
    }
    words[i] = word;
  }
  __syncthreads();
  // bitonic sort, descending.  Stage k's steps of stride j >= 32 pair
  // words of different warps' 32-word chunks: pair t compares lo, lo + j
  // in memory, a block barrier after each.  Its steps of stride 16..1
  // pair words of one chunk: a warp takes each of its chunks into its
  // lanes, exchanges them by shuffles, and stores them once.
  for (int k = 2; k <= n2; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32; j >>= 1) {
      for (int t = tid; t < n2 >> 1; t += SELECT_THREADS) {
        const int lo = 2 * t - (t & (j - 1)), hi = lo + j;
        const uint64_t a = words[lo], b = words[hi];
        if ((lo & k) == 0 ? a < b : a > b) {
          words[lo] = b;
          words[hi] = a;
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < n2; e += SELECT_THREADS) {
      uint64_t w = words[e];
      for (int jj = j; jj > 0; jj >>= 1) {
        const uint64_t o = __shfl_xor_sync(0xffffffffu, w, jj);
        // the lower word of a pair keeps the larger in a descending run
        const bool larger = ((e & k) == 0) == ((e & jj) == 0);
        w = larger == (o > w) ? o : w;
      }
      words[e] = w;
    }
    __syncthreads();
  }
  for (int r = tid; r < Q; r += SELECT_THREADS) {
    const uint64_t word = words[r];
    const size_t i = base + ~(uint32_t)word;
    const float h = from_order_key((uint32_t)(word >> 32));
    const size_t o = (size_t)n * Q + r;
    hval[o] = h;
    kys[o] = ys[i];
    kxs[o] = xs[i];
    kvalid[o] = (__float_as_uint(h) & 0x7F800000u) != 0x7F800000u && valid[i];
  }
}

// B3d's shared layout: the window as float32 rows of WORDS float4 (its
// 43 columns and one spare), and VR output rows a row-blur task
constexpr int WORDS = 11;
constexpr int VR = 5;
constexpr int VTASKS = WORDS * ((PS + VR - 1) / VR);  // 88, warps 0-2
constexpr int WIN_ROWS = (PS + VR - 1) / VR * VR + 6;  // the last task's rows
constexpr int BQ = 10;  // float4 a blurred row (37 columns and 3 spare)
constexpr int MOMENT_WARP = DESC_WARPS - 1;
static_assert(VTASKS <= 32 * MOMENT_WARP, "row blur on the other warps");

__device__ __forceinline__ float warp_sumf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte j of w as a float, exactly: 2^23 + b less 2^23
__device__ __forceinline__ float byte_f(uint32_t w, int j) {
  return __uint_as_float(0x4B000000u | ((w >> (8 * j)) & 0xFFu)) - 8388608.0f;
}

// rint(t) as an int for |t| < 2^22: t + 1.5 * 2^23 rounds to the nearest
// integer (ties to even) and holds it in its low bits
__device__ __forceinline__ int rint_int(float t) {
  return __float_as_int(__fadd_rn(t, 12582912.0f)) - 0x4B400000;
}

__device__ __forceinline__ float4 scale4(float k, float4 w) {
  return make_float4(__fmul_rn(k, w.x), __fmul_rn(k, w.y), __fmul_rn(k, w.z),
                     __fmul_rn(k, w.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(DESC_THREADS)
describe_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ ys,
                const int* __restrict__ xs, const int* __restrict__ consts,
                float* __restrict__ angle, uint32_t* __restrict__ desc,
                int Q, int H, int W, Gauss7 g, float rad2deg, float deg2rad) {
  // the window, then (after the row blur) the blurred patch
  __shared__ float4 win[WIN_ROWS * WORDS];
  // the row blur; one spare float4 for the last column task's reads
  __shared__ float4 rows[PS * WORDS + 1];
  __shared__ int umax[HALF + 1];
  __shared__ float rot[2];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int i = blockIdx.x;
  const int n = i / Q;
  const int y0 = origin(ys[i], H), x0 = origin(xs[i], W);
  const uint8_t* src = imgs + (size_t)n * H * W + (size_t)y0 * W + x0;

  // the window: each thread makes 4 bytes of a row from the two aligned
  // words that hold them (never a word past the row's last window byte)
#pragma unroll
  for (int it = 0; it < (SIDE * WORDS + DESC_THREADS - 1) / DESC_THREADS;
       ++it) {
    const int j = tid + it * DESC_THREADS;
    if (j >= SIDE * WORDS) break;
    const int r = j / WORDS, k = j - r * WORDS;
    const uint8_t* row = src + (size_t)r * W;
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + 4 * k);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    const uint32_t* last = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<uintptr_t>(row + SIDE - 1) & ~(uintptr_t)3);
    const uint32_t lo = w[0], hi = w < last ? w[1] : lo;
    const uint32_t v = (uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * (a & 3)));
    win[j] = make_float4(byte_f(v, 0), byte_f(v, 1), byte_f(v, 2),
                         byte_f(v, 3));
  }
  if (tid <= HALF) umax[tid] = consts[256 + tid];
  __syncthreads();

  const float* wf = reinterpret_cast<const float*>(win);
  if (wid == MOMENT_WARP) {
    // intensity-centroid moments over the radius-15 circle, lane u + 15
    // on column u: exact integers in float32 (|m10|, |m01| < 2^24), so
    // any order gives the plain version's float32 sums; then the angle
    const int u = lane - HALF;
    float col = 0.0f, m01 = 0.0f;
#pragma unroll
    for (int v = -HALF; v <= HALF; ++v) {
      const float p = wf[(R + v) * 4 * WORDS + R + u];
      if (abs(u) <= umax[v < 0 ? -v : v]) {
        col = col + p;
        m01 = m01 + (float)v * p;
      }
    }
    const float m10 = warp_sumf((float)u * col);
    m01 = warp_sumf(m01);
    // atan2(m01, m10) * (180 / pi), + 360 where negative
    float a = __fmul_rn(atan2f(m01, m10), rad2deg);
    if (a < 0.0f) a = __fadd_rn(a, 360.0f);
    if (lane == 0) {
      angle[i] = a;
      const float rad = __fmul_rn(a, deg2rad);
      rot[0] = cosf(rad);
      rot[1] = sinf(rad);
    }
  } else if (tid < VTASKS) {
    // _blur_patches_valid's rows (down a column): 4 columns by VR output
    // rows, each window row read once and added to the sums it reaches
    // in tap order
    const int q = tid % WORDS, r0 = tid / WORDS * VR;
    float4 acc[VR];
#pragma unroll
    for (int j = 0; j < VR + 6; ++j) {
      const float4 w = win[(r0 + j) * WORDS + q];
#pragma unroll
      for (int o = 0; o < VR; ++o) {
        const int t = j - o;
        if (t == 0) acc[o] = scale4(g.k[0], w);
        else if (t > 0 && t < 7) acc[o] = add4(acc[o], scale4(g.k[t], w));
      }
    }
#pragma unroll
    for (int o = 0; o < VR; ++o)
      if (r0 + o < PS) rows[(r0 + o) * WORDS + q] = acc[o];
  }
  __syncthreads();

  // the columns: 4 outputs of a row from 12 row-blur values, terms added
  // in tap order, into the window's space (BQ float4 a row)
  float4* blur = win;
#pragma unroll
  for (int it = 0; it < (PS * BQ + DESC_THREADS - 1) / DESC_THREADS; ++it) {
    const int j = tid + it * DESC_THREADS;
    if (j >= PS * BQ) break;
    const int r = j / BQ, q = j - r * BQ;
    const float4* s = rows + r * WORDS + q;
    const float4 a = s[0], b = s[1], c = s[2];
    const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
    float o[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      o[x] = __fmul_rn(g.k[0], v[x]);
#pragma unroll
      for (int t = 1; t < 7; ++t) o[x] = __fadd_rn(o[x], __fmul_rn(g.k[t], v[x + t]));
    }
    blur[j] = make_float4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  // steered rBRIEF: taps rint(x cos - y sin), rint(x sin + y cos)
  const float* bf = reinterpret_cast<const float*>(blur);
  const float ca = rot[0], sa = rot[1];
  const char4* pattern = reinterpret_cast<const char4*>(consts);
#pragma unroll
  for (int it = 0; it < 256 / DESC_THREADS; ++it) {
    const int b = tid + it * DESC_THREADS;
    const char4 pt = pattern[b];
    const float x1 = pt.x, y1 = pt.y, x2 = pt.z, y2 = pt.w;
    const int rx1 = rint_int(__fsub_rn(__fmul_rn(x1, ca), __fmul_rn(y1, sa))) + PR;
    const int ry1 = rint_int(__fadd_rn(__fmul_rn(x1, sa), __fmul_rn(y1, ca))) + PR;
    const int rx2 = rint_int(__fsub_rn(__fmul_rn(x2, ca), __fmul_rn(y2, sa))) + PR;
    const int ry2 = rint_int(__fadd_rn(__fmul_rn(x2, sa), __fmul_rn(y2, ca))) + PR;
    const bool bit = bf[ry1 * 4 * BQ + rx1] < bf[ry2 * 4 * BQ + rx2];
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) desc[(size_t)i * 8 + (b >> 5)] = word;
  }
}

}  // namespace

extern "C" {

// The sort words a select_keypoints block keeps in shared memory; a
// level of more candidates (rounded up to a power of two) needs scratch.
int select_shared_words() { return SELECT_SHARED_BYTES / 8; }

// imgs [N,H,W] u8, ys/xs [N,K] i32, valid [N,K] u8 (bool), scratch
// [N,n2] 8-byte words (n2 the power of two at or above K and 32) where n2 >
// select_shared_words(), else null; hval [N,Q] f32, kys/kxs [N,Q] i32,
// kvalid [N,Q] u8 (bool); requires 1 <= Q <= K and H, W >= 43.
int select_keypoints(const void* imgs, const void* ys, const void* xs,
                     const void* valid, void* scratch, void* hval, void* kys,
                     void* kxs, void* kvalid, int N, int K, int Q, int H,
                     int W, float harris_k, float scale4, void* stream) {
  if (N <= 0 || K <= 0 || Q <= 0 || Q > K || K > (1 << 30) || H < SIDE ||
      W < SIDE)
    return (int)cudaErrorInvalidValue;
  int n2 = 32;  // a warp's chunk at least
  while (n2 < K) n2 <<= 1;
  const bool shared = n2 <= select_shared_words();
  if (!shared && !scratch) return (int)cudaErrorInvalidValue;
  const auto im = static_cast<const uint8_t*>(imgs);
  const auto y = static_cast<const int*>(ys);
  const auto x = static_cast<const int*>(xs);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto hv = static_cast<float*>(hval);
  const auto ky = static_cast<int*>(kys);
  const auto kx = static_cast<int*>(kxs);
  const auto kv = static_cast<uint8_t*>(kvalid);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!shared) {
    select_kernel<true><<<(unsigned)N, SELECT_THREADS, 0, st>>>(
        im, y, x, v, static_cast<uint64_t*>(scratch), hv, ky, kx, kv, K, Q,
        H, W, n2, harris_k, scale4);
    return (int)cudaGetLastError();
  }
  const int bytes = n2 * 8;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  select_kernel<false><<<(unsigned)N, SELECT_THREADS, bytes, st>>>(
      im, y, x, v, nullptr, hv, ky, kx, kv, K, Q, H, W, n2, harris_k, scale4);
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
