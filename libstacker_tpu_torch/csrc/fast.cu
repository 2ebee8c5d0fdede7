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
// ~0.83 GB for 20 frames of 4K, ~0.25 ms at 3.35 TB/s.  The arithmetic is
// integer: the compass pre-test and the NMS for every pixel, the two arc
// trees for the ~40 % of pixels of textured content that pass the
// compass test.
//
// Design: one block per 128x16 output tile of one frame.
// - The tile plus a 4-pixel halo (3 for the circle, 1 for the NMS ring),
//   136x24, is staged in shared memory in groups of 4 pixels: one
//   4-byte (u8) or 16-byte (f32) load where the row stride and the base
//   allow it and the group lies inside the image, else 4 edge-clamped
//   loads (the values of clamped pixels never reach a kept score).  A u8
//   pixel p is staged as the s16x2 pair (p, -p).
// - Compaction: every thread runs the exact compass pre-test (an arc of
//   9 contains at least 2 of the circle pixels 0, 4, 8, 12) over the
//   tile and its 1-pixel ring; the pixels that pass are pushed to a
//   shared-memory queue (warp ballot, popc prefix, one shared counter),
//   and the arc trees run on the queue with every lane busy.  The other
//   pixels score 0.
// - Both trees in one register (u8): the minimum of a window of 9 and
//   the maximum over the 16 windows commute with subtracting the centre,
//   so one tree over the (p, -p) pairs gives max_i min_arc(p) and
//   max_i min_arc(-p) at once, and the bright and dark strengths are
//   those minus and plus the centre.  The tree is Hopper's DPX three-way
//   s16x2 min/max (__vimin3_s16x2, __vimax3_s16x2): windows of 3, then
//   of 9, then the max of 16, 40 packed operations for both signs.
//   Float sources take the float tree on e and -e.
// - The scores of the tile and its ring stay in shared memory, and the
//   NMS reads them from there with a sliding 3x3 window down each
//   column: the score map never makes a round trip through device memory.
// The TPU kernel's (8,128)-aligned windows, _PAD_T_U8 and bf16 tree
// existed for the TPU's DMA and vector units and have no counterpart
// here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;
constexpr int TH = 16;  // 128x32 stages fewer halo pixels (1.33 a
                        // pixel against 1.59) but measured slower
constexpr int HALO = 4;
constexpr int WW = TW + 2 * HALO;  // staged window
constexpr int WH = TH + 2 * HALO;
constexpr int GROUPS = WW / 4;  // 4-pixel groups of a window row
constexpr int EW = TW + 2;  // score region: tile + 1-px ring
constexpr int EH = TH + 2;
constexpr int NS = EW * EH;
constexpr int THREADS = 256;
constexpr int NMS_ROWS = TH / (THREADS / TW);  // tile rows per NMS thread

static_assert(WW % 4 == 0 && NS < 65536, "window groups, u16 queue");

// the 16 circle offsets, clockwise from (0, -3); dy(k) = dx(k + 12)
__host__ __device__ constexpr int circle_dx(int k) {
  return k <= 3 ? k : k <= 5 ? 3 : k <= 11 ? 8 - k : k <= 13 ? -3 : k - 16;
}
__host__ __device__ constexpr int circle_dy(int k) {
  return circle_dx((k + 12) & 15);
}

// How a source pixel is staged: u8 as the s16x2 pair (p, -p), f32 as is.
template <typename T> struct Stage;
template <> struct Stage<uint8_t> {
  typedef uint32_t S;
  typedef uchar4 V4;
  typedef uint4 S4;
  typedef int A;  // exact differences
  __device__ static S of(uint8_t p) { return (uint32_t)p * 0xFFFF0001u; }
  __device__ static A value(S s) { return (A)(s & 0xFFFFu); }
  __device__ static S4 of4(V4 v) {
    return make_uint4(of(v.x), of(v.y), of(v.z), of(v.w));
  }
};
template <> struct Stage<float> {
  typedef float S;
  typedef float4 V4;
  typedef float4 S4;
  typedef float A;
  __device__ static S of(float p) { return p; }
  __device__ static A value(S s) { return s; }
  __device__ static S4 of4(V4 v) { return v; }
};

// Bright and dark arc strengths of the pixel at w0 from its (p, -p)
// circle pairs: windows of 3, windows of 9, max of the 16 windows.
__device__ __forceinline__ float corner_score(const uint32_t* w0, int t) {
  uint32_t v[16], w3[16], w9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = w0[circle_dy(k) * WW + circle_dx(k)];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    w3[i] = __vimin3_s16x2(v[i], v[(i + 1) & 15], v[(i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    w9[i] = __vimin3_s16x2(w3[i], w3[(i + 3) & 15], w3[(i + 6) & 15]);
  }
  const uint32_t m0 = __vimax3_s16x2(w9[0], w9[1], w9[2]);
  const uint32_t m1 = __vimax3_s16x2(w9[3], w9[4], w9[5]);
  const uint32_t m2 = __vimax3_s16x2(w9[6], w9[7], w9[8]);
  const uint32_t m3 = __vimax3_s16x2(w9[9], w9[10], w9[11]);
  const uint32_t m4 = __vimax3_s16x2(w9[12], w9[13], w9[14]);
  const uint32_t best = __vmaxs2(__vimax3_s16x2(m0, m1, m2),
                                 __vimax3_s16x2(m3, m4, w9[15]));
  const int ctr = (int)(w0[0] & 0xFFFFu);
  const int tb = (int)(int16_t)(best & 0xFFFFu) - ctr;
  const int td = (int)(int16_t)(best >> 16) + ctr;
  return (tb > t || td > t) ? (float)max(tb, td) - 1.0f : 0.0f;
}

// max over the 16 circular windows of length 9 of the window minimum
// (the log-doubling tree of ops/fast.py; min and max are exact)
__device__ __forceinline__ float arc_strength(const float (&v)[16]) {
  float w2[16], w4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w2[i] = fminf(v[i], v[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) w4[i] = fminf(w2[i], w2[(i + 2) & 15]);
  float best = fminf(fminf(w4[0], w4[4]), v[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    best = fmaxf(best, fminf(fminf(w4[i], w4[(i + 4) & 15]), v[(i + 8) & 15]));
  }
  return best;
}

__device__ __forceinline__ float corner_score(const float* w0, float t) {
  const float ctr = w0[0];
  float e[16], ne[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    e[k] = w0[circle_dy(k) * WW + circle_dx(k)] - ctr;
    ne[k] = -e[k];
  }
  const float tb = arc_strength(e);
  const float td = arc_strength(ne);
  return (tb > t || td > t) ? fmaxf(tb, td) - 1.0f : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fast_kernel(const T* __restrict__ imgs, float* __restrict__ out, int H, int W,
            float threshold, int border, int vec) {
  typedef Stage<T> St;
  typedef typename St::S S;
  typedef typename St::A A;
  __shared__ __align__(16) S win[WH][WW];
  __shared__ float sc[EH][EW];
  __shared__ uint16_t queue[NS];
  __shared__ int queued;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const T* img = imgs + (size_t)n * H * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) queued = 0;
  for (int i = tid; i < WH * GROUPS; i += THREADS) {
    const int r = i / GROUPS, g = i - r * GROUPS;
    const int gy = min(max(ty0 - HALO + r, 0), H - 1);
    const int gx = tx0 - HALO + 4 * g;
    const T* row = img + (size_t)gy * W;
    typename St::S4 s4;
    if (vec && gx >= 0 && gx + 3 < W) {
      s4 = St::of4(__ldg(reinterpret_cast<const typename St::V4*>(row + gx)));
    } else {
      s4.x = St::of(row[min(max(gx, 0), W - 1)]);
      s4.y = St::of(row[min(max(gx + 1, 0), W - 1)]);
      s4.z = St::of(row[min(max(gx + 2, 0), W - 1)]);
      s4.w = St::of(row[min(max(gx + 3, 0), W - 1)]);
    }
    *reinterpret_cast<typename St::S4*>(&win[r][4 * g]) = s4;
  }
  __syncthreads();

  // compass pre-test over the tile and its ring; candidates to the queue
  const A t = (A)threshold;
  for (int base = 0; base < NS; base += THREADS) {
    const int i = base + tid;
    bool cand = false;
    if (i < NS) {
      const int r = i / EW, c = i - r * EW;
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
      if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
        const S* w0 = &win[r + HALO - 1][c + HALO - 1];
        const A ctr = St::value(w0[0]);
        int nb = 0, nd = 0;
#pragma unroll
        for (int k = 0; k < 16; k += 4) {
          const A e = St::value(w0[circle_dy(k) * WW + circle_dx(k)]) - ctr;
          nb += e > t;
          nd += e < -t;
        }
        cand = nb >= 2 || nd >= 2;
      }
      sc[r][c] = 0.0f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cand);
    if (ballot) {
      int pos = 0;
      if (lane == 0) pos = atomicAdd(&queued, __popc(ballot));
      pos = __shfl_sync(0xffffffffu, pos, 0);
      if (cand) queue[pos + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)i;
    }
  }
  __syncthreads();

  const int nq = queued;
  for (int j = tid; j < nq; j += THREADS) {
    const int i = queue[j];
    const int r = i / EW, c = i - r * EW;
    sc[r][c] = corner_score(&win[r + HALO - 1][c + HALO - 1], t);
  }
  __syncthreads();

  // NMS: each thread walks NMS_ROWS rows of one column with the 3x3
  // window in registers
  const int c = tid % TW;
  const int r0 = (tid / TW) * NMS_ROWS;
  const int gx = tx0 + c;
  if (gx >= W) return;
  float above = fmaxf(fmaxf(sc[r0][c], sc[r0][c + 1]), sc[r0][c + 2]);
  float ml = sc[r0 + 1][c], mc = sc[r0 + 1][c + 1], mr = sc[r0 + 1][c + 2];
  const bool col_in_band = gx >= border && gx < W - border;
  float* dst = out + (size_t)n * H * W + gx;
  for (int r = r0; r < r0 + NMS_ROWS; ++r) {
    const int gy = ty0 + r;
    if (gy >= H) break;
    const float bl = sc[r + 2][c], bc = sc[r + 2][c + 1], br = sc[r + 2][c + 2];
    const float nmax =
        fmaxf(fmaxf(above, fmaxf(fmaxf(bl, bc), br)), fmaxf(ml, mr));
    const bool in_band = col_in_band && gy >= border && gy < H - border;
    dst[(size_t)gy * W] = (in_band && mc > nmax) ? mc : 0.0f;
    above = fmaxf(fmaxf(ml, mc), mr);
    ml = bl;
    mc = bc;
    mr = br;
  }
}

template <typename T>
cudaError_t launch(const void* imgs, float* out, int N, int H, int W,
                   float threshold, int border, cudaStream_t st) {
  // 4-pixel groups load as one vector when every row starts aligned
  const int vec = W % 4 == 0 && (uintptr_t)imgs % (4 * sizeof(T)) == 0;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  fast_kernel<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(imgs), out,
                                           H, W, threshold, border, vec);
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
