// The burst grey: OpenCV's shift-15 fixed-point Rec.601 luma
//   (9798 R + 19235 G + 3735 B + 2^14) >> 15
// of [..., H, W, 3] RGB pixels, uint8 or uint16 (greyed on its high byte,
// as ops/color.depth_reduce_u8 does), written once as uint8 (grey_u8_kernel)
// or as the same values in float32 (grey_f32_kernel, the ECC path's input).
// The plain version is ops/color_cuda.grey_reference; the two are bitwise
// equal.
//
// Replaces no TPU kernel: the JAX package's grey is XLA-level jnp
// (libstacker_tpu/ops/color.py :26).  On the card the port ran the plain
// version's eager chain: each channel read through a strided view and
// widened to int32, three multiplies and adds into an int32 accumulator,
// the shift and the narrowing to uint8, ~10 int32 passes of 4 B a pixel,
// in chunks of 16 frames concatenated after, then a widening to float32
// for ECC.
//
// What bounds it on the H100.  A pixel's three multiplies and two adds are
// far below the ridge; the bound is reading each RGB pixel once and writing
// its grey once: 3 + 4 B a pixel for uint8 RGB to float32, 5.81 GB and
// 1.733 ms at 3.35 TB/s for 100 frames of 2160x3840 (3 + 1 B, 0.990 ms,
// to uint8).
//
// Design: the burst is one flat stream of N*H*W pixels, cut into steps of
// a block's 4096 pixels (16 a thread).  A block copies a step's RGB into
// shared memory with coalesced 16-byte loads, three a thread for uint8
// (six for uint16), then each thread forms the luma of 4 runs of 4
// adjacent pixels, 1024 pixels apart, in uint32 (its largest sum,
// 32768 * 255 + 2^14, is below 2^31: the plain version's int32 values),
// and writes each run with one store: 16 bytes of float32 or 4 of uint8,
// adjacent threads on adjacent addresses.  (A thread's own 16 adjacent
// pixels, with no staging, stored 64 bytes a thread as four strided
// float4 stores: 0.549 of the bound to float32 on 100 4K frames on the
// H100, against 0.835 to uint8.)  The blocks, BLOCKS_PER_SM an SM (launch bounds keep
// them resident), walk the steps in a grid-stride loop.  The last N*H*W
// mod 4096 pixels, and every pixel where the source or the destination
// is not 16-byte aligned (a view at an odd offset), take a scalar path: a
// thread a pixel, the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2048 threads, 96 KB of uint8 RGB staged
constexpr int RUN = 4;            // adjacent pixels a store
constexpr int RUNS = 4;           // runs a thread a step
constexpr int STEP = THREADS * RUN * RUNS;  // a block's pixels a step
// B2Y = 2^15 - R2Y - G2Y
constexpr unsigned R2Y = 9798, G2Y = 19235, B2Y = 3735;
constexpr int SHIFT = 15;

__device__ __forceinline__ unsigned luma(unsigned r, unsigned g, unsigned b) {
  return (R2Y * r + G2Y * g + B2Y * b + (1u << (SHIFT - 1))) >> SHIFT;
}

// a channel value's byte: uint8 as it is, uint16 its high byte
__device__ __forceinline__ unsigned top_byte(uint8_t v) { return v; }
__device__ __forceinline__ unsigned top_byte(uint16_t v) { return v >> 8; }

// channel k (0 .. 11) of a run of 4 pixels from its WORDS 32-bit words
template <typename T> struct Run;
template <> struct Run<uint8_t> {
  static constexpr int WORDS = 3;
  __device__ __forceinline__ static unsigned channel(const unsigned* w,
                                                    int k) {
    return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
  }
};
template <> struct Run<uint16_t> {
  static constexpr int WORDS = 6;
  __device__ __forceinline__ static unsigned channel(const unsigned* w,
                                                    int k) {
    return (w[k >> 1] >> (16 * (k & 1) + 8)) & 0xFFu;
  }
};

__device__ __forceinline__ void store_run(uint8_t* dst, const unsigned* g) {
  *reinterpret_cast<unsigned*>(dst) =
      g[0] | g[1] << 8 | g[2] << 16 | g[3] << 24;
}

__device__ __forceinline__ void store_run(float* dst, const unsigned* g) {
  *reinterpret_cast<float4*>(dst) =
      make_float4((float)g[0], (float)g[1], (float)g[2], (float)g[3]);
}

__device__ __forceinline__ void store_one(uint8_t* dst, unsigned g) {
  *dst = (uint8_t)g;
}
__device__ __forceinline__ void store_one(float* dst, unsigned g) {
  *dst = (float)g;
}

// src: `pixels` RGB pixels of T; dst: `pixels` values of O; `vec`: both
// 16-byte aligned; `blocks`: the grid's blocks
template <typename T, typename O>
__device__ __forceinline__ void grey_body(const T* src, O* dst,
                                          long long pixels, bool vec,
                                          unsigned blocks) {
  constexpr int WORDS = Run<T>::WORDS;        // 32-bit words a run
  constexpr int LOADS = RUNS * WORDS / 4;     // 16-byte loads a thread
  __shared__ uint4 stage[THREADS * LOADS];    // a step's RGB
  const unsigned* words = reinterpret_cast<const unsigned*>(stage);
  const int t = threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long steps = pixels / STEP;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (long long b = blockIdx.x; b < steps; b += blocks) {
#pragma unroll
      for (int q = 0; q < LOADS; ++q)
        stage[q * THREADS + t] = __ldg(s + (b * LOADS + q) * THREADS + t);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RUNS; ++r) {
        // pixels r * THREADS * RUN + t * RUN .. + RUN - 1 of the step
        unsigned w[WORDS];
#pragma unroll
        for (int i = 0; i < WORDS; ++i)
          w[i] = words[(r * THREADS + t) * WORDS + i];
        unsigned g[RUN];
#pragma unroll
        for (int p = 0; p < RUN; ++p)
          g[p] = luma(Run<T>::channel(w, 3 * p),
                      Run<T>::channel(w, 3 * p + 1),
                      Run<T>::channel(w, 3 * p + 2));
        store_run(dst + b * STEP + (r * THREADS + t) * RUN, g);
      }
      __syncthreads();
    }
    done = steps * STEP;
  }
  const long long stride = (long long)blocks * THREADS;
  for (long long p = done + (long long)blockIdx.x * THREADS + t; p < pixels;
       p += stride)
    store_one(dst + p, luma(top_byte(src[3 * p]), top_byte(src[3 * p + 1]),
                            top_byte(src[3 * p + 2])));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    grey_u8_kernel(const T* src, uint8_t* dst, long long pixels, bool vec,
                   unsigned blocks) {
  grey_body(src, dst, pixels, vec, blocks);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    grey_f32_kernel(const T* src, float* dst, long long pixels, bool vec,
                    unsigned blocks) {
  grey_body(src, dst, pixels, vec, blocks);
}

template <typename T>
cudaError_t launch(const void* src, void* dst, long long pixels, int out,
                   int sms, cudaStream_t st) {
  const bool vec = ((uintptr_t)src | (uintptr_t)dst) % 16 == 0;
  const long long want = vec && pixels >= STEP
                             ? (pixels + STEP - 1) / STEP
                             : (pixels + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  auto s = static_cast<const T*>(src);
  if (out == 0)
    grey_u8_kernel<T><<<blocks, THREADS, 0, st>>>(
        s, static_cast<uint8_t*>(dst), pixels, vec, blocks);
  else
    grey_f32_kernel<T><<<blocks, THREADS, 0, st>>>(
        s, static_cast<float*>(dst), pixels, vec, blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: `pixels` RGB pixels, contiguous, of in_dtype 0 uint8 or 1 uint16;
// dst: `pixels` greys of out_dtype 0 uint8 or 1 float32; sms: the card's
// streaming multiprocessors (the grid is BLOCKS_PER_SM of them deep).  One
// launch; none for 0 pixels.
int grey(const void* src, void* dst, long long pixels, int in_dtype,
         int out_dtype, int sms, void* stream) {
  if (pixels < 0 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  if (pixels == 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return in_dtype == 0
             ? (int)launch<uint8_t>(src, dst, pixels, out_dtype, sms, st)
             : (int)launch<uint16_t>(src, dst, pixels, out_dtype, sms, st);
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
