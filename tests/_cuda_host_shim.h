// A host stand-in for <cuda_runtime.h>, so that a csrc/*.cu kernel with a
// plain C interface compiles with g++ and runs on the CPU: a launch runs
// its blocks in turn, each block's lanes as coroutines on the calling
// thread (ucontext), __syncthreads switches to the next lane until all
// have reached it, __shared__ arrays are statics, and the intrinsics are
// their IEEE float32 definitions.  Build with -ffp-contract=off (nvcc's
// --fmad=false).  tests/test_torch_warp_accum_design.py and
// tests/test_torch_warp_design.py rewrite each
// `kernel<<<blocks, threads, 0, stream>>>(args)` as a host_grid call.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct host_dim3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// streaming stores and read-only loads: plain ones on the host
inline void __stcs(float* p, float v) { *p = v; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline void __stcs(float4* p, float4 v) { *p = v; }
inline host_dim3 threadIdx, blockIdx;
inline ucontext_t host_scheduler;
inline std::vector<ucontext_t> host_lanes;
inline void __syncthreads() {
  swapcontext(&host_lanes[threadIdx.x], &host_scheduler);
}
using std::max;
using std::min;
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __float_as_int(float f) { int u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host shim"; }
// Run `blocks` blocks of `threads` lanes: each round resumes every lane
// that has not returned until its next __syncthreads (or its end).
inline std::function<void()> host_kernel;
inline std::vector<bool> host_done;
inline void host_lane(int t) {
  host_kernel();
  host_done[t] = true;
}
inline void host_grid(dim3 blocks, unsigned threads,
                      std::function<void()> fn) {
  constexpr size_t kStack = 1 << 16;
  std::vector<char> stacks(threads * kStack);
  host_kernel = fn;
  host_lanes.assign(threads, ucontext_t{});
  for (unsigned by = 0; by < blocks.y; ++by)
  for (unsigned b = 0; b < blocks.x; ++b) {
    blockIdx = {b, by, 0};
    host_done.assign(threads, false);
    for (unsigned t = 0; t < threads; ++t) {
      getcontext(&host_lanes[t]);
      host_lanes[t].uc_stack.ss_sp = &stacks[t * kStack];
      host_lanes[t].uc_stack.ss_size = kStack;
      host_lanes[t].uc_link = &host_scheduler;
      makecontext(&host_lanes[t], (void (*)())host_lane, 1, (int)t);
    }
    for (bool running = true; running;) {
      running = false;
      for (unsigned t = 0; t < threads; ++t) {
        if (host_done[t]) continue;
        threadIdx = {t, 0, 0};
        swapcontext(&host_scheduler, &host_lanes[t]);
        running = true;
      }
    }
  }
}
inline void host_grid(unsigned blocks, unsigned threads,
                      std::function<void()> fn) {
  host_grid(dim3(blocks), threads, fn);
}
