// A host stand-in for <cuda_runtime.h>, so that a csrc/*.cu kernel with a
// plain C interface compiles with g++ and runs on the CPU: a launch runs
// its blocks in turn, each block's lanes as coroutines on the calling
// thread (ucontext); a lane at __syncthreads waits until every lane that
// has not returned reaches it, a lane at a warp's barrier (__syncwarp,
// and inside the shuffles and ballots, which exchange through a slot a
// lane) until the other lanes of its warp do; __shared__ arrays are
// statics, a source's DYNAMIC_SHARED(T, name) (its `extern __shared__`
// array) the launch's dynamic bytes, and the intrinsics are their IEEE
// float32 definitions.  Build with -ffp-contract=off (nvcc's
// --fmad=false).  tests/test_torch_warp_accum_design.py,
// tests/test_torch_warp_design.py, tests/test_torch_orb_design.py and
// tests/test_torch_ecc_blur.py rewrite each
// `kernel<<<blocks, threads, bytes, stream>>>(args)` as a host_grid call.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
struct float4 { float x, y, z, w; };
struct char4 { signed char x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
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
// cp.async as <cuda_pipeline.h> declares it: the copy at once on the host
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) { std::memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline host_dim3 threadIdx, blockIdx;
// a launch's dynamic shared memory, as 16-byte words
inline std::vector<float4> host_dynamic_shared;
#define DYNAMIC_SHARED(T, name) \
  T* const name = reinterpret_cast<T*>(host_dynamic_shared.data())
inline ucontext_t host_scheduler;
inline std::vector<ucontext_t> host_lanes;
// per lane: block and warp barriers reached, whether it has returned, and
// its exchange slot
inline std::vector<long> host_block_arrivals, host_warp_arrivals;
inline std::vector<bool> host_done;
inline std::vector<uint64_t> host_slot;
inline void host_yield() {
  swapcontext(&host_lanes[threadIdx.x], &host_scheduler);
}
inline void __syncthreads() {
  ++host_block_arrivals[threadIdx.x];
  host_yield();
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  ++host_warp_arrivals[threadIdx.x];
  host_yield();
}
template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int mask) {
  static_assert(sizeof(V) <= sizeof(uint64_t), "one slot a lane");
  const unsigned t = threadIdx.x;
  std::memcpy(&host_slot[t], &v, sizeof(V));
  __syncwarp();
  V r;
  std::memcpy(&r, &host_slot[t ^ (unsigned)mask], sizeof(V));
  __syncwarp();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  const unsigned t = threadIdx.x, base = t & ~31u;
  host_slot[t] = p;
  __syncwarp();
  unsigned r = 0;
  for (unsigned l = 0; l < 32 && base + l < host_slot.size(); ++l)
    if (!host_done[base + l] && host_slot[base + l]) r |= 1u << l;
  __syncwarp();
  return r;
}
using std::max;
using std::min;
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __float_as_int(float f) { int u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
// byte i of the result: byte (s >> 4i) & 7 of y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xFF) << (8 * i);
  return r;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host shim"; }
// Run `blocks` blocks of `threads` lanes: each round resumes every lane
// that has not returned and whose barrier its peers have reached, until
// its next barrier (or its end); a round that resumes no lane while some
// have not returned is a kernel whose lanes wait at different barriers.
inline std::function<void()> host_kernel;
inline void host_lane(int t) {
  host_kernel();
  host_done[t] = true;
}
inline void host_grid(dim3 blocks, unsigned threads,
                      std::function<void()> fn, size_t dynamic_bytes = 0) {
  constexpr size_t kStack = 1 << 16;
  std::vector<char> stacks(threads * kStack);
  host_kernel = fn;
  host_dynamic_shared.assign((dynamic_bytes + 15) / 16, float4{});
  host_lanes.assign(threads, ucontext_t{});
  for (unsigned by = 0; by < blocks.y; ++by)
  for (unsigned b = 0; b < blocks.x; ++b) {
    blockIdx = {b, by, 0};
    host_done.assign(threads, false);
    host_block_arrivals.assign(threads, 0);
    host_warp_arrivals.assign(threads, 0);
    host_slot.assign(threads, 0);
    for (unsigned t = 0; t < threads; ++t) {
      getcontext(&host_lanes[t]);
      host_lanes[t].uc_stack.ss_sp = &stacks[t * kStack];
      host_lanes[t].uc_stack.ss_size = kStack;
      host_lanes[t].uc_link = &host_scheduler;
      makecontext(&host_lanes[t], (void (*)())host_lane, 1, (int)t);
    }
    std::vector<long> warp_min((threads + 31) / 32);
    for (bool running = true; running;) {
      // the fewest barriers a lane that has not returned has reached, in
      // the block and in each warp: a lane waits while it is past them
      long block_min = LONG_MAX;
      std::fill(warp_min.begin(), warp_min.end(), LONG_MAX);
      for (unsigned t = 0; t < threads; ++t) {
        if (host_done[t]) continue;
        block_min = std::min(block_min, host_block_arrivals[t]);
        warp_min[t >> 5] = std::min(warp_min[t >> 5], host_warp_arrivals[t]);
      }
      running = false;
      bool resumed = false;
      for (unsigned t = 0; t < threads; ++t) {
        if (host_done[t]) continue;
        running = true;
        if (host_block_arrivals[t] > block_min ||
            host_warp_arrivals[t] > warp_min[t >> 5])
          continue;
        threadIdx = {t, 0, 0};
        swapcontext(&host_scheduler, &host_lanes[t]);
        resumed = true;
      }
      if (running && !resumed) std::abort();
    }
  }
}
inline void host_grid(unsigned blocks, unsigned threads,
                      std::function<void()> fn, size_t dynamic_bytes = 0) {
  host_grid(dim3(blocks), threads, fn, dynamic_bytes);
}
