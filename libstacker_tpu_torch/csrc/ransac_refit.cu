// RANSAC's refit on the inliers, batched over frames, one launch each:
// the weighted DLT's smallest eigenvector (ransac_dlt_kernel) and the
// whole masked Gauss-Newton polish of the reprojection error
// (ransac_refine_kernel).  Their plain versions are ops/ransac.py
// _dlt_least_squares and _gauss_newton_refine, which the CPU runs.
//
// Replaces no TPU kernel: the JAX package computes both with XLA-level
// jnp (libstacker_tpu/ops/ransac.py _dlt_least_squares :93, an eigh;
// _gauss_newton_refine :109, ten 8x8 solves), vmapped over frames.  On
// the card the port ran the plain versions eagerly: torch.linalg.eigh,
// whose check of its info makes the host wait for the card, then ten
// Gauss-Newton steps of ~100 launches each on [B, M] tensors, so the host
// set the pace of the refit (~1000 launches a burst).
//
// Arithmetic: float64 from the float32 inputs to the float32 outputs.
// The plain versions compute in the points' dtype (float32 on the path):
// their float32 polish stops short of the optimum that float64 reaches,
// so the kernels are held to the plain versions run in float64 within
// 1e-3 px at a 4K frame's corners, the float32 output's rounding.
// Against the float32 plain versions the gap is that shortfall: up to
// 0.0049 px on the tests' synthetic frames, and on the 4K keypoint
// cell's frames 0.0089 px or less but on one of 456, at 0.0136 px,
// where the float32 polish stopped 0.0137 px from the optimum
// (tests/test_torch_ransac_refit.py).
//
// What bounds it on the H100: neither bytes nor operations.  A 20-frame
// burst is 19 blocks of M = 500 slots: 20 bytes and ~200 (DLT) or ~250
// (a polish step) float64 operations a slot, well under a microsecond of
// either at the card's rates.  The time is each block's serial part: the
// sums across its threads and thread 0's solves.
//
// Design:
// - A block of THREADS threads a frame.  Each thread sums its slots'
//   terms (slots t, t + THREADS, ...) in float64; the block writes the
//   threads' partials to shared memory and thread k adds partial k over
//   the threads in order, so a launch gives the same bits every run.
// - The DLT: the 45 entries of the upper triangle of the 9x9 Gram of the
//   weighted rows [x, y, 1, 0, 0, 0, -ux, -uy, -u] and
//   [0, 0, 0, x, y, 1, -vx, -vy, -v]; thread 0 diagonalises it by cyclic
//   Jacobi (Rutishauser's rotations, as Numerical Recipes' jacobi), takes
//   the eigenvector of the least eigenvalue (the first index of it) and
//   divides it by its h22 as ops/ransac._normalise_h22 does.
// - The polish, `iters` steps: the 36 + 8 sums of J^T J and J^T r of the
//   weighted residuals over the 8 entries other than h22; thread 0 solves
//   (J^T J + 1e-6 I) dp = J^T r by LU with partial pivoting (dp = 0 on a
//   zero pivot, a non-finite entry of dp = 0, as the plain version masks
//   solve_ex's info and non-finite entries); the block sums the weighted
//   squared errors under h and h - dp and keeps h - dp where it is lower.
//
// Build with --fmad=false (utils/cuda_build.py), as every source here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
// partials a thread: the Gram's upper triangle (45); the polish's J^T J
// upper triangle and J^T r (36 + 8)
constexpr int DLT_SUMS = 45;
constexpr int STEP_SUMS = 44;
constexpr int RED_STRIDE = DLT_SUMS + 1;

// Thread k < n sets tot[k] to the sum over the threads, in order, of
// their partial k; every thread may read tot after the call.
template <int N>
__device__ __forceinline__ void block_sum(const double (&part)[N],
                                          double (*red)[RED_STRIDE],
                                          double* tot) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < N; ++k) red[t][k] = part[k];
  __syncthreads();
  if (t < N) {
    double s = 0.0;
    for (int u = 0; u < THREADS; ++u) s += red[u][t];
    tot[t] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void rotate(double (*a)[9], int i, int j, int k,
                                       int l, double s, double tau) {
  const double g = a[i][j], h = a[k][l];
  a[i][j] = g - s * (h + g * tau);
  a[k][l] = h + s * (g - h * tau);
}

// Cyclic Jacobi on the symmetric 9x9 `a` (its upper triangle, destroyed):
// the eigenvalues into d and the eigenvectors into v's columns.
__device__ void jacobi9(double (*a)[9], double (*v)[9], double* d) {
  constexpr int n = 9;
  double b[n], z[n];
  for (int p = 0; p < n; ++p) {
    for (int q = 0; q < n; ++q) v[p][q] = p == q ? 1.0 : 0.0;
    b[p] = d[p] = a[p][p];
    z[p] = 0.0;
  }
  for (int sweep = 1; sweep <= 50; ++sweep) {
    double sm = 0.0;
    for (int p = 0; p < n - 1; ++p)
      for (int q = p + 1; q < n; ++q) sm += fabs(a[p][q]);
    if (sm == 0.0) return;
    const double tresh = sweep < 4 ? 0.2 * sm / (n * n) : 0.0;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double g = 100.0 * fabs(a[p][q]);
        if (sweep > 4 && fabs(d[p]) + g == fabs(d[p]) &&
            fabs(d[q]) + g == fabs(d[q])) {
          a[p][q] = 0.0;
        } else if (fabs(a[p][q]) > tresh) {
          double h = d[q] - d[p];
          double t;
          if (fabs(h) + g == fabs(h)) {
            t = a[p][q] / h;
          } else {
            const double theta = 0.5 * h / a[p][q];
            t = 1.0 / (fabs(theta) + sqrt(1.0 + theta * theta));
            if (theta < 0.0) t = -t;
          }
          const double c = 1.0 / sqrt(1.0 + t * t);
          const double s = t * c;
          const double tau = s / (1.0 + c);
          h = t * a[p][q];
          z[p] -= h;
          z[q] += h;
          d[p] -= h;
          d[q] += h;
          a[p][q] = 0.0;
          for (int j = 0; j < p; ++j) rotate(a, j, p, j, q, s, tau);
          for (int j = p + 1; j < q; ++j) rotate(a, p, j, j, q, s, tau);
          for (int j = q + 1; j < n; ++j) rotate(a, p, j, q, j, s, tau);
          for (int j = 0; j < n; ++j) rotate(v, j, p, j, q, s, tau);
        }
      }
    }
    for (int p = 0; p < n; ++p) {
      b[p] += z[p];
      d[p] = b[p];
      z[p] = 0.0;
    }
  }
}

// false for an infinity or a NaN
__device__ __forceinline__ bool finite(double x) {
  return fabs(x) <= 1.7976931348623157e308;
}

// ops/ransac._project's denominator: h20 x + h21 y + h22, 1e-12 where its
// magnitude is below 1e-12.
__device__ __forceinline__ double denom(const double* h, double x,
                                        double y) {
  const double w = h[6] * x + h[7] * y + h[8];
  return fabs(w) < 1e-12 ? 1e-12 : w;
}

__device__ __forceinline__ double sq_error(const double* h, double x,
                                           double y, double dx, double dy) {
  const double w = denom(h, x, y);
  const double eu = (h[0] * x + h[1] * y + h[2]) / w - dx;
  const double ev = (h[3] * x + h[4] * y + h[5]) / w - dy;
  return eu * eu + ev * ev;
}

// src, dst [B, M, 2], w [B, M], out [B, 3, 3]; a block a frame.
__global__ void __launch_bounds__(THREADS)
    ransac_dlt_kernel(const float* __restrict__ src,
                      const float* __restrict__ dst,
                      const float* __restrict__ w, float* __restrict__ out,
                      int M) {
  __shared__ double red[THREADS][RED_STRIDE];
  __shared__ double tot[RED_STRIDE];
  __shared__ double a[9][9], v[9][9];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * M;
  double part[DLT_SUMS];
#pragma unroll
  for (int k = 0; k < DLT_SUMS; ++k) part[k] = 0.0;
  for (int m = t; m < M; m += THREADS) {
    const double wt = w[base + m];
    const double x = src[2 * (base + m)], y = src[2 * (base + m) + 1];
    const double u = dst[2 * (base + m)], vv = dst[2 * (base + m) + 1];
    const double ru[9] = {x * wt, y * wt, wt, 0.0, 0.0, 0.0,
                          -u * x * wt, -u * y * wt, -u * wt};
    const double rv[9] = {0.0, 0.0, 0.0, x * wt, y * wt, wt,
                          -vv * x * wt, -vv * y * wt, -vv * wt};
    int k = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = i; j < 9; ++j) part[k++] += ru[i] * ru[j] + rv[i] * rv[j];
  }
  block_sum(part, red, tot);
  if (t != 0) return;
  int k = 0;
  for (int i = 0; i < 9; ++i)
    for (int j = i; j < 9; ++j) a[i][j] = a[j][i] = tot[k++];
  double d[9];
  jacobi9(a, v, d);
  int least = 0;
  for (int i = 1; i < 9; ++i)
    if (d[i] < d[least]) least = i;
  const double h22 = v[8][least];
  const double den = fabs(h22) < 1e-12 ? 1e-12 : h22;
  for (int i = 0; i < 9; ++i)
    out[9LL * blockIdx.x + i] = (float)(v[i][least] / den);
}

// Solve the 8x8 `a` x = r in place by LU with partial pivoting (the first
// row of the largest magnitude); false on a zero pivot.
__device__ bool solve8(double (*a)[8], double* r) {
  for (int c = 0; c < 8; ++c) {
    int p = c;
    for (int i = c + 1; i < 8; ++i)
      if (fabs(a[i][c]) > fabs(a[p][c])) p = i;
    if (a[p][c] == 0.0) return false;
    if (p != c) {
      for (int j = 0; j < 8; ++j) {
        const double s = a[c][j];
        a[c][j] = a[p][j];
        a[p][j] = s;
      }
      const double s = r[c];
      r[c] = r[p];
      r[p] = s;
    }
    for (int i = c + 1; i < 8; ++i) {
      const double f = a[i][c] / a[c][c];
      for (int j = c + 1; j < 8; ++j) a[i][j] -= f * a[c][j];
      r[i] -= f * r[c];
    }
  }
  for (int i = 7; i >= 0; --i) {
    double s = r[i];
    for (int j = i + 1; j < 8; ++j) s -= a[i][j] * r[j];
    r[i] = s / a[i][i];
  }
  return true;
}

// h, out [B, 3, 3]; src, dst [B, M, 2]; w [B, M]; a block a frame.
__global__ void __launch_bounds__(THREADS)
    ransac_refine_kernel(const float* __restrict__ h_in,
                         const float* __restrict__ src,
                         const float* __restrict__ dst,
                         const float* __restrict__ w,
                         float* __restrict__ out, int M, int iters) {
  __shared__ double red[THREADS][RED_STRIDE];
  __shared__ double tot[RED_STRIDE];
  __shared__ double hs[9], hn[9];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * M;
  if (t < 9) hs[t] = h_in[9LL * blockIdx.x + t];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    double part[STEP_SUMS];
#pragma unroll
    for (int k = 0; k < STEP_SUMS; ++k) part[k] = 0.0;
    for (int m = t; m < M; m += THREADS) {
      const double wt = w[base + m];
      const double x = src[2 * (base + m)], y = src[2 * (base + m) + 1];
      const double wd = denom(hs, x, y);
      const double u = (hs[0] * x + hs[1] * y + hs[2]) / wd;
      const double v = (hs[3] * x + hs[4] * y + hs[5]) / wd;
      const double iw = 1.0 / wd;
      const double ju[8] = {x * iw * wt, y * iw * wt, iw * wt, 0.0, 0.0, 0.0,
                            -u * x * iw * wt, -u * y * iw * wt};
      const double jv[8] = {0.0, 0.0, 0.0, x * iw * wt, y * iw * wt, iw * wt,
                            -v * x * iw * wt, -v * y * iw * wt};
      const double ru = (u - dst[2 * (base + m)]) * wt;
      const double rv = (v - dst[2 * (base + m) + 1]) * wt;
      int k = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = i; j < 8; ++j) part[k++] += ju[i] * ju[j] + jv[i] * jv[j];
#pragma unroll
      for (int i = 0; i < 8; ++i) part[36 + i] += ju[i] * ru + jv[i] * rv;
    }
    block_sum(part, red, tot);
    if (t == 0) {
      double a[8][8], r[8];
      int k = 0;
      for (int i = 0; i < 8; ++i)
        for (int j = i; j < 8; ++j) a[i][j] = a[j][i] = tot[k++];
      for (int i = 0; i < 8; ++i) {
        a[i][i] += 1e-6;
        r[i] = tot[36 + i];
      }
      const bool ok = solve8(a, r);
      for (int i = 0; i < 8; ++i)
        hn[i] = hs[i] - (ok && finite(r[i]) ? r[i] : 0.0);
      hn[8] = hs[8];
    }
    __syncthreads();
    double sse[2] = {0.0, 0.0};
    for (int m = t; m < M; m += THREADS) {
      const double wt = w[base + m];
      const double x = src[2 * (base + m)], y = src[2 * (base + m) + 1];
      const double dx = dst[2 * (base + m)], dy = dst[2 * (base + m) + 1];
      sse[0] += wt * sq_error(hs, x, y, dx, dy);
      sse[1] += wt * sq_error(hn, x, y, dx, dy);
    }
    block_sum(sse, red, tot);
    if (t < 9 && tot[1] < tot[0]) hs[t] = hn[t];
    __syncthreads();
  }
  if (t < 9) out[9LL * blockIdx.x + t] = (float)hs[t];
}

}  // namespace

extern "C" {

// src, dst [B, M, 2] f32, w [B, M] f32, out [B, 3, 3] f32, all on the
// device and contiguous.
int ransac_dlt(const void* src, const void* dst, const void* w, void* out,
               int B, int M, void* stream) {
  if (B < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  ransac_dlt_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(dst),
      static_cast<const float*>(w), static_cast<float*>(out), M);
  return (int)cudaGetLastError();
}

// h, out [B, 3, 3] f32, src, dst [B, M, 2] f32, w [B, M] f32, all on the
// device and contiguous; iters >= 0 polish steps.
int ransac_refine(const void* h, const void* src, const void* dst,
                  const void* w, void* out, int B, int M, int iters,
                  void* stream) {
  if (B < 0 || M < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  ransac_refine_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(src),
      static_cast<const float*>(dst), static_cast<const float*>(w),
      static_cast<float*>(out), M, iters);
  return (int)cudaGetLastError();
}

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
