// The real roots of a bank of real polynomials in one launch: the
// Durand-Kerner root finder of ops/polynomial.py (find_roots + real_roots)
// with every sweep of every polynomial in registers.
//
// Replaces no TPU kernel: the JAX package's root finder
// (colmap_pcd_tpu/ops/polynomial.py::find_roots) is plain jnp, which XLA
// runs as one program. It is written by hand because in eager PyTorch the
// same loop sets the pace of the RANSAC banks: each of its 80 sweeps is a
// polyval of ten multiply-adds, a product over the roots' differences, a
// floor and a divide, ~30 launches on tensors of ~33 k complex numbers, so
// a 16-pair verification chunk dispatches ~3 900 operations from the host
// for the five-point solver's degree-10 polynomials alone (P3P's quartics
// likewise in every ransac_pnp).
//
// What bounds it on Hopper: operations, and they are negligible (~0.2 GFLOP
// for a chunk's ~3 300 polynomials). The kernel exists to remove launches
// and host dispatch, not device time. The design:
//   * one thread owns one polynomial; its coefficients and its roots stay
//     in registers, the degree is a template parameter (1 to MAX_DEGREE,
//     one instantiation each), so every loop over coefficients and roots
//     unrolls;
//   * the prologue is the plain route's, in its order: max-abs scaling,
//     the geometric balancing z = s u with log s clamped to [0, 7], the
//     monic normalisation, the (0.4 + 0.9i)^k initial roots;
//   * the sweeps are simultaneous updates, as in the plain route: every
//     root moves by p(z_i) / prod_j (z_i - z_j) over the previous sweep's
//     roots (not Gauss-Seidel, not Aberth); then Newton steps on each root,
//     the un-balancing, and real_roots' test |im| <= tol (1 + |re|) with
//     the leading coefficient's flag;
//   * blocks of 128 threads; no shared memory, no atomics, no scratch.
// The arithmetic is complex64 throughout, as the plain route's. Complex
// division is c10::complex's (numpy's scaled formula) and the floors (1e-20
// on the denominators, 1e-30 on the leading coefficient) are the plain
// route's. Rounding differs from the plain route's in the last bits:
// torch.prod's reduction order over the roots cannot be reproduced.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// a named namespace, so that a profiler's trace names the kernel
// (poly_roots::poly_roots_kernel<degree>)
namespace poly_roots {

constexpr int MAX_DEGREE = 10;
constexpr int THREADS = 128;

struct cpx {
  float re, im;
};

__device__ __forceinline__ cpx cmul(cpx a, cpx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ cpx csub(cpx a, cpx b) { return {a.re - b.re, a.im - b.im}; }

// c10::complex's operator/ (numpy's scaled division)
__device__ __forceinline__ cpx cdiv(cpx a, cpx b) {
  const float c = b.re, d = b.im, abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) return {a.re / abs_c, a.im / abs_d};
    const float rat = d / c, scl = 1.0f / (c + d * rat);
    return {(a.re + a.im * rat) * scl, (a.im - a.re * rat) * scl};
  }
  const float rat = c / d, scl = 1.0f / (d + c * rat);
  return {(a.re * rat + a.im) * scl, (a.im * rat - a.re) * scl};
}

// x where |x| >= eps, else eps (the plain route's _floor_abs)
__device__ __forceinline__ cpx floor_abs(cpx x, float eps) {
  return hypotf(x.re, x.im) < eps ? cpx{eps, 0.0f} : x;
}

// torch.amax's and torch.clamp's NaN rule: a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) { return (isnan(b) || b > a) ? b : a; }
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// Horner over M real coefficients (highest first) at z
template <int M>
__device__ __forceinline__ cpx horner(const float (&c)[M], cpx z) {
  cpx out{c[0], 0.0f};
#pragma unroll
  for (int k = 1; k < M; ++k) {
    out = cmul(out, z);
    out.re += c[k];
  }
  return out;
}

template <int N>
__global__ void __launch_bounds__(THREADS) poly_roots_kernel(const float* __restrict__ coeffs, int P,
                                                             int iters, int newton_iters, float tol,
                                                             float* __restrict__ roots_out,
                                                             uint8_t* __restrict__ valid_out) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const float* cp = coeffs + static_cast<size_t>(p) * (N + 1);

  // max-abs scaling
  float c[N + 1];
  float scale = 0.0f;
#pragma unroll
  for (int k = 0; k <= N; ++k) {
    c[k] = cp[k];
    scale = k == 0 ? fabsf(c[k]) : nan_max(scale, fabsf(c[k]));
  }
  scale = scale > 0.0f ? scale : 1.0f;
#pragma unroll
  for (int k = 0; k <= N; ++k) c[k] = c[k] / scale;

  // geometric balancing z = s u: s = (max |c_k>0| / |lead|)^(1/N), log s
  // clamped to [0, 7]
  const float lead_abs = fabsf(c[0]);
  float tail_max = fabsf(c[1]);
#pragma unroll
  for (int k = 2; k <= N; ++k) tail_max = nan_max(tail_max, fabsf(c[k]));
  tail_max = isnan(tail_max) ? tail_max : fmaxf(tail_max, 1e-30f);
  const bool ok = lead_abs > 1e-30f;
  const float log_s =
      nan_clamp((logf(tail_max) - logf(isnan(lead_abs) ? lead_abs : fmaxf(lead_abs, 1e-30f))) / N, 0.0f,
                7.0f);
  const float s = expf(log_s);
  float monic[N + 1];
#pragma unroll
  for (int k = 0; k <= N; ++k) monic[k] = c[k] * powf(s, static_cast<float>(N - k));
  const float lead = fabsf(monic[0]) > 1e-30f ? monic[0] : 1.0f;
#pragma unroll
  for (int k = 0; k <= N; ++k) monic[k] = monic[k] / lead;

  // initial roots (0.4 + 0.9i)^k = exp(k log(0.4 + 0.9i)), k = 1..N
  const float base_r = logf(hypotf(0.4f, 0.9f)), base_t = atan2f(0.9f, 0.4f);
  cpx z[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float m = expf((i + 1) * base_r), t = (i + 1) * base_t;
    z[i] = {m * cosf(t), m * sinf(t)};
  }

  // Durand-Kerner, simultaneous updates: every root from the last sweep's
  for (int it = 0; it < iters; ++it) {
    cpx next[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cpx prod{1.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j != i) prod = cmul(prod, csub(z[i], z[j]));
      next[i] = csub(z[i], cdiv(horner(monic, z[i]), floor_abs(prod, 1e-20f)));
    }
#pragma unroll
    for (int i = 0; i < N; ++i) z[i] = next[i];
  }

  // Newton polish on each root
  float dmonic[N];
#pragma unroll
  for (int k = 0; k < N; ++k) dmonic[k] = monic[k] * static_cast<float>(N - k);
  for (int it = 0; it < newton_iters; ++it) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      z[i] = csub(z[i], cdiv(horner(monic, z[i]), floor_abs(horner(dmonic, z[i]), 1e-20f)));
  }

  // un-balance, then real_roots' test
  float* ro = roots_out + static_cast<size_t>(p) * N;
  uint8_t* vo = valid_out + static_cast<size_t>(p) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float re = z[i].re * s, im = z[i].im * s;
    const bool valid = ok && fabsf(im) <= tol * (1.0f + fabsf(re));
    ro[i] = valid ? re : 0.0f;
    vo[i] = valid ? 1 : 0;
  }
}

template <int N>
cudaError_t launch(const float* coeffs, int P, int iters, int newton_iters, float tol, float* roots,
                   uint8_t* valid, cudaStream_t stream) {
  poly_roots_kernel<N><<<(P + THREADS - 1) / THREADS, THREADS, 0, stream>>>(coeffs, P, iters, newton_iters,
                                                                          tol, roots, valid);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_degree(int degree, const float* coeffs, int P, int iters, int newton_iters, float tol,
                          float* roots, uint8_t* valid, cudaStream_t stream) {
  if constexpr (N > MAX_DEGREE) {
    return cudaErrorInvalidValue;
  } else {
    if (degree != N)
      return launch_degree<N + 1>(degree, coeffs, P, iters, newton_iters, tol, roots, valid, stream);
    return launch<N>(coeffs, P, iters, newton_iters, tol, roots, valid, stream);
  }
}

}  // namespace poly_roots

using namespace poly_roots;

// coeffs [P, degree + 1] highest first; roots [P, degree] (0 where not
// valid), valid [P, degree] (0 or 1)
extern "C" int poly_roots_launch(const float* coeffs, int P, int degree, int iters, int newton_iters,
                                 float tol, float* roots, uint8_t* valid, void* stream) {
  if (P < 1 || degree < 1 || degree > MAX_DEGREE || iters < 0 || newton_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_degree<1>(degree, coeffs, P, iters, newton_iters, tol, roots, valid,
                                           static_cast<cudaStream_t>(stream)));
}
