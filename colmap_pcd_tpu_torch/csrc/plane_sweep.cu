// Plane-sweep stereo of one reference view in one launch: for every
// reference pixel, the depth of the fronto-parallel plane whose warped
// sources agree best with the reference over a (2r+1)^2 window.
//
// Replaces no TPU kernel: the JAX package's plane sweep
// (colmap_pcd_tpu/ops/stereo.py::plane_sweep) is plain jnp. It is written
// by hand because the sweep sets the pace of the dense stage: as plain
// PyTorch (ops/stereo.py::plane_sweep_plain, the CPU's route) every window
// tap is one elementwise launch over [depths, sources, H, W] tensors, so a
// view-pass at 1280x960 and r = 5 moves tens of GB through device memory
// for ~5 multiply-adds a tap.
//
// What bounds it on Hopper: f32 instruction slots and shared memory. A
// hypothesis (pixel, source, depth) costs 7 f32 instructions a tap (weight
// times the warped sample, its square and its product with the weighted
// reference, each added, and the validity's weight); 38 G taps at the
// cell's shape. The design keeps everything but the inputs on chip:
//   * one block per 32 x TY tile of reference pixels, one pixel a thread;
//     the tile's (2r+1)^2 bilateral weight planes, and the reference over
//     the tile and its r halo, are staged in shared memory once per launch;
//   * the block walks every depth in order, and for each the sources in
//     groups of 4 (then 2, then 1): each source of a group is warped
//     (homography, bilinear sample, validity) over the tile and its halo
//     into shared memory once, as (value, valid) pairs, and every thread
//     then sums its window over the group's sources in registers, so one
//     weight and one reference read serve 4 hypotheses;
//   * the NCC closes, the geometric term is added, and the best k sources
//     are kept by comparison in registers; the running best depth is
//     merged by a strict '<'. Only the depth and the photometric cost of
//     each pixel are written. One launch per view-pass, no atomics, no
//     scratch memory.
// Radii 1 to STAGED_RADIUS have one instantiation each, sized at compile
// time. Larger radii, up to COLMAP's largest window (MAX_RADIUS), share one
// instantiation that reads the radius at launch and the bilateral weights
// from global memory: their planes do not fit in shared memory beside the
// tile.
// The floats are the plain route's: every product, sum and quotient is
// taken in the same order and rounded as that route rounds it. Every
// product goes through mul() (__fmul_rn), which nvcc never contracts with
// an add into an FMA, so each product and each sum rounds on its own, as in
// the plain route's elementwise launches.
// Border rules are the plain route's: the bilateral window pads the warped
// values and their validity by replicating the edge pixel, the box window
// pads with zeros; source samples clip corners and fractions to the image
// and take validity from the unclipped coordinates.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// a named namespace, so that a profiler's trace names the kernel
// (plane_sweep::plane_sweep_kernel<radius, bilateral>)
namespace plane_sweep {

constexpr int TX = 32;             // tile width: a warp is one row of the tile
constexpr int GROUP = 4;           // sources warped together
constexpr int STAGED_RADIUS = 8;   // the largest radius with staged weights
constexpr int MAX_RADIUS = 32;     // COLMAP's largest PatchMatch window radius
constexpr int MAX_TOP_K = 4;
constexpr size_t MAX_SMEM = 227 * 1024;  // a block's shared memory on Hopper

// shared memory of a TX x ty tile at radius r: the group's warped (value,
// valid) pairs and the reference over the tile and its halo, then the
// weight planes where they are staged
__host__ __device__ constexpr size_t smem_bytes(int r, int ty, bool staged) {
  return (sizeof(float2) * GROUP + sizeof(float)) * (TX + 2 * r) * (ty + 2 * r) +
         (staged ? sizeof(float) * (2 * r + 1) * (2 * r + 1) * TX * ty : 0);
}

// the tile's rows at radius r: 8 where the staged weights fit, else 4; past
// STAGED_RADIUS 4, or 2 where a 4-row tile's halo does not fit
__host__ __device__ constexpr int tile_rows(int r) {
  return r <= STAGED_RADIUS ? (smem_bytes(r, 8, true) <= MAX_SMEM ? 8 : 4)
                            : (smem_bytes(r, 4, false) <= MAX_SMEM ? 4 : 2);
}

__host__ __device__ constexpr int max_threads(int R) { return TX * (R > 0 ? tile_rows(R) : 4); }

// the tile's sizes: compile-time constants for a staged radius R ...
template <int R>
struct Geo {
  static constexpr int ty = tile_rows(R), side = 2 * R + 1, hw = TX + 2 * R, hh = ty + 2 * R,
                       hn = hw * hh, threads = TX * ty;
  __device__ explicit Geo(int) {}
};

// ... and read from the launch's radius for R = 0
template <>
struct Geo<0> {
  int ty, side, hw, hh, hn, threads;
  __device__ explicit Geo(int r)
      : ty(tile_rows(r)), side(2 * r + 1), hw(TX + 2 * r), hh(ty + 2 * r), hn(hw * hh), threads(TX * ty) {}
};

struct Params {
  const float* ref;         // [H, W]
  const float* srcs;        // [S, Hs, Ws]
  const float* homs;        // [D, S, 3, 3] reference pixel -> source pixel
  const float* depths;      // [D]
  const float* weights;     // [T, H, W] bilateral weights (bilateral only)
  const float* term0;       // bilateral: Wsum, mu_r, var_r; box: s_r, s_rr
  const float* term1;
  const float* term2;
  const float* src_depths;  // [S, Hs, Ws] (geometric pass only)
  const float* geom;        // [S, 21] K_src^-1, R_rel, t_rel; then K_ref [9]
  int H, W, S, Hs, Ws, D, k, radius;
  float big;                // the running best's first cost
  float reg, max_cost;      // the geometric term's weight and cap
  float valid_min;          // box: a window needs more valid taps than this
  float* best_depth;        // [H, W]
  float* best_photo;        // [H, W]
};

// a product rounded on its own: never contracted into an FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// source coordinates of reference pixel (x, y) under the homography m
__device__ __forceinline__ void warp_coords(const float* __restrict__ m, float x, float y,
                                            float& sx, float& sy) {
  const float q0 = mul(__ldg(m + 0), x) + mul(__ldg(m + 1), y) + __ldg(m + 2);
  const float q1 = mul(__ldg(m + 3), x) + mul(__ldg(m + 4), y) + __ldg(m + 5);
  const float q2 = mul(__ldg(m + 6), x) + mul(__ldg(m + 7), y) + __ldg(m + 8);
  const float w = fabsf(q2) < 1e-8f ? 1e-8f : q2;
  sx = q0 / w;
  sy = q1 / w;
}

// bilinear sample of img [Hs, Ws] at (sx, sy): corners clipped to the image,
// fractions clipped to [0, 1]; valid (0 or 1) from the unclipped coordinates
__device__ __forceinline__ float2 sample(const float* __restrict__ img, int Hs, int Ws,
                                         float sx, float sy) {
  const float wmax = static_cast<float>(Ws - 1), hmax = static_cast<float>(Hs - 1);
  const float fx0 = floorf(sx), fy0 = floorf(sy);
  const float x0 = fminf(fmaxf(isnan(fx0) ? 0.f : fx0, 0.f), wmax);
  const float y0 = fminf(fmaxf(isnan(fy0) ? 0.f : fy0, 0.f), hmax);
  const float x1 = fminf(x0 + 1.f, wmax);
  const float y1 = fminf(y0 + 1.f, hmax);
  const float fx = clampf(sx - x0, 0.f, 1.f);
  const float fy = clampf(sy - y0, 0.f, 1.f);
  const size_t r0 = static_cast<size_t>(y0) * Ws, r1 = static_cast<size_t>(y1) * Ws;
  const int c0 = static_cast<int>(x0), c1 = static_cast<int>(x1);
  const float gx = 1.f - fx, gy = 1.f - fy;
  const float v = mul(mul(__ldg(img + r0 + c0), gx), gy) + mul(mul(__ldg(img + r0 + c1), fx), gy) +
                  mul(mul(__ldg(img + r1 + c0), gx), fy) + mul(mul(__ldg(img + r1 + c1), fx), fy);
  const bool valid = sx >= 0.f && sx <= wmax && sy >= 0.f && sy <= hmax;
  return make_float2(v, valid ? 1.f : 0.f);
}

// row j of the 3x3 matrix m applied to (a, b, c), summed k = 0, 1, 2
__device__ __forceinline__ float row3(const float* __restrict__ m, int j, float a, float b, float c) {
  return mul(__ldg(m + 3 * j), a) + mul(__ldg(m + 3 * j + 1), b) + mul(__ldg(m + 3 * j + 2), c);
}

// the geometric term of source s at reference pixel (x, y): the forward-
// backward reprojection error against the source's depth map, capped
__device__ __forceinline__ float geom_cost(const Params& p, int s, const float* __restrict__ m,
                                           float x, float y) {
  float sx, sy;
  warp_coords(m, x, y, sx, sy);
  const float2 ds = sample(p.src_depths + static_cast<size_t>(s) * p.Hs * p.Ws, p.Hs, p.Ws, sx, sy);
  const float* Ki = p.geom + s * 21;
  const float* Rm = Ki + 9;
  const float* t = Ki + 18;
  const float* K = p.geom + p.S * 21;
  // back-project the source pixel at its own depth, into the reference frame
  float y3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    y3[j] = mul(mul(__ldg(Ki + 3 * j), sx) + mul(__ldg(Ki + 3 * j + 1), sy) + __ldg(Ki + 3 * j + 2), ds.x) -
            __ldg(t + j);
  // R^T (y - t)
  float r3[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    r3[j] = mul(__ldg(Rm + j), y3[0]) + mul(__ldg(Rm + 3 + j), y3[1]) + mul(__ldg(Rm + 6 + j), y3[2]);
  const float q0 = row3(K, 0, r3[0], r3[1], r3[2]);
  const float q1 = row3(K, 1, r3[0], r3[1], r3[2]);
  const float q2 = row3(K, 2, r3[0], r3[1], r3[2]);
  const float qz = fabsf(q2) < 1e-8f ? 1e-8f : q2;
  const float ex = q0 / qz - x;
  const float ey = q1 / qz - y;
  const float err = sqrtf(mul(ex, ex) + mul(ey, ey));
  const bool ok = ds.y > 0.f && ds.x > 0.f && r3[2] > 0.f;
  // torch.minimum: NaN stays NaN
  return ok ? ((err < p.max_cost || isnan(err)) ? err : p.max_cost) : p.max_cost;
}

// (total, photo) into the best k by total, ascending; a later source ties
// behind an earlier one (the stable sort's order)
__device__ __forceinline__ void keep_best(float c, float ph, int k, float (&tv)[MAX_TOP_K],
                                          float (&pv)[MAX_TOP_K]) {
#pragma unroll
  for (int j = MAX_TOP_K - 1; j >= 1; --j) {
    if (j < k) {
      if (c < tv[j - 1]) {  // c goes above rank j: shift rank j - 1 down
        tv[j] = tv[j - 1];
        pv[j] = pv[j - 1];
      } else if (c < tv[j]) {
        tv[j] = c;
        pv[j] = ph;
      }
    }
  }
  if (c < tv[0]) {
    tv[0] = c;
    pv[0] = ph;
  }
}

// one group of NG sources (s0 .. s0+NG-1, warped in wt): the window sums in
// registers, then each source's cost into the best k. The thread's weight
// of tap i is wcol[i * wstep].
template <int R, bool BILATERAL, int NG>
__device__ __forceinline__ void sweep_group(const Params& p, const Geo<R>& g, const float2* wt,
                                            const float* rsm, const float* wcol, size_t wstep,
                                            int base, int d, int s0, float x, float y,
                                            const float (&term)[3], float (&tv)[MAX_TOP_K],
                                            float (&pv)[MAX_TOP_K]) {
  float s_a[NG], s_aa[NG], s_ra[NG], s_v[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) s_a[j] = s_aa[j] = s_ra[j] = s_v[j] = 0.f;
#pragma unroll 1
  for (int dy = 0; dy < g.side; ++dy) {
    const int q0 = base + dy * g.hw;
    const float* wrow = wcol + static_cast<size_t>(dy * g.side) * wstep;
#pragma unroll
    for (int dx = 0; dx < g.side; ++dx) {
      const int q = q0 + dx;
      if (BILATERAL) {
        // the plain route's Ww, Www, Wrw and Wv, tap by tap in offset order
        const float w = wrow[dx * wstep];
        const float wr = mul(w, rsm[q]);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const float2 sv = wt[j * g.hn + q];
          const float a = mul(w, sv.x);
          s_a[j] += a;
          s_aa[j] += mul(a, sv.x);
          s_ra[j] += mul(wr, sv.x);
          s_v[j] += mul(w, sv.y);
        }
      } else {
        // the box sums of the warped values, their squares, their products
        // with the reference and the validity, zero outside the image
        const float rq = rsm[q];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const float2 sv = wt[j * g.hn + q];
          s_a[j] += sv.x;
          s_aa[j] += mul(sv.x, sv.x);
          s_ra[j] += mul(rq, sv.x);
          s_v[j] += sv.y;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    float cost;
    if (BILATERAL) {
      const float wsum = term[0], mu_r = term[1], var_r = term[2];
      const float mu_w = s_a[j] / wsum;
      float var_w = s_aa[j] / wsum - mul(mu_w, mu_w);
      var_w = var_w < 1e-8f ? 1e-8f : var_w;
      const float cov = s_ra[j] / wsum - mul(mu_r, mu_w);
      const float ncc = cov / sqrtf(mul(var_r, var_w));
      cost = s_v[j] > mul(0.8f, wsum) ? 1.f - clampf(ncc, -1.f, 1.f) : 2.f;
    } else {
      const float n = static_cast<float>(g.side * g.side);
      const float s_r = term[0], s_rr = term[1];
      const float s_w = s_a[j] / n, s_ww = s_aa[j] / n, s_rw = s_ra[j] / n;
      float var_r = s_rr - mul(s_r, s_r);
      var_r = var_r < 1e-8f ? 1e-8f : var_r;
      float var_w = s_ww - mul(s_w, s_w);
      var_w = var_w < 1e-8f ? 1e-8f : var_w;
      const float ncc = (s_rw - mul(s_r, s_w)) / sqrtf(mul(var_r, var_w));
      cost = s_v[j] > p.valid_min ? 1.f - clampf(ncc, -1.f, 1.f) : 2.f;
    }
    float total = cost;
    if (p.src_depths != nullptr) {
      const int s = s0 + j;
      total = cost + mul(p.reg, geom_cost(p, s, p.homs + (static_cast<size_t>(d) * p.S + s) * 9, x, y));
    }
    keep_best(total, cost, p.k, tv, pv);
  }
}

template <int R, bool BILATERAL>
__global__ void __launch_bounds__(max_threads(R), 1) plane_sweep_kernel(const Params p) {
  const Geo<R> g(p.radius);
  const int r = R > 0 ? R : p.radius;
  constexpr bool STAGED = BILATERAL && R > 0;
  extern __shared__ float4 smem_raw[];
  float2* wt = reinterpret_cast<float2*>(smem_raw);    // [GROUP][hn] warped (value, valid)
  float* rsm = reinterpret_cast<float*>(wt + GROUP * g.hn);  // [hn] reference
  float* wsm = rsm + g.hn;                             // [taps][threads] staged weights
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int bx = blockIdx.x * TX, by = blockIdx.y * g.ty;
  const int x = bx + tx, y = by + ty;
  const bool inside = x < p.W && y < p.H;
  const size_t plane = static_cast<size_t>(p.H) * p.W;
  const size_t pix = static_cast<size_t>(inside ? y : 0) * p.W + (inside ? x : 0);

  // the reference over the tile and its halo: replicated at the border for
  // the bilateral window, zero outside the image for the box sums
  for (int q = tid; q < g.hn; q += g.threads) {
    const int hy = q / g.hw, hx = q - hy * g.hw;
    const int gy = by + hy - r, gx = bx + hx - r;
    float v;
    if (BILATERAL) {
      v = __ldg(p.ref + static_cast<size_t>(min(max(gy, 0), p.H - 1)) * p.W + min(max(gx, 0), p.W - 1));
    } else {
      const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      v = in ? __ldg(p.ref + static_cast<size_t>(gy) * p.W + gx) : 0.f;
    }
    rsm[q] = v;
  }
  if (STAGED) {
    for (int k = 0; k < g.side * g.side; ++k)
      wsm[k * g.threads + tid] = inside ? __ldg(p.weights + k * plane + pix) : 0.f;
  }
  // the thread's weights: staged in shared memory, or the planes themselves
  const float* wcol = STAGED ? wsm + tid : (BILATERAL ? p.weights + pix : nullptr);
  const size_t wstep = STAGED ? static_cast<size_t>(g.threads) : plane;
  float term[3] = {__ldg(p.term0 + pix), __ldg(p.term1 + pix), BILATERAL ? __ldg(p.term2 + pix) : 0.f};
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  const int base = ty * g.hw + tx;

  float best_cost = p.big, best_photo = 2.f, best_depth = __ldg(p.depths);
  for (int d = 0; d < p.D; ++d) {
    float tv[MAX_TOP_K], pv[MAX_TOP_K];
#pragma unroll
    for (int j = 0; j < MAX_TOP_K; ++j) tv[j] = pv[j] = INFINITY;
    for (int s0 = 0; s0 < p.S;) {
      const int left = p.S - s0;
      const int ng = left >= 4 ? 4 : (left >= 2 ? 2 : 1);
      __syncthreads();  // the last group's sums are done with wt
      // warp the group's sources over the tile and its halo
      for (int i = tid; i < ng * g.hn; i += g.threads) {
        const int j = i / g.hn, q = i - j * g.hn;
        const int hy = q / g.hw, hx = q - hy * g.hw;
        int gy = by + hy - r, gx = bx + hx - r;
        float2 v = make_float2(0.f, 0.f);
        const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        if (BILATERAL || in) {
          gy = min(max(gy, 0), p.H - 1);
          gx = min(max(gx, 0), p.W - 1);
          const int s = s0 + j;
          float sx, sy;
          warp_coords(p.homs + (static_cast<size_t>(d) * p.S + s) * 9, static_cast<float>(gx),
                      static_cast<float>(gy), sx, sy);
          v = sample(p.srcs + static_cast<size_t>(s) * p.Hs * p.Ws, p.Hs, p.Ws, sx, sy);
        }
        wt[i] = v;
      }
      __syncthreads();
      if (inside) {
        if (ng == 4)
          sweep_group<R, BILATERAL, 4>(p, g, wt, rsm, wcol, wstep, base, d, s0, fx, fy, term, tv, pv);
        else if (ng == 2)
          sweep_group<R, BILATERAL, 2>(p, g, wt, rsm, wcol, wstep, base, d, s0, fx, fy, term, tv, pv);
        else
          sweep_group<R, BILATERAL, 1>(p, g, wt, rsm, wcol, wstep, base, d, s0, fx, fy, term, tv, pv);
      }
      s0 += ng;
    }
    if (inside) {
      // the best k in rank order, averaged; the first depth among equals
      float total = tv[0], photo = pv[0];
#pragma unroll
      for (int j = 1; j < MAX_TOP_K; ++j) {
        if (j < p.k) {
          total += tv[j];
          photo += pv[j];
        }
      }
      const float kf = static_cast<float>(p.k);
      total = total / kf;
      photo = photo / kf;
      if (total < best_cost) {
        best_cost = total;
        best_photo = photo;
        best_depth = __ldg(p.depths + d);
      }
    }
  }
  if (inside) {
    p.best_depth[pix] = best_depth;
    p.best_photo[pix] = best_photo;
  }
}

// R = 0: the radius is read at launch and the weights from global memory
template <int R, bool BILATERAL>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int r = R > 0 ? R : p.radius, ty = tile_rows(r);
  const size_t smem = smem_bytes(r, ty, BILATERAL && R > 0);
  cudaError_t err = cudaFuncSetAttribute(plane_sweep_kernel<R, BILATERAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + TX - 1) / TX, (p.H + ty - 1) / ty);
  plane_sweep_kernel<R, BILATERAL><<<grid, dim3(TX, ty), smem, stream>>>(p);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_radius(bool bilateral, const Params& p, cudaStream_t stream) {
  if constexpr (R > STAGED_RADIUS) {
    return bilateral ? launch<0, true>(p, stream) : launch<0, false>(p, stream);
  } else {
    if (p.radius != R) return launch_radius<R + 1>(bilateral, p, stream);
    return bilateral ? launch<R, true>(p, stream) : launch<R, false>(p, stream);
  }
}

}  // namespace plane_sweep

using namespace plane_sweep;

extern "C" int plane_sweep_max_radius() { return MAX_RADIUS; }
extern "C" int plane_sweep_max_top_k() { return MAX_TOP_K; }

// weights, term2: bilateral only (null for the box window); src_depths and
// geom: the geometric pass only (null without it)
extern "C" int plane_sweep_launch(const float* ref, const float* srcs, const float* homs,
                                  const float* depths, const float* weights, const float* term0,
                                  const float* term1, const float* term2, const float* src_depths,
                                  const float* geom, int H, int W, int S, int Hs, int Ws, int D,
                                  int radius, int bilateral, int k, float big, float reg,
                                  float max_cost, float valid_min, float* best_depth,
                                  float* best_photo, void* stream) {
  if (radius < 1 || radius > MAX_RADIUS || k < 1 || k > MAX_TOP_K || k > S || D < 1 || H < 1 ||
      W < 1 || Hs < 1 || Ws < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{ref, srcs, homs, depths, weights, term0, term1, term2, src_depths, geom,
           H, W, S, Hs, Ws, D, k, radius, big, reg, max_cost, valid_min, best_depth, best_photo};
  return static_cast<int>(launch_radius<1>(bilateral != 0, p, static_cast<cudaStream_t>(stream)));
}
