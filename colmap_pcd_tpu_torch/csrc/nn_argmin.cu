// Exact 1-nearest-neighbour of each query among the lidar map points.
//
// Replaces the Pallas TPU kernel `nn_argmin` (colmap_pcd_tpu/ops/
// pallas_kernels.py:175, body `_nn_kernel` :150), which streams 256x2048
// tiles through VMEM and forms d^2 = |q|^2 + |p|^2 - 2 q.p on the MXU. That
// identity cancels catastrophically at map scale (50-100 m coordinates give
// |q|^2 ~ 1e4 against d^2 ~ 1e-2 in f32), so here d^2 = (q-p).(q-p) is
// formed directly with f32 FMAs. A 3-wide contraction gains nothing from
// tensor cores.
//
// What bounds it on Hopper: FP32 issue. Each (query, point) pair costs
// 3 FSUB + 1 FMUL + 2 FFMA + a compare/select; Q = 4096 queries against a
// 0.5 M-point map is 2e9 pairs, ~0.5 ms of the card's f32 pipes, while the
// map itself (6 MB) sits in L2. The design keeps those pipes fed:
//   * one query per thread, held in registers; map tiles of TN points are
//     staged through shared memory and read back as warp-wide broadcasts
//     (every lane reads the same address, so no bank conflicts);
//   * the mapper sends only ~4096 queries (16 blocks of 256), which would
//     leave most of the 132 SMs idle, so the grid also splits the MAP:
//     grid = (query tiles, map splits). Each block writes a partial
//     (d^2, index) for its split into scratch, and a second small kernel
//     reduces the splits;
//   * ties resolve to the lowest index, as argmin does: points are scanned
//     in increasing index within a split with a strict '<', and splits are
//     reduced in increasing order with a strict '<';
//   * no sentinels: ragged query and map edges are masked here, so neither
//     input is padded.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after both launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 256;   // queries per block, one per thread
constexpr int TN = 2048;  // map points per shared-memory tile (24 KB)

__global__ void __launch_bounds__(TQ)
nn_partial_kernel(const float* __restrict__ queries, int Q,
                  const float* __restrict__ points, int N, int chunk,
                  float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float tile[3 * TN];
  const int qi = blockIdx.x * TQ + threadIdx.x;
  const int split = blockIdx.y;
  const int begin = split * chunk;
  const int end = min(N, begin + chunk);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = queries[3 * qi + 0];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }
  float best = INFINITY;
  int best_i = begin;
  for (int base = begin; base < end; base += TN) {
    const int n = min(TN, end - base);
    __syncthreads();  // the previous tile is fully consumed
    const float* src = points + 3 * (size_t)base;
    for (int k = threadIdx.x; k < 3 * n; k += TQ) tile[k] = src[k];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float dx = qx - tile[3 * j + 0];
      const float dy = qy - tile[3 * j + 1];
      const float dz = qz - tile[3 * j + 2];
      const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (qi < Q) {
    part_d[(size_t)split * Q + qi] = best;
    part_i[(size_t)split * Q + qi] = best_i;
  }
}

__global__ void nn_reduce_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i, int Q,
                                 int splits, int* __restrict__ out_idx,
                                 float* __restrict__ out_dist) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  float best = part_d[qi];
  int best_i = part_i[qi];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(size_t)s * Q + qi];
    if (d < best) {
      best = d;
      best_i = part_i[(size_t)s * Q + qi];
    }
  }
  out_idx[qi] = best_i;
  out_dist[qi] = sqrtf(fmaxf(best, 0.f));
}

}  // namespace

extern "C" int nn_argmin_tile_points() { return TN; }

extern "C" int nn_argmin_launch(const float* queries, int Q, const float* points,
                                int N, int chunk, int splits, float* part_d,
                                int* part_i, int* out_idx, float* out_dist,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + TQ - 1) / TQ, splits);
  nn_partial_kernel<<<grid, TQ, 0, s>>>(queries, Q, points, N, chunk, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_reduce_kernel<<<(Q + 255) / 256, 256, 0, s>>>(part_d, part_i, Q, splits, out_idx,
                                                   out_dist);
  return static_cast<int>(cudaGetLastError());
}
