// Exact 1-nearest-neighbour of each query among the lidar map points.
//
// Replaces the Pallas TPU kernel `nn_argmin` (colmap_pcd_tpu/ops/
// pallas_kernels.py:175, pallas_call :191, body `_nn_kernel` :150), which
// streams 256x2048 tiles through VMEM and forms d^2 = |q|^2 + |p|^2 - 2 q.p
// on the MXU. That identity cancels catastrophically at map scale (50-100 m
// coordinates give |q|^2 ~ 1e4 against d^2 ~ 1e-2 in f32), and TF32 or bf16
// operands cannot hold 50 m coordinates to millimetres, so this kernel stays
// off the tensor cores: d^2 = (q-p).(q-p) in f32, 3 FADD + 1 FMUL + 2 FFMA.
//
// What bounds it on Hopper: f32 instruction slots. Q = 4096 queries against a
// 0.5 M-point map is 2e9 pairs while the map (8 MB as float4) sits in L2;
// the six arithmetic instructions per pair alone are ~0.37 ms of the card.
// The design spends as little as it can beside them:
//   * the map is float4 per point (x, y, z, unused), so one 16-byte load
//     brings a point;
//   * selection costs ~1.2 slots per pair instead of 3: per group of 16
//     points a query keeps only the running minimum (one FMNMX per pair) and
//     notes the group in which it last fell (a compare and two selects per
//     group); at the end the one noted group is scanned again for the lowest
//     index that attains the minimum. Groups are visited in increasing index
//     with a strict '<', so ties go to the lowest index;
//   * many queries (`nn_scan_queries_kernel`): every thread holds 4 queries
//     in registers and all threads scan the same map tile from shared
//     memory, so one broadcast LDS.128 serves 4 x 32 pairs. Tiles of 512
//     points are double-buffered by one TMA bulk copy each, signalled by an
//     `mbarrier`, so the next tile loads while this one is scanned. The grid
//     also splits the map, since 4096 queries are only 8 blocks;
//   * few queries (`nn_scan_points_kernel`, the mapper's local BA sends
//     tens): all threads of a block hold the same 8 queries and split the
//     POINTS among them, each thread reading its own points with coalesced
//     16-byte loads, so no lane idles; the threads' (d^2, index) merge by
//     warp shuffles and through shared memory, lexicographically;
//   * queries per thread, group sizes and the switch between the two scans
//     were chosen by measurement on the card (PERF.md);
//   * both write one partial (d^2, index) per query and map split; a second
//     small kernel takes the lexicographic minimum over the splits.
// Ragged edges are masked here (points past the end stand 1e18 m away), so
// neither input is padded.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() after both launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float FAR = 1e18f;  // (q - FAR)^2 stays finite and above any real d^2

// many queries: queries in registers, map tiles broadcast from shared memory
constexpr int QT_THREADS = 128;
constexpr int QT_QPT = 4;    // queries per thread
constexpr int QT_G = 16;     // points per selection group
constexpr int QT_TN = 512;   // points per tile (8 KB)
constexpr int QT_STAGES = 2;
// few queries: the block's threads split the points
constexpr int PT_THREADS = 256;
constexpr int PT_QPT = 8;    // queries per block, held by every thread
constexpr int PT_G = 4;      // points per thread and selection group

__device__ __forceinline__ float dist2(float qx, float qy, float qz, const float4& p) {
  const float dx = qx - p.x;
  const float dy = qy - p.y;
  const float dz = qz - p.z;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

__device__ __forceinline__ bool closer(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1 << 22)) __trap();  // a copy that never lands is a bug here
  }
}

// one TMA bulk copy of `bytes` (a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the lowest index of the noted group that attains the minimum
template <int G>
__device__ __forceinline__ int rescan(const float4* __restrict__ points, int first, int stride,
                                      int end, float qx, float qy, float qz, float best) {
  int res = min(first, end - 1);
#pragma unroll
  for (int j = G - 1; j >= 0; --j) {
    const int i = first + j * stride;
    if (i < end && dist2(qx, qy, qz, __ldg(points + i)) == best) res = i;
  }
  return res;
}

__global__ void __launch_bounds__(QT_THREADS)
nn_scan_queries_kernel(const float* __restrict__ queries, int Q,
                       const float4* __restrict__ points, int N, int chunk,
                       float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ __align__(128) float4 tile[QT_STAGES][QT_TN];
  __shared__ __align__(8) uint64_t full[QT_STAGES];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * (QT_THREADS * QT_QPT) + tid;
  const int split = blockIdx.y;
  const int begin = split * chunk;
  const int end = min(N, begin + chunk);
  const int ntiles = (end - begin + QT_TN - 1) / QT_TN;

  float qx[QT_QPT], qy[QT_QPT], qz[QT_QPT], best[QT_QPT];
  int first[QT_QPT];
#pragma unroll
  for (int k = 0; k < QT_QPT; ++k) {
    const int qi = q0 + k * QT_THREADS;
    const bool in = qi < Q;
    qx[k] = in ? queries[3 * qi + 0] : 0.f;
    qy[k] = in ? queries[3 * qi + 1] : 0.f;
    qz[k] = in ? queries[3 * qi + 2] : 0.f;
    best[k] = INFINITY;
    first[k] = begin;
  }

  if (tid == 0) {
    for (int s = 0; s < QT_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(QT_STAGES, ntiles); ++t) {
      const int base = begin + t * QT_TN;
      bulk_load(smem_u32(tile[t]), points + base, min(QT_TN, end - base) * 16, smem_u32(&full[t]));
    }
  }
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % QT_STAGES;
    const int base = begin + t * QT_TN;
    const int n = min(QT_TN, end - base);
    mbar_wait(smem_u32(&full[s]), (t / QT_STAGES) & 1);
    if (n % QT_G) {  // the map's last tile: far points fill its last group
      if (tid < QT_G - n % QT_G) tile[s][n + tid] = make_float4(FAR, FAR, FAR, 0.f);
      __syncthreads();
    }
    const int ngroups = (n + QT_G - 1) / QT_G;
    for (int g = 0; g < ngroups; ++g) {
      float4 p[QT_G];
#pragma unroll
      for (int j = 0; j < QT_G; ++j) p[j] = tile[s][g * QT_G + j];
#pragma unroll
      for (int k = 0; k < QT_QPT; ++k) {
        float m = best[k];
#pragma unroll
        for (int j = 0; j < QT_G; ++j) m = fminf(m, dist2(qx[k], qy[k], qz[k], p[j]));
        if (m < best[k]) {
          best[k] = m;
          first[k] = base + g * QT_G;
        }
      }
    }
    __syncthreads();  // the tile is consumed: its stage takes tile t + STAGES
    if (tid == 0 && t + QT_STAGES < ntiles) {
      const int nb = begin + (t + QT_STAGES) * QT_TN;
      bulk_load(smem_u32(tile[s]), points + nb, min(QT_TN, end - nb) * 16, smem_u32(&full[s]));
    }
  }

#pragma unroll
  for (int k = 0; k < QT_QPT; ++k) {
    const int qi = q0 + k * QT_THREADS;
    if (qi < Q) {
      part_d[(size_t)split * Q + qi] = best[k];
      part_i[(size_t)split * Q + qi] =
          rescan<QT_G>(points, first[k], 1, end, qx[k], qy[k], qz[k], best[k]);
    }
  }
}

__global__ void __launch_bounds__(PT_THREADS)
nn_scan_points_kernel(const float* __restrict__ queries, int Q,
                      const float4* __restrict__ points, int N, int chunk,
                      float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float red_d[PT_THREADS / 32][PT_QPT];
  __shared__ int red_i[PT_THREADS / 32][PT_QPT];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * PT_QPT;
  const int split = blockIdx.y;
  const int begin = split * chunk;
  const int end = min(N, begin + chunk);

  float qx[PT_QPT], qy[PT_QPT], qz[PT_QPT], best[PT_QPT];
  int first[PT_QPT];
#pragma unroll
  for (int k = 0; k < PT_QPT; ++k) {
    const int qi = min(q0 + k, Q - 1);
    qx[k] = queries[3 * qi + 0];
    qy[k] = queries[3 * qi + 1];
    qz[k] = queries[3 * qi + 2];
    best[k] = INFINITY;
    first[k] = begin + tid;
  }

  const float4 far = make_float4(FAR, FAR, FAR, 0.f);
  for (int i = begin + tid; i < end; i += PT_G * PT_THREADS) {
    float4 p[PT_G];
#pragma unroll
    for (int j = 0; j < PT_G; ++j) {
      const int pi = i + j * PT_THREADS;
      p[j] = pi < end ? __ldg(points + pi) : far;
    }
#pragma unroll
    for (int k = 0; k < PT_QPT; ++k) {
      float m = best[k];
#pragma unroll
      for (int j = 0; j < PT_G; ++j) m = fminf(m, dist2(qx[k], qy[k], qz[k], p[j]));
      if (m < best[k]) {
        best[k] = m;
        first[k] = i;
      }
    }
  }

  // each thread's exact (d^2, index), then the block's lexicographic minimum
#pragma unroll
  for (int k = 0; k < PT_QPT; ++k) {
    float d = best[k];
    int i = rescan<PT_G>(points, first[k], PT_THREADS, end, qx[k], qy[k], qz[k], d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, d, off);
      const int oi = __shfl_xor_sync(FULL, i, off);
      if (closer(od, oi, d, i)) {
        d = od;
        i = oi;
      }
    }
    if ((tid & 31) == 0) {
      red_d[tid >> 5][k] = d;
      red_i[tid >> 5][k] = i;
    }
  }
  __syncthreads();
  if (tid < PT_QPT && q0 + tid < Q) {
    float d = red_d[0][tid];
    int i = red_i[0][tid];
    for (int w = 1; w < PT_THREADS / 32; ++w)
      if (closer(red_d[w][tid], red_i[w][tid], d, i)) {
        d = red_d[w][tid];
        i = red_i[w][tid];
      }
    part_d[(size_t)split * Q + q0 + tid] = d;
    part_i[(size_t)split * Q + q0 + tid] = i;
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
    const int i = part_i[(size_t)s * Q + qi];
    if (closer(d, i, best, best_i)) {
      best = d;
      best_i = i;
    }
  }
  out_idx[qi] = best_i;
  out_dist[qi] = sqrtf(fmaxf(best, 0.f));
}

}  // namespace

// the granule of a map split and the queries a block serves, per mode
// (0 = many queries, 1 = few queries)
extern "C" int nn_argmin_split_granule(int mode) { return mode ? PT_THREADS * PT_G : QT_TN; }
extern "C" int nn_argmin_block_queries(int mode) { return mode ? PT_QPT : QT_THREADS * QT_QPT; }

// points4: [N][4] f32 (x, y, z, unused), 16-byte aligned; chunk: a multiple
// of the mode's granule
extern "C" int nn_argmin_launch(const float* queries, int Q, const float* points4,
                                int N, int mode, int chunk, int splits, float* part_d,
                                int* part_i, int* out_idx, float* out_dist,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* points = reinterpret_cast<const float4*>(points4);
  if (mode) {
    const dim3 grid((Q + PT_QPT - 1) / PT_QPT, splits);
    nn_scan_points_kernel<<<grid, PT_THREADS, 0, s>>>(queries, Q, points, N, chunk, part_d, part_i);
  } else {
    const dim3 grid((Q + QT_THREADS * QT_QPT - 1) / (QT_THREADS * QT_QPT), splits);
    nn_scan_queries_kernel<<<grid, QT_THREADS, 0, s>>>(queries, Q, points, N, chunk, part_d, part_i);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_reduce_kernel<<<(Q + 255) / 256, 256, 0, s>>>(part_d, part_i, Q, splits, out_idx, out_dist);
  return static_cast<int>(cudaGetLastError());
}
