// Fused descriptor matching: for every row of d1 against the columns d2 of
// its image pair, the best cosine similarity, the second best and the
// column of the best, without ever writing the similarity matrix.
//
// Replaces the Pallas TPU kernel `match_top2` (colmap_pcd_tpu/ops/
// pallas_kernels.py:77, pallas_call :94, body `_match_kernel` :42), which
// streams 256x1024 tiles of d1 d2^T through VMEM on the MXU and carries a
// running (best, second, argbest) per row across its sequential grid.
//
// What bounds it on Hopper: f32 FMA issue. The matcher's chunk is B = 16
// image pairs of up to 2048 x 2048 descriptors of 128 floats, 2 x 16 x
// 2048^2 x 128 x 2 = 34 GFLOP with the cross-check's transposed launch;
// the inputs (16 MB each) sit in L2. This is the route for float
// descriptors (the guided matcher, any caller with normalized f32 rows); the
// matcher's uint8 descriptors go through csrc/match_top2_u8.cu, which forms
// the products on the integer tensor cores and is exact for another reason.
// Design (f32 FMAs, so that it can be held exactly against its plain
// version):
//   * a block owns TQ = 64 rows of d1 for one pair and keeps them in shared
//     memory for its whole column loop; tiles of TN = 64 columns of d2 are
//     staged through shared memory; 256 threads each compute a 4 x 4
//     micro-tile with float4 shared-memory reads (row stride 132 floats:
//     the column reads of a quarter-warp hit 32 distinct banks);
//   * sim(i, j) is accumulated over k = 0..127 in one fixed order with
//     fmaf, starting from 0. fmaf(a, b, c) == fmaf(b, a, c), so the
//     cross-check's launch on (d2, d1) forms bit-identical similarities
//     and near-ties cannot flip the cross-check;
//   * each thread folds its columns, in increasing order, into a running
//     top-2 per row; the 16 threads that share rows merge with warp
//     shuffles. The merge takes the larger best, the lower column on equal
//     bests, and the larger of the rest as second: ties go to the lowest
//     column, as argmax breaks them;
//   * invalid columns (valid2 <= 0) count as -2, as the plain version masks
//     them; ragged row and column edges are masked here, so neither input
//     is padded;
//   * a pair block of few rows (B = 1, or ragged pairs) would leave SMs
//     idle, so the grid also splits the columns: grid = (row tiles, column
//     splits, pairs); each block writes a partial top-2 and a second small
//     kernel merges the splits in order.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns the CUDA error code of the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int D = 128;         // descriptor width
constexpr int TQ = 64;         // rows of d1 per block
constexpr int TN = 64;         // columns per shared-memory tile
constexpr int LD = D + 4;      // padded shared row stride, floats
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 results each
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_BYTES = (size_t)(TQ * LD + TN * LD + TN) * sizeof(float);

// merge (c1, k1, c2) into (b1, i1, b2): symmetric, so both lanes of a
// shuffle butterfly hold the same result
__device__ __forceinline__ void merge(float& b1, int& i1, float& b2, float c1, int k1,
                                      float c2) {
  if (c1 > b1) {
    b2 = fmaxf(c2, b1);
    b1 = c1;
    i1 = k1;
  } else if (c1 < b1) {
    b2 = fmaxf(b2, c1);
  } else {
    i1 = min(i1, k1);
    b2 = b1;
  }
}

__global__ void __launch_bounds__(THREADS)
top2_partial_kernel(const float* __restrict__ d1, int N1, const float* __restrict__ d2,
                    int N2, const float* __restrict__ valid2, int chunk,
                    float* __restrict__ part_b1, int* __restrict__ part_i1,
                    float* __restrict__ part_b2) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;            // [TQ][LD]
  float* Bs = As + TQ * LD;    // [TN][LD]
  float* Vs = Bs + TN * LD;    // [TN] 1 = valid column

  const int pair = blockIdx.z;
  const int npairs = gridDim.z;
  const int row0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int col_begin = split * chunk;
  const int col_end = min(N2, col_begin + chunk);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* A = d1 + (size_t)pair * N1 * D;
  const float* Bm = d2 + (size_t)pair * N2 * D;
  const float* V = valid2 + (size_t)pair * N2;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the block's rows stay in shared memory for the whole column loop
  for (int f = tid; f < TQ * (D / 4); f += THREADS) {
    const int r = f / (D / 4), kq = f % (D / 4);
    float4 v = zero4;
    if (row0 + r < N1) v = reinterpret_cast<const float4*>(A + (size_t)(row0 + r) * D)[kq];
    *reinterpret_cast<float4*>(As + r * LD + 4 * kq) = v;
  }

  float b1[4], b2[4];
  int i1[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    b1[r] = -INFINITY;
    b2[r] = -INFINITY;
    i1[r] = INT_MAX;
  }

  for (int base = col_begin; base < col_end; base += TN) {
    __syncthreads();  // the previous tile is consumed (and As is written)
    for (int f = tid; f < TN * (D / 4); f += THREADS) {
      const int c = f / (D / 4), kq = f % (D / 4);
      float4 v = zero4;
      if (base + c < col_end) v = reinterpret_cast<const float4*>(Bm + (size_t)(base + c) * D)[kq];
      *reinterpret_cast<float4*>(Bs + c * LD + 4 * kq) = v;
    }
    if (tid < TN) Vs[tid] = (base + tid < col_end && V[base + tid] > 0.f) ? 1.f : 0.f;
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

#pragma unroll 4
    for (int k = 0; k < D; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(As + (ty + 16 * r) * LD + k);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * c) * LD + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = acc[r][c];
          s = fmaf(a[r].x, b[c].x, s);
          s = fmaf(a[r].y, b[c].y, s);
          s = fmaf(a[r].z, b[c].z, s);
          s = fmaf(a[r].w, b[c].w, s);
          acc[r][c] = s;
        }
    }

    // fold this tile's columns, in increasing order, into the running top-2
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = base + tx + 16 * c;
      if (col < col_end) {
        const bool ok = Vs[tx + 16 * c] > 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = ok ? acc[r][c] : -2.f;
          if (v > b1[r]) {
            b2[r] = b1[r];
            b1[r] = v;
            i1[r] = col;
          } else {
            b2[r] = fmaxf(b2[r], v);
          }
        }
      }
    }
  }

  // merge the 16 threads (one half-warp) that share each row
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float c1 = __shfl_xor_sync(FULL, b1[r], off);
      const int k1 = __shfl_xor_sync(FULL, i1[r], off);
      const float c2 = __shfl_xor_sync(FULL, b2[r], off);
      merge(b1[r], i1[r], b2[r], c1, k1, c2);
    }
    const int row = row0 + ty + 16 * r;
    if (tx == 0 && row < N1) {
      const size_t o = ((size_t)split * npairs + pair) * N1 + row;
      part_b1[o] = b1[r];
      part_i1[o] = i1[r];
      part_b2[o] = b2[r];
    }
  }
}

__global__ void top2_reduce_kernel(const float* __restrict__ part_b1,
                                   const int* __restrict__ part_i1,
                                   const float* __restrict__ part_b2, int rows, int splits,
                                   float* __restrict__ s1, float* __restrict__ s2,
                                   int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float b1 = part_b1[i], b2 = part_b2[i];
  int i1 = part_i1[i];
  for (int s = 1; s < splits; ++s) {
    const size_t o = (size_t)s * rows + i;
    merge(b1, i1, b2, part_b1[o], part_i1[o], part_b2[o]);
  }
  s1[i] = b1;
  s2[i] = fmaxf(b2, -2.f);  // the best column itself counts as -2
  idx[i] = i1;
}

}  // namespace

extern "C" int match_top2_tile_rows() { return TQ; }
extern "C" int match_top2_tile_cols() { return TN; }
extern "C" int match_top2_width() { return D; }

extern "C" int match_top2_launch(const float* d1, int N1, const float* d2, int N2,
                                 const float* valid2, int B, int chunk, int splits,
                                 float* part_b1, int* part_i1, float* part_b2, float* s1,
                                 float* s2, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      top2_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N1 + TQ - 1) / TQ, splits, B);
  top2_partial_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(d1, N1, d2, N2, valid2, chunk, part_b1,
                                                        part_i1, part_b2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * N1;
  top2_reduce_kernel<<<(rows + 255) / 256, 256, 0, s>>>(part_b1, part_i1, part_b2, rows, splits,
                                                        s1, s2, idx);
  return static_cast<int>(cudaGetLastError());
}
