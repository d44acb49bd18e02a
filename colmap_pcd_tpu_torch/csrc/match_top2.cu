// Fused descriptor matching: for every row of d1 against the columns d2 of
// its image pair, the best cosine similarity, the second best and the
// column of the best; and, for the cross-check, the best row of every
// column, from the same similarities in the same launch. The similarity
// matrix is never written.
//
// Replaces the Pallas TPU kernel `match_top2` (colmap_pcd_tpu/ops/
// pallas_kernels.py:77, pallas_call :94, body `_match_kernel` :42), which
// streams 256x1024 tiles of d1 d2^T through VMEM on the MXU and carries a
// running (best, second, argbest) per row across its sequential grid; the
// JAX package then takes the cross-check's column argmax from a second pass.
//
// What bounds it on Hopper: f32 FMA issue. One cross-checked call on the
// matcher's largest chunk (16 pairs at cap 8192) is 275 G f32 operations,
// 4.1 ms at the card's 67 TFLOP/s outside the tensor cores; the inputs
// (64 MB a side) stream through L2. The tensor cores were measured and
// rejected: 3xTF32 (hi = rna(x), lo = rna(x - hi), three products) through
// `wgmma` lands 1.9-2.0e-6 from float64 on unit SIFT-like descriptors, with
// a mean bias of -1.0e-6 from the accumulator's truncation, where the
// callers hold the kernel to the plain f32 product at 1e-6
// (scripts/torch_k1_numerics.py). The uint8 route (csrc/match_top2_u8.cu)
// is exact on the integer tensor cores for another reason. Design:
//   * a block owns TM = 128 rows of d1, loaded once by TMA, and streams
//     TN = 128-column tiles of d2 through a ring of 2 shared-memory stages:
//     TMA copies (each tile in four 32-float k chunks with the 128-byte
//     swizzle, rows past N zero-filled) signalled by `mbarrier`s, so one
//     tile's products and epilogue overlap the next tile's load. Warp 0
//     refills a stage once every warp is done with it; no warp is spent on
//     loads alone, so every thread may hold the 8 x 8 tile, its operands
//     and the next step's in registers (a 288-thread block is allotted 168);
//   * 256 threads (16 x 16) each form an 8 x 8 register tile of
//     similarities, rows ty + 16 i and columns tx + 16 j: per 4-deep k step,
//     16 float4 shared-memory reads feed 256 FMAs. The swizzle puts a row's
//     16-byte unit u at u ^ (row & 7), so the 8 rows a quarter-warp reads
//     hit 8 distinct bank groups, and the rows that share ty are broadcast;
//   * sim(i, j) is accumulated over k = 0..127 in one fixed order with fmaf
//     from 0, the order of the plain f32 product on the card;
//   * rows: each thread folds its columns in increasing order into a
//     running top-2 per row (strict '>', so ties keep the lowest column);
//     the 16 threads that share rows merge with warp shuffles. Invalid
//     columns (valid2 <= 0) count as -2 and columns past the ragged edge as
//     -inf, from a per-tile table that warp 0 writes;
//   * columns (the cross-check): the same registers fold, per column, into
//     the best valid row (valid1 > 0; other rows and rows past the edge do
//     not vote). The key is the order-preserving bits of the similarity in
//     the high word and 0xFFFFFFFF - row in the low word, so one unsigned
//     max picks the largest similarity and, among equals, the lowest row,
//     as argmax does. The 8 warps' keys meet by shared-memory atomicMax in
//     the stage's key slots; warp 0 merges them with one 64-bit atomicMax
//     per column and tile into global memory, whatever the order of the row
//     blocks, when it refills the stage. The wrapper fills that scratch with the
//     key of (-inf, row 0) first, so a column no valid row votes for
//     reports row 0, as argmax over all -2 does;
//   * a pair block of few rows (B = 1, or ragged pairs) would leave SMs
//     idle, so the grid also splits the columns: grid = (row tiles, column
//     splits, pairs); the splits write partial top-2s and a second small
//     kernel merges them in order and turns the column keys into rows.
//     With one split and no cross-check the main kernel writes the results.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, returns the CUDA error code of the launches (1000 +
// CUresult if a tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;                   // descriptor width, floats
constexpr int TM = 128;                  // rows per block
constexpr int TN = 128;                  // columns per stage
constexpr int KC = 32;                   // floats per swizzled k chunk (128 bytes)
constexpr int STAGES = 2;
constexpr int THREADS = 256;             // 16 x 16 threads, 8 x 8 similarities each
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK_BYTES = TN * KC * 4;  // one k chunk of a tile, 16 KB
constexpr int TILE_BYTES = TN * D * 4;    // 64 KB
constexpr int ROW_STEP = 16 * KC * 4;     // bytes from row r to row r + 16 in a chunk

// the order-preserving bits of -inf, and the key of (-inf, row 0): the
// column scratch's starting value, below every vote (and the empty value of
// a stage's key slots)
constexpr uint32_t NEG_INF_BITS = 0x007FFFFFu;
constexpr unsigned long long SENTINEL = ((unsigned long long)NEG_INF_BITS << 32) | 0xFFFFFFFFull;

// shared-memory map, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows = 1024 bytes)
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + TILE_BYTES;
constexpr int OFF_TABLE = OFF_B + STAGES * TILE_BYTES;  // [STAGES][TN] float2
constexpr int OFF_KEYS = OFF_TABLE + STAGES * TN * 8;   // [STAGES][TN] u64
constexpr int OFF_BAR = OFF_KEYS + STAGES * TN * 8;
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;         // + alignment slack

struct Top2 {
  float b1, b2;
  int i1;
};

// v enters the running top-2; a strict '>' keeps the lowest column on ties
__device__ __forceinline__ void fold(Top2& t, float v, int col) {
  const bool up = v > t.b1;
  t.b2 = fmaxf(t.b2, fminf(t.b1, v));
  t.i1 = up ? col : t.i1;
  t.b1 = fmaxf(t.b1, v);
}

// merge (c1, k1, c2) into t: symmetric, so both lanes of a shuffle butterfly
// hold the same result. Takes the larger best, the lower column on equal
// bests, and the larger of the rest as second
__device__ __forceinline__ void merge(Top2& t, float c1, int k1, float c2) {
  if (c1 > t.b1) {
    t.b2 = fmaxf(c2, t.b1);
    t.b1 = c1;
    t.i1 = k1;
  } else if (c1 < t.b1) {
    t.b2 = fmaxf(t.b2, c1);
  } else {
    t.i1 = min(t.i1, k1);
    t.b2 = t.b1;
  }
}

// bits of v that order as unsigned integers as the floats do (no NaN)
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed; a barrier that
// never completes is a bug in this file, so trap instead of hanging the card
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
    if (spins > (1 << 22)) __trap();
  }
}

// rows [row, row + 128) of one pair of the [B][N][128] f32 tensor into
// shared memory as four k chunks of [128 rows][32 floats], each swizzled;
// rows past N arrive as zeros; completion lands on the mbarrier
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int pair) {
#pragma unroll
  for (int q = 0; q < D / KC; ++q)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst + q * CHUNK_BYTES),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(q * KC), "r"(row), "r"(pair)
        : "memory");
}

// acc[i][j] += sum_k A[ty + 16 i][k] * B[tx + 16 j][k], k = 0..127 in
// order, each product an fmaf into the running sum
__device__ __forceinline__ void products(float (&acc)[8][8], const uint8_t* a, const uint8_t* b,
                                         int ty, int tx) {
#pragma unroll 1
  for (int q = 0; q < D / KC; ++q) {
    const uint8_t* ap = a + q * CHUNK_BYTES + ty * (KC * 4);
    const uint8_t* bp = b + q * CHUNK_BYTES + tx * (KC * 4);
#pragma unroll 2
    for (int u = 0; u < KC / 4; ++u) {
      const int ua = (u ^ (ty & 7)) << 4, ub = (u ^ (tx & 7)) << 4;
      float4 av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(ap + i * ROW_STEP + ua);
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float4*>(bp + j * ROW_STEP + ub);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = acc[i][j];
          s = fmaf(av[i].x, bv[j].x, s);
          s = fmaf(av[i].y, bv[j].y, s);
          s = fmaf(av[i].z, bv[j].z, s);
          s = fmaf(av[i].w, bv[j].w, s);
          acc[i][j] = s;
        }
    }
  }
}

// warp 0's part in stage s before tile t fills it: the tile's column table
// (scale, offset): (1, 0) for a valid column, (0, -2) for an invalid one,
// (0, -inf) past the ragged edge; then the TMA copy, announced on `full`
__device__ __forceinline__ void fill_stage(uint8_t* smem, const CUtensorMap* map2, uint32_t full,
                                           const float* V, int s, int col0, int col_end, int pair,
                                           int lane) {
  float2* table = reinterpret_cast<float2*>(smem + OFF_TABLE) + s * TN;
#pragma unroll
  for (int k = 0; k < TN / 32; ++k) {
    const int c = col0 + lane + 32 * k;
    table[lane + 32 * k] = c >= col_end ? make_float2(0.f, -INFINITY)
                                        : (V[c] > 0.f ? make_float2(1.f, 0.f) : make_float2(0.f, -2.f));
  }
  if (lane == 0) {
    mbar_arrive_expect_tx(full, TILE_BYTES);
    tma_load_rows(smem_u32(smem + OFF_B + s * TILE_BYTES), map2, full, col0, pair);
  } else {
    mbar_arrive(full);
  }
}

template <bool CROSS>
__global__ void __launch_bounds__(THREADS, 1)
top2_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
            int N1, int N2, const float* __restrict__ valid1, const float* __restrict__ valid2,
            int chunk, int final_pass, float* __restrict__ out_b1, int* __restrict__ out_i1,
            float* __restrict__ out_b2, unsigned long long* __restrict__ col_keys) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int pair = blockIdx.z, npairs = gridDim.z;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int col_begin = split * chunk;
  const int col_end = min(N2, col_begin + chunk);
  const int ntiles = (col_end - col_begin + TN - 1) / TN;
  const float* V = valid2 + (size_t)pair * N2;

  const uint32_t bar_full = smem_u32(smem + OFF_BAR);
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_a = bar_empty + 8 * STAGES;
  const float2* table = reinterpret_cast<const float2*>(smem + OFF_TABLE);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + OFF_KEYS);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);       // warp 0's lanes
      mbar_init(bar_empty + 8 * s, THREADS);  // every thread
    }
    mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar_a, TILE_BYTES);
    tma_load_rows(smem_u32(smem + OFF_A), &map1, bar_a, row0, pair);
  }
  if (CROSS && tid < STAGES * TN) keys[tid] = SENTINEL;
  __syncthreads();
  // warp 0 fills the stages ahead and, once every warp is done with a
  // stage, merges its column keys into global memory and fills it again
  if (warp == 0)
    for (int t = 0; t < STAGES && t < ntiles; ++t)
      fill_stage(smem, &map2, bar_full + 8 * t, V, t, col_begin + t * TN, col_end, pair, lane);

  Top2 top[8];
  float vote[8];  // 0 for a row that votes in the column best, -inf for one that does not
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    top[i] = {-INFINITY, -INFINITY, INT_MAX};
    const int r = row0 + ty + 16 * i;
    vote[i] = CROSS && r < N1 && valid1[(size_t)pair * N1 + r] > 0.f ? 0.f : -INFINITY;
  }
  unsigned long long* out_keys = CROSS ? col_keys + (size_t)pair * N2 : nullptr;

  mbar_wait(bar_a, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int col0 = col_begin + t * TN;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    products(acc, smem + OFF_A, smem + OFF_B + s * TILE_BYTES, ty, tx);

    // rows: this tile's columns, in increasing order, into the running top-2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 c = table[s * TN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) fold(top[i], fmaf(acc[i][j], c.x, c.y), col0 + tx + 16 * j);
    }

    if (CROSS) {
      // columns: the best voting row of each of the thread's 8 columns (rows
      // in increasing order, strict '>': the lowest of equals), then of the
      // two threads of the warp that share the column, then of the 8 warps
      // by a shared-memory atomicMax
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float best = -INFINITY;
        int bi = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // + 0 votes (and turns -0 into +0, which argmax does not tell
          // apart); + -inf does not
          const float v = acc[i][j] + vote[i];
          if (v > best) {
            best = v;
            bi = i;
          }
        }
        unsigned long long key = ((unsigned long long)ordered(best) << 32) |
                                 (0xFFFFFFFFu - (uint32_t)(row0 + ty + 16 * bi));
        const unsigned long long other = __shfl_xor_sync(FULL, key, 16);
        key = key > other ? key : other;
        if (lane < 16 && (uint32_t)(key >> 32) != NEG_INF_BITS) atomicMax(keys + s * TN + tx + 16 * j, key);
      }
    }
    mbar_arrive(bar_empty + 8 * s);

    if (warp == 0) {
      mbar_wait(bar_empty + 8 * s, (t / STAGES) & 1);
      if (CROSS) {
#pragma unroll
        for (int k = 0; k < TN / 32; ++k) {
          const int c = lane + 32 * k;
          const unsigned long long m = keys[s * TN + c];
          if (col0 + c < col_end && m != SENTINEL) atomicMax(out_keys + col0 + c, m);
          keys[s * TN + c] = SENTINEL;
        }
      }
      if (t + STAGES < ntiles)
        fill_stage(smem, &map2, bar_full + 8 * s, V, s, col0 + STAGES * TN, col_end, pair, lane);
    }
  }

  // merge the 16 threads (one half-warp) that share each row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float c1 = __shfl_xor_sync(FULL, top[i].b1, off);
      const int k1 = __shfl_xor_sync(FULL, top[i].i1, off);
      const float c2 = __shfl_xor_sync(FULL, top[i].b2, off);
      merge(top[i], c1, k1, c2);
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < N1) {
      if (final_pass) {
        const size_t o = (size_t)pair * N1 + r;
        out_b1[o] = top[i].b1;
        out_b2[o] = fmaxf(top[i].b2, -2.f);  // the best column itself counts as -2
        out_i1[o] = top[i].i1;
      } else {
        const size_t o = ((size_t)split * npairs + pair) * N1 + r;
        out_b1[o] = top[i].b1;
        out_b2[o] = top[i].b2;
        out_i1[o] = top[i].i1;
      }
    }
  }
}

// merge the column splits' partial top-2s in split order (rows < `rows`,
// when splits > 1) and turn the column keys into rows (columns < `cols`)
__global__ void finish_kernel(const float* __restrict__ part_b1, const int* __restrict__ part_i1,
                              const float* __restrict__ part_b2, int rows, int splits,
                              float* __restrict__ s1, float* __restrict__ s2, int* __restrict__ idx,
                              const unsigned long long* __restrict__ col_keys, int cols,
                              int* __restrict__ back) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cols) back[i] = (int)(0xFFFFFFFFu - (uint32_t)(col_keys[i] & 0xFFFFFFFFull));
  if (i >= rows) return;
  Top2 t = {part_b1[i], part_b2[i], part_i1[i]};
  for (int s = 1; s < splits; ++s) {
    const size_t o = (size_t)s * rows + i;
    merge(t, part_b1[o], part_i1[o], part_b2[o]);
  }
  s1[i] = t.b1;
  s2[i] = fmaxf(t.b2, -2.f);
  idx[i] = t.i1;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the [B][N][128] f32 tensor, read in boxes of 32 floats x 128 rows of one
// pair, 128-byte swizzled
int encode_rows_map(CUtensorMap* map, const float* base, int N, int B) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaDriverEntryPointSuccess || fn == nullptr) return 999;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)D * 4 * (cuuint64_t)N};
  const cuuint32_t box[3] = {(cuuint32_t)KC, (cuuint32_t)TN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

template <bool CROSS>
int launch(const CUtensorMap& map1, const CUtensorMap& map2, int N1, int N2, const float* valid1,
           const float* valid2, int B, int chunk, int splits, float* part_b1, int* part_i1,
           float* part_b2, float* s1, float* s2, int* idx, unsigned long long* col_keys,
           int* back, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(top2_kernel<CROSS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N1 + TM - 1) / TM, splits, B);
  const bool final_pass = splits == 1;
  top2_kernel<CROSS><<<grid, THREADS, SMEM_BYTES, s>>>(
      map1, map2, N1, N2, valid1, valid2, chunk, final_pass, final_pass ? s1 : part_b1,
      final_pass ? idx : part_i1, final_pass ? s2 : part_b2, col_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess || (final_pass && !CROSS)) return static_cast<int>(err);
  const int rows = final_pass ? 0 : B * N1;
  const int cols = CROSS ? B * N2 : 0;
  const int n = rows > cols ? rows : cols;
  finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_b1, part_i1, part_b2, rows, splits, s1, s2,
                                                 idx, col_keys, cols, back);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(TM == TN, "one box shape serves both tensor maps");

extern "C" int match_top2_tile_rows() { return TM; }
extern "C" int match_top2_tile_cols() { return TN; }
extern "C" int match_top2_width() { return D; }
extern "C" long long match_top2_key_sentinel() { return (long long)SENTINEL; }

// The row top-2 of d1 [B][N1][128] against d2 [B][N2][128] into s1, s2, idx
// [B][N1]; with col_keys (filled with match_top2_key_sentinel()) also the
// best row of every column over the rows with valid1 > 0 into back [B][N2]
// (valid1 and back may be null without col_keys). The partial buffers hold
// `splits` x B x N1 entries each and are not touched when splits == 1.
extern "C" int match_top2_launch(const float* d1, int N1, const float* d2, int N2,
                                 const float* valid1, const float* valid2, int B, int chunk,
                                 int splits, float* part_b1, int* part_i1, float* part_b2,
                                 float* s1, float* s2, int* idx, unsigned long long* col_keys,
                                 int* back, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map1, map2;
  int rc = encode_rows_map(&map1, d1, N1, B);
  if (rc != 0) return rc;
  rc = encode_rows_map(&map2, d2, N2, B);
  if (rc != 0) return rc;
  if (col_keys != nullptr)
    return launch<true>(map1, map2, N1, N2, valid1, valid2, B, chunk, splits, part_b1, part_i1,
                        part_b2, s1, s2, idx, col_keys, back, s);
  return launch<false>(map1, map2, N1, N2, valid1, valid2, B, chunk, splits, part_b1, part_i1,
                       part_b2, s1, s2, idx, nullptr, nullptr, s);
}
