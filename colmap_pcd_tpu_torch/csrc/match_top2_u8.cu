// Fused descriptor matching on the integer tensor cores: for every row of d1
// against the columns d2 of its image pair, the best cosine similarity, the
// second best and the column of the best, without ever writing the
// similarity matrix. The descriptors are the uint8 rows the database holds.
//
// Replaces the Pallas TPU kernel `match_top2` (colmap_pcd_tpu/ops/
// pallas_kernels.py:77, pallas_call :94, body `_match_kernel` :42) for uint8
// descriptors; csrc/match_top2.cu stays the route for float descriptors.
//
// What bounds it on Hopper: the epilogue's instruction slots, not the
// product. The matcher's chunk (16 pairs of 2048 x 2048 x 128) is 17.2 G
// integer operations, 0.009 ms of the card's int8 tensor-core peak, while
// every similarity still costs a convert, a scale, and a five-instruction
// fold into the running top-2, six of them on the ALU pipe that runs at half
// the FMA rate: ~0.02 ms over 132 SMs. Design:
//   * u8 x u8 -> s32 `wgmma.mma_async.m64n128k32`, both operands K-major from
//     shared memory (the [N,128] rows as they lie; 128 deep = 4 k-steps). An
//     integer dot product (<= 255^2 x 128 < 2^23) is exact and has no
//     summation order; the similarity is float(dot) * (inv_row * inv_col),
//     the product of the two f32 inverse norms first, which commutes, so the
//     cross-check's launch on (d2, d1) forms bit-identical similarities and
//     the plain version (an f32 matmul of uint8-valued floats) agrees to the
//     last bit;
//   * a block owns 128 rows: two consumer warpgroups of 64 rows each, whose
//     descriptors (16 KB) stay in shared memory. One producer warp streams
//     128-column tiles (16 KB) through a ring of 4 shared-memory stages with
//     TMA (128-byte swizzle, out-of-range rows zero-filled) signalled by
//     `mbarrier`s; `setmaxnreg` moves registers from the producer to the
//     consumers, which hold two accumulator sets, so the MMAs of tile t+1
//     run while the epilogue folds tile t;
//   * the producer also writes the tile's per-column (scale, offset) table:
//     (inv, 0) for a valid column, (0, -2) for an invalid one, (0, -inf) past
//     the ragged edge, so the epilogue is one fmaf per similarity and masks
//     nothing. The block first finds its last valid column: the tiles past
//     it (the matcher pads ~2100 keypoints to 4096) are neither loaded nor
//     multiplied, they fold (-2, their lowest column) once; the loop over
//     the tiles before it has no branch around its MMAs, which ptxas needs
//     to keep them asynchronous. A row tile with no valid row (valid1 given)
//     exits at once; invalid rows return (-2, -2, 0);
//   * the epilogue works on the accumulator fragment in registers: each
//     thread folds its 2 x 32 values in increasing column order (strict '>',
//     so ties keep the lowest column), the 4 threads that share a row merge
//     by shuffles with the symmetric merge of match_top2.cu;
//   * few row tiles (one pair) would leave SMs idle, so the grid also splits
//     the columns; a second small kernel then merges the splits. With one
//     split the main kernel writes the results itself.
//
// The guided variant (`guided_top2_kernel`, `guided_merge_kernel`: guided
// matching, feature/matching.h:277-310) is the same kernel with an
// epipolar mask in its epilogue. Every point carries a float4 (x, y, z, n):
// image 1's points their epipolar line F x1 = (a, b, c) and n = e^2 (a^2 +
// b^2), image 2's points (u, v, 1) and n = e^2 |(F^T x2)_xy|^2, e the
// largest Sampson error. A similarity stays where
//     (x_r u_c + y_r v_c + z_r w_c)^2 < n_r + n_c,
// the Sampson test, and is -2 elsewhere, before the fold. Each product and
// sum is rounded on its own (no FMA), and both sides enter symmetrically, so
// the launch on the transpose (the cross-check's column bests) forms the
// transposed mask bit for bit and the plain version in PyTorch agrees to the
// last bit. The producer copies a tile's 128 column records (2 KB) with one
// bulk copy beside the tile's TMA load; the caller pads both record arrays
// to a multiple of 128 points with n = +inf, so columns past the ragged edge
// pass the test and stay at -inf.
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

constexpr int D = 128;            // descriptor width, bytes per row
constexpr int TM = 128;           // rows per block, 64 per consumer warpgroup
constexpr int TN = 128;           // columns per stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;    // two warpgroups
constexpr int THREADS = 384;      // + the producer's warpgroup (one warp works)
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE_BYTES = TN * D;

// shared-memory map, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows = 1024 bytes)
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + TM * D;
constexpr int OFF_SCALE = OFF_B + STAGES * TILE_BYTES;
constexpr int OFF_BAR = OFF_SCALE + STAGES * TN * (int)sizeof(float2);
constexpr int OFF_LAST = OFF_BAR + 128;
constexpr int SMEM_BYTES = OFF_LAST + 64 + 1024;  // + alignment slack
// the guided variant's column records, one float4 a column of each stage
constexpr int OFF_GEO = OFF_LAST + 64;
constexpr int GEO_TILE_BYTES = TN * (int)sizeof(float4);
constexpr int SMEM_BYTES_GUIDED = OFF_GEO + STAGES * GEO_TILE_BYTES + 1024;

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
// hold the same result (as in match_top2.cu)
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

// one [TN or TM rows] x 128-byte box of the [B][N][128] tensor into shared
// memory; rows past N arrive as zeros; completion lands on the mbarrier
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int pair) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(pair)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global memory
// into shared memory; completion lands on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the Sampson test of a (row, column) pair of point records: v where the
// pair lies within the error, else -2; every operation rounded on its own
__device__ __forceinline__ float epipolar(float v, const float4& r, const float4& c) {
  const float t = __fadd_rn(__fadd_rn(__fmul_rn(r.x, c.x), __fmul_rn(r.y, c.y)), __fmul_rn(r.z, c.z));
  return __fmul_rn(t, t) < __fadd_rn(r.w, c.w) ? v : -2.f;
}

// shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart; a k-step of 32 bytes adds 2
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define ACC8(a, o)                                                                          \
  "+r"(a[o + 0]), "+r"(a[o + 1]), "+r"(a[o + 2]), "+r"(a[o + 3]), "+r"(a[o + 4]),           \
      "+r"(a[o + 5]), "+r"(a[o + 6]), "+r"(a[o + 7])
#define ACC64(a) \
  ACC8(a, 0), ACC8(a, 8), ACC8(a, 16), ACC8(a, 24), ACC8(a, 32), ACC8(a, 40), ACC8(a, 48), ACC8(a, 56)

// acc (+)= A[64 x 32] * B[128 x 32]^T, u8 x u8 -> s32, both from shared memory
__device__ __forceinline__ void wgmma_m64n128k32_u8(int (&acc)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : ACC64(acc)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the compiler must not move reads or writes of the accumulators across the
// asynchronous MMAs that own them
__device__ __forceinline__ void fence_acc(int (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

struct Ring {
  uint32_t a, b, full, empty, a_full;  // shared-memory addresses
  const float2* scale;                 // [STAGES][TN]
  const float4* geo;                   // [STAGES][TN], the guided variant's column records
};

// start the MMAs of column tile t into acc and commit them as one group
__device__ __forceinline__ void start_tile(int (&acc)[64], const Ring& r, int t, uint64_t desc_a) {
  const int s = t % STAGES;
  mbar_wait(r.full + 8 * s, (t / STAGES) & 1);
  const uint64_t desc_b = smem_desc(r.b + s * TILE_BYTES);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 32; ++k) wgmma_m64n128k32_u8(acc, desc_a + 2 * k, desc_b + 2 * k, k > 0);
  wgmma_commit();
}

// fold the finished tile t into the two rows' running top-2 and hand its
// stage back to the producer; GUIDED masks each similarity by the Sampson
// test of the rows' records g_lo, g_hi against the columns'
template <bool GUIDED>
__device__ __forceinline__ void finish_tile(int (&acc)[64], const Ring& r, int t, int col0, int lane,
                                            float inv_lo, float inv_hi, const float4& g_lo,
                                            const float4& g_hi, Top2& lo, Top2& hi) {
  const int s = t % STAGES;
  fence_acc(acc);
  const int cq = 2 * (lane & 3);
  const float2* sc = r.scale + s * TN + cq;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const float4 c = *reinterpret_cast<const float4*>(sc + 8 * j);  // two columns
    const int col = col0 + 8 * j + cq;
    float v0 = fmaf((float)acc[4 * j + 0], inv_lo * c.x, c.y);
    float v1 = fmaf((float)acc[4 * j + 1], inv_lo * c.z, c.w);
    float v2 = fmaf((float)acc[4 * j + 2], inv_hi * c.x, c.y);
    float v3 = fmaf((float)acc[4 * j + 3], inv_hi * c.z, c.w);
    if constexpr (GUIDED) {
      const float4 e0 = r.geo[s * TN + 8 * j + cq];
      const float4 e1 = r.geo[s * TN + 8 * j + cq + 1];
      v0 = epipolar(v0, g_lo, e0);
      v1 = epipolar(v1, g_lo, e1);
      v2 = epipolar(v2, g_hi, e0);
      v3 = epipolar(v3, g_hi, e1);
    }
    fold(lo, v0, col);
    fold(lo, v1, col + 1);
    fold(hi, v2, col);
    fold(hi, v3, col + 1);
  }
  mbar_arrive(r.empty + 8 * s);
}

// the body of both main kernels; GUIDED reads the rows' and columns' point
// records geo1 [B][N1 padded to TN] and geo2 [B][N2 padded to TN]
template <bool GUIDED>
__device__ __forceinline__ void top2_u8_body(const CUtensorMap* map1, const CUtensorMap* map2, int N1, int N2,
                                             const float* __restrict__ inv1, const float* __restrict__ inv2,
                                             const float* __restrict__ valid1, const float* __restrict__ valid2,
                                             const float4* __restrict__ geo1, const float4* __restrict__ geo2,
                                             int chunk, int final_pass, float* __restrict__ out_b1,
                                             int* __restrict__ out_i1, float* __restrict__ out_b2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int pair = blockIdx.z, npairs = gridDim.z;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int col_begin = split * chunk;
  const int col_end = min(N2, col_begin + chunk);

  // a row tile without a valid row does no work
  if (valid1 != nullptr) {
    const int r = row0 + tid;
    const bool ok = tid < TM && r < N1 && valid1[(size_t)pair * N1 + r] > 0.f;
    if (!__syncthreads_or(ok)) {
      if (final_pass && tid < TM && r < N1) {
        const size_t o = (size_t)pair * N1 + r;
        out_b1[o] = -2.f;
        out_b2[o] = -2.f;
        out_i1[o] = 0;
      }
      return;
    }
  }

  Ring ring;
  ring.a = smem_u32(smem + OFF_A);
  ring.b = smem_u32(smem + OFF_B);
  ring.full = smem_u32(smem + OFF_BAR);
  ring.empty = ring.full + 8 * STAGES;
  ring.a_full = ring.empty + 8 * STAGES;
  ring.scale = reinterpret_cast<const float2*>(smem + OFF_SCALE);
  ring.geo = reinterpret_cast<const float4*>(smem + OFF_GEO);
  int* last_valid = reinterpret_cast<int*>(smem + OFF_LAST);

  if (tid == 0) {
    *last_valid = -1;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 32);          // the producer warp's lanes
      mbar_init(ring.empty + 8 * s, CONSUMERS);  // every consumer thread
    }
    mbar_init(ring.a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the block's rows start loading while its columns are scanned below
    mbar_arrive_expect_tx(ring.a_full, TM * D);
    tma_load_rows(ring.a, map1, ring.a_full, row0, pair);
  }
  __syncthreads();

  // the block's last valid column bounds the tiles that are loaded and
  // multiplied; what lies past it counts as -2 without either
  {
    const float* V = valid2 + (size_t)pair * N2;
    int mine = -1;
    for (int c = col_begin + tid; c < col_end; c += THREADS)
      if (V[c] > 0.f) mine = c;
    mine = __reduce_max_sync(FULL, mine);
    if (lane == 0 && mine >= 0) atomicMax(last_valid, mine);
  }
  __syncthreads();
  const int ntiles = *last_valid < 0 ? 0 : (*last_valid - col_begin) / TN + 1;
  const int dead_col = col_begin + ntiles * TN;  // the lowest column past the tiles, if < col_end

  if (warp >= CONSUMERS / 32) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != CONSUMERS / 32 || ntiles == 0) return;
    float2* scale = reinterpret_cast<float2*>(smem + OFF_SCALE);
    const float* V = valid2 + (size_t)pair * N2;
    const float* I = inv2 + (size_t)pair * N2;
    // the columns' valid flags and inverse norms are fetched one tile ahead,
    // so that no global-memory latency lies between a stage's release and
    // its next fill
    float next_v[TN / 32], next_i[TN / 32];
    auto fetch = [&](int t) {
#pragma unroll
      for (int k = 0; k < TN / 32; ++k) {
        const int c = col_begin + t * TN + lane + 32 * k;
        next_v[k] = c < col_end ? V[c] : 0.f;
        next_i[k] = c < col_end ? I[c] : 0.f;
      }
    };
    fetch(0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      const int col0 = col_begin + t * TN;
      float2 sc[TN / 32];
#pragma unroll
      for (int k = 0; k < TN / 32; ++k) {
        const bool in = col0 + lane + 32 * k < col_end;
        sc[k] = next_v[k] > 0.f ? make_float2(next_i[k], 0.f)
                                : make_float2(0.f, in ? -2.f : -INFINITY);
      }
      if (t + 1 < ntiles) fetch(t + 1);
      mbar_wait(ring.empty + 8 * s, ((t / STAGES) & 1) ^ 1);
#pragma unroll
      for (int k = 0; k < TN / 32; ++k) scale[s * TN + lane + 32 * k] = sc[k];
      if (lane == 0) {
        mbar_arrive_expect_tx(ring.full + 8 * s, GUIDED ? TILE_BYTES + GEO_TILE_BYTES : TILE_BYTES);
        tma_load_rows(ring.b + s * TILE_BYTES, map2, ring.full + 8 * s, col0, pair);
        if constexpr (GUIDED)
          bulk_load(smem_u32(smem + OFF_GEO) + s * GEO_TILE_BYTES,
                    geo2 + (size_t)pair * ((N2 + TN - 1) / TN * TN) + col0, GEO_TILE_BYTES, ring.full + 8 * s);
      } else {
        mbar_arrive(ring.full + 8 * s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int r_lo = row0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const int r_hi = r_lo + 8;
    const float* I = inv1 + (size_t)pair * N1;
    const float inv_lo = r_lo < N1 ? I[r_lo] : 0.f;
    const float inv_hi = r_hi < N1 ? I[r_hi] : 0.f;
    float4 g_lo = make_float4(0.f, 0.f, 0.f, 0.f), g_hi = g_lo;
    if constexpr (GUIDED) {
      const float4* G = geo1 + (size_t)pair * ((N1 + TN - 1) / TN * TN);
      if (r_lo < N1) g_lo = G[r_lo];
      if (r_hi < N1) g_hi = G[r_hi];
    }
    Top2 lo = {-INFINITY, -INFINITY, INT_MAX};
    Top2 hi = lo;
    int acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] = 0;
      acc1[i] = 0;
    }
    const uint64_t desc_a = smem_desc(ring.a + wg * 64 * D);

    mbar_wait(ring.a_full, 0);  // also when unused: the copy must land before the block ends
    if (ntiles > 0) {
      start_tile(acc0, ring, 0, desc_a);
      int t = 0;
      for (; t + 2 < ntiles; t += 2) {  // acc0 holds tile t; tiles t+1 and t+2 exist
        start_tile(acc1, ring, t + 1, desc_a);
        wgmma_wait<1>();
        finish_tile<GUIDED>(acc0, ring, t, col_begin + t * TN, lane, inv_lo, inv_hi, g_lo, g_hi, lo, hi);
        start_tile(acc0, ring, t + 2, desc_a);
        wgmma_wait<1>();
        finish_tile<GUIDED>(acc1, ring, t + 1, col_begin + (t + 1) * TN, lane, inv_lo, inv_hi, g_lo, g_hi, lo, hi);
      }
      if (t + 1 < ntiles) {
        start_tile(acc1, ring, t + 1, desc_a);
        wgmma_wait<1>();
        finish_tile<GUIDED>(acc0, ring, t, col_begin + t * TN, lane, inv_lo, inv_hi, g_lo, g_hi, lo, hi);
        wgmma_wait<0>();
        finish_tile<GUIDED>(acc1, ring, t + 1, col_begin + (t + 1) * TN, lane, inv_lo, inv_hi, g_lo, g_hi, lo, hi);
      } else {
        wgmma_wait<0>();
        finish_tile<GUIDED>(acc0, ring, t, col_begin + t * TN, lane, inv_lo, inv_hi, g_lo, g_hi, lo, hi);
      }
    }
    if (dead_col < col_end) {  // columns without a valid one among them
      fold(lo, -2.f, dead_col);
      fold(hi, -2.f, dead_col);
    }

    // merge the 4 threads that share each row
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      float c1 = __shfl_xor_sync(FULL, lo.b1, off);
      int k1 = __shfl_xor_sync(FULL, lo.i1, off);
      float c2 = __shfl_xor_sync(FULL, lo.b2, off);
      merge(lo, c1, k1, c2);
      c1 = __shfl_xor_sync(FULL, hi.b1, off);
      k1 = __shfl_xor_sync(FULL, hi.i1, off);
      c2 = __shfl_xor_sync(FULL, hi.b2, off);
      merge(hi, c1, k1, c2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r_hi : r_lo;
        const Top2 t = h ? hi : lo;
        if (r >= N1) continue;
        if (final_pass) {
          const size_t o = (size_t)pair * N1 + r;
          const bool ok = valid1 == nullptr || valid1[o] > 0.f;
          out_b1[o] = ok ? t.b1 : -2.f;
          out_b2[o] = ok ? fmaxf(t.b2, -2.f) : -2.f;  // the best column itself counts as -2
          out_i1[o] = ok ? t.i1 : 0;
        } else {
          const size_t o = ((size_t)split * npairs + pair) * N1 + r;
          out_b1[o] = t.b1;
          out_b2[o] = t.b2;
          out_i1[o] = t.i1;
        }
      }
    }
  }
}

__device__ __forceinline__ void top2_reduce_body(const float* __restrict__ part_b1,
                                                 const int* __restrict__ part_i1,
                                                 const float* __restrict__ part_b2, int rows, int splits,
                                                 const float* __restrict__ valid1, float* __restrict__ s1,
                                                 float* __restrict__ s2, int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  if (valid1 != nullptr && !(valid1[i] > 0.f)) {  // its row tile may have written nothing
    s1[i] = -2.f;
    s2[i] = -2.f;
    idx[i] = 0;
    return;
  }
  Top2 t = {part_b1[i], part_b2[i], part_i1[i]};
  for (int s = 1; s < splits; ++s) {
    const size_t o = (size_t)s * rows + i;
    merge(t, part_b1[o], part_i1[o], part_b2[o]);
  }
  s1[i] = t.b1;
  s2[i] = fmaxf(t.b2, -2.f);
  idx[i] = t.i1;
}

// the plain kernel and the guided one carry names of their own, so that a
// trace tells their device time apart

__global__ void __launch_bounds__(THREADS, 1)
top2_u8_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
               int N1, int N2, const float* __restrict__ inv1, const float* __restrict__ inv2,
               const float* __restrict__ valid1, const float* __restrict__ valid2, int chunk,
               int final_pass, float* __restrict__ out_b1, int* __restrict__ out_i1,
               float* __restrict__ out_b2) {
  top2_u8_body<false>(&map1, &map2, N1, N2, inv1, inv2, valid1, valid2, nullptr, nullptr, chunk, final_pass,
                      out_b1, out_i1, out_b2);
}

__global__ void __launch_bounds__(THREADS, 1)
guided_top2_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
                   int N1, int N2, const float* __restrict__ inv1, const float* __restrict__ inv2,
                   const float* __restrict__ valid1, const float* __restrict__ valid2,
                   const float4* __restrict__ geo1, const float4* __restrict__ geo2, int chunk,
                   int final_pass, float* __restrict__ out_b1, int* __restrict__ out_i1,
                   float* __restrict__ out_b2) {
  top2_u8_body<true>(&map1, &map2, N1, N2, inv1, inv2, valid1, valid2, geo1, geo2, chunk, final_pass, out_b1,
                     out_i1, out_b2);
}

__global__ void top2_u8_reduce_kernel(const float* __restrict__ part_b1, const int* __restrict__ part_i1,
                                      const float* __restrict__ part_b2, int rows, int splits,
                                      const float* __restrict__ valid1, float* __restrict__ s1,
                                      float* __restrict__ s2, int* __restrict__ idx) {
  top2_reduce_body(part_b1, part_i1, part_b2, rows, splits, valid1, s1, s2, idx);
}

__global__ void guided_merge_kernel(const float* __restrict__ part_b1, const int* __restrict__ part_i1,
                                    const float* __restrict__ part_b2, int rows, int splits,
                                    const float* __restrict__ valid1, float* __restrict__ s1,
                                    float* __restrict__ s2, int* __restrict__ idx) {
  top2_reduce_body(part_b1, part_i1, part_b2, rows, splits, valid1, s1, s2, idx);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the [B][N][128] uint8 tensor, read in boxes of 128 rows of one pair
int encode_rows_map(CUtensorMap* map, const uint8_t* base, int N, int B) {
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
  const cuuint64_t strides[2] = {(cuuint64_t)D, (cuuint64_t)D * (cuuint64_t)N};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)TN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(base), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

// both launches of one variant: the main kernel over (row tiles, column
// splits, pairs) and, with more than one split, the merge of the splits
template <bool GUIDED>
int launch(const uint8_t* d1, int N1, const uint8_t* d2, int N2, const float* inv1, const float* inv2,
           const float* valid1, const float* valid2, const float4* geo1, const float4* geo2, int B, int chunk,
           int splits, float* part_b1, int* part_i1, float* part_b2, float* s1, float* s2, int* idx,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map1, map2;
  int rc = encode_rows_map(&map1, d1, N1, B);
  if (rc != 0) return rc;
  rc = encode_rows_map(&map2, d2, N2, B);
  if (rc != 0) return rc;
  const int smem = GUIDED ? SMEM_BYTES_GUIDED : SMEM_BYTES;
  cudaError_t err;
  if constexpr (GUIDED)
    err = cudaFuncSetAttribute(guided_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  else
    err = cudaFuncSetAttribute(top2_u8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N1 + TM - 1) / TM, splits, B);
  const int final_pass = splits == 1;
  float* b1 = final_pass ? s1 : part_b1;
  int* i1 = final_pass ? idx : part_i1;
  float* b2 = final_pass ? s2 : part_b2;
  if constexpr (GUIDED)
    guided_top2_kernel<<<grid, THREADS, smem, s>>>(map1, map2, N1, N2, inv1, inv2, valid1, valid2, geo1, geo2,
                                                   chunk, final_pass, b1, i1, b2);
  else
    top2_u8_kernel<<<grid, THREADS, smem, s>>>(map1, map2, N1, N2, inv1, inv2, valid1, valid2, chunk,
                                               final_pass, b1, i1, b2);
  err = cudaGetLastError();
  if (err != cudaSuccess || final_pass) return static_cast<int>(err);
  const int rows = B * N1;
  if constexpr (GUIDED)
    guided_merge_kernel<<<(rows + 255) / 256, 256, 0, s>>>(part_b1, part_i1, part_b2, rows, splits, valid1, s1,
                                                           s2, idx);
  else
    top2_u8_reduce_kernel<<<(rows + 255) / 256, 256, 0, s>>>(part_b1, part_i1, part_b2, rows, splits, valid1,
                                                             s1, s2, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(TM == TN, "one box shape serves both tensor maps");

extern "C" int match_top2_u8_tile_rows() { return TM; }
extern "C" int match_top2_u8_tile_cols() { return TN; }
extern "C" int match_top2_u8_width() { return D; }

// valid1 may be null (every row valid). With splits == 1 the partial buffers
// are not touched.
extern "C" int match_top2_u8_launch(const uint8_t* d1, int N1, const uint8_t* d2, int N2,
                                    const float* inv1, const float* inv2, const float* valid1,
                                    const float* valid2, int B, int chunk, int splits,
                                    float* part_b1, int* part_i1, float* part_b2, float* s1,
                                    float* s2, int* idx, void* stream) {
  return launch<false>(d1, N1, d2, N2, inv1, inv2, valid1, valid2, nullptr, nullptr, B, chunk, splits, part_b1,
                       part_i1, part_b2, s1, s2, idx, stream);
}

// the guided variant: geo1 [B][N1 rounded up to a multiple of the tile] and
// geo2 [B][N2 rounded up] point records (see the top of this file), 16-byte
// aligned
extern "C" int match_guided_u8_launch(const uint8_t* d1, int N1, const uint8_t* d2, int N2,
                                      const float* inv1, const float* inv2, const float* valid1,
                                      const float* valid2, const float* geo1, const float* geo2, int B,
                                      int chunk, int splits, float* part_b1, int* part_i1, float* part_b2,
                                      float* s1, float* s2, int* idx, void* stream) {
  return launch<true>(d1, N1, d2, N2, inv1, inv2, valid1, valid2, reinterpret_cast<const float4*>(geo1),
                      reinterpret_cast<const float4*>(geo2), B, chunk, splits, part_b1, part_i1, part_b2, s1,
                      s2, idx, stream);
}
