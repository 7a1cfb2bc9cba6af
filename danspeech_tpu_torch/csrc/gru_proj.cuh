// Tiled bf16 tensor-core GEMMs with f32 accumulation and an f32 result, shared
// by the recurrent kernels: the input projection of gru_bidi_fused.cu and the
// gate recompute of gru_bwd.cu and lstm_bwd.cu. Include after <cuda_bf16.h>
// and the bf16 typedef. Two kernels for the same product:
//
// gru_proj_kernel takes the operands as they lie (weights (K, N), any
// alignment). A block computes a 128 x 128 tile over a ring of P_STAGES
// chunks of depth 32 in dynamic shared memory, filled by cp.async (16 bytes a
// thread) so that the loads of the chunks ahead overlap the MMAs of the chunk
// at hand. Eight warps (2 x 4) each own a 64 x 32 part: ldmatrix brings the
// fragments (the right operand, stored depth-major as it lies in memory,
// through ldmatrix.trans), mma.m16n8k16 multiplies, and the epilogue writes
// the f32 accumulators from registers straight to memory, 8 bytes a thread
// (whole 32-byte sectors a row). M, N and K need not be multiples of the
// tile, and rows that do not start on 16-byte boundaries take a scalar load
// path. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W:
// 290 TFLOP/s at M=51328, N=3600, K=2016 (two directions).
//
// gru_proj_wgmma_kernel (below it) takes the weights transposed and rows the
// copy engine can read: wgmma fed by TMA, 610 TFLOP/s at the same shape.

#pragma once

#include "persist.cuh"

// ---------------------------------------------------------------------------
// Projection: gx[dir] (M, N) f32 = A (M, K) bf16 @ W[dir] (K, N) bf16
// ---------------------------------------------------------------------------

#define P_BM 128
#define P_BN 128
#define P_BK 32
#define P_PAD 8
#define P_THREADS 256
#define P_STAGES 4
#define P_LDA (P_BK + P_PAD)
#define P_LDB (P_BN + P_PAD)
#define P_STAGE_ELEMS (P_BM * P_LDA + P_BK * P_LDB)
#define P_SMEM_BYTES (P_STAGES * P_STAGE_ELEMS * 2)

__global__ void __launch_bounds__(P_THREADS, 2)
gru_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w_f,
                const bf16* __restrict__ w_b, float* __restrict__ gx,
                int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char p_smem[];
  bf16* ring = reinterpret_cast<bf16*>(p_smem);

  const int dir = blockIdx.z;
  const bf16* __restrict__ w = dir == 0 ? w_f : w_b;
  float* __restrict__ c = gx + (size_t)dir * M * N;

  const int m0 = blockIdx.y * P_BM;
  const int n0 = blockIdx.x * P_BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 0..1: 64-row half of the tile
  const int wn = warp & 3;   // 0..3: 32-column quarter of the tile
  // 16-byte copies need rows that start on 16-byte boundaries
  const bool vec_a = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0;
  const bool vec_b = (N % 8) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0;
  const int nch = (K + P_BK - 1) / P_BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto load_chunk = [&](int ch) {
    bf16* As = ring + (size_t)(ch % P_STAGES) * P_STAGE_ELEMS;
    bf16* Bs = As + P_BM * P_LDA;
    const int k0 = ch * P_BK;
    // A tile: 128 x 32 = 512 pieces of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * P_THREADS;
      const int row = idx >> 2;
      const int col = (idx & 3) * 8;
      const int gm = m0 + row, gk = k0 + col;
      bf16* dst = As + row * P_LDA + col;
      if (vec_a && gm < M && gk + 8 <= K) {
        ps_cp_async16(dst, a + (size_t)gm * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? a[(size_t)gm * K + gk + e]
                                           : __float2bfloat16(0.0f);
      }
    }
    // B tile: 32 x 128 = 512 pieces of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * P_THREADS;
      const int row = idx >> 4;
      const int col = (idx & 15) * 8;
      const int gk = k0 + row, gn = n0 + col;
      bf16* dst = Bs + row * P_LDB + col;
      if (vec_b && gk < K && gn + 8 <= N) {
        ps_cp_async16(dst, w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e]
                                           : __float2bfloat16(0.0f);
      }
    }
  };

  for (int ch = 0; ch < P_STAGES - 1; ++ch) {
    if (ch < nch) load_chunk(ch);
    ps_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    ps_wait<P_STAGES - 2>();
    __syncthreads();  // chunk ch has landed; the stage of chunk ch - 1 is free
    if (ch + P_STAGES - 1 < nch) load_chunk(ch + P_STAGES - 1);
    ps_commit();

    const bf16* As = ring + (size_t)(ch % P_STAGES) * P_STAGE_ELEMS;
    const bf16* Bs = As + P_BM * P_LDA;
#pragma unroll
    for (int kk = 0; kk < P_BK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ps_ldmatrix_x4(af[i], As + (wm * 64 + i * 16 + (lane & 15)) * P_LDA +
                                  kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ps_ldmatrix_x4_trans(
            bfr[j], Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * P_LDB +
                        wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps_mma(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                 bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  ps_wait<0>();

  // epilogue: accumulators to memory from registers. A thread holds, per
  // 16 x 8 fragment, columns 2q, 2q + 1 of rows r and r + 8.
  const int r = lane >> 2;
  const int q = (lane & 3) * 2;
  const bool pair = (N % 2) == 0 && (reinterpret_cast<uintptr_t>(c) % 8) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + wn * 32 + j * 8 + q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wm * 64 + i * 16 + r + half * 8;
        if (gm >= M) continue;
        float* dst = c + (size_t)gm * N + gn;
        const float v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        if (pair && gn + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (gn < N) dst[0] = v0;
          if (gn + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

// Launches the projection for `ndir` (1 or 2) weight matrices on stream s.
// Returns the CUDA error code.
static inline int gru_proj_launch(const bf16* a, const bf16* w_f,
                                  const bf16* w_b, float* out, int M, int N,
                                  int K, int ndir, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)gru_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + P_BN - 1) / P_BN, (M + P_BM - 1) / P_BM, ndir);
  gru_proj_kernel<<<grid, P_THREADS, P_SMEM_BYTES, s>>>(a, w_f, w_b, out, M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The same product on wgmma, fed by the copy engine: gx[dir] (M, N) f32 =
// A (M, K) bf16 @ Wt[dir] (N, K)^T, the weights given transposed (depth
// contiguous, as A), both directions in one (ndir, N, K) tensor
// ---------------------------------------------------------------------------
//
// A block computes a 128 x 240 tile (240 divides 3H for every H that is a
// multiple of 80: 1200, 2000, 800). Its third warpgroup feeds a ring of
// Q_STAGES chunks 64 deep: one lane asks the copy engine (TMA) for the A box
// (128 rows) and the Wt box (240 rows) of a chunk, both in the 128-byte
// swizzle that wgmma reads; rows past M or N and depth past K arrive as zeros.
// The other two warpgroups each own 64 rows of the tile and multiply them by
// the two 120-column halves of the Wt box (wgmma.m64n120k16, both operands in
// shared memory, 120 f32 sums a thread), one chunk's products in flight while
// the next chunk's are issued, and write their sums from registers straight
// to memory. Needs rows the copy engine can read (ps_tma_ok: K a multiple of
// 8, 16-byte aligned bases); gru_proj_kernel above takes every other case.

#define Q_BM 128
#define Q_BN 240
#define Q_HALF (Q_BN / 2)  // columns of one wgmma
#define Q_NT (Q_HALF / 8)
#define Q_STAGES 4
#define Q_THREADS 384
#define Q_A_ELEMS (Q_BM * PS_BOX)
#define Q_STAGE_ELEMS ((Q_BM + Q_BN) * PS_BOX)
#define Q_SMEM_BYTES (Q_STAGES * Q_STAGE_ELEMS * 2)

__global__ void __launch_bounds__(Q_THREADS, 1)
gru_proj_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap w_map,
                      float* __restrict__ gx, int M, int N, int K) {
  extern __shared__ __align__(1024) unsigned char q_smem[];
  __shared__ __align__(8) uint64_t q_mbar[2 * PS_MAX_STAGES];
  bf16* ring = reinterpret_cast<bf16*>(q_smem);
  uint64_t* full = q_mbar;
  uint64_t* empty = q_mbar + PS_MAX_STAGES;

  const int dir = blockIdx.z;
  const int m0 = blockIdx.y * Q_BM;
  const int n0 = blockIdx.x * Q_BN;
  // read from lane 0: the same in the whole warp by construction, which the
  // compiler must know to keep a warpgroup's wgmmas in flight together
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int nch = (K + PS_BOX - 1) / PS_BOX;

  // "full": the feeder's arrival with the bytes; "empty": one arrival for
  // each of the 8 multiplying warps
  ps_ring_init(ring, q_mbar, Q_STAGES);

  if (warp >= PS_WARPS) {
    if (warp == PS_WARPS && lane == 0) {
      int stage = 0;
      uint32_t use = 0;
      for (int c = 0; c < nch; ++c) {
        ps_mbar_wait(empty + stage, (use & 1u) ^ 1u);
        bf16* st = ring + stage * Q_STAGE_ELEMS;
        ps_mbar_expect_tx(full + stage, (uint32_t)Q_STAGE_ELEMS * 2u);
        ps_tma_load_3d(st, &a_map, c * PS_BOX, m0, 0, full + stage);
        ps_tma_load_3d(st + Q_A_ELEMS, &w_map, c * PS_BOX, n0, dir, full + stage);
        if (++stage == Q_STAGES) {
          stage = 0;
          ++use;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // this warpgroup's 64 rows of the tile
  float acc[2][Q_NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < Q_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = 0.0f;

  int stage = 0;
  uint32_t use = 0;
  for (int c = 0; c < nch; ++c) {
    ps_mbar_wait(full + stage, use & 1u);
    const bf16* As = ring + stage * Q_STAGE_ELEMS + wg * 64 * PS_BOX;
    const bf16* Bs = ring + stage * Q_STAGE_ELEMS + Q_A_ELEMS;
    ps_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PS_BOX; kk += 16) {
      const uint64_t da = ps_wgmma_desc(As + kk);
      ps_wgmma<Q_NT>(acc[0], da, ps_wgmma_desc(Bs + kk));
      ps_wgmma<Q_NT>(acc[1], da, ps_wgmma_desc(Bs + Q_HALF * PS_BOX + kk));
    }
    ps_wgmma_commit();
    // the chunk before has been read once at most this chunk's products fly
    ps_wgmma_wait<1>();
    if (c > 0) {
      __syncwarp();
      if (lane == 0) ps_mbar_arrive(empty + (stage == 0 ? Q_STAGES : stage) - 1);
    }
    if (++stage == Q_STAGES) {
      stage = 0;
      ++use;
    }
  }
  ps_wgmma_wait<0>();
  // the sums are in the registers now, not before (wgmma is asynchronous)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < Q_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[h][n][e])::"memory");

  // a thread holds, per 8-column tile n, columns 2q, 2q + 1 of rows r, r + 8
  // of its warp's 16 rows
  float* __restrict__ c = gx + (size_t)dir * M * N;
  const int r = lane >> 2;
  const int q = (lane & 3) * 2;
  const bool pair = (N % 2) == 0 && (reinterpret_cast<uintptr_t>(c) % 8) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < Q_NT; ++n) {
      const int gn = n0 + h * Q_HALF + n * 8 + q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wg * 64 + (warp & 3) * 16 + r + half * 8;
        if (gm >= M) continue;
        float* dst = c + (size_t)gm * N + gn;
        const float v0 = acc[h][n][half * 2], v1 = acc[h][n][half * 2 + 1];
        if (pair && gn + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (gn < N) dst[0] = v0;
          if (gn + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

// Launches the wgmma projection for the `ndir` matrices of wt (ndir, N, K) on
// stream s. The caller has checked ps_tma_ok(a, K) and ps_tma_ok(wt, K).
// Returns the CUDA error code.
static inline int gru_proj_wgmma_launch(const bf16* a, const bf16* wt, float* out,
                                        int M, int N, int K, int ndir,
                                        cudaStream_t s) {
  CUtensorMap a_map, w_map;
  int rc = ps_make_tmap(&a_map, a, K, M, 1, Q_BM);
  if (rc != 0) return rc;
  rc = ps_make_tmap(&w_map, wt, K, N, ndir, Q_BN);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)gru_proj_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + Q_BN - 1) / Q_BN, (M + Q_BM - 1) / Q_BM, ndir);
  gru_proj_wgmma_kernel<<<grid, Q_THREADS, Q_SMEM_BYTES, s>>>(a_map, w_map, out, M,
                                                              N, K);
  return (int)cudaGetLastError();
}
