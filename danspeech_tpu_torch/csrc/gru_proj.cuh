// Tiled bf16 WMMA GEMM with f32 accumulation, shared by the GRU kernels:
// the input projection of gru_bidi_fused.cu and the gate recompute of
// gru_bwd.cu. Include after <cuda_bf16.h>, <mma.h> and the bf16 typedef.

#pragma once

// ---------------------------------------------------------------------------
// Projection: gx[dir] (M, N) f32 = A (M, K) bf16 @ W[dir] (K, N) bf16
// ---------------------------------------------------------------------------

#define P_BM 128
#define P_BN 128
#define P_BK 32
#define P_PAD 8
#define P_THREADS 256

__global__ void __launch_bounds__(P_THREADS)
gru_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w_f,
                const bf16* __restrict__ w_b, float* __restrict__ gx,
                int M, int N, int K) {
  __shared__ __align__(32) bf16 As[P_BM][P_BK + P_PAD];
  __shared__ __align__(32) bf16 Bs[P_BK][P_BN + P_PAD];
  __shared__ __align__(32) float Cs[8][16][16];

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
  // 16-byte vector loads need rows that start on 16-byte boundaries
  const bool vec_a = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0;
  const bool vec_b = (N % 8) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += P_BK) {
    // A tile: 128 x 32 = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int idx = tid + i * P_THREADS;
      int row = idx >> 2;
      int col = (idx & 3) * 8;
      int gm = m0 + row, gk = k0 + col;
      bf16* dst = &As[row][col];
      if (vec_a && gm < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(a + (size_t)gm * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? a[(size_t)gm * K + gk + e]
                                           : __float2bfloat16(0.0f);
      }
    }
    // B tile: 32 x 128 = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int idx = tid + i * P_THREADS;
      int row = idx >> 4;
      int col = (idx & 15) * 8;
      int gk = k0 + row, gn = n0 + col;
      bf16* dst = &Bs[row][col];
      if (vec_b && gk < K && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e]
                                           : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < P_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[wm * 64 + i * 16][kk], P_BK + P_PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[kk][wn * 32 + j * 16], P_BN + P_PAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time and writes the
  // in-bounds part (M and N need not be multiples of the tile)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      int rbase = m0 + wm * 64 + i * 16;
      int cbase = n0 + wn * 32 + j * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int idx = lane + e * 32;
        int r = idx >> 4, cc = idx & 15;
        int gm = rbase + r, gn = cbase + cc;
        if (gm < M && gn < N) c[(size_t)gm * N + gn] = Cs[warp][r][cc];
      }
      __syncwarp();
    }
  }
}
