// Tiled float32 GEMM on the CUDA cores (FFMA), shared by the float32 step
// design of the GRU kernels (gru_f32.cu): the input projection of the fused
// bidirectional layer (x @ w_ih of both directions) and the gate recompute of
// the backward walk (hprev @ w_hh of each chain).
//
//   C[z] (M, N) = A[z] (M, K) @ B[z] (K, N), float32, row-major, z < 2.
//
// Hopper's tensor cores have no float32 x float32 shape (TF32 keeps 10
// mantissa bits and is not float32), so the product runs on the FP32 units:
// 67 TFLOP/s on an H100 SXM at 700 W, the bound of these products. A block
// of 256 threads computes a 128 x 128 tile over chunks of depth 8; each
// thread owns an 8 x 8 register tile (two 4-row and two 4-column strips, 64
// apart, so its shared-memory reads are 16-byte vectors without bank
// conflicts), 64 FFMAs for every 4 vector loads. The next chunk is loaded
// into registers while the chunk at hand is multiplied (two shared-memory
// buffers), so a chunk's global loads overlap the previous chunk's FFMAs.
// M, N and K need not be multiples of the tile; rows whose length is no
// multiple of 4 floats, or that do not start on 16 bytes, take scalar loads.
// The sum over K runs in order within a thread: the result differs from
// cuBLAS's full float32 product only by the order of the sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SG_BM 128
#define SG_BN 128
#define SG_BK 8
#define SG_THREADS 256

struct SgemmArgs {
  const float* a[2];  // (M, K)
  const float* b[2];  // (K, N)
  float* c[2];        // (M, N)
  int M, N, K;
};

__global__ void __launch_bounds__(SG_THREADS)
sgemm_kernel(SgemmArgs p) {
  __shared__ __align__(16) float As[2][SG_BK][SG_BM];  // depth-major
  __shared__ __align__(16) float Bs[2][SG_BK][SG_BN];

  const int z = blockIdx.z;
  const float* __restrict__ A = p.a[z];
  const float* __restrict__ B = p.b[z];
  float* __restrict__ C = p.c[z];
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * SG_BM;
  const int n0 = blockIdx.x * SG_BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // what a thread loads of a chunk: 4 consecutive depths of one row of A,
  // 4 consecutive columns of one depth of B
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;
  const bool a_vec = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool b_vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int gm = m0 + a_row, gk = k0 + a_k;
    if (a_vec && gm < M && gk + 3 < K) {
      const float4 v = *reinterpret_cast<const float4*>(A + (size_t)gm * K + gk);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ra[e] = (gm < M && gk + e < K) ? A[(size_t)gm * K + gk + e] : 0.0f;
    }
    const int bk = k0 + b_k, gn = n0 + b_col;
    if (b_vec && bk < K && gn + 3 < N) {
      const float4 v = *reinterpret_cast<const float4*>(B + (size_t)bk * N + gn);
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rb[e] = (bk < K && gn + e < N) ? B[(size_t)bk * N + gn + e] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) As[buf][a_k + e][a_row] = ra[e];
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_col]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += SG_BK) {
    const bool more = k0 + SG_BK < K;
    if (more) load(k0 + SG_BK);
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the barrier that ended the
    // previous chunk
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) C[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// C[z] = A[z] @ B[z] for z < nz (1 or 2), on ``s``. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a grid
// the card cannot take.
static int sgemm_launch(const float* a0, const float* a1, const float* b0,
                        const float* b1, float* c0, float* c1, int M, int N,
                        int K, int nz, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || nz < 1 || nz > 2) return (int)cudaErrorInvalidValue;
  const unsigned gy = (unsigned)((M + SG_BM - 1) / SG_BM);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  SgemmArgs p;
  p.a[0] = a0; p.a[1] = a1;
  p.b[0] = b0; p.b[1] = b1;
  p.c[0] = c0; p.c[1] = c1;
  p.M = M; p.N = N; p.K = K;
  dim3 grid((N + SG_BN - 1) / SG_BN, gy, nz);
  sgemm_kernel<<<grid, SG_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
