// The step products of the float32 step design, shared by the float32
// variants of the recurrent kernels (gru_f32.cu, lstm_f32.cu,
// rnn_tanh_f32.cu): one launch per time step from a host loop, the launch
// boundary as the barrier between steps, each block rereading its slice of
// the float32 weights from L2.
//
// Float32 products run on the CUDA cores (FFMA): Hopper's tensor cores have
// no float32 x float32 shape, and TF32 keeps 10 mantissa bits and is not
// float32. A step block has F_THREADS = 256 threads and owns F_J = 32 hidden
// units for F_BR = 64 batch rows; thread (ty = tid / 16, tx = tid % 16) holds
// the sums of rows b0 + 4 ty .. + 3 and units j0 + 2 tx, j0 + 2 tx + 1 in
// registers, so the caller's epilogue (gates, mask, writes) runs on the
// registers that hold them. The depth is walked in chunks of F_KC = 32
// through shared memory, the next chunk's loads in flight (registers) while
// the chunk at hand is multiplied.
//
// - f32_fwd_product<G>: the forward step's gate sums of G gates,
//   acc[r][g * 2 + u] = sum_k h[b, k] w_hh[k, g H + j], k < H, w_hh (H, G H)
//   row-major; the block reads columns j, H + j, ... of its units.
// - f32_bwd_product: the backward walk's carry,
//   acc[r][u] = sum_k dg[b, k] w_hh[j, k], k < K = G H: dg (B, K) @ w_hh^T
//   at the block's units, w_hh's rows j read as they lie.
// Rows past B and units past H read zeros and their sums are not used; the
// sum over the depth runs in order within a thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define F_J 32        // hidden units per block
#define F_BR 64       // batch rows per block
#define F_KC 32       // depth of one shared-memory chunk
#define F_THREADS 256

__device__ __forceinline__ float f32_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int G>
__device__ __forceinline__ void f32_fwd_product(const float* __restrict__ hin,  // (B, H)
                                                const float* __restrict__ whh,  // (H, G H)
                                                int j0, int b0, int B, int H,
                                                float (&acc)[4][2 * G]) {
  __shared__ float As[F_KC][F_BR + 1];                   // h chunk, depth-major
  __shared__ __align__(16) float Bs[F_KC][G * F_J];      // [k][gate * F_J + unit]
  constexpr int NB = G * F_J * F_KC / F_THREADS;         // w_hh loads a thread
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t N = (size_t)G * H;

  // a chunk: 64 rows x 32 depths of h (8 a thread, a warp reads one row's 32
  // depths) and 32 depths x 32 G columns of w_hh (4 G a thread, a warp reads
  // 32 consecutive units of one gate at one depth)
  float ra[8], rb[NB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * F_THREADS;
      const int gb = b0 + (idx >> 5), gk = k0 + (idx & 31);
      ra[i] = (gb < B && gk < H) ? hin[(size_t)gb * H + gk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + i * F_THREADS;
      const int kk = idx / (G * F_J), col = idx % (G * F_J);
      const int gk = k0 + kk, gj = j0 + (col & (F_J - 1));
      rb[i] = (gk < H && gj < H) ? whh[(size_t)gk * N + (size_t)(col / F_J) * H + gj] : 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * F_THREADS;
      As[idx & 31][idx >> 5] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = tid + i * F_THREADS;
      Bs[idx / (G * F_J)][idx % (G * F_J)] = rb[i];
    }
  };

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 2 * G; ++q) acc[r][q] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < H; k0 += F_KC) {
    store();
    __syncthreads();
    if (k0 + F_KC < H) load(k0 + F_KC);  // in flight during the FFMAs below
#pragma unroll 8
    for (int kk = 0; kk < F_KC; ++kk) {
      float a[4], w[2 * G];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 v = *reinterpret_cast<const float2*>(&Bs[kk][g * F_J + tx * 2]);
        w[g * 2] = v.x;
        w[g * 2 + 1] = v.y;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 2 * G; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
    }
    __syncthreads();  // the chunk is read before the next store
  }
}

__device__ __forceinline__ void f32_bwd_product(const float* __restrict__ dg,   // (B, K)
                                                const float* __restrict__ whh,  // (H, K)
                                                int j0, int b0, int B, int H, int K,
                                                float (&acc)[4][2]) {
  __shared__ float As[F_KC][F_BR + 1];  // dg chunk, depth-major
  __shared__ float Bs[F_KC][F_J + 1];   // w_hh^T chunk: [k][unit] = w_hh[j0 + unit][k]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // a chunk: 64 rows x 32 depths of dg (8 a thread) and 32 units x 32
  // depths of w_hh (4 a thread, a warp reads one unit's row along the depth)
  float ra[8], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * F_THREADS;
      const int gb = b0 + (idx >> 5), gk = k0 + (idx & 31);
      ra[i] = (gb < B && gk < K) ? dg[(size_t)gb * K + gk] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * F_THREADS;
      const int gj = j0 + (idx >> 5), gk = k0 + (idx & 31);
      rb[i] = (gj < H && gk < K) ? whh[(size_t)gj * K + gk] : 0.0f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * F_THREADS;
      As[idx & 31][idx >> 5] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * F_THREADS;
      Bs[idx & 31][idx >> 5] = rb[i];
    }
  };

#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += F_KC) {
    store();
    __syncthreads();
    if (k0 + F_KC < K) load(k0 + F_KC);
#pragma unroll 8
    for (int kk = 0; kk < F_KC; ++kk) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
      const float w0 = Bs[kk][tx * 2], w1 = Bs[kk][tx * 2 + 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(a[r], w0, acc[r][0]);
        acc[r][1] = fmaf(a[r], w1, acc[r][1]);
      }
    }
    __syncthreads();
  }
}

// The grid of a step launch: the units of each chain along x, row blocks
// along y, the chains along z. Returns false for a batch the grid cannot
// take.
static inline bool f32_step_grid(int B, int H, int chains, dim3* grid) {
  const unsigned gy = (unsigned)((B + F_BR - 1) / F_BR);
  if (gy > 65535u) return false;
  *grid = dim3((H + F_J - 1) / F_J, gy, chains);
  return true;
}
