// The product of one recurrence step, shared by the LSTM and tanh-RNN
// kernels (lstm_scan.cu, lstm_bwd.cu, rnn_tanh_scan.cu, rnn_tanh_bwd.cu).
// Include after <cuda_bf16.h>, <mma.h>, <stdint.h> and the bf16 typedef.
//
// A block owns R_J hidden units for R_BR batch rows. step_product computes,
// for NG gates, C[:, g * R_J + c] = sum_k a[b0 + r, k] * w[k, g * gate_stride
// + j0 + c] with WMMA (bf16 operands, f32 accumulation): the block's
// gate-aligned column slice of a (B, K) x (K, ldw) product. NG = 4 is the
// LSTM forward step (columns j, H + j, 2H + j, 3H + j of w_hh); NG = 1 is
// the tanh step and the carry of both backward walks (w_hh^T, one column
// block). The state a and the weights w are read from L2 in chunks of R_KC;
// rows past B, columns past H and depth past K are zero-filled, and warps
// whose 16 rows lie wholly past B skip their products.

#pragma once

#define R_J 16        // hidden units per block (one WMMA tile per gate)
#define R_BR 64       // batch rows per block (one 16-row WMMA tile per warp)
#define R_KC 64       // depth of one shared-memory chunk of the product
#define R_PAD 8
#define R_THREADS 128

template <int NG>
struct StepSmem {
  bf16 A[R_BR][R_KC + R_PAD];
  bf16 W[R_KC][NG * R_J + R_PAD];
  float C[R_BR][NG * R_J + 4];
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int NG>
__device__ __forceinline__ void step_product(
    StepSmem<NG>& sm,
    const bf16* __restrict__ a,   // (B, K) bf16
    int K,
    const bf16* __restrict__ w,   // (K, ldw) bf16
    int ldw, int gate_stride,
    int B, int H, int j0, int b0) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // this warp's 16 rows hold at least one real batch row (warp-uniform)
  const bool active = b0 + warp * 16 < B;
  // 16-byte vector loads need rows and gate slices on 16-byte boundaries
  const bool vec = (K % 8) == 0 && (H % 8) == 0 && (ldw % 8) == 0 &&
                   (gate_stride % 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) wmma::fill_fragment(acc[g], 0.0f);

  for (int k0 = 0; k0 < K; k0 += R_KC) {
    // state tile: 64 rows x 64 k = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + i * R_THREADS;
      int row = idx >> 3;
      int col = (idx & 7) * 8;
      int gb = b0 + row, gk = k0 + col;
      bf16* dst = &sm.A[row][col];
      if (vec && gb < B && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(a + (size_t)gb * K + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gb < B && gk + e < K) ? a[(size_t)gb * K + gk + e]
                                          : __float2bfloat16(0.0f);
      }
    }
    // weight slice: 64 k x (NG gates x 16 units) = NG * 128 chunks of 8
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      int idx = tid + i * R_THREADS;
      int row = idx / (2 * NG);
      int rem = idx % (2 * NG);
      int g = rem >> 1;
      int col = (rem & 1) * 8;
      int gk = k0 + row, gj = j0 + col;
      bf16* dst = &sm.W[row][g * R_J + col];
      const bf16* src = w + (size_t)gk * ldw + (size_t)g * gate_stride + gj;
      if (vec && gk < K && gj + 8 <= H) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gj + e < H) ? src[e] : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < R_KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, &sm.A[warp * 16][kk], R_KC + R_PAD);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, &sm.W[kk][g * R_J], NG * R_J + R_PAD);
          wmma::mma_sync(acc[g], af, bfr, acc[g]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
    wmma::store_matrix_sync(&sm.C[warp * 16][g * R_J], acc[g], NG * R_J + 4,
                            wmma::mem_row_major);
  __syncthreads();
}
