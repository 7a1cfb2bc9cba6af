// tanh-RNN backward walk (training) for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:rnn_tanh_bwd_scan (kernel body
// _rnn_tanh_bwd_kernel). Same contract, streams in natural time order:
//   out (T, B, H) bf16, the forward output stream (h' where t < length,
//   zeros elsewhere); dout (T, B, H) f32; lengths (B,) int32; w_hh^T (H, H)
//   bf16.
//   Per step t, with m = length > t:
//     dhnew = m (dh + dout_t); dpre_t = dhnew (1 - out_t^2);
//     dh <- bf16(dpre_t) @ w_hh^T + (1 - m) dh.
//   tanh' comes off the stored stream: nothing is recomputed. dh starts at
//   zero (the layer returns no final state) and ends as dh0. reverse walks
//   t = T-1 .. 0 (the backward of the forward chain), else 0 .. T-1 (the
//   backward of the reverse-time chain). Steps past a row's length write
//   zeros to dpre and pass dh through.
//
// What bounds it on an H100, and what this design does about it:
// - 2*T*B*H*H operations, 16 GFLOP at the training shape (T=401, B=32,
//   H=800), 0.017 ms at the bf16 peak, against 104 MB of streams (0.031 ms
//   at 3.35 TB/s): bound by bytes. Neither is what a step costs here: each
//   of the T dependent steps needs all H columns of the previous step's
//   dpre, blocks of one launch cannot wait for each other, so the launch
//   boundary orders the steps and the host loop launches
//   rnn_tanh_bwd_step_kernel T + 1 times; a step of 0.04 GFLOP is bound by
//   the launch and the latency of its load-then-multiply loop.
// - A block owns 16 hidden units j for 64 batch rows. It first finishes the
//   previous step's carry for its units, dh = partial + bf16(dpre_prev) @
//   w_hh^T[:, j] (rnn_step.cuh, one tile), then applies step t's elementwise
//   gradient and leaves, for the next launch, dpre_t in bf16 and the partial
//   carry (1 - m) dh. Both ping-pong between two buffers. The last launch
//   (t < 0) only finishes the carry: that is dh0.
// - At H=800 and B=32 a launch has 50 blocks, fewer than the card's 132 SMs.
//   A persistent kernel with w_hh^T resident in shared memory and a
//   grid-wide barrier per step is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "rnn_step.cuh"

__global__ void __launch_bounds__(R_THREADS)
rnn_tanh_bwd_step_kernel(const bf16* __restrict__ out,      // (T, B, H)
                         const float* __restrict__ dout,    // (T, B, H)
                         const int* __restrict__ lengths,   // (B,)
                         const bf16* __restrict__ whht,     // (H, H)
                         const float* __restrict__ part_in,   // (B, H) f32
                         const bf16* __restrict__ dp_in,      // (B, H) bf16
                         float* __restrict__ part_out,        // (B, H) f32
                         bf16* __restrict__ dp_out,           // (B, H) bf16
                         float* __restrict__ dpre,            // (T, B, H)
                         int t, int B, int H) {
  __shared__ __align__(32) StepSmem<1> sm;
  const int j0 = blockIdx.x * R_J;
  const int b0 = blockIdx.y * R_BR;
  const int tid = threadIdx.x;

  step_product<1>(sm, dp_in, H, whht, H, 0, B, H, j0, b0);

  // epilogue: finish the carry, then step t's gradient for 64 x 16 units
#pragma unroll
  for (int e = 0; e < (R_BR * R_J) / R_THREADS; ++e) {
    int idx = tid + e * R_THREADS;
    int r = idx / R_J, cj = idx % R_J;
    int b = b0 + r, j = j0 + cj;
    if (b >= B || j >= H) continue;
    size_t hi = (size_t)b * H + j;
    float dh = part_in[hi] + sm.C[r][cj];
    if (t < 0) {  // after the last step: the carry is dh0
      part_out[hi] = dh;
      continue;
    }
    size_t oi = ((size_t)t * B + b) * H + j;
    bool valid = lengths[b] > t;
    float hn = __bfloat162float(out[oi]);
    float dhnew = valid ? dh + dout[oi] : 0.0f;
    float dp = dhnew * (1.0f - hn * hn);
    dpre[oi] = dp;
    dp_out[hi] = __float2bfloat16(dp);
    part_out[hi] = valid ? 0.0f : dh;
  }
}

// ---------------------------------------------------------------------------
// Host entry: one chain's backward walk, on the caller's stream. part holds
// two buffers of (B, H) f32 and dp two of (B, H) bf16; on entry buffer 0 of
// each holds zeros; on exit buffer (T + 1) % 2 of part holds dh0. Returns
// cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int rnn_tanh_bwd_launch(
    const void* out, const void* dout, const void* lengths, const void* w_hht,
    void* part,   // (2 buffers, B, H) f32
    void* dp,     // (2 buffers, B, H) bf16
    void* dpre,   // (T, B, H) f32
    int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t psz = (size_t)B * H;
  float* pf = static_cast<float*>(part);
  bf16* pb = static_cast<bf16*>(dp);
  dim3 grid((H + R_J - 1) / R_J, (B + R_BR - 1) / R_BR);
  for (int step = 0; step <= T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    const int t = step == T ? -1 : (reverse ? T - 1 - step : step);
    rnn_tanh_bwd_step_kernel<<<grid, R_THREADS, 0, s>>>(
        static_cast<const bf16*>(out), static_cast<const float*>(dout),
        static_cast<const int*>(lengths), static_cast<const bf16*>(w_hht),
        pf + src * psz, pb + src * psz, pf + dst * psz, pb + dst * psz,
        static_cast<float*>(dpre), t, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
