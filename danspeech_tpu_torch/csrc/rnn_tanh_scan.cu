// One tanh-RNN chain over a precomputed input projection, for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:rnn_tanh_scan (kernel body
// _rnn_tanh_step_kernel). Same contract:
//   gx (T, B, H) bf16, the projection x @ w_ih + b_ih + b_hh (both biases
//   are already inside, rounded with it); lengths (B,) int32; w_hh (H, H)
//   bf16; the chain starts from h = 0;
//   h' = tanh(gx_t + bf16(h) @ w_hh), the product accumulated and the state
//   carried in f32; out (T, B, H) bf16 = h' where t < length, exact zeros
//   elsewhere, and the state freezes there. reverse walks t = T-1 .. 0.
//   h_last is the f32 state after the walk.
//
// What bounds it on an H100, and what this design does about it:
// - T dependent steps, each a (B, H) x (H, H) product: 2*T*B*H*H operations,
//   66 GFLOP at the serving shape (T=401, B=128, H=800), 0.066 ms at the
//   bf16 peak, against 166 MB of streams and weights (0.049 ms at
//   3.35 TB/s): bound by operations, closely. Every step needs all of
//   h_{t-1} and blocks of one launch cannot wait for each other, so the
//   launch boundary orders the steps: the host loop launches
//   rnn_tanh_step_kernel T times on the caller's stream.
// - Each block owns 16 hidden units for 64 batch rows: one WMMA tile per
//   chunk of the product (rnn_step.cuh), then tanh, the length mask, the out
//   write and the h update in its epilogue. h ping-pongs between two buffers
//   (the f32 state and the bf16 copy that the next launch's product reads).
//   w_hh (1.3 MB at H=800) stays in L2, so a step of 0.16 GFLOP is bound by
//   the launch itself and the latency of its load-then-multiply loop.
// - At H=800 a launch has 50 x ceil(B/64) blocks, fewer than the card's 132
//   SMs. A persistent kernel with w_hh resident in shared memory across the
//   SMs and a grid-wide barrier per step is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "rnn_step.cuh"

__global__ void __launch_bounds__(R_THREADS)
rnn_tanh_step_kernel(const bf16* __restrict__ gx,       // (T, B, H)
                     const int* __restrict__ lengths,   // (B,)
                     const bf16* __restrict__ whh,      // (H, H)
                     const float* __restrict__ h_in,    // (B, H) f32
                     const bf16* __restrict__ hb_in,    // (B, H) bf16
                     float* __restrict__ h_out,         // (B, H) f32
                     bf16* __restrict__ hb_out,         // (B, H) bf16
                     bf16* __restrict__ out,            // (T, B, H)
                     int t, int B, int H) {
  __shared__ __align__(32) StepSmem<1> sm;
  const int j0 = blockIdx.x * R_J;
  const int b0 = blockIdx.y * R_BR;
  const int tid = threadIdx.x;

  step_product<1>(sm, hb_in, H, whh, H, 0, B, H, j0, b0);

  // epilogue: tanh, mask, out write and h update for 64 x 16 outputs
#pragma unroll
  for (int e = 0; e < (R_BR * R_J) / R_THREADS; ++e) {
    int idx = tid + e * R_THREADS;
    int r = idx / R_J, cj = idx % R_J;
    int b = b0 + r, j = j0 + cj;
    if (b >= B || j >= H) continue;
    size_t oi = ((size_t)t * B + b) * H + j;
    size_t hi = (size_t)b * H + j;
    float hn = tanhf(__bfloat162float(gx[oi]) + sm.C[r][cj]);
    bool valid = lengths[b] > t;
    float hnext = valid ? hn : h_in[hi];
    h_out[hi] = hnext;
    hb_out[hi] = __float2bfloat16(hnext);
    out[oi] = __float2bfloat16(valid ? hn : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// Host entry: one chain, on the caller's stream. h32/h16 hold two buffers of
// (B, H); buffer 0 holds zeros on entry, and buffer T % 2 holds h_last on
// exit. Returns cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int rnn_tanh_scan_launch(
    const void* gx, const void* lengths, const void* w_hh,
    void* h32,   // (2 buffers, B, H) f32
    void* h16,   // (2 buffers, B, H) bf16
    void* out,   // (T, B, H) bf16
    int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t hsz = (size_t)B * H;
  float* hf = static_cast<float*>(h32);
  bf16* hb = static_cast<bf16*>(h16);
  dim3 grid((H + R_J - 1) / R_J, (B + R_BR - 1) / R_BR);
  for (int step = 0; step < T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    const int t = reverse ? T - 1 - step : step;
    rnn_tanh_step_kernel<<<grid, R_THREADS, 0, s>>>(
        static_cast<const bf16*>(gx), static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hh), hf + src * hsz, hb + src * hsz,
        hf + dst * hsz, hb + dst * hsz, static_cast<bf16*>(out), t, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
