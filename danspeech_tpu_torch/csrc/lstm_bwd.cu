// LSTM backward walk (training) for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:lstm_bwd_scan (kernel body
// _lstm_bwd_kernel). Same contract, gate order i, f, g, o, all streams in
// natural time order:
//   gx (T, B, 4H) bf16, the projection x @ w_ih + b_ih; hprev, cprev
//   (T, B, H) bf16, the states before each step in chain order; dout
//   (T, B, H) f32; lengths (B,) int32; w_hh (H, 4H) and its transpose
//   (4H, H) bf16; b_hh (4H,) f32.
//   Per step t, with m = length > t:
//     pre = gx_t + hprev_t @ w_hh + b_hh, i, f, g, o recomputed as in the
//     forward; c' = f cprev_t + i g;
//     dhnew = m (dh + dout_t); do = dhnew tanh(c');
//     dc' = dhnew o (1 - tanh(c')^2) + m dc;
//     dg4_t = [dc' g i (1 - i), dc' cprev_t f (1 - f), dc' i (1 - g^2),
//              do o (1 - o)];
//     dh <- bf16(dg4_t) @ w_hh^T + (1 - m) dh;  dc <- dc' f + (1 - m) dc.
//   dh and dc start at zero (the layer returns no final state) and end as
//   dh0, dc0. reverse walks t = T-1 .. 0 (the backward of the forward
//   chain), else 0 .. T-1 (the backward of the reverse-time chain). Steps
//   past a row's length write zeros to dg4 and pass dh and dc through. dg4
//   is the gradient of both gx and gh: they enter the gates additively.
//
// What bounds it on an H100, and what this design does about it:
// - Two products per step, 2*T*B*H*4H operations each: 131 GFLOP together at
//   the training shape (T=401, B=32, H=800), 0.13 ms at the bf16 peak,
//   against 338 MB of streams (dg4 alone is 164 MB of f32) and weights,
//   0.10 ms at 3.35 TB/s: bound by operations, closely.
// - The gate recompute hprev_t @ w_hh does not depend on the walk (hprev is
//   the stored forward stream), so it runs for all t at once, before the
//   walk, as one tiled tensor-core GEMM (gru_proj_kernel, gru_proj.cuh), bound by
//   the tensor cores. It writes gh into the dg4 output buffer: each
//   (t, b, j) is read back and overwritten with the gate gradient by the one
//   thread that owns it, so the walk needs no (T, B, 4H) scratch of its own.
// - The walk is T dependent steps, each a (B, 4H) x (4H, H) product against
//   w_hh^T that needs all 4H columns of the previous step's dg4: blocks of
//   one launch cannot wait for each other, so the launch boundary orders the
//   steps and the host loop launches lstm_bwd_step_kernel T + 1 times. A
//   block owns 16 hidden units j for 64 batch rows. It first finishes the
//   previous step's carry for its units, dh = partial + bf16(dg4_prev) @
//   w_hh^T[:, j] (rnn_step.cuh, one tile, depth 4H), then applies step t's
//   elementwise gradient at its units and leaves, for the next launch, dg4_t
//   in bf16 and the partial carry (1 - m) dh. Both ping-pong between two
//   buffers. dc is elementwise and owned: it is updated in place. The last
//   launch (t < 0) only finishes the carry: that is dh0. w_hh^T (5 MB at
//   H=800) stays in the 50 MB L2 across steps, so a step is bound by L2
//   reads of its 4H-deep slice, the unpipelined load-then-multiply loop and
//   the launch itself, not by HBM.
// - At H=800 and B=32 a launch has 50 blocks, two of whose four warps hold
//   batch rows: fewer than the card's 132 SMs. A persistent kernel with
//   w_hh^T resident in shared memory across the SMs, with the 4H depth split
//   over blocks, is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "gru_proj.cuh"
#include "rnn_step.cuh"

__global__ void __launch_bounds__(R_THREADS)
lstm_bwd_step_kernel(const bf16* __restrict__ gx,       // (T, B, 4H)
                     const bf16* __restrict__ cprev,    // (T, B, H)
                     const float* __restrict__ dout,    // (T, B, H)
                     const int* __restrict__ lengths,   // (B,)
                     const bf16* __restrict__ whht,     // (4H, H)
                     const float* __restrict__ bhh,     // (4H,)
                     const float* __restrict__ part_in,   // (B, H) f32
                     const bf16* __restrict__ dg_in,      // (B, 4H) bf16
                     float* __restrict__ part_out,        // (B, H) f32
                     bf16* __restrict__ dg_out,           // (B, 4H) bf16
                     float* __restrict__ dc,     // (B, H) f32, in place
                     float* dg4,                 // (T, B, 4H): gh in, dg4 out
                     int t, int B, int H) {
  __shared__ __align__(32) StepSmem<1> sm;
  const int j0 = blockIdx.x * R_J;
  const int b0 = blockIdx.y * R_BR;
  const int tid = threadIdx.x;
  const int G = 4 * H;

  step_product<1>(sm, dg_in, G, whht, H, 0, B, H, j0, b0);

  // epilogue: finish the carry, then step t's gradients for 64 x 16 units
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
    size_t row = (size_t)t * B + b;
    float* g = dg4 + row * G;
    const bf16* gxr = gx + row * G;
    float ig = sigmoidf_(__bfloat162float(gxr[j]) + g[j] + bhh[j]);
    float fg = sigmoidf_(__bfloat162float(gxr[H + j]) + g[H + j] + bhh[H + j]);
    float gg = tanhf(__bfloat162float(gxr[2 * H + j]) + g[2 * H + j] +
                     bhh[2 * H + j]);
    float og = sigmoidf_(__bfloat162float(gxr[3 * H + j]) + g[3 * H + j] +
                         bhh[3 * H + j]);
    float cp = __bfloat162float(cprev[row * H + j]);
    float th = tanhf(fg * cp + ig * gg);

    bool valid = lengths[b] > t;
    float dcv = dc[hi];
    float dhnew = valid ? dh + dout[row * H + j] : 0.0f;
    float d_o = dhnew * th;
    float dcn = dhnew * og * (1.0f - th * th) + (valid ? dcv : 0.0f);
    float dpre_i = dcn * gg * ig * (1.0f - ig);
    float dpre_f = dcn * cp * fg * (1.0f - fg);
    float dpre_g = dcn * ig * (1.0f - gg * gg);
    float dpre_o = d_o * og * (1.0f - og);

    g[j] = dpre_i;
    g[H + j] = dpre_f;
    g[2 * H + j] = dpre_g;
    g[3 * H + j] = dpre_o;
    bf16* dg = dg_out + (size_t)b * G;
    dg[j] = __float2bfloat16(dpre_i);
    dg[H + j] = __float2bfloat16(dpre_f);
    dg[2 * H + j] = __float2bfloat16(dpre_g);
    dg[3 * H + j] = __float2bfloat16(dpre_o);
    part_out[hi] = valid ? 0.0f : dh;
    if (valid) dc[hi] = dcn * fg;
  }
}

// ---------------------------------------------------------------------------
// Host entry: one chain's backward walk, on the caller's stream. part holds
// two buffers of (B, H) f32 and dg two of (B, 4H) bf16; on entry buffer 0 of
// each and dc hold zeros; on exit buffer (T + 1) % 2 of part holds dh0 and dc
// holds dc0. Returns cudaGetLastError() of the first launch that failed,
// else 0.
// ---------------------------------------------------------------------------

extern "C" int lstm_bwd_launch(
    const void* gx, const void* hprev, const void* cprev, const void* dout,
    const void* lengths, const void* w_hh, const void* w_hht, const void* b_hh,
    void* part,   // (2 buffers, B, H) f32
    void* dg,     // (2 buffers, B, 4H) bf16
    void* dc,     // (B, H) f32
    void* dg4,    // (T, B, 4H) f32
    int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = T * B;
  const int N = 4 * H;
  // gh = hprev @ w_hh for every step, into the dg4 buffer
  int rc = gru_proj_launch(
      static_cast<const bf16*>(hprev), static_cast<const bf16*>(w_hh),
      static_cast<const bf16*>(w_hh), static_cast<float*>(dg4), M, N, H, 1, s);
  if (rc != 0) return rc;
  cudaError_t err;

  const size_t psz = (size_t)B * H;
  const size_t gsz = (size_t)B * N;
  float* pf = static_cast<float*>(part);
  bf16* gb = static_cast<bf16*>(dg);
  dim3 grid((H + R_J - 1) / R_J, (B + R_BR - 1) / R_BR);
  for (int step = 0; step <= T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    const int t = step == T ? -1 : (reverse ? T - 1 - step : step);
    lstm_bwd_step_kernel<<<grid, R_THREADS, 0, s>>>(
        static_cast<const bf16*>(gx), static_cast<const bf16*>(cprev),
        static_cast<const float*>(dout), static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hht), static_cast<const float*>(b_hh),
        pf + src * psz, gb + src * gsz, pf + dst * psz, gb + dst * gsz,
        static_cast<float*>(dc), static_cast<float*>(dg4), t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
