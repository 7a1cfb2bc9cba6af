// One LSTM chain over a precomputed input projection, for Hopper, with and
// without the cell stream.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:lstm_scan (kernel body
// _lstm_step_kernel) and :lstm_scan_with_cell (_lstm_step_kernel_cell).
// Same contract, gate order i, f, g, o:
//   gx (T, B, 4H) bf16, the projection x @ w_ih + b_ih (the bias is already
//   inside, rounded with it); lengths (B,) int32; w_hh (H, 4H) bf16; b_hh
//   (4H,) f32; h0, c0 (B, H) f32;
//   gh = bf16(h) @ w_hh accumulated in f32, pre = gx + gh + b_hh,
//   c' = f c + i g, h' = o tanh(c'), gates and both carried states in f32;
//   out (T, B, H) bf16 = h' where t < length, exact zeros elsewhere, and the
//   states freeze there; lstm_scan_with_cell also writes c_seq (T, B, H) bf16
//   = c' masked the same way (the residual of the backward walk, which reads
//   it rounded to bf16). reverse walks t = T-1 .. 0. h_last and c_last are
//   the f32 states after the walk.
//
// What bounds it on an H100, and what this design does about it:
// - T dependent steps, each a (B, H) x (H, 4H) product: 2*T*B*H*4H
//   operations, 263 GFLOP at the serving shape (T=401, B=128, H=800), 0.27 ms
//   at the bf16 peak, against 416 MB of streams and weights (0.12 ms at
//   3.35 TB/s): bound by operations. Every step needs all of h_{t-1} and
//   blocks of one launch cannot wait for each other, so the launch boundary
//   orders the steps: the host loop launches lstm_step_kernel T times on the
//   caller's stream.
// - Each block owns 16 hidden units j (columns j, H+j, 2H+j, 3H+j of w_hh:
//   four WMMA tiles per chunk, rnn_step.cuh) for 64 batch rows, and applies
//   the gates, the length mask and the writes in its epilogue. h ping-pongs
//   between two buffers (the f32 state and the bf16 copy that the next
//   launch's product reads); c is read and written only by the thread that
//   owns (b, j), so it is updated in place. w_hh (5 MB at H=800) stays in
//   the 50 MB L2 across steps, so a step is bound by L2 reads, its
//   unpipelined load-then-multiply loop and the launch itself, not by HBM.
// - At H=800 a launch has 50 x ceil(B/64) blocks (100 at B=128, 50 at B=32),
//   fewer than the card's 132 SMs. A persistent kernel with w_hh resident in
//   shared memory across the SMs, finer tiles and a grid-wide barrier per
//   step is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "rnn_step.cuh"

__global__ void __launch_bounds__(R_THREADS)
lstm_step_kernel(const bf16* __restrict__ gx,       // (T, B, 4H)
                 const int* __restrict__ lengths,   // (B,)
                 const bf16* __restrict__ whh,      // (H, 4H)
                 const float* __restrict__ bhh,     // (4H,)
                 const float* __restrict__ h_in,    // (B, H) f32
                 const bf16* __restrict__ hb_in,    // (B, H) bf16
                 float* __restrict__ h_out,         // (B, H) f32
                 bf16* __restrict__ hb_out,         // (B, H) bf16
                 float* __restrict__ c,             // (B, H) f32, in place
                 bf16* __restrict__ out,            // (T, B, H)
                 bf16* __restrict__ cseq,           // (T, B, H) or null
                 int t, int B, int H) {
  __shared__ __align__(32) StepSmem<4> sm;
  const int j0 = blockIdx.x * R_J;
  const int b0 = blockIdx.y * R_BR;
  const int tid = threadIdx.x;
  const int G = 4 * H;

  step_product<4>(sm, hb_in, H, whh, G, H, B, H, j0, b0);

  // epilogue: gates, mask, writes and state updates for 64 x 16 outputs
#pragma unroll
  for (int e = 0; e < (R_BR * R_J) / R_THREADS; ++e) {
    int idx = tid + e * R_THREADS;
    int r = idx / R_J, cj = idx % R_J;
    int b = b0 + r, j = j0 + cj;
    if (b >= B || j >= H) continue;
    const bf16* gxr = gx + ((size_t)t * B + b) * G;
    float pi = __bfloat162float(gxr[j]) + sm.C[r][cj] + bhh[j];
    float pf = __bfloat162float(gxr[H + j]) + sm.C[r][R_J + cj] + bhh[H + j];
    float pg = __bfloat162float(gxr[2 * H + j]) + sm.C[r][2 * R_J + cj] +
               bhh[2 * H + j];
    float po = __bfloat162float(gxr[3 * H + j]) + sm.C[r][3 * R_J + cj] +
               bhh[3 * H + j];
    float ig = sigmoidf_(pi);
    float fg = sigmoidf_(pf);
    float gg = tanhf(pg);
    float og = sigmoidf_(po);
    size_t hi = (size_t)b * H + j;
    float cp = c[hi];
    float hp = h_in[hi];
    float cn = fg * cp + ig * gg;
    float hn = og * tanhf(cn);
    bool valid = lengths[b] > t;
    float hnext = valid ? hn : hp;
    if (valid) c[hi] = cn;
    h_out[hi] = hnext;
    hb_out[hi] = __float2bfloat16(hnext);
    size_t oi = ((size_t)t * B + b) * H + j;
    out[oi] = __float2bfloat16(valid ? hn : 0.0f);
    if (cseq != nullptr) cseq[oi] = __float2bfloat16(valid ? cn : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// Host entries: one chain, on the caller's stream. h32/h16 hold two buffers
// of (B, H); buffer 0 holds h0 (f32 and its bf16 copy) on entry and buffer
// T % 2 holds h_last on exit; c holds c0 on entry and c_last on exit. Each
// returns cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

static int lstm_walk(const void* gx, const void* lengths, const void* w_hh,
                     const void* b_hh, void* h32, void* h16, void* c,
                     void* out, void* cseq, int T, int B, int H, int reverse,
                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t hsz = (size_t)B * H;
  float* hf = static_cast<float*>(h32);
  bf16* hb = static_cast<bf16*>(h16);
  dim3 grid((H + R_J - 1) / R_J, (B + R_BR - 1) / R_BR);
  for (int step = 0; step < T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    const int t = reverse ? T - 1 - step : step;
    lstm_step_kernel<<<grid, R_THREADS, 0, s>>>(
        static_cast<const bf16*>(gx), static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hh), static_cast<const float*>(b_hh),
        hf + src * hsz, hb + src * hsz, hf + dst * hsz, hb + dst * hsz,
        static_cast<float*>(c), static_cast<bf16*>(out),
        static_cast<bf16*>(cseq), t, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int lstm_scan_launch(
    const void* gx, const void* lengths, const void* w_hh, const void* b_hh,
    void* h32,   // (2 buffers, B, H) f32
    void* h16,   // (2 buffers, B, H) bf16
    void* c,     // (B, H) f32
    void* out,   // (T, B, H) bf16
    int T, int B, int H, int reverse, void* stream) {
  return lstm_walk(gx, lengths, w_hh, b_hh, h32, h16, c, out, nullptr, T, B, H,
                   reverse, stream);
}

extern "C" int lstm_scan_with_cell_launch(
    const void* gx, const void* lengths, const void* w_hh, const void* b_hh,
    void* h32, void* h16, void* c, void* out,
    void* cseq,  // (T, B, H) bf16
    int T, int B, int H, int reverse, void* stream) {
  return lstm_walk(gx, lengths, w_hh, b_hh, h32, h16, c, out, cseq, T, B, H,
                   reverse, stream);
}
