// Float32 variants of the three LSTM kernels, for Hopper: what the port runs
// for compute_dtype="float32" serving and mixed_precision=False training of
// rnn_type="lstm" models (ops/lstm_cuda.py dispatches on the operands'
// dtype).
//
// Replaces, in float32, danspeech_tpu/ops/pallas_gru.py:
//   lstm_scan (B5) and lstm_scan_with_cell (B6) -> lstm_f32_scan_launch,
//       one chain or two (the chain is the grid's z index), the cell stream
//       written only when its pointer is set;
//   lstm_bwd_scan (B7)                         -> lstm_f32_bwd_launch, one
//       chain or the two chains of a bidirectional layer.
// The Pallas kernels are dtype-generic: float32 weights give float32
// products there. Same contract as the bf16 kernels (lstm_scan.cu,
// lstm_bwd.cu), gate order i, f, g, o, every stream and weight in float32:
//   gx (T, B, 4H), the projection x @ w_ih + b_ih; the kernel adds b_hh;
//   gh = h @ w_hh with h the float32 state itself (the bf16 kernels round h
//   to bf16 first; here nothing is rounded); c' = f c + i g, h' = o tanh(c');
//   rows past their length freeze h and c and emit exact zeros to out and
//   c_seq; a reverse chain walks t = T-1 .. 0 and holds its states at h0, c0
//   until t < length, with no reversed copy of gx. The backward walk follows
//   lstm_bwd.cu's equations with float32 dg4 as the carry's left operand.
//
// What bounds it on an H100, and what this design does about it:
// - Float32 products run on the CUDA cores (FFMA) at 67 TFLOP/s (FP32, SXM,
//   700 W): the forward recurrence at T=401, B=128, H=800 is 263 GFLOP, 3.9
//   ms at that peak over every step (less over the valid ones).
// - A resident design would fit at this width (f32 w_hh is 10.24 MB a chain
//   at H = 800 against about 30 MB of shared memory on the card), but this is
//   the simple step design of gru_f32.cu: one launch per time step from a
//   host loop, the launch boundary as the barrier between steps, each block
//   rereading its slice of w_hh from L2 (f32_step.cuh).
// - Forward step (lstm_f32_step_kernel): a block owns 32 units (the columns
//   j, H+j, 2H+j, 3H+j of w_hh) for 64 batch rows; each of its 256 threads
//   holds 4 rows x 2 units x 4 gates in registers (f32_fwd_product<4>), and
//   the gates, the c and h updates, the mask and the writes happen in the
//   registers that hold the sums. c is owned: the thread that owns (b, j)
//   updates it in place; h ping-pongs between two buffers, since every block
//   reads all of the previous step's h.
// - Backward (lstm_f32_bwd_step_kernel): the gate recompute hprev @ w_hh for
//   every t does not depend on the walk, so it is one FFMA GEMM for both
//   chains (sgemm.cuh) into the dg4 output buffer; each (t, b, j) of it is
//   read back as gh and overwritten with the gate gradient by the one thread
//   that owns it. Then T + 1 step launches: each finishes the carry of the
//   previous step, dh = partial + dg4_prev @ w_hh^T[:, j] (depth 4H, read
//   from the previous step's row of dg4, which the launch before wrote in
//   full), applies step t's gradient, and leaves the partial carry
//   (1 - m) dh and dc in place (both owned). The last launch (t < 0) only
//   finishes the carry: dh0; dc0 is the dc after step 0.
// Measured by chip_smoke.py (phase 12): see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_step.cuh"
#include "sgemm.cuh"

// ---------------------------------------------------------------------------
// Forward step (B5, B6): one time step of one or two chains
// ---------------------------------------------------------------------------

struct LstmF32Chains {
  const float* gx[2];   // (T, B, 4H), b_ih inside
  const float* whh[2];  // (H, 4H)
  const float* bhh[2];  // (4H,)
  float* out[2];        // (T, B, H)
  float* cseq[2];       // (T, B, H), or null: no cell stream
  int reverse[2];
};

// thread (ty = tid / 16, tx = tid % 16): rows b0 + 4 ty .. + 3, units
// j0 + 2 tx and j0 + 2 tx + 1, the four gates of each
__global__ void __launch_bounds__(F_THREADS)
lstm_f32_step_kernel(LstmF32Chains p, const int* __restrict__ lengths,
                     const float* __restrict__ h_in,  // (chains, B, H)
                     float* __restrict__ h_out,       // (chains, B, H)
                     float* __restrict__ cst,         // (chains, B, H), in place
                     int step, int T, int B, int H) {
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * F_J;
  const int b0 = blockIdx.y * F_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int t = p.reverse[c] ? T - 1 - step : step;
  const size_t coff = (size_t)c * B * H;
  float acc[4][8];  // [row][gate * 2 + unit]
  f32_fwd_product<4>(h_in + coff, p.whh[c], j0, b0, B, H, acc);

  // epilogue: gates, c and h updates, mask and writes, from the registers
  const float* __restrict__ gx = p.gx[c];
  const float* __restrict__ bhh = p.bhh[c];
  float* __restrict__ out = p.out[c];
  float* __restrict__ cseq = p.cseq[c];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + ty * 4 + r;
    if (b >= B) continue;
    const bool valid = lengths[b] > t;
    const size_t row = (size_t)t * B + b;
    const float* gxr = gx + row * 4 * H;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tx * 2 + u;
      if (j >= H) continue;
      const float ig = f32_sigmoid(gxr[j] + acc[r][u] + bhh[j]);
      const float fg = f32_sigmoid(gxr[H + j] + acc[r][2 + u] + bhh[H + j]);
      const float gg = tanhf(gxr[2 * H + j] + acc[r][4 + u] + bhh[2 * H + j]);
      const float og = f32_sigmoid(gxr[3 * H + j] + acc[r][6 + u] + bhh[3 * H + j]);
      const size_t hi = coff + (size_t)b * H + j;
      const float cp = cst[hi];
      const float cn = fg * cp + ig * gg;
      const float hn = og * tanhf(cn);
      h_out[hi] = valid ? hn : h_in[hi];
      cst[hi] = valid ? cn : cp;
      out[row * H + j] = valid ? hn : 0.0f;
      if (cseq) cseq[row * H + j] = valid ? cn : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Host entry, B5 / B6: one or two chains (a, b) over precomputed projections,
// sharing T, B, H and lengths, T launches on the caller's stream. h32 holds
// two buffers of (chains, B, H): buffer 0 holds h0 of each chain on entry,
// buffer T % 2 holds h_last on exit; c32 (chains, B, H) holds c0 on entry
// and c_last on exit. cseq_a / cseq_b are null for B5. Returns
// cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int lstm_f32_scan_launch(
    const void* gx_a, const void* gx_b, const void* lengths,
    const void* w_hh_a, const void* w_hh_b, const void* b_hh_a, const void* b_hh_b,
    void* h32,     // (2 buffers, chains, B, H) f32
    void* c32,     // (chains, B, H) f32
    void* out_a,   // (T, B, H) f32
    void* out_b,
    void* cseq_a,  // (T, B, H) f32, or null
    void* cseq_b,
    int T, int B, int H, int reverse_a, int reverse_b, int chains, void* stream) {
  if (chains < 1 || chains > 2 || T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  LstmF32Chains p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.whh[0] = static_cast<const float*>(w_hh_a);
  p.whh[1] = static_cast<const float*>(w_hh_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.out[0] = static_cast<float*>(out_a);
  p.out[1] = static_cast<float*>(out_b);
  p.cseq[0] = static_cast<float*>(cseq_a);
  p.cseq[1] = static_cast<float*>(cseq_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  const size_t hsz = (size_t)chains * B * H;
  float* h = static_cast<float*>(h32);
  dim3 grid;
  if (!f32_step_grid(B, H, chains, &grid)) return (int)cudaErrorInvalidValue;
  for (int step = 0; step < T; ++step) {
    const int src = step & 1;
    lstm_f32_step_kernel<<<grid, F_THREADS, 0, s>>>(
        p, static_cast<const int*>(lengths), h + src * hsz, h + (src ^ 1) * hsz,
        static_cast<float*>(c32), step, T, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Backward walk (B7): one step of one or two chains
// ---------------------------------------------------------------------------

struct LstmF32BwdChains {
  const float* gx[2];     // (T, B, 4H)
  const float* cprev[2];  // (T, B, H)
  const float* dout[2];   // (T, B, H)
  const float* whh[2];    // (H, 4H)
  const float* bhh[2];    // (4H,)
  float* dg4[2];          // (T, B, 4H): gh in, the gate gradients out
  int reverse[2];
};

// thread (ty, tx): rows b0 + 4 ty .. + 3, units j0 + 2 tx and j0 + 2 tx + 1
__global__ void __launch_bounds__(F_THREADS)
lstm_f32_bwd_step_kernel(LstmF32BwdChains p, const int* __restrict__ lengths,
                         float* __restrict__ dh,  // (chains, B, H), in place
                         float* __restrict__ dc,  // (chains, B, H), in place
                         int step, int T, int B, int H) {
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * F_J;
  const int b0 = blockIdx.y * F_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int G = 4 * H;
  const bool rev = p.reverse[c];
  const int t = step == T ? -1 : (rev ? T - 1 - step : step);
  float* __restrict__ dg4 = p.dg4[c];
  float acc[4][2];
  if (step > 0) {  // the carry of the step before, from its row of dg4
    const int tp = rev ? T - step : step - 1;
    f32_bwd_product(dg4 + (size_t)tp * B * G, p.whh[c], j0, b0, B, H, G, acc);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
  }

  // epilogue: finish the carry, then step t's gradients
  const size_t coff = (size_t)c * B * H;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + ty * 4 + r;
    if (b >= B) continue;
    const bool valid = t >= 0 && lengths[b] > t;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tx * 2 + u;
      if (j >= H) continue;
      const size_t hi = coff + (size_t)b * H + j;
      const float dhv = dh[hi] + acc[r][u];
      if (t < 0) {  // after the last step: the carry is dh0
        dh[hi] = dhv;
        continue;
      }
      const size_t row = (size_t)t * B + b;
      float* g = dg4 + row * G;
      const float* gxr = p.gx[c] + row * G;
      const float* bhh = p.bhh[c];
      const float ig = f32_sigmoid(gxr[j] + g[j] + bhh[j]);
      const float fg = f32_sigmoid(gxr[H + j] + g[H + j] + bhh[H + j]);
      const float gg = tanhf(gxr[2 * H + j] + g[2 * H + j] + bhh[2 * H + j]);
      const float og = f32_sigmoid(gxr[3 * H + j] + g[3 * H + j] + bhh[3 * H + j]);
      const float cp = p.cprev[c][row * H + j];
      const float tc = tanhf(fg * cp + ig * gg);
      const float dcv = dc[hi];

      const float dhnew = valid ? dhv + p.dout[c][row * H + j] : 0.0f;
      const float dcn = dhnew * og * (1.0f - tc * tc) + (valid ? dcv : 0.0f);
      g[j] = dcn * gg * ig * (1.0f - ig);
      g[H + j] = dcn * cp * fg * (1.0f - fg);
      g[2 * H + j] = dcn * ig * (1.0f - gg * gg);
      g[3 * H + j] = dhnew * tc * og * (1.0f - og);
      dh[hi] = valid ? 0.0f : dhv;
      dc[hi] = valid ? dcn * fg : dcv;
    }
  }
}

// ---------------------------------------------------------------------------
// Host entry, B7: the backward walks of one or two chains (a, b) that share
// T, B, H and lengths, on the caller's stream: the gate recompute
// gh = hprev @ w_hh of each chain into its dg4 buffer, then T + 1 steps.
// dh and dc (chains, B, H) f32 are zero on entry (the layer returns no final
// state) and hold dh0 and dc0 on exit. Returns cudaGetLastError() of the
// first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int lstm_f32_bwd_launch(
    const void* gx_a, const void* gx_b, const void* hprev_a, const void* hprev_b,
    const void* cprev_a, const void* cprev_b, const void* dout_a, const void* dout_b,
    const void* lengths, const void* w_hh_a, const void* w_hh_b,
    const void* b_hh_a, const void* b_hh_b,
    void* dh,     // (chains, B, H) f32
    void* dc,     // (chains, B, H) f32
    void* dg4_a,  // (T, B, 4H) f32
    void* dg4_b,
    int T, int B, int H, int reverse_a, int reverse_b, int chains, void* stream) {
  if (chains < 1 || chains > 2 || T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  LstmF32BwdChains p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.cprev[0] = static_cast<const float*>(cprev_a);
  p.cprev[1] = static_cast<const float*>(cprev_b);
  p.dout[0] = static_cast<const float*>(dout_a);
  p.dout[1] = static_cast<const float*>(dout_b);
  p.whh[0] = static_cast<const float*>(w_hh_a);
  p.whh[1] = static_cast<const float*>(w_hh_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.dg4[0] = static_cast<float*>(dg4_a);
  p.dg4[1] = static_cast<float*>(dg4_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  // gh = hprev @ w_hh for every step of each chain, into its dg4 buffer
  int rc = sgemm_launch(static_cast<const float*>(hprev_a),
                        static_cast<const float*>(hprev_b), p.whh[0], p.whh[1], p.dg4[0],
                        p.dg4[1], T * B, 4 * H, H, chains, s);
  if (rc != 0) return rc;

  dim3 grid;
  if (!f32_step_grid(B, H, chains, &grid)) return (int)cudaErrorInvalidValue;
  for (int step = 0; step <= T; ++step) {
    lstm_f32_bwd_step_kernel<<<grid, F_THREADS, 0, s>>>(
        p, static_cast<const int*>(lengths), static_cast<float*>(dh),
        static_cast<float*>(dc), step, T, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
