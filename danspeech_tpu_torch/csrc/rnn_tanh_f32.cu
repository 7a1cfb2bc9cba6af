// Float32 variants of the two tanh-RNN kernels, for Hopper: what the port
// runs for compute_dtype="float32" serving and mixed_precision=False
// training of rnn_type="rnn" models (ops/rnn_tanh_cuda.py dispatches on the
// operands' dtype).
//
// Replaces, in float32, danspeech_tpu/ops/pallas_gru.py:
//   rnn_tanh_scan (B8)     -> rnn_tanh_f32_scan_launch, one chain or two
//       (the chain is the grid's z index);
//   rnn_tanh_bwd_scan (B9) -> rnn_tanh_f32_bwd_launch, one chain or the two
//       chains of a bidirectional layer.
// The Pallas kernels are dtype-generic: float32 weights give float32
// products there. Same contract as the bf16 kernels (rnn_tanh_scan.cu,
// rnn_tanh_bwd.cu), every stream and weight in float32:
//   gx (T, B, H), the projection x @ w_ih + b_ih + b_hh (the kernels have no
//   bias); h' = tanh(gx + h @ w_hh) from h = 0, with h the float32 state
//   itself (the bf16 kernels round h to bf16 first; here nothing is
//   rounded); rows past their length freeze h and emit exact zeros; a
//   reverse chain walks t = T-1 .. 0 and holds its state until t < length.
//   The backward walk reads tanh' = 1 - out^2 off the float32 output
//   stream: per step, with m = length > t, dpre_t = m (dh + dout_t)
//   (1 - out_t^2) and dh <- dpre_t @ w_hh^T + (1 - m) dh, from dh = 0.
//
// What bounds it on an H100, and what this design does about it:
// - 2 T B H^2 operations a walk, 66 GFLOP for the forward at T=401, B=128,
//   H=800: 1.0 ms at the FP32 peak (67 TFLOP/s, SXM, 700 W) over every step.
//   What a step costs here is latency: each of the T dependent steps needs
//   all of the previous step's h (or dpre).
// - The step design of gru_f32.cu (f32_step.cuh): one launch per time step
//   from a host loop, the launch boundary as the barrier, a block of 256
//   threads owning 32 units for 64 batch rows, 4 rows x 2 units a thread in
//   registers, rereading its slice of w_hh from L2. At H = 800 that is 25
//   blocks of units a chain: the walk is bound by the launches, not by the
//   card's FP32 units.
// - Forward (rnn_tanh_f32_step_kernel): h ping-pongs between two buffers.
// - Backward (rnn_tanh_f32_bwd_step_kernel): T + 1 launches; each finishes
//   the previous step's carry dh = partial + dpre_prev @ w_hh^T[:, j] (the
//   previous step's row of the dpre output, which the launch before wrote
//   in full; w_hh's rows j read as they lie), applies step t's gradient and
//   leaves the partial carry (1 - m) dh in place (owned). The last launch
//   (t < 0) only finishes the carry: dh0.
// Measured by chip_smoke.py (phase 12): see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_step.cuh"

struct TanhF32Chains {
  const float* seq[2];  // forward: gx (T, B, H); backward: out (T, B, H)
  const float* dout[2]; // backward: (T, B, H); forward: unused
  const float* whh[2];  // (H, H)
  float* res[2];        // forward: out (T, B, H); backward: dpre (T, B, H)
  int reverse[2];
};

// ---------------------------------------------------------------------------
// Forward step (B8): one time step of one or two chains
// ---------------------------------------------------------------------------

// thread (ty = tid / 16, tx = tid % 16): rows b0 + 4 ty .. + 3, units
// j0 + 2 tx and j0 + 2 tx + 1
__global__ void __launch_bounds__(F_THREADS)
rnn_tanh_f32_step_kernel(TanhF32Chains p, const int* __restrict__ lengths,
                         const float* __restrict__ h_in,  // (chains, B, H)
                         float* __restrict__ h_out,       // (chains, B, H)
                         int step, int T, int B, int H) {
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * F_J;
  const int b0 = blockIdx.y * F_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int t = p.reverse[c] ? T - 1 - step : step;
  const size_t coff = (size_t)c * B * H;
  float acc[4][2];  // [row][unit]
  f32_fwd_product<1>(h_in + coff, p.whh[c], j0, b0, B, H, acc);

  const float* __restrict__ gx = p.seq[c];
  float* __restrict__ out = p.res[c];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + ty * 4 + r;
    if (b >= B) continue;
    const bool valid = lengths[b] > t;
    const size_t row = (size_t)t * B + b;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tx * 2 + u;
      if (j >= H) continue;
      const size_t hi = coff + (size_t)b * H + j;
      const float hn = tanhf(gx[row * H + j] + acc[r][u]);
      h_out[hi] = valid ? hn : h_in[hi];
      out[row * H + j] = valid ? hn : 0.0f;
    }
  }
}

static int tanh_chains(TanhF32Chains* p, const void* seq_a, const void* seq_b,
                       const void* dout_a, const void* dout_b, const void* w_hh_a,
                       const void* w_hh_b, void* res_a, void* res_b, int reverse_a,
                       int reverse_b, int T, int B, int H, int chains) {
  if (chains < 1 || chains > 2 || T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  p->seq[0] = static_cast<const float*>(seq_a);
  p->seq[1] = static_cast<const float*>(seq_b);
  p->dout[0] = static_cast<const float*>(dout_a);
  p->dout[1] = static_cast<const float*>(dout_b);
  p->whh[0] = static_cast<const float*>(w_hh_a);
  p->whh[1] = static_cast<const float*>(w_hh_b);
  p->res[0] = static_cast<float*>(res_a);
  p->res[1] = static_cast<float*>(res_b);
  p->reverse[0] = reverse_a;
  p->reverse[1] = reverse_b;
  return 0;
}

// ---------------------------------------------------------------------------
// Host entry, B8: one or two chains (a, b) over precomputed projections,
// sharing T, B, H and lengths, T launches on the caller's stream. h32 holds
// two buffers of (chains, B, H): buffer 0 zeroed on entry (h0 = 0), buffer
// T % 2 holds h_last on exit. Returns cudaGetLastError() of the first launch
// that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int rnn_tanh_f32_scan_launch(
    const void* gx_a, const void* gx_b, const void* lengths,
    const void* w_hh_a, const void* w_hh_b,
    void* h32,    // (2 buffers, chains, B, H) f32
    void* out_a,  // (T, B, H) f32
    void* out_b,
    int T, int B, int H, int reverse_a, int reverse_b, int chains, void* stream) {
  TanhF32Chains p;
  int rc = tanh_chains(&p, gx_a, gx_b, nullptr, nullptr, w_hh_a, w_hh_b, out_a, out_b,
                       reverse_a, reverse_b, T, B, H, chains);
  if (rc != 0) return rc;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t hsz = (size_t)chains * B * H;
  float* h = static_cast<float*>(h32);
  dim3 grid;
  if (!f32_step_grid(B, H, chains, &grid)) return (int)cudaErrorInvalidValue;
  for (int step = 0; step < T; ++step) {
    const int src = step & 1;
    rnn_tanh_f32_step_kernel<<<grid, F_THREADS, 0, s>>>(
        p, static_cast<const int*>(lengths), h + src * hsz, h + (src ^ 1) * hsz, step, T,
        B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Backward walk (B9): one step of one or two chains
// ---------------------------------------------------------------------------

// thread (ty, tx): rows b0 + 4 ty .. + 3, units j0 + 2 tx and j0 + 2 tx + 1
__global__ void __launch_bounds__(F_THREADS)
rnn_tanh_f32_bwd_step_kernel(TanhF32Chains p, const int* __restrict__ lengths,
                             float* __restrict__ dh,  // (chains, B, H), in place
                             int step, int T, int B, int H) {
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * F_J;
  const int b0 = blockIdx.y * F_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const bool rev = p.reverse[c];
  const int t = step == T ? -1 : (rev ? T - 1 - step : step);
  float* __restrict__ dpre = p.res[c];
  float acc[4][2];
  if (step > 0) {  // the carry of the step before, from its row of dpre
    const int tp = rev ? T - step : step - 1;
    f32_bwd_product(dpre + (size_t)tp * B * H, p.whh[c], j0, b0, B, H, H, acc);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.0f;
  }

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
      const size_t at = ((size_t)t * B + b) * H + j;
      const float o = p.seq[c][at];
      dpre[at] = valid ? (dhv + p.dout[c][at]) * (1.0f - o * o) : 0.0f;
      dh[hi] = valid ? 0.0f : dhv;
    }
  }
}

// ---------------------------------------------------------------------------
// Host entry, B9: the backward walks of one or two chains (a, b) that share
// T, B, H and lengths, T + 1 launches on the caller's stream. dh (chains, B,
// H) f32 is zero on entry (the layer returns no final state) and holds dh0 on
// exit. Returns cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int rnn_tanh_f32_bwd_launch(
    const void* out_a, const void* out_b, const void* dout_a, const void* dout_b,
    const void* lengths, const void* w_hh_a, const void* w_hh_b,
    void* dh,      // (chains, B, H) f32
    void* dpre_a,  // (T, B, H) f32
    void* dpre_b,
    int T, int B, int H, int reverse_a, int reverse_b, int chains, void* stream) {
  TanhF32Chains p;
  int rc = tanh_chains(&p, out_a, out_b, dout_a, dout_b, w_hh_a, w_hh_b, dpre_a, dpre_b,
                       reverse_a, reverse_b, T, B, H, chains);
  if (rc != 0) return rc;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid;
  if (!f32_step_grid(B, H, chains, &grid)) return (int)cudaErrorInvalidValue;
  for (int step = 0; step <= T; ++step) {
    rnn_tanh_f32_bwd_step_kernel<<<grid, F_THREADS, 0, s>>>(
        p, static_cast<const int*>(lengths), static_cast<float*>(dh), step, T, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
