// Float32 variants of the four GRU kernels, for Hopper: what the port runs
// for compute_dtype="float32" serving and mixed_precision=False training
// (ops/gru_cuda.py dispatches on the operands' dtype).
//
// Replaces, in float32, danspeech_tpu/ops/pallas_gru.py:
//   gru_scan (B1) and gru_scan_bidi (B2)  -> gru_f32_scan_launch, one chain
//       or two (the chain is the grid's z index);
//   gru_scan_bidi_fused (B3)              -> gru_f32_bidi_fused_launch;
//   gru_bwd_scan (B4)                     -> gru_f32_bwd_launch, one chain
//       or the two chains of a bidirectional layer.
// The Pallas kernels are dtype-generic: their products take "the two matmuls
// in the weights' dtype" (pallas_gru.py:21-23), and float32 weights give
// float32 products there. Same contract as the bf16 kernels of this
// directory, every stream and weight in float32:
//   gx (T, B, 3H) the bias-free projection x @ w_ih, b_ih added when gx is
//   read; gh = h @ w_hh with h the float32 state itself (the bf16 kernels
//   round h to bf16 first; here nothing is rounded), b_hh_n inside r * gh_n;
//   rows past their length freeze the state and emit exact zeros; a reverse
//   chain walks t = T-1 .. 0 and holds its state at h0 until t < length, with
//   no reversed copy of gx. The backward walk follows gru_bwd.cu's equations
//   with float32 dgh.
//
// What bounds it on an H100, and what this design does about it:
// - Float32 products run on the CUDA cores: the tensor cores have no f32 x
//   f32 shape, and TF32 is not float32. The bound is 67 TFLOP/s (FP32, SXM,
//   700 W): 35.5 ms for the flagship's first layer (T=401, B=128, D=2016,
//   H=1200: projection 1.49 TFLOP, recurrence 0.89 TFLOP).
// - The resident (persistent) design of the bf16 kernels does not fit:
//   float32 w_hh is 17.3 MB a chain at H = 1200 and 48 MB at H = 2000,
//   against about 30 MB of shared memory on the whole card (132 SMs x 227
//   KB), so neither both chains of a flagship layer nor one chain of
//   GPUStreamingRNN can stay in shared memory. This is the step design: one
//   launch per time step from a host loop, the launch boundary as the
//   barrier between steps, each block rereading its slice of w_hh from L2
//   (both flagship chains, 34.6 MB, fit the 50 MB L2).
// - A step block owns F_J = 32 hidden units (the columns j, H+j, 2H+j of
//   w_hh) for F_BR = 64 batch rows. Its 256 threads each hold 4 rows x 2
//   units x 3 gates in registers (f32_fwd_product<3>, f32_step.cuh), so the
//   gates, the mask, the out write and the h update happen in the registers
//   that hold the sums; h ping-pongs between two f32 buffers (other blocks
//   read the previous step's).
// - The projection of the fused layer and the backward walk's gate
//   recompute do not depend on the walk: one tiled FFMA GEMM each, before it
//   (sgemm.cuh), into the f32 gx buffer and into the dgx output buffer (each
//   (t, b, j) of gh is read back and overwritten with the gate gradient by
//   the one thread that owns it).
// - The backward walk's step product is dgh_prev (B, 3H) @ w_hh^T
//   (f32_bwd_product): a block owns 32 units (32 rows of w_hh, read as they
//   lie) for 64 batch rows, 4 rows x 2 units a thread; it finishes the previous step's carry
//   dh = partial + dgh_prev @ w_hh^T[:, j], applies step t's gradient and
//   leaves dgh_t (f32, ping-pong) and the partial carry. One more step
//   (t < 0) only finishes the carry: that is dh0.
// Measured by chip_smoke.py (phase 12): see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_step.cuh"
#include "sgemm.cuh"

// ---------------------------------------------------------------------------
// Forward step: one time step of one or two chains
// ---------------------------------------------------------------------------

struct F32Chains {
  const float* gx[2];   // (T, B, 3H)
  const float* whh[2];  // (H, 3H)
  const float* bih[2];  // (3H,)
  const float* bhh[2];  // (3H,)
  float* out[2];        // (T, B, H)
  int reverse[2];
};

// thread (ty = tid / 16, tx = tid % 16): rows b0 + 4 ty .. + 3, units
// j0 + 2 tx and j0 + 2 tx + 1, the three gates of each
__global__ void __launch_bounds__(F_THREADS)
gru_f32_step_kernel(F32Chains p, const int* __restrict__ lengths,
                    const float* __restrict__ h_in,  // (chains, B, H)
                    float* __restrict__ h_out,       // (chains, B, H)
                    int step, int T, int B, int H) {
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * F_J;
  const int b0 = blockIdx.y * F_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int G = 3 * H;
  const int t = p.reverse[c] ? T - 1 - step : step;
  const size_t coff = (size_t)c * B * H;
  float acc[4][6];  // [row][gate * 2 + unit]
  f32_fwd_product<3>(h_in + coff, p.whh[c], j0, b0, B, H, acc);

  // epilogue: gates, mask, out write and h update, from the registers
  const float* __restrict__ gx = p.gx[c];
  const float* __restrict__ bih = p.bih[c];
  const float* __restrict__ bhh = p.bhh[c];
  float* __restrict__ out = p.out[c];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + ty * 4 + r;
    if (b >= B) continue;
    const bool valid = lengths[b] > t;
    const float* gxr = gx + ((size_t)t * B + b) * G;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + tx * 2 + u;
      if (j >= H) continue;
      const float ghr = acc[r][u] + bhh[j];
      const float ghz = acc[r][2 + u] + bhh[H + j];
      const float ghn = acc[r][4 + u] + bhh[2 * H + j];
      const float rg = f32_sigmoid((gxr[j] + bih[j]) + ghr);
      const float zg = f32_sigmoid((gxr[H + j] + bih[H + j]) + ghz);
      const float ng = tanhf((gxr[2 * H + j] + bih[2 * H + j]) + rg * ghn);
      const size_t hi = coff + (size_t)b * H + j;
      const float hp = h_in[hi];
      const float hn = (1.0f - zg) * ng + zg * hp;
      h_out[hi] = valid ? hn : hp;
      out[((size_t)t * B + b) * H + j] = valid ? hn : 0.0f;
    }
  }
}

static int f32_walk(const F32Chains& p, const int* lengths, float* h32, int T, int B,
                    int H, int chains, cudaStream_t s) {
  const size_t hsz = (size_t)chains * B * H;
  dim3 grid;
  if (!f32_step_grid(B, H, chains, &grid)) return (int)cudaErrorInvalidValue;
  for (int step = 0; step < T; ++step) {
    const int src = step & 1;
    gru_f32_step_kernel<<<grid, F_THREADS, 0, s>>>(
        p, lengths, h32 + src * hsz, h32 + (src ^ 1) * hsz, step, T, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Host entry, B1 / B2: one or two chains (a, b) over precomputed bias-free
// projections, sharing T, B, H and lengths, T launches on the caller's
// stream. h32 holds two buffers of (chains, B, H): buffer 0 holds h0 of each
// chain on entry, buffer T % 2 holds h_last on exit. Returns
// cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_f32_scan_launch(
    const void* gx_a, const void* gx_b, const void* lengths,
    const void* w_hh_a, const void* w_hh_b, const void* b_ih_a, const void* b_ih_b,
    const void* b_hh_a, const void* b_hh_b,
    void* h32,    // (2 buffers, chains, B, H) f32
    void* out_a,  // (T, B, H) f32
    void* out_b,
    int T, int B, int H, int reverse_a, int reverse_b, int chains, void* stream) {
  if (chains < 1 || chains > 2 || T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  F32Chains p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.whh[0] = static_cast<const float*>(w_hh_a);
  p.whh[1] = static_cast<const float*>(w_hh_b);
  p.bih[0] = static_cast<const float*>(b_ih_a);
  p.bih[1] = static_cast<const float*>(b_ih_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.out[0] = static_cast<float*>(out_a);
  p.out[1] = static_cast<float*>(out_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  return f32_walk(p, static_cast<const int*>(lengths), static_cast<float*>(h32), T, B,
                  H, chains, reinterpret_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Host entry, B3: the projection x @ w_ih of both directions into the f32 gx
// buffer (2, T, B, 3H), then both chains (the backward one in reverse time),
// h0 = 0. h32 holds two zeroed buffers of (2, B, H); buffer T % 2 holds
// h_last on exit; out is (2, T, B, H).
// ---------------------------------------------------------------------------

extern "C" int gru_f32_bidi_fused_launch(
    const void* x, const void* lengths, const void* w_ih_f, const void* w_ih_b,
    const void* w_hh_f, const void* w_hh_b, const void* b_ih_f, const void* b_ih_b,
    const void* b_hh_f, const void* b_hh_b,
    void* gx,    // (2, T, B, 3H) f32 scratch
    void* h32,   // (2 buffers, 2, B, H) f32, zeroed
    void* out,   // (2, T, B, H) f32
    int T, int B, int D, int H, void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t gsz = (size_t)T * B * 3 * H;
  float* g = static_cast<float*>(gx);
  const float* xa = static_cast<const float*>(x);
  int rc = sgemm_launch(xa, xa, static_cast<const float*>(w_ih_f),
                        static_cast<const float*>(w_ih_b), g, g + gsz, T * B, 3 * H, D,
                        2, s);
  if (rc != 0) return rc;
  F32Chains p;
  p.gx[0] = g;
  p.gx[1] = g + gsz;
  p.whh[0] = static_cast<const float*>(w_hh_f);
  p.whh[1] = static_cast<const float*>(w_hh_b);
  p.bih[0] = static_cast<const float*>(b_ih_f);
  p.bih[1] = static_cast<const float*>(b_ih_b);
  p.bhh[0] = static_cast<const float*>(b_hh_f);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.out[0] = static_cast<float*>(out);
  p.out[1] = static_cast<float*>(out) + (size_t)T * B * H;
  p.reverse[0] = 0;
  p.reverse[1] = 1;
  return f32_walk(p, static_cast<const int*>(lengths), static_cast<float*>(h32), T, B,
                  H, 2, s);
}

// ---------------------------------------------------------------------------
// Backward walk (B4): one step of one or two chains
// ---------------------------------------------------------------------------

struct F32BwdChains {
  const float* gx[2];     // (T, B, 3H)
  const float* hprev[2];  // (T, B, H)
  const float* dout[2];   // (T, B, H)
  const float* whh[2];    // (H, 3H)
  const float* bih[2];    // (3H,)
  const float* bhh[2];    // (3H,)
  float* dgx[2];          // (T, B, 3H): gh in, dgx out
  float* dghn[2];         // (T, B, H)
  int reverse[2];
};

// thread (ty, tx): rows b0 + 4 ty .. + 3, units j0 + 2 tx and j0 + 2 tx + 1
__global__ void __launch_bounds__(F_THREADS)
gru_f32_bwd_step_kernel(F32BwdChains p, const int* __restrict__ lengths,
                        const float* __restrict__ part_in,  // (chains, B, H)
                        const float* __restrict__ dgh_in,   // (chains, B, 3H)
                        float* __restrict__ part_out,
                        float* __restrict__ dgh_out,
                        int step, int T, int B, int H) {
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * F_J;
  const int b0 = blockIdx.y * F_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int G = 3 * H;
  const int t = step == T ? -1 : (p.reverse[c] ? T - 1 - step : step);
  float acc[4][2];
  f32_bwd_product(dgh_in + (size_t)c * B * G, p.whh[c], j0, b0, B, H, G, acc);

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
      const float dh = part_in[hi] + acc[r][u];
      if (t < 0) {  // after the last step: the carry is dh0
        part_out[hi] = dh;
        continue;
      }
      const size_t row = (size_t)t * B + b;
      float* g = p.dgx[c] + row * G;
      const float* gxr = p.gx[c] + row * G;
      const float* bih = p.bih[c];
      const float* bhh = p.bhh[c];
      const float hp = p.hprev[c][row * H + j];
      const float ghr = g[j] + bhh[j];
      const float ghz = g[H + j] + bhh[H + j];
      const float ghn = g[2 * H + j] + bhh[2 * H + j];
      const float rg = f32_sigmoid((gxr[j] + bih[j]) + ghr);
      const float zg = f32_sigmoid((gxr[H + j] + bih[H + j]) + ghz);
      const float ng = tanhf((gxr[2 * H + j] + bih[2 * H + j]) + rg * ghn);

      const float dhnew = valid ? dh + p.dout[c][row * H + j] : 0.0f;
      const float dn = dhnew * (1.0f - zg);
      const float dz = dhnew * (hp - ng);
      const float dpre_n = dn * (1.0f - ng * ng);
      const float dpre_r = dpre_n * ghn * rg * (1.0f - rg);
      const float dpre_z = dz * zg * (1.0f - zg);
      const float dghn_v = dpre_n * rg;

      g[j] = dpre_r;
      g[H + j] = dpre_z;
      g[2 * H + j] = dpre_n;
      p.dghn[c][row * H + j] = dghn_v;
      float* dg = dgh_out + ((size_t)c * B + b) * G;
      dg[j] = dpre_r;
      dg[H + j] = dpre_z;
      dg[2 * H + j] = dghn_v;
      part_out[hi] = dhnew * zg + (valid ? 0.0f : dh);
    }
  }
}

// ---------------------------------------------------------------------------
// Host entry, B4: the backward walks of one or two chains (a, b) that share
// T, B, H and lengths, on the caller's stream: the gate recompute
// gh = hprev @ w_hh of each chain into its dgx buffer, then T + 1 steps.
// part holds two buffers of (chains, B, H) f32 and dgh two of (chains, B, 3H)
// f32; on entry buffer 0 of part holds each chain's dh_last and buffer 0 of
// dgh zeros; on exit buffer (T + 1) % 2 of part holds dh0. Returns
// cudaGetLastError() of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_f32_bwd_launch(
    const void* gx_a, const void* gx_b, const void* hprev_a, const void* hprev_b,
    const void* dout_a, const void* dout_b, const void* lengths,
    const void* w_hh_a, const void* w_hh_b, const void* b_ih_a, const void* b_ih_b,
    const void* b_hh_a, const void* b_hh_b,
    void* part,   // (2 buffers, chains, B, H) f32
    void* dgh,    // (2 buffers, chains, B, 3H) f32
    void* dgx_a, void* dgx_b,     // (T, B, 3H) f32
    void* dghn_a, void* dghn_b,   // (T, B, H) f32
    int T, int B, int H, int reverse_a, int reverse_b, int chains, void* stream) {
  if (chains < 1 || chains > 2 || T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  F32BwdChains p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.hprev[0] = static_cast<const float*>(hprev_a);
  p.hprev[1] = static_cast<const float*>(hprev_b);
  p.dout[0] = static_cast<const float*>(dout_a);
  p.dout[1] = static_cast<const float*>(dout_b);
  p.whh[0] = static_cast<const float*>(w_hh_a);
  p.whh[1] = static_cast<const float*>(w_hh_b);
  p.bih[0] = static_cast<const float*>(b_ih_a);
  p.bih[1] = static_cast<const float*>(b_ih_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.dgx[0] = static_cast<float*>(dgx_a);
  p.dgx[1] = static_cast<float*>(dgx_b);
  p.dghn[0] = static_cast<float*>(dghn_a);
  p.dghn[1] = static_cast<float*>(dghn_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  // gh = hprev @ w_hh for every step of each chain, into its dgx buffer
  int rc = sgemm_launch(p.hprev[0], p.hprev[1], p.whh[0], p.whh[1], p.dgx[0], p.dgx[1],
                        T * B, 3 * H, H, chains, s);
  if (rc != 0) return rc;

  const size_t psz = (size_t)chains * B * H;
  const size_t gsz = (size_t)chains * B * 3 * H;
  float* pf = static_cast<float*>(part);
  float* dg = static_cast<float*>(dgh);
  dim3 grid;
  if (!f32_step_grid(B, H, chains, &grid)) return (int)cudaErrorInvalidValue;
  for (int step = 0; step <= T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    gru_f32_bwd_step_kernel<<<grid, F_THREADS, 0, s>>>(
        p, static_cast<const int*>(lengths), pf + src * psz, dg + src * gsz,
        pf + dst * psz, dg + dst * gsz, step, T, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
