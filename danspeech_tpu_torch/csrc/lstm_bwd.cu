// LSTM backward walk (training) for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:lstm_bwd_scan (kernel body
// _lstm_bwd_kernel). Same contract, gate order i, f, g, o, all streams in
// natural time order:
//   gx (T, B, 4H) bf16, the bias-free projection x @ w_ih; hprev, cprev
//   (T, B, H) bf16, the states before each step in chain order; dout
//   (T, B, H) f32; lengths (B,) int32; w_hh (H, 4H) and its transpose
//   (4H, H) bf16; b_hh (4H,) f32, the per-step bias, which ops/rnn.py
//   hands as b_ih + b_hh.
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
//   walk, as one tiled tensor-core GEMM (gru_proj.cuh: on wgmma fed by the
//   copy engine when w_hh^T is given and hprev's rows start on 16 bytes,
//   else cp.async + mma.m16n8k16). It writes gh into the dg4 output buffer:
//   each (t, b, j) is read back and overwritten with the gate gradient by the
//   one thread that owns it, so the walk needs no (T, B, 4H) scratch of its
//   own.
// - The walk is T dependent steps, each a (B, 4H) x (4H, H) product against
//   w_hh^T that needs all 4H columns of the previous step's dg4: 0.16 GFLOP
//   and 205 KB of bf16 dg a step at B = 32, H = 800. What a step costs is
//   latency (a barrier, an L2 round trip, one pass over the weights), not
//   bytes or operations. A block owns U hidden units j. It first finishes
//   the previous step's carry for its units, dh = partial + bf16(dg_prev) @
//   w_hh^T[:, j], then applies step t's elementwise gradient at its units and
//   leaves dg_t in bf16 (ping-pong between two buffers) and the partial carry
//   (1 - m) dh (f32). dc is elementwise and owned: it is updated in place.
//   One more step (t < 0) only finishes the carry: that is dh0. Two designs,
//   chosen on the host by ops/persist_plan.py (plan_lstm_backward) from the
//   shape and the device's SM count and shared memory:
//   * persistent (lstm_bwd_persist_kernel, persist.cuh): ONE cooperative
//     launch walks all T + 1 steps of one chain, or of both chains of a
//     bidirectional layer (the chain as the slow grid index, each chain with
//     its own barrier). A block keeps its U columns of w_hh^T, 4H deep, in
//     shared memory for the whole walk (they are rows j of w_hh itself, so
//     no transposed copy is made for them): U = 8 for one chain at H = 800
//     (100 blocks, 51 KB slices, five ring stages), U = 16 for two (50
//     blocks a chain, 102 KB, three stages). Per step: the barrier; dg of the
//     previous step streams from L2 through a TMA ring beside the slice, fed
//     by a ninth warp, while the two warpgroups multiply with wgmma (at
//     B = 32 one warpgroup's 64 rows hold the batch, so the two split the 4H
//     depth and their partial sums are added in a fixed order in shared
//     memory). The streams of the next step (gx, gh, cprev, dout at the
//     block's units) do not depend on the carry: they are prefetched into L2
//     during the product.
//   * step (lstm_bwd_step_kernel): one launch per time step from the host
//     loop, the launch boundary as the barrier; a block owns 16 units for 64
//     rows and rereads its 4H-deep slice of w_hh^T from L2 (rnn_step.cuh,
//     an unpipelined load-then-multiply loop). Kept for widths whose slices
//     do not fit an SM's shared memory.
//   Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, T=401,
//   B=32, H=800: persistent 6.05 ms a chain (the walk 5.82 ms = 14.5 us a
//   step over 402, the recompute on wgmma 0.15 ms), 3.31 ms a chain when
//   both chains share a launch; step design 29.8-31.4 ms; cuDNN's whole LSTM
//   backward 7.3-21.2 ms (bf16 and float16); bound 0.07 ms. What is left of
//   a step is its latency: the barrier, 13 dependent 256-deep chunks of dg
//   from L2, the epilogue.

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

// gh = hprev @ w_hh for every step of one chain, into its dg4 buffer: on
// wgmma fed by the copy engine where w_hht (4H, H) is given and both operands'
// rows can be read by it, else on mma.sync. Returns the CUDA error code.
static int lstm_recompute(const bf16* hprev, const bf16* w_hh, const bf16* w_hht,
                          float* dg4, int T, int B, int H, cudaStream_t s) {
  if (w_hht != nullptr && ps_tma_ok(hprev, H) && ps_tma_ok(w_hht, H))
    return gru_proj_wgmma_launch(hprev, w_hht, dg4, T * B, 4 * H, H, 1, s);
  return gru_proj_launch(hprev, w_hh, w_hh, dg4, T * B, 4 * H, H, 1, s);
}

// ---------------------------------------------------------------------------
// Host entry, step design: one chain's backward walk, on the caller's stream.
// part holds two buffers of (B, H) f32 and dg two of (B, 4H) bf16; on entry
// buffer 0 of each and dc hold zeros; on exit buffer (T + 1) % 2 of part
// holds dh0 and dc holds dc0. Returns cudaGetLastError() of the first launch
// that failed, else 0.
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
  const int rc = lstm_recompute(static_cast<const bf16*>(hprev),
                                static_cast<const bf16*>(w_hh),
                                static_cast<const bf16*>(w_hht),
                                static_cast<float*>(dg4), T, B, H, s);
  if (rc != 0) return rc;
  cudaError_t err;

  const size_t psz = (size_t)B * H;
  const size_t gsz = (size_t)B * 4 * H;
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

// ---------------------------------------------------------------------------
// Persistent design: all T + 1 steps of one or two chains in one cooperative
// launch
// ---------------------------------------------------------------------------

struct LstmBwdPersistArgs {
  const bf16* gx[2];      // (T, B, 4H), bias-free
  const bf16* cprev[2];   // (T, B, H)
  const float* dout[2];   // (T, B, H)
  const int* lengths;     // (B,)
  const bf16* whh[2];     // (H, 4H): row j is column j of w_hh^T, 4H deep
  const float* bhh[2];    // (4H,): b_ih + b_hh, added at every step
  float* part[2];         // (B, H) f32: zeros on entry, dh0 on exit
  float* dc[2];           // (B, H) f32: zeros on entry, dc0 on exit
  bf16* dg;               // (2 buffers, chains, B, 4H) bf16 (step 0 reads none)
  float* dg4[2];          // (T, B, 4H): gh in, dg4 out
  unsigned int* barrier;  // (chains,) zeros on entry
  int reverse[2];
  int chains;
  int T, B, H;
  int U;       // hidden units per block (a multiple of 8)
  int MG;      // warpgroups along the rows of a row block (64 rows each): 1 or 2
  int stages;  // ring stages: 2 .. PS_MAX_STAGES
  int kc;      // depth one warpgroup covers of a ring chunk: 128, 64 or 32
  int bpd;     // blocks per chain
  int Kr;      // 4H rounded up to 64
  int ws_off;  // bytes from the start of shared memory (the ring) to the slice
  int tma;     // dg can be read by the copy engine (else element by element)
};

template <int NT>  // U / 8: 8-column MMA tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
lstm_bwd_persist_kernel(const LstmBwdPersistArgs p,
                        const __grid_constant__ CUtensorMap dg_map) {
  extern __shared__ __align__(1024) unsigned char ps_smem_raw[];
  __shared__ __align__(8) uint64_t ps_mbar[2 * PS_MAX_STAGES];
  PsPhases phases;
  const int tid = threadIdx.x;
  const int ch = blockIdx.x / p.bpd;
  const int j0 = (blockIdx.x - ch * p.bpd) * p.U;
  const int T = p.T, B = p.B, H = p.H, U = p.U;
  const int G = 4 * H;
  bf16* ring = reinterpret_cast<bf16*>(ps_smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(ps_smem_raw + p.ws_off);
  float* Cs = reinterpret_cast<float*>(ring);
  const int BR = p.MG * 64;
  const int KS = 2 / p.MG;  // planes of partial sums: one a depth split
  const int ldc = NT * 8 + 1;
  const int nrb = (B + BR - 1) / BR;

  // the epilogue's input streams do not alias its outputs (gh / dg4 share a
  // buffer and stay unqualified): their loads may be issued together
  const bf16* __restrict__ gx = p.gx[ch];
  const bf16* __restrict__ cprev = p.cprev[ch];
  const float* __restrict__ dout = p.dout[ch];
  const int* __restrict__ lengths = p.lengths;
  const float* __restrict__ bhh = p.bhh[ch];
  float* part = p.part[ch];
  float* dc = p.dc[ch];
  float* dg4 = p.dg4[ch];
  const bool reverse = p.reverse[ch] != 0;
  const size_t gsz = (size_t)p.chains * B * G;
  unsigned int* counter = p.barrier + ch;
  const int uw = min(U, H - j0);  // real units of this block

  ps_load_slice(Ws, p.whh[ch], H, G, p.Kr, 1, U, j0);
  ps_ring_init(ring, ps_mbar, p.stages);

  PS_T0();
  for (int step = 0; step <= T; ++step) {
    const int t = step == T ? -1 : (reverse ? T - 1 - step : step);
    const bf16* dg_in = p.dg + (step & 1) * gsz + (size_t)ch * B * G;
    bf16* __restrict__ dg_out = p.dg + ((step & 1) ^ 1) * gsz + (size_t)ch * B * G;
    PS_ACC(0);
    if (step > 0) ps_grid_barrier(counter, (unsigned int)step * p.bpd);
    PS_ACC(1);
    if (step + 1 < T) {
      // the next step's streams do not depend on the carry: bring them into
      // L2 meanwhile (4 gate segments of gx and of gh, which this step leaves
      // intact, cprev and dout per row)
      const int tn = reverse ? t - 1 : t + 1;
      for (int i = tid; i < B * 10; i += PS_BLOCK) {
        const int b = i / 10, k = i - b * 10;
        const size_t row = (size_t)tn * B + b;
        const char* q;
        int bytes;
        if (k < 4) {
          q = reinterpret_cast<const char*>(gx + row * G + (size_t)k * H + j0);
          bytes = uw * 2;
        } else if (k < 8) {
          q = reinterpret_cast<const char*>(dg4 + row * G + (size_t)(k - 4) * H + j0);
          bytes = uw * 4;
        } else if (k == 8) {
          q = reinterpret_cast<const char*>(cprev + row * H + j0);
          bytes = uw * 2;
        } else {
          q = reinterpret_cast<const char*>(dout + row * H + j0);
          bytes = uw * 4;
        }
        ps_prefetch_l2(q);
        ps_prefetch_l2(q + bytes - 1);
      }
    }
    PS_ACC(2);
    for (int rb = 0; rb < nrb; ++rb) {
      const int row0 = rb * BR;
      // before the first step dg is zero: the carry is the zero start itself
      PS_ACC(0);
      if (step > 0)
        ps_block_product<NT>(dg_in, &dg_map, p.tma, (step & 1) * p.chains + ch, row0, B,
                             G, p.Kr, Ws, ring, Cs, p.MG, p.stages, p.kc, ps_mbar,
                             phases);
      PS_ACC(9);
      // a thread's elements, EP at a time: first every load they need, then
      // the arithmetic, so the loads' latencies overlap
      constexpr int UC = NT * 8;  // == U
      constexpr int EP = 4;
      for (int base = tid; base < BR * UC; base += EP * PS_BLOCK) {
        float dh[EP], pi[EP], pf[EP], pg[EP], po[EP], cp[EP], dy[EP], dcv[EP];
        int len[EP];
        unsigned live = 0u;
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          const int idx = base + e * PS_BLOCK;
          const int r = idx / UC, u = idx - r * UC;
          const int b = row0 + r, j = j0 + u;
          if (idx < BR * UC && b < B && j < H) {
            live |= 1u << e;
            const size_t hi = (size_t)b * H + j;
            dh[e] = part[hi];
            if (t >= 0) {
              const size_t row = (size_t)t * B + b;
              const float* g = dg4 + row * G;
              const bf16* x = gx + row * G;
              pi[e] = g[j] + __bfloat162float(x[j]);
              pf[e] = g[H + j] + __bfloat162float(x[H + j]);
              pg[e] = g[2 * H + j] + __bfloat162float(x[2 * H + j]);
              po[e] = g[3 * H + j] + __bfloat162float(x[3 * H + j]);
              cp[e] = __bfloat162float(cprev[row * H + j]);
              dy[e] = dout[row * H + j];
              dcv[e] = dc[hi];
              len[e] = lengths[b];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          if (!(live >> e & 1u)) continue;
          const int idx = base + e * PS_BLOCK;
          const int r = idx / UC, u = idx - r * UC;
          const int b = row0 + r, j = j0 + u;
          const size_t hi = (size_t)b * H + j;
          float dhv = dh[e];
          if (step > 0) dhv += ps_sum_splits(Cs, KS, BR, ldc, r, u);
          if (t < 0) {  // after the last step: the carry is dh0
            part[hi] = dhv;
            continue;
          }
          const float ig = ps_sigmoid(pi[e] + bhh[j]);
          const float fg = ps_sigmoid(pf[e] + bhh[H + j]);
          const float gg = ps_tanh(pg[e] + bhh[2 * H + j]);
          const float og = ps_sigmoid(po[e] + bhh[3 * H + j]);
          const float th = ps_tanh(fg * cp[e] + ig * gg);

          const bool valid = len[e] > t;
          const float dhnew = valid ? dhv + dy[e] : 0.0f;
          const float d_o = dhnew * th;
          const float dcn = dhnew * og * (1.0f - th * th) + (valid ? dcv[e] : 0.0f);
          const float dpre_i = dcn * gg * ig * (1.0f - ig);
          const float dpre_f = dcn * cp[e] * fg * (1.0f - fg);
          const float dpre_g = dcn * ig * (1.0f - gg * gg);
          const float dpre_o = d_o * og * (1.0f - og);

          float* g = dg4 + ((size_t)t * B + b) * G;
          g[j] = dpre_i;
          g[H + j] = dpre_f;
          g[2 * H + j] = dpre_g;
          g[3 * H + j] = dpre_o;
          bf16* d = dg_out + (size_t)b * G;
          d[j] = __float2bfloat16(dpre_i);
          d[H + j] = __float2bfloat16(dpre_f);
          d[2 * H + j] = __float2bfloat16(dpre_g);
          d[3 * H + j] = __float2bfloat16(dpre_o);
          part[hi] = valid ? 0.0f : dhv;
          if (valid) dc[hi] = dcn * fg;
        }
      }
      __syncthreads();  // Cs lies over the ring of the next product
      PS_ACC(3);
    }
  }
}

// Host entry, persistent design, for `chains` = 1 or 2 chains that share T,
// B, H and lengths (the two directions of a bidirectional layer): every
// per-chain pointer has a second one, ignored when chains = 1. Before the
// walk the gate recompute gh = hprev @ w_hh runs per chain into dg4
// (lstm_recompute; w_hht_c is the transposed w_hh (4H, H) or null). part_c and
// dc_c hold zeros on entry and dh0 and dc0 on exit. The plan (U, MG, stages,
// kc, bpd, smem bytes) comes from ops/persist_plan.py; the launch is refused
// with an error code if the device cannot hold the grid.
extern "C" int lstm_bwd_persist_launch(
    const void* gx0, const void* gx1, const void* hprev0, const void* hprev1,
    const void* cprev0, const void* cprev1, const void* dout0, const void* dout1,
    const void* lengths, const void* w_hh0, const void* w_hh1,
    const void* w_hht0, const void* w_hht1, const void* b_hh0, const void* b_hh1,
    void* part0, void* part1,   // (B, H) f32 each
    void* dc0, void* dc1,       // (B, H) f32 each
    void* dg,                   // (2 buffers, chains, B, 4H) bf16
    void* dg4_0, void* dg4_1,   // (T, B, 4H) f32 each
    void* barrier,              // (chains,) uint32, zeroed
    int T, int B, int H, int reverse0, int reverse1, int chains, int U, int MG,
    int stages, int kc, int bpd, int smem, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((chains != 1 && chains != 2) || U % 8 != 0 || (MG != 1 && MG != 2) ||
      stages < 2 || stages > PS_MAX_STAGES || (kc != 32 && kc != 64 && kc != 128) ||
      (2 / MG * kc) % PS_BOX != 0 || bpd * U < H || (bpd - 1) * U >= H)
    return (int)cudaErrorInvalidValue;

  LstmBwdPersistArgs p;
  const void* gx[2] = {gx0, gx1};
  const void* hprev[2] = {hprev0, hprev1};
  const void* cprev[2] = {cprev0, cprev1};
  const void* dout[2] = {dout0, dout1};
  const void* whh[2] = {w_hh0, w_hh1};
  const void* whht[2] = {w_hht0, w_hht1};
  const void* bhh[2] = {b_hh0, b_hh1};
  void* part[2] = {part0, part1};
  void* dcs[2] = {dc0, dc1};
  void* dg4s[2] = {dg4_0, dg4_1};
  const int reverse[2] = {reverse0, reverse1};
  for (int c = 0; c < 2; ++c) {
    const int k = c < chains ? c : 0;
    p.gx[c] = static_cast<const bf16*>(gx[k]);
    p.cprev[c] = static_cast<const bf16*>(cprev[k]);
    p.dout[c] = static_cast<const float*>(dout[k]);
    p.whh[c] = static_cast<const bf16*>(whh[k]);
    p.bhh[c] = static_cast<const float*>(bhh[k]);
    p.part[c] = static_cast<float*>(part[k]);
    p.dc[c] = static_cast<float*>(dcs[k]);
    p.dg4[c] = static_cast<float*>(dg4s[k]);
    p.reverse[c] = reverse[k] ? 1 : 0;
  }
  p.lengths = static_cast<const int*>(lengths);
  p.dg = static_cast<bf16*>(dg);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.chains = chains;
  p.T = T; p.B = B; p.H = H; p.U = U; p.MG = MG; p.stages = stages; p.kc = kc;
  p.bpd = bpd; p.Kr = (4 * H + 63) / 64 * 64;

  for (int c = 0; c < chains; ++c) {
    const int rc = lstm_recompute(static_cast<const bf16*>(hprev[c]), p.whh[c],
                                  static_cast<const bf16*>(whht[c]), p.dg4[c], T, B, H, s);
    if (rc != 0) return rc;
  }

  p.ws_off = smem - U * p.Kr * 2;
  const int BR = MG * 64;
  if (p.ws_off < stages * BR * (2 / MG * kc) * 2 ||
      p.ws_off < 2 / MG * BR * (U + 1) * 4 || p.ws_off % 1024 != 0)
    return (int)cudaErrorInvalidValue;
  // dg: (2 buffers x chains, B, 4H)
  CUtensorMap dg_map = {};
  p.tma = ps_tma_ok(dg, 4 * H) ? 1 : 0;
  if (p.tma) {
    const int rc = ps_make_tmap(&dg_map, dg, 4 * H, B, 2 * chains, BR);
    if (rc != 0) return rc;
  }
  void* args[] = {&p, &dg_map};
  const int grid = chains * bpd;
  switch (U / 8) {
    case 1: return ps_coop_launch((const void*)lstm_bwd_persist_kernel<1>, grid, PS_BLOCK, smem, args, s);
    case 2: return ps_coop_launch((const void*)lstm_bwd_persist_kernel<2>, grid, PS_BLOCK, smem, args, s);
    case 3: return ps_coop_launch((const void*)lstm_bwd_persist_kernel<3>, grid, PS_BLOCK, smem, args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
