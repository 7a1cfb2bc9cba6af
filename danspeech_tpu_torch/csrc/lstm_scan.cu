// One LSTM chain over a precomputed input projection, for Hopper, with and
// without the cell stream.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:lstm_scan (kernel body
// _lstm_step_kernel) and :lstm_scan_with_cell (_lstm_step_kernel_cell).
// Same contract, gate order i, f, g, o, but for the bias:
//   gx (T, B, 4H) bf16, the bias-free projection x @ w_ih as the GEMM
//   rounded it; lengths (B,) int32; w_hh (H, 4H) bf16; b_hh (4H,) f32, the
//   per-step bias, which ops/rnn.py hands as b_ih + b_hh (the JAX kernel
//   reads b_ih inside gx); h0, c0 (B, H) f32;
//   gh = bf16(h) @ w_hh accumulated in f32, pre = gx + gh + b_hh,
//   c' = f c + i g, h' = o tanh(c'), gates and both carried states in f32;
//   out (T, B, H) bf16 = h' where t < length, exact zeros elsewhere, and the
//   states freeze there; lstm_scan_with_cell also writes c_seq (T, B, H) bf16
//   = c' masked the same way (the residual of the backward walk, which reads
//   it rounded to bf16). reverse walks t = T-1 .. 0. h_last and c_last are
//   the f32 states after the walk.
//
// What bounds it on an H100, and what this design does about it:
// - T dependent steps, each a (B, H) x (H, 4H) product that needs all of
//   h_{t-1}: 2*T*B*H*4H operations, 263 GFLOP at the serving shape (T=401,
//   B=128, H=800), 0.27 ms at the bf16 peak. What a step costs is latency (a
//   barrier, an L2 round trip, one pass over the weights), not bytes or
//   operations. Two designs, chosen on the host by ops/persist_plan.py
//   (plan_lstm_forward) from the shape and the device's SM count and shared
//   memory:
//   * persistent (lstm_persist_kernel, persist.cuh): ONE cooperative launch
//     walks one chain, or both chains of a bidirectional layer (the chain as
//     the slow grid index, each chain with its own barrier, so the two never
//     wait for each other). A block owns U hidden units of one chain (U = 16
//     at H = 800 for two chains, 50 blocks each; U = 8 for one chain, 100
//     blocks) and keeps their 4U columns of w_hh, H deep, in shared memory
//     for the whole walk (104 KB and 52 KB). Per step: the chain's barrier;
//     bf16 h of the previous step streams from L2 through a TMA ring beside
//     the slice while the two warpgroups multiply with wgmma; then the gates,
//     the mask and the writes. c never leaves its block: the thread that
//     owns (b, j) updates it in place every step, as it does f32 h, and only
//     the bf16 copy of h is exchanged (ping-pong between two buffers that the
//     other blocks read through L2). gx of the next step is prefetched into
//     L2 during the product. The walk covers only t < the longest row's
//     length: the later steps write zeros at the start and take no barrier.
//   * step (lstm_step_kernel): one launch per time step from the host loop
//     below; each block owns 16 units j (columns j, H+j, 2H+j, 3H+j of w_hh:
//     four WMMA tiles per chunk, rnn_step.cuh) for 64 batch rows and rereads
//     its slice from L2. Kept for widths whose slices do not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "persist.cuh"
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
// Host entries, step design: one chain, on the caller's stream. h32/h16 hold two buffers
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

// ---------------------------------------------------------------------------
// Persistent design: one chain, or both chains of a layer, in one
// cooperative launch
// ---------------------------------------------------------------------------

struct LstmPersistArgs {
  const bf16* gx[2];      // (T, B, 4H) bf16, bias-free
  const int* lengths;     // (B,)
  const bf16* whht[2];    // (4H, H): w_hh transposed, depth contiguous
  const float* bhh[2];    // (4H,)
  float* h32[2];          // (B, H) f32: h0 on entry, h_last on exit
  float* c32[2];          // (B, H) f32: c0 on entry, c_last on exit
  bf16* hb;               // (2 buffers, chains, B, H) bf16: buffer 0 holds bf16(h0)
  bf16* out[2];           // (T, B, H)
  bf16* cseq[2];          // (T, B, H), or null
  unsigned int* barrier;  // (chains,) zeros on entry
  int reverse[2];
  int chains;
  int T, B, H;
  int U;       // hidden units per block (a multiple of 8)
  int MG;      // warpgroups along the rows of a row block (64 rows each): 1 or 2
  int stages;  // ring stages: 2 .. PS_MAX_STAGES
  int kc;      // depth one warpgroup covers of a ring chunk: 128, 64 or 32
  int bpd;     // blocks per chain
  int Kr;      // H rounded up to 64
  int ws_off;  // bytes from the start of shared memory (the ring) to the slice
  int tma;     // hb can be read by the copy engine (else element by element)
};

template <int NT>  // 4 * U / 8: 8-column tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
lstm_persist_kernel(const LstmPersistArgs p, const __grid_constant__ CUtensorMap hb_map) {
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

  // the epilogue's streams do not alias: its loads may be issued together
  const bf16* __restrict__ gx = p.gx[ch];
  const float* __restrict__ bhh = p.bhh[ch];
  const int* __restrict__ lengths = p.lengths;
  float* __restrict__ h32 = p.h32[ch];
  float* __restrict__ c32 = p.c32[ch];
  bf16* __restrict__ out = p.out[ch];
  bf16* __restrict__ cseq = p.cseq[ch];
  const bool reverse = p.reverse[ch] != 0;
  const size_t hsz = (size_t)p.chains * B * H;
  unsigned int* counter = p.barrier + ch;
  const int uw = min(U, H - j0);  // real units of this block
  const bool vec4 =
      (H % 4) == 0 &&
      ((reinterpret_cast<uintptr_t>(h32) | reinterpret_cast<uintptr_t>(c32) |
        reinterpret_cast<uintptr_t>(bhh)) % 16) == 0 &&
      ((reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(p.hb) |
        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(cseq)) % 8) == 0;

  const int steps = ps_longest(lengths, B, T);
  ps_zero_steps(out, steps, T, B, H, j0, uw);
  if (cseq != nullptr) ps_zero_steps(cseq, steps, T, B, H, j0, uw);
  ps_load_slice(Ws, p.whht[ch], H, H, p.Kr, 4, U, j0);
  ps_ring_init(ring, ps_mbar, p.stages);

  PS_T0();
  for (int step = 0; step < steps; ++step) {
    const int t = reverse ? steps - 1 - step : step;
    const bf16* hb_in = p.hb + (step & 1) * hsz + (size_t)ch * B * H;
    bf16* __restrict__ hb_out = p.hb + ((step & 1) ^ 1) * hsz + (size_t)ch * B * H;
    PS_ACC(0);
    if (step > 0) ps_grid_barrier(counter, (unsigned int)step * p.bpd);
    PS_ACC(1);
    if (step + 1 < steps) {
      // the next step's gx does not depend on h: bring it into L2 meanwhile
      const int tn = reverse ? t - 1 : t + 1;
      for (int i = tid; i < B * 4; i += PS_BLOCK) {
        const int b = i >> 2, g = i & 3;
        const bf16* q = gx + ((size_t)tn * B + b) * G + (size_t)g * H + j0;
        ps_prefetch_l2(q);
        ps_prefetch_l2(q + uw - 1);
      }
    }
    PS_ACC(2);
    for (int rb = 0; rb < nrb; ++rb) {
      const int row0 = rb * BR;
      PS_ACC(0);
      ps_block_product<NT>(hb_in, &hb_map, p.tma, (step & 1) * p.chains + ch, row0, B, H,
                           p.Kr, Ws, ring, Cs, p.MG, p.stages, p.kc, ps_mbar, phases);
      PS_ACC(9);
      constexpr int UC = NT * 2;  // == U
      if (vec4) {
        // a thread's quads of four neighbouring units, EQ at a time: first
        // every load they need, then the arithmetic
        constexpr int QC = UC / 4;
        constexpr int EQ = 2;
        for (int base = tid; base < BR * QC; base += EQ * PS_BLOCK) {
          float4 xi[EQ], xf[EQ], xg[EQ], xo[EQ], hp[EQ], cp[EQ];
          int len[EQ];
          unsigned live = 0u;
#pragma unroll
          for (int e = 0; e < EQ; ++e) {
            const int idx = base + e * PS_BLOCK;
            const int r = idx / QC, q = idx - r * QC;
            const int b = row0 + r, j = j0 + 4 * q;
            if (idx < BR * QC && b < B && j < H) {  // H % 4 == 0: a whole quad
              const bf16* gxr = gx + ((size_t)t * B + b) * G + j;
              xi[e] = ps_load_bf16x4(gxr);
              xf[e] = ps_load_bf16x4(gxr + H);
              xg[e] = ps_load_bf16x4(gxr + 2 * H);
              xo[e] = ps_load_bf16x4(gxr + 3 * H);
              hp[e] = *reinterpret_cast<const float4*>(h32 + (size_t)b * H + j);
              cp[e] = *reinterpret_cast<const float4*>(c32 + (size_t)b * H + j);
              len[e] = lengths[b];
              live |= 1u << e;
            }
          }
#pragma unroll
          for (int e = 0; e < EQ; ++e) {
            if (!(live >> e & 1u)) continue;
            const int idx = base + e * PS_BLOCK;
            const int r = idx / QC, q = idx - r * QC;
            const int b = row0 + r, j = j0 + 4 * q;
            const bool valid = len[e] > t;
            const float4 bi = *reinterpret_cast<const float4*>(bhh + j);
            const float4 bf = *reinterpret_cast<const float4*>(bhh + H + j);
            const float4 bg = *reinterpret_cast<const float4*>(bhh + 2 * H + j);
            const float4 bo = *reinterpret_cast<const float4*>(bhh + 3 * H + j);
            const float pi[4] = {xi[e].x + bi.x, xi[e].y + bi.y, xi[e].z + bi.z,
                                 xi[e].w + bi.w};
            const float pf[4] = {xf[e].x + bf.x, xf[e].y + bf.y, xf[e].z + bf.z,
                                 xf[e].w + bf.w};
            const float pg[4] = {xg[e].x + bg.x, xg[e].y + bg.y, xg[e].z + bg.z,
                                 xg[e].w + bg.w};
            const float po[4] = {xo[e].x + bo.x, xo[e].y + bo.y, xo[e].z + bo.z,
                                 xo[e].w + bo.w};
            const float hpv[4] = {hp[e].x, hp[e].y, hp[e].z, hp[e].w};
            const float cpv[4] = {cp[e].x, cp[e].y, cp[e].z, cp[e].w};
            float hv[4], cv[4], ov[4], sv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int u = 4 * q + k;
              const float ig = ps_sigmoid(pi[k] + ps_sum_splits(Cs, KS, BR, ldc, r, u));
              const float fg = ps_sigmoid(pf[k] + ps_sum_splits(Cs, KS, BR, ldc, r, UC + u));
              const float gg = ps_tanh(pg[k] + ps_sum_splits(Cs, KS, BR, ldc, r, 2 * UC + u));
              const float og = ps_sigmoid(po[k] + ps_sum_splits(Cs, KS, BR, ldc, r, 3 * UC + u));
              const float cn = fg * cpv[k] + ig * gg;
              const float hn = og * ps_tanh(cn);
              hv[k] = valid ? hn : hpv[k];
              cv[k] = valid ? cn : cpv[k];
              ov[k] = valid ? hn : 0.0f;
              sv[k] = valid ? cn : 0.0f;
            }
            const size_t hi = (size_t)b * H + j;
            const size_t oi = ((size_t)t * B + b) * H + j;
            *reinterpret_cast<float4*>(h32 + hi) = make_float4(hv[0], hv[1], hv[2], hv[3]);
            *reinterpret_cast<float4*>(c32 + hi) = make_float4(cv[0], cv[1], cv[2], cv[3]);
            ps_store_bf16x4(hb_out + hi, hv);
            ps_store_bf16x4(out + oi, ov);
            if (cseq != nullptr) ps_store_bf16x4(cseq + oi, sv);
          }
        }
      } else {
        // H no multiple of 4, or a stream that does not start where the
        // vector loads need: one unit at a time
        for (int idx = tid; idx < BR * UC; idx += PS_BLOCK) {
          const int r = idx / UC, u = idx - r * UC;
          const int b = row0 + r, j = j0 + u;
          if (b >= B || j >= H) continue;
          const bf16* gxr = gx + ((size_t)t * B + b) * G;
          const float ig = ps_sigmoid(__bfloat162float(gxr[j]) + bhh[j] +
                                      ps_sum_splits(Cs, KS, BR, ldc, r, u));
          const float fg = ps_sigmoid(__bfloat162float(gxr[H + j]) + bhh[H + j] +
                                      ps_sum_splits(Cs, KS, BR, ldc, r, UC + u));
          const float gg = ps_tanh(__bfloat162float(gxr[2 * H + j]) + bhh[2 * H + j] +
                                   ps_sum_splits(Cs, KS, BR, ldc, r, 2 * UC + u));
          const float og = ps_sigmoid(__bfloat162float(gxr[3 * H + j]) + bhh[3 * H + j] +
                                      ps_sum_splits(Cs, KS, BR, ldc, r, 3 * UC + u));
          const size_t hi = (size_t)b * H + j;
          const size_t oi = ((size_t)t * B + b) * H + j;
          const float hp = h32[hi], cp = c32[hi];
          const float cn = fg * cp + ig * gg;
          const float hn = og * ps_tanh(cn);
          const bool valid = lengths[b] > t;
          const float hnext = valid ? hn : hp;
          h32[hi] = hnext;
          if (valid) c32[hi] = cn;
          hb_out[hi] = __float2bfloat16(hnext);
          out[oi] = __float2bfloat16(valid ? hn : 0.0f);
          if (cseq != nullptr) cseq[oi] = __float2bfloat16(valid ? cn : 0.0f);
        }
      }
      __syncthreads();  // Cs lies over the ring of the next product
      PS_ACC(3);
    }
  }
}

// Host entry, persistent design, for `chains` = 1 or 2 chains that share T,
// B, H and lengths (the two directions of a bidirectional layer): every
// per-chain pointer has a second one, ignored when chains = 1. h32_c and c32_c
// hold h0 and c0 on entry and h_last and c_last on exit; buffer 0 of h16 holds
// bf16(h0) of each chain; cseq_c is null for lstm_scan. w_hht_c is w_hh
// transposed (4H, H). The plan (U, MG, stages, kc, bpd, smem bytes) comes from
// ops/persist_plan.py; the launch is refused with an error code if the device
// cannot hold the grid.
extern "C" int lstm_scan_persist_launch(
    const void* gx0, const void* gx1, const void* lengths, const void* w_hht0,
    const void* w_hht1, const void* b_hh0, const void* b_hh1,
    void* h32_0, void* h32_1,   // (B, H) f32 each
    void* c32_0, void* c32_1,   // (B, H) f32 each
    void* h16,                  // (2 buffers, chains, B, H) bf16
    void* out0, void* out1,     // (T, B, H) bf16 each
    void* cseq0, void* cseq1,   // (T, B, H) bf16 each, or null
    void* barrier,              // (chains,) uint32, zeroed
    int T, int B, int H, int reverse0, int reverse1, int chains, int U, int MG,
    int stages, int kc, int bpd, int smem, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((chains != 1 && chains != 2) || U % 8 != 0 || (MG != 1 && MG != 2) ||
      stages < 2 || stages > PS_MAX_STAGES || (kc != 32 && kc != 64 && kc != 128) ||
      bpd * U < H || (bpd - 1) * U >= H)
    return (int)cudaErrorInvalidValue;
  LstmPersistArgs p;
  const void* gx[2] = {gx0, gx1};
  const void* whht[2] = {w_hht0, w_hht1};
  const void* bhh[2] = {b_hh0, b_hh1};
  void* h32[2] = {h32_0, h32_1};
  void* c32[2] = {c32_0, c32_1};
  void* out[2] = {out0, out1};
  void* cseq[2] = {cseq0, cseq1};
  const int reverse[2] = {reverse0, reverse1};
  for (int c = 0; c < 2; ++c) {
    const int k = c < chains ? c : 0;
    p.gx[c] = static_cast<const bf16*>(gx[k]);
    p.whht[c] = static_cast<const bf16*>(whht[k]);
    p.bhh[c] = static_cast<const float*>(bhh[k]);
    p.h32[c] = static_cast<float*>(h32[k]);
    p.c32[c] = static_cast<float*>(c32[k]);
    p.out[c] = static_cast<bf16*>(out[k]);
    p.cseq[c] = static_cast<bf16*>(cseq[k]);
    p.reverse[c] = reverse[k] ? 1 : 0;
  }
  p.lengths = static_cast<const int*>(lengths);
  p.hb = static_cast<bf16*>(h16);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.chains = chains;
  p.T = T; p.B = B; p.H = H;
  p.U = U; p.MG = MG; p.stages = stages; p.kc = kc; p.bpd = bpd;
  p.Kr = (H + 63) / 64 * 64;
  p.ws_off = smem - 4 * U * p.Kr * 2;
  const int BR = MG * 64;
  const int KCB = 2 / MG * kc;  // depth of a ring chunk
  if (KCB % PS_BOX != 0 || p.ws_off < stages * BR * KCB * 2 ||
      p.ws_off < 2 / MG * BR * (4 * U + 1) * 4 || p.ws_off % 1024 != 0)
    return (int)cudaErrorInvalidValue;
  // hb: (2 buffers x chains, B, H)
  CUtensorMap hb_map = {};
  p.tma = ps_tma_ok(h16, H) ? 1 : 0;
  if (p.tma) {
    const int rc = ps_make_tmap(&hb_map, h16, H, B, 2 * chains, BR);
    if (rc != 0) return rc;
  }
  void* args[] = {&p, &hb_map};
  const int grid = chains * bpd;
  switch (U / 8) {
    case 1: return ps_coop_launch((const void*)lstm_persist_kernel<4>, grid, PS_BLOCK, smem, args, s);
    case 2: return ps_coop_launch((const void*)lstm_persist_kernel<8>, grid, PS_BLOCK, smem, args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
