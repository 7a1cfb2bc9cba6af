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
// - T dependent steps, each a (B, H) x (H, H) product that needs all of
//   h_{t-1}: 2*T*B*H*H operations, 66 GFLOP at the serving shape (T=401,
//   B=128, H=800), 0.066 ms at the bf16 peak, against 166 MB of streams and
//   weights (0.049 ms at 3.35 TB/s). What a step costs is latency (a
//   barrier, an L2 round trip, one pass over the weights), not bytes or
//   operations. Two designs, chosen on the host by ops/persist_plan.py
//   (plan_rnn_tanh_forward) from the shape and the device's SM count and
//   shared memory:
//   * persistent (rnn_tanh_persist_kernel, persist.cuh): ONE cooperative
//     launch walks one chain, or both chains of a bidirectional layer (the
//     chain as the slow grid index, each chain with its own barrier counter
//     and its own planes of the ping-pong buffer, so the two never wait for
//     each other). A block owns U hidden units of one chain (U = 8 for one
//     chain at H = 800, 100 blocks; U = 16 for two, 50 blocks a chain) and
//     keeps their U columns of w_hh, H deep, in shared memory for the whole
//     walk (13 KB and 27 KB), which leaves room for six 128-deep ring
//     stages. Per step: the chain's barrier; bf16 h of the previous step
//     streams from L2 through a TMA ring beside the slice while the two
//     warpgroups multiply with wgmma; then tanh, the length mask, the out
//     write and the h update (f32 h owned in place by one thread, its bf16
//     copy ping-pongs between two buffers that the other blocks read
//     through L2). gx of the next step is prefetched into L2 during the
//     product. The walk covers only t < the longest row's length: the
//     later steps write zeros at the start and take no barrier.
//   * step (rnn_tanh_step_kernel): one launch per time step from the host
//     loop below, the launch boundary as the barrier; each block owns 16
//     units for 64 batch rows (one WMMA tile per chunk, rnn_step.cuh) and
//     rereads its slice of w_hh from L2 (11.5-11.8 ms at the serving shape
//     by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W). Kept for
//     widths whose slices do not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "persist.cuh"
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
// Host entry, step design: one chain, on the caller's stream. h32/h16 hold
// two buffers of (B, H); buffer 0 holds zeros on entry, and buffer T % 2
// holds h_last on exit. Returns cudaGetLastError() of the first launch that
// failed, else 0.
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

// ---------------------------------------------------------------------------
// Persistent design: one chain, or both chains of a layer, in one
// cooperative launch
// ---------------------------------------------------------------------------

struct RnnTanhPersistArgs {
  const bf16* gx[2];      // (T, B, H) bf16, both biases inside
  const int* lengths;     // (B,)
  const bf16* whht[2];    // (H, H): w_hh transposed, depth contiguous
  float* h32[2];          // (B, H) f32: zeros on entry, h_last on exit
  bf16* hb;               // (2 buffers, chains, B, H) bf16: buffer 0 holds zeros
  bf16* out[2];           // (T, B, H)
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

template <int NT>  // U / 8: 8-column tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
rnn_tanh_persist_kernel(const RnnTanhPersistArgs p,
                        const __grid_constant__ CUtensorMap hb_map) {
  extern __shared__ __align__(1024) unsigned char ps_smem_raw[];
  __shared__ __align__(8) uint64_t ps_mbar[2 * PS_MAX_STAGES];
  PsPhases phases;
  const int tid = threadIdx.x;
  const int ch = blockIdx.x / p.bpd;
  const int j0 = (blockIdx.x - ch * p.bpd) * p.U;
  const int T = p.T, B = p.B, H = p.H, U = p.U;
  bf16* ring = reinterpret_cast<bf16*>(ps_smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(ps_smem_raw + p.ws_off);
  float* Cs = reinterpret_cast<float*>(ring);
  const int BR = p.MG * 64;
  const int KS = 2 / p.MG;  // planes of partial sums: one a depth split
  const int ldc = NT * 8 + 1;
  const int nrb = (B + BR - 1) / BR;

  // the epilogue's streams do not alias: its loads may be issued together
  const bf16* __restrict__ gx = p.gx[ch];
  const int* __restrict__ lengths = p.lengths;
  float* __restrict__ h32 = p.h32[ch];
  bf16* __restrict__ out = p.out[ch];
  const bool reverse = p.reverse[ch] != 0;
  const size_t hsz = (size_t)p.chains * B * H;
  unsigned int* counter = p.barrier + ch;
  const int uw = min(U, H - j0);  // real units of this block
  const bool vec4 =
      (H % 4) == 0 && (reinterpret_cast<uintptr_t>(h32) % 16) == 0 &&
      ((reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(p.hb) |
        reinterpret_cast<uintptr_t>(out)) % 8) == 0;

  const int steps = ps_longest(lengths, B, T);
  ps_zero_steps(out, steps, T, B, H, j0, uw);
  ps_load_slice(Ws, p.whht[ch], H, H, p.Kr, 1, U, j0);
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
      for (int b = tid; b < B; b += PS_BLOCK) {
        const bf16* q = gx + ((size_t)tn * B + b) * H + j0;
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
      constexpr int UC = NT * 8;  // == U
      if (vec4) {
        // a thread's quads of four neighbouring units, EQ at a time: first
        // every load they need, then the arithmetic
        constexpr int QC = UC / 4;
        constexpr int EQ = 2;
        for (int base = tid; base < BR * QC; base += EQ * PS_BLOCK) {
          float4 x[EQ], hp[EQ];
          int len[EQ];
          unsigned live = 0u;
#pragma unroll
          for (int e = 0; e < EQ; ++e) {
            const int idx = base + e * PS_BLOCK;
            const int r = idx / QC, q = idx - r * QC;
            const int b = row0 + r, j = j0 + 4 * q;
            if (idx < BR * QC && b < B && j < H) {  // H % 4 == 0: a whole quad
              x[e] = ps_load_bf16x4(gx + ((size_t)t * B + b) * H + j);
              hp[e] = *reinterpret_cast<const float4*>(h32 + (size_t)b * H + j);
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
            const float xv[4] = {x[e].x, x[e].y, x[e].z, x[e].w};
            const float hpv[4] = {hp[e].x, hp[e].y, hp[e].z, hp[e].w};
            float hv[4], ov[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float hn = ps_tanh(xv[k] + ps_sum_splits(Cs, KS, BR, ldc, r, 4 * q + k));
              hv[k] = valid ? hn : hpv[k];
              ov[k] = valid ? hn : 0.0f;
            }
            const size_t hi = (size_t)b * H + j;
            *reinterpret_cast<float4*>(h32 + hi) = make_float4(hv[0], hv[1], hv[2], hv[3]);
            ps_store_bf16x4(hb_out + hi, hv);
            ps_store_bf16x4(out + ((size_t)t * B + b) * H + j, ov);
          }
        }
      } else {
        // H no multiple of 4, or a stream that does not start where the
        // vector loads need: one unit at a time
        for (int idx = tid; idx < BR * UC; idx += PS_BLOCK) {
          const int r = idx / UC, u = idx - r * UC;
          const int b = row0 + r, j = j0 + u;
          if (b >= B || j >= H) continue;
          const size_t hi = (size_t)b * H + j;
          const size_t oi = ((size_t)t * B + b) * H + j;
          const float hn =
              ps_tanh(__bfloat162float(gx[oi]) + ps_sum_splits(Cs, KS, BR, ldc, r, u));
          const bool valid = lengths[b] > t;
          const float hnext = valid ? hn : h32[hi];
          h32[hi] = hnext;
          hb_out[hi] = __float2bfloat16(hnext);
          out[oi] = __float2bfloat16(valid ? hn : 0.0f);
        }
      }
      __syncthreads();  // Cs lies over the ring of the next product
      PS_ACC(3);
    }
  }
}

// Host entry, persistent design, for `chains` = 1 or 2 chains that share T,
// B, H and lengths (the two directions of a bidirectional layer): every
// per-chain pointer has a second one, ignored when chains = 1. h32_c holds
// zeros on entry and h_last on exit; buffer 0 of h16 holds zeros. w_hht_c is
// w_hh transposed (H, H). The plan (U, MG, stages, kc, bpd, smem bytes) comes
// from ops/persist_plan.py; the launch is refused with an error code if the
// device cannot hold the grid.
extern "C" int rnn_tanh_scan_persist_launch(
    const void* gx0, const void* gx1, const void* lengths, const void* w_hht0,
    const void* w_hht1,
    void* h32_0, void* h32_1,   // (B, H) f32 each
    void* h16,                  // (2 buffers, chains, B, H) bf16
    void* out0, void* out1,     // (T, B, H) bf16 each
    void* barrier,              // (chains,) uint32, zeroed
    int T, int B, int H, int reverse0, int reverse1, int chains, int U, int MG,
    int stages, int kc, int bpd, int smem, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((chains != 1 && chains != 2) || U % 8 != 0 || (MG != 1 && MG != 2) ||
      stages < 2 || stages > PS_MAX_STAGES || (kc != 32 && kc != 64 && kc != 128) ||
      bpd * U < H || (bpd - 1) * U >= H)
    return (int)cudaErrorInvalidValue;
  RnnTanhPersistArgs p;
  const void* gx[2] = {gx0, gx1};
  const void* whht[2] = {w_hht0, w_hht1};
  void* h32[2] = {h32_0, h32_1};
  void* out[2] = {out0, out1};
  const int reverse[2] = {reverse0, reverse1};
  for (int c = 0; c < 2; ++c) {
    const int k = c < chains ? c : 0;
    p.gx[c] = static_cast<const bf16*>(gx[k]);
    p.whht[c] = static_cast<const bf16*>(whht[k]);
    p.h32[c] = static_cast<float*>(h32[k]);
    p.out[c] = static_cast<bf16*>(out[k]);
    p.reverse[c] = reverse[k] ? 1 : 0;
  }
  p.lengths = static_cast<const int*>(lengths);
  p.hb = static_cast<bf16*>(h16);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.chains = chains;
  p.T = T; p.B = B; p.H = H;
  p.U = U; p.MG = MG; p.stages = stages; p.kc = kc; p.bpd = bpd;
  p.Kr = (H + 63) / 64 * 64;
  p.ws_off = smem - U * p.Kr * 2;
  const int BR = MG * 64;
  const int KCB = 2 / MG * kc;  // depth of a ring chunk
  if (KCB % PS_BOX != 0 || p.ws_off < stages * BR * KCB * 2 ||
      p.ws_off < 2 / MG * BR * (U + 1) * 4 || p.ws_off % 1024 != 0)
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
    case 1: return ps_coop_launch((const void*)rnn_tanh_persist_kernel<1>, grid, PS_BLOCK, smem, args, s);
    case 2: return ps_coop_launch((const void*)rnn_tanh_persist_kernel<2>, grid, PS_BLOCK, smem, args, s);
    case 3: return ps_coop_launch((const void*)rnn_tanh_persist_kernel<3>, grid, PS_BLOCK, smem, args, s);
    case 4: return ps_coop_launch((const void*)rnn_tanh_persist_kernel<4>, grid, PS_BLOCK, smem, args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
