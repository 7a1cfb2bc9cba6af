// tanh-RNN backward walk (training) for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:rnn_tanh_bwd_scan (kernel body
// _rnn_tanh_bwd_kernel). Same contract, streams in natural time order:
//   out (T, B, H) bf16, the forward output stream (h' where t < length,
//   zeros elsewhere); dout (T, B, H) f32; lengths (B,) int32; w_hh (H, H)
//   bf16 (the step design reads its transpose).
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
//   dpre, so a step is latency (a barrier, an L2 round trip, one pass over
//   the weights). A block owns U hidden units j. It first finishes the
//   previous step's carry for its units, dh = partial + bf16(dpre_prev) @
//   w_hh^T[:, j], then applies step t's elementwise gradient at its units and
//   leaves dpre_t in bf16 (ping-pong between two buffers) and the partial
//   carry (1 - m) dh (f32). One more step (t < 0) only finishes the carry:
//   that is dh0. Two designs, chosen on the host by ops/persist_plan.py
//   (plan_rnn_tanh_backward) from the shape and the device's SM count and
//   shared memory:
//   * persistent (rnn_tanh_bwd_persist_kernel, persist.cuh): ONE cooperative
//     launch walks all T + 1 steps of one chain, or of both chains of a
//     bidirectional layer (the chain as the slow grid index, each chain with
//     its own barrier counter and its own planes of the dpre ping-pong). A
//     block keeps its U columns of w_hh^T, H deep, in shared memory for the
//     whole walk; they are rows j of w_hh itself, so no transposed copy is
//     made on this route (U = 8 for one chain at H = 800, 100 blocks; U = 16
//     for two, 50 blocks a chain). Per step: the barrier; bf16 dpre of the
//     previous step streams from L2 through a TMA ring beside the slice while
//     the two warpgroups multiply with wgmma (at B = 32 one warpgroup's 64
//     rows hold the batch, so the two split the depth and their partial sums
//     are added in a fixed order); dh of a frozen row passes through in
//     place. The next step's out and dout at the block's units do not depend
//     on the carry: they are prefetched into L2 during the product.
//   * step (rnn_tanh_bwd_step_kernel): one launch per time step from the
//     host loop, the launch boundary as the barrier; a block owns 16 units
//     for 64 rows and rereads its slice of w_hh^T (kept per weight tensor by
//     ops/gru_cuda.py:transposed) from L2 (rnn_step.cuh; 8.7-8.9 ms at the
//     training shape by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W).
//     Kept for widths whose slices do not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "persist.cuh"
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
// Host entry, step design: one chain's backward walk, on the caller's
// stream. part holds two buffers of (B, H) f32 and dp two of (B, H) bf16; on
// entry buffer 0 of each holds zeros; on exit buffer (T + 1) % 2 of part
// holds dh0. w_hht is w_hh transposed. Returns cudaGetLastError() of the
// first launch that failed, else 0.
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

// ---------------------------------------------------------------------------
// Persistent design: all T + 1 steps of one or two chains in one cooperative
// launch
// ---------------------------------------------------------------------------

struct RnnTanhBwdPersistArgs {
  const bf16* out[2];     // (T, B, H) the forward output stream
  const float* dout[2];   // (T, B, H)
  const int* lengths;     // (B,)
  const bf16* whh[2];     // (H, H): row j is column j of w_hh^T, H deep
  float* part[2];         // (B, H) f32: zeros on entry, dh0 on exit
  bf16* dp;               // (2 buffers, chains, B, H) bf16 (step 0 reads none)
  float* dpre[2];         // (T, B, H)
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
  int tma;     // dp can be read by the copy engine (else element by element)
};

template <int NT>  // U / 8: 8-column MMA tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
rnn_tanh_bwd_persist_kernel(const RnnTanhBwdPersistArgs p,
                            const __grid_constant__ CUtensorMap dp_map) {
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

  // the epilogue's input streams do not alias its outputs: their loads may
  // be issued together
  const bf16* __restrict__ out = p.out[ch];
  const float* __restrict__ dout = p.dout[ch];
  const int* __restrict__ lengths = p.lengths;
  float* __restrict__ part = p.part[ch];
  float* __restrict__ dpre = p.dpre[ch];
  const bool reverse = p.reverse[ch] != 0;
  const size_t psz = (size_t)p.chains * B * H;
  unsigned int* counter = p.barrier + ch;
  const int uw = min(U, H - j0);  // real units of this block

  ps_load_slice(Ws, p.whh[ch], H, H, p.Kr, 1, U, j0);
  ps_ring_init(ring, ps_mbar, p.stages);

  PS_T0();
  for (int step = 0; step <= T; ++step) {
    const int t = step == T ? -1 : (reverse ? T - 1 - step : step);
    const bf16* dp_in = p.dp + (step & 1) * psz + (size_t)ch * B * H;
    bf16* __restrict__ dp_out = p.dp + ((step & 1) ^ 1) * psz + (size_t)ch * B * H;
    PS_ACC(0);
    if (step > 0) ps_grid_barrier(counter, (unsigned int)step * p.bpd);
    PS_ACC(1);
    if (step + 1 < T) {
      // the next step's streams do not depend on the carry: bring them into
      // L2 meanwhile
      const int tn = reverse ? t - 1 : t + 1;
      for (int i = tid; i < B * 2; i += PS_BLOCK) {
        const int b = i >> 1;
        const size_t row = ((size_t)tn * B + b) * H + j0;
        const char* q = (i & 1) ? reinterpret_cast<const char*>(dout + row)
                                : reinterpret_cast<const char*>(out + row);
        ps_prefetch_l2(q);
        ps_prefetch_l2(q + uw * ((i & 1) ? 4 : 2) - 1);
      }
    }
    PS_ACC(2);
    for (int rb = 0; rb < nrb; ++rb) {
      const int row0 = rb * BR;
      // before the first step dpre is zero: the carry is the zero start itself
      PS_ACC(0);
      if (step > 0)
        ps_block_product<NT>(dp_in, &dp_map, p.tma, (step & 1) * p.chains + ch, row0, B, H,
                             p.Kr, Ws, ring, Cs, p.MG, p.stages, p.kc, ps_mbar, phases);
      PS_ACC(9);
      // a thread's elements, EP at a time: first every load they need, then
      // the arithmetic, so the loads' latencies overlap
      constexpr int UC = NT * 8;  // == U
      constexpr int EP = 4;
      for (int base = tid; base < BR * UC; base += EP * PS_BLOCK) {
        float dh[EP], hn[EP], dy[EP];
        int len[EP];
        unsigned live = 0u;
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          const int idx = base + e * PS_BLOCK;
          const int r = idx / UC, u = idx - r * UC;
          const int b = row0 + r, j = j0 + u;
          if (idx < BR * UC && b < B && j < H) {
            live |= 1u << e;
            dh[e] = part[(size_t)b * H + j];
            if (t >= 0) {
              const size_t oi = ((size_t)t * B + b) * H + j;
              hn[e] = __bfloat162float(out[oi]);
              dy[e] = dout[oi];
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
          const bool valid = len[e] > t;
          const float dp = (valid ? dhv + dy[e] : 0.0f) * (1.0f - hn[e] * hn[e]);
          dpre[((size_t)t * B + b) * H + j] = dp;
          dp_out[hi] = __float2bfloat16(dp);
          part[hi] = valid ? 0.0f : dhv;
        }
      }
      __syncthreads();  // Cs lies over the ring of the next product
      PS_ACC(3);
    }
  }
}

// Host entry, persistent design, for `chains` = 1 or 2 chains that share T,
// B, H and lengths (the two directions of a bidirectional layer): every
// per-chain pointer has a second one, ignored when chains = 1. w_hh_c is w_hh
// (H, H) as it lies: its rows are the columns of w_hh^T. part_c holds zeros
// on entry and dh0 on exit. The plan (U, MG, stages, kc, bpd, smem bytes)
// comes from ops/persist_plan.py; the launch is refused with an error code if
// the device cannot hold the grid.
extern "C" int rnn_tanh_bwd_persist_launch(
    const void* out0, const void* out1, const void* dout0, const void* dout1,
    const void* lengths, const void* w_hh0, const void* w_hh1,
    void* part0, void* part1,   // (B, H) f32 each
    void* dp,                   // (2 buffers, chains, B, H) bf16
    void* dpre0, void* dpre1,   // (T, B, H) f32 each
    void* barrier,              // (chains,) uint32, zeroed
    int T, int B, int H, int reverse0, int reverse1, int chains, int U, int MG,
    int stages, int kc, int bpd, int smem, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((chains != 1 && chains != 2) || U % 8 != 0 || (MG != 1 && MG != 2) ||
      stages < 2 || stages > PS_MAX_STAGES || (kc != 32 && kc != 64 && kc != 128) ||
      (2 / MG * kc) % PS_BOX != 0 || bpd * U < H || (bpd - 1) * U >= H)
    return (int)cudaErrorInvalidValue;

  RnnTanhBwdPersistArgs p;
  const void* outs[2] = {out0, out1};
  const void* douts[2] = {dout0, dout1};
  const void* whh[2] = {w_hh0, w_hh1};
  void* parts[2] = {part0, part1};
  void* dpres[2] = {dpre0, dpre1};
  const int reverse[2] = {reverse0, reverse1};
  for (int c = 0; c < 2; ++c) {
    const int k = c < chains ? c : 0;
    p.out[c] = static_cast<const bf16*>(outs[k]);
    p.dout[c] = static_cast<const float*>(douts[k]);
    p.whh[c] = static_cast<const bf16*>(whh[k]);
    p.part[c] = static_cast<float*>(parts[k]);
    p.dpre[c] = static_cast<float*>(dpres[k]);
    p.reverse[c] = reverse[k] ? 1 : 0;
  }
  p.lengths = static_cast<const int*>(lengths);
  p.dp = static_cast<bf16*>(dp);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.chains = chains;
  p.T = T; p.B = B; p.H = H; p.U = U; p.MG = MG; p.stages = stages; p.kc = kc;
  p.bpd = bpd; p.Kr = (H + 63) / 64 * 64;
  p.ws_off = smem - U * p.Kr * 2;
  const int BR = MG * 64;
  if (p.ws_off < stages * BR * (2 / MG * kc) * 2 ||
      p.ws_off < 2 / MG * BR * (U + 1) * 4 || p.ws_off % 1024 != 0)
    return (int)cudaErrorInvalidValue;
  // dp: (2 buffers x chains, B, H)
  CUtensorMap dp_map = {};
  p.tma = ps_tma_ok(dp, H) ? 1 : 0;
  if (p.tma) {
    const int rc = ps_make_tmap(&dp_map, dp, H, B, 2 * chains, BR);
    if (rc != 0) return rc;
  }
  void* args[] = {&p, &dp_map};
  const int grid = chains * bpd;
  switch (U / 8) {
    case 1: return ps_coop_launch((const void*)rnn_tanh_bwd_persist_kernel<1>, grid, PS_BLOCK, smem, args, s);
    case 2: return ps_coop_launch((const void*)rnn_tanh_bwd_persist_kernel<2>, grid, PS_BLOCK, smem, args, s);
    case 3: return ps_coop_launch((const void*)rnn_tanh_bwd_persist_kernel<3>, grid, PS_BLOCK, smem, args, s);
    case 4: return ps_coop_launch((const void*)rnn_tanh_bwd_persist_kernel<4>, grid, PS_BLOCK, smem, args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
