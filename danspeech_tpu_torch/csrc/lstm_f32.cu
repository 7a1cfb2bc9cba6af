// Float32 variants of the three LSTM kernels, for Hopper: what the port runs
// for compute_dtype="float32" serving and mixed_precision=False training of
// rnn_type="lstm" models (ops/lstm_cuda.py dispatches on the operands'
// dtype).
//
// Replaces, in float32, danspeech_tpu/ops/pallas_gru.py:
//   lstm_scan (B5) and lstm_scan_with_cell (B6) -> lstm_f32_persist_launch
//       (one cooperative launch, below), or the step design
//       lstm_f32_scan_launch, one chain or two (the chain is the grid's z
//       index), the cell stream written only when its pointer is set;
//   lstm_bwd_scan (B7)                         -> lstm_f32_bwd_persist_launch
//       (the gate recompute, then one cooperative launch, below), or the step
//       design lstm_f32_bwd_launch, one chain or the two chains of a
//       bidirectional layer.
// ops/persist_plan.py:plan_lstm_f32_forward and plan_lstm_f32_backward
// choose the walks' design and cut them over the card.
// The Pallas kernels are dtype-generic: float32 weights give float32
// products there. Same contract as the bf16 kernels (lstm_scan.cu,
// lstm_bwd.cu), gate order i, f, g, o, every stream and weight in float32:
//   gx (T, B, 4H), the bias-free projection x @ w_ih; the kernel adds
//   b_hh, the per-step bias, which ops/rnn.py hands as b_ih + b_hh;
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
// - A fully resident slice does not quite fit: f32 w_hh is 10.24 MB a chain
//   at H = 800, and a pair's 20.5 MB over 116 blocks is 182 KB a block
//   (depth 832 x 14 units x 4 gates) beside a ring of 44 KB (92 KB at B =
//   128) and partial sums of 58 KB. The persistent forward walk (below; the
//   ring and the tiled product in f32_walk.cuh) keeps 85% of each block's
//   slice resident at B = 32 and 69% at B = 128 and streams the rest from L2
//   each step; h is exchanged through L2, c stays in the block.
// - The step design is that of gru_f32.cu: one launch per time step from a
//   host loop, the launch boundary as the barrier between steps, each block
//   rereading its slice of w_hh from L2 (f32_step.cuh). Forward step
//   (lstm_f32_step_kernel): a block owns 32 units (the columns j, H+j, 2H+j,
//   3H+j of w_hh) for 64 batch rows; each of its 256 threads holds 4 rows x 2
//   units x 4 gates in registers (f32_fwd_product<4>), and the gates, the c
//   and h updates, the mask and the writes happen in the registers that
//   hold the sums. c is owned: the thread that owns (b, j) updates it in
//   place; h ping-pongs between two buffers, since every block reads all of
//   the previous step's h.
// - Backward: the gate recompute hprev @ w_hh for every t does not depend on
//   the walk, so it is one FFMA GEMM for both chains (sgemm.cuh) into the dg4
//   output buffer; each (t, b, j) of it is read back as gh and overwritten
//   with the gate gradient by the one thread that owns it. The persistent
//   walk (lstm_f32_bwd_persist_kernel, below) then takes every step in one
//   launch, each block keeping the rows of w_hh of its units (depth 4H, the
//   whole slice resident at B = 32: 179 KB a block for a pair) and its
//   carries dh and dc in shared memory, dg4 exchanged through L2 as the
//   forward walk's h. The step design (lstm_f32_bwd_step_kernel) instead
//   takes T + 1 step launches: each finishes the carry of the
//   previous step, dh = partial + dg4_prev @ w_hh^T[:, j] (depth 4H, read
//   from the previous step's row of dg4, which the launch before wrote in
//   full), applies step t's gradient, and leaves the partial carry
//   (1 - m) dh and dc in place (both owned). The last launch (t < 0) only
//   finishes the carry: dh0; dc0 is the dc after step 0.
// Measured by chip_smoke.py (phase 12): see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;  // persist.cuh's streams; nothing here is bf16

#include "f32_step.cuh"
#include "persist.cuh"
#include "f32_walk.cuh"
#include "sgemm.cuh"

// ---------------------------------------------------------------------------
// Forward step (B5, B6): one time step of one or two chains
// ---------------------------------------------------------------------------

struct LstmF32Chains {
  const float* gx[2];   // (T, B, 4H), bias-free
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
// The persistent forward walk (B5, B6): all steps of one or two chains in one
// cooperative launch
// ---------------------------------------------------------------------------
//
// The plan (ops/persist_plan.py:plan_lstm_f32_forward) cuts the units of the
// chains into blocks of U (even) units, one block an SM, chain c's blocks
// c * blocks .. (c + 1) * blocks - 1. Block k of a chain owns units j0 = k U
// .. j0 + U - 1 and their 4U columns of w_hh (j, H + j, 2H + j, 3H + j: i, f,
// g, o), packed by the wrapper (gru_cuda.f32_slices) as wp[k][d][g U + u] =
// w_hh[d][g H + j0 + u]. h is exchanged transposed through hx (2 ping-pong
// buffers, chains, Dp depths, Bp rows) and read through the ring
// (f32_walk.cuh, G = 4: 8 rows x 2 units x 4 gates = 64 sums a thread); c
// never leaves the block: the block's units of it, for every row, stay in
// shared memory (Cs) for the whole walk, loaded from c0 and written to c_last
// at the end. The epilogue takes (row, unit) pairs over all threads: the four
// gate sums (splits in order), gx + b_hh (b_ih + b_hh), the gates, c and h,
// the length mask (rows past their length keep h and c and write zeros to
// out and c_seq), out, c_seq where it is set, and h through the tile Hn into
// hx in runs of rows. A grid barrier a chain (each chain its own counter)
// orders the steps. Only t < n = max(lengths) is walked (a reverse chain
// walks t = n - 1 .. 0, its states h0, c0 until then); the later steps' zeros
// are written first, with no barrier.
//
// Shared memory, from its start: the work area (the ring, and over it the
// partial sums [split][row][col] and the tile Hn[unit][row]), the cell
// state Cs[unit][Bp], the resident depths of the slice. ptxas (sm_90a): 167
// registers (64 sums a thread), no spill.

struct FlWalk {
  const float* gx[2];   // (T, B, 4H), bias-free
  const float* wp[2];   // (blocks, Dp, 4U), packed
  const float* bhh[2];  // (4H,)
  float* out[2];        // (T, B, H)
  float* cseq[2];       // (T, B, H), or null: no cell stream
  float* hlast[2];      // (B, H)
  float* cst[2];        // (B, H): c0 in, c_last out
  int reverse[2];
  const int* lengths;   // (B,)
  float* hx;            // (2, chains, Dp, Bp)
  unsigned int* barrier;  // (chains,): a zeroed counter a chain
  int T, B, H, chains, blocks;
  FpCut q;              // Dp: H padded to the chunk depth
};

// floats of the work area: the ring, or the partial sums and the new state's
// tile Hn (U x RB) over it
__host__ __device__ __forceinline__ int fl_work(const FpCut& q) {
  return fp_work_floats(q, 4 * q.U, q.RB, q.U * q.RB);
}

__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
lstm_f32_persist_kernel(FlWalk p) {
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const FpCut& fc = p.q;
  const int j0 = (blockIdx.x - c * p.blocks) * fc.U;
  const int U = fc.U, NC = 4 * U, H = p.H, B = p.B, T = p.T, RB = fc.RB, Bp = fc.Bp;
  const int uw = min(U, H - j0);
  const int G = 4 * H;
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Hn = fp_smem + fc.KS * RB * NC;
  float* Cs = fp_smem + fl_work(fc);
  float* Ws = Cs + fp_up4(U * Bp);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * fc.Dp * NC;

  if (tid == 0) {
    for (int i = 0; i < FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  fp_load_resident(Ws, wp, fc.kres * NC);  // the resident depths of the slice, once
  float* __restrict__ cst = p.cst[c];
  for (int i = tid; i < U * Bp; i += nthr) {  // c0 of this block's units
    const int u = i / Bp, b = i - u * Bp;
    Cs[i] = (u < uw && b < B) ? cst[(size_t)b * H + j0 + u] : 0.0f;
  }

  const int n = ps_longest(p.lengths, B, T);  // its __syncthreads covers both
  float* __restrict__ out = p.out[c];
  float* __restrict__ cseq = p.cseq[c];
  {  // steps n .. T - 1: zeros at this block's units
    const size_t cnt = (size_t)(T - n) * B * uw;
    for (size_t i = tid; i < cnt; i += nthr) {
      const size_t row = i / uw;
      const size_t at = ((size_t)n * B + row) * H + j0 + (i - row * uw);
      out[at] = 0.0f;
      if (cseq) cseq[at] = 0.0f;
    }
  }
  const float* __restrict__ gx = p.gx[c];
  const float* __restrict__ bhh = p.bhh[c];
  const size_t hbuf = (size_t)fc.Dp * Bp;
  const int passes = Bp / RB;
  const int nel = RB * U;
  long long ps_t_ = 0;
#ifdef PS_PROFILE
  ps_t_ = clock64();
#endif
  for (int s = 0; s < n; ++s) {
    const int t = p.reverse[c] ? n - 1 - s : s;
    const float* hsrc = p.hx + ((size_t)(s & 1) * p.chains + c) * hbuf;
    float* hdst = p.hx + ((size_t)((s & 1) ^ 1) * p.chains + c) * hbuf;
    for (int pass = 0; pass < passes; ++pass) {
      const int r0 = pass * RB;
      // the pass's gx rows at this block's units, toward L2 for the epilogue
      for (int i = tid; i < RB * 4; i += nthr) {
        const int b = r0 + i / 4;
        if (b < B) ps_prefetch_l2(gx + ((size_t)t * B + b) * G + (i % 4) * H + j0);
      }
      fp_tiled_product<4>(fc, hsrc, wp, Ws, ring, r0, ps_t_);
      // epilogue: (row, unit) pairs, units fastest (gx and out in runs); the
      // loads of FP_EPI pairs first, then their gates
      for (int e0 = tid; e0 < nel; e0 += FP_EPI * nthr) {
        float xi[FP_EPI], xf[FP_EPI], xg[FP_EPI], xo[FP_EPI], hp[FP_EPI];
        bool live[FP_EPI], valid[FP_EPI];
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          const int r = e / U, u = e - r * U;
          const int b = r0 + r, j = j0 + u;
          live[k] = e < nel && b < B && j < H;
          valid[k] = false;
          xi[k] = xf[k] = xg[k] = xo[k] = hp[k] = 0.0f;
          if (live[k]) {
            const float* gxr = gx + ((size_t)t * B + b) * G;
            xi[k] = gxr[j];
            xf[k] = gxr[H + j];
            xg[k] = gxr[2 * H + j];
            xo[k] = gxr[3 * H + j];
            hp[k] = __ldcg(hsrc + (size_t)j * Bp + b);
            valid[k] = p.lengths[b] > t;
          }
        }
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          if (e >= nel) break;
          const int r = e / U, u = e - r * U;
          float hn = 0.0f;  // padding rows stay zero
          if (live[k]) {
            const int b = r0 + r, j = j0 + u;
            float si = 0.0f, sf = 0.0f, sg = 0.0f, so = 0.0f;  // the splits in order
            for (int ks = 0; ks < fc.KS; ++ks) {
              const float* cs = ring.base + ((size_t)ks * RB + r) * NC + u;
              si += cs[0];
              sf += cs[U];
              sg += cs[2 * U];
              so += cs[3 * U];
            }
            const float ig = f32_sigmoid(xi[k] + si + bhh[j]);
            const float fg = f32_sigmoid(xf[k] + sf + bhh[H + j]);
            const float gg = tanhf(xg[k] + sg + bhh[2 * H + j]);
            const float og = f32_sigmoid(xo[k] + so + bhh[3 * H + j]);
            float* cp = Cs + u * Bp + b;
            const float cn = fg * *cp + ig * gg;
            const float hnew = og * tanhf(cn);
            const size_t at = ((size_t)t * B + b) * H + j;
            hn = valid[k] ? hnew : hp[k];
            if (valid[k]) *cp = cn;
            out[at] = valid[k] ? hnew : 0.0f;
            if (cseq) cseq[at] = valid[k] ? cn : 0.0f;
          }
          Hn[u * RB + r] = hn;
        }
      }
      __syncthreads();
      for (int e = tid; e < uw * RB; e += nthr) {  // rows fastest: runs of hx
        const int u = e / RB, r = e - u * RB;
        hdst[(size_t)(j0 + u) * Bp + r0 + r] = Hn[u * RB + r];
      }
      __syncthreads();  // Hn is read before the next pass's ring
      PS_ACC(3);
    }
    ps_grid_barrier(p.barrier + c, (unsigned int)(s + 1) * p.blocks);
    PS_ACC(1);
  }
  // h_last: this block's units of the last buffer written (h0 when n = 0);
  // c_last from Cs
  const float* hfin = p.hx + ((size_t)(n & 1) * p.chains + c) * hbuf;
  for (int i = tid; i < B * uw; i += nthr) {
    const int b = i / uw, u = i - b * uw;
    p.hlast[c][(size_t)b * H + j0 + u] = __ldcg(hfin + (size_t)(j0 + u) * Bp + b);
    cst[(size_t)b * H + j0 + u] = Cs[u * Bp + b];
  }
}

// ---------------------------------------------------------------------------
// Host entry, B5 / B6, persistent: one or two chains (a, b) over precomputed
// projections, sharing T, B, H and lengths, in one cooperative launch of the
// planned grid on the caller's stream. wp_* are the packed slices (blocks,
// Dp, 4U); hx holds 2 buffers of (chains, Dp, Bp) f32, buffer 0 h0 of each
// chain transposed (h0[b][j] at [j][b]) and zeros elsewhere; c_* (B, H) hold
// c0 on entry and c_last on exit; h_last (B, H) of each chain on exit;
// cseq_a / cseq_b are null for B5. barrier: one zeroed counter a chain.
// Returns the CUDA error code (cudaErrorCooperativeLaunchTooLarge where the
// grid cannot be co-resident), else 0.
// ---------------------------------------------------------------------------

extern "C" int lstm_f32_persist_launch(
    const void* gx_a, const void* gx_b, const void* lengths, const void* wp_a,
    const void* wp_b, const void* b_hh_a, const void* b_hh_b, void* hx, void* c_a, void* c_b,
    void* h_last_a, void* h_last_b, void* out_a, void* out_b, void* cseq_a, void* cseq_b,
    void* barrier, int T, int B, int H, int reverse_a, int reverse_b, int chains, int units,
    int blocks, int rows_per_pass, int padded_rows, int padded_depth, int k_splits,
    int chunk_depth, int resident_depth, int threads, int smem, int dot, void* stream) {
  FlWalk p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.wp[0] = static_cast<const float*>(wp_a);
  p.wp[1] = static_cast<const float*>(wp_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.out[0] = static_cast<float*>(out_a);
  p.out[1] = static_cast<float*>(out_b);
  p.cseq[0] = static_cast<float*>(cseq_a);
  p.cseq[1] = static_cast<float*>(cseq_b);
  p.hlast[0] = static_cast<float*>(h_last_a);
  p.hlast[1] = static_cast<float*>(h_last_b);
  p.cst[0] = static_cast<float*>(c_a);
  p.cst[1] = static_cast<float*>(c_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  p.lengths = static_cast<const int*>(lengths);
  p.hx = static_cast<float*>(hx);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.T = T; p.B = B; p.H = H; p.chains = chains; p.blocks = blocks;
  p.q = FpCut{units, rows_per_pass, padded_rows, padded_depth, k_splits, chunk_depth,
              resident_depth};
  const FpCut& q = p.q;
  const bool ok = chains >= 1 && chains <= 2 && T >= 1 && B >= 1 && H >= 1 && !dot &&
                  fp_cut_ok(q, H, blocks, threads) && fp_tiled_ok(q, threads) &&
                  q.Dp >= H && q.Bp >= B;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long need =
      4LL * (fl_work(q) + fp_up4(q.U * q.Bp) + (long long)q.kres * 4 * q.U);
  if (smem < need) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return ps_coop_launch((const void*)lstm_f32_persist_kernel, blocks * chains, threads,
                        (size_t)smem, args, reinterpret_cast<cudaStream_t>(stream));
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

// ---------------------------------------------------------------------------
// The persistent backward walk (B7): all steps of one or two chains in one
// cooperative launch
// ---------------------------------------------------------------------------
//
// The plan (ops/persist_plan.py:plan_lstm_f32_backward) cuts the units of the
// chains into blocks of U (even) units, one block an SM, chain c's blocks
// c * blocks .. (c + 1) * blocks - 1, as the forward walk's. Block k of a
// chain owns units j0 = k U .. j0 + U - 1 and rows j of w_hh (H, 4H), read as
// they lie (w_hh^T[:, j] = w_hh[j, :]): one column a unit over a depth of
// 4H, packed by the wrapper (gru_cuda.f32_rows) as wp[k][d][u] =
// w_hh[j0 + u][d], zeros past H and past 4H.
//
// Step s multiplies dg4 of the step before (B, 4H), exchanged transposed
// through dg (2 ping-pong buffers, chains, Dp depths, Bp rows; every block
// reads all of it, through the ring: f32_walk.cuh, G = 1), by its slice: the
// carry of its units, dh = partial + dg4_prev @ w_hh^T[:, j]. The epilogue
// takes (row, unit) pairs over all threads with the step kernel's arithmetic
// (lstm_f32_bwd_step_kernel): it finishes dh, recomputes i, f, g, o from gx
// + b_hh (b_ih + b_hh) and the gh the recompute left in dg4, applies step t's
// gradient, writes the four gate gradients over gh in dg4, keeps the partial
// carry (1 - m) dh and the cell gradient dc in shared memory (P and DC, the
// block's units for every row: no state leaves the block), and writes its
// units' four depths (j, H + j, 2H + j, 3H + j) of the new dg4 into dg through
// the tile Dn, in runs of rows. A grid barrier a chain (each chain its own
// counter) orders the steps. Only the steps with a valid row are walked,
// t = n - 1 .. 0 for a reverse walk (the backward of a forward chain), 0 ..
// n - 1 otherwise, n = max(lengths): at t >= n every row is past its length,
// the gradients are zeros (written first, with no barrier) and both carries
// pass through unchanged. Step 0 multiplies nothing (dg4 before it is zero).
// One more pass (s = n) only finishes the carry: that is dh0; dc0 is DC.
//
// Shared memory, from its start: the work area (the ring, and over it the
// partial sums Cs[split][row][unit] and the tile Dn[gate][unit][row]), the
// partial carry P[unit][Bp], the cell gradient DC[unit][Bp], the resident
// depths of the slice.

struct FlbWalk {
  const float* gx[2];     // (T, B, 4H), bias-free
  const float* cprev[2];  // (T, B, H)
  const float* dout[2];   // (T, B, H)
  const float* wp[2];     // (blocks, Dp, U), packed rows of w_hh
  const float* bhh[2];    // (4H,)
  float* dg4[2];          // (T, B, 4H): gh in, the gate gradients out
  float* dh[2];           // (B, H): the carry to start from in, dh0 out
  float* dc[2];           // (B, H): the cell gradient to start from in, dc0 out
  int reverse[2];
  const int* lengths;     // (B,)
  float* dg;              // (2, chains, Dp, Bp): dg4 exchanged, zeros on entry
  unsigned int* barrier;  // (chains,): a zeroed counter a chain
  int T, B, H, chains, blocks;
  FpCut q;                // Dp: 4H padded to the chunk depth
};

// floats of the work area: the ring, or the partial sums and the tile Dn
// (4 x U x RB) of the new dg4 over it
__host__ __device__ __forceinline__ int flb_work(const FpCut& q) {
  return fp_work_floats(q, q.U, q.RB, 4 * q.U * q.RB);
}

__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
lstm_f32_bwd_persist_kernel(FlbWalk p) {
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const FpCut& fc = p.q;
  const int j0 = (blockIdx.x - c * p.blocks) * fc.U;
  const int U = fc.U, H = p.H, B = p.B, T = p.T, RB = fc.RB, Bp = fc.Bp;
  const int uw = min(U, H - j0);
  const int G = 4 * H;
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Dn = fp_smem + fc.KS * RB * U;
  float* P = fp_smem + flb_work(fc);
  float* DC = P + fp_up4(U * Bp);
  float* Ws = DC + fp_up4(U * Bp);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * fc.Dp * U;

  if (tid == 0) {
    for (int i = 0; i < FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  fp_load_resident(Ws, wp, fc.kres * U);  // the resident depths of the slice, once
  float* __restrict__ dh = p.dh[c];
  float* __restrict__ dc = p.dc[c];
  for (int i = tid; i < U * Bp; i += nthr) {  // the carries start at dh, dc
    const int u = i / Bp, b = i - u * Bp;
    const bool in = u < uw && b < B;
    P[i] = in ? dh[(size_t)b * H + j0 + u] : 0.0f;
    DC[i] = in ? dc[(size_t)b * H + j0 + u] : 0.0f;
  }

  const int n = ps_longest(p.lengths, B, T);  // its __syncthreads covers both
  float* __restrict__ dg4 = p.dg4[c];
  {  // steps n .. T - 1: zeros at this block's units, four gates
    const size_t cnt = (size_t)(T - n) * B * uw;
    for (size_t i = tid; i < cnt; i += nthr) {
      const size_t row = (size_t)n * B + i / uw;
      const int j = j0 + (int)(i % uw);
      dg4[row * G + j] = 0.0f;
      dg4[row * G + H + j] = 0.0f;
      dg4[row * G + 2 * H + j] = 0.0f;
      dg4[row * G + 3 * H + j] = 0.0f;
    }
  }
  const float* __restrict__ gx = p.gx[c];
  const float* __restrict__ cprev = p.cprev[c];
  const float* __restrict__ dout = p.dout[c];
  const float* __restrict__ bhh = p.bhh[c];
  const size_t dbuf = (size_t)fc.Dp * Bp;
  const int passes = Bp / RB;
  const int nel = RB * U;
  long long ps_t_ = 0;
#ifdef PS_PROFILE
  ps_t_ = clock64();
#endif
  for (int s = 0; s <= n; ++s) {
    const bool last = s == n;  // after the last step: only the carry, dh0
    const int t = last ? -1 : (p.reverse[c] ? n - 1 - s : s);
    const float* dsrc = p.dg + ((size_t)(s & 1) * p.chains + c) * dbuf;
    float* ddst = p.dg + ((size_t)((s & 1) ^ 1) * p.chains + c) * dbuf;
    for (int pass = 0; pass < passes; ++pass) {
      const int r0 = pass * RB;
      if (!last) {  // the pass's rows of gx and gh at this block's units, toward L2
        for (int i = tid; i < RB * 8; i += nthr) {
          const int b = r0 + i / 8, g = i % 8;
          const float* base = g < 4 ? gx : dg4;
          if (b < B) ps_prefetch_l2(base + ((size_t)t * B + b) * G + (g % 4) * H + j0);
        }
      }
      if (s > 0) fp_tiled_product<1>(fc, dsrc, wp, Ws, ring, r0, ps_t_);
      // epilogue: (row, unit) pairs, units fastest; the loads of FP_EPI pairs
      // first, then their gradients
      for (int e0 = tid; e0 < nel; e0 += FP_EPI * nthr) {
        float xi[FP_EPI], xf[FP_EPI], xg[FP_EPI], xo[FP_EPI];
        float hi[FP_EPI], hf[FP_EPI], hg[FP_EPI], ho[FP_EPI], cp[FP_EPI], dy[FP_EPI];
        bool live[FP_EPI], valid[FP_EPI];
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          const int r = e / U, u = e - r * U;
          const int b = r0 + r, j = j0 + u;
          live[k] = e < nel && b < B && j < H;
          valid[k] = false;
          xi[k] = xf[k] = xg[k] = xo[k] = hi[k] = hf[k] = hg[k] = ho[k] = cp[k] = dy[k] = 0.0f;
          if (live[k] && !last) {
            const size_t row = (size_t)t * B + b;
            const float* gxr = gx + row * G;
            const float* ghr = dg4 + row * G;
            xi[k] = gxr[j];
            xf[k] = gxr[H + j];
            xg[k] = gxr[2 * H + j];
            xo[k] = gxr[3 * H + j];
            hi[k] = ghr[j];
            hf[k] = ghr[H + j];
            hg[k] = ghr[2 * H + j];
            ho[k] = ghr[3 * H + j];
            cp[k] = cprev[row * H + j];
            dy[k] = dout[row * H + j];
            valid[k] = p.lengths[b] > t;
          }
        }
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          if (e >= nel) break;
          const int r = e / U, u = e - r * U;
          float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;  // padding rows stay zero
          if (live[k]) {
            const int b = r0 + r, j = j0 + u;
            float acc = 0.0f;  // the splits in order
            if (s > 0)
              for (int ks = 0; ks < fc.KS; ++ks) acc += ring.base[((size_t)ks * RB + r) * U + u];
            const float dhv = P[u * Bp + b] + acc;
            if (last) {
              dh[(size_t)b * H + j] = dhv;
              dc[(size_t)b * H + j] = DC[u * Bp + b];
              continue;
            }
            const float ig = f32_sigmoid(xi[k] + hi[k] + bhh[j]);
            const float fg = f32_sigmoid(xf[k] + hf[k] + bhh[H + j]);
            const float gg = tanhf(xg[k] + hg[k] + bhh[2 * H + j]);
            const float og = f32_sigmoid(xo[k] + ho[k] + bhh[3 * H + j]);
            const float tc = tanhf(fg * cp[k] + ig * gg);
            const float dcv = DC[u * Bp + b];

            const float dhnew = valid[k] ? dhv + dy[k] : 0.0f;
            const float dcn = dhnew * og * (1.0f - tc * tc) + (valid[k] ? dcv : 0.0f);
            d0 = dcn * gg * ig * (1.0f - ig);
            d1 = dcn * cp[k] * fg * (1.0f - fg);
            d2 = dcn * ig * (1.0f - gg * gg);
            d3 = dhnew * tc * og * (1.0f - og);
            float* g = dg4 + ((size_t)t * B + b) * G;
            g[j] = d0;
            g[H + j] = d1;
            g[2 * H + j] = d2;
            g[3 * H + j] = d3;
            P[u * Bp + b] = valid[k] ? 0.0f : dhv;
            DC[u * Bp + b] = valid[k] ? dcn * fg : dcv;
          }
          Dn[u * RB + r] = d0;
          Dn[(U + u) * RB + r] = d1;
          Dn[(2 * U + u) * RB + r] = d2;
          Dn[(3 * U + u) * RB + r] = d3;
        }
      }
      __syncthreads();
      if (!last) {
        for (int e = tid; e < 4 * uw * RB; e += nthr) {  // rows fastest: runs of dg
          const int gu = e / RB, r = e - gu * RB;
          const int g = gu / uw, u = gu - g * uw;
          ddst[(size_t)(g * H + j0 + u) * Bp + r0 + r] = Dn[(g * U + u) * RB + r];
        }
      }
      __syncthreads();  // Dn is read before the next pass's ring
      PS_ACC(3);
    }
    if (!last) ps_grid_barrier(p.barrier + c, (unsigned int)(s + 1) * p.blocks);
    PS_ACC(1);
  }
}

// ---------------------------------------------------------------------------
// Host entry, B7, persistent: the backward walks of one or two chains (a, b)
// that share T, B, H and lengths, on the caller's stream: the gate recompute
// gh = hprev @ w_hh of each chain into its dg4 buffer (sgemm.cuh, as the step
// design's), then every step in one cooperative launch of the planned grid.
// wp_* are the packed rows (blocks, Dp, U); dg holds 2 zeroed buffers of
// (chains, Dp, Bp) f32; dh_* and dc_* (B, H) hold the carries to start from
// on entry (zeros: the layer returns no final state) and dh0, dc0 on exit;
// barrier: one zeroed counter a chain. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident),
// else 0.
// ---------------------------------------------------------------------------

extern "C" int lstm_f32_bwd_persist_launch(
    const void* gx_a, const void* gx_b, const void* hprev_a, const void* hprev_b,
    const void* cprev_a, const void* cprev_b, const void* dout_a, const void* dout_b,
    const void* lengths, const void* w_hh_a, const void* w_hh_b, const void* wp_a,
    const void* wp_b, const void* b_hh_a, const void* b_hh_b, void* dg, void* dh_a,
    void* dh_b, void* dc_a, void* dc_b, void* dg4_a, void* dg4_b, void* barrier, int T,
    int B, int H, int reverse_a, int reverse_b, int chains, int units, int blocks,
    int rows_per_pass, int padded_rows, int padded_depth, int k_splits, int chunk_depth,
    int resident_depth, int threads, int smem, int dot, void* stream) {
  FlbWalk p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.cprev[0] = static_cast<const float*>(cprev_a);
  p.cprev[1] = static_cast<const float*>(cprev_b);
  p.dout[0] = static_cast<const float*>(dout_a);
  p.dout[1] = static_cast<const float*>(dout_b);
  p.wp[0] = static_cast<const float*>(wp_a);
  p.wp[1] = static_cast<const float*>(wp_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.dg4[0] = static_cast<float*>(dg4_a);
  p.dg4[1] = static_cast<float*>(dg4_b);
  p.dh[0] = static_cast<float*>(dh_a);
  p.dh[1] = static_cast<float*>(dh_b);
  p.dc[0] = static_cast<float*>(dc_a);
  p.dc[1] = static_cast<float*>(dc_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  p.lengths = static_cast<const int*>(lengths);
  p.dg = static_cast<float*>(dg);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.T = T; p.B = B; p.H = H; p.chains = chains; p.blocks = blocks;
  p.q = FpCut{units, rows_per_pass, padded_rows, padded_depth, k_splits, chunk_depth,
              resident_depth};
  // the plan's ints, checked before any launch
  const FpCut& q = p.q;
  const bool ok = chains >= 1 && chains <= 2 && T >= 1 && B >= 1 && H >= 1 && !dot &&
                  fp_cut_ok(q, H, blocks, threads) && fp_tiled_ok(q, threads) &&
                  q.Dp >= 4 * H && q.Bp >= B;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long need =
      4LL * (flb_work(q) + 2LL * fp_up4(q.U * q.Bp) + (long long)q.kres * q.U);
  if (smem < need) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // gh = hprev @ w_hh for every step of each chain, into its dg4 buffer
  int rc = sgemm_launch(static_cast<const float*>(hprev_a), static_cast<const float*>(hprev_b),
                        static_cast<const float*>(w_hh_a), static_cast<const float*>(w_hh_b),
                        p.dg4[0], p.dg4[1], T * B, 4 * H, H, chains, s);
  if (rc != 0) return rc;
  void* args[] = {&p};
  return ps_coop_launch((const void*)lstm_f32_bwd_persist_kernel, blocks * chains, threads,
                        (size_t)smem, args, s);
}
