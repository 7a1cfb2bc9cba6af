// Float32 variants of the two tanh-RNN kernels, for Hopper: what the port
// runs for compute_dtype="float32" serving and mixed_precision=False
// training of rnn_type="rnn" models (ops/rnn_tanh_cuda.py dispatches on the
// operands' dtype).
//
// Replaces, in float32, danspeech_tpu/ops/pallas_gru.py:
//   rnn_tanh_scan (B8)     -> rnn_tanh_f32_persist_launch (one cooperative
//       launch for every step of one chain or two, below), or the step design
//       rnn_tanh_f32_scan_launch, one chain or two (the chain is the grid's z
//       index); ops/persist_plan.py:plan_rnn_tanh_f32_forward chooses;
//   rnn_tanh_bwd_scan (B9) -> rnn_tanh_f32_bwd_persist_launch (one
//       cooperative launch for every step of one chain or two, below), or
//       the step design rnn_tanh_f32_bwd_launch, one chain or the two chains
//       of a bidirectional layer; ops/persist_plan.py:plan_rnn_tanh_f32_backward
//       chooses.
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
// - Forward, persistent (rnn_tanh_f32_persist_kernel, below; the ring and
//   the tiled product in f32_walk.cuh): one block an SM, each keeping the
//   columns of w_hh of its units in shared memory (the whole slice: 47 KB a
//   block for a pair at H = 800), h exchanged through L2, a grid barrier a
//   step instead of a launch.
// - Backward, persistent (rnn_tanh_f32_bwd_persist_kernel, below): the
//   forward walk's layout with the rows of w_hh as the slices (w_hh^T's
//   columns, read as they lie: 47 KB a block for a pair at H = 800, all
//   resident), dpre exchanged through L2, and the partial carry kept in
//   shared memory for the whole walk; tanh' comes off the stored output, so
//   unlike the GRU's and the LSTM's backward walks there is no recompute.
// - The step design of gru_f32.cu (f32_step.cuh): one launch per time step
//   from a host loop, the launch boundary as the barrier, a block of 256
//   threads owning 32 units for 64 batch rows, 4 rows x 2 units a thread in
//   registers, rereading its slice of w_hh from L2. At H = 800 that is 25
//   blocks of units a chain: the walk is bound by the launches, not by the
//   card's FP32 units.
// - Forward, step design (rnn_tanh_f32_step_kernel): h ping-pongs between
//   two buffers.
// - Backward (rnn_tanh_f32_bwd_step_kernel): T + 1 launches; each finishes
//   the previous step's carry dh = partial + dpre_prev @ w_hh^T[:, j] (the
//   previous step's row of the dpre output, which the launch before wrote
//   in full; w_hh's rows j read as they lie), applies step t's gradient and
//   leaves the partial carry (1 - m) dh in place (owned). The last launch
//   (t < 0) only finishes the carry: dh0.
// Measured by chip_smoke.py (phase 12): see PERF.md. The library's build
// hash covers every csrc/*.cuh (ops/cuda_build.py), so an edit of
// persist.cuh or f32_walk.cuh rebuilds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;  // persist.cuh's streams; nothing here is bf16

#include "f32_step.cuh"
#include "persist.cuh"
#include "f32_walk.cuh"

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
// The persistent forward walk (B8): all steps of one or two chains in one
// cooperative launch
// ---------------------------------------------------------------------------
//
// The plan (ops/persist_plan.py:plan_rnn_tanh_f32_forward) cuts the units of
// the chains into blocks of U (even) units, one block an SM, chain c's blocks
// c * blocks .. (c + 1) * blocks - 1. Block k of a chain owns units j0 = k U
// .. j0 + U - 1 and their U columns of w_hh, packed by the wrapper
// (gru_cuda.f32_slices, one gate) as wp[k][d][u] = w_hh[d][j0 + u]. h is
// exchanged transposed through hx (2 ping-pong buffers, chains, Dp depths,
// Bp rows; zeros on entry: h0 = 0) and read through the ring (f32_walk.cuh,
// G = 1: 8 rows x 2 units = 16 sums a thread); the block keeps no state. The
// epilogue takes (row, unit) pairs over all threads: the gate sum (splits in
// order), tanh(gx + sum) (gx with both biases inside), the length mask (rows
// past their length keep h and write zeros to out), out, and h through the
// tile Hn into hx in runs of rows. A grid barrier a chain (each chain its own
// counter) orders the steps. Only t < n = max(lengths) is walked (a reverse
// chain walks t = n - 1 .. 0, its state h0 = 0 until then); the later
// steps' zeros are written first, with no barrier.
//
// Shared memory, from its start: the work area (the ring, and over it the
// partial sums [split][row][unit] and the tile Hn[unit][row]), the resident
// depths of the slice.

struct FtWalk {
  const float* gx[2];   // (T, B, H), b_ih + b_hh inside
  const float* wp[2];   // (blocks, Dp, U), packed
  float* out[2];        // (T, B, H)
  float* hlast[2];      // (B, H)
  int reverse[2];
  const int* lengths;   // (B,)
  float* hx;            // (2, chains, Dp, Bp)
  unsigned int* barrier;  // (chains,): a zeroed counter a chain
  int T, B, H, chains, blocks;
  FpCut q;              // Dp: H padded to the chunk depth
};

// floats of the work area: the ring, or the partial sums and the new state's
// tile Hn (U x RB) over it
__host__ __device__ __forceinline__ int ft_work(const FpCut& q) {
  return fp_work_floats(q, q.U, q.RB, q.U * q.RB);
}

__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
rnn_tanh_f32_persist_kernel(FtWalk p) {
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const FpCut& fc = p.q;
  const int j0 = (blockIdx.x - c * p.blocks) * fc.U;
  const int U = fc.U, H = p.H, B = p.B, T = p.T, RB = fc.RB, Bp = fc.Bp;
  const int uw = min(U, H - j0);
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Hn = fp_smem + fc.KS * RB * U;
  float* Ws = fp_smem + ft_work(fc);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * fc.Dp * U;

  if (tid == 0) {
    for (int i = 0; i < FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  fp_load_resident(Ws, wp, fc.kres * U);  // the resident depths of the slice, once

  const int n = ps_longest(p.lengths, B, T);  // its __syncthreads covers both
  float* __restrict__ out = p.out[c];
  {  // steps n .. T - 1: zeros at this block's units
    const size_t cnt = (size_t)(T - n) * B * uw;
    for (size_t i = tid; i < cnt; i += nthr) {
      const size_t row = i / uw;
      out[((size_t)n * B + row) * H + j0 + (i - row * uw)] = 0.0f;
    }
  }
  const float* __restrict__ gx = p.gx[c];
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
      for (int i = tid; i < RB; i += nthr) {
        const int b = r0 + i;
        if (b < B) ps_prefetch_l2(gx + ((size_t)t * B + b) * H + j0);
      }
      fp_tiled_product<1>(fc, hsrc, wp, Ws, ring, r0, ps_t_);
      // epilogue: (row, unit) pairs, units fastest (gx and out in runs); the
      // loads of FP_EPI pairs first, then their tanh
      for (int e0 = tid; e0 < nel; e0 += FP_EPI * nthr) {
        float x[FP_EPI], hp[FP_EPI];
        bool live[FP_EPI], valid[FP_EPI];
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          const int r = e / U, u = e - r * U;
          const int b = r0 + r, j = j0 + u;
          live[k] = e < nel && b < B && j < H;
          valid[k] = false;
          x[k] = hp[k] = 0.0f;
          if (live[k]) {
            x[k] = gx[((size_t)t * B + b) * H + j];
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
            float acc = 0.0f;  // the splits in order
            for (int ks = 0; ks < fc.KS; ++ks) acc += ring.base[((size_t)ks * RB + r) * U + u];
            const float hnew = tanhf(x[k] + acc);
            hn = valid[k] ? hnew : hp[k];
            out[((size_t)t * B + b) * H + j] = valid[k] ? hnew : 0.0f;
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
  // h_last: this block's units of the last buffer written (h0 = 0 when n = 0)
  const float* hfin = p.hx + ((size_t)(n & 1) * p.chains + c) * hbuf;
  for (int i = tid; i < B * uw; i += nthr) {
    const int b = i / uw, u = i - b * uw;
    p.hlast[c][(size_t)b * H + j0 + u] = __ldcg(hfin + (size_t)(j0 + u) * Bp + b);
  }
}

// ---------------------------------------------------------------------------
// Host entry, B8, persistent: one or two chains (a, b) over precomputed
// projections, sharing T, B, H and lengths, in one cooperative launch of the
// planned grid on the caller's stream. wp_* are the packed slices (blocks,
// Dp, U); hx holds 2 zeroed buffers of (chains, Dp, Bp) f32 (h0 = 0);
// h_last (B, H) of each chain on exit. barrier: one zeroed counter a chain.
// Returns the CUDA error code (cudaErrorCooperativeLaunchTooLarge where the
// grid cannot be co-resident), else 0.
// ---------------------------------------------------------------------------

extern "C" int rnn_tanh_f32_persist_launch(
    const void* gx_a, const void* gx_b, const void* lengths, const void* wp_a,
    const void* wp_b, void* hx, void* h_last_a, void* h_last_b, void* out_a, void* out_b,
    void* barrier, int T, int B, int H, int reverse_a, int reverse_b, int chains, int units,
    int blocks, int rows_per_pass, int padded_rows, int padded_depth, int k_splits,
    int chunk_depth, int resident_depth, int threads, int smem, int dot, void* stream) {
  FtWalk p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.wp[0] = static_cast<const float*>(wp_a);
  p.wp[1] = static_cast<const float*>(wp_b);
  p.out[0] = static_cast<float*>(out_a);
  p.out[1] = static_cast<float*>(out_b);
  p.hlast[0] = static_cast<float*>(h_last_a);
  p.hlast[1] = static_cast<float*>(h_last_b);
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
  const long long need = 4LL * (ft_work(q) + (long long)q.kres * q.U);
  if (smem < need) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return ps_coop_launch((const void*)rnn_tanh_f32_persist_kernel, blocks * chains, threads,
                        (size_t)smem, args, reinterpret_cast<cudaStream_t>(stream));
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

// ---------------------------------------------------------------------------
// The persistent backward walk (B9): all steps of one or two chains in one
// cooperative launch
// ---------------------------------------------------------------------------
//
// The plan (ops/persist_plan.py:plan_rnn_tanh_f32_backward) cuts the units
// of the chains into blocks of U (even) units, one block an SM, chain c's
// blocks c * blocks .. (c + 1) * blocks - 1. Block k of a chain owns units
// j0 = k U .. j0 + U - 1 and their U rows of w_hh, the columns of w_hh^T,
// packed by the wrapper (gru_cuda.f32_rows) as wp[k][d][u] = w_hh[j0 + u][d]
// over a depth of H. Step s walks t (n - 1 - s for a reverse chain, s
// otherwise; n = max(lengths)): the carry dh = P + dpre_prev @ w_hh^T (the
// tiled product, f32_walk.cuh, G = 1, of the previous step's dpre exchanged
// transposed through dx), then dpre_t = m (dh + dout_t) (1 - out_t^2) into
// the output and, through the tile Dn, into dx for the next step, and the
// partial carry P = (1 - m) dh, kept in shared memory for the whole walk
// from P = 0. A row past its length gets dpre = 0, so its product is an
// exact zero and P + 0 carries dh unchanged, bit for bit, as the plain walk
// does. A last pass (s = n) only finishes the carry: dh0. The steps t >= n
// are past every row's length: their dpre is written as zeros first, with
// no barrier, and they leave the carry as it is. A grid barrier a chain
// (each chain its own counter) orders the steps.
//
// Shared memory, from its start: the work area (the ring, and over it the
// partial sums [split][row][unit] and the tile Dn[unit][row]), P[unit][row],
// the resident depths of the slice.

struct FtbWalk {
  const float* out[2];    // (T, B, H): the forward chain's output
  const float* dout[2];   // (T, B, H)
  const float* wp[2];     // (blocks, Dp, U), packed rows of w_hh
  float* dpre[2];         // (T, B, H)
  float* dh[2];           // (B, H): dh0 on exit
  int reverse[2];
  const int* lengths;     // (B,)
  float* dx;              // (2, chains, Dp, Bp): dpre exchanged, zeros on entry
  unsigned int* barrier;  // (chains,): a zeroed counter a chain
  int T, B, H, chains, blocks;
  FpCut q;                // Dp: H padded to the chunk depth
};

// floats of the work area: the ring, or the partial sums and the tile Dn
// (U x RB) of the new dpre over it
__host__ __device__ __forceinline__ int ftb_work(const FpCut& q) {
  return fp_work_floats(q, q.U, q.RB, q.U * q.RB);
}

__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
rnn_tanh_f32_bwd_persist_kernel(FtbWalk p) {
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const FpCut& fc = p.q;
  const int j0 = (blockIdx.x - c * p.blocks) * fc.U;
  const int U = fc.U, H = p.H, B = p.B, T = p.T, RB = fc.RB, Bp = fc.Bp;
  const int uw = min(U, H - j0);
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Dn = fp_smem + fc.KS * RB * U;
  float* P = fp_smem + ftb_work(fc);
  float* Ws = P + fp_up4(U * Bp);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * fc.Dp * U;

  if (tid == 0) {
    for (int i = 0; i < FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  fp_load_resident(Ws, wp, fc.kres * U);  // the resident depths of the slice, once
  for (int i = tid; i < U * Bp; i += nthr) P[i] = 0.0f;  // dL/dh starts at zero

  const int n = ps_longest(p.lengths, B, T);  // its __syncthreads covers all three
  float* __restrict__ dpre = p.dpre[c];
  {  // steps n .. T - 1: zeros at this block's units
    const size_t cnt = (size_t)(T - n) * B * uw;
    for (size_t i = tid; i < cnt; i += nthr) {
      const size_t row = i / uw;
      dpre[((size_t)n * B + row) * H + j0 + (i - row * uw)] = 0.0f;
    }
  }
  const float* __restrict__ out = p.out[c];
  const float* __restrict__ dout = p.dout[c];
  float* __restrict__ dh = p.dh[c];
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
    const float* dsrc = p.dx + ((size_t)(s & 1) * p.chains + c) * dbuf;
    float* ddst = p.dx + ((size_t)((s & 1) ^ 1) * p.chains + c) * dbuf;
    for (int pass = 0; pass < passes; ++pass) {
      const int r0 = pass * RB;
      if (!last) {  // the pass's rows of out and dout at this block's units, toward L2
        for (int i = tid; i < 2 * RB; i += nthr) {
          const int b = r0 + i / 2;
          if (b < B) ps_prefetch_l2((i & 1 ? dout : out) + ((size_t)t * B + b) * H + j0);
        }
      }
      if (s > 0) fp_tiled_product<1>(fc, dsrc, wp, Ws, ring, r0, ps_t_);
      // epilogue: (row, unit) pairs, units fastest (out, dout and dpre in
      // runs); the loads of FP_EPI pairs first, then their gradients
      for (int e0 = tid; e0 < nel; e0 += FP_EPI * nthr) {
        float o[FP_EPI], dy[FP_EPI];
        bool live[FP_EPI], valid[FP_EPI];
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          const int r = e / U, u = e - r * U;
          const int b = r0 + r, j = j0 + u;
          live[k] = e < nel && b < B && j < H;
          valid[k] = false;
          o[k] = dy[k] = 0.0f;
          if (live[k] && !last) {
            const size_t at = ((size_t)t * B + b) * H + j;
            o[k] = out[at];
            dy[k] = dout[at];
            valid[k] = p.lengths[b] > t;
          }
        }
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          if (e >= nel) break;
          const int r = e / U, u = e - r * U;
          float dp = 0.0f;  // padding rows stay zero
          if (live[k]) {
            const int b = r0 + r, j = j0 + u;
            float acc = 0.0f;  // the splits in order
            if (s > 0)
              for (int ks = 0; ks < fc.KS; ++ks) acc += ring.base[((size_t)ks * RB + r) * U + u];
            const float dhv = P[u * Bp + b] + acc;
            if (last) {
              dh[(size_t)b * H + j] = dhv;
              continue;
            }
            dp = valid[k] ? (dhv + dy[k]) * (1.0f - o[k] * o[k]) : 0.0f;
            dpre[((size_t)t * B + b) * H + j] = dp;
            P[u * Bp + b] = valid[k] ? 0.0f : dhv;
          }
          Dn[u * RB + r] = dp;
        }
      }
      __syncthreads();
      if (!last) {
        for (int e = tid; e < uw * RB; e += nthr) {  // rows fastest: runs of dx
          const int u = e / RB, r = e - u * RB;
          ddst[(size_t)(j0 + u) * Bp + r0 + r] = Dn[u * RB + r];
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
// Host entry, B9, persistent: the backward walks of one or two chains (a, b)
// that share T, B, H and lengths, in one cooperative launch of the planned
// grid on the caller's stream. wp_* are the packed rows (blocks, Dp, U); dx
// holds 2 zeroed buffers of (chains, Dp, Bp) f32; dh_* (B, H) get dh0 (the
// carry starts at zero: the layer returns no final state); barrier: one
// zeroed counter a chain. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident),
// else 0.
// ---------------------------------------------------------------------------

extern "C" int rnn_tanh_f32_bwd_persist_launch(
    const void* out_a, const void* out_b, const void* dout_a, const void* dout_b,
    const void* lengths, const void* wp_a, const void* wp_b, void* dx, void* dh_a,
    void* dh_b, void* dpre_a, void* dpre_b, void* barrier, int T, int B, int H,
    int reverse_a, int reverse_b, int chains, int units, int blocks, int rows_per_pass,
    int padded_rows, int padded_depth, int k_splits, int chunk_depth, int resident_depth,
    int threads, int smem, int dot, void* stream) {
  FtbWalk p;
  p.out[0] = static_cast<const float*>(out_a);
  p.out[1] = static_cast<const float*>(out_b);
  p.dout[0] = static_cast<const float*>(dout_a);
  p.dout[1] = static_cast<const float*>(dout_b);
  p.wp[0] = static_cast<const float*>(wp_a);
  p.wp[1] = static_cast<const float*>(wp_b);
  p.dpre[0] = static_cast<float*>(dpre_a);
  p.dpre[1] = static_cast<float*>(dpre_b);
  p.dh[0] = static_cast<float*>(dh_a);
  p.dh[1] = static_cast<float*>(dh_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  p.lengths = static_cast<const int*>(lengths);
  p.dx = static_cast<float*>(dx);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.T = T; p.B = B; p.H = H; p.chains = chains; p.blocks = blocks;
  p.q = FpCut{units, rows_per_pass, padded_rows, padded_depth, k_splits, chunk_depth,
              resident_depth};
  // the plan's ints, checked before any launch
  const FpCut& q = p.q;
  const bool ok = chains >= 1 && chains <= 2 && T >= 1 && B >= 1 && H >= 1 && !dot &&
                  fp_cut_ok(q, H, blocks, threads) && fp_tiled_ok(q, threads) &&
                  q.Dp >= H && q.Bp >= B;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long need = 4LL * (ftb_work(q) + (long long)fp_up4(q.U * q.Bp) +
                                (long long)q.kres * q.U);
  if (smem < need) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return ps_coop_launch((const void*)rnn_tanh_f32_bwd_persist_kernel, blocks * chains,
                        threads, (size_t)smem, args, reinterpret_cast<cudaStream_t>(stream));
}
