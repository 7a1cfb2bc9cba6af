// Float32 variants of the four GRU kernels, for Hopper: what the port runs
// for compute_dtype="float32" serving and mixed_precision=False training
// (ops/gru_cuda.py dispatches on the operands' dtype).
//
// Replaces, in float32, danspeech_tpu/ops/pallas_gru.py:
//   gru_scan (B1) and gru_scan_bidi (B2)  -> gru_f32_persist_launch (one
//       cooperative launch, below), or the step design gru_f32_scan_launch,
//       one chain or two (the chain is the grid's z index);
//   gru_scan_bidi_fused (B3)              -> gru_f32_bidi_fused_persist_launch,
//       or the step design gru_f32_bidi_fused_launch;
//   gru_bwd_scan (B4)                     -> gru_f32_bwd_persist_launch (one
//       cooperative launch after the gate recompute, below), or the step
//       design gru_f32_bwd_launch, one chain or the two chains of a
//       bidirectional layer.
// ops/persist_plan.py (plan_gru_f32_forward, plan_gru_f32_backward) chooses
// each walk's design and cuts it over the card.
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
// - The fully resident design of the bf16 kernels does not fit: float32
//   w_hh is 17.3 MB a chain at H = 1200 and 48 MB at H = 2000, against
//   about 30 MB of shared memory on the whole card (132 SMs x 227 KB). The
//   persistent walks (below; the ring and the tiled product in f32_walk.cuh)
//   keep what fits of each block's slice resident and stream the rest from
//   L2 each step. The step design is one launch per time step from a host
//   loop, the launch boundary as the barrier between steps, each block
//   rereading its slice of w_hh from L2 (both flagship chains, 34.6 MB, fit
//   the 50 MB L2).
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
// - The backward walk's product is dgh_prev (B, 3H) @ w_hh^T: each unit owns
//   one row of w_hh, read as it lies, over a depth of 3H. Its step design
//   (f32_bwd_product: 32 units for 64 batch rows a block, 4 rows x 2 units a
//   thread) finishes the previous step's carry dh = partial + dgh_prev @
//   w_hh^T[:, j], applies step t's gradient and leaves dgh_t (f32,
//   ping-pong) and the partial carry in global memory; one more step (t < 0)
//   only finishes the carry: that is dh0. Its persistent design keeps the
//   partial carry in shared memory and exchanges dgh through L2 (below);
//   there the left operand, not the weights, dominates the L2 traffic: every
//   block reads all of its chain's dgh (467 KB a step at B = 32, H = 1200).
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
// The persistent forward walk (B1, B2, B3's recurrence): all steps of one or
// two chains in one cooperative launch
// ---------------------------------------------------------------------------
//
// The plan (ops/persist_plan.py:plan_gru_f32_forward) cuts the units of the
// chains into blocks of U (even) units, one block an SM, chain c's blocks
// c * blocks .. (c + 1) * blocks - 1. Block k of a chain owns units j0 = k U
// .. j0 + U - 1 and their 3U columns of w_hh, packed by the wrapper
// (gru_cuda.f32_slices) as wp[k][d][g U + u] = w_hh[d][g H + j0 + u], zeros
// past H and past the depth H, so a chunk of depths is one contiguous run.
// The state is exchanged through hx (2 ping-pong buffers, chains, Dp
// depths, Bp rows), transposed, so that a chunk of depths of h is contiguous
// too: step s reads buffer s % 2 and writes its units of buffer (s + 1) % 2;
// the grid barrier (persist.cuh) orders the two, and every read of hx goes
// through L2 (the copy engine's bulk copies after a fence.proxy.async, or
// __ldcg), never L1: another block wrote it.
//
// Shared memory, from its start:
//   the work area: the ring (FP_STAGES x one chunk: kc depths of h, then kc
//     depths of the streamed slice; thread 0 asks the copy engine for each
//     chunk, which completes on its stage's mbarrier), and over it, once a
//     product is done,
//     the partial sums Cs[split][row][col] and the new state's tile
//     Hn[u][row] from which hx is written in runs of rows;
//   "dot" only: the whole of h (Dp x B) for the step;
//   the resident slice: depths 0 .. kres - 1 of the block's packed slice,
//     loaded once. The split is chosen by the plan: the work area and h
//     first, then as many chunks of the slice as the block's shared memory
//     still holds; depths from kres on stream from L2 through the ring each
//     step (both flagship chains' 34.6 MB and one 5x2000 layer's 48 MB of
//     float32 w_hh stay in the 50 MB L2 between steps as far as they fit).
//
// The products are FFMA in float32 (no TF32), each thread's sums over the
// depth in order and the splits' partial sums added in split order, so a
// call repeats bit for bit:
// - tiled (more than FP_DOT_ROWS rows; fp_tiled_product<3>, f32_walk.cuh):
//   passes of RB rows (a multiple of 8; Bp = passes x RB); thread (split ks,
//   tile) holds 8 rows x 2 units x 3 gates = 48 sums and walks depths
//   ks kc / KS .. of each chunk: per depth two 16-byte reads of h and three
//   8-byte reads of w for 48 FFMAs. Every
//   block reads all of its chain's h each pass (614 KB a step at B=128,
//   H=1200, 74 MB over B3's 120 blocks): the ring overlaps those reads with
//   the product of the chunk before (FP_STAGES - 1 chunks in flight); nothing
//   cuts them (no multicast across a cluster).
// - dot (at most FP_DOT_ROWS rows, the streaming chunk and small cohorts):
//   no padding rows; thread (split ks, column) owns one gate column for
//   every row and a share of the depth: kres / KS resident depths, then
//   kc / KS of each streamed chunk. The whole of h (Dp x B) comes into
//   shared memory once a step; the streamed chunks' loads are in flight
//   while the resident depths are multiplied. Every block reads its columns
//   of w_hh, so all SMs read w_hh.
// The epilogue takes (row, unit) pairs over all threads: the three gate sums
// (splits in order), b_hh (b_hh_n inside r * gh_n), gx + b_ih, the gates, the
// length mask (rows past their length keep their state and write zeros),
// out, and h through the tile Hn. Only t < max(lengths) is walked (both
// chains the same count; a reverse chain walks t = n - 1 .. 0, its state h0
// until then); the later steps' zeros are written first, with no barrier.
// After the walk each block writes its units of the final state to h_last.
//
// ptxas (sm_90a, as chip_smoke.py's build log prints it): the tiled instance
// 145 registers, the small-B instances 127-168, no spill; the backward walk
// (below) 161.

#define FP_DOT_ROWS 8

struct FpWalk {
  const float* gx[2];   // (T, B, 3H), bias-free
  const float* wp[2];   // (blocks, Dp, 3U), packed
  const float* bih[2];  // (3H,)
  const float* bhh[2];  // (3H,)
  float* out[2];        // (T, B, H)
  float* hlast[2];      // (B, H)
  int reverse[2];
  const int* lengths;   // (B,)
  float* hx;            // (2, chains, Dp, Bp)
  unsigned int* barrier;
  int T, B, H, chains, blocks;
  FpCut q;              // Dp: H padded to the chunk depth
};

// floats of the work area: the ring, or the partial sums and the new state's
// tile Hn (U x RB) over it
__host__ __device__ __forceinline__ int fp_fwd_work(const FpCut& q, bool dot) {
  return fp_work_floats(q, 3 * q.U, dot ? 0 : q.RB, q.U * q.RB);
}

// Cs[ks][b][c] = the partial sum over split ks's depths of h[b] . slice[c],
// for the B = ROWS <= FP_DOT_ROWS rows (small-B product, one instance a
// batch); Cs lies over the ring. hs receives the whole of h.
template <int ROWS>
__device__ __forceinline__ void fp_dot_product(const FpCut& q, const float* hsrc,
                                               const float* wp, const float* Ws,
                                               FpRing& ring, float* hs, long long& ps_t_) {
  const int tid = threadIdx.x;
  const int NC = 3 * q.U, kc = q.kc, KS = q.KS;
  constexpr int S = FP_STAGES;
  constexpr int B = ROWS;
  const int nch = q.Dp / kc, kres_ch = q.kres / kc;
  const int stage_f = kc * NC;
  const uint32_t g0 = ring.fed - kres_ch;  // streamed chunk i is ring chunk g0 + i
  uint64_t* hbar = ring.bars + FP_STAGES;
  auto feed = [&](int i) {  // thread 0: streamed chunk i (i >= kres_ch)
    if (i >= nch) return;
    const uint32_t g = g0 + i;
    uint64_t* bar = ring.bars + g % S;
    ps_mbar_expect_tx(bar, 4u * stage_f);
    fp_bulk(ring.base + (g % S) * stage_f, wp + (size_t)i * kc * NC, 4u * stage_f, bar);
  };
  if (tid == 0) {
    asm volatile("fence.proxy.async;\n" ::: "memory");
    ps_mbar_expect_tx(hbar, 4u * q.Dp * B);
    fp_bulk(hs, hsrc, 4u * q.Dp * B, hbar);
    for (int i = kres_ch; i < kres_ch + S - 1; ++i) feed(i);
  }
  const int col = tid % NC, ks = tid / NC;
  const bool active = ks < KS;
  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.0f;

  ps_mbar_wait(hbar, ring.hfed & 1u);  // the whole of h has landed
  ++ring.hfed;
  PS_ACC(5);
  if (active) {  // the resident depths, in KS runs of kres / KS
    const int dk = q.kres / KS;
    const float* w = Ws + (size_t)ks * dk * NC + col;
    const float* hr = hs + (size_t)ks * dk * B;
#pragma unroll 4
    for (int k = 0; k < dk; ++k) {
      const float wk = w[(size_t)k * NC];
#pragma unroll
      for (int b = 0; b < B; ++b) acc[b] = fmaf(hr[k * B + b], wk, acc[b]);
    }
  }
  PS_ACC(10);
  const int dk = kc / KS;
  for (int i = kres_ch; i < nch; ++i) {
    fp_ring_wait(ring, g0 + i);
    __syncthreads();  // every thread has left the chunk before: its stage is free
    PS_ACC(5);
    if (tid == 0) {
      ps_fence_proxy_async();
      feed(i + S - 1);
    }
    if (active) {
      const float* ws = ring.base + ((g0 + i) % S) * stage_f + ks * dk * NC + col;
      const float* hr = hs + ((size_t)i * kc + ks * dk) * B;
#pragma unroll 4
      for (int kk = 0; kk < dk; ++kk) {
        const float w = ws[kk * NC];
#pragma unroll
        for (int b = 0; b < B; ++b) acc[b] = fmaf(hr[kk * B + b], w, acc[b]);
      }
    }
    PS_ACC(10);
  }
  ring.fed = g0 + nch;
  __syncthreads();  // the ring is read: the partial sums go over it
  if (active) {
#pragma unroll
    for (int b = 0; b < B; ++b) ring.base[((size_t)ks * B + b) * NC + col] = acc[b];
  }
  __syncthreads();
  PS_ACC(8);
}

// ROWS = 0: the tiled product; 1 .. FP_DOT_ROWS: the small-B product at B = ROWS
template <int ROWS>
__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
gru_f32_persist_kernel(FpWalk p) {
  constexpr bool DOT = ROWS > 0;
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES + 1];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const FpCut& fc = p.q;
  const int j0 = (blockIdx.x - c * p.blocks) * fc.U;
  const int U = fc.U, NC = 3 * U, H = p.H, B = p.B, T = p.T, RB = fc.RB, Bp = fc.Bp;
  const int uw = min(U, H - j0);
  const int G = 3 * H;
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Hn = fp_smem + fc.KS * RB * NC;
  float* hs = fp_smem + fp_fwd_work(fc, DOT);
  float* Ws = hs + (DOT ? fp_up4(fc.Dp * B) : 0);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * fc.Dp * NC;

  if (tid == 0) {
    for (int i = 0; i <= FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  fp_load_resident(Ws, wp, fc.kres * NC);  // the resident depths of the slice, once

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
  const float* __restrict__ bih = p.bih[c];
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
      for (int i = tid; i < RB * 3; i += nthr) {
        const int b = r0 + i / 3;
        if (b < B) ps_prefetch_l2(gx + ((size_t)t * B + b) * G + (i % 3) * H + j0);
      }
      if constexpr (DOT)
        fp_dot_product<(DOT ? ROWS : 1)>(fc, hsrc, wp, Ws, ring, hs, ps_t_);
      else
        fp_tiled_product<3>(fc, hsrc, wp, Ws, ring, r0, ps_t_);
      // epilogue: (row, unit) pairs, units fastest (gx and out in runs); the
      // loads of FP_EPI pairs first, then their gates
      for (int e0 = tid; e0 < nel; e0 += FP_EPI * nthr) {
        float xr[FP_EPI], xz[FP_EPI], xn[FP_EPI], hp[FP_EPI];
        bool live[FP_EPI], valid[FP_EPI];
#pragma unroll
        for (int q = 0; q < FP_EPI; ++q) {
          const int e = e0 + q * nthr;
          const int r = e / U, u = e - r * U;
          const int b = r0 + r, j = j0 + u;
          live[q] = e < nel && b < B && j < H;
          valid[q] = false;
          xr[q] = xz[q] = xn[q] = hp[q] = 0.0f;
          if (live[q]) {
            const float* gxr = gx + ((size_t)t * B + b) * G;
            xr[q] = gxr[j];
            xz[q] = gxr[H + j];
            xn[q] = gxr[2 * H + j];
            hp[q] = __ldcg(hsrc + (size_t)j * Bp + b);
            valid[q] = p.lengths[b] > t;
          }
        }
#pragma unroll
        for (int q = 0; q < FP_EPI; ++q) {
          const int e = e0 + q * nthr;
          if (e >= nel) break;
          const int r = e / U, u = e - r * U;
          float hn = 0.0f;  // padding rows stay zero
          if (live[q]) {
            const int b = r0 + r, j = j0 + u;
            float sr = 0.0f, sz = 0.0f, sn = 0.0f;  // the splits in order
            for (int ks = 0; ks < fc.KS; ++ks) {
              const float* cs = ring.base + ((size_t)ks * RB + r) * NC + u;
              sr += cs[0];
              sz += cs[U];
              sn += cs[2 * U];
            }
            const float ghr = sr + bhh[j];
            const float ghz = sz + bhh[H + j];
            const float ghn = sn + bhh[2 * H + j];
            const float rg = f32_sigmoid((xr[q] + bih[j]) + ghr);
            const float zg = f32_sigmoid((xz[q] + bih[H + j]) + ghz);
            const float ng = tanhf((xn[q] + bih[2 * H + j]) + rg * ghn);
            const float hnew = (1.0f - zg) * ng + zg * hp[q];
            hn = valid[q] ? hnew : hp[q];
            out[((size_t)t * B + b) * H + j] = valid[q] ? hnew : 0.0f;
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
    ps_grid_barrier(p.barrier, (unsigned int)(s + 1) * gridDim.x);
    PS_ACC(1);
  }
  // h_last: this block's units of the last buffer written (h0 when n = 0)
  const float* hfin = p.hx + ((size_t)(n & 1) * p.chains + c) * hbuf;
  for (int i = tid; i < B * uw; i += nthr) {
    const int b = i / uw, u = i - b * uw;
    p.hlast[c][(size_t)b * H + j0 + u] = __ldcg(hfin + (size_t)(j0 + u) * Bp + b);
  }
}

// The plan's ints, checked against what the kernel assumes, and the launch.
static int fp_launch(FpWalk& p, int threads, int smem, int dot, cudaStream_t s) {
  const FpCut& q = p.q;
  const int NC = 3 * q.U;
  bool ok = p.chains >= 1 && p.chains <= 2 && p.T >= 1 && p.B >= 1 && p.H >= 1 &&
            fp_cut_ok(q, p.H, p.blocks, threads) && q.Dp >= p.H && q.Bp >= p.B;
  if (dot)
    ok = ok && p.B <= FP_DOT_ROWS && q.RB == p.B && q.Bp == p.B && NC * q.KS <= threads &&
         q.kres % q.KS == 0;
  else
    ok = ok && fp_tiled_ok(q, threads);
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long need = 4LL * (fp_fwd_work(q, dot != 0) + (dot ? fp_up4(q.Dp * p.B) : 0) +
                                (long long)q.kres * NC);
  if (smem < need) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  static const void* const kernels[FP_DOT_ROWS + 1] = {
      (const void*)gru_f32_persist_kernel<0>, (const void*)gru_f32_persist_kernel<1>,
      (const void*)gru_f32_persist_kernel<2>, (const void*)gru_f32_persist_kernel<3>,
      (const void*)gru_f32_persist_kernel<4>, (const void*)gru_f32_persist_kernel<5>,
      (const void*)gru_f32_persist_kernel<6>, (const void*)gru_f32_persist_kernel<7>,
      (const void*)gru_f32_persist_kernel<8>};
  const void* kernel = kernels[dot ? p.B : 0];
  return ps_coop_launch(kernel, p.blocks * p.chains, threads, (size_t)smem, args, s);
}

// ---------------------------------------------------------------------------
// Host entry, B1 / B2, persistent: one or two chains (a, b) over precomputed
// bias-free projections, sharing T, B, H and lengths, in one cooperative
// launch of the planned grid on the caller's stream. wp_* are the packed
// slices (blocks, Dp, 3U); hx holds 2 buffers of (chains, Dp, Bp) f32, buffer
// 0 h0 of each chain transposed (h0[b][j] at [j][b]) and zeros elsewhere;
// h_last (B, H) of each chain on exit. barrier: one zeroed counter. Returns
// the CUDA error code (cudaErrorCooperativeLaunchTooLarge where the grid
// cannot be co-resident), else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_f32_persist_launch(
    const void* gx_a, const void* gx_b, const void* lengths, const void* wp_a,
    const void* wp_b, const void* b_ih_a, const void* b_ih_b, const void* b_hh_a,
    const void* b_hh_b, void* hx, void* h_last_a, void* h_last_b, void* out_a, void* out_b,
    void* barrier, int T, int B, int H, int reverse_a, int reverse_b, int chains,
    int units, int blocks, int rows_per_pass, int padded_rows, int padded_depth,
    int k_splits, int chunk_depth, int resident_depth, int threads, int smem, int dot,
    void* stream) {
  FpWalk p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.wp[0] = static_cast<const float*>(wp_a);
  p.wp[1] = static_cast<const float*>(wp_b);
  p.bih[0] = static_cast<const float*>(b_ih_a);
  p.bih[1] = static_cast<const float*>(b_ih_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.out[0] = static_cast<float*>(out_a);
  p.out[1] = static_cast<float*>(out_b);
  p.hlast[0] = static_cast<float*>(h_last_a);
  p.hlast[1] = static_cast<float*>(h_last_b);
  p.reverse[0] = reverse_a;
  p.reverse[1] = reverse_b;
  p.lengths = static_cast<const int*>(lengths);
  p.hx = static_cast<float*>(hx);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.T = T; p.B = B; p.H = H; p.chains = chains;
  p.blocks = blocks;
  p.q = FpCut{units, rows_per_pass, padded_rows, padded_depth, k_splits, chunk_depth,
              resident_depth};
  return fp_launch(p, threads, smem, dot, reinterpret_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Host entry, B3, persistent: the projection x @ w_ih of both directions
// into the f32 gx buffer (2, T, B, 3H) (sgemm.cuh, as the step design's),
// then both chains (the backward one in reverse time), h0 = 0, in one
// cooperative launch. hx: 2 zeroed buffers of (2, Dp, Bp); h_last (2, B, H)
// and out (2, T, B, H) f32.
// ---------------------------------------------------------------------------

extern "C" int gru_f32_bidi_fused_persist_launch(
    const void* x, const void* lengths, const void* w_ih_f, const void* w_ih_b,
    const void* wp_f, const void* wp_b, const void* b_ih_f, const void* b_ih_b,
    const void* b_hh_f, const void* b_hh_b, void* gx, void* hx, void* h_last, void* out,
    void* barrier, int T, int B, int D, int H, int units, int blocks, int rows_per_pass,
    int padded_rows, int padded_depth, int k_splits, int chunk_depth, int resident_depth,
    int threads, int smem, int dot, void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t gsz = (size_t)T * B * 3 * H;
  float* g = static_cast<float*>(gx);
  const float* xa = static_cast<const float*>(x);
  int rc = sgemm_launch(xa, xa, static_cast<const float*>(w_ih_f),
                        static_cast<const float*>(w_ih_b), g, g + gsz, T * B, 3 * H, D,
                        2, s);
  if (rc != 0) return rc;
  float* o = static_cast<float*>(out);
  float* hl = static_cast<float*>(h_last);
  return gru_f32_persist_launch(
      g, g + gsz, lengths, wp_f, wp_b, b_ih_f, b_ih_b, b_hh_f, b_hh_b, hx, hl,
      hl + (size_t)B * H, o, o + (size_t)T * B * H, barrier, T, B, H, 0, 1, 2, units,
      blocks, rows_per_pass, padded_rows, padded_depth, k_splits, chunk_depth,
      resident_depth, threads, smem, dot, stream);
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

// ---------------------------------------------------------------------------
// The persistent backward walk (B4): all steps of one or two chains in one
// cooperative launch, after the gate recompute
// ---------------------------------------------------------------------------
//
// The plan (ops/persist_plan.py:plan_gru_f32_backward) cuts the units of the
// chains into blocks of U (even) units, one block an SM, chain c's blocks
// c * blocks .. (c + 1) * blocks - 1, as the forward walk's. Block k of a
// chain owns units j0 = k U .. j0 + U - 1 and rows j of w_hh (H, 3H), read as
// they lie (w_hh^T[:, j] = w_hh[j, :]): one column a unit over a depth of
// 3H, packed by the wrapper (gru_cuda.f32_rows) as wp[k][d][u] =
// w_hh[j0 + u][d], zeros past H and past 3H.
//
// Step s multiplies dgh of the step before (B, 3H), exchanged transposed
// through dg (2 ping-pong buffers, chains, Dp depths, Bp rows; every block
// reads all of it, through the ring: f32_walk.cuh, G = 1), by its slice:
// the carry of its units, dh = partial + dgh_prev @ w_hh^T[:, j]. The
// epilogue takes (row, unit) pairs over all threads, as the step kernel's
// (gru_f32_bwd_step_kernel) does: it finishes dh, recomputes r, z and n from
// gx + b_ih and the gh the recompute left in dgx, applies step t's
// gradient, writes dgx and dghn, keeps the partial carry dhnew z + (1 - m) dh
// in shared memory (P, the block's units for every row: no state leaves the
// block), and writes its units' three depths (j, H + j, 2H + j) of the new
// dgh into dg through the tile Dn, in runs of rows. A grid barrier a chain
// (each chain its own counter, so the two never wait for each other) orders
// the steps. Only the steps with a valid row are walked, t = n - 1 .. 0 for
// a reverse walk (the backward of a forward chain), 0 .. n - 1 otherwise,
// n = max(lengths): at t >= n every row is past its length, the gradients
// are zeros (written first, with no barrier) and the carry passes through
// unchanged. Step 0 multiplies nothing (dgh before it is zero). One more pass
// (s = n) only finishes the carry: that is dh0.
//
// Shared memory, from its start: the work area (the ring, and over it the
// partial sums Cs[split][row][unit] and the tile Dn[gate][unit][row]), the
// partial carry P[unit][Bp], the resident depths of the slice.

struct FbWalk {
  const float* gx[2];     // (T, B, 3H), bias-free
  const float* hprev[2];  // (T, B, H)
  const float* dout[2];   // (T, B, H)
  const float* wp[2];     // (blocks, Dp, U), packed rows of w_hh
  const float* bih[2];    // (3H,)
  const float* bhh[2];    // (3H,)
  float* dgx[2];          // (T, B, 3H): gh in, dgx out
  float* dghn[2];         // (T, B, H)
  float* dh[2];           // (B, H): dh_last in, dh0 out
  int reverse[2];
  const int* lengths;     // (B,)
  float* dg;              // (2, chains, Dp, Bp): dgh exchanged, zeros on entry
  unsigned int* barrier;  // (chains,): a zeroed counter a chain
  int T, B, H, chains, blocks;
  FpCut q;                // Dp: 3H padded to the chunk depth
};

// floats of the work area: the ring, or the partial sums and the tile Dn
// (3 x U x RB) of the new dgh over it
__host__ __device__ __forceinline__ int fb_work(const FpCut& q) {
  return fp_work_floats(q, q.U, q.RB, 3 * q.U * q.RB);
}

__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
gru_f32_bwd_persist_kernel(FbWalk p) {
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const FpCut& fc = p.q;
  const int j0 = (blockIdx.x - c * p.blocks) * fc.U;
  const int U = fc.U, H = p.H, B = p.B, T = p.T, RB = fc.RB, Bp = fc.Bp;
  const int uw = min(U, H - j0);
  const int G = 3 * H;
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Dn = fp_smem + fc.KS * RB * U;
  float* P = fp_smem + fb_work(fc);
  float* Ws = P + fp_up4(U * Bp);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * fc.Dp * U;

  if (tid == 0) {
    for (int i = 0; i < FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  fp_load_resident(Ws, wp, fc.kres * U);  // the resident depths of the slice, once
  float* __restrict__ dh = p.dh[c];
  for (int i = tid; i < U * Bp; i += nthr) {  // the carry starts at dh_last
    const int u = i / Bp, b = i - u * Bp;
    P[i] = (u < uw && b < B) ? dh[(size_t)b * H + j0 + u] : 0.0f;
  }

  const int n = ps_longest(p.lengths, B, T);  // its __syncthreads covers both
  float* __restrict__ dgx = p.dgx[c];
  float* __restrict__ dghn = p.dghn[c];
  {  // steps n .. T - 1: zeros at this block's units
    const size_t cnt = (size_t)(T - n) * B * uw;
    for (size_t i = tid; i < cnt; i += nthr) {
      const size_t row = (size_t)n * B + i / uw;
      const int j = j0 + (int)(i % uw);
      dgx[row * G + j] = 0.0f;
      dgx[row * G + H + j] = 0.0f;
      dgx[row * G + 2 * H + j] = 0.0f;
      dghn[row * H + j] = 0.0f;
    }
  }
  const float* __restrict__ gx = p.gx[c];
  const float* __restrict__ hprev = p.hprev[c];
  const float* __restrict__ dout = p.dout[c];
  const float* __restrict__ bih = p.bih[c];
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
        for (int i = tid; i < RB * 6; i += nthr) {
          const int b = r0 + i / 6, g = i % 6;
          const float* base = g < 3 ? gx : dgx;
          if (b < B) ps_prefetch_l2(base + ((size_t)t * B + b) * G + (g % 3) * H + j0);
        }
      }
      if (s > 0) fp_tiled_product<1>(fc, dsrc, wp, Ws, ring, r0, ps_t_);
      // epilogue: (row, unit) pairs, units fastest; the loads of FP_EPI pairs
      // first, then their gradients
      for (int e0 = tid; e0 < nel; e0 += FP_EPI * nthr) {
        float xr[FP_EPI], xz[FP_EPI], xn[FP_EPI], hr[FP_EPI], hz[FP_EPI], hn[FP_EPI];
        float hp[FP_EPI], dy[FP_EPI];
        bool live[FP_EPI], valid[FP_EPI];
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          const int r = e / U, u = e - r * U;
          const int b = r0 + r, j = j0 + u;
          live[k] = e < nel && b < B && j < H;
          valid[k] = false;
          xr[k] = xz[k] = xn[k] = hr[k] = hz[k] = hn[k] = hp[k] = dy[k] = 0.0f;
          if (live[k] && !last) {
            const size_t row = (size_t)t * B + b;
            const float* gxr = gx + row * G;
            const float* ghr = dgx + row * G;
            xr[k] = gxr[j];
            xz[k] = gxr[H + j];
            xn[k] = gxr[2 * H + j];
            hr[k] = ghr[j];
            hz[k] = ghr[H + j];
            hn[k] = ghr[2 * H + j];
            hp[k] = hprev[row * H + j];
            dy[k] = dout[row * H + j];
            valid[k] = p.lengths[b] > t;
          }
        }
#pragma unroll
        for (int k = 0; k < FP_EPI; ++k) {
          const int e = e0 + k * nthr;
          if (e >= nel) break;
          const int r = e / U, u = e - r * U;
          float dr = 0.0f, dz = 0.0f, dn = 0.0f;  // padding rows stay zero
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
            const float ghr = hr[k] + bhh[j];
            const float ghz = hz[k] + bhh[H + j];
            const float ghn = hn[k] + bhh[2 * H + j];
            const float rg = f32_sigmoid((xr[k] + bih[j]) + ghr);
            const float zg = f32_sigmoid((xz[k] + bih[H + j]) + ghz);
            const float ng = tanhf((xn[k] + bih[2 * H + j]) + rg * ghn);

            const float dhnew = valid[k] ? dhv + dy[k] : 0.0f;
            const float dnv = dhnew * (1.0f - zg);
            const float dzv = dhnew * (hp[k] - ng);
            const float dpre_n = dnv * (1.0f - ng * ng);
            const float dpre_r = dpre_n * ghn * rg * (1.0f - rg);
            const float dpre_z = dzv * zg * (1.0f - zg);
            const size_t row = (size_t)t * B + b;
            dgx[row * G + j] = dpre_r;
            dgx[row * G + H + j] = dpre_z;
            dgx[row * G + 2 * H + j] = dpre_n;
            dr = dpre_r;
            dz = dpre_z;
            dn = dpre_n * rg;
            dghn[row * H + j] = dn;
            P[u * Bp + b] = dhnew * zg + (valid[k] ? 0.0f : dhv);
          }
          Dn[u * RB + r] = dr;
          Dn[(U + u) * RB + r] = dz;
          Dn[(2 * U + u) * RB + r] = dn;
        }
      }
      __syncthreads();
      if (!last) {
        for (int e = tid; e < 3 * uw * RB; e += nthr) {  // rows fastest: runs of dg
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
// Host entry, B4, persistent: the backward walks of one or two chains (a, b)
// that share T, B, H and lengths, on the caller's stream: the gate recompute
// gh = hprev @ w_hh of each chain into its dgx buffer (sgemm.cuh, as the step
// design's), then every step in one cooperative launch of the planned grid.
// wp_* are the packed rows (blocks, Dp, U); dg holds 2 zeroed buffers of
// (chains, Dp, Bp) f32; dh_* hold dh_last on entry and dh0 on exit;
// barrier: one zeroed counter a chain. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge where the grid cannot be co-resident),
// else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_f32_bwd_persist_launch(
    const void* gx_a, const void* gx_b, const void* hprev_a, const void* hprev_b,
    const void* dout_a, const void* dout_b, const void* lengths, const void* w_hh_a,
    const void* w_hh_b, const void* wp_a, const void* wp_b, const void* b_ih_a,
    const void* b_ih_b, const void* b_hh_a, const void* b_hh_b, void* dg, void* dh_a,
    void* dh_b, void* dgx_a, void* dgx_b, void* dghn_a, void* dghn_b, void* barrier,
    int T, int B, int H, int reverse_a, int reverse_b, int chains, int units, int blocks,
    int rows_per_pass, int padded_rows, int padded_depth, int k_splits, int chunk_depth,
    int resident_depth, int threads, int smem, int dot, void* stream) {
  FbWalk p;
  p.gx[0] = static_cast<const float*>(gx_a);
  p.gx[1] = static_cast<const float*>(gx_b);
  p.hprev[0] = static_cast<const float*>(hprev_a);
  p.hprev[1] = static_cast<const float*>(hprev_b);
  p.dout[0] = static_cast<const float*>(dout_a);
  p.dout[1] = static_cast<const float*>(dout_b);
  p.wp[0] = static_cast<const float*>(wp_a);
  p.wp[1] = static_cast<const float*>(wp_b);
  p.bih[0] = static_cast<const float*>(b_ih_a);
  p.bih[1] = static_cast<const float*>(b_ih_b);
  p.bhh[0] = static_cast<const float*>(b_hh_a);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.dgx[0] = static_cast<float*>(dgx_a);
  p.dgx[1] = static_cast<float*>(dgx_b);
  p.dghn[0] = static_cast<float*>(dghn_a);
  p.dghn[1] = static_cast<float*>(dghn_b);
  p.dh[0] = static_cast<float*>(dh_a);
  p.dh[1] = static_cast<float*>(dh_b);
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
                  q.Dp >= 3 * H && q.Bp >= B;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long need = 4LL * (fb_work(q) + fp_up4(q.U * q.Bp) + (long long)q.kres * q.U);
  if (smem < need) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // gh = hprev @ w_hh for every step of each chain, into its dgx buffer
  int rc = sgemm_launch(p.hprev[0], p.hprev[1], static_cast<const float*>(w_hh_a),
                        static_cast<const float*>(w_hh_b), p.dgx[0], p.dgx[1], T * B, 3 * H,
                        H, chains, s);
  if (rc != 0) return rc;
  void* args[] = {&p};
  return ps_coop_launch((const void*)gru_f32_bwd_persist_kernel, blocks * chains, threads,
                        (size_t)smem, args, s);
}

// ---------------------------------------------------------------------------
// Host entry, the float32 GEMM alone (sgemm.cuh), as B3's projection and the
// recompute of B4 and B7 call it: C[z] (M, N) = A[z] (M, K) @ B[z] (K, N) for
// z < nz (1 or 2), row-major float32, on the caller's stream (a single
// product fills both pointers of a pair with its own). Returns the CUDA
// error code, else 0.
// ---------------------------------------------------------------------------

extern "C" int sgemm_f32_launch(const void* a_0, const void* a_1, const void* b_0,
                                const void* b_1, void* c_0, void* c_1, int M, int N, int K,
                                int nz, void* stream) {
  return sgemm_launch(static_cast<const float*>(a_0), static_cast<const float*>(a_1),
                      static_cast<const float*>(b_0), static_cast<const float*>(b_1),
                      static_cast<float*>(c_0), static_cast<float*>(c_1), M, N, K, nz,
                      reinterpret_cast<cudaStream_t>(stream));
}
