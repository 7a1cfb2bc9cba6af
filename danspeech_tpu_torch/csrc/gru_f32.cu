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
//   gru_bwd_scan (B4)                     -> gru_f32_bwd_launch, one chain
//       or the two chains of a bidirectional layer (step design only).
// ops/persist_plan.py:plan_gru_f32_forward chooses the forward walk's
// design and cuts it over the card.
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
//   persistent forward walk (below) keeps what fits of each block's slice
//   resident and streams the rest from L2 each step. The step design is
//   one launch per time step from a host loop, the launch boundary as the
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;  // persist.cuh's streams; nothing here is bf16

#include "f32_step.cuh"
#include "persist.cuh"
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
// The state is exchanged through hx (2 ping-pong buffers, chains, Hp
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
//   "dot" only: the whole of h (Hp x B) for the step;
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
// - tiled (more than FP_DOT_ROWS rows): passes of RB rows (a multiple of 8;
//   Bp = passes x RB); thread (split ks, tile) holds 8 rows x 2 units x 3
//   gates = 48 sums and walks depths ks kc / KS .. of each chunk: per depth
//   two 16-byte reads of h and three 8-byte reads of w for 48 FFMAs. Every
//   block reads all of its chain's h each pass (614 KB a step at B=128,
//   H=1200, 74 MB over B3's 120 blocks): the ring overlaps those reads with
//   the product of the chunk before (FP_STAGES - 1 chunks in flight); nothing
//   cuts them (no multicast across a cluster).
// - dot (at most FP_DOT_ROWS rows, the streaming chunk and small cohorts):
//   no padding rows; thread (split ks, column) owns one gate column for
//   every row and a share of the depth: kres / KS resident depths, then
//   kc / KS of each streamed chunk. The whole of h (Hp x B) comes into
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
// 145 registers, the small-B instances 127-161, no spill.

#define FP_MAX_THREADS 384
#define FP_DOT_ROWS 8
#define FP_STAGES 2  // ring stages (persist_plan.F32_STAGES)

struct FpWalk {
  const float* gx[2];   // (T, B, 3H), bias-free
  const float* wp[2];   // (blocks, Hp, 3U), packed
  const float* bih[2];  // (3H,)
  const float* bhh[2];  // (3H,)
  float* out[2];        // (T, B, H)
  float* hlast[2];      // (B, H)
  int reverse[2];
  const int* lengths;   // (B,)
  float* hx;            // (2, chains, Hp, Bp)
  unsigned int* barrier;
  int T, B, H, chains;
  int U, blocks, RB, Bp, Hp, KS, kc, kres;
};

__host__ __device__ __forceinline__ int fp_up4(int n) { return (n + 3) & ~3; }

// floats of the work area (ring, or partial sums and the state tile)
__host__ __device__ __forceinline__ int fp_work_floats(const FpWalk& p, bool dot) {
  const int NC = 3 * p.U;
  const int ring = FP_STAGES * p.kc * ((dot ? 0 : p.RB) + NC);
  const int sums = p.KS * p.RB * NC + p.U * p.RB;
  return fp_up4(ring > sums ? ring : sums);
}

// `bytes` (a multiple of 16) from global memory at src to shared memory at
// dst, both on 16 bytes, by the copy engine (a bulk copy, through L2), counted
// on the mbarrier `bar`
__device__ __forceinline__ void fp_bulk(void* dst, const void* src, uint32_t bytes,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(ps_smem(dst)), "l"(src), "r"(bytes), "r"(ps_smem(bar)) : "memory");
}

// The ring: stage g % FP_STAGES holds chunk g (chunks counted over the whole
// walk, the same count in every thread), filled by thread 0 with bulk copies
// that complete on the stage's mbarrier; its (g / FP_STAGES)-th phase. Thread 0
// refills a stage only after the block-wide barrier that follows the wait
// for the next chunk, so every thread has left it.
struct FpRing {
  float* base;
  uint64_t* bars;  // one mbarrier a stage, then one for the whole of h ("dot")
  uint32_t fed;    // chunks fed before this product
  uint32_t hfed;   // loads of the whole of h before this one ("dot")
};

__device__ __forceinline__ void fp_ring_wait(const FpRing& ring, uint32_t g) {
  ps_mbar_wait(ring.bars + g % FP_STAGES, (g / FP_STAGES) & 1u);
}

// Cs[ks][r][c] = the partial sum over split ks's depths of h[r0 + r] .
// slice[c], for the pass's RB rows (tiled product); Cs lies over the ring.
// (Tried on an H100: a tile of 8 rows x 4 units was faster only where the
// block kept 8 warps, and slower at B3's layer, whose 80 such tiles leave 5;
// an unroll of 8 needs fewer registers than one of 4 and ran faster.)
__device__ __forceinline__ void fp_tiled_product(const FpWalk& p, const float* hsrc,
                                                 const float* wp, const float* Ws,
                                                 FpRing& ring, int r0, long long& ps_t_) {
  const int tid = threadIdx.x;
  const int U = p.U, NC = 3 * U, RB = p.RB, kc = p.kc, KS = p.KS;
  constexpr int S = FP_STAGES;
  const int nch = p.Hp / kc, kres_ch = p.kres / kc;
  const int stage_f = kc * (RB + NC);
  const uint32_t g0 = ring.fed;
  auto feed = [&](int i) {  // thread 0: chunk i of this product
    if (i >= nch) return;
    const uint32_t g = g0 + i;
    float* st = ring.base + (g % S) * stage_f;
    uint64_t* bar = ring.bars + g % S;
    const bool streamed = i >= kres_ch;
    ps_mbar_expect_tx(bar, 4u * kc * (RB + (streamed ? NC : 0)));
    if (RB == p.Bp) {  // one pass: kc depths of every row are one run
      fp_bulk(st, hsrc + (size_t)i * kc * RB, 4u * kc * RB, bar);
    } else {
      for (int kk = 0; kk < kc; ++kk)
        fp_bulk(st + kk * RB, hsrc + (size_t)(i * kc + kk) * p.Bp + r0, 4u * RB, bar);
    }
    if (streamed) fp_bulk(st + kc * RB, wp + (size_t)i * kc * NC, 4u * kc * NC, bar);
  };

  const int tiles = (RB / 8) * (U / 2);
  const int ks = tid / tiles, tile = tid - ks * tiles;
  const bool active = ks < KS;
  const int up = tile % (U / 2), rg = tile / (U / 2);
  const int dk = kc / KS;
  float acc[8][6];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[r][q] = 0.0f;

  if (tid == 0) {
    // what other blocks wrote before the grid barrier, and what this block
    // read and wrote with ordinary accesses, ordered before the copies
    asm volatile("fence.proxy.async;\n" ::: "memory");
    for (int i = 0; i < S - 1; ++i) feed(i);
  }
  PS_ACC(2);
  for (int i = 0; i < nch; ++i) {
    fp_ring_wait(ring, g0 + i);
    __syncthreads();  // every thread has left chunk i - 1: its stage is free
    PS_ACC(5);
    if (tid == 0) {
      ps_fence_proxy_async();
      feed(i + S - 1);
    }
    if (active) {
      const float* hs = ring.base + ((g0 + i) % S) * stage_f;
      const float* ws = i < kres_ch ? Ws + (size_t)i * kc * NC : hs + kc * RB;
      const float* a = hs + ks * dk * RB + rg * 8;
      const float* w = ws + ks * dk * NC + 2 * up;
#pragma unroll 8
      for (int kk = 0; kk < dk; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + kk * RB);
        const float4 a1 = *reinterpret_cast<const float4*>(a + kk * RB + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float wv[6];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float2 v = *reinterpret_cast<const float2*>(w + kk * NC + g * U);
          wv[2 * g] = v.x;
          wv[2 * g + 1] = v.y;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 6; ++q) acc[r][q] = fmaf(av[r], wv[q], acc[r][q]);
      }
    }
    PS_ACC(10);
  }
  ring.fed = g0 + nch;
  __syncthreads();  // the ring is read: the partial sums go over it
  if (active) {
    float* cs = ring.base + ((size_t)ks * RB + rg * 8) * NC + 2 * up;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        *reinterpret_cast<float2*>(cs + r * NC + g * U) =
            make_float2(acc[r][2 * g], acc[r][2 * g + 1]);
  }
  __syncthreads();
  PS_ACC(8);
}

// Cs[ks][b][c] = the partial sum over split ks's depths of h[b] . slice[c],
// for the B = ROWS <= FP_DOT_ROWS rows (small-B product, one instance a
// batch); Cs lies over the ring. hs receives the whole of h.
template <int ROWS>
__device__ __forceinline__ void fp_dot_product(const FpWalk& p, const float* hsrc,
                                               const float* wp, const float* Ws,
                                               FpRing& ring, float* hs, long long& ps_t_) {
  const int tid = threadIdx.x;
  const int NC = 3 * p.U, kc = p.kc, KS = p.KS;
  constexpr int S = FP_STAGES;
  constexpr int B = ROWS;
  const int nch = p.Hp / kc, kres_ch = p.kres / kc;
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
    ps_mbar_expect_tx(hbar, 4u * p.Hp * B);
    fp_bulk(hs, hsrc, 4u * p.Hp * B, hbar);
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
    const int dk = p.kres / KS;
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

#define FP_EPI 4  // epilogue elements a thread loads before it computes any

// ROWS = 0: the tiled product; 1 .. FP_DOT_ROWS: the small-B product at B = ROWS
template <int ROWS>
__global__ void __launch_bounds__(FP_MAX_THREADS, 1)
gru_f32_persist_kernel(FpWalk p) {
  constexpr bool DOT = ROWS > 0;
  extern __shared__ __align__(16) float fp_smem[];
  __shared__ __align__(8) uint64_t fp_bars[FP_STAGES + 1];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = blockIdx.x / p.blocks;
  const int j0 = (blockIdx.x - c * p.blocks) * p.U;
  const int U = p.U, NC = 3 * U, H = p.H, B = p.B, T = p.T, RB = p.RB, Bp = p.Bp;
  const int uw = min(U, H - j0);
  const int G = 3 * H;
  FpRing ring{fp_smem, fp_bars, 0u, 0u};
  float* Hn = fp_smem + p.KS * RB * NC;
  float* hs = fp_smem + fp_work_floats(p, DOT);
  float* Ws = hs + (DOT ? fp_up4(p.Hp * B) : 0);
  const float* wp = p.wp[c] + (size_t)(j0 / U) * p.Hp * NC;

  if (tid == 0) {
    for (int i = 0; i <= FP_STAGES; ++i) ps_mbar_init(fp_bars + i, 1);
    ps_mbar_init_fence();
  }
  // the resident depths of the slice, once
  for (int q = tid; q < p.kres * NC / 4; q += nthr) ps_cp_async16(Ws + 4 * q, wp + 4 * q);
  ps_commit();
  ps_wait<0>();

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
  const size_t hbuf = (size_t)p.Hp * Bp;
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
        fp_dot_product<(DOT ? ROWS : 1)>(p, hsrc, wp, Ws, ring, hs, ps_t_);
      else
        fp_tiled_product(p, hsrc, wp, Ws, ring, r0, ps_t_);
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
            for (int ks = 0; ks < p.KS; ++ks) {
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
  const int NC = 3 * p.U;
  bool ok = p.chains >= 1 && p.chains <= 2 && p.T >= 1 && p.B >= 1 && p.H >= 1 &&
            p.U >= 2 && p.U % 2 == 0 && p.blocks >= 1 && (long long)p.blocks * p.U >= p.H &&
            (long long)(p.blocks - 1) * p.U < p.H && p.KS >= 1 && p.kc >= 4 &&
            p.kc % 4 == 0 && p.kc % p.KS == 0 && p.Hp >= p.H && p.Hp % p.kc == 0 &&
            p.kres >= 0 && p.kres <= p.Hp && p.kres % p.kc == 0 && threads >= 32 && threads <= FP_MAX_THREADS &&
            threads % 32 == 0 && p.RB >= 1 && p.Bp % p.RB == 0 && p.Bp >= p.B;
  if (dot)
    ok = ok && p.B <= FP_DOT_ROWS && p.RB == p.B && p.Bp == p.B && NC * p.KS <= threads &&
         p.kres % p.KS == 0;
  else
    ok = ok && p.RB % 8 == 0 && (p.RB / 8) * (p.U / 2) * p.KS <= threads;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long need = 4LL * (fp_work_floats(p, dot != 0) +
                                (dot ? fp_up4(p.Hp * p.B) : 0) + (long long)p.kres * NC);
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
// slices (blocks, Hp, 3U); hx holds 2 buffers of (chains, Hp, Bp) f32, buffer
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
  p.U = units; p.blocks = blocks; p.RB = rows_per_pass; p.Bp = padded_rows;
  p.Hp = padded_depth; p.KS = k_splits; p.kc = chunk_depth;
  p.kres = resident_depth;
  return fp_launch(p, threads, smem, dot, reinterpret_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Host entry, B3, persistent: the projection x @ w_ih of both directions
// into the f32 gx buffer (2, T, B, 3H) (sgemm.cuh, as the step design's),
// then both chains (the backward one in reverse time), h0 = 0, in one
// cooperative launch. hx: 2 zeroed buffers of (2, Hp, Bp); h_last (2, B, H)
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
