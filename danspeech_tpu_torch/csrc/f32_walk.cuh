// The persistent float32 walks of the recurrent kernels (gru_f32.cu: the GRU
// forward walk and its backward walk; lstm_f32.cu: the LSTM forward walk and
// its backward walk; rnn_tanh_f32.cu: the tanh-RNN forward walk):
// all steps of one or two chains in one cooperative launch, one block an SM,
// each block keeping what fits of its float32 weight slice resident in
// shared memory and streaming the rest from L2 through a two-stage ring of
// bulk copies beside the left operand. The plans are those of
// ops/persist_plan.py (plan_f32 over its walk table F32_WALKS); the
// constants below mirror its F32_* ones.
//
// A block owns U (even) units of one chain and their NC = G U columns of a
// (depth, G H) matrix, packed by the wrapper (gru_cuda.f32_slices,
// gru_cuda.f32_rows) as wp[k][d][g U + u], zeros past H and past the depth,
// so that a chunk of depths of a block's slice is one contiguous run:
//   G = 3: the GRU forward walk, h (B, H) @ w_hh (H, 3H), gates r, z, n;
//   G = 4: the LSTM forward walk, h (B, H) @ w_hh (H, 4H), gates i, f, g, o;
//   G = 1: the GRU backward walk's carry, dgh (B, 3H) @ w_hh^T (3H, H), and
//          the LSTM backward walk's, dg4 (B, 4H) @ w_hh^T (4H, H), the rows j
//          of w_hh read as they lie; the tanh-RNN forward walk, h (B, H) @
//          w_hh (H, H).
// The left operand is exchanged through L2 transposed, (Dp depths, Bp rows),
// so that a chunk of depths of it is contiguous too: each block writes its
// units' depths of the next step's operand, the grid barrier (persist.cuh)
// orders the steps, and every read of it goes through L2 (the copy engine's
// bulk copies after a fence.proxy.async, or __ldcg), never L1: another block
// wrote it.
//
// The tiled product (fp_tiled_product<G>): passes of RB rows (a multiple of
// 8; Bp = passes x RB); thread (split ks, tile) holds 8 rows x 2 units x G
// gates of sums and walks depths ks kc / KS .. of each chunk: per depth two
// 16-byte reads of the operand and G 8-byte reads of the slice for 16 G
// FFMAs. Each thread sums over the depth in order and the splits' partial
// sums are added in split order by the caller's epilogue, so a call repeats
// bit for bit. The ring: stage g % FP_STAGES holds chunk g (kc depths of the
// operand's RB rows, then, for streamed depths, kc depths of the slice).

#pragma once

// Include after persist.cuh (mbarriers, bulk-copy and grid-barrier helpers).
#include <cuda_runtime.h>
#include <stdint.h>

#define FP_MAX_THREADS 384
#define FP_STAGES 2  // ring stages (persist_plan.F32_STAGES)
#define FP_EPI 4     // epilogue elements a thread loads before it computes any

// How a walk is cut over a block (the plan's ints)
struct FpCut {
  int U;     // units a block, even
  int RB;    // rows one pass multiplies
  int Bp;    // padded rows: the row stride of the exchanged operand
  int Dp;    // padded depth: a multiple of kc
  int KS;    // depth splits of the product
  int kc;    // depth of one chunk of the ring
  int kres;  // depths of the slice kept resident, a multiple of kc
};

__host__ __device__ __forceinline__ int fp_up4(int n) { return (n + 3) & ~3; }

// floats of the work area: the ring (rows_in_ring rows of the operand and
// the NC columns of the slice a stage), or, over it once a product is done,
// the partial sums (KS x RB x NC) and the caller's tile of `tile` floats
__host__ __device__ __forceinline__ int fp_work_floats(const FpCut& q, int NC, int rows_in_ring,
                                                       int tile) {
  const int ring = FP_STAGES * q.kc * (rows_in_ring + NC);
  const int sums = q.KS * q.RB * NC + tile;
  return fp_up4(ring > sums ? ring : sums);
}

// The plan's ints, checked against what every walk assumes: the blocks of a
// chain cover its H units, the chunks its depth, the passes its rows
__host__ __forceinline__ bool fp_cut_ok(const FpCut& q, int H, int blocks, int threads) {
  return q.U >= 2 && q.U % 2 == 0 && blocks >= 1 && (long long)blocks * q.U >= H &&
         (long long)(blocks - 1) * q.U < H && q.KS >= 1 && q.kc >= 4 && q.kc % 4 == 0 &&
         q.kc % q.KS == 0 && q.Dp >= 1 && q.Dp % q.kc == 0 && q.kres >= 0 &&
         q.kres <= q.Dp && q.kres % q.kc == 0 && threads >= 32 &&
         threads <= FP_MAX_THREADS && threads % 32 == 0 && q.RB >= 1 && q.Bp % q.RB == 0;
}

// ... and what fp_tiled_product assumes besides
__host__ __forceinline__ bool fp_tiled_ok(const FpCut& q, int threads) {
  return q.RB % 8 == 0 && (q.RB / 8) * (q.U / 2) * q.KS <= threads;
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

// Cs[ks][r][c] = the partial sum over split ks's depths of a[r0 + r] .
// slice[c], for the pass's RB rows and the NC = G U columns; Cs lies over the
// ring. `asrc` is the exchanged operand (Dp, Bp), `wp` the block's packed
// slice (Dp, NC), `Ws` its resident depths.
// (Tried on an H100 for G = 3: a tile of 8 rows x 4 units was faster only
// where the block kept 8 warps, and slower at B3's layer, whose 80 such tiles
// leave 5; an unroll of 8 needs fewer registers than one of 4 and ran faster.)
template <int G>
__device__ __forceinline__ void fp_tiled_product(const FpCut& q, const float* asrc,
                                                 const float* wp, const float* Ws,
                                                 FpRing& ring, int r0, long long& ps_t_) {
  const int tid = threadIdx.x;
  const int U = q.U, NC = G * U, RB = q.RB, kc = q.kc, KS = q.KS;
  constexpr int S = FP_STAGES;
  const int nch = q.Dp / kc, kres_ch = q.kres / kc;
  const int stage_f = kc * (RB + NC);
  const uint32_t g0 = ring.fed;
  auto feed = [&](int i) {  // thread 0: chunk i of this product
    if (i >= nch) return;
    const uint32_t g = g0 + i;
    float* st = ring.base + (g % S) * stage_f;
    uint64_t* bar = ring.bars + g % S;
    const bool streamed = i >= kres_ch;
    ps_mbar_expect_tx(bar, 4u * kc * (RB + (streamed ? NC : 0)));
    if (RB == q.Bp) {  // one pass: kc depths of every row are one run
      fp_bulk(st, asrc + (size_t)i * kc * RB, 4u * kc * RB, bar);
    } else {
      for (int kk = 0; kk < kc; ++kk)
        fp_bulk(st + kk * RB, asrc + (size_t)(i * kc + kk) * q.Bp + r0, 4u * RB, bar);
    }
    if (streamed) fp_bulk(st + kc * RB, wp + (size_t)i * kc * NC, 4u * kc * NC, bar);
  };

  const int tiles = (RB / 8) * (U / 2);
  const int ks = tid / tiles, tile = tid - ks * tiles;
  const bool active = ks < KS;
  const int up = tile % (U / 2), rg = tile / (U / 2);
  const int dk = kc / KS;
  float acc[8][2 * G];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 2 * G; ++c) acc[r][c] = 0.0f;

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
        float wv[2 * G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float2 v = *reinterpret_cast<const float2*>(w + kk * NC + g * U);
          wv[2 * g] = v.x;
          wv[2 * g + 1] = v.y;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 2 * G; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
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
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<float2*>(cs + r * NC + g * U) =
            make_float2(acc[r][2 * g], acc[r][2 * g + 1]);
  }
  __syncthreads();
  PS_ACC(8);
}

// The block's resident depths of its packed slice (kres x NC floats from
// wp), once, through L2
__device__ __forceinline__ void fp_load_resident(float* Ws, const float* wp, int floats) {
  for (int q = threadIdx.x; q < floats / 4; q += blockDim.x) ps_cp_async16(Ws + 4 * q, wp + 4 * q);
  ps_commit();
  ps_wait<0>();
}
