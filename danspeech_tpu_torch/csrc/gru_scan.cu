// One GRU chain over a precomputed input projection, for Hopper; its
// persistent kernel also walks both chains of a bidirectional layer.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:gru_scan (kernel body
// _gru_step_kernel), and, over two chains, pallas_gru.py:gru_scan_bidi (the
// persistent design of ops/gru_cuda.py:gru_scan_bidi; its step design is
// gru_scan_bidi.cu). Same contract:
//   gx (T, B, 3H) bf16, the bias-free projection x @ w_ih; lengths (B,)
//   int32; w_hh (H, 3H) bf16; b_ih, b_hh (3H,) f32, b_ih added when gx is
//   read; h0 (B, H) f32;
//   gh = bf16(h) @ w_hh accumulated in f32, b_hh_n stays inside r * gh_n;
//   gates and the carried state in f32; out (T, B, H) bf16 with exact zeros
//   where t >= length; reverse walks t = T-1 .. 0 and holds the state at h0
//   until t < length. h_last is the f32 state after the walk (for reverse,
//   the state at t = 0).
//
// What bounds it on an H100, and what this design does about it:
// - T dependent steps, each a (B, H) x (H, 3H) product that needs all of
//   h_{t-1}: 2*T*B*H*3H operations, 1.23 TFLOP at the unidirectional batch
//   shape (T=401, B=128, H=2000), 1.25 ms at the bf16 peak; at the streaming
//   chunk (B = 1) 24 MFLOP a step against 24 MB of w_hh. What a step costs
//   is latency (a barrier, an L2 round trip, one pass over the weights), not
//   bytes or operations. Two designs, chosen on the host by
//   ops/persist_plan.py (plan_gru_scan) from the shape and the device's SM
//   count and shared memory:
//   * persistent (gru_scan_persist_kernel, persist.cuh): ONE cooperative
//     launch walks the chain. A block owns U hidden units (U = 16 at
//     H = 2000: 125 blocks) and keeps their 3U columns of w_hh, H deep, in
//     shared memory for the whole walk (192 KB at H = 2000, in the swizzled
//     tiles wgmma reads), so no weight is read from L2 after the start. Per
//     step: a grid barrier; bf16 h of the previous step streams from L2
//     through a TMA ring beside the slice, fed by a ninth warp, while the two
//     warpgroups multiply with wgmma (B above 64: 64 rows each in row blocks
//     of 128, or, where those leave too few ring stages as at H = 2000, two
//     row blocks of 64 with the warpgroups splitting the depth; B <= 64:
//     one row block, the depth split; B <= 8, the streaming chunk among
//     them: h staged whole in shared memory and the product on the CUDA
//     cores, ps_dot_product, since the ring's per-chunk waits took most of
//     a B = 1 step); then the gates, the mask, the out
//     write and the h update (f32 h owned in place by one thread, its bf16
//     copy ping-pongs between two buffers that the other blocks read). The
//     first step multiplies bf16(h0). gx of the next step is prefetched into
//     L2 during the product. The walk covers only t < the longest row's
//     length: the later steps (the padding of a streaming chunk) write zeros
//     at the start and take no barrier. One launch may walk two chains that
//     share T, B, H and the lengths (gru_scan_bidi: the forward and the
//     reverse chain of a layer): the chain is the slow grid index, each chain
//     has its own barrier counter and its own planes of the ping-pong
//     buffer, so neither waits for the other (H = 1200: 50 blocks of 24
//     units a chain, B3's recurrence plan: 6.9 ms for both chains at T=401,
//     B=128, 17.1 us a step, by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
//     700 W). Where two chains' slices do not fit (H = 2000), gru_scan_bidi
//     runs one launch a chain.
//   * step (gru_scan_step_kernel): one launch per time step from the host
//     loop below, the launch boundary as the barrier; each block owns 16
//     units x 64 rows and rereads its slice of w_hh from L2 through an
//     unpipelined WMMA loop. Kept for widths whose slices do not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "persist.cuh"

#define S_J 16        // hidden units per block (one WMMA tile per gate)
#define S_BR 64       // batch rows per block (one 16-row WMMA tile per warp)
#define S_KC 64       // depth of one shared-memory chunk of the product
#define S_PAD 8
#define S_THREADS 128

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(S_THREADS)
gru_scan_step_kernel(const bf16* __restrict__ gx,       // (T, B, 3H)
                     const int* __restrict__ lengths,   // (B,)
                     const bf16* __restrict__ whh,      // (H, 3H)
                     const float* __restrict__ bih,     // (3H,)
                     const float* __restrict__ bhh,     // (3H,)
                     const float* __restrict__ h_in,    // (B, H) f32
                     const bf16* __restrict__ hb_in,    // (B, H) bf16
                     float* __restrict__ h_out,         // (B, H) f32
                     bf16* __restrict__ hb_out,         // (B, H) bf16
                     bf16* __restrict__ out,            // (T, B, H)
                     int t, int B, int H) {
  __shared__ __align__(32) bf16 Ah[S_BR][S_KC + S_PAD];
  __shared__ __align__(32) bf16 Bw[S_KC][3 * S_J + S_PAD];
  __shared__ __align__(32) float Cs[S_BR][3 * S_J + 4];

  const int j0 = blockIdx.x * S_J;
  const int b0 = blockIdx.y * S_BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int G = 3 * H;
  // this warp's 16 rows hold at least one real batch row (warp-uniform)
  const bool active = b0 + warp * 16 < B;
  const bool vec = (H % 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(hb_in) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(whh) % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) wmma::fill_fragment(acc[g], 0.0f);

  for (int k0 = 0; k0 < H; k0 += S_KC) {
    // h tile: 64 rows x 64 k = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + i * S_THREADS;
      int row = idx >> 3;
      int col = (idx & 7) * 8;
      int gb = b0 + row, gk = k0 + col;
      bf16* dst = &Ah[row][col];
      if (vec && gb < B && gk + 8 <= H) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(hb_in + (size_t)gb * H + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gb < B && gk + e < H) ? hb_in[(size_t)gb * H + gk + e]
                                           : __float2bfloat16(0.0f);
      }
    }
    // w_hh slice: 64 k x (3 gates x 16 units) = 384 chunks of 8
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      int idx = tid + i * S_THREADS;
      int row = idx / 6;
      int rem = idx % 6;
      int g = rem >> 1;
      int col = (rem & 1) * 8;
      int gk = k0 + row, gj = j0 + col;
      bf16* dst = &Bw[row][g * S_J + col];
      const bf16* src = whh + (size_t)gk * G + (size_t)g * H + gj;
      if (vec && gk < H && gj + 8 <= H) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < H && gj + e < H) ? src[e] : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < S_KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, &Ah[warp * 16][kk], S_KC + S_PAD);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, &Bw[kk][g * S_J], 3 * S_J + S_PAD);
          wmma::mma_sync(acc[g], af, bfr, acc[g]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
    wmma::store_matrix_sync(&Cs[warp * 16][g * S_J], acc[g], 3 * S_J + 4,
                            wmma::mem_row_major);
  __syncthreads();

  // epilogue: gates, mask, out write and h update for 64 x 16 outputs
#pragma unroll
  for (int e = 0; e < (S_BR * S_J) / S_THREADS; ++e) {
    int idx = tid + e * S_THREADS;
    int r = idx / S_J, cj = idx % S_J;
    int b = b0 + r, j = j0 + cj;
    if (b >= B || j >= H) continue;
    const bf16* gxr = gx + ((size_t)t * B + b) * G;
    float ghr = Cs[r][cj] + bhh[j];
    float ghz = Cs[r][S_J + cj] + bhh[H + j];
    float ghn = Cs[r][2 * S_J + cj] + bhh[2 * H + j];
    float xr = __bfloat162float(gxr[j]) + bih[j];
    float xz = __bfloat162float(gxr[H + j]) + bih[H + j];
    float xn = __bfloat162float(gxr[2 * H + j]) + bih[2 * H + j];
    float rg = sigmoidf_(xr + ghr);
    float zg = sigmoidf_(xz + ghz);
    float ng = tanhf(xn + rg * ghn);
    size_t hi = (size_t)b * H + j;
    float hp = h_in[hi];
    float hn = (1.0f - zg) * ng + zg * hp;
    bool valid = lengths[b] > t;
    float hnext = valid ? hn : hp;
    h_out[hi] = hnext;
    hb_out[hi] = __float2bfloat16(hnext);
    out[((size_t)t * B + b) * H + j] = __float2bfloat16(valid ? hn : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// Host entry, step design: one chain, on the caller's stream. h32/h16 hold two buffers of
// (B, H); buffer 0 holds h0 (f32 and its bf16 copy) on entry, and buffer
// T % 2 holds h_last on exit. Returns cudaGetLastError() of the first launch
// that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_scan_launch(
    const void* gx, const void* lengths, const void* w_hh, const void* b_ih,
    const void* b_hh,
    void* h32,   // (2 buffers, B, H) f32
    void* h16,   // (2 buffers, B, H) bf16
    void* out,   // (T, B, H) bf16
    int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t hsz = (size_t)B * H;
  float* hf = static_cast<float*>(h32);
  bf16* hb = static_cast<bf16*>(h16);
  dim3 grid((H + S_J - 1) / S_J, (B + S_BR - 1) / S_BR);
  for (int step = 0; step < T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    const int t = reverse ? T - 1 - step : step;
    gru_scan_step_kernel<<<grid, S_THREADS, 0, s>>>(
        static_cast<const bf16*>(gx), static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hh), static_cast<const float*>(b_ih),
        static_cast<const float*>(b_hh), hf + src * hsz, hb + src * hsz,
        hf + dst * hsz, hb + dst * hsz, static_cast<bf16*>(out), t, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Persistent design: one chain, or both chains of a bidirectional layer, in
// one cooperative launch
// ---------------------------------------------------------------------------

struct GruScanPersistArgs {
  const bf16* gx[2];      // (T, B, 3H) bf16, bias-free
  const int* lengths;     // (B,)
  const bf16* whht[2];    // (3H, H): w_hh transposed, depth contiguous
  const float* bih[2];    // (3H,)
  const float* bhh[2];    // (3H,)
  float* h32[2];          // (B, H) f32: h0 on entry, h_last on exit
  bf16* hb;               // (2 buffers, chains, B, H) bf16: buffer 0 holds bf16(h0)
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
  int dot;     // B <= PS_DOT_ROWS: the product on the CUDA cores (ps_dot_product)
};

template <int NT>  // 3 * U / 8: 8-column tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
gru_scan_persist_kernel(const GruScanPersistArgs p,
                        const __grid_constant__ CUtensorMap hb_map) {
  extern __shared__ __align__(1024) unsigned char ps_smem_raw[];
  __shared__ __align__(8) uint64_t ps_mbar[2 * PS_MAX_STAGES];
  PsPhases phases;
  const int tid = threadIdx.x;
  const int ch = blockIdx.x / p.bpd;
  const int j0 = (blockIdx.x - ch * p.bpd) * p.U;
  const int T = p.T, B = p.B, H = p.H, U = p.U;
  const int G = 3 * H;
  bf16* ring = reinterpret_cast<bf16*>(ps_smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(ps_smem_raw + p.ws_off);
  // the partial sums lie over the ring; for the CUDA-core product, after h
  float* Cs = reinterpret_cast<float*>(p.dot ? ring + (size_t)B * p.Kr : ring);
  const int BR = p.MG * 64;
  const int KS = p.dot ? 1 : 2 / p.MG;  // planes of partial sums: one a depth split
  const int ldc = NT * 8 + 1;
  const int nrb = (B + BR - 1) / BR;

  // the epilogue's streams do not alias: its loads may be issued together
  const bf16* __restrict__ gx = p.gx[ch];
  const float* __restrict__ bih = p.bih[ch];
  const float* __restrict__ bhh = p.bhh[ch];
  const int* __restrict__ lengths = p.lengths;
  float* __restrict__ h32 = p.h32[ch];
  bf16* __restrict__ out = p.out[ch];
  const bool reverse = p.reverse[ch] != 0;
  const size_t hsz = (size_t)p.chains * B * H;
  unsigned int* counter = p.barrier + ch;
  const int uw = min(U, H - j0);  // real units of this block
  // the epilogue works on four neighbouring units at a time where every row
  // segment it touches starts on 16 bytes (the bf16 ones on 8)
  const bool vec4 =
      (H % 4) == 0 &&
      ((reinterpret_cast<uintptr_t>(h32) | reinterpret_cast<uintptr_t>(bih) |
        reinterpret_cast<uintptr_t>(bhh)) % 16) == 0 &&
      ((reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(p.hb) |
        reinterpret_cast<uintptr_t>(out)) % 8) == 0;

  // both chains share the lengths, so the steps walked
  const int steps = ps_longest(lengths, B, T);
  ps_zero_steps(out, steps, T, B, H, j0, uw);
  ps_load_slice(Ws, p.whht[ch], H, H, p.Kr, 3, U, j0);
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
      for (int i = tid; i < B * 3; i += PS_BLOCK) {
        const int b = i / 3, g = i - b * 3;
        const bf16* q = gx + ((size_t)tn * B + b) * G + (size_t)g * H + j0;
        ps_prefetch_l2(q);
        ps_prefetch_l2(q + uw - 1);
      }
    }
    PS_ACC(2);
    for (int rb = 0; rb < nrb; ++rb) {
      const int row0 = rb * BR;
      PS_ACC(0);
      if (p.dot)
        ps_dot_product<NT>(hb_in, B, H, p.Kr, Ws, ring, Cs);
      else
        ps_block_product<NT>(hb_in, &hb_map, p.tma, (step & 1) * p.chains + ch, row0, B,
                             H, p.Kr, Ws, ring, Cs, p.MG, p.stages, p.kc, ps_mbar, phases);
      PS_ACC(9);
      constexpr int UC = NT * 8 / 3;  // == U
      if (vec4) {
        // a thread's quads of four neighbouring units, EQ at a time: first
        // every load they need, then the arithmetic, so the loads' latencies
        // overlap
        constexpr int QC = UC / 4;
        constexpr int EQ = 3;
        for (int base = tid; base < BR * QC; base += EQ * PS_BLOCK) {
          float4 xr[EQ], xz[EQ], xn[EQ], hp[EQ];
          int len[EQ];
          unsigned live = 0u;
#pragma unroll
          for (int e = 0; e < EQ; ++e) {
            const int idx = base + e * PS_BLOCK;
            const int r = idx / QC, q = idx - r * QC;
            const int b = row0 + r, j = j0 + 4 * q;
            if (idx < BR * QC && b < B && j < H) {  // H % 4 == 0: a whole quad
              const bf16* gxr = gx + ((size_t)t * B + b) * G + j;
              xr[e] = ps_load_bf16x4(gxr);
              xz[e] = ps_load_bf16x4(gxr + H);
              xn[e] = ps_load_bf16x4(gxr + 2 * H);
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
            const float4 bir = *reinterpret_cast<const float4*>(bih + j);
            const float4 biz = *reinterpret_cast<const float4*>(bih + H + j);
            const float4 bin = *reinterpret_cast<const float4*>(bih + 2 * H + j);
            const float4 bhr = *reinterpret_cast<const float4*>(bhh + j);
            const float4 bhz = *reinterpret_cast<const float4*>(bhh + H + j);
            const float4 bhn = *reinterpret_cast<const float4*>(bhh + 2 * H + j);
            const float pr[4] = {xr[e].x + bir.x + bhr.x, xr[e].y + bir.y + bhr.y,
                                 xr[e].z + bir.z + bhr.z, xr[e].w + bir.w + bhr.w};
            const float pz[4] = {xz[e].x + biz.x + bhz.x, xz[e].y + biz.y + bhz.y,
                                 xz[e].z + biz.z + bhz.z, xz[e].w + biz.w + bhz.w};
            const float pn[4] = {xn[e].x + bin.x, xn[e].y + bin.y, xn[e].z + bin.z,
                                 xn[e].w + bin.w};
            const float gn0[4] = {bhn.x, bhn.y, bhn.z, bhn.w};
            const float hpv[4] = {hp[e].x, hp[e].y, hp[e].z, hp[e].w};
            float hv[4], ov[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int u = 4 * q + k;
              const float ghr = ps_sum_splits(Cs, KS, BR, ldc, r, u);
              const float ghz = ps_sum_splits(Cs, KS, BR, ldc, r, UC + u);
              const float ghn = gn0[k] + ps_sum_splits(Cs, KS, BR, ldc, r, 2 * UC + u);
              const float rg = ps_sigmoid(pr[k] + ghr);
              const float zg = ps_sigmoid(pz[k] + ghz);
              const float ng = ps_tanh(pn[k] + rg * ghn);
              const float hn = (1.0f - zg) * ng + zg * hpv[k];
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
          const float ghr = bhh[j] + ps_sum_splits(Cs, KS, BR, ldc, r, u);
          const float ghz = bhh[H + j] + ps_sum_splits(Cs, KS, BR, ldc, r, UC + u);
          const float ghn = bhh[2 * H + j] + ps_sum_splits(Cs, KS, BR, ldc, r, 2 * UC + u);
          const bf16* gxr = gx + ((size_t)t * B + b) * G;
          const float rg = ps_sigmoid(__bfloat162float(gxr[j]) + bih[j] + ghr);
          const float zg = ps_sigmoid(__bfloat162float(gxr[H + j]) + bih[H + j] + ghz);
          const float ng =
              ps_tanh(__bfloat162float(gxr[2 * H + j]) + bih[2 * H + j] + rg * ghn);
          const size_t hi = (size_t)b * H + j;
          const float hp = h32[hi];
          const float hn = (1.0f - zg) * ng + zg * hp;
          const bool valid = lengths[b] > t;
          const float hnext = valid ? hn : hp;
          h32[hi] = hnext;
          hb_out[hi] = __float2bfloat16(hnext);
          out[((size_t)t * B + b) * H + j] = __float2bfloat16(valid ? hn : 0.0f);
        }
      }
      __syncthreads();  // Cs lies over the ring of the next product
      PS_ACC(3);
    }
  }
}

// Host entry, persistent design, for `chains` = 1 or 2 chains that share T,
// B, H and lengths (gru_scan: one chain; gru_scan_bidi: the two directions of
// a layer): every per-chain pointer has a second one, ignored when chains =
// 1. h32_c holds h0 on entry and h_last on exit; buffer 0 of h16 holds
// bf16(h0) of each chain. w_hht_c is w_hh transposed (3H, H). The plan (U,
// MG, stages, kc, bpd, smem bytes, and dot: the product on the CUDA cores for
// B <= PS_DOT_ROWS) comes from ops/persist_plan.py; the launch is refused with
// an error code if the device cannot hold the grid.
extern "C" int gru_scan_persist_launch(
    const void* gx0, const void* gx1, const void* lengths, const void* w_hht0,
    const void* w_hht1, const void* b_ih0, const void* b_ih1, const void* b_hh0,
    const void* b_hh1,
    void* h32_0, void* h32_1,   // (B, H) f32 each
    void* h16,                  // (2 buffers, chains, B, H) bf16
    void* out0, void* out1,     // (T, B, H) bf16 each
    void* barrier,              // (chains,) uint32, zeroed
    int T, int B, int H, int reverse0, int reverse1, int chains, int U, int MG,
    int stages, int kc, int bpd, int smem, int dot, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((chains != 1 && chains != 2) || U % 8 != 0 || (MG != 1 && MG != 2) ||
      stages < 2 || stages > PS_MAX_STAGES || (kc != 32 && kc != 64 && kc != 128) ||
      bpd * U < H || (bpd - 1) * U >= H || (dot && (B > PS_DOT_ROWS || MG != 1)))
    return (int)cudaErrorInvalidValue;
  GruScanPersistArgs p;
  const void* gx[2] = {gx0, gx1};
  const void* whht[2] = {w_hht0, w_hht1};
  const void* bih[2] = {b_ih0, b_ih1};
  const void* bhh[2] = {b_hh0, b_hh1};
  void* h32[2] = {h32_0, h32_1};
  void* out[2] = {out0, out1};
  const int reverse[2] = {reverse0, reverse1};
  for (int c = 0; c < 2; ++c) {
    const int k = c < chains ? c : 0;
    p.gx[c] = static_cast<const bf16*>(gx[k]);
    p.whht[c] = static_cast<const bf16*>(whht[k]);
    p.bih[c] = static_cast<const float*>(bih[k]);
    p.bhh[c] = static_cast<const float*>(bhh[k]);
    p.h32[c] = static_cast<float*>(h32[k]);
    p.out[c] = static_cast<bf16*>(out[k]);
    p.reverse[c] = reverse[k] ? 1 : 0;
  }
  p.lengths = static_cast<const int*>(lengths);
  p.hb = static_cast<bf16*>(h16);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.chains = chains;
  p.T = T; p.B = B; p.H = H;
  p.U = U; p.MG = MG; p.stages = stages; p.kc = kc; p.bpd = bpd; p.dot = dot ? 1 : 0;
  p.Kr = (H + 63) / 64 * 64;
  p.ws_off = smem - 3 * U * p.Kr * 2;
  const int BR = MG * 64;
  const int KCB = 2 / MG * kc;  // depth of a ring chunk
  if (KCB % PS_BOX != 0 || p.ws_off < stages * BR * KCB * 2 ||
      p.ws_off < 2 / MG * BR * (3 * U + 1) * 4 || p.ws_off % 1024 != 0 ||
      (dot && p.ws_off < B * p.Kr * 2 + B * (3 * U + 1) * 4))
    return (int)cudaErrorInvalidValue;
  // hb: (2 buffers x chains, B, H)
  CUtensorMap hb_map = {};
  p.tma = ps_tma_ok(h16, H) ? 1 : 0;
  if (p.tma) {
    const int rc = ps_make_tmap(&hb_map, h16, H, B, 2 * chains, BR);
    if (rc != 0) return rc;
  }
  void* args[] = {&p, &hb_map};
  const void* kernel = nullptr;
  switch (3 * U / 8) {
    case 3: kernel = (const void*)gru_scan_persist_kernel<3>; break;
    case 6: kernel = (const void*)gru_scan_persist_kernel<6>; break;
    case 9: kernel = (const void*)gru_scan_persist_kernel<9>; break;
    case 12: kernel = (const void*)gru_scan_persist_kernel<12>; break;
    case 15: kernel = (const void*)gru_scan_persist_kernel<15>; break;
    case 18: kernel = (const void*)gru_scan_persist_kernel<18>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return ps_coop_launch(kernel, chains * bpd, PS_BLOCK, smem, args, s);
}
