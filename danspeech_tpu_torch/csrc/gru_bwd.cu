// GRU backward walk (training) for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:gru_bwd_scan (kernel body
// _gru_bwd_kernel). Same contract, all streams in natural time order:
//   gx (T, B, 3H) bf16, the bias-free projection x @ w_ih; hprev (T, B, H)
//   bf16, the state before each step in chain order; dout (T, B, H) f32;
//   lengths (B,) int32; w_hh (H, 3H) and its transpose (3H, H) bf16; b_ih,
//   b_hh (3H,) f32; dh_last (B, H) f32.
//   Per step t, with m = length > t:
//     gh = hprev_t @ w_hh + b_hh, r, z, n recomputed as in the forward
//     (b_ih added to gx, b_hh_n inside r * gh_n);
//     dhnew = m * (dh + dout_t); dn = dhnew (1 - z); dz = dhnew (hprev - n);
//     dpre_n = dn (1 - n^2); dpre_r = dpre_n gh_n r (1 - r);
//     dpre_z = dz z (1 - z); dghn = dpre_n r;
//     dgx_t = [dpre_r, dpre_z, dpre_n]; dgh_t = [dpre_r, dpre_z, dghn];
//     dh <- dhnew z + bf16(dgh_t) @ w_hh^T + (1 - m) dh.
//   reverse walks t = T-1 .. 0 (the backward of the forward chain), else
//   0 .. T-1 (the backward of the reverse-time chain). dh starts at dh_last
//   and ends as dh0. Steps past a row's length write zeros to dgx and dghn
//   and pass dh through.
//
// What bounds it on an H100, and what this design does about it:
// - Two products per step. The gate recompute hprev_t @ w_hh does not depend
//   on the walk (hprev is the stored forward stream), so it runs for all t
//   at once, before the walk, as one tiled tensor-core GEMM of 2*T*B*H*3H
//   operations, bound by the tensor cores (gru_proj.cuh: on wgmma fed by the
//   copy engine when w_hh^T is given and hprev's rows start on 16 bytes,
//   else cp.async + mma.m16n8k16). It writes gh into the dgx output buffer:
//   each (t, b, j) is read back and overwritten with the gate gradient by
//   the one thread that owns it, so the walk needs no (T, B, 3H) scratch of
//   its own.
// - The walk is T dependent steps, each a (B, 3H) x (3H, H) product against
//   w_hh^T that needs all of the previous step's dgh: 0.28 GFLOP and 230 KB
//   of dgh a step at B = 32, H = 1200. What a step costs is latency (a
//   barrier, an L2 round trip, one pass over the weights), not bytes or
//   operations. A block owns U hidden units j. It first finishes the
//   previous step's carry for its units, dh = partial + bf16(dgh_prev) @
//   w_hh^T[:, j], then applies step t's elementwise gradient at its units
//   and leaves dgh_t in bf16 (ping-pong between two buffers) and the partial
//   carry dhnew z + (1 - m) dh (f32, owned in place by one thread). One more
//   step (t < 0) only finishes the carry: that is dh0. Two designs, chosen
//   on the host by ops/persist_plan.py from the shape and the device's SM
//   count and shared memory:
//   * persistent (gru_bwd_persist_kernel, persist.cuh): ONE cooperative
//     launch walks all T + 1 steps of one chain, or of both chains of a
//     bidirectional layer (the chain as the slow grid index, each chain with
//     its own barrier). A block keeps its U columns of w_hh^T, 3H deep, in
//     shared memory for the whole walk (they are rows j of w_hh itself, so
//     no transposed copy is made): U = 16 at H = 1200 (75 blocks, 117 KB) and
//     at H = 2000 (125 blocks, 193 KB), U = 24 for two chains at H = 1200
//     (100 blocks). Per step: the barrier; dgh of the previous step streams
//     from L2 through a TMA ring beside the slice, fed by a ninth warp, while
//     the two warpgroups multiply with wgmma.m64nUk16. At B = 32 one
//     warpgroup's 64 rows hold the batch, so the two split the 3H depth and
//     their partial sums are added in a fixed order in shared memory (no
//     float atomics). The streams of the next step (gx, hprev, dout, gh) do
//     not depend on the carry: they are prefetched into L2 during the
//     product.
//   * step (gru_bwd_step_kernel): one launch per time step, the launch
//     boundary as the barrier, each block rereading its slice of w_hh^T
//     from L2. Kept for widths whose slices do not fit an SM's shared memory.
//   Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, T=401,
//   B=32: H=1200 persistent 6.7 ms (walk 6.3 ms = 15.8 us a step, recompute
//   0.2 ms), 4.2 ms a chain when both chains share a launch, step design 33
//   ms, cuDNN's whole GRU backward 11-17 ms in bf16 and 13-14 ms in float16,
//   bound 0.12 ms; H=2000 15.4-15.9 ms against 52 ms (step) and 12-19 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "gru_proj.cuh"

#define W_J 16        // hidden units per block (one WMMA tile)
#define W_BR 64       // batch rows per block (one 16-row WMMA tile per warp)
#define W_KC 64       // depth of one shared-memory chunk of the product
#define W_PAD 8
#define W_THREADS 128

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(W_THREADS)
gru_bwd_step_kernel(const bf16* __restrict__ gx,       // (T, B, 3H)
                    const bf16* __restrict__ hprev,    // (T, B, H)
                    const float* __restrict__ dout,    // (T, B, H)
                    const int* __restrict__ lengths,   // (B,)
                    const bf16* __restrict__ whht,     // (3H, H)
                    const float* __restrict__ bih,     // (3H,)
                    const float* __restrict__ bhh,     // (3H,)
                    const float* __restrict__ part_in,   // (B, H) f32
                    const bf16* __restrict__ dgh_in,     // (B, 3H) bf16
                    float* __restrict__ part_out,        // (B, H) f32
                    bf16* __restrict__ dgh_out,          // (B, 3H) bf16
                    float* dgx,                 // (T, B, 3H): gh in, dgx out
                    float* __restrict__ dghn,   // (T, B, H)
                    int t, int B, int H) {
  __shared__ __align__(32) bf16 Ad[W_BR][W_KC + W_PAD];
  __shared__ __align__(32) bf16 Bw[W_KC][W_J + W_PAD];
  __shared__ __align__(32) float Cs[W_BR][W_J + 4];

  const int j0 = blockIdx.x * W_J;
  const int b0 = blockIdx.y * W_BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int G = 3 * H;
  // this warp's 16 rows hold at least one real batch row (warp-uniform)
  const bool active = b0 + warp * 16 < B;
  const bool vec = (H % 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(dgh_in) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(whht) % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);

  for (int k0 = 0; k0 < G; k0 += W_KC) {
    // dgh tile: 64 rows x 64 k = 512 chunks of 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = tid + i * W_THREADS;
      int row = idx >> 3;
      int col = (idx & 7) * 8;
      int gb = b0 + row, gk = k0 + col;
      bf16* dst = &Ad[row][col];
      if (vec && gb < B && gk + 8 <= G) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(dgh_in + (size_t)gb * G + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gb < B && gk + e < G) ? dgh_in[(size_t)gb * G + gk + e]
                                           : __float2bfloat16(0.0f);
      }
    }
    // w_hh^T slice: 64 k x 16 units = 128 chunks of 8
    {
      int row = tid >> 1;
      int col = (tid & 1) * 8;
      int gk = k0 + row, gj = j0 + col;
      bf16* dst = &Bw[row][col];
      const bf16* src = whht + (size_t)gk * H + gj;
      if (vec && gk < G && gj + 8 <= H) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < G && gj + e < H) ? src[e] : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < W_KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, &Ad[warp * 16][kk], W_KC + W_PAD);
        wmma::load_matrix_sync(bfr, &Bw[kk][0], W_J + W_PAD);
        wmma::mma_sync(acc, af, bfr, acc);
      }
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&Cs[warp * 16][0], acc, W_J + 4, wmma::mem_row_major);
  __syncthreads();

  // epilogue: finish the carry, then step t's gradients for 64 x 16 units
#pragma unroll
  for (int e = 0; e < (W_BR * W_J) / W_THREADS; ++e) {
    int idx = tid + e * W_THREADS;
    int r = idx / W_J, cj = idx % W_J;
    int b = b0 + r, j = j0 + cj;
    if (b >= B || j >= H) continue;
    size_t hi = (size_t)b * H + j;
    float dh = part_in[hi] + Cs[r][cj];
    if (t < 0) {  // after the last step: the carry is dh0
      part_out[hi] = dh;
      continue;
    }
    size_t row = (size_t)t * B + b;
    float* g = dgx + row * G;
    const bf16* gxr = gx + row * G;
    float hp = __bfloat162float(hprev[row * H + j]);
    float ghr = g[j] + bhh[j];
    float ghz = g[H + j] + bhh[H + j];
    float ghn = g[2 * H + j] + bhh[2 * H + j];
    float xr = __bfloat162float(gxr[j]) + bih[j];
    float xz = __bfloat162float(gxr[H + j]) + bih[H + j];
    float xn = __bfloat162float(gxr[2 * H + j]) + bih[2 * H + j];
    float rg = sigmoidf_(xr + ghr);
    float zg = sigmoidf_(xz + ghz);
    float ng = tanhf(xn + rg * ghn);

    bool valid = lengths[b] > t;
    float dhnew = valid ? dh + dout[row * H + j] : 0.0f;
    float dn = dhnew * (1.0f - zg);
    float dz = dhnew * (hp - ng);
    float dpre_n = dn * (1.0f - ng * ng);
    float dpre_r = dpre_n * ghn * rg * (1.0f - rg);
    float dpre_z = dz * zg * (1.0f - zg);
    float dghn_v = dpre_n * rg;

    g[j] = dpre_r;
    g[H + j] = dpre_z;
    g[2 * H + j] = dpre_n;
    dghn[row * H + j] = dghn_v;
    bf16* dg = dgh_out + (size_t)b * G;
    dg[j] = __float2bfloat16(dpre_r);
    dg[H + j] = __float2bfloat16(dpre_z);
    dg[2 * H + j] = __float2bfloat16(dghn_v);
    part_out[hi] = dhnew * zg + (valid ? 0.0f : dh);
  }
}

// ---------------------------------------------------------------------------
// Host entry, step design: one chain's backward walk, on the caller's stream. part holds
// two buffers of (B, H) f32 and dgh two of (B, 3H) bf16; on entry buffer 0 of
// part holds dh_last and buffer 0 of dgh zeros; on exit buffer (T + 1) % 2 of
// part holds dh0. Returns cudaGetLastError() of the first launch that failed,
// else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_bwd_launch(
    const void* gx, const void* hprev, const void* dout, const void* lengths,
    const void* w_hh, const void* w_hht, const void* b_ih, const void* b_hh,
    void* part,   // (2 buffers, B, H) f32
    void* dgh,    // (2 buffers, B, 3H) bf16
    void* dgx,    // (T, B, 3H) f32
    void* dghn,   // (T, B, H) f32
    int T, int B, int H, int reverse, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = T * B;
  const int N = 3 * H;
  // gh = hprev @ w_hh for every step, into the dgx buffer
  int rc = gru_proj_launch(
      static_cast<const bf16*>(hprev), static_cast<const bf16*>(w_hh),
      static_cast<const bf16*>(w_hh), static_cast<float*>(dgx), M, N, H, 1, s);
  if (rc != 0) return rc;
  cudaError_t err;

  const size_t psz = (size_t)B * H;
  const size_t gsz = (size_t)B * N;
  float* pf = static_cast<float*>(part);
  bf16* gb = static_cast<bf16*>(dgh);
  dim3 grid((H + W_J - 1) / W_J, (B + W_BR - 1) / W_BR);
  for (int step = 0; step <= T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    const int t = step == T ? -1 : (reverse ? T - 1 - step : step);
    gru_bwd_step_kernel<<<grid, W_THREADS, 0, s>>>(
        static_cast<const bf16*>(gx), static_cast<const bf16*>(hprev),
        static_cast<const float*>(dout), static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hht), static_cast<const float*>(b_ih),
        static_cast<const float*>(b_hh), pf + src * psz, gb + src * gsz,
        pf + dst * psz, gb + dst * gsz, static_cast<float*>(dgx),
        static_cast<float*>(dghn), t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Persistent design: all T + 1 steps of one or two chains in one cooperative
// launch
// ---------------------------------------------------------------------------

struct GruBwdPersistArgs {
  const bf16* gx[2];      // (T, B, 3H)
  const bf16* hprev[2];   // (T, B, H)
  const float* dout[2];   // (T, B, H)
  const int* lengths;     // (B,)
  const bf16* whh[2];     // (H, 3H): row j is column j of w_hh^T, 3H deep
  const float* bih[2];
  const float* bhh[2];
  float* part[2];         // (B, H) f32: dh_last on entry, dh0 on exit
  bf16* dgh;              // (2 buffers, chains, B, 3H) bf16 (step 0 reads none)
  float* dgx[2];          // (T, B, 3H): gh in, dgx out
  float* dghn[2];         // (T, B, H)
  unsigned int* barrier;  // (chains,) zeros on entry
  int reverse[2];
  int chains;
  int T, B, H;
  int U;       // hidden units per block (a multiple of 8)
  int MG;      // warpgroups along the rows of a row block (64 rows each): 1 or 2
  int stages;  // ring stages: 2 .. PS_MAX_STAGES
  int kc;      // depth one warpgroup covers of a ring chunk: 128, 64 or 32
  int bpd;     // blocks per chain
  int Kr;      // 3H rounded up to 64
  int ws_off;  // bytes from the start of shared memory (the ring) to the slice
  int tma;     // dgh can be read by the copy engine (else element by element)
};

template <int NT>  // U / 8: 8-column MMA tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
gru_bwd_persist_kernel(const GruBwdPersistArgs p,
                       const __grid_constant__ CUtensorMap dgh_map) {
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
  float* Cs = reinterpret_cast<float*>(ring);
  const int BR = p.MG * 64;
  const int KS = 2 / p.MG;  // planes of partial sums: one a depth split
  const int ldc = NT * 8 + 1;
  const int nrb = (B + BR - 1) / BR;

  // the epilogue's input streams do not alias its outputs (gh / dgx share a
  // buffer and stay unqualified): their loads may be issued together
  const bf16* __restrict__ gx = p.gx[ch];
  const bf16* __restrict__ hprev = p.hprev[ch];
  const float* __restrict__ dout = p.dout[ch];
  const int* __restrict__ lengths = p.lengths;
  const float* __restrict__ bih = p.bih[ch];
  const float* __restrict__ bhh = p.bhh[ch];
  float* part = p.part[ch];
  float* dgx = p.dgx[ch];
  float* __restrict__ dghn = p.dghn[ch];
  const bool reverse = p.reverse[ch] != 0;
  const size_t gsz = (size_t)p.chains * B * G;
  unsigned int* counter = p.barrier + ch;
  const int uw = min(U, H - j0);  // real units of this block

  ps_load_slice(Ws, p.whh[ch], H, G, p.Kr, 1, U, j0);
  ps_ring_init(ring, ps_mbar, p.stages);

  PS_T0();
  for (int step = 0; step <= T; ++step) {
    const int t = step == T ? -1 : (reverse ? T - 1 - step : step);
    const bf16* dgh_in = p.dgh + (step & 1) * gsz + (size_t)ch * B * G;
    bf16* __restrict__ dgh_out =
        p.dgh + ((step & 1) ^ 1) * gsz + (size_t)ch * B * G;
    PS_ACC(0);
    if (step > 0) ps_grid_barrier(counter, (unsigned int)step * p.bpd);
    PS_ACC(1);
    if (step + 1 < T) {
      // the next step's streams do not depend on the carry: bring them into
      // L2 meanwhile (3 gate segments of gx and of gh, hprev, dout per row)
      const int tn = reverse ? t - 1 : t + 1;
      for (int i = tid; i < B * 8; i += PS_BLOCK) {
        const int b = i >> 3, k = i & 7;
        const size_t row = (size_t)tn * B + b;
        const char* q;
        int bytes;
        if (k < 3) {
          q = reinterpret_cast<const char*>(gx + row * G + (size_t)k * H + j0);
          bytes = uw * 2;
        } else if (k < 6) {
          q = reinterpret_cast<const char*>(dgx + row * G + (size_t)(k - 3) * H + j0);
          bytes = uw * 4;
        } else if (k == 6) {
          q = reinterpret_cast<const char*>(hprev + row * H + j0);
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
      // before the first step dgh is zero: the carry is dh_last itself
      PS_ACC(0);
      if (step > 0)
        ps_block_product<NT>(dgh_in, &dgh_map, p.tma, (step & 1) * p.chains + ch, row0,
                             B, G, p.Kr, Ws, ring, Cs, p.MG, p.stages, p.kc, ps_mbar,
                             phases);
      PS_ACC(9);
      // a thread's elements, EP at a time: first every load they need, then
      // the arithmetic, so the loads' latencies overlap
      constexpr int UC = NT * 8;  // == U
      constexpr int EP = 4;
      for (int base = tid; base < BR * UC; base += EP * PS_BLOCK) {
        float dh[EP], ghr[EP], ghz[EP], ghn[EP], xr[EP], xz[EP], xn[EP], hp[EP], dy[EP];
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
              const size_t row = (size_t)t * B + b;
              const float* g = dgx + row * G;
              const bf16* gxr = gx + row * G;
              ghr[e] = g[j];
              ghz[e] = g[H + j];
              ghn[e] = g[2 * H + j];
              xr[e] = __bfloat162float(gxr[j]);
              xz[e] = __bfloat162float(gxr[H + j]);
              xn[e] = __bfloat162float(gxr[2 * H + j]);
              hp[e] = __bfloat162float(hprev[row * H + j]);
              dy[e] = dout[row * H + j];
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
          const size_t row = (size_t)t * B + b;
          float* g = dgx + row * G;
          const float gr = ghr[e] + bhh[j];
          const float gz = ghz[e] + bhh[H + j];
          const float gn = ghn[e] + bhh[2 * H + j];
          const float rg = ps_sigmoid(xr[e] + bih[j] + gr);
          const float zg = ps_sigmoid(xz[e] + bih[H + j] + gz);
          const float ng = ps_tanh(xn[e] + bih[2 * H + j] + rg * gn);

          const bool valid = len[e] > t;
          const float dhnew = valid ? dhv + dy[e] : 0.0f;
          const float dn = dhnew * (1.0f - zg);
          const float dz = dhnew * (hp[e] - ng);
          const float dpre_n = dn * (1.0f - ng * ng);
          const float dpre_r = dpre_n * gn * rg * (1.0f - rg);
          const float dpre_z = dz * zg * (1.0f - zg);
          const float dghn_v = dpre_n * rg;

          g[j] = dpre_r;
          g[H + j] = dpre_z;
          g[2 * H + j] = dpre_n;
          dghn[row * H + j] = dghn_v;
          bf16* dg = dgh_out + (size_t)b * G;
          dg[j] = __float2bfloat16(dpre_r);
          dg[H + j] = __float2bfloat16(dpre_z);
          dg[2 * H + j] = __float2bfloat16(dghn_v);
          part[hi] = dhnew * zg + (valid ? 0.0f : dhv);
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
// walk the gate recompute gh = hprev @ w_hh runs per chain into dgx. part_c
// holds dh_last on entry and dh0 on exit. w_hht_c is the transposed w_hh
// (3H, H) or null: with it, and rows of hprev the copy engine can read, the
// recompute runs on wgmma. The plan (U, MG, stages, kc, bpd, smem bytes) comes
// from ops/persist_plan.py; the launch is refused with an error code if the
// device cannot hold the grid.
extern "C" int gru_bwd_persist_launch(
    const void* gx0, const void* gx1, const void* hprev0, const void* hprev1,
    const void* dout0, const void* dout1, const void* lengths,
    const void* w_hh0, const void* w_hh1, const void* b_ih0, const void* b_ih1,
    const void* b_hh0, const void* b_hh1,
    void* part0, void* part1,   // (B, H) f32 each
    void* dgh,                  // (2 buffers, chains, B, 3H) bf16
    void* dgx0, void* dgx1,     // (T, B, 3H) f32 each
    void* dghn0, void* dghn1,   // (T, B, H) f32 each
    void* barrier,              // (chains,) uint32, zeroed
    const void* w_hht0, const void* w_hht1,
    int T, int B, int H, int reverse0, int reverse1, int chains, int U, int MG,
    int stages, int kc, int bpd, int smem, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if ((chains != 1 && chains != 2) || U % 8 != 0 ||
      (MG != 1 && MG != 2) || stages < 2 || stages > PS_MAX_STAGES ||
      (kc != 32 && kc != 64 && kc != 128) || (2 / MG * kc) % PS_BOX != 0 || bpd * U < H)
    return (int)cudaErrorInvalidValue;

  GruBwdPersistArgs p;
  const void* gx[2] = {gx0, gx1};
  const void* hprev[2] = {hprev0, hprev1};
  const void* dout[2] = {dout0, dout1};
  const void* whh[2] = {w_hh0, w_hh1};
  const void* bih[2] = {b_ih0, b_ih1};
  const void* bhh[2] = {b_hh0, b_hh1};
  void* part[2] = {part0, part1};
  void* dgxs[2] = {dgx0, dgx1};
  void* dghns[2] = {dghn0, dghn1};
  const int reverse[2] = {reverse0, reverse1};
  for (int c = 0; c < 2; ++c) {
    const int k = c < chains ? c : 0;
    p.gx[c] = static_cast<const bf16*>(gx[k]);
    p.hprev[c] = static_cast<const bf16*>(hprev[k]);
    p.dout[c] = static_cast<const float*>(dout[k]);
    p.whh[c] = static_cast<const bf16*>(whh[k]);
    p.bih[c] = static_cast<const float*>(bih[k]);
    p.bhh[c] = static_cast<const float*>(bhh[k]);
    p.part[c] = static_cast<float*>(part[k]);
    p.dgx[c] = static_cast<float*>(dgxs[k]);
    p.dghn[c] = static_cast<float*>(dghns[k]);
    p.reverse[c] = reverse[k];
  }
  p.lengths = static_cast<const int*>(lengths);
  p.dgh = static_cast<bf16*>(dgh);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.chains = chains;
  p.T = T; p.B = B; p.H = H; p.U = U; p.MG = MG; p.stages = stages; p.kc = kc;
  p.bpd = bpd; p.Kr = (3 * H + 63) / 64 * 64;

  // gh = hprev @ w_hh for every step, into the dgx buffers
  const void* whht[2] = {w_hht0, w_hht1};
  for (int c = 0; c < chains; ++c) {
    int rc;
    if (whht[c] != nullptr && ps_tma_ok(p.hprev[c], H) && ps_tma_ok(whht[c], H))
      rc = gru_proj_wgmma_launch(p.hprev[c], static_cast<const bf16*>(whht[c]),
                                 p.dgx[c], T * B, 3 * H, H, 1, s);
    else
      rc = gru_proj_launch(p.hprev[c], p.whh[c], p.whh[c], p.dgx[c], T * B,
                           3 * H, H, 1, s);
    if (rc != 0) return rc;
  }

  p.ws_off = smem - U * p.Kr * 2;
  if (p.ws_off < stages * MG * 64 * (2 / MG * kc) * 2 || p.ws_off % 1024 != 0)
    return (int)cudaErrorInvalidValue;
  // dgh: (2 buffers x chains, B, 3H)
  CUtensorMap dgh_map = {};
  p.tma = ps_tma_ok(dgh, 3 * H) ? 1 : 0;
  if (p.tma) {
    int rc = ps_make_tmap(&dgh_map, dgh, 3 * H, B, 2 * chains, MG * 64);
    if (rc != 0) return rc;
  }
  void* args[] = {&p, &dgh_map};
  const int grid = chains * bpd;
  switch (U / 8) {
    case 1: return ps_coop_launch((const void*)gru_bwd_persist_kernel<1>, grid, PS_BLOCK, smem, args, s);
    case 2: return ps_coop_launch((const void*)gru_bwd_persist_kernel<2>, grid, PS_BLOCK, smem, args, s);
    case 3: return ps_coop_launch((const void*)gru_bwd_persist_kernel<3>, grid, PS_BLOCK, smem, args, s);
    case 4: return ps_coop_launch((const void*)gru_bwd_persist_kernel<4>, grid, PS_BLOCK, smem, args, s);
    case 5: return ps_coop_launch((const void*)gru_bwd_persist_kernel<5>, grid, PS_BLOCK, smem, args, s);
    case 6: return ps_coop_launch((const void*)gru_bwd_persist_kernel<6>, grid, PS_BLOCK, smem, args, s);
    case 7: return ps_coop_launch((const void*)gru_bwd_persist_kernel<7>, grid, PS_BLOCK, smem, args, s);
    case 8: return ps_coop_launch((const void*)gru_bwd_persist_kernel<8>, grid, PS_BLOCK, smem, args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
