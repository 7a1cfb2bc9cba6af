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
//   at once, before the walk, as one tiled WMMA GEMM (gru_proj_kernel) of
//   2*T*B*H*3H operations, bound by the tensor cores. It writes gh into the
//   dgx output buffer: each (t, b, j) is read back and overwritten with the
//   gate gradient by the one thread that owns it, so the walk needs no
//   (T, B, 3H) scratch of its own.
// - The walk is T dependent steps, each a (B, 3H) x (3H, H) product against
//   w_hh^T that needs all of the previous step's dgh: blocks of one launch
//   cannot wait for each other, so the launch boundary orders the steps and
//   the host loop launches gru_bwd_step_kernel T + 1 times. A block owns 16
//   hidden units j for 64 batch rows. It first finishes the previous step's
//   carry for its units, dh = partial + bf16(dgh_prev) @ w_hh^T[:, j], then
//   applies step t's elementwise gradient at its units and leaves, for the
//   next launch, dgh_t in bf16 and the partial carry dhnew z + (1 - m) dh.
//   Both ping-pong between two buffers. The last launch (t < 0) only
//   finishes the carry: that is dh0. w_hh^T (8.6 MB at H=1200, 24 MB at
//   H=2000) stays in the 50 MB L2 across steps, so a step is bound by L2
//   reads of its 3H-deep slice, the unpipelined load-then-multiply loop and
//   the launch itself, not by HBM. A persistent kernel with w_hh^T resident
//   in shared memory across the SMs is the later, faster design.

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
// Host entry: one chain's backward walk, on the caller's stream. part holds
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
  dim3 pgrid((N + P_BN - 1) / P_BN, (M + P_BM - 1) / P_BM, 1);
  gru_proj_kernel<<<pgrid, P_THREADS, 0, s>>>(
      static_cast<const bf16*>(hprev), static_cast<const bf16*>(w_hh),
      static_cast<const bf16*>(w_hh), static_cast<float*>(dgx), M, N, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

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
