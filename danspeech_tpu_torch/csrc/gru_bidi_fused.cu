// Bidirectional GRU layer (projection + both recurrence chains) for Hopper.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:gru_scan_bidi_fused (kernel body
// _gru_bidi_fused_kernel). Same contract:
//   x (T, B, D) bf16, w_ih_{f,b} (D, 3H) bf16, w_hh_{f,b} (H, 3H) bf16,
//   b_ih_{f,b}, b_hh_{f,b} (3H,) f32, lengths (B,) int32, h0 = 0;
//   gx = x @ w_ih accumulated and kept in f32, b_ih added when gx is read;
//   gh = bf16(h) @ w_hh accumulated in f32, b_hh_n stays inside r * gh_n;
//   gates and the h update in f32; out (2, T, B, H) bf16 with exact zeros
//   where t >= length; the backward chain walks t = T-1 .. 0 and holds its
//   state at h0 until t < length (no reversed copy of x). h_last is the f32
//   state after the walk.
//
// What bounds it on an H100, and what this design does about it:
// - Projection: 2 * T*B*D*3H multiply-adds per direction, ~1.5 TFLOP at the
//   flagship's first layer (T=401, B=128, D=2016, H=1200): bound by the
//   tensor cores. gru_proj_kernel is a tiled bf16 WMMA GEMM (f32 accumulate)
//   over both directions in one grid (blockIdx.z = direction). gx goes to
//   device memory in f32 (2*T*B*3H*4 bytes, 1.5 GB at the flagship shape):
//   the TPU kernel keeps it in VMEM, which one SM's 227 KB cannot do here.
// - Recurrence: T dependent steps, each a (B, H) x (H, 3H) product per
//   direction. Every step needs all of h_{t-1}, and blocks of one launch
//   cannot wait for each other, so the launch boundary orders the steps:
//   the host loop below launches gru_step_kernel T times on the caller's
//   stream. Each block owns a gate-aligned slice of J hidden units
//   (columns j, H+j, 2H+j of w_hh) for BR batch rows of one direction,
//   computes that slice of bf16(h) @ w_hh with WMMA and applies the gates,
//   the length mask, the out write and the h update in its epilogue. h
//   ping-pongs between two buffers (f32 state + its bf16 copy that the next
//   step's product reads). Both w_hh matrices (17 MB in bf16) stay in the
//   50 MB L2 across steps, so a step is bound by L2 reads and the launch
//   itself, not by HBM. A persistent kernel with w_hh resident in shared
//   memory across the SMs is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#include "gru_proj.cuh"

// ---------------------------------------------------------------------------
// One recurrence step of both directions
// ---------------------------------------------------------------------------

#define S_J 16        // hidden units per block (one WMMA tile per gate)
#define S_BR 64       // batch rows per block (one 16-row WMMA tile per warp)
#define S_KC 64       // depth of one shared-memory chunk of the product
#define S_PAD 8
#define S_THREADS 128

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(S_THREADS)
gru_step_kernel(const float* __restrict__ gx,     // (2, T, B, 3H)
                const int* __restrict__ lengths,  // (B,)
                const bf16* __restrict__ whh_f, const bf16* __restrict__ whh_b,
                const float* __restrict__ bih_f, const float* __restrict__ bih_b,
                const float* __restrict__ bhh_f, const float* __restrict__ bhh_b,
                const float* __restrict__ h_in,    // (2, B, H) f32
                const bf16* __restrict__ hb_in,    // (2, B, H) bf16
                float* __restrict__ h_out,         // (2, B, H) f32
                bf16* __restrict__ hb_out,         // (2, B, H) bf16
                bf16* __restrict__ out,            // (2, T, B, H)
                int step, int T, int B, int H) {
  __shared__ __align__(32) bf16 Ah[S_BR][S_KC + S_PAD];
  __shared__ __align__(32) bf16 Bw[S_KC][3 * S_J + S_PAD];
  __shared__ __align__(32) float Cs[S_BR][3 * S_J + 4];

  const int dir = blockIdx.z;
  const int j0 = blockIdx.x * S_J;
  const int b0 = blockIdx.y * S_BR;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int G = 3 * H;
  const int t = dir == 0 ? step : T - 1 - step;

  const bf16* __restrict__ whh = dir == 0 ? whh_f : whh_b;
  const float* __restrict__ bih = dir == 0 ? bih_f : bih_b;
  const float* __restrict__ bhh = dir == 0 ? bhh_f : bhh_b;
  const bf16* __restrict__ hb = hb_in + (size_t)dir * B * H;
  const bool vec = (H % 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(hb) % 16) == 0 &&
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
            *reinterpret_cast<const uint4*>(hb + (size_t)gb * H + gk);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gb < B && gk + e < H) ? hb[(size_t)gb * H + gk + e]
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
    const float* gxr = gx + (((size_t)dir * T + t) * B + b) * G;
    float ghr = Cs[r][cj] + bhh[j];
    float ghz = Cs[r][S_J + cj] + bhh[H + j];
    float ghn = Cs[r][2 * S_J + cj] + bhh[2 * H + j];
    float xr = gxr[j] + bih[j];
    float xz = gxr[H + j] + bih[H + j];
    float xn = gxr[2 * H + j] + bih[2 * H + j];
    float rg = sigmoidf_(xr + ghr);
    float zg = sigmoidf_(xz + ghz);
    float ng = tanhf(xn + rg * ghn);
    size_t hi = ((size_t)dir * B + b) * H + j;
    float hp = h_in[hi];
    float hn = (1.0f - zg) * ng + zg * hp;
    bool valid = lengths[b] > t;
    float hnext = valid ? hn : hp;
    h_out[hi] = hnext;
    hb_out[hi] = __float2bfloat16(hnext);
    out[(((size_t)dir * T + t) * B + b) * H + j] =
        __float2bfloat16(valid ? hn : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// Host entry: one layer, on the caller's stream. Returns cudaGetLastError()
// of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_bidi_fused_launch(
    const void* x, const void* lengths, const void* w_ih_f, const void* w_ih_b,
    const void* w_hh_f, const void* w_hh_b, const void* b_ih_f,
    const void* b_ih_b, const void* b_hh_f, const void* b_hh_b,
    void* gx,    // (2, T, B, 3H) f32 scratch
    void* h32,   // (2 buffers, 2 dirs, B, H) f32, buffer 0 zeroed
    void* h16,   // (2 buffers, 2 dirs, B, H) bf16, buffer 0 zeroed
    void* out,   // (2, T, B, H) bf16
    int T, int B, int D, int H, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = T * B;
  const int N = 3 * H;
  dim3 pgrid((N + P_BN - 1) / P_BN, (M + P_BM - 1) / P_BM, 2);
  gru_proj_kernel<<<pgrid, P_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih_f),
      static_cast<const bf16*>(w_ih_b), static_cast<float*>(gx), M, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t hsz = (size_t)2 * B * H;
  float* hf = static_cast<float*>(h32);
  bf16* hb = static_cast<bf16*>(h16);
  dim3 sgrid((H + S_J - 1) / S_J, (B + S_BR - 1) / S_BR, 2);
  for (int step = 0; step < T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    gru_step_kernel<<<sgrid, S_THREADS, 0, s>>>(
        static_cast<const float*>(gx), static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hh_f), static_cast<const bf16*>(w_hh_b),
        static_cast<const float*>(b_ih_f), static_cast<const float*>(b_ih_b),
        static_cast<const float*>(b_hh_f), static_cast<const float*>(b_hh_b),
        hf + src * hsz, hb + src * hsz, hf + dst * hsz, hb + dst * hsz,
        static_cast<bf16*>(out), step, T, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
