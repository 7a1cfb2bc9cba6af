// Both chains of a bidirectional GRU layer over precomputed input
// projections, in one launch per step, for Hopper: the step design of
// ops/gru_cuda.py:gru_scan_bidi. Its persistent design, which the plan takes
// wherever a chain's slice fits, is gru_scan.cu's kernel over two chains.
//
// Replaces danspeech_tpu/ops/pallas_gru.py:gru_scan_bidi (kernel body
// _gru_bidi_step_kernel). Same contract:
//   gx_f, gx_b (T, B, 3H) bf16, the bias-free projections x @ w_ih of the
//   two directions in natural time order; lengths (B,) int32; w_hh_{f,b}
//   (H, 3H) bf16; b_ih_{f,b}, b_hh_{f,b} (3H,) f32, b_ih added when gx is
//   read; h0_{f,b} (B, H) f32;
//   gh = bf16(h) @ w_hh accumulated in f32, b_hh_n stays inside r * gh_n;
//   gates and the carried state in f32; out (2, T, B, H) bf16 with exact
//   zeros where t >= length. At step s the forward chain is at t = s and
//   the backward chain at t = T-1-s (no reversed copy of gx); the backward
//   chain holds its state at h0 until t < length. h_last is the f32 state
//   after the walk (for the backward chain, the state at t = 0).
//
// What bounds it on an H100, and what this design does about it:
// - T dependent steps, each a (B, H) x (H, 3H) product per direction:
//   2*2*T*B*H*3H operations. Every step needs all of h_{t-1} and blocks of
//   one launch cannot wait for each other, so the launch boundary orders
//   the steps: the host loop below launches gru_scan_bidi_step_kernel T
//   times on the caller's stream, the direction being the grid's z
//   dimension, so a layer costs T launches and not 2T, and the two chains'
//   blocks fill the card together.
// - Each block owns a gate-aligned slice of J hidden units (columns j, H+j,
//   2H+j of its direction's w_hh) for BR batch rows, computes that slice of
//   bf16(h) @ w_hh with WMMA and applies the gates, the length mask, the out
//   write and the h update in its epilogue. h ping-pongs between two
//   buffers (the f32 state and the bf16 copy that the next step's product
//   reads). Both w_hh (17 MB at H=1200) stay in the 50 MB L2 across steps,
//   so a step is bound by L2 reads of w_hh, its unpipelined
//   load-then-multiply loop and the launch itself, not by HBM. Measured by
//   chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, T=401, B=128,
//   H=1200: 22.8-23.8 ms, against 6.9 ms for the persistent design (17.1 us
//   a step) and 8.9-17.5 ms for cuDNN's bidirectional GRU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define S_J 16        // hidden units per block (one WMMA tile per gate)
#define S_BR 64       // batch rows per block (one 16-row WMMA tile per warp)
#define S_KC 64       // depth of one shared-memory chunk of the product
#define S_PAD 8
#define S_THREADS 128

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(S_THREADS)
gru_scan_bidi_step_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,  // (T, B, 3H)
    const int* __restrict__ lengths,                               // (B,)
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
  const size_t doff = (size_t)dir * B * H;  // this direction's state

  const bf16* __restrict__ gx = dir == 0 ? gx_f : gx_b;
  const bf16* __restrict__ whh = dir == 0 ? whh_f : whh_b;
  const float* __restrict__ bih = dir == 0 ? bih_f : bih_b;
  const float* __restrict__ bhh = dir == 0 ? bhh_f : bhh_b;
  const bf16* __restrict__ hb = hb_in + doff;
  // this warp's 16 rows hold at least one real batch row (warp-uniform)
  const bool active = b0 + warp * 16 < B;
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
    size_t hi = doff + (size_t)b * H + j;
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
// Host entry: one layer, on the caller's stream. h32/h16 hold two buffers of
// (2 directions, B, H); buffer 0 holds h0_f, h0_b (f32 and their bf16 copies)
// on entry, and buffer T % 2 holds h_last on exit. Returns cudaGetLastError()
// of the first launch that failed, else 0.
// ---------------------------------------------------------------------------

extern "C" int gru_scan_bidi_launch(
    const void* gx_f, const void* gx_b, const void* lengths,
    const void* w_hh_f, const void* w_hh_b, const void* b_ih_f,
    const void* b_ih_b, const void* b_hh_f, const void* b_hh_b,
    void* h32,   // (2 buffers, 2 dirs, B, H) f32
    void* h16,   // (2 buffers, 2 dirs, B, H) bf16
    void* out,   // (2, T, B, H) bf16
    int T, int B, int H, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t hsz = (size_t)2 * B * H;
  float* hf = static_cast<float*>(h32);
  bf16* hb = static_cast<bf16*>(h16);
  dim3 grid((H + S_J - 1) / S_J, (B + S_BR - 1) / S_BR, 2);
  for (int step = 0; step < T; ++step) {
    const int src = step & 1, dst = src ^ 1;
    gru_scan_bidi_step_kernel<<<grid, S_THREADS, 0, s>>>(
        static_cast<const bf16*>(gx_f), static_cast<const bf16*>(gx_b),
        static_cast<const int*>(lengths),
        static_cast<const bf16*>(w_hh_f), static_cast<const bf16*>(w_hh_b),
        static_cast<const float*>(b_ih_f), static_cast<const float*>(b_ih_b),
        static_cast<const float*>(b_hh_f), static_cast<const float*>(b_hh_b),
        hf + src * hsz, hb + src * hsz, hf + dst * hsz, hb + dst * hsz,
        static_cast<bf16*>(out), step, T, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
