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
//   tensor cores. gru_proj_wgmma_kernel (gru_proj.cuh) computes 128 x 240
//   tiles on wgmma.m64n120k16, both operands depth-contiguous in shared
//   memory (w_ih is given transposed), fed by the copy engine (TMA) through a
//   four-stage ring on the word of a third warpgroup, both directions in one
//   grid; x whose rows the copy engine cannot read (D no multiple of 8) takes
//   gru_proj_kernel, the cp.async + mma.m16n8k16 GEMM of the same header. gx
//   goes to device memory in f32 (2*T*B*3H*4 bytes, 1.5 GB at the flagship
//   shape): the TPU kernel keeps it in VMEM, which one SM's 227 KB cannot do.
// - Recurrence: T dependent steps, each a (B, H) x (H, 3H) product per
//   direction that needs all of h_{t-1}. Per step that is 2.2 GFLOP against
//   0.6 MB of new state, far too little to fill the card: what a step costs
//   is latency (a barrier, an L2 round trip, one pass over the weights), not
//   bytes or operations. Two designs, chosen on the host by
//   ops/persist_plan.py from the shape and the device's SM count and shared
//   memory:
//   * persistent (gru_persist_kernel, persist.cuh): ONE cooperative launch
//     walks all T steps of both directions. A block owns U hidden units of
//     one direction (U = 24 at H = 1200: 50 blocks a direction, 100 of 132
//     SMs) and keeps their 3U columns of w_hh, H deep, in shared memory for
//     the whole walk (175 KB, in the swizzled tiles wgmma reads), so no
//     weight is read from L2 after the first step. Per step: a barrier among
//     the blocks of the direction (the two chains never wait for each
//     other); bf16 h of the previous step, all B rows, streams from L2
//     through a three-stage TMA ring beside the slice, fed by a ninth warp,
//     while the two warpgroups multiply with wgmma.m64n72k16 (B = 128: 64
//     rows each; B = 32: half of the depth each, partial sums added in a
//     fixed order); then the gates, the mask, the out write and the h update
//     (f32 h owned in place by one thread, its bf16 copy ping-pongs between
//     two buffers that the other blocks read). gx of the next step is
//     prefetched into L2 during the product. The backward chain reads
//     t = T-1-step: no reversed copy. B above 128 runs in row blocks over
//     the same resident slice.
//   * step (gru_step_kernel): one launch per time step, the launch boundary
//     as the barrier, each block rereading its slice of w_hh from L2. Kept
//     for widths whose slices do not fit an SM's shared memory (H = 2000
//     here), with the mma.sync projection.
//   Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, T=401,
//   B=128, H=1200, D=2016: persistent 9.1-9.3 ms (recurrence 6.7 ms = 16.7 us a
//   step, projection 2.4 ms = 610 TFLOP/s), step design 29.7 ms, one cuDNN
//   nn.GRU call 12-19 ms in bf16 and 14-18 ms in float16, bound 2.4 ms.

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
// Host entry, step design: one layer, on the caller's stream. Returns cudaGetLastError()
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
  int rc = gru_proj_launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih_f),
      static_cast<const bf16*>(w_ih_b), static_cast<float*>(gx), M, N, D, 2, s);
  if (rc != 0) return rc;
  cudaError_t err;

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

// ---------------------------------------------------------------------------
// Persistent design: all T steps of both directions in one cooperative launch
// ---------------------------------------------------------------------------

struct GruPersistArgs {
  const float* gx;        // (2, T, B, 3H) f32, bias-free
  const int* lengths;     // (B,)
  const bf16* whht[2];    // (3H, H): w_hh transposed, depth contiguous
  const float* bih[2];
  const float* bhh[2];
  float* h32;             // (2, B, H) f32: zeros on entry, h_last on exit
  bf16* hb;               // (2 buffers, 2, B, H) bf16 (step 0 reads none)
  bf16* out;              // (2, T, B, H)
  unsigned int* barrier;  // (2,) zeros on entry: one counter a direction
  int T, B, H;
  int U;       // hidden units per block (a multiple of 8)
  int MG;      // warpgroups along the rows of a row block (64 rows each): 1 or 2
  int stages;  // ring stages: 2 .. PS_MAX_STAGES
  int kc;      // depth one warpgroup covers of a ring chunk: 128, 64 or 32
  int bpd;     // blocks per direction
  int Kr;      // H rounded up to 64
  int ws_off;  // bytes from the start of shared memory (the ring) to the slice
  int tma;     // hb can be read by the copy engine (else element by element)
};

template <int NT>  // 3 * U / 8: 8-column tiles of the block's slice
__global__ void __launch_bounds__(PS_BLOCK, 1)
gru_persist_kernel(const GruPersistArgs p, const __grid_constant__ CUtensorMap hb_map) {
  extern __shared__ __align__(1024) unsigned char ps_smem_raw[];
  __shared__ __align__(8) uint64_t ps_mbar[2 * PS_MAX_STAGES];
  PsPhases phases;
  const int tid = threadIdx.x;
  const int dir = blockIdx.x / p.bpd;
  const int j0 = (blockIdx.x - dir * p.bpd) * p.U;
  const int T = p.T, B = p.B, H = p.H, U = p.U;
  const int G = 3 * H;
  const int NC = 3 * U;
  bf16* ring = reinterpret_cast<bf16*>(ps_smem_raw);
  bf16* Ws = reinterpret_cast<bf16*>(ps_smem_raw + p.ws_off);
  float* Cs = reinterpret_cast<float*>(ring);
  const int BR = p.MG * 64;
  const int KS = 2 / p.MG;  // planes of partial sums: one a depth split
  const int ldc = NT * 8 + 1;
  const int nrb = (B + BR - 1) / BR;

  // the epilogue's streams do not alias: its loads may be issued together
  const float* __restrict__ bih = p.bih[dir];
  const float* __restrict__ bhh = p.bhh[dir];
  const int* __restrict__ lengths = p.lengths;
  float* __restrict__ h32 = p.h32 + (size_t)dir * B * H;
  bf16* __restrict__ out = p.out + (size_t)dir * T * B * H;
  const float* __restrict__ gxd = p.gx + (size_t)dir * T * B * G;
  const size_t hsz = (size_t)2 * B * H;
  unsigned int* counter = p.barrier + dir;
  const int uw = min(U, H - j0);  // real units of this block
  // the epilogue works on four neighbouring units at a time where every row
  // segment it touches starts on 16 bytes (the bf16 ones on 8)
  const bool vec4 =
      (H % 4) == 0 &&
      ((reinterpret_cast<uintptr_t>(p.gx) | reinterpret_cast<uintptr_t>(p.h32) |
        reinterpret_cast<uintptr_t>(bih) | reinterpret_cast<uintptr_t>(bhh)) % 16) == 0 &&
      ((reinterpret_cast<uintptr_t>(p.hb) | reinterpret_cast<uintptr_t>(p.out)) % 8) == 0;

  ps_load_slice(Ws, p.whht[dir], H, H, p.Kr, 3, U, j0);
  ps_ring_init(ring, ps_mbar, p.stages);

  PS_T0();
  for (int step = 0; step < T; ++step) {
    const int t = dir == 0 ? step : T - 1 - step;
    const bf16* hb_in = p.hb + (step & 1) * hsz + (size_t)dir * B * H;
    bf16* __restrict__ hb_out = p.hb + ((step & 1) ^ 1) * hsz + (size_t)dir * B * H;
    PS_ACC(0);
    if (step > 0) ps_grid_barrier(counter, (unsigned int)step * p.bpd);
    PS_ACC(1);
    if (step + 1 < T) {
      // the next step's gx does not depend on h: bring it into L2 meanwhile
      const int tn = dir == 0 ? t + 1 : t - 1;
      for (int i = tid; i < B * 3; i += PS_BLOCK) {
        const int b = i / 3, g = i - b * 3;
        const float* q = gxd + ((size_t)tn * B + b) * G + (size_t)g * H + j0;
        ps_prefetch_l2(q);
        ps_prefetch_l2(q + uw - 1);
      }
    }
    PS_ACC(2);
    for (int rb = 0; rb < nrb; ++rb) {
      const int row0 = rb * BR;
      // h0 = 0: the first step's product is zero
      PS_ACC(0);
      if (step > 0)
        ps_block_product<NT>(hb_in, &hb_map, p.tma, (step & 1) * 2 + dir, row0, B, H,
                             p.Kr, Ws, ring, Cs, p.MG, p.stages, p.kc, ps_mbar, phases);
      PS_ACC(9);
      constexpr int UC = NT * 8 / 3;  // == U
      if (vec4) {
        // a thread's quads of four neighbouring units, EQ at a time: first
        // every load they need (16 bytes each), then the arithmetic, so the
        // loads' latencies overlap. (Issuing the loads before the product,
        // tried on an H100, made a step of the 128-row shape 2 us slower.)
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
              const float* gxr = gxd + ((size_t)t * B + b) * G + j;
              xr[e] = *reinterpret_cast<const float4*>(gxr);
              xz[e] = *reinterpret_cast<const float4*>(gxr + H);
              xn[e] = *reinterpret_cast<const float4*>(gxr + 2 * H);
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
              float ghr = 0.0f, ghz = 0.0f, ghn = gn0[k];
              if (step > 0) {
                ghr = ps_sum_splits(Cs, KS, BR, ldc, r, u);
                ghz = ps_sum_splits(Cs, KS, BR, ldc, r, UC + u);
                ghn += ps_sum_splits(Cs, KS, BR, ldc, r, 2 * UC + u);
              }
              const float rg = ps_sigmoid(pr[k] + ghr);
              const float zg = ps_sigmoid(pz[k] + ghz);
              const float ng = ps_tanh(pn[k] + rg * ghn);
              const float hn = (1.0f - zg) * ng + zg * hpv[k];
              hv[k] = valid ? hn : hpv[k];
              ov[k] = valid ? hn : 0.0f;
            }
            const size_t hi = (size_t)b * H + j;
            *reinterpret_cast<float4*>(h32 + hi) = make_float4(hv[0], hv[1], hv[2], hv[3]);
            __nv_bfloat162 h01 = __floats2bfloat162_rn(hv[0], hv[1]);
            __nv_bfloat162 h23 = __floats2bfloat162_rn(hv[2], hv[3]);
            __nv_bfloat162 o01 = __floats2bfloat162_rn(ov[0], ov[1]);
            __nv_bfloat162 o23 = __floats2bfloat162_rn(ov[2], ov[3]);
            uint2 hw, ow;
            hw.x = *reinterpret_cast<uint32_t*>(&h01);
            hw.y = *reinterpret_cast<uint32_t*>(&h23);
            ow.x = *reinterpret_cast<uint32_t*>(&o01);
            ow.y = *reinterpret_cast<uint32_t*>(&o23);
            *reinterpret_cast<uint2*>(hb_out + hi) = hw;
            *reinterpret_cast<uint2*>(out + ((size_t)t * B + b) * H + j) = ow;
          }
        }
      } else {
        // H no multiple of 4, or a bias that does not start on 16 bytes: one
        // unit at a time
        for (int idx = tid; idx < BR * UC; idx += PS_BLOCK) {
          const int r = idx / UC, u = idx - r * UC;
          const int b = row0 + r, j = j0 + u;
          if (b >= B || j >= H) continue;
          float ghr = bhh[j], ghz = bhh[H + j], ghn = bhh[2 * H + j];
          if (step > 0) {
            ghr += ps_sum_splits(Cs, KS, BR, ldc, r, u);
            ghz += ps_sum_splits(Cs, KS, BR, ldc, r, UC + u);
            ghn += ps_sum_splits(Cs, KS, BR, ldc, r, 2 * UC + u);
          }
          const float* gxr = gxd + ((size_t)t * B + b) * G;
          const float rg = ps_sigmoid(gxr[j] + bih[j] + ghr);
          const float zg = ps_sigmoid(gxr[H + j] + bih[H + j] + ghz);
          const float ng = ps_tanh(gxr[2 * H + j] + bih[2 * H + j] + rg * ghn);
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

// Host entry, persistent design. The plan (U, MG, stages, kc, bpd, smem bytes)
// comes from ops/persist_plan.py; the launch is refused with an error code if
// the device cannot hold the grid. w_hht_{f,b} are the transposed w_hh. w_iht
// is both transposed w_ih in one (2, 3H, D) tensor, or null: with it, and rows
// of x the copy engine can read, the projection runs on wgmma.
extern "C" int gru_bidi_fused_persist_launch(
    const void* x, const void* lengths, const void* w_ih_f, const void* w_ih_b,
    const void* w_hht_f, const void* w_hht_b, const void* b_ih_f,
    const void* b_ih_b, const void* b_hh_f, const void* b_hh_b,
    void* gx,       // (2, T, B, 3H) f32 scratch
    void* h32,      // (2, B, H) f32, zeroed
    void* h16,      // (2 buffers, 2, B, H) bf16
    void* out,      // (2, T, B, H) bf16
    void* barrier,  // (2,) uint32, zeroed
    const void* w_iht,
    int T, int B, int D, int H, int U, int MG, int stages, int kc, int bpd, int smem,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc;
  if (w_iht != nullptr && ps_tma_ok(x, D) && ps_tma_ok(w_iht, D))
    rc = gru_proj_wgmma_launch(static_cast<const bf16*>(x),
                               static_cast<const bf16*>(w_iht),
                               static_cast<float*>(gx), T * B, 3 * H, D, 2, s);
  else
    rc = gru_proj_launch(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_ih_f),
        static_cast<const bf16*>(w_ih_b), static_cast<float*>(gx), T * B, 3 * H,
        D, 2, s);
  if (rc != 0) return rc;

  GruPersistArgs p;
  p.gx = static_cast<const float*>(gx);
  p.lengths = static_cast<const int*>(lengths);
  p.whht[0] = static_cast<const bf16*>(w_hht_f);
  p.whht[1] = static_cast<const bf16*>(w_hht_b);
  p.bih[0] = static_cast<const float*>(b_ih_f);
  p.bih[1] = static_cast<const float*>(b_ih_b);
  p.bhh[0] = static_cast<const float*>(b_hh_f);
  p.bhh[1] = static_cast<const float*>(b_hh_b);
  p.h32 = static_cast<float*>(h32);
  p.hb = static_cast<bf16*>(h16);
  p.out = static_cast<bf16*>(out);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.T = T; p.B = B; p.H = H; p.U = U; p.MG = MG; p.stages = stages; p.kc = kc;
  p.bpd = bpd; p.Kr = (H + 63) / 64 * 64;
  p.ws_off = smem - 3 * U * p.Kr * 2;
  if (U % 8 != 0 || (MG != 1 && MG != 2) || stages < 2 || stages > PS_MAX_STAGES ||
      (kc != 32 && kc != 64 && kc != 128) || bpd * U < H)
    return (int)cudaErrorInvalidValue;
  const int KCB = 2 / MG * kc;  // depth of a ring chunk
  if (KCB % PS_BOX != 0 || p.ws_off < stages * MG * 64 * KCB * 2 || p.ws_off % 1024 != 0)
    return (int)cudaErrorInvalidValue;
  // hb: (2 buffers x 2 directions, B, H)
  CUtensorMap hb_map = {};
  p.tma = ps_tma_ok(h16, H) ? 1 : 0;
  if (p.tma) {
    rc = ps_make_tmap(&hb_map, h16, H, B, 4, MG * 64);
    if (rc != 0) return rc;
  }
  void* args[] = {&p, &hb_map};
  const int grid = 2 * bpd;
  const void* kernel = nullptr;
  switch (3 * U / 8) {
    case 3: kernel = (const void*)gru_persist_kernel<3>; break;
    case 6: kernel = (const void*)gru_persist_kernel<6>; break;
    case 9: kernel = (const void*)gru_persist_kernel<9>; break;
    case 12: kernel = (const void*)gru_persist_kernel<12>; break;
    case 15: kernel = (const void*)gru_persist_kernel<15>; break;
    case 18: kernel = (const void*)gru_persist_kernel<18>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return ps_coop_launch(kernel, grid, PS_BLOCK, smem, args, s);
}
