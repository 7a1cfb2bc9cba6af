// The lookahead of unidirectional models: a depthwise stencil of C taps over
// time, for Hopper.
//
// Replaces no Pallas kernel: the JAX package writes the lookahead
// (danspeech_tpu/ops/conv.py:lookahead) as C shifted copies stacked and one
// einsum, which XLA fuses into one contraction. Run eagerly in PyTorch, the
// same formulation wrote C float32 copies of its input, copied that stack
// again into the einsum's layout and read it a third time in a GEMV. This
// kernel reads the input once and writes the output once. Contract:
//   x (T, B, H) float32, contiguous; w (H, C) float32, contiguous;
//   out[t, b, h] = sum_{k < C} w[h, k] * x[t + k, b, h], x zero from
//   t + k >= T on (the right padding), the C fused multiply-adds in float32
//   in the order k = 0 .. C-1. With reverse set, time runs backwards for
//   input and output alike: out[t] = sum_k w[:, k] * x[t - k], x zero below
//   t = 0. That is the past-tap walk of the gradient, dx = that walk of dout.
//
// What bounds it on an H100, and what this design does about it:
// - 2 C operations for every 8 bytes read and written: at the batch shape
//   (T=401, B=128, H=2000, C=20) 411 MB in, 411 MB out, 0.245 ms at
//   3.35 TB/s, against 4.1 GFLOP, 0.061 ms at the 67 TFLOP/s float32 rate.
//   Bytes bound it.
// - x is seen as T rows of N = B*H contiguous columns. Each thread owns
//   COLS = 4 neighbouring columns (one 16-byte load and store a row) or,
//   where H is not a multiple of 4, a pointer is not 16-byte aligned or C is
//   above 24, one column (the scalar path). The C entry chooses from the
//   shape and the pointers it is given; nothing else chooses.
// - A thread walks one tile of time rows. Its columns' C taps stay in
//   registers for the whole tile, and so do C running partial sums, a ring
//   indexed by output row modulo C: input row s adds w[k] * x[s] to the sum
//   of output s - k for every k, and then the sum of output s - (C - 1) is
//   whole, is stored, and its slot starts over as output s + 1's. The walk
//   is unrolled by C, one turn of the ring, so every slot index is known at
//   compile time and the ring never leaves registers (C = 20, COLS = 4: 80
//   taps, 80 sums). Each input row is read once per tile; a tile of TT
//   output rows reads C - 1 rows of halo past its end, which the next tile
//   of the same columns (the neighbouring block) reads too, mostly from L2.
//   Fewer, longer tiles were faster wherever the column blocks alone give
//   the card about one block an SM (chip_smoke.py --lookahead and builds of
//   other tiles, NVIDIA H100 80GB HBM3 at 700 W: at T=401, B=128, H=2000 one
//   tile of 401 rows 0.292 ms, two 0.299, five 0.318-0.329; at B=16 three
//   tiles 0.045 ms, five 0.053): a tile pays its taps' loads, C - 1 steps
//   whose sums it throws away and its halo. So the C entry cuts T into as
//   many tiles as bring the blocks to the SM count, each at least C + 1 rows,
//   and sizes a tile to whole turns, TT = turns * C - (C - 1). At the batch
//   shape that is one tile: every row read once.
// - The loads are prefetched LA_PREFETCH rows ahead through a small ring of
//   registers, so that every warp keeps several 16-byte loads in flight
//   (C = 20, COLS = 4 takes 255 registers with no spill, two blocks an SM;
//   3 rows ahead measured 1-3% faster than 2 or 4).
// - The grid is one-dimensional, time tiles fastest, so that the tiles of
//   the same columns run side by side and share their halo in L2.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int LA_THREADS = 128;
constexpr int LA_PREFETCH = 3;  // rows loaded ahead of the one being added
constexpr int LA_MAX_C = 32;
constexpr int LA_MAX_VEC_C = 24;  // 2 * C * 4 registers of taps and sums fit up to here

template <int COLS>
__device__ __forceinline__ void la_load(float (&v)[COLS], const float* p) {
  if constexpr (COLS == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) v[j] = __ldg(p + j);
  }
}

template <int COLS>
__device__ __forceinline__ void la_store(float* p, const float (&v)[COLS]) {
  if constexpr (COLS == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) p[j] = v[j];
  }
}

template <int C, int COLS>
__global__ void __launch_bounds__(LA_THREADS)
lookahead_stencil_kernel(const float* __restrict__ x,   // (T, N)
                         const float* __restrict__ w,   // (H, C)
                         float* __restrict__ out,       // (T, N)
                         int T, long long N, int H, int tile_rows, int tiles,
                         int reverse) {
  constexpr int P = LA_PREFETCH < C ? LA_PREFETCH : C;
  const int tile = blockIdx.x % tiles;
  const long long col =
      ((long long)(blockIdx.x / tiles) * LA_THREADS + threadIdx.x) * COLS;
  if (col >= N) return;
  const int t0 = tile * tile_rows;                   // outputs [t0, t_end)
  const int t_end = min(t0 + tile_rows, T);
  const int r_end = min(t_end + C - 1, T);           // inputs [t0, r_end)
  const int turns = (t_end - t0 + C - 1 + C - 1) / C;

  float tap[C][COLS];
  if constexpr (COLS == 4) {
    // the four columns are four neighbouring h of one row b (H % 4 == 0):
    // their taps are 4 C contiguous floats, 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(w + (col % H) * C);
    float flat[4 * C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float4 q = __ldg(src + i);
      flat[4 * i] = q.x; flat[4 * i + 1] = q.y; flat[4 * i + 2] = q.z;
      flat[4 * i + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) tap[k][j] = flat[j * C + k];
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const long long h = (col + j) % H;
#pragma unroll
      for (int k = 0; k < C; ++k) tap[k][j] = __ldg(w + h * C + k);
    }
  }

  // walk index r -> time row; reverse walks t = T-1 .. 0
  const long long row0 = reverse ? (long long)(T - 1) * N : 0;
  const long long step = reverse ? -N : N;
  const float* xc = x + row0 + col;
  float* oc = out + row0 + col;

  float acc[C][COLS];
#pragma unroll
  for (int m = 0; m < C; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;

  // pre[i % P] holds input row t0 + q C + i when step i of turn q reads it
  float pre[P][COLS];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (t0 + p < r_end) {
      la_load<COLS>(pre[p], xc + (t0 + p) * step);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) pre[p][j] = 0.f;
    }
  }

  for (int q = 0; q < turns; ++q) {
    const int base = t0 + q * C;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int s = base + i;  // the input row this step adds
      float v[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) v[j] = pre[i % P][j];
      if (s + P < r_end) {
        la_load<COLS>(pre[i % P], xc + (s + P) * step);
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j) pre[i % P][j] = 0.f;
      }
      // x[s] into the sum of output s - k, slot (s - k - t0) mod C
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int m = (i - k + C) % C;
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[m][j] = fmaf(tap[k][j], v[j], acc[m][j]);
      }
      // output s - (C - 1) is whole: slot (i + 1) mod C
      const int u = s - (C - 1);
      const int done = (i + 1) % C;
      if (u >= t0 && u < t_end) la_store<COLS>(oc + u * step, acc[done]);
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[done][j] = 0.f;
    }
    // slot j of the next turn is the one written C - P + j steps into this
    float next[P][COLS];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < COLS; ++j) next[p][j] = pre[(C + p) % P][j];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < COLS; ++j) pre[p][j] = next[p][j];
  }
}

template <int C, int COLS>
static int la_launch(const float* x, const float* w, float* out, int T, long long N,
                     int H, int reverse, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long col_blocks = (N / COLS + LA_THREADS - 1) / LA_THREADS;
  // enough time tiles to give every SM a block, each at least C + 1 rows
  const long long want = (sms + col_blocks - 1) / col_blocks;
  const int most = (T + C) / (C + 1);
  int tiles = (int)(want < most ? want : most);
  if (tiles < 1) tiles = 1;
  const int turns = ((T + tiles - 1) / tiles + C - 1 + C - 1) / C;
  const int tile_rows = turns * C - (C - 1);
  tiles = (T + tile_rows - 1) / tile_rows;
  const long long blocks = col_blocks * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lookahead_stencil_kernel<C, COLS><<<(unsigned)blocks, LA_THREADS, 0, s>>>(
      x, w, out, T, N, H, tile_rows, tiles, reverse);
  return (int)cudaGetLastError();
}

template <int C>
static int la_dispatch_cols(const float* x, const float* w, float* out, int T,
                            long long N, int H, int reverse, cudaStream_t s) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0) &&
                       ((uintptr_t)out % 16 == 0);
  if constexpr (C <= LA_MAX_VEC_C) {
    if (H % 4 == 0 && aligned) return la_launch<C, 4>(x, w, out, T, N, H, reverse, s);
  }
  return la_launch<C, 1>(x, w, out, T, N, H, reverse, s);
}

template <int C>
static int la_dispatch(int c, const float* x, const float* w, float* out, int T,
                       long long N, int H, int reverse, cudaStream_t s) {
  if (c == C) return la_dispatch_cols<C>(x, w, out, T, N, H, reverse, s);
  if constexpr (C < LA_MAX_C) {
    return la_dispatch<C + 1>(c, x, w, out, T, N, H, reverse, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// out (T, B, H) = the stencil of x (T, B, H) with the taps w (H, C), C from 1
// to LA_MAX_C; reverse walks time backwards (the gradient's past taps).
extern "C" int lookahead_stencil_launch(const void* x, const void* w, void* out,
                                        int T, int B, int H, int C, int reverse,
                                        void* stream) {
  if (T < 1 || B < 1 || H < 1 || C < 1 || C > LA_MAX_C) return (int)cudaErrorInvalidValue;
  return la_dispatch<1>(C, static_cast<const float*>(x), static_cast<const float*>(w),
                        static_cast<float*>(out), T, (long long)B * H, H, reverse,
                        reinterpret_cast<cudaStream_t>(stream));
}
