// Float32 GEMM on the CUDA cores (FFMA) for Hopper, shared by the float32
// kernels of gru_f32.cu and lstm_f32.cu: the input projection of the fused
// bidirectional layer (x @ w_ih of both directions, B3) and the gate
// recompute of the backward walks (hprev @ w_hh of each chain, B4 and B7).
// The TPU kernels compute these products in their own bodies
// (danspeech_tpu/ops/pallas_gru.py: _gru_bidi_fused_kernel's projection,
// the recompute of _gru_bwd_kernel and of _lstm_bwd_kernel).
//
//   C[z] (M, N) = A[z] (M, K) @ B[z] (K, N), float32, row-major, z < 2.
//
// Hopper's tensor cores have no float32 x float32 shape (TF32 keeps 10
// mantissa bits and is not float32), so the product runs on the FP32 units:
// 67 TFLOP/s on an H100 SXM at 700 W, the bound of these products. A
// sub-partition reaches that rate only if nearly every instruction it issues
// is an FFMA, so the design keeps the copies off the multiplying threads:
// - Persistent blocks, two an SM, walk the output tiles of 128 x 128 (z
//   outermost, then rows, columns fastest, so the blocks at work share their
//   rows of A and all of B in L2); a tile's stores overlap the loads of the
//   next.
// - Thread 0 fills a ring of SG_STAGES stages, each a chunk of SG_BK
//   depths, by TMA (cp.async.bulk.tensor, completion counted on an mbarrier
//   a stage): A's box (128 rows x 32 depths, K-contiguous) in the 128-byte
//   swizzle, B's (32 depths x 128 columns, N-contiguous) as it lies; what
//   lies past M, N or K arrives as zeros. It refills a stage two chunks
//   ahead of the one being multiplied, once every warp has handed the
//   stage back on its "empty" mbarrier: no block-wide barrier in the loop.
// - A thread holds 8 rows x 8 columns of sums (rows tm + 4 r of its warp's
//   32, columns tn * 4 + 32 j + c of its warp's 64) and issues only
//   shared-memory loads and FFMAs: per two depths eight 8-byte loads of its
//   rows' A along K (the swizzle puts the rows of one load in distinct bank
//   groups) and per depth two 16-byte loads of B (eight threads over 128
//   contiguous bytes), each loaded one depth ahead of the FFMAs that use it.
// - 256 threads of 128 registers, two blocks an SM: four warps on each
//   sub-partition hide the loads' latency.
// Where the copy engine cannot read an operand (K or N no multiple of 4, a
// base off 16 bytes), the kernel's other instance (kTma false) has every
// thread fill the stage with ordinary loads between two block barriers
// instead; the product does not change.
// The sum over K runs in order within a thread: the result differs from
// cuBLAS's full float32 product only by the order of the sums.
// (Tried on an H100 at 700 W, chip_smoke.py --sgemm-against, shape (a):
// the kernel this one replaced, 128 x 128 tiles over chunks of 8 depths
// loaded through registers with transposing stores and a block barrier a
// chunk, 41.0-41.6 TFLOP/s; a producer warp beside eight consumer warps holding 8 x 16 sums
// (one block an SM) left 168 registers a thread, since one sub-partition
// then holds three warps, and spilled at 9.5 TFLOP/s; setmaxnreg (three
// warpgroups, consumers at 232) did not lift ptxas's 168 and ran at 30.0;
// the same tile at 255 registers with thread 0 feeding, 34.2 before its
// ring was addressed as shared memory (its loads had been generic LD),
// 38.5-39.0 after, 42.4 with the loads a depth ahead; eight sums a thread,
// two blocks an SM, A four depths a load, 33.7; A two depths a load and
// one depth ahead, 43.2.)
//
// Include after persist.cuh (its mbarrier helpers and ps_mbar_wait).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#define SG_BM 128       // rows of a tile
#define SG_BN 128       // columns of a tile
#define SG_BK 32        // depths of a chunk: 128 bytes of A's rows, the swizzle's span
#define SG_STAGES 3     // ring stages
#define SG_THREADS 256  // eight warps: 4 over the rows x 2 over the columns
#define SG_BLOCKS 2     // blocks an SM
#define SG_A_FLOATS (SG_BM * SG_BK)
#define SG_B_FLOATS (SG_BK * SG_BN)
#define SG_STAGE_FLOATS (SG_A_FLOATS + SG_B_FLOATS)
// the ring, and 1 KB to put it on the 1024-byte boundary the swizzle needs
#define SG_SMEM (SG_STAGES * SG_STAGE_FLOATS * 4 + 1024)

struct SgemmMaps {
  CUtensorMap a[2];  // A[z] (M, K): boxes of SG_BK depths x SG_BM rows, 128-byte swizzle
  CUtensorMap b[2];  // B[z] (K, N): boxes of SG_BN columns x SG_BK depths
};

struct SgemmArgs {
  const float* a[2];  // (M, K)
  const float* b[2];  // (K, N)
  float* c[2];        // (M, N)
  int M, N, K, nz;
};

// the float offset of A's element (row m, depth k) within a stage: rows of
// 128 bytes, the 16-byte chunk k / 4 of row m at chunk (k / 4) ^ (m % 8), as
// TMA's 128-byte swizzle lays a box out from a 1024-byte boundary
__device__ __forceinline__ int sg_a_off(int m, int k) {
  return m * SG_BK + ((((k >> 2) ^ m) & 7) << 2) + (k & 3);
}

__device__ __forceinline__ void sg_tma_load_2d(void* dst, const CUtensorMap* map, int c0,
                                               int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(ps_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(ps_smem(bar)) : "memory");
}

template <bool kTma>  // the copy engine fills the ring, or every thread's loads
__global__ void __launch_bounds__(SG_THREADS, SG_BLOCKS)
sgemm_tma_kernel(const __grid_constant__ SgemmMaps maps, SgemmArgs p) {
  extern __shared__ unsigned char sg_raw[];
  __shared__ __align__(8) uint64_t full[SG_STAGES];
  __shared__ __align__(8) uint64_t empty[SG_STAGES];
  // the ring on a 1024-byte boundary, as an offset into the shared array so
  // that its loads stay shared-memory loads (LDS), not generic ones
  float* ring = reinterpret_cast<float*>(sg_raw + ((1024u - (ps_smem(sg_raw) & 1023u)) & 1023u));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int M = p.M, N = p.N, K = p.K;
  const int tiles_m = (M + SG_BM - 1) / SG_BM, tiles_n = (N + SG_BN - 1) / SG_BN;
  const int tiles = tiles_m * tiles_n * p.nz;
  const int chunks = (K + SG_BK - 1) / SG_BK;
  const int my_tiles = (int)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t total = (uint32_t)my_tiles * chunks;  // this block's chunks

  if (kTma && tid == 0) {
    for (int s = 0; s < SG_STAGES; ++s) {
      ps_mbar_init(full + s, 1);
      ps_mbar_init(empty + s, SG_THREADS / 32);
    }
    ps_mbar_init_fence();
  }
  __syncthreads();
  auto feed = [&](uint32_t c) {  // thread 0: chunk c of this block's walk
    const int tile = blockIdx.x + (int)(c / chunks) * gridDim.x;
    const int kc = (int)(c % chunks);
    const int z = tile / (tiles_m * tiles_n);
    const int mn = tile - z * tiles_m * tiles_n;
    const int m0 = (mn / tiles_n) * SG_BM, n0 = (mn % tiles_n) * SG_BN;
    const int s = c % SG_STAGES;
    float* As = ring + s * SG_STAGE_FLOATS;
    ps_mbar_expect_tx(full + s, SG_STAGE_FLOATS * 4u);
    sg_tma_load_2d(As, &maps.a[z], kc * SG_BK, m0, full + s);
    sg_tma_load_2d(As + SG_A_FLOATS, &maps.b[z], n0, kc * SG_BK, full + s);
  };
  if (kTma && tid == 0)
    for (uint32_t c = 0; c < SG_STAGES && c < total; ++c) feed(c);

  // warp (wm, wn) owns rows 32 wm .. + 31 and columns 64 wn .. + 63 of a
  // tile; lane (tm, tn) rows 32 wm + tm + 4 r, columns 64 wn + tn * 4 + 32 j + c
  const int wm = warp & 3, wn = warp >> 2;
  const int tm = lane >> 3, tn = lane & 7;
  const int wrow = wm * 32 + tm;
  const int wcol = wn * 64 + tn * 4;
  uint32_t g = 0;  // chunks multiplied over the whole walk
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int z = tile / (tiles_m * tiles_n);
    const int mn = tile - z * tiles_m * tiles_n;
    const int m0 = (mn / tiles_n) * SG_BM, n0 = (mn % tiles_n) * SG_BN;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

    for (int kc = 0; kc < chunks; ++kc, ++g) {
      const int s = g % SG_STAGES;
      float* As = ring + s * SG_STAGE_FLOATS;
      if constexpr (kTma) {
        if (tid == 0 && g + 2 >= SG_STAGES && g + 2 < total) {
          // chunk g + 2 into the stage of chunk g + 2 - SG_STAGES, once handed back
          const uint32_t back = g + 2 - SG_STAGES;
          ps_mbar_wait(empty + back % SG_STAGES, (back / SG_STAGES) & 1u);
          feed(g + 2);
        }
        ps_mbar_wait(full + s, (g / SG_STAGES) & 1u);
      } else {
        __syncthreads();  // every thread has left the stage
        const float* __restrict__ A = p.a[z];
        const float* __restrict__ Bm = p.b[z];
        const int k0 = kc * SG_BK;
        for (int i = tid; i < SG_A_FLOATS; i += SG_THREADS) {
          const int m = i / SG_BK, k = i % SG_BK;
          const int gm = m0 + m, gk = k0 + k;
          As[sg_a_off(m, k)] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
        }
        for (int i = tid; i < SG_B_FLOATS; i += SG_THREADS) {
          const int k = i / SG_BN, n = i % SG_BN;
          const int gk = k0 + k, gn = n0 + n;
          As[SG_A_FLOATS + i] = (gk < K && gn < N) ? Bm[(size_t)gk * N + gn] : 0.0f;
        }
        __syncthreads();
      }
      const float* Bs = As + SG_A_FLOATS + wcol;
      int aoff[8];  // a row's start in the stage; its swizzle is that of row wrow or wrow + 4
#pragma unroll
      for (int r = 0; r < 8; ++r) aoff[r] = (wrow + 4 * r) * SG_BK;
      const int xr0 = wrow & 7, xr1 = (wrow + 4) & 7;
      float a[8][2], an[8][2], bv[8], bn[8];
      auto load_a = [&](float (&dst)[8][2], int k) {  // depths k, k + 1 of the 8 rows
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              As + aoff[r] + ((((k >> 2) ^ ((r & 1) ? xr1 : xr0)) & 7) << 2) + (k & 3));
          dst[r][0] = v.x;
          dst[r][1] = v.y;
        }
      };
      auto load_b = [&](float (&dst)[8], int k) {  // depth k of the 8 columns
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(Bs + k * SG_BN + 32 * j);
          dst[4 * j] = v.x;
          dst[4 * j + 1] = v.y;
          dst[4 * j + 2] = v.z;
          dst[4 * j + 3] = v.w;
        }
      };
      load_a(a, 0);
      load_b(bv, 0);
#pragma unroll
      for (int k = 0; k < SG_BK; ++k) {
        if (k + 1 < SG_BK) load_b(bn, k + 1);
        if ((k & 1) && k + 1 < SG_BK) load_a(an, k + 1);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r][k & 1], bv[c], acc[r][c]);
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = bn[c];
        if (k & 1) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            a[r][0] = an[r][0];
            a[r][1] = an[r][1];
          }
        }
      }
      if constexpr (kTma) {
        __syncwarp();
        if (lane == 0) ps_mbar_arrive(empty + s);  // this warp is done with the stage
      }
    }

    float* __restrict__ C = p.c[z];
    const bool cvec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = m0 + wrow + 4 * r;
      if (row >= M) continue;
      float* crow = C + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + wcol + 32 * j;
        if (cvec && col + 3 < N) {
          *reinterpret_cast<float4*>(crow + col) =
              make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                          acc[r][4 * j + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col + c < N) crow[col + c] = acc[r][4 * j + c];
        }
      }
    }
  }
}

// The tensor map of a row-major (rows, cols) float32 matrix at `base` (rows
// cols * 4 bytes apart, a multiple of 16, from a 16-byte boundary), read in
// boxes of box_cols x box_rows, in the 128-byte swizzle or as it lies;
// cuTensorMapEncodeTiled of libcuda.so.1 looked up by name, as
// ps_make_tmap does. Returns the CUDA (runtime) error code, or
// cudaErrorUnknown when the encoder refuses.
static inline int sg_make_tmap(CUtensorMap* map, const float* base, int rows, int cols,
                               int box_cols, int box_rows, bool swizzle) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) return (int)cudaErrorSharedObjectInitFailed;
    encode = reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"));
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
      estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorUnknown;
}

static inline bool sg_tma_ok(const float* base, int cols) {
  return cols % 4 == 0 && (reinterpret_cast<uintptr_t>(base) % 16) == 0;
}

// C[z] = A[z] @ B[z] for z < nz (1 or 2), on ``s``: SG_BLOCKS persistent
// blocks an SM (fewer where there are fewer tiles). Returns
// cudaGetLastError() after the launch, or the error of the first call that
// failed.
static int sgemm_launch(const float* a0, const float* a1, const float* b0,
                        const float* b1, float* c0, float* c1, int M, int N,
                        int K, int nz, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || nz < 1 || nz > 2) return (int)cudaErrorInvalidValue;
  SgemmArgs p;
  p.a[0] = a0; p.a[1] = nz > 1 ? a1 : a0;
  p.b[0] = b0; p.b[1] = nz > 1 ? b1 : b0;
  p.c[0] = c0; p.c[1] = nz > 1 ? c1 : c0;
  p.M = M; p.N = N; p.K = K; p.nz = nz;
  SgemmMaps maps;
  memset(&maps, 0, sizeof(maps));
  bool tma = true;
  for (int z = 0; z < 2; ++z)
    if (!sg_tma_ok(p.a[z], K) || !sg_tma_ok(p.b[z], N)) tma = false;
  for (int z = 0; tma && z < 2; ++z) {
    int rc = sg_make_tmap(&maps.a[z], p.a[z], M, K, SG_BK, SG_BM, true);
    if (rc == 0) rc = sg_make_tmap(&maps.b[z], p.b[z], K, N, SG_BN, SG_BK, false);
    if (rc != 0) return rc;
  }
  void (*kernel)(const SgemmMaps, SgemmArgs) =
      tma ? sgemm_tma_kernel<true> : sgemm_tma_kernel<false>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SG_SMEM);
  if (err == cudaSuccess)  // room for SG_BLOCKS rings an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((M + SG_BM - 1) / SG_BM) * ((N + SG_BN - 1) / SG_BN) * nz;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)sms * SG_BLOCKS;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kernel<<<grid, SG_THREADS, SG_SMEM, s>>>(maps, p);
  return (int)cudaGetLastError();
}
