// Persistent recurrences for Hopper: what a kernel needs to walk all T steps
// of a recurrence in ONE cooperative launch, with its slice of the recurrent
// weights resident in shared memory for the whole walk.
//
// A block owns U hidden units. For `gates` gates it keeps the gate-aligned
// columns {g * H + j0 + u} of a (K, gates * H) matrix in shared memory, depth
// contiguous, in the 128-byte swizzled tiles that wgmma reads as its right
// operand. Per step it multiplies the step's left operand (rows, K) bf16,
// which every block reads from L2 where the previous step left it, by that
// slice: the operand streams through a ring in the shared memory the slice
// leaves free, filled by the copy engine (TMA) on the word of a ninth warp,
// so the loads of the chunks ahead overlap the products of the chunk at
// hand. Steps are ordered by a grid-wide barrier; the launch is cooperative,
// so a grid that cannot be co-resident is an error, not a hang.
//
// The eight multiplying warps are two warpgroups; a warpgroup multiplies 64
// rows at a time (wgmma.m64nNk16, both operands from shared memory, f32 sums
// in registers). A batch above 64 rows gives each warpgroup 64 of a 128-row
// block; a smaller one gives each half of the depth, so a small batch still
// uses both. The partial sums meet in shared memory and are added in a fixed
// order: the result does not depend on scheduling.
// (mma.sync.m16n8k16 in this product, tried on an NVIDIA H100 80GB HBM3 at
// 700 W with chip_smoke.py, left gru_bidi_fused at 13.7 ms where wgmma gives
// 11.8 ms at T=401, B=128, H=1200, D=2016, and gru_bwd_scan at 8.2 ms
// against 6.8 ms at B=32.)
//
// The sizes are planned on the host (ops/persist_plan.py mirrors the constants
// below): units per block, blocks, stages of the ring and bytes of shared
// memory. A host entry checks the plan against the occupancy the device
// reports and returns the CUDA error code.
//
// Building with -DPS_PROFILE makes thread 0 of block 0 add up the clocks it
// spends in each part of a step (PS_ACC below; persist_prof_read fetches the
// sums): the barrier, the wait for a chunk, the products, the epilogue.
//
// The forward chains (gru_scan.cu, lstm_scan.cu) walk only the steps before
// the longest row's length (ps_longest); the later steps only write zeros.
//
// Include after <cuda_bf16.h> and the bf16 typedef.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#define PS_THREADS 256   // the 8 warps (2 warpgroups) that multiply
#define PS_WARPS 8
#define PS_BLOCK 288     // a block: those and one warp that feeds the ring (four
                         // feeding warps, tried, were no faster)
#define PS_MAX_STAGES 6  // ring stages: 2 .. 6, as many as fit (the plan)
#define PS_BOX 64        // depth of one swizzled tile, of the operand (a TMA box)
                         // and of the slice: 128 bytes a row

#ifdef PS_PROFILE
__device__ unsigned long long ps_prof[16];
#define PS_T0() long long ps_t_ = clock64()
#define PS_ACC(i)                                     \
  if (blockIdx.x == 0 && threadIdx.x == 0) {          \
    long long n_ = clock64();                         \
    ps_prof[i] += (unsigned long long)(n_ - ps_t_);   \
    ps_t_ = n_;                                       \
  }
extern "C" int persist_prof_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ps_prof, sizeof(ps_prof));
  if (e != cudaSuccess) return (int)e;
  if (reset) {
    unsigned long long z[16] = {0};
    e = cudaMemcpyToSymbol(ps_prof, z, sizeof(z));
  }
  return (int)e;
}
#else
#define PS_T0()
#define PS_ACC(i)
#endif

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ps_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only (.cg): data another block wrote
// before the barrier is never served from a stale L1 line
__device__ __forceinline__ void ps_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(ps_smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void ps_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ps_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// --- TMA tile copies completing on an mbarrier in shared memory ---

__device__ __forceinline__ void ps_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(ps_smem(bar)), "r"(count) : "memory");
}

// makes initialised mbarriers visible to the copy engine
__device__ __forceinline__ void ps_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's ordinary writes to shared memory before later writes
// of the copy engine to the same bytes
__device__ __forceinline__ void ps_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void ps_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(ps_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ps_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(ps_smem(bar)) : "memory");
}

// the 8 multiplying warps alone
__device__ __forceinline__ void ps_sync_multipliers() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(PS_THREADS) : "memory");
}

// One box of the 3-D tensor `tmap` describes, starting at element (c0, c1,
// c2), global -> shared by the copy engine (TMA), read through L2. What lies
// outside the tensor arrives as zeros. Completion (the box's full size in
// bytes) is counted on `bar`.
__device__ __forceinline__ void ps_tma_load_3d(void* dst, const CUtensorMap* tmap,
                                               int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(ps_smem(dst)), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1),
         "r"(c2), "r"(ps_smem(bar)) : "memory");
}

// waits for the phase of `bar` with the given parity; a wait that never ends
// (a byte count that does not match) traps instead of hanging the card
__device__ __forceinline__ void ps_mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = ps_smem(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void ps_prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ void ps_ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ps_smem(p)));
}

__device__ __forceinline__ void ps_ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ps_smem(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void ps_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  // no memory operand: the compiler may schedule it among the loads
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- wgmma: 64 x N x 16, both operands in shared memory, f32 accumulate ---

// The descriptor of an operand tile whose rows are 128 bytes (64 bf16 of
// depth) in the 128-byte swizzle, rows of 8 packed 1024 bytes apart: what TMA
// writes and ps_load_slice lays out. `p` is the tile's first row at the depth
// the instruction starts from (a multiple of 16 inside the 64).
__device__ __forceinline__ uint64_t ps_wgmma_desc(const void* p) {
  return (uint64_t)((ps_smem(p) & 0x3FFFFu) >> 4)  // start address
         | ((uint64_t)1 << 16)                     // leading offset: unused here
         | ((uint64_t)(1024 >> 4) << 32)           // 8 rows further
         | ((uint64_t)1 << 62);                    // 128-byte swizzle
}

__device__ __forceinline__ void ps_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ps_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of products are still in flight
template <int N>
__device__ __forceinline__ void ps_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x NT * 8, this thread's NT * 4 values: tile n holds, as mma.m16n8
// does, columns 8n + 2q, 2q + 1 of rows 16w + r and + 8, for lane 4r + q of
// warp w of the warpgroup) += a (64 x 16) * b (16 x NT * 8). One
// specialisation per width the kernels are compiled for.
template <int NT>
__device__ __forceinline__ void ps_wgmma(float (&d)[NT][4], uint64_t da, uint64_t db);

#define PS_WG_R1 "%0, %1, %2, %3"
#define PS_WG_R2 PS_WG_R1 ", %4, %5, %6, %7"
#define PS_WG_R3 PS_WG_R2 ", %8, %9, %10, %11"
#define PS_WG_R4 PS_WG_R3 ", %12, %13, %14, %15"
#define PS_WG_R5 PS_WG_R4 ", %16, %17, %18, %19"
#define PS_WG_R6 PS_WG_R5 ", %20, %21, %22, %23"
#define PS_WG_R7 PS_WG_R6 ", %24, %25, %26, %27"
#define PS_WG_R8 PS_WG_R7 ", %28, %29, %30, %31"
#define PS_WG_R9 PS_WG_R8 ", %32, %33, %34, %35"
#define PS_WG_R10 PS_WG_R9 ", %36, %37, %38, %39"
#define PS_WG_R11 PS_WG_R10 ", %40, %41, %42, %43"
#define PS_WG_R12 PS_WG_R11 ", %44, %45, %46, %47"
#define PS_WG_R13 PS_WG_R12 ", %48, %49, %50, %51"
#define PS_WG_R14 PS_WG_R13 ", %52, %53, %54, %55"
#define PS_WG_R15 PS_WG_R14 ", %56, %57, %58, %59"
#define PS_WG_R16 PS_WG_R15 ", %60, %61, %62, %63"
#define PS_WG_R17 PS_WG_R16 ", %64, %65, %66, %67"
#define PS_WG_R18 PS_WG_R17 ", %68, %69, %70, %71"
#define PS_WG_D(d, n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
#define PS_WG_O1(d) PS_WG_D(d, 0)
#define PS_WG_O2(d) PS_WG_O1(d), PS_WG_D(d, 1)
#define PS_WG_O3(d) PS_WG_O2(d), PS_WG_D(d, 2)
#define PS_WG_O4(d) PS_WG_O3(d), PS_WG_D(d, 3)
#define PS_WG_O5(d) PS_WG_O4(d), PS_WG_D(d, 4)
#define PS_WG_O6(d) PS_WG_O5(d), PS_WG_D(d, 5)
#define PS_WG_O7(d) PS_WG_O6(d), PS_WG_D(d, 6)
#define PS_WG_O8(d) PS_WG_O7(d), PS_WG_D(d, 7)
#define PS_WG_O9(d) PS_WG_O8(d), PS_WG_D(d, 8)
#define PS_WG_O10(d) PS_WG_O9(d), PS_WG_D(d, 9)
#define PS_WG_O11(d) PS_WG_O10(d), PS_WG_D(d, 10)
#define PS_WG_O12(d) PS_WG_O11(d), PS_WG_D(d, 11)
#define PS_WG_O13(d) PS_WG_O12(d), PS_WG_D(d, 12)
#define PS_WG_O14(d) PS_WG_O13(d), PS_WG_D(d, 13)
#define PS_WG_O15(d) PS_WG_O14(d), PS_WG_D(d, 14)
#define PS_WG_O16(d) PS_WG_O15(d), PS_WG_D(d, 15)
#define PS_WG_O17(d) PS_WG_O16(d), PS_WG_D(d, 16)
#define PS_WG_O18(d) PS_WG_O17(d), PS_WG_D(d, 17)
// NT tiles, N = 8 NT columns, and the numbers of the two operands after the
// 4 NT accumulator registers
#define PS_WGMMA_DEF(NT, N, A, B)                                                  \
  template <>                                                                      \
  __device__ __forceinline__ void ps_wgmma<NT>(float (&d)[NT][4], uint64_t da,     \
                                               uint64_t db) {                      \
    asm volatile(                                                                  \
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"                                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" PS_WG_R##NT   \
        "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                                 \
        : PS_WG_O##NT(d)                                                           \
        : "l"(da), "l"(db));                                                       \
  }
PS_WGMMA_DEF(1, 8, 4, 5)
PS_WGMMA_DEF(2, 16, 8, 9)
PS_WGMMA_DEF(3, 24, 12, 13)
PS_WGMMA_DEF(4, 32, 16, 17)
PS_WGMMA_DEF(5, 40, 20, 21)
PS_WGMMA_DEF(6, 48, 24, 25)
PS_WGMMA_DEF(7, 56, 28, 29)
PS_WGMMA_DEF(8, 64, 32, 33)
PS_WGMMA_DEF(9, 72, 36, 37)
PS_WGMMA_DEF(12, 96, 48, 49)
PS_WGMMA_DEF(15, 120, 60, 61)
PS_WGMMA_DEF(18, 144, 72, 73)

// The gate functions of a step's epilogue, on the fast exponential and
// division (about 2 ulp each; the arguments are clamped where the result has
// long since saturated in f32, so neither overflows).
__device__ __forceinline__ float ps_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-fminf(fmaxf(x, -30.0f), 30.0f)));
}

__device__ __forceinline__ float ps_tanh(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * fminf(fmaxf(x, -15.0f), 15.0f)));
}

// four neighbouring bf16 (8 bytes, from an 8-byte boundary) as floats, and back
__device__ __forceinline__ float4 ps_load_bf16x4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void ps_store_bf16x4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&a);
  w.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// The steps a forward chain must walk: t < the longest of the B lengths (at
// most T). Every block computes the same; the later steps change no state
// and only write zeros (ps_zero_steps), so they need no barrier.
__device__ __forceinline__ int ps_longest(const int* lengths, int B, int T) {
  __shared__ int longest;
  if (threadIdx.x == 0) longest = 0;
  __syncthreads();
  int m = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) m = max(m, lengths[b]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(&longest, m);
  __syncthreads();
  return min(longest, T);
}

// seq[t][b][j0 + u] = 0 for t0 <= t < T, every row b < B, u < uw: a (T, B, H)
// stream's steps past every row's length, at this block's units
__device__ __forceinline__ void ps_zero_steps(bf16* seq, int t0, int T, int B, int H,
                                              int j0, int uw) {
  const size_t n = (size_t)(T - t0) * B * uw;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t row = i / uw;  // (t - t0) * B + b
    seq[((size_t)t0 * B + row) * H + j0 + (i - row * uw)] = __float2bfloat16(0.0f);
  }
}

// ---------------------------------------------------------------------------
// Grid-wide barrier over the `blocks` blocks that share `counter`
// ---------------------------------------------------------------------------
//
// The counter only grows: the n-th barrier (n from 1) waits for n * blocks
// arrivals, so it is never reset and a fast block cannot lap a slow one. All
// blocks must be co-resident (cooperative launch). What a block wrote to
// global memory before the barrier is visible to every block after it: the
// block-wide barrier orders the block's writes before thread 0's fence, the
// fence (cumulative, device scope) before its arrival, and the second fence
// orders the observed count before the block's later reads. Read exchanged
// buffers through L2 (TMA, cp.async.cg, __ldcg), not through L1. A wait
// that never ends (a block that never arrives) traps instead of hanging the
// card.

__device__ __forceinline__ void ps_grid_barrier(unsigned int* counter,
                                                unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    for (uint32_t spins = 0;
         *reinterpret_cast<volatile unsigned int*>(counter) < target; ++spins)
      if (spins > (1u << 24)) __trap();
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// One-time loader of a block's resident slice
// ---------------------------------------------------------------------------
//
// wt is the matrix with its depth contiguous: (gates * H, K) row-major, i.e.
// the transpose of the (K, gates * H) matrix of the product. Row c = g * U + u
// of the slice is wt[g * H + j0 + u][0 .. K), zero-filled to Kr (K rounded up
// to 64) and for units past H. The slice is laid out as Kr / 64 tiles of
// gates * U rows x 128 bytes, the 16-byte unit v of row c of a tile at
// c * 128 + ((v ^ (c & 7)) << 4): the 128-byte swizzle wgmma reads. Ws must
// start on 1024 bytes (the swizzle counts rows from there).

__device__ __forceinline__ void ps_load_slice(bf16* Ws, const bf16* wt, int H,
                                              int K, int Kr, int gates, int U,
                                              int j0) {
  const int NC = gates * U;
  const bool vec = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(wt) % 16) == 0;
  const int pieces = Kr / 8;
  const int total = NC * pieces;
  for (int p = threadIdx.x; p < total; p += PS_BLOCK) {
    const int c = p / pieces;
    const int k = (p - c * pieces) * 8;
    const int g = c / U;
    const int j = j0 + (c - g * U);
    bf16* dst = Ws + (k >> 6) * (NC * PS_BOX) + c * PS_BOX + ((((k & 63) >> 3) ^ (c & 7)) << 3);
    const bf16* src = wt + ((size_t)g * H + j) * K + k;
    if (vec && j < H && k + 8 <= K) {
      ps_cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (j < H && k + e < K) ? src[e] : __float2bfloat16(0.0f);
    }
  }
  ps_commit();
  ps_wait<0>();
  // wgmma reads shared memory as the copy engine does: after this fence
  ps_fence_proxy_async();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The operand ring
// ---------------------------------------------------------------------------
//
// The ring lies at the start of dynamic shared memory (1024-byte aligned), the
// resident slice after it. A stage holds one chunk of the step's left operand:
// BR = 64 * MG rows x KCB = KS * kc depth (MG warpgroups along the rows, KS =
// 2 / MG along the depth), as KCB / 64 boxes of BR rows x 128 bytes in TMA's
// 128-byte swizzle, which is also what wgmma reads as its left operand. A
// ninth warp feeds the ring: its first lane waits until the eight multiplying
// warps have left a stage (the stage's "empty" mbarrier, one arrival a warp),
// then asks the copy engine (TMA) for the stage's next chunk, a box an
// instruction; the engine counts the bytes on the stage's "full" mbarrier, on
// which the multiplying warps wait. No block-wide barrier is taken inside a
// product. Rows past the batch and depth past K arrive as zeros.
// (On an H100, one block an SM, the operand in L2, what a chunk costs the
// engine hardly depends on its bytes, the number of stages or of feeding
// threads: so chunks as large as fit; more but smaller stages measured
// slower. So did cp.async, 16 bytes a thread, where a warp stands still
// while it issues its copies, and ld.global.cg through registers.)

// The ring's state: the chunks fed since the kernel began, the same number in
// every thread. Chunk g lies in stage g % stages, and is the (g / stages)-th
// use of that stage, which gives the parity of the mbarrier phases to wait for.
struct PsPhases {
  uint32_t chunks = 0u;
};

// element offset of (row, k) in a stage; k a multiple of 8 addresses a unit
__device__ __forceinline__ int ps_ring_off(int row, int k, int BR) {
  return (k >> 6) * (BR * PS_BOX) + row * PS_BOX + ((((k & 63) >> 3) ^ (row & 7)) << 3) +
         (k & 7);
}

// Once, before the first product: per stage a "full" mbarrier (one arrival:
// the feeder's, with the bytes) at mbar[s] and an "empty" one (an arrival a
// multiplying warp) at mbar[PS_MAX_STAGES + s].
__device__ __forceinline__ void ps_ring_init(const bf16* ring, uint64_t* mbar,
                                             int stages) {
  if (threadIdx.x == 0) {
    if (ps_smem(ring) & 1023u) __trap();  // the swizzle counts rows from 1024 bytes
    for (int s = 0; s < stages; ++s) {
      ps_mbar_init(mbar + s, 1);
      ps_mbar_init(mbar + PS_MAX_STAGES + s, PS_WARPS);
    }
    ps_mbar_init_fence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The step product of one row block
// ---------------------------------------------------------------------------
//
// Cs[ks][r][c] (f32, rows NT * 8 + 1 apart) = partial sum, over the depth
// slice the warpgroup of split ks covered, of a[row0 + r][:] @ slice[c][:],
// for r < 64 * MG and c < NT * 8. Cs lies over the ring (the ring is idle once
// the product is done); the caller adds the KS = 2 / MG partial sums in order
// and ends with __syncthreads() before the next product.
//
// `a` is plane `plane` of the (planes, rows, K) tensor that `tmap` describes;
// with tma == 0 (rows that do not start on 16 bytes: no tensor map exists)
// the multiplying threads copy their pieces of a chunk element by element
// instead, with a barrier of their own per chunk. Kr (K rounded up to 64) is
// the depth of the slice. Every thread of the block calls this.

template <int NT>
__device__ __forceinline__ void ps_block_product(
    const bf16* a, const CUtensorMap* tmap, int tma, int plane, int row0, int rows,
    int K, int Kr, const bf16* Ws, bf16* ring, float* Cs, int MG, int stages, int kc,
    uint64_t* mbar, PsPhases& phases) {
  const int tid = threadIdx.x;
  // the warp's number, read from lane 0: the same in the whole warp by
  // construction, which the compiler must know to keep the wgmmas of a
  // warpgroup in flight together (on a path it takes for divergent it waits
  // for each one)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int wg = (warp >> 2) & 1;  // the warpgroup of a multiplying warp
  const int KS = 2 / MG;
  const int mg = wg & (MG - 1);
  const int ks = wg / MG;
  const int BR = MG * 64;
  const int KCB = KS * kc;  // a multiple of 64
  const int NC = NT * 8;
  const int nch = (K + KCB - 1) / KCB;
  const int stage_elems = BR * KCB;
  uint64_t* full = mbar;
  uint64_t* empty = mbar + PS_MAX_STAGES;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  PS_T0();
  const uint32_t g0 = phases.chunks;  // this product's first chunk
  if (tma) phases.chunks += nch;
  if (warp >= PS_WARPS) {
    // the feeder
    if (tma && lane == 0) {
      // what this thread may read with ordinary loads since the grid barrier,
      // the copy engine's reads must see too
      asm volatile("fence.proxy.async;\n" ::: "memory");
      int stage = g0 % stages;
      uint32_t use = g0 / stages;
      for (int c = 0; c < nch; ++c) {
        // the stage's use before this one has been left (a fresh stage: the
        // wait for the phase before the first passes at once)
        ps_mbar_wait(empty + stage, (use & 1u) ^ 1u);
        bf16* st = ring + stage * stage_elems;
        ps_mbar_expect_tx(full + stage, (uint32_t)stage_elems * 2u);
        for (int x = 0; x < KCB / PS_BOX; ++x)
          ps_tma_load_3d(st + x * BR * PS_BOX, tmap, c * KCB + x * PS_BOX, row0, plane,
                         full + stage);
        if (++stage == stages) {
          stage = 0;
          ++use;
        }
      }
    }
  } else {
    // element-by-element copy of chunk c (no tensor map): ppr = KCB / 8
    // pieces a row (a power of two, at most 32), so a thread's pieces share a
    // column and lie 256 / ppr rows apart
    auto copy_chunk = [&](int c, int stage) {
      bf16* st = ring + stage * stage_elems;
      const int ppr_log = __ffs(KCB >> 3) - 1;
      const int col = (tid & ((1 << ppr_log) - 1)) * 8;
      const int gk = c * KCB + col;
      for (int row = tid >> ppr_log; row < BR; row += PS_THREADS >> ppr_log) {
        unsigned short* d16 =
            reinterpret_cast<unsigned short*>(st + ps_ring_off(row, col, BR));
        const unsigned short* s16 =
            reinterpret_cast<const unsigned short*>(a + (size_t)(row0 + row) * K + gk);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d16[e] = (row0 + row < rows && gk + e < K) ? __ldcg(s16 + e) : (unsigned short)0;
      }
      ps_fence_proxy_async();  // wgmma reads shared memory as the copy engine does
    };

    if (!tma) copy_chunk(0, 0);
    int stage = tma ? g0 % stages : 0;
    uint32_t use = g0 / stages;
    for (int c = 0; c < nch; ++c) {
      if (tma) {  // chunk c has landed
        ps_mbar_wait(full + stage, use & 1u);
      } else {
        ps_sync_multipliers();  // chunk c is stored; every warp has left chunk c - 1
        if (c + 1 < nch) copy_chunk(c + 1, stage ^ 1);
      }
      PS_ACC(5);
      // this warpgroup's rows of the chunk, from its depth kk0 on: one wgmma
      // per 16 of depth, the depth inside a 64-deep tile 2 bytes an element
      const bf16* st = ring + stage * stage_elems + mg * 64 * PS_BOX;
      const int kk0 = ks * kc;
      const int kg0 = c * KCB + kk0;
      // 16-deep steps of this warpgroup's part that reach into the depth
      const int steps = min(kc, max(K - kg0 + 15, 0)) >> 4;
      ps_wgmma_fence();
      for (int s = 0; s < steps; ++s) {
        const int kk = kk0 + s * 16, kg = kg0 + s * 16;
        ps_wgmma<NT>(acc, ps_wgmma_desc(st + (kk >> 6) * (BR * PS_BOX) + (kk & 63)),
                     ps_wgmma_desc(Ws + (kg >> 6) * (NC * PS_BOX) + (kg & 63)));
      }
      ps_wgmma_commit();
      PS_ACC(10);
      // one chunk's products stay in flight while the next chunk's are issued:
      // wait for those of the chunk before, which have then read its stage
      if (tma) {
        ps_wgmma_wait<1>();
        PS_ACC(11);
        if (c > 0) {
          __syncwarp();
          if (lane == 0) ps_mbar_arrive(empty + (stage == 0 ? stages : stage) - 1);
        }
        if (++stage == stages) {
          stage = 0;
          ++use;
        }
      } else {
        ps_wgmma_wait<0>();  // the next barrier frees this stage
        stage ^= 1;
      }
      PS_ACC(6);
    }
    ps_wgmma_wait<0>();
    if (tma && nch > 0) {  // the last chunk's stage
      __syncwarp();
      if (lane == 0) ps_mbar_arrive(empty + (stage == 0 ? stages : stage) - 1);
    }
  }
  // the sums are in the registers now, not before (wgmma is asynchronous)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[n][e])::"memory");
  __syncthreads();  // every warp is done with the ring: Cs may overwrite it
  PS_ACC(7);

  const int ldc = NT * 8 + 1;
  float* Cw = Cs + (ks * BR + mg * 64 + (warp & 3) * 16) * ldc;
  const int r = lane >> 2;
  const int cc = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (warp >= PS_WARPS) break;  // the feeder holds no sums
    Cw[r * ldc + n * 8 + cc] = acc[n][0];
    Cw[r * ldc + n * 8 + cc + 1] = acc[n][1];
    Cw[(r + 8) * ldc + n * 8 + cc] = acc[n][2];
    Cw[(r + 8) * ldc + n * 8 + cc + 1] = acc[n][3];
  }
  ps_fence_proxy_async();  // the copy engine writes these bytes again later
  __syncthreads();
  PS_ACC(8);
}

// ---------------------------------------------------------------------------
// The step product of a batch of at most PS_DOT_ROWS rows, on the CUDA cores
// ---------------------------------------------------------------------------
//
// Cs[r][c] (f32, rows NT * 8 + 1 apart: the layout ps_block_product leaves
// with one depth split) = a[r][:] @ slice[c][:] for r < rows, c < NT * 8.
// a (rows, K) bf16, which other blocks wrote before the grid barrier, comes
// once through L2 (cp.async.cg) into shared memory at hs, rows Kr apart with
// zeros past K; each warp then owns the columns warp, warp + 9, ..., its lanes
// take 8-deep pieces of the depth 256 apart and meet through shuffles, in a
// fixed order. hs and Cs must not overlap. Every thread of the block calls
// this. (At B = 1 the wgmma ring spent 84% of a gru_scan step, mostly on
// its per-chunk waits, for 32 chunks of 63 zero rows and one real one:
// chip_smoke.py --phase-clocks on an NVIDIA H100 80GB HBM3 at 700 W. This
// product takes 69% of a step half as long; walking four columns a warp at
// a time, tried, left its clocks as they were.)

#define PS_DOT_ROWS 8

template <int NT>
__device__ __forceinline__ void ps_dot_product(const bf16* a, int rows, int K, int Kr,
                                               const bf16* Ws, bf16* hs, float* Cs) {
  const int tid = threadIdx.x;
  const bool vec = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0;
  const int pieces = Kr / 8;
  for (int p = tid; p < rows * pieces; p += PS_BLOCK) {
    const int r = p / pieces;
    const int k = (p - r * pieces) * 8;
    bf16* dst = hs + (size_t)r * Kr + k;
    const unsigned short* src = reinterpret_cast<const unsigned short*>(a + (size_t)r * K + k);
    if (vec && k + 8 <= K) {
      ps_cp_async16(dst, src);
    } else {
      unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
      for (int e = 0; e < 8; ++e) d16[e] = k + e < K ? __ldcg(src + e) : (unsigned short)0;
    }
  }
  ps_commit();
  ps_wait<0>();
  __syncthreads();

  constexpr int NC = NT * 8;
  const int warp = tid >> 5, lane = tid & 31;
  for (int c = warp; c < NC; c += PS_BLOCK / 32) {
    float acc[PS_DOT_ROWS];
#pragma unroll
    for (int r = 0; r < PS_DOT_ROWS; ++r) acc[r] = 0.0f;
    for (int k = lane * 8; k < Kr; k += 256) {
      // 8 of column c's depth from its swizzled tile (ps_load_slice's layout)
      const uint4 wv = *reinterpret_cast<const uint4*>(
          Ws + (k >> 6) * (NC * PS_BOX) + c * PS_BOX + ((((k & 63) >> 3) ^ (c & 7)) << 3));
      const uint32_t wu[4] = {wv.x, wv.y, wv.z, wv.w};
      float w[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wu[q]));
        w[2 * q] = f.x;
        w[2 * q + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < PS_DOT_ROWS; ++r) {
        if (r >= rows) break;
        const uint4 hv = *reinterpret_cast<const uint4*>(hs + (size_t)r * Kr + k);
        const uint32_t hu[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hu[q]));
          acc[r] = fmaf(f.x, w[2 * q], acc[r]);
          acc[r] = fmaf(f.y, w[2 * q + 1], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < PS_DOT_ROWS; ++r) {
      if (r >= rows) break;
      float v = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) Cs[r * (NC + 1) + c] = v;
    }
  }
  __syncthreads();
}

// the sum of the k_splits partial sums of element (r, c), in split order
__device__ __forceinline__ float ps_sum_splits(const float* Cs, int KS, int BR,
                                               int ldc, int r, int c) {
  float v = Cs[(size_t)r * ldc + c];
  for (int s = 1; s < KS; ++s) v += Cs[((size_t)s * BR + r) * ldc + c];
  return v;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Cooperative launch of `grid` blocks of `threads` threads with `smem` bytes
// of dynamic shared memory on stream s. Returns the CUDA error code:
// cudaErrorCooperativeLaunchTooLarge when the device cannot hold the grid.
static inline int ps_coop_launch(const void* kernel, int grid, int threads,
                                 size_t smem, void** args, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args,
                                    smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tensor map of a (planes, rows, K) bf16 tensor at `base` (rows K * 2
// bytes apart, a multiple of 16, from a 16-byte boundary), read in boxes of
// `box_rows` rows x 64 depth in the 128-byte swizzle. The encoder is
// cuTensorMapEncodeTiled of libcuda.so.1, which the CUDA runtime has loaded
// already: looked up by name, so nothing links against it. Returns the CUDA
// (runtime) error code, or cudaErrorUnknown when the encoder refuses.
static inline int ps_make_tmap(CUtensorMap* map, const void* base, int K, int rows,
                               int planes, int box_rows) {
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
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)K * 2 * rows};
  const cuuint32_t box[3] = {PS_BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
      box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorUnknown;
}

// whether the copy engine can read rows of K bf16 from `base`
static inline bool ps_tma_ok(const void* base, int K) {
  return (K % 8) == 0 && (reinterpret_cast<uintptr_t>(base) % 16) == 0;
}

// What the plan needs to know of the current device.
extern "C" int persist_device_info(int* sm_count, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// ---------------------------------------------------------------------------
// The barrier alone: `iters` barriers over `grid` blocks that each hold
// `smem` bytes. Before each barrier a block publishes the barrier's number;
// after it, it reads another block's slot through L2 and counts a slot that
// lags behind in *errors. Times the barrier and proves it orders memory.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PS_THREADS, 1)
ps_barrier_probe_kernel(unsigned int* counter, int* slots, int* errors,
                        int iters) {
  extern __shared__ __align__(16) unsigned char ps_probe_smem[];
  if (threadIdx.x == 0) ps_probe_smem[0] = 0;
  const int nb = gridDim.x;
  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x == 1) slots[blockIdx.x] = it + 1;
    ps_grid_barrier(counter, (unsigned int)(it + 1) * nb);
    if (threadIdx.x == 2) {
      const int other = (blockIdx.x + 1 + it) % nb;
      if (__ldcg(slots + other) < it + 1) atomicAdd(errors, 1);
    }
  }
}

extern "C" int persist_barrier_probe_launch(void* counter, void* slots,
                                            void* errors, int grid, int smem,
                                            int iters, void* stream) {
  unsigned int* c = static_cast<unsigned int*>(counter);
  int* sl = static_cast<int*>(slots);
  int* er = static_cast<int*>(errors);
  void* args[] = {&c, &sl, &er, &iters};
  return ps_coop_launch((const void*)ps_barrier_probe_kernel, grid, PS_THREADS,
                        (size_t)smem, args, reinterpret_cast<cudaStream_t>(stream));
}
