// Hopper feature probes: the four questions a faster cg_* kernel asks of
// the card.
//
// Replaces: tools/test_mosaic_feats.py, the four pallas_calls of its
// main(): t_transpose -> :47 (in-kernel transpose of a [256, 512] f32
// tile), t_split -> :74 (bitcast + mask split of f32 into three bf16
// parts whose sum is exact), t_dotgen -> :96 (a product contracting the
// leading axis of both operands at Precision.HIGHEST) and t_winDMA -> :123
// (a copy of one window of an HBM array, chosen by a runtime scalar under
// a predicate per window).
//
// Bound on the H100: at the TPU probe's shapes every probe moves well
// under a megabyte, so each is bound by its launch and its latency chain
// (a few microseconds), not by bytes or operations; the probes ask
// whether the feature works and how accurate it is.  The transpose moves
// 1,048,576 bytes (0.31 us at 3.35 TB/s), the split 458,752 (0.14 us),
// the product 557,056 (0.166 us; its 75.5 MFLOP of bf16 products take
// 0.08 us at 989 TFLOP/s) and the window 196,612 (0.059 us).  The floor,
// the profiler's device time of a launch that moves almost nothing
// (tools/bench_dma's overhead control, one block copying 4 KB), reads
// 1.40-1.41 us, and PyTorch's zero_ of the same 4 KB 0.91-0.93 us, on an
// H100 80GB HBM3 at 700.00 W (PERF.md, section 6), where the transpose
// reads 1.34 us and the split 1.17: each is its launch and one chain of
// dependent steps.  The kernels are therefore cut over many blocks, each
// with one short chain: a latency chain is paid once per block, in
// parallel, not once per element or once per tile of a single block.
//
// Design:
// - transpose: a block one warp and a 16 x 32 tile of x (256 blocks at
//   the probe's shape), a lane a 4 x 4 sub-block: four float4 loads of
//   four consecutive x rows (a warp load instruction reads 128
//   contiguous bytes of each of four rows), the transpose in registers,
//   four float4 stores into four consecutive y rows (a warp store
//   instruction writes 64 contiguous bytes, two whole sectors, of each
//   of eight y rows).  No shared memory, no barrier, no division: the
//   grid's x axis runs over column tiles, its y axis over row tiles.
//   The SASS (cuobjdump -sass on the H100 build, 42 registers) issues
//   the four LDG.E.128 back to back before any use, then the four
//   STG.E.128.  rows and cols must be multiples of 4 and x and y 16-byte
//   aligned; the C entry refuses anything else.  Against the 32 x 33
//   shared tile it replaced (1.52 us on the H100 80GB HBM3 at 700.00 W),
//   tried in the same calls on that card: two-warp blocks 1.35 us; a 1-D
//   grid, which divides for the tile, 0.035 us slower at two warps and
//   1.49-1.51 at four (64 blocks for 132 SMs); and 32 x 32 tensor-map
//   tiles (one 2-D cp.async.bulk.tensor copy in with the 128-byte
//   swizzle, the transpose through shared memory in a thread order free
//   of bank conflicts, one tensor store out) 1.41 us.
// - split: __float_as_uint and masks, the bf16 parts by intrinsic
//   (__float2bfloat16_rn, __bfloat162float); writes the three parts and
//   their sum hi + mid + lo, which must equal x bit for bit.  An element
//   a thread, 256 threads a block, any n up to SPLIT_MAX_N (no tail to
//   handle); the SASS is straight-line: one LDG, three STG.U16, one STG.
//   Wider threads read no faster (H100 80GB HBM3, 700.00 W): 2, 4 or 8
//   elements a thread (float2 / float4 loads, one 4-, 8- or 16-byte
//   store a part) 1.17, 1.17-1.20 and 1.26-1.29 us against 1.17, each
//   extra element lengthening the thread's chain of conversions.
// - product: out[C, TE] = a[W, C]^T b[W, TE] on wgmma (m64n16k16, bf16 in,
//   f32 accumulate), one warpgroup a 64 x 16 output tile: 96 blocks at
//   the probe's shape.  Each thread loads its chunks of the block's
//   operands by float4 loads, a trip count known at compile time (4
//   chunks of a's 64-column slice, 1 of b's 16-column slice, a chunk
//   being 8 consecutive MN elements of one K row; rows k >= W read as
//   zeros), then splits each chunk into hi / mid / lo (as the split
//   probe does) and writes each part as one 16-byte core-matrix row.
//   The source loads every chunk before it splits any, but ptxas
//   interleaves the two: the SASS issues a thread's 10 LDG.128 in four
//   rounds, each used before the next round is issued (chunks 2 and 3
//   overlap), not all at once.  Loads forced into three rounds
//   (unconditional, or volatile ld.global.nc) read the same device time
//   on the H100, so the rounds are not what bounds the block.  The 8
//   threads of a phase take 8 consecutive K rows of one core matrix, so
//   their writes meet no bank conflict.  wgmma then sums the six
//   products mm, hl, lh, hm, mh, hh (smallest first) into one f32
//   accumulator over the 4 k-steps of the largest W, in a fixed order
//   (two launches give the same bits): what Precision.HIGHEST does on the
//   TPU.  a^T and b both arrive MN-major (a is [W, C] and b
//   is [W, TE], both row-major, so C and TE are the contiguous axes);
//   wgmma reads MN-major operands from shared memory only through its
//   transpose flags (imm-trans-a, imm-trans-b), which it accepts for bf16
//   and fp16 but not for tf32.  That is why the probe is bf16x3, not
//   3xTF32.  The bf16 tiles use the no-swizzle layout: 8 x 16-byte core
//   matrices, 8 K-rows of 8 contiguous MN elements, at 128 bytes along
//   MN (SBO) and 128 x MN / 8 bytes along K (LBO).  The accumulator's
//   registers r and r + 1 hold adjacent columns of one row, stored as one
//   float2: each warp store writes 8 whole 32-byte sectors.  On the H100
//   the block's time is its chain of load, split and 24 wgmma: the same
//   kernel fed by one cp.async.bulk a row (W rows of a and of b onto one
//   mbarrier, issued by the lanes of one warp) took twice as long, and
//   64 x 32 tiles (48 blocks), or two and four warpgroups sharing a's
//   split, were slower than more blocks of one warpgroup (PERF.md,
//   section 6).
// - window: the window is cut into pieces (a plan the host computes:
//   tools/hopper_feats.window_plan), one block of one warp a piece.  In
//   each block one thread reads the selector from device memory (there is
//   no scalar prefetch), walks the windows and, under the predicate
//   w == selector, issues one cp.async.bulk of its piece of that window
//   into shared memory with completion on an mbarrier; it then stores the
//   piece to the output with one bulk store and waits for the store to
//   have read shared memory before the block exits.  No thread copies the
//   data element by element.  A selector out of range issues no copy (a
//   bare arrive completes the barrier, so nothing waits forever): the
//   warp writes zeros into shared memory, fences them into the async
//   proxy, and the same bulk store writes the piece as zeros.
//
// Every wait on an mbarrier traps after 2^26 polls (over a second; a
// launch takes microseconds): a copy that never lands is a launch error
// instead of a hung card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the transpose: a block one warp, a lane a 4 x 4 sub-block, the warp 4
// row groups x 8 column groups of them (tools/hopper_feats.TRANSPOSE_SUB,
// TRANSPOSE_BLOCK_ROWS); the row tiles run along the grid's y axis, at
// most TRANSPOSE_MAX_GRID_Y of them
constexpr int TRANSPOSE_SUB = 4;
constexpr int TRANSPOSE_BLOCK_ROWS = 16;
constexpr int TRANSPOSE_BLOCK_COLS = 32;
constexpr int TRANSPOSE_MAX_GRID_Y = 65535;
static_assert(TRANSPOSE_BLOCK_ROWS == 4 * TRANSPOSE_SUB &&
                  TRANSPOSE_BLOCK_COLS == 8 * TRANSPOSE_SUB &&
                  TRANSPOSE_SUB == 4,
              "a lane a float4 sub-block, 32 lanes a block");
constexpr int SPLIT_THREADS = 256;
// parts is indexed by int up to 3 n - 1 (tools/hopper_feats.SPLIT_MAX_N)
constexpr int SPLIT_MAX_N = 715827882;
constexpr int DOT_THREADS = 128;  // one warpgroup
constexpr int DOT_M = 64;  // output rows (C) of a block; also the largest W
constexpr int DOT_N = 16;  // output columns (TE) of a block: m64n16k16
constexpr int DOT_A_PART = DOT_M * DOT_M * 2;  // one bf16 part of a^T
constexpr int DOT_B_PART = DOT_M * DOT_N * 2;  // one bf16 part of b
constexpr uint32_t DOT_SBO = 128;              // next 8 MN elements
// 8-element chunks of each operand a thread loads and splits
constexpr int DOT_CHUNKS_A = DOT_M * DOT_M / 8 / DOT_THREADS;
constexpr int DOT_CHUNKS_B = DOT_M * DOT_N / 8 / DOT_THREADS;
static_assert(DOT_CHUNKS_A * DOT_THREADS * 8 == DOT_M * DOT_M &&
                  DOT_CHUNKS_B * DOT_THREADS * 8 == DOT_M * DOT_N,
              "whole chunks a thread");
// shared memory: three parts of each operand (30 KB)
constexpr int DOT_SMEM = 3 * DOT_A_PART + 3 * DOT_B_PART;
constexpr int WINDOW_THREADS = 32;  // one warp: lane 0 copies, all zero
constexpr int WINDOW_HEADER = 128;
// the largest piece: a block's default dynamic shared memory (48 KB)
// beside its mbarrier; tools/hopper_feats.WINDOW_MAX_PIECE
constexpr int WINDOW_MAX_PIECE = 49152 - WINDOW_HEADER;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits for the barrier's first phase
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// global -> shared, completing `bytes` on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x [rows, cols] -> y = x^T [cols, rows], a block one warp and a tile of
// TRANSPOSE_BLOCK_ROWS x TRANSPOSE_BLOCK_COLS of x: lane l takes the 4 x 4
// sub-block at row group l / 8 and column group l % 8 by four float4
// loads of four consecutive x rows, transposes it in registers and
// writes it by four float4 stores into four consecutive y rows.  rows and
// cols are multiples of 4 (the C entry checks), so a sub-block lies
// wholly inside x or wholly outside it
__global__ void __launch_bounds__(32)
    transpose_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int rows, int cols) {
  const int r0 = blockIdx.y * TRANSPOSE_BLOCK_ROWS + threadIdx.x / 8 * 4;
  const int c0 = blockIdx.x * TRANSPOSE_BLOCK_COLS + threadIdx.x % 8 * 4;
  if (r0 >= rows || c0 >= cols) return;
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __ldg(reinterpret_cast<const float4*>(
        x + static_cast<long long>(r0 + i) * cols + c0));
  }
  float* out = y + static_cast<long long>(c0) * rows + r0;
  *reinterpret_cast<float4*>(out) =
      make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<float4*>(out + rows) =
      make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
  *reinterpret_cast<float4*>(out + 2LL * rows) =
      make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
  *reinterpret_cast<float4*>(out + 3LL * rows) =
      make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
}

struct Split3 {
  __nv_bfloat16 hi, mid, lo;
};

// x = hi + mid + lo exactly: hi keeps x's top 16 bits, mid the top 16
// bits of the remainder, lo the rest (at most 8 significant bits)
__device__ __forceinline__ Split3 split3(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  const float r1 = __fsub_rn(x, hi);
  const float mid = __uint_as_float(__float_as_uint(r1) & 0xFFFF0000u);
  const float lo = __fsub_rn(r1, mid);
  return {__float2bfloat16_rn(hi), __float2bfloat16_rn(mid),
          __float2bfloat16_rn(lo)};
}

__global__ void __launch_bounds__(SPLIT_THREADS)
    split_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ parts,
                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (i >= n) return;
  const Split3 p = split3(x[i]);
  parts[i] = p.hi;
  parts[n + i] = p.mid;
  parts[2 * n + i] = p.lo;
  out[i] = __fadd_rn(__fadd_rn(__bfloat162float(p.hi), __bfloat162float(p.mid)),
                     __bfloat162float(p.lo));
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo,
                                               __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// chunk c of an operand MN elements wide: 8 consecutive MN elements
// (group g) of K row k.  The 8 chunks of a phase are 8 consecutive K rows
// of one core matrix, so their 16-byte writes fill it without a bank
// conflict
template <int MN>
__device__ __forceinline__ void chunk_of(int c, int& k, int& g) {
  constexpr int groups = MN / 8;
  k = c / (8 * groups) * 8 + c % 8;
  g = c / 8 % groups;
}

// this thread's chunks of src[w, ld] (row-major) at column col0, a trip
// count known at compile time; rows k >= w read as zeros
template <int MN, int CHUNKS>
__device__ __forceinline__ void load_chunks(const float* __restrict__ src,
                                            int ld, int col0, int w,
                                            float4 (&v)[CHUNKS][2]) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int k, g;
    chunk_of<MN>(threadIdx.x + i * DOT_THREADS, k, g);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* p = reinterpret_cast<const float4*>(
        src + static_cast<long long>(k) * ld + col0 + g * 8);
    v[i][0] = k < w ? __ldg(p) : zero;
    v[i][1] = k < w ? __ldg(p + 1) : zero;
  }
}

// the chunks split into three MN-major no-swizzle bf16 tiles, `part`
// bytes apart: one 16-byte core-matrix row of each part a chunk
template <int MN, int CHUNKS>
__device__ __forceinline__ void split_chunks(const float4 (&v)[CHUNKS][2],
                                             unsigned char* parts, int part) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    int k, g;
    chunk_of<MN>(threadIdx.x + i * DOT_THREADS, k, g);
    const float x[8] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w,
                        v[i][1].x, v[i][1].y, v[i][1].z, v[i][1].w};
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Split3 p0 = split3(x[2 * j]);
      const Split3 p1 = split3(x[2 * j + 1]);
      hi[j] = bf16_pair(p0.hi, p1.hi);
      mid[j] = bf16_pair(p0.mid, p1.mid);
      lo[j] = bf16_pair(p0.lo, p1.lo);
    }
    const uint32_t off = g * DOT_SBO + (k / 8) * (MN / 8 * 128) + (k % 8) * 16;
    *reinterpret_cast<uint4*>(parts + off) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(parts + part + off) =
        make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(parts + 2 * part + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// an MN-major no-swizzle tile of MN columns: start address, LBO (the next
// 8 K rows) and SBO (the next 8 MN elements) in 16-byte units; base
// offset 0; layout type 0 (no swizzle)
template <int MN>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  constexpr uint32_t lbo = MN / 8 * 128;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((DOT_SBO & 0x3FFFF) >> 4) << 32);
}

// d += A * B for a 64 x 16 tile and k = 16, A and B MN-major (both
// transpose flags set)
__device__ __forceinline__ void wgmma_m64n16k16_tt(float (&d)[8],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(DOT_THREADS)
    dot_bf16x3_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int w, int m, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sa = smem;                   // hi, mid, lo of a^T
  unsigned char* sb = smem + 3 * DOT_A_PART;  // hi, mid, lo of b
  const int m0 = blockIdx.x * DOT_M;
  const int n0 = blockIdx.y * DOT_N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float4 va[DOT_CHUNKS_A][2];
  float4 vb[DOT_CHUNKS_B][2];
  load_chunks<DOT_M>(a, m, m0, w, va);
  load_chunks<DOT_N>(b, n, n0, w, vb);
  split_chunks<DOT_M>(va, sa, DOT_A_PART);
  split_chunks<DOT_N>(vb, sb, DOT_B_PART);
  // wgmma reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = 0.f;
  // (part of a, part of b): mm, hl, lh, hm, mh, hh
  constexpr int pa[6] = {1, 0, 2, 0, 1, 0};
  constexpr int pb[6] = {1, 2, 0, 1, 0, 0};
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    // every k-step of the largest W: the parts of rows k >= w are zeros,
    // which add exactly nothing
#pragma unroll
    for (int ks = 0; ks < DOT_M / 16; ++ks) {
      // k-step ks starts two 8-row K groups further on
      wgmma_m64n16k16_tt(
          d,
          smem_desc<DOT_M>(sa + pa[p] * DOT_A_PART + ks * 2 * DOT_M * 16),
          smem_desc<DOT_N>(sb + pb[p] * DOT_B_PART + ks * 2 * DOT_N * 16));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);

  // accumulator layout of m64nNk16: warp w owns rows 16w..16w+15;
  // register 4j + q holds row lane/4 (+8 for q >= 2), column 8j +
  // 2(lane%4) + q%2, so registers 4j + 2h and 4j + 2h + 1 are one float2:
  // a warp's store fills 8 whole 32-byte sectors
#pragma unroll
  for (int j = 0; j < DOT_N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + lane / 4 + 8 * h;
      const int col = n0 + j * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(out + static_cast<long long>(row) * n + col) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// piece blockIdx.x (piece_floats long, the last one shorter) of window
// *sel of y, or zeros for a selector out of range
__global__ void __launch_bounds__(WINDOW_THREADS)
    window_kernel(const int* __restrict__ sel, const float* __restrict__ y,
                  float* __restrict__ out, int n_windows, int win_floats,
                  int piece_floats) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + WINDOW_HEADER);
  const int start = blockIdx.x * piece_floats;
  const uint32_t bytes =
      static_cast<uint32_t>(min(piece_floats, win_floats - start)) * 4;
  int hit = 0;
  if (threadIdx.x == 0) {
    const int s = *sel;
    mbar_init(bar);
    for (int w = 0; w < n_windows; ++w) {
      if (w == s) {
        mbar_expect_tx(bar, bytes);
        bulk_load(buf, y + static_cast<long long>(w) * win_floats + start,
                  bytes, bar);
        hit = 1;
      }
    }
    if (!hit) mbar_arrive(bar);
  }
  hit = __shfl_sync(0xFFFFFFFFu, hit, 0);
  if (!hit) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (uint32_t i = threadIdx.x; i < bytes / 16; i += WINDOW_THREADS) {
      reinterpret_cast<float4*>(buf)[i] = zero;
    }
    // the bulk store reads the zeros through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  if (threadIdx.x == 0) {
    mbar_wait0(bar);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            reinterpret_cast<uint64_t>(out + start)),
        "r"(smem_u32(buf)), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // shared memory must outlive the store's read of it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace

extern "C" int probe_transpose_f32(const float* x, float* y, int rows,
                                   int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || rows % TRANSPOSE_SUB != 0 ||
      cols % TRANSPOSE_SUB != 0 ||
      (rows + TRANSPOSE_BLOCK_ROWS - 1) / TRANSPOSE_BLOCK_ROWS >
          TRANSPOSE_MAX_GRID_Y ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + TRANSPOSE_BLOCK_COLS - 1) / TRANSPOSE_BLOCK_COLS,
                  (rows + TRANSPOSE_BLOCK_ROWS - 1) / TRANSPOSE_BLOCK_ROWS);
  transpose_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_split_f32(const float* x, void* parts, float* out, int n,
                               void* stream) {
  if (n <= 0 || n > SPLIT_MAX_N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_kernel<<<(n + SPLIT_THREADS - 1) / SPLIT_THREADS, SPLIT_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat16*>(parts), out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_dot_bf16x3_f32(const float* a, const float* b,
                                    float* out, int w, int m, int n,
                                    void* stream) {
  if (w <= 0 || w > DOT_M || w % 16 != 0 || m <= 0 || m % DOT_M != 0 ||
      n <= 0 || n % DOT_N != 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(m / DOT_M, n / DOT_N);
  dot_bf16x3_kernel<<<grid, DOT_THREADS, DOT_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(a, b, out, w, m, n);
  return static_cast<int>(cudaGetLastError());
}

// the window cut into n_pieces of piece_floats (the last one shorter), one
// block each: the host's plan (tools/hopper_feats.window_plan)
extern "C" int probe_window_f32(const int* sel, const float* y, float* out,
                                int n_windows, int win_floats, int n_pieces,
                                int piece_floats, void* stream) {
  if (n_windows <= 0 || win_floats <= 0 || win_floats % 4 != 0 ||
      piece_floats <= 0 || piece_floats % 4 != 0 ||
      piece_floats > WINDOW_MAX_PIECE / 4 || n_pieces <= 0 ||
      static_cast<long long>(n_pieces - 1) * piece_floats >= win_floats ||
      static_cast<long long>(n_pieces) * piece_floats < win_floats ||
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window_kernel<<<n_pieces, WINDOW_THREADS, WINDOW_HEADER + piece_floats * 4,
                  static_cast<cudaStream_t>(stream)>>>(
      sel, y, out, n_windows, win_floats, piece_floats);
  return static_cast<int>(cudaGetLastError());
}
