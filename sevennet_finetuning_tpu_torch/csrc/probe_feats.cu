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
// under a megabyte, so each is bound by its launch (a few microseconds),
// not by bytes or operations; the probes ask whether the feature works and
// how accurate it is, not how fast it runs.
//
// Design:
// - transpose: 32 x 33 shared-memory tiles (the padding column keeps the
//   transposed reads free of bank conflicts), coalesced loads and stores.
// - split: __float_as_uint and masks, the bf16 parts by intrinsic
//   (__float2bfloat16_rn, __bfloat162float); writes the three parts and
//   their sum hi + mid + lo, which must equal x bit for bit.
// - product: out[C, TE] = a[W, C]^T b[W, TE] on wgmma (m64n64k16, bf16 in,
//   f32 accumulate).  Each block splits its 64-column slices of a and b
//   into hi / mid / lo in shared memory as the split probe does, then sums
//   the six products mm, hl, lh, hm, mh, hh (smallest first) into one f32
//   accumulator over W / 16 k-steps: what Precision.HIGHEST does on the
//   TPU.  a^T and b both arrive MN-major (a is [W, C] and b is [W, TE],
//   both row-major, so C and TE are the contiguous axes); wgmma reads
//   MN-major operands from shared memory only through its transpose flags
//   (imm-trans-a, imm-trans-b), which it accepts for bf16 and fp16 but not
//   for tf32.  That is why the probe is bf16x3, not 3xTF32.  The shared
//   tiles use the no-swizzle layout: 8 x 16-byte core matrices, 8 K-rows
//   of 8 contiguous MN elements, at 128 bytes along MN (SBO) and 1024
//   bytes along K (LBO).
// - window: one thread reads the selector from device memory (there is no
//   scalar prefetch), walks the windows and, under the predicate
//   w == selector, issues one cp.async.bulk of that window into shared
//   memory with completion on an mbarrier; the block then writes the
//   window out.  A selector out of range issues no copy and gives zeros
//   (a bare arrive completes the barrier, so nothing waits forever).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;
constexpr int SPLIT_THREADS = 256;
constexpr int DOT_THREADS = 128;  // one warpgroup
constexpr int DOT_TILE = 64;      // M and N of a block; also the largest W
constexpr int DOT_PART_BYTES = DOT_TILE * DOT_TILE * 2;  // one bf16 part
constexpr int DOT_SMEM = 6 * DOT_PART_BYTES;             // 3 of a, 3 of b
constexpr uint32_t DOT_SBO = 128;   // next 8 MN elements
constexpr uint32_t DOT_LBO = 1024;  // next 8 K rows
constexpr int WINDOW_THREADS = 256;
constexpr int WINDOW_HEADER = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int rows, int cols) {
  __shared__ float tile[TILE][TILE + 1];
  const int c = blockIdx.x * TILE + threadIdx.x;
  const int r0 = blockIdx.y * TILE;
  for (int j = threadIdx.y; j < TILE; j += TILE_ROWS) {
    const int r = r0 + j;
    if (r < rows && c < cols) {
      tile[j][threadIdx.x] = x[static_cast<long long>(r) * cols + c];
    }
  }
  __syncthreads();
  // y is [cols, rows]: its row is x's column
  const int yc = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < TILE; j += TILE_ROWS) {
    const int yr = blockIdx.x * TILE + j;
    if (yr < cols && yc < rows) {
      y[static_cast<long long>(yr) * rows + yc] = tile[threadIdx.x][j];
    }
  }
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

// byte offset of element (mn, k) in an MN-major no-swizzle tile
__device__ __forceinline__ uint32_t mn_major_offset(int mn, int k) {
  return (mn / 8) * DOT_SBO + (k / 8) * DOT_LBO + (k % 8) * 16 + (mn % 8) * 2;
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  // start address, LBO and SBO in 16-byte units; base offset 0; layout
  // type 0 (no swizzle)
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((DOT_LBO & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((DOT_SBO & 0x3FFFF) >> 4) << 32);
}

// d += A * B for a 64 x 64 tile and k = 16, A and B MN-major (both
// transpose flags set)
__device__ __forceinline__ void wgmma_m64n64k16_tt(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one 64-column slice of src [w, ld] (row-major) split into three
// MN-major bf16 tiles
__device__ __forceinline__ void stage_split(const float* __restrict__ src,
                                            int w, int ld, int col0,
                                            unsigned char* tiles) {
  for (int i = threadIdx.x; i < w * DOT_TILE; i += DOT_THREADS) {
    const int k = i / DOT_TILE;
    const int mn = i % DOT_TILE;
    const Split3 p = split3(src[static_cast<long long>(k) * ld + col0 + mn]);
    const uint32_t off = mn_major_offset(mn, k);
    *reinterpret_cast<__nv_bfloat16*>(tiles + off) = p.hi;
    *reinterpret_cast<__nv_bfloat16*>(tiles + DOT_PART_BYTES + off) = p.mid;
    *reinterpret_cast<__nv_bfloat16*>(tiles + 2 * DOT_PART_BYTES + off) =
        p.lo;
  }
}

__global__ void __launch_bounds__(DOT_THREADS)
    dot_bf16x3_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int w, int m, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sa = smem;                       // hi, mid, lo of a^T
  unsigned char* sb = smem + 3 * DOT_PART_BYTES;  // hi, mid, lo of b
  const int m0 = blockIdx.x * DOT_TILE;
  const int n0 = blockIdx.y * DOT_TILE;
  stage_split(a, w, m, m0, sa);
  stage_split(b, w, n, n0, sb);
  // wgmma reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  // (part of a, part of b): mm, hl, lh, hm, mh, hh
  constexpr int pa[6] = {1, 0, 2, 0, 1, 0};
  constexpr int pb[6] = {1, 2, 0, 1, 0, 0};
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    for (int ks = 0; ks < w / 16; ++ks) {
      // k-step ks starts two 8-row K groups further on
      wgmma_m64n64k16_tt(
          d, smem_desc(sa + pa[p] * DOT_PART_BYTES + 2 * ks * DOT_LBO),
          smem_desc(sb + pb[p] * DOT_PART_BYTES + 2 * ks * DOT_LBO));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);

  // accumulator layout of m64nNk16: warp w owns rows 16w..16w+15; register
  // 4j + q holds row lane/4 (+8 for q >= 2), column 8j + 2(lane%4) + q%2
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int row = m0 + warp * 16 + lane / 4 + 8 * ((r / 2) % 2);
    const int col = n0 + (r / 4) * 8 + (lane % 4) * 2 + r % 2;
    out[static_cast<long long>(row) * n + col] = d[r];
  }
}

__global__ void __launch_bounds__(WINDOW_THREADS)
    window_kernel(const int* __restrict__ sel, const float* __restrict__ y,
                  float* __restrict__ out, int n_windows, int win_floats) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int& hit = *reinterpret_cast<int*>(smem + 8);
  float* buf = reinterpret_cast<float*>(smem + WINDOW_HEADER);
  if (threadIdx.x == 0) {
    const uint32_t b = smem_u32(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int s = *sel;
    hit = 0;
    for (int w = 0; w < n_windows; ++w) {
      if (w == s) {
        const uint32_t bytes = static_cast<uint32_t>(win_floats) * 4;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(buf)),
            "l"(reinterpret_cast<uint64_t>(
                y + static_cast<long long>(w) * win_floats)),
            "r"(bytes),
            "r"(b)
            : "memory");
        hit = 1;
      }
    }
    if (!hit) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b)
                   : "memory");
    }
  }
  __syncthreads();
  uint32_t done = 0;
  do {
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
  const float4* src = reinterpret_cast<const float4*>(buf);
  float4* dst = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < win_floats / 4; i += WINDOW_THREADS) {
    dst[i] = hit ? src[i] : zero;
  }
}

}  // namespace

extern "C" int probe_transpose_f32(const float* x, float* y, int rows,
                                   int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + TILE - 1) / TILE, (rows + TILE - 1) / TILE);
  transpose_kernel<<<grid, dim3(TILE, TILE_ROWS), 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_split_f32(const float* x, void* parts, float* out, int n,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  split_kernel<<<(n + SPLIT_THREADS - 1) / SPLIT_THREADS, SPLIT_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat16*>(parts), out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_dot_bf16x3_f32(const float* a, const float* b,
                                    float* out, int w, int m, int n,
                                    void* stream) {
  if (w <= 0 || w > DOT_TILE || w % 16 != 0 || m <= 0 || m % DOT_TILE != 0 ||
      n <= 0 || n % DOT_TILE != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(m / DOT_TILE, n / DOT_TILE);
  dot_bf16x3_kernel<<<grid, DOT_THREADS, DOT_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(a, b, out, w, m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_window_f32(const int* sel, const float* y, float* out,
                                int n_windows, int win_floats, void* stream) {
  const long long smem = WINDOW_HEADER + static_cast<long long>(win_floats) * 4;
  if (n_windows <= 0 || win_floats <= 0 || win_floats % 4 != 0 ||
      smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_kernel<<<1, WINDOW_THREADS, static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(sel, y, out, n_windows,
                                                       win_floats);
  return static_cast<int>(cudaGetLastError());
}
