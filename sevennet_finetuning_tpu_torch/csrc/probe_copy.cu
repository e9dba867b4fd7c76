// Copy-bandwidth probes: y = x * c through two pipelining strategies, and
// a read-only column sum.
//
// Replaces: tools/bench_dma.py, the three pallas_calls of its main():
// bs_copy -> :84 (a BlockSpec auto-pipelined copy by row tiles, "em", or by
// column strips of the transposed slab, "fm"), bs_read -> :109 (a column
// sum accumulated in o_ref across a sequential grid) and manual_copy ->
// :167 (an S-slot HBM -> VMEM -> HBM DMA ring, each tile optionally cut
// into `split` concurrent column copies).
//
// Bound on the H100: memory.  A copy reads and writes E * D * 4 bytes and
// the sum reads them once; one multiply or add per element is far below
// the card's arithmetic rate.  The probes ask what share of the published
// 3.35 TB/s a hand-written kernel reaches with each strategy.
//
// Design:
// - tiled copy: one block per row tile or column strip, standing in for
//   the TPU's sequential grid; each thread moves 16 bytes per load and
//   store, neighbouring threads on neighbouring addresses.  A grid of
//   E / te blocks leaves SMs idle when te is large: that is part of what
//   the sweep measures, as the TPU sweep measured its tile sizes.
// - column sum in two passes: Hopper blocks run in no order and cannot
//   carry the TPU's o_ref += (bench_dma.py:107) across the grid.  Pass 1
//   cuts the rows into slabs of `slab` rows and the float4 columns into
//   bands of 32, one block a (slab, band), enough blocks to fill every SM
//   several times (504 at the TPU tool's shape); each warp of the block
//   takes a contiguous stripe of the slab's rows, a lane one float4
//   column, and keeps SUM_DEPTH 16-byte loads in flight before adding
//   them in row order; the block adds its warps' sums in warp order and
//   writes the slab's partial row.  Pass 2 adds the partial rows in slab
//   order.  The schedule does not follow the TPU's tile te (its grid
//   step), which only has to divide the rows, as it does there
//   (tools/bench_dma.py, colsum_stripes, mirrors it).  No atomics: every
//   run gives the same bits.
// - bulk-copy ring: a persistent grid (one block per SM) walks its tiles
//   through an S-slot ring in shared memory.  cp.async.bulk brings a tile
//   in with completion on the slot's mbarrier, the block multiplies it in
//   place, and cp.async.bulk writes it out; a slot is reloaded once its
//   store has finished reading it (cp.async.bulk.wait_group.read).  The
//   TPU's tiles (te x 768 x 4 bytes, 768 KB at te = 256, in two rings of
//   S) do not fit 227 KB, so a tile here is `rows` rows with
//   rows x S x 3072 bytes <= 227 KB; the host planner
//   (tools/bench_dma.ring_variants) picks them.  `split` cuts each tile
//   row into that many bulk copies (each a multiple of 16 bytes, 16-byte
//   aligned), as the TPU's split cut each tile into column copies.  One
//   warp issues the copies, a lane per copy; each lane waits only on its
//   own store groups, and its loads refill exactly the bytes its stores
//   read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COPY_THREADS = 512;
constexpr int SUM_WARPS = 8;      // bench_dma.COLSUM_WARPS
constexpr int SUM_THREADS = 32 * SUM_WARPS;
constexpr int SUM_DEPTH = 8;      // loads in flight per lane
constexpr int RING_THREADS = 256;
constexpr int RING_HEADER = 128;  // bytes of shared memory for the mbarriers
constexpr int RING_MAX_SLOTS = RING_HEADER / 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float4 scale4(float4 v, float c) {
  v.x *= c;
  v.y *= c;
  v.z *= c;
  v.w *= c;
  return v;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst_smem)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src_smem)), "r"(bytes)
      : "memory");
}

// y = x * c over this block's region: n_rows rows of width4 float4s at a
// row stride of stride4, starting block_step float4s after the last block's
__global__ void __launch_bounds__(COPY_THREADS)
    copy_tiled_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                      int n_rows, int width4, int stride4,
                      long long block_step, float c) {
  const long long base = static_cast<long long>(blockIdx.x) * block_step;
  const int n = n_rows * width4;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += COPY_THREADS) {
    const int r = i / width4;
    const long long at =
        base + static_cast<long long>(r) * stride4 + (i - r * width4);
    y[at] = scale4(x[at], c);
  }
}

// pass 1: part[slab, band's columns] = the sum of the slab's rows (block
// (band, slab)): each warp a contiguous stripe of the slab's rows, added
// in row order, SUM_DEPTH rows' loads in flight at a time; then the
// warps' sums in warp order
__global__ void __launch_bounds__(SUM_THREADS)
    colsum_slab_kernel(const float4* __restrict__ x,
                       float4* __restrict__ part, int rows, int cols4,
                       int slab) {
  __shared__ float4 wsum[SUM_WARPS][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q = blockIdx.x * 32 + lane;  // the lane's float4 column
  const bool active = q < cols4;
  const int r0 = blockIdx.y * slab;
  const int n = min(slab, rows - r0);
  const int per = (n + SUM_WARPS - 1) / SUM_WARPS;
  const int w0 = r0 + min(n, warp * per);
  const int w1 = r0 + min(n, (warp + 1) * per);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = w0; r < w1; r += SUM_DEPTH) {
    float4 v[SUM_DEPTH];
#pragma unroll
    for (int d = 0; d < SUM_DEPTH; ++d) {
      v[d] = active && r + d < w1
                 ? __ldcs(x + static_cast<long long>(r + d) * cols4 + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int d = 0; d < SUM_DEPTH; ++d) {
      acc.x += v[d].x;
      acc.y += v[d].y;
      acc.z += v[d].z;
      acc.w += v[d].w;
    }
  }
  wsum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && active) {
    float4 s = wsum[0][lane];
#pragma unroll
    for (int w = 1; w < SUM_WARPS; ++w) {
      s.x += wsum[w][lane].x;
      s.y += wsum[w][lane].y;
      s.z += wsum[w][lane].z;
      s.w += wsum[w][lane].w;
    }
    part[static_cast<long long>(blockIdx.y) * cols4 + q] = s;
  }
}

// pass 2: out[col] = sum over slabs of part[slab, col], in slab order,
// SUM_DEPTH slabs' loads in flight at a time
__global__ void colsum_final_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int n_slab,
                                    int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float acc = 0.f;
  for (int t = 0; t < n_slab; t += SUM_DEPTH) {
    float v[SUM_DEPTH];
#pragma unroll
    for (int d = 0; d < SUM_DEPTH; ++d)
      v[d] = t + d < n_slab ? part[static_cast<long long>(t + d) * cols + col]
                            : 0.f;
#pragma unroll
    for (int d = 0; d < SUM_DEPTH; ++d) acc += v[d];
  }
  out[col] = acc;
}

// warp 0: the copies of local tile k into its slot, one lane per copy
__device__ __forceinline__ void ring_load(const float* x, float* buf,
                                          uint64_t* full, int k, int lane,
                                          int rows, int cols, int slots,
                                          int split) {
  const int slot = k % slots;
  const long long tile =
      blockIdx.x + static_cast<long long>(k) * gridDim.x;
  const int piece = cols / split;
  if (lane == 0) {
    mbar_expect_tx(&full[slot],
                   static_cast<uint32_t>(rows) * cols * sizeof(float));
  }
  __syncwarp();
  float* dst = buf + static_cast<long long>(slot) * rows * cols;
  for (int i = lane; i < rows * split; i += 32) {
    const int r = i / split;
    const int s = i - r * split;
    bulk_load(dst + r * cols + s * piece,
              x + (tile * rows + r) * cols + s * piece,
              static_cast<uint32_t>(piece) * sizeof(float), &full[slot]);
  }
}

// warp 0: the copies of local tile k out of its slot, one lane per copy
// (the same partition as ring_load), committed as one group per lane
__device__ __forceinline__ void ring_store(float* y, const float* buf, int k,
                                           int lane, int rows, int cols,
                                           int slots, int split) {
  const int slot = k % slots;
  const long long tile =
      blockIdx.x + static_cast<long long>(k) * gridDim.x;
  const int piece = cols / split;
  const float* src = buf + static_cast<long long>(slot) * rows * cols;
  for (int i = lane; i < rows * split; i += 32) {
    const int r = i / split;
    const int s = i - r * split;
    bulk_store(y + (tile * rows + r) * cols + s * piece,
               src + r * cols + s * piece,
               static_cast<uint32_t>(piece) * sizeof(float));
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(RING_THREADS)
    copy_ring_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int n_tiles, int rows, int cols, int slots, int split,
                     float c) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + RING_HEADER);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's tiles: blockIdx.x + k * gridDim.x for k < n_local
  const int n_local = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int tile4 = rows * cols / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    for (int k = 0; k < slots && k < n_local; ++k) {
      ring_load(x, buf, full, k, lane, rows, cols, slots, split);
    }
  }
  for (int k = 0; k < n_local; ++k) {
    const int slot = k % slots;
    // refill the slot of tile k - 1 with tile k - 1 + slots once the
    // store of tile k - 1 has read it
    if (warp == 0 && k >= 1 && k - 1 + slots < n_local) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
      ring_load(x, buf, full, k - 1 + slots, lane, rows, cols, slots, split);
    }
    mbar_wait(&full[slot], static_cast<uint32_t>((k / slots) & 1));
    float4* t4 = reinterpret_cast<float4*>(
        buf + static_cast<long long>(slot) * rows * cols);
    for (int i = threadIdx.x; i < tile4; i += RING_THREADS) {
      t4[i] = scale4(t4[i], c);
    }
    // the bulk store reads shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (warp == 0) ring_store(y, buf, k, lane, rows, cols, slots, split);
  }
  if (warp == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace

extern "C" int probe_copy_tiled_f32(const float* x, float* y, int rows,
                                    int cols, int te, int fm, float c,
                                    void* stream) {
  // em: one block per te rows of [rows, cols]; fm: one block per te
  // columns of every row
  const int n_blocks = fm ? cols / te : rows / te;
  if (n_blocks <= 0 || cols % 4 != 0 || te % (fm ? 4 : 1) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols4 = cols / 4;
  copy_tiled_kernel<<<n_blocks, COPY_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      fm ? rows : te, fm ? te / 4 : cols4, cols4,
      fm ? static_cast<long long>(te / 4)
         : static_cast<long long>(te) * cols4,
      c);
  return static_cast<int>(cudaGetLastError());
}

// x [rows, cols] (cols a multiple of 4) -> out [cols]; part: scratch of
// ceil(rows / slab) x cols floats.  te, the TPU tool's tile, must divide
// the rows; the schedule does not use it.
extern "C" int probe_colsum_f32(const float* x, float* part, float* out,
                                int rows, int cols, int te, int slab,
                                void* stream) {
  if (te <= 0 || rows % te != 0 || rows <= 0 || slab <= 0 ||
      cols % 4 != 0 || cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slab = (rows + slab - 1) / slab;
  const int cols4 = cols / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  colsum_slab_kernel<<<dim3((cols4 + 31) / 32, n_slab), SUM_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(part),
      rows, cols4, slab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_final_kernel<<<(cols + 255) / 256, 256, 0, s>>>(part, out, n_slab,
                                                        cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_copy_ring_f32(const float* x, float* y, int n_rows,
                                   int cols, int rows, int slots, int split,
                                   int n_blocks, float c, void* stream) {
  const int n_tiles = n_rows / rows;
  const long long smem =
      RING_HEADER + static_cast<long long>(slots) * rows * cols * 4;
  if (n_tiles <= 0 || n_tiles * rows != n_rows || slots < 2 ||
      slots > RING_MAX_SLOTS || split <= 0 || cols % split != 0 ||
      (cols / split * 4) % 16 != 0 || smem > 232448 || n_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      copy_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_blocks < n_tiles ? n_blocks : n_tiles;
  copy_ring_kernel<<<grid, RING_THREADS, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      x, y, n_tiles, rows, cols, slots, split, c);
  return static_cast<int>(cudaGetLastError());
}
