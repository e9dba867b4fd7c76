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
// - tiled copy: the TPU's te was the step of a sequential pipelined grid,
//   never a limit on parallelism, so the grid here is sized to the card
//   (as many blocks as the SMs hold at once, from the occupancy API), not
//   to the number of tiles.  The tiles (em: te rows; fm: te columns of
//   every row, a row of te x 4 bytes at the slab's row stride) are cut
//   into chunks of COPY_THREADS x COPY_DEPTH float4s in row-major order
//   (an fm chunk is a range of the strip's rows), numbered tile by tile in
//   the TPU's tile order; block b takes chunks b, b + grid, ...  Each
//   thread issues its COPY_DEPTH 16-byte loads of a chunk before the
//   first store; nothing is reused, so loads and stores are streaming
//   (__ldcs / __stcs) and no shared memory is used.
//   tools/bench_dma.tiled_chunks mirrors the layout.
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
// - bulk-copy ring: the TPU's two rings, an input ring and an output ring
//   of S slots each, in shared memory; a persistent grid (as many blocks
//   as the SMs hold: several an SM where they fit) walks tiles blockIdx.x
//   + k * gridDim.x.  A tile is `rows` rows with 2 x S x rows x 3072
//   bytes <= 227 KB (the TPU's te = 256 tiles do not fit; the host planner
//   tools/bench_dma.ring_variants picks the shapes).  Each tile moves in
//   `split` column copies, as the TPU's split cut it: the slab is mapped
//   as a 3-D tensor (w, cols / w, rows) so that one box, one
//   cp.async.bulk.tensor copy, is the tile's rows x cols / split columns
//   (row-by-row 1-D copies made that 32 copies of 768 bytes a tile at
//   split 4).  A loading warp issues the loads, a lane per copy, into
//   input slot k % S with completion on that slot's "full" mbarrier; the
//   consumer warps wait for "full", multiply input slot k into output
//   slot k and arrive on the slot's "done" mbarrier; the loading warp
//   then refills input slot k with tile k + S at once, and a storing
//   warp stores output slot k, a lane per copy, so that a store that
//   drains slowly never holds back a load.  Output slot k is rewritten
//   by tile k + S, the TPU's rule (its store t - S is waited on only
//   before the slot is reused): after committing tile k's stores the
//   storing warp waits with cp.async.bulk.wait_group.read 0 and arrives
//   on the slot's "vacant" mbarrier.  Each storing lane commits one
//   group per tile.  Against one warp issuing loads and stores and
//   freeing tile k + 1's slot with S - 1 stores in flight, each of the
//   two choices gains on its own (PERF.md).  Every copy carries an
//   L2 evict-first hint: nothing is read twice.  No block-wide barrier
//   per tile.
//
// Every wait on an mbarrier traps after 2^26 polls (over a second; a
// whole launch takes ~50 us): a copy that never lands, or a protocol slip,
// is a launch error instead of a hung card.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found
                   // through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int COPY_DEPTH = 4;     // 16-byte loads in flight per thread
constexpr int COPY_CHUNK = COPY_THREADS * COPY_DEPTH;  // float4s a chunk
constexpr int SUM_WARPS = 8;      // bench_dma.COLSUM_WARPS
constexpr int SUM_THREADS = 32 * SUM_WARPS;
constexpr int SUM_DEPTH = 8;      // loads in flight per lane
constexpr int RING_CONSUMER_WARPS = 8;
constexpr int RING_PRODUCER_WARPS = 2;  // a loading and a storing warp
constexpr int RING_THREADS = 32 * (RING_PRODUCER_WARPS + RING_CONSUMER_WARPS);
constexpr int RING_MAX_SLOTS = 16;
// shared memory before the rings: three mbarriers a slot (full, done,
// vacant); bench_dma.RING_HEADER
constexpr int RING_HEADER = 3 * 8 * RING_MAX_SLOTS;
constexpr int SMEM_MAX = 232448;
constexpr int MAX_DEVICES = 64;

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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
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

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// one box of the 3-D tensor map `map` at (c0, c1, c2) into shared memory,
// its bytes counted on `bar`
__device__ __forceinline__ void tensor_load(void* dst_smem,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(dst_smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)), "l"(evict_first())
      : "memory");
}

// one box out of shared memory to the 3-D tensor map `map` at (c0, c1, c2)
__device__ __forceinline__ void tensor_store(const CUtensorMap* map, int c0,
                                             int c1, int c2,
                                             const void* src_smem) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      ".L2::cache_hint [%0, {%1, %2, %3}], [%4], %5;\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src_smem)),
      "l"(evict_first())
      : "memory");
}

// y = x * c over chunks of COPY_CHUNK float4s.  Tile t is the region of
// tile_n float4s at x + t * tile_step laid out as rows of width4 float4s
// at a row stride of stride4 (em: te contiguous rows; fm: a te-column
// strip of every row); its chunks are chunks_per_tile consecutive ranges
// of the region's row-major order.  Block b takes chunks b, b + grid, ...
__global__ void __launch_bounds__(COPY_THREADS)
    copy_tiled_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                      int width4, int stride4, long long tile_step,
                      int tile_n, int chunks_per_tile, int n_chunks,
                      float c) {
  // a thread's next element lies COPY_THREADS on in row-major order:
  // step_r rows and step_c float4s on
  const int step_r = COPY_THREADS / width4;
  const int step_c = COPY_THREADS - step_r * width4;
  for (int q = blockIdx.x; q < n_chunks; q += gridDim.x) {
    const int t = q / chunks_per_tile;
    const int j0 = (q - t * chunks_per_tile) * COPY_CHUNK + threadIdx.x;
    const long long base = static_cast<long long>(t) * tile_step;
    int r = j0 / width4;
    int col = j0 - r * width4;
    long long at[COPY_DEPTH];
    float4 v[COPY_DEPTH];
#pragma unroll
    for (int d = 0; d < COPY_DEPTH; ++d) {
      at[d] = base + static_cast<long long>(r) * stride4 + col;
      if (j0 + d * COPY_THREADS < tile_n) {
        v[d] = __ldcs(x + at[d]);
      }
      r += step_r;
      col += step_c;
      if (col >= width4) {
        col -= width4;
        ++r;
      }
    }
#pragma unroll
    for (int d = 0; d < COPY_DEPTH; ++d) {
      if (j0 + d * COPY_THREADS < tile_n) {
        __stcs(y + at[d], scale4(v[d], c));
      }
    }
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

// A tile's copies: the slab [n_rows, cols] is mapped as a 3-D tensor
// (w, cols / w, n_rows) whose box (w, piece / w, rows) is one of the TPU's
// column copies, `piece = cols / split` columns of the tile's rows; copy s
// of a tile lands at s * rows * piece floats of its slot, the box's rows
// one after the other.  The output slot has the same layout, so the
// elementwise multiply does not see it.

// loading lane: copy `lane` of local tile k into input slot k % slots
// (lane 0 first expects the tile's bytes on the slot's "full" mbarrier)
__device__ __forceinline__ void ring_load(const CUtensorMap* mx, float* in,
                                          uint64_t* full, int k, int lane,
                                          int rows, int cols, int slots,
                                          int split, int w) {
  const int slot = k % slots;
  const int tile = blockIdx.x + k * gridDim.x;
  const int piece = cols / split;
  if (lane == 0) {
    mbar_expect_tx(&full[slot],
                   static_cast<uint32_t>(rows) * cols * sizeof(float));
  }
  __syncwarp();
  if (lane < split) {
    tensor_load(in + (static_cast<long long>(slot) * split + lane) * rows *
                         piece,
                mx, 0, lane * piece / w, tile * rows, &full[slot]);
  }
}

// storing lane: copy `lane` of local tile k out of output slot k % slots,
// committed as one group per lane
__device__ __forceinline__ void ring_store(const CUtensorMap* my,
                                           const float* out, int k, int lane,
                                           int rows, int cols, int slots,
                                           int split, int w) {
  const int slot = k % slots;
  const int tile = blockIdx.x + k * gridDim.x;
  const int piece = cols / split;
  if (lane < split) {
    tensor_store(my, 0, lane * piece / w, tile * rows,
                 out + (static_cast<long long>(slot) * split + lane) * rows *
                           piece);
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// warp 0 loads and warp 1 stores, a lane per copy; the other warps
// consume (the multiply).  The three mbarriers of slot s: full[s] (its
// input tile landed: one arrive with the tile's bytes), done[s] (every
// consumer warp has read input slot s and written output slot s),
// vacant[s] (output slot s may be rewritten: the storing warp, once the
// slot's last store has read it)
__global__ void __launch_bounds__(RING_THREADS)
    copy_ring_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap my, int n_tiles,
                     int rows, int cols, int slots, int split, int w,
                     float c) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* done = full + RING_MAX_SLOTS;
  uint64_t* vacant = done + RING_MAX_SLOTS;
  const long long tile_floats = static_cast<long long>(rows) * cols;
  float* in = reinterpret_cast<float*>(smem + RING_HEADER);
  float* out = in + slots * tile_floats;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's tiles: blockIdx.x + k * gridDim.x for k < n_local
  const int n_local = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], RING_CONSUMER_WARPS);
      mbar_init(&vacant[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    for (int k = 0; k < slots && k < n_local; ++k) {
      ring_load(&mx, in, full, k, lane, rows, cols, slots, split, w);
    }
    for (int k = 0; k + slots < n_local; ++k) {
      mbar_wait(&done[k % slots], static_cast<uint32_t>((k / slots) & 1));
      ring_load(&mx, in, full, k + slots, lane, rows, cols, slots, split,
                w);
    }
    return;
  }
  if (warp == 1) {
    for (int k = 0; k < n_local; ++k) {
      mbar_wait(&done[k % slots], static_cast<uint32_t>((k / slots) & 1));
      ring_store(&my, out, k, lane, rows, cols, slots, split, w);
      // tile k + slots rewrites this output slot once the store has read
      // it
      if (k + slots < n_local) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&vacant[k % slots]);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  const int tile4 = static_cast<int>(tile_floats / 4);
  for (int k = 0; k < n_local; ++k) {
    const int slot = k % slots;
    const int lap = k / slots;
    if (lap > 0) {
      mbar_wait(&vacant[slot], static_cast<uint32_t>((lap - 1) & 1));
    }
    mbar_wait(&full[slot], static_cast<uint32_t>(lap & 1));
    const float4* src =
        reinterpret_cast<const float4*>(in + slot * tile_floats);
    float4* dst = reinterpret_cast<float4*>(out + slot * tile_floats);
#pragma unroll 4
    for (int i = threadIdx.x - 32 * RING_PRODUCER_WARPS; i < tile4;
         i += 32 * RING_CONSUMER_WARPS) {
      dst[i] = scale4(src[i], c);
    }
    // the bulk store reads the output slot through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[slot]);
  }
}

// the blocks of kernel `kern` an SM holds at `threads` threads and `smem`
// bytes of dynamic shared memory, times the SMs: per device, the largest
// shared memory granted so far and the last answer, cached
struct GridCache {
  int smem_set[MAX_DEVICES] = {};
  int key[MAX_DEVICES] = {};
  int grid[MAX_DEVICES] = {};
};

template <typename Kernel>
cudaError_t card_grid(Kernel kern, GridCache& cache, int threads, int smem,
                      int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > cache.smem_set[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    cache.smem_set[dev] = smem;
  }
  if (cache.key[dev] != smem + 1) {
    int n_sm = 0;
    int occ = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kern, threads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cache.key[dev] = smem + 1;
    cache.grid[dev] = occ * n_sm;
  }
  *grid = cache.grid[dev];
  return cudaSuccess;
}

}  // namespace

// em: tiles of te rows of x [rows, cols]; fm: strips of te columns of
// every row.  One launch of as many blocks as the card holds (or one a
// chunk, if fewer).
extern "C" int probe_copy_tiled_f32(const float* x, float* y, int rows,
                                    int cols, int te, int fm, float c,
                                    void* stream) {
  static GridCache cache;
  if (rows <= 0 || cols <= 0 || cols % 4 != 0 || te <= 0 ||
      (fm ? cols : rows) % te != 0 || (fm && te % 4 != 0) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      static_cast<long long>(rows) * cols / 4 >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols4 = cols / 4;
  const int width4 = fm ? te / 4 : cols4;
  const int n_tiles = fm ? cols / te : rows / te;
  const int tile_n = (fm ? rows : te) * width4;
  const int chunks_per_tile = (tile_n + COPY_CHUNK - 1) / COPY_CHUNK;
  const int n_chunks = n_tiles * chunks_per_tile;
  int grid = 0;
  cudaError_t err = card_grid(copy_tiled_kernel, cache, COPY_THREADS, 0,
                              &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_tiled_kernel<<<grid < n_chunks ? grid : n_chunks, COPY_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      width4, cols4,
      fm ? static_cast<long long>(width4)
         : static_cast<long long>(te) * cols4,
      tile_n, chunks_per_tile, n_chunks, c);
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

// y = x * c through the two rings: tiles of `rows` rows of x [n_rows,
// cols], `slots` slots a ring, each tile row in `split` bulk copies.  One
// launch of as many blocks as the card holds at this shared memory (or
// one a tile, if fewer).
// the box width of the ring's tensor map: the widest of 64 .. 4 floats
// (16-byte multiples) that divides a copy's `piece` columns in at most
// 256 (a box dimension's limit) steps; 0 if none does
// (bench_dma.ring_box)
static int ring_box_width(int piece) {
  for (int w = 64; w >= 4; w /= 2) {
    if (piece % w == 0 && piece / w <= 256) return w;
  }
  return 0;
}

// the slab [n_rows, cols] at `base` as the 3-D tensor (w, cols / w,
// n_rows) cut in boxes (w, piece / w, rows); the encoder,
// cuTensorMapEncodeTiled, is found once through the runtime
static cudaError_t ring_map(CUtensorMap* map, const float* base, int n_rows,
                            int cols, int rows, int piece, int w) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(cols / w),
                              static_cast<cuuint64_t>(n_rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * 4,
                                 static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(piece / w),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// y = x * c through the two rings: tiles of `rows` rows of x [n_rows,
// cols], `slots` slots a ring, each tile in `split` column copies.  One
// launch of as many blocks as the card holds at this shared memory (or
// one a tile, if fewer).
extern "C" int probe_copy_ring_f32(const float* x, float* y, int n_rows,
                                   int cols, int rows, int slots, int split,
                                   float c, void* stream) {
  static GridCache cache;
  if (rows <= 0 || rows > 256 || cols <= 0 || slots < 2 ||
      slots > RING_MAX_SLOTS || split <= 0 || split > 32 ||
      cols % split != 0 || n_rows % rows != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int piece = cols / split;
  const int w = ring_box_width(piece);
  // every copy's place in shared memory 128-byte aligned
  if (w == 0 || (static_cast<long long>(rows) * piece * 4) % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      RING_HEADER + 2LL * slots * rows * cols * static_cast<int>(sizeof(float));
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n_rows / rows;
  CUtensorMap mx, my;
  cudaError_t err = ring_map(&mx, x, n_rows, cols, rows, piece, w);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ring_map(&my, y, n_rows, cols, rows, piece, w);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = card_grid(copy_ring_kernel, cache, RING_THREADS,
                  static_cast<int>(smem), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_ring_kernel<<<grid < n_tiles ? grid : n_tiles, RING_THREADS,
                     static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      mx, my, n_tiles, rows, cols, slots, split, w, c);
  return static_cast<int>(cudaGetLastError());
}
