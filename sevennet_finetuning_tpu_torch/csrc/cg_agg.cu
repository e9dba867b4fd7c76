// Fused convolution forward ('agg'): uvu CG messages summed onto their
// destination nodes,
//   out[n, msg_off + k*mul + u] = sum over edges e of node n of
//       w[e, w_off + u] * sum_i x[e, x_off + i*mul + u] * B_e[k][i],
//   B_e[k][i] = sum_j c * sh[e, sh_off + j]
// over the couplings (k, i, j, c) of each path (x chunk, sh irrep, output
// irrep, mul channels u).  The [E, dim_msg] message tensor is never stored.
//
// Replaces: sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py, agg_pallas
// -> the pallas_call of _kernel (per edge tile: messages in VMEM, then a
// one-hot matmul onto the node tile).
//
// Bound on the H100: memory.  Each live edge's rows of x, sh and w are read
// once (1,449 floats at SevenNet-0's interior block) and each node row of
// the output written once; there are about 2.2 multiply-adds per message
// element, far below the bytes' time.  No tensor cores: the function has
// no product with a reduction deep enough to feed them, and the port runs
// float32 with TF32 off.
//
// Design: the edges are dst-sorted, so the edges of `nodes` consecutive
// nodes are one contiguous run [offs[n0], offs[n0 + nodes]) of rows in
// each of x, sh and w.  A block takes such a node group and walks its run
// in tiles of `tile` edges through a ring of `stages` stages in shared
// memory.  One thread issues each tile as three bulk asynchronous copies
// (cp.async.bulk, completion on the stage's mbarrier), `stages` tiles
// ahead of the tile being computed.  A bulk copy needs a 16-byte aligned
// source, destination and size: a tile's rows of an array are copied as
// the enclosing 16-byte aligned span and read at an offset (the sh rows
// are 9 floats; ops/cg_tables.py, agg_span); rows that reach into the
// array's last partial 16 bytes are finished by plain loads.  Sentinel
// edges (dst = n_node) lie past every node's range and are never staged.
//
// Per tile, the block first forms every edge's B row (a float per path,
// k and i, each a short sum of c * sh[j] over the path's couplings) in
// shared memory, then each warp computes its items: an item is one node
// of the block and one unit, a path and a 32-channel slice of its x
// chunk, and a lane is a channel u.  Lanes read X and W from shared
// memory on consecutive channels (no bank conflicts) and the B row by
// broadcast, as float4s.  Per edge in edge order, m[k] = sum_i X[i] B[k][i]
// and acc[k] += w * m[k], every product rounded before its add: the order
// of JAX's composition on the CPU (B = sum_j c sh[j], the x contraction,
// then the message times w, then the segment sum in edge order).  The
// batch-8 train golden's sensitive gradients track that rounding: with
// fma for the w product (one-term cg_gagg.cu's order) the last
// convolution's denominator read 0.159 of its size against JAX's (limit
// 0.1), in this order 0.064 (chip_smoke.py).  Of the variants between,
// the rounded w product alone passed with less margin and an unfused B
// failed, so B keeps its fma.  The running sums of
// an item live in registers over a tile and in shared memory between
// tiles, so a warp can take several items; the plan (cg_tables.agg_plan)
// spreads the items over the warps by cost.  The paths write disjoint
// columns and each item is one warp's: no atomics, a fixed order, every
// launch gives the same bits.  A node without edges writes zeros.
//
// What limits it: the arithmetic, not the copies.  At SevenNet-0's
// interior block on an H100 (tools/agg_sweep.py --phases) the copies alone
// take 75.5 us (2.66 TB/s, the card's copy rate) and the arithmetic alone
// 136.9 us of the whole kernel's 137.4: each tile runs the B rows and then
// the items between block barriers, and every item reads its x, w and B
// values from shared memory for each edge.  The tile, the stage count, the
// nodes and the warps a block are launch parameters, chosen by the same
// sweep (ops/fused_conv_agg.py, agg_config); a stage must fit beside the
// ring's others, the B rows and the accumulators in the block's shared
// memory, which sets how many blocks share an SM.

#include <cuda_runtime.h>
#include <stdint.h>

// Measurement builds (tools/agg_sweep.py --phases; never on a user path):
// CG_AGG_ONLY=1 keeps the copies and drops the arithmetic (B rows and
// items); CG_AGG_ONLY=2 keeps the arithmetic and copies only the first
// `stages` tiles, so later tiles compute on stale rows.
#ifndef CG_AGG_ONLY
#define CG_AGG_ONLY 0
#endif

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxStages = 8;   // cg_tables.AGG_MAX_STAGES
constexpr int kMaxNodes = 8;    // cg_tables.AGG_MAX_NODES
constexpr int kItem = 10;       // cg_tables.AGG_ITEM
constexpr int kEntry = 16;      // cg_tables.AGG_ENTRY
constexpr int kMaxSteps = 7;    // cg_tables.AGG_MAX_STEPS
// shared memory of a block: 232,448 bytes, of which the static arrays
// (the mbarriers and node offsets) take 128 (cg_tables.AGG_SMEM_MAX)
constexpr int kSmemMax = 232448;
constexpr int kStaticSmem = 128;

struct Args {
  const float* x;
  const float* sh;
  const float* w;
  const int* offs;   // [n_node + 1] dst-sorted edge ranges
  const int* plan;   // cg_tables.AggPlan.packed()
  float* out;        // [n_node, dim_msg]
  long long n_x, n_sh, n_w;  // floats of each edge array
  int n_node, dim_x, dim_sh, dim_w, dim_msg;
  int tile, stages, nodes;
  // shared memory in floats (cg_tables.agg_smem)
  int x_cap, sh_cap, stage, b_base, acc_base, b_row;
  // the plan's sections (cg_tables.AggPlan.packed's meta)
  int n_entry, warp_start, items, entries;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
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

// a stage's copies land in microseconds: a wait of ~2^30 polls is a
// fault (a copy that was never issued), which traps as a launch error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
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

// The staging of rows [e0, e0 + ne) of an array of width dim (cg_tables.
// agg_span): floats [a0, a0 + bulk) by a bulk copy, [a0 + bulk, f1) by
// plain loads, float f to buf[f - a0]; returns the row offset f0 - a0.
struct Span {
  long long a0, bulk, f1;
  int off;
};

__device__ __forceinline__ Span span_of(int e0, int ne, int dim,
                                        long long total) {
  const long long f0 = static_cast<long long>(e0) * dim;
  const long long f1 = static_cast<long long>(e0 + ne) * dim;
  const long long a0 = f0 & ~3LL;
  long long a1 = (f1 + 3) & ~3LL;
  const long long last = total & ~3LL;
  if (a1 > last) a1 = last;
  Span s;
  s.a0 = a0;
  s.bulk = a1 > a0 ? a1 - a0 : 0;
  s.f1 = f1;
  s.off = static_cast<int>(f0 - a0);
  return s;
}

__device__ __forceinline__ void stage_tail(float* buf, const float* src,
                                           const Span& s) {
  for (long long f = s.a0 + s.bulk; f < s.f1; ++f) buf[f - s.a0] = src[f];
}

// thread 0: tile c of the block's run into its stage
__device__ void issue_tile(const Args& a, float* smem, uint64_t* full,
                           int e_begin, int e_end, int c) {
  const int e0 = e_begin + c * a.tile;
  const int ne = min(a.tile, e_end - e0);
  const int s = c % a.stages;
  float* xb = smem + s * a.stage;
  float* sb = xb + a.x_cap;
  float* wb = sb + a.sh_cap;
  if (CG_AGG_ONLY == 2 && c >= a.stages) {
    mbar_expect_tx(&full[s], 0);
    return;
  }
  const Span sx = span_of(e0, ne, a.dim_x, a.n_x);
  const Span ss = span_of(e0, ne, a.dim_sh, a.n_sh);
  const Span sw = span_of(e0, ne, a.dim_w, a.n_w);
  // the stage's earlier reads and writes (generic proxy) before the
  // copies' writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  stage_tail(xb, a.x, sx);
  stage_tail(sb, a.sh, ss);
  stage_tail(wb, a.w, sw);
  // the arrive releases the tail's plain stores to the waiting threads
  mbar_expect_tx(&full[s],
                 static_cast<uint32_t>((sx.bulk + ss.bulk + sw.bulk) * 4));
  if (sx.bulk) bulk_load(xb, a.x + sx.a0, sx.bulk * 4, &full[s]);
  if (ss.bulk) bulk_load(sb, a.sh + ss.a0, ss.bulk * 4, &full[s]);
  if (sw.bulk) bulk_load(wb, a.w + sw.a0, sw.bulk * 4, &full[s]);
}

// R consecutive edges of one item (x, w and B rows at xr, wr, br): the R
// messages first, as independent chains, then the running sums edge by
// edge in order.  Every product is rounded before its add (no fma; the
// intrinsics keep the compiler from contracting them): JAX's composition
// on the CPU, which the train goldens track (see the header)
template <int D1, int D3, int R>
__device__ __forceinline__ void item_edges(const Args& a, int mul,
                                           const float* xr, const float* wr,
                                           const float* br, float* acc) {
  constexpr int NB = (D1 * D3 + 3) / 4;  // float4s of the path's B block
  float xv[R][D1], wv[R], b[R][NB * 4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < D1; ++i) xv[r][i] = xr[r * a.dim_x + i * mul];
    wv[r] = wr[r * a.dim_w];
    const float4* b4 = reinterpret_cast<const float4*>(br + r * a.b_row);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const float4 v = b4[q];
      b[r][4 * q] = v.x;
      b[r][4 * q + 1] = v.y;
      b[r][4 * q + 2] = v.z;
      b[r][4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int k = 0; k < D3; ++k) {
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = __fmul_rn(b[r][k * D1], xv[r][0]);
#pragma unroll
      for (int i = 1; i < D1; ++i)
        m[r] = __fadd_rn(m[r], __fmul_rn(b[r][k * D1 + i], xv[r][i]));
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(wv[r], m[r]));
  }
}

// one item over its node's edges [lo, hi) of the tile: x, w rows at
// xs / ws (row 0 of the tile), B rows at bs; two edges an iteration (two
// independent chains ran faster than one at SevenNet-0's interior block,
// four no faster than two)
template <int D1, int D3>
__device__ __forceinline__ void run_item(const Args& a, const int* item,
                                         int lane, const float* xs,
                                         const float* ws, const float* bs,
                                         float* acc_s, int lo, int hi) {
  const int x_off = __ldg(item + 1);
  const int mul = __ldg(item + 3);
  const int u = __ldg(item + 4) + lane;
  const int w_off = __ldg(item + 5);
  const int msg_off = __ldg(item + 7);
  const int b_off = __ldg(item + 8);
  const bool active = u < mul;
  const int uc = active ? u : mul - 1;
  float* accp = acc_s + msg_off + uc;
  float acc[D3];
#pragma unroll
  for (int k = 0; k < D3; ++k) acc[k] = accp[k * mul];
  const float* xr = xs + lo * a.dim_x + x_off + uc;
  const float* wr = ws + lo * a.dim_w + w_off + uc;
  const float* br = bs + lo * a.b_row + b_off;
  int le = lo;
  for (; le + 1 < hi; le += 2) {
    item_edges<D1, D3, 2>(a, mul, xr, wr, br, acc);
    xr += 2 * a.dim_x;
    wr += 2 * a.dim_w;
    br += 2 * a.b_row;
  }
  if (le < hi) item_edges<D1, D3, 1>(a, mul, xr, wr, br, acc);
  if (active) {
#pragma unroll
    for (int k = 0; k < D3; ++k) accp[k * mul] = acc[k];
  }
}

template <int D1>
__device__ __forceinline__ void run_d3(int d3, const Args& a, const int* item,
                                       int lane, const float* xs,
                                       const float* ws, const float* bs,
                                       float* acc_s, int lo, int hi) {
  switch (d3) {
    case 1: run_item<D1, 1>(a, item, lane, xs, ws, bs, acc_s, lo, hi); break;
    case 3: run_item<D1, 3>(a, item, lane, xs, ws, bs, acc_s, lo, hi); break;
    case 5: run_item<D1, 5>(a, item, lane, xs, ws, bs, acc_s, lo, hi); break;
    default: run_item<D1, 7>(a, item, lane, xs, ws, bs, acc_s, lo, hi); break;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    cg_agg_bulk_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ int node_offs[kMaxNodes + 1];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * a.nodes;
  const int nn = min(a.nodes, a.n_node - n0);
  float* acc_s = smem + a.acc_base;

  if (tid <= nn) node_offs[tid] = __ldg(a.offs + n0 + tid);
  for (int i = tid; i < nn * a.dim_msg; i += blockDim.x) acc_s[i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int e_begin = node_offs[0];
  const int e_end = node_offs[nn];
  const int n_tile = (e_end - e_begin + a.tile - 1) / a.tile;
  if (tid == 0) {
    for (int c = 0; c < a.stages && c < n_tile; ++c)
      issue_tile(a, smem, full, e_begin, e_end, c);
  }
  const int* ent = a.plan + a.entries;
  const int it_begin = __ldg(a.plan + a.warp_start + warp);
  const int it_end = __ldg(a.plan + a.warp_start + warp + 1);

  for (int c = 0; c < n_tile; ++c) {
    const int s = c % a.stages;
    const int e0 = e_begin + c * a.tile;
    const int ne = min(a.tile, e_end - e0);
    mbar_wait(&full[s], static_cast<uint32_t>((c / a.stages) & 1));
    const float* xb = smem + s * a.stage;
    const float* sb = xb + a.x_cap;
    const float* wb = sb + a.sh_cap;
    const float* xs = xb + span_of(e0, ne, a.dim_x, a.n_x).off;
    const float* ss = sb + span_of(e0, ne, a.dim_sh, a.n_sh).off;
    const float* ws = wb + span_of(e0, ne, a.dim_w, a.n_w).off;
    float* bs = smem + a.b_base + (c & 1) * a.tile * a.b_row;

    // the tile's B rows: entry q of edge le, its couplings in order
    for (int q = tid; q < (CG_AGG_ONLY == 1 ? 0 : a.n_entry);
         q += blockDim.x) {
      const int* eq = ent + q * kEntry;
      const int col = __ldg(eq);
      const int steps = __ldg(eq + 1);
      int sj[kMaxSteps];
      float sc[kMaxSteps];
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        sj[st] = st < steps ? __ldg(eq + 2 + 2 * st) : 0;
        sc[st] = st < steps ? __int_as_float(__ldg(eq + 3 + 2 * st)) : 0.f;
      }
      for (int le = 0; le < ne; ++le) {
        const float* sr = ss + le * a.dim_sh;
        float b = 0.f;
#pragma unroll
        for (int st = 0; st < kMaxSteps; ++st) {
          if (st >= steps) break;
          b = fmaf(sc[st], sr[sj[st]], b);
        }
        bs[le * a.b_row + col] = b;
      }
    }
    // the B rows are complete, and every thread is done with tile c - 1
    __syncthreads();
    if (tid == 0 && c >= 1 && c - 1 + a.stages < n_tile)
      issue_tile(a, smem, full, e_begin, e_end, c - 1 + a.stages);

    for (int it = it_begin; it < (CG_AGG_ONLY == 1 ? it_begin : it_end);
         ++it) {
      const int* item = a.plan + a.items + it * kItem;
      const int g = __ldg(item);
      if (g >= nn) continue;
      const int lo = max(node_offs[g], e0) - e0;
      const int hi = min(node_offs[g + 1], e0 + ne) - e0;
      if (lo >= hi) continue;
      float* acc_g = acc_s + g * a.dim_msg;
      const int d3 = __ldg(item + 6);
      switch (__ldg(item + 2)) {
        case 1: run_d3<1>(d3, a, item, lane, xs, ws, bs, acc_g, lo, hi);
          break;
        case 3: run_d3<3>(d3, a, item, lane, xs, ws, bs, acc_g, lo, hi);
          break;
        case 5: run_d3<5>(d3, a, item, lane, xs, ws, bs, acc_g, lo, hi);
          break;
        default: run_d3<7>(d3, a, item, lane, xs, ws, bs, acc_g, lo, hi);
          break;
      }
    }
  }
  __syncthreads();
  float* o = a.out + static_cast<long long>(n0) * a.dim_msg;
  for (int i = tid; i < nn * a.dim_msg; i += blockDim.x) o[i] = acc_s[i];
}

// offs[n] = the first edge e with dst[e] >= n (n_edge if none), for n =
// 0..n_node, from the ascending dst: thread e writes the n in (dst[e - 1],
// dst[e]], thread n_edge those past dst[n_edge - 1]; sentinels (dst >=
// n_node) count as n_node.  Each entry is written once, so a call needs
// no host-side search
__global__ void cg_agg_offsets_kernel(const int* __restrict__ dst,
                                      int* __restrict__ offs, int n_edge,
                                      int n_node) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > n_edge) return;
  const int lo = e == 0 ? -1 : min(__ldg(dst + e - 1), n_node);
  const int hi = e == n_edge ? n_node : min(__ldg(dst + e), n_node);
  for (int n = lo + 1; n <= hi; ++n) offs[n] = e;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x [E, dim_x], sh [E, dim_sh], w [E, dim_w] (16-byte aligned), dst [E]
// ascending; offs: scratch of n_node + 1 ints (the node ranges, written
// here); plan: the device copy of AggPlan.packed(), plan_meta its meta
// (host array); cfg: host array (tile, stages, nodes, warps); smem: host
// array (x_cap, sh_cap, stage, b_base, acc_base, b_row, total floats)
// (ops/cg_tables.py, agg_plan / agg_smem).  Two launches: the node
// ranges, then the aggregation.
extern "C" int cg_agg_f32(const float* x, const float* sh, const float* w,
                          const int* dst, int* offs, const int* plan,
                          const int* plan_meta, const int* cfg,
                          const int* smem, float* out, int n_edge,
                          int n_node, int dim_x, int dim_sh, int dim_w,
                          int dim_msg, void* stream) {
  // the largest dynamic shared memory granted, per device (an attribute
  // of the function on each device)
  static int smem_set[64] = {};
  const int tile = cfg[0], stages = cfg[1], nodes = cfg[2], warps = cfg[3];
  const long long bytes = 4LL * smem[6];
  // a tile is issued `stages` - 1 tiles ahead of its use: at least 2
  if (tile < 1 || stages < 2 || stages > kMaxStages || nodes < 1 ||
      nodes > kMaxNodes || warps < 1 || warps * 32 > kMaxThreads ||
      bytes + kStaticSmem > kSmemMax || !aligned16(x) || !aligned16(sh) ||
      !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 6; ++i) {  // every section starts 16-byte aligned
    if (smem[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(cg_agg_bulk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = static_cast<int>(bytes);
  }
  Args a;
  a.x = x;
  a.sh = sh;
  a.w = w;
  a.offs = offs;
  a.plan = plan;
  a.out = out;
  a.n_x = static_cast<long long>(n_edge) * dim_x;
  a.n_sh = static_cast<long long>(n_edge) * dim_sh;
  a.n_w = static_cast<long long>(n_edge) * dim_w;
  a.n_node = n_node;
  a.dim_x = dim_x;
  a.dim_sh = dim_sh;
  a.dim_w = dim_w;
  a.dim_msg = dim_msg;
  a.tile = tile;
  a.stages = stages;
  a.nodes = nodes;
  a.x_cap = smem[0];
  a.sh_cap = smem[1];
  a.stage = smem[2];
  a.b_base = smem[3];
  a.acc_base = smem[4];
  a.b_row = smem[5];
  a.n_entry = plan_meta[0];
  a.warp_start = plan_meta[1];
  a.items = plan_meta[2];
  a.entries = plan_meta[3];
  if (n_node > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cg_agg_offsets_kernel<<<n_edge / 256 + 1, 256, 0, st>>>(dst, offs,
                                                            n_edge, n_node);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (n_node + nodes - 1) / nodes;
    cg_agg_bulk_kernel<<<blocks, warps * 32, static_cast<size_t>(bytes),
                         st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
